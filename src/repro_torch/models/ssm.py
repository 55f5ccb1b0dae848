"""Mamba2 (SSD — state-space duality) layer [arXiv:2405.21060] (port of
``repro.models.ssm``, without its sharding specs).

Layer structure (Mamba2):
  in_proj -> [z | x | B | C | dt] -> causal depthwise conv (x, B, C) -> SiLU
  -> SSD(x, dt, A, B, C) + D*x -> gated RMSNorm(y * silu(z)) -> out_proj

The SSD scan is the reference's chunked form: inside a chunk of Q steps the
dual quadratic form (scores C_i·B_j times the decay matrix, then a product
with dt·x), across chunks a recurrence over the chunk-end states. The
reference computes it with XLA einsums, ``cumsum`` and ``lax.scan`` (no
Pallas kernel), so here it is plain PyTorch: batched matmuls and a Python
loop over the ``s / Q`` chunks (static from the shapes; no value is read
back to the host). Every three-operand einsum of the reference is taken in
two explicit steps, so that no (Q, Q, h, p) intermediate is formed.

Decode carries (ssm_state (b, h, p, n) float32, conv_state (b, w-1,
conv_ch)) and updates both in place.

Tensor-parallel training (a ``TrainShard`` with ``ssm`` set) cuts the
layer by SSM head group, Megatron's cut with one group of B and C: a rank
holds its heads' columns of z, x and dt in ``in_proj`` and the whole B
and C columns, its heads' x channels and the whole B and C channels in
the conv, its channels of ``norm_w`` and rows of ``out_proj``, and reads
``A_log``, ``D`` and ``dt_bias`` (replicated) at its heads
(``ssm_specs``' ``Pieces``; the reference cuts ``in_proj``'s columns
contiguously, which crosses the z | x | B | C | dt boundaries). Its input
enters through ``copy_to_group``, the pieces every rank holds whole
through ``copy_parts_to_group`` (each rank's gradient of them covers only
its heads), the gated norm's sum of squares over the whole d_inner is
summed both ways (``sum_over_group``), and ``out_proj``'s partial rows
end in ``reduce_from_group``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import comm
from repro_torch.distributed.sharding import P, Pieces
from repro_torch.models.layers import dense_init, rms_normalize


def _dims(cfg: ModelConfig, shard=None):
    """(d_inner, heads, head dim, state, conv channels): the whole
    layer's, or a head-group rank's (``shard.ssm``)."""
    d_inner = cfg.ssm_d_inner
    nheads = cfg.ssm_num_heads
    p = cfg.ssm_head_dim
    n = cfg.ssm_state
    if shard is not None and shard.ssm:
        lo, hi = shard.ssm_head_range
        nheads = hi - lo
        d_inner = nheads * p
    conv_ch = d_inner + 2 * n          # x, B, C go through the conv
    return d_inner, nheads, p, n, conv_ch


def init_ssm(cfg: ModelConfig, dtype, *, generator, device):
    """The reference's initializer (the random stream differs): ``A_log``,
    ``D`` and ``dt_bias`` are float32 in any model dtype."""
    d = cfg.d_model
    d_inner, nheads, p, n, conv_ch = _dims(cfg)
    kw = dict(generator=generator, device=device)
    proj_out = 2 * d_inner + 2 * n + nheads      # z, x, B, C, dt
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((cfg.ssm_conv_width, conv_ch), **f32,
                         generator=generator) * 0.1
    dt0 = torch.linspace(1e-3, 0.1, nheads, **f32)
    return {
        "in_proj": dense_init(d, proj_out, dtype, **kw),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, **f32)),
        "D": torch.ones((nheads,), **f32),
        "dt_bias": torch.log(torch.exp(dt0) - 1.0),
        "norm_w": torch.ones((d_inner,), dtype=dtype, device=device),
        "out_proj": dense_init(d_inner, d, dtype, **kw),
    }


def ssm_specs(cfg: ModelConfig):
    """The reference's specs ("ssm_ff": the SSM projection widths, 2
    d_inner + 2n + nheads, do not always divide by tp, and ``auto_rules``
    demotes only this axis), whose "ssm_ff" entries of ``in_proj``,
    ``conv_w`` and ``conv_b`` are ``Pieces``: cut by head group, B and C
    whole (module docstring)."""
    d_inner, nheads, _, n, _ = _dims(cfg)
    proj = Pieces("ssm_ff", (d_inner, d_inner, n, n, nheads),
                  (True, True, False, False, True))
    conv = Pieces("ssm_ff", (d_inner, 2 * n), (True, False))
    return {"in_proj": P("embed", proj), "conv_w": P(None, conv),
            "conv_b": P(conv), "A_log": P(None), "D": P(None),
            "dt_bias": P(None), "norm_w": P("ssm_ff"),
            "out_proj": P("ssm_ff", "embed")}


def _split_proj(cfg: ModelConfig, proj, shard=None):
    d_inner, nheads, p, n, _ = _dims(cfg, shard)
    return torch.split(proj, [d_inner, d_inner, n, n, nheads], dim=-1)


def _head_group(params, cfg: ModelConfig, shard):
    """A head-group rank's view of the layer's params: ``in_proj``,
    ``conv_w`` and ``conv_b`` through ``copy_parts_to_group`` (their whole
    B and C parts), ``A_log``, ``D`` and ``dt_bias`` too (whole), then
    read at the rank's heads."""
    d_inner, _, _, n, _ = _dims(cfg, shard)
    lo, hi = shard.ssm_head_range
    bc = [(2 * d_inner, 2 * n)]
    names = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias")
    parts = [(1, bc), (1, [(d_inner, 2 * n)]), (0, [(d_inner, 2 * n)])]
    parts += [(0, [(0, cfg.ssm_num_heads)])] * 3
    views = comm.copy_parts_to_group([params[k] for k in names], parts,
                                     shard.model)
    out = dict(params, **dict(zip(names, views)))
    for k in ("A_log", "D", "dt_bias"):
        out[k] = out[k][lo:hi]
    return out


def _causal_conv(conv_in, w, b, width: int, fast: bool = False):
    """(b, s, ch) depthwise causal conv, then SiLU.

    fast=False: ``width`` shifted multiply-adds over the stream, in its
    dtype; fast=True: one ``F.conv1d`` with ``groups=ch`` (the reference's
    ``conv_general_dilated`` with ``feature_group_count=ch``)."""
    if fast:
        ch = conv_in.shape[-1]
        kernel = w.to(conv_in.dtype).t()[:, None, :]        # (ch, 1, W)
        out = F.conv1d(F.pad(conv_in.transpose(1, 2), (width - 1, 0)),
                       kernel, groups=ch).transpose(1, 2)
        return F.silu(out + b)
    s = conv_in.shape[1]
    out = torch.zeros_like(conv_in)
    for i in range(width):
        shift = width - 1 - i
        shifted = F.pad(conv_in, (0, 0, shift, 0))[:, :s]
        out = out + shifted * w[i]
    return F.silu(out + b)


def ssd_chunked(x, dt, a_log_decay, b_in, c_in, chunk: int,
                return_final_state: bool = False,
                decay_dtype=torch.float32):
    """SSD chunked scan.

    x:   (b, s, h, p)   per-head inputs
    dt:  (b, s, h)      positive step sizes
    a_log_decay: (b, s, h)  log a_t = dt * A  (A < 0)
    b_in/c_in: (b, s, n)    shared across heads (ngroups = 1)
    Returns y (b, s, h, p) float32 [, the final state (b, h, p, n)].

    ``decay_dtype`` rounds the intra-chunk operands (scores, decays, dt·x)
    to that dtype and takes their product in float32, as the reference's
    einsum with ``preferred_element_type=float32`` does.
    """
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    pad = (-s) % chunk
    if pad:
        # padded steps have dt == 0 and log-decay 0: they leave the state
        # untouched, so the final state is exact for the unpadded sequence
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, a_log_decay, b_in, c_in = (F.pad(t, (0, 0, 0, pad))
                                       for t in (dt, a_log_decay, b_in, c_in))
    nc = x.shape[1] // chunk

    # chunks, heads before steps: (b, nc, h, Q, ...)
    xc = x.reshape(bsz, nc, chunk, h, p).float().permute(0, 1, 3, 2, 4)
    dtc = dt.reshape(bsz, nc, chunk, h).float().permute(0, 1, 3, 2)
    ac = a_log_decay.reshape(bsz, nc, chunk, h).float().permute(0, 1, 3, 2)
    bc = b_in.reshape(bsz, nc, chunk, n).float()
    cc = c_in.reshape(bsz, nc, chunk, n).float()

    cum = torch.cumsum(ac, dim=-1)                     # (b, nc, h, Q) inclusive
    total = cum[..., -1]                               # (b, nc, h) chunk decay

    # ---- intra-chunk (dual quadratic form, masked by the decay matrix) ----
    # M[i, j] = exp(cum_i - cum_j) for j <= i. The exponent is clamped
    # BEFORE exp: for j > i it is positive and would overflow to inf, and
    # where(mask, inf, 0) gives NaN gradients (inf * 0 in the backward).
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    seg = cum[..., :, None] - cum[..., None, :]        # (b, nc, h, Q, Q)
    decay = torch.where(mask, torch.exp(torch.clamp(seg, max=0.0)), 0.0)
    cb = cc @ bc.transpose(-1, -2)                     # (b, nc, Q, Q)
    xdt = xc * dtc[..., None]                          # dt_j x_j (b,nc,h,Q,p)
    if decay_dtype != torch.float32:
        cb, decay, xdt_o = (t.to(decay_dtype).float() for t in (cb, decay, xdt))
    else:
        xdt_o = xdt
    scores = cb[:, :, None] * decay                    # (b, nc, h, Q, Q)
    y_intra = scores @ xdt_o                           # (b, nc, h, Q, p)

    # ---- chunk-end states ----
    # S_c = sum_j exp(total - cum_j) * (dt_j x_j) ⊗ B_j   -> (b, nc, h, p, n)
    w_end = torch.exp(total[..., None] - cum)          # (b, nc, h, Q)
    states = (xdt * w_end[..., None]).transpose(-1, -2) @ bc[:, :, None]

    # ---- inter-chunk recurrence over the chunks ----
    decay_c = torch.exp(total)[..., None, None]        # (b, nc, h, 1, 1)
    h_t = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    h_before = []
    for c in range(nc):
        h_before.append(h_t)                           # state BEFORE chunk c
        h_t = h_t * decay_c[:, c] + states[:, c]
    h_before = torch.stack(h_before, dim=1)            # (b, nc, h, p, n)

    # y_inter[i] = exp(cum_i) * C_i · H_{chunk start}
    y_inter = (cc[:, :, None] @ h_before.transpose(-1, -2)) \
        * torch.exp(cum)[..., None]                    # (b, nc, h, Q, p)

    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(
        bsz, nc * chunk, h, p)
    y = y[:, :s] if pad else y
    if return_final_state:
        return y, h_t
    return y


def apply_ssm(params, cfg: ModelConfig, x, *, return_final_state: bool = False,
              shard=None):
    """Full-sequence SSD. x: (b, s, d_model) -> (b, s, d_model)
    [, the final state {"h", "conv"} for serving prefill]. ``shard``: a
    rank's head group of a tensor-parallel training step (module
    docstring; a ``TrainShard`` whose ``ssm`` is False runs the whole
    layer)."""
    tp = shard is not None and shard.ssm
    d_inner, nheads, p, n, conv_ch = _dims(cfg, shard)
    bsz, s, _ = x.shape
    if tp:
        params = _head_group(params, cfg, shard)
        x = comm.copy_to_group(x, shard.model)
    proj = x @ params["in_proj"]
    z, xin, b_in, c_in, dt = _split_proj(cfg, proj, shard)

    conv_in = torch.cat([xin, b_in, c_in], dim=-1)
    conv_out = _causal_conv(conv_in, params["conv_w"], params["conv_b"],
                            cfg.ssm_conv_width, fast=cfg.fast_conv)
    xin_c, b_in, c_in = torch.split(conv_out, [d_inner, n, n], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"])             # (b, s, h)
    a = -torch.exp(params["A_log"])                             # (h,)
    a_log_decay = dt * a                                        # (b, s, h)

    xh = xin_c.reshape(bsz, s, nheads, p)
    res = ssd_chunked(xh, dt, a_log_decay, b_in, c_in, cfg.ssm_chunk,
                      return_final_state=return_final_state,
                      decay_dtype=getattr(torch, cfg.ssm_decay_dtype))
    y, h_final = res if return_final_state else (res, None)
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(bsz, s, d_inner).to(x.dtype)

    if tp:
        y = _sharded_rms_normalize(y * F.silu(z), cfg.ssm_d_inner,
                                   shard.model) * params["norm_w"]
        out = comm.reduce_from_group(y @ params["out_proj"], shard.model)
    else:
        y = rms_normalize(y * F.silu(z)) * params["norm_w"]
        out = y @ params["out_proj"]
    if return_final_state:
        # the reference's slice: for s < w-1 the start is negative and
        # counts from the end (fewer than w-1 rows come back)
        w = cfg.ssm_conv_width
        return out, {"h": h_final, "conv": conv_in[:, s - (w - 1):, :]}
    return out


def _sharded_rms_normalize(x, width: int, group, eps: float = 1e-6):
    """``rms_normalize`` of channels cut over ``group`` (``width`` of them
    in all): the sum of squares summed over the group both ways."""
    xf = x.float()
    ss = comm.sum_over_group((xf * xf).sum(dim=-1, keepdim=True), group)
    return (xf * torch.rsqrt(ss / width + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------

def init_ssm_state(cfg: ModelConfig, batch: int, dtype, device):
    d_inner, nheads, p, n, conv_ch = _dims(cfg)
    return {
        "h": torch.zeros((batch, nheads, p, n), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
    }


def ssm_state_specs(cfg: ModelConfig | None = None):
    """Logical specs of the decode state (the reference's): lanes over
    "data", ``h``'s heads over "ssm_heads", the conv state's channels over
    "ssm_ff". Given ``cfg`` the conv entry is a ``Pieces`` of the head-group
    cut (its x channels cut, B and C whole: ``ssm_specs``' conv layout),
    equal to the reference's name."""
    conv = "ssm_ff"
    if cfg is not None:
        d_inner, _, _, n, _ = _dims(cfg)
        conv = Pieces("ssm_ff", (d_inner, 2 * n), (True, False))
    return {"h": P("data", "ssm_heads", None, None),
            "conv": P("data", None, conv)}


def decode_ssm_step(params, cfg: ModelConfig, x, state, shard=None):
    """x: (b, 1, d_model). Advances ``state`` ({"h", "conv"}) by one token
    in place; returns (y (b, 1, d_model), state). ``shard``: a rank's
    head group of a sequence-sharded decode (``shard.ssm``; the state is
    the rank's heads of ``h`` and its x channels with the whole B and C
    channels of ``conv``): the gated norm's sum of squares and
    ``out_proj``'s rows are summed over "model"."""
    tp = shard is not None and shard.ssm
    d_inner, nheads, p, n, conv_ch = _dims(cfg, shard)
    if tp:
        params = _head_group(params, cfg, shard)
    bsz = x.shape[0]
    proj = x[:, 0] @ params["in_proj"]                 # (b, proj_out)
    z, xin, b_in, c_in, dt = _split_proj(cfg, proj, shard)

    conv_in = torch.cat([xin, b_in, c_in], dim=-1)     # (b, conv_ch)
    window = torch.cat([state["conv"], conv_in[:, None]], dim=1)  # (b, w, ch)
    conv_out = F.silu(
        torch.einsum("bwc,wc->bc", window.float(), params["conv_w"].float())
        + params["conv_b"].float()).to(x.dtype)
    xin, b_in, c_in = torch.split(conv_out, [d_inner, n, n], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"])             # (b, h)
    decay = torch.exp(dt * -torch.exp(params["A_log"]))          # (b, h)

    xh = xin.reshape(bsz, nheads, p).float()
    dbx = (dt[:, :, None] * xh)[..., None] * b_in.float()[:, None, None, :]
    h_new = state["h"] * decay[:, :, None, None] + dbx
    y = (h_new @ c_in.float()[:, None, :, None])[..., 0]        # (b, h, p)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(bsz, d_inner).to(x.dtype)

    if tp:
        y = _sharded_rms_normalize(y * F.silu(z), cfg.ssm_d_inner,
                                   shard.model) * params["norm_w"]
        y = comm.all_reduce_sum(y @ params["out_proj"], shard.model)[:, None]
    else:
        y = rms_normalize(y * F.silu(z)) * params["norm_w"]
        y = (y @ params["out_proj"])[:, None]
    state["h"].copy_(h_new)
    state["conv"].copy_(window[:, 1:])
    return y, state
