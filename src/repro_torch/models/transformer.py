"""Block stacks (port of ``repro.models.transformer``): pre-norm attention
+ MLP blocks (norm and MLP by ``cfg.norm_type`` / ``cfg.mlp_type``),
attention + MoE blocks for ``family="moe"``, attention-free Mamba2 (SSD)
blocks for ``family="ssm"`` (an MLP only where ``d_ff > 0``), and
Hymba's blocks for ``family="hybrid"``: attention and SSM heads read the
same normalized input, and their outputs, each RMS-normalized, are
averaged. ``family="encdec"``: the encoder's blocks are the dense ones
run non-causal (``causal_override=False``), the decoder's add
cross-attention over the encoder's output after self-attention
(``cross_norm``, ``cross_attn``); prefill caches the encoder's K/V per
layer (``"cross_kv"``, padded to the decode kernel's tile) and decode
attends them with ``kv_len`` = the encoder's length. The stacks run as a
plain loop over layers (the JAX package scans over stacked layers). The
training stack sums the MoE layers' load-balancing losses; the serving
stacks drop them, as the reference does. The SSM path ignores
``segment_ids``: packing is an attention-family feature. With
``cfg.remat`` the training stack checkpoints every block
(``torch.utils.checkpoint``, non-reentrant: only the block's input is
kept and the block runs again in the backward), as the JAX package's
``jax.checkpoint(policy=nothing_saveable)`` does.

The paged serving stacks take a ``ServeMesh`` (``mesh``) under tensor or
sequence parallelism: the attention layer's and the MLP's output
projections then sum over the tp group (``attention_layer._tp_reduce``),
two collectives a layer. The training stack takes a ``TrainShard``
(``shard``) under a sharded train step: the rank's heads and FFN columns
with Megatron's ``copy_to_group`` / ``reduce_from_group`` pair around the
attention (self and cross, an encoder's too) and the MLP
(``attention_layer``), the rank's experts (``moe``) and SSM head group
(``ssm``) under their pairs, the MoE's load-balancing statistics over the
data group, and the global coordinates of the dropout hash. ``block_specs`` gives a block's logical sharding specs (the
reference's, without its stacked layer axis)."""

from __future__ import annotations

from typing import Any

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_map
from repro_torch.distributed import comm
from repro_torch.models import attention_layer as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.kernels.tuning import DECODE_TILE
from repro_torch.models.layers import (apply_mlp, apply_norm, init_mlp,
                                       init_norm, mlp_specs, norm_specs,
                                       rms_normalize)

Params = dict[str, Any]


def init_block(cfg: ModelConfig, dtype, *, generator, device,
               cross_attn: bool = False) -> Params:
    """The reference's block tree: attention unless the family is "ssm",
    an SSM (with its own norm) for "ssm" and "hybrid" (the hybrid's
    ``ssm_norm`` is never read, as in the reference), cross-attention
    with its norm for an encoder-decoder's decoder blocks
    (``cross_attn``), then an MoE for "moe" or an MLP where ``d_ff > 0``."""
    kw = dict(generator=generator, device=device)
    p: Params = {}
    if cfg.family != "ssm":
        p["attn_norm"] = init_norm(cfg.d_model, cfg.norm_type, dtype, device)
        p["attn"] = attn_mod.init_attention(cfg, dtype, **kw)
    if cfg.family == "ssm" or cfg.hybrid:
        p["ssm_norm"] = init_norm(cfg.d_model, cfg.norm_type, dtype, device)
        p["ssm"] = ssm_mod.init_ssm(cfg, dtype, **kw)
    if cross_attn:
        p["cross_norm"] = init_norm(cfg.d_model, cfg.norm_type, dtype, device)
        p["cross_attn"] = attn_mod.init_attention(cfg, dtype, **kw)
    if cfg.family == "moe":
        p["mlp_norm"] = init_norm(cfg.d_model, cfg.norm_type, dtype, device)
        p["moe"] = moe_mod.init_moe(cfg, dtype, **kw)
    elif cfg.d_ff > 0:
        p["mlp_norm"] = init_norm(cfg.d_model, cfg.norm_type, dtype, device)
        p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype, **kw)
    return p


def block_specs(cfg: ModelConfig, *, cross_attn: bool = False) -> Params:
    """Logical specs of ``init_block``'s tree, leaf for leaf."""
    s: Params = {}
    if cfg.family != "ssm":
        s["attn_norm"] = norm_specs(cfg.norm_type)
        s["attn"] = attn_mod.attention_specs(cfg)
    if cfg.family == "ssm" or cfg.hybrid:
        s["ssm_norm"] = norm_specs(cfg.norm_type)
        s["ssm"] = ssm_mod.ssm_specs(cfg)
    if cross_attn:
        s["cross_norm"] = norm_specs(cfg.norm_type)
        s["cross_attn"] = attn_mod.attention_specs(cfg)
    if cfg.family == "moe":
        s["mlp_norm"] = norm_specs(cfg.norm_type)
        s["moe"] = moe_mod.moe_specs(cfg)
    elif cfg.d_ff > 0:
        s["mlp_norm"] = norm_specs(cfg.norm_type)
        s["mlp"] = mlp_specs(cfg.mlp_type)
    return s


def _layered(specs):
    """A layer's specs with a leading layer axis."""
    if isinstance(specs, dict):
        return {k: _layered(v) for k, v in specs.items()}
    return type(specs)(None, *specs)


def decode_cache_specs(cfg: ModelConfig, *, enc: bool = False) -> Params:
    """Logical specs of ``init_decode_cache``'s tree (the reference's
    ``decode_cache_specs``; a leading layer axis): K/V rows over "data",
    the capacity over "kv_seq"; the SSM state's heads over "ssm_heads",
    its conv channels over "ssm_ff" (cut by head group,
    ``ssm.ssm_state_specs``); ``enc``: the cross-attention's K/V."""
    c: Params = {}
    if cfg.family != "ssm":
        c["kv"] = attn_mod.kv_cache_specs()
    if cfg.family == "ssm" or cfg.hybrid:
        c["ssm"] = ssm_mod.ssm_state_specs(cfg)
    if enc:
        c["cross_kv"] = attn_mod.kv_cache_specs()
    return _layered(c)


def paged_decode_cache_specs() -> Params:
    """Logical specs of ``init_paged_decode_cache``'s tree (the
    reference's): each layer's pool, its pages over "kv_seq"."""
    return _layered({"kv": attn_mod.paged_kv_cache_specs()})


def _mix(x, a, m):
    """Hymba's residual: the attention and SSM outputs, each RMS-normalized,
    averaged."""
    return x + 0.5 * (rms_normalize(a) + rms_normalize(m))


def _ffn_residual(params: Params, cfg: ModelConfig, x, mesh=None,
                  shard=None):
    """x plus the block's MLP, or MoE, of its normalised self (x itself
    for a block with neither); under a mesh the MLP's ``w_down`` partial
    sums over the tp group, under a ``shard`` with the FFN cut over
    "model" Megatron's pair runs around the MLP, and with the experts cut
    around the rank's experts (``moe.apply_moe``). Returns (x, aux): the
    MoE's load-balancing loss, or None (the serving stacks drop it)."""
    if "mlp_norm" not in params:
        return x, None
    h = apply_norm(params["mlp_norm"], x, cfg.norm_type)
    if "moe" in params:
        y, aux = moe_mod.apply_moe(params["moe"], cfg, h,
                                   data=None if shard is None else shard.data,
                                   shard=shard)
        return x + y, aux
    if shard is not None and shard.ff:
        h = comm.copy_to_group(h, shard.model)
        y = comm.reduce_from_group(apply_mlp(params["mlp"], h, cfg.mlp_type),
                                   shard.model)
        return x + y, None
    y = attn_mod._tp_reduce(apply_mlp(params["mlp"], h, cfg.mlp_type), cfg,
                            mesh)
    return x + y, None


def _cross_residual(params: Params, cfg: ModelConfig, x, enc_out, *,
                    deterministic: bool = True, shard=None, batch_offset=0):
    """x plus cross-attention of its normalised self over ``enc_out``
    (decoder blocks of an encoder-decoder; x itself otherwise)."""
    if "cross_attn" not in params or enc_out is None:
        return x
    h = apply_norm(params["cross_norm"], x, cfg.norm_type)
    return x + attn_mod.apply_attention(params["cross_attn"], cfg, h,
                                        kv_x=enc_out,
                                        deterministic=deterministic,
                                        shard=shard, batch_offset=batch_offset)


def apply_block(params: Params, cfg: ModelConfig, x, *, enc_out=None,
                segment_ids=None, deterministic: bool = True,
                dropout_seed=0, causal_override: bool | None = None,
                shard=None, batch_offset: int = 0):
    """One block, full sequence (training). Returns (x, aux_loss); aux is 0
    outside the MoE family. ``causal_override`` sets the self-attention's
    causality (the encoder's blocks run with False, and then no window);
    ``enc_out`` feeds the decoder blocks' cross-attention; ``shard`` and
    ``batch_offset``: a rank's part of a sharded step."""
    spec = None
    if causal_override is not None:
        spec = dataclasses.replace(
            attn_mod.attn_spec_from_config(cfg), causal=causal_override,
            window=cfg.window if causal_override else None)
    if cfg.family == "ssm":
        h = apply_norm(params["ssm_norm"], x, cfg.norm_type)
        x = x + ssm_mod.apply_ssm(params["ssm"], cfg, h, shard=shard)
    else:
        h = apply_norm(params["attn_norm"], x, cfg.norm_type)
        a = attn_mod.apply_attention(params["attn"], cfg, h, spec=spec,
                                     segment_ids=segment_ids,
                                     deterministic=deterministic,
                                     dropout_seed=dropout_seed, shard=shard,
                                     batch_offset=batch_offset)
        # a replicated SSM takes h as it is: its input gradient is whole
        # on every rank (only the attention's and a cut SSM's are parts)
        x = (_mix(x, a, ssm_mod.apply_ssm(params["ssm"], cfg, h,
                                          shard=shard))
             if cfg.hybrid else x + a)
    x = _cross_residual(params, cfg, x, enc_out, deterministic=deterministic,
                        shard=shard, batch_offset=batch_offset)
    x, aux = _ffn_residual(params, cfg, x, shard=shard)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def apply_stack(blocks: list[Params], cfg: ModelConfig, x, *,
                enc_out=None, segment_ids=None,
                deterministic: bool = True, dropout_seed=0,
                causal_override: bool | None = None, shard=None,
                batch_offset: int = 0):
    """All blocks in order. Returns (x, total_aux_loss)."""
    def fn(p_l, h):
        return apply_block(p_l, cfg, h, enc_out=enc_out,
                           segment_ids=segment_ids,
                           deterministic=deterministic,
                           dropout_seed=dropout_seed,
                           causal_override=causal_override, shard=shard,
                           batch_offset=batch_offset)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p_l in blocks:
        if cfg.remat:
            # the recompute stops once the backward's tensors are back
            # (torch's default, pinned: a sharded step's census counts on it)
            with set_checkpoint_early_stop(True):
                x, aux = checkpoint(fn, p_l, x, use_reentrant=False)
        else:
            x, aux = fn(p_l, x)
        aux_total = aux_total + aux
    return x, aux_total


def cross_capacity(enc_len: int) -> int:
    """Rows of a cross-attention cache for ``enc_len`` encoder rows: padded
    up to the decode kernel's tile (``DECODE_TILE``), so that the split-KV
    decode takes its tile whatever the encoder's length; the padding is
    masked through ``kv_len = enc_len``."""
    return -(-enc_len // DECODE_TILE) * DECODE_TILE


def apply_block_prefill(params: Params, cfg: ModelConfig, x,
                        capacity: int | None = None, *, segment_ids=None,
                        positions=None, enc_out=None, mesh=None):
    """One block over a (packed) prompt; returns (x, cache_l): ``"kv"``
    with the block's K/V rows (b, hkv, s, hd), or, given a ``capacity``, a
    (b, hkv, capacity, hd) slot cache holding them at [0, s); ``"ssm"``
    with the SSM's final state {"h", "conv"} (families "ssm" and
    "hybrid"; those prefill one unpacked prompt a row); ``"cross_kv"``
    with the encoder's K/V rows for decode (decoder blocks of an
    encoder-decoder, given ``enc_out``; ``cross_capacity`` rows)."""
    cache_l: Params = {}
    if cfg.family == "ssm":
        h = apply_norm(params["ssm_norm"], x, cfg.norm_type)
        y, cache_l["ssm"] = ssm_mod.apply_ssm(params["ssm"], cfg, h,
                                              return_final_state=True)
        return _ffn_residual(params, cfg, x + y)[0], cache_l
    h = apply_norm(params["attn_norm"], x, cfg.norm_type)
    cache = (None if capacity is None else
             attn_mod.init_kv_cache(cfg, x.shape[0], capacity, x.dtype,
                                    x.device))
    a, cache_l["kv"] = attn_mod.prefill_attention(
        params["attn"], cfg, h, cache, segment_ids=segment_ids,
        positions=positions, mesh=mesh)
    if cfg.hybrid:
        m, cache_l["ssm"] = ssm_mod.apply_ssm(params["ssm"], cfg, h,
                                              return_final_state=True)
        x = _mix(x, a, m)
    else:
        x = x + a
    if "cross_attn" in params and enc_out is not None:
        h = apply_norm(params["cross_norm"], x, cfg.norm_type)
        c, cache_l["cross_kv"] = attn_mod.cross_prefill_attention(
            params["cross_attn"], cfg, h, enc_out,
            cross_capacity(enc_out.shape[1]))
        x = x + c
    return _ffn_residual(params, cfg, x, mesh)[0], cache_l


def apply_stack_prefill(blocks: list[Params], cfg: ModelConfig, x,
                        capacity: int | None = None, *, segment_ids=None,
                        positions=None, enc_out=None, mesh=None):
    """Prompt through all layers; every cache leaf stacked on a leading
    layer axis: {"kv": {"k": (L, b, hkv, s or capacity, hd), "v": ...},
    "ssm": {"h": (L, b, h, p, n), "conv": (L, b, w-1, conv_ch)},
    "cross_kv": {"k": (L, b, hkv, cross_capacity(s_enc), hd), "v": ...}},
    each where the family has it."""
    outs = []
    for p_l in blocks:
        x, c = apply_block_prefill(p_l, cfg, x, capacity,
                                   segment_ids=segment_ids,
                                   positions=positions, enc_out=enc_out,
                                   mesh=mesh)
        outs.append(c)
    return x, tree_map(lambda *ls: torch.stack(ls), outs[0], *outs[1:])


def init_decode_cache(cfg: ModelConfig, batch: int, capacity: int, dtype,
                      device, *, enc_len: int = 0):
    """Per-layer slot caches stacked on a leading layer axis:
    (L, batch, hkv, capacity, hd) per K/V leaf (unless the family is
    "ssm"), the SSM state (families "ssm" and "hybrid"): "h" (L,
    batch, h, p, n) float32 and "conv" (L, batch, w-1, conv_ch), and an
    encoder-decoder's cross-attention cache for ``enc_len`` encoder rows
    ("cross_kv", ``cross_capacity(enc_len)`` rows)."""
    c: Params = {}

    def kv(rows):
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, rows, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    if cfg.family != "ssm":
        c["kv"] = kv(capacity)
    if cfg.num_encoder_layers > 0 and enc_len > 0:
        c["cross_kv"] = kv(cross_capacity(enc_len))
    if cfg.family == "ssm" or cfg.hybrid:
        one = ssm_mod.init_ssm_state(cfg, batch, dtype, device)
        c["ssm"] = {k: torch.zeros((cfg.num_layers, *t.shape), dtype=t.dtype,
                                   device=device) for k, t in one.items()}
    return c


def apply_block_decode(params: Params, cfg: ModelConfig, x, cache, kv_len,
                       enc_len=None):
    """One block for one new token against its layer's slot cache
    ({"kv", "ssm"} as the family has them, updated in place; an
    encoder-decoder's "cross_kv", read over ``enc_len`` (b,) rows).
    Returns (x, cache)."""
    if cfg.family == "ssm":
        h = apply_norm(params["ssm_norm"], x, cfg.norm_type)
        y, _ = ssm_mod.decode_ssm_step(params["ssm"], cfg, h, cache["ssm"])
        return _ffn_residual(params, cfg, x + y)[0], cache
    h = apply_norm(params["attn_norm"], x, cfg.norm_type)
    a, _ = attn_mod.decode_attention_step(params["attn"], cfg, h,
                                          cache["kv"], kv_len)
    if cfg.hybrid:
        m, _ = ssm_mod.decode_ssm_step(params["ssm"], cfg, h, cache["ssm"])
        x = _mix(x, a, m)
    else:
        x = x + a
    if "cross_attn" in params and "cross_kv" in cache:
        h = apply_norm(params["cross_norm"], x, cfg.norm_type)
        x = x + attn_mod.cross_decode_attention_step(
            params["cross_attn"], cfg, h, cache["cross_kv"], enc_len)
    return _ffn_residual(params, cfg, x)[0], cache


def apply_stack_decode(blocks: list[Params], cfg: ModelConfig, x, caches,
                       kv_len, enc_len=None, shard=None):
    """A single token through all layers against the slot caches (updated
    in place); ``kv_len`` and ``enc_len`` are layer-invariant. ``shard``
    (a ``sharding.DecodeShard``): one rank of a sequence-sharded decode,
    ``caches`` its piece (``apply_block_decode_rank``). Returns (x,
    caches)."""
    for l, p_l in enumerate(blocks):
        layer = {name: {k: t[l] for k, t in leaves.items()}
                 for name, leaves in caches.items()}
        if shard is not None:
            x = apply_block_decode_rank(p_l, cfg, x, layer, kv_len, shard,
                                        enc_len)
        else:
            x, _ = apply_block_decode(p_l, cfg, x, layer, kv_len, enc_len)
    return x, caches


# ---------------------------------------------------------------------------
# one rank of a sequence-sharded decode (train.steps.make_sharded_serve_steps)
# ---------------------------------------------------------------------------

def _ffn_rank(params: Params, cfg: ModelConfig, x, shard):
    """x plus the block's MLP or MoE on a decode rank: an MLP with its
    hidden dim cut sums ``w_down``'s rows over "model", an MoE with its
    experts cut its experts' outputs (``moe.apply_moe``; no
    load-balancing statistics are summed: serving drops them)."""
    if "mlp_norm" not in params:
        return x
    h = apply_norm(params["mlp_norm"], x, cfg.norm_type)
    if "moe" in params:
        return x + moe_mod.apply_moe(params["moe"], cfg, h, shard=shard)[0]
    y = apply_mlp(params["mlp"], h, cfg.mlp_type)
    if shard.ff:
        y = comm.all_reduce_sum(y, shard.model)
    return x + y


def _capacity_slice(k, v, capacity: int, shard) -> Params:
    """This rank's slice [r C / m, (r + 1) C / m) of a slot cache of
    ``capacity`` holding the prompt's K/V rows (b, hkv, s, hd) at [0, s)."""
    m, r = shard.kv_rank
    if capacity % m:
        raise ValueError(f"capacity {capacity} does not cut into {m} "
                         f"slices over \"model\"")
    b, hkv, s, hd = k.shape
    if s > capacity:
        raise ValueError(f"a prompt of {s} rows exceeds the capacity "
                         f"{capacity}")
    cs = capacity // m
    lo, hi = r * cs, min(s, (r + 1) * cs)
    out = {}
    for name, t in (("k", k), ("v", v)):
        c = t.new_zeros((b, hkv, cs, hd))
        if hi > lo:
            c[:, :, :hi - lo] = t[:, :, lo:hi]
        out[name] = c
    return out


def apply_encoder_rank(blocks: list[Params], cfg: ModelConfig, x, shard):
    """An encoder's blocks (non-causal self-attention, the FFN) on a decode
    rank, tensor-parallel as the decoder's prefill."""
    for p_l in blocks:
        h = apply_norm(p_l["attn_norm"], x, cfg.norm_type)
        a, _, _ = attn_mod.kv_seq_prefill_attention(p_l["attn"], cfg, h,
                                                    shard, causal=False)
        x = _ffn_rank(p_l, cfg, x + a, shard)
    return x


def apply_block_prefill_rank(params: Params, cfg: ModelConfig, x,
                             capacity: int, shard, enc_out=None):
    """One block over a prompt on a decode rank: the tensor-parallel
    prefill at the rank's heads (``attention_layer.
    kv_seq_prefill_attention``), its SSM head group and FFN cut. Returns
    (x, cache_l): ``"kv"`` the rank's capacity slice of every head,
    ``"ssm"`` the rank's head group of the final SSM state,
    ``"cross_kv"`` (given the encoder's output ``enc_out``) the rank's
    slice of the encoder's K/V rows, exactly S_enc of them in all."""
    cache_l: Params = {}
    if cfg.family == "ssm":
        h = apply_norm(params["ssm_norm"], x, cfg.norm_type)
        y, cache_l["ssm"] = ssm_mod.apply_ssm(params["ssm"], cfg, h,
                                              return_final_state=True,
                                              shard=shard)
        return _ffn_rank(params, cfg, x + y, shard), cache_l
    h = apply_norm(params["attn_norm"], x, cfg.norm_type)
    a, k, v = attn_mod.kv_seq_prefill_attention(params["attn"], cfg, h,
                                                shard)
    cache_l["kv"] = _capacity_slice(k, v, capacity, shard)
    if cfg.hybrid:
        m, cache_l["ssm"] = ssm_mod.apply_ssm(params["ssm"], cfg, h,
                                              return_final_state=True,
                                              shard=shard)
        x = _mix(x, a, m)
    else:
        x = x + a
    if "cross_attn" in params and enc_out is not None:
        h = apply_norm(params["cross_norm"], x, cfg.norm_type)
        c, k, v = attn_mod.kv_seq_prefill_attention(params["cross_attn"],
                                                    cfg, h, shard,
                                                    kv_x=enc_out)
        cache_l["cross_kv"] = _capacity_slice(k, v, enc_out.shape[1], shard)
        x = x + c
    return _ffn_rank(params, cfg, x, shard), cache_l


def apply_stack_prefill_rank(blocks: list[Params], cfg: ModelConfig, x,
                             capacity: int, shard, enc_out=None):
    """A prompt through all layers on a decode rank; every cache leaf of
    the rank's piece stacked on a leading layer axis, written layer by
    layer into leaves allocated once."""
    caches = None
    for l, p_l in enumerate(blocks):
        x, c = apply_block_prefill_rank(p_l, cfg, x, capacity, shard,
                                        enc_out)
        if caches is None:
            caches = tree_map(lambda t: t.new_empty((len(blocks),
                                                     *t.shape)), c)
        for name, leaves in c.items():
            for k, t in leaves.items():
                caches[name][k][l] = t
    return x, caches


def apply_block_decode_rank(params: Params, cfg: ModelConfig, x, cache,
                            kv_len, shard, enc_len=None):
    """One block for one new token on a decode rank against its piece of
    the layer's slot cache (updated in place): the attention over the
    rank's capacity slice, merged over "model"
    (``attention_layer.kv_seq_decode_attention_step``), the SSM by head
    group, a decoder block's cross-attention over the rank's rows of the
    encoder's K/V (``kv_seq_cross_decode_step``, ``enc_len`` rows in
    all), the FFN cut. Returns x."""
    if cfg.family == "ssm":
        h = apply_norm(params["ssm_norm"], x, cfg.norm_type)
        y, _ = ssm_mod.decode_ssm_step(params["ssm"], cfg, h, cache["ssm"],
                                       shard=shard)
        return _ffn_rank(params, cfg, x + y, shard)
    h = apply_norm(params["attn_norm"], x, cfg.norm_type)
    a, _ = attn_mod.kv_seq_decode_attention_step(params["attn"], cfg, h,
                                                 cache["kv"], kv_len, shard)
    if cfg.hybrid:
        m, _ = ssm_mod.decode_ssm_step(params["ssm"], cfg, h, cache["ssm"],
                                       shard=shard)
        x = _mix(x, a, m)
    else:
        x = x + a
    if "cross_attn" in params and "cross_kv" in cache:
        h = apply_norm(params["cross_norm"], x, cfg.norm_type)
        x = x + attn_mod.kv_seq_cross_decode_step(
            params["cross_attn"], cfg, h, cache["cross_kv"], enc_len, shard)
    return _ffn_rank(params, cfg, x, shard)


def init_paged_decode_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                            dtype, device):
    """Per-layer page pools stacked on a leading layer axis:
    (L, hkv, num_pages, page_size, hd) per K/V leaf. Paging is an
    attention-family feature: SSM and hybrid state has no per-token rows."""
    if cfg.family not in ("dense", "moe") or cfg.hybrid:
        raise ValueError(f"family {cfg.family!r} (hybrid={cfg.hybrid}) has "
                         f"no pageable KV cache")
    layer = attn_mod.init_paged_kv_cache(cfg, num_pages, page_size, dtype,
                                         "meta")
    return {"kv": {k: torch.zeros((cfg.num_layers, *t.shape), dtype=dtype,
                                  device=device) for k, t in layer.items()}}


def _layer_pool(caches, l: int):
    """Views of layer l's page pool: in-place writes land in the stacked
    leaves."""
    return {"k": caches["kv"]["k"][l], "v": caches["kv"]["v"][l]}


def apply_stack_chunk_prefill(blocks: list[Params], cfg: ModelConfig, x,
                              caches, dest_page, dest_off, page_list,
                              q_seg, kv_seg, q_pos, kv_pos, mesh=None):
    """Packed prefill chunks through all layers, each writing its rows into
    its own pool layer and attending the prefix in place. The scatter map
    and page list are layer-invariant. Returns (x, caches) — caches
    updated in place."""
    for l, p_l in enumerate(blocks):
        h = apply_norm(p_l["attn_norm"], x, cfg.norm_type)
        a, _ = attn_mod.chunk_prefill_attention_step(
            p_l["attn"], cfg, h, _layer_pool(caches, l), dest_page, dest_off,
            page_list, q_seg, kv_seg, q_pos, kv_pos, mesh=mesh)
        x = _ffn_residual(p_l, cfg, x + a, mesh)[0]
    return x, caches


def apply_stack_decode_paged(blocks: list[Params], cfg: ModelConfig, x,
                             caches, page_table, kv_len, mesh=None,
                             shard=None, lanes=None):
    """A single token through all layers against the page pools (updated in
    place). ``page_table`` / ``kv_len`` are layer-invariant. ``shard`` (a
    ``sharding.DecodeShard``): one rank of a decode over a pool cut over
    "model", ``caches`` its pages, ``lanes`` every data rank's (table,
    lengths) where the pool is every data rank's
    (``attention_layer.kv_seq_paged_decode_attention_step``)."""
    for l, p_l in enumerate(blocks):
        h = apply_norm(p_l["attn_norm"], x, cfg.norm_type)
        if shard is not None:
            a, _ = attn_mod.kv_seq_paged_decode_attention_step(
                p_l["attn"], cfg, h, _layer_pool(caches, l), page_table,
                kv_len, shard, lanes=lanes)
            x = _ffn_rank(p_l, cfg, x + a, shard)
            continue
        a, _ = attn_mod.paged_decode_attention_step(
            p_l["attn"], cfg, h, _layer_pool(caches, l), page_table, kv_len,
            mesh=mesh)
        x = _ffn_residual(p_l, cfg, x + a, mesh)[0]
    return x, caches


def interleaved_page_table(lanes: int, pages_per_seq: int, device,
                           rows=None) -> "torch.Tensor":
    """The page table of a pool that holds ``lanes`` lanes' whole
    capacities, logical page t of lane b at pool page ``t * lanes + b``:
    a pool cut into m contiguous page ranges then gives each rank the
    logical pages [r T / m, (r + 1) T / m) of every lane, the slot
    cache's capacity slice (the sequence-sharded decode's prefill writes
    its pages so). ``rows``: the lanes [first, last) to return (default
    all). int32 (len(rows), pages_per_seq)."""
    lo, hi = rows or (0, lanes)
    b = torch.arange(lo, hi, device=device, dtype=torch.int32)[:, None]
    t = torch.arange(pages_per_seq, device=device, dtype=torch.int32)
    return t[None, :] * lanes + b

