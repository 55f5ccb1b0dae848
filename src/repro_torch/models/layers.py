"""Primitive layers (port of ``repro.models.layers``): RMSNorm, LayerNorm
and non-parametric LayerNorm, the parameter-free RMS normalization of
qk-norm, RoPE, the SwiGLU / GeGLU / GELU MLPs and the truncated-normal
initializer, with the logical sharding specs of the norms and MLPs
(``norm_specs``, ``mlp_specs``: tuples of logical axis names, as the
reference's). Params are plain dicts of tensors."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import P


def truncated_normal_init(shape, scale, dtype, *, generator, device):
    """N(0, stddev) truncated at +-2 stddev, stddev = scale / sqrt(fan_in)
    (the JAX package's initializer; the random stream differs)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    stddev = scale / max(1.0, fan_in) ** 0.5
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if w.is_meta:             # shapes only (``Model.param_shapes``)
        return w.to(dtype)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return (w * stddev).to(dtype)


def dense_init(d_in, d_out, dtype, *, generator, device, scale: float = 1.0):
    return truncated_normal_init((d_in, d_out), scale, dtype,
                                 generator=generator, device=device)


def init_norm(d, norm_type: str, dtype, device):
    if norm_type == "rmsnorm":
        return {"w": torch.ones((d,), dtype=dtype, device=device)}
    if norm_type == "layernorm":
        return {"w": torch.ones((d,), dtype=dtype, device=device),
                "b": torch.zeros((d,), dtype=dtype, device=device)}
    if norm_type == "layernorm_np":   # non-parametric (OLMo)
        return {}
    raise ValueError(norm_type)


def norm_specs(norm_type: str):
    if norm_type == "rmsnorm":
        return {"w": P(None)}
    if norm_type == "layernorm":
        return {"w": P(None), "b": P(None)}
    return {}


def apply_norm(params, x, norm_type: str, eps: float = 1e-5):
    """RMSNorm, or LayerNorm with the biased variance (scaled and shifted
    for ``layernorm``, not for ``layernorm_np``), in fp32; result in x's
    dtype."""
    xf = x.float()
    if norm_type == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        return (y * params["w"].float()).to(x.dtype)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if norm_type == "layernorm":
        y = y * params["w"].float() + params["b"].float()
    return y.to(x.dtype)


def rms_normalize(x, eps: float = 1e-6):
    """Parameter-free RMS normalization in fp32 (the base of qk-norm);
    result in x's dtype."""
    xf = x.float()
    return (xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split RoPE computed in fp32. x: (b, h, s, d); positions: (s,)
    or (b, s)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)
    angles = positions[..., None].float() * freqs
    if angles.ndim == 2:
        angles = angles[None, None]
    else:
        angles = angles[:, None]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def init_mlp(d_model, d_ff, mlp_type, dtype, *, generator, device):
    kw = dict(generator=generator, device=device)
    if mlp_type in ("swiglu", "geglu"):
        return {"w_gate": dense_init(d_model, d_ff, dtype, **kw),
                "w_up": dense_init(d_model, d_ff, dtype, **kw),
                "w_down": dense_init(d_ff, d_model, dtype, **kw)}
    return {"w_up": dense_init(d_model, d_ff, dtype, **kw),
            "w_down": dense_init(d_ff, d_model, dtype, **kw)}


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp_specs(mlp_type: str):
    if mlp_type in ("swiglu", "geglu"):
        return {"w_gate": P("embed", "ff"), "w_up": P("embed", "ff"),
                "w_down": P("ff", "embed")}
    return {"w_up": P("embed", "ff"), "w_down": P("ff", "embed")}


def apply_mlp(params, x, mlp_type):
    if mlp_type == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif mlp_type == "geglu":
        h = _gelu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = _gelu(x @ params["w_up"])
    return h @ params["w_down"]
