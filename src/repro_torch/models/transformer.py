"""Decoder stack (port of the dense and MoE parts of
``repro.models.transformer``): pre-norm attention + MLP blocks (norm and
MLP by ``cfg.norm_type`` / ``cfg.mlp_type``), or attention + MoE blocks
for ``family="moe"``, run as a plain loop over layers (the JAX package
scans over stacked layers). The training stack sums the MoE layers'
load-balancing losses; the serving stacks drop them, as the reference
does. With
``cfg.remat`` the training stack checkpoints every block
(``torch.utils.checkpoint``, non-reentrant: only the block's input is
kept and the block runs again in the backward), as the JAX package's
``jax.checkpoint(policy=nothing_saveable)`` does."""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention_layer as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, init_mlp,
                                       init_norm)

Params = dict[str, Any]


def init_block(cfg: ModelConfig, dtype, *, generator, device) -> Params:
    kw = dict(generator=generator, device=device)
    p = {
        "attn_norm": init_norm(cfg.d_model, cfg.norm_type, dtype, device),
        "attn": attn_mod.init_attention(cfg, dtype, **kw),
        "mlp_norm": init_norm(cfg.d_model, cfg.norm_type, dtype, device),
    }
    if cfg.family == "moe":
        p["moe"] = moe_mod.init_moe(cfg, dtype, **kw)
    else:
        p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype, **kw)
    return p


def _ffn_residual(params: Params, cfg: ModelConfig, x):
    """x plus the block's MLP, or MoE, of its normalised self. Returns (x,
    aux): the MoE's load-balancing loss, or None for an MLP (the serving
    stacks drop it)."""
    h = apply_norm(params["mlp_norm"], x, cfg.norm_type)
    if "moe" in params:
        y, aux = moe_mod.apply_moe(params["moe"], cfg, h)
        return x + y, aux
    return x + apply_mlp(params["mlp"], h, cfg.mlp_type), None


def apply_block(params: Params, cfg: ModelConfig, x, *, segment_ids=None,
                deterministic: bool = True, dropout_seed=0):
    """One block, full sequence (training). Returns (x, aux_loss); aux is 0
    for the dense family."""
    h = apply_norm(params["attn_norm"], x, cfg.norm_type)
    x = x + attn_mod.apply_attention(params["attn"], cfg, h,
                                     segment_ids=segment_ids,
                                     deterministic=deterministic,
                                     dropout_seed=dropout_seed)
    x, aux = _ffn_residual(params, cfg, x)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def apply_stack(blocks: list[Params], cfg: ModelConfig, x, *,
                segment_ids=None, deterministic: bool = True,
                dropout_seed=0):
    """All blocks in order. Returns (x, total_aux_loss)."""
    def fn(p_l, h):
        return apply_block(p_l, cfg, h, segment_ids=segment_ids,
                           deterministic=deterministic,
                           dropout_seed=dropout_seed)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p_l in blocks:
        if cfg.remat:
            x, aux = checkpoint(fn, p_l, x, use_reentrant=False)
        else:
            x, aux = fn(p_l, x)
        aux_total = aux_total + aux
    return x, aux_total


def apply_block_prefill(params: Params, cfg: ModelConfig, x,
                        capacity: int | None = None, *, segment_ids=None,
                        positions=None):
    """One block over a (packed) prompt; returns (x, {"kv": {"k", "v"}})
    with the block's K/V rows (b, hkv, s, hd), or, given a ``capacity``,
    a (b, hkv, capacity, hd) slot cache holding them at [0, s)."""
    h = apply_norm(params["attn_norm"], x, cfg.norm_type)
    cache = (None if capacity is None else
             attn_mod.init_kv_cache(cfg, x.shape[0], capacity, x.dtype,
                                    x.device))
    a, kv = attn_mod.prefill_attention(params["attn"], cfg, h, cache,
                                       segment_ids=segment_ids,
                                       positions=positions)
    return _ffn_residual(params, cfg, x + a)[0], {"kv": kv}


def apply_stack_prefill(blocks: list[Params], cfg: ModelConfig, x,
                        capacity: int | None = None, *, segment_ids=None,
                        positions=None):
    """Prompt through all layers; K/V rows (or slot caches of
    ``capacity``) stacked on a leading layer axis:
    {"kv": {"k": (L, b, hkv, s or capacity, hd), "v": ...}}."""
    ks, vs = [], []
    for p_l in blocks:
        x, c = apply_block_prefill(p_l, cfg, x, capacity,
                                   segment_ids=segment_ids,
                                   positions=positions)
        ks.append(c["kv"]["k"])
        vs.append(c["kv"]["v"])
    return x, {"kv": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def init_decode_cache(cfg: ModelConfig, batch: int, capacity: int, dtype,
                      device):
    """Per-layer slot caches stacked on a leading layer axis:
    (L, batch, hkv, capacity, hd) per K/V leaf."""
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, capacity, cfg.head_dim)
    return {"kv": {"k": torch.zeros(shape, dtype=dtype, device=device),
                   "v": torch.zeros(shape, dtype=dtype, device=device)}}


def apply_block_decode(params: Params, cfg: ModelConfig, x, cache, kv_len):
    """One block for one new token against its slot cache (updated in
    place). Returns (x, cache)."""
    h = apply_norm(params["attn_norm"], x, cfg.norm_type)
    a, cache = attn_mod.decode_attention_step(params["attn"], cfg, h, cache,
                                              kv_len)
    return _ffn_residual(params, cfg, x + a)[0], cache


def apply_stack_decode(blocks: list[Params], cfg: ModelConfig, x, caches,
                       kv_len):
    """A single token through all layers against the slot caches (updated
    in place); ``kv_len`` is layer-invariant. Returns (x, caches)."""
    for l, p_l in enumerate(blocks):
        x, _ = apply_block_decode(p_l, cfg, x, _layer_pool(caches, l), kv_len)
    return x, caches


def init_paged_decode_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                            dtype, device):
    """Per-layer page pools stacked on a leading layer axis:
    (L, hkv, num_pages, page_size, hd) per K/V leaf."""
    shape = (cfg.num_layers, cfg.num_kv_heads, num_pages, page_size,
             cfg.head_dim)
    return {"kv": {"k": torch.zeros(shape, dtype=dtype, device=device),
                   "v": torch.zeros(shape, dtype=dtype, device=device)}}


def _layer_pool(caches, l: int):
    """Views of layer l's pool or slot cache: in-place writes land in the
    stacked leaves."""
    return {"k": caches["kv"]["k"][l], "v": caches["kv"]["v"][l]}


def apply_stack_chunk_prefill(blocks: list[Params], cfg: ModelConfig, x,
                              caches, dest_page, dest_off, page_list,
                              q_seg, kv_seg, q_pos, kv_pos):
    """Packed prefill chunks through all layers, each writing its rows into
    its own pool layer and attending the prefix in place. The scatter map
    and page list are layer-invariant. Returns (x, caches) — caches
    updated in place."""
    for l, p_l in enumerate(blocks):
        h = apply_norm(p_l["attn_norm"], x, cfg.norm_type)
        a, _ = attn_mod.chunk_prefill_attention_step(
            p_l["attn"], cfg, h, _layer_pool(caches, l), dest_page, dest_off,
            page_list, q_seg, kv_seg, q_pos, kv_pos)
        x = _ffn_residual(p_l, cfg, x + a)[0]
    return x, caches


def apply_stack_decode_paged(blocks: list[Params], cfg: ModelConfig, x,
                             caches, page_table, kv_len):
    """A single token through all layers against the page pools (updated in
    place). ``page_table`` / ``kv_len`` are layer-invariant."""
    for l, p_l in enumerate(blocks):
        h = apply_norm(p_l["attn_norm"], x, cfg.norm_type)
        a, _ = attn_mod.paged_decode_attention_step(
            p_l["attn"], cfg, h, _layer_pool(caches, l), page_table, kv_len)
        x = _ffn_residual(p_l, cfg, x + a)[0]
    return x, caches
