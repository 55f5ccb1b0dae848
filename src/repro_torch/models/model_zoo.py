"""Top-level dense decoder Model (port of the serving parts of
``repro.models.model_zoo``): init, packed prefill, chunked prefill against
the page pool, paged decode, and ``params_from_jax``.

Params are a plain dict: ``{"embed": (V, d), "final_norm": {...},
"blocks": [per-layer dicts]}`` with the JAX package's weight layouts
(``x @ W``, W of shape (d_in, d_out)). Every serving method runs under
``torch.inference_mode()`` (the decode state is created outside it, so
callers may edit it); the paged pool is updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm, dense_init, init_norm

Params = dict[str, Any]


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


@dataclasses.dataclass
class Model:
    cfg: ModelConfig

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator, device="cuda") -> Params:
        """Random weights drawn from ``generator`` on its own device, then
        placed on ``device`` (same shapes and initializer as the JAX
        package; the random stream differs)."""
        cfg = self.cfg
        dev = resolve_device(device)
        gdev = generator.device
        dtype = torch_dtype(cfg)
        kw = dict(generator=generator, device=gdev)
        p: Params = {
            "embed": dense_init(cfg.vocab_size, cfg.d_model, dtype, **kw),
            "final_norm": init_norm(cfg.d_model, dtype, gdev),
            "blocks": [tfm.init_block(cfg, dtype, **kw)
                       for _ in range(cfg.num_layers)],
        }
        return _map_tensors(p, lambda t: t.to(dev))

    # --------------------------------------------------------------- helpers
    def _logits(self, params, h):
        h = apply_norm(params["final_norm"], h)
        return h @ params["embed"].T        # tied head

    # --------------------------------------------------------------- serving
    def init_paged_decode_state(self, batch: int, num_pages: int,
                                page_size: int, pages_per_seq: int,
                                device="cuda"):
        """Decode state over a shared page pool: per-layer pools
        (L, hkv, num_pages, page_size, hd), a (batch, pages_per_seq) page
        table (negative = unallocated) and logical lengths."""
        dev = resolve_device(device)
        caches = tfm.init_paged_decode_cache(self.cfg, num_pages, page_size,
                                             torch_dtype(self.cfg), dev)
        return {"caches": caches,
                "page_table": torch.full((batch, pages_per_seq), -1,
                                         dtype=torch.int32, device=dev),
                "kv_len": torch.zeros((batch,), dtype=torch.int32,
                                      device=dev)}

    @torch.inference_mode()
    def prefill_packed(self, params, batch):
        """Prefill SEVERAL requests packed into one (1, S) sequence.
        batch: {"tokens": (1, S), "segment_ids": (1, S)}. Returns (caches,
        logits (1, S, V)); caches {"kv": {"k": (L, 1, hkv, S, hd), ...}}."""
        x = params["embed"][batch["tokens"].long()]
        h, caches = tfm.apply_stack_prefill(
            params["blocks"], self.cfg, x, segment_ids=batch["segment_ids"])
        return caches, self._logits(params, h)

    @torch.inference_mode()
    def prefill_chunk_paged(self, params, batch, caches):
        """Prefill the NEXT chunk of several sequences, packed, against the
        shared page pool. batch: tokens / q_segment_ids / q_positions
        (1, S); kv_segment_ids / kv_positions (1, Sk); dest_page / dest_off
        (S,); page_list (1, Sk // page_size). Returns (caches, logits
        (1, S, V)); caches updated in place."""
        x = params["embed"][batch["tokens"].long()]
        h, caches = tfm.apply_stack_chunk_prefill(
            params["blocks"], self.cfg, x, caches,
            batch["dest_page"], batch["dest_off"], batch["page_list"],
            batch["q_segment_ids"], batch["kv_segment_ids"],
            batch["q_positions"], batch["kv_positions"])
        return caches, self._logits(params, h)

    @torch.inference_mode()
    def decode_step(self, params, state, token):
        """token: (B,) int. Returns (new_state, logits (B, 1, V)); the pool
        is updated in place and ``kv_len`` advances by one."""
        if "page_table" not in state:
            raise NotImplementedError(
                "dense slot-cache decode is not ported yet; use the paged "
                "decode state (init_paged_decode_state)")
        x = params["embed"][token.long()[:, None]]
        h, caches = tfm.apply_stack_decode_paged(
            params["blocks"], self.cfg, x, state["caches"],
            state["page_table"], state["kv_len"])
        new_state = {"caches": caches, "page_table": state["page_table"],
                     "kv_len": state["kv_len"] + 1}
        return new_state, self._logits(params, h)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)


def _map_tensors(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tensors(v, fn) for v in tree]
    return fn(tree)


def params_to(params: Params, device) -> Params:
    """The same params on another device (a copy per leaf)."""
    dev = resolve_device(device)
    return _map_tensors(params, lambda t: t.to(dev))


def params_from_jax(np_tree, cfg: ModelConfig, device="cuda") -> Params:
    """The JAX package's parameter pytree (leaves as numpy arrays) -> this
    package's params. Blocks stacked on a leading layer axis (``init_stack``
    under ``scan_layers``) are unstacked into a per-layer list; a list of
    blocks is taken as is. Leaves are cast to the config's dtype through
    float32 (lossless for bf16 and f32)."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)

    def conv(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev, dtype)

    blocks = np_tree["blocks"]
    if isinstance(blocks, dict):
        blocks = [_map_tensors(blocks, lambda a, l=l: np.asarray(a)[l])
                  for l in range(cfg.num_layers)]
    out = {k: v for k, v in np_tree.items() if k != "blocks"}
    out["blocks"] = blocks
    return _map_tensors(out, conv)
