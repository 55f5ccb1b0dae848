"""Top-level dense decoder Model (port of the dense parts of
``repro.models.model_zoo``): init, ``forward``/``loss`` for training,
prefill into a slot cache, packed prefill, chunked prefill against the
page pool, decode against either cache, and ``params_from_jax``.

Params are a plain dict: ``{"embed": (V, d), "final_norm": {...},
"blocks": [per-layer dicts]}``, plus ``"lm_head": (d, V)`` when
``cfg.tie_embeddings`` is False, with the JAX package's weight layouts
(``x @ W``, W of shape (d_in, d_out)). ``forward`` and ``loss`` run with
autograd; every serving method runs under ``torch.inference_mode()`` (the decode state is created outside it, so
callers may edit it); the slot cache and the paged pool are updated in
place.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_map
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
            "final_norm": init_norm(cfg.d_model, cfg.norm_type, dtype, gdev),
            "blocks": [tfm.init_block(cfg, dtype, **kw)
                       for _ in range(cfg.num_layers)],
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = dense_init(cfg.d_model, cfg.vocab_size, dtype, **kw)
        return tree_map(lambda t: t.to(dev), p)

    # --------------------------------------------------------------- helpers
    def _logits(self, params, h):
        h = apply_norm(params["final_norm"], h, self.cfg.norm_type)
        head = params.get("lm_head")
        return h @ (params["embed"].T if head is None else head)

    def _batch_tensor(self, params, x):
        return torch.as_tensor(x).to(params["embed"].device)

    # -------------------------------------------------------------- training
    def forward(self, params, batch, *, deterministic: bool = True,
                dropout_seed=0):
        """Returns (logits, aux_loss). ``batch["segment_ids"]`` (B, S), when
        present, isolates packed documents in self-attention and makes RoPE
        segment-relative. Batch leaves may be numpy arrays or tensors."""
        tokens = self._batch_tensor(params, batch["tokens"]).long()
        segment_ids = batch.get("segment_ids")
        if segment_ids is not None:
            segment_ids = self._batch_tensor(params, segment_ids)
        x = params["embed"][tokens]
        h, aux = tfm.apply_stack(params["blocks"], self.cfg, x,
                                 segment_ids=segment_ids,
                                 deterministic=deterministic,
                                 dropout_seed=dropout_seed)
        return self._logits(params, h), aux

    def loss(self, params, batch, *, deterministic: bool = False,
             dropout_seed=0, aux_weight: float = 0.01):
        """Next-token cross-entropy in fp32 over ``loss_mask`` (default all
        ones). Returns (total, {"loss", "ce", "aux", "tokens"})."""
        logits, aux = self.forward(params, batch, deterministic=deterministic,
                                   dropout_seed=dropout_seed)
        tokens = self._batch_tensor(params, batch["tokens"]).long()
        logits = logits[:, :-1].float()
        targets = tokens[:, 1:]
        if "loss_mask" in batch:
            mask = self._batch_tensor(params, batch["loss_mask"]).float()
        else:
            mask = torch.ones(tokens.shape, dtype=torch.float32,
                              device=tokens.device)
        mask = mask[:, 1:]
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, targets[..., None])[..., 0]
        nll = (logz - gold) * mask
        denom = mask.sum().clamp_min(1.0)
        ce = nll.sum() / denom
        total = ce + aux_weight * aux
        return total, {"loss": total, "ce": ce, "aux": aux, "tokens": denom}

    # --------------------------------------------------------------- serving
    def decode_capacity(self, prompt_len: int, max_new: int) -> int:
        return prompt_len + max_new

    def init_decode_state(self, batch: int, capacity: int, device="cuda"):
        """Dense decode state: per-layer slot caches
        (L, batch, hkv, capacity, hd) and per-slot valid lengths."""
        dev = resolve_device(device)
        caches = tfm.init_decode_cache(self.cfg, batch, capacity,
                                       torch_dtype(self.cfg), dev)
        return {"caches": caches,
                "kv_len": torch.zeros((batch,), dtype=torch.int32,
                                      device=dev)}

    @torch.inference_mode()
    def prefill(self, params, batch, capacity: int):
        """Run the prompt (b, s) into fresh slot caches of ``capacity``;
        returns (state, last-token logits (b, 1, V))."""
        tokens = self._batch_tensor(params, batch["tokens"]).long()
        x = params["embed"][tokens]
        h, caches = tfm.apply_stack_prefill(params["blocks"], self.cfg, x,
                                            capacity)
        state = {"caches": caches,
                 "kv_len": torch.full((x.shape[0],), x.shape[1],
                                      dtype=torch.int32, device=x.device)}
        return state, self._logits(params, h[:, -1:])

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
        """token: (B,) int. Returns (new_state, logits (B, 1, V)); the cache
        is updated in place and ``kv_len`` advances by one. A ``page_table``
        key in the state selects the paged pool, else the slot cache."""
        x = params["embed"][token.long()[:, None]]
        if "page_table" in state:
            h, caches = tfm.apply_stack_decode_paged(
                params["blocks"], self.cfg, x, state["caches"],
                state["page_table"], state["kv_len"])
            new_state = {"caches": caches, "page_table": state["page_table"],
                         "kv_len": state["kv_len"] + 1}
            return new_state, self._logits(params, h)
        h, caches = tfm.apply_stack_decode(params["blocks"], self.cfg, x,
                                           state["caches"], state["kv_len"])
        return ({"caches": caches, "kv_len": state["kv_len"] + 1},
                self._logits(params, h))


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)


def params_to(params: Params, device) -> Params:
    """The same params on another device (a copy per leaf)."""
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), params)


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
        blocks = [tree_map(lambda a, l=l: np.asarray(a)[l], blocks)
                  for l in range(cfg.num_layers)]
    out = {k: v for k, v in np_tree.items() if k != "blocks"}
    out["blocks"] = blocks
    return tree_map(conv, out)
