"""Top-level Model (port of ``repro.models.model_zoo`` for the dense, MoE,
SSM, hybrid, encoder-decoder and vision-language families):
init, ``forward``/``loss`` for training, prefill into a slot cache, packed
prefill, chunked prefill against the page pool, decode against either
cache, and ``params_from_jax``. Packed prefill and the page pool serve the
attention families only (``supports_packed_prefill``,
``supports_paged_decode``); SSM and hybrid models carry a recurrent state
beside (or instead of) the K/V cache and serve in dense slots.

Params are a plain dict: ``{"embed": (V, d), "final_norm": {...},
"blocks": [per-layer dicts]}``, plus ``"lm_head": (d, V)`` when
``cfg.tie_embeddings`` is False, and, for an encoder-decoder,
``"enc_blocks"`` (a list), ``"enc_final_norm"`` and ``"frontend_proj"``
(frontend_dim, d), with the JAX package's weight layouts
(``x @ W``, W of shape (d_in, d_out)). ``forward`` and ``loss`` run with
autograd; every serving method runs under ``torch.inference_mode()`` (the decode state is created outside it, so
callers may edit it); the slot cache and the paged pool are updated in
place.

A VLM's batch is ``{"patches": (B, frontend_tokens, frontend_dim),
"tokens": (B, S)}`` (the image frontend is a stub: patches are
precomputed embeddings): ``_embed_decoder_input`` projects the patches
and prepends them to the token embeddings, ``loss`` drops their logits,
and ``prefill`` caches the whole stream (``decode_step`` takes tokens).

An encoder-decoder's batch is ``{"frames": (B, S_enc, frontend_dim),
"tokens": (B, S)}`` (the audio frontend is a stub: frames are
precomputed embeddings): ``_encode`` projects the frames and runs the
encoder non-causal; the decoder's blocks cross-attend its output.
``prefill`` caches the encoder's K/V per layer and ``decode_step`` attends
them with ``kv_len`` = the encoder's length (``state["enc_len"]``); the
cross cache is padded to the decode kernel's tile
(``transformer.cross_capacity``), the reference's holds exactly S_enc
rows. Packed ``segment_ids`` are refused with a frontend or an encoder,
as in the reference.

``param_specs`` names the logical axes of every leaf (the reference's
specs leaf for leaf, without their stacked layer axis). A ``Model`` built
with a ``mesh`` (``distributed.meshes.ServeMesh``) is one rank's view of
a tensor- or sequence-parallel model: its config holds the rank's head
and d_ff counts, and its packed prefill, chunk prefill and paged decode
run the collectives of DESIGN.md §13-§14 over that mesh (the serving
engine builds it). A ``Model`` built with a ``shard``
(``distributed.sharding.TrainShard``) is one rank's view of a sharded
training step (``train.steps.make_sharded_train_step`` builds it): its
config holds the rank's head, d_ff and expert counts (the SSM reads its
head group off the shard); ``forward`` runs the tensor-parallel blocks
(every family's: the MoE's experts, the SSM's head groups, an encoder's
and a cross-attention's heads; ``frontend_proj`` stays replicated, its
gradient whole on every rank), a vocab-sharded embedding (a masked lookup of
the rank's rows, summed over "model") and logits (the rank's vocab
columns, tied or not), and ``loss`` the cross-entropy over the global
softmax (the max and the sum of exponentials over "model") in a form
whose gradients sum over the data ranks to the whole batch's: each rank
divides its rows' summed loss by the whole batch's token count.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_map
from repro_torch.distributed import comm
from repro_torch.models import transformer as tfm
from repro_torch.distributed.sharding import DecodeShard, P
from repro_torch.models.layers import (apply_norm, dense_init, init_norm,
                                       norm_specs)

Params = dict[str, Any]


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    mesh: Any = None
    shard: Any = None

    def param_specs(self) -> Params:
        """Logical specs of ``init``'s tree, leaf for leaf: ``blocks`` (and
        ``enc_blocks``) a list of per-layer spec dicts."""
        cfg = self.cfg
        enc = cfg.num_encoder_layers > 0
        s: Params = {"embed": P("vocab", "embed"),
                     "final_norm": norm_specs(cfg.norm_type),
                     "blocks": [tfm.block_specs(cfg, cross_attn=enc)
                                for _ in range(cfg.num_layers)]}
        if enc:
            s["enc_blocks"] = [tfm.block_specs(cfg)
                               for _ in range(cfg.num_encoder_layers)]
            s["enc_final_norm"] = norm_specs(cfg.norm_type)
        if cfg.frontend is not None:
            s["frontend_proj"] = P("embed", None)
        if not cfg.tie_embeddings:
            s["lm_head"] = P("embed", "vocab")
        return s

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator | None, device="cuda") -> Params:
        """Random weights drawn from ``generator`` on its own device, then
        placed on ``device`` (same shapes and initializer as the JAX
        package; the random stream differs). ``generator=None`` with
        ``device="meta"``: the tree's shapes and dtypes, nothing drawn or
        allocated (``param_shapes``)."""
        cfg = self.cfg
        dev = resolve_device(device)
        gdev = generator.device if generator is not None else dev
        dtype = torch_dtype(cfg)
        kw = dict(generator=generator, device=gdev)
        enc = cfg.num_encoder_layers > 0
        p: Params = {
            "embed": dense_init(cfg.vocab_size, cfg.d_model, dtype, **kw),
            "final_norm": init_norm(cfg.d_model, cfg.norm_type, dtype, gdev),
            "blocks": [tfm.init_block(cfg, dtype, cross_attn=enc, **kw)
                       for _ in range(cfg.num_layers)],
        }
        if enc:
            p["enc_blocks"] = [tfm.init_block(cfg, dtype, **kw)
                               for _ in range(cfg.num_encoder_layers)]
            p["enc_final_norm"] = init_norm(cfg.d_model, cfg.norm_type,
                                            dtype, gdev)
        if cfg.frontend is not None:
            p["frontend_proj"] = dense_init(cfg.frontend_dim, cfg.d_model,
                                            dtype, **kw)
        if not cfg.tie_embeddings:
            p["lm_head"] = dense_init(cfg.d_model, cfg.vocab_size, dtype, **kw)
        return tree_map(lambda t: t.to(dev), p)

    def param_shapes(self) -> Params:
        """``init``'s tree as meta tensors: the global shapes and dtypes."""
        return self.init(None, device="meta")

    # ----------------------------------------------------- dry-run interface
    def input_specs(self, shape):
        """One dry-run cell's inputs as meta tensors, with their logical
        specs (the reference's ``input_specs``): for a ``train`` or
        ``prefill`` ``configs.ShapeConfig`` the batch and its specs (an
        encoder-decoder's ``frames`` and tokens half the sequence each, a
        VLM's ``patches`` ahead of the tokens, a decoder's packed
        ``segment_ids`` when training, a ``loss_mask`` when training);
        for ``decode`` ((state, token), (state specs, token spec)), the
        state from ``init_decode_state`` on ``device="meta"`` (an
        encoder-decoder's also holds ``enc_len``)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        data = "data"

        def meta(*dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            if cfg.num_encoder_layers > 0:
                half = S // 2
                batch = {"frames": meta(B, half, cfg.frontend_dim,
                                        dtype=torch.float32),
                         "tokens": meta(B, half)}
                specs = {"frames": P(data, None, None),
                         "tokens": P(data, None)}
            elif cfg.frontend == "vision":
                nf = cfg.frontend_tokens
                batch = {"patches": meta(B, nf, cfg.frontend_dim,
                                         dtype=torch.float32),
                         "tokens": meta(B, S - nf)}
                specs = {"patches": P(data, None, None),
                         "tokens": P(data, None)}
            else:
                batch = {"tokens": meta(B, S)}
                specs = {"tokens": P(data, None)}
                if shape.kind == "train":
                    batch["segment_ids"] = meta(B, S)
                    specs["segment_ids"] = P(data, None)
            if shape.kind == "train":
                batch["loss_mask"] = meta(*batch["tokens"].shape,
                                          dtype=torch.float32)
                specs["loss_mask"] = P(data, None)
            return batch, specs
        enc = cfg.num_encoder_layers > 0
        capacity = S // 2 if enc else S
        state = self.init_decode_state(B, capacity, device="meta",
                                       enc_len=S // 2 if enc else 0)
        return (state, meta(B)), (self.decode_state_specs(), P(data))

    def decode_state_specs(self) -> Params:
        """Logical specs of ``init_decode_state``'s tree (with an encoder,
        its cross cache and ``enc_len``)."""
        enc = self.cfg.num_encoder_layers > 0
        specs = {"caches": tfm.decode_cache_specs(self.cfg, enc=enc),
                 "kv_len": P("data")}
        if enc:
            specs["enc_len"] = P("data")
        return specs

    def paged_decode_state_specs(self) -> Params:
        """Logical specs of ``init_paged_decode_state``'s tree (the
        reference's): the pool's pages over "kv_seq", as the slot cache's
        capacity; the page table and lengths follow the lanes."""
        return {"caches": tfm.paged_decode_cache_specs(),
                "page_table": P("data", None), "kv_len": P("data")}

    # --------------------------------------------------------------- helpers
    def _logits(self, params, h):
        h = apply_norm(params["final_norm"], h, self.cfg.norm_type)
        head = params.get("lm_head")
        if self.shard is not None and self.shard.vocab:
            h = comm.copy_to_group(h, self.shard.model)
        return h @ (params["embed"].T if head is None else head)

    def _embed(self, params, tokens):
        """The token embeddings; under a vocab-sharded ``shard`` a masked
        lookup of this rank's rows, summed over "model"."""
        if self.shard is None or not self.shard.vocab:
            return params["embed"][tokens]
        table = params["embed"]
        rows = table.shape[0]
        local = tokens - self.shard.model.index * rows
        hit = (local >= 0) & (local < rows)
        x = table[torch.where(hit, local, 0)] * hit[..., None].to(table.dtype)
        return comm.reduce_from_group(x, self.shard.model)

    def _batch_tensor(self, params, x):
        return torch.as_tensor(x).to(params["embed"].device)

    def _embed_decoder_input(self, params, batch):
        """The decoder's input stream (B, S, d): the token embeddings and,
        for a VLM, ``batch["patches"]`` (B, frontend_tokens, frontend_dim)
        through ``frontend_proj`` ahead of them (the stream then holds
        frontend_tokens + S rows; attention is causal over all of it and
        RoPE positions run over it, as in the reference)."""
        tokens = self._batch_tensor(params, batch["tokens"]).long()
        x = self._embed(params, tokens)
        if self.cfg.frontend == "vision":
            patches = self._batch_tensor(params, batch["patches"])
            front = patches.to(x.dtype) @ params["frontend_proj"]
            x = torch.cat([front, x], dim=1)
        return x

    def _encode(self, params, batch, deterministic: bool = True):
        """The encoder's output (B, S_enc, d): ``batch["frames"]`` through
        ``frontend_proj``, the encoder's blocks (non-causal) and its final
        norm."""
        frames = self._batch_tensor(params, batch["frames"])
        front = frames.to(params["frontend_proj"].dtype) @ params["frontend_proj"]
        h, _ = tfm.apply_stack(params["enc_blocks"], self.cfg, front,
                               deterministic=deterministic,
                               causal_override=False, shard=self.shard,
                               batch_offset=self._batch_offset(front))
        return apply_norm(params["enc_final_norm"], h, self.cfg.norm_type)

    # -------------------------------------------------------------- training
    def forward(self, params, batch, *, deterministic: bool = True,
                dropout_seed=0):
        """Returns (logits, aux_loss). ``batch["segment_ids"]`` (B, S), when
        present, isolates packed documents in self-attention and makes RoPE
        segment-relative. Batch leaves may be numpy arrays or tensors."""
        cfg = self.cfg
        segment_ids = batch.get("segment_ids")
        if segment_ids is not None:
            if cfg.frontend is not None or cfg.num_encoder_layers > 0:
                raise ValueError(
                    "packed segment_ids are a text-decoder feature: "
                    "frontends prepend a modality stream with its own "
                    "position space, and cross-attention reads one shared "
                    "encoder stream that cannot be isolated per packed "
                    "document")
            segment_ids = self._batch_tensor(params, segment_ids)
        enc_out = None
        if cfg.num_encoder_layers > 0:
            enc_out = self._encode(params, batch, deterministic)
        x = self._embed_decoder_input(params, batch)
        h, aux = tfm.apply_stack(params["blocks"], cfg, x, enc_out=enc_out,
                                 segment_ids=segment_ids,
                                 deterministic=deterministic,
                                 dropout_seed=dropout_seed, shard=self.shard,
                                 batch_offset=self._batch_offset(x))
        return self._logits(params, h), aux

    def _batch_offset(self, x) -> int:
        return 0 if self.shard is None else self.shard.batch_offset(x.shape[0])

    def loss(self, params, batch, *, deterministic: bool = False,
             dropout_seed=0, aux_weight: float = 0.01):
        """Next-token cross-entropy in fp32 over ``loss_mask`` (default all
        ones) on the token rows (a VLM's patch rows are dropped first).
        Returns (total, {"loss", "ce", "aux", "tokens"})."""
        logits, aux = self.forward(params, batch, deterministic=deterministic,
                                   dropout_seed=dropout_seed)
        tokens = self._batch_tensor(params, batch["tokens"]).long()
        if self.cfg.frontend == "vision":
            logits = logits[:, self.cfg.frontend_tokens:]
        logits = logits[:, :-1].float()
        targets = tokens[:, 1:]
        if "loss_mask" in batch:
            mask = self._batch_tensor(params, batch["loss_mask"]).float()
        else:
            mask = torch.ones(tokens.shape, dtype=torch.float32,
                              device=tokens.device)
        mask = mask[:, 1:]
        if self.shard is None:
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, targets[..., None])[..., 0]
            nll = (logz - gold) * mask
            denom = mask.sum().clamp_min(1.0)
            ce = nll.sum() / denom
            total = ce + aux_weight * aux
            return total, {"loss": total, "ce": ce, "aux": aux,
                           "tokens": denom}
        return self._sharded_loss(logits, targets, mask, aux, aux_weight)

    def _sharded_loss(self, logits, targets, mask, aux, aux_weight):
        """This rank's share of the whole batch's loss (its rows' summed
        cross-entropy over the whole batch's token count; the MoE's share
        from ``load_balance_loss``): the shares, and their gradients, sum
        over the data ranks to the unsharded loss's. With the vocab cut
        over "model", logsumexp and the gold logit come from the global
        max (``all_reduce_max``) and two sums over "model". ``tokens`` is
        the whole batch's token count (a replicated batch counted once)."""
        sh = self.shard
        if sh.vocab:
            cols = logits.shape[-1]
            top = comm.all_reduce_max(logits.detach().amax(dim=-1), sh.model)
            sumexp = comm.reduce_from_group(
                torch.exp(logits - top[..., None]).sum(dim=-1), sh.model)
            logz = top + torch.log(sumexp)
            local = targets - sh.model.index * cols
            hit = (local >= 0) & (local < cols)
            gold = logits.gather(-1, torch.where(hit, local, 0)[..., None])
            gold = comm.reduce_from_group(gold[..., 0] * hit, sh.model)
        else:
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, targets[..., None])[..., 0]
        nll = (logz - gold) * mask
        denom = mask.sum()
        if sh.data.size > 1:
            denom = comm.all_reduce_sum(denom.detach().clone(), sh.data)
        ce = nll.sum() / denom.clamp_min(1.0)
        total = ce + aux_weight * aux
        tokens = (denom if sh.batch_sharded else denom / sh.data.size)
        return total, {"loss": total, "ce": ce, "aux": aux,
                       "tokens": tokens.clamp_min(1.0)}

    # --------------------------------------------------------------- serving
    def decode_capacity(self, prompt_len: int, max_new: int) -> int:
        return prompt_len + max_new

    def init_decode_state(self, batch: int, capacity: int, device="cuda",
                          *, enc_len: int = 0):
        """Dense decode state: per-layer slot caches
        (L, batch, hkv, capacity, hd), the SSM state where the family has
        one, an encoder-decoder's cross caches for ``enc_len`` encoder rows
        (``transformer.init_decode_cache``), per-slot valid lengths and,
        with an encoder, ``"enc_len"`` (batch,)."""
        dev = resolve_device(device)
        caches = tfm.init_decode_cache(self.cfg, batch, capacity,
                                       torch_dtype(self.cfg), dev,
                                       enc_len=enc_len)
        state = {"caches": caches,
                 "kv_len": torch.zeros((batch,), dtype=torch.int32,
                                       device=dev)}
        if "cross_kv" in caches:
            state["enc_len"] = torch.full((batch,), enc_len,
                                          dtype=torch.int32, device=dev)
        return state

    @torch.inference_mode()
    def prefill(self, params, batch, capacity: int, *,
                page_size: int | None = None):
        """Run the prompt (b, s) into fresh slot caches of ``capacity``
        (and, for the SSM and hybrid families, the SSM state after the
        prompt; for an encoder-decoder, ``batch["frames"]`` through the
        encoder and its K/V into per-layer cross caches; for a VLM, the
        patches ahead of the prompt, so ``kv_len`` is frontend_tokens +
        the prompt); returns (state, last-token logits (b, 1, V)). A
        decode rank (``shard`` a ``DecodeShard``) returns its piece of
        the state (``_rank_prefill``; ``page_size``: as a page pool)."""
        if isinstance(self.shard, DecodeShard):
            return self._rank_prefill(params, batch, capacity, page_size)
        if page_size is not None:
            raise ValueError("prefill writes a page pool on a decode rank "
                             "only (make_sharded_serve_steps)")
        enc_out = None
        if self.cfg.num_encoder_layers > 0:
            enc_out = self._encode(params, batch)
        x = self._embed_decoder_input(params, batch)
        h, caches = tfm.apply_stack_prefill(params["blocks"], self.cfg, x,
                                            capacity, enc_out=enc_out)
        b, dev = x.shape[0], x.device
        state = {"caches": caches,
                 "kv_len": torch.full((b,), x.shape[1], dtype=torch.int32,
                                      device=dev)}
        if enc_out is not None:
            state["enc_len"] = torch.full((b,), enc_out.shape[1],
                                          dtype=torch.int32, device=dev)
        return state, self._logits(params, h[:, -1:])

    def supports_packed_prefill(self) -> bool:
        """Packed prefill scatters per-segment K/V row ranges into slots or
        pages: every cache leaf must be a length-indexed K/V cache. SSM
        and hybrid states, encoder and frontend streams do not split per
        segment."""
        cfg = self.cfg
        return (cfg.family in ("dense", "moe") and not cfg.hybrid
                and cfg.num_encoder_layers == 0 and cfg.frontend is None)

    def supports_paged_decode(self) -> bool:
        """Paged decode needs per-token K/V rows: the packed-prefill
        predicate, as in the reference."""
        return self.supports_packed_prefill()

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
            params["blocks"], self.cfg, x, segment_ids=batch["segment_ids"],
            mesh=self.mesh)
        return caches, self._logits(params, h)

    @torch.inference_mode()
    def prefill_chunk_paged(self, params, batch, caches):
        """Prefill the NEXT chunk of several sequences, packed, against the
        shared page pool. batch: tokens / q_segment_ids / q_positions
        (1, S); kv_segment_ids / kv_positions (1, Sk); dest_page / dest_off
        (S,); page_list (1, Sk // page_size). Returns (caches, logits
        (1, S, V)); caches updated in place. Under a mesh with sp > 1 the
        q-side rows are this rank's slab of S / sp rows (and so are the
        logits) while dest_page / dest_off cover the whole chunk."""
        x = params["embed"][batch["tokens"].long()]
        h, caches = tfm.apply_stack_chunk_prefill(
            params["blocks"], self.cfg, x, caches,
            batch["dest_page"], batch["dest_off"], batch["page_list"],
            batch["q_segment_ids"], batch["kv_segment_ids"],
            batch["q_positions"], batch["kv_positions"], mesh=self.mesh)
        return caches, self._logits(params, h)

    @torch.inference_mode()
    def decode_step(self, params, state, token):
        """token: (B,) int. Returns (new_state, logits (B, 1, V)); the cache
        (and every slot's SSM state, idle slots' too) is updated in place
        and ``kv_len`` advances by one. A ``page_table``
        key in the state selects the paged pool, else the slot cache. A
        decode rank (``shard`` a ``DecodeShard``) steps its lanes over its
        piece of the state (``_rank_decode_step``)."""
        if isinstance(self.shard, DecodeShard):
            return self._rank_decode_step(params, state, token)
        x = params["embed"][token.long()[:, None]]
        if "page_table" in state:
            h, caches = tfm.apply_stack_decode_paged(
                params["blocks"], self.cfg, x, state["caches"],
                state["page_table"], state["kv_len"], mesh=self.mesh)
            new_state = {"caches": caches, "page_table": state["page_table"],
                         "kv_len": state["kv_len"] + 1}
            return new_state, self._logits(params, h)
        h, caches = tfm.apply_stack_decode(params["blocks"], self.cfg, x,
                                           state["caches"], state["kv_len"],
                                           state.get("enc_len"))
        new_state = dict(state, caches=caches, kv_len=state["kv_len"] + 1)
        return new_state, self._logits(params, h)

    # ------------------------------------ one rank of a sequence-sharded decode
    def _rank_rows(self, batch):
        """This rank's lanes of a global batch (its rows over the data
        axes where the lanes are cut)."""
        sh = self.shard
        if not sh.batch_sharded:
            return batch
        n, i = sh.data.size, sh.data.index

        def rows(x):
            if x.shape[0] % n:
                raise ValueError(f"batch {x.shape[0]} does not cut into {n} "
                                 f"data ranks' lanes")
            b = x.shape[0] // n
            return x[i * b:(i + 1) * b]
        return {k: rows(v) for k, v in batch.items()}

    def _rank_logits(self, params, h):
        """Every vocab column's logits on a decode rank (a cut vocab's
        columns gathered over "model")."""
        logits = self._logits(params, h)
        if self.shard.vocab:
            logits = comm.all_gather(logits, self.shard.model, dim=-1)
        return logits

    def _rank_prefill(self, params, batch, capacity: int,
                      page_size: int | None):
        """A decode rank's prefill of its lanes: the tensor-parallel
        prefill (``transformer.apply_stack_prefill_rank``), keeping the
        rank's capacity slice of every head's K/V and its SSM head group.
        With ``page_size``, the slices as the rank's pages of a pool
        holding every lane's whole capacity in the interleaved layout
        (``transformer.interleaved_page_table``; every data rank's lanes,
        gathered over "data", where the lanes are cut: the pool is
        replicated over "data"). Returns (state piece, logits (b, 1, V) of
        the rank's lanes)."""
        cfg, sh = self.cfg, self.shard
        batch = self._rank_rows(batch)
        enc_out = None
        if cfg.num_encoder_layers > 0:
            frames = self._batch_tensor(params, batch["frames"])
            front = (frames.to(params["frontend_proj"].dtype)
                     @ params["frontend_proj"])
            enc_out = apply_norm(
                params["enc_final_norm"],
                tfm.apply_encoder_rank(params["enc_blocks"], cfg, front, sh),
                cfg.norm_type)
        x = self._embed_decoder_input(params, batch)
        h, caches = tfm.apply_stack_prefill_rank(params["blocks"], cfg, x,
                                                 capacity, sh, enc_out)
        b, s = x.shape[:2]
        kv_len = torch.full((b,), s, dtype=torch.int32, device=x.device)
        logits = self._rank_logits(params, h[:, -1:])
        if page_size is None:
            state = {"caches": caches, "kv_len": kv_len}
            if enc_out is not None:
                state["enc_len"] = torch.full((b,), enc_out.shape[1],
                                              dtype=torch.int32,
                                              device=x.device)
            return state, logits
        if "ssm" in caches:
            raise ValueError(f"family {cfg.family!r} (hybrid={cfg.hybrid}) "
                             f"has no pageable KV cache")
        m, r = sh.kv_rank
        T = capacity // page_size
        if capacity % page_size or T % m:
            raise ValueError(f"capacity {capacity} does not cut into pages "
                             f"of {page_size} whose count divides by {m}")
        kv = torch.stack([caches["kv"]["k"], caches["kv"]["v"]])
        lanes = (0, b)
        if sh.batch_sharded and sh.data.size > 1:
            kv = comm.all_gather(kv, sh.data, dim=2)
            lanes = (sh.data.index * b, (sh.data.index + 1) * b)
        _, L, B, hkv, cs, hd = kv.shape
        tl = cs // page_size
        pools = kv.view(2, L, B, hkv, tl, page_size, hd).permute(
            0, 1, 3, 4, 2, 5, 6).reshape(2, L, hkv, tl * B, page_size, hd)
        return {"caches": {"kv": {"k": pools[0].contiguous(),
                                  "v": pools[1].contiguous()}},
                "page_table": tfm.interleaved_page_table(B, T, x.device,
                                                         rows=lanes),
                "kv_len": kv_len}, logits

    def _rank_decode_step(self, params, state, token):
        """One decode step of a decode rank's lanes over its state piece
        (the K/V capacity or pages cut over "model", merged across ranks;
        ``transformer.apply_stack_decode`` / ``apply_stack_decode_paged``
        with the shard). Returns (new state piece, logits (b, 1, V))."""
        sh = self.shard
        x = self._embed(params, token.long()[:, None])
        if "page_table" in state:
            lanes = None
            if sh.batch_sharded and sh.data.size > 1:
                both = torch.cat([state["page_table"].to(torch.int32),
                                  state["kv_len"].to(torch.int32)[:, None]],
                                 dim=1)
                every = comm.all_gather(both, sh.data, dim=0)
                lanes = (every[:, :-1], every[:, -1])
            h, caches = tfm.apply_stack_decode_paged(
                params["blocks"], self.cfg, x, state["caches"],
                state["page_table"], state["kv_len"], shard=sh, lanes=lanes)
        else:
            h, caches = tfm.apply_stack_decode(
                params["blocks"], self.cfg, x, state["caches"],
                state["kv_len"], state.get("enc_len"), shard=sh)
        new_state = dict(state, caches=caches, kv_len=state["kv_len"] + 1)
        return new_state, self._rank_logits(params, h)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)


def require_token_inputs(cfg: ModelConfig, entry: str) -> None:
    """Raise for a model whose batch needs more than tokens: the
    encoder-decoder's ``frames`` (seamless-m4t-medium) or the VLM's
    ``patches`` (phi-3-vision-4.2b). ``entry`` feeds token prompts or
    ``SyntheticLM`` token batches only. The JAX package's engine passes
    tokens alone to ``Model.prefill`` and its train launcher feeds
    ``SyntheticLM`` tokens, so neither runs these families; such a model
    runs at model level (``forward``, ``loss``, ``prefill``,
    ``decode_step`` with the batch it needs, and ``make_train_step``).
    A VLM's ``decode_step`` takes tokens alone, as the reference's does."""
    if cfg.num_encoder_layers > 0 or cfg.frontend is not None:
        raise ValueError(
            f"{entry} feeds token inputs only, and {cfg.name} (family "
            f"{cfg.family!r}, frontend {cfg.frontend!r}) also reads "
            f"precomputed frontend embeddings, as the JAX package's engine "
            f"and train launcher cannot either; run it at model level "
            f"(Model.prefill / decode_step / loss, make_train_step) with "
            f"them in the batch")


def params_to(params: Params, device) -> Params:
    """The same params on another device (a copy per leaf)."""
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), params)


def params_from_jax(np_tree, cfg: ModelConfig, device="cuda") -> Params:
    """The JAX package's parameter pytree (leaves as numpy arrays) -> this
    package's params. Blocks (and an encoder's ``enc_blocks``) stacked on
    a leading layer axis (``init_stack`` under ``scan_layers``) are
    unstacked into a per-layer list; a list of blocks is taken as is. A float32 leaf stays float32 (the reference
    keeps some in a bf16 model: the MoE router, the SSM's ``A_log``, ``D``
    and ``dt_bias``); every other leaf is cast
    to the config's dtype through float32 (lossless for bf16 and f32)."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)

    def conv(a):
        a = np.asarray(a)
        to = torch.float32 if a.dtype == np.float32 else dtype
        return torch.from_numpy(np.array(a, np.float32)).to(dev, to)

    def unstack(blocks, n):
        if isinstance(blocks, dict):
            return [tree_map(lambda a, l=l: np.asarray(a)[l], blocks)
                    for l in range(n)]
        return blocks

    out = dict(np_tree)
    out["blocks"] = unstack(np_tree["blocks"], cfg.num_layers)
    if "enc_blocks" in np_tree:
        out["enc_blocks"] = unstack(np_tree["enc_blocks"],
                                    cfg.num_encoder_layers)
    return tree_map(conv, out)
