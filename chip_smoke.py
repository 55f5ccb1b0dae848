#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --ab PARENT_CHECKOUT    # A/B against another checkout

Imports nothing of JAX or of the JAX package; needs one CUDA card and the
repository checkout beside it (``src/repro_torch``). Seven main paths run
through the hand-written kernels: the trainable paged prefill (phase 2c),
paged serving (phases 3-4), dense-slot serving (phases 4b-4c) and training
(phases 5-6) of granite-3-2b, then training of bert-large with the paper's
LAMB recipe (phase 7), training of olmo-1b (phase 8) and paged serving of
qwen3-32b (phase 9). Phases:

1. print the card's name and power limit (nvidia-smi), then build every
   CUDA kernel of both paths from ``src/repro_torch/kernels/csrc`` (one
   nvcc per source, the three libraries started together), and count the
   tensor-core instructions (``HMMA``, ``cuobjdump -sass`` of the built
   library) in every bf16 ``flash_fwd_kernel`` instantiation, and, from
   ``-Xptxas -v`` compiles of ``flash_bwd.cu`` and ``flash_decode.cu``
   started beside the build, in every bf16 ``flash_bwd_dq_kernel`` /
   ``flash_bwd_dkv_kernel`` (paged, contiguous, contiguous with dropout)
   with its registers and spills: each must have some (no bf16 forward
   and no bf16 backward runs the scalar body), and no bf16 backward may
   spill; then every ``flash_decode_kernel`` instantiation's registers,
   shared memory (static, and the dynamic size and ring stages its
   launcher gives it), spills and HMMA: none may spill, and every bf16 one
   runs on the tensor cores;
2. kernels: each kernel against its plain PyTorch version at the main
   path's shapes in bf16 (hq 32 / hkv 8 / d 64, page 16): a ~2k-token
   packed prefill with several documents (flash_fwd), a 256-row chunk
   against 1.5k-token paged prefixes (flash_fwd_paged), decode at batch 8
   over ~1k-token contexts (flash_decode_paged: the whole decode, one
   launch that writes the split partials and merges them, its layout
   lowered beforehand; the plain version is the plain partials and the
   torch merge). Tolerances: max |o - o_plain| <= 2e-2 (bf16 output), m
   and l within 1e-2 relative, the decodes' split accumulators o_p within
   2e-2 once scaled by each split's max(1, l). Each is timed after
   warm-up, inputs rotated so the working set exceeds the 50 MB L2, as
   device time per call (``ms``: every kernel of the call summed by
   ``torch.profiler``) and as CUDA-event time per call (``call_ms``: the
   host's launch gaps included); the plain version is timed the same way
   (device time), and so is one ``scaled_dot_product_attention`` call with
   the equivalent boolean mask (``library_ms``; the port never calls it;
   for the two paged kernels
   SDPA runs on K/V gathered beforehand into a contiguous tensor, the
   gather not timed). At the training phase's per-layer shape in bf16 (q
   (4, 32, 2048, 64), k/v (4, 8, 2048, 64), causal, the segment ids of
   ``SyntheticLM(49155, 2048, 4, seed).batch_at(0)``): the forward against
   its plain version, the dq and dkv kernels fed the kernel forward's
   (o, m, l) against the plain backward fed the same (max |g - plain| /
   max |plain| <= 2e-2), a dropout_p = 0.1 forward + backward and a
   ``variant="paper"`` forward against the plain versions, two calls of
   the backward pair bit-identical (without and with dropout), each kernel
   timed (device time) beside its bound,
   its plain time and ``library_ms`` = the backward of SDPA alone
   (``torch.autograd.grad`` after one forward, boolean mask, GQA), and the
   pair's device time (dq + dkv) against it on a line of its own, beside
   the kernels' CTA walks (layout tiles a dq CTA visits, (q-block, head)
   items a dkv CTA visits: mean and max). The whole
   contiguous decode (flash_decode) at batch 8 over a 2048-slot
   cache, kv_len 900-1100, also with a window and with a kv_mask, against
   its plain version (SDPA over the cache with a boolean mask as library);
2c. paged backward: at flash_fwd_paged's shapes, one row per sequence,
   the first prefix page shared by both rows and dead slots: the paged dq
   and dkv kernels plus the fold kernel into pool shape against the plain
   backward (max |g - plain| / max |plain| <= 2e-2), untouched pages
   exactly zero, two calls bit-identical, one call of the whole backward
   under ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), the
   fold bit-equal to ``fold_packed_to_pool``; each kernel timed (library:
   SDPA's backward on pre-gathered K/V; ``index_add_`` for the fold), the
   whole backward by device and by event time. Then the path itself:
   launch counters reset, one forward + backward through
   ``core.attention.paged_prefill_attention`` with q and both pools
   requiring grad; the paged forward, dq, dkv and fold kernels must be
   > 0;
2d. kernels at the later paths' shapes (bf16, the same checks, times,
   bounds and SDPA yardsticks as phase 2b, without dropout and "paper"):
   the forward and the dq / dkv pair at train-bert's attention layer (q
   and k/v (56, 16, 512, 64), non-causal over the packed documents of its
   first batch) and at train-olmo's ((4, 16, 2048, 128), causal);
   printed as ``at_shapes`` sub-entries of those kernels' records, each
   with its launches on its path (serve-qwen3's come with phase 9);
3. parity: granite-3-2b at full width, 2 layers, float32: the same weights
   (drawn on the card) served by the engine on ``cuda`` (kernels) and on
   ``cpu`` (plain versions); greedy tokens must be identical (a divergence
   at a near-tie is reported with its step and top-2 logit margin);
4. serve: the published granite-3-2b (40 layers, bf16, random weights from
   the seed): 8 requests on 4 lanes, a 64-token shared prefix, one
   1024-token prompt prefilled in chunks of 256, 32 new tokens each. Every
   kernel's launch counter is reset just before and must be > 0 just
   after; prints tokens/s, TTFT p50 and peak memory beside the card. The
   same requests then run once more under ``torch.profiler``, with 8 new
   tokens each, for the device busy share and the kernels that take the
   most device time;
4b. dense parity: granite-3-2b at full width, 2 layers, float32, dense
   slot mode (``paged=False``) on ``cuda`` and on ``cpu``, and the paged
   engine on ``cuda``: greedy tokens identical;
4c. dense serve: the published model in dense slot mode with the decode
   kernel: 4 slots of 2048, 8 requests of 64-1024 prompt tokens, 32 new
   tokens each, drained requests prefilled packed; flash_fwd and
   flash_decode must be > 0 and flash_decode_paged 0; prints tokens/s,
   TTFT p50, decode step p50 and peak memory (not profiled);
5. train parity: granite-3-2b at full width, 2 layers, float32, seq 512,
   batch 2: the same random weights and ``SyntheticLM`` batches through two
   train steps on ``cuda`` (kernels) and on ``cpu`` (plain versions): losses
   within 1e-4 relative, layer 0's wq/wk/wv gradients of the first batch
   within 1e-3 scaled by their max;
6. train: the published granite-3-2b (40 layers, bf16, remat on) through
   the training launcher (``repro_torch.launch.train``: AdamW,
   warmup_cosine(3e-4, 20, steps), clip 1.0, deterministic), seq 2048,
   batch 4, 6 steps, step 1 excluded from the timing. Launch counters are
   reset just before and flash_fwd, flash_bwd_dq, flash_bwd_dkv must be > 0
   just after; every loss and grad norm finite; prints the first loss,
   tokens/s, ms/step and peak memory, then one more step under
   ``torch.profiler`` for the device busy share and the top kernels;
7. bert parity, then train-bert: bert-large at full width, 2 layers,
   float32, with ``lamb(warmup_poly(3.75e-3, 10, 7100))`` on ``cuda`` and
   on ``cpu`` (the tolerances of phase 5); then the published bert-large
   (24 layers, d 1024, 16 heads of 64, LayerNorm, GELU, non-causal, bf16,
   remat) with that recipe, clip 1.0, at seq 512 and batch 56 (the MLPerf
   step batch of 448 over the paper's 8 cards), 6 steps, through
   ``make_train_step`` and the ``Trainer``, with the checks, numbers and
   profile of phase 6;
8. olmo parity, then train-olmo: the same for olmo-1b (non-parametric
   LayerNorm, untied head, 16 heads of 128) with AdamW, then the
   published model (16 layers) through the training launcher at seq 2048,
   batch 4, 6 steps;
9. qwen3 parity, then serve-qwen3: qwen3-32b at full width, 2 layers,
   float32, served on ``cuda`` and on ``cpu`` (8 new tokens, the rules of
   phase 3); then qwen3-32b at its published width (d 5120, 64/8 heads of
   128, qk-norm, untied head, bf16) cut to 8 of its 64 layers, serving the
   requests of phase 4, with its checks, numbers and profile; then the
   same requests once more with the wrappers of flash_fwd (#1),
   flash_fwd_paged (#4) and flash_decode_paged (#8) watched, and each of
   the three held at the serve's call that did the most work (its
   layout, page list, positions and lane lengths, random q/K/V of its
   shapes) against its plain version, with the checks, times, bound and
   SDPA yardstick of phase 2, in a fresh Python process (the profiler
   stops recording whole windows late in this one), as ``at_shapes``
   sub-entries.

``--ab PARENT_CHECKOUT`` runs only an A/B against another checkout (e.g.
``git archive`` of the parent commit): first both checkouts' kernel
sources compiled with ``-Xptxas -v`` to cubins, printing every parent
kernel's registers, stack and spills on both sides and whether its SASS
(``cuobjdump -sass``) is identical; then this script's
``train_kernel_phase`` (first, so that both sides time the training
kernels from the same process state), ``kernel_phase``,
``paged_grad_ab`` (the paged dq and dkv kernels and the whole paged
backward), ``serve_phase``, ``dense_serve_phase`` and ``train_phase``
(without the profiled passes) on that checkout's package
and on this one's (one measurement for both sides; a decode of a checkout
without the fused launch is timed as its partials kernel and the torch
merge, ``whole_decode``), each in a fresh
process, in the order parent, change, change, parent on the same card,
then each side's per-run numbers (record in
``build/chip_smoke_ab.json``).

Prints one JSON line of kernel results (``launches`` summed over the seven
main paths' runs, per path under ``launches_by_path``), then as its last
line
``{"ok": true, "device": {...}}``. Exits non-zero on any failure, without
a CUDA device, or without the repository beside it. A full record is
written to ``build/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12          # dense bf16 tensor-core peak
FP32_FLOPS_PER_S = 67e12           # fp32 outside the tensor cores
L2_BYTES = 50e6


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(torch, fns, warmup=3, iters=20) -> float:
    """Time of one call on the card's clock (CUDA events around ``iters``
    calls), cycling over ``fns`` — one closure per rotated input copy. The
    host's gaps between launches count: a call whose wrapper takes longer
    on the host than its kernels on the card reads its host time."""
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fns, warmup=3, iters=20) -> float:
    """Device time of one call: every kernel the ``iters`` calls launch
    (cycling over ``fns``), summed by ``torch.profiler``, over ``iters``.
    Unlike ``time_ms`` it leaves out the host's gaps between launches,
    which set the CUDA-event time of a call that takes less device time
    than its wrapper takes host time. On the card's machine a profiled
    window now and then records no device event at all, or only some of
    the kernels it ran (seen early and late in a process, now and then
    several windows in a row; ``serve_shape_records_apart`` says what
    happens late in this script's process). Every call launches the same
    kernels, so
    a window is kept only if it counts each of its kernels a multiple of
    ``iters`` times; any other is profiled again after a pause, up to ten
    windows in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    for attempt in range(10):
        if attempt:
            print(f"[profile] window {attempt} recorded no device time or "
                  f"only part of its kernels: profiling again", flush=True)
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        us = sum(_device_us(e) for e in kernels)
        if us > 0 and all(e.count % iters == 0 for e in kernels):
            return us / 1e3 / iters
    raise SmokeFailure("torch.profiler recorded no whole window of device "
                       "time in ten")


def timed(torch, fns) -> tuple[float, float]:
    """(device_ms, time_ms) of the same calls."""
    return device_ms(torch, fns), time_ms(torch, fns)


def copies_for(nbytes: int) -> int:
    """Input copies to rotate so one pass exceeds twice the L2 cache."""
    return max(1, min(16, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def bound(nbytes: float, flops: float, dtype_peak: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / dtype_peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def release(torch) -> None:
    """Free what the last phase left: its objects (some sit in reference
    cycles) and the allocator's cached blocks, so that the next phase's
    peak memory is its own."""
    gc.collect()
    torch.cuda.empty_cache()


def rel_err(a, b) -> float:
    """max |a - b| / max(1, |b|) over finite entries (m and l)."""
    a, b = a.float(), b.float()
    return float(((a - b).abs() / b.abs().clamp_min(1.0)).max())


# ---------------------------------------------------------------------------
# phase 2: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def kernel_phase(torch, seed: int) -> list[dict]:
    from repro_torch.core import masks as M
    from repro_torch.kernels import tuning

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    hq, hkv, d, ps = 32, 8, 64, 16
    scale = d ** -0.5
    results = []

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=bf16)

    # -- flash_fwd: packed zero-offset prefill of several documents --------
    lengths = [700, 500, 400, 300, 148]
    S = sum(lengths)
    seg = torch.cat([torch.full((n,), i, dtype=torch.int32)
                     for i, n in enumerate(lengths)])[None].to(dev)
    bq, bk = tuning.fwd_tiles(d)
    spec = M.MaskSpec(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    layout = M.compile_block_layout(spec, S, S, bq, bk).as_array(dev)
    call = dict(scale=scale, causal=True, window=None, q_offset=0,
                block_q=bq, block_k=bk, q_segment_ids=seg, kv_segment_ids=seg)
    results.append(packed_prefill_record(
        torch, gen, (randn(1, hq, S, d), randn(1, hkv, S, d),
                     randn(1, hkv, S, d), None, layout), call,
        f"packed prefill b=1 S={S} docs={lengths}"))

    # -- flash_fwd_paged: chunks against paged prefixes ---------------------
    spans, chunks = [1536, 600], [192, 64]
    sq = sum(chunks)
    T = sum(-(-s // ps) for s in spans) + 2          # two dead slots
    num_pages = 400
    pages = torch.randperm(num_pages, generator=gen, device=dev).int()
    page_list = torch.full((1, T), -1, dtype=torch.int32, device=dev)
    kv_seg = torch.full((1, T * ps), M.SEG_PAD_KV, dtype=torch.int32, device=dev)
    kv_pos = torch.full((1, T * ps), M.POS_PAD, dtype=torch.int32, device=dev)
    q_seg = torch.empty((1, sq), dtype=torch.int32, device=dev)
    q_pos = torch.empty((1, sq), dtype=torch.int32, device=dev)
    slot = row = 0
    for i, (span, n) in enumerate(zip(spans, chunks)):
        np_ = -(-span // ps)
        page_list[0, slot:slot + np_] = pages[slot:slot + np_]
        kv_seg[0, slot * ps:slot * ps + span] = i
        kv_pos[0, slot * ps:slot * ps + span] = torch.arange(span, device=dev)
        q_seg[0, row:row + n] = i
        q_pos[0, row:row + n] = torch.arange(span - n, span, device=dev)
        slot, row = slot + np_, row + n
    pspec = M.MaskSpec(causal=True, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                       q_positions=q_pos, kv_positions=kv_pos)
    play = M.compile_block_layout(pspec, sq, T * ps, bq, ps).as_array(dev)
    play = M.paged_prefill_block_layout(play, page_list)
    pcall = dict(scale=scale, causal=True, window=None, block_q=bq,
                 q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                 q_positions=q_pos, kv_positions=kv_pos)
    results.append(paged_prefill_record(
        torch, gen, (randn(1, hq, sq, d), randn(hkv, num_pages, ps, d),
                     randn(hkv, num_pages, ps, d), page_list, play), pcall,
        f"chunks {chunks} against paged prefixes {spans}, page {ps}"))

    # -- flash_decode_paged: batch 8 over ~1k-token contexts, 1152-slot page
    # tables with unallocated tails
    kv_len = torch.tensor([900, 1100, 1000, 1024, 950, 1050, 980, 1070],
                          dtype=torch.int32, device=dev)
    b, T = len(kv_len), 1152 // ps
    table = torch.randperm(b * T, generator=gen, device=dev).int()
    table = table.reshape(b, T).clone()
    for i, n in enumerate(kv_len.tolist()):
        table[i, -(-(n + 1) // ps):] = -1           # unallocated tail
    dcall = dict(scale=scale, num_splits=tuning.resolve_paged_decode_splits(T),
                 window=None)
    results.append(paged_decode_record(
        torch, gen, (randn(b, hq, 1, d), randn(hkv, b * T, ps, d),
                     randn(hkv, b * T, ps, d), table, kv_len,
                     M.paged_block_layout(kv_len, table, ps)), dcall))
    results.append(contiguous_decode_record(torch, gen, randn, hq, hkv, d))
    return results


def fresh(torch, gen, t):
    """A random tensor on the card of ``t``'s shape and dtype."""
    return torch.randn(t.shape, generator=gen, device="cuda", dtype=t.dtype)


def copies(torch, gen, tensors, nbytes_: int) -> list[tuple]:
    """``tensors`` and enough random copies of them that one pass over all
    exceeds twice the L2 cache (``nbytes_`` per set)."""
    return [tuple(tensors)] + [tuple(fresh(torch, gen, t) for t in tensors)
                               for _ in range(copies_for(nbytes_) - 1)]


def scored_pairs(fa, q, sk, kv_mask, layout, call, block_k):
    """(b or 1, 1, sq, sk) bool, or (sq, sk): the (q, k) pairs the kernel
    scores, as its plain version masks them."""
    return fa._allowed(
        layout, kv_mask, b=q.shape[0], sq=q.shape[2], sk=sk, dev=q.device,
        causal=call["causal"], window=call["window"],
        q_offset=call.get("q_offset", 0),
        kv_valid_len=call.get("kv_valid_len"), block_q=call["block_q"],
        block_k=block_k, q_segment_ids=call.get("q_segment_ids"),
        kv_segment_ids=call.get("kv_segment_ids"),
        q_positions=call.get("q_positions"),
        kv_positions=call.get("kv_positions"))


def _meta(call) -> list:
    return [call.get(n) for n in ("q_segment_ids", "kv_segment_ids",
                                  "q_positions", "kv_positions")]


def packed_prefill_record(torch, gen, args, call, shape) -> dict:
    """flash_fwd (#1) on ``args`` = (q, k, v, kv_mask, layout) under
    ``call`` against its plain version; timed over random copies of q, k
    and v; SDPA with the pairs the kernel scores as a boolean mask is the
    library yardstick."""
    from repro_torch.kernels import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v, kv_mask, layout = args
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    out = fa.flash_attention_forward(*args, **call)
    torch.cuda.synchronize()
    plain = fa.flash_attention_forward_plain(*args, **call)
    sets = copies(torch, gen, (q, k, v), nbytes(q, k, v))
    ms, call_ms = timed(torch, [lambda a=a: fa.flash_attention_forward(
        *a, kv_mask, layout, **call) for a in sets])
    plain_ms = device_ms(torch, [lambda: fa.flash_attention_forward_plain(
        *args, **call)], warmup=1, iters=3)
    mask = scored_pairs(fa, q, sk, kv_mask, layout, call, call["block_k"])
    lib_ms = device_ms(torch, [lambda a=a: sdpa(
        *a, attn_mask=mask, scale=call["scale"], enable_gqa=True)
        for a in sets])
    pairs = int(mask.expand(b, 1, sq, sk).sum()) * hq
    b_ms, b_by = bound(nbytes(q, k, v, *out, kv_mask, layout, *_meta(call)),
                       4.0 * d * pairs, BF16_FLOPS_PER_S)
    return _kernel_record(
        "flash_fwd", "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "src/repro/kernels/flash_attention.py:325", out, plain, ms, plain_ms,
        b_ms, b_by, lib_ms, call_ms=call_ms, shape=shape,
        library="SDPA, bool mask")


def paged_prefill_record(torch, gen, args, call, shape) -> dict:
    """flash_fwd_paged (#4) on ``args`` = (q, k_pool, v_pool, page_list,
    layout) under ``call`` against its plain version; timed over random
    copies of q and the pools; SDPA on K/V gathered beforehand, with the
    pairs the kernel scores as a boolean mask, is the library yardstick."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import gather_pages

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k_pool, v_pool, page_list, layout = args
    b, hq, sq, d = q.shape
    hkv, _, ps, _ = k_pool.shape
    sk = page_list.shape[1] * ps
    out = fa.flash_prefill_paged_forward(*args, **call)
    torch.cuda.synchronize()
    plain = fa.flash_prefill_paged_forward_plain(*args, **call)
    live = int((page_list >= 0).sum())
    kv_bytes = 2 * live * hkv * ps * d * k_pool.element_size()
    sets = copies(torch, gen, (q, k_pool, v_pool), nbytes(q) + kv_bytes)
    ms, call_ms = timed(torch, [lambda a=a: fa.flash_prefill_paged_forward(
        *a, page_list, layout, **call) for a in sets])
    plain_ms = device_ms(torch, [lambda: fa.flash_prefill_paged_forward_plain(
        *args, **call)], warmup=1, iters=3)
    mask = scored_pairs(fa, q, sk, None, layout, call, ps)
    pairs = int(mask.expand(b, 1, sq, sk).sum()) * hq
    b_ms, b_by = bound(nbytes(q, *out, layout, page_list, *_meta(call))
                       + kv_bytes, 4.0 * d * pairs, BF16_FLOPS_PER_S)
    gathered = [(a[0], gather_pages(a[1], page_list),
                 gather_pages(a[2], page_list))
                for a in sets]                       # the gather is not timed
    lib_ms = device_ms(torch, [lambda a=a: sdpa(
        *a, attn_mask=mask, scale=call["scale"], enable_gqa=True)
        for a in gathered])
    del gathered
    return _kernel_record(
        "flash_fwd_paged", "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "src/repro/kernels/flash_attention.py:765", out, plain, ms, plain_ms,
        b_ms, b_by, lib_ms, call_ms=call_ms, shape=shape,
        library="SDPA on pre-gathered K/V, bool mask")


def paged_decode_record(torch, gen, args, call) -> dict:
    """flash_decode_paged (#8), the whole decode (one launch that writes the
    split partials and merges them, its layout lowered beforehand), on
    ``args`` = (q, k_pool, v_pool, page_table, kv_len, layout) under
    ``call`` (no window) against the plain partials and their torch merge;
    timed over random copies of q and the pools; SDPA on K/V gathered
    beforehand is the library yardstick."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.ref import gather_pages

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qd, k_pool, v_pool, table, kv_len, dlay = args
    b, hq, _, d = qd.shape
    hkv, _, ps, _ = k_pool.shape
    T = table.shape[1]
    check(call["window"] is None, "paged_decode_record takes no window")
    whole = whole_decode(fd, paged=True)
    o, parts = whole(*args, **call)
    torch.cuda.synchronize()
    pparts = fd.flash_decode_paged_partials_plain(*args, **call)
    out = (o, parts[1], parts[2])
    plain = (fd._merge_split_partials(*pparts, qd.dtype), pparts[1], pparts[2])
    o_p_err = check_partials("flash_decode_paged", parts, pparts)
    rows = sum(-(-n // ps) * ps for n in kv_len.tolist())
    kv_bytes = 2 * rows * hkv * d * k_pool.element_size()
    sets = copies(torch, gen, (qd, k_pool, v_pool), kv_bytes)
    ms, call_ms = timed(torch, [lambda a=a: whole(
        *a, table, kv_len, dlay, **call) for a in sets])
    plain_ms = device_ms(torch, [lambda: fd._merge_split_partials(
        *fd.flash_decode_paged_partials_plain(*args, **call), qd.dtype)],
        warmup=1, iters=3)
    pairs = int(kv_len.sum()) * hq
    b_ms, b_by = bound(nbytes(qd, o, *parts, table, kv_len, dlay) + kv_bytes,
                       4.0 * d * pairs, BF16_FLOPS_PER_S)
    dmask = (torch.arange(T * ps, device=qd.device)[None, :]
             < kv_len[:, None])[:, None, None, :]  # (b, 1, 1, T*ps) bool
    gathered = [(a[0], gather_pages(a[1], table), gather_pages(a[2], table))
                for a in sets]                       # the gather is not timed
    lib_ms = device_ms(torch, [lambda a=a: sdpa(
        *a, attn_mask=dmask, scale=call["scale"], enable_gqa=True)
        for a in gathered])
    del gathered
    rec = _kernel_record(
        "flash_decode_paged", "src/repro_torch/kernels/csrc/flash_decode.cu",
        "src/repro/kernels/flash_decode.py:329", out, plain, ms, plain_ms,
        b_ms, b_by, lib_ms, call_ms=call_ms,
        shape=f"whole decode b={b} hq={hq} hkv={hkv} d={d} kv_len "
              f"{kv_len.tolist()} page {ps} table {T} pages splits "
              f"{call['num_splits']}",
        library="SDPA on pre-gathered K/V, bool mask")
    rec["o_p_err"] = o_p_err
    return rec


def contiguous_decode_record(torch, gen, randn, hq, hkv, d) -> dict:
    """flash_decode (#7) at the dense serve's decode shape: batch 8 over a
    2048-slot cache, kv_len 900-1100; also checked with a window and with
    a kv_mask. Timed on the plain case; SDPA over the contiguous cache with
    the validity mask as a boolean mask and GQA is the library yardstick."""
    from repro_torch.core import masks as M
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import tuning

    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, cap = 8, 2048
    scale = d ** -0.5
    kv_len = torch.tensor([900, 1100, 1000, 1024, 950, 1050, 980, 1070],
                          dtype=torch.int32, device=dev)
    bk, splits = tuning.resolve_decode_geometry(cap, None, None)
    qd, kc, vc = randn(b, hq, 1, d), randn(b, hkv, cap, d), randn(b, hkv, cap, d)
    masked = torch.rand(b, cap, generator=gen, device=dev) > 0.25
    whole = whole_decode(fd, paged=False)
    errs = {}
    for case, window, kvm in (("plain", None, None), ("window 256", 256, None),
                              ("kv_mask", None, masked)):
        valid = M.decode_kv_valid(kv_len, cap, window=window, kv_mask=kvm)
        lay = M.kv_block_layout(valid, bk)
        call = dict(scale=scale, block_k=bk, num_splits=splits, window=window,
                    kv_mask=kvm)
        o, parts = whole(qd, kc, vc, kv_len, lay, **call)
        torch.cuda.synchronize()
        pparts = fd.flash_decode_partials_plain(qd, kc, vc, kv_len, lay, **call)
        out = (o, *parts[1:])
        plain = (fd._merge_split_partials(*pparts, torch.bfloat16), *pparts[1:])
        o_err = float((out[0].float() - plain[0].float()).abs().max())
        errs[case] = o_err
        check(o_err <= 2e-2, f"flash_decode ({case}): max |o - plain| {o_err}")
        check(rel_err(out[1], plain[1]) <= 1e-2 and rel_err(out[2], plain[2])
              <= 1e-2, f"flash_decode ({case}): m/l differ from the plain "
                       f"version")
        o_p_err = check_partials(f"flash_decode ({case})", parts, pparts)
        if case == "plain":
            first = (out, plain, lay, call, valid, parts, o_p_err)
    out, plain, lay, call, valid, parts, o_p_err = first
    rows = int(valid.sum())                  # the keys this data needs
    kv_bytes = 2 * rows * hkv * d * 2
    sets = [(qd, kc, vc)] + [(randn(b, hq, 1, d), randn(b, hkv, cap, d),
                              randn(b, hkv, cap, d))
                             for _ in range(copies_for(nbytes(kc, vc)) - 1)]
    ms, call_ms = timed(torch, [lambda a=a: whole(
        *a, kv_len, lay, **call) for a in sets])
    plain_ms = device_ms(torch, [lambda: fd._merge_split_partials(
        *fd.flash_decode_partials_plain(qd, kc, vc, kv_len, lay, **call),
        torch.bfloat16)], warmup=1, iters=3)
    b_ms, b_by = bound(nbytes(qd, out[0], *parts, kv_len, lay) + kv_bytes,
                       4.0 * d * rows * hq, BF16_FLOPS_PER_S)
    mask = valid[:, None, None, :]                # (b, 1, 1, cap) bool
    lib_ms = device_ms(torch, [lambda a=a: sdpa(*a, attn_mask=mask, scale=scale,
                                              enable_gqa=True) for a in sets])
    rec = _kernel_record(
        "flash_decode", "src/repro_torch/kernels/csrc/flash_decode.cu",
        "src/repro/kernels/flash_decode.py:169", out, plain, ms, plain_ms,
        b_ms, b_by, lib_ms, call_ms=call_ms,
        shape=f"whole contiguous decode b={b} capacity {cap} kv_len "
              f"{kv_len.tolist()} block_k {bk} splits {splits}",
        library="SDPA on the contiguous cache, bool mask, GQA")
    rec["case_errs"] = errs
    rec["o_p_err"] = o_p_err
    return rec


def whole_decode(fd, paged: bool):
    """The whole decode for a lowered layout, returning (out, (o_p, m_p,
    l_p)): the package's one fused launch, or, in a checkout that predates
    it (a ``--ab`` parent), its partials kernel followed by the torch
    merge, so both sides of an A/B compute the same function."""
    fused = getattr(fd, "flash_decode_paged_from_layout" if paged
                    else "flash_decode_from_layout", None)
    if fused is not None:
        return fused
    partials = (fd.flash_decode_paged_partials if paged
                else fd.flash_decode_partials)

    def call(q, *args, **kw):
        parts = partials(q, *args, **kw)
        return fd._merge_split_partials(*parts, q.dtype), parts
    return call


def check_partials(name, parts, plain_parts) -> float:
    """The split accumulators o_p against the plain version, each split's
    error scaled by its plain l: the error of the split's own normalized
    output, held to the bf16 output tolerance, 2e-2 (the bf16 kernel
    rounds P to bf16 for its P V product, as flash_fwd does; m and l are
    checked with the output)."""
    scale = plain_parts[2].float().clamp_min(1.0)[..., None]
    err = float(((parts[0].float() - plain_parts[0].float()).abs() / scale).max())
    check(err <= 2e-2, f"{name}: split partials o_p differ from the plain "
                       f"version (max |o_p - plain| / max(1, l) = {err})")
    return err


def _kernel_record(name, source, replaces, out, plain, ms, plain_ms, b_ms,
                   b_by, lib_ms, shape, library=None, call_ms=None):
    """One kernel's line: errors against the plain version, ``ms`` its
    device time per call (``device_ms``), ``call_ms`` its CUDA-event time
    per call (``time_ms``)."""
    o_err = float((out[0].float() - plain[0].float()).abs().max())
    m_err, l_err = rel_err(out[1], plain[1]), rel_err(out[2], plain[2])
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": None, "max_abs_err": o_err,
           "m_rel_err": m_err, "l_rel_err": l_err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": lib_ms, "library": library, "shape": shape,
           "call_ms": call_ms}
    print(f"[kernel] {name}: {shape}: max|o-plain| {o_err:.3g} "
          f"m rel {m_err:.3g} l rel {l_err:.3g}; {ms:.4f} ms on the card, "
          f"{call_ms:.4f} ms a call "
          f"(plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}"
          + (f", {library} {lib_ms:.4f} ms" if lib_ms is not None else "")
          + ")", flush=True)
    check(o_err <= 2e-2, f"{name}: max |o - plain| {o_err} > 2e-2")
    check(m_err <= 1e-2 and l_err <= 1e-2,
          f"{name}: m/l relative error {m_err}/{l_err} > 1e-2")
    return rec


# ---------------------------------------------------------------------------
# phase 2b: the training path's kernels at the training shape
# ---------------------------------------------------------------------------

def scaled_err(got, want) -> float:
    """max |got - want| / max |want| (gradients)."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def fwd_bwd_case(torch, gen, b, hq, hkv, S, d, causal, seg) -> dict:
    """The forward kernel against its plain version, then dq / dkv from the
    kernel forward's (o, m, l) against the plain backward from the same
    residuals, two calls of the pair bit-identical, at one training
    layer's attention shape in bf16 (packed documents ``seg``); each kernel
    timed (device time) beside its bound, its plain time and SDPA's.
    Returns the numbers, and the inputs and residuals for further checks."""
    from repro_torch.core import masks as M
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import tuning

    dev = torch.device("cuda")
    scale = d ** -0.5
    bq, bk = tuning.bwd_tiles(d)
    spec = M.MaskSpec(causal=causal, q_segment_ids=seg, kv_segment_ids=seg)
    layout = M.compile_block_layout(spec, S, S, bq, bk).as_array(dev)
    call = dict(scale=scale, causal=causal, window=None, q_offset=0,
                block_q=bq, block_k=bk, q_segment_ids=seg, kv_segment_ids=seg)
    shape = (f"train layer b={b} hq={hq} hkv={hkv} S={S} d={d}, "
             f"{'causal' if causal else 'non-causal'}, "
             f"{int(seg.max(dim=1).values.sum()) + b} documents")

    def randn(*shp):
        return torch.randn(*shp, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    q, k, v, do = randn(b, hq, S, d), randn(b, hkv, S, d), randn(b, hkv, S, d), \
        randn(b, hq, S, d)
    mask = spec.element_mask(S, S)                   # (b, 1, S, S) bool
    pairs = int(mask.sum()) * hq

    # -- the forward kernel against its plain version; its (o, m, l) are the
    # residuals of both backwards below
    o, m, l = fa.flash_attention_forward(q, k, v, None, layout, **call)
    torch.cuda.synchronize()
    fplain = fa.flash_attention_forward_plain(q, k, v, None, layout, **call)
    f_errs = (float((o.float() - fplain[0].float()).abs().max()),
              rel_err(m, fplain[1]), rel_err(l, fplain[2]))
    del fplain
    print(f"[train-kernel] flash_fwd {shape}: max |o - plain| {f_errs[0]:.3g}, "
          f"m rel {f_errs[1]:.3g}, l rel {f_errs[2]:.3g}", flush=True)
    check(f_errs[0] <= 2e-2, f"flash_fwd {shape}: max |o - plain| {f_errs[0]}")
    check(f_errs[1] <= 1e-2 and f_errs[2] <= 1e-2,
          f"flash_fwd {shape}: m/l relative error {f_errs[1:]} > 1e-2")
    res = (q, k, v, o, do, m, l, None, layout)

    # -- correctness: kernels against the plain backward --------------------
    got = fa.flash_attention_backward(*res, **call)
    torch.cuda.synchronize()
    want = fa.flash_attention_backward_plain(*res, **call)
    errs = dict(zip(("dq", "dk", "dv"), map(scaled_err, got, want)))
    abs_errs = {n: float((g.float() - w.float()).abs().max())
                for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    # an all-zero gradient would agree with the kernel's trivially
    check(all(float(w.float().abs().max()) > 0 for w in want),
          "the plain backward gave an all-zero gradient")
    del want
    print(f"[train-kernel] {shape}: scaled |grad - plain| {errs}", flush=True)
    for name, e in errs.items():
        check(e <= 2e-2, f"flash_bwd {shape}: {name} scaled error {e} > 2e-2")
    # deterministic: no atomics, the GQA sum in a fixed order
    again = fa.flash_attention_backward(*res, **call)
    check(all(torch.equal(a, g) for a, g in zip(again, got)),
          f"flash_bwd {shape}: two calls of the pair are not bit-identical")
    del again

    # -- times: each kernel alone (one input set exceeds 2x L2)
    ops_ = fa.prepare_backward(*res, **call)
    dq_ms = device_ms(torch, [lambda: fa.launch_dq(ops_)])
    dkv_ms = device_ms(torch, [lambda: fa.launch_dkv(ops_)])
    del ops_
    bwd_ms, pair_ms = timed(torch, [lambda: fa.flash_attention_backward(
        *res, **call)])
    plain_ms = device_ms(torch, [lambda: fa.flash_attention_backward_plain(
        *res, **call)], warmup=1, iters=3)
    fwd_ms, fwd_call_ms = timed(torch, [lambda: fa.flash_attention_forward(
        q, k, v, None, layout, **call)])
    fwd_plain_ms = device_ms(torch, [lambda: fa.flash_attention_forward_plain(
        q, k, v, None, layout, **call)], warmup=1, iters=3)

    # -- library yardstick: SDPA's backward alone, same mask, GQA ----------
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = sdpa(*leaves, attn_mask=mask, scale=scale, enable_gqa=True)
    lib_bwd_ms = device_ms(torch, [lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True)])
    del out, leaves
    lib_fwd_ms = device_ms(torch, [lambda: sdpa(q, k, v, attn_mask=mask,
                                              scale=scale, enable_gqa=True)])
    print(f"[train-kernel] backward pair against SDPA's backward: dq + dkv "
          f"{dq_ms + dkv_ms:.4f} ms on the card (dq {dq_ms:.4f}, dkv "
          f"{dkv_ms:.4f}); the whole flash_attention_backward {bwd_ms:.4f} ms "
          f"on the card, {pair_ms:.4f} ms a call; SDPA backward "
          f"{lib_bwd_ms:.4f} ms: the pair {(dq_ms + dkv_ms) / lib_bwd_ms:.2f}x "
          f"SDPA's time", flush=True)

    # -- bounds: each input read once, each output written once; FLOPs of
    # the minimal backward, 5 products of 2d per unmasked pair, split as
    # dkv: S, dP, dV, dK (8d) and dq: dQ (2d) so the two bounds add up
    ins = nbytes(q, k, v, do, m, l, layout, seg, seg) + m.numel() * 4  # + D
    return {
        "shape": shape, "call": call, "layout": layout, "res": res,
        "errs": errs, "abs_errs": abs_errs, "f_errs": f_errs,
        "dq_ms": dq_ms, "dkv_ms": dkv_ms, "bwd_ms": bwd_ms,
        "pair_ms": pair_ms, "plain_ms": plain_ms, "fwd_ms": fwd_ms,
        "fwd_call_ms": fwd_call_ms, "fwd_plain_ms": fwd_plain_ms,
        "lib_bwd_ms": lib_bwd_ms, "lib_fwd_ms": lib_fwd_ms,
        "dq_bound": bound(ins + nbytes(got[0]), 2.0 * d * pairs,
                          BF16_FLOPS_PER_S),
        "dkv_bound": bound(ins + nbytes(got[1], got[2]), 8.0 * d * pairs,
                           BF16_FLOPS_PER_S),
        "fwd_bound": bound(nbytes(q, k, v, o, m, l, layout, seg, seg),
                           4.0 * d * pairs, BF16_FLOPS_PER_S)}


def shape_entries(c: dict) -> dict:
    """One case of ``fwd_bwd_case`` as the sub-entries of the forward and
    of the dq / dkv kernels at that shape."""
    fwd = {"shape": c["shape"], "ms": c["fwd_ms"], "call_ms": c["fwd_call_ms"],
           "plain_ms": c["fwd_plain_ms"], "bound_ms": c["fwd_bound"][0],
           "bound_by": c["fwd_bound"][1], "library_ms": c["lib_fwd_ms"],
           "max_abs_err": c["f_errs"][0], "m_rel_err": c["f_errs"][1],
           "l_rel_err": c["f_errs"][2]}
    out = {"flash_fwd": fwd}
    for name, ms, (b_ms, b_by), grads in (
            ("flash_bwd_dq", c["dq_ms"], c["dq_bound"], ("dq",)),
            ("flash_bwd_dkv", c["dkv_ms"], c["dkv_bound"], ("dk", "dv"))):
        out[name] = {"shape": c["shape"], "ms": ms,
                     "plain_ms": c["plain_ms"], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": c["lib_bwd_ms"],
                     "max_abs_err": max(c["abs_errs"][g] for g in grads),
                     "scaled_err": max(c["errs"][g] for g in grads),
                     "pair_device_ms": c["dq_ms"] + c["dkv_ms"],
                     "backward_ms": c["bwd_ms"], "pair_ms": c["pair_ms"]}
    for name, e in out.items():
        print(f"[kernel] {name} at {e['shape']}: {e['ms']:.4f} ms on the card "
              f"(plain {e['plain_ms']:.3f} ms, bound {e['bound_ms']:.4f} ms by "
              f"{e['bound_by']}, SDPA {e['library_ms']:.4f} ms)", flush=True)
    return out


def train_kernel_phase(torch, seed: int) -> tuple[list[dict], dict]:
    """``fwd_bwd_case`` at the per-layer shape of the training phase, then
    a dropout forward + backward and a "paper" forward against the plain
    versions; returns the two backward records and the forward's numbers
    at this shape."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    b, hq, hkv, S, d = 4, 32, 8, 2048, 64
    seg = torch.as_tensor(SyntheticLM(49155, S, b, seed=seed).batch_at(0)
                          ["segment_ids"]).to(dev)
    c = fwd_bwd_case(torch, gen, b, hq, hkv, S, d, True, seg)
    shape, call, layout = c["shape"], c["call"], c["layout"]
    q, k, v, o, do, m, l = c["res"][:7]
    bq, bk = call["block_q"], call["block_k"]
    # the walks of the two kernels' CTAs: dq's the tiles of its layout row,
    # dkv's the q-blocks of its layout column times the n_rep heads
    runs = layout.reshape(-1, S // bq, S // bk) != 0
    row_walk = runs.sum(dim=2).float()
    col_walk = runs.sum(dim=1).float() * (hq // hkv)
    walks = {"dq_tiles_mean": float(row_walk.mean()),
             "dq_tiles_max": int(row_walk.max()),
             "dkv_items_mean": float(col_walk.mean()),
             "dkv_items_max": int(col_walk.max())}
    print(f"[train-kernel] CTA walks at the train layer: dq "
          f"{walks['dq_tiles_mean']:.2f} kv tiles a CTA (max "
          f"{walks['dq_tiles_max']}), dkv {walks['dkv_items_mean']:.2f} "
          f"(q-block, head) items a CTA (max {walks['dkv_items_max']})",
          flush=True)

    # -- dropout 0.1: forward and backward against the plain versions ------
    dcall = dict(call, dropout_p=0.1, dropout_seed=seed + 7,
                 dropout_dims=(S, S))
    dout = fa.flash_attention_forward(q, k, v, None, layout, **dcall)
    torch.cuda.synchronize()
    dplain = fa.flash_attention_forward_plain(q, k, v, None, layout, **dcall)
    d_o_err = float((dout[0].float() - dplain[0].float()).abs().max())
    check(d_o_err <= 2e-2, f"flash_fwd dropout: max |o - plain| {d_o_err}")
    check(rel_err(dout[1], dplain[1]) <= 1e-2 and rel_err(dout[2], dplain[2])
          <= 1e-2, "flash_fwd dropout: m/l differ from the plain version")
    dres = (q, k, v, dout[0], do, dout[1], dout[2], None, layout)
    dgot = fa.flash_attention_backward(*dres, **dcall)
    torch.cuda.synchronize()
    dwant = fa.flash_attention_backward_plain(*dres, **dcall)
    derrs = dict(zip(("dq", "dk", "dv"), map(scaled_err, dgot, dwant)))
    del dwant, dplain, dout
    print(f"[train-kernel] dropout 0.1: max |o - plain| {d_o_err:.3g}, "
          f"scaled |grad - plain| {derrs}", flush=True)
    for name, e in derrs.items():
        check(e <= 2e-2, f"flash_bwd dropout: {name} scaled error {e} > 2e-2")
    again = fa.flash_attention_backward(*dres, **dcall)
    check(all(torch.equal(a, g) for a, g in zip(again, dgot)),
          "flash_bwd dropout: two calls of the pair are not bit-identical")
    del again
    print("[train-kernel] two calls of the pair bit-identical, without and "
          "with dropout 0.1", flush=True)
    fwd_drop_ms = device_ms(torch, [lambda: fa.flash_attention_forward(
        q, k, v, None, layout, **dcall)])
    dops = fa.prepare_backward(*dres, **dcall)
    dq_drop_ms = device_ms(torch, [lambda: fa.launch_dq(dops)])
    dkv_drop_ms = device_ms(torch, [lambda: fa.launch_dkv(dops)])

    # -- variant "paper": forward against the plain version ----------------
    pcall = dict(call, variant="paper")
    pout = fa.flash_attention_forward(q, k, v, None, layout, **pcall)
    torch.cuda.synchronize()
    pplain = fa.flash_attention_forward_plain(q, k, v, None, layout, **pcall)
    p_err = float((pout[0].float() - pplain[0].float()).abs().max())
    check(p_err <= 2e-2, f"flash_fwd paper: max |o - plain| {p_err} > 2e-2")
    fwd_paper_ms = device_ms(torch, [lambda: fa.flash_attention_forward(
        q, k, v, None, layout, **pcall)])

    lib = "SDPA backward (dq, dk, dv together), bool mask, GQA"
    recs = []
    for name, ms, (b_ms, b_by), grads, drop_ms, line in (
            ("flash_bwd_dq", c["dq_ms"], c["dq_bound"], ("dq",), dq_drop_ms,
             581),
            ("flash_bwd_dkv", c["dkv_ms"], c["dkv_bound"], ("dk", "dv"),
             dkv_drop_ms, 612)):
        err = max(c["errs"][g] for g in grads)
        rec = {"name": name, "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
               "replaces": f"src/repro/kernels/flash_attention.py:{line}",
               "launches": None,
               "max_abs_err": max(c["abs_errs"][g] for g in grads),
               "scaled_err": err, "ms": ms, "plain_ms": c["plain_ms"],
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": c["lib_bwd_ms"], "library": lib,
               "shape": shape, "dropout_ms": drop_ms,
               "pair_ms": c["pair_ms"],
               "pair_device_ms": c["dq_ms"] + c["dkv_ms"],
               "backward_ms": c["bwd_ms"],
               "plain_ms_is": "the plain backward (dq, dk, dv together)"}
        recs.append(rec)
        print(f"[kernel] {name}: {shape}: scaled err {err:.3g}; {ms:.4f} ms "
              f"(dropout 0.1: {drop_ms:.4f} ms; plain backward "
              f"{c['plain_ms']:.3f} ms, bound {b_ms:.4f} ms by {b_by}, {lib} "
              f"{c['lib_bwd_ms']:.4f} ms)", flush=True)
    fwd = {"shape": shape, "ms": c["fwd_ms"], "call_ms": c["fwd_call_ms"],
           "dropout_ms": fwd_drop_ms,
           "paper_ms": fwd_paper_ms, "plain_ms": c["fwd_plain_ms"],
           "bound_ms": c["fwd_bound"][0], "bound_by": c["fwd_bound"][1],
           "library_ms": c["lib_fwd_ms"], "max_abs_err": c["f_errs"][0],
           "m_rel_err": c["f_errs"][1], "l_rel_err": c["f_errs"][2],
           "dropout_max_abs_err": d_o_err,
           "paper_max_abs_err": p_err, "bwd_pair_ms": c["pair_ms"],
           "bwd_pair_device_ms": c["dq_ms"] + c["dkv_ms"],
           "bwd_ms": c["bwd_ms"], "bwd_cta_walks": walks,
           "dropout_grad_errs": derrs}
    print(f"[kernel] flash_fwd at the train shape: {c['fwd_ms']:.4f} ms on the "
          f"card ({c['fwd_call_ms']:.4f} ms a call), dropout "
          f"0.1 {fwd_drop_ms:.4f} ms, paper {fwd_paper_ms:.4f} ms (plain "
          f"{c['fwd_plain_ms']:.3f} ms, bound {c['fwd_bound'][0]:.4f} ms by "
          f"{c['fwd_bound'][1]}, SDPA forward {c['lib_fwd_ms']:.4f} ms); "
          f"backward pair {c['pair_ms']:.4f} ms", flush=True)
    return recs, fwd


def new_shape_kernel_phase(torch, seed: int) -> dict:
    """The kernels at the shapes of the two later training paths: #1/#2/#3
    at train-bert's attention layer (non-causal, its packed documents, d
    64, MHA) and at train-olmo's (causal, d 128, MHA), each through
    ``fwd_bwd_case``. Returns {kernel: {path: entry}}; serve-qwen3's
    kernels are held at its shapes by ``serve_phase``."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    at: dict = {}
    for path, (arch, S, b) in NEW_TRAIN_PATHS.items():
        cfg = get_config(arch)
        # the segments of the path's first batch
        seg = torch.as_tensor(SyntheticLM(cfg.vocab_size, S, b, seed=seed)
                              .batch_at(0)["segment_ids"]).to(dev)
        c = fwd_bwd_case(torch, gen, b, cfg.num_heads, cfg.num_kv_heads, S,
                         cfg.head_dim, cfg.causal, seg)
        for name, e in shape_entries(c).items():
            at.setdefault(name, {})[path] = e
        del c
        release(torch)
    return at


# ---------------------------------------------------------------------------
# phase 2c: the trainable paged prefill's backward kernels
# ---------------------------------------------------------------------------

def paged_grad_case(torch, seed: int, *, requires_grad=False) -> dict:
    """The paged prefill at the serving shapes of flash_fwd_paged (chunks of
    192 and 64 rows against 1536- and 600-token prefixes, page 16, hq 32 /
    hkv 8 / d 64, bf16), one row per sequence: both rows' first prefix page
    is the same pool page (a shared prefix), two dead slots per row, the
    short row's q tail padded. Returns the inputs, the compiled layout and
    the call's keyword arguments."""
    from repro_torch.core import masks as M
    from repro_torch.kernels import tuning

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    hq, hkv, d, ps, num_pages = 32, 8, 64, 16, 400
    spans, chunks = [1536, 600], [192, 64]
    sq = max(chunks)
    T = max(-(-s // ps) for s in spans) + 2
    pages = torch.randperm(num_pages, generator=gen, device=dev).int()
    page_list = torch.full((2, T), -1, dtype=torch.int32, device=dev)
    kv_seg = torch.full((2, T * ps), M.SEG_PAD_KV, dtype=torch.int32, device=dev)
    kv_pos = torch.full((2, T * ps), M.POS_PAD, dtype=torch.int32, device=dev)
    q_seg = torch.full((2, sq), M.SEG_PAD_Q, dtype=torch.int32, device=dev)
    q_pos = torch.full((2, sq), M.POS_PAD, dtype=torch.int32, device=dev)
    nxt = 1
    for r, (span, n) in enumerate(zip(spans, chunks)):
        np_ = -(-span // ps)
        page_list[r, 0] = pages[0]                       # the shared page
        page_list[r, 1:np_] = pages[nxt:nxt + np_ - 1]
        nxt += np_ - 1
        kv_seg[r, :span] = 0
        kv_pos[r, :span] = torch.arange(span, device=dev)
        q_seg[r, :n] = 0
        q_pos[r, :n] = torch.arange(span - n, span, device=dev)

    def randn(*shape):
        t = torch.randn(*shape, generator=gen, device=dev, dtype=torch.bfloat16)
        return t.requires_grad_() if requires_grad else t

    ids = dict(q_segment_ids=q_seg, kv_segment_ids=kv_seg, q_positions=q_pos,
               kv_positions=kv_pos)
    bq = tuning.fwd_tiles(d)[0]
    spec = M.MaskSpec(causal=True, **ids)
    layout = M.compile_block_layout(spec, sq, T * ps, bq, ps).as_array(dev)
    layout = M.paged_prefill_block_layout(layout, page_list)
    return {"q": randn(2, hq, sq, d), "k_pool": randn(hkv, num_pages, ps, d),
            "v_pool": randn(hkv, num_pages, ps, d), "page_list": page_list,
            "do": randn(2, hq, sq, d).detach(), "ids": ids, "layout": layout,
            "mask": spec.element_mask(sq, T * ps),   # (2, 1, sq, T*ps) bool
            "call": dict(scale=d ** -0.5, causal=True, window=None,
                         block_q=bq, **ids),
            "shape": f"chunks {chunks} against paged prefixes {spans} "
                     f"(one row each, first page shared, 2 dead slots), "
                     f"page {ps}"}


def paged_grad_kernel_phase(torch, seed: int) -> list[dict]:
    """The paged dq and dkv kernels and the fold kernel against the plain
    backward over the gathered pages: dq, dk_pool, dv_pool within 2e-2 of
    their max, untouched pages exactly zero, two calls bit-identical, the
    whole backward free of host syncs (``torch.cuda.set_sync_debug_mode
    ("error")``), the fold bit-equal to ``fold_packed_to_pool``; each
    kernel timed beside its bound, the plain version's time and one
    PyTorch call (SDPA's backward on pre-gathered K/V; ``index_add_`` for
    the fold), and the whole backward by device and by event time."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import gather_pages

    c = paged_grad_case(torch, seed)
    q, k_pool, v_pool, page_list = c["q"], c["k_pool"], c["v_pool"], c["page_list"]
    call, d = c["call"], q.shape[-1]
    o, m, l = fa.flash_prefill_paged_forward(q, k_pool, v_pool, page_list,
                                             c["layout"], **call)
    res = (q, k_pool, v_pool, page_list, o, c["do"], m, l, c["layout"])
    got = fa.flash_prefill_paged_backward(*res, **call)
    torch.cuda.synchronize()
    want = fa.flash_prefill_paged_backward_plain(*res, **call)
    errs = dict(zip(("dq", "dk_pool", "dv_pool"), map(scaled_err, got, want)))
    abs_errs = {n: float((g.float() - w.float()).abs().max())
                for n, g, w in zip(errs, got, want)}
    check(all(float(w.float().abs().max()) > 0 for w in want),
          "the plain paged backward gave an all-zero gradient")
    named = torch.zeros(k_pool.shape[1], dtype=torch.bool, device=q.device)
    named[page_list[page_list >= 0].long()] = True
    untouched_zero = all(bool((g[:, ~named] == 0).all()) for g in got[1:])
    again = fa.flash_prefill_paged_backward(*res, **call)
    torch.cuda.synchronize()
    identical = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"[paged-grad] {c['shape']}: scaled |grad - plain| {errs}; "
          f"untouched pages zero {untouched_zero}; two calls bit-identical "
          f"{identical}", flush=True)
    for name, e in errs.items():
        check(e <= 2e-2, f"paged backward: {name} scaled error {e} > 2e-2")
    check(untouched_zero, "paged backward: an untouched page got a gradient")
    check(identical, "paged backward: two calls differ (not deterministic)")
    torch.cuda.set_sync_debug_mode("error")
    try:
        fa.flash_prefill_paged_backward(*res, **call)
    except RuntimeError as e:
        raise SmokeFailure(f"paged backward waits on the card: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("[paged-grad] the whole backward ran under "
          "set_sync_debug_mode('error')", flush=True)

    ops_ = fa.prepare_backward(q, k_pool, v_pool, o, c["do"], m, l, None,
                               c["layout"], q_offset=0, block_k=k_pool.shape[2],
                               page_list=page_list, **call)
    dq_ms = device_ms(torch, [lambda: fa.launch_dq_paged(ops_)])
    dkv_ms = device_ms(torch, [lambda: fa.launch_dkv_paged(ops_)])
    full_dev_ms, full_ms = timed(torch, [lambda: fa.flash_prefill_paged_backward(
        *res, **call)])

    # the fold alone: the kernel (with its order and zeroed pools) against
    # fold_packed_to_pool, bit for bit, on the dkv kernel's packed rows
    num_pages, dtype = k_pool.shape[1], k_pool.dtype
    packed = fa.launch_dkv_paged(ops_)
    fold = fa.launch_fold_paged(*packed, page_list, num_pages, dtype)
    torch.cuda.synchronize()
    fold_plain = [fa.fold_packed_to_pool(x, page_list, num_pages).to(dtype)
                  for x in packed]
    fold_err = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(fold, fold_plain))
    check(all(torch.equal(a, b) for a, b in zip(fold, fold_plain)),
          f"flash_bwd_fold_paged differs from fold_packed_to_pool "
          f"(max {fold_err})")
    fold_ms, fold_call_ms = timed(torch, [lambda: fa.launch_fold_paged(
        *packed, page_list, num_pages, dtype)])
    fold_plain_ms = device_ms(torch, [lambda: [
        fa.fold_packed_to_pool(x, page_list, num_pages).to(dtype)
        for x in packed]], warmup=1, iters=3)
    # library: index_add_ of the live slots' rows (selected beforehand) into
    # zeroed fp32 pools, dk and dv
    flat = page_list.reshape(-1).long()
    live_idx = (flat >= 0).nonzero().squeeze(1)
    hkv_, ps, T = k_pool.shape[0], k_pool.shape[2], page_list.shape[1]
    srcs = [x.reshape(q.shape[0], hkv_, T, ps, d).transpose(1, 2)
            .reshape(-1, hkv_, ps, d)[live_idx].transpose(0, 1).contiguous()
            for x in packed]
    fold_lib_ms = device_ms(torch, [lambda: [
        torch.zeros((hkv_, num_pages, ps, d), device=q.device).index_add_(
            1, flat[live_idx], src) for src in srcs]])
    live_slots = int(live_idx.numel())
    fold_bound = bound(2 * hkv_ * live_slots * ps * d * 4 + nbytes(page_list)
                       + nbytes(*fold), 2.0 * hkv_ * live_slots * ps * d,
                       FP32_FLOPS_PER_S)
    del packed, fold_plain, srcs
    plain_ms = device_ms(torch, [lambda: fa.flash_prefill_paged_backward_plain(
        *res, **call)], warmup=1, iters=3)
    # library: SDPA's backward alone on K/V gathered beforehand, same mask;
    # the padded q rows, which have no key, may see key 0 so SDPA's softmax
    # stays finite (only the time is used)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = c["mask"].clone()
    mask[..., 0] |= ~mask.any(dim=-1)
    leaves = [q.detach().requires_grad_(),
              gather_pages(k_pool, page_list).requires_grad_(),
              gather_pages(v_pool, page_list).requires_grad_()]
    out = sdpa(*leaves, attn_mask=mask, scale=call["scale"], enable_gqa=True)
    lib_ms = device_ms(torch, [lambda: torch.autograd.grad(
        out, leaves, c["do"], retain_graph=True)])
    del out, leaves
    pairs = int(c["mask"].sum()) * q.shape[1]
    live = int((page_list >= 0).sum())
    kv_bytes = 2 * live * k_pool.shape[0] * k_pool.shape[2] * d * 2
    ins = (nbytes(q, c["do"], m, l, c["layout"], page_list, *c["ids"].values())
           + m.numel() * 4 + kv_bytes)                       # + D
    dq_bound = bound(ins + nbytes(got[0]), 2.0 * d * pairs, BF16_FLOPS_PER_S)
    dkv_bound = bound(ins + nbytes(got[1], got[2]), 8.0 * d * pairs,
                      BF16_FLOPS_PER_S)
    lib = "SDPA backward (dq, dk, dv together) on pre-gathered K/V, bool mask"
    recs = []
    for name, ms, (b_ms, b_by), grads, line in (
            ("flash_bwd_dq_paged", dq_ms, dq_bound, ("dq",), 851),
            ("flash_bwd_dkv_paged", dkv_ms, dkv_bound, ("dk_pool", "dv_pool"),
             897)):
        rec = {"name": name, "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
               "replaces": f"src/repro/kernels/flash_attention.py:{line}",
               "launches": None,
               "max_abs_err": max(abs_errs[g] for g in grads),
               "scaled_err": max(errs[g] for g in grads), "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms, "library": lib, "shape": c["shape"],
               "backward_ms": full_dev_ms, "backward_call_ms": full_ms,
               "deterministic": identical, "no_host_sync": True,
               "plain_ms_is": "the plain paged backward (dq, dk, dv, fold)"}
        recs.append(rec)
        print(f"[kernel] {name}: {c['shape']}: scaled err "
              f"{rec['scaled_err']:.3g}; {ms:.4f} ms (whole backward with the "
              f"fold {full_dev_ms:.4f} ms on the card, {full_ms:.4f} ms a "
              f"call; plain backward {plain_ms:.3f} ms, bound {b_ms:.4f} ms by "
              f"{b_by}, {lib} {lib_ms:.4f} ms)", flush=True)
    fold_lib = "index_add_ of the live slots' rows into zeroed fp32 pools, dk and dv"
    rec = {"name": "flash_bwd_fold_paged", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
           "replaces": "src/repro/kernels/flash_attention.py:930",
           "launches": None, "max_abs_err": fold_err, "ms": fold_ms,
           "call_ms": fold_call_ms, "plain_ms": fold_plain_ms,
           "bound_ms": fold_bound[0], "bound_by": fold_bound[1],
           "library_ms": fold_lib_ms, "library": fold_lib,
           "shape": c["shape"],
           "ms_is": "launch_fold_paged: the order sort, the zeroed pools and "
                    "the fold kernel",
           "plain_ms_is": "fold_packed_to_pool of dk and dv, cast to bf16"}
    recs.append(rec)
    print(f"[kernel] flash_bwd_fold_paged: {c['shape']}: bit-equal to "
          f"fold_packed_to_pool; {fold_ms:.4f} ms on the card, "
          f"{fold_call_ms:.4f} ms a call (plain {fold_plain_ms:.3f} ms, bound "
          f"{fold_bound[0]:.4f} ms by {fold_bound[1]}, {fold_lib} "
          f"{fold_lib_ms:.4f} ms)", flush=True)
    return recs


def paged_grad_ab(torch, seed: int) -> dict:
    """For ``--ab``: device time of the paged dq and dkv kernels, and the
    whole paged backward's device and event time, at phase 2c's shape,
    through calls that both checkouts' packages have."""
    from repro_torch.kernels import flash_attention as fa

    c = paged_grad_case(torch, seed)
    q, k_pool, v_pool, page_list = c["q"], c["k_pool"], c["v_pool"], c["page_list"]
    call = c["call"]
    o, m, l = fa.flash_prefill_paged_forward(q, k_pool, v_pool, page_list,
                                             c["layout"], **call)
    res = (q, k_pool, v_pool, page_list, o, c["do"], m, l, c["layout"])
    ops_ = fa.prepare_backward(q, k_pool, v_pool, o, c["do"], m, l, None,
                               c["layout"], q_offset=0, block_k=k_pool.shape[2],
                               page_list=page_list, **call)
    dev, ev = timed(torch, [lambda: fa.flash_prefill_paged_backward(*res, **call)])
    return {"flash_bwd_dq_paged": device_ms(torch, [lambda: fa.launch_dq_paged(ops_)]),
            "flash_bwd_dkv_paged": device_ms(torch, [lambda: fa.launch_dkv_paged(ops_)]),
            "paged_backward_ms": dev, "paged_backward_call_ms": ev}


def paged_grad_phase(torch, seed: int) -> dict:
    """The trainable paged prefill's main path: one forward and backward
    through ``core.attention.paged_prefill_attention`` (impl "pallas") with
    q and both pools requiring grad. Launch counters are reset just before
    and the paged forward, dq, dkv and fold kernels must be > 0 just
    after."""
    from repro_torch.core.attention import AttentionSpec, paged_prefill_attention

    c = paged_grad_case(torch, seed + 1, requires_grad=True)
    torch.cuda.synchronize()
    reset_launches()
    o = paged_prefill_attention(c["q"], c["k_pool"], c["v_pool"],
                                c["page_list"], AttentionSpec(impl="pallas"),
                                **c["ids"])
    (o.float() * c["do"].float()).sum().backward()
    torch.cuda.synchronize()
    launches = read_launches()
    for name in PAGED_GRAD_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was never launched in the paged-grad path")
    for n in ("q", "k_pool", "v_pool"):
        check(bool(torch.isfinite(c[n].grad).all()),
              f"paged-grad path: the {n} gradient is not finite")
    print(f"[paged-grad] forward + backward through paged_prefill_attention: "
          f"launches {launches}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 3: float32 parity, cuda (kernels) vs cpu (plain versions)
# ---------------------------------------------------------------------------

def _serve(engine, prompts, n_new, prime: bool):
    if prime:
        engine.submit(prompts[0], max_new_tokens=n_new)
        engine.run()
        prompts = prompts[1:]
    for p in prompts:
        engine.submit(p, max_new_tokens=n_new)
    engine.run()
    return {r.rid: r.output for r in engine.finished}


def parity_phase(torch, seed: int, arch: str = "granite-3-2b",
                 n_new: int = 12, tag: str = "parity") -> dict:
    """``arch`` at full width, 2 layers, float32: the same
    weights (drawn on the card from ``seed``) served by the paged engine on
    ``cuda`` (kernels) and on ``cpu`` (plain versions); greedy tokens must
    be identical, a divergence allowed only at a near-tie."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, params_to
    from repro_torch.serve import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), num_layers=2,
                              dtype="float32", attn_impl="pallas",
                              use_decode_kernel=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed),
                        device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)

    def toks(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()

    shared = toks(32)
    prompts = [shared + toks(9), toks(150), shared + toks(20), shared + toks(3),
               toks(40)]
    kw = dict(num_slots=4, capacity=256, page_size=16, chunk_size=64)
    outs = {}
    engines = {}
    for device in ("cuda", "cpu"):
        p = params if device == "cpu" else params_to(params, device)
        engines[device] = ServingEngine(model, p, device=device, **kw)
        t0 = time.perf_counter()
        outs[device] = _serve(engines[device], prompts, n_new, prime=True)
        print(f"[{tag}] {cfg.name} 2 layers float32, {device}: "
              f"{sum(map(len, outs[device].values()))} tokens in "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
        del p
    check(engines["cuda"].prefix_hits >= 1, f"{tag} run had no prefix hit")
    diverged = []
    for rid, ref in outs["cpu"].items():
        got = outs["cuda"][rid]
        if got == ref:
            continue
        i = next(j for j, (a, c) in enumerate(zip(got, ref)) if a != c)
        ctx = prompts[rid] + ref[:i]
        with torch.inference_mode():
            _, logits = model.prefill_packed(params, {
                "tokens": torch.tensor([ctx]),
                "segment_ids": torch.zeros((1, len(ctx)), dtype=torch.int32)})
        top2 = torch.topk(logits[0, -1].float(), 2).values
        margin = float(top2[0] - top2[1])
        print(f"[{tag}] request {rid} diverges at generated step {i}: "
              f"cuda {got[i]} cpu {ref[i]}, top-2 logit margin {margin:.3g}",
              flush=True)
        diverged.append({"rid": rid, "step": i, "margin": margin})
        check(margin < 1e-3, f"request {rid} diverged at step {i} with a "
                             f"top-2 margin {margin:.3g} (not a near-tie)")
    print(f"[{tag}] greedy tokens identical: {not diverged} "
          f"({len(outs['cpu'])} requests, near-tie divergences: "
          f"{len(diverged)})", flush=True)
    return {"model": cfg.name, "layers": cfg.num_layers,
            "identical": not diverged, "near_tie_divergences": diverged,
            "requests": len(outs["cpu"]),
            "prefix_hits": engines["cuda"].prefix_hits}


# ---------------------------------------------------------------------------
# phase 4: the published model, served through the kernels
# ---------------------------------------------------------------------------

def reset_launches():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    for table in (fa.LAUNCHES, fd.LAUNCHES):
        for k in table:
            table[k] = 0


def read_launches() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    return {**fa.LAUNCHES, **fd.LAUNCHES}


SERVE_KERNELS = ("flash_fwd", "flash_fwd_paged", "flash_decode_paged")
DENSE_SERVE_KERNELS = ("flash_fwd", "flash_decode")
PAGED_GRAD_KERNELS = ("flash_fwd_paged", "flash_bwd_dq_paged",
                      "flash_bwd_dkv_paged", "flash_bwd_fold_paged")
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# the later paths: (arch, seq, batch) of the two trained at full depth, and
# the depth serve-qwen3 cuts qwen3-32b to (its 64 layers hold ~65.5 GB of
# bf16 weights; 8 keep the published width at ~10.9 GB)
NEW_TRAIN_PATHS = {"train_bert": ("bert-large", 512, 56),
                   "train_olmo": ("olmo-1b", 2048, 4)}
SERVE_QWEN3_LAYERS = 8


def serve_phase(torch, seed: int, card: str, arch: str = "granite-3-2b",
                num_layers: int | None = None, tag: str = "serve",
                hold_shapes: bool = False) -> tuple[dict, dict]:
    """``arch`` at its published width (and depth, unless ``num_layers``),
    bf16, random weights drawn on the card from ``seed``, served by the
    paged engine through the kernels; then profiled (``profile_serve``).
    With ``hold_shapes`` the same requests are served once more with the
    serving kernels' wrappers watched (``capture_calls``), and each kernel
    is held at the shape of its call that did the most work
    (``serve_shape_records``, under ``rec["at_shapes"]``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServingEngine

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(arch), attn_impl="pallas",
                              use_decode_kernel=True)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    torch.cuda.synchronize()
    print(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.head_dim}, {cfg.dtype}, weights in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    gen = torch.Generator().manual_seed(seed + 2)

    def toks(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()

    kw = dict(num_slots=4, capacity=1056, page_size=16, chunk_size=256,
              device=dev)
    warm = ServingEngine(model, params, **kw)       # cuBLAS / allocator warm-up
    warm.submit(toks(300), max_new_tokens=4)
    warm.run()
    del warm

    shared = toks(64)
    prompts = [shared + toks(1024 - 64)] + [shared + toks(n) for n in
                                            (17, 120, 45, 200, 9, 77, 150)]
    eng = ServingEngine(model, params, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    n_tok = sum(len(r.output) for r in done)
    lat = eng.latency_stats()
    check(len(done) == len(prompts) and all(len(r.output) == 32 for r in done),
          f"{tag} phase did not finish every request")
    check(eng.prefix_hits >= 1, f"{tag} phase had no prefix-cache hit")
    for name in SERVE_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was never launched in the {tag} phase")
    profile = profile_serve(torch, model, params, prompts, kw)
    rec = {"model": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "requests": len(done), "lanes": 4, "new_tokens": n_tok,
           "wall_s": wall, "tokens_per_s": n_tok / wall,
           "ttft_p50_s": lat["ttft_p50"], "ttft_p95_s": lat["ttft_p95"],
           "tok_latency_p50_s": lat["tok_latency_p50"],
           "peak_memory_bytes": peak, "prefix_hits": eng.prefix_hits,
           "prefill_calls": eng.prefill_calls,
           "decode_calls": eng.decode_calls, "profile": profile,
           "card": card}
    print(f"[{tag}] {n_tok} tokens in {wall:.2f}s: {n_tok / wall:.1f} tok/s, "
          f"TTFT p50 {lat['ttft_p50'] * 1e3:.1f} ms, peak memory "
          f"{peak / 2**30:.2f} GiB, prefix hits {eng.prefix_hits}, "
          f"launches {launches} [{card}]", flush=True)
    if hold_shapes:
        calls = capture_calls(torch, lambda: _serve(
            ServingEngine(model, params, **kw), prompts, 32, prime=False))
        rec["at_shapes"] = serve_shape_records_apart(torch, seed, calls, tag)
    return rec, launches


# the serving kernels' wrappers as the engine calls them, each with the
# work of one call (q rows times the key rows it may read)
SERVE_WRAPPERS = {
    "flash_fwd": ("flash_attention", "flash_attention_forward",
                  lambda a: a[0].shape[0] * a[0].shape[2] * a[1].shape[2]),
    "flash_fwd_paged": ("flash_attention", "flash_prefill_paged_forward",
                        lambda a: a[0].shape[2] * int((a[3] >= 0).sum())),
    "flash_decode_paged": ("flash_decode", "flash_decode_paged_from_layout",
                           lambda a: int(a[4].sum()))}


def capture_calls(torch, run) -> dict:
    """Runs ``run()`` with each wrapper of ``SERVE_WRAPPERS`` replaced by
    one that calls it and keeps the arguments of its call with the most
    work (the first of equals): q, K and V as meta tensors of their shape
    and dtype, every other tensor cloned. Returns {kernel: (args, kw)};
    the wrappers are put back however ``run`` ends. The extra host work
    (and a sync a call for the work of the paged calls) is why this runs
    beside the timed serve, not in it."""
    import importlib

    def keep(i, x):
        if not isinstance(x, torch.Tensor):
            return x
        if i < 3:
            return torch.empty(x.shape, dtype=x.dtype, device="meta")
        return x.clone()

    best, saved = {}, {}

    def watch(name, fn, work):
        def call(*a, **kw):
            w = work(a)
            if name not in best or w > best[name][0]:
                best[name] = (w, tuple(keep(i, x) for i, x in enumerate(a)),
                              {n: keep(3, x) for n, x in kw.items()})
            return fn(*a, **kw)
        return call

    for name, (mod, attr, work) in SERVE_WRAPPERS.items():
        mod = importlib.import_module(f"repro_torch.kernels.{mod}")
        saved[name] = (mod, attr, getattr(mod, attr))
        setattr(mod, attr, watch(name, saved[name][2], work))
    try:
        run()
    finally:
        for mod, attr, fn in saved.values():
            setattr(mod, attr, fn)
    check(set(best) == set(SERVE_WRAPPERS),
          f"the serve called only {sorted(best)} of {sorted(SERVE_WRAPPERS)}")
    return {name: (a, kw) for name, (_, a, kw) in best.items()}


def serve_shape_records(torch, seed: int, calls: dict, tag: str) -> dict:
    """#1, #4 and #8 each held against its plain version at the call the
    serve gave it (``capture_calls``), with random q, K and V of those
    shapes, timed beside its bound and SDPA's time. Returns {kernel:
    entry}, entries without ``launches`` (``main`` adds the path's)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 30)

    def inputs(name):
        args, kw = calls[name]
        return tuple(fresh(torch, gen, t) for t in args[:3]) + args[3:], kw

    def segments(ids) -> list[int]:
        return ids[0].unique_consecutive(return_counts=True)[1].tolist()

    out = {}
    with torch.inference_mode():        # the engine's tensors were made so
        args, kw = inputs("flash_fwd")
        b, hq, sq, d = args[0].shape
        out["flash_fwd"] = packed_prefill_record(
            torch, gen, args, kw,
            f"{tag} packed prefill b={b} hq={hq} hkv={args[1].shape[1]} "
            f"S={sq} d={d}, {'causal' if kw['causal'] else 'non-causal'}, "
            f"rows by segment {segments(kw['q_segment_ids'])}")
        args, kw = inputs("flash_fwd_paged")
        b, hq, sq, d = args[0].shape
        hkv, _, ps, _ = args[1].shape
        out["flash_fwd_paged"] = paged_prefill_record(
            torch, gen, args, kw,
            f"{tag} chunked prefill hq={hq} hkv={hkv} d={d}: {sq} q rows "
            f"(by segment {segments(kw['q_segment_ids'])}, first position "
            f"{int(kw['q_positions'][0, 0])}) against "
            f"{int((args[3] >= 0).sum())} live of {args[3].shape[1]} pages "
            f"of {ps}")
        args, kw = inputs("flash_decode_paged")
        dec = paged_decode_record(torch, gen, args, kw)
        dec["shape"] = f"{tag} {dec['shape']}"
        out["flash_decode_paged"] = dec
    for entry in out.values():
        entry.pop("launches")
    return out


_SHAPES_RUN = """
import json, sys
sys.path[:0] = [{src!r}, {here!r}]
import torch
import chip_smoke as cs
saved = torch.load({path!r}, map_location="cuda", weights_only=False)


def back(x):
    if isinstance(x, tuple) and x[:1] == ("meta",):
        return torch.empty(x[1], dtype=getattr(torch, x[2]), device="meta")
    return x


calls = {{n: (tuple(map(back, a)), kw) for n, (a, kw) in saved["calls"].items()}}
out = cs.serve_shape_records(torch, saved["seed"], calls, saved["tag"])
print("SHAPES " + json.dumps(out))
"""


def serve_shape_records_apart(torch, seed: int, calls: dict, tag: str) -> dict:
    """``serve_shape_records`` in a fresh Python process on the same card.
    Late in this script's long process ``torch.profiler`` stops recording
    whole windows (after serve-qwen3's serve it recorded none of these
    kernels' windows whole in ten tries), where a fresh process records
    them at once. The captured calls go through a file under ``build/``,
    q, K and V as ("meta", shape, dtype)."""
    def put(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.device.type == "meta":
            return ("meta", tuple(x.shape), str(x.dtype).removeprefix("torch."))
        return x.cpu()

    path = ROOT / "build" / "serve_shape_calls.pt"
    torch.save({"seed": seed, "tag": tag, "calls": {
        n: (tuple(map(put, a)), {k: put(v) for k, v in kw.items()})
        for n, (a, kw) in calls.items()}}, path)
    code = _SHAPES_RUN.format(src=str(ROOT / "src"), here=str(ROOT),
                              path=str(path))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    lines = out.stdout.splitlines()
    for x in lines:
        if not x.startswith("SHAPES "):
            print(x, flush=True)
    line = [x for x in lines if x.startswith("SHAPES ")]
    check(out.returncode == 0 and len(line) == 1,
          f"the {tag} shape records failed: {out.stderr[-3000:]}")
    return json.loads(line[0][len("SHAPES "):])


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or \
        getattr(e, "self_cuda_time_total", 0.0)


PROFILED_NEW_TOKENS = 8


def profile_serve(torch, model, params, prompts, kw) -> dict:
    """The same requests once more under ``torch.profiler`` with
    ``PROFILED_NEW_TOKENS`` new tokens each instead of 32 (tracing multiplies
    the host cost of every decode step; the prefill work is the same): device
    busy share of the wall time, device time per launch of each ported
    kernel, and the kernels that take the most device time. Launch counters
    are not read here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ServingEngine

    eng = ServingEngine(model, params, **kw)
    for p in prompts:
        eng.submit(p, max_new_tokens=PROFILED_NEW_TOKENS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in kernels)
    if busy_us <= 0:
        print("[profile] the profiler recorded no device time: not measured",
              flush=True)
        return {"busy_share": None}
    # flash_fwd_kernel<T, D, Paged, Dropout, Paper> and
    # flash_decode_kernel<T, D, Paged>: Paged tells them apart
    ported = {"flash_fwd": r"flash_fwd_kernel<[^,>]+, \d+, false",
              "flash_fwd_paged": r"flash_fwd_kernel<[^,>]+, \d+, true",
              "flash_decode_paged": r"flash_decode_kernel<[^,>]+, \d+, true>"}
    per_kernel = {}
    for name, pattern in ported.items():
        hits = [e for e in kernels if re.search(pattern, e.key)]
        n = sum(e.count for e in hits)
        per_kernel[name] = {
            "launches": n, "device_ms_total": sum(_device_us(e) for e in hits) / 1e3,
            "device_ms_per_launch": (sum(_device_us(e) for e in hits) / 1e3 / n
                                     if n else None)}
    top = sorted(kernels, key=_device_us, reverse=True)[:8]
    out = {"wall_s": wall_us / 1e6, "device_busy_s": busy_us / 1e6,
           "busy_share": busy_us / wall_us, "ported": per_kernel,
           "new_tokens_per_request": PROFILED_NEW_TOKENS,
           "top": [{"kernel": e.key[:90], "count": e.count,
                    "device_ms": _device_us(e) / 1e3} for e in top]}
    print(f"[profile] serve under torch.profiler: wall {wall_us / 1e6:.2f}s, "
          f"device busy {busy_us / 1e6:.3f}s ({busy_us / wall_us:.1%}); "
          f"ported kernels {json.dumps(per_kernel)}", flush=True)
    for t in out["top"]:
        print(f"[profile]   {t['device_ms']:9.2f} ms  x{t['count']:<6} "
              f"{t['kernel']}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phases 4b-4c: dense slot serving
# ---------------------------------------------------------------------------

def dense_parity_phase(torch, seed: int) -> dict:
    """granite-3-2b at full width, 2 layers, float32, dense slot mode: the
    engine on ``cuda`` (packed prefill + the contiguous decode kernel)
    against the same engine on ``cpu`` (plain versions), and against the
    paged engine on ``cuda``; greedy tokens must be identical."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, params_to
    from repro_torch.serve import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("granite-3-2b"), num_layers=2,
                              dtype="float32", attn_impl="pallas",
                              use_decode_kernel=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed + 4), device="cpu")
    gen = torch.Generator().manual_seed(seed + 5)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (41, 150, 7, 96, 23)]
    outs, launches = {}, {}
    for device, paged in (("cuda", False), ("cpu", False), ("cuda", True)):
        eng = ServingEngine(model, params_to(params, device), device=device,
                            num_slots=4, capacity=256, paged=paged)
        reset_launches()
        t0 = time.perf_counter()
        outs[(device, paged)] = _serve(eng, prompts, 12, prime=False)
        launches[(device, paged)] = read_launches()
        print(f"[dense-parity] {device} {'paged' if paged else 'dense'}: "
              f"{sum(map(len, outs[(device, paged)].values()))} tokens in "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
    check(launches[("cuda", False)]["flash_decode"] > 0
          and launches[("cuda", False)]["flash_decode_paged"] == 0,
          "dense parity: the dense engine did not decode through flash_decode")
    vs_cpu = outs[("cuda", False)] == outs[("cpu", False)]
    vs_paged = outs[("cuda", False)] == outs[("cuda", True)]
    print(f"[dense-parity] greedy tokens identical: cuda dense vs cpu dense "
          f"{vs_cpu}, cuda dense vs cuda paged {vs_paged}", flush=True)
    check(vs_cpu, "dense parity: cuda and cpu tokens differ")
    check(vs_paged, "dense parity: dense and paged tokens differ on the card")
    return {"identical_vs_cpu": vs_cpu, "identical_vs_paged": vs_paged,
            "requests": len(prompts)}


def dense_serve_phase(torch, seed: int, card: str) -> tuple[dict, dict]:
    """The published granite-3-2b (40 layers, bf16) in dense slot mode with
    the decode kernel: 4 slots of 2048, 8 requests with prompts of 64-1024
    tokens, 32 new tokens each, drained requests prefilled packed. Launch
    counters reset just before; flash_fwd and flash_decode must be > 0 and
    flash_decode_paged 0 just after. Not profiled."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServingEngine

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("granite-3-2b"), attn_impl="pallas",
                              use_decode_kernel=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    gen = torch.Generator().manual_seed(seed + 6)

    def toks(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()

    kw = dict(num_slots=4, capacity=2048, paged=False, device=dev)
    warm = ServingEngine(model, params, **kw)       # cuBLAS / allocator warm-up
    warm.submit(toks(300), max_new_tokens=4)
    warm.run()
    del warm
    prompts = [toks(n) for n in (64, 1024, 300, 512, 128, 900, 700, 200)]
    eng = ServingEngine(model, params, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    n_tok = sum(len(r.output) for r in done)
    lat = eng.latency_stats()
    check(len(done) == len(prompts) and all(len(r.output) == 32 for r in done),
          "dense serve phase did not finish every request")
    for name in DENSE_SERVE_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was never launched in the dense serve phase")
    check(launches["flash_decode_paged"] == 0,
          "the dense serve launched the paged decode kernel")
    rec = {"model": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "mode": "dense slots", "requests": len(done), "lanes": 4,
           "capacity": 2048, "new_tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall, "ttft_p50_s": lat["ttft_p50"],
           "ttft_p95_s": lat["ttft_p95"],
           "tok_latency_p50_s": lat["tok_latency_p50"],
           "peak_memory_bytes": peak, "prefill_calls": eng.prefill_calls,
           "decode_calls": eng.decode_calls,
           "decode_geometry": [eng.decode_block_k, eng.num_decode_splits],
           "blocks_skipped": eng.blocks_skipped,
           "blocks_total": eng.blocks_total, "card": card}
    print(f"[dense-serve] {n_tok} tokens in {wall:.2f}s: {n_tok / wall:.1f} "
          f"tok/s, TTFT p50 {lat['ttft_p50'] * 1e3:.1f} ms, decode step p50 "
          f"{lat['tok_latency_p50'] * 1e3:.1f} ms, peak memory "
          f"{peak / 2**30:.2f} GiB, prefill calls {eng.prefill_calls}, "
          f"launches {launches} [{card}]", flush=True)
    return rec, launches


# ---------------------------------------------------------------------------
# phase 5: float32 train parity, cuda (kernels) vs cpu (plain versions)
# ---------------------------------------------------------------------------

def _grads(torch, model, params, batch):
    """(loss, grads) of one batch, grads in the params' tree layout."""
    from repro_torch.core.tree import tree_leaves, with_leaves
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, _ = model.loss(with_leaves(params, leaves), batch,
                         deterministic=True)
    return float(loss.detach()), with_leaves(
        params, torch.autograd.grad(loss, leaves))


def adamw_recipe():
    """The training launcher's recipe at two steps."""
    from repro_torch.optim import adamw, warmup_cosine
    return adamw(warmup_cosine(3e-4, 20, 2))


def lamb_recipe():
    """The MLPerf-BERT recipe (``benchmarks/bench_table1_bert.py``)."""
    from repro_torch.optim import lamb, warmup_poly
    return lamb(warmup_poly(3.75e-3, 10, 7100))


def train_parity_phase(torch, seed: int, arch: str = "granite-3-2b",
                       recipe=adamw_recipe, tag: str = "train-parity") -> dict:
    """``arch`` at full width, 2 layers, float32, seq 512, batch 2: the same
    weights (drawn on the card from ``seed``) and ``SyntheticLM`` batches
    through two train steps of ``recipe()`` on ``cuda`` (kernels) and on
    ``cpu`` (plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model, params_to
    from repro_torch.train import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), num_layers=2,
                              dtype="float32", attn_impl="pallas")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed),
                        device="cpu")
    data = SyntheticLM(cfg.vocab_size, 512, 2, seed=seed + 3)
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        p = params_to(params, device)
        _, g = _grads(torch, model, p, data.batch_at(0))
        g0 = {n: g["blocks"][0]["attn"][n].cpu() for n in ("wq", "wk", "wv")}
        del g
        opt = recipe()
        state = opt.init(p)
        step = make_train_step(model, opt, clip_norm=1.0, deterministic=True)
        losses = []
        for s in range(2):
            p, state, metrics = step(p, state, data.batch_at(s))
            losses.append(float(metrics["loss"]))
        out[device] = {"losses": losses, "grads": g0}
        del p, state
        print(f"[{tag}] {cfg.name} 2 layers float32, {device}: losses "
              f"{losses} in {time.perf_counter() - t0:.1f}s", flush=True)
    rel = [abs(a - b) / abs(b) for a, b in zip(out["cuda"]["losses"],
                                               out["cpu"]["losses"])]
    gerr = {n: scaled_err(out["cuda"]["grads"][n], out["cpu"]["grads"][n])
            for n in ("wq", "wk", "wv")}
    print(f"[{tag}] loss relative differences {rel}; layer-0 "
          f"scaled grad differences {gerr}", flush=True)
    check(max(rel) <= 1e-4, f"{tag}: losses differ by {rel} > 1e-4")
    check(max(gerr.values()) <= 1e-3,
          f"{tag}: layer-0 grads differ by {gerr} > 1e-3")
    return {"model": cfg.name, "losses_cuda": out["cuda"]["losses"],
            "losses_cpu": out["cpu"]["losses"], "loss_rel_diff": rel,
            "grad_scaled_diff": gerr}


# ---------------------------------------------------------------------------
# phase 6: the published model, trained through the kernels
# ---------------------------------------------------------------------------

def train_phase(torch, seed: int, card: str, arch: str = "granite-3-2b",
                tag: str = "train") -> tuple[dict, dict]:
    """The published ``arch`` through the training launcher (AdamW,
    warmup_cosine(3e-4, 20, steps), clip 1.0, deterministic, bf16, remat),
    seq 2048, batch 4, 6 steps (``train_path``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train

    steps, seq, batch = 6, 2048, 4

    def run():
        return launch_train.main([
            "--arch", arch, "--device", "cuda", "--seed", str(seed),
            "--steps", str(steps), "--seq", str(seq), "--batch", str(batch),
            "--ckpt-every", "1000000",
            "--ckpt-dir", str(ROOT / "build" / "chip_smoke_train_ckpt")])

    return train_path(torch, tag, get_config(arch), run, seq, batch, steps,
                      "AdamW, warmup_cosine(3e-4, 20, 6), clip 1.0", card)


def bert_train_phase(torch, seed: int, card: str) -> tuple[dict, dict]:
    """The published bert-large (24 layers, bf16, remat, non-causal over
    ``SyntheticLM``'s packed documents) with the MLPerf-BERT recipe
    (``lamb_recipe``, clip 1.0, deterministic) at seq 512 and batch 56 (the
    MLPerf step batch of 448 over the paper's 8 cards), 6 steps, through
    ``make_train_step`` and the ``Trainer`` (``train_path``)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train import Trainer, TrainerConfig, make_train_step

    arch, seq, batch = NEW_TRAIN_PATHS["train_bert"]
    steps = 6
    cfg = dataclasses.replace(get_config(arch), attn_impl="pallas")

    def run():
        model = build_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(seed),
                            device="cuda")
        opt = lamb_recipe()
        step = make_train_step(model, opt, clip_norm=1.0, deterministic=True)
        data = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed)
        trainer = Trainer(
            TrainerConfig(total_steps=steps, ckpt_every=1000000,
                          ckpt_dir=str(ROOT / "build" / "chip_smoke_bert_ckpt")),
            step, params, opt.init(params), data.batch_at)
        trainer.run()
        return trainer

    return train_path(torch, "train-bert", cfg, run, seq, batch, steps,
                      "LAMB, warmup_poly(3.75e-3, 10, 7100), clip 1.0", card)


def train_path(torch, tag, cfg, run, seq, batch, steps, recipe,
               card) -> tuple[dict, dict]:
    """One training main path: launch counters reset just before ``run()``
    (which builds the model and trains ``steps`` steps, returning the
    ``Trainer``) and flash_fwd, flash_bwd_dq and flash_bwd_dkv > 0 just
    after; every loss and grad norm finite; prints the first loss, tokens/s
    and ms/step over steps 2-``steps`` and peak memory, then profiles one
    more step (``profile_train``)."""
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    trainer = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    hist = trainer.history
    for name in TRAIN_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was never launched in the {tag} phase")
    check(len(hist) == steps, f"{tag} phase ran {len(hist)} of {steps} steps")
    for rec in hist:
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"]),
              f"{tag} step {rec['step']}: loss {rec['loss']} grad norm "
              f"{rec['grad_norm']}")
    timed = [r["step_time_s"] for r in hist[1:]]    # step 1 compiles, warms up
    ms_step = sum(timed) / len(timed) * 1e3
    tok_s = seq * batch / (ms_step / 1e3)
    per_step = {n: launches[n] / steps for n in TRAIN_KERNELS}
    print(f"[{tag}] {cfg.name} {cfg.num_layers} layers {cfg.dtype} remat, "
          f"{'causal' if cfg.causal else 'non-causal'}, {recipe}, seq {seq} "
          f"batch {batch}: first loss {hist[0]['loss']:.4f} (ln "
          f"{cfg.vocab_size} = {math.log(cfg.vocab_size):.4f}), last "
          f"{hist[-1]['loss']:.4f}; {ms_step:.1f} ms/step, {tok_s:.0f} "
          f"tokens/s over steps 2-{steps}; peak memory {peak / 2**30:.2f} GiB; "
          f"launches {launches} ({per_step} a step) [{card}]", flush=True)
    profile = profile_train(torch, trainer)
    rec = {"model": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "remat": cfg.remat, "causal": cfg.causal, "recipe": recipe,
           "seq": seq, "batch": batch, "steps": steps,
           "losses": [r["loss"] for r in hist],
           "grad_norms": [r["grad_norm"] for r in hist],
           "step_ms": [r["step_time_s"] * 1e3 for r in hist],
           "ms_per_step": ms_step, "tokens_per_s": tok_s, "wall_s": wall,
           "peak_memory_bytes": peak, "launches_per_step": per_step,
           "profile": profile, "card": card}
    return rec, launches


def profile_train(torch, trainer) -> dict:
    """One more train step under ``torch.profiler`` (not counted in the
    numbers above): device busy share of its wall time and the kernels
    that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b = trainer.batch_fn(trainer.step)              # the next batch of the run
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.params, trainer.opt_state, metrics = trainer.step_fn(
            trainer.params, trainer.opt_state, b)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in kernels)
    if busy_us <= 0:
        print("[profile] the profiler recorded no device time: not measured",
              flush=True)
        return {"busy_share": None}
    top = sorted(kernels, key=_device_us, reverse=True)[:10]
    out = {"wall_s": wall_us / 1e6, "device_busy_s": busy_us / 1e6,
           "busy_share": busy_us / wall_us,
           "top": [{"kernel": e.key[:90], "count": e.count,
                    "device_ms": _device_us(e) / 1e3} for e in top]}
    print(f"[profile] one train step under torch.profiler: wall "
          f"{wall_us / 1e6:.3f}s, device busy {busy_us / 1e6:.3f}s "
          f"({busy_us / wall_us:.1%})", flush=True)
    for t in out["top"]:
        print(f"[profile]   {t['device_ms']:9.2f} ms  x{t['count']:<6} "
              f"{t['kernel']}", flush=True)
    return out


# ---------------------------------------------------------------------------
# --ab: parent against change on the serving and training kernels, one call
# ---------------------------------------------------------------------------

_AB_RUN = """
import json, sys
sys.path[:0] = [{src!r}, {here!r}]
import torch
import chip_smoke as cs
from repro_torch.kernels import build
build.build_all()
bwd, fwd = cs.train_kernel_phase(torch, {seed})
kernels = cs.kernel_phase(torch, {seed})
paged_grad = cs.paged_grad_ab(torch, {seed})
cs.profile_serve = lambda *a, **k: {{}}
cs.profile_train = lambda *a, **k: {{}}
serve, _ = cs.serve_phase(torch, {seed}, cs.card_line())
torch.cuda.empty_cache()
dense, _ = cs.dense_serve_phase(torch, {seed}, cs.card_line())
torch.cuda.empty_cache()
train, _ = cs.train_phase(torch, {seed}, cs.card_line())
print("AB " + json.dumps({{
    "kernels": {{r["name"]: r["ms"] for r in kernels + bwd}},
    "bound_ms": {{r["name"]: r["bound_ms"] for r in kernels + bwd}},
    "bwd_dropout_ms": {{r["name"]: r["dropout_ms"] for r in bwd}},
    "bwd_pair_device_ms": fwd["bwd_pair_device_ms"],
    "bwd_ms": fwd["bwd_ms"],
    "call_ms": {{r["name"]: r["call_ms"] for r in kernels}},
    "flash_fwd_train_shape_ms": fwd["ms"],
    "flash_fwd_train_shape_call_ms": fwd["call_ms"],
    "paged_grad": paged_grad,
    "serve": {{n: serve[n] for n in ("tokens_per_s", "ttft_p50_s",
                                     "tok_latency_p50_s", "wall_s")}},
    "dense_serve": {{n: dense[n] for n in ("tokens_per_s", "ttft_p50_s",
                                           "tok_latency_p50_s")}},
    "train": {{n: train[n] for n in ("ms_per_step", "tokens_per_s",
                                     "losses")}}}}))
"""

_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")


def _cubin(root: pathlib.Path, name: str, out: pathlib.Path):
    """nvcc of one kernel source to a cubin with ``-Xptxas -v`` (the build's
    own flags, without the shared-library ones); returns the process."""
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
    src = root / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu"
    nvcc = pathlib.Path("/usr/local/cuda/bin/nvcc")
    cmd = [str(nvcc) if nvcc.exists() else "nvcc", *flags, "-cubin",
           "-Xptxas", "-v", "-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _demangle(names: list[str]) -> dict[str, str]:
    tool = pathlib.Path("/usr/local/cuda/bin/cu++filt")
    out = subprocess.run([str(tool) if tool.exists() else "c++filt"],
                         input="\n".join(names), capture_output=True,
                         text=True, timeout=60)
    return dict(zip(names, out.stdout.splitlines()))


def _sass(binary: pathlib.Path) -> dict[str, list[str]]:
    """The SASS instruction text of every kernel (mangled name) in a cubin
    or a built library, from ``cuobjdump -sass`` (addresses and encodings
    dropped)."""
    tool = pathlib.Path("/usr/local/cuda/bin/cuobjdump")
    out = subprocess.run([str(tool) if tool.exists() else "cuobjdump",
                          "-sass", str(binary)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0,
          f"cuobjdump -sass {binary.name} failed: {out.stderr[-1000:]}")
    body, cur = {}, None
    for line in out.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            body[cur] = []
        elif cur and "/*" in line:
            text = re.sub(r"/\*[^*]*\*/", "", line).strip().rstrip(";").strip()
            if text:
                body[cur].append(text)
    return body


_FWD_BF16 = re.compile(r"flash_fwd_kernel<__nv_bfloat16, \(int\)(\d+), "
                       r"\(bool\)(\d), \(bool\)(\d), \(bool\)(\d)>")


def hmma_counts(lib: pathlib.Path) -> dict[str, list[int]]:
    """[HMMA, all] SASS instructions of each bf16 ``flash_fwd_kernel``
    instantiation of the built forward library, keyed by head dim and
    variant; every one must have tensor-core (``HMMA``) instructions, the
    paged and the contiguous alike (no bf16 forward runs the scalar
    body)."""
    body = _sass(lib)
    names = _demangle(sorted(body))
    counts = {}
    for mangled, instrs in body.items():
        m = _FWD_BF16.search(names.get(mangled, mangled))
        if m:
            d, paged, drop, paper = m.groups()
            key = (f"d{d} {'paged' if paged == '1' else 'contiguous'}"
                   f"{' dropout' if drop == '1' else ''}"
                   f"{' paper' if paper == '1' else ''}")
            counts[key] = [sum(bool(re.match(r"(@!?U?P\w+ )?HMMA\.", i))
                               for i in instrs), len(instrs)]
    print(f"[build] [HMMA, all] SASS instructions per bf16 flash_fwd_kernel: "
          f"{json.dumps(counts)}", flush=True)
    check(any(k.split()[1] == "paged" for k in counts)
          and any(k.split()[1] == "contiguous" for k in counts),
          f"the built forward lacks a paged or a contiguous bf16 kernel: "
          f"{sorted(counts)}")
    check(all(n > 0 for n, _ in counts.values()),
          f"a bf16 flash_fwd_kernel has no HMMA (scalar body): {counts}")
    return counts


_BWD_BF16 = re.compile(r"flash_bwd_(dq|dkv)_kernel<__nv_bfloat16, "
                       r"\(int\)(\d+), \(bool\)(\d), \(bool\)(\d)>")


def bwd_build_counts(proc, cubin: pathlib.Path) -> dict[str, dict]:
    """Registers, spills and [HMMA, all] SASS instructions of every bf16
    ``flash_bwd_dq_kernel`` / ``flash_bwd_dkv_kernel`` instantiation (paged;
    contiguous, with and without dropout), from a ``-Xptxas -v`` compile
    of ``flash_bwd.cu`` to a cubin (started beside the build by
    ``_cubin``): each must have tensor-core (``HMMA``) instructions (no
    bf16 backward runs the scalar body) and none may spill."""
    log, _ = proc.communicate()
    check(proc.returncode == 0, f"nvcc -Xptxas -v flash_bwd.cu failed:\n"
                                f"{log[-3000:]}")
    counts = {}
    for kern, info in _kernel_info(log, cubin).items():
        m = _BWD_BF16.search(kern)
        if m:
            kind, d, paged, drop = m.groups()
            key = (f"{kind} d{d} {'paged' if paged == '1' else 'contiguous'}"
                   f"{' dropout' if drop == '1' else ''}")
            counts[key] = {
                "hmma": sum(bool(re.match(r"(@!?U?P\w+ )?HMMA\.", i))
                            for i in info["sass"]),
                "instructions": len(info["sass"]),
                "registers": info.get("registers"), "spill": info.get("spill")}
    print(f"[build] bf16 flash_bwd kernels (HMMA, SASS instructions, "
          f"registers, spill bytes): {json.dumps(counts)}", flush=True)
    # 2 kernels x 4 head dims x (paged, contiguous, contiguous dropout)
    check(len(counts) == 24, f"the built backward lacks a bf16 kernel: "
                             f"{sorted(counts)}")
    check(all(c["hmma"] > 0 for c in counts.values()),
          f"a bf16 flash_bwd kernel has no HMMA (scalar body): {counts}")
    check(all(c["spill"] == 0 for c in counts.values()),
          f"a bf16 flash_bwd kernel spills: {counts}")
    return counts


_DECODE = re.compile(r"flash_decode_kernel<(float|__nv_bfloat16), \(int\)(\d+), "
                     r"\(bool\)(\d)>")


def decode_build_counts(torch, proc, cubin: pathlib.Path) -> dict[str, dict]:
    """Registers, static shared memory, spills and HMMA instructions of
    every ``flash_decode_kernel`` instantiation (fp32 and bf16, paged and
    contiguous, head dims 16-128) from a ``-Xptxas -v`` compile of
    ``flash_decode.cu`` to a cubin (started beside the build by
    ``_cubin``), with the dynamic shared memory and ring stages its
    launcher gives each (``flash_decode.smem_bytes``); none may spill,
    and every bf16 one must have HMMA (its tensor-core body)."""
    from repro_torch.kernels import flash_decode as fd
    log, _ = proc.communicate()
    check(proc.returncode == 0, f"nvcc -Xptxas -v flash_decode.cu failed:\n"
                                f"{log[-3000:]}")
    counts = {}
    for kern, info in _kernel_info(log, cubin).items():
        m = _DECODE.search(kern)
        if m:
            t, d, paged = m.groups()
            bf16 = t == "__nv_bfloat16"
            dyn, stages = fd.smem_bytes(torch.bfloat16 if bf16 else torch.float32,
                                        int(d))
            key = (f"{'bf16' if bf16 else 'fp32'} d{d} "
                   f"{'paged' if paged == '1' else 'contiguous'}")
            counts[key] = {"registers": info.get("registers"),
                           "spill": info.get("spill"),
                           "static_smem": info.get("smem"),
                           "dynamic_smem": dyn, "stages": stages,
                           "hmma": sum(bool(re.match(r"(@!?U?P\w+ )?HMMA\.", i))
                                       for i in info["sass"])}
    print(f"[build] flash_decode_kernel instantiations (registers, spill "
          f"bytes, static and dynamic shared memory, ring stages, HMMA): "
          f"{json.dumps(counts)}", flush=True)
    # 2 dtypes x 4 head dims x (paged, contiguous)
    check(len(counts) == 16, f"the built decode lacks an instantiation: "
                             f"{sorted(counts)}")
    check(all(c["spill"] == 0 for c in counts.values()),
          f"a flash_decode_kernel spills: {counts}")
    check(all(c["hmma"] > 0 for k, c in counts.items() if k.startswith("bf16")),
          f"a bf16 flash_decode_kernel has no HMMA (CUDA-core body): {counts}")
    return counts


def _kernel_info(log: str, cubin: pathlib.Path) -> dict[str, dict]:
    """Per kernel (demangled name): registers and stack from ptxas, and the
    SASS instruction text from cuobjdump (addresses and encodings dropped)."""
    info, cur = {}, None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            cur = m.group(1)
            info[cur] = {}
        elif cur and _PTXAS_STACK.search(line):
            st = _PTXAS_STACK.search(line)
            info[cur]["stack"], info[cur]["spill"] = int(st.group(1)), int(st.group(2))
        elif cur and _PTXAS_REGS.search(line):
            info[cur]["registers"] = int(_PTXAS_REGS.search(line).group(1))
            sm = _PTXAS_SMEM.search(line)
            info[cur]["smem"] = int(sm.group(1)) if sm else 0
    body = _sass(cubin)
    names = _demangle(sorted(set(info) | set(body)))
    return {names.get(k, k): {**info.get(k, {}), "sass": body.get(k, [])}
            for k in set(info) | set(body)}


def _base_name(kernel: str) -> str:
    """A demangled kernel name without a last template argument ``false``:
    the change may add a ``bool`` template parameter whose ``false``
    instantiation is the parent's kernel."""
    return re.sub(r", (false|\(bool\)0)>\(", ">(", kernel, count=1)


def compare_builds(parent: pathlib.Path, change: pathlib.Path) -> dict:
    """For every kernel the parent builds: its registers, stack and spills
    in both checkouts and whether the change's SASS is identical (matched
    by name, or through ``_base_name`` where the change added a trailing
    ``false`` template argument); plus the kernels only the change
    builds."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for tag, root in (("parent", parent), ("change", change)):
            for name in ("flash_fwd", "flash_decode", "flash_bwd"):
                cub = pathlib.Path(tmp) / f"{tag}-{name}.cubin"
                procs[(tag, name)] = (_cubin(root, name, cub), cub)
        infos = {}
        for key, (proc, cub) in procs.items():
            log, _ = proc.communicate()
            check(proc.returncode == 0, f"nvcc {key} failed:\n{log[-3000:]}")
            infos[key] = _kernel_info(log, cub)
    for name in ("flash_fwd", "flash_decode", "flash_bwd"):
        par, chg = infos[("parent", name)], infos[("change", name)]
        by_base = {_base_name(k): v for k, v in chg.items()
                   if _base_name(k) != k and _base_name(k) not in chg}
        matched = set()
        for kern, p in sorted(par.items()):
            c = chg.get(kern) or by_base.get(kern)
            matched.add(id(c))
            if c is None:
                out[kern] = {"parent": {k: v for k, v in p.items() if k != "sass"},
                             "change": None}
                continue
            out[kern] = {
                "parent": {k: v for k, v in p.items() if k != "sass"},
                "change": {k: v for k, v in c.items() if k != "sass"},
                "sass_instructions": [len(p["sass"]), len(c["sass"])],
                "sass_identical": p["sass"] == c["sass"]}
        out[f"{name}: new kernels"] = sorted(
            k for k, v in chg.items() if id(v) not in matched)
    return out


def ab_main(parent: pathlib.Path, seed: int) -> int:
    card = card_line()
    print(card, flush=True)
    builds = compare_builds(parent, ROOT)
    for kern, rec in builds.items():
        print(f"[ab-build] {kern}: {json.dumps(rec)}", flush=True)
    runs = {"parent": [], "change": []}
    for tag in ("parent", "change", "change", "parent"):
        root = parent if tag == "parent" else ROOT
        code = _AB_RUN.format(src=str(root / "src"), here=str(ROOT), seed=seed)
        out = subprocess.run([sys.executable, "-c", code], cwd=root,
                             capture_output=True, text=True, timeout=900)
        line = [x for x in out.stdout.splitlines() if x.startswith("AB ")]
        check(out.returncode == 0 and len(line) == 1,
              f"A/B run of {tag} failed: {out.stderr[-2000:]}")
        runs[tag].append(json.loads(line[0][3:]))
        print(f"[ab] {tag}: {line[0][3:]}", flush=True)
    print(json.dumps({"ab": runs, "card": card}))
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_ab.json").write_text(json.dumps(
        {"ab": runs, "builds": builds, "card": card}, indent=1))
    return 0


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ab", type=pathlib.Path, default=None,
                    metavar="PARENT_CHECKOUT",
                    help="only A/B the serving path against that checkout")
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print("chip_smoke: src/repro_torch is not beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test runs only on a CUDA card", file=sys.stderr)
        return 3
    if args.ab is not None:
        return ab_main(args.ab.resolve(), args.seed)
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    cubins = {name: out_dir / f"{name}_ptxas.cubin"
              for name in ("flash_bwd", "flash_decode")}
    procs = {name: _cubin(ROOT, name, cub)          # beside the build
             for name, cub in cubins.items()}
    try:
        libs = build.build_all()
    except BaseException:
        for proc in procs.values():
            proc.kill()
            proc.wait()
        raise
    build_s = time.perf_counter() - t0
    print(f"[build] {len(build.SOURCES)} kernel libraries in {build_s:.1f}s",
          flush=True)
    hmma = hmma_counts(libs["flash_fwd"])
    hmma_bwd = bwd_build_counts(procs["flash_bwd"], cubins["flash_bwd"])
    decode_build = decode_build_counts(torch, procs["flash_decode"],
                                       cubins["flash_decode"])

    kernels = kernel_phase(torch, args.seed)
    bwd_kernels, fwd_train = train_kernel_phase(torch, args.seed)
    kernels[0]["at_train_shape"] = fwd_train
    kernels += bwd_kernels
    kernels += paged_grad_kernel_phase(torch, args.seed)
    release(torch)
    at_shapes = new_shape_kernel_phase(torch, args.seed)
    release(torch)
    paths = {"paged_grad": paged_grad_phase(torch, args.seed)}
    release(torch)
    parity = parity_phase(torch, args.seed)
    serve, paths["serve"] = serve_phase(torch, args.seed, card)
    release(torch)
    dense_parity = dense_parity_phase(torch, args.seed)
    dense_serve, paths["dense_serve"] = dense_serve_phase(torch, args.seed,
                                                          card)
    release(torch)
    train_parity = train_parity_phase(torch, args.seed)
    train, paths["train"] = train_phase(torch, args.seed, card)
    release(torch)
    bert_parity = train_parity_phase(torch, args.seed, "bert-large",
                                     lamb_recipe, tag="bert-parity")
    train_bert, paths["train_bert"] = bert_train_phase(torch, args.seed, card)
    release(torch)
    olmo_parity = train_parity_phase(torch, args.seed, "olmo-1b",
                                     tag="olmo-parity")
    train_olmo, paths["train_olmo"] = train_phase(
        torch, args.seed, card, arch="olmo-1b", tag="train-olmo")
    release(torch)
    qwen3_parity = parity_phase(torch, args.seed, "qwen3-32b", n_new=8,
                                tag="qwen3-parity")
    release(torch)
    serve_qwen3, paths["serve_qwen3"] = serve_phase(
        torch, args.seed, card, arch="qwen3-32b",
        num_layers=SERVE_QWEN3_LAYERS, tag="serve-qwen3", hold_shapes=True)
    for name, entry in serve_qwen3.pop("at_shapes").items():
        at_shapes.setdefault(name, {})["serve_qwen3"] = entry
    for rec in kernels:
        by_path = {p: launches[rec["name"]] for p, launches in paths.items()}
        rec["launches"] = sum(by_path.values())
        rec["launches_by_path"] = by_path
        if rec["name"] in at_shapes:
            rec["at_shapes"] = at_shapes[rec["name"]]
            for path, entry in rec["at_shapes"].items():
                entry["launches"] = by_path[path]
    check(all(rec["launches"] > 0 for rec in kernels),
          "a kernel was launched on none of the main paths")

    record = {"card": card, "build_s": build_s, "hmma": hmma,
              "bwd_bf16_build": hmma_bwd, "decode_build": decode_build,
              "kernels": kernels,
              "paged_grad_launches": paths["paged_grad"], "parity": parity,
              "serve": serve, "dense_parity": dense_parity,
              "dense_serve": dense_serve, "train_parity": train_parity,
              "train": train, "bert_parity": bert_parity,
              "train_bert": train_bert, "olmo_parity": olmo_parity,
              "train_olmo": train_olmo, "qwen3_parity": qwen3_parity,
              "serve_qwen3": serve_qwen3,
              "total_s": time.perf_counter() - t_start}
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(f"[done] total {record['total_s']:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
