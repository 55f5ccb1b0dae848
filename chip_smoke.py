#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Imports nothing of JAX or of the JAX package; needs one CUDA card and the
repository checkout beside it (``src/repro_torch``). Phases:

1. print the card's name and power limit (nvidia-smi), then build every
   CUDA kernel of the serving path from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, started together);
2. kernels: each kernel against its plain PyTorch version at the main
   path's shapes in bf16 (hq 32 / hkv 8 / d 64, page 16): a ~2k-token
   packed prefill with several documents (flash_fwd), a 256-row chunk
   against 1.5k-token paged prefixes (flash_fwd_paged), decode at batch 8
   over ~1k-token contexts (flash_decode_paged). Tolerances: max |o - o_plain|
   <= 2e-2 (bf16 output), m and l within 1e-2 relative. Each is timed with
   CUDA events after warm-up, inputs rotated so the working set exceeds the
   50 MB L2; the plain version is timed the same way, and for flash_fwd so
   is one ``scaled_dot_product_attention`` call with the equivalent boolean
   mask (``library_ms``; the port never calls it);
3. parity: granite-3-2b at full width, 2 layers, float32: the same weights
   served by the engine on ``cuda`` (kernels) and on ``cpu`` (plain
   versions); greedy tokens must be identical (a divergence at a near-tie
   is reported with its step and top-2 logit margin);
4. serve: the published granite-3-2b (40 layers, bf16, random weights from
   the seed): 8 requests on 4 lanes, a 64-token shared prefix, one
   1024-token prompt prefilled in chunks of 256, 32 new tokens each. Every
   kernel's launch counter is reset just before and must be > 0 just
   after; prints tokens/s, TTFT p50 and peak memory beside the card. The
   same serve then runs once more under ``torch.profiler`` for the device
   busy share and the kernels that take the most device time.

Prints one JSON line of kernel results, then as its last line
``{"ok": true, "device": {...}}``. Exits non-zero on any failure, without
a CUDA device, or without the repository beside it. A full record is
written to ``build/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12          # dense bf16 tensor-core peak
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
    """Mean device time of one call (CUDA events around ``iters`` calls),
    cycling over ``fns`` — one closure per rotated input copy."""
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


def copies_for(nbytes: int) -> int:
    """Input copies to rotate so one pass exceeds twice the L2 cache."""
    return max(1, min(16, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def bound(nbytes: float, flops: float, dtype_peak: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / dtype_peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def rel_err(a, b) -> float:
    """max |a - b| / max(1, |b|) over finite entries (m and l)."""
    a, b = a.float(), b.float()
    return float(((a - b).abs() / b.abs().clamp_min(1.0)).max())


# ---------------------------------------------------------------------------
# phase 2: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def kernel_phase(torch, seed: int) -> list[dict]:
    from repro_torch.core import masks as M
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
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
    q, k, v = randn(1, hq, S, d), randn(1, hkv, S, d), randn(1, hkv, S, d)
    out = fa.flash_attention_forward(q, k, v, None, layout, **call)
    torch.cuda.synchronize()
    plain = fa.flash_attention_forward_plain(q, k, v, None, layout, **call)
    sets = [(q, k, v)] + [(randn(1, hq, S, d), randn(1, hkv, S, d),
                           randn(1, hkv, S, d))
                          for _ in range(copies_for(nbytes(q, k, v)) - 1)]
    ms = time_ms(torch, [lambda a=a: fa.flash_attention_forward(
        *a, None, layout, **call) for a in sets])
    plain_ms = time_ms(torch, [lambda: fa.flash_attention_forward_plain(
        q, k, v, None, layout, **call)], warmup=1, iters=3)
    mask = spec.element_mask(S, S)                   # (1, 1, S, S) bool
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, [lambda a=a: sdpa(*a, attn_mask=mask, scale=scale,
                                              enable_gqa=True) for a in sets])
    pairs = int(mask.sum()) * hq
    b_ms, b_by = bound(nbytes(q, k, v, out[0], out[1], out[2], layout, seg, seg),
                       4.0 * d * pairs, BF16_FLOPS_PER_S)
    results.append(_kernel_record(
        "flash_fwd", "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "src/repro/kernels/flash_attention.py:325", out, plain, ms, plain_ms,
        b_ms, b_by, lib_ms, shape=f"packed prefill b=1 S={S} docs={lengths}"))

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
    qc = randn(1, hq, sq, d)
    pool_k, pool_v = randn(hkv, num_pages, ps, d), randn(hkv, num_pages, ps, d)
    out = fa.flash_prefill_paged_forward(qc, pool_k, pool_v, page_list, play,
                                         **pcall)
    torch.cuda.synchronize()
    plain = fa.flash_prefill_paged_forward_plain(qc, pool_k, pool_v,
                                                 page_list, play, **pcall)
    live = int((page_list >= 0).sum())
    kv_bytes = 2 * live * hkv * ps * d * 2
    sets = [(qc, pool_k, pool_v)] + [
        (randn(1, hq, sq, d), randn(hkv, num_pages, ps, d),
         randn(hkv, num_pages, ps, d))
        for _ in range(copies_for(nbytes(qc) + kv_bytes) - 1)]
    ms = time_ms(torch, [lambda a=a: fa.flash_prefill_paged_forward(
        *a, page_list, play, **pcall) for a in sets])
    plain_ms = time_ms(torch, [lambda: fa.flash_prefill_paged_forward_plain(
        qc, pool_k, pool_v, page_list, play, **pcall)], warmup=1, iters=3)
    pairs = int(pspec.element_mask(sq, T * ps).sum()) * hq
    b_ms, b_by = bound(nbytes(qc, out[0], out[1], out[2], play, page_list,
                              q_seg, q_pos, kv_seg, kv_pos) + kv_bytes,
                       4.0 * d * pairs, BF16_FLOPS_PER_S)
    results.append(_kernel_record(
        "flash_fwd_paged", "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "src/repro/kernels/flash_attention.py:765", out, plain, ms, plain_ms,
        b_ms, b_by, None,
        shape=f"chunks {chunks} against paged prefixes {spans}, page {ps}"))

    # -- flash_decode_paged: batch 8 over ~1k-token contexts ----------------
    b, cap = 8, 1152
    T = cap // ps
    kv_len = torch.tensor([900, 1100, 1000, 1024, 950, 1050, 980, 1070],
                          dtype=torch.int32, device=dev)
    num_pages = b * T
    table = torch.randperm(num_pages, generator=gen, device=dev).int()
    table = table.reshape(b, T).clone()
    for i, n in enumerate(kv_len.tolist()):
        table[i, -(-(n + 1) // ps):] = -1           # unallocated tail
    splits = tuning.resolve_paged_decode_splits(T)
    dlay = M.paged_block_layout(kv_len, table, ps)
    qd = randn(b, hq, 1, d)
    dk, dv = randn(hkv, num_pages, ps, d), randn(hkv, num_pages, ps, d)
    dcall = dict(scale=scale, num_splits=splits, window=None)
    parts = fd.flash_decode_paged_partials(qd, dk, dv, table, kv_len, dlay,
                                           **dcall)
    torch.cuda.synchronize()
    pparts = fd.flash_decode_paged_partials_plain(qd, dk, dv, table, kv_len,
                                                  dlay, **dcall)
    out = (fd._merge_split_partials(*parts, bf16), parts[1], parts[2])
    plain = (fd._merge_split_partials(*pparts, bf16), pparts[1], pparts[2])
    rows = sum(-(-n // ps) * ps for n in kv_len.tolist())
    kv_bytes = 2 * rows * hkv * d * 2
    sets = [(qd, dk, dv)] + [
        (randn(b, hq, 1, d), randn(hkv, num_pages, ps, d),
         randn(hkv, num_pages, ps, d))
        for _ in range(copies_for(kv_bytes) - 1)]
    ms = time_ms(torch, [lambda a=a: fd.flash_decode_paged_partials(
        *a, table, kv_len, dlay, **dcall) for a in sets])
    plain_ms = time_ms(torch, [lambda: fd.flash_decode_paged_partials_plain(
        qd, dk, dv, table, kv_len, dlay, **dcall)], warmup=1, iters=3)
    pairs = int(kv_len.sum()) * hq
    b_ms, b_by = bound(nbytes(qd, *parts, table, kv_len, dlay) + kv_bytes,
                       4.0 * d * pairs, BF16_FLOPS_PER_S)
    results.append(_kernel_record(
        "flash_decode_paged", "src/repro_torch/kernels/csrc/flash_decode.cu",
        "src/repro/kernels/flash_decode.py:329", out, plain, ms, plain_ms,
        b_ms, b_by, None,
        shape=f"decode b={b} kv_len {kv_len.tolist()} page {ps} "
              f"splits {splits}"))
    return results


def _kernel_record(name, source, replaces, out, plain, ms, plain_ms, b_ms,
                   b_by, lib_ms, shape):
    o_err = float((out[0].float() - plain[0].float()).abs().max())
    m_err, l_err = rel_err(out[1], plain[1]), rel_err(out[2], plain[2])
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": None, "max_abs_err": o_err,
           "m_rel_err": m_err, "l_rel_err": l_err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": lib_ms, "shape": shape}
    print(f"[kernel] {name}: {shape}: max|o-plain| {o_err:.3g} "
          f"m rel {m_err:.3g} l rel {l_err:.3g}; {ms:.4f} ms "
          f"(plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}"
          + (f", library {lib_ms:.4f} ms" if lib_ms is not None else "")
          + ")", flush=True)
    check(o_err <= 2e-2, f"{name}: max |o - plain| {o_err} > 2e-2")
    check(m_err <= 1e-2 and l_err <= 1e-2,
          f"{name}: m/l relative error {m_err}/{l_err} > 1e-2")
    return rec


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


def parity_phase(torch, seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, params_to
    from repro_torch.serve import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("granite-3-2b"), num_layers=2,
                              dtype="float32", attn_impl="pallas",
                              use_decode_kernel=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed), device="cpu")
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
        outs[device] = _serve(engines[device], prompts, 12, prime=True)
        print(f"[parity] {device}: {sum(map(len, outs[device].values()))} "
              f"tokens in {time.perf_counter() - t0:.2f}s", flush=True)
    check(engines["cuda"].prefix_hits >= 1, "parity run had no prefix hit")
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
        print(f"[parity] request {rid} diverges at generated step {i}: "
              f"cuda {got[i]} cpu {ref[i]}, top-2 logit margin {margin:.3g}",
              flush=True)
        diverged.append({"rid": rid, "step": i, "margin": margin})
        check(margin < 1e-3, f"request {rid} diverged at step {i} with a "
                             f"top-2 margin {margin:.3g} (not a near-tie)")
    print(f"[parity] greedy tokens identical: {not diverged} "
          f"({len(outs['cpu'])} requests, near-tie divergences: "
          f"{len(diverged)})", flush=True)
    return {"identical": not diverged, "near_tie_divergences": diverged,
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


def serve_phase(torch, seed: int, card: str) -> tuple[dict, dict]:
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServingEngine

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("granite-3-2b"), attn_impl="pallas",
                              use_decode_kernel=True)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
          f"{cfg.dtype}, weights in {time.perf_counter() - t0:.1f}s",
          flush=True)
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
          "serve phase did not finish every request")
    check(eng.prefix_hits >= 1, "serve phase had no prefix-cache hit")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was never launched in the serve phase")
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
    print(f"[serve] {n_tok} tokens in {wall:.2f}s: {n_tok / wall:.1f} tok/s, "
          f"TTFT p50 {lat['ttft_p50'] * 1e3:.1f} ms, peak memory "
          f"{peak / 2**30:.2f} GiB, prefix hits {eng.prefix_hits}, "
          f"launches {launches} [{card}]", flush=True)
    return rec, launches


def profile_serve(torch, model, params, prompts, kw) -> dict:
    """The same serve once more under ``torch.profiler`` (not timed for the
    end-to-end numbers: tracing adds host cost): device busy share of the
    wall time, device time per launch of each ported kernel, and the
    kernels that take the most device time. Launch counters are not read
    here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ServingEngine

    eng = ServingEngine(model, params, **kw)
    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0.0)

    busy_us = sum(dev_us(e) for e in kernels)
    if busy_us <= 0:
        print("[profile] the profiler recorded no device time: not measured",
              flush=True)
        return {"busy_share": None}
    ported = {"flash_fwd": ("flash_fwd_kernel", "false>"),
              "flash_fwd_paged": ("flash_fwd_kernel", "true>"),
              "flash_decode_paged": ("flash_decode_paged_kernel", "")}
    per_kernel = {}
    for name, (stem, tag) in ported.items():
        hits = [e for e in kernels if stem in e.key and tag in e.key]
        n = sum(e.count for e in hits)
        per_kernel[name] = {
            "launches": n, "device_ms_total": sum(dev_us(e) for e in hits) / 1e3,
            "device_ms_per_launch": (sum(dev_us(e) for e in hits) / 1e3 / n
                                     if n else None)}
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    out = {"wall_s": wall_us / 1e6, "device_busy_s": busy_us / 1e6,
           "busy_share": busy_us / wall_us, "ported": per_kernel,
           "top": [{"kernel": e.key[:90], "count": e.count,
                    "device_ms": dev_us(e) / 1e3} for e in top]}
    print(f"[profile] serve under torch.profiler: wall {wall_us / 1e6:.2f}s, "
          f"device busy {busy_us / 1e6:.3f}s ({busy_us / wall_us:.1%}); "
          f"ported kernels {json.dumps(per_kernel)}", flush=True)
    for t in out["top"]:
        print(f"[profile]   {t['device_ms']:9.2f} ms  x{t['count']:<6} "
              f"{t['kernel']}", flush=True)
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
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
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {len(build.SOURCES)} kernel libraries in {build_s:.1f}s",
          flush=True)

    kernels = kernel_phase(torch, args.seed)
    parity = parity_phase(torch, args.seed)
    serve, launches = serve_phase(torch, args.seed, card)
    for rec in kernels:
        rec["launches"] = launches[rec["name"]]

    record = {"card": card, "build_s": build_s, "kernels": kernels,
              "parity": parity, "serve": serve,
              "total_s": time.perf_counter() - t_start}
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
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
