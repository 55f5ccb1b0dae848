#!/usr/bin/env python3
"""The sm90 forward's CTA modes on one CUDA card: 128 rows, 64 rows, and a
64-row tile's kv walk split over a thread-block cluster.

    python3 scripts/sm90_fwd_probe.py [--seed N]

``csrc/flash_fwd_sm90.cu`` runs a CTA over 128 q rows (one 64-row layout
block per consumer warpgroup, both reading every K/V stage), over 64 rows
(both warpgroups on the same block, taking alternate kv tiles and merging
at the end), or over 64 rows with the kv walk dealt over ``splits`` CTAs
of one cluster that merge through distributed shared memory;
``tuning.sm90_fwd_rows`` and ``tuning.sm90_fwd_splits`` pick one by the
call's grid. At each shape this script launches the forward on the same
inputs with the rule forced to every mode in ``MODES``, holds the modes'
outputs to the rule's own (o within 2e-2, m and l 1e-2 relative; the
merges add in another order), and times each by ``chip_smoke.device_ms``
in the order of ``MODES`` and back. The shapes (bf16):

  * ``seamless_cross``: 4 x 16 heads of 64 decoder rows against 1024
    encoder rows, d 64, non-causal (serve-seamless's cross prefill: 64
    CTAs of 64 rows);
  * ``serve_first_chunk``: granite-3-2b's first 256-row chunk of a prompt
    (32 q / 8 kv heads of 64, causal) against its own 16 pages of 16;
  * ``serve_paged_chunks``: phase 2's #4 shape, chunks of 192 and 64 rows
    against paged prefixes of 1536 and 600 tokens, page 16;
  * ``qwen3_paged_chunk``: the same chunks at qwen3-32b's heads (64 q / 8
    kv of 128);
  * ``train``: granite's train layer (4, 32/8, 2048, 64), causal;
  * ``bert``: bert-large's layer (56, 16, 512, 64), non-causal;
  * ``chunk_against_16k_prefix``: a 64-row chunk of 8 q / 2 kv heads of 64
    against a 16384-token paged prefix (8 CTAs of 64 rows, 257 kv tiles:
    the only shape here where the rule splits).

Prints one line per shape and one JSON object last. Builds only
``flash_fwd_sm90``; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# the forced (rows, splits) of each timed mode
MODES = ((128, 1), (64, 1), (64, 2), (64, 4), (64, 8))


def contiguous_case(torch, M, gen, b, hq, hkv, sq, sk, d, causal):
    def randn(*shp):
        return torch.randn(*shp, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    q_offset = sk - sq if causal else 0
    layout = M.compile_block_layout(
        M.MaskSpec(causal=causal, q_offset=q_offset), sq, sk, 64,
        64).as_array("cuda")
    call = dict(scale=d ** -0.5, causal=causal, window=None,
                q_offset=q_offset, block_q=64, block_k=64)
    return (randn(b, hq, sq, d), randn(b, hkv, sk, d), randn(b, hkv, sk, d),
            None, layout), call, -(-sk // 64)


def paged_case(torch, M, gen, hq, hkv, d, spans, chunks, ps=16):
    """Chunks (the tails of their documents) packed in one q row against
    their paged prefixes, as chip_smoke's phase 2 builds #4's case."""
    def randn(*shp):
        return torch.randn(*shp, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    sq = sum(chunks)
    T = sum(-(-s // ps) for s in spans) + 2
    num_pages = max(400, T + 8)
    pages = torch.randperm(num_pages, generator=gen, device="cuda").int()
    page_list = torch.full((1, T), -1, dtype=torch.int32, device="cuda")
    kv_seg = torch.full((1, T * ps), M.SEG_PAD_KV, dtype=torch.int32,
                        device="cuda")
    kv_pos = torch.full((1, T * ps), M.POS_PAD, dtype=torch.int32,
                        device="cuda")
    q_seg = torch.empty((1, sq), dtype=torch.int32, device="cuda")
    q_pos = torch.empty((1, sq), dtype=torch.int32, device="cuda")
    slot = row = 0
    for i, (span, n) in enumerate(zip(spans, chunks)):
        np_ = -(-span // ps)
        page_list[0, slot:slot + np_] = pages[slot:slot + np_]
        kv_seg[0, slot * ps:slot * ps + span] = i
        kv_pos[0, slot * ps:slot * ps + span] = torch.arange(span,
                                                             device="cuda")
        q_seg[0, row:row + n] = i
        q_pos[0, row:row + n] = torch.arange(span - n, span, device="cuda")
        slot, row = slot + np_, row + n
    spec = M.MaskSpec(causal=True, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                      q_positions=q_pos, kv_positions=kv_pos)
    layout = M.compile_block_layout(spec, sq, T * ps, 64, ps).as_array("cuda")
    layout = M.paged_prefill_block_layout(layout, page_list)
    call = dict(scale=d ** -0.5, causal=True, window=None, block_q=64,
                q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                q_positions=q_pos, kv_positions=kv_pos)
    return (randn(1, hq, sq, d), randn(hkv, num_pages, ps, d),
            randn(hkv, num_pages, ps, d), page_list, layout), call, \
        -(-T * ps // 64)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.core import masks as M
    from repro_torch.kernels import build, tuning
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("sm90_fwd_probe: no CUDA card", file=sys.stderr)
        return 1
    build.build_all(("flash_fwd_sm90",))
    card = cs.card_line()
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows_rule, splits_rule = fa.sm90_fwd_rows, fa.sm90_fwd_splits

    def forced(mode, fn):
        fa.sm90_fwd_rows = lambda *a, **k: mode[0]
        fa.sm90_fwd_splits = lambda *a, **k: mode[1]
        try:
            return fn()
        finally:
            fa.sm90_fwd_rows, fa.sm90_fwd_splits = rows_rule, splits_rule

    cases = {
        "seamless_cross": lambda g: contiguous_case(
            torch, M, g, 4, 16, 16, 64, 1024, 64, False),
        "serve_first_chunk": lambda g: paged_case(
            torch, M, g, 32, 8, 64, [256], [256]),
        "serve_paged_chunks": lambda g: paged_case(
            torch, M, g, 32, 8, 64, [1536, 600], [192, 64]),
        "qwen3_paged_chunk": lambda g: paged_case(
            torch, M, g, 64, 8, 128, [1536, 600], [192, 64]),
        "train": lambda g: contiguous_case(
            torch, M, g, 4, 32, 8, 2048, 2048, 64, True),
        "bert": lambda g: contiguous_case(
            torch, M, g, 56, 16, 16, 512, 512, 64, False),
        "chunk_against_16k_prefix": lambda g: paged_case(
            torch, M, g, 8, 2, 64, [16384], [64]),
    }
    out = {}
    for name, make in cases.items():
        gen = torch.Generator(device="cuda").manual_seed(args.seed + len(name))
        inputs, call, tiles = make(gen)
        paged = "chunk" in name
        fwd = (fa.flash_prefill_paged_forward if paged
               else fa.flash_attention_forward)
        b, hq, sq = inputs[0].shape[:3]
        nq = sq // 64
        rule = (tuning.sm90_fwd_rows(b, hq, nq, sms),
                tuning.sm90_fwd_splits(b, hq, nq, tiles, sms))
        want = fwd(*inputs, **call)
        times, errs = {m: [] for m in MODES}, {}
        for mode in MODES:
            got = forced(mode, lambda: fwd(*inputs, **call))
            torch.cuda.synchronize()
            errs[mode] = (float((got[0].float() - want[0].float()).abs().max()),
                          cs.rel_err(got[1], want[1]),
                          cs.rel_err(got[2], want[2]))
            if errs[mode][0] > 2e-2 or max(errs[mode][1:]) > 1e-2:
                print(f"sm90_fwd_probe: {name} {mode}: differs from the "
                      f"rule's mode by {errs[mode]}", file=sys.stderr)
                return 1
        for mode in MODES + MODES[::-1]:
            times[mode].append(cs.device_ms(torch, [
                lambda mode=mode: forced(mode, lambda: fwd(*inputs, **call))]))
        ms = {m: sum(t) / len(t) for m, t in times.items()}
        base = ms[(64, 1)]
        rec = {"shape": [b, hq, sq, int(inputs[1].shape[-1])], "paged": paged,
               "kv_tiles": tiles, "rule": list(rule),
               "ms": {f"{r}x{s}": v for (r, s), v in ms.items()},
               "samples": {f"{r}x{s}": t for (r, s), t in times.items()},
               "over_64x1": {f"{r}x{s}": v / base for (r, s), v in ms.items()},
               "max_abs_err_vs_rule": {f"{r}x{s}": e[0]
                                       for (r, s), e in errs.items()}}
        out[name] = rec
        print(f"[modes] {name} {rec['shape']} (rule {rule[0]} rows, "
              f"{rule[1]} splits): "
              + ", ".join(f"{r}x{s} {v:.4f} ms ({v / base:.3f})"
                          for (r, s), v in ms.items()), flush=True)
        del inputs, want
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "modes": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
