#!/usr/bin/env python3
"""The sm90 backward pair's two CTA tiles, 64 and 128 rows, on one CUDA card.

    python3 scripts/sm90_rows_probe.py [--seed N]

``csrc/flash_bwd_sm90.cu`` runs a CTA over 128 rows (one 64-row layout
block per consumer warpgroup) or over 64 rows (both warpgroups on the
same block, taking alternate items of the walk and adding their sums at
the end); ``tuning.sm90_bwd_rows`` picks one by the shape's grid. At each
shape where the rule takes 64 rows for a kernel, this script launches that
kernel on the same residuals with the rule forced to 64 and to 128 rows,
holds the two results to each other (scaled by their max, 2e-2; the merge
adds in another order), and times each by ``chip_smoke.device_ms`` in the
order 128, 64, 64, 128. The shapes (bf16, head_dim 64 unless named):

  * ``dp2tp2``: train-dp2tp2's rank layer (2 rows of the launcher's first
    granite-3-2b batch, its documents, 16 q / 4 kv heads, 2048 rows,
    causal): dkv at 64 rows;
  * ``dp2tp2_nodocs``: the same without documents (the causal triangle
    alone sets the walks' lengths);
  * ``cross_64x1024``: 4 x 16 heads of 64 q rows against 1024 keys,
    non-causal (seamless's cross-attention prefill): dq at 64 rows;
  * ``one_head_2k`` and ``one_head_2k_d128``: one head of 2048 causal rows,
    dq and dkv (dkv at d 128 has only the 128-row tile).

Prints one line per timing and one JSON object last. Builds only
``flash_fwd`` (the residuals) and ``flash_bwd_sm90``; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# (b, hq, hkv, sq, sk, d, causal, documents)
SHAPES = {
    "dp2tp2": (2, 16, 4, 2048, 2048, 64, True, True),
    "dp2tp2_nodocs": (2, 16, 4, 2048, 2048, 64, True, False),
    "cross_64x1024": (4, 16, 16, 64, 1024, 64, False, False),
    "one_head_2k": (1, 1, 1, 2048, 2048, 64, True, False),
    "one_head_2k_d128": (1, 1, 1, 2048, 2048, 128, True, False),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core import masks as M
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("sm90_rows_probe: no CUDA card", file=sys.stderr)
        return 1
    build.build_all(("flash_fwd", "flash_bwd_sm90"))
    dev = torch.device("cuda")
    card = cs.card_line()
    print(card, flush=True)
    rule = fa.sm90_bwd_rows

    def forced(rows, fn):
        fa.sm90_bwd_rows = lambda *a, **k: rows
        try:
            return fn()
        finally:
            fa.sm90_bwd_rows = rule

    out = {}
    for name, (b, hq, hkv, sq, sk, d, causal, docs) in SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(args.seed + sq + d)
        seg = None
        if docs:
            cfg = get_config("granite-3-2b")
            seg = torch.as_tensor(SyntheticLM(cfg.vocab_size, sq, 4,
                                              seed=args.seed).batch_at(0)
                                  ["segment_ids"][:b]).to(dev)

        def randn(*shp):
            return torch.randn(*shp, generator=gen, device=dev,
                               dtype=torch.bfloat16)

        q, k, v, do = (randn(b, hq, sq, d), randn(b, hkv, sk, d),
                       randn(b, hkv, sk, d), randn(b, hq, sq, d))
        spec = M.MaskSpec(causal=causal, q_segment_ids=seg,
                          kv_segment_ids=seg)
        layout = M.compile_block_layout(spec, sq, sk, 64, 64).as_array(dev)
        call = dict(scale=d ** -0.5, causal=causal, window=None, q_offset=0,
                    block_q=64, block_k=64, q_segment_ids=seg,
                    kv_segment_ids=seg)
        o, m, l = fa.flash_attention_forward(q, k, v, None, layout, **call)
        ops = fa.prepare_backward(q, k, v, o, do, m, l, None, layout, **call)
        assert ops.body == "sm90", ops.body
        nq, nk = sq // 64, sk // 64
        picks = {"dq": rule(b, hq, nq, kernel="dq", head_dim=d),
                 "dkv": rule(b, hkv, nk, kernel="dkv", head_dim=d)}
        for kern, launch in (("dq", fa.launch_dq), ("dkv", fa.launch_dkv)):
            if kern == "dkv" and d == 128:
                continue              # dkv at d 128 has the 128-row tile only
            if picks[kern] == 128 and not name.startswith("one_head"):
                continue              # the rule already takes 128 rows here
            got = {r: forced(r, lambda: launch(ops)) for r in (64, 128)}
            if kern == "dq":
                got = {r: (g,) for r, g in got.items()}
            err = max(map(cs.scaled_err, got[64], got[128]))
            times = {64: [], 128: []}
            for r in (128, 64, 64, 128):
                times[r].append(cs.device_ms(torch, [
                    lambda r=r: forced(r, lambda: launch(ops))]))
            ms = {r: sum(t) / len(t) for r, t in times.items()}
            rec = {"shape": [b, hq, hkv, sq, sk, d], "causal": causal,
                   "documents": docs, "rule_rows": picks[kern],
                   "ms_64": ms[64], "ms_128": ms[128],
                   "samples_64": times[64], "samples_128": times[128],
                   "ratio_128_over_64": ms[128] / ms[64],
                   "scaled_diff_64_vs_128": err}
            out[f"{name} {kern}"] = rec
            print(f"[rows] {name} {kern}: 64 rows {ms[64]:.4f} ms, 128 rows "
                  f"{ms[128]:.4f} ms (128 / 64 = {ms[128] / ms[64]:.3f}; rule "
                  f"{picks[kern]}); |64 - 128| scaled {err:.3g}", flush=True)
            if err > 2e-2:
                print(f"sm90_rows_probe: {name} {kern}: the tiles differ by "
                      f"{err}", file=sys.stderr)
                return 1
        del q, k, v, do, o, m, l, ops
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "rows": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
