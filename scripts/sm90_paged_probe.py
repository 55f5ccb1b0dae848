#!/usr/bin/env python3
"""The sm90 paged backward pair's producer and ring, on one CUDA card.

    python3 scripts/sm90_paged_probe.py [--seed N]

``csrc/flash_bwd_sm90.cu`` with ``Paged = true`` feeds the paged dq's ring
from ``PAGED_PRODUCERS`` warps of the producer warpgroup (each takes every
``PAGED_PRODUCERS``-th tile of the walk, one TMA box a page and lane) and
gives the paged pair 8 ring stages at head_dim 64 (4 otherwise). This
script builds copies of the source with other values in place of those
two constants (1, 2 or 4 producer warps; 4 or 8 stages at d 64) under
``build/sm90_paged_probe/``, loads each copy in turn as the wrapper's
library, and at chip_smoke's paged grad shape (``paged_grad_case``: chunks
of 192 and 64 rows against 1536- and 600-token paged prefixes, page 16,
32 q / 8 kv heads of 64, bf16) and at qwen3-32b's heads (64 q / 8 kv of
128) times ``launch_dq_paged`` and ``launch_dkv_paged`` by
``chip_smoke.device_ms``: every variant once in order, then once in
reverse, each result held to the plain paged backward (scaled by its max,
2e-2), with the dq rule's CTA tile forced to 64 and to 128 rows; the
mma.sync pair (``_mma_body``) beside them. Prints one line per timing and
one JSON object last (also ``build/sm90_paged_probe.json``). Builds only
``flash_fwd_sm90`` (the residuals), ``flash_bwd`` (the fold, the mma.sync
pair) and the copies; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

PRODUCERS = "constexpr int PAGED_PRODUCERS = 4;"
STAGES = "static constexpr int STAGES = Paged && D == 64 ? 8 : 4;"
# name: (producer warps, stages at d 64)
VARIANTS = {"w1_s4": (1, 4), "w2_s4": (2, 4), "w4_s4": (4, 4),
            "w4_s8": (4, 8)}


def build_variants(build) -> dict:
    """One nvcc per variant, all started together; returns the libraries."""
    src = (build.CSRC / "flash_bwd_sm90.cu").read_text()
    if src.count(PRODUCERS) != 1 or src.count(STAGES) != 1:
        raise SystemExit("sm90_paged_probe: the source's constants moved")
    procs = {}
    for name, (warps, stages) in VARIANTS.items():
        d = ROOT / "build" / "sm90_paged_probe" / name
        d.mkdir(parents=True, exist_ok=True)
        for header in build.CSRC.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        (d / "flash_bwd_sm90.cu").write_text(
            src.replace(PRODUCERS, f"constexpr int PAGED_PRODUCERS = {warps};")
            .replace(STAGES, "static constexpr int STAGES = "
                             f"Paged && D == 64 ? {stages} : 4;"))
        so = d / "flash_bwd_sm90.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so),
               str(d / "flash_bwd_sm90.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"sm90_paged_probe: {name} failed:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("sm90_paged_probe: no CUDA card", file=sys.stderr)
        return 1
    build.build_all(("flash_fwd_sm90", "flash_bwd"))
    libs = build_variants(build)
    card = cs.card_line()
    print(card, flush=True)
    rule = fa.sm90_bwd_rows

    def use(name):
        build._LIBS["flash_bwd_sm90"] = libs[name]
        fa._sm90_lib()

    out = {}
    for tag, heads in (("granite", dict(hq=32, hkv=8, d=64)),
                       ("qwen3", dict(hq=64, hkv=8, d=128))):
        c = cs.paged_grad_case(torch, args.seed, **heads)
        q, kp, vp, pl = c["q"], c["k_pool"], c["v_pool"], c["page_list"]
        call = c["call"]
        o, m, l = fa.flash_prefill_paged_forward(q, kp, vp, pl, c["layout"],
                                                 **call)
        ops_ = fa.prepare_backward(q, kp, vp, o, c["do"], m, l, None,
                                   c["layout"], q_offset=0,
                                   block_k=kp.shape[2], page_list=pl, **call)
        want = fa.flash_prefill_paged_backward_plain(
            q, kp, vp, pl, o, c["do"], m, l, c["layout"], **call)
        names = [n for n, (_, st) in VARIANTS.items()
                 if heads["d"] == 64 or st == 4]
        for rows in (64, 128):
            fa.sm90_bwd_rows = lambda *a, kernel="dq", head_dim=64, r=rows: (
                128 if kernel == "dkv" and head_dim == 128
                else r if kernel == "dq" else rule(*a, kernel=kernel,
                                                   head_dim=head_dim))
            res = {n: {"dq_ms": [], "dkv_ms": []} for n in names}
            for order in (names, names[::-1]):
                for n in order:
                    use(n)
                    dq = fa.launch_dq_paged(ops_)
                    dk, dv = fa.launch_dkv_paged(ops_)
                    folded = fa.launch_fold_paged(dk, dv, pl, kp.shape[1],
                                                  kp.dtype)
                    torch.cuda.synchronize()
                    err = max(cs.scaled_err(g, w)
                              for g, w in zip((dq, *folded), want))
                    if err > 2e-2:
                        raise SystemExit(f"sm90_paged_probe: {tag} {n} rows "
                                         f"{rows}: scaled error {err}")
                    res[n]["dq_ms"].append(cs.device_ms(
                        torch, [lambda: fa.launch_dq_paged(ops_)]))
                    res[n]["dkv_ms"].append(cs.device_ms(
                        torch, [lambda: fa.launch_dkv_paged(ops_)]))
            fa.sm90_bwd_rows = rule
            for n in names:
                print(f"{tag} dq rows {rows} {n}: dq {res[n]['dq_ms']} ms, "
                      f"dkv {res[n]['dkv_ms']} ms", flush=True)
            out[f"{tag}_dq_rows{rows}"] = res
        out[f"{tag}_mma"] = {
            "dq_ms": cs.device_ms(torch, [lambda: fa.launch_dq_paged(
                ops_, _mma_body=True)]),
            "dkv_ms": cs.device_ms(torch, [lambda: fa.launch_dkv_paged(
                ops_, _mma_body=True)])}
        print(f"{tag} mma.sync pair: {out[f'{tag}_mma']}", flush=True)
        del c, ops_, want
    record = {"card": card, "variants": VARIANTS, "results": out}
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "sm90_paged_probe.json").write_text(
        json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
