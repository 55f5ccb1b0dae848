#!/usr/bin/env python3
"""Where the split-KV decode's time goes, on one CUDA card.

    python3 scripts/decode_probe.py

Builds four copies of ``src/repro_torch`` under ``build/decode_probe/``,
each with an altered ``csrc/flash_decode.cu``, beside the unaltered one:

  * ``trace``: the kernel records per CTA (thread 0) ``clock64`` at its
    phases (start, listing done, first tile done, ring done, warps
    merged, CTA partial written, cluster merge done, end) and
    ``%globaltimer`` at start and end;
  * ``noload``: the ring's 16-byte copies removed (the arithmetic runs on
    whatever the ring holds): the time without the K/V bytes;
  * ``nocompute``: the per-tile arithmetic removed (the copies still land):
    the time without the arithmetic;
  * ``spread``: the clusters placed by the default (spread) policy instead
    of load balancing.

Then, at ``chip_smoke.py``'s kernel-phase decode shapes (bf16, 32/8 heads,
d 64, batch 8, kv_len 900-1100; paged: page 16 over a 1152-slot table;
contiguous: a 2048-slot cache, block 64), prints the whole decode's device
time (``chip_smoke.device_ms``) for several split counts in each copy, and
the traced copy's phase cycles (mean, median, max over CTAs) and CTA
start/end times for the paged decode at 8 splits. Each copy runs in a
process of its own. Needs the repository checkout; imports no JAX.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "decode_probe"
KERNEL = pathlib.Path("src/repro_torch/kernels/csrc/flash_decode.cu")

TRACE_HEAD = """__device__ unsigned long long g_trace[8192 * 16];
__device__ __forceinline__ unsigned long long probe_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TR(i) if (threadIdx.x == 0) { \\
  const long long cta_ = ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x; \\
  if (cta_ < 8192) { g_trace[cta_ * 16 + (i)] = clock64(); \\
    if ((i) == 0 || (i) == 7) g_trace[cta_ * 16 + 8 + (i)] = probe_now(); } }
"""
TRACE_FETCH = """int flash_decode_trace(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, (size_t)n * 16 * 8);
}

const char* flash_decode_error_string(int err) {"""
PHASES = ("listing", "first tile done", "rest of the ring", "warps merged",
          "CTA partial written", "cluster merge", "end")


def _insert(src: str, anchor: str, text: str, before=False) -> str:
    if src.count(anchor) != 1:
        raise SystemExit(f"decode_probe: anchor not found once in "
                         f"{KERNEL.name}: {anchor!r}")
    return src.replace(anchor, text + anchor if before else anchor + text)


def variants(src: str) -> dict[str, str]:
    t = _insert(src, "namespace cg = cooperative_groups;\n", TRACE_HEAD)
    t = _insert(t, "  const int kv_len = p.kv_len[b];\n", "  TR(0);\n")
    t = _insert(t, "    const int n_live = sh.n_live;\n", "    TR(1);\n")
    t = _insert(t, "      core.tile(ks, ks + TILE * D, sh.rows_ok[i]);\n",
                "      if (i == 0) TR(2);\n")
    t = _insert(t, "  flash::cp_async_wait_all();\n", "  TR(3);\n")
    t = _insert(t, "  // then the four warps, in warp order", "  TR(4);\n",
                before=True)
    t = _insert(t, "  cg::cluster_group cluster = cg::this_cluster();\n",
                "  TR(5);\n", before=True)
    t = _insert(t, "  cluster.sync();      // every rank stays", "  TR(6);\n",
                before=True)
    t = _insert(t, "until the others have read it\n", "  TR(7);\n")
    t = t.replace("const char* flash_decode_error_string(int err) {",
                  TRACE_FETCH, 1)
    copies = ("      flash::cp_async16_zfill(ks + Core::offset(r, c), kg + off, valid);\n"
              "      flash::cp_async16_zfill(vs + Core::offset(r, c), vg + off, valid);\n")
    arith = "      core.tile(ks, ks + TILE * D, sh.rows_ok[i]);\n"
    for anchor in (copies, arith):
        if src.count(anchor) != 1:
            raise SystemExit(f"decode_probe: anchor not found once: {anchor!r}")
    lb = "  cfg.numAttrs = 2;\n"
    if src.count(lb) != 1:
        raise SystemExit(f"decode_probe: anchor not found once: {lb!r}")
    return {"base": src, "trace": t, "noload": src.replace(copies, ""),
            "nocompute": src.replace(arith, ""),
            "spread": src.replace(lb, "  cfg.numAttrs = 1;\n")}


RUN = r"""
import ctypes, json, sys
sys.path[:0] = [{src!r}, {root!r}]
import numpy as np, torch
import chip_smoke as cs
from repro_torch.core import masks as M
from repro_torch.kernels import flash_decode as fd

dev, bf16 = torch.device("cuda"), torch.bfloat16
gen = torch.Generator(device=dev).manual_seed(0)
hq, hkv, d, ps, b = 32, 8, 64, 16, 8
kv_len = torch.tensor([900, 1100, 1000, 1024, 950, 1050, 980, 1070],
                      dtype=torch.int32, device=dev)
T = 1152 // ps
table = torch.randperm(b * T, generator=gen, device=dev).int().reshape(b, T)
for i, n in enumerate(kv_len.tolist()):
    table[i, -(-(n + 1) // ps):] = -1
play = M.paged_block_layout(kv_len, table, ps)
rnd = lambda *s: torch.randn(*s, generator=gen, device=dev, dtype=bf16)
psets = [(rnd(b, hq, 1, d), rnd(hkv, b * T, ps, d), rnd(hkv, b * T, ps, d))
         for _ in range(7)]
csets = [(rnd(b, hq, 1, d), rnd(b, hkv, 2048, d), rnd(b, hkv, 2048, d))
         for _ in range(4)]
clay = M.kv_block_layout(M.decode_kv_valid(kv_len, 2048), 64)

def paged(a, s):
    return fd.flash_decode_paged_from_layout(*a, table, kv_len, play,
                                             scale=d ** -0.5, num_splits=s,
                                             window=None)

def contig(a, s):
    return fd.flash_decode_from_layout(*a, kv_len, clay, scale=d ** -0.5,
                                       block_k=64, num_splits=s, window=None)

out = {{"paged": {{}}, "contiguous": {{}}}}
for s in (8, 6, 4, 2, 1):
    out["paged"][s] = cs.device_ms(torch, [lambda a=a: paged(a, s) for a in psets]) * 1e3
for s in (8, 4, 2, 1):
    out["contiguous"][s] = cs.device_ms(torch, [lambda a=a: contig(a, s) for a in csets]) * 1e3
if {trace}:
    lib = fd._lib()
    lib.flash_decode_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for i in range(12):
        paged(psets[i % 7], 8)
    torch.cuda.synchronize()
    n = 8 * hkv * b
    buf = np.zeros((n, 16), np.uint64)
    assert lib.flash_decode_trace(buf.ctypes.data, n) == 0
    clk = buf[:, :8].astype(np.int64)
    g0, g7 = buf[:, 8].astype(np.int64), buf[:, 15].astype(np.int64)
    phases = []
    for i in range(7):
        dd = clk[:, i + 1] - clk[:, i]
        dd = dd[(clk[:, i] > 0) & (clk[:, i + 1] > 0) & (dd >= 0) & (dd < 10**8)]
        phases.append([float(dd.mean()), float(np.median(dd)), int(dd.max()), len(dd)])
    out["trace"] = {{"phases_cycles": phases,
                    "start_us": np.quantile((g0 - g0.min()) / 1e3, [0, .5, .9, 1]).tolist(),
                    "end_us": np.quantile((g7 - g0.min()) / 1e3, [0, .5, .9, 1]).tolist()}}
print("PROBE " + json.dumps(out))
"""


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import torch
    if not torch.cuda.is_available():
        print("decode_probe: needs a CUDA card", file=sys.stderr)
        return 3
    card = chip_smoke.card_line()
    print(card, flush=True)
    srcs = {}
    for name, text in variants((ROOT / KERNEL).read_text()).items():
        copy = OUT / name
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(ROOT / "src" / "repro_torch", copy / "src" / "repro_torch")
        (copy / KERNEL).write_text(text)
        srcs[name] = copy / "src"
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from repro_torch.kernels import build; "
                               "build.build_all(('flash_decode',))"],
        env={**os.environ, "PYTHONPATH": str(src)})
        for src in srcs.values()]
    if any(p.wait() for p in builds):
        print("decode_probe: a build failed", file=sys.stderr)
        return 1
    results = {}
    for name, src in srcs.items():
        code = RUN.format(src=str(src), root=str(ROOT), trace=name == "trace")
        run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, timeout=600)
        line = [x for x in run.stdout.splitlines() if x.startswith("PROBE ")]
        if run.returncode or len(line) != 1:
            print(f"decode_probe: {name} failed:\n{run.stderr[-2000:]}",
                  file=sys.stderr)
            return 1
        results[name] = json.loads(line[0][6:])
        times = {k: {s: round(v, 2) for s, v in results[name][k].items()}
                 for k in ("paged", "contiguous")}
        print(f"[{name}] whole decode, device us by split count: "
              f"{json.dumps(times)} [{card}]", flush=True)
    tr = results["trace"]["trace"]
    for label, (mean, p50, mx, n) in zip(PHASES, tr["phases_cycles"]):
        print(f"[trace] paged, 8 splits: to {label:20s} cycles mean {mean:8.0f} "
              f"median {p50:8.0f} max {mx:8d} (CTAs {n})")
    print(f"[trace] CTA start us (min, median, p90, max) {tr['start_us']}, "
          f"end us {tr['end_us']}")
    print(json.dumps({"card": card, **results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
