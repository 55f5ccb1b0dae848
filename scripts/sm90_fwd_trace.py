#!/usr/bin/env python3
"""Where a tile's time goes inside the sm90 forward, on one CUDA card.

    python3 scripts/sm90_fwd_trace.py

``csrc/flash_fwd_sm90.cu`` cannot be profiled from inside on a machine
where ``ncu`` does not run, so this script writes a copy of it with
``clock64()`` stamps at the boundaries of each role's phases (under
``build/sm90_fwd_trace/``; the source in the repo is not touched), builds
that copy, and launches it in place of the real library through the same
wrapper (``flash_attention.flash_attention_forward`` /
``flash_prefill_paged_forward``). Each CTA's first thread of each
warpgroup adds up, over the kv tiles its role handles, the cycles spent in:

  * consumer warpgroups (roles 0 and 1): ``wait_full`` (the tile's K / V
    not landed yet), ``issue`` (issuing S = Q'K^T and the last tile's P V),
    ``wait_S`` (the dropout hash and the wait for S), ``softmax`` (mask,
    row max, P = exp2, row sums), ``wait_PV`` (the last tile's P V and the
    release of its stage), ``rescale_toA`` (the accumulator's rescale and P
    to A fragments), ``loop_other`` (the loop's own bookkeeping); once per
    CTA ``prologue`` (kernel entry to the first tile: barriers, the walk,
    Q') and ``epilogue`` (the last P V, the merges);
  * the producer (role 2): ``wait_empty`` (a stage still in use) and
    ``issue`` (the copies of a tile).

It prints, per shape, each role's cycles per tile and per CTA, the traced
and the untraced kernel's device time (the stamps' cost), checks that the
traced kernel's outputs equal the untraced one's bit for bit, and prints
one JSON object last. The shapes (bf16, the rule's CTA mode unless forced):
serve-seamless's cross prefill (64 CTAs of 64 rows), a 64-row chunk against
a 16384-token paged prefix (forced to 64 rows and one split: 8 CTAs, the
producer's pace alone), granite-3-2b's train layer (128 rows), bert-large's
layer (128 rows, 8-tile walks) and olmo-1b's layer at d 128.

The stamps are inserted at anchors of the kernel's text; each must be
found exactly once, so a change to the kernel that moves one stops this
script with the anchor it missed. Imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]

MAX_CTAS = 4096          # CTAs the trace buffer holds (the shapes stay below)
SLOTS = 16               # counters a role of a CTA writes
CONSUMER = ("wait_full", "issue", "wait_S", "softmax", "wait_PV",
            "rescale_toA", "epilogue", "prologue", "tiles", "loop_other")
PRODUCER = ("wait_empty", "issue", None, None, None, None, None, "prologue",
            "tiles", None)
PER_CTA = ("prologue", "epilogue")

HEADER = f"""
__device__ unsigned int g_trace[{MAX_CTAS} * 3 * {SLOTS}];
#define TR_DECL unsigned int tr_c[10] = {{0,0,0,0,0,0,0,0,0,0}}; \\
  long long tr_t = clock64(); const long long tr_start = tr_t; \\
  tr_c[7] = (unsigned)(tr_t - tr_entry);
#define TR_MARK(k) {{ long long _n = clock64(); tr_c[k] += (unsigned)(_n - tr_t); tr_t = _n; }}
#define TR_FLUSH(role) if ((threadIdx.x & 127) == 0) {{ \\
  unsigned lin = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x; \\
  if (lin < {MAX_CTAS}) {{ unsigned* o = g_trace + (lin * 3 + (role)) * {SLOTS}; \\
    for (int k_ = 0; k_ < 10; ++k_) o[k_] = tr_c[k_]; \\
    o[10] = (unsigned)(clock64() - tr_start); }} }}
"""

READOUT = f"""
int flash_fwd_sm90_trace(unsigned* host, int clear) {{
  const size_t n = sizeof(unsigned) * {MAX_CTAS} * 3 * {SLOTS};
  cudaError_t e = cudaMemcpyFromSymbol(host, g_trace, n);
  if (e == cudaSuccess && clear) {{
    void* ptr = nullptr;
    e = cudaGetSymbolAddress(&ptr, g_trace);
    if (e == cudaSuccess) e = cudaMemset(ptr, 0, n);
  }}
  return (int)e;
}}

"""

# (anchor, replacement) in the kernel's text, in order
EDITS = (
    ('#include "sm90_common.cuh"\n', '#include "sm90_common.cuh"\n' + HEADER),
    ("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"
     "  const int wg = warp >> 2;\n",
     "  const long long tr_entry = clock64();\n"
     "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"
     "  const int wg = warp >> 2;\n"),
    # consumers
    ("    int pending = -1;      // the stage of the P V still to be issued",
     "    TR_DECL\n"
     "    int pending = -1;      // the stage of the P V still to be issued"),
    ("      mbar_wait_bounded(&full[s], (j / STAGES) & 1);\n"
     "      const int kt = (int)widx[i];",
     "      TR_MARK(9)\n"
     "      mbar_wait_bounded(&full[s], (j / STAGES) & 1);\n"
     "      TR_MARK(0)\n"
     "      const int kt = (int)widx[i];"),
    ("      if constexpr (Dropout && overlap_keep) hash_keep();\n"
     "      wg_wait<1>();                                 // S landed; P V may still run\n"
     "      pin<32>(sc);",
     "      TR_MARK(1)\n"
     "      if constexpr (Dropout && overlap_keep) hash_keep();\n"
     "      wg_wait<1>();                                 // S landed; P V may still run\n"
     "      pin<32>(sc);\n"
     "      TR_MARK(2)"),
    ("      wg_wait<0>();                                 // the last tile's P V landed\n"
     "      pin<NA>(acc);\n"
     "      if (pending >= 0) mbar_arrive(&empty[pending]);\n"
     "      if constexpr (Dropout && !overlap_keep) hash_keep();",
     "      TR_MARK(3)\n"
     "      wg_wait<0>();                                 // the last tile's P V landed\n"
     "      pin<NA>(acc);\n"
     "      if (pending >= 0) mbar_arrive(&empty[pending]);\n"
     "      TR_MARK(4)\n"
     "      if constexpr (Dropout && !overlap_keep) hash_keep();"),
    ("      pending = s;\n"
     "      pv_tile = smem_addr(sm + S::v0 + s * S::TILE);\n"
     "    }",
     "      pending = s;\n"
     "      pv_tile = smem_addr(sm + S::v0 + s * S::TILE);\n"
     "      TR_MARK(5)\n"
     "      tr_c[8] += 1;\n"
     "    }\n"
     "    TR_MARK(9)"),
    ("    if (!two && wg == 1) return;\n",
     "    TR_MARK(6)\n"
     "    TR_FLUSH(wg)\n"
     "    if (!two && wg == 1) return;\n"),
    # the producer
    ("    for (int j = 0; j < mine; ++j) {\n"
     "      const int s = j % STAGES;\n"
     "      if (j >= STAGES) mbar_wait_bounded(&empty[s], ((j / STAGES) & 1) ^ 1);",
     "    TR_DECL\n"
     "    for (int j = 0; j < mine; ++j) {\n"
     "      const int s = j % STAGES;\n"
     "      TR_MARK(1)\n"
     "      if (j >= STAGES) mbar_wait_bounded(&empty[s], ((j / STAGES) & 1) ^ 1);\n"
     "      TR_MARK(0)"),
    ("        if (lane < 2 * S::NB) tma_box(dst, map, &full[s], nb * BOX, t * BOX, bb * p.hkv + kvh);\n"
     "      }\n"
     "    }\n"
     "  };",
     "        if (lane < 2 * S::NB) tma_box(dst, map, &full[s], nb * BOX, t * BOX, bb * p.hkv + kvh);\n"
     "      }\n"
     "      tr_c[8] += 1;\n"
     "    }\n"
     "    TR_MARK(1)\n"
     "    TR_FLUSH(2)\n"
     "  };"),
    ("const char* flash_fwd_sm90_error_string(int err) {",
     READOUT + "const char* flash_fwd_sm90_error_string(int err) {"),
)


def traced_source(src: str) -> str:
    for old, new in EDITS:
        if src.count(old) != 1:
            raise SystemExit(f"sm90_fwd_trace: anchor found {src.count(old)} "
                             f"times in flash_fwd_sm90.cu: {old[:70]!r}")
        src = src.replace(old, new)
    return src


def summarize(a) -> dict:
    """Per role: tiles a CTA, cycles per tile of each phase, cycles per CTA
    of the per-CTA phases and of the whole role."""
    used = a[:, 2, 10] > 0                # every CTA's producer flushes
    n = int(used.sum())
    out = {"ctas": n}
    for role, names in ((0, CONSUMER), (1, CONSUMER), (2, PRODUCER)):
        x = a[used, role]
        tiles = float(x[:, 8].sum())
        if tiles == 0:
            continue
        rec = {"tiles_per_cta": tiles / n,
               "cycles_per_cta": float(x[:, 10].mean())}
        for k, name in enumerate(names):
            if name is None or name == "tiles":
                continue
            if name in PER_CTA:
                rec[f"{name}_per_cta"] = float(x[:, k].mean())
            else:
                rec[name] = float(x[:, k].sum()) / tiles
        out[f"role{role}"] = rec
    return out


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    import sm90_fwd_probe as probe
    from repro_torch.core import masks as M
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("sm90_fwd_trace: no CUDA card", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    out_dir = ROOT / "build" / "sm90_fwd_trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "flash_fwd_sm90_trace.cu"
    cu.write_text(traced_source((build.CSRC / "flash_fwd_sm90.cu").read_text()))
    so = out_dir / "libflash_fwd_sm90_trace.so"
    proc = subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                             str(build.CSRC), "-o", str(so), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    untraced = fa._fwd_sm90_lib()       # built beside the traced copy
    log, _ = proc.communicate()
    if proc.returncode != 0:
        print(f"sm90_fwd_trace: nvcc failed:\n{log[-3000:]}", file=sys.stderr)
        return 1
    traced = ctypes.CDLL(str(so))
    traced.flash_fwd_sm90_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    traced.flash_fwd_sm90_trace.restype = ctypes.c_int
    buf = (ctypes.c_uint * (MAX_CTAS * 3 * SLOTS))()
    rows_rule, splits_rule = fa.sm90_fwd_rows, fa.sm90_fwd_splits
    real_load = build.load

    def use(lib):
        build.load = (lambda name: lib if name == "flash_fwd_sm90"
                      else real_load(name))

    cases = {
        "seamless_cross": (lambda g: probe.contiguous_case(
            torch, M, g, 4, 16, 16, 64, 1024, 64, False), None),
        "chunk_against_16k_prefix": (lambda g: probe.paged_case(
            torch, M, g, 8, 2, 64, [16384], [64]), (64, 1)),
        "train": (lambda g: probe.contiguous_case(
            torch, M, g, 4, 32, 8, 2048, 2048, 64, True), None),
        "bert": (lambda g: probe.contiguous_case(
            torch, M, g, 56, 16, 16, 512, 512, 64, False), None),
        "olmo_d128": (lambda g: probe.contiguous_case(
            torch, M, g, 4, 16, 16, 2048, 2048, 128, True), None),
    }
    result = {}
    try:
        for name, (make, force) in cases.items():
            gen = torch.Generator(device="cuda").manual_seed(len(name))
            inputs, call, _ = make(gen)
            fwd = (fa.flash_prefill_paged_forward if "chunk" in name
                   else fa.flash_attention_forward)
            if force:
                fa.sm90_fwd_rows = lambda *a, **k: force[0]
                fa.sm90_fwd_splits = lambda *a, **k: force[1]
            use(untraced)
            want = fwd(*inputs, **call)
            ms = cs.device_ms(torch, [lambda: fwd(*inputs, **call)])
            use(traced)
            fa._fwd_sm90_lib()                  # types the traced entry
            got = fwd(*inputs, **call)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                print(f"sm90_fwd_trace: {name}: the traced kernel's outputs "
                      f"differ from the kernel's", file=sys.stderr)
                return 1
            traced_ms = cs.device_ms(torch, [lambda: fwd(*inputs, **call)])
            traced.flash_fwd_sm90_trace(ctypes.addressof(buf), 1)
            fwd(*inputs, **call)
            torch.cuda.synchronize()
            err = traced.flash_fwd_sm90_trace(ctypes.addressof(buf), 0)
            if err:
                print(f"sm90_fwd_trace: readout failed ({err})",
                      file=sys.stderr)
                return 1
            a = np.frombuffer(buf, dtype=np.uint32).reshape(
                MAX_CTAS, 3, SLOTS).astype(np.float64)
            rec = summarize(a)
            rec.update(shape=list(inputs[0].shape), ms=ms, traced_ms=traced_ms,
                       mode=list(force) if force else "rule")
            result[name] = rec
            lines = [f"[trace] {name} {rec['shape']}: {rec['ctas']} CTAs, "
                     f"{ms:.4f} ms ({traced_ms:.4f} traced)"]
            for role in ("role0", "role1", "role2"):
                if role in rec:
                    lines.append(f"  {role}: " + ", ".join(
                        f"{k} {v:.0f}" if k != "tiles_per_cta" else
                        f"{k} {v:.2f}" for k, v in rec[role].items()))
            print("\n".join(lines), flush=True)
            fa.sm90_fwd_rows, fa.sm90_fwd_splits = rows_rule, splits_rule
            del inputs, want, got
            torch.cuda.empty_cache()
    finally:
        build.load = real_load
        fa.sm90_fwd_rows, fa.sm90_fwd_splits = rows_rule, splits_rule
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"[trace] SM clock now, max: {clocks}", flush=True)
    print(json.dumps({"card": card, "sm_clocks": clocks, "shapes": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
