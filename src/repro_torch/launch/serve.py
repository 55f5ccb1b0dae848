"""Serving launcher of the port: the continuous-batching scheduler over the
paged KV cache (or, with ``--dense``, the fixed-slot cache), on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --dense --reduced \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --slots 4 --requests 8 --capacity 1088 --chunk-size 256 \\
        --long-prompt 1024 --shared-prefix 64 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke \\
        --device cpu --tp 2 --sp 2

The flags are the JAX launcher's (``repro.launch.serve``) plus
``--device`` (default ``cuda``; without a card it raises) and
``--reduced``. Without ``--reduced`` the PUBLISHED config is built at full
width and depth with random weights from ``--seed``. On ``cuda`` the
launcher sets ``attn_impl="pallas"`` and ``use_decode_kernel=True``, so
prefill and decode run through the hand-written kernels (in dense mode the
contiguous split-KV decode kernel). Families with recurrent state
(``mamba2-2.7b``, ``hymba-1.5b``) serve in dense slots without
``--dense``, as in the reference (the engine's default for them).
An arch whose model reads frontend embeddings (``seamless-m4t-medium``) is
refused: its requests would carry tokens alone.

``--tp`` / ``--sp`` above 1 serve tensor- and sequence-parallel (paged
mode, the dense family; DESIGN.md §13-§14): the launcher spawns ``sp *
tp`` ranks (``distributed.launch.spawn``), each building the same weights
from ``--seed``, keeping its slices and serving the same requests over
one ``ServeMesh``; rank 0 prints. ``--backend gloo`` (the default) runs
the ranks on ``--device``, several on one card if need be, its
collectives staged through host memory; ``--backend nccl`` puts rank r on
``cuda:r`` and needs a card a rank. As in the reference, a ``--reduced``
config whose kv heads do not divide by ``--tp`` (granite's 4 q / 1 kv)
has both head counts scaled, keeping the GQA ratio, and says so.
``--autotune`` / ``--sram-budget`` set the tuner's knobs
(``kernels.tuning.configure_tuning``) in every rank: with ``--autotune``
the attention tiles and the decode geometry are timed on the device at
first use and kept in the autotune cache.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced_config
from repro_torch.distributed import launch
from repro_torch.distributed.meshes import serve_mesh
from repro_torch.kernels import tuning
from repro_torch.models import build_model, require_token_inputs
from repro_torch.serve import ServingEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--autotune", action="store_true",
                    help="empirically time tile candidates on this device "
                         "(persisted in the autotune cache)")
    ap.add_argument("--sram-budget", type=int, default=None,
                    help="tuner SRAM budget in bytes (default: "
                         "io_model.DEFAULT_SRAM_BUDGET)")
    ap.add_argument("--reduced", action="store_true",
                    help="the tiny family-faithful config instead of the "
                         "published one")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: kernels) or cpu (plain versions)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    ap.add_argument("--slots", type=int, default=4, help="decode batch lanes")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--capacity", type=int, default=128,
                    help="per-sequence max cache length")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--dense", action="store_true",
                    help="fixed-slot dense KV cache (atomic packed prefill); "
                         "the default for families that cannot page")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV rows per page (== mask-IR kv block)")
    ap.add_argument("--pages", type=int, default=None,
                    help="page pool size (default: slots*capacity/page_size)")
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="prefill chunk length (default: atomic prefill)")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="max tokens one step may process")
    ap.add_argument("--long-prompt", type=int, default=None,
                    help="also submit one prompt of this many tokens")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=None)
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many identical tokens to every prompt")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks (paged mode): the pool and "
                         "the projections shard by heads, the scheduler "
                         "runs on every rank")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel ranks (paged mode): each owns "
                         "a slab of every prefill chunk's query rows")
    ap.add_argument("--sp-strategy", default=None,
                    choices=("allgather", "ring"),
                    help="the sp K/V movement (default: the io_model's "
                         "cheaper one)")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="the ranks' collectives: gloo (any device, ranks "
                         "may share a card) or nccl (rank r on cuda:r)")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write a Chrome trace-event JSON of the serve here")
    ap.add_argument("--metrics", action="store_true",
                    help="print the metrics-registry table at exit")
    ap.add_argument("--smoke", action="store_true",
                    help="preset pressure workload (tight pool + chunked "
                         "prefill + shared prefix) forcing preemption and "
                         "prefix hits")
    return ap


def model_config(args):
    """The served config: published unless ``--reduced``; on the card the
    attention runs through the hand-written kernels."""
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if torch.device(args.device).type == "cuda":
        cfg = dataclasses.replace(cfg, attn_impl="pallas",
                                  use_decode_kernel=True)
    if args.reduced and args.tp > 1 and cfg.num_kv_heads % args.tp:
        ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
        kv = -(-cfg.num_kv_heads // args.tp) * args.tp
        cfg = dataclasses.replace(cfg, num_kv_heads=kv, num_heads=kv * ratio)
    return cfg


def main(argv=None):
    """Serve as the flags say. Returns the engine; with ``--tp`` / ``--sp``
    above 1, every rank's tokens by rid, by rank."""
    args = build_parser().parse_args(argv)
    if args.smoke:
        args.reduced = True
        args.slots, args.capacity = 2, 32
        args.page_size, args.pages = 8, 4
        args.chunk_size, args.token_budget = 8, 18
        args.requests, args.max_new = 2, 5
        args.long_prompt, args.shared_prefix = 16, 8
    resolve_device(args.device)
    if args.tp > 1 or args.sp > 1:
        return launch.spawn(args.tp * args.sp, _rank, args,
                            backend=args.backend)
    return run(args)


def _rank(args):
    """One rank of a tp/sp serve: its tokens by rid."""
    mesh = serve_mesh(args.sp, args.tp, backend=args.backend,
                      device=args.device)
    eng = run(args, mesh)
    return {r.rid: list(r.output) for r in eng.finished}


def run(args, mesh=None):
    """Build the model from ``--seed``, serve the requests, print (on rank
    0 of a mesh), return the engine."""
    device = mesh.device if mesh is not None else resolve_device(args.device)
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    tuning.configure_tuning(sram_budget=args.sram_budget,
                            autotune=args.autotune or None)
    cfg = model_config(args)
    require_token_inputs(cfg, "the serve launcher")
    base = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if cfg.num_kv_heads != base.num_kv_heads:
        say(f"[tp={args.tp}] scaled the reduced config to {cfg.num_heads}q/"
            f"{cfg.num_kv_heads}kv heads so every rank owns whole kv-head "
            f"groups")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed),
                        device=device)
    eng = ServingEngine(model, params, num_slots=args.slots,
                        capacity=args.capacity,
                        paged=False if args.dense else None,
                        page_size=args.page_size,
                        num_pages=args.pages, chunk_size=args.chunk_size,
                        token_budget=args.token_budget,
                        prefix_cache=args.prefix_cache,
                        tp=args.tp, sp=args.sp, sp_strategy=args.sp_strategy,
                        mesh=mesh, trace=bool(args.trace), device=device)
    del params
    rng = np.random.default_rng(args.seed)
    shared = [int(t) for t in rng.integers(1, cfg.vocab_size,
                                           size=args.shared_prefix)]

    def prompt(n):
        return shared + [int(t) for t in rng.integers(1, cfg.vocab_size,
                                                      size=n)]

    t0 = time.perf_counter()
    if args.long_prompt:
        eng.submit(prompt(args.long_prompt), max_new_tokens=args.max_new,
                   temperature=args.temperature, top_p=args.top_p)
    for _ in range(args.requests):
        eng.submit(prompt(int(rng.integers(3, 16))),
                   max_new_tokens=int(rng.integers(4, args.max_new + 1)),
                   temperature=args.temperature, top_p=args.top_p)
    chunked = f" chunk={args.chunk_size}" if args.chunk_size else ""
    layout = (f"paged pool={eng.kv.num_pages}x{eng.kv.page_size}" if eng.paged
              else f"dense slots={args.slots}x{args.capacity}")
    if mesh is not None:
        layout += (f" tp={eng.tp} sp={eng.sp}"
                   f"{f'({eng.sp_strategy})' if eng.sp > 1 else ''}"
                   f" backend={args.backend}")
    shard_note = (f" ({eng.per_shard_cache_bytes()/1e6:.2f} MB/shard)"
                  if eng.tp > 1 else "")
    say(f"arch={cfg.name} device={device} attn={cfg.attn_impl}"
        f"{chunked} lanes={args.slots} cache={eng.cache_bytes()/1e6:.2f} MB"
        f"{shard_note} mode={layout}")
    done = eng.run(on_step=ServingEngine.step_stats_printer()
                   if mesh is None or mesh.rank == 0 else None)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    tok = sum(len(r.output) for r in done)
    lat = eng.latency_stats()
    say(f"{len(done)} requests, {tok} tokens in {dt:.2f}s "
        f"({tok/dt:.1f} tok/s, ttft p50 {lat['ttft_p50']*1e3:.1f} ms, "
        f"peak_concurrent={eng.peak_active}, "
        f"preemptions={eng.preemptions})")
    if eng.prefix_cache:
        say(f"prefix cache: hit-rate {eng.prefix_cache_hit_rate:.0%} "
            f"({eng.prefix_hits}/{eng.prefix_lookups} admissions), "
            f"{eng.prefix_pages_shared} pages shared, "
            f"{eng.prefill_tokens_skipped} prefill tokens skipped")
    if eng.tp > 1 or eng.sp > 1:
        # every rank counts the censuses together (their collectives are
        # real); rank 0 prints them
        decode_census = eng.decode_collective_census()
        chunk_census = eng.prefill_collective_census("chunk")
    if eng.tp > 1:
        say(f"tp={eng.tp}: per-shard pool utilization "
            f"{eng.kv.utilization():.0%} (identical on every shard: one "
            f"logical pool, head-sliced), "
            f"{eng.per_shard_cache_bytes()/1e6:.2f} MB KV/shard, "
            f"decode census {decode_census}")
    if eng.sp > 1:
        c = eng.sp_prefill_costs
        say(f"sp={eng.sp}: strategy={eng.sp_strategy} "
            f"(io_model chunk bytes: replicated {c['replicated']/1e6:.2f} "
            f"MB, allgather {c['allgather']/1e6:.2f} MB, "
            f"ring {c['ring']/1e6:.2f} MB), "
            f"prefill census {chunk_census}, "
            f"decode census {decode_census}")
    for r in done[:5]:
        say(f"  req{r.rid}: {len(r.output)} tokens {r.output[:8]}...")
    if args.trace:
        n = eng.tm.tracer.to_chrome_trace(args.trace)
        say(f"trace: {n} events -> {args.trace}")
    if args.metrics:
        say("\n-- metrics registry --")
        say(eng.tm.registry.table())
    return eng


if __name__ == "__main__":
    main()
