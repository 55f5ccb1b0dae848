"""Serving launcher of the port: the continuous-batching scheduler over the
paged KV cache (or, with ``--dense``, the fixed-slot cache), on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --dense --reduced \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --slots 4 --requests 8 --capacity 1088 --chunk-size 256 \\
        --long-prompt 1024 --shared-prefix 64 --max-new 32

The flags are the JAX launcher's (``repro.launch.serve``) plus
``--device`` (default ``cuda``; without a card it raises) and
``--reduced``. Without ``--reduced`` the PUBLISHED config is built at full
width and depth with random weights from ``--seed``. On ``cuda`` the
launcher sets ``attn_impl="pallas"`` and ``use_decode_kernel=True``, so
prefill and decode run through the hand-written kernels (in dense mode the
contiguous split-KV decode kernel). Families with recurrent state
(``mamba2-2.7b``, ``hymba-1.5b``) serve in dense slots without
``--dense``, as in the reference (the engine's default for them).
``--tp`` > 1 and ``--sp`` > 1 are not ported yet and raise. An arch whose
model reads frontend embeddings (``seamless-m4t-medium``) is refused: its
requests would carry tokens alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import build_model, require_token_inputs
from repro_torch.serve import ServingEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
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
                    help="tensor-parallel shards (not ported yet)")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel shards (not ported yet)")
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
    return cfg


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.smoke:
        args.reduced = True
        args.slots, args.capacity = 2, 32
        args.page_size, args.pages = 8, 4
        args.chunk_size, args.token_budget = 8, 18
        args.requests, args.max_new = 2, 5
        args.long_prompt, args.shared_prefix = 16, 8
    device = resolve_device(args.device)
    if args.tp > 1 or args.sp > 1:
        raise NotImplementedError("--tp > 1 and --sp > 1 are not ported yet")
    cfg = model_config(args)
    require_token_inputs(cfg, "the serve launcher")
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
                        trace=bool(args.trace), device=device)
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
    print(f"arch={cfg.name} device={device} attn={cfg.attn_impl}"
          f"{chunked} lanes={args.slots} cache={eng.cache_bytes()/1e6:.2f} MB"
          f" mode={layout}")
    done = eng.run(on_step=ServingEngine.step_stats_printer())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    tok = sum(len(r.output) for r in done)
    lat = eng.latency_stats()
    print(f"{len(done)} requests, {tok} tokens in {dt:.2f}s "
          f"({tok/dt:.1f} tok/s, ttft p50 {lat['ttft_p50']*1e3:.1f} ms, "
          f"peak_concurrent={eng.peak_active}, "
          f"preemptions={eng.preemptions})")
    if eng.prefix_cache:
        print(f"prefix cache: hit-rate {eng.prefix_cache_hit_rate:.0%} "
              f"({eng.prefix_hits}/{eng.prefix_lookups} admissions), "
              f"{eng.prefix_pages_shared} pages shared, "
              f"{eng.prefill_tokens_skipped} prefill tokens skipped")
    for r in done[:5]:
        print(f"  req{r.rid}: {len(r.output)} tokens {r.output[:8]}...")
    if args.trace:
        n = eng.tm.tracer.to_chrome_trace(args.trace)
        print(f"trace: {n} events -> {args.trace}")
    if args.metrics:
        print("\n-- metrics registry --")
        print(eng.tm.registry.table())
    return eng


if __name__ == "__main__":
    main()
