"""Batched serving in the PyTorch/CUDA port: continuous batching over a
PAGED KV cache.

    PYTHONPATH=src python examples/torch_serve_batched.py [--dense]
        [--page-size 16] [--pages 16] [--chunk-size 16 [--token-budget 32]]
        [--shared-prefix 32] [--no-prefix-cache] [--device cpu]

Submits a burst of mixed-length requests (in chunked mode also one LONG
prompt) against a page pool holding, at the default flags, the cache
budget of only 4 dense slots; the engine admits by free-page budget (more
concurrent requests than slots), appends and reclaims pages as requests
grow and finish, and prints per-step batch occupancy and pool utilization.
``--chunk-size`` prefills the long prompt a chunk a step while the short
requests keep decoding (``prefill Nt+decode Mt``). The outputs are checked
token-exact against per-request full-context greedy decoding in every
mode, and ``ok`` printed. On the card the prefill and decode run through
the hand-written kernels (``attn_impl="pallas"``, ``use_decode_kernel``);
on the CPU through their plain versions. ``--device`` defaults to
``cuda`` and raises without a card. Tensor-parallel serving spawns ranks:
``python -m repro_torch.launch.serve --tp 2``."""

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import reduced_config
from repro_torch.models import build_model
from repro_torch.serve import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=16)
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="prefill chunk length (paged mode; adds the "
                         "long-prompt request)")
    ap.add_argument("--token-budget", type=int, default=None)
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=None,
                    help="copy-on-write page sharing across requests "
                         "(default: on in paged mode)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many identical tokens to every "
                         "prompt: later requests hit the prefix cache")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write a Chrome trace-event JSON of the serve")
    ap.add_argument("--metrics", action="store_true",
                    help="print the metrics registry and the IO ledger")
    args = ap.parse_args(argv)
    if args.dense and (args.chunk_size or args.prefix_cache):
        ap.error("--chunk-size and --prefix-cache need the paged engine "
                 "(drop --dense)")
    dev = resolve_device(args.device)

    cfg = reduced_config("granite-3-2b", num_layers=4, d_model=128,
                         num_heads=4, num_kv_heads=2, head_dim=32,
                         d_ff=256, vocab_size=512, attn_impl="pallas",
                         use_decode_kernel=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    rng = np.random.default_rng(0)

    n = args.requests
    shared = [int(t) for t in rng.integers(1, cfg.vocab_size,
                                           size=args.shared_prefix)]
    prompts = [shared + [int(t) for t in rng.integers(
        1, cfg.vocab_size, size=rng.integers(3, 12))] for _ in range(n)]
    new_tokens = [int(rng.integers(4, 12)) for _ in range(n)]
    if args.chunk_size:
        prompts.insert(0, shared + [int(t) for t in rng.integers(
            1, cfg.vocab_size, size=40)])
        new_tokens.insert(0, 4)

    dense_slots, capacity = 4, 64
    if args.dense:
        eng = ServingEngine(model, params, num_slots=dense_slots,
                            capacity=capacity, paged=False,
                            trace=bool(args.trace), device=dev)
        print(f"dense: {dense_slots} slots x {capacity} capacity")
    else:
        # short requests hold only the pages they fill, so the decode batch
        # can be wider than the dense slots the same cache cells would buy
        cells = args.pages * args.page_size
        lanes = max(dense_slots, 2 * cells // capacity)
        eng = ServingEngine(model, params, num_slots=lanes,
                            capacity=capacity, paged=True,
                            page_size=args.page_size, num_pages=args.pages,
                            chunk_size=args.chunk_size,
                            token_budget=args.token_budget,
                            prefix_cache=args.prefix_cache,
                            trace=bool(args.trace), device=dev)
        chunked = (f", chunked prefill {args.chunk_size}t/step"
                   if args.chunk_size else "")
        print(f"paged: {args.pages} pages x {args.page_size} rows "
              f"({cells} cells = {cells / (dense_slots * capacity):.2g}x "
              f"the dense {dense_slots}x{capacity} budget), {lanes} decode "
              f"lanes ({eng.cache_bytes() / 1e6:.2f} MB pool){chunked}")

    t0 = time.perf_counter()
    burst = list(zip(prompts, new_tokens))
    if args.shared_prefix and eng.paged and eng.prefix_cache:
        # prime: drain the first request alone so that its prefix pages
        # are published before the burst, and every later request hits
        p, k = burst.pop(0)
        eng.submit(p, max_new_tokens=k)
        eng.run()
    for p, k in burst:
        eng.submit(p, max_new_tokens=k)
    done = eng.run(on_step=ServingEngine.step_stats_printer())
    dt = time.perf_counter() - t0
    total = sum(len(r.output) for r in done)
    extra = (f", peak {eng.peak_active} concurrent, {eng.preemptions} "
             f"preemptions" if eng.paged else "")
    print(f"{len(done)} requests: {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s on {dev.type}{extra})")
    if eng.paged and eng.prefix_cache:
        print(f"prefix cache: hit-rate {eng.prefix_cache_hit_rate:.0%} "
              f"({eng.prefix_hits}/{eng.prefix_lookups} admissions)")

    def greedy(prompt, k):
        toks = list(prompt)
        with torch.no_grad():
            for _ in range(k):
                logits, _ = model.forward(
                    params, {"tokens": np.asarray([toks], np.int32)})
                toks.append(int(logits[0, -1].argmax()))
        return toks[len(prompt):]

    ok = all(r.output == greedy(prompts[r.rid], len(r.output)) for r in done)
    print(f"token-exact vs sequential greedy: {ok}")
    if args.trace:
        print(f"trace: {eng.tm.tracer.to_chrome_trace(args.trace)} events "
              f"-> {args.trace}")
    if args.metrics:
        print("\n-- metrics registry --")
        print(eng.tm.registry.table())
        print("\n-- IO ledger --")
        print(eng.tm.ledger.table())
    if not ok:
        raise SystemExit("token mismatch against per-request greedy")
    print("ok")


if __name__ == "__main__":
    main()
