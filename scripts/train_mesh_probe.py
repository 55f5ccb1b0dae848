"""Where a sharded train step's time goes, on the card: chip_smoke's
train-dp2tp2 (granite-3-2b at full width, 8 of 40 layers, bf16, seq 2048
x batch 4, data 2 x model 2, ZeRO-1, the train launcher's recipe and
batches) as four gloo ranks sharing the card, with every collective of
``repro_torch.distributed.comm`` timed (the card synchronised before and
after each, so a collective's time includes the host staging and the
wait for the slowest rank) and the bytes each moves counted.

    python3 scripts/train_mesh_probe.py [--steps 4] [--layers 8]

Prints, for rank 0, each step's wall time, the time and bytes of its
collectives by kind, and the rest of the step (the forward, backward and
update on the card, and the host work between launches).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _timed(torch, dist, comm, table):
    """Wrap comm's three transports so that each call adds its seconds and
    payload bytes to ``table[kind]``."""
    def wrap(fn, kind_of):
        def run(x, group, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x, group, *args, **kw)
            torch.cuda.synchronize()
            rec = table[kind_of(args, kw)]
            rec["s"] += time.perf_counter() - t0
            rec["bytes"] += x.numel() * x.element_size()
            rec["calls"] += 1
            return out
        return run

    comm._reduce = wrap(comm._reduce, lambda a, kw: (
        "all_reduce_max" if a[0] == dist.ReduceOp.MAX else "all_reduce"))
    comm.all_gather = wrap(comm.all_gather, lambda a, kw: "all_gather")
    comm.reduce_scatter = wrap(comm.reduce_scatter,
                               lambda a, kw: "reduce_scatter")


def probe_rank(args) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import comm
    from repro_torch.distributed.meshes import make_mesh
    from repro_torch.distributed.sharding import P, auto_rules, shard_tree
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train.steps import init_opt_state, make_sharded_train_step

    table = collections.defaultdict(
        lambda: {"s": 0.0, "bytes": 0, "calls": 0})
    _timed(torch, dist, comm, table)
    mesh = make_mesh((2, 2), ("data", "model"), device="cuda")
    cfg = dataclasses.replace(get_config("granite-3-2b"),
                              num_layers=args.layers, attn_impl="pallas")
    model = build_model(cfg)
    opt = adamw(warmup_cosine(3e-4, 20, args.steps))
    step, sh = make_sharded_train_step(
        model, opt, mesh, rules=auto_rules(cfg, mesh, global_batch=4),
        deterministic=True,
        batch_specs={k: P("data", None)
                     for k in ("tokens", "loss_mask", "segment_ids")})
    full = model.init(torch.Generator(device=mesh.device).manual_seed(0),
                      device=mesh.device)
    params = shard_tree(full, sh["params"])
    del full
    state = init_opt_state(opt, params, sh)
    data = SyntheticLM(cfg.vocab_size, 2048, 4, seed=0)
    steps = []
    for i in range(args.steps):
        table.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, data.batch_at(i))
        loss = float(m["loss"])
        wall = time.perf_counter() - t0
        steps.append({"wall_s": wall, "loss": loss,
                      "collectives": {k: dict(v) for k, v in table.items()},
                      "rest_s": wall - sum(v["s"] for v in table.values())})
    return {"rank": mesh.rank, "steps": steps}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--layers", type=int, default=8)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_mesh_probe: no CUDA device", file=sys.stderr)
        return 3
    from repro_torch.distributed import launch
    from repro_torch.kernels import build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    build.build_all()
    out = launch.spawn(4, probe_rank, args, threads=2)
    for s, rec in enumerate(out[0]["steps"]):
        parts = ", ".join(
            f"{k} {v['calls']} calls {v['bytes'] / 2**20:.0f} MiB "
            f"{v['s'] * 1e3:.0f} ms" for k, v in
            sorted(rec["collectives"].items()))
        print(f"[train-mesh-probe] rank 0 step {s + 1}: {rec['wall_s'] * 1e3:.0f}"
              f" ms (loss {rec['loss']:.4f}): {parts}; the rest "
              f"{rec['rest_s'] * 1e3:.0f} ms [{card}; ranks sharing one card, "
              f"collectives through host memory]", flush=True)
    print(json.dumps({"card": card, "rank0": out[0]["steps"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
