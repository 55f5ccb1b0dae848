"""Training launcher of the port: the fault-tolerant trainer on one card,
or sharded over ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --steps 100 --seq 2048 --batch 4 --device cuda
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
        --steps 20 --seq 64 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
        --data 2 --model 2 --steps 3 --seq 64 --batch 4

The flags follow the JAX launcher's (``repro.launch.train``; default arch
``olmo-1b``, any arch of ``repro_torch.configs``: dense, MoE (printing
their cross-entropy and load-balancing loss apart), ``mamba2-2.7b`` and
``hymba-1.5b``; ``seamless-m4t-medium`` is refused, as its model reads
audio frames that ``SyntheticLM`` does not make), with one difference:
without ``--reduced`` the PUBLISHED config is built at full width and
depth (random weights from ``--seed``). ``--data`` / ``--model`` above 1
train sharded (``train.steps.make_sharded_train_step``: the batch rows
over "data", heads, FFN, vocab, the MoE's experts and the SSM's head
groups over "model" through ``auto_rules``, ZeRO-1; every arch the
launcher takes, the MoE, SSM and hybrid ones included): the launcher spawns ``data * model`` ranks
(``distributed.launch.spawn``), each building the same weights from
``--seed``, keeping its pieces and stepping on the same batches over one
``("data", "model")`` mesh; rank 0 prints; checkpoints hold full arrays
(a resume may take another mesh). ``--backend gloo`` (the default) runs
the ranks on ``--device``, several on one card if need be, collectives
staged through host memory; ``--backend nccl`` puts rank r on ``cuda:r``,
a card a rank: ``--data 16 --model 16 --backend nccl`` on 256 cards is
the reference's ``--full`` mesh (``launch.mesh.make_production_mesh``).
``--device`` defaults to ``cuda`` and raises without a card. The launcher
sets ``attn_impl="pallas"``, so on ``cuda`` the attention forward and
backward run through the hand-written kernels (their plain versions on
``cpu``). AdamW with ``warmup_cosine(lr, 20, steps)``, clip 1.0,
deterministic; SIGTERM asks for a checkpoint at the next step while
``main`` trains (the previous handler is restored when it returns).
``--autotune`` / ``--sram-budget`` set the tuner's knobs
(``kernels.tuning.configure_tuning``) in every rank.
"""

from __future__ import annotations

import argparse
import dataclasses
import signal

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.tree import tree_leaves
from repro_torch.data import SyntheticLM
from repro_torch.distributed import launch
from repro_torch.distributed.meshes import make_mesh
from repro_torch.distributed.sharding import P, auto_rules, shard_tree
from repro_torch.kernels import tuning
from repro_torch.kernels.build import REPO_ROOT
from repro_torch.models import build_model, require_token_inputs
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train import Trainer, TrainerConfig, make_train_step
from repro_torch.train.steps import init_opt_state, make_sharded_train_step

BATCH_SPECS = {k: P("data", None)
               for k in ("tokens", "loss_mask", "segment_ids")}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--autotune", action="store_true",
                    help="empirically time attention tile candidates on "
                         "this device (persisted in the autotune cache)")
    ap.add_argument("--sram-budget", type=int, default=None,
                    help="tuner SRAM budget in bytes for the analytic "
                         "tile chooser")
    ap.add_argument("--reduced", action="store_true",
                    help="the tiny family-faithful config instead of the "
                         "published one")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: kernels) or cpu (plain versions)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the data")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=str(REPO_ROOT / "build" / "train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel ranks (the batch rows, ZeRO-1)")
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel ranks (heads, FFN, vocab, "
                         "experts, SSM head groups)")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="gloo: ranks on --device (may share a card); "
                         "nccl: rank r on cuda:r")
    return ap


def main(argv=None):
    """Parse ``argv``, train, print a summary. Returns the Trainer (its
    ``history``, ``params`` and ``step_fn``); with ``--data`` / ``--model``
    above 1, every rank's ``{"history", "slow_steps"}``, by rank."""
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    if args.data * args.model > 1:
        return launch.spawn(args.data * args.model, _rank, args,
                            backend=args.backend)
    return run(args)


def _rank(args) -> dict:
    """One rank of a sharded launch."""
    mesh = make_mesh((args.data, args.model), ("data", "model"),
                     backend=args.backend, device=args.device)
    trainer = run(args, mesh)
    return {"history": trainer.history, "slow_steps": trainer.slow_steps}


def run(args, mesh=None) -> Trainer:
    """Build the model from ``--seed`` and train it (over ``mesh``, this
    rank's part); print on rank 0; return the Trainer."""
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    tuning.configure_tuning(sram_budget=args.sram_budget,
                            autotune=args.autotune or None)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    cfg = dataclasses.replace(cfg, attn_impl="pallas")
    require_token_inputs(cfg, "the train launcher (SyntheticLM tokens)")
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(gen, device=dev)
    n = sum(p.numel() for p in tree_leaves(params))
    opt = adamw(warmup_cosine(args.lr, 20, args.steps))
    shardings = {}
    if mesh is None:
        opt_state = opt.init(params)
        step = make_train_step(model, opt, grad_accum=args.grad_accum,
                               deterministic=True)
    else:
        rules = auto_rules(cfg, mesh, global_batch=args.batch)
        step, sh = make_sharded_train_step(
            model, opt, mesh, rules=rules, zero1=True,
            grad_accum=args.grad_accum, deterministic=True,
            batch_specs=BATCH_SPECS)
        params = shard_tree(params, sh["params"])
        opt_state = init_opt_state(opt, params, sh)
        shardings = dict(param_shardings=sh["params"],
                         opt_shardings=sh["opt"])
    where = (f"device={dev}" if mesh is None else
             f"mesh=data {args.data} x model {args.model} "
             f"backend={args.backend} device={dev}")
    say(f"arch={cfg.name} layers={cfg.num_layers} params={n / 1e6:.1f}M "
        f"seq={args.seq} batch={args.batch} accum={args.grad_accum} {where}",
        flush=True)

    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    trainer = Trainer(
        TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, async_ckpt=True),
        step, params, opt_state, data.batch_at, **shardings)
    del params, opt_state
    previous = signal.signal(signal.SIGTERM,
                             lambda *_: trainer.request_checkpoint())
    try:
        if args.resume and trainer.try_resume():
            say(f"resumed from step {trainer.step}", flush=True)
        hist = trainer.run()
    finally:
        # the handler holds the trainer (params and fp32 moments): put the
        # previous one back so that a caller running several launches in
        # one process frees each run's memory with its Trainer
        signal.signal(signal.SIGTERM, previous)
    for rec in hist[:: max(1, len(hist) // 10)]:
        moe = (f"  ce {rec['ce']:.4f}  aux {rec['aux']:.4f}"
               if cfg.family == "moe" else "")
        say(f"step {rec['step']:>5}  loss {rec['loss']:.4f}{moe}  grad_norm "
            f"{rec['grad_norm']:.3f}  {rec['step_time_s'] * 1e3:.0f} ms/step",
            flush=True)
    if trainer.slow_steps:
        say(f"straggler-flagged steps: {trainer.slow_steps}")
    return trainer


if __name__ == "__main__":
    main()
