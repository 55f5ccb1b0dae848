"""Training launcher of the port: the fault-tolerant trainer on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --steps 100 --seq 2048 --batch 4 --device cuda
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
        --steps 20 --seq 64 --batch 4

The flags follow the JAX launcher's (``repro.launch.train``; default arch
``olmo-1b``, any arch of ``repro_torch.configs``), with one difference:
without ``--reduced`` the PUBLISHED config is built at full width and
depth (random weights from ``--seed``) on one device; the production-mesh
path (``--full`` on a TPU slice: TP/DP/EP + ZeRO-1) is not ported.
``--device`` defaults to ``cuda`` and raises without a card. The launcher
sets ``attn_impl="pallas"``, so on ``cuda`` the attention forward and
backward run through the hand-written kernels (their plain versions on
``cpu``). AdamW with ``warmup_cosine(lr, 20, steps)``, clip 1.0,
deterministic; SIGTERM asks for a checkpoint at the next step while
``main`` trains (the previous handler is restored when it returns).
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
from repro_torch.kernels.build import REPO_ROOT
from repro_torch.models import build_model
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train import Trainer, TrainerConfig, make_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmo-1b")
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
    return ap


def main(argv=None) -> Trainer:
    """Parse ``argv``, train, print a summary; returns the Trainer (its
    ``history``, ``params`` and ``step_fn``)."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    cfg = dataclasses.replace(cfg, attn_impl="pallas")
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(gen, device=dev)
    opt = adamw(warmup_cosine(args.lr, 20, args.steps))
    opt_state = opt.init(params)
    step = make_train_step(model, opt, grad_accum=args.grad_accum,
                           deterministic=True)
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.name} layers={cfg.num_layers} params={n / 1e6:.1f}M "
          f"seq={args.seq} batch={args.batch} accum={args.grad_accum} "
          f"device={dev}", flush=True)

    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    trainer = Trainer(
        TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, async_ckpt=True),
        step, params, opt_state, data.batch_at)
    previous = signal.signal(signal.SIGTERM,
                             lambda *_: trainer.request_checkpoint())
    try:
        if args.resume and trainer.try_resume():
            print(f"resumed from step {trainer.step}", flush=True)
        hist = trainer.run()
    finally:
        # the handler holds the trainer (params and fp32 moments): put the
        # previous one back so that a caller running several launches in
        # one process frees each run's memory with its Trainer
        signal.signal(signal.SIGTERM, previous)
    for rec in hist[:: max(1, len(hist) // 10)]:
        print(f"step {rec['step']:>5}  loss {rec['loss']:.4f}  grad_norm "
              f"{rec['grad_norm']:.3f}  {rec['step_time_s'] * 1e3:.0f} ms/step",
              flush=True)
    if trainer.slow_steps:
        print(f"straggler-flagged steps: {trainer.slow_steps}")
    return trainer


if __name__ == "__main__":
    main()
