"""End-to-end training example of the PyTorch/CUDA port: a GPT-2-small-class
LM trained on the synthetic pipeline, with checkpointing and resume.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300     # card
    PYTHONPATH=src python examples/torch_train_lm.py --steps 300 --resume
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20

By default a CPU-sized model (--preset cpu, ~6M params); --preset
gpt2-small runs the real 124M config (the same code path: the paper's
Table 2 recipe, AdamW with warmup and cosine decay, clip 1.0). On the card
``--attn-impl pallas`` (the default there) runs the hand-written CUDA
forward and backward kernels. ``--device`` defaults to ``cuda`` and raises
without a card."""

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train import Trainer, TrainerConfig, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--preset", choices=["cpu", "gpt2-small"], default="cpu")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--attn-impl", default=None,
                    choices=["chunked", "reference", "pallas"],
                    help="default: pallas on the card, chunked on the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("gpt2-small")
    if args.preset == "cpu":
        cfg = dataclasses.replace(cfg, num_layers=4, d_model=256,
                                  num_heads=4, num_kv_heads=4, d_ff=1024,
                                  vocab_size=8192, dtype="float32",
                                  remat=False)
    impl = args.attn_impl or ("pallas" if dev.type == "cuda" else "chunked")
    cfg = dataclasses.replace(cfg, attn_impl=impl)

    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"model: {cfg.name} ({n_params / 1e6:.1f}M params), "
          f"attn={cfg.attn_impl}, seq={args.seq}, batch={args.batch}, "
          f"device={dev}")

    opt = adamw(warmup_cosine(6e-4, 20, args.steps))   # paper App. E.2 recipe
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=0)
    step = make_train_step(model, opt, deterministic=True)

    trainer = Trainer(
        TrainerConfig(total_steps=args.steps, ckpt_every=100,
                      ckpt_dir=args.ckpt_dir),
        step, params, opt.init(params), data.batch_at)
    if args.resume and trainer.try_resume():
        print(f"resumed from step {trainer.step}")

    hist = trainer.run()
    for rec in hist[:: max(1, len(hist) // 10)]:
        print(f"step {rec['step']:>5}  loss {rec['loss']:.4f}  "
              f"({rec['step_time_s'] * 1e3:.0f} ms/step)")
    if hist:
        print(f"final loss {hist[-1]['loss']:.4f} "
              f"(start {hist[0]['loss']:.4f})")
    return hist


if __name__ == "__main__":
    main()
