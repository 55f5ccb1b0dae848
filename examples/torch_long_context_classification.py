"""Long-document classification lift from longer context (paper Table 5),
in the PyTorch/CUDA port.

MIMIC-III and ECtHR are gated datasets; this harness reproduces the
experiment's structure on a synthetic long-document task whose label
depends on evidence placed deep in the document (beyond position 384), so
a model truncated to a short context cannot solve it and accuracy rises
with the trainable sequence length: the paper's Table-5 mechanism.

    PYTHONPATH=src python examples/torch_long_context_classification.py
    PYTHONPATH=src python examples/torch_long_context_classification.py \\
        --device cpu --steps 20 --seqs 128,512

``--device`` defaults to ``cuda`` and raises without a card."""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves, with_leaves
from repro_torch.models import build_model

VOCAB = 64
EVIDENCE = 7          # the token that flips the label
DOC_LEN = 512


def make_docs(rng, batch):
    """Label 1 iff the EVIDENCE token occurs in the last quarter."""
    toks = rng.integers(8, VOCAB, size=(batch, DOC_LEN))
    y = rng.integers(0, 2, size=(batch,))
    lo = 3 * DOC_LEN // 4
    for i in range(batch):
        if y[i]:
            toks[i, rng.integers(lo, DOC_LEN, size=8)] = EVIDENCE
    return toks, y


def train_eval(seq_len: int, dev, steps: int = 80, n_eval: int = 128,
               seed: int = 0) -> float:
    cfg = dataclasses.replace(
        get_config("bert-large"), num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=VOCAB, dtype="float32",
        remat=False, causal=False, attn_impl="chunked")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    rng = np.random.default_rng(seed)

    def class_logits(p, toks):
        logits, _ = model.forward(p, {"tokens": toks})
        return logits.amax(dim=1)[:, :2]     # detection: max-pool readout

    for _ in range(steps):
        toks, y = make_docs(rng, 8)
        out = torch.log_softmax(class_logits(with_leaves(params, leaves),
                                             toks[:, :seq_len]), dim=-1)
        loss = -out[torch.arange(len(y)), torch.as_tensor(y, device=dev)
                    ].mean()
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p -= 5e-3 * g
    toks, y = make_docs(rng, n_eval)
    with torch.no_grad():
        pred = class_logits(params, toks[:, :seq_len]).argmax(dim=-1)
    return float((pred.cpu().numpy() == y).mean())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--eval", type=int, default=128)
    ap.add_argument("--seqs", default="128,256,512")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"evidence lives in positions [{3 * DOC_LEN // 4}, {DOC_LEN}): "
          f"short contexts cannot see it\n")
    print(f"{'trainable seq len':>18} {'accuracy':>9}")
    out = {}
    for seq in [int(s) for s in args.seqs.split(",")]:
        out[seq] = acc = train_eval(seq, dev, args.steps, args.eval)
        note = " (cannot see evidence)" if seq <= 3 * DOC_LEN // 4 else ""
        print(f"{seq:>18} {acc:>9.3f}{note}")
    print("\nPaper Table 5: MIMIC-III 52.8 -> 57.1 F1 and ECtHR 72.2 -> 80.7 "
          "from 512 -> 8k+ context; the same mechanism: linear-memory "
          "attention makes the longer context trainable at all.")
    return out


if __name__ == "__main__":
    main()
