"""Quickstart of the PyTorch/CUDA port: FlashAttention as a drop-in
exact-attention primitive.

    PYTHONPATH=src python examples/torch_quickstart.py                 # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Shows: (1) the FlashAttention kernel (``kernels.ops.flash_attention``: the
hand-written CUDA kernel on the card, its plain version on the CPU) against
standard attention, exact to fp32 tolerance; (2) long-context attention
with O(N) memory (Algorithm 1, ``kernels.ref.chunked_attention``): the
largest temporary is one (N, chunk) score block, never the N x N matrix;
(3) block-sparse FlashAttention with a butterfly layout (paper §3.3).
``--device`` defaults to ``cuda`` and raises without a card."""

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import masks
from repro_torch.kernels.ops import flash_attention
from repro_torch.kernels.ref import chunked_attention, standard_attention


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=512, help="sequence length")
    ap.add_argument("--long", type=int, default=16_384,
                    help="sequence length of the long-context attention")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, n, d = 2, 8, args.n, 64

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q, k, v = (randn(b, h, n, d) for _ in range(3))

    # 1. exactness: the paper's central claim
    o_flash = flash_attention(q, k, v, causal=True)
    o_std = standard_attention(q, k, v, causal=True)
    err = float((o_flash - o_std).abs().max())
    print(f"[1] flash vs standard: max_abs_err = {err:.2e} (exact)")

    # 2. long context with O(N) memory (Algorithm 1, chunks of 1024 keys)
    n_long, chunk = args.long, min(1024, args.long)
    ql, kl, vl = (randn(1, 2, n_long, d, dtype=torch.bfloat16)
                  for _ in range(3))
    scores = 1 * 2 * n_long * n_long * 4         # the N x N scores, fp32
    if dev.type == "cuda":
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        chunked_attention(ql, kl, vl, causal=True, chunk_size=chunk)
        peak = torch.cuda.max_memory_allocated() - base
        print(f"[2] {n_long}-token attention peak temp = {peak / 1e6:.0f} MB "
              f"(the N^2 matrix alone would be {scores / 1e6:.0f} MB)")
    else:
        chunked_attention(ql, kl, vl, causal=True, chunk_size=chunk)
        block = 1 * 2 * n_long * chunk * 4
        print(f"[2] {n_long}-token attention: one score block of "
              f"{block / 1e6:.0f} MB at a time (the N^2 matrix alone would be "
              f"{scores / 1e6:.0f} MB)")

    # 3. block-sparse FlashAttention (paper Alg. 5, butterfly pattern)
    block_rows = min(128, n)
    layout = masks.butterfly_block_layout(n, n, block_rows, block_rows,
                                          causal=True)
    o_bs = flash_attention(q, k, v, causal=True, block_layout=layout)
    density = masks.layout_density(layout)
    print(f"[3] block-sparse butterfly: density={density:.2f} -> IO scales "
          f"by ~{density:.2f} (Prop. 4); output shape {tuple(o_bs.shape)}")


if __name__ == "__main__":
    main()
