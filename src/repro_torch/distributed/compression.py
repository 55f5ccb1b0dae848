"""Gradient compression for the data-parallel all-reduce: int8
quantization with a per-tensor scale and error-feedback residuals (port
of ``repro.distributed.compression``).

At 2+ pods the data-parallel gradient all-reduce crosses the inter-pod
link, the slowest hop. Quantizing each summand to int8 cuts those bytes
4x (fp32) or 2x (bf16) at ~0.4% relative error a step, which error
feedback (the 1-bit SGD lineage) removes over steps: the quantization
error of step t is added back into step t+1's gradient.

These are standalone functions, as in the reference, whose sharded train
step does not call them:

  * ``quantize`` / ``dequantize`` — the int8 payload and its scale,
    bit-equal to the reference's;
  * ``compressed_mean_tree(grads, group)`` — the mean of a gradient tree
    over a ``Group``: each rank dequantizes its own int8 payload and the
    dequantized values are summed over the group and divided by its size
    (the reference's ``psum`` of ``contrib``);
  * ``error_feedback_update`` / ``init_residuals`` — the residual state.
"""

from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map
from repro_torch.distributed import comm


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, fp32 scale): scale = max|g| / 127 (at least 1e-12),
    payload = clip(round_half_even(g / scale), -127, 127)."""
    gf = g.float()
    scale = torch.clamp(gf.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_mean_tree(grads, group):
    """The mean of a gradient tree over ``group`` with int8 payloads: each
    rank's contribution is exact to 1/127 of its own max|g|."""
    n = group.size

    def one(g):
        q, scale = quantize(g)
        return comm.all_reduce_sum(dequantize(q, scale), group) / n

    return tree_map(one, grads)


def error_feedback_update(grads, residuals):
    """Add the residuals into the grads, quantize, keep the new residual.
    Returns (dequantized grads in fp32, new residuals)."""
    pairs = tree_map(lambda g, r: _feedback(g.float() + r), grads, residuals)
    return (tree_map(lambda _, p: p[0], grads, pairs),
            tree_map(lambda _, p: p[1], grads, pairs))


def _feedback(gf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    deq = dequantize(*quantize(gf))
    return deq, gf - deq


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
