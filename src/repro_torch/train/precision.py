"""Precision control (port of ``repro.train.precision``).

``ct_cast(x, dtype)``: identity in the forward pass; in the backward pass
it casts a floating COTANGENT to ``dtype`` and back to its own dtype.
Placed at block boundaries it rounds the backward residual-stream
gradients to bf16 while they keep their fp32 storage. As in the JAX
package, nothing on the training path calls it."""

from __future__ import annotations

import torch


class _CtCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        if ct.is_floating_point():
            ct = ct.to(ctx.dtype).to(ct.dtype)
        return ct, None


def ct_cast(x: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return _CtCast.apply(x, dtype)
