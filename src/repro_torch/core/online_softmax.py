"""Online (blocked) softmax primitives — the algebraic core of FlashAttention
§3.1 (PyTorch port of ``repro.core.online_softmax``).

The paper decomposes softmax over a concatenation ``x = [x1 x2]`` with running
statistics ``m(x) = max`` and ``l(x) = sum exp(x - m)``:

    m  = max(m1, m2)
    l  = exp(m1 - m) * l1 + exp(m2 - m) * l2

and the attention output accumulator rescales the same way (Alg. 1 line 12).
These primitives are shared by the chunked reference (``kernels/ref.py``),
the kernels' plain versions and the split-KV decode merge.

A softmax "state" over a set of key blocks is the triple ``(m, l, acc)``:
  m   : (..., q)        running row max of scores (fp32)
  l   : (..., q)        running row sum of exp(scores - m) (fp32)
  acc : (..., q, d)     running UNNORMALIZED output  sum exp(s - m) @ V (fp32)

The final output is ``acc / l`` (guarding l == 0 for fully-masked rows).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.masks import NEG_INF  # one masked-score sentinel


class SoftmaxState(NamedTuple):
    m: torch.Tensor    # (..., q)
    l: torch.Tensor    # (..., q)
    acc: torch.Tensor  # (..., q, d)


def init_state(q_shape: tuple[int, ...], d: int, dtype=torch.float32,
               device=None) -> SoftmaxState:
    """Empty state: m = -inf, l = 0, acc = 0 (Alg. 1 line 2)."""
    return SoftmaxState(
        m=torch.full(q_shape, NEG_INF, dtype=dtype, device=device),
        l=torch.zeros(q_shape, dtype=dtype, device=device),
        acc=torch.zeros((*q_shape, d), dtype=dtype, device=device),
    )


def pv_product(p: torch.Tensor, values: torch.Tensor,
               p_dtype=None) -> torch.Tensor:
    """P @ V in float32; ``p_dtype`` (e.g. bf16) rounds P and V to it
    first and sums the products in float32, the reference's
    ``dot_general`` with ``preferred_element_type=float32`` (a product of
    two bf16 values is exact in float32)."""
    if p_dtype is None:
        return p @ values.float()
    return p.to(p_dtype).float() @ values.to(p_dtype).float()


def block_state(scores: torch.Tensor, values: torch.Tensor,
                p_dtype=None) -> SoftmaxState:
    """State for a single block of scores (..., q, k) and values (..., k, d);
    scores must already include any masking as NEG_INF terms. ``p_dtype``:
    the P tile's width for P@V (``pv_product``); m and l stay float32."""
    scores = scores.float()
    m = scores.amax(dim=-1)
    # Guard fully-masked rows: exp(NEG_INF - NEG_INF) = 1 would pollute l.
    p = torch.exp(scores - m[..., None])
    p = torch.where(scores <= NEG_INF / 2, torch.zeros_like(p), p)
    l = p.sum(dim=-1)
    acc = pv_product(p, values, p_dtype)
    return SoftmaxState(m=m, l=l, acc=acc)


def merge_states(a: SoftmaxState, b: SoftmaxState) -> SoftmaxState:
    """Associative + commutative merge (paper §3.1 decomposition)."""
    m = torch.maximum(a.m, b.m)
    ea = torch.exp(a.m - m)
    eb = torch.exp(b.m - m)
    l = a.l * ea + b.l * eb
    acc = a.acc * ea[..., None] + b.acc * eb[..., None]
    return SoftmaxState(m=m, l=l, acc=acc)


def finalize(state: SoftmaxState, dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (output, lse). output = acc / l; lse = m + log(l).
    Fully-masked rows (l == 0) produce zeros and lse = NEG_INF."""
    l_safe = torch.where(state.l == 0.0, torch.ones_like(state.l), state.l)
    out = state.acc / l_safe[..., None]
    lse = torch.where(state.l == 0.0, torch.full_like(state.l, NEG_INF),
                      state.m + torch.log(l_safe))
    if dtype is not None:
        out = out.to(dtype)
    return out, lse
