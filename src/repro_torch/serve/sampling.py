"""Token sampling for the serving engine: temperature / top-p with a
per-request random stream that is a pure function of (seed, position)
(port of ``repro.serve.sampling``).

The preemption-resume invariant (DESIGN.md §10) requires that a request
preempted after generating k tokens and later resumed produces the SAME
continuation. Greedy decoding gets this for free (``argmax`` takes the
first maximum, as ``jnp.argmax`` does, so greedy tokens match the JAX
engine exactly). Sampling gets it by construction: the draw for a
request's i-th generated token comes from a ``torch.Generator`` seeded
from (seed, i) alone — no random state survives a preemption. The JAX
package draws with ``fold_in(PRNGKey(seed), i)``, which PyTorch cannot
reproduce; sampled tokens are therefore identical across preempt->resume
within this package, not across the two packages.

``temperature <= 0`` means greedy for that row; ``top_p`` keeps the
smallest prefix of the sorted distribution whose cumulative probability
reaches p (the top token always survives).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["SamplingParams", "sample_tokens"]

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode distribution. ``temperature == 0`` is greedy
    (top_p and seed are then inert). ``seed`` defaults to the request id."""
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


def _stream_seed(seed: int, count: int) -> int:
    """A 63-bit generator seed from (seed, count): splitmix64-style mixing
    so neighbouring positions and requests decorrelate."""
    x = ((int(seed) & 0xFFFFFFFF) << 32 | (int(count) & 0xFFFFFFFF)) & _MASK64
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


def _sample_one(logits: torch.Tensor, seed: int, count: int,
                temperature: float, top_p: float) -> int:
    """One sampled row (temperature > 0), drawn on the host in fp32."""
    probs = torch.softmax(logits.float().cpu() / temperature, dim=-1)
    sp, order = torch.sort(probs, descending=True, stable=True)
    # keep rows whose EXCLUSIVE cumulative mass is < p: the top token's is
    # 0, so at least one row always survives.
    keep = (torch.cumsum(sp, 0) - sp) < top_p
    kept = torch.where(keep, sp, torch.zeros_like(sp))
    g = torch.Generator().manual_seed(_stream_seed(seed, count))
    idx = torch.multinomial(kept / kept.sum(), 1, generator=g)
    return int(order[idx])


def sample_tokens(logits: torch.Tensor, seeds, counts, temperature,
                  top_p) -> list[int]:
    """(n, V) logits + per-row (seed, count, temperature, top_p) -> n
    tokens. Greedy rows take the argmax on the logits' device; each
    sampled row's draw depends only on its own (seed, count, logits)."""
    greedy = logits.argmax(dim=-1).tolist()
    out = []
    for i, tok in enumerate(greedy):
        if temperature[i] <= 0.0:
            out.append(int(tok))
        else:
            out.append(_sample_one(logits[i], seeds[i], counts[i],
                                   float(temperature[i]), float(top_p[i])))
    return out
