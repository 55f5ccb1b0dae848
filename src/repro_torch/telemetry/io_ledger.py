"""IO ledger: per-step *predicted* HBM bytes next to measured wall-clock
(port of ``repro.telemetry.io_ledger``, the same classes and arithmetic).

The paper's cost surface is Theorem 2's HBM-access count; ``core/io_model``
prices it analytically. The ledger closes the loop at serve time: every
executed step accounts its predicted bytes (via a ``ServePriceModel``
built from the engine's config) alongside the step's wall-clock, so
``summary()`` reports the *implied* bandwidth per step kind — the number
to hold against the device's nominal HBM bandwidth
(``io_model.H100_HBM_BW``).

Pricing maps 1:1 onto io_model functions (global, all-shard traffic):

- chunk prefill  → ``prefill_order_hbm_bytes`` (the engine's loop
  order: q-major on Hopper) + the chunk's KV pool write, plus ``tp_psum_hbm_bytes`` (tp>1)
  and the sp comm component of ``sp_prefill_hbm_bytes`` (sp>1).
- decode         → split-KV streams each lane's valid cache bytes once
  (``2·kv_len·d·h_kv·elt`` per layer) + the q/o side (``3·d·h_q·elt``)
  + the new token's KV write + ``tp_psum_hbm_bytes``.
- prefix hits    → credited from ``prefix_cache_hbm_bytes_saved``
  (recorded as the ``prefix_saved`` kind, bytes NOT spent).

The ledger never touches the device: it is bookkeeping over host ints,
cheap enough to stay on even when tracing is off.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import io_model


@dataclasses.dataclass(frozen=True)
class ServePriceModel:
    """Frozen per-engine pricing constants (model geometry + mesh)."""

    d: int                 # head_dim
    heads_q: int
    heads_kv: int
    d_model: int
    layers: int
    elt: int               # KV element bytes
    block_q: int           # the forward kernel's tiles (kernels.tuning)
    block_k: int
    kv_major: bool         # loop order of the prefill kernel
    tp: int = 1
    sp: int = 1
    sp_strategy: str = "replicated"

    def prefill_bytes(self, spans) -> float:
        """Predicted bytes for one prefill call over ``spans`` =
        [(start, length), ...] — each segment attends causally to its
        ``start + length`` rows."""
        total = 0.0
        for start, length in spans:
            if length <= 0:
                continue
            orders = io_model.prefill_order_hbm_bytes(
                length, start + length, self.d, self.heads_q,
                self.heads_kv, 1, self.block_q, self.block_k, elt=self.elt)
            attn = orders["kv_major" if self.kv_major else "q_major"]
            kv_write = 2.0 * length * self.d * self.heads_kv * self.elt
            total += (attn + kv_write) * self.layers
            if self.sp > 1:
                total += self._sp_comm_bytes(length) * self.sp
        if self.tp > 1:
            n_q = sum(max(length, 0) for _, length in spans)
            total += io_model.tp_psum_hbm_bytes(
                n_q, self.d_model, self.tp, elt=self.elt,
                layers=self.layers) * self.tp
        return total

    def _sp_comm_bytes(self, chunk: int) -> float:
        """Per-shard collective bytes of moving one chunk's K/V across the
        sp axis (the comm component of ``io_model.sp_prefill_hbm_bytes``)."""
        sp = self.sp
        kv_payload = 2.0 * chunk * self.d * self.heads_kv * self.elt
        comm = 2.0 * (sp - 1) / sp * kv_payload
        if self.sp_strategy == "ring":
            return (comm * self.layers
                    + io_model.SP_COLLECTIVE_LAUNCH_BYTES
                    * (sp - 1) * self.layers)
        # allgather pays a write + re-read of the gathered non-local part
        # but a single launch per layer.
        return ((comm + comm) * self.layers
                + io_model.SP_COLLECTIVE_LAUNCH_BYTES * self.layers)

    def decode_bytes(self, kv_lens) -> float:
        """Predicted bytes for one decode step over active lanes with the
        given pre-step KV lengths (split-KV reads every valid byte once)."""
        kv_lens = list(kv_lens)
        total = 0.0
        for kv in kv_lens:
            kv_read = 2.0 * kv * self.d * self.heads_kv
            q_side = 3.0 * self.d * self.heads_q
            kv_write = 2.0 * self.d * self.heads_kv
            total += (kv_read + q_side + kv_write) * self.elt * self.layers
        if self.tp > 1:
            total += io_model.tp_psum_hbm_bytes(
                len(kv_lens), self.d_model, self.tp,
                elt=self.elt, layers=self.layers) * self.tp
        return total


class IOLedger:
    """Accumulates (steps, predicted bytes, wall seconds, tokens) per step
    kind; ``summary()`` derives implied bandwidth and bytes/token."""

    def __init__(self, price: ServePriceModel | None = None):
        self.price = price
        self.by_kind: dict[str, dict] = {}

    def account(self, kind: str, *, hbm_bytes: float, wall_s: float = 0.0,
                tokens: int = 0) -> None:
        cell = self.by_kind.setdefault(
            kind, {"steps": 0, "hbm_bytes": 0.0, "wall_s": 0.0, "tokens": 0})
        cell["steps"] += 1
        cell["hbm_bytes"] += float(hbm_bytes)
        cell["wall_s"] += float(wall_s)
        cell["tokens"] += int(tokens)

    def total_bytes(self) -> float:
        return sum(c["hbm_bytes"] for k, c in self.by_kind.items()
                   if k != "prefix_saved")

    def total_tokens(self) -> int:
        return sum(c["tokens"] for k, c in self.by_kind.items()
                   if k != "prefix_saved")

    def bytes_per_token(self) -> float:
        toks = self.total_tokens()
        return self.total_bytes() / toks if toks else 0.0

    def summary(self) -> dict[str, dict]:
        """Per-kind view with implied GB/s and bytes/token derived."""
        out = {}
        for kind, c in sorted(self.by_kind.items()):
            gbps = (c["hbm_bytes"] / c["wall_s"] / 1e9) if c["wall_s"] else 0.0
            bpt = c["hbm_bytes"] / c["tokens"] if c["tokens"] else 0.0
            out[kind] = dict(c, implied_gb_per_s=gbps, bytes_per_token=bpt)
        return out

    def table(self) -> str:
        lines = [f"{'step kind':<16} {'steps':>7} {'GB':>10} {'wall s':>9} "
                 f"{'tokens':>9} {'GB/s':>8} {'B/tok':>10}"]
        for kind, c in self.summary().items():
            lines.append(
                f"{kind:<16} {c['steps']:>7} {c['hbm_bytes'] / 1e9:>10.4f} "
                f"{c['wall_s']:>9.4f} {c['tokens']:>9} "
                f"{c['implied_gb_per_s']:>8.2f} {c['bytes_per_token']:>10.0f}")
        return "\n".join(lines)
