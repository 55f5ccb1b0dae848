"""Fault-tolerant trainer loop (port of ``repro.train.loop``).

  * checkpoint every N steps (atomic, last-k, async-capable);
  * automatic resume from the newest VALID checkpoint (corrupted
    checkpoints are skipped);
  * deterministic data: the pipeline is random-access by step, so a
    resumed run consumes exactly the batches it would have (bit-identical
    loss curves across restarts — asserted in tests);
  * preemption hook: ``request_checkpoint()`` from a signal handler makes
    the loop save at the next step boundary;
  * straggler bookkeeping: per-step wall-time EWMA + slow-step counter.

A step's wall time ends at ``loss.item()``, which waits for the device
(the JAX package's ``block_until_ready``).

A sharded trainer (``param_shardings`` / ``opt_shardings``: the
``NamedSharding`` trees of ``make_sharded_train_step``) is one rank of
SPMD ranks: a save gathers the full arrays (every rank takes part) and
rank 0 writes them, so a checkpoint is mesh-free, as the reference's is;
a resume reads the full arrays and cuts this rank's pieces on the CURRENT
mesh (the reference's elastic restore onto the current shardings). A
preemption request on any rank makes every rank save at the same step
(the flag is maxed over the mesh each step).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.tree import tree_leaves
from repro_torch.distributed import comm
from repro_torch.distributed.sharding import shard_tree, unshard
from repro_torch.telemetry.metrics import MetricsRegistry


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 100
    ckpt_keep: int = 3
    async_ckpt: bool = False
    straggler_ewma: float = 0.9
    straggler_factor: float = 3.0    # step counts as "slow" above EWMA * factor


class Trainer:
    def __init__(self, cfg: TrainerConfig, step_fn: Callable,
                 params, opt_state,
                 batch_fn: Callable[[int], Any],
                 param_shardings=None, opt_shardings=None,
                 registry: MetricsRegistry | None = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.batch_fn = batch_fn
        self.param_shardings = param_shardings
        self.opt_shardings = opt_shardings
        self.mesh = (tree_leaves(param_shardings)[0].mesh
                     if param_shardings is not None else None)
        self.ckpt = Checkpointer(cfg.ckpt_dir, keep=cfg.ckpt_keep,
                                 async_save=cfg.async_ckpt)
        self.step = 0
        self.history: list[dict] = []
        self._ckpt_requested = False
        self._ewma: float | None = None
        self.slow_steps = 0
        self.registry = registry if registry is not None else MetricsRegistry()
        self._h_step = self.registry.histogram(
            "train_step_time_s", "per-step wall time")
        self._g_loss = self.registry.gauge("train_loss", "last step loss")
        self._g_tps = self.registry.gauge(
            "train_tokens_per_s", "tokens/s over the last step")

    # ----------------------------------------------------------- checkpoints
    def _shardings(self):
        return {"params": self.param_shardings,
                "opt_state": self.opt_shardings}

    def save(self) -> None:
        tree = {"params": self.params, "opt_state": self.opt_state}
        if self.mesh is not None:
            tree = unshard(tree, self._shardings())
            if self.mesh.rank != 0:
                return
        self.ckpt.save(self.step, tree)

    def try_resume(self) -> bool:
        """Restore the newest valid checkpoint (a sharded trainer cuts its
        pieces out of the full arrays on the current mesh). Returns True
        if resumed."""
        if not self.ckpt.all_steps():
            return False
        target = {"params": self.params, "opt_state": self.opt_state}
        try:
            tree, step = self.ckpt.restore(target)
        except FileNotFoundError:
            return False
        if self.mesh is not None:
            tree = shard_tree(tree, self._shardings())
        self.params = tree["params"]
        self.opt_state = tree["opt_state"]
        self.step = step
        return True

    def _save_requested(self) -> bool:
        """The preemption flag, or a sharded trainer's flag on any rank."""
        if self.mesh is None or self.mesh.size == 1:
            return self._ckpt_requested
        flag = torch.tensor([float(self._ckpt_requested)],
                            device=self.mesh.device)
        return bool(comm.all_reduce_max(flag, self.mesh.world)[0] > 0)

    def request_checkpoint(self) -> None:
        """Preemption-signal hook (a SIGTERM handler calls this)."""
        self._ckpt_requested = True

    # ------------------------------------------------------------------ run
    def run(self, max_steps: int | None = None) -> list[dict]:
        end = min(self.cfg.total_steps,
                  self.step + (max_steps or self.cfg.total_steps))
        while self.step < end:
            batch = self.batch_fn(self.step)
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"].item())    # waits for the device
            dt = time.perf_counter() - t0
            self._track_straggler(dt)
            self.step += 1
            rec = {k: float(v) for k, v in metrics.items()}
            rec["loss"] = loss
            rec["step"] = self.step
            rec["step_time_s"] = dt
            self.history.append(rec)
            self._h_step.observe(dt)
            self._g_loss.set(loss)
            n_tok = self._batch_tokens(batch)
            if n_tok and dt > 0:
                self._g_tps.set(n_tok / dt)
            if self._save_requested() or self.step % self.cfg.ckpt_every == 0:
                self.save()
                self._ckpt_requested = False
        self.ckpt.wait()
        return self.history

    @staticmethod
    def _batch_tokens(batch) -> int:
        """Token count for throughput: the ``tokens`` entry of the batch."""
        if not (isinstance(batch, dict) and "tokens" in batch):
            return 0
        t = batch["tokens"]
        return t.numel() if isinstance(t, torch.Tensor) else int(np.size(t))

    def _track_straggler(self, dt: float) -> None:
        if self._ewma is None:
            self._ewma = dt
            return
        if dt > self.cfg.straggler_factor * self._ewma:
            self.slow_steps += 1
        a = self.cfg.straggler_ewma
        self._ewma = a * self._ewma + (1 - a) * dt
