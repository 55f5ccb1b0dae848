"""Deterministic synthetic LM data (port of ``repro.data.pipeline``).

numpy only, with the JAX package's generator and draws, so a batch is
bit-equal to the JAX package's for the same (seed, step, host):

  * random access by (step, host): a restart reproduces the exact stream
    with no state files;
  * host-sharded: each host materializes only its slice of the batch;
  * learnable structure: tokens follow a noisy affine recurrence
    t_{i+1} = (a * t_i + b) % V;
  * packing: documents of random length are packed back to back with
    ``segment_ids`` (int32 document ids) and a loss mask that zeroes the
    boundary token and the first token after it.

The trainer moves the batch to the device (``Model.loss`` accepts numpy
leaves).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.masks import segment_ids_from_boundaries


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    noise: float = 0.02
    mean_doc_len: int = 512

    def __post_init__(self):
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global_batch {self.global_batch} is not a "
                             f"multiple of num_hosts {self.num_hosts}")
        self.host_batch = self.global_batch // self.num_hosts

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[step, self.host_id, 0, 0]))
        B, S, V = self.host_batch, self.seq_len, self.vocab_size
        a = 31337 % V or 7
        b = rng.integers(1, V, size=(B, 1))
        t0 = rng.integers(0, V, size=(B, 1))
        toks = np.empty((B, S), np.int64)
        toks[:, 0] = t0[:, 0]
        for i in range(1, S):
            toks[:, i] = (a * toks[:, i - 1] + b[:, 0]) % V
        flip = rng.random((B, S)) < self.noise
        toks = np.where(flip, rng.integers(0, V, size=(B, S)), toks)
        # boundary[p] marks position p as the FIRST token of a new document
        boundary = rng.random((B, S)) < (1.0 / self.mean_doc_len)
        boundary[:, 0] = False
        toks = np.where(boundary, rng.integers(0, V, size=(B, S)), toks)
        # loss_mask[p] = 0 suppresses the loss on PREDICTING token p: the
        # boundary token and the one after it (the chain restarts there)
        after = np.zeros_like(boundary)
        after[:, 1:] = boundary[:, :-1]
        loss_mask = 1.0 - (boundary | after).astype(np.float32)
        return {"tokens": toks.astype(np.int32),
                "loss_mask": loss_mask,
                "segment_ids": segment_ids_from_boundaries(boundary)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
