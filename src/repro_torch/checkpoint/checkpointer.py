"""Fault-tolerant checkpointing (port of ``repro.checkpoint.checkpointer``):
atomic, checksummed, last-k retention, corruption fallback, async save.

Layout:
  <dir>/step_00000100/           (atomic: written as .tmp-* then renamed)
      manifest.json              structure, shapes, dtypes, crc32 per leaf
      leaf_000000.npy ...
  <dir>/LATEST                   text file with the newest step number

A tree is nested dicts and lists of tensors. Each leaf is copied to the
host BEFORE an async save starts its thread (the caller may update the
device tensors in place right after ``save`` returns), and stored as the
raw bits of its dtype through numpy: ``Tensor.numpy()`` has no bfloat16,
so a bf16 leaf is saved as its int16 view and the manifest records the
torch dtype, which ``restore`` puts back with a ``view``. Restore checks
each leaf's crc32 and shape and falls back to the newest valid step;
leaves are matched to the target tree by their keys (the manifest keeps
the saved tree's structure), so the target's dict order does not matter,
and land on the device of the matching target leaf.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_map

# torch dtypes without a numpy dtype, stored as a same-width integer view
_VIEW_AS = {torch.bfloat16: torch.int16}


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().to("cpu", copy=True).contiguous()
    dtype = str(t.dtype).removeprefix("torch.")
    if t.dtype in _VIEW_AS:
        t = t.view(_VIEW_AS[t.dtype])
    return t.numpy(), dtype


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(arr)
    want = getattr(torch, dtype)
    return t.view(want) if want in _VIEW_AS else t.to(want)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree) -> None:
        host = [_to_host(x) for x in tree_leaves(tree)]
        structure = tree_map(lambda _: None, tree)
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write_logged, args=(step, host, structure),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host, structure)

    def wait(self) -> None:
        """Join the pending async save; re-raise its failure, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err

    def _write_logged(self, step, host, structure) -> None:
        try:
            self._write(step, host, structure)
        except Exception as e:    # reported by the next wait()
            self._error = e

    def _write(self, step: int, host, structure) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + f".tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "structure": structure, "leaves": []}
        for i, (arr, dtype) in enumerate(host):
            np.save(os.path.join(tmp, f"leaf_{i:06d}.npy"), arr)
            manifest["leaves"].append({"shape": list(arr.shape),
                                       "dtype": dtype, "crc32": _crc(arr)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(self.dir, "LATEST.tmp"),
                   os.path.join(self.dir, "LATEST"))
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp" not in name:
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def _validate(self, step: int):
        """(the saved tree, rebuilt from the manifest's structure) or None
        where the step does not validate."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            leaves = []
            for i, meta in enumerate(manifest["leaves"]):
                arr = np.load(os.path.join(path, f"leaf_{i:06d}.npy"))
                if list(arr.shape) != meta["shape"] or _crc(arr) != meta["crc32"]:
                    return None
                leaves.append(_from_host(arr, meta["dtype"]))
            return _fill(manifest["structure"], iter(leaves))
        except (OSError, ValueError, KeyError, AttributeError,
                json.JSONDecodeError):
            return None

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target_tree, step: int | None = None):
        """Restore into the structure of ``target_tree`` (each leaf on the
        device of the target's leaf). Falls back to the newest checkpoint
        that validates. Returns (tree, step)."""
        candidates = ([step] if step is not None else
                      list(reversed(self.all_steps())))
        for s in candidates:
            saved = self._validate(s)
            if saved is None:
                continue
            try:
                return _match(target_tree, saved), s
            except (KeyError, IndexError, TypeError):
                continue            # another tree's checkpoint
        raise FileNotFoundError(f"no valid checkpoint in {self.dir}")


def _fill(structure, leaves):
    """The saved tree: the manifest's structure with its leaves in order."""
    if isinstance(structure, dict):
        return {k: _fill(v, leaves) for k, v in structure.items()}
    if isinstance(structure, list):
        return [_fill(v, leaves) for v in structure]
    return next(leaves)


def _match(target, saved):
    """The saved tree in the target's structure (by keys), each leaf on the
    device of the target's."""
    if isinstance(target, dict):
        if set(target) != set(saved):
            raise KeyError(f"keys {sorted(saved)} != {sorted(target)}")
        return {k: _match(v, saved[k]) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if len(target) != len(saved):
            raise IndexError("list lengths differ")
        return type(target)(_match(t, v) for t, v in zip(target, saved))
    if isinstance(saved, (dict, list)):
        raise TypeError("a leaf where the checkpoint has a subtree")
    return saved.to(target.device)
