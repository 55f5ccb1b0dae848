"""Spawning the ranks of a tensor- or sequence-parallel serve, and the
rank entry that serves a list of prompts.

``spawn(world, fn, *args)`` starts ``world`` processes through
``torch.multiprocessing`` (start method ``spawn``: a child imports only
this package, never its parent's modules), joins them to a fresh default
process group initialised through a ``file://`` store in a temporary
directory (no fixed port, so concurrent spawns never collide), runs
``fn(*args)`` on each and returns every rank's result in rank order. A
rank that raises makes ``spawn`` raise with its traceback.

``serve(spec, world)`` runs ``serve_rank(spec)`` on every rank: for each
run of the spec, one ``ServingEngine`` over a fresh ``ServeMesh`` serving
waves of requests (each wave drained before the next is submitted, so a
later wave can hit the prefix cache of an earlier one), with what the
run asks to bring back (tokens, counters, the census by step kind, the
pool, the logits of a packed prefill).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, world, tmp, backend, threads):
    if threads:
        torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    fn, args = torch.load(os.path.join(tmp, "call.pt"), weights_only=False)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        torch.save(fn(*args), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(world: int, fn, *args, backend: str = "gloo",
          threads: int | None = 1) -> list:
    """``fn(*args)`` on ``world`` fresh ranks; their results by rank.
    ``threads`` sets each rank's intra-op threads (None leaves torch's
    default). The call goes to the ranks through a file, not their start
    pipes: a pipe holds 64 KiB, and a larger argument would start the
    ranks one after another."""
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        torch.save((fn, args), os.path.join(tmp, "call.pt"))
        mp.spawn(_rank_main, args=(world, tmp, backend, threads),
                 nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def _tensors(tree, device):
    """A numpy parameter tree in the port's layout as tensors on
    ``device`` (float32 leaves stay float32)."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v, device) for v in tree]
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


def serve_waves(engine, waves) -> dict[int, list[int]]:
    """Each wave's requests submitted, then the engine run to drain; the
    tokens of every finished request by rid. A request is a dict of
    ``prompt``, ``max_new`` and optionally ``temperature``, ``top_p`` and
    ``seed``."""
    for wave in waves:
        for r in wave:
            engine.submit(list(r["prompt"]), max_new_tokens=r["max_new"],
                          temperature=r.get("temperature", 0.0),
                          top_p=r.get("top_p", 1.0), seed=r.get("seed"))
        engine.run()
    return {r.rid: list(r.output) for r in engine.finished}


def serve_rank(spec: dict) -> list[dict]:
    """One rank's part of ``serve``. ``spec``: ``cfg`` (a ModelConfig),
    ``params`` (a numpy tree in the port's layout; every rank gets the full
    tree and keeps its slices; None: every rank draws the same full tree
    from ``seed`` on its device, as ``Model.init`` does), ``device`` ("cpu" or "cuda"), ``backend``
    and ``runs``: each with ``sp``, ``tp``, optional ``sp_strategy``,
    ``engine`` (ServingEngine keywords), ``waves`` and the flags ``pool``
    (bring back the rank's page pool) and ``packed`` (a (1, S) packed
    prefill batch of numpy ``tokens`` / ``segment_ids`` whose logits to
    bring back, through the shard model). A run with ``mesh_only`` only
    builds the mesh of its ``sp``, ``tp`` and ``backend`` and brings back
    the ``ValueError`` it raised (or None)."""
    from repro_torch.distributed.meshes import serve_mesh
    from repro_torch.models import build_model
    from repro_torch.serve import ServingEngine

    model = build_model(spec["cfg"])
    out = []
    for run in spec["runs"]:
        if run.get("mesh_only"):
            # a mesh that must be refused: the error each rank raised
            try:
                serve_mesh(run["sp"], run["tp"], backend=run["backend"])
                out.append({"error": None})
            except ValueError as e:
                out.append({"error": str(e)})
            continue
        mesh = serve_mesh(run["sp"], run["tp"], backend=spec["backend"],
                          device=spec["device"])
        if spec.get("params") is None:
            params = model.init(torch.Generator(device=mesh.device)
                                .manual_seed(spec["seed"]),
                                device=mesh.device)
        else:
            params = _tensors(spec["params"], mesh.device)
        eng = ServingEngine(model, params, tp=run["tp"], sp=run["sp"],
                            sp_strategy=run.get("sp_strategy"), mesh=mesh,
                            device=mesh.device, **run.get("engine", {}))
        del params
        rec = {"rank": mesh.rank, "coord": mesh.coord,
               "outputs": serve_waves(eng, run.get("waves", [])),
               "preemptions": eng.preemptions,
               "prefix_hits": eng.prefix_hits,
               "prefill_tokens_skipped": eng.prefill_tokens_skipped,
               "step_census": dict(eng.step_census),
               "cache_bytes": eng.cache_bytes(),
               "sp_strategy": eng.sp_strategy,
               "prefill_bucket": eng.prefill_bucket,
               "chunk_size": eng.scheduler.cfg.chunk_size}
        if run.get("pool"):
            rec["pool"] = {k: t.cpu().numpy()
                           for k, t in eng.state["caches"]["kv"].items()}
        if run.get("packed") is not None:
            batch = {k: torch.as_tensor(v, device=mesh.device)
                     for k, v in run["packed"].items()}
            _, logits = eng.shard_model.prefill_packed(eng.params, batch)
            rec["packed_logits"] = logits.float().cpu().numpy()
        out.append(rec)
    return out


def serve(spec: dict, world: int, *, threads: int | None = 1) -> list:
    """``serve_rank(spec)`` on ``world`` ranks; each rank's list of run
    records, by rank."""
    return spawn(world, serve_rank, spec, backend=spec["backend"],
                 threads=threads)
