"""Spawning the ranks of a sharded serve or train step, and the rank
entries that serve a list of prompts (``serve_rank``) and train a few
steps (``train_rank``).

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

``train(spec, world)`` runs ``train_rank(spec)`` on every rank: for each
run of the spec, a ``meshes.Mesh`` of its shape, the sharded train step
(``train.steps.make_sharded_train_step``) over this rank's pieces of the
spec's weights, stepped through the run's batches by a ``Trainer`` (with
the run's checkpoint directory: save every N steps, resume first), with
what the run asks to bring back (losses and metrics a step, each step's
collective census, the full params gathered back, the pieces' shapes,
the ``ValueError`` a refused mesh raised).
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.tree import tree_leaves, tree_map


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
    ``device`` (float32 leaves stay float32), copies: a train step updates
    them in place, and the next run of the spec starts from the tree."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v, device) for v in tree]
    return torch.tensor(np.asarray(tree), device=device)


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
    bring back, through the shard model) and ``census`` (the engine's
    censuses, ``decode_collective_census`` and ``prefill_collective_census``
    of every kind, before the first step and after the waves, and whether
    the second left the engine's pool, counters and census as they were).
    A run with ``mesh_only`` only
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
        census = _engine_census(eng) if run.get("census") else None
        rec = {"rank": mesh.rank, "coord": mesh.coord,
               "outputs": serve_waves(eng, run.get("waves", [])),
               "preemptions": eng.preemptions,
               "prefix_hits": eng.prefix_hits,
               "prefill_tokens_skipped": eng.prefill_tokens_skipped,
               "step_census": dict(eng.step_census),
               "cache_bytes": eng.cache_bytes(),
               "per_shard_cache_bytes": eng.per_shard_cache_bytes(),
               "sp_strategy": eng.sp_strategy,
               "prefill_bucket": eng.prefill_bucket,
               "chunk_size": eng.scheduler.cfg.chunk_size}
        if census is not None:
            # again after serving: the placeholder steps must leave the
            # engine's pool, counters and census as they were
            pool = {k: t.clone() for k, t in eng.state["caches"]["kv"].items()}
            seen = (eng.collectives(), dict(eng.step_census),
                    eng.decode_calls, eng.prefill_calls)
            rec["census_before"] = census
            rec["census_after"] = _engine_census(eng)
            rec["census_left_engine"] = (
                seen == (eng.collectives(), dict(eng.step_census),
                         eng.decode_calls, eng.prefill_calls)
                and all(torch.equal(pool[k], t) for k, t in
                        eng.state["caches"]["kv"].items()))
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


def _engine_census(eng) -> dict:
    """The engine's decode census and its prefill census of every kind,
    or the ``ValueError`` a kind raised, as its message."""
    out = {"decode": eng.decode_collective_census()}
    for kind in ("chunk", "packed", "scatter", "bogus"):
        try:
            out[kind] = eng.prefill_collective_census(kind)
        except ValueError as e:
            out[kind] = f"ValueError: {e}"
    return out


def serve(spec: dict, world: int, *, threads: int | None = 1) -> list:
    """``serve_rank(spec)`` on ``world`` ranks; each rank's list of run
    records, by rank."""
    return spawn(world, serve_rank, spec, backend=spec["backend"],
                 threads=threads)


def _numpy(tree):
    """A state tree as numpy copies (the decode steps update the state in
    place), floats as float32."""
    def one(t):
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy().copy()
    return tree_map(one, tree)


def kv_seq_rank(spec: dict) -> list[dict]:
    """One rank's part of ``kv_seq``: for each run of the spec, a
    ``("data", "model")`` mesh of its ``shape`` (counted), the sharded
    serve steps (``train.steps.make_sharded_serve_steps``) of ``cfg`` with
    the run's ``state`` specs ("contiguous": ``Model.decode_state_specs``,
    "paged": ``paged_decode_state_specs`` with ``page_size``, None: no
    state sharding) and ``rules`` ("auto": ``sharding.auto_rules``, None:
    the mesh's defaults), the prefill of the run's global ``batch`` (numpy
    leaves) at ``capacity``, then ``steps`` greedy decode steps (or, given
    ``forced``, one global token row a step: teacher forcing). ``spec``:
    ``cfg``, ``params`` (a numpy tree in the port's layout, every rank the
    full tree, cut to its pieces) or ``seed`` (every rank draws the same
    tree on its device), ``device``, ``backend`` and ``runs``; a run's
    ``cfg``, ``params`` and ``seed`` replace the spec's; its
    ``donate`` (default True), ``keep_state`` (bring back the rank's
    state pieces after the prefill and after the steps, and whether the
    state handed to the first step changed) and ``expect_error`` (bring
    back the ``ValueError`` building the steps or the prefill raised).
    Each record: the rank, its coordinate, its lanes' tokens and float32
    logits (prefill first), the census of each decode step, the decode
    state's bytes after the prefill, the kernels' launches over the
    prefill and the decode steps, times and, on a card, the rank's peak
    memory."""
    import time

    from repro_torch.distributed.meshes import make_mesh
    from repro_torch.distributed.sharding import auto_rules
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import build_model
    from repro_torch.telemetry.metrics import MetricsRegistry
    from repro_torch.train.steps import make_sharded_serve_steps

    out = []
    for run in spec["runs"]:
        cfg = run.get("cfg", spec.get("cfg"))
        model = build_model(cfg)
        registry = MetricsRegistry()
        mesh = make_mesh(run["shape"], ("data", "model"),
                         backend=spec["backend"],
                         device=spec["device"]).counted(registry)
        counter = registry.get("collectives")
        dev = mesh.device
        rec = {"rank": mesh.rank, "coord": mesh.named_coord}
        kind = run.get("state", "contiguous")
        specs = {"contiguous": model.decode_state_specs,
                 "paged": model.paged_decode_state_specs,
                 None: lambda: None}[kind]()
        rules = (auto_rules(cfg, mesh) if run.get("rules") == "auto"
                 else None)
        try:
            prefill, decode = make_sharded_serve_steps(
                model, mesh, rules=rules, state_specs=specs,
                donate=run.get("donate", True))
        except ValueError as e:
            if not run.get("expect_error"):
                raise
            out.append(dict(rec, error=str(e)))
            continue
        sh = decode.shardings
        tree = run.get("params", spec.get("params"))
        if tree is None:
            full = model.init(torch.Generator(device=dev)
                              .manual_seed(run.get("seed", spec.get("seed"))),
                              device=dev)
        else:
            full = _tensors(tree, dev)
        if sh["params"] is None:
            params = full
        else:
            from repro_torch.distributed.sharding import _pairs
            params = _pairs(full, sh["params"], lambda t, s_: s_.shard(t))
        del full
        batch = {k: torch.as_tensor(np.asarray(v), device=dev)
                 for k, v in run["batch"].items()}
        on_card = dev.type == "cuda"
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        kw = {"page_size": run["page_size"]} if kind == "paged" else {}
        launches = {**fa.LAUNCHES, **fd.LAUNCHES}
        t0 = time.perf_counter()
        state, logits = prefill(params, batch, run["capacity"], **kw)
        if on_card:
            torch.cuda.synchronize()
        rec["prefill_s"] = time.perf_counter() - t0
        rec["state_bytes"] = sum(t.numel() * t.element_size()
                                 for t in tree_leaves(state))
        if run.get("keep_state"):
            rec["prefill_state"] = _numpy(state)
        b = logits.shape[0]
        lo = (mesh.data.index * b if sh["token"] is not None
              and sh["token"].spec[0] is not None else 0)
        rec["lanes"] = (lo, lo + b)
        tokens = [logits[:, -1].argmax(-1).cpu().numpy()]
        rec_logits = [logits[:, -1].float().cpu().numpy()]
        census = []
        forced = run.get("forced")
        first = None if not run.get("keep_state") else _numpy(state)
        t0 = time.perf_counter()
        for i in range(run["steps"]):
            row = (np.asarray(forced[i])[lo:lo + b] if forced is not None
                   else tokens[-1])
            token = torch.as_tensor(row, dtype=torch.int32, device=dev)
            before = _census(counter)
            new_state, logits = decode(params, state, token)
            after = _census(counter)
            census.append({k: n - before.get(k, 0) for k, n in after.items()
                           if n != before.get(k, 0)})
            if i == 0 and first is not None:
                rec["input_state_unchanged"] = all(
                    np.array_equal(a, c) for a, c in zip(
                        tree_leaves(first), tree_leaves(_numpy(state))))
            state = new_state
            tokens.append(logits[:, -1].argmax(-1).cpu().numpy())
            rec_logits.append(logits[:, -1].float().cpu().numpy())
        if on_card:
            torch.cuda.synchronize()
        rec["decode_s"] = time.perf_counter() - t0
        rec["launches"] = {k: n - launches[k] for k, n in
                           {**fa.LAUNCHES, **fd.LAUNCHES}.items()}
        rec.update(tokens=np.stack(tokens, 1), logits=np.stack(rec_logits, 1),
                   census=census, expected_census=sh["census"],
                   peak_memory_bytes=(torch.cuda.max_memory_allocated(dev)
                                      if on_card else None))
        if run.get("keep_state"):
            rec["state"] = _numpy(state)
        del state, new_state, params
        out.append(rec)
    return out


def kv_seq(spec: dict, world: int, *, threads: int | None = 1) -> list:
    """``kv_seq_rank(spec)`` on ``world`` ranks; each rank's list of run
    records, by rank."""
    return spawn(world, kv_seq_rank, spec, backend=spec["backend"],
                 threads=threads)


def _optimizer(spec: dict):
    """An optimizer from a picklable spec: ``{"name": "adamw" | "lamb",
    "lr": a float or (schedule name, args), **keywords}``."""
    from repro_torch import optim
    kw = dict(spec)
    name, lr = kw.pop("name"), kw.pop("lr")
    if not isinstance(lr, (int, float)):
        lr = getattr(optim, lr[0])(*lr[1])
    return getattr(optim, name)(lr, **kw)


def _census(counter) -> dict[str, int]:
    return {key[0]: int(counter.value(kind=key[0]))
            for key in counter.series_keys()}


def train_rank(spec: dict) -> list[dict]:
    """One rank's part of ``train``. ``spec``: ``device``, ``backend`` and
    ``runs``, each with ``cfg`` (a ModelConfig), ``params`` (a numpy tree
    in the port's layout, every rank the full tree) or ``seed`` (every
    rank draws the same tree), ``shape`` of its ``("data", "model")``
    mesh, ``optimizer`` (``_optimizer``'s spec), ``batches`` (global
    numpy batches, one a step, their rows cut over "data"), and optionally
    ``zero1`` (default True), ``grad_accum``, ``deterministic`` (default
    True), ``ckpt`` ({"dir", "every", "resume"}), ``gather`` (bring
    back the full params on rank 0), ``grads`` (bring back the first
    step's summed gradients, gathered into full arrays, on rank 0),
    ``roundtrip`` (whether every leaf cut into the rank's param and
    moment pieces gathers back into the full array, bit for bit),
    ``routes`` (bring back every MoE layer's top-k experts of the rank's
    rows at every step, ``moe._route`` watched) and ``step_routes``
    (before each step after the first, gather the mesh's weights and
    bring back, on rank 0, the routes and router probabilities of one
    forward of the whole model over that step's batch); a key of ``spec`` is
    every run's default. Each record holds the attention kernels'
    launches over the run's steps and, on a card, the rank's peak
    memory. A run with
    ``expect_error`` brings back the ``ValueError`` the step factory
    raised (or None); a run with ``mesh_fn`` (a name in ``launch.mesh``
    and its ``mesh_kw``) only builds that mesh and brings back the
    ``ValueError`` it raised (or None)."""
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.distributed.meshes import make_mesh
    from repro_torch.distributed.sharding import (P, _pairs, auto_rules,
                                                  shard_tree, unshard)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import build_model
    from repro_torch.telemetry.metrics import MetricsRegistry
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.steps import init_opt_state, make_sharded_train_step

    out = []
    for run in spec["runs"]:
        if "mesh_fn" in run:
            try:
                getattr(launch_mesh, run["mesh_fn"])(**run.get("mesh_kw", {}))
                out.append({"error": None})
            except ValueError as e:
                out.append({"error": str(e)})
            continue
        run = {**spec, **run}
        model = build_model(run["cfg"])
        mesh = make_mesh(run["shape"], ("data", "model"),
                         backend=spec["backend"], device=spec["device"])
        registry = MetricsRegistry()
        mesh = mesh.counted(registry)
        counter = registry.get("collectives")
        batches = run["batches"]
        rules = auto_rules(run["cfg"], mesh,
                           global_batch=len(batches[0]["tokens"]))
        opt = _optimizer(run["optimizer"])
        specs = {k: P("data", None) for k in batches[0]}
        kept = []

        def keep_first(grads):
            if not kept:
                kept.append(tree_map(torch.clone, grads))

        try:
            step, sh = make_sharded_train_step(
                model, opt, mesh, rules=rules, zero1=run.get("zero1", True),
                grad_accum=run.get("grad_accum", 1),
                deterministic=run.get("deterministic", True),
                batch_specs=specs,
                on_grads=keep_first if run.get("grads") else None)
        except ValueError as e:
            if not run.get("expect_error"):
                raise
            out.append({"error": str(e)})
            continue
        if run.get("expect_error"):
            out.append({"error": None})
            continue
        if run.get("params") is None:
            full = model.init(torch.Generator(device=mesh.device)
                              .manual_seed(run["seed"]), device=mesh.device)
        else:
            full = _tensors(run["params"], mesh.device)
        params = shard_tree(full, sh["params"])
        roundtrip = None
        if run.get("roundtrip"):
            # every leaf's pieces, of the params and of the moments,
            # gathered back bit for bit
            roundtrip = all(
                torch.equal(a, b)
                for tree in (sh["params"], sh["opt"]["mu"])
                for a, b in zip(tree_leaves(unshard(shard_tree(full, tree),
                                                    tree)),
                                tree_leaves(_pairs(full, tree,
                                                   lambda t, _: t))))
        del full
        opt_state = init_opt_state(opt, params, sh)
        census, step_routes = [], []

        def counted_step(p, o, b):
            if run.get("step_routes") and census:
                # this step's weights gathered, outside the census window
                step_routes.append(_gathered_routes(model, p, sh["params"],
                                                    b, mesh.rank))
            before = _census(counter)
            res = step(p, o, b)
            after = _census(counter)
            census.append({k: n - before.get(k, 0) for k, n in after.items()
                           if n != before.get(k, 0)})
            return res

        ckpt = run.get("ckpt") or {}
        scratch = (None if ckpt.get("dir") else
                   tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_"))
        trainer = Trainer(
            TrainerConfig(total_steps=len(batches),
                          ckpt_every=ckpt.get("every", 10 ** 9),
                          ckpt_dir=ckpt.get("dir") or scratch.name),
            counted_step, params, opt_state, lambda i: batches[i],
            param_shardings=sh["params"], opt_shardings=sh["opt"])
        del params, opt_state
        if ckpt.get("resume"):
            trainer.try_resume()
        on_card = mesh.device.type == "cuda"
        if on_card:
            torch.cuda.synchronize(mesh.device)
            torch.cuda.reset_peak_memory_stats(mesh.device)
        launches = dict(fa.LAUNCHES)
        with _watched_routes(run.get("routes")) as routes:
            hist = trainer.run()
        if scratch is not None:
            scratch.cleanup()
        rec = {"rank": mesh.rank, "coord": mesh.named_coord,
               "launches": {k: n - launches[k] for k, n in
                            fa.LAUNCHES.items()},
               "peak_memory_bytes": (torch.cuda.max_memory_allocated(
                   mesh.device) if on_card else None),
               "start": len(batches) - len(hist), "history": hist,
               "census": census, "expected_census": sh["census"],
               "param_shapes": [tuple(t.shape)
                                for t in tree_leaves(trainer.params)],
               "moment_shapes": [tuple(t.shape) for t in
                                 tree_leaves(trainer.opt_state["mu"])]}
        if run.get("routes"):
            rec["routes"] = routes
        if run.get("step_routes") and mesh.rank == 0:
            rec["step_routes"] = step_routes
        if roundtrip is not None:
            rec["roundtrip"] = roundtrip
        if kept:
            full = unshard(kept[0], sh["opt"]["mu"])
            if mesh.rank == 0:
                rec["grads"] = tree_map(lambda t: t.cpu().numpy(), full)
        if run.get("gather"):
            full = unshard(trainer.params, sh["params"])
            if mesh.rank == 0:
                rec["full"] = tree_map(lambda t: t.float().cpu().numpy(),
                                       full)
        out.append(rec)
    return out


@contextlib.contextmanager
def _watched_routes(on: bool, probs: bool = False):
    """While on, every ``moe._route`` call's top-k experts (numpy; with
    ``probs``, (experts, router probabilities)) into the yielded list. A
    watch opened inside another calls the unwatched route: the outer one
    does not see the inner one's calls."""
    from repro_torch.models import moe

    seen: list = []
    route = moe._route
    base = getattr(route, "unwatched", route)

    def watch(logits, k):
        out = base(logits, k)
        idx = out[0].cpu().numpy()
        seen.append((idx, out[2].cpu().numpy()) if probs else idx)
        return out

    watch.unwatched = base
    if on:
        moe._route = watch
    try:
        yield seen
    finally:
        moe._route = route


def _gathered_routes(model, pieces, shardings, batch, rank: int):
    """The routes of one forward of the whole (unsharded) ``model`` over
    the global ``batch`` with the mesh's current weights, gathered from
    every rank's ``pieces`` (a collective every rank runs): on rank 0 a
    list of (experts, router probabilities) a MoE call, elsewhere None."""
    from repro_torch.distributed.sharding import unshard

    full = unshard(pieces, shardings)
    if rank != 0:
        return None
    with torch.no_grad(), _watched_routes(True, probs=True) as seen:
        model.forward(full, batch)
    return seen


def train(spec: dict, world: int, *, threads: int | None = 1) -> list:
    """``train_rank(spec)`` on ``world`` ranks; each rank's list of run
    records, by rank."""
    return spawn(world, train_rank, spec, backend=spec["backend"],
                 threads=threads)


def pipeline_rank(spec: dict) -> dict:
    """One stage of ``pipeline.pipeline_apply`` over the ``"pipe"`` axis of
    a mesh of every rank (``spec["shape"]`` / ``spec["axes"]``, default a
    ``("pipe",)`` mesh of them all; the ranks along another axis run
    pipelines of their own): ``spec`` = {"w": (L, D, D) numpy, "x": (GB,
    D) numpy, "num_microbatches", "device", "backend"}, the stack of
    ``pipeline.tanh_block`` layers. Returns the output on this rank, the
    gradient of sum(y²) with respect to the whole (L, D, D) stack (this
    stage's layers; zeros elsewhere) and the collectives by kind."""
    from repro_torch.distributed import pipeline
    from repro_torch.distributed.meshes import make_mesh
    from repro_torch.telemetry.metrics import MetricsRegistry

    registry = MetricsRegistry()
    mesh = make_mesh(spec.get("shape", (dist.get_world_size(),)),
                     spec.get("axes", ("pipe",)), backend=spec["backend"],
                     device=spec["device"]).counted(registry)
    w = torch.tensor(spec["w"], device=mesh.device, requires_grad=True)
    x = torch.tensor(spec["x"], device=mesh.device)
    stages = pipeline.split_stages({"w": w}, mesh.shape["pipe"])
    y = pipeline.pipeline_apply(pipeline.make_stage_fn(pipeline.tanh_block),
                                stages, x, mesh=mesh,
                                num_microbatches=spec["num_microbatches"])
    y.square().sum().backward()
    return {"rank": mesh.rank, "stage": mesh.named_coord["pipe"],
            "y": y.detach().cpu().numpy(),
            "grad": w.grad.cpu().numpy(),
            "census": _census(registry.get("collectives"))}


def compression_rank(spec: dict) -> dict:
    """``compression.compressed_mean_tree`` of this rank's row of
    ``spec["g"]`` (world, n) over a ``("data",)`` mesh of every rank."""
    from repro_torch.distributed import compression
    from repro_torch.distributed.meshes import make_mesh

    mesh = make_mesh((dist.get_world_size(),), ("data",),
                     backend=spec["backend"], device=spec["device"])
    g = torch.tensor(spec["g"][mesh.rank], device=mesh.device)
    mean = compression.compressed_mean_tree({"g": g}, mesh.group("data"))
    return {"rank": mesh.rank, "mean": mean["g"].cpu().numpy()}
