"""Every family of the port trains with a "model" axis above one
(``train.steps.make_sharded_train_step``) as SPMD ranks over gloo on the
CPU: one spawn a world size (2 and 4 ranks; ``distributed.launch.train``,
each rank importing only ``repro_torch``), weights from the JAX
``Model.init``, 3 AdamW steps against the JAX ``make_train_step`` on the
whole batch:

  * reduced olmoe-1b-7b with its experts cut over "model" at model 2 and
    at data 2 x model 2 with ZeRO-1, at capacity factors 1.25 and 0.25
    (tokens dropped); reduced phi3.5-moe at model 2, its single kv head
    cut across the ranks;
  * reduced mamba2-2.7b cut by SSM head group at model 2, model 4 (remat)
    and data 2 x model 2 with ZeRO-1; reduced hymba-1.5b at model 2 (attention heads, SSM head
    groups, MLP; remat), with its SSM whole on every rank (3 SSM heads of
    64 and 1 of 128: their widths do not cut, as ``auto_rules`` finds),
    and at 5 q / 1 kv heads, published hymba's ratio, whose heads do not
    cut whole over 2 ranks (``train_rules`` replicates the attention);
  * reduced seamless-m4t-medium (encoder, cross-attention) and
    phi-3-vision-4.2b (patches through the replicated ``frontend_proj``)
    at model 2.

Each case: losses within 1e-4 relative of the JAX step's, the first
step's gradients of layer 0 (and of ``frontend_proj``), summed over the
ranks and gathered, within 1e-4 of their largest (with one SSM head,
``D``'s gradient within ``D_GRAD_RTOL`` of the reference's float64
value instead), the MoE's routes at
every step equal to the reference's, and every rank's census of every
step equal to ``expected_train_census``. Also: the SSM's head-group
pieces (``Pieces``) cut and gathered back bit for bit, params and ZeRO-1
moments, and a mamba2 checkpoint saved at model 2 resumed in one process.
"""

import concurrent.futures
import functools
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.optim import adamw as jax_adamw
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import reduced_config
from repro_torch.core.tree import tree_map
from repro_torch.distributed import launch
from repro_torch.distributed.sharding import (auto_rules, train_cuts,
                                              train_rules)
from repro_torch.models import build_model, params_from_jax
from repro_torch.optim import adamw
from repro_torch.train import Trainer, TrainerConfig, make_train_step

torch.set_num_threads(1)
STEPS = 3
ADAMW = {"name": "adamw", "lr": 1e-3}

# name: (arch, (data, model), config overrides, run keywords)
CASES2 = {
    # step_routes: before steps 2 and 3 the mesh's weights are gathered
    # and one forward of the whole model routes the step's tokens
    "olmoe": ("olmoe-1b-7b", (1, 2), {}, {"step_routes": True}),
    "olmoe_drop": ("olmoe-1b-7b", (1, 2), {"moe_capacity_factor": 0.25}, {}),
    "phi35moe": ("phi3.5-moe-42b-a6.6b", (1, 2), {}, {}),
    "mamba2": ("mamba2-2.7b", (1, 2), {}, {}),
    "hymba": ("hymba-1.5b", (1, 2), {"remat": True}, {}),
    # three SSM heads of 64: its widths do not cut over 2 ranks, so
    # auto_rules keeps the SSM whole on every rank beside the cut heads
    "hymba_ssm_whole": ("hymba-1.5b", (1, 2),
                        {"ssm_expand": 3, "ssm_head_dim": 64}, {}),
    # one SSM head of 128, whole on every rank too; its D gradient is
    # held against the float64 value (test_layer0_grads_match_jax)
    "hymba_ssm_one_head": ("hymba-1.5b", (1, 2), {"ssm_head_dim": 128}, {}),
    # 5 q / 1 kv heads, published hymba's ratio (25 / 5): they do not cut
    # whole over 2 ranks, so train_rules replicates the attention beside
    # the cut SSM and MLP
    "hymba_gqa5": ("hymba-1.5b", (1, 2),
                   {"num_heads": 5, "num_kv_heads": 1}, {}),
    "seamless": ("seamless-m4t-medium", (1, 2), {}, {}),
    "phi3v": ("phi-3-vision-4.2b", (1, 2), {}, {}),
}
CASES4 = {
    "olmoe_dp2tp2": ("olmoe-1b-7b", (2, 2), {}, {"zero1": True}),
    "olmoe_dp2tp2_drop": ("olmoe-1b-7b", (2, 2),
                          {"moe_capacity_factor": 0.25, "remat": True},
                          {"zero1": True}),
    "mamba2_m4": ("mamba2-2.7b", (1, 4), {"remat": True}, {}),
    "mamba2_dp2tp2": ("mamba2-2.7b", (2, 2), {}, {"zero1": True}),
}
CASES = {**CASES2, **CASES4}
SSM_WHOLE = ("hymba_ssm_whole", "hymba_ssm_one_head")
# one SSM head: D's gradient is one sum over every (row, step, channel)
# whose terms nearly cancel, so float32 rounding on either side moves it
# far more than any other leaf. Measured at layer 0 (the test prints
# it): the JAX step's float32 value 7.7e-2 from the float64 one, the
# port's 4.7e-3. The port is held to the float64 value within
# D_GRAD_RTOL.
D_GRAD_RTOL = 1e-2


def batches(cfg, n=STEPS, rows=8, seq=32, seed=5):
    """Global batches of the family's inputs: tokens and a loss mask, audio
    frames of an encoder-decoder, patches of a VLM."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (rows, seq)
                                    ).astype(np.int32),
             "loss_mask": (rng.random((rows, seq)) > 0.2).astype(np.float32)}
        if cfg.frontend == "audio":
            b["frames"] = rng.standard_normal(
                (rows, seq, cfg.frontend_dim)).astype(np.float32)
        elif cfg.frontend == "vision":
            b["patches"] = rng.standard_normal(
                (rows, cfg.frontend_tokens, cfg.frontend_dim)
            ).astype(np.float32)
        out.append(b)
    return out


@functools.lru_cache(maxsize=None)
def weights(name):
    """(port cfg, numpy params in the port's layout), from the JAX
    ``Model.init``."""
    arch, _, kw, _ = CASES[name]
    jparams = jax_build_model(jax_reduced_config(arch, **kw)).init(
        jax.random.PRNGKey(0))
    cfg = reduced_config(arch, **kw)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return cfg, tree_map(lambda t: t.numpy(), params)


_TRACING = threading.Lock()     # moe._route is patched while a step traces


def _reference(arch, kw):
    """The JAX ``make_train_step`` of the reduced arch (remat off: it does
    not change the reference's values) over ``2 * STEPS`` batches: its
    losses, the first step's gradients in the port's layout and, for the
    MoE, every step's routes (``moe._route`` watched inside the jitted
    step through an ordered callback)."""
    kw = dict(kw, remat=False)
    jmodel = jax_build_model(jax_reduced_config(arch, **kw))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced_config(arch, **kw)
    jopt = jax_adamw(1e-3)
    train = jax_make_train_step(jmodel, jopt, deterministic=True)

    def step_and_grads(p, state, b):
        g = jax.grad(lambda q: jmodel.loss(q, b, deterministic=True)[0])(p)
        return train(p, state, b), g

    seen, route = [], jax_moe._route

    def watch(logits, k):
        out = route(logits, k)
        jax.debug.callback(lambda i: seen.append(np.asarray(i)), out[0],
                           ordered=True)
        return out

    with _TRACING:
        jax_moe._route = watch
        try:
            lowered = jax.jit(step_and_grads).lower(
                jparams, jopt.init(jparams),
                {k: jnp.asarray(v) for k, v in batches(cfg)[0].items()})
        finally:
            jax_moe._route = route
    step = lowered.compile()
    state = jopt.init(jparams)
    losses, grads = [], None
    for b in batches(cfg, 2 * STEPS):
        (jparams, state, m), g = step(jparams, state,
                                      {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        grads = g if grads is None else grads
    jax.effects_barrier()
    # the step's forward runs twice (its own and the gradient's): the
    # first of each step's two passes over the layers
    n = cfg.num_layers
    routes = [seen[2 * n * i:2 * n * i + n] for i in range(2 * STEPS)]
    grads = params_from_jax(jax.tree.map(np.asarray, grads), cfg,
                            device="cpu")
    return losses, tree_map(lambda t: t.numpy(), grads), routes


def _reference_key(name):
    arch, _, kw, _ = CASES[name]
    return arch, tuple(sorted((k, v) for k, v in kw.items() if k != "remat"))


@functools.lru_cache(maxsize=None)
def _references():
    """Every case's JAX reference, computed in threads (XLA compiles
    outside the GIL): {key: future}."""
    pool = concurrent.futures.ThreadPoolExecutor(3)
    keys = dict.fromkeys(_reference_key(n) for n in CASES)
    futures = {k: pool.submit(_reference, *k) for k in keys}
    pool.shutdown(wait=False)
    return futures


def jax_run(name):
    return _references()[_reference_key(name)].result()


def run(name, **kw):
    arch, shape, _, extra = CASES[name]
    cfg, params = weights(name)
    return dict({"cfg": cfg, "params": params, "shape": shape,
                 "optimizer": ADAMW, "batches": batches(cfg), "grads": True,
                 "routes": cfg.family == "moe"}, **extra, **kw)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mamba2_ckpt"))


def _spawn(world, ckpt):
    names = list(CASES2 if world == 2 else CASES4)
    runs = [run(n) for n in names]
    if world == 2:
        i = names.index("mamba2")
        runs[i] = dict(runs[i], roundtrip=True,
                       ckpt={"dir": ckpt, "every": STEPS})
    else:
        for n in ("mamba2_m4", "mamba2_dp2tp2"):
            i = names.index(n)
            runs[i] = dict(runs[i], roundtrip=True)
    out = launch.train({"backend": "gloo", "device": "cpu", "runs": runs},
                       world)
    return {n: [recs[i] for recs in out] for i, n in enumerate(names)}


@functools.lru_cache(maxsize=None)
def spawned(ckpt):
    """Both spawns started at once, in threads, then the JAX references
    (``_references``): {world: future of {case: records by rank}}."""
    for name in CASES:
        weights(name)
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = {w: pool.submit(_spawn, w, ckpt) for w in (2, 4)}
    pool.shutdown(wait=False)
    _references()
    return futures


@pytest.fixture(scope="module", autouse=True)
def _start_ranks(ckpt_dir):
    spawned(ckpt_dir)


def records(name, ckpt):
    return spawned(ckpt)[2 if name in CASES2 else 4].result()[name]


def losses(recs):
    return [h["loss"] for h in recs[0]["history"]]


def check_ranks(recs):
    for r in recs:
        assert [h["loss"] for h in r["history"]] == losses(recs)
        for c in r["census"]:
            assert c == r["expected_census"], (r["rank"], c)


@pytest.mark.parametrize("name", list(CASES))
def test_losses_and_census_match_jax(name, ckpt_dir):
    recs = records(name, ckpt_dir)
    check_ranks(recs)
    want, _, _ = jax_run(name)
    np.testing.assert_allclose(losses(recs), want[:STEPS], rtol=1e-4)
    # the case cuts what it names: the family's own axis over "model"
    arch, shape, _, _ = CASES[name]
    cfg = weights(name)[0]
    mesh = {"data": shape[0], "model": shape[1]}
    cuts = train_cuts(cfg, mesh, train_rules(
        cfg, mesh, auto_rules(cfg, mesh, global_batch=8)))
    assert cuts["experts"] == (cfg.family == "moe")
    assert cuts["ssm"] == (cfg.ssm_state > 0 and name not in SSM_WHOLE)
    assert cuts["heads"] == (cfg.num_heads > 0 and name != "hymba_gqa5")


def _close(got, want):
    s = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / s, want / s, atol=1e-4, rtol=0)


def _float64_d_grads(name):
    """The JAX loss's first-step gradient of every layer's SSM ``D`` in
    float64: the reference's float32 weights and batch cast to float64,
    traced with x64 on and every float32 cast of the reference made a
    float64 one (``jnp.float32`` patched while it traces, after every
    other reference has finished tracing)."""
    for future in _references().values():
        future.result()
    arch, _, kw, _ = CASES[name]
    jmodel = jax_build_model(jax_reduced_config(arch, **dict(kw,
                                                             remat=False)))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    batch = batches(weights(name)[0])[0]

    def f64(a):
        return a.astype(np.float64) if a.dtype == np.float32 else a

    with jax.enable_x64(True), mock.patch.object(jnp, "float32",
                                                 jnp.float64):
        grads = jax.grad(lambda p: jmodel.loss(
            p, {k: jnp.asarray(f64(v)) for k, v in batch.items()},
            deterministic=True)[0])(jax.tree.map(f64, params))
        d = np.asarray(grads["blocks"]["ssm"]["D"])
    assert d.dtype == np.float64
    return d


@pytest.mark.parametrize("name", list(CASES))
def test_layer0_grads_match_jax(name, ckpt_dir):
    got = records(name, ckpt_dir)[0]["grads"]
    _, want, _ = jax_run(name)
    one_head = name == "hymba_ssm_one_head"
    if one_head:
        d64 = _float64_d_grads(name)[0]
        d = got["blocks"][0]["ssm"]["D"]
        print(f"layer 0's D gradient: float64 {d64}, the port's {d} "
              f"({float(abs(d[0] / d64[0] - 1)):.2e} off), JAX float32 "
              f"{want['blocks'][0]['ssm']['D']} "
              f"({float(abs(want['blocks'][0]['ssm']['D'][0] / d64[0] - 1)):.2e}"
              f" off)")
        np.testing.assert_allclose(d, d64, rtol=D_GRAD_RTOL, atol=0)
    for key in ("blocks", "enc_blocks"):
        if key in want:
            pair = (got[key][0], want[key][0])
            if one_head and key == "blocks":      # D: against float64
                pair = [dict(b, ssm={k: v for k, v in b["ssm"].items()
                                     if k != "D"}) for b in pair]
            tree_map(_close, *pair)
    if "frontend_proj" in want:
        _close(got["frontend_proj"], want["frontend_proj"])
    block = got["blocks"][0]
    if "moe" in block:       # the router: the combine's and aux's parts
        assert np.abs(block["moe"]["router"]).max() > 0
    if "ssm" in block:       # the whole pieces: every rank's heads summed
        assert np.abs(block["ssm"]["A_log"]).min() > 0


@pytest.mark.parametrize("name", [n for n in CASES
                                  if CASES[n][0].startswith(("olmoe",
                                                             "phi3.5"))])
def test_routes_equal_reference(name, ckpt_dir):
    recs = records(name, ckpt_dir)
    _, _, want = jax_run(name)
    cfg = weights(name)[0]
    data = CASES[name][1][0]
    for r in recs:
        got = r["routes"]
        calls = (2 if cfg.remat else 1) * cfg.num_layers
        assert len(got) == STEPS * calls
        rows = 8 // data
        b0 = r["coord"]["data"] * rows
        for s in range(STEPS):
            step = got[s * calls:(s + 1) * calls]
            # a remat run routes each layer again in the backward, from the
            # last layer to the first
            layers = step[:cfg.num_layers]
            again = step[cfg.num_layers:][::-1]
            for l in range(cfg.num_layers):
                for idx in [layers[l]] + again[l:l + 1]:
                    np.testing.assert_array_equal(
                        idx, want[s][l][b0:b0 + rows],
                        err_msg=f"step {s} layer {l}")
    if CASES[name][3].get("step_routes"):
        # the gathered weights' forward routes as the mesh did at that step
        gathered = recs[0]["step_routes"]
        assert len(gathered) == STEPS - 1
        assert all(r.get("step_routes") is None for r in recs[1:])
        for s, calls in enumerate(gathered, start=1):
            assert len(calls) == cfg.num_layers
            for l, (idx, probs) in enumerate(calls):
                assert probs.shape == idx.shape[:-1] + (cfg.num_experts,)
                np.testing.assert_array_equal(idx, want[s][l])
    if CASES[name][2].get("moe_capacity_factor") == 0.25:
        # capacity drops tokens: some expert gets more than its buffer
        cap = max(int(0.25 * 32 * 2 / cfg.num_experts + 0.999), 1)
        counts = [np.bincount(r.reshape(-1), minlength=cfg.num_experts)
                  for r in want[0][0]]
        assert max(c.max() for c in counts) > cap


@pytest.mark.parametrize("name", ["mamba2", "mamba2_m4", "mamba2_dp2tp2"])
def test_ssm_pieces_gather_back(name, ckpt_dir):
    for r in records(name, ckpt_dir):
        assert r["roundtrip"] is True
    # a rank holds its heads' z, x, dt columns and all of B and C
    cfg = weights(name)[0]
    m = CASES[name][1][1]
    d_inner, h, n = cfg.ssm_d_inner, cfg.ssm_num_heads, cfg.ssm_state
    shapes = records(name, ckpt_dir)[0]["param_shapes"]
    assert (cfg.d_model, 2 * d_inner // m + 2 * n + h // m) in shapes
    assert (cfg.ssm_conv_width, d_inner // m + 2 * n) in shapes


def test_mamba2_checkpoint_at_model2_resumes_in_one_process(ckpt_dir):
    recs = records("mamba2", ckpt_dir)
    assert recs[0]["start"] == 0
    cfg, params = weights("mamba2")
    six = batches(cfg, n=2 * STEPS)
    want, _, _ = jax_run("mamba2")
    p = tree_map(torch.from_numpy, params)
    opt = adamw(1e-3)
    trainer = Trainer(TrainerConfig(total_steps=2 * STEPS, ckpt_dir=ckpt_dir,
                                    ckpt_every=100),
                      make_train_step(build_model(cfg), opt,
                                      deterministic=True),
                      p, opt.init(p), lambda i: six[i])
    assert trainer.try_resume() and trainer.step == STEPS
    np.testing.assert_allclose([h["loss"] for h in trainer.run()],
                               want[STEPS:], rtol=1e-4)


def test_expert_and_head_group_ranges():
    """A rank's experts and SSM heads are its contiguous part, the
    reference's "expert" cut; the whole range where nothing is cut."""
    from repro_torch.distributed.sharding import TrainShard

    class G:
        def __init__(self, index, size):
            self.index, self.size = index, size

    def shard(index, experts=True, ssm=True):
        return TrainShard(model=G(index, 4), data=G(0, 1), heads=False,
                          ff=False, vocab=False, num_heads=0,
                          num_kv_heads=0, vocab_size=0, batch_sharded=False,
                          experts=experts, num_experts=64, ssm=ssm,
                          ssm_num_heads=80)

    assert [shard(i).expert_range for i in range(4)] == [
        (0, 16), (16, 32), (32, 48), (48, 64)]
    assert shard(2).ssm_head_range == (40, 60)
    assert shard(2, False, False).expert_range == (0, 64)
    assert shard(2, False, False).ssm_head_range == (0, 80)


def test_launcher_trains_olmoe_at_model2(tmp_path, capfd):
    from repro_torch.launch import train as launch_train

    args = ["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
            "--steps", "3", "--seq", "64", "--batch", "4", "--ckpt-every",
            "100"]
    one = launch_train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    capfd.readouterr()
    two = launch_train.main(args + ["--model", "2",
                                    "--ckpt-dir", str(tmp_path / "b")])
    printed = capfd.readouterr().out
    assert "mesh=data 1 x model 2" in printed
    steps = [line for line in printed.splitlines()
             if line.startswith("step ")]
    assert steps and all(" ce " in s and " aux " in s for s in steps)
    assert len(two) == 2
    want = [h["loss"] for h in one.history]
    for rec in two:
        got = [h["loss"] for h in rec["history"]]
        np.testing.assert_allclose(got, want, rtol=1e-4)
        assert all(h["aux"] > 0 for h in rec["history"])
