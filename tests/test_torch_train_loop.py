"""Fault tolerance of the port's trainer and checkpointer (the port of
``tests/test_train_loop.py``) on ``reduced_config("granite-3-2b")``:
crash/restart resume reproduces the uninterrupted run bit for bit;
corrupted checkpoints are skipped; the preemption hook saves; straggler
bookkeeping; async save. Also: a bf16 tree round-trips through the
checkpointer bit-exactly (numpy has no bfloat16; the raw bits are stored),
and an async save writes what the tree held when ``save`` was called."""

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import reduced_config
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.train import Trainer, TrainerConfig, make_train_step

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py


@pytest.fixture(scope="module")
def setup():
    cfg = reduced_config("granite-3-2b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    opt = adamw(warmup_cosine(1e-3, 5, 100))
    data = SyntheticLM(cfg.vocab_size, 32, 4, seed=3)
    step = make_train_step(model, opt, deterministic=True)
    return params, opt, step, data


def make_trainer(setup, d, **kw):
    params, opt, step, data = setup
    cfg = TrainerConfig(total_steps=kw.pop("total_steps", 20),
                        ckpt_every=kw.pop("ckpt_every", 5),
                        ckpt_dir=str(d), **kw)
    # the optimizer updates its moments in place: every trainer gets its own
    return Trainer(cfg, step, params, opt.init(params),
                   lambda s: data.batch_at(s))


def test_restart_resumes_identically(setup, tmp_path):
    t_full = make_trainer(setup, tmp_path / "full")
    hist_full = t_full.run()

    t_a = make_trainer(setup, tmp_path / "crash")
    t_a.run(max_steps=10)          # checkpoints at 5, 10; "crash" here
    t_b = make_trainer(setup, tmp_path / "crash")
    assert t_b.try_resume() and t_b.step == 10
    assert int(t_b.opt_state["step"]) == 10
    hist_b = t_b.run()

    full_tail = [h["loss"] for h in hist_full[10:]]
    resumed = [h["loss"] for h in hist_b]
    assert resumed == full_tail            # bit-identical
    for a, b in zip(tree_leaves(t_b.params), tree_leaves(t_full.params)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_resume_skips_corrupted_checkpoint(setup, tmp_path):
    t = make_trainer(setup, tmp_path)
    t.run(max_steps=10)            # checkpoints at 5 and 10
    leaf = tmp_path / "step_00000010" / "leaf_000000.npy"
    leaf.write_bytes(b"junk")
    t2 = make_trainer(setup, tmp_path)
    assert t2.try_resume()
    assert t2.step == 5            # fell back to the older valid one


def test_preemption_hook_saves_mid_interval(setup, tmp_path):
    t = make_trainer(setup, tmp_path, ckpt_every=100)
    t.run(max_steps=3)
    assert t.ckpt.all_steps() == []        # no scheduled save yet
    t.request_checkpoint()                  # a SIGTERM handler calls this
    t.run(max_steps=1)
    assert t.ckpt.all_steps() == [4]


def test_straggler_bookkeeping(setup, tmp_path):
    t = make_trainer(setup, tmp_path)
    t._track_straggler(0.1)
    for _ in range(5):
        t._track_straggler(0.1)
    assert t.slow_steps == 0
    t._track_straggler(10.0)               # 100x the EWMA -> flagged
    assert t.slow_steps == 1


def test_async_checkpoint_trainer(setup, tmp_path):
    t = make_trainer(setup, tmp_path, total_steps=6, ckpt_every=3,
                     async_ckpt=True)
    t.run()
    assert t.ckpt.all_steps() == [3, 6]
    assert t.registry.get("train_loss").value() == t.history[-1]["loss"]


def test_bf16_tree_round_trips(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(4, 3, generator=gen).to(torch.bfloat16),
            "blocks": [{"s": torch.randn(5, generator=gen)},
                       {"i": torch.arange(6, dtype=torch.int32)}],
            "step": torch.tensor(7, dtype=torch.int32)}
    ck = Checkpointer(str(tmp_path), keep=2)
    ck.save(1, tree)
    target = tree_map(torch.zeros_like, tree)
    got, step = ck.restore(target)
    assert step == 1
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bfloat16
                           else a, b.view(torch.uint8)
                           if b.dtype == torch.bfloat16 else b)


def test_async_save_copies_before_returning(tmp_path):
    """The tree is copied to the host inside ``save``: an in-place update
    right after it does not reach the checkpoint; last-k retention."""
    w = torch.ones(1000)
    ck = Checkpointer(str(tmp_path), keep=2, async_save=True)
    for s in (1, 2, 3):
        ck.save(s, {"w": w})
        w.add_(1.0)                 # the caller mutates immediately
    ck.wait()
    assert ck.all_steps() == [2, 3]
    got, step = ck.restore({"w": torch.zeros(1000)})
    assert step == 3 and float(got["w"][0]) == 3.0
    np.testing.assert_array_equal(got["w"].numpy(), np.full(1000, 3.0))
