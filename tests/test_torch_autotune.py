"""The port's tuner (``repro_torch.kernels.tuning``) against the JAX
package's (``repro.kernels.tuning``) on the CPU: the public names, the
decision record, the cache keys and the cache file bit-equal, the analytic
chooser equal to the reference's where both take the same tiles, the tiles
every path resolves with autotuning off, the autotuner's write + hit round
trips on the plain versions (``device="cpu"``), the cache shared by two
processes, a model-2 rank resolving as a shard, the ``--smoke`` CLI, the
serve and train launchers' ``--autotune`` / ``--sram-budget`` and the
dry-run's ``--override``, and tile invariance of
``ops.flash_attention`` (outputs and gradients across every legal pair of
{8, 24, 32, 64} rows, against ``repro.kernels.ref.standard_attention``).
Mirrors ``tests/test_tuning.py`` case for case, with the card's limits in
place of the TPU's (tiles of multiples of 8 rows up to 64, one Hopper
block of shared memory, at most 8 decode splits)."""

import dataclasses
import functools
import itertools
import json
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import io_model as jio
from repro.kernels import tuning as jtuning
from repro.kernels.ref import standard_attention
from repro_torch.core import io_model
from repro_torch.kernels import ops, tuning

ROOT = pathlib.Path(__file__).resolve().parents[1]
INV = dict(rtol=1e-4, atol=1e-5)
torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py


@pytest.fixture
def tuned(tmp_path):
    """A private autotune cache under tmp_path; every knob restored after
    the test."""
    saved = dict(tuning._STATE)
    tuning.configure_tuning(cache_path=str(tmp_path / "autotune.json"))
    yield tmp_path / "autotune.json"
    tuning._STATE.update(saved)
    tuning.configure_tuning(cache_path=saved["cache_path"])


# ---------------------------------------------------------------------------
# the reference's surface, bit-equal
# ---------------------------------------------------------------------------

def _public(mod) -> set[str]:
    """Names a module defines (not those it imports)."""
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, type(os))
            and getattr(v, "__module__", mod.__name__) == mod.__name__}


def test_every_public_name_of_the_reference():
    missing = _public(jtuning) - set(vars(tuning))
    # the kv-major loop order is not ported (the Hopper bodies walk q-major)
    assert missing == {"kv_major_fits"}


def test_tile_config_fields_and_cache_entry_equal_reference():
    fields = [(f.name, f.default) for f in dataclasses.fields(tuning.TileConfig)]
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(jtuning.TileConfig)]
    kw = dict(block_q=32, block_k=64, decode_block_k=16, num_decode_splits=4,
              sp_strategy="ring", source="autotuned")
    entry = tuning.TileConfig(**kw).as_cache_entry()
    assert entry == jtuning.TileConfig(**kw).as_cache_entry()
    assert tuning.TileConfig.from_cache_entry(
        {**entry, "timed_us": 3.0, "candidates_us": {}}) == \
        tuning.TileConfig(**{**kw, "source": "cache"})


@pytest.mark.parametrize("n", [1, 7, 100, 128, 129, 1000, 2048, 2049, 32768])
def test_seq_bucket_equals_reference(n):
    assert tuning.seq_bucket(n) == jtuning.seq_bucket(n)


@pytest.mark.parametrize("shards,sp", [(1, 1), (2, 1), (1, 4), (4, 2)])
def test_cache_key_equals_reference(shards, sp):
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16),
                     ("float32", "float32"), ("bfloat16", jnp.bfloat16)):
        for mask in ("causal", "dense", "causal+seg+pos"):
            assert tuning.cache_key("NVIDIA H100 80GB HBM3", tdt, 64, 2048,
                                    mask, shards=shards, sp=sp) == \
                jtuning.cache_key("NVIDIA H100 80GB HBM3", jdt, 64, 2048,
                                  mask, shards=shards, sp=sp)
    assert tuning.elt_bytes(torch.bfloat16) == jtuning._elt_bytes(jnp.bfloat16)
    assert tuning.elt_bytes(torch.float32) == jtuning._elt_bytes(jnp.float32)


def test_mask_class_equals_reference():
    for flags in itertools.product((False, True), repeat=6):
        kw = dict(zip(("causal", "has_kv_mask", "has_segments",
                       "has_sparse", "has_positions"), flags[:5]),
                  window=64 if flags[5] else None)
        assert tuning.mask_class_of(**kw) == jtuning.mask_class_of(**kw)


def test_cache_file_loads_in_both_packages(tmp_path):
    kind = "Some Accelerator X1"          # in neither nominal table
    cfg = dict(block_q=32, block_k=64)
    samples = ((1.5e6, 120.0), (4.0e6, 300.0), (2.0e5, 15.5))
    for writer, reader in ((tuning, jtuning), (jtuning, tuning)):
        path = str(tmp_path / f"{writer.__name__}.json")
        w = writer.AutotuneCache(path)
        for i, (b, us) in enumerate(samples):
            w.put(f"k{i}", writer.TileConfig(**cfg), us, model_hbm_bytes=b,
                  device_kind=kind)
        r = reader.AutotuneCache(path)
        got = r.get("k1")
        assert (got.block_q, got.block_k, got.source) == (32, 64, "cache")
        assert r.calibration(kind) == w.calibration(kind)
        with open(path) as f:
            doc = json.load(f)
        assert set(doc) == {"version", "entries", "calibration"}
        assert doc["version"] == 1
    assert tuning.nominal_hbm_bw(kind) == jtuning.nominal_hbm_bw(kind)
    assert tuning.nominal_hbm_bw("NVIDIA H100 80GB HBM3") == 3.35e12


_PUTTER = """
import os, sys, time
sys.path.insert(0, {src!r})
from repro_torch.kernels import tuning
cache = tuning.AutotuneCache({path!r})
open({path!r} + ".{tag}.ready", "w").close()
while not os.path.exists({path!r} + ".go"):
    time.sleep(0.001)
for i in range({n}):
    cache.put(f"{tag}{{i}}", tuning.TileConfig(block_q=32, block_k=64),
              10.0, model_hbm_bytes=1e6, device_kind="Some Accelerator X1")
"""


def test_cache_puts_from_two_processes_all_survive(tmp_path):
    """Two processes (the ranks of a sharded launch) put different keys
    into one cache file at once: every key and every calibration sample
    survives, and no temporary file is left."""
    path = tmp_path / "shared.json"
    n = 200
    procs = [subprocess.Popen([sys.executable, "-c", _PUTTER.format(
        src=str(ROOT / "src"), path=str(path), n=n, tag=tag)])
        for tag in ("a", "b")]
    deadline = time.monotonic() + 60
    while not all(pathlib.Path(f"{path}.{t}.ready").exists() for t in "ab"):
        assert time.monotonic() < deadline
        time.sleep(0.01)
    pathlib.Path(f"{path}.go").touch()     # both start putting at once
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    doc = json.loads(path.read_text())
    assert set(doc["entries"]) == {f"{t}{i}" for t in "ab" for i in range(n)}
    assert doc["calibration"]["Some Accelerator X1"]["samples"] == 2 * n
    assert not list(tmp_path.glob("*.tmp"))


def test_winner_beats_the_analytic_choice_only_beyond_the_spread():
    """A timed candidate replaces the analytic choice only where it is
    faster by more than either one's spread between samples."""
    a, b = (64, 64), (32, 64)
    assert tuning._winner({a: (10.0, 1.0), b: (9.5, 0.2)}, a) == (a, 10.0)
    assert tuning._winner({a: (10.0, 0.2), b: (9.5, 0.6)}, a) == (a, 10.0)
    assert tuning._winner({a: (10.0, 0.2), b: (9.5, 0.2)}, a) == (b, 9.5)
    assert tuning._winner({a: (9.0, 3.0), b: (9.5, 0.2)}, a) == (a, 9.0)
    assert tuning._winner({b: (9.5, 0.2)}, a) == (b, 9.5)


def test_model2_rank_resolves_its_tiles_as_a_shard(monkeypatch):
    """A rank of a step with a "model" axis of 2 (its heads cut) runs its
    attention as one of 2 shards: ``_rank_cfg`` sets ``tp_shards`` and
    ``ops.flash_attention`` is called with ``shards=2``. With autotuning
    off the rank keeps 64 x 64 tiles at train-dp2tp2's rank layer
    (granite-3-2b's 32 / 8 heads of 64 cut in two, 2048 rows)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.distributed import comm
    from repro_torch.distributed.meshes import Group
    from repro_torch.distributed.sharding import TrainShard
    from repro_torch.models import attention_layer as al
    from repro_torch.train import steps

    cfg = dataclasses.replace(reduced_config("olmo-1b"), attn_impl="pallas")
    shard = TrainShard(
        model=Group(ranks=(0, 1), index=0, pg=None, backend="gloo"),
        data=Group(ranks=(0,), index=0, pg=None, backend="gloo"),
        heads=True, ff=True, vocab=False, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, vocab_size=cfg.vocab_size,
        batch_sharded=False)
    rank = steps._rank_cfg(cfg, shard)
    assert (rank.tp_shards, rank.num_heads) == (2, cfg.num_heads // 2)
    assert steps._rank_cfg(cfg, dataclasses.replace(
        shard, heads=False)).tp_shards == 1
    seen = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: seen.append(k["shards"])
                        or real(*a, **k))
    monkeypatch.setattr(comm, "all_reduce_sum", lambda x, group: x)
    gen = torch.Generator().manual_seed(0)
    params = al.init_attention(rank, torch.float32, generator=gen,
                               device="cpu")
    x = torch.randn(2, 32, cfg.d_model, generator=gen, requires_grad=True)
    al.apply_attention(params, rank, x, shard=shard).sum().backward()
    assert seen == [2]
    full = get_config("granite-3-2b")
    assert not tuning.autotune_enabled()
    for backward in (False, True):
        got = tuning.resolve_tiles(
            None, None, sq=2048, sk=2048, head_dim=full.head_dim,
            dtype=torch.bfloat16, mask_class="causal", backward=backward,
            heads_q=full.num_heads // 2, heads_kv=full.num_kv_heads // 2,
            shards=2, device="cpu")
        assert (got.block_q, got.block_k, got.source) == (64, 64, "analytic")


@pytest.mark.parametrize("n_q_group,block_k,d,in_elt", [
    (8, 16, 64, 4), (256, 128, 128, 2), (40, 64, 96, 4), (1, 8, 16, 2)])
def test_working_set_counts_bit_equal_reference(n_q_group, block_k, d, in_elt):
    assert io_model.kv_major_working_set_bytes(
        n_q_group, block_k, d, in_elt=in_elt) == \
        jio.kv_major_working_set_bytes(n_q_group, block_k, d, in_elt=in_elt)
    assert io_model.decode_working_set_bytes(block_k, d, in_elt) == \
        jio.decode_working_set_bytes(block_k, d, in_elt)
    assert io_model.DEFAULT_SRAM_BUDGET == io_model.H100_SMEM_PER_BLOCK


# ---------------------------------------------------------------------------
# the analytic chooser (TestAnalyticChooser)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("backward", [False, True])
def test_small_shapes_choose_as_the_reference(shards, backward):
    """sq, sk <= 64: both packages take multiples of 8 rows; under a budget
    every candidate fits in both, the choices are equal where the
    reference keeps the q-major order (always at 8 and 16 heads); at 1-3
    heads, where the grid rule shrinks block_q under shards, the
    reference's kv-major order re-picks block_k only, so block_q is
    compared there."""
    budget = 1 << 40
    shrunk = 0
    for sq in (8, 24, 40, 64):
        for sk in (8, 33, 64):
            for hq in (1, 2, 3, 8, 16):
                want = jtuning.choose_tile_config(
                    sq, sk, 32, backward=backward, sram_budget_bytes=budget,
                    heads_q=hq, heads_kv=hq, shards=shards)
                got = tuning.choose_tile_config(
                    sq, sk, 32, backward=backward, sram_budget_bytes=budget,
                    heads_q=hq, heads_kv=hq, shards=shards)
                assert not got.kv_major
                assert not (hq >= 8 and want.kv_major)
                assert got.block_q == want.block_q, (sq, sk, hq)
                assert want.kv_major or got.block_k == want.block_k
                shrunk += got.block_q < tuning.round_block(64, sq)
    assert (shrunk > 0) == (shards > 1)


@pytest.mark.parametrize("n", [128, 256, 512, 1024, 2048, 4096, 32768])
@pytest.mark.parametrize("d", [64, 128])
def test_sweep_shapes_aligned_and_fit(n, d):
    for dtype in ("float32", "bfloat16"):
        cfg = tuning.choose_tile_config(n, n, d, dtype=dtype)
        assert cfg.block_q % tuning.ROW_ALIGN == 0
        assert cfg.block_k % tuning.ROW_ALIGN == 0
        assert max(cfg.block_q, cfg.block_k) <= tuning.MAX_TILE
        assert io_model.attention_working_set_bytes(
            cfg.block_q, cfg.block_k, d, bf16=dtype == "bfloat16") \
            <= tuning.sram_budget()


@pytest.mark.parametrize("n", [1024, 4096, 32768])
def test_chosen_hbm_never_worse_than_fixed_32(n):
    cfg = tuning.choose_tile_config(n, n, 64)
    chosen = io_model.flash_hbm_bytes_tiled(n, n, 64, 1, 1, cfg.block_q,
                                            cfg.block_k)
    assert chosen <= io_model.flash_hbm_bytes_tiled(n, n, 64, 1, 1, 32, 32)


def test_budget_shrinks_tiles():
    """fp32 shared memory grows with the tiles (the bf16 bodies stage
    64-row tiles whatever the tile)."""
    big = tuning.choose_tile_config(4096, 4096, 64)
    small = tuning.choose_tile_config(4096, 4096, 64,
                                      sram_budget_bytes=48 * 1024)
    assert (small.block_q, small.block_k) < (big.block_q, big.block_k)
    assert io_model.attention_working_set_bytes(
        small.block_q, small.block_k, 64) <= 48 * 1024


def test_pinned_axis_respected():
    cfg = tuning.choose_tile_config(2048, 2048, 64, block_q=32)
    assert (cfg.block_q, cfg.block_k) == (32, 64)


def test_working_set_monotone_in_tiles():
    ws = io_model.attention_working_set_bytes
    assert ws(32, 32, 64) < ws(64, 32, 64) < ws(64, 64, 64)
    assert ws(32, 32, 64, backward=False) < ws(32, 32, 64)


def test_hbm_model_prefers_bigger_q_blocks():
    h = io_model.flash_hbm_bytes_tiled
    assert h(4096, 4096, 64, 1, 1, 64, 64) < h(4096, 4096, 64, 1, 1, 32, 64)


def test_sharded_small_grid_shrinks_block_q():
    """TARGET_GRID_CELLS: 2 local heads over 64 rows keep 8 cells busy only
    at 16-row q tiles."""
    one = tuning.choose_tile_config(64, 64, 64, heads_q=2, shards=1)
    two = tuning.choose_tile_config(64, 64, 64, heads_q=2, shards=2)
    assert one.block_q == 64 and two.block_q == 16
    assert two.block_q == jtuning.choose_tile_config(
        64, 64, 64, heads_q=2, shards=2).block_q


# the (sq, sk, head_dim) of every flash_attention and paged-prefill call
# chip_smoke's paths make, and ragged tails
PATH_SHAPES = [(2048, 2048, 64), (256, 1792, 64), (192, 1600, 64),
               (64, 664, 64), (512, 512, 64), (2048, 2048, 128),
               (256, 1792, 128), (1024, 1024, 64), (64, 1024, 64),
               (2048, 2048, 96), (640, 640, 96), (128, 1088, 64),
               (4096, 4096, 64), (16384, 16384, 64), (100, 37, 64),
               (5, 5, 16), (1, 130, 32)]


@pytest.mark.parametrize("sq,sk,d", PATH_SHAPES)
def test_autotune_off_resolves_the_fixed_tiles(sq, sk, d):
    """With autotuning off and one shard every path keeps the tiles it ran
    before the tuner: (round_block(64, sq), round_block(64, sk)), in both
    dtypes, paged and contiguous, forward and backward; each fits a
    block."""
    assert not tuning.autotune_enabled()
    want = (tuning.round_block(64, sq), tuning.round_block(64, sk))
    for dtype in ("float32", "bfloat16", torch.bfloat16):
        for backward in (False, True):
            for mask in ("causal+seg", "dense", "causal+pos"):
                cfg = tuning.resolve_tiles(None, None, sq=sq, sk=sk,
                                           head_dim=d, dtype=dtype,
                                           mask_class=mask,
                                           backward=backward, heads_q=32,
                                           heads_kv=8, device="cpu")
                assert (cfg.block_q, cfg.block_k) == want
                assert cfg.source == "analytic" and not cfg.kv_major
                assert io_model.attention_working_set_bytes(
                    *want, d, bf16=tuning.elt_bytes(dtype) == 2,
                    backward=backward) <= io_model.H100_SMEM_PER_BLOCK
            for ps in tuning.PAGE_SIZES:
                paged = tuning.resolve_tiles(None, ps, sq=sq, sk=sk,
                                             head_dim=d, dtype=dtype,
                                             backward=backward, paged=True,
                                             device="cpu")
                assert paged.block_q == want[0]
                assert io_model.attention_working_set_bytes(
                    paged.block_q, ps, d, bf16=tuning.elt_bytes(dtype) == 2,
                    paged=True, backward=backward) \
                    <= io_model.H100_SMEM_PER_BLOCK


# ---------------------------------------------------------------------------
# block clamp (TestRoundBlock)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("req,seq,expect", [
    (64, 96, 64), (64, 100, 64), (64, 3, 8), (32, 96, 32), (64, 37, 40),
    (60, 1000, 56), (128, 100, 104)])
def test_round_block_values(req, seq, expect):
    assert tuning.round_block(req, seq) == expect == \
        jtuning.round_block(req, seq)


def test_round_block_always_aligned_and_refuses_zero():
    for req in (8, 60, 64, 250):
        for seq in (1, 3, 7, 100, 130, 999):
            blk = tuning.round_block(req, seq)
            assert blk % tuning.ROW_ALIGN == 0 and blk >= tuning.ROW_ALIGN
    for bad in (0, -8):
        with pytest.raises(ValueError, match="rows"):
            tuning.round_block(bad, 64)


@pytest.mark.parametrize("sq,sk", [(100, 100), (3, 130), (130, 100), (5, 5),
                                   (100, 260)])
def test_ragged_seq_numerics(sq, sk):
    rng = np.random.default_rng(sq * 1000 + sk)
    q, k, v = (rng.standard_normal((2, 2, n, 32)).astype(np.float32)
               for n in (sq, sk, sk))
    causal = sq <= sk
    o = ops.flash_attention(*map(torch.as_tensor, (q, k, v)), causal=causal)
    o_ref = standard_attention(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=2e-3,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# decode geometry (TestDecodeGeometry)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [16, 64, 128, 384, 2048, 4096])
def test_decode_auto_always_divisor_valid(capacity):
    for on_card in (False, True):
        blk, splits = tuning.resolve_decode_geometry(
            capacity, None, None, head_dim=64, shards=2, on_card=on_card)
        assert capacity % blk == 0 and (capacity // blk) % splits == 0
        assert splits <= (tuning.MAX_DECODE_SPLITS if on_card else 16)


def test_decode_explicit_still_validates():
    with pytest.raises(ValueError, match="multiple of block_k"):
        tuning.resolve_decode_geometry(384, 256, 1, head_dim=64)


@pytest.mark.parametrize("capacity,splits", [(768, 3), (4096, 16), (256, 2)])
def test_decode_pinned_splits_constrain_auto_block(capacity, splits):
    blk, got = tuning.resolve_decode_geometry(capacity, None, splits,
                                              head_dim=64)
    assert got == splits and capacity % blk == 0
    assert (capacity // blk) % splits == 0


def test_decode_pinned_splits_impossible_raises():
    with pytest.raises(ValueError, match="num_splits"):
        tuning.resolve_decode_geometry(128, None, 7, head_dim=64)


def test_decode_paged_block_is_the_page():
    blk, splits = tuning.resolve_decode_geometry(192, None, None, head_dim=64,
                                                 page_size=16)
    assert blk == 16 and 12 % splits == 0
    assert (blk, splits) == jtuning.resolve_decode_geometry(
        192, None, None, head_dim=64, page_size=16)
    with pytest.raises(ValueError, match="page_size"):
        tuning.resolve_decode_geometry(192, 128, None, head_dim=64,
                                       page_size=16)
    with pytest.raises(ValueError, match="num_splits"):
        tuning.resolve_decode_geometry(192, None, 8, head_dim=64,
                                       page_size=16)


# ---------------------------------------------------------------------------
# the autotuner and its cache on the plain versions (TestAutotuneCache)
# ---------------------------------------------------------------------------

def _tune(**kw):
    args = dict(dtype=torch.float32, mask_class="causal", backward=False,
                max_candidates=2, device="cpu")
    args.update(kw)
    return tuning.autotune_tiles(128, 128, 16, **args)


def test_autotune_write_then_hit(tuned):
    first = _tune()
    assert first.source == "autotuned"
    blob = json.loads(tuned.read_text())
    (key, entry), = blob["entries"].items()
    assert key == "cpu|float32|16|128|causal"
    assert entry["block_q"] == first.block_q and entry["timed_us"] > 0
    assert sorted(entry["candidates_us"]) == ["64x32", "64x64"]
    assert blob["calibration"]["cpu"]["samples"] == 1
    second = _tune()
    assert second.source == "cache"
    assert (second.block_q, second.block_k) == (first.block_q, first.block_k)
    assert tuning.autotune_cache().get(
        tuning.cache_key("cpu", "float32", 16, 128, "dense")) is None
    cal = tuning.autotune_cache().calibration("cpu")
    assert cal["samples"] == 1 and cal["vs_nominal"] > 0


def test_autotune_partial_pin_constrains_candidates(tuned):
    tuning.configure_tuning(autotune=True)
    cfg = tuning.resolve_tiles(32, None, sq=128, sk=128, head_dim=16,
                               dtype=torch.float32, mask_class="causal",
                               device="cpu")
    assert cfg.block_q == 32 and cfg.source == "autotuned"
    (key, entry), = json.loads(tuned.read_text())["entries"].items()
    assert key.endswith("|bq=32|bwd")
    assert all(c.startswith("32x") for c in entry["candidates_us"])
    again = tuning.resolve_tiles(32, None, sq=128, sk=128, head_dim=16,
                                 dtype=torch.float32, mask_class="causal",
                                 device="cpu")
    assert again.source == "cache" and again.block_q == 32


def test_autotune_backward_keyed_separately(tuned):
    fwd = _tune()
    bwd = _tune(backward=True)
    assert fwd.source == bwd.source == "autotuned"
    entries = json.loads(tuned.read_text())["entries"]
    assert len(entries) == 2
    (bwd_key,) = [k for k in entries if k.endswith("|bwd")]
    assert entries[bwd_key]["timed_us"] > 0
    assert _tune(backward=True).source == "cache"
    assert _tune().source == "cache"


def test_autotune_group_ratio_and_shards_keyed(tuned):
    _tune(heads_q=4, heads_kv=2, shards=2)
    (key,) = json.loads(tuned.read_text())["entries"]
    assert key == "cpu|float32|16|128|causal|tp2|g=2"


def test_resolve_tiles_explicit_skips_cache(tuned):
    tuning.configure_tuning(autotune=True)
    cfg = tuning.resolve_tiles(64, 32, sq=128, sk=128, head_dim=16,
                               dtype=torch.float32, device="cpu")
    assert (cfg.block_q, cfg.block_k, cfg.source) == (64, 32, "explicit")
    assert not tuned.exists()


def test_ops_resolve_through_the_autotuner(tuned):
    """A trainable call resolves (and times) under the |bwd key, an
    inference call under the forward key; the second call of each hits."""
    tuning.configure_tuning(autotune=True)
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, 4, 40, 16)),
                               dtype=torch.float32) for _ in range(3))
    with torch.no_grad():
        ops.flash_attention(q, k, v, causal=True)
    qg = q.clone().requires_grad_()
    ops.flash_attention(qg, k, v, causal=True).sum().backward()
    entries = json.loads(tuned.read_text())["entries"]
    assert sorted(entries) == ["cpu|float32|16|128|causal",
                               "cpu|float32|16|128|causal|bwd"]
    cache = tuning.autotune_cache()
    hits = cache.hits
    with torch.no_grad():
        ops.flash_attention(q, k, v, causal=True)
    assert cache.hits == hits + 1


def test_autotune_contiguous_and_paged_decode(tuned):
    dec = tuning.autotune_decode_geometry(128, 16, dtype=torch.float32,
                                          device="cpu")
    paged = tuning.autotune_decode_geometry(128, 16, dtype=torch.float32,
                                            page_size=16, device="cpu")
    assert dec.source == paged.source == "autotuned"
    entries = json.loads(tuned.read_text())["entries"]
    contig = entries["decode|cpu|float32|16|128|contig"]
    pg = entries["decode|cpu|float32|16|128|paged16"]
    assert len(contig["candidates_us"]) == 4
    assert sorted(pg["candidates_us"]) == ["16x1", "16x2", "16x4", "16x8"]
    assert paged.decode_block_k == 16
    assert 128 % dec.decode_block_k == 0
    assert (128 // dec.decode_block_k) % dec.num_decode_splits == 0
    tuning.configure_tuning(autotune=True)
    assert tuning.resolve_decode_geometry(
        128, None, None, head_dim=16, dtype=torch.float32, page_size=16,
        device="cpu") == (16, paged.num_decode_splits)
    assert tuning.autotune_decode_geometry(
        128, 16, dtype=torch.float32, device="cpu").source == "cache"


def test_decode_candidates_stay_within_a_cluster():
    for cap, ps in ((2048, 16), (4096, 8), (192, 16), (2048, None)):
        for target in (8, 16, 32):
            for blk, s in tuning.decode_candidates(cap, page_size=ps,
                                                   target_splits=target):
                assert 1 <= s <= tuning.MAX_DECODE_SPLITS
                assert cap % blk == 0 and (cap // blk) % s == 0
    assert tuning.decode_candidates(2048, page_size=16) == \
        [(16, 8), (16, 4), (16, 2), (16, 1)]


@pytest.mark.parametrize("chunk,prefix,hq,hkv,sp", [
    (128, 512, 2, 2, 4), (64, 64, 8, 4, 2), (256, 1056, 16, 4, 2)])
def test_sp_strategy_persisted_under_sp_key(tuned, chunk, prefix, hq, hkv, sp):
    """The slab tile equals the reference's where the slab is at most 64
    rows, and the strategy then too; with autotuning on the decision
    persists under |spN and the second resolution hits."""
    analytic = tuning.resolve_sp_strategy(chunk, prefix, 64, heads_q=hq,
                                          heads_kv=hkv, sp=sp)
    if -(-chunk // sp) <= 64:
        want = jtuning.resolve_sp_strategy(chunk, prefix, 64, heads_q=hq,
                                           heads_kv=hkv, sp=sp)
        assert analytic["tiles"].block_q == want["tiles"].block_q
        assert analytic["strategy"] == want["strategy"]
        assert analytic["costs"] == want["costs"]
    tuning.configure_tuning(autotune=True)
    first = tuning.resolve_sp_strategy(chunk, prefix, 64, heads_q=hq,
                                       heads_kv=hkv, sp=sp, device="cpu")
    assert first["source"] == "analytic"
    assert first["tiles"].sp_strategy == first["strategy"]
    (key,) = json.loads(tuned.read_text())["entries"]
    assert key.endswith(f"|causal+seg+pos|sp{sp}")
    again = tuning.resolve_sp_strategy(chunk, prefix, 64, heads_q=hq,
                                       heads_kv=hkv, sp=sp, device="cpu")
    assert again["source"] == "cache"
    assert again["strategy"] == first["strategy"]


def test_smoke_cli_twice_hits_the_cache(tmp_path):
    cache = str(tmp_path / "smoke.json")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cmd = [sys.executable, "-m", "repro_torch.kernels.tuning", "--smoke",
           "--device", "cpu", "--cache", cache, "--sp", "2", "--seq", "128"]
    first = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=300)
    assert first.returncode == 0, first.stderr
    assert "source=autotuned" in first.stdout
    assert "calibration[cpu]" in first.stdout
    second = subprocess.run(cmd + ["--expect-hit"], env=env,
                            capture_output=True, text=True, timeout=300)
    assert second.returncode == 0, second.stderr
    assert "cache_hit=True" in second.stdout and "re-tuned" not in (
        second.stdout + second.stderr)


def test_smoke_cli_without_a_card_raises(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.kernels.tuning", "--smoke",
         "--cache", str(tmp_path / "x.json")],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "torch.cuda.is_available()" in out.stderr
    assert not (tmp_path / "x.json").exists()


# ---------------------------------------------------------------------------
# the launchers' --autotune / --sram-budget
# ---------------------------------------------------------------------------

def test_serve_launcher_takes_the_tuner_flags(tuned):
    from repro_torch.launch import serve
    eng = serve.main(["--smoke", "--device", "cpu", "--autotune",
                      "--sram-budget", "123456"])
    assert tuning.sram_budget() == 123456 and tuning.autotune_enabled()
    assert len(eng.finished) == 3


def test_train_launcher_takes_the_tuner_flags(tuned, tmp_path):
    from repro_torch.launch import train
    trainer = train.main(["--reduced", "--device", "cpu", "--steps", "2",
                          "--seq", "32", "--batch", "2", "--ckpt-every",
                          "100", "--ckpt-dir", str(tmp_path / "ck"),
                          "--autotune", "--sram-budget", "200000"])
    assert tuning.sram_budget() == 200000
    assert len(trainer.history) == 2
    # the launcher's pallas attention resolved (and timed) its tiles
    entries = json.loads(tuned.read_text())["entries"]
    assert any(k.endswith("|bwd") for k in entries)


def test_dryrun_takes_overrides(tuned, tmp_path):
    from repro_torch.launch import dryrun
    out = tmp_path / "d.jsonl"
    assert dryrun.main(["--arch", "olmo-1b", "--shape", "train_4k",
                        "--mesh", "single", "--out", str(out), "--override",
                        "attn_pv_bf16=true,attn_chunk_size=512"]) == 0
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["overrides"] == {"attn_pv_bf16": True, "attn_chunk_size": 512}
    assert dryrun.parse_overrides("a=1,b=true,c=x") == \
        {"a": 1, "b": True, "c": "x"}
    assert not tuned.exists()
    # no cell resolves a tile, so the dry-run has no tuner flags
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "olmo-1b", "--autotune"])


# ---------------------------------------------------------------------------
# tile invariance (tests/test_config_invariance.py)
# ---------------------------------------------------------------------------

TILES = [(bq, bk) for bq in (8, 24, 32, 64) for bk in (8, 24, 32, 64)]
B, HQ, HKV, S, D = 2, 4, 2, 72, 16


@functools.lru_cache(maxsize=None)
def _case(segments: bool):
    """Inputs, cotangent, segment ids and the reference's output and
    gradients (standard attention through jax.vjp)."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, HQ, S, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, HKV, S, D)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((B, HQ, S, D)).astype(np.float32)
    seg = (np.stack([np.repeat([1, 2, 3], [30, 20, 22]),
                     np.repeat([1, 2], [50, 22])]).astype(np.int32)
           if segments else None)
    fn = functools.partial(standard_attention, causal=True,
                           segment_ids=None if seg is None
                           else jnp.asarray(seg))
    o, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(do))
    return (q, k, v, do, seg), [np.asarray(x) for x in (o, *grads)]


def _port(bq, bk, segments):
    (q, k, v, do, seg), _ = _case(segments)
    qt, kt, vt = (torch.as_tensor(x).requires_grad_() for x in (q, k, v))
    o = ops.flash_attention(qt, kt, vt, causal=True, block_q=bq, block_k=bk,
                            segment_ids=None if seg is None
                            else torch.as_tensor(seg))
    grads = torch.autograd.grad(o, (qt, kt, vt), torch.as_tensor(do))
    return [x.detach().numpy() for x in (o, *grads)]


@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("bq,bk", TILES)
def test_tile_invariance(bq, bk, segments):
    got = _port(bq, bk, segments)
    for a, b in zip(got, _port(64, 64, segments)):
        np.testing.assert_allclose(a, b, **INV)
    for a, want in zip(got, _case(segments)[1]):
        np.testing.assert_allclose(a, want, **INV)
