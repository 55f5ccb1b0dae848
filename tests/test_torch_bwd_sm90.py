"""The sm90 backward pair (``csrc/flash_bwd_sm90.cu``) on the CPU: which body
a backward call takes (``flash_attention.backward_body``, a static rule on
dtype, head dim, tiles, pages and walk length), the CTA tile the analytic
chooser picks for it (``tuning.sm90_bwd_rows``) at every shape the paths
and ``PERF.md`` hold it at (the paged pair's grids too), a failed sm90
launch raising instead of running another body (contiguous and paged), the
entry points built and typed, and the function it computes at its own tiles (bf16-scope head dims 96
and 128, 64 x 64 blocks, GQA 5 and 8) against the JAX package: the port's
plain path and the JAX kernels (Pallas in interpret mode) on the same numpy
inputs, gradients scaled by their max within rtol 1e-4, atol 1e-5 (fp32,
summation order; the tolerance of ``tests/test_kernels_flash.py``). The
kernel itself runs only on the card: ``tests/test_torch_gpu.py``."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build, ops, tuning
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16


# ---------------------------------------------------------------------------
# the body rule
# ---------------------------------------------------------------------------

TILES = ((64, 64), (32, 32), (16, 16), (24, 40), (64, 32))


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("tiles", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("d", tuning.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_backward_body_rule(dtype, d, tiles, paged):
    """CPU tensors take the plain version; on the card bf16 at d 64 / 96 /
    128 over 64-row q blocks takes the sm90 body, its key blocks 64 rows
    (contiguous) or pages of 8, 16, 32 or 64 rows (paged: ``block_k`` is
    the page); every other bf16 call the mma.sync body and fp32 the scalar
    body."""
    bq, bk = tiles
    kw = dict(dtype=dtype, head_dim=d, block_q=bq, block_k=bk, paged=paged)
    assert fa.backward_body(on_card=False, **kw) == "plain"
    k_ok = bk in tuning.PAGE_SIZES if paged else bk == 64
    if dtype == F32:
        want = "scalar"
    elif d in (64, 96, 128) and bq == 64 and k_ok:
        want = "sm90"
    else:
        want = "mma"
    assert fa.backward_body(on_card=True, **kw) == want


@pytest.mark.parametrize("block_q", [64, 32, 16])
@pytest.mark.parametrize("page", [8, 16, 32, 64])
@pytest.mark.parametrize("d", tuning.KERNEL_HEAD_DIMS)
def test_paged_backward_body_rule(d, page, block_q):
    """The paged pair in bf16 (``flash_prefill_paged_backward``): the sm90
    body at d 64 / 96 / 128 with 64-row q blocks at every page it takes;
    the mma.sync body at d 16 / 32 and for smaller q blocks. The chunk and
    prefix of the paged grad path: 3 q blocks, 98 page slots."""
    nk = -(-1536 // page) + 2
    body = fa.backward_body(on_card=True, dtype=BF16, head_dim=d,
                            block_q=block_q, block_k=page, paged=True, nq=3,
                            nk=nk)
    want = "sm90" if d in (64, 96, 128) and block_q == 64 else "mma"
    assert body == want


@pytest.mark.parametrize("nq,nk", [(2048, 2048), (2049, 64), (64, 2049)])
def test_backward_body_walk_limit(nq, nk):
    """A layout row or column longer than the sm90 body's compacted walk
    (``SM90_MAX_WALK`` blocks, 131072 rows) takes the mma.sync body."""
    body = fa.backward_body(on_card=True, dtype=BF16, head_dim=64, block_q=64,
                            block_k=64, paged=False, nq=nq, nk=nk)
    fits = max(nq, nk) <= tuning.SM90_MAX_WALK
    assert body == ("sm90" if fits else "mma")


# (q blocks, page slots, page): the paged walks are the q blocks of a
# layout column (dkv) and the 64-key tiles of a row, ceil(slots * page / 64)
# (dq); at most SM90_MAX_WALK each
PAGED_WALKS = {
    "tiles_at_limit_page8": (3, 2048 * 8, 8, True),
    "tiles_past_limit_page8": (3, 2048 * 8 + 1, 8, False),
    "tiles_at_limit_page64": (2, 2048, 64, True),
    "tiles_past_limit_page64": (2, 2049, 64, False),
    "q_blocks_at_limit": (2048, 10, 16, True),
    "q_blocks_past_limit": (2049, 10, 16, False),
}


@pytest.mark.parametrize("name", sorted(PAGED_WALKS))
def test_paged_backward_body_walk_limit(name):
    """A paged call whose 64-key tiles or q blocks exceed the sm90 body's
    compacted walk takes the mma.sync body."""
    nq, slots, page, fits = PAGED_WALKS[name]
    body = fa.backward_body(on_card=True, dtype=BF16, head_dim=128,
                            block_q=64, block_k=page, paged=True, nq=nq,
                            nk=slots)
    assert body == ("sm90" if fits else "mma")


# ---------------------------------------------------------------------------
# the CTA tile
# ---------------------------------------------------------------------------

# (b, hq, hkv, S_q, S_k, d) of each path's attention layer and PERF.md's
# #2 / #3 rows, and the (dq, dkv) CTA rows on an H100's 132 SMs
SHAPE_ROWS = {
    "train": ((4, 32, 8, 2048, 2048, 64), (128, 128)),
    "bert": ((56, 16, 16, 512, 512, 64), (128, 128)),
    "olmo": ((4, 16, 16, 2048, 2048, 128), (128, 128)),
    "hymba_train": ((4, 25, 5, 2048, 2048, 64), (128, 128)),
    "seamless": ((4, 16, 16, 1024, 1024, 64), (128, 128)),
    "seamless_cross": ((4, 16, 16, 64, 1024, 64), (64, 128)),
    "phi3v_train": ((4, 32, 32, 2048, 2048, 96), (128, 128)),
    "dp2tp2": ((2, 16, 4, 2048, 2048, 64), (128, 64)),
    "ep4": ((4, 4, 4, 2048, 2048, 128), (128, 128)),
    "bs4k": ((4, 12, 12, 4096, 4096, 64), (128, 128)),
    "bs16k": ((1, 12, 12, 16384, 16384, 64), (128, 128)),
    "one_head_2k": ((1, 1, 1, 2048, 2048, 64), (64, 64)),
    "one_head_2k_d128": ((1, 1, 1, 2048, 2048, 128), (64, 128)),
}


# the paged pair's grids: (b, hq, hkv, q blocks, page slots, page, d) of
# chip_smoke's paged grad path (granite's heads; qwen3-32b's, n_rep 8 at
# d 128) and the (dq, dkv) CTA rows; dkv counts 64-key page groups
PAGED_SHAPE_ROWS = {
    "paged_grad": ((2, 32, 8, 3, 98, 16, 64), (64, 128)),
    "paged_grad_qwen3": ((2, 64, 8, 3, 98, 16, 128), (128, 128)),
    "one_row_page64_d96": ((1, 16, 4, 4, 12, 64, 96), (64, 64)),
}


@pytest.mark.parametrize("name", sorted(PAGED_SHAPE_ROWS))
def test_sm90_cta_tile_rule_paged(name):
    """The same rule over the paged grids: dq (b, hq, q blocks), dkv (b,
    hkv, ceil(slots * page / 64) page groups); dkv at d 128 always 128."""
    (b, hq, hkv, nq, slots, page, d), (dq_rows, dkv_rows) = \
        PAGED_SHAPE_ROWS[name]
    groups = -(-slots * page // 64)
    assert tuning.sm90_bwd_rows(b, hq, nq, kernel="dq",
                                head_dim=d) == dq_rows
    assert tuning.sm90_bwd_rows(b, hkv, groups, kernel="dkv",
                                head_dim=d) == dkv_rows


@pytest.mark.parametrize("name", sorted(SHAPE_ROWS))
def test_sm90_cta_tile_rule(name):
    """128 rows where the 128-row grid (batch x heads x ceil(blocks / 2))
    still gives each of the 132 SMs a CTA, else 64; dkv at d 128 always
    128."""
    (b, hq, hkv, sq, sk, d), (dq_rows, dkv_rows) = SHAPE_ROWS[name]
    assert tuning.sm90_bwd_rows(b, hq, sq // 64, kernel="dq",
                                head_dim=d) == dq_rows
    assert tuning.sm90_bwd_rows(b, hkv, sk // 64, kernel="dkv",
                                head_dim=d) == dkv_rows


def test_sm90_cta_tile_rule_edges():
    assert tuning.H100_SMS == 132
    assert tuning.sm90_bwd_rows(1, 132, 2) == 128      # exactly one wave
    assert tuning.sm90_bwd_rows(1, 131, 2) == 64
    assert tuning.sm90_bwd_rows(1, 66, 3) == 128       # ceil(3 / 2) = 2
    assert tuning.sm90_bwd_rows(1, 66, 3, num_sms=140) == 64


# ---------------------------------------------------------------------------
# a failed sm90 launch raises; nothing falls back
# ---------------------------------------------------------------------------

class _StubLib:
    """A loaded library whose every entry returns ``err`` and records the
    call."""

    def __init__(self, err):
        self.calls = []
        for name in ("flash_bwd_sm90_dq", "flash_bwd_sm90_dkv",
                     "flash_bwd_sm90_dq_paged", "flash_bwd_sm90_dkv_paged",
                     "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dq_paged",
                     "flash_bwd_dkv_paged"):
            setattr(self, name, self._entry(name, err))
        self.flash_bwd_sm90_error_string = lambda e: b"stub error"
        self.flash_bwd_error_string = lambda e: b"stub error"

    def _entry(self, name, err):
        def call(*args):
            self.calls.append((name, args))
            return err
        return call


def _sm90_operands(b=1, hq=4, hkv=2, s=128, d=64):
    q = torch.zeros((b, hq, s, d), dtype=BF16)
    kv = torch.zeros((b, hkv, s, d), dtype=BF16)
    stats = torch.zeros((b, hq, s))
    return fa.BackwardOperands(1, d, (q, kv, kv, q, stats, stats, stats), (),
                               (0,) * 40, "sm90", (b, hq, hkv, s // 64, s // 64))


def _sm90_paged_operands(b=2, hq=32, hkv=8, nq=3, slots=98, page=16, d=64):
    """The operands of a paged call at chip_smoke's paged grad shape; the
    page list is the last of ``extra`` and the args end in (page list,
    num_pages), as ``prepare_backward`` lays them out."""
    q = torch.zeros((b, hq, nq * 64, d), dtype=BF16)
    pool = torch.zeros((hkv, 400, page, d), dtype=BF16)
    stats = torch.zeros((b, hq, nq * 64))
    page_list = torch.zeros((b, slots), dtype=torch.int32)
    return fa.BackwardOperands(1, d, (q, pool, pool, q, stats, stats, stats),
                               (page_list,), (0,) * 31 + (0, 400), "sm90",
                               (b, hq, hkv, nq, slots))


@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_sm90_paged_launch_error_raises_without_fallback(monkeypatch, which):
    """A failed sm90 paged launch raises with its counter's name; neither
    flash_bwd.cu's paged entry nor any other body is tried, and nothing is
    counted."""
    sm90, mma = _StubLib(700), _StubLib(0)
    monkeypatch.setattr(fa, "_sm90_lib", lambda: sm90)
    monkeypatch.setattr(fa, "_bwd_lib", lambda: mma)
    monkeypatch.setattr(fa, "_num_sms", lambda device: 132)
    before = dict(fa.LAUNCHES)
    launch = fa.launch_dq_paged if which == "dq" else fa.launch_dkv_paged
    with pytest.raises(RuntimeError, match=f"flash_bwd_{which}_paged_sm90 "
                                           "launch failed: CUDA error 700"):
        launch(_sm90_paged_operands())
    assert [c[0] for c in sm90.calls] == [f"flash_bwd_sm90_{which}_paged"]
    assert mma.calls == []
    assert fa.LAUNCHES == before


@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_sm90_paged_launch_passes_the_chosen_cta_tile(monkeypatch, which):
    """The last argument of an sm90 paged launch is ``sm90_bwd_rows`` of
    the paged grid (dq 64 rows, dkv 128 at the paged grad shape); the
    (page list, num_pages) of the args come before it; ``_mma_body`` takes
    flash_bwd.cu's paged entry instead."""
    sm90, mma = _StubLib(0), _StubLib(0)
    monkeypatch.setattr(fa, "_sm90_lib", lambda: sm90)
    monkeypatch.setattr(fa, "_bwd_lib", lambda: mma)
    monkeypatch.setattr(fa, "_num_sms", lambda device: 132)
    monkeypatch.setattr(fa, "LAUNCHES", {n: 0 for n in fa.LAUNCHES})
    launch = fa.launch_dq_paged if which == "dq" else fa.launch_dkv_paged
    ops_ = _sm90_paged_operands()
    launch(ops_)
    args = sm90.calls[-1][1]
    assert args[-1] == (64 if which == "dq" else 128)
    assert args[-3:-1] == (0, 400) and len(args) == 45
    assert fa.LAUNCHES[f"flash_bwd_{which}_paged_sm90"] == 1
    launch(ops_, _mma_body=True)
    assert [c[0] for c in mma.calls] == [f"flash_bwd_{which}_paged"]
    assert fa.LAUNCHES[f"flash_bwd_{which}_paged"] == 1
    assert fa.LAUNCHES[f"flash_bwd_{which}_paged_sm90"] == 1


@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_sm90_launch_error_raises_without_fallback(monkeypatch, which):
    sm90, mma = _StubLib(700), _StubLib(0)
    monkeypatch.setattr(fa, "_sm90_lib", lambda: sm90)
    monkeypatch.setattr(fa, "_bwd_lib", lambda: mma)
    monkeypatch.setattr(fa, "_num_sms", lambda device: 132)
    before = dict(fa.LAUNCHES)
    launch = fa.launch_dq if which == "dq" else fa.launch_dkv
    with pytest.raises(RuntimeError, match=f"flash_bwd_{which}_sm90 launch "
                                           "failed: CUDA error 700"):
        launch(_sm90_operands())
    assert [c[0] for c in sm90.calls] == [f"flash_bwd_sm90_{which}"]
    assert mma.calls == []                   # no other body was tried
    assert fa.LAUNCHES == before             # a failed launch counts nothing


@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_sm90_launch_passes_the_chosen_cta_tile(monkeypatch, which):
    """The last argument of an sm90 launch is ``sm90_bwd_rows`` of the
    call's grid; ``_mma_body`` takes flash_bwd.cu's entry instead."""
    sm90, mma = _StubLib(0), _StubLib(0)
    monkeypatch.setattr(fa, "_sm90_lib", lambda: sm90)
    monkeypatch.setattr(fa, "_bwd_lib", lambda: mma)
    monkeypatch.setattr(fa, "_num_sms", lambda device: 132)
    monkeypatch.setattr(fa, "LAUNCHES", {n: 0 for n in fa.LAUNCHES})
    launch = fa.launch_dq if which == "dq" else fa.launch_dkv
    ops_ = _sm90_operands(b=2, hq=16, hkv=4, s=2048)    # dp2tp2's rank layer
    launch(ops_)
    assert sm90.calls[-1][1][-1] == (128 if which == "dq" else 64)
    assert fa.LAUNCHES[f"flash_bwd_{which}_sm90"] == 1
    launch(ops_, _mma_body=True)
    assert [c[0] for c in mma.calls] == [f"flash_bwd_{which}"]
    assert fa.LAUNCHES[f"flash_bwd_{which}"] == 1


def test_sm90_source_is_built_and_typed(monkeypatch):
    """``build_all`` starts one nvcc for the sm90 source beside the others,
    and the wrapper types the four entries: the contiguous pair with the
    CTA tile appended, the paged pair with (page list, num_pages) and then
    the CTA tile."""
    assert "flash_bwd_sm90" in build.SOURCES
    assert (build.CSRC / "flash_bwd_sm90.cu").exists()
    entries = ("flash_bwd_sm90_dq", "flash_bwd_sm90_dkv",
               "flash_bwd_sm90_dq_paged", "flash_bwd_sm90_dkv_paged")
    src = (build.CSRC / "flash_bwd_sm90.cu").read_text()
    for name in entries:
        assert f"int {name}(FLASH_BWD_SM90_ARGS" in src
    lib = type("Lib", (), {})()
    for name in entries:
        setattr(lib, name, type("Fn", (), {})())
    monkeypatch.setattr(build, "load", lambda name: lib)
    fa._sm90_lib()
    for name in entries[:2]:
        fn = getattr(lib, name)
        assert fn.restype is ctypes.c_int
        assert fn.argtypes[-1] is ctypes.c_int and len(fn.argtypes) == 43
    for name in entries[2:]:
        fn = getattr(lib, name)
        assert fn.restype is ctypes.c_int
        assert len(fn.argtypes) == 45
        assert fn.argtypes[-3:] == [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int]


# ---------------------------------------------------------------------------
# the function at the sm90 body's tiles, against the JAX package
# ---------------------------------------------------------------------------

JAX_CASES = {
    # name: (b, hq, hkv, sq, sk, d, kwargs)
    "d96_gqa5_causal": (1, 5, 1, 128, 128, 96, dict(causal=True)),
    "d128_gqa8_cross": (1, 8, 1, 64, 192, 128, dict(causal=False)),
    "d64_segments_dropout": (1, 4, 2, 128, 128, 64, dict(
        causal=True, segments=True, dropout_p=0.1, dropout_seed=7)),
}


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_grads_at_sm90_tiles_match_jax(name):
    """``ops.flash_attention`` at 64 x 64 blocks (the plain path on the
    CPU; the sm90 pair on the card in bf16) against the JAX op's
    gradients under ``jax.grad``."""
    b, hq, hkv, sq, sk, d, kw = JAX_CASES[name]
    rng = np.random.default_rng(len(name))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v, do = f(b, hq, sq, d), f(b, hkv, sk, d), f(b, hkv, sk, d), \
        f(b, hq, sq, d)
    kw = dict(kw)
    if kw.pop("segments", False):
        seg = np.zeros((b, sq), np.int32)
        seg[:, 50:] = 1
        seg[:, 100:] = 2
        kw["segment_ids"] = seg
    jkw = {n: jnp.asarray(x) if isinstance(x, np.ndarray) else x
           for n, x in kw.items()}
    tkw = {n: torch.as_tensor(x) if isinstance(x, np.ndarray) else x
           for n, x in kw.items()}
    blocks = dict(block_q=64, block_k=64)

    def jloss(q_, k_, v_):
        return jnp.sum(jops.flash_attention(q_, k_, v_, **blocks, **jkw) * do)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    to = ops.flash_attention(*leaves, **blocks, **tkw)
    tg = torch.autograd.grad(to, leaves, torch.as_tensor(do))
    for g, w in zip(tg, jg):
        w = np.asarray(w)
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy() / scale, w / scale, rtol=1e-4,
                                   atol=1e-5)
