"""The sm90 forward (``csrc/flash_fwd_sm90.cu``) on the CPU: which body a
forward call takes (``flash_attention.forward_body``, a static rule on dtype,
head dim, tiles and paging; dropout does not change it), the CTA mode the
chooser picks for it (``tuning.sm90_fwd_rows`` / ``sm90_fwd_splits``) at
every shape ``PERF.md`` holds #1 and #4 at, a failed sm90 launch raising
instead of running another body, and the function it computes at its own
tiles (head dims 96 and 128, 64 x 64 blocks, GQA 5 and 8, causal packed
documents, a window, a kv_mask, dropout; paged at pages of 8 and 16 with a
dead page and a chunk's q_offset) against the JAX package: the port's
plain path and the JAX kernels (Pallas in interpret mode) on the same
numpy inputs, o, m and l within atol 1e-5 (fp32, summation order; the
repository's attention tolerance), l also within 1e-5 relative: it sums up
to ~140 probabilities to values near 15, where the two sides' sum orders
differ by ~1.5e-6 relative. The kernel itself runs only on the card:
``tests/test_torch_gpu.py``."""

import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masks as JM
from repro.kernels import flash_attention as jfa
from repro_torch.core import masks as TM
from repro_torch.kernels import build, tuning
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16
ATOL = 1e-5
L_RTOL = 1e-5   # l: a sum of up to ~140 terms near 15 (see the docstring)


# ---------------------------------------------------------------------------
# the body rule
# ---------------------------------------------------------------------------

# (block_q, block_k, nq, nk): 64-row blocks, smaller blocks, one short
# block on either axis, a short block that is no multiple of 8
TILES = ((64, 64, 4, 4), (32, 32, 4, 4), (16, 16, 2, 2), (24, 40, 3, 4),
         (64, 32, 4, 2), (40, 64, 1, 4), (64, 24, 4, 1), (16, 16, 1, 1),
         (64, 20, 2, 1))


@pytest.mark.parametrize("kv", ["contiguous", "contiguous_dropout", "paged"])
@pytest.mark.parametrize("tiles", TILES, ids=lambda t: "x".join(map(str, t)))
@pytest.mark.parametrize("d", tuning.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_forward_body_rule(dtype, d, tiles, kv):
    """CPU tensors take the plain version; on the card bf16 at d 64 / 96 /
    128 over 64-row q blocks (or one block) and 64-key blocks (or one block
    of a multiple of 8 keys), or pages, takes the sm90 body; every other
    bf16 call the mma.sync body, fp32 the scalar body. Dropout (contiguous
    K/V only: paged K/V never take it) does not enter the rule."""
    paged = kv == "paged"
    bq, bk, nq, nk = tiles
    kw = dict(dtype=dtype, head_dim=d, block_q=bq, block_k=bk, paged=paged,
              nq=nq, nk=nk)
    assert fa.forward_body(on_card=False, **kw) == "plain"
    q_ok = bq == 64 or nq == 1
    k_ok = paged or bk == 64 or (nk == 1 and bk % 8 == 0)
    if dtype == F32:
        want = "scalar"
    elif d in (64, 96, 128) and q_ok and k_ok:
        want = "sm90"
    else:
        want = "mma"
    assert fa.forward_body(on_card=True, **kw) == want


@pytest.mark.parametrize("paged,nk,block_k", [(False, 1024, 64),
                                              (False, 1025, 64),
                                              (True, 4096, 16),
                                              (True, 4097, 16)])
def test_forward_body_walk_limit(paged, nk, block_k):
    """A walk longer than the sm90 body's compacted list
    (``SM90_FWD_MAX_WALK`` 64-key tiles, 65536 keys) takes the mma.sync
    body."""
    body = fa.forward_body(on_card=True, dtype=BF16, head_dim=64, block_q=64,
                           block_k=block_k, paged=paged, nq=4, nk=nk)
    fits = -(-nk * block_k // 64) <= tuning.SM90_FWD_MAX_WALK
    assert body == ("sm90" if fits else "mma")


# ---------------------------------------------------------------------------
# the CTA mode
# ---------------------------------------------------------------------------

# (b, hq, q rows, keys) of #1 and #4 at the shapes PERF.md holds them at
# (#4's keys: its page slots times the page, 1536 + 600 tokens at page 16 and
# two dead slots), and the (rows, splits) of their CTA mode on an H100's 132
# SMs
SHAPE_MODES = {
    "serve_packed_prefill": ((1, 32, 2048, 2048), (128, 1)),
    "serve_paged_chunks": ((1, 32, 256, 2176), (64, 1)),
    "train": ((4, 32, 2048, 2048), (128, 1)),
    "bert": ((56, 16, 512, 512), (128, 1)),
    "olmo": ((4, 16, 2048, 2048), (128, 1)),
    "hymba_train": ((4, 25, 2048, 2048), (128, 1)),
    "seamless": ((4, 16, 1024, 1024), (128, 1)),
    "seamless_cross": ((4, 16, 64, 1024), (64, 1)),
    "phi3v_train": ((4, 32, 2048, 2048), (128, 1)),
    "phi3v_prefill": ((4, 32, 640, 640), (128, 1)),
    "dp2tp2": ((2, 16, 2048, 2048), (128, 1)),
    "ep4": ((4, 4, 2048, 2048), (128, 1)),
    "bs4k": ((4, 12, 4096, 4096), (128, 1)),
    "bs16k": ((1, 12, 16384, 16384), (128, 1)),
    "qwen3_paged_chunk": ((1, 64, 256, 2176), (128, 1)),
    "olmoe_paged_chunk": ((1, 16, 256, 2176), (64, 1)),
    "tp2_paged_chunk": ((1, 16, 256, 2176), (64, 1)),
    "sp2_slab": ((1, 32, 128, 2176), (64, 1)),
    "one_head_2k": ((1, 1, 2048, 2048), (64, 1)),
    "one_head_short_walk": ((1, 1, 64, 128), (64, 1)),
    # a 64-row chunk of 8 heads against a 16k-token prefix: 8 CTAs
    "chunk_against_16k_prefix": ((1, 8, 64, 16384), (64, 8)),
}


@pytest.mark.parametrize("name", sorted(SHAPE_MODES))
def test_sm90_fwd_mode_rule(name):
    """128 rows where the 128-row grid (batch x heads x ceil(blocks / 2))
    fills more than half of the 132 SMs, else 64; the walk split over a
    cluster only where the 64-row CTAs fill at most half the card, into as
    many CTAs as fit it once, at most 8, each keeping 32 kv tiles or more
    (the rule ``scripts/sm90_fwd_probe.py`` set, PERF.md §6)."""
    (b, hq, sq, sk), (rows, splits) = SHAPE_MODES[name]
    nq, tiles = -(-sq // 64), -(-sk // 64)
    assert tuning.sm90_fwd_rows(b, hq, nq) == rows
    assert tuning.sm90_fwd_splits(b, hq, nq, tiles) == splits


def test_sm90_fwd_mode_rule_edges():
    assert tuning.sm90_fwd_rows(1, 67, 2) == 128         # over half the card
    assert tuning.sm90_fwd_rows(1, 66, 2) == 64
    assert tuning.sm90_fwd_splits(1, 66, 1, 64) == 2      # half the card
    assert tuning.sm90_fwd_splits(1, 67, 1, 64) == 1
    assert tuning.sm90_fwd_splits(1, 1, 1, 512) == tuning.SM90_FWD_MAX_SPLITS
    assert tuning.sm90_fwd_splits(1, 1, 1, 63) == 1       # 32 tiles a split
    assert tuning.sm90_fwd_splits(1, 8, 1, 128, num_sms=16) == 2


# ---------------------------------------------------------------------------
# a failed sm90 launch raises; nothing falls back
# ---------------------------------------------------------------------------

class _StubLib:
    """A loaded library whose every forward entry returns ``err`` and
    records the call."""

    def __init__(self, err):
        self.calls = []
        for name in ("flash_fwd_sm90", "flash_fwd"):
            setattr(self, name, self._entry(name, err))
        self.flash_fwd_sm90_error_string = lambda e: b"stub error"
        self.flash_fwd_error_string = lambda e: b"stub error"

    def _entry(self, name, err):
        def call(*args):
            self.calls.append((name, args))
            return err
        return call


def _stub(monkeypatch, sm90_err, mma_err=0):
    sm90, mma = _StubLib(sm90_err), _StubLib(mma_err)
    monkeypatch.setattr(fa, "_fwd_sm90_lib", lambda: sm90)
    monkeypatch.setattr(fa, "_lib", lambda: mma)
    monkeypatch.setattr(fa, "_num_sms", lambda device: 132)
    # the wrappers name the card's current stream
    monkeypatch.setattr(fa.torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return sm90, mma


def _launch(paged=False, b=1, hq=4, hkv=2, sq=128, sk=128, d=64, dropout=0.0,
            mma_body=False):
    """One forward launch through ``fa._launch`` on CPU tensors (the stub
    library never reads them)."""
    q = torch.zeros((b, hq, sq, d), dtype=BF16)
    if paged:
        ps = 16
        k = torch.zeros((hkv, 8, ps, d), dtype=BF16)
        page_list = torch.zeros((b, sk // ps), dtype=torch.int32)
        layout = torch.ones((b, sq // 64, sk // ps), dtype=torch.int32)
        block_k = ps
    else:
        k = torch.zeros((b, hkv, sk, d), dtype=BF16)
        page_list, layout, block_k = None, torch.ones((sq // 64, sk // 64)), 64
    return fa._launch(
        paged=paged, q=q, k=k, v=k, block_layout=layout, kv_mask=None,
        q_seg=None, kv_seg=None, q_pos=None, kv_pos=None, page_list=page_list,
        scale=0.125, causal=True, window=None, q_offset=0, kv_valid_len=None,
        block_q=64, block_k=block_k, sk=sk, num_pages=8 if paged else 0,
        variant="fa2", dropout=fa._dropout_args(dropout, 3, None, sq, sk, hq),
        mma_body=mma_body)


@pytest.mark.parametrize("paged", [False, True])
def test_sm90_launch_error_raises_without_fallback(monkeypatch, paged):
    sm90, mma = _stub(monkeypatch, 700)
    monkeypatch.setattr(fa, "LAUNCHES", {n: 0 for n in fa.LAUNCHES})
    name = "flash_fwd_paged_sm90" if paged else "flash_fwd_sm90"
    with pytest.raises(RuntimeError, match=f"{name} launch failed: CUDA "
                                           "error 700"):
        _launch(paged=paged)
    assert [c[0] for c in sm90.calls] == ["flash_fwd_sm90"]
    assert mma.calls == []                   # no other body was tried
    assert not any(fa.LAUNCHES.values())     # a failed launch counts nothing


@pytest.mark.parametrize("paged", [False, True])
def test_sm90_launch_passes_the_chosen_cta_mode(monkeypatch, paged):
    """The last two arguments of an sm90 launch are ``sm90_fwd_rows`` and
    ``sm90_fwd_splits`` of the call's grid, the paged flag and dropout's
    on-bit go through; ``_mma_body`` takes flash_fwd.cu's entry instead."""
    sm90, mma = _stub(monkeypatch, 0)
    monkeypatch.setattr(fa, "LAUNCHES", {n: 0 for n in fa.LAUNCHES})
    dropout = 0.0 if paged else 0.1
    # a 64-row chunk of 8 heads against 16384 keys: 8 CTAs, 8 splits
    _launch(paged=paged, b=1, hq=8, hkv=2, sq=64, sk=16384, dropout=dropout)
    args = sm90.calls[-1][1]
    assert args[-2:] == (64, 8) and args[1] == int(paged)
    assert args[32] == int(dropout > 0)      # the dropout on-bit
    base = "flash_fwd_paged" if paged else "flash_fwd"
    assert fa.LAUNCHES[base + "_sm90"] == 1
    # granite's train layer: 128-row CTAs, one split
    _launch(paged=paged, b=4, hq=32, hkv=8, sq=2048, sk=2048)
    assert sm90.calls[-1][1][-2:] == (128, 1)
    _launch(paged=paged, mma_body=True)
    assert [c[0] for c in mma.calls] == ["flash_fwd"]
    assert fa.LAUNCHES[base] == 1 and fa.LAUNCHES[base + "_sm90"] == 2


def test_sm90_source_is_built_and_typed(monkeypatch):
    """``build_all`` starts one nvcc for the sm90 forward beside the
    others, the shared sm90 header sits beside the sources, and the wrapper
    types the entry with flash_fwd's arguments and the CTA mode appended."""
    assert "flash_fwd_sm90" in build.SOURCES
    assert (build.CSRC / "flash_fwd_sm90.cu").exists()
    assert (build.CSRC / "sm90_common.cuh").exists()
    lib = type("Lib", (), {})()
    lib.flash_fwd_sm90 = type("Fn", (), {})()
    monkeypatch.setattr(build, "load", lambda name: lib)
    fa._fwd_sm90_lib()
    fn = lib.flash_fwd_sm90
    assert fn.restype is ctypes.c_int
    assert fn.argtypes[-2:] == [ctypes.c_int, ctypes.c_int]
    assert len(fn.argtypes) == 44


# ---------------------------------------------------------------------------
# the function at the sm90 body's tiles, against the JAX package
# ---------------------------------------------------------------------------

def _close(t, j, rtol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=rtol)


def _both(arrays):
    return ({k: None if v is None else jnp.asarray(v) for k, v in arrays.items()},
            {k: None if v is None else torch.as_tensor(v)
             for k, v in arrays.items()})


def _documents(rng, b, s):
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        for cut in np.sort(rng.choice(np.arange(1, s), 3, replace=False)):
            seg[i, cut:] += 1
    return seg


JAX_CASES = {
    # name: (b, hq, hkv, sq, sk, d, kwargs)
    "d96_gqa5_causal_documents": (1, 5, 1, 128, 128, 96, dict(
        causal=True, documents=True)),
    "d128_gqa8_window_kvmask": (1, 8, 1, 64, 192, 128, dict(
        causal=True, window=70, kv_mask=True)),
    "d64_documents_dropout_paper": (2, 4, 2, 128, 128, 64, dict(
        causal=True, documents=True, dropout_p=0.1, dropout_seed=7,
        variant="paper")),
    "d96_noncausal_one_short_block": (1, 5, 1, 40, 40, 96, dict(
        causal=False)),
}


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_forward_at_sm90_tiles_matches_jax(name):
    """``flash_attention_forward`` at the sm90 body's tiles (64 x 64, or
    one block of the whole axis; the plain version on the CPU) against the
    JAX kernel in interpret mode: o, m and l."""
    b, hq, hkv, sq, sk, d, kw = JAX_CASES[name]
    rng = np.random.default_rng(len(name))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v = f(b, hq, sq, d), f(b, hkv, sk, d), f(b, hkv, sk, d)
    kw = dict(kw)
    q_offset = sk - sq if kw["causal"] else 0
    arrays = dict(kv_mask=None, q_segment_ids=None, kv_segment_ids=None)
    if kw.pop("documents", False):
        seg = _documents(rng, b, sk)
        arrays.update(q_segment_ids=seg[:, sk - sq:].copy(), kv_segment_ids=seg)
    if kw.pop("kv_mask", False):
        kvm = rng.random((b, sk)) > 0.25
        kvm[:, -30:] = False
        arrays["kv_mask"] = kvm
    ja, ta = _both(arrays)
    bq, bk = min(64, sq), min(64, sk)
    spec_kw = dict(causal=kw["causal"], window=kw.get("window"),
                   q_offset=q_offset)
    jl = JM.compile_block_layout(JM.MaskSpec(**spec_kw, **ja), sq, sk, bq,
                                 bk).as_array()
    tl = TM.compile_block_layout(TM.MaskSpec(**spec_kw, **ta), sq, sk, bq,
                                 bk).as_array()
    assert fa.forward_body(on_card=True, dtype=BF16, head_dim=d, block_q=bq,
                           block_k=bk, paged=False, nq=sq // bq,
                           nk=sk // bk) == "sm90"
    common = dict(scale=d ** -0.5, block_q=bq, block_k=bk, q_offset=q_offset,
                  causal=kw["causal"], window=kw.get("window"),
                  variant=kw.get("variant", "fa2"))
    drop = dict(dropout_p=kw.get("dropout_p", 0.0),
                dropout_seed=kw.get("dropout_seed", 0))
    jo, jm, jl_ = jfa.flash_attention_forward(
        *map(jnp.asarray, (q, k, v)), ja.pop("kv_mask"), jl, interpret=True,
        **common, **drop, **ja)
    to, tm, tl_ = fa.flash_attention_forward(
        *map(torch.as_tensor, (q, k, v)), ta.pop("kv_mask"), tl, **common,
        **drop, **ta)
    _close(to, jo)
    _close(tm, jm)
    _close(tl_, jl_, rtol=L_RTOL)


def _paged_case(rng, page_size, d, sq):
    """Two documents' chunks (the tails of their documents: a chunk's
    q_offset through positions) packed in one q row against their paged
    prefixes, a dead slot between the documents' pages and one after, and
    padding q rows past the chunks."""
    hq, hkv, num_pages = 8, 1, 40
    spans, chunks = [90, 50], [sq // 2, sq // 4]
    pool_k = rng.standard_normal((hkv, num_pages, page_size, d)).astype(np.float32)
    pool_v = rng.standard_normal((hkv, num_pages, page_size, d)).astype(np.float32)
    pages = rng.permutation(num_pages)
    n_pages = [-(-s // page_size) for s in spans]
    T = n_pages[0] + 1 + n_pages[1] + 1
    page_list = np.full((1, T), -1, np.int32)
    kv_seg = np.full((1, T * page_size), JM.SEG_PAD_KV, np.int32)
    kv_pos = np.full((1, T * page_size), JM.POS_PAD, np.int32)
    q_seg = np.full((1, sq), JM.SEG_PAD_Q, np.int32)
    q_pos = np.full((1, sq), JM.POS_PAD, np.int32)
    slot = row = used = 0
    for s, (span, n, np_) in enumerate(zip(spans, chunks, n_pages)):
        page_list[0, slot:slot + np_] = pages[used:used + np_]
        kv_seg[0, slot * page_size:slot * page_size + span] = s
        kv_pos[0, slot * page_size:slot * page_size + span] = np.arange(span)
        q_seg[0, row:row + n] = s
        q_pos[0, row:row + n] = np.arange(span - n, span)
        slot, row, used = slot + np_ + 1, row + n, used + np_
    q = rng.standard_normal((1, hq, sq, d)).astype(np.float32)
    return dict(q=q, k_pool=pool_k, v_pool=pool_v, page_list=page_list,
                q_segment_ids=q_seg, kv_segment_ids=kv_seg, q_positions=q_pos,
                kv_positions=kv_pos)


@pytest.mark.parametrize("page_size,d,sq", [(8, 128, 64), (16, 96, 128),
                                            (16, 64, 40)])
def test_paged_forward_at_sm90_tiles_matches_jax(page_size, d, sq):
    """``flash_prefill_paged_forward`` at the sm90 body's tiles (64-row q
    blocks or one block of 40; pages of 8 and 16, gathered 8 or 4 to a
    64-key tile by the kernel) against the JAX kernel in interpret mode,
    with a dead page inside a tile and padding rows with no key."""
    case = _paged_case(np.random.default_rng(page_size + d), page_size, d, sq)
    ja, ta = _both(case)
    bq = min(64, sq)
    T = case["page_list"].shape[1]
    assert fa.forward_body(on_card=True, dtype=BF16, head_dim=d, block_q=bq,
                           block_k=page_size, paged=True, nq=sq // bq,
                           nk=T) == "sm90"
    names = ("q_segment_ids", "kv_segment_ids", "q_positions", "kv_positions")

    def layout(M, a):
        spec = M.MaskSpec(causal=True, **{n: a[n] for n in names})
        lay = M.compile_block_layout(spec, sq, T * page_size, bq,
                                     page_size).as_array()
        return M.paged_prefill_block_layout(lay, a["page_list"])

    common = dict(scale=d ** -0.5, causal=True, window=None, block_q=bq)
    jo, jm, jl = jfa.flash_prefill_paged_forward(
        ja["q"], ja["k_pool"], ja["v_pool"], ja["page_list"], layout(JM, ja),
        interpret=True, **common, **{n: ja[n] for n in names})
    to, tm, tl = fa.flash_prefill_paged_forward(
        ta["q"], ta["k_pool"], ta["v_pool"], ta["page_list"], layout(TM, ta),
        **common, **{n: ta[n] for n in names})
    _close(to, jo)
    _close(tm, jm)
    _close(tl, jl, rtol=L_RTOL)
    rows = sq // 2 + sq // 4                 # the chunks' rows; the rest pad
    assert torch.all(tl[0, :, rows:] == 0)
    assert torch.all(tm[0, :, rows:] == TM.NEG_INF)
