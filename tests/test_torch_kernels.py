"""Kernel parity on the CPU: the plain versions of the port's kernels
(``flash_attention_forward``, ``flash_prefill_paged_forward``,
``flash_decode_paged`` — the functions the CUDA kernels compute) against
the JAX package's Pallas kernels run in interpret mode, on the same numpy
inputs made from a seed. Each side compiles its own block layout from the
same mask arguments. Tolerance: atol 1e-5 in fp32 (summation order
differs; the masks and the online-softmax guards are the same), and exact
equality of the NEG_INF / zero sentinels on fully masked rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masks as JM
from repro.kernels import flash_attention as jfa
from repro.kernels import flash_decode as jfd
from repro_torch.core import masks as TM
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py
ATOL = 1e-5


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


def _both(arrays):
    return ({k: None if v is None else jnp.asarray(v) for k, v in arrays.items()},
            {k: None if v is None else torch.as_tensor(v) for k, v in arrays.items()})


def _qkv(rng, b, hq, hkv, sq, sk, d):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(b, hq, sq, d), f(b, hkv, sk, d), f(b, hkv, sk, d)


def _contiguous(seed, *, b=2, hq=4, hkv=2, sq=64, sk=64, d=16, bq=16, bk=16,
                causal=True, window=None, q_offset=None, kv_valid_len=None,
                kv_mask=None, q_seg=None, kv_seg=None, q_pos=None,
                kv_pos=None):
    rng = np.random.default_rng(seed)
    q, k, v = _qkv(rng, b, hq, hkv, sq, sk, d)
    q_offset = (sk - sq) if q_offset is None else q_offset
    scale = 1.0 / np.sqrt(d)
    arrays = dict(kv_mask=kv_mask, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                  q_positions=q_pos, kv_positions=kv_pos)
    ja, ta = _both(arrays)
    if q_pos is not None:
        q_offset = 0
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_valid_len=kv_valid_len)
    jl = JM.compile_block_layout(JM.MaskSpec(**kw, **{k: v for k, v in ja.items()}),
                                 sq, sk, bq, bk).as_array()
    tl = TM.compile_block_layout(TM.MaskSpec(**kw, **{k: v for k, v in ta.items()}),
                                 sq, sk, bq, bk).as_array()
    common = dict(scale=scale, block_q=bq, block_k=bk, **kw)
    jo, jm, jl_ = jfa.flash_attention_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), ja.pop("kv_mask"), jl,
        dropout_p=0.0, interpret=True, **common, **ja)
    to, tm, tl_ = tfa.flash_attention_forward(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        ta.pop("kv_mask"), tl, **common, **ta)
    _close(to, jo)
    _close(tm, jm)
    _close(tl_, jl_)
    return to, tm, tl_


def test_gqa_causal_with_offset():
    _contiguous(0, sq=32, sk=64)


def test_window_kv_mask_and_padding_tail():
    rng = np.random.default_rng(1)
    kvm = rng.random((2, 64)) > 0.25
    kvm[1, :20] = False          # rows whose whole window is masked
    _contiguous(1, window=12, kv_mask=kvm, kv_valid_len=52, bk=8)


def test_packed_segments_padded_rows_are_zero():
    """Packed documents with a SEG_PAD_Q / SEG_PAD_KV padded tail: padded q
    rows come out o = 0, l = 0, m = NEG_INF on both sides."""
    seg = np.zeros((2, 48), np.int32)
    seg[0, 20:] = 1
    seg[1, 10:30] = 1
    seg[1, 30:] = 2
    q_seg, kv_seg = seg.copy(), seg.copy()
    q_seg[:, 40:] = JM.SEG_PAD_Q
    kv_seg[:, 40:] = JM.SEG_PAD_KV
    o, m, l = _contiguous(2, sq=48, sk=48, q_seg=q_seg, kv_seg=kv_seg)
    assert torch.all(o[:, :, 40:] == 0) and torch.all(l[:, :, 40:] == 0)
    assert torch.all(m[:, :, 40:] == TM.NEG_INF)


def test_positions_chunk_against_prefix():
    """Per-segment q_offset through logical positions; POS_PAD keys on the
    kv tail are causally unreachable from every real query."""
    b, sq, sk = 2, 32, 64
    q_pos = np.stack([np.arange(10, 10 + sq), np.arange(30, 30 + sq)]).astype(np.int32)
    kv_pos = np.tile(np.arange(sk, dtype=np.int32), (b, 1))
    kv_pos[0, 42:] = JM.POS_PAD
    _contiguous(3, sq=sq, sk=sk, q_pos=q_pos, kv_pos=kv_pos, bk=8)


def _paged_case(seed, *, page_size=8, d=16):
    """Two sequences packed in one row (segments), prefixes read through a
    scrambled page list with dead slots, chunk queries at hist + r, and a
    padded q tail."""
    rng = np.random.default_rng(seed)
    hq, hkv, num_pages, T = 4, 2, 24, 8
    spans, chunks = [21, 30], [5, 9]
    sq = 16
    pool_k = rng.standard_normal((hkv, num_pages, page_size, d)).astype(np.float32)
    pool_v = rng.standard_normal((hkv, num_pages, page_size, d)).astype(np.float32)
    pages = rng.permutation(num_pages)
    page_list = np.full((1, T), -1, np.int32)
    kv_seg = np.full((1, T * page_size), JM.SEG_PAD_KV, np.int32)
    kv_pos = np.full((1, T * page_size), JM.POS_PAD, np.int32)
    q_seg = np.full((1, sq), JM.SEG_PAD_Q, np.int32)
    q_pos = np.full((1, sq), JM.POS_PAD, np.int32)
    slot, row = 0, 0
    for s, (span, n) in enumerate(zip(spans, chunks)):
        np_ = -(-span // page_size)
        page_list[0, slot:slot + np_] = pages[slot:slot + np_]
        kv_seg[0, slot * page_size:slot * page_size + span] = s
        kv_pos[0, slot * page_size:slot * page_size + span] = np.arange(span)
        q_seg[0, row:row + n] = s
        q_pos[0, row:row + n] = np.arange(span - n, span)
        slot, row = slot + np_, row + n
    q = rng.standard_normal((1, hq, sq, d)).astype(np.float32)
    return dict(q=q, k_pool=pool_k, v_pool=pool_v, page_list=page_list,
                q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                q_positions=q_pos, kv_positions=kv_pos)


@pytest.mark.parametrize("window", [None, 7])
def test_paged_prefill_matches_pallas(window):
    case = _paged_case(4)
    ja, ta = _both(case)
    bq, ps = 8, case["k_pool"].shape[2]
    sq, T = case["q"].shape[2], case["page_list"].shape[1]

    def layout(M, a):
        spec = M.MaskSpec(causal=True, window=window,
                          q_segment_ids=a["q_segment_ids"],
                          kv_segment_ids=a["kv_segment_ids"],
                          q_positions=a["q_positions"],
                          kv_positions=a["kv_positions"])
        lay = M.compile_block_layout(spec, sq, T * ps, bq, ps).as_array()
        return M.paged_prefill_block_layout(lay, a["page_list"])

    common = dict(scale=0.25, causal=True, window=window, block_q=bq)
    names = ("q_segment_ids", "kv_segment_ids", "q_positions", "kv_positions")
    jo, jm, jl = jfa.flash_prefill_paged_forward(
        ja["q"], ja["k_pool"], ja["v_pool"], ja["page_list"], layout(JM, ja),
        interpret=True, **common, **{n: ja[n] for n in names})
    to, tm, tl = tfa.flash_prefill_paged_forward(
        ta["q"], ta["k_pool"], ta["v_pool"], ta["page_list"], layout(TM, ta),
        **common, **{n: ta[n] for n in names})
    _close(to, jo)
    _close(tm, jm)
    _close(tl, jl)
    # padded q rows (beyond the 14 real chunk rows) are fully masked
    assert torch.all(tl[0, :, 14:] == 0) and torch.all(tm[0, :, 14:] == TM.NEG_INF)


def test_paged_prefill_op_matches_gather_oracle():
    """ops.flash_prefill_paged (padding + layout compile) equals the plain
    gather-and-attend oracle over the same logical prefix."""
    from repro_torch.core.attention import AttentionSpec, paged_prefill_attention
    case = {k: torch.as_tensor(v) for k, v in _paged_case(5).items()}
    kw = {n: case[n] for n in ("q_segment_ids", "kv_segment_ids",
                               "q_positions", "kv_positions")}
    o_kernel = tops.flash_prefill_paged(case["q"], case["k_pool"],
                                        case["v_pool"], case["page_list"],
                                        block_q=8, **kw)
    o_ref = paged_prefill_attention(case["q"], case["k_pool"], case["v_pool"],
                                    case["page_list"],
                                    AttentionSpec(impl="reference"), **kw)
    torch.testing.assert_close(o_kernel[0, :, :14], o_ref[0, :, :14],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("window,num_splits", [(None, 2), (10, 4)])
def test_paged_decode_partials_match_pallas(monkeypatch, window, num_splits):
    rng = np.random.default_rng(6)
    b, hq, hkv, d, ps, num_pages, T = 3, 4, 2, 16, 8, 20, 4
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    pool_k = rng.standard_normal((hkv, num_pages, ps, d)).astype(np.float32)
    pool_v = rng.standard_normal((hkv, num_pages, ps, d)).astype(np.float32)
    table = rng.permutation(num_pages)[:b * T].reshape(b, T).astype(np.int32)
    table[0, 2:] = -1                      # short sequence: dead pages
    table[2, :] = -1                       # idle lane: every page dead
    kv_len = np.array([13, 30, 0], np.int32)
    captured = {}

    def capture(o_p, m_p, l_p, dtype):
        captured.update(o_p=o_p, m_p=m_p, l_p=l_p)
        return merge(o_p, m_p, l_p, dtype)

    merge = jfd._merge_split_partials
    monkeypatch.setattr(jfd, "_merge_split_partials", capture)
    jo = jfd.flash_decode_paged(jnp.asarray(q), jnp.asarray(pool_k),
                                jnp.asarray(pool_v), jnp.asarray(table),
                                jnp.asarray(kv_len), num_splits=num_splits,
                                window=window, interpret=True)
    tq, tk, tv, tt, tkl = map(torch.as_tensor, (q, pool_k, pool_v, table, kv_len))
    lay = TM.paged_block_layout(tkl, tt, ps, window=window)
    o_p, m_p, l_p = tfd.flash_decode_paged_partials(
        tq, tk, tv, tt, tkl, lay, scale=1.0 / np.sqrt(d),
        num_splits=num_splits, window=window)
    _close(o_p, captured["o_p"])
    _close(m_p, captured["m_p"])
    _close(l_p, captured["l_p"])
    to = tfd.flash_decode_paged(tq, tk, tv, tt, tkl, num_splits=num_splits,
                                window=window)
    _close(to, jo)
    assert torch.all(to[2] == 0)          # an idle lane emits zeros
    # the merge itself, on the captured JAX partials
    _close(tfd._merge_split_partials(
        *(torch.as_tensor(np.array(captured[n])) for n in ("o_p", "m_p", "l_p")),
        torch.float32), merge(captured["o_p"], captured["m_p"],
                              captured["l_p"], jnp.float32))


@pytest.mark.parametrize("num_splits", [12, 24])
def test_paged_decode_takes_any_split_count_on_cpu(num_splits):
    """The card's decode merges its splits in one thread-block cluster of
    at most 8; on the CPU every split count still works, as in the JAX
    package: 12 and 24 splits against the JAX kernel (interpret mode), and
    ``flash_decode_paged_from_layout`` returns that decode with its
    partials."""
    rng = np.random.default_rng(num_splits)
    b, hq, hkv, d, ps, T = 2, 4, 2, 16, 8, 24
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    pool_k, pool_v = (rng.standard_normal((hkv, b * T, ps, d)).astype(np.float32)
                      for _ in range(2))
    table = rng.permutation(b * T).reshape(b, T).astype(np.int32)
    table[0, 10:] = -1
    kv_len = np.array([75, T * ps], np.int32)
    jo = jfd.flash_decode_paged(*map(jnp.asarray, (q, pool_k, pool_v, table,
                                                   kv_len)),
                                num_splits=num_splits, interpret=True)
    tq, tk, tv, tt, tkl = map(torch.as_tensor, (q, pool_k, pool_v, table, kv_len))
    to = tfd.flash_decode_paged(tq, tk, tv, tt, tkl, num_splits=num_splits)
    _close(to, jo)
    lay = TM.paged_block_layout(tkl, tt, ps)
    whole, parts = tfd.flash_decode_paged_from_layout(
        tq, tk, tv, tt, tkl, lay, scale=d ** -0.5, num_splits=num_splits,
        window=None)
    assert torch.equal(whole, to) and parts[0].shape == (b, hq, num_splits, d)
    for got, want in zip(parts, tfd.flash_decode_paged_partials(
            tq, tk, tv, tt, tkl, lay, scale=d ** -0.5,
            num_splits=num_splits, window=None)):
        assert torch.equal(got, want)


def test_paged_decode_geometry_validation():
    with pytest.raises(ValueError, match="multiple of num_splits"):
        tfd.validate_paged_decode_geometry(12, 8)
    assert tfd.validate_paged_decode_geometry(4, 8) == 4


def test_forward_only_and_cpu_wrappers():
    """The paged op is differentiable: on inputs that require grad it
    returns q and pool gradients (dead and unnamed pages exactly zero) and
    integer inputs get none; both differentiable ops run their forward and
    backward through the plain versions on CPU tensors and never count a
    kernel launch; an unknown variant raises."""
    case = {k: torch.as_tensor(v) for k, v in _paged_case(5).items()}
    kw = {n: case[n] for n in ("q_segment_ids", "kv_segment_ids",
                               "q_positions", "kv_positions")}
    before = dict(tfa.LAUNCHES)
    leaves = [case[n].clone().requires_grad_()
              for n in ("q", "k_pool", "v_pool")]
    tops.flash_prefill_paged(*leaves, case["page_list"], block_q=8,
                             **kw).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in leaves)
    named = set(case["page_list"][case["page_list"] >= 0].tolist())
    unnamed = [p for p in range(case["k_pool"].shape[1]) if p not in named]
    assert torch.all(leaves[1].grad[:, unnamed] == 0)
    assert leaves[1].grad[:, sorted(named)].abs().sum() > 0
    assert all(t.grad is None for t in kw.values())
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    k = torch.randn(1, 1, 8, 16)
    o = tops.flash_attention(q, k, k, causal=True, dropout_p=0.1)
    o.sum().backward()
    assert tfa.LAUNCHES == before and q.grad is not None
    with pytest.raises(ValueError, match="variant"):
        tfa.flash_attention_forward(
            q.detach(), k, k, None, torch.ones((1, 1), dtype=torch.int32),
            scale=1.0, causal=True, window=None, q_offset=0, block_q=8,
            block_k=8, variant="alg3")
