"""Card tests of the hand-written CUDA kernels: each kernel against its
plain PyTorch version on the same CUDA inputs (the forward, its dropout
and "paper" variants, ragged tiles and rows with no key, the dq and dkv
backward kernels (bf16 on tensor cores: every head dim, ragged tiles, GQA
n_rep 1 and 4, dropout at two seeds, two calls bit-identical), the paged kernels with several pages to a kv tile,
the decode body that merges its splits in a cluster (paged: pages of 8-64
rows, dead and SKIP pages; contiguous: ragged blocks, windows, kv_mask;
every head dim, GQA 1/4/6, splits 1/6/8, two calls bit-identical, 9
splits refused), the paged dq and dkv kernels with the fold
into pool shape, on tensor cores in bf16 with several pages to a kv tile,
and with no host sync), the differentiable ops and a train step on the card
against the CPU, and the serving engine (paged and dense) on the card
against the same engine on the CPU (and refusing pages its kernels do not
take). Marked ``gpu``; skipped
without a CUDA device (whether one is present is decided inside the
fixture, never at import or collection). Imports no jax: the card's
machine has none. Run there with::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: fp32 inputs atol 1e-4 (summation order only); bf16 inputs
atol 2e-2 on o (bf16 output rounding) and 1e-2 relative on m and l.
Gradients: max |g - g_plain| / max |g_plain| <= 1e-4 in fp32 (summation
order; dk and dv sum a whole GQA group), 2e-2 in bf16.
"""

import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.core import masks as M
from repro_torch.kernels import build, ops, tuning
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.models import build_model, params_to
from repro_torch.serve import ServingEngine

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    return torch.device("cuda")


def _tol(dtype):
    return (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1e-2)


def _check(kernel_out, plain_out, dtype):
    atol, rel = _tol(dtype)
    o, m, l = kernel_out
    po, pm, pl = plain_out
    torch.testing.assert_close(o.float(), po.float(), atol=atol, rtol=0)
    torch.testing.assert_close(m, pm, atol=rel, rtol=rel)
    torch.testing.assert_close(l, pl, atol=rel, rtol=rel)


def _segments(gen, b, s, device):
    seg = torch.zeros((b, s), dtype=torch.int32)
    for i in range(b):
        cuts = torch.sort(torch.randperm(s - 1, generator=gen)[:3] + 1).values
        seg[i] = torch.searchsorted(cuts, torch.arange(s), right=True)
    return seg.to(device)


def _contiguous_case(cuda, dtype, d, mask, seed=None, hkv=2):
    """Inputs, compiled layout and call kwargs of one contiguous-K/V case:
    8 query heads over ``hkv`` kv heads (GQA 8/2 by default), sq 128
    against sk 192, 64 x 64 tiles."""
    gen = torch.Generator().manual_seed(d if seed is None else seed)
    b, hq, sq, sk, bq, bk = 2, 8, 128, 192, 64, 64
    q = torch.randn(b, hq, sq, d, generator=gen).to(cuda, dtype)
    k = torch.randn(b, hkv, sk, d, generator=gen).to(cuda, dtype)
    v = torch.randn(b, hkv, sk, d, generator=gen).to(cuda, dtype)
    kw = dict(causal=True, window=None, q_offset=sk - sq, kv_valid_len=None)
    arrays = {}
    if mask == "causal_segments":
        arrays["q_segment_ids"] = _segments(gen, b, sq, cuda)
        arrays["kv_segment_ids"] = torch.cat(
            [torch.zeros((b, sk - sq), dtype=torch.int32, device=cuda),
             arrays["q_segment_ids"]], dim=1)
    elif mask == "window_kvmask_tail":
        kw.update(window=37, kv_valid_len=180)
        arrays["kv_mask"] = (torch.rand(b, sk, generator=gen) > 0.2).to(cuda)
    else:
        kw["q_offset"] = 0
        arrays["q_positions"] = (torch.arange(sq, dtype=torch.int32)[None]
                                 + torch.tensor([[5], [50]], dtype=torch.int32)).to(cuda)
        kv_pos = torch.arange(sk, dtype=torch.int32).repeat(b, 1)
        kv_pos[1, 170:] = M.POS_PAD
        arrays["kv_positions"] = kv_pos.to(cuda)
    spec = M.MaskSpec(**kw, **arrays)
    layout = M.compile_block_layout(spec, sq, sk, bq, bk).as_array(cuda)
    call = dict(scale=d ** -0.5, block_q=bq, block_k=bk, **kw,
                q_segment_ids=arrays.get("q_segment_ids"),
                kv_segment_ids=arrays.get("kv_segment_ids"),
                q_positions=arrays.get("q_positions"),
                kv_positions=arrays.get("kv_positions"))
    return gen, (q, k, v, arrays.get("kv_mask"), layout), call


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("mask", ["causal_segments", "window_kvmask_tail",
                                  "positions"])
def test_flash_fwd_matches_plain(cuda, dtype, d, mask):
    _, args, call = _contiguous_case(cuda, dtype, d, mask)
    n0 = fa.LAUNCHES["flash_fwd"]
    out = fa.flash_attention_forward(*args, **call)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_fwd"] == n0 + 1
    plain = fa.flash_attention_forward_plain(*args, **call)
    assert fa.LAUNCHES["flash_fwd"] == n0 + 1      # the plain call counts nothing
    _check(out, plain, dtype)


def _ragged_case(cuda, dtype, d, bq, bk, seed=0):
    """Tiles that are not multiples of 16 (``round_block`` gives 8, 24, 40
    for short sequences): GQA 4/2, sq = 3 block_q against sk = 4 block_k,
    causal, three documents a row, a kv_valid_len inside the last tile,
    and row 5 of sequence 0 in no document (no key: o = 0, l = 0,
    m = NEG_INF)."""
    gen = torch.Generator().manual_seed(seed + 7 * bq + bk + d)
    b, hq, hkv, sq, sk = 2, 4, 2, 3 * bq, 4 * bk
    q = torch.randn(b, hq, sq, d, generator=gen).to(cuda, dtype)
    k = torch.randn(b, hkv, sk, d, generator=gen).to(cuda, dtype)
    v = torch.randn(b, hkv, sk, d, generator=gen).to(cuda, dtype)
    q_offset = max(0, sk - sq)
    kv_seg = _segments(gen, b, sk, "cpu")
    q_seg = kv_seg[:, q_offset:q_offset + sq].clone()
    if q_seg.shape[1] < sq:                  # sq > sk: rows past sk, last doc
        q_seg = torch.cat([q_seg, q_seg[:, -1:].expand(b, sq - q_seg.shape[1])], 1)
    q_seg[0, 5] = M.SEG_PAD_Q
    kw = dict(causal=True, window=None, q_offset=q_offset, kv_valid_len=sk - 3)
    ids = dict(q_segment_ids=q_seg.to(cuda), kv_segment_ids=kv_seg.to(cuda))
    spec = M.MaskSpec(**kw, **ids)
    layout = M.compile_block_layout(spec, sq, sk, bq, bk).as_array(cuda)
    call = dict(scale=d ** -0.5, block_q=bq, block_k=bk, **kw, **ids)
    return gen, (q, k, v, None, layout), call


def _check_empty_row(out, b, r):
    o, m, l = out
    assert torch.all(o[b, :, r] == 0)
    assert torch.all(l[b, :, r] == 0) and torch.all(m[b, :, r] == M.NEG_INF)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("bq,bk", [(8, 8), (24, 40), (40, 24)])
def test_flash_fwd_ragged_tiles_match_plain(cuda, dtype, d, bq, bk):
    """The forward at block_q / block_k of 8, 24 and 40 (zero-padded to the
    tensor cores' 16 inside the CTA), every head dim, with a row that has
    no key."""
    _, args, call = _ragged_case(cuda, dtype, d, bq, bk)
    out = fa.flash_attention_forward(*args, **call)
    torch.cuda.synchronize()
    plain = fa.flash_attention_forward_plain(*args, **call)
    _check(out, plain, dtype)
    _check_empty_row(out, 0, 5)


@pytest.mark.parametrize("variant", ["fa2", "paper"])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("dropout_seed", [77, 901])
def test_dropout_bf16_forward_and_backward_match_plain(cuda, variant, d,
                                                       dropout_seed):
    """bf16 dropout (p = 0.2) at ragged tiles, both accumulator variants,
    two seeds: the forward against the plain version, and the tensor-core
    backward pair fed the KERNEL's (o, m, l) against the plain backward fed
    the plain ones (the regenerated keep mask must agree with the
    forward's, in dkv with the fragment's rows and columns swapped), and
    two calls of the pair bit-identical."""
    gen, args, call = _ragged_case(cuda, torch.bfloat16, d, 24, 40, seed=3)
    call.update(dropout_p=0.2, dropout_seed=dropout_seed,
                dropout_dims=(70, 150), variant=variant)
    out = fa.flash_attention_forward(*args, **call)
    torch.cuda.synchronize()
    plain = fa.flash_attention_forward_plain(*args, **call)
    _check(out, plain, torch.bfloat16)
    _check_empty_row(out, 0, 5)
    do = torch.randn(args[0].shape, generator=gen).to(cuda, torch.bfloat16)
    bcall = {n: x for n, x in call.items() if n != "variant"}
    got = fa.flash_attention_backward(*args[:3], *out[:1], do, *out[1:],
                                      *args[3:], **bcall)
    want = fa.flash_attention_backward_plain(*args[:3], plain[0], do,
                                             *plain[1:], *args[3:], **bcall)
    _check_grads(got, want, torch.bfloat16)
    again = fa.flash_attention_backward(*args[:3], *out[:1], do, *out[1:],
                                        *args[3:], **bcall)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def _check_grads(got, want, dtype):
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        err = float((g.float() - w.float()).abs().max()
                    / w.float().abs().max().clamp_min(1e-30))
        assert err <= tol, f"{name}: scaled error {err} > {tol}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("mask", ["causal_segments", "window_kvmask_tail",
                                  "positions"])
@pytest.mark.parametrize("hkv", [2, 8])
def test_flash_bwd_matches_plain(cuda, dtype, d, mask, hkv):
    """dq, dk, dv of the two backward kernels (bf16: the tensor-core pair;
    fp32: the scalar body) against the plain backward on the same (o, m, l)
    residuals, at GQA n_rep 4 and 1; two calls bit-identical."""
    gen, args, call = _contiguous_case(cuda, dtype, d, mask, hkv=hkv)
    q = args[0]
    o, m, l = fa.flash_attention_forward_plain(*args, **call)
    do = torch.randn(q.shape, generator=gen).to(cuda, dtype)
    n_dq, n_dkv = fa.LAUNCHES["flash_bwd_dq"], fa.LAUNCHES["flash_bwd_dkv"]
    res = (*args[:3], o, do, m, l, *args[3:])
    got = fa.flash_attention_backward(*res, **call)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_bwd_dq"] == n_dq + 1
    assert fa.LAUNCHES["flash_bwd_dkv"] == n_dkv + 1
    want = fa.flash_attention_backward_plain(*res, **call)
    _check_grads(got, want, dtype)
    again = fa.flash_attention_backward(*res, **call)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("bq,bk", [(8, 8), (24, 40), (40, 24), (64, 64)])
def test_flash_bwd_ragged_tiles_match_plain(cuda, dtype, d, bq, bk):
    """The backward pair at block_q / block_k of 8, 24, 40 and 64 (the
    tensor-core pair pads them to 16 inside the CTA: rows past a block are
    zero with P = 0), every head dim, causal documents with a kv_valid_len
    tail, and a row with no key (l = 0: its dq is zero); two calls
    bit-identical."""
    gen, args, call = _ragged_case(cuda, dtype, d, bq, bk)
    o, m, l = fa.flash_attention_forward_plain(*args, **call)
    assert torch.all(l[0, :, 5] == 0)
    do = torch.randn(args[0].shape, generator=gen).to(cuda, dtype)
    res = (*args[:3], o, do, m, l, *args[3:])
    got = fa.flash_attention_backward(*res, **call)
    torch.cuda.synchronize()
    want = fa.flash_attention_backward_plain(*res, **call)
    _check_grads(got, want, dtype)
    assert torch.all(got[0][0, :, 5] == 0)
    again = fa.flash_attention_backward(*res, **call)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_dropout_forward_and_backward_match_plain(cuda):
    """dropout_p = 0.2 in fp32: a keep mask that differs in one element
    moves o and the grads far past 1e-4."""
    gen, args, call = _contiguous_case(cuda, torch.float32, 64,
                                       "causal_segments", seed=5)
    call.update(dropout_p=0.2, dropout_seed=1234, dropout_dims=(120, 190))
    out = fa.flash_attention_forward(*args, **call)
    plain = fa.flash_attention_forward_plain(*args, **call)
    _check(out, plain, torch.float32)
    do = torch.randn(args[0].shape, generator=gen).to(cuda)
    res = (*args[:3], plain[0], do, plain[1], plain[2], *args[3:])
    got = fa.flash_attention_backward(*res, **call)
    want = fa.flash_attention_backward_plain(*res, **call)
    _check_grads(got, want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paper_variant_matches_plain(cuda, dtype):
    _, args, call = _contiguous_case(cuda, dtype, 64, "window_kvmask_tail")
    call["variant"] = "paper"
    out = fa.flash_attention_forward(*args, **call)
    _check(out, fa.flash_attention_forward_plain(*args, **call), dtype)


def test_differentiable_op_on_card_matches_cpu(cuda):
    """``ops.flash_attention`` with autograd on the card (forward, dq and
    dkv kernels, padding outside the Function) against the same op on the
    CPU (plain versions): sq 100 / sk 150 pad to the tiles."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(2, 8, 100, 64, generator=gen)
    k = torch.randn(2, 2, 150, 64, generator=gen)
    v = torch.randn(2, 2, 150, 64, generator=gen)
    do = torch.randn(2, 8, 100, 64, generator=gen)
    outs = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_() for t in (q, k, v)]
        o = ops.flash_attention(*leaves, causal=True, dropout_p=0.1,
                                dropout_seed=9)
        outs[str(dev)] = [o] + list(torch.autograd.grad(o, leaves, do.to(dev)))
    for got, want in zip(outs["cuda"], outs["cpu"]):
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        assert err <= 1e-4, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page_size", [8, 16, 64])
def test_flash_fwd_paged_matches_plain(cuda, dtype, page_size):
    gen = torch.Generator().manual_seed(page_size)
    hq, hkv, d, num_pages = 8, 2, 64, 40
    spans, chunks = [70, 130], [30, 34]
    sq = 64
    k_pool = torch.randn(hkv, num_pages, page_size, d, generator=gen).to(cuda, dtype)
    v_pool = torch.randn(hkv, num_pages, page_size, d, generator=gen).to(cuda, dtype)
    T = sum(-(-s // page_size) for s in spans) + 2       # two dead slots
    pages = torch.randperm(num_pages, generator=gen)
    page_list = torch.full((1, T), -1, dtype=torch.int32)
    kv_seg = torch.full((1, T * page_size), M.SEG_PAD_KV, dtype=torch.int32)
    kv_pos = torch.full((1, T * page_size), M.POS_PAD, dtype=torch.int32)
    q_seg = torch.full((1, sq), M.SEG_PAD_Q, dtype=torch.int32)
    q_pos = torch.full((1, sq), M.POS_PAD, dtype=torch.int32)
    slot = row = 0
    for s, (span, n) in enumerate(zip(spans, chunks)):
        np_ = -(-span // page_size)
        page_list[0, slot:slot + np_] = pages[slot:slot + np_].int()
        kv_seg[0, slot * page_size:slot * page_size + span] = s
        kv_pos[0, slot * page_size:slot * page_size + span] = torch.arange(span)
        q_seg[0, row:row + n] = s
        q_pos[0, row:row + n] = torch.arange(span - n, span)
        slot, row = slot + np_, row + n
    q = torch.randn(1, hq, sq, d, generator=gen).to(cuda, dtype)
    a = {n: t.to(cuda) for n, t in dict(q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                                       q_positions=q_pos, kv_positions=kv_pos).items()}
    bq = 32
    spec = M.MaskSpec(causal=True, **a)
    layout = M.compile_block_layout(spec, sq, T * page_size, bq,
                                    page_size).as_array(cuda)
    layout = M.paged_prefill_block_layout(layout, page_list.to(cuda))
    call = dict(scale=d ** -0.5, causal=True, window=None, block_q=bq, **a)
    n0 = fa.LAUNCHES["flash_fwd_paged"]
    out = fa.flash_prefill_paged_forward(q, k_pool, v_pool, page_list.to(cuda),
                                         layout, **call)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_fwd_paged"] == n0 + 1
    plain = fa.flash_prefill_paged_forward_plain(q, k_pool, v_pool,
                                                 page_list.to(cuda), layout, **call)
    _check(out, plain, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("page_size", [8, 16, 32, 64])
def test_flash_fwd_paged_page_groups_match_plain(cuda, dtype, d, page_size):
    """A kv tile gathers 64 // page_size pages: a dead slot between the two
    documents' pages and the other document's SKIP pages share one group,
    the page count is not a multiple of the pages per tile (for pages
    below 64), and the padded q rows past both chunks have no key."""
    gen = torch.Generator().manual_seed(100 + page_size + d)
    hq, hkv, num_pages = 4, 2, 60
    spans, chunks = [70, 130], [30, 34]
    bq = 24 if page_size in (8, 32) else 40
    sq = 3 * bq
    k_pool = torch.randn(hkv, num_pages, page_size, d, generator=gen).to(cuda, dtype)
    v_pool = torch.randn(hkv, num_pages, page_size, d, generator=gen).to(cuda, dtype)
    n_pages = [-(-s // page_size) for s in spans]
    T = n_pages[0] + 1 + n_pages[1] + 2          # dead slots: one between, two after
    pages = torch.randperm(num_pages, generator=gen).int()
    page_list = torch.full((1, T), -1, dtype=torch.int32)
    kv_seg = torch.full((1, T * page_size), M.SEG_PAD_KV, dtype=torch.int32)
    kv_pos = torch.full((1, T * page_size), M.POS_PAD, dtype=torch.int32)
    q_seg = torch.full((1, sq), M.SEG_PAD_Q, dtype=torch.int32)
    q_pos = torch.full((1, sq), M.POS_PAD, dtype=torch.int32)
    slot, row, used = 0, 0, 0
    for s, (span, n, np_) in enumerate(zip(spans, chunks, n_pages)):
        page_list[0, slot:slot + np_] = pages[used:used + np_]
        kv_seg[0, slot * page_size:slot * page_size + span] = s
        kv_pos[0, slot * page_size:slot * page_size + span] = torch.arange(span)
        q_seg[0, row:row + n] = s
        q_pos[0, row:row + n] = torch.arange(span - n, span)
        slot, row, used = slot + np_ + 1, row + n, used + np_
    if page_size < 64:
        assert T % tuning.fwd_pages_per_tile(page_size) != 0
    q = torch.randn(1, hq, sq, d, generator=gen).to(cuda, dtype)
    a = {n: t.to(cuda) for n, t in dict(q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                                       q_positions=q_pos, kv_positions=kv_pos).items()}
    spec = M.MaskSpec(causal=True, **a)
    layout = M.compile_block_layout(spec, sq, T * page_size, bq,
                                    page_size).as_array(cuda)
    layout = M.paged_prefill_block_layout(layout, page_list.to(cuda))
    call = dict(scale=d ** -0.5, causal=True, window=None, block_q=bq, **a)
    n0 = fa.LAUNCHES["flash_fwd_paged"]
    out = fa.flash_prefill_paged_forward(q, k_pool, v_pool, page_list.to(cuda),
                                         layout, **call)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_fwd_paged"] == n0 + 1
    plain = fa.flash_prefill_paged_forward_plain(q, k_pool, v_pool,
                                                 page_list.to(cuda), layout, **call)
    _check(out, plain, dtype)
    _check_empty_row(out, 0, sq - 1)


def test_paged_forward_refuses_other_page_sizes(cuda):
    """A page the kv tile cannot gather whole raises before launch."""
    q = torch.randn(1, 2, 24, 64, device=cuda, dtype=torch.bfloat16)
    pool = torch.randn(1, 4, 24, 64, device=cuda, dtype=torch.bfloat16)
    page_list = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    layout = torch.ones((1, 1, 2), dtype=torch.int32, device=cuda)
    n0 = fa.LAUNCHES["flash_fwd_paged"]
    with pytest.raises(ValueError, match="page sizes"):
        fa.flash_prefill_paged_forward(q, pool, pool, page_list, layout,
                                       scale=0.125, causal=False, window=None,
                                       block_q=24)
    assert fa.LAUNCHES["flash_fwd_paged"] == n0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 100])
def test_flash_decode_paged_matches_plain(cuda, dtype, window):
    gen = torch.Generator().manual_seed(1)
    b, hq, hkv, d, ps, num_pages, T = 6, 32, 8, 64, 16, 200, 24
    q = torch.randn(b, hq, 1, d, generator=gen).to(cuda, dtype)
    k_pool = torch.randn(hkv, num_pages, ps, d, generator=gen).to(cuda, dtype)
    v_pool = torch.randn(hkv, num_pages, ps, d, generator=gen).to(cuda, dtype)
    kv_len = torch.tensor([1, 17, 200, 383, 384, 0], dtype=torch.int32)
    table = torch.randperm(num_pages, generator=gen)[:b * T].reshape(b, T).int()
    for i, n in enumerate(kv_len.tolist()):
        table[i, -(-n // ps):] = -1          # unallocated tail (idle lane: all)
    table, kv_len = table.to(cuda), kv_len.to(cuda)
    layout = M.paged_block_layout(kv_len, table, ps, window=window)
    kw = dict(scale=d ** -0.5, num_splits=4, window=window)
    n0 = fd.LAUNCHES["flash_decode_paged"]
    out = fd.flash_decode_paged_partials(q, k_pool, v_pool, table, kv_len,
                                         layout, **kw)
    torch.cuda.synchronize()
    assert fd.LAUNCHES["flash_decode_paged"] == n0 + 1
    plain = fd.flash_decode_paged_partials_plain(q, k_pool, v_pool, table,
                                                 kv_len, layout, **kw)
    atol, rel = _tol(dtype)
    torch.testing.assert_close(out[0], plain[0], atol=atol * 10, rtol=rel)
    torch.testing.assert_close(out[1], plain[1], atol=rel, rtol=rel)
    torch.testing.assert_close(out[2], plain[2], atol=rel, rtol=rel)
    merged = fd._merge_split_partials(*out, dtype)
    ref = fd._merge_split_partials(*plain, dtype)
    torch.testing.assert_close(merged.float(), ref.float(), atol=atol, rtol=0)
    assert torch.all(merged[5] == 0)         # the idle lane emits zeros


def test_unsupported_shapes_raise_before_launch(cuda):
    q = torch.randn(1, 2, 8, 48, device=cuda)
    lay = torch.ones((1, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_forward(q, q[:, :1], q[:, :1], None, lay,
                                   scale=1.0, causal=True, window=None,
                                   q_offset=0, block_q=8, block_k=8)
    with pytest.raises(ValueError, match="variant"):
        ops.flash_attention(torch.randn(1, 2, 8, 64, device=cuda),
                            torch.randn(1, 1, 8, 64, device=cuda),
                            torch.randn(1, 1, 8, 64, device=cuda),
                            causal=True, variant="alg3")


def test_engine_on_card_matches_cpu(cuda):
    """The kernel path on the card gives the CPU (plain-version) engine's
    greedy tokens: chunked prefill, a prefix hit, paged decode."""
    cfg = reduced_config("granite-3-2b", head_dim=16, attn_impl="pallas",
                         use_decode_kernel=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    shared = list(range(1, 25))
    prompts = [shared + [40, 41, 42], list(range(60, 79)), shared + [50]]
    outs = []
    for device in ("cpu", "cuda"):
        p = params_to(params, device)
        eng = ServingEngine(model, p, num_slots=2, capacity=64, page_size=8,
                            chunk_size=8, device=device)
        for pr in prompts:
            eng.submit(pr, max_new_tokens=6)
            eng.run()
        outs.append({r.rid: r.output for r in eng.finished})
    assert outs[0] == outs[1]
    assert fa.LAUNCHES["flash_fwd"] > 0 and fa.LAUNCHES["flash_fwd_paged"] > 0
    assert fd.LAUNCHES["flash_decode_paged"] > 0


def test_paged_engine_refuses_other_page_sizes_on_card(cuda):
    """A paged engine on the card refuses at construction a page its
    kernels do not take, naming the sizes they take; the same engine on
    the CPU is built (and serves: tests/test_torch_serve.py)."""
    cfg = reduced_config("granite-3-2b", head_dim=16, attn_impl="pallas",
                         use_decode_kernel=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    kw = dict(num_slots=2, capacity=256, page_size=128)
    with pytest.raises(ValueError, match=r"page sizes \(8, 16, 32, 64\)"):
        ServingEngine(model, params_to(params, "cuda"), device="cuda", **kw)
    ServingEngine(model, params, device="cpu", **kw)


def test_train_step_on_card_matches_cpu(cuda):
    """Two steps of ``make_train_step`` (fp32, pallas, remat on) from the
    same weights and batches on the card and on the CPU: losses within
    1e-4 relative, and every kernel of the path launched."""
    import dataclasses

    from repro_torch.data import SyntheticLM
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import make_train_step

    cfg = dataclasses.replace(reduced_config("granite-3-2b", head_dim=64,
                                             attn_impl="pallas"), remat=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    data = SyntheticLM(cfg.vocab_size, 96, 2, seed=1, mean_doc_len=32)
    losses = {}
    for dev in ("cpu", "cuda"):
        opt = adamw(warmup_cosine(1e-3, 2, 10))
        p = params_to(params, dev)
        state = opt.init(p)
        step = make_train_step(model, opt, deterministic=True)
        n0 = dict(fa.LAUNCHES)
        losses[dev] = []
        for s in range(2):
            p, state, metrics = step(p, state, data.batch_at(s))
            losses[dev].append(float(metrics["loss"]))
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert fa.LAUNCHES[name] > n0[name], name
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) <= 1e-4 * abs(b), (losses["cuda"], losses["cpu"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_k,window,masked", [
    (64, None, False), (16, 100, False), (128, None, True), (32, 37, True)])
def test_flash_decode_matches_plain(cuda, dtype, block_k, window, masked):
    """The contiguous split-KV kernel: GQA 32/8, a kv_len 0 lane (zeros), a
    full lane, a window, a kv_mask, and a block of 128 rows (two staged
    sub-tiles)."""
    gen = torch.Generator().manual_seed(block_k)
    b, hq, hkv, d, cap, splits = 6, 32, 8, 64, 512, 4
    q = torch.randn(b, hq, 1, d, generator=gen).to(cuda, dtype)
    k = torch.randn(b, hkv, cap, d, generator=gen).to(cuda, dtype)
    v = torch.randn(b, hkv, cap, d, generator=gen).to(cuda, dtype)
    kv_len = torch.tensor([1, 17, 200, 383, cap, 0], dtype=torch.int32,
                          device=cuda)
    kvm = ((torch.rand(b, cap, generator=gen) > 0.3).to(cuda)
           if masked else None)
    valid = M.decode_kv_valid(kv_len, cap, window=window, kv_mask=kvm)
    layout = M.kv_block_layout(valid, block_k)
    kw = dict(scale=d ** -0.5, block_k=block_k, num_splits=splits,
              window=window, kv_mask=kvm)
    n0 = fd.LAUNCHES["flash_decode"]
    out = fd.flash_decode_partials(q, k, v, kv_len, layout, **kw)
    torch.cuda.synchronize()
    assert fd.LAUNCHES["flash_decode"] == n0 + 1
    plain = fd.flash_decode_partials_plain(q, k, v, kv_len, layout, **kw)
    atol, rel = _tol(dtype)
    torch.testing.assert_close(out[0], plain[0], atol=atol * 10, rtol=rel)
    torch.testing.assert_close(out[1], plain[1], atol=rel, rtol=rel)
    torch.testing.assert_close(out[2], plain[2], atol=rel, rtol=rel)
    merged = fd._merge_split_partials(*out, dtype)
    ref = fd._merge_split_partials(*plain, dtype)
    torch.testing.assert_close(merged.float(), ref.float(), atol=atol, rtol=0)
    assert torch.all(merged[5] == 0)         # kv_len 0 emits zeros
    # the kernel merges in its cluster, the reference in torch: _tol apart
    torch.testing.assert_close(
        fd.flash_decode(q, k, v, kv_len, block_k=block_k, num_splits=splits,
                        window=window, kv_mask=kvm).float(),
        ref.float(), atol=atol, rtol=0)


# (hkv, n_rep, splits, window): GQA 1, 4 and 6 (two head groups of one
# CTA's 4), splits 1, 6 and 8, a window cutting inside a 64-row tile
_DECODE_GROUPS = ((4, 1, 6, None), (2, 4, 8, 100), (2, 4, 1, None),
                  (1, 6, 8, None))


def _check_decode(dtype, name, call, plain_parts, idle):
    """One fused decode launch against the plain partials and their torch
    merge: partials within 10 x atol (unnormalized sums), the output within
    atol, the idle lanes zero."""
    n0 = fd.LAUNCHES[name]
    out, parts = call()
    torch.cuda.synchronize()
    assert fd.LAUNCHES[name] == n0 + 1
    atol, rel = _tol(dtype)
    torch.testing.assert_close(parts[0], plain_parts[0], atol=atol * 10,
                               rtol=rel)
    torch.testing.assert_close(parts[1], plain_parts[1], atol=rel, rtol=rel)
    torch.testing.assert_close(parts[2], plain_parts[2], atol=rel, rtol=rel)
    ref = fd._merge_split_partials(*plain_parts, dtype)
    assert out.dtype == dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    assert torch.all(out[idle] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("page_size", [8, 16, 32, 64])
def test_flash_decode_paged_page_groups_match_plain(cuda, dtype, d,
                                                    page_size):
    """The paged decode body over 64-row tiles of 64 // page_size pages:
    an idle lane (kv_len 0), a short lane whose later splits are all SKIP,
    a dead page inside the third lane's first tile, a full lane; every
    GQA group, split count and window of ``_DECODE_GROUPS``."""
    gen = torch.Generator(device=cuda).manual_seed(d + page_size)
    b, T = 4, 24
    num_pages = b * T + 5
    kv_len = torch.tensor([0, 17, T * page_size // 2 + 5, T * page_size],
                          dtype=torch.int32, device=cuda)
    table = torch.randperm(num_pages, generator=gen, device=cuda)[:b * T]
    table = table.reshape(b, T).int()
    for i, n in enumerate(kv_len.tolist()):
        table[i, -(-n // page_size):] = -1   # unallocated tail
    table[2, 1] = -1                         # a dead page mid-sequence
    for hkv, n_rep, splits, window in _DECODE_GROUPS:
        hq = hkv * n_rep
        q = torch.randn(b, hq, 1, d, generator=gen, device=cuda).to(dtype)
        k_pool, v_pool = (torch.randn(hkv, num_pages, page_size, d,
                                      generator=gen, device=cuda).to(dtype)
                          for _ in range(2))
        layout = M.paged_block_layout(kv_len, table, page_size, window=window)
        args = (q, k_pool, v_pool, table, kv_len, layout)
        kw = dict(scale=d ** -0.5, num_splits=splits, window=window)
        _check_decode(
            dtype, "flash_decode_paged",
            lambda: fd.flash_decode_paged_from_layout(*args, **kw),
            fd.flash_decode_paged_partials_plain(*args, **kw), idle=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("block_k", [8, 24, 40, 128])
def test_flash_decode_ragged_blocks_match_plain(cuda, dtype, d, block_k):
    """The contiguous decode body with kv blocks that are not 64 rows
    (several to a tile, a tile straddling blocks, a block in two tiles):
    an idle lane, a short lane, a half-full lane with a kv_mask, a full
    lane; every GQA group, split count and window of ``_DECODE_GROUPS``."""
    gen = torch.Generator(device=cuda).manual_seed(d + block_k)
    b, cap = 4, block_k * 48                 # 48 blocks: 1, 6 or 8 splits
    kv_len = torch.tensor([0, 17, cap // 2 + 3, cap], dtype=torch.int32,
                          device=cuda)
    kvm = torch.rand(b, cap, generator=gen, device=cuda) > 0.3
    kvm[[0, 1, 3]] = True                    # the mask cuts one lane
    for hkv, n_rep, splits, window in _DECODE_GROUPS:
        hq = hkv * n_rep
        q = torch.randn(b, hq, 1, d, generator=gen, device=cuda).to(dtype)
        k, v = (torch.randn(b, hkv, cap, d, generator=gen,
                            device=cuda).to(dtype) for _ in range(2))
        valid = M.decode_kv_valid(kv_len, cap, window=window, kv_mask=kvm)
        layout = M.kv_block_layout(valid, block_k)
        args = (q, k, v, kv_len, layout)
        kw = dict(scale=d ** -0.5, block_k=block_k, num_splits=splits,
                  window=window, kv_mask=kvm)
        _check_decode(
            dtype, "flash_decode",
            lambda: fd.flash_decode_from_layout(*args, **kw),
            fd.flash_decode_partials_plain(*args, **kw), idle=0)


def _decode_case(cuda, paged, splits):
    """bf16 inputs of one decode call at granite's GQA 32/8, d 64."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    b, hq, hkv, d, ps, T = 3, 32, 8, 64, 16, 72
    q = torch.randn(b, hq, 1, d, generator=gen, device=cuda).bfloat16()
    kv_len = torch.tensor([500, 1100, 3], dtype=torch.int32, device=cuda)
    kw = dict(scale=d ** -0.5, num_splits=splits, window=None)
    if paged:
        pools = [torch.randn(hkv, b * T, ps, d, generator=gen,
                             device=cuda).bfloat16() for _ in range(2)]
        table = torch.randperm(b * T, generator=gen, device=cuda)
        table = table.reshape(b, T).int()
        layout = M.paged_block_layout(kv_len, table, ps)
        return (lambda: fd.flash_decode_paged_from_layout(
            q, *pools, table, kv_len, layout, **kw)), "flash_decode_paged"
    k, v = (torch.randn(b, hkv, T * ps, d, generator=gen,
                        device=cuda).bfloat16() for _ in range(2))
    layout = M.kv_block_layout(M.decode_kv_valid(kv_len, T * ps), 16)
    return (lambda: fd.flash_decode_from_layout(
        q, k, v, kv_len, layout, block_k=16, **kw)), "flash_decode"


@pytest.mark.parametrize("paged", [True, False])
def test_flash_decode_is_bit_identical_across_calls(cuda, paged):
    """No atomics: the cluster merges its splits in rank order, so two
    calls give the same bits (output and partials)."""
    call, _ = _decode_case(cuda, paged, 8)
    (o1, p1), (o2, p2) = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)
    for a, b in zip(p1, p2):
        assert torch.equal(a, b)


@pytest.mark.parametrize("paged", [True, False])
def test_flash_decode_refuses_more_splits_than_a_cluster(cuda, paged):
    """9 splits would need a cluster of 9 blocks: refused before launch,
    naming the limit, the launch counter unchanged."""
    call, name = _decode_case(cuda, paged, 9)
    n0 = fd.LAUNCHES[name]
    with pytest.raises(ValueError, match="1 to 8 splits"):
        call()
    assert fd.LAUNCHES[name] == n0


def _paged_grad_case(cuda, dtype, page_size, seed=0):
    """Two rows, one segment each, whose prefixes share their first pool
    page; scrambled pages, dead slots, a padded q tail in row 1."""
    gen = torch.Generator().manual_seed(seed + page_size)
    hq, hkv, d, num_pages, sq = 8, 2, 64, 60, 64
    spans, chunks = [150, 70], [64, 30]
    T = max(-(-s // page_size) for s in spans) + 2
    pages = torch.randperm(num_pages, generator=gen).int()
    page_list = torch.full((2, T), -1, dtype=torch.int32)
    kv_seg = torch.full((2, T * page_size), M.SEG_PAD_KV, dtype=torch.int32)
    kv_pos = torch.full((2, T * page_size), M.POS_PAD, dtype=torch.int32)
    q_seg = torch.full((2, sq), M.SEG_PAD_Q, dtype=torch.int32)
    q_pos = torch.full((2, sq), M.POS_PAD, dtype=torch.int32)
    nxt = 1
    for r, (span, n) in enumerate(zip(spans, chunks)):
        np_ = -(-span // page_size)
        page_list[r, 0] = pages[0]                # shared by both rows
        page_list[r, 1:np_] = pages[nxt:nxt + np_ - 1]
        nxt += np_ - 1
        kv_seg[r, :span] = 0
        kv_pos[r, :span] = torch.arange(span)
        q_seg[r, :n] = 0
        q_pos[r, :n] = torch.arange(span - n, span)
    f = lambda *sh: torch.randn(*sh, generator=gen).to(cuda, dtype)  # noqa: E731
    ids = {n: t.to(cuda) for n, t in dict(
        q_segment_ids=q_seg, kv_segment_ids=kv_seg, q_positions=q_pos,
        kv_positions=kv_pos).items()}
    return (f(2, hq, sq, d), f(hkv, num_pages, page_size, d),
            f(hkv, num_pages, page_size, d), page_list.to(cuda), ids,
            f(2, hq, sq, d))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page_size", [8, 16, 64])
def test_flash_bwd_paged_matches_plain(cuda, dtype, page_size):
    """The paged dq and dkv kernels + the fold against the plain backward
    over the gathered pages: untouched pages exactly zero, two calls
    bit-identical (no atomics anywhere)."""
    q, k_pool, v_pool, page_list, ids, do = _paged_grad_case(
        cuda, dtype, page_size)
    bq = 32
    T = page_list.shape[1]
    spec = M.MaskSpec(causal=True, **ids)
    layout = M.compile_block_layout(spec, q.shape[2], T * page_size, bq,
                                    page_size).as_array(cuda)
    layout = M.paged_prefill_block_layout(layout, page_list)
    call = dict(scale=q.shape[-1] ** -0.5, causal=True, window=None,
                block_q=bq, **ids)
    o, m, l = fa.flash_prefill_paged_forward_plain(q, k_pool, v_pool,
                                                   page_list, layout, **call)
    res = (q, k_pool, v_pool, page_list, o, do, m, l, layout)
    n0 = dict(fa.LAUNCHES)
    got = fa.flash_prefill_paged_backward(*res, **call)
    torch.cuda.synchronize()
    for name in ("flash_bwd_dq_paged", "flash_bwd_dkv_paged",
                 "flash_bwd_fold_paged"):
        assert fa.LAUNCHES[name] == n0[name] + 1
    want = fa.flash_prefill_paged_backward_plain(*res, **call)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs().max() / w.float().abs().max()
        assert err <= tol, float(err)
    named = set(page_list[page_list >= 0].tolist())
    unnamed = [p for p in range(k_pool.shape[1]) if p not in named]
    assert torch.all(got[1][:, unnamed] == 0) and torch.all(got[2][:, unnamed] == 0)
    again = fa.flash_prefill_paged_backward(*res, **call)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_paged_op_grads_on_card_match_cpu(cuda):
    """ops.flash_prefill_paged forward + backward (fp32) through the kernels
    on the card against the plain versions on the CPU."""
    q, k_pool, v_pool, page_list, ids, do = _paged_grad_case(
        cuda, torch.float32, 16, seed=5)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k_pool, v_pool)]
        o = ops.flash_prefill_paged(*leaves, page_list.to(dev),
                                    **{n: t.to(dev) for n, t in ids.items()})
        (o * do.to(dev)).sum().backward()
        grads[dev] = [t.grad.cpu() for t in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4


def _paged_group_case(cuda, d, page_size, block_q, seed=0):
    """bf16, two rows. Row 0 packs document A (span 70, 32 chunk rows) and
    document B (span 45, 30 rows) with a dead slot between their pages and
    B's first page the same pool page as A's (shared within the row); row
    1 holds document C (span 100, 40 rows) whose first page is that page
    too (shared across rows). Every row ends in dead slots, as many as make
    T no multiple of the pages per 64-key tile (page < 64). q rows 64..127
    are padding (SKIP everywhere); at block_q 32, A's and B's q-blocks see
    each other's pages as SKIP inside one tile."""
    gen = torch.Generator().manual_seed(seed + 10 * page_size + d + block_q)
    hq, hkv, num_pages, sq = 8, 2, 40, 128
    g = tuning.fwd_pages_per_tile(page_size)
    rows = [[(70, 32), (45, 30)], [(100, 40)]]
    npg = lambda span: -(-span // page_size)  # noqa: E731
    used = [sum(npg(s) for s, _ in docs) + len(docs) - 1 for docs in rows]
    T = max(used) + 1
    while g > 1 and T % g == 0:
        T += 1
    pages = torch.randperm(num_pages, generator=gen).int()
    page_list = torch.full((2, T), -1, dtype=torch.int32)
    kv_seg = torch.full((2, T * page_size), M.SEG_PAD_KV, dtype=torch.int32)
    kv_pos = torch.full((2, T * page_size), M.POS_PAD, dtype=torch.int32)
    q_seg = torch.full((2, sq), M.SEG_PAD_Q, dtype=torch.int32)
    q_pos = torch.full((2, sq), M.POS_PAD, dtype=torch.int32)
    nxt = 1
    for r, docs in enumerate(rows):
        slot = row = 0
        for s, (span, n) in enumerate(docs):
            np_ = npg(span)
            page_list[r, slot] = pages[0]                 # the shared page
            page_list[r, slot + 1:slot + np_] = pages[nxt:nxt + np_ - 1]
            nxt += np_ - 1
            lo = slot * page_size
            kv_seg[r, lo:lo + span] = s
            kv_pos[r, lo:lo + span] = torch.arange(span)
            q_seg[r, row:row + n] = s
            q_pos[r, row:row + n] = torch.arange(span - n, span)
            slot, row = slot + np_ + 1, row + n           # a dead slot between
    f = lambda *sh: torch.randn(*sh, generator=gen).to(cuda, torch.bfloat16)  # noqa: E731
    ids = {n: t.to(cuda) for n, t in dict(
        q_segment_ids=q_seg, kv_segment_ids=kv_seg, q_positions=q_pos,
        kv_positions=kv_pos).items()}
    q, k_pool, v_pool = (f(2, hq, sq, d), f(hkv, num_pages, page_size, d),
                         f(hkv, num_pages, page_size, d))
    page_list = page_list.to(cuda)
    spec = M.MaskSpec(causal=True, **ids)
    layout = M.compile_block_layout(spec, sq, T * page_size, block_q,
                                    page_size).as_array(cuda)
    layout = M.paged_prefill_block_layout(layout, page_list)
    call = dict(scale=d ** -0.5, causal=True, window=None, block_q=block_q,
                **ids)
    o, m, l = fa.flash_prefill_paged_forward_plain(q, k_pool, v_pool,
                                                   page_list, layout, **call)
    return (q, k_pool, v_pool, page_list, o, f(2, hq, sq, d), m, l,
            layout), call


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("page_size", [8, 16, 32, 64])
@pytest.mark.parametrize("block_q", [32, 64])
def test_flash_bwd_paged_bf16_page_groups_match_plain(cuda, d, page_size,
                                                      block_q):
    """The tensor-core paged dq and dkv kernels and the fold kernel against
    the plain backward: tiles that mix dead, SKIP and shared pages, a T
    that is no multiple of the pages per tile, padded q-blocks; untouched
    pages exactly zero, padded q rows' dq zero, two calls bit-identical."""
    res, call = _paged_group_case(cuda, d, page_size, block_q)
    n0 = dict(fa.LAUNCHES)
    got = fa.flash_prefill_paged_backward(*res, **call)
    torch.cuda.synchronize()
    for name in ("flash_bwd_dq_paged", "flash_bwd_dkv_paged",
                 "flash_bwd_fold_paged"):
        assert fa.LAUNCHES[name] == n0[name] + 1
    want = fa.flash_prefill_paged_backward_plain(*res, **call)
    for g, w in zip(got, want):
        assert float(w.float().abs().max()) > 0
        err = (g.float() - w.float()).abs().max() / w.float().abs().max()
        assert err <= 2e-2, float(err)
    page_list, k_pool = res[3], res[1]
    named = set(page_list[page_list >= 0].tolist())
    unnamed = [p for p in range(k_pool.shape[1]) if p not in named]
    assert unnamed
    assert torch.all(got[1][:, unnamed] == 0) and torch.all(got[2][:, unnamed] == 0)
    assert torch.all(got[0][:, :, 64:] == 0)
    again = fa.flash_prefill_paged_backward(*res, **call)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_kernel_is_bit_equal_to_plain(cuda, dtype):
    """flash_bwd_fold_paged against fold_packed_to_pool (then the pools'
    dtype): pages shared within and across rows, dead slots."""
    gen = torch.Generator().manual_seed(3)
    b, hkv, T, ps, d, num_pages = 3, 2, 9, 16, 64, 30
    packed = [torch.randn(b, hkv, T * ps, d, generator=gen).to(cuda)
              for _ in range(2)]
    page_list = torch.randint(0, 20, (b, T), generator=gen, dtype=torch.int32)
    page_list[:, 0] = 7
    page_list[0, -1] = 7
    page_list[1, 2] = page_list[2, 5] = -1
    page_list = page_list.to(cuda)
    n0 = fa.LAUNCHES["flash_bwd_fold_paged"]
    got = fa.launch_fold_paged(*packed, page_list, num_pages, dtype)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_bwd_fold_paged"] == n0 + 1
    for g, x in zip(got, packed):
        assert g.dtype == dtype
        assert torch.equal(g, fa.fold_packed_to_pool(x, page_list,
                                                     num_pages).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_backward_never_waits_on_the_card(cuda, dtype):
    """The whole paged backward (D, the paged dq and dkv kernels, the fold
    order and the fold) runs under torch.cuda.set_sync_debug_mode("error"):
    no host sync on its path."""
    res, call = _paged_group_case(cuda, 64, 16, 64, seed=1)
    if dtype == torch.float32:
        res = tuple(t.float() if t.dtype == torch.bfloat16 else t for t in res)
    fa.flash_prefill_paged_backward(*res, **call)      # build and load first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fa.flash_prefill_paged_backward(*res, **call)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in got)


def test_bf16_paged_backward_refuses_other_page_sizes(cuda):
    """A page the tensor-core pair's 64-key tile cannot gather whole raises
    before launch, with the forward's message."""
    q = torch.randn(1, 2, 24, 64, device=cuda, dtype=torch.bfloat16)
    pool = torch.randn(1, 4, 24, 64, device=cuda, dtype=torch.bfloat16)
    stats = torch.zeros((1, 2, 24), device=cuda)
    page_list = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    layout = torch.ones((1, 1, 2), dtype=torch.int32, device=cuda)
    n0 = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="page sizes"):
        fa.flash_prefill_paged_backward(q, pool, pool, page_list, q, q, stats,
                                        stats, layout, scale=0.125,
                                        causal=False, window=None, block_q=24)
    assert fa.LAUNCHES == n0


def test_dense_engine_on_card_matches_cpu(cuda):
    """Dense slot mode with the contiguous decode kernel on the card gives
    the CPU engine's greedy tokens, and the paged engine's on the card."""
    cfg = reduced_config("granite-3-2b", head_dim=16, attn_impl="pallas",
                         use_decode_kernel=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    prompts = [list(range(1, 28)), list(range(60, 79)), [5, 9, 2]]
    outs = {}
    for device, paged in (("cpu", False), ("cuda", False), ("cuda", True)):
        eng = ServingEngine(model, params_to(params, device), num_slots=2,
                            capacity=64, paged=paged, device=device)
        n0 = fd.LAUNCHES["flash_decode"]
        for pr in prompts:
            eng.submit(pr, max_new_tokens=6)
        eng.run()
        outs[(device, paged)] = {r.rid: r.output for r in eng.finished}
        if device == "cuda" and not paged:
            assert fd.LAUNCHES["flash_decode"] > n0
    assert outs[("cpu", False)] == outs[("cuda", False)] == outs[("cuda", True)]


# (name, causal, d, n_rep) of the attention layers the new training paths
# run: bert-large's (non-causal, packed documents, d 64, MHA) and
# olmo-1b's (causal, packed documents, d 128, MHA)
_NEW_TRAIN_SHAPES = (("bert", False, 64, 1), ("olmo", True, 128, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,causal,d,n_rep", _NEW_TRAIN_SHAPES)
def test_new_train_shapes_match_plain(cuda, dtype, name, causal, d, n_rep):
    """The forward and the dq / dkv pair at the attention shapes of the
    bert-large and olmo-1b paths against their plain versions (packed
    documents with a ragged tail), two backward calls bit-identical."""
    gen = torch.Generator().manual_seed(d + causal)
    b, hkv, S, bq, bk = 2, 4, 320, 64, 64
    hq = hkv * n_rep
    q = torch.randn(b, hq, S, d, generator=gen).to(cuda, dtype)
    k, v = (torch.randn(b, hkv, S, d, generator=gen).to(cuda, dtype)
            for _ in range(2))
    seg = _segments(gen, b, S, cuda)
    spec = M.MaskSpec(causal=causal, q_segment_ids=seg, kv_segment_ids=seg)
    layout = M.compile_block_layout(spec, S, S, bq, bk).as_array(cuda)
    call = dict(scale=d ** -0.5, causal=causal, window=None, q_offset=0,
                block_q=bq, block_k=bk, q_segment_ids=seg, kv_segment_ids=seg)
    n0 = dict(fa.LAUNCHES)
    out = fa.flash_attention_forward(q, k, v, None, layout, **call)
    torch.cuda.synchronize()
    _check(out, fa.flash_attention_forward_plain(q, k, v, None, layout,
                                                 **call), dtype)
    do = torch.randn(q.shape, generator=gen).to(cuda, dtype)
    res = (q, k, v, out[0], do, out[1], out[2], None, layout)
    got = fa.flash_attention_backward(*res, **call)
    torch.cuda.synchronize()
    for kern in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert fa.LAUNCHES[kern] == n0[kern] + 1, kern
    _check_grads(got, fa.flash_attention_backward_plain(*res, **call), dtype)
    again = fa.flash_attention_backward(*res, **call)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 8])
@pytest.mark.parametrize("paged", [True, False])
def test_decode_at_qwen3_group_matches_plain(cuda, dtype, splits, paged):
    """The decode body at qwen3-32b's GQA 8 (two head groups of one CTA's
    4) and d 128, 16 query heads over 2 kv heads: an idle lane, a short
    lane, a long lane and a full one, against the plain partials and their
    merge."""
    gen = torch.Generator(device=cuda).manual_seed(splits + 2 * paged)
    b, hkv, n_rep, d, ps, T = 4, 2, 8, 128, 16, 64
    hq = hkv * n_rep
    kv_len = torch.tensor([0, 21, 700, T * ps], dtype=torch.int32,
                          device=cuda)
    q = torch.randn(b, hq, 1, d, generator=gen, device=cuda).to(dtype)
    kw = dict(scale=d ** -0.5, num_splits=splits, window=None)
    if paged:
        num_pages = b * T
        table = torch.randperm(num_pages, generator=gen, device=cuda)
        table = table.reshape(b, T).int()
        for i, n in enumerate(kv_len.tolist()):
            table[i, -(-n // ps):] = -1
        pools = [torch.randn(hkv, num_pages, ps, d, generator=gen,
                             device=cuda).to(dtype) for _ in range(2)]
        args = (q, *pools, table, kv_len,
                M.paged_block_layout(kv_len, table, ps))
        _check_decode(dtype, "flash_decode_paged",
                      lambda: fd.flash_decode_paged_from_layout(*args, **kw),
                      fd.flash_decode_paged_partials_plain(*args, **kw),
                      idle=0)
        return
    cap = T * ps
    k, v = (torch.randn(b, hkv, cap, d, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    layout = M.kv_block_layout(M.decode_kv_valid(kv_len, cap), 64)
    args = (q, k, v, kv_len, layout)
    kw["block_k"] = 64
    _check_decode(dtype, "flash_decode",
                  lambda: fd.flash_decode_from_layout(*args, **kw),
                  fd.flash_decode_partials_plain(*args, **kw), idle=0)


def test_qwen3_engine_on_card_matches_cpu(cuda):
    """Reduced qwen3-32b (qk-norm, untied head, head_dim 32 decoupled from
    d_model 64) served on the card gives the CPU engine's greedy tokens,
    paged and dense."""
    cfg = reduced_config("qwen3-32b", head_dim=32, attn_impl="pallas",
                         use_decode_kernel=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    shared = list(range(1, 25))
    prompts = [shared + [40, 41, 42], list(range(60, 79)), shared + [50]]
    for paged in (True, False):
        outs = []
        for device in ("cpu", "cuda"):
            eng = ServingEngine(model, params_to(params, device), num_slots=2,
                                capacity=64, page_size=8, paged=paged,
                                chunk_size=8 if paged else None,
                                device=device)
            for pr in prompts:
                eng.submit(pr, max_new_tokens=6)
                eng.run()
            outs.append({r.rid: r.output for r in eng.finished})
        assert outs[0] == outs[1], paged


def test_bert_lamb_train_step_on_card_matches_cpu(cuda):
    """Two steps of reduced bert-large (non-causal, LayerNorm, GELU) with
    ``lamb(warmup_poly)`` on the card and on the CPU, fp32: losses within
    1e-4 relative, every kernel of the path launched."""
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import lamb, warmup_poly
    from repro_torch.train import make_train_step

    cfg = reduced_config("bert-large", head_dim=64, attn_impl="pallas")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    data = SyntheticLM(cfg.vocab_size, 96, 2, seed=1, mean_doc_len=32)
    losses = {}
    for dev in ("cpu", "cuda"):
        opt = lamb(warmup_poly(3.75e-3, 1, 10))
        p = params_to(params, dev)
        state = opt.init(p)
        step = make_train_step(model, opt, deterministic=True)
        n0 = dict(fa.LAUNCHES)
        losses[dev] = []
        for s in range(2):
            p, state, metrics = step(p, state, data.batch_at(s))
            losses[dev].append(float(metrics["loss"]))
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert fa.LAUNCHES[name] > n0[name], name
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) <= 1e-4 * abs(b), (losses["cuda"], losses["cpu"])
