"""Card tests of the hand-written CUDA kernels and of the MoE layer: each kernel against its
plain PyTorch version on the same CUDA inputs (the forward, its dropout
and "paper" variants, ragged tiles and rows with no key (a sequence-parallel
slab of padding rows only, for the paged forward), the dq and dkv
backward kernels (bf16 on tensor cores: every head dim, ragged tiles, GQA
n_rep 1 and 4, dropout at two seeds and at a sharded rank's global
coordinates, two calls bit-identical), the paged kernels with several pages to a kv tile,
the decode body that merges its splits in a cluster (paged: pages of 8-64
rows, dead and SKIP pages; contiguous: ragged blocks, windows, kv_mask;
every head dim, GQA 1/4/6, splits 1/6/8, two calls bit-identical, 9
splits refused), the paged dq and dkv kernels with the fold
into pool shape, on tensor cores in bf16 with several pages to a kv tile,
and with no host sync (the sm90 paged pair at pages 8-64, head dims 64 /
96 / 128, GQA n_rep 1 / 4 / 5 / 8, dead slots, shared pages and SKIP
pages inside live page groups, both CTA tiles, against the plain backward
and the mma.sync pair), the differentiable ops and a train step on the card
against the CPU, and the serving engine (paged and dense) on the card
against the same engine on the CPU (and refusing pages its kernels do not
take); the MoE layer on the card against the CPU (fp32), bit-identical
twice and free of host syncs in bf16, reduced olmoe-1b-7b served on the
card against the CPU, and the serving kernels at the MoE serves' head
groups (d 128, GQA 1 and 4); the kernels at hymba-1.5b's GQA 5 with a
window that skips whole tiles (#1, #2, #3, and #7 at window 1024),
reduced hymba served and trained on the card against the CPU, and one
bf16 SSM layer at mamba2-2.7b's heads bit-identical twice and free of host
syncs. Marked ``gpu``; skipped
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
@pytest.mark.parametrize("d", [16, 64, 96, 128])
@pytest.mark.parametrize("mask", ["causal_segments", "window_kvmask_tail",
                                  "positions"])
def test_flash_fwd_matches_plain(cuda, dtype, d, mask):
    _, args, call = _contiguous_case(cuda, dtype, d, mask)
    name = _fwd_kernel(dtype, d, 64, 64, args[4])
    n0 = dict(fa.LAUNCHES)
    out = fa.flash_attention_forward(*args, **call)
    torch.cuda.synchronize()
    _check_one_fwd(n0, name)
    plain = fa.flash_attention_forward_plain(*args, **call)
    _check_one_fwd(n0, name)                      # the plain call counts nothing
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
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128])
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
@pytest.mark.parametrize("d", [32, 64, 96])
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


def _bwd_kernels(dtype, d, block_q=64, block_k=64):
    """The launch counters of the backward pair body that
    ``fa.backward_body`` picks for a contiguous call: the sm90 pair in bf16
    at d 64 / 96 / 128 over 64 x 64 blocks, flash_bwd.cu's otherwise."""
    body = fa.backward_body(on_card=True, dtype=dtype, head_dim=d,
                            block_q=block_q, block_k=block_k, paged=False)
    end = "_sm90" if body == "sm90" else ""
    return f"flash_bwd_dq{end}", f"flash_bwd_dkv{end}"


def _paged_bwd_kernels(dtype, d, block_q, page_size, layout):
    """The launch counters of the paged backward pair body that
    ``fa.backward_body`` picks for a call over ``layout`` (b, nq, T): the
    sm90 pair in bf16 at d 64 / 96 / 128 over 64-row q blocks,
    flash_bwd.cu's otherwise."""
    nq, nk = layout.shape[-2:]
    body = fa.backward_body(on_card=True, dtype=dtype, head_dim=d,
                            block_q=block_q, block_k=page_size, paged=True,
                            nq=nq, nk=nk)
    end = "_sm90" if body == "sm90" else ""
    return f"flash_bwd_dq_paged{end}", f"flash_bwd_dkv_paged{end}"


_FWD_COUNTERS = ("flash_fwd", "flash_fwd_sm90", "flash_fwd_paged",
                 "flash_fwd_paged_sm90")


def _fwd_kernel(dtype, d, block_q, block_k, layout, paged=False):
    """The launch counter of the forward body ``fa.forward_body`` picks for
    a call over ``layout`` (paged: ``block_k`` is the page): the sm90 body
    in bf16 at d 64 / 96 / 128 over 64-row blocks (or one block),
    flash_fwd.cu's otherwise."""
    nq, nk = layout.shape[-2:]
    body = fa.forward_body(on_card=True, dtype=dtype, head_dim=d,
                           block_q=block_q, block_k=block_k, paged=paged,
                           nq=nq, nk=nk)
    name = "flash_fwd_paged" if paged else "flash_fwd"
    return name + "_sm90" if body == "sm90" else name


def _check_one_fwd(n0, name):
    """Exactly one forward launch since the counts ``n0``, counted as
    ``name``."""
    for c in _FWD_COUNTERS:
        assert fa.LAUNCHES[c] == n0[c] + (c == name), c


def _launched(n0, name):
    """Whether kernel ``name`` launched since the counts ``n0`` (for the
    backward pair: either body)."""
    names = [n for n in (name, name + "_sm90") if n in fa.LAUNCHES]
    return sum(fa.LAUNCHES[n] - n0[n] for n in names) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128])
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
    dq_name, dkv_name = _bwd_kernels(dtype, d)
    n_dq, n_dkv = fa.LAUNCHES[dq_name], fa.LAUNCHES[dkv_name]
    res = (*args[:3], o, do, m, l, *args[3:])
    got = fa.flash_attention_backward(*res, **call)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[dq_name] == n_dq + 1
    assert fa.LAUNCHES[dkv_name] == n_dkv + 1
    want = fa.flash_attention_backward_plain(*res, **call)
    _check_grads(got, want, dtype)
    again = fa.flash_attention_backward(*res, **call)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


# the sm90 pair (csrc/flash_bwd_sm90.cu): (b, hq, hkv, sq, sk, d) and the
# mask of each case; "butterfly" is a pattern of 128-row blocks refined to
# the 64-row tiles, "dp2tp2" train-dp2tp2's rank layer (its dkv grid takes
# 64-row CTA tiles, its dq grid 128)
_SM90_CASES = {
    "noncausal_d64": ((2, 4, 4, 320, 320, 64), dict(causal=False)),
    "causal_d64_rep4": ((2, 8, 2, 320, 320, 64), dict(causal=True)),
    "causal_d96_rep1": ((2, 4, 4, 320, 320, 96), dict(causal=True)),
    "causal_d128_rep8": ((1, 8, 1, 320, 320, 128), dict(causal=True)),
    "segments_d96_rep4": ((2, 8, 2, 384, 384, 96), dict(causal=True, seg=True)),
    "window1024_rep5": ((1, 10, 2, 2048, 2048, 64), dict(causal=True,
                                                         window=1024)),
    "kvmask_d128_rep8": ((2, 8, 1, 320, 320, 128), dict(causal=False,
                                                        kv_mask=True)),
    "butterfly_d64": ((2, 4, 2, 1024, 1024, 64), dict(causal=False,
                                                      sparse=128)),
    "butterfly_causal_kvmask": ((1, 4, 2, 1024, 1024, 64), dict(
        causal=True, sparse=128, kv_mask=True)),
    "dropout_d64": ((2, 8, 2, 320, 320, 64), dict(causal=True, seg=True,
                                                  dropout=0.1)),
    "dropout_d96": ((2, 4, 4, 320, 320, 96), dict(causal=True, dropout=0.1)),
    "dropout_d128": ((2, 8, 2, 320, 320, 128), dict(causal=False,
                                                    dropout=0.1)),
    "cross_64x1024": ((4, 16, 16, 64, 1024, 64), dict(causal=False)),
    "dp2tp2": ((2, 16, 4, 2048, 2048, 64), dict(causal=True, seg=True)),
}


def _sm90_case(cuda, dims, opts, seed=0):
    """Inputs, the plain forward's residuals, layout and call kwargs of one
    ``_SM90_CASES`` case, in bf16 at 64 x 64 tiles."""
    b, hq, hkv, sq, sk, d = dims
    gen = torch.Generator().manual_seed(seed + sq + d + hq)
    bf16 = torch.bfloat16
    q = torch.randn(b, hq, sq, d, generator=gen).to(cuda, bf16)
    k = torch.randn(b, hkv, sk, d, generator=gen).to(cuda, bf16)
    v = torch.randn(b, hkv, sk, d, generator=gen).to(cuda, bf16)
    causal, window = opts["causal"], opts.get("window")
    seg = _segments(gen, b, sk, cuda) if opts.get("seg") else None
    kvm = None
    if opts.get("kv_mask"):
        kvm = (torch.rand(b, sk, generator=gen) > 0.2)
        kvm[:, sk - 40:] = False
        kvm = kvm.to(cuda)
    sparse = None
    if opts.get("sparse"):
        blk = opts["sparse"]
        tile, r = tuning.sparse_tile(blk, on_card=True)
        assert tile == 64
        sparse = M.refine_block_layout(
            M.butterfly_block_layout(sq, sk, blk, blk, causal=causal), r, r)
    q_offset = sk - sq if causal else 0
    spec = M.MaskSpec(causal=causal, window=window, q_offset=q_offset,
                      kv_mask=kvm, q_segment_ids=seg, kv_segment_ids=seg,
                      sparse_layout=sparse)
    layout = M.compile_block_layout(spec, sq, sk, 64, 64).as_array(cuda)
    call = dict(scale=d ** -0.5, causal=causal, window=window,
                q_offset=q_offset, block_q=64, block_k=64,
                q_segment_ids=seg, kv_segment_ids=seg)
    if opts.get("dropout"):
        call.update(dropout_p=opts["dropout"], dropout_seed=seed + 11,
                    dropout_dims=(sq - 5, sk - 3))
    o, m, l = fa.flash_attention_forward_plain(q, k, v, kvm, layout, **call)
    do = torch.randn(q.shape, generator=gen).to(cuda, bf16)
    return (q, k, v, o, do, m, l, kvm, layout), call


def _check_sm90_pair(res, call):
    """The sm90 pair through ``flash_attention_backward`` against the plain
    backward and against the mma.sync body on the same residuals (2e-2 of
    each gradient's max); only the sm90 counters move; two calls
    bit-identical."""
    n0 = dict(fa.LAUNCHES)
    got = fa.flash_attention_backward(*res, **call)
    torch.cuda.synchronize()
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert fa.LAUNCHES[name + "_sm90"] == n0[name + "_sm90"] + 1, name
        assert fa.LAUNCHES[name] == n0[name], name
    _check_grads(got, fa.flash_attention_backward_plain(*res, **call),
                 torch.bfloat16)
    ops_ = fa.prepare_backward(*res, **call)
    assert ops_.body == "sm90"
    mma = (fa.launch_dq(ops_, _mma_body=True),
           *fa.launch_dkv(ops_, _mma_body=True))
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_bwd_dq"] == n0["flash_bwd_dq"] + 1
    _check_grads(got, mma, torch.bfloat16)
    again = fa.flash_attention_backward(*res, **call)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("case", sorted(_SM90_CASES))
def test_sm90_pair_matches_plain_and_mma_body(cuda, case):
    """The wgmma/TMA pair at every mask it takes (causal and not, packed
    documents, window 1024, kv_mask, a butterfly pattern, dropout 0.1),
    GQA n_rep 1, 4, 5 and 8, d 64, 96 and 128, sq = sk = 320 (no multiple
    of the 128-row CTA tile), 64 q rows against 1024 keys, train-dp2tp2's
    small batch."""
    dims, opts = _SM90_CASES[case]
    _check_sm90_pair(*_sm90_case(cuda, dims, opts))


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_sm90_pair_both_cta_tiles(cuda, monkeypatch, rows, d, dropout):
    """Each CTA tile of the sm90 pair (``tuning.sm90_bwd_rows`` picks it
    by shape; forced here, but for dkv at d 128, which takes 128 only):
    128 rows, one layout block per consumer warpgroup, and 64, the two
    warpgroups splitting the walk and adding their sums; packed documents,
    GQA 4, 5 q-blocks (the last 128-row tile half past the end)."""
    monkeypatch.setattr(fa, "sm90_bwd_rows",
                        lambda *a, kernel="dq", head_dim=64: (
                            128 if kernel == "dkv" and head_dim == 128
                            else rows))
    opts = dict(causal=True, seg=True, dropout=dropout or None)
    _check_sm90_pair(*_sm90_case(cuda, (2, 8, 2, 320, 320, d), opts))


def test_sm90_cta_tile_rule_on_card(cuda):
    """The chooser's CTA tile at train-dp2tp2's rank layer on this card:
    dq 128 rows, dkv 64 (128 CTAs at 128 would leave SMs idle)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert tuning.sm90_bwd_rows(2, 16, 32, sms) == 128
    assert tuning.sm90_bwd_rows(2, 4, 32, sms, kernel="dkv") == (
        64 if sms > 128 else 128)


# the sm90 forward (csrc/flash_fwd_sm90.cu): (b, hq, hkv, sq, sk, d) and the
# mask of each case; blocks of 64 rows, or one block of the whole axis where
# it is shorter; "cross_64x1024" takes split mode (64 CTAs), "dp2tp2" the
# 128-row CTA tile
_SM90_FWD_CASES = {
    "noncausal_d64": ((2, 4, 4, 320, 320, 64), dict(causal=False)),
    "causal_d64_rep4_paper": ((2, 8, 2, 320, 320, 64), dict(causal=True,
                                                            paper=True)),
    "causal_d96_rep1": ((2, 4, 4, 320, 320, 96), dict(causal=True)),
    "causal_d128_rep8": ((1, 8, 1, 320, 320, 128), dict(causal=True)),
    "segments_d96_rep4": ((2, 8, 2, 384, 384, 96), dict(causal=True, seg=True)),
    "qoffset_segments_d128": ((2, 8, 2, 192, 448, 128), dict(causal=True,
                                                             seg=True)),
    "window1024_rep5": ((1, 10, 2, 2048, 2048, 64), dict(causal=True,
                                                         window=1024)),
    "window_valid_kvmask": ((2, 8, 2, 128, 192, 64), dict(
        causal=True, window=37, valid=180, kv_mask=True)),
    "kvmask_d128_rep8": ((2, 8, 1, 320, 320, 128), dict(causal=False,
                                                        kv_mask=True)),
    "butterfly_d64": ((2, 4, 2, 1024, 1024, 64), dict(causal=False,
                                                      sparse=128)),
    "butterfly_causal_kvmask": ((1, 4, 2, 1024, 1024, 64), dict(
        causal=True, sparse=128, kv_mask=True)),
    "dropout_d64": ((2, 8, 2, 320, 320, 64), dict(causal=True, seg=True,
                                                  dropout=0.1)),
    "dropout_d96_paper": ((2, 4, 4, 320, 320, 96), dict(
        causal=True, dropout=0.1, paper=True)),
    "dropout_d128": ((2, 8, 2, 320, 320, 128), dict(causal=False,
                                                    dropout=0.1)),
    "cross_64x1024": ((4, 16, 16, 64, 1024, 64), dict(causal=False)),
    "dp2tp2": ((2, 16, 4, 2048, 2048, 64), dict(causal=True, seg=True)),
    "one_block_24": ((2, 4, 2, 24, 24, 64), dict(causal=True, seg=True)),
    "q_block_40_d96": ((2, 8, 2, 40, 192, 96), dict(causal=True)),
    "kv_block_16_d128": ((2, 4, 2, 128, 16, 128), dict(causal=False)),
}


def _sm90_fwd_case(cuda, dims, opts, seed=0):
    """Inputs, layout and call kwargs of one ``_SM90_FWD_CASES`` case in
    bf16: documents over the keys (the q rows are the last ``sq`` of them,
    ``q_offset = sk - sq`` when causal), a kv_mask that drops the last 40
    keys and a fifth of the rest, a butterfly of 128-row blocks refined to
    64, dropout over unpadded dims, the "paper" variant."""
    b, hq, hkv, sq, sk, d = dims
    gen = torch.Generator().manual_seed(seed + sq + sk + d + hq)
    bf16 = torch.bfloat16
    q = torch.randn(b, hq, sq, d, generator=gen).to(cuda, bf16)
    k = torch.randn(b, hkv, sk, d, generator=gen).to(cuda, bf16)
    v = torch.randn(b, hkv, sk, d, generator=gen).to(cuda, bf16)
    causal, window = opts["causal"], opts.get("window")
    q_offset = sk - sq if causal else 0
    q_seg = kv_seg = None
    if opts.get("seg"):
        kv_seg = _segments(gen, b, sk, cuda)
        q_seg = kv_seg[:, sk - sq:].contiguous()
    kvm = None
    if opts.get("kv_mask"):
        kvm = (torch.rand(b, sk, generator=gen) > 0.2)
        kvm[:, sk - 40:] = False
        kvm = kvm.to(cuda)
    bq, bk = min(64, sq), min(64, sk)
    sparse = None
    if opts.get("sparse"):
        blk = opts["sparse"]
        tile, r = tuning.sparse_tile(blk, on_card=True)
        sparse = M.refine_block_layout(
            M.butterfly_block_layout(sq, sk, blk, blk, causal=causal), r, r)
    spec = M.MaskSpec(causal=causal, window=window, q_offset=q_offset,
                      kv_valid_len=opts.get("valid"), kv_mask=kvm,
                      q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                      sparse_layout=sparse)
    layout = M.compile_block_layout(spec, sq, sk, bq, bk).as_array(cuda)
    call = dict(scale=d ** -0.5, causal=causal, window=window,
                q_offset=q_offset, kv_valid_len=opts.get("valid"),
                block_q=bq, block_k=bk, q_segment_ids=q_seg,
                kv_segment_ids=kv_seg)
    if opts.get("dropout"):
        call.update(dropout_p=opts["dropout"], dropout_seed=seed + 11,
                    dropout_dims=(sq - 5, sk - 3))
    if opts.get("paper"):
        call["variant"] = "paper"
    return (q, k, v, kvm, layout), call


def _check_sm90_fwd(args, call, paged=False):
    """The sm90 forward against its plain version and against the mma.sync
    body on the same inputs (o within 2e-2, m and l 1e-2 relative); only
    the sm90 counter moves on the path's call; two calls bit-identical."""
    fwd = fa.flash_prefill_paged_forward if paged else fa.flash_attention_forward
    plain = (fa.flash_prefill_paged_forward_plain if paged
             else fa.flash_attention_forward_plain)
    name = "flash_fwd_paged" if paged else "flash_fwd"
    n0 = dict(fa.LAUNCHES)
    out = fwd(*args, **call)
    torch.cuda.synchronize()
    _check_one_fwd(n0, name + "_sm90")
    _check(out, plain(*args, **call), torch.bfloat16)
    mma = fwd(*args, **call, _mma_body=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[name] == n0[name] + 1
    _check(out, mma, torch.bfloat16)
    again = fwd(*args, **call)
    assert all(torch.equal(a, g) for a, g in zip(again, out))
    return out


@pytest.mark.parametrize("case", sorted(_SM90_FWD_CASES))
def test_sm90_fwd_matches_plain_and_mma_body(cuda, case):
    """The wgmma/TMA forward at every mask it takes (causal and not, packed
    documents, a q_offset, windows, kv_valid_len, kv_mask, a butterfly
    pattern, dropout 0.1, "paper"), GQA n_rep 1, 4, 5 and 8, d 64, 96 and
    128, 320 rows (no multiple of the 128-row CTA tile), 64 q rows against
    1024 keys (split mode), one q or kv block shorter than 64 rows."""
    dims, opts = _SM90_FWD_CASES[case]
    _check_sm90_fwd(*_sm90_fwd_case(cuda, dims, opts))


@pytest.mark.parametrize("rows,splits", [(128, 1), (64, 1), (64, 2), (64, 3),
                                         (64, 8)])
@pytest.mark.parametrize("d", [64, 96, 128])
def test_sm90_fwd_every_cta_mode(cuda, monkeypatch, rows, splits, d):
    """Each CTA mode of the sm90 forward (``tuning.sm90_fwd_rows`` /
    ``sm90_fwd_splits`` pick one by shape; forced here): 128 rows (the last
    tile half past the end), 64 rows merged in the CTA, and the walk split
    over 2, 3 and 8 CTAs of a cluster (some with no tile), over packed
    documents with dropout."""
    monkeypatch.setattr(fa, "sm90_fwd_rows", lambda *a, **k: rows)
    monkeypatch.setattr(fa, "sm90_fwd_splits", lambda *a, **k: splits)
    opts = dict(causal=True, seg=True, dropout=0.1, paper=d == 96)
    _check_sm90_fwd(*_sm90_fwd_case(cuda, (2, 8, 2, 320, 320, d), opts))


def _sm90_paged_case(cuda, d, page_size, sq, variant="fa2", seed=0):
    """A prefill chunk of two documents' tails against their paged prefixes
    (GQA 8/2): a dead slot between the documents' pages and two after, the
    page count no multiple of the pages a tile gathers (pages below 64), the
    chunks' rows at the end of their documents (a chunk's q_offset) and
    padding rows past them with no key; 64-row q blocks, or one block of
    ``sq`` < 64 rows."""
    gen = torch.Generator().manual_seed(seed + 7 * page_size + d + sq)
    hq, hkv, num_pages = 8, 2, 90
    spans = [300, 130]
    chunks = [sq // 2 + 5, sq // 3] if sq >= 64 else [sq - 14, 10]
    bq = min(64, sq)
    bf16 = torch.bfloat16
    pools = [torch.randn(hkv, num_pages, page_size, d, generator=gen).to(
        cuda, bf16) for _ in range(2)]
    n_pages = [-(-s // page_size) for s in spans]
    T = n_pages[0] + 1 + n_pages[1] + 2
    pages = torch.randperm(num_pages, generator=gen).int()
    page_list = torch.full((1, T), -1, dtype=torch.int32)
    kv_seg = torch.full((1, T * page_size), M.SEG_PAD_KV, dtype=torch.int32)
    kv_pos = torch.full((1, T * page_size), M.POS_PAD, dtype=torch.int32)
    q_seg = torch.full((1, sq), M.SEG_PAD_Q, dtype=torch.int32)
    q_pos = torch.full((1, sq), M.POS_PAD, dtype=torch.int32)
    slot = row = used = 0
    for s, (span, n, np_) in enumerate(zip(spans, chunks, n_pages)):
        page_list[0, slot:slot + np_] = pages[used:used + np_]
        kv_seg[0, slot * page_size:slot * page_size + span] = s
        kv_pos[0, slot * page_size:slot * page_size + span] = torch.arange(span)
        q_seg[0, row:row + n] = s
        q_pos[0, row:row + n] = torch.arange(span - n, span)
        slot, row, used = slot + np_ + 1, row + n, used + np_
    q = torch.randn(1, hq, sq, d, generator=gen).to(cuda, bf16)
    a = {n: t.to(cuda) for n, t in dict(
        q_segment_ids=q_seg, kv_segment_ids=kv_seg, q_positions=q_pos,
        kv_positions=kv_pos).items()}
    layout = M.compile_block_layout(M.MaskSpec(causal=True, **a), sq,
                                    T * page_size, bq, page_size).as_array(cuda)
    layout = M.paged_prefill_block_layout(layout, page_list.to(cuda))
    call = dict(scale=d ** -0.5, causal=True, window=None, block_q=bq,
                variant=variant, **a)
    return (q, *pools, page_list.to(cuda), layout), call


@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("page_size", [8, 16, 32, 64])
@pytest.mark.parametrize("sq", [128, 40])
def test_sm90_paged_fwd_matches_plain_and_mma_body(cuda, d, page_size, sq):
    """The paged sm90 forward: 64 / page_size pages a tile by TMA, dead and
    SKIP pages zero-filled past the pool, every head dim and page size, two
    64-row q blocks or one block of 40 rows; with a row that has no key."""
    args, call = _sm90_paged_case(cuda, d, page_size, sq)
    out = _check_sm90_fwd(args, call, paged=True)
    _check_empty_row(out, 0, sq - 1)


@pytest.mark.parametrize("rows,splits", [(128, 1), (64, 1), (64, 4)])
@pytest.mark.parametrize("variant", ["fa2", "paper"])
def test_sm90_paged_fwd_every_cta_mode(cuda, monkeypatch, rows, splits,
                                       variant):
    """The paged sm90 forward in each CTA mode (forced), both variants."""
    monkeypatch.setattr(fa, "sm90_fwd_rows", lambda *a, **k: rows)
    monkeypatch.setattr(fa, "sm90_fwd_splits", lambda *a, **k: splits)
    _check_sm90_fwd(*_sm90_paged_case(cuda, 64, 16, 192, variant), paged=True)


@pytest.mark.parametrize("d", [64, 96, 128])
def test_sm90_fwd_residuals_feed_the_sm90_backward(cuda, d):
    """The sm90 forward's (o, m, l) feed the sm90 backward pair: its
    gradients within 2e-2 (scaled by their max) of the plain backward fed
    the plain forward's residuals, over packed documents with dropout;
    only the sm90 counters move."""
    args, call = _sm90_fwd_case(cuda, (2, 8, 2, 320, 320, d), dict(
        causal=True, seg=True, dropout=0.1))
    q, k, v, kvm, layout = args
    n0 = dict(fa.LAUNCHES)
    o, m, l = fa.flash_attention_forward(*args, **call)
    po, pm, pl = fa.flash_attention_forward_plain(*args, **call)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(d)).to(
        cuda, torch.bfloat16)
    got = fa.flash_attention_backward(q, k, v, o, do, m, l, kvm, layout, **call)
    torch.cuda.synchronize()
    want = fa.flash_attention_backward_plain(q, k, v, po, do, pm, pl, kvm,
                                             layout, **call)
    _check_grads(got, want, torch.bfloat16)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert fa.LAUNCHES[name + "_sm90"] == n0[name + "_sm90"] + 1, name
        assert fa.LAUNCHES[name] == n0[name], name


def test_sm90_fwd_mode_rule_on_card(cuda):
    """The chooser's CTA mode on this card: 128 rows at granite's train
    layer, 64 rows and one split at seamless's cross prefill, 8 splits for
    a 64-row chunk of 8 heads against 16384 keys."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert tuning.sm90_fwd_rows(4, 32, 32, sms) == 128
    assert tuning.sm90_fwd_rows(4, 16, 1, sms) == 64
    assert tuning.sm90_fwd_splits(4, 16, 1, 16, sms) == 1
    assert tuning.sm90_fwd_splits(1, 8, 1, 256, sms) == 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128])
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
@pytest.mark.parametrize("coords", [(3, 2, 32), (1, 6, 16)])
def test_dropout_at_global_coordinates_matches_plain(cuda, dtype, coords):
    """A sharded step's rank: its buffer at rows b0 and heads h0 of a
    global batch of H heads (``dropout_coords``). #1, #2 and #3 with
    dropout 0.2 against their plain versions at the same coordinates (each
    side's backward fed its own forward's residuals); the coordinates
    reach the kernel's hash (o differs from the default's), and the
    default (0, 0, the buffer's heads) is bit-equal to passing it."""
    gen, args, call = _contiguous_case(cuda, dtype, 64, "causal_segments",
                                       seed=7)
    call.update(dropout_p=0.2, dropout_seed=99, dropout_dims=(120, 190),
                dropout_coords=coords)
    out = fa.flash_attention_forward(*args, **call)
    torch.cuda.synchronize()
    plain = fa.flash_attention_forward_plain(*args, **call)
    _check(out, plain, dtype)
    base = fa.flash_attention_forward(*args, **dict(call,
                                                    dropout_coords=None))
    assert not torch.equal(out[0], base[0])
    hq = args[0].shape[1]
    same = fa.flash_attention_forward(*args, **dict(call,
                                                    dropout_coords=(0, 0, hq)))
    assert all(torch.equal(a, b) for a, b in zip(same, base))
    do = torch.randn(args[0].shape, generator=gen).to(cuda, dtype)
    got = fa.flash_attention_backward(*args[:3], out[0], do, out[1], out[2],
                                      *args[3:], **call)
    want = fa.flash_attention_backward_plain(*args[:3], plain[0], do,
                                             plain[1], plain[2], *args[3:],
                                             **call)
    _check_grads(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paper_variant_matches_plain(cuda, dtype):
    _, args, call = _contiguous_case(cuda, dtype, 64, "window_kvmask_tail")
    call["variant"] = "paper"
    out = fa.flash_attention_forward(*args, **call)
    _check(out, fa.flash_attention_forward_plain(*args, **call), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["fa2", "paper"])
@pytest.mark.parametrize("dropout_p", [0.0, 0.2])
def test_head_dim_96_forward_variants_and_backward_match_plain(
        cuda, dtype, variant, dropout_p):
    """Every contiguous instantiation at head_dim 96 (phi-3-vision's: 12
    chunks a row, the swizzle that permutes within a row of 12): the
    forward in both accumulator variants with and without dropout, then
    the backward pair fed the kernel's (o, m, l) against the plain backward
    fed the plain ones, at ragged tiles with a row with no key."""
    gen, args, call = _ragged_case(cuda, dtype, 96, 24, 40, seed=5)
    call.update(variant=variant)
    if dropout_p:
        call.update(dropout_p=dropout_p, dropout_seed=31,
                    dropout_dims=(70, 150))
    out = fa.flash_attention_forward(*args, **call)
    torch.cuda.synchronize()
    plain = fa.flash_attention_forward_plain(*args, **call)
    _check(out, plain, dtype)
    _check_empty_row(out, 0, 5)
    do = torch.randn(args[0].shape, generator=gen).to(cuda, dtype)
    bcall = {n: x for n, x in call.items() if n != "variant"}
    got = fa.flash_attention_backward(*args[:3], *out[:1], do, *out[1:],
                                      *args[3:], **bcall)
    want = fa.flash_attention_backward_plain(*args[:3], plain[0], do,
                                             *plain[1:], *args[3:], **bcall)
    _check_grads(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["fa2", "paper"])
@pytest.mark.parametrize("page_size", [16, 64])
def test_head_dim_96_paged_forward_and_backward_match_plain(
        cuda, dtype, variant, page_size):
    """The paged instantiations at head_dim 96: the paged forward in both
    variants (2 warp groups a CTA above d 64) and the paged dq, dkv and
    fold (fp32 scalar body and bf16 tensor-core body) against the plain
    versions over the gathered pages."""
    q, k_pool, v_pool, page_list, ids, do = _paged_grad_case(
        cuda, dtype, page_size, seed=9, d=96)
    bq = 32
    T = page_list.shape[1]
    layout = M.compile_block_layout(M.MaskSpec(causal=True, **ids),
                                    q.shape[2], T * page_size, bq,
                                    page_size).as_array(cuda)
    layout = M.paged_prefill_block_layout(layout, page_list)
    call = dict(scale=96 ** -0.5, causal=True, window=None, block_q=bq,
                **ids)
    out = fa.flash_prefill_paged_forward(q, k_pool, v_pool, page_list,
                                         layout, variant=variant, **call)
    torch.cuda.synchronize()
    plain = fa.flash_prefill_paged_forward_plain(
        q, k_pool, v_pool, page_list, layout, variant=variant, **call)
    _check(out, plain, dtype)
    res = (q, k_pool, v_pool, page_list, plain[0], do, plain[1], plain[2],
           layout)
    got = fa.flash_prefill_paged_backward(*res, **call)
    want = fa.flash_prefill_paged_backward_plain(*res, **call)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs().max() / w.float().abs().max()
        assert err <= tol, float(err)


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
    n0 = dict(fa.LAUNCHES)
    out = fa.flash_prefill_paged_forward(q, k_pool, v_pool, page_list.to(cuda),
                                         layout, **call)
    torch.cuda.synchronize()
    _check_one_fwd(n0, _fwd_kernel(dtype, d, call["block_q"], page_size,
                                   layout, paged=True))
    plain = fa.flash_prefill_paged_forward_plain(q, k_pool, v_pool,
                                                 page_list.to(cuda), layout, **call)
    _check(out, plain, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128])
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
    n0 = dict(fa.LAUNCHES)
    out = fa.flash_prefill_paged_forward(q, k_pool, v_pool, page_list.to(cuda),
                                         layout, **call)
    torch.cuda.synchronize()
    _check_one_fwd(n0, _fwd_kernel(dtype, d, call["block_q"], page_size,
                                   layout, paged=True))
    plain = fa.flash_prefill_paged_forward_plain(q, k_pool, v_pool,
                                                 page_list.to(cuda), layout, **call)
    _check(out, plain, dtype)
    _check_empty_row(out, 0, sq - 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_paged_slab_of_padding_rows_is_zero(cuda, dtype):
    """A sequence-parallel rank whose slab of a chunk holds only padding
    rows (a suffix shorter than one slab after a prefix hit): every q row
    is SEG_PAD_Q at POS_PAD against a live prefix (no row has a key), and
    #4 must give finite zeros, as its plain version does."""
    gen = torch.Generator().manual_seed(7)
    hq, hkv, d, page_size, num_pages, sq, span = 8, 2, 64, 16, 12, 32, 70
    k_pool = torch.randn(hkv, num_pages, page_size, d, generator=gen).to(cuda, dtype)
    v_pool = torch.randn(hkv, num_pages, page_size, d, generator=gen).to(cuda, dtype)
    T = -(-span // page_size)
    page_list = torch.randperm(num_pages, generator=gen)[:T].int()[None]
    kv_seg = torch.full((1, T * page_size), M.SEG_PAD_KV, dtype=torch.int32)
    kv_pos = torch.full((1, T * page_size), M.POS_PAD, dtype=torch.int32)
    kv_seg[0, :span], kv_pos[0, :span] = 0, torch.arange(span)
    q_seg = torch.full((1, sq), M.SEG_PAD_Q, dtype=torch.int32)
    q_pos = torch.full((1, sq), M.POS_PAD, dtype=torch.int32)
    q = torch.randn(1, hq, sq, d, generator=gen).to(cuda, dtype)
    a = {n: t.to(cuda) for n, t in dict(q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                                       q_positions=q_pos, kv_positions=kv_pos).items()}
    layout = M.compile_block_layout(M.MaskSpec(causal=True, **a), sq,
                                    T * page_size, sq, page_size).as_array(cuda)
    layout = M.paged_prefill_block_layout(layout, page_list.to(cuda))
    call = dict(scale=d ** -0.5, causal=True, window=None, block_q=sq, **a)
    n0 = dict(fa.LAUNCHES)
    out = fa.flash_prefill_paged_forward(q, k_pool, v_pool, page_list.to(cuda),
                                         layout, **call)
    torch.cuda.synchronize()
    _check_one_fwd(n0, _fwd_kernel(dtype, d, call["block_q"], page_size,
                                   layout, paged=True))
    plain = fa.flash_prefill_paged_forward_plain(q, k_pool, v_pool,
                                                 page_list.to(cuda), layout, **call)
    _check(out, plain, dtype)
    for r in range(sq):
        _check_empty_row(out, 0, r)


def test_paged_forward_refuses_other_page_sizes(cuda):
    """A page the kv tile cannot gather whole raises before launch."""
    q = torch.randn(1, 2, 24, 64, device=cuda, dtype=torch.bfloat16)
    pool = torch.randn(1, 4, 24, 64, device=cuda, dtype=torch.bfloat16)
    page_list = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    layout = torch.ones((1, 1, 2), dtype=torch.int32, device=cuda)
    n0 = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="page sizes"):
        fa.flash_prefill_paged_forward(q, pool, pool, page_list, layout,
                                       scale=0.125, causal=False, window=None,
                                       block_q=24)
    assert all(fa.LAUNCHES[c] == n0[c] for c in _FWD_COUNTERS)


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
    assert fa.LAUNCHES["flash_fwd"] + fa.LAUNCHES["flash_fwd_sm90"] > 0
    assert (fa.LAUNCHES["flash_fwd_paged"]
            + fa.LAUNCHES["flash_fwd_paged_sm90"]) > 0
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
        assert _launched(n0, name), name
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
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128])
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
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128])
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


def _paged_grad_case(cuda, dtype, page_size, seed=0, d=64):
    """Two rows, one segment each, whose prefixes share their first pool
    page; scrambled pages, dead slots, a padded q tail in row 1."""
    gen = torch.Generator().manual_seed(seed + page_size)
    hq, hkv, num_pages, sq = 8, 2, 60, 64
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
    names = _paged_bwd_kernels(dtype, q.shape[-1], bq, page_size, layout)
    for name in (*names, "flash_bwd_fold_paged"):
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


@pytest.mark.parametrize("d", [64, 96, 128])
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
    names = _paged_bwd_kernels(torch.bfloat16, d, block_q, page_size, res[-1])
    for name in (*names, "flash_bwd_fold_paged"):
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


# the sm90 paged pair (csrc/flash_bwd_sm90.cu, Paged = true)
def _sm90_paged_grad_case(cuda, d, page_size, n_rep, window=None, seed=0):
    """bf16, two rows of 128 q rows (two 64-row q blocks). Row 0 packs
    document A (span 260, 70 chunk rows) and document B (span 90, 40 rows)
    with a dead slot between their pages; row 1 holds document C (span 200,
    100 rows). A's, B's and C's first pages are one pool page (shared
    within and across rows); every row ends in dead slots, as many as make
    T no multiple of the pages of a 64-key tile; padded q rows have no key.
    GQA n_rep over 2 kv heads (1 at n_rep 8). A ``window`` makes the pages
    behind it SKIP inside page groups whose other pages run."""
    gen = torch.Generator().manual_seed(seed + 10 * page_size + d + n_rep
                                        + (window or 0))
    hkv = 1 if n_rep == 8 else 2
    hq, sq = hkv * n_rep, 128
    g = tuning.fwd_pages_per_tile(page_size)
    rows = [[(260, 70), (90, 40)], [(200, 100)]]
    npg = lambda span: -(-span // page_size)  # noqa: E731
    used = [sum(npg(s) for s, _ in docs) + len(docs) - 1 for docs in rows]
    T = max(used) + 2
    while g > 1 and T % g == 0:
        T += 1
    num_pages = sum(npg(s) for docs in rows for s, _ in docs) + 6
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
    spec = M.MaskSpec(causal=True, window=window, **ids)
    layout = M.compile_block_layout(spec, sq, T * page_size, 64,
                                    page_size).as_array(cuda)
    layout = M.paged_prefill_block_layout(layout, page_list)
    call = dict(scale=d ** -0.5, causal=True, window=window, block_q=64,
                **ids)
    o, m, l = fa.flash_prefill_paged_forward_plain(q, k_pool, v_pool,
                                                   page_list, layout, **call)
    return (q, k_pool, v_pool, page_list, o, f(2, hq, sq, d), m, l,
            layout), call


def _check_sm90_paged_pair(res, call):
    """The sm90 paged pair through ``flash_prefill_paged_backward`` against
    the plain paged backward and against the mma.sync body on the same
    residuals (2e-2 of each gradient's max); only the sm90 counters move;
    untouched pages and padded q rows exactly zero; two calls
    bit-identical."""
    q, k_pool, page_list, layout = res[0], res[1], res[3], res[-1]
    assert fa.backward_body(on_card=True, dtype=q.dtype, head_dim=q.shape[-1],
                            block_q=64, block_k=k_pool.shape[2], paged=True,
                            nq=layout.shape[-2],
                            nk=layout.shape[-1]) == "sm90"
    n0 = dict(fa.LAUNCHES)
    got = fa.flash_prefill_paged_backward(*res, **call)
    torch.cuda.synchronize()
    for name in ("flash_bwd_dq_paged", "flash_bwd_dkv_paged"):
        assert fa.LAUNCHES[name + "_sm90"] == n0[name + "_sm90"] + 1, name
        assert fa.LAUNCHES[name] == n0[name], name
    assert fa.LAUNCHES["flash_bwd_fold_paged"] == n0["flash_bwd_fold_paged"] + 1
    want = fa.flash_prefill_paged_backward_plain(*res, **call)
    for w in want:
        assert float(w.float().abs().max()) > 0
    _check_grads(got, want, torch.bfloat16)
    mma = fa.flash_prefill_paged_backward(*res, **call, _mma_body=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_bwd_dq_paged"] == n0["flash_bwd_dq_paged"] + 1
    _check_grads(got, mma, torch.bfloat16)
    named = set(page_list[page_list >= 0].tolist())
    unnamed = [p for p in range(k_pool.shape[1]) if p not in named]
    assert unnamed
    assert torch.all(got[1][:, unnamed] == 0) and torch.all(got[2][:, unnamed] == 0)
    no_key = call["q_segment_ids"] == M.SEG_PAD_Q           # (b, sq)
    assert torch.all(got[0].transpose(1, 2)[no_key] == 0)
    again = fa.flash_prefill_paged_backward(*res, **call)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    return got


@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("page_size", [8, 16, 32, 64])
@pytest.mark.parametrize("n_rep", [1, 4, 5, 8])
@pytest.mark.parametrize("window", [None, 48])
def test_sm90_paged_pair_matches_plain_and_mma_body(cuda, d, page_size,
                                                     n_rep, window):
    """The wgmma/TMA paged pair at every page size and head dim, GQA n_rep
    1, 4, 5 and 8: dead slots inside and after the live pages, pages shared
    within and across rows, padded q rows, and (window 48) SKIP pages
    inside page groups whose other pages run."""
    _check_sm90_paged_pair(*_sm90_paged_grad_case(cuda, d, page_size, n_rep,
                                                  window))


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("page_size", [8, 64])
def test_sm90_paged_pair_both_cta_tiles(cuda, monkeypatch, rows, d,
                                        page_size):
    """Each CTA tile of the sm90 paged pair (forced; dkv at d 128 takes 128
    only): 128 rows, one q block / page group per consumer warpgroup (the
    last group half past the key axis), and 64, the warpgroups splitting
    the walk and adding their sums; GQA 4 with a window."""
    monkeypatch.setattr(fa, "sm90_bwd_rows",
                        lambda *a, kernel="dq", head_dim=64: (
                            128 if kernel == "dkv" and head_dim == 128
                            else rows))
    _check_sm90_paged_pair(*_sm90_paged_grad_case(cuda, d, page_size, 4,
                                                  window=48, seed=3))


def test_sm90_paged_pair_never_waits_on_the_card(cuda):
    """The whole paged backward on the sm90 pair (D, dq, dkv, the fold
    order and the fold) runs under set_sync_debug_mode("error")."""
    res, call = _sm90_paged_grad_case(cuda, 128, 16, 8, seed=1)
    fa.flash_prefill_paged_backward(*res, **call)       # build and load first
    torch.cuda.synchronize()
    n0 = dict(fa.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fa.flash_prefill_paged_backward(*res, **call)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_bwd_dkv_paged_sm90"] == n0["flash_bwd_dkv_paged_sm90"] + 1
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


# (name, causal, d, n_rep) of the attention layers the later paths run:
# bert-large's (non-causal, packed documents, d 64, MHA), olmo-1b's and
# olmoe-1b-7b's (causal, packed documents, d 128, MHA) and
# phi3.5-moe's prefill (causal, d 128, GQA 4)
_NEW_TRAIN_SHAPES = (("bert", False, 64, 1), ("olmo", True, 128, 1),
                     ("phi35moe", True, 128, 4))


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
    for kern in (_fwd_kernel(dtype, d, bq, bk, layout),
                 *_bwd_kernels(dtype, d, bq, bk)):
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
        assert _launched(n0, name), name
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) <= 1e-4 * abs(b), (losses["cuda"], losses["cpu"])


# ---------------------------------------------------------------------------
# the mixture-of-experts family
# ---------------------------------------------------------------------------

def _moe_near_tie_rows(got, want, probs) -> set:
    """Rows whose top-k routes differ between the card (``got``) and the
    CPU (``want``); each difference must be a near-tie of the CPU's
    router probabilities (gap <= 1e-5 at the first differing rank)."""
    rows = set()
    for b, t in (got != want).any(-1).nonzero().tolist():
        j = int((got[b, t] != want[b, t]).nonzero()[0])
        top = probs[b, t].sort(descending=True).values
        assert float(top[j] - top[j + 1]) <= 1e-5, (b, t)
        rows.add(b)
    return rows


@pytest.mark.parametrize("experts,top_k,cf", [(8, 2, 1.25), (64, 8, 1.25),
                                              (16, 2, 0.5)])
def test_moe_layer_on_card_matches_cpu(cuda, experts, top_k, cf):
    """One MoE layer (capacity path, d 256, d_ff 128) in fp32 on the card
    and on the CPU: the same routes (a flip only at a near-tie, its row
    then left out), outputs within 1e-4, the aux loss within 1e-5
    relative, every gradient (router, experts, x) within 1e-4 scaled by
    its max."""
    import dataclasses

    from repro_torch.models import moe

    cfg = dataclasses.replace(
        reduced_config("olmoe-1b-7b"), d_model=256, d_ff=128,
        num_experts=experts, num_experts_per_token=top_k,
        moe_capacity_factor=cf)
    gen = torch.Generator().manual_seed(experts + top_k)
    params = moe.init_moe(cfg, torch.float32, generator=gen, device="cpu")
    x = torch.randn(4, 96, cfg.d_model, generator=gen)
    cot = torch.randn(4, 96, cfg.d_model, generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        leaves = {n: t.to(dev, copy=True).requires_grad_()
                  for n, t in params.items()}
        xx = x.to(dev, copy=True).requires_grad_()
        logits = xx.detach() @ leaves["router"].detach()
        idx, _, probs = moe._route(logits, top_k)
        y, aux = moe.apply_moe(leaves, cfg, xx)
        grads = torch.autograd.grad((y * cot.to(dev)).sum() + aux,
                                    [xx, *leaves.values()])
        out[dev] = [t.detach().cpu() for t in (idx, probs, y, aux, *grads)]
    rows = _moe_near_tie_rows(out["cuda"][0], out["cpu"][0], out["cpu"][1])
    keep = [r for r in range(4) if r not in rows]
    torch.testing.assert_close(out["cuda"][2][keep], out["cpu"][2][keep],
                               atol=1e-4, rtol=0)
    if not rows:
        torch.testing.assert_close(out["cuda"][3], out["cpu"][3], atol=0,
                                   rtol=1e-5)
        for g, w in zip(out["cuda"][4:], out["cpu"][4:]):
            err = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
            assert err <= 1e-4, err


def test_moe_layer_bf16_is_bit_identical_and_never_waits(cuda):
    """Forward + backward of one MoE layer at olmoe-1b-7b's expert shapes
    (64 experts of d_ff 1024, top-8, d 2048; 2 x 512 tokens) in bf16:
    two calls bit-identical (the dispatch and combine gathers sum a
    token's slots in a fixed order, no atomics), and a third under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), num_layers=1)
    gen = torch.Generator(device=cuda).manual_seed(3)
    params = moe.init_moe(cfg, torch.bfloat16, generator=gen, device=cuda)
    x = torch.randn(2, 512, cfg.d_model, generator=gen, device=cuda,
                    dtype=torch.bfloat16)
    cot = torch.randn(x.shape, generator=gen, device=cuda,
                      dtype=torch.bfloat16)

    def run():
        leaves = {n: t.detach().requires_grad_() for n, t in params.items()}
        xx = x.detach().requires_grad_()
        y, aux = moe.apply_moe(leaves, cfg, xx)
        grads = torch.autograd.grad((y * cot).float().sum() + aux,
                                    [xx, *leaves.values()])
        return (y, aux, *grads)

    first, second = run(), run()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert first[-4].dtype == torch.float32              # the router's grad
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        third = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(torch.equal(a, b) for a, b in zip(first, third))


def test_moe_engine_on_card_matches_cpu(cuda):
    """Reduced olmoe-1b-7b (8 experts, top-2, capacity factor 1.25: the
    packed prefill rows drop) served on the card gives the CPU engine's
    greedy tokens, paged (chunked prefill, a prefix hit) and dense."""
    cfg = reduced_config("olmoe-1b-7b", head_dim=64, attn_impl="pallas",
                         use_decode_kernel=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    shared = list(range(1, 25))
    prompts = [shared + [40, 41, 42], list(range(60, 79)), shared + [50],
               [5, 9, 2]]
    for paged in (True, False):
        outs = []
        for device in ("cpu", "cuda"):
            eng = ServingEngine(model, params_to(params, device), num_slots=2,
                                capacity=64, page_size=16, paged=paged,
                                chunk_size=16 if paged else None,
                                device=device)
            for pr in prompts:
                eng.submit(pr, max_new_tokens=6)
            eng.run()
            outs.append({r.rid: r.output for r in eng.finished})
        assert outs[0] == outs[1], paged


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_rep", [1, 4])
def test_serving_kernels_at_moe_head_groups_match_plain(cuda, dtype, n_rep):
    """#4 (a 48-row chunk against a 150-token paged prefix, page 16) and
    #8 (the whole decode over lanes of 0, 21, 700 and 1024 keys) at d 128
    with 2 kv heads of ``n_rep`` q heads each: olmoe-1b-7b's MHA and
    phi3.5-moe's GQA 4 head groups, against their plain versions (#1 at
    these groups: ``test_new_train_shapes_match_plain``)."""
    gen = torch.Generator(device=cuda).manual_seed(n_rep)
    hkv, d, ps = 2, 128, 16
    hq = hkv * n_rep
    # -- #4: one chunk of rows [150 - 48, 150) against its paged prefix
    span, n, bq = 150, 48, 64
    T = -(-span // ps)
    num_pages = 3 * T
    pools = [torch.randn(hkv, num_pages, ps, d, generator=gen,
                         device=cuda).to(dtype) for _ in range(2)]
    page_list = torch.randperm(num_pages, generator=gen,
                               device=cuda)[:T][None].int()
    kv_seg = torch.full((1, T * ps), M.SEG_PAD_KV, dtype=torch.int32,
                        device=cuda)
    kv_pos = torch.full((1, T * ps), M.POS_PAD, dtype=torch.int32,
                        device=cuda)
    kv_seg[0, :span], kv_pos[0, :span] = 0, torch.arange(span, device=cuda)
    q_seg = torch.full((1, bq), M.SEG_PAD_Q, dtype=torch.int32, device=cuda)
    q_pos = torch.full((1, bq), M.POS_PAD, dtype=torch.int32, device=cuda)
    q_seg[0, :n] = 0
    q_pos[0, :n] = torch.arange(span - n, span, device=cuda)
    a = dict(q_segment_ids=q_seg, kv_segment_ids=kv_seg, q_positions=q_pos,
             kv_positions=kv_pos)
    layout = M.compile_block_layout(M.MaskSpec(causal=True, **a), bq, T * ps,
                                    bq, ps).as_array(cuda)
    layout = M.paged_prefill_block_layout(layout, page_list)
    q = torch.randn(1, hq, bq, d, generator=gen, device=cuda).to(dtype)
    call = dict(scale=d ** -0.5, causal=True, window=None, block_q=bq, **a)
    n0 = dict(fa.LAUNCHES)
    out = fa.flash_prefill_paged_forward(q, *pools, page_list, layout, **call)
    torch.cuda.synchronize()
    _check_one_fwd(n0, _fwd_kernel(dtype, d, bq, ps, layout, paged=True))
    _check(out, fa.flash_prefill_paged_forward_plain(q, *pools, page_list,
                                                     layout, **call), dtype)
    # -- #8: the whole decode
    b, T = 4, 64
    kv_len = torch.tensor([0, 21, 700, T * ps], dtype=torch.int32,
                          device=cuda)
    q = torch.randn(b, hq, 1, d, generator=gen, device=cuda).to(dtype)
    num_pages = b * T
    table = torch.randperm(num_pages, generator=gen, device=cuda)
    table = table.reshape(b, T).int()
    for i, n in enumerate(kv_len.tolist()):
        table[i, -(-n // ps):] = -1
    pools = [torch.randn(hkv, num_pages, ps, d, generator=gen,
                         device=cuda).to(dtype) for _ in range(2)]
    args = (q, *pools, table, kv_len, M.paged_block_layout(kv_len, table, ps))
    kw = dict(scale=d ** -0.5, num_splits=8, window=None)
    _check_decode(dtype, "flash_decode_paged",
                  lambda: fd.flash_decode_paged_from_layout(*args, **kw),
                  fd.flash_decode_paged_partials_plain(*args, **kw), idle=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hymba_attention_group_with_window_matches_plain(cuda, dtype):
    """The forward and the dq / dkv pair at hymba-1.5b's head group (5 q
    heads a kv head, d 64) with a causal window of 200 over 512 keys, so
    that whole 64 x 64 tiles fall out of it and are skipped, over packed
    documents: against their plain versions, two backward calls
    bit-identical (the dkv GQA sum over 5 heads in a fixed order)."""
    gen = torch.Generator().manual_seed(5)
    b, hkv, n_rep, S, d, bq, bk, window = 2, 2, 5, 512, 64, 64, 64, 200
    hq = hkv * n_rep
    q = torch.randn(b, hq, S, d, generator=gen).to(cuda, dtype)
    k, v = (torch.randn(b, hkv, S, d, generator=gen).to(cuda, dtype)
            for _ in range(2))
    seg = _segments(gen, b, S, cuda)
    spec = M.MaskSpec(causal=True, window=window, q_segment_ids=seg,
                      kv_segment_ids=seg)
    layout = M.compile_block_layout(spec, S, S, bq, bk).as_array(cuda)
    # some tiles below the diagonal are out of the window
    nq = S // bq
    below = torch.ones(nq, nq, dtype=torch.bool, device=cuda).tril(-1)
    assert bool(((layout == M.BLOCK_SKIP) & below).any())
    call = dict(scale=d ** -0.5, causal=True, window=window, q_offset=0,
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
    for kern in (_fwd_kernel(dtype, d, bq, bk, layout),
                 *_bwd_kernels(dtype, d, bq, bk)):
        assert fa.LAUNCHES[kern] == n0[kern] + 1, kern
    _check_grads(got, fa.flash_attention_backward_plain(*res, **call), dtype)
    again = fa.flash_attention_backward(*res, **call)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 8])
def test_decode_at_hymba_group_with_window_matches_plain(cuda, dtype, splits):
    """The contiguous decode at hymba-1.5b's GQA 5 (one CTA's 4 heads and
    one more), d 64, window 1024 over a 2048-slot cache: an idle lane, a
    lane inside the window, and two past it whose first blocks are
    skipped, against the plain partials and their merge."""
    gen = torch.Generator(device=cuda).manual_seed(splits)
    b, hkv, n_rep, d, cap, bk, window = 4, 2, 5, 64, 2048, 64, 1024
    hq = hkv * n_rep
    kv_len = torch.tensor([0, 700, 1536, cap], dtype=torch.int32,
                          device=cuda)
    q = torch.randn(b, hq, 1, d, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(b, hkv, cap, d, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    valid = M.decode_kv_valid(kv_len, cap, window=window)
    layout = M.kv_block_layout(valid, bk)
    assert int((layout[3] == M.BLOCK_SKIP).sum()) >= cap // 2 // bk
    kw = dict(scale=d ** -0.5, block_k=bk, num_splits=splits, window=window)
    args = (q, k, v, kv_len, layout)
    _check_decode(dtype, "flash_decode",
                  lambda: fd.flash_decode_from_layout(*args, **kw),
                  fd.flash_decode_partials_plain(*args, **kw), idle=0)


def test_hymba_engine_and_train_step_on_card_match_cpu(cuda):
    """Reduced hymba-1.5b (float32, window 64, GQA 4, head_dim 64) served
    in dense slots on the card gives the CPU engine's greedy tokens, with
    prompts past the window and one that is not a chunk multiple, through
    #1 and #7; two AdamW steps on the card give the CPU's losses within
    1e-4 relative through #1, #2 and #3."""
    import dataclasses

    from repro_torch.data import SyntheticLM
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import make_train_step

    cfg = reduced_config("hymba-1.5b", head_dim=64, attn_impl="pallas",
                         use_decode_kernel=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    prompts = [list(range(1, 100)), [5, 9, 2, 7], list(range(30, 67)),
               list(range(3, 83))]
    outs = []
    for device in ("cpu", "cuda"):
        n0 = {**fa.LAUNCHES, **fd.LAUNCHES}
        eng = ServingEngine(model, params_to(params, device), num_slots=2,
                            capacity=128, device=device)
        assert not eng.paged
        for pr in prompts:
            eng.submit(pr, max_new_tokens=6)
        eng.run()
        outs.append({r.rid: r.output for r in eng.finished})
    assert outs[0] == outs[1]
    assert _launched(n0, "flash_fwd")
    assert fd.LAUNCHES["flash_decode"] > n0["flash_decode"]
    assert fd.LAUNCHES["flash_decode_paged"] == n0["flash_decode_paged"]

    cfg = dataclasses.replace(cfg, remat=True)
    model = build_model(cfg)
    data = SyntheticLM(cfg.vocab_size, 160, 2, seed=1, mean_doc_len=48)
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
        assert _launched(n0, name), name
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) <= 1e-4 * abs(b), (losses["cuda"], losses["cpu"])


def test_ssm_layer_bf16_is_bit_identical_and_never_waits(cuda):
    """Forward + backward of one SSM layer at mamba2-2.7b's head shapes
    (80 heads of 64, state 128, chunks of 256, d 2560; 2 x 600 tokens, a
    padded last chunk) in bf16: finite, two calls bit-identical, and a
    third under ``torch.cuda.set_sync_debug_mode("error")`` (the chunk loop
    reads nothing back to the host)."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    cfg = get_config("mamba2-2.7b")
    gen = torch.Generator(device=cuda).manual_seed(4)
    params = ssm.init_ssm(cfg, torch.bfloat16, generator=gen, device=cuda)
    x = torch.randn(2, 600, cfg.d_model, generator=gen, device=cuda,
                    dtype=torch.bfloat16)
    cot = torch.randn(x.shape, generator=gen, device=cuda,
                      dtype=torch.bfloat16)

    def run():
        leaves = {n: t.detach().requires_grad_() for n, t in params.items()}
        xx = x.detach().requires_grad_()
        y = ssm.apply_ssm(leaves, cfg, xx)
        return (y, *torch.autograd.grad((y * cot).float().sum(),
                                        [xx, *leaves.values()]))

    first, second = run(), run()
    assert all(bool(torch.isfinite(t).all()) for t in first)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert params["A_log"].dtype == first[5].dtype == torch.float32
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        third = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(torch.equal(a, b) for a, b in zip(first, third))


# ---------------------------------------------------------------------------
# block-sparse FlashAttention (paper Alg. 5) and the encoder-decoder
# ---------------------------------------------------------------------------

def _sparse_case(cuda, dtype, blk, causal, masked, s=512, d=64):
    """A butterfly pattern at ``blk``-row blocks, refined to the kernels'
    tiles as ``ops.flash_attention`` refines it, compiled with an optional
    kv_mask (FULL blocks it cuts become PARTIAL_DATA); GQA 4/2."""
    gen = torch.Generator().manual_seed(blk + 2 * causal + masked)
    b, hq, hkv = 2, 4, 2
    q = torch.randn(b, hq, s, d, generator=gen).to(cuda, dtype)
    k = torch.randn(b, hkv, s, d, generator=gen).to(cuda, dtype)
    v = torch.randn(b, hkv, s, d, generator=gen).to(cuda, dtype)
    kvm = None
    if masked:
        kvm = (torch.rand(b, s, generator=gen) > 0.2)
        kvm[:, s - 40:] = False
        kvm = kvm.to(cuda)
    pattern = M.butterfly_block_layout(s, s, blk, blk, causal=causal)
    tile, r = tuning.sparse_tile(blk, on_card=True)
    spec = M.MaskSpec(causal=causal, kv_mask=kvm,
                      sparse_layout=M.refine_block_layout(pattern, r, r))
    layout = M.compile_block_layout(spec, s, s, tile, tile).as_array(cuda)
    call = dict(scale=d ** -0.5, causal=causal, window=None, q_offset=0,
                block_q=tile, block_k=tile)
    return gen, (q, k, v, kvm, layout), call


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blk", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_blocksparse_kernels_match_plain(cuda, dtype, blk, causal, masked):
    """#1, #2 and #3 at a butterfly layout of 64-row blocks and of 128-row
    blocks refined into 64-row tiles, causal (a FULL block above the
    diagonal runs unmasked) and not, with a kv_mask (PARTIAL_DATA tiles)
    and without; two backward calls bit-identical."""
    gen, args, call = _sparse_case(cuda, dtype, blk, causal, masked)
    layout = args[4]
    assert bool((layout == M.BLOCK_SKIP).any())
    if masked:
        assert bool((layout == M.BLOCK_PARTIAL_DATA).any())
    n0 = dict(fa.LAUNCHES)
    out = fa.flash_attention_forward(*args, **call)
    torch.cuda.synchronize()
    _check(out, fa.flash_attention_forward_plain(*args, **call), dtype)
    do = torch.randn(args[0].shape, generator=gen).to(cuda, dtype)
    res = (*args[:3], out[0], do, out[1], out[2], *args[3:])
    got = fa.flash_attention_backward(*res, **call)
    torch.cuda.synchronize()
    _check_grads(got, fa.flash_attention_backward_plain(*res, **call), dtype)
    for name in (_fwd_kernel(dtype, args[0].shape[-1], call["block_q"],
                             call["block_k"], layout),
                 *_bwd_kernels(dtype, args[0].shape[-1], call["block_q"],
                               call["block_k"])):
        assert fa.LAUNCHES[name] == n0[name] + 1, name
    again = fa.flash_attention_backward(*res, **call)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_blocksparse_op_on_card_matches_cpu(cuda):
    """``ops.flash_attention(block_layout=...)`` with autograd at a causal
    butterfly pattern of 128-row blocks with a kv_mask, sq 510 (4 blocks
    of ceil(510 / 4) = 128 rows, padded to 512), on the card against the
    CPU (fp32)."""
    gen = torch.Generator().manual_seed(11)
    s = 510
    q = torch.randn(1, 4, s, 64, generator=gen)
    k = torch.randn(1, 2, s, 64, generator=gen)
    v = torch.randn(1, 2, s, 64, generator=gen)
    do = torch.randn(1, 4, s, 64, generator=gen)
    kvm = torch.rand(1, s, generator=gen) > 0.25
    layout = M.butterfly_block_layout(s, s, 128, 128, causal=True)
    outs = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_() for t in (q, k, v)]
        o = ops.flash_attention(*leaves, causal=True, block_layout=layout,
                                kv_mask=kvm.to(dev))
        outs[str(dev)] = [o] + list(torch.autograd.grad(o, leaves, do.to(dev)))
    for got, want in zip(outs["cuda"], outs["cpu"]):
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        assert err <= 1e-4, err


def test_blocksparse_refuses_other_blocks_on_card(cuda):
    """A pattern whose block (96 rows) is neither at most the kernels' 64-row
    tile nor a multiple of it raises before any launch on the card."""
    x = torch.randn(1, 2, 192, 64, device=cuda)
    n0 = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="neither at most 64 nor a multiple"):
        ops.flash_attention(x, x, x, causal=True,
                            block_layout=torch.ones((2, 2), dtype=torch.uint8))
    assert dict(fa.LAUNCHES) == n0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_kernels_match_plain(cuda, dtype):
    """#1 + backward at cross-attention's shapes: decoder queries (sq 96)
    against encoder keys (sk 200, a padding tail), non-causal, no RoPE,
    MHA, through ``ops.flash_attention`` on the card against the CPU in
    fp32, and the kernels against their plain versions in bf16."""
    gen = torch.Generator().manual_seed(12)
    q = torch.randn(2, 4, 96, 64, generator=gen)
    k = torch.randn(2, 4, 200, 64, generator=gen)
    v = torch.randn(2, 4, 200, 64, generator=gen)
    do = torch.randn(2, 4, 96, 64, generator=gen)
    if dtype == torch.float32:
        outs = {}
        for dev in ("cpu", cuda):
            leaves = [t.to(dev).requires_grad_() for t in (q, k, v)]
            o = ops.flash_attention(*leaves, causal=False)
            outs[str(dev)] = [o] + list(torch.autograd.grad(o, leaves,
                                                            do.to(dev)))
        for got, want in zip(outs["cuda"], outs["cpu"]):
            err = float((got.cpu() - want).abs().max() / want.abs().max())
            assert err <= 1e-4, err
        return
    q, k, v, do = (t.to(cuda, dtype) for t in (q, k, v, do))
    kp = torch.nn.functional.pad(k, (0, 0, 0, 56))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 56))
    spec = M.MaskSpec(causal=False, kv_valid_len=200)
    layout = M.compile_block_layout(spec, 96, 256, 32, 64).as_array(cuda)
    call = dict(scale=0.125, causal=False, window=None, q_offset=0,
                kv_valid_len=200, block_q=32, block_k=64)
    args = (q, kp, vp, None, layout)
    out = fa.flash_attention_forward(*args, **call)
    _check(out, fa.flash_attention_forward_plain(*args, **call), dtype)
    res = (q, kp, vp, out[0], do, out[1], out[2], None, layout)
    _check_grads(fa.flash_attention_backward(*res, **call),
                 fa.flash_attention_backward_plain(*res, **call), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("enc_len", [100, 128, 1000])
def test_decode_over_padded_cross_cache_matches_plain(cuda, dtype, enc_len):
    """#7 over a cross-attention cache padded to the decode tile
    (``transformer.cross_capacity``) with kv_len = enc_len: the padded
    rows (filled with garbage here) never count, against the plain decode
    over the unpadded rows."""
    from repro_torch.core.attention import AttentionSpec, decode_attention
    from repro_torch.models.transformer import cross_capacity

    gen = torch.Generator().manual_seed(enc_len)
    cap = cross_capacity(enc_len)
    assert cap % tuning.DECODE_TILE == 0 and cap - enc_len < 64
    q = torch.randn(3, 16, 1, 64, generator=gen).to(cuda, dtype)
    k = torch.randn(3, 16, cap, 64, generator=gen).to(cuda, dtype)
    v = torch.randn(3, 16, cap, 64, generator=gen).to(cuda, dtype)
    kv_len = torch.full((3,), enc_len, dtype=torch.int32, device=cuda)
    n0 = fd.LAUNCHES["flash_decode"]
    got = decode_attention(q, k, v, kv_len,
                           AttentionSpec(use_decode_kernel=True))
    torch.cuda.synchronize()
    assert fd.LAUNCHES["flash_decode"] == n0 + 1
    want = decode_attention(q, k[:, :, :enc_len], v[:, :, :enc_len], kv_len,
                            AttentionSpec())
    atol, _ = _tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def test_encdec_on_card_matches_cpu(cuda):
    """Reduced seamless-m4t-medium (float32, head_dim 64): prefill of 40
    audio frames and a 9-token prompt, then 6 greedy decode steps, on the
    card gives the CPU's tokens through #1 (encoder non-causal,
    cross-attention sq != sk) and #7 (self- and cross-attention decode);
    two AdamW steps on the card give the CPU's losses within 1e-4
    relative through #1, #2 and #3."""
    import dataclasses

    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import make_train_step

    cfg = reduced_config("seamless-m4t-medium", head_dim=64,
                         attn_impl="pallas", use_decode_kernel=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    frames = torch.randn(2, 40, cfg.frontend_dim, generator=gen)
    prompt = torch.randint(0, cfg.vocab_size, (2, 9), generator=gen)
    tokens = {}
    for dev in ("cpu", "cuda"):
        n0 = {**fa.LAUNCHES, **fd.LAUNCHES}
        p = params_to(params, dev)
        state, lg = model.prefill(p, {"frames": frames.to(dev),
                                      "tokens": prompt.to(dev)}, 16)
        out = []
        for _ in range(6):
            tok = lg[:, -1].argmax(-1)
            out.append(tok.tolist())
            state, lg = model.decode_step(p, state, tok)
        tokens[dev] = out
    assert tokens["cpu"] == tokens["cuda"]
    assert _launched(n0, "flash_fwd")
    assert fd.LAUNCHES["flash_decode"] >= n0["flash_decode"] + 6 * 2 * 2

    model = build_model(dataclasses.replace(cfg, remat=True))
    losses = {}
    for dev in ("cpu", "cuda"):
        opt = adamw(warmup_cosine(1e-3, 2, 10))
        p = params_to(params, dev)
        state = opt.init(p)
        step = make_train_step(model, opt, deterministic=True)
        n0 = dict(fa.LAUNCHES)
        losses[dev] = []
        for s in range(2):
            g = torch.Generator().manual_seed(20 + s)
            batch = {"frames": torch.randn(2, 80, cfg.frontend_dim,
                                           generator=g),
                     "tokens": torch.randint(0, cfg.vocab_size, (2, 48),
                                             generator=g)}
            p, state, metrics = step(p, state, batch)
            losses[dev].append(float(metrics["loss"]))
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert _launched(n0, name), name
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) <= 1e-4 * abs(b), (losses["cuda"], losses["cpu"])


class _LoneRank:
    """Rank ``index`` of a "model" group of ``size`` ranks in one process:
    the group's collectives pass each rank's part through unsummed
    (``comm.all_reduce_sum`` as the identity), so that the rank's own
    work runs alone, on the card as on the CPU."""

    def __init__(self, index, size):
        from repro_torch.distributed.meshes import Group

        self.group = Group(ranks=tuple(range(size)), index=index, pg=None,
                           backend="gloo")

    def __enter__(self):
        from repro_torch.distributed import comm

        self._sum = comm.all_reduce_sum
        comm.all_reduce_sum = lambda x, group: x
        return self

    def __exit__(self, *exc):
        from repro_torch.distributed import comm

        comm.all_reduce_sum = self._sum

    def shard(self, **cut):
        from repro_torch.distributed.sharding import TrainShard

        g = self.group
        return TrainShard(model=g, data=_LoneRank(0, 1).group, heads=False,
                          ff=False, vocab=False, num_heads=0,
                          num_kv_heads=0, vocab_size=0, batch_sharded=False,
                          **cut)


def _moe_rank(cfg, params, x, cot, rank, size):
    """A rank's expert slice of one MoE layer: y and the gradients of
    (y * cot).sum() with respect to x, the router and its experts."""
    import dataclasses

    from repro_torch.models import moe

    lone = _LoneRank(rank, size)
    shard = lone.shard(experts=True, num_experts=cfg.num_experts)
    lo, hi = shard.expert_range
    mine = {k: (v if k == "router" else v[lo:hi]).detach().requires_grad_()
            for k, v in params.items()}
    xx = x.detach().requires_grad_()
    with lone:
        y, _ = moe.apply_moe(mine, dataclasses.replace(
            cfg, num_experts=hi - lo), xx, shard=shard)
        grads = torch.autograd.grad((y * cot).float().sum(),
                                    [xx, *mine.values()])
    return (y, *grads)


def test_rank_expert_slice_on_card_matches_cpu(cuda):
    """Reduced olmoe-1b-7b's MoE layer (8 experts, top-2, fp32) cut into two
    expert ranks: each rank's partial output and gradients on the card
    against the CPU, and on the card the two ranks' outputs, input and
    router gradients summed, and their experts' gradients side by side,
    equal to the whole layer's."""
    from repro_torch.models import moe

    cfg = reduced_config("olmoe-1b-7b")
    gen = torch.Generator().manual_seed(5)
    params = moe.init_moe(cfg, torch.float32, generator=gen, device="cpu")
    x = torch.randn(2, 32, cfg.d_model, generator=gen)
    cot = torch.randn(x.shape, generator=gen)
    ranks = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev) for k, v in params.items()}
        ranks[dev] = [_moe_rank(cfg, p, x.to(dev), cot.to(dev), r, 2)
                      for r in range(2)]
    for got, want in zip(ranks["cuda"], ranks["cpu"]):
        for g, w in zip(got, want):
            err = float((g.cpu() - w).abs().max()
                        / w.abs().max().clamp_min(1e-30))
            assert err <= 1e-5, err
    p = {k: v.to(cuda).detach().requires_grad_() for k, v in params.items()}
    xx = x.to(cuda).requires_grad_()
    y, _ = moe.apply_moe(p, cfg, xx)
    whole = (y, *torch.autograd.grad((y * cot.to(cuda)).sum(),
                                     [xx, *p.values()]))
    r0, r1 = ranks["cuda"]
    for i in range(3):                      # y, dx, the router's gradient
        torch.testing.assert_close(r0[i] + r1[i], whole[i], atol=1e-5,
                                   rtol=1e-5)
    for i in range(3, 6):                   # the experts' gradients
        torch.testing.assert_close(torch.cat([r0[i], r1[i]]), whole[i],
                                   atol=1e-5, rtol=1e-5)


def test_rank_ssm_head_group_on_card_matches_cpu(cuda):
    """Reduced mamba2-2.7b's SSM layer (8 heads, fp32) cut by head group
    over two ranks (``ssm_specs``' pieces): each rank's partial output and
    the gradients of its pieces on the card against the CPU."""
    import types

    from repro_torch.distributed.sharding import (NamedSharding,
                                                  resolve_spec)
    from repro_torch.models import ssm

    cfg = reduced_config("mamba2-2.7b")
    gen = torch.Generator().manual_seed(6)
    params = ssm.init_ssm(cfg, torch.float32, generator=gen, device="cpu")
    specs = ssm.ssm_specs(cfg)
    x = torch.randn(2, 40, cfg.d_model, generator=gen)
    cot = torch.randn(x.shape, generator=gen)
    for rank in range(2):
        mesh = types.SimpleNamespace(shape={"model": 2},
                                     named_coord={"model": rank})
        pieces = {k: NamedSharding(mesh, resolve_spec(
            specs[k], {"ssm_ff": "model"})).shard(v)
            for k, v in params.items()}
        lone = _LoneRank(rank, 2)
        shard = lone.shard(ssm=True, ssm_num_heads=cfg.ssm_num_heads)
        out = {}
        for dev in ("cpu", "cuda"):
            mine = {k: v.to(dev).requires_grad_() for k, v in pieces.items()}
            xx = x.to(dev).requires_grad_()
            with lone:
                y = ssm.apply_ssm(mine, cfg, xx, shard=shard)
                grads = torch.autograd.grad((y * cot.to(dev)).sum(),
                                            [xx, *mine.values()])
            out[dev] = (y, *grads)
        assert out["cuda"][0].shape == x.shape
        assert out["cuda"][2].shape == (cfg.d_model, 2 * 64 + 2 * 16 + 4)
        for g, w in zip(out["cuda"], out["cpu"]):
            err = float((g.cpu() - w).abs().max()
                        / w.abs().max().clamp_min(1e-30))
            assert err <= 1e-4, err


def test_expert_parallel_moe_layer_bf16_never_waits(cuda):
    """One rank's expert slice (rank 1 of 4: 16 of olmoe-1b-7b's 64
    experts of d_ff 1024, top-8, d 2048; 2 x 512 tokens) in bf16, forward
    and backward: two calls bit-identical, and a third under
    ``torch.cuda.set_sync_debug_mode("error")`` (the routing over all
    experts, the rank's slots and its combine never wait on the host)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), num_layers=1)
    gen = torch.Generator(device=cuda).manual_seed(3)
    params = moe.init_moe(cfg, torch.bfloat16, generator=gen, device=cuda)
    x = torch.randn(2, 512, cfg.d_model, generator=gen, device=cuda,
                    dtype=torch.bfloat16)
    cot = torch.randn(x.shape, generator=gen, device=cuda,
                      dtype=torch.bfloat16)

    def run():
        return _moe_rank(cfg, params, x, cot, 1, 4)

    first, second = run(), run()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert first[2].dtype == torch.float32              # the router's grad
    assert first[3].shape[0] == 16
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        third = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(torch.equal(a, b) for a, b in zip(first, third))


# ---------------------------------------------------------------------------
# the tuner on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def tune_cache(tmp_path):
    """A private autotune cache; every tuner knob restored after the test."""
    saved = dict(tuning._STATE)
    tuning.configure_tuning(cache_path=str(tmp_path / "autotune.json"))
    yield tmp_path / "autotune.json"
    tuning._STATE.update(saved)
    tuning.configure_tuning(cache_path=saved["cache_path"])


def test_autotune_writes_then_hits_on_card(cuda, tune_cache):
    """The first resolution times the candidates with CUDA events and keys
    them under the card's name; the second is served from the cache."""
    import json
    kw = dict(dtype=torch.bfloat16, mask_class="causal", backward=False,
              heads_q=8, heads_kv=2, device=cuda)
    first = tuning.autotune_tiles(256, 256, 64, **kw)
    assert first.source == "autotuned"
    (key, entry), = json.loads(tune_cache.read_text())["entries"].items()
    assert key.startswith(torch.cuda.get_device_name(0).replace("|", "_"))
    assert len(entry["candidates_us"]) == 4
    assert all(t > 0 for t in entry["candidates_us"].values())
    second = tuning.autotune_tiles(256, 256, 64, **kw)
    assert second.source == "cache"
    assert (second.block_q, second.block_k) == (first.block_q, first.block_k)


def test_autotune_clock_reads_device_time_not_host_work(cuda):
    """A call whose host work (1 ms) dwarfs its kernel (a 4 KB add) times
    at the kernel's device time: the timed calls run back to back, queued
    behind a device sleep."""
    import time as _time
    x = torch.zeros(1024, device=cuda)

    def call():
        _time.sleep(1e-3)
        x.add_(1.0)
    least, spread = tuning._clock_us(call, cuda, 3)
    assert 0 < least < 100 and spread >= 0


def test_granite_forward_winner_stable_across_fresh_caches(cuda, tune_cache,
                                                           tmp_path):
    """granite-3-2b's forward layer ((1, 32 / 8 heads, 2048, 64), causal,
    bf16) tuned twice, each time into a fresh cache, persists the same
    winner."""
    winners = []
    for i in range(2):
        tuning.configure_tuning(cache_path=str(tmp_path / f"fresh{i}.json"))
        cfg = tuning.autotune_tiles(2048, 2048, 64, dtype=torch.bfloat16,
                                    mask_class="causal", backward=False,
                                    heads_q=32, heads_kv=8, device=cuda)
        assert cfg.source == "autotuned"
        winners.append((cfg.block_q, cfg.block_k))
    assert winners[0] == winners[1]


@pytest.mark.parametrize("backward", [False, True])
def test_autotuned_winner_matches_plain(cuda, tune_cache, backward):
    """The winning tiles (the |bwd winner for a trainable call, resolved
    through ``ops.flash_attention`` on the card) against the plain version
    at the same tiles: o within 2e-2, dq, dk, dv within 2e-2 of their
    max."""
    import json
    tuning.configure_tuning(autotune=True)
    gen = torch.Generator().manual_seed(11)
    q = torch.randn(1, 8, 200, 64, generator=gen)
    k, v = (torch.randn(1, 2, 200, 64, generator=gen) for _ in range(2))
    do = torch.randn(q.shape, generator=gen)
    outs, tiles = [], {}
    for dev, dt in ((cuda, torch.bfloat16), (torch.device("cpu"),
                                             torch.float32)):
        t = [x.to(dev, dt).requires_grad_(backward) for x in (q, k, v)]
        with torch.set_grad_enabled(backward):
            o = ops.flash_attention(*t, causal=True, **tiles)
        grads = (torch.autograd.grad(o, t, do.to(dev, dt)) if backward
                 else ())
        outs.append([x.detach().float().cpu() for x in (o, *grads)])
        (key, entry), = json.loads(tune_cache.read_text())["entries"].items()
        tiles = dict(block_q=entry["block_q"], block_k=entry["block_k"])
    assert key.endswith("|bwd") == backward
    (o, *g), (po, *pg) = outs
    torch.testing.assert_close(o, po, atol=2e-2, rtol=0)
    for a, b in zip(g, pg):
        assert float((a - b).abs().max() / b.abs().max()) <= 2e-2


@pytest.mark.parametrize("shards", [1, 4])
def test_paged_decode_timed_list_within_a_cluster(cuda, tune_cache, shards):
    """The paged decode's timed candidates keep the page as the block and
    never more than 8 splits, whatever the tensor-parallel target."""
    import json
    cfg = tuning.autotune_decode_geometry(2048, 64, dtype=torch.bfloat16,
                                          page_size=16, shards=shards,
                                          device=cuda)
    (entry,) = json.loads(tune_cache.read_text())["entries"].values()
    splits = [int(c.split("x")[1]) for c in entry["candidates_us"]]
    blocks = {int(c.split("x")[0]) for c in entry["candidates_us"]}
    assert blocks == {16} and max(splits) <= tuning.MAX_DECODE_SPLITS
    assert cfg.decode_block_k == 16
    assert cfg.num_decode_splits <= tuning.MAX_DECODE_SPLITS


def test_resolve_tiles_autotune_off_keeps_64x64_at_granite(cuda, monkeypatch):
    """With autotuning off the forward and backward kernels at granite's
    train layer (q (1, 32, 2048, 64), k/v 8 heads) launch at 64 x 64, as
    before the tuner."""
    assert not tuning.autotune_enabled()
    cfg = tuning.resolve_tiles(
        None, None, sq=2048, sk=2048, head_dim=64, dtype=torch.bfloat16,
        heads_q=32, heads_kv=8, mask_class="causal+seg", device=cuda)
    assert (cfg.block_q, cfg.block_k, cfg.source) == (64, 64, "analytic")
    seen = []
    for name in ("flash_attention_forward", "flash_attention_backward"):
        real = getattr(fa, name)

        def spy(*a, _real=real, _name=name, **kw):
            seen.append((_name, kw["block_q"], kw["block_k"]))
            return _real(*a, **kw)
        monkeypatch.setattr(fa, name, spy)
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(1, 32, 2048, 64, generator=gen, device=cuda,
                    dtype=torch.bfloat16, requires_grad=True)
    k, v = (torch.randn(1, 8, 2048, 64, generator=gen, device=cuda,
                        dtype=torch.bfloat16, requires_grad=True)
            for _ in range(2))
    seg = torch.repeat_interleave(torch.arange(4, device=cuda), 512)[None]
    o = ops.flash_attention(q, k, v, causal=True, segment_ids=seg)
    o.sum().backward()
    assert seen == [("flash_attention_forward", 64, 64),
                    ("flash_attention_backward", 64, 64)]


# ---------------------------------------------------------------------------
# the sequence-sharded decode: a rank's slice through #7 / #8
# ---------------------------------------------------------------------------

def _merged(parts, dtype):
    return fd._merge_split_partials(
        *(torch.cat([p[i] for p in parts], dim=2) for i in range(3)), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("window", [None, 40])
def test_flash_decode_slices_merge_to_the_whole(cuda, dtype, m, window):
    """Each rank's ``flash_decode_slice`` over its C / m slots launches #7
    and matches the CPU's plain partials; the ranks' partials merged equal
    the whole cache's decode. Lane lengths leave later ranks nothing to
    attend (their splits weigh 0)."""
    gen = torch.Generator().manual_seed(m)
    b, hq, hkv, d, cap = 4, 8, 2, 64, 512
    q = torch.randn(b, hq, 1, d, generator=gen).to(dtype)
    k = torch.randn(b, hkv, cap, d, generator=gen).to(dtype)
    v = torch.randn(b, hkv, cap, d, generator=gen).to(dtype)
    kv_len = torch.tensor([1, 100, 300, 512], dtype=torch.int32)
    cs = cap // m
    got, want = [], []
    for r in range(m):
        sl = slice(r * cs, (r + 1) * cs)
        n0 = fd.LAUNCHES["flash_decode"]
        got.append(fd.flash_decode_slice(
            q.to(cuda), k[:, :, sl].to(cuda), v[:, :, sl].to(cuda),
            kv_len.to(cuda), offset=r * cs, window=window))
        assert fd.LAUNCHES["flash_decode"] == n0 + 1
        want.append(fd.flash_decode_slice(q, k[:, :, sl], v[:, :, sl],
                                          kv_len, offset=r * cs,
                                          window=window))
    atol, _ = _tol(dtype)
    out = _merged(got, dtype).float().cpu()
    torch.testing.assert_close(out, _merged(want, dtype).float(), atol=atol,
                               rtol=0)
    whole = fd.flash_decode(q, k, v, kv_len, window=window)
    torch.testing.assert_close(out, whole.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [2, 4])
def test_flash_decode_paged_slices_merge_to_the_whole(cuda, dtype, m):
    """Each rank's ``flash_decode_paged_slice`` over its pages (the others'
    table entries -1, forced SKIP) launches #8 and matches the CPU's plain
    partials; merged they equal the whole pool's decode."""
    from repro_torch.models.transformer import interleaved_page_table
    gen = torch.Generator().manual_seed(10 + m)
    b, hq, hkv, d, ps, T = 4, 8, 2, 64, 16, 16
    n = b * T
    q = torch.randn(b, hq, 1, d, generator=gen).to(dtype)
    kp = torch.randn(hkv, n, ps, d, generator=gen).to(dtype)
    vp = torch.randn(hkv, n, ps, d, generator=gen).to(dtype)
    table = interleaved_page_table(b, T, "cpu")
    kv_len = torch.tensor([1, 70, 200, 256], dtype=torch.int32)
    nl = n // m
    got, want = [], []
    for r in range(m):
        sl = slice(r * nl, (r + 1) * nl)
        n0 = fd.LAUNCHES["flash_decode_paged"]
        got.append(fd.flash_decode_paged_slice(
            q.to(cuda), kp[:, sl].to(cuda), vp[:, sl].to(cuda),
            table.to(cuda), kv_len.to(cuda), first_page=r * nl))
        assert fd.LAUNCHES["flash_decode_paged"] == n0 + 1
        want.append(fd.flash_decode_paged_slice(
            q, kp[:, sl], vp[:, sl], table, kv_len, first_page=r * nl))
    atol, _ = _tol(dtype)
    out = _merged(got, dtype).float().cpu()
    torch.testing.assert_close(out, _merged(want, dtype).float(), atol=atol,
                               rtol=0)
    whole = fd.flash_decode_paged(q, kp, vp, table, kv_len)
    torch.testing.assert_close(out, whole.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("state", ["contiguous", "paged"])
def test_kv_seq_ranks_on_card_match_cpu(cuda, state):
    """Reduced granite's sequence-sharded decode at model 2, two gloo
    ranks sharing the card, against the same ranks on the CPU: tokens
    identical, logits within 1e-4, #7 or #8 launched on both ranks."""
    from repro_torch.configs import reduced_config
    from repro_torch.core.tree import tree_map
    from repro_torch.distributed import launch

    cfg = reduced_config("granite-3-2b", attn_impl="pallas",
                         use_decode_kernel=True)
    tokens = torch.randint(1, cfg.vocab_size, (2, 29),
                           generator=torch.Generator().manual_seed(0))
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    run = {"shape": (1, 2), "state": state, "rules": "auto",
           "batch": {"tokens": tokens.numpy()}, "capacity": 64, "steps": 6,
           "page_size": 16}
    spec = {"cfg": cfg, "params": tree_map(lambda t: t.numpy(), params),
            "backend": "gloo", "runs": [run]}
    card = launch.kv_seq(dict(spec, device="cuda"), 2)
    cpu = launch.kv_seq(dict(spec, device="cpu"), 2)
    kernel = "flash_decode_paged" if state == "paged" else "flash_decode"
    for a, c in zip(card, cpu):
        assert (a[0]["tokens"] == c[0]["tokens"]).all()
        torch.testing.assert_close(torch.from_numpy(a[0]["logits"]),
                                   torch.from_numpy(c[0]["logits"]),
                                   atol=1e-4, rtol=0)
        assert a[0]["launches"][kernel] == 6 * cfg.num_layers
        assert a[0]["census"] == c[0]["census"]
