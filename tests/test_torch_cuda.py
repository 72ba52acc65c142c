"""The port's CUDA kernels against their plain PyTorch versions on the
card, at edge shapes the serving path does not reach (ragged F and D
tiles, odd token counts, other head dims and block sizes, aliased
tables, sentinel rows), for bf16/f32 pools and for int8 pools with f32
scales (rows whose scales differ by 100x, an all-zero scale row), for
both GMMs at x's row counts either side of the tensor-core kernel's
tiles and at the served expert widths, for the slot-contiguous path
(ragged prefill lengths, GQA groups 1 and 8, decode lengths of 1 and
S_max, a dropped cache write), for the split-context decode over both
addressings and over int8 rows with their scales (lengths at and either
side of a split boundary, at and past S_max, groups of 1 to 16 heads,
peaked scores, a repeat launch that must give the same bits), for the
mixed (chunked-prefill) attentions over bf16 and int8 pools (contexts at
and either side of a 64-key tile and a span edge, padding rows, a
prompt's first chunk, a one-row sequence beside a chunk, groups of 4 and
8 heads, head widths 64 and 128, peaked scores, a repeat launch), for
the prefill attention's four head-width instances at and either side of
its 64-row tiles with peaked scores, and for MLA (the latent decode at
lengths 0, 1, S_max and past it, an S_max that is no tile multiple,
sequences split over up to 16 blocks, peaked and flat scores; the bf16
tensor-core kernel at lengths either side of its span and at 4, 16 and
128 heads, one bf16 rounding of the f32 answer and a repeat launch;
prefill attention at q/k width 192 and v width 128), and for the Mamba2
models (the SSD chunk scan at ragged lengths, one token, fewer than 32
columns of P, chunks of 16 to 256 rows, B and C in bf16 and f32; the
bf16 chunk-parallel tensor-core instance at 1, 4 and 16 chunks of
mamba2's widths, zamba2's, a chunk of 100 rows, N and P that are no
multiple of 16, A twenty times steeper, and a repeat launch; zamba2's
attention at head width 80), and for scaling while serving (overlapped
staging on the TransferEngine's side streams while decode steps run
under sync-debug "error", its shards equal to a serial staging's; a KV
block copied between replicas and TP copies, int8 scales included; a
transfer session that counts as finished only once its copies landed),
and for the IMM's CUDA graphs (graphed servers against their eager twins,
``cuda_graphs=False``, over paged bf16 and int8, dense, MLA and Mamba2
stores on one device and DP2 x TP2, and the MLA and zamba2 models on
DP2 x TP2 through a scale up and a drain back, greedy tokens and launch
counts equal; the paged decode and chunk steps' logits replayed bit for bit; a
scale up, down and up that captures each target afresh; a capture on the
serving thread while an overlapped staging's workers copy), and for
scale to zero (a park frees every tensor and graph set of the server;
an unpark's begin and STAGING polls make no host sync beside another
server's decode steps; two servers sharing one ``imm_cache`` keep their
own sets through a scale and a park), and for the last slice's
instances (the flash kernel over another sequence's keys, not causal,
and under a sliding window, rows with no key included; the slot decode
over a windowed ring's ranges, the empty one's uniform mean included).
Needs an NVIDIA GPU: marked ``cuda`` and skipped elsewhere.  On the card,
from the repo root::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerance: f32 atol = rtol = 1e-4 (f32 sums in another order than the
plain version's matmuls); bf16 atol = rtol = 2e-2 on f32-cast outputs
(both round once from f32); the split-context decodes, the mixed
attentions, the prefill attention and the GMMs in bf16 also within 3e-5
past one bf16 rounding of the f32 answer.  The SSD scan's outputs are f32
from f32 sums on both sides whatever the input type: atol = rtol = 1e-3
(sums of up to 256 products, the decays' exps taken in another order).
"""
import contextlib
import dataclasses

import pytest
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import (_build, flash_attention,
                                 flash_attention_bwd, kv_write, mla_decode,
                                 moe_gmm, ops, paged_attention, ref,
                                 ssd_scan)
from repro_torch.kernels.quant import dequantize_rows

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device("cuda")       # also sets the port's matmul precision


def _rand(gen, shape, dtype, dev, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(dtype).to(dev)


def _tables(gen, lengths, NB, MB, bs):
    perm = torch.randperm(NB, generator=gen)
    bt = torch.full((len(lengths), MB), NB, dtype=torch.int32)
    used = 0
    for b, n in enumerate(lengths):
        k = -(-n // bs)
        bt[b, :k] = perm[used:used + k].to(torch.int32)
        used += k
    return bt


ATTN = {  # H, KVH, hd, bs, NB, lengths
    "gqa8-hd128": (32, 4, 128, 16, 64, [1, 16, 17, 300]),
    "mha-hd64-bs8": (4, 4, 64, 8, 40, [5, 64, 9]),
    "gqa2-hd96-bs32": (8, 4, 96, 32, 20, [33, 200]),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", sorted(ATTN))
def test_decode_kernel_matches_plain(dev, case, dtype):
    H, KVH, hd, bs, NB, lengths = ATTN[case]
    gen = torch.Generator().manual_seed(0)
    MB = max(-(-n // bs) for n in lengths) + 2
    q = _rand(gen, (len(lengths), H, hd), dtype, dev)
    k = _rand(gen, (NB, bs, KVH, hd), dtype, dev)
    v = _rand(gen, (NB, bs, KVH, hd), dtype, dev)
    bt = _tables(gen, lengths, NB, MB, bs).to(dev)      # NB sentinel padding
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = paged_attention.block_paged_decode_attention(q, k, v, bt, lens)
    want = ref.block_paged_decode_attention_ref(q, k, v, bt, lens)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    # q_len == 1 through the mixed kernel is the same function (another
    # kernel, whose sums run in another order)
    mixed = paged_attention.mixed_block_paged_attention(
        q[:, None].contiguous(), k, v, bt, lens, torch.ones_like(lens))
    torch.testing.assert_close(mixed[:, 0].float(), got.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("Sq,ctx,q_len", [(16, 37, 16), (24, 40, 7),
                                          (8, 8, 8), (40, 300, 33)])
def test_mixed_kernel_matches_plain(dev, Sq, ctx, q_len, dtype):
    H, KVH, hd, bs, NB = 8, 2, 64, 16, 32
    gen = torch.Generator().manual_seed(1)
    q = _rand(gen, (2, Sq, H, hd), dtype, dev)
    k = _rand(gen, (NB, bs, KVH, hd), dtype, dev)
    v = _rand(gen, (NB, bs, KVH, hd), dtype, dev)
    ctxs = [ctx, max(q_len, ctx // 2)]
    bt = _tables(gen, ctxs, NB, -(-ctx // bs) + 1, bs).to(dev)
    c = torch.tensor(ctxs, dtype=torch.int32, device=dev)
    ql = torch.tensor([q_len, q_len], dtype=torch.int32, device=dev)
    got = paged_attention.mixed_block_paged_attention(q, k, v, bt, c, ql)
    want = ref.mixed_block_paged_attention_ref(q, k, v, bt, c, ql)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("E,C,D,F", [(5, 1, 300, 130), (7, 3, 64, 257),
                                     (3, 9, 512, 96), (2, 13, 260, 40)])
def test_paged_gmm_matches_plain(dev, E, C, D, F, dtype):
    gen = torch.Generator().manual_seed(2)
    P = E + 3
    pool = _rand(gen, (P, D, F), dtype, dev, D ** -0.5)
    x = _rand(gen, (E, C, D), dtype, dev)
    perm = torch.randperm(P, generator=gen)[:E]
    for table in (perm, perm[torch.arange(E) % 2]):    # permuted, aliased
        table = table.to(torch.int32).to(dev)
        got = moe_gmm.paged_gmm(table, pool, x)
        want = ref.paged_gmm_ref(table, pool, x)
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


GMM_WIDTHS = [(2048, 768), (768, 2048), (2048, 1408),      # served (D, F)
              (64, 257), (260, 40)]                        # ragged


@pytest.mark.parametrize("quant", [False, True], ids=["pages", "int8"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("D,F", GMM_WIDTHS)
@pytest.mark.parametrize("C", [1, 7, 8, 9, 10, 16, 120, 129])
def test_gmm_rows_and_widths_match_plain(dev, C, D, F, dtype, quant):
    """Both GMMs at x's row counts either side of the tensor-core kernel's
    8-row n-tiles and its 128-row blocks (C = 10: qwen3's chunk; 120:
    deepseek-v2-lite's prefill), at the served widths (which take the
    tensor cores in bf16) and ragged ones (CUDA cores); permuted, aliased
    and all-one-page tables (int8: page 0, whose scale is 0; every int8
    value in every page).  In bf16 the
    output is the f32 answer rounded once; a second launch gives the same
    bits."""
    gen = torch.Generator().manual_seed(21)
    E, P = 3, 5
    x = _rand(gen, (E, C, D), dtype, dev)
    if quant:
        pool, scales = _int8(gen, (P, D, F), dev, top=3 * D ** -0.5)
        # every int8 value, -128 too, in every page
        pool.view(P, -1)[:, :256] = torch.arange(-128, 128, device=dev,
                                                  dtype=torch.int8)
        kern = lambda t, xx: moe_gmm.quant_paged_gmm(t, pool, scales, xx)
        plain = lambda t, xx: ref.quant_paged_gmm_ref(t, pool, scales, xx)
    else:
        pool = _rand(gen, (P, D, F), dtype, dev, D ** -0.5)
        kern = lambda t, xx: moe_gmm.paged_gmm(t, pool, xx)
        plain = lambda t, xx: ref.paged_gmm_ref(t, pool, xx)
    served = (D, F) in GMM_WIDTHS[:3]
    want_inst = ("mma" if dtype == torch.bfloat16 and served
                 else "fma_char4" if quant and F % 4 == 0 else "fma")
    assert moe_gmm.gmm_instance(dtype, pool.dtype, D, F, x.data_ptr(),
                                pool.data_ptr()) == want_inst
    perm = torch.randperm(P, generator=gen)[:E]
    for table in (perm, perm[torch.tensor([0, 0, 1])],  # permuted, aliased
                  torch.zeros(E, dtype=torch.int64)):   # one page
        table = table.to(torch.int32).to(dev)
        got = kern(table, x)
        assert torch.equal(kern(table, x), got)
        want = plain(table, x)
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
        if dtype == torch.bfloat16:
            _assert_one_bf16_rounding(got, plain(table, x.float()),
                                      "quant_paged_gmm" if quant
                                      else "paged_gmm")
        if quant and not table.any():
            assert not got.any()                        # scale 0


def test_expert_ffn_and_counters(dev):
    gen = torch.Generator().manual_seed(3)
    E, C, D, F, P = 4, 5, 128, 96, 6
    pi = _rand(gen, (P, D, F), torch.float32, dev, D ** -0.5)
    pg = _rand(gen, (P, D, F), torch.float32, dev, D ** -0.5)
    po = _rand(gen, (P, F, D), torch.float32, dev, F ** -0.5)
    x = _rand(gen, (E, C, D), torch.float32, dev)
    t = torch.tensor([5, 0, 0, 2], dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    got = ops.paged_expert_ffn(t, t, t, pi, pg, po, x)
    assert ops.launch_counts()["paged_gmm"] == 3
    with ops.use_reference():
        want = ops.paged_expert_ffn(t, t, t, pi, pg, po, x)
    assert ops.launch_counts()["paged_gmm"] == 3        # plain: no launch
    torch.testing.assert_close(got, want, **TOL[torch.float32])


def test_wrappers_refuse_what_the_kernel_does_not_take(dev):
    x = torch.randn(2, 1, 8, device=dev)
    pool = torch.randn(3, 8, 4, device=dev)
    t = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        moe_gmm.paged_gmm(t.long(), pool, x)
    with pytest.raises(TypeError):
        moe_gmm.paged_gmm(t, pool.double(), x.double())
    strided = torch.randn(3, 4, 8, device=dev).transpose(1, 2)  # [3,8,4]
    with pytest.raises(ValueError, match="contiguous"):
        moe_gmm.paged_gmm(t, strided, x)


# ------------------------------------------------------------------- int8

def _int8(gen, shape, dev, top=3.0, spread=100.0):
    """int8 entries and positive f32 scales per leading row, row maxima
    log-uniform in [top / spread, top]; the first row's scale is 0."""
    q = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
    lo, hi = torch.log(torch.tensor(top / spread)), torch.log(torch.tensor(top))
    s = torch.exp(lo + (hi - lo) * torch.rand(shape[:-2], generator=gen))
    s = s / 127.0
    s.view(-1)[0] = 0.0
    return q.to(dev), s.to(dev)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", sorted(ATTN))
def test_quant_decode_kernel_matches_plain(dev, case, dtype):
    H, KVH, hd, bs, NB, lengths = ATTN[case]
    gen = torch.Generator().manual_seed(4)
    MB = max(-(-n // bs) for n in lengths) + 2
    q = _rand(gen, (len(lengths), H, hd), dtype, dev)
    k, ks = _int8(gen, (NB, bs, KVH, hd), dev)
    v, vs = _int8(gen, (NB, bs, KVH, hd), dev)
    bt = _tables(gen, lengths, NB, MB, bs).to(dev)      # NB sentinel padding
    bt[0, 0] = 0                                       # the zero-scale block
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = paged_attention.quant_block_paged_decode_attention(
        q, k, ks, v, vs, bt, lens)
    want = ref.quant_block_paged_decode_attention_ref(q, k, ks, v, vs, bt,
                                                      lens)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    # q_len == 1 through the int8 mixed kernel is the same function
    # (another kernel, whose sums run in another order)
    mixed = paged_attention.quant_mixed_block_paged_attention(
        q[:, None].contiguous(), k, ks, v, vs, bt, lens, torch.ones_like(lens))
    torch.testing.assert_close(mixed[:, 0].float(), got.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("Sq,ctx,q_len", [(16, 37, 16), (24, 40, 7),
                                          (40, 300, 33)])
def test_quant_mixed_kernel_matches_plain(dev, Sq, ctx, q_len, dtype):
    H, KVH, hd, bs, NB = 8, 2, 64, 16, 32
    gen = torch.Generator().manual_seed(5)
    q = _rand(gen, (2, Sq, H, hd), dtype, dev)
    k, ks = _int8(gen, (NB, bs, KVH, hd), dev)
    v, vs = _int8(gen, (NB, bs, KVH, hd), dev)
    ctxs = [ctx, max(q_len, ctx // 2)]
    bt = _tables(gen, ctxs, NB, -(-ctx // bs) + 1, bs).to(dev)
    c = torch.tensor(ctxs, dtype=torch.int32, device=dev)
    ql = torch.tensor([q_len, q_len], dtype=torch.int32, device=dev)
    got = paged_attention.quant_mixed_block_paged_attention(
        q, k, ks, v, vs, bt, c, ql)
    want = ref.quant_mixed_block_paged_attention_ref(q, k, ks, v, vs, bt, c,
                                                     ql)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_quant_v_scale_stays_out_of_the_softmax_sum(dev):
    """Doubling every v scale doubles the output exactly: the v scale
    multiplies the probability rows, never the running sum l (a kernel
    that added p * sv to l would return the output unchanged)."""
    H, KVH, hd, bs, NB, lengths = ATTN["gqa8-hd128"]
    gen = torch.Generator().manual_seed(6)
    q = _rand(gen, (len(lengths), H, hd), torch.float32, dev)
    k, ks = _int8(gen, (NB, bs, KVH, hd), dev)
    v, vs = _int8(gen, (NB, bs, KVH, hd), dev)
    bt = _tables(gen, lengths, NB, -(-max(lengths) // bs), bs).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    base = paged_attention.quant_block_paged_decode_attention(
        q, k, ks, v, vs, bt, lens)
    twice = paged_attention.quant_block_paged_decode_attention(
        q, k, ks, v, 2 * vs, bt, lens)
    assert torch.equal(twice, 2 * base)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("E,C,D,F", [(5, 1, 300, 130), (7, 3, 64, 257),
                                     (3, 9, 512, 96), (2, 13, 260, 40),
                                     (4, 1, 2048, 768)])
def test_quant_paged_gmm_matches_plain(dev, E, C, D, F, dtype):
    gen = torch.Generator().manual_seed(7)
    P = E + 3
    pool, scales = _int8(gen, (P, D, F), dev, top=3 * D ** -0.5)
    x = _rand(gen, (E, C, D), dtype, dev)
    perm = torch.randperm(P, generator=gen)[:E]
    for table in (perm, perm[torch.arange(E) % 2],     # permuted, aliased
                  torch.zeros(E, dtype=torch.int64)):  # the zero-scale page
        table = table.to(torch.int32).to(dev)
        got = moe_gmm.quant_paged_gmm(table, pool, scales, x)
        want = ref.quant_paged_gmm_ref(table, pool, scales, x)
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_quant_expert_ffn_and_counters(dev):
    gen = torch.Generator().manual_seed(8)
    E, C, D, F, P = 4, 5, 128, 96, 6
    pi, si = _int8(gen, (P, D, F), dev, top=3 * D ** -0.5)
    pg, sg = _int8(gen, (P, D, F), dev, top=3 * D ** -0.5)
    po, so = _int8(gen, (P, F, D), dev, top=3 * F ** -0.5)
    x = _rand(gen, (E, C, D), torch.float32, dev)
    t = torch.tensor([5, 1, 1, 2], dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    got = ops.quant_paged_expert_ffn(t, t, t, pi, pg, po, si, sg, so, x)
    assert ops.launch_counts()["quant_paged_gmm"] == 3
    with ops.use_reference():
        want = ops.quant_paged_expert_ffn(t, t, t, pi, pg, po, si, sg, so, x)
    assert ops.launch_counts()["quant_paged_gmm"] == 3   # plain: no launch
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    w = dequantize_rows(pi, si, (-2, -1))
    torch.testing.assert_close(ops.paged_gmm(t, w, x),
                               ops.quant_paged_gmm(t, pi, si, x),
                               **TOL[torch.float32])


def test_quant_wrappers_refuse_what_the_kernel_does_not_take(dev):
    """The int8 decode takes whole 16-byte pieces of a row (hd a multiple
    of 16, pools 16-byte aligned), at most 16 query heads per kv head and
    hd at most 128; the int8 mixed attention hd a multiple of 8."""
    gen = torch.Generator().manual_seed(9)
    bt = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    lens = torch.tensor([3, 5], dtype=torch.int32, device=dev)
    for H, KVH, hd in ((4, 2, 24), (34, 2, 64), (4, 4, 144)):
        q = torch.randn(2, H, hd, device=dev)
        k, ks = _int8(gen, (6, 4, KVH, hd), dev)
        with pytest.raises(ValueError, match="multiple of 16"):
            paged_attention.quant_block_paged_decode_attention(
                q, k, ks, k, ks, bt, lens)
    q = torch.randn(2, 4, 12, device=dev)
    k, ks = _int8(gen, (6, 4, 2, 12), dev)             # hd 12: not 8-aligned
    with pytest.raises(ValueError, match="multiple of 8"):
        paged_attention.quant_block_paged_decode_attention(
            q, k, ks, k, ks, bt, lens)
    with pytest.raises(ValueError, match="multiple of 8"):
        paged_attention.quant_mixed_block_paged_attention(
            q[:, None].contiguous(), k, ks, k, ks, bt, lens, lens)
    q = torch.randn(2, 4, 32, device=dev)
    flat = torch.randint(-127, 128, (6 * 4 * 2 * 32 + 8,), generator=gen,
                         dtype=torch.int8).to(dev)
    k = flat[8:].view(6, 4, 2, 32)                     # 8 bytes off
    ks = torch.rand(6, 4, generator=gen).to(dev) / 127
    with pytest.raises(ValueError, match="aligned"):
        paged_attention.quant_block_paged_decode_attention(
            q, k, ks, k, ks, bt, lens)
    k8, ks8 = _int8(gen, (6, 4, 2, 8), dev)
    with pytest.raises(TypeError):
        paged_attention.quant_block_paged_decode_attention(
            q[..., :8].contiguous(), k8, ks8.double(), k8, ks8, bt, lens)
    pool, scales = _int8(gen, (3, 8, 4), dev)
    x = torch.randn(2, 1, 8, device=dev)
    t = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        moe_gmm.quant_paged_gmm(t, pool.float(), scales, x)
    with pytest.raises(ValueError):
        moe_gmm.quant_paged_gmm(t, pool, scales[:2], x)


# --------------------------------------------- slot-contiguous KV, prefill

FLASH = {  # B, S, H, KVH, hd
    "gqa8-hd128-ragged": (1, 200, 32, 4, 128),
    "mha-hd64-ragged": (2, 77, 4, 4, 64),
    "gqa2-hd64-one-tile": (2, 64, 8, 4, 64),
    "gqa8-hd128-one-token": (1, 1, 8, 1, 128),
    "mha-hd80-ragged": (1, 200, 32, 32, 80),
    "mha-hd80-two-sequences": (2, 77, 4, 4, 80),
}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", sorted(FLASH))
def test_flash_attention_matches_plain(dev, case, dtype, causal):
    B, S, H, KVH, hd = FLASH[case]
    gen = torch.Generator().manual_seed(10)
    q = _rand(gen, (B, S, H, hd), dtype, dev)
    k = _rand(gen, (B, S, KVH, hd), dtype, dev)
    v = _rand(gen, (B, S, KVH, hd), dtype, dev)
    got = flash_attention.flash_attention(q, k, v, causal)
    want = ref.flash_attention_ref(q, k, v, causal)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("dims", flash_attention.HEAD_DIMS,
                         ids=lambda d: f"{d[0]}-{d[1]}")
def test_flash_attention_tile_boundaries(dev, dims, G, dtype, causal):
    """Every (hd, hdv) instance at S one token either side of the 64-row
    query and key tiles and on them, at two tiles and one, and at 1; one,
    four (a qwen3-30b-a3b rank at tp = 8: 4 query heads, the one kv head
    they read) and eight query heads a kv head; queries scaled so each score has a
    standard deviation of 3 (a peaked softmax, where a probability rounded
    to bf16 before P.V moves the output by more than its own rounding).
    In bf16 the output is the f32 answer rounded once."""
    hd, hdv = dims
    KVH = 2 if G == 1 else 1
    gen = torch.Generator().manual_seed(20)
    for S in (63, 64, 65, 129, 1):
        q = _rand(gen, (2, S, G * KVH, hd), dtype, dev, 3.0)
        k = _rand(gen, (2, S, KVH, hd), dtype, dev)
        v = _rand(gen, (2, S, KVH, hdv), dtype, dev)
        ops.reset_launch_counts()
        got = flash_attention.flash_attention(q, k, v, causal)
        assert ops.launch_counts()["flash_attention"] == 1
        want = ref.flash_attention_ref(q, k, v, causal)
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
        if dtype == torch.bfloat16:
            want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                             causal)
            _assert_one_bf16_rounding(got, want32, f"flash_attention S={S}")


# the last slice's flash instances: (B, S, Skv, H, KVH, hd, causal,
# window): the VLM's cross prefill at a ragged Skv, the encoder's
# non-causal head width 80, a causal window at and either side of a key
# tile, and a cross window under which rows past Skv - 1 + W attend no key
FLASH_NEW = {
    "cross": (2, 65, 1601, 8, 2, 128, False, None),
    "cross-one-row": (1, 1, 33, 4, 4, 64, False, None),
    "encoder-hd80": (2, 129, 129, 4, 4, 80, False, None),
    "window-63": (1, 300, 300, 8, 2, 128, True, 63),
    "window-64": (1, 300, 300, 8, 2, 128, True, 64),
    "window-65": (2, 257, 257, 4, 4, 64, True, 65),
    "window-1": (1, 70, 70, 4, 4, 64, True, 1),
    "cross-window-empty-rows": (2, 130, 24, 8, 2, 128, False, 8),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", sorted(FLASH_NEW))
def test_flash_attention_cross_and_window_match_plain(dev, case, dtype):
    """Keys of their own length (a cross-attention), non-causal, and the
    sliding window's mask, whose skipped key tiles and masked edge tiles
    give the plain version's answer; a row with no key left gives the
    uniform mean of v, as the plain version (the reference's -1e30 mask)
    does.  bf16 within one rounding of the f32 answer."""
    B, S, Skv, H, KVH, hd, causal, window = FLASH_NEW[case]
    gen = torch.Generator().manual_seed(31)
    q = _rand(gen, (B, S, H, hd), dtype, dev, 3.0)
    k = _rand(gen, (B, Skv, KVH, hd), dtype, dev)
    v = _rand(gen, (B, Skv, KVH, hd), dtype, dev)
    ops.reset_launch_counts()
    got = flash_attention.flash_attention(q, k, v, causal, window=window)
    assert ops.launch_counts()["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    if dtype == torch.bfloat16:
        want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                         causal, window=window)
        _assert_one_bf16_rounding(got, want32, f"flash_attention {case}")



@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("dims", flash_attention_bwd.HEAD_DIMS,
                         ids=lambda d: f"{d[0]}-{d[1]}")
def test_flash_attention_bwd_matches_plain(dev, dims, G, dtype):
    """The backward's every (hd, hdv) instance at S = 1, either side of
    its 32-column slices and 64-row tiles, on them and ragged past several;
    one, four and eight query heads a kv head (its dK and dV sum the
    group inside a block).  The forward's LSE output leaves its output
    bit for bit as it was and is within 1e-4 of the plain version's; the
    gradients are within ``TOL`` of the plain version's on the same o and
    lse, and a second launch gives the same bits (no float atomics)."""
    hd, hdv = dims
    KVH = 2 if G == 1 else 1
    gen = torch.Generator().manual_seed(40)
    for S in (1, 31, 33, 63, 64, 65, 129, 200):
        q = _rand(gen, (2, S, G * KVH, hd), dtype, dev)
        k = _rand(gen, (2, S, KVH, hd), dtype, dev)
        v = _rand(gen, (2, S, KVH, hdv), dtype, dev)
        do = _rand(gen, (2, S, G * KVH, hdv), dtype, dev)
        o, lse = flash_attention.flash_attention(q, k, v, True, lse=True)
        assert torch.equal(o, flash_attention.flash_attention(q, k, v, True))
        _, lse_plain = ref.flash_attention_lse_ref(q, k, v, True)
        torch.testing.assert_close(lse, lse_plain, atol=1e-4, rtol=1e-4)
        ops.reset_launch_counts()
        got = flash_attention_bwd.flash_attention_bwd(q, k, v, o, lse, do)
        assert ops.launch_counts()["flash_attention_bwd"] == 1
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            torch.testing.assert_close(g.float(), w.float(), **TOL[dtype],
                                       msg=lambda m: f"{name} S={S}: {m}")
        again = flash_attention_bwd.flash_attention_bwd(q, k, v, o, lse, do)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_attention_grad_runs_both_kernels_or_neither(dev):
    """Where an input requires grad, ``ops.flash_attention`` runs the
    forward with its LSE and the backward kernel; under
    ``use_reference()`` neither launches, also in the backward, which the
    autograd engine runs on a thread of its own."""
    gen = torch.Generator().manual_seed(41)
    shapes = ((2, 130, 8, 128), (2, 130, 2, 128), (2, 130, 2, 128))
    base = [_rand(gen, s, torch.bfloat16, dev) for s in shapes]
    do = _rand(gen, (2, 130, 8, 128), torch.bfloat16, dev)
    grads = {}
    for plain in (False, True):
        ts = [t.clone().requires_grad_() for t in base]
        ops.reset_launch_counts()
        with ops.use_reference() if plain else contextlib.nullcontext():
            o = ops.flash_attention(*ts)
        o.backward(do)
        counts = ops.launch_counts()
        n = 0 if plain else 1
        assert (counts["flash_attention"], counts["flash_attention_bwd"]) \
            == (n, n)
        grads[plain] = [t.grad.float() for t in ts]
    for g, w in zip(grads[False], grads[True]):
        torch.testing.assert_close(g, w, **TOL[torch.bfloat16])


def test_training_step_under_remat_keeps_the_reference_mode(dev):
    """A checkpointed block's recomputation runs in its forward's mode:
    one f32 step of a tiny MoE under ``use_reference()`` launches no
    kernel, and the same step through the kernels is within 1e-4 of it."""
    from repro_torch.models.model import init_params
    from repro_torch.training.optimizer import AdamWConfig, init_state
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.configs import ModelConfig
    cfg = ModelConfig(name="test-moe", arch_type="moe", num_layers=2,
                      d_model=64, vocab_size=128, num_heads=4,
                      num_kv_heads=4, head_dim=16, d_ff=128, num_experts=24,
                      top_k=2, moe_d_ff=32, dtype="float32",
                      capacity_factor=100.0)
    gen = torch.Generator().manual_seed(42)
    tokens = torch.randint(0, cfg.vocab_size, (2, 33), generator=gen)
    batch = {"tokens": tokens[:, :-1].to(dev), "labels": tokens[:, 1:].to(dev)}
    out = {}
    for plain in (True, False):
        params = init_params(cfg, 0, device=dev, experts=True)
        opt = AdamWConfig(warmup_steps=1)
        step = make_train_step(cfg, opt)
        ops.reset_launch_counts()
        with ops.use_reference() if plain else contextlib.nullcontext():
            params, _, m = step(params, init_state(opt, params), batch)
        counts = ops.launch_counts()
        assert (counts["flash_attention"] == 0) == plain
        assert (counts["flash_attention_bwd"] == 0) == plain
        out[plain] = (m["loss"], params)
    torch.testing.assert_close(out[False][0], out[True][0], atol=1e-4,
                               rtol=1e-4)
    from repro_torch.distributed.sharding import tree_leaves as leaves
    for a, b in zip(leaves(out[False][1]), leaves(out[True][1])):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("W,rows", [(4, 4), (64, 64), (200, 130),
                                    (300, 257)])
def test_ring_decode_matches_plain_and_the_uniform_mean(dev, W, rows,
                                                         dtype):
    """The windowed ring decode (``starts``) at L < W, W <= L < 2W - 1
    and L >= 2W - 1 over a ring of ``rows`` = min(max_len, W) slots: the
    kernel reads ``[max(0, L - W + 1), min(L + 1, rows))``, and an empty
    range gives the uniform mean of all rows of v (the reference's
    softmax over equal -1e30 scores); a repeat launch gives the same bits;
    bf16 within one rounding of the f32 answer."""
    H, KVH, hd = 16, 2, 128
    Ls = [0, W - 1, W, 2 * W - 2, 2 * W - 1, 3 * W + 5]
    gen = torch.Generator().manual_seed(32)
    q = _rand(gen, (len(Ls), H, hd), dtype, dev, 3.0)
    kc = _rand(gen, (len(Ls), rows, KVH, hd), dtype, dev)
    vc = _rand(gen, (len(Ls), rows, KVH, hd), dtype, dev)
    end = torch.tensor([min(L + 1, rows) for L in Ls], dtype=torch.int32,
                       device=dev)
    start = torch.tensor([max(0, L - W + 1) for L in Ls], dtype=torch.int32,
                         device=dev)
    got = paged_attention.paged_decode_attention(q, kc, vc, end,
                                                 starts=start)
    want = ref.paged_decode_attention_ref(q, kc, vc, end, starts=start)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(paged_attention.paged_decode_attention(
        q, kc, vc, end, starts=start), got)
    empty = start >= end
    assert empty.any()
    mean = vc.float().mean(1).repeat_interleave(H // KVH, 1)
    torch.testing.assert_close(got.float()[empty], mean[empty],
                               **TOL[dtype])
    if dtype == torch.bfloat16:
        want32 = ref.paged_decode_attention_ref(q.float(), kc.float(),
                                                vc.float(), end,
                                                starts=start)
        _assert_one_bf16_rounding(got, want32, f"ring decode W={W}")


SLOT = {  # H, KVH, hd, S_max, lengths
    "gqa8-hd128": (32, 4, 128, 256, [1, 256, 17, 300]),
    "mha-hd64-ragged-smax": (4, 4, 64, 50, [50, 1, 49]),
    "mha-hd80": (32, 32, 80, 256, [1, 256, 17, 300]),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", sorted(SLOT))
def test_slot_decode_kernel_matches_plain(dev, case, dtype):
    """Lengths of 1, of S_max and past S_max (clamped); an S_max that is
    not a multiple of the kernel's 16-row tile."""
    H, KVH, hd, S_max, lengths = SLOT[case]
    gen = torch.Generator().manual_seed(11)
    B = len(lengths)
    q = _rand(gen, (B, H, hd), dtype, dev)
    kc = _rand(gen, (B, S_max, KVH, hd), dtype, dev)
    vc = _rand(gen, (B, S_max, KVH, hd), dtype, dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = paged_attention.paged_decode_attention(q, kc, vc, lens)
    want = ref.paged_decode_attention_ref(q, kc, vc, lens)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _assert_one_bf16_rounding(got, want32, what, atol=3e-5):
    """bf16 ``got`` must be ``want32``, the f32 answer on the same inputs,
    rounded once: within half a bf16 step of it (a step is 2^(e-8) for a
    value in [2^(e-1), 2^e)), plus ``atol`` for f32 sums taken in another
    order.  One bf16 rounding of the probabilities before P.V (each
    moved by up to 2^-9 of itself) fails this at peaked scores."""
    half = torch.ldexp(torch.ones_like(want32),
                       torch.frexp(want32).exponent - 9)
    excess = ((got.float() - want32).abs() - half).max().item()
    assert excess <= atol, f"{what}: {excess:.3e} past one bf16 rounding"


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("G", [1, 8, 16])
@pytest.mark.parametrize("form", ["block", "slot", "int8"])
def test_decode_splits_match_plain(dev, form, G, dtype):
    """The split-context decode over both addressings and over int8 block
    pools with their scales (one row of a live block with a zero scale,
    row scales 100x apart): lengths one token either side of a split
    boundary and on it, at the cap (the slot cache's S_max rows, or the
    tables' MB * bs positions) and past it (clamped), and 1; groups of 1,
    8 and 16 query heads per kv head (chatglm3-6b's 32 over 2); queries
    scaled so each score has a standard deviation of 3 (a peaked softmax,
    as in decode, where a wrong score moves the output by a row, not by
    the mean of the rows).  In bf16 the output is the f32 answer rounded
    once.  A second launch reuses the split counters the first left at
    zero and gives the same bits."""
    CH = paged_attention.TOKENS_PER_BLOCK
    KVH, hd, bs = 2, 128, 16
    S_max = 3 * CH + 5
    MB = -(-S_max // bs)
    cap = S_max if form == "slot" else MB * bs      # 389 or 400
    lengths = [CH - 1, CH, CH + 1, 2 * CH, 2 * CH + 1, cap, cap + 7, 1]
    B, H = len(lengths), G * KVH
    gen = torch.Generator().manual_seed(17)
    q = _rand(gen, (B, H, hd), dtype, dev, 3.0)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if form == "slot":
        kc = _rand(gen, (B, S_max, KVH, hd), dtype, dev)
        vc = _rand(gen, (B, S_max, KVH, hd), dtype, dev)
        args = (q, kc, vc, lens)
        kern = paged_attention.paged_decode_attention
        plain = ref.paged_decode_attention_ref
    elif form == "int8":
        NB = B * MB + 3
        k, ks = _int8(gen, (NB, bs, KVH, hd), dev)      # pool row 0: scale 0
        v, vs = _int8(gen, (NB, bs, KVH, hd), dev)
        bt = _tables(gen, [min(n, cap) for n in lengths], NB, MB, bs)
        bt[0, 0] = 0                                   # a live block
        args = (q, k, ks, v, vs, bt.to(dev), lens)
        kern = paged_attention.quant_block_paged_decode_attention
        plain = ref.quant_block_paged_decode_attention_ref
    else:
        NB = B * MB + 3
        k = _rand(gen, (NB, bs, KVH, hd), dtype, dev)
        v = _rand(gen, (NB, bs, KVH, hd), dtype, dev)
        bt = _tables(gen, [min(n, cap) for n in lengths], NB, MB, bs)
        args = (q, k, v, bt.to(dev), lens)
        kern = paged_attention.block_paged_decode_attention
        plain = ref.block_paged_decode_attention_ref
    ops.reset_launch_counts()
    got = kern(*args)
    again = kern(*args)
    assert ops.launch_counts()[kern.__name__] == 2
    want = plain(*args)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    if dtype == torch.bfloat16:
        want32 = plain(*(t.float() if t.is_floating_point() else t
                         for t in args))
        _assert_one_bf16_rounding(got, want32, kern.__name__)
    assert torch.equal(got, again)
    stream = torch.cuda.current_stream().cuda_stream
    assert not _build.split_counters(dev, stream, B * KVH)[:B * KVH].any()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [4, 8])
@pytest.mark.parametrize("form", ["block", "int8"])
def test_mixed_spans_and_tiles_match_plain(dev, form, G, hd, dtype):
    """The mixed attentions over bf16/f32 and int8 pools (a live block
    with a zero scale, row scales 100x apart): contexts that end on and one
    token either side of a 64-key tile edge and of a span edge, a longer
    one over several spans; a chunk with padding rows (q_len < Sq) and a
    full one (q_len = Sq); a prompt's first chunk (ctx = q_len); beside
    each, a second sequence with one row (q_len = 1).  Queries scaled so
    each score has a standard deviation of 3 (a peaked softmax); in bf16
    the output is the f32 answer rounded once.  A second launch reuses the
    span counters the first left at zero and gives the same bits."""
    SPAN = paged_attention.MIXED_TOKENS_PER_BLOCK
    KVH, bs, Sq = 2, 16, 40
    H = G * KVH
    cases = []   # (ctx, q_len) of sequence 0; sequence 1 has q_len 1
    for ctx in (63, 64, 65, SPAN - 1, SPAN, SPAN + 1, 2 * SPAN + 77):
        cases += [(ctx, min(Sq, ctx)), (ctx, min(Sq - 9, ctx))]
    cases += [(Sq, Sq), (Sq - 9, Sq - 9)]             # first chunks
    MB = -(-max(c for c, _ in cases) // bs) + 1
    NB = 2 * MB + 3
    gen = torch.Generator().manual_seed(21)
    if form == "int8":
        k, ks = _int8(gen, (NB, bs, KVH, hd), dev)      # pool row 0: scale 0
        v, vs = _int8(gen, (NB, bs, KVH, hd), dev)
        pools = (k, ks, v, vs)
        kern = paged_attention.quant_mixed_block_paged_attention
        plain = ref.quant_mixed_block_paged_attention_ref
    else:
        pools = (_rand(gen, (NB, bs, KVH, hd), dtype, dev),
                 _rand(gen, (NB, bs, KVH, hd), dtype, dev))
        kern = paged_attention.mixed_block_paged_attention
        plain = ref.mixed_block_paged_attention_ref
    for ctx, q_len in cases:
        ctxs = [ctx, ctx + 3]
        bt = _tables(gen, ctxs, NB, MB, bs)
        bt[0, 0] = 0                                   # a live block
        bt = bt.to(dev)
        q = _rand(gen, (2, Sq, H, hd), dtype, dev, 3.0)
        args = (q, *pools, bt,
                torch.tensor(ctxs, dtype=torch.int32, device=dev),
                torch.tensor([q_len, 1], dtype=torch.int32, device=dev))
        ops.reset_launch_counts()
        got = kern(*args)
        again = kern(*args)
        assert ops.launch_counts()[kern.__name__] == 2
        want = plain(*args)
        what = f"{kern.__name__} ctx={ctx} q_len={q_len}"
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype],
                                   msg=what)
        if dtype == torch.bfloat16:
            want32 = plain(*(t.float() if t.is_floating_point() else t
                             for t in args))
            _assert_one_bf16_rounding(got, want32, what)
        assert torch.equal(got, again), what
    stream = torch.cuda.current_stream().cuda_stream
    assert not _build.split_counters(dev, stream, 1).any()


def test_mixed_wrappers_refuse_what_the_tensor_cores_do_not_take(dev):
    """bf16 q: a head dim that is not a multiple of 16 or above 128, and
    q or the pools off a 16-byte boundary."""
    gen = torch.Generator().manual_seed(22)
    bt = torch.zeros(1, 2, dtype=torch.int32, device=dev)
    lens = torch.tensor([3], dtype=torch.int32, device=dev)
    for hd in (40, 144):
        q = torch.randn(1, 4, 4, hd, device=dev, dtype=torch.bfloat16)
        kp = torch.zeros(4, 16, 2, hd, device=dev, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dim"):
            paged_attention.mixed_block_paged_attention(q, kp, kp, bt, lens,
                                                        lens)
        k8, ks = _int8(gen, (4, 16, 2, hd), dev)
        with pytest.raises(ValueError, match="head dim"):
            paged_attention.quant_mixed_block_paged_attention(
                q, k8, ks, k8, ks, bt, lens, lens)
    q = torch.randn(1, 4, 4, 64, device=dev, dtype=torch.bfloat16)
    flat = torch.zeros(4 * 16 * 2 * 64 + 4, device=dev, dtype=torch.bfloat16)
    kp = flat[4:].view(4, 16, 2, 64)                   # 8 bytes off
    with pytest.raises(ValueError, match="aligned"):
        paged_attention.mixed_block_paged_attention(q, kp, kp, bt, lens, lens)
    k8, ks = _int8(gen, (4, 16, 2, 64), dev)
    flat8 = torch.zeros(4 * 16 * 2 * 64 + 8, device=dev, dtype=torch.int8)
    k_off = flat8[8:].view(4, 16, 2, 64)               # 8 bytes off
    with pytest.raises(ValueError, match="aligned"):
        paged_attention.quant_mixed_block_paged_attention(
            q, k_off, ks, k8, ks, bt, lens, lens)
    qflat = torch.zeros(4 * 4 * 64 + 4, device=dev, dtype=torch.bfloat16)
    q_off = qflat[4:].view(1, 4, 4, 64)                # 8 bytes off
    kp = torch.zeros(4, 16, 2, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        paged_attention.mixed_block_paged_attention(q_off, kp, kp, bt, lens,
                                                    lens)


def test_decode_wrappers_refuse_what_the_kernel_does_not_take(dev):
    """More than 16 query heads per kv head, a head dim above 128 or not
    in whole 16-byte pieces, and K/V off a 16-byte boundary."""
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    for H, KVH, hd in ((34, 2, 64), (4, 4, 256), (4, 4, 66)):
        q = torch.randn(1, H, hd, device=dev, dtype=torch.bfloat16)
        kc = torch.zeros(1, 8, KVH, hd, device=dev, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            paged_attention.paged_decode_attention(q, kc, kc, lens)
        bt = torch.zeros(1, 1, dtype=torch.int32, device=dev)
        with pytest.raises(ValueError):
            paged_attention.block_paged_decode_attention(q, kc, kc, bt, lens)
    q = torch.randn(1, 4, 64, device=dev)
    flat = torch.zeros(1 * 8 * 4 * 64 + 1, device=dev)
    kc = flat[1:].view(1, 8, 4, 64)                    # 4 bytes off
    with pytest.raises(ValueError, match="aligned"):
        paged_attention.paged_decode_attention(q, kc, kc, lens)


@pytest.mark.parametrize("dtype", DTYPES + [torch.int8], ids=str)
@pytest.mark.parametrize("row", [(4, 128), (3, 5)], ids=["vec16", "bytes"])
def test_kv_cache_write_matches_plain_bit_for_bit(dev, dtype, row):
    """Positions 0, S-1, S (dropped) and -1 (dropped); 16-byte rows and
    rows of an odd byte count."""
    gen = torch.Generator().manual_seed(12)
    B, S = 4, 37
    cache = torch.randint(-100, 100, (B, S, *row), generator=gen).to(dtype) \
        .to(dev)
    new = torch.randint(-100, 100, (B, *row), generator=gen).to(dtype).to(dev)
    pos = torch.tensor([0, S - 1, S, -1], dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    got = kv_write.kv_cache_write(cache.clone(), new, pos)
    assert ops.launch_counts()["kv_cache_write"] == 1
    want = ref.kv_cache_write_ref(cache.clone(), new, pos)
    assert torch.equal(got, want)
    assert torch.equal(got[2], cache[2]) and torch.equal(got[3], cache[3])
    assert torch.equal(got[0, 0], new[0]) and torch.equal(got[1, S - 1],
                                                          new[1])


def test_dense_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.randn(1, 8, 4, 48, device=dev)                 # hd 48
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention(q, q, q)
    q = torch.randn(1, 8, 4, 64, device=dev)
    with pytest.raises(TypeError):
        flash_attention.flash_attention(q, q.bfloat16(), q)
    cache = torch.zeros(2, 8, 4, 64, device=dev)
    with pytest.raises(TypeError):
        kv_write.kv_cache_write(cache, torch.zeros(2, 4, 64, device=dev,
                                                   dtype=torch.bfloat16),
                                torch.zeros(2, dtype=torch.int32, device=dev))
    with pytest.raises(TypeError):
        paged_attention.paged_decode_attention(
            q[:, 0].contiguous(), cache, cache,
            torch.ones(2, dtype=torch.int64, device=dev))


# ------------------------------------------------------------------- MLA

MLA = {  # H, r, dr, S_max, lengths
    "full-one-smax-past": (16, 512, 64, 2048, [1, 2048, 2049, 777]),
    "full-ragged-smax-zero": (16, 512, 64, 1000, [1000, 999, 0, 333]),
    "full-h6-three-groups": (6, 512, 64, 64, [64, 3]),
    "reduced-h4": (4, 64, 16, 96, [96, 5, 50]),
    "reduced-h2-one-group": (2, 64, 16, 40, [40, 1]),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", sorted(MLA))
def test_mla_decode_kernel_matches_plain(dev, case, dtype):
    """Lengths of 0 (zeros), 1, S_max and past S_max (clamped); an S_max
    that is not a multiple of the 256-token block; 8, 3 and 1 groups of
    two heads."""
    H, r, dr, S_max, lengths = MLA[case]
    gen = torch.Generator().manual_seed(13)
    B = len(lengths)
    qe = _rand(gen, (B, H, r), dtype, dev, r ** -0.5)
    qr = _rand(gen, (B, H, dr), dtype, dev, dr ** -0.5)
    c = _rand(gen, (B, S_max, r), dtype, dev)
    kr = _rand(gen, (B, S_max, dr), dtype, dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    scale = (128 + dr) ** -0.5
    ops.reset_launch_counts()
    got = mla_decode.mla_decode_attention(qe, qr, c, kr, lens, scale)
    assert ops.launch_counts()["mla_decode_attention"] == 1
    want = ref.mla_decode_attention_ref(qe, qr, c, kr, lens, scale)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    for b, n in enumerate(lengths):
        if n == 0:
            assert not got[b].any()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("S", [200, 1000, 4096])
def test_mla_decode_splits_match_plain(dev, dtype, S):
    """A sequence read by one block (S = 200) or split over 4 or 16 blocks
    of 256 tokens (the last block merges them), lengths 0, 1, 256, 257
    and S, with scores spread over several units; the same numbers run to
    run (a fixed merge order) and on a second launch, which reuses the
    split counters the first left at zero."""
    gen = torch.Generator().manual_seed(16)
    H, r, dr = 4, 512, 64
    lengths = [0, 1, min(256, S), min(257, S), S]
    B = len(lengths)
    scale = (128 + dr) ** -0.5
    qe = _rand(gen, (B, H, r), dtype, dev, 3 * (128 + dr) ** 0.5 / r ** 0.5)
    qr = _rand(gen, (B, H, dr), dtype, dev, 3 * (128 + dr) ** 0.5 / dr ** 0.5)
    c = _rand(gen, (B, S, r), dtype, dev)
    kr = _rand(gen, (B, S, dr), dtype, dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = mla_decode.mla_decode_attention(qe, qr, c, kr, lens, scale)
    again = mla_decode.mla_decode_attention(qe, qr, c, kr, lens, scale)
    want = ref.mla_decode_attention_ref(qe, qr, c, kr, lens, scale)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(got, again) and not got[0].any()


@pytest.mark.parametrize("H", [4, 16, 128])
def test_mla_decode_span_edges_match_plain(dev, H):
    """The bf16 (tensor-core) kernel at lengths one short of a span, at a
    span and one past it, at two spans and at 0, for 4 heads (one group
    padded to 16 rows), deepseek-v2-lite's 16 and deepseek-v3's 128 (8
    groups), with peaked scores: within TOL of the plain version, within
    3e-5 past one bf16 rounding of the f32 answer, zeros at length 0, and
    the same bits on a second launch (the span counters are reused)."""
    gen = torch.Generator().manual_seed(21)
    r, dr, span = 512, 64, mla_decode.TOKENS_PER_BLOCK
    lengths = [span - 1, span, span + 1, 2 * span, 0]
    B, S = len(lengths), 2 * span + 3
    scale = (128 + dr) ** -0.5
    qe = _rand(gen, (B, H, r), torch.bfloat16, dev,
               3 * (128 + dr) ** 0.5 / r ** 0.5)
    qr = _rand(gen, (B, H, dr), torch.bfloat16, dev,
               3 * (128 + dr) ** 0.5 / dr ** 0.5)
    c = _rand(gen, (B, S, r), torch.bfloat16, dev)
    kr = _rand(gen, (B, S, dr), torch.bfloat16, dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = mla_decode.mla_decode_attention(qe, qr, c, kr, lens, scale)
    again = mla_decode.mla_decode_attention(qe, qr, c, kr, lens, scale)
    want = ref.mla_decode_attention_ref(qe, qr, c, kr, lens, scale)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])
    _assert_one_bf16_rounding(
        got, ref.mla_decode_attention_ref(qe.float(), qr.float(), c.float(),
                                          kr.float(), lens, scale),
        f"mla_decode_attention H={H}")
    assert torch.equal(got, again) and not got[-1].any()


MLA_FLASH = {  # B, S, H
    "h16-ragged": (1, 200, 16),
    "h4-two-sequences-one-tile": (2, 64, 4),
    "h2-one-token": (1, 1, 2),
}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", sorted(MLA_FLASH))
def test_flash_attention_192_128_matches_plain(dev, case, dtype, causal):
    """MLA's prefill instance: q/k rows of 192, v and output rows of 128,
    one kv head per query head, the model's scale given explicitly."""
    B, S, H = MLA_FLASH[case]
    gen = torch.Generator().manual_seed(15)
    q = _rand(gen, (B, S, H, 192), dtype, dev)
    k = _rand(gen, (B, S, H, 192), dtype, dev)
    v = _rand(gen, (B, S, H, 128), dtype, dev)
    got = flash_attention.flash_attention(q, k, v, causal, 0.05)
    want = ref.flash_attention_ref(q, k, v, causal, 0.05)
    assert tuple(got.shape) == (B, S, H, 128)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_mla_wrappers_refuse_what_the_kernels_do_not_take(dev):
    qe = torch.randn(2, 4, 256, device=dev)                  # r = 256
    qr = torch.randn(2, 4, 64, device=dev)
    c, kr = torch.randn(2, 8, 256, device=dev), torch.randn(2, 8, 64,
                                                            device=dev)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="kv_lora_rank"):
        mla_decode.mla_decode_attention(qe, qr, c, kr, lens, 0.1)
    qe, c = qe[..., :64].contiguous(), c[..., :64].contiguous()
    qr, kr = qr[..., :16].contiguous(), kr[..., :16].contiguous()
    with pytest.raises(TypeError):
        mla_decode.mla_decode_attention(qe, qr, c, kr, lens.long(), 0.1)
    with pytest.raises(TypeError):
        mla_decode.mla_decode_attention(qe, qr, c.bfloat16(), kr, lens, 0.1)
    with pytest.raises(ValueError):
        mla_decode.mla_decode_attention(qe, qr, c[:1].contiguous(), kr,
                                        lens, 0.1)
    with pytest.raises(ValueError, match="even"):
        mla_decode.mla_decode_attention(qe[:, :3].contiguous(),
                                        qr[:, :3].contiguous(), c, kr, lens,
                                        0.1)
    q = torch.randn(1, 8, 4, 192, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention(q, q, q)              # v 192


# ------------------------------------------------------------------ SSD

SSD_TOL = dict(atol=1e-3, rtol=1e-3)
SSD = {  # B, S, H, P, N, chunk
    "mamba2-s1024": (1, 1024, 64, 64, 128, 256),
    "zamba2-s1024": (1, 1024, 80, 64, 64, 128),
    "b2-s512": (2, 512, 64, 64, 128, 256),
    "ragged-s1000": (1, 1000, 8, 64, 128, 256),
    "reduced-ragged-s40": (2, 40, 4, 32, 16, 16),
    "p16-n8-c16": (2, 64, 8, 16, 8, 16),
    "one-token": (3, 1, 4, 64, 64, 128),
    "s-below-chunk-c100": (1, 250, 2, 40, 24, 100),
}


def _ssd_inputs(gen, B, S, H, P, N, dtype, dev, a_scale=1.0):
    """The reference test's distributions: dt in [0.01, 0.51], A in
    [-1.5, -0.5] times ``a_scale``."""
    return (_rand(gen, (B, S, H, P), dtype, dev),
            (torch.rand(B, S, H, generator=gen) * 0.5 + 0.01).to(dev),
            (-(torch.rand(H, generator=gen) + 0.5) * a_scale).to(dev),
            _rand(gen, (B, S, N), dtype, dev),
            _rand(gen, (B, S, N), dtype, dev))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", sorted(SSD))
def test_ssd_scan_matches_plain(dev, case, dtype):
    *shape, chunk = SSD[case]
    gen = torch.Generator().manual_seed(17)
    inputs = _ssd_inputs(gen, *shape, dtype, dev)
    ops.reset_launch_counts()
    y, st = ssd_scan.ssd_scan(*inputs, chunk)
    assert ops.launch_counts()["ssd_scan"] == 1
    wy, ws = ref.ssd_scan_ref(*inputs, chunk)
    assert y.dtype == st.dtype == torch.float32
    assert tuple(st.shape) == (shape[0], shape[2], shape[4], shape[3])
    torch.testing.assert_close(y, wy, **SSD_TOL)
    torch.testing.assert_close(st, ws, **SSD_TOL)
    again = ssd_scan.ssd_scan(*inputs, chunk)
    assert torch.equal(again[0], y) and torch.equal(again[1], st)


SSD_MMA = {  # B, S, H, P, N, chunk: the tensor-core instance's edges
    "mamba2-widths-1-chunk": (1, 256, 8, 64, 128, 256),
    "mamba2-widths-4-chunks": (1, 1024, 8, 64, 128, 256),
    "mamba2-widths-16-chunks": (1, 4096, 8, 64, 128, 256),
    "ragged-s1000-b2": (2, 1000, 4, 64, 128, 256),
    "zamba2-widths-c128": (1, 384, 16, 64, 64, 128),
    "chunk-100-not-row-tiles": (2, 300, 4, 64, 128, 100),
    "n-and-p-not-16-multiples": (1, 200, 4, 40, 24, 48),
}


@pytest.mark.parametrize("case", sorted(SSD_MMA))
def test_ssd_scan_tensor_cores_match_plain(dev, case):
    """The chunk-parallel tensor-core instance (bf16) at 1, 4 and 16
    chunks of mamba2's widths, a ragged S with B = 2, zamba2's N = P = 64
    at chunk 128, a chunk of 100 rows (no multiple of the 64-row tile),
    N and P multiples of 8 but not 16: within SSD_TOL of the plain
    version, and the same bits on a second launch."""
    *shape, chunk = SSD_MMA[case]
    gen = torch.Generator().manual_seed(22)
    inputs = _ssd_inputs(gen, *shape, torch.bfloat16, dev)
    assert ssd_scan.ssd_instance(inputs[0], inputs[3], inputs[4]) == \
        "tensor_cores"
    y, st = ssd_scan.ssd_scan(*inputs, chunk)
    wy, ws = ref.ssd_scan_ref(*inputs, chunk)
    torch.testing.assert_close(y, wy, **SSD_TOL)
    torch.testing.assert_close(st, ws, **SSD_TOL)
    again = ssd_scan.ssd_scan(*inputs, chunk)
    assert torch.equal(again[0], y) and torch.equal(again[1], st)


@pytest.mark.parametrize("case", ["mamba2-widths-4-chunks",
                                  "zamba2-widths-c128", "ragged-s1000-b2"])
def test_ssd_scan_tensor_cores_at_steep_decays(dev, case):
    """A twenty times the reference test's, dt as drawn there (a row's
    decay up to 15, up to 140 within a 16-row k-step; a served mamba2's
    steepest head, A = -16 with dt near softplus(0) = 0.69, decays 11 a
    row): no exp overflows into the products (a factor that did
    gave NaN), within SSD_TOL of the plain version run on the CPU, whose
    f32 cumsum accumulates in double (the card's sums it in f32, whose
    rounding at |acs| in the thousands is not the kernel's to match).
    dt ten times larger too would make |y| reach 660 from cancelling
    terms, where the f32 plain version is itself 1.7 tolerances from an
    f64 run: no f32 answer can be held to 1e-3 there."""
    *shape, chunk = SSD_MMA[case]
    gen = torch.Generator().manual_seed(23)
    inputs = _ssd_inputs(gen, *shape, torch.bfloat16, dev, a_scale=20.0)
    y, st = ssd_scan.ssd_scan(*inputs, chunk)
    wy, ws = (t.to(dev) for t in ref.ssd_scan_ref(
        *(t.cpu() for t in inputs), chunk))
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    torch.testing.assert_close(y, wy, **SSD_TOL)
    torch.testing.assert_close(st, ws, **SSD_TOL)


def test_ssd_scan_counts_and_use_reference(dev):
    gen = torch.Generator().manual_seed(18)
    inputs = _ssd_inputs(gen, 1, 64, 2, 32, 16, torch.float32, dev)
    ops.reset_launch_counts()
    got = ops.ssd_scan(*inputs, 16)
    with ops.use_reference():
        want = ops.ssd_scan(*inputs, 16)
    assert ops.launch_counts()["ssd_scan"] == 1         # plain: no launch
    torch.testing.assert_close(got, want, **SSD_TOL)


def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(dev):
    gen = torch.Generator().manual_seed(19)
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 1, 64, 2, 32, 16, torch.bfloat16,
                                   dev)
    with pytest.raises(TypeError):
        ssd_scan.ssd_scan(x, dt.bfloat16(), A, Bm, Cm, 16)
    with pytest.raises(TypeError):
        ssd_scan.ssd_scan(x, dt, A, Bm.float(), Cm, 16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2),
                          dt, A, Bm, Cm, 16)
    with pytest.raises(ValueError, match="shapes"):
        ssd_scan.ssd_scan(x, dt, A[:1].contiguous(), Bm, Cm, 16)
    big = _ssd_inputs(gen, 1, 512, 2, 32, 16, torch.bfloat16, dev)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan.ssd_scan(*big, 512)


# -------------------------------------------------------------- KV writes

def _write_rows(gen, shape, dtype, dev):
    """Rows whose token rows' maxima spread over four decades, the first
    token row all zeros (its int8 scale is the EPS floor's)."""
    x = torch.randn(shape, generator=gen)
    x = x * torch.exp(4.6 * torch.rand(shape[:-2] + (1, 1), generator=gen)
                      - 2.3)
    x.view(-1, *shape[-2:])[0] = 0.0
    return x.to(dtype).to(dev)


def _write_pools(gen, lead, row, store, dev):
    """K/V pools [*lead, *row] with earlier contents, f32 scales [*lead] for
    an int8 store (None otherwise)."""
    out = []
    for _ in range(2):
        if store == torch.int8:
            out.append(torch.randint(-127, 128, lead + row, generator=gen,
                                     dtype=torch.int8).to(dev))
            out.append((torch.rand(lead, generator=gen) + 0.01).to(dev))
        else:
            out.append(torch.randn(lead + row, generator=gen).to(store)
                       .to(dev))
            out.append(None)
    return out                               # k, k_scale, v, v_scale


def _assert_same(got, want):
    for g, w in zip(got, want):
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)


WRITE_ROWS = {"qwen3": (4, 128), "hd64": (4, 64), "odd": (3, 5)}
STORES = [torch.float32, torch.bfloat16, torch.int8]


@pytest.mark.parametrize("row", sorted(WRITE_ROWS))
@pytest.mark.parametrize("src", DTYPES, ids=str)
@pytest.mark.parametrize("store", STORES, ids=str)
def test_kv_paged_write_matches_plain_bit_for_bit(dev, store, src, row):
    """A decode step's rows: live writes to blocks 3, NB - 1 and 0, two
    inactive slots on the NB sentinel at the live NB - 1 row's offset (a
    clamped sentinel would collide with it), K rows read through a batch
    stride ([B, 2, ...][:, 1]).  The int8 rows and their scales are
    the plain version's as it runs on the card, bit for bit; a second
    launch gives the same bits."""
    gen = torch.Generator().manual_seed(20)
    NB, bs = 11, 16
    shape = WRITE_ROWS[row]
    pools = _write_pools(gen, (NB, bs), shape, store, dev)
    wb = torch.tensor([3, NB, NB - 1, NB, 0], dtype=torch.int32, device=dev)
    lens = torch.tensor([21, 2 + 3 * bs, 2 + bs, 2, 31], dtype=torch.int32,
                        device=dev)
    k = _write_rows(gen, (5, 2) + shape, src, dev)[:, 1]
    v = _write_rows(gen, (5,) + shape, src, dev)
    want = [None if t is None else t.clone() for t in pools]
    ref.kv_paged_write_ref(want[0], want[2], k, v, wb, lens, want[1],
                           want[3])
    for _ in range(2):
        got = [None if t is None else t.clone() for t in pools]
        ops.reset_launch_counts()
        kv_write.kv_paged_write(got[0], got[2], k, v, wb, lens, got[1],
                                got[3])
        assert ops.launch_counts()["kv_cache_write"] == 1
        torch.cuda.synchronize()
        _assert_same(got, want)
    assert not torch.equal(got[0][NB - 1, 2], pools[0][NB - 1, 2])


@pytest.mark.parametrize("L,strided", [(1, False), (3, True)],
                         ids=["chunk", "prefill-layers"])
@pytest.mark.parametrize("row", sorted(WRITE_ROWS))
@pytest.mark.parametrize("src", DTYPES, ids=str)
@pytest.mark.parametrize("store", STORES, ids=str)
def test_kv_block_write_matches_plain_bit_for_bit(dev, store, src, row, L,
                                                  strided):
    """Whole blocks: a chunk's 4 blocks into one layer (blocks 6 and NB - 1
    written, a CoW-shared block and padding on the sentinel), and a
    prefill's rows into 3 layers at once, read through the dense cache's
    layer and token strides ([L, 1, S, ...][:, 0, :n * bs])."""
    gen = torch.Generator().manual_seed(21)
    NB, bs = 11, 16
    shape = WRITE_ROWS[row]
    pools = _write_pools(gen, (L, NB, bs), shape, store, dev)
    ids = torch.tensor([6, NB, NB - 1, NB], dtype=torch.int32, device=dev)
    n = ids.shape[0] * bs
    if strided:
        k = _write_rows(gen, (L, 1, n + 24) + shape, src, dev)[:, 0, :n]
        v = _write_rows(gen, (L, 1, n + 24) + shape, src, dev)[:, 0, :n]
    else:
        k = _write_rows(gen, (L, n) + shape, src, dev)
        v = _write_rows(gen, (L, n) + shape, src, dev)
    want = [None if t is None else t.clone() for t in pools]
    ref.kv_block_write_ref(want[0], want[2], k, v, ids, want[1], want[3])
    for _ in range(2):
        got = [None if t is None else t.clone() for t in pools]
        kv_write.kv_block_write(got[0], got[2], k, v, ids, got[1], got[3])
        torch.cuda.synchronize()
        _assert_same(got, want)


@pytest.mark.parametrize("rows", [((4, 128), (4, 128)), ((512,), (64,)),
                                  ((3, 5), (7,))],
                         ids=["kv", "mla-latent", "odd"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kv_cache_write_pair_matches_plain_bit_for_bit(dev, dtype, rows):
    """Two slot caches in one launch, each with its own row width: K and V
    of qwen3-30b-a3b, MLA's latent (1 KiB in bf16) and rope-key (128 B)
    rows, and odd byte counts; positions 0, S - 1, S (dropped) and -1
    (dropped); rows read through a batch stride."""
    gen = torch.Generator().manual_seed(22)
    B, S = 4, 37
    caches = [_rand(gen, (B, S) + r, dtype, dev) for r in rows]
    new = [_rand(gen, (B, 2) + r, dtype, dev)[:, 1] for r in rows]
    pos = torch.tensor([0, S - 1, S, -1], dtype=torch.int32, device=dev)
    want = ref.kv_cache_write_pair_ref(caches[0].clone(), new[0],
                                       caches[1].clone(), new[1], pos)
    for _ in range(2):
        ops.reset_launch_counts()
        got = kv_write.kv_cache_write_pair(caches[0].clone(), new[0],
                                           caches[1].clone(), new[1], pos)
        assert ops.launch_counts()["kv_cache_write"] == 1
        torch.cuda.synchronize()
        _assert_same(got, want)


def test_kv_write_wrappers_refuse_what_the_kernels_do_not_take(dev):
    pool = torch.zeros(4, 16, 2, 8, device=dev)
    new = torch.zeros(2, 2, 8, device=dev)
    i32 = torch.zeros(2, dtype=torch.int32, device=dev)
    q8 = pool.to(torch.int8)
    with pytest.raises(TypeError):
        kv_write.kv_paged_write(pool, pool, new, new, i32.long(), i32)
    with pytest.raises(ValueError, match="scale"):
        kv_write.kv_paged_write(q8, q8, new, new, i32, i32)
    with pytest.raises(ValueError, match="scale"):
        kv_write.kv_paged_write(pool, pool, new, new, i32, i32,
                                pool[..., 0, 0], pool[..., 0, 0])
    with pytest.raises(ValueError, match="contiguous"):
        kv_write.kv_paged_write(pool, pool, new.transpose(1, 2).contiguous()
                                .transpose(1, 2), new, i32, i32)
    with pytest.raises(TypeError):
        kv_write.kv_paged_write(pool.double(), pool.double(), new.double(),
                                new.double(), i32, i32)
    with pytest.raises(ValueError, match="expected"):
        kv_write.kv_block_write(pool[None], pool[None], new[None], new[None],
                                i32)
    with pytest.raises(TypeError):
        kv_write.kv_cache_write_pair(pool, pool[:, 0].bfloat16(), pool,
                                     pool[:, 0], i32.new_zeros(4))


# ---------------------------------------------------- steps with no syncs

@contextlib.contextmanager
def _no_host_sync():
    """Any synchronising CUDA call inside raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _booted(name, dev, **knobs):
    """A reduced (2-layer) model in bf16, booted on ``dev``."""
    from repro_torch.configs import get_config
    from repro_torch.core.hmm import HMM
    from repro_torch.core.topology import ElasticConfig
    cfg = dataclasses.replace(get_config(name + "-smoke"), dtype="bfloat16")
    hmm = HMM(cfg, 1, batch_per_replica=4, max_len=128, seed=0,
              device=dev, **knobs)
    hmm.boot(ElasticConfig(1, 1, (0,)))
    for leaf in hmm.cache.values():          # earlier contents
        if leaf.dtype == torch.int8:
            leaf.random_(-127, 128)
        elif leaf.dtype == torch.float32 and leaf.dim() == 3:
            leaf.uniform_(0.01, 0.03)        # int8 scales
        else:
            leaf.normal_()
    return cfg, hmm.params, hmm.cache


PAGED = dict(kv_mode="paged", kv_block_size=16, kv_blocks_per_replica=32,
             expert_mode="pooled")


@pytest.mark.parametrize("store", ["bf16", "int8"])
def test_paged_steps_run_with_no_host_sync(dev, store):
    """The paged decode step (the model's and the engine's greedy one) and
    a chunk step of a 2-layer qwen3-30b-a3b, bf16 pools or int8 pools with
    int8 expert pages, inputs already on the card: no call synchronises
    with the host, and each step launches one KV write per layer."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import _paged_decode_fn
    int8 = dict(kv_dtype="int8", expert_dtype="int8") if store == "int8" \
        else {}
    cfg, params, cache = _booted("qwen3-30b-a3b", dev, **PAGED, **int8)
    NB, bs, L = 32, 16, cfg.num_layers
    bt = torch.full((4, 8), NB, dtype=torch.int32)
    bt[0, :2], bt[1, :1], bt[2, :3], bt[3, :1] = (torch.tensor([5, 9]),
                                                 torch.tensor([2]),
                                                 torch.tensor([7, 1, 30]),
                                                 torch.tensor([31]))
    bt = bt.to(dev)
    lens = torch.tensor([20, 3, 40, 0], dtype=torch.int32, device=dev)
    wb = torch.tensor([9, 2, 30, NB], dtype=torch.int32, device=dev)
    active = torch.tensor([True, True, True, False], device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (4,), dtype=torch.int32,
                           device=dev)
    chunk = torch.randint(0, cfg.vocab_size, (1, 32), dtype=torch.int32,
                          device=dev)
    ids = torch.tensor([7, NB], dtype=torch.int32, device=dev)

    def steps():
        M.paged_decode_step(cfg, params, tokens[:, None], cache, lens, bt,
                            wb)
        _paged_decode_fn(cfg, params, cache, tokens, lens, active, bt)
        M.paged_chunk_prefill_step(cfg, params, chunk, cache, 0, 20, bt[2:3],
                                   ids)
    steps()                                  # builds and loads the kernels
    ops.reset_launch_counts()
    with _no_host_sync():
        steps()
    assert ops.launch_counts()["kv_cache_write"] == 3 * L


@pytest.mark.parametrize("store", ["bf16", "int8"])
def test_write_prefill_to_blocks_runs_with_no_host_sync(dev, store):
    from repro_torch.models import model as M
    int8 = dict(kv_dtype="int8", expert_dtype="int8") if store == "int8" \
        else {}
    cfg, _, cache = _booted("qwen3-30b-a3b", dev, **PAGED, **int8)
    L, KVH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    dense = {n: torch.randn(L, 1, 64, KVH, hd, device=dev)
             .to(torch.bfloat16) for n in ("k", "v")}
    ids = torch.tensor([4, 32, 31, 32], dtype=torch.int32, device=dev)
    M.write_prefill_to_blocks(cache, dense, ids)
    ops.reset_launch_counts()
    with _no_host_sync():
        M.write_prefill_to_blocks(cache, dense, ids)
    assert ops.launch_counts()["kv_cache_write"] == 1


@pytest.mark.parametrize("model", ["qwen3-30b-a3b", "deepseek-v2-lite-16b",
                                   "zamba2-2.7b"])
def test_slot_decode_step_runs_with_no_host_sync(dev, model):
    """``decode_step`` over the slot-contiguous cache (the default stores)
    of a 2-layer qwen3 (K/V), deepseek-v2-lite (MLA latent) and zamba2
    (the shared block's K/V per group), one slot full (its write drops):
    no host sync, one KV write per attention layer."""
    from repro_torch.models import model as M
    cfg, params, cache = _booted(model, dev)
    n_attn = len(next(iter(cache.values()))) if cfg.arch_type != "hybrid" \
        else cache["attn_k"].shape[0]
    tokens = torch.randint(0, cfg.vocab_size, (4, 1), dtype=torch.int32,
                           device=dev)
    lens = torch.tensor([5, 127, 128, 0], dtype=torch.int32, device=dev)
    M.decode_step(cfg, params, tokens, cache, lens)
    ops.reset_launch_counts()
    with _no_host_sync():
        M.decode_step(cfg, params, tokens, cache, lens)
    assert ops.launch_counts()["kv_cache_write"] == n_attn


# ----------------------------------------------- several logical devices

def _booted_dp(dev, ndev, tp=1, model=(), **knobs):
    """A reduced (2-layer) qwen3-30b-a3b in bf16 (its fields replaced by
    ``model``'s pairs) booted on ``ndev`` logical devices of the one card
    (DP = ndev / tp)."""
    from repro_torch.configs import get_config
    from repro_torch.core.hmm import HMM
    from repro_torch.core.topology import ElasticConfig
    from repro_torch.distributed.sharding import make_instance_mesh
    from repro_torch.serving.engine import engine_parallel_ctx
    cfg = dataclasses.replace(get_config("qwen3-30b-a3b-smoke"),
                              dtype="bfloat16", **dict(model))
    ecfg = ElasticConfig(ndev // tp, tp, tuple(range(ndev)))
    hmm = HMM(cfg, tp, batch_per_replica=2, max_len=128, seed=0,
              all_devices=[dev] * ndev, device=dev, **knobs)
    hmm.boot(ecfg)
    ctx = engine_parallel_ctx(make_instance_mesh(ecfg, hmm.all_devices))
    return cfg, hmm, ctx


@pytest.mark.parametrize("store", ["bf16", "int8"])
@pytest.mark.parametrize("ndev", [4, 6])
def test_moe_ep_matches_plain(dev, store, ndev):
    """``moe_ep`` over pooled pages split over 4 and 6 logical devices of
    the card (6: two devices own no expert, their table rows all pad),
    through the paged GMM kernels and through their plain versions; three
    GMM launches per device."""
    from repro_torch.models.model import layer_params
    from repro_torch.models.moe import moe_ep
    int8 = dict(kv_dtype="int8", expert_dtype="int8") if store == "int8" \
        else {}
    cfg, hmm, ctx = _booted_dp(dev, ndev, **PAGED, **int8)
    p = layer_params(hmm.params["blocks"]["moe"], 0)
    pool = hmm.params["moe_pool"]
    gen = torch.Generator().manual_seed(0)
    x = _rand(gen, (2 * ndev + 1, 3, cfg.d_model), torch.bfloat16, dev)
    ops.reset_launch_counts()
    got = moe_ep(cfg, p, x, ctx, pool=pool)
    gmm = "quant_paged_gmm" if int8 else "paged_gmm"
    assert ops.launch_counts()[gmm] == 3 * ndev
    with ops.use_reference():
        want = moe_ep(cfg, p, x, ctx, pool=pool)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("store", ["bf16", "int8", "dense"])
def test_multi_device_steps_run_with_no_host_sync(dev, store):
    """On 3 logical devices of the card: the paged decode step (the
    engine's), a chunk step and a prefill written into the pool of replica
    1, bf16 or int8 stores; or, with the default stores on 4 devices (the
    dense banks' 4 experts split evenly), the slot decode step and a
    prefill on replica 2.  No call synchronises with the host;
    a decode step writes KV once per layer per replica, a chunk step once
    per layer, the pool write of a prefill once."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import _paged_decode_fn
    knobs = {} if store == "dense" else dict(PAGED)
    if store == "int8":
        knobs.update(kv_dtype="int8", expert_dtype="int8")
    ndev = 4 if store == "dense" else 3
    cfg, hmm, ctx = _booted_dp(dev, ndev, **knobs)
    params, cache, L = hmm.params, hmm.cache, cfg.num_layers
    tokens = torch.randint(0, cfg.vocab_size, (2 * ndev,), dtype=torch.int32,
                           device=dev)
    lens = torch.tensor([20, 3, 40, 0, 7, 127, 64, 1][:2 * ndev],
                        dtype=torch.int32, device=dev)
    active = torch.tensor([True] * 5 + [False], device=dev)
    chunk = torch.randint(0, cfg.vocab_size, (1, 32), dtype=torch.int32,
                          device=dev)
    if store == "dense":
        def steps():
            M.decode_step(cfg, params, tokens[:, None], cache, lens,
                          parallel=ctx)
            M.prefill(cfg, params, {"tokens": chunk, "lengths": lens[1:2]},
                      128, parallel=ctx, replica=2)
        writes = ndev * L
    else:
        NB = 32                                # one replica's pool slice
        bt = torch.full((6, 8), NB, dtype=torch.int32)
        for i, row in enumerate([[5, 9], [2], [7, 1, 30], [31], [4], []]):
            bt[i, :len(row)] = torch.tensor(row, dtype=torch.int32)
        bt = bt.to(dev)
        ids = torch.tensor([7, NB], dtype=torch.int32, device=dev)

        def steps():
            _paged_decode_fn(cfg, params, cache, tokens, lens, active, bt,
                             parallel=ctx)
            M.paged_chunk_prefill_step(cfg, params, chunk, cache, 0, 20,
                                       bt[2:3], ids, parallel=ctx, replica=1)
            _, small = M.prefill(cfg, params, {"tokens": chunk}, 32,
                                 parallel=ctx, replica=1)
            M.write_prefill_to_blocks(cache, small, ids, parallel=ctx,
                                      replica=1)
        writes = 3 * L + L + 1
    steps()                                  # builds and loads the kernels
    ops.reset_launch_counts()
    with _no_host_sync():
        steps()
    assert ops.launch_counts()["kv_cache_write"] == writes


# ------------------------------------------------- a TP rank's head range

# (query heads of the rank, its kv heads, the pool's kv heads, offset):
# qwen3-30b-a3b's (16, 2) at tp = 2, (8, 1) at tp = 4 and (4, 1) at tp = 8
# (half a kv head a rank: its 4 query heads read one kv head) over its 4
HEAD_RANGES = [(16, 2, 4, 0), (16, 2, 4, 2), (8, 1, 4, 0), (8, 1, 4, 3),
               (4, 1, 4, 1), (4, 1, 4, 3)]


def _offset_pools(gen, shape, store, dev):
    """K and V rows of ``shape`` (int8 with scales, or bf16 / f32) -> (k,
    k_scale, v, v_scale); the scales None unless int8."""
    if store == "int8":
        k, ks = _int8(gen, shape, dev)
        v, vs = _int8(gen, shape, dev)
        return k, ks, v, vs
    dtype = getattr(torch, store)
    return (_rand(gen, shape, dtype, dev), None, _rand(gen, shape, dtype, dev),
            None)


@pytest.mark.parametrize("store", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("heads", HEAD_RANGES,
                         ids=[f"H{h}-kv{n}of{p}-off{o}"
                              for h, n, p, o in HEAD_RANGES])
def test_head_offset_kernels_match_plain_and_a_sliced_pool(dev, heads,
                                                           store):
    """The two paged decodes, the slot decode and the two mixed attentions
    at a rank's kv heads ``[off, off + n)`` of a pool of 4 heads: within
    the tolerance of the plain version with the same offset, and bit for
    bit the kernel on those heads copied out into a pool of their own
    (the same blocks, the same sums)."""
    H, n, KVH, off = heads
    hd, bs, NB = 128, 16, 48
    qdt = torch.float32 if store == "float32" else torch.bfloat16
    gen = torch.Generator().manual_seed(off + 10 * n)
    lengths = [1, 130, 300, 17]
    MB = -(-max(lengths) // bs) + 1
    k, ks, v, vs = _offset_pools(gen, (NB, bs, KVH, hd), store, dev)
    sl = [t[:, :, off:off + n].contiguous() for t in (k, v)]
    scales = (ks, vs)
    bt = _tables(gen, lengths, NB, MB, bs).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = _rand(gen, (len(lengths), H, hd), qdt, dev, 3.0)
    qm = _rand(gen, (1, 40, H, hd), qdt, dev, 3.0)
    c = torch.tensor([300], dtype=torch.int32, device=dev)
    ql = torch.tensor([33], dtype=torch.int32, device=dev)
    rng = dict(kv_head_offset=off, kv_heads=n)
    if store == "int8":
        dec, mix = (paged_attention.quant_block_paged_decode_attention,
                    paged_attention.quant_mixed_block_paged_attention)
        pdec, pmix = (ref.quant_block_paged_decode_attention_ref,
                      ref.quant_mixed_block_paged_attention_ref)

        def kv(pair):
            return pair[0], scales[0], pair[1], scales[1]
    else:
        dec, mix = (paged_attention.block_paged_decode_attention,
                    paged_attention.mixed_block_paged_attention)
        pdec, pmix = (ref.block_paged_decode_attention_ref,
                      ref.mixed_block_paged_attention_ref)

        def kv(pair):
            return pair
    calls = [(dec, pdec, (q,), (bt, lens)), (mix, pmix, (qm,), (bt[2:3], c,
                                                                 ql))]
    if store != "int8":
        S_max = 320
        kc, _, vc, _ = _offset_pools(gen, (len(lengths), S_max, KVH, hd),
                                     store, dev)
        calls.append((paged_attention.paged_decode_attention,
                      ref.paged_decode_attention_ref, (q,), (lens,),
                      (kc, vc)))
    for call in calls:
        fn, plain, head, tail = call[:4]
        pools = call[4] if len(call) > 4 else kv((k, v))
        cut = (tuple(t[:, :, off:off + n].contiguous() for t in call[4])
               if len(call) > 4 else kv(tuple(sl)))
        got = fn(*head, *pools, *tail, **rng)
        torch.testing.assert_close(
            got.float(), plain(*head, *pools, *tail, **rng).float(),
            **TOL[qdt])
        assert torch.equal(got, fn(*head, *cut, *tail)), fn.__name__


def test_head_offset_wrappers_refuse_a_range_past_the_pool(dev):
    q = torch.zeros(2, 8, 128, dtype=torch.bfloat16, device=dev)
    k = torch.zeros(4, 16, 4, 128, dtype=torch.bfloat16, device=dev)
    bt = torch.zeros(2, 1, dtype=torch.int32, device=dev)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    for off, n in ((3, 2), (-1, 1), (0, 3)):     # past, negative, 8 % 3
        with pytest.raises(ValueError):
            paged_attention.block_paged_decode_attention(
                q, k, k, bt, lens, kv_head_offset=off, kv_heads=n)
        with pytest.raises(ValueError):
            paged_attention.paged_decode_attention(
                q, k[:2], k[:2], lens, kv_head_offset=off, kv_heads=n)


@pytest.mark.parametrize("store", ["bf16", "int8", "dense"])
def test_tp_steps_run_with_no_host_sync(dev, store):
    """DP2 x TP2 on 4 logical devices of the card (the reduced qwen3's 4
    query and 4 kv heads, 2 a rank): the engine's paged decode step, a
    chunk step and a prefill written into replica 1's pool, bf16 or int8
    stores; or, the default stores, the slot decode step and a prefill.
    No call synchronises with the host; every rank writes its own copy of
    the cache (a decode step L * dp * tp KV writes, a chunk L * tp, a
    pool prefill tp), the copies stay equal, and the logits agree with
    the plain versions'."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import _paged_decode_fn
    knobs = {} if store == "dense" else dict(PAGED)
    if store == "int8":
        knobs.update(kv_dtype="int8", expert_dtype="int8")
    cfg, hmm, ctx = _booted_dp(dev, 4, tp=2, **knobs)
    params, cache, L = hmm.params, hmm.cache, cfg.num_layers
    tokens = torch.randint(0, cfg.vocab_size, (4,), dtype=torch.int32,
                           device=dev)
    lens = torch.tensor([20, 3, 40, 7], dtype=torch.int32, device=dev)
    active = torch.tensor([True, True, True, False], device=dev)
    chunk = torch.randint(0, cfg.vocab_size, (1, 32), dtype=torch.int32,
                          device=dev)
    if store == "dense":
        def steps():
            a, _ = M.decode_step(cfg, params, tokens[:, None], cache, lens,
                                 parallel=ctx)
            b, _ = M.prefill(cfg, params, {"tokens": chunk,
                                           "lengths": lens[1:2]},
                             128, parallel=ctx, replica=1)
            return torch.cat([a, b]).float()
        writes = 2 * 2 * L
    else:
        NB = 32
        bt = torch.full((4, 8), NB, dtype=torch.int32)
        for i, row in enumerate([[5, 9], [2], [7, 1, 30], [31]]):
            bt[i, :len(row)] = torch.tensor(row, dtype=torch.int32)
        bt = bt.to(dev)
        ids = torch.tensor([7, NB], dtype=torch.int32, device=dev)

        def steps():
            nxt, _ = _paged_decode_fn(cfg, params, cache, tokens, lens,
                                      active, bt, parallel=ctx)
            a, _ = M.paged_chunk_prefill_step(cfg, params, chunk, cache, 0,
                                              20, bt[2:3], ids, parallel=ctx,
                                              replica=1)
            b, small = M.prefill(cfg, params, {"tokens": chunk}, 32,
                                 parallel=ctx, replica=1)
            M.write_prefill_to_blocks(cache, small, ids, parallel=ctx,
                                      replica=1)
            return torch.cat([a, b]).float()
        writes = 2 * 2 * L + 2 * L + 2
    steps()                                  # builds and loads the kernels
    snapshot = {n: {d: t.clone() for d, t in leaf.shards.items()}
                for n, leaf in cache.items()}
    ops.reset_launch_counts()
    with _no_host_sync():
        got = steps()
    assert ops.launch_counts()["kv_cache_write"] == writes
    for leaf in cache.values():
        for r in (0, 1):
            assert torch.equal(leaf.shard(2 * r), leaf.shard(2 * r + 1))
    for n, leaf in cache.items():                 # the same steps, plain
        for d, t in leaf.shards.items():
            t.copy_(snapshot[n][d])
    with ops.use_reference():
        want = steps()
    # chip_smoke.py's e2e rule for bf16: a one-ulp difference may flip a
    # near-tied expert choice
    assert ((got - want).norm() / want.norm()).item() < 0.25


# qwen3-30b-a3b's attention at full width (32 query heads, 4 kv heads of
# 128) in the reduced model: at tp = 8 a rank holds half a kv head
QWEN3_HEADS = (("num_heads", 32), ("num_kv_heads", 4), ("head_dim", 128))


@pytest.mark.parametrize("store", ["bf16", "int8"])
def test_tp8_cut_head_steps_graphed_equal_eager_with_no_host_sync(dev,
                                                                  store):
    """DP1 x TP8 on 8 logical devices of the card, qwen3-30b-a3b's heads
    (each rank 64 of a kv head's 128 columns): the paged decode step and a
    chunk step run with no host sync and write every rank's copy of the
    cache (L * tp KV writes each), the copies stay equal, each step
    captured with ``core.graphs.capture`` replays the eager step's logits
    bit for bit, and the logits agree with the plain versions'."""
    from repro_torch.core.graphs import capture
    from repro_torch.models import model as M
    knobs = dict(PAGED)
    if store == "int8":
        knobs.update(kv_dtype="int8", expert_dtype="int8")
    cfg, hmm, ctx = _booted_dp(dev, 8, tp=8, model=QWEN3_HEADS, **knobs)
    params, cache, L = hmm.params, hmm.cache, cfg.num_layers
    for leaf in cache.values():                 # the same earlier contents
        first = leaf.shard(0)                   # in every rank's copy
        if first.dtype == torch.int8:
            first.random_(-127, 128)
        elif first.dtype == torch.float32 and first.dim() == 3:
            first.uniform_(0.01, 0.03)
        else:
            first.normal_()
        for d in range(1, 8):
            leaf.shard(d).copy_(first)
    NB = 32
    bt = torch.full((2, 8), NB, dtype=torch.int32)
    bt[0, :2], bt[1, :3] = torch.tensor([5, 9]), torch.tensor([7, 1, 30])
    bt = bt.to(dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 1), dtype=torch.int32,
                           device=dev)
    lens = torch.tensor([20, 40], dtype=torch.int32, device=dev)
    wb = torch.tensor([9, 30], dtype=torch.int32, device=dev)
    chunk = torch.randint(0, cfg.vocab_size, (1, 32), dtype=torch.int32,
                          device=dev)
    ids = torch.tensor([7, NB], dtype=torch.int32, device=dev)
    start = torch.tensor([0], dtype=torch.int32, device=dev)
    length = torch.tensor([20], dtype=torch.int32, device=dev)
    steps = {
        "decode": lambda: M.paged_decode_step(
            cfg, params, tokens, cache, lens, bt, wb, parallel=ctx)[0],
        "chunk": lambda: M.paged_chunk_prefill_step(
            cfg, params, chunk, cache, start, length, bt[1:2], ids,
            parallel=ctx)[0]}
    stream, pool = torch.cuda.Stream(), torch.cuda.graph_pool_handle()
    for name, fn in steps.items():
        fn()                                 # builds and loads the kernels
        snapshot = {n: {d: t.clone() for d, t in leaf.shards.items()}
                    for n, leaf in cache.items()}
        ops.reset_launch_counts()
        with _no_host_sync():
            want = fn().clone()
        assert ops.launch_counts()["kv_cache_write"] == L * 8, name
        for leaf in cache.values():
            for d in range(1, 8):
                assert torch.equal(leaf.shard(d), leaf.shard(0)), name
        g = capture(fn, stream, pool)
        for _ in range(2):
            got = g.replay().clone()
            assert torch.equal(got, want), (name, (got - want).abs().max())
        for n, leaf in cache.items():
            for d, t in leaf.shards.items():
                t.copy_(snapshot[n][d])
        with ops.use_reference():
            plain = fn().float()
        # chip_smoke.py's e2e rule for bf16
        assert ((want.float() - plain).norm() / plain.norm()).item() < 0.25


# ------------------------------------------------ scaling while serving

def _scale_hmm(dev, staging, store="bf16"):
    """A reduced (2-layer) qwen3-30b-a3b in bf16 with pooled pages booted
    on DP4 of 6 logical devices of the card, ``staging`` serial or
    overlap."""
    from repro_torch.configs import get_config
    from repro_torch.core.hmm import HMM
    from repro_torch.core.topology import ElasticConfig
    cfg = dataclasses.replace(get_config("qwen3-30b-a3b-smoke"),
                              dtype="bfloat16")
    int8 = dict(kv_dtype="int8", expert_dtype="int8") if store == "int8" \
        else {}
    hmm = HMM(cfg, 1, batch_per_replica=2, max_len=128, seed=0,
              all_devices=[dev] * 6, device=dev, staging=staging,
              transfer_workers=2, **PAGED, **int8)
    hmm.boot(ElasticConfig(4, 1, (0, 1, 2, 3)))
    return cfg, hmm


@pytest.mark.parametrize("store", ["bf16", "int8"])
def test_overlapped_staging_beside_strict_steps(dev, store):
    """DP4 -> DP6 staged on the TransferEngine's side streams (each unit
    slowed, so the ops are in flight) while the engine's paged decode step
    runs again and again under ``set_sync_debug_mode("error")`` on the
    default stream: no step and no op synchronises with the host (the mode
    is global, so the workers run under it too), and every staged shard
    equals a serial staging's bit for bit, with the same bytes."""
    import time
    from repro_torch.core.hmm import TransferStats
    from repro_torch.core.topology import ElasticConfig
    from repro_torch.distributed.sharding import (make_instance_mesh,
                                                  tree_leaves_with_path)
    from repro_torch.serving.engine import (_paged_decode_fn,
                                            engine_parallel_ctx)
    c6 = ElasticConfig(6, 1, tuple(range(6)))
    _, serial = _scale_hmm(dev, "serial", store)
    st_serial = serial.scale(c6)
    want = {p: leaf for p, leaf in
            tree_leaves_with_path(serial.attach_staged()[2])}
    cfg, hmm = _scale_hmm(dev, "overlap", store)
    ctx = engine_parallel_ctx(make_instance_mesh(hmm.active_cfg,
                                                 hmm.all_devices))
    NB = 32
    bt = torch.full((8, 8), NB, dtype=torch.int32)
    for i, row in enumerate([[5, 9], [2], [7, 1, 30], [31], [4], [], [3],
                             [8]]):
        bt[i, :len(row)] = torch.tensor(row, dtype=torch.int32)
    bt = bt.to(dev)
    tokens = torch.randint(0, cfg.vocab_size, (8,), dtype=torch.int32,
                           device=dev)
    lens = torch.tensor([20, 3, 40, 7, 1, 0, 9, 12], dtype=torch.int32,
                        device=dev)
    active = torch.tensor([True] * 5 + [False] + [True] * 2, device=dev)

    def step():
        _paged_decode_fn(cfg, hmm.params, hmm.cache, tokens, lens, active,
                         bt, parallel=ctx)
    step()                                   # builds and loads the kernels
    unit = hmm._stage_unit

    def slow(*a, **k):
        time.sleep(0.005)
        return unit(*a, **k)
    hmm._stage_unit = slow
    steps = 0
    with _no_host_sync():
        hmm.begin_scale(c6)
        while hmm.staging_in_flight:
            step()
            steps += 1
    assert steps > 0
    assert hmm.poll_staging() and not hmm.staging_in_flight
    st = hmm.last_stats
    for f in TransferStats.BYTE_FIELDS:
        assert getattr(st, f) == getattr(st_serial, f), f
    got = dict(tree_leaves_with_path(hmm.attach_staged()[2]))
    assert got.keys() == want.keys()
    for p, leaf in got.items():
        for d, t in leaf.shards.items():
            assert torch.equal(t, want[p].shard(d)), (p, d)
    hmm.commit()
    hmm.close()


@pytest.mark.parametrize("store", ["bf16", "int8"])
def test_copy_block_between_replicas_on_a_side_stream(dev, store):
    """At DP3 x TP2, a block of replica 2 copied into a block of replica 0
    by a TransferOp on a worker's side stream (after the default stream's
    ready event): both of replica 0's TP copies take the source rows, and
    an int8 pool's scale rows, bit for bit; nothing else changes."""
    from repro_torch.configs import get_config
    from repro_torch.core.elastic_engine import ElasticServer
    from repro_torch.core.topology import ElasticConfig
    from repro_torch.core.transfer import (TransferEngine, TransferOp,
                                           cuda_devices, ready_events)
    cfg = dataclasses.replace(get_config("qwen3-30b-a3b-smoke"),
                              dtype="bfloat16")
    int8 = dict(kv_dtype="int8", expert_dtype="int8") if store == "int8" \
        else {}
    srv = ElasticServer(cfg, tp=2, batch_per_replica=2, max_len=128,
                        seed=0, all_devices=[dev] * 6, device=dev,
                        **PAGED, **int8)
    srv.boot(ElasticConfig(3, 2, tuple(range(6))))
    eng = srv.engine
    for leaf in eng.cache.values():
        for r in range(3):
            devs = eng.parallel.replica_devices(r)
            rows = leaf.shard(devs[0])
            if rows.dtype == torch.int8:
                rows.random_(-127, 128)
            else:
                rows.normal_()
            for d in devs[1:]:
                leaf.shard(d).copy_(rows)
    before = {n: leaf.gather(dev) for n, leaf in eng.cache.items()}
    bpp = eng.kv.blocks_per_partition
    src, dst = 2 * bpp + 3, 1
    pool = TransferEngine(1)
    devs = cuda_devices([dev])
    sess = pool.submit([TransferOp(0, "kvmig", lambda: eng.copy_block(src,
                                                                      dst),
                                   devices=devs)], after=ready_events(devs))
    assert sess.join(timeout=60) and not sess.failed_ops()
    pool.shutdown()
    assert len(eng.cache) == (4 if int8 else 2)
    for n, leaf in eng.cache.items():
        want = before[n].clone()
        want[:, dst] = before[n][:, src]
        for r in range(3):
            for d in eng.parallel.replica_devices(r):
                assert torch.equal(leaf.shard(d),
                                   want[:, r * bpp:(r + 1) * bpp]), (n, d)


def test_a_session_finishes_when_its_copies_have_landed(dev):
    """A large copy's op returns from ``fn`` as soon as the copies are
    enqueued; the op waits for its side stream's event (under sync-debug
    "error", which neither ``Event.synchronize`` nor ``Event.query``
    trips), so its ``seconds`` cover the copies' event-timed duration and
    the session counts as finished only once they completed."""
    from repro_torch.core.transfer import (TransferEngine, TransferOp,
                                           cuda_devices)
    src = torch.randn(256 << 20, device=dev)         # 1 GiB
    dst = torch.empty_like(src)
    marks = {}

    def copies():
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(8):
            dst.copy_(src)
        e.record()
        marks.update(start=s, end=e)
        return e.query()                 # enqueued, not landed

    pool = TransferEngine(1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sess = pool.submit([TransferOp(0, "big", copies,
                                       devices=cuda_devices([dev]))])
        assert sess.join(timeout=60)
        (op,) = sess.ops
        assert op.state == "done", op.error
        assert marks["end"].query()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        pool.shutdown()
    assert op.result is False            # fn returned before the copies
    copy_s = marks["start"].elapsed_time(marks["end"]) / 1e3
    assert op.seconds >= copy_s, (op.seconds, copy_s)
    assert torch.equal(dst, src)


# ------------------------------------------------------------ CUDA graphs

def _graph_model(name):
    """The served model of a graph test in bf16: ``TEST_MOE``'s widths (2
    layers, 24 experts top-2, 4 heads of 16; the chunked paged path), or
    a reduced model (2 layers; the monolithic prefill's flash attention
    takes head widths of 64 and more, so the reduced MLA model keeps
    deepseek-v2-lite's head and latent widths)."""
    from repro_torch.configs import ModelConfig, get_config
    if name == "test-moe":
        return ModelConfig(name="test-moe", arch_type="moe", num_layers=2,
                           d_model=64, vocab_size=128, num_heads=4,
                           num_kv_heads=4, head_dim=16, d_ff=128,
                           num_experts=24, top_k=2, moe_d_ff=32,
                           dtype="bfloat16", capacity_factor=100.0)
    cfg = dataclasses.replace(get_config(name + "-smoke"), dtype="bfloat16")
    if cfg.use_mla:
        cfg = dataclasses.replace(cfg, kv_lora_rank=512, qk_nope_dim=128,
                                  qk_rope_dim=64, v_head_dim=128)
    return cfg


GRAPH_PAGED = dict(kv_mode="paged", kv_block_size=16, expert_mode="pooled",
                   prefill_chunk=32, prefill_budget=64, prefill_buckets=(32,))
# store: (model, tp, logical devices, boot dp, server knobs)
GRAPH_SERVERS = {
    "paged_bf16": ("test-moe", 1, 1, 1, GRAPH_PAGED),
    "paged_int8": ("test-moe", 1, 1, 1, dict(GRAPH_PAGED, kv_dtype="int8",
                                             expert_dtype="int8")),
    "dense": ("qwen3-30b-a3b", 1, 1, 1, dict(prefill_buckets=(32, 64))),
    "mla": ("deepseek-v2-lite-16b", 1, 1, 1,
            dict(prefill_buckets=(32, 64))),
    "mamba2": ("mamba2-1.3b", 1, 1, 1, dict(prefill_buckets=(32, 64))),
    "dp2_tp2": ("test-moe", 2, 6, 2, GRAPH_PAGED),
}
GRAPH_REQS = [(n, out) for n, out in zip([10, 37, 16, 23, 30, 45],
                                         [20, 12, 24, 9, 15, 18])]


def _graph_server(dev, store, graphs, **kw):
    from repro_torch.core.elastic_engine import ElasticServer
    from repro_torch.core.topology import ElasticConfig
    model, tp, ndev, dp, knobs = GRAPH_SERVERS[store]
    srv = ElasticServer(_graph_model(model), tp=tp, batch_per_replica=2,
                        max_len=128, seed=0, all_devices=[dev] * ndev,
                        device=dev, cuda_graphs=graphs, **knobs, **kw)
    srv.boot(ElasticConfig(dp, tp, tuple(range(dp * tp))))
    return srv


def _graph_requests(vocab):
    from repro_torch.serving.workload import Request
    gen = torch.Generator().manual_seed(0)
    return [Request(i, 0.0, n, out,
                    prompt=torch.randint(0, vocab, (n,), generator=gen)
                    .numpy().astype("int32"))
            for i, (n, out) in enumerate(GRAPH_REQS)]


def _drive(srv, scale=None):
    """Serve ``GRAPH_REQS`` to the end; ``scale(srv, tick)`` runs before
    every tick and returns True while it has work left, which the ticks
    then go on for.  Returns each request's tokens."""
    reqs = _graph_requests(srv.mcfg.vocab_size)
    for r in reqs:
        srv.submit(r)
    n, busy = 0, scale is not None
    while busy or any(r.finish_s is None for r in reqs):
        busy = scale is not None and scale(srv, n)
        srv.tick(n * .1)
        n += 1
        assert n < 1000
    return {r.rid: srv.engine.generated[r.rid] for r in reqs}


@pytest.mark.parametrize("store", sorted(GRAPH_SERVERS))
def test_graphed_server_tokens_equal_eager(dev, store):
    """The same requests on a server with the CUDA graphs (the default)
    and on its eager twin (``cuda_graphs=False``): the greedy tokens are
    equal; the graphed one replays its graphs (the engine holds them) and
    launched every kernel the eager one did, as many times."""
    counts, tokens = {}, {}
    for graphs in (False, True):
        srv = _graph_server(dev, store, graphs)
        assert (srv.engine.graphs is not None) == graphs
        ops.reset_launch_counts()
        tokens[graphs] = _drive(srv)
        counts[graphs] = ops.launch_counts()
        srv.hmm.close()
    assert tokens[True] == tokens[False]
    assert counts[True] == counts[False]


@pytest.mark.parametrize("model", ["deepseek-v2-lite-16b", "zamba2-2.7b"])
def test_dp2_tp2_dense_layout_graphs_equal_eager(dev, model):
    """deepseek-v2-lite (the MLA latent cache, pooled pages of 12
    experts) and zamba2 (SSD layers replicated over a replica's ranks,
    the shared block split) on DP2 x TP2 logical devices of the card: the
    engine's decode step over the bound tensors runs with no host sync and
    writes once per attention layer, rank and replica; the decode graph's
    replay gives the eager step's tokens on the same inputs and state; the
    graphed server's tokens through a scale to DP3 x TP2 and a drain back
    equal its eager twin's, with the same launch counts, and every rank's
    copy of the cache is rank 0's after every tick."""
    from repro_torch.core.elastic_engine import ElasticServer
    from repro_torch.core.topology import ElasticConfig
    from repro_torch.serving.driver import ScalePhase
    from test_torch_scale_mla import assert_copies_equal
    cfg = _graph_model(model)
    knobs = dict(prefill_buckets=(32, 64))
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, num_experts=12)
        knobs["expert_mode"] = "pooled"
    c4 = ElasticConfig(2, 2, (0, 1, 2, 3))
    c6 = ElasticConfig(3, 2, tuple(range(6)))
    n_attn = (cfg.num_layers if cfg.use_mla
              else cfg.num_layers // cfg.attn_every)

    tokens, counts = {}, {}
    for graphs in (False, True):
        srv = ElasticServer(cfg, tp=2, batch_per_replica=2, max_len=128,
                            seed=0, all_devices=[dev] * 6, device=dev,
                            cuda_graphs=graphs, **knobs)
        srv.boot(c4)
        eng = srv.engine
        if graphs:
            gen = torch.Generator().manual_seed(1)
            host = [torch.randint(0, cfg.vocab_size, (4,), generator=gen,
                                  dtype=torch.int32),
                    torch.tensor([5, 60, 0, 17], dtype=torch.int32),
                    torch.ones(4, dtype=torch.bool)]
            args = [t.to(dev) for t in host]
            state = {n: {d: t.clone() for d, t in leaf.shards.items()}
                     for n, leaf in eng.cache.items()}
            ops.reset_launch_counts()
            with _no_host_sync():
                want = eng.compiled["decode"](eng.params, eng.cache,
                                              *args)[0]
            assert ops.launch_counts()["kv_cache_write"] == n_attn * 2 * 2
            for n, leaf in eng.cache.items():       # the same state again
                for d, t in leaf.shards.items():
                    t.copy_(state[n][d])
            got = eng.graphs.decode(*[t.numpy() for t in host])
            assert torch.equal(got.cpu(), want.cpu())
            assert_copies_equal(eng.cache, eng.parallel)
        reqs = _graph_requests(cfg.vocab_size)
        for r in reqs:
            srv.submit(r)
        ops.reset_launch_counts()
        n, task = 0, None
        while any(r.finish_s is None for r in reqs) or (
                task is not None and not task.done):
            if n == 3:
                srv.stage_scale(c6)
            elif n == 5:
                srv.switchover()
            elif n == 8:
                task = srv.start_scale(c4)
                while task.phase in (ScalePhase.STAGING,
                                     ScalePhase.COMPILING):
                    task.advance(n * .1)
            srv.tick(n * .1)
            n += 1
            if task is not None and not task.done:
                task.advance(n * .1)
            assert_copies_equal(eng.cache, eng.parallel)
            assert n < 1000
        assert task.phase is ScalePhase.DONE and task.migrated_blocks == 0
        assert srv.hmm.active_cfg == c4
        assert (eng.graphs is not None) == graphs
        tokens[graphs] = {r.rid: eng.generated[r.rid] for r in reqs}
        counts[graphs] = ops.launch_counts()
        srv.hmm.close()
    assert tokens[True] == tokens[False]
    assert counts[True] == counts[False]


def _step_inputs(dev, cfg, NB):
    gen = torch.Generator().manual_seed(3)
    bt = torch.full((4, 8), NB, dtype=torch.int32)
    bt[0, :2], bt[1, :1], bt[2, :3] = (torch.tensor([5, 9]),
                                       torch.tensor([2]),
                                       torch.tensor([7, 1, 30]))
    return dict(
        tokens=torch.randint(0, cfg.vocab_size, (4,), generator=gen,
                             dtype=torch.int32).to(dev),
        lens=torch.tensor([20, 3, 40, 0], dtype=torch.int32, device=dev),
        wb=torch.tensor([9, 2, 30, NB], dtype=torch.int32, device=dev),
        bt=bt.to(dev),
        chunk=torch.randint(0, cfg.vocab_size, (1, 32), generator=gen,
                            dtype=torch.int32).to(dev),
        ids=torch.tensor([7, NB], dtype=torch.int32, device=dev),
        start=torch.tensor([0], dtype=torch.int32, device=dev),
        length=torch.tensor([20], dtype=torch.int32, device=dev))


@pytest.mark.parametrize("store", ["bf16", "int8"])
def test_graphed_steps_give_the_eager_logits_bit_for_bit(dev, store):
    """A 2-layer qwen3-30b-a3b's paged decode step and chunk step captured
    with ``core.graphs.capture`` (its thread-local mode, a side stream, a
    pool): each replay's logits equal the eager step's on the same inputs
    and cache bit for bit (the same kernels on the same bytes; both write
    the same rows), and a replay counts the launches its capture
    tallied."""
    from repro_torch.core.graphs import capture
    from repro_torch.models import model as M
    int8 = dict(kv_dtype="int8", expert_dtype="int8") if store == "int8" \
        else {}
    cfg, params, cache = _booted("qwen3-30b-a3b", dev, **PAGED, **int8)
    x = _step_inputs(dev, cfg, 32)
    steps = {
        "decode": lambda: M.paged_decode_step(
            cfg, params, x["tokens"][:, None], cache, x["lens"], x["bt"],
            x["wb"])[0],
        "chunk": lambda: M.paged_chunk_prefill_step(
            cfg, params, x["chunk"], cache, x["start"], x["length"],
            x["bt"][2:3], x["ids"])[0]}
    stream, pool = torch.cuda.Stream(), torch.cuda.graph_pool_handle()
    for name, fn in steps.items():
        want = fn().clone()
        ops.reset_launch_counts()
        g = capture(fn, stream, pool)
        assert sum(ops.launch_counts().values()) == 0     # nothing ran
        for _ in range(2):
            got = g.replay().clone()
            assert torch.equal(got, want), (name, (got - want).abs().max())
        assert ops.launch_counts()["kv_cache_write"] == 2 * cfg.num_layers


def _scale_schedule(targets):
    """From tick 3 on, every 3 ticks: ``stage_scale`` to the next of
    ``targets``, then ``switchover`` once the doomed slots of a
    scale-down have drained (staging stops their admission)."""
    from repro_torch.core.topology import ElasticConfig
    todo, state = list(targets), {"last": 0}

    def scale(srv, n):
        if srv._staged_cfg is not None:
            keep = srv._staged_cfg.dp * srv.engine.batch_per_replica
            if srv.engine.drained(keep):
                srv.switchover()
                state["last"] = n
        elif todo and n - state["last"] >= 3:
            dp = todo.pop(0)
            srv.stage_scale(ElasticConfig(dp, 1, tuple(range(dp))))
        return bool(todo) or srv._staged_cfg is not None
    return scale


def test_scale_up_down_up_captures_afresh(dev):
    """DP2 -> DP3 -> DP2 -> DP3 while serving: every target's graphs are
    captured during its staging over its staged tensors and bound at the
    switchover (a hit); the second DP3 set is a fresh capture (the first's
    tensors were freed at the scale-down, so its record refuses the new
    ones); the tokens equal the eager twin's on the same schedule."""
    tokens = {}
    for graphs in (False, True):
        srv = _dp_server(dev, graphs)
        tokens[graphs] = _drive(srv, _scale_schedule([3, 2, 3]))
        assert [e.dst.split("-")[0] for e in srv.events] == \
            ["DP3", "DP2", "DP3"]
        assert all(e.compile_hit for e in srv.events)
        st = srv.imm.stats
        assert (st["captures"], st["preinit_misses"]) == (4, 1)
        assert (srv.engine.graphs is not None) == graphs
        srv.hmm.close()
    assert tokens[True] == tokens[False]


def _dp_server(dev, graphs, **kw):
    from repro_torch.core.elastic_engine import ElasticServer
    from repro_torch.core.topology import ElasticConfig
    srv = ElasticServer(_graph_model("test-moe"), tp=1, batch_per_replica=2,
                        max_len=128, seed=0, all_devices=[dev] * 4,
                        device=dev, cuda_graphs=graphs, **GRAPH_PAGED, **kw)
    srv.boot(ElasticConfig(2, 1, (0, 1)))
    return srv


def test_capture_beside_an_overlapped_staging(dev):
    """DP2 -> DP3 with ``staging="overlap"``, each unit slowed: the polls
    capture the target's graphs on the serving thread, one a poll with
    ticks between them, while the workers copy on their side streams and
    wait on their events (capture in thread-local mode); the switchover
    binds them, and the tokens equal the eager twin's."""
    import time
    from repro_torch.core.topology import ElasticConfig
    from repro_torch.serving.driver import ScalePhase
    tokens = {}
    for graphs in (False, True):
        srv = _dp_server(dev, graphs, staging="overlap", transfer_workers=2)
        unit = srv.hmm._stage_unit

        def slow(*a, **k):
            time.sleep(0.02)
            return unit(*a, **k)
        srv.hmm._stage_unit = slow
        seen = {}

        def scale(srv, n, seen=seen):
            task = seen.get("task")
            if n == 3:
                seen["task"] = srv.start_scale(ElasticConfig(3, 1,
                                                             (0, 1, 2)))
            elif task is not None and not task.done:
                before = srv.imm.stats["captures"]
                in_flight = srv.hmm.staging_in_flight
                ready = srv.imm.ready(task.target)
                task.advance(n * .1)
                if srv.imm.stats["captures"] > before:
                    seen["captured_in_flight"] = in_flight \
                        and srv.hmm.staging_in_flight
                if not ready:
                    seen["capture_polls"] = seen.get("capture_polls", 0) + 1
        tokens[graphs] = _drive(srv, scale)
        task = seen["task"]
        while not task.done:
            task.advance(0.0)
        assert task.phase is ScalePhase.DONE and task.event.compile_hit
        if graphs:
            assert seen["captured_in_flight"]
            # the decode graph and three chunk graphs, one a poll
            assert seen["capture_polls"] == 4
            assert srv.engine.graphs is not None
        srv.hmm.close()
    assert tokens[True] == tokens[False]


def test_a_target_that_outgrows_the_split_buffers_replays_a_chunk_first(
        dev):
    """DP2 -> DP3 where the target's steps need more split counters and
    workspace than the capture stream holds: the stream's buffers are set
    aside first (kept alive, as the boot's graphs name them), the case of
    a target whose steps need more than any step captured before.  Its
    capture then grows them outside the capture, counters zeroed, and
    captures again over them; they are zero before any replay.  The first
    graph of the target that replays is a chunk step (the requests that
    wait are admitted into the new slots at the switchover), whose merge
    counts on those zeros.  The tokens equal the eager twin's."""
    from repro_torch.core.topology import ElasticConfig
    from repro_torch.kernels import _build
    tokens, order = {}, []
    for graphs in (False, True):
        srv = _dp_server(dev, graphs)

        def scale(srv, n, graphs=graphs):
            if n == 3:
                if graphs:
                    s = srv.imm._stream.cuda_stream
                    for table in (_build._counters, _build._workspaces):
                        for key in [k for k in table if k[1] == s]:
                            _build._retired.append(table.pop(key))
                srv.stage_scale(ElasticConfig(3, 1, (0, 1, 2)))
                if graphs:
                    torch.cuda.synchronize()
                    done = [c for (_, s), c in _build._counters.items()
                            if s == srv.imm._stream.cuda_stream]
                    assert len(done) == 1 and not done[0].any()
            elif n == 4:
                assert srv.queue            # they wait for the new slots
                srv.switchover()
                g = srv.engine.graphs
                for name in ("decode", "chunk") if graphs else ():
                    def logged(*a, _f=getattr(g, name), _n=name):
                        order.append(_n)
                        return _f(*a)
                    setattr(g, name, logged)
            return n < 4
        tokens[graphs] = _drive(srv, scale)
        assert srv.events[0].compile_hit
        srv.hmm.close()
    assert order[0] == "chunk"
    assert tokens[True] == tokens[False]


def test_closed_loop_on_the_card_equals_the_cpu_run(dev):
    """Case 1 of ``tests/test_torch_closed_loop.py`` (TEST_MOE at f32, tp
    = 2, DP2 -> DP3 -> DP2 under the driver) on ``cuda:0`` eight times:
    the driver's events and every request's timestamps equal the CPU
    run's (they depend on no weight: the driver's clock is virtual), and
    the graphed server's greedy tokens equal its eager twin's."""
    from test_torch_closed_loop import (events_without_wall,
                                        run_closed_loop, same_events)
    _, cpu_driver, cpu_reqs = run_closed_loop("case1")
    want_events = events_without_wall(cpu_driver)
    want_times = {r.rid: (r.first_token_s, r.finish_s, r.token_times)
                  for r in cpu_reqs}
    tokens = {}
    for graphs in (True, False):
        srv, driver, reqs = run_closed_loop(
            "case1", all_devices=[dev] * 8, device=dev, cuda_graphs=graphs)
        assert (srv.engine.graphs is not None) == graphs
        got = events_without_wall(driver)
        assert [e["direction"] for e in got] == ["up", "down"]
        assert same_events(got, want_events), (got, want_events)
        assert {r.rid: (r.first_token_s, r.finish_s, r.token_times)
                for r in reqs} == want_times
        tokens[graphs] = {r.rid: srv.engine.generated[r.rid] for r in reqs}
        assert all(len(tokens[graphs][r.rid]) == r.output_len for r in reqs)
        srv.hmm.close()
    assert tokens[True] == tokens[False]


# ------------------------------------------------- the skew rebalancer

def test_routed_decode_step_runs_with_no_host_sync(dev):
    """The engine's routed twin (``decode_routed``) on DP2 x TP2 logical
    devices of the card: no call synchronises with the host (the counts
    are added with ``index_add_``, not ``bincount``); it writes the KV once
    per layer and rank; its output is the plain step's tokens followed by
    the [L, E] counts of every slot's routed rows."""
    from repro_torch.serving.engine import _paged_decode_fn
    cfg, hmm, ctx = _booted_dp(dev, 4, tp=2, **PAGED)
    L, E, B, NB = cfg.num_layers, cfg.num_experts, 4, 32
    tokens = torch.randint(0, cfg.vocab_size, (B,), dtype=torch.int32,
                           device=dev)
    lens = torch.tensor([20, 3, 40, 0], dtype=torch.int32, device=dev)
    active = torch.tensor([True, True, False, True], device=dev)
    bt = torch.full((B, 8), NB, dtype=torch.int32)
    for i, row in enumerate([[5, 9], [2], [7, 1, 30], [31]]):
        bt[i, :len(row)] = torch.tensor(row, dtype=torch.int32)
    bt = bt.to(dev)

    def step(routed):
        return _paged_decode_fn(cfg, hmm.params, hmm.cache, tokens, lens,
                                active, bt, parallel=ctx,
                                collect_routing=routed)[0]
    plain = step(False)
    step(True)                               # builds and loads the kernels
    ops.reset_launch_counts()
    with _no_host_sync():
        out = step(True)
    assert ops.launch_counts()["kv_cache_write"] == L * 4
    assert out.shape == (B + L * E,) and out.dtype == torch.int32
    assert torch.equal(out[:B], plain)
    counts = out[B:].view(L, E).cpu()
    assert int(counts.sum()) == L * B * cfg.top_k and counts.min() >= 0
    hmm.close()


def _joined(srv):
    """Every rebalance session's copies land in the tick that opens it, so
    the commits fall on the same ticks in every run."""
    hmm = srv.hmm
    begin = hmm.begin_rebalance

    def wrapped(*a, **k):
        n = begin(*a, **k)
        if hmm._rebalance_session is not None:
            hmm._rebalance_session.join()
        return n
    hmm.begin_rebalance = wrapped
    return srv


def test_rebalance_commit_under_graphs_recaptures_nothing(dev):
    """TEST_MOE's widths in bf16 on DP2 x TP2 logical devices with
    ``routing_sample_every=1`` (the routed graph each tick) and the
    reference test's tight policy: replicas and demotions commit while
    serving, no graph is captured after boot (the commit writes the index
    tensors in place: every bound tensor keeps its address), and the
    tokens equal the eager twin's and those of the graphed server without
    a policy."""
    from repro_torch.core.graphs import _tensors
    from repro_torch.serving.rebalance import RebalancePolicy
    tokens = {}
    for graphs, policy in ((True, True), (False, True), (True, False)):
        kw = {}
        if policy:
            kw = dict(routing_sample_every=1, rebalance=RebalancePolicy(
                hot_factor=1.02, cold_factor=0.98, min_samples=3,
                cooldown_s=0.5, max_actions=8))
        srv = _joined(_graph_server(dev, "dp2_tp2", graphs, **kw))
        eng = srv.engine
        bound = [(t, t.data_ptr())
                 for t in _tensors(eng.params) + _tensors(eng.cache)]
        captures, step_set = srv.imm.stats["captures"], eng.graphs
        tokens[(graphs, policy)] = _drive(srv)
        if policy:
            summ = srv.rebalance_summary()
            assert summ["replicated"] >= 1 and summ["demoted"] >= 1, summ
            assert srv.imm.stats["captures"] == captures
            assert eng.graphs is step_set
            assert all(t.data_ptr() == p for t, p in bound)
            assert srv.hmm.page_table.replicas
            if graphs:
                assert step_set._routed == 1
        srv.hmm.close()
    assert tokens[(True, True)] == tokens[(False, True)]
    assert tokens[(True, True)] == tokens[(True, False)]


@pytest.mark.parametrize("staging", ["serial", "overlap"])
def test_demote_and_cold_scale_bytes_equal_the_cpu_run(dev, staging):
    """int8 pages of TEST_MOE's widths, DP2 x TP2 -> DP3 x TP2: a rebalance
    that demotes every expert and replicates one, then a scale, on logical
    devices of the card and of the CPU.  The ``TransferStats`` byte
    fields and the migrations are equal; on the card the host rows are
    pinned (D2H on the worker's side stream) and each host-sourced page
    lands equal to its host rows (the ``_scale`` banks too)."""
    from repro_torch.core.expert_pages import HOST
    from repro_torch.core.hmm import HMM
    from repro_torch.core.topology import ElasticConfig
    c4 = ElasticConfig(2, 2, (0, 1, 2, 3))
    c6 = ElasticConfig(3, 2, tuple(range(6)))
    acts = [("demote", l, e) for l in range(2) for e in range(24)]
    acts.append(("replicate", 0, 0, 1))

    def run(d):
        hmm = HMM(_graph_model("test-moe"), 2, batch_per_replica=2,
                  max_len=128, seed=0, all_devices=[d] * 8, device=d,
                  kv_mode="paged", kv_block_size=16, expert_mode="pooled",
                  expert_dtype="int8", staging=staging)
        hmm.boot(c4)
        hmm.begin_rebalance(acts)
        reb = hmm.commit_rebalance()
        stage = hmm.scale(c6)
        fields = lambda st: {f: getattr(st, f) for f in st.BYTE_FIELDS}
        out = (fields(reb), fields(stage),
               [(m.layer, m.expert, m.src.device, m.src.page, m.dst.device,
                 m.dst.page) for m in hmm.last_migrations])
        return hmm, out

    cpu, want = run(torch.device("cpu"))
    cpu.close()
    hmm, got = run(dev)
    assert got == want
    assert all(m[2] == HOST for m in got[2])
    assert got[1]["expert_p2p_bytes"] == 0
    assert got[1]["expert_h2d_bytes"] == len(got[2]) \
        * hmm.expert_page_nbytes()
    host = hmm._expert_host_pool
    assert all(t.is_pinned() for rows in host.values()
               for t in rows.values())
    new = hmm.staged[2]["moe_pool"]
    torch.cuda.synchronize()
    for l, e, _, _, d, page in got[2]:
        for bank, rows in host[(l, e)].items():
            assert torch.equal(new[bank].shard(d)[page].cpu(), rows)
    hmm.commit()
    hmm.close()


# ------------------------------------------------------------ scale to zero

def _strict(fn):
    """``fn`` under ``set_sync_debug_mode("error")``: a call that
    synchronises with the host raises (the mode is global: the
    TransferEngine's workers run under it too)."""
    def run(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return run


def _park_server(dev, seed=0, cache=None, **kw):
    """TEST_MOE's widths in bf16, DP2 x TP2 on 8 logical devices of the
    card, paged KV, pooled pages, chunked prefill, CUDA graphs."""
    from repro_torch.core.elastic_engine import ElasticServer
    from repro_torch.core.topology import ElasticConfig
    srv = ElasticServer(_graph_model("test-moe"), tp=2, batch_per_replica=2,
                        max_len=128, seed=seed, all_devices=[dev] * 8,
                        device=dev, imm_cache=cache, **GRAPH_PAGED, **kw)
    srv.boot(ElasticConfig(2, 2, (0, 1, 2, 3)))
    return srv


def test_park_frees_the_device_memory_and_every_graph_set(dev):
    """A graphed server that served and scaled (its source's set released
    at the switchover, the target's live) parks: every parameter and
    cache tensor it bound is freed, the engine and the IMM hold no graph,
    ``memory_allocated`` is back within 256 MiB of its level before the
    boot, and the snapshot is pinned.  Unparked to DP3 x TP2 (its graphs
    captured during STAGING) it frees the snapshot's pinned blocks at the
    commit and gives the tokens it gave before."""
    import gc
    import weakref
    from repro_torch.core.graphs import _tensors
    from repro_torch.core.topology import ElasticConfig
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    srv = _park_server(dev, staging="overlap")
    want = _drive(srv)
    srv.scale_to(ElasticConfig(3, 2, tuple(range(6))))
    eng = srv.engine
    bound = [weakref.ref(t) for t in _tensors(eng.params)
             + _tensors(eng.cache)]
    sets = [i for i in srv.imm._cache.values() if i.graphs is not None]
    assert len(sets) == 1 and eng.graphs is sets[0].graphs
    del eng
    st = srv.park()
    gc.collect()
    assert all(r() is None for r in bound)
    assert srv.engine.graphs is None and srv.engine.params is None
    assert all(i.graphs is None and i.binding is None for i in sets)
    assert torch.cuda.memory_allocated() - before < 256 << 20
    snap = srv.hmm._parked
    assert all(b.is_pinned() for b in snap.arena.blocks)
    assert st.d2h_bytes == srv.hmm.parked_bytes()
    blocks = len(snap.arena.blocks)
    del snap
    frees = torch.cuda.host_memory_stats()["num_host_free"]
    task = srv.start_unpark(ElasticConfig(3, 2, tuple(range(6))))
    n = 0
    while not task.done:
        task.advance(n * .1)
        n += 1
    assert task.phase.name == "DONE" and srv.engine.graphs is not None
    # the commit gave the snapshot's pinned blocks back to the system
    assert torch.cuda.host_memory_stats()["num_host_free"] - frees >= blocks
    assert _drive(srv) == want
    srv.hmm.close()


def test_unpark_polls_make_no_host_sync_beside_a_ticking_server(dev):
    """Server "a" unparks (overlapped staging, each unit slowed) while
    server "b" serves on the same card: ``start_unpark`` and every STAGING
    poll (the copies on side streams, one graph captured a poll) run under
    sync-debug "error", and so does each of "b"'s decode steps between
    them; "a" then serves its pre-park tokens."""
    import time
    from repro_torch.core.topology import ElasticConfig
    from repro_torch.serving.driver import ScalePhase
    a = _park_server(dev, staging="overlap", transfer_workers=2)
    want = _drive(a)
    a.park()
    b = _park_server(dev, seed=1)
    for r in _graph_requests(b.mcfg.vocab_size):
        b.submit(r)
    b.tick(0.0)
    graphs = b.engine.graphs
    graphs.decode = _strict(graphs.decode)
    unit = a.hmm._stage_unit

    def slow(*args, **kw):
        time.sleep(0.005)
        return unit(*args, **kw)
    a.hmm._stage_unit = slow
    torch.cuda.synchronize()
    task = _strict(a.start_unpark)(ElasticConfig(2, 2, (0, 1, 2, 3)))
    n, polls = 1, 0
    while task.phase is ScalePhase.STAGING:
        _strict(task.advance)(n * .1)
        b.tick(n * .1)
        n, polls = n + 1, polls + 1
    while not task.done:
        task.advance(n * .1)
        n += 1
    del a.hmm._stage_unit, graphs.decode
    # one graph of the target's set captured a STAGING poll
    assert polls >= len(a.engine.graphs._graphs) > 0
    assert _drive(a) == want
    a.hmm.close()
    b.hmm.close()


def test_shared_cache_servers_keep_their_sets_through_a_park(dev):
    """Two servers of one model share one ``imm_cache``: one scales to
    DP3 x TP2 and serves, the other parks; the first then captures
    nothing more, keeps its graph set and gives the same tokens."""
    from collections import OrderedDict
    from repro_torch.core.topology import ElasticConfig
    shared = OrderedDict()
    s1 = _park_server(dev, cache=shared)
    s2 = _park_server(dev, seed=1, cache=shared)
    s1.scale_to(ElasticConfig(3, 2, tuple(range(6))))
    _drive(s1)                  # its prompts' prefixes registered, as later
    want = _drive(s1)
    captures, step_set = s1.imm.stats["captures"], s1.engine.graphs
    s2.park()
    assert _drive(s1) == want
    assert s1.imm.stats["captures"] == captures
    assert s1.engine.graphs is step_set
    inst = shared[s1.imm._key(ElasticConfig(3, 2, tuple(range(6))))]
    assert inst.graphs is step_set and inst.live
    s1.hmm.close()
    s2.hmm.close()


# ---------------------------------------- prefill graphs, dense KV chunks

# store: (model, tp, dp, server knobs); every one monolithic but the
# chunked ones
PREFILL_STORES = {
    "dense": ("qwen3-30b-a3b", 1, 1, dict(prefill_buckets=(32, 64))),
    "paged": ("test-moe", 1, 1, dict(kv_mode="paged", kv_block_size=16,
                                     expert_mode="pooled",
                                     prefill_buckets=(32, 64))),
    "mla": ("deepseek-v2-lite-16b", 1, 1, dict(prefill_buckets=(32, 64))),
    "mamba2": ("mamba2-1.3b", 1, 1, dict(prefill_buckets=(32, 64))),
    "zamba2": ("zamba2-2.7b", 1, 1, dict(prefill_buckets=(32, 64))),
    "dense_dp2_tp2": ("test-moe", 2, 2, dict(prefill_buckets=(32, 64))),
}
DENSE_CHUNK_STORES = {
    "dense_chunk": ("test-moe", 1, 1, dict(prefill_chunk=32,
                                           prefill_budget=64)),
    "dense_chunk_dp2_tp2": ("test-moe", 2, 2, dict(prefill_chunk=32,
                                                   prefill_budget=64)),
}


def _prefill_server(dev, spec, graphs=True):
    from repro_torch.core.elastic_engine import ElasticServer
    from repro_torch.core.topology import ElasticConfig
    model, tp, dp, knobs = spec
    srv = ElasticServer(_graph_model(model), tp=tp, batch_per_replica=2,
                        max_len=128, seed=0, all_devices=[dev] * (dp * tp),
                        device=dev, cuda_graphs=graphs, **knobs)
    srv.boot(ElasticConfig(dp, tp, tuple(range(dp * tp))))
    return srv


def _shards(eng):
    from repro_torch.core.graphs import _tensors
    return _tensors(eng.cache)


def _graphed_twin(eng, eager, graphed):
    """Run ``eager()`` -> the token tensor, then, from the cache state
    before it, ``graphed()`` under sync-debug "error": the tokens and
    every cache shard must be equal bit for bit, and the step must have
    written something."""
    before = [t.clone() for t in _shards(eng)]
    want = int(eager()[0])
    after = [t.clone() for t in _shards(eng)]
    assert any(not torch.equal(a, b) for a, b in zip(after, before))
    for t, b in zip(_shards(eng), before):
        t.copy_(b)
    with _no_host_sync():
        out = graphed()
    assert int(out[0]) == want
    for t, a in zip(_shards(eng), after):
        assert torch.equal(t, a)


@pytest.mark.parametrize("store", sorted(PREFILL_STORES))
def test_graphed_prefill_equals_eager_with_no_host_sync(dev, store):
    """Each monolithic store's prefill bucket (the slot row of the dense,
    MLA latent and Mamba2 / zamba2 state caches, the paged pool's blocks;
    on DP2 x TP2, replica 1's row in both ranks' copies) as the IMM's
    graph: filled and replayed under sync-debug "error", its token and
    every cache shard equal the eager step's on the same inputs and
    state, bit for bit."""
    import numpy as np
    srv = _prefill_server(dev, PREFILL_STORES[store])
    eng = srv.engine
    assert all(eng.graphs.has_prefill(b) for b in (32, 64))
    S, S_pad, r = 45, 64, eng.cfg.dp - 1
    gen = torch.Generator().manual_seed(4)
    host = np.zeros((1, S_pad), np.int32)
    host[0, :S] = torch.randint(0, srv.mcfg.vocab_size, (S,),
                                generator=gen).numpy()
    if eng.paged:
        where = np.array([3, 1, 6, eng.kv.blocks_per_partition], np.int32)
    else:
        where = np.array([1], np.int32)
    kw = {"replica": r} if eng.parallel is not None else {}
    step = eng.compiled[f"prefill_{S_pad}"]

    def eager():
        return step(eng.params, eng.cache, torch.from_numpy(host).to(dev),
                    torch.tensor([S], dtype=torch.int32, device=dev),
                    torch.from_numpy(where).to(dev), **kw)[0]
    _graphed_twin(eng, eager, lambda: eng.graphs.prefill(r, host, S, where))
    srv.hmm.close()


def test_a_lazy_paged_bucket_runs_eagerly(dev):
    """A paged monolithic server given bucket 32 only: a prompt of 45
    tokens needs bucket 64, which the engine builds lazily and runs
    eagerly (the set holds no graph of it, and nothing is captured after
    boot); the tokens equal the eager twin's."""
    spec = PREFILL_STORES["paged"]
    spec = spec[:3] + (dict(spec[3], prefill_buckets=(32,)),)
    tokens = {}
    for graphs in (False, True):
        srv = _prefill_server(dev, spec, graphs)
        captures = srv.imm.stats["captures"]
        tokens[graphs] = _drive(srv)
        assert "prefill_64" in srv.engine.compiled
        if graphs:
            assert not srv.engine.graphs.has_prefill(64)
            assert srv.engine.graphs.has_prefill(32)
            assert srv.imm.stats["captures"] == captures
        srv.hmm.close()
    assert tokens[True] == tokens[False]


@pytest.mark.parametrize("store", sorted(DENSE_CHUNK_STORES))
def test_dense_chunk_step_graphed_equals_eager_with_no_host_sync(dev,
                                                                 store):
    """Dense KV with chunks of 32: the chunk step over the slot's row (the
    mixed kernel over the row read as pool blocks, the chunk written by
    ``kv_cache_write``'s block instance), replayed from the IMM's graph
    under sync-debug "error", equals the eager step bit for bit (token and
    every shard; on DP2 x TP2 replica 1's row in both ranks' copies); the
    server's tokens equal its eager twin's, with the same launch counts,
    and it captured no prefill bucket."""
    import numpy as np
    spec = DENSE_CHUNK_STORES[store]
    srv = _prefill_server(dev, spec)
    eng = srv.engine
    assert not eng.graphs.has_prefill(64)
    r, C = eng.cfg.dp - 1, 32
    gen = torch.Generator().manual_seed(5)
    host = torch.randint(0, srv.mcfg.vocab_size, (1, C), generator=gen,
                         dtype=torch.int32).numpy()
    row = np.array([1], np.int32)
    kw = {"replica": r} if eng.parallel is not None else {}
    step = eng.compiled[f"chunk_prefill_{C}"]
    for start, length in ((0, 32), (32, 50)):
        def eager():
            return step(eng.params, eng.cache,
                        torch.from_numpy(host).to(dev),
                        torch.tensor([start], dtype=torch.int32, device=dev),
                        torch.tensor([length], dtype=torch.int32,
                                     device=dev),
                        torch.from_numpy(row).to(dev), **kw)[0]
        _graphed_twin(eng, eager, lambda: eng.graphs.chunk(
            r, host, start, length, row))
    srv.hmm.close()
    tokens, counts = {}, {}
    for graphs in (False, True):
        srv = _prefill_server(dev, spec, graphs)
        ops.reset_launch_counts()
        tokens[graphs] = _drive(srv)
        counts[graphs] = ops.launch_counts()
        srv.hmm.close()
    assert tokens[True] == tokens[False] and counts[True] == counts[False]
    assert counts[True]["mixed_block_paged_attention"] > 0
    assert counts[True]["flash_attention"] == 0


def test_a_scale_down_frees_the_source_tensors_the_target_does_not_hold(
        dev):
    """DP3 x TP2 -> DP2 x TP2 on a graphed server (paged KV, pooled
    pages; a vocabulary of 32,768, so the third replica's embedding and
    LM head copies take 32 MiB): after the switchover every source
    parameter and cache tensor that the target does not hold is freed —
    the source's graph set, whose closures named them, was released —
    and ``memory_allocated`` has fallen by at least their bytes, less the
    target's own new tensors and 1 MiB of static inputs."""
    import gc
    import weakref
    from repro_torch.core.elastic_engine import ElasticServer
    from repro_torch.core.graphs import _tensors
    from repro_torch.core.topology import ElasticConfig
    cfg = dataclasses.replace(_graph_model("test-moe"), vocab_size=32768,
                              d_model=256)
    srv = ElasticServer(cfg, tp=2, batch_per_replica=2, max_len=128,
                        seed=0, all_devices=[dev] * 6, device=dev,
                        **GRAPH_PAGED)
    srv.boot(ElasticConfig(3, 2, tuple(range(6))))
    _drive(srv)
    eng = srv.engine
    src = {id(t): t for t in _tensors(eng.params) + _tensors(eng.cache)}
    gc.collect()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    srv.scale_to(ElasticConfig(2, 2, (0, 1, 2, 3)))
    tgt = {id(t): t for t in _tensors(eng.params) + _tensors(eng.cache)}
    gone = [weakref.ref(t) for i, t in src.items() if i not in tgt]
    gone_bytes = sum(t.nbytes for i, t in src.items() if i not in tgt)
    new_bytes = sum(t.nbytes for i, t in tgt.items() if i not in src)
    del src
    gc.collect()
    torch.cuda.synchronize()
    assert gone and all(r() is None for r in gone)
    assert gone_bytes > 16 << 20
    assert m0 - torch.cuda.memory_allocated() >= \
        gone_bytes - new_bytes - (1 << 20)
    assert len(_drive(srv)) == len(GRAPH_REQS)
    srv.hmm.close()

