"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the serving path does not reach (ragged F and D tiles, odd
token counts, other head dims and block sizes, aliased tables, sentinel
rows).  Needs an NVIDIA GPU: marked ``cuda`` and skipped elsewhere.  On the
card, from the repo root::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerance: f32 atol = rtol = 1e-4 (f32 sums in another order than the
plain version's matmuls); bf16 atol = rtol = 2e-2 on f32-cast outputs
(both round once from f32).
"""
import pytest
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import moe_gmm, ops, paged_attention, ref

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
    mixed = paged_attention.mixed_block_paged_attention(
        q[:, None].contiguous(), k, v, bt, lens, torch.ones_like(lens))
    assert torch.equal(mixed[:, 0], got)               # q_len == 1 is decode


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
