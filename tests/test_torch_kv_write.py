"""The plain versions of the port's KV writes against the reference, on the
CPU: the slot pair write (K and V, or MLA's latent and rope-key rows, at
the same positions), the paged decode write, the block write of a prefill
chunk and ``write_prefill_to_blocks``.  The reference side is what the
JAX package computes at those sites: ``.at[...].set(mode="drop")``, with
``repro.kernels.quant.quantize_rows`` on an int8 pool.

Inputs come from numpy with a seed: f32 and bf16 rows into f32, bf16 and
int8 pools that hold earlier contents.  Every paged case puts the ``NB``
sentinel beside a live write to block ``NB - 1`` at the same offset, where
a sentinel clamped onto ``NB - 1`` would collide with the live row.
Tolerances: bit for bit for f32 and bf16 pools and for the int8 scales;
int8 entries equal except at most one quantum at a rounding tie, counted
as ``tests/test_torch_quant.py`` counts them.  The CUDA kernels are held
against these plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant as jquant
from repro.models import model as JM
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import kv_write, ops
from repro_torch.kernels import ref as tref
from repro_torch.models import model as TM

KVH, HD = 4, 16                       # TEST_MOE's kv heads and head width
NB, BS = 10, 8
STORES = ["float32", "bfloat16", "int8"]
ROWS = ["float32", "bfloat16"]


def _rows(rng, shape, dtype):
    """Normal rows whose token rows' maxima spread over two decades, as a
    jnp array of ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.exp(rng.uniform(-2.3, 2.3, shape[:-2] + (1, 1)))
    return jnp.asarray(x.astype(np.float32), jnp.dtype(dtype))


def _pools(rng, store, lead=()):
    """K/V pools [*lead, NB, BS, KVH, HD] with earlier contents (and f32
    scales [*lead, NB, BS] for an int8 store), as numpy arrays."""
    shape = lead + (NB, BS, KVH, HD)
    out = {}
    for n in ("k", "v"):
        if store == "int8":
            out[n] = rng.integers(-127, 128, shape).astype(np.int8)
            out[n + "_scale"] = rng.uniform(0.01, 0.03, shape[:-2]) \
                .astype(np.float32)
        else:
            out[n] = np.asarray(jnp.asarray(
                rng.standard_normal(shape).astype(np.float32),
                jnp.dtype(store)))
    return out


def _t(tree):
    return {n: tensor_from_numpy(np.asarray(a)) for n, a in tree.items()}


def _assert_written(got, want):
    """f32/bf16 pools and scales bit for bit; int8 entries within one
    quantum at a rounding tie, at most two of them."""
    flips = 0
    for n, leaf in got.items():
        w = tensor_from_numpy(np.asarray(want[n]))
        if leaf.dtype == torch.int8:
            d = (leaf.int() - w.int()).abs()
            assert int(d.max()) <= 1, n
            flips += int(d.count_nonzero())
        else:
            assert torch.equal(leaf, w), n
    assert flips <= 2, flips


def _jax_set(pool, index, rows, scale=None):
    """The reference's write: rows cast to the pool's dtype, or quantized
    over their (KVH, hd) row with the scales set through the same index."""
    if scale is None:
        return pool.at[index].set(rows.astype(pool.dtype), mode="drop"), None
    q, s = jquant.quantize_rows(rows, (-2, -1))
    return (pool.at[index].set(q, mode="drop"),
            scale.at[index].set(s, mode="drop"))


def _jax_paged(pools, index, new):
    out = {}
    for n in ("k", "v"):
        scale = pools.get(n + "_scale")
        out[n], s = _jax_set(jnp.asarray(pools[n]), index, new[n],
                             None if scale is None else jnp.asarray(scale))
        if s is not None:
            out[n + "_scale"] = s
    return out


# ------------------------------------------------------------- slot pair

@pytest.mark.parametrize("rows", [(KVH, HD), (32,)],
                         ids=["kv", "latent"])
@pytest.mark.parametrize("dtype", ROWS)
def test_slot_pair_write_equals_reference(dtype, rows):
    """K and V rows of one width, or a latent row (32 values here, 512 at
    deepseek-v2-lite) beside a rope-key row of 8 (64): both written at
    ``pos``; ``pos = S`` (a full slot's next token) drops in both."""
    rng = np.random.default_rng(0)
    B, S = 4, 24
    rows_b = (KVH, HD) if len(rows) == 2 else (8,)
    caches = [_rows(rng, (B, S) + r, dtype) for r in (rows, rows_b)]
    new = [_rows(rng, (B,) + r, dtype) for r in (rows, rows_b)]
    pos = np.array([0, S, 13, S - 1], np.int32)
    want = [c.at[jnp.arange(B), pos].set(n, mode="drop")
            for c, n in zip(caches, new)]
    tc = [tensor_from_numpy(np.asarray(c)) for c in caches]
    got = ops.kv_cache_write_pair(tc[0], tensor_from_numpy(np.asarray(
        new[0])), tc[1], tensor_from_numpy(np.asarray(new[1])),
        torch.from_numpy(pos))
    assert got[0] is tc[0] and got[1] is tc[1]          # in place
    for g, w, c in zip(got, want, caches):
        assert torch.equal(g, tensor_from_numpy(np.asarray(w)))
        assert torch.equal(g[1], tensor_from_numpy(np.asarray(c[1])))


# ---------------------------------------------------------- paged decode

@pytest.mark.parametrize("dtype", ROWS)
@pytest.mark.parametrize("store", STORES)
def test_paged_decode_write_equals_reference(store, dtype):
    """Five slots: live writes to blocks 3, NB - 1 and 0 (offsets 5, 2 and
    7), and two inactive slots on the NB sentinel whose lengths point at
    the same offset 2 as the live write to NB - 1."""
    rng = np.random.default_rng(1)
    pools = _pools(rng, store)
    write_block = np.array([3, NB, NB - 1, NB, 0], np.int32)
    lengths = np.array([21, 2 + 3 * BS, 2 + BS, 2, 7], np.int32)
    new = {n: _rows(rng, (5, KVH, HD), dtype) for n in ("k", "v")}
    want = _jax_paged(pools, (write_block, lengths % BS), new)
    got = _t(pools)
    ops.kv_paged_write(got["k"], got["v"], *(tensor_from_numpy(np.asarray(
        new[n])) for n in ("k", "v")), torch.from_numpy(write_block),
        torch.from_numpy(lengths), got.get("k_scale"), got.get("v_scale"))
    _assert_written(got, want)
    # the live row at (NB - 1, 2) is the new one, not the earlier contents
    assert not torch.equal(got["k"][NB - 1, 2],
                           tensor_from_numpy(pools["k"][NB - 1, 2]))


# ----------------------------------------------------------- block write

@pytest.mark.parametrize("dtype", ROWS)
@pytest.mark.parametrize("store", STORES)
def test_chunk_block_write_equals_reference(store, dtype):
    """A chunk of 4 blocks: blocks 6 and NB - 1 written, a CoW-shared block
    and a padding block on the sentinel (the rows the sentinel carries
    would land on NB - 1 if it were clamped)."""
    rng = np.random.default_rng(2)
    pools = _pools(rng, store)
    ids = np.array([6, NB, NB - 1, NB], np.int32)
    C = ids.shape[0] * BS
    new = {n: _rows(rng, (1, C, KVH, HD), dtype) for n in ("k", "v")}
    blocks = {n: a[0].reshape(-1, BS, KVH, HD) for n, a in new.items()}
    want = _jax_paged(pools, ids, blocks)
    got = _t(pools)
    one = {n: t[None] for n, t in got.items()}
    ops.kv_block_write(one["k"], one["v"], *(tensor_from_numpy(np.asarray(
        new[n])) for n in ("k", "v")), torch.from_numpy(ids),
        one.get("k_scale"), one.get("v_scale"))
    _assert_written(got, want)


@pytest.mark.parametrize("dtype", ROWS)
@pytest.mark.parametrize("store", STORES)
def test_write_prefill_to_blocks_with_the_sentinel_beside_the_last_block(
        store, dtype):
    """Two layers of a 32-token prefill into blocks NB - 1, (shared), 4,
    (padding): the model function against the reference's."""
    rng = np.random.default_rng(3)
    L, S = 2, 4 * BS
    pools = _pools(rng, store, lead=(L,))
    small = {n: _rows(rng, (L, 1, S, KVH, HD), dtype) for n in ("k", "v")}
    ids = np.array([NB - 1, NB, 4, NB], np.int32)
    want = JM.write_prefill_to_blocks(
        {n: jnp.asarray(a) for n, a in pools.items()}, small, ids)
    got = _t(pools)
    assert TM.write_prefill_to_blocks(
        got, _t(small), torch.from_numpy(ids)) is got
    _assert_written(got, want)


# ------------------------------------------------------------- dispatch

def _cpu_inputs():
    g = torch.Generator().manual_seed(4)
    pools = [torch.randn(NB, BS, KVH, HD, generator=g) for _ in range(2)]
    new = [torch.randn(3, KVH, HD, generator=g) for _ in range(2)]
    wb = torch.tensor([1, NB, 2], dtype=torch.int32)
    lens = torch.tensor([3, 4, 5], dtype=torch.int32)
    return pools, new, wb, lens


def test_cpu_tensors_take_the_plain_writes_and_count_no_launch():
    pools, new, wb, lens = _cpu_inputs()
    want = [p.clone() for p in pools]
    tref.kv_paged_write_ref(*want, *new, wb, lens)
    ops.reset_launch_counts()
    ops.kv_paged_write(*pools, *new, wb, lens)
    assert all(torch.equal(p, w) for p, w in zip(pools, want))
    ops.kv_block_write(pools[0][None], pools[1][None],
                       torch.zeros(1, BS, KVH, HD),
                       torch.zeros(1, BS, KVH, HD),
                       torch.tensor([NB], dtype=torch.int32))
    assert all(torch.equal(p, w) for p, w in zip(pools, want))  # dropped
    ops.kv_cache_write_pair(pools[0][:3], new[0], pools[1][:3], new[1],
                            torch.tensor([BS, 0, 1], dtype=torch.int32))
    assert torch.equal(pools[0][0], want[0][0])           # pos = S dropped
    assert torch.equal(pools[1][2, 1], new[1][2])
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_write_wrappers_refuse_cpu_tensors():
    pools, new, wb, lens = _cpu_inputs()
    with pytest.raises(ValueError, match="CUDA kernel"):
        kv_write.kv_paged_write(*pools, *new, wb, lens)
    with pytest.raises(ValueError, match="CUDA kernel"):
        kv_write.kv_block_write(pools[0][None], pools[1][None],
                                torch.zeros(1, BS, KVH, HD),
                                torch.zeros(1, BS, KVH, HD),
                                torch.tensor([0], dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA kernel"):
        kv_write.kv_cache_write_pair(pools[0][:3], new[0], pools[1][:3],
                                     new[1], lens)
    assert ops.launch_counts()["kv_cache_write"] == 0
