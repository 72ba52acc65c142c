"""The port serving at tp > 1 against the reference, on the CPU.

The reference runs in one subprocess with 8 simulated host devices (as
``tests/helpers.run_with_devices`` runs it), started once per module: it
boots the HMMs whose weights the port takes (``np.savez`` of the
parameters), runs its one-device model steps on those weights and on
inputs it draws from a numpy seed (saved beside them), and runs its
``ElasticServer`` at tp = 2, DP2 -> DP3 (``stage_scale`` at the 5th tick,
one tick, ``switchover``), saving the greedy tokens and the scale's
``TransferStats``.  The port runs in this process on ``[cpu] * 8`` logical
devices.  Held:

* the port's ``forward``, ``prefill``, ``decode_step``,
  ``paged_decode_step`` and ``paged_chunk_prefill_step`` at DP2 x TP2 and
  DP2 x TP4 (TEST_MOE with dense banks and with pooled pages; the dense
  test model, whose MLP splits over the ranks; TEST_MOE with a shared
  expert, split over the ranks, and with a dense MLP beside the MoE
  (``dense_residual``), split too) against the
  reference's one-device steps at f32: logits and written cache rows
  within atol = rtol = 1e-5 (``tests/test_torch_model.py``'s rule: the TP
  ranks' partial sums add in another order than one product's); every TP
  rank's copy of the cache bitwise equal to the others after every step;
* the bf16 and int8 stores: every rank's copy bitwise equal after a paged
  decode, a chunk, a prefill written into the pool, a slot decode and a
  slot prefill;
* ``ElasticServer`` at tp = 2, DP2 -> DP3: greedy tokens equal the
  reference server's and an unscaled DP3 x TP2 run of the port, for the
  paged KV pool with pooled pages and chunked prefill, for the default
  stores and for the int8 KV blocks and expert pages; every
  ``TransferStats.BYTE_FIELDS`` value equal the reference's, staged and
  committed;
* dense KV with chunked prefill (``DENSE_CHUNK``, one loop exec'd on both
  sides): DP2 x TP2 with dense banks and pooled pages, greedy tokens equal
  the reference's and the port's monolithic run's; DP2 x TP2 -> DP3 x TP2
  opened while prompts are mid-chunk, tokens and byte fields equal the
  reference's;
* a TP degree that cuts a head — (H, KVH, tp) = (4, 2, 4), (6, 6, 4),
  (4, 1, 2) and (4, 4, 3): a rank holds half a kv head, one and a half
  query heads, half of the one kv head, or (no width dividing by 3) the
  whole weights, of which it keeps a third of the output columns — the
  same six steps (``chunk_prefill_step``
  too) at DP2 x tp against the reference's one-device steps within 1e-5,
  every rank's copy bitwise equal, also for bf16 and int8 stores;
  ``ElasticServer`` with 2 kv heads at tp = 4, DP1 x TP4 -> DP2 x TP4
  (paged KV, pooled pages, chunks of 16): greedy tokens and every
  ``TransferStats.BYTE_FIELDS`` value equal the reference's; an MLA model
  at a tp that cuts its heads still raises, naming its slice;
* a vocabulary that does not split over the ranks stays whole on each
  (the sharding rule) and gives the one-device logits;
* the plain attention versions at a kv head offset equal the plain
  versions on the heads sliced out, and the TP sums and gathers add and
  join in rank order.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from test_torch_scale import (CHUNKED, COMMON, CPU8, DENSE, REQS, TOL,
                              _mcfg, _start, _stats, _tree, _wait)
from repro_torch.configs import get_config
from repro_torch.core.elastic_engine import ElasticServer
from repro_torch.core.hmm import HMM
from repro_torch.core.topology import ElasticConfig
from repro_torch.distributed.sharding import (make_instance_mesh,
                                              tp_all_gather, tp_all_reduce,
                                              tp_gather)
from repro_torch.kernels import ref
from repro_torch.models import model as TM
from repro_torch.serving.engine import _prefill_fn, engine_parallel_ctx
from repro_torch.serving.workload import Request

MAX_LEN, NBL, BS = 32, 8, 8          # slot cache length; blocks a replica

# dense KV with chunked prefill at DP2 x TP2 (the requests and knobs of
# ``tests/test_chunked_prefill.py``): exec'd by the reference script and by
# the tests, so both sides drive the same loop
DENSE_CHUNK = '''
DC_KW = dict(tp=2, batch_per_replica=4, max_len=128, seed=0,
             kv_mode="dense", kv_block_size=16, prefill_buckets=(32, 64, 96),
             prefill_chunk=32, prefill_budget=64)
# the mid-chunk scale: two slots a replica, one chunk a tick
DC_SCALE_KW = dict(DC_KW, batch_per_replica=2, prefill_buckets=(32,),
                   prefill_budget=32)

def mixed_reqs():
    rng = np.random.default_rng(0)
    return [Request(i, 0.2 * i, L, o,
                    prompt=rng.integers(0, 128, L).astype(np.int32))
            for i, (L, o) in enumerate(zip([10, 37, 90, 16, 64, 45],
                                           [8, 12, 16, 1, 10, 6]))]

def drive(srv, reqs):
    pending = sorted(reqs, key=lambda r: r.arrival_s)
    t, n, i = 0.0, 0, 0
    while any(r.finish_s is None for r in reqs):
        while i < len(pending) and pending[i].arrival_s <= t:
            srv.submit(pending[i]); i += 1
        srv.tick(t); t += .1; n += 1
        assert n < 3000
    return {str(r.rid): [int(x) for x in srv.engine.generated[r.rid]]
            for r in reqs}

def scale_mid_chunk(srv, target):
    """start_scale to ``target`` at the second tick, while prompts are
    mid-chunk; one advance after every tick."""
    rng = np.random.default_rng(0)
    reqs = [Request(i, 0.0, L, 30,
                    prompt=rng.integers(0, 128, L).astype(np.int32))
            for i, L in enumerate([16, 90, 90, 37])]
    for r in reqs:
        srv.submit(r)
    t, n, task, overlapped = 0.0, 0, None, False
    while any(r.finish_s is None for r in reqs):
        if n == 1 and task is None:
            assert any(s.prefilling for s in srv.engine.slots if s.rid >= 0)
            task = srv.start_scale(target)
        srv.tick(t); t += .1; n += 1
        if task is not None and not task.done:
            task.advance(t)
            overlapped = overlapped or bool(srv.engine._prefilling)
        assert n < 800
    assert overlapped and task.done and srv.engine.num_slots == 6
    return {"tokens": {str(r.rid): [int(x) for x in
                                    srv.engine.generated[r.rid]]
                       for r in reqs},
            "final": stats(srv.events[-1].stats)}
'''

SCRIPT = COMMON + '''
from repro.core.elastic_engine import ElasticServer
from repro.core.hmm import HMM, TransferStats
from repro.models import model as JM
from repro.serving.workload import Request
PARAMS, SERVERS, REQS, CUT, CUT_SERVER = %s, %s, %s, %s, %s
MAX_LEN, NBL, BS = %d, %d, %d

def stats(st):
    return {f: int(getattr(st, f)) for f in TransferStats.BYTE_FIELDS}

rng = np.random.default_rng(0)
res = {}
for name, (model, dp, tp, kw) in PARAMS.items():
    mcfg = {"moe": MCFG, "dense": DENSE,
            "moe_shared": dataclasses.replace(MCFG, num_shared_experts=1),
            "moe_residual": dataclasses.replace(MCFG, dense_residual=True),
            }[model] if model not in CUT else dataclasses.replace(
                MCFG, num_heads=CUT[model][0], num_kv_heads=CUT[model][1])
    hmm = HMM(mcfg, tp=tp, batch_per_replica=2, max_len=MAX_LEN, **kw)
    hmm.boot(cfg(dp, tp))
    np.savez(f"{OUT}/p_{name}.npz", **flat(hmm.params))
    # the global arrays on one device: the one-device steps' weights
    p = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), hmm.params)
    L, KVH, hd = mcfg.num_layers, mcfg.num_kv_heads, mcfg.resolved_head_dim
    V, NB = mcfg.vocab_size, dp * NBL
    io = {}
    # forward: two sequences of 13 tokens
    io["fwd_tokens"] = rng.integers(0, V, (2, 13)).astype(np.int32)
    io["fwd_logits"] = np.asarray(JM.forward(mcfg, p, {
        "tokens": io["fwd_tokens"]})[0])
    # prefill: one prompt of 11 tokens padded to 16
    io["pre_tokens"] = rng.integers(0, V, (1, 16)).astype(np.int32)
    lg, c = JM.prefill(mcfg, p, {"tokens": io["pre_tokens"],
                                 "lengths": np.array([11], np.int32)},
                       MAX_LEN)
    io["pre_logits"] = np.asarray(lg)
    io["pre_k"], io["pre_v"] = np.asarray(c["k"]), np.asarray(c["v"])
    # slot decode: 2 slots a replica, one slot full (its write drops)
    B = 2 * dp
    io["dec_tokens"] = rng.integers(0, V, (B, 1)).astype(np.int32)
    io["dec_lens"] = np.array([5, MAX_LEN, 0, 17][:B], np.int32)
    for n in ("k", "v"):
        io["dec_" + n] = rng.standard_normal(
            (L, B, MAX_LEN, KVH, hd)).astype(np.float32)
    lg, c = JM.decode_step(mcfg, p, io["dec_tokens"],
                           {n: jnp.asarray(io["dec_" + n])
                            for n in ("k", "v")}, io["dec_lens"])
    io["dec_logits"] = np.asarray(lg)
    io["dec_k_out"], io["dec_v_out"] = np.asarray(c["k"]), np.asarray(c["v"])
    # paged decode: tables local to each replica's NBL blocks; the global
    # ids add the replica's base, the sentinel NBL becomes NB
    lens = np.array([5, 17, 30, 9][:B], np.int32)
    local = np.full((B, 4), NBL, np.int32)
    for b in range(B):
        local[b, :-(-(int(lens[b]) + 1) // BS)] = rng.permutation(NBL)[
            :-(-(int(lens[b]) + 1) // BS)]
    wb_local = local[np.arange(B), lens // BS].copy()
    wb_local[1] = NBL                                  # inactive slot
    base = (np.arange(B) // 2 * NBL)[:, None]
    glob = np.where(local == NBL, NB, local + base).astype(np.int32)
    wb = np.where(wb_local == NBL, NB, wb_local + base[:, 0]).astype(np.int32)
    io.update(pd_tokens=rng.integers(0, V, (B, 1)).astype(np.int32),
              pd_lens=lens, pd_tables=local, pd_wb=wb_local)
    for n in ("k", "v"):
        io["pd_" + n] = rng.standard_normal(
            (L, NB, BS, KVH, hd)).astype(np.float32)
    lg, c = JM.paged_decode_step(mcfg, p, io["pd_tokens"],
                                 {n: jnp.asarray(io["pd_" + n])
                                  for n in ("k", "v")}, lens, glob, wb)
    io["pd_logits"] = np.asarray(lg)
    io["pd_k_out"], io["pd_v_out"] = np.asarray(c["k"]), np.asarray(c["v"])
    # chunk step on replica 1: 16 rows at start 8, context 21
    C, start, length = 16, 8, 21
    rows = rng.permutation(NBL)[:4].astype(np.int32)
    tl = np.full((1, 4), NBL, np.int32)
    tl[0, :-(-length // BS)] = rows[:-(-length // BS)]
    ids = np.array([tl[0, 1], tl[0, 2]], np.int32)
    tok = np.zeros((1, C), np.int32)
    tok[0, :length - start] = rng.integers(0, V, length - start)
    io.update(ch_tokens=tok, ch_tables=tl, ch_ids=ids)
    gtl = np.where(tl == NBL, NB, tl + NBL).astype(np.int32)
    lg, c = JM.paged_chunk_prefill_step(
        mcfg, p, tok, {n: jnp.asarray(io["pd_" + n]) for n in ("k", "v")},
        np.int32(start), np.int32(length), gtl, ids + NBL)
    io["ch_logits"] = np.asarray(lg)
    io["ch_k_out"], io["ch_v_out"] = np.asarray(c["k"]), np.asarray(c["v"])
    if model in CUT:
        # the same tokens as a chunk at 16 (a multiple of C, as the engine
        # starts its chunks), context 29, into slot 3 (replica 1's row 1)
        # of the slot cache
        lg, c = JM.chunk_prefill_step(
            mcfg, p, tok, {n: jnp.asarray(io["dec_" + n]) for n in ("k", "v")},
            np.int32(16), np.int32(16 + length - start), np.int32(3))
        io["dc_logits"] = np.asarray(lg)
        io["dc_k_out"], io["dc_v_out"] = np.asarray(c["k"]), np.asarray(c["v"])
    np.savez(f"{OUT}/io_{name}.npz", **io)

def serve(srv, target):
    reqs = [Request(i, 0.0, len(pr), out, prompt=np.asarray(pr, np.int32))
            for i, (pr, out) in enumerate(REQS)]
    for r in reqs:
        srv.submit(r)
    t, n, staged = 0.0, 0, None
    while any(r.finish_s is None for r in reqs):
        if n == 5:
            staged = stats(srv.stage_scale(target).stats)
            srv.tick(t); t += .1; n += 1
            srv.switchover()
            continue
        srv.tick(t); t += .1; n += 1
        assert n < 500
    return {"tokens": {str(r.rid): srv.engine.generated[r.rid]
                       for r in reqs},
            "staged": staged, "final": stats(srv.events[-1].stats)}

for name, kw in SERVERS.items():
    srv = ElasticServer(MCFG, tp=2, batch_per_replica=2, max_len=128,
                        seed=0, **kw)
    srv.boot(cfg(2, 2))
    np.savez(f"{OUT}/serve_{name}.npz", **flat(srv.hmm.params))
    if kw.get("expert_mode") == "pooled":
        hmm = HMM(MCFG, tp=2, batch_per_replica=2, max_len=128, seed=0,
                  **{k: v for k, v in kw.items()
                     if k not in ("prefill_buckets", "prefill_chunk",
                                  "prefill_budget")})
        hmm.boot(cfg(3, 2))
        np.savez(f"{OUT}/serve_{name}_dp3.npz", **flat(hmm.params))
    res[name] = serve(srv, cfg(3, 2))

# two kv heads at tp = 4: each rank holds half a kv head
srv = ElasticServer(dataclasses.replace(MCFG, num_kv_heads=2), tp=4,
                    batch_per_replica=2, max_len=128, seed=0, **CUT_SERVER)
srv.boot(cfg(1, 4))
np.savez(f"{OUT}/serve_cut.npz", **flat(srv.hmm.params))
res["cut"] = serve(srv, cfg(2, 4))

exec(DENSE_CHUNK)
for em in ("dense", "pooled"):
    srv = ElasticServer(MCFG, expert_mode=em, **DC_KW)
    srv.boot(cfg(2, 2))
    np.savez(f"{OUT}/dchunk_{em}.npz", **flat(srv.hmm.params))
    res["dchunk_" + em] = {"tokens": drive(srv, mixed_reqs())}
srv = ElasticServer(MCFG, **DC_SCALE_KW)
srv.boot(cfg(2, 2))
np.savez(f"{OUT}/dchunk_scale.npz", **flat(srv.hmm.params))
res["dchunk_scale"] = scale_mid_chunk(srv, cfg(3, 2))
json.dump(res, open(f"{OUT}/serve.json", "w"))
print("TP-DONE")
'''

POOLED = dict(kv_mode="paged", kv_block_size=BS, expert_mode="pooled")
# name: (model, dp, tp, HMM knobs) — the weights each port case boots from
PARAMS = {
    "moe_dense": ("moe", 2, 2, {}),
    "moe_pooled_tp2": ("moe", 2, 2, POOLED),
    "moe_pooled_tp4": ("moe", 2, 4, POOLED),
    "dense": ("dense", 2, 2, {}),
    "moe_shared": ("moe_shared", 2, 2, {}),
    "moe_residual": ("moe_residual", 2, 2, {}),
    "cut_kvh2": ("cut_kvh2", 2, 4, {}),
    "cut_h6": ("cut_h6", 2, 4, {}),
    "cut_kvh1": ("cut_kvh1", 2, 2, {}),
    "cut_tp3": ("cut_tp3", 2, 3, {}),
}
# the head-cutting weights: (query heads, kv heads, tp); at tp = 3 no
# width splits (64 % 3), so q, k, v, o and the MLP stay whole on each rank
CUT = {"cut_kvh2": (4, 2, 4), "cut_h6": (6, 6, 4), "cut_kvh1": (4, 1, 2),
       "cut_tp3": (4, 4, 3)}
CUT_IDS = {"cut_kvh2": "kvh2-tp4", "cut_h6": "h6-tp4", "cut_kvh1": "kvh1-tp2",
           "cut_tp3": "h4-tp3"}
# the head-cutting server: two kv heads at tp = 4, chunks of 16
CUT_SERVER = dict(CHUNKED, prefill_chunk=16, prefill_budget=32,
                  prefill_buckets=(16,))
# (weights, tp): the dense banks and the dense model hold the same global
# numbers at either tp
CASES = [("moe_dense", 2), ("moe_dense", 4), ("moe_pooled_tp2", 2),
         ("moe_pooled_tp4", 4), ("dense", 2), ("dense", 4),
         ("moe_shared", 2), ("moe_shared", 4), ("moe_residual", 2),
         ("moe_residual", 4)]
STEPS = ["forward", "prefill", "decode_step", "paged_decode_step",
         "paged_chunk_prefill_step"]
SERVERS = {
    "paged": CHUNKED,
    "defaults": dict(prefill_buckets=(32, 64)),
    "int8": dict(CHUNKED, kv_dtype="int8", expert_dtype="int8"),
}


@pytest.fixture(scope="module")
def ref_tp(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_ref")
    proc = _start("DENSE_CHUNK = " + repr(DENSE_CHUNK) + "\n"
                  + SCRIPT % (repr(PARAMS), repr(SERVERS), repr(REQS),
                              repr(CUT), repr(CUT_SERVER), MAX_LEN, NBL,
                              BS), out)
    _wait(proc, "TP steps and servers")
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The steps are tiny: one intra-op thread (the suite runs several
    test workers on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(dp, tp):
    return ElasticConfig(dp, tp, tuple(range(dp * tp)))


def _model(name):
    if name in CUT:
        return _mcfg(num_heads=CUT[name][0], num_kv_heads=CUT[name][1])
    return {"moe": _mcfg(), "dense": DENSE,
            "moe_shared": _mcfg(num_shared_experts=1),
            "moe_residual": _mcfg(dense_residual=True)}[PARAMS[name][0]]


def _booted(ref_tp, name, tp, kv_mode):
    """The port's HMM at DP2 x ``tp`` on the reference's weights ``name``,
    with a slot cache or a pool of NBL blocks a replica (the weights' own
    expert store) -> (cfg, hmm, ctx)."""
    model, dp, _, kw = PARAMS[name]
    kw = dict(kw, kv_mode=kv_mode, kv_block_size=BS,
              kv_blocks_per_replica=NBL)
    mcfg = _model(name)
    hmm = HMM(mcfg, tp, batch_per_replica=2, max_len=MAX_LEN,
              all_devices=CPU8, device="cpu", **kw)
    hmm.boot(_cfg(dp, tp), params=_tree(ref_tp / f"p_{name}.npz"))
    ctx = engine_parallel_ctx(make_instance_mesh(_cfg(dp, tp), CPU8))
    return mcfg, hmm, ctx


def _fill(cache, arrays):
    """Every shard of a sharded cache from the global ``arrays``."""
    for n, leaf in cache.items():
        a = torch.from_numpy(arrays[n])
        for _, idx, t in leaf.addressable_shards:
            t.copy_(a[idx])


def _assert_copies_equal(cache, ctx):
    """Every TP rank's copy of each replica's cache slice bitwise equal to
    rank 0's."""
    for leaf in cache.values():
        for r in range(ctx.dp):
            devs = ctx.replica_devices(r)
            for d in devs[1:]:
                assert torch.equal(leaf.shard(d), leaf.shard(devs[0]))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("case", CASES, ids=[f"{n}-tp{t}" for n, t in CASES])
def test_tp_steps_match_one_device_reference(ref_tp, case, step):
    _check_step(ref_tp, *case, step)


@pytest.mark.parametrize("step", STEPS + ["chunk_prefill_step"])
@pytest.mark.parametrize("name", sorted(CUT), ids=[CUT_IDS[n]
                                                   for n in sorted(CUT)])
def test_a_head_cutting_tp_matches_one_device_reference(ref_tp, name, step):
    """Heads that do not split evenly over tp: each rank gathers q, k and
    v, attends the query heads covering its columns of ``o`` against the
    kv heads they read, and the steps equal the reference's one-device
    steps on the same weights."""
    _check_step(ref_tp, name, CUT[name][2], step)


def _check_step(ref_tp, name, tp, step):
    """The port's ``step`` at DP2 x ``tp`` on the weights ``name`` against
    the reference's one-device step: logits and cache rows within TOL,
    every TP rank's copy of the cache bitwise equal."""
    io = dict(np.load(ref_tp / f"io_{name}.npz"))
    t = {k: torch.from_numpy(v) for k, v in io.items()}
    paged = step.startswith("paged")
    cfg, hmm, ctx = _booted(ref_tp, name, tp, "paged" if paged else "dense")
    params, cache = hmm.params, hmm.cache
    if step == "forward":
        got = TM.forward(cfg, params, {"tokens": t["fwd_tokens"]},
                         parallel=ctx, replica=1)
        _close(got, io["fwd_logits"])
    elif step == "prefill":
        lg, small = TM.prefill(cfg, params, {
            "tokens": t["pre_tokens"], "lengths": torch.tensor([11])},
            MAX_LEN, parallel=ctx, replica=1)
        _close(lg, io["pre_logits"])
        _close(small["k"], io["pre_k"])
        _close(small["v"], io["pre_v"])
        _prefill_fn(cfg, MAX_LEN, params, cache, t["pre_tokens"],
                    torch.tensor([11], dtype=torch.int32),
                    torch.tensor([1], dtype=torch.int32), parallel=ctx,
                    replica=1)                  # slot 3: replica 1, row 1
        _close(cache["k"].gather()[:, 3], io["pre_k"][:, 0])
    elif step == "decode_step":
        _fill(cache, {n: io["dec_" + n] for n in ("k", "v")})
        lg, cache = TM.decode_step(cfg, params, t["dec_tokens"], cache,
                                   t["dec_lens"], parallel=ctx)
        _close(lg, io["dec_logits"])
        for n in ("k", "v"):
            _close(cache[n].gather(), io[f"dec_{n}_out"])
    elif step == "paged_decode_step":
        _fill(cache, {n: io["pd_" + n] for n in ("k", "v")})
        lg, cache = TM.paged_decode_step(
            cfg, params, t["pd_tokens"], cache, t["pd_lens"], t["pd_tables"],
            t["pd_wb"], parallel=ctx)
        _close(lg, io["pd_logits"])
        for n in ("k", "v"):
            _close(cache[n].gather(), io[f"pd_{n}_out"])
    elif step == "chunk_prefill_step":
        _fill(cache, {n: io["dec_" + n] for n in ("k", "v")})
        lg, cache = TM.chunk_prefill_step(
            cfg, params, t["ch_tokens"], cache, 16, 29, 1, parallel=ctx,
            replica=1)                          # slot 3: replica 1, row 1
        _close(lg, io["dc_logits"])
        for n in ("k", "v"):
            _close(cache[n].gather(), io[f"dc_{n}_out"])
    else:
        _fill(cache, {n: io["pd_" + n] for n in ("k", "v")})
        lg, cache = TM.paged_chunk_prefill_step(
            cfg, params, t["ch_tokens"], cache, 8, 21, t["ch_tables"],
            t["ch_ids"], parallel=ctx, replica=1)
        _close(lg, io["ch_logits"])
        for n in ("k", "v"):
            _close(cache[n].gather(), io[f"ch_{n}_out"])
    _assert_copies_equal(cache, ctx)


@pytest.mark.parametrize("store", ["bfloat16", "int8"])
def test_tp_copies_stay_bitwise_equal(store):
    """bf16 stores, and int8 KV blocks with int8 expert pages, at DP2 x
    TP2: a paged decode step, a chunk step, a prefill written into the
    pool, then (slot cache) a decode step and a prefill written into a
    slot leave every rank's copy of the cache equal to rank 0's."""
    _copies_stay_equal(store, 4, 4, 2)


@pytest.mark.parametrize("store", ["bfloat16", "int8"])
@pytest.mark.parametrize("name", sorted(CUT), ids=[CUT_IDS[n]
                                                   for n in sorted(CUT)])
def test_a_head_cutting_tp_keeps_the_copies_bitwise_equal(name, store):
    """The same steps at a tp that cuts a head: every rank writes the
    gathered rows of all heads (an int8 row quantized over all of them)."""
    _copies_stay_equal(store, *CUT[name])


def _copies_stay_equal(store, H, KVH, tp):
    cfg = _mcfg(dtype="bfloat16", num_heads=H, num_kv_heads=KVH)
    int8 = dict(kv_dtype="int8", expert_dtype="int8") \
        if store == "int8" else {}
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen,
                           dtype=torch.int32)
    chunk = torch.randint(0, cfg.vocab_size, (1, 16), generator=gen,
                          dtype=torch.int32)
    lens = torch.tensor([5, 17, 30, 9], dtype=torch.int32)
    for kv_mode in ("paged", "dense"):
        hmm = HMM(cfg, tp, batch_per_replica=2, max_len=MAX_LEN,
                  all_devices=CPU8, device="cpu", kv_mode=kv_mode,
                  kv_block_size=BS, kv_blocks_per_replica=NBL,
                  expert_mode="pooled", **(int8 if kv_mode == "paged"
                                           else {}))
        hmm.boot(_cfg(2, tp))
        ctx = engine_parallel_ctx(make_instance_mesh(_cfg(2, tp), CPU8))
        params, cache = hmm.params, hmm.cache
        if kv_mode == "paged":
            bt = torch.tensor([[0, 1, 8, 8], [2, 3, 4, 8], [0, 1, 2, 3],
                               [5, 6, 8, 8]], dtype=torch.int32)
            wb = torch.tensor([0, 4, 3, 6], dtype=torch.int32)
            TM.paged_decode_step(cfg, params, tokens, cache, lens, bt, wb,
                                 parallel=ctx)
            _assert_copies_equal(cache, ctx)
            TM.paged_chunk_prefill_step(cfg, params, chunk, cache, 8, 21,
                                        bt[2:3], bt[2, 1:3], parallel=ctx,
                                        replica=1)
            _assert_copies_equal(cache, ctx)
            _, small = TM.prefill(cfg, params, {"tokens": chunk}, 16,
                                  parallel=ctx, replica=0)
            TM.write_prefill_to_blocks(cache, small, bt[1, :2], parallel=ctx,
                                       replica=0)
        else:
            TM.decode_step(cfg, params, tokens, cache, lens, parallel=ctx)
            _assert_copies_equal(cache, ctx)
            _prefill_fn(cfg, MAX_LEN, params, cache, chunk,
                        torch.tensor([9], dtype=torch.int32),
                        torch.tensor([0], dtype=torch.int32), parallel=ctx,
                        replica=1)              # slot 2: replica 1, row 0
        _assert_copies_equal(cache, ctx)
        assert any(leaf.shard(1).abs().sum() > 0 for leaf in cache.values())


# ----------------------------------------------------------------- servers

def _serve(name, params, scale, boot_dp=2):
    srv = ElasticServer(_mcfg(), tp=2, batch_per_replica=2, max_len=128,
                        seed=0, all_devices=CPU8, device="cpu",
                        **SERVERS[name])
    srv.boot(_cfg(boot_dp, 2), params=params)
    reqs = [Request(i, 0.0, len(pr), out, prompt=np.asarray(pr, np.int32))
            for i, (pr, out) in enumerate(REQS)]
    for r in reqs:
        srv.submit(r)
    t, n, staged = 0.0, 0, None
    while any(r.finish_s is None for r in reqs):
        if scale and n == 5:
            staged = _stats(srv.stage_scale(_cfg(3, 2)).stats)
            srv.tick(t)
            t, n = t + .1, n + 1
            srv.switchover()
            assert srv.engine.num_slots == 6
            continue
        srv.tick(t)
        t, n = t + .1, n + 1
        assert n < 500
    _assert_copies_equal(srv.engine.cache, srv.engine.parallel)
    tokens = {str(r.rid): srv.engine.generated[r.rid] for r in reqs}
    final = _stats(srv.events[-1].stats) if scale else None
    return tokens, staged, final


def test_a_head_cutting_tp_server_scales_up_as_the_reference(ref_tp):
    """Two kv heads at tp = 4 (half a kv head a rank), paged KV, pooled
    pages, chunks of 16: DP1 x TP4 -> DP2 x TP4 at the 5th tick gives the
    reference server's greedy tokens and every byte field, staged and
    committed, and every TP rank's copy of the cache stays equal."""
    want = json.load(open(ref_tp / "serve.json"))["cut"]
    srv = ElasticServer(_mcfg(num_kv_heads=2), tp=4, batch_per_replica=2,
                        max_len=128, seed=0, all_devices=CPU8, device="cpu",
                        **CUT_SERVER)
    srv.boot(_cfg(1, 4), params=_tree(ref_tp / "serve_cut.npz"))
    reqs = [Request(i, 0.0, len(pr), out, prompt=np.asarray(pr, np.int32))
            for i, (pr, out) in enumerate(REQS)]
    for r in reqs:
        srv.submit(r)
    t, n, staged = 0.0, 0, None
    while any(r.finish_s is None for r in reqs):
        if n == 5:
            staged = _stats(srv.stage_scale(_cfg(2, 4)).stats)
            srv.tick(t)
            t, n = t + .1, n + 1
            srv.switchover()
            assert srv.engine.num_slots == 4
            continue
        srv.tick(t)
        t, n = t + .1, n + 1
        assert n < 500
    _assert_copies_equal(srv.engine.cache, srv.engine.parallel)
    assert {str(r.rid): srv.engine.generated[r.rid]
            for r in reqs} == want["tokens"]
    final = _stats(srv.events[-1].stats)
    assert staged == want["staged"] and final == want["final"]
    assert final["p2p_bytes"] > 0 and final["zero_copy_bytes"] > 0


@pytest.mark.parametrize("name", sorted(SERVERS))
def test_tp2_scale_up_equals_reference_and_unscaled(ref_tp, name):
    """tp = 2, DP2 -> DP3 at the 5th tick: the reference server's tokens
    and byte fields, and the tokens of an unscaled DP3 x TP2 run."""
    want = json.load(open(ref_tp / "serve.json"))[name]
    got, staged, final = _serve(name, _tree(ref_tp / f"serve_{name}.npz"),
                                scale=True)
    assert got == want["tokens"]
    assert staged == want["staged"] and final == want["final"]
    assert final["p2p_bytes"] > 0 and final["zero_copy_bytes"] > 0
    dp3 = ref_tp / f"serve_{name}_dp3.npz"
    params3 = _tree(dp3 if dp3.exists() else ref_tp / f"serve_{name}.npz")
    assert _serve(name, params3, scale=False, boot_dp=3)[0] == got


# ---------------------------------------------- dense KV, chunked prefill

def _dense_chunk():
    """The ``DENSE_CHUNK`` loop with the port's classes."""
    ns = {"np": np, "Request": Request, "stats": _stats}
    exec(DENSE_CHUNK, ns)
    return ns


def _dense_chunk_server(params, **kw):
    srv = ElasticServer(_mcfg(), all_devices=CPU8, device="cpu", **kw)
    srv.boot(_cfg(2, 2), params=params)
    return srv


@pytest.mark.parametrize("experts", ["dense", "pooled"])
def test_dense_kv_chunked_equals_reference_and_monolithic(ref_tp, experts):
    """Dense KV, chunks of 32 under a budget of 64, DP2 x TP2, dense banks
    or pooled pages: the reference server's greedy tokens, and the port's
    own monolithic run's (chunking only schedules); every TP rank's copy
    of the slot cache equal."""
    want = json.load(open(ref_tp / "serve.json"))["dchunk_" + experts]
    ns = _dense_chunk()
    params = _tree(ref_tp / f"dchunk_{experts}.npz")
    srv = _dense_chunk_server(params, expert_mode=experts, **ns["DC_KW"])
    got = ns["drive"](srv, ns["mixed_reqs"]())
    assert got == want["tokens"] and len(got["3"]) == 1
    _assert_copies_equal(srv.engine.cache, srv.engine.parallel)
    mono = _dense_chunk_server(params, expert_mode=experts,
                               **dict(ns["DC_KW"], prefill_chunk=0,
                                      prefill_budget=None))
    assert ns["drive"](mono, ns["mixed_reqs"]()) == got


def test_dense_kv_scale_up_mid_chunk_equals_reference(ref_tp):
    """DP2 x TP2 -> DP3 x TP2 opened while prompts are mid-chunk (serial
    staging, one advance a tick): the jobs go on chunking through the
    scale, and the tokens and every ``TransferStats.BYTE_FIELDS`` value
    equal the reference's."""
    want = json.load(open(ref_tp / "serve.json"))["dchunk_scale"]
    ns = _dense_chunk()
    srv = _dense_chunk_server(_tree(ref_tp / "dchunk_scale.npz"),
                              **ns["DC_SCALE_KW"])
    got = ns["scale_mid_chunk"](srv, _cfg(3, 2))
    assert got["tokens"] == want["tokens"]
    assert got["final"] == want["final"] and got["final"]["p2p_bytes"] > 0
    _assert_copies_equal(srv.engine.cache, srv.engine.parallel)


# ----------------------------------------------------------- what raises

@pytest.mark.parametrize("tp", [3, 8])
def test_an_mla_head_cutting_tp_raises(tp):
    """deepseek-v2-lite (4 heads at its reduced size) at a tp that cuts a
    head, which the port once refused: now the server and the HMM take it
    (the reference's rule: at tp = 3 q alone is cut, 64 of its 192
    columns a rank, and k_up, v_up and o stay whole; at tp = 8 every leaf
    is cut) and a forward on it gives the one-device logits.  The steps
    against the reference are ``tests/test_torch_scale_mla.py``'s."""
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b-smoke"),
                              num_experts=24, capacity_factor=100.0)
    assert cfg.use_mla and cfg.num_heads % tp
    ElasticServer(cfg, tp=tp, batch_per_replica=2, max_len=64,
                  all_devices=CPU8, device="cpu")
    one = HMM(cfg, 1, batch_per_replica=2, max_len=64, device="cpu")
    one.boot(ElasticConfig(1, 1, (0,)))
    hmm = HMM(cfg, tp, batch_per_replica=2, max_len=64, all_devices=CPU8,
              device="cpu")
    hmm.boot(_cfg(8 // tp, tp), params=one.params)
    attn = hmm.params["blocks"]["attn"]
    assert attn["q"]["w"].shard(0).shape[-1] == 4 * 48 // tp
    assert (attn["k_up"]["w"].shard(0).shape[-1] == 4 * 32) == (tp == 3)
    ctx = engine_parallel_ctx(make_instance_mesh(_cfg(8 // tp, tp), CPU8))
    tokens = torch.arange(0, 130, 10, dtype=torch.int32)[None]
    want = TM.forward(cfg, one.params, {"tokens": tokens})
    got = TM.forward(cfg, hmm.params, {"tokens": tokens}, parallel=ctx)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_a_vocab_that_does_not_split_stays_whole(tp):
    """vocab 130 at tp = 4 (130 % 4 != 0): the embedding and the LM head
    stay whole on every rank and give the one-device logits; at tp = 2 they
    split and give them too."""
    cfg = dataclasses.replace(DENSE, vocab_size=130)
    one = HMM(cfg, 1, batch_per_replica=2, max_len=32, device="cpu")
    one.boot(ElasticConfig(1, 1, (0,)))
    hmm = HMM(cfg, tp, batch_per_replica=2, max_len=32, all_devices=CPU8,
              device="cpu")
    hmm.boot(_cfg(2, tp), params=one.params)
    whole = tp == 4
    assert (hmm.params["embed"].shard(1).shape[0] == 130) == whole
    assert (hmm.params["lm_head"]["w"].shard(1).shape[1] == 130) == whole
    ctx = engine_parallel_ctx(make_instance_mesh(_cfg(2, tp), CPU8))
    tokens = torch.arange(0, 130, 10, dtype=torch.int32)[None]
    want = TM.forward(cfg, one.params, {"tokens": tokens})
    got = TM.forward(cfg, hmm.params, {"tokens": tokens}, parallel=ctx,
                     replica=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# ---------------------------------------------- plain versions, collectives

def _pools(gen, NB, bs, KVH, hd, int8):
    if int8:
        q = [torch.randint(-127, 128, (NB, bs, KVH, hd), generator=gen,
                           dtype=torch.int8) for _ in range(2)]
        s = [torch.rand(NB, bs, generator=gen) / 127 + 1e-3
             for _ in range(2)]
        return q[0], s[0], q[1], s[1]
    return (torch.randn(NB, bs, KVH, hd, generator=gen), None,
            torch.randn(NB, bs, KVH, hd, generator=gen), None)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("off,n", [(1, 1), (2, 2), (3, 1)])
def test_plain_head_offsets_equal_a_sliced_pool(off, n, int8):
    """Each plain decode and mixed attention at kv heads [off, off + n) of
    a 4-head pool equals the same plain version on those heads copied out
    (an int8 row's scale covering all four)."""
    gen = torch.Generator().manual_seed(off + 4 * n)
    NB, bs, KVH, hd, G = 12, 4, 4, 16, 2
    k, ks, v, vs = _pools(gen, NB, bs, KVH, hd, int8)
    cut = [t[:, :, off:off + n].contiguous() for t in (k, v)]
    bt = torch.randperm(NB, generator=gen)[:9].reshape(3, 3).int()
    lens = torch.tensor([3, 12, 7], dtype=torch.int32)
    q = torch.randn(3, n * G, hd, generator=gen)
    qm = torch.randn(3, 5, n * G, hd, generator=gen)
    ql = torch.tensor([3, 2, 1], dtype=torch.int32)
    rng = dict(kv_head_offset=off, kv_heads=n)
    if int8:
        pairs = [(ref.quant_block_paged_decode_attention_ref, (q,),
                  (bt, lens)),
                 (ref.quant_mixed_block_paged_attention_ref, (qm,),
                  (bt, lens, ql))]
        full, sliced = (k, ks, v, vs), (cut[0], ks, cut[1], vs)
    else:
        pairs = [(ref.block_paged_decode_attention_ref, (q,), (bt, lens)),
                 (ref.mixed_block_paged_attention_ref, (qm,),
                  (bt, lens, ql))]
        full, sliced = (k, v), tuple(cut)
    for fn, head, tail in pairs:
        assert torch.equal(fn(*head, *full, *tail, **rng),
                           fn(*head, *sliced, *tail))
    if not int8:
        kc, vc = torch.randn(2, 3, 12, KVH, hd, generator=gen)
        got = ref.paged_decode_attention_ref(q, kc, vc, lens, **rng)
        want = ref.paged_decode_attention_ref(
            q, kc[:, :, off:off + n].contiguous(),
            vc[:, :, off:off + n].contiguous(), lens)
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        ref.block_paged_decode_attention_ref(q, k, v, bt, lens,
                                             kv_head_offset=KVH - n + 1,
                                             kv_heads=n)


def test_tp_collectives_add_and_join_in_rank_order():
    """The sum adds rank 0 first, then 1, ... (f32: the order shows in the
    rounding) and every rank gets its own copy; the gather joins the parts
    in rank order and copies every part, also rank 0's and also where the
    ranks share a device."""
    devs = [torch.device("cpu")] * 3
    parts = [torch.tensor([1e8]), torch.tensor([-1e8]), torch.tensor([1.0])]
    out = tp_all_reduce(parts, devs)
    assert [float(t) for t in out] == [1.0] * 3
    assert len({t.data_ptr() for t in out}) == 3
    cat = tp_all_gather([torch.full((2, 1), float(i)) for i in range(3)],
                        devs, 1)
    assert cat[2].tolist() == [[0.0, 1.0, 2.0]] * 2
    assert cat[0].data_ptr() != cat[1].data_ptr()
    parts = [torch.full((2, 1), float(i)) for i in range(3)]
    whole = tp_gather(parts, devs, -1)
    assert whole.tolist() == [[0.0, 1.0, 2.0]] * 2
    assert all(whole.data_ptr() != t.data_ptr() for t in parts)
    one = torch.ones(2)
    assert tp_all_reduce([one], devs[:1])[0] is one
    assert tp_gather([one], devs[:1], 0) is one
