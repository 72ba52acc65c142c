"""The port's elastic scale path against the reference, on the CPU.

The reference runs in two subprocesses with 8 simulated host devices (as
``tests/helpers.run_with_devices`` runs it), started together once per
module; they write their parameters, outputs, ``TransferStats`` and
``Migration`` lists to ``tmp_path`` (``np.savez`` and JSON).  The port runs
in this process on ``[cpu] * 8`` logical devices, from the reference's own
parameters (``convert.params_from_jax``).  Held:

* the HMM's scale path: every ``TransferStats.BYTE_FIELDS`` value equal
  the reference's, after staging and after commit, for ``TEST_MOE`` with
  dense banks at tp = 2 (DP2 -> DP3), the dense test model of
  ``test_hmm_bytes_match_planner``, pooled bf16 pages and pooled int8
  pages with their scales (DP4 -> DP6 at tp = 1), and an HMM-level DP3 ->
  DP2 with commit (pooled pages and dense banks) and with abort (then
  staged again); the pooled ``Migration`` list equal entry for entry,
  ``expert_p2p_bytes == len(migrations) * page`` and no expert bytes at
  commit; reused shards the same tensors (``data_ptr``) and staged values
  equal to the active ones;
* ``moe_ep`` against the reference's at f32 within 1e-5 for n_ep 2, 4, 6
  over dense banks and pooled pages (a min-move placement, and 20 experts
  over 6 devices with pad slots), and over dense banks through the packed
  dispatch (``ParallelCtx.moe_dispatch="packed"``), T = 15 rows (not a
  multiple of n_ep), with and without capacity drops; without drops also
  against the port's ``moe_local``;
* ``ElasticServer`` at tp = 1, DP2 -> DP3 at the 5th tick (``stage_scale``,
  one tick, ``switchover``): greedy tokens equal the reference server's
  tokens and an unscaled DP3 run of the port, with the paged KV pool,
  pooled pages and chunked prefill, with the default stores (dense KV,
  dense banks, monolithic prefill), and with the int8 KV blocks and expert
  pages; at capacity factor 1.25, where routed entries are dropped, equal
  the reference server's tokens.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from helpers import REPO, TEST_MOE
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.elastic_engine import ElasticServer
from repro_torch.core.hmm import HMM, TransferStats
from repro_torch.core.topology import ElasticConfig
from repro_torch.distributed.sharding import (NamedSharding, ParallelCtx,
                                              ShardedTensor,
                                              make_instance_mesh)
from repro_torch.models import moe as TMoE
from repro_torch.serving.workload import Request

CPU8 = [torch.device("cpu")] * 8
TOL = dict(atol=1e-5, rtol=1e-5)

COMMON = TEST_MOE + '''
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import ModelConfig
from repro.core.topology import ElasticConfig
OUT = sys.argv[1]
DENSE = ModelConfig(name="dense-t", arch_type="dense", num_layers=2,
                    d_model=64, vocab_size=128, num_heads=4, num_kv_heads=4,
                    head_dim=16, d_ff=128, dtype="float32")

def cfg(dp, tp=1):
    return ElasticConfig(dp, tp, tuple(range(dp * tp)))

def flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            key, a = key + "|bf16", a.view(np.uint16)
        out[key] = a
    return out
'''

HMM_SCRIPT = COMMON + '''
from repro.core.hmm import HMM, TransferStats
from repro.core.expert_pages import ExpertPageTable, pooled_layout
from repro.distributed.sharding import ParallelCtx
from repro.models.moe import moe_ep, moe_init
from jax.sharding import Mesh

def stats(st):
    return {f: int(getattr(st, f)) for f in TransferStats.BYTE_FIELDS}

res = {}
HMM_CASES = %s
for name, (model, tp, dp0, dp1, kw, mode) in HMM_CASES.items():
    mcfg = {"moe": MCFG, "moe_bf16": dataclasses.replace(MCFG,
            dtype="bfloat16"), "dense": DENSE}[model]
    hmm = HMM(mcfg, tp=tp, batch_per_replica=2, max_len=32, **kw)
    hmm.boot(cfg(dp0, tp))
    np.savez(f"{OUT}/{name}.npz", **flat(hmm.params))
    r = {}
    if mode == "abort":
        hmm.begin_scale(cfg(dp1, tp))
        hmm.stage_increment()
        hmm.stage_increment()
        hmm.abort()
        hmm.abort()
        r["after_abort"] = {d: hmm.page_table.pages_in_use(d)
                            for d in range(dp0 * tp)}
    r["stage"] = stats(hmm.scale(cfg(dp1, tp)))
    if hmm.last_migrations is not None:
        r["migrations"] = [[m.layer, m.expert, m.src.device, m.src.page,
                            m.dst.device, m.dst.page]
                           for m in hmm.last_migrations]
    r["commit"] = stats(hmm.commit())
    r["final"] = stats(hmm.last_stats)
    res[name] = r

outs = {}
for E, n, cf, pooled in %s:
    mcfg = dataclasses.replace(MCFG, num_experts=E, capacity_factor=cf)
    p = moe_init(jax.random.PRNGKey(0), mcfg, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (3, 5, mcfg.d_model))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(n, 1), ("dp", "tp"))
    ctx = ParallelCtx(mesh=mesh, ep_axes=("dp", "tp"), tp_axis="tp",
                      dp_axes=("dp",), moe_tp=False,
                      moe_dispatch="packed" if pooled == "packed"
                      else "expert_slots")
    key = f"{E}_{n}_{cf}_{pooled}"
    outs[key + "/x"] = np.asarray(x)
    for k in ("wi", "wg", "wo"):
        outs[key + "/" + k] = np.asarray(p[k])
    outs[key + "/router"] = np.asarray(p["router"]["w"])
    if pooled in (False, "packed"):
        y = jax.jit(lambda p, x: moe_ep(mcfg, p, x, ctx)[0])(p, x)
    else:
        # a min-move placement: booted on 4 devices, remapped to n
        ppd = 2 * E
        t = ExpertPageTable(1, E, pool_pages_per_device=ppd)
        t.initial_place(cfg(4))
        if n != 4:
            t.stage_remap(cfg(n), min_move=True)
            t.commit()
        lay = pooled_layout(t.active, cfg(n), 1, E, ppd)
        pool = {k: np.zeros((n * ppd,) + p[k].shape[1:], np.float32)
                for k in ("wi", "wg", "wo")}
        for (l, e), ref in t.active.items():
            for k in pool:
                pool[k][ref.device * ppd + ref.page] = np.asarray(p[k][e])
        pp = {"router": p["router"]}
        for k in ("tables", "edest", "eslot", "gtable"):
            pp[k] = jnp.asarray(lay[k][0])
            outs[key + "/" + k] = lay[k][0]
        for k in pool:
            outs[key + "/pool_" + k] = pool[k]
        y = jax.jit(lambda pp, x, pool: moe_ep(mcfg, pp, x, ctx,
                                               pool=pool)[0])(
            pp, x, {k: jnp.asarray(v) for k, v in pool.items()})
    outs[key + "/y"] = np.asarray(y)
np.savez(f"{OUT}/moe_ep.npz", **outs)
json.dump(res, open(f"{OUT}/hmm.json", "w"))
print("HMM-DONE")
'''

# a server booted on one device, run by the reference's script and by the
# test alike: DP1 -> DP2 staged at tick 5 and switched over after one
# tick, then a drain back to DP1 opened at tick 12 and advanced once after
# every tick
DRIVE_ONE = '''
def drive_one(srv, reqs, cfg):
    for r in reqs:
        srv.submit(r)
    t, n, task = 0.0, 0, None
    while any(r.finish_s is None for r in reqs) or (
            task is not None and not task.done):
        if n == 5:
            srv.stage_scale(cfg(2))
            srv.tick(t)
            t, n = t + .1, n + 1
            srv.switchover()
            continue
        if n == 12:
            task = srv.start_scale(cfg(1))
        srv.tick(t)
        t, n = t + .1, n + 1
        if task is not None and not task.done:
            task.advance(t)
        assert n < 800
    return {"tokens": {str(r.rid): [int(x) for x in srv.engine.generated[
                r.rid]] for r in reqs},
            "events": [[e.src, e.dst, {f: int(getattr(e.stats, f))
                                       for f in e.stats.BYTE_FIELDS}]
                       for e in srv.events]}
'''

SERVE_SCRIPT = COMMON + DRIVE_ONE + '''
from repro.core.elastic_engine import ElasticServer
from repro.core.hmm import HMM
from repro.serving.workload import Request
SERVERS = %s
REQS = %s
res = {}
for name, kw in SERVERS.items():
    mcfg = dataclasses.replace(MCFG, **kw.pop("model", {}))
    srv = ElasticServer(mcfg, tp=1, batch_per_replica=2, max_len=128,
                        seed=0, **kw)
    srv.boot(cfg(2))
    np.savez(f"{OUT}/serve_{name}.npz", **flat(srv.hmm.params))
    if kw.get("expert_mode") == "pooled":
        # the same weights in the DP3 boot's page layout
        hmm = HMM(mcfg, tp=1, batch_per_replica=2, max_len=128, seed=0,
                  **{k: v for k, v in kw.items()
                     if k not in ("prefill_buckets", "prefill_chunk",
                                  "prefill_budget")})
        hmm.boot(cfg(3))
        np.savez(f"{OUT}/serve_{name}_dp3.npz", **flat(hmm.params))
    reqs = [Request(i, 0.0, len(pr), out, prompt=np.asarray(pr, np.int32))
            for i, (pr, out) in enumerate(REQS)]
    for r in reqs:
        srv.submit(r)
    t, n = 0.0, 0
    while any(r.finish_s is None for r in reqs):
        if n == 5:
            srv.stage_scale(cfg(3))
            srv.tick(t); t += .1; n += 1
            srv.switchover()
            continue
        srv.tick(t); t += .1; n += 1
        assert n < 500
    res[name] = {str(r.rid): srv.engine.generated[r.rid] for r in reqs}
for name, kw in %s.items():
    srv = ElasticServer(MCFG, tp=1, batch_per_replica=2, max_len=128,
                        seed=0, **kw)
    srv.boot(cfg(1))
    np.savez(f"{OUT}/serve_{name}.npz", **flat(srv.hmm.params))
    res[name] = drive_one(srv, [
        Request(i, 0.0, len(pr), out, prompt=np.asarray(pr, np.int32))
        for i, (pr, out) in enumerate(REQS)], cfg)
json.dump(res, open(f"{OUT}/serve.json", "w"))
print("SERVE-DONE")
'''

# name: (model, tp, from dp, to dp, HMM knobs, mode)
PAGED = dict(kv_mode="paged", kv_block_size=16, expert_mode="pooled")
HMM_CASES = {
    "moe_tp2": ("moe", 2, 2, 3, {}, "commit"),
    "dense_tp2": ("dense", 2, 2, 3, {}, "commit"),
    "pooled_bf16": ("moe_bf16", 1, 4, 6, PAGED, "commit"),
    "pooled_int8": ("moe", 1, 4, 6, dict(PAGED, kv_dtype="int8",
                                         expert_dtype="int8"), "commit"),
    "down_pooled": ("moe", 1, 3, 2, PAGED, "commit"),
    "down_dense": ("moe", 1, 3, 2, {}, "commit"),
    "down_abort": ("moe", 1, 3, 2, PAGED, "abort"),
    # one device on either side: its plain tensors as shards indexed
    # slice(None), so the commit zeroes the KV, as the reference's does
    "one_up_pooled": ("moe", 1, 1, 2, PAGED, "commit"),
    "one_down_pooled": ("moe", 1, 2, 1, PAGED, "commit"),
    "one_up_dense": ("moe", 1, 1, 2, {}, "commit"),
    "one_down_dense": ("moe", 1, 2, 1, {}, "commit"),
}
# (experts, n_ep, capacity factor, store): dense banks (False), pooled
# pages (True), or dense banks through the packed dispatch ("packed"; 12,
# 6 and 4 local experts against top-2, and at capacity factor 0.5 entries
# dropped on every n_ep)
MOE_CASES = [(24, n, cf, pooled) for n in (2, 4, 6) for cf in (100.0, 1.0)
             for pooled in (False, True)] + [(20, 6, cf, True)
                                             for cf in (100.0, 1.0)] + [
    (24, n, cf, "packed") for n in (2, 4, 6) for cf in (100.0, 0.5)]
CHUNKED = dict(PAGED, prefill_chunk=32, prefill_budget=64,
               prefill_buckets=(32,))
SERVERS = {
    "paged": CHUNKED,
    "paged_drops": dict(CHUNKED, model={"capacity_factor": 1.25}),
    "defaults": dict(prefill_buckets=(32, 64)),
    "int8": dict(CHUNKED, kv_dtype="int8", expert_dtype="int8"),
}
# servers booted on one device (``DRIVE_ONE``); the paged one drains its
# scale-down (a migration's copies land at times a loop cannot fix)
ONE_SERVERS = {
    "one_paged": dict(CHUNKED, scaledown="drain"),
    "one_defaults": dict(prefill_buckets=(32, 64)),
}
_rng = np.random.default_rng(0)
REQS = [(_rng.integers(0, 128, n).tolist(), out)
        for n, out in zip([10, 37, 16, 23, 30, 45], [20, 12, 24, 9, 15, 18])]


# the reference subprocess's XLA: 8 simulated host devices, each op on one
# thread (an XLA CPU client otherwise sizes its Eigen pool to the whole
# host, and these processes run beside the suite's test workers)
REF_XLA_FLAGS = ("--xla_force_host_platform_device_count=8 "
                 "--xla_cpu_multi_thread_eigen=false "
                 "intra_op_parallelism_threads=1")
REF_TIMEOUT_S = 600


def _start(script, out):
    env = dict(os.environ, XLA_FLAGS=REF_XLA_FLAGS, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen([sys.executable, "-c", script, str(out)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    proc.started = time.perf_counter()
    return proc


def _wait(proc, what):
    """The reference's standard output, or an error with its rc (or the
    seconds it ran before its time ran out: then it is killed and reaped,
    so it holds no core for the rest of the run) and its stderr's tail."""
    try:
        out, err = proc.communicate(timeout=REF_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(
            f"reference {what} did not finish in {REF_TIMEOUT_S} s (killed "
            f"after {time.perf_counter() - proc.started:.0f} s since its "
            f"start)\n{out[-2000:]}\n{err[-4000:]}") from None
    if proc.returncode != 0:
        raise AssertionError(f"reference {what} failed (rc="
                             f"{proc.returncode}, after "
                             f"{time.perf_counter() - proc.started:.0f} s)"
                             f"\n{out}\n{err[-4000:]}")
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Both reference subprocesses, started together."""
    out = tmp_path_factory.mktemp("scale_ref")
    procs = [
        (_start(HMM_SCRIPT % (repr(HMM_CASES), repr(MOE_CASES)), out),
         "HMM and moe_ep"),
        (_start(SERVE_SCRIPT % (repr(SERVERS), repr(REQS),
                                repr(ONE_SERVERS)), out), "servers")]
    for proc, what in procs:
        _wait(proc, what)
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The steps are tiny: one intra-op thread (the suite runs several
    test workers on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(path):
    """An ``np.savez`` of ``flat`` paths -> the nested parameter tree."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            a = z[key]
            name = key
            if key.endswith("|bf16"):
                import ml_dtypes
                name, a = key[:-5], a.view(ml_dtypes.bfloat16)
            node, parts = tree, name.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = a
    return params_from_jax(tree)


def _mcfg(**kw):
    ns = {}
    exec(TEST_MOE, ns)
    return ModelConfig(**dataclasses.asdict(
        dataclasses.replace(ns["MCFG"], **kw)))


DENSE = ModelConfig(name="dense-t", arch_type="dense", num_layers=2,
                    d_model=64, vocab_size=128, num_heads=4, num_kv_heads=4,
                    head_dim=16, d_ff=128, dtype="float32")


def _cfg(dp, tp=1):
    return ElasticConfig(dp, tp, tuple(range(dp * tp)))


def _stats(st):
    return {f: int(getattr(st, f)) for f in TransferStats.BYTE_FIELDS}


def _hmm(name):
    model, tp, dp0, dp1, kw, mode = HMM_CASES[name]
    mcfg = {"moe": _mcfg(), "moe_bf16": _mcfg(dtype="bfloat16"),
            "dense": DENSE}[model]
    return HMM(mcfg, tp, batch_per_replica=2, max_len=32,
               all_devices=CPU8, device="cpu", **kw), tp, dp0, dp1, mode


def _ptrs(tree):
    out = {}
    stack = [tree]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack += t.values()
        elif isinstance(t, ShardedTensor):
            out.update({(id(t), d): s.data_ptr() for d, s in t.shards.items()})
    return out


# ---------------------------------------------------------------- the HMM

@pytest.mark.parametrize("name", sorted(HMM_CASES))
def test_hmm_bytes_equal_reference(ref, name):
    """Every byte field equal the reference's, staged and committed; the
    pooled stores' migrations equal entry for entry, and an abort returns
    the pools to the reference's state."""
    want = json.load(open(ref / "hmm.json"))[name]
    hmm, tp, dp0, dp1, mode = _hmm(name)
    hmm.boot(_cfg(dp0, tp), params=_tree(ref / f"{name}.npz"))
    if mode == "abort":
        hmm.begin_scale(_cfg(dp1, tp))
        hmm.stage_increment()
        hmm.stage_increment()
        hmm.abort()
        hmm.abort()                             # idempotent
        got = {str(d): hmm.page_table.pages_in_use(d)
               for d in range(dp0 * tp)}
        assert got == want["after_abort"]
        assert hmm.page_table.staged is None and hmm.staged is None
    assert _stats(hmm.scale(_cfg(dp1, tp))) == want["stage"]
    page = hmm.expert_page_nbytes()
    if "migrations" in want:
        migs = [[m.layer, m.expert, m.src.device, m.src.page, m.dst.device,
                 m.dst.page] for m in hmm.last_migrations]
        assert migs == want["migrations"] and migs
        assert want["stage"]["expert_p2p_bytes"] == len(migs) * page
    assert _stats(hmm.commit()) == want["commit"]
    assert want["commit"]["expert_p2p_bytes"] == 0
    assert _stats(hmm.last_stats) == want["final"]
    assert hmm.active_cfg == _cfg(dp1, tp)


def test_hmm_zero_copy_aliasing_and_equality(ref):
    """tp = 2, DP2 -> DP3: the four surviving devices' q shards are the
    same tensors, and every staged leaf holds the active values."""
    hmm, tp, dp0, dp1, _ = _hmm("moe_tp2")
    hmm.boot(_cfg(dp0, tp), params=_tree(ref / "moe_tp2.npz"))
    _, _, params0, _ = hmm.attach_active()
    q0 = params0["blocks"]["attn"]["q"]["w"]
    ptrs = {d: s.data_ptr() for d, s in q0.shards.items()}
    st = hmm.scale(_cfg(dp1, tp))
    _, _, nparams, _ = hmm.attach_staged()
    q1 = nparams["blocks"]["attn"]["q"]["w"]
    assert sum(q1.shard(d).data_ptr() == p for d, p in ptrs.items()) == 4
    assert len({s.data_ptr() for s in q1.shards.values()}) == 6
    stack = [(params0, nparams)]
    while stack:
        a, b = stack.pop()
        if isinstance(a, dict):
            stack += [(a[k], b[k]) for k in a]
        else:
            torch.testing.assert_close(b.gather(), a.gather(), rtol=0,
                                       atol=0)
    assert st.zero_copy_bytes > 0 and st.p2p_bytes > 0


def test_hmm_bytes_match_planner(ref):
    """The dense model growing 4 -> 6 devices: p2p bytes are exactly the
    two new devices' shards, nothing is assembled locally, and every byte
    resident on a surviving device is reused zero-copy."""
    hmm, tp, dp0, dp1, _ = _hmm("dense_tp2")
    hmm.boot(_cfg(dp0, tp), params=_tree(ref / "dense_tp2.npz"))
    resident = sum(s.nbytes for leaf in _leaves(hmm.params)
                   for s in leaf.shards.values())
    st = hmm.scale(_cfg(dp1, tp))
    mesh6 = make_instance_mesh(_cfg(dp1, tp), CPU8)
    want = 0
    for path, leaf in _paths(hmm.params):
        sh = hmm.param_sharding(path, leaf.shape, mesh6)
        for dev, idx in sh.devices_indices_map(leaf.shape).items():
            if dev in (4, 5):
                n = leaf.dtype.itemsize
                for d, sl in zip(leaf.shape, idx):
                    n *= len(range(*sl.indices(d)))
                want += n
    assert st.p2p_bytes == want
    assert st.local_bytes == 0
    assert st.zero_copy_bytes == resident


def _paths(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _leaves(tree):
    return [leaf for _, leaf in _paths(tree)]


def test_pooled_scale_reuses_survivor_pools_and_moves_pages(ref):
    """DP4 -> DP6 min-move: the survivors' pool slices are the same
    tensors (they take no page: each is over its new capacity), and each
    migrated page lands bit for bit at its staged page."""
    hmm, tp, dp0, dp1, _ = _hmm("pooled_bf16")
    hmm.boot(_cfg(dp0), params=_tree(ref / "pooled_bf16.npz"))
    pool0 = hmm.params["moe_pool"]["wi"]
    ptrs = {d: s.data_ptr() for d, s in pool0.shards.items()}
    hmm.scale(_cfg(dp1))
    pool1 = hmm.attach_staged()[2]["moe_pool"]["wi"]
    assert all(pool1.shard(d).data_ptr() == p for d, p in ptrs.items())
    for m in hmm.last_migrations:
        torch.testing.assert_close(pool1.shard(m.dst.device)[m.dst.page],
                                   pool0.shard(m.src.device)[m.src.page],
                                   rtol=0, atol=0)
    hmm.commit()
    E = hmm.mcfg.num_experts
    for layer in range(hmm.mcfg.num_layers):
        sizes = sorted(len(v) for v in hmm.page_table.owners(layer).values())
        assert sizes == [E // dp1] * dp1


def test_forward_on_a_replica_equals_one_device(ref):
    """``forward`` with ``parallel`` (the batch on replica 3 of DP4, the
    MoE expert-parallel over the 4 devices) gives the one-device logits
    (no capacity drops)."""
    from repro_torch.models import model as TM
    from repro_torch.serving.engine import engine_parallel_ctx
    params = _tree(ref / "moe_tp2.npz")
    one = HMM(_mcfg(), 1, batch_per_replica=2, max_len=32, device="cpu")
    one.boot(_cfg(1), params=params)
    dp = HMM(_mcfg(), 1, batch_per_replica=2, max_len=32,
             all_devices=CPU8, device="cpu")
    dp.boot(_cfg(4), params=params)
    ctx = engine_parallel_ctx(make_instance_mesh(_cfg(4), CPU8))
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, 128, (2, 13)).astype(np.int32))
    want = TM.forward(one.mcfg, one.params, {"tokens": tokens})
    got = TM.forward(dp.mcfg, dp.params, {"tokens": tokens}, parallel=ctx,
                     replica=3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_a_missing_logical_device_raises():
    hmm = HMM(_mcfg(), 1, batch_per_replica=2, max_len=32,
              all_devices=CPU8[:3], device="cpu")
    with pytest.raises(ValueError, match="not in all_devices"):
        hmm.boot(_cfg(4))


# ------------------------------------------------------------------ moe_ep

def _moe_inputs(ref, case):
    E, n, cf, pooled = case
    key = f"{E}_{n}_{cf}_{pooled}"
    with np.load(ref / "moe_ep.npz") as z:
        get = {k[len(key) + 1:]: z[k] for k in z.files
               if k.startswith(key + "/")}
    mcfg = _mcfg(num_experts=E, capacity_factor=cf)
    mesh = make_instance_mesh(_cfg(n), CPU8)
    ctx = ParallelCtx(devices=mesh.devices, dp=n, tp=1,
                      all_devices=mesh.all_devices,
                      moe_dispatch="packed" if pooled == "packed"
                      else "expert_slots")

    def shard(a, spec=()):
        return ShardedTensor.from_tensor(torch.from_numpy(a),
                                         NamedSharding(mesh, spec))
    ep = (("dp", "tp"),)
    p = {"router": {"w": shard(get["router"])}}
    pool = None
    if pooled is True:
        p.update(tables=shard(get["tables"], ep), edest=shard(get["edest"]),
                 eslot=shard(get["eslot"]), gtable=shard(get["gtable"]))
        pool = {k: shard(get["pool_" + k], ep) for k in ("wi", "wg", "wo")}
    else:
        p.update({k: shard(get[k], ep) for k in ("wi", "wg", "wo")})
    return mcfg, ctx, p, pool, get


@pytest.mark.parametrize("case", MOE_CASES,
                         ids=[f"E{E}-ep{n}-cf{cf:g}-"
                              f"{ {False: 'dense', True: 'pooled'}.get(p, p)}"
                              for E, n, cf, p in MOE_CASES])
def test_moe_ep_matches_reference(ref, case):
    mcfg, ctx, p, pool, get = _moe_inputs(ref, case)
    x = torch.from_numpy(get["x"])
    y = TMoE.moe_ep(mcfg, p, x, ctx, pool=pool)
    np.testing.assert_allclose(y.numpy(), get["y"], **TOL)
    # the same rows given as the replicas' groups, each on its device
    groups = TMoE.moe_ep(mcfg, p, [x[:2], x[2:]], ctx, pool=pool)
    np.testing.assert_allclose(torch.cat(groups).numpy(), get["y"], **TOL)


@pytest.mark.parametrize("n", [2, 4, 6])
def test_moe_ep_matches_local(ref, n):
    """No drops: expert parallelism changes nothing of the result."""
    mcfg, ctx, p, _, get = _moe_inputs(ref, (24, n, 100.0, False))
    x = torch.from_numpy(get["x"])
    dense = {"router": {"w": torch.from_numpy(get["router"])},
             **{k: torch.from_numpy(get[k]) for k in ("wi", "wg", "wo")}}
    y_ref = TMoE.moe_local(mcfg, dense, x.reshape(-1, mcfg.d_model),
                           capacity=x.shape[0] * x.shape[1] * mcfg.top_k)
    y_ep = TMoE.moe_ep(mcfg, p, x, ctx, capacity=15 * mcfg.top_k)
    np.testing.assert_allclose(y_ep.reshape(-1, mcfg.d_model).numpy(),
                               y_ref.numpy(), **TOL)


# ----------------------------------------------------------------- servers

def _serve(name, params, scale, boot_dp=2):
    kw = dict(SERVERS[name])
    mcfg = _mcfg(**kw.pop("model", {}))
    srv = ElasticServer(mcfg, tp=1, batch_per_replica=2, max_len=128, seed=0,
                        all_devices=CPU8, device="cpu", **kw)
    srv.boot(_cfg(boot_dp), params=params)
    reqs = [Request(i, 0.0, len(pr), out, prompt=np.asarray(pr, np.int32))
            for i, (pr, out) in enumerate(REQS)]
    for r in reqs:
        srv.submit(r)
    t, n = 0.0, 0
    while any(r.finish_s is None for r in reqs):
        if scale and n == 5:
            ev = srv.stage_scale(_cfg(3))
            assert ev.stats is srv.hmm.last_stats
            srv.tick(t)
            t, n = t + .1, n + 1
            srv.switchover()
            assert srv.engine.num_slots == 6 and ev.switch_s > 0
            continue
        srv.tick(t)
        t, n = t + .1, n + 1
        assert n < 500
    if srv.hmm.kv_blocks is not None:
        srv.hmm.kv_blocks.check_invariants()
        assert srv.hmm.kv_blocks.num_partitions == (3 if scale else boot_dp)
    return {str(r.rid): srv.engine.generated[r.rid] for r in reqs}


@pytest.mark.parametrize("name", sorted(SERVERS))
def test_scale_up_tokens_equal_unscaled_and_reference(ref, name):
    """Equal to the reference's tokens; without capacity drops also to an
    unscaled DP3 run (with drops, which entries drop depends on the batch,
    and the unscaled run admits the last two requests five ticks
    earlier)."""
    want = json.load(open(ref / "serve.json"))[name]
    got = _serve(name, _tree(ref / f"serve_{name}.npz"), scale=True)
    assert got == want
    if "model" in SERVERS[name]:
        return
    dp3 = ref / f"serve_{name}_dp3.npz"
    params3 = _tree(dp3 if dp3.exists() else ref / f"serve_{name}.npz")
    assert _serve(name, params3, scale=False, boot_dp=3) == got


@pytest.mark.parametrize("name", sorted(ONE_SERVERS))
def test_one_device_server_scales_up_and_drains_as_the_reference(ref, name):
    """A server booted on one device, scaled DP1 -> DP2 while it serves
    and drained back to DP1: the greedy tokens and both events' byte
    fields equal the reference's.  Each commit zeroes the KV of the
    sequences it keeps (a DP1 cache shard is keyed whole, a DP2 one by
    replica), in both packages, so the scale-up's ``init_bytes`` are both
    replicas' KV; the server ends on plain tensors and one-device
    steps."""
    want = json.load(open(ref / "serve.json"))[name]
    ns = {}
    exec(DRIVE_ONE, ns)
    srv = ElasticServer(_mcfg(), tp=1, batch_per_replica=2, max_len=128,
                        seed=0, all_devices=CPU8, device="cpu",
                        **ONE_SERVERS[name])
    srv.boot(_cfg(1), params=_tree(ref / f"serve_{name}.npz"))
    kv_dp1 = sum(t.nbytes for t in srv.engine.cache.values())
    reqs = [Request(i, 0.0, len(pr), out, prompt=np.asarray(pr, np.int32))
            for i, (pr, out) in enumerate(REQS)]
    got = json.loads(json.dumps(ns["drive_one"](srv, reqs, _cfg)))
    assert got == want
    assert got["events"][0][2]["init_bytes"] == 2 * kv_dp1
    assert srv.current_config() == _cfg(1) and srv.engine.parallel is None
    assert not isinstance(srv.hmm.params["lm_head"]["w"], ShardedTensor)


def test_server_refuses_what_is_not_ported(ref):
    """A VLM (a ``Request`` carries no image), an encoder (no decode) and
    a sliding window (its steps run on one device only, so the server
    could not scale) are refused at construction, naming why; a scale to
    another tp is refused (as in the reference) with nothing staged.
    Scaling to or from
    one device is ported (``test_one_device_server_scales_up_and_drains_
    as_the_reference``), and so are a server scale-down
    (``tests/test_torch_scaledown.py``) and any tp > 1, also one that
    cuts a kv head (``tests/test_torch_tp.py``) or an MLA head
    (``tests/test_torch_scale_mla.py``)."""
    from repro_torch.configs import get_config
    for name, why in (("llama-3.2-vision-11b-smoke", "no image"),
                      ("hubert-xlarge-smoke", "encoder-only")):
        with pytest.raises(NotImplementedError, match=why):
            ElasticServer(get_config(name), tp=1, batch_per_replica=2,
                          max_len=128, all_devices=CPU8, device="cpu")
    with pytest.raises(NotImplementedError, match="sliding window"):
        ElasticServer(_mcfg(attn_window=8), tp=1, batch_per_replica=2,
                      max_len=128, all_devices=CPU8, device="cpu")
    srv = ElasticServer(_mcfg(), tp=1, batch_per_replica=2, max_len=128,
                        all_devices=CPU8, device="cpu",
                        prefill_buckets=(32, 64))
    srv.boot(_cfg(3), params=_tree(ref / "serve_defaults.npz"))
    with pytest.raises(ValueError, match="TP is fixed"):
        srv.stage_scale(_cfg(1, 2))
    assert srv.hmm.staged is None and srv.engine.admit_limit is None
