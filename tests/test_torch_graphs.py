"""The IMM's compile (CUDA graphs of the decode and chunk steps) and what
it rests on, on the CPU, where no graph is captured and the eager steps
serve.

The reference runs in one subprocess with 8 simulated host devices (as
``tests/helpers.run_with_devices`` runs it); its HMMs go DP2 -> DP3 -> DP2
(``TEST_MOE``, tp = 1, the paged KV pool with pooled pages, and the dense
stores), saving the boot weights and every ``TransferStats``.  Held:

* the chunk step fed ``start`` and ``length`` as [1] int32 tensors (as a
  graph reads them) against the reference's ``paged_chunk_prefill_step``
  at f32 within 1e-5, in process; the engine's chunk function returns the
  reference's greedy token as a tensor;
* ``begin_scale`` allocates every staged destination and new KV shard:
  ``commit`` adopts exactly the tensors ``staged_tensors`` handed out then
  (equal ``data_ptr``s, parameters and cache), up and down, serial and
  overlapped, while every byte field equals the reference's;
* the IMM's ``Binding`` refuses a parameter or cache tensor that changed;
  a server scaled up, down and up again captures each step set afresh over
  the new tensors, and ``activate`` over tensors the cached set was not
  built on counts a miss; an evicted instance drops its set; after a
  switchover, and after an aborted scale, every other set that names a
  tensor the live set does not hold is dropped, and a set whose tensors
  all live is kept and bound again on the way back;
* on the CPU ``activate`` returns the eager steps; the launch tally of a
  capture reaches the wrappers' counts only at replay.

The graphs themselves run on the card (``tests/test_torch_cuda.py``).
"""
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import TEST_MOE
from test_torch_scale import (COMMON, CPU8, DENSE, REQS, _mcfg, _start,
                              _stats, _tree, _wait)
from repro.core.hmm import HMM as JaxHMM
from repro.core.topology import ElasticConfig as JaxElasticConfig
from repro.models import model as JM
from repro_torch.convert import params_from_jax
from repro_torch.core.elastic_engine import ElasticServer
from repro_torch.core.graphs import Binding, CapturedStep
from repro_torch.core.hmm import HMM
from repro_torch.core.topology import ElasticConfig
from repro_torch.distributed.sharding import (ShardedTensor,
                                              tree_leaves_with_path)
from repro_torch.kernels import _build
from repro_torch.models import model as TM
from repro_torch.serving.engine import _paged_chunk_prefill_fn
from repro_torch.serving.workload import Request

TOL = dict(atol=1e-5, rtol=1e-5)
PAGED = dict(kv_mode="paged", kv_block_size=16, expert_mode="pooled")
HMM_CASES = {"paged": PAGED, "dense": {}}

SCRIPT = COMMON + '''
from repro.core.hmm import HMM, TransferStats
CASES = %s

def stats(st):
    return {f: int(getattr(st, f)) for f in TransferStats.BYTE_FIELDS}

res = {}
for name, kw in CASES.items():
    hmm = HMM(MCFG, tp=1, batch_per_replica=2, max_len=32, **kw)
    hmm.boot(cfg(2))
    np.savez(f"{OUT}/{name}.npz", **flat(hmm.params))
    r = {}
    for step, dp in (("up", 3), ("down", 2)):
        r[step + "_stage"] = stats(hmm.scale(cfg(dp)))
        r[step + "_commit"] = stats(hmm.commit())
    res[name] = r
json.dump(res, open(f"{OUT}/graphs.json", "w"))
print("GRAPHS-DONE")
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("graphs_ref")
    _wait(_start(SCRIPT % repr(HMM_CASES), out), "DP2 -> DP3 -> DP2")
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny steps: one intra-op thread (the suite runs several test
    workers on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(dp, tp=1):
    return ElasticConfig(dp, tp, tuple(range(dp * tp)))


# ------------------------------------------------------------ chunk step

@pytest.fixture(scope="module")
def one_device():
    """The reference's one-device pooled ``TEST_MOE`` parameters (numpy)
    and the port's copy."""
    ns = {}
    exec(TEST_MOE, ns)
    jcfg = ns["MCFG"]
    hmm = JaxHMM(jcfg, 1, batch_per_replica=2, max_len=64, seed=0,
                 kv_mode="paged", kv_block_size=8, expert_mode="pooled")
    hmm.boot(JaxElasticConfig(1, 1, (0,)))
    jp = _np_tree(hmm.params)
    return jcfg, jp, _mcfg(), params_from_jax(jp)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return np.asarray(tree)


def _jnp_tree(tree):
    if isinstance(tree, dict):
        return {k: _jnp_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jnp_tree(v) for v in tree]
    return jnp.asarray(tree)


@pytest.mark.parametrize("start,length", [(0, 13), (16, 30)])
def test_chunk_step_takes_start_and_length_as_tensors(one_device, start,
                                                      length):
    """``start`` and ``length`` as [1] int32 tensors: the logits row is
    gathered by a device index, the positions and lengths come from the
    tensors; logits and written rows equal the reference's within 1e-5,
    and the engine's chunk function returns its greedy token."""
    jcfg, jp, cfg, tp = one_device
    rng = np.random.default_rng(start + length)
    NB, bs, MB, C = 16, 8, 6, 16
    shape = (cfg.num_layers, NB, bs, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    cache = {n: rng.standard_normal(shape).astype(np.float32)
             for n in ("k", "v")}
    rows = np.array([4, 11, 2, 15, 8, 0], np.int32)
    nblk = -(-length // bs)
    bt = np.full((1, MB), NB, np.int32)
    bt[0, :nblk] = rows[:nblk]
    ids = np.full((C // bs,), NB, np.int32)
    for j in range(C // bs):
        if start // bs + j < nblk:
            ids[j] = rows[start // bs + j]
    tokens = np.zeros((1, C), np.int32)
    tokens[0, :length - start] = rng.integers(0, cfg.vocab_size,
                                              length - start)
    jl, jc = JM.paged_chunk_prefill_step(jcfg, _jnp_tree(jp), tokens,
                                         _jnp_tree(cache), np.int32(start),
                                         np.int32(length), bt, ids)
    args = [torch.from_numpy(a) for a in
            (tokens, np.array([start], np.int32),
             np.array([length], np.int32), bt, ids)]
    tc = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    tl, tc = TM.paged_chunk_prefill_step(cfg, tp, args[0], tc, *args[1:])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **TOL)
    tc = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    tok, _ = _paged_chunk_prefill_fn(cfg, tp, tc, *args)
    assert tok.dtype == torch.int32 and tok.shape == (1,)
    assert int(tok) == int(np.argmax(np.asarray(jl)[0]))


# -------------------------------------------- begin_scale's allocations

def _shard_ptrs(tree):
    """(leaf path, logical device or None) -> data_ptr."""
    out = {}
    for path, leaf in tree_leaves_with_path(tree):
        if isinstance(leaf, ShardedTensor):
            out.update({(path, d): t.data_ptr()
                        for d, t in leaf.shards.items()})
        else:
            out[(path, None)] = leaf.data_ptr()
    return out


@pytest.mark.parametrize("staging", ["serial", "overlap"])
@pytest.mark.parametrize("name", sorted(HMM_CASES))
def test_commit_adopts_the_tensors_made_at_begin_scale(ref, name, staging):
    """DP2 -> DP3 -> DP2: the target's parameters and cache handed out at
    ``begin_scale`` (before a byte moved) are the very tensors ``commit``
    installs; the byte fields equal the reference's, staged and
    committed."""
    want = json.load(open(ref / "graphs.json"))[name]
    hmm = HMM(_mcfg(), 1, batch_per_replica=2, max_len=32, all_devices=CPU8,
              device="cpu", staging=staging, transfer_workers=2,
              **HMM_CASES[name])
    hmm.boot(_cfg(2), params=_tree(ref / f"{name}.npz"))
    for step, dp in (("up", 3), ("down", 2)):
        hmm.begin_scale(_cfg(dp))
        _, _, params, cache = hmm.staged_tensors(hmm.cache)
        ptrs = (_shard_ptrs(params), _shard_ptrs(cache))
        if staging == "overlap":
            assert hmm.join_staging()
        else:
            while hmm.stage_increment():
                pass
        assert _stats(hmm.last_stats) == want[step + "_stage"]
        assert _stats(hmm.commit()) == want[step + "_commit"]
        assert (_shard_ptrs(hmm.params), _shard_ptrs(hmm.cache)) == ptrs
    hmm.close()


def test_staged_tensors_need_an_open_scale():
    hmm = HMM(_mcfg(), 1, batch_per_replica=2, max_len=32, all_devices=CPU8,
              device="cpu", **PAGED)
    hmm.boot(_cfg(2))
    with pytest.raises(RuntimeError, match="no scale"):
        hmm.staged_tensors(hmm.cache)
    hmm.begin_scale(_cfg(3))
    hmm.abort()
    with pytest.raises(RuntimeError, match="no scale"):
        hmm.staged_tensors(hmm.cache)
    hmm.close()


# ------------------------------------------------------------ the IMM

def _server(**kw):
    srv = ElasticServer(_mcfg(), tp=1, batch_per_replica=2, max_len=128,
                        seed=0, all_devices=CPU8, device="cpu",
                        prefill_chunk=32, prefill_budget=64,
                        prefill_buckets=(32,), **PAGED, **kw)
    srv.boot(_cfg(2))
    return srv


def _serve(srv, n=3):
    reqs = [Request(i, 0.0, len(pr), out, prompt=np.asarray(pr, np.int32))
            for i, (pr, out) in enumerate(REQS[:n])]
    for r in reqs:
        srv.submit(r)
    t = 0
    while any(r.finish_s is None for r in reqs):
        srv.tick(t * .1)
        t += 1
        assert t < 500
    return {r.rid: srv.engine.generated[r.rid] for r in reqs}


def test_binding_refuses_changed_tensors():
    srv = _server()
    inst = srv.imm._cache[srv.imm._key(_cfg(2))]
    params, cache = srv.engine.params, srv.engine.cache
    assert inst.binding.matches(params, cache)
    k = cache["k"]
    moved = dict(cache, k=ShardedTensor(
        k.shape, k.sharding, {d: t.clone() for d, t in k.shards.items()}))
    assert not inst.binding.matches(params, moved)
    assert not inst.binding.matches(params, {"k": k})
    # a fresh record of the new tensors holds them
    assert Binding(params, moved).matches(params, moved)
    srv.hmm.close()


def test_up_down_up_captures_afresh():
    """Each scale captures its target's set during staging over the staged
    tensors, and ``switchover`` binds it (a hit).  DP3 again after DP2:
    the cached DP3 set's tensors are gone, so it is captured anew; an
    ``activate`` over tensors the set was not built on is a miss."""
    srv = _server()
    imm = srv.imm
    st = imm.stats
    assert (st["captures"], st["preinit_misses"], st["preinit_hits"]) == \
        (1, 1, 0)
    bindings = []
    for n, dp in enumerate((3, 2, 3)):
        ev = srv.scale_to(_cfg(dp))
        assert ev.compile_hit, dp
        inst = imm._cache[imm._key(_cfg(dp))]
        assert inst.binding.matches(srv.engine.params, srv.engine.cache)
        assert srv.engine.compiled is inst.compiled
        bindings.append(inst.binding)
        assert (st["captures"], st["preinit_hits"]) == (n + 2, n + 1)
    assert st["preinit_misses"] == 1
    # the first DP3 record is refused: its tensors were freed at the
    # scale-down (the configuration's key is the same)
    assert bindings[0] is not bindings[2]
    assert not bindings[0].matches(srv.engine.params, srv.engine.cache)
    # staged and committed behind the IMM's back: activate captures anew
    srv.hmm.scale(_cfg(2))
    srv.hmm.commit(live_cache=srv.engine.cache)
    inst, params, cache, hit = imm.activate(_cfg(2))
    assert not hit and st["preinit_misses"] == 2 and st["captures"] == 5
    srv._bind(inst, params, cache)
    tokens = _serve(srv)
    assert all(len(t) == out for t, (_, out) in zip(tokens.values(), REQS))
    srv.hmm.close()


def _held_sets(srv):
    """This server's cached instances that hold a binding or graphs."""
    imm = srv.imm
    return {inst.cfg.dp for inst in imm._cache.values()
            if inst.owner == imm.owner
            and (inst.binding is not None or inst.graphs is not None)}


def test_a_scale_releases_the_sets_it_cannot_bind_again():
    """Pooled pages (the page-table index arrays are rebuilt at every
    scale): after a switchover (up, then down) only the live instance
    holds a binding (and, on the card, graphs): the source's set names
    tensors the scale freed.  A target staged and then aborted — by its
    task, and by ``HMM.abort`` under a blocking ``stage_scale`` — gives its
    set up too.  Every instance stays cached, so ``has`` keeps its
    answer."""
    srv = _server(staging="overlap")
    imm = srv.imm
    for dp in (3, 2):
        srv.scale_to(_cfg(dp))
        assert _held_sets(srv) == {dp}
        live = imm._cache[imm._key(_cfg(dp))]
        assert live.live and live.binding.matches(srv.engine.params,
                                                  srv.engine.cache)
        assert imm.has(_cfg(2)) and imm.has(_cfg(3))
    # the units wait for a gate, so the task is still STAGING once its
    # target's set is captured
    gate, unit = threading.Event(), srv.hmm._stage_unit

    def gated(*a, **k):
        assert gate.wait(timeout=300)
        return unit(*a, **k)
    srv.hmm._stage_unit = gated
    task = srv.start_scale(_cfg(3))
    while not imm.ready(_cfg(3)):
        task.advance(0.0)
    assert task.phase.name == "STAGING"
    assert _held_sets(srv) == {2, 3}        # the target, captured
    gate.set()
    task.abort()
    del srv.hmm._stage_unit
    assert _held_sets(srv) == {2} and imm.has(_cfg(3))
    srv.stage_scale(_cfg(3))
    assert _held_sets(srv) == {2, 3}
    srv.hmm.abort()
    srv._staged_cfg = None
    assert _held_sets(srv) == {2} and imm.has(_cfg(3))
    assert len(_serve(srv, 1)[0]) == REQS[0][1]
    srv.hmm.close()


def test_a_set_whose_tensors_all_live_is_kept_and_bound_again():
    """The dense test model with the default stores: DP2 -> DP3 reuses
    every parameter and cache tensor of DP2, so the DP2 set frees nothing
    and is kept; the way back down binds it again (no capture), and the
    DP3 set, which names the third replica's tensors, is released."""
    srv = ElasticServer(DENSE, tp=1, batch_per_replica=2, max_len=64,
                        seed=0, all_devices=CPU8, device="cpu",
                        prefill_buckets=(32,))
    srv.boot(_cfg(2))
    imm = srv.imm
    srv.scale_to(_cfg(3))
    assert _held_sets(srv) == {2, 3}
    srv.scale_to(_cfg(2))
    assert _held_sets(srv) == {2}
    assert imm.stats["captures"] == 2 and imm.stats["preinit_hits"] == 2
    srv.hmm.close()


def test_evicted_instance_drops_its_set():
    srv = _server()
    srv.imm.lru_capacity = 1
    boot = srv.imm._cache[srv.imm._key(_cfg(2))]
    assert boot.binding is not None
    srv.preinitialize(_cfg(3))
    assert srv.imm._key(_cfg(2)) not in srv.imm._cache
    assert boot.binding is None and boot.graphs is None
    # the engine keeps serving on the steps it holds
    assert len(_serve(srv, 1)[0]) == REQS[0][1]
    srv.hmm.close()


def test_cpu_activate_returns_the_eager_steps():
    srv = _server()
    inst = srv.imm._cache[srv.imm._key(_cfg(2))]
    assert not srv.imm.cuda_graphs and inst.graphs is None
    assert srv.engine.graphs is None
    assert srv.engine.compiled is inst.compiled
    eager = _server(cuda_graphs=False)
    assert _serve(srv) == _serve(eager)
    srv.hmm.close()
    eager.hmm.close()


def test_a_capture_tally_counts_at_replay():
    """Inside ``capturing`` a wrapper's launch goes to the tally (a
    capture launches nothing); each replay adds the tally to the
    wrapper's count."""
    def wrapper():
        pass
    wrapper.launches = 0
    with _build.capturing() as tally:
        _build.count_launch(wrapper)
        _build.count_launch(wrapper)
    assert wrapper.launches == 0 and tally.launches == {wrapper: 2}
    _build.count_launch(wrapper)
    assert wrapper.launches == 1

    class Replayed:
        replays = 0

        def replay(self):
            self.replays += 1
    g = Replayed()
    step = CapturedStep(g, torch.zeros(1), dict(tally.launches))
    step.replay()
    step.replay()
    assert g.replays == 2 and wrapper.launches == 5


def test_a_capture_never_grows_the_split_buffers():
    """A capture that finds a stream's split counters or workspace too
    small leaves them as they are (a zero fill captured into a graph would
    run only at its replays), records the sizes it needs and gets scratch;
    ``reserve`` then grows them, counters zeroed, outside the capture."""
    dev, stream = torch.device("cpu"), -7       # a key no kernel uses
    key = (dev.index, stream)
    try:
        done = _build.split_counters(dev, stream, 4)
        ws = _build.split_workspace(dev, stream, 8)
        with _build.capturing() as tally:
            assert _build.split_counters(dev, stream, 3) is done
            c = _build.split_counters(dev, stream, 24)
            w = _build.split_workspace(dev, stream, 40)
            _build.split_counters(dev, stream, 16)
        assert c.numel() == 24 and w.numel() == 40
        assert c is not done and w is not ws
        assert _build._counters[key] is done
        assert _build._workspaces[key] is ws
        assert tally.short == {(dev, stream): [24, 40]}
        _build.reserve(tally.short)
        grown = _build._counters[key]
        assert grown.numel() == 24 and not grown.any()
        assert _build._workspaces[key].numel() == 40
        with _build.capturing() as again:
            assert _build.split_counters(dev, stream, 24) is grown
        assert again.short == {}
    finally:
        _build._counters.pop(key, None)
        _build._workspaces.pop(key, None)
