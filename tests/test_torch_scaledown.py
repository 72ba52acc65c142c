"""A server scale-down while it serves — live KV migration and drain —
against the reference, on the CPU.

The reference runs in one subprocess with 8 simulated host devices (as
``tests/helpers.run_with_devices`` runs it), started once for the module:
its ``ElasticServer`` at tp = 2 boots on DP3 x TP2, serves, and at a
fixed tick opens ``start_scale`` toward DP2 x TP2; the port runs the same
loop in this process on ``[cpu] * 8`` logical devices, from the
reference's weights.  Both loops run the staging to its end in the tick
the task opens and join every copy session a MIGRATING poll submits
before the next tick, so that which blocks move, and when, is the same on
both sides.  Held, at f32:

* the migration matrix (``tests/test_scaledown_migration.py``): dense
  banks, pooled pages, and int8 KV blocks with int8 pages — greedy tokens
  equal the reference's and an unscaled DP2 x TP2 run of the port;
  ``migrated_blocks``, ``migration_bytes`` (= blocks x ``block_nbytes``,
  the int8 scale rows counted) and ``preemptions`` (0) equal the
  reference's; the block manager's invariants hold; every TP rank's copy
  of the cache is bitwise equal;
* a sharing component (a CoW prefix in the doomed partition) moves whole;
* survivors too full for a component: the fallback to preemption, as the
  reference's;
* ``scaledown="drain"``, and a dense-KV server (which always drains);
* abort with copies in flight restores every slot and leaks no block, and
  the server finishes on the old configuration;
* ``copy_block`` between replicas moves every rank's rows and scales;
* ``KVBlockManager``'s migration API driven through one sequence of
  operations, against the reference's manager.
"""
import json
import threading

import numpy as np
import pytest
import torch

from test_torch_scale import COMMON, CPU8, _mcfg, _start, _tree, _wait
from repro_torch.core.elastic_engine import ElasticServer
from repro_torch.core.topology import ElasticConfig
from repro_torch.serving.driver import ScalePhase
from repro_torch.serving.kv_blocks import KVBlockManager, block_bytes
from repro_torch.serving.workload import Request

PAGED = dict(kv_mode="paged", kv_block_size=16)
# name: (server knobs, request set)
# (the reference runs them in this order: the first three share their
# compiled steps through one IMM cache)
CASES = {
    "dense": (dict(PAGED, expert_mode="dense"), "mixed"),
    "shared": (dict(PAGED, expert_mode="dense"), "shared"),
    "drain": (dict(PAGED, expert_mode="dense", scaledown="drain"), "mixed"),
    "fallback": (dict(PAGED, expert_mode="dense", kv_blocks_per_replica=8),
                 "full"),
    "dense_kv": (dict(kv_mode="dense", expert_mode="dense"), "mixed"),
    "pooled": (dict(PAGED, expert_mode="pooled"), "mixed"),
    "int8": (dict(PAGED, expert_mode="pooled", kv_dtype="int8",
                  expert_dtype="int8"), "mixed"),
}


def _reqsets():
    """name -> (prompts, output lengths, the tick the scale starts).
    "mixed": the short rids 0-1 free survivor slots early and the long
    rids 4-5 sit in the doomed partition, mid-decode at the scale;
    "shared": the same, rids 4 and 5 sharing their first block; "full":
    every partition's pool too small to take a doomed sequence."""
    rng = np.random.default_rng(0)
    mixed = [rng.integers(0, 128, 16).tolist() for _ in range(6)]
    rng = np.random.default_rng(2)
    shared = [rng.integers(0, 128, 32).tolist() for _ in range(6)]
    shared[5][:16] = shared[4][:16]
    rng = np.random.default_rng(1)
    full = [rng.integers(0, 128, 16).tolist() for _ in range(6)]
    return {"mixed": (mixed, [6, 6, 30, 30, 60, 60], 10),
            "shared": (shared, [6, 6, 30, 30, 60, 60], 10),
            "full": (full, [40] * 6, 5)}


REQSETS = _reqsets()

# the reference's loop; the port's ``_drive`` is the same
SCRIPT = COMMON + '''
from repro.core.elastic_engine import ElasticServer
from repro.core.hmm import HMM
from repro.serving.driver import ScalePhase
from repro.serving.workload import Request
CASES, REQSETS = %s, %s
c6, c4 = cfg(3, 2), cfg(2, 2)

def drive(srv, reqs, target, at):
    t, n, task, phases = 0.0, 0, None, set()
    while any(r.finish_s is None for r in reqs) or \\
            (task is not None and not task.done):
        if target is not None and n == at and task is None:
            task = srv.start_scale(target)
            while task.phase in (ScalePhase.STAGING, ScalePhase.COMPILING):
                task.advance(t)
        srv.tick(t); t += .1; n += 1
        if task is not None and not task.done:
            phases.add(task.advance(t).name)
            for _, sess in task._mig_inflight:
                sess.join()
        assert n < 3000
    return task, phases

from collections import OrderedDict
res, shared = {}, OrderedDict()
for name, (kw, rs) in CASES.items():
    prompts, outs, at = REQSETS[rs]
    srv = ElasticServer(MCFG, tp=2, batch_per_replica=2, max_len=128,
                        prefill_buckets=(32,), seed=0, imm_cache=shared,
                        **kw)
    srv.boot(c6)
    np.savez(f"{OUT}/{name}.npz", **flat(srv.hmm.params))
    if kw.get("expert_mode") == "pooled":
        hmm = HMM(MCFG, tp=2, batch_per_replica=2, max_len=128, seed=0,
                  **{k: v for k, v in kw.items() if k != "scaledown"})
        hmm.boot(c4)
        np.savez(f"{OUT}/{name}_c4.npz", **flat(hmm.params))
    reqs = [Request(i, 0.0, len(p), o, prompt=np.asarray(p, np.int32))
            for i, (p, o) in enumerate(zip(prompts, outs))]
    for r in reqs:
        srv.submit(r)
    task, phases = drive(srv, reqs, c4, at)
    assert task.phase is ScalePhase.DONE and srv.hmm.active_cfg == c4
    res[name] = {"tokens": {str(r.rid): srv.engine.generated[r.rid]
                            for r in reqs},
                 "migrated_blocks": task.migrated_blocks,
                 "migration_bytes": task.migration_bytes,
                 "preemptions": srv.engine.preemptions,
                 "phases": sorted(phases),
                 "block_nbytes": (srv.engine.block_nbytes()
                                  if kw.get("kv_mode") == "paged" else 0)}
json.dump(res, open(f"{OUT}/scaledown.json", "w"))
print("SCALEDOWN-DONE")
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("scaledown_ref")
    _wait(_start(SCRIPT % (repr(CASES), repr(REQSETS)), out),
          "scale-down servers")
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The servers' steps are tiny: one intra-op thread (the suite runs
    several test workers on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


C6 = ElasticConfig(3, 2, (0, 1, 2, 3, 4, 5))
C4 = ElasticConfig(2, 2, (0, 1, 2, 3))


def _server(name, **extra):
    kw, _ = CASES[name]
    return ElasticServer(_mcfg(), tp=2, batch_per_replica=2, max_len=128,
                         prefill_buckets=(32,), seed=0, all_devices=CPU8,
                         device="cpu", **kw, **extra)


def _requests(name):
    prompts, outs, _ = REQSETS[CASES[name][1]]
    return [Request(i, 0.0, len(p), o, prompt=np.asarray(p, np.int32))
            for i, (p, o) in enumerate(zip(prompts, outs))]


def _drive(srv, reqs, target, at):
    """The reference script's loop: the staging runs to its end in the
    tick the task opens; every copy session lands before the next tick."""
    t, n, task, phases = 0.0, 0, None, set()
    while any(r.finish_s is None for r in reqs) or \
            (task is not None and not task.done):
        if target is not None and n == at and task is None:
            task = srv.start_scale(target)
            while task.phase in (ScalePhase.STAGING, ScalePhase.COMPILING):
                task.advance(t)
        srv.tick(t)
        t, n = t + .1, n + 1
        if task is not None and not task.done:
            phases.add(task.advance(t).name)
            for _, sess in task._mig_inflight:
                assert sess.join(timeout=60)
        assert n < 3000
    return task, phases


def _run(name, params, scale):
    srv = _server(name)
    srv.boot(C6 if scale else C4, params=params)
    reqs = _requests(name)
    for r in reqs:
        srv.submit(r)
    task, phases = _drive(srv, reqs, C4 if scale else None,
                          REQSETS[CASES[name][1]][2])
    tokens = {str(r.rid): srv.engine.generated[r.rid] for r in reqs}
    return srv, task, phases, tokens


def _assert_copies_equal(srv):
    par = srv.engine.parallel
    for leaf in srv.engine.cache.values():
        for r in range(par.dp):
            devs = par.replica_devices(r)
            for d in devs[1:]:
                assert torch.equal(leaf.shard(d), leaf.shard(devs[0]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_scale_down_equals_reference_and_unscaled(ref, name):
    """DP3 x TP2 -> DP2 x TP2 while serving: tokens, moved blocks and
    bytes and preemptions equal the reference's; without the fallback,
    tokens equal an unscaled DP2 x TP2 run too."""
    want = json.load(open(ref / "scaledown.json"))[name]
    srv, task, phases, tokens = _run(name, _tree(ref / f"{name}.npz"),
                                     scale=True)
    assert task.phase is ScalePhase.DONE
    assert srv.hmm.active_cfg == C4 and srv.engine.num_slots == 4
    assert sorted(phases) == want["phases"]
    assert tokens == want["tokens"]
    assert task.migrated_blocks == want["migrated_blocks"]
    assert task.migration_bytes == want["migration_bytes"]
    assert srv.engine.preemptions == want["preemptions"]
    ev = srv.events[-1]
    assert (ev.migrated_blocks, ev.migration_bytes) == (
        task.migrated_blocks, task.migration_bytes)
    summary = srv.scaling_summary()
    assert summary["migrated_blocks"] == task.migrated_blocks
    assert srv.engine.admit_limit is None and srv._active_task is None
    _assert_copies_equal(srv)
    kv = srv.hmm.kv_blocks
    if name == "dense_kv":
        assert srv.scaledown_mode == "drain" and kv is None
        assert "DRAINING" in phases and task.migrated_blocks == 0
    else:
        kv.check_invariants()
        assert kv.num_partitions == 2 and kv.used_blocks() == 0
        nbytes = srv.engine.block_nbytes()
        assert nbytes == want["block_nbytes"] == block_bytes(
            srv.mcfg, 16, CASES[name][0].get("kv_dtype"))
        assert task.migration_bytes == task.migrated_blocks * nbytes
        assert srv.engine.kv_stats()["migration_bytes"] == \
            task.migration_bytes
    if name == "drain":
        assert "DRAINING" in phases and task.migrated_blocks == 0
    elif name == "fallback":
        assert srv.engine.preemptions > 0
        return
    elif name != "dense_kv":
        assert "MIGRATING" in phases and task.migrated_blocks > 0
        assert srv.engine.preemptions == 0      # moved, not recomputed
    c4 = ref / f"{name}_c4.npz"
    params4 = _tree(c4 if c4.exists() else ref / f"{name}.npz")
    assert _run(name, params4, scale=False)[3] == tokens


def test_a_sharing_component_moves_whole(ref):
    """Rids 4 and 5 share their first block in the doomed partition: one
    ticket moves both, the shared block once, onto one survivor
    partition, and their tables share the moved block."""
    srv = _server("shared")
    srv.boot(C6, params=_tree(ref / "shared.npz"))
    reqs = _requests("shared")
    for r in reqs:
        srv.submit(r)
    for n in range(REQSETS["shared"][2]):
        srv.tick(n * .1)
    kv = srv.hmm.kv_blocks
    assert kv.share_components(2) == [[4, 5]]
    need = kv.migration_need([4, 5])
    assert need == len(kv.seq(4).blocks) + len(kv.seq(5).blocks) - 1
    task = srv.start_scale(C4)
    while task.phase is not ScalePhase.MIGRATING:
        task.advance(1.0)
    task.advance(1.0)                       # plans and submits the move
    (job, sess), = task._mig_inflight
    assert job.ticket.num_blocks == need
    assert sorted(r for r, _, _ in job.moves) == [4, 5]
    assert len({dst // 2 for _, _, dst in job.moves}) == 1
    assert sess.join(timeout=60)
    task.advance(1.1)                       # harvests it
    assert kv.seq(4).blocks[0] == kv.seq(5).blocks[0]
    assert kv.seq(4).partition == kv.seq(5).partition < 2
    kv.check_invariants()
    while not task.done:
        srv.tick(2.0)
        task.advance(2.0)
    assert task.migrated_blocks == need


def test_abort_mid_migration_restores_and_leaks_nothing(ref):
    """Abort with copies in flight (held at a gate until then): the
    sessions are cancelled or joined, the tickets unwind, the block tables
    were never flipped, the paused sequences resume in place on the old
    configuration, and every request completes with the pool
    conserved."""
    srv = _server("pooled")
    srv.boot(C6, params=_tree(ref / "pooled.npz"))
    reqs = _requests("pooled")
    for r in reqs:
        srv.submit(r)
    copy, gate = srv.engine.copy_block, threading.Event()
    bpp = srv.engine.kv.blocks_per_partition

    def gated_copy(src, dst):
        if src // bpp != dst // bpp:       # a migration copy, not a CoW
            assert gate.wait(timeout=300)  # keep the ops in flight
        copy(src, dst)
    srv.engine.copy_block = gated_copy
    t, n, task, aborted = 0.0, 0, None, False
    while any(r.finish_s is None for r in reqs):
        if n == 10 and task is None:
            task = srv.start_scale(C4)
        srv.tick(t)
        t, n = t + .1, n + 1
        if task is not None and not task.done:
            task.advance(t)
            if not aborted and task.phase is ScalePhase.MIGRATING \
                    and task._mig_inflight:
                mig = [i for i, s in enumerate(srv.engine.slots)
                       if s.migrating]
                assert mig, "no slot paused while the copies are in flight"
                before = srv.engine.block_tables[mig].copy()
                gate.set()      # running copies finish; pending never start
                task.abort()
                aborted = True
                assert (srv.engine.block_tables[mig] == before).all()
                assert not any(s.migrating or s.reserved
                               for s in srv.engine.slots)
                srv.hmm.kv_blocks.check_invariants()
                assert srv.hmm.kv_blocks.migrations_pending == 0
                assert srv.engine.admit_limit is None
                assert srv.hmm.staged is None
        assert n < 3000
    assert aborted and task.phase is ScalePhase.ABORTED
    assert srv.hmm.active_cfg == C6
    assert srv.engine.kv_stats()["used_blocks"] == 0
    srv.hmm.kv_blocks.check_invariants()
    for r in reqs:
        assert len(srv.engine.generated[r.rid]) == r.output_len
    srv.hmm.close()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_copy_block_between_replicas_moves_every_rank(kv_dtype):
    """A block of replica 2 into a block of replica 0 at tp = 2: both of
    the destination replica's copies take the source rows (and an int8
    pool's scale rows) bit for bit; nothing else changes."""
    srv = ElasticServer(_mcfg(), tp=2, batch_per_replica=2, max_len=64,
                        seed=0, all_devices=CPU8, device="cpu",
                        kv_dtype=kv_dtype, **CASES["pooled"][0])
    srv.boot(C6)
    eng = srv.engine
    gen = torch.Generator().manual_seed(0)
    for leaf in eng.cache.values():
        for r in range(3):
            devs = eng.parallel.replica_devices(r)
            rows = (torch.randint(-127, 128, leaf.shard(devs[0]).shape,
                                  generator=gen).to(leaf.dtype)
                    if leaf.dtype == torch.int8 else
                    torch.randn(leaf.shard(devs[0]).shape, generator=gen))
            for d in devs:
                leaf.shard(d).copy_(rows)
    before = {n: leaf.gather() for n, leaf in eng.cache.items()}
    bpp = eng.kv.blocks_per_partition
    src, dst = 2 * bpp + 3, 1
    eng.copy_block(src, dst)
    assert len(eng.cache) == (4 if kv_dtype else 2)
    for n, leaf in eng.cache.items():
        want = before[n].clone()
        want[:, dst] = before[n][:, src]
        for d in eng.parallel.replica_devices(0):
            assert torch.equal(leaf.shard(d), want[:, :bpp])
        for r in (1, 2):
            for d in eng.parallel.replica_devices(r):
                assert torch.equal(leaf.shard(d),
                                   before[n][:, r * bpp:(r + 1) * bpp])


def _manager_ops(KV):
    """One sequence of allocate / append / CoW / migrate / commit / abort /
    preempt / free operations; returns every observable after each."""
    kv = KV(3, 6, 4)
    out = []

    def snap(tag):
        kv.check_invariants()
        out.append((tag, {s: (kv.seq(s).partition, kv.block_table(s),
                              kv.seq(s).num_tokens)
                          for s in sorted(kv.live_seqs())},
                    [kv.free_blocks(p) for p in range(kv.num_partitions)],
                    {k: kv.stats()[k] for k in (
                        "used_blocks", "cow_copies", "shared_block_hits",
                        "migrated_blocks", "migrations_pending",
                        "preemptions")}))

    toks = list(range(10))
    kv.allocate(1, 10, partition=2, tokens=toks)
    kv.allocate(2, 9, partition=2, tokens=toks[:9])     # shares 2 blocks
    kv.allocate(3, 5, partition=1, tokens=[7] * 5)
    kv.allocate(4, 3, partition=2, tokens=[9, 9, 9])
    snap("alloc")
    kv.append(2)                                        # CoW of a tail
    snap("cow")
    comps = kv.share_components(2)
    out.append(("comps", comps))
    out.append(("need", [kv.migration_need(c) for c in comps]))
    t1 = kv.begin_migration(comps[0], 0)
    out.append(("ticket", t1.seqs, t1.pairs, t1.src_partition,
                t1.dst_partition, [kv.migrating(s) for s in (1, 2, 4)]))
    snap("reserved")
    t2 = kv.begin_migration(comps[1], 1)
    kv.abort_migration(t2)
    kv.abort_migration(t2)                              # idempotent
    snap("aborted")
    out.append(("released", kv.commit_migration(t1)))
    snap("committed")
    out.append(("match", kv.prefix_match_blocks(0, toks)))
    kv.allocate(5, 8, partition=0, tokens=toks[:8])     # the moved prefix
    kv.allocate(6, 8, partition=0, tokens=[5] * 8)      # fills partition 0
    snap("rematched")
    try:
        kv.begin_migration([4], 0)
        out.append(("big", "ok"))
    except MemoryError:
        out.append(("big", "MemoryError"))
    t3 = kv.begin_migration([4], 1)
    out.append(("victim", kv.victim(candidates=[3, 4])))
    kv.commit_migration(t3)
    for s in (1, 2):
        kv.append(s)
    kv.preempt(3)
    kv.free(5)
    snap("after")
    for s in list(kv.live_seqs()):
        kv.free(s)
    kv.shrink_partitions(2)
    snap("shrunk")
    return out


def test_block_manager_migration_api_equals_reference():
    from repro.serving.kv_blocks import KVBlockManager as RefKV
    assert _manager_ops(KVBlockManager) == _manager_ops(RefKV)


def test_block_manager_refuses_a_frozen_or_open_component():
    kv = KVBlockManager(2, 4, 4)
    kv.allocate(1, 6, partition=1, tokens=list(range(6)))
    kv.allocate(2, 6, partition=1, tokens=list(range(6)))
    with pytest.raises(ValueError, match="shares blocks"):
        kv.begin_migration([1], 0)
    t = kv.begin_migration([1, 2], 0)
    with pytest.raises(RuntimeError, match="mid-migration"):
        kv.append(1)
    with pytest.raises(RuntimeError, match="mid-migration"):
        kv.free(2)
    with pytest.raises(RuntimeError, match="in flight"):
        kv.shrink_partitions(1)
    kv.check_invariants()
    kv.commit_migration(t)
    kv.check_invariants()
    kv.shrink_partitions(1)
    assert kv.block_table(1) == kv.block_table(2)
