"""Overlapped staging (``staging="overlap"``: the HMM's units on the
background ``TransferEngine`` while the server keeps ticking) against the
reference, on the CPU.

The reference runs in one subprocess with 8 simulated host devices (as
``tests/helpers.run_with_devices`` runs it), started once for the module:
its HMMs stage with ``staging="overlap"`` and its tp = 2 server scales DP2
-> DP3 through ``start_scale`` with ticks between the polls, saving the
weights, the ``TransferStats`` and the greedy tokens.  The port runs in this
process on ``[cpu] * 8`` logical devices (its ops run in the worker threads
with no stream: the tensors are on the CPU).  Held:

* ``TransferEngine``: results in op order, cancel joins the running op and
  skips the pending ones, a failing op is reported, and each op's span
  lands on its worker thread's lane;
* every ``TransferStats.BYTE_FIELDS`` value of an overlapped staging equal
  the serial staging's and the reference's, staged and committed, with the
  staged leaves equal to the serial ones bit for bit: dense banks (f32 and
  bf16, tp = 2), pooled bf16 and int8 pages (DP4 -> DP6) and a pooled DP3
  x TP2 -> DP2 x TP2;
* ticks served while ops are in flight (one worker, each unit slowed), the
  greedy tokens equal the reference's overlapped server and an unscaled
  DP3 x TP2 run of the port; the serve loop's stall below the staging
  window; the phases' spans on the ``"scale"`` lane;
* abort with ops in flight leaves no staged page, and a later scale
  completes;
* a failing op aborts the task: the server keeps serving on the old
  configuration and a later scale succeeds.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

from test_torch_scale import (CHUNKED, COMMON, CPU8, REQS, _mcfg,
                              _start, _stats, _tree, _wait)
from repro_torch import obs
from repro_torch.core.elastic_engine import ElasticServer
from repro_torch.core.hmm import HMM
from repro_torch.core.topology import ElasticConfig
from repro_torch.core.transfer import TransferEngine, TransferOp
from repro_torch.distributed.sharding import tree_leaves_with_path
from repro_torch.serving.driver import ScalePhase
from repro_torch.serving.workload import Request

PAGED = dict(kv_mode="paged", kv_block_size=16, expert_mode="pooled")
# name: (model, tp, from dp, to dp, HMM knobs)
HMM_CASES = {
    "dense_tp2": ("moe", 2, 2, 3, {}),
    "dense_bf16_tp2": ("moe_bf16", 2, 2, 3, {}),
    "pooled_bf16": ("moe_bf16", 1, 4, 6, PAGED),
    "pooled_int8": ("moe", 1, 4, 6, dict(PAGED, kv_dtype="int8",
                                         expert_dtype="int8")),
    "down_pooled_tp2": ("moe", 2, 3, 2, PAGED),
}
SERVER = dict(CHUNKED, staging="overlap")

SCRIPT = COMMON + '''
from repro.core.elastic_engine import ElasticServer
from repro.core.hmm import HMM, TransferStats
from repro.serving.driver import ScalePhase
from repro.serving.workload import Request
HMM_CASES, SERVER, REQS = %s, %s, %s

def stats(st):
    return {f: int(getattr(st, f)) for f in TransferStats.BYTE_FIELDS}

res = {}
for name, (model, tp, dp0, dp1, kw) in HMM_CASES.items():
    mcfg = {"moe": MCFG, "moe_bf16": dataclasses.replace(
        MCFG, dtype="bfloat16")}[model]
    hmm = HMM(mcfg, tp=tp, batch_per_replica=2, max_len=32,
              staging="overlap", **kw)
    hmm.boot(cfg(dp0, tp))
    np.savez(f"{OUT}/{name}.npz", **flat(hmm.params))
    r = {"stage": stats(hmm.scale(cfg(dp1, tp)))}
    r["commit"] = stats(hmm.commit())
    res[name] = r

srv = ElasticServer(MCFG, tp=2, batch_per_replica=2, max_len=128, seed=0,
                    **SERVER)
srv.boot(cfg(2, 2))
np.savez(f"{OUT}/serve.npz", **flat(srv.hmm.params))
hmm = HMM(MCFG, tp=2, batch_per_replica=2, max_len=128, seed=0,
          **{k: v for k, v in SERVER.items()
             if k not in ("prefill_buckets", "prefill_chunk",
                          "prefill_budget")})
hmm.boot(cfg(3, 2))
np.savez(f"{OUT}/serve_dp3.npz", **flat(hmm.params))
reqs = [Request(i, 0.0, len(pr), out, prompt=np.asarray(pr, np.int32))
        for i, (pr, out) in enumerate(REQS)]
for r in reqs:
    srv.submit(r)
t, n, task = 0.0, 0, None
while any(r.finish_s is None for r in reqs) or not task.done:
    if n == 5 and task is None:
        task = srv.start_scale(cfg(3, 2))
    srv.tick(t); t += .1; n += 1
    if task is not None and not task.done:
        task.advance(t)
    assert n < 3000
res["server"] = {"tokens": {str(r.rid): srv.engine.generated[r.rid]
                            for r in reqs},
                 "stage": stats(task.stage_stats)}
json.dump(res, open(f"{OUT}/overlap.json", "w"))
print("OVERLAP-DONE")
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("overlap_ref")
    _wait(_start(SCRIPT % (repr(HMM_CASES), repr(SERVER), repr(REQS)), out),
          "overlapped staging")
    return out


def _cfg(dp, tp=1):
    return ElasticConfig(dp, tp, tuple(range(dp * tp)))


# ------------------------------------------------------- transfer engine

def test_transfer_engine_runs_polls_and_orders_results():
    eng = TransferEngine(max_workers=2)
    ops = [TransferOp(index=i, label=f"op{i}", fn=lambda i=i: i * i)
           for i in range(8)]
    sess = eng.submit(ops)
    assert sess.join(timeout=30.0)
    assert sess.finished() and sess.remaining() == 0
    assert [op.result for op in sess.ops] == [i * i for i in range(8)]
    assert all(op.state == "done" for op in ops)
    assert sess.op_seconds >= 0.0 and not sess.failed_ops()
    assert sess.last_done_t == max(op.t_done for op in ops)
    eng.shutdown()


def test_transfer_engine_cancel_joins_running_and_skips_pending():
    started, release = threading.Event(), threading.Event()

    def blocker():
        started.set()
        release.wait(timeout=30.0)
        return "ran"

    eng = TransferEngine(max_workers=1)   # one worker: the rest stay pending
    ops = [TransferOp(index=0, label="blocker", fn=blocker)] + [
        TransferOp(index=i, label=f"p{i}", fn=lambda: "ran")
        for i in range(1, 5)]
    sess = eng.submit(ops)
    assert started.wait(timeout=30.0)
    release.set()                          # cancel() must JOIN the runner
    sess.cancel()
    assert sess.finished()
    assert ops[0].state == "done"          # the running op joined
    assert all(op.state == "cancelled" and op.seconds == 0
               for op in ops[1:])
    assert sess.op_seconds == ops[0].seconds
    eng.shutdown()


def test_transfer_engine_reports_failures_on_worker_lanes():
    def boom():
        raise ValueError("transfer exploded")

    tr = obs.install(obs.Tracer())
    try:
        eng = TransferEngine(max_workers=2)
        sess = eng.submit([TransferOp(index=0, label="ok", fn=lambda: 1),
                           TransferOp(index=1, label="bad", fn=boom)])
        assert sess.join(timeout=30.0)
        eng.shutdown()
    finally:
        obs.install(None)
    failed = sess.failed_ops()
    assert len(failed) == 1 and failed[0].label == "bad"
    assert isinstance(failed[0].error, ValueError)
    spans = {e.name: e for e in tr.events() if e.cat == "transfer"}
    assert spans["bad"].args["state"] == "failed"
    names = tr.thread_names()
    assert all(names[e.tid].startswith("hmm-transfer")
               for e in spans.values())


# ------------------------------------------------------------ the HMM

def _hmm(name, staging):
    model, tp, dp0, dp1, kw = HMM_CASES[name]
    mcfg = {"moe": _mcfg(), "moe_bf16": _mcfg(dtype="bfloat16")}[model]
    return HMM(mcfg, tp, batch_per_replica=2, max_len=32, all_devices=CPU8,
               device="cpu", staging=staging, **kw)


@pytest.mark.parametrize("name", sorted(HMM_CASES))
def test_overlap_bytes_equal_serial_and_reference(ref, name):
    """The same units on the workers: every byte field equal the serial
    staging's and the reference's overlapped one, staged and committed,
    and the staged leaves equal bit for bit."""
    want = json.load(open(ref / "overlap.json"))[name]
    _, tp, dp0, dp1, _ = HMM_CASES[name]
    params = _tree(ref / f"{name}.npz")
    staged = {}
    for staging in ("serial", "overlap"):
        hmm = _hmm(name, staging)
        hmm.boot(_cfg(dp0, tp), params=params)
        assert _stats(hmm.scale(_cfg(dp1, tp))) == want["stage"]
        staged[staging] = {p: leaf.gather() for p, leaf
                           in tree_leaves_with_path(hmm.attach_staged()[2])}
        st = hmm.last_stats
        if staging == "overlap":
            assert st.op_s > 0 and st.wall_s > 0
        assert _stats(hmm.commit()) == want["commit"]
        hmm.close()
    assert staged["serial"].keys() == staged["overlap"].keys()
    for p, a in staged["serial"].items():
        assert torch.equal(a, staged["overlap"][p]), p


def test_stage_increment_refuses_an_overlapped_session():
    hmm = _hmm("pooled_bf16", "overlap")
    hmm.boot(_cfg(4))
    hmm.begin_scale(_cfg(6))
    with pytest.raises(RuntimeError, match="poll_staging"):
        hmm.stage_increment()
    assert hmm.join_staging() and hmm.staged is not None
    assert hmm.staging_remaining == 0 and not hmm.staging_in_flight
    hmm.abort()
    hmm.close()


# ---------------------------------------------------------------- servers

def _server(params, boot, **kw):
    srv = ElasticServer(_mcfg(), tp=2, batch_per_replica=2, max_len=128,
                        seed=0, all_devices=CPU8, device="cpu",
                        **dict(SERVER, **kw))
    srv.boot(boot, params=params)
    return srv


def _requests():
    return [Request(i, 0.0, len(pr), out, prompt=np.asarray(pr, np.int32))
            for i, (pr, out) in enumerate(REQS)]


def _gate_units(srv):
    """Each staging unit waits for the returned gate to open first, so the
    ops stay in flight across as many ticks as the test wants, however
    loaded the host."""
    gate, unit = threading.Event(), srv.hmm._stage_unit

    def gated(*a, **k):
        assert gate.wait(timeout=300)
        return unit(*a, **k)
    srv.hmm._stage_unit = gated
    return gate


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The servers' steps are tiny: one intra-op thread (the suite runs
    several test workers on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ticks_during_flight_equal_reference_and_unscaled(ref):
    """tp = 2, DP2 -> DP3 at the 5th tick, one worker: three ticks run
    with ops in flight (the units wait for a gate until then); tokens
    equal the reference's overlapped server and an unscaled DP3 x TP2
    run; the bytes equal the reference's; the serve loop stalls less than
    the staging window lasts."""
    want = json.load(open(ref / "overlap.json"))["server"]
    srv = _server(_tree(ref / "serve.npz"), _cfg(2, 2), transfer_workers=1)
    srv.preinitialize(_cfg(3, 2))
    gate = _gate_units(srv)
    reqs = _requests()
    for r in reqs:
        srv.submit(r)
    tr = obs.install(obs.Tracer())
    try:
        t, n, task, mid = 0.0, 0, None, 0
        while any(r.finish_s is None for r in reqs) or not task.done:
            if n == 5 and task is None:
                task = srv.start_scale(_cfg(3, 2))
                assert srv.hmm.staging_in_flight
            queued = len(srv.queue)
            srv.tick(t)
            t, n = t + .1, n + 1
            if task is not None and not task.done:
                if task.phase is ScalePhase.STAGING \
                        and srv.hmm.staging_in_flight:
                    mid += 1          # this tick ran with ops in flight
                    assert len(srv.queue) == queued     # admission paused
                if mid >= 3:
                    gate.set()
                task.advance(t)
            assert n < 3000
    finally:
        obs.install(None)
    assert task.phase is ScalePhase.DONE and mid >= 3, mid
    assert task.event.compile_hit and task.overlap_efficiency > 0
    assert task.stall_s < task.stage_stats.wall_s
    assert srv.events[-1].stall_s == task.stall_s
    assert _stats(task.stage_stats) == want["stage"]
    tokens = {str(r.rid): srv.engine.generated[r.rid] for r in reqs}
    assert tokens == want["tokens"]
    lanes = {e.name: e.tid for e in tr.events() if e.cat == "scale"}
    assert lanes == {"scale.STAGING": "scale", "scale.COMMITTING": "scale"}
    srv.hmm.close()
    unscaled = _server(_tree(ref / "serve_dp3.npz"), _cfg(3, 2))
    reqs = _requests()
    for r in reqs:
        unscaled.submit(r)
    n = 0
    while any(r.finish_s is None for r in reqs):
        unscaled.tick(n * .1)
        n += 1
    assert {str(r.rid): unscaled.engine.generated[r.rid]
            for r in reqs} == tokens


def _pool_consistent(srv):
    table = srv.hmm.page_table
    for d in srv.hmm.active_cfg.devices:
        owned = sum(1 for r in table.active.values() if r.device == d)
        assert table.pages_in_use(d) == owned, d
    assert table.staged is None
    assert srv.hmm.staged is None and not srv.hmm.staging_in_flight


def test_abort_in_flight_leaves_no_staged_page(ref):
    """abort() with ops pending or running (held at a gate through a tick)
    cancels or joins them and unwinds the page pool, three times over;
    then a scale completes with exact byte accounting."""
    srv = _server(_tree(ref / "serve.npz"), _cfg(2, 2), transfer_workers=1)
    gate = _gate_units(srv)
    reqs = _requests()
    for r in reqs:
        srv.submit(r)
    for trial in range(3):
        gate.clear()
        task = srv.start_scale(_cfg(3, 2))
        srv.tick(0.1 * trial)
        assert srv.hmm.staging_in_flight
        gate.set()          # the running op finishes; the pending never start
        task.abort()
        assert task.phase is ScalePhase.ABORTED
        _pool_consistent(srv)
        srv.hmm.abort()                     # idempotent
        _pool_consistent(srv)
        assert srv._active_task is None
    t, n, task = 1.0, 0, srv.start_scale(_cfg(3, 2))
    while any(r.finish_s is None for r in reqs) or not task.done:
        srv.tick(t)
        if not task.done:
            task.advance(t)
        t, n = t + .1, n + 1
        assert n < 3000
    assert srv.hmm.active_cfg == _cfg(3, 2)
    assert srv.hmm.last_stats.expert_p2p_bytes == \
        len(srv.hmm.last_migrations) * srv.hmm.expert_page_nbytes()
    srv.hmm.kv_blocks.check_invariants()
    srv.hmm.close()


def test_a_failed_op_unwinds_the_task_and_the_server(ref):
    """A unit that raises on a worker aborts the session and the task (a
    scale-down: the slots it closed reopen) and re-raises; the server
    serves on the old configuration and the next scale succeeds."""
    srv = _server(_tree(ref / "serve.npz"), _cfg(2, 2))
    srv.stage_scale(_cfg(3, 2))
    srv.switchover()
    reqs = _requests()
    for r in reqs:
        srv.submit(r)
    srv.tick(0.0)
    unit, calls = srv.hmm._stage_unit, []

    def failing(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected transfer failure")
        return unit(*a, **k)
    srv.hmm._stage_unit = failing
    task = srv.start_scale(_cfg(2, 2))
    assert srv.engine.admit_limit == 4
    t = 0.1
    with pytest.raises(RuntimeError, match="transfer op"):
        for _ in range(500):
            srv.tick(t)
            task.advance(t)
            t += .1
    assert task.phase is ScalePhase.ABORTED
    assert srv.engine.admit_limit is None
    assert srv._active_task is None and srv._staged_cfg is None
    _pool_consistent(srv)
    srv.hmm._stage_unit = unit
    task = srv.start_scale(_cfg(2, 2))
    n = 0
    while any(r.finish_s is None for r in reqs) or not task.done:
        srv.tick(t)
        if not task.done:
            task.advance(t)
        t, n = t + .1, n + 1
        assert n < 3000
    assert srv.hmm.active_cfg == _cfg(2, 2)
    for r in reqs:
        assert len(srv.engine.generated[r.rid]) == r.output_len
    srv.hmm.close()
