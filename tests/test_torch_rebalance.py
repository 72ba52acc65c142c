"""Skew-aware expert rebalancing in the port — replica sets, the
pinned-host tier, the rebalance session and routing telemetry — against
the reference, on the CPU.

In process, against the reference's host-side modules (the same inputs,
the same outputs): the page table's rebalance lifecycle (stage, commit and
abort conserve the device and HOST pools; validation and rollback; host
pool exhaustion; a rebalance session and a scale remap exclude each
other), ``pooled_layout`` with and without replicas (least-loaded
assignment, slot overflow), min-move over replicas and host-sourced
migrations, ``plan_elastic_paged`` and its ``Op.HOST`` pricing, the
policy's hysteresis and gates, ``routing_counts`` and the engine's
histogram.  The port's own: ``moe_ep`` and the DP2 x TP2 decode step count
the routed rows as one device does, pad rows left out.

Servers: one reference subprocess (8 simulated host devices, f32) runs the
four server scenarios of ``tests/test_rebalance.py`` — a policy
rebalancing mid-serving (and, with int8 pages, a scale over its replicas
and demoted experts), an abort in flight then a full demotion and a cold
DP2 x TP2 -> DP3 x TP2 scale, the routing reset at a scale's commit — from
one loop (``DRIVE``), which the port runs too, on ``[cpu] * 8`` logical
devices from the reference's boot weights.  Every rebalance session's
copies are joined in the tick that opens it on both sides, so each commit
lands on the same tick.  Held exactly: the page tables (``active``,
``replicas``, ``host``), every event's ``TransferStats`` byte fields, the
scales' migrations and byte fields, ``rebalance_summary()``, the routing
counts, and the greedy tokens (also against a server without a policy).
"""
import json
import threading

import numpy as np
import pytest
import torch

from test_torch_scale import COMMON, CPU8, _mcfg, _start, _tree, _wait
from repro_torch.core.costmodel import plan_cost
from repro_torch.core.elastic_engine import ElasticServer
from repro_torch.core.expert_pages import (HOST, ExpertPageTable,
                                           pooled_layout)
from repro_torch.core.scaling_plan import Op, plan_elastic_paged
from repro_torch.core.topology import ElasticConfig, model_tensors
from repro_torch.serving.rebalance import RebalancePolicy, max_rank_load
from repro_torch.serving.workload import Request

C4 = ElasticConfig(2, 2, (0, 1, 2, 3))
C6 = ElasticConfig(3, 2, (0, 1, 2, 3, 4, 5))
L, E = 2, 24                     # the test MoE's layers and experts

# ------------------------------------------------------ the serving loop
# run by the reference's script and by the port's test alike: ``make(name,
# **knobs)`` builds a server with ``KW`` and the knobs and boots it on c4
# (the reference saves its weights under ``name``, the port adopts them)
DRIVE = '''
import numpy as np
POLICY = dict(hot_factor=1.02, cold_factor=0.98, min_samples=3,
              cooldown_s=0.5, max_actions=8)

def serve(srv, reqs, max_ticks=600):
    t, n = 0.0, 0
    for r in reqs:
        srv.submit(r)
    while any(r.finish_s is None for r in reqs):
        srv.tick(t)
        t, n = t + .1, n + 1
        assert n < max_ticks, "serve loop did not finish"

def mkreqs(n=4, out=40, base=0):
    rng = np.random.default_rng(0)
    return [Request(base + i, 0.0, 16, out,
                    prompt=rng.integers(0, 128, 16).astype(np.int32))
            for i in range(n)]

def joined(srv):
    """Every rebalance session's copies land in the tick that opens it."""
    hmm = srv.hmm
    begin = hmm.begin_rebalance
    def wrapped(*a, **k):
        n = begin(*a, **k)
        if hmm._rebalance_session is not None:
            hmm._rebalance_session.join()
        return n
    hmm.begin_rebalance = wrapped
    return srv

def stats(st):
    return None if st is None else {
        f: int(getattr(st, f)) for f in st.BYTE_FIELDS}

def table(pt):
    return {"active": sorted([l, e, r.device, r.page]
                             for (l, e), r in pt.active.items()),
            "replicas": sorted([l, e, [[r.device, r.page] for r in refs]]
                               for (l, e), refs in pt.replicas.items()),
            "host": sorted([l, e, r.device, r.page]
                           for (l, e), r in pt.host.items())}

def usage(pt, devices):
    return [pt.pages_in_use(d) for d in list(devices) + [HOST]]

def record(srv, reqs):
    st = srv.routing_stats()
    return {"tokens": {str(r.rid): [int(t) for t in
                                    srv.engine.generated[r.rid]]
                       for r in reqs},
            "table": table(srv.hmm.page_table),
            "events": [[ev.actions, ev.replicated, ev.demoted, ev.dropped,
                        ev.promoted, ev.aborted, stats(ev.stats)]
                       for ev in srv.rebalance_events],
            "summary": srv.rebalance_summary(),
            "counts": None if st is None else st["counts"].tolist(),
            "samples": None if st is None else st["samples"],
            "host_tier_bytes": int(srv.hmm.host_tier_bytes())}

def scale(srv, target, t=100.0):
    task = srv.start_scale(target)
    n = 0
    while not task.done:
        srv.tick(t)
        task.advance(t)
        t, n = t + .1, n + 1
        assert n < 500
    return {"migrations": [[m.layer, m.expert, m.src.device, m.src.page,
                            m.dst.device, m.dst.page]
                           for m in srv.hmm.last_migrations],
            "stage": stats(task.stage_stats),
            "page": srv.hmm.expert_page_nbytes(),
            "stats_reset": srv.routing_stats() is None}

def case_mid(make, store):
    """A tight-banded policy rebalances mid-serving; tokens equal a server
    without one.  int8 pages: then a scale over the replicas and the
    demoted experts (an open rebalance is aborted first)."""
    plain = make("plain" + store, **KNOBS[store])
    reqs = mkreqs()
    serve(plain, reqs)
    base = record(plain, reqs)["tokens"]
    srv = joined(make("policy" + store, routing_sample_every=1,
                      rebalance=RebalancePolicy(**POLICY), **KNOBS[store]))
    reqs = mkreqs()
    serve(srv, reqs)
    res = record(srv, reqs)
    res["plain_tokens"] = base
    if store:
        res["scale"] = scale(srv, c6)
        more = mkreqs(2, out=10, base=300)
        serve(srv, more)
        res["after_scale"] = record(srv, more)
    return res

def case_cold(make):
    """Abort in flight, a full demotion in sessions of 8, then a cold
    scale whose every mover comes from the host tier."""
    srv = make("route", routing_sample_every=1)
    pt = srv.hmm.page_table
    res = {"usage0": usage(pt, c4.devices)}
    task = srv.start_rebalance([("replicate", 0, 0, 1), ("demote", 1, 23)])
    task.abort()
    res.update(after_abort=table(pt), usage1=usage(pt, c4.devices),
               host_rows=len(srv.hmm._expert_host_pool),
               aborted=[ev.aborted for ev in srv.rebalance_events])
    reqs = mkreqs(2, out=10, base=100)
    serve(srv, reqs)
    keys = [(l, e) for l in range(MCFG.num_layers)
            for e in range(MCFG.num_experts)]
    for i in range(0, len(keys), 8):
        task = srv.start_rebalance([("demote", l, e)
                                    for l, e in keys[i:i + 8]])
        t = 0.0
        while not task.done:
            srv.tick(t)
            t += .1
    res["demoted_bytes"] = int(srv.hmm.host_tier_bytes())
    reqs2 = mkreqs(2, out=10, base=200)
    serve(srv, reqs2)
    res["pre"] = record(srv, reqs2)
    res["scale"] = scale(srv, c6)
    gg = mkreqs(2, out=10, base=300)
    serve(srv, gg)
    res.update(record(srv, reqs + reqs2 + gg))
    return res

def case_reset(make):
    """A scale opened mid-serving: the histogram is empty at its commit
    and samples again after."""
    srv = make("route", routing_sample_every=1)
    reqs = mkreqs(2, out=20)
    serve(srv, reqs)
    res = {"pre": record(srv, reqs)}
    reqs2 = mkreqs(2, out=30, base=100)
    for r in reqs2:
        srv.submit(r)
    task, post, t, n = None, "unset", 200.0, 0
    while any(r.finish_s is None for r in reqs2):
        if n == 2 and task is None:
            task = srv.start_scale(c6)
        srv.tick(t)
        if task is not None and not task.done:
            task.advance(t)
            if task.done:
                post = srv.routing_stats()
        t, n = t + .1, n + 1
        assert n < 500
    res["post_commit_none"] = post is None
    res.update(record(srv, reqs + reqs2))
    return res

KNOBS = {"": {}, "_int8": {"expert_dtype": "int8"}}
CASES = [("mid", lambda make: case_mid(make, "")),
         ("mid_int8", lambda make: case_mid(make, "_int8")),
         ("cold", case_cold), ("reset", case_reset)]
'''

SCRIPT = COMMON + DRIVE + '''
from collections import OrderedDict
from repro.core.elastic_engine import ElasticServer
from repro.core.expert_pages import HOST
from repro.serving.rebalance import RebalancePolicy
from repro.serving.workload import Request
c4, c6 = cfg(2, 2), cfg(3, 2)
shared = OrderedDict()

def make(name, **knobs):
    srv = ElasticServer(MCFG, tp=2, batch_per_replica=2, max_len=128,
                        prefill_buckets=(32,), seed=0, expert_mode="pooled",
                        imm_cache=shared, **knobs)
    srv.boot(c4)
    np.savez(f"{OUT}/{name}.npz", **flat(srv.hmm.params))
    return srv

json.dump({name: run(make) for name, run in CASES},
          open(f"{OUT}/rebalance.json", "w"))
print("REBALANCE-DONE")
'''


@pytest.fixture(scope="module")
def _ref_proc(tmp_path_factory):
    """The reference's servers, started as the module starts: the
    in-process tests run while it compiles."""
    out = tmp_path_factory.mktemp("rebalance_ref")
    return _start(SCRIPT, out), out


@pytest.fixture(scope="module")
def ref(_ref_proc):
    proc, out = _ref_proc
    _wait(proc, "rebalance servers")
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_thread(_ref_proc):
    """The servers' steps are tiny: one intra-op thread (the suite runs
    several test workers on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ the port and the reference

def _jcfg(c):
    from repro.core.topology import ElasticConfig as JC
    return JC(c.dp, c.tp, c.devices)


def _tables(c=C4, host_pool_pages=None):
    """The port's and the reference's page tables, placed on ``c``."""
    from repro.core.expert_pages import ExpertPageTable as JT
    t = ExpertPageTable(L, E, host_pool_pages=host_pool_pages)
    j = JT(L, E, host_pool_pages=host_pool_pages)
    t.initial_place(c)
    j.initial_place(_jcfg(c))
    return t, j


def _ref(r):
    return None if r is None else (r.device, r.page)


def _state(t):
    """A table's whole state as plain tuples."""
    return {
        "active": sorted((k, _ref(r)) for k, r in t.active.items()),
        "replicas": sorted((k, tuple(map(_ref, v)))
                           for k, v in t.replicas.items()),
        "host": sorted((k, _ref(r)) for k, r in t.host.items()),
        "staged": (None if t.staged is None else
                   sorted((k, _ref(r)) for k, r in t.staged.items())),
        "staged_rebalance": (None if t.staged_rebalance is None else
                             [(o.kind, o.key, _ref(o.src), _ref(o.dst))
                              for o in t.staged_rebalance]),
        "free": {d: list(v) for d, v in t._free.items()},
    }


def _out(x):
    """A table call's result as plain tuples."""
    if isinstance(x, list):
        return [_out(v) for v in x]
    if hasattr(x, "kind"):                       # RebalanceOp
        return (x.kind, x.key, _ref(x.src), _ref(x.dst))
    if hasattr(x, "src"):                        # Migration
        return (x.layer, x.expert, _ref(x.src), _ref(x.dst))
    if hasattr(x, "page"):
        return _ref(x)
    return x


ALL = [("demote", l, e) for l in range(L) for e in range(E)]
# name: (boot configuration, host pool pages, [(method, argument)...]);
# an argument C6 / C4 is that configuration in each package
SEQUENCES = {
    "replicate_demote_undo": (C4, None, [
        ("stage_rebalance", [("replicate", 0, 0, 1), ("demote", 1, 23)]),
        ("commit_rebalance", None),
        ("stage_rebalance", [("drop_replica", 0, 0, 1), ("promote", 1, 23)]),
        ("commit_rebalance", None)]),
    "abort_in_flight": (C4, None, [
        ("stage_rebalance", [("replicate", 0, 0, 2), ("replicate", 0, 1, 3),
                             ("demote", 1, 5), ("demote", 1, 6)]),
        ("abort_rebalance", None), ("abort_rebalance", None)]),
    "validation_and_rollback": (C4, None, [
        ("stage_rebalance", [("replicate", 0, 0, 0)]),
        ("stage_rebalance", [("replicate", 0, 0, 1), ("demote", 0, 1),
                             ("promote", 0, 2)]),
        ("stage_rebalance", [("demote", 0, 0)]),
        ("commit_rebalance", None),
        ("stage_rebalance", [("demote", 0, 0)]),
        ("stage_rebalance", [("drop_replica", 0, 0, 1)]),
        ("stage_rebalance", [("evict", 0, 0)]),
        ("stage_rebalance", [("demote", 5, 0)]),
        ("commit_rebalance", None)]),
    "host_pool_exhaustion": (C4, 1, [
        ("stage_rebalance", [("demote", 0, 0), ("demote", 0, 1)]),
        ("stage_rebalance", [("demote", 0, 0)]),
        ("commit_rebalance", None),
        ("stage_rebalance", [("demote", 0, 1)])]),
    "exclusive_with_scale": (C4, None, [
        ("stage_rebalance", [("demote", 0, 0)]),
        ("stage_remap", C6),
        ("abort_rebalance", None),
        ("stage_remap", C6),
        ("stage_rebalance", [("demote", 0, 0)]),
        ("abort", None), ("abort", None)]),
    "kept_via_replica": (C4, None, [
        ("stage_rebalance", [("replicate", 0, 0, 1), ("replicate", 1, 7, 3)]),
        ("commit_rebalance", None),
        ("stage_remap", C6),
        ("commit", None)]),
    "host_sourced_migrations": (C4, None, [
        ("stage_rebalance", ALL),
        ("commit_rebalance", None),
        ("stage_remap", C6),
        ("commit", None)]),
    "replicas_then_shrink": (C6, None, [
        ("stage_rebalance", [("replicate", 0, 0, 5), ("replicate", 1, 3, 0),
                             ("demote", 0, 7), ("demote", 1, 20)]),
        ("commit_rebalance", None),
        ("stage_remap", C4),
        ("abort", None),
        ("stage_remap", C4),
        ("commit", None),
        ("stage_rebalance", [("promote", 0, 7)]),
        ("commit_rebalance", None)]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_page_table_sequence_matches_reference(name):
    """The port's table and the reference's run the same calls: every
    result (ops, migrations, freed pages), every refused call's exception
    type, and the whole state after each call (active, replicas, host, the
    staged session, every free list) are equal."""
    boot, host_pages, calls = SEQUENCES[name]
    t, j = _tables(boot, host_pages)
    for method, arg in calls:
        outs = []
        for tab, conv in ((t, lambda a: a), (j, _jcfg)):
            args = () if arg is None else (
                conv(arg) if isinstance(arg, ElasticConfig) else arg,)
            try:
                outs.append(("ok", _out(getattr(tab, method)(*args))))
            except (ValueError, KeyError, RuntimeError, MemoryError) as e:
                outs.append((type(e).__name__, None))
        assert outs[0] == outs[1], (name, method, arg)
        assert _state(t) == _state(j), (name, method, arg)
    # the pools hold exactly the live pages
    live = sum(t.pages_in_use(d) for d in range(8))
    assert live == len(t.active) + sum(len(v) for v in t.replicas.values())
    assert t.pages_in_use(HOST) == len(t.host)


def test_scale_after_full_demotion_sources_every_mover_from_host():
    t, _ = _tables()
    t.stage_rebalance(ALL)
    t.commit_rebalance()
    migs = t.stage_remap(C6, min_move=True)
    assert migs and all(m.src.is_host for m in migs)
    t.commit()
    assert len(t.host) == L * E          # host copies outlive the scale


LAYOUTS = {
    # name: (configuration, replicate actions, load, slots per rank)
    "no_replicas": (C6, [], None, None),
    "no_replicas_kwargs": (C6, [], "uniform", None),
    "hot_expert": (C4, [("replicate", 0, 0, 3)], "hot", E // 4 + 1),
    "two_replicas_slack2": (C4, [("replicate", 0, 0, 1),
                                 ("replicate", 0, 0, 2),
                                 ("replicate", 1, 9, 0)], "random", E // 4 + 2),
    "replicas_uniform": (C6, [("replicate", 1, 2, 4)], None, E // 6 + 1),
}


def _load(kind):
    if kind is None:
        return None
    if kind == "uniform":
        return np.ones((L, E))
    if kind == "hot":
        load = np.ones((L, E))
        load[0, 0] = 100.0
        return load
    return np.random.default_rng(3).integers(0, 50, (L, E)).astype(float)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_pooled_layout_matches_reference(name):
    """``pooled_layout`` with and without replicas equals the reference's
    arrays; every expert serves from a rank that holds a copy of it."""
    from repro.core.expert_pages import pooled_layout as jlayout
    c, acts, load, spr = LAYOUTS[name]
    t, j = _tables(c)
    if acts:
        for tab in (t, j):
            tab.stage_rebalance(acts)
            tab.commit_rebalance()
    reps = t.replicas if acts else ({} if load == "uniform" else None)
    jreps = j.replicas if acts else ({} if load == "uniform" else None)
    got = pooled_layout(t.active, c, L, E, 48, replicas=reps,
                        load=_load(load), slots_per_rank=spr)
    want = jlayout(j.active, _jcfg(c), L, E, 48, replicas=jreps,
                   load=_load(load), slots_per_rank=spr)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for l in range(L):
        for e in range(E):
            holders = {c.slot(r.device) for r in
                       (t.active[(l, e)],) + t.replicas.get((l, e), ())}
            assert int(got["edest"][l, e]) in holders
    if name == "hot_expert":
        def peak(lay):
            rl = np.zeros(c.ndev)
            for e in range(E):
                rl[lay["edest"][0, e]] += _load(load)[0, e]
            return rl.max()
        assert peak(got) <= peak(pooled_layout(t.active, c, L, E, 48))


def test_pooled_layout_slot_overflow_raises_as_the_reference():
    from repro.core.expert_pages import pooled_layout as jlayout
    t, j = _tables()
    for tab in (t, j):
        tab.stage_rebalance([("replicate", 0, 0, 1), ("replicate", 0, 1, 1)])
        tab.commit_rebalance()
    with pytest.raises(ValueError, match="slots_per_rank"):
        pooled_layout(t.active, C4, L, E, 48, replicas=t.replicas,
                      slots_per_rank=5)
    with pytest.raises(ValueError, match="slots_per_rank"):
        jlayout(j.active, _jcfg(C4), L, E, 48, replicas=j.replicas,
                slots_per_rank=5)


def _steps(plan):
    return sorted((s.op.value, s.key.tensor, s.key.part, s.nbytes, s.dst,
                   s.src) for s in plan.steps)


@pytest.mark.parametrize("kind", ["cold", "replica", "warm", "mixed"])
def test_plan_elastic_paged_and_cost_match_reference(kind):
    """``plan_elastic_paged`` over replicas and the host tier: the same
    steps as the reference's (movers of demoted experts ``Op.HOST``,
    replica-kept experts zero-copy), and the same ``plan_cost``
    breakdown (the host bucket: host bytes over ``h2d_bw``)."""
    from repro.core.costmodel import plan_cost as jcost
    from repro.core.scaling_plan import plan_elastic_paged as jplan
    from repro.core.topology import model_tensors as jtensors
    from helpers import TEST_MOE
    ns = {}
    exec(TEST_MOE, ns)
    acts = {"cold": ALL, "warm": [],
            "replica": [("replicate", 0, 0, 1)],
            "mixed": [("replicate", 0, 0, 1), ("replicate", 1, 5, 3)]
            + ALL[4:20] + ALL[30:34]}[kind]
    t, j = _tables()
    if acts:
        for tab in (t, j):
            tab.stage_rebalance(acts)
            tab.commit_rebalance()
    plan = plan_elastic_paged(model_tensors(_mcfg(), 2), C4, C6, t)
    want = jplan(jtensors(ns["MCFG"], 2), _jcfg(C4), _jcfg(C6), j)
    assert _steps(plan) == _steps(want)
    hosts = [s for s in plan.steps
             if s.op == Op.HOST and "/expert" in s.key.tensor]
    p2ps = [s for s in plan.steps
            if s.op == Op.P2P and "/expert" in s.key.tensor]
    if kind == "cold":
        assert hosts and not p2ps
    if kind in ("warm", "replica"):
        assert not hosts and not plan.host_bytes_per_device()
    assert plan.host_bytes_per_device() == dict(want.host_bytes_per_device())
    got, exp = plan_cost(plan), jcost(want)
    assert got.breakdown == pytest.approx(exp.breakdown)
    assert (got.breakdown["host"] > 0) == bool(hosts)


def _stats(counts, samples=10):
    return {"samples": samples, "counts": np.asarray(counts, np.float64)}


def _policy_inputs(name):
    """name -> (policy knobs, table actions, [(stats, now, slots)...])."""
    hot = np.full((L, E), 10.0)
    hot[:, 0], hot[:, E - 1] = 100.0, 0.0
    undo = np.ones((L, E))
    undo[0, 0], undo[0, 1] = 0.5, 2.0
    band = undo.copy()
    band[0, 0], band[0, 1] = 1.2, 0.8
    gate = np.ones((L, E))
    gate[:, 0] = 4 * E
    skew = np.random.default_rng(5).zipf(1.5, (L, E)).astype(float)
    return {
        "hot_and_cold": (dict(min_samples=1, max_actions=16), [],
                         [(_stats(hot), 0.0, 7)]),
        "neutral_band": (dict(min_samples=1, max_actions=32), [],
                         [(_stats(np.ones((L, E))), 0.0, None)]),
        "undo": (dict(min_samples=1, max_actions=32),
                 [("replicate", 0, 0, 1), ("demote", 0, 1)],
                 [(_stats(undo), 0.0, None), (_stats(band), 0.0, None)]),
        "gates": (dict(min_samples=5, cooldown_s=10.0, max_actions=4), [],
                  [(_stats(gate, 2), 0.0, None), (None, 0.0, None),
                   (_stats(gate), 0.0, 7), (_stats(gate), 5.0, None),
                   (_stats(gate), 11.0, 7)]),
        "zero_slack": (dict(min_samples=1), [],
                       [(_stats(gate), 0.0, E // 4)]),
        "zipf": (dict(min_samples=1, max_replicas=2, max_actions=12),
                 [("replicate", 1, 3, 2), ("demote", 0, 4)],
                 [(_stats(skew), 0.0, E // 4 + 2),
                  (_stats(skew[::-1]), 1.0, E // 4 + 2)]),
    }[name]


@pytest.mark.parametrize("name", ["hot_and_cold", "neutral_band", "undo",
                                  "gates", "zero_slack", "zipf"])
def test_policy_decides_as_the_reference(name):
    """``RebalancePolicy.decide`` gives the reference's actions for the
    same histograms, table and clock: the hot expert replicated onto a
    device without a copy, the cold one demoted, the hysteresis band, the
    undo actions, and the gates (samples, cooldown, slot budget)."""
    from repro.serving.rebalance import RebalancePolicy as JPolicy
    knobs, acts, calls = _policy_inputs(name)
    t, j = _tables()
    if acts:
        for tab in (t, j):
            tab.stage_rebalance(acts)
            tab.commit_rebalance()
    pol, jpol = RebalancePolicy(**knobs), JPolicy(**knobs)
    for stats, now, slots in calls:
        got = pol.decide(stats, t, C4, now, slots_per_rank=slots)
        want = jpol.decide(stats, j, _jcfg(C4), now, slots_per_rank=slots)
        assert got == want, (name, now)
        for a in got:
            if a[0] == "replicate":
                assert a[3] != t.active[(a[1], a[2])].device
    if name == "hot_and_cold":
        assert ("replicate", 0, 0) in [a[:3] for a in got]
        assert ("demote", 0, E - 1) in [a[:3] for a in got]
    if name == "zero_slack":
        assert got and all(a[0] != "replicate" for a in got)


def test_max_rank_load_matches_reference():
    from repro.serving.rebalance import max_rank_load as jmrl
    rng = np.random.default_rng(1)
    counts = rng.integers(0, 20, (L, E)).astype(float)
    edest = rng.integers(0, 4, (L, E))
    assert max_rank_load(counts, edest, 4) == jmrl(counts, edest, 4)


@pytest.mark.parametrize("T,k,E_,top", [(1, 1, 4, 3), (8, 2, 24, 23),
                                        (37, 8, 128, 90), (5, 2, 64, 0)])
def test_routing_counts_match_reference(T, k, E_, top):
    """``routing_counts`` (no bincount) equals the reference's over random
    top-k indices, with E above the largest index present."""
    import jax.numpy as jnp
    from repro.models.moe import routing_counts as jcounts
    from repro_torch.models.moe import routing_counts
    idx = np.random.default_rng(T).integers(0, top + 1, (T, k))
    got = routing_counts(torch.from_numpy(idx).to(torch.int32), E_)
    want = np.asarray(jcounts(jnp.asarray(idx, jnp.int32), E_))
    assert got.dtype == torch.int32 and got.shape == (E_,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_routing_histogram_matches_reference_engine():
    """The engine's histogram: the same samples, counts and skew metrics
    as the reference's; a change of shape restarts counts and samples
    together; a reset empties it."""
    from repro.serving.engine import InferenceEngine as JEngine
    from repro_torch.serving.engine import InferenceEngine
    from helpers import TEST_MOE
    ns = {}
    exec(TEST_MOE, ns)
    eng = InferenceEngine(_mcfg(), batch_per_replica=2, max_len=64,
                          routing_sample_every=1, device="cpu")
    jeng = JEngine(ns["MCFG"], batch_per_replica=2, max_len=64,
                   routing_sample_every=1)
    rng = np.random.default_rng(0)
    for shape in [(2, 24), (2, 24), (2, 24), (2, 12), (2, 12)]:
        c = rng.integers(0, 9, shape)
        eng._accumulate_routing(c)
        jeng._accumulate_routing(c)
        got, want = eng.routing_stats(), jeng.routing_stats()
        assert got["samples"] == want["samples"]
        np.testing.assert_array_equal(got["counts"], want["counts"])
        assert got["top_expert_share"] == want["top_expert_share"]
        assert got["expert_cv"] == want["expert_cv"]
    assert eng.routing_stats()["samples"] == 2
    eng.reset_routing_stats()
    assert eng.routing_stats() is None


# -------------------------------------------- the port's routed steps

def _hmm(cfg, **kw):
    from repro_torch.core.hmm import HMM
    hmm = HMM(_mcfg(), cfg.tp, batch_per_replica=2, max_len=64, seed=0,
              all_devices=CPU8, device="cpu", kv_mode="paged",
              kv_block_size=16, expert_mode="pooled", **kw)
    hmm.boot(cfg)
    return hmm


@pytest.mark.parametrize("slack", [0, 1])
def test_split_decode_counts_equal_one_device(slack):
    """The DP2 x TP2 paged decode step with ``collect_routing`` gives the
    one-device step's counts [L, E] exactly (every routed row once, the
    pad rows of ``moe_ep``'s even shards left out, the replicas' rows
    summed) and its logits; a table with slack slots serves the same."""
    from repro_torch.distributed.sharding import make_instance_mesh
    from repro_torch.models import model as M
    from repro_torch.serving.engine import engine_parallel_ctx
    one = ElasticConfig(1, 1, (0,))
    h1, h4 = _hmm(one), _hmm(C4, expert_slot_slack=slack)
    assert h4.params["blocks"]["moe"]["tables"].shape[-1] == 6 + slack
    ctx = engine_parallel_ctx(make_instance_mesh(C4, h4.all_devices))
    B = 4
    tok = torch.tensor([[3], [77], [5], [120]], dtype=torch.int32)
    lens = torch.tensor([0, 0, 0, 0], dtype=torch.int32)
    nb1 = h1.kv_blocks_per_replica
    nb4 = h4.kv_blocks_per_replica
    bt1 = torch.tensor([[0, nb1], [1, nb1], [2, nb1], [3, nb1]],
                       dtype=torch.int32)
    # each replica's ids are local to its pool slice
    bt4 = torch.tensor([[0, nb4], [1, nb4], [0, nb4], [1, nb4]],
                       dtype=torch.int32)
    got = M.paged_decode_step(h4.mcfg, h4.params, tok, h4.cache, lens, bt4,
                              bt4[:, 0], parallel=ctx, collect_routing=True)
    want = M.paged_decode_step(h1.mcfg, h1.params, tok, h1.cache, lens,
                               bt1, bt1[:, 0], collect_routing=True)
    assert got[2].shape == (L, E) and got[2].dtype == torch.int32
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    assert int(want[2].sum()) == L * B * _mcfg().top_k
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rows", [1, 3, 5, 9])
def test_moe_ep_counts_leave_pad_rows_out(rows):
    """``moe_ep`` over 4 logical devices counts each of the T rows once
    (T not a multiple of n_ep: zero rows pad the last shards), as
    ``moe_local`` on one device counts them."""
    from repro_torch.distributed.sharding import make_instance_mesh
    from repro_torch.models.model import layer_params
    from repro_torch.models.moe import moe_ep, moe_local_pooled
    from repro_torch.serving.engine import engine_parallel_ctx
    h1, h4 = _hmm(ElasticConfig(1, 1, (0,))), _hmm(C4)
    ctx = engine_parallel_ctx(make_instance_mesh(C4, h4.all_devices))
    x = torch.randn(rows, 1, 64, generator=torch.Generator().manual_seed(0))
    y4, c4 = moe_ep(h4.mcfg, layer_params(h4.params["blocks"]["moe"], 1), x,
                    ctx, pool=h4.params["moe_pool"], return_counts=True)
    y1, c1 = moe_local_pooled(h1.mcfg,
                              layer_params(h1.params["blocks"]["moe"], 1),
                              h1.params["moe_pool"], x.reshape(rows, 64),
                              return_counts=True)
    torch.testing.assert_close(c4, c1, rtol=0, atol=0)
    assert int(c4.sum()) == rows * h4.mcfg.top_k
    torch.testing.assert_close(y4.reshape(rows, 64), y1, rtol=1e-5,
                               atol=1e-5)


def test_rebalance_commit_writes_index_tensors_in_place():
    """A commit writes the new serving assignment into the bound index
    tensors (the same tensors at the same addresses, which a captured
    graph names), the replica's rows equal its primary's in every bank,
    and the demoted rows are the host tier's."""
    hmm = _hmm(C4, expert_slot_slack=1, expert_dtype="int8")
    moe = hmm.params["blocks"]["moe"]
    before = {n: {d: (t, t.data_ptr()) for d, t in moe[n].shards.items()}
              for n in ("tables", "edest", "eslot", "gtable")}
    hmm.begin_rebalance([("replicate", 0, 0, 3), ("demote", 1, 5)],
                        load=np.eye(1, E)[0] * 50 + 1)
    st = hmm.commit_rebalance()
    page = hmm.expert_page_nbytes()
    assert (st.expert_replica_bytes, st.expert_d2h_bytes) == (page, page)
    pt = hmm.page_table
    for n, shards in before.items():
        for d, (t, ptr) in shards.items():
            assert moe[n].shard(d) is t and t.data_ptr() == ptr
    want = hmm._pooled_index_arrays(pt.active, C4, replicas=pt.replicas,
                                    load=np.eye(1, E)[0] * 50 + 1)
    np.testing.assert_array_equal(moe["edest"].shard(2).numpy(),
                                  want["edest"])
    np.testing.assert_array_equal(moe["tables"].shard(3).numpy(),
                                  want["tables"][:, 3:4])
    prim, rep = pt.active[(0, 0)], pt.replicas[(0, 0)][0]
    for bank, leaf in hmm.params["moe_pool"].items():
        assert torch.equal(leaf.shard(rep.device)[rep.page],
                           leaf.shard(prim.device)[prim.page])
        src = pt.active[(1, 5)]
        assert torch.equal(hmm._expert_host_pool[(1, 5)][bank],
                           leaf.shard(src.device)[src.page])
    assert hmm.host_tier_bytes() == page
    hmm.close()


def test_failed_copy_aborts_the_session_and_raises():
    """A copy op that fails aborts the whole session (both tiers as
    before) and ``poll_rebalance`` raises, as the reference's does."""
    hmm = _hmm(C4)
    pt = hmm.page_table
    usage = [pt.pages_in_use(d) for d in (0, 1, 2, 3, HOST)]

    def boom(*a, **k):
        raise OSError("copy failed")
    hmm._rebalance_copy = boom
    hmm.begin_rebalance([("replicate", 0, 0, 1), ("demote", 1, 2)])
    hmm._rebalance_session.join(30)
    with pytest.raises(RuntimeError, match="rebalance copy op"):
        hmm.poll_rebalance()
    assert [pt.pages_in_use(d) for d in (0, 1, 2, 3, HOST)] == usage
    assert pt.staged_rebalance is None and not pt.replicas and not pt.host
    assert hmm._rebalance_ops is None and not hmm._expert_host_pool
    hmm.close()


def test_abort_waits_for_a_running_copy():
    """``abort_rebalance`` with a copy running: it returns only after the
    copy has finished, and the op queued behind it never runs."""
    hmm = _hmm(C4, transfer_workers=1)
    gate, started, ran = threading.Event(), threading.Event(), []
    real = hmm._rebalance_copy

    def held(kind, *a):
        started.set()
        assert gate.wait(30)
        ran.append(kind)
        return real(kind, *a)
    hmm._rebalance_copy = held
    hmm.begin_rebalance([("replicate", 0, 0, 1), ("demote", 1, 2)])
    assert started.wait(30)
    threading.Timer(0.2, gate.set).start()
    hmm.abort_rebalance()
    assert ran == ["replicate"]
    assert not hmm.page_table.replicas and not hmm._expert_host_pool
    hmm.close()


# -------------------------------------------------------------- servers

def _port_cases(ref):
    ns = {"Request": Request, "RebalancePolicy": RebalancePolicy,
          "HOST": HOST, "c4": C4, "c6": C6, "MCFG": _mcfg()}
    exec(DRIVE, ns)

    def make(name, **knobs):
        srv = ElasticServer(_mcfg(), tp=2, batch_per_replica=2, max_len=128,
                            prefill_buckets=(32,), seed=0,
                            expert_mode="pooled", all_devices=CPU8,
                            device="cpu", **knobs)
        srv.boot(C4, params=_tree(ref / f"{name}.npz"))
        return srv
    return ns, make


@pytest.fixture(scope="module")
def cases(ref):
    want = json.load(open(ref / "rebalance.json"))
    ns, make = _port_cases(ref)
    got = json.loads(json.dumps({name: run(make)
                                 for name, run in ns["CASES"]}))
    return got, want


@pytest.mark.parametrize("name", ["mid", "mid_int8", "cold", "reset"])
def test_server_matches_reference(cases, name):
    """Every recorded field of the scenario equals the reference's: page
    tables, events and their byte fields, ``rebalance_summary()``, routing
    counts, host-tier bytes, scale migrations and bytes, tokens."""
    got, want = cases
    assert got[name] == want[name]


@pytest.mark.parametrize("name", ["mid", "mid_int8"])
def test_policy_acted_and_tokens_equal_the_plain_server(cases, name):
    """The policy replicated and demoted mid-serving, and its greedy
    tokens equal those of the same server without a policy."""
    got = cases[0][name]
    summ = got["summary"]
    assert summ["replicated"] >= 1 and summ["demoted"] >= 1, summ
    assert summ["replica_bytes"] > 0 and summ["d2h_bytes"] > 0
    assert summ["host_tier_bytes"] == got["host_tier_bytes"] > 0
    assert got["table"]["replicas"] and got["table"]["host"]
    assert got["tokens"] == got["plain_tokens"]
    assert got["samples"] >= 1


def test_int8_scale_over_replicas_and_host_tier(cases):
    """int8 pages: the scale after the policy's passes moves its demoted
    movers from the host tier (their ``_scale`` banks too: whole pages in
    ``expert_h2d_bytes``) and the others P2P, and the server serves on."""
    sc = cases[0]["mid_int8"]["scale"]
    host = [m for m in sc["migrations"] if m[2] == HOST]
    assert host and len(host) < len(sc["migrations"])
    st, page = sc["stage"], sc["page"]
    assert st["expert_h2d_bytes"] == len(host) * page
    assert st["expert_p2p_bytes"] == (len(sc["migrations"])
                                      - len(host)) * page
    assert sc["stats_reset"]


def test_cold_scale_streams_every_mover_from_the_host_tier(cases):
    got = cases[0]["cold"]
    assert got["usage1"] == got["usage0"] and got["host_rows"] == 0
    assert got["aborted"][0] is True
    assert not got["after_abort"]["replicas"]
    assert not got["after_abort"]["host"]
    sc = got["scale"]
    assert sc["migrations"] and all(m[2] == HOST for m in sc["migrations"])
    assert sc["stage"]["expert_p2p_bytes"] == 0
    assert sc["stage"]["expert_h2d_bytes"] == len(sc["migrations"]) \
        * sc["page"]
    assert got["demoted_bytes"] == L * E * sc["page"]
    assert len(got["table"]["host"]) == L * E
    assert sc["stats_reset"]


def test_routing_histogram_resets_at_scale_commit(cases):
    got = cases[0]["reset"]
    assert got["pre"]["samples"] >= 10
    assert got["post_commit_none"]
    assert got["samples"] >= 1
