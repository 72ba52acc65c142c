"""Scale to zero and the fleet in the port — the HMM's park and unpark,
``UnparkTask``, the cold-start pricing and the ``FleetDriver`` — against
the reference, on the CPU.

In process, against the reference's modules: ``plan_unpark``,
``unpark_cost`` and ``unpark_transition_cost`` give equal steps and
``ScalingCost`` fields over every registered config (tp 1 and 2, DP1-DP3,
``preinit`` on and off, serial and overlapped staging, int8 KV and
pages), and the reference test's pricing assertions hold; the fleet properties of
``tests/test_fleet.py`` (its ``_given_or_cases`` and hypothesis profile)
run the port's and the reference's ``FleetDriver`` side by side over two
instances of a deterministic stub backend defined here (the reference's
``ServingSimulator`` is not ported): equal events, timelines and request
timestamps, and the properties (conservation every tick, ``min_devices``
floors, every parked model with a queue unparks, every request finishes);
the IMM's keys carry the model and the owning server, and two servers of
one model sharing one ``imm_cache`` keep their own sets; the card phase's
park configuration at test size (bf16, 4 transfer workers, a demoted
layer, jittered units) keeps every parameter bitwise over several park /
unpark cycles.

One reference subprocess (8 simulated host devices, f32 and bf16), started
as the module starts, runs one code string, ``DRIVE``, which the port runs
too, on ``[cpu] * 8`` from the reference's boot weights (its cases come
last in the file, so the in-process ones run while it computes):

* HMM round trips at tp = 2 (dense banks, pooled bf16 pages, pooled int8
  pages; the pooled stores with three pages demoted to the host tier
  first): DP1 x TP2 -> park -> DP1 x TP2 and DP2 x TP2 -> park -> DP3 x
  TP2, each unpark first aborted after one unit and retried.  Equal: the
  park's and the unpark's ``BYTE_FIELDS``, ``parked_bytes``,
  ``host_tier_bytes``, the page table after the unpark and every parameter
  after it; and every logical parameter equals the pre-park one bit for
  bit;
* a server round trip (``test_engine_park_unpark_byte_exact_with_trace_
  overlap``): overlapped staging, each H2D op throttled, the IMM's cache
  cleared; tokens equal a never-parked server's and the reference's, a
  tick while parked returns ``[]`` and a submit queues, a park with a live
  sequence or during a scale raises, and an ``unpark:`` op span overlaps
  an ``unpark.compile`` span in the exported trace (the port's capture on
  the CPU is throttled too: no graph is captured there);
* the fleet over real servers: "a" (``min_devices`` 0, parks after 1 s
  idle) and "b" (``min_devices`` 2) at tp = 2 in a pool of 8 ids, one
  shared ``imm_cache``: "a" scales down and parks, "b" scales up onto its
  ids and back down, "a" unparks.  Equal: the ``FleetDriver``'s events,
  timeline, every request's timestamps, the tokens and every server
  event's ``TransferStats`` bytes.  Both sides join a task's copy sessions
  before the next tick (as ``tests/test_torch_closed_loop.py`` does).
"""
import dataclasses
import json
import re
import time
import types
from collections import OrderedDict

import numpy as np
import pytest
import torch

from test_fleet import HAVE_HYPOTHESIS, _given_or_cases
from test_torch_scale import COMMON, CPU8, _mcfg, _start, _tree, _wait
from repro_torch import obs
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core.coordinator import ScalingPolicy
from repro_torch.core.costmodel import unpark_cost
from repro_torch.core.elastic_engine import ElasticServer
from repro_torch.core.hmm import HMM
from repro_torch.core.imm import IMM
from repro_torch.core.scaling_plan import plan_unpark
from repro_torch.core.topology import (ElasticConfig, kv_cache_bytes,
                                       model_tensors)
from repro_torch.distributed.sharding import (ShardedTensor,
                                              tree_leaves_with_path)
from repro_torch.serving import driver as TDriver
from repro_torch.serving import fleet as TFleet
from repro_torch.serving.metrics import SLO
from repro_torch.serving.workload import Request

if HAVE_HYPOTHESIS:
    from hypothesis import strategies as st

# ------------------------------------------------------- the shared loops
# run by the reference's script and by the port's tests alike; each side
# gives MCFG, Request, cfg(dp, tp), make_hmm(name, store, dp) and
# make_server(name, dp, cache, seed, **knobs) (the reference saves the
# boot weights under ``name``, the port adopts them)
DRIVE = '''
import dataclasses
from collections import OrderedDict
import numpy as np

def stats(st):
    return {f: int(getattr(st, f)) for f in st.BYTE_FIELDS}

def table(pt):
    return sorted([l, e, r.device, r.page] for (l, e), r in pt.active.items())

STORES = {
    "dense": ({}, False),
    "bf16": (dict(expert_mode="pooled", kv_mode="paged",
                  kv_block_size=16), True),
    "int8": (dict(expert_mode="pooled", expert_dtype="int8",
                  kv_mode="paged", kv_block_size=16), False),
}
DEMOTE = [(0, 0), (0, 5), (1, 23)]
HMM_CASES = {f"{s}_{a}_{b}": (s, a, b, 2) for s in STORES
             for a, b in ((1, 1), (2, 3))}
# one device: parked from DP1 and unparked to DP1 at tp = 1
HMM_CASES.update({f"{s}_one": (s, 1, 1, 1) for s in ("dense", "bf16")})

def store_mcfg(store):
    bf16 = STORES[store][1]
    return dataclasses.replace(MCFG, dtype="bfloat16") if bf16 else MCFG

def hmm_case(name):
    """Boot, demote (pooled), park, an unpark aborted after one unit, then
    the unpark to its end and its commit."""
    store, dp0, dp1, tp = HMM_CASES[name]
    hmm = make_hmm(name, store, dp0, tp)
    res = {}
    if "expert_mode" in STORES[store][0]:
        hmm.begin_rebalance([("demote", l, e) for l, e in DEMOTE])
        hmm.commit_rebalance()
    res["host_tier0"] = int(hmm.host_tier_bytes())
    res["park"] = stats(hmm.park())
    res["parked"] = [hmm.parked, int(hmm.parked_bytes()),
                     int(hmm.host_tier_bytes()), hmm.active_cfg is None]
    hmm.begin_unpark(cfg(dp1, tp))
    hmm.stage_increment()
    hmm.abort()
    res["after_abort"] = [hmm.parked, int(hmm.parked_bytes()),
                          hmm.active_cfg is None]
    n = hmm.begin_unpark(cfg(dp1, tp))
    while hmm.stage_increment():
        pass
    res["units"] = n
    res["staged"] = stats(hmm.last_stats)
    res["commit"] = stats(hmm.commit())
    res["unpark"] = stats(hmm.last_stats)
    res["table"] = None if hmm.page_table is None else table(hmm.page_table)
    res["after"] = [hmm.parked, int(hmm.parked_bytes()),
                    int(hmm.host_tier_bytes()), hmm.active_cfg.describe()]
    return res, hmm

PARK_KW = dict(tp=2, batch_per_replica=4, max_len=32, prefill_buckets=(16,),
               kv_mode="paged", kv_block_size=4, expert_mode="pooled",
               staging="overlap", transfer_workers=1)

def park_reqs(base=0, n=3):
    rng = np.random.default_rng(0)
    return [Request(rid=base + i, arrival_s=0.0, prompt_len=12, output_len=8,
                    prompt=rng.integers(1, 100, 12).astype(np.int32))
            for i in range(n)]

def serve(srv, reqs, t=0.0):
    for r in reqs:
        srv.submit(r)
    n = 0
    while any(r.finish_s is None for r in reqs):
        srv.tick(t)
        t, n = t + 0.05, n + 1
        assert n < 2000, "serving did not finish"
    return {str(r.rid): [int(x) for x in srv.engine.generated[r.rid]]
            for r in reqs}

def refusals(srv):
    """A park with a live sequence, then during a scale: both refused."""
    out = []
    r = park_reqs(100, 1)[0]
    srv.submit(r)
    srv.tick(0.0)
    try:
        srv.park()
        out.append("parked")
    except Exception as e:
        out.append(type(e).__name__)
    while r.finish_s is None:
        srv.tick(1.0)
    task = srv.start_scale(cfg(2, 2))
    try:
        srv.park()
        out.append("parked")
    except Exception as e:
        out.append(type(e).__name__)
    task.abort()
    return out

def park_case(throttle):
    """test_engine_park_unpark_byte_exact_with_trace_overlap's scenario;
    ``throttle(srv)`` clears the IMM's cache, slows each H2D op and
    returns the undo."""
    base_srv = make_server("park_base", 1, None, 0, **PARK_KW)
    res = {"base": serve(base_srv, park_reqs())}
    res["refused"] = refusals(base_srv)
    srv = make_server("park", 1, None, 0, **PARK_KW)
    serve(srv, park_reqs())
    res["park"] = stats(srv.park())
    late = park_reqs(50, 1)[0]
    srv.submit(late)
    res["parked"] = [srv.parked, srv.current_config() is None,
                     float(srv.utilization()), srv.tick(0.0),
                     srv.queue_depth(), int(srv.hmm.parked_bytes())]
    undo = throttle(srv)
    task = srv.start_unpark(cfg(1, 2))
    t = 500.0
    while not task.done:
        task.advance(t)
        srv.tick(t)                     # legal, and serves nothing
        t += 0.05
    undo()
    res["unpark"] = stats(task.stats)
    res["unpark_phase"] = [task.phase.name, task.event.src, task.event.dst,
                           task.event.compile_hit]
    while late.finish_s is None:
        srv.tick(t)
        t += 0.05
    res["late"] = [int(x) for x in srv.engine.generated[late.rid]]
    res["after"] = serve(srv, park_reqs(), t)
    return res, srv

FLEET_KW = dict(tp=2, batch_per_replica=2, max_len=64, prefill_buckets=(16,),
                kv_mode="paged", kv_block_size=16, expert_mode="pooled",
                staging="overlap", transfer_workers=2)
# "b"'s burst comes after "a" has parked; "a"'s late requests after "b"
# has scaled up
FLEET_TIMES = dict(burst=6.0, late=8.0)

def joining(srv):
    """A task's staging copies land before its first poll, a MIGRATING
    poll's copy sessions before the next tick: deterministic ticks."""
    start, unpark = srv.start_scale, srv.start_unpark

    def joined(task):
        if srv.hmm._stage_session is not None:
            srv.hmm._stage_session.join()
        adv = task.advance

        def advance(now):
            phase = adv(now)
            for _, sess in getattr(task, "_mig_inflight", ()):
                sess.join()
            return phase
        task.advance = advance
        return task
    srv.start_scale = lambda target: joined(start(target))
    srv.start_unpark = lambda target: joined(unpark(target))
    return srv

def fleet_reqs(base, t, n, out):
    rng = np.random.default_rng(base)
    return [Request(rid=base + i, arrival_s=t, prompt_len=12, output_len=out,
                    prompt=rng.integers(1, 100, 12).astype(np.int32))
            for i in range(n)]

def fleet_case(FleetDriver, FleetModelSpec, FleetConfig, ScalingPolicy,
               SLO):
    shared = OrderedDict()
    a = joining(make_server("fleet_a", 2, shared, 0, **FLEET_KW))
    b = joining(make_server("fleet_b", 1, shared, 1, **FLEET_KW))

    def policy():
        return ScalingPolicy(slo=SLO(ttft_s=10.0, tpot_s=1.5), window=8,
                             cooldown_s=1.0, queue_scale_up=3,
                             confirm_s=0.2, idle_utilization=0.4)
    specs = [FleetModelSpec("a", a, policy(), MCFG, 2, min_devices=0,
                            park_after_idle_s=1.0),
             FleetModelSpec("b", b, policy(), MCFG, 2, min_devices=2,
                            park_after_idle_s=1.0)]
    fd = FleetDriver(specs, range(8), FleetConfig(
        dt=0.1, settle_s=1.0, max_step_dp=2, sample_every_s=1.0))
    arrivals = {"a": fleet_reqs(0, 0.0, 4, 8)
                + fleet_reqs(100, FLEET_TIMES["late"], 4, 8),
                "b": fleet_reqs(200, 0.0, 2, 8)
                + fleet_reqs(300, FLEET_TIMES["burst"], 12, 8)}
    until = 0.0
    while any(r.finish_s is None for v in arrivals.values() for r in v) \\
            or any(s.task is not None for s in fd.states.values()):
        until += 5.0
        fd.run(arrivals if until == 5.0 else {}, until=until)
        assert until < 60.0, "the fleet did not finish"
    srvs = {"a": a, "b": b}
    return {
        "events": [dataclasses.asdict(e) for e in fd.events],
        "timeline": fd.timeline,
        "requests": {n: [[r.rid, r.arrival_s, r.first_token_s, r.finish_s,
                          r.token_times] for r in v]
                     for n, v in arrivals.items()},
        "tokens": {n: {str(r.rid): [int(x) for x in
                                    srvs[n].engine.generated[r.rid]]
                       for r in v} for n, v in arrivals.items()},
        "scale_events": {n: [[ev.src, ev.dst, stats(ev.stats)]
                             for ev in s.events] for n, s in srvs.items()},
        "device_seconds": fd.device_seconds(),
    }, fd, srvs
'''

SCRIPT = COMMON + DRIVE + '''
import time
from collections import OrderedDict
from repro.core.coordinator import ScalingPolicy
from repro.core.elastic_engine import ElasticServer
from repro.core.hmm import HMM
from repro.serving.fleet import FleetConfig, FleetDriver, FleetModelSpec
from repro.serving.metrics import SLO
from repro.serving.workload import Request


def make_hmm(name, store, dp, tp):
    hmm = HMM(store_mcfg(store), tp, batch_per_replica=2, max_len=32,
              **STORES[store][0])
    hmm.boot(cfg(dp, tp))
    np.savez(f"{OUT}/{name}.npz", **flat(hmm.params))
    return hmm


def make_server(name, dp, cache, seed, **kw):
    srv = ElasticServer(MCFG, seed=seed, imm_cache=cache, **kw)
    srv.boot(cfg(dp, 2))
    np.savez(f"{OUT}/{name}.npz", **flat(srv.hmm.params))
    return srv


def throttle(srv):
    srv.imm._cache.clear()
    orig = srv.hmm._stage_unit

    def slow_unit(*a, **k):
        time.sleep(0.05)
        return orig(*a, **k)
    srv.hmm._stage_unit = slow_unit
    return lambda: setattr(srv.hmm, "_stage_unit", orig)


res = {"hmm": {}}
for name in HMM_CASES:
    res["hmm"][name], hmm = hmm_case(name)
    np.savez(f"{OUT}/{name}_after.npz", **flat(hmm.params))
res["park"] = park_case(throttle)[0]
res["fleet"] = fleet_case(FleetDriver, FleetModelSpec, FleetConfig,
                          ScalingPolicy, SLO)[0]
json.dump(res, open(f"{OUT}/fleet.json", "w"))
print("FLEET-DONE")
'''


@pytest.fixture(scope="module")
def _ref_proc(tmp_path_factory):
    """The reference's script, started as the module starts: the
    in-process tests run while it compiles."""
    out = tmp_path_factory.mktemp("fleet_ref")
    return _start(SCRIPT, out), out


@pytest.fixture(scope="module")
def ref(_ref_proc):
    proc, out = _ref_proc
    _wait(proc, "park and fleet")
    return out, json.load(open(out / "fleet.json"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread(_ref_proc):
    """The servers' steps are tiny: one intra-op thread (the suite runs
    several test workers on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(dp, tp=2):
    return ElasticConfig(dp, tp, tuple(range(dp * tp)))


def _jcfg(c):
    from repro.core.topology import ElasticConfig as JC
    return JC(c.dp, c.tp, c.devices)


def _port_ns(out, pre=None):
    """``DRIVE`` with the port's server and HMM makers, booting from the
    reference's weights in ``out``; ``pre``: name -> logical parameters at
    boot (``_logical``)."""
    ns = {"MCFG": _mcfg(), "Request": Request, "cfg": _cfg}
    exec(DRIVE, ns)

    def make_hmm(name, store, dp, tp):
        hmm = HMM(ns["store_mcfg"](store), tp, batch_per_replica=2,
                  max_len=32, all_devices=CPU8, device="cpu",
                  **ns["STORES"][store][0])
        hmm.boot(_cfg(dp, tp), params=_tree(out / f"{name}.npz"))
        if pre is not None:
            pre[name] = _logical(hmm)
        return hmm

    def make_server(name, dp, cache, seed, **kw):
        srv = ElasticServer(_mcfg(), seed=seed, imm_cache=cache,
                            all_devices=CPU8, device="cpu", **kw)
        srv.boot(_cfg(dp), params=_tree(out / f"{name}.npz"))
        return srv
    ns.update(make_hmm=make_hmm, make_server=make_server)
    return ns


_NAMES = {}
exec(DRIVE, _NAMES)
HMM_NAMES = sorted(_NAMES["HMM_CASES"])
INDEX = re.compile(r"moe/(tables|edest|eslot|gtable)$")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _whole(leaf) -> torch.Tensor:
    """A leaf as one tensor: a sharded leaf gathered, a one-device
    instance's plain tensor as it is."""
    return leaf.gather() if isinstance(leaf, ShardedTensor) else leaf


def _page(leaf, ref) -> torch.Tensor:
    """An expert page's rows in a pool bank (sharded or plain)."""
    return (leaf.shard(ref.device) if isinstance(leaf, ShardedTensor)
            else leaf)[ref.page]


def _logical(hmm) -> dict:
    """Every logical parameter: each dense leaf gathered (its copies on
    every device first held equal), each expert's rows where the page
    table puts them.  The pool layout and the index arrays are left out:
    they follow the configuration."""
    out = {}
    for path, leaf in tree_leaves_with_path(hmm.params):
        if path.startswith("moe_pool/") or INDEX.search(path):
            continue
        full = _whole(leaf)
        for _, index, shard in getattr(leaf, "addressable_shards", ()):
            assert torch.equal(_bits(shard), _bits(full[index])), path
        out[path] = full.clone()
    if hmm.expert_mode == "pooled":
        pool = hmm.params["moe_pool"]
        for (l, e), r in hmm.page_table.active.items():
            for bank, leaf in pool.items():
                out[f"{l}.{e}.{bank}"] = _page(leaf, r).clone()
    return out


# ------------------------------------------ park / unpark in process

def test_park_and_unpark_refuse_what_is_not_ported_or_legal():
    """A second park, an unpark while not parked, a park while staging
    and an unpark to another tp raise.  Parking from and unparking to one
    device is ported (the ``*_one`` cases of
    ``test_hmm_park_unpark_bytes_and_table_equal_reference``): a
    one-device HMM parks, refuses a second park, and unparks to two
    devices."""
    one = ElasticConfig(1, 1, (0,))
    hmm = HMM(_mcfg(), 1, batch_per_replica=2, max_len=32,
              all_devices=CPU8, device="cpu")
    hmm.boot(one)
    hmm.park()
    with pytest.raises(RuntimeError, match="nothing to park"):
        hmm.park()
    hmm.begin_unpark(_cfg(2, 1))
    while hmm.stage_increment():
        pass
    hmm.commit()
    assert hmm.active_cfg == _cfg(2, 1) and not hmm.parked
    hmm.close()
    hmm = HMM(_mcfg(), 2, batch_per_replica=2, max_len=32,
              all_devices=CPU8, device="cpu")
    hmm.boot(_cfg(1))
    with pytest.raises(RuntimeError, match="not parked"):
        hmm.begin_unpark(_cfg(1))
    hmm.begin_scale(_cfg(2))
    with pytest.raises(RuntimeError, match="staging"):
        hmm.park()
    hmm.abort()
    hmm.park()
    with pytest.raises(RuntimeError, match="nothing to park"):
        hmm.park()
    with pytest.raises(ValueError, match="TP"):
        hmm.begin_unpark(ElasticConfig(2, 1, (0, 1)))
    hmm.close()


def _clone(params):
    return {path: {d: t.clone() for d, t in leaf.shards.items()}
            for path, leaf in tree_leaves_with_path(params)}


def _same_logical(old, old_table, hmm):
    """Every dense shard of ``old`` (``_clone``'s) at its logical device,
    and every expert's rows where each table puts them, bitwise in
    ``hmm``'s parameters; returns the tensors that differ."""
    new = dict(tree_leaves_with_path(hmm.params))
    bad = [path for path, shards in old.items()
           if not path.startswith("moe_pool/")
           and not re.search(r"moe/(tables|edest|eslot|gtable)$", path)
           and any(not torch.equal(new[path].shards[d], t)
                   for d, t in shards.items())]
    for key, ref in old_table.items():
        dst = hmm.page_table.active[key]
        bad += [f"{bank} {key}" for bank in old if bank.startswith("moe_pool/")
                and not torch.equal(new[bank].shards[dst.device][dst.page],
                                    old[bank][ref.device][ref.page])]
    return bad


@pytest.mark.parametrize("capture_s", [0.0, 0.02])
def test_bf16_overlapped_park_cycles_are_bitwise(capture_s):
    """The card phase's configuration at test size: bf16 pages and KV,
    overlapped staging on 4 transfer workers, the expert host tier with
    one layer demoted (the park absorbs its rows), the capture slowed by
    ``capture_s`` a call and each unit by 0-4 ms (seeded), so the units
    land in shuffled orders.  Three park / unpark cycles to DP2 x TP2
    while the server ticks: each time every logical parameter is bitwise the
    pre-park one and the requests give the pre-park tokens; a last unpark
    to DP3 x TP2 keeps every parameter too."""
    mcfg = _mcfg(dtype="bfloat16")
    srv = ElasticServer(mcfg, tp=2, batch_per_replica=2, max_len=64,
                        prefill_chunk=16, kv_mode="paged", kv_block_size=16,
                        expert_mode="pooled", staging="overlap",
                        transfer_workers=4, seed=3, all_devices=CPU8,
                        device="cpu",
                        expert_host_pages=2 * mcfg.num_experts)
    srv.boot(_cfg(2))
    task = srv.start_rebalance([("demote", 0, e)
                                for e in range(mcfg.num_experts)])
    t = 0.0
    while not task.done:
        srv.tick(t)
        t += 0.1
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, mcfg.vocab_size, n).astype(np.int32)
               for n in (9, 30, 17, 41)]

    def serve(base):
        nonlocal t
        reqs = [Request(rid=base + i, arrival_s=t, prompt_len=len(p),
                        output_len=8, prompt=p) for i, p in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        while any(r.finish_s is None for r in reqs):
            srv.tick(t)
            t += 0.05
        return [list(srv.engine.generated[r.rid]) for r in reqs]
    want = serve(0)
    pre, unit = srv.imm.preinitialize, srv.hmm._stage_unit
    delays = iter(np.random.default_rng(7).uniform(0, 4e-3, 10_000))

    def slow_capture(*a, **k):
        time.sleep(capture_s)
        return pre(*a, **k)

    def slow_unit(*a, **k):
        time.sleep(next(delays))
        return unit(*a, **k)
    srv.imm.preinitialize, srv.hmm._stage_unit = slow_capture, slow_unit
    for cycle, target in enumerate((_cfg(2),) * 3 + (_cfg(3),)):
        old = _clone(srv.hmm.params)
        table = dict(srv.hmm.page_table.active)
        host_rows = len(srv.hmm._expert_host_pool)
        srv.park()
        assert srv.hmm.last_park["absorbed_bytes"] == \
            host_rows * srv.hmm.expert_page_nbytes()
        task = srv.start_unpark(target)
        while not task.done:
            task.advance(t)
            srv.tick(t)
            t += 0.05
        assert _same_logical(old, table, srv.hmm) == [], cycle
        if target == _cfg(2):
            assert serve(100 * (cycle + 1)) == want, cycle
    srv.hmm.close()


def test_validate_trace_refuses_malformed_documents():
    with pytest.raises(ValueError):
        obs.validate_trace({"events": []})
    with pytest.raises(ValueError):
        obs.validate_trace({"traceEvents": [{"ph": "X", "pid": 1}]})
    with pytest.raises(ValueError):
        obs.validate_trace({"traceEvents": [
            {"ph": "X", "pid": 1, "tid": 1, "ts": 0, "name": "a",
             "dur": -1}]})


# ------------------------------------------------------- cold-start pricing

def _ref_config(name):
    from repro.configs import get_config as ref_get_config
    return ref_get_config(name)


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_unpark_pricing_equals_reference(name):
    """At tp 1 and 2, DP1-DP3, f32/bf16 and int8 pools: ``plan_unpark``'s
    steps equal, and ``unpark_cost`` of the plan with ``preinit`` on and
    off and serial and overlapped staging equal field for field;
    ``unpark_transition_cost``, at one such setting a target, equal too
    and the cost of that plan."""
    from repro.core import costmodel as RCost
    from repro.core import scaling_plan as RPlan
    from repro.core import topology as RTopo
    from repro.serving import driver as RDriver
    mine, theirs = get_config(name), _ref_config(name)
    n = 0
    for tp in (1, 2):
        for dp in (1, 2, 3):
            new = _cfg(dp, tp)
            for i, (kvd, exd) in enumerate(((None, None), ("int8", "int8"))):
                kvb = kv_cache_bytes(mine, 8, 512, kv_dtype=kvd)
                plan = plan_unpark(model_tensors(
                    mine, tp, kv_bytes_per_replica=kvb, expert_dtype=exd),
                    new)
                rplan = RPlan.plan_unpark(RTopo.model_tensors(
                    theirs, tp, kv_bytes_per_replica=kvb,
                    expert_dtype=exd), _jcfg(new))
                assert [(s.op.value, s.key.tensor, s.key.part, s.nbytes,
                         s.dst) for s in plan.steps] == \
                    [(s.op.value, s.key.tensor, s.key.part, s.nbytes, s.dst)
                     for s in rplan.steps]
                for preinit in (True, False):
                    for staging in ("serial", "overlap"):
                        kw = dict(preinit=preinit, staging=staging)
                        assert dataclasses.asdict(unpark_cost(plan, **kw)) \
                            == dataclasses.asdict(RCost.unpark_cost(rplan,
                                                                    **kw))
                        n += 1
                kw = dict(preinit=dp != 2, staging=("serial", "overlap")[i])
                got = TDriver.unpark_transition_cost(
                    mine, tp, new, kv_dtype=kvd, expert_dtype=exd,
                    kv_seq_len=512, **kw)
                want = RDriver.unpark_transition_cost(
                    theirs, tp, _jcfg(new), kv_dtype=kvd, expert_dtype=exd,
                    kv_seq_len=512, **kw)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert dataclasses.asdict(got) == \
                    dataclasses.asdict(unpark_cost(plan, **kw))
    assert n == 48


def test_unpark_pricing_holds_the_reference_assertions():
    """``test_unpark_transition_cost_pricing``: a cold start costs time and
    all of it is downtime; without a standby it costs the cold boot more;
    serial staging costs no less than overlapped.  A plan with a P2P step
    is not an unpark plan."""
    mcfg = get_config("deepseek-v2-lite-16b")
    tgt = _cfg(2)
    warm = TDriver.unpark_transition_cost(mcfg, 2, tgt)
    assert warm.scale_time_s > 0
    assert warm.downtime_s == warm.scale_time_s
    assert "cold_start" in warm.breakdown
    cold = TDriver.unpark_transition_cost(mcfg, 2, tgt, preinit=False)
    assert cold.scale_time_s > warm.scale_time_s
    serial = TDriver.unpark_transition_cost(mcfg, 2, tgt, staging="serial")
    assert serial.scale_time_s >= warm.scale_time_s
    plan = TDriver.transition_plan(mcfg, 2, _cfg(2), _cfg(3))[0]
    with pytest.raises(ValueError, match="unpark plan"):
        unpark_cost(plan)


# ----------------------------------------------------------- the IMM's keys

def _hmm_attrs(**kw):
    attrs = dict(kv_mode="paged", kv_block_size=16, kv_blocks_per_replica=64,
                 expert_mode="pooled", expert_pool_pages=0,
                 expert_slot_slack=0, kv_dtype=None, expert_dtype=None,
                 device=torch.device("cpu"))
    attrs.update(kw)
    return types.SimpleNamespace(**attrs)


def test_imm_standby_key_carries_model_identity():
    """``test_imm_standby_key_carries_model_identity``: two models on the
    same mesh never collide in a shared LRU, nor does one model with
    another layout knob.  The port's keys also carry the owning IMM: two
    servers of one model share the cache, each with its own instance,
    while ``has`` keeps the reference's meaning (cached by anyone)."""
    shared = OrderedDict()
    a = IMM(get_config("deepseek-v2-lite-16b"), _hmm_attrs(),
            batch_per_replica=4, max_len=128, shared_cache=shared)
    b = IMM(get_config("qwen3-30b-a3b"), _hmm_attrs(), batch_per_replica=4,
            max_len=128, shared_cache=shared)
    cfg = _cfg(2)
    assert a.model_key(cfg) != b.model_key(cfg)
    assert a._cache is b._cache
    shared[a._key(cfg)] = "standby-a"
    assert a.has(cfg) and not b.has(cfg)
    c = IMM(get_config("deepseek-v2-lite-16b"), _hmm_attrs(kv_block_size=32),
            batch_per_replica=4, max_len=128, shared_cache=shared)
    assert not c.has(cfg)
    a2 = IMM(get_config("deepseek-v2-lite-16b"), _hmm_attrs(),
             batch_per_replica=4, max_len=128, shared_cache=shared)
    assert a2.model_key(cfg) == a.model_key(cfg)
    assert a2._key(cfg) != a._key(cfg) and a2.has(cfg)


def _two_servers(shared, lru=4):
    out = []
    for seed in (0, 1):
        srv = ElasticServer(_mcfg(), tp=2, batch_per_replica=2, max_len=32,
                            prefill_buckets=(16,), seed=seed,
                            kv_mode="paged", kv_block_size=4,
                            expert_mode="pooled", imm_cache=shared,
                            all_devices=CPU8, device="cpu")
        srv.imm.lru_capacity = lru
        srv.boot(_cfg(1))
        out.append(srv)
    return out


def _tokens(srv, base):
    reqs = [Request(base + i, 0.0, 12, 6,
                    prompt=np.random.default_rng(i).integers(
                        1, 100, 12).astype(np.int32)) for i in range(2)]
    for r in reqs:
        srv.submit(r)
    t = 0.0
    while any(r.finish_s is None for r in reqs):
        srv.tick(t)
        t += 0.05
    return [srv.engine.generated[r.rid] for r in reqs]


def test_shared_imm_cache_keeps_each_servers_set():
    """Two servers of one model sharing one ``imm_cache`` serve with their
    solo tokens; one's scale and park release none of the other's set,
    and an eviction skips the other's live set."""
    solo = [_tokens(s, 0) for s in _two_servers(None)]
    shared = OrderedDict()
    s1, s2 = _two_servers(shared, lru=2)
    assert s1.imm.has(_cfg(1)) and s2.imm.has(_cfg(1))
    assert [_tokens(s1, 0), _tokens(s2, 0)] == solo
    live = shared[s2.imm._key(_cfg(1))]
    assert live.live and live.binding.matches(s2.engine.params,
                                              s2.engine.cache)
    s1.scale_to(_cfg(2))                 # past the capacity: s1's own go
    assert s2.imm._key(_cfg(1)) in shared and live.binding is not None
    assert s1.imm._key(_cfg(1)) not in shared
    s1.park()
    assert live.binding.matches(s2.engine.params, s2.engine.cache)
    assert all(inst.binding is None for k, inst in shared.items()
               if k[0] == s1.imm.owner)
    assert _tokens(s2, 10) == solo[1]
    for s in (s1, s2):
        s.hmm.close()


# ------------------------------------------------- fleet properties (a stub)

class _StubTask:
    """A stub's scale or unpark: commits after ``_Stub.STAGE`` polls (a
    scale-down once the slots it drops are empty)."""

    def __init__(self, be, target, kind):
        self.be, self.target, self.kind, self.polls = be, target, kind, 0
        self.phase = be.P.STAGING

    @property
    def done(self):
        return self.phase.terminal

    def advance(self, now):
        if self.phase.terminal:
            return self.phase
        self.polls += 1
        if self.polls >= _Stub.STAGE and len(self.be.running) <= \
                self.be.capacity(self.target):
            self.be.cfg = self.target
            self.be.parked = False
            self.phase = self.be.P.DONE
        return self.phase


class _Stub:
    """A deterministic backend for the ``FleetDriver`` (of either package:
    ``P`` and ``Cfg`` are its ``ScalePhase`` and ``ElasticConfig``):
    ``bpr`` slots a replica, FIFO admission (none while a task runs), the
    first token in the admitting tick and one more a tick after."""

    STAGE = 3
    staging_mode = "overlap"

    def __init__(self, P, Cfg, ndev, tp=2, bpr=4):
        self.P, self.Cfg, self.tp, self.bpr = P, Cfg, tp, bpr
        self.cfg = Cfg(ndev // tp, tp, tuple(range(ndev)))
        self.queue, self.running = [], []
        self.parked, self.task = False, None

    def current_config(self):
        return None if self.parked else self.cfg

    def capacity(self, cfg):
        return cfg.dp * self.bpr

    def queue_depth(self):
        return len(self.queue)

    def utilization(self):
        return 0.0 if self.parked else \
            len(self.running) / self.capacity(self.cfg)

    def submit(self, r):
        self.queue.append(r)

    def step(self, now):
        if self.parked:
            return []
        out = []
        for r in list(self.running):
            r.token_times.append(now)
            if len(r.token_times) >= r.output_len:
                r.finish_s = now
                self.running.remove(r)
                out.append(r)
        busy = self.task is not None and not self.task.done
        while not busy and self.queue and \
                len(self.running) < self.capacity(self.cfg):
            r = self.queue.pop(0)
            r.first_token_s, r.token_times = now, [now]
            self.running.append(r)
        return out

    def start_scale(self, target):
        kind = "down" if target.ndev < self.cfg.ndev else "up"
        self.task = _StubTask(self, target, kind)
        return self.task

    def start_unpark(self, target):
        assert self.parked
        self.task = _StubTask(self, target, "unpark")
        return self.task

    def park(self):
        assert not self.queue and not self.running and not self.parked
        self.parked = True


def _packages():
    """(name, ScalePhase, ElasticConfig, Request, fleet module, the
    ScalingPolicy and SLO, the model config) of each package."""
    from repro.configs import get_config as rget
    from repro.core.coordinator import ScalingPolicy as RPolicy
    from repro.core.topology import ElasticConfig as RCfg
    from repro.serving import fleet as RFleet
    from repro.serving.driver import ScalePhase as RPhase
    from repro.serving.metrics import SLO as RSLO
    from repro.serving.workload import Request as RRequest
    return [("port", TDriver.ScalePhase, ElasticConfig, Request, TFleet,
             ScalingPolicy, SLO, get_config("deepseek-v2-lite-16b")),
            ("ref", RPhase, RCfg, RRequest, RFleet, RPolicy, RSLO,
             rget("deepseek-v2-lite-16b"))]


def _policy(Policy, Slo):
    """``tests/test_fleet.py``'s policy."""
    return Policy(slo=Slo(ttft_s=10.0, tpot_s=1.5), window=8, cooldown_s=5.0,
                  queue_scale_up=3, confirm_s=0.5, idle_utilization=0.4)


def _arrivals(Req, windows, window_s, prompt_len=2000, output_len=24):
    """``tests/test_fleet.py``'s deterministic arrival stream."""
    reqs, rid = [], 0
    for i, rate in enumerate(windows):
        n = int(rate * window_s)
        for k in range(n):
            reqs.append(Req(rid, i * window_s + (k + 0.5) * window_s / n,
                            prompt_len, output_len))
            rid += 1
    return reqs


def _drive(fd, arrivals, cap_s=600.0):
    """``tests/test_fleet.py``'s loop: run in 30 s slabs (the invariants
    checked every tick inside) until every request finished."""
    until, first = 30.0, True
    total = sum(len(v) for v in arrivals.values())
    while True:
        res = fd.run(arrivals if first else {}, until=until)
        first = False
        if sum(len(v) for v in res.values()) == total:
            return res
        assert until < cap_s, f"fleet stalled at t={until}"
        until += 30.0


def _side_by_side(build):
    """Run ``build(package)`` -> (driver, arrivals) in both packages;
    their events, timelines, device seconds and request timestamps must
    be equal.  Returns the port's (driver, arrivals, finished)."""
    runs = {}
    for pkg in _packages():
        fd, arrivals = build(pkg)
        runs[pkg[0]] = (fd, arrivals, _drive(fd, arrivals))
    (fd, arr, res), (rfd, rarr, _) = runs["port"], runs["ref"]
    assert [dataclasses.asdict(e) for e in fd.events] == \
        [dataclasses.asdict(e) for e in rfd.events]
    assert fd.timeline == rfd.timeline
    assert fd.device_seconds() == rfd.device_seconds()
    stamps = {n: [(r.rid, r.first_token_s, r.finish_s) for r in v]
              for n, v in arr.items()}
    assert stamps == {n: [(r.rid, r.first_token_s, r.finish_s) for r in v]
                      for n, v in rarr.items()}
    return fd, arr, res


def test_fleet_boot_overflow_and_duplicate_names_raise():
    P, Cfg = TDriver.ScalePhase, ElasticConfig
    mcfg = get_config("deepseek-v2-lite-16b")

    def spec(name, ndev):
        return TFleet.FleetModelSpec(name=name, backend=_Stub(P, Cfg, ndev),
                                     policy=_policy(ScalingPolicy, SLO),
                                     mcfg=mcfg, tp=2)
    with pytest.raises(ValueError, match="already owned|cannot cover"):
        TFleet.FleetDriver([spec("a", 4), spec("b", 4)], range(6))
    with pytest.raises(ValueError, match="duplicate model names"):
        TFleet.FleetDriver([spec("a", 2), spec("a", 2)], range(8))


def test_fleet_parks_idle_model_and_unparks_on_next_request():
    """An idle trough parks the model (its lease back to the pool); the
    next queued request unparks it and is served."""
    def build(pkg):
        _, P, Cfg, Req, F, Policy, Slo, mcfg = pkg
        spec = F.FleetModelSpec(name="solo", backend=_Stub(P, Cfg, 2),
                                policy=_policy(Policy, Slo), mcfg=mcfg, tp=2,
                                min_devices=0, park_after_idle_s=5.0)
        fd = F.FleetDriver([spec], range(4), F.FleetConfig(
            dt=0.1, settle_s=2.0, sample_every_s=2.0))
        reqs = _arrivals(Req, [2.0], 10.0) + [Req(100, 60.0, 2000, 24)]
        return fd, {"solo": reqs}
    fd, _, res = _side_by_side(build)
    kinds = [e.kind for e in fd.events]
    assert "park" in kinds and "unpark" in kinds
    assert kinds.index("park") < kinds.index("unpark")
    assert len(res["solo"]) == 21
    parked_t = next(e.t for e in fd.events if e.kind == "park")
    unparked_t = next(e.t for e in fd.events if e.kind == "unpark")
    for row in fd.timeline:
        if parked_t < row["t"] < unparked_t:
            assert row["solo"] == 0 and row["free"] == 4
    fd.check_invariants()


@_given_or_cases(
    [([0.0, 1.0, 0.0], [3.0, 0.0, 5.0], 0),
     ([1.0, 3.0, 0.0], [0.0, 5.0, 1.0], 4),
     ([0.0, 0.0, 3.0], [5.0, 3.0, 0.0], 4)],
    windows_a=st.lists(st.sampled_from([0.0, 0.0, 1.0, 3.0]),
                       min_size=3, max_size=3) if HAVE_HYPOTHESIS else None,
    windows_b=st.lists(st.sampled_from([0.0, 1.0, 3.0, 5.0]),
                       min_size=3, max_size=3) if HAVE_HYPOTHESIS else None,
    floor_b=st.sampled_from([0, 4]) if HAVE_HYPOTHESIS else None)
def test_fleet_random_demand_conserves_devices_and_floors(windows_a,
                                                          windows_b,
                                                          floor_b):
    """Random per-model demand: the pool is conserved every tick, the
    ``min_devices`` floor holds, every parked model with a queue unparks
    (every request finishes) — and both packages' drivers agree."""
    def build(pkg):
        _, P, Cfg, Req, F, Policy, Slo, mcfg = pkg
        specs = [F.FleetModelSpec(name="a", backend=_Stub(P, Cfg, 2),
                                  policy=_policy(Policy, Slo), mcfg=mcfg,
                                  tp=2, min_devices=0,
                                  park_after_idle_s=8.0),
                 F.FleetModelSpec(name="b",
                                  backend=_Stub(P, Cfg, max(floor_b, 2)),
                                  policy=_policy(Policy, Slo), mcfg=mcfg,
                                  tp=2, min_devices=floor_b,
                                  park_after_idle_s=8.0)]
        fd = F.FleetDriver(specs, range(10), F.FleetConfig(
            dt=0.1, settle_s=3.0, max_step_dp=2, sample_every_s=5.0))
        return fd, {"a": _arrivals(Req, windows_a, 25.0),
                    "b": _arrivals(Req, windows_b, 25.0)}
    fd, arrivals, res = _side_by_side(build)
    assert sorted(len(v) for v in res.values()) == \
        sorted(len(v) for v in arrivals.values())
    fd.check_invariants()
    leases = {n: s.lease for n, s in fd.states.items()}
    assert sum(map(len, leases.values())) + len(fd.pool.free()) == 10
    if floor_b > 0:
        assert not any(e.kind == "park" and e.model == "b"
                       for e in fd.events)
        assert all(row["b"] >= floor_b for row in fd.timeline)
        assert len(leases["b"]) >= floor_b
    for e in fd.events:
        if e.kind == "down":
            dst_dp = int(e.dst.split("DP")[1].split("-")[0])
            assert dst_dp >= fd._min_dp(fd.states[e.model].spec)


@_given_or_cases(
    [(20.0, 1), (35.0, 2), (50.0, 4)],
    gap=st.sampled_from([20.0, 35.0, 50.0]) if HAVE_HYPOTHESIS else None,
    late_n=st.integers(1, 4) if HAVE_HYPOTHESIS else None)
def test_fleet_parked_model_next_request_always_unparks(gap, late_n):
    """Whatever the idle gap and the late batch, a parked model's queued
    requests unpark it and all finish."""
    def build(pkg):
        _, P, Cfg, Req, F, Policy, Slo, mcfg = pkg
        spec = F.FleetModelSpec(name="m", backend=_Stub(P, Cfg, 2),
                                policy=_policy(Policy, Slo), mcfg=mcfg, tp=2,
                                min_devices=0, park_after_idle_s=6.0)
        fd = F.FleetDriver([spec], range(4), F.FleetConfig(dt=0.1,
                                                          settle_s=2.0))
        reqs = _arrivals(Req, [1.0], 8.0)
        reqs += [Req(1000 + i, 8.0 + gap + 0.1 * i, 2000, 24)
                 for i in range(late_n)]
        return fd, {"m": reqs}
    fd, arrivals, res = _side_by_side(build)
    assert len(res["m"]) == len(arrivals["m"])
    kinds = [e.kind for e in fd.events]
    if "park" in kinds:
        assert "unpark" in kinds[kinds.index("park"):]


# ------------------------------------------------------------ HMM round trips

@pytest.fixture(scope="module")
def hmm_runs(ref):
    out, _ = ref
    pre = {}
    ns = _port_ns(out, pre)
    got, hmms = {}, {}
    for name in HMM_NAMES:
        got[name], hmms[name] = ns["hmm_case"](name)
        hmms[name].close()
    return json.loads(json.dumps(got)), hmms, pre


@pytest.mark.parametrize("name", HMM_NAMES)
def test_hmm_park_unpark_bytes_and_table_equal_reference(ref, hmm_runs,
                                                        name):
    """The park's and the unpark's byte fields (staged and after the
    commit), ``parked_bytes``, ``host_tier_bytes`` while parked, after an
    aborted unpark (the snapshot kept) and after the retried one, and the
    page table the unpark placed, all equal the reference's."""
    want, got = ref[1]["hmm"][name], hmm_runs[0][name]
    assert got == want
    assert got["park"]["d2h_bytes"] > 0 and got["unpark"]["h2d_bytes"] > 0
    assert got["after_abort"][:2] == got["parked"][:2]
    assert got["after"][:2] == [False, 0]


@pytest.mark.parametrize("name", HMM_NAMES)
def test_hmm_unpark_restores_every_parameter(ref, hmm_runs, name):
    """After the unpark every logical parameter equals the pre-park one
    bit for bit, and every parameter (the pool's layout and the index
    arrays included) equals the reference's after its unpark."""
    _, hmms, pre = hmm_runs
    hmm = hmms[name]
    post = _logical(hmm)
    assert post.keys() == pre[name].keys()
    for k, t in pre[name].items():
        assert torch.equal(_bits(post[k]), _bits(t)), k
    want = _tree(ref[0] / f"{name}_after.npz")
    want = dict(tree_leaves_with_path(want))
    leaves = dict(tree_leaves_with_path(hmm.params))
    assert leaves.keys() == want.keys()
    for path, leaf in leaves.items():
        assert torch.equal(_bits(_whole(leaf)), _bits(want[path])), path


# ------------------------------------------------------ the server round trip

def _throttle(srv):
    """The reference test's trick: the IMM's cache cleared (the capture is
    not a hit) and each H2D op slowed, so the copies span the capture; the
    capture slowed too, since the CPU captures no graph."""
    srv.imm._cache.clear()
    unit, pre = srv.hmm._stage_unit, srv.imm.preinitialize

    def slow_unit(*a, **k):
        time.sleep(0.05)
        return unit(*a, **k)

    def slow_capture(*a, **k):
        time.sleep(0.05)
        return pre(*a, **k)
    srv.hmm._stage_unit, srv.imm.preinitialize = slow_unit, slow_capture

    def undo():
        del srv.hmm._stage_unit, srv.imm.preinitialize
    return undo


@pytest.fixture(scope="module")
def park_run(ref, tmp_path_factory):
    ns = _port_ns(ref[0])
    tr = obs.install(obs.Tracer(capacity=200_000))
    try:
        res, srv = ns["park_case"](_throttle)
        path = tmp_path_factory.mktemp("trace") / "trace.json"
        doc = obs.write_chrome_trace(str(path), tr)
    finally:
        obs.install(None)
    srv.hmm.close()
    return json.loads(json.dumps(res)), doc, path


def test_server_park_unpark_tokens_and_bytes_equal_reference(ref, park_run):
    """Tokens after park -> unpark equal the never-parked server's and the
    reference's; parked, the server reports no configuration, no load and
    serves nothing while a submit queues; the park and unpark bytes and
    the unpark's event equal the reference's; a park with a live sequence
    and one during a scale are refused (the reference asserts)."""
    got, want = dict(park_run[0]), dict(ref[1]["park"])
    assert got.pop("refused") == ["RuntimeError", "RuntimeError"]
    assert want.pop("refused") == ["AssertionError", "AssertionError"]
    assert got == want
    assert got["after"] == got["base"]
    assert got["parked"][:5] == [True, True, 0.0, [], 1]
    assert got["park"]["d2h_bytes"] == got["parked"][5] > 0
    assert got["unpark_phase"] == ["DONE", "parked", "DP1-TP2-EP2@[0, 1]",
                                   False]
    assert len(got["late"]) == 8


def test_unpark_copies_overlap_the_capture_in_the_trace(park_run):
    _, doc, path = park_run
    obs.validate_trace(doc)
    assert obs.load_trace(str(path)) == doc
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    h2d = [e for e in spans if str(e["name"]).startswith("unpark:")]
    comp = [e for e in spans if e["name"] == "unpark.compile"]
    assert h2d and comp
    assert {e["name"] for e in spans} >= {"unpark.STAGING",
                                          "unpark.COMMITTING", "hmm.park",
                                          "hmm.begin_unpark"}

    def overlap(a, b):
        return max(a["ts"], b["ts"]) < min(a["ts"] + a["dur"],
                                           b["ts"] + b["dur"])
    assert any(overlap(a, b) for a in h2d for b in comp)


# ------------------------------------------------ the fleet over real servers

@pytest.fixture(scope="module")
def fleet_run(ref):
    ns = _port_ns(ref[0])
    res, fd, srvs = ns["fleet_case"](TFleet.FleetDriver,
                                     TFleet.FleetModelSpec,
                                     TFleet.FleetConfig, ScalingPolicy, SLO)
    for srv in srvs.values():
        srv.hmm.close()
    return json.loads(json.dumps(res)), fd


@pytest.mark.parametrize("field", ["events", "timeline", "requests",
                                   "tokens", "scale_events",
                                   "device_seconds"])
def test_fleet_over_servers_equals_reference(ref, fleet_run, field):
    assert fleet_run[0][field] == ref[1]["fleet"][field]


def test_fleet_parks_scales_onto_freed_ids_and_unparks(fleet_run):
    """"a" scales down and parks, "b" scales up onto ids "a" held, then
    "a" unparks; "b" scales down; every request finishes with
    in-vocabulary tokens and the pool is conserved."""
    got, fd = fleet_run
    ev = [(e["model"], e["kind"]) for e in got["events"]]
    park, up, unpark = (ev.index(("a", "park")), ev.index(("b", "up")),
                        ev.index(("a", "unpark")))
    assert park < up < unpark and ("b", "down") in ev[up:]
    assert {"up", "down", "park", "unpark"} <= {k for _, k in ev}
    fd.check_invariants()
    assert set(fd.states["b"].lease) & {0, 1, 2, 3}    # "a"'s boot ids
    for name, reqs in got["requests"].items():
        for rid, arrival, first, finish, times in reqs:
            assert first is not None and finish is not None
            toks = got["tokens"][name][str(rid)]
            assert len(toks) == len(times) == 8
            assert all(0 <= x < 128 for x in toks)
