"""The closed loop (the paper's Coordinator, §4.3) against the reference,
on the CPU: the workload generators, the metrics, the logical tensors, the
planner and the cost model, the load estimator, the device pool, the
``ClusterDriver`` over the port's ``ElasticServer``, and the launcher.

The host modules run in this process against ``repro``'s: equal requests
for a seed, equal ``summarize`` / ``slo_attainment_timeline`` values,
equal ``model_tensors`` and ``kv_cache_bytes`` for every config the port
registers, every ``ScalingCost`` field of ``transition_cost`` equal over a
grid (every strategy; dense and pooled experts, the pooled case from a
live port table after one remap against the reference's table in the same
state; serial and overlap staging; KV migration bytes; int8 pools), equal
estimator decisions over a scripted sequence.

The servers: one reference subprocess with 8 simulated host devices (as
``tests/helpers.run_with_devices`` runs it) runs the reference's
``ClusterDriver`` over its ``ElasticServer`` and saves the boot weights;
the port's driver runs over the port's server on ``[cpu] * 8`` from them.
Case 1 (TEST_MOE at tp = 2, DP2 -> DP3 -> DP2, dense KV, serial staging,
the schedule of ``test_engine_backend_closed_loop_up_then_down``): the
``DriverEvent`` list equal field for field apart from the wall-clock
``stall_s`` and ``overlap_eff``, every request's ``first_token_s``,
``finish_s`` and ``token_times``, the greedy tokens and every scale's
``TransferStats`` bytes.  Case 2 (tp = 1, paged KV, pooled pages, chunked
prefill, scale-down by migrate, ``min_dp=2``): directions, targets,
projections, tokens and bytes.  In case 2 both sides join a MIGRATING
poll's copy sessions before the next tick (as ``tests/
test_torch_scaledown.py`` does), so which blocks move, and when, is the
same on both.

The launcher: ``python -m repro_torch.launch.serve --device cpu
--autoscale`` prints the reference launcher's scale lines and summary
(driver seconds, independent of the weights), with the default flags
(deepseek-v2-lite, 12 requests: no scale) and with qwen1.5-0.5b and 32
requests (one scale up).  The smoke configs' four experts do not split
over DP3's six devices in either package, so the MoE runs never scale.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from helpers import REPO
from test_torch_scale import (COMMON, CPU8, REF_XLA_FLAGS, _mcfg, _start,
                              _tree, _wait)
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core import costmodel as TCost
from repro_torch.core import topology as TTopo
from repro_torch.core.coordinator import LoadEstimator, ScalingPolicy
from repro_torch.core.elastic_engine import ElasticServer
from repro_torch.core.expert_pages import ExpertPageTable
from repro_torch.core.hmm import HMM
from repro_torch.core.scaling_plan import STRATEGIES
from repro_torch.core.topology import ElasticConfig
from repro_torch.serving import metrics as TMetrics
from repro_torch.serving import workload as TWork
from repro_torch.serving.driver import (ClusterDriver, DevicePool,
                                        DriverConfig, ScalePhase,
                                        ServingBackend, transition_cost)

PAGED = dict(kv_mode="paged", kv_block_size=16, expert_mode="pooled",
             prefill_chunk=32, prefill_budget=64)
# name: tp, boot dp, device pool, server knobs, SLO ttft, DriverConfig
# knobs, request groups (schedule, output range, seed), prompt length
CASES = {
    "case1": dict(tp=2, dp=2, pool=6, server={}, ttft=1.0,
                  driver=dict(dt=0.05, settle_s=2.0, prewarm_next=False),
                  groups=[([(0.0, 2), (0.5, 7), (6.0, 1)], (10, 24), 1)],
                  prompt_len=16),
    "case2": dict(tp=1, dp=2, pool=6, server=PAGED, ttft=3.0,
                  driver=dict(dt=0.05, settle_s=2.0, prewarm_next=False,
                              min_dp=2),
                  groups=[([(0.0, 2), (0.5, 7)], (10, 24), 1),
                          ([(0.5, 2)], (70, 90), 2),
                          ([(5.0, 2), (6.0, 2)], (10, 24), 3)],
                  prompt_len=40),
}
WALL_FIELDS = ("stall_s", "overlap_eff")

SCRIPT = COMMON + '''
from repro.core.coordinator import ScalingPolicy
from repro.core.elastic_engine import ElasticServer
from repro.core.hmm import TransferStats
from repro.serving.driver import ClusterDriver, DriverConfig
from repro.serving.metrics import SLO
from repro.serving.workload import scripted_burst
CASES = %s


def joining(srv):
    """Join a MIGRATING poll's copy sessions before the next tick."""
    start = srv.start_scale

    def start_scale(target):
        task = start(target)
        adv = task.advance

        def advance(now):
            phase = adv(now)
            for _, sess in task._mig_inflight:
                sess.join()
            return phase
        task.advance = advance
        return task
    srv.start_scale = start_scale


def requests(case):
    reqs = []
    for sched, outs, seed in case["groups"]:
        reqs += scripted_burst(sched, prompt_len=case["prompt_len"],
                               output_range=outs, vocab_size=128, seed=seed,
                               rid0=len(reqs))
    reqs.sort(key=lambda r: r.arrival_s)
    return reqs


res = {}
for name, case in CASES.items():
    tp = case["tp"]
    srv = ElasticServer(MCFG, tp=tp, batch_per_replica=2, max_len=128,
                        prefill_buckets=(32,), seed=0, **case["server"])
    srv.boot(cfg(case["dp"], tp))
    np.savez(f"{OUT}/{name}.npz", **flat(srv.hmm.params))
    joining(srv)
    policy = ScalingPolicy(slo=SLO(ttft_s=case["ttft"], tpot_s=1.0),
                           window=8, cooldown_s=1.0, queue_scale_up=3)
    driver = ClusterDriver(srv, policy, mcfg=MCFG, tp=tp,
                           device_pool=range(case["pool"]),
                           config=DriverConfig(**case["driver"]))
    reqs = requests(case)
    until = 0.0
    while any(r.finish_s is None for r in reqs):
        until += 10.0
        driver.run(reqs if until == 10.0 else [], until=until)
        assert until < 200.0, "stalled"
    res[name] = {
        "events": [dataclasses.asdict(e) for e in driver.events],
        "requests": {str(r.rid): [r.first_token_s, r.finish_s,
                                  r.token_times] for r in reqs},
        "tokens": {str(r.rid): srv.engine.generated[r.rid] for r in reqs},
        "stats": [{f: int(getattr(ev.stats, f))
                   for f in TransferStats.BYTE_FIELDS}
                  for ev in srv.events],
        "migrated": [ev.migrated_blocks for ev in srv.events],
        "final": srv.hmm.active_cfg.describe()}
json.dump(res, open(f"{OUT}/closed_loop.json", "w"))
print("CLOSED-LOOP-DONE")
'''

# (launcher arguments) — the default run, and one that scales up
LAUNCHES = {"default": [],
            "scales": ["--arch", "qwen1.5-0.5b", "--requests", "32"]}


def _launch(module, args, extra_env):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               REPRO_SERVE_DEVICES="8", **extra_env)
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--autoscale", *args], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    proc.started = time.perf_counter()
    return proc


def _launcher_lines(proc):
    out = _wait(proc, "launcher")
    return [ln for ln in out.splitlines()
            if ln.startswith("[t=") or ln.startswith("{'n'")]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference servers and both packages' launchers, started
    together."""
    out = tmp_path_factory.mktemp("closed_loop_ref")
    proc = _start(SCRIPT % repr(CASES), out)
    xla = {"XLA_FLAGS": REF_XLA_FLAGS, "OMP_NUM_THREADS": "1"}
    launches = {
        name: (_launch("repro.launch.serve", args, xla),
               _launch("repro_torch.launch.serve", ["--device", "cpu",
                                                    *args],
                       {"OMP_NUM_THREADS": "1"}))
        for name, args in LAUNCHES.items()}
    lines = {name: tuple(_launcher_lines(p) for p in procs)
             for name, procs in launches.items()}
    _wait(proc, "closed loop")
    return {"dir": out, "launches": lines,
            "res": json.load(open(out / "closed_loop.json"))}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The servers' steps are tiny: one intra-op thread (the suite runs
    several test workers on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(dp, tp=1, base=0):
    return ElasticConfig(dp, tp, tuple(range(base, base + dp * tp)))


def _same(a, b) -> bool:
    """Equality with NaN equal to NaN (a latency snapshot before the first
    finish)."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


# ------------------------------------------------------------- workloads

def _fields(r):
    out = dataclasses.asdict(r)
    out["prompt"] = None if r.prompt is None else r.prompt.tolist()
    return out


def _workloads(W):
    return {
        "make_fixed": W.make_workload(duration_s=5.0,
                                      rps_fn=W.fixed_rate(6.0),
                                      prompt_len=64, output_range=(4, 9),
                                      seed=3, vocab_size=97),
        "make_range_burst": W.make_workload(
            duration_s=10.0, rps_fn=W.burst(2.0, 16.0, 2.0, 1.0),
            prompt_len=(200, 1000), output_range=(16, 48), seed=0,
            vocab_size=151936),
        "make_sampler_ramp": W.make_workload(
            duration_s=6.0, rps_fn=W.ramp(1.0, 9.0, 4.0),
            prompt_len=lambda rng: int(rng.integers(3, 30)) * 2, seed=5,
            dt=0.1),
        "make_step_diurnal": W.make_workload(
            duration_s=8.0,
            rps_fn=lambda t: W.step_up(1.0, 5.0, 3.0)(t)
            + W.diurnal(0.5, 4.0, 4.0, 0.25)(t), seed=7, vocab_size=50),
        "shared": W.shared_prefix_workload(
            [(0.0, 3), (0.4, 5)], prefix_len=20, num_prefixes=2,
            vocab_size=64, seed=2, rid0=4),
        "scripted": W.scripted_burst([(0.0, 2), (0.5, 7), (6.0, 1)],
                                     vocab_size=128, seed=1),
        "merged": W.merge_arrivals(
            W.scripted_burst([(0.0, 2), (1.0, 3)], seed=1), 1,
            W.scripted_burst([(0.5, 2)], seed=2, rid0=10)),
        **{f"fleet_{m}": reqs for m, reqs in W.fleet_workload(
            ["a", "b", "c"], duration_s=6.0, base_rps=1.0, peak_rps=6.0,
            period_s=4.0, burst_rps=5.0, burst_width_s=0.5,
            prompt_len=(8, 40), output_range=(3, 7), seed=11).items()},
    }


def test_workload_generators_equal_reference():
    from repro.serving import workload as RWork
    got, want = _workloads(TWork), _workloads(RWork)
    assert got.keys() == want.keys()
    for name in want:
        assert [_fields(r) for r in got[name]] == \
            [_fields(r) for r in want[name]], name
        assert len(want[name]) > 0, name
    for phase in (0.0, 0.3, 0.75):
        assert TWork.diurnal_crest(7.0, phase) == \
            RWork.diurnal_crest(7.0, phase)


# --------------------------------------------------------------- metrics

def _finished(W, seed):
    """Requests with a fixed random history: finished, one-token,
    first-token-only and waiting ones."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(40):
        arr = float(rng.uniform(0, 20))
        out = int(rng.integers(1, 30))
        r = W.Request(i, arr, 16, out)
        kind = i % 5
        if kind < 3:
            first = arr + float(rng.exponential(0.8))
            gaps = rng.exponential(0.07, out - 1)
            r.first_token_s = first
            r.token_times = [first, *(first + np.cumsum(gaps)).tolist()]
            r.finish_s = r.token_times[-1]
        elif kind == 3:
            r.first_token_s = arr + 0.5
            r.token_times = [r.first_token_s]
        reqs.append(r)
    return reqs


class _Backend:
    def __init__(self, kv, scaling):
        self._kv, self._scaling = kv, scaling

    def kv_stats(self):
        return self._kv

    def scaling_summary(self):
        return self._scaling


BACKENDS = {
    "none": None,
    "dense": _Backend(None, None),
    "paged": _Backend({"num_blocks": 64, "used_blocks": 17,
                       "utilization": 17 / 64, "preemptions": 2},
                      {"staging_mode": "overlap", "decode_stall_s": 0.25,
                       "overlap_efficiency": 1.7,
                       "scaledown_mode": "migrate", "migrated_blocks": 6,
                       "migration_bytes": 98304}),
}


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("seed", [0, 1])
def test_summarize_and_timeline_equal_reference(backend, seed):
    from repro.serving import metrics as RMetrics
    from repro.serving import workload as RWork
    got_reqs, want_reqs = _finished(TWork, seed), _finished(RWork, seed)
    for slo in (None, (1.0, 0.1), (0.3, 0.05)):
        t_slo = slo and TMetrics.SLO(*slo)
        r_slo = slo and RMetrics.SLO(*slo)
        got = TMetrics.summarize(got_reqs, t_slo, backend=BACKENDS[backend])
        want = RMetrics.summarize(want_reqs, r_slo,
                                  backend=BACKENDS[backend])
        assert got.keys() == want.keys()
        assert all(_same(got[k], want[k]) for k in want), (got, want)
        if slo is None:
            continue
        for window, dt in ((10.0, 1.0), (2.5, 0.5)):
            gt, ga = TMetrics.slo_attainment_timeline(got_reqs, t_slo,
                                                      window, dt)
            wt, wa = RMetrics.slo_attainment_timeline(want_reqs, r_slo,
                                                      window, dt)
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(ga, wa)
        assert TMetrics.throughput_rps(got_reqs, 2.0, 9.0) == \
            RMetrics.throughput_rps(want_reqs, 2.0, 9.0)
    per = {"a": got_reqs[:20], "b": got_reqs[20:]}
    rper = {"a": want_reqs[:20], "b": want_reqs[20:]}
    dev_s = {"a": 3600.0, "b": 900.0}
    assert TMetrics.fleet_summary(per, TMetrics.SLO(1.0, 0.1), dev_s) == \
        RMetrics.fleet_summary(rper, RMetrics.SLO(1.0, 0.1), dev_s)


# ------------------------------------------------- tensors and cost model

def _ref_config(name):
    from repro.configs import get_config as ref_get_config
    return ref_get_config(name)


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_model_tensors_and_kv_bytes_equal_reference(name):
    from repro.core import topology as RTopo
    mine, theirs = get_config(name), _ref_config(name)
    for tp in (1, 2):
        for kv_dtype, expert_dtype in ((None, None), ("int8", "int8"),
                                       ("int8", None)):
            kvb = TTopo.kv_cache_bytes(mine, 8, 4096, kv_dtype=kv_dtype)
            assert kvb == RTopo.kv_cache_bytes(theirs, 8, 4096,
                                               kv_dtype=kv_dtype)
            got = TTopo.model_tensors(mine, tp, kv_bytes_per_replica=kvb,
                                      expert_dtype=expert_dtype)
            want = RTopo.model_tensors(theirs, tp, kv_bytes_per_replica=kvb,
                                       expert_dtype=expert_dtype)
            assert [dataclasses.astuple(t) for t in got] == \
                [dataclasses.astuple(t) for t in want]


def test_dtype_bytes_equal_reference():
    from repro.core import costmodel as RCost
    assert TCost.DTYPE_BYTES == RCost.DTYPE_BYTES
    for d in [None, *RCost.DTYPE_BYTES, np.float16, np.dtype("int16")]:
        assert TCost.dtype_bytes(d) == RCost.dtype_bytes(d)
    assert dataclasses.asdict(TCost.DEFAULT_HW) == \
        dataclasses.asdict(RCost.DEFAULT_HW)


def _live_tables(mcfg, dp0, dp1):
    """A port HMM's page table after one committed remap DP{dp0} ->
    DP{dp1} (tp = 1), and the reference's table in the same state."""
    from repro.core.expert_pages import ExpertPageTable as RTable
    hmm = HMM(mcfg, 1, batch_per_replica=2, max_len=32, all_devices=CPU8,
              device="cpu", kv_mode="paged", kv_block_size=16,
              expert_mode="pooled")
    hmm.boot(_cfg(dp0))
    hmm.scale(_cfg(dp1))
    hmm.commit()
    mine = hmm.page_table
    theirs = RTable(mine.num_layers, mine.num_experts,
                    pool_pages_per_device=mine.pool_pages)
    theirs.initial_place(_cfg(dp0))
    theirs.stage_remap(_cfg(dp1))
    theirs.commit()
    assert {k: (v.device, v.page) for k, v in mine.active.items()} == \
        {k: (v.device, v.page) for k, v in theirs.active.items()}
    return mine, theirs


def _snapshot(table):
    return (dict(table.active), table.staged and dict(table.staged),
            {d: list(v) for d, v in table._free.items()})


def _cost_dict(cost):
    return dataclasses.asdict(cost)


COST_MODELS = {"moe": lambda: _mcfg(),
               "qwen3": lambda: get_config("qwen3-30b-a3b"),
               "dsv2": lambda: get_config("deepseek-v2-lite-16b")}


@pytest.mark.parametrize("model", sorted(COST_MODELS))
def test_transition_cost_equals_reference_over_the_grid(model):
    from repro.serving import driver as RDriver
    mcfg = COST_MODELS[model]()
    rcfg = (_ref_config(mcfg.name) if model != "moe"
            else _ref_moe())
    from repro.core.topology import ElasticConfig as RCfg

    def rc(c):
        return c and RCfg(c.dp, c.tp, c.devices)

    mine_t, theirs_t = _live_tables(_mcfg(), 4, 6)
    n = 0
    for tp in (1, 2):
        for strategy in sorted(STRATEGIES):
            disjoint = strategy in ("extravagant", "horizontal")
            pairs = [(_cfg(2, tp), _cfg(3, tp, base=2 * tp if disjoint
                                           else 0)),
                     (_cfg(3, tp), _cfg(2, tp, base=3 * tp if disjoint
                                           else 0))]
            for old, new in pairs:
                for expert_mode in ("dense", "pooled"):
                    for staging in ("serial", "overlap"):
                        for mig, kvd, exd in ((0, None, None),
                                              (5 << 20, "int8", "int8")):
                            kw = dict(strategy=strategy, staging=staging,
                                      expert_mode=expert_mode,
                                      kv_migration_bytes=mig,
                                      kv_dtype=kvd, expert_dtype=exd,
                                      preinit=(mig == 0), kv_seq_len=512)
                            got = transition_cost(mcfg, tp, old, new, **kw)
                            want = RDriver.transition_cost(
                                rcfg, tp, rc(old), rc(new), **kw)
                            assert _cost_dict(got) == _cost_dict(want), kw
                            n += 1
    # pooled from the live tables (TEST_MOE at tp = 1, after DP4 -> DP6)
    before = _snapshot(mine_t)
    for new in (_cfg(3), _cfg(4), _cfg(5), _cfg(8)):
        for staging in ("serial", "overlap"):
            for mig in (0, 3 << 20):
                kw = dict(expert_mode="pooled", staging=staging,
                          kv_migration_bytes=mig)
                got = transition_cost(_mcfg(), 1, _cfg(6), new,
                                      page_table=mine_t, **kw)
                want = RDriver.transition_cost(_ref_moe(), 1, rc(_cfg(6)),
                                               rc(new), page_table=theirs_t,
                                               **kw)
                assert _cost_dict(got) == _cost_dict(want), (new, kw)
                n += 1
    assert _snapshot(mine_t) == before       # projected on a clone
    assert n > 100


def _ref_moe(**kw):
    from repro.configs.base import ModelConfig as RModelConfig
    return RModelConfig(**dataclasses.asdict(_mcfg(**kw)))


def test_clone_is_independent_and_a_pool_too_small_raises_as_the_reference():
    from repro.core.expert_pages import ExpertPageTable as RTable
    from repro.core.topology import ElasticConfig as RCfg
    from repro.serving import driver as RDriver
    t = ExpertPageTable(2, 24)
    t.initial_place(_cfg(4))
    t.stage_remap(_cfg(6))
    before = _snapshot(t)
    c = t.clone()
    assert _snapshot(c) == before
    c.commit()
    c.stage_remap(_cfg(3))
    c.abort()
    assert _snapshot(t) == before
    t.commit()
    # a pool with no spare page: staging a scale-down's pages fails alike
    small, rsmall = (ExpertPageTable(1, 24, pool_pages_per_device=8),
                     RTable(1, 24, pool_pages_per_device=8))
    small.initial_place(_cfg(3))
    rsmall.initial_place(RCfg(3, 1, (0, 1, 2)))
    before = _snapshot(small)
    with pytest.raises(MemoryError):
        transition_cost(_mcfg(num_layers=1), 1, _cfg(3), _cfg(2),
                        expert_mode="pooled", page_table=small)
    with pytest.raises(MemoryError):
        RDriver.transition_cost(_ref_moe(num_layers=1), 1,
                                RCfg(3, 1, (0, 1, 2)), RCfg(2, 1, (0, 1)),
                                expert_mode="pooled", page_table=rsmall)
    assert _snapshot(small) == before
    # the driver turns it into a veto
    backend = types.SimpleNamespace(expert_mode="pooled",
                                    hmm=types.SimpleNamespace(
                                        page_table=small))
    driver = ClusterDriver(backend, ScalingPolicy(slo=TMetrics.SLO(1, 1)),
                           mcfg=_mcfg(num_layers=1), tp=1,
                           device_pool=range(4))
    assert driver.projected_cost_s(_cfg(3), _cfg(2)) == math.inf
    assert math.isfinite(driver.projected_cost_s(_cfg(3), _cfg(4)))
    assert _snapshot(small) == before


# --------------------------------------------------------- the estimator

def _decisions(module_policy, module_slo, module_work, confirm_s):
    """Drive an estimator through a scripted sequence over 40 s: spells
    of good and of late finishes, of queue spikes, of idle and of mixed
    load."""
    policy = module_policy(slo=module_slo(ttft_s=1.0, tpot_s=0.1),
                           window=8, cooldown_s=3.0, queue_scale_up=4,
                           confirm_s=confirm_s)
    from repro.core.coordinator import LoadEstimator as RLoad
    est = (LoadEstimator if module_policy is ScalingPolicy else RLoad)(
        policy)
    rng = np.random.default_rng(4)
    out = []
    for k in range(800):
        now = k * 0.05
        if rng.random() < 0.3:
            r = module_work.Request(k, now - 1.0, 8, 10)
            late = (now // 8) % 2 == 1
            r.first_token_s = now - (0.1 if not late else -0.5)
            r.finish_s = r.first_token_s + 9 * (0.05 if not late else 0.2)
            est.record(r)
        phase = int(now // 5) % 3       # spikes, idle, mixed
        queue = int(rng.integers(0, 7)) if phase == 0 else 0
        util = (float(rng.uniform(0.5, 0.9)) if phase == 0 else 0.1
                if phase == 1 else float(rng.uniform(0.0, 0.8)))
        out.append((est.decide(now, queue, util), est.attainment()))
    return out


@pytest.mark.parametrize("confirm_s", [0.0, 0.4, 1.5])
def test_load_estimator_decisions_equal_reference(confirm_s):
    from repro.core.coordinator import ScalingPolicy as RPolicy
    from repro.serving import metrics as RMetrics
    from repro.serving import workload as RWork
    got = _decisions(ScalingPolicy, TMetrics.SLO, TWork, confirm_s)
    want = _decisions(RPolicy, RMetrics.SLO, RWork, confirm_s)
    assert got == want
    dirs = [d for d, _ in got if d]
    assert "up" in dirs and "down" in dirs


def test_device_pool_refuses_double_claims_and_foreign_releases():
    pool = DevicePool(range(6))
    assert pool.claim("a", [0, 1]) == (0, 1)
    with pytest.raises(ValueError, match="already owned"):
        pool.claim("b", [1, 2])
    with pytest.raises(ValueError, match="already owned"):
        pool.claim("a", [0])
    with pytest.raises(ValueError, match="not in the pool"):
        pool.claim("b", [6])
    with pytest.raises(ValueError, match="duplicate"):
        pool.claim("b", [3, 3])
    with pytest.raises(ValueError, match="not 'b'"):
        pool.release("b", [0])
    with pytest.raises(ValueError, match="duplicate"):
        DevicePool([0, 0])
    pool.claim("b", [4])
    pool.check_invariants({"a": [0, 1], "b": [4]})
    with pytest.raises(AssertionError):
        pool.check_invariants({"a": [0, 1]})
    pool.release("a", [0, 1])
    assert pool.free() == (0, 1, 2, 3, 5) and pool.owned("b") == (4,)
    # a driver claims its whole pool: a second one over it is refused
    srv = _server("case1")
    shared = DevicePool(range(6))
    policy = ScalingPolicy(slo=TMetrics.SLO(1.0, 1.0))
    ClusterDriver(srv, policy, mcfg=srv.mcfg, tp=2, device_pool=shared)
    assert shared.owned(srv.mcfg.name) == tuple(range(6))
    with pytest.raises(ValueError, match="already owned"):
        ClusterDriver(srv, policy, mcfg=srv.mcfg, tp=2, device_pool=shared)


# ------------------------------------------------------------ the servers

def _server(name, **extra):
    """The case's server, on ``[cpu] * 8`` unless ``extra`` says
    otherwise."""
    case = CASES[name]
    kw = dict(all_devices=CPU8, device="cpu", **case["server"])
    kw.update(extra)
    return ElasticServer(_mcfg(), tp=case["tp"], batch_per_replica=2,
                         max_len=128, prefill_buckets=(32,), seed=0, **kw)


def _requests(name):
    case = CASES[name]
    reqs = []
    for sched, outs, seed in case["groups"]:
        reqs += TWork.scripted_burst(sched, prompt_len=case["prompt_len"],
                                     output_range=outs, vocab_size=128,
                                     seed=seed, rid0=len(reqs))
    reqs.sort(key=lambda r: r.arrival_s)
    return reqs


def _joining(srv):
    """The reference script's ``joining``: a MIGRATING poll's copy
    sessions land before the next tick."""
    start = srv.start_scale

    def start_scale(target):
        task = start(target)
        adv = task.advance

        def advance(now):
            phase = adv(now)
            for _, sess in task._mig_inflight:
                assert sess.join(timeout=60)
            return phase
        task.advance = advance
        return task
    srv.start_scale = start_scale


def run_closed_loop(name, params=None, **server_kw):
    """The reference script's loop over the port's server."""
    case = CASES[name]
    srv = _server(name, **server_kw)
    srv.boot(_cfg(case["dp"], case["tp"]), params=params)
    assert isinstance(srv, ServingBackend)
    _joining(srv)
    policy = ScalingPolicy(slo=TMetrics.SLO(ttft_s=case["ttft"], tpot_s=1.0),
                           window=8, cooldown_s=1.0, queue_scale_up=3)
    driver = ClusterDriver(srv, policy, mcfg=srv.mcfg, tp=case["tp"],
                           device_pool=range(case["pool"]),
                           config=DriverConfig(**case["driver"]))
    reqs = _requests(name)
    until = 0.0
    while any(r.finish_s is None for r in reqs):
        until += 10.0
        driver.run(reqs if until == 10.0 else [], until=until)
        assert until < 200.0, "stalled"
    return srv, driver, reqs


def events_without_wall(driver):
    """The driver's events as dicts, without the wall-clock fields."""
    return [{k: v for k, v in dataclasses.asdict(e).items()
             if k not in WALL_FIELDS} for e in driver.events]


def same_events(got, want):
    """Equal field for field, NaN equal to NaN."""
    return len(got) == len(want) and all(
        g.keys() == w.keys() and all(_same(g[k], w[k]) for k in w)
        for g, w in zip(got, want))


def test_case1_events_timestamps_tokens_and_bytes_equal_reference(ref):
    want = ref["res"]["case1"]
    srv, driver, reqs = run_closed_loop(
        "case1", params=_tree(ref["dir"] / "case1.npz"))
    got_ev = events_without_wall(driver)
    want_ev = [{k: v for k, v in e.items() if k not in WALL_FIELDS}
               for e in want["events"]]
    assert [e["direction"] for e in got_ev] == ["up", "down"]
    assert same_events(got_ev, want_ev), (got_ev, want_ev)
    assert {str(r.rid): [r.first_token_s, r.finish_s, r.token_times]
            for r in reqs} == want["requests"]
    assert {str(r.rid): srv.engine.generated[r.rid] for r in reqs} == \
        want["tokens"]
    assert [{f: int(getattr(ev.stats, f)) for f in ev.stats.BYTE_FIELDS}
            for ev in srv.events] == want["stats"]
    assert srv.hmm.active_cfg.describe() == want["final"] == \
        _cfg(2, 2).describe()
    assert all(r.finish_s is not None and
               len(srv.engine.generated[r.rid]) == r.output_len
               for r in reqs)
    # the driver's getattr defaults: no routing telemetry in the port
    assert all(e.routing_samples is None and e.routing_cv is None
               for e in driver.events)


def test_case2_directions_targets_projections_tokens_bytes_equal_reference(
        ref):
    want = ref["res"]["case2"]
    srv, driver, reqs = run_closed_loop(
        "case2", params=_tree(ref["dir"] / "case2.npz"))
    keys = ("t", "direction", "src", "dst", "projected_scale_s")
    got = [tuple(getattr(e, k) for k in keys) for e in driver.events]
    assert got == [tuple(e[k] for k in keys) for e in want["events"]]
    assert {e.direction for e in driver.events} == {"up", "down"}
    assert {str(r.rid): srv.engine.generated[r.rid] for r in reqs} == \
        want["tokens"]
    assert [{f: int(getattr(ev.stats, f)) for f in ev.stats.BYTE_FIELDS}
            for ev in srv.events] == want["stats"]
    assert [ev.migrated_blocks for ev in srv.events] == want["migrated"]
    assert sum(want["migrated"]) > 0           # a down migrated live KV
    assert srv.hmm.active_cfg.describe() == want["final"]
    kv = srv.hmm.kv_blocks
    kv.check_invariants()
    assert kv.used_blocks() == 0


def test_a_projection_while_staging_leaves_the_live_table_as_it_was(ref):
    """The pooled projection reads ``hmm.page_table``; taken while a task
    stages (the table holds a staged remap) it plans from a fresh
    placement and changes nothing; after the commit it plans from a clone
    of the live table."""
    srv = _server("case2", staging="overlap")
    srv.boot(_cfg(2), params=_tree(ref["dir"] / "case2.npz"))
    driver = ClusterDriver(srv, ScalingPolicy(slo=TMetrics.SLO(1.0, 1.0)),
                           mcfg=srv.mcfg, tp=1, device_pool=range(6),
                           config=DriverConfig(min_dp=2))
    table = srv.hmm.page_table
    task = srv.start_scale(_cfg(4))
    assert task.phase is ScalePhase.STAGING and table.staged is not None
    before = _snapshot(table)
    for new in (_cfg(3), _cfg(5), _cfg(6)):
        assert math.isfinite(driver.projected_cost_s(_cfg(4), new))
    assert _snapshot(table) == before
    while not task.done:
        srv.tick(0.0)
        task.advance(0.0)
    assert task.phase is ScalePhase.DONE and table.staged is None
    before = _snapshot(table)
    up = driver.select_target("up")
    assert up is not None and up[0].dp in (5, 6)
    assert up[1] == transition_cost(srv.mcfg, 1, _cfg(4), up[0],
                                    expert_mode="pooled", staging="overlap",
                                    page_table=table).scale_time_s
    assert _snapshot(table) == before
    srv.hmm.close()


def test_policy_is_accepted_and_decides_from_finished_requests():
    srv = _server("case1", policy=ScalingPolicy(
        slo=TMetrics.SLO(ttft_s=1.0, tpot_s=1.0), window=8,
        queue_scale_up=3))
    assert srv.autoscale_decision(0.0) is None
    srv.boot(_cfg(2, 2))
    reqs = TWork.scripted_burst([(0.0, 8)], vocab_size=128, seed=1)
    for r in reqs:
        srv.submit(r)
    assert srv.autoscale_decision(0.0) == "up"     # queue of 8 >= 3
    t = 0.0
    while any(r.finish_s is None for r in reqs):
        srv.tick(t)
        t += 0.05
    assert len(srv.estimator.recent) == 8 and all(srv.estimator.recent)
    plain = _server("case1")
    assert plain.estimator is None and plain.autoscale_decision(0.0) is None


# ---------------------------------------------------------- the launcher

@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_launcher_prints_the_reference_scale_lines_and_summary(ref, name):
    port, reference = ref["launches"][name][1], ref["launches"][name][0]
    assert port == reference
    assert port[-1].startswith("{'n'")
    assert sum(ln.startswith("[t=") for ln in port) == (
        1 if name == "scales" else 0)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a host with no card")
def test_launcher_without_a_card_raises():
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--autoscale", "--requests", "2"])
