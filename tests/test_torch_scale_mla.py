"""The MLA models on several logical devices against the reference, on the
CPU: deepseek-v2-lite's path (latent cache, shared experts, dense first
layer) and deepseek-v3's q-LoRA branch, at ``reduced()`` size with 12
experts (so that expert parallelism divides 2, 3, 4 and 6 devices).

The reference runs in one subprocess with 8 simulated host devices (as
``tests/helpers.run_with_devices`` runs it), started once per module at
f32: it boots the HMMs whose weights the port takes (``np.savez`` of the
parameters), runs its one-device ``forward``, ``prefill`` and
``decode_step`` on those weights and on inputs it draws from a numpy seed,
scales its HMMs (the ``TransferStats`` byte fields) and runs its
``ElasticServer``s through a scale-up (``stage_scale`` at the 5th tick,
one tick, ``switchover``) or a drain scale-down (``start_scale``, the
loop of ``tests/test_torch_scaledown.py``), saving the greedy tokens.  The
port runs in this process on ``[cpu] * 8`` logical devices.  Held:

* ``forward``, ``prefill`` (and the engine's ``_prefill_fn`` writing the
  slot's row in every rank's copy) and ``decode_step`` at DP2 and DP2 x
  TP2 against the reference's one-device steps within atol = rtol = 1e-5
  (no capacity drops: expert parallelism then changes nothing of the
  result); every TP rank's copy of the cache bitwise equal to the others;
* every ``TransferStats.BYTE_FIELDS`` value equal the reference's, staged
  and committed: DP2 -> DP3 with dense banks and with pooled pages, DP2 x
  TP2 -> DP3 x TP2, DP3 -> DP2 with commit and with abort (then staged
  again), and deepseek-v3's q-LoRA leaves at DP2 x TP2 -> DP3 x TP2;
* the servers' greedy tokens equal the reference's across a scale-up and
  across a drain scale-down (the dense layout always drains).

``tests/test_torch_scale_ssm.py`` imports the script and the drivers to
hold the Mamba2 models the same way.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from test_torch_scale import COMMON, CPU8, TOL, _start, _stats, _wait
from test_torch_scale import _tree as _dict_tree
from test_torch_tp import _assert_copies_equal as assert_copies_equal
from repro_torch.configs import get_config
from repro_torch.core.elastic_engine import ElasticServer
from repro_torch.core.hmm import HMM
from repro_torch.core.topology import ElasticConfig
from repro_torch.distributed.sharding import make_instance_mesh
from repro_torch.models import model as TM
from repro_torch.serving.driver import ScalePhase
from repro_torch.serving.engine import _prefill_fn, engine_parallel_ctx
from repro_torch.serving.workload import Request

MAX_LEN = 32                           # the steps' slot cache length

# the reference's side: weights, one-device steps, HMM scales, servers
SCRIPT = COMMON + '''
from repro.configs import get_config
from repro.core.elastic_engine import ElasticServer
from repro.core.hmm import HMM, TransferStats
from repro.models import model as JM
from repro.serving.driver import ScalePhase
from repro.serving.workload import Request
MODELS, STEPS, HMM_CASES, SERVERS, REQS = %s, %s, %s, %s, %s
MAX_LEN = %d

def model(key):
    arch, kw = MODELS[key]
    return dataclasses.replace(get_config(arch), **kw)

def stats(st):
    return {f: int(getattr(st, f)) for f in TransferStats.BYTE_FIELDS}

rng = np.random.default_rng(0)
for name, key in STEPS.items():
    mcfg = model(key)
    hmm = HMM(mcfg, tp=1, batch_per_replica=2, max_len=MAX_LEN)
    hmm.boot(cfg(2))
    np.savez(f"{OUT}/p_{name}.npz", **flat(hmm.params))
    p = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), hmm.params)
    V, io = mcfg.vocab_size, {}
    io["fwd_tokens"] = rng.integers(0, V, (2, 16)).astype(np.int32)
    io["fwd_logits"] = np.asarray(JM.forward(mcfg, p, {
        "tokens": io["fwd_tokens"]})[0])
    # one prompt of 11 tokens padded to 16
    io["pre_tokens"] = rng.integers(0, V, (1, 16)).astype(np.int32)
    lg, c = JM.prefill(mcfg, p, {"tokens": io["pre_tokens"],
                                 "lengths": np.array([11], np.int32)},
                       MAX_LEN)
    io["pre_logits"] = np.asarray(lg)
    for n, v in c.items():
        io["pre_" + n] = np.asarray(v)
    # decode: 2 slots a replica, one slot full (its write drops; a
    # hybrid's shared block wraps it to row 0)
    B = 4
    io["dec_tokens"] = rng.integers(0, V, (B, 1)).astype(np.int32)
    io["dec_lens"] = np.array([5, MAX_LEN, 0, 17], np.int32)
    cache = JM.init_cache(mcfg, B, MAX_LEN, jnp.float32)
    for n, v in cache.items():
        io["dec_" + n] = rng.standard_normal(v.shape).astype(np.float32)
    lg, c = JM.decode_step(mcfg, p, io["dec_tokens"],
                           {n: jnp.asarray(io["dec_" + n]) for n in cache},
                           io["dec_lens"])
    io["dec_logits"] = np.asarray(lg)
    for n, v in c.items():
        io[f"dec_{n}_out"] = np.asarray(v)
    np.savez(f"{OUT}/io_{name}.npz", **io)

res = {}
for name, (key, tp, dp0, dp1, kw, mode) in HMM_CASES.items():
    hmm = HMM(model(key), tp=tp, batch_per_replica=2, max_len=MAX_LEN, **kw)
    hmm.boot(cfg(dp0, tp))
    np.savez(f"{OUT}/h_{name}.npz", **flat(hmm.params))
    r = {}
    if mode == "abort":
        hmm.begin_scale(cfg(dp1, tp))
        hmm.stage_increment()
        hmm.stage_increment()
        hmm.abort()
    r["stage"] = stats(hmm.scale(cfg(dp1, tp)))
    r["commit"] = stats(hmm.commit())
    r["final"] = stats(hmm.last_stats)
    res[name] = r
json.dump(res, open(f"{OUT}/hmm.json", "w"))

def drive(srv, reqs, target, at, down):
    t, n, task = 0.0, 0, None
    while any(r.finish_s is None for r in reqs) or \\
            (task is not None and not task.done):
        if n == at and not down:
            srv.stage_scale(target)
            srv.tick(t); t += .1; n += 1
            srv.switchover()
            continue
        if n == at and task is None:
            task = srv.start_scale(target)
            while task.phase in (ScalePhase.STAGING, ScalePhase.COMPILING):
                task.advance(t)
        srv.tick(t); t += .1; n += 1
        if task is not None and not task.done:
            task.advance(t)
        assert n < 3000
    return task

res = {}
for name, (key, tp, dp0, dp1, kw) in SERVERS.items():
    srv = ElasticServer(model(key), tp=tp, batch_per_replica=2,
                        max_len=128, prefill_buckets=(32, 64), seed=0, **kw)
    srv.boot(cfg(dp0, tp))
    np.savez(f"{OUT}/s_{name}.npz", **flat(srv.hmm.params))
    reqs = [Request(i, 0.0, len(p), o, prompt=np.asarray(p, np.int32))
            for i, (p, o) in enumerate(REQS)]
    for r in reqs:
        srv.submit(r)
    task = drive(srv, reqs, cfg(dp1, tp), 5, dp1 < dp0)
    assert srv.hmm.active_cfg == cfg(dp1, tp)
    res[name] = {"tokens": {str(r.rid): srv.engine.generated[r.rid]
                            for r in reqs},
                 "final": stats(srv.events[-1].stats),
                 "drained": task is not None
                 and task.phase is ScalePhase.DONE}
json.dump(res, open(f"{OUT}/serve.json", "w"))
print("REF-DONE")
'''

# key: (reference config, overrides).  No capacity drops in the step
# cases: there the port's expert-parallel steps meet the reference's
# one-device ones.
MODELS = {
    "v2": ("deepseek-v2-lite-16b-smoke", dict(num_experts=12)),
    "v2_nodrop": ("deepseek-v2-lite-16b-smoke",
                  dict(num_experts=12, capacity_factor=100.0)),
    "v3": ("deepseek-v3-smoke", dict(num_experts=12)),
    "v3_nodrop": ("deepseek-v3-smoke",
                  dict(num_experts=12, capacity_factor=100.0)),
}
STEPS = {"v2": "v2_nodrop", "v3": "v3_nodrop"}
POOLED = dict(expert_mode="pooled")
# name: (model, tp, from dp, to dp, HMM knobs, mode)
HMM_CASES = {
    "dense": ("v2", 1, 2, 3, {}, "commit"),
    "pooled": ("v2", 1, 2, 3, POOLED, "commit"),
    "tp2": ("v2", 2, 2, 3, POOLED, "commit"),
    "down": ("v2", 1, 3, 2, POOLED, "commit"),
    "down_abort": ("v2", 1, 3, 2, POOLED, "abort"),
    "v3_tp2": ("v3", 2, 2, 3, {}, "commit"),
}
# name: (model, tp, from dp, to dp, server knobs)
SERVERS = {
    "up_dense": ("v2", 1, 2, 3, {}),
    "up_tp2_pooled": ("v2", 2, 2, 3, POOLED),
    "drain_tp2": ("v2", 2, 3, 2, POOLED),
}
_rng = np.random.default_rng(0)
REQS = [(_rng.integers(0, 512, n).tolist(), out)
        for n, out in zip([10, 37, 16, 23, 30, 45], [20, 12, 24, 9, 15, 18])]


def start_reference(tmp_path_factory, tag, models, steps, hmm_cases,
                    servers):
    """Run the reference script for these cases; returns its output
    directory."""
    out = tmp_path_factory.mktemp(tag)
    _wait(_start(SCRIPT % (repr(models), repr(steps), repr(hmm_cases),
                           repr(servers), repr(REQS), MAX_LEN), out),
          f"{tag} steps, HMM scales and servers")
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return start_reference(tmp_path_factory, "scale_mla", MODELS, STEPS,
                           HMM_CASES, SERVERS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The steps are tiny: one intra-op thread (the suite runs several
    test workers on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lists(tree):
    """Dicts keyed "0", "1", ... (a saved list, ``dense_prefix``) back to
    lists."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _lists(v) for k, v in tree.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def _tree(path):
    """The reference's saved parameters as the port's tree."""
    return _lists(_dict_tree(path))


def model(models, key):
    arch, kw = models[key]
    return dataclasses.replace(get_config(arch), **kw)


def cfg(dp, tp=1):
    return ElasticConfig(dp, tp, tuple(range(dp * tp)))


# a hybrid's steps: the one-device hybrid's tolerance
# (``tests/test_torch_mamba2.py``'s ``HYBRID_TOL``: its shared block's
# softmax feeds a scan over the whole prompt)
HYBRID_TOL = dict(atol=5e-5, rtol=1e-5)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), want, **tol)


def check_step(ref, models, steps, name, dp, tp, step):
    """The port's ``step`` at DP``dp`` x TP``tp`` on the reference's
    weights ``name`` against the reference's one-device step."""
    io = dict(np.load(ref / f"io_{name}.npz"))
    t = {k: torch.from_numpy(v) for k, v in io.items()}
    mcfg = model(models, steps[name])
    tol = HYBRID_TOL if mcfg.arch_type == "hybrid" else TOL
    hmm = HMM(mcfg, tp, batch_per_replica=2, max_len=MAX_LEN,
              all_devices=CPU8, device="cpu")
    hmm.boot(cfg(dp, tp), params=_tree(ref / f"p_{name}.npz"))
    ctx = engine_parallel_ctx(make_instance_mesh(cfg(dp, tp), CPU8))
    params, cache = hmm.params, hmm.cache
    if step == "forward":
        got = TM.forward(mcfg, params, {"tokens": t["fwd_tokens"]},
                         parallel=ctx, replica=1)
        _close(got, io["fwd_logits"], tol)
        return
    if step == "prefill":
        lg, small = TM.prefill(mcfg, params, {
            "tokens": t["pre_tokens"], "lengths": torch.tensor([11])},
            MAX_LEN, parallel=ctx, replica=1)
        _close(lg, io["pre_logits"], tol)
        assert set(small) == set(cache)
        for n in cache:
            _close(small[n], io["pre_" + n], tol)
        # slot 1 of replica 1: its row in every rank's copy
        _prefill_fn(mcfg, MAX_LEN, params, cache, t["pre_tokens"],
                    torch.tensor(11), 3, parallel=ctx)
        for n in cache:
            _close(cache[n].gather()[:, 3], io["pre_" + n][:, 0], tol)
    else:
        for n, leaf in cache.items():
            a = t["dec_" + n]
            for _, idx, shard in leaf.addressable_shards:
                shard.copy_(a[idx])
        lg, cache = TM.decode_step(mcfg, params, t["dec_tokens"], cache,
                                   t["dec_lens"], parallel=ctx)
        _close(lg, io["dec_logits"], tol)
        for n in cache:
            _close(cache[n].gather(), io[f"dec_{n}_out"], tol)
    assert_copies_equal(cache, ctx)


def check_hmm(ref, models, hmm_cases, name):
    """Every byte field equal the reference's, staged and committed (after
    an abort and a second staging where the case aborts)."""
    want = json.load(open(ref / "hmm.json"))[name]
    key, tp, dp0, dp1, kw, mode = hmm_cases[name]
    hmm = HMM(model(models, key), tp, batch_per_replica=2, max_len=MAX_LEN,
              all_devices=CPU8, device="cpu", **kw)
    hmm.boot(cfg(dp0, tp), params=_tree(ref / f"h_{name}.npz"))
    if mode == "abort":
        hmm.begin_scale(cfg(dp1, tp))
        hmm.stage_increment()
        hmm.stage_increment()
        hmm.abort()
        assert hmm.staged is None
    assert _stats(hmm.scale(cfg(dp1, tp))) == want["stage"]
    assert _stats(hmm.commit()) == want["commit"]
    assert _stats(hmm.last_stats) == want["final"]
    assert hmm.active_cfg == cfg(dp1, tp)
    # every cache leaf split on its batch axis over the new replicas
    for leaf in hmm.cache.values():
        assert {idx[1] for _, idx, _ in leaf.addressable_shards} == {
            slice(r * 2, (r + 1) * 2) for r in range(dp1)}


def _drive(srv, reqs, target, at, down):
    """The reference script's loop: a scale-up staged at tick ``at``,
    served one tick, switched over; or a scale-down's task, its staging
    run to its end in the tick it opens, advanced after every tick."""
    t, n, task = 0.0, 0, None
    while any(r.finish_s is None for r in reqs) or \
            (task is not None and not task.done):
        if n == at and not down:
            srv.stage_scale(target)
            srv.tick(t)
            t, n = t + .1, n + 1
            srv.switchover()
            assert_copies_equal(srv.engine.cache, srv.engine.parallel)
            continue
        if n == at and task is None:
            task = srv.start_scale(target)
            while task.phase in (ScalePhase.STAGING, ScalePhase.COMPILING):
                task.advance(t)
        srv.tick(t)
        t, n = t + .1, n + 1
        if task is not None and not task.done:
            task.advance(t)
        assert n < 3000
    return task


def check_server(ref, models, servers, name):
    """Greedy tokens and the scale's byte fields equal the reference's;
    a scale-down drains."""
    want = json.load(open(ref / "serve.json"))[name]
    key, tp, dp0, dp1, kw = servers[name]
    srv = ElasticServer(model(models, key), tp=tp, batch_per_replica=2,
                        max_len=128, prefill_buckets=(32, 64), seed=0,
                        all_devices=CPU8, device="cpu", **kw)
    srv.boot(cfg(dp0, tp), params=_tree(ref / f"s_{name}.npz"))
    reqs = [Request(i, 0.0, len(p), o, prompt=np.asarray(p, np.int32))
            for i, (p, o) in enumerate(REQS)]
    for r in reqs:
        srv.submit(r)
    task = _drive(srv, reqs, cfg(dp1, tp), 5, dp1 < dp0)
    assert srv.hmm.active_cfg == cfg(dp1, tp)
    assert {str(r.rid): srv.engine.generated[r.rid] for r in reqs} == \
        want["tokens"]
    assert _stats(srv.events[-1].stats) == want["final"]
    if dp1 < dp0:
        assert srv.scaledown_mode == "drain" and want["drained"]
        assert task.phase is ScalePhase.DONE and task.migrated_blocks == 0
        assert srv.engine.num_slots == 2 * dp1
    assert_copies_equal(srv.engine.cache, srv.engine.parallel)


STEP_CASES = [(n, dp, tp, s) for n in STEPS for dp, tp in ((2, 1), (2, 2))
              for s in ("forward", "prefill", "decode_step")]


@pytest.mark.parametrize("case", STEP_CASES,
                         ids=[f"{n}-dp{d}tp{t}-{s}" for n, d, t, s
                              in STEP_CASES])
def test_steps_match_one_device_reference(ref, case):
    check_step(ref, MODELS, STEPS, *case)


@pytest.mark.parametrize("name", sorted(HMM_CASES))
def test_hmm_bytes_equal_reference(ref, name):
    check_hmm(ref, MODELS, HMM_CASES, name)


@pytest.mark.parametrize("name", sorted(SERVERS))
def test_server_tokens_equal_reference(ref, name):
    check_server(ref, MODELS, SERVERS, name)


def test_latent_shards_follow_the_reference_rules(ref):
    """DP2 x TP2: q, k_up and v_up split by columns over the TP ranks, o
    by rows, the latent's down projection and norm replicated, the dense
    prefix unstacked; the latent cache split on its batch axis only."""
    mcfg = model(MODELS, "v3")
    hmm = HMM(mcfg, 2, batch_per_replica=2, max_len=MAX_LEN,
              all_devices=CPU8, device="cpu")
    hmm.boot(cfg(2, 2), params=_tree(ref / "h_v3_tp2.npz"))
    attn = hmm.params["blocks"]["attn"]
    specs = {k: attn[k]["w"].sharding.spec for k in attn if "w" in attn[k]}
    assert specs["q_up"] == (None, None, "tp")
    assert specs["k_up"] == specs["v_up"] == (None, None, "tp")
    assert specs["o"] == (None, "tp", None)
    assert specs["q_down"] == specs["kv_down"] == (None, None, None)
    prefix = hmm.params["dense_prefix"][0]
    assert prefix["attn"]["q_up"]["w"].sharding.spec == (None, "tp")
    assert prefix["mlp"]["down"]["w"].sharding.spec == ("tp", None)
    for leaf in hmm.cache.values():
        assert leaf.sharding.spec[1] == "dp"
        assert all(s is None for i, s in enumerate(leaf.sharding.spec)
                   if i != 1)


@pytest.mark.parametrize("dtype,tp,device,refused", [
    ("float32", 4, "cuda:0", True),      # one head a rank
    ("float32", 2, "cuda:0", False),     # two
    ("bfloat16", 4, "cuda:0", False),    # the bf16 kernel takes any count
    ("float32", 4, "cpu", False),        # the plain version takes any
])
def test_odd_mla_heads_a_rank_refused_on_the_card(dtype, tp, device,
                                                 refused):
    """reduced() deepseek-v2-lite has 4 heads: at tp = 4 each rank holds
    one, which the f32 MLA decode kernel refuses, so such a configuration
    is refused at boot rather than at its first decode."""
    mcfg = dataclasses.replace(model(MODELS, "v2"), dtype=dtype)
    assert mcfg.num_heads == 4
    devices = [torch.device(device)] * tp
    if refused:
        with pytest.raises(NotImplementedError, match="MLA head count"):
            TM.check_mla_heads(mcfg, tp, devices)
    else:
        TM.check_mla_heads(mcfg, tp, devices)
