"""The Mamba2 models on several logical devices against the reference, on
the CPU: mamba2-1.3b (attention-free) and zamba2-2.7b (hybrid: one shared
attention block, split over the TP ranks, ahead of each SSD layer) at
``reduced()`` size.  An SSD layer is replicated over a replica's TP ranks:
each rank runs it on its copy of the activations and of the layer's conv
tail and state.

The reference script, its drivers and checks are
``tests/test_torch_scale_mla.py``'s; this module starts its own reference
subprocess (8 simulated host devices, f32) for these models.  Held:

* ``forward``, ``prefill`` (with the engine's ``_prefill_fn`` writing the
  slot's conv tail, state and shared-block rows in every rank's copy) and
  ``decode_step`` at DP2 and DP2 x TP2 against the reference's one-device
  steps within atol = rtol = 1e-5 (zamba2: atol 5e-5, the one-device
  hybrid's tolerance in ``tests/test_torch_mamba2.py``, which the port's
  one-device steps already need); every TP rank's copy of the cache
  bitwise equal to the others.  The prefill scans the bucket's padding
  into the state, as the reference does; a hybrid's full slot wraps its
  shared block's write to row 0;
* every ``TransferStats.BYTE_FIELDS`` value equal the reference's, staged
  and committed: DP2 -> DP3 (zero-copy reuse and whole-replica copies:
  there are no experts), DP2 x TP2 -> DP3 x TP2, DP3 -> DP2 with commit
  and with abort;
* the servers' greedy tokens equal the reference's across a scale-up and
  across a drain scale-down.
"""
import pytest

from test_torch_scale_mla import (check_hmm, check_server, check_step,
                                  start_reference)
from test_torch_scale_mla import _one_thread  # noqa: F401 (autouse fixture)

MODELS = {"mamba2": ("mamba2-1.3b-smoke", {}),
          "zamba2": ("zamba2-2.7b-smoke", {})}
STEPS = {"mamba2": "mamba2", "zamba2": "zamba2"}
# name: (model, tp, from dp, to dp, HMM knobs, mode)
HMM_CASES = {
    "mamba2": ("mamba2", 1, 2, 3, {}, "commit"),
    "mamba2_tp2": ("mamba2", 2, 2, 3, {}, "commit"),
    "mamba2_down": ("mamba2", 1, 3, 2, {}, "commit"),
    "mamba2_down_abort": ("mamba2", 1, 3, 2, {}, "abort"),
    "zamba2": ("zamba2", 1, 2, 3, {}, "commit"),
    "zamba2_tp2": ("zamba2", 2, 2, 3, {}, "commit"),
    "zamba2_down": ("zamba2", 2, 3, 2, {}, "commit"),
}
# name: (model, tp, from dp, to dp, server knobs)
SERVERS = {
    "mamba2_up": ("mamba2", 1, 2, 3, {}),
    "mamba2_drain": ("mamba2", 1, 3, 2, {}),
    "zamba2_up_tp2": ("zamba2", 2, 2, 3, {}),
    "zamba2_drain_tp2": ("zamba2", 2, 3, 2, {}),
}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return start_reference(tmp_path_factory, "scale_ssm", MODELS, STEPS,
                           HMM_CASES, SERVERS)


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
