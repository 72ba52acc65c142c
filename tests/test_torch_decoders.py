"""The dense decoders of the assigned set — yi-6b (GQA), qwen1.5-0.5b (QKV
bias), stablelm-3b (partial rotary, LayerNorm), chatglm3-6b (half rotary,
two kv heads, QKV bias) — and arctic-480b (a MoE with a dense residual
MLP) against the reference, on the CPU.

Their configs are the port's own copies (``repro_torch/configs/``): held
field for field equal to the reference's, full size and ``reduced()``.
Their steps run through the port's standard-attention paths: at
``reduced()`` size and f32, on the reference's parameters
(``init_params`` with seed 0, ``convert.params_from_jax``), ``forward``,
``prefill`` (two prompts, lengths 16 and 11, padded to 16, max_len 32)
and one ``decode_step`` from the prefilled cache are held against
``repro.models.model`` within atol = rtol = 1e-5 (logits and cache).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import model as TM

TOL = dict(atol=1e-5, rtol=1e-5)
NAMES = ["yi-6b", "qwen1.5-0.5b", "stablelm-3b", "chatglm3-6b",
         "arctic-480b"]


@pytest.mark.parametrize("name", NAMES)
def test_config_equals_reference(name):
    for suffix in ("", "-smoke"):
        got = dataclasses.asdict(get_config(name + suffix))
        assert got == dataclasses.asdict(jax_config(name + suffix))


@pytest.mark.parametrize("name", NAMES)
def test_steps_match_reference(name):
    jcfg = jax_config(name + "-smoke")
    cfg = get_config(name + "-smoke")
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = params_from_jax(jp)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    lengths = np.array([16, 11], np.int32)

    want = np.asarray(JM.forward(jcfg, jp, {"tokens": tokens})[0])
    got = TM.forward(cfg, tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    jlg, jc = JM.prefill(jcfg, jp, {"tokens": tokens, "lengths": lengths},
                         32)
    lg, cache = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(tokens),
                                     "lengths": torch.from_numpy(lengths)},
                           32)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    for n in jc:
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jc[n]),
                                   **TOL)

    # one decode step from the reference's cache (the same rows in both)
    step = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    cache = {n: torch.from_numpy(np.array(v)) for n, v in jc.items()}
    jlg, jc = JM.decode_step(jcfg, jp, step, jc, lengths)
    lg, cache = TM.decode_step(cfg, tp, torch.from_numpy(step), cache,
                               torch.from_numpy(lengths))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    for n in jc:
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jc[n]),
                                   **TOL)
