"""The training step and loop — the port of ``repro.training.train_loop``
on one device.

``make_train_step`` differentiates ``models.model.loss_fn`` with
``torch.autograd`` (the reference's ``jax.value_and_grad``): the
parameters are leaf tensors that require grad, each attention block runs
under ``torch.utils.checkpoint`` with ``remat`` (the reference's
``jax.checkpoint``), and its flash attention through the hand-written
forward and backward kernels on the card (``kernels.ops``).  The AdamW
update then runs in place under ``torch.no_grad()``
(``training.optimizer``).  ``train`` is the reference's single-host loop:
the port's ``init_params`` with dense expert banks, the synthetic stream,
the same history and log lines.  Training over logical devices
(``parallel``) is not ported (ROADMAP §1 item 7).
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (tree_leaves_with_path,
                                              tree_map_with_path)
from repro_torch.models.model import init_params, loss_fn
from repro_torch.training.optimizer import (AdamWConfig, apply_updates,
                                            init_state)


def make_train_step(mcfg, opt: AdamWConfig, parallel=None,
                    remat: bool = True):
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    parameters and moments updated in place; metrics ``{"loss", "lr",
    "gnorm"}`` as 0-d tensors on the parameters' device."""

    def step(params, opt_state, batch):
        paths, ps = zip(*tree_leaves_with_path(params))
        for p in ps:
            p.requires_grad_(True)
        loss = loss_fn(mcfg, params, batch, parallel=parallel, remat=remat)
        grads = dict(zip(paths, torch.autograd.grad(
            loss, ps, materialize_grads=True)))
        params, opt_state, info = apply_updates(
            opt, params, tree_map_with_path(lambda path, _: grads[path],
                                            params), opt_state)
        return params, opt_state, {"loss": loss.detach(), **info}

    return step


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    """A numpy batch of ``training.data`` as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train(mcfg, *, steps: int, batch: int, seq_len: int,
          opt: Optional[AdamWConfig] = None, seed: int = 0,
          log_every: int = 10, device="cuda") -> Dict[str, Any]:
    """Single-device training loop (the launcher's); on the card unless
    ``device="cpu"``."""
    from repro_torch.training.data import synthetic_batches
    dev = resolve_device(device)
    opt = opt or AdamWConfig(total_steps=steps)
    params = init_params(mcfg, seed, device=dev, experts=True)
    opt_state = init_state(opt, params)
    step_fn = make_train_step(mcfg, opt)
    it = synthetic_batches(mcfg, batch, seq_len, seed)
    history = []
    t0 = time.perf_counter()
    for i in range(steps):
        params, opt_state, m = step_fn(params, opt_state,
                                       to_device(next(it), dev))
        if i % log_every == 0 or i == steps - 1:
            loss = float(m["loss"])
            history.append((i, loss))
            print(f"step {i:5d}  loss {loss:.4f}  lr {float(m['lr']):.2e}")
    return {"params": params, "opt_state": opt_state, "history": history,
            "wall_s": time.perf_counter() - t0}
