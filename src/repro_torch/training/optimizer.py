"""AdamW with a warmup and cosine schedule — the port of
``repro.training.optimizer``, in the reference's arithmetic: the schedule
and the bias corrections in f32 tensors from an int32 step, the global
gradient norm summed over the leaves in ``jax.tree.leaves`` order
(``distributed.sharding.tree_leaves``), each update in f32 and rounded
once to the parameter's dtype, decoupled weight decay on leaves with
``ndim >= 2`` (the stacked ``blocks/*`` norm scales [L, D] among them,
as in the reference: ROADMAP §3).

Where the port differs from the pure-functional reference: ``apply_updates``
writes the new parameters, ``mu`` and ``nu`` into the given tensors (under
``torch.no_grad()``) and returns the same trees, updating one leaf at a
time, so that at full width the f32 temporaries are those of one leaf (a
stacked expert bank of four layers is 3.2 GB in f32).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.distributed.sharding import tree_leaves as leaves
from repro_torch.distributed.sharding import tree_map_with_path


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor) as an f32 tensor:
    a linear warmup, then a cosine down to ``min_lr_ratio``."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_state(cfg: AdamWConfig, params) -> AdamWState:
    """Step 0 and f32 zeros of each parameter's shape for ``mu`` and
    ``nu``, on its device."""
    zeros = lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
    step = torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
    return AdamWState(step, tree_map_with_path(zeros, params),
                      tree_map_with_path(zeros, params))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState):
    """One AdamW step: ``grads`` (a tree of ``params``' structure) clipped
    to the global norm ``grad_clip`` -> (params, state, {"lr", "gnorm"}),
    the parameters and moments updated in place."""
    step = state.step + 1
    gs = leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in gs))
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    bc1, bc2 = 1 - cfg.b1 ** step, 1 - cfg.b2 ** step
    for p, g, m, v in zip(leaves(params), gs, leaves(state.mu),
                          leaves(state.nu)):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        delta = torch.div(m, bc1, out=g)
        delta.div_(torch.sqrt(v / bc2).add_(cfg.eps))
        if p.ndim >= 2:                  # decoupled decay, matrices only
            delta.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - lr * delta)
    return params, AdamWState(step, state.mu, state.nu), \
        {"lr": lr, "gnorm": gnorm}
