"""Training launcher — the port's counterpart of ``repro.launch.train``:

    python -m repro_torch.launch.train --arch <id> [--steps N] [--batch N]
        [--seq N] [--lr X] [--full] [--device cuda|cpu]

Trains the *reduced* (``-smoke``) variant of the chosen architecture, or
with ``--full`` its full config, on one device: on the card unless
``--device cpu`` is given, raising without one.  The attention decoders
train (standard attention and MLA, dense and MoE); the others raise
(ROADMAP §1 item 7).
"""
from __future__ import annotations

import argparse

from repro_torch.configs import REGISTRY, get_config
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import train


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(REGISTRY))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="use the full config (its weights must fit the "
                         "device)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the launcher; returns ``train``'s result (``history``, ``wall_s``,
    the trained ``params`` and ``opt_state``)."""
    args = parse_args(argv)
    cfg = get_config(args.arch if args.full else args.arch + "-smoke")
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params")
    out = train(cfg, steps=args.steps, batch=args.batch, seq_len=args.seq,
                opt=AdamWConfig(lr=args.lr, total_steps=args.steps),
                log_every=max(args.steps // 10, 1), device=args.device)
    print(f"done: loss {out['history'][0][1]:.4f} -> "
          f"{out['history'][-1][1]:.4f} in {out['wall_s']:.0f}s")
    return out


if __name__ == "__main__":
    main()
