"""Training launcher.

    python -m repro_torch.launch.train --arch recurrentgemma-2b --steps 60 \
        [--batch 4] [--seq 64] [--full] [--layers N] [--ckpt-dir DIR] \
        [--ckpt-every 20] [--fail-at STEP] [--lr 3e-4] [--device cpu] \
        [--seed 0]

Trains on the synthetic cyclic stream (``train/loop.py::data_stream``) from
random parameters drawn from ``--seed``.  ``--reduced`` (the default) is the
tiny same-topology configuration, ``--full`` the published one;
``--layers`` cuts the depth to its first N layers (one card holds the
float32 optimizer state of a few layers at full width, not of all 26 at
once with a large batch).  Checkpoints and auto-resume via ``--ckpt-dir``;
``--fail-at`` injects a failure at that step to demonstrate the restart.
Runs on the CUDA device by default (``--device cpu`` to run on the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="use the smoke-scale variant (the default)")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to the first N layers")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.configs.base import get_arch
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.optimizer import AdamWConfig

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    out = train(cfg,
                LoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every, log_every=10,
                           fail_at_step=args.fail_at, straggler_warn_s=10.0),
                batch=args.batch, seq=args.seq,
                opt_cfg=AdamWConfig(lr=args.lr), device=args.device,
                seed=args.seed)
    first = out["losses"][0] if out["losses"] else float("nan")
    print(f"done: {cfg.name} ({cfg.n_layers} layers) first_loss={first:.4f} "
          f"final_loss={out['final_loss']:.4f} "
          f"slow_steps={out['slow_steps']}")
    return out


if __name__ == "__main__":
    main()
