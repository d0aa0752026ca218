"""End-to-end training example of the PyTorch port: train a language model
for a few dozen steps with checkpointing/auto-resume and optional failure
injection.  The port's counterpart of ``examples/train_lm.py``; it imports
only ``repro_torch``.

Presets:
  smoke (default) — reduced recurrentgemma-2b (3 layers rglru, rglru, local;
                    d 64; float32), 60 steps, well under a minute on a CPU.
                    The reference's smoke preset is reduced smollm, whose
                    dense-attention family the port does not have yet
                    (ROADMAP Q9c); recurrentgemma is the one architecture
                    the port trains.
  unit            — recurrentgemma-2b at full width, depth cut to one unit
                    (3 layers), bf16, B 1 x S 2 304: one H100.

Run:  PYTHONPATH=src python examples/train_lm_torch.py --device cpu
      PYTHONPATH=src python examples/train_lm_torch.py --device cpu --fail-at 25
      PYTHONPATH=src python examples/train_lm_torch.py --device cpu --resume
"""
import argparse
import dataclasses
import os
import shutil
import tempfile

from repro_torch.configs.base import get_arch
from repro_torch.train.loop import LoopConfig, train


def preset_cfg(name: str):
    base = get_arch("recurrentgemma-2b")
    if name == "smoke":
        return base.reduced(), dict(batch=4, seq=64, steps=60)
    if name == "unit":
        return (dataclasses.replace(base, n_layers=3),
                dict(batch=1, seq=2304, steps=30))
    raise SystemExit(f"unknown preset {name}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="smoke", choices=["smoke", "unit"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--resume", action="store_true",
                    help="keep existing checkpoints (restart demo)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args()
    if not args.resume:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    cfg, run = preset_cfg(args.preset)
    print(f"training {cfg.name}: {run} on {args.device}")
    out = train(cfg, LoopConfig(steps=run["steps"], ckpt_dir=args.ckpt_dir,
                                ckpt_every=20, log_every=10,
                                fail_at_step=args.fail_at,
                                straggler_warn_s=5.0),
                batch=run["batch"], seq=run["seq"], device=args.device)
    print(f"final loss: {out['final_loss']:.4f} "
          f"(first: {out['losses'][0]:.4f}) slow_steps={out['slow_steps']}")
    assert out["losses"][-1] < out["losses"][0], "loss did not improve"


if __name__ == "__main__":
    main()
