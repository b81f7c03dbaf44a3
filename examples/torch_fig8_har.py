"""Fig 8/9 analogue on the PyTorch port: mobile-device training on IMU HAR
with the paper's LSTM-CNN, seed-averaged (counterpart of
``benchmarks/fig8_mobile_har.py``, the same rows).

Phones collect accelerometer/gyro windows as their users move through
spaces; fixed devices only host/aggregate. The claim validated is ML Mule
> Gossip/OppCL/Local (Local cannot extract enough features from its
slice). Each P_cross cell replays every seed as a lane of one sweep
(``run_sweep_experiment``); with ``--seeds 1`` (the default) that is the
single-seed run ``run_experiment`` gives.

  PYTHONPATH=src python examples/torch_fig8_har.py [--seeds 4] [--full]
  PYTHONPATH=src python examples/torch_fig8_har.py --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core import METHODS_MOBILE
from repro_torch.experiment import ExperimentConfig, run_sweep_experiment

METHODS = METHODS_MOBILE


def run(full: bool = False, seeds=(0,), steps: int = 0, p_cross=None,
        pretrain_steps: int = 120, device="cuda"):
    steps = steps or (700 if full else 200)
    p_list = (["0", "0.1", "0.5"] if full else [p_cross or "0.1"])
    rows = []
    for p in p_list:
        cfg = ExperimentConfig(task="har", mode="mobile", pattern=p,
                               steps=steps, batch=12, lr=0.03,
                               pretrain_steps=pretrain_steps)
        r = run_sweep_experiment(cfg, seeds, methods=METHODS, device=device)
        print(f"HAR (LSTM-CNN over IMU windows), P_cross={p}, seeds "
              f"{list(seeds)}")
        for method in METHODS:
            d = r["methods"][method]
            rows.append({"p_cross": p, "method": method,
                         "seeds": list(seeds),
                         "trace": list(zip(r["eval_steps"], d["mean_acc"])),
                         "acc_per_seed": d["final_acc"],
                         "final_acc": d["mean_final_acc"],
                         "wall_s": r["wall_s"]})
            trace = " ".join(f"{t}:{a:.2f}" for t, a in
                             zip(r["eval_steps"], d["mean_acc"]))
            print(f"{method:14s} final={d['mean_final_acc']:.3f}  trace: "
                  f"{trace}")
            print(f"fig8,{p},{method},{d['mean_final_acc']:.4f}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seeds", type=int, default=1,
                    help="number of seeds (0..N-1) averaged per cell")
    ap.add_argument("--out", default=None)
    ap.add_argument("--p-cross", default=None,
                    help="the one P_cross without --full (default 0.1)")
    ap.add_argument("--steps", type=int, default=0,
                    help="steps per run (0: 200, or 700 with --full)")
    ap.add_argument("--pretrain-steps", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    rows = run(full=args.full, seeds=tuple(range(args.seeds)),
               steps=args.steps, p_cross=args.p_cross,
               pretrain_steps=args.pretrain_steps, device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
