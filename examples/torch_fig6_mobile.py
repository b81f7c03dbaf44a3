"""Fig 6/7 analogue on the PyTorch port: mobile-device training (Shards,
CIFAR-like) over time, seed-averaged (counterpart of
``benchmarks/fig6_mobile_cifar.py``, the same rows).

Methods: Gossip, OppCL, Local-Only, ML Mule, ML Mule + Gossip, at P_cross
in {0, 0.5} ({0, 0.1, 0.5} and 900 steps with --full). The claim validated
is that ML Mule converges faster and higher than Gossip/OppCL/Local, and
Mule+Gossip ~ Mule. Each (P_cross) cell replays every seed as a lane of one
sweep (``run_sweep_experiment``): each step launches ``mule_agg`` and
``encounter_mix`` once for all seeds.

  PYTHONPATH=src python examples/torch_fig6_mobile.py --seeds 4 [--full]
  PYTHONPATH=src python examples/torch_fig6_mobile.py --device cpu \\
      --steps 20 --pretrain-steps 2 --seeds 2
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core import METHODS_MOBILE
from repro_torch.experiment import ExperimentConfig, run_sweep_experiment

METHODS = METHODS_MOBILE


def run(full: bool = False, seeds=(0,), steps: int = 0,
        pretrain_steps: int = 120, device="cuda"):
    steps = steps or (900 if full else 240)
    p_list = ["0", "0.1", "0.5"] if full else ["0", "0.5"]
    rows = []
    for p in p_list:
        cfg = ExperimentConfig(task="image", mode="mobile", dist="shards",
                               pattern=p, steps=steps,
                               pretrain_steps=pretrain_steps)
        r = run_sweep_experiment(cfg, seeds, methods=METHODS, device=device)
        for method in METHODS:
            d = r["methods"][method]
            rows.append({"p_cross": p, "method": method,
                         "seeds": list(seeds),
                         "trace": list(zip(r["eval_steps"], d["mean_acc"])),
                         "acc_per_seed": d["final_acc"],
                         "final_acc": d["mean_final_acc"],
                         "wall_s": r["wall_s"]})
            print(f"fig6,{p},{method},{d['mean_final_acc']:.4f}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seeds", type=int, default=1,
                    help="number of seeds (0..N-1) averaged per cell")
    ap.add_argument("--out", default=None)
    ap.add_argument("--steps", type=int, default=0,
                    help="steps per run (0: 240, or 900 with --full)")
    ap.add_argument("--pretrain-steps", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    rows = run(full=args.full, seeds=tuple(range(args.seeds)),
               steps=args.steps, pretrain_steps=args.pretrain_steps,
               device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
