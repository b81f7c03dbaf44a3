"""Table 1 analogue on the PyTorch port: fixed-device training accuracy
across data distributions (counterpart of
``benchmarks/table1_fixed_training.py``, the same rows).

Paper: CIFAR-100 20-super-class task, 8 fixed devices, 20 mules; methods
CFL/FedAS/FedAvg/Local vs ML Mule at P_cross in {0, 0.1, 0.5} and 4Q traces.
Here: procedural image dataset at reduced scale; --full approaches the
paper's sizes. The claim validated is the ORDERING: ML Mule >= federated
baselines >= Local under non-IID, and the P_cross trends.

  PYTHONPATH=src python examples/torch_table1.py [--full] [--out rows.json]
  PYTHONPATH=src python examples/torch_table1.py --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import json

from repro_torch.experiment import ExperimentConfig, run_experiment


def run(full: bool = False, dists=None, seed: int = 0, steps: int = 0,
        device="cuda"):
    dists = dists or (["dir0.01", "iid"] if not full
                      else ["dir0.001", "dir0.01", "dir0.1", "iid"])
    steps = steps or (900 if full else 240)
    rows = []

    def row(method, dist, pattern):
        cfg = ExperimentConfig(mode="fixed", method=method, dist=dist,
                               pattern="0.1" if pattern == "-" else pattern,
                               steps=steps, seed=seed)
        r = run_experiment(cfg, device=device)
        rows.append({"dist": dist, "method": method, "pattern": pattern,
                     **{k: r[k] for k in ("pre_local_acc", "post_local_acc",
                                          "wall_s")}})
        print(f"table1,{dist},{method},{pattern},"
              f"{r['pre_local_acc']:.4f},{r['post_local_acc']:.4f}")

    for dist in dists:
        for method in ("local", "fedavg", "cfl", "fedas"):
            row(method, dist, "-")
        for pattern in (["0", "0.1", "0.5", "4q"] if full
                        else ["0", "0.5", "4q"]):
            row("mlmule", dist, pattern)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--steps", type=int, default=0,
                    help="steps per run (default 240, or 900 with --full)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    rows = run(full=args.full, steps=args.steps, device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
