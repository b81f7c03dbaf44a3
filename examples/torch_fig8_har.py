"""Mobile-device training (paper Fig. 2b) on IMU HAR, on the PyTorch port
(counterpart of ``examples/har_mobile_training.py``).

Phones collect accelerometer/gyro windows as their users move through
spaces; fixed devices only host/aggregate. Compares ML Mule vs Gossip vs
Local over time (Fig. 8/9 analogue), with the paper's LSTM-CNN.

  PYTHONPATH=src python examples/torch_fig8_har.py [--p-cross 0.1]
  PYTHONPATH=src python examples/torch_fig8_har.py --device cpu --steps 20
"""
import argparse

from repro_torch.experiment import ExperimentConfig, run_experiment


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--p-cross", default="0.1")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    print(f"HAR (LSTM-CNN over IMU windows), P_cross={args.p_cross}")
    for method in ("local", "gossip", "mlmule"):
        cfg = ExperimentConfig(task="har", mode="mobile", method=method,
                               pattern=args.p_cross, steps=args.steps,
                               seed=args.seed, batch=12, lr=0.03)
        r = run_experiment(cfg, device=args.device)
        trace = " ".join(f"{t}:{a:.2f}" for t, a in r["trace"])
        print(f"{method:8s} final={r['pre_local_acc']:.3f}  trace: {trace}")


if __name__ == "__main__":
    main()
