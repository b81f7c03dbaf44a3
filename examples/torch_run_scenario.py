"""Run any registered scenario end to end through the port's harness
(counterpart of ``examples/run_scenario.py``).

  PYTHONPATH=src python examples/torch_run_scenario.py --list
  PYTHONPATH=src python examples/torch_run_scenario.py --scenario commuter
  PYTHONPATH=src python examples/torch_run_scenario.py \\
      --scenario multi_area_3city --method gossip --seeds 4
  PYTHONPATH=src python examples/torch_run_scenario.py --device cpu \\
      --scenario commuter --steps 20 --n-mules 6

The scenario supplies mobility, protocol mode and data partition, and for
the churn family a per-step device activity mask: ``commuter_churn``
(Markov join/leave sessions), ``event_crowd_flash`` (flash joins, mass
exits), ``multi_area_3city`` (3 near-isolated cities, 12 spaces),
``multi_area_migratory`` (the same with heavy migration and a [T, M] area
column), ``mixed_cadence`` (per-space exchange tempos); the ``har_*``
variants bind the LSTM-CNN IMU task. Every mobile method (mlmule, gossip,
oppcl, local, mlmule+gossip) rides the engine. With ``--seeds N > 1`` the
seeds run as lanes of one sweep (``run_sweep_experiment``), each step
launching ``mule_agg`` and ``encounter_mix`` once for all of them.

The reference's ``--stream``, ``--stream-chunk``, ``--distributed``,
``--processes`` and ``--rebucket-*`` flags are accepted and raise: the
streamed schedule is ROADMAP item 12, the distributed engine item 13b.
"""
import argparse

import numpy as np

from repro_torch.core import METHODS_MOBILE
from repro_torch.experiment import (ExperimentConfig, run_experiment,
                                    run_sweep_experiment)
from repro_torch.scenarios import SCENARIOS, list_scenarios

# flags of the reference's script whose engines the port does not have yet
NOT_PORTED = {
    "stream": "ROADMAP §1 item 12 (streaming colocation)",
    "stream_chunk": "ROADMAP §1 item 12 (streaming colocation)",
    "distributed": "ROADMAP §1 item 13b (the distributed engine)",
    "processes": "ROADMAP §1 item 13b (the distributed engine)",
    "rebucket_every": "ROADMAP §1 item 13b (the distributed engine)",
    "rebucket_threshold": "ROADMAP §1 item 13b (the distributed engine)",
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="random_walk",
                    choices=list_scenarios(),
                    help="registered scenario (see --list)")
    ap.add_argument("--method", default="mlmule", choices=METHODS_MOBILE)
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--n-mules", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=1,
                    help="sweep seed..seed+N-1 as lanes of one replay")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--list", action="store_true",
                    help="print the registry and exit")
    # the reference's engines that are not ported: raise when asked for
    ap.add_argument("--stream", action="store_true")
    ap.add_argument("--stream-chunk", type=int, default=0)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--processes", type=int, default=1)
    ap.add_argument("--rebucket-every", type=int, default=0)
    ap.add_argument("--rebucket-threshold", type=float, default=None)
    args = ap.parse_args(argv)

    if args.list:
        for name in list_scenarios():
            print(f"{name:20s} {SCENARIOS[name].description}")
        return
    for field, item in NOT_PORTED.items():
        if getattr(args, field) != ap.get_default(field):
            raise NotImplementedError(
                f"--{field.replace('_', '-')} is not ported yet; it arrives "
                f"with {item}")

    spec = SCENARIOS[args.scenario]
    print(f"scenario={spec.name} mode={spec.mode} dist={spec.dist} "
          f"task={spec.task} method={args.method} device={args.device}")
    cfg = ExperimentConfig(scenario=args.scenario, method=args.method,
                           steps=args.steps, n_mules=args.n_mules,
                           seed=args.seed)
    if args.seeds > 1:
        seeds = range(args.seed, args.seed + args.seeds)
        r = run_sweep_experiment(cfg, seeds, device=args.device)
        d = r["methods"][args.method]
        spread = np.asarray(d["acc"]).std(axis=0)
        for t, acc, sd in zip(r["eval_steps"], d["mean_acc"], spread):
            print(f"  step {t + 1:4d}  mean acc {acc:.3f} +/- {sd:.3f} "
                  f"({args.seeds} seeds)")
        print(f"final pre-local acc {d['mean_final_acc']:.3f}  "
              f"wall {r['wall_s']:.0f}s")
        return

    r = run_experiment(cfg, device=args.device)
    for t, acc in r["trace"]:
        print(f"  step {t + 1:4d}  mean acc {acc:.3f}")
    print(f"final pre-local acc {r['pre_local_acc']:.3f}  "
          f"wall {r['wall_s']:.0f}s")


if __name__ == "__main__":
    main()
