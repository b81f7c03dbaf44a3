"""Run any registered scenario end to end through the port's harness
(counterpart of ``examples/run_scenario.py``).

  PYTHONPATH=src python examples/torch_run_scenario.py --list
  PYTHONPATH=src python examples/torch_run_scenario.py --scenario commuter
  PYTHONPATH=src python examples/torch_run_scenario.py \\
      --scenario multi_area_3city --method gossip --seeds 4
  PYTHONPATH=src python examples/torch_run_scenario.py --device cpu \\
      --scenario commuter --steps 20 --n-mules 6
  PYTHONPATH=src python examples/torch_run_scenario.py \\
      --scenario streaming_commuter --stream --n-mules 1000
  PYTHONPATH=src python examples/torch_run_scenario.py \\
      --scenario multi_area_migratory --method gossip --n-mules 16 \\
      --distributed --stream --rebucket-every 20 --processes 4
  PYTHONPATH=src python examples/torch_run_scenario.py --device cpu \
      --scenario random_walk --method gossip --n-mules 16 --steps 9 \
      --seeds 2 --distributed --processes 4

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

With ``--stream`` the schedule is generated chunk by chunk on the device
(``run_population_streamed``: O(chunk * M) schedule memory instead of
O(T * M), the same results). With ``--distributed`` the mules are cut over
the ranks of a ``torch.distributed`` world (``run_population_distributed``;
the peer methods search encounters around the ring of ranks; mobile runs
report the final accuracy only, since an eval inside the run would see one
rank's mules). ``--processes N`` re-runs this script as N local ranks over
gloo (``spawn_local_cluster``), all on the one device, and prints rank 0's
output; ``--rebucket-every`` re-buckets the population between chunks of
the streamed distributed engine. ``--seeds N`` with ``--distributed`` runs
the seeds as lanes inside each rank's block (``run_sweep_distributed``):
each step sends one collective for all lanes.
"""
import argparse
import os
import sys

import numpy as np

from repro_torch.core import METHODS_MOBILE
from repro_torch.experiment import (ExperimentConfig, run_experiment,
                                    run_sweep_experiment)
from repro_torch.launch.multiprocess import (ENV_COORDINATOR,
                                             initialize_from_env,
                                             spawn_local_cluster)
from repro_torch.scenarios import SCENARIOS, list_scenarios


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
    ap.add_argument("--stream", action="store_true",
                    help="generate the schedule chunk by chunk on the "
                         "device (the same results as the materialized "
                         "run)")
    ap.add_argument("--stream-chunk", type=int, default=0,
                    help="steps per chunk of --stream (0: the engine's "
                         "default; a multiple of the eval cadence)")
    ap.add_argument("--distributed", action="store_true",
                    help="cut the mules over the ranks of the world (one "
                         "rank without --processes: nothing is cut)")
    ap.add_argument("--processes", type=int, default=1,
                    help="run as N local ranks over gloo (needs "
                         "--distributed; n-mules must divide over them)")
    ap.add_argument("--rebucket-every", type=int, default=0,
                    help="distributed runs: re-bucket the mules by area "
                         "every N steps when the drift passes "
                         "--rebucket-threshold (a multiple of "
                         "--stream-chunk)")
    ap.add_argument("--rebucket-threshold", type=float, default=0.25,
                    help="share of drifted mules that triggers a swap")
    args = ap.parse_args(argv)

    if args.list:
        for name in list_scenarios():
            print(f"{name:20s} {SCENARIOS[name].description}")
        return
    if args.processes > 1 and not args.distributed:
        ap.error("--processes cuts the population over ranks; add "
                 "--distributed")
    if args.rebucket_every and args.seeds > 1:
        ap.error("--rebucket-every re-buckets one seed's run; drop --seeds")
    if args.stream and args.seeds > 1:
        ap.error("--stream runs one seed; drop --seeds")
    if args.rebucket_every:
        if not args.distributed:
            ap.error("--rebucket-every re-buckets the population over the "
                     "ranks; add --distributed")
        if args.stream_chunk and args.rebucket_every % args.stream_chunk:
            ap.error(f"--rebucket-every={args.rebucket_every} must be a "
                     f"multiple of --stream-chunk={args.stream_chunk}")
    if args.processes > 1 and not os.environ.get(ENV_COORDINATOR):
        # the parent: run this script as the ranks, show rank 0's output
        ranks = spawn_local_cluster(
            [sys.executable, os.path.abspath(__file__), *(
                sys.argv[1:] if argv is None else argv)], args.processes)
        sys.stdout.write(ranks[0].stdout)
        return
    initialize_from_env()

    spec = SCENARIOS[args.scenario]
    print(f"scenario={spec.name} mode={spec.mode} dist={spec.dist} "
          f"task={spec.task} method={args.method} device={args.device}"
          + (" [distributed]" if args.distributed else "")
          + (" [streamed]" if args.stream else "")
          + (f" [{args.processes} processes]" if args.processes > 1
             else ""))
    cfg = ExperimentConfig(scenario=args.scenario, method=args.method,
                           steps=args.steps, n_mules=args.n_mules,
                           seed=args.seed, distributed=args.distributed,
                           stream=args.stream, stream_chunk=args.stream_chunk,
                           rebucket_every=args.rebucket_every,
                           rebucket_threshold=args.rebucket_threshold)
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
