"""Quickstart on the PyTorch port: a short ML Mule simulation.

Eight smart-space fixed devices, twelve phone "mules", the paper's CNN on a
procedural image task. Watch per-space accuracy improve as mules ferry model
snapshots between spaces — no server, no always-on connectivity.

  PYTHONPATH=src python examples/torch_quickstart.py            # on the GPU
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu --steps 60

Scenarios
---------
Mobility, protocol mode and data partition are bundled behind string names
in the scenario registry; the engine replays a ``[T, M]`` schedule:

    from repro_torch.scenarios import get_scenario, run_population

    spec = get_scenario("random_walk")      # or: commuter, foursquare_sparse,
                                            #     shift_worker, event_crowd
    co = spec.colocation(seed=1, n_mules=12, n_steps=240)
    final, aux = run_population(pop, co, batch_fn, train_fn, pcfg, key=42,
                                eval_every=60, eval_fn=eval_hook)

The paper's whole experiments (Table 1, Figs 6-9) run through
``repro_torch.experiment.run_experiment``: see ``examples/torch_table1.py``
and ``examples/torch_fig8_har.py``.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.mule_cnn import CNNConfig
from repro_torch.core import PopulationConfig, init_population
from repro_torch.data import (dirichlet_partition, make_image_dataset,
                              train_test_split)
from repro_torch.device import resolve_device
from repro_torch.experiment import cnn_model_fns, sample_batches
from repro_torch.scenarios import get_scenario, run_population

F, M = 8, 12


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--eval-every", type=int, default=60)
    args = ap.parse_args()
    dev = resolve_device(args.device)

    # --- data: 20 super-classes, Dirichlet(0.01) over 8 spaces --------------
    x, sup, _ = make_image_dataset(0, n_per_sub=16, n_super=20, size=16,
                                   noise=3.0)
    parts = dirichlet_partition(sup, F, alpha=0.01, seed=0, min_per_part=24)
    tr, te = zip(*[train_test_split(p, 0.2, 0) for p in parts])
    n_tr = min(32, min(len(t) for t in tr))
    n_te = min(len(t) for t in te)
    Xtr, Ytr, Xte, Yte = (torch.as_tensor(a, device=dev) for a in (
        np.stack([x[t[:n_tr]] for t in tr]),
        np.stack([sup[t[:n_tr]] for t in tr]),
        np.stack([x[t[:n_te]] for t in te]),
        np.stack([sup[t[:n_te]] for t in te])))

    # --- model + protocol ---------------------------------------------------
    mc = CNNConfig(image_size=16, conv_features=(8, 16), hidden=64,
                   n_classes=20)
    init_fn, train_fn, eval_fn = cnn_model_fns(mc, 0.05)

    def batch_fn(seed, t):
        return {"fixed": sample_batches(seed, Xtr, Ytr, 16), "mule": None}

    pcfg = PopulationConfig(mode="fixed", n_fixed=F, n_mules=M)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    pop = init_population(pcfg, init_fn, gen, device=dev)

    # --- the engine over the whole scenario ---------------------------------
    co = get_scenario("random_walk").colocation(1, M, args.steps)
    eval_v = torch.func.vmap(eval_fn)
    pop, aux = run_population(
        pop, co, batch_fn, train_fn, pcfg, 42, eval_every=args.eval_every,
        eval_fn=lambda st, last: eval_v(st["fixed_models"], Xte, Yte),
        device=dev)

    for t, acc in zip(aux["eval_steps"], aux["evals"].cpu().numpy()):
        print(f"step {t+1:4d}  per-space acc: {np.round(acc, 2)}  "
              f"mean {acc.mean():.3f}")
    print(f"done on {dev} — models evolved purely through mule-carried "
          f"snapshots.")


if __name__ == "__main__":
    main()
