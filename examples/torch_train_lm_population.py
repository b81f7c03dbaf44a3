"""End-to-end driver on the PyTorch port: ML Mule over a population of
language models (counterpart of ``examples/train_lm_population.py``).

Each fixed device hosts an LM of ``--arch`` trained on its space's token
stream (``make_lm_dataset``); mules on the random walk carry LM snapshots
between spaces. ``population_step`` runs in fixed mode, so the ``mule_agg``
kernel aggregates whole LM parameter vectors, and the fixed devices train
under ``torch.func.vmap`` (SGD at 3e-3 through ``Model.loss``), each
kernel of the model launched once for all of them.

  PYTHONPATH=src python examples/torch_train_lm_population.py \\
      --arch stablelm-1.6b --steps 60 --device cpu      # the smoke config
  PYTHONPATH=src python examples/torch_train_lm_population.py \\
      --arch xlstm-350m --full --steps 3                # full width, card

As in the reference, the config is the arch's reduced smoke config unless
``--full`` asks for the published one. ``lm_population`` is the body, which
``chip_smoke.py`` calls with a full config. A MoE arch
(``--arch granite-moe-1b-a400m``) trains its smoke config: the routing and
sort-based dispatch run under ``torch.func.vmap`` like the rest of the
model. At full width it does not fit one 80 GB card: ten models of 5.3 GB
(1,334,578,176 f32 weights each), the fixed devices' vmapped gradients
and ``masked_group_mean``'s ``[M, D]`` copy of the mules' weights.

The population engine keeps each model as a flat dict of leaves (the CNN's
layout); an LM's nested tree rides in it as ``{"00000": leaf, ...}``, the
leaves numbered in ``jax.tree.flatten``'s order, so the aggregation's
``[M, D]`` columns follow the reference's order. ``train_fn`` rebuilds the
tree for ``Model.loss``.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import PopulationConfig, init_population, population_step
from repro_torch.core.freshness import FreshnessConfig
from repro_torch.core.seeds import fold_in
from repro_torch.data import make_lm_dataset
from repro_torch.device import resolve_device
from repro_torch.interop import tree_leaves, tree_map
from repro_torch.mobility import (MobilityConfig, init_mobility,
                                  mobility_step, sample_walk_draws)
from repro_torch.models import build_model

LR = 3e-3


def flat_params(tree) -> dict:
    """A parameter tree as ``{"00000": leaf, ...}`` in leaf order."""
    return {f"{i:05d}": leaf for i, leaf in enumerate(tree_leaves(tree))}


def nested_params(flat: dict, structure):
    """``flat_params``' inverse onto ``structure`` (the tree's nesting)."""
    it = iter(flat[k] for k in sorted(flat))

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return next(it)
    return walk(structure)


def lm_population(cfg, *, steps: int = 60, seq: int = 64, batch: int = 4,
                  n_fixed: int = 4, n_mules: int = 6, eval_every: int = 20,
                  device="cuda", seed: int = 0, on_step=None, log=print):
    """Run ``steps`` population steps; returns ``{"pop", "losses" (per
    eval, one a space), "step_s", "pcfg", "model", "train_fn", "loss"
    (flat params, tokens -> loss), "data" ([F, n, S] tokens)}``.
    ``on_step(t, pop, info, batches)`` is called before step ``t``."""
    dev = resolve_device(device)
    model = build_model(cfg)
    log(f"population of {n_fixed} fixed + {n_mules} mule {cfg.name} models "
        f"({cfg.param_count() / 1e6:.2f}M params each)")

    seqs, spaces = make_lm_dataset(seed, n_seqs=n_fixed * 32, seq_len=seq,
                                   vocab=cfg.vocab, n_spaces=n_fixed)
    per_space = [seqs[spaces == f] for f in range(n_fixed)]
    n = min(len(p) for p in per_space)
    data = torch.as_tensor(np.stack([p[:n] for p in per_space]),
                           dtype=torch.int64, device=dev)     # [F, n, S]

    structure = []

    def init_fn(g):
        params = model.init(g)
        if not structure:
            structure.append(tree_map(lambda _: None, params))
        return flat_params(params)

    def loss(flat, toks):
        return model.loss(nested_params(flat, structure[0]),
                          {"tokens": toks})[0]

    def train_fn(params, toks, key):
        grads = torch.func.grad(loss)(params, toks)
        return {k: p - LR * grads[k] for k, p in params.items()}

    pcfg = PopulationConfig(mode="fixed", n_fixed=n_fixed, n_mules=n_mules,
                            freshness=FreshnessConfig())
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pop = init_population(pcfg, init_fn, gen, device=dev)
    mcfg = MobilityConfig(n_mules=n_mules, n_areas=1, p_cross=0.2)
    draws = sample_walk_draws(mcfg, steps, gen)
    mob = init_mobility(mcfg, draws.sid, draws.u)

    def eval_losses(pop):
        with torch.no_grad():
            return [float(loss({k: v[f] for k, v in
                                pop["fixed_models"].items()},
                               data[f, :batch])) for f in range(n_fixed)]

    losses, step_s = [], []
    for t in range(steps):
        mob, info = mobility_step(mob, mcfg, draws.step_noise[t],
                                  draws.u_cross[t])
        idx = torch.randint(0, n, (n_fixed, batch), generator=gen,
                            device=dev)
        batches = {"fixed": torch.take_along_dim(data, idx[:, :, None],
                                                 dim=1), "mule": None}
        info = {"fixed_id": info["fixed_id"].clamp(-1, n_fixed - 1),
                "exchange": info["exchange"]}
        if on_step is not None:
            on_step(t, pop, info, batches)
        t0 = time.perf_counter()
        pop = population_step(pop, info, batches, train_fn, pcfg,
                              fold_in(42, t))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        if (t + 1) % eval_every == 0:
            losses.append(eval_losses(pop))
            log(f"step {t + 1:4d}  per-space LM loss: "
                f"{np.round(losses[-1], 3)}  ({sum(step_s):.0f}s)")
    return {"pop": pop, "losses": losses, "step_s": step_s, "pcfg": pcfg,
            "model": model, "train_fn": train_fn, "loss": loss,
            "data": data}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--full", action="store_true",
                    help="the published config, not the smoke one")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--n-fixed", type=int, default=4)
    ap.add_argument("--n-mules", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    out = lm_population(cfg, steps=args.steps, seq=args.seq,
                        batch=args.batch, n_fixed=args.n_fixed,
                        n_mules=args.n_mules, device=args.device)
    print("done")
    return out


if __name__ == "__main__":
    main()
