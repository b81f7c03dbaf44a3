"""What one card, or one rank of a production mesh, would need for each
(architecture x input shape): a count of one step on the ``meta`` device.

Port of ``repro.launch.dryrun``. For each config of ``configs.ARCH_IDS``
and each ``configs.INPUT_SHAPES`` entry, the model is built at
``backend="auto"`` with its parameters on ``meta`` (shapes, no storage),
and one step runs there under ``launch.cost_analysis.CostCounter``: the
train step (``launch.steps.make_train_step`` with the port's Adam, or SGD
with momentum), the prefill or the decode step. Every hand kernel on the
path is one priced call on ``meta`` and launches nothing; the plain ops,
the flash backward among them, run on shapes. Nothing touches a card: that
is the dry run's purpose, as the reference's runs on host devices.

``--mesh one`` (the default) counts one card holding the whole model:
``mesh`` "1", a collective term of 0 over the host link. ``--mesh single``
/ ``multi`` / ``both`` count **rank 0** of the reference's production mesh
(``launch.mesh.make_production_mesh``: (data 256 / tp, model tp), or (pod
2, data 256 / tp, model tp), ``--tp``, default 16), a stand-in that holds
the rank's coordinates and no process group: the model is
``build_model(cfg, mesh=..., dp_axes=..., moe_ep_axis=None if population
else "model", fsdp=...)``, the rank holds its ``rank_specs`` blocks (with
``--fsdp``, the FSDP cut too; ``--population``, every leaf whole and the
batch over the whole mesh), its block of the batch (``batch_specs``) and,
for decode, its cache (``Model.init_cache`` with the global batch, every
family: ``cache_specs``' block of each KV cache, the kv heads or
``head_dim`` over ``model``, so ``long_500k``'s batch of one holds its
block of the slots too; ``launch.sharding.kv_cache_cut``). Every
collective on the path is a
custom op (``launch.collectives``, ``core.distributed.ordered_psum_op``)
whose shape rule moves nothing on ``meta``, and ``CostCounter`` prices it
by kind: the row's ``coll_breakdown``, its collective term at the rate
between DGX H100 nodes (``link`` "ib", ``roofline.IB_LINK_BYTES_PER_S``).
The count needs no ``torch.distributed`` process group.

Each row is ``roofline.Roofline.row()`` (the reference's keys, and
``link``) with the count's peak live bytes as ``peak_memory_gb`` (a rank's,
on a production mesh), ``fits_one_card`` (that peak within the card's 80
GB), ``param_bytes_per_device`` (the rank's parameter blocks), for decode
``cache_bytes_per_device`` (the rank's cache), the kernels' calls and the
count's seconds; its ``status`` is ``ok``, ``skip`` (the reference's
``skip_reason``) or ``FAIL`` with the error.
``--remat`` (on by default, as the reference's; ``--remat-policy``)
checkpoints each layer of a train step (``Model.remat``).

A Mamba2 layout that splits the channels inside heads (zamba2-2.7b at
``--tp 32``: 160 channels a rank of 80 heads of 64) runs its sub-heads
(``models/mamba2.py``). The reference's dry run sets no ``head_axis``, and
neither does this one's command line; ``count_step`` counts a model built
with it (``chip_smoke.py`` phase 27).

Departures from the reference: a row counts one rank, not the whole
program XLA compiles, so its terms are that rank's (every rank of a mesh
runs the same shapes, the data ranks the same ops); a MoE whose experts
the expert axis does not divide runs them whole on every peer
(``models/moe.py``), where the reference asserts; ``--fsdp`` with
``--population`` raises (``Model.fsdp``: the population layout holds
every leaf whole).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both [--fsdp] --out dryrun.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, InputShape,
                                 get_config, get_smoke_config)
from repro_torch.interop import tree_leaves, tree_map
from repro_torch.launch import roofline
from repro_torch.launch.cost_analysis import CostCounter
from repro_torch.launch.lm_ranks import rank_batch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import data_axes, rank_specs, shard_tree
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import build_model
from repro_torch.models.api import meta_params
from repro_torch.optim import adam, sgd

MESH = "1"          # one card
MESHES = ("one", "single", "multi")


def skip_reason(cfg, shape, sliding_variant: bool) -> Optional[str]:
    """The reference's skips: 500k tokens for the encoder-decoder ASR model
    and, without the sliding variant, for full-attention archs."""
    if shape.name == "long_500k":
        if cfg.family == "audio":
            return "enc-dec ASR decoder; 500k out of family (DESIGN.md)"
        if not cfg.supports_long_context and not sliding_variant:
            return "full-attention arch; paper-faithful config skips 500k " \
                   "(run with --sliding-variant for the windowed variant)"
    return None


def rank_inputs(model, shape: InputShape) -> Dict:
    """One step's inputs at ``shape`` on ``meta`` as the rank of
    ``model.mesh`` holds them (the whole of them without a mesh): its block
    of the batch (``lm_ranks.rank_batch``), or for decode its rows' token
    and cache (``init_cache`` with the global batch) and the last
    position."""
    mesh = model.mesh
    if mesh is None:
        return model.input_specs(shape)
    if shape.kind in ("train", "prefill"):
        return tree_map(lambda t: t.clone(),
                        rank_batch(model, model.input_specs(shape)))
    b = shape.global_batch
    n = mesh.axis_size(data_axes(mesh))
    rows = b // n if b % n == 0 else b
    return {"token": torch.zeros((rows, 1), dtype=torch.int32,
                                 device="meta"),
            "pos": shape.seq_len - 1,
            "cache": model.init_cache(rows, shape.seq_len, device="meta",
                                      global_batch=b)}


def count_step(model, shape: InputShape, optimizer=None,
               donate: bool = False):
    """(the finished ``CostCounter``, the parameter bytes held) of one step
    of ``model`` at ``shape`` on ``meta``, on the rank of ``model.mesh``
    (a stand-in: ``launch.mesh.stand_in_mesh``) or on one card. A train
    step takes ``optimizer`` (default: the port's Adam at 1e-4) and
    ``donate`` (``make_train_step``'s)."""
    whole = meta_params(model)
    params = whole
    if model.mesh is not None:
        # copies of the blocks, as a rank holds them: a view would keep
        # the whole leaf's storage live in the count
        params = tree_map(lambda t: t.clone(), shard_tree(whole, rank_specs(
            model.cfg, whole, model.mesh, model.moe_ep_axis,
            replicate=model.replicate, fsdp=model.fsdp), model.mesh))
    del whole
    inputs = rank_inputs(model, shape)
    # each layer's plain flash backward counted once a shape (replayed)
    with CostCounter(replay=True) as cc:
        if shape.kind == "train":
            opt = adam(1e-4) if optimizer is None else optimizer
            opt_state = opt.init(params)
            cc.hold(params, opt_state, inputs)
            make_train_step(model, opt, donate=donate)(params, opt_state,
                                                       inputs)
        elif shape.kind == "prefill":
            cc.hold(params, inputs)
            make_prefill_step(model)(params, inputs)
        else:
            cc.hold(params, inputs["cache"], inputs["token"])
            make_serve_step(model)(params, inputs["cache"], inputs["token"],
                                   inputs["pos"])
    held = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    return cc, held


def dryrun_one(arch: str, shape: InputShape, *, smoke: bool = False,
               optimizer: str = "adam", sliding_variant: bool = False,
               remat: bool = False, remat_policy: str = "full",
               mesh: str = "one", tp: int = 16, fsdp: bool = False,
               population: bool = False, verbose: bool = True) -> Dict:
    """One row: count one step of ``arch`` at ``shape`` on ``meta``, on one
    card (``mesh="one"``) or on rank 0 of the production mesh ``"single"``
    (16 x 16 at ``tp`` 16) or ``"multi"`` (2 x 16 x 16)."""
    if mesh not in MESHES:
        raise ValueError(f"mesh {mesh!r}: one of {MESHES}")
    name = MESH if mesh == "one" else mesh
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    reason = skip_reason(cfg, shape, sliding_variant)
    if reason:
        return {"arch": arch, "shape": shape.name, "mesh": name,
                "status": "skip", "reason": reason}
    variant = ""
    if (shape.name == "long_500k" and not cfg.supports_long_context
            and sliding_variant):
        cfg = dataclasses.replace(cfg, sliding_window=4096,
                                  global_layer_interval=6)
        variant = "+sliding4k"
    kw = dict(backend="auto", remat=remat, remat_policy=remat_policy)
    if mesh != "one":
        multi = mesh == "multi"
        dp = ("pod", "data") if multi else ("data",)
        kw.update(mesh=make_production_mesh(multi_pod=multi,
                                            model_parallel=tp),
                  dp_axes=dp + (("model",) if population else ()),
                  moe_ep_axis=None if population else "model", fsdp=fsdp)
    elif fsdp or population:
        raise ValueError("--fsdp and --population lay out a production "
                         "mesh: give --mesh single, multi or both")
    model = build_model(cfg, **kw)
    t0 = time.perf_counter()
    opt = None
    if shape.kind == "train" and optimizer != "adam":
        opt = sgd(0.01, momentum=0.9)
    cc, held = count_step(model, shape, opt)
    t_count = time.perf_counter() - t0
    chips = 1 if model.mesh is None else model.mesh.axis_size(
        model.mesh.axis_names)
    rl = roofline.analyze(arch + variant, shape.name, name, chips, cc,
                          roofline.model_flops_for(cfg, shape),
                          link="host" if mesh == "one" else "ib")
    row = rl.row()
    row.update(status="ok", t_count_s=round(t_count, 1),
               remat=remat_policy if remat else None,
               fits_one_card=cc.peak_live_bytes <= roofline.CARD_MEMORY_BYTES,
               param_bytes_per_device=held, kernels=dict(cc.kernels))
    if mesh != "one":
        row.update(tp=tp, fsdp=fsdp, population=population)
    if shape.kind == "decode":      # the decode cache a rank holds
        row["cache_bytes_per_device"] = sum(
            t.numel() * t.element_size()
            for t in tree_leaves(rank_inputs(model, shape)["cache"]))
    if verbose:
        where = ("one card" if mesh == "one" else
                 f"rank 0 of {'x'.join(map(str, model.mesh.shape.values()))}"
                 f"{' fsdp' if fsdp else ''}"
                 f"{' population' if population else ''}")
        print(f"--- {arch}{variant} x {shape.name} ({where}, meta) ---")
        print(f"  roofline: compute={rl.t_compute * 1e3:.2f}ms "
              f"memory={rl.t_memory * 1e3:.2f}ms "
              f"collective={rl.t_collective * 1e3:.2f}ms -> {rl.dominant}; "
              f"FLOPs {rl.flops_per_device:.3e} {dict(rl.flops_by)}")
        mib = {k: f"{v / 2**20:.1f}MiB" for k, v in rl.coll_breakdown.items()}
        print(f"  collectives: {mib}")
        cache = row.get("cache_bytes_per_device")
        print(f"  peak {row['peak_memory_gb']:.2f} GiB "
              f"(fits one card: {row['fits_one_card']}), params "
              f"{held / 2**30:.2f} GiB"
              + ("" if cache is None else f", cache {cache / 2**30:.2f} GiB")
              + f", kernels {row['kernels']}, "
              f"useful_flops_ratio {rl.useful_flops_ratio:.3f}, count "
              f"{t_count:.1f}s")
    return row


def dryrun(archs=ARCH_IDS, shapes: Optional[Dict[str, InputShape]] = None,
           meshes=("one",), **kw) -> list:
    """Rows of every (arch x shape x mesh); a failure is a ``FAIL`` row
    with its error, and the sweep goes on."""
    shapes = INPUT_SHAPES if shapes is None else shapes
    rows = []
    for arch in archs:
        for shape in shapes.values():
            for mesh in meshes:
                try:
                    row = dryrun_one(arch, shape, mesh=mesh, **kw)
                except Exception as e:      # a row of the table, not a crash
                    traceback.print_exc()
                    row = {"arch": arch, "shape": shape.name,
                           "mesh": MESH if mesh == "one" else mesh,
                           "status": "FAIL",
                           "error": f"{type(e).__name__}: {e}"}
                rows.append(row)
                if row["status"] == "skip":
                    print(f"--- {arch} x {shape.name} x {row['mesh']}: "
                          f"SKIP ({row['reason']})")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="one",
                    choices=["one", "single", "multi", "both"],
                    help="one card, or rank 0 of the 16 x 16 (single) or "
                         "2 x 16 x 16 (multi) production mesh")
    ap.add_argument("--tp", type=int, default=16,
                    help="model-parallel degree over the 256-chip pod")
    ap.add_argument("--fsdp", action="store_true",
                    help="also cut each leaf over the data axes")
    ap.add_argument("--population", action="store_true",
                    help="population layout: parameters replicated, the "
                         "whole mesh as data parallelism, shard-local MoE")
    ap.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family configs")
    ap.add_argument("--sliding-variant", action="store_true",
                    help="run long_500k on full-attention archs with a "
                         "4k sliding-window variant")
    ap.add_argument("--remat", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="checkpoint each layer in train steps (default "
                         "on; --no-remat shows the unrematerialized count)")
    ap.add_argument("--remat-policy", default="full",
                    choices=["full", "dots"])
    ap.add_argument("--out", default=None, help="append rows to this json")
    args = ap.parse_args(argv)
    if args.mesh == "one" and (args.fsdp or args.population):
        ap.error("--fsdp and --population lay out a production mesh: give "
                 "--mesh single, multi or both")
    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    names = (list(INPUT_SHAPES) if args.shape == "all"
             else args.shape.split(","))
    meshes = {"one": ("one",), "single": ("single",), "multi": ("multi",),
              "both": ("single", "multi")}[args.mesh]
    rows = dryrun(archs, {n: INPUT_SHAPES[n] for n in names}, meshes,
                  smoke=args.smoke, optimizer=args.optimizer,
                  sliding_variant=args.sliding_variant, remat=args.remat,
                  remat_policy=args.remat_policy, tp=args.tp,
                  fsdp=args.fsdp, population=args.population)
    if args.out:
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)

        def key(r):
            return (r["arch"], r["shape"], r["mesh"], r.get("remat"),
                    r.get("tp"), r.get("fsdp"), r.get("population"))
        keys = {key(r) for r in rows}
        existing = [r for r in existing if key(r) not in keys]
        with open(args.out, "w") as f:
            json.dump(existing + rows, f, indent=1, default=str)
        print(f"wrote {len(rows)} rows -> {args.out}")
    counts = {s: sum(r["status"] == s for r in rows)
              for s in ("ok", "skip", "FAIL")}
    print(f"\n=== dry-run: {counts['ok']} ok, {counts['skip']} skip, "
          f"{counts['FAIL']} FAIL ===")
    return 1 if counts["FAIL"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
