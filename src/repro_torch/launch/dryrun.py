"""What one card would need for each (architecture x input shape): a count
of one step on the ``meta`` device.

Port of ``repro.launch.dryrun``. For each config of ``configs.ARCH_IDS``
and each ``configs.INPUT_SHAPES`` entry, the model is built at
``backend="auto"`` with its parameters on ``meta`` (shapes, no storage),
and one step runs there under ``launch.cost_analysis.CostCounter``: the
train step (``launch.steps.make_train_step`` with the port's Adam, or SGD
with momentum), the prefill or the decode step. Every hand kernel on the
path is one priced call on ``meta`` and launches nothing; the plain ops,
the flash backward among them, run on shapes. Nothing touches a card: that
is the dry run's purpose, as the reference's runs on host devices.

Each row is ``roofline.Roofline.row()`` (the reference's keys) with the
count's peak live bytes as ``peak_memory_gb``, ``fits_one_card`` (that peak
within the card's 80 GB), the kernels' calls and the count's seconds; its
``status`` is ``ok``, ``skip`` (the reference's ``skip_reason``) or
``FAIL`` with the error.

Departures from the reference: one card, so the production meshes,
``--fsdp``, ``--tp``, ``--multi`` / ``--mesh``, the population layout and
the sliding variant's multi-pod rows have no counterpart (the sliding
variant itself runs, ``--sliding-variant``); the rows' mesh is ``"1"``
and their collective term 0. ``--remat`` (with ``--remat-policy``)
checkpoints each layer (``Model.remat``), as the reference's ``remat``:
the row's ``remat`` says which policy ran and its peak is the count's.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --out dryrun.json
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
from repro_torch.launch import roofline
from repro_torch.launch.cost_analysis import CostCounter
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import build_model
from repro_torch.models.api import meta_params
from repro_torch.optim import adam, sgd

MESH = "1"          # one card


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


def dryrun_one(arch: str, shape: InputShape, *, smoke: bool = False,
               optimizer: str = "adam", sliding_variant: bool = False,
               remat: bool = False, remat_policy: str = "full",
               verbose: bool = True) -> Dict:
    """One row: count one step of ``arch`` at ``shape`` on ``meta``."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    reason = skip_reason(cfg, shape, sliding_variant)
    if reason:
        return {"arch": arch, "shape": shape.name, "mesh": MESH,
                "status": "skip", "reason": reason}
    variant = ""
    if (shape.name == "long_500k" and not cfg.supports_long_context
            and sliding_variant):
        cfg = dataclasses.replace(cfg, sliding_window=4096,
                                  global_layer_interval=6)
        variant = "+sliding4k"
    model = build_model(cfg, backend="auto", remat=remat,
                        remat_policy=remat_policy)
    t0 = time.perf_counter()
    params = meta_params(model)
    specs = model.input_specs(shape)
    with CostCounter() as cc:
        if shape.kind == "train":
            opt = (adam(1e-4) if optimizer == "adam"
                   else sgd(0.01, momentum=0.9))
            opt_state = opt.init(params)
            cc.hold(params, opt_state, specs)
            make_train_step(model, opt)(params, opt_state, specs)
        elif shape.kind == "prefill":
            cc.hold(params, specs)
            make_prefill_step(model)(params, specs)
        else:
            cc.hold(params, specs["cache"], specs["token"])
            make_serve_step(model)(params, specs["cache"], specs["token"],
                                   specs["pos"])
    t_count = time.perf_counter() - t0
    rl = roofline.analyze(arch + variant, shape.name, MESH, 1, cc,
                          roofline.model_flops_for(cfg, shape))
    row = rl.row()
    row.update(status="ok", t_count_s=round(t_count, 1),
               remat=remat_policy if remat else None,
               fits_one_card=cc.peak_live_bytes <= roofline.CARD_MEMORY_BYTES,
               kernels=dict(cc.kernels))
    if verbose:
        print(f"--- {arch}{variant} x {shape.name} (one card, meta) ---")
        print(f"  roofline: compute={rl.t_compute * 1e3:.2f}ms "
              f"memory={rl.t_memory * 1e3:.2f}ms -> {rl.dominant}; "
              f"FLOPs {rl.flops_per_device:.3e} {dict(rl.flops_by)}")
        print(f"  peak {row['peak_memory_gb']:.2f} GiB "
              f"(fits one card: {row['fits_one_card']}), kernels "
              f"{row['kernels']}, useful_flops_ratio "
              f"{rl.useful_flops_ratio:.3f}, count {t_count:.1f}s")
    return row


def dryrun(archs=ARCH_IDS, shapes: Optional[Dict[str, InputShape]] = None,
           **kw) -> list:
    """Rows of every (arch x shape); a failure is a ``FAIL`` row with its
    error, and the sweep goes on."""
    shapes = INPUT_SHAPES if shapes is None else shapes
    rows = []
    for arch in archs:
        for shape in shapes.values():
            try:
                row = dryrun_one(arch, shape, **kw)
            except Exception as e:      # a row of the table, not a crash
                traceback.print_exc()
                row = {"arch": arch, "shape": shape.name, "mesh": MESH,
                       "status": "FAIL", "error": f"{type(e).__name__}: {e}"}
            rows.append(row)
            if row["status"] == "skip":
                print(f"--- {arch} x {shape.name}: SKIP ({row['reason']})")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family configs")
    ap.add_argument("--sliding-variant", action="store_true",
                    help="run long_500k on full-attention archs with a "
                         "4k sliding-window variant")
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint each layer (Model.remat)")
    ap.add_argument("--remat-policy", default="full",
                    choices=["full", "dots"])
    ap.add_argument("--out", default=None, help="append rows to this json")
    args = ap.parse_args(argv)
    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    names = (list(INPUT_SHAPES) if args.shape == "all"
             else args.shape.split(","))
    rows = dryrun(archs, {n: INPUT_SHAPES[n] for n in names},
                  smoke=args.smoke, optimizer=args.optimizer,
                  sliding_variant=args.sliding_variant, remat=args.remat,
                  remat_policy=args.remat_policy)
    if args.out:
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        keys = {(r["arch"], r["shape"], r["mesh"], r.get("remat"))
                for r in rows}
        existing = [r for r in existing
                    if (r["arch"], r["shape"], r["mesh"], r.get("remat"))
                    not in keys]
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
