#!/usr/bin/env python3
"""Run the PyTorch/CUDA port of ML Mule on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final result line):

1. the card's name and power limit, as nvidia-smi reports them;
2. build every kernel of ``src/repro_torch`` from its sources with nvcc,
   all at once, and print the build time;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shape and at ragged and edge shapes, in f32 and bf16, with
   TF32 off; time the kernel, the plain version and the one PyTorch call
   that computes the same function (CUDA events, median after warm-up);
4. the main path: ``mlmule`` in mobile mode on the ``commuter`` scenario at
   the full width of the paper's CNN (32x32x3, conv 32/64, hidden 128, 20
   classes), F=8 fixed devices, M=256 mules, batch 16, lr 0.05, T=60 steps,
   an eval every 20, random weights from a seed, through the port's entry
   points with the default aggregation backend (the ``mule_agg`` kernel).
   Kernel launch counts are zeroed just before the run and read just after;
   every eval must be finite. The same run is replayed with
   ``agg_backend="ref"`` and the final weights of the two must agree.

The second-to-last line is a JSON object describing every kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# main path (phase 4)
N_FIXED, N_MULES, BATCH, LR, N_STEPS, EVAL_EVERY = 8, 256, 16, 0.05, 60, 20
PROFILE_STEPS = 5
# The kernel run and its agg_backend="ref" replay differ by fp32 summation
# order only (~1e-7). Training is not continuous in the weights: a change
# that small flips some max-pool and ReLU ties every step at 256 mules x 16
# images, and a flip moves a weight by up to lr*|grad|. So the final
# weights are held to a bound on that growth (the run prints the measured
# gap), and the aggregation itself, which has no ties, is held step by
# step in lockstep to fp32 order.
REPLAY_ATOL = 5e-2
LOCKSTEP_ATOL = 1e-5

# phase 3: the JAX package's kernel tolerances
# (tests/test_kernels_mule_agg.py)
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
# H100 SXM peaks (NVIDIA data sheet): memory rate, fp32 outside the
# tensor cores (the kernel's FMAs)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def _median_ms(fn, reps: int = 30, warm: int = 5) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = out.stdout.strip().splitlines()[0]
    print(line)
    return line


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {len(logs)} kernel sources compiled in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line:
                print(f"  {name}: {line.strip()}")


def phase_kernels() -> dict:
    """mule_agg against its plain version; returns its JSON row."""
    import torch
    from repro_torch.kernels.mule_agg import mule_agg, mule_agg_plain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    d_main = 546_484     # the paper CNN's parameter count (CONFIG)
    cases = [  # (F, M, D): main path, tests/test_kernels_mule_agg.py's
        (N_FIXED, N_MULES, d_main),  # shapes, then A chunked in shared memory
        (8, 20, 256), (8, 20, 1000), (2, 3, 64), (16, 64, 4096), (1, 1, 130),
        (8, 1100, 3000), (16, 600, 2000)]
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[1]]
        for f, m, d in cases:
            a = torch.rand(f, m, device="cuda", generator=g)
            a = a / a.sum(1, keepdim=True)       # rows of a group mean
            w = torch.randn(m, d, device="cuda", generator=g).to(dtype)
            out = mule_agg(a, w)
            torch.cuda.synchronize()
            ref = mule_agg_plain(a, w)
            err = (out.float() - ref.float()).abs().max().item()
            ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
            print(f"mule_agg F={f} M={m} D={d} {dtype}: max_abs_err={err:.3e}"
                  f" (tol {tol}) {'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"mule_agg disagrees with its plain "
                                     f"version at F={f} M={m} D={d} {dtype}")
            if (f, m, d) == cases[0] and dtype == torch.float32:
                ms = _median_ms(lambda: mule_agg(a, w))
                plain_ms = _median_ms(lambda: mule_agg_plain(a, w))
                library_ms = _median_ms(lambda: torch.matmul(a, w))
                n_bytes = 4 * (f * m + m * d + f * d)
                n_flop = 2 * f * m * d
                t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
                t_ops = n_flop / FP32_FLOP_PER_S * 1e3
                row = {
                    "name": "mule_agg", "route": "cuda",
                    "source": "src/repro_torch/kernels/mule_agg/csrc/"
                              "mule_agg.cu",
                    "replaces": "src/repro/kernels/mule_agg/kernel.py:42",
                    "launches": None, "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": library_ms,
                }
                print(f"mule_agg timing F={f} M={m} D={d} f32: kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul "
                      f"{library_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
                      f"({row['bound_by']}; {n_bytes} B, {n_flop} FLOP)")
            elif (f, m, d) == cases[0]:
                bf_ms = _median_ms(lambda: mule_agg(a, w))
                print(f"mule_agg timing F={f} M={m} D={d} bf16: kernel "
                      f"{bf_ms:.4f} ms, bound "
                      f"{2 * m * d / HBM_BYTES_PER_S * 1e3:.4f} ms (W bytes)")
    return row


def _max_diff(a: dict, b: dict, sides) -> float:
    """Largest |a - b| over the float tensors of the named state parts."""
    return max((a[s][k].float() - b[s][k].float()).abs().max().item()
               for s in sides for k in a[s])


def _group_mean_overhead(models, assign) -> None:
    """Time the kernel alone against the whole masked_group_mean (flatten
    of every leaf into [M, D], kernel, split back) on the main path's
    population."""
    import torch
    from repro_torch.core.aggregation import masked_group_mean
    from repro_torch.kernels.mule_agg import mule_agg
    n_m = assign.shape[1]
    flat = torch.cat([models[k].reshape(n_m, -1) for k in sorted(models)],
                     dim=1)
    kern = _median_ms(lambda: mule_agg(assign, flat), reps=10)
    whole = _median_ms(lambda: masked_group_mean(models, assign), reps=10)
    print(f"masked_group_mean at M={n_m} D={flat.shape[1]}: {whole:.4f} ms "
          f"whole, {kern:.4f} ms of it the kernel")


def phase_main_path(card: str) -> dict:
    import torch
    from repro_torch.configs.mule_cnn import CONFIG
    from repro_torch.core.population import PopulationConfig, init_population
    from repro_torch.experiment import (batch_sampler, cnn_model_fns,
                                        image_data_mobile)
    from repro_torch.kernels.mule_agg import mule_agg
    from repro_torch.scenarios import get_scenario, run_population

    spec = get_scenario("commuter")
    co = spec.colocation(SEED, N_MULES, N_STEPS)
    t0 = time.perf_counter()
    Xtr, Ytr, Xte, Yte = image_data_mobile(
        SEED, N_MULES, spec.n_fixed, co["init_space"], co["init_area"],
        n_super=CONFIG.n_classes, image_size=CONFIG.image_size)
    print(f"data: train {tuple(Xtr.shape)}, test {tuple(Xte.shape)} in "
          f"{time.perf_counter() - t0:.2f} s")
    init_fn, train_fn, eval_fn = cnn_model_fns(CONFIG, LR)
    pcfg = PopulationConfig(mode=spec.mode, n_fixed=spec.n_fixed,
                            n_mules=N_MULES)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    pop0 = init_population(pcfg, init_fn, gen)
    d_params = sum(v[0].numel() for v in pop0["mule_models"].values())
    print(f"population: {N_MULES} mules + {spec.n_fixed} fixed devices, "
          f"D={d_params} parameters each ({CONFIG.name})")
    batch_fn = batch_sampler(Xtr, Ytr, BATCH)

    def eval_hook(st, last):
        return torch.func.vmap(eval_fn)(st["mule_models"], Xte[last],
                                        Yte[last])

    def run(cfg, colocation):
        return run_population(pop0, colocation, batch_fn, train_fn, cfg,
                              SEED, eval_every=EVAL_EVERY, eval_fn=eval_hook)

    # warm-up: cuDNN plans and first-call set-up, outside the counted run
    run(pcfg, {k: co[k][:3] for k in ("fixed_id", "exchange")})
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    mule_agg.launches = 0
    t0 = time.perf_counter()
    final, aux = run(pcfg, co)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mule_agg.launches
    peak = torch.cuda.max_memory_allocated()

    if launches != N_STEPS:
        raise AssertionError(f"mule_agg launched {launches} times in a "
                             f"{N_STEPS}-step run, expected {N_STEPS}")
    evals = aux["evals"]
    if evals is None or tuple(evals.shape) != (N_STEPS // EVAL_EVERY,
                                               N_MULES):
        raise AssertionError(f"evals of shape "
                             f"{None if evals is None else evals.shape}")
    if not bool(torch.isfinite(evals).all()):
        raise AssertionError("non-finite eval")
    receipts = int(final["fresh"]["count"].sum())
    if receipts == 0:
        raise AssertionError("no mule delivered to a fixed device")
    for k, v in {**final["mule_models"], **final["fixed_models"]}.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite weights in {k}")
    trace = [(int(s), float(a)) for s, a in
             zip(aux["eval_steps"], evals.mean(1).tolist())]
    print(f"main path: mlmule mobile on commuter, T={N_STEPS}: "
          f"{N_STEPS / wall:.3f} steps/s ({wall:.3f} s), peak memory "
          f"{peak} B, mule_agg launches {launches}, receipts {receipts}, "
          f"accuracy trace {trace} [{card}]")

    # the whole path against its plain version (agg_backend="ref"), with
    # cuDNN's deterministic algorithms so that the runs differ only where
    # the two backends do
    ref_cfg = dataclasses.replace(pcfg, agg_backend="ref")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    det_a, _ = run(pcfg, co)
    det_b, _ = run(pcfg, co)
    det_ref, _ = run(ref_cfg, co)
    same = _max_diff(det_a, det_b, ("mule_models", "fixed_models"))
    print(f"deterministic replay, kernel twice: max |final weight diff| = "
          f"{same:.3e} (must be 0)")
    if same != 0.0:
        raise AssertionError("the port's path is not deterministic")
    diff = _max_diff(det_a, det_ref, ("mule_models", "fixed_models"))
    print(f"replay with agg_backend='ref': max |final weight diff| = "
          f"{diff:.3e} (tol {REPLAY_ATOL})")
    if not diff <= REPLAY_ATOL:
        raise AssertionError("the kernel run and the plain run disagree")
    # lockstep: each step from the same state through both backends; the
    # aggregation side (fixed models, freshness) must agree to fp32 order
    st, agg_worst, mule_worst = pop0, 0.0, 0.0
    for t in range(N_STEPS):
        one = {k: co[k][t:t + 1] for k in ("fixed_id", "exchange")}
        k_t = SEED * N_STEPS + t
        a, _ = run_population(st, one, batch_fn, train_fn, pcfg, k_t)
        b, _ = run_population(st, one, batch_fn, train_fn, ref_cfg, k_t)
        agg_worst = max(agg_worst, _max_diff(a, b, ("fixed_models", "fresh")))
        mule_worst = max(mule_worst, _max_diff(a, b, ("mule_models",)))
        st = a
    torch.backends.cudnn.deterministic = False
    print(f"lockstep over {N_STEPS} steps, kernel vs ref from the same "
          f"state: aggregation side max diff {agg_worst:.3e} (tol "
          f"{LOCKSTEP_ATOL}), trained mule side max diff {mule_worst:.3e}")
    if not agg_worst <= LOCKSTEP_ATOL:
        raise AssertionError("mule_agg and the plain aggregation disagree "
                             "on the main path")

    assign = torch.rand(spec.n_fixed, N_MULES, device="cuda", generator=gen)
    _group_mean_overhead(final["mule_models"], assign / assign.sum(1)[:, None])
    _profile_steps(lambda: run(pcfg, {k: co[k][:PROFILE_STEPS]
                                      for k in ("fixed_id", "exchange")}))
    return {"mule_agg": launches}


def _profile_steps(fn) -> None:
    """Device time by kernel, and the device's busy share, over one short
    run of the main path (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        # kernels only: an operator's row repeats its kernels' time
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            rows.append((us, ev.key, ev.count))
    rows.sort(reverse=True)
    summed = sum(r[0] for r in rows)
    # kernels can overlap (cuDNN issues grouped convolutions as concurrent
    # per-group kernels), so the busy time is the union of their intervals
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    print(f"profile of {PROFILE_STEPS} steps: wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), "
          f"kernel time summed {summed / 1e3:.3f} ms")
    for us, key, count in rows[:12]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / summed:5.1f}%  x{count:<5d} "
              f"{key[:90]}")


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke.py needs the repository around it: no "
              f"src/repro_torch under {ROOT}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    phase = "card"
    try:
        card = phase_card()
        phase = "build"
        phase_build()
        phase = "kernels"
        rows = [phase_kernels()]
        phase = "main path"
        launches = phase_main_path(card)
    except Exception:
        traceback.print_exc()
        print(f"FAILED in phase: {phase}", file=sys.stderr)
        return 1
    for row in rows:
        row["launches"] = launches[row["name"]]
        if not all(isinstance(row[k], (int, float)) and math.isfinite(row[k])
                   for k in ("launches", "max_abs_err", "ms", "plain_ms",
                             "bound_ms", "library_ms")):
            print(f"incomplete kernel row {row}", file=sys.stderr)
            return 1
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
