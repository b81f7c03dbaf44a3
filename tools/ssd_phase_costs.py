#!/usr/bin/env python3
"""Where the time of ``ssd_scan`` goes, phase by phase, on one NVIDIA GPU.

    python3 tools/ssd_phase_costs.py

Builds this tree's ``csrc/ssd_scan.cu`` as it is and in variants that each
leave one phase out (their outputs are wrong; only their times are read),
and times every build at zamba2-2.7b's prefill shape (x [2, 4096, 80, 64],
N 64, chunk 64) with CUDA events, in rounds. A phase's cost is the whole
kernel's median time less the variant's. The phases:

- ``prep``: the preparation kernel (G = C Bᵀ, the transposes, the cumsum);
- ``triangle``: the scan's pass that turns G into M with exp(cum_i - cum_j);
- ``y``: the products of the outputs;
- ``state``: the state update;
- ``loads``: the copies of the next chunk's operands inside the walk.

Every line carries the card's name and power limit. It exits non-zero
without a GPU or nvcc, or when the source no longer has a phase's text.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ROUNDS = 3

# phase -> the source text that runs it and what the variant puts there
PHASES = {
    "prep": ("  ssd_prep_kernel<<<", "  if (B < 0) ssd_prep_kernel<<<"),
    "triangle": ("Mt[j * T + i] = Mt[j * T + i] * expf(ci - cum[j]);", "{}"),
    "y": ("if (r0 < Q) {", "if (r0 < 0) {"),
    "state": ("if (r0 < N) {", "if (r0 < 0) {"),
    "loads": ("    if (ch + 1 < nc) load_xv(ch + 1, cur ^ 1);\n    load_b(ch);\n",
              ""),
}


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build as build
    from repro_torch.kernels.ssm_scan import ops

    card = chip_smoke.phase_card()
    src = (build._PKG / build.SOURCES["ssd_scan"]).read_text()
    variants = {"whole": src}
    for phase, (text, stub) in PHASES.items():
        if text not in src:
            print(f"the source has no {phase} text {text!r}",
                  file=sys.stderr)
            return 1
        variants[phase] = src.replace(text, stub)
    variants["loads"] = variants["loads"].replace(
        "if (ch + 1 < nc) load_cg(ch + 1);", "")
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, text in variants.items():
            cu = Path(tmp) / f"{name}.cu"
            cu.write_text(text)
            procs[name] = subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                 str(cu.with_suffix(".so")), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, proc in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                print(f"nvcc failed for the {name} variant:\n{out}",
                      file=sys.stderr)
                return 1
            libs[name] = ctypes.CDLL(str(Path(tmp) / f"{name}.so"))

    cfg = get_config(chip_smoke.HYBRID_ARCH)
    b, s, p, n, chunk = (chip_smoke.PREFILL_B, chip_smoke.PREFILL_S,
                         cfg.ssm_head_dim, cfg.ssm_state, 64)
    h = cfg.ssm_expand * cfg.d_model // p
    g = torch.Generator(device="cuda")
    g.manual_seed(chip_smoke.SEED + 3)
    a = -torch.arange(1, h + 1, dtype=torch.float32, device="cuda")
    x, dt, A, bm, cm = chip_smoke._ssd_inputs(g, b, s, h, p, n, a)
    geo = ops.ssd_geometry(b, s, h, p, chunk)
    y = torch.empty_like(x)
    tiles = torch.empty(geo["tiles"], device="cuda")
    vecs = torch.empty(geo["vecs"], device="cuda")
    strides = (ctypes.c_longlong * 13)(*x.stride(), *dt.stride(),
                                       *bm.stride(), *cm.stride())
    runs = {}
    for name, lib in libs.items():
        fn = lib.ssd_scan_f32
        fn.argtypes, fn.restype = ops._ARGTYPES, ctypes.c_int

        def run(fn=fn):
            err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), 0,
                     bm.data_ptr(), cm.data_ptr(), y.data_ptr(),
                     tiles.data_ptr(), vecs.data_ptr(), b, s, h, p, n, chunk,
                     strides, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"CUDA error {err}")
        runs[name] = run
    times = {name: [] for name in runs}
    for _ in range(ROUNDS):
        for name, run in runs.items():
            times[name].append(chip_smoke._median_ms(run, reps=10))
    whole = statistics.median(times["whole"])
    print(f"ssd_scan at x {[b, s, h, p]} n={n} chunk={chunk}: whole "
          f"{whole:.4f} ms {[round(t, 4) for t in times['whole']]} [{card}]")
    for name in PHASES:
        ms = statistics.median(times[name])
        print(f"  without {name}: {ms:.4f} ms "
              f"{[round(t, 4) for t in times[name]]}, so {name} costs "
              f"{whole - ms:.4f} ms [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
