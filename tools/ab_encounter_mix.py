#!/usr/bin/env python3
"""Time this tree's ``encounter_mix`` kernel against another version of
its source, in one process on one NVIDIA GPU.

    python3 tools/ab_encounter_mix.py OTHER.cu

``OTHER.cu`` is the kernel's source from another commit, for example
``git show <commit>:src/repro_torch/kernels/encounter_mix/csrc/encounter_mix.cu
> OTHER.cu``. Both are built with the port's nvcc flags and fed the peer
path's inputs at its first exchange (M = 256 mules of the random walk, D =
546,484, f32, seeded weights). The script checks that both give the same
bits, then times them in turns (other, tree, tree, other), five rounds of
medians of CUDA-event timings, and prints every reading, the medians and
the card's name and power limit. It exits non-zero without a GPU or nvcc.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.encounter_mix import encounter_mix

    card = chip_smoke.phase_card()
    with tempfile.TemporaryDirectory() as tmp:
        lib = Path(tmp) / "other.so"
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                        str(lib), sys.argv[1]], check=True)
        other_fn = ctypes.CDLL(str(lib)).encounter_mix_f32
    other_fn.argtypes = ([ctypes.c_void_p] * 6
                         + [ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                            ctypes.c_void_p])
    other_fn.restype = ctypes.c_int

    pos, area = chip_smoke._walk_geometry(chip_smoke.PEER_EVERY - 1)
    g = torch.Generator(device="cuda")
    g.manual_seed(chip_smoke.SEED + 1)
    m, d = chip_smoke.N_MULES, 546_484
    w = torch.randn(m, d, device="cuda", generator=g)
    area64 = area.to(torch.int64).contiguous()
    on = torch.ones(m, dtype=torch.bool, device="cuda")
    out = torch.empty_like(w)
    mass = torch.empty(m, device="cuda")

    def other():
        err = other_fn(pos.data_ptr(), area64.data_ptr(), on.data_ptr(),
                       w.data_ptr(), out.data_ptr(), mass.data_ptr(), m, d,
                       ctypes.c_float(chip_smoke.RADIUS ** 2),
                       torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the other kernel failed: CUDA error {err}")

    def tree():
        return encounter_mix(pos, area, on, w, radius=chip_smoke.RADIUS)

    other()
    mix, tree_mass = tree()
    torch.cuda.synchronize()
    same = torch.equal(out, mix) and torch.equal(mass, tree_mass)
    print(f"encounter_mix M={m} D={d} f32: the two sources give "
          f"{'the same bits' if same else 'DIFFERENT results'}")
    if not same:
        return 1
    times = {"other": [], "tree": []}
    for _ in range(5):
        for name, fn in (("other", other), ("tree", tree), ("tree", tree),
                         ("other", other)):
            times[name].append(chip_smoke._median_ms(fn))
    for name, ms in times.items():
        print(f"{name}: {[round(t, 4) for t in ms]} ms, median "
              f"{statistics.median(ms):.4f} ms [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
