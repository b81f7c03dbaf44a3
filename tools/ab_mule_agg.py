#!/usr/bin/env python3
"""Hold this tree's mule_agg kernel against another version of its source,
in one process on one NVIDIA GPU, and time both.

    python3 tools/ab_mule_agg.py OTHER.cu

``OTHER.cu`` is ``mule_agg.cu`` from another commit with the lane-batched C
entries ``mule_agg_lanes_f32`` / ``mule_agg_lanes_bf16`` (A, W, out, S, F,
M, D, stream; with ``grid_blocks`` before the stream in a source that
exports ``mule_agg_wave_blocks``, called with 0: one wave), for example
``git show <commit>:src/repro_torch/kernels/mule_agg/csrc/mule_agg.cu >
build/other_mule_agg.cu``. It is built with the port's nvcc flags. Both
sides launch their hand-picked grid: the tuning cache is switched off
(``REPRO_TORCH_TUNE_CACHE`` empty). At the paths' shapes (F, M, D):

- (8, 256, 546,484): the main path, the sweep;
- (12, 256, 546,484): the multi-area scenarios;
- (8, 20, 546,484): Table 1's fixed path;
- (8, 256, 44,580): the HAR path (the LSTM-CNN),

in f32 and bf16, as one lane and as 4 lanes, seeded inputs, the script
checks that both sources give the same bits, then times them in turns
(other, tree, tree, other), five rounds of medians, W's copies rotating
so that each call finds it cold; a call whose bound is under
``chip_smoke.GRAPH_BELOW_MS`` is timed in a CUDA graph (``chip_smoke.
_cold_ms``). Every line carries the card's name and power limit. It exits
non-zero without a GPU or nvcc, or if any two results differ.
"""
from __future__ import annotations

import ctypes
import math
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ROUNDS = 5
LANES = 4
D_MAIN = 546_484     # the paper CNN's parameter count
SHAPES = ((8, 256, D_MAIN, "main path"), (12, 256, D_MAIN, "multi-area"),
          (8, 20, D_MAIN, "Table 1"), (8, 256, 44_580, "HAR"))


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    os.environ["REPRO_TORCH_TUNE_CACHE"] = ""    # the hand picks, both sides
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.mule_agg import mule_agg_lanes
    from repro_torch.kernels.mule_agg.ops import _LANES_ARGTYPES, _LANES_ENTRY

    card = chip_smoke.phase_card()
    with tempfile.TemporaryDirectory() as tmp:
        lib_path = Path(tmp) / "other.so"
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                        str(lib_path), sys.argv[1]], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(str(lib_path))
    # a source without the wave query takes no grid_blocks argument
    grid_abi = hasattr(lib, "mule_agg_wave_blocks")
    entries = {}
    for dtype, name in _LANES_ENTRY.items():
        fn = getattr(lib, name)
        fn.argtypes = (_LANES_ARGTYPES if grid_abi
                       else _LANES_ARGTYPES[:-2] + _LANES_ARGTYPES[-1:])
        fn.restype = ctypes.c_int
        entries[dtype] = fn

    def other(a, w):
        s, f, m = a.shape
        out = torch.empty((s, f, w.shape[2]), dtype=w.dtype, device="cuda")
        err = entries[w.dtype](a.data_ptr(), w.data_ptr(), out.data_ptr(), s,
                               f, m, w.shape[2], *([0] if grid_abi else []),
                               torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the other kernel failed: CUDA error {err}")
        return out

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(chip_smoke.SEED + 3)
    ok = True
    for f, m, d, what in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for s in (1, LANES):
                w_bytes = s * m * d * (4 if dtype == torch.float32 else 2)
                inputs = []
                for _ in range(max(1, math.ceil(chip_smoke.COLD_BYTES
                                                / w_bytes))):
                    a = torch.rand(s, f, m, device="cuda", generator=g)
                    a = a / a.sum(2, keepdim=True)
                    w = torch.randn(s, m, d, device="cuda",
                                    generator=g).to(dtype)
                    inputs.append((a, w))
                label = (f"S={s} F={f} M={m} D={d} "
                         f"{str(dtype).split('.')[1]} ({what})")
                a, w = inputs[0]
                x, y = other(a, w), mule_agg_lanes(a, w)
                torch.cuda.synchronize()
                same = torch.equal(x, y)
                ok &= same
                print(f"{label}: the two sources give "
                      f"{'the same bits' if same else 'DIFFERENT results'} "
                      f"[{card}]")
                if not same:
                    diff = (x.float() - y.float()).abs()
                    print(f"  max |other - tree| {diff.max().item():.3e}, "
                          f"{int((x != y).sum())} cells")
                del x, y
                bound = (4 * s * f * m + w_bytes + w_bytes // m * f) \
                    / chip_smoke.HBM_BYTES_PER_S * 1e3
                graph = bound < chip_smoke.GRAPH_BELOW_MS
                times = {"other": [], "tree": []}
                for _ in range(ROUNDS):
                    for side, fn in (("other", other),
                                     ("tree", mule_agg_lanes),
                                     ("tree", mule_agg_lanes),
                                     ("other", other)):
                        times[side].append(chip_smoke._cold_ms(
                            fn, inputs, graph, reps=10))
                how = (f"CUDA graph of {chip_smoke.GRAPH_CALLS * len(inputs)}"
                       f" calls" if graph else "CUDA events, one call each")
                for side, ms in times.items():
                    print(f"  {label} {side}: {[round(t, 4) for t in ms]} "
                          f"ms, median {statistics.median(ms):.4f} ms, bound "
                          f"{bound:.4f} ms; {how}, W in {len(inputs)} "
                          f"cop{'y' if len(inputs) == 1 else 'ies'} [{card}]")
                del inputs, a, w
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
