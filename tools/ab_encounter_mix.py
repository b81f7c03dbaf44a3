#!/usr/bin/env python3
"""Time this tree's encounter kernels against another version of their
source, in one process on one NVIDIA GPU.

    python3 tools/ab_encounter_mix.py OTHER.cu

``OTHER.cu`` is ``encounter_mix.cu`` from another commit, for example
``git show <commit>:src/repro_torch/kernels/encounter_mix/csrc/encounter_mix.cu
> OTHER.cu``. It is built with the port's nvcc flags; a source without the
``encounter_pairs`` entry takes the older interface (no pair scratch, no
dense switch), and one without ``encounter_sums_shapes`` a hop entry
without the sums kernel's shape. Both sides take their hand-picked launches:
the tuning cache is switched off (``REPRO_TORCH_TUNE_CACHE`` empty). Three
inputs, f32, seeded weights:

- ``walk``: the peer path's first exchange (M = 256 mules of the random
  walk, D = 546,484), through ``encounter_mix_f32``;
- ``dense strip``: the same shape with pos 0 and two areas, as the trace
  scenarios give the peer step (every same-area pair meets);
- ``hop``: the ring path's busiest remote hop (R = V = 64), through
  ``encounter_hop_f32`` (or, in a source without it,
  ``encounter_hop_lanes_f32`` with one lane).

For each, the script checks that both sources give the same bits (mix or
sums, and mass), then times them in turns (other, tree, tree, other), five
rounds of medians of CUDA-event timings, and prints every reading and the
medians. Then it sweeps this tree's dense switch
(forced through ``ops.DENSE_MIN``: 0 makes every strip dense, 33 none) on the
walk and the dense strip, checking the bits at each setting. Last, the
tree's hop against ``encounter_block``: after the allocator's next
blocks are filled with NaN (a cell the kernel never writes would show),
and in HOP_REPEATS back-to-back hops alternating with mixes (a race of
the early-launched sums kernel would show). Every line carries the card's
name and power limit. It exits non-zero without a GPU or nvcc, or if any
two results differ.
"""
from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SWEEP = (0, 4, 8, 12, 16, 33)
HOP_REPEATS = 200
# encounter_mix_f32's C interface in sources with the pair scratch: pos,
# area, active, W, out, mass, words, M, D, r2, dense_min, stream
MIX_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong,
                                        ctypes.c_float, ctypes.c_int,
                                        ctypes.c_void_p]


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
    from repro_torch.kernels.encounter_mix import (encounter_block_hop,
                                                   encounter_mix, ops)
    from repro_torch.kernels.encounter_mix.ref import n_words

    card = chip_smoke.phase_card()
    with tempfile.TemporaryDirectory() as tmp:
        lib_path = Path(tmp) / "other.so"
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                        str(lib_path), sys.argv[1]], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(str(lib_path))
    new_abi = hasattr(lib, "encounter_pairs")
    shape_abi = hasattr(lib, "encounter_sums_shapes")
    # a source whose only hop entry takes S lanes is called with S = 1
    lanes_hop = not hasattr(lib, "encounter_hop_f32")
    mix_fn = lib.encounter_mix_f32
    hop_fn = lib.encounter_hop_lanes_f32 if lanes_hop else \
        lib.encounter_hop_f32
    if new_abi:
        # ops._HOP_ARGTYPES ends S, D, r2, dense_min, shape, stream: a
        # source without the shape argument takes it without, one without
        # the lanes entry without S too
        hop = (ops._HOP_ARGTYPES if shape_abi
               else ops._HOP_ARGTYPES[:-2] + ops._HOP_ARGTYPES[-1:])
        mix_fn.argtypes = MIX_ARGTYPES
        hop_fn.argtypes = hop if lanes_hop else hop[:-5] + hop[-4:]
    else:
        mix_fn.argtypes = ([ctypes.c_void_p] * 6
                           + [ctypes.c_int, ctypes.c_longlong,
                              ctypes.c_float, ctypes.c_void_p])
        hop_fn.argtypes = (ops._SIDES + [ctypes.c_void_p] * 3
                           + [ctypes.c_longlong, ctypes.c_float,
                              ctypes.c_void_p])
    mix_fn.restype = hop_fn.restype = ctypes.c_int
    print(f"the other source takes the "
          f"{'pair-scratch' if new_abi else 'older'} interface [{card}]")

    g = torch.Generator(device="cuda")
    g.manual_seed(chip_smoke.SEED + 1)
    m, d = chip_smoke.N_MULES, 546_484
    r2 = ctypes.c_float(chip_smoke.RADIUS ** 2)
    w = torch.randn(m, d, device="cuda", generator=g)
    on = torch.ones(m, dtype=torch.bool, device="cuda")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def other_mix(pos, area):
        area64 = area.to(torch.int64).contiguous()
        out = torch.empty_like(w)
        mass = torch.empty(m, device="cuda")
        # the closure holds the scratch tensor itself: a pointer alone
        # would let the allocator hand its block on while the kernel still
        # writes its pair words there
        words = torch.empty((m, n_words(m)), dtype=torch.int32,
                            device="cuda")

        def run():
            extra = ([words.data_ptr()], [ops.DENSE_PAIRS_PER_ROW]) \
                if new_abi else ([], [])
            err = mix_fn(pos.data_ptr(), area64.data_ptr(), on.data_ptr(),
                         w.data_ptr(), out.data_ptr(), mass.data_ptr(),
                         *extra[0], m, d, r2, *extra[1], stream())
            if err != 0:
                raise RuntimeError(f"the other kernel failed: CUDA error "
                                   f"{err}")
            return out, mass
        return run

    def other_hop(args):
        pr, ar, _, row0, pv, av, _, col0, wv, _ = args
        r, v = pr.shape[0], pv.shape[0]
        ar64, av64 = (a.to(torch.int64).contiguous() for a in (ar, av))
        pr, pv = pr.contiguous(), pv.contiguous()
        on_r = torch.ones(r, dtype=torch.bool, device="cuda")
        on_v = torch.ones(v, dtype=torch.bool, device="cuda")
        acc = torch.empty((r, d), device="cuda")
        mass = torch.empty(r, device="cuda")
        words = torch.empty((r, n_words(v)), dtype=torch.int32,
                            device="cuda")

        def run():
            extra = ([words.data_ptr()], [ops.DENSE_PAIRS_PER_ROW]) \
                if new_abi else ([], [])
            err = hop_fn(pr.data_ptr(), ar64.data_ptr(), on_r.data_ptr(), r,
                         row0, pv.data_ptr(), av64.data_ptr(),
                         on_v.data_ptr(), v, col0, wv.data_ptr(),
                         acc.data_ptr(), mass.data_ptr(), *extra[0],
                         *([1] if lanes_hop else []), d, r2,
                         *extra[1], *([0] if shape_abi else []), stream())
            if err != 0:
                raise RuntimeError(f"the other hop failed: CUDA error {err}")
            return acc, mass
        return run

    walk = chip_smoke._walk_geometry(chip_smoke.PEER_EVERY - 1)
    dense = chip_smoke._dense_strip_geometry(g)
    co, _ = chip_smoke._ring_walk()
    ring_pos = torch.as_tensor(co["pos"][chip_smoke.PEER_EVERY - 1],
                               device="cuda")
    ring_area = torch.as_tensor(co["area"], device="cuda")
    hop_args, hop_pairs, (hi, hj) = chip_smoke._busiest_remote_hop(
        ring_pos, ring_area, w)
    inputs = {
        "walk": (other_mix(*walk), lambda: encounter_mix(
            walk[0], walk[1], on, w, radius=chip_smoke.RADIUS)),
        "dense strip": (other_mix(*dense), lambda: encounter_mix(
            dense[0], dense[1], on, w, radius=chip_smoke.RADIUS)),
        f"hop (rows {hi}, visiting {hj}; {hop_pairs} pairs)": (
            other_hop(hop_args), lambda: encounter_block_hop(*hop_args)),
    }
    ok = True
    for name, (other, tree) in inputs.items():
        a, a_mass = other()
        b, b_mass = tree()
        torch.cuda.synchronize()
        same = torch.equal(a, b) and torch.equal(a_mass, b_mass)
        ok &= same
        print(f"{name}, f32: the two sources give "
              f"{'the same bits' if same else 'DIFFERENT results'} "
              f"({int(b_mass.sum().item())} met pairs) [{card}]")
        if not same:
            print(f"  max |other - tree| {(a - b).abs().max().item():.3e}, "
                  f"{int((a != b).sum())} cells, masses "
                  f"{'equal' if torch.equal(a_mass, b_mass) else 'differ'}")
        del a, b
        times = {"other": [], "tree": []}
        for _ in range(5):
            for label, fn in (("other", other), ("tree", tree),
                              ("tree", tree), ("other", other)):
                times[label].append(chip_smoke._median_ms(fn))
        for label, ms in times.items():
            print(f"  {name} {label}: {[round(t, 4) for t in ms]} ms, "
                  f"median {statistics.median(ms):.4f} ms [{card}]")

    ok &= _hop_checks(hop_args, walk, on, w, card)
    try:
        for name in ("walk", "dense strip"):
            tree = inputs[name][1]
            want, want_mass = tree()
            for dense_min in SWEEP:
                ops.DENSE_MIN = dense_min
                got, got_mass = tree()
                torch.cuda.synchronize()
                same = torch.equal(got, want) and torch.equal(got_mass,
                                                              want_mass)
                ok &= same
                ms = statistics.median(chip_smoke._median_ms(tree)
                                       for _ in range(3))
                print(f"  {name} tree, dense switch at {dense_min} pairs a "
                      f"row: {'same bits' if same else 'DIFFERENT'}, "
                      f"{ms:.4f} ms [{card}]")
                del got
            del want
    finally:
        ops.DENSE_MIN = None
    return 0 if ok else 1


def _hop_checks(hop_args, walk, on, w, card: str) -> bool:
    """The tree's hop against encounter_block on a poisoned allocator and
    over HOP_REPEATS back-to-back hops alternating with walk mixes."""
    import torch
    import chip_smoke
    from repro_torch.kernels.encounter_mix import (encounter_block,
                                                   encounter_block_hop,
                                                   encounter_mix)
    want, want_mass = encounter_block(*hop_args)
    r, d = hop_args[0].shape[0], hop_args[8].shape[1]
    junk = (torch.empty((r, d), device="cuda").fill_(float("nan")),
            torch.empty(r, device="cuda").fill_(float("nan")))
    del junk                                  # the blocks the hop takes next
    got, got_mass = encounter_block_hop(*hop_args)
    torch.cuda.synchronize()
    poisoned = (bool(torch.isfinite(got).all())
                and torch.equal(got_mass, want_mass)
                and torch.equal(got, want))
    print(f"hop after NaN-filled blocks: "
          f"{'the bits of encounter_block' if poisoned else 'DIFFERENT'}"
          f" [{card}]")
    differ = 0
    for _ in range(HOP_REPEATS):
        got, got_mass = encounter_block_hop(*hop_args)
        encounter_mix(walk[0], walk[1], on, w, radius=chip_smoke.RADIUS)
        differ += int(not (torch.equal(got_mass, want_mass)
                           and torch.equal(got, want)))
    print(f"{HOP_REPEATS} hops alternating with walk mixes: {differ} differ "
          f"from encounter_block [{card}]")
    return poisoned and differ == 0


if __name__ == "__main__":
    sys.exit(main())
