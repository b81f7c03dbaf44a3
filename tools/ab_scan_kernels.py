#!/usr/bin/env python3
"""Hold this tree's scan kernels against another version of their sources,
in one process on one NVIDIA GPU, and time both.

    python3 tools/ab_scan_kernels.py OTHER_SLSTM.cu OTHER_SSD.cu

The two files are ``slstm_scan.cu`` and ``ssd_scan.cu`` from another
commit, for example ``git show <commit>:src/repro_torch/kernels/slstm_fused/
csrc/slstm_scan.cu > build/other_slstm.cu`` (and ``.../ssm_scan/csrc/
ssd_scan.cu``). Both are built with the port's nvcc flags; an
``ssd_scan.cu`` without ``ssd_prep_kernel`` is called through the older C
interface, which takes no scratch, and one without ``a_rs`` takes no row
stride for A (``slstm_scan_f32`` kept its interface).
Checks, f32, seeded inputs:

- ``ssd_scan``: the two sources give the same bits on chip_smoke.py's
  SSD_CASES, SSD_EDGE and zamba2-2.7b's prefill shape (x [2, 4096, 80, 64],
  N 64, chunk 64, A = -(1 .. 80));
- ``slstm_scan``: on SLSTM_CASES, SLSTM_EDGE and xlstm-350m's prefill shape
  (pre [2, 4096, 4, 4, 256]) both sources lie within SLSTM_TOL of the plain
  version and of each other;
- the step floor of this tree's ``slstm_scan`` (the h exchange alone, 4,096
  steps at xlstm's grid) through st.async and mbarriers and through DSMEM
  stores and ``cluster.sync()`` must end with h = S.

Then it times each kernel at its full shape in turns (other, tree, tree,
other), five rounds of medians of CUDA-event timings, prints every reading
and the medians, and the step floors beside them. Every line carries the
card's name and power limit. It exits non-zero without a GPU or nvcc, or on
any mismatch.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ROUNDS = 5


def _build(src: str, out: Path) -> tuple:
    """Builds ``src`` into ``out``; returns (library, ptxas report lines)."""
    from repro_torch.kernels import _build as build
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                          str(out), src], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}"
                           f"{res.stderr}")
    lines = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    return ctypes.CDLL(str(out)), lines


def _print_ptxas(label: str, lines, card: str) -> None:
    entry = ""
    for ln in lines:
        if "Compiling entry" in ln:
            entry = ln.split("'")[1]
        else:
            print(f"  {label} {entry}: {ln} [{card}]")


def _turns(name: str, other, tree, card: str, reps: int) -> dict:
    import chip_smoke
    times = {"other": [], "tree": []}
    for _ in range(ROUNDS):
        for label, fn in (("other", other), ("tree", tree), ("tree", tree),
                          ("other", other)):
            times[label].append(chip_smoke._median_ms(fn, reps=reps,
                                                      warm=2))
    for label, ms in times.items():
        print(f"  {name} {label}: {[round(t, 4) for t in ms]} ms, median "
              f"{statistics.median(ms):.4f} ms [{card}]")
    return {k: statistics.median(v) for k, v in times.items()}


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build as build
    from repro_torch.kernels.slstm_fused import ops as sops
    from repro_torch.kernels.slstm_fused import slstm_reference, slstm_scan
    from repro_torch.kernels.ssm_scan import ops as dops
    from repro_torch.kernels.ssm_scan import ssd_scan

    card = chip_smoke.phase_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    slstm_src, ssd_src = sys.argv[1], sys.argv[2]
    ssd_text = Path(ssd_src).read_text()
    new_ssd = "ssd_prep_kernel" in ssd_text
    a_rs = [0] if "a_rs" in ssd_text else []   # A's row stride, A [H]
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        # this tree's sources too, for their ptxas reports
        for key, src in (("other slstm", slstm_src), ("other ssd", ssd_src),
                         ("tree slstm", str(build._PKG / build.SOURCES[
                             "slstm_scan"])),
                         ("tree ssd", str(build._PKG / build.SOURCES[
                             "ssd_scan"]))):
            libs[key], lines = _build(src, Path(tmp) / (
                key.replace(" ", "_") + ".so"))
            _print_ptxas(key, lines, card)
    print(f"the other ssd_scan source takes the "
          f"{'scratch' if new_ssd else 'older'} interface [{card}]")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    # ---- ssd_scan ------------------------------------------------------
    ssd_fn = libs["other ssd"].ssd_scan_f32
    ssd_fn.restype = ctypes.c_int
    # dops._ARGTYPES's fourth entry is A's row stride
    ssd_fn.argtypes = dops._ARGTYPES[:3] + dops._ARGTYPES[
        4 - len(a_rs):] if new_ssd else (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 +
        [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])

    def other_ssd(args, chunk):
        x, dt, A, bm, cm = args
        b, s, h, p = x.shape
        n = bm.shape[2]
        y = torch.empty((b, s, h, p), device="cuda")
        strides = (ctypes.c_longlong * 13)(*x.stride(), *dt.stride(),
                                           *bm.stride(), *cm.stride())
        A = A.contiguous()
        scratch = []
        if new_ssd:
            geo = dops.ssd_geometry(b, s, h, p, chunk)
            scratch = [torch.empty(geo["tiles"], device="cuda"),
                       torch.empty(geo["vecs"], device="cuda")]

        def run():
            err = ssd_fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), *a_rs,
                         bm.data_ptr(), cm.data_ptr(), y.data_ptr(),
                         *(t.data_ptr() for t in scratch), b, s, h, p, n,
                         chunk, strides, stream())
            if err != 0:
                raise RuntimeError(f"the other ssd_scan failed: CUDA error "
                                   f"{err}")
            return y
        return run

    ok = True
    g = torch.Generator(device="cuda")
    g.manual_seed(chip_smoke.SEED + 3)
    cfg = get_config(chip_smoke.HYBRID_ARCH)
    zb, zs = chip_smoke.PREFILL_B, chip_smoke.PREFILL_S
    zp, zn = cfg.ssm_head_dim, cfg.ssm_state
    zh = cfg.ssm_expand * cfg.d_model // zp
    cases = [(c, None) for c in chip_smoke.SSD_CASES + chip_smoke.SSD_EDGE]
    cases.append(((zb, zs, zh, zp, zn, 64), -torch.arange(
        1, zh + 1, dtype=torch.float32, device="cuda")))
    for (b, s, h, p, n, chunk), a in cases:
        args = chip_smoke._ssd_inputs(g, b, s, h, p, n, a)
        want = other_ssd(args, chunk)().clone()
        got, _ = ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        ok &= same
        label = f"ssd_scan b={b} s={s} h={h} p={p} n={n} chunk={chunk}"
        print(f"{label}: the two sources give "
              f"{'the same bits' if same else 'DIFFERENT results'} (max "
              f"|diff| {(got - want).abs().max().item():.3e}) [{card}]")
    _turns(label, other_ssd(args, chunk),
           lambda: ssd_scan(*args, chunk=chunk), card, reps=10)
    del args, want, got

    # ---- slstm_scan ----------------------------------------------------
    sl_fn = libs["other slstm"].slstm_scan_f32
    sl_fn.restype = ctypes.c_int
    sl_fn.argtypes = sops._ARGTYPES

    def other_slstm(pre, r):
        b, s, _, h, p = pre.shape
        out = torch.empty((b, s, h, p), device="cuda")
        strides = (ctypes.c_longlong * 9)(*pre.stride(), *r.stride())

        def run():
            err = sl_fn(pre.data_ptr(), r.data_ptr(), out.data_ptr(), b, s,
                        h, p, strides, stream())
            if err != 0:
                raise RuntimeError(f"the other slstm_scan failed: CUDA "
                                   f"error {err}")
            return out
        return run

    g.manual_seed(chip_smoke.SEED + 4)
    xc = get_config(chip_smoke.XLSTM_ARCH)
    xh = xc.n_heads
    scases = [(c, 1.0, 0.1) for c in chip_smoke.SLSTM_CASES
              + chip_smoke.SLSTM_EDGE]
    scases.append(((zb, zs, xh, xc.d_model // xh), chip_smoke.SLSTM_PRE_STD,
                   chip_smoke.SLSTM_R_STD))
    tol = chip_smoke.SLSTM_TOL
    for (b, s, h, p), pre_std, r_std in scases:
        pre, r = chip_smoke._slstm_inputs(g, b, s, h, p, pre_std, r_std)
        plain = slstm_reference(pre, r)[0]
        other = other_slstm(pre, r)().clone()
        got = slstm_scan(pre, r)
        torch.cuda.synchronize()
        errs = {"other vs plain": (other - plain).abs().max().item(),
                "tree vs plain": (got - plain).abs().max().item(),
                "tree vs other": (got - other).abs().max().item()}
        good = all(e <= tol for e in errs.values())
        ok &= good
        label = f"slstm_scan b={b} s={s} h={h} p={p}"
        print(f"{label}: " + ", ".join(f"{k} {v:.3e}" for k, v in
                                       errs.items())
              + f" (bound {tol:g}) {'ok' if good else 'MISMATCH'} [{card}]")
    med = _turns(label, other_slstm(pre, r), lambda: slstm_scan(pre, r),
                 card, reps=5)
    print(f"  {label}: other {med['other'] * 1e3 / s:.3f} us a step, tree "
          f"{med['tree'] * 1e3 / s:.3f} us a step [{card}]")
    for sync in ("mbarrier", "cluster"):
        last = sops.slstm_step_floor(b, s, h, p, sync=sync)[:, s - 1]
        good = bool((last == float(s)).all())
        ok &= good
        ms = statistics.median(chip_smoke._median_ms(
            lambda: sops.slstm_step_floor(b, s, h, p, sync=sync), reps=5)
            for _ in range(3))
        print(f"  step floor ({sops.CLUSTER}-block clusters), {sync}: "
              f"{ms:.4f} ms, {ms * 1e3 / s:.3f} us a step, last h "
              f"{'= S' if good else 'WRONG'} [{card}]")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
