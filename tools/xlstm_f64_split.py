#!/usr/bin/env python3
"""Does ``slstm_scan`` err to one side against the exact scan?

    python3 tools/xlstm_f64_split.py

On one NVIDIA GPU, at xlstm-350m's sLSTM shape (B 2, H 4, P 256) and S in
512, 1024, 2048 and 4096, for three seeds each, with pre and r drawn at
the layer's scales (std 0.64 and 0.02, as ``chip_smoke.py``'s kernel
phase): the kernel's h and the plain version's h (``slstm_reference`` in
float32 on the card) each minus the float64 scan of the same inputs
(``slstm_reference`` on float64, the oracle). For each case it prints the
mean signed error of both over every output and over the last eighth of
the steps, their RMS and largest errors, and the share of positive
errors; then the verdict:

- **one-sided**: the kernel's mean signed error has one sign in every case
  and exceeds the plain version's in size in most of them (a fault of the
  kernel's rounding, to keep open);
- **chance**: otherwise (the model-level check's ratio of the two runs'
  distances is then the luck of the draw, and the check needs a redesign).

Every line carries the card's name and power limit. It exits non-zero
without a GPU.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LENGTHS = (512, 1024, 2048, 4096)
SEEDS = (0, 1, 2)
B = 2
PRE_STD, R_STD = 0.64, 0.02


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("xlstm_f64_split.py needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels.slstm_fused import slstm_reference, slstm_scan
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].strip()
    cfg = get_config("xlstm-350m")
    h, p = cfg.n_heads, cfg.d_model // cfg.n_heads
    print(f"card: {card}; sLSTM shape B {B}, H {h}, P {p}; pre std "
          f"{PRE_STD}, r std {R_STD}")
    rows = []
    for s in LENGTHS:
        for seed in SEEDS:
            g = torch.Generator(device="cuda")
            g.manual_seed(1000 * s + seed)
            pre = PRE_STD * torch.randn(B, s, 4, h, p, device="cuda",
                                        generator=g)
            r = R_STD * torch.randn(4, h, p, p, device="cuda", generator=g)
            exact = slstm_reference(pre.double(), r.double())[0]
            row = {"s": s, "seed": seed}
            for name, got in (("kernel", slstm_scan(pre, r)),
                              ("plain", slstm_reference(pre, r)[0])):
                err = got.double() - exact
                tail = err[:, -(s // 8):]
                row[name] = {
                    "mean": err.mean().item(), "tail_mean": tail.mean().item(),
                    "rms": err.pow(2).mean().sqrt().item(),
                    "max": err.abs().max().item(),
                    "positive": (err > 0).double().mean().item()}
            rows.append(row)
            k, pl = row["kernel"], row["plain"]
            print(f"S {s} seed {seed}: mean signed error kernel "
                  f"{k['mean']:+.3e} plain {pl['mean']:+.3e}; last eighth "
                  f"{k['tail_mean']:+.3e} / {pl['tail_mean']:+.3e}; RMS "
                  f"{k['rms']:.3e} / {pl['rms']:.3e}; max {k['max']:.3e} / "
                  f"{pl['max']:.3e}; positive {k['positive']:.4f} / "
                  f"{pl['positive']:.4f} [{card}]")
            del pre, r, exact
            torch.cuda.empty_cache()
    signs = {row["kernel"]["mean"] > 0 for row in rows}
    larger = sum(abs(row["kernel"]["mean"]) > abs(row["plain"]["mean"])
                 for row in rows)
    one_sided = len(signs) == 1 and larger > len(rows) // 2
    sign = "one sign" if len(signs) == 1 else "both signs"
    print(f"the kernel's mean signed error: {sign} "
          f"over {len(rows)} cases, larger than the plain version's in "
          f"{larger}; RMS ratio kernel / plain "
          f"{min(x['kernel']['rms'] / x['plain']['rms'] for x in rows):.3f}"
          f"–{max(x['kernel']['rms'] / x['plain']['rms'] for x in rows):.3f}"
          f"; verdict: {'one-sided' if one_sided else 'chance'} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
