"""Render dry-run rows as markdown tables.

Port of ``repro.launch.report``: ``roofline_table`` and ``skip_table`` have
the reference's columns, so rows of the two packages render alike, and
``status_table`` is the port's counterpart of the reference's
``compile_proof_table``: a count on ``meta`` has no lowering or
compilation, so its last column is the count's seconds.

    PYTHONPATH=src python -m repro_torch.launch.report --single dryrun.json
"""
from __future__ import annotations

import argparse
import json


def _fmt_s(x):
    if x is None:
        return "-"
    if x >= 1.0:
        return f"{x:.2f}s"
    return f"{x*1e3:.1f}ms"


def roofline_table(rows):
    out = ["| arch | shape | dominant | t_compute | t_memory | t_collective | "
           "mem/chip | useful FLOPs |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("status") != "ok":
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | **{r['dominant']}** | "
            f"{_fmt_s(r['t_compute_s'])} | {_fmt_s(r['t_memory_s'])} | "
            f"{_fmt_s(r['t_collective_s'])} | "
            f"{r['peak_memory_gb']:.1f}GB | {r['useful_flops_ratio']:.2f} |")
    return "\n".join(out)


def skip_table(rows):
    out = ["| arch | shape | mesh | reason |", "|---|---|---|---|"]
    for r in rows:
        if r.get("status") == "skip":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"{r['reason']} |")
    return "\n".join(out)


def status_table(rows):
    out = ["| arch | shape | mesh | status | fits one card | count |",
           "|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("status") == "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
                       f"{'yes' if r.get('fits_one_card') else 'no'} | "
                       f"{r.get('t_count_s', '-')}s |")
        elif r.get("status") == "FAIL":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"**FAIL** {r.get('error', '')} | - | - |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--single", required=True,
                    help="rows written by launch.dryrun --out")
    ap.add_argument("--mode", default="roofline",
                    choices=["roofline", "skips", "status"])
    args = ap.parse_args(argv)
    with open(args.single) as f:
        rows = json.load(f)
    print({"roofline": roofline_table, "skips": skip_table,
           "status": status_table}[args.mode](rows))


if __name__ == "__main__":
    main()
