"""Builds every kernel source twice, with and without ``-split-compile=0``,
and compares the two libraries' SASS; times each build.

    python3 tools/split_compile_check.py

Run it where ``nvcc`` is (the card's machine). ``kernels/_build.py`` passes
``-split-compile=0`` only for the sources in ``EXTRA_FLAGS``; this prints,
for every source, whether the flag leaves its SASS (``cuobjdump -sass``,
less the lines that name the file) the same, and each build's seconds, the
two builds of a source one after the other and the sources in turn. Exits
1 if a source in ``EXTRA_FLAGS`` compiles to other SASS with the flag.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

SPLIT = "-split-compile=0"


def _sass(tool: str, lib: Path) -> list:
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return [line for line in text.splitlines()
            if "Fatbin" not in line and "code for" not in line
            and ".so" not in line]


def main() -> int:
    nvcc = _build.nvcc_path()
    tool = shutil.which("cuobjdump") or str(Path(nvcc).parent / "cuobjdump")
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout.strip()
    print(f"{version.splitlines()[-1]}; {len(os.sched_getaffinity(0))} "
          f"cores")
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for name, src in _build.SOURCES.items():
            sass, secs = {}, {}
            for tag, extra in (("without", ()), ("with", (SPLIT,))):
                lib = Path(tmp) / f"{name}-{tag}.so"
                t0 = time.perf_counter()
                subprocess.run([nvcc, *_build.NVCC_FLAGS, *extra, "-o",
                                str(lib), str(_build._PKG / src)],
                               check=True, capture_output=True)
                secs[tag] = time.perf_counter() - t0
                sass[tag] = _sass(tool, lib)
            same = sass["without"] == sass["with"]
            used = SPLIT in _build.EXTRA_FLAGS.get(name, ())
            print(f"{name}: build {secs['without']:.1f} s without {SPLIT}, "
                  f"{secs['with']:.1f} s with it; SASS "
                  f"{'the same' if same else 'DIFFERENT'} "
                  f"({len(sass['without'])} lines); the flag is "
                  f"{'passed' if used else 'not passed'} in _build.py")
            ok = ok and (same or not used)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
