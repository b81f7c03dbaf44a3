"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default and raise when no card is
present: work moves to the CPU only when the caller asks for it. ``"meta"``
runs a step on shapes alone, for a count (``launch.cost_analysis``, the dry
run): nothing is computed and no card is touched.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"the port runs on cuda or cpu (meta for a "
                         f"count), not {dev}")
    return dev
