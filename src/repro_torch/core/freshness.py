"""The paper's model-freshness filter (Sec 3.1), exact ring buffer.

Each fixed device f keeps a history L of the *ages* of models it has
received (age = now - model's last update time) and a dynamic threshold

    T_{t+1} = (1 - alpha) T_t + alpha * ( median(L) + beta * MAD(L) )

where MAD is the median absolute deviation. An incoming model is accepted
iff its age <= T (devices in warmup accept everything). alpha=0.1 and
beta=1.0 are the reference's documented assumption. History is a fixed
ring buffer per device.

This is the single-host engine's exact ring. The reference pushes ages
with a sequential scan over mules; the port computes each delivery's rank
among the deliveries to its device in the same step, keeps only the last
``history`` of them and writes each to its own slot, which gives the
scan's slots exactly without a scatter onto duplicate indices (whose
order a GPU does not fix).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

INF = float(np.float32(1e30))   # empty-slot sentinel, exact in float32


@dataclasses.dataclass(frozen=True)
class FreshnessConfig:
    alpha: float = 0.1
    beta: float = 1.0
    history: int = 16         # ring buffer length K
    warmup: int = 4           # accept-all until this many receipts
    init_threshold: float = 1e6


def init_freshness(n_fixed: int, cfg: FreshnessConfig, device) -> dict:
    return {
        "ages": torch.full((n_fixed, cfg.history), INF, device=device),
        "count": torch.zeros((n_fixed,), dtype=torch.int32, device=device),
        "threshold": torch.full((n_fixed,), cfg.init_threshold,
                                dtype=torch.float32, device=device),
    }


def accept_mask(state, fixed_ids: torch.Tensor, ages: torch.Tensor,
                cfg: FreshnessConfig) -> torch.Tensor:
    """fixed_ids: [M] target device per mule (-1 = none); ages: [M]."""
    fid = fixed_ids.clamp(min=0)
    thr = state["threshold"][fid]
    warm = state["count"][fid] < cfg.warmup
    return (fixed_ids >= 0) & (warm | (ages <= thr))


def _masked_median(vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median over valid entries of each row (midpoint for even counts)."""
    filled = torch.where(valid, vals, INF)
    srt = torch.sort(filled, dim=-1).values
    n = valid.sum(-1)                                     # [F]
    lo = (n - 1).clamp(min=0) // 2
    hi = n.clamp(min=1) // 2
    vlo = srt.gather(-1, lo[:, None])[:, 0]
    vhi = srt.gather(-1, hi[:, None])[:, 0]
    return 0.5 * (vlo + vhi)


def push_and_update(state, fixed_ids: torch.Tensor, ages: torch.Tensor,
                    deliver: torch.Tensor, cfg: FreshnessConfig) -> dict:
    """Push delivered ages into per-device rings, then update thresholds.

    fixed_ids/ages/deliver: [M] per-mule target, age, delivering-this-step.
    Mule m's push to device f lands in slot ``(count[f] + rank_m) % K``,
    where ``rank_m`` counts the deliveries to f by mules before m — the
    slot the reference's sequential scan gives it. Of the pushes to one
    device only the last K survive the scan, and those hit distinct slots.
    """
    n_fixed, k = state["ages"].shape
    n_m = fixed_ids.shape[0]
    dev = fixed_ids.device
    d = deliver & (fixed_ids >= 0)
    f = fixed_ids.clamp(min=0).long()
    onehot = ((f[:, None] == torch.arange(n_fixed, device=dev)[None, :])
              & d[:, None]).long()                                 # [M, F]
    n_f = onehot.sum(0)                                            # [F]
    rank = (onehot.cumsum(0) - onehot).gather(1, f[:, None])[:, 0]  # [M]
    keep = d & (rank >= n_f[f] - k)
    slot = (state["count"].long()[f] + rank) % k
    # every write has a cell of its own: kept pushes their ring slot, the
    # rest a scratch cell per mule past the end of the rings
    idx = torch.where(keep, f * k + slot,
                      n_fixed * k + torch.arange(n_m, device=dev))
    cells = torch.cat([state["ages"].reshape(-1),
                       state["ages"].new_empty(n_m)])
    cells = cells.index_put((idx,), ages.float())
    ages_buf = cells[:n_fixed * k].reshape(n_fixed, k)
    count = state["count"] + n_f.to(torch.int32)

    valid = ages_buf < INF
    med = _masked_median(ages_buf, valid)
    mad = _masked_median(torch.abs(ages_buf - med[:, None]), valid)
    target = med + cfg.beta * mad
    new_thr = torch.where(
        valid.any(-1),
        (1 - cfg.alpha) * state["threshold"] + cfg.alpha * target,
        state["threshold"])
    return {"ages": ages_buf, "count": count, "threshold": new_thr}
