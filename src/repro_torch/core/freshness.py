"""The paper's model-freshness filter (Sec 3.1), exact ring buffer.

Each fixed device f keeps a history L of the *ages* of models it has
received (age = now - model's last update time) and a dynamic threshold

    T_{t+1} = (1 - alpha) T_t + alpha * ( median(L) + beta * MAD(L) )

where MAD is the median absolute deviation. An incoming model is accepted
iff its age <= T (devices in warmup accept everything). alpha=0.1 and
beta=1.0 are the reference's documented assumption. History is a fixed
ring buffer per device.

Two statistics back the threshold:

- the exact ring buffer (``init_freshness`` / ``push_and_update``), the
  single-host engine's. The reference pushes ages with a sequential scan
  over mules; the port computes each delivery's rank among the deliveries
  to its device in the same step, keeps only the last ``history`` of them
  and writes each to its own slot, which gives the scan's slots exactly
  without a scatter onto duplicate indices (whose order a GPU does not
  fix).
- a histogram sketch (``init_freshness_sketch`` /
  ``sketch_push_and_update``), the distributed engine's: ages fall into
  ``sketch_bins`` fixed bins per device, so the contributions of ranks are
  plain sums that merge in the engine's one collective a step, and median
  and MAD are weighted quantiles of the merged histogram, exact to within
  one bin width. The ring's last-K window becomes a cap of K on the
  resident mass (old receipts decay geometrically instead of leaving slot
  by slot). ``FreshnessConfig.stat`` picks the sketch (``"median"``) or the
  older per-step mean/std EMA (``"meanstd"``) for that engine.
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
    # the distributed engine's statistic: "median" (the histogram sketch,
    # the paper's median/MAD) or "meanstd" (a per-step mean/std EMA, which
    # keeps no receipt counts and so ignores ``warmup``); the single-host
    # engine always uses the exact ring
    stat: str = "median"
    sketch_bins: int = 64          # histogram resolution B
    sketch_max_age: float = 512.0  # ages past it fall into the last bin


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
    # [F, M], so that the running count scans the contiguous mule axis (a
    # cumsum down the rows of [M, F] walks 8 columns of a million rows on
    # the card)
    onehot = ((f[None, :] == torch.arange(n_fixed, device=dev)[:, None])
              & d[None, :]).long()                                 # [F, M]
    n_f = onehot.sum(1)                                            # [F]
    rank = (onehot.cumsum(1) - onehot).gather(0, f[None, :])[0]    # [M]
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


# ---------------------------------------------------------------------------
# the histogram sketch (distributed engine)
# ---------------------------------------------------------------------------


def sketch_edges(cfg: FreshnessConfig, device="cpu") -> torch.Tensor:
    """Bin edges [B+1], uniform over [0, sketch_max_age]: float32
    ``start (1 - s) + stop s`` at ``s = i / B``, then ``stop``, which is
    the reference's ``jnp.linspace`` bit for bit."""
    b = cfg.sketch_bins
    stop = torch.tensor(cfg.sketch_max_age, dtype=torch.float32)
    start = torch.tensor(0.0, dtype=torch.float32)
    step = torch.arange(b, dtype=torch.float32) / torch.tensor(
        float(b), dtype=torch.float32)
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop[None]]).to(device)


def sketch_centers(cfg: FreshnessConfig, device="cpu") -> torch.Tensor:
    e = sketch_edges(cfg, device)
    return 0.5 * (e[:-1] + e[1:])


def age_bin_onehot(ages: torch.Tensor, cfg: FreshnessConfig) -> torch.Tensor:
    """One-hot bin of each age: [...] -> [..., B] float32. Ages below 0 or
    past ``sketch_max_age`` fall into the edge bins, so no mass is lost."""
    b = cfg.sketch_bins
    # a tensor divisor: a CUDA division by a host scalar multiplies by its
    # reciprocal, which can move an age across a bin edge
    width = torch.tensor(cfg.sketch_max_age / b, dtype=torch.float32,
                         device=ages.device)
    idx = torch.floor(ages / width).to(torch.int32).clamp(0, b - 1)
    return torch.nn.functional.one_hot(idx.long(), b).float()


def age_histogram(ages: torch.Tensor, weights: torch.Tensor,
                  cfg: FreshnessConfig) -> torch.Tensor:
    """Weighted histogram over the trailing axis: [..., N] -> [..., B]."""
    onehot = age_bin_onehot(ages, cfg)                          # [..., N, B]
    return torch.sum(onehot * weights[..., None].float(), dim=-2)


def hist_quantile(hist: torch.Tensor, edges: torch.Tensor,
                  q: float) -> torch.Tensor:
    """Interpolated weighted quantile per row: hist [..., B] -> [...]."""
    c = torch.cumsum(hist, dim=-1)
    total = c[..., -1:]
    t = q * total
    # the first bin whose cumulative mass reaches t (argmax of a 0/1 row
    # is its first 1)
    idx = torch.argmax((c >= t).to(torch.uint8), dim=-1)
    cprev = torch.where(
        idx > 0, c.gather(-1, (idx - 1).clamp(min=0)[..., None])[..., 0],
        torch.zeros((), dtype=c.dtype, device=c.device))
    mass = hist.gather(-1, idx[..., None])[..., 0]
    frac = torch.clamp((t[..., 0] - cprev) / torch.clamp(mass, min=1e-12),
                       0.0, 1.0)
    width = edges[1] - edges[0]
    return edges[idx] + frac * width


def sketch_median_mad(hist: torch.Tensor, cfg: FreshnessConfig):
    """(median, MAD) of the binned ages: hist [..., B] -> ([...], [...]).

    MAD is the weighted median of |bin centre - median|: the bins sorted by
    that distance (a stable sort, as the reference's: centres lie
    symmetric about the median, so ties are the rule), then the first to
    reach half the mass.
    """
    edges = sketch_edges(cfg, hist.device)
    med = hist_quantile(hist, edges, 0.5)
    d = torch.abs(sketch_centers(cfg, hist.device) - med[..., None])
    order = torch.argsort(d, dim=-1, stable=True)
    ds = d.gather(-1, order)
    ws = hist.gather(-1, order)
    cw = torch.cumsum(ws, dim=-1)
    total = cw[..., -1:]
    idx = torch.argmax((cw >= 0.5 * total).to(torch.uint8), dim=-1)
    mad = ds.gather(-1, idx[..., None])[..., 0]
    return med, mad


def init_freshness_sketch(n_fixed: int, cfg: FreshnessConfig,
                          device) -> dict:
    return {
        "hist": torch.zeros((n_fixed, cfg.sketch_bins), dtype=torch.float32,
                            device=device),
        "count": torch.zeros((n_fixed,), dtype=torch.int32, device=device),
        "threshold": torch.full((n_fixed,), cfg.init_threshold,
                                dtype=torch.float32, device=device),
    }


def sketch_push_and_update(state, step_hist: torch.Tensor,
                           step_counts: torch.Tensor,
                           cfg: FreshnessConfig) -> dict:
    """Fold one step's merged histogram [F, B] and receipt counts [F] (the
    sums over every rank) into the sketch, then update the thresholds. It
    runs on replicated state, so every rank computes the same sketch."""
    hist = state["hist"] + step_hist
    count = state["count"] + step_counts.to(torch.int32)
    total = torch.sum(hist, dim=-1)
    # cap the resident mass at the ring depth K: the last-K window
    scale = torch.where(total > cfg.history,
                        cfg.history / torch.clamp(total, min=1e-12),
                        torch.ones((), dtype=total.dtype,
                                   device=total.device))
    hist = hist * scale[:, None]
    med, mad = sketch_median_mad(hist, cfg)
    target = med + cfg.beta * mad
    new_thr = torch.where(
        torch.sum(hist, dim=-1) > 0,
        (1 - cfg.alpha) * state["threshold"] + cfg.alpha * target,
        state["threshold"])
    return {"hist": hist, "count": count, "threshold": new_thr}
