"""Mixture-of-experts FFN with top-k routing: sort-based dispatch with a
global capacity.

Port of ``repro.models.moe``'s single-device path (``mesh=None``): the
router in float32, softmax, top-k renormalised with a 1e-9 floor, the
Switch load-balance aux loss, a stable sort of the flat expert ids, a
capacity per expert (slots past it are dropped to the sentinel row
``E * C``), the experts as three batched products in the compute dtype,
and the gate-weighted sum back to tokens in float32.

The reference has no Pallas kernel here: its einsums are plain batched
products, and so are the port's (``torch.bmm``). Two parts differ in form,
not in value:

- the dispatch writes the grouped tokens out of place into a fresh buffer
  (``index_put``) whose sentinel row, where every dropped slot lands, is
  cut off; an in-place copy into a shared buffer would not compose with
  ``torch.func.vmap`` and autograd;
- the un-group sums each token's k slots along a ``[T, k, d]`` axis in a
  fixed order (the sorted order, i.e. by expert id) instead of the
  reference's ``.at[st].add``, whose direct port (``index_add_``) adds with
  atomics on CUDA, so two replays of a prefill would not be bitwise equal.
  The two orders differ by float32 rounding only.

Not ported: the data-parallel ``shard_map`` (experts replicated, routing per
data shard) and the expert-parallel ``shard_map`` with its ``all_to_all``
pair. One card has no mesh, so ``apply_moe`` takes no ``mesh`` argument.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models.attention import compute_dtype_of
from repro_torch.models.layers import activation, dense_init


def init_moe(gen: torch.Generator, cfg: ModelConfig):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": dense_init(gen, (d, e)),
        "wi_gate": dense_init(gen, (e, d, f)),
        "wi_up": dense_init(gen, (e, d, f)),
        "wo": dense_init(gen, (e, f, d)),
    }


def capacity_of(t: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``t`` tokens (Python's ``round``, ties to even,
    as in the reference)."""
    return int(max(1, round(t * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor)))


def _route(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """The router on xt [T, d]: (probs [T, E] f32, top_p [T, k]
    renormalised, top_e [T, k], aux)."""
    e, k = cfg.n_experts, cfg.top_k
    logits = xt.float() @ router.float()                       # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    experts = torch.arange(e, device=xt.device)
    density = (top_e[:, :1] == experts).float().mean(0)   # one-hot of top 1
    aux = e * torch.sum(density * probs.mean(0))
    return probs, top_p, top_e, aux


def _route_and_group(xt: torch.Tensor, router: torch.Tensor,
                     cfg: ModelConfig, capacity: int):
    """Routing and sort-based grouping. xt: [T, d].

    Returns (grouped [E, C, d], dest [T*k], st [T*k], sw [T*k], aux).
    ``dest == E * C`` marks dropped slots."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    _, top_p, top_e, aux = _route(xt, router, cfg)

    flat_e = top_e.reshape(-1)
    flat_t = torch.arange(t, device=xt.device).repeat_interleave(k)
    flat_w = top_p.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    grp_start = torch.searchsorted(se, torch.arange(e, device=xt.device),
                                   side="left")
    pos_in_e = torch.arange(t * k, device=xt.device) - grp_start[se]
    keep = pos_in_e < capacity
    dest = torch.where(keep, se * capacity + pos_in_e,
                       torch.full_like(se, e * capacity))

    xg = xt[st]
    buf = xt.new_zeros((e * capacity + 1, d)).index_put((dest,), xg)
    grouped = buf[: e * capacity].reshape(e, capacity, d)
    return grouped, dest, st, sw, aux


def _expert_ffn(grouped: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wo: torch.Tensor, act_name: str) -> torch.Tensor:
    """grouped [E, C, d] x per-expert weights [E, d, f] -> [E, C, d]."""
    act = activation(act_name)
    h = act(torch.bmm(grouped, wg)) * torch.bmm(grouped, wu)
    return torch.bmm(h, wo)


def _ungroup(out_g: torch.Tensor, dest: torch.Tensor, st: torch.Tensor,
             sw: torch.Tensor, t: int, d: int) -> torch.Tensor:
    """Expert outputs back to tokens, gate-weighted: [T, d] f32.

    Each token's k slots are summed along an axis in the sorted order (no
    atomics), dropped slots reading the zero sentinel row."""
    e_cap = out_g.shape[0] * out_g.shape[1]
    out_flat = torch.cat([out_g.reshape(e_cap, d),
                          out_g.new_zeros((1, d))], dim=0)
    by_token = torch.argsort(st, stable=True)        # [T*k], k per token
    per_slot = (out_flat[dest[by_token]]
                * sw[by_token, None].to(out_g.dtype)).float()
    return per_slot.reshape(t, -1, d).sum(1)


def apply_moe(params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D] in x's dtype, aux_loss f32 scalar)."""
    b, s, d = x.shape
    compute_dtype = compute_dtype_of(cfg)
    t = b * s
    xt = x.reshape(t, d).to(compute_dtype)
    grouped, dest, st, sw, aux = _route_and_group(
        xt, params["router"], cfg, capacity_of(t, cfg))
    out_g = _expert_ffn(grouped, params["wi_gate"].to(compute_dtype),
                        params["wi_up"].to(compute_dtype),
                        params["wo"].to(compute_dtype), cfg.act)
    out = _ungroup(out_g, dest, st, sw, t, d)
    return out.reshape(b, s, d).to(x.dtype), aux
