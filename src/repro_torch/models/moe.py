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

On a mesh of ranks (``launch.mesh.make_lm_mesh``) ``apply_moe`` takes the
reference's two ``shard_map`` paths, line for line, each rank running the
body that ``shard_map`` runs on one device: ``x`` is the rank's block of
the batch (cut over ``dp_axes`` where the batch divides, whole otherwise:
``launch.sharding.batch_specs``, the reference's ``b_shard``), and the
output is the rank's block.

- data-parallel (``ep_axis=None``): experts replicated, routing and a
  capacity per data shard, the aux loss averaged over ``dp_axes``;
- expert-parallel: the rank holds ``E / ep`` experts (``launch.sharding.
  rank_specs``); each of the ``ep`` peers takes ``t_ep = t_loc // ep`` of
  the block's tokens, routes them with a capacity of its own, and an
  ``all_to_all`` pair moves the groups ``[E, C, d] -> [E/ep, ep C, d]``
  to the experts' owners and back; an ``all_gather`` over the peers
  rebuilds the tokens.

The collectives are ``launch.collectives``'s, whose backwards count each
token once: the router and the input enter as ``replicated`` over the
expert axis (each peer's gradient is partial, summed in rank order), the
gathered output gives each peer its own block of the cotangent, and the
aux loss is averaged over the expert axis by gathering (``mean_of_peers``)
and over the data axes by ``pmean``. Transfers go through host memory.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

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


def apply_moe(params, x: torch.Tensor, cfg: ModelConfig, *, mesh: Any = None,
              dp_axes: Tuple = ("data",), ep_axis: Optional[str] = "model"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D] in x's dtype, aux_loss f32 scalar).

    On a ``mesh``, ``x`` and ``out`` are this rank's block of the batch and
    ``params`` its block of the weights (module docstring); ``ep_axis=None``
    takes the data-parallel path, with every expert on every rank."""
    b, s, d = x.shape
    compute_dtype = compute_dtype_of(cfg)
    e, k = cfg.n_experts, cfg.top_k

    if mesh is not None and ep_axis is None:
        from repro_torch.launch import collectives as coll
        t_loc = b * s
        capacity = capacity_of(t_loc, cfg)
        xt = x.reshape(t_loc, d).to(compute_dtype)
        grouped, dest, st, sw, aux = _route_and_group(
            xt, params["router"], cfg, capacity)
        out_g = _expert_ffn(grouped, params["wi_gate"].to(compute_dtype),
                            params["wi_up"].to(compute_dtype),
                            params["wo"].to(compute_dtype), cfg.act)
        out = _ungroup(out_g, dest, st, sw, t_loc, d)
        return (out.reshape(b, s, d).to(x.dtype),
                coll.pmean(aux, mesh, dp_axes))

    if mesh is None:
        t = b * s
        xt = x.reshape(t, d).to(compute_dtype)
        grouped, dest, st, sw, aux = _route_and_group(
            xt, params["router"], cfg, capacity_of(t, cfg))
        out_g = _expert_ffn(grouped, params["wi_gate"].to(compute_dtype),
                            params["wi_up"].to(compute_dtype),
                            params["wo"].to(compute_dtype), cfg.act)
        out = _ungroup(out_g, dest, st, sw, t, d)
        return out.reshape(b, s, d).to(x.dtype), aux

    # ---- expert-parallel path ---------------------------------------------
    from repro_torch.launch import collectives as coll
    ep = mesh.shape[ep_axis]
    assert e % ep == 0, (e, ep)
    el = e // ep
    if params["wi_gate"].shape[0] != el:
        raise ValueError(f"the expert-parallel path takes this rank's "
                         f"{el} of {e} experts (launch.sharding.rank_specs); "
                         f"got {params['wi_gate'].shape[0]}")
    # activations arrive replicated over the expert axis; each peer takes
    # a distinct 1/ep slice of the block's tokens
    t_loc = b * s
    if t_loc >= ep and t_loc % ep:
        raise ValueError(f"{t_loc} tokens a rank do not split evenly over "
                         f"{ep} expert-parallel peers")
    t_ep = max(t_loc // ep, 1)
    capacity = capacity_of(t_ep, cfg)
    xt = coll.replicated(x.reshape(t_loc, d).to(compute_dtype), mesh,
                         ep_axis)
    idx = mesh.axis_index(ep_axis)
    if t_loc >= ep:
        xt = xt.narrow(0, idx * t_ep, t_ep)
    router = coll.replicated(params["router"], mesh, ep_axis)
    grouped, dest, st, sw, aux = _route_and_group(xt, router, cfg, capacity)
    # [E, C, d] -> [E/ep, ep*C, d]: the groups to their experts' owners
    g4 = coll.all_to_all(grouped.reshape(ep, el, capacity, d), mesh,
                         ep_axis)                     # [peer, E/ep, C, d]
    g4 = g4.movedim(0, 1)                             # [E/ep, peer, C, d]
    out_g = _expert_ffn(g4.reshape(el, ep * capacity, d),
                        params["wi_gate"].to(compute_dtype),
                        params["wi_up"].to(compute_dtype),
                        params["wo"].to(compute_dtype), cfg.act)
    o4 = out_g.reshape(el, ep, capacity, d).movedim(1, 0)
    o4 = coll.all_to_all(o4.contiguous(), mesh,
                         ep_axis)                     # [owner, E/ep, C, d]
    out = _ungroup(o4.reshape(e, capacity, d), dest, st, sw, xt.shape[0], d)
    if t_loc >= ep:
        out = coll.all_gather(out, mesh, ep_axis)
        out = out[: b * s]
    aux = coll.pmean(coll.mean_of_peers(aux, mesh, ep_axis), mesh, dp_axes)
    return out.reshape(b, s, d).to(x.dtype), aux
