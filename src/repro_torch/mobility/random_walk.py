"""Random-walk mobility with crossing probability P_cross (paper Sec 4.1).

Geometry: ``n_areas`` isolated unit squares. Each area holds four spaces —
the corner cells of side ``space_size`` — and an empty central corridor (the
paper's Fig. 4 layout). One fixed device sits in each space.

Dynamics per step (vectorized over mules):
- gaussian step proposal, reflected at the area walls;
- if the proposal exits the mule's current space, it is accepted with
  probability ``p_cross`` and otherwise reflected back into the space;
- areas are fully isolated.

``space_of`` maps positions to space ids 0..3 or -1 (corridor). Global fixed
device id = area * 4 + space.

torch cannot reproduce JAX's threefry bits, so every random function is
split in two: a pure function of its draws (``init_mobility(cfg, sid, u)``,
``mobility_step(state, cfg, step_noise, u_cross)``,
``simulate_trajectories(cfg, draws)``) and a sampler that draws them from
an explicit ``torch.Generator`` (``sample_walk_draws``). Fed the reference's
draws, the pure functions give its arrays bitwise. Every scalar constant is
rounded once to float32 before it meets a float32 tensor, as JAX rounds a
Python scalar.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MobilityConfig:
    n_mules: int = 20
    n_areas: int = 2
    p_cross: float = 0.1
    step_sigma: float = 0.08
    space_size: float = 0.42     # corner cell side; corridor is the rest
    exchange_steps: int = 3      # time steps to complete one model transfer


@dataclasses.dataclass(frozen=True)
class WalkDraws:
    """The random numbers of one trajectory: ``sid`` [M] int in 0..3 and
    ``u`` [M, 2] uniform in [0, 1) place the mules; per step, ``step_noise``
    [T, M, 2] standard normal and ``u_cross`` [T, M] uniform in [0, 1)."""
    sid: torch.Tensor
    u: torch.Tensor
    step_noise: torch.Tensor
    u_cross: torch.Tensor


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=F32, device=like.device)


def space_of(pos: torch.Tensor, space_size: float) -> torch.Tensor:
    """pos: [..., 2] in [0,1]^2 -> space id 0..3 or -1 (corridor), int32."""
    x, y = pos[..., 0], pos[..., 1]
    lo = _f32(space_size, pos)
    hi = _f32(1.0 - space_size, pos)
    in_left, in_right = x < lo, x > hi
    in_bot, in_top = y < lo, y > hi
    sid = torch.full(x.shape, -1, dtype=torch.int32, device=pos.device)
    sid = torch.where(in_right & in_top, 3, sid)
    sid = torch.where(in_left & in_top, 2, sid)
    sid = torch.where(in_right & in_bot, 1, sid)
    return torch.where(in_left & in_bot, 0, sid).to(torch.int32)


def _space_bounds(sid: torch.Tensor, space_size: float):
    """Bounding box (lo, hi) per axis for a space id (when sid >= 0)."""
    right = (sid == 1) | (sid == 3)
    top = sid >= 2
    zero, one = _f32(0.0, sid), _f32(1.0, sid)
    near, far = _f32(space_size, sid), _f32(1.0 - space_size, sid)
    lo_x = torch.where(right, far, zero)
    hi_x = torch.where(right, one, near)
    lo_y = torch.where(top, far, zero)
    hi_y = torch.where(top, one, near)
    return lo_x, hi_x, lo_y, hi_y


def init_mobility(cfg: MobilityConfig, sid: torch.Tensor,
                  u: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Mules start uniformly inside the spaces ``sid`` of their (fixed,
    balanced) area; ``u`` [M, 2] in [0, 1) places them in the space."""
    m = cfg.n_mules
    dev = u.device
    area = torch.arange(m, dtype=torch.int32, device=dev) % cfg.n_areas
    u = u * _f32(cfg.space_size, u)
    lo_x, _, lo_y, _ = _space_bounds(sid, cfg.space_size)
    pos = torch.stack([lo_x + u[:, 0], lo_y + u[:, 1]], dim=-1)
    return {
        "pos": pos,                                          # [M, 2]
        "area": area,                                        # [M]
        "dwell": torch.zeros((m,), dtype=torch.int32, device=dev),
    }


def mobility_step(state: Dict[str, torch.Tensor], cfg: MobilityConfig,
                  step_noise: torch.Tensor, u_cross: torch.Tensor
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One time step from its draws. Returns (new_state, info dict)."""
    pos = state["pos"]
    cur_sid = space_of(pos, cfg.space_size)

    prop = pos + _f32(cfg.step_sigma, pos) * step_noise
    prop = prop.clamp(0.0, 1.0)                              # area walls
    prop_sid = space_of(prop, cfg.space_size)

    exits = (cur_sid >= 0) & (prop_sid != cur_sid)
    allow = u_cross < _f32(cfg.p_cross, u_cross)
    # reflected-back position: clamp into current space bounds (eps keeps the
    # point strictly inside — space membership uses strict inequalities)
    eps = _f32(1e-4, pos)
    lo_x, hi_x, lo_y, hi_y = _space_bounds(cur_sid, cfg.space_size)
    clamped = torch.stack(
        [torch.minimum(torch.maximum(prop[:, 0], lo_x + eps * (lo_x > 0)),
                       hi_x - eps * (hi_x < 1)),
         torch.minimum(torch.maximum(prop[:, 1], lo_y + eps * (lo_y > 0)),
                       hi_y - eps * (hi_y < 1))], dim=-1)
    new_pos = torch.where((exits & ~allow)[:, None], clamped, prop)
    new_sid = space_of(new_pos, cfg.space_size)

    same = (new_sid == cur_sid) & (new_sid >= 0)
    dwell = torch.where(same, state["dwell"] + 1,
                        (new_sid >= 0).to(torch.int32)).to(torch.int32)

    # an exchange completes every `exchange_steps` consecutive steps in a space
    exchange = (dwell > 0) & (dwell % cfg.exchange_steps == 0)
    fixed_id = torch.where(new_sid >= 0, state["area"] * 4 + new_sid, -1)

    new_state = {"pos": new_pos, "area": state["area"], "dwell": dwell}
    info = {"space": new_sid, "fixed_id": fixed_id.to(torch.int32),
            "exchange": exchange, "pos": new_pos}
    return new_state, info


def sample_walk_draws(cfg: MobilityConfig, n_steps: int,
                      generator: torch.Generator) -> WalkDraws:
    """Every draw of an ``n_steps`` trajectory, from ``generator`` on its
    device."""
    m, dev = cfg.n_mules, generator.device
    return WalkDraws(
        sid=torch.randint(0, 4, (m,), generator=generator, device=dev),
        u=torch.rand((m, 2), generator=generator, device=dev),
        step_noise=torch.randn((n_steps, m, 2), generator=generator,
                               device=dev),
        u_cross=torch.rand((n_steps, m), generator=generator, device=dev))


def simulate_trajectories(cfg: MobilityConfig, draws: WalkDraws
                          ) -> Dict[str, torch.Tensor]:
    """Unrolled trajectory: dict of [T, M] tensors (``pos`` [T, M, 2])."""
    state = init_mobility(cfg, draws.sid, draws.u)
    infos = []
    for noise, u_cross in zip(draws.step_noise, draws.u_cross):
        state, info = mobility_step(state, cfg, noise, u_cross)
        infos.append(info)
    return {k: torch.stack([i[k] for i in infos]) for k in infos[0]}
