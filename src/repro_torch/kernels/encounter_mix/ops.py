"""Wrappers of the ``encounter_mix`` kernels: checks, dispatch, launch counts.

``encounter_mix(pos, area, active, weights, radius=...)`` returns
``(mix [M, D], mass [M])``: each row the mean of the weights of the peers
it met (same area, within ``radius``, both active, not itself), zero where
it met none, in ``weights``' dtype; ``mass`` the number of peers, float32.
On a CUDA tensor it launches the hand-written kernels
(``csrc/encounter_mix.cu``) or raises; on a CPU tensor it takes the plain
version (``ref.encounter_mix_reference``), which is what the CPU tests run.
``encounter_mix.launches`` counts calls that launched: each makes two CUDA
launches, the pairs (the meet masks, into int32 scratch allocated here)
and the sums over them.

``encounter_mix_lanes(pos [S, M, 2], area [S, M], active [S, M],
weights [S, M, D])`` is the lane-batched mix of a seed sweep: ``(mix
[S, M, D], mass [S, M])`` from one call of the same two kernels for all S
lanes (the lane is ``gridDim.y``; scratch words ``[S, M, ceil(M / 32)]``),
lane s the bits of ``encounter_mix`` on lane s's inputs; on a CPU tensor
``ref.encounter_mix_lanes_reference``. It adds one to
``encounter_mix.launches`` a call; ``encounter_mix`` on a CUDA tensor is
its one-lane call. ``encounter_mix_op`` is
``encounter_mix`` registered as the custom op ``repro_torch::encounter_mix``,
whose ``torch.func.vmap`` rule calls ``encounter_mix_lanes``; gossip's mix
calls it.

``encounter_block_hop(pos_r, area_r, act_r, row0, pos_v, area_v, act_v,
col0, weights_v, radius)`` is one hop of the ring (``baselines.gossip:
ring_encounter_mix``): local rows against a visiting block, global ids
``row0 + i`` and ``col0 + j``, returning the unnormalized ``(acc [R, D],
mass [R])`` of ``ref.encounter_block``, float32 only. ``backend="auto"``
launches the hop kernels (pairs, then sums, two CUDA launches: the lane
entry with one lane) on a CUDA tensor and takes
``encounter_block`` on a CPU tensor; ``"ref"`` is ``encounter_block``
everywhere. ``encounter_block_hop.launches`` counts its calls that
launched.

``encounter_block_hop_lanes`` is the hop with a leading lane axis on every
tensor (a seed sweep over the ranks; every lane shares ``row0`` and
``col0``): ``(acc [S, R, D], mass [S, R])`` from one call of the same two
kernels for all S lanes (``encounter_hop_lanes_f32``, the lane as
``gridDim.y``, scratch words ``[S, R, ceil(V / 32)]``), lane s the bits of
its one-lane call on lane s's inputs; on a CPU tensor or under
``backend="ref"`` ``ref.encounter_block_lanes_reference``. It adds one to
``encounter_block_hop.launches`` a call. ``encounter_hop_op`` is
``encounter_block_hop`` registered as the custom op
``repro_torch::encounter_hop``, whose ``torch.func.vmap`` rule calls
``encounter_block_hop_lanes``; the ring (``baselines.gossip``) calls it.

``encounter_pairs(...)`` (the hop's arguments without weights) is the
pairs kernel alone: ``(words [R, ceil(V / 32)] int32, mass [R] f32)``,
bit ``b`` of ``words[i, w]`` set where row ``i`` meets visiting mule ``32 w
+ b``; on a CPU tensor ``ref.encounter_pairs_reference``.
``encounter_pairs.launches`` counts its launches.

``DENSE_PAIRS_PER_ROW`` sets where the sums kernel switches a strip (a
warp's rows x 32 visiting mules) from gathering the met rows to a dense
register-tiled loop: at that many met pairs per row of the strip. Both
modes give the same bits; 0 makes every strip dense and 33 none. It is the
hand pick; the committed tuning cache (``launch.autotune``:
``tuned_encounter_launch`` for the mix, ``tuned_hop_launch`` for a hop)
may name another switch and the sums kernel's shape (``"small"``: 4 warps
of 16 rows, or ``"big"``: 16 warps of 8; by hand the small one for at most
64 rows) for the nearest tuned shape. ``DENSE_MIN`` and ``SUMS_SHAPE``
force either over the cache. Neither choice changes the bits.

On ``meta`` tensors the wrappers return empty results of the right shapes
and launch nothing. Under a ``launch.cost_analysis`` count each call is
priced by ``launch.roofline.encounter_mix_work`` /
``encounter_hop_work`` at the pairs that met, read from its masses.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.encounter_mix.ref import (
    encounter_block, encounter_block_lanes_reference,
    encounter_mix_lanes_reference, encounter_mix_reference,
    encounter_pairs_reference, n_words)
from repro_torch.kernels.mule_agg.ops import MAX_LANES, lanes_first
from repro_torch.launch import autotune
from repro_torch.launch.cost_analysis import met_pairs, priced
from repro_torch.launch.roofline import (encounter_hop_work,
                                         encounter_mix_work)

# The sums kernel's switch from sparse to dense strips, in met pairs per
# row of a 32-mule strip: a gathered pair costs a 512-byte shared-memory
# read per warp, about four times a dense (row, mule) step's FMAs, so dense
# pays from a quarter full. tools/ab_encounter_mix.py sweeps it (PERF.md).
DENSE_PAIRS_PER_ROW = 8
# forced launch choices over the tuned cache's (None: the cache, else the
# hand pick): the dense switch, and the sums kernel's shape
DENSE_MIN = None
SUMS_SHAPE = None
_SHAPE_CODE = {None: 0, "small": 1, "big": 2}   # encounter_mix.cu kShape*

# pos, area, active, W, out, mass, words, S, M, D, r2, dense_min, shape,
# stream
_LANES_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
_LANES_ENTRY = {torch.float32: "encounter_mix_lanes_f32",
                torch.bfloat16: "encounter_mix_lanes_bf16"}
# pos_r, area_r, act_r, R, row0, pos_v, area_v, act_v, V, col0
_SIDES = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong]
          + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong])
# ..., W_v, acc, mass, words, S, D, r2, dense_min, shape, stream
_HOP_ARGTYPES = _SIDES + [ctypes.c_void_p] * 4 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p]
# ..., r2, words, mass, stream
_PAIRS_ARGTYPES = _SIDES + [ctypes.c_float] + [ctypes.c_void_p] * 3


def launch_choice(rows: int, d: int, hop: bool) -> Tuple[int, int]:
    """(shape code, dense_min) of a call on ``rows`` rows and D columns:
    forced, else tuned, else the hand pick (code 0: by the rows)."""
    shape, dense = (autotune.tuned_hop_launch(rows, d) if hop
                    else autotune.tuned_encounter_launch(rows, d))
    shape = SUMS_SHAPE if SUMS_SHAPE is not None else shape
    dense = DENSE_MIN if DENSE_MIN is not None else dense
    return (_SHAPE_CODE[shape],
            DENSE_PAIRS_PER_ROW if dense is None else dense)


def _entry(name: str, argtypes):
    fn = getattr(_build.load("encounter_mix"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _side(area: torch.Tensor, act: Optional[torch.Tensor]):
    """One side's area as int64 and activity as bool, contiguous, as the
    kernels read them; activity stays None (a null pointer: all active)."""
    return (area.to(torch.int64).contiguous(),
            None if act is None else act.contiguous())


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(pos: torch.Tensor, area: torch.Tensor,
           active: Optional[torch.Tensor], weights: torch.Tensor,
           lanes: bool = False) -> None:
    """``lanes``: every argument has a leading lane axis of one size."""
    lead = "S, " if lanes else ""
    if weights.dim() != 2 + lanes:
        raise ValueError(f"encounter_mix wants weights [{lead}M, D], got "
                         f"{tuple(weights.shape)}")
    m = weights.shape[-2]
    ls = tuple(weights.shape[:1]) if lanes else ()
    if tuple(pos.shape) != ls + (m, 2):
        raise ValueError(f"encounter_mix wants pos [{lead}M, 2] with "
                         f"{ls + (m,)}, got {tuple(pos.shape)}")
    if tuple(area.shape) != ls + (m,):
        raise ValueError(f"encounter_mix wants area [{lead}M] with "
                         f"{ls + (m,)}, got {tuple(area.shape)}")
    if active is not None and tuple(active.shape) != ls + (m,):
        raise ValueError(f"encounter_mix wants active [{lead}M] with "
                         f"{ls + (m,)}, got {tuple(active.shape)}")
    if pos.dtype != torch.float32:
        raise TypeError(f"encounter_mix: pos must be float32, got {pos.dtype}")
    if area.dtype.is_floating_point or area.dtype.is_complex \
            or area.dtype == torch.bool:
        raise TypeError(f"encounter_mix: area must be integer, got "
                        f"{area.dtype}")
    if active is not None and active.dtype != torch.bool:
        raise TypeError(f"encounter_mix: active must be bool, got "
                        f"{active.dtype}")
    if weights.dtype not in _LANES_ENTRY:
        raise TypeError(f"encounter_mix: weights must be float32 or bfloat16, "
                        f"got {weights.dtype}")
    others = [pos, area] + ([] if active is None else [active])
    if any(t.device != weights.device for t in others):
        raise ValueError(f"encounter_mix: inputs on "
                         f"{sorted({str(t.device) for t in others})}, "
                         f"weights on {weights.device}")


def encounter_mix(pos: torch.Tensor, area: torch.Tensor,
                  active: Optional[torch.Tensor], weights: torch.Tensor, *,
                  radius: float = 0.15) -> Tuple[torch.Tensor, torch.Tensor]:
    """pos [M, 2] f32, area [M] int, active [M] bool (None == all active),
    weights [M, D] f32|bf16 -> (mix [M, D] in weights' dtype, mass [M] f32).

    On a CUDA tensor: ``encounter_mix_lanes`` of one lane (the single-call
    kernels)."""
    _check(pos, area, active, weights)
    if weights.device.type == "cpu":
        def plain():
            mix, mass = encounter_mix_reference(pos, area, active, weights,
                                                radius=radius)
            return mix.to(weights.dtype), mass
        return priced("encounter_mix", plain, lambda out: encounter_mix_work(
            *weights.shape, met_pairs(out[1]), weights.element_size()))
    mix, mass = encounter_mix_lanes(
        pos[None], area[None], None if active is None else active[None],
        weights[None], radius=radius)
    return mix[0], mass[0]


encounter_mix.launches = 0


def encounter_mix_lanes(pos: torch.Tensor, area: torch.Tensor,
                        active: Optional[torch.Tensor],
                        weights: torch.Tensor, *, radius: float = 0.15
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pos [S, M, 2] f32, area [S, M] int, active [S, M] bool (None == all
    active), weights [S, M, D] f32|bf16 -> (mix [S, M, D] in weights'
    dtype, mass [S, M] f32): lane s is ``encounter_mix`` on lane s's
    inputs, all S lanes in one call."""
    _check(pos, area, active, weights, lanes=True)
    s, m, d = weights.shape
    return priced("encounter_mix",
                  lambda: _mix_lanes(pos, area, active, weights, radius),
                  lambda out: encounter_mix_work(
                      m, d, met_pairs(out[1]), weights.element_size(), s))


def _mix_lanes(pos, area, active, weights, radius):
    if weights.device.type == "cpu":
        mix, mass = encounter_mix_lanes_reference(pos, area, active, weights,
                                                  radius=radius)
        return mix.to(weights.dtype), mass
    if weights.device.type == "meta":
        return (torch.empty_like(weights),
                weights.new_empty(weights.shape[:2], dtype=torch.float32))
    if weights.device.type != "cuda":
        raise ValueError(f"encounter_mix runs on cuda or cpu, not "
                         f"{weights.device}")
    if not weights.is_contiguous():
        raise ValueError("encounter_mix: weights must be contiguous")
    s, m, d = weights.shape
    if s > MAX_LANES:
        raise ValueError(f"encounter_mix_lanes: S={s} lanes exceed the "
                         f"grid's bound of {MAX_LANES}")
    pos = pos.contiguous()                      # [S, M, 2]: small
    dev = weights.device
    out = torch.empty((s, m, d), dtype=weights.dtype, device=dev)
    mass = torch.empty((s, m), dtype=torch.float32, device=dev)
    if s == 0 or m == 0:
        return out, mass
    area64, on = _side(area, active)
    words = torch.empty((s, m, n_words(m)), dtype=torch.int32, device=dev)
    fn = _entry(_LANES_ENTRY[weights.dtype], _LANES_ARGTYPES)
    shape, dense_min = launch_choice(m, d, hop=False)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pos.data_ptr(), area64.data_ptr(), _ptr(on),
                 weights.data_ptr(), out.data_ptr(), mass.data_ptr(),
                 words.data_ptr(), s, m, d, ctypes.c_float(radius ** 2),
                 dense_min, shape, stream)
    if err != 0:
        raise RuntimeError(f"encounter_mix_lanes kernel launch failed: CUDA "
                           f"error {err} (S={s}, M={m}, D={d}, "
                           f"{weights.dtype})")
    encounter_mix.launches += 1
    return out, mass


@torch.library.custom_op("repro_torch::encounter_mix", mutates_args=())
def encounter_mix_op(pos: torch.Tensor, area: torch.Tensor,
                     active: Optional[torch.Tensor], weights: torch.Tensor,
                     radius: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``encounter_mix`` as a custom op, visible to ``torch.func.vmap``."""
    return encounter_mix(pos, area, active, weights, radius=radius)


@encounter_mix_op.register_fake
def _(pos, area, active, weights, radius):
    return (torch.empty_like(weights),
            weights.new_empty(weights.shape[:1], dtype=torch.float32))


@encounter_mix_op.register_vmap
def _(info, in_dims, pos, area, active, weights, radius):
    n = info.batch_size
    lanes = [None if x is None else lanes_first(x, d, n)
             for x, d in zip((pos, area, active, weights), in_dims[:4])]
    return encounter_mix_lanes(*lanes, radius=radius), (0, 0)


def _check_block(name: str, pos: torch.Tensor, area: torch.Tensor,
                 act: Optional[torch.Tensor], n: int, dev,
                 op: str = "encounter_block_hop") -> None:
    """One side of a hop or of the pairs: pos [n, 2] f32, area [n] int, act
    [n] bool, on ``dev``."""
    if tuple(pos.shape) != (n, 2) or tuple(area.shape) != (n,) or (
            act is not None and tuple(act.shape) != (n,)):
        raise ValueError(
            f"{op} wants pos_{name} [{n}, 2], area_{name} and "
            f"act_{name} [{n}], got {tuple(pos.shape)}, {tuple(area.shape)}, "
            f"{None if act is None else tuple(act.shape)}")
    if pos.dtype != torch.float32:
        raise TypeError(f"{op}: pos_{name} must be float32, "
                        f"got {pos.dtype}")
    if area.dtype.is_floating_point or area.dtype.is_complex \
            or area.dtype == torch.bool:
        raise TypeError(f"{op}: area_{name} must be integer, "
                        f"got {area.dtype}")
    if act is not None and act.dtype != torch.bool:
        raise TypeError(f"{op}: act_{name} must be bool, got "
                        f"{act.dtype}")
    if any(t.device != dev for t in (pos, area) + (() if act is None
                                                    else (act,))):
        raise ValueError(f"{op}: the {name} block's geometry "
                         f"is not on {dev}")


def _sides(pos_r, area_r, act_r, row0, pos_v, area_v, act_v, col0):
    """(args, keep): the kernels' first ten arguments (each side's pos,
    area as int64 and activity as bool or null, its size and global offset;
    with or without a leading lane axis) and the tensors they point to,
    which the caller holds until the launch."""
    args, keep = [], []
    for pos, area, act, start in ((pos_r, area_r, act_r, row0),
                                  (pos_v, area_v, act_v, col0)):
        pos = pos.contiguous()                  # [n, 2] or [S, n, 2]: small
        area64, on = _side(area, act)
        keep += [pos, area64, on]
        args += [pos.data_ptr(), area64.data_ptr(), _ptr(on), pos.shape[-2],
                 int(start)]
    return args, keep


def encounter_block_hop(pos_r: torch.Tensor, area_r: torch.Tensor,
                        act_r: Optional[torch.Tensor], row0: int,
                        pos_v: torch.Tensor, area_v: torch.Tensor,
                        act_v: Optional[torch.Tensor], col0: int,
                        weights_v: torch.Tensor, radius: float = 0.15, *,
                        backend: str = "auto"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local rows pos_r [R, 2] f32, area_r [R] int, act_r [R] bool (None ==
    all active) with global ids ``row0 + i``, against a visiting block
    (``*_v`` [V], global ids ``col0 + j``, weights_v [V, D] f32) ->
    (acc [R, D] f32, mass [R] f32), unnormalized."""
    if backend not in ("auto", "ref"):
        raise ValueError(f"unknown encounter_block_hop backend {backend!r}; "
                         "expected 'auto' or 'ref'")
    if weights_v.dim() != 2:
        raise ValueError(f"encounter_block_hop wants weights_v [V, D], got "
                         f"{tuple(weights_v.shape)}")
    if weights_v.dtype != torch.float32:
        raise TypeError(f"encounter_block_hop: weights_v must be float32, "
                        f"got {weights_v.dtype}")
    r = pos_r.shape[0]
    v, d = weights_v.shape
    dev = weights_v.device
    _check_block("r", pos_r, area_r, act_r, r, dev)
    _check_block("v", pos_v, area_v, act_v, v, dev)
    if backend == "ref":
        return encounter_block(pos_r, area_r, act_r, row0, pos_v, area_v,
                               act_v, col0, weights_v, radius)

    def run():
        if dev.type == "cpu":
            return encounter_block(pos_r, area_r, act_r, row0, pos_v, area_v,
                                   act_v, col0, weights_v, radius)
        return _hop_launch(pos_r, area_r, act_r, row0, pos_v, area_v, act_v,
                           col0, weights_v, radius)
    return priced("encounter_hop", run, lambda out: encounter_hop_work(
        r, v, d, met_pairs(out[1])))


encounter_block_hop.launches = 0


def encounter_block_hop_lanes(pos_r: torch.Tensor, area_r: torch.Tensor,
                              act_r: Optional[torch.Tensor], row0: int,
                              pos_v: torch.Tensor, area_v: torch.Tensor,
                              act_v: Optional[torch.Tensor], col0: int,
                              weights_v: torch.Tensor, radius: float = 0.15,
                              *, backend: str = "auto"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``encounter_block_hop`` of S lanes in one call: pos_r [S, R, 2],
    area_r / act_r [S, R], the visiting block's [S, V], weights_v [S, V, D]
    f32 -> (acc [S, R, D] f32, mass [S, R] f32); every lane shares ``row0``
    and ``col0``."""
    if backend not in ("auto", "ref"):
        raise ValueError(f"unknown encounter_block_hop backend {backend!r}; "
                         "expected 'auto' or 'ref'")
    if weights_v.dim() != 3:
        raise ValueError(f"encounter_block_hop_lanes wants weights_v "
                         f"[S, V, D], got {tuple(weights_v.shape)}")
    if weights_v.dtype != torch.float32:
        raise TypeError(f"encounter_block_hop_lanes: weights_v must be "
                        f"float32, got {weights_v.dtype}")
    s, v, d = weights_v.shape
    r = pos_r.shape[1] if pos_r.dim() == 3 else -1
    dev = weights_v.device
    for name, pos, area, act, n in (("r", pos_r, area_r, act_r, r),
                                    ("v", pos_v, area_v, act_v, v)):
        if pos.dim() != 3 or pos.shape[0] != s or area.shape[:1] != (s,) \
                or (act is not None and act.shape[:1] != (s,)):
            raise ValueError(f"encounter_block_hop_lanes wants {s} lanes of "
                             f"every {name} input, got pos "
                             f"{tuple(pos.shape)}, area {tuple(area.shape)}")
        if s:       # lane 0 stands for the others: same shapes and types
            _check_block(name, pos[0], area[0], None if act is None
                         else act[0], n, dev, "encounter_block_hop_lanes")
    if backend == "ref":
        return encounter_block_lanes_reference(pos_r, area_r, act_r, row0,
                                               pos_v, area_v, act_v, col0,
                                               weights_v, radius)

    def run():
        if dev.type == "cpu":
            return encounter_block_lanes_reference(
                pos_r, area_r, act_r, row0, pos_v, area_v, act_v, col0,
                weights_v, radius)
        return _hop_launch(pos_r, area_r, act_r, row0, pos_v, area_v, act_v,
                           col0, weights_v, radius)
    return priced("encounter_hop", run, lambda out: encounter_hop_work(
        r, v, d, met_pairs(out[1]), s))


def _hop_launch(pos_r, area_r, act_r, row0, pos_v, area_v, act_v, col0,
                weights_v, radius):
    """The hop kernels on checked inputs, with a leading lane axis S or
    without one (a single hop, S = 1) -> (acc [S, R, D], mass [S, R], or
    [R, D] and [R]); one launch for all lanes."""
    *lanes, v, d = weights_v.shape
    s, r = (lanes[0] if lanes else 1), pos_r.shape[-2]
    dev = weights_v.device
    if dev.type == "meta":
        return (weights_v.new_empty((*lanes, r, d)),
                weights_v.new_empty((*lanes, r)))
    if dev.type != "cuda":
        raise ValueError(f"encounter_block_hop runs on cuda or cpu, not "
                         f"{dev}")
    if s > MAX_LANES:
        raise ValueError(f"encounter_block_hop_lanes: S={s} lanes exceed "
                         f"the grid's bound of {MAX_LANES}")
    weights_v = weights_v.contiguous()
    acc = torch.empty((*lanes, r, d), dtype=torch.float32, device=dev)
    mass = torch.empty((*lanes, r), dtype=torch.float32, device=dev)
    if s == 0 or r == 0:
        return acc, mass
    words = torch.empty((*lanes, r, n_words(v)), dtype=torch.int32,
                        device=dev)
    args, _keep = _sides(pos_r, area_r, act_r, row0, pos_v, area_v, act_v,
                         col0)
    fn = _entry("encounter_hop_lanes_f32", _HOP_ARGTYPES)
    shape, dense_min = launch_choice(r, d, hop=True)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, weights_v.data_ptr(), acc.data_ptr(),
                 mass.data_ptr(), words.data_ptr(), s, d,
                 ctypes.c_float(radius ** 2), dense_min, shape, stream)
    if err != 0:
        raise RuntimeError(f"encounter_hop_lanes kernel launch failed: CUDA "
                           f"error {err} (S={s}, R={r}, V={v}, D={d})")
    encounter_block_hop.launches += 1
    return acc, mass


@torch.library.custom_op("repro_torch::encounter_hop", mutates_args=())
def encounter_hop_op(pos_r: torch.Tensor, area_r: torch.Tensor,
                     act_r: Optional[torch.Tensor], row0: int,
                     pos_v: torch.Tensor, area_v: torch.Tensor,
                     act_v: Optional[torch.Tensor], col0: int,
                     weights_v: torch.Tensor, radius: float, backend: str
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``encounter_block_hop`` as a custom op, visible to
    ``torch.func.vmap``."""
    return encounter_block_hop(pos_r, area_r, act_r, row0, pos_v, area_v,
                               act_v, col0, weights_v, radius,
                               backend=backend)


@encounter_hop_op.register_fake
def _(pos_r, area_r, act_r, row0, pos_v, area_v, act_v, col0, weights_v,
      radius, backend):
    return (weights_v.new_empty((pos_r.shape[0], weights_v.shape[1])),
            weights_v.new_empty((pos_r.shape[0],)))


@encounter_hop_op.register_vmap
def _(info, in_dims, pos_r, area_r, act_r, row0, pos_v, area_v, act_v, col0,
      weights_v, radius, backend):
    n = info.batch_size
    lanes = [None if x is None else lanes_first(x, d, n)
             for x, d in zip((pos_r, area_r, act_r, pos_v, area_v, act_v,
                              weights_v),
                             in_dims[:3] + in_dims[4:7] + in_dims[8:9])]
    return encounter_block_hop_lanes(*lanes[:3], row0, *lanes[3:6], col0,
                                     lanes[6], radius, backend=backend), (0, 0)


def encounter_pairs(pos_r: torch.Tensor, area_r: torch.Tensor,
                    act_r: Optional[torch.Tensor], row0: int,
                    pos_v: torch.Tensor, area_v: torch.Tensor,
                    act_v: Optional[torch.Tensor], col0: int,
                    radius: float = 0.15) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hop's geometry -> (words [R, ceil(V / 32)] int32, mass [R] f32):
    bit b of words[i, w] is e[i, 32 w + b]. The pairs kernel on a CUDA
    tensor, ``ref.encounter_pairs_reference`` on a CPU tensor."""
    r, v = pos_r.shape[0], pos_v.shape[0]
    dev = pos_r.device
    _check_block("r", pos_r, area_r, act_r, r, dev, "encounter_pairs")
    _check_block("v", pos_v, area_v, act_v, v, dev, "encounter_pairs")
    if dev.type == "cpu":
        return encounter_pairs_reference(pos_r, area_r, act_r, row0, pos_v,
                                         area_v, act_v, col0, radius)
    if dev.type != "cuda":
        raise ValueError(f"encounter_pairs runs on cuda or cpu, not {dev}")
    words = torch.empty((r, n_words(v)), dtype=torch.int32, device=dev)
    mass = torch.empty((r,), dtype=torch.float32, device=dev)
    if r == 0:
        return words, mass
    args, _keep = _sides(pos_r, area_r, act_r, row0, pos_v, area_v, act_v,
                         col0)
    fn = _entry("encounter_pairs", _PAIRS_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, ctypes.c_float(radius ** 2), words.data_ptr(),
                 mass.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"encounter_pairs kernel launch failed: CUDA "
                           f"error {err} (R={r}, V={v})")
    encounter_pairs.launches += 1
    return words, mass


encounter_pairs.launches = 0
