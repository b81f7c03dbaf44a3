"""Count the FLOPs, bytes and collective bytes of a step as it runs.

The counterpart of ``repro.launch.hlo_analysis``, which reads the compiled
HLO text of a jitted step. Eager PyTorch has no HLO, so the port counts the
step while it runs, op by op, in a ``TorchDispatchMode``:

    with CostCounter() as cc:
        step(...)
    cc.flops, cc.flops_by, cc.bytes, cc.coll, cc.coll_bytes,
    cc.peak_live_bytes, cc.breakdown(top=15)

- **FLOPs**: matmuls, batched matmuls and convolutions, forward and
  backward, by the formulas of ``torch.utils.flop_counter`` (and matrix-
  vector and dot products, which its table lacks; a convolution's backward
  by our own formula, since the table's ignores ``groups``), kept by kind
  (``"mm:bf16"``, ``"conv:f32"``) so that ``roofline.compute_seconds``
  prices each at its own peak; a hand kernel's FMAs are ``"fma:f32"``.
- **Bytes**: each op's operand and result bytes (an expanded operand counts
  the memory it spans). View and metadata ops, and allocations that write
  nothing, are skipped, as the reference skips ``parameter``, ``tuple``
  and ``bitcast``. Eager PyTorch does not fuse, so these bytes are each
  op's own round trip through memory, not XLA's after fusion: they are
  not held to the reference's.
- **Collective bytes**, by the reference's kinds: ``repro_torch::
  ordered_psum`` (an all-reduce of its operand), ``repro_torch::ring_shift``
  (a collective-permute), ``repro_torch::ring_need`` (the all-reduce of
  the ring's area table), ``repro_torch::all_to_all`` and
  ``repro_torch::all_gather`` (``launch.collectives``: the MoE's
  all-to-all pair and its gather), ``repro_torch::gather_seq`` and
  ``scatter_sum_seq`` (context parallelism's K/V gather, an all-gather,
  and its backward, a reduce-scatter), ``gather_fsdp`` and
  ``scatter_sum_fsdp`` (an FSDP weight's gather and its gradient's
  reduce-scatter), and the raw ``torch.distributed`` ops
  the mode sees (``c10d``), each by its operand bytes.
- **Peak live bytes**, tracked by storage: every storage the step's ops
  create, and every one they read (or ``hold`` names), is live from then
  until it is freed. On the ``meta`` device this is the peak a run would
  need, without touching a card.

Each hand-written kernel is one op priced by its formula in
``launch.roofline`` wherever its wrapper is reached, on any device, and the
count does not descend into its plain version. The three custom ops
(``repro_torch::mule_agg``, ``encounter_mix``, ``encounter_hop``) are seen
by the mode itself; the wrappers (``mule_agg_lanes``,
``encounter_mix_lanes``, ``encounter_block_hop_lanes`` under ``vmap``,
and the autograd Functions of ``flash_attention``, ``ssd_scan`` and
``slstm_scan``, which a dispatch mode never sees) report their calls
through ``priced``. ``encounter_mix``'s work depends on the data: the count
reads the met pairs from the call's masses, which waits for the device, but
only under a count; on ``meta`` it raises.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import conv_flop_count, flop_registry

from repro_torch.launch import roofline
from repro_torch.launch.dtypes import dtype_bytes, dtype_name

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")

# ops that move no bytes: aliases of their input, metadata, allocations
# that write nothing
_NO_BYTES = {"detach", "alias", "lift_fresh", "_unsafe_view", "view",
             "empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "resize_", "set_", "record_stream",
             "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
             "is_same_size", "_reshape_alias"}
_CONV = {"convolution", "_convolution", "convolution_backward",
         "cudnn_convolution", "_slow_conv2d_forward",
         "convolution_overrideable"}
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
         "broadcast_": "broadcast", "send": "collective-permute",
         "recv_": "collective-permute"}

# the counts running now, innermost last (the wrappers find theirs here)
_ACTIVE: List["CostCounter"] = []


def _mv_flop(a, b, *args, out_val=None, **kwargs) -> int:
    return 2 * a.shape[0] * a.shape[1]


def _addmv_flop(x, a, b, *args, out_val=None, **kwargs) -> int:
    return 2 * a.shape[0] * a.shape[1]


def _dot_flop(a, b, *args, out_val=None, **kwargs) -> int:
    return 2 * a.shape[0]


def _conv_backward_flop(grad_out, x, w, bias_sizes, stride, padding,
                        dilation, transposed, output_padding, groups,
                        output_mask, out_val=None, **kwargs) -> int:
    """The forward's FLOPs once for each gradient asked for. The table's
    formula takes the weight gradient as a convolution of x by grad_out,
    which ignores ``groups``: a vmapped model's convolution (its lanes as
    groups) would count ``groups`` times its work."""
    fwd = conv_flop_count(list(x.shape), list(w.shape), list(grad_out.shape),
                          transposed)
    return fwd * (int(output_mask[0]) + int(output_mask[1]))


_EXTRA_FLOPS = {torch.ops.aten.mv: _mv_flop, torch.ops.aten.addmv: _addmv_flop,
                torch.ops.aten.dot: _dot_flop, torch.ops.aten.vdot: _dot_flop}
# formulas of ours that take the table's place
_OWN_FLOPS = {torch.ops.aten.convolution_backward: _conv_backward_flop}


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes ``t`` spans in memory: its elements, or fewer where a
    stride is 0 (an expanded operand)."""
    n = t.numel()
    if n == 0:
        return 0
    width = dtype_bytes(t.dtype)
    if t.layout != torch.strided:
        return n * width
    span = 1 + sum((s - 1) * abs(st) for s, st in zip(t.shape, t.stride())
                   if s > 1)
    return min(n, span) * width


def _storage(t: torch.Tensor):
    """``t``'s storage, through functorch's wrappers."""
    from torch._C._functorch import get_unwrapped, is_functorch_wrapped_tensor
    while is_functorch_wrapped_tensor(t):
        t = get_unwrapped(t)
    return t.untyped_storage()


def counting() -> bool:
    """True while a count runs and is not inside a priced kernel."""
    return bool(_ACTIVE) and _ACTIVE[-1]._paused == 0


def priced(name: str, run: Callable[[], Any],
           work_of: Callable[[Any], roofline.Work]) -> Any:
    """``run()`` as one call of the hand kernel ``name``, priced at
    ``work_of(its result)`` by the running count; the ops inside are not
    counted (their storages are still tracked). Without a count, just
    ``run()``."""
    if not counting():
        return run()
    counter = _ACTIVE[-1]
    counter._paused += 1
    try:
        out = run()
        work = work_of(out)         # reading the met pairs is not the step's
    finally:
        counter._paused -= 1
    counter.add_kernel(name, work)
    return out


def replayed(key, run: Callable[[], tuple]) -> tuple:
    """``run()`` (a pure function of tensors on ``meta`` returning a tuple
    of them) once per ``key`` under a running count made with
    ``replay=True``: a later call with the same key adds what the first
    added (FLOPs, bytes, collectives, kernels, ops, and the peak above the
    bytes live at the call) and returns empty tensors of the first
    result's shapes, without running. The same ops on the same shapes
    count the same, so the FLOPs, bytes and collectives are unchanged; a
    layer's plain flash backward (tens of thousands of ops on shapes) then
    runs once a count, not once a layer. The peak is the first run's
    above the live bytes, and what that run left live (a differentiable
    backward's saved temporaries) lives as long as the results: within a
    few hundred KB of the run's own at smoke size, not exact. Otherwise
    just ``run()``."""
    if not counting() or not _ACTIVE[-1].replay:
        return run()
    return _ACTIVE[-1]._replay(key, run)


def met_pairs(mass: torch.Tensor) -> int:
    """The met pairs of an encounter call, read from its masses; raises on
    ``meta``, where the data the work depends on does not exist."""
    if mass.device.type == "meta":
        raise ValueError("encounter_mix's work depends on the met pairs, "
                         "which a meta tensor does not hold: count it on "
                         "cpu or cuda")
    return int(mass.sum().item())


class CostCounter(TorchDispatchMode):
    """A count of the ops run while it is entered (module docstring)."""

    def __init__(self, replay: bool = False):
        super().__init__()
        self.replay = replay        # ``replayed`` calls run once a key
        self.flops_by: Dict[str, float] = {}
        self.bytes = 0.0
        self.coll: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.kernels: Dict[str, int] = {}
        self.by_op: Dict[str, List[float]] = {}   # name: [calls, FLOPs, B]
        self.peak_live_bytes = 0
        self._live: Dict[int, int] = {}
        self._live_total = 0
        self._paused = 0
        self._replays: Dict[Any, tuple] = {}

    # -- results --------------------------------------------------------------
    @property
    def flops(self) -> float:
        return float(sum(self.flops_by.values()))

    @property
    def coll_bytes(self) -> float:
        return float(sum(self.coll.values()))

    def breakdown(self, top: int = 15) -> str:
        """The ``top`` ops by their roofline time (FLOPs at the fp32 peak
        plus bytes at the HBM rate), one line each, then the totals."""
        def cost(item):
            _, (_, fl, by) = item
            return fl / roofline.FP32_FLOP_PER_S + by / roofline.HBM_BYTES_PER_S
        rows = sorted(self.by_op.items(), key=cost, reverse=True)[:top]
        out = [f"{int(n):7d} x {name:42s} {fl:.3e} FLOP {by:.3e} B"
               for name, (n, fl, by) in rows]
        out.append(f"TOTAL {self.flops:.4e} FLOP {self.bytes:.4e} B "
                   f"coll {self.coll_bytes:.4e} B peak "
                   f"{self.peak_live_bytes / 2**30:.3f} GiB")
        return "\n".join(out)

    # -- bookkeeping ----------------------------------------------------------
    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)

    def hold(self, *trees) -> None:
        """Count every tensor of ``trees`` live from now (a step's
        parameters, optimizer state and batch)."""
        for t in _tensors(trees):
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        if t.layout != torch.strided:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        self._live[key] = st.nbytes()
        self._live_total += self._live[key]
        self.peak_live_bytes = max(self.peak_live_bytes, self._live_total)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._live_total -= self._live.pop(key, 0)

    def _record(self, name: str, flops: float, kind: Optional[str],
                n_bytes: float) -> None:
        if flops:
            self.flops_by[kind] = self.flops_by.get(kind, 0.0) + flops
        self.bytes += n_bytes
        rec = self.by_op.setdefault(name, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += n_bytes

    def add_kernel(self, name: str, work: roofline.Work) -> None:
        """One call of a hand kernel, at its formula's work."""
        self.kernels[name] = self.kernels.get(name, 0) + 1
        self._record(name, work.n_flop, work.kind, work.n_bytes)

    def _state(self) -> tuple:
        return (dict(self.flops_by), self.bytes, dict(self.coll),
                dict(self.kernels),
                {k: list(v) for k, v in self.by_op.items()})

    def _replay(self, key, run: Callable[[], tuple]) -> tuple:
        """``replayed``'s work (its docstring)."""
        rec = self._replays.get(key)
        if rec is None:
            before, base, peak = self._state(), self._live_total, \
                self.peak_live_bytes
            self.peak_live_bytes = base
            try:
                out = run()
            finally:
                excess = self.peak_live_bytes - base
                self.peak_live_bytes = max(peak, self.peak_live_bytes)
            after = self._state()
            # what the run leaves live beside its results (a graph's saved
            # temporaries, under a differentiable backward)
            kept = self._live_total - base - sum(
                self._live.get(id(_storage(t)), 0) for t in out)
            delta = tuple({k: v - b.get(k, 0) for k, v in a.items()}
                          for a, b in ((after[0], before[0]),
                                       (after[2], before[2]),
                                       (after[3], before[3])))
            ops = {k: [x - y for x, y in zip(v, before[4].get(k, [0] * 3))]
                   for k, v in after[4].items()}
            self._replays[key] = (delta, after[1] - before[1], ops, excess,
                                  kept, [(t.shape, t.dtype) for t in out])
            return out
        (flops, coll, kernels), n_bytes, ops, excess, kept, outs = rec
        for mine, add in ((self.flops_by, flops), (self.coll, coll),
                          (self.kernels, kernels)):
            for k, v in add.items():
                if v:
                    mine[k] = mine.get(k, 0) + v
        self.bytes += n_bytes
        for k, v in ops.items():
            if any(v):
                rec_op = self.by_op.setdefault(k, [0, 0.0, 0.0])
                for i in range(3):
                    rec_op[i] += v[i]
        self.peak_live_bytes = max(self.peak_live_bytes,
                                   self._live_total + excess)
        # made through the mode, which tracks them (unwrapped); the bytes
        # the first run left live beside them stay live as long as they do
        out = tuple(torch.empty(shape, dtype=dtype, device="meta")
                    for shape, dtype in outs)
        if kept > 0:
            ballast = torch.empty(kept, dtype=torch.uint8, device="meta")
            for t in out:
                t._replay_kept = ballast
        return out

    # -- the mode -------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ns = func.namespace
        if ns == "repro_torch" and func.__name__.split(".")[0] in (
                "mule_agg", "encounter_mix", "encounter_hop"):
            self._paused += 1
            try:
                out = func(*args, **kwargs)
                work = (_custom_kernel_work(func, args, out)
                        if self._paused == 1 else None)
            finally:
                self._paused -= 1
            if work is not None:
                self.add_kernel(*work)
            for t in _tensors(out):
                self._track(t)
            return out
        out = func(*args, **kwargs)
        for t in _tensors((args, kwargs)) + _tensors(out):
            self._track(t)
        if self._paused:
            return out
        name = func.__name__.split(".")[0]
        packet = func._overloadpacket
        in_bytes = sum(tensor_bytes(t) for t in _tensors((args, kwargs)))
        out_bytes = sum(tensor_bytes(t) for t in _tensors(out))
        coll = _collective_kind(ns, name)
        if coll is not None:
            moved = (8 * args[2] * args[3] if name == "ring_need"
                     else in_bytes)
            self.coll[coll] += moved
            self._record(f"{ns}::{name}", 0, None, in_bytes + out_bytes)
            return out
        if func.is_view or name in _NO_BYTES:
            return out
        flops, kind = 0, None
        flop_fn = (_OWN_FLOPS.get(packet) or flop_registry.get(packet)
                   or _EXTRA_FLOPS.get(packet))
        if flop_fn is not None:
            flops = flop_fn(*args, **kwargs, out_val=out)
            first = _tensors(args)[0]
            kind = ("conv:" if name in _CONV else "mm:") + dtype_name(
                first.dtype)
        self._record(f"{ns}::{name}", flops, kind, in_bytes + out_bytes)
        return out


def _collective_kind(ns: str, name: str) -> Optional[str]:
    if ns == "repro_torch":
        return {"ordered_psum": "all-reduce", "ring_need": "all-reduce",
                "ring_shift": "collective-permute",
                "all_to_all": "all-to-all",
                "all_gather": "all-gather", "gather_seq": "all-gather",
                "scatter_sum_seq": "reduce-scatter",
                "gather_fsdp": "all-gather",
                "scatter_sum_fsdp": "reduce-scatter"}.get(name)
    if ns == "c10d":
        return _C10D.get(name)
    return None


def _custom_kernel_work(func, args, out):
    """(name, Work) of one of the three kernel custom ops."""
    name = func.__name__.split(".")[0]
    if name == "mule_agg":
        assign, weights = args[:2]
        f, m = assign.shape
        return name, roofline.mule_agg_work(f, m, weights.shape[1],
                                            weights.element_size())
    mass = out[1]
    if name == "encounter_mix":
        weights = args[3]
        m, d = weights.shape
        return name, roofline.encounter_mix_work(
            m, d, met_pairs(mass), weights.element_size())
    pos_r, weights_v = args[0], args[8]
    v, d = weights_v.shape
    return name, roofline.encounter_hop_work(pos_r.shape[0], v, d,
                                             met_pairs(mass))
