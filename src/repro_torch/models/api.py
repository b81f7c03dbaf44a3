"""Model API of the LM stack: ``Model`` with ``init / forward / loss /
init_cache / decode_step``.

Port of ``repro.models.api`` for the stage kinds ``attn`` (GQA attention +
gated MLP), ``moe`` (GQA attention + the mixture-of-experts FFN of
``models/moe.py``, whose load-balance aux loss ``forward`` sums over the
layers), ``mamba`` (the Mamba2/SSD mixer), ``shared_attn`` (zamba2's
attention block, one set of weights stored once as
``params["shared_attn"]`` and applied at every such stage, whose slot in
``params["stages"]`` is ``{}``) and ``xlstm_pair`` (an mLSTM block, then an
sLSTM block). A config is compiled into the
reference's stage program: consecutive layers of the same kind and
attention window form one stage whose parameters are stacked
``[count, ...]``, as in the reference, so weights carry across leaf for
leaf. The reference scans a stage with ``lax.scan``; the port walks it
with a Python loop (PyTorch runs eagerly).

The ``vlm`` family (qwen2-vl) runs through ``Model`` too: ``_embed`` puts
the batch's ``vision_embed`` [B, vision_tokens, D] in front of the token
embeddings, ``_positions`` gives M-RoPE's three streams [3, B, S] (all
equal), and ``loss`` drops the prefix's logits. The ``audio`` family
(Whisper) is ``models/whisper.py``'s ``WhisperModel``, which
``build_model`` returns for it. ``forward`` takes ``batch["positions"]``
where the caller passes them, as the reference does.
On a mesh of ranks (``mesh``, ``dp_axes``, ``moe_ep_axis``, the
reference's fields) every rank runs the model on its block of the batch
and its block of the weights (``launch.sharding.rank_specs``: the
reference's ``param_specs`` executed, every fallback held whole). Tensor
parallelism over ``"model"``: attention on the rank's heads, the MLP on
its ``d_ff`` block, the Mamba2 mixer on its SSM heads (or on its channels
as sub-heads where the heads do not divide)
(``models/attention.py``, ``layers.apply_mlp``, ``models/mamba2.py``), each
reading its split from its leaves' shapes, so a leaf held whole runs whole
with no collective; the vocabulary split over
``"model"`` where it divides: ``_embed`` looks up the rank's rows (ids
elsewhere read zero) and sums over the peers (one nonzero term, so exact),
``_unembed`` computes the rank's columns and ``all_gather``s them, so
``forward`` and ``decode_step`` return the whole logits on every rank and
``loss`` runs on them (each rank sends its B x S x V / tp f32 block and
receives the others'). Tied embeddings use the split ``embed`` for both.
The experts take ``models/moe.py``'s ``shard_map`` paths:
expert-parallel over ``moe_ep_axis``, or data-parallel where it is
``None``. Decode passes ``mesh`` and ``dp_axes`` but not ``moe_ep_axis``,
as the reference's ``_decode_layer`` does, so it takes the expert-parallel
path over ``"model"`` whatever ``moe_ep_axis`` says. The ``REPLICATED_ARCHS``
(xlstm, audio) hold every leaf whole and cut the batch over ``(data,
model)`` (``Model.batch_axes``, from ``batch_specs``), as does ``dp_axes``
holding ``"model"`` (``Model.replicate``, the population layout). The
decode cache a rank holds is ``cache_specs``' block of each KV cache (the
kv heads or ``head_dim`` over ``"model"``, the slots where the global
batch does not divide the data axes: ``launch.sharding.kv_cache_cut``),
and the SSM state of its SSM heads, sized from its blocks
(``Model.init_cache``: the blocks of ``rank_specs`` on ``meta``); the
population layout, whose rows differ between the peers of ``"model"``,
holds its caches whole. ``remat``
checkpoints each layer of ``forward`` (``models/remat.py``;
``remat_policy`` "full" or "dots").

Context parallelism (``seq_axis``, a mesh axis other than ``"model"``):
each rank runs the model on its block of ``S / n`` positions of every row
(``lm_ranks.rank_batch``), with ``_positions`` offset to the block, and
``forward`` returns the rank's [B, S / n, V] logits. Attention gathers K/V
over ``seq_axis`` (``models/attention.py``). A layer that is not
per-token gathers its input over ``seq_axis`` (``collectives.gather_seq``,
one a layer), runs on the whole sequence, as the reference's partitioner
computes the unsharded values there, and keeps the rank's block of the
output (``_whole``, ``_own``; the backward is ``scatter_sum_seq``'s: the
ordered sum of the peers' cotangents):

- a MoE layer routes the whole sequence, with its capacity and top-k
  order, as the reference's ``shard_map`` does (its ``P(b_shard)`` cuts
  the batch only; on the expert-parallel path each ``model`` peer then
  takes ``S / ep`` of the tokens);
- a ``mamba`` layer gathers its normed input and runs the Mamba2 mixer
  (the SSD scan) on the whole sequence, on its heads over ``"model"``;
- an ``xlstm_pair`` gathers x and runs the mLSTM, then the sLSTM scan, on
  the whole sequence. So every rank holds the same carried states: none
  passes between ranks, and the scans take no initial state.

Every other layer is per-token. The sequence cut is the whole embedded
one: for ``vlm``, ``vision_tokens`` + T positions, a rank's block holding
the vision rows below ``vision_tokens`` and the text after them
(``_embed`` puts its rows of ``vision_embed`` in front of its tokens).
Whisper (``models/whisper.py``) runs its decoder on the rank's block of
tokens and its encoder whole on every rank. The batch is not cut
along ``seq_axis``: ``dp_axes`` (the axes the batch is cut along under
``seq_axis``) must not hold it. ``loss``
is each rank's share of the mean over the whole sequence's B (T - 1)
targets (T the text tokens): its own sum over that count (rank r's last
position targets rank r + 1's first token, gathered; the last rank has one
target fewer, and a vision position predicts nothing), plus
0.01 times the MoE aux term over n (the whole sequence's, the same on every
rank, so the sum over ``seq_axis`` is the reference's 0.01 x aux);
``launch.steps`` sums the shares and
their gradients over ``seq_axis``. A share, not a mean per rank, because
the ranks' target counts differ and the sum of shares is the mean exactly.
Decode under ``seq_axis`` splits each KV cache's slots over it where they
divide (``init_cache``), as ``cache_specs`` does for a batch of one; the
Mamba2 and xLSTM states are whole on every rank, which updates them alike.

FSDP (``fsdp=True``, the reference's ``param_specs(fsdp=True)``): each
rank holds ``rank_specs(..., fsdp=True)``'s blocks, each leaf's largest
still-whole dimension cut over the data axes as well (``fsdp_dims``).
``forward`` gathers a layer's FSDP leaves (``collectives.gather_fsdp``, one
transfer a layer) just before the layer runs, inside the remat body, so a
recomputation
gathers again; ``embed``, ``head`` and ``final_norm`` are gathered once a
call, ``shared_attn`` at each stage that runs it, and ``decode_step``
gathers the same way. Each gathered leaf has its ``fsdp=False`` block's
shape exactly, so the layers read their tensor-parallel split as before,
and ``rank_blocks`` and the decode cache use the ``fsdp=False`` blocks.
The gather's backward sums the data ranks' cotangents in rank order and
keeps the rank's block, so ``launch.steps`` only divides an FSDP leaf's
gradient by the data axes' size. FSDP raises under ``replicate`` (every
leaf whole) and under ``seq_axis`` (no reference entry point combines
them).

``head_axis="model"`` (the reference's GSPMD hint that pads head counts
that do not divide the axis): a layer whose ``wq`` is held whole
(``n_heads`` does not divide ``"model"``) runs on the rank's padded block
of query heads (``models/attention.py``: ``attention.head_block``), its
whole weights' gradients summed over the peers; where the heads divide it
changes nothing, and without a mesh it is a no-op, as the reference's
constraint is. It raises for another axis and under a layout whose batch
takes ``"model"`` (``REPLICATED_ARCHS``, ``replicate``). Decode does not
take it, as the reference's does not. It composes with ``seq_axis`` and
``fsdp`` (an FSDP leaf is gathered to its ``fsdp=False`` block, whole,
before the head block is taken).

Not ported: ``unroll`` (the port's stages are Python loops already).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import InputShape, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.interop import tree_leaves, tree_map
from repro_torch.launch import collectives as coll
from repro_torch.launch.sharding import (REPLICATED_ARCHS, KVCut,
                                         batch_specs, data_axes, fsdp_dims,
                                         kv_cache_cut, rank_specs,
                                         shard_tree)
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2 as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import remat as remat_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.attention import compute_dtype_of
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_init,
                                       init_mlp, init_norm)


@dataclasses.dataclass(frozen=True)
class Stage:
    kind: str            # attn | moe | mamba | shared_attn | xlstm_pair
    count: int           # number of layers folded into this stage
    window: Optional[int] = None


# ---------------------------------------------------------------------------
# program construction
# ---------------------------------------------------------------------------


def build_program(cfg: ModelConfig) -> List[Stage]:
    if cfg.family == "xlstm":
        assert cfg.n_layers % 2 == 0, "xlstm program scans (mLSTM, sLSTM) pairs"
        return [Stage("xlstm_pair", cfg.n_layers // 2)]

    kinds: List[Tuple[str, Optional[int]]] = []
    for layer in range(cfg.n_layers):
        if cfg.family in ("ssm", "hybrid"):
            if cfg.attn_layer_interval and (layer + 1) % cfg.attn_layer_interval == 0:
                kinds.append(("shared_attn", None))
            else:
                kinds.append(("mamba", None))
        else:
            window = cfg.sliding_window
            if window is not None and cfg.global_layer_interval:
                if (layer + 1) % cfg.global_layer_interval == 0:
                    window = None  # global layer
            kind = "moe" if cfg.n_experts else "attn"
            kinds.append((kind, window))

    stages: List[Stage] = []
    for kind, window in kinds:
        if stages and stages[-1].kind == kind and stages[-1].window == window \
                and kind != "shared_attn":
            stages[-1] = Stage(kind, stages[-1].count + 1, window)
        else:
            stages.append(Stage(kind, 1, window))
    return stages


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------


def _init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str):
    dev = gen.device
    if kind == "mamba":
        return {"norm": init_norm(cfg.norm, cfg.d_model, device=dev),
                "mixer": mamba_lib.init_mamba2(gen, cfg)}
    if kind == "xlstm_pair":
        return {"mlstm": xlstm_lib.init_mlstm(gen, cfg),
                "slstm": xlstm_lib.init_slstm(gen, cfg)}
    p = {"norm1": init_norm(cfg.norm, cfg.d_model, device=dev),
         "attn": attn_lib.init_attention(gen, cfg),
         "norm2": init_norm(cfg.norm, cfg.d_model, device=dev)}
    if kind == "moe":
        p["moe"] = moe_lib.init_moe(gen, cfg)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff)
    return p


def _whole(x: torch.Tensor, mesh, seq_axis) -> torch.Tensor:
    """The whole sequence of x: its blocks gathered over ``seq_axis`` (one
    ``gather_seq``), or x itself without it."""
    return x if seq_axis is None else coll.gather_seq(x, mesh, seq_axis)


def _own(y: torch.Tensor, m: int, mesh, seq_axis) -> torch.Tensor:
    """This rank's block of ``m`` positions of the whole-sequence y (y
    itself without ``seq_axis``); the backward of ``_whole`` sums the
    peers' cotangents in rank order."""
    if seq_axis is None:
        return y
    return y.narrow(1, mesh.axis_index(seq_axis) * m, m)


def _apply_layer(params, x, positions, cfg: ModelConfig, kind: str,
                 window: Optional[int], backend: str, shared=None, mesh=None,
                 dp_axes=("data",), moe_ep_axis="model", seq_axis=None,
                 head_axis=None):
    """Full-sequence forward for one layer. Returns (x, aux_loss or None:
    only ``moe`` layers have one). Under ``seq_axis`` a layer that is not
    per-token (``mamba``, ``xlstm_pair``, ``moe``'s routing) runs on the
    whole sequence and keeps the rank's block (module docstring)."""
    m = x.shape[1]
    if kind == "mamba":
        h = _whole(apply_norm(params["norm"], x, cfg.norm, cfg.norm_eps),
                   mesh, seq_axis)
        return x + _own(mamba_lib.mamba2_forward(params["mixer"], h, cfg,
                                                 backend=backend, mesh=mesh),
                        m, mesh, seq_axis), None
    if kind == "xlstm_pair":
        y = xlstm_lib.mlstm_forward(params["mlstm"],
                                    _whole(x, mesh, seq_axis), cfg)
        y = xlstm_lib.slstm_forward(params["slstm"], y, cfg, backend=backend)
        return _own(y, m, mesh, seq_axis), None
    p = shared if kind == "shared_attn" else params
    h = apply_norm(p["norm1"], x, cfg.norm, cfg.norm_eps)
    x = x + attn_lib.attn_forward(p["attn"], h, positions, cfg,
                                  window=window, backend=backend,
                                  mesh=mesh, head_axis=head_axis,
                                  seq_axis=seq_axis)
    h = apply_norm(p["norm2"], x, cfg.norm, cfg.norm_eps)
    if kind == "moe":
        # the whole sequence routed, as the reference's shard_map (which
        # cuts the batch only) routes it
        out, aux = moe_lib.apply_moe(p["moe"], _whole(h, mesh, seq_axis),
                                     cfg, mesh=mesh, dp_axes=dp_axes,
                                     ep_axis=moe_ep_axis)
        return x + _own(out, m, mesh, seq_axis), aux
    return x + apply_mlp(p["mlp"], h, cfg.act, compute_dtype_of(cfg),
                         mesh=mesh, d_ff=cfg.d_ff), None


def _decode_layer(params, x, cache, pos: int, cfg: ModelConfig, kind: str,
                  window: Optional[int], shared=None, mesh=None,
                  dp_axes=("data",), cut: KVCut = KVCut()):
    """Single-token decode for one layer; updates ``cache`` in place
    (an attention layer's KV cache the rank's block under ``cut``)."""
    if kind == "mamba":
        h = apply_norm(params["norm"], x, cfg.norm, cfg.norm_eps)
        out, _ = mamba_lib.mamba2_decode(params["mixer"], h, cache, cfg,
                                         mesh=mesh)
        return x + out
    if kind == "xlstm_pair":
        x, _ = xlstm_lib.mlstm_decode(params["mlstm"], x, cache["mlstm"], cfg)
        x, _ = xlstm_lib.slstm_decode(params["slstm"], x, cache["slstm"], cfg)
        return x
    p = shared if kind == "shared_attn" else params
    h = apply_norm(p["norm1"], x, cfg.norm, cfg.norm_eps)
    out, _ = attn_lib.attn_decode(p["attn"], h, cache, pos, cfg,
                                  window=window, mesh=mesh, cut=cut)
    x = x + out
    h = apply_norm(p["norm2"], x, cfg.norm, cfg.norm_eps)
    if kind == "moe":       # the aux loss is dropped, as in the reference
        return x + moe_lib.apply_moe(p["moe"], h, cfg, mesh=mesh,
                                     dp_axes=dp_axes)[0]
    return x + apply_mlp(p["mlp"], h, cfg.act, compute_dtype_of(cfg),
                         mesh=mesh, d_ff=cfg.d_ff)


def _init_stage_cache(cfg: ModelConfig, stage: Stage, batch: int,
                      max_seq: int, dtype, device, block=None, mesh=None,
                      cut: KVCut = KVCut()):
    """One stage's decode cache; with ``block``, the rank's parameters of
    the stage (its layer's, or the shared attention's, on ``meta``), the
    SSM heads and channels they hold; a KV cache the rank's block under
    ``cut`` (``attention.rank_kv_heads``, ``init_kv_cache``)."""
    if stage.kind == "mamba":     # f32 whatever ``dtype``, as the reference
        c = mamba_lib.init_mamba2_cache(
            cfg, batch, device=device,
            params=None if block is None else block["mixer"])
    elif stage.kind == "xlstm_pair":     # f32 too
        c = {"mlstm": xlstm_lib.init_mlstm_cache(cfg, batch, device=device),
             "slstm": xlstm_lib.init_slstm_cache(cfg, batch, device=device)}
    else:
        kv, hd = (None, None) if block is None else \
            attn_lib.rank_kv_heads(block["attn"], cfg, mesh, cut)
        c = attn_lib.init_kv_cache(
            cfg, batch, max_seq, window=stage.window, dtype=dtype,
            device=device, kv_heads=kv, head_dim=hd,
            seq_split=1 if cut.slots is None else mesh.axis_size(cut.slots))
    if stage.count > 1:   # stacked [count, ...], a buffer of its own each
        c = tree_map(lambda l: l[None].repeat((stage.count,)
                                              + (1,) * l.dim()), c)
    return c


def _gather_tree(tree, dims, mesh, shift: int = 0):
    """``tree`` with each leaf whose FSDP dimension ``dims`` names (``None``:
    held whole) gathered over the data axes, all in one transfer
    (``collectives.gather_fsdp``); ``shift`` 1 for a layer of a stacked
    stage, whose stack axis is gone."""
    cut = [(leaf, dim - shift) for leaf, dim in zip(tree_leaves(tree),
                                                    tree_leaves(dims))
           if dim is not None]
    if not cut:
        return tree
    wholes = coll.gather_fsdp([leaf for leaf, _ in cut], mesh,
                              data_axes(mesh), [d for _, d in cut])
    by_id = {id(leaf): whole for (leaf, _), whole in zip(cut, wholes)}
    return tree_map(lambda leaf, dim: leaf if dim is None else by_id[id(leaf)],
                    tree, dims)


def unstack(tree, count: int) -> list:
    """The per-layer slices (views) of a stacked [count, ...] tree."""
    return [tree_map(lambda l, _i=i: l[_i], tree) for i in range(count)]


def _layers(stage: Stage, tree):
    """The per-layer slices of a stage's tree, stacked unless count is 1."""
    return [tree] if stage.count == 1 else unstack(tree, stage.count)


class _OnMeta(TorchDispatchMode):
    """Every op lands on ``meta``: factories' ``device`` is replaced and
    their generator dropped, so ``Model.init`` draws shapes, not numbers."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = torch.device("meta")
        if kwargs.get("generator") is not None:
            kwargs["generator"] = None
        return func(*args, **kwargs)


def meta_params(model):
    """``model.init``'s parameters on ``meta``."""
    with _OnMeta():
        return model.init(torch.Generator())


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    program: List[Stage]
    backend: str = "auto"         # kernel backend: auto | ref
    remat: bool = False           # checkpoint each layer of forward
    mesh: Any = None              # launch.mesh mesh of ranks
    dp_axes: tuple = ("data",)    # mesh axes carrying the batch (the
                                  # REPLICATED_ARCHS add "model")
    remat_policy: str = "full"    # full | dots (keep the x @ w products)
    moe_ep_axis: Any = "model"    # MoE expert-parallel axis; None: the
                                  # data-parallel path, experts replicated
    seq_axis: Any = None          # context parallelism: the sequence cut
                                  # over this mesh axis (K/V gathered)
    fsdp: bool = False            # each leaf's FSDP block held, gathered
                                  # over the data axes before each use
    head_axis: Any = None         # "model": attention on the rank's padded
                                  # block of heads where wq is whole

    def __post_init__(self):
        if self.backend not in ("auto", "ref"):
            raise ValueError(f"unknown kernel backend {self.backend!r}: "
                             f"'auto' (the kernel on the card) or 'ref' "
                             f"(the plain version)")
        if self.remat_policy not in remat_lib.POLICIES:
            raise ValueError(f"unknown remat policy {self.remat_policy!r}: "
                             f"one of {remat_lib.POLICIES}")
        if self.seq_axis is not None:
            self._check_seq_axis()
        if self.head_axis is not None:
            self._check_head_axis()
        if self.fsdp:
            self._check_fsdp()
            # drawn now on meta, not inside a later step (nor a count)
            self.fsdp_dims

    def _check_fsdp(self):
        """Where FSDP does not run (module docstring)."""
        if self.mesh is None:
            raise ValueError("fsdp=True needs a mesh: the weights are cut "
                             "over its data axes")
        if self.replicate:
            raise ValueError(f"fsdp=True under the population layout "
                             f"(dp_axes={self.dp_axes}): param_specs holds "
                             f"every leaf whole there")
        if self.seq_axis is not None:
            raise ValueError(f"fsdp=True with seq_axis={self.seq_axis!r}: "
                             f"no reference entry point combines them")

    def _check_head_axis(self):
        """Where ``head_axis`` cannot run (module docstring)."""
        if self.head_axis not in attn_lib.HEAD_AXES:
            raise ValueError(f"head_axis={self.head_axis!r}: None or "
                             f"'model', the axis the weights split over")
        if self.mesh is None:
            return
        if self.replicate or self.cfg.family in REPLICATED_ARCHS:
            raise ValueError(f"{self.cfg.name}: head_axis="
                             f"{self.head_axis!r} where the batch is cut "
                             f"over 'model' (dp_axes={self.dp_axes}, family "
                             f"{self.cfg.family}): every leaf is whole and "
                             f"every peer runs its own rows")

    def _check_seq_axis(self):
        """Where context parallelism cannot run (module docstring)."""
        axis = self.seq_axis
        if self.mesh is None or axis not in self.mesh.axis_names:
            raise ValueError(f"seq_axis={axis!r} needs a mesh with that "
                             f"axis")
        if axis == "model":
            raise ValueError("seq_axis='model': the weights split over "
                             "'model'; cut the sequence over another axis")
        if axis in self.batch_axes:
            raise ValueError(f"seq_axis={axis!r} is one of the axes the "
                             f"batch is cut along ({self.batch_axes}); "
                             f"leave it out of dp_axes")

    # -- the mesh -------------------------------------------------------------
    @property
    def replicate(self) -> bool:
        """The population layout: ``"model"`` among ``dp_axes``, every leaf
        held whole and the batch cut over the whole mesh (``launch.
        sharding``'s ``replicate``)."""
        return "model" in self.dp_axes

    @property
    def batch_axes(self) -> tuple:
        """The mesh axes a batch that divides is cut along (``launch.
        sharding.batch_specs``: the data axes, or the whole mesh for
        ``REPLICATED_ARCHS`` and under ``replicate``); ``dp_axes`` without
        a mesh or under ``seq_axis``."""
        mesh = self.mesh
        if mesh is None or self.seq_axis is not None:
            return tuple(self.dp_axes)
        every = InputShape("axes", 1, mesh.axis_size(mesh.axis_names),
                           "train")
        axes = batch_specs(self.cfg, every, mesh,
                           replicate=self.replicate)["tokens"][0]
        return axes if isinstance(axes, tuple) else (axes,)

    def rank_blocks(self) -> Dict[str, Any]:
        """This rank's parameter blocks on ``meta`` (shapes only):
        ``launch.sharding.rank_specs`` over the whole model's shapes."""
        whole = meta_params(self)
        return shard_tree(whole, rank_specs(self.cfg, whole, self.mesh,
                                            self.moe_ep_axis,
                                            replicate=self.replicate),
                          self.mesh)

    @functools.cached_property
    def fsdp_dims(self) -> Any:
        """Under ``fsdp``, each leaf's dimension cut over the data axes, or
        ``None`` (``launch.sharding.fsdp_dims``, from the whole model's
        shapes); ``None`` without ``fsdp``."""
        if not self.fsdp:
            return None
        return fsdp_dims(self.cfg, meta_params(self), self.mesh,
                         self.moe_ep_axis, replicate=self.replicate)

    def _whole_top(self, params):
        """``params`` with the leaves outside the stages (``embed``,
        ``head``, ``final_norm``) gathered to their ``fsdp=False`` blocks,
        in one transfer; ``params`` itself without ``fsdp``."""
        if not self.fsdp:
            return params
        top = {k: v for k, v in params.items()
               if k not in ("stages", "shared_attn")}
        return {**params, **_gather_tree(
            top, {k: self.fsdp_dims[k] for k in top}, self.mesh)}

    def _whole_layer(self, at: int, layer, shared):
        """(a layer's weights in stage ``at``, the shared attention's)
        gathered to their ``fsdp=False`` blocks, the shared attention's
        only where the stage runs it (as they are without ``fsdp``)."""
        if not self.fsdp:
            return layer, shared
        dims, stage = self.fsdp_dims, self.program[at]
        layer = _gather_tree(layer, dims["stages"][at], self.mesh,
                             int(stage.count > 1))
        if stage.kind == "shared_attn":
            shared = _gather_tree(shared, dims["shared_attn"], self.mesh)
        return layer, shared

    # -- init ---------------------------------------------------------------
    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random f32 parameters from ``gen``, on ``gen``'s device."""
        cfg = self.cfg
        params: Dict[str, Any] = {
            "embed": dense_init(gen, (cfg.vocab, cfg.d_model)),
            "final_norm": init_norm(cfg.norm, cfg.d_model, device=gen.device),
        }
        if not cfg.tie_embeddings:
            params["head"] = dense_init(gen, (cfg.d_model, cfg.vocab))
        if any(s.kind == "shared_attn" for s in self.program):
            params["shared_attn"] = _init_layer(gen, cfg, "shared_attn")
        stage_params = []
        for stage in self.program:
            if stage.kind == "shared_attn":
                stage_params.append({})  # weights in params["shared_attn"]
                continue
            layers = [_init_layer(gen, cfg, stage.kind)
                      for _ in range(stage.count)]
            if stage.count > 1:
                stage_params.append(tree_map(lambda *ls: torch.stack(ls),
                                             *layers))
            else:
                stage_params.append(layers[0])
            del layers
        params["stages"] = stage_params
        return params

    # -- embedding helpers ----------------------------------------------------
    def _embed(self, params, tokens: torch.Tensor,
               batch: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """Token embeddings; for ``vlm`` with a ``batch``, its
        ``vision_embed`` [B, vision_tokens, D] in front of them (under
        ``seq_axis`` the rank's rows of each, which may be none: its block
        of the whole sequence, ``lm_ranks.rank_batch``)."""
        cdt = compute_dtype_of(self.cfg)
        embed, mesh = params["embed"], self.mesh
        if mesh is None or embed.shape[0] == self.cfg.vocab:
            x = embed[tokens].to(cdt)
        else:
            # the rank's rows; ids elsewhere read zero, and the sum over
            # the peers has one nonzero term, so it is exact
            rows = embed.shape[0]
            local = tokens - mesh.axis_index("model") * rows
            mine = (local >= 0) & (local < rows)
            x = torch.where(mine[..., None],
                            embed[local.clamp(0, rows - 1)], 0.0).to(cdt)
            x = coll.reduce_from_peers(x, mesh, "model")
        if batch is not None and self.cfg.family == "vlm":
            x = torch.cat([batch["vision_embed"].to(x.dtype), x], dim=1)
        return x

    def _unembed(self, params, x: torch.Tensor) -> torch.Tensor:
        """f32 logits [.., V]: whole on every rank, the rank's vocabulary
        columns gathered over ``"model"`` where they are split."""
        w = params["embed"].T if self.cfg.tie_embeddings else params["head"]
        mesh = self.mesh
        if mesh is None or w.shape[-1] == self.cfg.vocab:
            return x.float() @ w.float()
        mine = coll.replicated(x, mesh, "model").float() @ w.float()
        parts = coll.all_gather(mine[None], mesh, "model")  # [tp, .., V/tp]
        return torch.movedim(parts, 0, -2).reshape(
            mine.shape[:-1] + (self.cfg.vocab,))

    def _positions(self, batch_size: int, seq: int, device) -> torch.Tensor:
        """[B, S], or [3, B, S] (three equal streams) under M-RoPE; under
        ``seq_axis`` the rank's block of ``seq`` positions."""
        first = 0 if self.seq_axis is None else \
            self.mesh.axis_index(self.seq_axis) * seq
        pos = torch.arange(first, first + seq, dtype=torch.int32,
                           device=device)[None].expand(batch_size, seq)
        if self.cfg.mrope_sections is not None:
            pos = pos[None].expand(3, batch_size, seq)
        return pos

    # -- full-sequence forward ------------------------------------------------
    def forward(self, params, batch: Dict[str, Any]):
        """Returns (logits [B,S,V] f32, aux_loss). batch: ``tokens`` [B, S]
        (S counts the vision prefix for ``vlm``), ``vision_embed`` for
        ``vlm``, and optionally ``positions`` ([B, S], or [3, B, S] under
        M-RoPE) in place of 0..S-1.

        The aux loss is the sum of the ``moe`` layers' load-balance terms
        (f32; 0 for a model without them)."""
        cfg = self.cfg
        top = self._whole_top(params)
        x = self._embed(top, batch["tokens"], batch)
        b, s, _ = x.shape
        positions = batch.get("positions")
        if positions is None:
            positions = self._positions(b, s, x.device)
        shared = params.get("shared_attn")
        aux_total = torch.zeros((), device=x.device)
        for at, (stage, sp) in enumerate(zip(self.program,
                                             params["stages"])):
            body = functools.partial(
                _apply_layer, positions=positions, cfg=cfg, kind=stage.kind,
                window=stage.window, backend=self.backend, mesh=self.mesh,
                dp_axes=self.dp_axes, moe_ep_axis=self.moe_ep_axis,
                seq_axis=self.seq_axis, head_axis=self.head_axis)

            def run(x, lp, sh, body=body, at=at):
                # FSDP's gathers inside the layer, so that remat's
                # recomputation gathers again and the whole weights do
                # not live until the backward
                lp, sh = self._whole_layer(at, lp, sh)
                return body(lp, x, shared=sh)
            for lp in _layers(stage, sp):
                if self.remat:
                    # the backward runs the layer again: bind this
                    # stage's body, not the loop's last
                    x, aux = remat_lib.checkpoint(
                        run, x, lp, shared, policy=self.remat_policy)
                else:
                    x, aux = run(x, lp, shared)
                if aux is not None:
                    aux_total = aux_total + aux
        x = apply_norm(top["final_norm"], x, cfg.norm, cfg.norm_eps)
        return self._unembed(top, x), aux_total

    # -- loss -----------------------------------------------------------------
    def loss(self, params, batch: Dict[str, Any]):
        """(loss, {"nll", "aux"}): the mean next-token nll plus 0.01 x the
        aux loss; under ``seq_axis`` the rank's share of them (module
        docstring)."""
        logits, aux = self.forward(params, batch)
        tokens = batch["tokens"]
        if self.seq_axis is not None:
            return self._loss_share(logits, aux, tokens)
        if self.cfg.family == "vlm":    # no loss on the vision prefix
            logits = logits[:, self.cfg.vision_tokens:]
        lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        tgt = tokens[:, 1:].long()
        nll = -torch.gather(lp, -1, tgt[..., None])[..., 0]
        loss = torch.mean(nll) + 0.01 * aux
        return loss, {"nll": torch.mean(nll), "aux": aux}

    def _loss_share(self, logits, aux, tokens):
        """This rank's share of ``loss`` under ``seq_axis``: its positions'
        nll summed over the whole sequence's B (T - 1) targets (T the text
        tokens; a ``vlm`` block's leading ``lead`` rows are the vision
        prefix, whose positions predict nothing)."""
        mesh, axis = self.mesh, self.seq_axis
        n, r = mesh.axis_size(axis), mesh.axis_index(axis)
        b, m = logits.shape[:2]
        lead = m - tokens.shape[1]
        # every block's first token, [n, B]: the next block's is the
        # target of this block's last position (0 for a block that starts
        # in the prefix: no position predicts it)
        first = tokens[:, :1] if lead == 0 else tokens.new_zeros((b, 1))
        firsts = coll.all_gather(first.T.contiguous(), mesh, axis)
        if r < n - 1:
            tgt = torch.cat([tokens[:, 1:], firsts[r + 1][:, None]],
                            dim=1)[:, :m - lead]
        else:
            tgt, logits = tokens[:, 1:], logits[:, :-1]
        lp = torch.log_softmax(logits[:, lead:].float(), dim=-1)
        nll = -torch.gather(lp, -1, tgt.long()[..., None])[..., 0]
        share = nll.sum() / (b * (n * m - self.cfg.vision_tokens - 1))
        return share + 0.01 * aux / n, {"nll": share, "aux": aux}

    # -- decode ----------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device="cuda", *, global_batch: Optional[int] = None):
        """The decode cache; on a mesh, the rank's blocks: of each KV cache
        ``cache_specs``' block (``_kv_cut``), of the SSM state its SSM heads
        and ``conv_x`` channels (sized from its blocks, ``rank_blocks``).

        ``batch`` is the rows this rank decodes, the same on every peer of
        ``"model"``. The KV caches are cut as ``launch.sharding.
        kv_cache_cut`` says: the kv heads or ``head_dim`` over
        ``"model"``; the slots under ``seq_axis`` over it (the batch is
        whole along it), else where ``global_batch``, the batch all ranks
        decode together (``cache_specs``' ``batch``), does not divide the
        data axes, over them, every rank then holding all
        ``global_batch`` rows. Without ``global_batch`` each rank's rows
        are its own and no slots are cut."""
        dev = resolve_device(device)
        if self.mesh is None:
            blocks = [None] * len(self.program)
        else:
            whole = self.rank_blocks()
            blocks = [whole.get("shared_attn") if s.kind == "shared_attn"
                      else sp for s, sp in zip(self.program, whole["stages"])]
        return [_init_stage_cache(
                    self.cfg, s, batch, max_seq, dtype, dev, block, self.mesh,
                    KVCut() if s.kind in ("mamba", "xlstm_pair") else
                    self._kv_cut(attn_lib.cache_slots(max_seq, s.window),
                                 batch, global_batch))
                for s, block in zip(self.program, blocks)]

    def _kv_cut(self, slots: Optional[int], batch: Optional[int] = None,
                global_batch: Optional[int] = None) -> KVCut:
        """How a KV cache of ``slots`` slots is cut on this rank
        (``launch.sharding.kv_cache_cut``); ``slots`` ``None``: the heads
        and ``head_dim`` only (decode reads the slot cut off the cache).
        The population layout cuts nothing: its rows differ between the
        peers of ``"model"``."""
        mesh = self.mesh
        if mesh is None or self.replicate:
            return KVCut()
        if global_batch is not None and self.seq_axis is None:
            n = mesh.axis_size(data_axes(mesh))
            rows = global_batch if global_batch % n else global_batch // n
            if batch != rows:
                raise ValueError(f"a global batch of {global_batch} on {n} "
                                 f"data ranks puts {rows} rows on a rank, "
                                 f"not {batch}")
        return kv_cache_cut(self.cfg, global_batch, slots, mesh,
                            seq_axis=self.seq_axis)

    def _decode_cut(self, cache, slots_key: str = "slots") -> KVCut:
        """The cut of a KV cache being decoded: the heads and ``head_dim``
        as ``_kv_cut`` says, the slots along ``seq_axis`` or the data axes
        where ``cache`` holds ``slots_key`` (the whole count)."""
        cut = self._kv_cut(None)
        if slots_key in cache:
            cut = cut._replace(slots=self.seq_axis or data_axes(self.mesh))
        return cut

    def decode_step(self, params, cache, token: torch.Tensor, pos: int):
        """token: [B,1] int; pos: int. Returns (logits [B,V] f32, cache).

        The cache is updated in place (see ``attention.attn_decode``,
        ``mamba2.mamba2_decode`` and ``xlstm``'s decodes)."""
        cfg = self.cfg
        pos = int(pos)
        top = self._whole_top(params)
        x = self._embed(top, token)
        for at, (stage, sp, sc) in enumerate(zip(self.program,
                                                 params["stages"], cache)):
            cut = KVCut() if stage.kind in ("mamba", "xlstm_pair") else \
                self._decode_cut(sc)
            for lp, lc in zip(_layers(stage, sp), _layers(stage, sc)):
                lp, shared = self._whole_layer(at, lp,
                                               params.get("shared_attn"))
                x = _decode_layer(lp, x, lc, pos, cfg, stage.kind,
                                  stage.window, shared, self.mesh,
                                  self.dp_axes, cut)
        x = apply_norm(top["final_norm"], x, cfg.norm, cfg.norm_eps)
        return self._unembed(top, x)[:, 0], cache

    # -- dry-run inputs -------------------------------------------------------
    def input_specs(self, shape, device="meta") -> Dict[str, Any]:
        """Inputs of one step at ``shape`` (a ``configs.InputShape``) on
        ``device``, by default ``meta`` (shapes only, nothing allocated):
        the batch of a train or prefill step, or a decode step's ``token``,
        ``pos`` (the last position) and ``cache``."""
        cfg = self.cfg
        b = shape.global_batch
        if shape.kind in ("train", "prefill"):
            s = shape.seq_len
            if cfg.family == "vlm":
                return {"tokens": torch.zeros(
                            (b, s - cfg.vision_tokens), dtype=torch.int32,
                            device=device),
                        "vision_embed": torch.zeros(
                            (b, cfg.vision_tokens, cfg.d_model),
                            dtype=torch.bfloat16, device=device)}
            return {"tokens": torch.zeros((b, s), dtype=torch.int32,
                                          device=device)}
        return {"token": torch.zeros((b, 1), dtype=torch.int32,
                                     device=device),
                "pos": shape.seq_len - 1,
                "cache": self.init_cache(b, shape.seq_len, device=device)}


def build_model(cfg: ModelConfig, *, backend: str = "auto",
                remat: bool = False, mesh: Any = None,
                dp_axes: tuple = ("data",), remat_policy: str = "full",
                moe_ep_axis: Any = "model", seq_axis: Any = None,
                fsdp: bool = False, head_axis: Any = None) -> Model:
    """The model of ``cfg``: a ``WhisperModel`` for the ``audio`` family,
    else a ``Model``."""
    kw = dict(cfg=cfg, program=build_program(cfg), backend=backend,
              remat=remat, mesh=mesh, dp_axes=dp_axes,
              remat_policy=remat_policy, moe_ep_axis=moe_ep_axis,
              seq_axis=seq_axis, fsdp=fsdp, head_axis=head_axis)
    if cfg.family == "audio":
        from repro_torch.models.whisper import WhisperModel
        return WhisperModel(**kw)
    return Model(**kw)
