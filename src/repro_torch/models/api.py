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
its ``d_ff`` block, the Mamba2 mixer on its SSM heads
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
decode cache a rank holds is sized from its blocks (``Model.init_cache``:
the blocks of ``rank_specs`` on ``meta``). ``remat``
checkpoints each layer of ``forward`` (``models/remat.py``;
``remat_policy`` "full" or "dots"). Not ported: ``head_axis`` (the
reference's GSPMD hint that pads head counts that do not divide; the port
runs such a layer whole) and ``seq_axis`` (context parallelism), and
``unroll`` (the port's stages are Python loops already).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import InputShape, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.interop import tree_map
from repro_torch.launch import collectives as coll
from repro_torch.launch.sharding import batch_specs, rank_specs, shard_tree
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


def _apply_layer(params, x, positions, cfg: ModelConfig, kind: str,
                 window: Optional[int], backend: str, shared=None, mesh=None,
                 dp_axes=("data",), moe_ep_axis="model"):
    """Full-sequence forward for one layer. Returns (x, aux_loss or None:
    only ``moe`` layers have one)."""
    if kind == "mamba":
        h = apply_norm(params["norm"], x, cfg.norm, cfg.norm_eps)
        return x + mamba_lib.mamba2_forward(params["mixer"], h, cfg,
                                            backend=backend,
                                            mesh=mesh), None
    if kind == "xlstm_pair":
        x = xlstm_lib.mlstm_forward(params["mlstm"], x, cfg)
        return xlstm_lib.slstm_forward(params["slstm"], x, cfg,
                                       backend=backend), None
    p = shared if kind == "shared_attn" else params
    h = apply_norm(p["norm1"], x, cfg.norm, cfg.norm_eps)
    x = x + attn_lib.attn_forward(p["attn"], h, positions, cfg,
                                  window=window, backend=backend,
                                  mesh=mesh)
    h = apply_norm(p["norm2"], x, cfg.norm, cfg.norm_eps)
    if kind == "moe":
        out, aux = moe_lib.apply_moe(p["moe"], h, cfg, mesh=mesh,
                                     dp_axes=dp_axes, ep_axis=moe_ep_axis)
        return x + out, aux
    return x + apply_mlp(p["mlp"], h, cfg.act, compute_dtype_of(cfg),
                         mesh=mesh, d_ff=cfg.d_ff), None


def _decode_layer(params, x, cache, pos: int, cfg: ModelConfig, kind: str,
                  window: Optional[int], shared=None, mesh=None,
                  dp_axes=("data",)):
    """Single-token decode for one layer; updates ``cache`` in place."""
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
                                  window=window, mesh=mesh)
    x = x + out
    h = apply_norm(p["norm2"], x, cfg.norm, cfg.norm_eps)
    if kind == "moe":       # the aux loss is dropped, as in the reference
        return x + moe_lib.apply_moe(p["moe"], h, cfg, mesh=mesh,
                                     dp_axes=dp_axes)[0]
    return x + apply_mlp(p["mlp"], h, cfg.act, compute_dtype_of(cfg),
                         mesh=mesh, d_ff=cfg.d_ff)


def _init_stage_cache(cfg: ModelConfig, stage: Stage, batch: int,
                      max_seq: int, dtype, device, block=None, mesh=None):
    """One stage's decode cache; with ``block``, the rank's parameters of
    the stage (its layer's, or the shared attention's, on ``meta``), the
    heads and channels they hold."""
    if stage.kind == "mamba":     # f32 whatever ``dtype``, as the reference
        c = mamba_lib.init_mamba2_cache(
            cfg, batch, device=device,
            params=None if block is None else block["mixer"])
    elif stage.kind == "xlstm_pair":     # f32 too
        c = {"mlstm": xlstm_lib.init_mlstm_cache(cfg, batch, device=device),
             "slstm": xlstm_lib.init_slstm_cache(cfg, batch, device=device)}
    else:
        c = attn_lib.init_kv_cache(
            cfg, batch, max_seq, window=stage.window, dtype=dtype,
            device=device, kv_heads=None if block is None else
            attn_lib.rank_kv_heads(block["attn"], cfg, mesh))
    if stage.count > 1:   # stacked [count, ...], a buffer of its own each
        c = tree_map(lambda l: l[None].repeat((stage.count,)
                                              + (1,) * l.dim()), c)
    return c


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

    def __post_init__(self):
        if self.backend not in ("auto", "ref"):
            raise ValueError(f"unknown kernel backend {self.backend!r}: "
                             f"'auto' (the kernel on the card) or 'ref' "
                             f"(the plain version)")
        if self.remat_policy not in remat_lib.POLICIES:
            raise ValueError(f"unknown remat policy {self.remat_policy!r}: "
                             f"one of {remat_lib.POLICIES}")

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
        a mesh."""
        mesh = self.mesh
        if mesh is None:
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
        ``vision_embed`` [B, vision_tokens, D] in front of them."""
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
        """[B, S], or [3, B, S] (three equal streams) under M-RoPE."""
        pos = torch.arange(seq, dtype=torch.int32, device=device)[None] \
            .expand(batch_size, seq)
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
        x = self._embed(params, batch["tokens"], batch)
        b, s, _ = x.shape
        positions = batch.get("positions")
        if positions is None:
            positions = self._positions(b, s, x.device)
        shared = params.get("shared_attn")
        aux_total = torch.zeros((), device=x.device)
        for stage, sp in zip(self.program, params["stages"]):
            body = functools.partial(
                _apply_layer, positions=positions, cfg=cfg, kind=stage.kind,
                window=stage.window, backend=self.backend, mesh=self.mesh,
                dp_axes=self.dp_axes, moe_ep_axis=self.moe_ep_axis)
            for lp in _layers(stage, sp):
                if self.remat:
                    # the backward runs the layer again: bind this
                    # stage's body, not the loop's last
                    x, aux = remat_lib.checkpoint(
                        lambda x, lp, sh, body=body: body(lp, x, shared=sh),
                        x, lp, shared, policy=self.remat_policy)
                else:
                    x, aux = body(lp, x, shared=shared)
                if aux is not None:
                    aux_total = aux_total + aux
        x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
        return self._unembed(params, x), aux_total

    # -- loss -----------------------------------------------------------------
    def loss(self, params, batch: Dict[str, Any]):
        logits, aux = self.forward(params, batch)
        tokens = batch["tokens"]
        if self.cfg.family == "vlm":    # no loss on the vision prefix
            logits = logits[:, self.cfg.vision_tokens:]
        lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        tgt = tokens[:, 1:].long()
        nll = -torch.gather(lp, -1, tgt[..., None])[..., 0]
        loss = torch.mean(nll) + 0.01 * aux
        return loss, {"nll": torch.mean(nll), "aux": aux}

    # -- decode ----------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device="cuda"):
        """The decode cache; on a mesh, the rank's kv heads, SSM heads and
        ``conv_x`` channels (the ones its own compute reads), sized from
        its blocks (``rank_blocks``)."""
        dev = resolve_device(device)
        if self.mesh is None:
            blocks = [None] * len(self.program)
        else:
            whole = self.rank_blocks()
            blocks = [whole.get("shared_attn") if s.kind == "shared_attn"
                      else sp for s, sp in zip(self.program, whole["stages"])]
        return [_init_stage_cache(self.cfg, s, batch, max_seq, dtype, dev,
                                  block, self.mesh)
                for s, block in zip(self.program, blocks)]

    def decode_step(self, params, cache, token: torch.Tensor, pos: int):
        """token: [B,1] int; pos: int. Returns (logits [B,V] f32, cache).

        The cache is updated in place (see ``attention.attn_decode``,
        ``mamba2.mamba2_decode`` and ``xlstm``'s decodes)."""
        cfg = self.cfg
        pos = int(pos)
        x = self._embed(params, token)
        shared = params.get("shared_attn")
        for stage, sp, sc in zip(self.program, params["stages"], cache):
            for lp, lc in zip(_layers(stage, sp), _layers(stage, sc)):
                x = _decode_layer(lp, x, lc, pos, cfg, stage.kind,
                                  stage.window, shared, self.mesh,
                                  self.dp_axes)
        x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
        return self._unembed(params, x)[:, 0], cache

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
                moe_ep_axis: Any = "model") -> Model:
    """The model of ``cfg``: a ``WhisperModel`` for the ``audio`` family,
    else a ``Model``."""
    kw = dict(cfg=cfg, program=build_program(cfg), backend=backend,
              remat=remat, mesh=mesh, dp_axes=dp_axes,
              remat_policy=remat_policy, moe_ep_axis=moe_ep_axis)
    if cfg.family == "audio":
        from repro_torch.models.whisper import WhisperModel
        return WhisperModel(**kw)
    return Model(**kw)
