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
with every weight whole but the experts, which ``models/moe.py``'s
``shard_map`` paths take: expert-parallel over ``moe_ep_axis``, or
data-parallel where it is ``None``. Decode passes ``mesh`` and ``dp_axes``
but not ``moe_ep_axis``, as the reference's ``_decode_layer`` does, so it
takes the expert-parallel path over ``"model"`` whatever ``moe_ep_axis``
says. ``remat`` checkpoints each layer of ``forward`` (``models/remat.py``;
``remat_policy`` "full" or "dots"). Not ported: ``head_axis`` and
``seq_axis`` (attention's tensor and context parallelism) and ``unroll``
(the port's stages are Python loops already).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.interop import tree_map
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
                                            backend=backend), None
    if kind == "xlstm_pair":
        x = xlstm_lib.mlstm_forward(params["mlstm"], x, cfg)
        return xlstm_lib.slstm_forward(params["slstm"], x, cfg,
                                       backend=backend), None
    p = shared if kind == "shared_attn" else params
    h = apply_norm(p["norm1"], x, cfg.norm, cfg.norm_eps)
    x = x + attn_lib.attn_forward(p["attn"], h, positions, cfg,
                                  window=window, backend=backend)
    h = apply_norm(p["norm2"], x, cfg.norm, cfg.norm_eps)
    if kind == "moe":
        out, aux = moe_lib.apply_moe(p["moe"], h, cfg, mesh=mesh,
                                     dp_axes=dp_axes, ep_axis=moe_ep_axis)
        return x + out, aux
    return x + apply_mlp(p["mlp"], h, cfg.act, compute_dtype_of(cfg)), None


def _decode_layer(params, x, cache, pos: int, cfg: ModelConfig, kind: str,
                  window: Optional[int], shared=None, mesh=None,
                  dp_axes=("data",)):
    """Single-token decode for one layer; updates ``cache`` in place."""
    if kind == "mamba":
        h = apply_norm(params["norm"], x, cfg.norm, cfg.norm_eps)
        out, _ = mamba_lib.mamba2_decode(params["mixer"], h, cache, cfg)
        return x + out
    if kind == "xlstm_pair":
        x, _ = xlstm_lib.mlstm_decode(params["mlstm"], x, cache["mlstm"], cfg)
        x, _ = xlstm_lib.slstm_decode(params["slstm"], x, cache["slstm"], cfg)
        return x
    p = shared if kind == "shared_attn" else params
    h = apply_norm(p["norm1"], x, cfg.norm, cfg.norm_eps)
    out, _ = attn_lib.attn_decode(p["attn"], h, cache, pos, cfg,
                                  window=window)
    x = x + out
    h = apply_norm(p["norm2"], x, cfg.norm, cfg.norm_eps)
    if kind == "moe":       # the aux loss is dropped, as in the reference
        return x + moe_lib.apply_moe(p["moe"], h, cfg, mesh=mesh,
                                     dp_axes=dp_axes)[0]
    return x + apply_mlp(p["mlp"], h, cfg.act, compute_dtype_of(cfg))


def _init_stage_cache(cfg: ModelConfig, stage: Stage, batch: int,
                      max_seq: int, dtype, device):
    if stage.kind == "mamba":     # f32 whatever ``dtype``, as the reference
        c = mamba_lib.init_mamba2_cache(cfg, batch, device=device)
    elif stage.kind == "xlstm_pair":     # f32 too
        c = {"mlstm": xlstm_lib.init_mlstm_cache(cfg, batch, device=device),
             "slstm": xlstm_lib.init_slstm_cache(cfg, batch, device=device)}
    else:
        c = attn_lib.init_kv_cache(cfg, batch, max_seq, window=stage.window,
                                   dtype=dtype, device=device)
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


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    program: List[Stage]
    backend: str = "auto"         # kernel backend: auto | ref
    remat: bool = False           # checkpoint each layer of forward
    mesh: Any = None              # launch.mesh mesh of ranks (the MoE paths)
    dp_axes: tuple = ("data",)    # mesh axes carrying the batch
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
        x = params["embed"][tokens].to(compute_dtype_of(self.cfg))
        if batch is not None and self.cfg.family == "vlm":
            x = torch.cat([batch["vision_embed"].to(x.dtype), x], dim=1)
        return x

    def _unembed(self, params, x: torch.Tensor) -> torch.Tensor:
        w = params["embed"].T if self.cfg.tie_embeddings else params["head"]
        return x.float() @ w.float()

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
        dev = resolve_device(device)
        return [_init_stage_cache(self.cfg, s, batch, max_seq, dtype, dev)
                for s in self.program]

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
