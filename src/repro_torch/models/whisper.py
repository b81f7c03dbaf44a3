"""Whisper-style encoder-decoder (the ``audio`` family).

Port of ``repro.models.whisper``. The mel-spectrogram and conv feature
extractor is a stub, as in the reference: the batch carries precomputed
frame embeddings ``audio_embed`` [B, encoder_seq, D]. The transformer
backbone is whole: a bidirectional encoder and a causal decoder with
cross-attention, both with fixed sinusoidal positions (no RoPE), layernorm
and a gelu MLP, the unembedding tied to the token embedding.

The parameter tree is the reference's: ``embed``, ``encoder`` (``layers``
stacked ``[encoder_layers, ...]``, ``final_norm``), ``decoder`` (stacked
``[n_layers, ...]``) and ``final_norm``. The reference scans the stacked
layers with ``lax.scan``; the port walks them with a Python loop, as
``models/api.py`` walks a stage. ``loss`` is ``Model.loss``: the
next-token NLL over the decoder's tokens, whose aux term is ``forward``'s
zero (the reference's override drops it). The encoder's and the decoder's
self-attention go through ``flash_attention`` (the hand-written kernel on
the card); cross-attention takes the plain version
(``attention.cross_attn_forward``, and at decode
``attention.cross_attn_decode``). ``decode_step`` writes the new
self-attention K/V into the cache in place, as ``attention.attn_decode``
does, and returns it.

Under ``seq_axis`` (context parallelism; the reference's Whisper ignores
the axis, so its values are the unsharded model's) ``forward`` runs the
decoder on the rank's block of ``S / n`` tokens: self-attention on the
gathered causal prefix (``attention.attn_forward(seq_axis=)``),
cross-attention of the rank's queries against the whole encoder output's
K/V, the sinusoids the rank's rows of the whole sequence's; ``loss`` is
the rank's share (``Model._loss_share``). The encoder runs whole on every
rank of the axis (its attention is bidirectional), on the rows of
``audio_embed`` the batch axes give the rank.

Decode on a mesh holds ``cache_specs``' block of each of ``self_k``,
``self_v``, ``cross_k`` and ``cross_v`` (``init_cache(global_batch=)``,
``launch.sharding.kv_cache_cut``): the kv heads over ``"model"`` where
they divide, else ``head_dim``; the slots over the data axes for a batch
that does not divide them, or over ``seq_axis`` under it. The rows a rank
decodes are cut over the data axes only, as ``cache_specs`` cuts the
batch, so the peers of ``"model"`` decode the same rows.
``prefill_cross_kv`` runs the encoder whole and writes the rank's block;
``decode_step`` runs self-attention through ``attention.attn_decode`` and
cross-attention through ``attention.cross_attn_decode`` on the rank's
blocks, to the unsharded model's values.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.interop import tree_map
from repro_torch.launch.sharding import shard_of
from repro_torch.models import attention as attn_lib
from repro_torch.models.api import Model, unstack
from repro_torch.models.attention import compute_dtype_of
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_init,
                                       init_mlp, init_norm,
                                       sinusoidal_positions, sinusoids)


def _stack(layers: List[Dict[str, Any]]) -> Dict[str, Any]:
    return tree_map(lambda *ls: torch.stack(ls), *layers)


def init_encoder(gen: torch.Generator, cfg: ModelConfig):
    dev = gen.device
    layers = [{"norm1": init_norm(cfg.norm, cfg.d_model, device=dev),
               "attn": attn_lib.init_attention(gen, cfg),
               "norm2": init_norm(cfg.norm, cfg.d_model, device=dev),
               "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff)}
              for _ in range(cfg.encoder_layers)]
    return {"layers": _stack(layers),
            "final_norm": init_norm(cfg.norm, cfg.d_model, device=dev)}


def _init_dec_layer(gen: torch.Generator, cfg: ModelConfig):
    dev = gen.device
    return {"norm1": init_norm(cfg.norm, cfg.d_model, device=dev),
            "self_attn": attn_lib.init_attention(gen, cfg),
            "norm_x": init_norm(cfg.norm, cfg.d_model, device=dev),
            "cross_attn": attn_lib.init_attention(gen, cfg),
            "norm2": init_norm(cfg.norm, cfg.d_model, device=dev),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff)}


@dataclasses.dataclass
class WhisperModel(Model):

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random f32 parameters from ``gen``, on ``gen``'s device."""
        cfg = self.cfg
        return {
            "embed": dense_init(gen, (cfg.vocab, cfg.d_model)),
            "encoder": init_encoder(gen, cfg),
            "decoder": _stack([_init_dec_layer(gen, cfg)
                               for _ in range(cfg.n_layers)]),
            "final_norm": init_norm(cfg.norm, cfg.d_model, device=gen.device),
        }

    def _norm(self, p, x):
        return apply_norm(p, x, self.cfg.norm, self.cfg.norm_eps)

    def _mlp(self, p, x):
        return apply_mlp(p, x, self.cfg.act, compute_dtype_of(self.cfg))

    # -- encoder ------------------------------------------------------------
    def encode(self, params, audio_embed: torch.Tensor) -> torch.Tensor:
        """audio_embed [B, Se, D] -> the encoder's output [B, Se, D]."""
        cfg = self.cfg
        se = audio_embed.shape[1]
        x = audio_embed.to(compute_dtype_of(cfg))
        x = x + sinusoidal_positions(se, cfg.d_model,
                                     device=x.device)[None].to(x.dtype)
        for lp in unstack(params["encoder"]["layers"], cfg.encoder_layers):
            h = self._norm(lp["norm1"], x)
            x = x + attn_lib.attn_forward(lp["attn"], h, None, cfg,
                                          causal=False, rope=False,
                                          backend=self.backend)
            x = x + self._mlp(lp["mlp"], self._norm(lp["norm2"], x))
        return self._norm(params["encoder"]["final_norm"], x)

    # -- decoder, full sequence ---------------------------------------------
    def forward(self, params, batch: Dict[str, Any]):
        """Returns (logits [B, S, V] f32, aux 0). batch: ``tokens`` [B, S],
        ``audio_embed`` [B, Se, D]; under ``seq_axis`` the rank's block of
        the tokens and its logits [B, S / n, V]."""
        cfg, mesh, axis = self.cfg, self.mesh, self.seq_axis
        enc_out = self.encode(params, batch["audio_embed"])
        tokens = batch["tokens"]
        m = tokens.shape[1]
        n, r = (1, 0) if axis is None else (mesh.axis_size(axis),
                                            mesh.axis_index(axis))
        x = params["embed"][tokens].to(compute_dtype_of(cfg))
        # the rank's rows of the whole sequence's table (so its bits)
        pe = sinusoidal_positions(n * m, cfg.d_model, device=x.device)
        x = x + pe[r * m:(r + 1) * m][None].to(x.dtype)
        for lp in unstack(params["decoder"], cfg.n_layers):
            h = self._norm(lp["norm1"], x)
            x = x + attn_lib.attn_forward(lp["self_attn"], h, None, cfg,
                                          causal=True, rope=False,
                                          backend=self.backend, mesh=mesh,
                                          seq_axis=axis)
            h = self._norm(lp["norm_x"], x)
            ck, cv = attn_lib.cross_kv(lp["cross_attn"], enc_out, cfg)
            x = x + attn_lib.cross_attn_forward(lp["cross_attn"], h, ck, cv,
                                                cfg)
            x = x + self._mlp(lp["mlp"], self._norm(lp["norm2"], x))
        x = self._norm(params["final_norm"], x)
        return self._unembed(params, x), torch.zeros((), device=x.device)

    # -- decode ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device="cuda", *, global_batch: Optional[int] = None):
        """Self-attention K/V [L, B, max_seq, KV, hd] and cross-attention
        K/V [L, B, encoder_seq, KV, hd], zeros; ``prefill_cross_kv`` fills
        the cross ones. On a mesh, each the rank's block as ``cache_specs``
        lays it out (``Model._kv_cut``, ``launch.sharding.kv_cache_cut``:
        the kv heads or ``head_dim`` over ``"model"``, the slots over
        ``seq_axis``, or over the data axes for a ``global_batch`` that
        does not divide them), ``batch`` the rank's rows, the same on
        every peer of ``"model"``; a cut of the slots adds ``self_slots``
        / ``cross_slots``, the whole count (a host int64 scalar)."""
        cfg = self.cfg
        dev = resolve_device(device)
        out = {}
        for part, slots in (("self", max_seq), ("cross", cfg.encoder_seq)):
            cut = self._kv_cut(slots, batch, global_batch)
            kv, hd = attn_lib.rank_kv_heads(None, cfg, self.mesh, cut)
            n = 1 if cut.slots is None else self.mesh.axis_size(cut.slots)
            if slots % n:
                raise ValueError(f"{slots} cache slots do not split over "
                                 f"{n} ranks")
            shape = (cfg.n_layers, batch, slots // n, kv, hd)
            for leaf in ("k", "v"):
                out[f"{part}_{leaf}"] = torch.zeros(shape, dtype=dtype,
                                                    device=dev)
            if n > 1:
                out[f"{part}_slots"] = torch.tensor(slots, dtype=torch.int64)
        return out

    def input_specs(self, shape, device="meta") -> Dict[str, Any]:
        """``Model.input_specs`` with the encoder's frames: ``audio_embed``
        [B, encoder_seq, d_model] bf16 beside the tokens of a train or
        prefill step."""
        if shape.kind in ("train", "prefill"):
            b, cfg = shape.global_batch, self.cfg
            return {"audio_embed": torch.zeros(
                        (b, cfg.encoder_seq, cfg.d_model),
                        dtype=torch.bfloat16, device=device),
                    "tokens": torch.zeros((b, shape.seq_len),
                                          dtype=torch.int32, device=device)}
        return super().input_specs(shape, device)

    def prefill_cross_kv(self, params, audio_embed: torch.Tensor, cache):
        """Encode ``audio_embed`` [B, encoder_seq, D] (the rank's rows,
        whole: the weights are replicated) and write every decoder layer's
        cross-attention K/V, or the rank's block of them, into ``cache``
        (in place; run once a request). Returns the cache."""
        cfg = self.cfg
        want = (cache["cross_k"].shape[1], cfg.encoder_seq)
        if tuple(audio_embed.shape[:2]) != want:
            raise ValueError(f"audio_embed {tuple(audio_embed.shape)} does "
                             f"not fill the cache's cross K/V [B, Se] = "
                             f"{list(want)}")
        spec = self._decode_cut(cache, "cross_slots").spec()
        enc_out = self.encode(params, audio_embed)
        for li, lp in enumerate(unstack(params["decoder"], cfg.n_layers)):
            ck, cv = attn_lib.cross_kv(lp["cross_attn"], enc_out, cfg)
            if self.mesh is not None:
                ck = shard_of(ck, spec, self.mesh)
                cv = shard_of(cv, spec, self.mesh)
            cache["cross_k"][li] = ck.to(cache["cross_k"].dtype)
            cache["cross_v"][li] = cv.to(cache["cross_v"].dtype)
        return cache

    def decode_step(self, params, cache, token: torch.Tensor, pos: int):
        """token: [B, 1] int; pos: int. Returns (logits [B, V] f32, cache),
        the cache's self-attention K/V updated in place. On a mesh the
        caches are the rank's blocks (``init_cache``); self-attention
        runs through ``attention.attn_decode``, cross-attention through
        ``attention.cross_attn_decode``."""
        cfg, mesh = self.cfg, self.mesh
        pos = int(pos)
        self_cut = self._decode_cut(cache, "self_slots")
        cross_cut = self._decode_cut(cache, "cross_slots")
        x = params["embed"][token].to(compute_dtype_of(cfg))
        # the sinusoid of this one position
        pe = sinusoids(torch.full((1,), pos, dtype=torch.float32,
                                  device=x.device), cfg.d_model)[0]
        x = x + pe.to(x.dtype)
        for li, lp in enumerate(unstack(params["decoder"], cfg.n_layers)):
            h = self._norm(lp["norm1"], x)
            kv = {"k": cache["self_k"][li], "v": cache["self_v"][li]}
            if "self_slots" in cache:
                kv["slots"] = cache["self_slots"]
            out, _ = attn_lib.attn_decode(lp["self_attn"], h, kv, pos, cfg,
                                          rope=False, mesh=mesh,
                                          cut=self_cut)
            x = x + out
            h = self._norm(lp["norm_x"], x)
            x = x + attn_lib.cross_attn_decode(
                lp["cross_attn"], h, cache["cross_k"][li],
                cache["cross_v"][li], cfg, mesh=mesh, cut=cross_cut)
            x = x + self._mlp(lp["mlp"], self._norm(lp["norm2"], x))
        x = self._norm(params["final_norm"], x)
        return self._unembed(params, x)[:, 0], cache
