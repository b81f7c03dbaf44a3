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
(``attention.cross_attn_forward``). ``decode_step`` writes the new
self-attention K/V into the cache in place, as ``attention.attn_decode``
does, and returns it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from repro_torch.configs import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.interop import tree_map
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
        ``audio_embed`` [B, Se, D]."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["audio_embed"])
        tokens = batch["tokens"]
        s = tokens.shape[1]
        x = params["embed"][tokens].to(compute_dtype_of(cfg))
        x = x + sinusoidal_positions(s, cfg.d_model,
                                     device=x.device)[None].to(x.dtype)
        for lp in unstack(params["decoder"], cfg.n_layers):
            h = self._norm(lp["norm1"], x)
            x = x + attn_lib.attn_forward(lp["self_attn"], h, None, cfg,
                                          causal=True, rope=False,
                                          backend=self.backend)
            h = self._norm(lp["norm_x"], x)
            ck, cv = attn_lib.cross_kv(lp["cross_attn"], enc_out, cfg)
            x = x + attn_lib.cross_attn_forward(lp["cross_attn"], h, ck, cv,
                                                cfg)
            x = x + self._mlp(lp["mlp"], self._norm(lp["norm2"], x))
        x = self._norm(params["final_norm"], x)
        return self._unembed(params, x), torch.zeros((), device=x.device)

    # -- decode ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device="cuda"):
        """Self-attention K/V [L, B, max_seq, KV, hd] and cross-attention
        K/V [L, B, encoder_seq, KV, hd], zeros; ``prefill_cross_kv`` fills
        the cross ones."""
        cfg = self.cfg
        dev = resolve_device(device)
        kv = (cfg.n_kv_heads, cfg.resolved_head_dim)
        self_shape = (cfg.n_layers, batch, max_seq) + kv
        cross_shape = (cfg.n_layers, batch, cfg.encoder_seq) + kv
        return {name: torch.zeros(shape, dtype=dtype, device=dev)
                for name, shape in (("self_k", self_shape),
                                    ("self_v", self_shape),
                                    ("cross_k", cross_shape),
                                    ("cross_v", cross_shape))}

    def prefill_cross_kv(self, params, audio_embed: torch.Tensor, cache):
        """Encode ``audio_embed`` and write every decoder layer's
        cross-attention K/V into ``cache`` (in place; run once a request).
        Returns the cache."""
        cfg = self.cfg
        want = tuple(cache["cross_k"].shape[1:3])
        if tuple(audio_embed.shape[:2]) != want:
            raise ValueError(f"audio_embed {tuple(audio_embed.shape)} does "
                             f"not fill the cache's cross K/V [B, Se] = "
                             f"{list(want)}")
        enc_out = self.encode(params, audio_embed)
        for li, lp in enumerate(unstack(params["decoder"], cfg.n_layers)):
            ck, cv = attn_lib.cross_kv(lp["cross_attn"], enc_out, cfg)
            cache["cross_k"][li] = ck.to(cache["cross_k"].dtype)
            cache["cross_v"][li] = cv.to(cache["cross_v"].dtype)
        return cache

    def decode_step(self, params, cache, token: torch.Tensor, pos: int):
        """token: [B, 1] int; pos: int. Returns (logits [B, V] f32, cache),
        the cache's self-attention K/V updated in place."""
        cfg = self.cfg
        pos = int(pos)
        x = params["embed"][token].to(compute_dtype_of(cfg))
        # the sinusoid of this one position
        pe = sinusoids(torch.full((1,), pos, dtype=torch.float32,
                                  device=x.device), cfg.d_model)[0]
        x = x + pe.to(x.dtype)
        for li, lp in enumerate(unstack(params["decoder"], cfg.n_layers)):
            h = self._norm(lp["norm1"], x)
            out, _ = attn_lib.attn_decode(
                lp["self_attn"], h, {"k": cache["self_k"][li],
                                     "v": cache["self_v"][li]},
                pos, cfg, rope=False)
            x = x + out
            h = self._norm(lp["norm_x"], x)
            x = x + attn_lib.cross_attn_forward(
                lp["cross_attn"], h, cache["cross_k"][li],
                cache["cross_v"][li], cfg)
            x = x + self._mlp(lp["mlp"], self._norm(lp["norm2"], x))
        x = self._norm(params["final_norm"], x)
        return self._unembed(params, x)[:, 0], cache
