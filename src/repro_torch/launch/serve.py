"""Serving launcher: batched greedy decode with KV caches.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \\
      --smoke --device cpu --batch 4 --prompt-len 16 --gen 32

Port of ``repro.launch.serve``: random weights from ``--seed``, a random
prompt, the prompt replayed through ``decode_step`` to fill the cache
(cache-correct for rolling windows), then greedy decode. The cache is f32,
as in the reference. For Whisper (the ``audio`` family) ``0.1 * normal``
frames from the seed stand in for the audio; ``prefill_cross_kv`` encodes
them into the cache's cross-attention K/V before the replay. Runs on the
card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import build_model
from repro_torch.models.api import Model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(model: Model, params, prompt: torch.Tensor, gen: int,
             cache_dtype=torch.float32,
             audio_embed: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """Replay ``prompt`` [B, P] through decode, then ``gen`` greedy tokens.
    An ``audio`` model needs ``audio_embed`` [B, encoder_seq, D]: it is
    encoded into the fresh cache (``prefill_cross_kv``) first.

    Returns ``tokens`` [B, gen], the last step's ``logits`` [B, V],
    ``finite`` (whether every step's logits were finite, reduced on the
    device), and the wall seconds of the encoding (``encode_s``, 0 without
    audio), of the replay (``prefill_s``) and of the greedy loop
    (``decode_s``), each ending in a device synchronise.
    """
    dev = prompt.device
    b, n_prompt = prompt.shape
    if n_prompt < 1:
        raise ValueError("generate needs a prompt of at least one token")
    audio = model.cfg.family == "audio"
    if audio != (audio_embed is not None):
        raise ValueError(f"{model.cfg.name}: audio_embed is "
                         f"{'needed' if audio else 'only for audio models'}")
    max_seq = n_prompt + gen
    decode = make_serve_step(model)
    cache = model.init_cache(b, max_seq, dtype=cache_dtype, device=dev)
    t_encode = 0.0
    if audio:
        t0 = time.perf_counter()
        with torch.no_grad():
            cache = model.prefill_cross_kv(params, audio_embed, cache)
        _sync(dev)
        t_encode = time.perf_counter() - t0

    finite = torch.ones((), dtype=torch.bool, device=dev)
    t0 = time.perf_counter()
    for t in range(n_prompt):
        logits, cache = decode(params, cache, prompt[:, t:t + 1], t)
        finite &= torch.isfinite(logits).all()
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    generated = []
    t0 = time.perf_counter()
    tok = torch.argmax(logits, dim=-1)[:, None]
    for t in range(n_prompt, max_seq):
        generated.append(tok)
        logits, cache = decode(params, cache, tok, t)
        finite &= torch.isfinite(logits).all()
        tok = torch.argmax(logits, dim=-1)[:, None]
    _sync(dev)
    t_gen = time.perf_counter() - t0
    tokens = torch.cat(generated, dim=1) if generated else \
        prompt.new_zeros((b, 0))
    return {"tokens": tokens, "logits": logits, "finite": bool(finite),
            "encode_s": t_encode, "prefill_s": t_prefill, "decode_s": t_gen}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = model.init(gen)
    b = args.batch
    prompt = torch.randint(0, cfg.vocab, (b, args.prompt_len), generator=gen,
                           device=dev)
    audio = None
    if cfg.family == "audio":
        audio = 0.1 * torch.randn((b, cfg.encoder_seq, cfg.d_model),
                                  generator=gen, device=dev)
    out = generate(model, params, prompt, args.gen, audio_embed=audio)

    print(f"arch={cfg.name} batch={b} prompt={args.prompt_len} gen={args.gen} "
          f"device={dev}")
    if audio is not None:
        print(f"encoded {cfg.encoder_seq} frames into the cross-attention "
              f"cache in {out['encode_s']:.2f}s")
    print(f"prefill {out['prefill_s']:.2f}s | decode {out['decode_s']:.2f}s "
          f"({b * args.gen / max(out['decode_s'], 1e-9):.1f} tok/s)")
    print("sample tokens:", out["tokens"][0, :16].tolist(),
          "| every logit finite:", out["finite"])
    return out


if __name__ == "__main__":
    main()
