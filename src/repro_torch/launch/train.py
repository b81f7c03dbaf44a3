"""Training launcher: Adam with a cosine warmup on synthetic token streams.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --steps 20 --batch 4 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --smoke --device cpu --steps 20 --batch 4 --seq 128

Port of ``repro.launch.train``: the same CLI, random f32 weights from
``--seed``, ``make_lm_dataset``'s Markov streams, ``adam(cosine_schedule(lr,
steps, warmup=steps // 10))`` through ``make_train_step``, and parameter
checkpoints with ML Mule lineage metadata every ``--ckpt-every`` steps under
``--ckpt-dir`` (restored from the latest one at start, as the reference
does: the parameters, not the optimizer state). ``--smoke`` takes the
reduced same-family config. Runs on the card unless ``--device cpu`` is
given; there the forward of every attention, SSD and sLSTM layer is a
hand-written kernel and the gradient the plain version's.

The batch is assembled for every family, as the reference's loop does (a
MoE model's loss carries its load-balance term at 0.01): a ``vlm`` model's
tokens are cut to ``seq - vision_tokens`` behind a zero ``vision_embed``
prefix, an ``audio`` model gets zero ``audio_embed`` frames, both in bf16.
"""
from __future__ import annotations

import argparse
import functools
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import (latest_checkpoint, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import ModelConfig, get_config, get_smoke_config
from repro_torch.data import make_lm_dataset
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import adam, cosine_schedule

def lm_batch(cfg: ModelConfig, tokens: np.ndarray,
             device) -> Dict[str, torch.Tensor]:
    """The train batch of ``tokens`` [B, S] for ``cfg``'s family: for
    ``vlm`` the first ``S - vision_tokens`` tokens and a zero
    ``vision_embed`` [B, vision_tokens, d_model], for ``audio`` a zero
    ``audio_embed`` [B, encoder_seq, d_model], both bf16 (the stubs'
    inputs, as in the reference's loop)."""
    b, s = tokens.shape
    zeros = functools.partial(torch.zeros, dtype=torch.bfloat16,
                              device=device)
    batch = {}
    if cfg.family == "vlm":
        if s <= cfg.vision_tokens:
            raise ValueError(f"{cfg.name}: a sequence of {s} leaves no "
                             f"token after its {cfg.vision_tokens} vision "
                             f"tokens")
        tokens = tokens[:, :s - cfg.vision_tokens]
        batch["vision_embed"] = zeros((b, cfg.vision_tokens, cfg.d_model))
    if cfg.family == "audio":
        batch["audio_embed"] = zeros((b, cfg.encoder_seq, cfg.d_model))
    batch["tokens"] = torch.as_tensor(tokens, dtype=torch.int64,
                                      device=device)
    return batch


def setup(cfg: ModelConfig, *, seed: int = 0, lr: float = 3e-4,
          steps: int = 50, device="cuda"):
    """(model, params, optimizer, opt_state, step_fn) of the launcher."""
    dev = resolve_device(device)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen)
    opt = adam(cosine_schedule(lr, steps, warmup=steps // 10))
    return model, params, opt, opt.init(params), make_train_step(model, opt)


def train(cfg: ModelConfig, *, steps: int = 50, batch: int = 4,
          seq: int = 128, lr: float = 3e-4, seed: int = 0,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          device="cuda", log=print
          ) -> Dict[str, Any]:
    """The launcher's loop. Returns ``losses`` (one a step run), ``aux``
    (each step's MoE load-balance term, 0 for a model without experts), the
    final ``params``, ``start`` (the restored step) and ``step_s`` (wall
    seconds of each step, the device synchronised)."""
    dev = resolve_device(device)
    model, params, opt, opt_state, step_fn = setup(
        cfg, seed=seed, lr=lr, steps=steps, device=dev)
    start = 0
    if ckpt_dir:
        ck = latest_checkpoint(ckpt_dir)
        if ck:
            params, meta = restore_checkpoint(ck, params)
            start = int(meta.get("step", 0))
            log(f"restored {ck} at step {start}")

    seqs, _ = make_lm_dataset(seed, n_seqs=max(batch * 8, 64), seq_len=seq,
                              vocab=cfg.vocab)
    rng = np.random.default_rng(seed)
    losses, auxes, times = [], [], []
    for step in range(start, steps):
        idx = rng.integers(0, len(seqs), size=batch)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state,
                                             lm_batch(cfg, seqs[idx], dev))
        loss = float(metrics["loss"])           # synchronises the device
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        auxes.append(float(metrics["aux"]))
        if step % 5 == 0 or step == steps - 1:
            log(f"step {step:5d} loss {loss:.4f} aux {auxes[-1]:.4f} "
                f"({times[-1]:.2f}s/step)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, step + 1, params,
                            metadata={"arch": cfg.name, "loss": loss,
                                      "updated_at": step + 1})
    return {"losses": losses, "aux": auxes, "params": params, "start": start,
            "step_s": times, "model": model}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"arch={cfg.name} params~{cfg.param_count() / 1e6:.1f}M "
          f"active~{cfg.active_param_count() / 1e6:.1f}M")
    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, seed=args.seed, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, device=args.device)
    if out["losses"]:
        print("done; final loss", out["losses"][-1])
    return out


if __name__ == "__main__":
    main()
