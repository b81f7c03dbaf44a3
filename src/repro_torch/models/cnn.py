"""The paper's CNN (Sec 4.2.1) as plain functions on a dict of tensors.

Two conv blocks (3x3 conv, batch norm, ReLU, 2x2 max pool) + a two-layer
FC classifier. Parameters keep the reference's layouts and key paths:
conv weights HWIO, dense weights ``[in, out]``, images NHWC at the
boundary. ``cnn_forward`` permutes to NCHW/OIHW inside and back to NHWC
before the flatten into ``fc1``, so the same weights give the same logits.

Batch norm uses in-batch population statistics (``correction=0``) and keeps
no running stats: the learned scale/bias are part of the exchanged model.
The forward is functional, so ``torch.func.vmap(torch.func.grad(...))``
trains every device of a population at once with nothing shared between
devices.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.mule_cnn import CNNConfig

Params = Dict[str, torch.Tensor]


def init_cnn(generator: torch.Generator, cfg: CNNConfig) -> Params:
    """Random weights on ``generator``'s device: ``scale * N(0, 1)``."""
    dev = generator.device
    f1, f2 = cfg.conv_features
    flat = (cfg.image_size // 4) * (cfg.image_size // 4) * f2

    def normal(shape, scale):
        return scale * torch.randn(shape, generator=generator, device=dev)

    return {
        "bn1.bias": torch.zeros(f1, device=dev),
        "bn1.scale": torch.ones(f1, device=dev),
        "bn2.bias": torch.zeros(f2, device=dev),
        "bn2.scale": torch.ones(f2, device=dev),
        "conv1": normal((3, 3, cfg.channels, f1), 0.1),
        "conv2": normal((3, 3, f1, f2), 0.1),
        "fc1": normal((flat, cfg.hidden), 0.05),
        "fc1_b": torch.zeros(cfg.hidden, device=dev),
        "fc2": normal((cfg.hidden, cfg.n_classes), 0.05),
        "fc2_b": torch.zeros(cfg.n_classes, device=dev),
    }


def _block(x, w_hwio, scale, bias, eps=1e-5):
    """3x3 SAME conv -> batch norm -> ReLU -> 2x2 max pool, NCHW."""
    x = F.conv2d(x, w_hwio.permute(3, 2, 0, 1), padding=1)
    mu = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), correction=0, keepdim=True)
    x = ((x - mu) * torch.rsqrt(var + eps) * scale[None, :, None, None]
         + bias[None, :, None, None])
    return F.max_pool2d(F.relu(x), 2, 2)


def cnn_forward(params: Params, images: torch.Tensor) -> torch.Tensor:
    """images: [B, H, W, C] -> logits [B, n_classes]."""
    x = images.permute(0, 3, 1, 2)
    x = _block(x, params["conv1"], params["bn1.scale"], params["bn1.bias"])
    x = _block(x, params["conv2"], params["bn2.scale"], params["bn2.bias"])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten
    x = F.relu(x @ params["fc1"] + params["fc1_b"])
    return x @ params["fc2"] + params["fc2_b"]


def xent_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lp = torch.log_softmax(logits, dim=-1)
    return -lp.gather(-1, labels.long()[:, None]).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()
