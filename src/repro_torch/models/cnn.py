"""The paper's task models as plain functions on a dict of tensors.

- ``CNN`` (Sec 4.2.1): two conv blocks (3x3 conv, batch norm, ReLU, 2x2
  max pool) + a two-layer FC classifier — CIFAR-100 super-class task.
- ``LSTM-CNN`` (Sec 4.3.1, Xia et al. 2020): two strided 1-D conv blocks
  over the IMU window followed by an LSTM and a dense classifier — HAR.

Parameters keep the reference's layouts and key paths: conv weights HWIO
(WIO in 1-D), dense weights ``[in, out]``, images NHWC and IMU windows
``[B, T, C]`` at the boundary. The forwards permute to PyTorch's channel-
first layouts inside and back before any flatten, so the same weights
give the same logits.

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
from repro_torch.configs.mule_lstm_cnn import LSTMCNNConfig

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


def init_lstm_cnn(generator: torch.Generator, cfg: LSTMCNNConfig) -> Params:
    """Random weights on ``generator``'s device: ``scale * N(0, 1)``."""
    dev = generator.device
    f1, f2 = cfg.conv_features
    h = cfg.lstm_hidden

    def normal(shape, scale):
        return scale * torch.randn(shape, generator=generator, device=dev)

    return {
        "conv1": normal((5, cfg.channels, f1), 0.1),
        "conv1_b": torch.zeros(f1, device=dev),
        "conv2": normal((5, f1, f2), 0.1),
        "conv2_b": torch.zeros(f2, device=dev),
        "fc": normal((h, cfg.n_classes), 0.05),
        "fc_b": torch.zeros(cfg.n_classes, device=dev),
        "lstm_b": torch.zeros(4 * h, device=dev),
        "lstm_wh": normal((h, 4 * h), 0.08),
        "lstm_wx": normal((f2, 4 * h), 0.08),
    }


def same_pad(length: int, kernel: int, stride: int):
    """XLA's ``SAME`` padding (left, right): the output has
    ``ceil(length / stride)`` positions and the odd pad goes right."""
    total = max((-(-length // stride) - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


def _conv1d(x, w_wio, b, stride):
    """x: [B, C, T] -> [B, O, ceil(T / stride)], SAME, WIO weights."""
    x = F.pad(x, same_pad(x.shape[-1], w_wio.shape[0], stride))
    return F.conv1d(x, w_wio.permute(2, 1, 0), b, stride=stride)


def lstm_cnn_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: [B, T, C] IMU window -> logits [B, n_classes].

    The LSTM runs as a Python loop over the T/4 conv positions (the
    reference's ``lax.scan``); the input projection of every step is one
    matmul before it. Gates split as ``i, f, g, o`` with +1 on the forget
    gate.
    """
    h1 = F.relu(_conv1d(x.transpose(1, 2), params["conv1"],
                        params["conv1_b"], 2))
    h2 = F.relu(_conv1d(h1, params["conv2"], params["conv2_b"], 2))
    xw = h2.transpose(1, 2) @ params["lstm_wx"]             # [B, T/4, 4h]
    hidden = params["lstm_wh"].shape[0]
    h = c = xw.new_zeros((xw.shape[0], hidden))
    for t in range(xw.shape[1]):
        gates = xw[:, t] + h @ params["lstm_wh"] + params["lstm_b"]
        i, f, g, o = gates.split(hidden, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
    return h @ params["fc"] + params["fc_b"]


def xent_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lp = torch.log_softmax(logits, dim=-1)
    return -lp.gather(-1, labels.long()[:, None]).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()
