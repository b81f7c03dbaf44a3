"""The paper's lightweight CNN for the CIFAR-100 super-class task (Sec 4.2.1).

"a feature extractor with two convolutional blocks (3x3 convolution, batch
normalization, ReLU activation, and pooling) and a classifier with two fully
connected layers" — used by every fixed/mobile device in the ML Mule
simulations. Described by a small dict config (it is not a transformer).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str = "mule-cnn"
    image_size: int = 32
    channels: int = 3
    conv_features: Tuple[int, int] = (32, 64)
    hidden: int = 128
    n_classes: int = 20
    source = "[paper Sec 4.2.1]"


CONFIG = CNNConfig()


def smoke_config() -> CNNConfig:
    return CNNConfig(name="mule-cnn-smoke", image_size=16, conv_features=(8, 16), hidden=32, n_classes=4)
