"""The paper's LSTM-CNN for IMU human-activity recognition (Sec 4.3.1).

"To handle sequential IMU data, we employ an LSTM-CNN model structure, which
is well-established in HAR research [47]" (Xia et al. 2020: conv1d blocks over
the 50 Hz window followed by LSTM layers and a dense classifier).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class LSTMCNNConfig:
    name: str = "mule-lstm-cnn"
    window: int = 128          # 50 Hz IMU samples per window
    channels: int = 6          # 3-axis accel + 3-axis gyro
    conv_features: Tuple[int, int] = (32, 64)
    lstm_hidden: int = 64
    n_classes: int = 4         # Bike Repair / Cooking / Dance / Music (Table 2)
    source = "[paper Sec 4.3.1, Xia et al. 2020]"


CONFIG = LSTMCNNConfig()


def smoke_config() -> LSTMCNNConfig:
    return LSTMCNNConfig(name="mule-lstm-cnn-smoke", window=32,
                         conv_features=(8, 16), lstm_hidden=16, n_classes=4)
