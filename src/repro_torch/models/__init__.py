"""Models of the port: the paper's CNN and LSTM-CNN, and the LM stack."""
from repro_torch.models.api import Model, build_model  # noqa: F401
from repro_torch.models.cnn import (  # noqa: F401
    accuracy, cnn_forward, init_cnn, init_lstm_cnn, lstm_cnn_forward,
    xent_loss)
