"""Models of the port: the paper's CNN and the dense-attention LM stack."""
from repro_torch.models.api import Model, build_model  # noqa: F401
from repro_torch.models.cnn import (  # noqa: F401
    accuracy, cnn_forward, init_cnn, xent_loss)
