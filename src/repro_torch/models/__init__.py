"""Task models of the port (the paper's CNN so far)."""
from repro_torch.models.cnn import (  # noqa: F401
    accuracy, cnn_forward, init_cnn, xent_loss)
