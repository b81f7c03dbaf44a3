"""Checkpoints of parameter trees (port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    latest_checkpoint, restore_checkpoint, save_checkpoint)
