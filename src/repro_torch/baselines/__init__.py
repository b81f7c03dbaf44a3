"""Baselines of the paper's comparison; the port has local-only so far."""
from repro_torch.baselines.local_only import local_step  # noqa: F401
