"""Baselines of the paper's comparison: local-only and the peer-encounter
methods (gossip, OppCL)."""
from repro_torch.baselines.gossip import gossip_step  # noqa: F401
from repro_torch.baselines.local_only import local_step  # noqa: F401
from repro_torch.baselines.oppcl import oppcl_step  # noqa: F401
