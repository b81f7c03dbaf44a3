"""Baselines the paper compares against (Sec 4).

Federated (server-coordinated, time-coupled):
- ``fedavg``  — McMahan et al. [10]
- ``cfl``     — Clustered FL, Sattler et al. [11] (bipartition on update
                cosine similarity)
- ``fedas``   — personalized FL with shared-backbone alignment, Yang et al.
                [12] (simplified: shared feature extractor aggregated +
                aligned, personal classifier kept local)

Decentralized (device-to-device, space+time-coupled):
- ``gossip``  — Hegedűs et al. [5]: exchange-aggregate-train per encounter
- ``oppcl``   — Lee et al. [6]: exchange-train-exchange-aggregate

- ``local_only`` — no communication.
"""
from repro_torch.baselines.fedavg import fedavg_round  # noqa: F401
from repro_torch.baselines.cfl import CFLState, cfl_round  # noqa: F401
from repro_torch.baselines.fedas import fedas_round  # noqa: F401
from repro_torch.baselines.gossip import gossip_step  # noqa: F401
from repro_torch.baselines.local_only import local_step  # noqa: F401
from repro_torch.baselines.oppcl import oppcl_step  # noqa: F401
