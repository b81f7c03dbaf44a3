"""encounter_mix: the fused peer-encounter mix and its ring hop, single-lane
and lane-batched (CUDA kernels, plain versions)."""
from repro_torch.kernels.encounter_mix.ops import (  # noqa: F401
    encounter_block_hop, encounter_block_hop_lanes, encounter_hop_op,
    encounter_mix, encounter_mix_lanes, encounter_mix_op, encounter_pairs)
from repro_torch.kernels.encounter_mix.ref import (  # noqa: F401
    encounter_block, encounter_block_lanes_reference, encounter_gate,
    encounter_mix_lanes_reference, encounter_mix_reference,
    encounter_pairs_reference, normalize_mix, unpack_pairs)
