"""encounter_mix: the fused peer-encounter mix, single-lane and lane-batched,
and its ring hop (CUDA kernels, plain versions)."""
from repro_torch.kernels.encounter_mix.ops import (  # noqa: F401
    encounter_block_hop, encounter_mix, encounter_mix_lanes,
    encounter_mix_op, encounter_pairs)
from repro_torch.kernels.encounter_mix.ref import (  # noqa: F401
    encounter_block, encounter_gate, encounter_mix_lanes_reference,
    encounter_mix_reference, encounter_pairs_reference, normalize_mix,
    unpack_pairs)
