"""encounter_mix: the fused peer-encounter mix and its ring hop (CUDA
kernels, plain versions)."""
from repro_torch.kernels.encounter_mix.ops import (  # noqa: F401
    encounter_block_hop, encounter_mix, encounter_pairs)
from repro_torch.kernels.encounter_mix.ref import (  # noqa: F401
    encounter_block, encounter_gate, encounter_mix_reference,
    encounter_pairs_reference, normalize_mix, unpack_pairs)
