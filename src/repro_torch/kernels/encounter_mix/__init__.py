"""encounter_mix: the fused peer-encounter mix (CUDA kernel, plain version)."""
from repro_torch.kernels.encounter_mix.ops import encounter_mix  # noqa: F401
from repro_torch.kernels.encounter_mix.ref import (  # noqa: F401
    encounter_block, encounter_gate, encounter_mix_reference, normalize_mix)
