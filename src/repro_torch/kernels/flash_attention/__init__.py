"""flash_attention: blockwise GQA attention forward (CUDA kernel, plain versions)."""
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    flash_reference, mha_reference)
