"""flash_attention: blockwise GQA attention (CUDA kernels for the forward,
plain versions, the reference's blockwise backward)."""
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    flash_backward, flash_reference, mha_reference)
