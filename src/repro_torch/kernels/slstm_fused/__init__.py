"""slstm_scan: the sequential sLSTM recurrence (CUDA kernel, plain version),
and its differentiable, vmappable form ``slstm_scan_op``."""
from repro_torch.kernels.slstm_fused.ops import (  # noqa: F401
    slstm_scan, slstm_scan_op)
from repro_torch.kernels.slstm_fused.ref import slstm_reference  # noqa: F401
