"""slstm_scan: the sequential sLSTM recurrence (CUDA kernel, plain version)."""
from repro_torch.kernels.slstm_fused.ops import slstm_scan  # noqa: F401
from repro_torch.kernels.slstm_fused.ref import slstm_reference  # noqa: F401
