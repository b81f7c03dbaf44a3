"""ssd_scan: the chunked Mamba2/SSD scan (CUDA kernel, plain versions)."""
from repro_torch.kernels.ssm_scan.ops import ssd_scan  # noqa: F401
from repro_torch.kernels.ssm_scan.ref import (  # noqa: F401
    ssd_chunked_reference, ssd_reference)
