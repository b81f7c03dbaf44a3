"""ssd_scan: the chunked Mamba2/SSD scan (CUDA kernel, plain versions), and
its differentiable, vmappable form ``ssd_scan_op``."""
from repro_torch.kernels.ssm_scan.ops import (  # noqa: F401
    ssd_scan, ssd_scan_op)
from repro_torch.kernels.ssm_scan.ref import (  # noqa: F401
    ssd_chunked_reference, ssd_reference)
