"""mule_agg: the dwell-weighted group mean A @ W (CUDA kernel + plain version)."""
from repro_torch.kernels.mule_agg.ops import mule_agg  # noqa: F401
from repro_torch.kernels.mule_agg.ref import mule_agg_plain  # noqa: F401
