"""mule_agg: the dwell-weighted group mean A @ W (CUDA kernel + plain version),
single-lane and lane-batched."""
from repro_torch.kernels.mule_agg.ops import (  # noqa: F401
    mule_agg, mule_agg_lanes, mule_agg_op)
from repro_torch.kernels.mule_agg.ref import (  # noqa: F401
    mule_agg_lanes_plain, mule_agg_plain)
