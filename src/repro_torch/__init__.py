"""ML Mule in PyTorch and CUDA: the port of ``repro`` to one NVIDIA H100.

The module layout mirrors ``repro``. Plain tensor code is PyTorch; the
reference's Pallas TPU kernels become kernels written by hand for Hopper
(``repro_torch.kernels``), built from the repository's sources on first
use. Entry points take ``device="cuda"`` and raise when no card is present
unless the caller passes ``device="cpu"``. This package never imports JAX
or ``repro``; ``repro_torch.interop`` carries the reference's state across
as numpy.
"""
