"""One dtype-width table for the cost count and the roofline.

Port of ``repro.launch.dtypes``. The reference keys its table by the HLO
element-type names its parsers read (``f32``, ``bf16``, ``s32``, ``pred``,
...); the port counts ``torch.dtype``s, so ``dtype_bytes`` takes either: a
``torch.dtype`` is mapped to its HLO name through ``TORCH_DTYPE_NAMES``
and then looked up in the same ``DTYPE_BYTES`` table, so the two packages
charge every dtype the same width. As in the reference an unknown dtype is
loud: ``dtype_bytes`` raises :class:`UnknownDtypeError`, or, given a
``collect`` set, records it there and charges 4 bytes so that a whole count
can report every unknown at once.
"""
from __future__ import annotations

from typing import Optional, Set, Union

import torch

# Width in bytes of every HLO element type the reference's analyzers
# understand (the reference's table, whole). Sub-byte types are charged
# one byte, as HLO buffers round them up.
DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
    "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
    "f8e4m3": 1, "f8e4m3fn": 1, "f8e4m3fnuz": 1, "f8e4m3b11fnz": 1,
    "f8e5m2": 1, "f8e5m2fnuz": 1, "f8e3m4": 1, "f8e8m0fnu": 1,
    "token": 0,   # sequencing tokens carry no data
}

# The HLO name of each torch dtype that has one.
TORCH_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.uint16: "u16", torch.bfloat16: "bf16",
    torch.float16: "f16", torch.int32: "s32", torch.uint32: "u32",
    torch.float32: "f32", torch.int64: "s64", torch.uint64: "u64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e4m3fnuz: "f8e4m3fnuz",
    torch.float8_e5m2: "f8e5m2", torch.float8_e5m2fnuz: "f8e5m2fnuz",
}
if hasattr(torch, "float8_e8m0fnu"):
    TORCH_DTYPE_NAMES[torch.float8_e8m0fnu] = "f8e8m0fnu"


class UnknownDtypeError(ValueError):
    """A dtype missing from :data:`DTYPE_BYTES` (or, for a ``torch.dtype``,
    from :data:`TORCH_DTYPE_NAMES`)."""

    def __init__(self, dtype):
        self.dtype = dtype
        super().__init__(
            f"unknown dtype {dtype!r}: add it to repro_torch.launch.dtypes "
            f"(a silent f32 fallback would skew every roofline term)")


def dtype_name(dtype: Union[str, torch.dtype],
               collect: Optional[Set] = None) -> str:
    """The HLO name of ``dtype`` (a name is returned as it is); an unknown
    ``torch.dtype`` raises, or with ``collect`` is recorded and named by
    its ``str``."""
    if isinstance(dtype, str):
        return dtype
    name = TORCH_DTYPE_NAMES.get(dtype)
    if name is None:
        if collect is None:
            raise UnknownDtypeError(dtype)
        collect.add(dtype)
        return str(dtype)
    return name


def dtype_bytes(dtype: Union[str, torch.dtype],
                collect: Optional[Set] = None) -> int:
    """Bytes per element of a ``torch.dtype`` or an HLO dtype name.

    Raises :class:`UnknownDtypeError` for a dtype not in the tables; with a
    ``collect`` set, unknowns are recorded there and charged 4 bytes.
    """
    name = dtype_name(dtype, collect)
    width = DTYPE_BYTES.get(name)
    if width is None:
        if collect is None:
            raise UnknownDtypeError(dtype)
        collect.add(dtype)
        return 4
    return width
