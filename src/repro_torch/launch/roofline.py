"""What one H100 can do, and what each step and kernel of the port must do.

Port of ``repro.launch.roofline``. Three terms, in seconds, per step:

    compute    = sum over FLOP kinds of FLOPs / the card's peak for the kind
    memory     = bytes / the card's HBM rate
    collective = collective bytes / the host link's rate

The peaks are one NVIDIA H100 SXM's (NVIDIA's data sheet, dense rates,
at the full 700 W power limit): HBM3 at 3.35 TB/s; 67 TFLOP/s in float32
outside the tensor cores; on the tensor cores 495 TFLOP/s in TF32 and 989
TFLOP/s in bf16 and fp16 (1,979 in fp8 and int8; float64 67 on the tensor
cores, 34 outside). A card set below 700 W runs slower under load, so a
share of these peaks is stated beside the card's power limit.

Where the port departs from the reference:

- The reference prices every FLOP at one bf16 peak. The port's count keeps
  FLOPs by kind (``"mm:bf16"``, ``"conv:f32"``, ``"fma:f32"``: a matmul or
  convolution on its dtype, or a hand kernel's FMAs outside the tensor
  cores), and ``flop_rate`` prices each at its own peak. A float32 matmul
  or convolution is priced at the TF32 tensor peak whenever
  ``torch.backends.cuda.matmul.allow_tf32`` (matmul) or
  ``torch.backends.cudnn.allow_tf32`` (convolution, True by default)
  lets the library use TF32, since the term is a lower bound.
- The collective term's rate is the host link's, not an ICI link's: gloo
  stages every rank's collective through host memory on this card.
  ``HOST_LINK_BYTES_PER_S`` is PCIe Gen5 x16 per direction (63.0 GB/s after
  128b/130b coding), the H100 SXM's host link on NVIDIA's data sheet:
  ``nvidia-smi --query-gpu=pcie.link.gen.max,pcie.link.width.max`` answers
  ``[N/A]`` on the sandboxed H100 80GB HBM3 that ``chip_smoke.py`` runs on
  (phase 22 prints the query; ``query_host_link`` derives the rate where a
  card reports its link), so the data sheet is the source.
- A production-mesh row of the dry run (one rank of the reference's 16 x
  16 or 2 x 16 x 16 mesh of H100s, ``link="ib"``) prices its collective
  bytes at the rate between nodes of a DGX H100 instead:
  ``IB_LINK_BYTES_PER_S``, one 400 Gb/s NDR InfiniBand port per GPU, 50
  GB/s per direction (NVIDIA's DGX H100 data sheet: eight ConnectX-7
  ports of 400 Gb/s for eight GPUs). An axis of 16 ranks spans two 8-GPU
  NVLink nodes, so its collectives cross that link; the term prices every
  byte at it, a lower bound's rate for the slowest hop.
- ``analyze`` takes a ``launch.cost_analysis.CostCounter``, not a compiled
  XLA artifact.

The cost of each hand-written kernel (``mule_agg_work``,
``encounter_mix_work``, ``encounter_hop_work``, ``flash_attention_work``,
``ssd_work``, ``slstm_work``) counts what its bound in ``PERF.md``'s table
counts: each input read once and each output written once, and the
operations the data needs. ``cost_analysis`` prices every kernel call by
these, and ``chip_smoke.py`` prints its bounds from them.
"""
from __future__ import annotations

import dataclasses
import subprocess
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# One H100 SXM, NVIDIA's data sheet (dense rates, 700 W).
HBM_BYTES_PER_S = 3.35e12
CARD_MEMORY_BYTES = 80e9
FP32_FLOP_PER_S = 67e12              # float32 outside the tensor cores
FP64_FLOP_PER_S = 34e12
FP64_TENSOR_FLOP_PER_S = 67e12
TF32_TENSOR_FLOP_PER_S = 495e12
BF16_TENSOR_FLOP_PER_S = 989e12      # bf16 and fp16
FP8_TENSOR_FLOP_PER_S = 1979e12      # fp8, and int8 in TOP/s

# PCIe bytes per second per lane and direction, after line coding:
# generations 1-2 code 8b/10b, 3-5 128b/130b, 6 in 256-byte FLITs of 242
# payload bytes.
_PCIE_LANE = {1: 2.5e9 * 8 / 10 / 8, 2: 5e9 * 8 / 10 / 8,
              3: 8e9 * 128 / 130 / 8, 4: 16e9 * 128 / 130 / 8,
              5: 32e9 * 128 / 130 / 8, 6: 64e9 * 242 / 256 / 8}


def host_link_bytes_per_s(gen: int, width: int) -> float:
    """Bytes per second, one direction, of a PCIe link of ``gen`` x
    ``width``."""
    if gen not in _PCIE_LANE or width < 1:
        raise ValueError(f"no PCIe rate for generation {gen} x{width}")
    return _PCIE_LANE[gen] * width


HOST_LINK_GEN, HOST_LINK_WIDTH = 5, 16
HOST_LINK_BYTES_PER_S = host_link_bytes_per_s(HOST_LINK_GEN,
                                              HOST_LINK_WIDTH)


# One 400 Gb/s NDR InfiniBand port per GPU of a DGX H100, one direction.
IB_LINK_BYTES_PER_S = 400e9 / 8
LINK_BYTES_PER_S = {"host": HOST_LINK_BYTES_PER_S, "ib": IB_LINK_BYTES_PER_S}


def query_host_link() -> Tuple[str, Optional[float]]:
    """(``nvidia-smi``'s answer, bytes/s or None) for the card's host link
    at its maximum generation and width; None where the card does not
    report them (``[N/A]``). Needs a card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.max,pcie.link.width.max",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    line = out.stdout.splitlines()[0].strip()
    try:
        gen, width = (int(x) for x in line.split(","))
    except ValueError:
        return line, None
    return line, host_link_bytes_per_s(gen, width)


def flop_rate(kind: str, tf32_matmul: Optional[bool] = None,
              tf32_conv: Optional[bool] = None) -> float:
    """Peak FLOP/s of one kind of FLOP, ``"<unit>:<dtype>"``: ``mm`` and
    ``conv`` on the tensor cores where the dtype has them (float32 only
    where TF32 is allowed: the flags as they stand now, unless given),
    ``fma`` outside them."""
    unit, _, dt = kind.partition(":")
    if unit == "fma":
        return FP64_FLOP_PER_S if dt == "f64" else FP32_FLOP_PER_S
    if unit not in ("mm", "conv"):
        raise ValueError(f"unknown FLOP kind {kind!r}")
    if dt in ("bf16", "f16"):
        return BF16_TENSOR_FLOP_PER_S
    if dt.startswith("f8") or dt in ("s8", "u8"):
        return FP8_TENSOR_FLOP_PER_S
    if dt == "f64":
        return FP64_TENSOR_FLOP_PER_S
    if dt == "f32":
        if unit == "mm":
            tf32 = (torch.backends.cuda.matmul.allow_tf32
                    if tf32_matmul is None else tf32_matmul)
        else:
            tf32 = (torch.backends.cudnn.allow_tf32
                    if tf32_conv is None else tf32_conv)
        return TF32_TENSOR_FLOP_PER_S if tf32 else FP32_FLOP_PER_S
    return FP32_FLOP_PER_S


def compute_seconds(flops_by: Dict[str, float], **flags) -> float:
    """The compute term of FLOPs kept by kind."""
    return sum(n / flop_rate(k, **flags) for k, n in flops_by.items() if n)


# ---------------------------------------------------------------------------
# The hand-written kernels' work
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Work:
    """The bytes and operations one kernel call needs, and their kind."""
    n_bytes: int
    n_flop: int
    kind: str = "fma:f32"

    @property
    def t_bytes_ms(self) -> float:
        return self.n_bytes / HBM_BYTES_PER_S * 1e3

    @property
    def t_ops_ms(self) -> float:
        return self.n_flop / flop_rate(self.kind) * 1e3

    @property
    def bound_ms(self) -> float:
        """The least time the card could take: the larger term."""
        return max(self.t_bytes_ms, self.t_ops_ms)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.t_bytes_ms >= self.t_ops_ms else "operations"


def mule_agg_work(f: int, m: int, d: int, w_bytes: int = 4,
                  lanes: int = 1) -> Work:
    """A [F, M] f32 read, W [M, D] read and out [F, D] written once, in W's
    width; one multiply-add per (row, mule, column)."""
    return Work(lanes * (4 * f * m + w_bytes * m * d + w_bytes * f * d),
                2 * lanes * f * m * d)


def encounter_mix_work(m: int, d: int, nnz: int, w_bytes: int = 4,
                       lanes: int = 1) -> Work:
    """W read and the mix written once, the mass written and the geometry
    (pos f32 x 2, area int64, active bool) read once; one multiply-add per
    met pair and column (``nnz`` the pairs that met, over every lane)."""
    return Work(lanes * (2 * w_bytes * m * d + 4 * m + 17 * m), 2 * nnz * d)


def encounter_hop_work(r: int, v: int, d: int, nnz: int,
                       lanes: int = 1) -> Work:
    """One ring hop in f32: W_v read and acc written once, the mass written
    and both blocks' geometry read once; one multiply-add per met pair and
    column."""
    return Work(lanes * (4 * v * d + 4 * r * d + 4 * r + 17 * (r + v)),
                2 * nnz * d)


def unmasked_pairs(s: int, sk: int, window: Optional[int],
                   causal: bool) -> int:
    """(query, key) pairs the masks leave, for one batch row and head
    (right-aligned queries)."""
    qpos = np.arange(s, dtype=np.int64) + (sk - s)
    hi = np.minimum(qpos, sk - 1) if causal else np.full(s, sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(s, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_attention_work(b: int, s: int, sk: int, h: int, kv: int, d: int,
                         causal: bool, window: Optional[int],
                         dtype: torch.dtype) -> Work:
    """q, k, v read and out written once in their dtype; two products of
    2 D FLOP per unmasked (query, key) pair and head: on the tensor cores
    in bf16, in fp32 FMAs otherwise."""
    size = torch.tensor([], dtype=dtype).element_size()
    pairs = unmasked_pairs(s, sk, window, causal) * b * h
    kind = "mm:bf16" if dtype == torch.bfloat16 else "fma:f32"
    return Work(size * (2 * b * s * h * d + 2 * b * sk * kv * d),
                4 * d * pairs, kind)


def ssd_work(b: int, s: int, h: int, p: int, n: int) -> Work:
    """Each input read once and y written once; the least work of the
    scan's forms, the recurrence's, where each (batch row, head, step)
    takes one state update s = dA s + (dt x) Bᵀ and one read-out y = C s,
    2 P N FLOP each, and one exp for dA (the chunked form the kernel runs
    does more)."""
    return Work(4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * n),
                4 * b * h * s * p * n + b * h * s)


def slstm_work(b: int, s: int, h: int, p: int) -> Work:
    """pre [B, S, 4, H, P] and r [4, H, P, P] read and h [B, S, H, P]
    written once; the products h_{t-1} @ r of every step."""
    return Work(4 * (b * s * 4 * h * p + b * s * h * p + 4 * h * p * p),
                2 * b * s * 4 * h * p * p)


# ---------------------------------------------------------------------------
# Rows
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Roofline:
    """One (arch x shape x mesh) row. The terms price the work of the whole
    world against one card, which the ranks share."""
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_by: Dict[str, float]
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, float]
    peak_memory_bytes: Optional[float]
    model_flops: float
    link: str = "host"      # the collective term's rate: LINK_BYTES_PER_S

    @property
    def flops_per_device(self) -> float:
        return float(sum(self.flops_by.values()))

    @property
    def t_compute(self) -> float:
        return compute_seconds(self.flops_by)

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BYTES_PER_S

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / LINK_BYTES_PER_S[self.link]

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "flops_per_device": self.flops_per_device,
            "flops_by": dict(self.flops_by),
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "coll_breakdown": self.coll_breakdown,
            "peak_memory_gb": (self.peak_memory_bytes / 2**30
                               if self.peak_memory_bytes else None),
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "link": self.link,
        }


def analyze(arch: str, shape_name: str, mesh_name: str, chips: int,
            count, model_flops: float, link: str = "host") -> Roofline:
    """The row of a finished ``cost_analysis.CostCounter``."""
    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        flops_by=dict(count.flops_by), bytes_per_device=count.bytes,
        coll_bytes_per_device=count.coll_bytes,
        coll_breakdown={k: v for k, v in count.coll.items() if v},
        peak_memory_bytes=float(count.peak_live_bytes),
        model_flops=model_flops, link=link)


def model_flops_for(cfg, shape) -> float:
    """6·N·D train / 2·N·D prefill / 2·N·B decode (N = active params)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch
