"""Port's flash attention (plain versions and wrapper) against the JAX package.

Inputs come from a numpy seed and go to both packages (bf16 inputs are the
same f32 numbers rounded once in each). Tolerances are the JAX package's
own for this kernel (tests/test_kernels_flash.py): 1e-5 in f32 (fp32 sums
in another order), 3e-2 in bf16 (one bf16 ulp of the output where the two
fp32 results round to different sides), 2e-5 against the Pallas kernel in
interpret mode.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import flash_reference as j_flash  # noqa: E402
from repro.kernels.flash_attention.ref import mha_reference as j_mha  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_reference,
                                                 mha_reference)
from repro_torch.kernels.flash_attention.ops import (TC_HEAD_DIMS,  # noqa: E402
                                                     tc_route)

torch.set_num_threads(1)

# tests/test_kernels_flash.py's cases: b, s, h, kv, d, window, causal
CASES = [
    (2, 128, 4, 2, 32, None, True),
    (1, 200, 4, 4, 16, None, True),       # ragged seq vs blocks
    (2, 256, 8, 2, 32, 64, True),         # sliding window
    (1, 128, 4, 2, 32, None, False),      # bidirectional (encoder)
    (2, 96, 4, 1, 64, 48, True),          # MQA + window
    (1, 64, 2, 2, 8, 16, True),           # tiny window
]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _inputs(b, s, h, kv, d, sk=None, seed=0):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, sk, kv, d)).astype(np.float32),
            rng.normal(size=(b, sk, kv, d)).astype(np.float32))


def _both(arrays, jdt, tdt):
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_versions_match_jax(case, dtype):
    b, s, h, kv, d, win, causal = case
    jdt, tdt, tol = DTYPES[dtype]
    (jq, jk, jv), (q, k, v) = _both(_inputs(b, s, h, kv, d), jdt, tdt)
    want_mha = j_mha(jq, jk, jv, causal=causal, window=win)
    want_flash = j_flash(jq, jk, jv, causal=causal, window=win,
                         block_q=64, block_k=64)
    got_mha = mha_reference(q, k, v, causal=causal, window=win)
    got_flash = flash_reference(q, k, v, causal=causal, window=win,
                                block_q=64, block_k=64)
    got_auto = flash_attention(q, k, v, causal=causal, window=win)
    for got in (got_mha, got_flash, got_auto):
        assert got.dtype == tdt and tuple(got.shape) == (b, s, h, d)
    _close(got_mha, want_mha, tol)
    _close(got_flash, want_flash, tol)
    # the chunked versions against the oracle, as the JAX test holds them
    _close(got_flash, want_mha, tol)
    _close(got_auto, want_mha, tol)


@pytest.mark.parametrize("case", CASES)
def test_plain_versions_match_pallas_interpret(case):
    b, s, h, kv, d, win, causal = case
    (jq, jk, jv), (q, k, v) = _both(_inputs(b, s, h, kv, d), jnp.float32,
                                    torch.float32)
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=win,
                                  block_q=64, block_k=64, interpret=True)
    for got in (mha_reference(q, k, v, causal=causal, window=win),
                flash_attention(q, k, v, causal=causal, window=win)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_decode_alignment():
    """Right-aligned queries (q shorter than k) match the oracle."""
    b, sq, sk, h, kv, d = 2, 4, 64, 4, 2, 16
    (jq, jk, jv), (q, k, v) = _both(_inputs(b, sq, h, kv, d, sk=sk, seed=3),
                                    jnp.float32, torch.float32)
    want = j_mha(jq, jk, jv, causal=True)
    for got in (flash_reference(q, k, v, causal=True, block_q=4, block_k=16),
                flash_attention(q, k, v, causal=True),
                mha_reference(q, k, v, causal=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_cpu_tensors_take_the_plain_path():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 32, 4, 2, 16))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, window=8)
    assert flash_attention.launches == before
    torch.testing.assert_close(out, flash_reference(
        q, k, v, causal=True, window=8, block_q=256, block_k=256))
    torch.testing.assert_close(out, flash_attention(q, k, v, causal=True,
                                                    window=8, backend="ref"))


def test_flash_attention_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :12], k[..., :12], v[..., :12])
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="backend"):
        flash_attention(q, k, v, backend="pallas")
    assert "flash_attention" in _build.SOURCES


def test_causal_call_with_more_queries_than_keys_raises():
    """Right-aligned, the first S - Sk queries of such a call see no key;
    the model never makes one, so the wrapper refuses it on every route."""
    q, _, _ = (torch.from_numpy(a) for a in _inputs(1, 8, 4, 2, 16))
    _, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 4, 2, 16))
    for backend in ("auto", "ref"):
        with pytest.raises(ValueError, match="S <= Sk"):
            flash_attention(q, k, v, causal=True, backend=backend)
        with pytest.raises(ValueError, match="S <= Sk"):
            flash_attention(q, k, v, causal=True, window=2, backend=backend)
    out = flash_attention(q, k, v, causal=False)
    np.testing.assert_allclose(out.numpy(), mha_reference(
        q, k, v, causal=False).numpy(), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_matches_plain_on_card(cuda_device, dtype):
    """The CUDA kernels against the oracle on the cases above, the decode
    alignment case, two windowed cases where a row's first visited key
    block (64 keys) is fully masked for that row, the head dims 80, 128 and
    256, and non-contiguous (sliced) q, k, v. bf16 at head dims 64, 80, 128
    and 256 must take the tensor-core kernel (``tc_launches``), every other
    call the SIMT one."""
    _, tdt, tol = DTYPES[dtype]
    shapes = [(b, s, h, kv, d, s, win, causal)
              for b, s, h, kv, d, win, causal in CASES]
    shapes += [(2, 4, 4, 2, 16, 64, None, True),
               (1, 256, 2, 2, 8, 256, 16, True),
               (2, 300, 4, 1, 64, 300, 48, True),
               (1, 200, 4, 2, 128, 200, None, True),
               (2, 130, 4, 4, 80, 130, None, True),
               (1, 200, 2, 1, 80, 200, 70, True),
               (1, 300, 2, 1, 256, 300, 100, True)]
    for b, s, h, kv, d, sk, win, causal in shapes:
        q, k, v = (torch.from_numpy(a).to(cuda_device, tdt)
                   for a in _inputs(b, s, h, kv, d, sk=sk))
        before = (flash_attention.launches, flash_attention.tc_launches)
        out = flash_attention(q, k, v, causal=causal, window=win)
        torch.cuda.synchronize()
        tc = int(tdt == torch.bfloat16 and d in TC_HEAD_DIMS)
        assert (flash_attention.launches - before[0],
                flash_attention.tc_launches - before[1]) == (1, tc)
        want = mha_reference(q, k, v, causal=causal, window=win)
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=tol)
    q, k, v = (torch.from_numpy(a).to(cuda_device, tdt)
               for a in _inputs(1, 8, 4, 2, 16, sk=4))
    with pytest.raises(ValueError, match="S <= Sk"):
        flash_attention(q, k, v, causal=True)
    wide = torch.randn(2, 40, 8, 64, device=cuda_device).to(tdt)
    q, k, v = wide[:, :, :4], wide[:, :, 4:6], wide[:, :, 6:]
    before = flash_attention.tc_launches
    torch.testing.assert_close(
        flash_attention(q, k, v, causal=True).float(),
        mha_reference(q, k, v, causal=True).float(), atol=tol, rtol=tol)
    assert flash_attention.tc_launches - before == int(tdt == torch.bfloat16)


def _chip_smoke_constants():
    """chip_smoke.py (the repo root's card check, stdlib imports only) holds
    the bf16 bounds the card run applies; the emulation is held to the same
    objects."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_consts", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tc_emulate(q, k, v, *, causal, window, split=True):
    """The tensor-core kernel's arithmetic in plain torch on the CPU
    (csrc/flash_attention_tc.cu): bf16 inputs; per tile of 64 queries the
    key blocks of 64 in [lo, hi) that the kernel visits; fp32 scores of the
    exact bf16 products with scale * log2(e) applied after the product;
    -1e30 for masked pairs; an online softmax in exp2; p split into bf16
    hi + lo (or, with ``split=False``, rounded once to bf16) and each part's
    product with v summed in fp32; o / max(l, 1e-30) rounded once to
    bf16."""
    b, s, h, d = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    scale_log2 = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) \
        * torch.tensor(math.log2(math.e), dtype=torch.float32)
    heads = torch.arange(h) // (h // n_kv)
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3)[:, heads]
    vf = v.float().permute(0, 2, 1, 3)[:, heads]
    out = torch.empty(b, h, s, d)
    nk = -(-sk // 64)
    for row0 in range(0, s, 64):
        q_start = row0 + sk - s
        hi = nk if not causal else min(nk, max(0, -(-(q_start + 64) // 64)))
        t = q_start - window - 64 if window else -1
        lo = 0 if t < 0 else t // 64 + 1
        qt = qf[:, :, row0:row0 + 64]
        qpos = (q_start + torch.arange(qt.shape[2]))[:, None]
        m = torch.full(qt.shape[:3] + (1,), -1e30)
        l = torch.zeros_like(m)
        o = torch.zeros_like(qt)
        for k0 in range(lo * 64, hi * 64, 64):
            kb, vb = kf[:, :, k0:k0 + 64], vf[:, :, k0:k0 + 64]
            sc = (qt @ kb.transpose(-1, -2)) * scale_log2
            kpos = (k0 + torch.arange(kb.shape[2]))[None, :]
            ok = torch.ones_like(sc, dtype=torch.bool)
            if causal:
                ok = ok & (kpos <= qpos)
            if window:
                ok = ok & (kpos > qpos - window)
            sc = torch.where(ok, sc, torch.tensor(-1e30))
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(sc - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            p_hi = p.bfloat16().float()
            o = o * corr + p_hi @ vb
            if split:
                o = o + (p - p_hi).bfloat16().float() @ vb
            m = m_new
        out[:, :, row0:row0 + 64] = o / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3).bfloat16()


# the JAX tests' cases, gemma3-4b's width (D = 256, GQA 8:4) at S = 512 and
# Whisper's encoder call
EMULATED = CASES + [(1, 512, 8, 4, 256, None, True),
                    (1, 512, 8, 4, 256, 128, True),
                    # Whisper's encoder call: bidirectional, S = 1500 not a
                    # multiple of the 64-key blocks, group 1
                    (1, 1500, 8, 8, 64, None, False)]


def _worst_vs_f32_oracle(case, split):
    """The emulated kernel's bf16 output against the JAX package's fp32
    mha_reference on the same bf16-valued inputs: the largest
    |err| / (atol + rtol |want|) under chip_smoke.py's FLASH_BF16_VS_F32."""
    b, s, h, kv, d, win, causal = case
    atol, rtol = _chip_smoke_constants().FLASH_BF16_VS_F32
    arrays = [torch.from_numpy(a).bfloat16() for a in _inputs(b, s, h, kv, d)]
    want = np.asarray(j_mha(*[jnp.asarray(a.float().numpy()) for a in arrays],
                            causal=causal, window=win), np.float32)
    got = _tc_emulate(*arrays, causal=causal, window=win, split=split)
    return float((np.abs(got.float().numpy() - want)
                  / (atol + rtol * np.abs(want))).max())


@pytest.mark.parametrize("case", EMULATED)
def test_tensor_core_arithmetic_meets_the_bf16_bound(case):
    """The kernel's arithmetic, with p split into bf16 hi + lo, holds the
    card run's bound against the fp32 oracle (half a bf16 ulp of the
    output, bound at twice that) at every case: the worst ratio to the
    bound reads 0.483-0.495, the final rounding's half ulp. With p rounded
    once to bf16, as FlashAttention-2/3 and SDPA do, the same cases read
    45.3-95.2: 2^-9 of each p.v term exceeds the bound where v's signs
    cancel and the output is near 0."""
    assert _worst_vs_f32_oracle(case, split=True) <= 1.0


def test_single_bf16_p_misses_the_bound():
    """Why the split: rounding p once misses the bound at gemma3-4b's
    width, causal, no window."""
    assert _worst_vs_f32_oracle(EMULATED[-2], split=False) > 1.0


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 80, True),
    (torch.bfloat16, 128, True), (torch.bfloat16, 256, True),
    (torch.bfloat16, 8, False), (torch.bfloat16, 16, False),
    (torch.bfloat16, 32, False), (torch.float32, 64, False),
    (torch.float32, 80, False), (torch.float32, 256, False)])
def test_route_by_dtype_and_head_dim(dtype, d, want):
    """bf16 at head dims 64, 80, 128, 256 takes the tensor-core kernel;
    float32 and the small bf16 head dims the SIMT one, whatever their
    alignment (the SIMT kernel reads any layout)."""
    aligned = ((4096, 4096 + 512, 8192), (8 * d * 64, 8 * d, d) * 3)
    assert tc_route(dtype, d, *aligned) is want
    if not want:
        assert tc_route(dtype, d, (4098, 4096, 4096), (d, d, 3) * 3) is False


@pytest.mark.parametrize("ptrs,strides", [
    ((4096 + 8, 4096, 4096), (2048, 256, 64) * 3),     # q's base, 8 B off
    ((4096, 4096, 4096 + 2), (2048, 256, 64) * 3),     # v's base, 2 B off
    ((4096, 4096, 4096), (2048, 256, 68) * 3),         # h stride 136 B
    ((4096, 4096, 4096), (2048, 260, 64) + (2048, 256, 64) * 2),
    ((4096, 4096, 4096), (2048, 256, 64) * 2 + (2044, 256, 64))])
def test_route_raises_where_the_tensor_core_kernel_cannot_load(ptrs, strides):
    """A bf16 call at a tensor-core head dim whose base or (b, s, h) stride
    is not a multiple of 16 bytes raises: it does not go to the SIMT
    kernel instead."""
    with pytest.raises(ValueError, match="16-byte"):
        tc_route(torch.bfloat16, 64, ptrs, strides)
    assert tc_route(torch.float32, 64, ptrs, strides) is False


def test_route_of_model_and_sliced_layouts():
    """The models' q, k, v (reshapes of contiguous GEMM outputs, D = 80 at
    zamba2's 160-byte rows) and heads sliced out of one tensor (offsets of
    512 and 768 bytes) take the tensor-core kernel; a base one element off
    raises."""
    def route(q, k, v):
        return tc_route(q.dtype, q.shape[-1],
                        [t.data_ptr() for t in (q, k, v)],
                        [st for t in (q, k, v) for st in t.stride()[:3]])

    for d in TC_HEAD_DIMS:
        q, k, v = (torch.zeros(2, 16, n * d, dtype=torch.bfloat16)
                   .reshape(2, 16, n, d) for n in (8, 4, 4))
        assert route(q, k, v)
    wide = torch.zeros(2, 40, 8, 64, dtype=torch.bfloat16)
    assert route(wide[:, :, :4], wide[:, :, 4:6], wide[:, :, 6:])
    flat = torch.zeros(2 * 16 * 4 * 64 + 1, dtype=torch.bfloat16)
    off = flat[1:].view(2, 16, 4, 64)
    with pytest.raises(ValueError, match="16-byte"):
        route(off, off, off)


def test_cpu_calls_leave_the_counts_alone():
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _inputs(1, 64, 4, 2, 64))
    before = (flash_attention.launches, flash_attention.tc_launches)
    flash_attention(q, k, v, causal=True)
    assert (flash_attention.launches, flash_attention.tc_launches) == before


def test_tensor_core_source_is_built_with_the_others():
    src = Path(_build.__file__).resolve().parent.parent / _build.SOURCES[
        "flash_attention_tc"]
    assert src.is_file() and "wgmma.mma_async" in src.read_text()
