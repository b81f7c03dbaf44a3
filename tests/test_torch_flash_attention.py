"""Port's flash attention (plain versions and wrapper) against the JAX package.

Inputs come from a numpy seed and go to both packages (bf16 inputs are the
same f32 numbers rounded once in each). Tolerances are the JAX package's
own for this kernel (tests/test_kernels_flash.py): 1e-5 in f32 (fp32 sums
in another order), 3e-2 in bf16 (one bf16 ulp of the output where the two
fp32 results round to different sides), 2e-5 against the Pallas kernel in
interpret mode.
"""
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
    """The CUDA kernel against the oracle on the cases above, the decode
    alignment case, two windowed cases where a row's first visited key
    block (64 keys) is fully masked for that row, the head dims 80, 128 and
    256, and non-contiguous (sliced) q, k, v."""
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
        before = flash_attention.launches
        out = flash_attention(q, k, v, causal=causal, window=win)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        want = mha_reference(q, k, v, causal=causal, window=win)
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=tol)
    q, k, v = (torch.from_numpy(a).to(cuda_device, tdt)
               for a in _inputs(1, 8, 4, 2, 16, sk=4))
    with pytest.raises(ValueError, match="S <= Sk"):
        flash_attention(q, k, v, causal=True)
    wide = torch.randn(2, 40, 8, 64, device=cuda_device).to(tdt)
    q, k, v = wide[:, :, :4], wide[:, :, 4:6], wide[:, :, 6:]
    torch.testing.assert_close(
        flash_attention(q, k, v, causal=True).float(),
        mha_reference(q, k, v, causal=True).float(), atol=tol, rtol=tol)
