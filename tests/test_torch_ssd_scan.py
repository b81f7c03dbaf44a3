"""Port's SSD scan (plain versions and wrapper) against the JAX package.

Inputs come from a numpy seed and go to both packages. The cases are
tests/test_kernels_ssm.py's four, a ragged case at zamba2's P = N = 64 and
chunk 64, and one whose A spans zamba2's (-1 .. -80) and sends cum to about
-3,500 within a chunk. Tolerances:

- outputs reach ~100 at these inputs, where an f32 ulp is 7.6e-6; final
  states stay under ~10 and are held to 2e-5 throughout;
- the port's sequential oracle against JAX's 5e-5 (the same products and
  sums a step; measured 1.1e-5);
- the port's chunked version against JAX's, and against JAX's sequential
  oracle, 3e-4: the JAX package's own bound between its two forms
  (test_kernels_ssm.py; JAX's two differ by up to 1.5e-4 here);
- the wrapper (on the CPU, the chunked version) against the Pallas kernel
  in interpret mode 2e-4, the JAX package's bound for that kernel;
- ``init_state`` carry and the split-scan handoff 1e-4, the JAX test's.

The kernel's grids and scratch (``ssd_geometry``) are checked on the CPU:
every (batch row, head, state column) belongs to exactly one block of the
scan, as the kernel's own index arithmetic (emulated here) assigns them.

``cuda``-marked tests hold the kernel to its plain versions on the card and
skip without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssm_scan.kernel import ssd_scan_pallas  # noqa: E402
from repro.kernels.ssm_scan.ref import ssd_chunked_reference as j_chunked  # noqa: E402
from repro.kernels.ssm_scan.ref import ssd_reference as j_seq  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssm_scan import (ssd_chunked_reference,  # noqa: E402
                                          ssd_reference, ssd_scan)
from repro_torch.kernels.ssm_scan.ops import SLICE, ssd_geometry  # noqa: E402

torch.set_num_threads(1)

CASES = [
    # b, s, h, p, n, chunk (tests/test_kernels_ssm.py's)
    (2, 64, 3, 8, 16, 16),
    (1, 100, 2, 16, 8, 32),     # ragged
    (2, 128, 4, 32, 16, 64),
    (1, 33, 1, 4, 4, 8),
    (1, 77, 2, 64, 64, 64),     # zamba2's P, N and chunk, ragged
    (2, 150, 3, 40, 24, 64),    # ragged S; P and N not multiples of a slice
    (3, 77, 5, 24, 12, 16),     # B = 3, ragged
]


def _mk(b, s, h, p, n, seed=0, zamba_a=False):
    """x, dt, A, B, C as numpy f32 (the JAX test's distributions)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p))
    dt = np.logaddexp(rng.normal(size=(b, s, h)), 0.0)     # softplus
    a = -np.arange(1, h + 1) * 80.0 / h if zamba_a \
        else -np.exp(rng.normal(size=h))
    bm = rng.normal(size=(b, s, n))
    cm = rng.normal(size=(b, s, n))
    return [t.astype(np.float32) for t in (x, dt, a, bm, cm)]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.parametrize("case", CASES)
def test_plain_versions_match_jax(case):
    b, s, h, p, n, chunk = case
    arrays = _mk(b, s, h, p, n)
    jy_seq, js_seq = j_seq(*_j(arrays))
    jy_ch, js_ch = j_chunked(*_j(arrays), chunk=chunk)
    y_seq, s_seq = ssd_reference(*_t(arrays))
    y_ch, s_ch = ssd_chunked_reference(*_t(arrays), chunk=chunk)
    for y in (y_seq, y_ch):
        assert y.dtype == torch.float32 and tuple(y.shape) == (b, s, h, p)
    assert tuple(s_ch.shape) == (b, h, p, n)
    _close(y_seq, jy_seq, 5e-5)
    _close(y_ch, jy_ch, 3e-4)
    _close(y_ch, jy_seq, 3e-4)
    for got, want in ((s_seq, js_seq), (s_ch, js_ch), (s_ch, js_seq)):
        _close(got, want, 2e-5)


@pytest.mark.parametrize("case", CASES)
def test_wrapper_matches_pallas_interpret(case):
    """On a CPU tensor the wrapper takes the chunked plain version, which
    holds the TPU kernel (interpret mode) to the JAX test's 2e-4."""
    b, s, h, p, n, chunk = case
    arrays = _mk(b, s, h, p, n, seed=1)
    want, none = ssd_scan_pallas(*_j(arrays), chunk=chunk, interpret=True)
    assert none is None
    before = ssd_scan.launches
    y, state = ssd_scan(*_t(arrays), chunk=chunk)
    assert ssd_scan.launches == before          # CPU: the plain version
    _close(y, want, 2e-4)
    y_ref, s_ref = ssd_scan(*_t(arrays), chunk=chunk, backend="ref")
    torch.testing.assert_close(y, y_ref, atol=0, rtol=0)
    torch.testing.assert_close(state, s_ref, atol=0, rtol=0)


def test_zamba2_decay_stays_finite():
    """A = -(1..80): cum reaches about -3,500 within a chunk of 64, where
    exp of the unmasked upper triangle would be inf and inf * 0 NaN."""
    b, s, h, p, n, chunk = 1, 64, 80, 4, 4, 64
    arrays = _mk(b, s, h, p, n, seed=2, zamba_a=True)
    cum = np.cumsum(arrays[1] * arrays[2], axis=1)
    assert cum.min() < -3000
    y, state = ssd_chunked_reference(*_t(arrays), chunk=chunk)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())
    want, _ = j_seq(*_j(arrays))
    _close(y, want, 2e-4)
    _close(ssd_reference(*_t(arrays))[0], want, 2e-5)


def test_init_state_carry():
    b, s, h, p, n = 2, 48, 2, 8, 8
    arrays = _mk(b, s, h, p, n, seed=7)
    init = np.random.default_rng(9).normal(size=(b, h, p, n)) \
        .astype(np.float32)
    jy, js = j_seq(*_j(arrays), init_state=jnp.asarray(init))
    for fn in (ssd_reference, ssd_chunked_reference):
        kw = {} if fn is ssd_reference else {"chunk": 16}
        y, st = fn(*_t(arrays), init_state=torch.from_numpy(init), **kw)
        _close(y, jy, 1e-4)
        _close(st, js, 1e-4)
    y, st = ssd_scan(*_t(arrays), chunk=16, init_state=torch.from_numpy(init))
    _close(y, jy, 1e-4)
    _close(st, js, 1e-4)


def test_split_scan_equals_full():
    """Two halves with the state handed over equal one full scan (the
    prefill -> decode handoff), through the plain chunked version."""
    b, s, h, p, n = 1, 64, 2, 8, 8
    x, dt, a, bm, cm = _t(_mk(b, s, h, p, n, seed=11))
    y_full, s_full = ssd_reference(x, dt, a, bm, cm)
    half = s // 2
    y1, st = ssd_chunked_reference(x[:, :half], dt[:, :half], a,
                                   bm[:, :half], cm[:, :half], chunk=16)
    y2, s2 = ssd_chunked_reference(x[:, half:], dt[:, half:], a,
                                   bm[:, half:], cm[:, half:], chunk=16,
                                   init_state=st)
    _close(torch.cat([y1, y2], 1), y_full, 1e-4)
    _close(s2, s_full, 1e-4)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, dt, a, bm, cm = _t(_mk(1, 8, 2, 4, 4))
    with pytest.raises(TypeError, match="float32"):
        ssd_scan(x.double(), dt, a, bm, cm)
    with pytest.raises(TypeError, match="float32"):
        ssd_scan(x, dt.bfloat16(), a, bm, cm)
    with pytest.raises(ValueError, match="P=65"):
        ssd_scan(torch.zeros(1, 8, 2, 65), dt, a, bm, cm)
    with pytest.raises(ValueError, match="N=65"):
        ssd_scan(x, dt, a, torch.zeros(1, 8, 65), torch.zeros(1, 8, 65))
    for chunk in (0, 65, 128):
        with pytest.raises(ValueError, match="chunk"):
            ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    with pytest.raises(ValueError, match="match"):
        ssd_scan(x, dt[:, :4], a, bm, cm)
    with pytest.raises(ValueError, match="match"):
        ssd_scan(x, dt, a[:1], bm, cm)
    with pytest.raises(ValueError):
        ssd_scan(x, dt, a, bm, cm[..., :2])
    with pytest.raises(ValueError, match="backend"):
        ssd_scan(x, dt, a, bm, cm, backend="pallas")
    assert _build.SOURCES["ssd_scan"] == "kernels/ssm_scan/csrc/ssd_scan.cu"


@pytest.mark.parametrize("b,s,h,p,chunk", [(1, 1, 1, 1, 1), (2, 4096, 80,
                                           64, 64), (3, 150, 3, 40, 64),
                                           (2, 37, 2, 24, 1),
                                           (1, 100, 5, 33, 16),
                                           (4, 64, 2, 32, 64),
                                           (2, 65, 7, 63, 8),
                                           (1, 129, 1, 16, 64)])
def test_geometry_covers_every_state_column_once(b, s, h, p, chunk):
    """Block k of the scan takes slice k % slices of head (k // slices) % h
    of row k // (h slices), as csrc/ssd_scan.cu decodes blockIdx; every
    (b, h, p) falls in exactly one block."""
    geo = ssd_geometry(b, s, h, p, chunk)
    assert geo["slices"] == -(-p // SLICE)
    assert geo["grid"] == b * h * geo["slices"]
    assert geo["threads"] == 16 * (SLICE // 4)
    n_chunks = -(-s // chunk)
    assert geo["n_chunks"] == n_chunks and geo["prep_grid"] == (n_chunks, b)
    assert geo["tiles"] == (b, n_chunks, 3, 64, 64)
    assert geo["vecs"] == (b, n_chunks, h, 4, 64)
    seen = {}
    for k in range(geo["grid"]):
        sl, bh = k % geo["slices"], k // geo["slices"]
        row, head = bh // h, bh % h
        lo, hi = geo["columns"][sl]
        assert lo == sl * SLICE and hi - lo <= SLICE
        for col in range(lo, hi):
            assert (row, head, col) not in seen
            seen[(row, head, col)] = k
    assert set(seen) == {(i, j, c) for i in range(b) for j in range(h)
                         for c in range(p)}


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    """The CUDA kernel against the sequential oracle and the chunked plain
    version (2e-4, the JAX test's bound for the TPU kernel) on the cases
    above and on strided (non-contiguous) inputs, and its refusal of an
    init_state."""
    for b, s, h, p, n, chunk in CASES + [(3, 37, 2, 40, 24, 1)]:
        ts = [t.to(cuda_device) for t in _t(_mk(b, s, h, p, n))]
        before = ssd_scan.launches
        y, state = ssd_scan(*ts, chunk=chunk)
        torch.cuda.synchronize()
        assert ssd_scan.launches == before + 1 and state is None
        torch.testing.assert_close(y, ssd_reference(*ts)[0], atol=2e-4,
                                   rtol=0)
        torch.testing.assert_close(
            y, ssd_chunked_reference(*ts, chunk=chunk)[0], atol=2e-4, rtol=0)
    x, dt, a, bm, cm = (t.to(cuda_device) for t in _t(_mk(2, 40, 6, 8, 8)))
    xs, dts = x[:, :, ::2], dt[:, :, ::2]          # strided heads
    bcs = torch.cat([bm, cm], dim=-1)              # B, C as strided views
    args = (xs, dts, a[::2], bcs[..., :8], bcs[..., 8:])
    torch.testing.assert_close(ssd_scan(*args, chunk=16)[0],
                               ssd_reference(*args)[0], atol=2e-4, rtol=0)
    with pytest.raises(ValueError, match="init_state"):
        ssd_scan(x, dt, a, bm, cm, init_state=torch.zeros(2, 6, 8, 8,
                                                          device=cuda_device))
