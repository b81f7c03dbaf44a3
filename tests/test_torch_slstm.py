"""Port's sLSTM scan (plain version and wrapper) against the JAX package.

Inputs come from a numpy seed and go to both packages. The cases are
tests/test_kernels_slstm.py's three (pre ~ N(0, 1), r ~ 0.1 N(0, 1)).
Tolerances:

- the plain version against JAX's plain version and against the Pallas
  kernel in interpret mode 2e-6, the JAX test's own bound (f32, the same
  products summed in another order; outputs |h| < 1); the final state
  (c and n grow to a few units over 33 steps) 1e-5;
- the state carry and the split scan 1e-6, the JAX test's;
- the wrapper on a CPU tensor equals the plain version bitwise (it is the
  plain version, and launches nothing).

The ``cuda``-marked test holds the kernel to the plain version on the card
and skips without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.slstm_fused.kernel import slstm_scan_pallas  # noqa: E402
from repro.kernels.slstm_fused.ref import slstm_reference as j_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.slstm_fused import (slstm_reference,  # noqa: E402
                                             slstm_scan)

torch.set_num_threads(1)

# b, s, h, p (tests/test_kernels_slstm.py's)
CASES = [(2, 24, 3, 8), (1, 7, 1, 4), (2, 33, 4, 16)]


def _mk(b, s, h, p, seed=0):
    """pre, r as numpy f32 (the JAX test's distributions)."""
    rng = np.random.default_rng(seed)
    pre = rng.normal(size=(b, s, 4, h, p))
    r = 0.1 * rng.normal(size=(4, h, p, p))
    return pre.astype(np.float32), r.astype(np.float32)


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_jax_and_pallas_interpret(case):
    arrays = _mk(*case)
    jpre, jr = (jnp.asarray(a) for a in arrays)
    jh, jstate = j_ref(jpre, jr)
    h, state = slstm_reference(*_t(arrays))
    assert h.dtype == torch.float32 and tuple(h.shape) == \
        (case[0], case[1], case[2], case[3])
    _close(h, jh, 2e-6)
    _close(h, slstm_scan_pallas(jpre, jr, interpret=True), 2e-6)
    assert sorted(state) == sorted(jstate)
    for key in state:
        _close(state[key], jstate[key], 1e-5)


@pytest.mark.parametrize("case", CASES)
def test_wrapper_takes_the_plain_version_on_cpu(case):
    pre, r = _t(_mk(*case, seed=1))
    before = slstm_scan.launches
    h = slstm_scan(pre, r)
    assert slstm_scan.launches == before        # CPU: the plain version
    torch.testing.assert_close(h, slstm_reference(pre, r)[0], atol=0, rtol=0)
    torch.testing.assert_close(h, slstm_scan(pre, r, backend="ref"), atol=0,
                               rtol=0)


def test_state_carry_matches_split_scan():
    """Scanning two halves with the state handed over equals one full scan
    (the JAX test's shapes), in the plain version and through the
    wrapper, and JAX's carried state gives the same second half."""
    pre, r = _mk(1, 16, 2, 8, seed=2)
    tpre, tr = _t((pre, r))
    h_full, _ = slstm_reference(tpre, tr)
    h1, st = slstm_reference(tpre[:, :8], tr)
    h2, _ = slstm_reference(tpre[:, 8:], tr, state=st)
    _close(torch.cat([h1, h2], dim=1), h_full, 1e-6)
    _close(slstm_scan(tpre[:, 8:], tr, state=st), h2, 0.0)
    _, jst = j_ref(jnp.asarray(pre[:, :8]), jnp.asarray(r))
    jh2, _ = j_ref(jnp.asarray(pre[:, 8:]), jnp.asarray(r), state=jst)
    _close(h2, jh2, 2e-6)


def test_first_step_and_float64_oracle():
    """From the zero state (m = -1e30) the first step's forget gate is 0
    and its input gate 1, so h_0 = sigmoid(o) tanh(z); float64 inputs stay
    float64 and agree with float32."""
    pre, r = _t(_mk(2, 5, 3, 8, seed=3))
    h, st = slstm_reference(pre, r)
    z, o = pre[:, 0, 0], pre[:, 0, 3]
    torch.testing.assert_close(h[:, 0], torch.sigmoid(o) * torch.tanh(z),
                               atol=1e-7, rtol=0)
    h64, st64 = slstm_reference(pre.double(), r.double())
    assert h64.dtype == torch.float64 and st64["m"].dtype == torch.float64
    _close(h, h64.float(), 2e-6)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    pre, r = _t(_mk(1, 4, 2, 8))
    with pytest.raises(ValueError, match="P=257"):
        slstm_scan(torch.zeros(1, 4, 4, 1, 257), torch.zeros(4, 1, 257, 257))
    with pytest.raises(TypeError, match="float32"):
        slstm_scan(pre.double(), r.double())
    with pytest.raises(TypeError, match="float32"):
        slstm_scan(pre, r.bfloat16())
    with pytest.raises(ValueError, match="does not match"):
        slstm_scan(pre, r[:, :1])
    with pytest.raises(ValueError, match="does not match"):
        slstm_scan(pre, r[..., :4])
    with pytest.raises(ValueError, match=r"\[B,S,4,H,P\]"):
        slstm_scan(pre[:, :, :3], r)
    with pytest.raises(ValueError, match="S=0"):
        slstm_scan(pre[:, :0], r)
    with pytest.raises(ValueError, match="backend"):
        slstm_scan(pre, r, backend="pallas")
    # the kernel route (any tensor off the CPU) takes no state
    meta = (pre.to("meta"), r.to("meta"))
    _, st = slstm_reference(pre, r)
    with pytest.raises(ValueError, match="zero state"):
        slstm_scan(*meta, state=st)
    with pytest.raises(ValueError, match="cuda or cpu"):
        slstm_scan(*meta)
    assert _build.SOURCES["slstm_scan"] == \
        "kernels/slstm_fused/csrc/slstm_scan.cu"


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    """The CUDA kernel against the plain version (2e-6, the JAX test's
    bound) on the cases above, a ragged P, one step, xlstm-350m's P and a
    strided pre, and its refusal of a state."""
    cases = CASES + [(2, 19, 2, 100), (3, 1, 4, 256), (1, 12, 2, 256)]
    for b, s, h, p in cases:
        pre, r = (t.to(cuda_device) for t in _t(_mk(b, s, h, p)))
        before = slstm_scan.launches
        out = slstm_scan(pre, r)
        torch.cuda.synchronize()
        assert slstm_scan.launches == before + 1
        torch.testing.assert_close(out, slstm_reference(pre, r)[0],
                                   atol=2e-6, rtol=0)
    pre, r = (t.to(cuda_device) for t in _t(_mk(2, 9, 6, 16)))
    args = (pre[:, :, :, ::2], r[:, ::2])          # strided heads
    torch.testing.assert_close(slstm_scan(*args),
                               slstm_reference(*args)[0], atol=2e-6, rtol=0)
    _, st = slstm_reference(pre, r)
    with pytest.raises(ValueError, match="zero state"):
        slstm_scan(pre, r, state=st)
