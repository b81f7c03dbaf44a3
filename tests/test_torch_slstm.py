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

The kernel's grid (``slstm_geometry``) is checked on the CPU: every
(batch row, head) and every head column belongs to exactly one cluster and
one block, as the kernel's own index arithmetic (emulated here) assigns
them. The kernel's order of summation (per segment of the p axis four
strided accumulators, then the segments in order) is emulated in float32
and held to JAX's plain version at the same 2e-6.

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
from repro_torch.kernels.slstm_fused.ops import (  # noqa: E402
    CLUSTER, MAX_ROWS, slstm_geometry, slstm_step_floor)

torch.set_num_threads(1)

# b, s, h, p (tests/test_kernels_slstm.py's), then more batch rows than
# one cluster of the kernel takes (B = 5) at a ragged P, and one row and
# one head at xlstm-350m's P
CASES = [(2, 24, 3, 8), (1, 7, 1, 4), (2, 33, 4, 16), (5, 24, 2, 100),
         (1, 9, 1, 256)]


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
    # the kernel route (any tensor off the CPU) takes no state; on meta it
    # returns an empty h of the right shape and launches nothing (a count)
    meta = (pre.to("meta"), r.to("meta"))
    _, st = slstm_reference(pre, r)
    with pytest.raises(ValueError, match="zero state"):
        slstm_scan(*meta, state=st)
    out = slstm_scan(*meta)
    assert out.device.type == "meta" and out.dtype == torch.float32
    assert tuple(out.shape) == (1, 4, 2, 8)
    assert _build.SOURCES["slstm_scan"] == \
        "kernels/slstm_fused/csrc/slstm_scan.cu"


def _kernel_cells(b, h, p):
    """{(row, head, column): (cluster id, block)} as csrc/slstm_scan.cu
    assigns them from blockIdx (cid = block // CLUSTER, head = cid % H,
    b0 = (cid // H) rows, nb = min(rows, B - b0); block j owns columns
    [j per, j per + ncols))."""
    geo = slstm_geometry(b, h, p)
    rows, per = geo["rows"], geo["per"]
    cells = {}
    for block in range(geo["clusters"] * CLUSTER):
        cid, rank = divmod(block, CLUSTER)
        head, b0 = cid % h, (cid // h) * rows
        nb = min(rows, b - b0)
        col0 = rank * per
        for row in range(b0, b0 + nb):
            for col in range(col0, col0 + max(0, min(per, p - col0))):
                key = (row, head, col)
                assert key not in cells, f"{key} in two blocks"
                cells[key] = (cid, rank)
    return geo, cells


@pytest.mark.parametrize("b,h,p", [(1, 1, 1), (2, 4, 256), (3, 2, 100),
                                   (4, 3, 5), (5, 2, 100), (9, 1, 256),
                                   (13, 2, 64), (17, 1, 255), (6, 3, 17),
                                   (8, 2, 128), (2, 1, 8), (7, 1, 200)])
def test_geometry_covers_every_row_head_and_column_once(b, h, p):
    geo, cells = _kernel_cells(b, h, p)
    assert set(cells) == {(i, j, k) for i in range(b) for j in range(h)
                          for k in range(p)}
    assert geo["rows"] <= MAX_ROWS and geo["groups"] * geo["rows"] >= b
    assert geo["clusters"] == h * geo["groups"]
    # every group holds at least one row, and the groups tile the batch
    spans = geo["row_groups"]
    assert spans[0][0] == 0 and spans[-1][1] == b
    assert all(lo < hi for lo, hi in spans)
    assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))
    # a block's columns are whole float4s of h, within its registers
    assert geo["per"] % 4 == 0 and geo["per"] <= 256 // CLUSTER
    cols = geo["columns"]
    assert cols[0][0] == 0 and cols[-1][1] == p
    assert all(a[1] == c[0] for a, c in zip(cols, cols[1:]))


def test_step_floor_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="sync"):
        slstm_step_floor(2, 8, 1, 16, sync="grid")
    with pytest.raises(ValueError, match="cuda"):
        slstm_step_floor(2, 8, 1, 16, sync="mbarrier", device="cpu")


def _kernel_order(pre, r):
    """The kernel's arithmetic in float32 in its order of summation: per
    segment of 16 values of the padded p axis, four accumulators over
    k = 0, 1, 2, 3 mod 4 (fused multiply-adds, emulated in float64 and
    rounded once each), summed (a0 + a1) + (a2 + a3); then the segments in
    order; then the cell update."""
    b, s, _, h, p = pre.shape
    n_seg = 16          # 16 warps of 64 (gate, column) pairs of 16 columns
    kl = 256 // n_seg
    rp = torch.zeros(4, h, 256, p, dtype=torch.float32)
    rp[:, :, :p] = r
    hs = torch.zeros(b, h, 256, dtype=torch.float32)
    c = torch.zeros(b, h, p)
    n = torch.zeros(b, h, p)
    m = torch.full((b, h, p), -1e30)
    out = []
    for t in range(s):
        rec = torch.zeros(b, 4, h, p)
        for seg in range(n_seg):
            accs = []
            for j in range(4):
                acc = torch.zeros(b, 4, h, p)
                for k in range(seg * kl + j, seg * kl + kl, 4):
                    prod = (hs[:, None, :, k, None].double()
                            * rp[None, :, :, k, :].double())
                    acc = (prod + acc.double()).float()
                accs.append(acc)
            rec = rec + ((accs[0] + accs[1]) + (accs[2] + accs[3]))
        x = pre[:, t] + rec
        lf = torch.minimum(x[:, 2], torch.zeros(())) - torch.log1p(
            torch.exp(-x[:, 2].abs()))
        m_new = torch.maximum(lf + m, x[:, 1])
        i_act = torch.exp(x[:, 1] - m_new)
        f_act = torch.exp(lf + m - m_new)
        c = f_act * c + i_act * torch.tanh(x[:, 0])
        n = f_act * n + i_act
        m = m_new
        hn = torch.sigmoid(x[:, 3]) * c / torch.clamp(n, min=1e-6)
        hs = torch.zeros(b, h, 256)
        hs[:, :, :p] = hn
        out.append(hn)
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("case", [(2, 6, 2, 40), (1, 4, 1, 256)])
def test_kernel_order_of_sums_matches_jax(case):
    """The kernel sums in another order than the plain versions; emulated,
    that order stays within 2e-6 of JAX's plain version."""
    pre, r = _mk(*case, seed=4)
    got = _kernel_order(*_t((pre, r)))
    _close(got, j_ref(jnp.asarray(pre), jnp.asarray(r))[0], 2e-6)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    """The CUDA kernel against the plain version (2e-6, the JAX test's
    bound) on the cases above, a ragged P, one step, xlstm-350m's P, more
    batch rows than a cluster takes, one row and one head; a strided pre,
    its refusal of a state, and the step floor."""
    cases = CASES + [(2, 19, 2, 100), (3, 1, 4, 256), (1, 12, 2, 256),
                     (5, 12, 1, 256), (1, 30, 1, 256)]
    for b, s, h, p in cases:
        pre, r = (t.to(cuda_device) for t in _t(_mk(b, s, h, p)))
        before = slstm_scan.launches
        out = slstm_scan(pre, r)
        torch.cuda.synchronize()
        assert slstm_scan.launches == before + 1
        torch.testing.assert_close(out, slstm_reference(pre, r)[0],
                                   atol=2e-6, rtol=0)
    for sync in ("mbarrier", "cluster"):
        floor = slstm_step_floor(2, 64, 3, 100, sync=sync)
        assert bool((floor[:, -1] == 64.0).all())
    pre, r = (t.to(cuda_device) for t in _t(_mk(2, 9, 6, 16)))
    args = (pre[:, :, :, ::2], r[:, ::2])          # strided heads
    torch.testing.assert_close(slstm_scan(*args),
                               slstm_reference(*args)[0], atol=2e-6, rtol=0)
    _, st = slstm_reference(pre, r)
    with pytest.raises(ValueError, match="zero state"):
        slstm_scan(pre, r, state=st)
