"""Port's encounter_mix (plain version and wrapper) against the JAX package.

Inputs come from a numpy seed and go to both packages. Masses are counts of
0/1 gates and must be exactly equal: the gate (``dx*dx + dy*dy`` in float32
against ``radius**2`` rounded to float32, integer areas, global indices) is
bitwise the reference's. The mix is held to atol/rtol 1e-5 in float32: fp32
sums in another order, and the Pallas interpret path is itself not bitwise
across tiles (ROADMAP §3). bf16 weights are held to 5e-2, one bf16 ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.encounter_mix import ref as jref  # noqa: E402
from repro.kernels.encounter_mix.kernel import encounter_mix_pallas  # noqa: E402
from repro_torch.kernels.encounter_mix import (encounter_block,  # noqa: E402
                                               encounter_gate, encounter_mix,
                                               encounter_mix_reference,
                                               normalize_mix)

torch.set_num_threads(1)

# tests/test_kernels_encounter.py's shapes and Pallas tiles
SHAPES = [(20, 256, 8, 128), (33, 130, 16, 128), (64, 1024, 64, 256),
          (7, 5, 8, 128)]
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _setup(m, d, seed=1, n_areas=2, p_active=1.0, zero_pos=False):
    rng = np.random.default_rng(seed * 1000 + m)
    pos = (np.zeros((m, 2), np.float32) if zero_pos
           else rng.uniform(size=(m, 2)).astype(np.float32))
    area = rng.integers(0, n_areas, m).astype(np.int32)
    w = rng.normal(size=(m, d)).astype(np.float32)
    active = rng.uniform(size=m) < p_active
    return pos, area, active, w


def _torch(*arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("m,d,block_m,block_d", SHAPES)
@pytest.mark.parametrize("p_active", [1.0, 0.6])
def test_encounter_mix_matches_jax(m, d, block_m, block_d, p_active):
    pos, area, active, w = _setup(m, d, p_active=p_active)
    got, mass = encounter_mix(*_torch(pos, area, active, w), radius=0.3)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, d)
    jin = [jnp.asarray(a) for a in (pos, area, active, w)]
    want = [jref.encounter_mix_reference(*jin, radius=0.3),
            encounter_mix_pallas(*jin, radius=0.3, block_m=block_m,
                                 block_d=block_d, interpret=True)]
    assert mass.sum() > 0, "no encounter: parity is vacuous"
    for mix_j, mass_j in want:
        np.testing.assert_array_equal(mass.numpy(), np.asarray(mass_j))
        np.testing.assert_allclose(got.numpy(), np.asarray(mix_j),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("m,d", [(20, 256), (33, 130)])
def test_encounter_mix_bf16_matches_pallas(m, d):
    pos, area, active, w = _setup(m, d, p_active=0.6)
    got, mass = encounter_mix(*_torch(pos, area, active),
                              torch.tensor(w).to(torch.bfloat16), radius=0.3)
    assert got.dtype == torch.bfloat16
    want, want_mass = encounter_mix_pallas(
        jnp.asarray(pos), jnp.asarray(area), jnp.asarray(active),
        jnp.asarray(w, jnp.bfloat16), radius=0.3, interpret=True)
    np.testing.assert_array_equal(mass.numpy(), np.asarray(want_mass))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=5e-2,
                               rtol=5e-2)


def test_zero_positions_every_same_area_pair_meets():
    """Trace scenarios carry pos = 0: the strip is the area blocks."""
    pos, area, _, w = _setup(12, 40, zero_pos=True)
    got, mass = encounter_mix(*_torch(pos, area), None, torch.tensor(w),
                              radius=0.15)
    same = area[:, None] == area[None, :]
    np.testing.assert_array_equal(mass.numpy(), same.sum(1) - 1)
    want, want_mass = jref.encounter_mix_reference(
        jnp.asarray(pos), jnp.asarray(area), None, jnp.asarray(w),
        radius=0.15)
    np.testing.assert_array_equal(mass.numpy(), np.asarray(want_mass))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("row0,col0", [(0, 0), (5, 0), (0, 9), (13, 13)])
def test_gate_and_block_with_offsets_match_jax(row0, col0):
    """A row block against a visiting block at global offsets: distances
    and gates bitwise, block sums to 1e-5, counts exact."""
    rng = np.random.default_rng(row0 * 31 + col0)
    r, v, d = 9, 11, 17
    pr = rng.uniform(size=(r, 2)).astype(np.float32)
    pv = rng.uniform(size=(v, 2)).astype(np.float32)
    pv[:4] = pr[:4]         # coincident points: only global ids separate them
    ar, av = rng.integers(0, 2, r), rng.integers(0, 2, v)
    ar[:4] = av[:4]
    actr, actv = rng.uniform(size=r) < 0.8, rng.uniform(size=v) < 0.8
    wv = rng.normal(size=(v, d)).astype(np.float32)
    targs = (*_torch(pr, ar, actr), row0, *_torch(pv, av, actv), col0)
    jargs = (jnp.asarray(pr), jnp.asarray(ar), jnp.asarray(actr), row0,
             jnp.asarray(pv), jnp.asarray(av), jnp.asarray(actv), col0)
    d2, gate = encounter_gate(*targs)
    jd2, jgate = jref.encounter_gate(*jargs)
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jd2))
    np.testing.assert_array_equal(gate.numpy(), np.asarray(jgate))
    acc, mass = encounter_block(*targs, torch.tensor(wv), 0.5)
    jacc, jmass = jref.encounter_block(*jargs, jnp.asarray(wv), 0.5)
    np.testing.assert_array_equal(mass.numpy(), np.asarray(jmass))
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(normalize_mix(acc, mass).numpy(),
                               np.asarray(jref.normalize_mix(jacc, jmass)),
                               atol=1e-6, rtol=1e-6)
    # the coincident pairs (i, i) share position and area: only the global
    # ids (and activity) decide them
    i = np.arange(4)
    np.testing.assert_array_equal(gate.numpy()[i, i],
                                  actr[i] & actv[i] & (row0 != col0))


def test_isolated_rows_are_zero_with_zero_mass():
    """No peer in radius/area (or inactive) -> zero mix row, zero mass."""
    pos = torch.tensor([[0.0, 0.0], [0.05, 0.0], [0.9, 0.9], [0.0, 0.01]])
    area = torch.tensor([0, 0, 0, 1])           # row 3: same spot, other area
    w = torch.ones(4, 8)
    out, mass = encounter_mix(pos, area, torch.ones(4, dtype=torch.bool), w,
                              radius=0.15)
    np.testing.assert_array_equal(mass.numpy(), [1, 1, 0, 0])
    assert not out[2:].any()
    out2, mass2 = encounter_mix(pos, area,
                                torch.tensor([True, False, True, True]), w,
                                radius=0.15)
    np.testing.assert_array_equal(mass2.numpy(), [0, 0, 0, 0])
    assert not out2.any()


def test_active_none_equals_all_ones():
    pos, area, _, w = _setup(16, 32, seed=9)
    a, am = encounter_mix(*_torch(pos, area), None, torch.tensor(w),
                          radius=0.3)
    b, bm = encounter_mix(*_torch(pos, area), torch.ones(16, dtype=torch.bool),
                          torch.tensor(w), radius=0.3)
    assert torch.equal(a, b) and torch.equal(am, bm)


def test_radius_is_rounded_to_float32_like_jax():
    """A pair exactly at float32(r)**2 apart, and one a float32 ulp inside
    and outside: the port and the reference agree on each."""
    r2 = np.float32(0.3 ** 2)
    xs = [np.sqrt(np.float64(r2)), np.float32(0.3), np.nextafter(
        np.float32(0.3), np.float32(1)), np.nextafter(np.float32(0.3),
                                                      np.float32(0))]
    pos = np.array([[0.0, 0.0]] + [[x, 0.0] for x in xs], np.float32)
    area = np.zeros(len(pos), np.int32)
    w = np.eye(len(pos), dtype=np.float32)
    _, mass = encounter_mix(*_torch(pos, area), None, torch.tensor(w),
                            radius=0.3)
    _, jmass = jref.encounter_mix_reference(jnp.asarray(pos),
                                            jnp.asarray(area), None,
                                            jnp.asarray(w), radius=0.3)
    np.testing.assert_array_equal(mass.numpy(), np.asarray(jmass))


def test_wrapper_rejects_bad_inputs():
    pos, area, w = torch.rand(5, 2), torch.zeros(5, dtype=torch.int64), \
        torch.randn(5, 3)
    with pytest.raises(ValueError):
        encounter_mix(torch.rand(4, 2), area, None, w)          # M mismatch
    with pytest.raises(ValueError):
        encounter_mix(pos, torch.zeros(4, dtype=torch.int64), None, w)
    with pytest.raises(ValueError):
        encounter_mix(pos, area, torch.ones(3, dtype=torch.bool), w)
    with pytest.raises(ValueError):
        encounter_mix(pos, area, None, w[0])                    # not [M, D]
    with pytest.raises(TypeError):
        encounter_mix(pos.double(), area, None, w)
    with pytest.raises(TypeError):
        encounter_mix(pos, area.float(), None, w)
    with pytest.raises(TypeError):
        encounter_mix(pos, area, torch.ones(5), w)              # not bool
    with pytest.raises(TypeError):
        encounter_mix(pos, area, None, w.half())


def test_cpu_run_launches_no_kernel():
    before = encounter_mix.launches
    pos, area, active, w = _setup(20, 64, p_active=0.6)
    got, mass = encounter_mix(*_torch(pos, area, active, w), radius=0.3)
    want, want_mass = encounter_mix_reference(*_torch(pos, area, active, w),
                                              radius=0.3)
    assert torch.equal(got, want) and torch.equal(mass, want_mass)
    assert encounter_mix.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_kernel_matches_plain_on_card(cuda_device, dtype):
    """The CUDA kernel against its plain version: the shapes above at two
    activity levels, a ragged shape over several M-chunks, zero positions
    (a dense strip), and masses exactly equal."""
    tdt = getattr(torch, dtype)
    tol = TOL[dtype]
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [(m, d, p, False) for m, d, _, _ in SHAPES for p in (1.0, 0.6)]
    cases += [(1100, 4099, 0.8, False), (300, 2000, 1.0, True)]
    for m, d, p, zero in cases:
        pos, area, active, w = (torch.tensor(a).to(cuda_device) for a in
                                _setup(m, d, p_active=p, zero_pos=zero))
        w = w.to(tdt)
        before = encounter_mix.launches
        out, mass = encounter_mix(pos, area, active, w, radius=0.3)
        torch.cuda.synchronize()
        assert encounter_mix.launches == before + 1
        ref, ref_mass = encounter_mix_reference(pos, area, active, w,
                                                radius=0.3)
        assert torch.equal(mass, ref_mass)
        torch.testing.assert_close(out.float(), ref.to(tdt).float(),
                                   atol=tol, rtol=tol)
