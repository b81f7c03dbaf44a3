"""Port's encounter_mix (plain version and wrapper) against the JAX package.

Inputs come from a numpy seed and go to both packages. Masses are counts of
0/1 gates and must be exactly equal: the gate (``dx*dx + dy*dy`` in float32
against ``radius**2`` rounded to float32, integer areas, global indices) is
bitwise the reference's. The mix is held to atol/rtol 1e-5 in float32: fp32
sums in another order, and the Pallas interpret path is itself not bitwise
across tiles (ROADMAP §3). bf16 weights are held to 5e-2, one bf16 ulp.

The CUDA kernels work per met pair: a pairs kernel writes each row's meet
mask as 32-bit words (``encounter_pairs``; its plain version is
``encounter_pairs_reference``), and the sums kernel adds the listed W rows
in ascending order. The pair lists are held to the JAX gate exactly, and
that order of summation, emulated here in plain float32 adds, to the JAX
mix and block sums.
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
                                               encounter_pairs,
                                               encounter_pairs_reference,
                                               normalize_mix, unpack_pairs)
from repro_torch.kernels.encounter_mix import ops  # noqa: E402
from repro_torch.kernels.encounter_mix.ref import n_words  # noqa: E402

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


def _jax_gate(pr, ar, actr, row0, pv, av, actv, col0, radius):
    """The reference's e [R, V] (bool) for numpy inputs."""
    jd2, jgate = jref.encounter_gate(
        jnp.asarray(pr), jnp.asarray(ar), None if actr is None
        else jnp.asarray(actr), row0, jnp.asarray(pv), jnp.asarray(av),
        None if actv is None else jnp.asarray(actv), col0)
    return np.asarray((jd2 <= np.float32(radius) ** 2) & jgate)


def _pairs_vs_jax(pr, ar, actr, row0, pv, av, actv, col0, radius):
    """The port's pair words and masses against the JAX gate: the unpacked
    gate, each row's ascending list of met mules and the counts exactly
    equal. Returns the lists."""
    t = [None if a is None else torch.tensor(a)
         for a in (pr, ar, actr, pv, av, actv)]
    words, mass = encounter_pairs(t[0], t[1], t[2], row0, t[3], t[4], t[5],
                                  col0, radius)
    assert words.dtype == torch.int32 and mass.dtype == torch.float32
    assert tuple(words.shape) == (len(pr), n_words(len(pv)))
    want = _jax_gate(pr, ar, actr, row0, pv, av, actv, col0, radius)
    got = unpack_pairs(words, len(pv)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mass.numpy(), want.sum(1))
    lists = [np.flatnonzero(row) for row in got]
    for row, lst in zip(want, lists):
        np.testing.assert_array_equal(lst, np.flatnonzero(row))
    return lists


@pytest.mark.parametrize("m,d,block_m,block_d", SHAPES)
@pytest.mark.parametrize("p_active", [1.0, 0.6])
def test_pairs_match_jax_gate(m, d, block_m, block_d, p_active):
    pos, area, active, _ = _setup(m, d, p_active=p_active)
    lists = _pairs_vs_jax(pos, area, active, 0, pos, area, active, 0, 0.3)
    assert sum(len(lst) for lst in lists) > 0 or m < 8


@pytest.mark.parametrize("row0,col0", [(0, 0), (5, 0), (0, 9), (13, 13),
                                       (40, 3)])
def test_pairs_with_offsets_match_jax(row0, col0):
    """Rows against a visiting block at global offsets, with coincident
    points that only the global ids separate, over two mask words."""
    rng = np.random.default_rng(row0 * 31 + col0 + 7)
    r, v = 9, 45
    pr = rng.uniform(size=(r, 2)).astype(np.float32)
    pv = rng.uniform(size=(v, 2)).astype(np.float32)
    pv[:4] = pr[:4]
    ar, av = rng.integers(0, 2, r), rng.integers(0, 2, v)
    ar[:4] = av[:4]
    actr, actv = rng.uniform(size=r) < 0.8, rng.uniform(size=v) < 0.8
    _pairs_vs_jax(pr, ar, actr, row0, pv, av, actv, col0, 0.5)
    _pairs_vs_jax(pr, ar, None, row0, pv, av, None, col0, 0.5)


def test_pairs_zero_positions_and_isolated_rows():
    """pos = 0 (every same-area pair meets, as on the trace scenarios), a
    row alone in its area, an inactive row, and a visiting block of 0, 32
    and 33 mules (a word's edge)."""
    pos, area, active, _ = _setup(40, 8, zero_pos=True)
    area[7] = 5                                 # alone in its area
    active[11] = False
    lists = _pairs_vs_jax(pos, area, active, 0, pos, area, active, 0, 0.15)
    assert len(lists[7]) == 0 and len(lists[11]) == 0
    assert all(len(lst) > 10 for i, lst in enumerate(lists)
               if i not in (7, 11))
    for v in (0, 32, 33):
        lists = _pairs_vs_jax(pos[:5], area[:5], None, 0, pos[:v],
                              area[:v], None, 0, 0.15)
        assert all(len(lst) <= max(v - 1, 0) for lst in lists)


def _pair_order_sums(lists, w):
    """The sums kernel's arithmetic in plain float32: each row adds its
    listed W rows one at a time, ascending, from +0."""
    w = torch.tensor(w)
    acc = torch.zeros((len(lists), w.shape[1]), dtype=torch.float32)
    for i, lst in enumerate(lists):
        for j in lst:
            acc[i] = acc[i] + w[j]
    return acc


@pytest.mark.parametrize("m,d,block_m,block_d", SHAPES)
@pytest.mark.parametrize("geo", ["uniform", "churn", "zero"])
def test_pair_order_sums_match_jax_mix(m, d, block_m, block_d, geo):
    """The kernel's order of summation against the JAX mix: masses exact,
    mix within 1e-5; the division where the mass is 0 skipped, as the
    kernel skips it (its sums are +0 there)."""
    pos, area, active, w = _setup(m, d, p_active=0.6 if geo == "churn"
                                  else 1.0, zero_pos=geo == "zero")
    lists = _pairs_vs_jax(pos, area, active, 0, pos, area, active, 0, 0.3)
    acc = _pair_order_sums(lists, w)
    mass = torch.tensor([float(len(lst)) for lst in lists])
    mix = torch.where(mass[:, None] > 0, acc / mass.clamp(min=1)[:, None],
                      acc)
    want, want_mass = jref.encounter_mix_reference(
        *[jnp.asarray(a) for a in (pos, area, active, w)], radius=0.3)
    np.testing.assert_array_equal(mass.numpy(), np.asarray(want_mass))
    np.testing.assert_allclose(mix.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(mix.numpy(),
                                  normalize_mix(acc, mass).numpy())


@pytest.mark.parametrize("r,v,d,row0,col0", [(9, 45, 17, 0, 9),
                                             (64, 64, 40, 128, 192),
                                             (20, 33, 130, 33, 0)])
def test_pair_order_sums_match_jax_block(r, v, d, row0, col0):
    """The hop's sums (unnormalised) in the kernel's order against the JAX
    ``encounter_block``."""
    rng = np.random.default_rng(r + v + d)
    pr = rng.uniform(size=(r, 2)).astype(np.float32)
    pv = rng.uniform(size=(v, 2)).astype(np.float32)
    ar, av = rng.integers(0, 2, r), rng.integers(0, 2, v)
    actv = rng.uniform(size=v) < 0.8
    wv = rng.normal(size=(v, d)).astype(np.float32)
    lists = _pairs_vs_jax(pr, ar, None, row0, pv, av, actv, col0, 0.3)
    acc = _pair_order_sums(lists, wv)
    jacc, jmass = jref.encounter_block(
        jnp.asarray(pr), jnp.asarray(ar), None, row0, jnp.asarray(pv),
        jnp.asarray(av), jnp.asarray(actv), col0, jnp.asarray(wv), 0.3)
    np.testing.assert_array_equal([len(lst) for lst in lists],
                                  np.asarray(jmass))
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), atol=1e-5,
                               rtol=1e-5)


def test_pair_words_pack_and_unpack():
    """Bit b of word w is mule 32 w + b, bit 31 included; bits past V are
    0; a set bit past V is refused."""
    pos = np.zeros((3, 2), np.float32)
    pv = np.zeros((70, 2), np.float32)
    av = np.zeros(70, np.int64)
    av[[0, 31, 32, 63, 69]] = 1
    words, mass = encounter_pairs_reference(
        torch.tensor(pos), torch.ones(3, dtype=torch.int64), None, 100,
        torch.tensor(pv), torch.tensor(av), None, 0, 0.1)
    assert words.tolist()[0] == [1 | -2 ** 31, 1 | -2 ** 31, 1 << 5]
    assert mass.tolist() == [5.0] * 3
    assert n_words(0) == 1 and n_words(32) == 1 and n_words(33) == 2
    with pytest.raises(ValueError):
        unpack_pairs(words, 68)


def test_encounter_pairs_cpu_and_checks():
    pos, area, _, _ = _setup(10, 4)
    tp, ta = torch.tensor(pos), torch.tensor(area)
    before = encounter_pairs.launches
    got = encounter_pairs(tp, ta, None, 0, tp, ta, None, 0, 0.3)
    want = encounter_pairs_reference(tp, ta, None, 0, tp, ta, None, 0, 0.3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert encounter_pairs.launches == before           # CPU: plain version
    with pytest.raises(ValueError):
        encounter_pairs(tp[:4], ta, None, 0, tp, ta, None, 0, 0.3)
    with pytest.raises(TypeError):
        encounter_pairs(tp.double(), ta, None, 0, tp, ta, None, 0, 0.3)
    with pytest.raises(TypeError):
        encounter_pairs(tp, ta.float(), None, 0, tp, ta, None, 0, 0.3)
    with pytest.raises(TypeError):
        encounter_pairs(tp, ta, torch.ones(10), 0, tp, ta, None, 0, 0.3)
    assert 0 <= ops.DENSE_PAIRS_PER_ROW <= 33


@pytest.mark.cuda
def test_pairs_and_modes_on_card(cuda_device):
    """The pairs kernel equals its plain version; the sums give the same
    bits with every strip dense, none dense and the default switch."""
    for m, d, zero in ((300, 2000, True), (1100, 4099, False),
                       (64, 1024, False), (7, 5, False)):
        pos, area, active, w = (torch.tensor(a).to(cuda_device) for a in
                                _setup(m, d, p_active=0.8, zero_pos=zero))
        got = encounter_pairs(pos, area, active, 0, pos, area, active, 0,
                              0.3)
        want = encounter_pairs_reference(pos, area, active, 0, pos, area,
                                         active, 0, 0.3)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        default = ops.DENSE_PAIRS_PER_ROW
        outs = []
        try:
            for dense_min in (0, default, 33):
                ops.DENSE_PAIRS_PER_ROW = dense_min
                outs.append(encounter_mix(pos, area, active, w, radius=0.3))
        finally:
            ops.DENSE_PAIRS_PER_ROW = default
        for out, mass in outs[1:]:
            assert torch.equal(out, outs[0][0])
            assert torch.equal(mass, outs[0][1])


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
