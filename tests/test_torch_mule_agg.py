"""Port's mule_agg and masked_group_mean against the JAX package.

Inputs come from a numpy seed and go to both packages. Tolerances are the
JAX package's own for this kernel (tests/test_kernels_mule_agg.py): 1e-5 in
f32 (fp32 sums in another order) and 5e-2 in bf16 (one bf16 ulp where the
two fp32 sums round to different sides).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core.aggregation import masked_group_mean as jax_group_mean  # noqa: E402
from repro.kernels.mule_agg.kernel import mule_agg_pallas  # noqa: E402
from repro.kernels.mule_agg.ref import mule_agg_reference  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core.aggregation import masked_group_mean  # noqa: E402
from repro_torch.interop import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.kernels.mule_agg import (mule_agg, mule_agg_lanes,  # noqa: E402
                                          mule_agg_lanes_plain, mule_agg_op,
                                          mule_agg_plain)

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
SHAPES = [(8, 20, 256, 128), (8, 20, 1000, 256), (2, 3, 64, 64),
          (16, 64, 4096, 2048), (1, 1, 130, 128)]
# F past the kernel's 16-row tile: two tiles of 9 (one row unused) and of
# 10, three of 11
WIDE_F = (17, 20, 33)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.parametrize("f,m,d,block_d", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_mule_agg_matches_jax(f, m, d, block_d, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(f * 1000 + m)
    a = rng.uniform(size=(f, m)).astype(np.float32)
    w = rng.normal(size=(m, d)).astype(np.float32)
    got = mule_agg(torch.from_numpy(a), torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (f, d)
    aj, wj = jnp.asarray(a), jnp.asarray(w, jdt)
    for want in (mule_agg_pallas(aj, wj, block_d=block_d, interpret=True),
                 mule_agg_reference(aj, wj)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("f", WIDE_F)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mule_agg_past_16_rows_matches_jax(f, dtype):
    """Any F, as mule_agg_pallas keeps A resident whatever its rows: the
    port takes F > 16 (row tiles on the card) and matches the reference's
    Pallas kernel and plain version."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(f)
    a = rng.uniform(size=(f, 40)).astype(np.float32)
    a /= a.sum(1, keepdims=True)
    w = rng.normal(size=(40, 301)).astype(np.float32)
    got = mule_agg(torch.from_numpy(a), torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (f, 301)
    aj, wj = jnp.asarray(a), jnp.asarray(w, jdt)
    for want in (mule_agg_pallas(aj, wj, block_d=128, interpret=True),
                 mule_agg_reference(aj, wj)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_masked_group_mean_past_16_fixed_devices(dtype):
    """masked_group_mean(backend="auto") at F = 20 fixed devices, with a
    zero-mass row, against the reference's group mean."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(20)
    tree = {"a": rng.normal(size=(24, 5, 7)).astype(np.float32),
            "b": rng.normal(size=(24, 130)).astype(np.float32)}
    assign = (rng.uniform(size=(20, 24)) > 0.6).astype(np.float32)
    assign[19] = 0.0
    jtree = {k: jnp.asarray(v, jdt) for k, v in tree.items()}
    models = params_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")
    got, mass = masked_group_mean(models, torch.from_numpy(assign),
                                  backend="auto")
    got = to_numpy(got)
    assert not got["b"][19].any()
    want, want_mass = jax_group_mean(jtree, jnp.asarray(assign), backend="ref")
    np.testing.assert_array_equal(mass.numpy(), np.asarray(want_mass))
    for k in tree:
        assert got[k].shape == (20,) + tree[k].shape[1:]
        np.testing.assert_allclose(got[k], np.asarray(want[k], np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_lanes_past_16_rows_match_plain_and_jax(dtype):
    """The lane entry at F = 20 (and the custom op under vmap) against the
    plain version and each lane's reference product."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(7)
    a = rng.uniform(size=(3, 20, 30)).astype(np.float32)
    w = rng.normal(size=(3, 30, 257)).astype(np.float32)
    ta, tw = torch.from_numpy(a), torch.from_numpy(w).to(tdt)
    got = mule_agg_lanes(ta, tw)
    assert got.dtype == tdt and tuple(got.shape) == (3, 20, 257)
    torch.testing.assert_close(got, mule_agg_lanes_plain(ta, tw), atol=0,
                               rtol=0)
    assert torch.equal(torch.func.vmap(mule_agg_op)(ta, tw), got)
    for s in range(3):
        want = mule_agg_reference(jnp.asarray(a[s]), jnp.asarray(w[s], jdt))
        np.testing.assert_allclose(got[s].float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_masked_group_mean_matches_jax(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(2)
    tree = {"a": rng.normal(size=(10, 33)).astype(np.float32),
            "b": {"c": rng.normal(size=(10, 4, 7)).astype(np.float32)}}
    assign = (rng.uniform(size=(4, 10)) > 0.4).astype(np.float32)
    assign[3] = 0.0                                   # a zero-mass row
    jtree = {"a": jnp.asarray(tree["a"], jdt),
             "b": {"c": jnp.asarray(tree["b"]["c"], jdt)}}
    models = params_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")
    assert all(v.dtype == tdt for v in models.values())
    for backend in ("auto", "ref"):
        got, mass = masked_group_mean(models, torch.from_numpy(assign),
                                      backend=backend)
        got = to_numpy(got)
        assert not got["b.c"][3].any()                # zero mass -> zeros
        for jb in ("ref", "interpret"):
            want, want_mass = jax_group_mean(jtree, jnp.asarray(assign),
                                             backend=jb)
            np.testing.assert_array_equal(mass.numpy(), np.asarray(want_mass))
            np.testing.assert_allclose(got["a"], np.asarray(want["a"],
                                                            np.float32),
                                       atol=tol, rtol=tol)
            np.testing.assert_allclose(got["b.c"],
                                       np.asarray(want["b"]["c"], np.float32),
                                       atol=tol, rtol=tol)


@pytest.mark.parametrize("fn", ["weighted_average", "pairwise_mix",
                                "batched_mix", "prox_mix", "quality_weights"])
def test_aggregation_helpers_match_jax(fn):
    """The other aggregation primitives; float32 elementwise and small
    sums, held to 1e-6."""
    rng = np.random.default_rng(11)
    a = {"w": rng.normal(size=(5, 3, 4)).astype(np.float32),
         "v": rng.normal(size=(5, 2)).astype(np.float32)}
    b = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in a.items()}
    g = rng.uniform(size=5).astype(np.float32)
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    ta = {k: torch.tensor(v) for k, v in a.items()}
    tb = {k: torch.tensor(v) for k, v in b.items()}
    calls = {
        "weighted_average": (lambda m, x, y, w: m.weighted_average(x, w)),
        "pairwise_mix": (lambda m, x, y, w: m.pairwise_mix(x, y, 0.3)),
        "batched_mix": (lambda m, x, y, w: m.batched_mix(x, y, w)),
        "prox_mix": (lambda m, x, y, w: m.prox_mix(x, y, 0.4, mu=0.2)),
        "quality_weights": (lambda m, x, y, w: {"q": m.quality_weights(
            w * 3.0, temperature=0.7)}),
    }
    want = calls[fn](jagg, ja, jb, jnp.asarray(g))
    got = calls[fn](tagg, ta, tb, torch.tensor(g))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=1e-6)


def test_mule_agg_rejects_bad_inputs():
    a, w = torch.ones(2, 3), torch.ones(3, 5)
    with pytest.raises(ValueError):
        mule_agg(a, torch.ones(4, 5))                 # M mismatch
    with pytest.raises(TypeError):
        mule_agg(a.double(), w)
    with pytest.raises(TypeError):
        mule_agg(a, w.half())


# the card's cases beyond SHAPES: A chunked in shared memory; every tile
# height at a ragged D; row tiles (F > 16) at an odd D; D % 4 == 2; an odd
# bf16 row (plain loads); bf16 rows only 8-byte aligned (D = 546,484)
CARD_SHAPES = ([(f, m, d) for f, m, d, _ in SHAPES]
               + [(8, 1100, 3000), (16, 600, 2000)]
               + [(f, 37, 4099) for f in range(1, 17)]
               + [(f, 256, 5001) for f in WIDE_F]
               + [(7, 40, 4098), (5, 33, 1001), (8, 20, 546_484)])


def _card_inputs(g, shape, dtype, lanes=()):
    f, m, d = shape
    a = torch.rand(*lanes, f, m, device=g.device, generator=g)
    a = a / a.sum(-1, keepdim=True)
    w = torch.randn(*lanes, m, d, device=g.device, generator=g).to(dtype)
    return a, w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_matches_plain_on_card(cuda_device, dtype):
    """The CUDA kernel against its plain version: the edge shapes above,
    A chunked in shared memory, every tile height F = 1..16, F > 16, a D
    that is not a multiple of 4, and bf16 rows that are 8-byte aligned."""
    _, tdt, tol = DTYPES[dtype]
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape in CARD_SHAPES:
        a, w = _card_inputs(g, shape, tdt)
        before = mule_agg.launches
        out = mule_agg(a, w)
        torch.cuda.synchronize()
        assert mule_agg.launches == before + 1
        torch.testing.assert_close(out.float(), mule_agg_plain(a, w).float(),
                                   atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_lanes_bitwise_single_calls_on_card(cuda_device, dtype):
    """Each lane of one mule_agg_lanes launch has the bits of its single
    call, at 16 rows or fewer and at row tiles (F = 20)."""
    _, tdt, _ = DTYPES[dtype]
    g = torch.Generator(device=cuda_device)
    g.manual_seed(1)
    for shape in ((8, 256, 44_580), (12, 20, 4099), (20, 64, 5001)):
        a, w = _card_inputs(g, shape, tdt, lanes=(3,))
        before = mule_agg.launches
        got = mule_agg_lanes(a, w)
        assert mule_agg.launches == before + 1
        for s in range(3):
            assert torch.equal(got[s], mule_agg(a[s], w[s]))
