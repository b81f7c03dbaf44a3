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
from repro_torch.kernels.mule_agg import mule_agg, mule_agg_plain  # noqa: E402

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
SHAPES = [(8, 20, 256, 128), (8, 20, 1000, 256), (2, 3, 64, 64),
          (16, 64, 4096, 2048), (1, 1, 130, 128)]


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_matches_plain_on_card(cuda_device, dtype):
    """The CUDA kernel against its plain version: the edge shapes above,
    plus M large enough that A is staged in shared memory in chunks."""
    _, tdt, tol = DTYPES[dtype]
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    for f, m, d, _ in SHAPES + [(8, 1100, 3000, 0), (16, 600, 2000, 0)]:
        a = torch.rand(f, m, device=cuda_device, generator=g)
        a = a / a.sum(1, keepdim=True)
        w = torch.randn(m, d, device=cuda_device, generator=g).to(tdt)
        before = mule_agg.launches
        out = mule_agg(a, w)
        torch.cuda.synchronize()
        assert mule_agg.launches == before + 1
        torch.testing.assert_close(out.float(), mule_agg_plain(a, w).float(),
                                   atol=tol, rtol=tol)
