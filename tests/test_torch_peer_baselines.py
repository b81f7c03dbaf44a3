"""Port's peer baselines (baselines/gossip.py, baselines/oppcl.py) against
the JAX package.

Both packages get the reference's smoke-CNN population (carried across with
``params_from_numpy``), the same geometry and the same numpy batches; the
train functions ignore their keys, like the reference harness's. Each step
is one SGD step of 12 mules from the same state; weights are held to
atol/rtol 1e-5 (the neighbor mix differs by fp32 summation order, ~1e-7,
and one step of convolution and matmul gradients adds ~1e-6). Masses,
peer choices and the encounter matrix are exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.baselines import gossip as jgossip  # noqa: E402
from repro.baselines import oppcl as joppcl  # noqa: E402
from repro.configs.mule_cnn import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.baselines import gossip as tgossip  # noqa: E402
from repro_torch.baselines import oppcl as toppcl  # noqa: E402
from repro_torch.interop import flatten_tree, params_from_numpy, to_numpy  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

torch.set_num_threads(1)

M, BATCH, LR, TOL = 12, 4, 0.05, 1e-5
CFG = jax_smoke_config()        # 16x16x3, conv 8/16, hidden 32, 4 classes


def _jax_train(params, batch, key):
    xb, yb = batch
    g = jax.grad(lambda p: jcnn.xent_loss(jcnn.cnn_forward(p, xb), yb))(params)
    return jax.tree.map(lambda p, gg: p - LR * gg, params, g)


def _torch_train(params, batch, key):
    xb, yb = batch
    g = torch.func.grad(
        lambda p: cnn.xent_loss(cnn.cnn_forward(p, xb), yb))(params)
    return {k: p - LR * g[k] for k, p in params.items()}


def _population(m=M, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), m)
    return jax.tree.map(np.asarray,
                        jax.vmap(lambda k: jcnn.init_cnn(k, CFG))(keys))


def _geometry(kind, m=M, seed=0):
    """(pos, area, active) of one step: uniform positions, all-zero
    positions (trace scenarios: every same-area pair ties at d2 = 0), or
    uniform positions under a churn mask."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(size=(m, 2)).astype(np.float32)
    if kind == "zero_pos":
        pos[:] = 0.0
    area = rng.integers(0, 2, m).astype(np.int32)
    active = (rng.uniform(size=m) < 0.7 if kind == "churn"
              else np.ones(m, bool))
    return pos, area, active


def _batches(m=M, seed=1):
    rng = np.random.default_rng(seed)
    s = CFG.image_size
    x = rng.normal(size=(m, BATCH, s, s, 3)).astype(np.float32)
    y = rng.integers(0, CFG.n_classes, (m, BATCH)).astype(np.int32)
    return x, y


def test_flatten_population_column_order_matches_jax():
    pop = _population(5)
    flat_j, spec_j = jgossip.flatten_population(
        jax.tree.map(jnp.asarray, pop))
    models = params_from_numpy(pop, device="cpu")
    flat, spec = tgossip.flatten_population(models)
    assert flat.dtype == torch.float32
    np.testing.assert_array_equal(flat.numpy(), np.asarray(flat_j))
    assert spec[0] == list(flatten_tree(pop))
    back = tgossip.unflatten_population(flat, spec)
    assert sorted(back) == sorted(models)
    for k, v in models.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v)
    want = flatten_tree(jax.tree.map(np.asarray, jgossip.unflatten_population(
        flat_j, spec_j)))
    for k in want:
        np.testing.assert_array_equal(back[k].numpy(), want[k])


def test_unflatten_restores_each_leaf_dtype():
    models = {"a": torch.randn(3, 2, 2).to(torch.bfloat16),
              "b": torch.randn(3, 5)}
    flat, spec = tgossip.flatten_population(models)
    assert flat.dtype == torch.float32 and tuple(flat.shape) == (3, 9)
    back = tgossip.unflatten_population(flat, spec)
    assert back["a"].dtype == torch.bfloat16
    assert torch.equal(back["a"], models["a"])
    assert torch.equal(back["b"], models["b"])


@pytest.mark.parametrize("kind", ["uniform", "zero_pos", "churn"])
def test_encounter_matrix_matches_jax(kind):
    pos, area, active = _geometry(kind, m=30)
    for act in (None, active):
        got = tgossip.encounter_matrix(torch.tensor(pos), torch.tensor(area),
                                       0.3, None if act is None
                                       else torch.tensor(act))
        want = jgossip.encounter_matrix(jnp.asarray(pos), jnp.asarray(area),
                                        0.3, None if act is None
                                        else jnp.asarray(act))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.any()


STEPS = {
    "gossip": (jgossip.gossip_step, tgossip.gossip_step),
    "gossip_dense": (jgossip.gossip_step_dense, tgossip.gossip_step_dense),
    "oppcl": (joppcl.oppcl_step, toppcl.oppcl_step),
}


@pytest.mark.parametrize("kind", ["uniform", "zero_pos", "churn"])
@pytest.mark.parametrize("step", sorted(STEPS))
def test_peer_step_matches_jax(step, kind):
    jstep, tstep = STEPS[step]
    pop = _population()
    pos, area, active = _geometry(kind)
    x, y = _batches()
    act = None if kind != "churn" else active
    want = jax.jit(lambda mo, p, a, b, ac: jstep(
        mo, p, a, b, _jax_train, jax.random.PRNGKey(0), radius=0.3,
        active=ac))(jax.tree.map(jnp.asarray, pop), jnp.asarray(pos),
                    jnp.asarray(area), (jnp.asarray(x), jnp.asarray(y)),
                    None if act is None else jnp.asarray(act))
    models = params_from_numpy(pop, device="cpu")
    got = tstep(models, torch.tensor(pos), torch.tensor(area),
                (torch.tensor(x), torch.tensor(y)), _torch_train, 0,
                radius=0.3, active=None if act is None else torch.tensor(act))
    want = flatten_tree(jax.tree.map(np.asarray, want))
    got = to_numpy(got)
    assert sorted(got) == sorted(want)
    moved = np.zeros(M, bool)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL,
                                   err_msg=k)
        before = flatten_tree(pop)[k]
        moved |= (got[k] != before).reshape(M, -1).any(1)
    assert moved.any(), "no mule met a peer: parity is vacuous"
    if act is not None:
        # a switched-off mule meets nobody, so its model is untouched
        assert not moved[~active].any()


@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_gossip_backends_agree_on_cpu(backend):
    """On a CPU tensor "auto" takes the plain version: both backends give
    the same state bitwise."""
    pop = params_from_numpy(_population(), device="cpu")
    pos, area, active = _geometry("churn")
    x, y = _batches()
    args = (pop, torch.tensor(pos), torch.tensor(area),
            (torch.tensor(x), torch.tensor(y)), _torch_train, 3)
    got = tgossip.gossip_step(*args, active=torch.tensor(active),
                              backend=backend)
    want = tgossip.gossip_step(*args, active=torch.tensor(active),
                               backend="ref")
    for k in want:
        assert torch.equal(got[k], want[k])
    with pytest.raises(ValueError, match="backend"):
        tgossip.gossip_step(*args, backend="pallas")


def test_oppcl_picks_the_first_nearest_peer():
    """argmin ties go to the first occurrence, in torch as in JAX: with
    every position 0, each mule's peer is the lowest-index other mule of
    its area; a mule alone in its area keeps row 0 as a placeholder."""
    area = np.array([1, 0, 1, 1, 0, 2, 0], np.int32)
    pos = np.zeros((7, 2), np.float32)
    d2 = toppcl._block_d2(torch.tensor(pos), torch.tensor(area), None, 0,
                          torch.tensor(pos), torch.tensor(area), None, 0)
    peer = torch.argmin(d2, dim=1).numpy()
    np.testing.assert_array_equal(peer, [2, 4, 0, 0, 1, 0, 1])
    jd2 = joppcl._block_d2(jnp.asarray(pos), jnp.asarray(area), None, 0,
                           jnp.asarray(pos), jnp.asarray(area), None, 0)
    np.testing.assert_array_equal(peer, np.asarray(jnp.argmin(jd2, axis=1)))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jd2))
    # the same on a long row of exact ties (vectorized reductions included)
    ties = torch.full((3, 4099), 0.25)
    ties[:, :5] = torch.inf
    ties[1, 4000:] = 0.125
    np.testing.assert_array_equal(torch.argmin(ties, dim=1).numpy(),
                                  [5, 4000, 5])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.cuda
def test_oppcl_tie_break_on_card(cuda_device):
    """The card's argmin takes the first of tied minima, as the CPU's."""
    ties = torch.full((3, 4099), 0.25)
    ties[:, :5] = torch.inf
    ties[1, 4000:] = 0.125
    np.testing.assert_array_equal(
        torch.argmin(ties.to(cuda_device), dim=1).cpu().numpy(), [5, 4000, 5])
    area = torch.tensor([1, 0, 1, 1, 0, 2, 0], device=cuda_device)
    pos = torch.zeros((7, 2), device=cuda_device)
    d2 = toppcl._block_d2(pos, area, None, 0, pos, area, None, 0)
    np.testing.assert_array_equal(torch.argmin(d2, dim=1).cpu().numpy(),
                                  [2, 4, 0, 0, 1, 0, 1])
