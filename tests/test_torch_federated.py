"""Port's federated baselines (baselines/fedavg.py, cfl.py, fedas.py)
against the JAX package.

Both packages get the reference's smoke-CNN weights (carried across with
``params_from_numpy``) and the same numpy batches; the train functions
ignore their keys, like the reference harness's. Weights are held to
atol/rtol 1e-5: a round is two SGD steps of convolution and matmul
gradients (~1e-6 apart in fp32 summation order) and a weighted average.

CFL's split is a host decision on float norms and on the sign of an
eigenvector: the split cases sit far from the thresholds (eps1 = 1e9,
eps2 = 0), and partitions are compared as sets of sets, models by
membership (a sign flip of ``eigh``'s leading vector swaps the halves).
The semantic checks of ``tests/test_baselines.py`` (FedAvg reduces the
loss, CFL separates bimodal clients, FedAS keeps personal parts local)
are mirrored on the port.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.baselines import cfl as jcfl  # noqa: E402
from repro.baselines import fedas as jfedas  # noqa: E402
from repro.baselines import fedavg as jfedavg  # noqa: E402
from repro.configs.mule_cnn import CNNConfig  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.baselines import cfl as tcfl  # noqa: E402
from repro_torch.baselines import fedas as tfedas  # noqa: E402
from repro_torch.baselines import fedavg as tfedavg  # noqa: E402
from repro_torch.core.seeds import fold_in, split  # noqa: E402
from repro_torch.interop import flatten_tree, params_from_numpy, to_numpy  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

torch.set_num_threads(1)

C, BATCH, LR, TOL = 6, 4, 0.05, 1e-5
CFG = CNNConfig(image_size=8, conv_features=(4, 8), hidden=16, n_classes=4)


def _jax_train(params, batch, key):
    xb, yb = batch
    g = jax.grad(lambda p: jcnn.xent_loss(jcnn.cnn_forward(p, xb), yb))(params)
    return jax.tree.map(lambda p, gg: p - LR * gg, params, g)


def _torch_train(params, batch, key):
    xb, yb = batch
    g = torch.func.grad(
        lambda p: cnn.xent_loss(cnn.cnn_forward(p, xb), yb))(params)
    return {k: p - LR * g[k] for k, p in params.items()}


def _model(seed=0):
    return jax.tree.map(np.asarray,
                        jcnn.init_cnn(jax.random.PRNGKey(seed), CFG))


def _clients(n=C, seed=1):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return jax.tree.map(np.asarray,
                        jax.vmap(lambda k: jcnn.init_cnn(k, CFG))(keys))


def _batches(n=C, seed=2):
    rng = np.random.default_rng(seed)
    s = CFG.image_size
    x = rng.normal(size=(n, BATCH, s, s, 3)).astype(np.float32)
    y = rng.integers(0, CFG.n_classes, (n, BATCH)).astype(np.int32)
    return x, y


def _sizes(n=C):
    return np.arange(1, n + 1, dtype=np.float32) * 8


def _close(got, want, tol=TOL):
    want = flatten_tree(jax.tree.map(np.asarray, want))
    got = to_numpy(got)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=tol,
                                   err_msg=k)


def _port(tree):
    return params_from_numpy(tree, device="cpu")


def _port_batches(b):
    return tuple(torch.tensor(a) for a in b)


@pytest.mark.parametrize("local_steps", [1, 2])
def test_fedavg_round_matches_jax(local_steps):
    g, b, sizes = _model(), _batches(), _sizes()
    want = jfedavg.fedavg_round(g, tuple(jnp.asarray(a) for a in b),
                                jnp.asarray(sizes), _jax_train,
                                jax.random.PRNGKey(0), local_steps)
    got = tfedavg.fedavg_round(_port(g), _port_batches(b),
                               torch.tensor(sizes), _torch_train, 0,
                               local_steps)
    _close(got, want)


def test_local_train_seeds_each_client_and_step(monkeypatch):
    """Client c's step i trains with fold_in(seed_c, i), seed_c the c-th of
    split(key, C): twelve distinct seeds for 4 clients x 3 steps."""
    got = []

    def fake_vmap(fn):
        def run(models, batches, keys):
            got.append(keys.tolist())
            return models
        return run

    monkeypatch.setattr(torch.func, "vmap", fake_vmap)
    tfedavg.local_train({"w": torch.zeros(4, 3)}, torch.zeros(4, 2), None,
                        7, 3)
    seeds = split(7, 4, "cpu").tolist()
    assert got == [[fold_in(s, i) for s in seeds] for i in range(3)]
    assert len({k for row in got for k in row}) == 12


def test_cfl_round_without_split_matches_jax():
    """eps1 below every mean norm: no split, one FedAvg round per cluster,
    from a state of two clusters."""
    models = [_model(0), _model(3)]
    clusters = [np.array([0, 2, 3]), np.array([1, 4, 5])]
    b, sizes = _batches(), _sizes()
    jst = jcfl.CFLState(clusters=clusters, models=models, eps1=0.0, eps2=0.0)
    tst = tcfl.CFLState(clusters=clusters,
                        models=[_port(m) for m in models], eps1=0.0, eps2=0.0)
    want = jcfl.cfl_round(jst, tuple(jnp.asarray(a) for a in b),
                          jnp.asarray(sizes), _jax_train,
                          jax.random.PRNGKey(0), local_steps=2)
    got = tcfl.cfl_round(tst, _port_batches(b), torch.tensor(sizes),
                         _torch_train, 0, local_steps=2)
    assert [c.tolist() for c in got.clusters] == \
        [c.tolist() for c in want.clusters]
    for g, w in zip(got.models, want.models):
        _close(g, w)


def _toy_setup(n_clients=8, d=6, seed=0):
    """Linear regression clients; targets differ per cluster (the
    reference's tests/test_baselines.py toy)."""
    rng = np.random.default_rng(seed)
    w_true = {0: rng.normal(size=d), 1: -rng.normal(size=d)}
    xs, ys, cluster = [], [], []
    for c in range(n_clients):
        cl = c % 2
        x = rng.normal(size=(32, d))
        xs.append(x)
        ys.append(x @ w_true[cl])
        cluster.append(cl)
    return (np.stack(xs).astype(np.float32), np.stack(ys).astype(np.float32),
            np.array(cluster))


def _jax_lin(params, batch, key):
    x, y = batch
    g = jax.grad(lambda p: jnp.mean((x @ p["w"] - y) ** 2))(params)
    return jax.tree.map(lambda p, gg: p - 0.05 * gg, params, g)


def _torch_lin(params, batch, key):
    x, y = batch
    g = torch.func.grad(lambda p: ((x @ p["w"] - y) ** 2).mean())(params)
    return {k: p - 0.05 * g[k] for k, p in params.items()}


def _by_members(state):
    return {frozenset(c.tolist()): m for c, m in zip(state.clusters,
                                                     state.models)}


def test_cfl_round_split_matches_jax_by_membership():
    """Two rounds with the split check forced: the partitions equal as sets
    of sets, each cluster's model equal by membership, and the stacked
    client view equal client by client."""
    xs, ys, _ = _toy_setup()
    sizes = np.full((8,), 32.0, np.float32)
    jst = jcfl.CFLState(clusters=[np.arange(8)],
                        models=[{"w": jnp.zeros(6)}], eps1=1e9, eps2=0.0)
    tst = tcfl.CFLState(clusters=[np.arange(8)],
                        models=[{"w": torch.zeros(6)}], eps1=1e9, eps2=0.0)
    for r in range(2):
        jst = jcfl.cfl_round(jst, (jnp.asarray(xs), jnp.asarray(ys)),
                             jnp.asarray(sizes), _jax_lin,
                             jax.random.PRNGKey(r), local_steps=2)
        tst = tcfl.cfl_round(tst, (torch.tensor(xs), torch.tensor(ys)),
                             torch.tensor(sizes), _torch_lin, r,
                             local_steps=2)
        want, got = _by_members(jst), _by_members(tst)
        assert set(got) == set(want)
        for members, m in want.items():
            _close(got[members], m)
    assert len(tst.clusters) >= 2
    _close(tcfl.cfl_client_models(tst, 8),
           jcfl.cfl_client_models(jst, 8))


def test_cfl_client_models_matches_jax():
    models = [_model(0), _model(1), _model(2)]
    clusters = [np.array([4, 0]), np.array([2, 5, 1]), np.array([3])]
    want = jcfl.cfl_client_models(
        jcfl.CFLState(clusters=clusters, models=models), 6)
    got = tcfl.cfl_client_models(
        tcfl.CFLState(clusters=clusters, models=[_port(m) for m in models]),
        6)
    _close(got, want, tol=0)


def test_cfl_flat_and_bipartition_match_jax():
    tree = _clients(3)
    np.testing.assert_array_equal(
        tcfl._flat(_port(tree)).numpy(),
        np.asarray(jax.vmap(jcfl._flat)(tree)))
    rng = np.random.default_rng(0)
    u = rng.normal(size=(7, 5)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sim = u @ u.T
    for g, w in zip(tcfl._bipartition(sim), jcfl._bipartition(sim)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("pred", ["default", "backbone_only"])
def test_fedas_split_masks_match_jax(pred):
    """The port names leaves by dotted key, the reference by pytree path;
    the masks agree leaf by leaf on the CNN."""
    fn = (tfedas.default_shared_predicate if pred == "default"
          else (lambda name: "conv" in name or "bn" in name))
    tree = _model()
    want = flatten_tree(jax.tree.map(np.asarray, jfedas._split(tree, fn)))
    got = to_numpy(tfedas._split(_port(tree), fn))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert {k for k in want if not want[k].all()} == (
        {"fc2", "fc2_b"} if pred == "default"
        else {"fc1", "fc1_b", "fc2", "fc2_b"})


@pytest.mark.parametrize("local_steps", [1, 2])
def test_fedas_round_matches_jax(local_steps):
    g, clients, b, sizes = _model(), _clients(), _batches(), _sizes()
    want_g, want_c = jfedas.fedas_round(
        g, clients, tuple(jnp.asarray(a) for a in b), jnp.asarray(sizes),
        _jax_train, jax.random.PRNGKey(0), local_steps=local_steps)
    got_g, got_c = tfedas.fedas_round(
        _port(g), _port(clients), _port_batches(b), torch.tensor(sizes),
        _torch_train, 0, local_steps=local_steps)
    _close(got_g, want_g)
    _close(got_c, want_c)
    for k in ("fc2", "fc2_b"):      # personal: the old global's, bitwise
        np.testing.assert_array_equal(got_g[k].numpy(), g[k])


# ---------------------------------------------------------------------------
# the reference's semantic checks (tests/test_baselines.py), on the port
# ---------------------------------------------------------------------------


def _loss_of(params, x, y):
    return float(((x @ params["w"] - y) ** 2).mean())


def test_fedavg_reduces_loss_iid():
    xs, _, _ = _toy_setup()
    xs = torch.tensor(xs)
    ys = torch.einsum("cnd,d->cn", xs, torch.ones(6))
    model = {"w": torch.zeros(6)}
    sizes = torch.full((8,), 32.0)
    l0 = np.mean([_loss_of(model, xs[c], ys[c]) for c in range(8)])
    for r in range(30):
        model = tfedavg.fedavg_round(model, (xs, ys), sizes, _torch_lin, r,
                                     local_steps=2)
    l1 = np.mean([_loss_of(model, xs[c], ys[c]) for c in range(8)])
    assert l1 < 0.2 * l0


def test_cfl_splits_bimodal_clients():
    xs, ys, cl = _toy_setup()
    state = tcfl.CFLState(clusters=[np.arange(8)],
                          models=[{"w": torch.zeros(6)}],
                          eps1=1e9, eps2=0.0)  # force split check every round
    sizes = torch.full((8,), 32.0)
    for r in range(12):
        state = tcfl.cfl_round(state, (torch.tensor(xs), torch.tensor(ys)),
                               sizes, _torch_lin, r, local_steps=2)
        if len(state.clusters) > 1:
            break
    assert len(state.clusters) >= 2
    got = state.clusters[0]
    purity = max(np.mean(cl[got] == 0), np.mean(cl[got] == 1))
    assert purity >= 0.75
    assert tuple(tcfl.cfl_client_models(state, 8)["w"].shape) == (8, 6)


def test_fedas_keeps_personal_parts_local():
    xs, ys, _ = _toy_setup()
    glob = {"backbone": torch.zeros(6), "fc2": torch.zeros(3)}
    clients = {"backbone": torch.zeros(8, 6),
               "fc2": torch.arange(24, dtype=torch.float32).reshape(8, 3)}

    def train(params, batch, key):
        x, y = batch
        g = torch.func.grad(
            lambda p: ((x @ p["backbone"] - y) ** 2).mean())(params)
        return {k: p - 0.05 * g[k] for k, p in params.items()}

    new_glob, new_clients = tfedas.fedas_round(
        glob, clients, (torch.tensor(xs), torch.tensor(ys)),
        torch.full((8,), 32.0), train, 0)
    torch.testing.assert_close(new_clients["fc2"], clients["fc2"])
    torch.testing.assert_close(new_glob["fc2"], glob["fc2"])
    assert float(new_glob["backbone"].abs().sum()) > 0


def test_cfl_state_fields_match_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(tcfl.CFLState)] \
        == [(f.name, f.default) for f in dataclasses.fields(jcfl.CFLState)]
