"""Port's CNN against the JAX package, with the reference's weights carried
across by ``params_from_numpy``.

Tolerances: the two frameworks run float32 convolutions and matmuls with
other summation orders; batch norm rescales activations to O(1), so
logits and one SGD step agree to ~1e-6 and are held to 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.mule_cnn import CNNConfig as JCNNConfig  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.configs.mule_cnn import CNNConfig, smoke_config  # noqa: E402
from repro_torch.interop import flatten_tree, params_from_numpy  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-5
LR = 0.05

CASES = {
    "smoke": smoke_config(),
    "odd_widths": CNNConfig(name="odd", image_size=8, channels=2,
                            conv_features=(5, 3), hidden=7, n_classes=3),
}


def _jax_cfg(cfg):
    return JCNNConfig(image_size=cfg.image_size, channels=cfg.channels,
                      conv_features=cfg.conv_features, hidden=cfg.hidden,
                      n_classes=cfg.n_classes)


def _setup(name, batch=6):
    cfg = CASES[name]
    jparams = jax.jit(lambda k: jcnn.init_cnn(k, _jax_cfg(cfg)))(
        jax.random.PRNGKey(3))
    jparams = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(batch, cfg.image_size, cfg.image_size,
                         cfg.channels)).astype(np.float32)
    y = rng.integers(0, cfg.n_classes, batch).astype(np.int32)
    return cfg, jparams, x, y


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    _, jparams, x, _ = _setup(name)
    want = np.asarray(jax.jit(jcnn.cnn_forward)(jparams, jnp.asarray(x)))
    got = cnn.cnn_forward(params_from_numpy(jparams, device="cpu"),
                          torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sgd_step_matches_jax(name):
    _, jparams, x, y = _setup(name)

    def jstep(p):
        g = jax.grad(lambda q: jcnn.xent_loss(
            jcnn.cnn_forward(q, jnp.asarray(x)), jnp.asarray(y)))(p)
        return jax.tree.map(lambda a, b: a - LR * b, p, g)

    params = params_from_numpy(jparams, device="cpu")
    g = torch.func.grad(lambda p: cnn.xent_loss(
        cnn.cnn_forward(p, torch.from_numpy(x)), torch.from_numpy(y)))(params)
    got = {k: (v - LR * g[k]).numpy() for k, v in params.items()}
    want = flatten_tree(jax.tree.map(np.asarray, jax.jit(jstep)(jparams)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL,
                                   err_msg=k)


def test_loss_and_accuracy_match_jax():
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(12, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 12).astype(np.int32)
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
    np.testing.assert_allclose(
        cnn.xent_loss(lt, yt).item(),
        float(jcnn.xent_loss(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)
    assert cnn.accuracy(lt, yt).item() == float(
        jcnn.accuracy(jnp.asarray(logits), jnp.asarray(labels)))


def test_init_cnn_keys_shapes_and_scale():
    """Same key paths and shapes as the reference; dense_init's scale."""
    cfg = CNNConfig()                      # the full-width paper CNN
    g = torch.Generator()
    g.manual_seed(0)
    params = cnn.init_cnn(g, cfg)
    want = flatten_tree(jax.eval_shape(
        lambda k: jcnn.init_cnn(k, _jax_cfg(cfg)), jax.random.PRNGKey(0)))
    assert list(params) == list(want)      # sorted = jax.tree.flatten order
    for k, v in params.items():
        assert tuple(v.shape) == want[k].shape, k
    assert sum(v.numel() for v in params.values()) == 546_484
    assert abs(params["fc1"].std().item() - 0.05) < 1e-3
    assert abs(params["conv2"].std().item() - 0.1) < 5e-3


def test_vmapped_training_keeps_devices_apart():
    """vmap(grad) over a population equals training each device alone:
    batch-norm statistics do not leak between devices."""
    cfg = smoke_config()
    g = torch.Generator()
    g.manual_seed(1)
    models = [cnn.init_cnn(g, cfg) for _ in range(3)]
    stacked = {k: torch.stack([m[k] for m in models]) for k in models[0]}
    x = torch.randn(3, 4, cfg.image_size, cfg.image_size, cfg.channels,
                    generator=g)
    y = torch.randint(0, cfg.n_classes, (3, 4), generator=g)

    def train(p, xb, yb):
        gr = torch.func.grad(
            lambda q: cnn.xent_loss(cnn.cnn_forward(q, xb), yb))(p)
        return {k: v - LR * gr[k] for k, v in p.items()}

    together = torch.func.vmap(train)(stacked, x, y)
    for i, m in enumerate(models):
        alone = train(m, x[i], y[i])
        for k in alone:
            torch.testing.assert_close(together[k][i], alone[k], atol=TOL,
                                       rtol=TOL)
