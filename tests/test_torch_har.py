"""Port's HAR slice (Fig 8) against the JAX package: the IMU data, the
LSTM-CNN, its config, the HAR scenarios and ``run_experiment(task="har")``.

The IMU windows and the per-mule HAR layout are numpy draws, bitwise the
reference's. The LSTM-CNN gets the reference's weights
(``params_from_numpy``) and numpy windows; logits and one SGD step are
held to 1e-5 (fp32 convolutions and 32 LSTM steps summed in another
order). Odd window lengths exercise XLA's asymmetric SAME padding of the
stride-2 convolutions (the odd pad goes right).
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import benchmarks.common as jcommon  # noqa: E402
from repro.configs import mule_lstm_cnn as jlcfg  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import experiment as texp  # noqa: E402
from repro_torch.configs import mule_lstm_cnn as tlcfg  # noqa: E402
from repro_torch.core import METHODS_MOBILE  # noqa: E402
from repro_torch.data import make_imu_dataset  # noqa: E402
from repro_torch.interop import flatten_tree, params_from_numpy, to_numpy  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

torch.set_num_threads(1)

TOL, LR = 1e-5, 0.03


@pytest.mark.parametrize("seed,n_per_cell", [(0, 3), (5, 8)])
def test_make_imu_dataset_bitwise(seed, n_per_cell):
    got = make_imu_dataset(seed, n_per_cell=n_per_cell)
    want = jsyn.make_imu_dataset(seed, n_per_cell=n_per_cell)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    dens = np.ones((2, 3))
    for g, w in zip(make_imu_dataset(1, 2, 16, 4, 2, 3, dens),
                    jsyn.make_imu_dataset(1, 2, 16, 4, 2, 3, dens)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("scenario", ["har_commuter", "har_shift_worker"])
def test_har_data_mobile_bitwise(scenario):
    kw = dict(scenario=scenario, seed=2, n_mules=10, n_per_sub=6, steps=80)
    jcfg = jcommon.ExperimentConfig(**kw)
    co = jcommon._mobility_tensors(jcfg)
    want = jcommon._har_data_mobile(jcfg, co[1], co[2])
    got = texp.har_data_mobile(texp.ExperimentConfig(**kw), co[1], co[2],
                               device="cpu")
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("size", ["full", "smoke"])
def test_lstm_cnn_config_matches(size):
    jc = jlcfg.CONFIG if size == "full" else jlcfg.smoke_config()
    tc = tlcfg.CONFIG if size == "full" else tlcfg.smoke_config()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    get = tconfigs.get_config if size == "full" else tconfigs.get_smoke_config
    assert get("mule-lstm-cnn") == tc


def _weights(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        jcnn.init_lstm_cnn(jax.random.PRNGKey(seed), cfg))


def test_init_lstm_cnn_layout_matches():
    """Keys, shapes and per-leaf scale of the port's init against the
    reference's, at full width (D = 44,580)."""
    cfg = jlcfg.CONFIG
    want = _weights(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    got = cnn.init_lstm_cnn(gen, tlcfg.CONFIG)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert sum(v.numel() for v in got.values()) == 44_580
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k].std()), float(w.std()),
                                   rtol=0.2, atol=1e-12, err_msg=k)


def _windows(b, t, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, 6)).astype(np.float32)
    y = rng.integers(0, 4, b).astype(np.int32)
    return x, y


@pytest.mark.parametrize("window", [128, 33, 7])
def test_same_padding_is_xlas(window):
    for stride in (1, 2):
        left, right = cnn.same_pad(window, 5, stride)
        out = -(-window // stride)
        assert (window + left + right - 5) // stride + 1 == out
        assert right - left in (0, 1)
    assert cnn.same_pad(128, 5, 2) == (1, 2)


@pytest.mark.parametrize("window", [128, 33])
def test_lstm_cnn_forward_and_sgd_step_match_jax(window):
    jc = jlcfg.LSTMCNNConfig(window=window, conv_features=(16, 32),
                             lstm_hidden=32)
    p = _weights(jc)
    x, y = _windows(5, window)
    want = np.asarray(jcnn.lstm_cnn_forward(p, jnp.asarray(x)))
    tp = params_from_numpy(p, "cpu")
    got = cnn.lstm_cnn_forward(tp, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)

    g = jax.grad(lambda q: jcnn.xent_loss(
        jcnn.lstm_cnn_forward(q, jnp.asarray(x)), jnp.asarray(y)))(p)
    want = flatten_tree(jax.tree.map(lambda a, b: np.asarray(a - LR * b),
                                     p, g))
    _, train_fn, eval_fn = texp.lstm_cnn_model_fns(
        tlcfg.LSTMCNNConfig(window=window, conv_features=(16, 32),
                            lstm_hidden=32), LR)
    stepped = to_numpy(train_fn(tp, (torch.tensor(x), torch.tensor(y)), 0))
    for k in want:
        np.testing.assert_allclose(stepped[k], want[k], atol=TOL, rtol=TOL,
                                   err_msg=k)
    assert float(eval_fn(tp, torch.tensor(x), torch.tensor(y))) == \
        float(jcnn.accuracy(jcnn.lstm_cnn_forward(p, jnp.asarray(x)),
                            jnp.asarray(y)))


def test_lstm_cnn_vmaps_without_a_per_sample_fallback():
    """torch.func.vmap(grad) over the LSTM's Python loop: every op has a
    batching rule (a fallback warns), and the lanes equal the per-sample
    gradients."""
    _, train_fn, _ = texp.lstm_cnn_model_fns(tlcfg.smoke_config(), LR)
    gen = torch.Generator()
    one = cnn.init_lstm_cnn(gen, tlcfg.smoke_config())
    models = {k: torch.stack([v, v * 1.5, v - 0.1]) for k, v in one.items()}
    x = torch.randn(3, 4, 32, 6, generator=gen)
    y = torch.randint(0, 4, (3, 4), generator=gen)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        batched = torch.func.vmap(train_fn)(models, (x, y),
                                            torch.arange(3))
    for i in range(3):
        lane = train_fn({k: v[i] for k, v in models.items()},
                        (x[i], y[i]), i)
        for k in lane:
            torch.testing.assert_close(batched[k][i], lane[k], atol=1e-6,
                                       rtol=1e-6)


def test_model_fns_select_the_harness_lstm():
    init, _, _ = texp.model_fns(texp.ExperimentConfig(task="har"))
    got = init(torch.Generator())
    want = _weights(jlcfg.LSTMCNNConfig(conv_features=(16, 32),
                                        lstm_hidden=32, n_classes=4))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}


TINY_HAR = dict(task="har", mode="mobile", steps=12, eval_every=6,
                pretrain_steps=2, n_mules=6, batch=4, n_per_sub=6)


@pytest.mark.parametrize("method", METHODS_MOBILE)
def test_run_experiment_har_contract(method):
    """Every mobile method on the HAR task, on the CPU: the reference's
    keys, evals after steps 5 and 11, accuracies in [0, 1]."""
    got = texp.run_experiment(texp.ExperimentConfig(method=method,
                                                    **TINY_HAR),
                              device="cpu")
    assert sorted(got) == ["config", "post_local_acc", "pre_local_acc",
                           "trace", "wall_s"]
    assert got["config"] == dataclasses.asdict(
        jcommon.ExperimentConfig(method=method, **TINY_HAR))
    assert [s for s, _ in got["trace"]] == [5, 11]
    for _, acc in got["trace"]:
        assert 0.0 <= acc <= 1.0
    assert got["pre_local_acc"] == got["post_local_acc"]
    assert 0.0 <= got["pre_local_acc"] <= 1.0


def test_run_experiment_on_a_har_scenario():
    """A scenario sets task, mode, dist and n_fixed: har_commuter runs the
    LSTM-CNN in mobile mode."""
    got = texp.run_experiment(texp.ExperimentConfig(
        scenario="har_commuter", method="mlmule", steps=12, eval_every=6,
        pretrain_steps=2, n_mules=6, batch=4, n_per_sub=6), device="cpu")
    assert (got["config"]["task"], got["config"]["mode"]) == ("har",
                                                              "mobile")
    assert [s for s, _ in got["trace"]] == [5, 11]
