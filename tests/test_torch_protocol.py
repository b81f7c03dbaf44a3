"""Port's per-pair protocol cycles (core/protocol.py) against the JAX
package, and the port's ``population_step`` against them.

The cycles are the paper's Sec 3.1 step lists: both packages get the same
numpy models, timestamps and thresholds, and a deterministic train
function (one SGD step of the smoke CNN on a fixed numpy batch). Models
are held to atol/rtol 1e-6 (a mix and one step of gradients in fp32),
the accept flag exactly. ``population_step`` with one mule delivering to
one of two fixed devices must reproduce the cycle of its mode, as
``tests/test_core_protocol.py`` holds the reference's to its own.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.mule_cnn import CNNConfig  # noqa: E402
from repro.core import protocol as jproto  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.core import protocol as tproto  # noqa: E402
from repro_torch.core.freshness import FreshnessConfig  # noqa: E402
from repro_torch.core.population import (PopulationConfig,  # noqa: E402
                                         init_population, population_step)
from repro_torch.interop import flatten_tree, params_from_numpy, to_numpy  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

torch.set_num_threads(1)

TOL, LR = 1e-6, 0.05
CFG = CNNConfig(image_size=8, conv_features=(4, 8), hidden=16, n_classes=4)
CYCLES = {"fixed": "fixed_device_training_cycle",
          "mobile": "mobile_device_training_cycle"}


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, 4).astype(np.int32)
    return x, y


def _jax_trainer(batch):
    xb, yb = (jnp.asarray(a) for a in batch)

    def train(p):
        g = jax.grad(lambda q: jcnn.xent_loss(jcnn.cnn_forward(q, xb),
                                              yb))(p)
        return jax.tree.map(lambda a, b: a - LR * b, p, g)
    return train


def _torch_trainer(batch):
    xb, yb = (torch.tensor(a) for a in batch)

    def train(p):
        g = torch.func.grad(
            lambda q: cnn.xent_loss(cnn.cnn_forward(q, xb), yb))(p)
        return {k: v - LR * g[k] for k, v in p.items()}
    return train


def _model(seed):
    return jax.tree.map(np.asarray,
                        jcnn.init_cnn(jax.random.PRNGKey(seed), CFG))


def _close(got, want):
    want = flatten_tree(jax.tree.map(np.asarray, want))
    got = to_numpy(got)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("mode", sorted(CYCLES))
@pytest.mark.parametrize("threshold", [100.0, 3.0])
def test_cycle_matches_jax(mode, threshold):
    """Age 6 under a threshold of 100 (accepted) and of 3 (stale)."""
    m, f = _model(0), _model(1)
    t, ts_m, ts_f, gamma = 10.0, 4.0, 9.0, 0.3
    want_m, want_f, want_acc = getattr(jproto, CYCLES[mode])(
        jproto.DeviceState(m, jnp.float32(ts_m)),
        jproto.DeviceState(f, jnp.float32(ts_f)), jnp.float32(threshold),
        jnp.float32(t), _jax_trainer(_batch()), gamma=gamma)
    got_m, got_f, got_acc = getattr(tproto, CYCLES[mode])(
        tproto.DeviceState(params_from_numpy(m, "cpu"), torch.tensor(ts_m)),
        tproto.DeviceState(params_from_numpy(f, "cpu"), torch.tensor(ts_f)),
        torch.tensor(threshold), torch.tensor(t), _torch_trainer(_batch()),
        gamma=gamma)
    assert bool(got_acc) == bool(want_acc) == (threshold > 6.0)
    _close(got_m.model, want_m.model)
    _close(got_f.model, want_f.model)
    assert float(got_m.ts) == float(want_m.ts) == t
    assert float(got_f.ts) == float(want_f.ts) == t


def test_protocol_cycles_match_paper_order():
    """Fixed-device cycle trains AFTER aggregation; mobile cycle trains the
    mule AFTER receiving the aggregate. Both stamp timestamps to t."""
    t = torch.tensor(10.0)
    mule = tproto.DeviceState({"w": torch.ones(3)}, torch.tensor(4.0))
    fixed = tproto.DeviceState({"w": torch.zeros(3)}, torch.tensor(9.0))

    def train(m):
        return {"w": m["w"] + 100.0}

    new_m, new_f, acc = tproto.fixed_device_training_cycle(
        mule, fixed, torch.tensor(100.0), t, train, gamma=0.5)
    assert bool(acc)
    torch.testing.assert_close(new_f.model["w"], torch.full((3,), 100.5))
    torch.testing.assert_close(new_m.model["w"],
                               torch.full((3,), 0.5 * 1 + 0.5 * 100.5))
    assert float(new_m.ts) == 10.0 and float(new_f.ts) == 10.0

    new_m, new_f, acc = tproto.mobile_device_training_cycle(
        mule, fixed, torch.tensor(100.0), t, train, gamma=0.5)
    torch.testing.assert_close(new_f.model["w"], torch.full((3,), 0.5))
    torch.testing.assert_close(new_m.model["w"], torch.full((3,), 100.75))


def test_stale_model_does_not_contaminate():
    t = torch.tensor(1000.0)
    mule = tproto.DeviceState({"w": torch.full((3,), 77.0)}, torch.tensor(0.0))
    fixed = tproto.DeviceState({"w": torch.zeros(3)}, t)
    new_m, new_f, acc = tproto.mobile_device_training_cycle(
        mule, fixed, torch.tensor(10.0), t, lambda m: m, gamma=0.5)
    assert not bool(acc)
    torch.testing.assert_close(new_f.model["w"], torch.zeros(3))


@pytest.mark.parametrize("mode", sorted(CYCLES))
def test_population_step_matches_single_pair_protocol(mode):
    """One mule delivering to fixed device 0 of two: the port's vectorized
    step reproduces the port's cycle of the same mode, and leaves device 1
    untouched."""
    pcfg = PopulationConfig(
        mode=mode, n_fixed=2, n_mules=1, gamma=0.5,
        freshness=FreshnessConfig(warmup=0, init_threshold=1e9))
    gen = torch.Generator()
    gen.manual_seed(0)
    state = init_population(pcfg, lambda g: cnn.init_cnn(g, CFG), gen,
                            device="cpu")
    state = {**state, "t": torch.tensor(5.0),
             "mule_ts": torch.tensor([2.0])}
    x, y = (torch.tensor(a) for a in _batch())
    train = _torch_trainer(_batch())
    side = (x[None].expand(2, *x.shape), y[None].expand(2, *y.shape)) \
        if mode == "fixed" else (x[None], y[None])
    batches = {"fixed": side, "mule": None} if mode == "fixed" else \
        {"fixed": None, "mule": side}
    info = {"fixed_id": torch.tensor([0]), "exchange": torch.tensor([True])}
    new = population_step(state, info, batches,
                          lambda p, b, k: train(p), pcfg, key=1)

    pick = (lambda tree, i: {k: v[i] for k, v in tree.items()})
    want_m, want_f, acc = getattr(tproto, CYCLES[mode])(
        tproto.DeviceState(pick(state["mule_models"], 0),
                           state["mule_ts"][0]),
        tproto.DeviceState(pick(state["fixed_models"], 0), state["t"]),
        torch.tensor(1e9), state["t"], train, gamma=0.5)
    assert bool(acc)
    for k in want_f.model:
        torch.testing.assert_close(new["fixed_models"][k][0],
                                   want_f.model[k], atol=TOL, rtol=TOL)
        torch.testing.assert_close(new["mule_models"][k][0],
                                   want_m.model[k], atol=TOL, rtol=TOL)
        assert torch.equal(new["fixed_models"][k][1],
                           state["fixed_models"][k][1])
    assert float(new["mule_ts"][0]) == 5.0


def test_device_state_is_a_named_pair():
    assert tproto.DeviceState._fields == jproto.DeviceState._fields
