"""Port's population step and scenario engine against the JAX package.

Keys cannot be carried across, so both packages get the same injected
inputs: the reference's initial population (``population_from_numpy``),
the registry's colocation schedule, and stacked ``[T, ...]`` batches made
with numpy; the train function ignores its key, like the reference
harness's. Freshness counts, ring slots, timestamps and ``last_fid`` are
compared exactly, so no delivery was accepted on one side and refused on
the other. Thresholds are held to 1e-6 relative: inside the compiled scan
XLA fuses the threshold EMA, whose last bits then drift a few ulp from the
eager arithmetic both packages do outside it. Weights are compared at
1e-4: each step adds float32 differences of ~1e-6 (convolution and matmul
summation order) and 24 SGD steps grow them.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.mule_cnn import smoke_config as jax_smoke_config  # noqa: E402
from repro.baselines.gossip import encounter_matrix as jax_encounter_matrix  # noqa: E402
from repro.core import population as jpop  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.scenarios import get_scenario as jax_get_scenario  # noqa: E402
from repro.scenarios import run_population as jax_run_population  # noqa: E402
from repro_torch.core import population as tpop  # noqa: E402
from repro_torch.interop import (flatten_tree, population_from_numpy,  # noqa: E402
                                 to_numpy)
from repro_torch.models import cnn  # noqa: E402
from repro_torch.scenarios import run_population  # noqa: E402

torch.set_num_threads(1)

N_FIXED, N_MULES, N_STEPS, EVAL_EVERY, BATCH, N_TEST, LR = 8, 6, 24, 10, 4, 8, 0.05
TOL = 1e-4
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


def _data(n, n_steps, seed):
    rng = np.random.default_rng(seed)
    s = CFG.image_size
    x = rng.normal(size=(n_steps, n, BATCH, s, s, 3)).astype(np.float32)
    y = rng.integers(0, CFG.n_classes, (n_steps, n, BATCH)).astype(np.int32)
    xt = rng.normal(size=(N_FIXED, N_TEST, s, s, 3)).astype(np.float32)
    yt = rng.integers(0, CFG.n_classes, (N_FIXED, N_TEST)).astype(np.int32)
    return x, y, xt, yt


@functools.lru_cache(maxsize=None)
def _jax_population(mode):
    pcfg = jpop.PopulationConfig(mode=mode, n_fixed=N_FIXED, n_mules=N_MULES)
    pop = jax.jit(lambda k: jpop.init_population(
        k, lambda kk: jcnn.init_cnn(kk, CFG), pcfg))(jax.random.PRNGKey(0))
    return pcfg, jax.tree.map(np.asarray, pop)


def _torch_cfg(mode):
    return tpop.PopulationConfig(mode=mode, n_fixed=N_FIXED, n_mules=N_MULES)


def _assert_states_close(port, ref):
    port, ref = to_numpy(port), jax.tree.map(np.asarray, ref)
    for side in ("mule_models", "fixed_models"):
        want = flatten_tree(ref[side])
        assert sorted(port[side]) == sorted(want)
        for k in want:
            np.testing.assert_allclose(port[side][k], want[k], atol=TOL,
                                       rtol=TOL, err_msg=f"{side}/{k}")
    np.testing.assert_array_equal(port["mule_ts"], ref["mule_ts"])
    np.testing.assert_array_equal(port["t"], ref["t"])
    for k in ("ages", "count"):
        np.testing.assert_array_equal(port["fresh"][k], ref["fresh"][k],
                                      err_msg=f"fresh/{k}")
    np.testing.assert_allclose(port["fresh"]["threshold"],
                               ref["fresh"]["threshold"], rtol=1e-6, atol=0)


@pytest.mark.parametrize("mode,aggregation", [
    ("fixed", "weighted"), ("mobile", "weighted"), ("mobile", "prox")])
def test_population_step_matches_jax(mode, aggregation):
    """One step from a state with live freshness history, under churn."""
    pcfg, pop = _jax_population(mode)
    pcfg = dataclasses.replace(pcfg, aggregation=aggregation)
    rng = np.random.default_rng(3)
    pop = {**pop,
           "mule_ts": rng.integers(0, 5, N_MULES).astype(np.float32),
           "t": np.float32(5.0),
           "fresh": {**pop["fresh"],
                     "count": rng.integers(0, 7, N_FIXED).astype(np.int32),
                     "threshold": rng.uniform(0, 4, N_FIXED)
                     .astype(np.float32)}}
    info = {"fixed_id": rng.integers(-1, N_FIXED, N_MULES).astype(np.int32),
            "exchange": rng.uniform(size=N_MULES) < 0.8,
            "active": rng.uniform(size=N_MULES) < 0.8}
    n = N_FIXED if mode == "fixed" else N_MULES
    x, y, _, _ = _data(n, 1, seed=4)
    side = "fixed" if mode == "fixed" else "mule"
    other = "mule" if mode == "fixed" else "fixed"
    want = jax.jit(lambda s, i, b: jpop.population_step(
        s, i, b, _jax_train, pcfg, jax.random.PRNGKey(0)))(
        pop, {k: jnp.asarray(v) for k, v in info.items()},
        {side: (jnp.asarray(x[0]), jnp.asarray(y[0])), other: None})
    got = tpop.population_step(
        population_from_numpy(pop, device="cpu"),
        {"fixed_id": torch.tensor(info["fixed_id"]).long(),
         "exchange": torch.tensor(info["exchange"]),
         "active": torch.tensor(info["active"])},
        {side: (torch.tensor(x[0]), torch.tensor(y[0])), other: None},
        _torch_train, dataclasses.replace(_torch_cfg(mode),
                                          aggregation=aggregation), key=0)
    _assert_states_close(got, want)
    assert int(got["fresh"]["count"].sum()) > int(pop["fresh"]["count"].sum())


def _jax_eval(x_test, y_test):
    def ev(st, last):
        return jax.vmap(lambda p, xx, yy: jcnn.xent_loss(
            jcnn.cnn_forward(p, xx), yy))(st["mule_models"], x_test[last],
                                          y_test[last])
    return ev


def _torch_eval(x_test, y_test):
    def ev(st, last):
        return torch.func.vmap(lambda p, xx, yy: cnn.xent_loss(
            cnn.cnn_forward(p, xx), yy))(st["mule_models"], x_test[last],
                                         y_test[last])
    return ev


def _encounters(co):
    """Peer encounters at the cadence steps t % 3 == 2 (radius 0.15)."""
    act = co.get("active")
    return sum(int(np.asarray(jax_encounter_matrix(
        jnp.asarray(co["pos"][t]), jnp.asarray(co["area"]), 0.15,
        None if act is None else jnp.asarray(act[t]))).sum())
        for t in range(2, N_STEPS, 3))


@pytest.mark.parametrize("method", jpop.METHODS_MOBILE)
@pytest.mark.parametrize("scenario", ["commuter", "commuter_churn",
                                      "random_walk"])
def test_run_population_matches_jax(method, scenario):
    """Mobile mode, T=24 with an eval every 10 steps: two evals and an
    unevaluated trailing chunk of 4 steps. ``random_walk`` is the
    reference's ``jax.random`` schedule, injected as numpy."""
    pcfg, pop = _jax_population("mobile")
    co = jax_get_scenario(scenario).colocation(0, N_MULES, N_STEPS)
    delivers = co["exchange"] & (co["fixed_id"] >= 0)
    if "active" in co:
        delivers &= co["active"]
        assert not co["active"].all()
    assert delivers.any(), "the schedule delivers nothing: parity is vacuous"
    assert _encounters(co) > 0, "no peer encounter: parity is vacuous"
    x, y, xt, yt = _data(N_MULES, N_STEPS, seed=1)

    want, aux_j = jax_run_population(
        pop, co, {"fixed": None, "mule": (jnp.asarray(x), jnp.asarray(y))},
        _jax_train, pcfg, jax.random.PRNGKey(2), eval_every=EVAL_EVERY,
        eval_fn=_jax_eval(jnp.asarray(xt), jnp.asarray(yt)), method=method)
    got, aux_t = run_population(
        population_from_numpy(pop, device="cpu"), co,
        {"fixed": None, "mule": (torch.tensor(x), torch.tensor(y))},
        _torch_train, _torch_cfg("mobile"), 2, eval_every=EVAL_EVERY,
        eval_fn=_torch_eval(torch.tensor(xt), torch.tensor(yt)),
        method=method, device="cpu")

    _assert_states_close(got, want)
    np.testing.assert_array_equal(aux_t["last_fid"].numpy(),
                                  np.asarray(aux_j["last_fid"]))
    np.testing.assert_array_equal(aux_t["eval_steps"], [9, 19])
    np.testing.assert_array_equal(aux_t["eval_steps"], aux_j["eval_steps"])
    assert tuple(aux_t["evals"].shape) == (2, N_MULES)
    np.testing.assert_allclose(aux_t["evals"].numpy(),
                               np.asarray(aux_j["evals"]), atol=TOL, rtol=TOL)
    if method == "mlmule":
        assert int(got["fresh"]["count"].sum()) > 0   # deliveries accepted


def test_callable_batches_and_time_varying_area():
    """The callable-batches path and a [T, M] area column give the stacked
    run's state, since the batch function and mlmule ignore seed and area."""
    _, pop = _jax_population("mobile")
    co = jax_get_scenario("commuter").colocation(0, N_MULES, 12)
    x, y, _, _ = _data(N_MULES, 12, seed=2)
    stacked = {"fixed": None, "mule": (torch.tensor(x), torch.tensor(y))}
    cfg = _torch_cfg("mobile")
    base, aux = run_population(population_from_numpy(pop, device="cpu"), co,
                               stacked, _torch_train, cfg, 0, device="cpu")
    assert aux["evals"] is None and len(aux["eval_steps"]) == 0
    moving = {**co, "area": np.random.default_rng(0).integers(
        0, 2, (12, N_MULES)).astype(np.int32)}
    other, _ = run_population(
        population_from_numpy(pop, device="cpu"), moving,
        lambda seed, t: {"fixed": None, "mule": (stacked["mule"][0][t],
                                                 stacked["mule"][1][t])},
        _torch_train, cfg, 0, device="cpu")
    for k in base["mule_models"]:
        torch.testing.assert_close(other["mule_models"][k],
                                   base["mule_models"][k], atol=0, rtol=0)


def test_init_population_and_eval_population():
    """Ready-made weights give the interop state; eval_population vmaps
    an eval over the population like the reference's."""
    _, pop = _jax_population("mobile")
    state = population_from_numpy(pop, device="cpu")
    made = tpop.init_population(
        _torch_cfg("mobile"),
        weights={k: state[k] for k in ("mule_models", "fixed_models")},
        device="cpu")
    for side in ("mule_models", "fixed_models"):
        for k, v in state[side].items():
            assert torch.equal(made[side][k], v)
    for k in ("ages", "count", "threshold"):
        assert torch.equal(made["fresh"][k], state["fresh"][k])
    assert torch.equal(made["mule_ts"], state["mule_ts"])
    assert torch.equal(made["t"], state["t"])
    _, _, xt, yt = _data(N_MULES, 1, seed=6)
    want = jpop.eval_population(
        jax.tree.map(jnp.asarray, pop["fixed_models"]),
        jax.jit(lambda p, d: jcnn.xent_loss(jcnn.cnn_forward(p, d[0]), d[1])),
        (jnp.asarray(xt), jnp.asarray(yt)))
    got = tpop.eval_population(
        state["fixed_models"],
        lambda p, d: cnn.xent_loss(cnn.cnn_forward(p, d[0]), d[1]),
        (torch.tensor(xt), torch.tensor(yt)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_unknown_method_names_the_five():
    _, pop = _jax_population("mobile")
    co = jax_get_scenario("commuter").colocation(0, N_MULES, 2)
    with pytest.raises(ValueError, match="unknown method") as err:
        run_population(population_from_numpy(pop, device="cpu"), co,
                       lambda s, t: None, _torch_train, _torch_cfg("mobile"),
                       0, method="fedavg", device="cpu")
    for m in jpop.METHODS_MOBILE:
        assert repr(m) in str(err.value)
