"""Port's streamed schedule and streamed engine against the JAX package.

The compact arrays, the run-length expansion and the procedural commuter
stream are integer and boolean arithmetic, so they are held bitwise: the
port's ``compact_colocation`` and the reference's are given the same
colocation dict (every scenario the port registers, and schedules whose
exchange flags take the run-length fallback); ``CommuterStream`` is handed
the reference's per-mule arrays, since torch cannot draw ``jax.random``'s
bits. The streamed engine is held bitwise to the port's ``run_population``
over the materialized dict (both walk the same steps with the same global
indices), and to the reference's ``run_population_streamed`` as
``tests/test_torch_engine.py`` holds the materialized engines: freshness
counts, ring slots, timestamps and ``last_fid`` exact, thresholds to 1e-6
relative, weights to 1e-5 (a linear model, a few SGD steps).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import population as jpop  # noqa: E402
from repro.mobility import streaming as js  # noqa: E402
from repro.scenarios import run_population_streamed as jax_streamed  # noqa: E402
from repro_torch import experiment as tex  # noqa: E402
from repro_torch.core import population as tpop  # noqa: E402
from repro_torch.interop import flatten_tree, to_numpy  # noqa: E402
from repro_torch.mobility import dwell_exchange_flags  # noqa: E402
from repro_torch.mobility import streaming as ts  # noqa: E402
from repro_torch.scenarios import (get_scenario, list_scenarios,  # noqa: E402
                                   run_population, run_population_streamed,
                                   scenario_generator)
from repro_torch.scenarios.registry import _cadence  # noqa: E402

torch.set_num_threads(1)

D, LR = 5, 0.05


def _assert_equal_dicts(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].cpu().numpy() if isinstance(got[k], torch.Tensor) \
            else np.asarray(got[k])
        w = np.asarray(want[k])
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


# ---------------------------------------------------------------------------
# run-length code and compact schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,shape,dtype,pad", [
    (0, (12, 5), np.int32, -1), (1, (1, 3), np.int32, -1),
    (2, (30, 7), bool, False), (3, (9, 1), np.int32, 0)])
def test_rle_columns_matches_jax(seed, shape, dtype, pad):
    rng = np.random.default_rng(seed)
    arr = rng.integers(-1, 3, shape).astype(dtype)
    got = ts._rle_columns(arr, np.asarray(pad, dtype))
    want = js._rle_columns(arr, np.asarray(pad, dtype))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert ts._PAD_T == js._PAD_T


# (t0, chunk) windows of a 40-step schedule: inside runs, across chunk
# boundaries, one step, and the last
WINDOWS = [(0, 7), (7, 13), (20, 20), (39, 1), (0, 40)]


@pytest.mark.parametrize("name", list_scenarios())
def test_compact_colocation_matches_jax_on_every_scenario(name):
    spec = get_scenario(name)
    co = spec.colocation(0, 6, 40)
    cadence = _cadence(spec.spaces)
    got = ts.compact_colocation(co, cadence=cadence, device="cpu")
    want = js.compact_colocation(co, cadence=cadence)
    _assert_equal_dicts(got.arrays(), want.arrays())
    assert got.static_token() == want.static_token()
    assert got.schedule_bytes() == want.schedule_bytes()
    assert got.max_area == want.max_area
    for t0, c in WINDOWS:
        _assert_equal_dicts(got.generate_chunk(None, t0, c),
                            want.generate_chunk(None, t0, c))
    # the expansion is the source schedule
    full = ts.materialize_generator(got, chunk_len=9)
    for k in ("fixed_id", "exchange", "active"):
        if k in co:
            np.testing.assert_array_equal(full[k], co[k])
    np.testing.assert_array_equal(full["area"], co["area"])


@pytest.mark.parametrize("case", ["random_flags", "wrong_cadence",
                                  "per_place_cadence"])
def test_exchange_rle_fallback_matches_jax(case):
    rng = np.random.default_rng(11)
    fid = rng.integers(-1, 4, (25, 5)).astype(np.int32)
    if case == "random_flags":
        exch, cadence = rng.uniform(size=fid.shape) < 0.3, 3
    elif case == "wrong_cadence":
        exch, cadence = dwell_exchange_flags(fid, 2), 3
    else:
        cadence = np.array([1, 2, 4, 3])
        exch = dwell_exchange_flags(fid, cadence)
    co = {"fixed_id": fid, "exchange": exch,
          "pos": rng.uniform(size=(25, 5, 2)).astype(np.float32),
          "area": np.stack([rng.integers(0, 3, 5)] * 25).astype(np.int32),
          "active": rng.uniform(size=fid.shape) < 0.8}
    got = ts.compact_colocation(co, cadence=cadence, device="cpu")
    want = js.compact_colocation(co, cadence=cadence)
    assert ("exc_starts" in got.arrays()) == (case != "per_place_cadence")
    _assert_equal_dicts(got.arrays(), want.arrays())
    for t0, c in [(0, 5), (5, 11), (24, 1)]:
        _assert_equal_dicts(got.generate_chunk(None, t0, c),
                            want.generate_chunk(None, t0, c))


# ---------------------------------------------------------------------------
# the procedural commuter stream
# ---------------------------------------------------------------------------


def _streams(duty_period, m=40, t=500):
    want = js.commuter_stream(3, m, t, duty_period=duty_period)
    arrays = {k: np.asarray(v) for k, v in want.arrays().items()}
    got = ts.commuter_stream(3, m, t, duty_period=duty_period, arrays=arrays,
                             device="cpu")
    return got, want


@pytest.mark.parametrize("duty_period", [0, 24])
def test_commuter_stream_expand_matches_jax(duty_period):
    """Chunks across day boundaries (period 192), on day 0 (day - 1 < 0)
    and deep into the run."""
    got, want = _streams(duty_period)
    _assert_equal_dicts(got.arrays(), want.arrays())
    assert got.static_token() == want.static_token()
    assert got.schedule_bytes() == want.schedule_bytes()
    assert got.max_area == want.max_area
    for t0, c in [(0, 10), (185, 30), (380, 120), (191, 2)]:
        _assert_equal_dicts(got.generate_chunk(None, t0, c),
                            want.generate_chunk(None, t0, c))
    _assert_equal_dicts(got.init_fields(), want.init_fields())


@pytest.mark.parametrize("duty_period", [0, 24])
def test_materialize_generator_matches_jax(duty_period):
    got, want = _streams(duty_period)
    full = ts.materialize_generator(got, chunk_len=64)
    _assert_equal_dicts(full, js.materialize_generator(want, chunk_len=64))
    # the morning continues the previous evening: the flags are the dwell
    # cadence over the materialized grid, so compacting round-trips
    np.testing.assert_array_equal(
        dwell_exchange_flags(full["fixed_id"], 3), full["exchange"])
    again = ts.compact_colocation(full, device="cpu")
    assert "exc_starts" not in again.arrays()
    _assert_equal_dicts(ts.materialize_generator(again, chunk_len=50),
                        {k: full[k] for k in ("fixed_id", "exchange", "pos",
                                              "active", "area")})


def test_commuter_stream_draws_are_seeded_and_shaped():
    a = ts.commuter_stream(5, 30, 100, duty_period=12, device="cpu")
    b = ts.commuter_stream(5, 30, 100, duty_period=12, device="cpu")
    _assert_equal_dicts(a.arrays(), {k: v.numpy()
                                     for k, v in b.arrays().items()})
    arr = {k: v.numpy() for k, v in a.arrays().items()}
    assert all(v.dtype == np.int32 and v.shape == (30,) for v in arr.values())
    assert ((arr["work"] != arr["home"]) & (arr["home"] < 8)).all()
    assert (arr["stride"] % 2 == 1).all() and (arr["phase"] <= 8).all()
    np.testing.assert_array_equal(arr["ids"], np.arange(30))
    with pytest.raises(ValueError, match="arrays"):
        ts.commuter_stream(5, 30, 100, arrays={"home": arr["home"]},
                           device="cpu")


def test_reorder_generator_arrays_matches_jax():
    rng = np.random.default_rng(4)
    order = rng.permutation(6)
    co = get_scenario("multi_area_migratory").colocation(0, 6, 30)
    co["pos"] = rng.uniform(size=(30, 6, 2)).astype(np.float32)
    got_gen = ts.compact_colocation(co, device="cpu")
    want_gen = js.compact_colocation(co)
    got = ts.reorder_generator_arrays(got_gen, got_gen.arrays(), order)
    want = js.reorder_generator_arrays(want_gen, want_gen.arrays(), order)
    _assert_equal_dicts(got, want)
    stream, ref = _streams(24, m=6)
    _assert_equal_dicts(
        ts.reorder_generator_arrays(stream, stream.arrays(), order),
        js.reorder_generator_arrays(ref, ref.arrays(), order))


def test_scenario_generator_and_streaming_commuter():
    spec = get_scenario("streaming_commuter")
    assert spec.generator is ts.commuter_stream
    gen = scenario_generator("streaming_commuter", 2, 10, 50, device="cpu")
    assert isinstance(gen, ts.CommuterStream)
    _assert_equal_dicts(spec.colocation(2, 10, 50),
                        ts.materialize_generator(gen))
    compact = scenario_generator("mixed_cadence", 0, 6, 40, device="cpu")
    assert "cadence" in compact.arrays()       # per-space tempos, no RLE


# ---------------------------------------------------------------------------
# the streamed engine
# ---------------------------------------------------------------------------


def _torch_train(params, batch, key):
    xb, yb = batch
    g = torch.func.grad(
        lambda p: torch.mean((xb @ p["w"] + p["b"] - yb) ** 2))(params)
    return {k: p - LR * g[k] for k, p in params.items()}


def _jax_train(params, batch, key):
    xb, yb = batch
    g = jax.grad(lambda p: jnp.mean((xb @ p["w"] + p["b"] - yb) ** 2))(params)
    return jax.tree.map(lambda p, gg: p - LR * gg, params, g)


def _population(n_fixed, n_mules, mode="mobile", seed=0):
    rng = np.random.default_rng(seed)
    pcfg = jpop.PopulationConfig(mode=mode, n_fixed=n_fixed, n_mules=n_mules)
    pop = jpop.init_population(
        jax.random.PRNGKey(0),
        lambda k: {"w": jax.random.normal(k, (D,)),
                   "b": jax.random.normal(k, ())}, pcfg)
    pop = jax.tree.map(np.asarray, pop)
    pop["mule_models"]["w"] = rng.normal(size=(n_mules, D)).astype(np.float32)
    return pcfg, pop


def _torch_state(pop):
    return {"mule_models": {k: torch.tensor(v) for k, v in
                            pop["mule_models"].items()},
            "fixed_models": {k: torch.tensor(v) for k, v in
                             pop["fixed_models"].items()},
            "mule_ts": torch.tensor(pop["mule_ts"]),
            "fresh": {k: torch.tensor(v) for k, v in pop["fresh"].items()},
            "t": torch.tensor(pop["t"])}


def _stacked(n_steps, n, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_steps, n, 3, D)).astype(np.float32),
            rng.normal(size=(n_steps, n, 3)).astype(np.float32))


def _torch_eval(st, last):
    return st["mule_models"]["w"].sum(1) + last.float()


def _jax_eval(st, last):
    return st["mule_models"]["w"].sum(1) + last.astype(jnp.float32)


def _states_equal(a, b):
    for side in ("mule_models", "fixed_models"):
        for k in a[side]:
            assert torch.equal(a[side][k], b[side][k]), (side, k)
    for k in a["fresh"]:
        assert torch.equal(a["fresh"][k], b["fresh"][k]), k
    assert torch.equal(a["mule_ts"], b["mule_ts"])
    assert torch.equal(a["t"], b["t"])


@pytest.mark.parametrize("method", jpop.METHODS_MOBILE)
@pytest.mark.parametrize("scenario,chunk", [
    ("commuter_churn", 5), ("multi_area_migratory", 10),
    ("random_walk", 15), ("streaming_commuter", 30)])
def test_streamed_equals_materialized(method, scenario, chunk):
    """Bitwise, with stacked batches, evals every 5 steps and a trailing
    partial chunk (T = 32)."""
    spec = get_scenario(scenario)
    m, n_steps = 8, 32
    gen = scenario_generator(spec, 0, m, n_steps, device="cpu")
    co = ts.materialize_generator(gen)
    pcfg, pop = _population(spec.n_fixed, m)
    cfg = tpop.PopulationConfig(mode="mobile", n_fixed=spec.n_fixed,
                                n_mules=m)
    x, y = _stacked(n_steps, m)
    batches = {"fixed": None, "mule": (torch.tensor(x), torch.tensor(y))}
    kw = dict(batches=batches, train_fn=_torch_train, cfg=cfg, key=7,
              eval_every=5, eval_fn=_torch_eval, method=method,
              device="cpu")
    want, aux_w = run_population(_torch_state(pop), co, **kw)
    got, aux_g = run_population_streamed(_torch_state(pop), gen,
                                         chunk_len=chunk, **kw)
    _states_equal(got, want)
    assert torch.equal(aux_g["last_fid"], aux_w["last_fid"])
    np.testing.assert_array_equal(aux_g["eval_steps"], aux_w["eval_steps"])
    assert torch.equal(aux_g["evals"], aux_w["evals"])
    assert tuple(aux_g["evals"].shape) == (6, m)


def test_streamed_callable_batches_and_horizon():
    """Callable batches (keyed by the global step) and an ``n_steps``
    shorter than the generator's."""
    gen = scenario_generator("commuter", 0, 6, 40, device="cpu")
    co = {k: v[:23] if k not in ("area", "init_space", "init_area") else v
          for k, v in ts.materialize_generator(gen).items()}
    _, pop = _population(8, 6)
    cfg = tpop.PopulationConfig(mode="mobile", n_fixed=8, n_mules=6)

    def batches(seed, t):
        g = torch.Generator()
        g.manual_seed(seed)
        return {"fixed": None, "mule": (torch.randn(6, 3, D, generator=g),
                                        torch.randn(6, 3, generator=g))}

    want, aux_w = run_population(_torch_state(pop), co, batches,
                                 _torch_train, cfg, 3, method="mlmule+gossip",
                                 device="cpu")
    got, aux_g = run_population_streamed(
        _torch_state(pop), gen, batches, _torch_train, cfg, 3, n_steps=23,
        chunk_len=4, method="mlmule+gossip", device="cpu")
    _states_equal(got, want)
    assert torch.equal(aux_g["last_fid"], aux_w["last_fid"])
    assert aux_g["evals"] is None


def test_streamed_rejects_misaligned_chunks():
    gen = scenario_generator("commuter", 0, 6, 40, device="cpu")
    _, pop = _population(8, 6)
    cfg = tpop.PopulationConfig(mode="mobile", n_fixed=8, n_mules=6)
    kw = dict(batches=lambda s, t: None, train_fn=_torch_train, cfg=cfg,
              key=0, device="cpu")
    with pytest.raises(ValueError, match="multiple of eval_every"):
        run_population_streamed(_torch_state(pop), gen, chunk_len=7,
                                eval_every=5, eval_fn=_torch_eval, **kw)
    with pytest.raises(ValueError, match="positive"):
        run_population_streamed(_torch_state(pop), gen, chunk_len=0, **kw)
    with pytest.raises(ValueError, match="requires dcfg"):
        run_population_streamed(_torch_state(pop), gen, mesh=object(), **kw)


@pytest.mark.parametrize("method", jpop.METHODS_MOBILE)
def test_streamed_matches_jax_streamed(method):
    """The port's streamed engine against the reference's on
    ``commuter_churn`` (T = 24, chunks of 10, evals every 5)."""
    spec = get_scenario("commuter_churn")
    m, n_steps = 6, 24
    co = spec.colocation(0, m, n_steps)
    pcfg, pop = _population(spec.n_fixed, m)
    x, y = _stacked(n_steps, m, seed=3)
    want, aux_w = jax_streamed(
        jax.tree.map(jnp.asarray, pop), js.compact_colocation(co),
        {"fixed": None, "mule": (jnp.asarray(x), jnp.asarray(y))},
        _jax_train, pcfg, jax.random.PRNGKey(2), chunk_len=10, eval_every=5,
        eval_fn=_jax_eval, method=method, donate=False)
    got, aux_g = run_population_streamed(
        _torch_state(pop), ts.compact_colocation(co, device="cpu"),
        {"fixed": None, "mule": (torch.tensor(x), torch.tensor(y))},
        _torch_train, tpop.PopulationConfig(mode="mobile",
                                            n_fixed=spec.n_fixed, n_mules=m),
        2, chunk_len=10, eval_every=5, eval_fn=_torch_eval, method=method,
        device="cpu")
    port, ref = to_numpy(got), jax.tree.map(np.asarray, want)
    for side in ("mule_models", "fixed_models"):
        for k, w in flatten_tree(ref[side]).items():
            np.testing.assert_allclose(port[side][k], w, atol=1e-5,
                                       rtol=1e-5, err_msg=f"{side}/{k}")
    for k in ("ages", "count"):
        np.testing.assert_array_equal(port["fresh"][k], ref["fresh"][k])
    np.testing.assert_allclose(port["fresh"]["threshold"],
                               ref["fresh"]["threshold"], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(port["mule_ts"], ref["mule_ts"])
    np.testing.assert_array_equal(aux_g["last_fid"].numpy(),
                                  np.asarray(aux_w["last_fid"]))
    np.testing.assert_array_equal(aux_g["eval_steps"], aux_w["eval_steps"])
    np.testing.assert_allclose(aux_g["evals"].numpy(),
                               np.asarray(aux_w["evals"]), atol=1e-5,
                               rtol=1e-5)
    if method == "mlmule":
        assert int(port["fresh"]["count"].sum()) > 0


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scenario,method", [
    ("", "mlmule"), ("commuter", "gossip"), ("streaming_commuter", "mlmule")])
def test_run_with_models_stream_equals_materialized(scenario, method):
    """``ExperimentConfig.stream`` replays the same run: final models,
    traces and accuracies bitwise."""
    cfg = tex.ExperimentConfig(scenario=scenario, mode="mobile",
                               method=method, steps=20, eval_every=10,
                               n_mules=6, pretrain_steps=2, image_size=8,
                               n_per_sub=4)
    fns = tex.model_fns(tex.with_scenario(cfg))
    base, st_b = tex.run_with_models(cfg, fns, device="cpu")
    streamed, st_s = tex.run_with_models(
        dataclasses.replace(cfg, stream=True, stream_chunk=10), fns,
        device="cpu")
    assert st_s["engine"] == "run_population_streamed"
    assert st_b["engine"] == "run_population"
    for k, v in st_b["final_models"].items():
        assert torch.equal(st_s["final_models"][k], v), k
    assert streamed["trace"] == base["trace"]
    assert streamed["pre_local_acc"] == base["pre_local_acc"]
    assert len(base["trace"]) == 2
