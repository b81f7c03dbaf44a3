"""Port's multi-area mobility and scenarios against the JAX package.

The traces, masks and schedules are numpy draws from
``np.random.default_rng``, so the port's are bitwise the reference's for
the same seed. The engine runs both scenarios on a linear model with the
reference's injected population and stacked batches, held to the
reference's run at ``TOL`` of ``tests/test_torch_engine.py`` (1e-4), its
freshness counts and ``last_fid`` exactly; ``multi_area_migratory`` hands
the engine a ``[T, M]`` area. ``examples/torch_run_scenario.py`` runs in a
subprocess.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.mobility as jmob  # noqa: E402
import repro.mobility.trace as jtrace  # noqa: E402
import repro.scenarios as jsc  # noqa: E402
from repro.core import population as jpop  # noqa: E402
from repro.scenarios.registry import ChurnSpec as JChurnSpec  # noqa: E402
import repro_torch.mobility as tmob  # noqa: E402
import repro_torch.scenarios as tsc  # noqa: E402
from repro_torch.core import population as tpop  # noqa: E402
from repro_torch.interop import population_from_numpy, to_numpy  # noqa: E402
from repro_torch.kernels.encounter_mix import encounter_mix_reference  # noqa: E402
from repro_torch.scenarios.registry import ChurnSpec  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SCENARIOS = ("multi_area_3city", "multi_area_migratory")
M, T, B, LR, TOL = 16, 24, 4, 0.05, 1e-4


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_areas", [2, 3])
def test_multi_area_trace_bitwise(seed, n_areas):
    kw = dict(n_users=17, n_places=4 * n_areas, n_steps=400,
              n_areas=n_areas, p_travel=0.2)
    got = tmob.multi_area_trace(seed, **kw)
    _same(got, jmob.multi_area_trace(seed, **kw))
    assert len(got) and set(got[:, 1] // 4) <= set(range(n_areas))


def test_multi_area_trace_wants_four_places_an_area():
    for mod in (tmob, jmob):
        with pytest.raises(ValueError, match=r"4 \* n_areas"):
            mod.multi_area_trace(0, n_places=10, n_areas=3)


@pytest.mark.parametrize("kw", [{}, dict(period=40, on_frac=0.3, jitter=0),
                                dict(period=7, on_frac=0.05, jitter=30)])
def test_duty_cycle_mask_bitwise(kw):
    for seed in (0, 5):
        got = tmob.duty_cycle_mask(seed, 300, 11, **kw)
        _same(got, jmob.duty_cycle_mask(seed, 300, 11, **kw))
        assert got.any(axis=1).all()          # one mule active every step


def test_duty_cycle_churn_kind():
    params = (("period", 30), ("on_frac", 0.4))
    got = ChurnSpec(kind="duty_cycle", params=params).mask(3, 90, 9)
    _same(got, JChurnSpec(kind="duty_cycle", params=params).mask(3, 90, 9))
    with pytest.raises(ValueError, match="duty_cycle"):
        ChurnSpec(kind="no_such_kind").mask(0, 5, 3)


def test_area_over_time_bitwise():
    co = jsc.get_scenario("multi_area_3city").colocation(1, 14, 200)
    init = np.arange(14) % 3
    _same(tmob.area_over_time(co["fixed_id"], init),
          jmob.area_over_time(co["fixed_id"], init))
    # corridor steps keep the last visit's area; before any visit init_area
    fid = np.array([[-1, 5], [9, -1], [-1, -1], [2, 0]], np.int32)
    want = np.array([[7, 1], [2, 1], [2, 1], [0, 0]], np.int32)
    got = tmob.area_over_time(fid, np.array([7, 8]))
    _same(got, want)
    _same(got, jmob.area_over_time(fid, np.array([7, 8])))


@pytest.mark.parametrize("cadence", [3, "per-place"])
def test_trace_to_colocation_loop_bitwise(cadence):
    visits = tmob.multi_area_trace(2, n_users=12, n_steps=300, p_travel=0.3)
    if cadence == "per-place":
        cadence = np.array([1, 2, 4, 8, 3, 6, 2, 5, 1, 3, 2, 7])
    got = tmob.trace_to_colocation_loop(visits, 12, 300, cadence)
    _same(got, jtrace.trace_to_colocation_loop(visits, 12, 300, cadence))
    _same(got, tmob.trace_to_colocation(visits, 12, 300, cadence))


@pytest.mark.parametrize("name", SCENARIOS)
@pytest.mark.parametrize("seed", [0, 3])
def test_multi_area_scenarios_bitwise(name, seed):
    t, j = tsc.get_scenario(name), jsc.get_scenario(name)
    assert (t.mode, t.dist, t.task, t.n_fixed) == (j.mode, j.dist, j.task,
                                                   j.n_fixed) == \
        ("mobile", "shards", "image", 12)
    got = t.colocation(seed, 20, 300)
    _same(got, j.colocation(seed, 20, 300))
    want_area = (300, 20) if name == "multi_area_migratory" else (20,)
    assert got["area"].shape == want_area
    assert int(got["fixed_id"].max()) < 12


def test_only_streaming_commuter_stays_deferred():
    """``streaming_commuter`` was the last scenario deferred (item 12); it
    is registered now, with its native generator, and none is left."""
    missing = set(jsc.list_scenarios()) - set(tsc.list_scenarios())
    assert missing == set()
    spec, ref = tsc.get_scenario("streaming_commuter"), \
        jsc.get_scenario("streaming_commuter")
    assert spec.generator is not None
    assert (spec.mode, spec.dist, spec.task, spec.n_fixed) == \
        (ref.mode, ref.dist, ref.task, ref.n_fixed)


def _linear_population():
    pcfg = jpop.PopulationConfig(mode="mobile", n_fixed=12, n_mules=M)
    pop = jpop.init_population(
        jax.random.PRNGKey(0), lambda k: {"w": jax.random.normal(k, (5,))},
        pcfg)
    return pcfg, jax.tree.map(np.asarray, pop)


def _jax_train(params, batch, key):
    xb, yb = batch
    g = jax.grad(lambda p: jnp.mean((xb @ p["w"] - yb) ** 2))(params)
    return jax.tree.map(lambda p, gg: p - LR * gg, params, g)


def _torch_train(params, batch, key):
    xb, yb = batch
    g = torch.func.grad(
        lambda p: torch.mean((xb @ p["w"] - yb) ** 2))(params)
    return {k: p - LR * g[k] for k, p in params.items()}


@pytest.mark.parametrize("method", ["mlmule", "gossip", "mlmule+gossip"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_engine_on_multi_area_matches_jax(name, method):
    """12 fixed devices; the migratory scenario's area changes over time,
    and each exchange must mix only within the step's area."""
    pcfg, pop = _linear_population()
    co = jsc.get_scenario(name).colocation(1, M, T)
    assert (co["exchange"] & (co["fixed_id"] >= 0)).any()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(T, M, B, 5)).astype(np.float32)
    y = rng.normal(size=(T, M, B)).astype(np.float32)
    want, aux_j = jsc.run_population(
        pop, co, {"fixed": None, "mule": (jnp.asarray(x), jnp.asarray(y))},
        _jax_train, pcfg, jax.random.PRNGKey(3), method=method)
    got, aux_t = tsc.run_population(
        population_from_numpy(pop, "cpu"), co,
        {"fixed": None, "mule": (torch.tensor(x), torch.tensor(y))},
        _torch_train, tpop.PopulationConfig(mode="mobile", n_fixed=12,
                                            n_mules=M), 3, method=method,
        device="cpu")
    got, want = to_numpy(got), jax.tree.map(np.asarray, want)
    for side in ("mule_models", "fixed_models"):
        np.testing.assert_allclose(got[side]["w"], want[side]["w"],
                                   atol=TOL, rtol=TOL, err_msg=side)
    for k in ("ages", "count"):
        np.testing.assert_array_equal(got["fresh"][k], want["fresh"][k])
    np.testing.assert_array_equal(aux_t["last_fid"].numpy(),
                                  np.asarray(aux_j["last_fid"]))
    if "gossip" in method:
        area = np.asarray(co["area"])
        for t in range(2, T, 3):
            at = torch.as_tensor(area[t] if area.ndim == 2 else area)
            _, mass = encounter_mix_reference(
                torch.zeros(M, 2), at, None, torch.eye(M), radius=0.15)
            same_area = (at[:, None] == at[None, :]).sum(1) - 1
            assert torch.equal(mass, same_area.float())


def _script(*args):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "torch_run_scenario.py"), *args],
        env=env, capture_output=True, text=True, timeout=300)


def test_run_scenario_lists_and_runs_on_the_cpu():
    out = _script("--list")
    assert out.returncode == 0, out.stderr
    names = [line.split()[0] for line in out.stdout.splitlines()]
    assert names == tsc.list_scenarios()
    out = _script("--device", "cpu", "--scenario", "multi_area_migratory",
                  "--method", "gossip", "--steps", "20", "--n-mules", "6")
    assert out.returncode == 0, out.stderr
    assert "scenario=multi_area_migratory" in out.stdout
    acc = float(out.stdout.split("final pre-local acc")[1].split()[0])
    assert 0.0 <= acc <= 1.0
    assert "import jax" not in open(os.path.join(
        ROOT, "examples", "torch_run_scenario.py")).read()


# each flag with what it needs beside it
_WITH = {"--stream-chunk": ["--stream"], "--processes": ["--distributed"],
         "--rebucket-every": ["--distributed", "--stream-chunk", "4"],
         "--rebucket-threshold": ["--distributed", "--rebucket-every", "4"]}


@pytest.mark.parametrize("flag,item", [
    (["--stream"], "12"), (["--stream-chunk", "8"], "12"),
    (["--distributed"], "13b"), (["--processes", "2"], "13b"),
    (["--rebucket-every", "4"], "13b"),
    (["--rebucket-threshold", "0.3"], "13b")])
def test_run_scenario_unported_flags_raise(flag, item):
    """The flags of ROADMAP items 12 and 13b raised before those engines
    were ported; now each runs the driver end to end on the CPU (with
    --processes as 2 gloo ranks), and --rebucket-every without
    --distributed is refused. A chunk of 8 steps is refused against the
    harness's eval cadence of 50 steps, and a chunk of 50 runs."""
    if flag[0] == "--stream-chunk":
        refused = _script("--device", "cpu", "--steps", "8", *flag,
                          "--stream")
        assert refused.returncode != 0
        assert "multiple of eval_every=50" in refused.stderr
        flag = ["--stream-chunk", "50"]
    out = _script("--device", "cpu", "--scenario", "multi_area_migratory",
                  "--method", "gossip", "--steps", "8", "--n-mules", "4",
                  *flag, *_WITH.get(flag[0], []))
    assert out.returncode == 0, out.stderr
    acc = float(out.stdout.split("final pre-local acc")[1].split()[0])
    assert 0.0 <= acc <= 1.0
    tag = "[streamed]" if item == "12" else "[distributed]"
    assert tag in out.stdout
    if flag[0] == "--processes":
        assert "1 pod x 2 mule shards" in out.stdout
    if item == "13b":
        refused = _script("--device", "cpu", "--rebucket-every", "4")
        assert refused.returncode != 0 and "--distributed" in refused.stderr
