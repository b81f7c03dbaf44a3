"""Port's experiment harness (experiment.py) against ``benchmarks/common.py``.

The data layouts and schedules are numpy draws, bitwise the reference's
for the same config. Minibatch draws, pretraining keys and model inits
cannot match (``jax.random`` against ``torch.Generator``), so pretraining
is held to a loop of ``jax.vmap(train_fn)`` on injected draws (1e-5: a few
SGD steps of fp32 gradients), and ``run_experiment`` to the reference's
contract: the result keys and config, the trace's steps, accuracies in
[0, 1]. The reference's ``run_experiment`` compiles slowly, so it runs
once, at the tiny size, where the federated methods' trace steps (rounds
of 10 steps) coincide with the engine's (an eval every 10 steps).
"""
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import benchmarks.common as jcommon  # noqa: E402
from repro_torch import experiment as texp  # noqa: E402
from repro_torch.interop import flatten_tree, params_from_numpy, to_numpy  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY = dict(steps=20, eval_every=10, pretrain_steps=2, image_size=8,
            n_per_sub=8, n_mules=6)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_config_fields_and_defaults_match():
    assert dataclasses.asdict(texp.ExperimentConfig()) == \
        dataclasses.asdict(jcommon.ExperimentConfig())
    assert texp.METHODS_FIXED == jcommon.METHODS_FIXED


@pytest.mark.parametrize("dist", ["iid", "dir0.01", "shards"])
def test_image_data_fixed_bitwise(dist):
    kw = dict(dist=dist, seed=3, image_size=8, n_per_sub=8)
    want = jcommon._image_data_fixed(jcommon.ExperimentConfig(**kw))
    got = texp.image_data_fixed(texp.ExperimentConfig(**kw), device="cpu")
    for g, w in zip(got, want):
        _same(g.numpy(), w)


@pytest.mark.parametrize("pattern,scenario", [("4q", ""), ("0.1", "commuter"),
                                              ("0.1", "har_shift_worker")])
def test_mobility_tensors_bitwise(pattern, scenario):
    kw = dict(pattern=pattern, scenario=scenario, seed=2, n_mules=9,
              steps=120)
    want = jcommon._mobility_tensors(jcommon.ExperimentConfig(**kw))
    got = texp.mobility_tensors(texp.ExperimentConfig(**kw))
    assert sorted(got[0]) == sorted(want[0])
    for k in want[0]:
        _same(got[0][k], want[0][k])
    _same(got[1], want[1])
    _same(got[2], want[2])


def test_mobility_tensors_walk_shapes():
    """The walk draws from a torch.Generator (tests/test_torch_random_walk.py
    feeds it the reference's draws): shapes and dtypes only."""
    cfg = dict(pattern="0.5", seed=1, n_mules=7, steps=30)
    want = jcommon._mobility_tensors(jcommon.ExperimentConfig(**cfg))[0]
    got = texp.mobility_tensors(texp.ExperimentConfig(**cfg))[0]
    for k in want:
        assert (got[k].shape, got[k].dtype) == (want[k].shape, want[k].dtype)


def test_sample_batches_rows_come_from_their_own_pool():
    X = torch.arange(3 * 5).reshape(3, 5, 1).float()
    Y = torch.arange(3 * 5).reshape(3, 5)
    xb, yb = texp.sample_batches(4, X, Y, 7)
    assert tuple(xb.shape) == (3, 7, 1) and tuple(yb.shape) == (3, 7)
    assert torch.equal(xb[..., 0].long(), yb)
    assert ((yb // 5) == torch.arange(3)[:, None]).all()
    assert torch.equal(texp.sample_batches(4, X, Y, 7)[1], yb)
    assert not torch.equal(texp.sample_batches(5, X, Y, 7)[1], yb)


@functools.lru_cache(maxsize=None)
def _model_cfg():
    cfg = jcommon.ExperimentConfig(image_size=8)
    return cfg, jcommon._model_fns(cfg), texp.model_fns(
        texp.ExperimentConfig(image_size=8))


def test_make_pretrain_matches_a_loop_of_jax_vmap():
    """Three pretraining steps of 4 clients on injected draws."""
    jcfg, (jinit, jtrain, _), (_, ttrain, _) = _model_cfg()
    steps, n = 3, 4
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(steps, n, 5, 8, 8, 3)).astype(np.float32)
    ys = rng.integers(0, 20, (steps, n, 5)).astype(np.int32)
    models = jax.tree.map(np.asarray, jax.vmap(jinit)(
        jax.random.split(jax.random.PRNGKey(0), n)))
    want, step = models, jax.jit(jax.vmap(jtrain))
    for i in range(steps):
        want = step(want, (xs[i], ys[i]),
                    jax.random.split(jax.random.PRNGKey(i), n))
    seen = []

    def sampler(seed, i):
        seen.append(i)
        return torch.tensor(xs[i]), torch.tensor(ys[i])

    cfg = texp.ExperimentConfig(image_size=8, pretrain_steps=steps)
    got = texp.make_pretrain(ttrain, cfg, n, sampler)(
        params_from_numpy(models, "cpu"), 7)
    assert seen == [0, 1, 2]
    want = flatten_tree(jax.tree.map(np.asarray, want))
    got = to_numpy(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)


def test_model_fns_match_the_harness_models():
    """The harness's reduced CNN: the same parameter shapes, and the same
    loss step on the reference's weights."""
    jcfg, (jinit, jtrain, jeval), (tinit, ttrain, teval) = _model_cfg()
    p = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0)))
    gen = torch.Generator()
    got = tinit(gen)
    want = flatten_tree(p)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 20, 6).astype(np.int32)
    stepped = to_numpy(ttrain(params_from_numpy(p, "cpu"),
                              (torch.tensor(x), torch.tensor(y)), 0))
    ref = flatten_tree(jax.tree.map(np.asarray, jtrain(p, (x, y), None)))
    for k in ref:
        np.testing.assert_allclose(stepped[k], ref[k], atol=1e-5, rtol=1e-5)
    assert float(teval(params_from_numpy(p, "cpu"), torch.tensor(x),
                       torch.tensor(y))) == float(jeval(p, x, y))


@functools.lru_cache(maxsize=None)
def _reference_result():
    return jcommon.run_experiment(jcommon.ExperimentConfig(**TINY))


@pytest.mark.parametrize("method", texp.METHODS_FIXED)
def test_run_experiment_fixed_mode_contract(method):
    want = _reference_result()
    got = texp.run_experiment(texp.ExperimentConfig(method=method, **TINY),
                              device="cpu")
    assert sorted(got) == sorted(want)
    assert got["config"] == {**want["config"], "method": method}
    assert [s for s, _ in got["trace"]] == [s for s, _ in want["trace"]] \
        == [9, 19]
    for _, acc in got["trace"]:
        assert 0.0 <= acc <= 1.0
    for k in ("pre_local_acc", "post_local_acc"):
        assert 0.0 <= got[k] <= 1.0
    assert got["wall_s"] > 0


def test_run_with_models_state():
    """What the body hands back: the server models of fedavg and fedas
    (personal leaves unchanged by FedAS), CFL's clusters over the clients,
    and mlmule's engine arguments, whose replay gives its population."""
    fns = texp.model_fns(texp.ExperimentConfig(**TINY))
    _, st = texp.run_with_models(texp.ExperimentConfig(method="fedas",
                                                       **TINY), fns, "cpu")
    for k in ("fc2", "fc2_b"):
        assert torch.equal(st["global"][k], st["global0"][k])
    assert not torch.equal(st["global"]["fc1"], st["global0"]["fc1"])
    _, st = texp.run_with_models(texp.ExperimentConfig(method="cfl", **TINY),
                                 fns, "cpu")
    members = np.sort(np.concatenate(st["cfl"].clusters))
    np.testing.assert_array_equal(members, np.arange(8))
    _, st = texp.run_with_models(texp.ExperimentConfig(**TINY), fns, "cpu")
    again, _ = texp.run_population(**st["run"])
    for k, v in st["population"]["fixed_models"].items():
        assert torch.equal(again["fixed_models"][k], v)
    assert st["pretrain_s"] > 0 and st["run_s"] > 0


@pytest.mark.parametrize("field,item", [("distributed", "13b"),
                                        ("stream", "12")])
def test_unported_engines_raise_naming_their_item(field, item):
    """The engines of ROADMAP items 12 and 13b raised before they were
    ported; now each runs the harness on one process (the distributed
    engine cuts nothing there). The seed sweep over the distributed engine,
    which raised naming item 13c, runs too (``run_sweep_distributed``),
    and refuses re-bucketing."""
    cfg = texp.ExperimentConfig(**{field: True, **TINY})
    result, st = texp.run_with_models(cfg, texp.model_fns(cfg), "cpu")
    engine = {"12": "run_population_streamed",
              "13b": "run_population_distributed"}[item]
    assert st["engine"] == engine
    assert 0.0 <= result["pre_local_acc"] <= 1.0
    assert [s for s, _ in result["trace"]] == [9, 19]
    if field == "distributed":
        sweep = texp.run_sweep_experiment(cfg, [0, 1], device="cpu")
        got = sweep["methods"][cfg.method]
        assert len(got["final_acc"]) == 2
        assert all(0.0 <= a <= 1.0 for a in got["final_acc"])
        with pytest.raises(ValueError, match="re-bucket"):
            texp.run_sweep_experiment(
                dataclasses.replace(cfg, rebucket_every=10), [0, 1],
                device="cpu")


def test_quickstart_runs_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch_quickstart.py"),
         "--device", "cpu", "--steps", "20", "--eval-every", "10"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("per-space acc") == 2
    assert "import jax" not in open(os.path.join(
        ROOT, "examples", "torch_quickstart.py")).read()


# ---------------------------------------------------------------------------
# value-level parity: the reference's draws and initial models injected
# ---------------------------------------------------------------------------

# fixed mode on the 4Q trace (numpy, so both packages replay one schedule)
VALUE = dict(TINY, pattern="4q", mode="fixed")
# The port's models and the reference's differ by fp32 summation order
# (~1e-7 a step in the convolutions and matmuls), which SGD grows over the
# 2 pretraining and 20 engine steps; max-pool and ReLU ties could flip under
# such differences (ROADMAP §3), which the bound would catch as a jump. At
# this size the readings are 1.2e-7 and 2.4e-7 (no flip); the bound is the
# pretraining test's 1e-5.
VALUE_TOL = 1e-5


def reference_draws(jcfg, n_rows: int, pool: int, engine_runs: int,
                    post_local: int) -> list:
    """The minibatch indices ``[P, B]`` the reference draws, in the order
    the port's harness calls ``sample_batches``: pretraining (its
    ``split(key, 3)`` chain from ``PRNGKey(seed + 7)``), each engine run
    (``split(fold_in(ke, t))``, ``ke = split(PRNGKey(seed + 100))[1]``),
    then the post-local epochs (the chain continued from that split)."""
    def draw(k):
        return np.asarray(jax.random.randint(k, (n_rows, jcfg.batch), 0,
                                             pool))
    out, key = [], jax.random.PRNGKey(jcfg.seed + 7)
    for _ in range(jcfg.pretrain_steps):
        key, kb, _ = jax.random.split(key, 3)
        out.append(draw(kb))
    key, ke = jax.random.split(jax.random.PRNGKey(jcfg.seed + 100))
    for _ in range(engine_runs):
        for t in range(jcfg.steps):
            out.append(draw(jax.random.split(jax.random.fold_in(ke, t))[0]))
    for _ in range(post_local):
        key, kb, _ = jax.random.split(key, 3)
        out.append(draw(kb))
    return out


def injected_sampler(draws: list):
    """A ``sample_batches`` that ignores its seed and gathers the next of
    the reference's draws from the pool it is given."""
    it = iter(draws)

    def sample_batches(seed, X, Y, batch):
        idx = torch.tensor(next(it), device=X.device).long()
        assert tuple(idx.shape) == (X.shape[0], batch)
        rows = torch.arange(X.shape[0], device=X.device)[:, None]
        return X[rows, idx], Y[rows, idx]

    sample_batches.left = lambda: sum(1 for _ in it)
    return sample_batches


def reference_init(jcfg, n_clients: int, jinit):
    """An ``init_fn`` handing out the reference's initial models in the
    port's call order: the pretrained clients, then ``init_population``'s
    mules and fixed devices (all from ``PRNGKey(seed)``)."""
    from repro.core import population as jpop
    key = jax.random.PRNGKey(jcfg.seed)
    pre = jax.vmap(jinit)(jax.random.split(key, n_clients))
    pop = jpop.init_population(key, jinit, jpop.PopulationConfig(
        mode=jcfg.mode, n_fixed=jcfg.n_fixed, n_mules=jcfg.n_mules))
    rows = [jax.tree.map(lambda l, i=i: np.asarray(l[i]), tree)
            for tree, n in ((pre, n_clients),
                            (pop["mule_models"], jcfg.n_mules),
                            (pop["fixed_models"], jcfg.n_fixed))
            for i in range(n)]
    it = iter(rows)
    return lambda generator: params_from_numpy(next(it), "cpu")


def assert_models_close(got, want, tol=VALUE_TOL):
    got, want = to_numpy(got), flatten_tree(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=tol,
                                   err_msg=k)


def capture(monkeypatch, module, name: str) -> list:
    """Wrap ``module.name`` to record what each call returns."""
    seen, fn = [], getattr(module, name)

    def wrapped(*args, **kw):
        seen.append(fn(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(module, name, wrapped)
    return seen


@pytest.mark.parametrize("method", ["mlmule", "local"])
def test_run_experiment_values_match_the_reference(method, monkeypatch):
    """Fixed mode: the reference's draws and initial models injected, the
    port's final fixed-device models, eval trace and pre/post-local
    accuracies held to the reference's run."""
    jcfg = jcommon.ExperimentConfig(method=method, **VALUE)
    tcfg = texp.ExperimentConfig(method=method, **VALUE)
    runs = capture(monkeypatch, jcommon, "run_population")
    want = jcommon.run_experiment(jcfg)
    (ref_pop, _), = runs
    Xtr = texp.image_data_fixed(tcfg, "cpu")[0]
    draws = reference_draws(jcfg, Xtr.shape[0], Xtr.shape[1], 1,
                            jcfg.post_local_epochs)
    sampler = injected_sampler(draws)
    monkeypatch.setattr(texp, "sample_batches", sampler)
    jinit = jcommon._model_fns(jcfg)[0]
    _, ttrain, teval = texp.model_fns(tcfg)
    got, st = texp.run_with_models(
        tcfg, (reference_init(jcfg, jcfg.n_fixed, jinit), ttrain, teval),
        "cpu")
    assert sampler.left() == 0
    if method == "mlmule":
        assert int(st["population"]["fresh"]["count"].sum()) > 0
    assert_models_close(st["final_models"], ref_pop["fixed_models"])
    assert [s for s, _ in got["trace"]] == [s for s, _ in want["trace"]]
    np.testing.assert_allclose([a for _, a in got["trace"]],
                               [a for _, a in want["trace"]], atol=1e-6)
    for k in ("pre_local_acc", "post_local_acc"):
        assert got[k] == pytest.approx(want[k], abs=1e-6)
