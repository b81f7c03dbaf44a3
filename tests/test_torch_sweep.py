"""Port's seed sweep (``scenarios/sweep.py``), its lane-batched kernel
entries and ``experiment.run_sweep_experiment`` against the JAX package.

- Lane ``i`` of the port's ``run_sweep`` against lane ``i`` of the
  reference's, for the five ``METHODS_MOBILE``, on a linear model with the
  reference's injected populations, walk schedules (one lane churned) and
  stacked batches: weights at ``TOL`` of ``tests/test_torch_engine.py``
  (1e-4), freshness counts and ``last_fid`` exactly.
- Lane ``i`` against the port's own sequential ``run_population`` with key
  ``i``, on the narrow CNN with callable batches and per-seed context:
  bitwise. On the CPU the vmapped step computes each lane with the
  sequential step's arithmetic (the convolutions' batching rule folds the
  lanes into groups), so nothing differs.
- The reference's ``tests/test_sweep.py`` cases: a shared schedule, the
  method dict, per-seed context.
- The kernels' vmap rules and lane-batched plain versions on the CPU, and
  ``cuda``-marked checks of the CUDA entries that skip without a card.
- ``run_sweep_experiment`` for one lane against the reference's, with the
  reference's draws and initial models injected, and its contract.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import benchmarks.common as jcommon  # noqa: E402
from repro.core import population as jpop  # noqa: E402
from repro.scenarios import run_sweep as jax_run_sweep  # noqa: E402
from repro.scenarios import stack_colocations as jax_stack_colocations  # noqa: E402
from repro.scenarios import stack_trees as jax_stack_trees  # noqa: E402
from repro.scenarios import walk_colocation as jax_walk  # noqa: E402
from repro_torch import experiment as texp  # noqa: E402
from repro_torch.configs.mule_cnn import smoke_config  # noqa: E402
from repro_torch.core import METHODS_MOBILE, population as tpop  # noqa: E402
from repro_torch.core.seeds import fold_in, split  # noqa: E402
from repro_torch.interop import population_from_numpy, to_numpy  # noqa: E402
from repro_torch.kernels.encounter_mix import (  # noqa: E402
    encounter_mix, encounter_mix_lanes, encounter_mix_lanes_reference,
    encounter_mix_op, encounter_mix_reference)
from repro_torch.kernels.mule_agg import (mule_agg, mule_agg_lanes,  # noqa: E402
                                          mule_agg_lanes_plain, mule_agg_op,
                                          mule_agg_plain)
from repro_torch.mobility import markov_churn_mask  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.scenarios import (run_population, run_sweep,  # noqa: E402
                                   run_sweep_distributed, stack_colocations,
                                   stack_trees, walk_colocation)
from test_torch_experiment import (VALUE, assert_models_close,  # noqa: E402
                                   capture, injected_sampler,
                                   reference_draws, reference_init)

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
F, M, T, S, B, LR, TOL = 8, 8, 18, 3, 4, 0.05, 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


# -- lane i against the reference's lane i (linear model) --------------------


def _jax_train(params, batch, key):
    xb, yb = batch
    g = jax.grad(lambda p: jnp.mean((xb @ p["w"] - yb) ** 2))(params)
    return jax.tree.map(lambda p, gg: p - LR * gg, params, g)


def _torch_train(params, batch, key):
    xb, yb = batch
    g = torch.func.grad(
        lambda p: torch.mean((xb @ p["w"] - yb) ** 2))(params)
    return {k: p - LR * g[k] for k, p in params.items()}


def _cfg():
    return tpop.PopulationConfig(mode="mobile", n_fixed=F, n_mules=M)


def _met_pairs(cos) -> int:
    """Peer encounters at the exchange steps t % 3 == 2, over the lanes."""
    n = 0
    for co in cos:
        act = co.get("active")
        for t in range(2, T, 3):
            _, mass = encounter_mix_reference(
                torch.as_tensor(co["pos"][t]), torch.as_tensor(co["area"]),
                None if act is None else torch.as_tensor(act[t]),
                torch.zeros(M, 1), radius=0.15)
            n += int(mass.sum())
    return n


@functools.lru_cache(maxsize=None)
def _linear_lanes():
    """Per-lane reference populations and walk schedules (lane 1 churned),
    stacked [S, T, ...] batches, and the reference's sweep of all five
    methods with an eval every 6 steps."""
    pcfg = jpop.PopulationConfig(mode="mobile", n_fixed=F, n_mules=M)
    pops = [jax.tree.map(np.asarray, jpop.init_population(
        jax.random.PRNGKey(s), lambda k: {"w": jax.random.normal(k, (5,))},
        pcfg)) for s in range(S)]
    cos = [jax.tree.map(np.asarray, jax_walk(s, M, T)) for s in range(S)]
    cos[1]["active"] = markov_churn_mask(4, T, M)
    assert _met_pairs(cos) > 0, "no encounter: the peer parity is vacuous"
    rng = np.random.default_rng(0)
    x = rng.normal(size=(S, T, M, B, 5)).astype(np.float32)
    y = rng.normal(size=(S, T, M, B)).astype(np.float32)
    xt = rng.normal(size=(F, 6, 5)).astype(np.float32)
    xt_j = jnp.asarray(xt)

    def j_eval(st, last):
        return jnp.mean((xt_j[last] @ st["mule_models"]["w"][:, :, None])
                        [..., 0], axis=1)

    out = jax_run_sweep(
        jax_stack_trees(pops), jax_stack_colocations(cos),
        {"fixed": None, "mule": (jnp.asarray(x), jnp.asarray(y))},
        _jax_train, pcfg,
        jax_stack_trees([jax.random.PRNGKey(100 + s) for s in range(S)]),
        eval_every=6, eval_fn=j_eval, methods=METHODS_MOBILE)
    return pops, cos, x, y, xt, jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("method", METHODS_MOBILE)
def test_run_sweep_lanes_match_the_reference(method):
    pops, cos, x, y, xt, out = _linear_lanes()
    xt_t = torch.tensor(xt)

    def t_eval(st, last):
        return torch.mean((xt_t[last] @ st["mule_models"]["w"][:, :, None])
                          [..., 0], dim=1)

    got, aux = run_sweep(
        stack_trees([population_from_numpy(p, "cpu") for p in pops]),
        stack_colocations(cos, "cpu"),
        {"fixed": None, "mule": (torch.tensor(x), torch.tensor(y))},
        _torch_train, _cfg(), [100 + s for s in range(S)], eval_every=6,
        eval_fn=t_eval, methods=method, device="cpu")
    want, want_aux = out[method]
    got = to_numpy(got)
    for side in ("mule_models", "fixed_models"):
        np.testing.assert_allclose(got[side]["w"], want[side]["w"],
                                   atol=TOL, rtol=TOL, err_msg=side)
    for k in ("ages", "count"):
        np.testing.assert_array_equal(got["fresh"][k], want["fresh"][k])
    np.testing.assert_array_equal(got["mule_ts"], want["mule_ts"])
    np.testing.assert_array_equal(aux["last_fid"].numpy(),
                                  want_aux["last_fid"])
    np.testing.assert_array_equal(aux["eval_steps"], [5, 11, 17])
    np.testing.assert_array_equal(aux["eval_steps"], want_aux["eval_steps"])
    assert tuple(aux["evals"].shape) == (S, 3, M)
    np.testing.assert_allclose(aux["evals"].numpy(), want_aux["evals"],
                               atol=TOL, rtol=TOL)
    moved = np.abs(got["mule_models"]["w"] - np.stack(
        [p["mule_models"]["w"] for p in pops])).max()
    assert moved > 1e-3                      # the lanes did train


def test_stack_colocations_matches_the_reference():
    cos = [jax.tree.map(np.asarray, jax_walk(s, 5, 7)) for s in range(3)]
    cos[2]["active"] = markov_churn_mask(1, 7, 5)
    got = stack_colocations(cos, "cpu")
    want = jax_stack_colocations(cos)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert got["active"][:2].all() and not got["active"][2].all()


# -- lane i against the port's own sequential run (the narrow CNN) ----------


CNN = smoke_config()


def _cnn_train(params, batch, key):
    xb, yb = batch
    g = torch.func.grad(
        lambda p: cnn.xent_loss(cnn.cnn_forward(p, xb), yb))(params)
    return {k: p - LR * g[k] for k, p in params.items()}


@functools.lru_cache(maxsize=None)
def _cnn_lanes():
    """Per-lane populations, walk schedules and data pools (context)."""
    pops, cos, xs, ys = [], [], [], []
    for s in range(S):
        g = torch.Generator().manual_seed(s)
        pops.append(tpop.init_population(
            _cfg(), lambda gg: cnn.init_cnn(gg, CNN), g, device="cpu"))
        cos.append(walk_colocation(s, M, T))
        assert _met_pairs(cos[-1:]) > 0
        rng = np.random.default_rng(10 + s)
        xs.append(rng.normal(size=(M, 12, 16, 16, 3)).astype(np.float32))
        ys.append(rng.integers(0, CNN.n_classes, (M, 12)))
    xt = np.random.default_rng(9).normal(size=(S, F, 5, 16, 16, 3))
    ctx = (torch.tensor(np.stack(xs)), torch.tensor(np.stack(ys)),
           torch.tensor(xt.astype(np.float32)))
    return pops, cos, ctx


def _ctx_batches(seed, t, c):
    return {"fixed": None, "mule": texp.sample_batches(seed, c[0], c[1], B)}


def _ctx_eval(st, last, c):
    return torch.func.vmap(lambda p, xx: cnn.cnn_forward(p, xx).mean())(
        st["mule_models"], c[2][last])


@pytest.mark.parametrize("method", METHODS_MOBILE)
def test_run_sweep_lanes_equal_sequential_runs_bitwise(method):
    pops, cos, ctx = _cnn_lanes()
    got, aux = run_sweep(stack_trees(pops), stack_colocations(cos, "cpu"),
                         _ctx_batches, _cnn_train, _cfg(), [7, 8, 9],
                         eval_every=9, eval_fn=_ctx_eval, methods=method,
                         context=ctx, device="cpu")
    for i in range(S):
        one, one_aux = run_population(
            pops[i], cos[i], _ctx_batches, _cnn_train, _cfg(), 7 + i,
            eval_every=9, eval_fn=_ctx_eval, method=method,
            context=tuple(c[i] for c in ctx), device="cpu")
        for side in ("mule_models", "fixed_models"):
            for k, v in one[side].items():
                assert torch.equal(got[side][k][i], v), f"{side}/{k}"
        for k, v in one["fresh"].items():
            assert torch.equal(got["fresh"][k][i], v), k
        assert torch.equal(aux["last_fid"][i], one_aux["last_fid"])
        assert torch.equal(aux["evals"][i], one_aux["evals"])
    np.testing.assert_array_equal(aux["eval_steps"], [8, 17])


def test_sweep_shared_colocation_and_method_dict():
    """A single [T, M] schedule broadcasts across seeds; a sequence of
    methods returns a per-method dict of stacked results."""
    pops, cos, ctx = _cnn_lanes()
    x = torch.tensor(np.random.default_rng(3).normal(
        size=(2, T, M, B, 16, 16, 3)).astype(np.float32))
    y = torch.randint(0, CNN.n_classes, (2, T, M, B),
                      generator=torch.Generator().manual_seed(0))
    out = run_sweep(stack_trees(pops[:2]), cos[0],
                    {"fixed": None, "mule": (x, y)}, _cnn_train, _cfg(),
                    [0, 1], methods=("local", "oppcl"), device="cpu")
    assert set(out) == {"local", "oppcl"}
    for m, (vf, aux) in out.items():
        assert vf["mule_models"]["conv1"].shape[0] == 2
        assert aux["evals"] is None and len(aux["eval_steps"]) == 0
        seq, _ = run_population(pops[1], cos[0],
                                {"fixed": None, "mule": (x[1], y[1])},
                                _cnn_train, _cfg(), 1, method=m,
                                device="cpu")
        for k, v in seq["mule_models"].items():
            assert torch.equal(vf["mule_models"][k][1], v), f"{m}/{k}"


def test_sweep_context_carries_per_seed_data():
    """Identical states and keys, different context: the lanes differ."""
    pops, cos, _ = _cnn_lanes()
    scale = torch.tensor([1.0, 2.0])
    x = torch.tensor(np.random.default_rng(4).normal(
        size=(M, 12, 16, 16, 3)).astype(np.float32))
    y = torch.randint(0, CNN.n_classes, (M, 12),
                      generator=torch.Generator().manual_seed(1))

    def ctx_batches(seed, t, c):
        xb, yb = texp.sample_batches(seed, x, y, B)
        return {"fixed": None, "mule": (xb * c["scale"], yb)}

    def ctx_eval(st, last, c):
        return st["mule_models"]["fc2_b"].mean() + c["scale"]

    _, aux = run_sweep(stack_trees([pops[0], pops[0]]),
                       stack_colocations([cos[0], cos[0]], "cpu"),
                       ctx_batches, _cnn_train, _cfg(), [7, 7], eval_every=6,
                       eval_fn=ctx_eval, context={"scale": scale},
                       device="cpu")
    assert tuple(aux["evals"].shape) == (2, 3)
    assert not torch.allclose(aux["evals"][0], aux["evals"][1])
    np.testing.assert_array_equal(aux["eval_steps"], [5, 11, 17])


def test_run_population_without_context_is_unchanged():
    """The two-argument batches and eval_fn: a run with ``context=None``
    equals the same run whose functions take and ignore a context."""
    pops, cos, ctx = _cnn_lanes()
    lane = tuple(c[0] for c in ctx)
    plain = run_population(
        pops[0], cos[0], lambda s, t: _ctx_batches(s, t, lane), _cnn_train,
        _cfg(), 7, eval_every=9,
        eval_fn=lambda st, last: _ctx_eval(st, last, lane), method="gossip",
        device="cpu")
    with_ctx = run_population(
        pops[0], cos[0], _ctx_batches, _cnn_train, _cfg(), 7, eval_every=9,
        eval_fn=_ctx_eval, method="gossip", context=lane, device="cpu")
    for k, v in plain[0]["mule_models"].items():
        assert torch.equal(with_ctx[0]["mule_models"][k], v)
    assert torch.equal(plain[1]["evals"], with_ctx[1]["evals"])


def test_sweep_seeds_fold_like_the_engine():
    """The vmapped step folds int64 seed tensors to the host's bits."""
    seeds = [0, 1, 7, 12345, 2 ** 40 + 3, (1 << 62) - 1]
    for data in (0, 1, 2, M, -1, 1 << 40):
        got = fold_in(torch.tensor(seeds), data).tolist()
        assert got == [fold_in(k, data) for k in seeds]
    got = torch.func.vmap(lambda k: split(k, 5, "cpu"))(torch.tensor(seeds))
    assert got.tolist() == [split(k, 5, "cpu").tolist() for k in seeds]


def test_run_sweep_distributed_raises_naming_13b():
    """Item 13c ported the sweep over the distributed engine, which raised
    naming it: on one rank (the mesh cuts nothing) each lane is now bitwise
    its sequential ``run_population_distributed`` run, and a re-bucketing
    config, which the lanes cannot share, raises instead."""
    from repro_torch.core import distributed as tdist
    from repro_torch.launch.mesh import make_mule_mesh
    from repro_torch.scenarios import run_population_distributed
    m, f, t, d, s = 8, 3, 6, 4, 2
    rng = np.random.default_rng(5)

    def train_fn(params, batch, key):
        xb, yb = batch
        g = torch.func.grad(lambda p: torch.mean(
            (xb @ p["w"] + p["b"] - yb) ** 2))(params)
        return {k: p - 0.05 * g[k] for k, p in params.items()}

    dcfg = tdist.DistributedConfig(pop=tpop.PopulationConfig(
        mode="mobile", n_fixed=f, n_mules=m))
    pops, cos, bs = [], [], []
    for _ in range(s):
        gen = torch.Generator().manual_seed(int(rng.integers(100)))
        pops.append(tdist.to_distributed_state(tpop.init_population(
            dcfg.pop, lambda g: {"w": torch.randn(d, generator=g),
                                 "b": torch.zeros(())}, gen, device="cpu"),
            dcfg))
        cos.append({"fixed_id": rng.integers(-1, f, (t, m)),
                    "exchange": rng.uniform(size=(t, m)) < 0.7,
                    "pos": rng.uniform(size=(t, m, 2)).astype(np.float32),
                    "area": np.repeat(np.arange(2), m // 2)})
        bs.append({"fixed": None, "mule": (
            torch.tensor(rng.normal(size=(t, m, 3, d)), dtype=torch.float32),
            torch.tensor(rng.normal(size=(t, m, 3)), dtype=torch.float32))})
    mesh = make_mule_mesh(1, 1)
    stacked = {k: np.stack([c[k] for c in cos]) for k in cos[0]}
    batches = {"fixed": None, "mule": tuple(
        torch.stack([b["mule"][j] for b in bs]) for j in (0, 1))}
    for method in ("mlmule", "gossip"):
        final, aux = run_sweep_distributed(
            tpop_stack(pops), stacked, batches, train_fn, dcfg, mesh, [4, 9],
            methods=method, device="cpu")
        for i in range(s):
            want, waux = run_population_distributed(
                pops[i], cos[i], bs[i], train_fn, dcfg, mesh, key=[4, 9][i],
                method=method, device="cpu")
            for side in ("mule_models", "fixed_models"):
                for k, v in want[side].items():
                    assert torch.equal(final[side][k][i], v), (method, k)
            assert torch.equal(aux["last_fid"][i], waux["last_fid"])
    with pytest.raises(ValueError, match="re-bucket"):
        run_sweep_distributed(tpop_stack(pops), stacked, batches, train_fn,
                              dataclasses.replace(dcfg, rebucket_every=2),
                              mesh, [4, 9], device="cpu")


def tpop_stack(pops):
    from repro_torch.scenarios.sweep import stack_trees
    return stack_trees(pops)


# -- the kernels' lane entries and vmap rules on the CPU --------------------


def _lane_inputs(seed=0, s=4, f=5, m=24, d=40):
    g = torch.Generator().manual_seed(seed)
    a = torch.rand(s, f, m, generator=g)
    a = a / a.sum(2, keepdim=True)
    pos = torch.rand(s, m, 2, generator=g) * 0.4
    area = torch.randint(0, 2, (s, m), generator=g)
    act = torch.rand(s, m, generator=g) < 0.8
    w = torch.randn(s, m, d, generator=g)
    return a, pos, area, act, w


def test_lane_plain_versions_match_single_lane_calls():
    """fp32 sums of the batched matmul and of each lane's own matmul may
    take other orders: 1e-6; the masses are counts, exactly equal."""
    a, pos, area, act, w = _lane_inputs()
    torch.testing.assert_close(
        mule_agg_lanes_plain(a, w),
        torch.stack([mule_agg_plain(a[i], w[i]) for i in range(4)]),
        atol=1e-6, rtol=1e-6)
    for active in (act, None):
        mix, mass = encounter_mix_lanes_reference(pos, area, active, w,
                                                  radius=0.15)
        for i in range(4):
            one, one_mass = encounter_mix_reference(
                pos[i], area[i], None if active is None else active[i], w[i],
                radius=0.15)
            torch.testing.assert_close(mix[i], one, atol=1e-6, rtol=1e-6)
            assert torch.equal(mass[i], one_mass)
        assert mass.sum() > 0


def test_vmap_rules_call_the_lane_entries_on_the_cpu(monkeypatch):
    """``torch.func.vmap`` of either custom op reaches its lane entry once
    for all lanes (batched and unbatched arguments alike) and gives each
    lane's single-lane result."""
    from repro_torch.kernels.encounter_mix import ops as eops
    from repro_torch.kernels.mule_agg import ops as mops
    calls = []
    for mod, name in ((mops, "mule_agg_lanes"),
                      (eops, "encounter_mix_lanes")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    a, pos, area, act, w = _lane_inputs(1)
    got = torch.func.vmap(mule_agg_op)(a, w)
    shared = torch.func.vmap(mule_agg_op, in_dims=(None, 0))(a[0], w)
    mix, mass = torch.func.vmap(encounter_mix_op,
                                in_dims=(0, 0, 0, 0, None))(pos, area, act,
                                                             w, 0.15)
    mix_n, mass_n = torch.func.vmap(encounter_mix_op,
                                    in_dims=(None, None, None, 0, None))(
        pos[0], area[0], None, w, 0.15)
    assert calls == ["mule_agg_lanes"] * 2 + ["encounter_mix_lanes"] * 2
    for i in range(4):
        assert torch.equal(got[i], mule_agg(a[i], w[i]))
        assert torch.equal(shared[i], mule_agg(a[0], w[i]))
        one, one_mass = encounter_mix(pos[i], area[i], act[i], w[i])
        torch.testing.assert_close(mix[i], one, atol=1e-6, rtol=1e-6)
        assert torch.equal(mass[i], one_mass)
        one, one_mass = encounter_mix(pos[0], area[0], None, w[i])
        torch.testing.assert_close(mix_n[i], one, atol=1e-6, rtol=1e-6)
        assert torch.equal(mass_n[i], one_mass)
    # outside vmap the ops are the single-lane wrappers
    assert torch.equal(mule_agg_op(a[0], w[0]), mule_agg(a[0], w[0]))


@pytest.mark.parametrize("bad", ["lanes", "rows", "pos", "active"])
def test_lane_entries_check_their_shapes(bad):
    a, pos, area, act, w = _lane_inputs()
    with pytest.raises(ValueError):
        if bad == "lanes":
            mule_agg_lanes(a[:3], w)
        elif bad == "rows":
            mule_agg_lanes(a, w[:, :5])
        elif bad == "pos":
            encounter_mix_lanes(pos[:, :, :1], area, act, w)
        else:
            encounter_mix_lanes(pos, area, act[:2], w)


@pytest.mark.cuda
def test_mule_agg_lanes_match_single_launches_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for f, m, d in ((8, 256, 4099), (12, 40, 1000), (1, 3, 130)):
        a = torch.rand(4, f, m, device=cuda_device, generator=g)
        w = torch.randn(4, m, d, device=cuda_device, generator=g)
        before = mule_agg.launches
        got = mule_agg_lanes(a, w)
        assert mule_agg.launches == before + 1
        want = torch.stack([mule_agg(a[i], w[i]) for i in range(4)])
        assert torch.equal(got, want)
        torch.testing.assert_close(got, mule_agg_lanes_plain(a, w),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_encounter_mix_lanes_match_single_launches_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    for m, d, zero in ((256, 4100, False), (300, 2000, True), (7, 5, False)):
        pos = torch.rand(4, m, 2, device=cuda_device, generator=g)
        if zero:
            pos.zero_()
        area = torch.randint(0, 2, (4, m), device=cuda_device, generator=g)
        act = torch.rand(4, m, device=cuda_device, generator=g) < 0.9
        w = torch.randn(4, m, d, device=cuda_device, generator=g)
        before = encounter_mix.launches
        mix, mass = encounter_mix_lanes(pos, area, act, w, radius=0.3)
        assert encounter_mix.launches == before + 1
        for i in range(4):
            one, one_mass = encounter_mix(pos[i], area[i], act[i], w[i],
                                          radius=0.3)
            assert torch.equal(mix[i], one) and torch.equal(mass[i], one_mass)
        ref, ref_mass = encounter_mix_lanes_reference(pos, area, act, w,
                                                      radius=0.3)
        assert torch.equal(mass, ref_mass)
        torch.testing.assert_close(mix, ref, atol=1e-5, rtol=1e-5)


# -- run_sweep_experiment ----------------------------------------------------


def test_run_sweep_experiment_values_match_the_reference(monkeypatch):
    """One lane, fixed mode, ``mlmule`` and ``local``: the reference's
    draws and initial models injected, the port's final models (for each
    method) and accuracy curves held to the reference's sweep."""
    methods = ("mlmule", "local")
    jcfg = jcommon.ExperimentConfig(**VALUE)
    tcfg = texp.ExperimentConfig(**VALUE)
    sweeps = capture(monkeypatch, jcommon, "run_sweep")
    want = jcommon.run_sweep_experiment(jcfg, [jcfg.seed], methods=methods)
    ref_out, = sweeps
    Xtr = texp.image_data_fixed(tcfg, "cpu")[0]
    sampler = injected_sampler(reference_draws(jcfg, Xtr.shape[0],
                                               Xtr.shape[1], len(methods), 0))
    monkeypatch.setattr(texp, "sample_batches", sampler)
    _, ttrain, teval = texp.model_fns(tcfg)
    got, st = texp.run_sweep_with_models(
        tcfg, [tcfg.seed],
        (reference_init(jcfg, jcfg.n_fixed, jcommon._model_fns(jcfg)[0]),
         ttrain, teval), methods, "cpu")
    assert sampler.left() == 0
    assert got["eval_steps"] == want["eval_steps"] == [9, 19]
    for m in methods:
        final, _ = st["out"][m]
        lane = {k: v[0] for k, v in final["fixed_models"].items()}
        assert_models_close(lane, jax.tree.map(
            lambda l: np.asarray(l[0]), ref_out[m][0]["fixed_models"]))
        for k in ("acc", "mean_acc", "final_acc"):
            np.testing.assert_allclose(got["methods"][m][k],
                                       want["methods"][m][k], atol=1e-6)


def test_run_sweep_experiment_contract_and_one_seed():
    """The reference's keys; lane 0 of a two-seed sweep is the one-seed
    run, whose curve is ``run_experiment``'s; federated methods raise."""
    cfg = texp.ExperimentConfig(mode="mobile", task="image", dist="shards",
                                pattern="4q", steps=20, eval_every=10,
                                pretrain_steps=2, image_size=8, n_per_sub=8,
                                n_mules=6)
    got = texp.run_sweep_experiment(cfg, [0, 1], methods=("gossip",
                                                          "mlmule"),
                                    device="cpu")
    assert sorted(got) == ["config", "eval_steps", "methods", "seeds",
                           "wall_s"]
    assert got["seeds"] == [0, 1] and got["eval_steps"] == [9, 19]
    assert sorted(got["methods"]["gossip"]) == [
        "acc", "final_acc", "mean_acc", "mean_final_acc"]
    for m, r in got["methods"].items():
        assert np.asarray(r["acc"]).shape == (2, 2)
        assert all(0.0 <= a <= 1.0 for a in r["final_acc"])
        one = texp.run_experiment(dataclasses.replace(cfg, method=m),
                                  device="cpu")
        np.testing.assert_allclose(r["acc"][0], [a for _, a in one["trace"]],
                                   atol=1e-6)
        assert r["final_acc"][0] == pytest.approx(one["pre_local_acc"],
                                                  abs=1e-6)
    with pytest.raises(ValueError, match="not engine methods"):
        texp.run_sweep_experiment(cfg, [0], methods=("fedavg",),
                                  device="cpu")


def _example(name: str):
    """An example script as a module (its ``main``/``run`` run here, with
    this process's single thread)."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        module = __import__(name)
    finally:
        sys.path.pop(0)
    assert "import jax" not in open(module.__file__).read()
    return module


def test_figure_drivers_and_seeded_scenario_run_on_the_cpu(tmp_path,
                                                           capsys):
    _example("torch_run_scenario").main(
        ["--device", "cpu", "--scenario", "commuter", "--steps", "20",
         "--n-mules", "6", "--seeds", "2"])
    assert "final pre-local acc" in capsys.readouterr().out
    rows = _example("torch_fig8_har").run(seeds=(0,), steps=10,
                                          pretrain_steps=1, device="cpu")
    assert [r["method"] for r in rows] == list(METHODS_MOBILE)
    assert all(r["p_cross"] == "0.1" for r in rows)
    # the Fig 6 driver end to end through its flags, in a process of its own
    rows_path = tmp_path / "fig6.json"
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch_fig6_mobile.py"),
         "--device", "cpu", "--steps", "10", "--pretrain-steps", "1",
         "--seeds", "2", "--out", str(rows_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("fig6,") == 10
    rows = json.loads(rows_path.read_text())
    assert [(r["p_cross"], r["method"]) for r in rows] == [
        (p, m) for p in ("0", "0.5") for m in METHODS_MOBILE]
    assert sorted(rows[0]) == ["acc_per_seed", "final_acc", "method",
                               "p_cross", "seeds", "trace", "wall_s"]
    assert all(len(r["acc_per_seed"]) == 2 for r in rows)
