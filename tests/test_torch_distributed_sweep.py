"""Port's seed sweep over the mule-sharded engine against its sequential
runs and against the JAX package.

One 4-rank gloo world (``spawn_local_cluster``, a ``FileStore`` under the
test's temporary directory) runs ``run_sweep_distributed`` over S = 3 seed
lanes for every one of the five mobile methods, then each lane alone through
``run_population_distributed``. The lanes differ in population, schedule,
batches and area layout: lanes 0 and 2 hold two bucket-ordered areas (the
1 x 4 ring prunes its middle hop), lane 1 one area (it needs every hop), so
the sweep runs hops that some lanes do not need. The reference side is
``test_torch_distributed_engine._jax_dist_run`` of each lane's inputs (its
distributed step under ``jax.vmap(axis_name="data")``). Bounds:

- every lane bitwise its sequential run (weights, timestamps, sketch,
  ``last_fid``, ``t``), on every rank;
- replicated state bitwise on every rank;
- ``mlmule`` and ``gossip`` lanes within the reference's bounds of
  ``_assert_close_to_jax`` (weights 1e-5, counts exact);
- one ``ordered_psum`` a ``mlmule`` step for all lanes, and the hops the
  sweep ran no more than the sequential runs' sum.
"""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import multiprocess as mp  # noqa: E402
from test_torch_distributed_engine import (  # noqa: E402
    F, LR, M, N_RANKS, REPLICATED, T, _assert_close_to_jax, _jax_dist_run,
    _pop_arrays, _population, _stacked_batches)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
S = 3
KEYS = [3, 8, 11]
METHODS = ("mlmule", "gossip", "oppcl", "local", "mlmule+gossip")
REFERENCE_METHODS = ("mlmule", "gossip")

_CHILD = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.baselines.gossip import RING_COUNTS
from repro_torch.core import distributed as td
from repro_torch.core.freshness import FreshnessConfig
from repro_torch.core.population import PopulationConfig
from repro_torch.launch.mesh import make_mule_mesh
from repro_torch.launch.multiprocess import gather_global, initialize_from_env
from repro_torch.scenarios import run_population_distributed
from repro_torch.scenarios.sweep import run_sweep_distributed, stack_trees

torch.set_num_threads(1)
assert initialize_from_env()
i = dist.get_rank()
d = sys.argv[1]
data = np.load(d + "/cases.npz")
spec = json.load(open(d + "/cases.json"))
LR, S = spec["lr"], spec["S"]


def train_fn(params, batch, key):
    xb, yb = batch
    def loss(p):
        return torch.mean((xb @ p["w"] + p["b"] - yb) ** 2)
    g = torch.func.grad(loss)(params)
    return {k: p - LR * g[k] for k, p in params.items()}


def arr(name):
    return torch.from_numpy(data[name].copy())


def population(p):
    return {"mule_models": {"w": arr(p + ".mw"), "b": arr(p + ".mb")},
            "fixed_models": {"w": arr(p + ".fw"), "b": arr(p + ".fb")},
            "mule_ts": arr(p + ".ts"),
            "fresh": {"ages": arr(p + ".ages"), "count": arr(p + ".count"),
                      "threshold": arr(p + ".thr")},
            "t": arr(p + ".t")}


def colocation(l):
    return {k: data[f"l{l}.co.{k}"] for k in ("fixed_id", "exchange", "pos",
                                              "area", "active")}


def batches(l):
    return {"fixed": None, "mule": (arr(f"l{l}.b.mx"), arr(f"l{l}.b.my"))}


dcfg = td.DistributedConfig(pop=PopulationConfig(
    mode="mobile", n_fixed=spec["F"], n_mules=spec["M"],
    freshness=FreshnessConfig(stat="median")))
mesh = make_mule_mesh(1, dist.get_world_size())
out = {}


def save(tag, final, last, lane=None):
    pick = (lambda v: v) if lane is None else (lambda v: v[lane])
    for k, v in final["mule_models"].items():
        out[f"{tag}.mule.{k}"] = gather_global(pick(v), mesh, 0).numpy()
    out[f"{tag}.mule_ts"] = gather_global(pick(final["mule_ts"]), mesh,
                                          0).numpy()
    out[f"{tag}.last"] = gather_global(pick(last), mesh, 0).numpy()
    for k, v in final["fixed_models"].items():
        out[f"{tag}.fixed.{k}"] = pick(v).numpy()
    for k, v in final["fresh"].items():
        out[f"{tag}.fresh.{k}"] = pick(v).numpy()
    out[f"{tag}.t"] = pick(final["t"]).numpy()


cos = [colocation(l) for l in range(S)]
stacked_co = {k: np.stack([c[k] for c in cos]) for k in cos[0]}
stacked_b = {"fixed": None,
             "mule": tuple(torch.stack([batches(l)["mule"][j]
                                        for l in range(S)]) for j in (0, 1))}
for method in spec["methods"]:
    states = stack_trees([td.to_distributed_state(population(f"l{l}.pop"),
                                                  dcfg) for l in range(S)])
    hops, psums = RING_COUNTS["hops"], td.PSUM_COUNTS["calls"]
    final, aux = run_sweep_distributed(states, stacked_co, stacked_b,
                                       train_fn, dcfg, mesh, spec["keys"],
                                       methods=method, device="cpu")
    out[f"{method}.sweep.hops"] = np.array(RING_COUNTS["hops"] - hops)
    out[f"{method}.sweep.psums"] = np.array(td.PSUM_COUNTS["calls"] - psums)
    for l in range(S):
        save(f"{method}.lane{l}", final, aux["last_fid"], l)
    hops, psums = RING_COUNTS["hops"], td.PSUM_COUNTS["calls"]
    for l in range(S):
        fin, a = run_population_distributed(
            td.to_distributed_state(population(f"l{l}.pop"), dcfg), cos[l],
            batches(l), train_fn, dcfg, mesh, key=spec["keys"][l],
            method=method, device="cpu")
        save(f"{method}.seq{l}", fin, a["last_fid"])
    out[f"{method}.seq.hops"] = np.array(RING_COUNTS["hops"] - hops)
    out[f"{method}.seq.psums"] = np.array(td.PSUM_COUNTS["calls"] - psums)
dist.barrier()
bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "repro")]
assert not bad, bad
np.savez(d + f"/out{i}.npz", **out)
'''


def _lane_inputs(lane):
    """Lane ``lane``'s population, schedule and stacked batches (numpy)."""
    rng = np.random.default_rng(100 + lane)
    pop = _population(seed=lane + 2)
    area = (np.zeros(M, np.int32) if lane == 1 else
            np.repeat(np.arange(2, dtype=np.int32), M // 2))
    arrays = {"co.fixed_id": rng.integers(-1, F, (T, M)).astype(np.int32),
              "co.exchange": rng.uniform(size=(T, M)) < 0.7,
              "co.pos": rng.uniform(size=(T, M, 2)).astype(np.float32),
              "co.area": area,
              "co.active": rng.uniform(size=(T, M)) < 0.85}
    arrays.update(_stacked_batches(rng, T))
    return pop, arrays


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every method's sweep and sequential runs over one 4-rank world."""
    d = tmp_path_factory.mktemp("sweep_world")
    lanes = [_lane_inputs(l) for l in range(S)]
    flat = {}
    for l, (pop, arrays) in enumerate(lanes):
        flat.update(_pop_arrays(pop, f"l{l}.pop"))
        flat.update({f"l{l}.{k}": v for k, v in arrays.items()})
    np.savez(d / "cases.npz", **flat)
    (d / "cases.json").write_text(json.dumps({
        "lr": LR, "M": M, "F": F, "S": S, "keys": KEYS,
        "methods": list(METHODS)}))
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    mp.spawn_local_cluster([sys.executable, "-c", _CHILD, str(d)], N_RANKS,
                           coordinator=f"file://{d}/store", base_env=env,
                           timeout=240)
    ranks = [dict(np.load(d / f"out{i}.npz")) for i in range(N_RANKS)]
    return lanes, ranks


@pytest.mark.parametrize("method", METHODS)
def test_each_lane_is_its_sequential_run_bitwise(world, method):
    _, ranks = world
    for r in ranks:
        for l in range(S):
            seq = f"{method}.seq{l}."
            for k in r:
                if k.startswith(seq):
                    np.testing.assert_array_equal(
                        r[f"{method}.lane{l}." + k[len(seq):]], r[k],
                        err_msg=k)


@pytest.mark.parametrize("method", METHODS)
def test_replicated_state_is_bitwise_on_every_rank(world, method):
    _, ranks = world
    for l in range(S):
        for k in REPLICATED:
            key = f"{method}.lane{l}.{k}"
            if key not in ranks[0]:
                continue
            for r in ranks[1:]:
                np.testing.assert_array_equal(r[key], ranks[0][key],
                                              err_msg=key)


@pytest.mark.parametrize("method", REFERENCE_METHODS)
@pytest.mark.parametrize("lane", range(S))
def test_lane_matches_the_reference(world, method, lane):
    lanes, ranks = world
    pop, arrays = lanes[lane]
    case = {"method": method, "mode": "mobile", "stat": "median", "data":
            N_RANKS, "prune": True}
    want, last = _jax_dist_run(case, pop, arrays)
    _assert_close_to_jax(ranks[0], f"{method}.lane{lane}", want, last)


def test_one_psum_a_step_for_all_lanes(world):
    _, ranks = world
    for r in ranks:
        assert int(r["mlmule.sweep.psums"]) == T
        assert int(r["mlmule.seq.psums"]) == S * T
        assert int(r["gossip.sweep.psums"]) == 0


@pytest.mark.parametrize("method", ("gossip", "oppcl", "mlmule+gossip"))
def test_the_ring_runs_the_union_of_the_lanes_hops(world, method):
    """The sweep runs every hop some lane needs once for all lanes: here
    lane 1 needs all 4, so the sweep runs 4 an exchange, the sequential
    runs 3 + 4 + 3."""
    _, ranks = world
    exchanges = T // 3
    for r in ranks:
        assert int(r[f"{method}.sweep.hops"]) == N_RANKS * exchanges
        assert int(r[f"{method}.seq.hops"]) == (3 + 4 + 3) * exchanges
