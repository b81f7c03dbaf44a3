"""Port's mule-sharded engine against the JAX package: the histogram
sketch, the configuration, and the distributed step, collectives,
bucketing, migration and re-bucketed streamed replay over gloo ranks.

The ranks run in child processes that import only ``repro_torch``
(``spawn_local_cluster``, one ``FileStore`` under the test's temporary
directory): one 4-rank world runs every case once (a module-scoped
fixture). The reference runs in this process. Its distributed step runs
under ``jax.vmap(..., axis_name="data")`` over the data shards, with eager
JAX walking the steps, where ``axis_index``, ``all_gather`` and ``psum``
behave as on a mesh; JAX's ``vmap`` cannot all-gather over two named axes,
so the reference side of a 2 x 2 mesh is its one-pod run over the 2 data
shards (the pods hold copies of the blocks, and ``cross_pod`` must divide
the copies back out of the sketch). The reference's re-bucketed streamed
engine runs in full, on a one-device mesh. Inputs come from a numpy seed;
the train function ignores its key. Bounds:

- weights 1e-5 (a fused sum of 4 rank partials in another order than the
  reference's matmul, then a few SGD steps of a linear model);
- sketch counts, timestamps, ``t``, ``last_fid``, bucket orders and
  re-bucketing swaps exact; histograms and thresholds 1e-6 relative (the
  cumulative sums of the quantiles in another order);
- every rank's replicated state (``fixed_models``, ``fresh``, ``t``)
  bitwise equal to every other rank's; the pruned ring bitwise the dense
  ring; ``run_population_distributed(rebucket_every=10)`` bitwise the
  streamed engine it hands over to.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import distributed as jd  # noqa: E402
from repro.core import freshness as jf  # noqa: E402
from repro.core import population as jpop  # noqa: E402
from repro.mobility import streaming as js  # noqa: E402
from repro.scenarios import run_population_streamed as jax_streamed  # noqa: E402
from repro_torch.core import distributed as td  # noqa: E402
from repro_torch.core import freshness as tf  # noqa: E402
from repro_torch.core import population as tpop  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import multiprocess as mp  # noqa: E402
from repro_torch.scenarios import get_scenario  # noqa: E402

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
N_RANKS, M, F, T, D, LR = 4, 16, 4, 9, 5, 0.05
# multi_area_migratory: 12 fixed devices; at M = 16 its first mule moves
# to another city before step 20
REBUCKET_F, REBUCKET_T, REBUCKET_EVERY = 12, 60, 20


# ---------------------------------------------------------------------------
# the histogram sketch
# ---------------------------------------------------------------------------

# (bins, max age): XLA's float32 division on the CPU is not correctly
# rounded, so jnp.linspace's edges are bitwise reproducible only where the
# bin count is a power of two (every division exact); elsewhere the edges
# are held to one ulp, and the centres (the mean of two edges) to two
SKETCH_CFGS = [(64, 512.0), (16, 97.0), (32, 333.3), (10, 100.0),
               (33, 1000.0)]


def _cfgs(bins, max_age, **kw):
    return (jf.FreshnessConfig(sketch_bins=bins, sketch_max_age=max_age, **kw),
            tf.FreshnessConfig(sketch_bins=bins, sketch_max_age=max_age, **kw))


@pytest.mark.parametrize("bins,max_age", SKETCH_CFGS)
def test_sketch_edges_and_centers_match_jax(bins, max_age):
    jc, tc = _cfgs(bins, max_age)
    for j_fn, t_fn, ulp in ((jf.sketch_edges, tf.sketch_edges, 1),
                            (jf.sketch_centers, tf.sketch_centers, 2)):
        want, got = np.asarray(j_fn(jc)), t_fn(tc).numpy()
        assert got.dtype == want.dtype == np.float32
        if bins & (bins - 1) == 0:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_array_max_ulp(got, want, maxulp=ulp)


@pytest.mark.parametrize("bins,max_age", SKETCH_CFGS)
def test_age_bins_and_histogram_match_jax(bins, max_age):
    jc, tc = _cfgs(bins, max_age)
    rng = np.random.default_rng(bins)
    ages = rng.uniform(-5, 1.2 * max_age, (5, 30)).astype(np.float32)
    ages[0, :6] = np.arange(6) * np.float32(max_age / bins)   # on edges
    w = (rng.uniform(size=(5, 30)) < 0.6).astype(np.float32)
    np.testing.assert_array_equal(
        tf.age_bin_onehot(torch.tensor(ages), tc).numpy(),
        np.asarray(jf.age_bin_onehot(jnp.asarray(ages), jc)))
    np.testing.assert_array_equal(
        tf.age_histogram(torch.tensor(ages), torch.tensor(w), tc).numpy(),
        np.asarray(jf.age_histogram(jnp.asarray(ages), jnp.asarray(w), jc)))


def _hists(seed, bins, rows=6):
    rng = np.random.default_rng(seed)
    h = rng.uniform(size=(rows, bins)).astype(np.float32)
    h *= rng.uniform(size=(rows, bins)) < 0.3          # sparse rows
    h[0] = 0.0                                          # an empty row
    h[1] = 0.0
    h[1, bins // 2] = 3.0                               # one occupied bin
    h[2, ::2] = 1.0                                     # ties everywhere
    return h


@pytest.mark.parametrize("bins,max_age", SKETCH_CFGS[:3])
def test_quantiles_and_median_mad_match_jax(bins, max_age):
    jc, tc = _cfgs(bins, max_age)
    h = _hists(bins, bins)
    edges_t, edges_j = tf.sketch_edges(tc), jf.sketch_edges(jc)
    for q in (0.1, 0.5, 0.9):
        np.testing.assert_allclose(
            tf.hist_quantile(torch.tensor(h), edges_t, q).numpy(),
            np.asarray(jf.hist_quantile(jnp.asarray(h), edges_j, q)),
            rtol=1e-6, atol=0)
    got = tf.sketch_median_mad(torch.tensor(h), tc)
    want = jf.sketch_median_mad(jnp.asarray(h), jc)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)


def test_sketch_push_and_update_matches_jax():
    """Ten pushes from a sketch with warmup history, the cap of K on the
    resident mass, rows that receive nothing keeping their threshold."""
    jc, tc = _cfgs(64, 512.0)
    rng = np.random.default_rng(5)
    j_st = jf.init_freshness_sketch(F, jc)
    t_st = tf.init_freshness_sketch(F, tc, "cpu")
    for step in range(10):
        ages = rng.uniform(0, 60, (F, 7)).astype(np.float32)
        w = (rng.uniform(size=(F, 7)) < 0.5).astype(np.float32)
        w[step % F] = 0.0
        hist = np.asarray(jf.age_histogram(jnp.asarray(ages), jnp.asarray(w),
                                           jc))
        cnt = w.sum(1)
        j_st = jf.sketch_push_and_update(j_st, jnp.asarray(hist),
                                         jnp.asarray(cnt), jc)
        t_st = tf.sketch_push_and_update(t_st, torch.tensor(hist),
                                         torch.tensor(cnt), tc)
        np.testing.assert_array_equal(t_st["count"].numpy(),
                                      np.asarray(j_st["count"]))
        for k in ("hist", "threshold"):
            np.testing.assert_allclose(t_st[k].numpy(), np.asarray(j_st[k]),
                                       rtol=1e-6, atol=0, err_msg=k)
    assert float(t_st["hist"].sum(1).max()) <= tc.history * (1 + 1e-6)
    assert (t_st["threshold"].numpy() < tc.init_threshold).all()


# ---------------------------------------------------------------------------
# configuration and state
# ---------------------------------------------------------------------------


def _population(n_fixed=F, seed=0):
    """A reference-layout population in numpy with a live freshness ring."""
    rng = np.random.default_rng(seed)
    ages = np.full((n_fixed, jf.FreshnessConfig().history), jf.INF,
                   np.float32)
    ages[:, :3] = rng.uniform(0, 9, (n_fixed, 3)).astype(np.float32)
    return {
        "mule_models": {"w": rng.normal(size=(M, D)).astype(np.float32),
                        "b": rng.normal(size=(M,)).astype(np.float32)},
        "fixed_models": {"w": rng.normal(size=(n_fixed, D))
                         .astype(np.float32),
                         "b": rng.normal(size=(n_fixed,)).astype(np.float32)},
        "mule_ts": rng.integers(0, 4, M).astype(np.float32),
        "fresh": {"ages": ages,
                  "count": np.full((n_fixed,), 3, np.int32),
                  "threshold": rng.uniform(2, 6, n_fixed).astype(np.float32)},
        "t": np.float32(5.0),
    }


def _torch_state(pop):
    return {k: ({kk: torch.tensor(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.tensor(v))
            for k, v in pop.items()}


@pytest.mark.parametrize("stat", ["median", "meanstd"])
def test_to_distributed_state_matches_jax(stat):
    pop = _population()
    jcfg = jd.DistributedConfig(pop=jpop.PopulationConfig(
        mode="mobile", n_fixed=F, n_mules=M,
        freshness=jf.FreshnessConfig(stat=stat)))
    tcfg = td.DistributedConfig(pop=tpop.PopulationConfig(
        mode="mobile", n_fixed=F, n_mules=M,
        freshness=tf.FreshnessConfig(stat=stat)))
    want = jd.to_distributed_state(jax.tree.map(jnp.asarray, pop), jcfg)
    got = td.to_distributed_state(_torch_state(pop), tcfg)
    assert sorted(got["fresh"]) == sorted(want["fresh"])
    for k, v in want["fresh"].items():
        np.testing.assert_array_equal(got["fresh"][k].numpy(), np.asarray(v))
    assert got["mule_models"] is not None and got["t"] is not None
    with pytest.raises(ValueError, match="unknown freshness stat"):
        td.init_distributed_freshness(F, tf.FreshnessConfig(stat="mode"),
                                      "cpu")


def test_distributed_config_matches_jax():
    j = jd.DistributedConfig(pop=None)
    t = td.DistributedConfig(pop=None)
    assert [(f.name, f.default) for f in dataclasses.fields(t)] == \
        [(f.name, f.default) for f in dataclasses.fields(j)]
    assert tf.FreshnessConfig() .stat == jf.FreshnessConfig().stat
    assert (tf.FreshnessConfig().sketch_bins,
            tf.FreshnessConfig().sketch_max_age) == \
        (jf.FreshnessConfig().sketch_bins, jf.FreshnessConfig().sketch_max_age)


def test_one_rank_mesh_and_placement():
    """Without a process group the mesh has one rank and cuts nothing."""
    mesh = tmesh.make_mule_mesh(1, 1)
    assert mesh.shape == {"pod": 1, "data": 1}
    assert mesh.coords == {"pod": 0, "data": 0}
    assert mesh.group("data") is None and mesh.axis_size(("pod", "data")) == 1
    assert tmesh.make_mule_mesh(1, 1) is mesh
    flat = tmesh.make_mule_mesh(1, 1, pod_axis="")
    assert flat.shape == {"data": 1}
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(mp.put_global(x, mesh), x)
    assert torch.equal(mp.gather_global(x, mesh, 1), x)
    tree = mp.put_global_tree({"a": x, "b": (x, None)}, mesh,
                              {"a": 0, "b": None})
    assert tree["b"][0] is x
    np.testing.assert_array_equal(mp.host_replicated(x), x.numpy())
    assert td.ordered_psum(x, mesh, ("pod", "data")) is x
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.make_mule_mesh(2, 1)
    with pytest.raises(ValueError, match="pod axis"):
        tmesh.make_mule_mesh(2, 1, pod_axis="")
    with pytest.raises(ValueError, match="no"):
        mesh.axis_size("model")


# ---------------------------------------------------------------------------
# the 4-rank world
# ---------------------------------------------------------------------------

# (method, mode, stat, pod, data, pod_axis, cross_pod, prune)
RUNS = [(m, "mobile", "median", 1, 4, "pod", True, True)
        for m in jpop.METHODS_MOBILE] + [
    ("gossip", "mobile", "median", 1, 4, "pod", True, False),
    ("mlmule", "mobile", "meanstd", 1, 4, "pod", True, True),
    ("mlmule", "fixed", "median", 1, 4, "pod", True, True),
    ("mlmule+gossip", "mobile", "median", 1, 4, "", True, True),
    ("mlmule", "mobile", "median", 2, 2, "pod", True, True),
    ("mlmule", "mobile", "median", 2, 2, "pod", False, True),
    ("gossip", "mobile", "median", 2, 2, "pod", True, True),
]
REBUCKET_METHODS = ("gossip", "mlmule")

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
from repro_torch.mobility import compact_colocation
from repro_torch.scenarios import (run_population_distributed,
                                   run_population_streamed)

torch.set_num_threads(1)
assert initialize_from_env()
n, i = dist.get_world_size(), dist.get_rank()
d = sys.argv[1]
data = np.load(d + "/cases.npz")
spec = json.load(open(d + "/cases.json"))
LR = spec["lr"]


def train_fn(params, batch, key):
    xb, yb = batch
    def loss(p):
        return torch.mean((xb @ p["w"] + p["b"] - yb) ** 2)
    g = torch.func.grad(loss)(params)
    return {k: p - LR * g[k] for k, p in params.items()}


def arr(name):
    return torch.from_numpy(data[name].copy())


def population(p="pop"):
    return {"mule_models": {"w": arr(p + ".mw"), "b": arr(p + ".mb")},
            "fixed_models": {"w": arr(p + ".fw"), "b": arr(p + ".fb")},
            "mule_ts": arr(p + ".ts"),
            "fresh": {"ages": arr(p + ".ages"), "count": arr(p + ".count"),
                      "threshold": arr(p + ".thr")},
            "t": arr(p + ".t")}


def config(case, n_fixed=spec["F"]):
    pcfg = PopulationConfig(mode=case["mode"], n_fixed=n_fixed,
                            n_mules=spec["M"],
                            freshness=FreshnessConfig(stat=case["stat"]))
    return td.DistributedConfig(
        pop=pcfg, pod_axis=case["pod_axis"], cross_pod=case["cross_pod"],
        ring_prune=case["prune"],
        rebucket_every=case.get("rebucket_every", 0),
        rebucket_threshold=case.get("threshold", 0.25))


out = {}


def save(tag, final, aux, mesh, dcfg):
    ax = dcfg.data_axis
    for k, v in final["mule_models"].items():
        out[f"{tag}.mule.{k}"] = gather_global(v, mesh, 0, ax).numpy()
    out[f"{tag}.mule_ts"] = gather_global(final["mule_ts"], mesh, 0,
                                          ax).numpy()
    out[f"{tag}.last"] = gather_global(aux["last_fid"], mesh, 0, ax).numpy()
    for k, v in final["fixed_models"].items():
        out[f"{tag}.fixed.{k}"] = v.numpy()
    for k, v in final["fresh"].items():
        out[f"{tag}.fresh.{k}"] = v.numpy()
    out[f"{tag}.t"] = final["t"].numpy()


co = {k: data["co." + k] for k in ("fixed_id", "exchange", "pos", "area",
                                   "active")}
stacked = {"fixed": (arr("b.fx"), arr("b.fy")),
           "mule": (arr("b.mx"), arr("b.my"))}
for c, case in enumerate(spec["runs"]):
    dcfg = config(case)
    mesh = make_mule_mesh(case["pod"], case["data"],
                          pod_axis=case["pod_axis"])
    state = td.to_distributed_state(population(), dcfg)
    batches = ({"fixed": stacked["fixed"], "mule": None}
               if case["mode"] == "fixed" else
               {"fixed": None, "mule": stacked["mule"]})
    hops = RING_COUNTS["hops"]
    final, aux = run_population_distributed(
        state, co, batches, train_fn, dcfg, mesh, key=3,
        method=case["method"], device="cpu")
    out[f"run{c}.hops"] = np.array(RING_COUNTS["hops"] - hops)
    save(f"run{c}", final, aux, mesh, dcfg)

# collectives and bucketing
for name, (pod, dat) in (("1x4", (1, 4)), ("2x2", (2, 2))):
    mesh = make_mule_mesh(pod, dat)
    x = torch.from_numpy(data["psum.x"][i].copy())
    out[f"psum.{name}.all"] = td.ordered_psum(x, mesh, ("pod", "data")).numpy()
    out[f"psum.{name}.data"] = td.ordered_psum(x, mesh, "data").numpy()
    out[f"pmean.{name}.data"] = td.ordered_pmean(x, mesh, "data").numpy()
    blk = torch.from_numpy(data["area.blocks"][mesh.coords["data"]].copy())
    order, full = td.global_bucket_order(blk, mesh, "data")
    out[f"order.{name}"] = order.numpy()
    out[f"order.{name}.area"] = full.numpy()
mesh = make_mule_mesh(2, 2)
block = mesh.coords["data"]
models = {"w": torch.from_numpy(data["mig.w"][mesh.coords["pod"], block]
                                .copy())}
mask = torch.from_numpy(data["mig.mask"][block].copy())
once = td.migrate_mules(models, mask, mesh)
out["mig.once"] = once["w"].numpy()
twice = td.migrate_mule_state({"mule_models": once, "fixed": 1}, mask, mesh)
out["mig.twice"] = twice["mule_models"]["w"].numpy()

# the re-bucketed streamed engine on multi_area_migratory
rco = {k: data["rco." + k] for k in ("fixed_id", "exchange", "pos", "area")}
rb_batches = {"fixed": None, "mule": (arr("rb.mx"), arr("rb.my"))}
for method in spec["rebucket_methods"]:
    case = {"mode": "mobile", "stat": "median", "pod_axis": "pod",
            "cross_pod": True, "prune": True,
            "rebucket_every": spec["rebucket_every"],
            "threshold": spec["threshold"]}
    dcfg = config(case, spec["rebucket_F"])
    mesh = make_mule_mesh(1, n)
    pruned = RING_COUNTS["pruned"]
    final, aux = run_population_streamed(
        td.to_distributed_state(population("rpop"), dcfg),
        compact_colocation(rco, device="cpu"), rb_batches, train_fn,
        dcfg.pop, 4, chunk_len=spec["rebucket_every"], method=method,
        mesh=mesh, dcfg=dcfg, device="cpu")
    out[f"rb.{method}.pruned"] = np.array(RING_COUNTS["pruned"] - pruned)
    save(f"rb.{method}", final, aux, mesh, dcfg)
    rb = aux["rebucket"]
    out[f"rb.{method}.drift"] = np.array(rb["drift"])
    out[f"rb.{method}.order"] = rb["order"]
    out[f"rb.{method}.counts"] = np.array([rb["checks"], rb["swaps"]])
    again, aux2 = run_population_distributed(
        td.to_distributed_state(population("rpop"), dcfg), rco, rb_batches,
        train_fn, dcfg, mesh, key=4, method=method, device="cpu")
    save(f"rbd.{method}", again, aux2, mesh, dcfg)
    out[f"rbd.{method}.order"] = aux2["rebucket"]["order"]
dist.barrier()
bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "repro")]
assert not bad, bad
np.savez(d + f"/out{i}.npz", **out)
'''


def _stacked_batches(rng, n_steps):
    return {"b.mx": rng.normal(size=(n_steps, M, 3, D)).astype(np.float32),
            "b.my": rng.normal(size=(n_steps, M, 3)).astype(np.float32),
            "b.fx": rng.normal(size=(n_steps, F, 3, D)).astype(np.float32),
            "b.fy": rng.normal(size=(n_steps, F, 3)).astype(np.float32)}


def _pop_arrays(pop, p):
    return {p + ".mw": pop["mule_models"]["w"],
            p + ".mb": pop["mule_models"]["b"],
            p + ".fw": pop["fixed_models"]["w"],
            p + ".fb": pop["fixed_models"]["b"],
            p + ".ts": pop["mule_ts"], p + ".ages": pop["fresh"]["ages"],
            p + ".count": pop["fresh"]["count"],
            p + ".thr": pop["fresh"]["threshold"],
            p + ".t": np.asarray(pop["t"])}


def _world_inputs():
    rng = np.random.default_rng(7)
    pop = _population()
    arrays = _pop_arrays(pop, "pop")
    arrays.update(_pop_arrays(_population(REBUCKET_F, seed=1), "rpop"))
    # two areas, bucket-ordered: the 1 x 4 ring prunes its middle hop
    area = np.repeat(np.arange(2, dtype=np.int32), M // 2)
    arrays.update({
        "co.fixed_id": rng.integers(-1, F, (T, M)).astype(np.int32),
        "co.exchange": rng.uniform(size=(T, M)) < 0.7,
        "co.pos": rng.uniform(size=(T, M, 2)).astype(np.float32),
        "co.area": area,
        "co.active": rng.uniform(size=(T, M)) < 0.85})
    arrays.update(_stacked_batches(rng, T))
    arrays["psum.x"] = rng.normal(size=(N_RANKS, 3, 5)).astype(np.float32)
    arrays["area.blocks"] = rng.integers(0, 3, (N_RANKS, 4)).astype(np.int32)
    arrays["mig.w"] = rng.normal(size=(2, 2, 8, 3)).astype(np.float32)
    arrays["mig.mask"] = rng.uniform(size=(2, 8)) < 0.5
    rco = get_scenario("multi_area_migratory").colocation(0, M, REBUCKET_T)
    rco["pos"] = rng.uniform(size=(REBUCKET_T, M, 2)).astype(np.float32)
    arrays.update({"rco." + k: rco[k] for k in ("fixed_id", "exchange",
                                                 "pos", "area")})
    b = _stacked_batches(rng, REBUCKET_T)
    arrays.update({"rb.mx": b["b.mx"], "rb.my": b["b.my"]})
    return pop, arrays


def _rebucket_threshold(area):
    """Half the smallest non-zero drift the schedule shows at a check, so
    the first drifting check swaps (the reference decides the same)."""
    drifts = []
    base = area[0]
    for t_end in range(REBUCKET_EVERY, REBUCKET_T, REBUCKET_EVERY):
        now = area[t_end - 1]
        drifts.append(float(np.mean(now != base)))
        base = now[np.argsort(now, kind="stable")]
        area = area[:, np.argsort(now, kind="stable")]
    assert max(drifts) > 0, "no mule migrates: re-bucketing is vacuous"
    return 0.5 * min(x for x in drifts if x > 0)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case over one 4-rank gloo world (one spawn)."""
    d = tmp_path_factory.mktemp("world")
    pop, arrays = _world_inputs()
    threshold = _rebucket_threshold(arrays["rco.area"])
    np.savez(d / "cases.npz", **arrays)
    runs = [dict(zip(("method", "mode", "stat", "pod", "data", "pod_axis",
                      "cross_pod", "prune"), r)) for r in RUNS]
    (d / "cases.json").write_text(json.dumps({
        "runs": runs, "lr": LR, "M": M, "F": F, "rebucket_F": REBUCKET_F,
        "rebucket_methods": REBUCKET_METHODS,
        "rebucket_every": REBUCKET_EVERY, "threshold": threshold}))
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    mp.spawn_local_cluster([sys.executable, "-c", _CHILD, str(d)], N_RANKS,
                           coordinator=f"file://{d}/store", base_env=env,
                           timeout=240)
    ranks = [dict(np.load(d / f"out{i}.npz")) for i in range(N_RANKS)]
    return pop, arrays, runs, threshold, ranks


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------


class _Mesh:
    """What ``make_distributed_method_step`` reads of a mesh."""
    def __init__(self, shape):
        self.shape = shape


def _jax_train(params, batch, key):
    xb, yb = batch
    g = jax.grad(lambda p: jnp.mean((xb @ p["w"] + p["b"] - yb) ** 2))(params)
    return jax.tree.map(lambda p, gg: p - LR * gg, params, g)


def _jax_dist_run(case, pop, arrays):
    """The reference's distributed step under ``jax.vmap`` over the data
    shards, walked step by step as its engine's scan does."""
    n = case["data"]
    m_loc = M // n
    pcfg = jpop.PopulationConfig(mode=case["mode"], n_fixed=F, n_mules=M,
                                 freshness=jf.FreshnessConfig(
                                     stat=case["stat"]))
    dcfg = jd.DistributedConfig(pop=pcfg, pod_axis="",
                                ring_prune=case["prune"], ring_bits=32)
    step = jd.make_distributed_method_step(case["method"], _jax_train, dcfg,
                                           mesh=_Mesh({"data": n}))
    state = jd.to_distributed_state(jax.tree.map(jnp.asarray, pop), dcfg)

    def shard(x):
        x = jnp.asarray(x)
        return x.reshape((n, m_loc) + x.shape[1:])

    def cols(x):                      # [T, M, ...] -> [T, n, m_loc, ...]
        x = jnp.asarray(x)
        return x.reshape((x.shape[0], n, m_loc) + x.shape[2:])

    st = {k: jax.tree.map(shard if k.startswith("mule") else
                          (lambda l: jnp.broadcast_to(l[None],
                                                      (n,) + l.shape)), v)
          for k, v in state.items()}
    fixed = case["mode"] == "fixed"
    bx, by = ((arrays["b.fx"], arrays["b.fy"]) if fixed else
              (cols(arrays["b.mx"]), cols(arrays["b.my"])))
    fid, exch, pos, act = (cols(arrays["co." + k]) for k in
                           ("fixed_id", "exchange", "pos", "active"))
    area = shard(arrays["co.area"])

    def one(s, info, b, t):
        batches = {"fixed": b, "mule": None} if fixed else \
            {"fixed": None, "mule": b}
        return step(s, {**info, "t": t}, batches, jax.random.PRNGKey(0))

    vstep = jax.jit(jax.vmap(one, axis_name="data",
                             in_axes=(0, 0, None if fixed else 0, None)))
    last = jnp.zeros((n, m_loc), jnp.int32)
    for t in range(T):
        info = {"fixed_id": fid[t], "exchange": exch[t], "pos": pos[t],
                "area": area, "active": act[t]}
        st = vstep(st, info, (jnp.asarray(bx[t]), jnp.asarray(by[t])),
                   jnp.int32(t))
        last = jnp.where((fid[t] >= 0) & act[t], fid[t], last)
    flat = {k: jax.tree.map(lambda l: np.asarray(l).reshape(
        (M,) + l.shape[2:]) if k.startswith("mule") else np.asarray(l[0]), v)
        for k, v in st.items()}
    return flat, np.asarray(last).reshape(M)


def _assert_close_to_jax(got, tag, want, last):
    for k in ("w", "b"):
        np.testing.assert_allclose(got[f"{tag}.mule.{k}"],
                                   want["mule_models"][k], atol=1e-5,
                                   rtol=1e-5, err_msg=f"{tag} mule {k}")
        np.testing.assert_allclose(got[f"{tag}.fixed.{k}"],
                                   want["fixed_models"][k], atol=1e-5,
                                   rtol=1e-5, err_msg=f"{tag} fixed {k}")
    np.testing.assert_array_equal(got[f"{tag}.mule_ts"], want["mule_ts"])
    np.testing.assert_array_equal(got[f"{tag}.t"], want["t"])
    np.testing.assert_array_equal(got[f"{tag}.last"], last)
    for k, v in want["fresh"].items():
        if k == "count":
            np.testing.assert_array_equal(got[f"{tag}.fresh.{k}"], v)
        else:
            np.testing.assert_allclose(got[f"{tag}.fresh.{k}"], v,
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{tag} fresh {k}")


REPLICATED = ("fixed.w", "fixed.b", "fresh.threshold", "fresh.hist",
              "fresh.count", "t")


def _assert_replicated_equal(ranks, tag):
    for k in REPLICATED:
        key = f"{tag}.{k}"
        if key not in ranks[0]:
            continue
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[key], ranks[0][key],
                                          err_msg=key)


# ---------------------------------------------------------------------------
# the distributed step and engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", range(len(RUNS)),
                         ids=[f"{r[0]}-{r[1]}-{r[2]}-{r[3]}x{r[4]}"
                              f"{'-nopod' if not r[5] else ''}"
                              f"{'-podlocal' if not r[6] else ''}"
                              f"{'-dense' if not r[7] else ''}"
                              for r in RUNS])
def test_distributed_run_matches_jax_vmapped(world, c):
    pop, arrays, runs, _, ranks = world
    case = runs[c]
    want, last = _jax_dist_run(case, pop, arrays)
    _assert_close_to_jax(ranks[0], f"run{c}", want, last)
    _assert_replicated_equal(ranks, f"run{c}")
    if case["method"] in ("mlmule", "mlmule+gossip"):
        if case["stat"] == "median":
            assert int(ranks[0][f"run{c}.fresh.count"].sum()) > \
                int(pop["fresh"]["count"].sum()), "no delivery: vacuous"
        else:
            assert (ranks[0][f"run{c}.fresh.threshold"]
                    != pop["fresh"]["threshold"]).any(), "no delivery"


def test_pruned_ring_equals_dense_ring(world):
    """Pruning is exact, and on the bucket-ordered areas it skips hops."""
    _, _, runs, _, ranks = world
    pruned = RUNS.index(("gossip", "mobile", "median", 1, 4, "pod", True,
                         True))
    dense = RUNS.index(("gossip", "mobile", "median", 1, 4, "pod", True,
                        False))
    for k in ("mule.w", "mule.b", "fixed.w", "mule_ts", "last"):
        np.testing.assert_array_equal(ranks[0][f"run{pruned}.{k}"],
                                      ranks[0][f"run{dense}.{k}"])
    hops_pruned = [int(r[f"run{pruned}.hops"]) for r in ranks]
    hops_dense = [int(r[f"run{dense}.hops"]) for r in ranks]
    assert hops_dense == [N_RANKS * (T // 3)] * N_RANKS
    assert sum(hops_pruned) < sum(hops_dense)


def test_ordered_psum_folds_in_rank_order(world):
    _, arrays, _, _, ranks = world
    x = arrays["psum.x"]
    full = ((x[0] + x[1]) + x[2]) + x[3]
    for name, data_groups in (("1x4", [[0, 1, 2, 3]]),
                              ("2x2", [[0, 1], [2, 3]])):
        for i, r in enumerate(ranks):
            np.testing.assert_array_equal(r[f"psum.{name}.all"], full)
            group = [g for g in data_groups if i in g][0]
            part = x[group[0]]
            for j in group[1:]:
                part = part + x[j]
            np.testing.assert_array_equal(r[f"psum.{name}.data"], part)
            np.testing.assert_array_equal(r[f"pmean.{name}.data"],
                                          part / np.float32(len(group)))


def test_global_bucket_order_is_a_stable_argsort(world):
    _, arrays, _, _, ranks = world
    blocks = arrays["area.blocks"]
    for name, n_data in (("1x4", 4), ("2x2", 2)):
        area = blocks[:n_data].reshape(-1)
        for r in ranks:
            np.testing.assert_array_equal(r[f"order.{name}.area"], area)
            np.testing.assert_array_equal(r[f"order.{name}"],
                                          np.argsort(area, kind="stable"))


def test_migrate_mules_walks_the_pod_ring(world):
    """One swap: a flagged slot takes the other pod's row; two swaps (the
    pod count) bring every slot home bitwise."""
    _, arrays, _, _, ranks = world
    w, mask = arrays["mig.w"], arrays["mig.mask"]
    for i, r in enumerate(ranks):
        pod, block = divmod(i, 2)
        other = w[1 - pod, block]
        want = np.where(mask[block][:, None], other, w[pod, block])
        np.testing.assert_array_equal(r["mig.once"], want)
        np.testing.assert_array_equal(r["mig.twice"], w[pod, block])


# ---------------------------------------------------------------------------
# re-bucketing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", REBUCKET_METHODS)
def test_rebucketed_streamed_run_matches_jax(world, method):
    """The port's re-bucketed streamed run over 4 ranks against the
    reference's ``run_population_streamed`` with the same ``dcfg`` on a
    one-device mesh: the same drift readings (equal on every rank), swaps
    and cumulative order, weights to 1e-5, sketch counts exact."""
    _, arrays, _, threshold, ranks = world
    pop = _population(REBUCKET_F, seed=1)
    rco = {k: arrays["rco." + k] for k in ("fixed_id", "exchange", "pos",
                                            "area")}
    pcfg = jpop.PopulationConfig(mode="mobile", n_fixed=REBUCKET_F,
                                 n_mules=M)
    dcfg = jd.DistributedConfig(pop=pcfg, rebucket_every=REBUCKET_EVERY,
                                rebucket_threshold=threshold)
    state = jd.to_distributed_state(jax.tree.map(jnp.asarray, pop), dcfg)
    want, aux = jax_streamed(
        state, js.compact_colocation(rco),
        {"fixed": None, "mule": (jnp.asarray(arrays["rb.mx"]),
                                 jnp.asarray(arrays["rb.my"]))},
        _jax_train, pcfg, jax.random.PRNGKey(0), chunk_len=REBUCKET_EVERY,
        method=method, donate=False, dcfg=dcfg,
        mesh=jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                               ("pod", "data")))
    want = jax.tree.map(np.asarray, want)
    tag = f"rb.{method}"
    _assert_close_to_jax(ranks[0], tag, want, np.asarray(aux["last_fid"]))
    _assert_replicated_equal(ranks, tag)
    rb = aux["rebucket"]
    assert rb["swaps"] >= 1, "no swap: re-bucketing is vacuous"
    for r in ranks:
        np.testing.assert_array_equal(r[f"{tag}.counts"],
                                      [rb["checks"], rb["swaps"]])
        np.testing.assert_array_equal(r[f"{tag}.drift"], rb["drift"])
        np.testing.assert_array_equal(r[f"{tag}.order"], rb["order"])
    assert sorted(ranks[0][f"{tag}.order"].tolist()) == list(range(M))


@pytest.mark.parametrize("method", REBUCKET_METHODS)
def test_run_population_distributed_hands_rebucketing_to_the_stream(
        world, method):
    _, _, _, _, ranks = world
    for r in ranks:
        for k in r:
            if k.startswith(f"rbd.{method}."):
                np.testing.assert_array_equal(
                    r[k], r["rb" + k[3:]], err_msg=k)
