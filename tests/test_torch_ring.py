"""Port's ring peer exchange against the JAX package: the hop-prune
predicate, the bucketing helpers, the per-hop kernel's plain version and
wrapper, the multi-process launcher, and the ring itself over 2 and 4 gloo
ranks.

Inputs come from a numpy seed and go to both packages. The ring runs in
child processes that import only ``repro_torch`` (``spawn_local_cluster``,
one ``FileStore`` under the test's temporary directory, so parallel test
workers never share a port); the reference's ring runs in this process
under ``jax.vmap(..., axis_name="r")``, where its ``ppermute`` hops and
``psum`` behave as on a mesh. Bounds:

- masks, summaries, permutations, bucketing, masses, OppCL's ``met`` and
  peer ids: bitwise (integer and 0/1 arithmetic, the gate bitwise);
- the ring's mix and one hop's partial sums: 1e-6 (fp32 sums of a few
  terms of |w| < 5 in another order, ~1e-7);
- one gossip or OppCL step's weights: 1e-5 (the mix's ~1e-7, then one SGD
  step of a linear model, as in tests/test_torch_peer_baselines.py);
- pruned against unpruned ring in the port: bitwise (a pruned hop would
  add exactly zero).
"""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.baselines import gossip as jg  # noqa: E402
from repro.baselines import oppcl as jo  # noqa: E402
from repro.core import distributed as jd  # noqa: E402
from repro.kernels.encounter_mix.kernel import encounter_hop_pallas  # noqa: E402
from repro.kernels.encounter_mix.ref import encounter_block as j_block  # noqa: E402
from repro_torch.baselines import gossip as tg  # noqa: E402
from repro_torch.core import distributed as td  # noqa: E402
from repro_torch.kernels.encounter_mix import (encounter_block,  # noqa: E402
                                               encounter_block_hop)
from repro_torch.launch import multiprocess as mp  # noqa: E402

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# hop-prune predicate and ring layout
# ---------------------------------------------------------------------------


def _areas(seed, m, n_areas, p_active):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_areas, m).astype(np.int32),
            rng.uniform(size=m) < p_active)


@pytest.mark.parametrize("seed,m,n_areas,p_active,n_bits", [
    (0, 9, 3, 1.0, 32), (1, 17, 40, 0.7, 32), (2, 30, 70, 0.5, 64),
    (3, 5, 2, 0.0, 32), (4, 1, 1, 1.0, 32)])
def test_area_bits_matches_jax(seed, m, n_areas, p_active, n_bits):
    area, act = _areas(seed, m, n_areas, p_active)
    for a in (None, act):
        got = tg.area_bits(torch.tensor(area),
                           None if a is None else torch.tensor(a), n_bits)
        want = jg.area_bits(jnp.asarray(area),
                            None if a is None else jnp.asarray(a), n_bits)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_hops_needed_matches_jax(n):
    table = np.random.default_rng(n).uniform(size=(n, 32)) < 0.05
    got = tg.hops_needed(torch.tensor(table))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jg.hops_needed(
                                      jnp.asarray(table))))


@pytest.mark.parametrize("n_shards,m_loc,n_areas,p_active,bucketed", [
    (2, 4, 2, 1.0, True), (4, 4, 4, 1.0, True), (4, 3, 5, 0.6, False),
    (8, 4, 8, 1.0, True), (8, 2, 40, 0.8, True), (4, 5, 3, 0.3, False)])
def test_ring_hop_mask_matches_jax(n_shards, m_loc, n_areas, p_active,
                                   bucketed):
    area, act = _areas(n_shards * 10 + m_loc, n_shards * m_loc, n_areas,
                       p_active)
    if bucketed:
        order = td.bucket_mule_order(area)
        area, act = area[order], act[order]
    for a in (None, act):
        got = tg.ring_hop_mask(area, a, n_shards)
        want = jg.ring_hop_mask(area, a, n_shards)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("area", [[0, 1, 33, 5], [], [0, 32, 64, 1],
                                  list(range(70)), [3, 3, 3]])
def test_area_bit_collision_rate_matches_jax(area):
    a = np.asarray(area, np.int32)
    for n_bits in (32, 64):
        assert tg.area_bit_collision_rate(a, n_bits) == \
            jg.area_bit_collision_rate(a, n_bits)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_ring_spec_permutations_match_jax(n):
    got, want = tg.RingSpec(n), jg.RingSpec("r", n)
    assert got.perm() == want.perm()
    for s in range(n):
        assert got.shift_perm(s) == want.shift_perm(s)
        for src, dst in got.shift_perm(s):
            assert src == (dst - s) % n          # rank i receives i - s


# ---------------------------------------------------------------------------
# bucketing helpers
# ---------------------------------------------------------------------------


def _colocation(seed, m=12, t=5):
    rng = np.random.default_rng(seed)
    return {"fixed_id": rng.integers(-1, 4, (t, m)).astype(np.int32),
            "exchange": rng.uniform(size=(t, m)) < 0.5,
            "pos": rng.uniform(size=(t, m, 2)).astype(np.float32),
            "area": rng.integers(0, 3, m).astype(np.int32),
            "init_space": rng.integers(0, 4, m),
            "n_steps": np.int32(t)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bucket_order_and_reorder_colocation_match_jax(seed):
    co = _colocation(seed)
    order = td.bucket_mule_order(co["area"])
    np.testing.assert_array_equal(order, jd.bucket_mule_order(co["area"]))
    trace = np.stack([co["area"], co["area"][::-1]])       # [T, M]: row 0
    np.testing.assert_array_equal(td.bucket_mule_order(trace),
                                  jd.bucket_mule_order(trace))
    got, want = td.reorder_colocation(co, order), \
        jd.reorder_colocation(co, order)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_reorder_mule_state_matches_jax():
    rng = np.random.default_rng(5)
    m = 10
    order = rng.permutation(m)
    state = {"mule_models": {"w": rng.normal(size=(m, 3)).astype(np.float32),
                             "b": rng.normal(size=(m,)).astype(np.float32)},
             "mule_ts": np.arange(m, dtype=np.int32),
             "fixed_models": {"w": rng.normal(size=(4, 3))},
             "t": np.int32(3)}
    want = jd.reorder_mule_state(state, order)
    as_torch = {"mule_models": {k: torch.tensor(v) for k, v in
                                state["mule_models"].items()},
                "mule_ts": torch.tensor(state["mule_ts"]),
                "fixed_models": state["fixed_models"], "t": state["t"]}
    for st in (state, as_torch):
        got = td.reorder_mule_state(st, order)
        for k in ("w", "b"):
            np.testing.assert_array_equal(np.asarray(got["mule_models"][k]),
                                          np.asarray(want["mule_models"][k]))
        np.testing.assert_array_equal(np.asarray(got["mule_ts"]),
                                      np.asarray(want["mule_ts"]))
        assert got["fixed_models"] is st["fixed_models"]
        assert got["t"] == st["t"]


@pytest.mark.parametrize("area,n_shards", [
    (np.repeat(np.arange(4), 4), 4), (np.tile(np.arange(4), 4), 4),
    (np.zeros(8, np.int32), 1), (np.arange(7) % 3, 3),
    (np.random.default_rng(0).integers(0, 5, 50), 4),
    (np.stack([np.arange(6) % 2, np.zeros(6, int)]), 2)])
def test_bucket_locality_fraction_matches_jax(area, n_shards):
    area = np.asarray(area, np.int32)
    assert td.bucket_locality_fraction(area, n_shards) == \
        jd.bucket_locality_fraction(area, n_shards)


# ---------------------------------------------------------------------------
# one hop: the plain version and the wrapper
# ---------------------------------------------------------------------------


def _hop_case(r, v, d, seed=0):
    rng = np.random.default_rng(seed * 100 + r * 7 + v)
    return (rng.uniform(size=(r, 2)).astype(np.float32),
            rng.integers(0, 3, r).astype(np.int32), rng.uniform(size=r) < 0.8,
            rng.uniform(size=(v, 2)).astype(np.float32),
            rng.integers(0, 3, v).astype(np.int32), rng.uniform(size=v) < 0.8,
            rng.normal(size=(v, d)).astype(np.float32))


# tests/test_ring_exchange.py's (r, v, d, row0, col0) cases
HOP_CASES = [(16, 16, 48, 0, 0), (16, 16, 48, 16, 48), (12, 20, 7, 0, 8),
             (8, 8, 8, 24, 24)]


@pytest.mark.parametrize("r,v,d,row0,col0", HOP_CASES)
def test_encounter_block_hop_matches_jax(r, v, d, row0, col0):
    pr, ar, cr, pv, av, cv, w = _hop_case(r, v, d)
    before = encounter_block_hop.launches
    acc, mass = encounter_block_hop(
        *map(torch.tensor, (pr, ar, cr)), row0,
        *map(torch.tensor, (pv, av, cv)), col0, torch.tensor(w), 0.3)
    assert encounter_block_hop.launches == before       # CPU: plain version
    assert acc.dtype == mass.dtype == torch.float32
    jargs = (*map(jnp.asarray, (pr, ar, cr)), row0,
             *map(jnp.asarray, (pv, av, cv)), col0, jnp.asarray(w))
    ref = j_block(*jargs, 0.3)
    pallas = encounter_hop_pallas(*jargs, radius=0.3, block_m=8,
                                  block_d=128, interpret=True)
    assert float(mass.sum()) > 0                        # not degenerate
    for want_acc, want_mass in (ref, pallas):
        np.testing.assert_array_equal(mass.numpy(), np.asarray(want_mass))
        np.testing.assert_allclose(acc.numpy(), np.asarray(want_acc),
                                   atol=1e-6, rtol=1e-6)
    got_ref = encounter_block_hop(
        *map(torch.tensor, (pr, ar, cr)), row0,
        *map(torch.tensor, (pv, av, cv)), col0, torch.tensor(w), 0.3,
        backend="ref")
    for a, b in zip(got_ref, (acc, mass)):
        assert torch.equal(a, b)


def test_encounter_block_hop_is_encounter_block_with_active_none():
    pr, ar, _, pv, av, _, w = _hop_case(9, 13, 5, seed=3)
    args = (torch.tensor(pr), torch.tensor(ar), None, 4, torch.tensor(pv),
            torch.tensor(av), None, 0, torch.tensor(w), 0.5)
    for a, b in zip(encounter_block_hop(*args), encounter_block(*args)):
        assert torch.equal(a, b)


def test_encounter_block_hop_rejects_bad_inputs():
    pr, ar, cr, pv, av, cv, w = map(torch.tensor, _hop_case(6, 5, 4))
    with pytest.raises(ValueError):
        encounter_block_hop(pr, ar, cr, 0, pv, av, cv, 6, w, 0.3,
                            backend="nope")
    with pytest.raises(TypeError):
        encounter_block_hop(pr, ar, cr, 0, pv, av, cv, 6,
                            w.to(torch.bfloat16), 0.3)
    with pytest.raises(TypeError):
        encounter_block_hop(pr, ar, cr, 0, pv, av, cv, 6, w.double(), 0.3,
                            backend="ref")
    with pytest.raises(ValueError):
        encounter_block_hop(pr, ar, cr, 0, pv[:4], av, cv, 6, w, 0.3)
    with pytest.raises(ValueError):
        encounter_block_hop(pr, ar[:5], cr, 0, pv, av, cv, 6, w, 0.3)
    with pytest.raises(TypeError):
        encounter_block_hop(pr, ar.float(), cr, 0, pv, av, cv, 6, w, 0.3)
    with pytest.raises(TypeError):
        encounter_block_hop(pr, ar, cr.float(), 0, pv, av, cv, 6, w, 0.3)


@pytest.mark.cuda
def test_hop_kernel_matches_plain_on_card(cuda_device):
    """The hop kernel against ``encounter_block`` on the card: the cases
    above, a ragged R != V over several row blocks and visiting chunks
    with D not a multiple of 128, ids past 2^24, and an empty visiting
    block, with the rows' positions strided; masses exactly equal, sums
    within 1e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = HOP_CASES + [(100, 70, 1000, 64, 0), (65, 33, 130, 1 << 25,
                                                  (1 << 25) + 10),
                         (40, 0, 17, 0, 40)]
    for r, v, d, row0, col0 in cases:
        pr, ar, cr, pv, av, cv, w = (torch.tensor(a).to(cuda_device)
                                     for a in _hop_case(r, v, d))
        pr = pr.t().contiguous().t()          # strided geometry is taken
        before = encounter_block_hop.launches
        acc, mass = encounter_block_hop(pr, ar, cr, row0, pv, av, cv, col0,
                                        w, 0.3)
        torch.cuda.synchronize()
        assert encounter_block_hop.launches == before + 1
        ref_acc, ref_mass = encounter_block(pr, ar, cr, row0, pv, av, cv,
                                            col0, w, 0.3)
        assert torch.equal(mass, ref_mass)
        torch.testing.assert_close(acc, ref_acc, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_local_cluster_env_and_init_from_env():
    env = mp.local_cluster_env(2, 4, "127.0.0.1:1234", base_env={"A": "1"})
    assert env == {"A": "1", mp.ENV_COORDINATOR: "127.0.0.1:1234",
                   mp.ENV_NUM_PROCESSES: "4", mp.ENV_PROCESS_ID: "2"}
    assert mp.initialize_from_env({}) is False
    # a one-process cluster needs no process group
    assert mp.initialize_from_env(mp.local_cluster_env(0, 1, "x:1", {}))
    assert not torch.distributed.is_initialized()
    assert 0 < mp.pick_free_port() < 65536


def test_spawn_local_cluster_raises_when_a_rank_fails(tmp_path):
    code = ("import os, sys, time; r = int(os.environ['REPRO_MP_PROCESS_ID']);"
            " print('rank', r, os.environ['REPRO_MP_NUM_PROCESSES']);"
            " sys.exit(3) if r == 1 else time.sleep(60 if r == 2 else 0)")
    with pytest.raises(RuntimeError, match="rank 1 of 3 exited with 3"):
        mp.spawn_local_cluster([sys.executable, "-c", code], 3, timeout=50)
    ok = mp.spawn_local_cluster(
        [sys.executable, "-c", "import os; print(os.environ["
         "'REPRO_MP_PROCESS_ID'])"], 2, coordinator=f"file://{tmp_path}/s")
    assert [(c.returncode, c.stdout.strip()) for c in ok] == \
        [(0, "0"), (0, "1")]


# ---------------------------------------------------------------------------
# the ring over gloo ranks
# ---------------------------------------------------------------------------

RADIUS = 0.3
LR = 0.05
M_LOC = 8

# Runs in each rank: only repro_torch, numpy and torch are imported. For
# every case it runs the ring pruned and unpruned and saves what each rank
# computed, and the ring's counters before and after each call.
_CHILD = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.baselines import gossip, oppcl
from repro_torch.core.seeds import split
from repro_torch.launch.multiprocess import initialize_from_env

torch.set_num_threads(1)
assert initialize_from_env()
n, i = dist.get_world_size(), dist.get_rank()
data = np.load(sys.argv[1] + "/cases.npz")
spec = json.load(open(sys.argv[1] + "/cases.json"))
LR = spec["lr"]


def train_fn(params, batch, key):
    xb, yb = batch
    def loss(p):
        return torch.mean((xb @ p["w"] + p["b"] - yb) ** 2)
    g = torch.func.grad(loss)(params)
    return {k: p - LR * g[k] for k, p in params.items()}


out = {}
for c, case in enumerate(spec["cases"]):
    ml = case["m"] // n
    sl = slice(i * ml, (i + 1) * ml)
    def get(name):
        key = f"{c}.{name}"
        return torch.from_numpy(data[key][sl].copy()) if key in data else None
    pos, area, act = get("pos"), get("area"), get("act")
    for prune in (True, False):
        ring = gossip.RingSpec(n, prune=prune)
        tag = f"{c}.{int(prune)}"
        hops = gossip.RING_COUNTS["hops"]
        if case["kind"] == "mix":
            mix, mass = gossip.ring_encounter_mix(
                pos, area, act, get("w"), radius=case["radius"], ring=ring)
            out[tag + ".mix"], out[tag + ".mass"] = mix.numpy(), mass.numpy()
        else:
            models = {"w": get("mw"), "b": get("mb")}
            batches = (get("x"), get("y"))
            keys = split(case["key"], case["m"], "cpu")[sl]
            step = gossip.gossip_step if case["kind"] == "gossip" \
                else oppcl.oppcl_step
            new = step(models, pos, area, batches, train_fn, case["key"],
                       radius=case["radius"], gamma=0.5, active=act,
                       ring=ring, keys=keys)
            out[tag + ".w"], out[tag + ".b"] = new["w"].numpy(), \
                new["b"].numpy()
            if case["kind"] == "oppcl":
                pb, met, peer = oppcl._ring_nearest_peer(
                    pos, area, act, batches, radius=case["radius"],
                    ring=ring)
                out[tag + ".px"], out[tag + ".met"], out[tag + ".peer"] = \
                    pb[0].numpy(), met.numpy(), peer.numpy()
        out[tag + ".hops"] = np.array(gossip.RING_COUNTS["hops"] - hops)
dist.barrier()
bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "repro")]
assert not bad, bad
np.savez(sys.argv[1] + f"/out{i}.npz", **out)
'''


def _ring_cases(n):
    """Mix, gossip and OppCL cases over n ranks of M_LOC mules each."""
    m = n * M_LOC
    rng = np.random.default_rng(100 + n)
    cases, arrays = [], {}

    def geometry(c, n_areas, p_active, bucketed, zero_pos=False):
        area = rng.integers(0, n_areas, m).astype(np.int32)
        order = td.bucket_mule_order(area) if bucketed else np.arange(m)
        pos = rng.uniform(size=(m, 2)).astype(np.float32)
        if zero_pos:
            pos[:] = 0.0
        arrays[f"{c}.pos"], arrays[f"{c}.area"] = pos, area[order]
        if p_active is not None:
            arrays[f"{c}.act"] = rng.uniform(size=m) < p_active

    # (kind, radius, n_areas, p_active, bucketed, zero_pos, D)
    for kind, radius, n_areas, p_act, bucketed, zero, d in [
            ("mix", RADIUS, n, 0.8, True, False, 37),
            ("mix", RADIUS, 3, None, False, False, 130),
            ("mix", 0.15, 2, None, True, True, 5),
            ("gossip", RADIUS, n, 0.8, True, False, 5),
            ("gossip", RADIUS, 2, None, False, False, 5),
            ("oppcl", RADIUS, n, 0.8, True, False, 5),
            ("oppcl", 0.15, 2, 0.9, True, True, 5)]:
        c = len(cases)
        geometry(c, n_areas, p_act, bucketed, zero)
        if kind == "mix":
            arrays[f"{c}.w"] = rng.normal(size=(m, d)).astype(np.float32)
        else:
            arrays[f"{c}.mw"] = rng.normal(size=(m, d)).astype(np.float32)
            arrays[f"{c}.mb"] = rng.normal(size=(m,)).astype(np.float32)
            arrays[f"{c}.x"] = rng.normal(size=(m, 4, d)).astype(np.float32)
            arrays[f"{c}.y"] = rng.normal(size=(m, 4)).astype(np.float32)
        cases.append({"kind": kind, "radius": radius, "m": m, "key": 7 + c})
    return cases, arrays


def _jax_train(params, batch, key):
    xb, yb = batch
    g = jax.grad(lambda p: jnp.mean((xb @ p["w"] + p["b"] - yb) ** 2))(params)
    return jax.tree.map(lambda p, gg: p - LR * gg, params, g)


def _jax_ring(case, arrays, c, n):
    """The reference's pruned ring on the same case, vmapped over n
    shards."""
    def blocks(x):
        x = jnp.asarray(x)
        return x.reshape((n, -1) + x.shape[1:])

    def get(name):
        key = f"{c}.{name}"
        return blocks(arrays[key]) if key in arrays else None

    ring = jg.RingSpec("r", n)
    r = case["radius"]
    pos, area, act = get("pos"), get("area"), get("act")
    if case["kind"] == "mix":
        return jax.vmap(lambda p, a, ac, w: jg.ring_encounter_mix(
            p, a, ac, w, radius=r, ring=ring), axis_name="r",
            in_axes=(0, 0, None if act is None else 0, 0))(
                pos, area, act, get("w"))
    models = {"w": get("mw"), "b": get("mb")}
    batches = (get("x"), get("y"))
    keys = blocks(jax.random.split(jax.random.PRNGKey(case["key"]),
                                   case["m"]))
    step = jg.gossip_step if case["kind"] == "gossip" else jo.oppcl_step

    def one(mo, p, a, ac, b, k):
        new = step(mo, p, a, b, _jax_train, None, radius=r, gamma=0.5,
                   active=ac, ring=ring, keys=k)
        if case["kind"] == "gossip":
            return new, None
        return new, jo._ring_nearest_peer(p, a, ac, b, radius=r, ring=ring)

    return jax.vmap(one, axis_name="r",
                    in_axes=(0, 0, 0, None if act is None else 0, 0, 0))(
        models, pos, area, act, batches, keys)


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ring_run(request, tmp_path_factory):
    """Every case over n gloo ranks (one spawn), beside the reference's
    vmapped ring on the same inputs."""
    n = request.param
    d = tmp_path_factory.mktemp(f"ring{n}")
    cases, arrays = _ring_cases(n)
    np.savez(d / "cases.npz", **arrays)
    (d / "cases.json").write_text(json.dumps({"cases": cases, "lr": LR}))
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    mp.spawn_local_cluster([sys.executable, "-c", _CHILD, str(d)], n,
                           coordinator=f"file://{d}/store", base_env=env,
                           timeout=240)
    ranks = [np.load(d / f"out{i}.npz") for i in range(n)]
    got = {k: np.concatenate([np.atleast_1d(r[k]) for r in ranks])
           for k in ranks[0].files}
    want = [_jax_ring(case, arrays, c, n) for c, case in enumerate(cases)]
    return n, cases, arrays, got, want


def _flat(x):
    x = np.asarray(x)
    return x.reshape((-1,) + x.shape[2:])


def test_ring_encounter_mix_matches_jax_ring(ring_run):
    n, cases, arrays, got, want = ring_run
    for c, case in enumerate(cases):
        if case["kind"] != "mix":
            continue
        mix, mass = want[c]
        np.testing.assert_array_equal(got[f"{c}.1.mass"], _flat(mass))
        np.testing.assert_allclose(got[f"{c}.1.mix"], _flat(mix), atol=1e-6,
                                   rtol=1e-6)
        assert got[f"{c}.1.mass"].sum() > 0, "no encounter: vacuous"
        # and the single-host reference of the whole population
        act = arrays.get(f"{c}.act")
        _, one_mass = jg.encounter_mix(
            jnp.asarray(arrays[f"{c}.pos"]), jnp.asarray(arrays[f"{c}.area"]),
            None if act is None else jnp.asarray(act),
            jnp.asarray(arrays[f"{c}.w"]), radius=case["radius"])
        np.testing.assert_array_equal(got[f"{c}.1.mass"],
                                      np.asarray(one_mass))


def test_gossip_step_ring_matches_jax_ring(ring_run):
    n, cases, _, got, want = ring_run
    for c, case in enumerate(cases):
        if case["kind"] != "gossip":
            continue
        new, _ = want[c]
        for leaf in ("w", "b"):
            np.testing.assert_allclose(got[f"{c}.1.{leaf}"],
                                       _flat(new[leaf]), atol=1e-5,
                                       rtol=1e-5)


def test_oppcl_ring_matches_jax_ring(ring_run):
    """Peer ids and met bitwise against the reference's single-host argmin
    and its ring; the peer's batch bitwise where met; the step's weights
    to 1e-5."""
    n, cases, arrays, got, want = ring_run
    for c, case in enumerate(cases):
        if case["kind"] != "oppcl":
            continue
        new, (peer_b, met) = want[c]
        np.testing.assert_array_equal(got[f"{c}.1.met"], _flat(met))
        act = arrays.get(f"{c}.act")
        pos = jnp.asarray(arrays[f"{c}.pos"])
        area = jnp.asarray(arrays[f"{c}.area"])
        d2 = jo._block_d2(pos, area, None if act is None else
                          jnp.asarray(act), 0, pos, area,
                          None if act is None else jnp.asarray(act), 0)
        d2 = jnp.where(d2 <= case["radius"] ** 2, d2, jnp.inf)
        one_peer = np.asarray(jnp.argmin(d2, axis=1))
        one_met = np.isfinite(np.asarray(jnp.min(d2, axis=1)))
        met_rows = got[f"{c}.1.met"] > 0
        np.testing.assert_array_equal(met_rows, one_met)
        assert met_rows.sum() > 0, "no encounter: vacuous"
        np.testing.assert_array_equal(got[f"{c}.1.peer"][met_rows],
                                      one_peer[met_rows])
        np.testing.assert_array_equal(got[f"{c}.1.px"][met_rows],
                                      _flat(peer_b[0])[met_rows])
        for leaf in ("w", "b"):
            np.testing.assert_allclose(got[f"{c}.1.{leaf}"],
                                       _flat(new[leaf]), atol=1e-5,
                                       rtol=1e-5)


def test_pruned_ring_equals_unpruned(ring_run):
    n, cases, _, got, _ = ring_run
    for c, case in enumerate(cases):
        names = {"mix": ("mix", "mass"), "gossip": ("w", "b"),
                 "oppcl": ("w", "b", "met")}[case["kind"]]
        for name in names:
            np.testing.assert_array_equal(got[f"{c}.1.{name}"],
                                          got[f"{c}.0.{name}"])
        if case["kind"] == "oppcl":
            met = got[f"{c}.1.met"] > 0
            np.testing.assert_array_equal(got[f"{c}.1.peer"][met],
                                          got[f"{c}.0.peer"][met])


def test_ring_hops_equal_the_masks_kept_hops(ring_run):
    """Each rank computes the local hop and every hop the mask keeps
    (pruned), or all n (unpruned); OppCL's step and its direct search each
    walk the ring once. Some bucket-ordered case must prune."""
    n, cases, arrays, got, _ = ring_run
    pruned_any = False
    for c, case in enumerate(cases):
        mask = tg.ring_hop_mask(arrays[f"{c}.area"], arrays.get(f"{c}.act"),
                                n).numpy()
        walks = 2 if case["kind"] == "oppcl" else 1
        kept = 1 + int(mask[1:].sum())
        np.testing.assert_array_equal(got[f"{c}.1.hops"], [walks * kept] * n)
        np.testing.assert_array_equal(got[f"{c}.0.hops"], [walks * n] * n)
        pruned_any |= kept < n
    assert pruned_any
