"""Port's random walk (mobility/random_walk.py) against the JAX package.

torch cannot draw JAX's threefry bits, so the port's walk is a pure
function of its draws; these tests hand it the draws the reference's keys
produce (split exactly as ``init_mobility``/``mobility_step`` split them).
Fed those, every step equals the reference's eager step bitwise. Inside
``simulate_trajectories``' compiled ``lax.scan`` XLA contracts
``pos + sigma * noise`` into a fused multiply-add, so the scanned positions
drift a few float32 ulp from eager arithmetic (1.8e-7 over 50 steps here):
positions are held to 1e-6 there, and every integer and boolean column
(``fixed_id``, ``exchange``, ``space``) exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.mobility import random_walk as jwalk  # noqa: E402
from repro_torch.mobility import random_walk as twalk  # noqa: E402
from repro_torch.scenarios import get_scenario, walk_colocation  # noqa: E402

torch.set_num_threads(1)
M, T = 40, 50


def _cfgs(**kw):
    return jwalk.MobilityConfig(n_mules=M, **kw), \
        twalk.MobilityConfig(n_mules=M, **kw)


def _jax_draws(seed, cfg, n_steps):
    """The reference's draws for ``simulate_trajectories(PRNGKey(seed))``."""
    k1, k2, key = jax.random.split(jax.random.PRNGKey(seed), 3)
    sid = jax.random.randint(k1, (cfg.n_mules,), 0, 4)
    u = jax.random.uniform(k2, (cfg.n_mules, 2))
    noise, u_cross = [], []
    for _ in range(n_steps):
        key, k_step, k_cross = jax.random.split(key, 3)
        noise.append(np.asarray(jax.random.normal(k_step, (cfg.n_mules, 2))))
        u_cross.append(np.asarray(jax.random.uniform(k_cross,
                                                     (cfg.n_mules,))))
    return twalk.WalkDraws(sid=torch.tensor(np.asarray(sid)),
                           u=torch.tensor(np.asarray(u)),
                           step_noise=torch.tensor(np.stack(noise)),
                           u_cross=torch.tensor(np.stack(u_cross)))


def _eq(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_space_of_and_bounds_bitwise():
    rng = np.random.default_rng(0)
    s = np.float32(0.42)
    # uniform points plus points on and one ulp either side of each edge
    edges = np.array([s, np.float32(1.0) - s, 0.0, 1.0], np.float32)
    near = np.concatenate([edges, np.nextafter(edges, np.float32(2)),
                           np.nextafter(edges, np.float32(-1))])
    grid = np.stack(np.meshgrid(near, near), -1).reshape(-1, 2)
    pts = np.concatenate([rng.uniform(size=(200, 2)).astype(np.float32),
                          grid])
    for size in (0.42, 0.3):
        _eq(twalk.space_of(torch.tensor(pts), size),
            jwalk.space_of(jnp.asarray(pts), size))
    sid = np.array([-1, 0, 1, 2, 3], np.int32)
    for got, want in zip(twalk._space_bounds(torch.tensor(sid), 0.42),
                         jwalk._space_bounds(jnp.asarray(sid), 0.42)):
        _eq(got, want)


@pytest.mark.parametrize("p_cross", [0.0, 0.1, 0.6])
def test_mobility_step_bitwise(p_cross):
    """Each eager step of the reference, from the same state and draws."""
    cfg_j, cfg_t = _cfgs(p_cross=p_cross)
    draws = _jax_draws(4, cfg_j, 20)
    state = jwalk.init_mobility(jax.random.PRNGKey(4), cfg_j)
    port = twalk.init_mobility(cfg_t, draws.sid, draws.u)
    for k in ("pos", "area", "dwell"):
        _eq(port[k], state[k])
    crossed = 0
    for t in range(20):
        prev = np.asarray(jwalk.space_of(state["pos"], cfg_j.space_size))
        state, info = jwalk.mobility_step(state, cfg_j)
        port, got = twalk.mobility_step(port, cfg_t, draws.step_noise[t],
                                        draws.u_cross[t])
        for k in info:
            _eq(got[k], info[k])
        for k in ("pos", "area", "dwell"):
            _eq(port[k], state[k])
        crossed += int(((prev >= 0) & (np.asarray(info["space"]) != prev)
                        ).sum())
    assert (crossed > 0) == (p_cross > 0)


def test_trajectory_matches_simulate_trajectories():
    cfg_j, cfg_t = _cfgs()
    draws = _jax_draws(3, cfg_j, T)
    got = twalk.simulate_trajectories(cfg_t, draws)
    want = jwalk.simulate_trajectories(jax.random.PRNGKey(3), cfg_j, T)
    assert sorted(got) == sorted(want)
    for k in ("fixed_id", "exchange", "space"):
        _eq(got[k], want[k])
    np.testing.assert_allclose(got["pos"].numpy(), np.asarray(want["pos"]),
                               atol=1e-6, rtol=0)
    # the eager reference step by step: bitwise
    state = jwalk.init_mobility(jax.random.PRNGKey(3), cfg_j)
    for t in range(T):
        state, info = jwalk.mobility_step(state, cfg_j)
        _eq(got["pos"][t], info["pos"])


def test_walk_colocation_properties():
    """The port's own draws: areas constant, ids consistent with spaces,
    an exchange every 3rd dwell step, positions in the unit square."""
    n, steps = 30, 120
    co = walk_colocation(5, n, steps, p_cross=0.1)
    assert co["fixed_id"].shape == co["exchange"].shape == (steps, n)
    assert co["pos"].shape == (steps, n, 2) and co["pos"].dtype == np.float32
    assert co["fixed_id"].dtype == np.int32 and co["area"].dtype == np.int32
    np.testing.assert_array_equal(co["area"], np.arange(n) % 2)
    np.testing.assert_array_equal(co["init_area"], co["area"])
    assert ((co["init_space"] >= 0) & (co["init_space"] < 4)).all()
    assert ((co["pos"] >= 0) & (co["pos"] <= 1)).all()
    sid = twalk.space_of(torch.tensor(co["pos"]), 0.42).numpy()
    want_fid = np.where(sid >= 0, co["area"][None] * 4 + sid, -1)
    np.testing.assert_array_equal(co["fixed_id"], want_fid)
    # dwell from the ids (it starts at 0, so step 0 counts 1 either way):
    # an exchange exactly at every 3rd consecutive step in a space
    dwell, prev = np.zeros(n, int), np.full(n, -2)
    for t in range(steps):
        here = co["fixed_id"][t]
        dwell = np.where((here == prev) & (here >= 0), dwell + 1,
                         (here >= 0).astype(int))
        np.testing.assert_array_equal(co["exchange"][t],
                                      (dwell > 0) & (dwell % 3 == 0))
        prev = here
    assert co["exchange"].any() and (co["fixed_id"] < 0).any()
    again = walk_colocation(5, n, steps, p_cross=0.1)
    for k in co:
        np.testing.assert_array_equal(again[k], co[k])


def test_random_walk_scenario_is_registered():
    spec = get_scenario("random_walk")
    assert (spec.mode, spec.dist, spec.task, spec.n_fixed) == \
        ("fixed", "dir0.01", "image", 8)
    co = spec.colocation(1, 10, 30)
    np.testing.assert_array_equal(co["pos"], walk_colocation(1, 10, 30)["pos"])
