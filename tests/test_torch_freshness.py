"""Port's exact freshness ring against the JAX package.

Counts, ring slots and acceptance are compared exactly: the port must put
every delivered age in the slot the reference's sequential scan gives it,
including steps where more than ``history`` mules deliver to one device.
Thresholds are float32 EMAs of the same ages; they are compared exactly
too, since one ulp would flip a later ``ages <= threshold`` decision.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import freshness as jf  # noqa: E402
from repro_torch.core import freshness as tf  # noqa: E402

torch.set_num_threads(1)


def _to_torch(state):
    return {k: torch.tensor(np.asarray(v)) for k, v in state.items()}


def _assert_state_equal(port, ref):
    for k in ("ages", "count", "threshold"):
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


def _step_inputs(rng, n_mules, n_fixed, t):
    fid = rng.integers(-1, n_fixed, n_mules).astype(np.int32)
    ages = (t - rng.integers(0, t + 1, n_mules)).astype(np.float32)
    deliver = rng.uniform(size=n_mules) < 0.7
    return fid, ages, deliver


@pytest.mark.parametrize("history,n_mules,n_fixed", [
    (16, 12, 3), (4, 9, 2), (5, 30, 1), (16, 40, 2)])
def test_push_and_update_matches_jax_over_steps(history, n_mules, n_fixed):
    """Several chained steps; the small rings wrap and overflow."""
    cfg_j = jf.FreshnessConfig(history=history)
    cfg_t = tf.FreshnessConfig(history=history)
    ref = jf.init_freshness(n_fixed, cfg_j)
    port = tf.init_freshness(n_fixed, cfg_t, "cpu")
    _assert_state_equal(port, ref)
    rng = np.random.default_rng(history * 100 + n_mules)
    for t in range(1, 9):
        fid, ages, deliver = _step_inputs(rng, n_mules, n_fixed, t)
        ref = jf.push_and_update(ref, jnp.asarray(fid), jnp.asarray(ages),
                                 jnp.asarray(deliver), cfg_j)
        port = tf.push_and_update(port, torch.from_numpy(fid).long(),
                                  torch.from_numpy(ages),
                                  torch.from_numpy(deliver), cfg_t)
        _assert_state_equal(port, ref)


@pytest.mark.parametrize("n_deliver", [5, 16, 17, 23, 32, 33])
def test_more_deliveries_than_history_to_one_device(n_deliver):
    """Even and odd delivery counts around and past the ring length, onto
    a ring that already holds a few receipts."""
    cfg_j, cfg_t = jf.FreshnessConfig(), tf.FreshnessConfig()
    ref = jf.init_freshness(3, cfg_j)
    ref = {**ref, "count": jnp.asarray([5, 0, 2], jnp.int32)}
    port = _to_torch(ref)
    n = n_deliver + 4
    fid = np.full(n, 1, np.int32)
    fid[::5] = 2                                     # some to another device
    fid[-1] = -1                                     # and one in a corridor
    ages = np.arange(n, dtype=np.float32) * 1.5
    deliver = np.ones(n, bool)
    ref = jf.push_and_update(ref, jnp.asarray(fid), jnp.asarray(ages),
                             jnp.asarray(deliver), cfg_j)
    port = tf.push_and_update(port, torch.from_numpy(fid).long(),
                              torch.from_numpy(ages),
                              torch.from_numpy(deliver), cfg_t)
    _assert_state_equal(port, ref)


@pytest.mark.parametrize("n_valid", range(0, 9))
def test_masked_median_matches_jax(n_valid):
    """Even and odd counts of filled ring slots (midpoint for even)."""
    rng = np.random.default_rng(n_valid)
    vals = rng.uniform(0, 50, size=(3, 8)).astype(np.float32)
    valid = np.zeros((3, 8), bool)
    for r in range(3):
        valid[r, rng.permutation(8)[:n_valid]] = True
    want = jf._masked_median(jnp.asarray(vals), jnp.asarray(valid))
    got = tf._masked_median(torch.from_numpy(vals), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_accept_mask_matches_jax():
    cfg_j, cfg_t = jf.FreshnessConfig(), tf.FreshnessConfig()
    rng = np.random.default_rng(7)
    state = {"ages": np.full((4, 16), jf.INF, np.float32),
             "count": rng.integers(0, 8, 4).astype(np.int32),
             "threshold": rng.uniform(2, 12, 4).astype(np.float32)}
    fid = rng.integers(-1, 4, 40).astype(np.int32)
    ages = rng.integers(0, 15, 40).astype(np.float32)
    ages[:4] = state["threshold"]                     # exact ties accept
    fid[:4] = np.arange(4)
    want = jf.accept_mask({k: jnp.asarray(v) for k, v in state.items()},
                          jnp.asarray(fid), jnp.asarray(ages), cfg_j)
    got = tf.accept_mask(_to_torch(state), torch.from_numpy(fid).long(),
                         torch.from_numpy(ages), cfg_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
