"""Port's numpy data, partitions, traces and registry against the JAX
package: bitwise for the same seed (both draw from np.random.default_rng)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.data as jdata  # noqa: E402
import repro.data.partition as jpart  # noqa: E402
import repro.mobility as jmob  # noqa: E402
import repro.scenarios as jsc  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
import repro_torch.mobility as tmob  # noqa: E402
import repro_torch.scenarios as tsc  # noqa: E402

torch.set_num_threads(1)


def _assert_same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_image_dataset_bitwise(seed):
    kw = dict(n_per_sub=3, n_super=6, n_sub=5, size=8, noise=0.7)
    _assert_same(tdata.make_image_dataset(seed, **kw),
                 jdata.make_image_dataset(seed, **kw))


def test_partitions_bitwise():
    _, sup, sub = jdata.make_image_dataset(1, n_per_sub=4, n_super=8, size=8)
    _assert_same(tdata.iid_partition(sup, 5, seed=2),
                 jdata.iid_partition(sup, 5, seed=2))
    for alpha in (0.01, 0.5):
        _assert_same(tdata.dirichlet_partition(sup, 6, alpha, seed=3),
                     jdata.dirichlet_partition(sup, 6, alpha, seed=3))
    for n_areas in (2, 3):
        t = tdata.shards_partition(sup, sub, n_areas=n_areas, seed=4)
        j = jdata.shards_partition(sup, sub, n_areas=n_areas, seed=4)
        for part in ("space_idx", "general_idx"):
            assert sorted(t[part]) == sorted(j[part])
            for k in t[part]:
                _assert_same(t[part][k], j[part][k])
        assert t["area_supers"] == j["area_supers"]
    idx = np.arange(37)
    _assert_same(tdata.train_test_split(idx, 0.2, seed=5),
                 jpart.train_test_split(idx, 0.2, seed=5))


TRACES = {
    "foursquare": lambda m, s: m.synth_foursquare_trace(s, 12, 8, 300),
    "commuter": lambda m, s: m.commuter_trace(s, 10, 8, 450, period=100),
    "shift_worker": lambda m, s: m.shift_worker_trace(s, 9, 8, 500),
    "event_crowd": lambda m, s: m.event_crowd_trace(s, 15, 8, 400),
    "markov_mask": lambda m, s: m.markov_churn_mask(s, 120, 11),
    "flash_mask": lambda m, s: m.flash_churn_mask(s, 200, 11),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_trace_generators_bitwise(name):
    for seed in (0, 5):
        _assert_same(TRACES[name](tmob, seed), TRACES[name](jmob, seed))


@pytest.mark.parametrize("cadence", [3, np.array([1, 2, 4, 8, 3, 6, 2, 5])])
def test_trace_to_colocation_bitwise(cadence):
    visits = jmob.commuter_trace(1, 10, 8, 300, period=60, commute=2)
    _assert_same(tmob.trace_to_colocation(visits, 10, 300, cadence),
                 jmob.trace_to_colocation(visits, 10, 300, cadence))
    fid, _ = jmob.trace_to_colocation(visits, 10, 300)
    _assert_same(tmob.dwell_exchange_flags(fid, cadence),
                 jmob.dwell_exchange_flags(fid, cadence))


PORTED = ["commuter", "commuter_churn", "event_crowd", "event_crowd_flash",
          "foursquare_sparse", "mixed_cadence", "shift_worker"]


def test_registry_holds_the_ported_scenarios():
    assert tsc.list_scenarios() == PORTED
    for name in set(jsc.list_scenarios()) - set(PORTED):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tsc.get_scenario(name)
    with pytest.raises(ValueError, match="unknown scenario"):
        tsc.get_scenario("no_such_scenario")


@pytest.mark.parametrize("name", PORTED)
def test_registry_colocation_bitwise(name):
    t, j = tsc.get_scenario(name), jsc.get_scenario(name)
    assert (t.mode, t.dist, t.task, t.n_fixed) == (j.mode, j.dist, j.task,
                                                   j.n_fixed)
    _assert_same(t.colocation(2, 9, 260), j.colocation(2, 9, 260))


def test_image_data_mobile_matches_the_harness():
    """The experiment module's per-mule Shards layout equals
    benchmarks/common.py's."""
    from benchmarks.common import ExperimentConfig, _image_data_mobile
    from repro_torch.experiment import image_data_mobile
    co = jsc.get_scenario("commuter").colocation(0, 10, 50)
    cfg = ExperimentConfig(mode="mobile", n_mules=10, n_fixed=8, seed=3,
                           image_size=8, n_per_sub=4)
    want = _image_data_mobile(cfg, co["init_space"], co["init_area"])
    got = image_data_mobile(3, 10, 8, co["init_space"], co["init_area"],
                            n_per_sub=4, image_size=8, device="cpu")
    _assert_same([g.numpy() for g in got], [np.asarray(w) for w in want])
