"""The port's tooling (``repro_torch.launch``: dtypes, roofline,
cost_analysis, autotune, dryrun, report) against the JAX package's
``repro.launch`` at small sizes.

The reference reads compiled HLO; the port counts ops as they run. Where
both count the same work (a lone matmul, batched matmul or convolution, the
engine's ``mlmule`` replay) the FLOPs must agree; the port's bytes are
eager PyTorch's and are held to the reference only for a lone matmul.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import INPUT_SHAPES as JAX_INPUT_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import autotune as jtune  # noqa: E402
from repro.launch import report as jreport  # noqa: E402
from repro.launch.dtypes import DTYPE_BYTES as JAX_DTYPE_BYTES  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.launch.roofline import collective_bytes  # noqa: E402
from repro.launch.roofline import model_flops_for as jax_model_flops  # noqa: E402
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES,  # noqa: E402
                                 InputShape, get_config, get_smoke_config)
from repro_torch.core.distributed import DistributedConfig, ordered_psum_op  # noqa: E402
from repro_torch.core.population import PopulationConfig  # noqa: E402
from repro_torch.launch import autotune, dryrun, report, roofline  # noqa: E402
from repro_torch.launch.cost_analysis import CostCounter  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.dtypes import (TORCH_DTYPE_NAMES,  # noqa: E402
                                       UnknownDtypeError, dtype_bytes)
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.scenarios import engine  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_cache():
    # both lookups memoize the default cache; tests repoint their env vars
    autotune.tuning_cache_clear()
    jtune.tuning_cache_clear()
    yield
    autotune.tuning_cache_clear()
    jtune.tuning_cache_clear()


# ---------------------------------------------------------------------------
# dtypes, model FLOPs
# ---------------------------------------------------------------------------


def test_dtype_bytes_match_the_reference():
    names = {v: k for k, v in TORCH_DTYPE_NAMES.items()}
    shared = [n for n in JAX_DTYPE_BYTES if n in names]
    assert len(shared) >= 15
    for name in shared:
        assert dtype_bytes(names[name]) == JAX_DTYPE_BYTES[name], name
        assert dtype_bytes(name) == JAX_DTYPE_BYTES[name], name
        assert dtype_bytes(names[name]) == names[name].itemsize, name
    for unknown in (torch.quint8, "f7"):
        with pytest.raises(UnknownDtypeError):
            dtype_bytes(unknown)
    seen = set()
    assert dtype_bytes(torch.quint8, collect=seen) == 4
    assert seen == {torch.quint8}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_the_reference(arch):
    assert tuple(ARCH_IDS) == tuple(JAX_ARCH_IDS)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.active_param_count() == jcfg.active_param_count()
    for name, shape in INPUT_SHAPES.items():
        assert roofline.model_flops_for(cfg, shape) == jax_model_flops(
            jcfg, JAX_INPUT_SHAPES[name])


# ---------------------------------------------------------------------------
# the count against the reference's HLO analysis
# ---------------------------------------------------------------------------


def _hlo_costs(fn, *xs):
    return analyze_hlo(jax.jit(fn).lower(*xs).compile().as_text())


def _count(fn, *xs):
    with CostCounter() as cc:
        fn(*xs)
    return cc


def test_matmul_flops_and_bytes_match_hlo():
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=s).astype(np.float32) for s in ((64, 32),
                                                            (32, 16)))
    ref = _hlo_costs(jnp.dot, jnp.asarray(a), jnp.asarray(b))
    cc = _count(torch.mm, torch.tensor(a), torch.tensor(b))
    assert cc.flops == ref.flops == 2 * 64 * 32 * 16
    assert cc.bytes == ref.bytes
    assert cc.flops_by == {"mm:f32": cc.flops}


def test_bmm_and_conv_flops_match_hlo():
    rng = np.random.default_rng(1)
    x, y = (rng.normal(size=s).astype(np.float32) for s in ((4, 64, 32),
                                                            (4, 32, 16)))
    ref = _hlo_costs(lambda p, q: jnp.einsum("bij,bjk->bik", p, q),
                     jnp.asarray(x), jnp.asarray(y))
    assert _count(torch.bmm, torch.tensor(x), torch.tensor(y)).flops == \
        ref.flops
    img = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 8)).astype(np.float32)     # HWIO
    ref = _hlo_costs(lambda p, q: jax.lax.conv_general_dilated(
        p, q, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC")),
        jnp.asarray(img), jnp.asarray(w))
    cc = _count(torch.nn.functional.conv2d,
                torch.tensor(img).permute(0, 3, 1, 2),
                torch.tensor(w).permute(3, 2, 0, 1))
    assert cc.flops == ref.flops
    assert cc.flops_by == {"conv:f32": ref.flops}


def test_ordered_psum_collective_bytes_are_exact():
    n = 1000
    with CostCounter() as cc:
        ordered_psum_op(torch.empty(n, device="meta"), 4, 0)
    hlo = (f"%ar = f32[{n}]{{0}} all-reduce(f32[{n}]{{0}} %p), "
           f"replica_groups={{}}, to_apply=%add")
    assert cc.coll["all-reduce"] == 4 * n == collective_bytes(hlo)[
        "all-reduce"]
    assert cc.coll_bytes == 4 * n


def _reference_workload(n_mules, steps):
    """The reference's workload as numpy, for injection into the port's."""
    from repro.launch.autotune import _engine_workload
    pop, co, _, _, _ = _engine_workload(n_mules, steps)
    X = np.asarray(jax.random.normal(jax.random.PRNGKey(50), (n_mules, 12, 5)))
    Y = np.asarray(jax.random.normal(jax.random.PRNGKey(60), (n_mules, 12)))
    return {"X": X, "Y": Y,
            "mule_w": np.asarray(pop["mule_models"]["w"]),
            "fixed_w": np.asarray(pop["fixed_models"]["w"]),
            "colocation": {k: np.asarray(v) for k, v in co.items()}}


def test_engine_step_flops_against_the_reference():
    data = _reference_workload(32, 6)
    ref = {m: jtune.analyze_engine_step(m, 32, 6) for m in ("mlmule",
                                                            "gossip")}
    got = {m: autotune.analyze_engine_step(m, 32, 6, device="cpu",
                                           data=data)
           for m in ("mlmule", "gossip")}
    want = ref["mlmule"]["flops_per_device"]
    assert abs(got["mlmule"]["flops_per_device"] - want) <= 0.01 * want
    assert got["mlmule"]["kernels"] == {"mule_agg": 6}
    # gossip: the reference's HLO multiplies the dense [M, M] encounter
    # matrix into W at every step (both branches of its exchange cond);
    # the port's kernel does one multiply-add per met pair at the
    # exchanges only, so its count is at most the reference's
    assert 0 < got["gossip"]["flops_per_device"] <= \
        ref["gossip"]["flops_per_device"]
    assert got["gossip"]["kernels"] == {"encounter_mix": 2}
    for row in got.values():
        assert row["dominant"] in ("compute", "memory", "collective")
        assert row["t_collective_s"] == 0.0


def test_engine_step_same_on_meta_and_cpu():
    rows = [autotune.analyze_engine_step("mlmule", 16, 3, device=dev)
            for dev in ("cpu", "meta")]
    assert rows[0]["flops_per_device"] == rows[1]["flops_per_device"] > 0
    assert rows[0]["bytes_per_device"] == rows[1]["bytes_per_device"] > 0


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "zamba2-2.7b",
                                  "xlstm-350m", "granite-moe-1b-a400m",
                                  "whisper-base", "qwen2-vl-72b"])
def test_train_step_same_on_meta_and_cpu(arch):
    model = build_model(get_smoke_config(arch))
    shape = InputShape("train", 32, 2, "train")
    counts = []
    for dev in ("cpu", "meta"):
        params = (model.init(torch.Generator().manual_seed(0))
                  if dev == "cpu" else dryrun.meta_params(model))
        batch = model.input_specs(shape, device=dev)
        opt = adam(1e-4)
        state = opt.init(params)
        with CostCounter() as cc:
            cc.hold(params, state, batch)
            make_train_step(model, opt)(params, state, batch)
        counts.append(cc)
    cpu, meta = counts
    assert cpu.flops == meta.flops > 0
    assert cpu.kernels == meta.kernels and cpu.kernels
    assert cpu.peak_live_bytes == meta.peak_live_bytes > 0
    if arch != "zamba2-2.7b":
        assert cpu.bytes == meta.bytes
        return
    # the SSD scan's plain version (the CPU route) returns a strided y,
    # which mamba2's reshape copies; the kernel and the meta route return
    # it contiguous: that one clone a layer is the only difference
    diff = {k for k in set(cpu.by_op) | set(meta.by_op)
            if cpu.by_op.get(k) != meta.by_op.get(k)}
    assert diff == {"aten::clone"}
    assert cpu.by_op["aten::clone"][0] - meta.by_op["aten::clone"][0] == \
        cpu.kernels["ssd_scan"]


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------


def _cache(tmp_path, name="cache.json"):
    payload = {
        "bench": "synthetic", "config": {},
        "roofline": [
            {"method": "mlmule", "mesh": "1x4", "n_mules": 64,
             "t_collective_us_per_step": 5.0, "t_memory_us_per_step": 1.0},
            {"method": "mlmule", "mesh": "2x2", "n_mules": 64,
             "t_collective_us_per_step": 1.0, "t_memory_us_per_step": 1.0},
            {"method": "mlmule", "mesh": "2x2", "n_mules": 1024,
             "t_collective_us_per_step": 9.0, "t_memory_us_per_step": 9.0},
            {"method": "gossip", "mesh": "4x1", "n_mules": 64,
             "t_collective_us_per_step": 0.1, "t_memory_us_per_step": 0.1},
            {"method": "local", "mesh": "1", "n_mules": 32}],
        "tuned": {
            "mule_agg": [
                {"f": 8, "m": 256, "d": 4096, "block_d": 512, "waves": 2.0},
                {"f": 8, "m": 256, "d": 546484, "block_d": 2048,
                 "waves": 0.5}],
            "encounter_mix": [
                {"m": 512, "d": 480, "block_m": 128, "block_d": 256,
                 "shape": "small", "dense_min": 16},
                {"m": 4096, "d": 480, "block_m": 512, "block_d": 1024,
                 "shape": "big", "dense_min": 4}],
            "encounter_hop": [{"r": 64, "d": 546484, "shape": "big",
                               "dense_min": 32}]},
        "tuned_speedup_vs_default": 1.0}
    path = tmp_path / name
    path.write_text(json.dumps(payload))
    return path


def _point_both(monkeypatch, value):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", value)
    monkeypatch.setenv("REPRO_TUNE_CACHE", value)
    autotune.tuning_cache_clear()
    jtune.tuning_cache_clear()


def test_cache_lookups_agree_with_the_reference(tmp_path, monkeypatch):
    _point_both(monkeypatch, str(_cache(tmp_path)))
    cache = autotune.load_tuning_cache()
    assert cache == jtune.load_tuning_cache()
    for entries, queries in (
            (cache["tuned"]["mule_agg"], [{"d": 4000}, {"d": 1 << 19},
                                          {"d": 60000}]),
            (cache["tuned"]["encounter_mix"],
             [{"m": 600, "d": 480}, {"m": 3000, "d": 480}]),
            (cache["roofline"], [{"n_mules": 70}, {"n_mules": 900}])):
        for q in queries:
            assert autotune._nearest(entries, q) is jtune._nearest(entries,
                                                                   q)
    # the lookups pick the entry the reference's picks: its block_d, the
    # port's waves, from one entry
    for d in (4000, 1 << 19):
        e = next(x for x in cache["tuned"]["mule_agg"]
                 if x["block_d"] == jtune.tuned_block_d(d))
        assert autotune.tuned_mule_agg_waves(8, 256, d) == e["waves"]
    for m in (600, 3000):
        e = next(x for x in cache["tuned"]["encounter_mix"]
                 if (x["block_m"], x["block_d"])
                 == jtune.tuned_encounter_blocks(m, 480))
        assert autotune.tuned_encounter_launch(m, 480) == (e["shape"],
                                                           e["dense_min"])
    assert autotune.tuned_hop_launch(60, 500_000) == ("big", 32)
    for method, n in (("mlmule", 64), ("mlmule", 1000), ("gossip", 64),
                      ("oppcl", 64)):
        assert autotune.suggest_mesh_shape(method, n) == \
            jtune.suggest_mesh_shape(method, n)
    assert autotune.suggest_mesh_shape("mlmule", 64) == (2, 2)


def test_cache_fallbacks_agree_with_the_reference(tmp_path, monkeypatch):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    schema = tmp_path / "schema.json"
    schema.write_text(json.dumps({"tuned": "oops"}))
    for value in ("", str(tmp_path / "absent.json"), str(bad), str(schema)):
        _point_both(monkeypatch, value)
        assert autotune.load_tuning_cache() is None
        assert jtune.load_tuning_cache() is None
        assert jtune.tuned_block_d(4096) == jtune.MULE_AGG_DEFAULT_BLOCK_D
        assert autotune.tuned_mule_agg_waves(8, 256, 4096) is None
        assert autotune.tuned_encounter_launch(256, 480) == (None, None)
        assert autotune.suggest_mesh_shape("mlmule", 64) is None
        assert jtune.suggest_mesh_shape("mlmule", 64) is None


def test_no_cache_means_the_hand_picks(monkeypatch):
    from repro_torch.kernels.encounter_mix import ops as enc
    from repro_torch.kernels.mule_agg import ops as agg
    _point_both(monkeypatch, "")
    assert agg.grid_blocks(8, 256, 546_484, torch.float32,
                           torch.device("cpu")) == 0
    for rows in (64, 256):
        assert enc.launch_choice(rows, 546_484, hop=rows == 64) == (
            0, enc.DENSE_PAIRS_PER_ROW)
    with autotune.forced(enc, SUMS_SHAPE="big", DENSE_MIN=32):
        assert enc.launch_choice(64, 100, hop=True) == (2, 32)
    assert enc.launch_choice(64, 100, hop=True) == (0, 8)


def test_committed_cache_parses_and_was_written_on_the_card():
    cache = autotune.load_tuning_cache(str(autotune.DEFAULT_CACHE_PATH))
    assert cache is not None, "the committed tuning_cache.json must parse"
    assert "H100" in cache["card"] and " W" in cache["card"]
    for kernel in ("mule_agg", "encounter_mix", "encounter_hop"):
        for e in cache["tuned"][kernel]:
            assert e["card"] == cache["card"]
            assert e["ms"] <= e["default_ms"]
            assert e["speedup_vs_default"] >= 1.0
    assert {tuple(map(int, r["mesh"].split("x"))) for r in cache["roofline"]
            if "x" in r["mesh"]} == set(autotune.MESHES)


def test_auto_mesh_takes_a_fitting_suggestion(tmp_path, monkeypatch):
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    made = []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(mesh_lib, "make_mule_mesh",
                        lambda pod, data, **kw: made.append((pod, data)))
    dcfg = DistributedConfig(pop=PopulationConfig(n_mules=64))
    _point_both(monkeypatch, str(_cache(tmp_path)))
    engine._auto_mesh("mlmule", 64, dcfg)       # cache: 2 x 2 fits
    engine._auto_mesh("mlmule", 65, dcfg)       # 65 % 2 != 0: fallback
    engine._auto_mesh("gossip", 64, dcfg)       # 4 x 1: 4 pods fit
    engine._auto_mesh("gossip", 64,             # no pod axis: fallback
                      DistributedConfig(pop=PopulationConfig(n_mules=64),
                                        pod_axis=""))
    _point_both(monkeypatch, "")
    engine._auto_mesh("mlmule", 64, dcfg)       # no cache: fallback
    assert made == [(2, 2), (4, 1), (4, 1), (1, 4), (1, 4)]


def test_auto_mesh_ignores_a_suggestion_that_does_not_fit(tmp_path,
                                                          monkeypatch):
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    made = []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 8)
    monkeypatch.setattr(mesh_lib, "make_mule_mesh",
                        lambda pod, data, **kw: made.append((pod, data)))
    _point_both(monkeypatch, str(_cache(tmp_path)))
    # the cache's 2 x 2 has 4 ranks, the world 8: the fallback's 1 x 8
    engine._auto_mesh("mlmule", 64,
                      DistributedConfig(pop=PopulationConfig(n_mules=64)))
    assert made == [(1, 8)]


# ---------------------------------------------------------------------------
# the dry run and the report
# ---------------------------------------------------------------------------

SMALL_SHAPES = {
    "train_4k": InputShape("train_4k", 64, 2, "train"),
    "prefill_32k": InputShape("prefill_32k", 128, 2, "prefill"),
    "decode_32k": InputShape("decode_32k", 128, 2, "decode"),
    "long_500k": InputShape("long_500k", 256, 1, "decode"),
}


def _reference_skip_reason():
    """The reference's ``skip_reason``; its module sets XLA_FLAGS when
    imported, which this process's initialized backend ignores and the
    rest of the process must not see."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import skip_reason
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return skip_reason


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dry_run_smoke_configs(arch):
    jax_skip = _reference_skip_reason()
    rows = dryrun.dryrun([arch], SMALL_SHAPES, smoke=True, verbose=False)
    assert len(rows) == len(SMALL_SHAPES)
    for row, shape in zip(rows, SMALL_SHAPES.values()):
        want = jax_skip(jax_get_config(arch), JAX_INPUT_SHAPES[shape.name],
                        False)
        if want is not None:
            assert row == {"arch": arch, "shape": shape.name, "mesh": "1",
                           "status": "skip", "reason": want}
            continue
        assert row["status"] == "ok", row
        assert row["flops_per_device"] > 0 and row["bytes_per_device"] > 0
        assert row["peak_memory_gb"] > 0 and row["fits_one_card"]
        assert row["t_collective_s"] == 0.0
        assert row["model_flops"] == roofline.model_flops_for(
            get_smoke_config(arch), shape)
        # the forward's attention is the kernel; decode's is the plain
        # cache update, as in the reference
        if shape.kind != "decode" and get_smoke_config(arch).family not in (
                "ssm", "xlstm"):
            assert row["kernels"].get("flash_attention", 0) > 0


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "granite-moe-1b-a400m",
                                  "zamba2-2.7b"])
def test_dry_run_remat_rows(arch):
    """``--remat`` recomputes each layer's forward in the backward: the
    rows say which policy ran, the kernels of the forward run twice, the
    count's FLOPs rise (the "dots" policy keeps the ``x @ w`` products, so
    by less) and the peak does not rise."""
    shape = {"train_4k": SMALL_SHAPES["train_4k"]}
    plain, full, dots = (dryrun.dryrun([arch], shape, smoke=True,
                                       verbose=False, remat=r,
                                       remat_policy=p)[0]
                         for r, p in ((False, "full"), (True, "full"),
                                      (True, "dots")))
    assert (plain["remat"], full["remat"], dots["remat"]) == \
        (None, "full", "dots")
    assert plain["flops_per_device"] < dots["flops_per_device"] < \
        full["flops_per_device"]
    assert full["kernels"] == dots["kernels"] == {
        k: 2 * v for k, v in plain["kernels"].items()}
    assert full["peak_memory_gb"] <= plain["peak_memory_gb"]
    assert dots["peak_memory_gb"] <= plain["peak_memory_gb"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dry_run_production_rows_of_the_smoke_configs(arch):
    """Rank 0 of the 16 x 16 and 2 x 16 x 16 production meshes, with and
    without FSDP: every row the reference does not skip is ``ok``, priced
    over the link between DGX nodes, with the rank's parameter blocks and
    its collectives by kind. zamba2's smoke config has 8 SSM heads of 32,
    which 16 ``model`` ranks split inside a head (256 channels divide): the
    rank scans its 16 channels as one sub-head of 16 (``models/mamba2.py``),
    and its decode cache holds that sub-head."""
    jax_skip = _reference_skip_reason()
    held = {}
    for fsdp in (False, True):
        rows = dryrun.dryrun([arch], SMALL_SHAPES, ("single", "multi"),
                             smoke=True, verbose=False, fsdp=fsdp,
                             remat=True)
        assert len(rows) == 2 * len(SMALL_SHAPES)
        for row in rows:
            shape = SMALL_SHAPES[row["shape"]]
            want = jax_skip(jax_get_config(arch),
                            JAX_INPUT_SHAPES[shape.name], False)
            if want is not None:
                assert row["status"] == "skip" and row["reason"] == want
                continue
            assert row["status"] == "ok", row
            assert row["chips"] == (256 if row["mesh"] == "single" else 512)
            assert row["link"] == "ib" and row["fsdp"] == fsdp
            assert row["param_bytes_per_device"] > 0
            assert row["t_collective_s"] == row["coll_bytes_per_device"] / \
                roofline.IB_LINK_BYTES_PER_S
            if shape.kind == "train":       # the mean over data at least
                assert row["coll_breakdown"].get("all-reduce", 0) > 0
            held.setdefault((row["shape"], row["mesh"]), set()).add(
                row["param_bytes_per_device"])
    # no smoke dimension reaches the FSDP rule's 1024: FSDP cuts nothing
    assert all(len(v) == 1 for v in held.values())
    if arch == "zamba2-2.7b":
        model = build_model(get_smoke_config(arch),
                            mesh=make_production_mesh())
        cache = model.init_cache(2, 16, device="meta")
        ssm = [c["ssm"].shape for c in cache if "ssm" in c]
        assert ssm and all(tuple(x[-3:]) == (1, 16, 16) for x in ssm), ssm


def test_dry_run_zamba2_at_tp_32_splits_its_mixer_inside_heads():
    """zamba2-2.7b on rank 0 of the 8 x 32 production mesh (``--tp 32``):
    80 SSM heads of 64 do not divide 32 ranks, 5,120 channels do, so a
    rank holds 160 channels and scans them as 5 sub-heads of 32 (one
    ``ssd_scan`` launch a Mamba2 layer), its decode cache holding those
    sub-heads; the row is ``ok`` with every layer's kernel counted."""
    shape = INPUT_SHAPES["prefill_32k"]
    row = dryrun.dryrun_one("zamba2-2.7b", shape, mesh="single", tp=32,
                            verbose=False)
    assert row["status"] == "ok" and row["tp"] == 32, row
    assert row["kernels"] == {"ssd_scan": 45, "flash_attention": 9}
    assert row["coll_breakdown"]["all-reduce"] > 0
    model = build_model(get_config("zamba2-2.7b"),
                        mesh=make_production_mesh(model_parallel=32))
    ssm = model.init_cache(4, 16, device="meta")[0]["ssm"]
    assert tuple(ssm.shape[-3:]) == (5, 32, 64)


def test_dry_run_counts_a_rank_without_a_process_group(monkeypatch):
    """The production row's collectives are custom ops whose shape rules
    move nothing on ``meta``: the count runs with ``torch.distributed``
    uninitialised and every transfer of it raising, and still prices the
    tensor-parallel sums, the experts' all-to-all and the gradients' mean
    by kind."""
    import torch.distributed as dist
    assert not dist.is_initialized()

    def refuse(*args, **kwargs):
        raise AssertionError("a count called torch.distributed")
    for name in ("all_gather", "all_reduce", "all_to_all_single",
                 "batch_isend_irecv", "isend", "irecv", "new_group",
                 "get_rank", "get_world_size", "barrier"):
        monkeypatch.setattr(dist, name, refuse)
    shape = SMALL_SHAPES["train_4k"]
    for fsdp in (False, True):
        row = dryrun.dryrun_one("granite-moe-1b-a400m", shape, smoke=True,
                                mesh="single", fsdp=fsdp, remat=True,
                                verbose=False)
        assert row["status"] == "ok"
        kinds = set(row["coll_breakdown"])
        assert {"all-reduce", "all-gather"} <= kinds
    row = dryrun.dryrun_one("granite-moe-1b-a400m", shape, mesh="single",
                            remat=True, verbose=False)
    assert row["status"] == "ok" and row["coll_breakdown"]["all-to-all"] > 0


def test_report_tables_match_the_reference():
    rows = [
        {"arch": "gemma3-4b", "shape": "train_4k", "mesh": "1",
         "status": "ok", "dominant": "compute", "t_compute_s": 1.5,
         "t_memory_s": 0.0123, "t_collective_s": 0.0,
         "peak_memory_gb": 71.23, "useful_flops_ratio": 0.8712},
        {"arch": "stablelm-1.6b", "shape": "long_500k", "mesh": "1",
         "status": "skip", "reason": "full-attention arch"},
        {"arch": "granite-34b", "shape": "decode_32k", "mesh": "1",
         "status": "FAIL", "error": "ValueError: x"}]
    assert report.roofline_table(rows) == jreport.roofline_table(rows)
    assert report.skip_table(rows) == jreport.skip_table(rows)
    status = report.status_table(rows)
    assert "**FAIL** ValueError: x" in status and "| ok |" in status


def test_work_bounds_match_the_kernel_formulas():
    w = roofline.mule_agg_work(8, 256, 546_484)
    assert w.n_bytes == 4 * (8 * 256 + 256 * 546_484 + 8 * 546_484)
    assert w.bound_by == "bytes"
    assert w.bound_ms == w.n_bytes / roofline.HBM_BYTES_PER_S * 1e3
    f = roofline.flash_attention_work(2, 4096, 4096, 8, 4, 256, True, None,
                                      torch.bfloat16)
    assert f.kind == "mm:bf16" and f.bound_by == "operations"
    assert f.n_flop == 4 * 256 * 2 * 8 * (4096 * 4097 // 2)
    assert roofline.flop_rate("conv:f32", tf32_conv=True) == \
        roofline.TF32_TENSOR_FLOP_PER_S
    assert roofline.flop_rate("mm:f32", tf32_matmul=False) == \
        roofline.FP32_FLOP_PER_S
    assert roofline.host_link_bytes_per_s(5, 16) == pytest.approx(63.015e9,
                                                                  rel=1e-4)
