"""Port's sharding rules (``repro_torch.launch.sharding``) against the JAX
package's (``repro.launch.sharding``), and the blocks a rank holds.

``param_specs``, ``batch_specs`` and ``cache_specs`` must equal the
reference's ``PartitionSpec``s leaf for leaf (the port's spec is the plain
tuple of the reference's entries) for the ten LM configs, at full size and
at smoke size, on a (2, 2) and a (16, 16) mesh of ``("data", "model")``
and a (2, 16, 16) mesh with ``pod``, with ``fsdp`` and ``replicate`` on and
off. No 256 devices exist here, so both sides read a stand-in mesh with a
``shape`` and ``axis_names``, which is all the rules read of one. The
parameters are shapes only: ``jax.eval_shape`` of the reference's init and
the port's init on ``meta``; the caches likewise, at ``decode_32k``'s batch
(which divides the data axes) and ``long_500k``'s batch of one (which does
not, so the sequence axis takes the data axes). The config registry's two
other entries, the paper's CNNs, are not LMs: the rules read an LM
config's family, in the reference too.

``shard_of`` and ``rank_specs`` are checked on a one-process stand-in
mesh: the blocks tile the whole leaf in rank order, and a rank's
parameters (``lm_ranks.rank_params``) are ``param_specs``' blocks with
every fallback, the experts whole under ``moe_ep_axis=None`` and every
leaf whole under ``replicate``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import sharding as tsh  # noqa: E402
from repro_torch.launch.dryrun import meta_params  # noqa: E402
from repro_torch.launch.mesh import MuleMesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

MESHES = {"2x2": {"data": 2, "model": 2},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class _Mesh:
    """What the rules read of a mesh: its axis sizes and names."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@functools.lru_cache(maxsize=None)
def _models(arch, smoke):
    jcfg = (jconfigs.get_smoke_config if smoke else jconfigs.get_config)(arch)
    tcfg = (tconfigs.get_smoke_config if smoke else tconfigs.get_config)(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    return (jcfg, tcfg, jm, tm,
            jax.eval_shape(jm.init, jax.random.PRNGKey(0)), meta_params(tm))


def _ref_flat(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), tuple(spec)) for path, spec in flat]


def _port_flat(specs, path=()):
    """(name, spec) pairs in ``jax.tree`` order: dict keys sorted, lists in
    order; a tuple is a leaf (a spec)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs)
                for x in _port_flat(specs[k], path + (k,))]
    if isinstance(specs, list):
        return [x for i, v in enumerate(specs)
                for x in _port_flat(v, path + (i,))]
    return [("/".join(str(p) for p in path), specs)]


def _assert_same(port, ref):
    got, want = _port_flat(port), _ref_flat(ref)
    assert [n for n, _ in got] == [n for n, _ in want]
    bad = [(n, g, w) for (n, g), (_, w) in zip(got, want) if g != w]
    assert not bad, bad[:5]


ARCHS = list(tconfigs.ARCH_IDS)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_the_reference(arch, smoke, mesh_name):
    jcfg, tcfg, jm, tm, jshapes, tparams = _models(arch, smoke)
    mesh = _Mesh(MESHES[mesh_name])
    for fsdp in (False, True):
        for replicate in (False, True):
            _assert_same(
                tsh.param_specs(tcfg, tparams, mesh, fsdp=fsdp,
                                replicate=replicate),
                jsh.param_specs(jcfg, jshapes, mesh, fsdp=fsdp,
                                replicate=replicate))
    for shape in (tconfigs.INPUT_SHAPES["train_4k"],
                  tconfigs.InputShape("odd", 64, 3, "train")):
        for replicate in (False, True):
            got = tsh.batch_specs(tcfg, shape, mesh, replicate=replicate)
            want = jsh.batch_specs(jcfg, shape, mesh, replicate=replicate)
            assert got == {k: tuple(v) for k, v in want.items()}
    for name in ("decode_32k", "long_500k"):
        s = tconfigs.INPUT_SHAPES[name]
        b, seq = s.global_batch, 64 if smoke else s.seq_len
        _assert_same(
            tsh.cache_specs(tcfg, tm.init_cache(b, seq, device="meta"), b,
                            mesh),
            jsh.cache_specs(jcfg, jax.eval_shape(
                lambda: jm.init_cache(b, seq)), b, mesh))


def _rank_mesh(shape, coords):
    return MuleMesh(shape=dict(shape), coords=dict(coords), groups={},
                    data_axis=tuple(shape)[-1])


@pytest.mark.parametrize("spec", [(), ("data", None), (None, "model"),
                                  ("model", "data"), (("data", "model"),),
                                  (None, ("data", "model"))])
def test_blocks_tile_the_leaf_in_rank_order(spec):
    shape = {"data": 2, "model": 4}
    leaf = torch.arange(16 * 8).reshape(16, 8)
    blocks = {}
    for d in range(2):
        for m in range(4):
            mesh = _rank_mesh(shape, {"data": d, "model": m})
            blocks[d, m] = tsh.shard_of(leaf, spec, mesh)
    # the reference's layout: jax.sharding's blocks of the same spec
    devices = np.arange(8).reshape(2, 4)
    for (d, m), block in blocks.items():
        idx = [slice(None)] * 2
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            n, i = 1, 0
            for a in ("data", "model"):
                if a in axes:
                    n *= shape[a]
                    i = i * shape[a] + {"data": d, "model": m}[a]
            step = leaf.shape[dim] // n
            idx[dim] = slice(i * step, (i + 1) * step)
        assert torch.equal(block, leaf[tuple(idx)]), (d, m)
    assert devices.size == len(blocks)


@pytest.mark.parametrize("ep_axis", ["model", None])
def test_moe_specs_cut_only_the_experts(ep_axis):
    """``rank_specs``' ``/moe/`` leaves: the experts over ``model`` and the
    router whole (``param_specs``' own), or all whole with
    ``moe_ep_axis=None``; every other leaf is ``param_specs``' either way."""
    _, tcfg, _, tm, _, tparams = _models("granite-moe-1b-a400m", True)
    mesh = _rank_mesh({"data": 1, "model": 2}, {"data": 0, "model": 1})
    specs = dict(_port_flat(tsh.rank_specs(tcfg, tparams, mesh, ep_axis)))
    full = dict(_port_flat(tsh.param_specs(tcfg, tparams, _Mesh(
        {"data": 1, "model": 2}))))
    moe = {n for n in specs if "/moe/" in n}
    cut = {n for n in moe if specs[n]}
    if ep_axis is None:
        assert not cut
    else:
        assert sorted(cut) == sorted(n for n in moe
                                     if not n.endswith("router"))
        assert all(specs[n] == full[n] for n in cut)
    assert all(specs[n] == full[n] for n in specs if n not in moe)
    local = tsh.shard_tree(tparams, tsh.rank_specs(tcfg, tparams, mesh,
                                                   ep_axis), mesh)
    assert local["stages"][0]["moe"]["wi_gate"].shape[1] == (
        tcfg.n_experts // 2 if ep_axis else tcfg.n_experts)
    assert local["embed"].shape[0] == tcfg.vocab // 2


def _block_shape(shape, spec, mesh_shape):
    out = list(shape)
    for dim, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                out[dim] //= mesh_shape[axis]
    return tuple(out)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4), (4, 2)],
                         ids=["2x2", "1x4", "4x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_params_are_the_param_specs_blocks(arch, mesh_shape):
    """``lm_ranks.rank_params`` on the smoke config at every coordinate of
    a ``(data, model)`` mesh: each leaf is its ``param_specs`` block (with
    every fallback), the rank's slice of the whole leaf; with
    ``replicate`` every leaf is whole, and with ``moe_ep_axis=None`` the
    experts are. The decode cache is the rank's kv heads and SSM heads."""
    from repro_torch.interop import tree_leaves
    from repro_torch.launch.lm_ranks import rank_params
    _, tcfg, _, _, _, _ = _models(arch, True)
    whole = build_model(tcfg).init(torch.Generator().manual_seed(0))
    dp, mp = mesh_shape
    shape = {"data": dp, "model": mp}
    want_specs = _port_flat(tsh.param_specs(tcfg, whole, _Mesh(shape)))
    for d in range(dp):
        for m in range(mp):
            mesh = _rank_mesh(shape, {"data": d, "model": m})
            for kw in ({}, {"moe_ep_axis": None},
                       {"dp_axes": ("data", "model"), "moe_ep_axis": None}):
                model = build_model(tcfg, mesh=mesh, **kw)
                got = tree_leaves(rank_params(model, whole))
                layout = "model" in model.dp_axes
                for leaf, w, (name, spec) in zip(got, tree_leaves(whole),
                                                 want_specs):
                    if layout or (kw and "/moe/" in name):
                        spec = ()
                    assert tuple(leaf.shape) == _block_shape(
                        w.shape, spec, shape), (name, kw)
                    assert torch.equal(leaf, tsh.shard_of(w, spec, mesh))
            if tcfg.family == "audio":      # WhisperModel: held whole
                continue
            whole_cache = build_model(tcfg).init_cache(2, 8, device="cpu")
            # the population layout holds every leaf, and its cache, whole
            for kw in ({}, {"dp_axes": ("data", "model")}):
                model = build_model(tcfg, mesh=mesh, **kw)
                split = mp > 1 and not model.replicate and \
                    tcfg.family not in tsh.REPLICATED_ARCHS
                _check_rank_cache(tcfg, model, whole_cache, split, mp, m)


def _check_rank_cache(tcfg, model, whole_cache, split, mp, m):
    for stage, c, w in zip(model.program,
                           model.init_cache(2, 8, device="cpu"),
                           whole_cache):
        if stage.kind == "mamba":
            h = w["ssm"].shape[-3]
            n = mp if split and h % mp == 0 else 1
            assert c["ssm"].shape[-3] == h // n
            assert c["conv_x"].shape[-1] == w["conv_x"].shape[-1] // n
        elif stage.kind != "xlstm_pair":
            # kv heads over model where they divide (cache_specs'
            # block); else the ones the rank's query heads read
            kv = c["k"].shape[-2]
            if not split or tcfg.n_heads % mp:
                assert kv == tcfg.n_kv_heads
            elif tcfg.n_kv_heads % mp == 0:
                assert kv == tcfg.n_kv_heads // mp
            else:
                g = tcfg.n_heads // tcfg.n_kv_heads
                q0 = m * (tcfg.n_heads // mp)
                assert kv == len({h // g for h in range(
                    q0, q0 + tcfg.n_heads // mp)}) or \
                    kv == tcfg.n_heads // mp


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "xlstm-350m"])
def test_rank_batch_is_cut_along_the_models_batch_axes(arch, mesh_shape):
    """``lm_ranks.rank_batch(model, ...)`` reads the layout from the model:
    each rank's rows are its block along ``Model.batch_axes``, the axes
    ``launch.steps`` averages over, in every layout (the data axes; the
    whole mesh for ``REPLICATED_ARCHS`` and the population layout), and the
    blocks of the ranks tile the batch."""
    from repro_torch.launch.lm_ranks import rank_batch
    tcfg = tconfigs.get_smoke_config(arch)
    dp, mp = mesh_shape
    shape = {"data": dp, "model": mp}
    tokens = torch.arange(8 * 3).reshape(8, 3)
    for kw in ({}, {"dp_axes": ("data", "model"), "moe_ep_axis": None}):
        rows = set()
        for d in range(dp):
            for m in range(mp):
                mesh = _rank_mesh(shape, {"data": d, "model": m})
                model = build_model(tcfg, mesh=mesh, **kw)
                whole = model.replicate or \
                    tcfg.family in tsh.REPLICATED_ARCHS
                assert model.batch_axes == (("data", "model") if whole
                                            else ("data",))
                blk = rank_batch(model, {"tokens": tokens})["tokens"]
                n = mesh.axis_size(model.batch_axes)
                i = mesh.axis_index(model.batch_axes)
                assert torch.equal(blk, tokens[i * 8 // n:(i + 1) * 8 // n])
                rows.add(tuple(blk[:, 0].tolist()))
        assert sorted(r for rs in rows for r in rs) == \
            tokens[:, 0].tolist()


@pytest.mark.parametrize("heads,kv,tp", [(4, 2, 4), (8, 4, 8), (48, 1, 4),
                                         (64, 4, 8), (12, 4, 6), (40, 8, 4),
                                         (12, 3, 4)])
def test_kv_take_is_the_kv_heads_the_query_heads_read(heads, kv, tp):
    """``attention.kv_take``: the kv heads a rank's query heads read (global
    q head h reads h // G), in the order the rank's grouped attention reads
    them; ``rank_kv_heads`` counts them from the rank's blocks
    (``Model.rank_blocks``) as its cache holds them."""
    from repro_torch.models.attention import kv_take, rank_kv_heads
    cfg = dataclasses.replace(tconfigs.get_smoke_config("stablelm-1.6b"),
                              n_heads=heads, n_kv_heads=kv)
    g, hq = heads // kv, heads // tp
    for r in range(tp):
        take = kv_take(cfg, r * hq, hq)
        got = list(range(kv))[take] if isinstance(take, slice) else take
        # the rank's q head i reads its kv entry i // (hq // len(got))
        assert [got[i // (hq // len(got))] for i in range(hq)] == \
            [(r * hq + i) // g for i in range(hq)]
        mesh = _rank_mesh({"data": 1, "model": tp}, {"data": 0, "model": r})
        block = build_model(cfg, mesh=mesh).rank_blocks()["stages"][0]
        assert rank_kv_heads(block["attn"], cfg, mesh) == (
            kv // tp if kv % tp == 0 else len(got))
