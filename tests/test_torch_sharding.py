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

``shard_of`` and ``moe_specs`` are checked on a one-process stand-in mesh:
the blocks tile the whole leaf in rank order.
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
    _, tcfg, _, tm, _, tparams = _models("granite-moe-1b-a400m", True)
    mesh = _rank_mesh({"data": 1, "model": 2}, {"data": 0, "model": 1})
    specs = tsh.moe_specs(tcfg, tparams, mesh, ep_axis)
    flat = dict(_port_flat(specs))
    cut = {n: s for n, s in flat.items() if s}
    if ep_axis is None:
        assert not cut
        return
    # the /moe/ rule of param_specs for the experts, nothing else
    full = dict(_port_flat(tsh.param_specs(tcfg, tparams, _Mesh(
        {"data": 1, "model": 2}))))
    assert sorted(cut) == sorted(n for n in flat if "/moe/" in n
                                 and not n.endswith("router"))
    assert all(cut[n] == full[n] for n in cut)
    local = tsh.shard_tree(tparams, specs, mesh)
    assert local["stages"][0]["moe"]["wi_gate"].shape[1] == \
        tcfg.n_experts // 2
    assert local["embed"].shape == tparams["embed"].shape
