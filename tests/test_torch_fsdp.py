"""Port's FSDP on a mesh of ranks (``Model(fsdp=True)``: each leaf's block
cut over the data axes as well, ``launch.sharding.rank_specs(...,
fsdp=True)``, gathered by ``collectives.gather_fsdp`` before each layer
runs) against the JAX package's unsharded model, and against the port's
own ``fsdp=False`` run.

The port's side is one 4-rank gloo world (``spawn_local_cluster``, a
``FileStore`` under the test's temporary directory) whose children import
only ``repro_torch``. The reference's FSDP rule cuts only a dimension of
1024 or more, so the smoke configs run at ``d_model`` 1024 (two layers, a
vocabulary of 256, float32; MoE drop-free, capacity factor E / top_k):

- stablelm-1.6b: attention, the MLP and the head cut over ``data`` too;
- gemma3-4b: tied embeddings (the one ``embed`` gathered once a call and
  read by the embedding and the unembedding);
- granite-moe-1b-a400m: the router and the experts' ``d_model`` rows;
- zamba2-2.7b: the Mamba2 mixer and the shared attention block.

Each on a (2, 2) and a (4, 1) ``(data, model)`` mesh. The reference's side
runs in a subprocess at the same time, on the same numpy weights (the
reference's init) and tokens. Bounds:

- the nll, averaged over the data ranks, 1e-5 relative of the reference's
  (the MoE aux term is the mesh's, averaged over shards, as under tensor
  parallelism); its gradient, through ``launch.steps``' mean over data
  (an FSDP leaf only divided: its gather's backward summed it), each
  rank's FSDP block 1e-4 of the leaf's largest against that block of the
  reference's gradient;
- two ``make_train_step`` SGD steps with ``fsdp=True`` and remat: the
  weights, gathered back over ``data``, bitwise the ``fsdp=False`` run's
  (no remat) on every rank;
- the gathers, counted exactly in calls and bytes: a forward gathers the
  FSDP leaves of ``embed``, ``head`` and ``final_norm`` in one transfer
  and each layer's in one a layer (the shared attention's at each stage
  that runs it); a gradient reduce-scatters each of those once; remat
  gathers each layer's again in its recomputation;
- ``gather_fsdp``'s backward bitwise this rank's block of the ordered sum
  of the ranks' cotangents, over one axis and over a tuple of axes;
- the dry run's stand-in count (``launch.dryrun.count_step`` on ``meta``,
  a ``launch.mesh.stand_in_mesh`` of (2, 2)) of each rank's SGD step equal
  to that rank's own ``CostCounter`` count in the gloo world: FLOPs by
  kind and collective bytes by kind, exactly, with and without FSDP.

The ``ValueError``s of ``Model(fsdp=True)`` need no ranks.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import multiprocess as mp  # noqa: E402
from repro_torch.launch.mesh import MuleMesh, stand_in_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
ARCHS = ("stablelm-1.6b", "gemma3-4b", "granite-moe-1b-a400m",
         "zamba2-2.7b")
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
N_RANKS = 4
D_MODEL = 1024       # the FSDP rule's least dimension
B, S = 4, 16
TRAIN_LR = 0.01
TRAIN_STEPS = 2
COUNT_ARCHS = ("stablelm-1.6b", "granite-moe-1b-a400m")
LOSS_REL = 1e-5
GRAD_REL = 1e-4


def _cfg(cfgs, arch):
    cfg = dataclasses.replace(cfgs.get_smoke_config(arch), dtype="float32",
                              d_model=D_MODEL)
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=float(cfg.n_experts) / cfg.top_k)
    return cfg


# ---------------------------------------------------------------------------
# the reference's side: one process, unsharded
# ---------------------------------------------------------------------------

_REF = r'''
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.models import build_model

d = sys.argv[1]
spec = json.load(open(d + "/spec.json"))
data = np.load(d + "/inputs.npz")
out = {}
for arch in spec["archs"]:
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="float32", d_model=spec["d_model"])
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=float(cfg.n_experts) / cfg.top_k)
    model = build_model(cfg)
    tree = jax.tree.structure(jax.eval_shape(model.init,
                                             jax.random.PRNGKey(0)))
    params = jax.tree.unflatten(tree, [jnp.asarray(data[f"{arch}.{i}"])
                                       for i in range(tree.num_leaves)])
    batch = {"tokens": jnp.asarray(data[arch + ".tokens"])}
    value, g = jax.jit(jax.value_and_grad(
        lambda p, b: model.loss(p, b)[1]["nll"]))(params, batch)
    out[arch + ".nll"] = np.asarray(value)
    for i, leaf in enumerate(jax.tree.leaves(g)):
        out[f"{arch}.g.{i}"] = np.asarray(leaf)
np.savez(d + "/ref.npz", **out)
'''


# ---------------------------------------------------------------------------
# the port's side: 4 ranks
# ---------------------------------------------------------------------------

_CHILD = r'''
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import configs
from repro_torch.core.distributed import ordered_psum
from repro_torch.interop import tree_leaves, tree_map
from repro_torch.launch import collectives as coll
from repro_torch.launch import lm_ranks
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.cost_analysis import CostCounter
from repro_torch.launch.dryrun import meta_params
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.launch.multiprocess import initialize_from_env
from repro_torch.launch.sharding import rank_specs, shard_of, unshard
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import sgd

torch.set_num_threads(1)
assert initialize_from_env()
rank = dist.get_rank()
d = sys.argv[1]
spec = json.load(open(d + "/spec.json"))
data = np.load(d + "/inputs.npz")


def cfg_of(arch):
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="float32", d_model=spec["d_model"])
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=float(cfg.n_experts) / cfg.top_k)
    return cfg


def whole_params(cfg, tag):
    # tree_leaves' order is the reference's: its leaves in the port's tree
    tree = build_model(cfg).init(torch.Generator().manual_seed(0))
    by_id = {id(t): torch.from_numpy(data[f"{tag}.{i}"])
             for i, t in enumerate(tree_leaves(tree))}
    return tree_map(lambda t: by_id[id(t)], tree)


def total(x, mesh):
    return float(ordered_psum(torch.tensor(float(x)), mesh,
                              ("data", "model")))


def fsdp_calls():
    c = coll.COLLECTIVE_COUNTS
    return [c["fsdp-gather"]["calls"], c["fsdp-gather"]["sent_bytes"],
            c["fsdp-scatter"]["calls"], c["fsdp-scatter"]["sent_bytes"]]


def since(before):
    return np.asarray([a - b for a, b in zip(fsdp_calls(), before)])


def to_tp_blocks(tree, dims, mesh):
    """The FSDP blocks gathered back over the data axes."""
    def back(leaf, dim):
        if dim is None:
            return leaf
        sp = [None] * leaf.dim()
        sp[dim] = "data"
        return unshard(leaf, tuple(sp), mesh)
    return [back(l, dm) for l, dm in zip(tree_leaves(tree),
                                         tree_leaves(dims))]


out = {}
for arch in spec["archs"]:
    cfg = cfg_of(arch)
    whole = whole_params(cfg, arch)
    tokens = torch.from_numpy(data[arch + ".tokens"])
    for name, (dp, tp) in spec["meshes"].items():
        tag = f"{arch}.{name}"
        mesh, model = lm_ranks.rank_model(cfg, dp, tp, fsdp=True)
        _, plain = lm_ranks.rank_model(cfg, dp, tp)
        dims = model.fsdp_dims
        out[tag + ".cut"] = total(rank == 0 and sum(
            x is not None for x in tree_leaves(dims)), mesh)
        params = lm_ranks.rank_params(model, whole)
        blk = lm_ranks.rank_batch(model, {"tokens": tokens})
        # the nll and its gradient through the train step's mean
        g, value = torch.func.grad_and_value(
            lambda p, b: model.loss(p, b)[1]["nll"])(params, blk)
        g, met = steps_mod._mesh_mean(model, g, {"loss": value})
        out[tag + ".nll"] = met["loss"].numpy()
        for i, leaf in enumerate(tree_leaves(g)):
            out[f"{tag}.g.{i}.r{rank}"] = leaf.numpy()
        # the gathers of a forward and of gradients with and without remat
        before = fsdp_calls()
        with torch.no_grad():
            model.forward(params, blk)
        out[tag + ".fwd"] = since(before)
        for policy in (None, "full"):
            m = dataclasses.replace(model, remat=policy is not None)
            before = fsdp_calls()
            torch.func.grad(lambda p, b: m.loss(p, b)[0])(params, blk)
            out[f"{tag}.grad.{policy}"] = since(before)
        # two SGD steps: FSDP with remat against fsdp=False without
        opt = sgd(spec["lr"])
        fs = dataclasses.replace(model, remat=True)
        step_f, step_p = make_train_step(fs, opt), make_train_step(plain, opt)
        pf, sf = params, opt.init(params)
        pp = lm_ranks.rank_params(plain, whole)
        sp = opt.init(pp)
        for _ in range(spec["steps"]):
            pf, sf, _ = step_f(pf, sf, blk)
            pp, sp, _ = step_p(pp, sp, blk)
        bad = sum(not torch.equal(a, b) for a, b in zip(
            to_tp_blocks(pf, dims, mesh), tree_leaves(pp)))
        out[tag + ".step_bad"] = total(bad, mesh)

# gather_fsdp's backward: this rank's blocks of the ordered sum of the
# ranks' cotangents, over one axis (4 x 1) and a tuple of axes (2 x 2), two
# leaves cut along different dimensions in one transfer
gen = torch.Generator().manual_seed(5)
xs = [torch.randn(3, 2, 5, generator=gen) for _ in range(4)]
ws = [torch.randn(4, 6, generator=gen) for _ in range(4)]
cots = [(torch.randn(3, 8, 5, generator=gen),
         torch.randn(16, 6, generator=gen)) for _ in range(4)]


def ordered_sum(parts):
    acc = parts[0] + parts[1]
    for p in parts[2:]:
        acc = acc + p
    return acc


want_x = ordered_sum([c[0] for c in cots])
want_w = ordered_sum([c[1] for c in cots])
for name, mesh, axes in (("one", make_lm_mesh(4, 1), "data"),
                         ("tuple", make_lm_mesh(2, 2), ("data", "model"))):
    before = fsdp_calls()
    ys, back = torch.func.vjp(
        lambda x, w: tuple(coll.gather_fsdp([x, w], mesh, axes, [1, 0])),
        xs[rank], ws[rank])
    gx, gw = back(cots[rank])
    out[f"gather.{name}.calls"] = np.asarray(since(before))
    out[f"gather.{name}.fwd"] = total(
        torch.equal(ys[0], torch.cat(xs, dim=1))
        and torch.equal(ys[1], torch.cat(ws, dim=0)), mesh)
    out[f"gather.{name}.back"] = total(
        torch.equal(gx, want_x[:, 2 * rank:2 * rank + 2])
        and torch.equal(gw, want_w[4 * rank:4 * rank + 4]), mesh)

# the real ranks' counts of one SGD step, for the stand-in's
for arch in spec["count_archs"]:
    cfg = cfg_of(arch)
    whole = whole_params(cfg, arch)
    for fsdp in (False, True):
        mesh, model = lm_ranks.rank_model(cfg, 2, 2, fsdp=fsdp, remat=True)
        params = lm_ranks.rank_params(model, whole)
        blk = lm_ranks.rank_batch(model, {"tokens": torch.from_numpy(
            data[arch + ".tokens"])})
        opt = sgd(spec["lr"])
        state = opt.init(params)
        with CostCounter() as cc:
            make_train_step(model, opt)(params, state, blk)
        tag = f"count.{arch}.{fsdp}.r{rank}"
        out[tag + ".flops"] = json.dumps(cc.flops_by, sort_keys=True)
        out[tag + ".coll"] = json.dumps(cc.coll, sort_keys=True)

np.savez(f"{d}/port{rank}.npz", **out)
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp")
    rng = np.random.default_rng(21)
    inputs = {}
    for i, arch in enumerate(ARCHS):
        cfg = _cfg(jconfigs, arch)
        leaves = jax.tree.leaves(j_build_model(cfg).init(
            jax.random.PRNGKey(i)))
        inputs.update({f"{arch}.{j}": np.asarray(x)
                       for j, x in enumerate(leaves)})
        inputs[arch + ".tokens"] = rng.integers(0, cfg.vocab, (B, S)) \
            .astype(np.int32)
    np.savez(d / "inputs.npz", **inputs)
    (d / "spec.json").write_text(json.dumps({
        "archs": ARCHS, "meshes": MESHES, "d_model": D_MODEL,
        "lr": TRAIN_LR, "steps": TRAIN_STEPS, "count_archs": COUNT_ARCHS}))
    ref_env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen([sys.executable, "-c", _REF, str(d)],
                           env=ref_env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
        mp.spawn_local_cluster([sys.executable, "-c", _CHILD, str(d)],
                               N_RANKS, coordinator=f"file://{d}/store",
                               base_env=env, timeout=300)
        log = ref.communicate(timeout=300)[0]
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, log
    port = {}
    for r in range(N_RANKS):        # the totals are alike on every rank
        port.update(np.load(d / f"port{r}.npz"))
    return port, dict(np.load(d / "ref.npz"))


CASES = [(arch, mesh) for arch in ARCHS for mesh in sorted(MESHES)]
IDS = [f"{arch}-{mesh}" for arch, mesh in CASES]


def _port_model(arch, mesh_name, rank=0, **kw):
    dp, tp = MESHES[mesh_name]
    return build_model(_cfg(tconfigs, arch), mesh=stand_in_mesh(
        {"data": dp, "model": tp}, rank), **kw)


def _specs_and_dims(arch, mesh_name, rank):
    from repro_torch.interop import tree_leaves
    from repro_torch.launch.sharding import rank_specs
    model = _port_model(arch, mesh_name, rank, fsdp=True)
    whole = dryrun.meta_params(model)
    specs = rank_specs(model.cfg, whole, model.mesh, fsdp=True)
    return model, whole, specs, tree_leaves(model.fsdp_dims)


def _spec_leaves(specs):
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for v in specs for x in _spec_leaves(v)]
    return [specs]


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_fsdp_cuts_leaves_over_data(world, arch, mesh):
    """At ``d_model`` 1024 the rule cuts leaves in every config."""
    port, _ = world
    assert float(port[f"{arch}.{mesh}.cut"]) > 0


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_loss_and_gradient_blocks_match_the_reference(world, arch, mesh):
    from repro_torch.launch.sharding import shard_of
    port, ref = world
    tag = f"{arch}.{mesh}"
    want = float(ref[arch + ".nll"])
    assert abs(float(port[tag + ".nll"]) - want) <= LOSS_REL * abs(want)
    n = sum(1 for k in ref if k.startswith(arch + ".g."))
    assert n > 0
    for r in range(N_RANKS):
        model, _, specs, _ = _specs_and_dims(arch, mesh, r)
        for i, sp in enumerate(_spec_leaves(specs)):
            whole = torch.from_numpy(ref[f"{arch}.g.{i}"])
            block = shard_of(whole, sp, model.mesh).numpy()
            scale = max(float(np.abs(whole.numpy()).max()), 1e-12)
            np.testing.assert_allclose(port[f"{tag}.g.{i}.r{r}"], block,
                                       atol=GRAD_REL * scale, rtol=0)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_sgd_steps_are_bitwise_the_unsharded_run(world, arch, mesh):
    """Two SGD steps with FSDP and remat: every rank's weights, gathered
    back over ``data``, are the ``fsdp=False`` run's bits."""
    port, _ = world
    assert float(port[f"{arch}.{mesh}.step_bad"]) == 0.0


def _expected_gathers(arch, mesh_name):
    """(gathers outside the layers, in the layers) in calls and bytes of a
    rank's forward, from the FSDP blocks' shapes: one transfer for the
    leaves outside the stages, one a layer, one for the shared attention
    at each stage that runs it."""
    model, whole, specs, dims = _specs_and_dims(arch, mesh_name, 0)
    from repro_torch.interop import tree_leaves
    from repro_torch.launch.sharding import shard_tree
    blocks = tree_leaves(shard_tree(whole, specs, model.mesh))
    names = _names(whole)
    top, layers = [0, 0], [0, 0]
    shared = sum(st.kind == "shared_attn" for st in model.program)
    groups = set()              # the transfers: top, a stage's, shared
    for name, blk, dim in zip(names, blocks, dims):
        if dim is None:
            continue
        nbytes = blk.numel() * blk.element_size()
        if name[0] == "stages":
            groups.add(("stages", name[1]))
            layers[1] += nbytes         # the stack's blocks, one a layer
        elif name[0] == "shared_attn":
            groups.add(("shared_attn",))
            layers[1] += shared * nbytes
        else:
            groups.add(("top",))
            top[1] += nbytes
    top[0] = int(("top",) in groups)
    layers[0] = shared * int(("shared_attn",) in groups) + sum(
        model.program[g[1]].count for g in groups if g[0] == "stages")
    return top, layers


def _names(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _names(tree[k],
                                                         path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _names(v,
                                                               path + (i,))]
    return [path]


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_gathers_are_counted_exactly(world, arch, mesh):
    port, _ = world
    tag = f"{arch}.{mesh}"
    top, layers = _expected_gathers(arch, mesh)
    dp = MESHES[mesh][0]
    calls, nbytes = top[0] + layers[0], top[1] + layers[1]
    assert port[tag + ".fwd"].tolist() == [calls, nbytes, 0, 0]
    # a scatter of each gathered block's whole, dp times its bytes
    assert port[tag + ".grad.None"].tolist() == [calls, nbytes, calls,
                                                 dp * nbytes]
    assert port[tag + ".grad.full"].tolist() == [
        calls + layers[0], nbytes + layers[1], calls, dp * nbytes]


@pytest.mark.parametrize("axes", ["one", "tuple"])
def test_gather_fsdp_backward_is_the_ordered_sum_of_the_cotangents(
        world, axes):
    """Two leaves, cut along dimensions 1 and 0, in one gather and one
    reduce-scatter of 4 x (30 + 24) float32 values."""
    port, _ = world
    assert float(port[f"gather.{axes}.fwd"]) == float(N_RANKS)
    assert float(port[f"gather.{axes}.back"]) == float(N_RANKS)
    assert port[f"gather.{axes}.calls"].tolist() == [1, 54 * 4, 1,
                                                     4 * 54 * 4]


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("arch", COUNT_ARCHS)
def test_stand_in_count_is_each_real_ranks_count(world, arch, fsdp):
    """The dry run's count of rank r of a stand-in (2, 2) mesh on ``meta``
    is rank r's count in the gloo world: FLOPs and collective bytes by
    kind, exactly (the count needs no process group)."""
    port, _ = world
    shape = tconfigs.InputShape("t", S, B, "train")
    for r in range(N_RANKS):
        model = _port_model(arch, "2x2", r, fsdp=fsdp, remat=True)
        cc, _ = dryrun.count_step(model, shape, sgd(TRAIN_LR))
        tag = f"count.{arch}.{fsdp}.r{r}"
        assert json.loads(str(port[tag + ".flops"])) == cc.flops_by
        assert json.loads(str(port[tag + ".coll"])) == cc.coll


# ---------------------------------------------------------------------------
# where FSDP does not run: a stand-in mesh, no ranks
# ---------------------------------------------------------------------------


def _mesh(shape):
    return MuleMesh(shape=dict(shape), coords={a: 0 for a in shape},
                    groups={}, data_axis=tuple(shape)[-1])


@pytest.mark.parametrize("kw,what", [
    ({"mesh": None}, "needs a mesh"),
    ({"dp_axes": ("data", "model")}, "population"),
    ({"seq_axis": "data", "dp_axes": ()}, "seq_axis"),
], ids=["no-mesh", "population-layout", "seq-axis"])
def test_fsdp_raises_where_it_does_not_run(kw, what):
    cfg = tconfigs.get_smoke_config("stablelm-1.6b")
    kw = {"mesh": _mesh({"data": 2, "model": 2}), **kw}
    with pytest.raises(ValueError, match=what):
        build_model(cfg, fsdp=True, **kw)
