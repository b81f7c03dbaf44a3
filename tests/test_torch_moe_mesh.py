"""Port's mixture-of-experts on a mesh of ranks (``models.moe.apply_moe``
with ``mesh=``, ``Model(mesh=...)``) against the JAX package's
``shard_map`` paths.

The port's side is one 4-rank gloo world (``spawn_local_cluster``, a
``FileStore`` under the test's temporary directory) whose children import
only ``repro_torch``; it runs every case once, on a 2 x 2 and a 1 x 4
``(data, model)`` mesh (the expert-parallel path, 2 and 4 peers) and on a
4 x 1 mesh with ``ep_axis=None`` (the data-parallel path). Each rank holds
its experts (``launch.sharding.shard_of``) and its block of the batch;
rank 0 puts the blocks back together: outputs and the input's gradient
gathered over ``data``, the router's gradient summed over ``data`` (the
global ``out.sum()`` is the sum of the ranks' sums), the experts' summed
over ``data`` and gathered over ``model``. The reference's side runs in a
subprocess with 4 XLA host devices (``conftest.run_with_devices``'
environment) on ``jax.sharding.Mesh``es of the same shapes, jitted. Both
take the same weights (the reference's ``init_moe`` and ``Model.init``)
and inputs from a numpy seed, in float32, at the smoke granite-moe layer
(E 4, top-2, d 128, f 64) on a [4, 16] batch. Bounds:

- ``apply_moe``'s output, aux loss and gradients of ``out.sum()`` (the
  weights and the input) 1e-5 of the reference's sharded runs, at capacity
  factor 1.25 (slots drop in each shard) and 8.0 (drop-free); drop-free,
  also 1e-5 of the port's own local path (``mesh=None``), as the
  reference's ``test_sharded_moe_matches_local``;
- the smoke granite-moe's ``Model.loss`` on 2 x 2 (every rank holding
  ``launch.sharding.rank_specs``' blocks: the experts and the attention's
  heads split over ``model``, the vocabulary of 256 too) 1e-5 relative, and its
  gradient averaged over ``data`` as the train step averages it, 1e-4 of
  each leaf's largest, against ``jax.value_and_grad`` of the reference's
  ``build_model(cfg, mesh=mesh).loss`` (sums in another order through two
  layers, as ``test_torch_train.py`` holds the local step); with
  ``remat=True`` the port's gradient bitwise its own without; one SGD
  step of ``make_train_step(model, sgd, donate=True)`` on 2 x 2 (the mean
  over ``data`` inside the step) against the reference's SGD step on that
  gradient: each weight lr x that bound plus one float32 spacing;
- 6 steps of ``decode_step`` on 2 x 2 (a float32 cache, the batch cut
  over ``data``) 1e-5 of the reference's on the same mesh, every step;
- the collectives: the ranks' ``all_to_all`` bytes are ``2 E C d`` a
  layer, and the 4 x 1 data-parallel path moves none; under
  ``torch.func.vmap`` each lane is bitwise its own call; ``ordered_psum``
  in pipelined pieces is bitwise the rank-order fold.
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
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.launch import multiprocess as mp  # noqa: E402

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
ARCH = "granite-moe-1b-a400m"
B, S, N_RANKS = 4, 16, 4
# name: (data, model, the experts' axis)
MESHES = {"2x2": (2, 2, "model"), "1x4": (1, 4, "model"),
          "4x1": (4, 1, None)}
FACTORS = (1.25, 8.0)
DECODE_STEPS, DECODE_LEN = 6, 8
MOE_TOL = 1e-5
LOSS_REL = 1e-5
GRAD_REL = 1e-4
TRAIN_LR = 0.5
DECODE_TOL = 1e-5
NAMES = ("router", "wi_gate", "wi_up", "wo")


def _cfg(**kw):
    return dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               dtype="float32", **kw)


# ---------------------------------------------------------------------------
# the reference's side: a subprocess with 4 host devices
# ---------------------------------------------------------------------------

_REF = r'''
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.models import build_model
from repro.models.moe import apply_moe
from repro.optim import sgd

d = sys.argv[1]
spec = json.load(open(d + "/spec.json"))
data = np.load(d + "/inputs.npz")
base = dataclasses.replace(configs.get_smoke_config(spec["arch"]),
                           dtype="float32")
out = {}
x = jnp.asarray(data["x"])
for name, (dp, ep, ep_axis) in spec["meshes"].items():
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(dp, ep),
                             ("data", "model"))
    for cf in spec["factors"]:
        cfg = dataclasses.replace(base, capacity_factor=cf)
        p = {k: jnp.asarray(data[f"moe{cf}.{k}"]) for k in spec["names"]}
        f = lambda p, x: apply_moe(p, x, cfg, mesh=mesh, ep_axis=ep_axis)
        with mesh:
            o, aux = jax.jit(f)(p, x)
            gp, gx = jax.jit(jax.grad(lambda p, x: f(p, x)[0].sum(),
                                      argnums=(0, 1)))(p, x)
        tag = f"{name}.{cf}"
        out[tag + ".out"], out[tag + ".aux"] = np.asarray(o), np.asarray(aux)
        out[tag + ".gx"] = np.asarray(gx)
        for k in spec["names"]:
            out[f"{tag}.g.{k}"] = np.asarray(gp[k])
cfg = dataclasses.replace(base, capacity_factor=spec["model_cf"])
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                         ("data", "model"))
model = build_model(cfg, mesh=mesh)
flat = [jnp.asarray(data[f"model.{i}"]) for i in range(spec["n_leaves"])]
params = jax.tree.unflatten(jax.tree.structure(
    jax.eval_shape(model.init, jax.random.PRNGKey(0))), flat)
batch = {"tokens": jnp.asarray(data["tokens"])}
with mesh:
    (loss, _), g = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(
        params, batch)
    out["model.loss"] = np.asarray(loss)
    for i, leaf in enumerate(jax.tree.leaves(g)):
        out[f"model.g.{i}"] = np.asarray(leaf)
    opt = sgd(spec["train_lr"])
    stepped, _ = jax.jit(opt.update)(params, g, opt.init(params))
    for i, leaf in enumerate(jax.tree.leaves(stepped)):
        out[f"train.p.{i}"] = np.asarray(leaf)
    cache = model.init_cache(spec["batch"], spec["decode_len"],
                             dtype=jnp.float32)
    step = jax.jit(model.decode_step)
    toks = jnp.asarray(data["decode_tokens"])
    for t in range(spec["decode_steps"]):
        logits, cache = step(params, cache, toks[:, t:t + 1], t)
        out[f"decode.{t}"] = np.asarray(logits)
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
from repro_torch.core import distributed
from repro_torch.core.distributed import ordered_psum, ordered_pmean
from repro_torch.interop import tree_leaves, tree_map
from repro_torch.launch import collectives
from repro_torch.launch.lm_ranks import rank_params
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.launch.multiprocess import initialize_from_env
from repro_torch.launch.sharding import rank_specs, shard_of, unshard
from repro_torch.launch import steps
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model, moe
from repro_torch.optim import sgd

torch.set_num_threads(1)
assert initialize_from_env()
rank = dist.get_rank()
N = dist.get_world_size()
d = sys.argv[1]
spec = json.load(open(d + "/spec.json"))
data = np.load(d + "/inputs.npz")
base = dataclasses.replace(configs.get_smoke_config(spec["arch"]),
                           dtype="float32")
out = {}
x_full = torch.from_numpy(data["x"])
EXPERTS = ("model", None, None)
BLOCK = ("data", None, None)
for name, (dp, ep, ep_axis) in spec["meshes"].items():
    mesh = make_lm_mesh(dp, ep)
    for cf in spec["factors"]:
        cfg = dataclasses.replace(base, capacity_factor=cf)
        full = {k: torch.from_numpy(data[f"moe{cf}.{k}"])
                for k in spec["names"]}
        cut = {k: (EXPERTS if ep_axis and k != "router" else ())
               for k in full}
        p = {k: shard_of(v, cut[k], mesh).clone() for k, v in full.items()}
        x = shard_of(x_full, BLOCK, mesh)
        f = lambda p, x: moe.apply_moe(p, x, cfg, mesh=mesh, ep_axis=ep_axis)
        before = collectives.COLLECTIVE_COUNTS["all-to-all"]["sent_bytes"]
        o, aux = f(p, x)
        a2a = collectives.COLLECTIVE_COUNTS["all-to-all"]["sent_bytes"] \
            - before
        gp, gx = torch.func.grad(lambda p, x: f(p, x)[0].sum(),
                                 argnums=(0, 1))(p, x)
        tag = f"{name}.{cf}"
        out[tag + ".out"] = unshard(o, BLOCK, mesh).numpy()
        out[tag + ".aux"] = aux.detach().numpy()
        out[tag + ".gx"] = unshard(gx, BLOCK, mesh).numpy()
        out[tag + ".a2a"] = np.asarray(a2a)
        for k in spec["names"]:
            g = ordered_psum(gp[k], mesh, "data")
            out[f"{tag}.g.{k}"] = unshard(g, cut[k], mesh).numpy()
        if name == "2x2" and cf == spec["factors"][-1]:
            lo, _ = moe.apply_moe(full, x_full, cfg)
            lp, lx = torch.func.grad(
                lambda p, x: moe.apply_moe(p, x, cfg)[0].sum(),
                argnums=(0, 1))(full, x_full)
            out["local.out"], out["local.gx"] = lo.numpy(), lx.numpy()
            for k in spec["names"]:
                out[f"local.g.{k}"] = lp[k].numpy()

# the collectives' vmap rules: each lane as its own call, forward and
# gradient (3 lanes, on the 2 x 2 mesh's model axis)
mesh = make_lm_mesh(2, 2)
C = collectives
lanes = torch.arange(30, dtype=torch.float32).reshape(3, 2, 5) + 100 * rank
scale = torch.arange(1.0, 11.0).reshape(2, 5) * (rank + 1)
checks = {
    "all_to_all": lambda x: C.all_to_all(x, mesh, "model"),
    "all_gather": lambda x: C.all_gather(x, mesh, "model"),
    "grad all_gather": torch.func.grad(
        lambda x: (C.all_gather(x, mesh, "model") ** 2).sum()),
    "grad replicated": torch.func.grad(
        lambda x: (C.replicated(x, mesh, "model") * scale).sum()),
    "grad all_to_all": torch.func.grad(
        lambda x: (C.all_to_all(x, mesh, "model") * scale).sum()),
    "psum": lambda x: C.psum(x, mesh, "data"),
}
bad = sum(not torch.equal(torch.func.vmap(f)(lanes),
                          torch.stack([f(x) for x in lanes]))
          for f in checks.values())
out["vmap.bad"] = ordered_psum(torch.tensor(float(bad)), mesh,
                               ("data", "model")).numpy()

# ordered_psum over the 4 ranks, its parts crossing in one piece and in
# 64-byte pieces (the window of pieces in flight full), against the fold
# of every rank's part in rank order
parts = [torch.randn(1000, generator=torch.Generator().manual_seed(r))
         for r in range(N)]
want = parts[0] + parts[1]
for p in parts[2:]:
    want = want + p
whole = ordered_psum(parts[rank], mesh, ("data", "model"))
distributed._EXCHANGE_PIECE = 64
pieces = ordered_psum(parts[rank], mesh, ("data", "model"))
out["psum.bitwise"] = ordered_psum(torch.tensor(float(
    torch.equal(whole, want) and torch.equal(pieces, want))), mesh,
    ("data", "model")).numpy()

cfg = dataclasses.replace(base, capacity_factor=spec["model_cf"])
model = build_model(cfg, mesh=mesh)
whole = model.init(torch.Generator().manual_seed(0))
flat = [torch.from_numpy(data[f"model.{i}"]) for i in range(spec["n_leaves"])]
# tree_leaves' order is the reference's: put its leaves in the port's tree
by_id = {id(t): v for t, v in zip(tree_leaves(whole), flat)}
whole = tree_map(lambda t: by_id[id(t)], whole)
specs = rank_specs(cfg, whole, mesh)
params = rank_params(model, whole)
batch = {"tokens": shard_of(torch.from_numpy(data["tokens"]),
                            ("data", None), mesh)}
g, (loss, _) = torch.func.grad_and_value(model.loss, has_aux=True)(
    params, batch)
remat = build_model(cfg, mesh=mesh, remat=True)
gr, (loss_r, _) = torch.func.grad_and_value(remat.loss, has_aux=True)(
    params, batch)
out["model.remat_bitwise"] = np.asarray(
    bool(torch.equal(loss, loss_r)) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(g), tree_leaves(gr))))
out["model.loss"] = ordered_pmean(loss, mesh, "data").numpy()
g = tree_map(lambda l: ordered_pmean(l, mesh, "data"), g)
g = tree_map(lambda l, s: unshard(l, s, mesh), g, specs)
for i, leaf in enumerate(tree_leaves(g)):
    out[f"model.g.{i}"] = leaf.numpy()
# one SGD step of the train step itself on the mesh (the gradients
# averaged over data in pieces of 1,000 elements, so that the smoke
# model's leaves cross in several, each in 64-byte pieces, the update in
# place)
steps._PMEAN_CHUNK = 1000
opt = sgd(spec["train_lr"])
stepped = tree_map(lambda t: t.clone(), params)
new, _, met = make_train_step(model, opt, donate=True)(
    stepped, opt.init(stepped), batch)
out["train.in_place"] = np.asarray(all(
    a is b for a, b in zip(tree_leaves(new), tree_leaves(stepped))))
out["train.loss"] = met["loss"].numpy()
new = tree_map(lambda l, s: unshard(l, s, mesh), new, specs)
for i, leaf in enumerate(tree_leaves(new)):
    out[f"train.p.{i}"] = leaf.numpy()

cache = model.init_cache(2, spec["decode_len"], dtype=torch.float32,
                         device="cpu")
toks = shard_of(torch.from_numpy(data["decode_tokens"]), ("data", None),
                mesh)
with torch.no_grad():
    for t in range(spec["decode_steps"]):
        logits, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
        out[f"decode.{t}"] = unshard(logits, ("data", None), mesh).numpy()
if rank == 0:
    np.savez(d + "/port.npz", **out)
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_mesh")
    rng = np.random.default_rng(7)
    inputs = {"x": (0.5 * rng.normal(size=(B, S, _cfg().d_model)))
              .astype(np.float32)}
    for i, cf in enumerate(FACTORS):
        p = jmoe.init_moe(jax.random.PRNGKey(10 + i), _cfg(capacity_factor=cf))
        inputs.update({f"moe{cf}.{k}": np.asarray(p[k]) for k in NAMES})
    jm = j_build_model(_cfg())
    leaves = jax.tree.leaves(jm.init(jax.random.PRNGKey(0)))
    inputs.update({f"model.{i}": np.asarray(x) for i, x in enumerate(leaves)})
    vocab = _cfg().vocab
    inputs["tokens"] = rng.integers(0, vocab, (B, S)).astype(np.int32)
    inputs["decode_tokens"] = rng.integers(
        0, vocab, (B, DECODE_STEPS)).astype(np.int32)
    np.savez(d / "inputs.npz", **inputs)
    (d / "spec.json").write_text(json.dumps({
        "arch": ARCH, "meshes": MESHES, "factors": FACTORS, "names": NAMES,
        "model_cf": 1.25, "n_leaves": len(leaves), "batch": B,
        "train_lr": TRAIN_LR,
        "decode_len": DECODE_LEN, "decode_steps": DECODE_STEPS}))
    ref_env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": f"--xla_force_host_platform_device_count="
                            f"{N_RANKS}"}
    ref = subprocess.Popen([sys.executable, "-c", _REF, str(d)],
                           env=ref_env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
        mp.spawn_local_cluster([sys.executable, "-c", _CHILD, str(d)],
                               N_RANKS, coordinator=f"file://{d}/store",
                               base_env=env, timeout=300)
        log, _ = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, log
    return dict(np.load(d / "port.npz")), dict(np.load(d / "ref.npz"))


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_apply_moe_on_the_mesh_matches_the_reference(world, mesh, cf):
    port, ref = world
    tag = f"{mesh}.{cf}"
    for part in ("out", "aux", "gx") + tuple(f"g.{k}" for k in NAMES):
        _close(port[f"{tag}.{part}"], ref[f"{tag}.{part}"], MOE_TOL)
    assert np.abs(port[f"{tag}.g.router"]).max() > 0


def test_drop_free_mesh_paths_match_the_local_path(world):
    port, _ = world
    for mesh in MESHES:
        tag = f"{mesh}.{FACTORS[-1]}"
        _close(port[tag + ".out"], port["local.out"], MOE_TOL)
        _close(port[tag + ".gx"], port["local.gx"], MOE_TOL)
        for k in NAMES:
            _close(port[f"{tag}.g.{k}"], port[f"local.g.{k}"], MOE_TOL)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_all_to_all_moves_the_groups_twice(world, mesh):
    port, _ = world
    dp, ep, ep_axis = MESHES[mesh]
    cfg = _cfg(capacity_factor=1.25)
    t_ep = B // dp * S // ep
    c = int(max(1, round(t_ep * cfg.top_k / cfg.n_experts * 1.25)))
    want = 2 * cfg.n_experts * c * cfg.d_model * 4 if ep_axis and ep > 1 \
        else 0
    assert int(port[f"{mesh}.1.25.a2a"]) == want


def test_collectives_under_vmap_are_each_lanes_call(world):
    """``all_to_all``, ``all_gather`` (and their gradients), the gradient
    of ``replicated`` and ``psum`` under ``torch.func.vmap`` over 3 lanes
    equal each lane's own call, bitwise, on every rank."""
    port, _ = world
    assert float(port["vmap.bad"]) == 0.0


def test_ordered_psum_in_pieces_is_the_rank_order_fold(world):
    """``ordered_psum`` over 4 ranks, its parts crossing whole and in
    64-byte pieces, is bitwise the left-to-right fold of the ranks' parts
    in rank order, on every rank."""
    port, _ = world
    assert float(port["psum.bitwise"]) == float(N_RANKS)


def test_model_loss_and_gradient_on_2x2_match_the_reference(world):
    port, ref = world
    assert abs(float(port["model.loss"]) - float(ref["model.loss"])) <= \
        LOSS_REL * abs(float(ref["model.loss"]))
    n = sum(1 for k in ref if k.startswith("model.g."))
    assert n == sum(1 for k in port if k.startswith("model.g."))
    for i in range(n):
        want = ref[f"model.g.{i}"]
        scale = max(float(np.abs(want).max()), 1e-12)
        _close(port[f"model.g.{i}"], want, GRAD_REL * scale)
    assert bool(port["model.remat_bitwise"])


def test_train_step_on_2x2_matches_the_reference(world):
    """One ``make_train_step(model, sgd, donate=True)`` step on 2 x 2 (each
    data rank's gradient, averaged over ``data`` in the step, the update in
    place) against the reference's SGD step on ``jax.value_and_grad`` of
    ``build_model(cfg, mesh=mesh).loss``: each updated leaf within lr x the
    gradient's bound, plus one float32 spacing of the leaf for the update's
    own rounding."""
    port, ref = world
    assert bool(port["train.in_place"])
    assert abs(float(port["train.loss"]) - float(ref["model.loss"])) <= \
        LOSS_REL * abs(float(ref["model.loss"]))
    n = sum(1 for k in ref if k.startswith("train.p."))
    assert n == sum(1 for k in port if k.startswith("train.p.")) > 0
    for i in range(n):
        want = ref[f"train.p.{i}"]
        scale = max(float(np.abs(ref[f"model.g.{i}"]).max()), 1e-12)
        ulp = float(np.spacing(np.abs(want).max().astype(np.float32)))
        _close(port[f"train.p.{i}"], want, TRAIN_LR * GRAD_REL * scale + ulp)


def test_decode_on_2x2_matches_the_reference(world):
    port, ref = world
    for t in range(DECODE_STEPS):
        _close(port[f"decode.{t}"], ref[f"decode.{t}"], DECODE_TOL)
