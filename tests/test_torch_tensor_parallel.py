"""Port's dense tensor parallelism on a mesh of ranks (``launch.sharding.
rank_specs`` executed by ``Model(mesh=...)``) against the JAX package's
unsharded model and its GSPMD train step.

The port's side is one 4-rank gloo world (``spawn_local_cluster``, a
``FileStore`` under the test's temporary directory) whose children import
only ``repro_torch``. For each of seven smoke configs, each chosen for a
fallback of ``param_specs``, on a (1, 4) and a (2, 2) ``(data, model)``
mesh, each rank holds its blocks (``lm_ranks.rank_params``) and its block
of the batch (``lm_ranks.rank_batch``):

- stablelm-1.6b: every dense rule splits (4 heads, MLP, vocabulary);
- gemma3-4b: 4 query heads over 2 kv heads, so at 4 ranks q splits and kv
  is whole (each rank keeps the kv head its query head reads); tied
  embeddings, sliding windows;
- qwen2.5-32b: 5 heads, so attention runs whole on every peer; qkv bias;
  the MLP and the vocabulary split;
- granite-34b: one kv head; tied embeddings;
- zamba2-2.7b: the Mamba2 mixer on its heads, the shared attention block;
- granite-moe-1b-a400m: split attention with the experts over ``model``;
- xlstm-350m: every leaf whole, the batch over ``(data, model)``.

The reference's side runs in a subprocess with 4 XLA host devices
(``conftest.run_with_devices``' environment) at the same time, on the same
numpy weights (the reference's init) and tokens, in float32. MoE runs
drop-free (capacity factor E / top_k), where the expert-parallel path's
routing is the local path's. Bounds:

- the logits, gathered over the batch, 2e-5 of the reference's unsharded
  ``forward`` (sums in other orders through two layers; readings ~1e-6);
- the nll (the loss less the MoE aux term, which the mesh averages over
  its shards: ``test_torch_moe_mesh.py`` holds that) 1e-5 relative, its
  gradient averaged over the batch's axes and ``unshard``-ed 1e-4 of each
  leaf's largest;
- the greedy tokens of ``serve.generate`` (a 3-token prompt, 6 tokens)
  equal to the reference's decode loop;
- bitwise: every leaf held whole on the model axis has the same gradient on
  every model peer, and the same weights on every rank after one
  ``make_train_step`` SGD step;
- one SGD step (lr 0.01) of stablelm-1.6b's smoke config on (2, 2) at
  4 x 32 against the reference's own GSPMD step (``jax.jit`` with
  ``param_specs`` as ``in_shardings``, as ``tests/test_distributed.py::
  test_smoke_mesh_train_step``), in float32: each weight lr x the
  gradient's bound plus one float32 spacing.
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
from repro_torch.launch import multiprocess as mp  # noqa: E402

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
ARCHS = ("stablelm-1.6b", "gemma3-4b", "qwen2.5-32b", "granite-34b",
         "zamba2-2.7b", "granite-moe-1b-a400m", "xlstm-350m")
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
N_RANKS = 4
REF_PARTS = 3        # the reference's processes (the archs dealt out)
B, S = 4, 16
PROMPT, GEN = 3, 6
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_LR = "stablelm-1.6b", 4, 32, 0.01
LOGIT_TOL = 2e-5
LOSS_REL = 1e-5
GRAD_REL = 1e-4


def _cfg(arch):
    cfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                              dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=float(cfg.n_experts) / cfg.top_k)
    return cfg


# ---------------------------------------------------------------------------
# the reference's side: a subprocess with 4 host devices
# ---------------------------------------------------------------------------

_REF = r'''
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.configs import InputShape
from repro.launch.sharding import batch_specs, param_specs, to_named
from repro.launch.steps import make_train_step
from repro.models import build_model
from repro.optim import sgd

d = sys.argv[1]
spec = json.load(open(d + "/spec.json"))
data = np.load(d + "/inputs.npz")


def cfg_of(arch):
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=float(cfg.n_experts) / cfg.top_k)
    return cfg


def params_of(model, tag):
    tree = jax.tree.structure(jax.eval_shape(model.init,
                                             jax.random.PRNGKey(0)))
    return jax.tree.unflatten(tree, [jnp.asarray(data[f"{tag}.{i}"])
                                     for i in range(tree.num_leaves)])


out = {}
part = int(sys.argv[2])           # this process's share of the archs
for arch in spec["archs"][part::spec["ref_parts"]]:
    model = build_model(cfg_of(arch))
    params = params_of(model, arch)
    batch = {"tokens": jnp.asarray(data[arch + ".tokens"])}

    def nll(p, b):       # one compile for the logits and the gradient
        return model.loss(p, b)[1]["nll"], model.forward(p, b)[0]

    (value, logits), g = jax.jit(jax.value_and_grad(nll, has_aux=True))(
        params, batch)
    out[arch + ".logits"] = np.asarray(logits)
    out[arch + ".nll"] = np.asarray(value)
    for i, leaf in enumerate(jax.tree.leaves(g)):
        out[f"{arch}.g.{i}"] = np.asarray(leaf)
    prompt = jnp.asarray(data[arch + ".prompt"])
    b, n = prompt.shape
    cache = model.init_cache(b, n + spec["gen"], dtype=jnp.float32)
    step = jax.jit(model.decode_step)
    for t in range(n):
        logits, cache = step(params, cache, prompt[:, t:t + 1], t)
    toks = []
    tok = jnp.argmax(logits, axis=-1)[:, None]
    for t in range(n, n + spec["gen"]):
        toks.append(tok)
        logits, cache = step(params, cache, tok, t)
        tok = jnp.argmax(logits, axis=-1)[:, None]
    out[arch + ".decode"] = np.asarray(jnp.concatenate(toks, axis=1))

if part:
    np.savez(f"{d}/ref{part}.npz", **out)
    sys.exit(0)

# one SGD step on a (2, 2) mesh through GSPMD, with the production specs
cfg = cfg_of(spec["train_arch"])
model = build_model(cfg)
params = params_of(model, "train")
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                         ("data", "model"))
opt = sgd(spec["train_lr"])
batch = {"tokens": jnp.asarray(data["train.tokens"])}
b, s = batch["tokens"].shape
pspecs = param_specs(cfg, params, mesh)
bspecs = batch_specs(cfg, InputShape("t", s, b, "train"), mesh)
with mesh:
    fn = jax.jit(make_train_step(model, opt),
                 in_shardings=(to_named(pspecs, mesh), None,
                               to_named(bspecs, mesh)))
    stepped, _, metrics = fn(params, opt.init(params), batch)
    _, g = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(params,
                                                                batch)
out["train.loss"] = np.asarray(metrics["loss"])
for i, (leaf, gl) in enumerate(zip(jax.tree.leaves(stepped),
                                   jax.tree.leaves(g))):
    out[f"train.p.{i}"] = np.asarray(leaf)
    out[f"train.g.{i}"] = np.asarray(gl)
np.savez(d + "/ref0.npz", **out)
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
from repro_torch.configs import InputShape
from repro_torch.core.distributed import (PSUM_COUNTS, ordered_pmean,
                                          ordered_psum)
from repro_torch.interop import tree_leaves, tree_map
from repro_torch.launch import lm_ranks
from repro_torch.launch.multiprocess import initialize_from_env
from repro_torch.launch.serve import generate
from repro_torch.launch.sharding import (batch_specs, rank_specs, shard_of,
                                         unshard)
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
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=float(cfg.n_experts) / cfg.top_k)
    return cfg


def whole_params(cfg, tag):
    # tree_leaves' order is the reference's: its leaves in the port's tree
    tree = build_model(cfg).init(torch.Generator().manual_seed(0))
    leaves = tree_leaves(tree)
    by_id = {id(t): torch.from_numpy(data[f"{tag}.{i}"])
             for i, t in enumerate(leaves)}
    return tree_map(lambda t: by_id[id(t)], tree)


def whole_on_model(spec):
    return not any(e == "model" or (isinstance(e, tuple) and "model" in e)
                   for e in spec)


def peers_differ(tree, specs, mesh):
    """How many leaves held whole on "model" differ between the peers."""
    bad = 0
    for leaf, sp in zip(tree_leaves(tree), spec_leaves(specs)):
        if not whole_on_model(sp):
            continue
        all_ = unshard(leaf.detach()[None].contiguous(),
                       ("model",) + (None,) * leaf.dim(), mesh)
        bad += sum(not torch.equal(all_[0], x) for x in all_[1:])
    return bad


def spec_leaves(specs):
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for v in specs for x in spec_leaves(v)]
    return [specs]


def total(x, mesh):
    return float(ordered_psum(torch.tensor(float(x)), mesh,
                              ("data", "model")))


out = {}
for arch in spec["archs"]:
    cfg = cfg_of(arch)
    whole = whole_params(cfg, arch)
    tokens = torch.from_numpy(data[arch + ".tokens"])
    prompt = torch.from_numpy(data[arch + ".prompt"])
    for name, (dp, mp) in spec["meshes"].items():
        tag = f"{arch}.{name}"
        mesh, model = lm_ranks.rank_model(cfg, dp, mp)
        specs = rank_specs(cfg, whole, mesh, model.moe_ep_axis)
        params = lm_ranks.rank_params(model, whole)
        out[tag + ".blocks_bad"] = total(sum(
            tuple(p.shape) != tuple(shard_of(w, sp, mesh).shape)
            for p, w, sp in zip(tree_leaves(params), tree_leaves(whole),
                                spec_leaves(specs))), mesh)
        bspec = batch_specs(cfg, InputShape("t", tokens.shape[1],
                                            tokens.shape[0], "train"),
                            mesh)["tokens"]
        blk = lm_ranks.rank_batch(model, {"tokens": tokens})
        with torch.no_grad():
            logits, _ = model.forward(params, blk)
        out[tag + ".logits"] = unshard(logits, bspec + (None,), mesh).numpy()
        nll = lambda p, b: model.loss(p, b)[1]["nll"]
        g, value = torch.func.grad_and_value(nll)(params, blk)
        local_batch = "model" not in model.batch_axes
        out[tag + ".grad_peers_bad"] = total(
            peers_differ(g, specs, mesh) if local_batch else 0, mesh)
        out[tag + ".nll"] = ordered_pmean(value, mesh,
                                          model.batch_axes).numpy()
        g = tree_map(lambda l: ordered_pmean(l, mesh, model.batch_axes), g)
        g = tree_map(lambda l, s: unshard(l, s, mesh), g, specs)
        for i, leaf in enumerate(tree_leaves(g)):
            out[f"{tag}.g.{i}"] = leaf.numpy()
        res = generate(model, params, lm_ranks.rank_batch(
            model, {"tokens": prompt})["tokens"], spec["gen"])
        out[tag + ".decode"] = unshard(res["tokens"], bspec, mesh).numpy()
        opt = sgd(spec["train_lr"])
        stepped, _, _ = make_train_step(model, opt)(
            params, opt.init(params), blk)
        out[tag + ".step_peers_bad"] = total(
            peers_differ(stepped, specs, mesh), mesh)

cfg = cfg_of(spec["train_arch"])
whole = whole_params(cfg, "train")
mesh, model = lm_ranks.rank_model(cfg, 2, 2)
specs = rank_specs(cfg, whole, mesh)
params = lm_ranks.rank_params(model, whole)
batch = lm_ranks.rank_batch(model, {"tokens": torch.from_numpy(
    data["train.tokens"])})
# remat on the mesh: the gradient bitwise the plain one's; "full" sums the
# recomputed layers' outputs over the peers again, "dots" keeps them
grads, sums = {}, {}
for policy in (None, "full", "dots"):
    m = dataclasses.replace(model, remat=policy is not None,
                            remat_policy=policy or "full")
    before = PSUM_COUNTS["calls"]
    grads[policy] = tree_leaves(torch.func.grad(
        lambda p, b: m.loss(p, b)[0])(params, batch))
    sums[policy] = PSUM_COUNTS["calls"] - before
out["remat.bitwise"] = total(all(
    torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(
        grads[None], grads["full"], grads["dots"])), mesh)
out["remat.sums"] = np.asarray([sums[None], sums["full"], sums["dots"]])
opt = sgd(spec["train_lr"])
stepped, _, metrics = make_train_step(model, opt)(params, opt.init(params),
                                                  batch)
out["train.loss"] = metrics["loss"].numpy()
stepped = tree_map(lambda l, s: unshard(l, s, mesh), stepped, specs)
for i, leaf in enumerate(tree_leaves(stepped)):
    out[f"train.p.{i}"] = leaf.numpy()
if rank == 0:
    np.savez(d + "/port.npz", **out)
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("tensor_parallel")
    rng = np.random.default_rng(11)
    inputs = {}
    for i, arch in enumerate(ARCHS):
        leaves = jax.tree.leaves(j_build_model(_cfg(arch)).init(
            jax.random.PRNGKey(i)))
        inputs.update({f"{arch}.{j}": np.asarray(x)
                       for j, x in enumerate(leaves)})
        vocab = _cfg(arch).vocab
        inputs[arch + ".tokens"] = rng.integers(0, vocab, (B, S)) \
            .astype(np.int32)
        inputs[arch + ".prompt"] = rng.integers(0, vocab, (B, PROMPT)) \
            .astype(np.int32)
    leaves = jax.tree.leaves(j_build_model(_cfg(TRAIN_ARCH)).init(
        jax.random.PRNGKey(100)))
    inputs.update({f"train.{j}": np.asarray(x) for j, x in enumerate(leaves)})
    inputs["train.tokens"] = rng.integers(
        0, _cfg(TRAIN_ARCH).vocab, (TRAIN_B, TRAIN_S)).astype(np.int32)
    np.savez(d / "inputs.npz", **inputs)
    (d / "spec.json").write_text(json.dumps({
        "archs": ARCHS, "meshes": MESHES, "gen": GEN, "ref_parts": REF_PARTS,
        "train_arch": TRAIN_ARCH, "train_lr": TRAIN_LR}))
    ref_env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": f"--xla_force_host_platform_device_count="
                            f"{N_RANKS}"}
    refs = [subprocess.Popen([sys.executable, "-c", _REF, str(d), str(i)],
                             env=ref_env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for i in range(REF_PARTS)]
    try:
        env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
        mp.spawn_local_cluster([sys.executable, "-c", _CHILD, str(d)],
                               N_RANKS, coordinator=f"file://{d}/store",
                               base_env=env, timeout=300)
        logs = [ref.communicate(timeout=300)[0] for ref in refs]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
    for ref, log in zip(refs, logs):
        assert ref.returncode == 0, log
    want = {}
    for i in range(REF_PARTS):
        want.update(np.load(d / f"ref{i}.npz"))
    return dict(np.load(d / "port.npz")), want


CASES = [(arch, mesh) for arch in ARCHS for mesh in sorted(MESHES)]
IDS = [f"{arch}-{mesh}" for arch, mesh in CASES]


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_rank_params_hold_the_param_specs_blocks(world, arch, mesh):
    port, _ = world
    assert float(port[f"{arch}.{mesh}.blocks_bad"]) == 0.0


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_logits_match_the_reference(world, arch, mesh):
    port, ref = world
    got, want = port[f"{arch}.{mesh}.logits"], ref[arch + ".logits"]
    assert got.shape == want.shape == (B, S, _cfg(arch).vocab)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_loss_and_gradients_match_the_reference(world, arch, mesh):
    port, ref = world
    tag = f"{arch}.{mesh}"
    want = float(ref[arch + ".nll"])
    assert abs(float(port[tag + ".nll"]) - want) <= LOSS_REL * abs(want)
    n = sum(1 for k in ref if k.startswith(arch + ".g."))
    assert n == sum(1 for k in port if k.startswith(tag + ".g.")) > 0
    for i in range(n):
        want = ref[f"{arch}.g.{i}"]
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(port[f"{tag}.g.{i}"], want,
                                   atol=GRAD_REL * scale, rtol=0)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_greedy_decode_matches_the_reference(world, arch, mesh):
    port, ref = world
    np.testing.assert_array_equal(port[f"{arch}.{mesh}.decode"],
                                  ref[arch + ".decode"])


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_whole_leaves_are_bitwise_equal_across_model_peers(world, arch,
                                                           mesh):
    """Every leaf held whole on ``"model"``: its gradient (before the mean
    over data; the batch over ``model`` for xlstm makes the peers' differ
    until then) and its weights after one SGD step are bitwise equal on
    every model peer."""
    port, _ = world
    tag = f"{arch}.{mesh}"
    assert float(port[tag + ".grad_peers_bad"]) == 0.0
    assert float(port[tag + ".step_peers_bad"]) == 0.0


def test_sgd_step_on_2x2_matches_the_reference_gspmd_step(world):
    port, ref = world
    want = float(ref["train.loss"])
    assert abs(float(port["train.loss"]) - want) <= LOSS_REL * abs(want)
    n = sum(1 for k in ref if k.startswith("train.p."))
    assert n == sum(1 for k in port if k.startswith("train.p.")) > 0
    for i in range(n):
        want = ref[f"train.p.{i}"]
        scale = max(float(np.abs(ref[f"train.g.{i}"]).max()), 1e-12)
        ulp = float(np.spacing(np.abs(want).max().astype(np.float32)))
        np.testing.assert_allclose(port[f"train.p.{i}"], want,
                                   atol=TRAIN_LR * GRAD_REL * scale + ulp,
                                   rtol=0)


def test_remat_on_the_mesh_is_bitwise_and_dots_keeps_the_sums(world):
    """stablelm-1.6b's smoke config on (2, 2): the loss's gradient with
    ``remat`` ("full" and "dots") is bitwise the plain one's on every rank.
    The plain gradient sums over the model peers 2 x layers + 1 times in
    the forward (attention, MLP, the lookup) and as often in the backward
    (the column splits' inputs, the logits'); "full" recomputes each
    layer's two sums once more, "dots" keeps their outputs and moves
    nothing again."""
    port, _ = world
    layers = _cfg(TRAIN_ARCH).n_layers
    assert float(port["remat.bitwise"]) == float(N_RANKS)
    plain = 2 * (2 * layers + 1)
    assert port["remat.sums"].tolist() == [plain, plain + 2 * layers, plain]
