"""Port's context parallelism on a mesh of ranks (``Model(seq_axis=...)``:
the sequence cut over ``"data"``, K/V gathered by ``collectives.
gather_seq``; decode from a KV cache whose slots are split over ranks)
against the JAX package's unsharded model.

The port's side is one 4-rank gloo world (``spawn_local_cluster``, a
``FileStore`` under the test's temporary directory) whose children import
only ``repro_torch``. For each of four smoke configs, on a (4, 1) mesh
with ``seq_axis="data"`` and a (2, 2) mesh with the sequence over
``"data"`` and the heads, MLP and vocabulary over ``"model"``, at batch 1:

- stablelm-1.6b: every dense rule splits on (2, 2);
- gemma3-4b: sliding windows (cut to 8 here so that they cross the
  ranks' blocks of 8 and 16 positions, and the decode's rolling buffer of
  8 slots splits), tied embeddings;
- qwen2.5-32b: qkv bias, 5 heads (attention whole on every model peer);
- granite-moe-1b-a400m: each MoE layer gathers its input over
  ``"data"`` and routes the whole sequence, drop-free (capacity factor
  E / top_k) here; and at its config's capacity factor 1.25, where slots
  drop, the full loss (nll plus 0.01 x aux) and its gradient against the
  reference's: unsharded on (4, 1) (a batch of one is not cut, so its
  ``shard_map`` routes the whole sequence), and its own (2, 2) mesh run
  (``seq_axis="data"``, the expert-parallel path's two peers routing 16
  tokens each) in a subprocess with 4 XLA host devices.

The reference's side runs in two subprocesses at the same time (the
configs dealt out): the same numpy weights (the reference's init) and
tokens, one device, float32.
Bounds:

- the logits, gathered over the sequence, 2e-5 of the reference's
  ``forward`` (sums in other orders through two layers);
- the nll, the ranks' shares summed, 1e-5 relative; its gradient summed
  over ``"data"`` (as ``launch.steps`` sums it) and ``unshard``-ed 1e-4 of
  each leaf's largest;
- the greedy tokens of ``serve.generate`` (a 5-token prompt, 11 tokens,
  16 slots split over the ranks of ``"data"``) equal to the reference's
  decode loop, and every step's logits along that path 2e-5 of the
  reference's (the tokens alone do not see a skewed combine of the ranks'
  softmaxes at smoke size); zamba2-2.7b without ``seq_axis`` (its
  context parallelism: ``tests/test_torch_context_parallel_state.py``)
  decodes a batch of one with ``global_batch=1``, its
  shared attention's cache split over ``"data"`` at 16 slots (which
  divide) and whole at 15 (which do not), against the reference's too;
- ``gather_seq``'s backward is bitwise this rank's block of the ordered
  sum of the peers' cotangents, and under ``torch.func.vmap`` each lane
  is bitwise its own gather, forward and backward;
- the gathers, counted exactly: one ``gather_seq`` of K and V a layer in
  a forward, of B x S/n x 2 kv x hd x 4 bytes; a gradient adds one
  ``scatter_sum_seq`` a layer; remat "full" gathers again in the
  recomputation, "dots" keeps the gathered K/V (and its gradient is
  bitwise the plain one's);
- one ``make_train_step`` SGD step of stablelm on (2, 2): the loss is the
  reference's 1e-5 relative, each weight lr x the gradient's bound plus
  one float32 spacing of the reference's step, and every leaf held whole
  on ``"model"`` bitwise equal on every rank.

The ``ValueError``s of ``Model(seq_axis=...)``, and the families that now
build under it, need no ranks: a stand-in mesh in this process.
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
from repro_torch.launch import multiprocess as mp  # noqa: E402
from repro_torch.launch.mesh import MuleMesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
ARCHS = ("stablelm-1.6b", "gemma3-4b", "qwen2.5-32b", "granite-moe-1b-a400m")
HYBRID = "zamba2-2.7b"
CAP_ARCH = "granite-moe-1b-a400m"     # also run at its config's capacity
MESHES = {"4x1": (4, 1), "2x2": (2, 2)}
N_RANKS = 4
REF_PARTS = 2        # the reference's processes (the archs dealt out)
S = 32
WINDOW = 8                  # gemma3's local layers, cut from 64
PROMPT, GEN = 5, 11         # 16 slots: they divide 2 and 4
HYBRID_GENS = (11, 10)      # 16 slots and 15 (whole)
COUNT_ARCH = "stablelm-1.6b"
TRAIN_LR = 0.01
LOGIT_TOL = 2e-5
LOSS_REL = 1e-5
GRAD_REL = 1e-4


def _cfg(arch):
    cfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                              dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=float(cfg.n_experts) / cfg.top_k)
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=WINDOW)
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


def cfg_of(arch):
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=float(cfg.n_experts) / cfg.top_k)
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=spec["window"])
    return cfg


def params_of(model, tag):
    tree = jax.tree.structure(jax.eval_shape(model.init,
                                             jax.random.PRNGKey(0)))
    return jax.tree.unflatten(tree, [jnp.asarray(data[f"{tag}.{i}"])
                                     for i in range(tree.num_leaves)])


def decode(model, params, prompt, gen, out, tag):
    b, n = prompt.shape
    cache = model.init_cache(b, n + gen, dtype=jnp.float32)
    step = jax.jit(model.decode_step)
    every = []
    for t in range(n):
        logits, cache = step(params, cache, prompt[:, t:t + 1], t)
        every.append(logits)
    toks = []
    tok = jnp.argmax(logits, axis=-1)[:, None]
    for t in range(n, n + gen):
        toks.append(tok)
        logits, cache = step(params, cache, tok, t)
        every.append(logits)
        tok = jnp.argmax(logits, axis=-1)[:, None]
    out[tag + ".decode"] = np.asarray(jnp.concatenate(toks, axis=1))
    out[tag + ".decode_logits"] = np.asarray(jnp.stack(every))


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
    decode(model, params, jnp.asarray(data[arch + ".prompt"]), spec["gen"],
           out, arch)
    if arch == spec["count_arch"]:
        _, loss_g = jax.jit(jax.value_and_grad(
            lambda p, b: model.loss(p, b)[0]))(params, batch)
        stepped = jax.tree.map(lambda p, g: p - spec["lr"] * g, params,
                               loss_g)
        out["train.loss"] = np.asarray(model.loss(params, batch)[0])
        for i, (p, g) in enumerate(zip(jax.tree.leaves(stepped),
                                       jax.tree.leaves(loss_g))):
            out[f"train.p.{i}"] = np.asarray(p)
            out[f"train.g.{i}"] = np.asarray(g)
if part == spec["ref_parts"] - 1:
    model = build_model(cfg_of(spec["hybrid"]))
    params = params_of(model, spec["hybrid"])
    for gen in spec["hybrid_gens"]:
        decode(model, params, jnp.asarray(data[spec["hybrid"] + ".prompt"]),
               gen, out, f"{spec['hybrid']}.{gen}")
np.savez(f"{d}/ref{part}.npz", **out)
'''


# the MoE at its config's capacity: the full loss and its gradient,
# unsharded and on the reference's own (2, 2) mesh with seq_axis
_REF_CAP = r'''
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.models import build_model

d = sys.argv[1]
spec = json.load(open(d + "/spec.json"))
data = np.load(d + "/inputs.npz")
arch = spec["cap_arch"]
cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
tree = jax.tree.structure(jax.eval_shape(build_model(cfg).init,
                                         jax.random.PRNGKey(0)))
params = jax.tree.unflatten(tree, [jnp.asarray(data[f"{arch}.{i}"])
                                   for i in range(tree.num_leaves)])
batch = {"tokens": jnp.asarray(data[arch + ".tokens"])}
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                         ("data", "model"))
out = {}
for name, kw in (("4x1", {}), ("2x2", dict(mesh=mesh, seq_axis="data"))):
    model = build_model(cfg, **kw)
    with mesh:
        value, g = jax.jit(jax.value_and_grad(
            lambda p, b: model.loss(p, b)[0]))(params, batch)
    out[f"cap.{name}.loss"] = np.asarray(value)
    for i, leaf in enumerate(jax.tree.leaves(g)):
        out[f"cap.{name}.g.{i}"] = np.asarray(leaf)
np.savez(d + "/ref_cap.npz", **out)
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
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.launch.multiprocess import initialize_from_env
from repro_torch.launch.serve import generate
from repro_torch.launch.sharding import rank_specs, unshard
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
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=spec["window"])
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


def spec_leaves(specs):
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for v in specs for x in spec_leaves(v)]
    return [specs]


def decode_logits(model, prompt, toks, params, **kw):
    """Every decode_step's logits along the greedy path (the prompt, then
    the generated tokens), from a fresh cache as generate makes it."""
    seq = torch.cat([prompt, toks], dim=1)
    cache = model.init_cache(seq.shape[0], seq.shape[1], dtype=torch.float32,
                             device="cpu", **kw)
    every = []
    with torch.no_grad():
        for t in range(seq.shape[1]):
            logits, cache = model.decode_step(params, cache, seq[:, t:t + 1],
                                              t)
            every.append(logits)
    return torch.stack(every).numpy()


def kv_slots(cache):
    return [c["k"].shape[-3] for c in cache if "k" in c]


def seq_calls():
    return [coll.COLLECTIVE_COUNTS[k]["calls"]
            for k in ("seq-gather", "seq-scatter")]


out = {}
for arch in spec["archs"]:
    cfg = cfg_of(arch)
    whole = whole_params(cfg, arch)
    tokens = torch.from_numpy(data[arch + ".tokens"])
    prompt = torch.from_numpy(data[arch + ".prompt"])
    for name, (dp, tp) in spec["meshes"].items():
        tag = f"{arch}.{name}"
        mesh, model = lm_ranks.rank_model(cfg, dp, tp, seq_axis="data")
        specs = rank_specs(cfg, whole, mesh)
        params = lm_ranks.rank_params(model, whole)
        blk = lm_ranks.rank_batch(model, {"tokens": tokens})
        with torch.no_grad():
            logits, _ = model.forward(params, blk)
        out[tag + ".logits"] = unshard(logits, (None, "data", None),
                                       mesh).numpy()
        nll = lambda p, b: model.loss(p, b)[1]["nll"]
        g, value = torch.func.grad_and_value(nll)(params, blk)
        out[tag + ".nll"] = ordered_psum(value, mesh, "data").numpy()
        g = tree_map(lambda l, s: unshard(ordered_psum(l, mesh, "data"), s,
                                          mesh), g, specs)
        for i, leaf in enumerate(tree_leaves(g)):
            out[f"{tag}.g.{i}"] = leaf.numpy()
        res = generate(model, params, prompt, spec["gen"])
        out[tag + ".decode"] = res["tokens"].numpy()
        out[tag + ".decode_logits"] = decode_logits(model, prompt,
                                                    res["tokens"], params)
        out[tag + ".slots"] = np.asarray(kv_slots(model.init_cache(
            1, prompt.shape[1] + spec["gen"], device="cpu")))
        if arch != spec["count_arch"]:
            continue
        # the gathers of a forward and of a gradient, with and without
        # remat; and one SGD step through the train step's sum over data
        before = (seq_calls(), coll.COLLECTIVE_COUNTS["seq-gather"][
            "sent_bytes"])
        with torch.no_grad():
            model.forward(params, blk)
        calls = seq_calls()
        out[tag + ".fwd_calls"] = np.asarray(
            [a - b for a, b in zip(calls, before[0])])
        out[tag + ".fwd_bytes"] = np.asarray(coll.COLLECTIVE_COUNTS[
            "seq-gather"]["sent_bytes"] - before[1])
        grads = {}
        for policy in (None, "full", "dots"):
            m = dataclasses.replace(model, remat=policy is not None,
                                    remat_policy=policy or "full")
            before = seq_calls()
            grads[policy] = tree_leaves(torch.func.grad(
                lambda p, b: m.loss(p, b)[0])(params, blk))
            out[f"{tag}.grad_calls.{policy}"] = np.asarray(
                [a - b for a, b in zip(seq_calls(), before)])
        out[tag + ".remat_bitwise"] = total(all(
            torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(
                grads[None], grads["full"], grads["dots"])), mesh)
        opt = sgd(spec["lr"])
        stepped, _, metrics = make_train_step(model, opt)(
            params, opt.init(params), blk)
        out[tag + ".train_loss"] = metrics["loss"].numpy()
        bad = 0
        for leaf, sp in zip(tree_leaves(stepped), spec_leaves(specs)):
            if "model" not in sp:
                # a leaf held whole on "model": the same bits on all ranks
                every = unshard(leaf[None].contiguous(),
                                (("data", "model"),) + (None,) * leaf.dim(),
                                mesh)
                bad += sum(not torch.equal(every[0], x) for x in every[1:])
        out[tag + ".step_bad"] = bad
        stepped = tree_map(lambda l, s: unshard(l, s, mesh), stepped, specs)
        for i, leaf in enumerate(tree_leaves(stepped)):
            out[f"{tag}.p.{i}"] = leaf.numpy()

# the MoE at its config's capacity: the full loss and its gradient
arch = spec["cap_arch"]
cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
whole = whole_params(cfg, arch)
tokens = torch.from_numpy(data[arch + ".tokens"])
for name, (dp, tp) in spec["meshes"].items():
    mesh, model = lm_ranks.rank_model(cfg, dp, tp, seq_axis="data")
    specs = rank_specs(cfg, whole, mesh)
    blk = lm_ranks.rank_batch(model, {"tokens": tokens})
    g, value = torch.func.grad_and_value(lambda p, b: model.loss(p, b)[0])(
        lm_ranks.rank_params(model, whole), blk)
    out[f"cap.{name}.loss"] = ordered_psum(value, mesh, "data").numpy()
    g = tree_map(lambda l, s: unshard(ordered_psum(l, mesh, "data"), s,
                                      mesh), g, specs)
    for i, leaf in enumerate(tree_leaves(g)):
        out[f"cap.{name}.g.{i}"] = leaf.numpy()

# zamba2-2.7b: no seq_axis; a batch of one decoded from caches split over
# data where their slots divide
cfg = cfg_of(spec["hybrid"])
whole = whole_params(cfg, spec["hybrid"])
prompt = torch.from_numpy(data[spec["hybrid"] + ".prompt"])
for name, (dp, tp) in spec["meshes"].items():
    mesh, model = lm_ranks.rank_model(cfg, dp, tp)
    params = lm_ranks.rank_params(model, whole)
    for gen in spec["hybrid_gens"]:
        tag = f"{spec['hybrid']}.{name}.{gen}"
        res = generate(model, params, prompt, gen, global_batch=1)
        out[tag + ".decode"] = res["tokens"].numpy()
        out[tag + ".decode_logits"] = decode_logits(
            model, prompt, res["tokens"], params, global_batch=1)
        out[tag + ".slots"] = np.asarray(kv_slots(model.init_cache(
            1, prompt.shape[1] + gen, device="cpu", global_batch=1)))

# gather_seq's backward: this rank's block of the ordered sum of the
# peers' cotangents
mesh = make_lm_mesh(4, 1)
gen = torch.Generator().manual_seed(5)
xs = [torch.randn(2, 3, 5, generator=gen) for _ in range(4)]
cots = [torch.randn(2, 12, 5, generator=gen) for _ in range(4)]
y, back = torch.func.vjp(lambda x: coll.gather_seq(x, mesh, "data"),
                         xs[rank])
want = cots[0] + cots[1]
for c in cots[2:]:
    want = want + c
out["gather.fwd"] = total(torch.equal(y, torch.cat(xs, dim=1)), mesh)
out["gather.back"] = total(torch.equal(
    back(cots[rank])[0], want[:, 3 * rank:3 * rank + 3]), mesh)
# under vmap (the lanes of a sweep): one transfer, each lane its own
# gather, forward and backward
lanes = torch.randn(3, 2, 3, 5, generator=torch.Generator().manual_seed(
    6 + rank))
lane_cots = torch.randn(3, 2, 12, 5, generator=gen)
y, back = torch.func.vjp(torch.func.vmap(
    lambda x: coll.gather_seq(x, mesh, "data")), lanes)
ones = [torch.func.vjp(lambda x: coll.gather_seq(x, mesh, "data"), lane)
        for lane in lanes]
out["gather.vmap"] = total(
    all(torch.equal(y[i], o[0]) for i, o in enumerate(ones)) and
    all(torch.equal(back(lane_cots)[0][i], o[1](lane_cots[i])[0])
        for i, o in enumerate(ones)), mesh)
if rank == 0:
    np.savez(d + "/port.npz", **out)
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("context_parallel")
    rng = np.random.default_rng(12)
    inputs = {}
    for i, arch in enumerate(ARCHS + (HYBRID,)):
        leaves = jax.tree.leaves(j_build_model(_cfg(arch)).init(
            jax.random.PRNGKey(i)))
        inputs.update({f"{arch}.{j}": np.asarray(x)
                       for j, x in enumerate(leaves)})
        vocab = _cfg(arch).vocab
        inputs[arch + ".tokens"] = rng.integers(0, vocab, (1, S)) \
            .astype(np.int32)
        inputs[arch + ".prompt"] = rng.integers(0, vocab, (1, PROMPT)) \
            .astype(np.int32)
    np.savez(d / "inputs.npz", **inputs)
    (d / "spec.json").write_text(json.dumps({
        "archs": ARCHS, "meshes": MESHES, "gen": GEN, "window": WINDOW,
        "hybrid": HYBRID, "hybrid_gens": HYBRID_GENS,
        "count_arch": COUNT_ARCH, "lr": TRAIN_LR, "ref_parts": REF_PARTS,
        "cap_arch": CAP_ARCH}))
    ref_env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    refs = [subprocess.Popen([sys.executable, "-c", _REF, str(d), str(i)],
                             env=ref_env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for i in range(REF_PARTS)]
    refs.append(subprocess.Popen(
        [sys.executable, "-c", _REF_CAP, str(d)],
        env={**ref_env, "XLA_FLAGS": f"--xla_force_host_platform_device_"
                                     f"count={N_RANKS}"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
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
    want = dict(np.load(d / "ref_cap.npz"))
    for i in range(REF_PARTS):
        want.update(np.load(d / f"ref{i}.npz"))
    return dict(np.load(d / "port.npz")), want


CASES = [(arch, mesh) for arch in ARCHS for mesh in sorted(MESHES)]
IDS = [f"{arch}-{mesh}" for arch, mesh in CASES]


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_logits_match_the_reference(world, arch, mesh):
    port, ref = world
    got, want = port[f"{arch}.{mesh}.logits"], ref[arch + ".logits"]
    assert got.shape == want.shape == (1, S, _cfg(arch).vocab)
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


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_moe_routes_the_whole_sequence_at_its_capacity(world, mesh):
    """granite-moe at its config's capacity factor 1.25, where slots drop:
    routing each rank's block on its own (its own capacity and top-k
    order) would move the loss and the gradient; the whole sequence's
    routing gives the reference's full loss (nll + 0.01 x aux) 1e-5
    relative and its gradient 1e-4 of each leaf's largest, unsharded on
    (4, 1) and its own (2, 2) mesh run."""
    port, ref = world
    tag = f"cap.{mesh}"
    want = float(ref[tag + ".loss"])
    assert abs(float(port[tag + ".loss"]) - want) <= LOSS_REL * abs(want)
    n = sum(1 for k in ref if k.startswith(tag + ".g."))
    assert n == sum(1 for k in port if k.startswith(tag + ".g.")) > 0
    for i in range(n):
        want = ref[f"{tag}.g.{i}"]
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(port[f"{tag}.g.{i}"], want,
                                   atol=GRAD_REL * scale, rtol=0)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_greedy_decode_from_the_split_cache_matches_the_reference(
        world, arch, mesh):
    """Every KV cache's slots split over the ranks of ``"data"`` (16 slots,
    or gemma3's local layers' 8), the tokens the reference's and every
    step's logits within LOGIT_TOL of its."""
    port, ref = world
    ranks = MESHES[mesh][0]
    cfg = _cfg(arch)
    whole = [min(w, PROMPT + GEN) if w else PROMPT + GEN
             for w in _windows(cfg)]
    assert port[f"{arch}.{mesh}.slots"].tolist() == \
        [w // ranks for w in whole]
    np.testing.assert_array_equal(port[f"{arch}.{mesh}.decode"],
                                  ref[arch + ".decode"])
    np.testing.assert_allclose(port[f"{arch}.{mesh}.decode_logits"],
                               ref[arch + ".decode_logits"],
                               atol=LOGIT_TOL, rtol=0)


def _windows(cfg):
    """Each attention stage's window (None: global), in program order."""
    from repro_torch.models.api import build_program
    return [st.window for st in build_program(cfg)
            if st.kind in ("attn", "moe", "shared_attn")]


@pytest.mark.parametrize("gen", HYBRID_GENS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_hybrid_decodes_a_batch_of_one_from_the_split_cache(world, mesh,
                                                            gen):
    """zamba2-2.7b, no ``seq_axis``, ``global_batch=1``: the shared
    attention's cache holds the rank's block of 16 slots, or all 15, and
    the greedy tokens and every step's logits are the reference's (within
    LOGIT_TOL)."""
    port, ref = world
    tag = f"{HYBRID}.{mesh}.{gen}"
    slots, ranks = PROMPT + gen, MESHES[mesh][0]
    want = slots // ranks if slots % ranks == 0 else slots
    assert set(port[tag + ".slots"].tolist()) == {want}
    np.testing.assert_array_equal(port[tag + ".decode"],
                                  ref[f"{HYBRID}.{gen}.decode"])
    np.testing.assert_allclose(port[tag + ".decode_logits"],
                               ref[f"{HYBRID}.{gen}.decode_logits"],
                               atol=LOGIT_TOL, rtol=0)


def test_gather_seq_backward_is_the_ordered_sum_of_the_peers_cotangents(
        world):
    port, _ = world
    assert float(port["gather.fwd"]) == float(N_RANKS)
    assert float(port["gather.back"]) == float(N_RANKS)


def test_gather_seq_under_vmap_is_each_lanes_gather(world):
    port, _ = world
    assert float(port["gather.vmap"]) == float(N_RANKS)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_gathers_are_counted_exactly(world, mesh):
    """A forward gathers K and V once a layer (f32 B x S/n x 2 kv x hd, kv
    the rank's heads); a gradient adds one reduce-scatter a layer; remat
    "full" gathers each layer again, "dots" keeps the gathered K/V, and
    both gradients are bitwise the plain one's on every rank."""
    port, _ = world
    cfg = _cfg(COUNT_ARCH)
    tag = f"{COUNT_ARCH}.{mesh}"
    dp, tp = MESHES[mesh]
    layers = cfg.n_layers
    kv = cfg.n_kv_heads // tp
    assert port[tag + ".fwd_calls"].tolist() == [layers, 0]
    assert int(port[tag + ".fwd_bytes"]) == \
        layers * (S // dp) * 2 * kv * cfg.resolved_head_dim * 4
    assert port[tag + ".grad_calls.None"].tolist() == [layers, layers]
    assert port[tag + ".grad_calls.full"].tolist() == [2 * layers, layers]
    assert port[tag + ".grad_calls.dots"].tolist() == [layers, layers]
    assert float(port[tag + ".remat_bitwise"]) == float(N_RANKS)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sgd_step_sums_the_shares_over_the_sequence(world, mesh):
    port, ref = world
    tag = f"{COUNT_ARCH}.{mesh}"
    want = float(ref["train.loss"])
    assert abs(float(port[tag + ".train_loss"]) - want) <= \
        LOSS_REL * abs(want)
    assert int(port[tag + ".step_bad"]) == 0
    n = sum(1 for k in ref if k.startswith("train.p."))
    assert n == sum(1 for k in port if k.startswith(tag + ".p.")) > 0
    for i in range(n):
        want = ref[f"train.p.{i}"]
        scale = max(float(np.abs(ref[f"train.g.{i}"]).max()), 1e-12)
        ulp = float(np.spacing(np.abs(want).max().astype(np.float32)))
        np.testing.assert_allclose(port[f"{tag}.p.{i}"], want,
                                   atol=TRAIN_LR * GRAD_REL * scale + ulp,
                                   rtol=0)


# ---------------------------------------------------------------------------
# where context parallelism cannot run: a stand-in mesh, no ranks
# ---------------------------------------------------------------------------


def _mesh(shape):
    return MuleMesh(shape=dict(shape), coords={a: 0 for a in shape},
                    groups={}, data_axis=tuple(shape)[-1])


@pytest.mark.parametrize("arch,family", [
    ("zamba2-2.7b", "hybrid"), ("xlstm-350m", "xlstm"),
    ("whisper-base", "audio"), ("qwen2-vl-72b", "vlm")])
def test_seq_axis_builds_where_state_runs_along_the_sequence(arch, family):
    """The carried layers (``mamba``, ``xlstm_pair``) and the ``audio`` and
    ``vlm`` families run under ``seq_axis`` on the whole gathered sequence
    (their parity: ``tests/test_torch_context_parallel_state.py``)."""
    cfg = tconfigs.get_smoke_config(arch)
    model = build_model(cfg, mesh=_mesh({"data": 4, "model": 1}),
                        seq_axis="data", dp_axes=())
    assert (cfg.family, model.seq_axis, model.batch_axes) == \
        (family, "data", ())


@pytest.mark.parametrize("kw", [
    {"seq_axis": "data"},                                  # dp_axes data
    {"seq_axis": "data", "dp_axes": ("data", "model")},    # replicate
    {"seq_axis": "model", "dp_axes": ()},                  # the weights'
    {"seq_axis": "data", "dp_axes": (), "mesh": None},     # no mesh
], ids=["batch-over-data", "population-layout", "model-axis", "no-mesh"])
def test_seq_axis_raises_where_the_batch_or_weights_hold_the_axis(kw):
    cfg = tconfigs.get_smoke_config("stablelm-1.6b")
    kw = {"mesh": _mesh({"data": 2, "model": 2}), **kw}
    with pytest.raises(ValueError, match="seq_axis"):
        build_model(cfg, **kw)
