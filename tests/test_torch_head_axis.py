"""Port's ``head_axis`` (attention on the rank's padded block of heads
where the head count does not divide ``"model"``) and the Mamba2 mixer
split inside its heads, on a mesh of ranks, against the JAX package's
model at ``head_axis="model"`` under its own GSPMD mesh.

The port's side is one 4-rank gloo world (``spawn_local_cluster``, a
``FileStore`` under the test's temporary directory) whose children import
only ``repro_torch``. Each rank holds its ``rank_specs`` blocks
(``lm_ranks.rank_params``) and its block of the batch:

- ``qwen``: qwen2.5-32b's smoke config (5 heads, 1 kv head, qkv bias) on
  (1, 4) with ``head_axis="model"``: blocks of 2 / 2 / 1 / 0 heads, so
  one rank runs none;
- ``gqa``: the same with 6 query and 3 kv heads of 32 (blocks 2 / 2 / 2 /
  0, each reading one kv head) on (1, 4);
- ``straddle``: the same with 10 query and 2 kv heads of 32 (groups of 5,
  blocks 3 / 3 / 3 / 1) on (1, 4): rank 1's heads 3-5 read kv heads 0, 0,
  1, a block that straddles groups unevenly (``kv_take``'s list);
- ``mixer``: zamba2-2.7b's smoke config with ``d_model`` 96 and
  ``ssm_head_dim`` 64 (3 SSM heads; the shared attention at head_dim 32)
  on (1, 4): 48 channels a rank straddle heads, scanned as sub-heads of
  16;
- ``stablelm``: stablelm-1.6b's smoke config on (1, 4), where the heads
  divide: ``head_axis="model"`` bitwise the path without it;
- ``qwen`` on (2, 2) with ``seq_axis="data"`` too (blocks 3 / 2);
- ``wide``: ``qwen`` with ``d_model`` 1024 (so FSDP cuts the attention's
  leaves over ``data``) on (2, 2) with ``fsdp=True``.

The reference's side runs in two subprocesses with 4 XLA host devices at
the same time (the configs dealt out): ``build_model(cfg,
head_axis="model")`` jitted under its (1, 4) mesh with ``param_specs`` as
``in_shardings``, on the same numpy weights (the reference's init) and
tokens, float32. Bounds:

- the logits, gathered, 2e-5 of the reference's (sums in other orders
  through two layers);
- the nll 1e-5 relative; its gradient (averaged over the batch's axes,
  summed over ``seq_axis``, ``unshard``-ed) 1e-4 of each leaf's largest;
- the greedy tokens of ``serve.generate`` (a 3-token prompt, 6 tokens)
  equal to the reference's decode loop (decode takes no ``head_axis``);
- bitwise: every leaf held whole on ``"model"`` has the same gradient on
  every model peer, and the same weights on every rank after one
  ``make_train_step`` SGD step; ``stablelm``'s logits and gradient with
  ``head_axis`` those without; ``wide``'s logits and SGD step with FSDP
  those without;
- the sums over ranks, counted: ``head_axis`` adds one a layer to the
  forward (the attention's partial output) and one to the backward (the
  input's and the whole weights' cotangents in one transfer).

The ``ValueError``s and the padded blocks need no ranks: a stand-in mesh
in this process.
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
from repro_torch.launch.mesh import stand_in_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import head_block  # noqa: E402

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
N_RANKS = 4
REF_PARTS = 2
B, S = 4, 16
PROMPT, GEN = 3, 6
LR = 0.01
LOGIT_TOL = 2e-5
LOSS_REL = 1e-5
GRAD_REL = 1e-4

# config name: (arch, overrides)
CFGS = {
    "qwen": ("qwen2.5-32b", {}),
    "gqa": ("qwen2.5-32b", dict(n_heads=6, n_kv_heads=3, head_dim=32)),
    "straddle": ("qwen2.5-32b", dict(n_heads=10, n_kv_heads=2,
                                     head_dim=32)),
    "mixer": ("zamba2-2.7b", dict(d_model=96, ssm_head_dim=64,
                                  head_dim=32)),
    "stablelm": ("stablelm-1.6b", {}),
    "wide": ("qwen2.5-32b", dict(d_model=1024, head_dim=32)),
}
# case: (config, (data, model), Model keywords)
CASES = {
    "qwen-1x4": ("qwen", (1, 4), {}),
    "gqa-1x4": ("gqa", (1, 4), {}),
    "straddle-1x4": ("straddle", (1, 4), {}),
    "mixer-1x4": ("mixer", (1, 4), {}),
    "stablelm-1x4": ("stablelm", (1, 4), {}),
    "qwen-seq-2x2": ("qwen", (2, 2), {"seq_axis": "data"}),
    "wide-fsdp-2x2": ("wide", (2, 2), {"fsdp": True}),
}
DECODED = ("qwen-1x4", "gqa-1x4", "straddle-1x4", "mixer-1x4")


def _cfg(configs, name):
    arch, kw = CFGS[name]
    return dataclasses.replace(configs.get_smoke_config(arch),
                               dtype="float32", **kw)


# ---------------------------------------------------------------------------
# the reference's side: subprocesses with 4 host devices
# ---------------------------------------------------------------------------

_REF = r'''
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.launch.sharding import param_specs, to_named
from repro.models import build_model

d, part = sys.argv[1], int(sys.argv[2])
spec = json.load(open(d + "/spec.json"))
data = np.load(d + "/inputs.npz")
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(1, 4),
                         ("data", "model"))
out = {}
for name in sorted(spec["cfgs"])[part::spec["ref_parts"]]:
    arch, kw = spec["cfgs"][name]
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="float32", **kw)
    model = build_model(cfg, head_axis="model")
    tree = jax.tree.structure(jax.eval_shape(model.init,
                                             jax.random.PRNGKey(0)))
    params = jax.tree.unflatten(tree, [jnp.asarray(data[f"{name}.{i}"])
                                       for i in range(tree.num_leaves)])
    batch = {"tokens": jnp.asarray(data[name + ".tokens"])}

    def nll(p, b):
        return model.loss(p, b)[1]["nll"], model.forward(p, b)[0]

    with mesh:
        fn = jax.jit(jax.value_and_grad(nll, has_aux=True),
                     in_shardings=(to_named(param_specs(cfg, params, mesh),
                                            mesh), None))
        (value, logits), g = fn(params, batch)
    out[name + ".logits"] = np.asarray(logits)
    out[name + ".nll"] = np.asarray(value)
    for i, leaf in enumerate(jax.tree.leaves(g)):
        out[f"{name}.g.{i}"] = np.asarray(leaf)
    prompt = jnp.asarray(data[name + ".prompt"])
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
    out[name + ".decode"] = np.asarray(jnp.concatenate(toks, axis=1))
np.savez(f"{d}/ref{part}.npz", **out)
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
from repro_torch.launch.sharding import batch_specs, rank_specs, unshard
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import sgd

torch.set_num_threads(1)
assert initialize_from_env()
d = sys.argv[1]
spec = json.load(open(d + "/spec.json"))
data = np.load(d + "/inputs.npz")


def cfg_of(name):
    arch, kw = spec["cfgs"][name]
    return dataclasses.replace(configs.get_smoke_config(arch),
                               dtype="float32", **kw)


def whole_params(cfg, name):
    # tree_leaves' order is the reference's: its leaves in the port's tree
    tree = build_model(cfg).init(torch.Generator().manual_seed(0))
    by_id = {id(t): torch.from_numpy(data[f"{name}.{i}"])
             for i, t in enumerate(tree_leaves(tree))}
    return tree_map(lambda t: by_id[id(t)], tree)


def spec_leaves(specs):
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for v in specs for x in spec_leaves(v)]
    return [specs]


def whole_on_model(sp):
    return not any(e == "model" or (isinstance(e, tuple) and "model" in e)
                   for e in sp)


def peers_differ(tree, specs, mesh):
    """How many leaves held whole on "model" differ between the peers."""
    bad = 0
    for leaf, sp in zip(tree_leaves(tree), spec_leaves(specs)):
        if not whole_on_model(sp):
            continue
        every = unshard(leaf.detach()[None].contiguous(),
                        ("model",) + (None,) * leaf.dim(), mesh)
        bad += sum(not torch.equal(every[0], x) for x in every[1:])
    return bad


def total(x, mesh):
    return float(ordered_psum(torch.tensor(float(x)), mesh,
                              ("data", "model")))


def sums(fn):
    before = PSUM_COUNTS["calls"]
    out = fn()
    return out, PSUM_COUNTS["calls"] - before


out = {}
for case, (name, (dp, tp), kw) in spec["cases"].items():
    cfg = cfg_of(name)
    whole = whole_params(cfg, name)
    tokens = torch.from_numpy(data[name + ".tokens"])
    runs = {}
    for axis in ("model", None):
        mesh, model = lm_ranks.rank_model(cfg, dp, tp, head_axis=axis, **kw)
        params = lm_ranks.rank_params(model, whole)
        blk = lm_ranks.rank_batch(model, {"tokens": tokens})
        with torch.no_grad():
            logits, fwd = sums(lambda: model.forward(params, blk)[0])
        nll = lambda p, b: model.loss(p, b)[1]["nll"]
        (g, value), both = sums(
            lambda: torch.func.grad_and_value(nll)(params, blk))
        runs[axis] = (mesh, model, params, blk, logits, g, value, fwd, both)
    mesh, model, params, blk, logits, g, value, fwd, both = runs["model"]
    specs = rank_specs(cfg, whole, mesh, model.moe_ep_axis,
                       fsdp=model.fsdp)
    out[case + ".sums"] = np.asarray([fwd, both - fwd, runs[None][7],
                                      runs[None][8] - runs[None][7]])
    out[case + ".same_as_without"] = total(
        torch.equal(logits, runs[None][4]) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(g),
                                              tree_leaves(runs[None][5]))),
        mesh)
    if model.seq_axis is not None:
        out[case + ".logits"] = unshard(logits, (None, "data", None),
                                        mesh).numpy()
        out[case + ".nll"] = ordered_psum(value, mesh, "data").numpy()
        g = tree_map(lambda l, s: unshard(ordered_psum(l, mesh, "data"), s,
                                          mesh), g, specs)
    else:
        bspec = batch_specs(cfg, InputShape("t", *tokens.shape[::-1],
                                            "train"),
                            mesh)["tokens"]
        out[case + ".logits"] = unshard(logits, bspec + (None,),
                                        mesh).numpy()
        out[case + ".nll"] = ordered_pmean(value, mesh,
                                           model.batch_axes).numpy()
        out[case + ".grad_peers_bad"] = total(peers_differ(g, specs, mesh),
                                              mesh)
        # an FSDP leaf's gradient is summed over data by the gather's
        # backward already (launch.steps divides it)
        g = tree_map(lambda l, dm: l / mesh.axis_size("data")
                     if dm is not None else
                     ordered_pmean(l, mesh, model.batch_axes), g,
                     model.fsdp_dims or tree_map(lambda l: None, g))
        g = tree_map(lambda l, s: unshard(l, s, mesh), g, specs)
    for i, leaf in enumerate(tree_leaves(g)):
        out[f"{case}.g.{i}"] = leaf.numpy()
    if case in spec["decoded"]:
        prompt = torch.from_numpy(data[name + ".prompt"])
        res = generate(model, params, prompt, spec["gen"])
        out[case + ".decode"] = res["tokens"].numpy()
    opt = sgd(spec["lr"])
    stepped, _, _ = make_train_step(model, opt)(params, opt.init(params),
                                                blk)
    out[case + ".step_peers_bad"] = total(
        peers_differ(stepped, rank_specs(cfg, whole, mesh,
                                         model.moe_ep_axis), mesh)
        if not model.fsdp else 0, mesh)
    if model.fsdp:
        # against the same step without FSDP, gathered back over data
        plain = dataclasses.replace(model, fsdp=False)
        pp = lm_ranks.rank_params(plain, whole)
        want, _, _ = make_train_step(plain, opt)(pp, opt.init(pp), blk)
        got = tree_map(lambda l, s: unshard(l, s, mesh), stepped, specs)
        want = tree_map(lambda l, s: unshard(l, s, mesh), want, rank_specs(
            cfg, whole, mesh, model.moe_ep_axis))
        with torch.no_grad():
            lp = plain.forward(pp, blk)[0]
        out[case + ".fsdp_bitwise"] = total(torch.equal(lp, logits) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                              tree_leaves(want))), mesh)
if dist.get_rank() == 0:
    np.savez(d + "/port.npz", **out)
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("head_axis")
    rng = np.random.default_rng(13)
    inputs = {}
    for i, name in enumerate(CFGS):
        cfg = _cfg(jconfigs, name)
        leaves = jax.tree.leaves(j_build_model(cfg).init(
            jax.random.PRNGKey(i)))
        inputs.update({f"{name}.{j}": np.asarray(x)
                       for j, x in enumerate(leaves)})
        inputs[name + ".tokens"] = rng.integers(0, cfg.vocab, (B, S)) \
            .astype(np.int32)
        inputs[name + ".prompt"] = rng.integers(0, cfg.vocab, (B, PROMPT)) \
            .astype(np.int32)
    np.savez(d / "inputs.npz", **inputs)
    (d / "spec.json").write_text(json.dumps({
        "cfgs": CFGS, "cases": CASES, "decoded": DECODED, "gen": GEN,
        "lr": LR, "ref_parts": REF_PARTS}))
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


IDS = sorted(CASES)


def _name(case):
    return CASES[case][0]


@pytest.mark.parametrize("case", IDS)
def test_logits_match_the_reference(world, case):
    port, ref = world
    got, want = port[case + ".logits"], ref[_name(case) + ".logits"]
    assert got.shape == want.shape == (B, S, _cfg(tconfigs,
                                                  _name(case)).vocab)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("case", IDS)
def test_loss_and_gradients_match_the_reference(world, case):
    port, ref = world
    name = _name(case)
    want = float(ref[name + ".nll"])
    assert abs(float(port[case + ".nll"]) - want) <= LOSS_REL * abs(want)
    n = sum(1 for k in ref if k.startswith(name + ".g."))
    assert n == sum(1 for k in port if k.startswith(case + ".g.")) > 0
    for i in range(n):
        want = ref[f"{name}.g.{i}"]
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(port[f"{case}.g.{i}"], want,
                                   atol=GRAD_REL * scale, rtol=0)


@pytest.mark.parametrize("case", DECODED)
def test_greedy_decode_matches_the_reference(world, case):
    port, ref = world
    np.testing.assert_array_equal(port[case + ".decode"],
                                  ref[_name(case) + ".decode"])


@pytest.mark.parametrize("case", [c for c in IDS if "seq" not in c])
def test_whole_leaves_are_bitwise_equal_across_model_peers(world, case):
    """Every leaf held whole on ``"model"`` (the attention's, where the
    heads do not divide): its gradient and, after one SGD step, its
    weights are bitwise equal on every model peer (for ``wide``, its FSDP
    blocks' step is held to the unsharded one instead)."""
    port, _ = world
    if "fsdp" not in case:
        assert float(port[case + ".grad_peers_bad"]) == 0.0
    assert float(port[case + ".step_peers_bad"]) == 0.0


def test_head_axis_is_the_split_path_where_the_heads_divide(world):
    """stablelm's 4 heads on 4 ranks: ``wq`` is split already, so the
    logits and the gradient are bitwise those without ``head_axis``, with
    the same sums."""
    port, _ = world
    assert float(port["stablelm-1x4.same_as_without"]) == float(N_RANKS)
    fwd, bwd, fwd0, bwd0 = port["stablelm-1x4.sums"].tolist()
    assert (fwd, bwd) == (fwd0, bwd0)


@pytest.mark.parametrize("case", ["qwen-1x4", "gqa-1x4", "straddle-1x4",
                                  "qwen-seq-2x2"])
def test_head_axis_adds_one_sum_a_layer_each_way(world, case):
    """Where the heads do not divide: without ``head_axis`` every peer
    runs the whole attention with no sum; with it, the partial outputs
    are summed once a layer in the forward and the input's and the whole
    weights' cotangents once a layer in the backward."""
    port, _ = world
    layers = _cfg(tconfigs, _name(case)).n_layers
    fwd, bwd, fwd0, bwd0 = port[case + ".sums"].tolist()
    assert fwd == fwd0 + layers
    assert bwd == bwd0 + layers


def test_fsdp_with_head_axis_is_bitwise_the_unsharded_step(world):
    """``wide`` on (2, 2): the attention's leaves cut over ``data`` are
    gathered to their whole ``fsdp=False`` blocks before the head block is
    taken: the logits and one SGD step's weights bitwise those without
    FSDP on every rank."""
    port, _ = world
    assert float(port["wide-fsdp-2x2.fsdp_bitwise"]) == float(N_RANKS)


# ---------------------------------------------------------------------------
# in this process: the blocks and the errors
# ---------------------------------------------------------------------------


def _mesh(model, data=1):
    return stand_in_mesh({"data": data, "model": model})


@pytest.mark.parametrize("heads,n,want", [
    (40, 16, [3] * 13 + [1, 0, 0]),      # qwen2.5-32b on the production 16
    (40, 3, [14, 14, 12]),
    (5, 4, [2, 2, 1, 0]),
    (6, 4, [2, 2, 2, 0]),
    (10, 4, [3, 3, 3, 1]),
    (8, 16, [1] * 8 + [0] * 8),          # gemma3-4b on the production 16
])
def test_head_blocks_are_gspmds_padded_blocks(heads, n, want):
    cfg = dataclasses.replace(tconfigs.get_smoke_config("qwen2.5-32b"),
                              n_heads=heads, n_kv_heads=1)
    blocks = [head_block(cfg, stand_in_mesh({"data": 1, "model": n}, r),
                         "model") for r in range(n)]
    assert [b[1] for b in blocks] == want
    assert [b[0] for b in blocks] == [min(r * want[0], heads)
                                      for r in range(n)]


def test_head_blocks_are_none_where_head_axis_changes_nothing():
    cfg = tconfigs.get_smoke_config("qwen2.5-32b")
    assert head_block(cfg, _mesh(4), None) is None
    assert head_block(cfg, None, "model") is None
    assert head_block(cfg, _mesh(1), "model") is None
    assert head_block(cfg, _mesh(5), "model") is None      # 5 heads divide


@pytest.mark.parametrize("arch,kw", [
    ("qwen2.5-32b", {"head_axis": "data"}),                # not the weights'
    ("qwen2.5-32b", {"head_axis": "heads", "mesh": None}),
    ("qwen2.5-32b", {"head_axis": "model",
                     "dp_axes": ("data", "model")}),       # replicate
    ("xlstm-350m", {"head_axis": "model"}),                # REPLICATED_ARCHS
    ("whisper-base", {"head_axis": "model"}),
])
def test_head_axis_raises_where_it_cannot_run(arch, kw):
    kw = {"mesh": _mesh(4), **kw}
    with pytest.raises(ValueError, match="head_axis"):
        build_model(tconfigs.get_smoke_config(arch), **kw)


def test_head_axis_without_a_mesh_is_a_no_op():
    cfg = dataclasses.replace(tconfigs.get_smoke_config("qwen2.5-32b"),
                              dtype="float32")
    plain = build_model(cfg)
    params = plain.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = plain.forward(params, {"tokens": toks})[0]
        got = build_model(cfg, head_axis="model").forward(
            params, {"tokens": toks})[0]
    assert torch.equal(got, want)
