"""Port's context parallelism through the layers that carry state along the
sequence and through the ``vlm`` and ``audio`` families
(``Model(seq_axis="data")``) on a mesh of ranks, against the JAX package's
unsharded model.

A ``mamba`` layer and an ``xlstm_pair`` gather their input over
``"data"`` (``collectives.gather_seq``), run the scan on the whole
sequence and keep the rank's block; ``qwen2-vl``'s sequence is the whole
embedded one (16 vision positions, then 32 text tokens: 48, so on (4, 1)
rank 0's block is all vision, rank 1's straddles the prefix and the text,
ranks 2-3 are all text); Whisper runs its decoder on the rank's block of
tokens over the whole encoder output.

The port's side is one 4-rank gloo world (``spawn_local_cluster``, a
``FileStore`` under the test's temporary directory) whose children import
only ``repro_torch``. For the smoke configs of zamba2-2.7b, xlstm-350m,
qwen2-vl-72b and whisper-base in float32 at batch 1 and 32 tokens, on a
(4, 1) mesh and a (2, 2) mesh (heads, MLP, SSM heads and vocabulary over
``"model"`` where ``rank_specs`` splits them):

- the logits, gathered over the sequence, 2e-5 of the reference's
  ``forward``;
- the nll, the ranks' shares summed, 1e-5 relative; its gradient summed
  over ``"data"`` and ``unshard``-ed 1e-4 of each leaf's largest;
- on (4, 1), the greedy tokens of ``serve.generate`` (a 5-token prompt, 11
  tokens; zamba2's shared attention's 16 slots and Whisper's self- and
  cross-attention slots split over the ranks, the Mamba2 and xLSTM states
  whole on each) equal to the reference's decode loop, and every step's
  logits 2e-5 of its;
- the gathers, counted exactly: one ``gather_seq`` a ``mamba`` or
  ``xlstm_pair`` layer a forward, of B x S/n x D x 4 bytes, and one of K
  and V an attention layer, of B x S/n x 2 kv x hd x 4 bytes (kv the
  rank's heads); a gradient adds one ``scatter_sum_seq`` for each; remat
  "full" gathers again in the recomputation, "dots" keeps the gathers,
  and both gradients are bitwise the plain one's (zamba2 and xlstm);
- one ``make_train_step`` SGD step of zamba2 on (2, 2) leaves every leaf
  held whole on ``"model"`` bitwise equal on every rank.

The reference's side runs in two subprocesses at the same time (the archs
dealt out): the same numpy weights (the reference's init), tokens and
stub embeddings, one device, float32.

``lm_ranks.rank_batch``'s blocks of a ``vlm`` and an ``audio`` batch need
no ranks: a stand-in mesh in this process.
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
from repro_torch.launch import lm_ranks  # noqa: E402
from repro_torch.launch import multiprocess as mp  # noqa: E402
from repro_torch.launch.mesh import stand_in_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
ARCHS = ("zamba2-2.7b", "xlstm-350m", "qwen2-vl-72b", "whisper-base")
MESHES = {"4x1": (4, 1), "2x2": (2, 2)}
DECODE_MESH = "4x1"
REMAT_ARCHS = ("zamba2-2.7b", "xlstm-350m")
STEP_ARCH, STEP_MESH = "zamba2-2.7b", "2x2"
N_RANKS = 4
REF_PARTS = 2
T = 32                      # text tokens (qwen2-vl: 16 vision positions too)
PROMPT, GEN = 5, 11         # 16 slots: they divide 4
LR = 0.01
LOGIT_TOL = 2e-5
LOSS_REL = 1e-5
GRAD_REL = 1e-4


def _cfg(configs, arch):
    return dataclasses.replace(configs.get_smoke_config(arch),
                               dtype="float32")


def _extra(cfg, rng, b):
    """The stub embeddings of a batch of ``b`` rows: ``vision_embed`` or
    ``audio_embed``, 0.1 x normal, float32."""
    if cfg.family == "vlm":
        return {"vision_embed": (0.1 * rng.normal(
            size=(b, cfg.vision_tokens, cfg.d_model))).astype(np.float32)}
    if cfg.family == "audio":
        return {"audio_embed": (0.1 * rng.normal(
            size=(b, cfg.encoder_seq, cfg.d_model))).astype(np.float32)}
    return {}


# ---------------------------------------------------------------------------
# the reference's side: one process, unsharded
# ---------------------------------------------------------------------------

_REF = r'''
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.models import build_model

d, part = sys.argv[1], int(sys.argv[2])
spec = json.load(open(d + "/spec.json"))
data = np.load(d + "/inputs.npz")
out = {}
for arch in spec["archs"][part::spec["ref_parts"]]:
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    model = build_model(cfg)
    tree = jax.tree.structure(jax.eval_shape(model.init,
                                             jax.random.PRNGKey(0)))
    params = jax.tree.unflatten(tree, [jnp.asarray(data[f"{arch}.{i}"])
                                       for i in range(tree.num_leaves)])
    batch = {k: jnp.asarray(data[f"{arch}.{k}"])
             for k in ("tokens", "vision_embed", "audio_embed")
             if f"{arch}.{k}" in data.files}

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
    if cfg.family == "audio":
        cache = model.prefill_cross_kv(
            params, jnp.asarray(data[arch + ".prompt_audio"]), cache)
    step = jax.jit(model.decode_step)
    every = []
    for t in range(n):
        logits, cache = step(params, cache, prompt[:, t:t + 1], t)
        every.append(logits)
    toks = []
    tok = jnp.argmax(logits, axis=-1)[:, None]
    for t in range(n, n + spec["gen"]):
        toks.append(tok)
        logits, cache = step(params, cache, tok, t)
        every.append(logits)
        tok = jnp.argmax(logits, axis=-1)[:, None]
    out[arch + ".decode"] = np.asarray(jnp.concatenate(toks, axis=1))
    out[arch + ".decode_logits"] = np.asarray(jnp.stack(every))
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
from repro_torch.core.distributed import ordered_psum
from repro_torch.interop import tree_leaves, tree_map
from repro_torch.launch import collectives as coll
from repro_torch.launch import lm_ranks
from repro_torch.launch.multiprocess import initialize_from_env
from repro_torch.launch.serve import generate
from repro_torch.launch.sharding import rank_specs, unshard
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import sgd

torch.set_num_threads(1)
assert initialize_from_env()
d = sys.argv[1]
spec = json.load(open(d + "/spec.json"))
data = np.load(d + "/inputs.npz")
EXTRA = ("vision_embed", "audio_embed")


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


def seq_counts():
    c = coll.COLLECTIVE_COUNTS
    return np.asarray([c["seq-gather"]["calls"], c["seq-scatter"]["calls"],
                       c["seq-gather"]["sent_bytes"]])


def decode_logits(model, params, prompt, toks, audio):
    """Every decode_step's logits along the greedy path (the prompt, then
    the generated tokens), from a fresh cache as generate makes it."""
    seq = torch.cat([prompt, toks], dim=1)
    cache = model.init_cache(seq.shape[0], seq.shape[1], dtype=torch.float32,
                             device="cpu")
    every = []
    with torch.no_grad():
        if audio is not None:
            cache = model.prefill_cross_kv(params, audio, cache)
        for t in range(seq.shape[1]):
            logits, cache = model.decode_step(params, cache, seq[:, t:t + 1],
                                              t)
            every.append(logits)
    return torch.stack(every).numpy()


out = {}
for arch in spec["archs"]:
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    whole = whole_params(cfg, arch)
    batch = {k: torch.from_numpy(data[f"{arch}.{k}"])
             for k in ("tokens",) + EXTRA if f"{arch}.{k}" in data.files}
    for name, (dp, tp) in spec["meshes"].items():
        tag = f"{arch}.{name}"
        mesh, model = lm_ranks.rank_model(cfg, dp, tp, seq_axis="data")
        specs = rank_specs(cfg, whole, mesh)
        params = lm_ranks.rank_params(model, whole)
        blk = lm_ranks.rank_batch(model, batch)
        before = seq_counts()
        with torch.no_grad():
            logits, _ = model.forward(params, blk)
        out[tag + ".fwd"] = seq_counts() - before
        out[tag + ".logits"] = unshard(logits, (None, "data", None),
                                       mesh).numpy()
        nll = lambda p, b: model.loss(p, b)[1]["nll"]
        before = seq_counts()
        g, value = torch.func.grad_and_value(nll)(params, blk)
        out[tag + ".grad"] = seq_counts() - before
        out[tag + ".nll"] = ordered_psum(value, mesh, "data").numpy()
        plain = tree_leaves(g)
        g = tree_map(lambda l, s: unshard(ordered_psum(l, mesh, "data"), s,
                                          mesh), g, specs)
        for i, leaf in enumerate(tree_leaves(g)):
            out[f"{tag}.g.{i}"] = leaf.numpy()
        if arch in spec["remat_archs"]:
            # the gathers inside the remat body: "full" gathers again,
            # "dots" keeps them; the gradients bitwise the plain one's
            same = True
            for policy in ("full", "dots"):
                m = dataclasses.replace(model, remat=True,
                                        remat_policy=policy)
                before = seq_counts()
                got = tree_leaves(torch.func.grad(
                    lambda p, b: m.loss(p, b)[1]["nll"])(params, blk))
                out[f"{tag}.grad.{policy}"] = seq_counts() - before
                same &= all(torch.equal(a, b) for a, b in zip(plain, got))
            out[tag + ".remat_bitwise"] = total(same, mesh)
        if name == spec["decode_mesh"]:
            prompt = torch.from_numpy(data[arch + ".prompt"])
            audio = (torch.from_numpy(data[arch + ".prompt_audio"])
                     if cfg.family == "audio" else None)
            res = generate(model, params, prompt, spec["gen"],
                           audio_embed=audio)
            out[tag + ".decode"] = res["tokens"].numpy()
            out[tag + ".decode_logits"] = decode_logits(
                model, params, prompt, res["tokens"], audio)
            if audio is not None:      # the slots of a rank's caches
                cache = model.init_cache(
                    1, prompt.shape[1] + spec["gen"], device="meta")
                out[tag + ".slots"] = np.asarray(
                    [cache["self_k"].shape[2], cache["cross_k"].shape[2]])
        if (arch, name) == tuple(spec["step"]):
            opt = sgd(spec["lr"])
            stepped, _, _ = make_train_step(model, opt)(
                params, opt.init(params), blk)
            bad = 0
            for leaf, sp in zip(tree_leaves(stepped), spec_leaves(specs)):
                if "model" not in sp:
                    every = unshard(leaf[None].contiguous(),
                                    (("data", "model"),)
                                    + (None,) * leaf.dim(), mesh)
                    bad += sum(not torch.equal(every[0], x)
                               for x in every[1:])
            out[tag + ".step_bad"] = bad
if dist.get_rank() == 0:
    np.savez(d + "/port.npz", **out)
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("context_parallel_state")
    rng = np.random.default_rng(33)
    inputs = {}
    for i, arch in enumerate(ARCHS):
        cfg = _cfg(jconfigs, arch)
        leaves = jax.tree.leaves(j_build_model(cfg).init(
            jax.random.PRNGKey(i)))
        inputs.update({f"{arch}.{j}": np.asarray(x)
                       for j, x in enumerate(leaves)})
        inputs[arch + ".tokens"] = rng.integers(0, cfg.vocab, (1, T)) \
            .astype(np.int32)
        inputs[arch + ".prompt"] = rng.integers(0, cfg.vocab, (1, PROMPT)) \
            .astype(np.int32)
        inputs.update({f"{arch}.{k}": v for k, v in _extra(cfg, rng, 1)
                       .items()})
        if cfg.family == "audio":
            inputs[arch + ".prompt_audio"] = _extra(cfg, rng, 1)[
                "audio_embed"]
    np.savez(d / "inputs.npz", **inputs)
    (d / "spec.json").write_text(json.dumps({
        "archs": ARCHS, "meshes": MESHES, "gen": GEN, "lr": LR,
        "ref_parts": REF_PARTS, "decode_mesh": DECODE_MESH,
        "remat_archs": REMAT_ARCHS, "step": [STEP_ARCH, STEP_MESH]}))
    ref_env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
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
def test_logits_match_the_reference(world, arch, mesh):
    port, ref = world
    cfg = _cfg(tconfigs, arch)
    got, want = port[f"{arch}.{mesh}.logits"], ref[arch + ".logits"]
    assert got.shape == want.shape == (1, cfg.vision_tokens + T, cfg.vocab)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_matches_the_reference(world, arch):
    """A batch of one on (4, 1) under ``seq_axis``: zamba2's shared
    attention's 16 slots and Whisper's self- and cross-attention slots
    split over the ranks (``cache_specs``' blocks), the carried states
    whole on each; the tokens the reference's and every step's logits
    within LOGIT_TOL of its."""
    port, ref = world
    tag = f"{arch}.{DECODE_MESH}"
    if arch == "whisper-base":
        cfg, n = _cfg(tconfigs, arch), MESHES[DECODE_MESH][0]
        assert port[tag + ".slots"].tolist() == [
            (PROMPT + GEN) // n, cfg.encoder_seq // n]
    np.testing.assert_array_equal(port[tag + ".decode"],
                                  ref[arch + ".decode"])
    np.testing.assert_allclose(port[tag + ".decode_logits"],
                               ref[arch + ".decode_logits"],
                               atol=LOGIT_TOL, rtol=0)


def _gathers(cfg, dp, tp):
    """(calls, bytes) of one forward's ``gather_seq``s on a rank: a
    ``mamba`` or ``xlstm_pair`` layer's input, an attention layer's K and
    V (the rank's kv heads), f32 at batch 1."""
    from repro_torch.models.api import build_program
    m = (cfg.vision_tokens + T) // dp
    kv = cfg.n_kv_heads
    if cfg.family not in ("xlstm", "audio") and kv % tp == 0:
        kv //= tp
    width = {"mamba": cfg.d_model, "xlstm_pair": cfg.d_model,
             "attn": 2 * kv * cfg.resolved_head_dim}
    width["shared_attn"] = width["attn"]
    if cfg.family == "audio":        # the decoder's self-attention
        layers = [width["attn"]] * cfg.n_layers
    else:
        layers = [width[st.kind] for st in build_program(cfg)
                  for _ in range(st.count)]
    return len(layers), sum(layers) * m * 4


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_gathers_are_counted_exactly(world, arch, mesh):
    """One ``gather_seq`` a layer in a forward, of the bytes ``_gathers``
    counts; a gradient adds one ``scatter_sum_seq`` for each; remat "full"
    gathers each layer again, "dots" keeps the gathers, and both gradients
    are bitwise the plain one's on every rank."""
    port, _ = world
    tag = f"{arch}.{mesh}"
    calls, sent = _gathers(_cfg(tconfigs, arch), *MESHES[mesh])
    assert port[tag + ".fwd"].tolist() == [calls, 0, sent]
    assert port[tag + ".grad"].tolist() == [calls, calls, sent]
    if arch in REMAT_ARCHS:
        assert port[tag + ".grad.full"].tolist() == [2 * calls, calls,
                                                     2 * sent]
        assert port[tag + ".grad.dots"].tolist() == [calls, calls, sent]
        assert float(port[tag + ".remat_bitwise"]) == float(N_RANKS)


def test_sgd_step_keeps_whole_leaves_equal_on_every_rank(world):
    port, _ = world
    assert int(port[f"{STEP_ARCH}.{STEP_MESH}.step_bad"]) == 0


# ---------------------------------------------------------------------------
# the rank's block of a batch: a stand-in mesh, no ranks
# ---------------------------------------------------------------------------


# mesh shape and the batch's axes under seq_axis="data"
LAYOUTS = {"4x1": ({"data": 4, "model": 1}, ()),
           "2x2-rows": ({"data": 2, "model": 2}, ("model",))}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "whisper-base"])
def test_rank_batches_rebuild_the_whole_sequence(arch, layout):
    """Each rank's ``rank_batch`` block: for ``vlm`` its embedded rows
    (``_embed`` of its ``vision_embed`` rows and its tokens) and its
    M-RoPE ``positions``, concatenated over ``"data"``, are the whole
    batch's, the vision prefix crossing blocks; for ``audio`` its tokens so,
    and its ``audio_embed`` the whole sequence of frames of its rows."""
    shape, dp_axes = LAYOUTS[layout]
    cfg = _cfg(tconfigs, arch)
    rng = np.random.default_rng(7)
    b = 2
    whole = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, T)).astype(np.int32))}
    whole.update({k: torch.from_numpy(v)
                  for k, v in _extra(cfg, rng, b).items()})
    s = cfg.vision_tokens + T
    if cfg.family == "vlm":
        whole["positions"] = torch.from_numpy(
            rng.integers(0, 99, (3, b, s)).astype(np.int32))
    one = build_model(cfg)
    params = one.init(torch.Generator().manual_seed(0))
    n_data, n_model = shape["data"], shape["model"]
    rows = b // n_model if dp_axes else b
    for mi in range(n_model):
        lo = mi * rows if dp_axes else 0
        blocks = []
        for di in range(n_data):
            mesh = stand_in_mesh(shape, di * n_model + mi)
            model = build_model(cfg, mesh=mesh, seq_axis="data",
                                dp_axes=dp_axes)
            blk = lm_ranks.rank_batch(model, whole)
            blocks.append(blk)
            if cfg.family == "audio":
                assert torch.equal(blk["audio_embed"],
                                   whole["audio_embed"][lo:lo + rows])
        if cfg.family == "vlm":
            got = torch.cat([one._embed(params, k["tokens"], k)
                             for k in blocks], dim=1)
            want = one._embed(params, whole["tokens"], whole)[lo:lo + rows]
            assert got.shape == (rows, s, cfg.d_model)
            assert torch.equal(got, want)
            assert torch.equal(
                torch.cat([k["positions"] for k in blocks], dim=2),
                whole["positions"][:, lo:lo + rows])
        else:
            assert torch.equal(torch.cat([k["tokens"] for k in blocks],
                                         dim=1),
                               whole["tokens"][lo:lo + rows])
