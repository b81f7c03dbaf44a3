"""Port's decode caches as the reference's ``cache_specs`` lays them out,
on a mesh of ranks, against the JAX package's unsharded decode.

``launch.sharding.kv_cache_cut`` executes ``cache_specs``' rule: the kv
heads over ``"model"`` where they divide, else ``head_dim``; the slots
over the data axes for a batch that does not divide them. Each rank holds
that block of every KV cache (``Model.init_cache`` /
``WhisperModel.init_cache`` with ``global_batch``) and decodes from it:
on a ``head_dim`` block the partial scores are summed over ``"model"``
in rank order and the output's blocks gathered; Whisper's self- and
cross-attention caches (its weights whole) cut by heads gather the heads'
outputs; over cut slots the ranks' partial softmaxes are combined.

The port's side is one 4-rank gloo world (``spawn_local_cluster``, a
``FileStore`` under the test's temporary directory) whose children import
only ``repro_torch``. Smoke configs in float32, a 5-token prompt replayed
through ``serve.generate`` and 11 greedy tokens (16 slots):

- granite-34b (6 heads on one kv head of 32) on (1, 2) (``wq`` split: 3
  heads a rank, q gathered) and (1, 4) (``wq`` whole), ``head_dim`` cut;
- qwen2.5-32b (5 heads on one kv head, QKV bias) on (1, 4), ``head_dim``;
- gemma3-4b (4 heads on 2 kv heads) on (1, 4), ``head_dim``, its sliding
  window narrowed to 8 slots so that the rolling buffer wraps;
- whisper-base (4 heads) at batch 1 on (4, 1) (self and cross slots over
  data), on (2, 2) (2 heads a rank, slots over data), and at batch 4 on
  (1, 4) (one head a rank); a Whisper variant with 2 kv heads of 64 at
  batch 3 on (1, 4), ``head_dim``. (``cache_specs`` takes the first
  dimension equal to the batch for the batch: at a batch equal to the
  smoke Whisper's 2 layers it would read the layer axis as the batch.)

Each case must give the reference's greedy tokens on every rank, every
step's logits within 2e-5 of the reference's, every KV leaf of every
rank's cache the shape of ``shard_of(whole, cache_specs(...))`` (the
reference's spec on its whole cache), and the sums and gathers of a
decode step, counted on every rank, exactly those the layout implies.

The reference's side runs in two subprocesses at the same time as the
ranks: the same numpy weights (the reference's init), prompts and stub
audio frames, one device, float32.
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
from repro.launch import sharding as jsh  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import multiprocess as mp  # noqa: E402
from repro_torch.launch.mesh import MuleMesh  # noqa: E402
from repro_torch.launch.sharding import shard_of  # noqa: E402

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
N_RANKS = 4
REF_PARTS = 2
PROMPT, GEN = 5, 11         # 16 slots: they divide 2 and 4
LOGIT_TOL = 2e-5
# the reference's models: arch, config overrides, batch
MODELS = {"granite": ("granite-34b", {}, 1),
          "qwen": ("qwen2.5-32b", {}, 1),
          "gemma": ("gemma3-4b", {"sliding_window": 8}, 1),
          "whisper1": ("whisper-base", {}, 1),
          "whisper4": ("whisper-base", {}, 4),
          "whisper_kv2": ("whisper-base", {"n_heads": 2, "n_kv_heads": 2,
                                           "head_dim": 64}, 3)}
# case: (the reference's model, (data, model))
CASES = {"granite-1x2": ("granite", (1, 2)),
         "granite-1x4": ("granite", (1, 4)),
         "qwen-1x4": ("qwen", (1, 4)),
         "gemma-1x4": ("gemma", (1, 4)),
         "whisper1-4x1": ("whisper1", (4, 1)),
         "whisper1-2x2": ("whisper1", (2, 2)),
         "whisper4-1x4": ("whisper4", (1, 4)),
         "whisper_kv2-1x4": ("whisper_kv2", (1, 4))}


def _cfg(configs, model):
    arch, over, _ = MODELS[model]
    return dataclasses.replace(configs.get_smoke_config(arch),
                               dtype="float32", **over)


# ---------------------------------------------------------------------------
# the reference's side: unsharded decode loops
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
for name in sorted(spec["models"])[part::spec["ref_parts"]]:
    arch, over, b = spec["models"][name]
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="float32", **over)
    model = build_model(cfg)
    tree = jax.tree.structure(jax.eval_shape(model.init,
                                             jax.random.PRNGKey(0)))
    params = jax.tree.unflatten(tree, [jnp.asarray(data[f"{name}.{i}"])
                                       for i in range(tree.num_leaves)])
    prompt = jnp.asarray(data[name + ".prompt"])
    n = prompt.shape[1]
    cache = model.init_cache(b, n + spec["gen"], dtype=jnp.float32)
    if cfg.family == "audio":
        cache = model.prefill_cross_kv(
            params, jnp.asarray(data[name + ".audio"]), cache)
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
    out[name + ".decode"] = np.asarray(jnp.concatenate(toks, axis=1))
    out[name + ".decode_logits"] = np.asarray(jnp.stack(every))
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
from repro_torch.core.distributed import PSUM_COUNTS
from repro_torch.interop import tree_leaves, tree_map
from repro_torch.launch import collectives as coll
from repro_torch.launch import lm_ranks
from repro_torch.launch.multiprocess import initialize_from_env
from repro_torch.launch.serve import generate
from repro_torch.models import build_model

torch.set_num_threads(1)
assert initialize_from_env()
rank = dist.get_rank()
d = sys.argv[1]
spec = json.load(open(d + "/spec.json"))
data = np.load(d + "/inputs.npz")


def whole_params(cfg, tag):
    # tree_leaves' order is the reference's: its leaves in the port's tree
    tree = build_model(cfg).init(torch.Generator().manual_seed(0))
    by_id = {id(t): torch.from_numpy(data[f"{tag}.{i}"])
             for i, t in enumerate(tree_leaves(tree))}
    return tree_map(lambda t: by_id[id(t)], tree)


def flat(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in flat(v, path + (i,))]
    return [("/".join(str(p) for p in path), tree)]


def moved():
    g = coll.COLLECTIVE_COUNTS["all-gather"]
    return np.asarray([PSUM_COUNTS["calls"], PSUM_COUNTS["part_bytes"],
                       g["calls"], g["sent_bytes"]])


out, shapes = {}, {}
for case, (name, (dp, tp)) in sorted(spec["cases"].items()):
    arch, over, b = spec["models"][name]
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="float32", **over)
    mesh, model = lm_ranks.rank_model(cfg, dp, tp,
                                      ranks=list(range(dp * tp)))
    if mesh is None:
        continue
    params = lm_ranks.rank_params(model, whole_params(cfg, name))
    rows = b // dp if b % dp == 0 else b
    lo = mesh.axis_index("data") * rows if b % dp == 0 else 0
    prompt = torch.from_numpy(data[name + ".prompt"])[lo:lo + rows]
    audio = (torch.from_numpy(data[name + ".audio"])[lo:lo + rows]
             if cfg.family == "audio" else None)
    res = generate(model, params, prompt, spec["gen"], audio_embed=audio,
                   global_batch=b)
    tag = f"{case}.{rank}"
    out[tag + ".decode"] = res["tokens"].numpy()
    # every step's logits along the greedy path, from a fresh cache as
    # generate makes it, and what the steps moved
    seq = torch.cat([prompt, res["tokens"]], dim=1)
    cache = model.init_cache(rows, seq.shape[1], dtype=torch.float32,
                             device="cpu", global_batch=b)
    shapes[tag] = {k: list(v.shape) for k, v in flat(cache)}
    every = []
    with torch.no_grad():
        if audio is not None:
            cache = model.prefill_cross_kv(params, audio, cache)
        before = moved()
        for t in range(seq.shape[1]):
            logits, cache = model.decode_step(params, cache, seq[:, t:t + 1],
                                              t)
            every.append(logits)
        out[tag + ".moved"] = moved() - before
    out[tag + ".decode_logits"] = torch.stack(every).numpy()
np.savez(f"{d}/port{rank}.npz", **out)
json.dump(shapes, open(f"{d}/shapes{rank}.json", "w"))
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("cache_layout")
    rng = np.random.default_rng(34)
    inputs = {}
    for i, name in enumerate(sorted(MODELS)):
        cfg = _cfg(jconfigs, name)
        b = MODELS[name][2]
        leaves = jax.tree.leaves(j_build_model(cfg).init(
            jax.random.PRNGKey(i)))
        inputs.update({f"{name}.{j}": np.asarray(x)
                       for j, x in enumerate(leaves)})
        inputs[name + ".prompt"] = rng.integers(
            0, cfg.vocab, (b, PROMPT)).astype(np.int32)
        if cfg.family == "audio":
            inputs[name + ".audio"] = (0.1 * rng.normal(
                size=(b, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    np.savez(d / "inputs.npz", **inputs)
    (d / "spec.json").write_text(json.dumps({
        "models": MODELS, "cases": CASES, "gen": GEN,
        "ref_parts": REF_PARTS}))
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
    want, port, shapes = {}, {}, {}
    for i in range(REF_PARTS):
        want.update(np.load(d / f"ref{i}.npz"))
    for r in range(N_RANKS):
        port.update(np.load(d / f"port{r}.npz"))
        shapes.update(json.loads((d / f"shapes{r}.json").read_text()))
    return port, want, shapes


def _ranks(case):
    dp, tp = CASES[case][1]
    return range(dp * tp)


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_decode_matches_the_reference(world, case):
    """The reference's greedy tokens on every rank, and every step's
    logits (the prompt's, then each generated token's) within LOGIT_TOL
    of its unsharded decode's."""
    port, ref, _ = world
    name = CASES[case][0]
    for r in _ranks(case):
        np.testing.assert_array_equal(port[f"{case}.{r}.decode"],
                                      ref[name + ".decode"])
        np.testing.assert_allclose(port[f"{case}.{r}.decode_logits"],
                                   ref[name + ".decode_logits"],
                                   atol=LOGIT_TOL, rtol=0)


def _rank_mesh(shape, rank):
    coords, left = {}, rank
    for axis in reversed(list(shape)):
        coords[axis], left = left % shape[axis], left // shape[axis]
    return MuleMesh(shape=dict(shape), coords=coords, groups={},
                    data_axis="model")


class _Mesh:
    """What the reference's rules read of a mesh: sizes and names."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cache_leaves_are_the_cache_specs_blocks(world, case):
    """Every KV leaf of every rank's cache has the shape of its block of
    the reference's whole cache under the reference's ``cache_specs``, the
    same leaves as the reference's, the whole slot count beside the
    slots where they are cut."""
    _, _, shapes = world
    name, (dp, tp) = CASES[case]
    b = MODELS[name][2]
    jm = j_build_model(_cfg(jconfigs, name))
    whole = jax.eval_shape(lambda: jm.init_cache(b, PROMPT + GEN))
    shape = {"data": dp, "model": tp}
    flat, _ = jax.tree_util.tree_flatten_with_path(whole)
    specs = jax.tree.leaves(jsh.cache_specs(_cfg(jconfigs, name), whole, b,
                                            _Mesh(shape)),
                            is_leaf=lambda x: isinstance(x, jax.sharding
                                                         .PartitionSpec))
    for r in _ranks(case):
        got = shapes[f"{case}.{r}"]
        kv = 0
        for (path, leaf), spec in zip(flat, specs):
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path)
            want = shard_of(torch.empty(leaf.shape, device="meta"),
                            tuple(spec), _rank_mesh(shape, r)).shape
            assert got[key] == list(want), (r, key, tuple(spec))
            kv += len(leaf.shape) >= 4
        extra = sorted(set(got) - {"/".join(
            str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
            for path, _ in flat})
        assert all(k.endswith("slots") for k in extra), extra
        assert kv > 0


def _moved(cfg, dp, tp, b, s):
    """(sums, their bytes, gathers, their bytes) of one decode step on a
    rank, f32, from the layout: the vocabulary's sum and gather (LM), then
    per attention layer the q gather (``head_dim`` cut under a split
    ``wq``), the scores' sum and the output's gather (``head_dim`` cut),
    the partial softmaxes' gather (slots cut), the heads' outputs' gather
    (Whisper, heads cut), the output projection's and the MLP's sums
    (weights split)."""
    from repro_torch.models.api import build_program
    hd, heads, kv, d = (cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads,
                        cfg.d_model)
    audio = cfg.family == "audio"
    by_heads = tp > 1 and kv % tp == 0
    by_dim = tp > 1 and not by_heads and hd % tp == 0
    sums, gathers = [], []

    def attn(slots, q_split):
        n = dp if dp > 1 and b % dp and slots % dp == 0 else 1
        m = slots // n
        hq, hdr = (heads // tp, hd) if by_heads else \
            (heads, hd // tp) if by_dim else (heads, hd)
        if by_dim and q_split:
            gathers.append(b * heads // tp * hd)
        if by_dim:
            sums.append(b * heads * m)
        if n > 1:
            gathers.append(b * hq * (2 + hdr))
        if by_dim:
            gathers.append(b * heads * hdr)
        if audio and by_heads:
            gathers.append(b * hq * hd)
        if q_split:
            sums.append(b * d)

    if audio:
        for _ in range(cfg.n_layers):
            attn(s, False)
            attn(cfg.encoder_seq, False)
    else:
        if tp > 1 and cfg.vocab % tp == 0:
            sums.append(b * d)
            gathers.append(b * cfg.vocab // tp)
        for st in build_program(cfg):
            for _ in range(st.count):
                attn(s if st.window is None else min(st.window, s),
                     tp > 1 and heads % tp == 0)
                if tp > 1 and cfg.d_ff % tp == 0:
                    sums.append(b * d)
    return [len(sums), 4 * sum(sums), len(gathers), 4 * sum(gathers)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_sums_and_gathers_are_counted_exactly(world, case):
    """What the replay's 16 decode steps moved on each rank: 16 times
    ``_moved``'s step, in count and bytes."""
    port, _, _ = world
    name, (dp, tp) = CASES[case]
    b = MODELS[name][2]
    rows = b // dp if b % dp == 0 else b
    want = [(PROMPT + GEN) * x for x in _moved(
        _cfg(tconfigs, name), dp, tp, rows, PROMPT + GEN)]
    for r in _ranks(case):
        assert port[f"{case}.{r}.moved"].tolist() == want, r
