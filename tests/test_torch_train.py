"""Port's LM training path against the JAX package: the optimizers and
schedules, ``make_train_step`` (with microbatches), the flash backward,
``make_lm_dataset``, checkpoints, the launcher and the LM population
example; and the three kernel ops' autograd and vmap rules on the CPU.

Models run at smoke size in float32 (``dtype="float32"``), the reference at
its default ``backend="ref"`` (the port's ops take their plain versions on
the CPU). Weights come from the reference's ``Model.init``, tokens from a
numpy seed. Bounds:

- optimizers and schedules 1e-6 over 5 updates (float32 formulas in the
  same order; XLA's float32 division on the CPU is not correctly rounded);
- the train step's loss 1e-5 relative, each gradient leaf 1e-4 of its
  max-abs (sums in another order through a few layers), parameters after 3
  Adam steps 1e-5 where every step's gradient is resolved (at least 1e-2
  of its leaf's largest, so its float32 noise is a small part of it):
  Adam divides each element's step by the root of its second moment, so
  an element whose gradient sits near the noise can take a step of either
  sign, up to ``lr`` a step; those are held to ``2 lr`` a step, and at most
  one element in a thousand may be more than 1e-5 apart;
- the flash backward 1e-5 against ``jax.grad`` of ``flash_reference``;
- ``make_lm_dataset`` and checkpoints bitwise;
- a vmapped op's lanes 1e-6 of their single calls (the CPU's batched
  products may block differently; on the card ``chip_smoke.py`` holds the
  kernels' lanes bitwise).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.checkpoint import restore_checkpoint as j_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro.data import make_lm_dataset as j_lm_dataset  # noqa: E402
from repro.kernels.flash_attention.ref import flash_reference as j_flash  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.checkpoint import (latest_checkpoint,  # noqa: E402
                                    restore_checkpoint, save_checkpoint)
from repro_torch.data import make_lm_dataset  # noqa: E402
from repro_torch.interop import (to_numpy, tree_from_numpy,  # noqa: E402
                                 tree_leaves, tree_map)
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_backward)
from repro_torch.kernels.slstm_fused import (slstm_reference,  # noqa: E402
                                             slstm_scan_op)
from repro_torch.kernels.ssm_scan import (ssd_chunked_reference,  # noqa: E402
                                          ssd_scan_op)
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ARCHS = ["stablelm-1.6b", "gemma3-4b", "zamba2-2.7b", "xlstm-350m",
         "granite-moe-1b-a400m", "whisper-base", "qwen2-vl-72b"]
OPT_TOL = 1e-6
LOSS_REL = 1e-5
GRAD_REL = 1e-4
PARAM_TOL = 1e-5
ADAM_RESOLVED = 1e-2
FLASH_TOL = 1e-5
LANE_TOL = 1e-6


def _np(tree):
    return [np.asarray(to_numpy(x) if isinstance(x, torch.Tensor) else x,
                       np.float32) for x in tree_leaves(tree)]


def _jleaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


# ---------------------------------------------------------------------------
# optimizers, schedules, clipping
# ---------------------------------------------------------------------------


def _tree(rng):
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rng.normal(size=(5,)).astype(np.float32)},
            "l": [rng.normal(size=(2,)).astype(np.float32),
                  rng.normal(size=(2, 2)).astype(np.float32)]}


OPTS = {
    "sgd": lambda o: o.sgd(0.1),
    "sgd-momentum": lambda o: o.sgd(o.linear_schedule(0.1, 5, warmup=1),
                                    momentum=0.9),
    "nesterov": lambda o: o.sgd(0.05, momentum=0.9, nesterov=True),
    "adam": lambda o: o.adam(o.cosine_schedule(1e-2, 5, warmup=2)),
    "adamw": lambda o: o.adamw(o.cosine_schedule(1e-2, 5, warmup=2,
                                                 final_frac=0.1)),
}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_matches_the_reference_over_5_updates(name):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jo, to = OPTS[name](joptim), OPTS[name](toptim)
    jp, tp = jax.tree.map(jnp.asarray, params), tree_from_numpy(params, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(5):
        g = _tree(rng)
        jp, js = jo.update(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = to.update(tp, tree_from_numpy(g, "cpu"), ts)
        for got, want in zip(_np(tp), _jleaves(jp)):
            np.testing.assert_allclose(got, want, atol=OPT_TOL, rtol=OPT_TOL)
    assert int(ts["step"]) == int(js["step"]) == 5
    assert ts["step"].dtype == torch.int32
    for k in ("m", "v", "mu"):
        if k in js:
            for got, want in zip(_np(ts[k]), _jleaves(js[k])):
                np.testing.assert_allclose(got, want, atol=OPT_TOL,
                                           rtol=OPT_TOL)


@pytest.mark.parametrize("kind", ["cosine", "cosine-floor", "linear"])
def test_schedule_matches_the_reference(kind):
    make = {"cosine": lambda o: o.cosine_schedule(3e-4, 10, warmup=3),
            "cosine-floor": lambda o: o.cosine_schedule(1.0, 7, warmup=0,
                                                        final_frac=0.2),
            "linear": lambda o: o.linear_schedule(0.5, 9, warmup=2)}[kind]
    jf, tf = make(joptim), make(toptim)
    for s in range(13):
        want = float(jf(jnp.int32(s)))
        got = float(tf(torch.tensor(s, dtype=torch.int32)))
        assert abs(got - want) <= OPT_TOL * max(1.0, abs(want)), (s, got,
                                                                 want)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    g = _tree(np.random.default_rng(1))
    jc, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                        max_norm)
    tc, tn = toptim.clip_by_global_norm(tree_from_numpy(g, "cpu"), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=OPT_TOL)
    for got, want in zip(_np(tc), _jleaves(jc)):
        np.testing.assert_allclose(got, want, atol=OPT_TOL, rtol=OPT_TOL)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _models(arch):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               dtype="float32")
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tconfigs.ModelConfig(**dataclasses.asdict(jcfg)))
    return jm, jp, tm, tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(cfg, b=2, s=12, seed=5):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)) \
        .astype(np.int32)


def _batches(cfg, toks, seed=6):
    """(JAX batch, port batch) of ``toks`` with the stubs' inputs from a
    numpy seed: ``audio_embed`` for ``audio``, a ``vision_embed`` prefix
    for ``vlm`` (0.1 x normal)."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": toks}
    if cfg.family == "audio":
        arrays["audio_embed"] = 0.1 * rng.normal(
            size=(toks.shape[0], cfg.encoder_seq, cfg.d_model))
    if cfg.family == "vlm":
        arrays["vision_embed"] = 0.1 * rng.normal(
            size=(toks.shape[0], cfg.vision_tokens, cfg.d_model))
    arrays = {k: v.astype(np.float32) if k != "tokens" else v
              for k, v in arrays.items()}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _assert_grads_close(got, want):
    for g, w in zip(_np(got), _jleaves(want)):
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g, w, atol=GRAD_REL * scale, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch):
    """Loss and every gradient leaf of one step, then the parameters after
    three Adam steps of ``make_train_step``."""
    jm, jp, tm, tp = _models(arch)
    j_grad = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))
    jb, tb = _batches(jm.cfg, _tokens(jm.cfg))
    (jl, _), jg = j_grad(jp, jb)
    tg, (tl, _) = torch.func.grad_and_value(tm.loss, has_aux=True)(tp, tb)
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    assert len(tree_leaves(tg)) == len(jax.tree.leaves(jg))
    _assert_grads_close(tg, jg)
    if jm.cfg.n_experts:
        # the router's gradient flows through the gates and the aux loss,
        # every expert's through the dispatch's gathers
        for name, g in tg["stages"][0]["moe"].items():
            per = g.reshape(g.shape[0], -1).abs().amax(1) if name == \
                "router" else g.flatten(2).abs().amax(2)
            assert bool((per > 0).all()), name

    lr, n_steps = 1e-3, 3
    jo = joptim.adam(joptim.cosine_schedule(lr, n_steps, warmup=1))
    to = toptim.adam(toptim.cosine_schedule(lr, n_steps, warmup=1))
    jstep = jax.jit(j_make_train_step(jm, jo))
    tstep = make_train_step(tm, to)
    js, ts = jo.init(jp), to.init(tp)
    # the smallest |gradient| of each element over the steps, over its leaf's
    # largest: where it sits near the gradients' float32 noise, Adam's
    # division by the root second moment decides the step's size and sign
    resolved = None
    for i in range(n_steps):
        b, tb = _batches(jm.cfg, _tokens(jm.cfg, seed=10 + i), seed=20 + i)
        g = [np.abs(x) / max(float(np.abs(x).max()), 1e-30)
             for x in _jleaves(j_grad(jp, b)[1])]
        resolved = g if resolved is None else [np.minimum(r, x) for r, x
                                               in zip(resolved, g)]
        jp, js, jmet = jstep(jp, js, b)
        tp, ts, tmet = tstep(tp, ts, tb)
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= \
            LOSS_REL * abs(float(jmet["loss"]))
    n_apart = 0
    for got, want, r in zip(_np(tp), _jleaves(jp), resolved):
        sure = r >= ADAM_RESOLVED
        np.testing.assert_allclose(got[sure], want[sure], atol=PARAM_TOL,
                                   rtol=0)
        gap = np.abs(got - want)[~sure]
        assert (gap <= 2 * lr * n_steps).all()
        n_apart += int((gap > PARAM_TOL).sum())
    assert n_apart <= 1e-3 * sum(x.size for x in resolved)


def test_train_step_with_microbatches_matches_the_reference():
    jm, jp, tm, tp = _models("stablelm-1.6b")
    jo, to = joptim.sgd(0.1), toptim.sgd(0.1)
    toks = _tokens(jm.cfg, b=4)
    jp2, _, jmet = j_make_train_step(jm, jo, microbatches=2)(
        jp, jo.init(jp), {"tokens": jnp.asarray(toks)})
    tp2, _, tmet = make_train_step(tm, to, microbatches=2)(
        tp, to.init(tp), {"tokens": torch.from_numpy(toks)})
    assert set(tmet) == {"loss"}
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= \
        LOSS_REL * abs(float(jmet["loss"]))
    for got, want in zip(_np(tp2), _jleaves(jp2)):
        np.testing.assert_allclose(got, want, atol=PARAM_TOL, rtol=0)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(tm, to, microbatches=3)(
            tp, to.init(tp), {"tokens": torch.from_numpy(toks)})


# ---------------------------------------------------------------------------
# the flash backward and the kernel ops' rules
# ---------------------------------------------------------------------------

# (b, s, sk, h, kv, d, causal, window)
FLASH_GRAD_CASES = [(2, 24, 24, 4, 2, 16, True, None),
                    (1, 40, 40, 4, 4, 8, True, 7),
                    (2, 20, 20, 6, 2, 16, False, None),
                    (1, 33, 33, 2, 1, 32, True, None)]


@pytest.mark.parametrize("case", FLASH_GRAD_CASES,
                         ids=["causal-gqa", "window", "bidirectional-gqa",
                              "ragged-mqa"])
def test_flash_backward_matches_jax_grad(case):
    b, s, sk, h, kv, d, causal, window = case
    rng = np.random.default_rng(s)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, kv, d)).astype(np.float32)
    do = rng.normal(size=(b, s, h, d)).astype(np.float32)
    blocks = dict(block_q=16, block_k=16)
    _, vjp = jax.vjp(lambda q_, k_, v_: j_flash(q_, k_, v_, causal=causal,
                                                window=window, **blocks),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = flash_backward(*(torch.from_numpy(x) for x in (q, k, v, do)),
                         causal=causal, window=window, **blocks)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FLASH_TOL,
                                   rtol=FLASH_TOL)
    # the op's autograd rule is that backward, at the plain blocks of 256
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    _, vjp256 = jax.vjp(lambda q_, k_, v_: j_flash(
        q_, k_, v_, causal=causal, window=window, block_q=256, block_k=256),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, w in zip(grads, vjp256(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FLASH_TOL,
                                   rtol=FLASH_TOL)


def _op_cases():
    """(name, op(per-lane tensors), per-lane inputs [L, ...]) of the three
    ops, each input drawn for 3 lanes."""
    g = torch.Generator().manual_seed(0)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    lanes = 3
    flash = (lambda q, k, v: flash_attention(q, k, v, causal=True,
                                             window=None),
             [rn(lanes, 2, 10, 4, 8), rn(lanes, 2, 10, 2, 8),
              rn(lanes, 2, 10, 2, 8)])
    ssd = (lambda x, dt, a, bm, cm: ssd_scan_op(x, dt, a, bm, cm, 4),
           [rn(lanes, 2, 10, 3, 4), torch.rand(lanes, 2, 10, 3,
                                               generator=g) * 0.5,
            -torch.rand(lanes, 3, generator=g) - 0.5, rn(lanes, 2, 10, 5),
            rn(lanes, 2, 10, 5)])
    slstm = (lambda pre, r: slstm_scan_op(pre, r),
             [rn(lanes, 2, 9, 4, 3, 4), rn(lanes, 4, 3, 4, 4, scale=0.3)])
    return {"flash_attention": flash, "ssd_scan": ssd, "slstm_scan": slstm}


@pytest.mark.parametrize("name", ["flash_attention", "ssd_scan",
                                  "slstm_scan"])
def test_kernel_op_gradients_under_vmap_are_each_lanes(name):
    """Every kernel-wrapped op has a ``grad_fn``; under
    ``vmap(grad(...))`` (how ``population_step`` trains) each lane gets its
    single-call gradient, the op called once for all lanes; the gradient is
    the plain version's."""
    op, inputs = _op_cases()[name]

    def loss(*xs):
        return (op(*xs) ** 2).sum()

    argnums = tuple(range(len(inputs)))
    lane_grads = torch.func.vmap(torch.func.grad(loss, argnums=argnums))(
        *inputs)
    for i in range(inputs[0].shape[0]):
        one = [x[i].clone().requires_grad_() for x in inputs]
        out = op(*one)
        assert out.grad_fn is not None
        single = torch.autograd.grad((out ** 2).sum(), one)
        for got, want in zip(lane_grads, single):
            torch.testing.assert_close(got[i], want, atol=LANE_TOL,
                                       rtol=LANE_TOL)
    # the plain version's own gradient, through autograd
    plain = {"flash_attention": None,
             "ssd_scan": lambda *xs: ssd_chunked_reference(*xs, chunk=4)[0],
             "slstm_scan": lambda pre, r: slstm_reference(pre, r)[0]}[name]
    if plain is not None:
        one = [x[0].clone().requires_grad_() for x in inputs]
        want = torch.autograd.grad((plain(*one) ** 2).sum(), one)
        for got, w in zip(lane_grads, want):
            torch.testing.assert_close(got[0], w, atol=LANE_TOL,
                                       rtol=LANE_TOL)


def test_ssd_per_row_a_equals_separate_calls():
    """A [B, H] (the vmap rule's folded lanes) gives each row the scan of
    its own A."""
    op, inputs = _op_cases()["ssd_scan"]
    x, dt, a, bm, cm = (t[0] for t in inputs)
    rows = torch.stack([a, a * 2.0])
    got = ssd_chunked_reference(x, dt, rows, bm, cm, chunk=4)[0]
    for r in range(2):
        want = ssd_chunked_reference(x[r:r + 1], dt[r:r + 1], rows[r],
                                     bm[r:r + 1], cm[r:r + 1], chunk=4)[0]
        torch.testing.assert_close(got[r:r + 1], want, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# data, checkpoints, the launcher and the example
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [(0, 10, 16, 50, 8), (3, 7, 5, 1000, 3)])
def test_make_lm_dataset_is_the_reference_bitwise(args):
    got = make_lm_dataset(*args)
    want = j_lm_dataset(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A checkpoint the reference writes restores in the port bitwise (and
    the other way), with the same file names and metadata."""
    jm, jp, tm, tp = _models("zamba2-2.7b")
    path = j_save(str(tmp_path / "j"), 7, jp, metadata={"updated_at": 7})
    template = tree_map(torch.zeros_like, tp)
    got, meta = restore_checkpoint(path, template)
    assert meta == {"updated_at": 7, "step": 7}
    for g, w in zip(_np(got), _jleaves(jp)):
        np.testing.assert_array_equal(g, w)
    mine = save_checkpoint(str(tmp_path / "t"), 7, tp,
                           metadata={"updated_at": 7})
    assert os.path.basename(mine) == os.path.basename(path)
    assert sorted(np.load(mine).files) == sorted(np.load(path).files)
    back, meta2 = j_restore(mine, jp)
    assert meta2 == meta
    for g, w in zip(_jleaves(back), _jleaves(jp)):
        np.testing.assert_array_equal(g, w)
    assert latest_checkpoint(str(tmp_path / "t")) == mine
    assert latest_checkpoint(str(tmp_path / "none")) is None
    bad = tree_map(lambda l: torch.zeros(l.shape[:-1] + (l.shape[-1] + 1,))
                   if l.dim() else l, tp)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(mine, bad)


def test_train_launcher_runs_and_resumes_on_the_cpu(tmp_path):
    """``--smoke`` on the CPU: a finite loss every step, a checkpoint every
    3 steps, and a second run that restores the last one."""
    ck = str(tmp_path / "ck")
    out = ttrain.main(["--arch", "stablelm-1.6b", "--smoke", "--device",
                       "cpu", "--steps", "6", "--batch", "2", "--seq", "16",
                       "--ckpt-dir", ck, "--ckpt-every", "3"])
    assert len(out["losses"]) == 6 and np.isfinite(out["losses"]).all()
    assert latest_checkpoint(ck).endswith("ckpt_00000006.npz")
    again = ttrain.main(["--arch", "stablelm-1.6b", "--smoke", "--device",
                         "cpu", "--steps", "7", "--batch", "2", "--seq",
                         "16", "--ckpt-dir", ck, "--ckpt-every", "3"])
    assert again["start"] == 6 and len(again["losses"]) == 1


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "whisper-base"])
def test_lm_batch_matches_the_reference(arch):
    """The launcher's batch for the stubbed families, as the reference's
    loop builds it (``repro/launch/train.py``): ``vlm`` tokens cut to
    ``seq - vision_tokens`` behind a zero bf16 ``vision_embed``, ``audio``
    zero bf16 ``audio_embed`` frames; a sequence the prefix fills raises."""
    jcfg = jconfigs.get_smoke_config(arch)
    cfg = tconfigs.ModelConfig(**dataclasses.asdict(jcfg))
    b, seq = 3, 40
    toks = _tokens(cfg, b, seq)
    batch = ttrain.lm_batch(cfg, toks, "cpu")
    want = {"tokens": ((b, seq - jcfg.vision_tokens) if jcfg.family == "vlm"
                       else (b, seq), torch.int64)}
    if jcfg.family == "vlm":
        want["vision_embed"] = ((b, jcfg.vision_tokens, jcfg.d_model),
                                torch.bfloat16)
    if jcfg.family == "audio":
        want["audio_embed"] = ((b, jcfg.encoder_seq, jcfg.d_model),
                               torch.bfloat16)
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == want
    np.testing.assert_array_equal(batch["tokens"].numpy(),
                                  toks[:, :want["tokens"][0][1]])
    for k in set(batch) - {"tokens"}:
        assert not bool(batch[k].any())
    if jcfg.family == "vlm":
        with pytest.raises(ValueError, match="vision tokens"):
            ttrain.lm_batch(cfg, toks[:, :jcfg.vision_tokens], "cpu")


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "whisper-base"])
def test_train_launcher_trains_the_stubbed_families(arch):
    """``--smoke`` on the CPU for the vision-language and audio models: a
    finite loss every step through the launcher's batch."""
    out = ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "3", "--batch", "2", "--seq", "32"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["aux"] == [0.0] * 3


def test_train_launcher_reports_the_moe_aux_loss():
    out = ttrain.main(["--arch", "granite-moe-1b-a400m", "--smoke",
                       "--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "16"])
    assert len(out["losses"]) == len(out["aux"]) == 2
    assert np.isfinite(out["losses"]).all()
    assert all(a > 0 for a in out["aux"])


def test_lm_population_example_trains_a_moe_model_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "torch_train_lm_population.py"),
         "--device", "cpu", "--steps", "2", "--arch",
         "granite-moe-1b-a400m"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "population of 4 fixed + 6 mule granite-moe-smoke" in out.stdout


def test_lm_population_example_runs_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "torch_train_lm_population.py"),
         "--device", "cpu", "--steps", "2", "--arch", "stablelm-1.6b"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "population of 4 fixed + 6 mule" in out.stdout
    src = open(os.path.join(ROOT, "examples",
                            "torch_train_lm_population.py")).read()
    assert "import jax" not in src and "from repro." not in src
