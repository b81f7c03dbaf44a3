"""Port's LM stack (configs, layers, model, serving) against the JAX
package: the dense models (gemma3-4b, stablelm-1.6b, granite-34b,
qwen2.5-32b), the MoE models (granite-moe-1b-a400m, qwen3-moe-235b-a22b),
the hybrid zamba2-2.7b, xlstm-350m, the vision-language qwen2-vl-72b
(M-RoPE, a vision prefix) and the encoder-decoder whisper-base.

The reference's ``Model.init`` weights are carried across with
``tree_from_numpy``; tokens, layer inputs and the stubs' ``vision_embed``
and ``audio_embed`` come from a numpy seed. The models run at smoke size
(2 layers, d_model 128). Tolerances:

- f32 layer functions 1e-6 (elementwise float32, sums in another order);
  RoPE and M-RoPE 1e-5 (angles up to 88 rad: an ulp of the angle is
  ~8e-6); M-RoPE with three equal streams equals plain RoPE bitwise;
- Whisper's sinusoids within ``SINUSOID_ULPS`` ulps of float32 times the
  largest angle: XLA's CPU ``exp``, ``sin`` and ``cos`` and PyTorch's round
  differently (neither is correctly rounded: against a float64 run, 5,697
  and 17,363 of 384,000 ``sin`` values at 1500 x 512 are off by an ulp),
  and an ulp of a frequency moves an angle by up to its position's ulps;
- f32 forward and decode logits and caches against JAX 1e-4, and the
  port's own decode against its forward 2e-4 (the reference's own bound,
  tests/test_decode_consistency.py); a MoE model's decode checks run
  drop-free (``capacity_factor = E / top_k``), as the reference's do,
  since at decode the capacity is counted over the batch's one token a
  row, not over the sequence; the MoE aux loss 1e-6;
- a bf16 forward 3e-2 against JAX's bf16 forward: each layer's output and
  the final norm round to bf16, and the two frameworks accumulate bf16
  products in another order, so one bf16 ulp of the residual stream
  (1.6e-2 at |x| ~ 2) can move a logit by a few 1e-3 (measured ~5e-3).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.api import build_program as j_build_program  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.interop import (to_numpy, tree_from_numpy,  # noqa: E402
                                 tree_leaves)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.api import Stage, build_program  # noqa: E402

torch.set_num_threads(1)

ARCHS = ["gemma3-4b", "stablelm-1.6b", "zamba2-2.7b", "xlstm-350m",
         "granite-moe-1b-a400m", "qwen3-moe-235b-a22b", "granite-34b",
         "qwen2.5-32b", "whisper-base", "qwen2-vl-72b"]
SINUSOID_ULPS = 4


def _port_cfg(jcfg):
    return tconfigs.ModelConfig(**dataclasses.asdict(jcfg))


_MODELS = {}


def _models(arch, dtype="float32", drop_free=False):
    """(JAX model, JAX params, port model, port params) at smoke size; with
    ``drop_free`` a MoE model's experts take every token."""
    key = (arch, dtype, drop_free)
    if key not in _MODELS:
        jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                                   dtype=dtype)
        if drop_free and jcfg.n_experts:
            jcfg = dataclasses.replace(
                jcfg, capacity_factor=float(jcfg.n_experts) / jcfg.top_k)
        jm = j_build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(_port_cfg(jcfg))
        tp = tree_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS[key] = (jm, jp, tm, tp)
    return _MODELS[key]


def _tokens(cfg, b, s, seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _batch(cfg, toks, audio=None, seed=6):
    """(JAX batch, port batch) of ``toks``: for ``audio`` ``audio_embed``
    [B, encoder_seq, D] (``audio`` if given, else 0.1 x normal from a numpy
    seed), for ``vlm`` a 0.1 x normal ``vision_embed`` [B, vision_tokens,
    D] prefix."""
    rng = np.random.default_rng(seed)
    b = toks.shape[0]
    extra = {}
    if cfg.family == "audio":
        extra["audio_embed"] = audio if audio is not None else (
            0.1 * rng.normal(size=(b, cfg.encoder_seq, cfg.d_model))
        ).astype(np.float32)
    if cfg.family == "vlm":
        extra["vision_embed"] = (0.1 * rng.normal(
            size=(b, cfg.vision_tokens, cfg.d_model))).astype(np.float32)
    arrays = {"tokens": toks, **extra}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()})


def _text_only(cfg):
    """qwen2-vl without its prefix and M-RoPE: the model its decode is
    held to (tests/test_decode_consistency.py)."""
    return dataclasses.replace(cfg, vision_tokens=0, family="dense",
                               mrope_sections=None)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(to_numpy(got), np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# configs and programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_config_copies_match(arch, size):
    get_j = jconfigs.get_config if size == "full" else jconfigs.get_smoke_config
    get_t = tconfigs.get_config if size == "full" else tconfigs.get_smoke_config
    jcfg, tcfg = get_j(arch), get_t(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.resolved_head_dim == jcfg.resolved_head_dim
    assert tcfg.supports_long_context == jcfg.supports_long_context


def test_registry_ports_three_ids_and_names_the_rest():
    """Every id of the reference is ported (the name is from when three
    were); an unknown id raises."""
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.INPUT_SHAPES == {
        k: tconfigs.InputShape(**dataclasses.asdict(v))
        for k, v in jconfigs.INPUT_SHAPES.items()}
    assert tconfigs.get_config("mule-cnn").name == "mule-cnn"
    assert tconfigs.get_config("mule-lstm-cnn").name == "mule-lstm-cnn"
    assert set(jconfigs.ARCH_IDS) == set(ARCHS)
    for arch in jconfigs.ARCH_IDS:
        for get_t, get_j in ((tconfigs.get_config, jconfigs.get_config),
                             (tconfigs.get_smoke_config,
                              jconfigs.get_smoke_config)):
            assert dataclasses.asdict(get_t(arch)) == \
                dataclasses.asdict(get_j(arch))
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_build_program_matches(arch):
    for get in (jconfigs.get_config, jconfigs.get_smoke_config):
        jcfg = get(arch)
        want = [(s.kind, s.count, s.window) for s in j_build_program(jcfg)]
        got = [(s.kind, s.count, s.window)
               for s in build_program(_port_cfg(jcfg))]
        assert got == want


def test_gemma3_program_is_five_local_one_global():
    prog = build_program(tconfigs.get_config("gemma3-4b"))
    assert prog == [Stage("attn", 5, 1024), Stage("attn", 1, None)] * 5 \
        + [Stage("attn", 4, 1024)]
    assert sum(s.count for s in prog) == 34


@pytest.mark.parametrize("arch,layers,const", [
    ("whisper-base", None, "AUDIO_PARAMS"),
    ("qwen2-vl-72b", 2, "VISION_PARAMS")])
def test_full_width_parameter_counts_match_chip_smoke(arch, layers, const):
    """The reference's init at full width (shapes only; qwen2-vl at the 2
    layers the card runs) counts the parameters chip_smoke.py checks on
    the card."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_consts", path)
    consts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(consts)
    jcfg = jconfigs.get_config(arch)
    if layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=layers)
    shapes = jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0))
    assert sum(int(np.prod(l.shape)) for l in jax.tree.leaves(shapes)) == \
        getattr(consts, const)


def test_build_model_backend_option():
    """backend="ref" runs the plain attention on any device (on the CPU
    that is also what "auto" runs); an unknown backend raises."""
    _, _, tm, tp = _models("gemma3-4b")
    toks = torch.from_numpy(_tokens(tm.cfg, 2, 12))
    ref = build_model(tm.cfg, backend="ref")
    assert ref.backend == "ref" and ref.program == tm.program
    torch.testing.assert_close(ref.forward(tp, {"tokens": toks})[0],
                               tm.forward(tp, {"tokens": toks})[0],
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="backend"):
        build_model(tm.cfg, backend="pallas")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_matches(kind, dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3 + 0.5
    p = {"scale": rng.normal(size=48).astype(np.float32),
         "bias": rng.normal(size=48).astype(np.float32)}
    if kind == "rmsnorm":
        del p["bias"]
    want = jl.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x, dtype), kind, 1e-5)
    got = tl.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x).to(getattr(torch, dtype)), kind,
                        1e-5)
    assert got.dtype == getattr(torch, dtype)
    # bf16: both compute in f32 and round once; allow one bf16 ulp
    _close(got, want, 1e-6 if dtype == "float32" else 3e-2)
    assert sorted(tl.init_norm(kind, 48, device="cpu")) == \
        sorted(jl.init_norm(kind, 48))


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activation_matches(name):
    x = np.linspace(-6, 6, 401, dtype=np.float32)
    want = jl.activation(name)(jnp.asarray(x))
    got = tl.activation(name)(torch.from_numpy(x))
    _close(got, want, 1e-6)
    if name == "gelu":   # the tanh approximation, not erf
        exact = torch.nn.functional.gelu(torch.from_numpy(x))
        assert (exact - got).abs().max() > 1e-4


def test_rope_matches():
    rng = np.random.default_rng(2)
    pos = np.broadcast_to(np.arange(88, dtype=np.int32), (2, 88)).copy()
    x = rng.normal(size=(2, 88, 3, 32)).astype(np.float32)
    for theta in (10_000.0, 1_000_000.0):
        np.testing.assert_array_equal(tl.rope_freqs(32, theta,
                                                    device="cpu").numpy(),
                                      np.asarray(jl.rope_freqs(32, theta)))
        ja = jl.rope_angles(jnp.asarray(pos), 32, theta)
        ta = tl.rope_angles(torch.from_numpy(pos), 32, theta)
        _close(ta, ja, 1e-5)
        _close(tl.apply_rope(torch.from_numpy(x), ta),
               jl.apply_rope(jnp.asarray(x), ja), 1e-5)
        # M-RoPE at the smoke sections, three different streams (t, h, w)
        streams = np.stack([pos, (7 * pos) % 13, pos[:, ::-1]])
        ja = jl.rope_angles(jnp.asarray(streams), 32, theta, (4, 6, 6))
        ta = tl.rope_angles(torch.from_numpy(streams.copy()), 32, theta,
                            (4, 6, 6))
        assert tuple(ta.shape) == ja.shape == (2, 88, 16)
        _close(ta, ja, 1e-5)
        _close(tl.apply_rope(torch.from_numpy(x), ta),
               jl.apply_rope(jnp.asarray(x), ja), 1e-5)
        # three equal streams are plain RoPE, bit for bit
        same = torch.from_numpy(pos)[None].expand(3, 2, 88)
        torch.testing.assert_close(
            tl.rope_angles(same, 32, theta, (4, 6, 6)),
            tl.rope_angles(torch.from_numpy(pos), 32, theta), atol=0, rtol=0)
    with pytest.raises(ValueError, match=r"\[3, B, S\]"):
        tl.rope_angles(torch.zeros(2, 4, dtype=torch.int32), 32, 1e4,
                       (4, 6, 6))
    with pytest.raises(ValueError, match="sum"):
        tl.rope_angles(torch.zeros(3, 1, 4, dtype=torch.int32), 32, 1e4,
                       (4, 6, 5))


@pytest.mark.parametrize("seq,dim", [(64, 128), (12, 128), (1500, 512)])
def test_sinusoidal_positions_match(seq, dim):
    """Whisper's fixed positions against the reference's; the one-position
    rows of decode equal the table's rows bitwise."""
    got = tl.sinusoidal_positions(seq, dim)
    want = np.asarray(jl.sinusoidal_positions(seq, dim))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got[0].numpy(), want[0])   # sin 0, cos 0
    _close(got, want, SINUSOID_ULPS * np.finfo(np.float32).eps * (seq - 1))
    for p in (0, 1, seq // 2, seq - 1):
        row = tl.sinusoids(torch.full((1,), p, dtype=torch.float32), dim)
        torch.testing.assert_close(row[0], got[p], atol=0, rtol=0)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches(act):
    rng = np.random.default_rng(3)
    p = {k: (0.1 * rng.normal(size=s)).astype(np.float32) for k, s in
         (("wi_gate", (64, 96)), ("wi_up", (64, 96)), ("wo", (96, 64)))}
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    want = jl.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), act, jnp.float32)
    got = tl.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), act, torch.float32)
    _close(got, want, 1e-5)


def _attn_params(cfg, rng):
    hd = cfg.resolved_head_dim
    p = {"wq": (cfg.d_model, cfg.n_heads * hd),
         "wk": (cfg.d_model, cfg.n_kv_heads * hd),
         "wv": (cfg.d_model, cfg.n_kv_heads * hd),
         "wo": (cfg.n_heads * hd, cfg.d_model)}
    if cfg.qkv_bias:
        p.update(bq=(cfg.n_heads * hd,), bk=(cfg.n_kv_heads * hd,),
                 bv=(cfg.n_kv_heads * hd,))
    return {k: (0.05 * rng.normal(size=s)).astype(np.float32)
            for k, s in p.items()}


@pytest.mark.parametrize("arch", ["whisper-base", "qwen2-vl-72b"])
@pytest.mark.parametrize("causal,rope", [(False, False), (True, False),
                                         (False, True)])
def test_attn_forward_causal_and_rope_options(arch, causal, rope):
    """``attn_forward``'s ``causal`` and ``rope`` arguments against the
    reference's (Whisper's encoder: bidirectional, no RoPE; its decoder:
    causal, no RoPE); qwen2-vl's with M-RoPE positions [3, B, S]."""
    from repro.models import attention as ja
    from repro_torch.models import attention as ta
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               dtype="float32")
    rng = np.random.default_rng(11)
    p = _attn_params(jcfg, rng)
    x = rng.normal(size=(2, 20, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 23, dtype=np.int32), (2, 20))
    if jcfg.mrope_sections is not None:
        pos = np.stack([pos, pos // 4, pos % 5])
    want = ja.attn_forward({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), jnp.asarray(pos), jcfg,
                           causal=causal, rope=rope)
    got = ta.attn_forward({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x),
                          torch.from_numpy(np.ascontiguousarray(pos)),
                          _port_cfg(jcfg), causal=causal, rope=rope)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("s,se", [(12, 64), (1, 64), (5, 3)])
def test_cross_attention_matches(s, se):
    """``cross_kv`` and ``cross_attn_forward`` against the reference's (the
    plain chunked version, bidirectional, S against the encoder's Se); a
    cache of another dtype is widened, not k and v rounded to q's."""
    from repro.models import attention as ja
    from repro_torch.models import attention as ta
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("whisper-base"),
                               dtype="float32")
    rng = np.random.default_rng(12)
    p = _attn_params(jcfg, rng)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    enc = rng.normal(size=(2, se, jcfg.d_model)).astype(np.float32)
    x = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    jk, jv = ja.cross_kv(jp, jnp.asarray(enc), jcfg)
    tk, tv = ta.cross_kv(tp, torch.from_numpy(enc), _port_cfg(jcfg))
    _close(tk, jk, 1e-6)
    _close(tv, jv, 1e-6)
    before = flash_attention.launches
    got = ta.cross_attn_forward(tp, torch.from_numpy(x), tk, tv,
                                _port_cfg(jcfg))
    assert flash_attention.launches == before
    _close(got, ja.cross_attn_forward(jp, jnp.asarray(x), jk, jv, jcfg),
           1e-6)
    # bf16 compute against an f32 cache, as serving holds it
    jcfg16 = dataclasses.replace(jcfg, dtype="bfloat16")
    want = ja.cross_attn_forward(jp, jnp.asarray(x), jk, jv, jcfg16)
    got = ta.cross_attn_forward(tp, torch.from_numpy(x), tk, tv,
                                _port_cfg(jcfg16))
    assert got.dtype == torch.float32
    _close(got, want, 3e-2)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-vl-72b"])
def test_forward_takes_the_batch_positions(arch):
    """``forward`` uses ``batch["positions"]`` where the caller passes
    them, as the reference does: shifted and spread positions (RoPE sees
    only their differences), and for qwen2-vl three different M-RoPE
    streams [3, B, S] over prefix and text."""
    jm, jp, tm, tp = _models(arch)
    cfg = jm.cfg
    toks = _tokens(cfg, 2, 12)
    jbatch, tbatch = _batch(cfg, toks)
    s = 12 + cfg.vision_tokens
    pos = np.stack([5 + 2 * np.arange(s), 3 + np.arange(s)]).astype(np.int32)
    if cfg.mrope_sections is not None:
        pos = np.stack([pos, (pos * 3) % 7, pos[:, ::-1]])
    pos = np.ascontiguousarray(pos)
    want, _ = jm.forward(jp, {**jbatch, "positions": jnp.asarray(pos)})
    got, _ = tm.forward(tp, {**tbatch, "positions": torch.from_numpy(pos)})
    _close(got, want, 1e-4)
    plain, _ = tm.forward(tp, tbatch)
    assert float((got - plain).abs().max()) > 1e-3   # the positions count


def test_whisper_needs_its_frames():
    """Whisper's cache takes frames of its own [B, Se]; ``generate`` needs
    them for an audio model and refuses them for another."""
    _, _, tm, tp = _models("whisper-base")
    cfg = tm.cfg
    cache = tm.init_cache(2, 4, dtype=torch.float32, device="cpu")
    assert tuple(cache["cross_k"].shape) == (cfg.n_layers, 2,
                                             cfg.encoder_seq,
                                             cfg.n_kv_heads,
                                             cfg.resolved_head_dim)
    with pytest.raises(ValueError, match="audio_embed"):
        tm.prefill_cross_kv(tp, torch.zeros(2, 3, cfg.d_model), cache)
    prompt = torch.zeros(2, 3, dtype=torch.long)
    with pytest.raises(ValueError, match="needed"):
        serve.generate(tm, tp, prompt, 2)
    _, _, sm, sp = _models("stablelm-1.6b")
    with pytest.raises(ValueError, match="only for audio"):
        serve.generate(sm, sp, prompt, 2,
                       audio_embed=torch.zeros(2, 4, sm.cfg.d_model))


# ---------------------------------------------------------------------------
# the model at smoke size, on the reference's weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jm, jp, tm, tp = _models(arch)
    toks = _tokens(jm.cfg, 2, 12)
    jbatch, tbatch = _batch(jm.cfg, toks)
    want, jaux = jm.forward(jp, jbatch)
    before = flash_attention.launches
    got, aux = tm.forward(tp, tbatch)
    assert flash_attention.launches == before     # CPU: the plain version
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    assert tuple(got.shape) == (2, 12 + jm.cfg.vision_tokens, jm.cfg.vocab)
    _close(got, want, 1e-4)
    _close(aux, jaux, 1e-6)
    assert (float(aux) > 0) == bool(jm.cfg.n_experts)
    logits = make_prefill_step(tm)(tp, tbatch)
    torch.testing.assert_close(logits, got, atol=0, rtol=0)
    jloss, _ = jm.loss(jp, jbatch)
    tloss, metrics = tm.loss(tp, tbatch)
    _close(tloss, jloss, 1e-5)
    _close(metrics["nll"], jloss - 0.01 * jaux, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax_and_own_forward(arch):
    """Decode against JAX's (logits and every cache leaf) and against the
    port's own forward. Whisper's cross K/V are prefilled from frames drawn
    as the reference's own test draws them; qwen2-vl's decode (M-RoPE, three
    equal streams) is held to the forward of its text-only copy, as the
    reference's test holds it (tests/test_decode_consistency.py)."""
    jm, jp, tm, tp = _models(arch, drop_free=True)
    cfg = jm.cfg
    b, s = 2, 12
    toks = _tokens(cfg, b, s)
    jdecode = jax.jit(jm.decode_step)
    jcache = jm.init_cache(b, s, dtype=jnp.float32)
    tcache = tm.init_cache(b, s, dtype=torch.float32, device="cpu")
    if cfg.family == "audio":
        audio = np.array(0.1 * jax.random.normal(
            jax.random.PRNGKey(2), (b, cfg.encoder_seq, cfg.d_model)))
        jcache = jm.prefill_cross_kv(jp, jnp.asarray(audio), jcache)
        tcache = tm.prefill_cross_kv(tp, torch.from_numpy(audio), tcache)
        full, _ = tm.forward(tp, _batch(cfg, toks, audio)[1])
    elif cfg.family == "vlm":
        full, _ = build_model(_port_cfg(_text_only(cfg))).forward(
            tp, {"tokens": torch.from_numpy(toks)})
    else:
        full, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    step = make_serve_step(tm)
    errs = []
    for t in range(s):
        jlg, jcache = jdecode(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                              jnp.int32(t))
        tlg, tcache = step(tp, tcache, torch.from_numpy(toks[:, t:t + 1]), t)
        _close(tlg, jlg, 1e-4)
        for got, want in zip(tree_leaves(tcache), jax.tree.leaves(jcache)):
            assert tuple(got.shape) == want.shape
            _close(got, want, 1e-4)
        errs.append(float((tlg - full[:, t]).abs().max()))
    assert max(errs) < 2e-4, errs


def test_sliding_window_cache_rolls():
    """gemma3-style local layers: decode past the window uses the rolling
    buffer and still matches the full-sequence forward (port and JAX)."""
    jm, jp, tm, tp = _models("gemma3-4b")
    cfg = tm.cfg
    assert cfg.sliding_window and cfg.sliding_window < 128
    b, s = 1, cfg.sliding_window + 24   # force wraparound
    toks = _tokens(cfg, b, s)
    full, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    jfull, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    _close(full, jfull, 1e-4)
    cache = tm.init_cache(b, s, dtype=torch.float32, device="cpu")
    assert cache[0]["k"].shape[1] == cfg.sliding_window   # rolling buffer
    errs = []
    for t in range(s):
        lg, cache = tm.decode_step(tp, cache, torch.from_numpy(
            toks[:, t:t + 1]), t)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 2e-4, max(errs)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_loop(arch):
    """Greedy tokens of the port's serve loop equal the reference loop's
    (``repro.launch.serve.main``), in f32, on the same weights and prompt."""
    jm, jp, tm, tp = _models(arch)
    b, n_prompt, n_gen = 2, 6, 10
    prompt = _tokens(jm.cfg, b, n_prompt, seed=9)
    decode = jax.jit(jm.decode_step)
    cache = jm.init_cache(b, n_prompt + n_gen, dtype=jnp.float32)
    audio = _batch(jm.cfg, prompt)[1].get("audio_embed")
    if audio is not None:
        cache = jm.prefill_cross_kv(jp, jnp.asarray(audio.numpy()), cache)
    jprompt = jnp.asarray(prompt)
    for t in range(n_prompt):
        logits, cache = decode(jp, cache, jprompt[:, t:t + 1], jnp.int32(t))
    generated = []
    tok = jnp.argmax(logits, axis=-1)[:, None]
    for t in range(n_prompt, n_prompt + n_gen):
        generated.append(tok)
        logits, cache = decode(jp, cache, tok, jnp.int32(t))
        tok = jnp.argmax(logits, axis=-1)[:, None]
    want = np.asarray(jnp.concatenate(generated, axis=1))
    out = serve.generate(tm, tp, torch.from_numpy(prompt).long(), n_gen,
                         cache_dtype=torch.float32, audio_embed=audio)
    np.testing.assert_array_equal(out["tokens"].numpy(), want)
    _close(out["logits"], logits, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_within_bound(arch):
    jm, jp, tm, tp = _models(arch, "bfloat16")
    jbatch, tbatch = _batch(jm.cfg, _tokens(jm.cfg, 2, 12))
    want, _ = jm.forward(jp, jbatch)
    got, _ = tm.forward(tp, tbatch)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    _close(got, want, 3e-2)


def test_serve_main_runs_on_cpu_and_needs_a_card_by_default(monkeypatch):
    for arch in ("gemma3-4b", "whisper-base", "qwen2-vl-72b"):
        out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "3", "--gen", "4"])
        assert tuple(out["tokens"].shape) == (2, 4)
        assert out["finite"] and bool(torch.isfinite(out["logits"]).all())
        assert (out["encode_s"] > 0) == (arch == "whisper-base")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "gemma3-4b", "--smoke"])
    tm = _models("stablelm-1.6b")[2]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init_cache(1, 4)


# ---------------------------------------------------------------------------
# interop
# ---------------------------------------------------------------------------


def test_tree_from_numpy_keeps_nesting_and_jax_leaf_order():
    rng = np.random.default_rng(4)
    tree = {"z": rng.normal(size=3).astype(np.float32),
            "stages": [{"w": np.full((2,), i, np.float32),
                        "n": {"b": np.int32(i), "a": np.zeros(1, np.int64)}}
                       for i in range(12)],
            "a": np.asarray(rng.normal(size=(2, 2)), jnp.bfloat16)}
    port = tree_from_numpy(tree, device="cpu")
    assert isinstance(port["stages"], list) and len(port["stages"]) == 12
    assert port["a"].dtype == torch.bfloat16
    back = to_numpy(port)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    want = jax.tree.leaves(tree)
    got = tree_leaves(port)
    assert len(got) == len(want)
    # "stages" leaves in list order 0, 1, .., 11 (not "stages.10" first)
    for g, w in zip(got, want):
        g = to_numpy(g)
        np.testing.assert_array_equal(g, np.asarray(w).astype(g.dtype))
    for g, w in zip(jax.tree.leaves(back), want):
        np.testing.assert_array_equal(g, np.asarray(w).astype(g.dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_params_round_trip(arch):
    jm, jp, tm, tp = _models(arch)
    jleaves, jdef = jax.tree.flatten(jp)
    tleaves = tree_leaves(tp)
    assert len(tleaves) == len(jleaves)
    for g, w in zip(tleaves, jleaves):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert jax.tree.structure(to_numpy(tp)) == jdef
    # the port's own init gives the reference's structure and shapes
    own = tm.init(torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in tree_leaves(own)] == \
        [w.shape for w in jleaves]
