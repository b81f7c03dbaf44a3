"""Port's zamba2 (Mamba2 mixer, shared attention block, the hybrid program)
against the JAX package.

The reference's weights are carried across with ``tree_from_numpy``; layer
inputs and tokens come from a numpy seed. Models run at smoke size (2 or 4
layers, d_model 128 or 320). The smoke model's forward, decode, caches,
greedy tokens and bf16 forward against JAX run in tests/test_torch_lm.py
(``zamba2-2.7b`` is one of its ``ARCHS``). Tolerances:

- the conv and gated norm 1e-6 (f32, the same products in the same order);
- the Mamba2 mixer's f32 forward and decode 1e-5 (f32 GEMMs and scan sums
  in another order, outputs ~0.1);
- f32 model logits 1e-4 and the port's own decode against its forward 2e-4,
  as in tests/test_torch_lm.py (the reference's own bound,
  tests/test_decode_consistency.py);
- bf16 mixer outputs 2e-3 (bf16 GEMMs accumulated in another order; outputs
  ~0.1, where a bf16 ulp is 4.9e-4).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro.models.api import build_program as j_build_program  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.interop import to_numpy, tree_from_numpy, tree_leaves  # noqa: E402
from repro_torch.kernels.ssm_scan import ssd_scan  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import mamba2 as tm2  # noqa: E402
from repro_torch.models.api import Stage, build_program  # noqa: E402

torch.set_num_threads(1)

ARCH = "zamba2-2.7b"
FULL_PARAMS = 2_063_676_080      # the reference's init at full width


def _port_cfg(jcfg):
    return tconfigs.ModelConfig(**dataclasses.asdict(jcfg))


def _smoke(**kw):
    return dataclasses.replace(jconfigs.get_smoke_config(ARCH), **kw)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(to_numpy(got), np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=0)


def _mixer(cfg, seed=0):
    """JAX Mamba2 weights and the port's copy of them."""
    jp = jm2.init_mamba2(jax.random.PRNGKey(seed), cfg)
    return jp, tree_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _x(shape, seed=3):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# program and parameters
# ---------------------------------------------------------------------------


def test_program_is_five_mamba_one_shared_attention():
    jcfg = jconfigs.get_config(ARCH)
    prog = build_program(tconfigs.get_config(ARCH))
    assert prog == [Stage("mamba", 5), Stage("shared_attn", 1)] * 9
    assert len(prog) == 18 and sum(s.count for s in prog) == 54
    assert [(s.kind, s.count, s.window) for s in prog] == \
        [(s.kind, s.count, s.window) for s in j_build_program(jcfg)]


def test_full_width_parameter_count():
    """The reference's init at full width (shapes only) holds 2,063,676,080
    parameters, the count chip_smoke.py checks on the card; the port's
    init at smoke size has its structure and shapes."""
    jm = j_build_model(jconfigs.get_config(ARCH))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    assert sum(int(np.prod(l.shape)) for l in jax.tree.leaves(shapes)) \
        == FULL_PARAMS
    assert tconfigs.get_config(ARCH).resolved_head_dim == 80
    jcfg = jconfigs.get_smoke_config(ARCH)
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = build_model(_port_cfg(jcfg)).init(torch.Generator().manual_seed(0))
    assert tp["stages"][1] == {} and "shared_attn" in tp
    assert [tuple(t.shape) for t in tree_leaves(tp)] == \
        [l.shape for l in jax.tree.leaves(jp)]


# ---------------------------------------------------------------------------
# the Mamba2 mixer
# ---------------------------------------------------------------------------


def test_causal_depthwise_conv_matches():
    x, w, b = _x((2, 9, 24)), _x((4, 24), 4) * 0.1, _x((24,), 5)
    want = jm2._causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b))
    got = tm2._causal_depthwise_conv(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(b))
    _close(got, want, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_norm_matches(dtype):
    y, z, scale = _x((2, 5, 64)), _x((2, 5, 64), 6), _x((64,), 7)
    want = jm2._gated_norm(jnp.asarray(y, dtype), jnp.asarray(z),
                           jnp.asarray(scale))
    got = tm2._gated_norm(torch.from_numpy(y).to(getattr(torch, dtype)),
                          torch.from_numpy(z), torch.from_numpy(scale))
    assert got.dtype == getattr(torch, dtype)
    # bf16: both compute in f32 and round once; allow one bf16 ulp
    _close(got, want, 1e-6 if dtype == "float32" else 3e-2)


@pytest.mark.parametrize("seq,chunk", [(12, 64), (40, 16)])
def test_mamba2_forward_matches(seq, chunk):
    cfg = _smoke(dtype="float32")
    jp, tp = _mixer(cfg)
    x = _x((2, seq, cfg.d_model))
    want = jm2.mamba2_forward(jp, jnp.asarray(x), cfg, chunk=chunk)
    before = ssd_scan.launches
    got = tm2.mamba2_forward(tp, torch.from_numpy(x), _port_cfg(cfg),
                             chunk=chunk)
    assert ssd_scan.launches == before        # CPU: the plain version
    _close(got, want, 1e-5)
    ref = tm2.mamba2_forward(tp, torch.from_numpy(x), _port_cfg(cfg),
                             chunk=chunk, backend="ref")
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


def test_mamba2_bf16_forward_within_bound():
    cfg = _smoke()
    jp, tp = _mixer(cfg, seed=1)
    x = _x((2, 20, cfg.d_model), seed=8)
    want = jm2.mamba2_forward(jp, jnp.asarray(x, jnp.bfloat16), cfg)
    got = tm2.mamba2_forward(tp, torch.from_numpy(x).bfloat16(),
                             _port_cfg(cfg))
    assert got.dtype == torch.bfloat16
    _close(got, want, 2e-3)


def test_mamba2_decode_matches_jax_and_forward():
    cfg = _smoke(dtype="float32")
    tcfg = _port_cfg(cfg)
    jp, tp = _mixer(cfg, seed=2)
    b, s = 2, 10
    x = _x((b, s, cfg.d_model), seed=9)
    full = tm2.mamba2_forward(tp, torch.from_numpy(x), tcfg)
    jcache = jm2.init_mamba2_cache(cfg, b)
    tcache = tm2.init_mamba2_cache(tcfg, b, device="cpu")
    assert all(v.dtype == torch.float32 for v in tcache.values())
    for t in range(s):
        jy, jcache = jm2.mamba2_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                       jcache, cfg)
        ty, out_cache = tm2.mamba2_decode(tp, torch.from_numpy(
            x[:, t:t + 1]), tcache, tcfg)
        assert out_cache is tcache                 # updated in place
        _close(ty, jy, 1e-5)
        for key in ("conv_x", "conv_B", "conv_C", "ssm"):
            _close(tcache[key], jcache[key], 1e-5)
        _close(ty[:, 0], full[:, t].numpy(), 1e-5)
    with pytest.raises(TypeError):
        tm2.init_mamba2_cache(tcfg, b)             # no device: no default


# ---------------------------------------------------------------------------
# the hybrid model
# ---------------------------------------------------------------------------


def _both(jcfg, seed=0):
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(_port_cfg(jcfg))
    return jm, jp, tm, tree_from_numpy(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _tokens(cfg, b, s, seed=5):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)) \
        .astype(np.int32)


@pytest.mark.parametrize("variant", ["4 layers", "head_dim 80"])
def test_hybrid_variants_match_jax(variant, monkeypatch):
    """The shared block applied twice with one set of weights, and a width
    whose attention heads are zamba2's head_dim 80 (d_model 320 over 4
    heads): forward, and decode against forward, on the reference's
    weights."""
    kw = ({"n_layers": 4} if variant == "4 layers"
          else {"d_model": 320, "d_ff": 320})
    jm, jp, tm, tp = _both(_smoke(dtype="float32", **kw))
    n_shared = sum(s.kind == "shared_attn" for s in tm.program)
    assert n_shared == (2 if variant == "4 layers" else 1)
    toks = _tokens(jm.cfg, 2, 10)
    real, dims = attn_lib.flash_attention, []

    def spy(q, k, v, **kwargs):
        dims.append(q.shape[-1])
        return real(q, k, v, **kwargs)

    monkeypatch.setattr(attn_lib, "flash_attention", spy)
    got, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    assert dims == [tm.cfg.resolved_head_dim] * n_shared
    _close(got, want, 1e-4)
    cache = tm.init_cache(2, 10, dtype=torch.float32, device="cpu")
    errs = []
    for t in range(10):
        lg, cache = tm.decode_step(tp, cache, torch.from_numpy(
            toks[:, t:t + 1]), t)
        errs.append(float((lg - got[:, t]).abs().max()))
    assert max(errs) < 2e-4, errs


def test_serve_main_runs_zamba2_on_cpu():
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "3", "--gen", "4"])
    assert tuple(out["tokens"].shape) == (2, 4)
    assert out["finite"] and bool(torch.isfinite(out["logits"]).all())


@pytest.mark.cuda
def test_smoke_model_kernels_match_plain_on_card():
    """The smoke model on the card: its f32 forward through the kernels
    (``ssd_scan`` and ``flash_attention``, one launch each) against
    ``backend="ref"``, within the f32 model bound above."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    jcfg = _smoke(dtype="float32")
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), device="cuda")
    toks = torch.from_numpy(_tokens(jcfg, 2, 70)).cuda()
    counts = ssd_scan.launches, attn_lib.flash_attention.launches
    got, _ = build_model(_port_cfg(jcfg)).forward(tp, {"tokens": toks})
    torch.cuda.synchronize()
    assert (ssd_scan.launches - counts[0],
            attn_lib.flash_attention.launches - counts[1]) == (1, 1)
    want, _ = build_model(_port_cfg(jcfg), backend="ref").forward(
        tp, {"tokens": toks})
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
