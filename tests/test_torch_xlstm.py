"""Port's xLSTM (the mLSTM and sLSTM blocks, the xlstm_pair program)
against the JAX package.

The reference's weights are carried across with ``tree_from_numpy``; block
inputs and tokens come from a numpy seed. Blocks and models run at smoke
size (d_model 128, 4 heads: mLSTM heads of 64, sLSTM heads of 32). The
smoke model's decode, caches, greedy tokens and bf16 forward against JAX
run in tests/test_torch_lm.py (``xlstm-350m`` is one of its ``ARCHS``).
Tolerances:

- f32 blocks against JAX 1e-5 (f32 GEMMs, and the mLSTM's cumsum and the
  sLSTM's products summed in another order; outputs up to ~4 with the
  residual, measured 2.4e-7), and the port's decode against its own
  forward 1e-5;
- f32 model logits 1e-4 against JAX's ``backend="ref"`` and
  ``backend="interpret"`` (the Pallas kernel in interpret mode), as in
  tests/test_torch_lm.py;
- bf16 blocks 3e-2: bf16 GEMMs accumulated in another order and rounded
  at other places (JAX rounds bf16 elementwise ops one by one), where a
  bf16 ulp of the residual stream (|x| in [2, 4)) is 1.6e-2 (measured:
  one such ulp).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.models.api import build_program as j_build_program  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.interop import to_numpy, tree_from_numpy, tree_leaves  # noqa: E402
from repro_torch.kernels.slstm_fused import slstm_scan  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from repro_torch.models.api import Stage, build_program  # noqa: E402

torch.set_num_threads(1)

ARCH = "xlstm-350m"
FULL_PARAMS = 468_260_864        # the reference's init at full width


def _port_cfg(jcfg):
    return tconfigs.ModelConfig(**dataclasses.asdict(jcfg))


def _smoke(**kw):
    return dataclasses.replace(jconfigs.get_smoke_config(ARCH), **kw)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(to_numpy(got), np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=0)


def _block(kind, cfg, seed=0):
    """JAX weights of one mLSTM or sLSTM block and the port's copy."""
    init = jx.init_mlstm if kind == "mlstm" else jx.init_slstm
    jp = init(jax.random.PRNGKey(seed), cfg)
    return jp, tree_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _x(shape, seed=3):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# program and parameters
# ---------------------------------------------------------------------------


def test_program_is_twelve_pairs():
    prog = build_program(tconfigs.get_config(ARCH))
    assert prog == [Stage("xlstm_pair", 12)]
    assert [(s.kind, s.count, s.window) for s in prog] == \
        [(s.kind, s.count, s.window)
         for s in j_build_program(jconfigs.get_config(ARCH))]


def test_full_width_parameter_count():
    """The reference's init at full width (shapes only) holds 468,260,864
    parameters, the count chip_smoke.py checks on the card; the port's
    init at smoke size has its structure and shapes, the sLSTM head being
    d_model // n_heads wide."""
    jm = j_build_model(jconfigs.get_config(ARCH))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    assert sum(int(np.prod(l.shape)) for l in jax.tree.leaves(shapes)) \
        == FULL_PARAMS
    assert shapes["stages"][0]["slstm"]["r"].shape == (12, 4, 4, 256, 256)
    jcfg = jconfigs.get_smoke_config(ARCH)
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = build_model(_port_cfg(jcfg)).init(torch.Generator().manual_seed(0))
    assert tuple(tp["stages"][0]["slstm"]["r"].shape) == (4, 4, 32, 32)
    assert [tuple(t.shape) for t in tree_leaves(tp)] == \
        [l.shape for l in jax.tree.leaves(jp)]


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq,block", [(12, 256), (40, 16)])
def test_mlstm_forward_matches(seq, block):
    """One sequence shorter than the block (the diagonal block alone), one
    of three blocks with a ragged tail (the off-diagonal scan and the
    -1e30 padding)."""
    cfg = _smoke(dtype="float32")
    jp, tp = _block("mlstm", cfg)
    x = _x((2, seq, cfg.d_model))
    want = jx.mlstm_forward(jp, jnp.asarray(x), cfg, block=block)
    got = tx.mlstm_forward(tp, torch.from_numpy(x), _port_cfg(cfg),
                           block=block)
    _close(got, want, 1e-5)


def test_slstm_forward_matches():
    cfg = _smoke(dtype="float32")
    jp, tp = _block("slstm", cfg, seed=1)
    x = _x((2, 20, cfg.d_model), seed=4)
    want = jx.slstm_forward(jp, jnp.asarray(x), cfg)
    before = slstm_scan.launches
    got = tx.slstm_forward(tp, torch.from_numpy(x), _port_cfg(cfg))
    assert slstm_scan.launches == before      # CPU: the plain version
    _close(got, want, 1e-5)
    ref = tx.slstm_forward(tp, torch.from_numpy(x), _port_cfg(cfg),
                           backend="ref")
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


@pytest.mark.parametrize("act", ["silu", "relu"])
def test_slstm_block_gate_is_gelu_whatever_act(act):
    """The reference's sLSTM block gates its up projection with GELU (tanh
    form) whatever ``cfg.act`` says; the port's prefill and decode follow
    it (a port that used ``cfg.act`` was 3.38e-3 off with "silu")."""
    cfg = _smoke(dtype="float32", act=act)
    tcfg = _port_cfg(cfg)
    jp, tp = _block("slstm", cfg, seed=5)
    b, s = 2, 12
    x = _x((b, s, cfg.d_model), seed=6)
    _close(tx.slstm_forward(tp, torch.from_numpy(x), tcfg),
           jx.slstm_forward(jp, jnp.asarray(x), cfg), 1e-5)
    jcache = jx.init_slstm_cache(cfg, b)
    tcache = tx.init_slstm_cache(tcfg, b, device="cpu")
    for t in range(s):
        jy, jcache = jx.slstm_decode(jp, jnp.asarray(x[:, t:t + 1]), jcache,
                                     cfg)
        ty, tcache = tx.slstm_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                     tcache, tcfg)
        _close(ty, jy, 1e-5)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_matches_jax_and_forward(kind):
    """Each block's recurrent step against JAX's (outputs and caches) and
    against the port's own full-sequence forward; the cache is updated in
    place and is f32."""
    cfg = _smoke(dtype="float32")
    tcfg = _port_cfg(cfg)
    jp, tp = _block(kind, cfg, seed=2)
    j_fwd, j_dec, j_cache = ((jx.mlstm_forward, jx.mlstm_decode,
                              jx.init_mlstm_cache) if kind == "mlstm" else
                             (jx.slstm_forward, jx.slstm_decode,
                              jx.init_slstm_cache))
    t_fwd, t_dec, t_cache = ((tx.mlstm_forward, tx.mlstm_decode,
                              tx.init_mlstm_cache) if kind == "mlstm" else
                             (tx.slstm_forward, tx.slstm_decode,
                              tx.init_slstm_cache))
    b, s = 2, 10
    x = _x((b, s, cfg.d_model), seed=9)
    full = t_fwd(tp, torch.from_numpy(x), tcfg)
    _close(full, j_fwd(jp, jnp.asarray(x), cfg), 1e-5)
    jcache = j_cache(cfg, b)
    tcache = t_cache(tcfg, b, device="cpu")
    assert all(v.dtype == torch.float32 for v in tcache.values())
    for t in range(s):
        jy, jcache = j_dec(jp, jnp.asarray(x[:, t:t + 1]), jcache, cfg)
        ty, out_cache = t_dec(tp, torch.from_numpy(x[:, t:t + 1]), tcache,
                              tcfg)
        assert out_cache is tcache                 # updated in place
        _close(ty, jy, 1e-5)
        assert sorted(tcache) == sorted(jcache)
        for key in tcache:
            _close(tcache[key], jcache[key], 1e-5)
        _close(ty[:, 0], full[:, t].numpy(), 1e-5)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_bf16_block_within_bound(kind):
    cfg = _smoke()
    jp, tp = _block(kind, cfg, seed=5)
    x = _x((2, 40, cfg.d_model), seed=8)
    j_fwd, t_fwd = ((jx.mlstm_forward, tx.mlstm_forward) if kind == "mlstm"
                    else (jx.slstm_forward, tx.slstm_forward))
    kw = {"block": 16} if kind == "mlstm" else {}
    want = j_fwd(jp, jnp.asarray(x, jnp.bfloat16), cfg, **kw)
    got = t_fwd(tp, torch.from_numpy(x).bfloat16(), _port_cfg(cfg), **kw)
    assert got.dtype == torch.bfloat16
    _close(got, want, 3e-2)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("j_backend", ["ref", "interpret"])
def test_smoke_logits_match_jax(j_backend):
    """f32 logits of the smoke model (one pair, 70 tokens: the mLSTM's
    block of 256 covers them) against JAX's plain scan and its Pallas
    kernel in interpret mode."""
    jcfg = _smoke(dtype="float32")
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 70)) \
        .astype(np.int32)
    want, _ = j_build_model(jcfg, backend=j_backend).forward(
        jp, {"tokens": jnp.asarray(toks)})
    got, _ = build_model(_port_cfg(jcfg)).forward(
        tp, {"tokens": torch.from_numpy(toks)})
    _close(got, want, 1e-4)


def test_serve_main_runs_xlstm_on_cpu():
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "3", "--gen", "4"])
    assert tuple(out["tokens"].shape) == (2, 4)
    assert out["finite"] and bool(torch.isfinite(out["logits"]).all())


@pytest.mark.cuda
def test_smoke_model_kernel_matches_plain_on_card():
    """The smoke model on the card: its f32 forward through ``slstm_scan``
    (one launch) against ``backend="ref"``, within the f32 model bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    jcfg = _smoke(dtype="float32")
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), device="cuda")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, jcfg.vocab, (2, 70))).cuda()
    before = slstm_scan.launches
    got, _ = build_model(_port_cfg(jcfg)).forward(tp, {"tokens": toks})
    torch.cuda.synchronize()
    assert slstm_scan.launches - before == 1
    want, _ = build_model(_port_cfg(jcfg), backend="ref").forward(
        tp, {"tokens": toks})
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
