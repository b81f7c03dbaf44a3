"""Port's mixture-of-experts layer (``repro_torch.models.moe``) against the
JAX package's single-device path (``repro.models.moe``, ``mesh=None``).

Weights come from the reference's ``init_moe`` at the MoE smoke configs
(granite-moe: E 4, top-2, d 128, f 64; qwen3-moe's smoke has the same
layer, so its cases draw other weights), inputs from a numpy seed, all in
float32. Bounds:

- routing exact: the top-k experts, the slot of every (token, choice) and
  the sorted token ids are integers and must be equal; the smallest gap
  between the k-th and the (k+1)-th probability of each case is printed,
  since a gap near float32 rounding would let the two frameworks' softmax
  pick different experts (none of the cases is near one);
- the grouped tokens, the sorted gates and the aux loss 1e-6 (float32
  softmax and sums in another order);
- ``apply_moe`` 1e-5 (three batched products and a sum of k slots);
  its gradients (params and x) 2e-4 of each leaf's largest;
- each lane of ``torch.func.vmap`` 1e-6 of its own call (the CPU's batched
  products may block differently), its gradient 1e-6 of the leaf's
  largest;
- the un-group sums each token's slots in a fixed order, so two replays
  are bitwise equal; it is held to the reference's scatter-add 1e-6
  relative.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.interop import tree_from_numpy  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

torch.set_num_threads(1)

MOE_ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b"]
GROUP_TOL = 1e-6
APPLY_TOL = 1e-5
GRAD_REL = 2e-4
LANE_TOL = 1e-6


def _cfgs(arch, drop_free=False):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               dtype="float32")
    if drop_free:   # every expert can take every token: nothing is dropped
        jcfg = dataclasses.replace(
            jcfg, capacity_factor=float(jcfg.n_experts) / jcfg.top_k)
    return jcfg, tconfigs.ModelConfig(**dataclasses.asdict(jcfg))


def _params(jcfg, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, tree_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach(), np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0)


def test_init_moe_layout_and_capacity_rounding():
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m")
    jp, _ = _params(jcfg)
    own = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg)
    assert sorted(own) == sorted(jp)
    for name in jp:
        assert tuple(own[name].shape) == jp[name].shape
        assert own[name].dtype == torch.float32
        std = float(own[name].std())
        assert 0.015 < std < 0.025, (name, std)      # dense_init at 0.02
    # Python's round, ties to even, as the reference: 4 tokens x 2 / 4
    # experts x 1.25 = 2.5 -> 2; decode at the launcher's batch 4 on the
    # full config: 4 x 8 / 32 x 1.25 = 1.25 -> 1
    assert tmoe.capacity_of(4, tcfg) == 2
    assert tmoe.capacity_of(12, tcfg) == 8          # 7.5 -> 8
    assert tmoe.capacity_of(1, tcfg) == 1           # floor of one slot
    full = tconfigs.get_config("granite-moe-1b-a400m")
    assert tmoe.capacity_of(4, full) == 1
    assert tmoe.capacity_of(8192, full) == 2560


@pytest.mark.parametrize("t", [1, 4, 24])
@pytest.mark.parametrize("drop_free", [False, True],
                         ids=["capacity", "drop-free"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_and_group_matches_the_reference(arch, drop_free, t):
    jcfg, tcfg = _cfgs(arch, drop_free)
    jp, tp = _params(jcfg, seed=MOE_ARCHS.index(arch))
    xt = _x((t, jcfg.d_model), seed=t)
    e, k = jcfg.n_experts, jcfg.top_k
    cap = int(max(1, round(t * k / e * jcfg.capacity_factor)))
    assert tmoe.capacity_of(t, tcfg) == cap
    jg, jdest, jst, jsw, jaux = jmoe._route_and_group(
        jnp.asarray(xt), jp["router"], jcfg, cap)
    # the reference's top-k (moe.py:51-53), which it does not return
    jprobs = jax.nn.softmax(jnp.asarray(xt) @ jp["router"], axis=-1)
    _, jtop_e = jax.lax.top_k(jprobs, k)
    probs, _, top_e, _ = tmoe._route(torch.from_numpy(xt), tp["router"],
                                     tcfg)
    srt = np.sort(np.asarray(jprobs), axis=-1)[:, ::-1]
    gap = float((srt[:, k - 1] - srt[:, k]).min())
    print(f"{arch} t={t} capacity {cap}: smallest gap between the k-th "
          f"and the (k+1)-th probability {gap:.3e}")
    _close(probs, jprobs, GROUP_TOL)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop_e))

    g, dest, st, sw, aux = tmoe._route_and_group(
        torch.from_numpy(xt), tp["router"], tcfg, cap)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    assert tuple(g.shape) == (e, cap, jcfg.d_model) and g.dtype == \
        torch.float32
    _close(g, jg, GROUP_TOL)
    _close(sw, jsw, GROUP_TOL)
    _close(aux, jaux, GROUP_TOL)
    dropped = int((dest == e * cap).sum())
    if drop_free:
        assert dropped == 0
    elif t == 24:       # 48 choices over 4 experts of 15 slots: some drop
        assert dropped > 0, "the capacity case drops nothing"


@pytest.mark.parametrize("drop_free", [False, True],
                         ids=["capacity", "drop-free"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_and_its_gradients_match_the_reference(arch, drop_free):
    jcfg, tcfg = _cfgs(arch, drop_free)
    jp, tp = _params(jcfg, seed=MOE_ARCHS.index(arch))
    x = _x((2, 12, jcfg.d_model))
    cot = _x((2, 12, jcfg.d_model), seed=7)
    jout, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    out, aux = tmoe.apply_moe(tp, torch.from_numpy(x), tcfg)
    assert out.dtype == torch.float32 and tuple(out.shape) == x.shape
    _close(out, jout, APPLY_TOL)
    _close(aux, jaux, GROUP_TOL)

    def jloss(p, xx):
        o, a = jmoe.apply_moe(p, xx, jcfg)
        return jnp.sum(o * cot) + a

    def tloss(p, xx):
        o, a = tmoe.apply_moe(p, xx, tcfg)
        return torch.sum(o * torch.from_numpy(cot)) + a

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tgp, tgx = torch.func.grad(tloss, argnums=(0, 1))(tp,
                                                      torch.from_numpy(x))
    for name in sorted(jgp):
        want = np.asarray(jgp[name])
        scale = float(np.abs(want).max())
        assert scale > 0 and float(tgp[name].abs().max()) > 0, name
        _close(tgp[name], want, GRAD_REL * scale)
    _close(tgx, jgx, GRAD_REL * float(np.abs(np.asarray(jgx)).max()))


def test_apply_moe_keeps_a_bf16_input_bf16():
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    _, tp = _params(jcfg)
    x = torch.from_numpy(_x((1, 5, jcfg.d_model))).bfloat16()
    out, aux = tmoe.apply_moe(tp, x, tcfg)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert bool(torch.isfinite(out.float()).all())


def test_apply_moe_under_vmap_gives_each_lane_its_own_call():
    """Three lanes of weights and tokens through ``torch.func.vmap`` (how
    the LM population trains its fixed devices): each lane's output and
    gradient equal its own call's."""
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m")
    lanes = [_params(jcfg, seed=s)[1] for s in range(3)]
    stacked = {k: torch.stack([p[k] for p in lanes]) for k in lanes[0]}
    xs = torch.from_numpy(_x((3, 2, 12, jcfg.d_model)))

    def loss(p, x):
        o, a = tmoe.apply_moe(p, x, tcfg)
        return (o ** 2).sum() + a

    outs, auxes = torch.func.vmap(lambda p, x: tmoe.apply_moe(p, x, tcfg))(
        stacked, xs)
    grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)))(stacked,
                                                                   xs)
    for i, p in enumerate(lanes):
        out, aux = tmoe.apply_moe(p, xs[i], tcfg)
        torch.testing.assert_close(outs[i], out, atol=LANE_TOL, rtol=0)
        torch.testing.assert_close(auxes[i], aux, atol=LANE_TOL, rtol=0)
        gp, gx = torch.func.grad(loss, argnums=(0, 1))(p, xs[i])
        for name in gp:
            scale = float(gp[name].abs().max())
            torch.testing.assert_close(grads[0][name][i], gp[name],
                                       atol=LANE_TOL * scale, rtol=0)
        torch.testing.assert_close(grads[1][i], gx,
                                   atol=LANE_TOL * float(gx.abs().max()),
                                   rtol=0)


def test_ungroup_replays_bitwise_and_matches_the_scatter_add():
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m")
    jp, tp = _params(jcfg)
    t, d = 24, jcfg.d_model
    cap = tmoe.capacity_of(t, tcfg)
    xt = torch.from_numpy(_x((t, d)))
    g, dest, st, sw, _ = tmoe._route_and_group(xt, tp["router"], tcfg, cap)
    out_g = tmoe._expert_ffn(g, tp["wi_gate"], tp["wi_up"], tp["wo"],
                             tcfg.act)
    first = tmoe._ungroup(out_g, dest, st, sw, t, d)
    second = tmoe._ungroup(out_g.clone(), dest.clone(), st.clone(),
                           sw.clone(), t, d)
    assert first.dtype == torch.float32
    assert torch.equal(first, second)
    want = jmoe._ungroup(jnp.asarray(out_g.numpy()), jnp.asarray(
        dest.numpy()), jnp.asarray(st.numpy()), jnp.asarray(sw.numpy()), t, d)
    want = np.asarray(want)
    np.testing.assert_allclose(first.numpy(), want,
                               atol=1e-6 * float(np.abs(want).max()), rtol=0)
