"""Property tests of the port's cost count and roofline
(``repro_torch.launch``): generated shapes with analytically known FLOPs,
bytes and peaks must come out of ``CostCounter`` exactly, the tuning
cache's nearest-shape rule must pick what the reference's picks, and every
kernel's bound must be the larger of its two terms."""
try:
    from hypothesis import given, settings, strategies as st
except ImportError:                              # tier-1 container: fixed-seed sweep
    from repro.testing.hypo import given, settings, strategies as st

import pytest

torch = pytest.importorskip("torch")

from repro.launch import autotune as jtune  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro_torch.kernels.encounter_mix import encounter_mix  # noqa: E402
from repro_torch.kernels.encounter_mix.ref import encounter_gate, radius_sq  # noqa: E402
from repro_torch.launch import autotune, roofline  # noqa: E402
from repro_torch.launch.cost_analysis import CostCounter  # noqa: E402

torch.set_num_threads(1)


def _dot_module(m, k, n):
    return f"""HloModule dot

ENTRY %main (a: f32[{m},{k}], b: f32[{k},{n}]) -> f32[{m},{n}] {{
  %a = f32[{m},{k}]{{1,0}} parameter(0)
  %b = f32[{k},{n}]{{1,0}} parameter(1)
  ROOT %d = f32[{m},{n}]{{1,0}} dot(%a, %b), lhs_contracting_dims={{1}}, rhs_contracting_dims={{0}}
}}
"""


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 300), st.integers(1, 300), st.integers(1, 300))
def test_matmul_count_is_the_hlo_analysis(m, k, n):
    with CostCounter() as cc:
        torch.mm(torch.empty(m, k, device="meta"),
                 torch.empty(k, n, device="meta"))
    ref = analyze_hlo(_dot_module(m, k, n))
    assert cc.flops == ref.flops == 2 * m * k * n
    assert cc.bytes == ref.bytes == 4 * (m * k + k * n + m * n)


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 8), st.integers(1, 64), st.integers(1, 64),
       st.integers(1, 64), st.sampled_from(["float32", "bfloat16"]))
def test_bmm_flops_by_dtype(b, m, k, n, dtype):
    dt = getattr(torch, dtype)
    with CostCounter() as cc:
        torch.bmm(torch.empty(b, m, k, device="meta", dtype=dt),
                  torch.empty(b, k, n, device="meta", dtype=dt))
    name = {"float32": "f32", "bfloat16": "bf16"}[dtype]
    assert cc.flops_by == {f"mm:{name}": 2.0 * b * m * k * n}


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(1, 5000), min_size=1, max_size=6),
       st.integers(0, 5))
def test_peak_live_bytes_of_an_allocation_chain(sizes, keep):
    """Tensors made and dropped in order: the peak is the largest live
    set, each storage counted once however many views read it."""
    with CostCounter() as cc:
        held, live, peak = [], 0, 0
        for i, n in enumerate(sizes):
            t = torch.empty(n, device="meta") + 1.0     # a fresh storage
            _ = t.view(-1)[: max(1, n // 2)] * 1.0      # a view, a temporary
            live += 4 * n
            peak = max(peak, live + 4 * max(1, n // 2))
            if i < keep:
                held.append(t)
            else:
                del t
                live -= 4 * n
    # the ``torch.empty`` before each ``+ 1.0`` is live beside its sum
    assert cc.peak_live_bytes >= peak
    assert cc.peak_live_bytes <= peak + 4 * max(sizes) + 4 * max(sizes)


@settings(max_examples=20, deadline=None)
@given(st.lists(st.tuples(st.integers(1, 1 << 20), st.integers(1, 1 << 12)),
                min_size=1, max_size=6),
       st.integers(1, 1 << 20), st.integers(1, 1 << 12))
def test_nearest_entry_is_the_reference_s(shapes, d, m):
    entries = [{"d": a, "m": b, "i": i} for i, (a, b) in enumerate(shapes)]
    for q in ({"d": d}, {"d": d, "m": m}):
        assert autotune._nearest(entries, q) is jtune._nearest(entries, q)


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 20), st.integers(1, 2000), st.integers(1, 1 << 20),
       st.integers(0, 10 ** 6), st.sampled_from([2, 4]), st.integers(1, 4))
def test_every_bound_is_its_larger_term(f, m, d, nnz, w_bytes, lanes):
    works = [roofline.mule_agg_work(f, m, d, w_bytes, lanes),
             roofline.encounter_mix_work(m, d, nnz, w_bytes, lanes),
             roofline.encounter_hop_work(f, m, d, nnz, lanes),
             roofline.ssd_work(lanes, m, f, 64, 64),
             roofline.slstm_work(lanes, m, f, 256),
             roofline.flash_attention_work(lanes, m, m + f, 4 * f, f, 64,
                                           True, None, torch.bfloat16)]
    for w in works:
        assert w.bound_ms == max(w.t_bytes_ms, w.t_ops_ms)
        assert w.bound_by == ("bytes" if w.t_bytes_ms >= w.t_ops_ms
                              else "operations")
        assert w.n_bytes > 0


@settings(max_examples=10, deadline=None)
@given(st.integers(2, 40), st.integers(1, 64), st.integers(0, 3),
       st.booleans())
def test_encounter_mix_priced_once_at_its_met_pairs(m, d, seed, zero_pos):
    """On a CPU tensor the mix is its plain version, counted as one kernel
    call of 2 nnz D FLOPs: none of the plain version's matmuls."""
    g = torch.Generator().manual_seed(seed)
    pos = (torch.zeros(m, 2) if zero_pos else torch.rand(m, 2, generator=g))
    area = torch.randint(0, 2, (m,), generator=g)
    active = torch.rand(m, generator=g) < 0.9
    w = torch.randn(m, d, generator=g)
    with CostCounter() as cc:
        _, mass = encounter_mix(pos, area, active, w, radius=0.3)
    d2, gate = encounter_gate(pos, area, active, 0, pos, area, active, 0)
    nnz = int(((d2 <= radius_sq(0.3)) & gate).sum())
    assert int(mass.sum()) == nnz
    assert cc.kernels == {"encounter_mix": 1}
    assert cc.flops_by == ({"fma:f32": 2.0 * nnz * d} if nnz else {})
    assert cc.bytes == roofline.encounter_mix_work(m, d, nnz).n_bytes


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 4), st.integers(1, 20), st.integers(1, 40),
       st.integers(1, 300))
def test_vmapped_lanes_priced_once(s, f, m, d):
    """``mule_agg_op`` under ``vmap`` reaches ``mule_agg_lanes`` once for
    all lanes, priced as S lanes, on the CPU as on ``meta``."""
    from repro_torch.kernels.mule_agg.ops import mule_agg_op
    for dev in ("cpu", "meta"):
        a = torch.rand(s, f, m, device=dev)
        w = torch.randn(s, m, d, device=dev)
        with CostCounter() as cc:
            out = torch.func.vmap(mule_agg_op)(a, w)
        assert tuple(out.shape) == (s, f, d)
        work = roofline.mule_agg_work(f, m, d, 4, s)
        assert cc.kernels == {"mule_agg": 1}
        assert cc.flops_by == {"fma:f32": float(work.n_flop)}
        assert cc.bytes == work.n_bytes


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 6), st.integers(1, 3), st.integers(1, 4),
       st.integers(3, 9), st.integers(1, 3))
def test_vmapped_conv_grad_counts_each_lane_once(lanes, b, c_out, hw, k):
    """A vmapped model's convolution runs as one grouped convolution (the
    lanes as groups); forward and backward count each lane's work once,
    the lanes times the single model's."""
    x = torch.randn(lanes, b, 3, hw, hw)
    w = torch.randn(lanes, c_out, 3, k, k)

    def loss(w1, x1):
        return torch.nn.functional.conv2d(x1, w1).square().sum()

    with CostCounter() as one:
        torch.func.grad(loss)(w[0], x[0])
    with CostCounter() as many:
        torch.func.vmap(torch.func.grad(loss))(w, x)
    fwd = 2 * b * c_out * 3 * k * k * (hw - k + 1) ** 2
    assert one.flops_by == {"conv:f32": 2.0 * fwd}     # forward, grad w
    assert many.flops == lanes * one.flops


def _meta_mesh(dp, ep, index):
    """A (data, model) mesh seen from the rank at model index ``index``,
    with no process group: on ``meta`` the collectives move nothing."""
    from repro_torch.launch.mesh import MuleMesh
    return MuleMesh(shape={"data": dp, "model": ep},
                    coords={"data": 0, "model": index}, groups={},
                    data_axis="model")


@settings(max_examples=20, deadline=None)
@given(st.sampled_from([(4, 2), (8, 2), (8, 4), (32, 8)]),
       st.sampled_from([1, 2, 4]), st.integers(1, 3), st.integers(0, 10),
       st.sampled_from([16, 64]), st.sampled_from(["float32", "bfloat16"]),
       st.sampled_from([1.0, 1.25, 8.0]))
def test_moe_layer_all_to_all_bytes_per_rank(ek, ep, b, m, d, dtype, cf):
    """One expert-parallel MoE layer moves ``2 E C d`` elements through
    all-to-all a rank (the pair), ``C`` the per-peer capacity, and gathers
    its ``t_loc / ep`` f32 output rows and its aux loss; its gradient with
    respect to the weights and the input moves the pair again."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    e, k = ek
    if e % ep:
        return
    # the peers split the block's tokens evenly, or each takes them all
    # (one token a row, fewer tokens than peers)
    b, s = (b, m * ep) if m else (1, 1)
    cfg = dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"),
                              n_experts=e, top_k=k, d_model=d, d_ff=8,
                              dtype=dtype, capacity_factor=cf)
    mesh = _meta_mesh(2, ep, ep - 1)
    dt = getattr(torch, dtype)
    params = {"router": torch.empty(d, e, device="meta"),
              **{n: torch.empty((e // ep,) + shp, device="meta")
                 for n, shp in (("wi_gate", (d, 8)), ("wi_up", (d, 8)),
                                ("wo", (8, d)))}}
    x = torch.empty(b, s, d, device="meta", dtype=dt)
    t_loc = b * s
    c = moe.capacity_of(max(t_loc // ep, 1), cfg)
    pair = 2 * e * c * d * dt.itemsize if ep > 1 else 0
    with CostCounter() as cc:
        out, _ = moe.apply_moe(params, x, cfg, mesh=mesh)
    assert out.shape == x.shape
    assert cc.coll["all-to-all"] == pair
    gathered = 4 * (t_loc // ep) * d if ep > 1 and t_loc >= ep else 0
    aux_gather = 4 if ep > 1 else 0
    assert cc.coll["all-gather"] == gathered + aux_gather
    with CostCounter() as cc:
        torch.func.grad(lambda p, x: moe.apply_moe(p, x, cfg, mesh=mesh)[0]
                        .float().sum(), argnums=(0, 1))(params, x)
    assert cc.coll["all-to-all"] == 2 * pair
