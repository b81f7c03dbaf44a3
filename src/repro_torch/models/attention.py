"""GQA attention layer: full-sequence (prefill), KV-cache decode, and
cross-attention.

Port of ``repro.models.attention``: QKV bias (qwen), sliding windows
(gemma3's local layers, with a rolling KV cache at decode), RoPE and M-RoPE
(qwen2-vl: positions [3, B, S]), bidirectional and RoPE-free layers
(``causal=False``, ``rope=False``: Whisper's encoder and decoder) and
Whisper's cross-attention (``cross_kv``, ``cross_attn_forward``). The
self-attention of the full-sequence path goes through ``flash_attention``,
which launches the hand-written kernel for CUDA tensors and differentiates
through the reference's blockwise backward. Cross-attention takes the
plain chunked version (``backend="ref"``) on every device, as the
reference's does, so it launches no kernel. The reference's
``d_model`` argument of ``init_attention`` is used by no model, so the
port leaves it out.

On a mesh of ranks (``mesh``: ``launch.sharding.rank_specs``' blocks, the
``"model"`` axis) a layer runs on the heads its weights hold, read from
their widths, not from ``cfg.n_heads``:

- ``wq`` (and ``bq``) whole: every peer runs the whole attention, with no
  collective (qwen2.5-32b's smoke config: 5 heads), unless ``head_axis``
  (below);
- ``wq`` split by heads: the input enters through ``replicated``, the
  rank's rows of ``wo`` give a partial output, summed by
  ``reduce_from_peers`` (Megatron's f and g). With ``wk`` and ``wv`` split
  too, the rank's kv heads are the ones its query heads read (global q
  head h reads kv head h // G). With them whole (``n_kv_heads`` does not
  divide: granite-34b's single kv head, gemma3-4b at 8 ranks), every peer
  computes every kv head from the input as it is, passes k and v through
  ``replicated`` (each peer uses its own heads of them, so their weights'
  gradients are the sum of the peers' partial ones) and keeps the kv heads
  its query heads read before the kernel (``kv_take``).

``head_axis="model"`` (the reference's ``_constrain_heads``: GSPMD pads a
head count that does not divide the axis) runs a layer whose ``wq`` is
whole on the rank's padded block of query heads (``head_block``: ``c =
ceil(n_heads / n)`` heads a rank, rank ``r`` the heads ``[r c, min((r +
1) c, n_heads))``, so trailing ranks may hold none). q comes from the
rank's columns of ``wq`` (and ``bq``), k and v from the columns of
``wk`` / ``wv`` of the kv heads those query heads read (``kv_take``; with
one kv head, the whole of them, which the reference leaves
unconstrained), and the rank's rows of ``wo`` give a partial output,
summed by ``reduce_from_peers``. The input and the whole weights enter
through ``collectives.replicated``, in f32: their cotangents, each
peer's partial (zero outside its block for a weight), are summed over the
peers in rank order in one transfer a layer, so each weight's gradient is
the whole one, the same bits on every peer, and the peers' sums come in
the same order whatever heads they hold. A rank with no heads launches
nothing and adds zeros; its empty q keeps it in that sum. Where the heads
divide, ``wq`` is split already and ``head_axis`` changes nothing.
Decode does not take ``head_axis``, as the reference's ``attn_decode``
does not: its layers run on the rank's block of each KV cache, as
``launch.sharding.kv_cache_cut`` lays it out (``cache_specs``' rule). Where
the kv heads do not divide ``"model"`` and ``head_dim`` does, the rank
holds every kv head's block of ``head_dim`` columns: it computes k and v
whole (``wk`` and ``wv`` are whole exactly there), RoPE on the whole
``head_dim``, writes its columns, takes every query head's q (gathered
over ``"model"`` where ``wq`` is split), sums the partial scores of its
columns over ``"model"`` in rank order (``collectives.psum``, f32, so
every peer holds the same bits; before the slot split's combine where
both apply), runs ``p @ v`` on its columns and gathers the output's
blocks, then goes on into the output projection with its heads. This is
what GSPMD does with the reference's layout. The ``audio`` family holds
its weights whole: a cache cut by kv heads runs the columns of the rank's
heads and gathers their outputs before the whole ``wo``, self- and
cross-attention alike (``cross_attn_decode``, Whisper's decode step's
cross-attention, plain PyTorch as the reference's).

Context parallelism (``seq_axis``, the reference's ``_constrain_seq``: q's
sequence over that axis, K/V all-gathered where attention needs them, the
Llama3 layout) runs on the rank's block of ``S / n`` positions: q, k and v
come from the block, k and v (after RoPE) go through ``collectives.
gather_seq`` in one call, and the kernel runs the rank's queries against
the prefix ``[0, (r + 1) S / n)``, causal and right-aligned, which is the
whole sequence's causal mask (and its sliding window) for those rows. The
full gather is the reference's own (GSPMD gathers all K/V too); it
composes with the head split over ``"model"``. At decode, a KV cache whose
slots are split over ranks (``launch.sharding.cache_seq_axes``: its
``"slots"`` entry holds the whole cache's count) takes the new K/V on the
rank that owns slot ``pos``; each rank's partial softmax over its own
slots (its max, its sum of exponentials, its unnormalised output) is
gathered and combined in rank order, so every rank holds the same bits,
and a rank whose slots are all masked weighs 0.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import collectives as coll
from repro_torch.launch.sharding import KVCut
from repro_torch.models.layers import apply_rope, dense_init, rope_angles

NEG_INF = -1e30


def compute_dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_attention(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, (d, cfg.n_heads * hd)),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd)),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd)),
        "wo": dense_init(gen, (cfg.n_heads * hd, d)),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((n * hd,), device=gen.device)
    return p


def kv_take(cfg: ModelConfig, q0: int, hq: int):
    """The kv heads that query heads ``q0 .. q0 + hq - 1`` read (global q
    head h reads kv head h // G): a slice where they read whole groups or
    lie inside one group, else one kv head a query head (a list)."""
    g = cfg.n_heads // cfg.n_kv_heads
    first, last = q0 // g, (q0 + hq - 1) // g
    if q0 % g == 0 and hq % g == 0:
        return slice(first, first + hq // g)
    if first == last:
        return slice(first, first + 1)
    return [(q0 + i) // g for i in range(hq)]


def _taken(take) -> int:
    return take.stop - take.start if isinstance(take, slice) else len(take)


def rank_kv_heads(params, cfg: ModelConfig, mesh,
                  cut: KVCut = KVCut()) -> Tuple[int, int]:
    """(kv heads, head_dim) of the decode cache of the rank holding
    ``params`` (its ``wq`` and ``wk`` blocks, or their shapes) under
    ``cut`` (``launch.sharding.kv_cache_cut``): ``cache_specs``' block
    where it cuts the kv heads or ``head_dim``; where it cuts neither, the
    kv heads the rank's query heads read (``kv_take``) where only q is
    split, else the kv heads its weights hold, at the whole ``head_dim``
    (``params`` ``None``: whole weights)."""
    hd = cfg.resolved_head_dim
    if cut.head_dim is not None:
        return cfg.n_kv_heads, hd // mesh.axis_size(cut.head_dim)
    if cut.heads is not None:
        return cfg.n_kv_heads // mesh.axis_size(cut.heads), hd
    if params is None:
        return cfg.n_kv_heads, hd
    hq, hkv = params["wq"].shape[-1] // hd, params["wk"].shape[-1] // hd
    if mesh is None or hq == cfg.n_heads or hkv != cfg.n_kv_heads:
        return hkv, hd
    return _taken(kv_take(cfg, mesh.axis_index("model") * hq, hq)), hd


HEAD_AXES = (None, "model")     # what Model(head_axis=) takes


def head_block(cfg: ModelConfig, mesh, head_axis) -> Optional[tuple]:
    """(first, count) of the query heads this rank runs under
    ``head_axis`` (GSPMD's padded block, module docstring), or ``None``
    where ``head_axis`` changes nothing: no mesh, one peer, or heads that
    divide (``wq`` split already)."""
    if head_axis is None or mesh is None:
        return None
    n = mesh.axis_size(head_axis)
    if n == 1 or cfg.n_heads % n == 0:
        return None
    c = -(-cfg.n_heads // n)
    first = min(mesh.axis_index(head_axis) * c, cfg.n_heads)
    return first, min(first + c, cfg.n_heads) - first


def _block_weights(params, x: torch.Tensor, cfg: ModelConfig, mesh,
                   block):
    """Under ``head_axis`` (module docstring), the rank's slices of whole
    weights for the query heads ``block`` (first, count): the columns of
    ``wq`` (``bq``) of those heads, of ``wk`` / ``wv`` (``bk`` / ``bv``)
    of the kv heads they read, the rows of ``wo``; the input; and, where a
    query head's kv head is not its place in a slice of them
    (``kv_take``'s list), the index of each among those columns."""
    hd = cfg.resolved_head_dim
    q0, hq = block
    take = kv_take(cfg, q0, hq) if hq else slice(0, 0)
    local = None
    if isinstance(take, slice):
        first, stop = take.start, take.stop
    else:
        first, stop = take[0], take[-1] + 1
        local = [h - first for h in take]
    names = ["wq", "wk", "wv", "wo"] + ["bq", "bk", "bv"] * cfg.qkv_bias
    # the input and the whole weights in one transfer of the backward,
    # so every peer's sums come in the same order whatever its heads
    xw = coll.replicated([x.float()] + [params[k].float() for k in names],
                         mesh, "model")
    w = dict(zip(names, xw[1:]))
    cols, kv = slice(q0 * hd, (q0 + hq) * hd), slice(first * hd, stop * hd)
    out = {"wq": w["wq"][:, cols], "wk": w["wk"][:, kv],
           "wv": w["wv"][:, kv], "wo": w["wo"][cols]}
    if cfg.qkv_bias:
        out.update(bq=w["bq"][cols], bk=w["bk"][kv], bv=w["bv"][kv])
    return out, xw[0], local


def _qkv(params, x: torch.Tensor, cfg: ModelConfig, compute_dtype,
         mesh=None, block=None, take_kv: bool = True):
    """q [B, S, hq, hd], k and v [B, S, kv, hd] of the heads this rank's
    weights hold, or under ``head_axis`` of the query heads ``block``
    (first, count) of whole weights (module docstring); the rank's rows of
    ``wo``; and whether q is split over the mesh's ``"model"`` axis.
    ``take_kv=False`` keeps every kv head of whole ``wk`` / ``wv`` under
    a split q (a decode cache cut along ``head_dim`` holds them all)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    local = None
    if block is not None:
        # the weights and the input came through ``replicated`` already
        params, x, local = _block_weights(params, x, cfg, mesh, block)
    hq, hkv = params["wq"].shape[-1] // hd, params["wk"].shape[-1] // hd
    q_split = mesh is not None and hq != cfg.n_heads
    kv_split = block is not None or hkv != cfg.n_kv_heads
    xc = (coll.replicated(x, mesh, "model") if q_split and block is None
          else x).to(compute_dtype)
    # kv from the input as it is where their weights are whole under a
    # split q: their cotangent is summed over the peers after the heads
    # (``replicated`` below), not through the input's
    xk = xc if kv_split or not q_split else x.to(compute_dtype)
    q = xc @ params["wq"].to(compute_dtype)
    k = xk @ params["wk"].to(compute_dtype)
    v = xk @ params["wv"].to(compute_dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(compute_dtype)
        k = k + params["bk"].to(compute_dtype)
        v = v + params["bv"].to(compute_dtype)
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if local is not None:
        k, v = k[:, :, local], v[:, :, local]
    elif q_split and not kv_split and take_kv:
        take = kv_take(cfg, mesh.axis_index("model") * hq, hq)
        k = coll.replicated(k, mesh, "model")[:, :, take]
        v = coll.replicated(v, mesh, "model")[:, :, take]
    return q, k, v, params["wo"], q_split


def _out_proj(wo: torch.Tensor, out: torch.Tensor, compute_dtype, mesh,
              q_split: bool) -> torch.Tensor:
    """out [B, S, hq * hd] @ the rank's rows of ``wo``, summed over the
    peers where q is split."""
    out = out.to(compute_dtype) @ wo.to(compute_dtype)
    if q_split:
        out = coll.reduce_from_peers(out, mesh, "model")
    return out


def _rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
          cfg: ModelConfig):
    """q and k rotated at ``positions`` ([B, S], or [3, B, S] under
    M-RoPE)."""
    ang = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta,
                      cfg.mrope_sections)
    return apply_rope(q, ang), apply_rope(k, ang)


def _gather_prefix(k: torch.Tensor, v: torch.Tensor, mesh, seq_axis: str):
    """k and v [B, S/n, kv, hd] of every peer of ``seq_axis`` in one
    gather, cut to the prefix this rank's queries read."""
    hkv = k.shape[2]
    kv = coll.gather_seq(torch.cat([k, v], dim=2), mesh, seq_axis)
    kv = kv[:, :(mesh.axis_index(seq_axis) + 1) * k.shape[1]]
    return kv[:, :, :hkv].contiguous(), kv[:, :, hkv:].contiguous()


def attn_forward(params, x: torch.Tensor, positions: Optional[torch.Tensor],
                 cfg: ModelConfig, *, window: Optional[int] = None,
                 causal: bool = True, backend: str = "auto",
                 rope: bool = True, mesh=None,
                 head_axis: Optional[str] = None,
                 seq_axis: Optional[str] = None) -> torch.Tensor:
    """Full-sequence self-attention. positions: [B, S] or [3, B, S]
    (M-RoPE); unused with ``rope=False``. On a ``mesh``, the rank's heads,
    under ``head_axis`` its padded block of them where ``wq`` is whole;
    with ``seq_axis``, x and positions are the rank's block of the sequence
    (module docstring)."""
    if seq_axis is not None and not causal:
        raise ValueError("context parallelism runs causal attention: the "
                         "prefix a block reads is its mask")
    compute_dtype = compute_dtype_of(cfg)
    hd = cfg.resolved_head_dim
    block = None
    if params["wq"].shape[-1] == cfg.n_heads * hd:
        block = head_block(cfg, mesh, head_axis)
    q, k, v, wo, q_split = _qkv(params, x, cfg, compute_dtype, mesh, block)
    b, s = x.shape[:2]
    if q.shape[2] == 0:
        # no heads: nothing to launch; the empty q keeps the rank in the
        # backward's sum over the peers
        out = q
    else:
        if rope:
            q, k = _rope(q, k, positions, cfg)
        if seq_axis is not None:
            k, v = _gather_prefix(k, v, mesh, seq_axis)
        out = flash_attention(q, k, v, causal=causal, window=window,
                              backend=backend)
    out = _out_proj(wo, out.reshape(b, s, q.shape[2] * hd), compute_dtype,
                    mesh, q_split)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# decode with KV cache
# ---------------------------------------------------------------------------


def cache_slots(max_seq: int, window: Optional[int] = None) -> int:
    """A layer's KV cache slots: a rolling buffer of ``window`` slots when
    windowed."""
    return min(window, max_seq) if window is not None else max_seq


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  window: Optional[int] = None, dtype=torch.bfloat16, *,
                  device, kv_heads: Optional[int] = None,
                  head_dim: Optional[int] = None, seq_split: int = 1):
    """Cache for ONE attention layer. Rolling buffer when windowed.
    ``kv_heads`` and ``head_dim``: a rank's block (``rank_kv_heads``), by
    default whole. ``seq_split`` > 1: this rank's block of the slots,
    which must divide (``launch.sharding.kv_cache_cut``), with the whole
    count under ``"slots"`` (a host int64 scalar)."""
    slots = cache_slots(max_seq, window)
    if slots % seq_split:
        raise ValueError(f"{slots} cache slots do not split over "
                         f"{seq_split} ranks")
    shape = (batch, slots // seq_split, kv_heads or cfg.n_kv_heads,
             head_dim or cfg.resolved_head_dim)
    out = {"k": torch.zeros(shape, dtype=dtype, device=device),
           "v": torch.zeros(shape, dtype=dtype, device=device)}
    if seq_split > 1:
        out["slots"] = torch.tensor(slots, dtype=torch.int64)
    return out


def _split_softmax(sc: torch.Tensor, valid: torch.Tensor, cv: torch.Tensor,
                   mesh, axes) -> torch.Tensor:
    """softmax(sc) @ v over the slots of every peer of ``axes``, from this
    rank's scores sc [B, kv, G, m], its slots' mask ``valid`` [m] and its
    values cv [B, m, kv, hd]: the peers' partial statistics gathered and
    folded in rank order (module docstring). A rank with no valid slot has
    max NEG_INF, sum 0 and output 0, and weighs exp(NEG_INF - M) = 0."""
    mx = torch.where(valid, sc, NEG_INF).amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(sc - mx), 0.0)
    stats = torch.cat([mx, p.sum(-1, keepdim=True),
                       torch.einsum("bkgj,bjkd->bkgd", p, cv.float())], -1)
    parts = coll.all_gather(stats[None], mesh, axes)   # [n, B, kv, G, 2+hd]
    w = torch.exp(parts[..., :1] - parts[..., :1].amax(0))
    num, den = w[0] * parts[0, ..., 2:], w[0] * parts[0, ..., 1:2]
    for i in range(1, parts.shape[0]):
        num = num + w[i] * parts[i, ..., 2:]
        den = den + w[i] * parts[i, ..., 1:2]
    return num / den


def _attend_cache(qg: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                  valid: torch.Tensor, mesh, cut: KVCut) -> torch.Tensor:
    """softmax(q k / sqrt(hd)) v of one query token over the rank's block
    of a cache: qg [B, kv, G, hd] f32 (every column of the heads), ck and
    cv [B, m, kv, hd_r] the block (``cut``), ``valid`` [m] its slots'
    mask. On a ``head_dim`` block the partial scores are summed over its
    axis in rank order (f32, the same bits on every peer) before the
    softmax, which combines the ranks' partial softmaxes over a slot cut;
    the output's ``head_dim`` blocks are gathered back. [B, kv, G, hd]."""
    hd = qg.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), device=qg.device))
    qs = qg * scale
    if cut.head_dim is not None:
        hdr = ck.shape[-1]
        lo = mesh.axis_index(cut.head_dim) * hdr
        qs = qs[..., lo:lo + hdr]
    sc = torch.einsum("bkgd,bjkd->bkgj", qs, ck.float())
    if cut.head_dim is not None:
        sc = coll.psum(sc, mesh, cut.head_dim)
    if cut.slots is not None:
        out = _split_softmax(sc, valid, cv, mesh, cut.slots)
    else:
        p = torch.softmax(torch.where(valid, sc, NEG_INF), dim=-1)
        out = torch.einsum("bkgj,bjkd->bkgd", p, cv.float())
    if cut.head_dim is not None:
        out = _gather_last(out, mesh, cut.head_dim)
    return out


def _head_columns(params, cfg: ModelConfig, mesh, axis) -> dict:
    """Whole ``wq`` / ``wk`` / ``wv`` (and biases) cut to the columns of
    the rank's block of kv heads along ``axis`` and of the query heads
    that read them (a decode cache cut by heads under whole weights)."""
    hd = cfg.resolved_head_dim
    n, r = mesh.axis_size(axis), mesh.axis_index(axis)
    hq, kv = cfg.n_heads // n, cfg.n_kv_heads // n
    cols = slice(r * hq * hd, (r + 1) * hq * hd)
    kvc = slice(r * kv * hd, (r + 1) * kv * hd)
    out = {"wq": params["wq"][:, cols], "wk": params["wk"][:, kvc],
           "wv": params["wv"][:, kvc], "wo": params["wo"]}
    if cfg.qkv_bias:
        out.update(bq=params["bq"][cols], bk=params["bk"][kvc],
                   bv=params["bv"][kvc])
    return out


def _gather_last(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """Every peer's x [..., c] of ``axis`` joined along the last dimension
    in rank order: [..., n c] (the blocks of ``head_dim``, or the heads'
    outputs [B, 1, hq_r hd] in head order)."""
    parts = coll.all_gather(x[None].contiguous(), mesh, axis)
    return torch.movedim(parts, 0, -2).reshape(
        x.shape[:-1] + (parts.shape[0] * x.shape[-1],))


def attn_decode(params, x: torch.Tensor, cache, pos: int, cfg: ModelConfig,
                *, window: Optional[int] = None, rope: bool = True,
                mesh=None, cut: KVCut = KVCut()):
    """One-token decode. x: [B, 1, D]; pos: the current position (int),
    the same in all three streams under M-RoPE.

    Cached K/V are stored post-RoPE. For windowed layers the cache is a
    rolling buffer of ``window`` slots written at ``pos % window``. Where
    the reference returns an updated copy, the port writes the new K/V into
    ``cache`` in place (no copy of the cache per token) and returns it.

    On a ``mesh`` the cache is the rank's block under ``cut``
    (``launch.sharding.kv_cache_cut``, ``cache_specs``' rule):

    - kv heads over ``"model"``: with ``wk`` / ``wv`` split, the rank's
      heads as in the forward; with whole weights (Whisper), the columns
      of the rank's kv heads and of the query heads that read them, whose
      outputs are gathered over ``"model"`` before the whole ``wo``;
    - ``head_dim`` over ``"model"`` (``wk`` / ``wv`` whole there): every
      kv head's k and v computed whole, RoPE on the whole ``head_dim``,
      the rank's block written; every query head's q (gathered over
      ``"model"`` where ``wq`` is split); partial scores summed in rank
      order, ``p @ v`` on the block, its blocks gathered, and the rank's
      heads (all of them where ``wq`` is whole) into ``_out_proj``;
    - neither: the kv heads the rank's query heads read (``rank_kv_heads``);
    - the slots over ``cut.slots`` (the cache holds ``"slots"``, the whole
      count): the new K/V written by the rank that owns slot ``pos``, the
      ranks' partial softmaxes combined (module docstring).
    """
    compute_dtype = compute_dtype_of(cfg)
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    ck, cv = cache["k"], cache["v"]
    whole_kv = params["wk"].shape[-1] == cfg.n_kv_heads * hd
    gather_axis = None
    if cut.heads is not None and whole_kv:
        gather_axis = cut.heads
        q, k, v, wo, q_split = _qkv(
            _head_columns(params, cfg, mesh, cut.heads), x, cfg,
            compute_dtype)
    elif cut.head_dim is not None and not whole_kv:
        raise ValueError(f"{cfg.name}: a cache cut along head_dim needs "
                         f"whole wk / wv, not {params['wk'].shape[-1]} of "
                         f"{cfg.n_kv_heads * hd} columns")
    else:
        q, k, v, wo, q_split = _qkv(params, x, cfg, compute_dtype, mesh,
                                    take_kv=cut.head_dim is None)
    if tuple(ck.shape[2:]) != (k.shape[2], hd if cut.head_dim is None
                               else hd // mesh.axis_size(cut.head_dim)):
        raise ValueError(f"{cfg.name}: a cache block {tuple(ck.shape)} "
                         f"under {cut} for {k.shape[2]} kv heads of "
                         f"head_dim {hd}")
    if rope:
        positions = torch.full((b, 1), pos, dtype=torch.int32,
                               device=x.device)
        if cfg.mrope_sections is not None:
            positions = positions.expand(3, b, 1)
        q, k = _rope(q, k, positions, cfg)
    hq = q.shape[2]
    if cut.head_dim is not None:
        lo = mesh.axis_index(cut.head_dim) * ck.shape[-1]
        k, v = k[..., lo:lo + ck.shape[-1]], v[..., lo:lo + ck.shape[-1]]
        if q_split:     # every query head reads the rank's columns
            q = torch.movedim(coll.all_gather(
                torch.movedim(q, 2, 0).contiguous(), mesh, "model"), 0, 2)

    mine = ck.shape[1]
    split = cut.slots is not None
    slots = int(cache["slots"]) if split else mine
    first = mesh.axis_index(cut.slots) * mine if split else 0
    slot = pos % slots if window is not None else pos
    if first <= slot < first + mine:
        ck[:, slot - first] = k[:, 0].to(ck.dtype)
        cv[:, slot - first] = v[:, 0].to(cv.dtype)

    # attention over the cache (linear in cache length)
    kv = ck.shape[2]
    qg = q.reshape(b, kv, q.shape[2] // kv, hd).float()
    slot_idx = torch.arange(first, first + mine, device=x.device)
    if window is not None:
        # slot s holds position p = s (mod slots), the largest such p <= pos
        slot_pos = pos - torch.remainder(pos - slot_idx, slots)
        valid = (slot_pos >= 0) & (slot_pos <= pos) & (slot_pos > pos - window)
    else:
        valid = slot_idx <= pos
    out = _attend_cache(qg, ck, cv, valid, mesh, cut)
    out = out.reshape(b, 1, q.shape[2] * hd)
    if cut.head_dim is not None and q_split:    # the rank's heads
        r = mesh.axis_index("model")
        out = out[..., r * hq * hd:(r + 1) * hq * hd]
    if gather_axis is not None:
        out = _gather_last(out, mesh, gather_axis)
    out = _out_proj(wo, out, compute_dtype, mesh, q_split)
    return out.to(x.dtype), cache


# ---------------------------------------------------------------------------
# cross-attention (whisper decoder)
# ---------------------------------------------------------------------------


def cross_attn_forward(params, x: torch.Tensor, enc_k: torch.Tensor,
                       enc_v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: [B, S, D] queries; enc_k, enc_v: [B, Se, KV, hd] from ``cross_kv``
    (or a cache of another dtype). Bidirectional, through the plain chunked
    version on every device, as in the reference. The plain version
    computes in float32 whatever its inputs' dtype, so q, k and v are
    widened to the wider of their dtypes (exactly) rather than k and v
    rounded to q's."""
    compute_dtype = compute_dtype_of(cfg)
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    xc = x.to(compute_dtype)
    q = (xc @ params["wq"].to(compute_dtype)).reshape(b, s, cfg.n_heads, hd)
    wide = torch.promote_types(q.dtype, enc_k.dtype)
    out = flash_attention(q.to(wide), enc_k.to(wide), enc_v.to(wide),
                          causal=False, backend="ref")
    out = out.reshape(b, s, cfg.n_heads * hd).to(compute_dtype)
    return (out @ params["wo"].to(compute_dtype)).to(x.dtype)


def cross_attn_decode(params, x: torch.Tensor, ck: torch.Tensor,
                      cv: torch.Tensor, cfg: ModelConfig, *, mesh=None,
                      cut: KVCut = KVCut()) -> torch.Tensor:
    """``cross_attn_forward`` of one query token x [B, 1, D] (the decode
    step's), against a cross-attention cache or, on a mesh, the rank's
    block of it (``cut``, ``launch.sharding.kv_cache_cut``; the weights
    whole): the rank's query heads where the heads are cut, their outputs
    gathered over ``"model"``; partial scores summed over ``"model"`` on a
    ``head_dim`` block; the ranks' partial softmaxes combined over a slot
    cut (``_attend_cache``). Plain PyTorch in f32, as the reference's
    cross-attention is."""
    compute_dtype = compute_dtype_of(cfg)
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    wq, hq = params["wq"], cfg.n_heads
    if cut.heads is not None:
        hq //= mesh.axis_size(cut.heads)
        r = mesh.axis_index(cut.heads)
        wq = wq[:, r * hq * hd:(r + 1) * hq * hd]
    kv = ck.shape[2]
    q = x.to(compute_dtype) @ wq.to(compute_dtype)
    qg = q.reshape(b, kv, hq // kv, hd).float()
    valid = torch.ones(ck.shape[1], dtype=torch.bool, device=x.device)
    out = _attend_cache(qg, ck, cv, valid, mesh, cut).reshape(b, 1, hq * hd)
    if cut.heads is not None:
        out = _gather_last(out, mesh, cut.heads)
    out = out.to(compute_dtype) @ params["wo"].to(compute_dtype)
    return out.to(x.dtype)


def cross_kv(params, enc_out: torch.Tensor, cfg: ModelConfig):
    """Cross-attention K/V [B, Se, KV, hd] of the encoder's output."""
    compute_dtype = compute_dtype_of(cfg)
    b, se, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    e = enc_out.to(compute_dtype)
    k = (e @ params["wk"].to(compute_dtype)).reshape(b, se, cfg.n_kv_heads, hd)
    v = (e @ params["wv"].to(compute_dtype)).reshape(b, se, cfg.n_kv_heads, hd)
    return k, v
