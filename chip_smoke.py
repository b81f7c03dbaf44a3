#!/usr/bin/env python3
"""Run the PyTorch/CUDA port of ML Mule on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final result line):

1. the card's name and power limit, as nvidia-smi reports them;
2. build every kernel of ``src/repro_torch`` from its sources with nvcc,
   all at once, and print the build time;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shape and at ragged and edge shapes, in f32 and bf16, with
   TF32 off; time the kernel, the plain version and the one PyTorch call
   that computes the same function (CUDA events, median after warm-up).
   ``mule_agg`` is held at every tile height F = 1..16, at F = 17, 20
   and 33 (row tiles), at D % 4 != 0, odd bf16 rows, rows out of 16-byte
   alignment, bf16 at D = 546,484 and M = 1,100, and ``masked_group_mean``
   runs at F = 20 through "auto" against "ref"; it is timed at the main
   path's (8, 256, 546,484), the multi-area (12, 256, 546,484), Table 1's
   (8, 20, 546,484) and the HAR (8, 256, 44,580) shapes beside
   ``torch.matmul`` and its bound, W cold (copies rotating over 150 MB),
   a call under 50 us timed in a CUDA graph of launches;
4. the main path: ``mlmule`` in mobile mode on the ``commuter`` scenario at
   the full width of the paper's CNN (32x32x3, conv 32/64, hidden 128, 20
   classes), F=8 fixed devices, M=256 mules, batch 16, lr 0.05, T=60 steps,
   an eval every 20, random weights from a seed, through the port's entry
   points with the default aggregation backend (the ``mule_agg`` kernel).
   Kernel launch counts are zeroed just before the run and read just after;
   every eval must be finite. The same run is replayed with
   ``agg_backend="ref"`` and the final weights of the two must agree;
5. the peer path: ``gossip``, ``oppcl`` and ``mlmule+gossip`` on the
   paper's random walk (P_cross = 0.1, Fig 6) at the same width and sizes,
   with the default encounter backend (the ``encounter_mix`` kernel). Each
   counted run must launch ``encounter_mix`` once per peer exchange (every
   third step; none for ``oppcl``, which has no kernel) and ``mule_agg``
   once per step for the hybrid only. ``gossip`` is replayed bitwise, with
   ``enc_backend="ref"`` under a growth bound, and its mix is held to the
   plain version in lockstep at every exchange;
6. the LM serve path: gemma3-4b at full width (34 layers, d_model 2560,
   head_dim 256, vocab 262144; random f32 weights from a seed) through the
   port's serving entry points. (a) ``make_prefill_step`` on 2 prompts of
   4096 tokens in bf16, which must launch ``flash_attention`` exactly 34
   times, all 34 on its tensor-core route (``tc_launches``), with the
   q/k/v of one local and one global layer held to the plain version, and
   attention's share of a profiled prefill printed; (b) ``serve.generate``
   at the launcher's defaults (batch 4, prompt 16, gen 32), every logit
   finite; (c) an f32 copy of the config
   whose 2 x 4096 prefill through the kernel must match the same prefill
   through ``build_model(cfg, backend="ref")`` (its attention on the SIMT
   route, no tensor-core launch), and whose ``forward`` logits must match
   the ``decode_step`` replay of 64 tokens;
7. the hybrid serve path: zamba2-2.7b at full width (54 layers: 45 Mamba2
   mixers with 80 SSM heads of 64 and state 64, and 9 applications of one
   shared attention block of 32 heads x 80; 2,063,676,080 random f32
   weights from a seed), through the same entry points as phase 6. Its
   2 x 4096 bf16 prefill must launch ``ssd_scan`` exactly 45 times and
   ``flash_attention`` exactly 9 times, all 9 on the tensor-core route;
   the scan inputs of two Mamba2 layers and the q/k/v of one shared
   attention are held to the plain versions; then ``serve.generate``, the f32 copy's prefill against
   ``backend="ref"`` and decode against forward, as in phase 6;
8. the xlstm serve path: xlstm-350m at full width (12 pairs of an mLSTM
   block, 4 heads of 512, and an sLSTM block, 4 heads of 256; d_model
   1024, vocab 50304; 468,260,864 random f32 weights from a seed), through
   the same entry points. Its 2 x 4096 bf16 prefill must launch
   ``slstm_scan`` exactly 12 times; the scan inputs of the first and the
   last sLSTM block are held to the plain version; then
   ``serve.generate``, the f32 copy's prefill against ``backend="ref"``
   and against a copy whose sLSTM runs in float64 (the kernel no farther
   from it than twice the plain version), the same f32 prefill on 2 x 16,
   128 and 512 tokens against ``backend="ref"`` (and measured against the
   f64-sLSTM copy), and decode against forward;
9. the ring peer path: ``spawn_local_cluster`` starts 4 ranks on the one
   card, joined over gloo; each holds its 64-mule block of phase 5's walk,
   bucket-ordered by area (T = 30), at the paper CNN's full width, and runs
   ``gossip`` and then ``oppcl`` through ``gossip_step(ring=...)`` and
   ``oppcl_step(ring=...)`` with the single-host engine's batches and
   global-split keys. Each rank must launch ``encounter_hop`` once per hop
   that the area mask keeps, at every exchange, for gossip and never for
   oppcl, and ``encounter_mix`` never. Rank 0 gathers each exchange's ring
   mix and the state it mixed, and measures them against the single-host
   ``encounter_mix`` (masses equal, mix within 2e-5), and the final weights
   against the single-host run (within the growth bound of phase 5);
   OppCL's peers must equal the single-host argmin bitwise. It prints
   steps/s, the bytes the ranks sent and the hops they pruned;
10. the Table 1 fixed path: the five ``METHODS_FIXED`` (``mlmule``,
   ``fedavg``, ``cfl``, ``fedas``, ``local``) through
   ``experiment.run_with_models`` (``run_experiment``'s body) handed the
   paper CNN at full width, in fixed mode: F = 8 fixed devices, M = 20
   mules on the walk (P_cross = 0.1), ``dir0.01`` data, batch 16, lr 0.05,
   120 pretraining steps, T = 60 (6 federated rounds of 2 local steps), an
   eval every 20 steps. ``mule_agg`` must launch 60 times for ``mlmule``
   and never for the other four; every accuracy finite and in [0, 1],
   every weight finite. ``mlmule`` is replayed bitwise, with
   ``agg_backend="ref"`` under phase 4's growth bound, and its exchange
   and aggregation are held in lockstep (training off) to fp32 order;
   FedAS's server model keeps its personal leaves bitwise; CFL's clusters
   partition the 8 clients and each client holds its cluster's model
   bitwise. Then ``run_experiment`` at the harness's reduced defaults for
   each method, T = 20;
11. the HAR path (Fig 8): ``mlmule`` and ``gossip`` on ``har_commuter``
   through ``run_with_models`` handed the LSTM-CNN at full width (window
   128, 6 channels, conv 32/64, LSTM 64, 4 classes), M = 256, F = 8, batch
   12, lr 0.03, T = 21 (cut from 60), an eval every 20 steps.
   ``mule_agg`` must launch 21 times for ``mlmule``; ``encounter_mix`` 7
   times and ``mule_agg`` never for ``gossip``. Both are replayed bitwise and against their plain
   backend under the growth bound of phases 4 and 5, ``mlmule``'s
   aggregation and ``gossip``'s mix held in lockstep; each prints steps/s,
   peak memory, its accuracy trace and a profile. Then
   ``run_experiment(task="har")`` at its defaults for the five
   ``METHODS_MOBILE``, T = 20;
12. the multi-area path: ``mlmule`` and ``gossip`` on ``multi_area_3city``
   (12 fixed devices in 3 cities) and ``gossip`` on
   ``multi_area_migratory`` (its area a [T, M] column) at the paper CNN's
   full width, M = 256, T = 60, an eval every 20. ``mule_agg`` must launch
   60 times for ``mlmule`` (F = 12, the kernel's 12-row instance),
   ``encounter_mix`` 20 times for ``gossip``; each run replayed bitwise
   and against its plain backend under the growth bound, ``gossip``'s mix
   in lockstep with the plain version at every exchange (1e-5), and no met
   pair across the step's areas;
13. the seed sweep: ``run_sweep`` over S = 4 seeds of the walk (P_cross =
   0.1, each seed its own schedule, data and population) for the five
   ``METHODS_MOBILE`` at the paper CNN's full width, F = 8, M = 256 (1,024
   mule models), batch 16, lr 0.05, T = 21 (cut from 60), an eval every
   20. Each step
   launches ``mule_agg`` and ``encounter_mix`` once for all lanes, through
   their lane-batched entries: ``mule_agg`` 21 launches for ``mlmule`` and
   ``mlmule+gossip``, ``encounter_mix`` 7 for ``gossip`` and
   ``mlmule+gossip``, none for ``oppcl`` and ``local``. The lanes of
   ``mlmule`` and ``gossip`` are held to their sequential
   ``run_population`` runs (weights within the growth bound, ``last_fid``
   and eval steps exact); steps/s and lane-steps/s beside the sequential
   runs', peak memory and a profile of the sweep step. Then
   ``run_sweep_experiment`` at Fig 8's config (har, walk P_cross = 0.1,
   batch 12, lr 0.03) at the harness's default sizes, seeds 0-3, T = 21,
   every accuracy in [0, 1];
14. the streamed path: phase 4's ``mlmule`` run and phase 5's ``gossip``
   run, each through ``run_population`` and through
   ``run_population_streamed`` over the schedule's compact form in chunks
   of 20, with cuDNN's deterministic algorithms: final states,
   ``last_fid`` and evals bitwise equal, ``mule_agg`` 60 and
   ``encounter_mix`` 20 launches in each; steps/s, peak memory and the
   schedule's bytes on the card of both;
15. population scale: the reference's scale workload (a linear model of
   8 weights, F = 8, ``mlmule``, 2 samples a mule a step) on
   ``streaming_commuter``'s procedural stream at M = 100,000 and
   1,000,000, T = 24 (the reference's 96, cut), streamed in chunks of 8
   and through ``run_population``
   over ``materialize_generator``'s schedule: final models and
   ``last_fid`` bitwise equal, ``mule_agg`` 24 launches a run; steps/s,
   schedule bytes and peak memory of each; then ``mule_agg`` timed at
   (8, 1,000,000, 8) beside ``torch.matmul`` and its bytes bound (a
   ``cases`` entry of row 1);
16. the distributed path: ``spawn_local_cluster`` starts 4 ranks of this
   script (``--dist-rank``) on the one card over gloo, each a 64-mule
   block of phase 9's bucket-ordered walk at the CNN's full width, T = 30.
   ``run_population_distributed`` runs the five ``METHODS_MOBILE`` with the
   histogram sketch: ``mule_agg`` 30 launches a rank for ``mlmule`` and
   ``mlmule+gossip``, ``encounter_hop`` once per kept hop for the peer
   methods, ``encounter_mix`` never; every rank's replicated state
   (``fixed_models``, ``fresh``, ``t``) bitwise equal. ``mlmule`` against
   ``agg_backend="ref"``: the final weights within phase 4's growth
   bound, the aggregation in lockstep with training off within 1e-5 over
   the first 10 steps;
   ``mlmule`` with ``cross_pod=False`` on a 2 x 2 mesh. Then ``gossip`` on
   ``multi_area_migratory`` through the streamed distributed engine,
   re-bucketing every 10 steps: at least one swap, a permutation, the
   same drift readings on every rank, bitwise
   ``run_population_distributed(rebucket_every=10)``; steps/s, bytes sent
   a step and hops pruned before and after the swap;
17. the seed sweep over the ranks, in phase 16's world: each rank runs
   ``run_sweep_distributed`` over 4 seeds of the walk (each bucket-ordered
   by its own areas) for ``mlmule`` and ``gossip``, T = 12, then each lane
   alone through ``run_population_distributed``. One ``ordered_psum`` a
   ``mlmule`` step and one ``encounter_hop`` launch a hop that any lane
   keeps, for all lanes; every lane's replicated state bitwise on every
   rank; each lane within the growth bound of its sequential run, and
   bitwise it over 4 steps with training off (the collectives, the
   aggregation and the hops alone); the lanes' distance from their
   sequential runs with training alone (``local``, 2 steps) with cuDNN
   and without; lane-steps/s beside the sequential runs and the bytes a
   step through host memory;
18. training: stablelm-1.6b at full width (24 layers, 1.64 B f32 weights)
   through ``launch/train.py``'s functions: an f32 copy's loss and
   gradient through the kernels (the SIMT flash route) against
   ``backend="ref"`` (every leaf a finite, non-zero gradient, the loss
   within 2e-4, each leaf's gap bounded); then Adam steps in bf16 compute
   (batch 4 x 128) with 24 tensor-core ``flash_attention`` launches a
   step and a finite, falling loss, and the checkpoint they write restored
   bitwise; steps/s, tokens/s and peak memory. Then the same gradient
   check for zamba2-2.7b (6 layers: 5 ``ssd_scan``, 1 ``flash_attention``
   at head dim 80) and xlstm-350m (4 layers: 2 ``slstm_scan``) at full
   width;
19. the LM population: ``examples/torch_train_lm_population.py``'s body
   with xlstm-350m at full width, 4 fixed devices training under
   ``torch.func.vmap`` and 6 mules on the walk, seq 64, batch 4, T = 3:
   ``mule_agg`` once a step over whole parameter vectors (D =
   468,260,864), ``slstm_scan`` once a layer a step for all 4 models; the
   aggregation of every step's state in lockstep with
   ``agg_backend="ref"`` (1e-5); steps/s and peak memory;
20. mixture-of-experts: granite-moe-1b-a400m at full width (24 layers of
   attention, 16 heads x 64 with KV 8, and 32 experts of 512, top-8;
   vocab 49155; 1,334,628,352 random f32 weights from a seed). (a)
   ``make_prefill_step`` on 2 x 4096 tokens in bf16 at the config's
   capacity factor, which must launch ``flash_attention`` 24 times, all on
   the tensor cores; prefill tokens/s, a profile, the dropped slots of
   every layer, and one MoE layer timed piece by piece on its own input
   (router and top-k, dispatch, expert GEMMs, un-group); (b)
   ``serve.generate`` at the launcher's defaults; (c) an f32 drop-free
   copy (capacity factor E / k) whose prefill through the kernel is held
   to ``backend="ref"`` route by route: every route flip is printed with
   its gap, a first flip at a gap of 1e-5 or more fails, and the rows no
   flip can reach are held to 2e-4; then decode against forward (1e-3);
   (d) training through ``launch/train.py``'s functions: the f32 gradient
   at 2 x 128 through the kernel against ``backend="ref"`` (the router
   and every expert of every layer non-zero), then 5 Adam steps in bf16
   at 4 x 128 with 24 tensor-core launches a step, a falling loss, a
   non-zero aux term and the checkpoint restored bitwise; (e)
   qwen3-moe-235b-a22b, granite-34b and qwen2.5-32b at full width, their
   depth cut to 2 layers (the whole models do not fit one card): the bf16
   prefill on 2 x 4096 tokens with both attention launches on the tensor
   cores, a profile (and qwen3-moe's 128-expert layer timed piece by
   piece); the f32 copy through the kernel against ``backend="ref"``
   (qwen3-moe drop-free on 2 x 1024 tokens, route by route as in (c); the
   dense two on 2 x 4096 within 2e-4); decode against forward (1e-3);
21. audio and vision: (a) whisper-base whole (6 encoder and 6 decoder
   layers, d_model 512, 8 heads x 64, vocab 51865; 83,210,752 random f32
   weights from a seed): ``make_prefill_step`` on 4 requests of 1500
   frames (0.1 x normal, as serve.py draws them) and 448 decoder tokens
   in bf16, which must launch ``flash_attention`` exactly 12 times (6
   bidirectional encoder calls, 6 causal decoder calls), all on the
   tensor cores, cross-attention none (it takes the plain version, as in
   the reference); a profile; ``serve.generate`` at the launcher's
   defaults with the frames encoded into the cache first; the f32 copy's
   prefill through the kernel against ``backend="ref"`` (2e-4) and decode
   against forward (1e-3); the f32 gradient at 2 x 128 through the kernels
   against ``backend="ref"`` (every leaf non-zero, within 2e-4 of its
   largest); 5 Adam steps through ``launch/train.py`` at 4 x 128 with its
   zero frames, 12 tensor-core launches a step, a falling loss. (b)
   qwen2-vl-72b at full width cut to 2 layers (64 heads on 8 KV heads x
   128, QKV bias, M-RoPE sections (16, 24, 24); 4,246,794,240 f32
   weights): M-RoPE with three equal position streams against plain RoPE
   on the card, bitwise; a 2 x 4096 bf16 prefill of 256 vision rows (0.1 x
   normal) and 3,840 tokens with both attention launches on the tensor
   cores, a profile; the f32 copy against ``backend="ref"`` (2e-4); decode
   of the text-only copy (no prefix, plain RoPE) against its forward
   (1e-3), as the reference's test holds it.

Phase 3 also holds the lane-batched entries at S = 4 (``mule_agg_lanes``
at the sweep's, Table 1's and the multi-area shapes; ``encounter_mix_lanes``
at the walk's first exchange of four seeds and at a dense HAR strip): each
lane bitwise a single-lane launch, the lanes within the JAX tests' bound of
their plain version, timed against S single launches, ``torch.bmm`` of the
dense gate and their bound (the ``lanes`` entries of rows 1 and 2); and
``fold_in`` of int64 seed tensors on the card against the host's. It also
holds ``flash_attention`` against its plain versions on the
JAX tests' cases, on tensor-core cases (decode, ragged Sk, bidirectional,
a fully masked first block at gemma3's GQA group) and at gemma3-4b's and
zamba2-2.7b's per-layer prefill shapes (in f32, and in bf16 against the
fp32 oracle on the same inputs), and at the layer shapes of
granite-moe-1b-a400m (GQA group 2, head dim 64; also f32), qwen3-moe-235b-a22b
(64 heads on 4 KV heads), granite-34b (48 heads on one KV head),
qwen2.5-32b (40 on 8) and qwen2-vl-72b (64 on 8), head dim 128, in bf16, and
Whisper's encoder layer (bidirectional, 4 x 1500 frames, 8 heads x 64,
group 1; also f32), and Whisper's encoder call (1 x 1500, bidirectional)
among the tensor-core cases, checks every call's route (bf16 at head
dims 64, 80, 128 and 256 on the tensor-core kernel, the rest on the SIMT
one), counts the ``HGMMA`` instructions of the built tensor-core library
(``cuobjdump -sass``; none fails), and times the tensor-core kernel beside
``F.scaled_dot_product_attention`` as the library yardstick; and
``ssd_scan`` against the sequential oracle and the chunked plain version
on the JAX tests' cases and at zamba2-2.7b's prefill shape,
where no single PyTorch call computes the scan (its ``library_ms`` is
null), and at edge shapes of its slicing and chunking (S not a multiple
of the chunk, P 40 and N 24, chunk 1, B 3); and ``slstm_scan`` against its
plain version on the JAX tests' cases, a ragged P, one step, more batch
rows than a cluster takes (B = 5), one row, one head and xlstm-350m's
prefill shape (there also against a float64 run of the plain version),
timed with its µs per time step and beside its step floor (the h exchange
alone, through the kernel's mbarriers and through a cluster barrier a
step); no PyTorch call computes the sLSTM cell (``library_ms`` null). Both
scan rows carry the build's registers and spill bytes (``build``). The
``encounter_mix`` cases include a dense strip at the main path's shape
(pos 0, two areas, as the trace scenarios give the peer step), timed
beside the walk and the bf16 mix; at every case and hop the pairs
kernel's words and masses must equal their plain version, and the walk
and the dense strip must give the same bits with every strip summed
densely, none, and the default switch. It
also holds ``encounter_hop``, one ring hop, against ``encounter_block`` on
every pair of the 4 blocks of phase 9's population at its first exchange
(and their ring-order sum, normalised, against ``encounter_mix``), on
ragged blocks, and on a balanced 4-area population whose hop mask prunes
(launches equal to the kept hops), timed at the ring's hop shape (R = V =
64, D = 546,484) beside ``torch.matmul`` of the hop's dense gate; and its
lane-batched entry ``encounter_block_hop_lanes`` at S = 1, 2, 4 (each lane
the single hop's bits, one launch a call), timed at S = 4 beside 4 single
launches and ``torch.bmm`` (the ``lanes`` entry of row 3). Last in phase
3, the three LM kernels as autograd ops: a ``grad_fn`` on each output, the
gradient against ``backend="ref"``'s, and ``vmap(grad)`` over 4 lanes in
one launch, each lane against its single gradient.

The second-to-last line is a JSON object describing every kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
SEED = 0

# main path (phase 4)
N_FIXED, N_MULES, BATCH, LR, N_STEPS, EVAL_EVERY = 8, 256, 16, 0.05, 60, 20
PROFILE_STEPS = 5
# The kernel run and its agg_backend="ref" replay differ by fp32 summation
# order only (~1e-7). Training is not continuous in the weights: a change
# that small flips some max-pool and ReLU ties every step at 256 mules x 16
# images, and a flip moves a weight by up to lr*|grad|. So the final
# weights are held to a bound on that growth (the run prints the measured
# gap), and the aggregation itself, which has no ties, is held step by
# step in lockstep to fp32 order.
REPLAY_ATOL = 5e-2
LOCKSTEP_ATOL = 1e-5

# peer path (phase 5): Fig 6's random walk; gossip_step's radius
PEER_METHODS = ("gossip", "oppcl", "mlmule+gossip")
P_CROSS, RADIUS, PEER_EVERY = 0.1, 0.15, 3
PEER_PROFILE_STEPS = 6
# gossip's kernel run and its enc_backend="ref" replay differ by the mix's
# fp32 summation order (~1e-7) and then by training's tie flips, as above
PEER_REPLAY_ATOL = 5e-2

# phase 3: the JAX package's kernel tolerances
# (tests/test_kernels_mule_agg.py, tests/test_kernels_encounter.py)
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
# H100 SXM peaks (NVIDIA data sheet): memory rate, fp32 outside the
# tensor cores (the kernel's FMAs), dense bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12

# flash_attention (phase 3): tests/test_kernels_flash.py's cases (b, s, h,
# kv, d, window, causal) and tolerances (test_kernels_flash.py:38), plus
# windowed cases where a row's first visited 64-key block is fully masked
# for that row, and the other head dims the kernel is built for
FLASH_CASES = [
    (2, 128, 4, 2, 32, None, True), (1, 200, 4, 4, 16, None, True),
    (2, 256, 8, 2, 32, 64, True), (1, 128, 4, 2, 32, None, False),
    (2, 96, 4, 1, 64, 48, True), (1, 64, 2, 2, 8, 16, True),
    (1, 256, 2, 2, 8, 16, True), (2, 300, 4, 1, 64, 48, True),
    (1, 200, 4, 2, 128, None, True), (1, 300, 2, 1, 256, 100, True),
    (2, 130, 4, 4, 80, None, True), (1, 200, 2, 1, 80, 70, True)]
# The tensor-core route (bf16, head dims 64, 80, 128, 256) also at the
# right-aligned decode shape, a ragged Sk with S < Sk, a bidirectional call,
# gemma3-4b's GQA group with a window whose first visited block is fully
# masked for some rows, Whisper's encoder call (bidirectional, S = Sk =
# 1500, not a multiple of the kernel's 64-row blocks, group 1) and its
# decoder's self-attention calls (causal, group 1) in the prefill (4 x 448)
# and in a training step (4 x 128):
# (b, s, sk, h, kv, d, window, causal)
FLASH_TC_CASES = [
    (2, 4, 64, 4, 2, 64, None, True), (1, 4, 300, 8, 4, 256, None, True),
    (1, 100, 300, 4, 4, 80, None, True), (1, 128, 128, 4, 2, 128, None, False),
    (2, 200, 200, 8, 4, 256, 64, True),
    (1, 1500, 1500, 8, 8, 64, None, False),
    (4, 448, 448, 8, 8, 64, None, True), (4, 128, 128, 8, 8, 64, None, True)]
FLASH_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# the prefill profiles' attention line: every flash_attention kernel
FLASH_PROFILE = {"attention": "flash_attention"}
FLASH_MHA_TOL_F32 = 2e-5       # against mha_reference (test_kernels_flash.py)
# bf16, (atol, rtol). The kernel and every plain version compute in fp32
# and round once to bf16, so the kernel's bf16 output is within half a
# bf16 ulp (2**-8 relative) of the fp32 oracle on the same inputs, and
# within one ulp of a bf16 plain version; the bounds are twice that, and
# atol covers fp32 sums that cancel to near zero. They hold every case
# above and, with the f32 checks, gemma3-4b's layer shapes and the
# prefill's own activations.
BF16_ULP = 2.0 ** -7
FLASH_BF16_VS_F32 = (1e-5, BF16_ULP)
FLASH_BF16_VS_BF16 = (1e-5, 2 * BF16_ULP)

# LM serve path (phase 6): gemma3-4b at full width
LM_ARCH = "gemma3-4b"
PREFILL_B, PREFILL_S = 2, 4096
PREFILL_REPS = 3
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 16, 32   # serve.py's defaults
# f32 forward vs decode replay at full width: the reference holds 2e-4 at
# smoke size (tests/test_decode_consistency.py); 34 layers at width 2560
# sum in another order on the two paths (GEMM vs matrix-vector), so 1e-3
DECODE_B, DECODE_S, DECODE_TOL = 1, 64, 1e-3
# f32 prefill through the kernel vs through the plain version
# (backend="ref"), all 34 layers: the two share every GEMM and differ only
# in the order of the attention sums, so the reference's own bound for two
# orders of the same sums (2e-4, tests/test_decode_consistency.py)
REF_PREFILL_TOL = 2e-4

# ssd_scan (phase 3): tests/test_kernels_ssm.py's cases (b, s, h, p, n,
# chunk) and its bound for the TPU kernel against the sequential oracle
SSD_CASES = [(2, 64, 3, 8, 16, 16), (1, 100, 2, 16, 8, 32),
             (2, 128, 4, 32, 16, 64), (1, 33, 1, 4, 4, 8)]
SSD_ORACLE_TOL = 2e-4
# edge shapes of the kernel's slicing and chunking: S not a multiple of the
# chunk, P and N not multiples of a slice of state columns, chunk 1, B = 3
SSD_EDGE = [(2, 150, 3, 40, 24, 64), (3, 37, 2, 40, 24, 1),
            (3, 77, 5, 24, 12, 16)]
# the kernel against the chunked plain version: the same fp32 function with
# its sums in another order, so the error scales with the terms summed, not
# with each output (outputs near 0 sit among terms of ~60). The bound is a
# fraction of the largest |output| of the call, ~4.5x the largest reading
# (8.8e-8 at the JAX tests' cases, 5.0e-8 at zamba2's shape, 2.5e-8 on the
# prefill's own activations; NVIDIA H100). At zamba2's shape the kernel must
# also be no farther than twice the plain version's own distance from an
# f64 sequential oracle: there A = -(1 .. 80) sends cum to about -3,500
# within a chunk, where the order of the cumsum decides the rounding of
# exp(cum_i - cum_j) (see csrc/ssd_scan.cu).
SSD_VS_CHUNKED_REL = 4e-7

# the hybrid serve path (phase 7): zamba2-2.7b at full width, whose 45
# Mamba2 layers run ssd_scan and whose 9 applications of the shared
# attention block run flash_attention at head_dim 80
HYBRID_ARCH = "zamba2-2.7b"
HYBRID_PARAMS = 2_063_676_080     # the reference's init (tests/test_torch_zamba2.py)
HYBRID_SCANS, HYBRID_ATTNS = 45, 9
# f32 prefill through the kernels vs backend="ref": the two share every
# GEMM and differ in the order of the scan's and the attention's fp32 sums,
# in all 54 layers. The bound is set from the readings, as gemma3-4b's:
# 4.554e-5 in each sound run (NVIDIA H100 80GB HBM3, 700 W), ~4.4x below it
HYBRID_REF_PREFILL_TOL = 2e-4

# slstm_scan (phase 3): tests/test_kernels_slstm.py's cases (b, s, h, p),
# a ragged P, one step, and its tolerance for the TPU kernel against the
# plain version; the full shape is xlstm-350m's prefill
SLSTM_CASES = [(2, 24, 3, 8), (1, 7, 1, 4), (2, 33, 4, 16), (2, 50, 2, 100),
               (3, 1, 4, 256)]
SLSTM_TOL = 2e-6
# edge shapes of the kernel's grid: more batch rows than one cluster takes
# (B = 5: two groups), one row, one head, ragged and full head widths
SLSTM_EDGE = [(5, 24, 2, 100), (1, 40, 1, 256), (5, 12, 1, 256)]
# the scales of the prefill's inputs: pre = LN(x) @ w_in at init scale 0.02
# and width 1024 has std 0.64; r is drawn at 0.02 (models/xlstm.py)
SLSTM_PRE_STD, SLSTM_R_STD = 0.64, 0.02

# the xlstm serve path (phase 8): xlstm-350m at full width, 12 (mLSTM,
# sLSTM) pairs, whose sLSTM blocks run slstm_scan
XLSTM_ARCH = "xlstm-350m"
XLSTM_PARAMS = 468_260_864        # the reference's init (tests/test_torch_xlstm.py)
XLSTM_PAIRS = 12
# f32 prefill through the kernel vs backend="ref": the two share every
# GEMM and the mLSTM, and differ in the order of the sLSTM's fp32 sums in
# 12 layers. The mLSTM amplifies such differences: it takes exp of
# differences of cumulative log-forget sums that reach ~2,800 at 4096
# tokens, where an f32 ulp is 2.4e-4. A run whose sLSTM is exact (float64,
# rounded once) is as far from the f32 plain run as the kernel's (NVIDIA
# H100 80GB HBM3, 700 W: kernel 5.593e-3, f64 sLSTM 6.920e-3). The bound,
# written as 1e-3 before the first run, is set from those readings; the
# kernel must also be no farther from the f64-sLSTM run than twice the
# plain version's distance.
XLSTM_REF_PREFILL_TOL = 2e-2
# The same f32 check on shorter prefills, each also measured against the
# copy whose sLSTM runs in f64. Written as 2e-4 at 2 x 512 tokens before
# the first run, on the premise that the gap is the mLSTM's at long
# lengths. The readings refuted it (NVIDIA H100 80GB HBM3, 700 W): the
# model amplifies ~1e-7 differences in the sLSTM's output about a
# thousandfold at any length (kernel vs plain at 16 tokens 2.39e-4, at
# 512 tokens 1.063e-3; the plain run vs the f64 copy 1.38e-4 and
# 2.27e-3). The bound is set from the 512-token reading, ~3.8x below it
# and under twice the plain run's own distance from the f64 copy there.
XLSTM_SHORT_S = (16, 128, 512)
XLSTM_SHORT_PREFILL_TOL = 4e-3

# encounter_hop (phase 3) and the ring peer path (phase 9): the walk of
# phase 5, bucket-ordered by area and split into RING_RANKS equal blocks of
# 64 mules, T = 30 steps (10 exchanges). Each hop is held to
# encounter_block as encounter_mix is (TOL), and the ring-order sum of the
# hops, normalised, to the single-host encounter_mix: both sum the same
# terms in other orders, and the normalisation divides by an exact count.
RING_RANKS, RING_STEPS = 4, 30
RING_MIX_TOL = 2e-5
RING_TIMEOUT = 600
# Table 1 fixed path (phase 10): the paper's 8 fixed devices and 20 mules,
# 120 pretraining steps a device, T = 60 (6 federated rounds of 2 local
# steps); the batch, lr, eval cadence, walk and CNN of phases 4 and 5
FIXED_MULES, FIXED_STEPS, FIXED_PRETRAIN = 20, 60, 120
# HAR path (phase 11): Fig 8's batch and lr (examples/har_mobile_training.py)
HAR_BATCH, HAR_LR = 12, 0.03
# the HAR path's horizon, cut from 60 to keep the script inside its time
# with phases 17-20 (one eval, after step 19; a multiple of the peer
# cadence, 3)
HAR_STEPS = 21
# run_experiment at the harness's own defaults, T cut to this
SHORT_STEPS = 20
# the seed sweep (phase 13) and the lane-batched kernel entries (phase 3):
# S seeds of the walk as lanes of one replay, each launch of mule_agg and
# encounter_mix serving all S lanes; the multi-area path (phase 12): the
# 3-city scenarios' 12 fixed devices
LANES = 4
# the sweep's horizon, cut from the other paths' 60 to keep the script
# inside its time with phases 17-20 (one eval, after step 19; a multiple
# of the peer cadence, 3)
SWEEP_STEPS = 21
MULTI_AREA_FIXED = 12
# the dense HAR strip of the lane-batched mix: the LSTM-CNN's D
HAR_D = 44_580
# mule_agg's timings (phase 3): a call whose bound is under GRAPH_BELOW_MS
# is timed in a CUDA graph of GRAPH_CALLS calls a copy of W (the wrapper's
# enqueue, ~15-20 us, is longer than the call); copies of W rotate until
# they span COLD_BYTES, three times the H100's 50 MB of L2
GRAPH_BELOW_MS = 0.05
GRAPH_CALLS = 4
COLD_BYTES = 150e6
# the streamed path (phase 14): phase 4's run through the streamed engine,
# a chunk an eval period
STREAM_CHUNK = EVAL_EVERY
# population scale (phase 15): the reference's scale workload
# (benchmarks/engine_micro.py: _scale_workload), a linear model of D = 8
# weights over F = 8 fixed devices, two samples a mule a step, lr 0.05, on
# streaming_commuter's procedural stream, T = 24 (the reference's horizon
# is 96; cut to keep the script inside its time with phases 17-20) in
# chunks of 8
SCALE_MULES = (100_000, 1_000_000)
SCALE_D, SCALE_STEPS, SCALE_CHUNK, SCALE_BATCH, SCALE_LR = 8, 24, 8, 2, 0.05
# the distributed engine (phase 16): 4 ranks, each a 64-mule block of the
# bucket-ordered walk of phase 9 at the CNN's full width, T = 30; then the
# streamed engine on multi_area_migratory, re-bucketing every 10 steps.
# At M = 256 that schedule's drift from its build-time buckets is 0 at
# step 10 and 2 mules of 256 (0.0078) at step 20: the threshold lets the
# second check swap
DIST_RANKS, DIST_STEPS = 4, 30
# the distributed mlmule's lockstep with agg_backend="ref": the first 10
# steps (cut from 30, to keep the script inside its time)
DIST_LOCKSTEP_STEPS = 10
REBUCKET_EVERY, REBUCKET_THRESHOLD = 10, 0.005
# the seed sweep over the ranks (phase 17, in phase 16's world): S seeds of
# that walk as lanes inside each rank's block, T = 12 (cut from 30 to keep
# the script inside its time with the checks below)
DIST_LANES = 4
DIST_SWEEP_METHODS = ("mlmule", "gossip")
DIST_SWEEP_STEPS = 12
# its lanes against their sequential runs with training off (the
# collectives, aggregation and hops alone: bitwise; two gossip exchanges)
# and with training alone (method "local", with and without cuDNN)
DIST_SWEEP_OFF_STEPS, DIST_LOCAL_STEPS = 4, 2
# the kernels' autograd ops (phase 3): each lane of vmap(grad) against its
# single gradient, and the single gradient against backend="ref"'s (both
# relative to the largest gradient; readings 8.6e-8 and 5.9e-7 on the H100)
KERNEL_GRAD_LANE_REL, KERNEL_GRAD_REF_REL = 1e-6, 1e-5
# training (phase 18): stablelm-1.6b at full width through launch/train.py,
# Adam in bf16 compute on batch 4 x 128; the f32 gradient checks at batch
# 2 (zamba2 and xlstm at full width, reduced depth, seq 64). The loss bound
# is the f32 prefills' (two orders of the same sums); the leaf bound 4x the
# largest gap read on the H100 (4.4e-5, zamba2; stablelm 5.0e-6, xlstm
# 1.5e-5)
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "stablelm-1.6b", 5, 4, 128
GRAD_BATCH, GRAD_SEQ = 2, 64
GRAD_HYBRID_LAYERS, GRAD_XLSTM_LAYERS = 6, 4
GRAD_LOSS_REL, GRAD_LEAF_REL = 2e-4, 2e-4
# the LM population (phase 19): examples/torch_train_lm_population.py's
# F 4 / M 6 with xlstm-350m at full width, T = 3 (4 until phase 20 came)
LM_POP_ARCH, LM_POP_STEPS, LM_POP_SEQ, LM_POP_BATCH = "xlstm-350m", 3, 64, 4
LM_POP_FIXED, LM_POP_MULES = 4, 6
# mixture-of-experts (phase 20): granite-moe-1b-a400m at full width, 24
# layers of attention (16 heads x 64, KV 8) and 32 experts of 512, top-8.
# Its leaves: the config's param_count() (1,334,578,176) and the norms'
# 2 x 24 x 1024 + 1024 scales
MOE_ARCH = "granite-moe-1b-a400m"
MOE_PARAMS = 1_334_628_352
# flash_attention at the layer shapes of the MoE and the other dense
# models (phase 3): GQA groups 2 (head dim 64), 16, 48, 5 and qwen2-vl's 8
# (head dim 128)
FLASH_LAYER_ARCHS = (MOE_ARCH, "qwen3-moe-235b-a22b", "granite-34b",
                     "qwen2.5-32b", "qwen2-vl-72b")
# the f32 drop-free prefill through the kernel vs backend="ref": the two
# differ in the order of attention's sums, and a token whose k-th and
# (k+1)-th router probabilities are that close may take another expert
# (a flip). A flip moves its token's output a long way, and attention
# carries it to the later positions of its sequence. So the rows held to
# REF_PREFILL_TOL are those that no flip can reach (positions before the
# first flip of their sequence); every flip is printed with its gap, and a
# first flip (no flip at an earlier layer and position of its sequence)
# whose gap is MOE_FLIP_GAP_REL of the k-th probability or more fails
MOE_FLIP_GAP_REL = 1e-5
# its training: the f32 gradient check at GRAD_BATCH x TRAIN_SEQ, then
# TRAIN_STEPS Adam steps at TRAIN_BATCH x TRAIN_SEQ in bf16 (phase 18's)
# the models whose whole depth does not fit one card run at full width
# with WIDE_LAYERS layers (every stage kind of each); qwen3-moe's f32
# drop-free copy on WIDE_MOE_S tokens a row: its group buffer is
# [128, T, 4096] f32 with the capacity T, 4.3 GB at T = 2 x 1024
WIDE_ARCHS = ("qwen3-moe-235b-a22b", "granite-34b", "qwen2.5-32b")
WIDE_LAYERS = 2
WIDE_MOE_S = 1024
DIST_TIMEOUT = 900
# audio and vision (phase 21): whisper-base whole (6 encoder and 6 decoder
# layers, the embedding tied; its leaves as the reference's init counts
# them), its prefill on AUDIO_B requests of encoder_seq = 1500 frames and
# AUDIO_S = 448 decoder tokens (Whisper's decoder context,
# arXiv:2212.04356); qwen2-vl-72b at full width with WIDE_LAYERS layers
# (its leaves at that depth, the reference's init), whose 2 x 4096 prefill
# is its 256 vision rows and 3,840 tokens
AUDIO_ARCH = "whisper-base"
AUDIO_PARAMS = 83_210_752
AUDIO_B, AUDIO_S = 4, 448
VISION_ARCH = "qwen2-vl-72b"
VISION_PARAMS = 4_246_794_240


def _hold(label: str, out, want, atol: float, rtol: float) -> float:
    """Raises unless |out - want| <= atol + rtol |want| everywhere; prints
    the largest error beside the typical size of what it is compared with.
    Returns the largest error."""
    import torch
    out, want = out.float(), want.float()
    diff = (out - want).abs()
    err = diff.max().item()
    worst = (diff / (atol + rtol * want.abs())).max().item()
    print(f"{label}: max_abs_err={err:.3e}, mean |want| "
          f"{want.abs().mean().item():.3e}, max |want| "
          f"{want.abs().max().item():.3e}, worst err / (atol + rtol |want|) "
          f"{worst:.3f} (atol {atol:g}, rtol {rtol:g}) "
          f"{'ok' if worst <= 1 else 'MISMATCH'}")
    if not worst <= 1:
        raise AssertionError(f"disagrees with its plain version: {label}")
    return err


def _hold_scaled(label: str, out, want, rel: float) -> float:
    """ssd_scan against its chunked plain version: raises unless
    |out - want| <= rel max |want| everywhere. Returns the largest
    error."""
    scale = want.float().abs().max().item()
    err = _hold(label, out, want, rel * scale, 0.0)
    print(f"  max |err| / max |want| = {err / scale:.3e} (bound {rel:g})")
    return err


def _median_ms(fn, reps: int = 30, warm: int = 5) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _cold_ms(fn, inputs, graph: bool, reps: int = 20) -> float:
    """Median ms of one call ``fn(*inputs[i])``, the calls cycling through
    the copies ``inputs`` so that each finds its inputs out of L2. With
    ``graph``, one reading is a replay of a CUDA graph of GRAPH_CALLS calls
    a copy, over their count: the host's enqueue, not timed then, is longer
    than such a call."""
    import torch
    n = len(inputs)
    if not graph:
        turn = [0]

        def one():
            fn(*inputs[turn[0] % n])
            turn[0] += 1
        return _median_ms(one, reps=max(reps, n))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up off the capture
        for x in inputs:
            fn(*x)
    torch.cuda.current_stream().wait_stream(side)
    graph_ = torch.cuda.CUDAGraph()
    calls = GRAPH_CALLS * n
    with torch.cuda.graph(graph_):
        for k in range(calls):
            fn(*inputs[k % n])
    ms = _median_ms(graph_.replay, reps=reps, warm=2) / calls
    del graph_
    return ms


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = out.stdout.strip().splitlines()[0]
    print(line)
    return line


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {len(logs)} kernel sources compiled in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        if name == "mule_agg":      # 32 instances: print three heights
            for label, use in _mule_agg_build().items():
                print(f"  mule_agg {label}: {use['registers']} registers, "
                      f"{use['spill_bytes']} bytes spilled")
            continue
        entry = ""
        for line in log.splitlines():
            if name == "flash_attention_tc" and "Compiling entry" in line:
                entry = "D=" + re.search(r"ILi(\d+)E", line).group(1) + " "
            if "registers" in line or (name == "flash_attention_tc"
                                       and "spill" in line):
                print(f"  {name}: {entry}{line.strip()}")


def _ptxas_usage(name: str, entries: dict) -> dict:
    """{label: {"registers": n, "spill_bytes": stores + loads}} of the
    kernels of library ``name`` whose mangled names contain ``entries``'
    values, from ptxas's report kept beside the library."""
    from repro_torch.kernels import _build
    log = _build.library_path(name).with_suffix(".log").read_text()
    usage, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = next((k for k, v in entries.items() if v in m.group(1)),
                         None)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage.setdefault(entry, {})["spill_bytes"] = \
                int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage.setdefault(entry, {})["registers"] = int(m.group(1))
    missing = set(entries) - set(usage)
    if missing:
        raise AssertionError(f"{name}: no ptxas report for {sorted(missing)}")
    return usage


def _mule_agg_case(g, f, m, d, dtype, offset: int = 0):
    """Seeded inputs of mule_agg: rows of a group mean a [F, M] and weights
    w [M, D] (``offset`` elements into their storage, so that their rows
    lose alignment)."""
    import torch
    a = torch.rand(f, m, device="cuda", generator=g)
    a = a / a.sum(1, keepdim=True)                  # rows of a group mean
    w = torch.randn(m * d + offset, device="cuda", generator=g).to(dtype)
    return a, w[offset:].view(m, d)


def _mule_agg_timing(g, f, m, d, what: str, dtype, card: str,
                     reps: int = 20) -> dict:
    """mule_agg at one path shape, cold (copies of W rotate while they span
    under COLD_BYTES), beside its plain version, torch.matmul and its
    bound; the kernel over ``reps`` readings."""
    import torch
    from repro_torch.kernels.mule_agg import mule_agg, mule_agg_plain
    size = torch.tensor([], dtype=dtype).element_size()
    w_bytes = m * d * size
    inputs = [_mule_agg_case(g, f, m, d, dtype)
              for _ in range(max(1, math.ceil(COLD_BYTES / w_bytes)))]
    n_bytes = 4 * f * m + w_bytes + f * d * size
    n_flop = 2 * f * m * d
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flop / FP32_FLOP_PER_S * 1e3
    graph = max(t_bytes, t_ops) < GRAPH_BELOW_MS
    ms = _cold_ms(mule_agg, inputs, graph, reps)
    plain_ms = _cold_ms(mule_agg_plain, inputs, graph)
    library_ms = (_cold_ms(torch.matmul, inputs, graph)
                  if dtype == torch.float32 else None)
    method = (f"CUDA graph of {GRAPH_CALLS * len(inputs)} calls" if graph
              else "CUDA events, one call each")
    entry = {"shape": f"F={f} M={m} D={d} {str(dtype).split('.')[1]}",
             "path": what, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": library_ms, "timed_by": method,
             "w_copies": len(inputs)}
    lib = "" if library_ms is None else \
        f", torch.matmul {library_ms:.4f} ms"
    print(f"mule_agg timing {entry['shape']} ({what}): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms{lib}, bound {entry['bound_ms']:.4f} ms "
          f"({entry['bound_by']}; {n_bytes} B, {n_flop} FLOP), "
          f"{ms / entry['bound_ms']:.3f}x its bound; {method}, W in "
          f"{len(inputs)} cop{'y' if len(inputs) == 1 else 'ies'} [{card}]")
    return entry


def _group_mean_wide(g) -> None:
    """masked_group_mean at F = 20 fixed devices (two row tiles of the
    kernel) through "auto" against "ref"."""
    import torch
    from repro_torch.core.aggregation import masked_group_mean
    from repro_torch.kernels.mule_agg import mule_agg
    f, m = 20, N_MULES
    models = {"conv": torch.randn(m, 3, 3, 3, 32, device="cuda", generator=g),
              "dense": torch.randn(m, 4099, device="cuda", generator=g)}
    assign = (torch.rand(f, m, device="cuda", generator=g) < 0.1).float()
    assign[f - 1] = 0.0                               # a zero-mass row
    before = mule_agg.launches
    got, mass = masked_group_mean(models, assign, backend="auto")
    torch.cuda.synchronize()
    if mule_agg.launches != before + 1:
        raise AssertionError("masked_group_mean at F = 20 did not launch "
                             "mule_agg once")
    want, want_mass = masked_group_mean(models, assign, backend="ref")
    if not torch.equal(mass, want_mass):
        raise AssertionError("masked_group_mean at F = 20: masses differ")
    for k in models:
        _hold(f"masked_group_mean F={f} M={m} {k} {tuple(got[k].shape)} "
              f"auto vs ref", got[k], want[k], TOL["float32"],
              TOL["float32"])


def _mule_agg_build() -> dict:
    """Registers and spill bytes of mule_agg's F = 8, 12 and 16 instances,
    f32 and bf16, from ptxas's report."""
    return _ptxas_usage("mule_agg", {
        f"F={f} {t}": f"mule_agg_kernelILi{f}E{mangled}"
        for f in (8, 12, 16)
        for t, mangled in (("f32", "f"), ("bf16", "13__nv_bfloat16"))})


def phase_mule_agg(card: str) -> dict:
    """mule_agg against its plain version: every tile height F = 1..16,
    F > 16 (row tiles), ragged, odd and misaligned rows of W, A past one
    chunk of shared memory, in f32 and bf16; masked_group_mean at F = 20;
    timed at the four path shapes. Returns its JSON row."""
    import torch
    from repro_torch.kernels.mule_agg import mule_agg, mule_agg_plain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    d_main = 546_484     # the paper CNN's parameter count (CONFIG)
    cases = [  # (F, M, D): main path, tests/test_kernels_mule_agg.py's
        (N_FIXED, N_MULES, d_main),  # shapes, then A chunked in shared memory
        (8, 20, 256), (8, 20, 1000), (2, 3, 64), (16, 64, 4096), (1, 1, 130),
        (8, 1100, 3000), (16, 600, 2000),
        # row tiles at a ragged (odd) D, an even D % 4 != 0, an odd bf16 row
        (17, N_MULES, 5001), (20, N_MULES, 5001), (33, N_MULES, 5001),
        (7, 40, 4098), (5, 33, 1001),
        # every tile height, at Table 1's width and at a ragged D
        *[(f, FIXED_MULES, d_main) for f in range(1, 17)],
        *[(f, 37, 4099) for f in range(1, 17)],
        (16, 1100, d_main)]
    # W's storage offset by 1 or 3 elements: rows out of 16-byte alignment
    cases = [(f, m, d, 0) for f, m, d in cases] + [(8, 40, 4100, 1),
                                                   (12, 20, 4096, 3)]
    err_main = None
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[1]]
        worst = 0.0
        for f, m, d, offset in cases:
            a, w = _mule_agg_case(g, f, m, d, dtype, offset)
            before = mule_agg.launches
            out = mule_agg(a, w)
            torch.cuda.synchronize()
            if mule_agg.launches != before + 1:
                raise AssertionError(f"mule_agg F={f} counted "
                                     f"{mule_agg.launches - before} launches")
            ref = mule_agg_plain(a, w)
            err = (out.float() - ref.float()).abs().max().item()
            ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
            worst = max(worst, err)
            if err_main is None:
                err_main = err                      # the main path's, f32
            print(f"mule_agg F={f} M={m} D={d}"
                  f"{f' W offset {offset}' if offset else ''} {dtype}: "
                  f"max_abs_err={err:.3e} (tol {tol}) "
                  f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"mule_agg disagrees with its plain "
                                     f"version at F={f} M={m} D={d} {dtype}")
            del a, w, out, ref
        print(f"mule_agg {dtype}: {len(cases)} cases within {tol} of the "
              f"plain version, worst {worst:.3e}")
    _group_mean_wide(g)

    timed = [_mule_agg_timing(g, f, m, d, what, torch.float32, card)
             for f, m, d, what in (
                 (N_FIXED, N_MULES, d_main, "main path"),
                 (MULTI_AREA_FIXED, N_MULES, d_main, "multi-area"),
                 (N_FIXED, FIXED_MULES, d_main, "Table 1"),
                 (N_FIXED, N_MULES, HAR_D, "HAR"))]
    timed.append(_mule_agg_timing(g, N_FIXED, N_MULES, d_main, "main path",
                                  torch.bfloat16, card))
    main = timed[0]
    row = {
        "name": "mule_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/mule_agg/csrc/mule_agg.cu",
        "replaces": "src/repro/kernels/mule_agg/kernel.py:42",
        "launches": None, "max_abs_err": err_main,
        **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")},
        "cases": timed,
        "build": _mule_agg_build(),
    }
    return row


def _walk_geometry(t: int):
    """pos [M, 2], area [M] of step ``t`` of the peer path's random walk."""
    import torch
    from repro_torch.scenarios import walk_colocation
    co = walk_colocation(SEED, N_MULES, N_STEPS, p_cross=P_CROSS)
    return (torch.as_tensor(co["pos"][t], device="cuda"),
            torch.as_tensor(co["area"], device="cuda"))


def _dense_mix(models, pos, area, active):
    """The mix of the retired dense path (``gossip_step_dense``): the
    [M, M] encounter matrix, then the per-leaf group mean."""
    from repro_torch.baselines.gossip import encounter_matrix
    from repro_torch.core.aggregation import masked_group_mean
    enc = encounter_matrix(pos, area, RADIUS, active).float()
    return masked_group_mean(models, enc, backend="ref")


def _dense_strip_geometry(g):
    """pos [M, 2] all zero and area [M] of two areas, as the trace
    scenarios give the peer step: every same-area pair meets."""
    import torch
    return (torch.zeros(N_MULES, 2, device="cuda"),
            torch.randint(0, 2, (N_MULES,), device="cuda", generator=g))


def _check_pairs(label, pos_r, area_r, act_r, row0, pos_v, area_v, act_v,
                 col0, radius) -> None:
    """The pairs kernel against its plain version: words and masses
    exactly equal."""
    import torch
    from repro_torch.kernels.encounter_mix import (encounter_pairs,
                                                   encounter_pairs_reference)
    args = (pos_r, area_r, act_r, row0, pos_v, area_v, act_v, col0, radius)
    words, mass = encounter_pairs(*args)
    torch.cuda.synchronize()
    want_words, want_mass = encounter_pairs_reference(*args)
    if not (torch.equal(words, want_words) and torch.equal(mass, want_mass)):
        raise AssertionError(f"encounter_pairs {label}: the pair words or "
                             f"masses differ from the plain version")


def _same_bits_across_modes(label, fn) -> None:
    """``fn()`` -> (out, mass) with every strip summed densely, with none,
    and with the default switch: the same bits each time."""
    import torch
    from repro_torch.kernels.encounter_mix import ops
    default = ops.DENSE_PAIRS_PER_ROW
    outs = {}
    try:
        for dense_min in (default, 0, 33):
            ops.DENSE_PAIRS_PER_ROW = dense_min
            outs[dense_min] = fn()
    finally:
        ops.DENSE_PAIRS_PER_ROW = default
    torch.cuda.synchronize()
    same = all(torch.equal(o, outs[default][0])
               and torch.equal(m, outs[default][1]) for o, m in outs.values())
    print(f"{label}: every strip dense, none dense and the default switch "
          f"({default} pairs a row) give "
          f"{'the same bits' if same else 'DIFFERENT results'}")
    if not same:
        raise AssertionError(f"{label}: the sparse and dense modes disagree")


def phase_encounter_mix() -> dict:
    """encounter_mix against its plain version; returns its JSON row."""
    import torch
    from repro_torch.baselines.gossip import (encounter_matrix,
                                              unflatten_population)
    from repro_torch.configs.mule_cnn import CONFIG
    from repro_torch.kernels.encounter_mix import (encounter_mix,
                                                   encounter_mix_reference)
    from repro_torch.models.cnn import init_cnn
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 1)
    d_main = 546_484     # the paper CNN's parameter count (CONFIG)
    # (M, D, radius, p_active, positions): the main path's shape on the
    # walk's first exchange step, tests/test_kernels_encounter.py's shapes,
    # a ragged shape over many M-chunks, a dense strip (all pos 0), and the
    # main path's shape with pos 0 and two areas (the trace scenarios'
    # dense regime)
    cases = [(N_MULES, d_main, RADIUS, 1.0, "walk")]
    cases += [(m, d, 0.3, p, "uniform") for m, d in
              ((20, 256), (33, 130), (64, 1024), (7, 5)) for p in (1.0, 0.6)]
    cases += [(1100, 4099, 0.3, 0.8, "uniform"), (300, 2000, RADIUS, 1.0,
                                                  "zero"),
              (N_MULES, d_main, RADIUS, 1.0, "dense strip")]
    row, dense = None, {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[1]]
        for m, d, radius, p, geo in cases:
            if geo == "walk":
                pos, area = _walk_geometry(PEER_EVERY - 1)
            elif geo == "dense strip":
                pos, area = _dense_strip_geometry(g)
            else:
                pos = torch.rand(m, 2, device="cuda", generator=g)
                if geo == "zero":
                    pos.zero_()
                area = torch.randint(0, 2, (m,), device="cuda", generator=g)
            active = torch.rand(m, device="cuda", generator=g) < p
            w = torch.randn(m, d, device="cuda", generator=g).to(dtype)
            out, mass = encounter_mix(pos, area, active, w, radius=radius)
            torch.cuda.synchronize()
            ref, ref_mass = encounter_mix_reference(pos, area, active, w,
                                                    radius=radius)
            ref = ref.to(dtype)
            err = (out.float() - ref.float()).abs().max().item() if d else 0.0
            ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
            same_mass = torch.equal(mass, ref_mass)
            nnz = int(ref_mass.sum().item())
            del ref
            if dtype == torch.float32:
                _check_pairs(f"M={m} {geo}", pos, area, active, 0, pos, area,
                             active, 0, radius)
            print(f"encounter_mix M={m} D={d} r={radius} p_active={p} {geo} "
                  f"{dtype}: max_abs_err={err:.3e} (tol {tol}), masses "
                  f"{'equal' if same_mass else 'DIFFER'}, {nnz} encounters"
                  f"{', pair words equal' if dtype == torch.float32 else ''} "
                  f"{'ok' if ok and same_mass else 'MISMATCH'}")
            if not (ok and same_mass):
                raise AssertionError(f"encounter_mix disagrees with its plain "
                                     f"version at M={m} D={d} {dtype}")
            if d == d_main and dtype == torch.float32:
                _same_bits_across_modes(
                    f"encounter_mix {geo} f32", lambda: encounter_mix(
                        pos, area, active, w, radius=radius))
            if geo == "walk" and dtype == torch.float32:
                ms = _median_ms(lambda: encounter_mix(pos, area, active, w,
                                                      radius=radius))
                plain_ms = _median_ms(lambda: encounter_mix_reference(
                    pos, area, active, w, radius=radius))
                e = encounter_matrix(pos, area, radius, active).float()
                library_ms = _median_ms(lambda: torch.matmul(e, w))
                # the same weights as the CNN's leaves, for the dense path
                params = init_cnn(g, CONFIG)
                keys = sorted(params)
                models = unflatten_population(w, (
                    keys, [params[k].shape for k in keys],
                    [torch.float32] * len(keys)))
                dense_ms = _median_ms(lambda: _dense_mix(models, pos, area,
                                                         active))
                del models
                # bytes: W read once, the mix and mass written once, the
                # geometry (pos f32 x2, area int64, active bool) read once
                n_bytes = 4 * m * d + 4 * m * d + 4 * m + 17 * m
                # operations the data needs: one multiply-add per met pair
                # and column; a dense strip would do M*M*D
                n_flop = 2 * nnz * d
                dense_flop = 2 * m * m * d
                t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
                t_ops = n_flop / FP32_FLOP_PER_S * 1e3
                row = {
                    "name": "encounter_mix", "route": "cuda",
                    "source": "src/repro_torch/kernels/encounter_mix/csrc/"
                              "encounter_mix.cu",
                    "replaces": "src/repro/kernels/encounter_mix/kernel.py:79",
                    "launches": None, "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": library_ms,
                }
                print(f"encounter_mix timing M={m} D={d} f32 ({nnz} "
                      f"encounters): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                      f"ms, torch.matmul on a dense e {library_ms:.4f} ms, "
                      f"gossip_step_dense's mix {dense_ms:.4f} ms, bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']}; "
                      f"{n_bytes} B, {n_flop} FLOP for the met pairs); the "
                      f"dense strip's {dense_flop} FLOP take "
                      f"{dense_flop / FP32_FLOP_PER_S * 1e3:.4f} ms")
            elif geo == "walk":
                bf_ms = _median_ms(lambda: encounter_mix(pos, area, active, w,
                                                         radius=radius))
                bf_bound = 4 * m * d / HBM_BYTES_PER_S * 1e3
                row["bf16"] = {"ms": bf_ms, "bound_ms": bf_bound,
                               "bound_by": "bytes", "max_abs_err": err}
                print(f"encounter_mix timing M={m} D={d} bf16: kernel "
                      f"{bf_ms:.4f} ms, bound {bf_bound:.4f} ms (W and "
                      f"mix bytes)")
            elif geo == "dense strip" and dtype == torch.float32:
                ms = _median_ms(lambda: encounter_mix(pos, area, active, w,
                                                      radius=radius))
                plain_ms = _median_ms(lambda: encounter_mix_reference(
                    pos, area, active, w, radius=radius))
                e = encounter_matrix(pos, area, radius, active).float()
                library_ms = _median_ms(lambda: torch.matmul(e, w))
                n_flop = 2 * nnz * d
                t_bytes = (8 * m * d + 21 * m) / HBM_BYTES_PER_S * 1e3
                t_ops = n_flop / FP32_FLOP_PER_S * 1e3
                dense = {"shape": f"M={m}, D={d}, pos 0, two areas "
                                  f"({nnz} met pairs)",
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": max(t_bytes, t_ops),
                         "bound_by": ("bytes" if t_bytes >= t_ops
                                      else "operations"),
                         "library_ms": library_ms}
                print(f"encounter_mix timing M={m} D={d} f32, dense strip "
                      f"(pos 0, two areas; {nnz} encounters): kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul "
                      f"on a dense e {library_ms:.4f} ms, bound "
                      f"{dense['bound_ms']:.4f} ms ({dense['bound_by']}; "
                      f"{n_flop} FLOP for the met pairs)")
            del out, w
    row["dense_strip"] = dense
    return row


def _check_seed_folds() -> None:
    """``fold_in`` of int64 tensors on the card (the sweep's vmapped step
    folds each lane's seed so) against the host's Python ints."""
    import torch
    from repro_torch.core.seeds import fold_in, split
    seeds = [0, 1, SEED + 100, 12345, 2 ** 40 + 7, (1 << 62) - 1]
    for data in (0, 1, 2, N_MULES, -1):
        got = fold_in(torch.tensor(seeds, device="cuda"), data).tolist()
        if got != [fold_in(k, data) for k in seeds]:
            raise AssertionError(f"fold_in of a seed tensor on the card "
                                 f"differs from the host's at data={data}")
    got = split(torch.tensor(SEED + 100, device="cuda"), N_MULES, "cuda")
    if not torch.equal(got, split(SEED + 100, N_MULES, "cuda")):
        raise AssertionError("split of a seed tensor differs on the card")
    print(f"seeds: fold_in and split of int64 seed tensors on the card give "
          f"the host's bits ({len(seeds)} seeds x 5 folds)")


def _lane_timing(label: str, lanes, singles, library, plain,
                 n_bytes: int, n_flop: int, err: float) -> dict:
    """The lanes entry's timings: one lane-batched call, S single-lane
    calls, the library call and the plain version; and its bound."""
    ms = _median_ms(lanes, reps=20)
    single_ms = _median_ms(singles, reps=20)
    library_ms = _median_ms(library, reps=20)
    plain_ms = _median_ms(plain, reps=10)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flop / FP32_FLOP_PER_S * 1e3
    entry = {"shape": label, "max_abs_err": err, "ms": ms,
             "single_launches_ms": single_ms, "plain_ms": plain_ms,
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": library_ms}
    print(f"  {label}: lanes {ms:.4f} ms, {LANES} single launches "
          f"{single_ms:.4f} ms, torch.bmm {library_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms "
          f"({entry['bound_by']}; {n_bytes} B, {n_flop} FLOP)")
    return entry


def phase_lanes() -> dict:
    """The lane-batched entries of mule_agg and encounter_mix at S = LANES:
    each lane bitwise a single-lane launch, the lanes within the JAX tests'
    bound of the plain version; returns {kernel: its "lanes" entry}."""
    import torch
    from repro_torch.baselines.gossip import encounter_matrix
    from repro_torch.kernels.encounter_mix import (
        encounter_mix, encounter_mix_lanes, encounter_mix_lanes_reference)
    from repro_torch.kernels.mule_agg import (mule_agg, mule_agg_lanes,
                                              mule_agg_lanes_plain)
    from repro_torch.scenarios import walk_colocation
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _check_seed_folds()
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 2)
    d_main = 546_484     # the paper CNN's parameter count (CONFIG)
    tol = TOL["float32"]
    agg_cases = []
    # the sweep's shape, Table 1's, the multi-area scenarios' (F = 12)
    for f, m, what in ((N_FIXED, N_MULES, "the sweep"),
                       (N_FIXED, FIXED_MULES, "Table 1"),
                       (MULTI_AREA_FIXED, N_MULES, "multi-area")):
        a = torch.rand(LANES, f, m, device="cuda", generator=g)
        a = a / a.sum(2, keepdim=True)
        w = torch.randn(LANES, m, d_main, device="cuda", generator=g)
        mule_agg.launches = 0
        got = mule_agg_lanes(a, w)
        if mule_agg.launches != 1:
            raise AssertionError(f"mule_agg_lanes counted "
                                 f"{mule_agg.launches} launches, not 1")
        singles = torch.stack([mule_agg(a[i], w[i]) for i in range(LANES)])
        torch.cuda.synchronize()
        label = f"S={LANES} F={f} M={m} D={d_main} f32 ({what})"
        same = torch.equal(got, singles)
        print(f"mule_agg_lanes {label}: every lane "
              f"{'bitwise' if same else 'NOT bitwise'} a single-lane launch")
        if not same:
            raise AssertionError(f"mule_agg_lanes {label}: a lane differs "
                                 f"from its single-lane launch")
        err = _hold(f"mule_agg_lanes {label} vs plain", got,
                    mule_agg_lanes_plain(a, w), tol, tol)
        del got, singles
        agg_cases.append(_lane_timing(
            label, lambda: mule_agg_lanes(a, w),
            lambda: [mule_agg(a[i], w[i]) for i in range(LANES)],
            lambda: torch.bmm(a, w), lambda: mule_agg_lanes_plain(a, w),
            4 * LANES * (f * m + m * d_main + f * d_main),
            2 * LANES * f * m * d_main, err))
        del a, w

    mix_cases = []
    walks = [walk_colocation(SEED + i, N_MULES, N_STEPS, p_cross=P_CROSS)
             for i in range(LANES)]
    t = PEER_EVERY - 1                       # the walk's first exchange
    for what, d in (("walk", d_main), ("dense HAR strip", HAR_D)):
        if what == "walk":
            pos = torch.stack([torch.as_tensor(co["pos"][t]) for co in walks])
            area = torch.stack([torch.as_tensor(co["area"]) for co in walks])
            pos, area = pos.to("cuda"), area.to("cuda", torch.int64)
        else:                    # the trace scenarios' pos = 0, two areas
            pos = torch.zeros(LANES, N_MULES, 2, device="cuda")
            area = torch.randint(0, 2, (LANES, N_MULES), device="cuda",
                                 generator=g)
        act = torch.ones(LANES, N_MULES, dtype=torch.bool, device="cuda")
        w = torch.randn(LANES, N_MULES, d, device="cuda", generator=g)
        encounter_mix.launches = 0
        mix, mass = encounter_mix_lanes(pos, area, act, w, radius=RADIUS)
        if encounter_mix.launches != 1:
            raise AssertionError(f"encounter_mix_lanes counted "
                                 f"{encounter_mix.launches} launches, not 1")
        singles = [encounter_mix(pos[i], area[i], act[i], w[i],
                                 radius=RADIUS) for i in range(LANES)]
        torch.cuda.synchronize()
        same = all(torch.equal(mix[i], o) and torch.equal(mass[i], ms)
                   for i, (o, ms) in enumerate(singles))
        nnz = int(mass.sum().item())
        label = (f"S={LANES} M={N_MULES} D={d} f32, {what} ({nnz} met "
                 f"pairs)")
        print(f"encounter_mix_lanes {label}: every lane's mix and mass "
              f"{'bitwise' if same else 'NOT bitwise'} a single-lane call")
        if not same:
            raise AssertionError(f"encounter_mix_lanes {label}: a lane "
                                 f"differs from its single-lane call")
        del singles
        ref, ref_mass = encounter_mix_lanes_reference(pos, area, act, w,
                                                      radius=RADIUS)
        if not torch.equal(mass, ref_mass):
            raise AssertionError(f"encounter_mix_lanes {label}: masses "
                                 f"differ from the plain version's")
        err = _hold(f"encounter_mix_lanes {label} vs plain", mix, ref, tol,
                    tol)
        del mix, ref
        _same_bits_across_modes(f"encounter_mix_lanes {label}",
                                lambda: encounter_mix_lanes(
                                    pos, area, act, w, radius=RADIUS))
        e = torch.stack([encounter_matrix(pos[i], area[i], RADIUS, act[i])
                         for i in range(LANES)]).float()
        # W read once, the mix and mass written once, the geometry (pos f32
        # x2, area int64, active bool) read once; one multiply-add per met
        # pair and column
        mix_cases.append(_lane_timing(
            label, lambda: encounter_mix_lanes(pos, area, act, w,
                                               radius=RADIUS),
            lambda: [encounter_mix(pos[i], area[i], act[i], w[i],
                                   radius=RADIUS) for i in range(LANES)],
            lambda: torch.bmm(e, w),
            lambda: encounter_mix_lanes_reference(pos, area, act, w,
                                                  radius=RADIUS),
            LANES * (8 * N_MULES * d + 21 * N_MULES), 2 * nnz * d, err))
        del w, e
    entry = {"lanes": LANES, "library": "torch.bmm of the dense [S, F, M] "
             "or [S, M, M] gate", "cases": None}
    return {"mule_agg": {**entry, "cases": agg_cases},
            "encounter_mix": {**entry, "cases": mix_cases}}


def _ring_walk():
    """(colocation, order): the ring path's random walk (T = RING_STEPS),
    bucket-ordered by area, so that each rank's block is area-contiguous."""
    from repro_torch.core.distributed import (bucket_mule_order,
                                              reorder_colocation)
    from repro_torch.scenarios import walk_colocation
    co = walk_colocation(SEED, N_MULES, RING_STEPS, p_cross=P_CROSS)
    order = bucket_mule_order(co["area"])
    return reorder_colocation(co, order), order


def _hop_ring(label, pos, area, active, w, sizes, radius, need=None):
    """Blocks of ``sizes`` rows: for each row block i, the hop kernel
    against block (i - s) % n for s = 0 .. n-1 (those ``need`` keeps),
    each hop held to encounter_block, summed in ring order, normalised and
    held to encounter_mix. Returns ({(i, j): met pairs}, max hop error)."""
    import torch
    from repro_torch.kernels.encounter_mix import (encounter_block,
                                                   encounter_block_hop,
                                                   encounter_mix,
                                                   normalize_mix)
    n = len(sizes)
    starts = [sum(sizes[:k]) for k in range(n)]

    def blk(k, x):
        return None if x is None else x[starts[k]:starts[k] + sizes[k]]

    accs, masses, pairs, worst = [], [], {}, 0.0
    for i in range(n):
        acc = mass = None
        for s in range(n):
            if need is not None and not need[s]:
                continue
            j = (i - s) % n
            args = (blk(i, pos), blk(i, area), blk(i, active), starts[i],
                    blk(j, pos), blk(j, area), blk(j, active), starts[j],
                    blk(j, w), radius)
            got, got_mass = encounter_block_hop(*args)
            torch.cuda.synchronize()
            _check_pairs(f"{label} hop ({i}, {j})", *args[:8], radius)
            want, want_mass = encounter_block(*args)
            if not torch.equal(got_mass, want_mass):
                raise AssertionError(f"encounter_hop {label} hop ({i}, {j}):"
                                     f" masses differ from encounter_block")
            pairs[(i, j)] = int(want_mass.sum().item())
            if got.numel():
                err = (got - want).abs().max().item()
                if not err <= TOL["float32"]:
                    raise AssertionError(
                        f"encounter_hop {label} hop ({i}, {j}): max_abs_err "
                        f"{err:.3e} over {TOL['float32']}")
                worst = max(worst, err)
            del want
            acc, mass = ((got, got_mass) if acc is None
                         else (acc + got, mass + got_mass))
        accs.append(acc)
        masses.append(mass)
    mix, mass = normalize_mix(torch.cat(accs), torch.cat(masses)), \
        torch.cat(masses)
    del accs
    want, want_mass = encounter_mix(pos, area, active, w, radius=radius)
    same = torch.equal(mass, want_mass)
    err = (mix - want).abs().max().item() if w.shape[1] else 0.0
    print(f"encounter_hop {label}: {len(pairs)} hops over blocks {sizes}, "
          f"pair words equal, each against encounter_block: masses equal, "
          f"max_abs_err "
          f"{worst:.3e} (tol {TOL['float32']}); {sum(pairs.values())} "
          f"encounters; the ring-order sum, normalised, vs encounter_mix: "
          f"masses {'equal' if same else 'DIFFER'}, max_abs_err {err:.3e} "
          f"(tol {RING_MIX_TOL}) "
          f"{'ok' if same and err <= RING_MIX_TOL else 'MISMATCH'}")
    if not (same and err <= RING_MIX_TOL):
        raise AssertionError(f"encounter_hop {label}: the ring-order sum "
                             f"disagrees with encounter_mix")
    return pairs, worst


def _busiest_remote_hop(pos, area, w):
    """(args of encounter_block_hop, met pairs, (i, j)): the remote hop of
    the ring path's blocks (rows i, visiting j != i, in the ring's order)
    with the most met pairs, all active."""
    from repro_torch.kernels.encounter_mix import encounter_pairs_reference
    m_loc = N_MULES // RING_RANKS
    best = None
    for i in range(RING_RANKS):
        for s in range(1, RING_RANKS):
            j = (i - s) % RING_RANKS
            sl_r, sl_v = (slice(k * m_loc, (k + 1) * m_loc) for k in (i, j))
            args = (pos[sl_r], area[sl_r], None, i * m_loc, pos[sl_v],
                    area[sl_v], None, j * m_loc, w[sl_v], RADIUS)
            nnz = int(encounter_pairs_reference(*args[:8], RADIUS)[1].sum())
            if best is None or nnz > best[1]:
                best = (args, nnz, (i, j))
    return best


def phase_encounter_hop(card: str) -> dict:
    """encounter_hop (one ring hop) against its plain version on the
    blocks of the ring path's population; returns its JSON row, timed at
    the ring path's hop shape (R = V = 64, D = 546,484, f32)."""
    import torch
    from repro_torch.baselines.gossip import ring_hop_mask
    from repro_torch.kernels.encounter_mix import (encounter_block,
                                                   encounter_block_hop,
                                                   encounter_gate)
    from repro_torch.kernels.encounter_mix.ref import radius_sq
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 5)
    d_main = 546_484     # the paper CNN's parameter count (CONFIG)
    m_loc = N_MULES // RING_RANKS
    # (a) the ring path's population at its first exchange, every pair of
    # its 4 blocks (the 4 shift-0 hops and the 12 with col0 != row0)
    co, _ = _ring_walk()
    pos = torch.as_tensor(co["pos"][PEER_EVERY - 1], device="cuda")
    area = torch.as_tensor(co["area"], device="cuda")
    w = torch.randn(N_MULES, d_main, device="cuda", generator=g)
    pairs, err = _hop_ring(f"walk M={N_MULES} D={d_main}", pos, area, None,
                           w, [m_loc] * RING_RANKS, RADIUS)
    # (b) ragged blocks (R != V, D not a multiple of 128) with churn
    m, d = 200, 4099
    _hop_ring(f"ragged M={m} D={d} p_active=0.8",
              torch.rand(m, 2, device="cuda", generator=g),
              torch.randint(0, 2, (m,), device="cuda", generator=g),
              torch.rand(m, device="cuda", generator=g) < 0.8,
              torch.randn(m, d, device="cuda", generator=g), [70, 45, 85],
              0.3)
    # (c) a balanced bucket-ordered 4-area population: the mask prunes
    # every remote hop, and the kernel runs only the kept ones
    b_area = torch.arange(RING_RANKS, device="cuda").repeat_interleave(m_loc)
    need = ring_hop_mask(b_area.cpu(), None, RING_RANKS).tolist()
    before = encounter_block_hop.launches
    _hop_ring(f"4 areas, bucket-ordered, mask {need}",
              torch.rand(N_MULES, 2, device="cuda", generator=g), b_area,
              None, torch.randn(N_MULES, d, device="cuda", generator=g),
              [m_loc] * RING_RANKS, RADIUS, need=need)
    launched = encounter_block_hop.launches - before
    print(f"encounter_hop pruned ring: {launched} launches for "
          f"{RING_RANKS} x {sum(need)} kept hops")
    if launched != RING_RANKS * sum(need) or sum(need) == RING_RANKS:
        raise AssertionError("the pruned ring did not launch exactly the "
                             "kept hops")

    # timing: the remote hop of (a) with the most encounters
    args, nnz, (i, j) = _busiest_remote_hop(pos, area, w)
    if nnz != pairs[(i, j)]:
        raise AssertionError("the busiest hop's pairs disagree")
    ms = _median_ms(lambda: encounter_block_hop(*args))
    plain_ms = _median_ms(lambda: encounter_block(*args))
    d2, gate = encounter_gate(*args[:8])
    e = ((d2 <= radius_sq(RADIUS).cuda()) & gate).float()
    library_ms = _median_ms(lambda: torch.matmul(e, args[8]))
    # bytes: W_v read once, acc and mass written once, the two blocks'
    # geometry (pos f32 x2, area int64, active bool) read once
    n_bytes = 4 * m_loc * d_main * 2 + 4 * m_loc + 2 * 17 * m_loc
    n_flop = 2 * nnz * d_main          # one multiply-add per met pair, column
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flop / FP32_FLOP_PER_S * 1e3
    row = {
        "name": "encounter_hop", "route": "cuda",
        "source": "src/repro_torch/kernels/encounter_mix/csrc/"
                  "encounter_mix.cu",
        "replaces": "src/repro/kernels/encounter_mix/kernel.py:166",
        "launches": None, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }
    print(f"encounter_hop timing R=V={m_loc} D={d_main} f32, hop (rows "
          f"{i}, visiting {j}; {nnz} encounters): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.matmul on the dense e [{m_loc}, "
          f"{m_loc}] {library_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}; {n_bytes} B, {n_flop} FLOP for the met "
          f"pairs; the dense strip's {2 * m_loc * m_loc * d_main} FLOP take "
          f"{2 * m_loc * m_loc * d_main / FP32_FLOP_PER_S * 1e3:.4f} ms) "
          f"[{card}]")
    row["lanes"] = _hop_lanes(pos, area, w, (i, j), n_bytes, card)
    return row


def _hop_lanes(pos, area, w, busiest, hop_bytes: int, card: str) -> dict:
    """``encounter_block_hop_lanes``, the hop of a seed sweep over the
    ranks, at S = 1, 2 and 4 lanes of the ring path's remote hops (lane 0
    the busiest; every lane with the busiest hop's row0 and col0): each lane
    bitwise its single-lane ``encounter_block_hop``, one launch a call,
    within the float32 bound of the plain version; S = 4 timed beside 4
    single launches and ``torch.bmm`` over the dense gates (the ``lanes``
    entry of row 3)."""
    import torch
    from repro_torch.kernels.encounter_mix import (
        encounter_block_hop, encounter_block_hop_lanes,
        encounter_block_lanes_reference, encounter_gate)
    from repro_torch.kernels.encounter_mix.ref import radius_sq
    m_loc = N_MULES // RING_RANKS
    i0, j0 = busiest
    row0, col0 = i0 * m_loc, j0 * m_loc
    pairs = [busiest] + [((i0 + k) % RING_RANKS, (j0 + k) % RING_RANKS)
                         for k in range(1, LANES)]

    def blk(k, x):
        return x[k * m_loc:(k + 1) * m_loc]

    # lane k: (pos_r, area_r, pos_v, area_v, w_v) of hop pairs[k]
    hops = [(blk(i, pos), blk(i, area), blk(j, pos), blk(j, area), blk(j, w))
            for i, j in pairs]

    def single(k):
        p_r, a_r, p_v, a_v, w_v = hops[k]
        return (p_r, a_r, None, row0, p_v, a_v, None, col0, w_v, RADIUS)

    def lanes(n):
        st = [torch.stack([h[c] for h in hops[:n]]) for c in range(5)]
        return (st[0], st[1], None, row0, st[2], st[3], None, col0, st[4],
                RADIUS)

    worst = 0.0
    for n in (1, 2, LANES):
        args = lanes(n)
        before = encounter_block_hop.launches
        acc, mass = encounter_block_hop_lanes(*args)
        torch.cuda.synchronize()
        if encounter_block_hop.launches - before != 1:
            raise AssertionError("encounter_block_hop_lanes: not one launch "
                                 "a call")
        for k in range(n):
            a1, m1 = encounter_block_hop(*single(k))
            if not (torch.equal(acc[k], a1) and torch.equal(mass[k], m1)):
                raise AssertionError(f"encounter_hop lanes S={n}: lane {k} "
                                     f"is not its single-lane hop's bits")
        want, want_mass = encounter_block_lanes_reference(*args)
        err = (acc - want).abs().max().item()
        if not (torch.equal(mass, want_mass) and err <= TOL["float32"]):
            raise AssertionError(f"encounter_hop lanes S={n}: vs the plain "
                                 f"version, masses equal "
                                 f"{torch.equal(mass, want_mass)}, "
                                 f"max_abs_err {err:.3e}")
        worst = max(worst, err)
        print(f"encounter_hop lanes S={n} (hops {pairs[:n]}, row0 {row0}, "
              f"col0 {col0}): one launch, each lane the bits of its "
              f"single-lane hop; vs the plain version masses equal, "
              f"max_abs_err {err:.3e} (tol {TOL['float32']})")
        del acc, want
    args = lanes(LANES)
    gates = [encounter_gate(*single(k)[:8]) for k in range(LANES)]
    e = torch.stack([((d2 <= radius_sq(RADIUS).cuda()) & g).float()
                     for d2, g in gates])
    nnz = int(e.sum().item())
    print(f"encounter_hop lanes timing, S={LANES} hops of R=V={m_loc}, "
          f"D={w.shape[1]} ({nnz} encounters) [{card}]:")
    return _lane_timing(
        f"S={LANES} ring hops R=V={m_loc} D={w.shape[1]}",
        lambda: encounter_block_hop_lanes(*args),
        lambda: [encounter_block_hop(*single(k)) for k in range(LANES)],
        lambda: torch.bmm(e, args[8]),
        lambda: encounter_block_lanes_reference(*args),
        LANES * hop_bytes, 2 * nnz * w.shape[1], worst)


def _unmasked_pairs(s: int, sk: int, window, causal: bool) -> int:
    """(query, key) pairs the masks leave, for one batch row and head
    (right-aligned queries)."""
    import numpy as np
    qpos = np.arange(s, dtype=np.int64) + (sk - s)
    hi = np.minimum(qpos, sk - 1) if causal else np.full(s, sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(s, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _sass_count(kernel: str, opcode: str) -> int:
    """How many times ``opcode`` appears in the SASS of a built kernel
    library (cuobjdump from the toolkit that built it)."""
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(kernel))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return len(re.findall(rf"\b{opcode}\b", sass))


def _flash_routed(q, k, v, **kw):
    """flash_attention on the card, holding the route it took: bf16 at a
    tensor-core head dim launches the tensor-core kernel, every other call
    the SIMT one, once."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import TC_HEAD_DIMS
    before = (flash_attention.launches, flash_attention.tc_launches)
    out = flash_attention(q, k, v, **kw)
    tc = q.dtype == torch.bfloat16 and q.shape[-1] in TC_HEAD_DIMS
    took = (flash_attention.launches - before[0],
            flash_attention.tc_launches - before[1])
    if took != (1, int(tc)):
        raise AssertionError(f"flash_attention {q.dtype} head_dim "
                             f"{q.shape[-1]}: (launches, tensor-core "
                             f"launches) {took}, expected {(1, int(tc))}")
    return out


def phase_flash_attention(card: str) -> dict:
    """flash_attention against its plain versions; returns its JSON row
    (timed at gemma3-4b's global-layer prefill shape)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_reference,
                                                     mha_reference)
    torch.backends.cuda.matmul.allow_tf32 = False
    hgmma = _sass_count("flash_attention_tc", "HGMMA")
    print(f"flash_attention_tc: {hgmma} HGMMA instructions in the built "
          f"library (cuobjdump -sass)")
    if hgmma == 0:
        raise AssertionError("the tensor-core flash library has no HGMMA")
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 2)

    def inputs(b, s, sk, h, kv, d, dtype):
        return (torch.randn(b, s, h, d, device="cuda", generator=g).to(dtype),
                torch.randn(b, sk, kv, d, device="cuda", generator=g)
                .to(dtype),
                torch.randn(b, sk, kv, d, device="cuda", generator=g)
                .to(dtype))

    def check(label, out, want, tol) -> float:
        return _hold(f"flash_attention {label}", out, want, tol, tol)

    cases = [(b, s, s, h, kv, d, win, causal)
             for b, s, h, kv, d, win, causal in FLASH_CASES]
    cases.append((2, 4, 64, 4, 2, 16, None, True))   # right-aligned decode
    cases += FLASH_TC_CASES
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        tol = FLASH_TOL[name]
        for b, s, sk, h, kv, d, win, causal in cases:
            q, k, v = inputs(b, s, sk, h, kv, d, dtype)
            out = _flash_routed(q, k, v, causal=causal, window=win)
            torch.cuda.synchronize()
            label = (f"b={b} s={s} sk={sk} h={h} kv={kv} d={d} window={win} "
                     f"causal={causal} {name}")
            check(label + " vs flash_reference", out,
                  flash_reference(q, k, v, causal=causal, window=win,
                                  block_q=64, block_k=64), tol)
            check(label + " vs mha_reference", out,
                  mha_reference(q, k, v, causal=causal, window=win),
                  FLASH_MHA_TOL_F32 if dtype == torch.float32 else tol)
            if dtype == torch.bfloat16:
                _hold(f"flash_attention {label} vs fp32 mha_reference of "
                      f"the same inputs", out,
                      mha_reference(q.float(), k.float(), v.float(),
                                    causal=causal, window=win),
                      *FLASH_BF16_VS_F32)

    # gemma3-4b's per-layer prefill shapes, in the served model's bf16,
    # and in f32 on the same (bf16-valued) inputs
    cfg = get_config(LM_ARCH)
    b, s, h, kv, d = (PREFILL_B, PREFILL_S, cfg.n_heads, cfg.n_kv_heads,
                      cfg.resolved_head_dim)
    q, k, v = inputs(b, s, s, h, kv, d, torch.bfloat16)
    # SDPA's layout is [B, H, S, D]; the copies are made outside the timing
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    row, errs = None, []
    for win in (None, cfg.sliding_window):
        kind = "global" if win is None else f"local (window {win})"
        label = f"gemma3-4b {kind} layer q {list(q.shape)} k/v {list(k.shape)}"
        q32, k32, v32 = q.float(), k.float(), v.float()
        oracle = mha_reference(q32, k32, v32, causal=True, window=win)
        out = _flash_routed(q32, k32, v32, causal=True, window=win)
        check(label + " f32 vs mha_reference", out, oracle,
              FLASH_MHA_TOL_F32)
        check(label + " f32 vs flash_reference", out,
              flash_attention(q32, k32, v32, causal=True, window=win,
                              backend="ref"), FLASH_TOL["float32"])
        del q32, k32, v32
        out = _flash_routed(q, k, v, causal=True, window=win)
        torch.cuda.synchronize()
        _hold(f"flash_attention {label} bf16 vs fp32 mha_reference of the "
              f"same inputs", out, oracle, *FLASH_BF16_VS_F32)
        del oracle
        errs.append(_hold(f"flash_attention {label} bf16 vs flash_reference",
                          out, flash_attention(q, k, v, causal=True,
                                               window=win, backend="ref"),
                          *FLASH_BF16_VS_BF16))
        _hold(f"flash_attention {label} bf16 vs mha_reference", out,
              mha_reference(q, k, v, causal=True, window=win),
              *FLASH_BF16_VS_BF16)
        if win is None:
            mask, note = None, "is_causal=True"
        else:
            qpos = torch.arange(s, device="cuda")[:, None]
            kpos = torch.arange(s, device="cuda")[None, :]
            mask = (kpos <= qpos) & (kpos > qpos - win)
            note = "a boolean band mask"

        def lib():
            return F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)

        lib_err = (lib().transpose(1, 2).float() - out.float()).abs().max()
        del out
        ms = _median_ms(lambda: flash_attention(q, k, v, causal=True,
                                                window=win), reps=10)
        plain_ms = _median_ms(lambda: flash_attention(
            q, k, v, causal=True, window=win, backend="ref"), reps=3, warm=1)
        library_ms = _median_ms(lib, reps=10)
        pairs = _unmasked_pairs(s, s, win, True) * b * h
        n_flop = 4 * d * pairs
        n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())  # bf16 q,k,v,out
        t_ops = n_flop / BF16_TENSOR_FLOP_PER_S * 1e3
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"flash_attention timing {label} bf16: tensor-core kernel "
              f"{ms:.4f} ms ({n_flop / ms / 1e9:.2f} TFLOP/s useful, "
              f"{1.5 * n_flop / ms / 1e9:.2f} on the tensor cores with p "
              f"split), plain {plain_ms:.4f} ms, "
              f"SDPA ({note}, enable_gqa) "
              f"{library_ms:.4f} ms (max |SDPA - kernel| "
              f"{lib_err.item():.3e}), bound {max(t_ops, t_bytes):.4f} ms "
              f"({bound_by}; {pairs} unmasked pairs, {n_flop} FLOP at "
              f"{BF16_TENSOR_FLOP_PER_S / 1e12:.0f} TFLOP/s bf16 dense, "
              f"{n_bytes} B at {HBM_BYTES_PER_S / 1e12:.2f} TB/s) [{card}]")
        timed = {"ms": ms, "plain_ms": plain_ms,
                 "bound_ms": max(t_ops, t_bytes), "bound_by": bound_by,
                 "library_ms": library_ms}
        if win is None:
            row = {
                "name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/flash_attention/csrc/"
                          "flash_attention_tc.cu",
                "replaces": "src/repro/kernels/flash_attention/kernel.py:118",
                "launches": None, "max_abs_err": None, **timed,
                "simt_source": "src/repro_torch/kernels/flash_attention/"
                               "csrc/flash_attention.cu (float32, and bf16 "
                               "at head dims 8, 16, 32)",
                "hgmma": hgmma,
            }
        else:
            row["local_layer"] = {"window": win, "max_abs_err": errs[-1],
                                  **timed}
    row["max_abs_err"] = max(errs)
    row["second_shape"] = _flash_layer_shape(card, inputs, check,
                                             HYBRID_ARCH)
    # the GQA groups of the MoE and the other dense models (head dims 64
    # and 128): bf16 on the tensor cores; granite-moe's also f32 (SIMT)
    row["layer_shapes"] = [
        _flash_layer_shape(card, inputs, check, arch, f32=arch == MOE_ARCH)
        for arch in FLASH_LAYER_ARCHS]
    # Whisper's encoder layer (bidirectional, 4 x 1500 frames) and its
    # decoder's self-attention in the prefill (causal, 4 x 448), group 1
    row["layer_shapes"] += [
        _flash_layer_shape(card, inputs, check, AUDIO_ARCH, b=AUDIO_B,
                           s=get_config(AUDIO_ARCH).encoder_seq,
                           causal=False),
        _flash_layer_shape(card, inputs, check, AUDIO_ARCH, b=AUDIO_B,
                           s=AUDIO_S)]
    return row


def _flash_layer_shape(card: str, inputs, check, arch: str,
                       f32: bool = True, b: int = PREFILL_B,
                       s: int = PREFILL_S, causal: bool = True) -> dict:
    """flash_attention at ``arch``'s per-layer prefill shape (q [b, s, H,
    D], k/v [b, s, KV, D], no window; causal or bidirectional): bf16 on the
    tensor-core route held to its oracles and timed beside SDPA and its
    bound; with ``f32`` also the same (bf16-valued) inputs in f32 on the
    SIMT route. Returns the shape's entry of row 4."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     mha_reference)
    cfg = get_config(arch)
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = inputs(b, s, s, h, kv, d, torch.bfloat16)
    kind = "causal" if causal else "bidirectional"
    label = (f"{arch} layer q {list(q.shape)} k/v {list(k.shape)} {kind} "
             f"(GQA group {h // kv})")
    q32, k32, v32 = q.float(), k.float(), v.float()
    oracle = mha_reference(q32, k32, v32, causal=causal)
    if f32:
        check(label + " f32 vs mha_reference",
              _flash_routed(q32, k32, v32, causal=causal), oracle,
              FLASH_MHA_TOL_F32)
        check(label + " f32 vs flash_reference",
              _flash_routed(q32, k32, v32, causal=causal),
              flash_attention(q32, k32, v32, causal=causal, backend="ref"),
              FLASH_TOL["float32"])
    del q32, k32, v32
    out = _flash_routed(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _hold(f"flash_attention {label} bf16 vs fp32 mha_reference of the same "
          f"inputs", out, oracle, *FLASH_BF16_VS_F32)
    del oracle
    err = _hold(f"flash_attention {label} bf16 vs flash_reference", out,
                flash_attention(q, k, v, causal=causal, backend="ref"),
                *FLASH_BF16_VS_BF16)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def lib():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal,
                                              enable_gqa=True)

    lib_err = (lib().transpose(1, 2).float() - out.float()).abs().max()
    del out
    ms = _median_ms(lambda: flash_attention(q, k, v, causal=causal),
                    reps=10)
    plain_ms = _median_ms(lambda: flash_attention(q, k, v, causal=causal,
                                                  backend="ref"),
                          reps=3, warm=1)
    library_ms = _median_ms(lib, reps=10)
    pairs = _unmasked_pairs(s, s, None, causal) * b * h
    n_flop = 4 * d * pairs
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    t_ops = n_flop / BF16_TENSOR_FLOP_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"flash_attention timing {label} bf16: tensor-core kernel "
          f"{ms:.4f} ms ({n_flop / ms / 1e9:.2f} TFLOP/s useful, "
          f"{1.5 * n_flop / ms / 1e9:.2f} on the tensor cores with p split), "
          f"plain {plain_ms:.4f} ms, SDPA (is_causal={causal}, enable_gqa) "
          f"{library_ms:.4f} ms (max |SDPA - kernel| "
          f"{lib_err.item():.3e}), bound {max(t_ops, t_bytes):.4f} ms "
          f"({bound_by}; {pairs} unmasked pairs, {n_flop} FLOP at "
          f"{BF16_TENSOR_FLOP_PER_S / 1e12:.0f} TFLOP/s bf16 dense, "
          f"{n_bytes} B at {HBM_BYTES_PER_S / 1e12:.2f} TB/s) [{card}]")
    return {"shape": f"q {list(q.shape)}, k/v {list(k.shape)} {kind} "
                     f"({arch})",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes), "bound_by": bound_by,
            "library_ms": library_ms}


def _ssd_inputs(g, b, s, h, p, n, a=None):
    """x, dt, A, B, C of the SSD scan, drawn as tests/test_kernels_ssm.py
    draws them (A given, or -exp of a normal)."""
    import torch
    import torch.nn.functional as F

    def normal(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    x, dt = normal(b, s, h, p), F.softplus(normal(b, s, h))
    A = -torch.exp(normal(h)) if a is None else a
    return x, dt, A, normal(b, s, n), normal(b, s, n)


def _ssd_work(b, s, h, p, n):
    """(bytes, fp32 operations) the scan needs: each input read once and y
    written once; the least work of its forms, the recurrence's, where each
    (batch row, head, step) takes one state update s = dA s + (dt x) Bᵀ and
    one read-out y = C s, 2 P N FLOP each, and one exp for dA (the chunked
    form the kernel runs does more)."""
    n_ops = 4 * b * h * s * p * n + b * h * s
    n_bytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * n)
    return n_bytes, n_ops


def phase_ssd_scan(card: str) -> dict:
    """ssd_scan against its plain versions; returns its JSON row (timed at
    zamba2-2.7b's prefill shape)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan import (ssd_chunked_reference,
                                              ssd_reference, ssd_scan)
    from repro_torch.kernels.ssm_scan.ops import SLICE
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 3)
    for b, s, h, p, n, chunk in SSD_CASES + SSD_EDGE:
        args = _ssd_inputs(g, b, s, h, p, n)
        y, state = ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        if state is not None:
            raise AssertionError("the kernel returned a final state")
        label = f"ssd_scan b={b} s={s} h={h} p={p} n={n} chunk={chunk}"
        _hold(label + " vs ssd_reference", y, ssd_reference(*args)[0],
              SSD_ORACLE_TOL, 0.0)
        _hold_scaled(label + " vs ssd_chunked_reference", y,
                     ssd_chunked_reference(*args, chunk=chunk)[0],
                     SSD_VS_CHUNKED_REL)

    # zamba2-2.7b's prefill shape, with the model's A = -(1 .. 80), under
    # which cum reaches about -3,500 within a chunk
    cfg = get_config(HYBRID_ARCH)
    d_in = cfg.ssm_expand * cfg.d_model
    b, s, p, n, chunk = (PREFILL_B, PREFILL_S, cfg.ssm_head_dim,
                         cfg.ssm_state, 64)
    h = d_in // p
    a = -torch.arange(1, h + 1, dtype=torch.float32, device="cuda")
    args = _ssd_inputs(g, b, s, h, p, n, a)
    label = f"{HYBRID_ARCH} x {[b, s, h, p]} n={n} chunk={chunk}"
    y, _ = ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    want = ssd_chunked_reference(*args, chunk=chunk)[0]
    if not bool(torch.isfinite(y).all()):
        raise AssertionError(f"ssd_scan {label}: non-finite output")
    err = _hold_scaled(f"ssd_scan {label} vs ssd_chunked_reference", y,
                       want, SSD_VS_CHUNKED_REL)
    oracle, _ = ssd_reference(*(t.double() for t in args))
    to_oracle = [(t.double() - oracle).abs().max().item() for t in (y, want)]
    print(f"ssd_scan {label}: distance from the f64 sequential oracle "
          f"(max |y| {oracle.abs().max().item():.3e}): kernel "
          f"{to_oracle[0]:.3e}, ssd_chunked_reference {to_oracle[1]:.3e} "
          f"(the kernel's must be at most twice the plain version's)")
    if not to_oracle[0] <= 2 * to_oracle[1]:
        raise AssertionError(f"ssd_scan {label}: farther from the oracle "
                             f"than the plain chunked version")
    del y, want, oracle
    ms = _median_ms(lambda: ssd_scan(*args, chunk=chunk), reps=10)
    plain_ms = _median_ms(lambda: ssd_chunked_reference(*args, chunk=chunk),
                          reps=3, warm=1)
    n_bytes, n_ops = _ssd_work(b, s, h, p, n)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOP_PER_S * 1e3
    row = {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssm_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:95",
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "library": "none: no single PyTorch call computes the SSD scan",
        "kernels_per_call": 2,
        "launches_count": "wrapper calls; each launches ssd_prep_kernel, "
                          "then ssd_scan_kernel",
        "slice": SLICE,
        "build": _ptxas_usage("ssd_scan", {
            "ssd_prep_kernel": "ssd_prep_kernel",
            "ssd_scan_kernel<full>": "ssd_scan_kernelILb1E"}),
    }
    print(f"ssd_scan timing {label} f32: kernel {ms:.4f} ms "
          f"({n_ops / ms / 1e9:.2f} TFLOP/s of the least work), plain "
          f"{plain_ms:.4f} ms, no library call, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}; {n_bytes} B at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s = {t_bytes:.4f} ms, {n_ops} "
          f"operations, the recurrence's FLOP and exps, at "
          f"{FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s fp32 = {t_ops:.4f} ms) "
          f"[{card}]")
    print(f"ssd_scan build (slice {SLICE}): {row['build']} [{card}]")
    return row


def _slstm_inputs(g, b, s, h, p, pre_std=1.0, r_std=0.1):
    """pre [B, S, 4, H, P] and r [4, H, P, P], normal at the given scales
    (the defaults are tests/test_kernels_slstm.py's)."""
    import torch
    return (pre_std * torch.randn(b, s, 4, h, p, device="cuda", generator=g),
            r_std * torch.randn(4, h, p, p, device="cuda", generator=g))


def phase_slstm_scan(card: str) -> dict:
    """slstm_scan against its plain version; returns its JSON row (timed
    at xlstm-350m's prefill shape)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.slstm_fused import slstm_reference, slstm_scan
    from repro_torch.kernels.slstm_fused.ops import (CLUSTER, slstm_geometry,
                                                     slstm_step_floor)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 4)
    for b, s, h, p in SLSTM_CASES + SLSTM_EDGE:
        pre, r = _slstm_inputs(g, b, s, h, p)
        out = slstm_scan(pre, r)
        torch.cuda.synchronize()
        _hold(f"slstm_scan b={b} s={s} h={h} p={p} vs slstm_reference", out,
              slstm_reference(pre, r)[0], SLSTM_TOL, 0.0)

    cfg = get_config(XLSTM_ARCH)
    b, s, h = PREFILL_B, PREFILL_S, cfg.n_heads
    p = cfg.d_model // h
    pre, r = _slstm_inputs(g, b, s, h, p, SLSTM_PRE_STD, SLSTM_R_STD)
    label = f"{XLSTM_ARCH} pre {[b, s, 4, h, p]}"
    out = slstm_scan(pre, r)
    torch.cuda.synchronize()
    want = slstm_reference(pre, r)[0]
    err = _hold(f"slstm_scan {label} vs slstm_reference", out, want,
                SLSTM_TOL, 0.0)        # fails on a NaN too
    oracle = slstm_reference(pre.double(), r.double())[0]
    to_oracle = [(t.double() - oracle).abs().max().item() for t in (out, want)]
    print(f"slstm_scan {label}: distance from the f64 plain version (max "
          f"|h| {oracle.abs().max().item():.3e}): kernel {to_oracle[0]:.3e}, "
          f"f32 slstm_reference {to_oracle[1]:.3e} (the kernel's must be at "
          f"most twice the plain version's)")
    if not to_oracle[0] <= 2 * to_oracle[1]:
        raise AssertionError(f"slstm_scan {label}: farther from the f64 "
                             f"oracle than twice the plain version")
    del out, want, oracle
    ms = _median_ms(lambda: slstm_scan(pre, r), reps=10)
    plain_ms = _median_ms(lambda: slstm_reference(pre, r), reps=3, warm=1)
    # the products h_{t-1} @ r of every step, and each input and output
    # moved once
    n_flop = 2 * b * s * 4 * h * p * p
    n_bytes = 4 * (pre.numel() + b * s * h * p + r.numel())
    t_ops = n_flop / FP32_FLOP_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    row = {
        "name": "slstm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/slstm_fused/csrc/slstm_scan.cu",
        "replaces": "src/repro/kernels/slstm_fused/kernel.py:75",
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "library": "none: no PyTorch call computes the sLSTM cell "
                   "(torch.nn.LSTM and cuDNN have sigmoid gates, no m "
                   "stabiliser and a dense, not head-wise, recurrent matrix)",
        "us_per_step": ms * 1e3 / s,
    }
    # the step floor: the kernel's h exchange alone over the same grid and
    # steps, through st.async and mbarriers (the kernel's) and through
    # DSMEM stores and a cluster barrier a step (the previous design's)
    floor = {}
    for sync in ("mbarrier", "cluster"):
        last = slstm_step_floor(b, s, h, p, sync=sync)[:, s - 1]
        if not bool((last == float(s)).all()):
            raise AssertionError(f"slstm step floor ({sync}) lost steps")
        floor[sync] = _median_ms(
            lambda: slstm_step_floor(b, s, h, p, sync=sync), reps=5) \
            * 1e3 / s
    rows = slstm_geometry(b, h, p)["rows"]
    row.update({
        "step_floor_us": floor, "cluster": CLUSTER,
        "build": _ptxas_usage("slstm_scan", {
            f"slstm_scan_kernel<{rows} rows>":
                f"slstm_scan_kernelILi{rows}ELi0E"}),
    })
    print(f"slstm_scan timing {label} f32: kernel {ms:.4f} ms "
          f"({row['us_per_step']:.3f} us per time step, "
          f"{n_flop / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} ms, no "
          f"library call, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
          f"{n_flop} FLOP at {FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s fp32 = "
          f"{t_ops:.4f} ms, {n_bytes} B at {HBM_BYTES_PER_S / 1e12:.2f} TB/s "
          f"= {t_bytes:.4f} ms) [{card}]")
    print(f"slstm_scan step floor at {label} ({CLUSTER}-block clusters): "
          f"{floor['mbarrier']:.3f} us a step through st.async and "
          f"mbarriers, {floor['cluster']:.3f} through DSMEM stores and "
          f"cluster.sync(); build {row['build']} [{card}]")
    return row


def _max_diff(a: dict, b: dict, sides) -> float:
    """Largest |a - b| over the float tensors of the named state parts."""
    return max((a[s][k].float() - b[s][k].float()).abs().max().item()
               for s in sides for k in a[s])


def _group_mean_overhead(models, assign) -> None:
    """Time the kernel alone against the whole masked_group_mean (flatten
    of every leaf into [M, D], kernel, split back) on the main path's
    population."""
    import torch
    from repro_torch.core.aggregation import masked_group_mean
    from repro_torch.kernels.mule_agg import mule_agg
    n_m = assign.shape[1]
    flat = torch.cat([models[k].reshape(n_m, -1) for k in sorted(models)],
                     dim=1)
    kern = _median_ms(lambda: mule_agg(assign, flat), reps=10)
    whole = _median_ms(lambda: masked_group_mean(models, assign), reps=10)
    print(f"masked_group_mean at M={n_m} D={flat.shape[1]}: {whole:.4f} ms "
          f"whole, {kern:.4f} ms of it the kernel")


def phase_main_path(card: str) -> dict:
    import torch
    from repro_torch.configs.mule_cnn import CONFIG
    from repro_torch.core.population import PopulationConfig, init_population
    from repro_torch.experiment import (batch_sampler, cnn_model_fns,
                                        image_data_mobile)
    from repro_torch.kernels.mule_agg import mule_agg
    from repro_torch.scenarios import get_scenario, run_population

    spec = get_scenario("commuter")
    co = spec.colocation(SEED, N_MULES, N_STEPS)
    t0 = time.perf_counter()
    Xtr, Ytr, Xte, Yte = image_data_mobile(
        SEED, N_MULES, spec.n_fixed, co["init_space"], co["init_area"],
        n_super=CONFIG.n_classes, image_size=CONFIG.image_size)
    print(f"data: train {tuple(Xtr.shape)}, test {tuple(Xte.shape)} in "
          f"{time.perf_counter() - t0:.2f} s")
    init_fn, train_fn, eval_fn = cnn_model_fns(CONFIG, LR)
    pcfg = PopulationConfig(mode=spec.mode, n_fixed=spec.n_fixed,
                            n_mules=N_MULES)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    pop0 = init_population(pcfg, init_fn, gen)
    d_params = sum(v[0].numel() for v in pop0["mule_models"].values())
    print(f"population: {N_MULES} mules + {spec.n_fixed} fixed devices, "
          f"D={d_params} parameters each ({CONFIG.name})")
    batch_fn = batch_sampler(Xtr, Ytr, BATCH)

    def eval_hook(st, last):
        return torch.func.vmap(eval_fn)(st["mule_models"], Xte[last],
                                        Yte[last])

    def run(cfg, colocation):
        return run_population(pop0, colocation, batch_fn, train_fn, cfg,
                              SEED, eval_every=EVAL_EVERY, eval_fn=eval_hook)

    # warm-up: cuDNN plans and first-call set-up, outside the counted run
    run(pcfg, {k: co[k][:3] for k in ("fixed_id", "exchange")})
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    mule_agg.launches = 0
    t0 = time.perf_counter()
    final, aux = run(pcfg, co)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mule_agg.launches
    peak = torch.cuda.max_memory_allocated()

    if launches != N_STEPS:
        raise AssertionError(f"mule_agg launched {launches} times in a "
                             f"{N_STEPS}-step run, expected {N_STEPS}")
    evals = aux["evals"]
    if evals is None or tuple(evals.shape) != (N_STEPS // EVAL_EVERY,
                                               N_MULES):
        raise AssertionError(f"evals of shape "
                             f"{None if evals is None else evals.shape}")
    if not bool(torch.isfinite(evals).all()):
        raise AssertionError("non-finite eval")
    receipts = int(final["fresh"]["count"].sum())
    if receipts == 0:
        raise AssertionError("no mule delivered to a fixed device")
    for k, v in {**final["mule_models"], **final["fixed_models"]}.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite weights in {k}")
    trace = [(int(s), float(a)) for s, a in
             zip(aux["eval_steps"], evals.mean(1).tolist())]
    print(f"main path: mlmule mobile on commuter, T={N_STEPS}: "
          f"{N_STEPS / wall:.3f} steps/s ({wall:.3f} s), peak memory "
          f"{peak} B, mule_agg launches {launches}, receipts {receipts}, "
          f"accuracy trace {trace} [{card}]")

    # the whole path against its plain version (agg_backend="ref"), and
    # its exchange and aggregation step by step in lockstep
    run_kw = dict(state=pop0, colocation=co, batches=batch_fn,
                  train_fn=train_fn, cfg=pcfg, key=SEED,
                  eval_every=EVAL_EVERY, eval_fn=eval_hook)
    _replays("main path mlmule", run_kw, "agg_backend", REPLAY_ATOL)
    _aggregation_lockstep("main path mlmule", run_kw, N_STEPS)

    assign = torch.rand(spec.n_fixed, N_MULES, device="cuda", generator=gen)
    _group_mean_overhead(final["mule_models"], assign / assign.sum(1)[:, None])
    _profile_steps(lambda: run(pcfg, {k: co[k][:PROFILE_STEPS]
                                      for k in ("fixed_id", "exchange")}),
                   PROFILE_STEPS, "mlmule")
    return {"mule_agg": launches}


def _encounters_per_mule(co) -> float:
    """Mean peers met per mule at the exchange steps (the plain gate)."""
    import torch
    from repro_torch.kernels.encounter_mix import encounter_gate
    from repro_torch.kernels.encounter_mix.ref import radius_sq
    area = torch.as_tensor(co["area"], device="cuda")
    counts = []
    for t in range(PEER_EVERY - 1, N_STEPS, PEER_EVERY):
        pos = torch.as_tensor(co["pos"][t], device="cuda")
        d2, gate = encounter_gate(pos, area, None, 0, pos, area, None, 0)
        met = (d2 <= radius_sq(RADIUS).cuda()) & gate
        counts.append(met.sum(1).float().mean().item())
    return sum(counts) / len(counts)


def phase_peer_path(card: str) -> dict:
    import torch
    from repro_torch.configs.mule_cnn import CONFIG
    from repro_torch.core.population import PopulationConfig, init_population
    from repro_torch.experiment import (batch_sampler, cnn_model_fns,
                                        image_data_mobile)
    from repro_torch.kernels.encounter_mix import encounter_mix
    from repro_torch.kernels.mule_agg import mule_agg
    from repro_torch.scenarios import run_population, walk_colocation

    # oppcl's peer is the first of tied nearest peers; the card's argmin
    # must pick it as the CPU's does
    ties = torch.full((3, 4099), 0.25, device="cuda")
    ties[:, :5] = float("inf")
    ties[1, 4000:] = 0.125
    picked = torch.argmin(ties, dim=1).tolist()
    print(f"argmin over ties on the card: {picked} (must be [5, 4000, 5])")
    if picked != [5, 4000, 5]:
        raise AssertionError("torch.argmin does not take the first of tied "
                             "minima on the card")

    co = walk_colocation(SEED, N_MULES, N_STEPS, p_cross=P_CROSS)
    n_fixed = 4 * (int(co["area"].max()) + 1)           # 4 spaces per area
    Xtr, Ytr, Xte, Yte = image_data_mobile(
        SEED, N_MULES, n_fixed, co["init_space"], co["init_area"],
        n_super=CONFIG.n_classes, image_size=CONFIG.image_size)
    init_fn, train_fn, eval_fn = cnn_model_fns(CONFIG, LR)
    pcfg = PopulationConfig(mode="mobile", n_fixed=n_fixed, n_mules=N_MULES)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    pop0 = init_population(pcfg, init_fn, gen)
    batch_fn = batch_sampler(Xtr, Ytr, BATCH)
    met = _encounters_per_mule(co)
    print(f"peer path: random walk P_cross={P_CROSS}, M={N_MULES}, "
          f"F={n_fixed}, T={N_STEPS}; {met:.3f} peers met per mule at the "
          f"exchange steps (radius {RADIUS})")
    if not met > 0:
        raise AssertionError("no mule meets a peer: the encounter path is "
                             "not exercised")

    def eval_hook(st, last):
        return torch.func.vmap(eval_fn)(st["mule_models"], Xte[last],
                                        Yte[last])

    def run(method, cfg, colocation, state=pop0, key=SEED, evals=True):
        return run_population(state, colocation, batch_fn, train_fn, cfg,
                              key, eval_every=EVAL_EVERY if evals else None,
                              eval_fn=eval_hook if evals else None,
                              method=method)

    def steps(lo, hi):
        """Steps [lo, hi) of the walk; ``area`` is per mule, not per step."""
        return {**{k: co[k][lo:hi] for k in ("fixed_id", "exchange", "pos")},
                "area": co["area"]}

    n_exchanges = N_STEPS // PEER_EVERY
    launches = {}
    for method in PEER_METHODS:
        run(method, pcfg, steps(0, PEER_EVERY), evals=False)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        encounter_mix.launches = 0
        mule_agg.launches = 0
        t0 = time.perf_counter()
        final, aux = run(method, pcfg, co)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"encounter_mix": encounter_mix.launches,
               "mule_agg": mule_agg.launches}
        peak = torch.cuda.max_memory_allocated()
        want = {"encounter_mix": 0 if method == "oppcl" else n_exchanges,
                "mule_agg": N_STEPS if method == "mlmule+gossip" else 0}
        if got != want:
            raise AssertionError(f"{method}: kernel launches {got}, expected "
                                 f"{want}")
        evals = aux["evals"]
        if evals is None or tuple(evals.shape) != (N_STEPS // EVAL_EVERY,
                                                   N_MULES):
            raise AssertionError(f"{method}: evals of shape "
                                 f"{None if evals is None else evals.shape}")
        if not bool(torch.isfinite(evals).all()):
            raise AssertionError(f"{method}: non-finite eval")
        for k, v in {**final["mule_models"], **final["fixed_models"]}.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{method}: non-finite weights in {k}")
        moved = sum(int((final["mule_models"][k] != pop0["mule_models"][k])
                        .reshape(N_MULES, -1).any(1).sum())
                    for k in final["mule_models"])
        if moved == 0:
            raise AssertionError(f"{method}: no mule model changed")
        trace = [(int(s), float(a)) for s, a in
                 zip(aux["eval_steps"], evals.mean(1).tolist())]
        print(f"peer path: {method} mobile on random_walk, T={N_STEPS}: "
              f"{N_STEPS / wall:.3f} steps/s ({wall:.3f} s), peak memory "
              f"{peak} B, launches {got}, {met:.3f} peers met per mule at "
              f"the exchange steps, accuracy trace {trace} [{card}]")
        if method == "gossip":
            launches["encounter_mix"] = got["encounter_mix"]

    # gossip against itself and against its plain version (enc_backend="ref"),
    # and its mix at every exchange in lockstep
    run_kw = dict(state=pop0, colocation=co, batches=batch_fn,
                  train_fn=train_fn, cfg=pcfg, key=SEED,
                  eval_every=EVAL_EVERY, eval_fn=eval_hook, method="gossip")
    _replays("peer path gossip", run_kw, "enc_backend", PEER_REPLAY_ATOL)
    _mix_lockstep("peer path gossip", run_kw, N_STEPS)
    _profile_steps(lambda: run("gossip", pcfg, steps(0, PEER_PROFILE_STEPS),
                               evals=False),
                   PEER_PROFILE_STEPS, "gossip")
    return launches


def _init_lm(arch: str, n_layers: Optional[int] = None):
    """(cfg, model, params, generator, parameter count): ``arch`` at full
    width (its depth cut to ``n_layers`` if given), random f32 weights from
    the seed, on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.interop import tree_leaves
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"lm serve: {cfg.name} at full width, {cfg.n_layers} layers in "
          f"{len(model.program)} stages, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads (kv {cfg.n_kv_heads}) x "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"window {cfg.sliding_window}, ssm state {cfg.ssm_state}, "
          f"encoder {cfg.encoder_layers} layers x {cfg.encoder_seq} frames, "
          f"vision prefix {cfg.vision_tokens}: "
          f"{n_params} f32 parameters initialised in "
          f"{time.perf_counter() - t0:.2f} s")
    return cfg, model, params, gen, n_params


def _warm_prefill(prefill, params, batch, wrap: dict) -> dict:
    """One warm-up prefill with each wrapper named in ``wrap`` ({name:
    (module that calls it, call indices to keep)}) replaced by one that
    records its calls. Returns {name: [(args or None, kw) per call]}: the
    keywords of every call, the positional arguments of the kept ones."""
    calls = {name: [] for name in wrap}
    real = {name: getattr(mod, name) for name, (mod, _) in wrap.items()}

    def recorder(name, keep):
        def record(*args, **kw):
            calls[name].append((args if len(calls[name]) in keep else None,
                                kw))
            return real[name](*args, **kw)
        return record

    for name, (mod, keep) in wrap.items():
        setattr(mod, name, recorder(name, keep))
    try:
        prefill(params, batch)          # the logits are dropped
    finally:
        for name, (mod, _) in wrap.items():
            setattr(mod, name, real[name])
    return calls


def _zero_counts(expect: dict) -> None:
    """Sets every count of ``expect`` ({name: (wrapper, attribute, n)}) to
    0."""
    for fn, attr, _ in expect.values():
        setattr(fn, attr, 0)


def _counts(expect: dict) -> dict:
    """{name: the count} of every entry of ``expect``."""
    return {name: getattr(fn, attr) for name, (fn, attr, _) in expect.items()}


def _flash_counts(n: int, n_tc: int) -> dict:
    """The expect entries of flash_attention: n launches, n_tc of them on
    the tensor-core route."""
    from repro_torch.kernels.flash_attention import flash_attention
    return {"flash_attention": (flash_attention, "launches", n),
            "flash_attention tc": (flash_attention, "tc_launches", n_tc)}


def _counted_prefill(prefill, params, batch, cfg, expect: dict,
                     card: str) -> dict:
    """The prefill with every count in ``expect`` ({name: (wrapper,
    attribute, n)}) set to 0 just before and read just after; each must be
    n. Then the median wall of PREFILL_REPS prefills, tokens/s and peak
    memory. The logits cover the batch's tokens, and a vision prefix;
    tokens/s counts the positions of those logits."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(expect)
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    launches = _counts(expect)
    peak = torch.cuda.max_memory_allocated()
    want = {name: n for name, (_, _, n) in expect.items()}
    if launches != want:
        raise AssertionError(f"{cfg.name}: one prefill launched {launches}, "
                             f"expected {want}")
    b, s = batch["tokens"].shape
    s += cfg.vision_tokens
    if tuple(logits.shape) != (b, s, cfg.vocab) \
            or logits.dtype != torch.float32:
        raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                             f"{logits.dtype}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite prefill logits")
    del logits
    for _ in range(PREFILL_REPS - 1):
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del logits
    wall = statistics.median(walls)
    n_tok = b * s
    extra = "".join(f", {k} {list(v.shape)}" for k, v in batch.items()
                    if k != "tokens")
    print(f"lm serve prefill {cfg.name}: {b} x {s} positions{extra}, "
          f"bf16: {n_tok / wall:.1f} tokens/s, {wall * 1e3:.3f} ms per "
          f"prefill (median of {['%.3f' % (w * 1e3) for w in walls]} ms), "
          f"peak memory {peak} B, launches per prefill {launches} (must be "
          f"{want}) [{card}]")
    return launches


def _frames(cfg, b: int, gen):
    """Whisper's stand-in audio, as serve.py draws it: 0.1 x normal frames
    [b, encoder_seq, d_model] (None for a model without an encoder)."""
    import torch
    if cfg.family != "audio":
        return None
    return 0.1 * torch.randn((b, cfg.encoder_seq, cfg.d_model),
                             device="cuda", generator=gen)


def _serve_generate(model, params, cfg, gen, card: str) -> None:
    """Decode through the serving loop at its defaults (Whisper's frames
    encoded into the cache first)."""
    import torch
    from repro_torch.launch import serve
    prompt = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                           device="cuda", generator=gen)
    audio = _frames(cfg, SERVE_BATCH, gen)
    serve.generate(model, params, prompt[:, :2], 2,
                   audio_embed=audio)                          # warm-up
    out = serve.generate(model, params, prompt, SERVE_GEN, audio_embed=audio)
    toks = out["tokens"]
    if tuple(toks.shape) != (SERVE_BATCH, SERVE_GEN) or not out["finite"] \
            or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
        raise AssertionError(f"decode: tokens {tuple(toks.shape)}, every "
                             f"logit finite: {out['finite']}")
    enc = (f"{cfg.encoder_seq} frames encoded into the cross-attention "
           f"cache in {out['encode_s']:.3f} s, " if audio is not None else "")
    print(f"lm serve decode {cfg.name}: batch {SERVE_BATCH}, {enc}prompt "
          f"{SERVE_PROMPT} replayed in {out['prefill_s']:.3f} s, {SERVE_GEN} "
          f"tokens in {out['decode_s']:.3f} s: "
          f"{SERVE_BATCH * SERVE_GEN / out['decode_s']:.2f} tokens/s "
          f"({out['decode_s'] / SERVE_GEN * 1e3:.3f} ms per step), every "
          f"logit finite, tokens of row 0 {toks[0, :8].tolist()} [{card}]")
    _profile_steps(lambda: serve.generate(model, params, prompt[:, :2], 2,
                                          audio_embed=audio), 4,
                   f"{cfg.name} decode")


def _f32_checks(cfg, params, batch, gen, ref_tol: float, expect: dict,
                oracle=None) -> None:
    """The f32 copy of the model: the whole prefill through the kernels
    (each count in ``expect`` must reach its n) against the same prefill
    through the plain versions (backend="ref"); with an ``oracle`` ((cfg,
    params, batch) -> logits of a more exact model), the kernels' logits no
    farther from the oracle's than twice the plain versions'; then decode
    against forward."""
    import torch
    from repro_torch.models import build_model
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    _zero_counts(expect)
    with torch.no_grad():
        got, _ = model32.forward(params, batch)
        launches = _counts(expect)
        want, _ = build_model(cfg32, backend="ref").forward(params, batch)
        err = (got - want).abs().max().item()
    print(f"lm serve {cfg.name} f32 prefill "
          f"{' x '.join(map(str, got.shape[:2]))}, through the kernels ({launches}) vs backend='ref' over every "
          f"logit: max diff {err:.3e} (tol {ref_tol}; logits up to "
          f"{want.abs().max().item():.3f})")
    if launches != {name: n for name, (_, _, n) in expect.items()}:
        raise AssertionError(f"the f32 prefill launched {launches}")
    if not err <= ref_tol:
        raise AssertionError("the f32 prefill through the kernels and "
                             "through the plain versions disagree")
    if oracle is not None:
        exact = oracle(cfg32, params, batch)
        to_exact = [(t - exact).abs().max().item() for t in (got, want)]
        print(f"lm serve {cfg.name} f32 prefill, distance from the more "
              f"exact model's logits: through the kernels {to_exact[0]:.3e}, "
              f"backend='ref' {to_exact[1]:.3e} (the kernels' must be at "
              f"most twice the plain versions')")
        if not to_exact[0] <= 2 * to_exact[1]:
            raise AssertionError("the f32 prefill through the kernels is "
                                 "farther from the oracle than twice the "
                                 "plain versions")
        del exact
    del got, want
    _decode_consistency(cfg, model32, params, gen)


def _decode_consistency(cfg, model32, params, gen) -> None:
    """The f32 model's ``forward`` logits on DECODE_B x DECODE_S tokens
    against its ``decode_step`` replay, within DECODE_TOL. Whisper's cross
    K/V come from frames through ``prefill_cross_kv``; a vision-language
    model is held through its text-only copy (no prefix, plain RoPE), as
    the reference's test holds it (tests/test_decode_consistency.py)."""
    import torch
    from repro_torch.models import build_model
    if cfg.family == "vlm":
        model32 = build_model(dataclasses.replace(
            model32.cfg, vision_tokens=0, family="dense",
            mrope_sections=None))
    toks = torch.randint(0, cfg.vocab, (DECODE_B, DECODE_S), device="cuda",
                         generator=gen)
    audio = _frames(cfg, DECODE_B, gen)
    batch = {"tokens": toks} if audio is None else {"tokens": toks,
                                                    "audio_embed": audio}
    with torch.no_grad():
        full, _ = model32.forward(params, batch)
        cache = model32.init_cache(DECODE_B, DECODE_S, dtype=torch.float32,
                                   device="cuda")
        if audio is not None:
            cache = model32.prefill_cross_kv(params, audio, cache)
        errs = []
        for t in range(DECODE_S):
            lg, cache = model32.decode_step(params, cache, toks[:, t:t + 1], t)
            errs.append((lg - full[:, t]).abs().max())
    worst = torch.stack(errs).max().item()
    print(f"lm serve {cfg.name} decode consistency, f32, B={DECODE_B} "
          f"S={DECODE_S}: max |decode_step - forward| over every logit "
          f"{worst:.3e} (tol {DECODE_TOL}; logits up to "
          f"{full.abs().max().item():.3f})")
    if not worst <= DECODE_TOL:
        raise AssertionError("decode_step and forward disagree at full width")


def phase_lm_serve(card: str) -> dict:
    """gemma3-4b at full width through the port's serving entry points."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     mha_reference)
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import attention as attn_lib

    cfg, model, params, gen, _ = _init_lm(LM_ARCH)
    # (a) prefill. The warm-up forward also keeps the q, k, v that the
    # first local and the first global layer hand to the kernel.
    windows = [st.window for st in model.program for _ in range(st.count)]
    picked = (windows.index(cfg.sliding_window), windows.index(None))
    prefill = make_prefill_step(model)
    batch = {"tokens": torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                                     device="cuda", generator=gen)}
    calls = _warm_prefill(prefill, params, batch, {
        "flash_attention": (attn_lib, picked)})["flash_attention"]
    if [kw["window"] for _, kw in calls] != windows:
        raise AssertionError(f"the prefill's attention windows are not the "
                             f"program's {windows}")
    # every layer's attention on the tensor-core route
    launches = _counted_prefill(prefill, params, batch, cfg,
                                _flash_counts(cfg.n_layers, cfg.n_layers),
                                card)
    for li in sorted(picked):
        (q, k, v), kw = calls[li]
        out = _flash_routed(q, k, v, **kw)
        label = (f"lm serve lockstep, layer {li} (window {kw['window']}) of "
                 f"the prefill, kernel on its bf16 q/k/v")
        _hold(label + " vs plain", out,
              flash_attention(q, k, v, **{**kw, "backend": "ref"}),
              *FLASH_BF16_VS_BF16)
        _hold(label + " vs fp32 mha_reference", out,
              mha_reference(q.float(), k.float(), v.float(),
                            causal=kw["causal"], window=kw["window"]),
              *FLASH_BF16_VS_F32)
    del calls, q, k, v, out
    _profile_steps(lambda: prefill(params, batch), 1, "gemma3-4b prefill",
                   FLASH_PROFILE)
    # (b) decode through the serving loop; (c) the f32 copy, all 34 layers,
    # whose attention takes the SIMT kernel
    _serve_generate(model, params, cfg, gen, card)
    _f32_checks(cfg, params, batch, gen, REF_PREFILL_TOL,
                _flash_counts(cfg.n_layers, 0))
    return launches


def phase_hybrid_serve(card: str) -> dict:
    """zamba2-2.7b at full width through the port's serving entry points:
    its prefill runs ssd_scan in each of the 45 Mamba2 layers and
    flash_attention (head_dim 80) in each of the 9 applications of the
    shared attention block."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     mha_reference)
    from repro_torch.kernels.ssm_scan import ssd_chunked_reference, ssd_scan
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import mamba2 as mamba_lib

    cfg, model, params, gen, n_params = _init_lm(HYBRID_ARCH)
    if n_params != HYBRID_PARAMS:
        raise AssertionError(f"{cfg.name} has {n_params} parameters, the "
                             f"reference's {HYBRID_PARAMS}")
    kinds = [st.kind for st in model.program for _ in range(st.count)]
    if (kinds.count("mamba"), kinds.count("shared_attn")) != \
            (HYBRID_SCANS, HYBRID_ATTNS):
        raise AssertionError(f"{cfg.name}'s program {model.program}")
    prefill = make_prefill_step(model)
    batch = {"tokens": torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                                     device="cuda", generator=gen)}
    # (a) the warm-up prefill also keeps the scan inputs of the first and
    # the last Mamba2 layer and the first shared attention's q, k, v
    calls = _warm_prefill(prefill, params, batch, {
        "ssd_scan_op": (mamba_lib, (0, HYBRID_SCANS - 1)),
        "flash_attention": (attn_lib, (0,))})
    scans, attns = calls["ssd_scan_op"], calls["flash_attention"]
    if (len(scans), len(attns)) != (HYBRID_SCANS, HYBRID_ATTNS):
        raise AssertionError(f"the prefill made {len(scans)} scans and "
                             f"{len(attns)} attention calls")
    expect = {"ssd_scan": (ssd_scan, "launches", HYBRID_SCANS),
              **_flash_counts(HYBRID_ATTNS, HYBRID_ATTNS)}
    launches = _counted_prefill(prefill, params, batch, cfg, expect, card)
    for li in (0, HYBRID_SCANS - 1):
        # ssd_scan_op(x, dt, A, B, C, chunk, backend)
        args, _ = scans[li]
        chunk = args[5]
        y, _ = ssd_scan(*args[:5], chunk=chunk)
        _hold_scaled(f"lm serve lockstep, Mamba2 layer {li} of the "
                     f"{cfg.name} prefill, ssd_scan on its x "
                     f"{list(args[0].shape)} vs ssd_chunked_reference", y,
                     ssd_chunked_reference(*args[:5], chunk=chunk)[0],
                     SSD_VS_CHUNKED_REL)
    (q, k, v), kw = attns[0]
    out = _flash_routed(q, k, v, **kw)
    label = (f"lm serve lockstep, shared attention 0 of the {cfg.name} "
             f"prefill, kernel on its bf16 q/k/v {list(q.shape)}")
    _hold(label + " vs plain", out,
          flash_attention(q, k, v, **{**kw, "backend": "ref"}),
          *FLASH_BF16_VS_BF16)
    _hold(label + " vs fp32 mha_reference", out,
          mha_reference(q.float(), k.float(), v.float(), causal=kw["causal"],
                        window=kw["window"]), *FLASH_BF16_VS_F32)
    del calls, scans, attns, args, y, q, k, v, out
    _profile_steps(lambda: prefill(params, batch), 1, f"{cfg.name} prefill",
                   FLASH_PROFILE)
    # (b) decode through the serving loop; (c) the f32 copy, all 54 layers,
    # whose attention takes the SIMT kernel
    _serve_generate(model, params, cfg, gen, card)
    _f32_checks(cfg, params, batch, gen, HYBRID_REF_PREFILL_TOL,
                {**expect, **_flash_counts(HYBRID_ATTNS, 0)})
    return launches


def phase_xlstm_serve(card: str) -> dict:
    """xlstm-350m at full width through the port's serving entry points:
    its prefill runs slstm_scan in each of the 12 sLSTM blocks."""
    import torch
    from repro_torch.kernels.slstm_fused import slstm_reference, slstm_scan
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import xlstm as xlstm_lib
    from repro_torch.models.api import Stage

    cfg, model, params, gen, n_params = _init_lm(XLSTM_ARCH)
    if n_params != XLSTM_PARAMS:
        raise AssertionError(f"{cfg.name} has {n_params} parameters, the "
                             f"reference's {XLSTM_PARAMS}")
    if model.program != [Stage("xlstm_pair", XLSTM_PAIRS)]:
        raise AssertionError(f"{cfg.name}'s program {model.program}")
    prefill = make_prefill_step(model)
    batch = {"tokens": torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                                     device="cuda", generator=gen)}
    # (a) the warm-up prefill also keeps the scan inputs of the first and
    # the last sLSTM block
    scans = _warm_prefill(prefill, params, batch, {
        "slstm_scan_op": (xlstm_lib, (0, XLSTM_PAIRS - 1))})["slstm_scan_op"]
    if len(scans) != XLSTM_PAIRS:
        raise AssertionError(f"the prefill made {len(scans)} sLSTM scans")
    expect = {"slstm_scan": (slstm_scan, "launches", XLSTM_PAIRS)}
    launches = _counted_prefill(prefill, params, batch, cfg, expect, card)
    for li in (0, XLSTM_PAIRS - 1):
        # slstm_scan_op(pre, r, backend)
        (pre, r, _), _ = scans[li]
        _hold(f"lm serve lockstep, sLSTM block {li} of the {cfg.name} "
              f"prefill, slstm_scan on its pre {list(pre.shape)} vs "
              f"slstm_reference", slstm_scan(pre, r),
              slstm_reference(pre, r)[0], SLSTM_TOL, 0.0)
    del scans, pre, r
    _profile_steps(lambda: prefill(params, batch), 1, f"{cfg.name} prefill")
    # (b) decode through the serving loop; (c) the f32 copy, all 24 blocks
    _serve_generate(model, params, cfg, gen, card)
    _f32_checks(cfg, params, batch, gen, XLSTM_REF_PREFILL_TOL, expect,
                oracle=_f64_slstm_logits)
    _xlstm_short_prefill(cfg, params, batch)
    return launches


def _xlstm_short_prefill(cfg, params, batch) -> None:
    """The f32 prefill through the kernel against backend="ref" on the
    first XLSTM_SHORT_S tokens of the batch, each within
    XLSTM_SHORT_PREFILL_TOL; prints both runs' distance from the copy
    whose sLSTM runs in f64 (the readings the bound was set from)."""
    import torch
    from repro_torch.kernels.slstm_fused import slstm_scan
    from repro_torch.models import build_model
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    for s in XLSTM_SHORT_S:
        short = {"tokens": batch["tokens"][:, :s].contiguous()}
        slstm_scan.launches = 0
        with torch.no_grad():
            got, _ = build_model(cfg32).forward(params, short)
            launches = slstm_scan.launches
            want, _ = build_model(cfg32, backend="ref").forward(params,
                                                                short)
        exact = _f64_slstm_logits(cfg32, params, short)
        err = (got - want).abs().max().item()
        print(f"lm serve {cfg.name} f32 prefill {PREFILL_B} x {s}, through "
              f"the kernel ({launches} slstm_scan launches) vs "
              f"backend='ref' over every logit: max diff {err:.3e} (tol "
              f"{XLSTM_SHORT_PREFILL_TOL}; logits up to "
              f"{want.abs().max().item():.3f}); from the f64-sLSTM copy: "
              f"kernel {(got - exact).abs().max().item():.3e}, "
              f"backend='ref' {(want - exact).abs().max().item():.3e}")
        if launches != XLSTM_PAIRS:
            raise AssertionError(f"the f32 prefill of {s} tokens launched "
                                 f"{launches}")
        if not err <= XLSTM_SHORT_PREFILL_TOL:
            raise AssertionError(f"the f32 prefill of {s} tokens through "
                                 f"the kernel and through the plain version "
                                 f"disagree")
        del got, want, exact


def _f64_slstm_logits(cfg32, params, batch):
    """Logits of the f32 model whose sLSTM recurrences run in float64 (the
    plain version on float64 inputs, rounded to f32 once)."""
    import torch
    from repro_torch.kernels.slstm_fused import slstm_reference
    from repro_torch.models import build_model
    from repro_torch.models import xlstm as xlstm_lib

    def exact_scan(pre, r, backend="auto"):
        return slstm_reference(pre.double(), r.double())[0].float()

    real = xlstm_lib.slstm_scan_op
    xlstm_lib.slstm_scan_op = exact_scan
    try:
        with torch.no_grad():
            return build_model(cfg32, backend="ref").forward(params, batch)[0]
    finally:
        xlstm_lib.slstm_scan_op = real


def ring_rank(out_dir: str) -> None:
    """One rank of phase 9, run as ``chip_smoke.py --ring-rank DIR`` by
    ``spawn_local_cluster``: this rank's block of the bucket-ordered walk,
    ``gossip`` and then ``oppcl`` through the ring, counted and timed; then
    the checks' material, which rank 0 gathers and measures against the
    single-host path and writes to DIR/ring.json."""
    import torch
    import torch.distributed as dist
    from repro_torch.baselines import gossip as gossip_lib
    from repro_torch.baselines import oppcl as oppcl_lib
    from repro_torch.baselines.gossip import (RING_COUNTS, RingSpec,
                                              flatten_population)
    from repro_torch.configs.mule_cnn import CONFIG
    from repro_torch.core.distributed import reorder_mule_state
    from repro_torch.core.population import PopulationConfig, init_population
    from repro_torch.core.seeds import fold_in, split
    from repro_torch.experiment import (batch_sampler, cnn_model_fns,
                                        image_data_mobile)
    from repro_torch.kernels.encounter_mix import (encounter_block_hop,
                                                   encounter_mix)
    from repro_torch.launch.multiprocess import initialize_from_env
    from repro_torch.scenarios import run_population

    if not initialize_from_env():
        raise RuntimeError("--ring-rank needs the REPRO_MP_* environment of "
                           "spawn_local_cluster")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, i = dist.get_world_size(), dist.get_rank()
    ring = RingSpec(n)
    co, order = _ring_walk()
    n_fixed = 4 * (int(co["area"].max()) + 1)           # 4 spaces per area
    Xtr, Ytr, _, _ = image_data_mobile(
        SEED, N_MULES, n_fixed, co["init_space"], co["init_area"],
        n_super=CONFIG.n_classes, image_size=CONFIG.image_size)
    init_fn, train_fn, _ = cnn_model_fns(CONFIG, LR)
    pcfg = PopulationConfig(mode="mobile", n_fixed=n_fixed, n_mules=N_MULES)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    pop0 = reorder_mule_state(init_population(pcfg, init_fn, gen), order)
    batch_fn = batch_sampler(Xtr, Ytr, BATCH)
    m_loc = N_MULES // n
    sl = slice(i * m_loc, (i + 1) * m_loc)
    pos = torch.as_tensor(co["pos"], device="cuda")              # [T, M, 2]
    area = torch.as_tensor(co["area"], dtype=torch.int64, device="cuda")
    steps = {"gossip": gossip_lib.gossip_step, "oppcl": oppcl_lib.oppcl_step}

    def run(method, n_steps):
        """The single-host engine's walk (run_population with callable
        batches), on this rank's rows: the same batches and keys."""
        models = {k: v[sl].clone() for k, v in pop0["mule_models"].items()}
        for t in range(n_steps):
            k_t = fold_in(SEED, t)
            xb, yb = batch_fn(fold_in(k_t, 0), t)["mule"]
            if t % PEER_EVERY != PEER_EVERY - 1:
                continue
            ks = fold_in(k_t, 1)
            models = steps[method](models, pos[t, sl], area[sl],
                                   (xb[sl], yb[sl]), train_fn, ks,
                                   radius=RADIUS, ring=ring,
                                   keys=split(ks, N_MULES, "cuda")[sl])
        return models

    # record what each exchange computed, for the checks after the timing
    recorded = {"gossip": [], "oppcl": []}
    real = (gossip_lib.ring_encounter_mix, oppcl_lib._ring_nearest_peer)

    def rec_mix(*args, **kw):
        out = real[0](*args, **kw)
        recorded["gossip"].append((args[3], *out))       # flat, mix, mass
        return out

    def rec_peer(*args, **kw):
        out = real[1](*args, **kw)
        recorded["oppcl"].append(out[1:])                # met, peer
        return out

    mine, finals = {}, {}
    for method in ("gossip", "oppcl"):
        run(method, PEER_EVERY)                          # warm-up: 1 exchange
        torch.cuda.synchronize()
        dist.barrier()
        encounter_block_hop.launches = 0
        encounter_mix.launches = 0
        before = dict(RING_COUNTS)
        gossip_lib.ring_encounter_mix, oppcl_lib._ring_nearest_peer = \
            rec_mix, rec_peer
        try:
            t0 = time.perf_counter()
            finals[method] = run(method, RING_STEPS)
            torch.cuda.synchronize()
            dist.barrier()
            wall = time.perf_counter() - t0
        finally:
            gossip_lib.ring_encounter_mix, oppcl_lib._ring_nearest_peer = \
                real
        mine[method] = {"wall_s": wall,
                        "encounter_hop": encounter_block_hop.launches,
                        "encounter_mix": encounter_mix.launches,
                        **{k: RING_COUNTS[k] - before[k] for k in before}}

    def gather(t):
        """This rank's block to rank 0 (through host memory); the
        population there, None elsewhere."""
        t = t.detach().cpu().contiguous()
        parts = [torch.empty_like(t) for _ in range(n)] if i == 0 else None
        dist.gather(t, parts, dst=0)
        return torch.cat(parts).cuda() if i == 0 else None

    ranks = [None] * n if i == 0 else None
    dist.gather_object(mine, ranks, dst=0)
    exchanges = [t for t in range(RING_STEPS) if t % PEER_EVERY
                 == PEER_EVERY - 1]
    report = {"ranks": ranks, "gossip": [], "oppcl": [], "final_diff": {}}
    for t, (flat, mix, mass) in zip(exchanges, recorded.pop("gossip")):
        full, ring_mix, ring_mass = gather(flat), gather(mix), gather(mass)
        del flat, mix, mass
        if i == 0:
            want, want_mass = encounter_mix(pos[t], area, None, full,
                                            radius=RADIUS)
            report["gossip"].append({
                "t": t, "masses_equal": bool(torch.equal(ring_mass,
                                                         want_mass)),
                "mix_err": (ring_mix - want).abs().max().item(),
                "encounters": int(want_mass.sum().item())})
            del want, full, ring_mix
    for t, (met, peer) in zip(exchanges, recorded.pop("oppcl")):
        met, peer = gather(met), gather(peer)
        if i == 0:
            report["oppcl"].append({"t": t, "met": met.tolist(),
                                    "peer": peer.tolist()})
    for method in ("gossip", "oppcl"):
        flat = gather(flatten_population(finals.pop(method))[0])
        if i == 0:
            single, _ = run_population(pop0, co, batch_fn, train_fn, pcfg,
                                       SEED, method=method)
            want = flatten_population(single["mule_models"])[0]
            report["final_diff"][method] = (flat - want).abs().max().item()
            report["finite_" + method] = bool(torch.isfinite(flat).all())
            del single, want
        del flat
    if i == 0:
        (Path(out_dir) / "ring.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()


def phase_ring_path(card: str) -> dict:
    """gossip and oppcl through the ring of RING_RANKS ranks on the one
    card (``spawn_local_cluster``, gloo), each rank holding its block of the
    bucket-ordered walk; holds what the ranks report to the single-host
    path and returns {"encounter_hop": launches of all ranks}."""
    import gc
    import tempfile
    import torch
    from repro_torch.baselines.gossip import ring_hop_mask
    from repro_torch.baselines.oppcl import _block_d2
    from repro_torch.kernels.encounter_mix.ref import radius_sq
    from repro_torch.launch.multiprocess import spawn_local_cluster
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    co, _ = _ring_walk()
    mask = ring_hop_mask(co["area"], None, RING_RANKS)
    kept = int(mask.sum())
    n_exch = RING_STEPS // PEER_EVERY
    with tempfile.TemporaryDirectory() as out_dir:
        outs = spawn_local_cluster(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--ring-rank",
             out_dir], RING_RANKS, timeout=RING_TIMEOUT)
        report = json.loads((Path(out_dir) / "ring.json").read_text())
    for line in outs[0].stdout.splitlines():
        print(f"  rank 0: {line}")
    ranks = report["ranks"]
    want = {"gossip": {"encounter_hop": n_exch * kept, "encounter_mix": 0},
            "oppcl": {"encounter_hop": 0, "encounter_mix": 0}}
    for method, exp in want.items():
        got = [{k: r[method][k] for k in exp} for r in ranks]
        if got != [exp] * RING_RANKS:
            raise AssertionError(f"ring {method}: launches by rank {got}, "
                                 f"expected {exp} on each")
        if not report["finite_" + method]:
            raise AssertionError(f"ring {method}: non-finite weights")
    # gossip: each exchange's ring mix against encounter_mix of the same
    # state (gathered and measured on rank 0)
    worst = max(x["mix_err"] for x in report["gossip"])
    if len(report["gossip"]) != n_exch or not all(
            x["masses_equal"] for x in report["gossip"]) \
            or not worst <= RING_MIX_TOL:
        raise AssertionError(f"ring gossip: the ring mix disagrees with "
                             f"encounter_mix: {report['gossip']}")
    # oppcl: every exchange's peers against the single-host argmin
    area = torch.as_tensor(co["area"], dtype=torch.int64, device="cuda")
    r2 = radius_sq(RADIUS).cuda()
    n_met = 0
    for x in report["oppcl"]:
        pos = torch.as_tensor(co["pos"][x["t"]], device="cuda")
        d2 = _block_d2(pos, area, None, 0, pos, area, None, 0)
        d2 = torch.where(d2 <= r2, d2, torch.inf)
        met = torch.isfinite(d2.min(dim=1).values)
        peer = torch.argmin(d2, dim=1)
        got_met = torch.tensor(x["met"], device="cuda") > 0
        got_peer = torch.tensor(x["peer"], device="cuda")
        if not (torch.equal(got_met, met)
                and torch.equal(got_peer[met], peer[met])):
            raise AssertionError(f"ring oppcl: peers at step {x['t']} differ "
                                 f"from the single-host argmin")
        n_met += int(met.sum())
    if len(report["oppcl"]) != n_exch or n_met == 0:
        raise AssertionError("ring oppcl: no exchange met a peer")
    for method, diff in report["final_diff"].items():
        print(f"ring {method}: final weights vs the single-host run: max "
              f"diff {diff:.3e} (tol {PEER_REPLAY_ATOL})")
        if not diff <= PEER_REPLAY_ATOL:
            raise AssertionError(f"ring {method}: final weights disagree "
                                 f"with the single-host run")
    total = sum(r["gossip"]["encounter_hop"] for r in ranks)
    for method in ("gossip", "oppcl"):
        wall = max(r[method]["wall_s"] for r in ranks)
        sent = sum(r[method]["sent_bytes"] for r in ranks)
        pruned = sum(r[method]["pruned"] for r in ranks)
        print(f"ring path: {method} on the bucket-ordered random walk, "
              f"{RING_RANKS} ranks x {N_MULES // RING_RANKS} mules, "
              f"T={RING_STEPS} ({n_exch} exchanges): "
              f"{RING_STEPS / wall:.3f} steps/s ({wall:.3f} s), hop mask "
              f"{mask.tolist()}, encounter_hop launches "
              f"{[r[method]['encounter_hop'] for r in ranks]} by rank, "
              f"{sent} B sent ({sent // n_exch} B per exchange), "
              f"{pruned} hops pruned ({pruned // n_exch} per exchange) "
              f"[{card}]")
    print(f"ring path: gossip's mix vs encounter_mix over {n_exch} "
          f"exchanges: masses equal, max diff {worst:.3e} (tol "
          f"{RING_MIX_TOL}); oppcl's peers equal the single-host argmin at "
          f"every exchange ({n_met} met rows); phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"encounter_hop": total}


def _steps(co: dict, lo: int, hi: int) -> dict:
    """Steps [lo, hi) of a colocation as a schedule of their own (an
    ``area`` per mule stays whole)."""
    part = {k: co[k][lo:hi] for k in ("fixed_id", "exchange", "pos",
                                      "active") if k in co}
    area = co.get("area")
    if area is not None:
        part["area"] = area[lo:hi] if area.ndim == 2 else area
    return part


def _replays(label: str, run: dict, field: str, atol: float) -> None:
    """``run`` (``run_population``'s keyword arguments) replayed with
    cuDNN's deterministic algorithms: twice through the kernels, which
    must agree bitwise, and once with ``cfg.<field> = "ref"``, within the
    growth bound ``atol``."""
    import torch
    from repro_torch.scenarios import run_population
    sides = ("mule_models", "fixed_models")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        det_a, _ = run_population(**run)
        det_b, _ = run_population(**run)
        det_ref, _ = run_population(**{**run, "cfg": dataclasses.replace(
            run["cfg"], **{field: "ref"})})
    finally:
        torch.backends.cudnn.deterministic = False
    same = _max_diff(det_a, det_b, sides)
    diff = _max_diff(det_a, det_ref, sides)
    print(f"{label}: deterministic replay, kernel twice: max |final weight "
          f"diff| = {same:.3e} (must be 0); replay with {field}='ref': "
          f"{diff:.3e} (tol {atol}); the run moved "
          f"{_max_diff(det_a, run['state'], sides):.3e} from its start")
    if same != 0.0:
        raise AssertionError(f"{label}: the path is not deterministic")
    if not diff <= atol:
        raise AssertionError(f"{label}: the kernel run and the plain run "
                             f"disagree")


def _aggregation_lockstep(label: str, run: dict, n_steps: int) -> None:
    """Each step from the state the run holds there, with training switched
    off (so only the exchange and the aggregation act), through the
    ``mule_agg`` kernel and through ``agg_backend="ref"``: every part of
    the state must agree to fp32 order. The run advances through the
    kernel with training on."""
    from repro_torch.scenarios import run_population
    ref_cfg = dataclasses.replace(run["cfg"], agg_backend="ref")
    st, worst = run["state"], 0.0

    def keep(params, batch, key):
        return params

    for t in range(n_steps):
        kw = {**run, "colocation": _steps(run["colocation"], t, t + 1),
              "key": t, "eval_every": None, "eval_fn": None}
        a, _ = run_population(**{**kw, "state": st, "train_fn": keep})
        b, _ = run_population(**{**kw, "state": st, "train_fn": keep,
                                 "cfg": ref_cfg})
        worst = max(worst, _max_diff(a, b, ("mule_models", "fixed_models",
                                            "fresh")))
        st, _ = run_population(**{**kw, "state": st})
    print(f"{label}: lockstep over {n_steps} steps, mule_agg vs "
          f"agg_backend='ref' from the same state, training off: max diff "
          f"{worst:.3e} (tol {LOCKSTEP_ATOL})")
    if not worst <= LOCKSTEP_ATOL:
        raise AssertionError(f"{label}: mule_agg and the plain aggregation "
                             f"disagree")


def _mix_lockstep(label: str, run: dict, n_steps: int) -> None:
    """At each peer exchange, ``encounter_mix`` of the state the run holds
    there against its plain version (masses equal, mix within
    LOCKSTEP_ATOL), and the pairs kernel's met pairs all within one area of
    that step (an ``area`` per step or per mule); the run advances one
    exchange period at a time through the kernel."""
    import torch
    from repro_torch.baselines.gossip import flatten_population
    from repro_torch.kernels.encounter_mix import (encounter_mix,
                                                   encounter_mix_reference,
                                                   encounter_pairs,
                                                   unpack_pairs)
    from repro_torch.scenarios import run_population
    co = run["colocation"]
    areas = torch.as_tensor(co["area"], device="cuda")
    st, worst, met_pairs, crossing = run["state"], 0.0, 0, 0
    for j in range(n_steps // PEER_EVERY):
        t = j * PEER_EVERY + PEER_EVERY - 1
        area = areas[t] if areas.dim() == 2 else areas
        flat, _ = flatten_population(st["mule_models"])
        pos = torch.as_tensor(co["pos"][t], device="cuda")
        mix_k, mass_k = encounter_mix(pos, area, None, flat, radius=RADIUS)
        mix_r, mass_r = encounter_mix_reference(pos, area, None, flat,
                                                radius=RADIUS)
        if not torch.equal(mass_k, mass_r):
            raise AssertionError(f"{label}: encounter_mix masses differ from "
                                 f"the plain version's at step {t}")
        worst = max(worst, (mix_k - mix_r).abs().max().item())
        words, _ = encounter_pairs(pos, area, None, 0, pos, area, None, 0,
                                   RADIUS)
        met = unpack_pairs(words, pos.shape[0])
        met_pairs += int(met.sum())
        crossing += int((met & (area[:, None] != area[None, :])).sum())
        st, _ = run_population(**{**run, "state": st, "key": j,
                                  "colocation": _steps(co, t + 1 - PEER_EVERY,
                                                       t + 1),
                                  "eval_every": None, "eval_fn": None})
    print(f"{label}: lockstep over {n_steps // PEER_EVERY} exchanges, "
          f"encounter_mix vs its plain version on the same state: max diff "
          f"{worst:.3e} (tol {LOCKSTEP_ATOL}), masses equal; {met_pairs} met "
          f"pairs, {crossing} across areas (must be 0)")
    if not worst <= LOCKSTEP_ATOL:
        raise AssertionError(f"{label}: encounter_mix and the plain mix "
                             f"disagree")
    if crossing:
        raise AssertionError(f"{label}: {crossing} met pairs cross an area")


def _check_result(label: str, result: dict, want_steps) -> None:
    """A run's accuracies finite and in [0, 1], its trace at
    ``want_steps``."""
    steps = [s for s, _ in result["trace"]]
    accs = [a for _, a in result["trace"]] + [result["pre_local_acc"],
                                               result["post_local_acc"]]
    if steps != list(want_steps):
        raise AssertionError(f"{label}: trace at steps {steps}, expected "
                             f"{list(want_steps)}")
    if not all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs):
        raise AssertionError(f"{label}: accuracy outside [0, 1]: {accs}")


def _trace_steps(method: str, steps: int, eval_every: int) -> list:
    """Where ``run_experiment`` logs its evals: federated round ``r``
    covers steps [10 r, 10 (r + 1)) and evaluates every
    ``max(eval_every // 10, 1)`` rounds; the engine after every
    ``eval_every`` steps."""
    from repro_torch.experiment import FEDERATED
    if method in FEDERATED:
        every = max(eval_every // 10, 1)
        return [(r + 1) * 10 - 1 for r in range(steps // 10)
                if (r + 1) % every == 0]
    return [(i + 1) * eval_every - 1 for i in range(steps // eval_every)]


def _check_finite(label: str, models: dict) -> None:
    import torch
    for k, v in models.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{label}: non-finite weights in {k}")


def _count_run(fn):
    """``fn()`` with every kernel count zeroed just before and read just
    after; returns (its value, {kernel: launches}, peak bytes)."""
    import torch
    from repro_torch.kernels.encounter_mix import encounter_mix
    from repro_torch.kernels.mule_agg import mule_agg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mule_agg.launches = 0
    encounter_mix.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {"mule_agg": mule_agg.launches,
                 "encounter_mix": encounter_mix.launches}, \
        torch.cuda.max_memory_allocated()


def _short_defaults(label: str, task: str, mode: str, methods) -> None:
    """``run_experiment`` at the harness's own reduced defaults on the card
    for each method, with a short T and an eval every 10 steps."""
    from repro_torch.experiment import ExperimentConfig, run_experiment
    for method in methods:
        cfg = ExperimentConfig(task=task, mode=mode, method=method,
                               steps=SHORT_STEPS, eval_every=10)
        t0 = time.perf_counter()
        result = run_experiment(cfg, device="cuda")
        _check_result(f"{label} {method}", result,
                      _trace_steps(method, SHORT_STEPS, 10))
        print(f"{label}: run_experiment(task={task!r}, mode={mode!r}, "
              f"method={method!r}, steps={SHORT_STEPS}) at the harness's "
              f"defaults (M={cfg.n_mules}, F={cfg.n_fixed}, "
              f"{cfg.pretrain_steps} pretraining steps): pre-local "
              f"{result['pre_local_acc']:.4f}, post-local "
              f"{result['post_local_acc']:.4f}, trace {result['trace']}, "
              f"{time.perf_counter() - t0:.2f} s")


def phase_fixed_path(card: str) -> dict:
    """Table 1's fixed-device path at the paper CNN's full width: the five
    ``METHODS_FIXED`` through ``run_with_models`` (``run_experiment``'s
    body), then ``run_experiment`` at its defaults. Returns
    {"mule_agg": launches of mlmule's run}."""
    import gc
    import numpy as np
    import torch
    from repro_torch.baselines.cfl import cfl_client_models
    from repro_torch.baselines.fedas import _split, default_shared_predicate
    from repro_torch.configs.mule_cnn import CONFIG
    from repro_torch.experiment import (FEDERATED, METHODS_FIXED,
                                        ExperimentConfig, cnn_model_fns,
                                        run_with_models)
    from repro_torch.scenarios import run_population
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    base = ExperimentConfig(
        mode="fixed", dist="dir0.01", pattern=str(P_CROSS), steps=FIXED_STEPS,
        eval_every=EVAL_EVERY, n_mules=FIXED_MULES, n_fixed=N_FIXED,
        batch=BATCH, lr=LR, pretrain_steps=FIXED_PRETRAIN,
        image_size=CONFIG.image_size, n_super=CONFIG.n_classes, seed=SEED)
    fns = cnn_model_fns(CONFIG, LR)
    counts = {}
    for method in METHODS_FIXED:
        cfg = dataclasses.replace(base, method=method)
        (result, st), got, peak = _count_run(
            lambda: run_with_models(cfg, fns, device="cuda"))
        want = {"mule_agg": FIXED_STEPS if method == "mlmule" else 0,
                "encounter_mix": 0}
        if got != want:
            raise AssertionError(f"Table 1 {method}: kernel launches {got}, "
                                 f"expected {want}")
        counts[method] = got
        _check_result(f"Table 1 {method}", result,
                      _trace_steps(method, FIXED_STEPS, EVAL_EVERY))
        _check_finite(f"Table 1 {method}", st["final_models"])
        d_params = sum(v[0].numel() for v in st["final_models"].values())
        if method in FEDERATED:
            n_rounds = FIXED_STEPS // 10
            rate = f"{n_rounds / st['run_s']:.3f} rounds/s ({n_rounds} rounds"
        else:
            rate = f"{FIXED_STEPS / st['run_s']:.3f} steps/s ({FIXED_STEPS} steps"
        print(f"Table 1 fixed path: {method}, dir0.01, walk P_cross="
              f"{P_CROSS}, F={N_FIXED}, M={FIXED_MULES}, D={d_params}: "
              f"{rate} in {st['run_s']:.3f} s), pretraining "
              f"{st['pretrain_s']:.3f} s ({FIXED_PRETRAIN} steps), peak "
              f"memory {peak} B, launches {got}, pre-local "
              f"{result['pre_local_acc']:.4f}, post-local "
              f"{result['post_local_acc']:.4f}, trace {result['trace']} "
              f"[{card}]")
        if method == "mlmule":
            _check_finite("Table 1 mlmule mules",
                          st["population"]["mule_models"])
            receipts = int(st["population"]["fresh"]["count"].sum())
            if receipts == 0:
                raise AssertionError("Table 1 mlmule: no mule delivered to a "
                                     "fixed device")
            run = st["run"]
            _replays("Table 1 mlmule", run, "agg_backend", REPLAY_ATOL)
            _aggregation_lockstep("Table 1 mlmule", run, FIXED_STEPS)
            _profile_steps(lambda: run_population(**{
                **run, "colocation": _steps(run["colocation"], 0,
                                            PROFILE_STEPS),
                "eval_every": None, "eval_fn": None}), PROFILE_STEPS,
                "Table 1 mlmule")
        if method == "fedas":
            mask = _split(st["global"], default_shared_predicate)
            personal = [k for k, m in mask.items() if not bool(m.any())]
            same = all(torch.equal(st["global"][k], st["global0"][k])
                       for k in personal)
            moved = any(not torch.equal(st["global"][k], st["global0"][k])
                        for k in mask if k not in personal)
            print(f"Table 1 fedas: personal leaves {personal} of the global "
                  f"model equal the first round's bitwise: {same}; shared "
                  f"leaves moved: {moved}")
            if not (personal and same and moved):
                raise AssertionError("Table 1 fedas: the server model's "
                                     "personal leaves changed, or nothing "
                                     "shared moved")
        if method == "cfl":
            state = st["cfl"]
            members = np.sort(np.concatenate(state.clusters))
            if not np.array_equal(members, np.arange(N_FIXED)):
                raise AssertionError(f"Table 1 cfl: clusters "
                                     f"{[c.tolist() for c in state.clusters]}"
                                     f" do not partition the clients")
            stacked = cfl_client_models(state, N_FIXED)
            for ci, idx in enumerate(state.clusters):
                for c in idx:
                    if not all(torch.equal(stacked[k][c], state.models[ci][k])
                               for k in stacked):
                        raise AssertionError(f"Table 1 cfl: client {c} "
                                             f"does not hold cluster {ci}'s "
                                             f"model")
            print(f"Table 1 cfl: clusters "
                  f"{[c.tolist() for c in state.clusters]} partition the "
                  f"{N_FIXED} clients; each client holds its cluster's "
                  f"model bitwise")
    _short_defaults("Table 1 defaults", "image", "fixed", METHODS_FIXED)
    print(f"Table 1 fixed path: phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"mule_agg": counts["mlmule"]["mule_agg"]}


def phase_har_path(card: str) -> dict:
    """Fig 8's HAR path at the LSTM-CNN's full width on ``har_commuter``:
    ``mlmule`` and ``gossip`` through ``run_with_models``, then
    ``run_experiment(task="har")`` at its defaults for the five mobile
    methods. Returns {"mule_agg": mlmule's launches, "encounter_mix":
    gossip's}."""
    import gc
    import torch
    from repro_torch.configs.mule_lstm_cnn import CONFIG
    from repro_torch.core import METHODS_MOBILE
    from repro_torch.experiment import (ExperimentConfig, lstm_cnn_model_fns,
                                        run_with_models)
    from repro_torch.scenarios import run_population
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    base = ExperimentConfig(scenario="har_commuter", steps=HAR_STEPS,
                            eval_every=EVAL_EVERY, n_mules=N_MULES,
                            batch=HAR_BATCH, lr=HAR_LR, seed=SEED)
    fns = lstm_cnn_model_fns(CONFIG, HAR_LR)
    n_exchanges = HAR_STEPS // PEER_EVERY
    counts = {}
    for method in ("mlmule", "gossip"):
        cfg = dataclasses.replace(base, method=method)
        (result, st), got, peak = _count_run(
            lambda: run_with_models(cfg, fns, device="cuda"))
        want = ({"mule_agg": HAR_STEPS, "encounter_mix": 0}
                if method == "mlmule" else
                {"mule_agg": 0, "encounter_mix": n_exchanges})
        if got != want:
            raise AssertionError(f"HAR {method}: kernel launches {got}, "
                                 f"expected {want}")
        counts[method] = got
        _check_result(f"HAR {method}", result,
                      _trace_steps(method, HAR_STEPS, EVAL_EVERY))
        pop = st["population"]
        _check_finite(f"HAR {method}", {**pop["mule_models"],
                                        **pop["fixed_models"]})
        d_params = sum(v[0].numel() for v in pop["mule_models"].values())
        print(f"HAR path: {method} mobile on har_commuter, M={N_MULES}, "
              f"F={result['config']['n_fixed']}, D={d_params} "
              f"({CONFIG.name}), batch {HAR_BATCH}, T={HAR_STEPS}: "
              f"{HAR_STEPS / st['run_s']:.3f} steps/s ({st['run_s']:.3f} s), "
              f"pretraining {st['pretrain_s']:.3f} s "
              f"({base.pretrain_steps} steps), peak memory {peak} B, "
              f"launches {got}, accuracy trace {result['trace']} [{card}]")
        run = st["run"]
        if method == "mlmule":
            if int(pop["fresh"]["count"].sum()) == 0:
                raise AssertionError("HAR mlmule: no mule delivered to a "
                                     "fixed device")
            _replays("HAR mlmule", run, "agg_backend", REPLAY_ATOL)
            _aggregation_lockstep("HAR mlmule", run, HAR_STEPS)
        else:
            _replays("HAR gossip", run, "enc_backend", PEER_REPLAY_ATOL)
            _mix_lockstep("HAR gossip", run, HAR_STEPS)
        _profile_steps(lambda: run_population(**{
            **run, "colocation": _steps(run["colocation"], 0,
                                        PROFILE_STEPS),
            "eval_every": None, "eval_fn": None}), PROFILE_STEPS,
            f"HAR {method}")
    _short_defaults("HAR defaults", "har", "mobile", METHODS_MOBILE)
    print(f"HAR path: phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"mule_agg": counts["mlmule"]["mule_agg"],
            "encounter_mix": counts["gossip"]["encounter_mix"]}


def phase_multi_area(card: str) -> dict:
    """The multi-area path: ``mlmule`` and ``gossip`` on
    ``multi_area_3city`` and ``gossip`` on ``multi_area_migratory`` (its
    area a [T, M] column) at the paper CNN's full width, F = 12, M = 256,
    T = 60, an eval every 20; launches exact, replays bitwise and against
    the plain backends, the mix in lockstep with no met pair across areas.
    Returns {path: {kernel: launches}}."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs.mule_cnn import CONFIG
    from repro_torch.core.population import PopulationConfig, init_population
    from repro_torch.experiment import (batch_sampler, cnn_model_fns,
                                        image_data_mobile)
    from repro_torch.scenarios import get_scenario, run_population
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    init_fn, train_fn, eval_fn = cnn_model_fns(CONFIG, LR)
    paths = {}
    for scenario, methods in (("multi_area_3city", ("mlmule", "gossip")),
                              ("multi_area_migratory", ("gossip",))):
        spec = get_scenario(scenario)
        co = spec.colocation(SEED, N_MULES, N_STEPS)
        if spec.n_fixed != MULTI_AREA_FIXED:
            raise AssertionError(f"{scenario}: {spec.n_fixed} fixed devices")
        area = np.asarray(co["area"])
        moved = (int((area != area[:1]).any(0).sum()) if area.ndim == 2
                 else 0)
        print(f"{scenario}: areas {sorted(np.unique(area).tolist())}, area "
              f"column {area.shape}, {moved} mules change area, "
              f"{int((co['exchange'] & (co['fixed_id'] >= 0)).sum())} "
              f"deliveries in T={N_STEPS}")
        Xtr, Ytr, Xte, Yte = image_data_mobile(
            SEED, N_MULES, spec.n_fixed, co["init_space"], co["init_area"],
            n_super=CONFIG.n_classes, image_size=CONFIG.image_size)
        pcfg = PopulationConfig(mode="mobile", n_fixed=spec.n_fixed,
                                n_mules=N_MULES)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        pop0 = init_population(pcfg, init_fn, gen)
        batch_fn = batch_sampler(Xtr, Ytr, BATCH)

        def eval_hook(st, last):
            return torch.func.vmap(eval_fn)(st["mule_models"], Xte[last],
                                            Yte[last])

        for method in methods:
            run = dict(state=pop0, colocation=co, batches=batch_fn,
                       train_fn=train_fn, cfg=pcfg, key=SEED,
                       eval_every=EVAL_EVERY, eval_fn=eval_hook,
                       method=method)
            run_population(**{**run, "colocation": _steps(co, 0, PEER_EVERY),
                              "eval_every": None, "eval_fn": None})
            t0 = time.perf_counter()
            (final, aux), got, peak = _count_run(
                lambda: run_population(**run))
            wall = time.perf_counter() - t0
            want = ({"mule_agg": N_STEPS, "encounter_mix": 0}
                    if method == "mlmule" else
                    {"mule_agg": 0, "encounter_mix": N_STEPS // PEER_EVERY})
            label = f"{scenario} {method}"
            if got != want:
                raise AssertionError(f"{label}: kernel launches {got}, "
                                     f"expected {want}")
            evals = aux["evals"]
            if evals is None or tuple(evals.shape) != (
                    N_STEPS // EVAL_EVERY, N_MULES) or \
                    not bool(torch.isfinite(evals).all()):
                raise AssertionError(f"{label}: evals missing or not finite")
            _check_finite(label, {**final["mule_models"],
                                  **final["fixed_models"]})
            if method == "mlmule" and int(final["fresh"]["count"].sum()) == 0:
                raise AssertionError(f"{label}: no mule delivered")
            trace = [(int(s), float(a)) for s, a in
                     zip(aux["eval_steps"], evals.mean(1).tolist())]
            print(f"multi-area path: {label}, F={spec.n_fixed}, "
                  f"M={N_MULES}, T={N_STEPS}: {N_STEPS / wall:.3f} steps/s "
                  f"({wall:.3f} s), peak memory {peak} B, launches {got}, "
                  f"accuracy trace {trace} [{card}]")
            paths[label] = got
            del final, aux
            if method == "mlmule":
                _replays(label, run, "agg_backend", REPLAY_ATOL)
            else:
                _replays(label, run, "enc_backend", PEER_REPLAY_ATOL)
                _mix_lockstep(label, run, N_STEPS)
        del pop0, Xtr, Xte
    print(f"multi-area path: phase wall {time.perf_counter() - t_phase:.1f} s")
    return paths


def _lane_steps(cos: dict, lo: int, hi: int) -> dict:
    """Steps [lo, hi) of a lane-stacked schedule (an area per mule stays
    whole)."""
    return {k: (v if k == "area" and v.dim() == 2 else v[:, lo:hi])
            for k, v in cos.items()}


def phase_sweep(card: str) -> dict:
    """The seed sweep: ``run_sweep`` over S = LANES seeds of the walk for
    the five ``METHODS_MOBILE`` at the paper CNN's full width, each step's
    ``mule_agg`` and ``encounter_mix`` one launch for all lanes; lanes of
    ``mlmule`` and ``gossip`` held to their sequential runs. Then
    ``run_sweep_experiment`` at Fig 8's config. Returns {path: {kernel:
    launches}}."""
    import gc
    import torch
    from repro_torch.configs.mule_cnn import CONFIG
    from repro_torch.core import METHODS_MOBILE
    from repro_torch.core.population import PopulationConfig, init_population
    from repro_torch.experiment import (ExperimentConfig, _stack_wrap_pad,
                                        cnn_model_fns, image_data_mobile,
                                        run_sweep_experiment, sample_batches)
    from repro_torch.scenarios import (run_population, run_sweep,
                                       stack_colocations, stack_trees,
                                       walk_colocation)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    init_fn, train_fn, eval_fn = cnn_model_fns(CONFIG, LR)
    seeds = [SEED + i for i in range(LANES)]
    cos = [walk_colocation(s, N_MULES, SWEEP_STEPS, p_cross=P_CROSS)
           for s in seeds]
    if max(int(co["fixed_id"].max()) for co in cos) >= N_FIXED:
        raise AssertionError("a walk visits a space past the F fixed devices")
    data = [image_data_mobile(s, N_MULES, N_FIXED, co["init_space"],
                              co["init_area"], n_super=CONFIG.n_classes,
                              image_size=CONFIG.image_size)
            for s, co in zip(seeds, cos)]
    ctx = tuple(_stack_wrap_pad([d[k] for d in data]) for k in range(4))
    del data
    pcfg = PopulationConfig(mode="mobile", n_fixed=N_FIXED, n_mules=N_MULES)
    pops = []
    for s in seeds:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(s)
        pops.append(init_population(pcfg, init_fn, gen))
    states = stack_trees(pops)
    stacked = stack_colocations(cos)
    d_params = sum(v[0].numel() for v in pops[0]["mule_models"].values())
    print(f"sweep: {LANES} seeds of the walk (P_cross={P_CROSS}) as lanes, "
          f"M={N_MULES}, F={N_FIXED}, D={d_params}: "
          f"{LANES * N_MULES} mule models, "
          f"{4 * LANES * N_MULES * d_params} B of f32 mule weights")

    def batch_fn(seed, t, c):
        return {"fixed": None, "mule": sample_batches(seed, c[0], c[1],
                                                      BATCH)}

    def eval_hook(st, last, c):
        return torch.func.vmap(eval_fn)(st["mule_models"], c[2][last],
                                        c[3][last])

    sweep = dict(states=states, colocations=stacked, batches=batch_fn,
                 train_fn=train_fn, cfg=pcfg, keys=seeds,
                 eval_every=EVAL_EVERY, eval_fn=eval_hook, context=ctx)
    run_sweep(**{**sweep, "colocations": _lane_steps(stacked, 0, PEER_EVERY),
                 "eval_every": None, "eval_fn": None},
              methods="mlmule+gossip")                     # warm-up
    n_ex = SWEEP_STEPS // PEER_EVERY
    want = {"mlmule": {"mule_agg": SWEEP_STEPS, "encounter_mix": 0},
            "mlmule+gossip": {"mule_agg": SWEEP_STEPS,
                              "encounter_mix": n_ex},
            "gossip": {"mule_agg": 0, "encounter_mix": n_ex},
            "oppcl": {"mule_agg": 0, "encounter_mix": 0},
            "local": {"mule_agg": 0, "encounter_mix": 0}}
    paths = {}
    for method in METHODS_MOBILE:
        t0 = time.perf_counter()
        (final, aux), got, peak = _count_run(
            lambda: run_sweep(**sweep, methods=method))
        wall = time.perf_counter() - t0
        label = f"sweep S={LANES} {method}"
        if got != want[method]:
            raise AssertionError(f"{label}: kernel launches {got}, expected "
                                 f"{want[method]}: one launch a step for "
                                 f"all lanes")
        evals = aux["evals"]
        n_ev = SWEEP_STEPS // EVAL_EVERY
        if tuple(evals.shape) != (LANES, n_ev, N_MULES) \
                or not bool(torch.isfinite(evals).all()):
            raise AssertionError(f"{label}: evals {tuple(evals.shape)} "
                                 f"missing or not finite")
        _check_finite(label, {**final["mule_models"],
                              **final["fixed_models"]})
        paths[label] = got
        print(f"{label}: {SWEEP_STEPS / wall:.3f} steps/s, "
              f"{LANES * SWEEP_STEPS / wall:.3f} lane-steps/s "
              f"({wall:.3f} s), "
              f"peak memory {peak} B, launches {got}, mean accuracy by lane "
              f"{[round(x, 4) for x in evals.mean((1, 2)).tolist()]} "
              f"[{card}]")
        if method in ("mlmule", "gossip"):
            seq_wall, worst = 0.0, 0.0
            for i in range(LANES):
                lane_ctx = tuple(c[i] for c in ctx)
                t0 = time.perf_counter()
                one, one_aux = run_population(
                    pops[i], cos[i], batch_fn, train_fn, pcfg, seeds[i],
                    eval_every=EVAL_EVERY, eval_fn=eval_hook, method=method,
                    context=lane_ctx)
                torch.cuda.synchronize()
                seq_wall += time.perf_counter() - t0
                lane = {side: {k: v[i] for k, v in final[side].items()}
                        for side in ("mule_models", "fixed_models")}
                worst = max(worst, _max_diff(lane, one, ("mule_models",
                                                         "fixed_models")))
                if not torch.equal(aux["last_fid"][i], one_aux["last_fid"]):
                    raise AssertionError(f"{label}: lane {i}'s last_fid "
                                         f"differs from its sequential run")
                if list(one_aux["eval_steps"]) != list(aux["eval_steps"]):
                    raise AssertionError(f"{label}: eval steps differ")
                del one
            print(f"{label}: lanes vs {LANES} sequential run_population "
                  f"runs ({LANES * SWEEP_STEPS / seq_wall:.3f} lane-steps/s, "
                  f"{SWEEP_STEPS / seq_wall:.3f} steps/s a run, "
                  f"{seq_wall:.3f} s): max |final weight diff| "
                  f"{worst:.3e} (tol {REPLAY_ATOL}); last_fid and eval "
                  f"steps equal")
            if not worst <= REPLAY_ATOL:
                raise AssertionError(f"{label}: a lane left its sequential "
                                     f"run's growth bound")
        del final, aux
    _profile_steps(lambda: run_sweep(
        **{**sweep, "colocations": _lane_steps(stacked, 0, PROFILE_STEPS),
           "eval_every": None, "eval_fn": None}, methods="mlmule"),
        PROFILE_STEPS, f"sweep S={LANES} mlmule")
    del states, pops, sweep, ctx
    gc.collect()
    torch.cuda.empty_cache()

    # Fig 8's config through the harness's seeded sweep
    cfg = ExperimentConfig(task="har", mode="mobile", pattern=str(P_CROSS),
                           steps=SWEEP_STEPS, batch=HAR_BATCH, lr=HAR_LR)
    t0 = time.perf_counter()
    result, got, peak = _count_run(lambda: run_sweep_experiment(
        cfg, seeds, methods=METHODS_MOBILE, device="cuda"))
    wall = time.perf_counter() - t0
    want_steps = [(i + 1) * cfg.eval_every - 1
                  for i in range(SWEEP_STEPS // cfg.eval_every)]
    want_got = {"mule_agg": 2 * SWEEP_STEPS, "encounter_mix": 2 * n_ex}
    if result["eval_steps"] != want_steps or got != want_got:
        raise AssertionError(f"Fig 8 sweep: eval steps "
                             f"{result['eval_steps']}, launches {got}; "
                             f"expected {want_steps}, {want_got}")
    for m, r in result["methods"].items():
        accs = [a for lane in r["acc"] for a in lane] + r["final_acc"]
        if len(r["final_acc"]) != LANES or not all(
                math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs):
            raise AssertionError(f"Fig 8 sweep {m}: accuracies {accs}")
        print(f"Fig 8 sweep (har, walk P_cross={P_CROSS}, seeds {seeds}, "
              f"M={cfg.n_mules}, T={SWEEP_STEPS}): {m} mean final accuracy "
              f"{r['mean_final_acc']:.4f}, by seed "
              f"{[round(a, 4) for a in r['final_acc']]}, mean curve "
              f"{[round(a, 4) for a in r['mean_acc']]}")
    print(f"Fig 8 sweep: run_sweep_experiment of the five methods in "
          f"{wall:.2f} s, peak memory {peak} B, launches {got} [{card}]")
    paths[f"Fig 8 sweep S={LANES}"] = got
    print(f"sweep: phase wall {time.perf_counter() - t_phase:.1f} s")
    return paths


def _schedule_bytes(window) -> int:
    """Bytes of a schedule window's tensors on the card."""
    return sum(t.numel() * t.element_size() for t in window)


def _same_state(label: str, a: dict, b: dict) -> None:
    """Raises unless every tensor of two population states is bitwise
    equal."""
    import torch
    from repro_torch.interop import flatten_tree
    fa, fb = flatten_tree(a), flatten_tree(b)
    if sorted(fa) != sorted(fb):
        raise AssertionError(f"{label}: state keys differ")
    bad = [k for k in fa if not torch.equal(fa[k], fb[k])]
    if bad:
        raise AssertionError(f"{label}: not bitwise equal in {bad}")


def phase_streamed_path(card: str) -> dict:
    """Phase 4's mlmule run and phase 5's gossip run, each materialized and
    through ``run_population_streamed`` (chunks of STREAM_CHUNK), with
    cuDNN's deterministic algorithms: final states, last_fid and evals
    bitwise equal, kernel launches exact. Returns {path: launches}."""
    import gc
    import torch
    from repro_torch.configs.mule_cnn import CONFIG
    from repro_torch.core.population import PopulationConfig, init_population
    from repro_torch.experiment import (batch_sampler, cnn_model_fns,
                                        image_data_mobile)
    from repro_torch.interop import tree_map
    from repro_torch.kernels.encounter_mix import encounter_mix
    from repro_torch.kernels.mule_agg import mule_agg
    from repro_torch.scenarios import (get_scenario, run_population,
                                       run_population_streamed,
                                       scenario_generator, walk_colocation)
    from repro_torch.scenarios.engine import _colocation_tensors
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    init_fn, train_fn, eval_fn = cnn_model_fns(CONFIG, LR)
    spec = get_scenario("commuter")
    paths = {}
    for method, co, n_fixed, kernel, want in (
            ("mlmule", spec.colocation(SEED, N_MULES, N_STEPS), spec.n_fixed,
             mule_agg, N_STEPS),
            ("gossip", walk_colocation(SEED, N_MULES, N_STEPS,
                                       p_cross=P_CROSS), None, encounter_mix,
             N_STEPS // PEER_EVERY)):
        if n_fixed is None:
            n_fixed = 4 * (int(co["area"].max()) + 1)
        Xtr, Ytr, Xte, Yte = image_data_mobile(
            SEED, N_MULES, n_fixed, co["init_space"], co["init_area"],
            n_super=CONFIG.n_classes, image_size=CONFIG.image_size)
        pcfg = PopulationConfig(mode="mobile", n_fixed=n_fixed,
                                n_mules=N_MULES)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        pop0 = init_population(pcfg, init_fn, gen)
        batch_fn = batch_sampler(Xtr, Ytr, BATCH)

        def eval_hook(st, last):
            return torch.func.vmap(eval_fn)(st["mule_models"], Xte[last],
                                            Yte[last])

        stream = scenario_generator(spec if method == "mlmule" else
                                    "random_walk", SEED, N_MULES, N_STEPS,
                                    colocation=co, device="cuda")
        kw = dict(batches=batch_fn, train_fn=train_fn, cfg=pcfg, key=SEED,
                  eval_every=EVAL_EVERY, eval_fn=eval_hook, method=method)
        mat_bytes = _schedule_bytes(_colocation_tensors(co, "cuda"))
        chunk = stream.generate_chunk(None, 0, STREAM_CHUNK)
        str_bytes = stream.schedule_bytes() + _schedule_bytes(
            chunk.values())
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            run_population(pop0, _steps(co, 0, PEER_EVERY), **{
                **kw, "eval_every": None, "eval_fn": None})    # warm-up
            runs = {}
            for engine in ("materialized", "streamed"):
                t0 = time.perf_counter()
                if engine == "materialized":
                    (final, aux), got, peak = _count_run(
                        lambda: run_population(pop0, co, **kw))
                else:
                    (final, aux), got, peak = _count_run(
                        lambda: run_population_streamed(
                            pop0, stream, chunk_len=STREAM_CHUNK, **kw))
                wall = time.perf_counter() - t0
                # to the host, so that the next run's peak holds only its own
                runs[engine] = (tree_map(lambda t: t.cpu(), final),
                                {k: (v.cpu() if isinstance(v, torch.Tensor)
                                     else v) for k, v in aux.items()},
                                wall, got, peak)
                del final, aux
        finally:
            torch.backends.cudnn.deterministic = False
        (fm, am, wm, gm, pm), (fs, as_, ws, gs, ps) = (runs["materialized"],
                                                       runs["streamed"])
        label = f"streamed {method}"
        name = "mule_agg" if kernel is mule_agg else "encounter_mix"
        for engine, got in (("materialized", gm), ("streamed", gs)):
            if got[name] != want:
                raise AssertionError(f"{label}: {engine} run launched "
                                     f"{name} {got[name]} times, expected "
                                     f"{want}")
        _same_state(label, fs, fm)
        if not (torch.equal(as_["last_fid"], am["last_fid"])
                and torch.equal(as_["evals"], am["evals"])
                and list(as_["eval_steps"]) == list(am["eval_steps"])):
            raise AssertionError(f"{label}: last_fid or evals differ")
        if not bool(torch.isfinite(as_["evals"]).all()):
            raise AssertionError(f"{label}: non-finite eval")
        _check_finite(label, {**fs["mule_models"], **fs["fixed_models"]})
        where = "commuter" if method == "mlmule" else "random_walk"
        print(f"streamed path: {method} on {where}, M={N_MULES}, "
              f"T={N_STEPS}, chunks of {STREAM_CHUNK}: streamed "
              f"{N_STEPS / ws:.3f} steps/s ({ws:.3f} s, peak {ps} B, "
              f"schedule {str_bytes} B: {stream.schedule_bytes()} B compact "
              f"+ {str_bytes - stream.schedule_bytes()} B a chunk), "
              f"materialized {N_STEPS / wm:.3f} steps/s ({wm:.3f} s, peak "
              f"{pm} B, schedule {mat_bytes} B); launches {gs}; final "
              f"state, last_fid and evals bitwise equal [{card}]")
        paths[label] = gs
        del fm, fs, am, as_, pop0, runs
    print(f"streamed path: phase wall {time.perf_counter() - t_phase:.1f} s")
    return paths


def _scale_fns(n_mules: int):
    """The reference's scale workload: (train_fn, batch_fn, state)."""
    import torch
    from repro_torch.core.population import PopulationConfig, init_population

    def train_fn(params, batch, key):
        xb, yb = batch
        g = torch.func.grad(
            lambda p: torch.mean((xb @ p["w"] - yb) ** 2))(params)
        return {k: p - SCALE_LR * g[k] for k, p in params.items()}

    def batch_fn(seed, t):
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        return {"fixed": None, "mule": (
            torch.randn(n_mules, SCALE_BATCH, SCALE_D, device="cuda",
                        generator=g),
            torch.randn(n_mules, SCALE_BATCH, device="cuda", generator=g))}

    pcfg = PopulationConfig(mode="mobile", n_fixed=N_FIXED, n_mules=n_mules)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 1)
    weights = {side: {"w": torch.randn(n, SCALE_D, device="cuda",
                                       generator=g)}
               for side, n in (("mule_models", n_mules),
                               ("fixed_models", N_FIXED))}
    return train_fn, batch_fn, pcfg, init_population(pcfg, weights=weights)


def phase_scale(card: str):
    """Population scale: the scale workload on streaming_commuter's
    procedural stream at SCALE_MULES, streamed and through run_population
    over the materialized schedule: final models bitwise equal, mule_agg
    launched SCALE_STEPS times a run; then mule_agg timed at the scale
    shape. Returns ({path: launches}, the timing entry of row 1)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.mobility import materialize_generator
    from repro_torch.scenarios import (run_population,
                                       run_population_streamed,
                                       scenario_generator)
    from repro_torch.scenarios.engine import _colocation_tensors
    t_phase = time.perf_counter()
    paths = {}
    for m in SCALE_MULES:
        gc.collect()
        torch.cuda.empty_cache()
        train_fn, batch_fn, pcfg, pop0 = _scale_fns(m)
        stream = scenario_generator("streaming_commuter", SEED, m,
                                    SCALE_STEPS, device="cuda")
        t0 = time.perf_counter()
        co = materialize_generator(stream)
        build_s = time.perf_counter() - t0
        delivers = int((co["exchange"] & (co["fixed_id"] >= 0)
                        & co["active"]).sum())
        kw = dict(batches=batch_fn, train_fn=train_fn, cfg=pcfg, key=SEED)
        run_population_streamed(pop0, stream, n_steps=SCALE_CHUNK,
                                chunk_len=SCALE_CHUNK, **kw)   # warm-up
        runs = {}
        for engine in ("streamed", "materialized"):
            t0 = time.perf_counter()
            if engine == "streamed":
                (final, aux), got, peak = _count_run(
                    lambda: run_population_streamed(
                        pop0, stream, chunk_len=SCALE_CHUNK, **kw))
                sched = stream.schedule_bytes() + _schedule_bytes(
                    stream.generate_chunk(None, 0, SCALE_CHUNK).values())
            else:
                (final, aux), got, peak = _count_run(
                    lambda: run_population(pop0, co, **kw))
                sched = _schedule_bytes(_colocation_tensors(co, "cuda"))
            wall = time.perf_counter() - t0
            if got["mule_agg"] != SCALE_STEPS:
                raise AssertionError(f"scale M={m} {engine}: mule_agg "
                                     f"launched {got['mule_agg']} times, "
                                     f"expected {SCALE_STEPS}")
            runs[engine] = (final, aux)
            print(f"scale M={m} {engine}: {SCALE_STEPS / wall:.3f} steps/s "
                  f"({wall:.3f} s), schedule {sched} B, peak memory {peak} "
                  f"B, launches {got} [{card}]")
        (fs, as_), (fm, am) = runs["streamed"], runs["materialized"]
        _same_state(f"scale M={m}", fs["mule_models"], fm["mule_models"])
        _same_state(f"scale M={m} fixed", fs["fixed_models"],
                    fm["fixed_models"])
        if not torch.equal(as_["last_fid"], am["last_fid"]):
            raise AssertionError(f"scale M={m}: last_fid differs")
        _check_finite(f"scale M={m}", fs["mule_models"])
        moved = int((fs["mule_models"]["w"] != pop0["mule_models"]["w"])
                    .any(1).sum())
        if moved == 0 or int(fs["fresh"]["count"].sum()) == 0:
            raise AssertionError(f"scale M={m}: no mule delivered")
        print(f"scale M={m}: streamed and materialized final models and "
              f"last_fid bitwise equal; {delivers} deliveries, {moved} "
              f"mules moved, schedule materialized on the host in "
              f"{build_s:.2f} s ({int(np.asarray(co['fixed_id']).nbytes)} B "
              f"of fixed_id alone)")
        paths[f"scale M={m}"] = {"mule_agg": SCALE_STEPS}
        del runs, fs, fm, co
        if m == SCALE_MULES[-1]:
            _profile_steps(lambda: run_population_streamed(
                pop0, stream, n_steps=SCALE_CHUNK, chunk_len=SCALE_CHUNK,
                **kw), SCALE_CHUNK, f"scale M={m} streamed",
                parts={"mule_agg": "mule_agg"})
        del pop0
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    # the kernel is far above its bound at this shape (PERF.md §6): a few
    # readings of a graph of 20 calls, to keep the phase short
    entry = _mule_agg_timing(g, N_FIXED, SCALE_MULES[-1], SCALE_D, "scale",
                             torch.float32, card, reps=3)
    print(f"scale: phase wall {time.perf_counter() - t_phase:.1f} s")
    return paths, entry


def _replicated_digest(st: dict) -> str:
    """sha256 of the bits of a rank's replicated state (fixed_models,
    fresh, t)."""
    import hashlib
    from repro_torch.interop import flatten_tree
    h = hashlib.sha256()
    for part in ("fixed_models", "fresh", "t"):
        flat = flatten_tree({part: st[part]})
        for k in sorted(flat):
            h.update(k.encode())
            h.update(flat[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _pruned_hops(co, order, n_ranks, t_swap, n_steps) -> list:
    """Remote hops the ring's mask skips a rank at the exchanges before and
    from ``t_swap``, where one swap put the mules in ``order``."""
    import numpy as np
    from repro_torch.baselines.gossip import ring_hop_mask
    area = np.asarray(co["area"])
    before = after = 0
    for t in range(PEER_EVERY - 1, n_steps, PEER_EVERY):
        row = area[t] if t < t_swap else area[t][order]
        mask = ring_hop_mask(row, None, n_ranks)
        skipped = int((~mask[1:]).sum())
        if t < t_swap:
            before += skipped
        else:
            after += skipped
    return [before, after]


def dist_rank(out_dir: str) -> None:
    """One rank of phase 16, run as ``chip_smoke.py --dist-rank DIR`` by
    ``spawn_local_cluster``: the five methods through
    ``run_population_distributed`` on this rank's block, mlmule against its
    plain aggregation (whole run and lockstep), mlmule on a 2 x 2 mesh,
    and the re-bucketed streamed engine on multi_area_migratory; then
    phase 17's sweep (``_dist_sweep``); rank 0 writes every rank's report
    to DIR/dist.json."""
    import dataclasses as dc
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.baselines.gossip import RING_COUNTS, flatten_population
    from repro_torch.configs.mule_cnn import CONFIG
    from repro_torch.core import METHODS_MOBILE
    from repro_torch.core.distributed import (PSUM_COUNTS, DistributedConfig,
                                              bucket_mule_order,
                                              make_distributed_method_step,
                                              reorder_colocation,
                                              reorder_mule_state,
                                              to_distributed_state)
    from repro_torch.core.population import PopulationConfig, init_population
    from repro_torch.core.seeds import fold_in
    from repro_torch.experiment import (batch_sampler, cnn_model_fns,
                                        image_data_mobile)
    from repro_torch.kernels.encounter_mix import (encounter_block_hop,
                                                   encounter_mix)
    from repro_torch.kernels.mule_agg import mule_agg
    from repro_torch.launch.mesh import make_mule_mesh
    from repro_torch.launch.multiprocess import (gather_global,
                                                 initialize_from_env,
                                                 put_global, put_global_tree)
    from repro_torch.mobility import compact_colocation
    from repro_torch.scenarios import (get_scenario,
                                       run_population_distributed,
                                       run_population_streamed)

    if not initialize_from_env():
        raise RuntimeError("--dist-rank needs the REPRO_MP_* environment of "
                           "spawn_local_cluster")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    n, i = dist.get_world_size(), dist.get_rank()
    co, order = _ring_walk()
    n_fixed = 4 * (int(co["area"].max()) + 1)
    Xtr, Ytr, _, _ = image_data_mobile(
        SEED, N_MULES, n_fixed, co["init_space"], co["init_area"],
        n_super=CONFIG.n_classes, image_size=CONFIG.image_size)
    init_fn, train_fn, _ = cnn_model_fns(CONFIG, LR)
    pcfg = PopulationConfig(mode="mobile", n_fixed=n_fixed, n_mules=N_MULES)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    pop0 = reorder_mule_state(init_population(pcfg, init_fn, gen), order)
    batch_fn = batch_sampler(Xtr, Ytr, BATCH)
    dcfg = DistributedConfig(pop=pcfg)
    mesh = make_mule_mesh(1, n)
    report = {"rank": i, "runs": {}}

    def whole(models, mesh_):
        """The population's flat models from every rank's block."""
        return gather_global(flatten_population(models)[0], mesh_)

    def run(method, dcfg_, mesh_, n_steps, train=train_fn):
        return run_population_distributed(
            to_distributed_state(pop0, dcfg_), _steps(co, 0, n_steps),
            batch_fn, train, dcfg_, mesh_, key=SEED, method=method)

    def counted(fn):
        torch.cuda.synchronize()
        dist.barrier()
        mule_agg.launches = 0
        encounter_block_hop.launches = 0
        encounter_mix.launches = 0
        ring0, psum0 = dict(RING_COUNTS), dict(PSUM_COUNTS)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dist.barrier()
        return out, {"wall_s": time.perf_counter() - t0,
                     "mule_agg": mule_agg.launches,
                     "encounter_hop": encounter_block_hop.launches,
                     "encounter_mix": encounter_mix.launches,
                     "pruned": RING_COUNTS["pruned"] - ring0["pruned"],
                     "ring_bytes": RING_COUNTS["sent_bytes"]
                     - ring0["sent_bytes"],
                     "psum_bytes": PSUM_COUNTS["sent_bytes"]
                     - psum0["sent_bytes"]}

    finals = {}
    for method in METHODS_MOBILE:
        run(method, dcfg, mesh, PEER_EVERY)                    # warm-up
        (final, _), rec = counted(lambda: run(method, dcfg, mesh, DIST_STEPS))
        rec["digest"] = _replicated_digest(final)
        flat = whole(final["mule_models"], mesh)
        rec["finite"] = bool(torch.isfinite(flat).all()) and all(
            bool(torch.isfinite(v).all())
            for v in final["fixed_models"].values())
        rec["moved"] = int((flat != flatten_population(
            pop0["mule_models"])[0]).any(1).sum())
        if method == "mlmule":
            finals["mlmule"] = (flat, final["fixed_models"])
        report["runs"][method] = rec
        del final, flat

    # mlmule against its plain aggregation: the whole run, under a bound
    # on training's growth, and the aggregation in lockstep, training off
    dcfg_ref = dc.replace(dcfg, pop=dc.replace(pcfg, agg_backend="ref"))
    (ref, _), _ = counted(lambda: run("mlmule", dcfg_ref, mesh, DIST_STEPS))
    flat_k, fixed_k = finals["mlmule"]
    report["ref_diff"] = max(
        (whole(ref["mule_models"], mesh) - flat_k).abs().max().item(),
        max((ref["fixed_models"][k] - fixed_k[k]).abs().max().item()
            for k in fixed_k))
    del ref

    def keep(params, batch, key):
        return params

    step_k = make_distributed_method_step("mlmule", keep, dcfg, mesh)
    step_r = make_distributed_method_step("mlmule", keep, dcfg_ref, mesh)
    step_t = make_distributed_method_step("mlmule", train_fn, dcfg, mesh)
    st = put_global_tree(to_distributed_state(pop0, dcfg), mesh,
                         {k: (0 if k.startswith("mule") else None)
                          for k in pop0})
    cols = {k: torch.as_tensor(co[k], device="cuda")
            for k in ("fixed_id", "exchange", "pos")}
    area = put_global(torch.as_tensor(co["area"], device="cuda").long(), mesh)
    worst = 0.0
    for t in range(DIST_LOCKSTEP_STEPS):
        info = {"fixed_id": put_global(cols["fixed_id"][t].long(), mesh),
                "exchange": put_global(cols["exchange"][t], mesh),
                "pos": put_global(cols["pos"][t], mesh), "area": area,
                "active": None, "t": t}
        k_t = fold_in(SEED, t)
        bt, ks = batch_fn(fold_in(k_t, 0), t), fold_in(k_t, 1)
        a, b = step_k(st, info, bt, ks), step_r(st, info, bt, ks)
        worst = max([worst] + [
            (a[side][k].float() - b[side][k].float()).abs().max().item()
            for side in ("mule_models", "fixed_models", "fresh")
            for k in a[side]])
        st = step_t(st, info, bt, ks)
    report["lockstep"] = worst
    del st, a, b

    # mlmule on a 2 x 2 mesh, each pod summing its own data axis
    mesh22 = make_mule_mesh(2, n // 2)
    dcfg22 = dc.replace(dcfg, cross_pod=False)
    run("mlmule", dcfg22, mesh22, PEER_EVERY)                   # warm-up
    (final, _), rec = counted(lambda: run("mlmule", dcfg22, mesh22,
                                          DIST_STEPS))
    rec["digest"] = _replicated_digest(final)
    flat = whole(final["mule_models"], mesh22)
    rec["finite"] = bool(torch.isfinite(flat).all())
    rec["diff_vs_1x4"] = (flat - flat_k).abs().max().item()
    report["runs"]["mlmule 2x2 pod-local"] = rec
    del final, finals

    # the re-bucketed streamed engine on the migratory schedule
    spec = get_scenario("multi_area_migratory")
    mco = spec.colocation(SEED, N_MULES, DIST_STEPS)
    morder = bucket_mule_order(mco["area"])
    mco = reorder_colocation(mco, morder)
    mX, mY, _, _ = image_data_mobile(
        SEED, N_MULES, spec.n_fixed, mco["init_space"], mco["init_area"],
        n_super=CONFIG.n_classes, image_size=CONFIG.image_size)
    mcfg = PopulationConfig(mode="mobile", n_fixed=spec.n_fixed,
                            n_mules=N_MULES)
    gen.manual_seed(SEED)
    mpop = reorder_mule_state(init_population(mcfg, init_fn, gen), morder)
    mbatch = batch_sampler(mX, mY, BATCH)
    dcfg_rb = DistributedConfig(pop=mcfg, rebucket_every=REBUCKET_EVERY,
                                rebucket_threshold=REBUCKET_THRESHOLD)
    stream = compact_colocation(mco, device="cuda")
    marks, expand = [], stream.expand

    def marked(arrays, key, t0, chunk_len):
        """The stream's expand, noting the hops pruned so far: the engine
        expands once to read the first areas, then once a chunk."""
        marks.append(RING_COUNTS["pruned"])
        return expand(arrays, key, t0, chunk_len)

    stream.expand = marked
    (fin_s, aux_s), rec = counted(lambda: run_population_streamed(
        to_distributed_state(mpop, dcfg_rb), stream, mbatch, train_fn, mcfg,
        SEED, chunk_len=REBUCKET_EVERY, method="gossip", mesh=mesh,
        dcfg=dcfg_rb))
    marks.append(RING_COUNTS["pruned"])
    by_chunk = [b - a for a, b in zip(marks[1:], marks[2:])]
    (fin_d, aux_d), rec_d = counted(lambda: run_population_distributed(
        to_distributed_state(mpop, dcfg_rb), mco, mbatch, train_fn, dcfg_rb,
        mesh, key=SEED, method="gossip"))
    rb = aux_s["rebucket"]
    try:
        _same_state("rebucketed streamed vs run_population_distributed",
                    {k: fin_s[k] for k in ("mule_models", "fixed_models",
                                           "mule_ts")},
                    {k: fin_d[k] for k in ("mule_models", "fixed_models",
                                           "mule_ts")})
        rec["equal_to_distributed"] = bool(
            torch.equal(aux_s["last_fid"], aux_d["last_fid"])
            and list(aux_d["rebucket"]["order"]) == list(rb["order"]))
    except AssertionError:
        rec["equal_to_distributed"] = False
    swap_t = next(((k + 1) * REBUCKET_EVERY for k, d in enumerate(rb["drift"])
                   if d > REBUCKET_THRESHOLD), DIST_STEPS)
    rec.update(checks=rb["checks"], swaps=rb["swaps"], drift=rb["drift"],
               order=[int(x) for x in rb["order"]], swap_t=swap_t,
               pruned_by_chunk=by_chunk,
               pruned_host=_pruned_hops(mco, rb["order"], n, swap_t,
                                        DIST_STEPS),
               digest=_replicated_digest(fin_s), finite=bool(all(
                   bool(torch.isfinite(v).all())
                   for v in fin_s["mule_models"].values())))
    report["runs"]["rebucket gossip"] = rec
    del fin_s, fin_d, mpop, stream
    gc.collect()
    torch.cuda.empty_cache()
    report["sweep"] = _dist_sweep(mesh, counted, whole, init_fn, train_fn)
    reports = [None] * n if i == 0 else None
    dist.gather_object(report, reports, dst=0)
    if i == 0:
        (Path(out_dir) / "dist.json").write_text(json.dumps(reports))
    dist.barrier()
    dist.destroy_process_group()


def _sweep_walks():
    """The distributed sweep's lanes: DIST_LANES seeds of the walk (T =
    DIST_STEPS), each bucket-ordered by its own areas; (colocations,
    orders)."""
    from repro_torch.core.distributed import (bucket_mule_order,
                                              reorder_colocation)
    from repro_torch.scenarios import walk_colocation
    cos, orders = [], []
    for s in range(SEED, SEED + DIST_LANES):
        co = walk_colocation(s, N_MULES, DIST_STEPS, p_cross=P_CROSS)
        order = bucket_mule_order(co["area"])
        cos.append(reorder_colocation(co, order))
        orders.append(order)
    return cos, orders


def _dist_sweep(mesh, counted, whole, init_fn, train_fn) -> dict:
    """Phase 17 in a rank of phase 16's world: ``run_sweep_distributed``
    over DIST_LANES seeds of the walk for ``mlmule`` and ``gossip``, then
    each lane alone through ``run_population_distributed``; the rank's
    launches, collectives, bytes and digests, and each lane's largest
    distance from its sequential run. Then the same comparison over
    DIST_SWEEP_OFF_STEPS steps with training off (the collectives, the
    aggregation and the hops alone) for both methods, and over
    DIST_LOCAL_STEPS for ``local`` (training alone) with cuDNN and
    without; each with its wall seconds."""
    import numpy as np
    import torch
    from repro_torch.configs.mule_cnn import CONFIG
    from repro_torch.core.distributed import (PSUM_COUNTS, DistributedConfig,
                                              reorder_mule_state,
                                              to_distributed_state)
    from repro_torch.core.population import PopulationConfig, init_population
    from repro_torch.experiment import (_stack_wrap_pad, image_data_mobile,
                                        sample_batches)
    from repro_torch.scenarios import (run_population_distributed,
                                       run_sweep_distributed, stack_trees)
    from repro_torch.scenarios.sweep import _lane as tree_lane
    cos, orders = _sweep_walks()
    seeds = [SEED + s for s in range(DIST_LANES)]
    data = [image_data_mobile(s, N_MULES, N_FIXED, co["init_space"],
                              co["init_area"], n_super=CONFIG.n_classes,
                              image_size=CONFIG.image_size)
            for s, co in zip(seeds, cos)]
    ctx = tuple(_stack_wrap_pad([d[k] for d in data]) for k in range(2))
    del data
    pcfg = PopulationConfig(mode="mobile", n_fixed=N_FIXED, n_mules=N_MULES)
    dcfg = DistributedConfig(pop=pcfg)
    pops = []
    for s, order in zip(seeds, orders):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(s)
        pops.append(to_distributed_state(reorder_mule_state(
            init_population(pcfg, init_fn, gen), order), dcfg))
    # the lanes' states stacked once; lane l's sequential run takes its
    # slices (4 ranks share the card, so no rank keeps a second copy)
    states = stack_trees(pops)
    del pops
    stacked = {k: torch.as_tensor(np.stack([co[k] for co in cos]),
                                  device="cuda")
               for k in ("fixed_id", "exchange", "pos", "area")}

    def batch_fn(seed, t, c):
        return {"fixed": None, "mule": sample_batches(seed, c[0], c[1],
                                                      BATCH)}

    def sweep(method, n_steps, train=train_fn):
        return run_sweep_distributed(
            states, _lane_steps(stacked, 0, n_steps), batch_fn, train,
            dcfg, mesh, seeds, methods=method, context=ctx)

    def alone(method, n_steps, l, train=train_fn):
        return run_population_distributed(
            tree_lane(states, l), _steps(cos[l], 0, n_steps), batch_fn,
            train, dcfg, mesh, key=seeds[l], method=method,
            context=tuple(c[l] for c in ctx))

    def gap(final, aux, l, one, one_aux):
        """(largest distance, bitwise) of lane l of a sweep from its
        sequential run: the whole population's mules and the fixed
        models, and last_fid."""
        lane = whole(tree_lane(final["mule_models"], l), mesh)
        solo = whole(one["mule_models"], mesh)
        pairs = [(lane, solo)] + [(final["fixed_models"][k][l], v)
                                  for k, v in one["fixed_models"].items()]
        diff = max((a - b).abs().max().item() for a, b in pairs)
        exact = all(torch.equal(a, b) for a, b in pairs) and torch.equal(
            aux["last_fid"][l], one_aux["last_fid"])
        return diff, exact

    def lanes_gap(method, n_steps, train):
        """(largest distance, every lane bitwise, wall seconds) of the
        sweep's lanes from their sequential runs."""
        t0 = time.perf_counter()
        final, aux = sweep(method, n_steps, train)
        worst, exact = 0.0, True
        for l in range(DIST_LANES):
            diff, ok = gap(final, aux, l, *alone(method, n_steps, l, train))
            worst, exact = max(worst, diff), exact and ok
        return worst, exact, time.perf_counter() - t0

    def keep(params, batch, key):
        return params

    out = {}
    for method in DIST_SWEEP_METHODS:
        torch.cuda.empty_cache()     # what this rank cached, for the others
        sweep(method, PEER_EVERY)                               # warm-up
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        calls0 = PSUM_COUNTS["calls"]
        (final, aux), rec = counted(lambda: sweep(method,
                                                      DIST_SWEEP_STEPS))
        rec["peak"] = torch.cuda.max_memory_allocated()
        rec["psum_calls"] = PSUM_COUNTS["calls"] - calls0
        rec["digests"] = [_replicated_digest(
            {k: tree_lane(final[k], l) for k in ("fixed_models", "fresh",
                                                 "t")})
            for l in range(DIST_LANES)]
        seq_wall, worst, bitwise, seq_bytes, seq_hops = 0.0, 0.0, True, 0, 0
        for l in range(DIST_LANES):
            (one, one_aux), r1 = counted(lambda: alone(
                method, DIST_SWEEP_STEPS, l))
            seq_wall += r1["wall_s"]
            seq_bytes += r1["ring_bytes"] + r1["psum_bytes"]
            seq_hops += r1["encounter_hop"]
            diff, exact = gap(final, aux, l, one, one_aux)
            worst, bitwise = max(worst, diff), bitwise and exact
            if not torch.equal(aux["last_fid"][l], one_aux["last_fid"]):
                rec["last_fid_differs"] = l
            del one
        rec.update(seq_wall_s=seq_wall, lane_diff=worst, bitwise=bitwise,
                   seq_bytes=seq_bytes, seq_hops=seq_hops,
                   finite=bool(all(bool(torch.isfinite(v).all())
                                   for v in final["mule_models"].values())))
        out[method] = rec
        del final, aux
        torch.cuda.empty_cache()
        rec["off"] = lanes_gap(method, DIST_SWEEP_OFF_STEPS, keep)
    # training alone: the vmapped CNN steps over lanes and mules (cuDNN
    # sees S times the groups), and the same without cuDNN
    torch.cuda.empty_cache()
    out["local"] = {"cudnn": lanes_gap("local", DIST_LOCAL_STEPS,
                                       train_fn)}
    with torch.backends.cudnn.flags(enabled=False, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        out["local"]["no cudnn"] = lanes_gap("local", DIST_LOCAL_STEPS,
                                             train_fn)
    del states
    torch.cuda.empty_cache()
    return out


def _check_dist_sweep(ranks: list, card: str) -> dict:
    """Phase 17's checks on the ranks' reports; {path: {kernel: launches of
    all ranks}}."""
    import numpy as np
    from repro_torch.baselines.gossip import ring_hop_mask
    cos, _ = _sweep_walks()
    need = np.zeros(DIST_RANKS, bool)
    kept_by_lane = []
    for co in cos:
        mask = ring_hop_mask(co["area"], None, DIST_RANKS).numpy()
        need |= mask
        kept_by_lane.append(int(mask.sum()))
    kept, n_ex = int(need.sum()), DIST_SWEEP_STEPS // PEER_EVERY
    want = {"mlmule": {"mule_agg": DIST_SWEEP_STEPS, "encounter_hop": 0,
                       "psum_calls": DIST_SWEEP_STEPS},
            "gossip": {"mule_agg": 0, "encounter_hop": n_ex * kept,
                       "psum_calls": 0}}
    paths = {}
    for method, exp in want.items():
        recs = [r["sweep"][method] for r in ranks]
        label = f"distributed sweep S={DIST_LANES} {method}"
        got = [{k: r[k] for k in exp} for r in recs]
        if got != [exp] * DIST_RANKS or any(r["encounter_mix"]
                                            for r in recs):
            raise AssertionError(f"{label}: by rank {got}, expected {exp} "
                                 f"(one ordered_psum a step and one "
                                 f"encounter_hop launch a kept hop for all "
                                 f"lanes), no encounter_mix")
        for l in range(DIST_LANES):
            if len({r["digests"][l] for r in recs}) != 1:
                raise AssertionError(f"{label}: lane {l}'s replicated state "
                                     f"differs between ranks")
        if not all(r["finite"] for r in recs) or any(
                "last_fid_differs" in r for r in recs):
            raise AssertionError(f"{label}: non-finite weights or a lane's "
                                 f"last_fid off its sequential run")
        worst = max(r["lane_diff"] for r in recs)
        wall = max(r["wall_s"] for r in recs)
        seq = max(r["seq_wall_s"] for r in recs)
        sent = sum(r["ring_bytes"] + r["psum_bytes"] for r in recs)
        seq_sent = sum(r["seq_bytes"] for r in recs)
        print(f"{label}: {DIST_RANKS} ranks x {N_MULES // DIST_RANKS} mules "
              f"x {DIST_LANES} lanes, T={DIST_SWEEP_STEPS}: "
              f"{DIST_LANES * DIST_SWEEP_STEPS / wall:.3f} lane-steps/s "
              f"({wall:.3f} s) against "
              f"{DIST_LANES * DIST_SWEEP_STEPS / seq:.3f} "
              f"for {DIST_LANES} sequential runs ({seq:.3f} s); launches by "
              f"rank {got}; {sent // DIST_SWEEP_STEPS} B a step through "
              f"host memory ({seq_sent // DIST_SWEEP_STEPS} B a step for the "
              f"sequential runs); encounter_hop {recs[0]['encounter_hop']} "
              f"a rank for all lanes against "
              f"{recs[0]['seq_hops']} for the sequential runs (kept hops "
              f"by lane {kept_by_lane}, union {kept}); replicated state "
              f"bitwise on every rank; lanes vs sequential runs max diff "
              f"{worst:.3e} (tol {REPLAY_ATOL}), bitwise "
              f"{all(r['bitwise'] for r in recs)}; peak memory by rank "
              f"{[r['peak'] for r in recs]} B [{card}]")
        off = max(r["off"][0] for r in recs)
        off_exact = all(r["off"][1] for r in recs)
        print(f"{label}, training off, T={DIST_SWEEP_OFF_STEPS}: lanes vs "
              f"sequential runs max diff {off:.3e}, bitwise {off_exact} "
              f"({max(r['off'][2] for r in recs):.1f} s) [{card}]")
        if not worst <= REPLAY_ATOL:
            raise AssertionError(f"{label}: a lane left its sequential "
                                 f"run's growth bound")
        if not off_exact:
            raise AssertionError(f"{label}: with training off a lane is not "
                                 f"bitwise its sequential run (the "
                                 f"collectives, aggregation or hops mix "
                                 f"lanes)")
        paths[label] = {k: sum(r[k] for r in recs)
                        for k in ("mule_agg", "encounter_hop")
                        if any(r[k] for r in recs)}
    local = {k: (max(r["sweep"]["local"][k][0] for r in ranks),
                 all(r["sweep"]["local"][k][1] for r in ranks),
                 max(r["sweep"]["local"][k][2] for r in ranks))
             for k in ("cudnn", "no cudnn")}
    print(f"distributed sweep S={DIST_LANES} local (training alone), "
          f"T={DIST_LOCAL_STEPS}: lanes vs sequential runs max diff "
          f"{local['cudnn'][0]:.3e} (bitwise {local['cudnn'][1]}; "
          f"{local['cudnn'][2]:.1f} s) with cuDNN, "
          f"{local['no cudnn'][0]:.3e} (bitwise {local['no cudnn'][1]}; "
          f"{local['no cudnn'][2]:.1f} s) without [{card}]")
    return paths


def phase_distributed(card: str) -> dict:
    """The distributed engine over DIST_RANKS ranks on the one card
    (``spawn_local_cluster``, gloo): holds what the ranks report and
    returns {path: {kernel: launches of all ranks}}."""
    import gc
    import tempfile
    import numpy as np
    import torch
    from repro_torch.baselines.gossip import ring_hop_mask
    from repro_torch.core import METHODS_MOBILE
    from repro_torch.launch.multiprocess import spawn_local_cluster
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    co, _ = _ring_walk()
    kept = int(ring_hop_mask(co["area"], None, DIST_RANKS).sum())
    n_ex = DIST_STEPS // PEER_EVERY
    with tempfile.TemporaryDirectory() as out_dir:
        outs = spawn_local_cluster(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-rank",
             out_dir], DIST_RANKS, timeout=DIST_TIMEOUT)
        ranks = json.loads((Path(out_dir) / "dist.json").read_text())
    for line in outs[0].stdout.splitlines():
        print(f"  rank 0: {line}")
    want = {"mlmule": {"mule_agg": DIST_STEPS, "encounter_hop": 0},
            "gossip": {"mule_agg": 0, "encounter_hop": n_ex * kept},
            "oppcl": {"mule_agg": 0, "encounter_hop": 0},
            "local": {"mule_agg": 0, "encounter_hop": 0},
            "mlmule+gossip": {"mule_agg": DIST_STEPS,
                              "encounter_hop": n_ex * kept},
            "mlmule 2x2 pod-local": {"mule_agg": DIST_STEPS,
                                     "encounter_hop": 0},
            "rebucket gossip": {"mule_agg": 0}}
    paths = {}
    for label, exp in want.items():
        recs = [r["runs"][label] for r in ranks]
        got = [{k: r[k] for k in exp} for r in recs]
        if got != [exp] * DIST_RANKS or any(r["encounter_mix"]
                                            for r in recs):
            raise AssertionError(f"distributed {label}: launches by rank "
                                 f"{got}, encounter_mix "
                                 f"{[r['encounter_mix'] for r in recs]}; "
                                 f"expected {exp} and no encounter_mix")
        if len({r["digest"] for r in recs}) != 1:
            raise AssertionError(f"distributed {label}: the ranks' "
                                 f"replicated state differs")
        if not all(r["finite"] for r in recs):
            raise AssertionError(f"distributed {label}: non-finite weights")
        if label in METHODS_MOBILE and recs[0]["moved"] == 0:
            raise AssertionError(f"distributed {label}: no mule changed")
        wall = max(r["wall_s"] for r in recs)
        sent = sum(r["ring_bytes"] + r["psum_bytes"] for r in recs)
        print(f"distributed path: {label}, {DIST_RANKS} ranks x "
              f"{N_MULES // DIST_RANKS} mules, T={DIST_STEPS}: "
              f"{DIST_STEPS / wall:.3f} steps/s ({wall:.3f} s), launches by "
              f"rank {got}, {sent} B sent ({sent // DIST_STEPS} B a step; "
              f"ring {sum(r['ring_bytes'] for r in recs)}, psum "
              f"{sum(r['psum_bytes'] for r in recs)}), "
              f"{sum(r['pruned'] for r in recs)} hops pruned; replicated "
              f"state bitwise equal on every rank [{card}]")
        paths[f"distributed {label}"] = {
            k: sum(r[k] for r in recs) for k in exp if any(
                r[k] for r in recs)}
    r0 = ranks[0]
    lock = max(r["lockstep"] for r in ranks)
    print(f"distributed mlmule: vs agg_backend='ref', final weights max "
          f"diff {r0['ref_diff']:.3e} (tol {REPLAY_ATOL}); lockstep over "
          f"{DIST_LOCKSTEP_STEPS} steps, training off: max diff {lock:.3e} "
          f"(tol "
          f"{LOCKSTEP_ATOL}); 2 x 2 pod-local vs 1 x 4: "
          f"{r0['runs']['mlmule 2x2 pod-local']['diff_vs_1x4']:.3e} (tol "
          f"{REPLAY_ATOL})")
    if not (r0["ref_diff"] <= REPLAY_ATOL and lock <= LOCKSTEP_ATOL
            and r0["runs"]["mlmule 2x2 pod-local"]["diff_vs_1x4"]
            <= REPLAY_ATOL):
        raise AssertionError("distributed mlmule: the kernel path and the "
                             "plain path disagree")
    rbs = [r["runs"]["rebucket gossip"] for r in ranks]
    rb = rbs[0]
    if rb["swaps"] < 1 or sorted(rb["order"]) != list(range(N_MULES)):
        raise AssertionError(f"rebucket: {rb['swaps']} swaps, order a "
                             f"permutation: "
                             f"{sorted(rb['order']) == list(range(N_MULES))}")
    if any(r["drift"] != rb["drift"] or r["order"] != rb["order"]
           for r in rbs):
        raise AssertionError("rebucket: the ranks read different drifts or "
                             "orders")
    if not all(r["equal_to_distributed"] for r in rbs):
        raise AssertionError("rebucket: the streamed run differs from "
                             "run_population_distributed(rebucket_every)")
    by_chunk = [r["pruned_by_chunk"] for r in rbs]
    if by_chunk != [rb["pruned_by_chunk"]] * DIST_RANKS \
            or sum(rb["pruned_by_chunk"]) != rb["pruned"]:
        raise AssertionError(f"rebucket: hops pruned by chunk and rank "
                             f"{by_chunk}, in all {rb['pruned']}")
    k = rb["swap_t"] // REBUCKET_EVERY
    before, after = sum(by_chunk[0][:k]), sum(by_chunk[0][k:])
    if rb["swaps"] == 1 and [before, after] != rb["pruned_host"]:
        raise AssertionError(f"rebucket: pruned {before} hops before the "
                             f"swap and {after} after, the host masks "
                             f"{rb['pruned_host']}")
    moved = int((np.asarray(rb["order"]) != np.arange(N_MULES)).sum())
    n_before = len(range(PEER_EVERY - 1, rb["swap_t"], PEER_EVERY))
    n_after = DIST_STEPS // PEER_EVERY - n_before
    print(f"distributed rebucket: gossip on multi_area_migratory, streamed "
          f"in chunks of {REBUCKET_EVERY}, threshold {REBUCKET_THRESHOLD}: "
          f"{rb['checks']} checks, drift {rb['drift']}, {rb['swaps']} "
          f"swap(s), the first after step {rb['swap_t']} ({moved} mules "
          f"renumbered in all); hops pruned a rank by chunk "
          f"{rb['pruned_by_chunk']}: {before} over {n_before} exchanges "
          f"before the swap, {after} over {n_after} after; equal to "
          f"run_population_distributed(rebucket_every={REBUCKET_EVERY}) "
          f"bitwise; drifts and orders equal on every rank")
    print(f"distributed path: phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    t_sweep = time.perf_counter()
    paths.update(_check_dist_sweep(ranks, card))
    print(f"distributed sweep: checks {time.perf_counter() - t_sweep:.1f} s "
          f"(its runs are in the ranks' wall above)")
    return paths


def phase_kernel_grads(card: str) -> None:
    """The three LM kernels as autograd ops on the card: each output has a
    ``grad_fn`` and its gradient is the plain version's (the backward is
    the plain version's VJP; the forwards differ by the kernel's rounding),
    and under ``torch.func.vmap(torch.func.grad(...))`` each lane gets its
    single-model gradient from one kernel launch for all lanes."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.slstm_fused import slstm_scan, slstm_scan_op
    from repro_torch.kernels.ssm_scan import ssd_scan, ssd_scan_op
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 9)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=g) * scale

    n = LANES
    cases = {
        "flash_attention": (
            flash_attention, "launches",
            lambda q, k, v, backend="auto": flash_attention(
                q, k, v, causal=True, backend=backend),
            [rn(n, 2, 128, 32, 64), rn(n, 2, 128, 32, 64),
             rn(n, 2, 128, 32, 64)]),
        "ssd_scan": (
            ssd_scan, "launches",
            lambda x, dt, a, bm, cm, backend="auto": ssd_scan_op(
                x, dt, a, bm, cm, 64, backend),
            [rn(n, 2, 128, 8, 64), torch.rand(n, 2, 128, 8, device="cuda",
                                               generator=g) * 0.1,
             -torch.rand(n, 8, device="cuda", generator=g) - 0.5,
             rn(n, 2, 128, 64), rn(n, 2, 128, 64)]),
        "slstm_scan": (
            slstm_scan, "launches",
            lambda pre, r, backend="auto": slstm_scan_op(pre, r, backend),
            [rn(n, 2, 64, 4, 4, 256), rn(n, 4, 4, 256, 256, scale=0.05)]),
    }
    for name, (fn, attr, op, inputs) in cases.items():
        def loss(*xs, backend="auto"):
            return (op(*xs, backend=backend) ** 2).mean()

        argnums = tuple(range(len(inputs)))
        setattr(fn, attr, 0)
        lanes = torch.func.vmap(torch.func.grad(loss, argnums=argnums))(
            *inputs)
        torch.cuda.synchronize()
        launched = getattr(fn, attr)
        if launched != 1:
            raise AssertionError(f"{name}: vmap(grad) over {n} lanes "
                                 f"launched {launched} times, not once")
        lane_gap, ref_gap, exact = 0.0, 0.0, True
        for i in range(n):
            one = [x[i].clone().requires_grad_() for x in inputs]
            out = op(*one)
            if out.grad_fn is None:
                raise AssertionError(f"{name}: the kernel's output has no "
                                     f"grad_fn")
            single = torch.autograd.grad((out ** 2).mean(), one)
            ref = torch.func.grad(lambda *xs: loss(*xs, backend="ref"),
                                  argnums=argnums)(*(x[i] for x in inputs))
            for a, b, c in zip(lanes, single, ref):
                scale = c.abs().max().item()
                lane_gap = max(lane_gap, (a[i] - b).abs().max().item()
                               / scale)
                ref_gap = max(ref_gap, (b - c).abs().max().item() / scale)
                exact = exact and torch.equal(a[i], b)
        print(f"kernel grads {name}: grad_fn set; vmap(grad) over {n} lanes "
              f"in 1 launch, each lane vs its single gradient max rel gap "
              f"{lane_gap:.3e} (bitwise {exact}; tol {KERNEL_GRAD_LANE_REL}),"
              f" the single vs backend='ref' {ref_gap:.3e} (tol "
              f"{KERNEL_GRAD_REF_REL}) [{card}]")
        if not (lane_gap <= KERNEL_GRAD_LANE_REL
                and ref_gap <= KERNEL_GRAD_REF_REL):
            raise AssertionError(f"{name}: a lane's gradient or the "
                                 f"kernel's gradient is off")


def _grad_check(label: str, cfg, params, tokens, expect: dict,
                card: str, check_tree=None, extra=None) -> None:
    """One f32 loss and gradient through the kernels (``backend="auto"``)
    against ``backend="ref"`` on the same weights and tokens: every leaf a
    finite, non-zero gradient, the loss within GRAD_LOSS_REL, each leaf's
    largest gap within GRAD_LEAF_REL of its largest gradient, the kernels
    launched as ``expect`` says; ``check_tree`` (if given) is called on the
    gradient tree through the kernels; ``extra`` joins the batch (Whisper's
    frames)."""
    import torch
    from repro_torch.interop import tree_leaves
    from repro_torch.models import build_model
    batch = {"tokens": tokens, **(extra or {})}
    _zero_counts(expect)
    ga, (la, _) = torch.func.grad_and_value(
        build_model(cfg).loss, has_aux=True)(params, batch)
    torch.cuda.synchronize()
    got = _counts(expect)
    if got != {k: v[2] for k, v in expect.items()}:
        raise AssertionError(f"{label}: launches {got}, expected "
                             f"{ {k: v[2] for k, v in expect.items()} }")
    if check_tree is not None:
        check_tree(ga)
    leaves_a = tree_leaves(ga)
    del ga
    gr, (lr, _) = torch.func.grad_and_value(
        build_model(cfg, backend="ref").loss, has_aux=True)(params, batch)
    leaves_r = tree_leaves(gr)
    if len(leaves_a) != len(tree_leaves(params)):
        raise AssertionError(f"{label}: a parameter leaf has no gradient")
    worst, worst_at, zero = 0.0, -1, 0
    for k, (a, r) in enumerate(zip(leaves_a, leaves_r)):
        if a is None or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label}: leaf {k}'s gradient is missing "
                                 f"or not finite")
        scale = r.abs().max().item()
        if a.abs().max().item() == 0.0 or scale == 0.0:
            zero += 1
            continue
        gap = (a - r).abs().max().item() / scale
        if gap > worst:
            worst, worst_at = gap, k
    rel = abs(la.item() - lr.item()) / abs(lr.item())
    print(f"{label}: f32 loss {la.item():.6f} through the kernels vs "
          f"{lr.item():.6f} backend='ref' (rel {rel:.3e}, tol "
          f"{GRAD_LOSS_REL}); {len(leaves_a)} gradient leaves, {zero} zero, "
          f"largest gap {worst:.3e} of its leaf's largest gradient (leaf "
          f"{worst_at}, tol {GRAD_LEAF_REL}); launches {got} [{card}]")
    if zero or not (rel <= GRAD_LOSS_REL and worst <= GRAD_LEAF_REL):
        raise AssertionError(f"{label}: the gradient through the kernels "
                             f"is off the plain version's")


def _flash_backward_cost(cfg, card: str) -> None:
    """One attention layer of the training step at its shape (bf16, batch
    TRAIN_BATCH x TRAIN_SEQ): the kernel's forward, the plain backward
    (``ref.flash_backward``) and, inside it, the recompute of the per-row
    softmax statistics that the kernel does not keep (``_fwd_impl``)."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_backward)
    from repro_torch.kernels.flash_attention.ops import REF_BLOCK
    from repro_torch.kernels.flash_attention.ref import _fwd_impl
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 13)
    h, d = cfg.n_heads, cfg.resolved_head_dim
    q, k, v, do = (torch.randn(TRAIN_BATCH, TRAIN_SEQ, h, d, device="cuda",
                               generator=g).bfloat16() for _ in range(4))
    blk = min(REF_BLOCK, TRAIN_SEQ)
    fwd_ms = _median_ms(lambda: flash_attention(q, k, v, causal=True))
    bwd_ms = _median_ms(lambda: flash_backward(
        q, k, v, do, causal=True, block_q=REF_BLOCK, block_k=REF_BLOCK))
    stats_ms = _median_ms(lambda: _fwd_impl(q, k, v, True, None, blk, blk,
                                            d ** -0.5))
    print(f"flash backward at one training layer (q, k, v [{TRAIN_BATCH}, "
          f"{TRAIN_SEQ}, {h}, {d}] bf16): kernel forward {fwd_ms:.4f} ms, "
          f"plain backward {bwd_ms:.4f} ms, of which the statistics' "
          f"recompute (the plain forward) {stats_ms:.4f} ms "
          f"({100 * stats_ms / bwd_ms:.1f}%) [{card}]")


def phase_training(card: str) -> dict:
    """Phase 18: stablelm-1.6b at full width through ``launch/train.py``'s
    functions (the f32 gradient check through the kernels, then Adam steps
    in bf16 with a checkpoint), and the gradient checks of zamba2-2.7b and
    xlstm-350m at full width and reduced depth. Returns {path: {kernel:
    launches}}."""
    import dataclasses as dc
    import gc
    import tempfile
    import numpy as np
    import torch
    from repro_torch.checkpoint import latest_checkpoint, restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.interop import tree_leaves
    from repro_torch.kernels.flash_attention.ops import TC_HEAD_DIMS
    from repro_torch.kernels.slstm_fused import slstm_scan
    from repro_torch.kernels.ssm_scan import ssd_scan
    from repro_torch.launch import train as ttrain
    from repro_torch.models import build_model
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    paths = {}
    rng = np.random.default_rng(SEED)

    # (a) the f32 gradient of stablelm-1.6b through the SIMT flash kernel
    cfg = get_config(TRAIN_ARCH)
    cfg32 = dc.replace(cfg, dtype="float32")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = build_model(cfg32).init(gen)
    n_params = sum(t.numel() for t in tree_leaves(params))
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (GRAD_BATCH,
                                                       TRAIN_SEQ)),
                           device="cuda")
    _grad_check(f"training {cfg.name} ({cfg.n_layers} layers, {n_params} "
                f"parameters) gradient", cfg32, params, toks,
                _flash_counts(cfg.n_layers, 0), card)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (b) Adam steps in bf16 through launch/train.py's loop, a checkpoint;
    # bf16 attention at stablelm's head dim 64 takes the tensor cores
    n_tc = cfg.n_layers if cfg.resolved_head_dim in TC_HEAD_DIMS else 0
    expect = _flash_counts(TRAIN_STEPS * cfg.n_layers, TRAIN_STEPS * n_tc)
    with tempfile.TemporaryDirectory() as ck:
        torch.cuda.reset_peak_memory_stats()
        ttrain.train(cfg, steps=1, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     device="cuda", log=lambda *_: None)          # warm-up
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(expect)
        out = ttrain.train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                           seq=TRAIN_SEQ, ckpt_dir=ck,
                           ckpt_every=TRAIN_STEPS, device="cuda",
                           log=lambda m: print(f"  {m}"))
        torch.cuda.synchronize()
        got = _counts(expect)
        peak = torch.cuda.max_memory_allocated()
        losses, times = out["losses"], out["step_s"]
        if got != {k: v[2] for k, v in expect.items()}:
            raise AssertionError(f"training {cfg.name}: launches {got}, "
                                 f"expected {cfg.n_layers} a step, {n_tc} "
                                 f"on the tensor cores")
        if not (all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0]):
            raise AssertionError(f"training {cfg.name}: losses {losses}")
        t0 = time.perf_counter()
        path = latest_checkpoint(ck)
        back, meta = restore_checkpoint(path, out["params"])
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(back), tree_leaves(out["params"])))
        ck_s = time.perf_counter() - t0
        if not same or meta.get("step") != TRAIN_STEPS:
            raise AssertionError(f"training {cfg.name}: the checkpoint "
                                 f"{path} did not restore bitwise")
        del back, out
    rate = TRAIN_STEPS / sum(times)
    print(f"training {cfg.name}: {TRAIN_STEPS} Adam steps (bf16 compute, "
          f"f32 weights, batch {TRAIN_BATCH} x {TRAIN_SEQ}): {rate:.3f} "
          f"steps/s, {rate * TRAIN_BATCH * TRAIN_SEQ:.1f} tokens/s (step "
          f"walls {[round(x, 4) for x in times]} s), losses "
          f"{[round(x, 4) for x in losses]}, peak memory {peak} B; "
          f"flash_attention {got['flash_attention'] // TRAIN_STEPS} a step "
          f"({got['flash_attention tc'] // TRAIN_STEPS} tensor-core); the "
          f"checkpoint restored bitwise ({ck_s:.1f} s) [{card}]")
    paths[f"{cfg.name} training"] = {"flash_attention": got["flash_attention"]}
    gc.collect()
    torch.cuda.empty_cache()
    _flash_backward_cost(cfg, card)

    # (c) zamba2-2.7b and xlstm-350m, full width, reduced depth, f32
    for arch, layers, expect_fn in (
            (HYBRID_ARCH, GRAD_HYBRID_LAYERS, lambda c: {
                "ssd_scan": (ssd_scan, "launches",
                             c.n_layers - c.n_layers
                             // c.attn_layer_interval),
                **_flash_counts(c.n_layers // c.attn_layer_interval, 0)}),
            (XLSTM_ARCH, GRAD_XLSTM_LAYERS, lambda c: {
                "slstm_scan": (slstm_scan, "launches", c.n_layers // 2)})):
        c = dc.replace(get_config(arch), n_layers=layers, dtype="float32")
        gen.manual_seed(SEED)
        params = build_model(c).init(gen)
        toks = torch.as_tensor(rng.integers(0, c.vocab, (GRAD_BATCH,
                                                         GRAD_SEQ)),
                               device="cuda")
        exp = expect_fn(c)
        _grad_check(f"training {arch} ({layers} layers, full width) "
                    f"gradient", c, params, toks, exp, card)
        paths[f"{arch} gradient check"] = {k: v[2] for k, v in exp.items()
                                           if "tc" not in k}
        del params
        gc.collect()
        torch.cuda.empty_cache()
    print(f"training: phase wall {time.perf_counter() - t_phase:.1f} s")
    return paths


def phase_lm_population(card: str) -> dict:
    """Phase 19: ``examples/torch_train_lm_population.py``'s
    ``lm_population`` with xlstm-350m at full width (F fixed devices
    training under ``torch.func.vmap``, M mules on the walk): ``mule_agg``
    once a step over whole LM parameter vectors, ``slstm_scan`` once a
    layer a step for all F models; before every step the aggregation of
    the state there held in lockstep through the kernel and through
    ``agg_backend="ref"`` (training off: the aggregation alone), on the
    step's deliveries and on every mule delivered. Returns {path: {kernel:
    launches}}."""
    import gc
    import importlib.util
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.aggregation import masked_group_mean
    from repro_torch.core.freshness import FreshnessConfig, accept_mask
    from repro_torch.kernels.mule_agg import mule_agg
    from repro_torch.kernels.slstm_fused import slstm_scan
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm_population",
        ROOT / "examples" / "torch_train_lm_population.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    cfg = get_config(LM_POP_ARCH)
    fresh_cfg = FreshnessConfig()          # the example's
    lock = {"worst": 0.0, "delivered": 0, "d": 0}

    def lockstep(t, pop, info, batches):
        saved = mule_agg.launches       # comparison launches do not count
        fid = info["fixed_id"]
        m = fid.shape[0]
        deliver = info["exchange"] & (fid >= 0)
        ok = accept_mask(pop["fresh"], fid, pop["t"] - pop["mule_ts"],
                         fresh_cfg) & deliver
        ids = torch.arange(LM_POP_FIXED, device=fid.device)[:, None]
        every = (torch.arange(m, device=fid.device)[None, :]
                 % LM_POP_FIXED == ids).float()
        step = (fid.clamp(min=0)[None, :] == ids).float() * ok[None].float()
        lock["delivered"] += int(ok.sum().item())
        for assign in (step, every):
            a, ma = masked_group_mean(pop["mule_models"], assign,
                                      backend="auto")
            lock["d"] = sum(v[0].numel() for v in a.values())
            b, mb = masked_group_mean(pop["mule_models"], assign,
                                      backend="ref")
            if not torch.equal(ma, mb):
                raise AssertionError("LM population: masses differ")
            lock["worst"] = max([lock["worst"]] + [
                (a[k] - b[k]).abs().max().item() for k in a])
            del a, b
        mule_agg.launches = saved

    torch.cuda.reset_peak_memory_stats()
    mule_agg.launches = slstm_scan.launches = 0
    out = example.lm_population(
        cfg, steps=LM_POP_STEPS, seq=LM_POP_SEQ, batch=LM_POP_BATCH,
        n_fixed=LM_POP_FIXED, n_mules=LM_POP_MULES, eval_every=10 ** 9,
        device="cuda", seed=SEED, on_step=lockstep,
        log=lambda m: print(f"  {m}"))
    torch.cuda.synchronize()
    got = {"mule_agg": mule_agg.launches, "slstm_scan": slstm_scan.launches}
    peak = torch.cuda.max_memory_allocated()
    want = {"mule_agg": LM_POP_STEPS,
            "slstm_scan": LM_POP_STEPS * cfg.n_layers // 2}
    if got != want:
        raise AssertionError(f"LM population: launches {got}, expected "
                             f"{want} (one mule_agg a step, one slstm_scan "
                             f"a layer a step for all fixed devices)")
    pop = out["pop"]
    with torch.no_grad():
        losses = [out["loss"]({k: v[f] for k, v in
                               pop["fixed_models"].items()},
                              out["data"][f, :LM_POP_BATCH]).item()
                  for f in range(LM_POP_FIXED)]
    if not (all(math.isfinite(x) for x in losses) and all(
            bool(torch.isfinite(v).all())
            for side in ("mule_models", "fixed_models")
            for v in pop[side].values())):
        raise AssertionError(f"LM population: non-finite weights or losses "
                             f"{losses}")
    walls = out["step_s"]
    print(f"LM population: {LM_POP_FIXED} fixed + {LM_POP_MULES} mule "
          f"{cfg.name} models at full width (D = {lock['d']} a model), "
          f"seq {LM_POP_SEQ}, batch {LM_POP_BATCH}, T={LM_POP_STEPS}: "
          f"{(len(walls) - 1) / sum(walls[1:]):.3f} steps/s after the "
          f"first step (step walls {[round(x, 3) for x in walls]} s; the "
          f"first warms cuBLAS and the allocator), peak memory {peak} "
          f"B, launches {got}; per-space loss after {losses}; aggregation "
          f"in lockstep with agg_backend='ref' ({lock['delivered']} "
          f"deliveries, and every mule delivered) max diff "
          f"{lock['worst']:.3e} (tol {LOCKSTEP_ATOL}) [{card}]")
    if not lock["worst"] <= LOCKSTEP_ATOL:
        raise AssertionError("LM population: mule_agg and the plain "
                             "aggregation disagree")
    d = lock["d"]
    del out, pop
    gc.collect()
    torch.cuda.empty_cache()
    # mule_agg at the population's shape, beside torch.matmul and its bound
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 11)
    entry = _mule_agg_timing(g, LM_POP_FIXED, LM_POP_MULES, d,
                             f"{cfg.name} population", torch.float32, card,
                             reps=5)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"LM population: phase wall {time.perf_counter() - t_phase:.1f} s")
    return {f"{cfg.name} population": got}, entry


class _MoeRoutes:
    """Records what every MoE layer call routes, through the module's own
    functions (a test-side hook, not a model option): each call's top-k
    experts and top-(k+1) probabilities (``moe._route``), its count of
    dropped slots and each expert's kept slots (``moe._route_and_group``);
    with ``keep_input``, the first call's token input and router."""

    def __init__(self, keep_input: bool = False):
        self.top_e, self.top_p, self.dropped, self.kept = [], [], [], []
        self.keep_input, self.first = keep_input, None

    def __enter__(self):
        import torch
        from repro_torch.models import moe as moe_lib
        self._real = (moe_lib._route, moe_lib._route_and_group)
        real_route, real_group = self._real

        def route(xt, router, cfg):
            probs, top_p, top_e, aux = real_route(xt, router, cfg)
            self.top_e.append(torch.sort(top_e, dim=-1).values)
            self.top_p.append(torch.topk(probs, cfg.top_k + 1,
                                         dim=-1).values)
            return probs, top_p, top_e, aux

        def route_and_group(xt, router, cfg, capacity):
            if self.keep_input and self.first is None:
                self.first = (xt.clone(), router, capacity)
            out = real_group(xt, router, cfg, capacity)
            dest = out[1]
            keep = dest < cfg.n_experts * capacity
            self.dropped.append(int((~keep).sum()))
            self.kept.append(torch.bincount(dest[keep] // capacity,
                                            minlength=cfg.n_experts))
            return out

        moe_lib._route, moe_lib._route_and_group = route, route_and_group
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as moe_lib
        moe_lib._route, moe_lib._route_and_group = self._real
        return False


def _route_flips(auto: "_MoeRoutes", ref: "_MoeRoutes", b: int, s: int):
    """The layers' routes of two runs of one [b, s] prefill compared: every
    flip (layer, row, position, gap of the k-th over the (k+1)-th
    probability relative to the k-th, in the ref run), whether it is a
    first flip, and the mask [b, s] of the positions no flip can reach."""
    import torch
    reach = torch.full((b,), s, dtype=torch.long, device="cuda")
    pos = torch.arange(s, device="cuda")
    flips = []
    for layer, (ea, er, pr) in enumerate(zip(auto.top_e, ref.top_e,
                                             ref.top_p)):
        differ = (ea != er).any(-1).reshape(b, s)
        if not bool(differ.any()):
            continue
        first = differ & (pos[None] < reach[:, None])
        k = pr.shape[-1] - 1
        gap = ((pr[:, k - 1] - pr[:, k]) / pr[:, k - 1]).reshape(b, s)
        at_rows, at_pos = differ.nonzero().unbind(1)
        flips += [(layer, row, p, g, f) for row, p, g, f in zip(
            at_rows.tolist(), at_pos.tolist(),
            gap[at_rows, at_pos].tolist(), first[at_rows, at_pos].tolist())]
        at = torch.where(differ, pos[None], s).amin(1)
        reach = torch.minimum(reach, at)
    return flips, pos[None] < reach[:, None]


def _moe_split(rec: "_MoeRoutes", params, cfg, layers: int,
               card: str) -> dict:
    """One MoE layer of the bf16 prefill, piece by piece on the first
    layer's own input (CUDA events, median): the router and top-k, the
    dispatch (sort, search, scatter, gather), the expert GEMMs and the
    un-group; each times ``layers`` is that piece's share of a prefill."""
    import torch
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.attention import compute_dtype_of
    xt, router, cap = rec.first
    p = params["stages"][0]
    dt = compute_dtype_of(cfg)
    wg, wu, wo = (p["moe"][n][0].to(dt) for n in ("wi_gate", "wi_up", "wo"))
    t, d = xt.shape
    grouped, dest, st, sw, _ = moe_lib._route_and_group(xt, router, cfg, cap)
    out_g = moe_lib._expert_ffn(grouped, wg, wu, wo, cfg.act)
    # the un-group sums each token's slots in a fixed order (no atomics)
    if not torch.equal(moe_lib._ungroup(out_g, dest, st, sw, t, d),
                       moe_lib._ungroup(out_g, dest, st, sw, t, d)):
        raise AssertionError("two replays of the un-group differ")
    ms = {
        "router and top-k": _median_ms(
            lambda: moe_lib._route(xt, router, cfg), reps=10),
        "route and dispatch": _median_ms(
            lambda: moe_lib._route_and_group(xt, router, cfg, cap), reps=10),
        "expert GEMMs": _median_ms(
            lambda: moe_lib._expert_ffn(grouped, wg, wu, wo, cfg.act),
            reps=10),
        "un-group": _median_ms(
            lambda: moe_lib._ungroup(out_g, dest, st, sw, t, d), reps=10),
    }
    ms["dispatch (sort, search, scatter, gather)"] = \
        ms["route and dispatch"] - ms["router and top-k"]
    e, f, k = cfg.n_experts, cfg.d_ff, cfg.top_k
    flop = 2 * 3 * e * cap * d * f
    print(f"moe layer split at the prefill's layer input (xt [{t}, {d}] "
          f"{str(xt.dtype).split('.')[1]}, {e} experts x {cap} slots, "
          f"top-{k}), ms a layer and x{layers} a prefill: "
          + ", ".join(f"{name} {v:.4f} ({v * layers:.2f})"
                      for name, v in ms.items() if name
                      != "route and dispatch")
          + f"; the expert GEMMs {flop / ms['expert GEMMs'] / 1e9:.1f} "
          f"TFLOP/s on {flop} FLOP (slots padded to the capacity) [{card}]")
    return ms


def _moe_vs_ref(cfg32, params, batch, card: str) -> None:
    """The drop-free f32 prefill of ``batch`` through the kernel against
    backend="ref", route by route: every flip printed with its gap, a first
    flip at MOE_FLIP_GAP_REL or more fails, the rows no flip can reach held
    to REF_PREFILL_TOL."""
    import torch
    from repro_torch.models import build_model
    b, s = batch["tokens"].shape
    expect = _flash_counts(cfg32.n_layers, 0)
    _zero_counts(expect)
    with torch.no_grad():
        with _MoeRoutes() as ra:
            got, aux = build_model(cfg32).forward(params, batch)
        launches = _counts(expect)
        with _MoeRoutes() as rr:
            want, aux_r = build_model(cfg32, backend="ref").forward(params,
                                                                    batch)
    if launches != {name: n for name, (_, _, n) in expect.items()}:
        raise AssertionError(f"the f32 prefill launched {launches}")
    if sum(ra.dropped) or sum(rr.dropped):
        raise AssertionError("the drop-free prefill dropped slots")
    flips, held = _route_flips(ra, rr, b, s)
    diff = (got - want).abs().amax(-1)
    err = diff[held].max().item()
    rest = diff[~held].max().item() if bool((~held).any()) else 0.0
    bad = [f for f in flips if f[4] and not f[3] < MOE_FLIP_GAP_REL]
    for layer, row, p, gap, first in flips[:40]:
        print(f"  route flip: layer {layer}, row {row}, position {p}, gap "
              f"{gap:.3e} of the k-th probability "
              f"({'first' if first else 'after an earlier flip'})")
    print(f"moe {cfg32.name} f32 drop-free prefill {b} x {s} through the "
          f"kernel ({launches}) vs backend='ref': {len(flips)} route flips "
          f"({sum(f[4] for f in flips)} first), {int(held.sum())} of "
          f"{held.numel()} rows no flip reaches, max diff there {err:.3e} "
          f"(tol {REF_PREFILL_TOL}), on the other rows {rest:.3e}; logits up "
          f"to {want.abs().max().item():.3f}; aux {aux.item():.6f} / "
          f"{aux_r.item():.6f} [{card}]")
    if bad:
        raise AssertionError(f"route flips at gaps of {MOE_FLIP_GAP_REL} or "
                             f"more: {bad}")
    if not err <= REF_PREFILL_TOL:
        raise AssertionError("the f32 prefill through the kernel and "
                             "through the plain version disagree")


def _wide_layers(arch: str, card: str,
                 expect_params: Optional[int] = None) -> dict:
    """``arch`` at full width with WIDE_LAYERS layers: the bf16 prefill on
    PREFILL_B x PREFILL_S tokens (a MoE model at its capacity factor) with
    every attention launch on the tensor cores, and a profile; the f32 copy
    through the kernel against backend="ref" (a MoE model drop-free on
    WIDE_MOE_S tokens a row, route by route) and decode against forward.
    A vision-language model's PREFILL_S positions are its vision prefix
    (0.1 x normal rows) and PREFILL_S - vision_tokens tokens; its decode is
    held to its text-only copy. With ``expect_params``, the parameter count
    at WIDE_LAYERS layers must equal it. Returns the prefill's launches."""
    import gc
    import torch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    cfg, model, params, gen, n_params = _init_lm(arch, WIDE_LAYERS)
    if expect_params is not None and n_params != expect_params:
        raise AssertionError(f"{arch}: {n_params} parameters at "
                             f"{WIDE_LAYERS} layers, expected "
                             f"{expect_params}")
    layers = cfg.n_layers
    prefill = make_prefill_step(model)
    batch = {"tokens": torch.randint(
        0, cfg.vocab, (PREFILL_B, PREFILL_S - cfg.vision_tokens),
        device="cuda", generator=gen)}
    if cfg.family == "vlm":
        batch["vision_embed"] = 0.1 * torch.randn(
            (PREFILL_B, cfg.vision_tokens, cfg.d_model), device="cuda",
            generator=gen)
    with _MoeRoutes(keep_input=True) as rec:
        prefill(params, batch)                       # warm-up
    if len(rec.dropped) != (layers if cfg.n_experts else 0):
        raise AssertionError(f"{arch}: {len(rec.dropped)} MoE layer calls "
                             f"in a prefill")
    if cfg.n_experts:
        print(f"moe prefill {cfg.name}: capacity {rec.first[2]} slots an "
              f"expert (factor {cfg.capacity_factor}) for "
              f"{PREFILL_B * PREFILL_S} tokens x top-{cfg.top_k}; dropped "
              f"slots per layer {rec.dropped} (of "
              f"{PREFILL_B * PREFILL_S * cfg.top_k}) [{card}]")
    launches = _counted_prefill(prefill, params, batch, cfg,
                                _flash_counts(layers, layers), card)
    _profile_steps(lambda: prefill(params, batch), 1, f"{cfg.name} prefill",
                   FLASH_PROFILE)
    if cfg.n_experts:
        _moe_split(rec, params, cfg, layers, card)
        del rec
        cfg32 = dataclasses.replace(
            cfg, dtype="float32",
            capacity_factor=float(cfg.n_experts) / cfg.top_k)
        _moe_vs_ref(cfg32, params,
                    {"tokens": batch["tokens"][:, :WIDE_MOE_S]}, card)
        _decode_consistency(cfg32, build_model(cfg32), params, gen)
    else:
        del rec
        _f32_checks(cfg, params, batch, gen, REF_PREFILL_TOL,
                    _flash_counts(layers, 0))
    del params, model, prefill
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{cfg.name} at full width, {layers} layers: "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def phase_moe(card: str) -> dict:
    """Phase 20: granite-moe-1b-a400m at full width through the serving
    and training entry points; qwen3-moe-235b-a22b, granite-34b and
    qwen2.5-32b at full width and WIDE_LAYERS layers. Returns {path:
    {kernel: launches}}."""
    import dataclasses as dc
    import gc
    import tempfile
    import numpy as np
    import torch
    from repro_torch.checkpoint import latest_checkpoint, restore_checkpoint
    from repro_torch.interop import tree_leaves
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.models.api import _layers
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    paths = {}
    cfg, model, params, gen, n_params = _init_lm(MOE_ARCH)
    if n_params != MOE_PARAMS:
        raise AssertionError(f"{MOE_ARCH}: {n_params} parameters, expected "
                             f"{MOE_PARAMS}")
    layers = cfg.n_layers

    # (a) the bf16 prefill at the config's capacity factor
    prefill = make_prefill_step(model)
    batch = {"tokens": torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                                     device="cuda", generator=gen)}
    with _MoeRoutes(keep_input=True) as rec:
        prefill(params, batch)                       # warm-up
    if len(rec.dropped) != layers:
        raise AssertionError(f"{MOE_ARCH}: {len(rec.dropped)} MoE layer "
                             f"calls in a prefill, expected {layers}")
    cap = rec.first[2]
    print(f"moe prefill {MOE_ARCH}: capacity {cap} slots an expert "
          f"(factor {cfg.capacity_factor}) for {PREFILL_B * PREFILL_S} "
          f"tokens x top-{cfg.top_k}; dropped slots per layer "
          f"{rec.dropped} (of {PREFILL_B * PREFILL_S * cfg.top_k}) [{card}]")
    launches = _counted_prefill(prefill, params, batch, cfg,
                                _flash_counts(layers, layers), card)
    paths[f"{MOE_ARCH} prefill"] = launches
    with torch.no_grad():
        if not torch.equal(prefill(params, batch), prefill(params, batch)):
            raise AssertionError(f"{MOE_ARCH}: two replays of the prefill "
                                 f"differ")
    print(f"moe prefill {MOE_ARCH}: two replays bitwise equal (the "
          f"un-group sums each token's slots in a fixed order) [{card}]")
    _profile_steps(lambda: prefill(params, batch), 1, f"{MOE_ARCH} prefill",
                   FLASH_PROFILE)
    _moe_split(rec, params, cfg, layers, card)
    del rec

    # (b) decode through the serving loop at its defaults
    _serve_generate(model, params, cfg, gen, card)

    # (c) the f32 drop-free copy: the prefill through the kernel against
    # backend="ref", route by route; then decode against forward
    cfg32 = dc.replace(cfg, dtype="float32",
                       capacity_factor=float(cfg.n_experts) / cfg.top_k)
    model32 = build_model(cfg32)
    _moe_vs_ref(cfg32, params, batch, card)
    _decode_consistency(cfg32, model32, params, gen)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (d) training: the f32 gradient through the kernels against
    # backend="ref", then Adam steps in bf16 through launch/train.py
    rng = np.random.default_rng(SEED)
    gen.manual_seed(SEED)
    cfg32 = dc.replace(cfg, dtype="float32")
    params = build_model(cfg32).init(gen)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (GRAD_BATCH,
                                                       TRAIN_SEQ)),
                           device="cuda")

    # the routes of this batch (the same forward as the gradient's): an
    # expert that no token reaches has no gradient, in the reference too
    with torch.no_grad(), _MoeRoutes() as routes:
        build_model(cfg32).forward(params, {"tokens": toks})
    reached = [c > 0 for c in routes.kept]

    def every_expert(grads):
        for li, lp in enumerate(_layers(model.program[0],
                                        grads["stages"][0])):
            for name, g in lp["moe"].items():
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"{MOE_ARCH} layer {li} {name}: "
                                         f"a gradient is not finite")
                # the router's column of every expert (through the softmax
                # and the aux loss), each reached expert's weights
                nonzero = g.abs().amax(0) > 0 if name == "router" else \
                    g.flatten(1).abs().amax(1) > 0
                want = torch.ones_like(nonzero) if name == "router" else \
                    reached[li]
                if not torch.equal(nonzero, want):
                    raise AssertionError(
                        f"{MOE_ARCH} layer {li} {name}: experts with a "
                        f"non-zero gradient {nonzero.int().tolist()}, "
                        f"reached by a token {want.int().tolist()}")
        print(f"training {MOE_ARCH}: every layer's router has a finite, "
              f"non-zero gradient for all {cfg.n_experts} experts, and "
              f"each expert has one exactly where a token reaches it; "
              f"experts no token reaches, by layer: "
              f"{[int((~r).sum()) for r in reached]}; dropped slots "
              f"{routes.dropped} of {GRAD_BATCH * TRAIN_SEQ * cfg.top_k}")

    _grad_check(f"training {MOE_ARCH} ({layers} layers, {n_params} "
                f"parameters) gradient", cfg32, params, toks,
                _flash_counts(layers, 0), card, check_tree=every_expert)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    expect = _flash_counts(TRAIN_STEPS * layers, TRAIN_STEPS * layers)
    with tempfile.TemporaryDirectory() as ck:
        ttrain.train(cfg, steps=1, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     device="cuda", log=lambda *_: None)          # warm-up
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(expect)
        out = ttrain.train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                           seq=TRAIN_SEQ, ckpt_dir=ck,
                           ckpt_every=TRAIN_STEPS, device="cuda",
                           log=lambda m: print(f"  {m}"))
        torch.cuda.synchronize()
        got = _counts(expect)
        peak = torch.cuda.max_memory_allocated()
        losses, auxes, times = out["losses"], out["aux"], out["step_s"]
        if got != {k: v[2] for k, v in expect.items()}:
            raise AssertionError(f"training {MOE_ARCH}: launches {got}, "
                                 f"expected {layers} a step, all on the "
                                 f"tensor cores")
        if not (all(math.isfinite(x) for x in losses + auxes)
                and losses[-1] < losses[0] and min(auxes) > 0):
            raise AssertionError(f"training {MOE_ARCH}: losses {losses}, "
                                 f"aux {auxes}")
        back, meta = restore_checkpoint(latest_checkpoint(ck),
                                        out["params"])
        if meta.get("step") != TRAIN_STEPS or not all(
                torch.equal(a, b) for a, b in zip(
                    tree_leaves(back), tree_leaves(out["params"]))):
            raise AssertionError(f"training {MOE_ARCH}: the checkpoint did "
                                 f"not restore bitwise")
        del back, out
    rate = TRAIN_STEPS / sum(times)
    print(f"training {MOE_ARCH}: {TRAIN_STEPS} Adam steps (bf16 compute, "
          f"f32 weights, batch {TRAIN_BATCH} x {TRAIN_SEQ}): {rate:.3f} "
          f"steps/s, {rate * TRAIN_BATCH * TRAIN_SEQ:.1f} tokens/s (step "
          f"walls {[round(x, 4) for x in times]} s), losses "
          f"{[round(x, 4) for x in losses]}, aux (the load-balance term, "
          f"x0.01 in the loss) {[round(x, 4) for x in auxes]}, peak memory "
          f"{peak} B; flash_attention {got['flash_attention'] // TRAIN_STEPS}"
          f" a step ({got['flash_attention tc'] // TRAIN_STEPS} tensor-core);"
          f" the checkpoint restored bitwise [{card}]")
    paths[f"{MOE_ARCH} training"] = got
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the models whose whole depth does not fit one card, at full
    # width and WIDE_LAYERS layers
    for arch in WIDE_ARCHS:
        paths[f"{arch} prefill ({WIDE_LAYERS} layers)"] = _wide_layers(arch,
                                                                       card)
    print(f"moe: phase wall {time.perf_counter() - t_phase:.1f} s")
    return paths


def phase_audio_vision(card: str) -> dict:
    """Phase 21: whisper-base whole through the serving and training entry
    points (its encoder's bidirectional and its decoder's causal
    self-attention on the tensor cores, cross-attention on the plain
    version), then qwen2-vl-72b at full width and WIDE_LAYERS layers (the
    vision prefix, M-RoPE). Returns {path: {kernel: launches}}."""
    import dataclasses as dc
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.models.layers import rope_angles
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    paths = {}
    last = [t_phase]

    def lap(what: str) -> None:
        now = time.perf_counter()
        print(f"audio and vision: {what} {now - last[0]:.1f} s")
        last[0] = now

    # (a) whisper-base: the bf16 prefill, its 12 self-attention layers on
    # the tensor cores (cross-attention launches nothing)
    cfg, model, params, gen, n_params = _init_lm(AUDIO_ARCH)
    if n_params != AUDIO_PARAMS:
        raise AssertionError(f"{AUDIO_ARCH}: {n_params} parameters, "
                             f"expected {AUDIO_PARAMS}")
    layers = cfg.encoder_layers + cfg.n_layers
    prefill = make_prefill_step(model)
    batch = {"tokens": torch.randint(0, cfg.vocab, (AUDIO_B, AUDIO_S),
                                     device="cuda", generator=gen),
             "audio_embed": _frames(cfg, AUDIO_B, gen)}
    prefill(params, batch)                           # warm-up
    paths[f"{AUDIO_ARCH} prefill"] = _counted_prefill(
        prefill, params, batch, cfg, _flash_counts(layers, layers), card)
    _profile_steps(lambda: prefill(params, batch), 1,
                   f"{AUDIO_ARCH} prefill", FLASH_PROFILE)
    lap(f"{AUDIO_ARCH} prefill and its profile")
    # decode through the serving loop (the frames encoded into the cache
    # first); the f32 copy through the kernel (SIMT) against
    # backend="ref", then decode against forward
    _serve_generate(model, params, cfg, gen, card)
    lap(f"{AUDIO_ARCH} decode and its profile")
    _f32_checks(cfg, params, batch, gen, REF_PREFILL_TOL,
                _flash_counts(layers, 0))
    lap(f"{AUDIO_ARCH} f32 checks")
    del params, model, prefill, batch
    gc.collect()
    torch.cuda.empty_cache()

    # training: the f32 gradient through the kernels (the encoder's
    # bidirectional calls among them) against backend="ref", then Adam
    # steps in bf16 through launch/train.py with its zero frames
    rng = np.random.default_rng(SEED)
    gen.manual_seed(SEED)
    cfg32 = dc.replace(cfg, dtype="float32")
    params = build_model(cfg32).init(gen)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (GRAD_BATCH,
                                                       TRAIN_SEQ)),
                           device="cuda")
    _grad_check(f"training {AUDIO_ARCH} ({cfg.encoder_layers} + "
                f"{cfg.n_layers} layers, {n_params} parameters) gradient",
                cfg32, params, toks, _flash_counts(layers, 0), card,
                extra={"audio_embed": _frames(cfg, GRAD_BATCH, gen)})
    lap(f"{AUDIO_ARCH} gradient check")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    expect = _flash_counts(TRAIN_STEPS * layers, TRAIN_STEPS * layers)
    ttrain.train(cfg, steps=1, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                 device="cuda", log=lambda *_: None)          # warm-up
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(expect)
    out = ttrain.train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                       seq=TRAIN_SEQ, device="cuda",
                       log=lambda m: print(f"  {m}"))
    torch.cuda.synchronize()
    got = _counts(expect)
    peak = torch.cuda.max_memory_allocated()
    losses, times = out["losses"], out["step_s"]
    del out
    if got != {k: v[2] for k, v in expect.items()}:
        raise AssertionError(f"training {AUDIO_ARCH}: launches {got}, "
                             f"expected {layers} a step, all on the tensor "
                             f"cores")
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"training {AUDIO_ARCH}: losses {losses}")
    rate = TRAIN_STEPS / sum(times)
    print(f"training {AUDIO_ARCH}: {TRAIN_STEPS} Adam steps (bf16 compute, "
          f"f32 weights, batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens and "
          f"{cfg.encoder_seq} zero frames): {rate:.3f} steps/s, "
          f"{rate * TRAIN_BATCH * TRAIN_SEQ:.1f} tokens/s (step walls "
          f"{[round(x, 4) for x in times]} s), losses "
          f"{[round(x, 4) for x in losses]}, peak memory {peak} B; "
          f"flash_attention {got['flash_attention'] // TRAIN_STEPS} a step "
          f"({got['flash_attention tc'] // TRAIN_STEPS} tensor-core) "
          f"[{card}]")
    paths[f"{AUDIO_ARCH} training"] = got
    gc.collect()
    torch.cuda.empty_cache()
    lap(f"{AUDIO_ARCH} training")

    # (b) qwen2-vl-72b at full width, WIDE_LAYERS layers: M-RoPE with three
    # equal streams is plain RoPE bit for bit on the card; the prefill with
    # its vision prefix, the f32 copy, decode through the text-only copy
    vcfg = get_config(VISION_ARCH)
    pos = torch.arange(PREFILL_S, dtype=torch.int32,
                       device="cuda")[None].expand(PREFILL_B, PREFILL_S)
    hd = vcfg.resolved_head_dim
    same = torch.equal(
        rope_angles(pos[None].expand(3, PREFILL_B, PREFILL_S), hd,
                    vcfg.rope_theta, vcfg.mrope_sections),
        rope_angles(pos, hd, vcfg.rope_theta))
    print(f"{VISION_ARCH} M-RoPE {vcfg.mrope_sections} with three equal "
          f"streams [3, {PREFILL_B}, {PREFILL_S}] vs plain RoPE on the card: "
          f"{'bitwise equal' if same else 'DIFFERENT'} [{card}]")
    if not same:
        raise AssertionError("M-RoPE with equal streams is not plain RoPE")
    paths[f"{VISION_ARCH} prefill ({WIDE_LAYERS} layers)"] = _wide_layers(
        VISION_ARCH, card, expect_params=VISION_PARAMS)
    lap(VISION_ARCH)
    print(f"audio and vision: phase wall {time.perf_counter() - t_phase:.1f}"
          f" s")
    return paths


def _profile_steps(fn, n_steps: int, label: str,
                   parts: Optional[dict] = None) -> None:
    """Device time by kernel, and the device's busy share, over one short
    run of a path (torch.profiler); with ``parts`` ({label: substring of
    kernel names}), the summed time of the kernels each part names. Only
    the device is traced: every reading is of kernels, and tracing the
    host's operators too slowed a launch-bound run under the profiler
    about twofold (Whisper's prefill on the H100: 102.9 ms against 56.3
    unprofiled) and took seconds to process."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        # kernels only: an operator's row repeats its kernels' time
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            rows.append((us, ev.key, ev.count))
    rows.sort(reverse=True)
    summed = sum(r[0] for r in rows)
    # kernels can overlap (cuDNN issues grouped convolutions as concurrent
    # per-group kernels), so the busy time is the union of their intervals
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    print(f"profile of {n_steps} {label} steps: wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), "
          f"kernel time summed {summed / 1e3:.3f} ms, "
          f"{sum(r[2] for r in rows)} kernel launches")
    for us, key, count in rows[:12]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / summed:5.1f}%  x{count:<5d} "
              f"{key[:90]}")
    for part, needle in (parts or {}).items():
        mine = [r for r in rows if needle in r[1]]
        us = sum(r[0] for r in mine)
        print(f"  {part} ({sum(r[2] for r in mine)} launches of kernels "
              f"named *{needle}*): {us / 1e3:.3f} ms, "
              f"{100 * us / summed:.1f}% of the kernel time")


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke.py needs the repository around it: no "
              f"src/repro_torch under {ROOT}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if sys.argv[1:2] == ["--ring-rank"]:
        ring_rank(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--dist-rank"]:
        dist_rank(sys.argv[2])
        return 0
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t_start = time.perf_counter()
    marks = []          # (phase, the time it began)

    def enter(name: str) -> str:
        marks.append((name, time.perf_counter()))
        return name

    phase = enter("card")
    try:
        card = phase_card()
        phase = enter("build")
        phase_build()
        phase = enter("kernels")
        rows = [phase_mule_agg(card), phase_encounter_mix(),
                phase_encounter_hop(card), phase_flash_attention(card),
                phase_ssd_scan(card), phase_slstm_scan(card)]
        lanes = phase_lanes()
        rows[0]["lanes"] = lanes["mule_agg"]
        rows[1]["lanes"] = lanes["encounter_mix"]
        phase_kernel_grads(card)
        # each path: {kernel: launches in its counted run}
        paths = {}
        phase = enter("main path")
        paths["mlmule on commuter"] = phase_main_path(card)
        phase = enter("peer path")
        paths["gossip on random_walk"] = phase_peer_path(card)
        phase = enter("lm serve")
        paths[f"{LM_ARCH} prefill"] = phase_lm_serve(card)
        phase = enter("hybrid serve")
        paths[f"{HYBRID_ARCH} prefill"] = phase_hybrid_serve(card)
        phase = enter("xlstm serve")
        paths[f"{XLSTM_ARCH} prefill"] = phase_xlstm_serve(card)
        phase = enter("ring path")
        paths[f"gossip on the {RING_RANKS}-rank ring"] = \
            phase_ring_path(card)
        phase = enter("Table 1 fixed path")
        paths["Table 1 fixed path"] = phase_fixed_path(card)
        phase = enter("HAR path")
        paths["HAR on har_commuter"] = phase_har_path(card)
        phase = enter("multi-area path")
        paths.update(phase_multi_area(card))
        phase = enter("sweep")
        paths.update(phase_sweep(card))
        phase = enter("streamed path")
        paths.update(phase_streamed_path(card))
        phase = enter("population scale")
        scale_paths, scale_entry = phase_scale(card)
        paths.update(scale_paths)
        rows[0]["cases"].append(scale_entry)
        phase = enter("distributed path and sweep")
        paths.update(phase_distributed(card))
        phase = enter("training")
        paths.update(phase_training(card))
        phase = enter("LM population")
        pop_paths, pop_entry = phase_lm_population(card)
        paths.update(pop_paths)
        rows[0]["cases"].append(pop_entry)
        phase = enter("mixture-of-experts")
        paths.update(phase_moe(card))
        phase = enter("audio and vision")
        paths.update(phase_audio_vision(card))
    except Exception:
        traceback.print_exc()
        print(f"FAILED in phase: {phase}", file=sys.stderr)
        return 1
    for row in rows:
        by_path = {p: c[row["name"]] for p, c in paths.items()
                   if row["name"] in c}
        # the count of the path whose shape the row is timed at
        row["launches"] = next(iter(by_path.values()))
        if len(by_path) > 1:
            row["launches_by_path"] = by_path
        tc = {p: c[row["name"] + " tc"] for p, c in paths.items()
              if row["name"] + " tc" in c}
        if tc:      # the launches that took the tensor-core route
            row["tc_launches_by_path"] = tc
        # a row whose function no single PyTorch call computes may have
        # library_ms null, and then says why under "library"
        needed = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms")
        if not (row.get("library") and row["library_ms"] is None):
            needed += ("library_ms",)
        if not all(isinstance(row[k], (int, float)) and math.isfinite(row[k])
                   for k in needed):
            print(f"incomplete kernel row {row}", file=sys.stderr)
            return 1
    ends = [t for _, t in marks[1:]] + [time.perf_counter()]
    print("chip_smoke.py: seconds by phase " + json.dumps(
        {name: round(end - t, 1) for (name, t), end in zip(marks, ends)}))
    print(f"chip_smoke.py: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
