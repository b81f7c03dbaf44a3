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
   f64-sLSTM copy), and decode against forward; last, at the scan's own
   output, for two seeds at the prefill's sLSTM shape, ``slstm_scan``'s
   RMS distance from the f64 scan at most ``XLSTM_SCAN_RMS_FACTOR`` times
   the plain f32 loop's;
9. the ring peer path: ``spawn_local_cluster`` starts 4 ranks on the one
   card, joined over gloo; each holds its 64-mule block of phase 5's walk,
   bucket-ordered by area (T = 12), at the paper CNN's full width, and runs
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
   30 pretraining steps, T = 60 (6 federated rounds of 2 local steps), an
   eval every 20 steps. ``mule_agg`` must launch 60 times for ``mlmule``
   and never for the other four; every accuracy finite and in [0, 1],
   every weight finite. ``mlmule`` is replayed bitwise, with
   ``agg_backend="ref"`` under phase 4's growth bound, and its exchange
   and aggregation are held in lockstep (training off) to fp32 order;
   FedAS's server model keeps its personal leaves bitwise; CFL's clusters
   partition the 8 clients and each client holds its cluster's model
   bitwise. Then ``run_experiment`` at the harness's reduced defaults for
   each method, T = 10;
11. the HAR path (Fig 8): ``mlmule`` and ``gossip`` on ``har_commuter``
   through ``run_with_models`` handed the LSTM-CNN at full width (window
   128, 6 channels, conv 32/64, LSTM 64, 4 classes), M = 256, F = 8, batch
   12, lr 0.03, T = 21 (cut from 60), an eval every 20 steps, 30
   pretraining steps a device (the harness's 120, cut).
   ``mule_agg`` must launch 21 times for ``mlmule``; ``encounter_mix`` 7
   times and ``mule_agg`` never for ``gossip``. Both are replayed bitwise and against their plain
   backend under the growth bound of phases 4 and 5, ``mlmule``'s
   aggregation and ``gossip``'s mix held in lockstep; each prints steps/s,
   peak memory, its accuracy trace and a profile. Then
   ``run_experiment(task="har")`` at its defaults for the five
   ``METHODS_MOBILE``, T = 10, 30 pretraining steps;
12. the multi-area path: ``mlmule`` and ``gossip`` on ``multi_area_3city``
   (12 fixed devices in 3 cities) and ``gossip`` on
   ``multi_area_migratory`` (its area a [T, M] column) at the paper CNN's
   full width, M = 256, T = 30 (60 until phase 25), an eval every 20.
   ``mule_agg`` must launch 30 times for ``mlmule`` (F = 12, the kernel's
   12-row instance), ``encounter_mix`` 10 times for ``gossip``; each run
   replayed bitwise and against its plain backend under the growth bound,
   ``gossip``'s mix
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
   30 pretraining steps,
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
   1,000,000, T = 16 (the reference's 96, cut), streamed in chunks of 8
   and through ``run_population``
   over ``materialize_generator``'s schedule: final models and
   ``last_fid`` bitwise equal, ``mule_agg`` 24 launches a run; steps/s,
   schedule bytes and peak memory of each; then ``mule_agg`` timed at
   (8, 1,000,000, 8) beside ``torch.matmul`` and its bytes bound (a
   ``cases`` entry of row 1);
16. the distributed path: ``spawn_local_cluster`` starts 4 ranks of this
   script (``--dist-rank``) on the one card over gloo, each a 64-mule
   block of phase 9's bucket-ordered walk at the CNN's full width, T = 6.
   ``run_population_distributed`` runs the five ``METHODS_MOBILE`` with the
   histogram sketch: ``mule_agg`` 30 launches a rank for ``mlmule`` and
   ``mlmule+gossip``, ``encounter_hop`` once per kept hop for the peer
   methods, ``encounter_mix`` never; every rank's replicated state
   (``fixed_models``, ``fresh``, ``t``) bitwise equal. ``mlmule`` against
   ``agg_backend="ref"``: the final weights within phase 4's growth
   bound, the aggregation in lockstep with training off within 1e-5 over
   the first 10 steps;
   ``mlmule`` with ``cross_pod=False`` on a 2 x 2 mesh. Then ``gossip`` on
   ``multi_area_migratory`` (T = 30) through the streamed distributed
   engine, re-bucketing every 10 steps: at least one swap, a permutation, the
   same drift readings on every rank, bitwise
   ``run_population_distributed(rebucket_every=10)``; steps/s, bytes sent
   a step and hops pruned before and after the swap;
17. the seed sweep over the ranks, in phase 16's world: each rank runs
   ``run_sweep_distributed`` over 4 seeds of the walk (each bucket-ordered
   by its own areas) for ``mlmule`` and ``gossip``, T = 6, then each lane
   alone through ``run_population_distributed``. One ``ordered_psum`` a
   ``mlmule`` step and one ``encounter_hop`` launch a hop that any lane
   keeps, for all lanes; every lane's replicated state bitwise on every
   rank; each lane within the growth bound of its sequential run, and
   bitwise it over 4 steps with training off (the collectives, the
   aggregation and the hops alone); the lanes' distance from their
   sequential runs with training alone (``local``, 2 steps) with cuDNN;
   lane-steps/s beside the sequential runs and the bytes a
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
   ``torch.func.vmap`` and 6 mules on the walk, seq 64, batch 4, T = 2:
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
   (1e-3), as the reference's test holds it;
22. the tooling (``repro_torch.launch``): (a) every launch candidate of the
   tuned kernels (``mule_agg``'s grid at 1/2, 1, 2, 4 waves; the sums
   kernel's two shapes times its dense switch at 4, 8, 16, 32 for
   ``encounter_mix`` and ``encounter_hop``) at the paths' shapes, each
   output bitwise the default's; (b) the tune at those shapes, each pick's
   ms beside the default's and ``tuned_speedup_vs_default`` (printed, not
   checked); (c) the committed tuning cache's picks are the launches'
   choices, and the main and peer paths run T = 6 with it and without it
   with the same launches and bits; (d) one step of the main path and one
   stablelm-1.6b training step at 4 x 128 counted (``CostCounter``) on the
   card and on ``meta``, the FLOPs equal, their roofline terms beside the
   step times phases 4 and 18 measured, the compute term at most the
   measured time; (e) the dry run's peak memory of that training step
   within 20% of phase 18's ``max_memory_allocated``; (f) the engine's
   roofline row of ``mlmule`` (M = 64, T = 24) on phase 16's 4 ranks and
   ``suggest_mesh_shape``'s pick from the committed cache;
23. the LM stack on a mesh of ranks: ``spawn_local_cluster`` starts 4
   ranks of this script (``--mesh-rank``) on the one card over gloo; each
   builds the ``(data, model)`` mesh (``launch.mesh.make_lm_mesh``) and
   granite-moe-1b-a400m whole with ``mesh=``, draws the full weights from
   the seed and keeps its experts (``launch.lm_ranks``). (a) On 2 x 2 (2
   expert-parallel peers, 16 experts a rank): a bf16 prefill of 2 x 1024
   at the config's capacity factor (each data rank 1 x 1024, 512 tokens
   and 160 slots an expert a peer) with 24 tensor-core ``flash_attention``
   launches a rank and the all-to-all bytes of a layer exactly 2 E C d x 2;
   ``serve.generate`` of 8 tokens at batch 4; 2 Adam steps at 4 x 128
   with the gradients averaged over ``data``, the update in place
   (``donate=True``) and each layer recomputed in the backward
   (``remat=True``), a falling loss, and every
   rank's replicated weights (and each model index's experts) bitwise
   equal after them. (b) The f32 drop-free copy (capacity factor E / k):
   a 2 x 256 prefill against the local path (``mesh=None``) on the same
   weights, route by route as phase 20 holds it (rows no flip reaches
   within 2e-4), and the f32 gradient of a data rank's nll (its 1 x 128
   of 2 x 128) within 2e-4 of each leaf's largest from the local path's
   on the same rows, none zero. (c) The same f32 prefill on 1 x 4 (4 peers,
   8 experts a rank) and on 4 x 1 with ``moe_ep_axis=None`` (the
   data-parallel path), each against the local path. (d)
   qwen3-moe-235b-a22b at full width with 2 layers on 1 x 4 (32 of 128
   experts a rank; the ranks draw the whole weights two at a time): a bf16
   prefill of 2 x 1024. Tokens/s, steps/s, the all-to-all bytes and each
   rank's peak memory are printed. Phase 18 also trains stablelm-1.6b
   with ``remat`` (full and "dots"): its f32 gradients at 2 x 128 bitwise
   those without, and 2 Adam steps of each at 4 x 128 beside its plain
   steps, with their peaks and the gradient's peak alone. Every rank holds
   ``launch.sharding.rank_specs``' blocks, so granite-moe's and
   qwen3-moe's attention heads split over ``model`` too, and the prefill's
   sums over ranks are exact: one all-reduce of [B, S, d] a layer (the
   attention's output) and one of the aux loss;
24. dense tensor parallelism, in phase 23's ranks (no second spawn): rank 0
   first holds ``flash_attention`` and ``ssd_scan`` against their plain
   versions at the per-rank shapes (stablelm-1.6b's 8 heads x 64 and
   zamba2-2.7b's 8 x 80 causal at 2 x 1024; the scan at 20 heads x 64, N
   64, with the last rank's A) and times them. (a) stablelm-1.6b whole in
   bf16 on 1 x 4 (8 of 32 heads, 1,408 of 5,632 FFN columns and 25,088 of
   100,352 vocabulary rows a rank): a 2 x 1024 prefill with 24 tensor-core
   ``flash_attention`` launches a rank and exactly 2 x 24 + 1 all-reduces
   of 2 x 1024 x 2048 bf16 values (attention and MLP outputs, the
   vocabulary-parallel lookup), the rank's f32 logits gathered; 8 greedy
   tokens of ``serve.generate`` at batch 2, equal on every rank; against
   one process's bf16 run on the whole weights, the prefill logits within
   ``TP_BF16_GAP`` and the tokens equal or apart first at a near tie within
   it, one process's own bf16 rounding within it too.
   (b) zamba2-2.7b at full width with 18 of its 54 layers on 1 x 4 (20 of
   80 SSM heads, 8 of 32 shared-attention heads a rank; the whole weights
   drawn two ranks at a time): the prefill with 15 ``ssd_scan`` and 3
   tensor-core ``flash_attention`` launches a rank and its all-reduces
   exact, and the
   greedy tokens as (a)'s. (c) stablelm-1.6b on 2 x 2: 2 SGD steps (lr
   0.01) at 4 x 128 with ``remat``, the step's collectives counted, every
   leaf held whole bitwise equal on all ranks after them and each split
   leaf on its data peers. (d) f32 copies with 2 layers: the 1 x 4 logits
   of stablelm-1.6b and of zamba2-2.7b (a Mamba2 layer and the shared
   attention) within 2e-4 of one process's on the same weights through the
   same kernels, their 8 greedy tokens equal one process's (or apart
   first at a near tie within 2e-4), and the 2 x 2 loss and gradient of
   stablelm-1.6b within 1e-5 and 2e-4 of each leaf's largest. Tokens/s, steps/s, each rank's
   peak and the seconds spent in the all-reduces are printed;
25. context parallelism, in phase 23's ranks too: rank 0 first holds
   ``flash_attention`` against its plain version at the per-rank shapes
   (stablelm-1.6b's 1024 queries of 32 heads against the prefix of 1024
   (r + 1) keys, right-aligned and causal, for each r of 4 x 1; 2048 of 16
   heads against 2048 (r + 1) on 2 x 2), every call tensor-core, timed
   beside SDPA with a right-aligned mask and the bound. (a) stablelm-1.6b
   whole in bf16 at batch 1, a 4096-token prompt (its context length),
   on 4 x 1 with ``seq_axis="data"`` (1024 tokens a rank) and on 2 x 2
   (2048 tokens and 16 heads a rank): the prefill with 24 tensor-core
   ``flash_attention`` launches a rank, exactly 24 K/V gathers over
   ``data`` of their bytes (and, on 2 x 2, the tensor-parallel sums and
   the logits' gather), each rank's attention ms (rank r reads r + 1
   blocks of keys) and peak; (c) decode at batch 1 from the cache split
   over ``data`` (a 24-token prompt, 8 greedy tokens: 32 slots, 8 or 16
   a rank), its bytes a rank exact, the tokens equal on every rank. (b)
   f32 copies with 2 layers on both meshes against one process on the
   same weights: the logits of 1 x 512 and the loss within 2e-4, the
   gradient (the ranks' shares summed over ``data``) within 2e-4 of each
   leaf's largest, and on 4 x 1 the greedy tokens of (c)'s decode equal
   one process's; and granite-moe-1b-a400m with 2 layers at its capacity
   factor 1.25 on 4 x 1, each MoE layer routing the whole sequence: the
   full loss and its gradient within 2e-4 of one process, the K/V and MoE
   input gathers exact. (d) 2 SGD steps of stablelm-1.6b on 2 x 2 at 1 x
   1024 with remat "dots": the gathers and sums of a step exact, the loss
   falling, every leaf held whole bitwise equal on all ranks after them and
   each split leaf on its data peers.
26. FSDP and the production meshes, in phase 23's ranks too: (a)
   stablelm-1.6b whole on 2 x 2 with ``fsdp=True`` (each leaf's block cut
   over ``data`` as well, gathered by ``collectives.gather_fsdp`` inside
   the remat body), phase 24 (c)'s seed, batch and 2 SGD steps: the losses
   and, gathered back over ``data``, the weights bitwise (c)'s on every
   rank; the parameter bytes a rank exact from the specs, the gathers and
   reduce-scatters a step exact from the shapes, 48 tensor-core
   ``flash_attention`` launches a step a rank; steps/s and the peak beside
   (c)'s. (b) The dry run's count of rank 0 of a stand-in 2 x 2 on meta
   (``launch.dryrun.count_step``, no process group) of (c)'s and (a)'s
   steps: its peak within 20% of each rank's ``max_memory_allocated``,
   its collective bytes by kind equal to the ranks' counts exactly. (c)
   The dry run's command line on the production meshes (rank 0 of 16 x 16
   and 2 x 16 x 16): stablelm-1.6b ``train_4k`` with and without
   ``--fsdp``, granite-moe-1b-a400m ``decode_32k``, gemma3-4b ``long_500k``
   with ``--sliding-variant``, every row ``ok``, printed with its peak a
   rank, ``fits_one_card``, terms and count's seconds. (b) and (c) run in
   processes started after the kernels' phases, beside the single-process
   path phases (not beside the kernels' timings, nor beside phase 23's
   ranks, whose host-side folds they would slow).
27. ``head_axis`` and the Mamba2 mixer split inside its heads, in phase
   23's ranks too: rank 0 first holds ``flash_attention`` against its
   plain version at (a)'s rank shapes (14 and 12 query heads with the kv
   heads they read) and at the whole 40 heads, every call tensor-core,
   timed beside SDPA and the bound, and ``ssd_scan`` at (b)'s sub-heads.
   (a) qwen2.5-32b at full width with 2 layers (40 heads on 8 kv heads x
   128, qkv bias, d_ff 27,648, vocab 152,064) in bf16 on a (data 1, model
   3) mesh over ranks 0-2 (a sub-group; rank 3 waits), with
   ``head_axis="model"`` (blocks of 14 / 14 / 12 heads; the MLP 9,216 and
   the vocabulary 50,688 a rank) beside ``head_axis=None`` (every rank all
   40 heads): a 2 x 1024 prefill of each with 2 tensor-core
   ``flash_attention`` launches a rank and its sums over ranks exact (2 x
   2 + 1 of [2, 1024, 5120] bf16 against 2 + 1), the logits of the two
   within ``TP_BF16_GAP``; the f32 copy at 1 x 256 within 2e-4 of one
   process; 2 SGD steps of each at 4 x 128, the losses falling and within
   ``TP_BF16_GAP`` of each other, every sum exact in count and bytes (the
   backward's one f32 sum a layer of the input and the whole attention
   weights), every whole attention leaf bitwise equal on the 3 ranks. (b)
   zamba2's smoke config with d_model 96, ssm_head_dim 64, ssm_state 64
   (and the shared attention at head dim 32) in f32 on 1 x 4: 48 channels
   a rank straddle the 3 heads and run as 3 sub-heads of 16 in one
   ``ssd_scan`` launch; the 2 x 256 prefill within 2e-4 of one process,
   8 greedy tokens equal to one process's. (c) The dry run's
   ``count_step`` on meta of rank 0 of the 16 x 16 production mesh:
   qwen2.5-32b ``prefill_32k`` and ``train_4k`` with and without
   ``head_axis`` (the attention kernel's FLOPs a rank exactly 3 / 40 of
   the whole heads'), and the dry run's command line for zamba2-2.7b at
   ``--tp 32`` (every row ``ok``), in processes started with phase 26's.
28. Context parallelism through the layers that carry state and through
   the vlm and audio families, in phase 23's ranks (``_cs_rank``, checked
   by ``phase_context_state``; alone: ``--cs-rank`` ranks started by
   ``spawn_context_state``). A ``mamba`` layer and an ``xlstm_pair``
   gather their input over ``"data"`` and scan the whole sequence on
   every rank, keeping the rank's block. Rank 0 first holds ``ssd_scan``
   at the whole gathered sequence of zamba2-2.7b's ranks ([1, 4096, 80 or
   40 heads, 64], N 64), ``slstm_scan`` at xlstm-350m's ([1, 4096, 4,
   256]) and ``flash_attention`` at the last rank's block of each case
   (zamba2 on 4 x 1 and 2 x 2, qwen2-vl-72b on 2 x 2, Whisper's decoder
   block of 112 against 448 and its encoder whole), timed beside the plain
   version, SDPA and the bound. (a) zamba2-2.7b at full width with 12
   layers (10 Mamba2, 2 shared attention): a bf16 1 x 4096 prefill with
   ``seq_axis="data"`` on 4 x 1 and 2 x 2 beside ``seq_axis=None`` on the
   same mesh and weights (10 ``ssd_scan`` and 2 tensor-core
   ``flash_attention`` launches a rank in each, the gathers exact in
   count and bytes, the logits within ``TP_BF16_GAP``, the Mamba2 mixers'
   share of a rank's device time), the f32 copy at 1 x 512 within 2e-4 of
   one process on each mesh, f32 greedy decode at batch 1 of 24 + 8
   tokens from the split cache equal to one process's, 2 SGD steps at 1 x
   1024 on 2 x 2 with remat "dots" (the gathers and reduce-scatters of a
   step exact, the whole leaves bitwise equal). (b) xlstm-350m whole, bf16
   and f32 1 x 4096 on 4 x 1 against one process: 12 ``slstm_scan`` a
   rank, the hidden state before the final norm (expected bitwise) and the
   logits (``TP_BF16_GAP``, phase 8's f32 bound). (c) qwen2-vl-72b at full
   width with 2 layers, each rank keeping its half of the 17 GB of f32
   weights drawn one rank at a time: a bf16 1 x 4096 prefill (256 vision
   rows in data rank 0's block) on 2 x 2 beside ``seq_axis=None``, the f32
   copy at 1 x 512 (data rank 0 all vision) within 2e-4 and its loss, over
   the text targets only, within 1e-5. (d) whisper-base whole: a bf16 4 x
   448 prefill over 4 x 1500 frames on 4 x 1 (112 tokens a rank, the
   encoder whole on each) against one process, the f32 copy within 2e-4,
   f32 greedy decode equal to one process's (from caches split as
   ``cache_specs`` lays them out: the self and cross slots over
   ``seq_axis``), 2 SGD steps on its first row (losses falling, the
   weights bitwise equal on every rank).
29. The decode caches as ``cache_specs`` lays them out, in phase 23's
   ranks (``_cl_rank``, checked by ``phase_cache_layout``; alone:
   ``--cl-rank`` ranks started by ``spawn_cache_layout``): every rank
   holds exactly ``cache_specs``' block of every KV cache. (a)
   granite-34b at full width with 2 layers (48 query heads on one kv head
   of 128): on 1 x 4 at batch 2 (12 query heads a rank, the kv head's
   ``head_dim`` 32 a rank) and on 2 x 2 at batch 1 (``head_dim`` 64 a
   rank, the slots over data), a 24-token prompt replayed through
   ``serve.generate`` and 8 greedy tokens, bf16 and an f32 copy: the f32
   tokens equal one process's whole-cache decode on the same weights, the
   last f32 logits within 1e-3, the cache a rank exactly a quarter of the
   whole's bytes, the sums and gathers of the 32 decode steps exact in
   count and bytes, tokens/s and the sums' seconds printed. (b)
   whisper-base whole, f32: batch 1 on 4 x 1 (self and cross slots over
   data, 375 of the 1,500 frames a rank), batch 1 on 2 x 2 (4 heads a
   rank, the slots over data), batch 4 on 1 x 4 (2 heads a rank); the
   same checks.

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
# The H100 SXM's peaks (NVIDIA's data sheet) and each kernel's work are
# src/repro_torch/launch/roofline.py's: HBM_BYTES_PER_S (3.35 TB/s),
# FP32_FLOP_PER_S (67 TFLOP/s outside the tensor cores, the kernels' FMAs),
# BF16_TENSOR_FLOP_PER_S (989 TFLOP/s dense), and mule_agg_work,
# encounter_mix_work, encounter_hop_work, flash_attention_work, ssd_work and
# slstm_work, whose Work.bound_ms is every bound line below

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
# The check at the sLSTM scan's output (phase 8), which does not ride on
# the mLSTM's amplification: at the phase's own shape (xlstm-350m's sLSTM
# on PREFILL_B x PREFILL_S, pre and r at the layer's scales) for each seed
# of XLSTM_SCAN_SEEDS, the kernel's RMS distance from the float64 scan of
# the same inputs at most XLSTM_SCAN_RMS_FACTOR times the plain f32 loop's:
# the kernel no less exact than the plain version. tools/xlstm_f64_split.py
# read the ratio at 0.954-0.957 in 12 cases (B 2, S 512-4096, three seeds;
# NVIDIA H100 80GB HBM3, 700 W), so 1.0 leaves ~4.5% of room.
XLSTM_SCAN_SEEDS = (SEED + 30, SEED + 31)
XLSTM_SCAN_RMS_FACTOR = 1.0

# encounter_hop (phase 3) and the ring peer path (phase 9): the walk of
# phase 5, bucket-ordered by area and split into RING_RANKS equal blocks of
# 64 mules, T = 12 steps (4 exchanges; cut from 30 for phases 22 and 23).
# Each hop
# is held to encounter_block as encounter_mix is (TOL), and the ring-order
# sum of the hops, normalised, to the single-host encounter_mix: both sum
# the same terms in other orders, and the normalisation divides by an
# exact count.
RING_RANKS, RING_STEPS = 4, 12
RING_MIX_TOL = 2e-5
RING_TIMEOUT = 600
# Table 1 fixed path (phase 10): the paper's 8 fixed devices and 20 mules,
# 30 pretraining steps a device (120 until phase 25, cut for its time),
# T = 60 (6 federated rounds of 2 local steps); the batch, lr, eval
# cadence, walk and CNN of phases 4 and 5
FIXED_MULES, FIXED_STEPS, FIXED_PRETRAIN = 20, 60, 30
# HAR path (phase 11): Fig 8's batch and lr (examples/har_mobile_training.py)
HAR_BATCH, HAR_LR = 12, 0.03
# local pretraining steps a device on the HAR task (phase 11's runs, its
# run_experiment defaults and phase 13's Fig 8 sweep), cut from the
# harness's 120 (at the LSTM-CNN ~90 ms a step, most of those runs' wall)
# to keep the script inside its time with phase 25
HAR_PRETRAIN = 30
# the HAR path's horizon, cut from 60 to keep the script inside its time
# with phases 17-20 (one eval, after step 19; a multiple of the peer
# cadence, 3)
HAR_STEPS = 21
# run_experiment at the harness's own defaults, T cut to this (one eval,
# after step 9; 20 until phase 27)
SHORT_STEPS = 10
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
# the multi-area path's horizon (phase 12), cut from the other paths' 60
# for phase 25 (one eval, after step 19; a multiple of the peer cadence)
MULTI_AREA_STEPS = 30
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
# streaming_commuter's procedural stream, T = 16 (the reference's horizon
# is 96; cut to 24 to keep the script inside its time with phases 17-20,
# and to 16 with phase 25) in chunks of 8
SCALE_MULES = (100_000, 1_000_000)
SCALE_D, SCALE_STEPS, SCALE_CHUNK, SCALE_BATCH, SCALE_LR = 8, 16, 8, 2, 0.05
# the distributed engine (phase 16): 4 ranks, each a 64-mule block of the
# bucket-ordered walk of phase 9 at the CNN's full width, T = 6 (cut from
# 30 for phases 22 and 23, from 12 for phase 24; at most phase 9's T, whose
# walk it runs); then
# the streamed engine on multi_area_migratory, re-bucketing every 10 steps.
# At M = 256 that schedule's drift from its build-time buckets is 0 at
# step 10 and 2 mules of 256 (0.0078) at step 20: the threshold lets the
# second check swap
DIST_RANKS, DIST_STEPS = 4, 6
# the distributed mlmule's lockstep with agg_backend="ref": the first 6
# steps (cut from 30, and from 10 for phase 24, to keep the script inside
# its time)
DIST_LOCKSTEP_STEPS = 6
REBUCKET_EVERY, REBUCKET_THRESHOLD = 10, 0.005
# the re-bucketed run keeps T = 30: at T = 24 the migratory schedule's drift
# stays under the threshold at both checks (no swap)
REBUCKET_STEPS = 30
# the seed sweep over the ranks (phase 17, in phase 16's world): S seeds of
# that walk as lanes inside each rank's block, T = 6 (cut from 30 to keep
# the script inside its time with the checks below, from 12 for phase 22
# and from 9 for phase 23)
DIST_LANES = 4
DIST_SWEEP_METHODS = ("mlmule", "gossip")
DIST_SWEEP_STEPS = 6
# its lanes against their sequential runs with training off (the
# collectives, aggregation and hops alone: bitwise; one gossip exchange)
# and with training alone (method "local", with cuDNN); 4 and 2 steps
# until phase 24
DIST_SWEEP_OFF_STEPS, DIST_LOCAL_STEPS = 3, 1
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
# the Adam steps of each remat policy (phase 18); a remat step's peak may
# pass the plain step's by at most REMAT_PEAK_SLACK (the update, not the
# activations, sets both), and one remat gradient's peak must be below the
# plain one's
REMAT_STEPS = 2
REMAT_PEAK_SLACK = 1 << 30
# the LM population (phase 19): examples/torch_train_lm_population.py's
# F 4 / M 6 with xlstm-350m at full width, T = 2 (4 until phase 20 came, 3
# until phase 23)
LM_POP_ARCH, LM_POP_STEPS, LM_POP_SEQ, LM_POP_BATCH = "xlstm-350m", 2, 64, 4
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
# the LM stack on a mesh of ranks (phase 23): granite-moe-1b-a400m whole on
# MESH_RANKS ranks of one card. (a) on 2 x 2: the bf16 prefill, decode at
# MESH_DECODE (batch, tokens) after a prompt of MESH_PROMPT, Adam steps at
# MESH_TRAIN on one batch of make_lm_dataset's streams at MESH_LR (a fixed
# batch, so the loss falls over 2 steps; 3 until phase 24); (b), (c) the f32 drop-free copy
# on 2 x MESH_F32_S tokens (each all-to-all moves the whole [E, t_ep, d]
# in f32 there, 67 MB a peer at 2 x 1024) and a data rank's gradient at
# GRAD_BATCH x TRAIN_SEQ; (d) qwen3-moe at full width with WIDE_LAYERS
# layers, a bf16 prefill of 2 x MESH_WIDE_S (decode 16 tokens and 2 x 2048
# until phase 24)
MESH_RANKS, MESH_TIMEOUT = 4, 600
MESH_PREFILL = (2, 1024)      # 2 x 4096 until phase 24, 2 x 2048 until 26
MESH_PROMPT, MESH_DECODE = 1, (4, 8)
MESH_TRAIN, MESH_TRAIN_STEPS, MESH_LR = (4, 128), 2, 1e-3
MESH_F32_S = 256
MESH_WIDE_ARCH, MESH_WIDE_S = "qwen3-moe-235b-a22b", 1024
# (a)'s drop-free f32 gradient against the local path: each leaf's largest
# gap over its largest gradient
MESH_GRAD_REL = 2e-4
# dense tensor parallelism (phase 24), in phase 23's ranks: (a) TP_ARCH
# whole in bf16 on 1 x MESH_RANKS, a TP_PREFILL prefill and TP_DECODE[1]
# greedy tokens at batch TP_DECODE[0] after a prompt of MESH_PROMPT; (b)
# TP_HYBRID_ARCH at full width, TP_HYBRID_LAYERS layers (of 54, for time:
# 15 Mamba2 layers and 3 of the shared attention),
# the same; (c) TP_ARCH on 2 x 2, TP_TRAIN_STEPS SGD steps at MESH_TRAIN
# with remat; (d) f32 copies with TP_PARITY_LAYERS layers against one
# process on the same weights: logits on 1 x 4 at 2 x TP_PARITY_S, the
# loss and gradient on 2 x 2 at GRAD_BATCH x TRAIN_SEQ (the bounds: the f32
# prefills' REF_PREFILL_TOL, LOSS_REL_TP, MESH_GRAD_REL)
TP_ARCH, TP_HYBRID_ARCH = "stablelm-1.6b", "zamba2-2.7b"
TP_PREFILL, TP_DECODE = (2, 1024), (2, 8)   # (2, 2048), (2, 16) until 26
TP_HYBRID_LAYERS = 18
TP_TRAIN_STEPS, TP_LR = 2, 0.01
TP_PARITY_LAYERS, TP_PARITY_S = 2, 256
LOSS_REL_TP = 1e-5
# (a) and (b) against one process on the whole weights, both in bf16: the
# prefill logits may differ by at most TP_BF16_GAP, and a greedy token may
# differ only at a near tie, where one process's logits put the mesh's pick
# below their top by at most TP_BF16_GAP. Each run rounds its partial sums
# to bf16 in its own order; the gap between them reads the size of one
# process's own bf16 rounding (its bf16 prefill logits against its f32
# copy's, on the same tokens and weights), which must stay within
# TP_BF16_GAP too, or the bound no longer fits the port's bf16 path.
# Readings on the H100 80GB HBM3 at 700 W, the same in every call (PERF.md
# section 6): one process's own rounding 1.8409e-01 (stablelm-1.6b) and
# 1.7333e-01 (zamba2-2.7b, 18 layers); mesh against one process 1.8280e-01
# and 1.6507e-01 (3.1263e-01 with zamba2's 54 layers); near ties
# 1.1488e-02 and 3.4327e-02 (5.4581e-02 at 54 layers).
TP_BF16_GAP = 0.25
# context parallelism (phase 25), in phase 23's ranks: (a) CP_ARCH whole in
# bf16 at batch 1, a CP_PREFILL-token prompt (stablelm-2's context length)
# on each of CP_MESHES with the sequence over "data"; (c) decode at batch 1
# from the split cache after a CP_PROMPT-token prompt, CP_GEN greedy
# tokens (32 slots: 8 a rank on 4 x 1); (b) f32 copies with
# CP_PARITY_LAYERS layers against one process on the same weights, at 1 x
# CP_PARITY_S (bounds REF_PREFILL_TOL and MESH_GRAD_REL); (d) CP_TRAIN_STEPS
# SGD steps of CP_ARCH on 2 x 2 at 1 x CP_TRAIN_S, remat "dots"
CP_ARCH = "stablelm-1.6b"
CP_MESHES = ((MESH_RANKS, 1), (2, 2))
CP_PREFILL = 4096
CP_PROMPT, CP_GEN = 24, 8       # 16 tokens until phase 26; a prompt of
                                # 48 until phase 27
CP_PARITY_LAYERS, CP_PARITY_S = 2, 512      # 1024 until phase 26
CP_TRAIN_S, CP_TRAIN_STEPS, CP_LR = 1024, 2, 0.01   # 2048 until phase 26
# (b) also holds MOE_ARCH, CP_PARITY_LAYERS layers in f32 at its config's
# capacity factor (1.25: slots drop), at 1 x CP_PARITY_S on MESH_RANKS x 1:
# each MoE layer routes the whole sequence, so the loss and the gradient
# are one process's (bounds REF_PREFILL_TOL and MESH_GRAD_REL)
# FSDP and the production meshes (phase 26), in phase 23's ranks: (a)
# TP_ARCH whole on 2 x 2 with fsdp=True, the seed, batch and SGD steps of
# phase 24 (c) (MESH_TRAIN, TP_TRAIN_STEPS, TP_LR, remat): its losses and
# its weights, gathered back, bitwise (c)'s; (b) the dry run's count of
# rank 0 of a stand-in 2 x 2 on meta against (c)'s and (a)'s ranks: the
# peak within TOOL_PEAK_GAP, the collective bytes by kind exact; (c) the
# rows FSDP_ROWS of the dry run on the production meshes, on meta
FSDP_ROWS = (("stablelm-1.6b", "train_4k", {}),
             ("stablelm-1.6b", "train_4k", {"fsdp": True}),
             ("granite-moe-1b-a400m", "decode_32k", {}),
             ("gemma3-4b", "long_500k", {"sliding_variant": True}))
# head_axis and the Mamba2 split inside heads (phase 27), in phase 23's
# ranks: (a) HA_ARCH at full width with WIDE_LAYERS layers in bf16 on a
# (data 1, model HA_RANKS) mesh over ranks 0 .. HA_RANKS - 1 of the world
# (a sub-group; the last rank waits), head_axis="model" beside
# head_axis=None: a HA_PREFILL prefill (40 heads: blocks of 14 / 14 / 12),
# the f32 copy at 1 x HA_PARITY_S against one process (REF_PREFILL_TOL),
# TP_TRAIN_STEPS SGD steps (lr TP_LR) at MESH_TRAIN (the bf16 runs within
# TP_BF16_GAP of each other); (b) TP_HYBRID_ARCH's smoke config narrowed by
# HA_MIXER (3 SSM heads of 64, 48 channels a rank of 1 x MESH_RANKS:
# sub-heads of 16; the shared attention at head dim 32) in f32: a 2 x
# HA_MIXER_S prefill against one process (REF_PREFILL_TOL), HA_MIXER_GEN
# greedy tokens equal to one process's; (c) the dry run's counts on meta of
# rank 0 of the production mesh, HA_ARCH at HA_COUNT_SHAPES with and
# without head_axis, and zamba2-2.7b's rows at --tp HA_TP (80 SSM heads of
# 64 over 32 ranks: 160 channels a rank, sub-heads of 32)
HA_ARCH, HA_RANKS = "qwen2.5-32b", 3
HA_PREFILL, HA_PARITY_S = (2, 1024), 256
HA_MIXER = {"d_model": 96, "ssm_head_dim": 64, "ssm_state": 64,
            "head_dim": 32}
HA_MIXER_S, HA_MIXER_GEN = 256, 8
HA_COUNT_SHAPES, HA_TP = ("prefill_32k", "train_4k"), 32
# (d)'s f32 greedy decode on 1 x 4 against one process: the tokens equal,
# or apart first at a near tie within REF_PREFILL_TOL
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
# context parallelism through the layers that carry state and through the
# vlm and audio families (phase 28), in phase 23's ranks, every prefill
# with seq_axis="data" beside seq_axis=None (or one process) on the same
# weights: (a) HYBRID_ARCH at full width with CS_HYBRID_LAYERS layers
# (CS_HYBRID_SCANS Mamba2 layers and CS_HYBRID_ATTNS of the shared
# attention at its interval of 6), a bf16 1 x CS_PREFILL prefill on each of
# CP_MESHES (the logits within TP_BF16_GAP), the f32 copy at 1 x
# CS_PARITY_S against one process on each (REF_PREFILL_TOL), f32 greedy
# decode at batch 1 of CS_PROMPT + CS_GEN tokens on MESH_RANKS x 1 equal to
# one process's, CS_TRAIN_STEPS SGD steps at 1 x CS_TRAIN_S on 2 x 2 with
# remat "dots"; (b) XLSTM_ARCH whole, bf16 and f32 1 x CS_PREFILL on
# MESH_RANKS x 1 against one process (the hidden state before the final
# norm, expected bitwise; the logits within TP_BF16_GAP and
# XLSTM_REF_PREFILL_TOL, phase 8's f32 bound); (c) VISION_ARCH at full
# width with WIDE_LAYERS layers, bf16 1 x CS_PREFILL (its 256 vision rows
# inside data rank 0's block) on 2 x 2 beside seq_axis=None, the f32 copy
# at 1 x CS_PARITY_S (data rank 0 all vision) within REF_PREFILL_TOL and
# its loss, over the text targets only, within LOSS_REL_TP; (d)
# AUDIO_ARCH whole, bf16 AUDIO_B x AUDIO_S tokens over AUDIO_B x 1500
# frames on MESH_RANKS x 1 against one process (TP_BF16_GAP), the f32 copy
# (REF_PREFILL_TOL), CS_TRAIN_STEPS SGD steps on CS_AUDIO_TRAIN_B rows, f32
# greedy decode at batch 1 from split caches equal to one process's.
# Depth is cut for time only:
# zamba2 to 12 of 54 layers (two shared attention layers, so the split KV
# cache and the gathers of both kinds run), qwen2-vl to 2 of 80 (its whole
# weights, 17 GB of f32, fit 2 x 2 at half a rank)
CS_HYBRID_LAYERS, CS_HYBRID_SCANS, CS_HYBRID_ATTNS = 12, 10, 2
CS_PREFILL, CS_PARITY_S = 4096, 512
CS_PROMPT, CS_GEN = 24, 8
CS_TRAIN_S, CS_TRAIN_STEPS, CS_LR = 1024, 2, 0.01
# (d)'s SGD steps on the first row of the batch: the encoder's 1500
# frames with their gradient on every rank took ~19 GB a rank at 4 rows
CS_AUDIO_TRAIN_B = 1
# the decode caches as cache_specs lays them out (phase 29), in phase 23's
# ranks, every rank holding exactly cache_specs' block of every KV cache:
# (a) CL_ARCH (48 query heads on one kv head of 128) at full width with
# WIDE_LAYERS layers, a CL_PROMPT-token prompt replayed through
# serve.generate and CL_GEN greedy tokens in bf16 and in an f32 copy, on
# each of CL_MESHES ((data, model), global batch): 1 x 4 (12 query heads a
# rank, head_dim 32 a rank) and 2 x 2 at batch 1 (head_dim 64 a rank, the
# slots over data); (b) AUDIO_ARCH whole, f32, on each of CL_AUDIO_MESHES:
# batch 1 on 4 x 1 (self and cross slots over data, 375 of the 1,500
# frames a rank), batch 1 on 2 x 2 (4 heads a rank, the slots over data),
# batch 4 on 1 x 4 (2 heads a rank). The f32 tokens must equal one
# process's whole-cache decode on the same weights, the last logits within
# DECODE_TOL, the cache a rank exactly the block's bytes, and the sums and
# gathers of the CL_PROMPT + CL_GEN decode steps exact in count and bytes
CL_ARCH = "granite-34b"
CL_MESHES = (((1, 4), 2), ((2, 2), 1))
CL_AUDIO_MESHES = (((4, 1), 1), ((2, 2), 1), ((1, 4), 4))
CL_PROMPT, CL_GEN = 24, 8


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
    from repro_torch.launch.roofline import mule_agg_work
    size = torch.tensor([], dtype=dtype).element_size()
    w_bytes = m * d * size
    inputs = [_mule_agg_case(g, f, m, d, dtype)
              for _ in range(max(1, math.ceil(COLD_BYTES / w_bytes)))]
    work = mule_agg_work(f, m, d, size)
    graph = work.bound_ms < GRAPH_BELOW_MS
    ms = _cold_ms(mule_agg, inputs, graph, reps)
    plain_ms = _cold_ms(mule_agg_plain, inputs, graph)
    library_ms = (_cold_ms(torch.matmul, inputs, graph)
                  if dtype == torch.float32 else None)
    method = (f"CUDA graph of {GRAPH_CALLS * len(inputs)} calls" if graph
              else "CUDA events, one call each")
    entry = {"shape": f"F={f} M={m} D={d} {str(dtype).split('.')[1]}",
             "path": what, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": work.bound_ms, "bound_by": work.bound_by,
             "library_ms": library_ms, "timed_by": method,
             "w_copies": len(inputs)}
    lib = "" if library_ms is None else \
        f", torch.matmul {library_ms:.4f} ms"
    print(f"mule_agg timing {entry['shape']} ({what}): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms{lib}, bound {entry['bound_ms']:.4f} ms "
          f"({entry['bound_by']}; {work.n_bytes} B, {work.n_flop} FLOP), "
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
    and with the launch's own switch (the tuned cache's or the hand
    pick's): the same bits each time."""
    import torch
    from repro_torch.kernels.encounter_mix import ops
    outs = {}
    try:
        for dense_min in (None, 0, 33):
            ops.DENSE_MIN = dense_min
            outs[dense_min] = fn()
    finally:
        ops.DENSE_MIN = None
    torch.cuda.synchronize()
    same = all(torch.equal(o, outs[None][0])
               and torch.equal(m, outs[None][1]) for o, m in outs.values())
    print(f"{label}: every strip dense, none dense and the launch's own "
          f"switch give {'the same bits' if same else 'DIFFERENT results'}")
    if not same:
        raise AssertionError(f"{label}: the sparse and dense modes disagree")


def phase_encounter_mix() -> dict:
    """encounter_mix against its plain version; returns its JSON row."""
    import torch
    from repro_torch.launch.roofline import (FP32_FLOP_PER_S,
                                             encounter_mix_work)
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
                # W read once, the mix and mass written once, the geometry
                # read once; one multiply-add per met pair and column (a
                # dense strip would do M*M*D)
                work = encounter_mix_work(m, d, nnz)
                dense_flop = 2 * m * m * d
                row = {
                    "name": "encounter_mix", "route": "cuda",
                    "source": "src/repro_torch/kernels/encounter_mix/csrc/"
                              "encounter_mix.cu",
                    "replaces": "src/repro/kernels/encounter_mix/kernel.py:79",
                    "launches": None, "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": work.bound_ms, "bound_by": work.bound_by,
                    "library_ms": library_ms,
                }
                print(f"encounter_mix timing M={m} D={d} f32 ({nnz} "
                      f"encounters): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                      f"ms, torch.matmul on a dense e {library_ms:.4f} ms, "
                      f"gossip_step_dense's mix {dense_ms:.4f} ms, bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']}; "
                      f"{work.n_bytes} B, {work.n_flop} FLOP for the met "
                      f"pairs); the "
                      f"dense strip's {dense_flop} FLOP take "
                      f"{dense_flop / FP32_FLOP_PER_S * 1e3:.4f} ms")
            elif geo == "walk":
                bf_ms = _median_ms(lambda: encounter_mix(pos, area, active, w,
                                                         radius=radius))
                bf = encounter_mix_work(m, d, nnz, 2)
                row["bf16"] = {"ms": bf_ms, "bound_ms": bf.bound_ms,
                               "bound_by": bf.bound_by, "max_abs_err": err}
                print(f"encounter_mix timing M={m} D={d} bf16: kernel "
                      f"{bf_ms:.4f} ms, bound {bf.bound_ms:.4f} ms "
                      f"({bf.bound_by}; W and mix in bf16)")
            elif geo == "dense strip" and dtype == torch.float32:
                ms = _median_ms(lambda: encounter_mix(pos, area, active, w,
                                                      radius=radius))
                plain_ms = _median_ms(lambda: encounter_mix_reference(
                    pos, area, active, w, radius=radius))
                e = encounter_matrix(pos, area, radius, active).float()
                library_ms = _median_ms(lambda: torch.matmul(e, w))
                work = encounter_mix_work(m, d, nnz)
                dense = {"shape": f"M={m}, D={d}, pos 0, two areas "
                                  f"({nnz} met pairs)",
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": work.bound_ms,
                         "bound_by": work.bound_by,
                         "library_ms": library_ms}
                print(f"encounter_mix timing M={m} D={d} f32, dense strip "
                      f"(pos 0, two areas; {nnz} encounters): kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul "
                      f"on a dense e {library_ms:.4f} ms, bound "
                      f"{dense['bound_ms']:.4f} ms ({dense['bound_by']}; "
                      f"{work.n_flop} FLOP for the met pairs)")
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


def _lane_timing(label: str, lanes, singles, library, plain, work,
                 err: float) -> dict:
    """The lanes entry's timings: one lane-batched call, S single-lane
    calls, the library call and the plain version; and its bound (``work``,
    a ``roofline.Work``)."""
    ms = _median_ms(lanes, reps=20)
    single_ms = _median_ms(singles, reps=20)
    library_ms = _median_ms(library, reps=20)
    plain_ms = _median_ms(plain, reps=10)
    entry = {"shape": label, "max_abs_err": err, "ms": ms,
             "single_launches_ms": single_ms, "plain_ms": plain_ms,
             "bound_ms": work.bound_ms, "bound_by": work.bound_by,
             "library_ms": library_ms}
    print(f"  {label}: lanes {ms:.4f} ms, {LANES} single launches "
          f"{single_ms:.4f} ms, torch.bmm {library_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms "
          f"({entry['bound_by']}; {work.n_bytes} B, {work.n_flop} FLOP)")
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
    from repro_torch.launch.roofline import (encounter_mix_work,
                                             mule_agg_work)
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
            mule_agg_work(f, m, d_main, 4, LANES), err))
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
            encounter_mix_work(N_MULES, d, nnz, 4, LANES), err))
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
    from repro_torch.launch.roofline import (FP32_FLOP_PER_S,
                                             encounter_hop_work)
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
    # W_v read once, acc and mass written once, the two blocks' geometry
    # read once; one multiply-add per met pair and column
    work = encounter_hop_work(m_loc, m_loc, d_main, nnz)
    row = {
        "name": "encounter_hop", "route": "cuda",
        "source": "src/repro_torch/kernels/encounter_mix/csrc/"
                  "encounter_mix.cu",
        "replaces": "src/repro/kernels/encounter_mix/kernel.py:166",
        "launches": None, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": work.bound_ms, "bound_by": work.bound_by,
        "library_ms": library_ms,
    }
    print(f"encounter_hop timing R=V={m_loc} D={d_main} f32, hop (rows "
          f"{i}, visiting {j}; {nnz} encounters): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.matmul on the dense e [{m_loc}, "
          f"{m_loc}] {library_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}; {work.n_bytes} B, {work.n_flop} FLOP for the "
          f"met pairs; the dense strip's {2 * m_loc * m_loc * d_main} FLOP "
          f"take {2 * m_loc * m_loc * d_main / FP32_FLOP_PER_S * 1e3:.4f} "
          f"ms) [{card}]")
    row["lanes"] = _hop_lanes(pos, area, w, (i, j), card)
    return row


def _hop_lanes(pos, area, w, busiest, card: str) -> dict:
    """``encounter_block_hop_lanes``, the hop of a seed sweep over the
    ranks, at S = 1, 2 and 4 lanes of the ring path's remote hops (lane 0
    the busiest; every lane with the busiest hop's row0 and col0): each lane
    bitwise its single-lane ``encounter_block_hop``, one launch a call,
    within the float32 bound of the plain version; S = 4 timed beside 4
    single launches and ``torch.bmm`` over the dense gates (the ``lanes``
    entry of row 3)."""
    import torch
    from repro_torch.launch.roofline import encounter_hop_work
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
        encounter_hop_work(m_loc, m_loc, w.shape[1], nnz, LANES), worst)


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
    from repro_torch.launch.roofline import (BF16_TENSOR_FLOP_PER_S,
                                             HBM_BYTES_PER_S,
                                             flash_attention_work,
                                             unmasked_pairs)
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
        work = flash_attention_work(b, s, s, h, kv, d, True, win,
                                    torch.bfloat16)
        pairs, n_flop, n_bytes = (unmasked_pairs(s, s, win, True) * b * h,
                                  work.n_flop, work.n_bytes)
        bound_by = work.bound_by
        print(f"flash_attention timing {label} bf16: tensor-core kernel "
              f"{ms:.4f} ms ({n_flop / ms / 1e9:.2f} TFLOP/s useful, "
              f"{1.5 * n_flop / ms / 1e9:.2f} on the tensor cores with p "
              f"split), plain {plain_ms:.4f} ms, "
              f"SDPA ({note}, enable_gqa) "
              f"{library_ms:.4f} ms (max |SDPA - kernel| "
              f"{lib_err.item():.3e}), bound {work.bound_ms:.4f} ms "
              f"({bound_by}; {pairs} unmasked pairs, {n_flop} FLOP at "
              f"{BF16_TENSOR_FLOP_PER_S / 1e12:.0f} TFLOP/s bf16 dense, "
              f"{n_bytes} B at {HBM_BYTES_PER_S / 1e12:.2f} TB/s) [{card}]")
        timed = {"ms": ms, "plain_ms": plain_ms,
                 "bound_ms": work.bound_ms, "bound_by": bound_by,
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
    from repro_torch.launch.roofline import (BF16_TENSOR_FLOP_PER_S,
                                             HBM_BYTES_PER_S,
                                             flash_attention_work,
                                             unmasked_pairs)
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
    work = flash_attention_work(b, s, s, h, kv, d, causal, None,
                                torch.bfloat16)
    pairs, n_flop, n_bytes = (unmasked_pairs(s, s, None, causal) * b * h,
                              work.n_flop, work.n_bytes)
    bound_by = work.bound_by
    print(f"flash_attention timing {label} bf16: tensor-core kernel "
          f"{ms:.4f} ms ({n_flop / ms / 1e9:.2f} TFLOP/s useful, "
          f"{1.5 * n_flop / ms / 1e9:.2f} on the tensor cores with p split), "
          f"plain {plain_ms:.4f} ms, SDPA (is_causal={causal}, enable_gqa) "
          f"{library_ms:.4f} ms (max |SDPA - kernel| "
          f"{lib_err.item():.3e}), bound {work.bound_ms:.4f} ms "
          f"({bound_by}; {pairs} unmasked pairs, {n_flop} FLOP at "
          f"{BF16_TENSOR_FLOP_PER_S / 1e12:.0f} TFLOP/s bf16 dense, "
          f"{n_bytes} B at {HBM_BYTES_PER_S / 1e12:.2f} TB/s) [{card}]")
    return {"shape": f"q {list(q.shape)}, k/v {list(k.shape)} {kind} "
                     f"({arch})",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": work.bound_ms, "bound_by": bound_by,
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


def phase_ssd_scan(card: str) -> dict:
    """ssd_scan against its plain versions; returns its JSON row (timed at
    zamba2-2.7b's prefill shape)."""
    import torch
    from repro_torch.launch.roofline import (FP32_FLOP_PER_S,
                                             HBM_BYTES_PER_S, ssd_work)
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
    work = ssd_work(b, s, h, p, n)
    n_bytes, n_ops = work.n_bytes, work.n_flop
    t_bytes, t_ops = work.t_bytes_ms, work.t_ops_ms
    row = {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssm_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:95",
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": work.bound_ms, "bound_by": work.bound_by,
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
    from repro_torch.launch.roofline import (FP32_FLOP_PER_S,
                                             HBM_BYTES_PER_S, slstm_work)
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
    # one call of ~2 s (the check above warmed it); three until phase 25
    plain_ms = _median_ms(lambda: slstm_reference(pre, r), reps=1, warm=0)
    # the products h_{t-1} @ r of every step, and each input and output
    # moved once
    work = slstm_work(b, s, h, p)
    n_flop, n_bytes = work.n_flop, work.n_bytes
    t_ops, t_bytes = work.t_ops_ms, work.t_bytes_ms
    row = {
        "name": "slstm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/slstm_fused/csrc/slstm_scan.cu",
        "replaces": "src/repro/kernels/slstm_fused/kernel.py:75",
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": work.bound_ms, "bound_by": work.bound_by,
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
    MEASURED["main step s"] = wall / N_STEPS

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
    _xlstm_scan_rms(cfg, card)
    return launches


def _xlstm_scan_rms(cfg, card: str) -> None:
    """The check at the sLSTM scan's output: for each seed of
    XLSTM_SCAN_SEEDS, slstm_scan's RMS distance from the float64 scan at
    most XLSTM_SCAN_RMS_FACTOR times the plain f32 loop's (the constants'
    comment)."""
    import torch
    from repro_torch.kernels.slstm_fused import slstm_reference, slstm_scan
    h = cfg.n_heads
    p = cfg.d_model // h
    for seed in XLSTM_SCAN_SEEDS:
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        pre, r = _slstm_inputs(g, PREFILL_B, PREFILL_S, h, p, SLSTM_PRE_STD,
                               SLSTM_R_STD)
        exact = slstm_reference(pre.double(), r.double())[0]
        rms = [(got.double() - exact).pow(2).mean().sqrt().item()
               for got in (slstm_scan(pre, r), slstm_reference(pre, r)[0])]
        shape = [PREFILL_B, PREFILL_S, 4, h, p]
        print(f"lm serve {cfg.name} sLSTM scan {shape} (seed {seed}, pre "
              f"std {SLSTM_PRE_STD}, r std {SLSTM_R_STD}) against the f64 "
              f"scan: RMS kernel {rms[0]:.4e}, plain f32 {rms[1]:.4e}, "
              f"ratio {rms[0] / rms[1]:.4f} (bound {XLSTM_SCAN_RMS_FACTOR}) "
              f"[{card}]")
        if not rms[0] <= XLSTM_SCAN_RMS_FACTOR * rms[1]:
            raise AssertionError(f"slstm_scan at seed {seed}: RMS {rms[0]} "
                                 f"from the f64 scan, past "
                                 f"{XLSTM_SCAN_RMS_FACTOR} x the plain "
                                 f"loop's {rms[1]}")
        del pre, r, exact


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


def _short_defaults(label: str, task: str, mode: str, methods,
                    **cut) -> None:
    """``run_experiment`` at the harness's own reduced defaults on the card
    for each method, with a short T, an eval every 10 steps and the fields
    in ``cut``."""
    from repro_torch.experiment import ExperimentConfig, run_experiment
    for method in methods:
        cfg = ExperimentConfig(task=task, mode=mode, method=method,
                               steps=SHORT_STEPS, eval_every=10, **cut)
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
                            batch=HAR_BATCH, lr=HAR_LR, seed=SEED,
                            pretrain_steps=HAR_PRETRAIN)
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
    _short_defaults("HAR defaults", "har", "mobile", METHODS_MOBILE,
                    pretrain_steps=HAR_PRETRAIN)
    print(f"HAR path: phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"mule_agg": counts["mlmule"]["mule_agg"],
            "encounter_mix": counts["gossip"]["encounter_mix"]}


def phase_multi_area(card: str) -> dict:
    """The multi-area path: ``mlmule`` and ``gossip`` on
    ``multi_area_3city`` and ``gossip`` on ``multi_area_migratory`` (its
    area a [T, M] column) at the paper CNN's full width, F = 12, M = 256,
    T = MULTI_AREA_STEPS, an eval every 20; launches exact, replays bitwise
    and against the plain backends, the mix in lockstep with no met pair
    across areas.
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
        co = spec.colocation(SEED, N_MULES, MULTI_AREA_STEPS)
        if spec.n_fixed != MULTI_AREA_FIXED:
            raise AssertionError(f"{scenario}: {spec.n_fixed} fixed devices")
        area = np.asarray(co["area"])
        moved = (int((area != area[:1]).any(0).sum()) if area.ndim == 2
                 else 0)
        print(f"{scenario}: areas {sorted(np.unique(area).tolist())}, area "
              f"column {area.shape}, {moved} mules change area, "
              f"{int((co['exchange'] & (co['fixed_id'] >= 0)).sum())} "
              f"deliveries in T={MULTI_AREA_STEPS}")
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
            want = ({"mule_agg": MULTI_AREA_STEPS, "encounter_mix": 0}
                    if method == "mlmule" else
                    {"mule_agg": 0,
                     "encounter_mix": MULTI_AREA_STEPS // PEER_EVERY})
            label = f"{scenario} {method}"
            if got != want:
                raise AssertionError(f"{label}: kernel launches {got}, "
                                     f"expected {want}")
            evals = aux["evals"]
            if evals is None or tuple(evals.shape) != (
                    MULTI_AREA_STEPS // EVAL_EVERY, N_MULES) or \
                    not bool(torch.isfinite(evals).all()):
                raise AssertionError(f"{label}: evals missing or not finite")
            _check_finite(label, {**final["mule_models"],
                                  **final["fixed_models"]})
            if method == "mlmule" and int(final["fresh"]["count"].sum()) == 0:
                raise AssertionError(f"{label}: no mule delivered")
            trace = [(int(s), float(a)) for s, a in
                     zip(aux["eval_steps"], evals.mean(1).tolist())]
            print(f"multi-area path: {label}, F={spec.n_fixed}, "
                  f"M={N_MULES}, T={MULTI_AREA_STEPS}: "
                  f"{MULTI_AREA_STEPS / wall:.3f} steps/s "
                  f"({wall:.3f} s), peak memory {peak} B, launches {got}, "
                  f"accuracy trace {trace} [{card}]")
            paths[label] = got
            del final, aux
            if method == "mlmule":
                _replays(label, run, "agg_backend", REPLAY_ATOL)
            else:
                _replays(label, run, "enc_backend", PEER_REPLAY_ATOL)
                _mix_lockstep(label, run, MULTI_AREA_STEPS)
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
                           steps=SWEEP_STEPS, batch=HAR_BATCH, lr=HAR_LR,
                           pretrain_steps=HAR_PRETRAIN)
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
    report = {"rank": i, "runs": {}, "laps": {}}
    t_lap = [time.perf_counter()]

    def lap(part: str):
        now = time.perf_counter()
        report["laps"][part] = now - t_lap[0]
        t_lap[0] = now

    lap("set-up")

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
        lap(method)

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
    lap("mlmule ref")

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
    lap("lockstep")

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
    lap("2x2")

    # the re-bucketed streamed engine on the migratory schedule
    spec = get_scenario("multi_area_migratory")
    mco = spec.colocation(SEED, N_MULES, REBUCKET_STEPS)
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
                   if d > REBUCKET_THRESHOLD), REBUCKET_STEPS)
    rec.update(checks=rb["checks"], swaps=rb["swaps"], drift=rb["drift"],
               order=[int(x) for x in rb["order"]], swap_t=swap_t,
               pruned_by_chunk=by_chunk,
               pruned_host=_pruned_hops(mco, rb["order"], n, swap_t,
                                        REBUCKET_STEPS),
               digest=_replicated_digest(fin_s), finite=bool(all(
                   bool(torch.isfinite(v).all())
                   for v in fin_s["mule_models"].values())))
    report["runs"]["rebucket gossip"] = rec
    del fin_s, fin_d, mpop, stream
    gc.collect()
    torch.cuda.empty_cache()
    lap("rebucket")
    report["sweep"] = _dist_sweep(mesh, counted, init_fn, train_fn)
    lap("sweep (phase 17)")
    # phase 22 (f): one row of the engine's roofline on these ranks
    from repro_torch.launch.autotune import engine_step_rank
    report["roofline"] = engine_step_rank("mlmule", 64, 24, 1, n, "cuda")
    lap("roofline row")
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


def _dist_sweep(mesh, counted, init_fn, train_fn) -> dict:
    """Phase 17 in a rank of phase 16's world: ``run_sweep_distributed``
    over DIST_LANES seeds of the walk for ``mlmule`` and ``gossip``, then
    each lane alone through ``run_population_distributed``; the rank's
    launches, collectives, bytes and digests, and each lane's largest
    distance from its sequential run. Then the same comparison over
    DIST_SWEEP_OFF_STEPS steps with training off (the collectives, the
    aggregation and the hops alone) for both methods, and over
    DIST_LOCAL_STEPS for ``local`` (training alone) with cuDNN; each with
    its wall seconds."""
    import numpy as np
    import torch
    from repro_torch.baselines.gossip import flatten_population
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
        sequential run on this rank: its block of the mules (the same
        block in both runs; the parent takes the largest over the ranks,
        so no rank gathers the population) and the fixed models, and
        last_fid."""
        lane = flatten_population(tree_lane(final["mule_models"], l))[0]
        solo = flatten_population(one["mule_models"])[0]
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
    # sees S times the groups)
    torch.cuda.empty_cache()
    out["local"] = {"cudnn": lanes_gap("local", DIST_LOCAL_STEPS,
                                       train_fn)}
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
             for k in ("cudnn",)}
    print(f"distributed sweep S={DIST_LANES} local (training alone), "
          f"T={DIST_LOCAL_STEPS}: lanes vs sequential runs max diff "
          f"{local['cudnn'][0]:.3e} (bitwise {local['cudnn'][1]}; "
          f"{local['cudnn'][2]:.1f} s) with cuDNN [{card}]")
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
    print("distributed laps, rank 0: " + ", ".join(
        f"{k} {v:.1f}" for k, v in ranks[0]["laps"].items()) + " s")
    from repro_torch.launch import autotune
    MEASURED["dist roofline"] = autotune.engine_row(
        "mlmule", 64, 24, f"1x{DIST_RANKS}", DIST_RANKS,
        autotune.RankSums([r["roofline"] for r in ranks]))
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
        t = REBUCKET_STEPS if label == "rebucket gossip" else DIST_STEPS
        print(f"distributed path: {label}, {DIST_RANKS} ranks x "
              f"{N_MULES // DIST_RANKS} mules, T={t}: "
              f"{t / wall:.3f} steps/s ({wall:.3f} s), launches by "
              f"rank {got}, {sent} B sent ({sent // t} B a step; "
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
    n_after = REBUCKET_STEPS // PEER_EVERY - n_before
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


def _remat_training(cfg, card: str) -> None:
    """Phase 18's remat steps: the f32 gradient of ``cfg`` at GRAD_BATCH x
    TRAIN_SEQ bitwise with and without ``remat`` (full and "dots"), then
    REMAT_STEPS Adam steps at TRAIN_BATCH x TRAIN_SEQ in bf16 with each
    policy, their steps/s and peak memory (within REMAT_PEAK_SLACK of the
    plain steps'), and the peak of one gradient alone (no Adam state) with
    and without remat (lower with it)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.data import make_lm_dataset
    from repro_torch.interop import tree_leaves
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adam, cosine_schedule

    def free():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    t_start = time.perf_counter()
    gen = torch.Generator(device="cuda")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen.manual_seed(SEED)
    params = build_model(cfg32).init(gen)
    rng = np.random.default_rng(SEED + 1)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab, (GRAD_BATCH, TRAIN_SEQ)), device="cuda")}
    g0, (l0, _) = torch.func.grad_and_value(build_model(cfg32).loss,
                                            has_aux=True)(params, batch)
    same = {}
    for policy in ("full", "dots"):
        g1, (l1, _) = torch.func.grad_and_value(build_model(
            cfg32, remat=True, remat_policy=policy).loss, has_aux=True)(
                params, batch)
        same[policy] = bool(torch.equal(l0, l1)) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(g0),
                                              tree_leaves(g1)))
        del g1
    del g0, params
    free()
    print(f"training {cfg.name} remat: the f32 loss and gradient at "
          f"{GRAD_BATCH} x {TRAIN_SEQ} with remat bitwise those without: "
          f"{same} [{card}]")
    if not all(same.values()):
        raise AssertionError(f"training {cfg.name}: remat changed the "
                             f"gradient's bits {same}")
    t_bits = time.perf_counter() - t_start
    seqs, _ = make_lm_dataset(SEED, n_seqs=max(TRAIN_BATCH * 8, 64),
                              seq_len=TRAIN_SEQ, vocab=cfg.vocab)
    idx = np.random.default_rng(SEED).integers(0, len(seqs), TRAIN_BATCH)
    batch = {"tokens": torch.as_tensor(seqs[idx], dtype=torch.int64,
                                       device="cuda")}
    report = {}
    for policy in (None, "full", "dots"):
        model = build_model(cfg, remat=policy is not None,
                            remat_policy=policy or "full")
        gen.manual_seed(SEED)
        start = model.init(gen)
        free()
        g, _ = torch.func.grad_and_value(model.loss, has_aux=True)(start,
                                                                   batch)
        torch.cuda.synchronize()
        grad_peak = torch.cuda.max_memory_allocated()
        del g
        if policy is None:      # phase 18's plain steps are measured above
            report["plain"] = {"grad_peak": grad_peak}
            del start
            continue
        opt = adam(cosine_schedule(3e-4, REMAT_STEPS, warmup=0))
        state = opt.init(start)
        step = make_train_step(model, opt)
        free()
        params, times, losses = start, [], []
        del start
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            params, state, met = step(params, state, batch)
            losses.append(float(met["loss"]))
            times.append(time.perf_counter() - t0)
        report[policy] = {"steps_s": REMAT_STEPS / sum(times),
                          "walls": [round(x, 4) for x in times],
                          "losses": [round(x, 4) for x in losses],
                          "peak": torch.cuda.max_memory_allocated(),
                          "grad_peak": grad_peak}
        del params, state, opt, step
        free()
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"training {cfg.name} remat {policy}: "
                                 f"losses {losses}")
    plain_rate = 1.0 / MEASURED["train step s"]
    print(f"training {cfg.name} remat, {REMAT_STEPS} Adam steps at "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} (bf16): plain (the steps above) "
          f"{plain_rate:.3f} steps/s at the median step, peak "
          f"{MEASURED['train peak B']} B, one gradient's peak "
          f"{report['plain']['grad_peak']} B; "
          + "; ".join(f"remat {p} {r['steps_s']:.3f} steps/s (walls "
                      f"{r['walls']} s, losses {r['losses']}), peak "
                      f"{r['peak']} B, one gradient's peak {r['grad_peak']} B"
                      for p, r in report.items() if p != "plain")
          + f"; the bit checks {t_bits:.1f} s, the steps "
          f"{time.perf_counter() - t_start - t_bits:.1f} s [{card}]")
    for policy, r in report.items():
        if policy != "plain" and (
                r["peak"] > MEASURED["train peak B"] + REMAT_PEAK_SLACK
                or r["grad_peak"] >= report["plain"]["grad_peak"]):
            raise AssertionError(
                f"training {cfg.name} remat {policy}: step peak {r['peak']} "
                f"B against the plain step's {MEASURED['train peak B']} "
                f"(+{REMAT_PEAK_SLACK} allowed), one gradient's peak "
                f"{r['grad_peak']} B against {report['plain']['grad_peak']}")


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
        MEASURED["train step s"] = statistics.median(times)
        MEASURED["train peak B"] = peak
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
    _remat_training(cfg, card)

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


# phase 22, the tooling: the main and peer paths run TOOL_STEPS steps with
# the committed tuning cache and without it (the same bits and launches);
# the dry run's peak memory of phase 18's training step is held to the
# measured peak within TOOL_PEAK_GAP of it
TOOL_STEPS = 6
TOOL_PEAK_GAP = 0.2
# what phases 4, 16 and 18 measured, for phase 22
MEASURED: dict = {}


def _cache_off(off: bool):
    """Run with the tuning cache switched off (``off``) or as committed:
    a context manager that repoints ``REPRO_TORCH_TUNE_CACHE``."""
    import contextlib
    import os
    from repro_torch.launch import autotune

    @contextlib.contextmanager
    def ctx():
        old = os.environ.get("REPRO_TORCH_TUNE_CACHE")
        if off:
            os.environ["REPRO_TORCH_TUNE_CACHE"] = ""
        autotune.tuning_cache_clear()
        try:
            yield
        finally:
            if off:
                if old is None:
                    del os.environ["REPRO_TORCH_TUNE_CACHE"]
                else:
                    os.environ["REPRO_TORCH_TUNE_CACHE"] = old
            autotune.tuning_cache_clear()
    return ctx()


def _cnn_path(scenario: str, device: str = "cuda"):
    """(pop0, co, batch_fn, train_fn, pcfg) of phase 4's main path
    (``commuter``) or phase 5's walk, at the paper CNN's full width."""
    import torch
    from repro_torch.configs.mule_cnn import CONFIG
    from repro_torch.core.population import PopulationConfig, init_population
    from repro_torch.experiment import (batch_sampler, cnn_model_fns,
                                        image_data_mobile)
    from repro_torch.scenarios import get_scenario, walk_colocation
    if scenario == "commuter":
        spec = get_scenario("commuter")
        co, n_fixed = spec.colocation(SEED, N_MULES, N_STEPS), spec.n_fixed
    else:
        co = walk_colocation(SEED, N_MULES, N_STEPS, p_cross=P_CROSS)
        n_fixed = N_FIXED
    Xtr, Ytr, _, _ = image_data_mobile(
        SEED, N_MULES, n_fixed, co["init_space"], co["init_area"],
        n_super=CONFIG.n_classes, image_size=CONFIG.image_size,
        device=device)
    init_fn, train_fn, _ = cnn_model_fns(CONFIG, LR)
    pcfg = PopulationConfig(mode="mobile", n_fixed=n_fixed, n_mules=N_MULES)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    pop0 = init_population(pcfg, init_fn, gen, device=device)
    return pop0, co, batch_sampler(Xtr, Ytr, BATCH), train_fn, pcfg


def _first_steps(co: dict, n: int) -> dict:
    keys = ("fixed_id", "exchange", "pos")
    return {**{k: co[k][:n] for k in keys if k in co}, "area": co["area"]} \
        if "pos" in co else {k: co[k][:n] for k in ("fixed_id", "exchange")}


def _tooling_tunes(card: str) -> dict:
    """(a) and (b): every candidate of the three tuned kernels at the
    paths' shapes, bitwise the default's; the picks' ms beside the
    default's (printed, not checked: timings)."""
    from repro_torch.launch import autotune
    tuned = autotune.run_tunes(reps=10)
    entries = [e for es in tuned.values() for e in es]
    excluded = [x for e in entries for x in e["excluded"]]
    for kernel, es in tuned.items():
        for e in es:
            shape = {k: e[k] for k in ("f", "m", "r", "d") if k in e}
            pick = e.get("waves", (e.get("shape"), e.get("dense_min")))
            print(f"tooling tune {kernel} {shape}: {len(e['candidates_ms'])} "
                  f"candidates, every one bitwise the default's; pick {pick} "
                  f"{e['ms']:.4f} ms, default {e['default_ms']:.4f} ms, "
                  f"speedup {e['speedup_vs_default']:.4f}; all "
                  f"{ {k: round(v, 4) for k, v in e['candidates_ms'].items()} }"
                  f" [{card}]")
    if excluded:
        raise AssertionError(f"tooling: candidates not bitwise the "
                             f"default's: {excluded}")
    speedup = autotune.geomean([e["speedup_vs_default"] for e in entries])
    print(f"tooling tune: tuned_speedup_vs_default {speedup:.4f} this run; "
          f"the committed cache's "
          f"{autotune.load_tuning_cache()['tuned_speedup_vs_default']:.4f} "
          f"[{card}]")
    return tuned


def _tooling_cache_drives(card: str) -> None:
    """(c): the committed cache's picks are the launches' choices, and the
    main and peer paths give the same launches and bits with it and
    without it."""
    import torch
    from repro_torch.kernels.encounter_mix import encounter_mix
    from repro_torch.kernels.encounter_mix import ops as enc
    from repro_torch.kernels.mule_agg import mule_agg
    from repro_torch.kernels.mule_agg import ops as agg
    from repro_torch.launch import autotune
    from repro_torch.scenarios import run_population
    cache = autotune.load_tuning_cache()
    if cache is None or "H100" not in cache.get("card", ""):
        raise AssertionError("tooling: no committed tuning cache from the "
                             "H100")
    dev = torch.device("cuda", 0)
    code = {None: 0, "small": 1, "big": 2}
    for e in cache["tuned"]["mule_agg"]:
        f, m, d = e["f"], e["m"], e["d"]
        with _cache_off(True):
            hand = agg.grid_blocks(f, m, d, torch.float32, dev)
        got = agg.grid_blocks(f, m, d, torch.float32, dev)
        want = (0 if e["waves"] == 1.0 else
                round(e["waves"] * agg.wave_blocks(f, torch.float32, dev)))
        print(f"tooling cache mule_agg F={f} M={m} D={d}: {e['waves']} "
              f"waves -> grid_blocks {got} (hand pick {hand})")
        if got != want or hand != 0:
            raise AssertionError("tooling: mule_agg's launch is not the "
                                 "cache's pick")
    for kernel, key, hop in (("encounter_mix", "m", False),
                             ("encounter_hop", "r", True)):
        for e in cache["tuned"][kernel]:
            with _cache_off(True):
                hand = enc.launch_choice(e[key], e["d"], hop)
            got = enc.launch_choice(e[key], e["d"], hop)
            print(f"tooling cache {kernel} {key.upper()}={e[key]} "
                  f"D={e['d']}: {e['shape']}/{e['dense_min']} -> launch "
                  f"{got} (hand pick {hand})")
            if got != (code[e["shape"]], e["dense_min"]) or \
                    hand != (0, enc.DENSE_PAIRS_PER_ROW):
                raise AssertionError(f"tooling: {kernel}'s launch is not "
                                     f"the cache's pick")
    torch.backends.cudnn.deterministic = True
    try:
        for scenario, method in (("commuter", "mlmule"), ("walk", "gossip")):
            pop0, co, batch_fn, train_fn, pcfg = _cnn_path(scenario)
            window = _first_steps(co, TOOL_STEPS)
            outs = {}
            for off in (False, True):
                with _cache_off(off):
                    mule_agg.launches = encounter_mix.launches = 0
                    final, _ = run_population(pop0, window, batch_fn,
                                              train_fn, pcfg, SEED,
                                              method=method)
                    torch.cuda.synchronize()
                    outs[off] = (final, (mule_agg.launches,
                                         encounter_mix.launches))
            same = _max_diff(outs[False][0], outs[True][0],
                             ("mule_models", "fixed_models")) == 0.0
            print(f"tooling cache {method} on {scenario}, T={TOOL_STEPS}: "
                  f"launches (mule_agg, encounter_mix) {outs[False][1]} with "
                  f"the cache, {outs[True][1]} without; final weights "
                  f"{'bitwise equal' if same else 'DIFFERENT'} [{card}]")
            if not same or outs[False][1] != outs[True][1] \
                    or sum(outs[False][1]) == 0:
                raise AssertionError(f"tooling: {method} differs with the "
                                     f"cache")
            del outs, pop0
    finally:
        torch.backends.cudnn.deterministic = False


def _meta_tree(tree):
    import torch
    from repro_torch.interop import tree_map
    return tree_map(lambda t: torch.empty_like(t, device="meta"), tree)


def _tooling_counts(card: str) -> dict:
    """(d): one step of the main path and one stablelm-1.6b training step
    counted on the card and on meta (the FLOPs equal), their roofline terms
    beside phases 4 and 18's measured step times; returns the terms."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.cost_analysis import CostCounter
    from repro_torch.launch.dryrun import meta_params
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adam, cosine_schedule
    from repro_torch.scenarios import run_population
    counts = {}
    # the main path: one mlmule step at M = 256, D = 546,484
    pop0, co, batch_fn, train_fn, pcfg = _cnn_path("commuter")
    one = _first_steps(co, 1)
    xb, yb = batch_fn(SEED, 0)["mule"]

    def meta_batches(seed, t):
        return {"fixed": None, "mule": (torch.empty_like(xb, device="meta"),
                                        torch.empty_like(yb, device="meta"))}
    for dev in ("cuda", "meta"):
        state = pop0 if dev == "cuda" else _meta_tree(pop0)
        with CostCounter() as cc:
            cc.hold(state)
            run_population(state, one, batch_fn if dev == "cuda"
                           else meta_batches, train_fn, pcfg, SEED,
                           device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        counts[("main", dev)] = cc
    del pop0, state
    # stablelm-1.6b: one Adam step, bf16 compute, batch 4 x 128
    cfg = get_config(TRAIN_ARCH)
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ))
    for dev in ("cuda", "meta"):
        if dev == "cuda":
            model, params, _, opt_state, step_fn = ttrain.setup(
                cfg, steps=TRAIN_STEPS, device="cuda")
        else:
            opt = adam(cosine_schedule(3e-4, TRAIN_STEPS,
                                       warmup=TRAIN_STEPS // 10))
            params = meta_params(model)
            opt_state = opt.init(params)
            step_fn = make_train_step(model, opt)
        batch = ttrain.lm_batch(cfg, toks, dev)
        with CostCounter() as cc:
            cc.hold(params, opt_state, batch)
            step_fn(params, opt_state, batch)
        if dev == "cuda":
            torch.cuda.synchronize()
        counts[("train", dev)] = cc
        del params, opt_state
    torch.cuda.empty_cache()
    terms = {}
    for path, measured, label in (
            ("main", MEASURED.get("main step s"),
             "main path: one mlmule step, M=256, D=546,484"),
            ("train", MEASURED.get("train step s"),
             f"{TRAIN_ARCH} Adam step, bf16 compute, {TRAIN_BATCH} x "
             f"{TRAIN_SEQ}")):
        card_cc, meta_cc = counts[(path, "cuda")], counts[(path, "meta")]
        rl = roofline.analyze(label, path, "1", 1, card_cc, 0.0)
        terms[path] = rl
        print(f"tooling count {label}: {card_cc.flops:.6e} FLOP on the card, "
              f"{meta_cc.flops:.6e} on meta, by kind {card_cc.flops_by}; "
              f"{card_cc.bytes:.6e} B ({meta_cc.bytes:.6e} on meta); "
              f"kernels {card_cc.kernels}; t_compute {rl.t_compute * 1e3:.4f}"
              f" ms, t_memory {rl.t_memory * 1e3:.4f} ms -> {rl.dominant}; "
              f"measured {None if measured is None else measured * 1e3} ms "
              f"a step (TF32 matmul "
              f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN "
              f"{torch.backends.cudnn.allow_tf32}) [{card}]")
        for line in card_cc.breakdown(6).splitlines():
            print(f"  {line}")
        if card_cc.flops != meta_cc.flops or card_cc.flops == 0:
            raise AssertionError(f"tooling: the {path} step's FLOPs differ "
                                 f"on the card and on meta")
        if measured is None:
            raise AssertionError(f"tooling: no measured {path} step time "
                                 f"(its phase did not run)")
        if not rl.t_compute <= measured:
            raise AssertionError(f"tooling: the {path} step's compute term "
                                 f"{rl.t_compute} s exceeds its measured "
                                 f"{measured} s: the count is wrong")
    return terms


def _tooling_peak(card: str) -> None:
    """(e): the dry run's peak memory of phase 18's training step against
    the peak phase 18 measured."""
    from repro_torch.configs import InputShape
    from repro_torch.launch.dryrun import dryrun_one
    row = dryrun_one(TRAIN_ARCH, InputShape("phase 18", TRAIN_SEQ,
                                            TRAIN_BATCH, "train"),
                     verbose=False)
    measured = MEASURED.get("train peak B")
    if measured is None:
        raise AssertionError("tooling: no measured training peak")
    gap = abs(row["peak_memory_gb"] * 2**30 - measured) / measured
    print(f"tooling dry run {TRAIN_ARCH} train {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"on meta ({row['t_count_s']} s): peak {row['peak_memory_gb']:.4f} "
          f"GiB, {row['peak_memory_gb'] * 2**30:.6e} B; phase 18 measured "
          f"{measured} B (torch.cuda.max_memory_allocated); gap {gap:.4f} of "
          f"the measured (bound {TOOL_PEAK_GAP}); t_compute "
          f"{row['t_compute_s'] * 1e3:.4f} ms, t_memory "
          f"{row['t_memory_s'] * 1e3:.4f} ms, useful FLOPs "
          f"{row['useful_flops_ratio']:.4f} [{card}]")
    if not gap <= TOOL_PEAK_GAP:
        raise AssertionError(f"tooling: the dry run's peak is {gap:.3f} "
                             f"from the measured")


def phase_tooling(card: str) -> None:
    """Phase 22: the tuned launches, the count, the dry run and the mesh
    suggestion (the module docstring's (a)-(f))."""
    import torch
    from repro_torch.launch import autotune, roofline
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # as phases 4 and 18
    torch.backends.cudnn.allow_tf32 = False
    line, rate = roofline.query_host_link()
    print(f"tooling host link: nvidia-smi pcie.link.gen.max,width.max "
          f"'{line}' -> {rate}; the collective term's rate "
          f"{roofline.HOST_LINK_BYTES_PER_S:.6e} B/s (PCIe Gen"
          f"{roofline.HOST_LINK_GEN} x{roofline.HOST_LINK_WIDTH}, the data "
          f"sheet's) [{card}]")
    _tooling_tunes(card)
    _tooling_cache_drives(card)
    _tooling_counts(card)
    _tooling_peak(card)
    row = MEASURED.get("dist roofline")
    if row is None:
        raise AssertionError("tooling: phase 16 wrote no roofline row")
    print(f"tooling engine roofline on phase 16's {row['chips']} ranks "
          f"({row['mesh']}): mlmule M={row['n_mules']} T={row['steps']}: "
          f"{row['flops_per_device']:.6e} FLOP, {row['bytes_per_device']:.6e}"
          f" B, {row['coll_bytes_per_device']:.6e} collective B "
          f"{row['coll_breakdown']}, kernels {row['kernels']}; per step "
          f"compute {row['t_compute_us_per_step']:.4f} us, memory "
          f"{row['t_memory_us_per_step']:.4f} us, collective "
          f"{row['t_collective_us_per_step']:.4f} us -> {row['dominant']}")
    for method in ("mlmule", "gossip"):
        print(f"tooling suggest_mesh_shape({method!r}, 64) on the committed "
              f"cache: {autotune.suggest_mesh_shape(method, 64)}")
    print(f"tooling: phase wall {time.perf_counter() - t_phase:.1f} s")


def _spec_leaves(specs) -> list:
    """A spec tree's leaves (tuples) in tree_leaves' order."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for v in specs for x in _spec_leaves(v)]
    return [specs]


def _wide_rank_params(cfg, mesh) -> dict:
    """This rank's block of ``Model.init``'s weights for ``cfg`` (one stage
    of MoE layers) under ``launch.sharding.rank_specs``, drawn from the
    seed on the card in ``init``'s order but one layer at a time: a layer
    is cut to the rank's block before the next is drawn, so the whole
    stack is never held at once."""
    import torch
    from repro_torch.interop import tree_map
    from repro_torch.launch.sharding import rank_specs, shard_tree
    from repro_torch.models import build_model
    from repro_torch.models.api import _init_layer
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cfg1 = dataclasses.replace(cfg, n_layers=1)
    first = build_model(cfg1).init(gen)
    # a one-layer stage is unstacked: its specs are a layer's
    specs = rank_specs(cfg1, first, mesh)

    def own(tree, spec):
        return tree_map(lambda t: t.clone(), shard_tree(tree, spec, mesh))

    layers = [own(first["stages"][0], specs["stages"][0])]
    for _ in range(cfg.n_layers - 1):
        layers.append(own(_init_layer(gen, cfg, "moe"), specs["stages"][0]))
    first = own({k: v for k, v in first.items() if k != "stages"},
                {k: v for k, v in specs.items() if k != "stages"})
    first["stages"] = [tree_map(lambda *ls: torch.stack(ls), *layers)]
    return first


def _mesh_routes(mesh_rec: "_MoeRoutes", local_rec: "_MoeRoutes",
                 start: int) -> list:
    """The flips of a mesh prefill's routes against the local path's on
    the same tokens: [layer, flat index in the rank's block, gap of the
    k-th over the (k+1)-th local probability relative to the k-th]. The
    mesh rank routed the block's tokens from ``start`` on (its slice on
    the expert-parallel path), the local run the whole block."""
    flips = []
    for layer, (em, el, pl) in enumerate(zip(mesh_rec.top_e,
                                             local_rec.top_e,
                                             local_rec.top_p)):
        n = em.shape[0]
        el, pl = el[start:start + n], pl[start:start + n]
        k = pl.shape[-1] - 1
        gap = (pl[:, k - 1] - pl[:, k]) / pl[:, k - 1]
        at = (em != el).any(-1).nonzero()[:, 0]
        flips += [[layer, start + i, g] for i, g in zip(
            at.tolist(), gap[at].tolist())]
    return flips


def _params_digest(tree) -> str:
    """sha256 of a fingerprint of a tree's bits, in tree_leaves' order: each
    leaf's 32-bit words summed exactly (int64) over blocks of 2^20 on the
    card, so that ranks compare gigabytes without moving them; two trees
    differ in it unless their differences cancel inside a block."""
    import hashlib
    import torch
    from repro_torch.interop import tree_leaves
    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        words = leaf.detach().reshape(-1).view(torch.int32).long()
        n = words.numel() // (1 << 20) * (1 << 20)
        sums = torch.cat([words[:n].view(-1, 1 << 20).sum(1),
                          words[n:].sum().reshape(1)])
        h.update(sums.cpu().numpy().tobytes())
    return h.hexdigest()


def _tp_kernel_shapes() -> dict:
    """Phase 24 on rank 0: flash_attention and ssd_scan against their plain
    versions at the shapes a rank of 1 x MESH_RANKS gives them, timed
    beside the plain version, SDPA and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssm_scan import ssd_chunked_reference, ssd_scan
    from repro_torch.launch.roofline import flash_attention_work, ssd_work
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 8)
    out = {"flash_attention": [], "ssd_scan": []}
    b, s = TP_PREFILL
    for arch in (TP_ARCH, TP_HYBRID_ARCH):
        cfg = get_config(arch)
        h, kv = cfg.n_heads // MESH_RANKS, cfg.n_kv_heads // MESH_RANKS
        d = cfg.resolved_head_dim
        q = torch.randn(b, s, h, d, device="cuda", generator=g).bfloat16()
        k, v = (torch.randn(b, s, kv, d, device="cuda", generator=g)
                .bfloat16() for _ in range(2))
        got = _flash_routed(q, k, v, causal=True)
        err = _hold(f"flash_attention {arch}'s rank of 1 x {MESH_RANKS} "
                    f"q {list(q.shape)} bf16 causal vs flash_reference", got,
                    flash_attention(q, k, v, causal=True, backend="ref"),
                    *FLASH_BF16_VS_BF16)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        work = flash_attention_work(b, s, s, h, kv, d, True, None,
                                    torch.bfloat16)
        out["flash_attention"].append({
            "arch": arch, "shape": [b, s, h, kv, d], "causal": True,
            "max_abs_err": err,
            "ms": _median_ms(lambda: flash_attention(q, k, v, causal=True),
                             reps=10),
            "plain_ms": _median_ms(lambda: flash_attention(
                q, k, v, causal=True, backend="ref"), reps=3, warm=1),
            "library_ms": _median_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True), reps=10),
            "bound_ms": work.bound_ms, "bound_by": work.bound_by})
    cfg = get_config(TP_HYBRID_ARCH)
    h_all = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    h, p, n = h_all // MESH_RANKS, cfg.ssm_head_dim, cfg.ssm_state
    # the last rank's heads: A = -(61 .. 80), the largest in the model
    a = -torch.arange(h_all - h + 1, h_all + 1, dtype=torch.float32,
                      device="cuda")
    args = _ssd_inputs(g, b, s, h, p, n, a)
    y, _ = ssd_scan(*args, chunk=64)
    err = _hold_scaled(f"ssd_scan {TP_HYBRID_ARCH}'s last rank of 1 x "
                       f"{MESH_RANKS} x {[b, s, h, p]} n={n} vs "
                       f"ssd_chunked_reference", y,
                       ssd_chunked_reference(*args, chunk=64)[0],
                       SSD_VS_CHUNKED_REL)
    work = ssd_work(b, s, h, p, n)
    out["ssd_scan"].append({
        "arch": TP_HYBRID_ARCH, "shape": [b, s, h, p, n], "max_abs_err": err,
        "ms": _median_ms(lambda: ssd_scan(*args, chunk=64), reps=10),
        "plain_ms": _median_ms(lambda: ssd_chunked_reference(*args,
                                                             chunk=64),
                               reps=3, warm=1),
        "library_ms": None, "bound_ms": work.bound_ms,
        "bound_by": work.bound_by})
    return out


def _first_mismatch(model, params, prompt, mine, theirs) -> Optional[list]:
    """Where two greedy runs' tokens part (None if they do not): [step,
    row, one process's top logit minus its logit of the mesh's pick]. The
    one-process logits at that step are replayed through ``decode_step``
    on the prompt and the shared prefix."""
    import torch
    from repro_torch.launch.steps import make_serve_step
    diff = (mine != theirs).nonzero()
    if not len(diff):
        return None
    t = int(diff[:, 1].min())
    row = int(diff[diff[:, 1] == t][0, 0])
    seq = torch.cat([prompt, theirs[:, :t]], dim=1)
    cache = model.init_cache(seq.shape[0], seq.shape[1] + 1,
                             dtype=torch.float32, device="cuda")
    decode = make_serve_step(model)
    for i in range(seq.shape[1]):
        logits, cache = decode(params, cache, seq[:, i:i + 1], i)
    gap = logits[row].max() - logits[row, mine[row, t]]
    return [t, row, float(gap)]


def _tp_serve(rep: dict, cfg, mesh, model, params, prompt, toks,
              expect: dict, one) -> None:
    """Phase 24's counted prefill and greedy decode of one model on a
    rank: launches, the sums over ranks (calls, bytes, seconds), the
    gathered logits' bytes, walls, peaks, and the tokens against one
    process's ``one`` (tokens, model, whole params) on rank 0."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.distributed import PSUM_COUNTS
    from repro_torch.launch import collectives
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model

    def snap():
        return (dict(PSUM_COUNTS),
                collectives.COLLECTIVE_COUNTS["all-gather"]["sent_bytes"])

    def since(before):
        psum, gathered = before
        return {"calls": PSUM_COUNTS["calls"] - psum["calls"],
                "part_bytes": PSUM_COUNTS["part_bytes"] - psum["part_bytes"],
                "seconds": PSUM_COUNTS["seconds"] - psum["seconds"],
                "gathered": collectives.COLLECTIVE_COUNTS["all-gather"][
                    "sent_bytes"] - gathered}

    prefill = make_prefill_step(model)
    prefill(params, {"tokens": toks[:, :256]})                # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    _zero_counts(expect)
    before = snap()
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    rep["prefill"] = {
        "wall_s": time.perf_counter() - t0, "launches": _counts(expect),
        "sums": since(before), "shape": list(logits.shape),
        "finite": bool(torch.isfinite(logits).all()),
        "peak_bytes": torch.cuda.max_memory_allocated()}
    if one is not None:
        # the bf16 runs' gap, and one process's own bf16 rounding (its f32
        # copy on the same weights), on the same tokens
        whole = make_prefill_step(one[1])(one[2], {"tokens": toks})
        rep["prefill"]["one_process_diff"] = \
            (logits - whole).abs().max().item()
        del logits
        f32 = build_model(dataclasses.replace(cfg, dtype="float32"))
        rep["prefill"]["one_f32_diff"] = (whole - make_prefill_step(f32)(
            one[2], {"tokens": toks})).abs().max().item()
        del whole
    else:
        del logits
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = snap()
    out = generate(model, params, prompt, TP_DECODE[1])
    rep["decode"] = {"decode_s": out["decode_s"],
                     "prefill_s": out["prefill_s"], "finite": out["finite"],
                     "tokens": out["tokens"].tolist(), "sums": since(before),
                     "peak_bytes": torch.cuda.max_memory_allocated()}
    if one is not None:
        mine = out["tokens"]
        rep["decode"]["one_process"] = one[0].tolist()
        rep["decode"]["mismatch"] = _first_mismatch(one[1], one[2], prompt,
                                                    mine, one[0])


def _tp_rank(rep: dict, note, free) -> None:
    """Phase 24 in one rank of phase 23's world (``mesh_rank``): fills
    ``rep["tp"]``."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.distributed import PSUM_COUNTS, ordered_pmean
    from repro_torch.interop import tree_leaves
    from repro_torch.kernels.ssm_scan import ssd_scan
    from repro_torch.launch import lm_ranks
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.dryrun import meta_params
    from repro_torch.launch.serve import generate
    from repro_torch.launch.sharding import rank_specs, shard_of, shard_tree
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    rank = dist.get_rank()
    tp = rep["tp"] = {}
    if rank == 0:
        tp["kernels"] = _tp_kernel_shapes()
    dist.barrier()
    free()
    note("(24) kernels at the rank shapes")

    # (a) stablelm-1.6b whole in bf16 on 1 x 4
    cfg = get_config(TP_ARCH)
    mesh, model = lm_ranks.rank_model(cfg, 1, MESH_RANKS)
    full = lm_ranks.full_params(model, SEED, "cuda")
    b, s = TP_PREFILL
    toks = lm_ranks.tokens(cfg, b, s, SEED + 6, "cuda")
    prompt = lm_ranks.tokens(cfg, TP_DECODE[0], MESH_PROMPT, SEED + 7,
                             "cuda")
    one = None
    if rank == 0:           # one process on the whole weights
        local = build_model(cfg)
        one = (generate(local, full, prompt, TP_DECODE[1])["tokens"], local,
               full)
    params = lm_ranks.rank_params(model, full)
    del full                # rank 0's one process keeps its own
    free()
    tp["a"] = {"rank_params": sum(t.numel() for t in tree_leaves(params))}
    tp["a"]["blocks"] = {k: list(v.shape) for k, v in (
        ("wq", params["stages"][0]["attn"]["wq"]),
        ("wi_gate", params["stages"][0]["mlp"]["wi_gate"]),
        ("embed", params["embed"]), ("head", params["head"]))}
    _tp_serve(tp["a"], cfg, mesh, model, params, prompt, toks,
              _flash_counts(cfg.n_layers, cfg.n_layers), one)
    del one, params
    free()
    note("(24a) stablelm-1.6b on 1 x 4")

    # (b) zamba2-2.7b at full width on 1 x 4, the whole weights drawn two
    # ranks at a time and cut
    hcfg = dataclasses.replace(get_config(TP_HYBRID_ARCH),
                               n_layers=TP_HYBRID_LAYERS)
    mesh, model = lm_ranks.rank_model(hcfg, 1, MESH_RANKS)
    toks = lm_ranks.tokens(hcfg, b, s, SEED + 8, "cuda")
    prompt = lm_ranks.tokens(hcfg, TP_DECODE[0], MESH_PROMPT, SEED + 9,
                             "cuda")
    params, one = None, None
    for turn in range(0, MESH_RANKS, 2):
        if rank in (turn, turn + 1):
            full = lm_ranks.full_params(model, SEED, "cuda")
            if rank == 0:
                local = build_model(hcfg)
                one = (generate(local, full, prompt, TP_DECODE[1])["tokens"],
                       local, full)
            params = lm_ranks.rank_params(model, full)
            del full
            free()
        dist.barrier()
    kinds = [st.kind for st in model.program for _ in range(st.count)]
    n_scan, n_attn = kinds.count("mamba"), kinds.count("shared_attn")
    tp["b"] = {"rank_params": sum(t.numel() for t in tree_leaves(params)),
               "scans": n_scan, "attns": n_attn}
    _tp_serve(tp["b"], hcfg, mesh, model, params, prompt, toks,
              {"ssd_scan": (ssd_scan, "launches", n_scan),
               **_flash_counts(n_attn, n_attn)}, one)
    del one, params
    free()
    note("(24b) zamba2-2.7b on 1 x 4")

    # (c) stablelm-1.6b on 2 x 2: SGD steps with remat
    mesh, model = lm_ranks.rank_model(cfg, 2, 2)
    specs = rank_specs(cfg, meta_params(model), mesh)
    params = lm_ranks.rank_params(model, lm_ranks.full_params(model, SEED,
                                                              "cuda"))
    free()
    tb, ts = MESH_TRAIN
    batch = lm_ranks.rank_batch(model, {"tokens": lm_ranks.tokens(
        cfg, tb, ts, SEED + 10, "cuda")})
    opt = sgd(TP_LR)
    state = opt.init(params)
    step = make_train_step(dataclasses.replace(model, remat=True), opt,
                           donate=True)
    # the mean over data, apart from the tensor-parallel sums
    mean_psum = {"calls": 0, "part_bytes": 0, "seconds": 0.0}
    inner = steps_mod._mesh_mean

    def counted_mean(*args):
        before = dict(PSUM_COUNTS)
        out = inner(*args)
        for k in mean_psum:
            mean_psum[k] += PSUM_COUNTS[k] - before[k]
        return out
    steps_mod._mesh_mean = counted_mean
    expect = _flash_counts(2 * TP_TRAIN_STEPS * cfg.n_layers,
                           2 * TP_TRAIN_STEPS * cfg.n_layers)
    torch.cuda.synchronize()
    dist.barrier()
    _zero_counts(expect)
    before = dict(PSUM_COUNTS)
    before_moved = _moved()
    losses, walls = [], []
    try:
        for _ in range(TP_TRAIN_STEPS):
            t0 = time.perf_counter()
            params, state, met = step(params, state, batch)
            losses.append(float(met["loss"]))
            walls.append(time.perf_counter() - t0)
    finally:
        steps_mod._mesh_mean = inner
    split = [bool(any(e is not None for e in sp))
             for sp in _spec_leaves(specs)]
    leaves = tree_leaves(params)
    # phase 26 (a)'s blocks of these weights (each FSDP leaf's block over
    # data, a view), which its own weights must equal bitwise
    fblocks = []
    for x, dim in zip(leaves, tree_leaves(build_model(
            cfg, mesh=mesh, fsdp=True).fsdp_dims)):
        if dim is not None:
            spec = [None] * x.dim()
            spec[dim] = "data"
            x = shard_of(x, tuple(spec), mesh)
        fblocks.append(x)
    tp["c"] = {
        "losses": losses, "step_s": walls, "launches": _counts(expect),
        "sums": {k: PSUM_COUNTS[k] - before[k] - mean_psum[k]
                 for k in mean_psum},
        "mean": mean_psum, "rows": batch["tokens"].shape[0],
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "moved": _moved_since(before_moved),
        "param_bytes": sum(x.numel() * x.element_size() for x in leaves),
        "fsdp_digest": _params_digest(fblocks),
        "whole_digest": _params_digest([x for x, sp in zip(leaves, split)
                                        if not sp]),
        "split_digest": _params_digest([x for x, sp in zip(leaves, split)
                                        if sp])}
    del params, state, step, leaves, fblocks
    free()
    note("(24c) stablelm-1.6b training on 2 x 2")

    # (d) f32 parity, TP_PARITY_LAYERS layers, against one process
    par = tp["d"] = {}
    for arch, extra in ((TP_ARCH, {}),
                        (TP_HYBRID_ARCH, {"attn_layer_interval": 2})):
        cfg32 = dataclasses.replace(get_config(arch), dtype="float32",
                                    n_layers=TP_PARITY_LAYERS, **extra)
        mesh, model = lm_ranks.rank_model(cfg32, 1, MESH_RANKS)
        local = build_model(cfg32)
        full = lm_ranks.full_params(local, SEED, "cuda")
        toks = lm_ranks.tokens(cfg32, 2, TP_PARITY_S, SEED + 11, "cuda")
        shard = shard_tree(full, rank_specs(cfg32, full, mesh), mesh)
        with torch.no_grad():
            want = local.forward(full, {"tokens": toks})[0]
            got = model.forward(shard, {"tokens": toks})[0]
        par[arch] = {"diff": (got - want).abs().max().item(),
                     "logit_max": want.abs().max().item()}
        del want, got
        # greedy decode through the rank's cache, against one process's
        prompt = lm_ranks.tokens(cfg32, TP_DECODE[0], MESH_PROMPT,
                                 SEED + 13, "cuda")
        mine = generate(model, shard, prompt, TP_DECODE[1])["tokens"]
        theirs = generate(local, full, prompt, TP_DECODE[1])["tokens"]
        par[arch]["decode"] = {
            "tokens": mine.tolist(),
            "mismatch": _first_mismatch(local, full, prompt, mine, theirs)}
        del full, shard
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                n_layers=TP_PARITY_LAYERS)
    mesh, model = lm_ranks.rank_model(cfg32, 2, 2)
    local = build_model(cfg32)
    full = lm_ranks.full_params(local, SEED, "cuda")
    gtoks = {"tokens": lm_ranks.tokens(cfg32, GRAD_BATCH, TRAIN_SEQ,
                                       SEED + 12, "cuda")}
    specs = rank_specs(cfg32, full, mesh)
    g_mesh, loss = torch.func.grad_and_value(
        lambda p, bt: model.loss(p, bt)[0])(shard_tree(full, specs, mesh),
                                            lm_ranks.rank_batch(
                                                model, gtoks))
    g_mesh = [ordered_pmean(x, mesh, "data") for x in tree_leaves(g_mesh)]
    loss = ordered_pmean(loss, mesh, "data").item()
    g_local, want = torch.func.grad_and_value(
        lambda p, bt: local.loss(p, bt)[0])(full, gtoks)
    worst, zero = 0.0, 0
    for gl, gm, sp in zip(tree_leaves(g_local), g_mesh, _spec_leaves(specs)):
        gl = shard_of(gl, sp, mesh)
        scale = gl.abs().max().item()
        if scale == 0.0 or gm.abs().max().item() == 0.0:
            zero += 1
            continue
        worst = max(worst, (gm - gl).abs().max().item() / scale)
    par["train"] = {"loss": loss, "local_loss": want.item(), "worst": worst,
                    "zero": zero, "leaves": len(g_mesh)}
    del full, g_mesh, g_local
    free()
    note("(24d) f32 parity")


def _cp_kernel_shapes() -> list:
    """Phase 25 on rank 0: flash_attention against its plain version at the
    shapes a rank of each of CP_MESHES gives it (its block of queries
    against the prefix of keys, right-aligned and causal), every call
    tensor-core, timed beside the plain version, SDPA with an explicit
    right-aligned mask (``is_causal`` aligns to the top left when S != Sk)
    and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.roofline import flash_attention_work
    cfg = get_config(CP_ARCH)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 14)
    out = []
    for dp, tp in CP_MESHES:
        s, h, kv = (CP_PREFILL // dp, cfg.n_heads // tp,
                    cfg.n_kv_heads // tp)
        d = cfg.resolved_head_dim
        for r in range(dp):
            sk = s * (r + 1)
            q = torch.randn(1, s, h, d, device="cuda", generator=g).bfloat16()
            k, v = (torch.randn(1, sk, kv, d, device="cuda", generator=g)
                    .bfloat16() for _ in range(2))
            got = _flash_routed(q, k, v, causal=True)
            err = _hold(f"flash_attention {CP_ARCH}'s rank {r} of {dp} x {tp}"
                        f" (seq over data) q {list(q.shape)} k/v "
                        f"{list(k.shape)} bf16 causal, right-aligned, vs "
                        f"flash_reference", got,
                        flash_attention(q, k, v, causal=True, backend="ref"),
                        *FLASH_BF16_VS_BF16)
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            mask = (torch.arange(sk, device="cuda")[None, :]
                    <= torch.arange(s, device="cuda")[:, None] + sk - s)

            def lib():
                return F.scaled_dot_product_attention(qh, kh, vh,
                                                      attn_mask=mask)
            lib_err = (lib().transpose(1, 2).float() - got.float()).abs() \
                .max().item()
            work = flash_attention_work(1, s, sk, h, kv, d, True, None,
                                        torch.bfloat16)
            out.append({
                "mesh": [dp, tp], "rank": r, "shape": [1, s, sk, h, kv, d],
                "causal": "right-aligned", "max_abs_err": err,
                "sdpa_diff": lib_err,
                "ms": _median_ms(lambda: flash_attention(q, k, v,
                                                         causal=True),
                                 reps=10),
                "plain_ms": _median_ms(lambda: flash_attention(
                    q, k, v, causal=True, backend="ref"), reps=3, warm=1),
                "library_ms": _median_ms(lib, reps=10),
                "bound_ms": work.bound_ms, "bound_by": work.bound_by})
            del q, k, v, qh, kh, vh, got
    return out


def _cp_counts() -> dict:
    """The transfers so far: the K/V gathers and their backward, the sums
    over ranks and the other gathers (calls and bytes)."""
    from repro_torch.core.distributed import PSUM_COUNTS
    from repro_torch.launch import collectives
    c = collectives.COLLECTIVE_COUNTS
    return {"seq_gather": [c["seq-gather"][k] for k in
                           ("calls", "sent_bytes", "received_bytes")],
            "seq_scatter": [c["seq-scatter"][k] for k in
                            ("calls", "sent_bytes")],
            "psum": [PSUM_COUNTS[k] for k in ("calls", "part_bytes")],
            "gather": [c["all-gather"][k] for k in ("calls", "sent_bytes")]}


def _cp_since(before: dict) -> dict:
    now = _cp_counts()
    return {k: [a - b for a, b in zip(now[k], before[k])] for k in now}


def _cp_rank(rep: dict, note, free) -> None:
    """Phase 25 in one rank of phase 23's world (``mesh_rank``): fills
    ``rep["cp"]``."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.distributed import ordered_psum
    from repro_torch.interop import tree_leaves
    from repro_torch.launch import lm_ranks
    from repro_torch.launch.dryrun import meta_params
    from repro_torch.launch.serve import generate
    from repro_torch.launch.sharding import rank_specs, shard_of, shard_tree
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    rank = dist.get_rank()
    cp = rep["cp"] = {}
    if rank == 0:
        cp["kernels"] = _cp_kernel_shapes()
    dist.barrier()
    free()
    note("(25e) kernels at the rank shapes")

    # (a) and (c): stablelm-1.6b whole in bf16 on each mesh, every rank
    # drawing the whole weights from the seed and reading its blocks of
    # them (views); (d) trains a copy of the 2 x 2 blocks
    cfg = get_config(CP_ARCH)
    full = lm_ranks.full_params(build_model(cfg), SEED, "cuda")
    toks = lm_ranks.tokens(cfg, 1, CP_PREFILL, SEED + 15, "cuda")
    cp["a"] = []
    for dp, tp in CP_MESHES:
        mesh, model = lm_ranks.rank_model(cfg, dp, tp, seq_axis="data")
        params = shard_tree(full, rank_specs(cfg, full, mesh), mesh)
        prefill = make_prefill_step(model)
        prefill(params, lm_ranks.rank_batch(
            model, {"tokens": toks[:, :256 * dp]}))       # warm-up
        torch.cuda.synchronize()
        batch = lm_ranks.rank_batch(model, {"tokens": toks})
        expect = _flash_counts(cfg.n_layers, cfg.n_layers)
        # each flash_attention call timed on the stream (the card is
        # shared by the ranks, so these include the peers' turns)
        events, inner = [], attn_mod.flash_attention

        def timed(*args, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = inner(*args, **kw)
            ev[1].record()
            events.append(ev)
            return out
        free()
        dist.barrier()
        _zero_counts(expect)
        before = _cp_counts()
        attn_mod.flash_attention = timed
        try:
            t0 = time.perf_counter()
            logits = prefill(params, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            attn_mod.flash_attention = inner
        cp["a"].append({
            "mesh": [dp, tp], "wall_s": wall, "launches": _counts(expect),
            "moved": _cp_since(before),
            "attention_ms": sum(a.elapsed_time(b) for a, b in events),
            "shape": list(logits.shape),
            "finite": bool(torch.isfinite(logits).all()),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "rank_params": sum(t.numel() for t in tree_leaves(params))})
        del logits, batch, prefill
        free()
        note(f"(25a) {CP_ARCH} prefill on {dp} x {tp}")
        if tp > 1:
            continue
        # (c) decode at batch 1 from the cache split over data
        prompt = lm_ranks.tokens(cfg, 1, CP_PROMPT, SEED + 16, "cuda")
        cache = model.init_cache(1, CP_PROMPT + CP_GEN, dtype=torch.float32,
                                 device="meta")
        dist.barrier()
        before = _cp_counts()
        out = generate(model, params, prompt, CP_GEN)
        cp["c"] = {
            "mesh": [dp, tp], "decode_s": out["decode_s"],
            "prefill_s": out["prefill_s"], "finite": out["finite"],
            "tokens": out["tokens"].tolist(), "moved": _cp_since(before),
            "cache_bytes": sum(c[k].numel() * c[k].element_size()
                               for c in cache for k in ("k", "v")),
            "slots": [c["k"].shape[-3] for c in cache],
            "peak_bytes": torch.cuda.max_memory_allocated()}
        del out
        free()
        note(f"(25c) {CP_ARCH} decode on {dp} x {tp}")

    # (d) SGD steps on 2 x 2 with remat "dots"
    mesh, model = lm_ranks.rank_model(cfg, 2, 2, seq_axis="data",
                                      remat=True, remat_policy="dots")
    specs = rank_specs(cfg, meta_params(model), mesh)
    params = lm_ranks.rank_params(model, full)
    del full
    batch = lm_ranks.rank_batch(model, {"tokens": lm_ranks.tokens(
        cfg, 1, CP_TRAIN_S, SEED + 19, "cuda")})
    opt = sgd(CP_LR)
    state = opt.init(params)
    step = make_train_step(model, opt, donate=True)
    expect = _flash_counts(2 * CP_TRAIN_STEPS * cfg.n_layers,
                           2 * CP_TRAIN_STEPS * cfg.n_layers)
    torch.cuda.synchronize()
    free()
    dist.barrier()
    _zero_counts(expect)
    before = _cp_counts()
    losses, walls = [], []
    for _ in range(CP_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        losses.append(float(met["loss"]))
        walls.append(time.perf_counter() - t0)
    split = [bool(any(e is not None for e in sp))
             for sp in _spec_leaves(specs)]
    leaves = tree_leaves(params)
    cp["d"] = {
        "losses": losses, "step_s": walls, "launches": _counts(expect),
        "moved": _cp_since(before),
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "whole_digest": _params_digest([x for x, sp in zip(leaves, split)
                                        if not sp]),
        "split_digest": _params_digest([x for x, sp in zip(leaves, split)
                                        if sp])}
    del params, state, step, leaves
    free()
    note("(25d) stablelm-1.6b training on 2 x 2")

    # (b) f32 copies against one process on the same weights
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                n_layers=CP_PARITY_LAYERS)
    local = build_model(cfg32)
    full = lm_ranks.full_params(local, SEED, "cuda")
    ptoks = {"tokens": lm_ranks.tokens(cfg32, 1, CP_PARITY_S, SEED + 17,
                                       "cuda")}
    pprompt = lm_ranks.tokens(cfg32, 1, CP_PROMPT, SEED + 18, "cuda")
    theirs = generate(local, full, pprompt, CP_GEN)["tokens"]
    g_local, want = torch.func.grad_and_value(
        lambda p, bt: local.loss(p, bt)[0])(full, ptoks)
    with torch.no_grad():
        want_logits = local.forward(full, ptoks)[0]
    cp["b"] = []
    for dp, tp in CP_MESHES:
        mesh, model = lm_ranks.rank_model(cfg32, dp, tp, seq_axis="data")
        specs = rank_specs(cfg32, full, mesh)
        shard = shard_tree(full, specs, mesh)
        blk = lm_ranks.rank_batch(model, ptoks)
        n = CP_PARITY_S // dp
        r = mesh.axis_index("data")
        with torch.no_grad():
            got = model.forward(shard, blk)[0]
        diff = (got - want_logits[:, r * n:(r + 1) * n]).abs().max().item()
        del got
        g_mesh, loss = torch.func.grad_and_value(
            lambda p, bt: model.loss(p, bt)[0])(shard, blk)
        loss = ordered_psum(loss, mesh, "data").item()
        worst, zero = 0.0, 0
        for gl, gm, sp in zip(tree_leaves(g_local), tree_leaves(g_mesh),
                              _spec_leaves(specs)):
            gm = ordered_psum(gm, mesh, "data")
            gl = shard_of(gl, sp, mesh)
            scale = gl.abs().max().item()
            if scale == 0.0 or gm.abs().max().item() == 0.0:
                zero += 1
                continue
            worst = max(worst, (gm - gl).abs().max().item() / scale)
        cp["b"].append({
            "mesh": [dp, tp], "diff": diff,
            "logit_max": want_logits.abs().max().item(), "loss": loss,
            "local_loss": want.item(), "worst": worst, "zero": zero,
            "leaves": len(tree_leaves(g_mesh))})
        if tp == 1:         # (c)'s layout: 14 slots a rank
            cp["b"][-1]["tokens"] = generate(model, shard, pprompt,
                                             CP_GEN)["tokens"].tolist()
            cp["b"][-1]["one_process"] = theirs.tolist()
        del g_mesh, shard
    del full, g_local, want_logits, local
    # the MoE at its config's capacity on 4 x 1: the whole sequence routed
    mcfg = dataclasses.replace(get_config(MOE_ARCH), dtype="float32",
                               n_layers=CP_PARITY_LAYERS)
    local = build_model(mcfg)
    full = lm_ranks.full_params(local, SEED, "cuda")
    mtoks = {"tokens": lm_ranks.tokens(mcfg, 1, CP_PARITY_S, SEED + 20,
                                       "cuda")}
    g_local, want = torch.func.grad_and_value(
        lambda p, bt: local.loss(p, bt)[0])(full, mtoks)
    mesh, model = lm_ranks.rank_model(mcfg, MESH_RANKS, 1, seq_axis="data")
    specs = rank_specs(mcfg, full, mesh)
    before = _cp_counts()
    g_mesh, loss = torch.func.grad_and_value(
        lambda p, bt: model.loss(p, bt)[0])(shard_tree(full, specs, mesh),
                                            lm_ranks.rank_batch(model,
                                                                mtoks))
    moved = _cp_since(before)
    loss = ordered_psum(loss, mesh, "data").item()
    worst, zero = 0.0, 0
    for gl, gm, sp in zip(tree_leaves(g_local), tree_leaves(g_mesh),
                          _spec_leaves(specs)):
        gm = ordered_psum(gm, mesh, "data")
        gl = shard_of(gl, sp, mesh)
        scale = gl.abs().max().item()
        if scale == 0.0 or gm.abs().max().item() == 0.0:
            zero += 1
            continue
        worst = max(worst, (gm - gl).abs().max().item() / scale)
    cp["b_moe"] = {"loss": loss, "local_loss": want.item(), "worst": worst,
                   "zero": zero, "leaves": len(tree_leaves(g_mesh)),
                   "moved": moved}
    del full, g_local, g_mesh, local
    free()
    note("(25b) f32 parity")


def _ha_cfg():
    """Phase 27 (a)'s config: HA_ARCH at full width, WIDE_LAYERS layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(HA_ARCH), n_layers=WIDE_LAYERS)


def _ha_mixer_cfg():
    """Phase 27 (b)'s config: TP_HYBRID_ARCH's smoke config narrowed by
    HA_MIXER, in f32."""
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(TP_HYBRID_ARCH),
                               dtype="float32", **HA_MIXER)


def _ha_kernel_shapes() -> dict:
    """Phase 27 on rank 0: flash_attention against its plain version at
    the shapes phase 27 (a)'s ranks give it (each block of query heads with
    the kv heads it reads, ``attention.kv_take``) and at the whole 40
    heads of ``head_axis=None``, every call tensor-core, timed beside SDPA
    (``enable_gqa`` where the kv heads group) and the bound; ssd_scan at
    (b)'s sub-heads (rank 1's: parents 0, 1, 1) against its chunked plain
    version, timed beside it and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssm_scan import ssd_chunked_reference, ssd_scan
    from repro_torch.launch.mesh import stand_in_mesh
    from repro_torch.launch.roofline import flash_attention_work, ssd_work
    from repro_torch.models.attention import head_block, kv_take
    cfg = _ha_cfg()
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 20)
    b, s = HA_PREFILL
    d = cfg.resolved_head_dim

    def normal(h):
        return torch.randn(b, s, h, d, device="cuda", generator=g).bfloat16()

    q_all = normal(cfg.n_heads)
    k_all, v_all = normal(cfg.n_kv_heads), normal(cfg.n_kv_heads)
    out = {"flash_attention": [], "ssd_scan": []}
    blocks = {}
    for r in range(HA_RANKS):
        q0, hq = head_block(cfg, stand_in_mesh({"data": 1, "model": HA_RANKS},
                                               r), "model")
        blocks.setdefault(hq, (f"rank {r}'s block", q0))
    blocks[cfg.n_heads] = ("whole (head_axis=None)", 0)
    for hq, (label, q0) in blocks.items():
        q = q_all[:, :, q0:q0 + hq].contiguous()
        take = kv_take(cfg, q0, hq)
        k, v = k_all[:, :, take].contiguous(), v_all[:, :, take].contiguous()
        kv = k.shape[2]
        # the kv heads the block's function reads: a list take repeats
        # them, one a query head, which the kernel then reads again
        distinct = len(set(take)) if isinstance(take, list) else kv
        got = _flash_routed(q, k, v, causal=True)
        err = _hold(f"flash_attention {HA_ARCH} {label} q {list(q.shape)} "
                    f"k/v {list(k.shape)} bf16 causal vs flash_reference",
                    got, flash_attention(q, k, v, causal=True,
                                         backend="ref"),
                    *FLASH_BF16_VS_BF16)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        work = flash_attention_work(b, s, s, hq, distinct, d, True, None,
                                    torch.bfloat16)
        out["flash_attention"].append({
            "arch": HA_ARCH, "block": label, "heads": [q0, hq],
            "shape": [b, s, hq, kv, d], "kv_read": distinct, "causal": True,
            "max_abs_err": err,
            "ms": _median_ms(lambda: flash_attention(q, k, v, causal=True),
                             reps=10),
            "plain_ms": _median_ms(lambda: flash_attention(
                q, k, v, causal=True, backend="ref"), reps=3, warm=1),
            "library_ms": _median_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=kv != hq), reps=10),
            "sdpa": "enable_gqa" if kv != hq else "kv repeated to the block",
            "bound_ms": work.bound_ms, "bound_by": work.bound_by})
    mc = _ha_mixer_cfg()
    dl = mc.ssm_expand * mc.d_model // MESH_RANKS
    p = math.gcd(dl, mc.ssm_head_dim)
    parents = torch.arange(dl, 2 * dl, p, device="cuda") // mc.ssm_head_dim
    args = _ssd_inputs(g, 2, HA_MIXER_S, dl // p, p, mc.ssm_state,
                       -(parents + 1).float())
    y, _ = ssd_scan(*args, chunk=64)
    shape = [2, HA_MIXER_S, dl // p, p, mc.ssm_state]
    err = _hold_scaled(f"ssd_scan phase 27 (b)'s sub-heads (rank 1 of 1 x "
                       f"{MESH_RANKS}, parents {parents.tolist()}) "
                       f"{shape[:4]} n={shape[4]} vs ssd_chunked_reference",
                       y, ssd_chunked_reference(*args, chunk=64)[0],
                       SSD_VS_CHUNKED_REL)
    work = ssd_work(*shape)
    out["ssd_scan"].append({
        "arch": mc.name, "shape": shape, "max_abs_err": err,
        "ms": _median_ms(lambda: ssd_scan(*args, chunk=64), reps=10),
        "plain_ms": _median_ms(lambda: ssd_chunked_reference(*args,
                                                             chunk=64),
                               reps=3, warm=1),
        "library_ms": None, "bound_ms": work.bound_ms,
        "bound_by": work.bound_by})
    return out


def _ha_qwen(ha: dict, cfg, mesh, model, free) -> None:
    """Phase 27 (a) on one rank of the (1, HA_RANKS) mesh: fills
    ``ha["a"]``."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.distributed import PSUM_COUNTS
    from repro_torch.launch import collectives, lm_ranks
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.attention import head_block
    from repro_torch.optim import sgd
    group = mesh.group(("data", "model"))
    first = mesh.axis_index("model") == 0
    full = lm_ranks.full_params(model, SEED, "cuda")
    params = lm_ranks.rank_params(model, full)
    if not first:
        full = None
    free()
    layer = params["stages"][0]
    a = ha["a"] = {"block": list(head_block(cfg, mesh, "model")),
                   "blocks": {"wq": list(layer["attn"]["wq"].shape),
                              "wi_gate": list(layer["mlp"]["wi_gate"].shape),
                              "embed": list(params["embed"].shape)}}
    runs = {"model": model,
            "none": dataclasses.replace(model, head_axis=None)}

    def sums_since(before):
        return [PSUM_COUNTS["calls"] - before["calls"],
                PSUM_COUNTS["part_bytes"] - before["part_bytes"],
                PSUM_COUNTS["seconds"] - before["seconds"]]

    b, s = HA_PREFILL
    toks = {"tokens": lm_ranks.tokens(cfg, b, s, SEED + 20, "cuda")}
    logits = {}
    for name, m in runs.items():
        prefill = make_prefill_step(m)
        # warm-up: the first at full size, for the pinned host buffers the
        # logits' gather stages through (then cached for both runs)
        prefill(params, toks if name == "model" else
                {"tokens": toks["tokens"][:, :256]})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier(group=group)
        expect = _flash_counts(cfg.n_layers, cfg.n_layers)
        _zero_counts(expect)
        before = dict(PSUM_COUNTS)
        gathered = collectives.COLLECTIVE_COUNTS["all-gather"]["sent_bytes"]
        t0 = time.perf_counter()
        logits[name] = prefill(params, toks)
        torch.cuda.synchronize()
        a["prefill_" + name] = {
            "wall_s": time.perf_counter() - t0, "launches": _counts(expect),
            "sums": sums_since(before),
            "gathered": collectives.COLLECTIVE_COUNTS["all-gather"][
                "sent_bytes"] - gathered,
            "shape": list(logits[name].shape),
            "finite": bool(torch.isfinite(logits[name]).all()),
            "peak_bytes": torch.cuda.max_memory_allocated()}
    a["gap"] = (logits["model"] - logits["none"]).abs().max().item()
    del logits
    free()
    # the f32 copy on the same weights against one process (rank 0)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    ptoks = {"tokens": lm_ranks.tokens(cfg, 1, HA_PARITY_S, SEED + 21,
                                       "cuda")}
    with torch.no_grad():
        got = dataclasses.replace(model, cfg=cfg32).forward(params,
                                                            ptoks)[0]
        if first:
            want = build_model(cfg32).forward(full, ptoks)[0]
            a["f32"] = {"diff": (got - want).abs().max().item(),
                        "logit_max": want.abs().max().item()}
            del want
    del got, full
    free()
    # SGD steps with and without head_axis from the same weights
    tb, ts = MESH_TRAIN
    batch = {"tokens": lm_ranks.tokens(cfg, tb, ts, SEED + 22, "cuda")}
    for name, m in runs.items():
        opt = sgd(TP_LR)
        p, state = params, opt.init(params)
        step = make_train_step(m, opt)
        n = TP_TRAIN_STEPS * cfg.n_layers
        expect = _flash_counts(n, n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier(group=group)
        _zero_counts(expect)
        before = dict(PSUM_COUNTS)
        losses, walls = [], []
        for _ in range(TP_TRAIN_STEPS):
            t0 = time.perf_counter()
            p, state, met = step(p, state, batch)
            losses.append(float(met["loss"]))
            walls.append(time.perf_counter() - t0)
        a["train_" + name] = {
            "losses": losses, "step_s": walls, "launches": _counts(expect),
            "sums": sums_since(before),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "attn_digest": _params_digest(p["stages"][0]["attn"])}
        del p, state, step
        free()


def _ha_mixer(ha: dict, free) -> None:
    """Phase 27 (b) on one rank of 1 x MESH_RANKS: fills ``ha["b"]``."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.ssm_scan import ssd_scan
    from repro_torch.launch import lm_ranks
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    mc = _ha_mixer_cfg()
    mesh, model = lm_ranks.rank_model(mc, 1, MESH_RANKS, head_axis="model")
    local = build_model(mc)
    full = lm_ranks.full_params(local, SEED, "cuda")
    params = lm_ranks.rank_params(model, full)
    kinds = [st.kind for st in model.program for _ in range(st.count)]
    n_scan, n_attn = kinds.count("mamba"), kinds.count("shared_attn")
    toks = {"tokens": lm_ranks.tokens(mc, 2, HA_MIXER_S, SEED + 23,
                                      "cuda")}
    expect = {"ssd_scan": (ssd_scan, "launches", n_scan),
              **_flash_counts(n_attn, 0)}
    dist.barrier()
    _zero_counts(expect)
    with torch.no_grad():
        got = model.forward(params, toks)[0]
    hb = ha["b"] = {
        "launches": _counts(expect), "scans": n_scan, "attns": n_attn,
        "w_x": list(params["stages"][0]["mixer"]["w_x"].shape),
        "w_dt": list(params["stages"][0]["mixer"]["w_dt"].shape),
        "ssm_cache": list(model.init_cache(2, 16, device="meta")[0][
            "ssm"].shape)}
    prompt = lm_ranks.tokens(mc, TP_DECODE[0], MESH_PROMPT, SEED + 24,
                             "cuda")
    hb["tokens"] = generate(model, params, prompt,
                            HA_MIXER_GEN)["tokens"].tolist()
    if mesh.axis_index("model") == 0:
        with torch.no_grad():
            want = local.forward(full, toks)[0]
        hb["diff"] = (got - want).abs().max().item()
        hb["logit_max"] = want.abs().max().item()
        hb["one_process"] = generate(local, full, prompt,
                                     HA_MIXER_GEN)["tokens"].tolist()
    del full, params, got
    free()


def _ha_rank(rep: dict, note, free) -> None:
    """Phase 27 in one rank of phase 23's world (``mesh_rank``): fills
    ``rep["ha"]``."""
    import torch.distributed as dist
    from repro_torch.launch import lm_ranks
    ha = rep["ha"] = {}
    if dist.get_rank() == 0:
        ha["kernels"] = _ha_kernel_shapes()
    dist.barrier()
    free()
    note("(27) kernels at the rank shapes")
    cfg = _ha_cfg()
    # every rank of the world makes the sub-group; the last one waits
    mesh, model = lm_ranks.rank_model(cfg, 1, HA_RANKS, head_axis="model",
                                      ranks=range(HA_RANKS))
    t0 = time.perf_counter()
    if mesh is not None:
        _ha_qwen(ha, cfg, mesh, model, free)
    dist.barrier()
    ha["a_wall_s"] = time.perf_counter() - t0
    free()
    note(f"(27a) {HA_ARCH} with head_axis on 1 x {HA_RANKS}")
    _ha_mixer(ha, free)
    note("(27b) the Mamba2 mixer split inside heads on 1 x 4")


def _cs_ssd_shapes() -> list:
    """Phase 28's ssd_scan entries: zamba2-2.7b's rank of each of
    CP_MESHES on the whole gathered sequence (the last model rank's
    heads), against the chunked plain version, timed beside it and the
    bound (no single PyTorch call computes the scan)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan import ssd_chunked_reference, ssd_scan
    from repro_torch.launch.roofline import ssd_work
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 48)
    s, zc, out = CS_PREFILL, get_config(HYBRID_ARCH), []
    h_all = zc.ssm_expand * zc.d_model // zc.ssm_head_dim
    p, n = zc.ssm_head_dim, zc.ssm_state
    for dp, tp in CP_MESHES:
        h = h_all // tp
        # the last model rank's heads: A = -(h_all - h + 1 .. h_all)
        a = -torch.arange(h_all - h + 1, h_all + 1, dtype=torch.float32,
                          device="cuda")
        args = _ssd_inputs(g, 1, s, h, p, n, a)
        y, _ = ssd_scan(*args, chunk=64)
        err = _hold_scaled(f"ssd_scan {HYBRID_ARCH}'s rank of {dp} x {tp} "
                           f"(seq over data: the whole gathered sequence) "
                           f"{[1, s, h, p]} n={n} vs ssd_chunked_reference",
                           y, ssd_chunked_reference(*args, chunk=64)[0],
                           SSD_VS_CHUNKED_REL)
        work = ssd_work(1, s, h, p, n)
        out.append({
            "arch": HYBRID_ARCH, "mesh": [dp, tp], "shape": [1, s, h, p, n],
            "max_abs_err": err,
            "ms": _median_ms(lambda: ssd_scan(*args, chunk=64), reps=10),
            "plain_ms": _median_ms(lambda: ssd_chunked_reference(
                *args, chunk=64), reps=3, warm=1),
            "library_ms": None, "bound_ms": work.bound_ms,
            "bound_by": work.bound_by})
        del args, y
    return out


def _cs_slstm_shapes() -> list:
    """Phase 28's slstm_scan entry: xlstm-350m's sLSTM on the whole
    gathered sequence, against the plain loop (timed once, on its run: it
    takes ~2 s at this length), beside the bound (no PyTorch call computes
    the cell)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.slstm_fused import slstm_reference, slstm_scan
    from repro_torch.launch.roofline import slstm_work
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 49)
    s, xc = CS_PREFILL, get_config(XLSTM_ARCH)
    h = xc.n_heads
    p = xc.d_model // h
    pre, r = _slstm_inputs(g, 1, s, h, p, SLSTM_PRE_STD, SLSTM_R_STD)
    got = slstm_scan(pre, r)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    want = slstm_reference(pre, r)[0]
    ev[1].record()
    torch.cuda.synchronize()
    err = _hold(f"slstm_scan {XLSTM_ARCH}'s rank of {MESH_RANKS} x 1 (the "
                f"whole gathered sequence) pre {[1, s, 4, h, p]} vs "
                f"slstm_reference", got, want, SLSTM_TOL, 0.0)
    work = slstm_work(1, s, h, p)
    return [{"arch": XLSTM_ARCH, "mesh": [MESH_RANKS, 1],
             "shape": [1, s, h, p], "max_abs_err": err,
             "ms": _median_ms(lambda: slstm_scan(pre, r), reps=5, warm=1),
             "plain_ms": ev[0].elapsed_time(ev[1]), "library_ms": None,
             "bound_ms": work.bound_ms, "bound_by": work.bound_by}]


def _cs_flash_shapes() -> list:
    """Phase 28's flash_attention entries: the last rank's block of
    queries against the whole prefix (zamba2-2.7b on each of CP_MESHES,
    qwen2-vl-72b on 2 x 2, Whisper's decoder on MESH_RANKS x 1) and
    Whisper's encoder whole, bf16 (the tensor-core route), against the
    plain version, timed beside it, SDPA (a right-aligned mask) and the
    bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.roofline import flash_attention_work
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 50)
    s, out = CS_PREFILL, []
    zc, vc, ac = (get_config(a) for a in (HYBRID_ARCH, VISION_ARCH,
                                           AUDIO_ARCH))
    # (arch, part, b, s, sk, h, kv, d, causal)
    cases = [(HYBRID_ARCH, f"last rank of {dp} x {tp}", 1, s // dp, s,
              zc.n_heads // tp, zc.n_kv_heads // tp, zc.resolved_head_dim,
              True) for dp, tp in CP_MESHES]
    cases += [(VISION_ARCH, "last rank of 2 x 2", 1, s // 2, s,
               vc.n_heads // 2, vc.n_kv_heads // 2, vc.resolved_head_dim,
               True),
              (AUDIO_ARCH, f"decoder, last rank of {MESH_RANKS} x 1",
               AUDIO_B, AUDIO_S // MESH_RANKS, AUDIO_S, ac.n_heads,
               ac.n_kv_heads, ac.resolved_head_dim, True),
              (AUDIO_ARCH, "encoder, whole on every rank", AUDIO_B,
               ac.encoder_seq, ac.encoder_seq, ac.n_heads, ac.n_kv_heads,
               ac.resolved_head_dim, False)]
    for arch, part, b, sq, sk, h, kv, d, causal in cases:
        q = torch.randn(b, sq, h, d, device="cuda", generator=g).bfloat16()
        k, v = (torch.randn(b, sk, kv, d, device="cuda", generator=g)
                .bfloat16() for _ in range(2))
        got = _flash_routed(q, k, v, causal=causal)
        err = _hold(f"flash_attention {arch}'s {part} q {list(q.shape)} "
                    f"k/v {list(k.shape)} bf16 "
                    f"{'causal, right-aligned' if causal else 'bidirectional'}"
                    f" vs flash_reference", got,
                    flash_attention(q, k, v, causal=causal, backend="ref"),
                    *FLASH_BF16_VS_BF16)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None
        if causal:
            mask = (torch.arange(sk, device="cuda")[None, :]
                    <= torch.arange(sq, device="cuda")[:, None] + sk - sq)

        def lib():
            return F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, enable_gqa=kv != h)
        work = flash_attention_work(b, sq, sk, h, kv, d, causal, None,
                                    torch.bfloat16)
        out.append({
            "arch": arch, "part": part, "shape": [b, sq, sk, h, kv, d],
            "causal": "right-aligned" if causal else False,
            "max_abs_err": err,
            "sdpa_diff": (lib().transpose(1, 2).float() - got.float())
            .abs().max().item(),
            "ms": _median_ms(lambda: flash_attention(q, k, v, causal=causal),
                             reps=10),
            "plain_ms": _median_ms(lambda: flash_attention(
                q, k, v, causal=causal, backend="ref"), reps=3, warm=1),
            "library_ms": _median_ms(lib, reps=10),
            "bound_ms": work.bound_ms, "bound_by": work.bound_by})
        del q, k, v, qh, kh, vh, got, mask
    return out


# phase 28's kernel checks, one kernel a rank: rank -> (kernel, its check)
_CS_KERNEL_RANKS = {0: ("flash_attention", _cs_flash_shapes),
                    1: ("ssd_scan", _cs_ssd_shapes),
                    2: ("slstm_scan", _cs_slstm_shapes)}


def _cs_timed(expect: dict, fn, mixers=()) -> tuple:
    """``fn()`` once on every rank together: its counts in ``expect`` from
    0, its transfers (``_cp_since``), its wall and its device time (CUDA
    events on the rank's stream, the card shared by the ranks), and the
    summed device time of the calls to each (module, name) of ``mixers``
    (the functions wrapped for the call). Returns (fn's result, report)."""
    import torch
    import torch.distributed as dist
    events, saved = [], []

    def timed(inner):
        def call(*args, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = inner(*args, **kw)
            ev[1].record()
            events.append(ev)
            return out
        return call
    torch.cuda.synchronize()
    dist.barrier()
    _zero_counts(expect)
    before = _cp_counts()
    whole = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for mod, name in mixers:
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, timed(getattr(mod, name)))
    try:
        t0 = time.perf_counter()
        whole[0].record()
        out = fn()
        whole[1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, name, inner in saved:
            setattr(mod, name, inner)
    return out, {"wall_s": wall, "launches": _counts(expect),
                 "moved": _cp_since(before),
                 "device_ms": whole[0].elapsed_time(whole[1]),
                 "mixer_ms": sum(a.elapsed_time(b) for a, b in events),
                 "peak_bytes": torch.cuda.max_memory_allocated()}


class _FinalNormInput:
    """Keeps the input of the last ``apply_norm`` that ``models/api.py``
    calls (in an xLSTM model, the final norm's: the hidden state)."""

    def __enter__(self):
        from repro_torch.models import api
        self.api, self.inner, self.seen = api, api.apply_norm, None

        def record(p, x, *args, **kw):
            self.seen = x
            return self.inner(p, x, *args, **kw)
        api.apply_norm = record
        return self

    def __exit__(self, *exc):
        self.api.apply_norm = self.inner


def _cs_block(t, mesh, dim: int = 1):
    """This rank's block of the whole-sequence ``t`` along ``dim`` (its
    index along ``"data"``)."""
    m = t.shape[dim] // mesh.axis_size("data")
    return t.narrow(dim, mesh.axis_index("data") * m, m)


def _cs_hybrid(cs: dict, note, free) -> None:
    """Phase 28 (a): CS_HYBRID_ARCH at CS_HYBRID_LAYERS layers."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.interop import tree_leaves
    from repro_torch.kernels.ssm_scan import ssd_scan
    from repro_torch.launch import lm_ranks
    from repro_torch.launch.dryrun import meta_params
    from repro_torch.launch.serve import generate
    from repro_torch.launch.sharding import rank_specs, shard_tree
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.models import build_model
    from repro_torch.models import mamba2 as mamba_lib
    from repro_torch.optim import sgd
    cfg = dataclasses.replace(get_config(HYBRID_ARCH),
                              n_layers=CS_HYBRID_LAYERS)
    one = build_model(cfg)
    cs["a_kinds"] = [st.kind for st in one.program for _ in range(st.count)]
    full = lm_ranks.full_params(one, SEED, "cuda")
    toks = {"tokens": lm_ranks.tokens(cfg, 1, CS_PREFILL, SEED + 40,
                                      "cuda")}
    expect = {"ssd_scan": (ssd_scan, "launches", 0), **_flash_counts(0, 0)}
    mixers = ((mamba_lib, "mamba2_forward"),)
    cs["a"] = []
    for dp, tp in CP_MESHES:
        row = {"mesh": [dp, tp]}
        for name, axis in (("seq", "data"), ("none", None)):
            mesh, model = lm_ranks.rank_model(cfg, dp, tp, seq_axis=axis)
            params = shard_tree(full, rank_specs(cfg, full, mesh), mesh)
            prefill = make_prefill_step(model)
            prefill(params, lm_ranks.rank_batch(
                model, {"tokens": toks["tokens"][:, :256 * dp]}))  # warm-up
            batch = lm_ranks.rank_batch(model, toks)
            free()
            logits, run = _cs_timed(expect, lambda: prefill(params, batch),
                                    mixers)
            run.update(shape=list(logits.shape),
                       finite=bool(torch.isfinite(logits).all()))
            row[name] = run
            if axis is not None:
                mine = logits
            else:
                row["gap"] = (mine - _cs_block(logits, mesh)).abs().max() \
                    .item()
            del logits, batch, prefill, params
        del mine
        cs["a"].append(row)
        free()
        note(f"(28a) {HYBRID_ARCH} prefills on {dp} x {tp}")

    # the f32 copy against one process: the prefill on each mesh, greedy
    # decode from the split cache on MESH_RANKS x 1
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    local = build_model(cfg32)
    ptoks = {"tokens": lm_ranks.tokens(cfg32, 1, CS_PARITY_S, SEED + 41,
                                       "cuda")}
    prompt = lm_ranks.tokens(cfg32, 1, CS_PROMPT, SEED + 42, "cuda")
    with torch.no_grad():
        want = local.forward(full, ptoks)[0]
    theirs = generate(local, full, prompt, CS_GEN)["tokens"].tolist()
    cs["a_f32"] = []
    for dp, tp in CP_MESHES:
        mesh, model = lm_ranks.rank_model(cfg32, dp, tp, seq_axis="data")
        shard = shard_tree(full, rank_specs(cfg32, full, mesh), mesh)
        before = _cp_counts()
        with torch.no_grad():
            got = model.forward(shard, lm_ranks.rank_batch(model, ptoks))[0]
        entry = {"mesh": [dp, tp], "moved": _cp_since(before),
                 "diff": (got - _cs_block(want, mesh)).abs().max().item(),
                 "logit_max": want.abs().max().item()}
        if tp == 1:
            cache = model.init_cache(1, CS_PROMPT + CS_GEN,
                                     dtype=torch.float32, device="meta")
            entry.update(
                slots=[c["k"].shape[-3] for c in cache if "k" in c],
                tokens=generate(model, shard, prompt, CS_GEN)["tokens"]
                .tolist(), one_process=theirs)
        cs["a_f32"].append(entry)
        del got, shard
    del want, local
    note(f"(28a) {HYBRID_ARCH} f32 copies and decode")

    # CS_TRAIN_STEPS SGD steps on 2 x 2 with remat "dots"
    mesh, model = lm_ranks.rank_model(cfg, 2, 2, seq_axis="data",
                                      remat=True, remat_policy="dots")
    specs = rank_specs(cfg, meta_params(model), mesh)
    params = lm_ranks.rank_params(model, full)
    del full
    batch = lm_ranks.rank_batch(model, {"tokens": lm_ranks.tokens(
        cfg, 1, CS_TRAIN_S, SEED + 43, "cuda")})
    opt = sgd(CS_LR)
    state = opt.init(params)
    step = make_train_step(model, opt, donate=True)
    free()
    dist.barrier()
    _zero_counts(expect)
    losses, walls, moved = [], [], []
    for _ in range(CS_TRAIN_STEPS):
        before = _cp_counts()
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        losses.append(float(met["loss"]))
        walls.append(time.perf_counter() - t0)
        moved.append(_cp_since(before))
    split = [any(e is not None for e in sp) for sp in _spec_leaves(specs)]
    leaves = tree_leaves(params)
    cs["a_train"] = {
        "losses": losses, "step_s": walls, "moved": moved,
        "launches": _counts(expect),
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "whole_digest": _params_digest([x for x, sp in zip(leaves, split)
                                        if not sp])}
    del params, state, step, leaves
    note(f"(28a) {HYBRID_ARCH} training")


def _cs_xlstm(cs: dict, note, free) -> None:
    """Phase 28 (b): xlstm-350m whole on MESH_RANKS x 1 against one
    process, bf16 and f32."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.slstm_fused import slstm_scan
    from repro_torch.launch import lm_ranks
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.models import xlstm as xlstm_lib
    cfg = get_config(XLSTM_ARCH)
    full = lm_ranks.full_params(build_model(cfg), SEED, "cuda")
    toks = {"tokens": lm_ranks.tokens(cfg, 1, CS_PREFILL, SEED + 44, "cuda")}
    expect = {"slstm_scan": (slstm_scan, "launches", 0)}
    mixers = ((xlstm_lib, "mlstm_forward"), (xlstm_lib, "slstm_forward"))
    cs["b"] = []
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        mesh, model = lm_ranks.rank_model(c, MESH_RANKS, 1, seq_axis="data")
        local = build_model(c)
        batch = lm_ranks.rank_batch(model, toks)
        row = {"dtype": dtype}
        for name, m, b in (("none", local, toks), ("seq", model, batch)):
            prefill = make_prefill_step(m)
            prefill(full, {"tokens": b["tokens"][:, :256]})    # warm-up
            free()
            with _FinalNormInput() as seen:
                logits, row[name] = _cs_timed(
                    expect, lambda: prefill(full, b), mixers)
            if m is local:
                want = _cs_block(logits, mesh).clone()
                want_h = _cs_block(seen.seen, mesh).clone()
                del logits, seen
        row.update(
            shape=list(logits.shape),
            finite=bool(torch.isfinite(logits).all()),
            hidden_gap=(seen.seen.float() - want_h.float()).abs().max()
            .item(),
            gap=(logits - want).abs().max().item(),
            logit_max=want.abs().max().item())
        cs["b"].append(row)
        del logits, seen, want, want_h, prefill
        free()
        note(f"(28b) {XLSTM_ARCH} {dtype}")
    del full


def _cs_vision(cs: dict, note, free) -> None:
    """Phase 28 (c): VISION_ARCH at full width with WIDE_LAYERS layers on
    2 x 2, seq_axis="data" beside seq_axis=None."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.distributed import ordered_psum
    from repro_torch.interop import tree_leaves
    from repro_torch.launch import lm_ranks
    from repro_torch.launch.steps import make_prefill_step
    cfg = dataclasses.replace(get_config(VISION_ARCH), n_layers=WIDE_LAYERS)
    mesh, model = lm_ranks.rank_model(cfg, 2, 2, seq_axis="data")
    _, model0 = lm_ranks.rank_model(cfg, 2, 2)
    # the whole f32 weights (~17 GB) drawn by one rank at a time, each
    # keeping its block
    params = None
    for turn in range(MESH_RANKS):
        if dist.get_rank() == turn:
            params = lm_ranks.rank_params(
                model, lm_ranks.full_params(model, SEED, "cuda"))
            free()
        dist.barrier()
    note(f"(28c) {VISION_ARCH} weights")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 45)
    vt = cfg.vision_tokens
    vis = 0.1 * torch.randn((1, vt, cfg.d_model), device="cuda",
                            generator=gen)
    whole = {"tokens": lm_ranks.tokens(cfg, 1, CS_PREFILL - vt, SEED + 46,
                                       "cuda"), "vision_embed": vis}
    small = {"tokens": whole["tokens"][:, :CS_PARITY_S - vt],
             "vision_embed": vis}
    expect = _flash_counts(0, 0)
    row = {"mesh": [2, 2],
           "rank_params": sum(t.numel() for t in tree_leaves(params))}
    for name, m in (("seq", model), ("none", model0)):
        prefill = make_prefill_step(m)
        prefill(params, lm_ranks.rank_batch(m, small))      # warm-up
        batch = lm_ranks.rank_batch(m, whole)
        row[name + "_rows"] = [batch["vision_embed"].shape[1],
                               batch["tokens"].shape[1]]
        free()
        logits, row[name] = _cs_timed(expect, lambda: prefill(params, batch))
        row[name].update(shape=list(logits.shape), finite=bool(
            torch.isfinite(logits).all()))
        if m is model:
            mine = logits
        else:
            row["gap"] = (mine - _cs_block(logits, mesh)).abs().max().item()
        del logits, batch, prefill
        note(f"(28c) {VISION_ARCH} prefill ({name})")
    del mine
    free()
    # the f32 copy at 1 x CS_PARITY_S (vision_tokens, then text): its
    # logits and its loss, only the text targets, beside seq_axis=None
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = lm_ranks.rank_model(cfg32, 2, 2, seq_axis="data")[1]
    n32 = lm_ranks.rank_model(cfg32, 2, 2)[1]
    with torch.no_grad():
        blk = lm_ranks.rank_batch(m32, small)
        got = m32.forward(params, blk)[0]
        share = m32.loss(params, blk)[0]
        want = n32.forward(params, small)[0]
        loss = n32.loss(params, small)[0]
    row["f32"] = {"diff": (got - _cs_block(want, mesh)).abs().max().item(),
                  "logit_max": want.abs().max().item(),
                  "loss": ordered_psum(share, mesh, "data").item(),
                  "share": share.item(), "local_loss": loss.item(),
                  "rows": [blk["vision_embed"].shape[1],
                           blk["tokens"].shape[1]]}
    cs["c"] = row
    note(f"(28c) {VISION_ARCH} f32 copy")
    del params, got, want, vis, whole


def _cs_audio(cs: dict, note, free) -> None:
    """Phase 28 (d): whisper-base whole on MESH_RANKS x 1 against one
    process."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.interop import tree_leaves
    from repro_torch.launch import lm_ranks
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    cfg = get_config(AUDIO_ARCH)
    local = build_model(cfg)
    full = lm_ranks.full_params(local, SEED, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 47)
    frames = _frames(cfg, AUDIO_B, gen)
    whole = {"tokens": torch.randint(0, cfg.vocab, (AUDIO_B, AUDIO_S),
                                     device="cuda", generator=gen),
             "audio_embed": frames}
    mesh, model = lm_ranks.rank_model(cfg, MESH_RANKS, 1, seq_axis="data")
    batch = lm_ranks.rank_batch(model, whole)
    expect = _flash_counts(0, 0)
    row = {"rows": [list(batch["tokens"].shape),
                    list(batch["audio_embed"].shape)]}
    for name, m, b in (("none", local, whole), ("seq", model, batch)):
        prefill = make_prefill_step(m)
        prefill(full, b)                                    # warm-up
        free()
        logits, row[name] = _cs_timed(expect, lambda: prefill(full, b))
        row[name].update(shape=list(logits.shape), finite=bool(
            torch.isfinite(logits).all()))
        if m is local:
            want = _cs_block(logits, mesh).clone()
            del logits
    row["gap"] = (logits - want).abs().max().item()
    del logits, want, prefill
    note(f"(28d) {AUDIO_ARCH} prefills")
    # the f32 copy, and greedy decode of a batch of one from split caches
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    local32 = build_model(cfg32)
    model32 = lm_ranks.rank_model(cfg32, MESH_RANKS, 1, seq_axis="data")[1]
    with torch.no_grad():
        got = model32.forward(full, batch)[0]
        want = _cs_block(local32.forward(full, whole)[0], mesh)
    prompt = whole["tokens"][:1, :CS_PROMPT]
    row["f32"] = {
        "diff": (got - want).abs().max().item(),
        "logit_max": want.abs().max().item(),
        "tokens": generate(model32, full, prompt, CS_GEN,
                           audio_embed=frames[:1])["tokens"].tolist(),
        "one_process": generate(local32, full, prompt, CS_GEN,
                                audio_embed=frames[:1])["tokens"].tolist()}
    del got, want, local32, model32
    note(f"(28d) {AUDIO_ARCH} f32 copy and decode")
    # CS_TRAIN_STEPS SGD steps on CS_AUDIO_TRAIN_B of the rows (every
    # leaf whole on every rank)
    rows = {k: v[:CS_AUDIO_TRAIN_B] for k, v in whole.items()}
    batch = lm_ranks.rank_batch(model, rows)
    with torch.no_grad():
        row["local_loss"] = local.loss(full, rows)[0].item()
    params = lm_ranks.rank_params(model, full)
    del full
    opt = sgd(CS_LR)
    state = opt.init(params)
    step = make_train_step(model, opt, donate=True)
    free()
    dist.barrier()
    _zero_counts(expect)
    losses, walls, moved = [], [], []
    for _ in range(CS_TRAIN_STEPS):
        before = _cp_counts()
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        losses.append(float(met["loss"]))
        walls.append(time.perf_counter() - t0)
        moved.append(_cp_since(before))
    row["train"] = {"losses": losses, "step_s": walls, "moved": moved,
                    "launches": _counts(expect),
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "digest": _params_digest(tree_leaves(params))}
    cs["d"] = row
    del params, state, step
    note(f"(28d) {AUDIO_ARCH} training")


def _cs_rank(rep: dict, note, free) -> None:
    """Phase 28 in one rank of phase 23's world (``mesh_rank``): fills
    ``rep["cs"]``."""
    import torch.distributed as dist
    cs = rep["cs"] = {}
    if dist.get_rank() in _CS_KERNEL_RANKS:
        kernel, check = _CS_KERNEL_RANKS[dist.get_rank()]
        cs["kernels"] = {kernel: check()}
    dist.barrier()
    free()
    note("(28) kernels at the rank shapes")
    for part in (_cs_hybrid, _cs_xlstm, _cs_vision, _cs_audio):
        part(cs, note, free)
        free()



def _cl_moved() -> list:
    """[sums, their bytes, gathers, their bytes, the sums' seconds] this
    process's transfers made so far."""
    from repro_torch.core.distributed import PSUM_COUNTS
    from repro_torch.launch import collectives
    g = collectives.COLLECTIVE_COUNTS["all-gather"]
    return [PSUM_COUNTS["calls"], PSUM_COUNTS["part_bytes"], g["calls"],
            g["sent_bytes"], PSUM_COUNTS["seconds"]]


def _cl_decode(model, params, prompt, audio, b: int) -> tuple:
    """Phase 29's counted ``serve.generate`` of ``prompt`` (the rank's
    rows) with the global batch ``b``: (its last logits, {tokens, walls,
    what the decode steps moved, the sums' seconds, the bytes of the
    cache's KV leaves})."""
    import torch
    from repro_torch.interop import tree_leaves
    from repro_torch.launch.serve import generate
    torch.cuda.synchronize()
    before = _cl_moved()
    out = generate(model, params, prompt, CL_GEN, audio_embed=audio,
                   global_batch=b)
    moved = [x - y for x, y in zip(_cl_moved(), before)]
    cache = model.init_cache(prompt.shape[0], CL_PROMPT + CL_GEN,
                             dtype=torch.float32, device="meta",
                             global_batch=b)
    kv = sum(t.numel() * t.element_size() for t in tree_leaves(cache)
             if t.dim() >= 4)
    return out["logits"], {
        "tokens": out["tokens"].tolist(), "finite": out["finite"],
        "decode_s": out["decode_s"], "prefill_s": out["prefill_s"],
        "moved": moved[:4], "sum_s": moved[4], "kv_bytes": kv}


def _cl_rank(rep: dict, note, free) -> None:
    """Phase 29 in one rank of phase 23's world (``mesh_rank``): fills
    ``rep["cl"]``."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import lm_ranks
    from repro_torch.launch.serve import generate
    from repro_torch.launch.sharding import rank_specs, shard_tree
    from repro_torch.models import build_model
    cl = rep["cl"] = {"a": [], "b": []}
    # (a) CL_ARCH at full width, WIDE_LAYERS layers
    cfg = dataclasses.replace(get_config(CL_ARCH), n_layers=WIDE_LAYERS)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    local = build_model(cfg32)
    full = lm_ranks.full_params(local, SEED, "cuda")
    for (dp, tp), b in CL_MESHES:
        prompt = lm_ranks.tokens(cfg, b, CL_PROMPT, SEED + 50, "cuda")
        with torch.no_grad():
            want, one = _cl_decode(local, full, prompt, None, b)
        entry = {"mesh": [dp, tp], "b": b, "one_process": one}
        for c in (cfg, cfg32):
            mesh, model = lm_ranks.rank_model(c, dp, tp)
            shard = shard_tree(full, rank_specs(c, full, mesh), mesh)
            rows = b // dp if b % dp == 0 else b
            lo = entry["lo"] = \
                mesh.axis_index("data") * rows if b % dp == 0 else 0
            dist.barrier()
            with torch.no_grad():
                logits, entry[c.dtype] = _cl_decode(
                    model, shard, prompt[lo:lo + rows], None, b)
            if c is cfg32:
                entry["diff"] = (logits - want[lo:lo + rows]).abs().max() \
                    .item()
                entry["logit_max"] = want.abs().max().item()
            del shard, logits
        cl["a"].append(entry)
        del want
        note(f"(29a) {CL_ARCH} on {dp} x {tp}")
    del full, local
    free()
    # (b) AUDIO_ARCH whole, f32
    cfg32 = dataclasses.replace(get_config(AUDIO_ARCH), dtype="float32")
    local = build_model(cfg32)
    full = lm_ranks.full_params(local, SEED, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 51)
    for (dp, tp), b in CL_AUDIO_MESHES:
        prompt = lm_ranks.tokens(cfg32, b, CL_PROMPT, SEED + 52, "cuda")
        frames = _frames(cfg32, b, gen)
        with torch.no_grad():
            want, one = _cl_decode(local, full, prompt, frames, b)
        mesh, model = lm_ranks.rank_model(cfg32, dp, tp)
        rows = b // dp if b % dp == 0 else b
        lo = mesh.axis_index("data") * rows if b % dp == 0 else 0
        dist.barrier()
        with torch.no_grad():
            logits, got = _cl_decode(model, full, prompt[lo:lo + rows],
                                     frames[lo:lo + rows], b)
        cl["b"].append({"mesh": [dp, tp], "b": b, "one_process": one,
                        "float32": got, "lo": lo,
                        "diff": (logits - want[lo:lo + rows]).abs().max()
                        .item(), "logit_max": want.abs().max().item()})
        del logits, want
        note(f"(29b) {AUDIO_ARCH} on {dp} x {tp}")
    del full, local


def _rank_tools(rep: dict, label: str):
    """(lap, note, free) of a rank of the card's world: ``lap(part)`` keeps
    the seconds since the last lap under ``rep["laps"][part]``, ``note``
    also prints the progress (the output a failing rank leaves), ``free``
    returns the cached blocks and resets the peak."""
    import gc
    import torch
    t_lap = [time.perf_counter()]

    def lap(part: str):
        now = time.perf_counter()
        rep["laps"][part] = now - t_lap[0]
        t_lap[0] = now

    def free():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def note(part: str):
        lap(part)
        print(f"{label} {rep['rank']}: {part} done, "
              f"{torch.cuda.max_memory_allocated()} B peak, "
              f"{torch.cuda.memory_allocated()} B held", flush=True)
    return lap, note, free


def _rank_start(flag: str) -> dict:
    """A rank started by ``spawn_local_cluster`` with ``flag``: its process
    group, matmuls without TF32, the host's cores shared; its report."""
    import os
    import torch
    import torch.distributed as dist
    from repro_torch.launch.multiprocess import initialize_from_env
    if not initialize_from_env():
        raise RuntimeError(f"{flag} needs the REPRO_MP_* environment of "
                           f"spawn_local_cluster")
    torch.backends.cuda.matmul.allow_tf32 = False
    # the host's cores shared: each rank's transfers fold on the host
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // MESH_RANKS))
    return {"rank": dist.get_rank(), "laps": {"start": time.time()}}


# the parts of phase 23's world that also run alone in ranks of their own:
# flag -> (the ranks' label, the part)
_PART_RANKS = {"--cs-rank": ("cs rank", "_cs_rank"),
               "--cl-rank": ("cl rank", "_cl_rank")}


def part_rank(flag: str, out_dir: str) -> None:
    """One part of phase 23's world alone in one rank (``chip_smoke.py
    --cs-rank DIR`` for phase 28, ``--cl-rank DIR`` for phase 29, started by
    ``spawn_part``); writes its report to DIR/rank<r>.json."""
    label, part = _PART_RANKS[flag]
    rep = _rank_start(flag)
    _, note, free = _rank_tools(rep, label)
    globals()[part](rep, note, free)
    rep["laps"]["end"] = time.time()
    Path(out_dir, f"rank{rep['rank']}.json").write_text(json.dumps(rep))


def spawn_part(flag: str) -> list:
    """MESH_RANKS ranks of ``part_rank(flag)``, as phase 23 starts its own:
    their reports, for the part's phase function."""
    import os
    import tempfile
    from repro_torch.launch.multiprocess import spawn_local_cluster
    with tempfile.TemporaryDirectory() as out_dir:
        outs = spawn_local_cluster(
            [sys.executable, str(ROOT / "chip_smoke.py"), flag, out_dir],
            MESH_RANKS, timeout=MESH_TIMEOUT, base_env={
                **os.environ,
                "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
        ranks = [json.loads((Path(out_dir) / f"rank{r}.json").read_text())
                 for r in range(MESH_RANKS)]
    for line in outs[0].stdout.splitlines():
        print(f"  rank 0: {line}")
    return ranks


def spawn_context_state() -> list:
    """Phase 28's ranks alone, for ``phase_context_state``."""
    return spawn_part("--cs-rank")


def spawn_cache_layout() -> list:
    """Phase 29's ranks alone, for ``phase_cache_layout``."""
    return spawn_part("--cl-rank")


def mesh_rank(out_dir: str) -> None:
    """One rank of phase 23, run as ``chip_smoke.py --mesh-rank DIR`` by
    ``spawn_local_cluster``; writes its report to DIR/rank<r>.json."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import make_lm_dataset
    from repro_torch.interop import tree_leaves, tree_map
    from repro_torch.launch import collectives, lm_ranks
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.serve import generate
    from repro_torch.core.distributed import PSUM_COUNTS
    from repro_torch.launch.dryrun import meta_params
    from repro_torch.launch.sharding import rank_specs, shard_of, shard_tree
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.moe import capacity_of
    from repro_torch.optim import adam

    rep = _rank_start("--mesh-rank")
    rank = rep["rank"]
    lap, note, free = _rank_tools(rep, "mesh rank")

    # the train step's gradient mean over data, timed apart
    mean_s = []
    _mesh_mean = steps_mod._mesh_mean

    def timed_mean(*args):
        t0 = time.perf_counter()
        out = _mesh_mean(*args)
        torch.cuda.synchronize()
        mean_s.append(time.perf_counter() - t0)
        return out
    steps_mod._mesh_mean = timed_mean

    def a2a() -> int:
        return collectives.COLLECTIVE_COUNTS["all-to-all"]["sent_bytes"]

    # (a) granite-moe on 2 x 2, bf16 at the config's capacity factor
    cfg = get_config(MOE_ARCH)
    mesh, model = lm_ranks.rank_model(cfg, 2, 2)
    rep["coords"] = dict(mesh.coords)
    t0 = time.perf_counter()
    params = lm_ranks.rank_params(model, lm_ranks.full_params(model, SEED,
                                                              "cuda"))
    free()
    rep["init_s"] = time.perf_counter() - t0
    lap("(a) weights")
    rep["rank_params"] = sum(t.numel() for t in tree_leaves(params))
    b, s = MESH_PREFILL
    toks = lm_ranks.tokens(cfg, b, s, SEED + 1, "cuda")
    prefill = make_prefill_step(model)
    prefill(params, lm_ranks.rank_batch(model, {"tokens": toks[:, :256]})
            )                                             # warm-up
    torch.cuda.synchronize()
    dist.barrier()
    free()
    lap("(a) warm-up")
    expect = _flash_counts(cfg.n_layers, cfg.n_layers)
    batch = lm_ranks.rank_batch(model, {"tokens": toks})
    _zero_counts(expect)
    sent, psum0 = a2a(), dict(PSUM_COUNTS)
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    rep["prefill"] = {
        "wall_s": time.perf_counter() - t0, "launches": _counts(expect),
        "a2a_bytes": a2a() - sent,
        "psum": [PSUM_COUNTS[k] - psum0[k] for k in ("calls", "part_bytes")],
        "capacity": capacity_of(batch["tokens"].numel() // 2, cfg),
        "finite": bool(torch.isfinite(logits).all()),
        "shape": list(logits.shape),
        "peak_bytes": torch.cuda.max_memory_allocated()}
    del logits
    note("(a) prefill")
    free()
    db, dg = MESH_DECODE
    prompt = lm_ranks.rank_batch(model, {"tokens": lm_ranks.tokens(
        cfg, db, MESH_PROMPT, SEED + 2, "cuda")})["tokens"]
    sent = a2a()
    out = generate(model, params, prompt, dg)
    rep["decode"] = {"decode_s": out["decode_s"], "finite": out["finite"],
                     "a2a_bytes": a2a() - sent,
                     "peak_bytes": torch.cuda.max_memory_allocated()}
    del out
    note("(a) decode")
    free()
    tb, ts = MESH_TRAIN
    seqs, _ = make_lm_dataset(SEED, n_seqs=64, seq_len=ts, vocab=cfg.vocab)
    batch = lm_ranks.rank_batch(model, {"tokens": torch.as_tensor(
        seqs[:tb], dtype=torch.int64, device="cuda")})
    opt = adam(MESH_LR)
    state = opt.init(params)
    # two data replicas of granite-moe's weights, gradients and Adam state
    # fill the card: the update runs in place (no second copy) and each
    # layer is recomputed in the backward (no whole graph of activations)
    step = make_train_step(dataclasses.replace(model, remat=True), opt,
                           donate=True)
    # each layer's attention runs twice a step: the forward and its
    # recomputation in the backward
    expect = _flash_counts(2 * MESH_TRAIN_STEPS * cfg.n_layers,
                           2 * MESH_TRAIN_STEPS * cfg.n_layers)
    _zero_counts(expect)
    losses, times, sent_steps = [], [], []
    for _ in range(MESH_TRAIN_STEPS):
        sent = a2a()
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        losses.append(float(met["loss"]))
        times.append(time.perf_counter() - t0)
        sent_steps.append(a2a() - sent)
    specs = rank_specs(cfg, meta_params(model), mesh)
    experts = tree_map(lambda t, sp: t if any(sp) else None, params, specs)
    whole = tree_map(lambda t, sp: None if any(sp) else t, params, specs)
    rep["train"] = {"losses": losses, "step_s": times, "mean_s": mean_s,
                    "a2a_bytes": sent_steps, "launches": _counts(expect),
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "digest": _params_digest([x for x in tree_leaves(whole)
                                              if x is not None]),
                    "expert_digest": _params_digest(
                        [x for x in tree_leaves(experts) if x is not None])}
    del params, state, opt, step, experts, whole
    note("(a) training")
    free()

    # (b), (c) the f32 drop-free copy against the local path
    cfg32 = dataclasses.replace(cfg, dtype="float32", capacity_factor=float(
        cfg.n_experts) / cfg.top_k)
    local = build_model(cfg32)
    full = lm_ranks.full_params(local, SEED, "cuda")
    toks = lm_ranks.tokens(cfg, 2, MESH_F32_S, SEED + 3, "cuda")
    with torch.no_grad(), _MoeRoutes() as rec_local:
        want = local.forward(full, {"tokens": toks})[0]
    rep["f32"] = {}
    for name, (dp, ep, ep_axis) in (("2x2", (2, 2, "model")),
                                    ("1x4", (1, 4, "model")),
                                    ("4x1", (4, 1, None))):
        mesh_m, model_m = lm_ranks.rank_model(cfg32, dp, ep,
                                              moe_ep_axis=ep_axis)
        p = shard_tree(full, rank_specs(cfg32, full, mesh_m, ep_axis),
                       mesh_m)
        blk = lm_ranks.rank_batch(model_m, {"tokens": toks})["tokens"]
        rows = blk.shape[0]
        row0 = mesh_m.coords["data"] * rows if rows < toks.shape[0] else 0
        t0 = time.perf_counter()
        with torch.no_grad(), _MoeRoutes() as rec:
            got = model_m.forward(p, {"tokens": blk})[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # the local run's routes over this block's rows, and where this
        # rank's own tokens start in them
        sub = _MoeRoutes()
        n_blk = rows * MESH_F32_S
        sub.top_e = [e[row0 * MESH_F32_S:][:n_blk] for e in rec_local.top_e]
        sub.top_p = [q[row0 * MESH_F32_S:][:n_blk] for q in rec_local.top_p]
        n_own = rec.top_e[0].shape[0]
        start = mesh_m.axis_index("model") * n_own if ep_axis and \
            n_own < n_blk else 0
        rep["f32"][name] = {
            "wall_s": wall, "rows": [row0, rows],
            "dropped": sum(rec.dropped),
            "flips": _mesh_routes(rec, sub, start),
            "diff": (got - want[row0:row0 + rows]).abs().amax(-1).tolist(),
            "logit_max": want.abs().max().item()}
        del got, p
    del want
    note("(b), (c) f32 prefills")
    free()
    # the f32 gradient at GRAD_BATCH x TRAIN_SEQ on 2 x 2: each data
    # rank's own (its block's nll; the mesh's aux loss is the mean of its
    # shards', the reference's, which no drop-free capacity makes the
    # whole batch's), held on the ranks of data index 0 (one a model
    # index) to the local path's gradient on the same block, while the
    # others free the whole weights (each local gradient, with its graph,
    # takes ~20 GB)
    gtoks = lm_ranks.tokens(cfg, GRAD_BATCH, TRAIN_SEQ, SEED + 4, "cuda")

    def nll(model):
        return lambda p, batch: model.loss(p, batch)[1]["nll"]

    mesh_m, model_m = lm_ranks.rank_model(cfg32, 2, 2)
    specs = rank_specs(cfg32, full, mesh_m)
    blk = lm_ranks.rank_batch(model_m, {"tokens": gtoks})
    g_mesh = tree_leaves(torch.func.grad(nll(model_m))(
        shard_tree(full, specs, mesh_m), blk))
    rep["grad"] = {"leaves": len(g_mesh), "rows": blk["tokens"].shape[0]}
    if mesh_m.coords["data"] != 0:
        del full, local
    free()
    if mesh_m.coords["data"] == 0:
        g_local = torch.func.grad(nll(local))(full, blk)
        worst, zero = 0.0, 0
        for gl, gm, sp in zip(tree_leaves(g_local), g_mesh,
                              _spec_leaves(specs)):
            gl = shard_of(gl, sp, mesh_m)
            scale = gl.abs().max().item()
            if gm.abs().max().item() == 0.0 or scale == 0.0:
                zero += 1
                continue
            worst = max(worst, (gm - gl).abs().max().item() / scale)
        rep["grad"].update(worst=worst, zero=zero)
        note("(b) gradient")
        del g_local, full, local
    dist.barrier()
    del g_mesh
    free()

    # (d) qwen3-moe at full width, WIDE_LAYERS layers, on 1 x 4; the ranks
    # draw the whole weights two at a time, each keeping its experts
    wcfg = dataclasses.replace(get_config(MESH_WIDE_ARCH),
                               n_layers=WIDE_LAYERS)
    mesh_w, model_w = lm_ranks.rank_model(wcfg, 1, 4)
    params = None
    for turn in range(0, MESH_RANKS, 2):
        if rank in (turn, turn + 1):
            params = _wide_rank_params(wcfg, mesh_w)
            free()
        dist.barrier()
    lap("(d) weights")
    rep["wide_rank_params"] = sum(t.numel() for t in tree_leaves(params))
    rep["wide_experts"] = params["stages"][0]["moe"]["wi_gate"].shape[1]
    wtoks = lm_ranks.tokens(wcfg, 2, MESH_WIDE_S, SEED + 5, "cuda")
    prefill = make_prefill_step(model_w)
    prefill(params, {"tokens": wtoks[:, :256]})           # warm-up
    torch.cuda.synchronize()
    dist.barrier()
    expect = _flash_counts(WIDE_LAYERS, WIDE_LAYERS)
    _zero_counts(expect)
    sent = a2a()
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": wtoks})
    torch.cuda.synchronize()
    rep["wide"] = {"wall_s": time.perf_counter() - t0,
                   "launches": _counts(expect), "a2a_bytes": a2a() - sent,
                   "finite": bool(torch.isfinite(logits).all()),
                   "peak_bytes": torch.cuda.max_memory_allocated()}
    del logits, params
    free()
    note("(d) prefill")
    _tp_rank(rep, note, free)
    _cp_rank(rep, note, free)
    _fsdp_rank(rep, note, free)
    _ha_rank(rep, note, free)
    _cs_rank(rep, note, free)
    free()
    _cl_rank(rep, note, free)
    rep["laps"]["end"] = time.time()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rep))


def _mesh_held(ranks: list, name: str, ep: int) -> dict:
    """The f32 drop-free prefill of mesh ``name`` against the local path,
    gathered from the ranks: the flips of every data block (its peers'
    slices together), whether each is a first flip, and the largest gap on
    the rows no flip can reach (from the block's model-index-0 rank)."""
    flips, err, rest, n_held, n_all = [], 0.0, 0.0, 0, 0
    for d in range(len(ranks) // ep):
        group = [r["f32"][name] for r in ranks[d * ep:(d + 1) * ep]]
        rows = group[0]["rows"][1]
        reach = [MESH_F32_S] * rows
        by_layer = {}
        for g in group:
            for layer, flat, gap in g["flips"]:
                by_layer.setdefault(layer, []).append((flat, gap))
        for layer in sorted(by_layer):
            seen = list(reach)
            for flat, gap in by_layer[layer]:
                row, pos = divmod(flat, MESH_F32_S)
                flips.append((d, layer, row, pos, gap, pos < seen[row]))
                reach[row] = min(reach[row], pos)
        for row, diffs in enumerate(group[0]["diff"]):
            held = diffs[:reach[row]]
            err = max([err] + held)
            rest = max([rest] + diffs[reach[row]:])
            n_held += len(held)
            n_all += len(diffs)
    return {"flips": flips, "err": err, "rest": rest, "held": n_held,
            "rows": n_all}


def phase_mesh(card: str):
    """Phase 23: the LM stack on MESH_RANKS ranks of the card
    (``spawn_local_cluster``, gloo, ``--mesh-rank``): holds what the ranks
    report and returns ({path: {kernel: launches of all ranks}}, the
    ranks' reports, which phase 24's part of them is in)."""
    import gc
    import os
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.multiprocess import spawn_local_cluster
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"mesh: this process holds {torch.cuda.memory_allocated()} B "
          f"({torch.cuda.memory_reserved()} B reserved) on the card as the "
          f"ranks start")
    t_spawn = time.time()
    with tempfile.TemporaryDirectory() as out_dir:
        outs = spawn_local_cluster(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
             out_dir], MESH_RANKS, timeout=MESH_TIMEOUT, base_env={
                 **os.environ,
                 "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
        ranks = [json.loads((Path(out_dir) / f"rank{r}.json").read_text())
                 for r in range(MESH_RANKS)]
    t_done = time.time()
    for line in outs[0].stdout.splitlines():
        print(f"  rank 0: {line}")
    laps = ranks[0]["laps"]
    print(f"mesh laps, rank 0: {laps['start'] - t_spawn:.1f} s to start "
          f"(imports, the card, the process groups), then "
          + ", ".join(f"{k} {v:.1f}" for k, v in laps.items()
                      if k not in ("start", "end"))
          + f" s; {t_done - laps['end']:.1f} s to exit")
    cfg = get_config(MOE_ARCH)
    e, k, d, n = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.n_layers
    peaks = lambda part: [r[part]["peak_bytes"] for r in ranks]  # noqa: E731
    paths = {}

    # (a) 2 x 2: the bf16 prefill, decode, Adam steps
    b, s = MESH_PREFILL
    pre = [r["prefill"] for r in ranks]
    cap = pre[0]["capacity"]
    layer_bytes = 2 * e * cap * d * 2           # the pair, bf16
    for r, p in zip(ranks, pre):
        want = {"flash_attention": n, "flash_attention tc": n}
        if p["launches"] != want or not p["finite"] or \
                p["shape"] != [b // 2, s, cfg.vocab]:
            raise AssertionError(f"mesh prefill, rank {r['rank']}: launches "
                                 f"{p['launches']} (expected {want}), "
                                 f"finite {p['finite']}, logits {p['shape']}")
        if p["a2a_bytes"] != n * layer_bytes:
            raise AssertionError(f"mesh prefill, rank {r['rank']}: "
                                 f"{p['a2a_bytes']} B through all-to-all, "
                                 f"expected {n} x {layer_bytes}")
        # a layer: the attention's output summed over the model peers
        # (bf16 [1, s, d]) and the aux loss over data (f32); the lookup
        # where the vocabulary splits (granite-moe's 49,155 does not)
        lookup = int(cfg.vocab % 2 == 0)
        want = [2 * n + lookup,
                (n + lookup) * b // 2 * s * d * 2 + n * 4]
        if p["psum"] != want:
            raise AssertionError(f"mesh prefill, rank {r['rank']}: sums over "
                                 f"ranks (calls, part bytes) {p['psum']}, "
                                 f"expected {want}")
    wall = max(p["wall_s"] for p in pre)
    print(f"mesh {MOE_ARCH} on 2 x 2 ranks ({e // 2} of {e} experts a rank, "
          f"{ranks[0]['rank_params']} weights a rank, drawn and cut in "
          f"{max(r['init_s'] for r in ranks):.1f} s): bf16 prefill "
          f"{b} x {s}, {b * s / wall:.1f} tokens/s ({wall:.3f} s); each "
          f"peer routes {b // 2 * s // 2} tokens into {cap} slots an "
          f"expert; all-to-all {layer_bytes} B a layer a rank "
          f"(2 E C d x 2 B), {pre[0]['a2a_bytes']} B a prefill a rank; "
          f"attention on {cfg.n_heads // 2} of {cfg.n_heads} heads a rank: "
          f"{pre[0]['psum'][0]} sums over ranks a prefill, {n} of the "
          f"attention's bf16 [1, {s}, {d}] output over model and {n} of the "
          f"aux loss over data, {pre[0]['psum'][1]} B a rank (the "
          f"vocabulary of {cfg.vocab} held whole); "
          f"flash_attention {n} a rank, all tensor-core; peak by rank "
          f"{peaks('prefill')} B [{card}]")
    paths[f"{MOE_ARCH} prefill on 2 x 2 ranks"] = {
        "flash_attention": sum(p["launches"]["flash_attention"]
                               for p in pre)}
    dec = [r["decode"] for r in ranks]
    if not all(x["finite"] for x in dec):
        raise AssertionError("mesh decode: non-finite logits")
    db, dg = MESH_DECODE
    dwall = max(x["decode_s"] for x in dec)
    print(f"mesh {MOE_ARCH} decode on 2 x 2: serve.generate at batch {db} "
          f"(2 a data rank), prompt {MESH_PROMPT}, {dg} tokens: "
          f"{db * dg / dwall:.2f} tokens/s ({dwall:.3f} s); all-to-all "
          f"{dec[0]['a2a_bytes']} B a rank in all; peak by rank "
          f"{peaks('decode')} B [{card}]")
    tr = [r["train"] for r in ranks]
    losses = tr[0]["losses"]
    want = {"flash_attention": 2 * MESH_TRAIN_STEPS * n,
            "flash_attention tc": 2 * MESH_TRAIN_STEPS * n}
    if any(t["losses"] != losses or t["launches"] != want for t in tr):
        raise AssertionError(f"mesh training: losses by rank "
                             f"{[t['losses'] for t in tr]}, launches "
                             f"{[t['launches'] for t in tr]}")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"mesh training: losses {losses}")
    if len({t["digest"] for t in tr}) != 1:
        raise AssertionError("mesh training: the weights held whole differ "
                             "between ranks")
    by_model = {}
    for r, t in zip(ranks, tr):
        by_model.setdefault(r["coords"]["model"], set()).add(
            t["expert_digest"])
    if any(len(v) != 1 for v in by_model.values()) or len(by_model) != 2:
        raise AssertionError(f"mesh training: split weights' digests by "
                             f"model index {by_model}")
    steps = [max(t["step_s"][i] for t in tr) for i in range(MESH_TRAIN_STEPS)]
    means = [round(max(t["mean_s"][i] for t in tr), 4)
             for i in range(MESH_TRAIN_STEPS)]
    tb, ts = MESH_TRAIN
    rate = MESH_TRAIN_STEPS / sum(steps)
    print(f"mesh {MOE_ARCH} training on 2 x 2: {MESH_TRAIN_STEPS} Adam "
          f"steps at {tb} x {ts} (bf16 compute, f32 weights, the gradients "
          f"averaged over data, in place, remat): {rate:.3f} steps/s, "
          f"{rate * tb * ts:.1f} tokens/s (step walls "
          f"{[round(x, 4) for x in steps]} s), losses "
          f"{[round(x, 4) for x in losses]}; the gradient mean over data "
          f"{means} s a step; all-to-all "
          f"{tr[0]['a2a_bytes']} B a step a rank; flash_attention "
          f"{2 * n} a step a rank (the forward and its recomputation), "
          f"tensor-core; the weights held whole bitwise equal on every "
          f"rank, each model index's split ones (experts, heads) on its "
          f"data peers; "
          f"peak by rank {peaks('train')} B [{card}]")
    paths[f"{MOE_ARCH} training on 2 x 2 ranks"] = {
        "flash_attention": sum(t["launches"]["flash_attention"] for t in tr)}

    # (b), (c) the f32 drop-free copy against the local path
    for name, ep in (("2x2", 2), ("1x4", 4), ("4x1", 1)):
        res = _mesh_held(ranks, name, ep)
        if any(r["f32"][name]["dropped"] for r in ranks):
            raise AssertionError(f"mesh f32 {name}: the drop-free prefill "
                                 f"dropped slots")
        bad = [f for f in res["flips"] if f[5]
               and not f[4] < MOE_FLIP_GAP_REL]
        for blk, layer, row, pos, gap, first in res["flips"][:20]:
            print(f"  route flip ({name}): data block {blk}, layer {layer},"
                  f" row {row}, position {pos}, gap {gap:.3e} "
                  f"({'first' if first else 'after an earlier flip'})")
        print(f"mesh {MOE_ARCH} f32 drop-free prefill 2 x {MESH_F32_S} on "
              f"{name.replace('x', ' x ')}"
              f"{' (moe_ep_axis=None, the data-parallel path)' if ep == 1 else ''}"
              f" vs the local path: {len(res['flips'])} route flips "
              f"({sum(f[5] for f in res['flips'])} first), {res['held']} of "
              f"{res['rows']} positions no flip reaches, max diff there "
              f"{res['err']:.3e} (tol {REF_PREFILL_TOL}), elsewhere "
              f"{res['rest']:.3e}; logits up to "
              f"{ranks[0]['f32'][name]['logit_max']:.3f}; wall "
              f"{max(r['f32'][name]['wall_s'] for r in ranks):.3f} s "
              f"[{card}]")
        if bad or not res["err"] <= REF_PREFILL_TOL:
            raise AssertionError(f"mesh f32 {name}: the mesh and the local "
                                 f"path disagree (first flips at gaps of "
                                 f"{MOE_FLIP_GAP_REL} or more: {bad})")
    held = [r["grad"] for r in ranks if "worst" in r["grad"]]
    if len(held) != 2:
        raise AssertionError(f"mesh gradient: {len(held)} ranks held it")
    worst = max(g["worst"] for g in held)
    zero = sum(g["zero"] for g in held)
    print(f"mesh {MOE_ARCH} f32 drop-free gradient of the nll of a data "
          f"rank's {held[0]['rows']} x {TRAIN_SEQ} of {GRAD_BATCH} x "
          f"{TRAIN_SEQ} on 2 x 2 (its experts' blocks) vs the local path on "
          f"the same rows: "
          f"{ranks[0]['grad']['leaves']} leaves a rank, {zero} zero, "
          f"largest gap {worst:.3e} of its leaf's largest (tol "
          f"{MESH_GRAD_REL}) [{card}]")
    if zero or not worst <= MESH_GRAD_REL:
        raise AssertionError("mesh gradient: the mesh and the local path "
                             "disagree")

    # (d) qwen3-moe at full width, WIDE_LAYERS layers, on 1 x 4
    wide = [r["wide"] for r in ranks]
    want = {"flash_attention": WIDE_LAYERS,
            "flash_attention tc": WIDE_LAYERS}
    if any(w["launches"] != want or not w["finite"] for w in wide):
        raise AssertionError(f"mesh {MESH_WIDE_ARCH}: {wide}")
    wwall = max(w["wall_s"] for w in wide)
    print(f"mesh {MESH_WIDE_ARCH} at full width, {WIDE_LAYERS} layers, on "
          f"1 x 4 ranks ({ranks[0]['wide_experts']} experts a rank, "
          f"{ranks[0]['wide_rank_params']} weights a rank): bf16 prefill "
          f"2 x {MESH_WIDE_S}, {2 * MESH_WIDE_S / wwall:.1f} tokens/s "
          f"({wwall:.3f} s), all-to-all {wide[0]['a2a_bytes']} B a rank; "
          f"peak by rank {peaks('wide')} B [{card}]")
    paths[f"{MESH_WIDE_ARCH} prefill on 1 x 4 ranks ({WIDE_LAYERS} "
          f"layers)"] = {"flash_attention": sum(
              w["launches"]["flash_attention"] for w in wide)}
    print(f"mesh: phase wall {time.perf_counter() - t_phase:.1f} s")
    return paths, ranks


def _tp_served(ranks: list, part: str, cfg, kinds: dict, sums: list,
               card: str) -> dict:
    """Phase 24's prefill and decode of one model on 1 x MESH_RANKS, held
    from the ranks' reports: launches ``kinds`` ({name: per rank}), the
    sums over ranks exactly ``sums`` ([(calls, bytes of each)]), the
    logits whole on every rank, the greedy tokens equal on every rank and
    to one process's (or the first mismatch a near tie). Returns the
    path's launches of all ranks."""
    rep = [r["tp"][part] for r in ranks]
    b, s = TP_PREFILL
    want_calls = sum(n for n, _ in sums)
    want_bytes = sum(n * each for n, each in sums)
    vl = cfg.vocab // MESH_RANKS
    for r, x in zip(ranks, rep):
        p = x["prefill"]
        want = dict(kinds)
        if p["launches"] != want or not p["finite"] or \
                p["shape"] != [b, s, cfg.vocab]:
            raise AssertionError(f"tp {cfg.name} prefill, rank {r['rank']}: "
                                 f"launches {p['launches']} (expected "
                                 f"{want}), finite {p['finite']}, logits "
                                 f"{p['shape']}")
        got = [p["sums"]["calls"], p["sums"]["part_bytes"],
               p["sums"]["gathered"]]
        if got != [want_calls, want_bytes, b * s * vl * 4]:
            raise AssertionError(f"tp {cfg.name} prefill, rank {r['rank']}: "
                                 f"(sums, their bytes, gathered bytes) {got}, "
                                 f"expected {[want_calls, want_bytes,
                                              b * s * vl * 4]}")
    dec = [x["decode"] for x in rep]
    if not all(x["finite"] for x in dec) or \
            any(x["tokens"] != dec[0]["tokens"] for x in dec):
        raise AssertionError(f"tp {cfg.name} decode: finite "
                             f"{[x['finite'] for x in dec]}, tokens by rank "
                             f"{[x['tokens'] for x in dec]}")
    miss = dec[0]["mismatch"]
    noise = rep[0]["prefill"]["one_process_diff"]
    own = rep[0]["prefill"]["one_f32_diff"]
    print(f"tp {cfg.name} bf16 prefill against one process: max |mesh - one "
          f"process| {noise:.4e}, one process's bf16 - f32 {own:.4e} "
          f"(bound {TP_BF16_GAP} each); greedy "
          + ("equal" if miss is None else
             f"first apart at step {miss[0]}, row {miss[1]}, gap "
             f"{miss[2]:.4e} (bound {TP_BF16_GAP})") + f" [{card}]")
    if not own <= TP_BF16_GAP:
        raise AssertionError(f"tp {cfg.name}: one process's bf16 prefill is "
                             f"{own:.4e} from its f32 copy's, past "
                             f"{TP_BF16_GAP}: the bound no longer fits the "
                             f"bf16 path")
    if not noise <= TP_BF16_GAP:
        raise AssertionError(f"tp {cfg.name} prefill: the mesh's bf16 logits "
                             f"are {noise:.4e} from one process's, past "
                             f"{TP_BF16_GAP}")
    if miss is not None and not miss[2] <= TP_BF16_GAP:
        raise AssertionError(f"tp {cfg.name} decode: the greedy tokens part "
                             f"from one process's at step {miss[0]}, row "
                             f"{miss[1]}, where one process's logits put the "
                             f"mesh's pick {miss[2]:.4e} below their top, "
                             f"past {TP_BF16_GAP}")
    wall = max(x["prefill"]["wall_s"] for x in rep)
    secs = max(x["prefill"]["sums"]["seconds"] for x in rep)
    db, dg = TP_DECODE
    dwall = max(x["decode_s"] for x in dec)
    dsecs = max(x["sums"]["seconds"] for x in dec)
    print(f"tp {cfg.name} on 1 x {MESH_RANKS} ranks "
          f"({rep[0]['rank_params']} weights a rank): bf16 prefill {b} x {s}, "
          f"{b * s / wall:.1f} tokens/s ({wall:.3f} s, {secs:.3f} s of it in "
          f"the {want_calls} sums over ranks, {want_bytes} B a rank, and the "
          f"rank's f32 logits [{b}, {s}, {vl}] gathered; max |mesh - one "
          f"process| {noise:.4e}), launches a rank "
          f"{rep[0]['prefill']['launches']}; peak by rank "
          f"{[x['prefill']['peak_bytes'] for x in rep]} B [{card}]")
    print(f"tp {cfg.name} decode on 1 x {MESH_RANKS}: serve.generate at batch "
          f"{db}, prompt {MESH_PROMPT}, {dg} tokens: {db * dg / dwall:.2f} "
          f"tokens/s ({dwall:.3f} s, {dsecs:.3f} s in "
          f"{dec[0]['sums']['calls']} sums over ranks, prompt replay "
          f"{max(x['prefill_s'] for x in dec):.3f} s); tokens equal on every "
          f"rank; against one process on the whole weights: "
          + ("equal" if miss is None else
             f"first apart at step {miss[0]}, row {miss[1]}, a near tie "
             f"(gap {miss[2]:.4e} <= {TP_BF16_GAP})")
          + f"; peak by rank {[x['peak_bytes'] for x in dec]} B [{card}]")
    return {k: sum(x["prefill"]["launches"][k] for x in rep) for k in kinds}


def phase_tensor_parallel(card: str, ranks: list):
    """Phase 24: dense tensor parallelism, run by phase 23's ranks
    (``_tp_rank``); holds their reports. Returns ({path: {kernel: launches
    of all ranks}}, the kernel checks at the rank shapes by kernel)."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    shapes = ranks[0]["tp"]["kernels"]
    for name, entries in shapes.items():
        for e in entries:
            print(f"tp kernel {name} at {e['arch']}'s rank shape {e['shape']}"
                  f": max |kernel - plain| {e['max_abs_err']:.3e}, kernel "
                  f"{e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, "
                  f"library {e['library_ms']} ms, bound {e['bound_ms']:.4f} "
                  f"ms ({e['bound_by']}) [{card}]")
    paths = {}
    cfg = get_config(TP_ARCH)
    n, b, s, d = cfg.n_layers, *TP_PREFILL, cfg.d_model
    blocks = ranks[0]["tp"]["a"]["blocks"]
    hd = cfg.resolved_head_dim
    want = {"wq": [n, d, cfg.n_heads * hd // MESH_RANKS],     # stacked
            "wi_gate": [n, d, cfg.d_ff // MESH_RANKS],
            "embed": [cfg.vocab // MESH_RANKS, d],
            "head": [d, cfg.vocab // MESH_RANKS]}
    if blocks != want:
        raise AssertionError(f"tp {cfg.name}: rank blocks {blocks}, expected "
                             f"{want}")
    # a layer: the attention's and the MLP's outputs; and the lookup
    launches = _tp_served(ranks, "a", cfg, {"flash_attention": n,
                                            "flash_attention tc": n},
                          [(2 * n + 1, b * s * d * 2)], card)
    paths[f"{TP_ARCH} prefill on 1 x {MESH_RANKS} ranks"] = launches

    hcfg = dataclasses.replace(get_config(TP_HYBRID_ARCH),
                               n_layers=TP_HYBRID_LAYERS)
    hb = ranks[0]["tp"]["b"]
    n_scan, n_attn, hd = hb["scans"], hb["attns"], hcfg.d_model
    # a Mamba2 layer: out_proj's output and the gated norm's f32 sum of
    # squares [B, S, 1]; a shared attention: attention and MLP; the lookup
    launches = _tp_served(ranks, "b", hcfg, {
        "ssd_scan": n_scan, "flash_attention": n_attn,
        "flash_attention tc": n_attn},
        [(n_scan + 2 * n_attn + 1, b * s * hd * 2), (n_scan, b * s * 4)],
        card)
    paths[f"{TP_HYBRID_ARCH} prefill on 1 x {MESH_RANKS} ranks "
          f"({TP_HYBRID_LAYERS} layers)"] = launches

    # (c) training on 2 x 2
    tr = [r["tp"]["c"] for r in ranks]
    tb, ts = MESH_TRAIN
    rows = tr[0]["rows"]
    losses = tr[0]["losses"]
    want_l = {"flash_attention": 2 * TP_TRAIN_STEPS * n,
              "flash_attention tc": 2 * TP_TRAIN_STEPS * n}
    # a step: the forward's 2 n + 1 sums, the recomputation's 2 n, the
    # backward's 2 n + 1 (the column splits' inputs), [rows, ts, d] bf16
    calls = TP_TRAIN_STEPS * (6 * n + 2)
    want_sums = [calls, calls * rows * ts * d * 2]
    for r, t in zip(ranks, tr):
        got = [t["sums"]["calls"], t["sums"]["part_bytes"]]
        if t["launches"] != want_l or got != want_sums or \
                t["losses"] != losses:
            raise AssertionError(f"tp training, rank {r['rank']}: launches "
                                 f"{t['launches']} (expected {want_l}), sums "
                                 f"{got} (expected {want_sums}), losses "
                                 f"{t['losses']} (rank 0 {losses})")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"tp training: losses {losses}")
    if len({t["whole_digest"] for t in tr}) != 1:
        raise AssertionError("tp training: the weights held whole differ "
                             "between ranks")
    by_model = {}
    for r, t in zip(ranks, tr):
        by_model.setdefault(r["rank"] % 2, set()).add(t["split_digest"])
    if any(len(v) != 1 for v in by_model.values()) or \
            len(set().union(*by_model.values())) != 2:
        raise AssertionError(f"tp training: split weights' digests by model "
                             f"index {by_model}")
    steps = [max(t["step_s"][i] for t in tr) for i in range(TP_TRAIN_STEPS)]
    rate = TP_TRAIN_STEPS / sum(steps)
    print(f"tp {cfg.name} training on 2 x 2 ranks: {TP_TRAIN_STEPS} SGD "
          f"steps (lr {TP_LR}) at {tb} x {ts} ({rows} rows a data rank, bf16 "
          f"compute, remat, in place): {rate:.3f} steps/s, "
          f"{rate * tb * ts:.1f} tokens/s (step walls "
          f"{[round(x, 4) for x in steps]} s), losses "
          f"{[round(x, 4) for x in losses]}; {tr[0]['sums']['calls']} sums "
          f"over model a rank ({tr[0]['sums']['part_bytes']} B, "
          f"{max(t['sums']['seconds'] for t in tr):.3f} s, waiting for "
          f"the peers included), the mean over data "
          f"{tr[0]['mean']['calls']} sums of {tr[0]['mean']['part_bytes']} "
          f"B ({max(t['mean']['seconds'] for t in tr):.3f} s); "
          f"flash_attention "
          f"{2 * n} a step a rank, tensor-core; the weights held whole "
          f"bitwise equal on every rank, the split ones on their data peers; "
          f"peak by rank {[t['peak_bytes'] for t in tr]} B [{card}]")
    paths[f"{TP_ARCH} training on 2 x 2 ranks"] = {
        k: sum(t["launches"][k] for t in tr) for k in want_l}

    # (d) f32 parity against one process
    par = [r["tp"]["d"] for r in ranks]
    for arch in (TP_ARCH, TP_HYBRID_ARCH):
        diff = max(p[arch]["diff"] for p in par)
        print(f"tp f32 {arch}, {TP_PARITY_LAYERS} layers, 2 x {TP_PARITY_S} "
              f"on 1 x {MESH_RANKS} vs one process on the same weights: max "
              f"|diff| {diff:.3e} (tol {REF_PREFILL_TOL}), logits up to "
              f"{par[0][arch]['logit_max']:.3f} [{card}]")
        if not diff <= REF_PREFILL_TOL:
            raise AssertionError(f"tp f32 {arch}: the mesh and one process "
                                 f"disagree")
        dec = [p[arch]["decode"] for p in par]
        miss = dec[0]["mismatch"]
        same = all(x["tokens"] == dec[0]["tokens"] for x in dec)
        print(f"tp f32 {arch} greedy decode on 1 x {MESH_RANKS}, batch "
              f"{TP_DECODE[0]}, prompt {MESH_PROMPT}, {TP_DECODE[1]} tokens: "
              f"equal on every rank {same}; against one process: "
              + ("equal" if miss is None else
                 f"first apart at step {miss[0]}, row {miss[1]}, gap "
                 f"{miss[2]:.4e} (bound {REF_PREFILL_TOL})") + f" [{card}]")
        if not same or (miss is not None and
                        not miss[2] <= REF_PREFILL_TOL):
            raise AssertionError(f"tp f32 {arch} decode: the mesh's greedy "
                                 f"tokens and one process's disagree")
    tr = [p["train"] for p in par]
    worst = max(t["worst"] for t in tr)
    zero = max(t["zero"] for t in tr)
    loss_gap = max(abs(t["loss"] - t["local_loss"]) for t in tr)
    print(f"tp f32 {TP_ARCH}, {TP_PARITY_LAYERS} layers, on 2 x 2: loss "
          f"{tr[0]['loss']:.6f} vs one process's {tr[0]['local_loss']:.6f} "
          f"(gap {loss_gap:.3e}, tol {LOSS_REL_TP} relative); gradient at "
          f"{GRAD_BATCH} x {TRAIN_SEQ}, averaged over data: "
          f"{tr[0]['leaves']} leaves a rank, {zero} zero, largest gap "
          f"{worst:.3e} of its leaf's largest (tol {MESH_GRAD_REL}) [{card}]")
    if zero or not worst <= MESH_GRAD_REL or \
            not loss_gap <= LOSS_REL_TP * abs(tr[0]["local_loss"]):
        raise AssertionError("tp f32 training: the mesh and one process "
                             "disagree")
    laps = ranks[0]["laps"]
    print(f"tensor parallelism: the ranks' part "
          f"{sum(v for k, v in laps.items() if k.startswith('(24')):.1f} s "
          f"(rank 0's laps, in phase 23's wall), the checks here "
          f"{time.perf_counter() - t_phase:.1f} s")
    return paths, shapes


def _cp_bytes(cfg, dp: int, tp: int, s: int, itemsize: int) -> int:
    """The bytes one K/V gather of a layer sends from a rank of dp x tp:
    its block of s / dp positions of k and v on its kv heads."""
    return (s // dp) * 2 * (cfg.n_kv_heads // tp) * cfg.resolved_head_dim \
        * itemsize


def phase_context_parallel(card: str, ranks: list):
    """Phase 25: context parallelism, run by phase 23's ranks
    (``_cp_rank``); holds their reports. Returns ({path: {kernel: launches
    of all ranks}}, the kernel checks at the rank shapes)."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    shapes = ranks[0]["cp"]["kernels"]
    for e in shapes:
        print(f"cp kernel flash_attention at {CP_ARCH}'s rank {e['rank']} of "
              f"{e['mesh'][0]} x {e['mesh'][1]}, [b, s, sk, h, kv, d] "
              f"{e['shape']} right-aligned causal, tensor-core: max |kernel "
              f"- plain| {e['max_abs_err']:.3e} (max |SDPA - kernel| "
              f"{e['sdpa_diff']:.3e}), kernel {e['ms']:.4f} ms, plain "
              f"{e['plain_ms']:.4f} ms, SDPA (a right-aligned boolean mask) "
              f"{e['library_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
              f"({e['bound_by']}) [{card}]")
    cfg = get_config(CP_ARCH)
    n, d, v = cfg.n_layers, cfg.d_model, cfg.vocab
    paths = {}
    for i, (dp, tp) in enumerate(CP_MESHES):
        rep = [r["cp"]["a"][i] for r in ranks]
        s = CP_PREFILL // dp
        each = _cp_bytes(cfg, dp, tp, CP_PREFILL, 2)
        # 2 x 2: the tensor-parallel sums of a layer (attention, MLP) and
        # the lookup's, [1, s, d] bf16, and the rank's f32 logits gathered
        sums = [2 * n + 1, (2 * n + 1) * s * d * 2] if tp > 1 else [0, 0]
        gathers = [1, s * v // tp * 4] if tp > 1 else [0, 0]
        want = {"seq_gather": [n, n * each, n * each * (dp - 1)],
                "seq_scatter": [0, 0], "psum": sums, "gather": gathers}
        for r, x in zip(ranks, rep):
            if x["launches"] != {"flash_attention": n,
                                 "flash_attention tc": n} or \
                    not x["finite"] or x["shape"] != [1, s, v] or \
                    x["moved"] != want:
                raise AssertionError(
                    f"cp {CP_ARCH} prefill on {dp} x {tp}, rank {r['rank']}:"
                    f" launches {x['launches']} (expected {n}, all "
                    f"tensor-core), finite {x['finite']}, logits "
                    f"{x['shape']}, transfers {x['moved']} (expected {want})")
        wall = max(x["wall_s"] for x in rep)
        print(f"cp {CP_ARCH} prefill on {dp} x {tp} ranks (seq over data: "
              f"{s} tokens and {cfg.n_heads // tp} heads a rank, "
              f"{rep[0]['rank_params']} weights a rank): bf16, batch 1 x "
              f"{CP_PREFILL}, {CP_PREFILL / wall:.1f} tokens/s ({wall:.3f} "
              f"s); K/V gathers exact: {n} a rank of {each} B sent, "
              f"{n * each * (dp - 1)} B received a rank; sums over model "
              f"{sums[0]} of {sums[1]} B, logits gathered {gathers[1]} B; "
              f"flash_attention {n} a rank, all tensor-core; attention ms by "
              f"rank {[round(x['attention_ms'], 3) for x in rep]} (events "
              f"on each rank's stream, the card shared; rank r reads r + 1 "
              f"blocks of keys); peak by rank "
              f"{[x['peak_bytes'] for x in rep]} B [{card}]")
        paths[f"{CP_ARCH} prefill on {dp} x {tp} ranks (seq over data)"] = {
            k: sum(x["launches"][k] for x in rep)
            for k in ("flash_attention", "flash_attention tc")}

    # (c) decode on MESH_RANKS x 1
    dec = [r["cp"]["c"] for r in ranks]
    dp, tp = dec[0]["mesh"]
    slots = (CP_PROMPT + CP_GEN) // dp
    want_bytes = n * 2 * slots * (cfg.n_kv_heads // tp) \
        * cfg.resolved_head_dim * 4
    if not all(x["finite"] for x in dec) or \
            any(x["tokens"] != dec[0]["tokens"] for x in dec) or \
            any(x["cache_bytes"] != want_bytes or set(x["slots"]) != {slots}
                for x in dec):
        raise AssertionError(
            f"cp decode on {dp} x {tp}: finite {[x['finite'] for x in dec]},"
            f" tokens by rank {[x['tokens'] for x in dec]}, cache bytes "
            f"{[x['cache_bytes'] for x in dec]} (expected {want_bytes}), "
            f"slots {[x['slots'] for x in dec]} (expected {slots})")
    dwall = max(x["decode_s"] for x in dec)
    print(f"cp {CP_ARCH} decode on {dp} x {tp}: serve.generate at batch 1, "
          f"prompt {CP_PROMPT}, {CP_GEN} greedy tokens: "
          f"{CP_GEN / dwall:.2f} tokens/s ({dwall:.3f} s; prompt replay "
          f"{max(x['prefill_s'] for x in dec):.3f} s); the f32 cache's "
          f"{CP_PROMPT + CP_GEN} slots split over data, {slots} a rank, "
          f"{want_bytes} B a rank, exact; {dec[0]['moved']['gather'][0]} "
          f"gathers of the partial softmax statistics a rank "
          f"({dec[0]['moved']['gather'][1]} B); tokens equal on every rank; "
          f"peak by rank {[x['peak_bytes'] for x in dec]} B [{card}]")

    for i, (dp, tp) in enumerate(CP_MESHES):
        xs = [r["cp"]["b"][i] for r in ranks]
        diff, worst = max(x["diff"] for x in xs), max(x["worst"] for x in xs)
        zero = max(x["zero"] for x in xs)
        gap = max(abs(x["loss"] - x["local_loss"]) for x in xs)
        same = all(x.get("tokens") == x.get("one_process") for x in xs)
        print(f"cp f32 {CP_ARCH}, {CP_PARITY_LAYERS} layers, 1 x "
              f"{CP_PARITY_S} on {dp} x {tp} vs one process on the same "
              f"weights: max |diff| of the ranks' logits {diff:.3e} (tol "
              f"{REF_PREFILL_TOL}, logits up to {xs[0]['logit_max']:.3f}); "
              f"loss {xs[0]['loss']:.6f} vs {xs[0]['local_loss']:.6f} (gap "
              f"{gap:.3e}); the gradient summed over data: {xs[0]['leaves']} "
              f"leaves a rank, {zero} zero, largest gap {worst:.3e} of its "
              f"leaf's largest (tol {MESH_GRAD_REL})"
              + ("" if "tokens" not in xs[0] else
                 f"; greedy decode from the split cache, {CP_GEN} tokens: "
                 + ("equal one process's" if same else "DIFFERENT"))
              + f" [{card}]")
        if not (diff <= REF_PREFILL_TOL and zero == 0 and
                worst <= MESH_GRAD_REL and gap <= REF_PREFILL_TOL and same):
            raise AssertionError(f"cp f32 on {dp} x {tp}: the mesh and one "
                                 f"process disagree")
    xs = [r["cp"]["b_moe"] for r in ranks]
    worst, zero = max(x["worst"] for x in xs), max(x["zero"] for x in xs)
    gap = max(abs(x["loss"] - x["local_loss"]) for x in xs)
    mcfg = get_config(MOE_ARCH)
    # a layer: K/V, and the MoE's input [1, S / n, d] gathered in f32
    want_g = [2 * CP_PARITY_LAYERS, CP_PARITY_LAYERS * (
        _cp_bytes(mcfg, MESH_RANKS, 1, CP_PARITY_S, 4)
        + CP_PARITY_S // MESH_RANKS * mcfg.d_model * 4)]
    got_g = xs[0]["moved"]["seq_gather"][:2]
    print(f"cp f32 {MOE_ARCH}, {CP_PARITY_LAYERS} layers, capacity factor "
          f"{mcfg.capacity_factor}, 1 x {CP_PARITY_S} on {MESH_RANKS} x 1 "
          f"vs one process: loss (nll + 0.01 aux) {xs[0]['loss']:.6f} vs "
          f"{xs[0]['local_loss']:.6f} (gap {gap:.3e}, tol "
          f"{REF_PREFILL_TOL}); the gradient summed over data: "
          f"{xs[0]['leaves']} leaves a rank, {zero} zero, largest gap "
          f"{worst:.3e} of its leaf's largest (tol {MESH_GRAD_REL}); "
          f"gathers (K/V and each MoE layer's input) {got_g} (calls, B; "
          f"expected {want_g}) [{card}]")
    if not (zero == 0 and worst <= MESH_GRAD_REL and gap <= REF_PREFILL_TOL
            and all(x["moved"]["seq_gather"][:2] == want_g for x in xs)):
        raise AssertionError(f"cp f32 {MOE_ARCH} at capacity "
                             f"{mcfg.capacity_factor}: the mesh and one "
                             f"process disagree, or the gathers are off")

    tr = [r["cp"]["d"] for r in ranks]
    losses = tr[0]["losses"]
    each = _cp_bytes(cfg, 2, 2, CP_TRAIN_S, 2)
    want_l = {"flash_attention": 2 * CP_TRAIN_STEPS * n,
              "flash_attention tc": 2 * CP_TRAIN_STEPS * n}
    # a step: the forward's K/V gathers ("dots" keeps them for the
    # recomputation) and their backward's reduce-scatters
    want_seq = [CP_TRAIN_STEPS * n, CP_TRAIN_STEPS * n * each]
    for r, t in zip(ranks, tr):
        got = [t["moved"]["seq_gather"][:2], t["moved"]["seq_scatter"]]
        if t["launches"] != want_l or t["losses"] != losses or \
                got != [want_seq, [want_seq[0], 2 * want_seq[1]]]:
            raise AssertionError(f"cp training, rank {r['rank']}: launches "
                                 f"{t['launches']} (expected {want_l}), K/V "
                                 f"gathers and scatters {got} (expected "
                                 f"{want_seq} each, the scatters of the "
                                 f"whole sequence), losses {t['losses']} "
                                 f"(rank 0 {losses})")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"cp training: losses {losses} do not fall")
    if len({t["whole_digest"] for t in tr}) != 1:
        raise AssertionError("cp training: the weights held whole differ "
                             "between ranks")
    by_model = {}
    for r, t in zip(ranks, tr):
        by_model.setdefault(r["rank"] % 2, set()).add(t["split_digest"])
    if any(len(x) != 1 for x in by_model.values()) or \
            len(set().union(*by_model.values())) != 2:
        raise AssertionError(f"cp training: split weights' digests by model "
                             f"index {by_model}")
    steps = [max(t["step_s"][i] for t in tr) for i in range(CP_TRAIN_STEPS)]
    rate = CP_TRAIN_STEPS / sum(steps)
    print(f"cp {CP_ARCH} training on 2 x 2 ranks (seq over data, heads over "
          f"model): {CP_TRAIN_STEPS} SGD steps (lr {CP_LR}) at 1 x "
          f"{CP_TRAIN_S}, remat \"dots\", in place: {rate:.3f} steps/s, "
          f"{rate * CP_TRAIN_S:.1f} tokens/s (step walls "
          f"{[round(x, 4) for x in steps]} s), losses "
          f"{[round(x, 4) for x in losses]}; a rank's K/V gathers "
          f"{tr[0]['moved']['seq_gather'][:2]} and reduce-scatters "
          f"{tr[0]['moved']['seq_scatter']} (calls, B), exact; sums over "
          f"ranks {tr[0]['moved']['psum']} and gathers "
          f"{tr[0]['moved']['gather']} (calls, B) with the gradients' sum "
          f"over data; flash_attention {2 * n} a step a rank, tensor-core; "
          f"the weights held whole bitwise equal on every rank, the split "
          f"ones on their data peers; peak by rank "
          f"{[t['peak_bytes'] for t in tr]} B [{card}]")
    paths[f"{CP_ARCH} training on 2 x 2 ranks (seq over data)"] = {
        k: sum(t["launches"][k] for t in tr) for k in want_l}
    laps = ranks[0]["laps"]
    print(f"context parallelism: the ranks' part "
          f"{sum(x for k, x in laps.items() if k.startswith('(25')):.1f} s "
          f"(rank 0's laps, in phase 23's wall), the checks here "
          f"{time.perf_counter() - t_phase:.1f} s")
    return paths, shapes


def _moved() -> dict:
    """The bytes this process's collectives moved so far by the count's
    kinds (``launch.cost_analysis``: each call's operand), and the FSDP
    gathers' and reduce-scatters' calls and bytes."""
    from repro_torch.core.distributed import PSUM_COUNTS
    from repro_torch.launch import collectives
    c = collectives.COLLECTIVE_COUNTS
    return {"all-reduce": PSUM_COUNTS["part_bytes"],
            "all-gather": sum(c[k]["sent_bytes"] for k in
                              ("all-gather", "seq-gather", "fsdp-gather")),
            "reduce-scatter": sum(c[k]["sent_bytes"] for k in
                                  ("seq-scatter", "fsdp-scatter")),
            "all-to-all": c["all-to-all"]["sent_bytes"],
            "fsdp": [c["fsdp-gather"]["calls"], c["fsdp-gather"]["sent_bytes"],
                     c["fsdp-scatter"]["calls"],
                     c["fsdp-scatter"]["sent_bytes"]]}


def _moved_since(before: dict) -> dict:
    now = _moved()
    return {k: ([a - b for a, b in zip(v, before[k])] if isinstance(v, list)
                else v - before[k]) for k, v in now.items()}


def _fsdp_rank(rep: dict, note, free) -> None:
    """Phase 26 (a) in one rank of phase 23's world (``mesh_rank``): fills
    ``rep["fsdp"]``."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.interop import tree_leaves
    from repro_torch.launch import lm_ranks
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import sgd
    cfg = get_config(TP_ARCH)
    mesh, model = lm_ranks.rank_model(cfg, 2, 2, fsdp=True)
    params = lm_ranks.rank_params(model, lm_ranks.full_params(model, SEED,
                                                              "cuda"))
    free()
    tb, ts = MESH_TRAIN
    batch = lm_ranks.rank_batch(model, {"tokens": lm_ranks.tokens(
        cfg, tb, ts, SEED + 10, "cuda")})
    opt = sgd(TP_LR)
    state = opt.init(params)
    step = make_train_step(dataclasses.replace(model, remat=True), opt,
                           donate=True)
    n = 2 * TP_TRAIN_STEPS * cfg.n_layers
    expect = _flash_counts(n, n)
    torch.cuda.synchronize()
    dist.barrier()
    _zero_counts(expect)
    before = _moved()
    losses, walls = [], []
    for _ in range(TP_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        losses.append(float(met["loss"]))
        walls.append(time.perf_counter() - t0)
    leaves = tree_leaves(params)
    fs = rep["fsdp"] = {
        "losses": losses, "step_s": walls, "launches": _counts(expect),
        "moved": _moved_since(before),
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "param_bytes": sum(x.numel() * x.element_size() for x in leaves),
        # every rank's blocks equal to 24 (c)'s: the whole weights are
        "digest": _params_digest(leaves)}
    del params, state, step, leaves
    free()
    note("(26a) stablelm-1.6b FSDP training on 2 x 2")


def _fsdp_per_step(model) -> list:
    """[gathers, their bytes, reduce-scatters, their bytes] of one remat'd
    training step of a rank of ``model.mesh`` under FSDP, from the blocks'
    shapes: the FSDP leaves outside the layers in one transfer, each
    layer's in one, twice (the forward and the recomputation), each
    reduce-scatter once of the whole (the data axes' size times the
    blocks). For a model without shared attention, whose leaves a stage
    gathers each time it runs."""
    from repro_torch.interop import tree_leaves
    from repro_torch.launch.dryrun import meta_params
    from repro_torch.launch.sharding import (data_axes, rank_specs,
                                             shard_tree)
    whole = meta_params(model)
    blocks = shard_tree(whole, rank_specs(model.cfg, whole, model.mesh,
                                          fsdp=True), model.mesh)
    dp = model.mesh.axis_size(data_axes(model.mesh))
    out = [0, 0, 0, 0]

    def add(count, calls, leaves, dims):
        size = sum(x.numel() * x.element_size() for x, d in zip(leaves, dims)
                   if d is not None) // count       # a layer's, or the top's
        if size:
            out[0] += calls
            out[1] += calls * size
            out[2] += count
            out[3] += count * dp * size
    top = [k for k in blocks if k not in ("stages", "shared_attn")]
    add(1, 1, tree_leaves([blocks[k] for k in top]),
        tree_leaves([model.fsdp_dims[k] for k in top]))
    for st, b, dm in zip(model.program, blocks["stages"],
                         model.fsdp_dims["stages"]):
        add(st.count, 2 * st.count, tree_leaves(b), tree_leaves(dm))
    return out


def start_meta_work() -> tuple:
    """Phase 26's counts on meta, started after the kernels' phases so that
    they run beside the single-process path phases (single-threaded
    processes): (b) the
    dry run's count of rank 0 of a stand-in 2 x 2 of phase 24 (c)'s and
    26 (a)'s steps (``chip_smoke.py --fsdp-count DIR``), and (c) the rows
    FSDP_ROWS of the dry run's command line on the production meshes (one
    process a row's two meshes). Returns (DIR, the processes), which
    ``phase_fsdp`` reads; ``stop_background`` ends any still running."""
    import os
    import subprocess
    import tempfile
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_meta_"))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    cmds = [[sys.executable, str(ROOT / "chip_smoke.py"), "--fsdp-count",
             str(out_dir)]]
    for i, (arch, shape, kw) in enumerate(FSDP_ROWS):
        cmds.append([sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shape, "--mesh", "both",
                     "--out", str(out_dir / f"rows{i}.json")]
                    + ["--fsdp"] * bool(kw.get("fsdp"))
                    + ["--sliding-variant"] * bool(kw.get("sliding_variant")))
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for cmd in cmds]
    _BACKGROUND.extend(procs)
    return out_dir, procs


_BACKGROUND: list = []      # processes started beside the phases


def stop_background() -> None:
    """Ends every process ``start_meta_work`` started that still runs."""
    for p in _BACKGROUND:
        if p.poll() is None:
            p.kill()
            p.wait()
    _BACKGROUND.clear()


def fsdp_count(out_dir: str) -> None:
    """Phase 26 (b)'s counts, run as ``chip_smoke.py --fsdp-count DIR``:
    rank 0 of a stand-in 2 x 2, phase 24 (c)'s and 26 (a)'s SGD steps on
    meta, with and without FSDP; writes DIR/count.json."""
    import torch
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.mesh import stand_in_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    torch.set_num_threads(1)
    cfg = get_config(TP_ARCH)
    tb, ts = MESH_TRAIN
    out = {}
    for fsdp in (False, True):
        model = build_model(cfg, mesh=stand_in_mesh({"data": 2, "model": 2}),
                            remat=True, fsdp=fsdp)
        t0 = time.perf_counter()
        cc, held = count_step(model, InputShape("mesh_train", ts, tb,
                                                "train"), sgd(TP_LR),
                              donate=True)
        out[str(fsdp)] = {"peak": cc.peak_live_bytes, "coll": cc.coll,
                          "held": held, "secs": time.perf_counter() - t0}
        if fsdp:
            out[str(fsdp)]["per_step"] = _fsdp_per_step(model)
    Path(out_dir, "count.json").write_text(json.dumps(out))


def phase_fsdp(card: str, ranks: list, meta=None) -> dict:
    """Phase 26: FSDP trained by phase 23's ranks (``_fsdp_rank``) against
    phase 24 (c)'s run, the dry run's count of a rank against both, and
    the dry run's production rows on meta (``start_meta_work``'s, started
    here unless given). Returns {path: {kernel: launches of all ranks}}."""
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline
    from repro_torch.launch.cost_analysis import COLLECTIVES
    t_phase = time.perf_counter()
    out_dir, procs = meta if meta is not None else start_meta_work()
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"phase 26's count {p.args[1:]}: exit "
                                 f"{p.returncode}\n{log[-4000:]}")
    counts = json.loads((out_dir / "count.json").read_text())
    cfg = get_config(TP_ARCH)
    tb, ts = MESH_TRAIN
    tp_c = [r["tp"]["c"] for r in ranks]
    fs = [r["fsdp"] for r in ranks]
    n = 2 * TP_TRAIN_STEPS * cfg.n_layers
    want_l = {"flash_attention": n, "flash_attention tc": n}
    held = counts["True"]["held"]
    per_step = counts["True"]["per_step"]
    want_moved = [TP_TRAIN_STEPS * x for x in per_step]

    # (a) FSDP training against phase 24 (c)
    for r, f, c in zip(ranks, fs, tp_c):
        bad = []
        if f["launches"] != want_l:
            bad.append(f"launches {f['launches']} (expected {want_l})")
        if f["losses"] != c["losses"]:
            bad.append(f"losses {f['losses']} (24c {c['losses']})")
        if f["digest"] != c["fsdp_digest"]:
            bad.append("the weights after training are not 24c's bits")
        if f["param_bytes"] != held or c["param_bytes"] != \
                counts["False"]["held"]:
            bad.append(f"parameter bytes {f['param_bytes']} / 24c "
                       f"{c['param_bytes']} (from the specs {held} / "
                       f"{counts['False']['held']})")
        if f["moved"]["fsdp"] != want_moved:
            bad.append(f"FSDP gathers and reduce-scatters {f['moved']['fsdp']}"
                       f" (expected {want_moved} from the shapes)")
        if bad:
            raise AssertionError(f"fsdp training, rank {r['rank']}: "
                                 + "; ".join(bad))
    steps_f = [max(f["step_s"][i] for f in fs)
               for i in range(TP_TRAIN_STEPS)]
    steps_c = [max(c["step_s"][i] for c in tp_c)
               for i in range(TP_TRAIN_STEPS)]
    rate_f, rate_c = (TP_TRAIN_STEPS / sum(x) for x in (steps_f, steps_c))
    print(f"fsdp {cfg.name} training on 2 x 2 ranks (fsdp=True, weights cut "
          f"over data too): {TP_TRAIN_STEPS} SGD steps (lr {TP_LR}) at {tb} "
          f"x {ts}, remat, in place: {rate_f:.3f} steps/s (24c without "
          f"FSDP {rate_c:.3f}; step walls {[round(x, 4) for x in steps_f]} "
          f"s), losses {[round(x, 4) for x in fs[0]['losses']]} bitwise "
          f"24c's; every rank's weight blocks bitwise its blocks of 24c's "
          f"weights; parameters {fs[0]['param_bytes']} B a rank (24c "
          f"{tp_c[0]['param_bytes']}), exact from the specs; a step "
          f"{per_step[0]} gathers ({per_step[1]} B) and {per_step[2]} "
          f"reduce-scatters ({per_step[3]} B) a rank, exact from the "
          f"shapes; flash_attention {n // TP_TRAIN_STEPS} a step a rank, "
          f"tensor-core; peak by rank {[f['peak_bytes'] for f in fs]} B "
          f"(24c {[c['peak_bytes'] for c in tp_c]}) [{card}]")

    # (b) the count against the ranks
    for fsdp, runs, label in ((False, tp_c, "24c"), (True, fs, "26a")):
        count = counts[str(fsdp)]
        peak, secs = count["peak"], count["secs"]
        gaps = [abs(peak - x["peak_bytes"]) / x["peak_bytes"] for x in runs]
        want = {k: TP_TRAIN_STEPS * int(count["coll"][k]) for k in COLLECTIVES
                if k != "collective-permute" and k != "broadcast"}
        got = [{k: x["moved"][k] for k in want} for x in runs]
        print(f"fsdp dry run vs the card ({label}, fsdp={fsdp}): the count of "
              f"rank 0 of a stand-in 2 x 2 on meta ({secs:.1f} s) peaks at "
              f"{peak} B against the ranks' {[x['peak_bytes'] for x in runs]}"
              f" (gaps {[round(g, 4) for g in gaps]}, tol {TOOL_PEAK_GAP}); "
              f"its collective bytes x {TP_TRAIN_STEPS} steps {want}, the "
              f"ranks' {got[0]} [{card}]")
        if max(gaps) > TOOL_PEAK_GAP or any(g != want for g in got):
            raise AssertionError(f"fsdp dry run ({label}): the count and the "
                                 f"ranks disagree")

    # (c) the production rows, on meta
    for i, (arch, shape, kw) in enumerate(FSDP_ROWS):
        for row in json.loads((out_dir / f"rows{i}.json").read_text()):
            mesh = row["mesh"]
            if row["status"] != "ok" or row["remat"] != "full":
                raise AssertionError(f"dry run {arch} x {shape} x {mesh} "
                                     f"{kw}: {row}")
            print(f"fsdp dry run {row['arch']} x {shape} on rank 0 of "
                  f"{'2 x 16 x 16' if mesh == 'multi' else '16 x 16'}"
                  f"{' fsdp' if kw.get('fsdp') else ''}: peak "
                  f"{row['peak_memory_gb']:.3f} GiB a rank (fits one card: "
                  f"{row['fits_one_card']}), parameters "
                  f"{row['param_bytes_per_device']} B, compute "
                  f"{row['t_compute_s'] * 1e3:.3f} ms, memory "
                  f"{row['t_memory_s'] * 1e3:.3f} ms, collective "
                  f"{row['t_collective_s'] * 1e3:.3f} ms at "
                  f"{roofline.IB_LINK_BYTES_PER_S / 1e9:.0f} GB/s -> "
                  f"{row['dominant']}, collectives "
                  f"{ {k: int(v) for k, v in row['coll_breakdown'].items()} }"
                  f" B, count {row['t_count_s']} s (the H100 SXM's data-sheet "
                  f"peaks)")
    shutil.rmtree(out_dir, ignore_errors=True)
    laps = ranks[0]["laps"]
    print(f"fsdp and production meshes: the ranks' part "
          f"{sum(x for k, x in laps.items() if k.startswith('(26')):.1f} s "
          f"(rank 0's laps, in phase 23's wall), the counts on meta beside "
          f"the earlier phases, the checks here "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {f"{TP_ARCH} FSDP training on 2 x 2 ranks": {
        k: sum(f["launches"][k] for f in fs) for k in want_l}}


def start_head_count() -> tuple:
    """Phase 27 (c)'s counts on meta, started with phase 26's
    (single-threaded processes): ``chip_smoke.py --head-count
    DIR`` (HA_ARCH on rank 0 of the production mesh with and without
    head_axis) and the dry run's command line for zamba2-2.7b at ``--tp``
    HA_TP. Returns (DIR, the processes), which ``phase_head_axis`` reads;
    ``stop_background`` ends any still running."""
    import os
    import subprocess
    import tempfile
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_heads_"))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    cmds = [[sys.executable, str(ROOT / "chip_smoke.py"), "--head-count",
             str(out_dir)],
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "zamba2-2.7b", "--shape", "all", "--mesh", "single", "--tp",
             str(HA_TP), "--out", str(out_dir / "tp.json")]]
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for cmd in cmds]
    _BACKGROUND.extend(procs)
    return out_dir, procs


def head_count(out_dir: str) -> None:
    """Phase 27 (c)'s counts, run as ``chip_smoke.py --head-count DIR``:
    the dry run's ``count_step`` of HA_ARCH on rank 0 of the 16 x 16
    production mesh at HA_COUNT_SHAPES (remat in the train step, as the
    dry run's default), with ``head_axis="model"`` and without; writes
    DIR/count.json."""
    import torch
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model
    from repro_torch.models.attention import head_block
    torch.set_num_threads(1)
    cfg, mesh = get_config(HA_ARCH), make_production_mesh()
    out = {"heads": [head_block(cfg, mesh, "model")[1], cfg.n_heads]}
    for shape in HA_COUNT_SHAPES:
        for axis in ("model", None):
            model = build_model(cfg, mesh=mesh, remat=True, head_axis=axis)
            t0 = time.perf_counter()
            cc, held = count_step(model, INPUT_SHAPES[shape])
            out[f"{shape} {axis}"] = {
                "flops": cc.flops,
                "flash_flops": cc.by_op["flash_attention"][1],
                "coll": {k: v for k, v in cc.coll.items() if v},
                "peak": cc.peak_live_bytes, "held": held,
                "kernels": dict(cc.kernels),
                "secs": time.perf_counter() - t0}
    Path(out_dir, "count.json").write_text(json.dumps(out))


def phase_head_axis(card: str, ranks: list, meta=None):
    """Phase 27: head_axis and the Mamba2 split inside heads, run by phase
    23's ranks (``_ha_rank``), and the counts on meta (``start_head_count``'s,
    started here unless given). Returns ({path: {kernel: launches of all
    ranks}}, the kernel checks at the rank shapes by kernel)."""
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import stand_in_mesh
    from repro_torch.models.attention import head_block
    t_phase = time.perf_counter()
    shapes = ranks[0]["ha"]["kernels"]
    for e in shapes["flash_attention"]:
        print(f"head_axis kernel flash_attention at {e['arch']}'s "
              f"{e['block']} {e['shape']} (b, s, heads, kv heads, d), "
              f"causal bf16: max |kernel - plain| {e['max_abs_err']:.3e}, "
              f"kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, SDPA "
              f"({e['sdpa']}) {e['library_ms']:.4f} ms, bound "
              f"{e['bound_ms']:.4f} ms ({e['bound_by']}) [{card}]")
    for e in shapes["ssd_scan"]:
        print(f"head_axis kernel ssd_scan at {e['arch']}'s sub-heads "
              f"{e['shape']} (b, s, sub-heads, channels, state): max "
              f"|kernel - plain| {e['max_abs_err']:.3e}, kernel "
              f"{e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, bound "
              f"{e['bound_ms']:.4f} ms ({e['bound_by']}) [{card}]")
    paths = {}

    # (a) HA_ARCH on 1 x HA_RANKS
    cfg = _ha_cfg()
    n, (b, s), d = cfg.n_layers, HA_PREFILL, cfg.d_model
    hd, h, kv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    rep = [r["ha"]["a"] for r in ranks[:HA_RANKS]]
    vl = cfg.vocab // HA_RANKS
    act = b * s * d * 2                      # a [B, S, d] bf16 sum
    for r, x in enumerate(rep):
        want_block = list(head_block(cfg, stand_in_mesh(
            {"data": 1, "model": HA_RANKS}, r), "model"))
        want_blocks = {"wq": [n, d, h * hd],
                       "wi_gate": [n, d, cfg.d_ff // HA_RANKS],
                       "embed": [vl, d]}
        if x["block"] != want_block or x["blocks"] != want_blocks:
            raise AssertionError(f"head_axis {cfg.name}, rank {r}: block "
                                 f"{x['block']} (expected {want_block}), "
                                 f"weights {x['blocks']} (expected "
                                 f"{want_blocks})")
        # head_axis: each layer's attention and MLP outputs, the lookup;
        # without it the MLP's and the lookup
        for name, calls in (("model", 2 * n + 1), ("none", n + 1)):
            p = x["prefill_" + name]
            want = {"launches": {"flash_attention": n,
                                 "flash_attention tc": n},
                    "sums": [calls, calls * act], "gathered": b * s * vl * 4,
                    "shape": [b, s, cfg.vocab], "finite": True}
            got = {k: p[k] if k != "sums" else p[k][:2] for k in want}
            if got != want:
                raise AssertionError(f"head_axis {cfg.name} prefill "
                                     f"({name}), rank {r}: {got}, expected "
                                     f"{want}")
    gap = max(x["gap"] for x in rep)
    walls = {k: max(x["prefill_" + k]["wall_s"] for x in rep)
             for k in ("model", "none")}
    secs = {k: max(x["prefill_" + k]["sums"][2] for x in rep)
            for k in ("model", "none")}
    flash = {e["heads"][1]: e for e in shapes["flash_attention"]}
    per_rank = [flash[x["block"][1]]["ms"] for x in rep]
    print(f"head_axis {cfg.name}, {n} layers, bf16 prefill {b} x {s} on 1 x "
          f"{HA_RANKS} ranks (blocks {[x['block'] for x in rep]} of {h} "
          f"heads, {kv} kv heads): head_axis='model' "
          f"{b * s / walls['model']:.1f} tokens/s ({walls['model']:.3f} s, "
          f"{secs['model']:.3f} s in {2 * n + 1} sums of {act} B), "
          f"head_axis=None {b * s / walls['none']:.1f} tokens/s "
          f"({walls['none']:.3f} s, {secs['none']:.3f} s in {n + 1} sums); "
          f"attention kernel a rank {[round(x, 4) for x in per_rank]} ms "
          f"against {flash[h]['ms']:.4f} ms on the whole {h} heads "
          f"({max(per_rank) / flash[h]['ms']:.3f}x); flash_attention {n} "
          f"launches a rank, tensor-core, in each; max |logits - "
          f"head_axis=None's| {gap:.4e} (bound {TP_BF16_GAP}); peak by rank "
          f"{[x['prefill_model']['peak_bytes'] for x in rep]} B [{card}]")
    if not gap <= TP_BF16_GAP:
        raise AssertionError(f"head_axis {cfg.name}: the bf16 logits are "
                             f"{gap:.4e} from head_axis=None's, past "
                             f"{TP_BF16_GAP}")
    f32 = rep[0]["f32"]
    print(f"head_axis f32 {cfg.name}, {n} layers, 1 x {HA_PARITY_S} on 1 x "
          f"{HA_RANKS} vs one process on the same weights: max |diff| "
          f"{f32['diff']:.3e} (tol {REF_PREFILL_TOL}), logits up to "
          f"{f32['logit_max']:.3f} [{card}]")
    if not f32["diff"] <= REF_PREFILL_TOL:
        raise AssertionError(f"head_axis f32 {cfg.name}: the mesh and one "
                             f"process disagree")
    # a step: the forward's sums as the prefill's; the backward's a layer
    # one of the input and the whole attention weights (f32, one transfer)
    # and one of the MLP's input, and one of the unembedding's input
    tb, ts = MESH_TRAIN
    tact = tb * ts * d * 2
    leaves = 2 * d * h * hd + 2 * d * kv * hd + (h * hd + 2 * kv * hd) * \
        cfg.qkv_bias
    whole = 4 * (tb * ts * d + leaves)
    want_sums = {"model": [TP_TRAIN_STEPS * (4 * n + 2),
                           TP_TRAIN_STEPS * ((3 * n + 2) * tact + n * whole)],
                 "none": [TP_TRAIN_STEPS * (2 * n + 2),
                          TP_TRAIN_STEPS * (2 * n + 2) * tact]}
    nl = TP_TRAIN_STEPS * n
    want_l = {"flash_attention": nl, "flash_attention tc": nl}
    for name in ("model", "none"):
        tr = [x["train_" + name] for x in rep]
        for r, t in enumerate(tr):
            if t["launches"] != want_l or t["sums"][:2] != want_sums[name] \
                    or t["losses"] != tr[0]["losses"]:
                raise AssertionError(f"head_axis training ({name}), rank {r}"
                                     f": launches {t['launches']} (expected "
                                     f"{want_l}), sums {t['sums'][:2]} "
                                     f"(expected {want_sums[name]}), losses "
                                     f"{t['losses']} (rank 0 "
                                     f"{tr[0]['losses']})")
        losses = tr[0]["losses"]
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"head_axis training ({name}): losses "
                                 f"{losses} do not fall")
        if len({t["attn_digest"] for t in tr}) != 1:
            raise AssertionError(f"head_axis training ({name}): the whole "
                                 f"attention weights differ between ranks")
    tm, tn = ([x["train_" + k] for x in rep] for k in ("model", "none"))
    lgap = max(abs(a - b) for a, b in zip(tm[0]["losses"], tn[0]["losses"]))
    if not lgap <= TP_BF16_GAP:
        raise AssertionError(f"head_axis training: losses {tm[0]['losses']} "
                             f"against head_axis=None's {tn[0]['losses']}, "
                             f"past {TP_BF16_GAP}")
    walls = {k: [max(t["step_s"][i] for t in tr)
                 for i in range(TP_TRAIN_STEPS)]
             for k, tr in (("model", tm), ("none", tn))}
    # the first step also pins the host buffers its sums stage through
    rates = {k: 1 / w[-1] for k, w in walls.items()}
    print(f"head_axis {cfg.name} training on 1 x {HA_RANKS}: "
          f"{TP_TRAIN_STEPS} SGD steps (lr {TP_LR}) at {tb} x {ts}, bf16 "
          f"compute, step walls {[round(x, 4) for x in walls['model']]} s "
          f"with head_axis='model', {[round(x, 4) for x in walls['none']]} "
          f"without: head_axis='model' {rates['model']:.3f} steps/s (the "
          f"last step), losses "
          f"{[round(x, 4) for x in tm[0]['losses']]}, "
          f"{tm[0]['sums'][0]} sums a rank ({tm[0]['sums'][1]} B, "
          f"{max(t['sums'][2] for t in tm):.3f} s; the backward's sum of a "
          f"layer's input and whole attention weights {whole} B), peak by "
          f"rank {[t['peak_bytes'] for t in tm]} B; head_axis=None "
          f"{rates['none']:.3f} steps/s, losses "
          f"{[round(x, 4) for x in tn[0]['losses']]} (largest gap "
          f"{lgap:.4e}, bound {TP_BF16_GAP}), {tn[0]['sums'][0]} sums "
          f"({tn[0]['sums'][1]} B), peak by rank "
          f"{[t['peak_bytes'] for t in tn]} B; every whole attention leaf "
          f"bitwise equal on the {HA_RANKS} ranks after the steps [{card}]")
    paths[f"{HA_ARCH} prefill with head_axis on 1 x {HA_RANKS} ranks"] = {
        k: sum(x["prefill_model"]["launches"][k] for x in rep)
        for k in ("flash_attention", "flash_attention tc")}

    # (b) the Mamba2 mixer split inside heads on 1 x MESH_RANKS
    mc = _ha_mixer_cfg()
    hb = [r["ha"]["b"] for r in ranks]
    d_in = mc.ssm_expand * mc.d_model
    dl = d_in // MESH_RANKS
    g = math.gcd(dl, mc.ssm_head_dim)
    for r, x in enumerate(hb):
        want = {"ssd_scan": x["scans"], "flash_attention": x["attns"],
                "flash_attention tc": 0}
        if x["launches"] != want or x["w_x"] != [mc.d_model, dl] or \
                x["w_dt"] != [mc.d_model, d_in // mc.ssm_head_dim] or \
                x["ssm_cache"] != [2, dl // g, g, mc.ssm_state] or \
                x["tokens"] != hb[0]["tokens"]:
            raise AssertionError(f"head_axis mixer, rank {r}: launches "
                                 f"{x['launches']} (expected {want}), w_x "
                                 f"{x['w_x']}, w_dt {x['w_dt']}, ssm cache "
                                 f"{x['ssm_cache']}, tokens {x['tokens']}")
    one = hb[0]
    print(f"head_axis mixer {mc.name} (d_model {mc.d_model}, "
          f"{d_in // mc.ssm_head_dim} SSM heads of {mc.ssm_head_dim}, state "
          f"{mc.ssm_state}) f32 on 1 x {MESH_RANKS}: {dl} channels a rank "
          f"scanned as {dl // g} sub-heads of {g}, ssd_scan {one['scans']} "
          f"launch(es) a rank; prefill 2 x {HA_MIXER_S} vs one process max "
          f"|diff| {one['diff']:.3e} (tol {REF_PREFILL_TOL}), logits up to "
          f"{one['logit_max']:.3f}; {HA_MIXER_GEN} greedy tokens at batch "
          f"{TP_DECODE[0]} equal on every rank and "
          f"{'equal' if one['tokens'] == one['one_process'] else 'NOT equal'}"
          f" to one process's [{card}]")
    if not one["diff"] <= REF_PREFILL_TOL or \
            one["tokens"] != one["one_process"]:
        raise AssertionError("head_axis mixer: the mesh and one process "
                             "disagree")
    paths[f"{mc.name} mixer split inside heads on 1 x {MESH_RANKS} ranks"] \
        = {k: sum(x["launches"][k] for x in hb)
           for k in ("ssd_scan", "flash_attention")}

    # (c) the counts on meta
    out_dir, procs = meta if meta is not None else start_head_count()
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"phase 27's count {p.args[1:]}: exit "
                                 f"{p.returncode}\n{log[-4000:]}")
    counts = json.loads((out_dir / "count.json").read_text())
    blk, heads = counts["heads"]
    for shape in HA_COUNT_SHAPES:
        on, off = counts[f"{shape} model"], counts[f"{shape} None"]
        ratio = on["flash_flops"] / off["flash_flops"]
        print(f"head_axis count of {HA_ARCH} {shape} on rank 0 of 16 x 16 "
              f"(meta): attention kernel FLOPs a rank {on['flash_flops']:.4e}"
              f" with head_axis='model' against {off['flash_flops']:.4e} "
              f"without ({ratio:.4f}, {blk} of {heads} heads); FLOPs "
              f"{on['flops']:.4e} / {off['flops']:.4e}; collectives "
              f"{ {k: int(v) for k, v in on['coll'].items()} } / "
              f"{ {k: int(v) for k, v in off['coll'].items()} } B; peak "
              f"{on['peak'] / 2**30:.3f} / {off['peak'] / 2**30:.3f} GiB; "
              f"count {on['secs']:.1f} / {off['secs']:.1f} s")
        if on["flash_flops"] * heads != off["flash_flops"] * blk or \
                on["kernels"] != off["kernels"]:
            raise AssertionError(f"head_axis count {shape}: the attention "
                                 f"FLOPs a rank are not {blk} of {heads} "
                                 f"heads' ({ratio})")
    for row in json.loads((out_dir / "tp.json").read_text()):
        if row["status"] != "ok":
            raise AssertionError(f"dry run zamba2-2.7b --tp {HA_TP}: {row}")
        print(f"head_axis dry run zamba2-2.7b x {row['shape']} on rank 0 of "
              f"{256 // HA_TP} x {HA_TP} (the mixer split inside heads: 160 "
              f"channels a rank, 5 sub-heads of 32): peak "
              f"{row['peak_memory_gb']:.3f} GiB a rank (fits one card: "
              f"{row['fits_one_card']}), compute "
              f"{row['t_compute_s'] * 1e3:.3f} ms, memory "
              f"{row['t_memory_s'] * 1e3:.3f} ms, collective "
              f"{row['t_collective_s'] * 1e3:.3f} ms at "
              f"{roofline.IB_LINK_BYTES_PER_S / 1e9:.0f} GB/s -> "
              f"{row['dominant']}, kernels {row['kernels']}, count "
              f"{row['t_count_s']} s (the H100 SXM's data-sheet peaks)")
    shutil.rmtree(out_dir, ignore_errors=True)
    laps = ranks[0]["laps"]
    print(f"head_axis: the ranks' part "
          f"{sum(x for k, x in laps.items() if k.startswith('(27')):.1f} s "
          f"(rank 0's laps, in phase 23's wall), the counts on meta beside "
          f"the earlier phases, the checks here "
          f"{time.perf_counter() - t_phase:.1f} s")
    return paths, shapes


def _cs_seq_bytes(cfg, kinds, dp: int, tp: int, s: int, item: int) -> int:
    """The bytes one forward's gathers send from a rank of dp x tp at a
    sequence of s (batch 1): a carried layer's input [s / dp, d_model], an
    attention layer's K and V (``_cp_bytes``)."""
    carried = sum(k in ("mamba", "xlstm_pair") for k in kinds)
    return carried * (s // dp) * cfg.d_model * item + \
        (len(kinds) - carried) * _cp_bytes(cfg, dp, tp, s, item)


def _cs_share(runs: list) -> list:
    """Each rank's share of its prefill's device time in the whole-sequence
    mixers (CUDA events on its stream)."""
    return [round(x["mixer_ms"] / x["device_ms"], 4) for x in runs]


def phase_context_state(card: str, ranks: list):
    """Phase 28: context parallelism through the layers that carry state
    and through the vlm and audio families, run by phase 23's ranks
    (``_cs_rank``); holds their reports. Returns ({path: {kernel: launches
    of all ranks}}, the kernel checks at the rank shapes by kernel)."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    shapes = {k: v for r in ranks for k, v in r["cs"].get("kernels",
                                                          {}).items()}
    for e in shapes["ssd_scan"] + shapes["slstm_scan"]:
        print(f"cs kernel {'ssd_scan' if len(e['shape']) == 5 else 'slstm_scan'}"
              f" at {e['arch']}'s rank of {e['mesh'][0]} x {e['mesh'][1]} "
              f"(the whole gathered sequence) {e['shape']}: max |kernel - "
              f"plain| {e['max_abs_err']:.3e}, kernel {e['ms']:.4f} ms, "
              f"plain {e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
              f"({e['bound_by']}) [{card}]")
    for e in shapes["flash_attention"]:
        print(f"cs kernel flash_attention at {e['arch']}'s {e['part']}, "
              f"[b, s, sk, h, kv, d] {e['shape']} "
              f"{'right-aligned causal' if e['causal'] else 'bidirectional'}"
              f", tensor-core: max |kernel - plain| {e['max_abs_err']:.3e} "
              f"(max |SDPA - kernel| {e['sdpa_diff']:.3e}), kernel "
              f"{e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, SDPA "
              f"{e['library_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
              f"({e['bound_by']}) [{card}]")
    paths = {}
    s = CS_PREFILL

    # (a) the hybrid
    cfg = dataclasses.replace(get_config(HYBRID_ARCH),
                              n_layers=CS_HYBRID_LAYERS)
    kinds = ranks[0]["cs"]["a_kinds"]
    scans, attns = kinds.count("mamba"), kinds.count("shared_attn")
    if (scans, attns) != (CS_HYBRID_SCANS, CS_HYBRID_ATTNS):
        raise AssertionError(f"cs {cfg.name} at {CS_HYBRID_LAYERS} layers: "
                             f"{scans} Mamba2 and {attns} shared attention "
                             f"layers")
    want_l = {"ssd_scan": scans, "flash_attention": attns,
              "flash_attention tc": attns}
    for i, (dp, tp) in enumerate(CP_MESHES):
        rows = [r["cs"]["a"][i] for r in ranks]
        sent = _cs_seq_bytes(cfg, kinds, dp, tp, s, 2)
        want = {"seq": [len(kinds), sent, sent * (dp - 1)],
                "none": [0, 0, 0]}
        for r, x in zip(ranks, rows):
            for name, shape in (("seq", [1, s // dp, cfg.vocab]),
                                ("none", [1, s, cfg.vocab])):
                run = x[name]
                if run["launches"] != want_l or not run["finite"] or \
                        run["shape"] != shape or \
                        run["moved"]["seq_gather"] != want[name] or \
                        run["moved"]["seq_scatter"] != [0, 0]:
                    raise AssertionError(
                        f"cs {cfg.name} prefill ({name}) on {dp} x {tp}, "
                        f"rank {r['rank']}: launches {run['launches']} "
                        f"(expected {want_l}), finite {run['finite']}, "
                        f"logits {run['shape']} (expected {shape}), gathers "
                        f"{run['moved']['seq_gather']} (expected "
                        f"{want[name]})")
        gap = max(x["gap"] for x in rows)
        walls = {k: max(x[k]["wall_s"] for x in rows) for k in ("seq",
                                                                 "none")}
        print(f"cs {cfg.name}, {CS_HYBRID_LAYERS} layers ({scans} Mamba2, "
              f"{attns} shared attention), bf16 prefill 1 x {s} on {dp} x "
              f"{tp} ranks: seq_axis='data' {s / walls['seq']:.1f} tokens/s "
              f"({walls['seq']:.3f} s), seq_axis=None {s / walls['none']:.1f}"
              f" tokens/s ({walls['none']:.3f} s); gathers a rank exact: "
              f"{len(kinds)} ({scans} of the Mamba2 input [1, {s // dp}, "
              f"{cfg.d_model}], {attns} of K/V), {sent} B sent, "
              f"{sent * (dp - 1)} B received; ssd_scan {scans} and "
              f"flash_attention {attns} (tensor-core) a rank in each; the "
              f"Mamba2 mixers' share of a rank's device time "
              f"{_cs_share([x['seq'] for x in rows])} with seq_axis, "
              f"{_cs_share([x['none'] for x in rows])} without; max "
              f"|logits - seq_axis=None's| {gap:.4e} (bound {TP_BF16_GAP}); "
              f"peak by rank {[x['seq']['peak_bytes'] for x in rows]} B "
              f"[{card}]")
        if not gap <= TP_BF16_GAP:
            raise AssertionError(f"cs {cfg.name} on {dp} x {tp}: the bf16 "
                                 f"logits are {gap:.4e} from seq_axis=None's")
        paths[f"{HYBRID_ARCH} prefill ({CS_HYBRID_LAYERS} layers) on {dp} x "
              f"{tp} ranks (seq over data)"] = {
            k: sum(x["seq"]["launches"][k] for x in rows) for k in want_l}
    for i, (dp, tp) in enumerate(CP_MESHES):
        xs = [r["cs"]["a_f32"][i] for r in ranks]
        diff = max(x["diff"] for x in xs)
        sent = _cs_seq_bytes(cfg, kinds, dp, tp, CS_PARITY_S, 4)
        moved = [x["moved"]["seq_gather"][:2] for x in xs]
        slots = [(CS_PROMPT + CS_GEN) // dp] * attns
        same = all(x.get("tokens") == x.get("one_process") and
                   x.get("slots", slots) == slots for x in xs)
        print(f"cs f32 {cfg.name}, {CS_HYBRID_LAYERS} layers, 1 x "
              f"{CS_PARITY_S} on {dp} x {tp} vs one process on the same "
              f"weights: max |diff| {diff:.3e} (tol {REF_PREFILL_TOL}, logits "
              f"up to {xs[0]['logit_max']:.3f}); gathers {moved[0]} (calls, "
              f"B; expected {[len(kinds), sent]})"
              + ("" if "tokens" not in xs[0] else
                 f"; greedy decode at batch 1 ({CS_PROMPT} + {CS_GEN} "
                 f"tokens, the shared attention's cache {slots[0]} slots a "
                 f"rank, the Mamba2 states whole): "
                 + ("equal one process's" if same else "DIFFERENT"))
              + f" [{card}]")
        if not (diff <= REF_PREFILL_TOL and same and
                all(m == [len(kinds), sent] for m in moved)):
            raise AssertionError(f"cs f32 {cfg.name} on {dp} x {tp}: the "
                                 f"mesh and one process disagree")
    tr = [r["cs"]["a_train"] for r in ranks]
    losses = tr[0]["losses"]
    sent = _cs_seq_bytes(cfg, kinds, 2, 2, CS_TRAIN_S, 2)
    want_t = {k: 2 * CS_TRAIN_STEPS * v for k, v in want_l.items()}
    # a step: the forward's gathers ("dots" keeps them for the
    # recomputation) and their backward's reduce-scatters of the whole
    # sequence
    want_m = [[len(kinds), sent], [len(kinds), 2 * sent]]
    for r, t in zip(ranks, tr):
        got = [[m["seq_gather"][:2], m["seq_scatter"]] for m in t["moved"]]
        if t["launches"] != want_t or t["losses"] != losses or \
                got != [want_m] * CS_TRAIN_STEPS:
            raise AssertionError(f"cs training, rank {r['rank']}: launches "
                                 f"{t['launches']} (expected {want_t}), "
                                 f"gathers and scatters a step {got} "
                                 f"(expected {want_m}), losses "
                                 f"{t['losses']} (rank 0 {losses})")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"cs training: losses {losses} do not fall")
    if len({t["whole_digest"] for t in tr}) != 1:
        raise AssertionError("cs training: the weights held whole differ "
                             "between ranks")
    steps = [max(t["step_s"][i] for t in tr) for i in range(CS_TRAIN_STEPS)]
    print(f"cs {cfg.name} training on 2 x 2 ranks (seq over data, heads over "
          f"model): {CS_TRAIN_STEPS} SGD steps (lr {CS_LR}) at 1 x "
          f"{CS_TRAIN_S}, remat \"dots\", in place: step walls "
          f"{[round(x, 4) for x in steps]} s, losses "
          f"{[round(x, 4) for x in losses]}; a step's gathers and "
          f"reduce-scatters a rank {want_m} (calls, B), exact; ssd_scan "
          f"{2 * scans} and flash_attention {2 * attns} a step a rank (the "
          f"forward and the recomputation); the weights held whole bitwise "
          f"equal on every rank; peak by rank "
          f"{[t['peak_bytes'] for t in tr]} B [{card}]")
    paths[f"{HYBRID_ARCH} training on 2 x 2 ranks (seq over data)"] = {
        k: sum(t["launches"][k] for t in tr) for k in want_t}

    # (b) xlstm
    xc = get_config(XLSTM_ARCH)
    pairs = xc.n_layers // 2
    m = s // MESH_RANKS
    for i, dtype in enumerate(("bfloat16", "float32")):
        rows = [r["cs"]["b"][i] for r in ranks]
        item = 2 if dtype == "bfloat16" else 4
        sent = pairs * m * xc.d_model * item
        want = {"seq": [pairs, sent, sent * (MESH_RANKS - 1)],
                "none": [0, 0, 0]}
        for r, x in zip(ranks, rows):
            for name in ("seq", "none"):
                run = x[name]
                if run["launches"] != {"slstm_scan": pairs} or \
                        run["moved"]["seq_gather"] != want[name]:
                    raise AssertionError(
                        f"cs {XLSTM_ARCH} {dtype} prefill ({name}), rank "
                        f"{r['rank']}: launches {run['launches']} (expected "
                        f"{pairs}), gathers {run['moved']['seq_gather']} "
                        f"(expected {want[name]})")
            if x["shape"] != [1, m, xc.vocab] or not x["finite"]:
                raise AssertionError(f"cs {XLSTM_ARCH} {dtype}: logits "
                                     f"{x['shape']}, finite {x['finite']}")
        hgap, gap = (max(x[k] for x in rows) for k in ("hidden_gap", "gap"))
        tol = TP_BF16_GAP if dtype == "bfloat16" else XLSTM_REF_PREFILL_TOL
        walls = {k: max(x[k]["wall_s"] for x in rows) for k in ("seq",
                                                                 "none")}
        print(f"cs {XLSTM_ARCH} ({pairs} mLSTM/sLSTM pairs) {dtype} prefill "
              f"1 x {s} on {MESH_RANKS} x 1 ranks (each pair on the whole "
              f"gathered sequence): seq_axis='data' {s / walls['seq']:.1f} "
              f"tokens/s ({walls['seq']:.3f} s), one process a rank "
              f"{s / walls['none']:.1f} tokens/s ({walls['none']:.3f} s); "
              f"gathers a rank exact: {pairs} of [1, {m}, {xc.d_model}], "
              f"{sent} B sent; slstm_scan {pairs} a rank; the pairs' share "
              f"of a rank's device time {_cs_share([x['seq'] for x in rows])}"
              f" with seq_axis, {_cs_share([x['none'] for x in rows])} in "
              f"one process; max |hidden state before the final norm - one "
              f"process's| {hgap:.4e} (expected 0); max |logits - one "
              f"process's| {gap:.4e} (bound {tol}, logits up to "
              f"{rows[0]['logit_max']:.3f}); peak by rank "
              f"{[x['seq']['peak_bytes'] for x in rows]} B [{card}]")
        if not gap <= tol:
            raise AssertionError(f"cs {XLSTM_ARCH} {dtype}: the logits are "
                                 f"{gap:.4e} from one process's")
        if dtype == "bfloat16":
            paths[f"{XLSTM_ARCH} prefill on {MESH_RANKS} x 1 ranks (seq "
                  f"over data)"] = {"slstm_scan": sum(
                      x["seq"]["launches"]["slstm_scan"] for x in rows)}

    # (c) the vision prefix on 2 x 2
    vc = dataclasses.replace(get_config(VISION_ARCH), n_layers=WIDE_LAYERS)
    vt, n = vc.vision_tokens, WIDE_LAYERS
    rows = [r["cs"]["c"] for r in ranks]
    sent = n * _cp_bytes(vc, 2, 2, s, 2)
    want_l = {"flash_attention": n, "flash_attention tc": n}
    for r, x in zip(ranks, rows):
        d = r["rank"] // 2
        lo = d * (s // 2)
        want_rows = [max(0, min(vt - lo, s // 2)), s // 2 - max(0, min(
            vt - lo, s // 2))]
        lo32 = d * (CS_PARITY_S // 2)
        v32 = max(0, min(vt - lo32, CS_PARITY_S // 2))
        want = {"seq": ([1, s // 2, vc.vocab], [n, sent, sent]),
                "none": ([1, s, vc.vocab], [0, 0, 0])}
        bad = [x["seq_rows"] != want_rows, x["none_rows"] != [vt, s - vt],
               x["f32"]["rows"] != [v32, CS_PARITY_S // 2 - v32]]
        for name, (shape, gathers) in want.items():
            run = x[name]
            bad += [run["launches"] != want_l, not run["finite"],
                    run["shape"] != shape,
                    run["moved"]["seq_gather"] != gathers]
        if any(bad):
            raise AssertionError(f"cs {vc.name} on 2 x 2, rank {r['rank']}: "
                                 f"rows (vision, text) {x['seq_rows']} "
                                 f"(expected {want_rows}), f32 "
                                 f"{x['f32']['rows']}, runs "
                                 f"{ {k: x[k] for k in want} }")
    x = rows[0]
    gap = max(y["gap"] for y in rows)
    diff = max(y["f32"]["diff"] for y in rows)
    lgap = max(abs(y["f32"]["loss"] - y["f32"]["local_loss"]) for y in rows)
    walls = {k: max(y[k]["wall_s"] for y in rows) for k in ("seq", "none")}
    print(f"cs {vc.name} at full width, {n} layers, bf16 prefill 1 x {s} "
          f"({vt} vision rows, then {s - vt} tokens) on 2 x 2 ranks (heads "
          f"and vocabulary over model, {x['rank_params']} weights a rank): "
          f"seq_axis='data' {s / walls['seq']:.1f} tokens/s "
          f"({walls['seq']:.3f} s; a rank's (vision, text) rows "
          f"{[y['seq_rows'] for y in rows]}), seq_axis=None "
          f"{s / walls['none']:.1f} tokens/s ({walls['none']:.3f} s); K/V "
          f"gathers a rank exact: {n} of {sent // n} B; flash_attention {n} "
          f"a rank, tensor-core, in each; max |logits - seq_axis=None's| "
          f"{gap:.4e} (bound {TP_BF16_GAP}); peak by rank "
          f"{[y['seq']['peak_bytes'] for y in rows]} B [{card}]")
    print(f"cs f32 {vc.name}, 1 x {CS_PARITY_S} ({vt} vision rows, "
          f"{CS_PARITY_S - vt} tokens: data rank 0 all vision, its tokens "
          f"none) on 2 x 2 vs seq_axis=None: max |diff| {diff:.3e} (tol "
          f"{REF_PREFILL_TOL}, logits up to {x['f32']['logit_max']:.3f}); "
          f"loss, the shares {[round(y['f32']['share'], 6) for y in rows]} "
          f"summed over data, {x['f32']['loss']:.6f} vs "
          f"{x['f32']['local_loss']:.6f} over the text targets only (gap "
          f"{lgap:.3e}, tol {LOSS_REL_TP} relative) [{card}]")
    if not (gap <= TP_BF16_GAP and diff <= REF_PREFILL_TOL and
            lgap <= LOSS_REL_TP * abs(x["f32"]["local_loss"]) and
            all(y["f32"]["share"] == 0.0 for y in rows[:2])):
        raise AssertionError(f"cs {vc.name}: seq_axis and seq_axis=None "
                             f"disagree")
    paths[f"{VISION_ARCH} prefill on 2 x 2 ranks (seq over data)"] = {
        k: sum(y["seq"]["launches"][k] for y in rows) for k in want_l}

    # (d) Whisper on MESH_RANKS x 1
    ac = get_config(AUDIO_ARCH)
    rows = [r["cs"]["d"] for r in ranks]
    ma = AUDIO_S // MESH_RANKS
    each = AUDIO_B * ma * 2 * ac.n_kv_heads * ac.resolved_head_dim * 2
    n = ac.n_layers
    want_l = {"flash_attention": ac.encoder_layers + n,
              "flash_attention tc": ac.encoder_layers + n}
    want = {"seq": ([AUDIO_B, ma, ac.vocab], [n, n * each,
                                              n * each * (MESH_RANKS - 1)]),
            "none": ([AUDIO_B, AUDIO_S, ac.vocab], [0, 0, 0])}
    want_t = {k: CS_TRAIN_STEPS * v for k, v in want_l.items()}
    each_t = each * CS_AUDIO_TRAIN_B // AUDIO_B
    want_m = [[n, n * each_t], [n, MESH_RANKS * n * each_t]]
    tr0 = rows[0]["train"]
    for r, x in zip(ranks, rows):
        bad = [x["rows"] != [[AUDIO_B, ma], [AUDIO_B, ac.encoder_seq,
                                             ac.d_model]]]
        for name, (shape, gathers) in want.items():
            run = x[name]
            bad += [run["launches"] != want_l, not run["finite"],
                    run["shape"] != shape,
                    run["moved"]["seq_gather"] != gathers]
        t = x["train"]
        bad += [t["launches"] != want_t, t["losses"] != tr0["losses"],
                t["digest"] != tr0["digest"],
                [[m["seq_gather"][:2], m["seq_scatter"]] for m in t["moved"]]
                != [want_m] * CS_TRAIN_STEPS]
        if any(bad):
            raise AssertionError(f"cs {AUDIO_ARCH}, rank {r['rank']}: "
                                 f"{[i for i, b in enumerate(bad) if b]} of "
                                 f"the checks fail: rows {x['rows']}, runs "
                                 f"{ {k: x[k] for k in want} }, training "
                                 f"{t}")
    x = rows[0]
    gap = max(y["gap"] for y in rows)
    diff = max(y["f32"]["diff"] for y in rows)
    same = all(y["f32"]["tokens"] == y["f32"]["one_process"] for y in rows)
    losses = tr0["losses"]
    lgap = abs(losses[0] - x["local_loss"])
    walls = {k: max(y[k]["wall_s"] for y in rows) for k in ("seq", "none")}
    steps = [max(y["train"]["step_s"][i] for y in rows)
             for i in range(CS_TRAIN_STEPS)]
    toks = AUDIO_B * AUDIO_S
    print(f"cs {ac.name} whole ({ac.encoder_layers} + {n} layers), bf16 "
          f"prefill {AUDIO_B} x {AUDIO_S} tokens over {AUDIO_B} x "
          f"{ac.encoder_seq} frames on {MESH_RANKS} x 1 ranks ({ma} tokens "
          f"a rank, the encoder whole on each): seq_axis='data' "
          f"{toks / walls['seq']:.1f} tokens/s ({walls['seq']:.3f} s), one "
          f"process a rank {toks / walls['none']:.1f} tokens/s "
          f"({walls['none']:.3f} s); K/V gathers a rank exact: {n} of "
          f"{each} B; flash_attention {want_l['flash_attention']} a rank "
          f"({ac.encoder_layers} encoder, {n} decoder), tensor-core; max "
          f"|logits - one process's| {gap:.4e} (bound {TP_BF16_GAP}); f32 "
          f"copy max |diff| {diff:.3e} (tol {REF_PREFILL_TOL}, logits up to "
          f"{x['f32']['logit_max']:.3f}); greedy decode at batch 1 "
          f"({CS_PROMPT} + {CS_GEN} tokens, the self and cross caches' "
          f"slots over data): "
          f"{'equal one process' if same else 'DIFFERENT'}; "
          f"{CS_TRAIN_STEPS} SGD steps (lr {CS_LR}) at {CS_AUDIO_TRAIN_B} x "
          f"{AUDIO_S}: step walls "
          f"{[round(y, 4) for y in steps]} s, losses "
          f"{[round(y, 4) for y in losses]} (one process's bf16 loss "
          f"{x['local_loss']:.4f}, gap {lgap:.3e}), a step's gathers and "
          f"reduce-scatters a rank {want_m} (calls, B), exact, the weights "
          f"bitwise equal on every rank; peak by rank "
          f"{[y['train']['peak_bytes'] for y in rows]} B [{card}]")
    if not (gap <= TP_BF16_GAP and diff <= REF_PREFILL_TOL and same and
            lgap <= TP_BF16_GAP and all(math.isfinite(y) for y in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"cs {ac.name}: the mesh and one process "
                             f"disagree, or the losses do not fall")
    paths[f"{AUDIO_ARCH} prefill on {MESH_RANKS} x 1 ranks (seq over "
          f"data)"] = {k: sum(y["seq"]["launches"][k] for y in rows)
                       for k in want_l}
    laps = ranks[0]["laps"]
    print(f"context parallelism through state: the ranks' part "
          f"{sum(v for k, v in laps.items() if k.startswith('(28')):.1f} s "
          f"(rank 0's laps, in phase 23's wall; by part "
          f"{ {k: round(v, 1) for k, v in laps.items() if k.startswith('(28')} }"
          f"), the checks here {time.perf_counter() - t_phase:.1f} s")
    return paths, shapes


def _cl_step_moves(cfg, dp: int, tp: int, b: int, s: int,
                   item: int) -> list:
    """[sums, their bytes, gathers, their bytes] of one decode step of
    ``cfg`` on a rank of ``dp`` x ``tp`` decoding ``b`` rows from
    ``cache_specs``' blocks of ``s``-slot caches, from the layout alone:
    the vocabulary's sum and gather (LM, vocabulary split), then per
    attention layer q's gather (``head_dim`` cut under a split ``wq``, in
    the compute dtype of ``item`` bytes), the f32 scores' sum and output's
    gather (``head_dim`` cut), the f32 partial softmaxes' gather (slots
    cut), the heads' f32 outputs' gather (Whisper, heads cut), the output
    projection's and the MLP's sums (weights split)."""
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
            gathers.append(b * heads // tp * hd * item)
        if by_dim:
            sums.append(b * heads * m * 4)
        if n > 1:
            gathers.append(b * hq * (2 + hdr) * 4)
        if by_dim:
            gathers.append(b * heads * hdr * 4)
        if audio and by_heads:
            gathers.append(b * hq * hd * 4)
        if q_split:
            sums.append(b * d * item)

    if audio:
        for _ in range(cfg.n_layers):
            attn(s, False)
            attn(cfg.encoder_seq, False)
    else:
        if tp > 1 and cfg.vocab % tp == 0:
            sums.append(b * d * item)
            gathers.append(b * cfg.vocab // tp * 4)
        for st in build_program(cfg):
            for _ in range(st.count):
                attn(s if st.window is None else min(st.window, s),
                     tp > 1 and heads % tp == 0)
                if tp > 1 and cfg.d_ff % tp == 0:
                    sums.append(b * d * item)
    return [len(sums), sum(sums), len(gathers), sum(gathers)]


def _cl_held(label: str, cfg, entries: list, card: str) -> None:
    """Phase 29's checks of one model's decodes on each mesh, from every
    rank's ``entries`` (one list a rank): the tokens equal on every rank
    and, in f32, to one process's whole-cache decode; the f32 last logits
    within DECODE_TOL; the cache a rank exactly a quarter of the whole's
    bytes; the sums and gathers of the decode steps exactly
    ``_cl_step_moves``' each step."""
    steps = CL_PROMPT + CL_GEN
    for i, first in enumerate(entries[0]):
        (dp, tp), b = first["mesh"], first["b"]
        rows = b // dp if b % dp == 0 else b
        one = first["one_process"]
        for dtype in ("bfloat16", "float32"):
            if dtype not in first:
                continue
            c = dataclasses.replace(cfg, dtype=dtype)
            want = [steps * x for x in _cl_step_moves(
                c, dp, tp, rows, steps, 2 if dtype == "bfloat16" else 4)]
            runs = [e[i][dtype] for e in entries]
            for r, x in enumerate(runs):
                if not x["finite"] or x["moved"] != want or \
                        4 * x["kv_bytes"] != one["kv_bytes"]:
                    raise AssertionError(
                        f"cl {label} {dtype} on {dp} x {tp}, rank {r}: "
                        f"finite {x['finite']}, moved {x['moved']} "
                        f"(expected {want}), cache {x['kv_bytes']} B "
                        f"(expected a quarter of {one['kv_bytes']} B)")
            los = [e[i]["lo"] for e in entries]
            by_lo = {lo: x["tokens"] for lo, x in zip(los, runs)}
            if any(x["tokens"] != by_lo[lo] for lo, x in zip(los, runs)):
                raise AssertionError(f"cl {label} {dtype} on {dp} x {tp}: "
                                     f"the ranks of one block of rows "
                                     f"decode different tokens")
            wall = max(x["decode_s"] for x in runs)
            sum_s = max(x["sum_s"] for x in runs)
            line = (f"cl {label} {dtype} decode on {dp} x {tp} at global "
                    f"batch {b} ({rows} of its rows a rank): "
                    f"{rows * CL_GEN / wall:.2f} tokens/s ({wall:.3f} s for "
                    f"{CL_GEN} tokens, prompt "
                    f"replay {max(x['prefill_s'] for x in runs):.3f} s; one "
                    f"process {rows * CL_GEN / one['decode_s']:.2f} tokens/s);"
                    f" a step {want[0] // steps} sums of "
                    f"{want[1] // steps} B and {want[2] // steps} gathers of "
                    f"{want[3] // steps} B, exact; {sum_s:.3f} s in the sums "
                    f"over {steps} steps; cache {runs[0]['kv_bytes']} B a "
                    f"rank of {one['kv_bytes']} B whole")
            if dtype == "float32":
                diff = max(e[i]["diff"] for e in entries)
                if any(x["tokens"] != one["tokens"][lo:lo + rows]
                       for lo, x in zip(los, runs)):
                    raise AssertionError(f"cl {label} f32 on {dp} x {tp}: "
                                         f"the greedy tokens are not one "
                                         f"process's")
                line += (f"; tokens equal one process's"
                         f"; max |logits - one process's| {diff:.3e} (bound "
                         f"{DECODE_TOL}, logits up to "
                         f"{first['logit_max']:.2f})")
                if not diff <= DECODE_TOL:
                    raise AssertionError(f"cl {label} f32 on {dp} x {tp}: "
                                         f"logits {diff:.3e} from one "
                                         f"process's")
            print(line + f" [{card}]")


def phase_cache_layout(card: str, ranks: list) -> None:
    """Phase 29: the decode caches as ``cache_specs`` lays them out, run by
    phase 23's ranks (``_cl_rank``); holds their reports (``_cl_held``)."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(CL_ARCH), n_layers=WIDE_LAYERS)
    _cl_held(CL_ARCH, cfg, [r["cl"]["a"] for r in ranks], card)
    _cl_held(AUDIO_ARCH, get_config(AUDIO_ARCH),
             [r["cl"]["b"] for r in ranks], card)
    laps = ranks[0]["laps"]
    print(f"decode caches as cache_specs lays them out: the ranks' part "
          f"{sum(v for k, v in laps.items() if k.startswith('(29')):.1f} s "
          f"(rank 0's laps, in phase 23's wall; by part "
          f"{ {k: round(v, 1) for k, v in laps.items() if k[:3] == '(29'} }"
          f"), the checks here {time.perf_counter() - t_phase:.1f} s")


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
    # the device's events as the tracer recorded them (kernels, copies,
    # sets: no operator's row repeats their time), aggregated by name here:
    # ``key_averages`` first builds every event's Python object and tree,
    # seconds for a run of ~50,000 launches
    cuda = [ev for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for ev in cuda:
        row = by_name.setdefault(ev.name(), [0.0, 0])
        row[0] += ev.duration_ns() / 1e3
        row[1] += 1
    rows = sorted(((us, name, count) for name, (us, count) in by_name.items()
                   if us > 0), reverse=True)
    summed = sum(r[0] for r in rows)
    # kernels can overlap (cuDNN issues grouped convolutions as concurrent
    # per-group kernels), so the busy time is the union of their intervals
    spans = sorted((ev.start_ns() / 1e3, ev.end_ns() / 1e3) for ev in cuda)
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
    if sys.argv[1:2] == ["--fsdp-count"]:
        fsdp_count(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--head-count"]:
        head_count(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank(sys.argv[2])
        return 0
    if sys.argv[1:2] and sys.argv[1] in _PART_RANKS:
        part_rank(sys.argv[1], sys.argv[2])
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
        # phases 26 and 27's counts on meta, in processes beside the
        # single-process phases (one core of the host each), after the
        # kernels' timings and done long before phase 23's ranks, whose
        # transfers fold on the host
        meta = start_meta_work()
        ha_meta = start_head_count()
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
        phase = enter("tooling")
        phase_tooling(card)
        phase = enter("mesh of ranks")
        mesh_paths, ranks = phase_mesh(card)
        paths.update(mesh_paths)
        phase = enter("tensor parallelism")
        tp_paths, tp_shapes = phase_tensor_parallel(card, ranks)
        paths.update(tp_paths)
        rows[3]["tp_shapes"] = tp_shapes["flash_attention"]
        rows[4]["tp_shapes"] = tp_shapes["ssd_scan"]
        phase = enter("context parallelism")
        cp_paths, rows[3]["cp_shapes"] = phase_context_parallel(card, ranks)
        paths.update(cp_paths)
        phase = enter("FSDP and production meshes")
        paths.update(phase_fsdp(card, ranks, meta))
        phase = enter("head_axis")
        ha_paths, ha_shapes = phase_head_axis(card, ranks, ha_meta)
        paths.update(ha_paths)
        rows[3]["ha_shapes"] = ha_shapes["flash_attention"]
        rows[4]["ha_shapes"] = ha_shapes["ssd_scan"]
        phase = enter("context parallelism through state")
        cs_paths, cs_shapes = phase_context_state(card, ranks)
        paths.update(cs_paths)
        rows[3]["cs_shapes"] = cs_shapes["flash_attention"]
        rows[4]["cs_shapes"] = cs_shapes["ssd_scan"]
        rows[5]["cs_shapes"] = cs_shapes["slstm_scan"]
        phase = enter("decode caches as cache_specs lays them out")
        phase_cache_layout(card, ranks)
    except Exception:
        traceback.print_exc()
        print(f"FAILED in phase: {phase}", file=sys.stderr)
        return 1
    finally:
        stop_background()
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
