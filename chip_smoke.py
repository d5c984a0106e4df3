#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

(``--only mesh`` builds the kernels and runs phase 7 alone: on a machine
with four cards its ranks talk over NCCL. ``--only attention`` builds them
and runs the flash kernels' holds of phase 1 in float32 and bf16, the
Function's gradients and the flash rows of phase 6 alone; its launches are
those of one bf16 Function forward+backward at granite's shape and of one
float32 forward at the harvest's. ``--only autograd`` builds them and runs
phases 3b and 3c on W1–W4 made from the seed; ``--only sae_tables`` runs
phase 8, ``--only train_mesh`` phase 9, ``--only serve`` phase 10,
``--only moe`` phase 11, ``--only recurrent`` phase 12, ``--only whisper``
phase 13, ``--only launch`` phase 14, ``--only widths`` phase 15,
``--only mesh_families`` phase 16.)

1. builds the fifteen CUDA kernels of the seven sources in
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, started together;
   ``l1ball`` and ``l1ball_cluster`` share ``l1ball.cu``),
   prints each kernel's ptxas lines (registers, shared memory, spills) and
   holds each against its plain PyTorch version on the card: the three
   generated-pipeline projection kernels at the two full-width
   serving shapes, over the design matrix at small ragged sizes, and for
   ``l1ball`` both bodies at 1, 127, 2048 and the one-CTA limit of values,
   each with radii a fraction of Σ|v| (one item inside its ball), just
   under Σ|v| (the most bisection steps), 0, and with a NaN and ±inf in
   v, as a bucket and as one item with its radius by value; the
   flash-attention forward (o and lse) at the harvest's shape
   (4, 32, 2048, 64) f32 causal and on small ragged cases (non-causal,
   windows, GQA, Sq < Sk and Sq > Sk, block-unaligned lengths); then, in
   float32 and bf16 (every kernel on the tensor cores, three TF32 products
   per product for float32: ``flash_fwd_tf32``, ``flash_bwd_dq_tf32``,
   ``flash_bwd_dkv_tf32``), the forward and the two backward kernels
   (``flash_bwd_dq``, ``flash_bwd_dkv``) at granite-3-2b's attention shape,
   q (4, 32, 2048, 64) and k/v (4, 8, 2048, 64) causal, and on the same
   ragged cases, and the ``FlashAttention`` Function's gradients at that
   shape in float32 against autograd of ``attention_naive`` (one launch of
   each float32 kernel, none of the bf16 ones), and each float32 export
   refusing a scratch one float short of its size; and the four
   golden kernels of paper Algorithms 2 and 5 (``colmax``, ``clip``,
   ``trilevel_reduce``, ``trilevel_apply``) in float32 and bf16 at the
   golden workloads' shapes, at ``tests/test_kernels.py``'s shapes and on
   ragged cases with a NaN, +inf and -inf in Y: every output equal to the
   plain version's, NaN in the same places; and the clip stream that
   ``clip`` and ``trilevel_apply`` share (``STREAM_SHAPES``: widths whose
   packs straddle rows, ragged element counts, one-row planes, c = 1),
   each operand aligned or a view one element off its allocation, with a
   NaN, +inf and -inf in Y, u and v2: equal, one launch per call, and the
   stream's kernels at 0 spill bytes;
2. serves full-width requests through ``ProjectionEngine`` — 8 bi-level
   (8192, 2048) and 8 tri-level (256, 32, 2048) f32 requests through
   ``codegen_batch`` buckets of 8, one of each through ``codegen`` — checks
   every answer against the plain schedule executor on the card and for
   feasibility, and reads each kernel's launch count over each path; then
   measures the engine's bucket and per-request latency, synchronous and
   with the dispatcher thread (whose answers must equal the synchronous
   ones);
3. runs the hand-written Algorithm 2 and 5 pipelines
   (``bilevel_l1inf_fused``, ``trilevel_l1infinf_fused``) on four
   workloads: W1 and W2, the server's first bi-level and tri-level request
   with its radius; W3, the paper's Fig. 1 at full size, (1000, 10000)
   uniform(0, 1) from numpy seed 0 at η in (0.25, 0.5, 1, 2, 4); W4, its
   Fig. 3 at full size, (32, 1000, 2000) uniform(0, 1) from numpy seed 2 at
   η = 1. Each fused call, counted alone, launches its three kernels once
   each (colmax/l1ball/clip or trilevel_reduce/l1ball/trilevel_apply) and
   nothing else; its result is held to the generated pipeline
   (``codegen.build(..., method="bisect")``) within 1e-6 (the golden pin)
   and is feasible. On W1 and W3 the exact ℓ1,∞ projection
   (``project_l1inf_exact``) is feasible, no farther from Y than the
   bi-level result (relative 1e-6), equal to the same call on the CPU and,
   with ``method="bisect"``, to Newton within 1e-4. Feasibility is held to
   1e-5 · η + m · 2**-23 · max|Y| (one float32 ulp of the outer threshold
   per summed column, as in phase 2);
3b. takes gradients through the generated pipeline on W1 and W2 (their
   first radius, a tensor that requires grad): through ``codegen.build``,
   through ``make_plan(..., method="codegen", grad=True)`` and through
   ``multilevel_project(..., method="auto")`` (the ``grad=True`` key's
   verdict), each forward counted alone (one launch of each of its three
   kernels where the verdict is ``codegen``), its result carrying a
   ``grad_fn``, its backward (the residual VJP of
   ``kernels/codegen/backward.py``) launching nothing and calling no
   ``schedule.execute``; dY and dη held against autograd through the plain
   schedule (``method="sort"``) on the card, for the cotangent P(Y) − Y and
   for a random one zeroed near the ball's boundaries (see
   ``grad_phase``); the grad forward, the backward alone, the no-grad
   forward and the plain schedule's forward and backward timed (events,
   median of 20), and the ``grad=True`` autotune verdict printed;
3c. calls every kernel without a backward (the four golden kernels, both
   golden pipelines, ``l1ball`` as a bucket and as one vector) on a CUDA
   input that requires grad: each raises and launches nothing;
4. runs the SAE factory at the full width of ``stablelm-1.6b`` (24 layers,
   d_model 2048, 32 heads of 64, seeded init on the card): ``run_factory``
   twice, each harvesting 2 steps of 4 × 2048 tokens at layer 12 (24
   launches of the float32 flash forward per harvest step, all of them the
   3×TF32 tensor-core kernel ``flash_fwd_tf32``, none of the bf16
   ``flash_fwd``) and training with seeds (0, 1) 20 steps of
   4096 rows in microbatches of 1024 — bi-level (encoder (2048, 8192)) and
   head-structured tri-level (``heads=32``, encoder (2048, 32, 256)).
   Losses must be finite and fall, and the projected encoders feasible (max
   violation <= 1e-5 · radius). The bi-level run's layer-12 shard 0 must
   equal the same forward with ``impl="naive"``; each design's first SAE
   step, from the main path's seed-0 init and batch and with live features,
   must equal the same step on the CPU (``hold_sae_step``);
5. trains granite-3-2b on the card. First a held step: full width cut to 4
   layers, float32 compute, the projection on, one step with
   ``impl="flash"`` against the same step with ``impl="naive"`` from the
   same state and batch (the float32 forward twice and each float32
   backward kernel once per layer and microbatch, no bf16 flash kernel),
   then that step timed warm. Then the main path, ``repro_torch.launch.train``
   at full width and depth (40 layers, 2.63 B float32 parameters, bf16
   compute, remat) with ``--batch 8 --microbatch 4 --seq 2048 --steps 3
   --ckpt <dir> --ckpt-every 3`` (one async checkpoint of 31.6 GB: the
   machine's disk takes 45 GiB of writes per call) and a radius of 0.05 of the init's
   smallest per-layer ℓ1,∞ norm of ``w_up``/``w_gate``: every loss finite,
   every projected layer feasible and neither empty nor full of zero
   columns, the launch counts (2 forward launches per layer and microbatch
   under remat, 1 of each backward kernel, none of the float32 ones), the
   last checkpoint restored
   equal to the final state, and the peak device memory;
6. times each kernel at full width (the projection kernels for the bucket
   of 8 and for one item, the golden kernels at their workloads W1–W4) with
   CUDA events (median of 20) beside its bound, its plain version and,
   where one PyTorch call computes the same function, that call (held
   equal to the plain version first; SDPA at granite's shape held to the
   flash kernels' float32 bars, its bf16 distance read); the projection
   and golden kernels also as CUDA-graph replays (one call, and per call
   of a 20-call graph) and by host time per call, beside the library
   call's, and each golden kernel's device kernels per call counted by the
   profiler (``trilevel_reduce``: exactly one); times the
   four golden workloads' pipelines (golden, generated, the plain schedule
   and, on W1 and W3, the exact projection; W3's exact/bi-level time ratio
   at each η), with one golden call's host trace (its host ms under the
   profiler and the CUDA runtime calls it made: a synchronize would show)
   and that of a number copied to the card (``torch.as_tensor``); times
   one warm harvest step and one SAE step with their parts; and one warm
   train step with its parts;
7. the mesh executor at the full width of granite-3-2b. First the partial
   apply (``codegen_partial_apply``, kernel row 9) alone: against its plain
   version at wq's local shard, 40 × (64, 8, 2048), and on eight ragged
   cases (depth 3 and 4, batch 1 and 40, edges off the block, ℓ∞, ℓ2 and
   ℓ1 at level L-2, a NaN, +inf and -inf in Y), then timed there (events,
   CUDA-graph replay, plain version, ``torch.clamp(y, -w, w)``). Then four
   ranks (``torch.multiprocessing``, spawn): NCCL with one rank per card
   when the machine has four, else gloo with all four on the one card
   (collectives through the host, the ranks time-slicing the card). Each
   rank builds granite's full wq (40, 2048, 32, 64) and w_up (40, 2048,
   8192) from the seed, keeps its shard of the ("data", "model") = (1, 4)
   mesh (``param_rules(fsdp=False)``: heads and ffn over "model") and
   projects it through ``make_projection_hook(spec, mesh=, param_specs=)``:
   wq transposed under ν = (ℓ∞, ℓ1, ℓ1) (the partial-apply path: one psum,
   then a 64-step distributed bisection, then row 9), w_up under the
   bi-level ν (the gather path), each at 0.05 of the init's smallest
   per-layer norm. With the codegen body, from zero: per rank and call
   1 ``codegen_reduce``, 1 ``l1ball`` and 1 ``codegen_partial_apply`` (wq)
   or ``codegen_apply`` (w_up), and the collective calls and bytes of
   ``sharded_collective_bytes``; the plain body launches nothing and moves
   the same bytes. Each shard: codegen body against plain body within
   4 · 2^-23 · max v (v the outer aggregate: the two bodies sum v and the
   outer θ-bisection's φ in other orders, so θ lands a few ulps apart, and
   ulp(θ) <= 2^-23 · max v), each body against its slice of the
   single-device generated projection of the whole leaf within
   1e-5 · max|Y|; every layer feasible (the bound
   below) and its share of zero outer groups strictly inside (0, 100) %.
   Times (events, median of 20, every rank in lock-step): one hook call per
   leaf and body, and the distributed bisection alone;
8. runs the §7.3 application at the paper's size
   (``training/sae_tables.tables(full=True)``: synthetic 1000 × 2000 and
   lung-like 1005 × 2944, the sae-paper SAE, 150 full-batch epochs per
   descent, 5 methods): prints the 10 rows with their seconds; the
   baseline's column sparsity is 0, every descent-1 projection of
   ``enc1/w`` feasible (the allowance of phase 3), every masked weight 0
   after descent 2, the bi-level ℓ1,∞ sparsity above 0; then runs the
   synthetic bi-level ℓ1,∞ row on the CPU from the same init: descent-1
   losses within ``SAE_TABLES_LOSS_RTOL`` of the card's, the differing
   mask columns printed. The path launches no kernel (the plain schedule,
   as the JAX hook's jnp one);
9. trains granite-3-2b sharded (``train_mesh_phase``): four ranks
   (``torch.multiprocessing``, spawn; gloo with all four on the one card,
   or NCCL one per card when the machine has four) on a ("data", "model")
   = (2, 2) mesh, tensor parallel over "model" and FSDP over "data", at
   phase 5's batch, microbatch, sequence and radius. First its kernels at
   the shapes this path gives them on each rank, read from the mesh's
   specs (``hold_mesh_train_kernels``: the flash forward, dQ and dK/dV in
   float32 and bf16 at q (2, 16, 2048, 64) and k/v (2, 4, 2048, 64); the
   hook's reduce, l1ball and apply on w_up's shard (L, 1024, 4096) at (a)'s
   and (b)'s depths), against their plain versions with phase 1's bars,
   and their event times. (a) float32 at 2
   layers for 2 steps through ``make_train_step(mesh=, param_specs=)``:
   losses and gradient norms within 1e-4 relative of the single-device
   unfused step run first in this process, the gathered AdamW moments of
   w_up / w_gate within 1e-4 of their largest entry at each step, the
   gathered w_up / w_gate within 1e-4 of their largest entry plus AdamW's
   slack read where the first gradient is within 1e3 eps of 0 (and within
   2 Σ lr everywhere), feasible (phase 5's bound), every copy of a replicated slice bit-identical across ranks (SHA-1 of
   params and moments), collectives per step equal to
   ``training.step.step_collectives``. (b) bf16 through the launcher's CLI
   (``launch.train.run([... "--mesh", "2x2", "--layers", N])``, 4 layers
   on one card (8 before PR 32), 40 on four) for 3 steps: finite losses within 2e-2
   relative of the single-device launcher at the same depth, per rank the
   step ms, tokens/s, peak memory, collectives per step (= the model) and
   launches (flash forward 2 · layers · micro-batches · steps, dQ and dK/dV
   half that; per step 2 each of ``codegen_reduce``, ``l1ball`` and
   ``codegen_apply`` from the mesh-native hook). (c) GSP
   (``gsp_whole_network``'s run, ``sae_factory._gsp``) on a (1, 4) mesh
   against one device, in float32 and in bf16 compute: the same leaves
   projected, both feasible, losses and per-leaf column sparsity within
   ``MESH_GSP_TOL`` (float32 1e-5 and 0.1 point; bf16 1e-4 and 2 points);
   the same sharded run with the psum over "model" of ``collectives.enter``'s
   backward skipped must fall outside those bars. ``--only train_mesh`` builds the kernels and runs phase
   9 alone;
10. serves and trains the rest of the port (``serve_phase``). (a)
   ``launch/serve.py``'s ``run`` at the full width and depth of
   granite-3-2b (seeded float32 params) with ``SERVE_ARGV`` (8 requests,
   128 prompt tokens, 64 new): the last prompt position's decode logits
   (the prompt replayed through ``make_decode_step``) within 5e-3 ·
   max|logits| of the teacher-forced ``forward(impl="chunked")``'s; then
   the ms per decode step (32 steps after the prompt, host clock), tok/s,
   peak memory, the step's byte bound (every weight and the cache read
   once over 3.35 TB/s), and the profiler's device kernels and busy time
   per step, which say whether the step is host- or device-bound. (b) the
   ring cache: h2o-danube-1.8b (window 4096) at full width cut to 2
   layers, one request of 4160 prompt tokens, held the same way. (c)
   ``ProjectionService(method="codegen_batch")`` at the server's two
   shapes: a bad request refused at submit, then 8 requests of each shape
   and one (3000, 1000) bi-level request with ``method="codegen"`` in one
   flush: 3 groups, one pipeline each (``codegen_reduce``, ``l1ball`` and
   ``codegen_apply`` launched 3 times), every result within phase 2's bars
   of the plain projection and feasible. (d) the train launcher at full
   width, 8 layers, 3 steps, phase 5's batch and radius, once plain and
   once with ``--telemetry-every 1 --telemetry-marks``: the registry holds
   ``train_loss`` (the last step's), ``train_grad_norm``, and per projected
   leaf ``train_param_zero_frac`` (inside (0, 1)) and
   ``train_feasibility_gap`` (at most 1e-5), and ``train_epilogue_seconds``
   3 times; the same launches in both runs; an unfused instrumented step's
   ``train_projection_seconds``; with the bridge off a step built with
   ``telemetry_every=1`` makes the aten operation sequence, the launches
   of one built with 0 in each of four profiled rounds (each step from one
   snapshot of the state, restored outside the profiler's window, after
   128 uncounted spin kernels that open it; the order alternating), and
   per device kernel or copy the same largest count over the rounds (the
   profiler leaves out some of the first events of its window, never adds
   one); the warm step time with telemetry on and off. (e)
   ``make_train_step`` at the full width of granite-3-2b cut to 8 layers
   (``INT8_LAYERS``; its full depth before PR 32) for 3 steps of phase 5's
   batch with int8 moments, then with float32 moments
   from the same init: finite losses, feasible projected layers, the
   optimizer state's bytes and each run's peak device memory; after step
   2, the first update from dequantized moments, the int8 run's m and √v
   within per-block bars of the float32 run's that follow from the
   rounding (β1·s1 + s2)/2 and (√β2·s1 + s2)/2, s1 and s2 the block's
   scales after steps 1 and 2, and each leaf's params apart by at most
   INT8_PARAM_BAR of the float32 run's step-2 move;
11. runs the MoE family (``moe_phase``) from freed memory: deepseek-v3-671b
   at full width cut to 4 layers (3 dense MLA layers, then one MoE layer
   of 256 experts, top-8, one shared; seeded float32, 15.11 B parameters).
   (a) ``launch/serve.py``'s ``run`` with ``MOE_SERVE_ARGV`` (8 requests,
   128 prompt tokens, 16 new): tokens in the vocabulary, the ms per decode
   step after the prompt (host clock) beside its byte bound (every weight
   read once, every expert's with the einsum dispatch, the embedding by
   row), tok/s, the profiler's device kernels and busy time per step, the
   peak memory and the latent cache's bytes (576 float32 values a token and
   layer). (b) layer 0's absorbed decode over the prompt's hidden states
   against the full expansion (``_attn_mla``, chunked) at every position,
   within MOE_ABSORB_BAR · max|out|. (c) the einsum and the scatter dispatch
   on 4096 tokens of layer 3 (cap 160): routing and keep equal, outputs
   within MOE_DISPATCH_BAR · max|out|, aux within 1e-5 relative; the
   dropped share there and at decode (batch 8, cap 1); the router's choice
   against the CPU's on the same inputs, shown only. (d) ``run_factory``
   from the same cut model with ``impl="chunked"``: one harvest step of 2 x
   2048 tokens at layer 3, SAEs of d_dict 14336 at d_model 7168 for seeds
   0 and 1, finite losses, feasible encoders, and the LM freed before the
   first SAE step. (e) the train launcher on deepseek-v3's and kimi-k2's
   smoke configs (``MOE_SMOKE_ARGV``: chunked attention, every
   ``w_up``/``w_gate`` projected, 3 steps, the launcher's bf16 compute) on
   the card and on the CPU from one saved init: losses within
   MOE_LOSS_RTOL, gradient norms within MOE_GNORM_RTOL, params within 2 ·
   steps · lr + MOE_PARAM_ATOL of each leaf's largest entry, and the first
   router decision that differs on a near tie (MOE_TIE). No kernel launches in the
   phase (MLA's 192/128-wide heads fit no flash kernel; the trainer
   projects with the plain schedule), and the phase fails if one does;
12. runs the recurrent families (``recurrent_phase``) from freed memory,
   seeded float32 weights. (a) ``launch/serve.py``'s ``run`` with
   ``REC_SERVE_ARGV`` on zamba2-7b at full width and depth (81 layers: 13
   x (5 Mamba2 + the shared attention) + 3; 5.79 B parameters): tokens in
   the vocabulary, the prompt's last decode logits against the
   teacher-forced forward's (``make_prefill``) within SERVE_BAR ·
   max|logits|, the ms per decode step (host clock) beside its byte bound
   (every weight read once, the embedding by row, the recurrent state read
   and written once, the valid KV slots read once), the profiler's device
   kernels and busy time per step, the peak memory. (b) zamba's layer 0
   on REC_SSD_TOKENS tokens (two 128-token chunks): the chunked SSD
   against the token-by-token recurrence within REC_SSD_BAR · max|y|, and
   the dt-gradient through the chunked form finite, beside the largest
   off-triangle exponent 127 · max dt that the mask keeps from ``exp``.
   (c) the train launcher on zamba2-7b at full width, ``--layers 13`` (2
   super-groups + 1 trailing layer, 1.32 B parameters), 3 bf16 steps of 8
   x 2048 tokens with the bi-level constraint on ``(w_up|w_gate|w_in)``:
   finite losses and gradient norms, every projected slice feasible, each
   slice's column sparsity under 100 % and above 0 in some slice of each
   leaf (min, mean and max printed), step seconds and peak memory. (d) the same for xlstm-1.3b: (a)'s readings at full width
   and depth (48 layers, 2.02 B parameters), layer 0's chunkwise mLSTM
   against its sequential form within REC_MLSTM_BAR · max|y|, the sLSTM's
   time loop timed at the training shape, and (c)'s at ``--layers 8`` (7
   mLSTM + 1 sLSTM). (e) the train launcher on both
   archs' smoke configs, 3 bf16 steps with the constraint on, on the card
   and on the CPU from one saved init, within MOE_LOSS_RTOL,
   MOE_GNORM_RTOL and 2 · steps · lr + MOE_PARAM_ATOL (``tests/
   test_torch_train.py``'s bf16 bars). No kernel launches in the phase
   (the shared attention is 112 wide and runs chunked, xLSTM has none,
   and the trainer projects with the plain schedule), and the phase fails
   if one does;
13. runs whisper-large-v3 (``whisper_phase``) from freed memory, seeded
   float32 weights (32 encoder + 32 decoder layers, 1.58 B parameters).
   (a) the flash forward, dQ and dK/dV in bf16 and float32 at its three
   attention shapes with micro-batch 4 (``WHISPER_FLASH``: the encoder's
   non-causal 1500 frames, the cross-attention's 448 queries against 1500
   keys, the decoder's causal 448), held against their plain versions
   with phase 1's bars and timed (events) beside their bounds and
   scaled_dot_product_attention (held to the float32 bars first); the
   flash Function's gradients in float32 and bf16 on keys that share most
   of their value (k̄ + 0.01·ε, the zero audio's regime; dQ sums dS (K −
   k̄)) against float64, each within NAIVE_FACTOR × the naive attention's
   distance or 1e-5 of its largest entry (``whisper_common_keys``: at the
   cross and decoder shapes; with common values too, at the cross shape,
   dq held and dk, dv printed). (b)
   ``launch/serve.py``'s ``run`` with ``WHISPER_SERVE_ARGV`` (8 requests,
   128 prompt tokens, 64 new): tokens in the vocabulary; the prompt's last
   decode logits with the cross cache filled from ``encode`` of the zero
   audio within SERVE_BAR · max|logits| of ``make_prefill``'s, the
   launcher's zero cross cache's distance printed beside them; the ms per
   decode step beside its byte bound (the decoder's weights but the cross
   wk/wv/bv, the unembedding, the whole cross cache and the valid self
   slots), the profiler's kernels and busy ms per step, the peak memory.
   (c) a held float32 step at full width cut to 4 + 4 layers with the
   constraint on, ``impl="flash"`` against ``"naive"`` from one state and
   batch with phase 5's bars: 2 float32 forwards (remat) and one dQ and
   one dK/dV per attention site and micro-batch, no bf16 kernel. (d) the
   train launcher at full width and depth, bf16, remat,
   ``WHISPER_TRAIN_ARGV`` (8 x 448 a step in micro-batches of 4, 3 steps)
   and a radius of 0.05 of the init's smallest per-layer ℓ1,∞ norm of both
   stacks' ``w_up``: finite losses and gradient norms, every slice
   feasible, under 100 % column-sparse and above 0 in some slice of each
   leaf, the step seconds and peak memory, and exactly 2 bf16 forwards and
   one dQ and one dK/dV per attention site (32 + 2 x 32) and micro-batch
   (1152 / 576 / 576), no other kernel. (e) the train launcher on the
   smoke config on the card and on the CPU from one saved init, phase
   12 (e)'s bars.
14. the dry run, the cost model and the tile search (``launch_phase``).
   (a) the measured tile search (``codegen.autotune_tiles``) at W1 (8192 ×
   2048 bi-level) and W2 (256 × 32 × 2048 tri-level), float32: each
   candidate plan's search ms a call and spread (``_TUNE_CALLS`` calls
   between events behind a spin kernel, best of ``_TUNE_REPS``
   interleaved rounds) and, apart, the per-call ms of a
   20-call CUDA-graph replay of its pipeline (median of REPS), its reduce
   and apply held to ``reduce_plain``/``apply_plain`` at phase 1's bars,
   the fastest and the verdict (the heuristic unless beaten by more than
   the spread); the search's launches held to its protocol
   (``tile_search_launches``) and a second ask searching nothing; then
   ``make_plan(method="auto")`` from cleared caches must run the search
   through rows 7 and 8, exactly by that protocol, and again from a cleared
   plan cache none, and its plan, if it is the codegen pipeline, launches
   each kernel once. Phases 7, 9 and 10 hold their tile searches' launches
   to the protocol too, and a second call of the same workload to none.
   (b) the cost model against a real step: granite-3-2b at full width cut
   to LAUNCH_LAYERS layers, phase 5's batch (8 × 2048 in micro-batches of
   4), bf16 compute, ``impl="flash"``, the constraint on: the walk
   (``roofline/costs.py``) of one warm step on the card equals the walk of
   the same step on ``meta`` in FLOPs, bytes and the flash kernels'
   declared costs; the step (CUDA events, median of 3 warm steps) takes at
   least the roofline's largest term (``roofline/analysis.py``, one H100)
   — the ratio is printed —; the meta walk's memory (arguments + peak) is
   within 0.5–2× of ``torch.cuda.max_memory_allocated`` over a step.
   (c) ``python -m repro_torch.launch.dryrun --shape all`` for every
   assigned arch on both production meshes (three processes a mesh, each
   with a third of the archs, ``LAUNCH_ARCH_GROUPS``; no card visible:
   ``CUDA_VISIBLE_DEVICES`` empty) and ``roofline.report`` on the records:
   the counts of ok, skip and error, no error but the int8 moments'
   refusal of the MoE archs' train cells (``LAUNCH_REFUSED``): every other
   cell walks its family's sharded forward, the MoE pair's prefill and
   decode cells included. (d) ``launch.hillclimb`` on every variant the
   port's step takes (stablelm_*, sae_factory*, xlstm_*; two processes;
   the kimi_* and deepseek_* variants are train cells with int8 moments),
   each delta of its baseline's dominant term printed. (c) and (d) run in
   the background: in a whole run from the script's start at the lowest
   CPU priority (``nice -n 19``) beside phases 1–13, under ``--only
   launch`` while (a) and (b) hold the card.
15. every head width up to 128, danube and zamba on their flash paths,
   the long ℓ1 solve and the golden pipelines in bf16 (``widths_phase``;
   ``--only widths`` runs it alone). (a) the six flash kernels at head
   dims 8, 24, 48, 80, 96 and 112 (the kernels of the next instantiated
   width up, the columns past the true one read as 0) on phase 1's
   ragged cases (GQA, block-unaligned, non-causal, windows, Sq < Sk,
   Sq > Sk) in float32 and bf16 at phase 1's bars; then at
   h2o-danube-1.8b's q (4, 32, 2048, 80), k/v (4, 8, 2048, 80) causal
   with its window of 4096, at (1, 32, 6144, 80) / (1, 8, 6144, 80)
   where that window bites, and at zamba2-7b's shared attention (4, 32,
   2048, 112): held, timed beside the bound at the true head dim, the
   plain version and one scaled_dot_product_attention call (with the
   window's mask where it bites); the ``FlashAttention`` Function's
   float32 gradients at danube's shape against autograd of
   ``attention_naive``. (b) the train launcher on h2o-danube-1.8b at
   full width and depth through its default ``--attn flash``, bf16,
   ``DANUBE_TRAIN_ARGV`` (8 × 2048 in micro-batches of 4, 3 steps):
   finite losses, a feasible constraint, exactly 2 bf16 forwards and one
   dQ and one dK/dV per layer and micro-batch (288 / 144 / 144), no
   float32 flash, the peak memory; then one harvest step of the SAE
   factory's launcher on danube at full width and depth (``--full
   --layers 12 --harvest-steps 1 --train-steps 1``): exit 0 through the
   flash kernels. (c) ``zamba.forward(impl="flash")`` on zamba2-7b at
   full width cut to two super-blocks (12 layers) on 1 × 2048 seeded
   tokens against ``impl="chunked"`` on the card: logits within 1e-4 of
   their largest, one float32 forward launch per shared-attention
   application. (d) ``l1ball_cluster`` (a thread block cluster per item)
   in both methods at 51,201, 100,352, 262,144 and 524,288 values,
   float32 and bf16, on phase 1's radii and NaN/±inf cases, as a bucket
   of 8 and as one item with its radius by value, against
   ``project_l1_plain`` on the card (phase 1's bars; bf16 within one
   bf16 rounding), two launches a pair of calls; timed (bisect) beside
   the plain version and the PyTorch-ops solve ``ref.project_l1_ref``;
   ``outer_l1_solve`` at 524,289 values launches nothing. (e) the golden
   Algorithm 2 and 5 pipelines on W1–W4 and W5 ((2048, 100352) uniform
   from a numpy seed: stablelm-1.6b's embedding, one column per token, the
   ℓ1 over its vocabulary, through ``l1ball_cluster``) in float32 and
   bf16: each fused call its three kernels once; float32 equal to the
   generated pipeline (1e-6), bf16 to the plain bf16 chain on the card
   and to the float32 pipeline on its values with the radius rounded to
   bf16 (both within one bf16 rounding), both feasible (bf16 within
   bf16(η) · (1 + 2^-8), each column's radius rounded half an ulp, plus
   phase 3's slack); each pipeline timed in both types.
16. the audio, hybrid, recurrent and MoE families trained under a mesh
   (``mesh_families_phase``; ``--only mesh_families`` runs it alone):
   whisper-large-v3 (2 + 2 layers), zamba2-7b (7 layers: five Mamba
   layers, one shared-attention site, one trailing Mamba layer),
   xlstm-1.3b (8 layers: seven mLSTM, one sLSTM) and deepseek-v3-671b
   (every published width and its vocabulary; 2 layers, one leading dense
   MLA layer and one MoE layer of 16 routed experts, top-8 and the shared
   expert: a chip's share of 256 experts under 64-way expert parallelism,
   ``MF_MOE_CUT``) at full width, 2 sequences a step (448, 1024, 256 and
   512 tokens) in one micro-batch, the constraint on (w_up|w_gate|w_in) at
   0.05 of the init's smallest slice norm. The flash kernels at the ranks'
   local heads (whisper's 64-wide encoder, decoder and cross sites, zamba's
   112-wide shared attention) in float32 and bf16 and the hook's reduce,
   l1ball and apply on each family's largest constrained shard (deepseek's
   expert shard), held against their plain versions; then four ranks
   (phase 9's transport): (a) one float32 step on the (2, 2) and (1, 4)
   meshes against the same step on one device (deepseek's dispatch in
   ``dp_shards`` token groups on both), loss and gradient norm within 1e-5
   relative (deepseek's router gradient too), the parameters' replicated
   copies bit-identical across ranks, each rank's collectives =
   ``step_collectives``, per rank the flash and hook launches by kernel
   (no flash launch for MLA) and the body the hook gave each constrained
   leaf (the dense, shared and expert leaves; every one the generated
   kernels', none the plain body); (b) each family's train launcher under
   ``--mesh 2x2``, 2 bf16 steps (kimi-k2-1t-a32b's smoke config too):
   finite losses the same on every rank, collectives = the model, a
   feasible constraint, flash and hook launches on every rank, peak
   memory per rank.

The widths are the SAE factory's on stablelm-1.6b: d_model 2048, d_dict
4 x 2048 = 8192, 32 heads; the projected tensor is the transposed encoder.
Projection tolerance: |a - b| <= 1e-5 * max|Y| + 1e-5 * |b| (64-step
float32 bisection and another summation order move θ by a few ulps); the
same for the exact ℓ1,∞ projection on the card against the CPU (float32
sorts and prefix sums in another order). Golden kernels: exact in float32
and bf16 (maxima and clips do not round). Flash
tolerance: o within 2e-5 + 1e-5 |b| (the JAX package's own f32 oracle
tests use 2e-5), lse within 1e-5 + 1e-5 |b|. Harvest tolerance: 1e-5 of
the largest activation + 1e-5 |b|. Flash backward tolerance: float32 dq/dk/dv within 1e-5 of
the tensor's largest entry + 1e-5 |b| (sums over up to 8192 rows in another
order); bf16 operands (forward o and the gradients) within 2**-7 |b| (one
bf16 rounding of a float32 result that the two versions compute in another
order) + 1e-5 of the largest entry. The Function's float32 gradients
against autograd of the naive attention: 1e-5 of the largest entry + 1e-5
|b|. Held train step: loss and gradient norm within 1e-5 |b|, the first
moments (the clipped gradients) within 1e-5 of the leaf's largest entry +
1e-5 |b|, the parameters as well plus AdamW's own sensitivity to those
differences (``hold_train_step``). Float32
matmuls run in full float32: TF32 is switched off for cuBLAS and cuDNN
before anything runs. Any failure
exits non-zero without the final line. Without a CUDA device, or outside a
checkout, it exits 2 and prints no result.

Output: one line per check, then a JSON line ``{"kernels": [...]}``, the
``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import gc
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
TF32_OPS_PER_S = 494.7e12     # H100 SXM TF32 tensor cores, dense
RTOL = 1e-5
INF = float("inf")            # torch.linalg.vector_norm's ℓ∞ order
BF16_RTOL = 2.0 ** -7         # one bf16 rounding
REPS = 20
SEED = 0

BILEVEL = (("inf", 1), ("1", 1))
TRILEVEL = (("inf", 1), ("inf", 1), ("1", 1))
FULL = {  # the two requests the server sees, per workload
    "bilevel": ((8192, 2048), BILEVEL),
    "trilevel": ((256, 32, 2048), TRILEVEL),
}
BUCKET = 8
# the flash kernels of each type, counted apart (kernels/flash_attention.py)
BF16_FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
F32_FLASH = ("flash_fwd_tf32", "flash_bwd_dq_tf32", "flash_bwd_dkv_tf32")
SERVER_KERNELS = ("codegen_reduce", "l1ball", "codegen_apply")  # the server's path

# tests/test_codegen.py DESIGNS + EXTRA_DESIGNS, then the port's own
DESIGNS = [
    ("l1inf_cols", (32, 64), BILEVEL),
    ("l1inf_rows", (32, 64), BILEVEL),
    ("l1infinf_last", (4, 16, 64), TRILEVEL),
    ("l1infinf_mid", (4, 16, 64), TRILEVEL),
    ("l12_rows", (32, 48), (("2", 1), ("1", 1))),
    ("l11_rows", (32, 48), (("1", 1), ("1", 1))),
    ("flat_l1", (16, 24), (("1", 2),)),
    ("l1inf_uneven", (32, 60), BILEVEL),
    ("l11_uneven", (30, 48), (("1", 1), ("1", 1))),
    ("l111", (3, 10, 20), (("1", 1), ("1", 1), ("1", 1))),
    ("rank4_mixed", (3, 4, 5, 32), (("inf", 1), ("2", 1), ("1", 1), ("1", 1))),
    ("rank4_l2pair", (2, 3, 4, 40), (("2", 2), ("inf", 1), ("1", 1))),
    ("outer_l2", (8, 16), (("inf", 1), ("2", 1))),
    ("outer_inf", (8, 16), (("1", 1), ("inf", 1))),
    ("wide_groups", (6, 200), (("1", 1), ("1", 1))),
    # the port's own: the lead-split apply at depth 4 (LEAD 2) and with a
    # ragged m (vec 1) (tests/test_torch_apply_split.py SPLIT_DESIGNS)
    ("rank4_linf", (3, 4, 5, 32), (("inf", 1), ("2", 1), ("inf", 1), ("1", 1))),
    ("rank4_l2lead", (2, 3, 7, 33), (("2", 1), ("inf", 1), ("2", 1), ("1", 1))),
    ("trilevel_ragged", (4, 16, 61), TRILEVEL),
    ("trilevel_l2", (5, 9, 44), (("2", 1), ("inf", 1), ("1", 1))),
    # the reduce's other geometries (tests/test_torch_reduce_split.py
    # REDUCE_DESIGNS): rows cut into chunks folded by reduce_finalize (few,
    # long columns), and slice lanes under one lead axis, vec 1 and 4
    ("l1inf_tall", (4096, 32), BILEVEL),
    ("trilevel_tall", (3, 2000, 20), TRILEVEL),
    ("trilevel_deep", (64, 5, 61), TRILEVEL),
    ("trilevel_deep_l2", (48, 3, 64), (("2", 1), ("inf", 1), ("1", 1))),
]

REPLACES = {  # (kernel, batched) -> the TPU kernel's pallas_call site
    ("codegen_reduce", True): "src/repro/kernels/codegen/lowering.py:512",
    ("codegen_reduce", False): "src/repro/kernels/codegen/lowering.py:183",
    ("codegen_apply", True): "src/repro/kernels/codegen/lowering.py:548",
    ("codegen_apply", False): "src/repro/kernels/codegen/lowering.py:270",
    ("l1ball", True): "src/repro/kernels/l1ball.py:154",
    ("l1ball", False): "src/repro/kernels/l1ball.py:122",
    ("flash_fwd", False): "src/repro/kernels/flash_attention.py:132",
    ("flash_fwd_tf32", False): "src/repro/kernels/flash_attention.py:132",
    ("flash_bwd_dq", False): "src/repro/kernels/flash_attention.py:302",
    ("flash_bwd_dkv", False): "src/repro/kernels/flash_attention.py:325",
    ("flash_bwd_dq_tf32", False): "src/repro/kernels/flash_attention.py:302",
    ("flash_bwd_dkv_tf32", False): "src/repro/kernels/flash_attention.py:325",
    ("colmax", False): "src/repro/kernels/bilevel_l1inf.py:82",
    ("clip", False): "src/repro/kernels/bilevel_l1inf.py:103",
    ("trilevel_reduce", False): "src/repro/kernels/trilevel_l1infinf.py:70",
    ("trilevel_apply", False): "src/repro/kernels/trilevel_l1infinf.py:98",
    ("codegen_partial_apply", False): "src/repro/kernels/codegen/lowering.py:309",
}

# flash forward: (q shape, kv shape, causal, window). The harvest's own shape
# at full width, then tests/test_kernels.py's flash cases plus the corners
# of the TPU kernel (rows no key reaches, ragged tails, head dims 16/32/128)
FLASH_FULL = ((4, 32, 2048, 64), (4, 32, 2048, 64), True, None)
FLASH_CASES = [
    ((1, 1, 128, 64), (1, 1, 128, 64), True, None),
    ((2, 4, 256, 64), (2, 2, 256, 64), True, None),
    ((1, 8, 384, 128), (1, 1, 384, 128), True, None),
    ((1, 8, 384, 64), (1, 2, 384, 64), True, None),      # GQA group 4
    ((2, 2, 257, 64), (2, 2, 257, 64), True, None),      # block-unaligned
    ((1, 2, 256, 64), (1, 2, 256, 64), False, None),     # non-causal
    ((1, 2, 384, 64), (1, 2, 384, 64), True, 32),        # windows
    ((1, 2, 384, 64), (1, 2, 384, 64), True, 128),
    ((1, 2, 384, 64), (1, 2, 384, 64), True, 1000),
    ((1, 2, 128, 64), (1, 2, 512, 64), False, None),     # cross, Sq < Sk
    ((1, 2, 100, 64), (1, 2, 300, 64), True, None),      # right-aligned q
    ((1, 2, 200, 64), (1, 2, 333, 64), False, 40),
    ((1, 2, 300, 64), (1, 2, 100, 64), True, None),      # Sq > Sk
    ((1, 2, 300, 64), (1, 2, 130, 64), True, 50),
    ((2, 4, 40, 16), (2, 4, 40, 16), True, None),        # the smoke LM's heads
    ((1, 4, 70, 32), (1, 2, 70, 32), True, 16),
]

# granite-3-2b's attention (configs/registry.py: 32 q heads over 8 kv heads
# of 64) at the training shape: microbatch 4 x 2048 tokens, causal
GRANITE_ATTN = ((4, 32, 2048, 64), (4, 8, 2048, 64), True, None)

# LM training (phase 5): launch/train.py's CLI at full width and depth
TRAIN_ARCH = "granite-3-2b"
# one checkpoint (the async save at the last step): the full state is
# 31.6 GB and the chip machine's disk takes 45 GiB of writes per call
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--batch", "8", "--microbatch", "4",
              "--seq", "2048", "--steps", "3", "--ckpt-every", "3"]
RADIUS_FRACTION = 0.05        # of the init's smallest per-layer l1,inf norm
HELD_LAYERS = 4

# the SAE factory at the full width of stablelm-1.6b (configs/registry.py)
FACTORY = dict(arch="stablelm-1.6b", smoke=False, layers=(12,),
               harvest_steps=2, seq_len=2048, lm_batch=4, train_steps=20,
               sae_batch=4096, microbatch=1024)
FACTORY_SEEDS = (0, 1)

# the golden kernels of paper Algorithms 2 and 5 (kernels/bilevel_l1inf.py,
# kernels/trilevel_l1infinf.py)
GOLDEN = {  # kernel -> its source in src/repro_torch/csrc
    "colmax": "bilevel_l1inf.cu",
    "clip": "bilevel_l1inf.cu",
    "trilevel_reduce": "trilevel_l1infinf.cu",
    "trilevel_apply": "trilevel_l1infinf.cu",
}
# phase 3's workloads beyond the server's two requests (W1, W2): the
# paper's Fig. 1 and Fig. 3 at full size (benchmarks/projections.py:37-74),
# uniform(0, 1) from a numpy seed: (shape, seed, radii)
FIG1 = ((1000, 10000), 0, (0.25, 0.5, 1.0, 2.0, 4.0))
FIG3 = ((32, 1000, 2000), 2, (1.0,))
# phase 1's extra shapes: tests/test_kernels.py's (colmax, clip; the
# tri-level classes) and a ragged case that gets a NaN, +inf and -inf
GOLDEN_SHAPES = {
    "bilevel": [(8, 128), (256, 512), (300, 700), (1024, 257), (7, 1000),
                (1, 128), (250, 333), (1024, 512), (37, 1001)],
    "trilevel": [(2, 8, 128), (3, 17, 130), (8, 250, 64), (1, 64, 257),
                 (4, 300, 700), (3, 9, 1001)],
}
# phase 1's cases of the clip stream (csrc/golden.cuh: stream_clip) that
# ``clip`` and ``trilevel_apply`` share: row widths that are no multiple of
# a pack (packs straddle rows; m = 7 is narrower than a bf16 pack), planes
# of a ragged element count (no multiple of a pack or of a round), one-row
# planes, c = 1, and planes of n · m % 8 ≠ 0 (one element per load)
STREAM_SHAPES = {
    "bilevel": [(37, 1001), (3, 2001), (5, 7), (1, 9), (64, 257)],
    "trilevel": [(3, 8, 1001), (2, 16, 257), (1, 5, 7), (4, 3, 2001),
                 (2, 1, 9)],
}


class SmokeFailure(RuntimeError):
    pass


def check_close(what, got, want, scale, rtol=RTOL, nonfinite=False):
    """Max abs error of ``got`` against ``want``; raises past
    1e-5 · scale + rtol · |want|. ``got`` must be finite, or with
    ``nonfinite`` (inputs with NaN and ±inf) hold NaN where ``want`` does
    and the same infinities; the error is then over the entries finite in
    both."""
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise SmokeFailure(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if nonfinite:
        if not torch.equal(got.isnan(), want.isnan()):
            raise SmokeFailure(f"{what}: NaN in other places")
        fin = got.isfinite() & want.isfinite()
        if not torch.equal(got[~fin & ~got.isnan()], want[~fin & ~want.isnan()]):
            raise SmokeFailure(f"{what}: infinities differ")
        got, want = got[fin], want[fin]
    elif not bool(torch.isfinite(got).all()):
        raise SmokeFailure(f"{what}: non-finite values")
    err = (got - want).abs()
    bad = err > 1e-5 * scale + rtol * want.abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if bool(bad.any()):
        raise SmokeFailure(f"{what}: max abs err {max_err:.3e} past tolerance "
                           f"(scale {scale:.3e})")
    return max_err


def check_exact(what, got, want):
    """``got`` must equal ``want``: same shape and type, NaN in the same
    places, every other entry equal (±inf included). Returns the max abs
    error over the entries finite in both (0)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise SmokeFailure(f"{what}: {tuple(got.shape)} {got.dtype} != "
                           f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not torch.equal(g.isnan(), w.isnan()):
        raise SmokeFailure(f"{what}: NaN in other places")
    finite = g.isfinite() & w.isfinite()
    err = float((g - w)[finite].abs().max()) if bool(finite.any()) else 0.0
    if bool(((g != w) & ~g.isnan()).any()):
        raise SmokeFailure(f"{what}: not equal (max abs err {err:.3e})")
    return err


def event_ms(fn, reps=REPS):
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events,
    after two warm-up runs."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, reps=REPS, calls=1):
    """Median milliseconds of one replay of ``fn`` captured in a CUDA graph:
    the device's time for its launches with no host work (wrapper checks,
    allocations, ``ctypes`` calls) inside the event window. With ``calls``
    > 1 the graph holds that many calls back to back and the time is per
    call: the graph's own launch latency, a floor of 15–25 µs on an H100
    (a graph of one ``zero_``), is spread over them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm up off the capture, as torch.cuda.graph asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = event_ms(graph.replay, reps) / calls
    del graph
    return ms


def tile_search_mark():
    """The ordinal of the last tile search so far (``codegen.autotune_tiles``),
    for :func:`tile_search_launches`."""
    from repro_torch.kernels import codegen

    return max((e["search"] for e in codegen.tile_search_log().values()),
               default=0)


def tile_search_launches(mark):
    """The launches that the tile searches logged after ``mark`` made, by
    the search's own protocol: each candidate's ``_TUNE_WARM`` warm-up calls
    and ``_TUNE_REPS`` rounds of ``_TUNE_CALLS`` timed calls, through the
    reduce, the apply and, for an ℓ1 outer solve, ``l1ball``. A phase holds
    ``search_counts`` to it exactly: a cache that searched again would
    double it."""
    from repro_torch.kernels import codegen

    per = codegen._TUNE_WARM + codegen._TUNE_REPS * codegen._TUNE_CALLS
    want = {}
    for key, entry in codegen.tile_search_log().items():
        if entry["search"] <= mark:
            continue
        kernels = ("codegen_reduce", "codegen_apply") \
            + (("l1ball",) if key[1][-1][0] == "1" else ())
        for k in kernels:
            want[k] = want.get(k, 0) + per * len(entry["plans"])
    return want


def check_search(what, mark):
    """``search_counts`` (the nonzero ones) must equal
    :func:`tile_search_launches` since ``mark``; returns them."""
    from repro_torch.kernels import _build

    got = {k: n for k, n in _build.search_counts().items() if n}
    want = tile_search_launches(mark)
    if got != want:
        raise SmokeFailure(f"{what}: tile search launches {got} != {want}, "
                           "one search per new workload")
    return got


def host_ms(fn, reps=5):
    """Median milliseconds of ``fn()`` on the host clock, each run ended by a
    device synchronize, after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def host_call_ms(fn, calls=200):
    """Milliseconds of host time per call of ``fn()``, over ``calls`` calls
    enqueued back to back with no synchronize between them: the wrapper's
    host work and the launch, which the event window of a lone call counts
    while the device waits."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def bound_ms(nbytes, nops, ops_per_s=F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fmax(t):
    """The largest finite |t| (a tolerance's scale)."""
    a = t.abs()
    return float(a[a.isfinite()].max())


# phase 1's l1ball cases: radii a random fraction of Σ|v| with one item
# inside its ball; r just under Σ|v| (θ far below max|v|: the most
# bisection steps); r = 0; a NaN; a +inf and a -inf
L1_CASES = ("fraction", "just_under", "zero", "nan", "inf")


def l1ball_case(randn, rand, n, case, items=4):
    """``items`` (at least 3) vectors of ``n`` values and their radii for
    one of L1_CASES; the non-finite values go into items 0 and 1, the last
    item stays finite."""
    import torch

    v = randn((items, n))
    s = v.abs().sum(1)
    if case == "just_under":
        radii = s * (1 - 1e-6)
    elif case == "zero":
        radii = torch.zeros_like(s)
    else:
        radii = rand((items,)) * s
    if case == "fraction":
        radii[0] = s[0] * 2       # one item inside its ball
    elif case == "nan":
        v[0, n // 2] = float("nan")
        v[1, 0] = float("nan")
    elif case == "inf":
        v[0, n // 3] = INF
        v[1, n - 1] = -INF
    return v, radii


def hold_pipeline(randn, rand, tag, shape, levels, batch, nonfinite=False):
    """Phase 1: each kernel of one design against its plain version on
    ``batch`` items from ``randn``; returns the max errors per kernel and
    the inputs. ``nonfinite`` puts a NaN, +inf and -inf in item 0 and a
    +inf and -inf in item 1 of Y, and each kernel must then hold NaN and
    ±inf where its plain version does."""
    import torch

    from repro_torch.core import schedule
    from repro_torch.kernels import l1ball
    from repro_torch.kernels.codegen import lowering, tiling

    sched = schedule.compile_schedule(shape, levels)
    tp = tiling.plan_tiles(sched, torch.float32)
    if tp is None:
        raise SmokeFailure(f"{tag}: the tiler rejects {levels} on {shape}")
    norms = [q for q, _ in sched.levels]
    yc = randn((batch,) + tp.canon_shape)
    if nonfinite:
        size = yc[0].numel()
        yc[0].view(-1)[[5 % size, (7 * tp.m + 3) % size, size - 2]] = \
            torch.tensor([float("nan"), INF, -INF], device=yc.device)
        yc[1].view(-1)[[size // 2, size - 1]] = torch.tensor(
            [INF, -INF], device=yc.device)
    scale = fmax(yc)
    errs = {}

    def hold(what, got, want, scale_):
        return check_close(f"{tag} {what}", got, want, scale_,
                           nonfinite=nonfinite)

    if len(norms) == 1:
        radii = rand((batch,)) * torch.nan_to_num(
            yc.abs(), nan=0.0, posinf=0.0).flatten(1).sum(1)
        got = l1ball.project_l1_batched(yc, radii)
        torch.cuda.synchronize()
        errs["l1ball"] = hold("l1ball", got,
                              l1ball.project_l1_plain(yc, radii), scale)
        return errs, None
    aggs, vfin = lowering.codegen_reduce(yc, tp, norms[:-1])
    torch.cuda.synchronize()
    aggs_p, vfin_p = lowering.reduce_plain(yc, norms[:-1])
    # aggregates are held to their own magnitude
    err = hold("reduce vfin", vfin, vfin_p, fmax(vfin_p))
    for t, (a, ap) in enumerate(zip(aggs, aggs_p)):
        err = max(err, hold(f"reduce v{t + 1}", a, ap, fmax(ap)))
    errs["codegen_reduce"] = err
    fin = torch.nan_to_num(vfin_p, nan=0.0, posinf=0.0)
    outer = {"1": fin.sum(1), "2": fin.norm(dim=1),
             "inf": fin.amax(1)}[norms[-1]]
    radii = (0.05 + 0.9 * rand((batch,))) * outer
    if norms[-1] == "1":
        u = l1ball.project_l1_batched(vfin_p, radii)
        torch.cuda.synchronize()
        u_p = l1ball.project_l1_plain(vfin_p, radii)
        errs["l1ball"] = hold("l1ball", u, u_p, fmax(vfin_p))
    else:
        u_p = lowering._solve_outer_batched(vfin_p, norms[-1], radii, "bisect")
    x = lowering.codegen_apply(yc, aggs_p, vfin_p, u_p, tp, norms[:-1])
    torch.cuda.synchronize()
    x_p = lowering.apply_plain(yc, aggs_p, vfin_p, u_p, norms[:-1])
    errs["codegen_apply"] = hold("apply", x, x_p, scale)
    return errs, (yc, tp, norms, aggs_p, vfin_p, u_p, radii)


def hold_golden_kernels(randn, rand):
    """Phase 1's golden kernels: ``colmax``, ``clip``, ``trilevel_reduce``
    and ``trilevel_apply`` against their plain versions in float32 and
    bf16, at the golden workloads' full-width shapes, at GOLDEN_SHAPES, and
    on the ragged cases with a NaN, +inf and -inf in Y; every output must
    equal. The radii are a random fraction of each column's maximum, in
    float32 (the wrappers round them to Y's type), so the NaN and +inf
    columns carry a NaN and an inf radius. Returns the max error of each
    kernel and the number of cases."""
    import torch

    from repro_torch.kernels import bilevel_l1inf as bi, trilevel_l1infinf as tri

    shapes = {"bilevel": [FULL["bilevel"][0], FIG1[0]] + GOLDEN_SHAPES["bilevel"],
              "trilevel": [FULL["trilevel"][0], FIG3[0]]
              + GOLDEN_SHAPES["trilevel"]}
    errs, cases = dict.fromkeys(GOLDEN, 0.0), 0
    for dtype in (torch.float32, torch.bfloat16):
        for design, design_shapes in shapes.items():
            for shape in design_shapes:
                y = randn(shape, 3.0).to(dtype)
                if shape == design_shapes[-1]:   # the ragged case
                    flat = y.view(-1)
                    flat[5], flat[7 * shape[-1] + 3], flat[-2] = (
                        float("nan"), float("inf"), -float("inf"))
                tag = f"golden {str(dtype)[6:]} {shape}"
                m = shape[-1]
                if design == "bilevel":
                    got = {"colmax": bi.colmax(y)}
                    want = {"colmax": bi.colmax_plain(y)}
                    u = want["colmax"].float() * (0.2 + 0.6 * rand((m,)))
                    got["clip"], want["clip"] = bi.clip(y, u), bi.clip_plain(y, u)
                else:
                    v2, v1 = tri.trilevel_reduce(y)
                    p2, p1 = tri.trilevel_reduce_plain(y)
                    u1 = p1.float() * (0.2 + 0.6 * rand((m,)))
                    got = {"trilevel_reduce": (v2, v1),
                           "trilevel_apply": tri.trilevel_apply(y, p2, u1)}
                    want = {"trilevel_reduce": (p2, p1),
                            "trilevel_apply": tri.trilevel_apply_plain(y, p2, u1)}
                torch.cuda.synchronize()
                for name in got:
                    pairs = zip(got[name], want[name]) \
                        if name == "trilevel_reduce" else [(got[name], want[name])]
                    for a, b in pairs:
                        errs[name] = max(errs[name],
                                         check_exact(f"{tag} {name}", a, b))
                cases += 1
    stream = hold_stream_kernels(randn, rand)
    for name, err in stream["errs"].items():
        errs[name] = max(errs[name], err)
    print(f"golden kernels vs plain versions, float32 and bf16, {cases} "
          "cases (full width, tests/test_kernels.py shapes, NaN/±inf) and "
          f"{stream['cases']} of the clip stream: all equal; "
          + ", ".join(f"{k} max_abs_err {v:.3e}" for k, v in errs.items()))
    return errs


def hold_stream_kernels(randn, rand):
    """Phase 1's cases of the clip stream: ``clip`` and ``trilevel_apply``
    at STREAM_SHAPES in float32 and bf16, each with every operand either
    16-byte aligned or a view one element past its allocation (so the
    kernel takes one element per load), and with a NaN, +inf and -inf in
    Y, in u (u1, in Y's type) and in v2; every output must equal the plain
    version's, and each call launch its kernel once."""
    import torch

    from repro_torch.kernels import bilevel_l1inf as bi, trilevel_l1infinf as tri

    def operand(t, offset):
        """``t``'s values in a fresh tensor ``offset`` elements past the
        start of its allocation."""
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
        out = buf[offset:].view(t.shape)
        out.copy_(t)
        return out

    def nonfinite(t):
        flat = t.view(-1)
        for k, v in zip((0, flat.numel() // 2, flat.numel() - 1),
                        (float("nan"), INF, -INF)):
            flat[k] = v
        return t

    errs, cases = {"clip": 0.0, "trilevel_apply": 0.0}, 0
    for dtype in (torch.float32, torch.bfloat16):
        for design, shapes in STREAM_SHAPES.items():
            for shape in shapes:
                m = shape[-1]
                y0 = nonfinite(randn(shape, 3.0).to(dtype))
                u0 = nonfinite((rand((m,)) * 3.0).to(dtype))
                v20 = nonfinite(y0.abs().amax(0)) if design == "trilevel" else None
                for offset in (0, 1):
                    y, u = operand(y0, offset), operand(u0, offset)
                    tag = f"stream {str(dtype)[6:]} {shape} offset {offset}"
                    if design == "bilevel":
                        name, kern = "clip", bi.CLIP
                        before = kern.launches
                        got, want = bi.clip(y, u), bi.clip_plain(y, u)
                    else:
                        name, kern = "trilevel_apply", tri.APPLY
                        v2 = operand(v20, offset)
                        before = kern.launches
                        got = tri.trilevel_apply(y, v2, u)
                        want = tri.trilevel_apply_plain(y, v2, u)
                    torch.cuda.synchronize()
                    if kern.launches != before + 1:
                        raise SmokeFailure(f"{tag} {name}: "
                                           f"{kern.launches - before} launches")
                    errs[name] = max(errs[name],
                                     check_exact(f"{tag} {name}", got, want))
                    cases += 1
    return {"errs": errs, "cases": cases}


def golden_workloads(server_reqs):
    """W1–W4 of phase 3: ``{name: (design, y, radii)}`` on the card."""
    import numpy as np
    import torch

    wls = {"W1": ("bilevel", *server_reqs["bilevel"]),
           "W2": ("trilevel", *server_reqs["trilevel"])}
    for name, design, (shape, seed, radii) in (("W3", "bilevel", FIG1),
                                                ("W4", "trilevel", FIG3)):
        y = np.random.default_rng(seed).uniform(0.0, 1.0, shape)
        wls[name] = (design, torch.from_numpy(y.astype(np.float32)).cuda(),
                     radii)
    return wls


def golden_phase(wls):
    """Phase 3: the hand-written Algorithm 2 and 5 pipelines on W1–W4 (see
    the module docstring). Each fused call runs in a counting window of its
    own. Returns per workload its launch counts (summed over its radii),
    the golden pin's largest difference and the exact projection's
    checks."""
    import torch

    from repro_torch.core import exact_l1inf, multilevel
    from repro_torch.kernels import (_build, bilevel_l1inf as bi, codegen,
                                     trilevel_l1infinf as tri)

    fused = {"bilevel": bi.bilevel_l1inf_fused,
             "trilevel": tri.trilevel_l1infinf_fused}
    levels = {"bilevel": BILEVEL, "trilevel": TRILEVEL}
    per_call = {"bilevel": {"colmax": 1, "l1ball": 1, "clip": 1},
                "trilevel": {"trilevel_reduce": 1, "l1ball": 1,
                             "trilevel_apply": 1}}
    out = {}
    for wl, (design, y, radii) in wls.items():
        lv = levels[design]
        generated = codegen.build(y.shape, lv, torch.float32, method="bisect")
        scale, m = float(y.abs().max()), y.shape[-1]
        counts, recs = {}, []
        for eta in radii:
            _build.reset_launches()
            x = fused[design](y, eta)
            torch.cuda.synchronize()
            got = _build.launch_counts()
            want = {k: per_call[design].get(k, 0) for k in got}
            if got != want:
                raise SmokeFailure(f"{wl} η={eta}: launches {got}, not {want}")
            for k, n in got.items():
                counts[k] = counts.get(k, 0) + n
            pin = float((x - generated(y, eta)).abs().max())
            if not pin <= 1e-6:
                raise SmokeFailure(f"{wl} η={eta}: golden vs generated {pin:.3e}")
            slack = RTOL * eta + m * 2.0 ** -23 * scale
            nrm = float(multilevel.multilevel_norm(x, lv))
            if not nrm <= eta + slack:
                raise SmokeFailure(f"{wl} η={eta}: norm {nrm} > {eta} + {slack:.3e}")
            rec = {"eta": eta, "pin_max_abs_diff": pin, "norm": nrm}
            line = (f"golden {wl} {design} {tuple(y.shape)} η={eta:.6g}: "
                    f"launches {({k: n for k, n in got.items() if n})}, golden "
                    f"vs generated max_abs_diff {pin:.3e}, norm {nrm:.7g} "
                    f"(excess {nrm - eta:.3e}, slack {slack:.3e})")
            if design == "bilevel":
                xe = exact_l1inf.project_l1inf_exact(y, eta)
                xb = exact_l1inf.project_l1inf_exact(y, eta, method="bisect")
                torch.cuda.synchronize()
                ne = float(exact_l1inf.l1inf_norm(xe))
                if not ne <= eta + slack:
                    raise SmokeFailure(f"{wl} η={eta}: exact norm {ne}")
                de, db = float((xe - y).norm()), float((x - y).norm())
                if not de <= db * (1 + 1e-6):
                    raise SmokeFailure(f"{wl} η={eta}: exact {de} farther than "
                                       f"bi-level {db}")
                nb = float((xe - xb).abs().max())
                if not nb <= 1e-4:
                    raise SmokeFailure(f"{wl} η={eta}: exact newton vs bisect {nb}")
                t0 = time.perf_counter()
                host = exact_l1inf.project_l1inf_exact(y.cpu(), eta)
                host_s = time.perf_counter() - t0
                ce = check_close(f"{wl} η={eta} exact card vs CPU", xe.cpu(),
                                 host, scale)
                rec.update(exact_norm=ne, exact_dist=de, bilevel_dist=db,
                           exact_newton_vs_bisect=nb, exact_card_vs_cpu=ce)
                line += (f"; exact norm {ne:.7g}, ‖X-Y‖ exact {de:.7g} vs "
                         f"bi-level {db:.7g}, newton vs bisect {nb:.3e}, card "
                         f"vs CPU {ce:.3e} (CPU call {host_s:.1f} s)")
                del xe, xb, host
            print(line)
            recs.append(rec)
            del x
        out[wl] = {"design": design, "shape": list(y.shape), "counts": counts,
                   "checks": recs}
    torch.cuda.empty_cache()
    return out


def time_golden(wls, golden, kernel_errs):
    """Phase 6's golden rows: each golden kernel at its workloads (W1, W3
    bi-level; W2, W4 tri-level) against its plain version, beside its
    bound and the library call; then each workload's pipelines (golden,
    generated, the plain schedule, and on W1 and W3 the exact projection)
    at its first radius, and on W3 the exact and golden pipelines at every
    radius. Returns the JSON rows and the pipeline times."""
    import torch

    from repro_torch.core import exact_l1inf, multilevel
    from repro_torch.kernels import (bilevel_l1inf as bi, codegen, l1ball,
                                     trilevel_l1infinf as tri)
    from repro_torch.roofline import costs as C

    rows, pipes = [], {}
    for wl, (design, y, radii) in wls.items():
        es, elems, m = y.element_size(), y.numel(), y.shape[-1]
        eta = radii[0]
        if design == "bilevel":
            u = l1ball.outer_l1_solve(bi.colmax(y), eta)
            lo, hi = -u[None, :], u[None, :]  # the bounds, precomputed
            cases = {  # kernel, plain, bytes, operations, library
                "colmax": (lambda: bi.colmax(y), lambda: bi.colmax_plain(y),
                           *C.colmax(es, elems, m),
                           lambda: torch.linalg.vector_norm(y, INF, dim=0)),
                "clip": (lambda: bi.clip(y, u), lambda: bi.clip_plain(y, u),
                         *C.clip(es, elems, m),
                         lambda: torch.clamp(y, lo, hi)),
            }
        else:
            v2, v1 = tri.trilevel_reduce(y)
            u1 = l1ball.outer_l1_solve(v1, eta)
            nm = v2.numel()
            w2 = torch.minimum(v2, u1.to(y.dtype)[None, :])[None]  # the bounds, precomputed
            lo2 = -w2
            cases = {
                "trilevel_reduce": (lambda: tri.trilevel_reduce(y),
                                    lambda: tri.trilevel_reduce_plain(y),
                                    *C.trilevel_reduce(es, elems, nm, m),
                                    None),
                "trilevel_apply": (lambda: tri.trilevel_apply(y, v2, u1),
                                   lambda: tri.trilevel_apply_plain(y, v2, u1),
                                   *C.trilevel_apply(es, elems, nm, m),
                                   lambda: torch.clamp(y, lo2, w2)),
            }
        for name, (kern, plain, nbytes, nops, lib) in cases.items():
            k_out, p_out = kern(), plain()
            torch.cuda.synchronize()
            pairs = zip(k_out, p_out) if name == "trilevel_reduce" \
                else [(k_out, p_out)]
            err = max([kernel_errs[name]] + [check_exact(
                f"{wl} {name} (timing)", a, b) for a, b in pairs])
            if lib is not None:  # the library call computes the same output
                check_exact(f"{wl} {name} library call", lib(), p_out)
            del k_out, p_out
            dev_launches = device_kernels(kern, counts=True)
            for _ in range(2):  # the profiler at times records no device
                if dev_launches:  # event at all: read it again
                    break
                dev_launches = device_kernels(kern, counts=True)
            if name == "trilevel_reduce" and sum(dev_launches.values()) != 1:
                raise SmokeFailure(f"{wl} trilevel_reduce: device kernels "
                                   f"{dev_launches}, not one")
            plain_ms = event_ms(plain)
            ms = event_ms(kern)
            dev_ms, dev20 = graph_ms(kern), graph_ms(kern, calls=20)
            lib_ms, lib_dev = (None, None) if lib is None else (
                event_ms(lib), graph_ms(lib))
            host = {"kernel": host_call_ms(kern),
                    "library": None if lib is None else host_call_ms(lib)}
            bms, by = bound_ms(nbytes, nops)
            rows.append({
                "name": name, "workload": f"{wl} {tuple(y.shape)} f32",
                "route": "cuda", "source": f"src/repro_torch/csrc/{GOLDEN[name]}",
                "replaces": REPLACES[name, False],
                "launches": golden[wl]["counts"][name], "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                "bound_by": by, "library_ms": lib_ms, "graph_ms": dev_ms,
                "graph20_ms": dev20, "host_ms": host["kernel"],
                "library_graph_ms": lib_dev,
                "library_host_ms": host["library"],
                "device_launches": dev_launches})
            print(f"time {wl} {name} {tuple(y.shape)}: device kernels per call "
                  f"{dev_launches}; {ms:.4f} ms (bound "
                  f"{bms:.4f} ms by {by}, {bms / ms:.2f} of bound; CUDA-graph "
                  f"replay {dev_ms:.4f} ms, {bms / dev_ms:.2f} of bound; per "
                  f"call of a 20-call replay {dev20:.4f} ms), plain "
                  f"{plain_ms:.4f} ms, library "
                  f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms (replay {lib_dev:.4f})'}, "
                  f"host per call {host['kernel']:.4f} ms (library "
                  f"{'n/a' if lib_ms is None else '%.4f ms' % host['library']}), "
                  f"max_abs_err {err:.3e}")
        fused = bi.bilevel_l1inf_fused if design == "bilevel" \
            else tri.trilevel_l1infinf_fused
        lv = BILEVEL if design == "bilevel" else TRILEVEL
        generated = codegen.build(y.shape, lv, torch.float32, method="bisect")
        t = {"golden_ms": event_ms(lambda: fused(y, eta)),
             "generated_ms": event_ms(lambda: generated(y, eta)),
             "plain_schedule_ms": event_ms(
                 lambda: multilevel.multilevel_project(y, lv, eta), reps=5)}
        # the host trace of one golden call: its host ms under the profiler
        # and the CUDA runtime calls it made (a synchronize would show)
        t["golden_host_trace_ms"], t["golden_runtime_calls"] = host_trace(
            lambda: fused(y, eta))
        if design == "bilevel":
            t["exact_ms"] = event_ms(
                lambda: exact_l1inf.project_l1inf_exact(y, eta), reps=5)
        if wl == "W3":
            t["exact_over_golden"] = {}
            for r in radii:
                g_ms = event_ms(lambda: fused(y, r))
                e_ms = event_ms(lambda: exact_l1inf.project_l1inf_exact(y, r),
                                reps=5)
                t["exact_over_golden"][r] = {"golden_ms": g_ms,
                                             "exact_ms": e_ms,
                                             "ratio": e_ms / g_ms}
        pipes[wl] = t
        print(f"time {wl} pipelines {tuple(y.shape)} η={eta:.6g} (ms): {t}")
    # what the θ-solve's radius copy cost before it went by value: a 0-d
    # float copied to the card from a Python number, as torch.as_tensor does
    pipes["radius_copy"] = dict(zip(("host_trace_ms", "runtime_calls"), host_trace(
        lambda: torch.as_tensor(0.5, dtype=torch.float32, device="cuda"))))
    print(f"time torch.as_tensor(0.5, device='cuda') host trace: "
          f"{pipes['radius_copy']}")
    return rows, pipes


def hold_sae_step(dev, fc, harvest_dir, layer, main_loss):
    """One full-width SAE step on the card against the same step on the CPU:
    the main path's seed-0 init and first batch, through the factory's own
    step (``make_sae_train_step``: microbatch accumulation, AdamW, the
    projection). The parameters are held in float64 for this check, so no
    ReLU decision near 0 can fall differently on the two devices; the step
    itself accumulates the gradients and runs AdamW and the projection in
    float32, as on the main path. The init must have live features, so the
    encoder's gradient is not zero. Loss and gradient norm are held within
    1e-5 |b|, every parameter within 1e-5 of its largest entry + 1e-5 |b|,
    and the main path's own float32 first-step loss within 1e-5 |b| of the
    CPU's. Returns the max abs errors."""
    import torch

    from repro_torch import _tree
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.models import sae
    from repro_torch.training import sae_factory as F

    tcfg = F.sae_train_config(fc)
    d_in = F.read_meta(harvest_dir)["d_model"]
    d_dict = fc.expansion * d_in
    rows = torch.from_numpy(DataPipeline(DataConfig(
        vocab=1, seq_len=0, global_batch=fc.sae_batch,
        microbatch=fc.microbatch, activation_dir=str(harvest_dir),
        activation_layer=layer)).batch(0))
    p32 = F.init_sae_state(d_in, d_dict, tcfg, 0, heads=fc.heads,
                           device=dev)["params"]
    with torch.no_grad():
        alive = {k: float(v) for k, v in sae.dict_metrics(
            p32, rows.reshape(-1, d_in).to(dev)).items()}
    if not (alive["l0"] > 0 and alive["dead_frac"] < 1):
        raise SmokeFailure(f"held SAE step heads={fc.heads}: no live feature "
                           f"at the init ({alive})")
    before = _tree.tree_map(lambda p: p.double().cpu(), p32)
    card = F.init_sae_state(d_in, d_dict, tcfg, 0,
                            params=_tree.tree_map(lambda p: p.to(dev, copy=True),
                                                 before))
    host = F.init_sae_state(d_in, d_dict, tcfg, 0,
                            params=_tree.tree_map(lambda p: p.clone(), before))
    step = F.make_sae_train_step(tcfg)
    card, cm = step(card, {"tokens": rows.to(dev)})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host, hm = step(host, {"tokens": rows})
    host_s = time.perf_counter() - t0
    tag = f"held SAE step heads={fc.heads}"
    errs = {k: check_close(f"{tag} {k}", cm[k].cpu(), hm[k], 0.0)
            for k in ("loss", "grad_norm")}
    errs["main_path_loss"] = check_close(
        f"{tag} main path's first loss", torch.tensor(main_loss),
        hm["loss"], 0.0)
    for (name, got), want, b0 in zip(_tree.leaves_with_paths(card["params"]),
                                     _tree.leaves(host["params"]),
                                     _tree.leaves(before)):
        scale = max(float(b0.abs().max()), float(want.abs().max()))
        errs[name] = check_close(f"{tag} {name}", got.cpu(), want, scale)
    moved = float((host["params"]["enc"]["w"] - before["enc"]["w"]).abs().max())
    print(f"{tag}: init l0 {alive['l0']:.1f} dead_frac {alive['dead_frac']:.4f}"
          f"; loss {float(hm['loss']):.6g} (main path {main_loss:.6g}), "
          f"grad_norm {float(hm['grad_norm']):.6g}, encoder moved by up to "
          f"{moved:.3e}; card vs CPU max_abs_err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (CPU step {host_s:.1f} s)")
    return errs


def hold_attention(randn, tag, qs, ks, causal, window, dtype, scale=None):
    """In ``dtype``: the forward and both backward kernels against their
    plain versions on the same inputs, the kernel's o and lse feeding
    both backwards. Returns the max error per kernel and the inputs."""
    import torch

    from repro_torch.kernels import flash_attention as flash

    q, k, v, do = (randn(s_, 1.0).to(dtype) for s_ in (qs, ks, ks, qs))
    opts = dict(causal=causal, window=window, scale=scale)
    o, lse = flash.flash_attention(q, k, v, **opts)
    torch.cuda.synchronize()
    rtol = BF16_RTOL if dtype == torch.bfloat16 else RTOL
    po, plse = flash.flash_attention_plain(q, k, v, **opts)
    errs = {"flash_fwd": max(check_close(f"{tag} o", o, po, 2.0, rtol=rtol),
                             check_close(f"{tag} lse", lse, plse, 1.0))}
    delta = (do.float() * o.float()).sum(-1)
    dq = flash.flash_bwd_dq(q, k, v, do, lse, delta, **opts)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, **opts)
    torch.cuda.synchronize()
    want = flash.flash_attention_bwd_plain(q, k, v, o, lse, do, **opts)
    got = {"dq": dq, "dk": dk, "dv": dv}
    e = {n: check_close(f"{tag} {n}", got[n], w, float(w.abs().max()),
                        rtol=rtol) for n, w in zip(("dq", "dk", "dv"), want)}
    errs["flash_bwd_dq"] = e["dq"]
    errs["flash_bwd_dkv"] = max(e["dk"], e["dv"])
    refused = ""
    if dtype == torch.float32:
        refuse_short_bwd_scratch(tag, q, k, v, do, lse, delta, dq, dk, dv,
                                 causal, window, scale)
        refused = "; a scratch one float short refused by both exports"
    print(f"flash {tag} {str(dtype)[6:]} q{qs} kv{ks} causal={causal} "
          f"window={window}" + ("" if scale is None else f" scale={scale}")
          + ": " + ", ".join(
              f"{k_} max_abs_err {v_:.3e}" for k_, v_ in errs.items()) + refused)
    return errs, (q, k, v, do, o, lse, delta)


def refuse_short_bwd_scratch(tag, q, k, v, do, lse, delta, dq, dk, dv, causal,
                             window, scale):
    """Each float32 backward export owns its scratch's layout: a buffer one
    float short of ``bwd_work_floats`` is refused before anything
    launches."""
    import torch

    from repro_torch.kernels import _build, flash_attention as flash

    (b, hq, sq, d), (hkv, sk) = q.shape, k.shape[1:3]
    tail = (b, hq, hkv, sq, sk, d, int(causal), window or 0,
            d ** -0.5 if scale is None else scale, 0, _build.stream_handle(q))
    head = {"flash_bwd_dq": (dq.data_ptr(),),
            "flash_bwd_dkv": (dk.data_ptr(), dv.data_ptr())}
    for kern, fn, dkv in ((flash.DQ_TF32_KERNEL, "flash_bwd_dq", False),
                          (flash.DKV_TF32_KERNEL, "flash_bwd_dkv", True)):
        short = torch.empty(flash.bwd_work_floats(
            b, hq, hkv, sq, sk, d, dkv=dkv, bf16=False) - 1, device=q.device)
        try:
            kern.launch(fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        *head[fn], short.data_ptr(), short.numel(), *tail)
        except RuntimeError:
            continue
        raise SmokeFailure(f"flash {tag}: {fn} took a float32 scratch one "
                           "float short of its size")



def hold_flash(randn, tag, qs, ks, causal, window):
    """The float32 flash forward against its plain version: o within 2e-5 +
    1e-5|b|, lse within 1e-5 + 1e-5|b|; returns the max error and the
    inputs."""
    import torch

    from repro_torch.kernels import _build, flash_attention as flash

    q, k, v = randn(qs, 1.0), randn(ks, 1.0), randn(ks, 1.0)
    o, lse = flash.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    po, plse = flash.flash_attention_plain(q, k, v, causal=causal,
                                           window=window)
    err = max(check_close(f"{tag} o", o, po, 2.0),
              check_close(f"{tag} lse", lse, plse, 1.0))
    # the export owns the scratch's layout: the wrapper's size just ran, one
    # float fewer is refused before anything launches
    (b, hq, sq, d), (hkv, sk) = q.shape, k.shape[1:3]
    short = torch.empty(flash.tf32_work_floats(b, hq, hkv, sq, sk, d) - 1,
                        device=q.device)
    try:
        flash.TF32_KERNEL.launch(
            "flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), short.data_ptr(), short.numel(), b,
            hq, hkv, sq, sk, d, int(causal), window or 0, d ** -0.5,
            min(128, sq), min(128, sk), 0, _build.stream_handle(q))
    except RuntimeError:
        pass
    else:
        raise SmokeFailure(f"flash {tag}: the float32 forward took a scratch "
                           "one float short of tf32_work_floats")
    print(f"flash {tag} q{qs} kv{ks} causal={causal} window={window}: "
          f"max_abs_err {err:.3e}; a scratch one float short refused")
    return err, (q, k, v)


def _profile(fn, annotate=False, setup=None):
    """One warm call of ``fn`` under ``torch.profiler`` (CPU and CUDA);
    with ``annotate`` inside a ``record_function`` range named
    ``smoke_call`` (which the trace also lists among the device events);
    ``setup()`` runs before each call of ``fn``, outside the profiler."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for step in (setup, fn, setup):
        if step:
            step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("smoke_call") if annotate else contextlib.nullcontext():
            fn()
        torch.cuda.synchronize()
    return prof


def device_kernels(fn, counts=False, setup=None):
    """``{kernel name: device ms}`` (with ``counts``: launches) of the
    device kernels one call of ``fn`` launches, read from
    ``torch.profiler`` (empty where the profiler records none); ``setup``
    as :func:`_profile`'s."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return {e.key: e.count if counts else getattr(e, "device_time_total", 0.0) / 1e3
            for e in _profile(fn, setup=setup).key_averages()
            if getattr(e, "device_type", None) == cuda}


def host_trace(fn):
    """The profiler's host trace of one call of ``fn``: its host ms (the
    ``smoke_call`` range) and ``{CUDA runtime call: count}`` inside it,
    where a ``cudaStreamSynchronize`` or ``cudaDeviceSynchronize`` shows
    that the call waited for the device."""
    import collections

    import torch

    cpu = torch.autograd.DeviceType.CPU
    evs = [e for e in _profile(fn, annotate=True).events() if e.device_type == cpu]
    call = next(e for e in evs if e.name == "smoke_call")
    t0, t1 = call.time_range.start, call.time_range.end
    runtime = collections.Counter(
        e.name for e in evs if e.name.startswith("cuda")
        and t0 <= e.time_range.start <= t1)
    return (t1 - t0) / 1e3, dict(runtime)


def time_flash_harvest(flash_full, launches):
    """Kernel row 12 f32: the float32 forward (``flash_fwd_tf32``) at the
    harvest's shape beside its plain version and one
    scaled_dot_product_attention call on the same tensors (its max abs
    error against the plain version and its device kernels, named by the
    profiler, are reported). The
    bound counts the float32 work at the TF32 rate; the printed line also
    gives the time of the three TF32 products the split issues (three times
    the bound's work at the same rate)."""
    import torch

    from repro_torch.kernels import flash_attention as flash
    from repro_torch.roofline import costs as C

    ferr, (q, k, v) = flash_full
    (b, hq, sq, d), sk = q.shape, k.shape[2]
    kern = lambda: flash.flash_attention(q, k, v, causal=True)  # noqa: E731
    plain = lambda: flash.flash_attention_plain(q, k, v, causal=True)  # noqa: E731
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True)
    want = plain()[0]
    ferr = max(ferr, check_close("full flash o (timing)", kern()[0], want, 2.0))
    # the library call's own distance to the plain version, read, not held
    lib_err = float((sdpa() - want).abs().max())
    del want
    plain_ms = event_ms(plain)
    ms = event_ms(kern)
    lib_ms = event_ms(sdpa)
    sdpa_kernels = device_kernels(sdpa)
    own_kernels = device_kernels(kern)   # the pre-pass and the kernel apart
    # causal work 2·B·Hq·Sq·Sk·D (half of QKᵀ and of PV); bytes: q, k, v, o
    # once each and the f32 lse (roofline/costs.py's table)
    nbytes, work = C.flash_fwd(q, k, True)
    bms, by = bound_ms(nbytes, work, TF32_OPS_PER_S)
    issued_ms = 3 * work / TF32_OPS_PER_S * 1e3
    row = {
        "name": "flash_fwd_tf32", "workload": f"harvest {tuple(q.shape)} causal f32",
        "route": "cuda", "source": "src/repro_torch/csrc/flash_fwd.cu",
        "replaces": REPLACES["flash_fwd_tf32", False], "launches": launches,
        "max_abs_err": ferr, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
        "bound_by": by, "library_ms": lib_ms,
        "kernels": own_kernels, "library_kernels": sdpa_kernels,
        "library_max_abs_err": lib_err}
    print(f"time flash_fwd_tf32 {tuple(q.shape)} causal: {ms:.4f} ms (bound "
          f"{bms:.4f} ms by {by}, {bms / ms:.2f} of bound; 3×TF32 issued "
          f"{issued_ms:.4f} ms, {issued_ms / ms:.2f} of it), plain "
          f"{plain_ms:.4f} ms, scaled_dot_product_attention {lib_ms:.4f} ms "
          f"(device kernels {sdpa_kernels}, max_abs_err {lib_err:.3e}), "
          f"max_abs_err {ferr:.3e}; device ms by kernel {own_kernels}")
    return row


def hold_function_grads(randn, attn=GRANITE_ATTN):
    """The ``FlashAttention`` Function's float32 gradients at ``attn``
    (q shape, k/v shape, causal, window; granite's attention by default)
    against autograd of ``attention_naive`` (the S×S logits) on the same
    q, k, v and cotangent."""
    import torch

    from repro_torch.kernels import _build, flash_attention as flash
    from repro_torch.models import layers as L

    qs, ks, causal, window = attn
    q, k, v, cot = randn(qs, 1.0), randn(ks, 1.0), randn(ks, 1.0), randn(qs, 1.0)
    lf = [x.clone().requires_grad_(True) for x in (q, k, v)]
    _build.reset_launches()
    (flash.flash(*lf, causal=causal, window=window) * cot).sum().backward()
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    want = dict.fromkeys(F32_FLASH, 1) | dict.fromkeys(BF16_FLASH, 0)
    if any(counts[n] != c for n, c in want.items()):
        raise SmokeFailure("flash Function float32 forward+backward: launches "
                           f"{ {n: counts[n] for n in want} }, not {want}")
    ln = [x.clone().requires_grad_(True) for x in (q, k, v)]
    on = L.attention_naive(*(x.transpose(1, 2) for x in ln), causal=causal,
                           window=window).transpose(1, 2)
    (on * cot).sum().backward()
    torch.cuda.synchronize()
    errs = {f"d{n}": check_close(f"Function d{n} vs naive autograd", a.grad,
                                 b.grad, float(b.grad.abs().max()))
            for n, a, b in zip("qkv", lf, ln)}
    print(f"flash Function gradients at {qs}/{ks} f32 vs autograd of "
          "attention_naive: " + ", ".join(f"{k_} max_abs_err {v_:.3e}"
                                          for k_, v_ in errs.items())
          + f"; launches {counts['flash_fwd_tf32']} / "
          f"{counts['flash_bwd_dq_tf32']} / {counts['flash_bwd_dkv_tf32']} "
          "(flash_fwd_tf32 / flash_bwd_dq_tf32 / flash_bwd_dkv_tf32), 0 bf16")
    return errs


def hold_attention_all(randn):
    """``hold_attention`` in float32 and bf16 on every ``FLASH_CASES``
    entry, on one case with a negative scale (the kernels take any scale)
    and at ``GRANITE_ATTN``, then ``hold_function_grads``. Returns
    the cases' max error per (kernel, type), granite's errors and inputs
    per type, and the Function's gradient errors."""
    import torch

    case_errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (qs, ks, causal, window, scale) in enumerate(
                [c + (None,) for c in FLASH_CASES] + [FLASH_CASES[1] + (-0.125,)]):
            errs, _ = hold_attention(randn, f"case{i}", qs, ks, causal,
                                     window, dtype, scale)
            for k_, v_ in errs.items():
                key = (k_, str(dtype)[6:])
                case_errs[key] = max(case_errs.get(key, 0.0), v_)
    full = {dt: hold_attention(randn, "granite", *GRANITE_ATTN, dt)
            for dt in (torch.float32, torch.bfloat16)}
    return case_errs, full, hold_function_grads(randn)


def factory_phase(dev, fcfg, seeds, workdir, randn):
    """Phase 4: the SAE factory on ``dev``. Builds the LM with the port's
    seeded init and runs ``run_factory`` bi-level and with ``heads=32``,
    each counted for launches (the flash kernel once per layer and harvest
    step) and checked for falling finite losses and feasible encoders. The
    bi-level run's layer-12 shard 0 is held against the same forward with
    ``impl="naive"``; each design's first SAE step is held against the same
    step on the CPU. Then times one warm harvest step and one SAE step with
    their parts. Returns what phase 5 and the JSON line report."""
    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.kernels import _build
    from repro_torch.models import lm, sae
    from repro_torch.optim.projection_hook import _project_leaf
    from repro_torch.training import sae_factory as F

    layer = fcfg.layers[0]
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    cfg, _, lm_params = F.lm_for(fcfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _tree.leaves(lm_params))
    print(f"factory: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"{cfg.n_heads}x{cfg.resolved_head_dim} heads d_ff {cfg.d_ff} vocab "
          f"{cfg.vocab}: {n_params} params, seeded init on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    per_step = n_layers = cfg.n_layers  # one flash launch per layer and step
    toks = DataPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=fcfg.seq_len, global_batch=fcfg.lm_batch,
        microbatch=fcfg.lm_batch, seed=fcfg.seed)).batch(0)
    toks = torch.from_numpy(toks.reshape(-1, fcfg.seq_len)).to(dev)

    # the main path: run_factory, bi-level then head-structured tri-level
    factory, held = {}, {}
    for design, heads in (("bilevel", 1), ("trilevel", 32)):
        fc = dataclasses.replace(fcfg, heads=heads)
        _build.reset_launches()
        t0 = time.perf_counter()
        res = F.run_factory(fc, workdir / design, seeds=seeds,
                            lm_params=lm_params, device=dev)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = _build.launch_counts()
        print(f"factory {design} (heads={heads}, levels "
              f"{F.effective_levels(fc)}): run_factory {run_s:.1f} s; "
              f"launches {counts}")
        # float32: every forward on the 3×TF32 tensor-core kernel
        if counts["flash_fwd_tf32"] != per_step * fc.harvest_steps \
                or counts["flash_fwd"] != 0:
            raise SmokeFailure(f"{design}: flash_fwd_tf32 / flash_fwd launched "
                               f"{counts['flash_fwd_tf32']} / "
                               f"{counts['flash_fwd']} times, not "
                               f"{per_step * fc.harvest_steps} / 0")
        rec = res["layers"][layer]
        for s_ in seeds:
            losses = rec["losses"][s_]
            rep = rec["constraint"][s_]
            print(f"factory {design} seed {s_} losses: "
                  + " ".join(f"{x:.6g}" for x in losses))
            print(f"factory {design} seed {s_}: metrics {rec['metrics'][s_]}; "
                  f"sparsity {rec['sparsity'][s_]}; constraint norms "
                  f"{rep['norms']} max_violation {rep['max_violation']:.3e}")
            if not all(np.isfinite(losses)):
                raise SmokeFailure(f"{design} seed {s_}: non-finite loss")
            if not losses[-1] < losses[0]:
                raise SmokeFailure(f"{design} seed {s_}: loss did not fall "
                                   f"({losses[0]} -> {losses[-1]})")
            if not rep["max_violation"] <= 1e-5 * fc.radius:
                raise SmokeFailure(f"{design} seed {s_}: encoder infeasible, "
                                   f"max violation {rep['max_violation']}")
        print(f"factory {design} mmcs {rec['mmcs']}")
        if design == "bilevel":
            # the main path's own shard against the naive-attention forward
            with torch.no_grad():
                want = lm.forward(lm_params, toks, cfg, impl="naive",
                                  remat=False, collect="resid")[2][layer]
            want = want.reshape(-1, cfg.d_model)
            got = torch.from_numpy(np.load(
                workdir / design / f"layer{layer:03d}_shard00000.npy")).to(dev)
            err = check_close(f"harvest layer {layer} flash vs naive", got,
                              want, float(want.abs().max()))
            print(f"factory harvest layer {layer} step 0 (bi-level run's "
                  f"shard): flash path vs impl='naive' max_abs_err {err:.3e} "
                  f"(max |act| {float(want.abs().max()):.3e})")
            del want, got
            torch.cuda.empty_cache()
        held[design] = hold_sae_step(dev, fc, workdir / design, layer,
                                     rec["losses"][0][0])
        factory[design] = {"counts": counts, "run_s": run_s,
                           "mmcs": rec["mmcs"],
                           "final_loss": {s_: rec["losses"][s_][-1]
                                          for s_ in seeds}}
    flash_launches = factory["bilevel"]["counts"]["flash_fwd_tf32"]

    # one warm harvest step as the factory runs it (tokens, forward, copy of
    # the layer's rows to the host, shard write) and its parts
    def harvest_forward():
        with torch.no_grad():
            return lm.forward(lm_params, toks, cfg, impl="flash", remat=False,
                              collect="resid")

    tdir = workdir / "timing"
    one = dataclasses.replace(fcfg, harvest_steps=1)
    step_parts = {"harvest_step_ms": host_ms(
        lambda: F.harvest_activations(one, tdir, params=lm_params), reps=3)}
    step_parts["forward_ms"] = host_ms(harvest_forward, reps=3)
    acts = harvest_forward()[2]
    step_parts["to_host_ms"] = host_ms(
        lambda: acts[layer].reshape(-1, cfg.d_model).cpu().numpy(), reps=3)
    rows = acts[layer].reshape(-1, cfg.d_model).cpu().numpy()
    step_parts["shard_write_ms"] = host_ms(
        lambda: np.save(tdir / "timing.npy", rows.astype(np.float32)), reps=3)
    # the token batch, meta.json and Python around the three parts
    step_parts["harvest_rest_ms"] = step_parts["harvest_step_ms"] - sum(
        step_parts[k] for k in ("forward_ms", "to_host_ms", "shard_write_ms"))
    del acts, rows
    b, s = toks.shape
    hd = cfg.resolved_head_dim
    x4 = randn((b, s, cfg.n_heads, hd), 1.0)
    step_parts["layout_copies_ms"] = cfg.n_layers * event_ms(
        lambda: [x4.transpose(1, 2).contiguous() for _ in range(3)])
    xs = randn((b, s, cfg.d_model), 1.0)
    step_parts["unembed_ms"] = event_ms(lambda: xs @ lm_params["unembed"])
    del x4, xs
    print(f"factory harvest step parts: {step_parts}")

    # one SAE step of each design and its parts
    sae_parts = {}
    for design, heads in (("bilevel", 1), ("trilevel", 32)):
        fc = dataclasses.replace(fcfg, heads=heads)
        tcfg = F.sae_train_config(fc)
        d_in = cfg.d_model
        state = F.init_sae_state(d_in, fc.expansion * d_in, tcfg, 0,
                                 heads=heads, device=dev)
        step = F.make_sae_train_step(tcfg)
        pipe = DataPipeline(DataConfig(
            vocab=1, seq_len=0, global_batch=fc.sae_batch,
            microbatch=fc.microbatch, activation_dir=str(workdir / design),
            activation_layer=layer))
        batch = torch.from_numpy(pipe.batch(0)).to(dev)
        spec = tcfg.projection
        enc = state["params"]["enc"]["w"]

        def fwd_bwd():
            leaves = [p.detach().requires_grad_(True)
                      for p in (enc, state["params"]["enc"]["b"],
                                state["params"]["dec"]["w"],
                                state["params"]["dec"]["b"])]
            tree = {"enc": {"w": leaves[0], "b": leaves[1]},
                    "dec": {"w": leaves[2], "b": leaves[3]}}
            loss = sae.dict_loss(tree, batch[0].float())
            return torch.autograd.grad(loss, leaves)

        # step_ms: the train step on a batch already on the card; data_ms:
        # the loop's fetch of the next batch (reader + copy), apart
        sae_parts[design] = {
            "step_ms": host_ms(lambda: step(state, {"tokens": batch})),
            "data_ms": host_ms(lambda: torch.from_numpy(
                pipe.batch(1)).to(dev)),
            "fwd_bwd_ms": batch.shape[0] * event_ms(fwd_bwd),
            "projection_ms": event_ms(lambda: _project_leaf(
                enc, spec.levels, spec.radius, spec.method,
                transpose=spec.transpose)),
        }
        print(f"factory SAE step {design}: {sae_parts[design]}")
        del state, batch, enc
    del lm_params, toks
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()

    return {"runs": factory, "flash_launches": flash_launches,
            "n_layers": n_layers, "harvest_step_ms": step_parts,
            "sae_step_ms": sae_parts, "held_sae_step": held}


def train_args():
    """(steps, batch, microbatch, seq) of TRAIN_ARGV."""
    args = dict(zip(TRAIN_ARGV[::2], TRAIN_ARGV[1::2]))
    return tuple(int(args[k]) for k in ("--steps", "--batch", "--microbatch",
                                        "--seq"))


@functools.lru_cache(maxsize=None)
def train_radius(dev):
    """The radius of the main path's constraint: RADIUS_FRACTION of the
    smallest per-layer bi-level ℓ1,∞ norm of the launcher's seed-0 init of
    ``w_up`` and ``w_gate`` (each leaf draws from its own seeded generator,
    so initialising one leaf gives the launcher's values); drawn once, then
    remembered for phases 9 and 10."""
    from repro_torch.configs import registry
    from repro_torch.configs.types import ProjectionSpec
    from repro_torch.core.multilevel import multilevel_norm
    from repro_torch.models import lm, params as PM

    mlp = lm.template(registry.get_arch(TRAIN_ARCH))["blocks"]["mlp"]
    levels = list(ProjectionSpec().levels)
    norms = []
    for leaf in ("w_up", "w_gate"):
        w = PM.init_params({"blocks": {"mlp": {leaf: mlp[leaf]}}}, SEED,
                           device=dev)["blocks"]["mlp"][leaf]
        norms += [float(multilevel_norm(x, levels)) for x in w]
        del w
    return RADIUS_FRACTION * min(norms), min(norms)


def held_step_setup(dev, radius):
    """The held step's configuration, batch and initial parameters:
    granite-3-2b at full width cut to HELD_LAYERS layers, float32 compute,
    the projection on (``hold_train_step``; ``scripts/time_ab.py held``
    times the same step). Returns (cfg, tcfg, api, spec, batch, params)."""
    import torch

    from repro_torch import models
    from repro_torch.configs import registry
    from repro_torch.configs.types import ProjectionSpec, TrainConfig
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.training import init_state

    cfg = dataclasses.replace(registry.get_arch(TRAIN_ARCH), n_layers=HELD_LAYERS)
    steps, batch, micro, seq = train_args()
    spec = ProjectionSpec(pattern=r"(w_up|w_gate)", radius=radius)
    tcfg = TrainConfig(microbatch=micro, total_steps=steps, warmup=1,
                       remat=True, master_dtype="", compute_dtype="float32",
                       projection=spec)
    api = models.get(cfg)
    pipe = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq + 1,
                                   global_batch=batch, microbatch=micro))
    toks = {"tokens": torch.from_numpy(pipe.batch(0)).to(dev)}
    base = init_state(cfg, tcfg, api, SEED, device=dev)["params"]
    return cfg, tcfg, api, spec, toks, base


def hold_train_step(dev, radius, setup=None, sites=HELD_LAYERS,
                    tag="held train step"):
    """One step of granite-3-2b at full width cut to HELD_LAYERS layers
    (``setup``, another model's, as ``held_step_setup`` returns it),
    float32 compute, the projection on: ``impl="flash"`` (the kernels,
    through the Function and remat) against ``impl="naive"`` from the same
    state and batch. The flash run launches the forward twice and each
    backward kernel once per attention site (``sites`` a microbatch) and
    microbatch, the naive run none.

    Tolerances. Loss and gradient norm within 1e-5 |b|. The first moments,
    m = (1 - β1) · the clipped gradient after one step, hold the kernels'
    gradients: within 1e-5 of the leaf's largest entry + 1e-5 |b|. Every
    updated parameter within 1e-5 of the leaf's largest entry + 1e-5 |b|
    + lr · |Δu|, where Δu is the difference of the two runs' normalised
    AdamW updates m̂ / (√v̂ + ε), computed from their own moments: that
    update has slope 1/ε = 1e8 at g = 0, so a gradient entry of order ε
    whose last digits differ moves its parameter by a fraction of lr. A
    projected leaf takes 3 × the leaf's largest lr · |Δu| instead (the clip
    moves with its column's max and with θ, each 1-Lipschitz).

    Every leaf is checked before a failure is raised, with all of them
    named, and the first moments farthest from the naive step's are
    printed in units of their bar's first term."""
    import torch

    from repro_torch import _tree
    from repro_torch.kernels import _build
    from repro_torch.optim import adamw
    from repro_torch.optim.projection_hook import _matches
    from repro_torch.training import make_train_step

    cfg, tcfg, api, spec, toks, base = (setup or held_step_setup)(dev, radius)
    runs, step_fns = {}, {}
    for impl in ("flash", "naive"):
        params = _tree.tree_map(lambda p: p.clone(), base)
        state = {"params": params, "opt": adamw.init(params, tcfg)}
        step_fns[impl] = make_train_step(cfg, tcfg, api, impl=impl)
        _build.reset_launches()
        state, m = step_fns[impl](state, toks)
        torch.cuda.synchronize()
        runs[impl] = (state, {k: float(v) for k, v in m.items()},
                      _build.launch_counts())
    (sf, mf, cf), (sn, mn, cn) = runs["flash"], runs["naive"]
    n_micro = toks["tokens"].shape[0]
    # float32 compute: the 3×TF32 kernels only, none of the bf16 ones
    want = {"flash_fwd_tf32": 2 * sites * n_micro,
            "flash_bwd_dq_tf32": sites * n_micro,
            "flash_bwd_dkv_tf32": sites * n_micro} | dict.fromkeys(BF16_FLASH, 0)
    for k_, n in want.items():
        if cf[k_] != n or cn[k_] != 0:
            raise SmokeFailure(f"{tag}: {k_} launched {cf[k_]} (flash) / "
                               f"{cn[k_]} (naive) times, not {n} / 0")
    errs = {k_: check_close(f"{tag} {k_}", torch.tensor(mf[k_]),
                            torch.tensor(mn[k_]), 0.0)
            for k_ in ("loss", "grad_norm")}
    match = _matches(spec)
    bc1, bc2 = 1.0 - tcfg.beta1, 1.0 - tcfg.beta2   # step 1's bias corrections

    def unit(m_, v_):
        return (m_ / bc1) / (torch.sqrt(v_ / bc2) + tcfg.eps)

    moved, slack_max, failed, ratio = 0.0, 0.0, [], {}
    for (name, pf), pn, p0, m_f, m_n, v_f, v_n in zip(
            _tree.leaves_with_paths(sf["params"]), _tree.leaves(sn["params"]),
            _tree.leaves(base), _tree.leaves(sf["opt"]["m"]),
            _tree.leaves(sn["opt"]["m"]), _tree.leaves(sf["opt"]["v"]),
            _tree.leaves(sn["opt"]["v"])):
        scale = float(m_n.abs().max())
        merr = (m_f - m_n).abs()
        errs[f"m/{name}"] = float(merr.max())
        ratio[name] = errs[f"m/{name}"] / max(1e-5 * scale, 1e-30)
        if not bool(torch.isfinite(m_f).all()) or bool(
                (merr > 1e-5 * scale + RTOL * m_n.abs()).any()):
            failed.append(f"first moment {name}: max abs err "
                          f"{errs[f'm/{name}']:.3e} (scale {scale:.3e})")
        du = mn["lr"] * (unit(m_f, v_f) - unit(m_n, v_n)).abs()
        slack = 3.0 * du.max() if match(name, pn) else du
        err = (pf - pn).abs()
        bad = err > 1e-5 * float(pn.abs().max()) + RTOL * pn.abs() + slack
        if bool(bad.any()) or not bool(torch.isfinite(pf).all()):
            failed.append(f"{name}: max abs err {float(err.max()):.3e}")
        errs[name] = float(err.max())
        moved = max(moved, float((pn - p0).abs().max()))
        slack_max = max(slack_max, float(slack.max()))
    print(f"{tag} ({cfg.name} full width, {cfg.n_layers} layers, f32, "
          f"radius {radius:.6g}): loss {mn['loss']:.6g} grad_norm "
          f"{mn['grad_norm']:.6g}, parameters moved by up to {moved:.3e}; "
          f"flash launches {cf}; flash vs naive max_abs_err "
          + ", ".join(f"{k_} {v_:.3e}" for k_, v_ in errs.items())
          + f"; largest lr·|Δu| slack used {slack_max:.3e}")
    worst = sorted(ratio, key=lambda n: -ratio[n])[:4]
    print(f"{tag}: first moments farthest from the naive step's, in units of "
          f"1e-5 of the leaf's largest entry: "
          + ", ".join(f"{n} {ratio[n]:.2f}" for n in worst))
    if failed:
        raise SmokeFailure(f"{tag}: past tolerance: " + "; ".join(failed))
    del runs, sn, base
    # the flash step warm, on its own result (host clock, median of 3)
    step_ms = host_ms(lambda: step_fns["flash"](sf, toks), reps=3)
    print(f"{tag} time (flash, warm): {step_ms:.3f} ms")
    del sf, step_fns
    torch.cuda.empty_cache()
    return errs, cf, step_ms


def training_phase(dev, workdir):
    """Phase 5: the held step, then the main path (``launch.train.run`` at
    full width and depth) with its checks, then one warm train step and its
    parts on the trained state. Returns what phase 6 and the JSON line
    report."""
    import numpy as np
    import torch

    from repro_torch import _tree, models
    from repro_torch.configs import registry
    from repro_torch.configs.types import ProjectionSpec, TrainConfig
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.kernels import _build
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import fused_step
    from repro_torch.optim.projection_hook import _project_leaf
    from repro_torch.runtime import CheckpointManager
    from repro_torch.training import make_loss_fn, make_train_step
    from repro_torch.training.sae_factory import constraint_report

    radius, init_norm = train_radius(dev)
    print(f"train radius {radius:.6g} = {RADIUS_FRACTION} x the init's smallest "
          f"per-layer l1,inf norm of w_up/w_gate ({init_norm:.6g})")
    held, held_launches, held_ms = hold_train_step(dev, radius)

    # ------------------------------------------------------- the main path
    cfg = registry.get_arch(TRAIN_ARCH)
    ck = workdir / "ckpt"
    shutil.rmtree(workdir, ignore_errors=True)
    argv = TRAIN_ARGV + ["--radius", repr(radius), "--ckpt", str(ck)]
    workdir.mkdir(parents=True)
    print(f"train checkpoint directory {ck}: "
          f"{shutil.disk_usage(workdir).free / 2**30:.1f} GiB free")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = train_cli.run(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    state = out["state"]
    steps, batch, micro, seq = train_args()
    n_micro = batch // micro
    n_params = sum(p.numel() for p in _tree.leaves(state["params"]))
    print(f"train main path: python -m repro_torch.launch.train {' '.join(argv)}"
          f": {cfg.n_layers} layers d_model {cfg.d_model} {cfg.n_heads}x"
          f"{cfg.resolved_head_dim} q heads over {cfg.n_kv_heads} kv heads d_ff "
          f"{cfg.d_ff} vocab {cfg.vocab}, {n_params} float32 params; {run_s:.1f} s "
          f"(init, {steps} steps, checkpoints); step seconds "
          + " ".join(f"{x:.3f}" for x in out["step_seconds"]))
    print(f"train losses {out['losses']} grad norms {out['grad_norms']}")
    print(f"train launches {counts}; peak device memory "
          f"{peak / 2**30:.2f} GiB ({peak} bytes, max_memory_allocated)")
    if not (len(out["losses"]) == steps and all(np.isfinite(out["losses"]))):
        raise SmokeFailure(f"train: losses {out['losses']}")
    want = {"flash_fwd": 2 * cfg.n_layers * n_micro * steps,
            "flash_bwd_dq": cfg.n_layers * n_micro * steps,
            "flash_bwd_dkv": cfg.n_layers * n_micro * steps}
    for k_, n in want.items():
        if counts[k_] != n:
            raise SmokeFailure(f"train: {k_} launched {counts[k_]} times, not {n}")
    if any(counts[k_] for k_ in F32_FLASH):  # bf16 compute: no float32 kernel
        raise SmokeFailure(f"train: float32 flash kernels launched: "
                           f"{ {k_: counts[k_] for k_ in F32_FLASH} }")
    spec = ProjectionSpec(pattern=r"(w_up|w_gate)", radius=radius)
    rep = constraint_report(state["params"], spec)
    print(f"train constraint: max per-layer norms {rep['norms']}, max_violation "
          f"{rep['max_violation']:.3e} (radius {radius:.6g})")
    if not rep["max_violation"] <= 1e-5 * radius:
        raise SmokeFailure(f"train: projected leaves infeasible: {rep}")
    layer_sparsity = {}
    for leaf in ("w_up", "w_gate"):
        cols = state["params"]["blocks"]["mlp"][leaf].abs().amax(dim=1)  # (L, f)
        per_layer = (100.0 * (cols == 0).float().mean(dim=1)).tolist()
        layer_sparsity[leaf] = per_layer
        print(f"train per-layer column sparsity {leaf}: min {min(per_layer):.2f}% "
              f"mean {sum(per_layer) / len(per_layer):.2f}% max "
              f"{max(per_layer):.2f}%; the launcher's stacked line "
              f"{out['sparsity'][f'blocks/mlp/{leaf}']:.2f}%")
        if not all(0.0 < x < 100.0 for x in per_layer):
            raise SmokeFailure(f"train: {leaf} per-layer column sparsity "
                               f"{per_layer} not strictly inside (0, 100)")
    mgr = CheckpointManager(ck)
    if mgr.all_steps() != [steps]:
        raise SmokeFailure(f"train: checkpoints {mgr.all_steps()}, not [{steps}]")
    t0 = time.perf_counter()
    restored, manifest = mgr.restore(device="cpu")
    restore_s = time.perf_counter() - t0
    got = dict(_tree.leaves_with_paths(restored))
    live = dict(_tree.leaves_with_paths(state))
    if manifest["step"] != steps or sorted(got) != sorted(live):
        raise SmokeFailure(f"train: restored step {manifest['step']} with "
                           f"{len(got)} leaves, not {steps} with {len(live)}")
    for name, t in live.items():
        if not torch.equal(got[name], t.cpu()):
            raise SmokeFailure(f"train: restored {name} differs from the state")
    ck_bytes = sum(f.stat().st_size for f in ck.rglob("*") if f.is_file())
    print(f"train checkpoint: steps {mgr.all_steps()} ({ck_bytes} bytes on disk),"
          f" step {steps} restored equal to the final state ({len(live)} "
          f"leaves) in {restore_s:.1f} s")
    del restored, got
    shutil.rmtree(workdir, ignore_errors=True)

    # ------------------------------------- one warm train step and its parts
    tcfg = TrainConfig(microbatch=micro, lr=3e-4, total_steps=steps,
                       warmup=min(20, steps // 5 + 1), remat=True,
                       master_dtype="", projection=spec)
    api = models.get(cfg)
    pipe = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq + 1,
                                   global_batch=batch, microbatch=micro))
    toks = torch.from_numpy(pipe.batch(steps)).to(dev)
    step_fn = make_train_step(cfg, tcfg, api, impl="flash")
    loss_fn = make_loss_fn(cfg, api, impl="flash", remat=True,
                           compute_dtype=torch.bfloat16)
    params = state["params"]
    leaves = _tree.leaves(params)

    def fwd_bwd():
        live_ = [p.detach().requires_grad_(True) for p in leaves]
        loss = loss_fn(_tree.unflatten_like(params, live_), toks[0])
        torch.autograd.grad(loss, live_)

    parts = {"step_ms": host_ms(lambda: step_fn(state, {"tokens": toks}), reps=3)}
    parts["fwd_bwd_ms"] = n_micro * host_ms(fwd_bwd, reps=3)
    grads = _tree.tree_map(lambda p: torch.full_like(p, 1e-3), params)
    parts["epilogue_ms"] = host_ms(lambda: fused_step.fused_update(
        grads, state["opt"], params, tcfg), reps=3)
    del grads
    mlp = params["blocks"]["mlp"]
    parts["projection_ms"] = sum(event_ms(lambda w=w: _project_leaf(
        w, spec.levels, spec.radius, spec.method)) for w in (mlp["w_up"],
                                                             mlp["w_gate"]))
    parts["data_ms"] = host_ms(lambda: torch.from_numpy(
        pipe.batch(steps + 1)).to(dev), reps=3)
    parts["tokens_per_s"] = batch * seq / (parts["step_ms"] / 1e3)
    per_step = {k_: n // steps for k_, n in want.items()}
    print(f"train step parts (ms): {parts}")
    out_losses, out_gnorms = out["losses"], out["grad_norms"]
    del state, params, leaves, mlp, out
    torch.cuda.empty_cache()
    return {"held": held, "held_launches": held_launches, "held_step_ms": held_ms,
            "counts": counts, "per_step": per_step,
            "losses": out_losses, "grad_norms": out_gnorms, "parts": parts,
            "peak_bytes": peak, "run_s": run_s,
            "radius": radius, "init_norm": init_norm,
            "layer_sparsity": layer_sparsity, "restore_s": restore_s,
            "ckpt_bytes": ck_bytes}


def function_launches():
    """Launch counts of one ``flash`` forward+backward (the Function that
    ``ops.attention`` calls) at granite's attention shape in bf16 and one in
    float32, each counted from 0: ``--only attention``'s launches, since it
    runs no train step. Each type launches its own three kernels once."""
    import torch

    from repro_torch.kernels import _build, flash_attention as flash

    qs, ks, causal, window = GRANITE_ATTN
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    launches = {}
    for dtype, names in ((torch.bfloat16, BF16_FLASH), (torch.float32, F32_FLASH)):
        q, k, v = (torch.randn(s_, generator=g, device="cuda", dtype=dtype
                               ).requires_grad_(True) for s_ in (qs, ks, ks))
        _build.reset_launches()
        flash.flash(q, k, v, causal=causal, window=window).float().sum().backward()
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        print(f"flash Function forward+backward at {qs}/{ks} {str(dtype)[6:]}: "
              "launches " + ", ".join(f"{n} {counts[n]}"
                                      for n in BF16_FLASH + F32_FLASH))
        if any(counts[n] != (n in names) for n in BF16_FLASH + F32_FLASH):
            raise SmokeFailure("flash Function forward+backward: each flash "
                               "kernel of its type should launch once, none other")
        launches |= {n: counts[n] for n in names}
    return launches


def hold_sdpa(tag, sdpa, leaves, q, k, v, o, lse, do, causal=True,
              window=None):
    """SDPA's distance to the plain version at granite's shape (and
    whisper's, non-causal where ``causal`` is False; phase 15's under a
    sliding ``window``), the library
    baseline of rows 12 and 13a/13b: its forward against
    ``flash_attention_plain``'s o and its gradients against
    ``flash_attention_bwd_plain``'s (from the kernel's o and lse). Read and
    printed in both types; in float32 held to the kernels' bars (o within
    2e-5 + 1e-5|b|, each gradient within 1e-5 of its largest entry +
    1e-5|b|). Returns ``{"fwd": err, "bwd": err}``."""
    import torch

    from repro_torch.kernels import flash_attention as flash

    held = q.dtype == torch.float32
    want_o = flash.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)[0]
    got_o = sdpa()
    want = dict(zip(("dq", "dk", "dv"), flash.flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal=causal, window=window)))
    got = dict(zip(("dq", "dk", "dv"), torch.autograd.grad(got_o, leaves, do)))
    if held:
        errs = {"o": check_close(f"SDPA {tag} o", got_o.detach(), want_o, 2.0)}
        errs |= {n: check_close(f"SDPA {tag} {n}", got[n], w,
                                float(w.abs().max())) for n, w in want.items()}
    else:
        errs = {"o": float((got_o.detach().float() - want_o.float()).abs().max())}
        errs |= {n: float((got[n].float() - w.float()).abs().max())
                 for n, w in want.items()}
    how = "held to the kernels' float32 bars" if held else "read"
    print(f"SDPA {tag} {tuple(q.shape)}/{tuple(k.shape)} causal={causal} "
          f"window={window} vs "
          f"the plain version ({how}): " + ", ".join(f"{n} max_abs_err {e:.3e}" for n, e in errs.items()))
    del want_o, got_o, want, got
    return {"fwd": errs["o"], "bwd": max(errs["dq"], errs["dk"], errs["dv"])}


def time_attention(attn_full, attn_case_errs, launches, trn=None):
    """Phase 6's attention rows: each flash kernel at granite's training
    shape in bf16 (the main path's type: the JSON rows) and in float32 (in
    each row under "float32"): the kernel, its plain version, and
    ``scaled_dot_product_attention`` (``enable_gqa``) on the same tensors,
    its backward timed as forward+backward minus forward. The float32
    backward kernels (``flash_bwd_dq_tf32``, ``flash_bwd_dkv_tf32``) also
    get rows of their own, with the device ms of their pre-pass and kernel
    and SDPA's backward kernels by profiler name. Float32 bounds count the
    work at the TF32 rate; the printed line also gives the time of the
    three TF32 products the split issues. The rows take ``launches`` (the
    train step's bf16 counts and the held step's float32 ones, or
    ``function_launches``' under ``--only attention``); with the train
    step's record ``trn`` the flash kernels' share goes into the step's
    parts."""
    import torch

    from repro_torch.kernels import flash_attention as flash
    from repro_torch.roofline import costs as C

    rows = []
    (b, hq, sq, d), (_, hkv, sk, _) = GRANITE_ATTN[0], GRANITE_ATTN[1]
    attn_rows, attn_ms = {}, {}
    f32_rows = []
    for dt, (errs, (q, k, v, do, o, lse, delta)) in attn_full.items():
        tag = str(dt)[6:]
        rate = BF16_OPS_PER_S if dt == torch.bfloat16 else TF32_OPS_PER_S
        qq, kk, vv = (x.detach().clone().requires_grad_(True) for x in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qq, kk, vv, is_causal=True, enable_gqa=True)

        t = {"flash_fwd": event_ms(lambda: flash.flash_attention(q, k, v)),
             "flash_bwd_dq": event_ms(lambda: flash.flash_bwd_dq(
                 q, k, v, do, lse, delta)),
             "flash_bwd_dkv": event_ms(lambda: flash.flash_bwd_dkv(
                 q, k, v, do, lse, delta)),
             "fwd_plain": event_ms(lambda: flash.flash_attention_plain(q, k, v)),
             "bwd_plain": event_ms(lambda: flash.flash_attention_bwd_plain(
                 q, k, v, o, lse, do), reps=5),
             "sdpa_fwd": event_ms(sdpa),
             "sdpa_fwd_bwd": event_ms(lambda: torch.autograd.grad(
                 sdpa(), (qq, kk, vv), do))}
        t["sdpa_bwd"] = t["sdpa_fwd_bwd"] - t["sdpa_fwd"]
        attn_ms[tag] = t
        sdpa_err = hold_sdpa(tag, sdpa, (qq, kk, vv), q, k, v, o, lse, do)
        spec_ = {  # bytes (inputs once, outputs once), operations, plain,
                   # library (roofline/costs.py's table)
            "flash_fwd": (*C.flash_fwd(q, k, True), t["fwd_plain"], t["sdpa_fwd"]),
            "flash_bwd_dq": (*C.flash_bwd_dq(q, k, True), t["bwd_plain"],
                             t["sdpa_bwd"]),
            "flash_bwd_dkv": (*C.flash_bwd_dkv(q, k, True), t["bwd_plain"],
                              t["sdpa_bwd"]),
        }
        for name, (nbytes, nops, plain_ms, lib_ms) in spec_.items():
            bms, by = bound_ms(nbytes, nops, rate)
            err = max(errs[name], attn_case_errs[name, tag])
            attn_rows[name, tag] = {
                "name": name, "workload": f"train {tuple(q.shape)}/"
                f"{tuple(k.shape)} causal {tag}", "route": "cuda",
                "source": "src/repro_torch/csrc/" + (
                    "flash_fwd.cu" if name == "flash_fwd" else "flash_bwd.cu"),
                "replaces": REPLACES[name, False],
                "launches": launches[name],
                "max_abs_err": err, "ms": t[name], "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
                "library_max_abs_err": sdpa_err[
                    "fwd" if name == "flash_fwd" else "bwd"]}
            issued = "" if dt == torch.bfloat16 else (
                f"; 3×TF32 issued {3 * nops / TF32_OPS_PER_S * 1e3:.4f} ms")
            print(f"time {name} {tag} {tuple(q.shape)}/{tuple(k.shape)} causal: "
                  f"{t[name]:.4f} ms (bound {bms:.4f} ms by {by}, "
                  f"{bms / t[name]:.3f} of bound{issued}), plain {plain_ms:.4f} ms, "
                  f"scaled_dot_product_attention {lib_ms:.4f} ms, max_abs_err "
                  f"{err:.3e}")
        if dt == torch.float32:
            # the 3×TF32 backward's own rows: pre-pass and kernel apart, and
            # SDPA's backward kernels (those of forward+backward not in the
            # forward)
            fwd_k = device_kernels(sdpa)
            lib_k = {n: ms for n, ms in device_kernels(lambda: torch.autograd.grad(
                sdpa(), (qq, kk, vv), do)).items() if n not in fwd_k}
            kern = {"flash_bwd_dq": flash.flash_bwd_dq,
                    "flash_bwd_dkv": flash.flash_bwd_dkv}
            for name, fn in kern.items():
                row = dict(attn_rows[name, tag], name=f"{name}_tf32",
                           replaces=REPLACES[f"{name}_tf32", False],
                           launches=launches[f"{name}_tf32"],
                           kernels=device_kernels(lambda fn=fn: fn(
                               q, k, v, do, lse, delta)), library_kernels=lib_k)
                print(f"time {row['name']}: device ms by kernel {row['kernels']}; "
                      f"SDPA backward's {lib_k}")
                f32_rows.append(row)
        del qq, kk, vv
    # the JSON rows are the main path's bf16 launches; the float32 times of
    # the same kernels at the same shape ride along
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        row = dict(attn_rows[name, "bfloat16"])
        row["float32"] = {k_: attn_rows[name, "float32"][k_] for k_ in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "library_max_abs_err")}
        rows.append(row)
    rows += f32_rows
    if trn is None:
        return rows
    tparts = trn["parts"]
    tparts["flash_ms"] = sum(trn["per_step"][k_] * attn_ms["bfloat16"][k_]
                             for k_ in trn["per_step"])
    tparts["fwd_bwd_rest_ms"] = tparts["fwd_bwd_ms"] - tparts["flash_ms"]
    tparts["rest_ms"] = tparts["step_ms"] - tparts["fwd_bwd_ms"] \
        - tparts["epilogue_ms"]
    print(f"train step breakdown (ms): {tparts}")
    return rows


# the mesh executor (phase 7): granite-3-2b's wq and w_up at full width,
# projected by the sharded hook on a ("data", "model") = (1, 4) mesh with
# heads and ffn sharded over "model" (param_rules(fsdp=False))
MESH_ARCH = "granite-3-2b"
# codegen body against plain body: this many 2^-23 · max v, v the outer
# aggregate (wq on an H100: 1.118e-8, 1.6 of them)
THETA_ULPS = 4
MESH_RANKS = 4
MESH_HOOKS = (  # leaf -> (its path under blocks/, the ProjectionSpec's fields)
    ("wq", ("attn", "wq"), dict(pattern=r"wq", levels=(("inf", 1), ("1", 1), ("1", 1)),
                                transpose=True, method="bisect")),
    ("w_up", ("mlp", "w_up"), dict(pattern=r"w_up", levels=(("inf", 1), ("1", 1)),
                                   method="bisect")),
)
# per rank and hook call: the kernels of the sharded codegen body
MESH_LAUNCHES = {"wq": {"codegen_reduce": 1, "codegen_partial_apply": 1,
                        "codegen_apply": 0, "l1ball": 1},
                 "w_up": {"codegen_reduce": 1, "codegen_partial_apply": 0,
                          "codegen_apply": 1, "l1ball": 1}}
# the partial apply alone (phase 7a): wq's local shard in canonical form,
# then ragged cases (batch, canonical shape, reduce norms; level L-2 is the
# second-to-last norm), a NaN, +inf and -inf in item 0 of each
PARTIAL_FULL = (40, (64, 8, 2048), ("inf", "1"))
PARTIAL_CASES = [
    (1, (5, 13, 77), ("inf", "1")),
    (40, (3, 9, 45), ("2", "1")),
    (1, (7, 11, 33), ("1", "1")),
    (40, (4, 8, 40), ("1", "1")),
    (1, (3, 4, 9, 50), ("inf", "inf", "1")),
    (40, (2, 3, 10, 37), ("1", "2", "1")),
    (1, (3, 5, 7, 65), ("2", "1", "1")),
    (40, (2, 3, 5, 33), ("inf", "1", "1")),
]


def partial_apply_inputs(randn, rand, batch, canon, norms, specials):
    """Y (batch, *canon), the plain reduce's aggregates, and radii w shaped
    like the last one (uniform fractions of it, so some groups shrink)."""
    import torch

    from repro_torch.core import schedule
    from repro_torch.kernels.codegen import lowering, tiling

    levels = [(q, 1) for q in norms] + [("1", 1)]
    tp = tiling.plan_tiles(schedule.compile_schedule(canon, levels), torch.float32)
    if tp is None or tp.canon_shape != tuple(canon):
        raise SmokeFailure(f"partial apply {canon}: no tile plan")
    yc = randn((batch,) + tuple(canon))
    if specials:
        flat = yc[0].view(-1)
        flat[3], flat[flat.numel() // 2], flat[-2] = float("nan"), float("inf"), -float("inf")
    aggs, _ = lowering.reduce_plain(yc, list(norms))
    w = (rand(aggs[-1].shape) * 1.2 * aggs[-1]).contiguous()
    return yc, tp, list(norms), aggs, w


def hold_partial_apply(randn, rand):
    """Phase 7a: ``codegen_partial_apply`` (kernel row 9) against
    ``partial_apply_plain`` on the card, at wq's local shard and on the
    ragged cases; then its times at wq's local shard. Returns its JSON row
    without ``launches`` (the mesh phase counts them)."""
    import torch

    from repro_torch.kernels.codegen import lowering
    from repro_torch.roofline import costs as C

    err = 0.0
    for batch, canon, norms in PARTIAL_CASES:
        yc, tp, norms, aggs, w = partial_apply_inputs(randn, rand, batch, canon,
                                                      norms, True)
        got = lowering.codegen_partial_apply(yc, aggs, w, tp, norms)
        torch.cuda.synchronize()
        want = lowering.partial_apply_plain(yc, aggs, w, norms)
        finite = yc[yc.isfinite()]
        e = check_close(f"partial apply {batch}x{canon} {norms}", got, want,
                        float(finite.abs().max()), nonfinite=True)
        print(f"partial apply {batch}x{canon} norms {norms} (NaN, ±inf in Y): "
              f"max_abs_err {e:.3e}")
        err = max(err, e)
    batch, canon, norms = PARTIAL_FULL
    yc, tp, norms, aggs, w = partial_apply_inputs(randn, rand, batch, canon,
                                                  norms, False)
    scale = float(yc.abs().max())
    out = torch.empty_like(yc)
    kern = lambda: lowering.codegen_partial_apply(yc, aggs, w, tp, norms, out=out)  # noqa: E731
    plain = lambda: lowering.partial_apply_plain(yc, aggs, w, norms)  # noqa: E731
    w_b, lo_b = w[:, None], -w[:, None]
    lib = lambda: torch.clamp(yc, lo_b, w_b)  # noqa: E731
    got = kern().clone()
    torch.cuda.synchronize()
    e = check_close(f"partial apply full {batch}x{canon}", got, plain(), scale)
    if not torch.equal(got, lib()):  # ℓ∞ at level L-2: the clamp itself
        raise SmokeFailure("partial apply full: not equal to torch.clamp")
    print(f"partial apply full {batch}x{canon} norms {norms}: max_abs_err {e:.3e}, "
          "equal to torch.clamp(y, -w, w)")
    err = max(err, e)
    del got
    plain_ms = event_ms(plain)
    ms = event_ms(kern)
    dev_ms = graph_ms(kern)
    lib_ms = event_ms(lib)
    # Y read and X written once, w read once; v1 only where an ℓ2 at level
    # L-2 rescales by it (an ℓ∞ clamps to ±w, an ℓ1 thresholds Y's group)
    nbytes, nops = C.codegen_partial_apply(
        yc.numel(), w.numel(), aggs[0].numel() if norms[0] == "2" else 0)
    bms, by = bound_ms(nbytes, nops)
    print(f"time codegen_partial_apply {batch}x{canon}: {ms:.4f} ms (bound "
          f"{bms:.4f} ms by {by}, {bms / ms:.2f} of bound; CUDA-graph replay "
          f"{dev_ms:.4f} ms, {bms / dev_ms:.2f} of bound), plain {plain_ms:.4f} "
          f"ms, torch.clamp {lib_ms:.4f} ms, max_abs_err {err:.3e}")
    return {"name": "codegen_partial_apply",
            "workload": f"wq local shard {batch}x{canon} f32",
            "route": "cuda", "source": "src/repro_torch/csrc/codegen_apply.cu",
            "replaces": REPLACES["codegen_partial_apply", False],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            "graph_ms": dev_ms}


def _layer_stats(x, levels, names, mesh, batch):
    """Per-layer norm of ``x`` under ``levels`` (its leading ``batch`` axes
    are layers) and the share of the outer level's groups that are zero;
    ``names`` shard axes over ``mesh`` (None: ``x`` is whole). Reduces
    with the mesh's collectives where a level spans a sharded axis."""
    import torch

    cur, cur_names = x, list(names)
    zero = None
    for i, (q, k) in enumerate(levels):
        axes = tuple(range(batch, batch + k)) if i < len(levels) - 1 \
            else tuple(range(batch, cur.ndim))
        if i == len(levels) - 1:  # the outer level's groups: zero or not
            outer = [cur_names[a] for a in axes if cur_names[a]]
            zeros = (cur == 0).flatten(batch).sum(-1).to(cur.dtype)
            zeros = mesh.psum(zeros, outer) if outer else zeros
            total = cur[(0,) * batch].numel() * (mesh.axis_size(outer) if outer else 1)
            zero = zeros / total
        a = cur.abs()
        v = a.sum(axes) if q == "1" else (a * a).sum(axes) if q == "2" else a.amax(axes)
        coll = [cur_names[ax] for ax in axes if cur_names[ax]]
        if coll:
            v = mesh.pmax(v, coll) if q == "inf" else mesh.psum(v, coll)
        cur = torch.sqrt(v) if q == "2" else v
        cur_names = [n for ax, n in enumerate(cur_names) if ax not in axes]
    return cur, zero


def mesh_rank(rank, world, backend, tmp):
    """One rank of phase 7 (``torch.multiprocessing`` spawns it): joins the
    world, builds granite-3-2b's full wq and w_up from the seed, keeps its
    shard, and projects it through ``make_projection_hook(spec, mesh=,
    param_specs=)`` with the codegen body (the main path: launch counts and
    collective counts from zero) and the plain body. Checks each shard;
    writes its numbers to ``<tmp>/rank<rank>.json``."""
    import datetime

    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.configs.types import ProjectionSpec
    from repro_torch.core import schedule, sharded
    from repro_torch.kernels import _build, l1ball
    from repro_torch.kernels.codegen import lowering, tiling
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.models.params import init_params, param_specs
    from repro_torch.optim.projection_hook import make_projection_hook
    from repro_torch.parallel import sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300),
                            device_id=dev if backend == "nccl" else None)
    mesh = make_host_mesh(1, world)
    blocks = lm.template(get_arch(MESH_ARCH))["blocks"]
    specs = param_specs({"blocks": blocks}, sharding.param_rules(mesh, fsdp=False),
                        sharding.mesh_shape_dict(mesh))
    out = {"rank": rank, "leaves": {}}
    local, refs, pspecs = {}, {}, {}
    for leaf, (grp, name), fields in MESH_HOOKS:
        levels = fields["levels"]
        full = init_params({"blocks": {grp: {name: blocks[grp][name]}}}, SEED,
                           device=dev)["blocks"][grp][name]
        spec = specs["blocks"][grp][name]
        perm = (0,) + tuple(reversed(range(1, full.ndim))) \
            if fields.get("transpose") else tuple(range(full.ndim))
        view = full.permute(perm)
        norms0, _ = _layer_stats(view, levels, (None,) * full.ndim, mesh, 1)
        radius = RADIUS_FRACTION * float(norms0.min())
        # the single-device generated pipeline on the whole leaf, and its
        # outer aggregate (the interval [0, max] the outer θ-bisection walks)
        whole = view.contiguous()
        gen = lowering.generate(schedule.compile_schedule(view.shape, levels, 1),
                                torch.float32, method="bisect")
        ref = gen(whole, radius).permute(perm)
        qs = [q for q, _ in levels]
        tp = tiling.plan_tiles(schedule.compile_schedule(view.shape[1:], levels),
                               torch.float32)
        _, vfin = lowering.codegen_reduce(
            whole.reshape((whole.shape[0],) + tp.canon_shape), tp, qs[:-1])
        refs[leaf] = sharding.shard(ref, spec, mesh)
        local[leaf] = sharding.shard(full, spec, mesh)
        pspecs[leaf] = ProjectionSpec(radius=radius, **fields)
        out["leaves"][leaf] = {"shape": list(full.shape), "spec": list(spec),
                               "local_shape": list(local[leaf].shape),
                               "radius": radius, "scale": float(full.abs().max()),
                               "outer_aggregate_max": float(vfin.max()),
                               "init_norm_min": float(norms0.min())}
        del full, view, ref, whole, vfin
        torch.cuda.empty_cache()
    params = {"blocks": {grp: {name: local[leaf]} for leaf, (grp, name), _ in MESH_HOOKS}}

    def hook(leaf, backend_):
        return make_projection_hook(pspecs[leaf], mesh=mesh, param_specs=specs,
                                    backend=backend_)

    results = {}
    for body in ("codegen", "plain"):  # the main path first
        for leaf, (grp, name), fields in MESH_HOOKS:
            h = hook(leaf, body)
            torch.cuda.synchronize()
            dist.barrier()
            _build.reset_launches()
            mesh.reset_counts()
            mark = tile_search_mark()
            x = h(params, 0)["blocks"][grp][name]
            torch.cuda.synchronize()
            counts = _build.launch_counts()
            # the first call tunes the shard's tile plan (codegen's
            # autotune_tiles): those launches are the search's, held to its
            # protocol and apart
            search = check_search(f"rank {rank} {leaf} {body}", mark)
            results[body, leaf] = x
            o = out["leaves"][leaf]
            o[f"{body}_collectives"] = mesh.counts()
            o[f"{body}_launches"] = {k: counts[k] - search.get(k, 0)
                                     for k in MESH_LAUNCHES[leaf]}
            o[f"{body}_search_launches"] = search
            # a second call of the same workload: the cached verdict, no search
            _build.reset_launches()
            h(params, 0)
            torch.cuda.synchronize()
            if any(_build.search_counts().values()):
                raise SmokeFailure(f"rank {rank} {leaf} {body}: the second call "
                                   f"searched again {_build.search_counts()}")
            counts = _build.launch_counts()
            o[f"{body}_launches_again"] = {k: counts[k] for k in MESH_LAUNCHES[leaf]}
    for leaf, (grp, name), fields in MESH_HOOKS:
        o = out["leaves"][leaf]
        levels, scale = fields["levels"], o["scale"]
        x, xp = results["codegen", leaf], results["plain", leaf]
        # the bodies sum the outer aggregate v and the outer θ-bisection's φ
        # in other orders (the kernels' against PyTorch's), so θ lands a few
        # of its ulps apart, and ulp(θ) <= 2^-23 · max v on [0, max v]
        bar = THETA_ULPS * 2.0 ** -23 * o["outer_aggregate_max"]
        o["codegen_vs_plain_bar"] = bar
        o["codegen_vs_plain"] = check_close(
            f"rank {rank} {leaf} codegen vs plain", x, xp, 1e5 * bar, rtol=0.0)
        for body, got in (("codegen", x), ("plain", xp)):
            o[f"{body}_vs_single_device"] = check_close(
                f"rank {rank} {leaf} {body} body vs the single-device projection",
                got, refs[leaf], scale, rtol=0.0)
        want = dict(MESH_LAUNCHES[leaf])
        for again in ("", "_again"):
            if o[f"codegen_launches{again}"] != want:
                raise SmokeFailure(f"rank {rank} {leaf}: launches "
                                   f"{o[f'codegen_launches{again}']} != {want}")
        if any(o["plain_launches"].values()) or any(o["plain_launches_again"].values()):
            raise SmokeFailure(f"rank {rank} {leaf}: the plain body launched "
                               f"{o['plain_launches']}")
        perm = (0,) + tuple(reversed(range(1, x.ndim))) \
            if fields.get("transpose") else tuple(range(x.ndim))
        names = tuple(o["spec"][a] for a in perm)
        vshape = [o["shape"][a] for a in perm]
        model = sharded.sharded_collective_bytes(vshape, levels, names, mesh,
                                                 batch_dims=1)
        o["model"] = {"calls": model["schedule_calls"],
                      "bytes": model["schedule_bytes"],
                      "per_step": model["per_step"]}
        for body in ("codegen", "plain"):
            got = o[f"{body}_collectives"]
            if (got["calls"], got["bytes"]) != (model["schedule_calls"],
                                                model["schedule_bytes"]):
                raise SmokeFailure(f"rank {rank} {leaf} {body}: collectives "
                                   f"{got} != the model {o['model']}")
        norms, zero = _layer_stats(x.permute(perm), levels, names, mesh, 1)
        r = o["radius"]
        slack = r * RTOL + vshape[-1] * 2.0 ** -23 * scale
        o["max_norm_over_radius"] = float((norms / r).max())
        if not bool((norms <= r + slack).all()):
            raise SmokeFailure(f"rank {rank} {leaf}: a layer's norm "
                               f"{float(norms.max())} > radius {r} + {slack}")
        o["zero_groups_pct"] = [float(zero.min()) * 100, float(zero.max()) * 100]
        if not bool(((zero > 0) & (zero < 1)).all()):
            raise SmokeFailure(f"rank {rank} {leaf}: a layer is empty or whole "
                               f"(zero outer groups {o['zero_groups_pct']} %)")

    # times: one sharded hook call per leaf and body, and the wq path's
    # distributed bisection alone, every rank in lock-step
    for leaf, (grp, name), _ in MESH_HOOKS:
        for body in ("codegen", "plain"):
            h = hook(leaf, body)
            dist.barrier()
            out["leaves"][leaf][f"{body}_hook_ms"] = event_ms(lambda: h(params, 0))
    fields = MESH_HOOKS[0][2]
    yt = local["wq"].permute(0, 3, 2, 1).contiguous()
    norms_ = [q for q, _ in fields["levels"]]
    tp = tiling.plan_tiles(schedule.compile_schedule(yt.shape[1:], fields["levels"]),
                           torch.float32)
    yc = yt.reshape((yt.shape[0],) + tp.canon_shape)
    aggs, acc = lowering.codegen_reduce(yc, tp, norms_[:-1], raw=True)
    vfin = mesh.psum(acc, ("model",))
    radii = torch.full((yc.shape[0],), pspecs["wq"].radius, device=dev)
    u = l1ball.project_l1_batched(vfin, radii)
    dist.barrier()
    out["bisection_ms"] = event_ms(lambda: sharded._grouped_l1_collective(
        aggs[-1], u, (1,), ("model",), vfin, mesh))
    out["bisection_shape"] = list(aggs[-1].shape)
    dist.barrier()
    dist.destroy_process_group()
    (tmp / f"rank{rank}.json").write_text(json.dumps(out))


def mesh_phase(backend):
    """Phase 7: four ranks project granite-3-2b's wq and w_up through the
    sharded hook (``mesh_rank``); every rank's checks must pass. Returns the
    ranks' numbers, rank 0 first."""
    import torch
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    tmp = ROOT / "build" / "chip_smoke_mesh"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        mp.start_processes(mesh_rank, args=(MESH_RANKS, backend, tmp),
                           nprocs=MESH_RANKS, join=True, start_method="spawn")
    except ProcessException as e:
        raise SmokeFailure(f"mesh phase: a rank failed:\n{e}") from None
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(MESH_RANKS)]
    shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t0
    for leaf, _, _ in MESH_HOOKS:
        for o in ranks:
            lo = o["leaves"][leaf]
            print(f"mesh rank {o['rank']} {leaf} {tuple(lo['shape'])} spec "
                  f"{tuple(lo['spec'])} shard {tuple(lo['local_shape'])}: "
                  f"codegen vs plain {lo['codegen_vs_plain']:.3e} (bar "
                  f"{lo['codegen_vs_plain_bar']:.3e}), vs the single-device "
                  f"projection {lo['codegen_vs_single_device']:.3e} codegen, "
                  f"{lo['plain_vs_single_device']:.3e} plain "
                  f"(max|Y| {lo['scale']:.4e}, outer aggregate max "
                  f"{lo['outer_aggregate_max']:.4e}); launches {lo['codegen_launches']}; "
                  f"collectives {lo['codegen_collectives']['calls']} calls "
                  f"{lo['codegen_collectives']['bytes']} bytes (model "
                  f"{lo['model']['calls']} calls {lo['model']['bytes']} bytes); "
                  f"every layer feasible (max norm/radius "
                  f"{lo['max_norm_over_radius']:.7f}), zero outer groups "
                  f"{min(lo['zero_groups_pct']):.2f}–{max(lo['zero_groups_pct']):.2f} %; "
                  f"hook call {lo['codegen_hook_ms']:.3f} ms codegen, "
                  f"{lo['plain_hook_ms']:.3f} ms plain")
    per_rank = ", ".join(f"{o['bisection_ms']:.3f}" for o in ranks)
    print(f"mesh distributed bisection {tuple(ranks[0]['bisection_shape'])}, 64 "
          f"steps: {per_rank} ms (ranks 0–{MESH_RANKS - 1})")
    print(f"mesh phase: {MESH_RANKS} ranks over {backend}, {seconds:.1f} s wall")
    torch.cuda.synchronize()
    return ranks, seconds


# sharded training (phase 9): launch/train.py's step on a ("data", "model")
# = (2, 2) mesh (tensor parallel over "model", FSDP over "data") of
# granite-3-2b at full width, phase 5's batch, microbatch and sequence, the
# bi-level constraint on (w_up|w_gate) at phase 5's radius
MESH_TRAIN_SIZES = (2, 2)
MESH_TRAIN_F32 = (2, 2)          # (a): layers, steps; float32 compute
MESH_TRAIN_BF16_STEPS = 3        # (b): bf16 compute, the launcher's CLI
# (b)'s depth: four ranks on one card share its 80 GB (about 11 GB a rank
# at 20 layers), and 4 layers (8 before PR 32) keep the whole script in its
# time limit with phase 16's MoE family; on four cards the full 40
MESH_TRAIN_LAYERS = {"gloo": 4, "nccl": 40}
MESH_TRAIN_RTOL = {"f32": 1e-4, "bf16": 2e-2}
# per rank and step, the sharded hook's kernels on w_up and w_gate: the
# bi-level ν with both trailing axes sharded ((None, "data", "model")) is
# the pmax + gather path: reduce, l1ball, apply, and no partial apply
MESH_TRAIN_HOOK = {"codegen_reduce": 2, "l1ball": 2, "codegen_apply": 2,
                   "codegen_partial_apply": 0}
# (c): GSP whole-network sparsification on a (1, 4) mesh against one device
MESH_GSP_SIZES = (1, 4)
# sharded against one device, per compute dtype: (loss rtol, per-leaf
# column sparsity in points). float32: sums in another order only. bf16 (the
# JAX package's setting): the sharded forward sums its bf16 partial products
# over ranks, AdamW's first steps (lr 1e-3) carry gradients that round the
# other way into the weights, and a column whose norm lies within that of
# its level's threshold goes either way: the CPU runs differ by 1-2 of the
# smoke unembedding's 256 columns (tests/test_torch_gsp.py), an H100 by 3
# (1.17 points) with the loss 2.2e-5 apart. The bars must catch a skipped
# psum over "model" in enter's backward, which (c) runs on every call
# (``skipped_enter_psum``): on the CPU it moves a leaf by 5.47 (bf16) and
# 6.64 (float32) points and the loss by 4.3e-5 / 3.6e-5
# (tests/test_torch_gsp.py); the card's readings are printed
MESH_GSP_TOL = {"float32": (1e-5, 0.1), "bfloat16": (1e-4, 2.0)}


def _mesh_train_tcfg(layers, steps, radius, compute):
    """(cfg, tcfg, pipeline) of a phase 9 run at ``layers``: the
    launcher's TrainConfig with ``compute``."""
    from repro_torch.configs import registry
    from repro_torch.configs.types import ProjectionSpec, TrainConfig
    from repro_torch.data import DataConfig, DataPipeline

    cfg = dataclasses.replace(registry.get_arch(TRAIN_ARCH), n_layers=layers)
    _, batch, micro, seq = train_args()
    tcfg = TrainConfig(microbatch=micro, total_steps=steps,
                       warmup=min(20, steps // 5 + 1), remat=True,
                       master_dtype="", compute_dtype=compute,
                       projection=ProjectionSpec(pattern=r"(w_up|w_gate)",
                                                 radius=radius))
    pipe = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq + 1,
                                   global_batch=batch, microbatch=micro))
    return cfg, tcfg, pipe


def _digest(t):
    import hashlib

    return hashlib.sha1(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def _mlp_moments(state):
    """w_up's and w_gate's AdamW moments, on the host."""
    return {k: (state["opt"]["m"]["blocks"]["mlp"][k].cpu(),
                state["opt"]["v"]["blocks"]["mlp"][k].cpu())
            for k in ("w_up", "w_gate")}


@contextlib.contextmanager
def skipped_enter_psum():
    """A fault phase 9 (c) must catch: ``collectives.enter``'s backward
    returns this rank's own gradient, without the psum over "model"."""
    from repro_torch.parallel import collectives

    keep = collectives._Enter.backward
    collectives._Enter.backward = staticmethod(lambda ctx, g: (g, None, None))
    try:
        yield
    finally:
        collectives._Enter.backward = keep


def gsp_gap(got, want):
    """(largest per-leaf column sparsity gap in points, loss relative gap)
    of two GSP records."""
    gap = max(abs(got["per_leaf_sparsity"][k] - v)
              for k, v in want["per_leaf_sparsity"].items())
    return gap, abs(got["loss"] - want["loss"]) / abs(want["loss"])


def mesh_train_shapes(layers):
    """The shapes phase 9's sharded step gives its kernels on each rank,
    read from the mesh's specs: flash's q and k/v (B, H, S, hd) of a
    micro-batch's slice over the batch axes and the rank's heads
    (granite's 8 kv heads shard over "model" as its 32 q heads do), and
    w_up's (and w_gate's) shard (L, d / D, ffn / M)."""
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.models.params import param_specs
    from repro_torch.parallel import sharding

    cfg = dataclasses.replace(registry.get_arch(TRAIN_ARCH), n_layers=layers)
    sizes = dict(zip(("data", "model"), MESH_TRAIN_SIZES))
    tpl = lm.template(cfg)["blocks"]
    specs = param_specs(tpl, sharding.param_rules(sizes), sizes)

    def local(grp, name):
        return sharding.local_shape(tpl[grp][name].shape, specs[grp][name], sizes)

    _, batch, micro, seq = train_args()
    mb = sharding.local_shape((batch // micro, micro, seq),
                              sharding.tokens_spec(sizes, None, micro), sizes)[1]
    h, hd = local("attn", "wq")[-2:]
    return ((mb, h, seq, hd), (mb, local("attn", "wk")[-2], seq, hd),
            cfg.window, local("mlp", "w_up"))


def hold_mesh_train_kernels(randn, rand, depths):
    """Phase 9's kernels against their plain versions at the shapes its
    path gives them on each rank (``mesh_train_shapes``), with phase 1's
    bars: the flash forward, dQ and dK/dV in float32 ((a)'s compute) and
    bf16 ((b)'s), and the sharded hook's kernels on w_up's shard at each
    of ``depths``: ``codegen_reduce`` (raw, as the hook takes it before its
    pmax over "data"), ``l1ball`` on the aggregate gathered over "model"
    (radii RADIUS_FRACTION of each layer's sum) and ``codegen_apply`` with
    this shard's columns of its radii. Returns {kernel: max error} and the
    event ms of each kernel and its plain version at the last depth."""
    import torch

    from repro_torch.core import schedule
    from repro_torch.kernels import flash_attention as flash, l1ball
    from repro_torch.kernels.codegen import lowering, tiling

    errs, times = {}, {}

    def keep(name, e):
        errs[name] = max(errs.get(name, 0.0), e)

    qs, ks, window, _ = mesh_train_shapes(depths[-1])
    for dtype in (torch.float32, torch.bfloat16):
        e, (q, k, v, do, o, lse, delta) = hold_attention(
            randn, "train mesh local", qs, ks, True, window, dtype)
        tag = str(dtype)[6:]
        for name, err in e.items():
            keep(f"{name} {tag}", err)
        opts = dict(causal=True, window=window)
        times[f"flash {tag}"] = {
            "fwd_ms": event_ms(lambda: flash.flash_attention(q, k, v, **opts)),
            "dq_ms": event_ms(lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta,
                                                         **opts)),
            "dkv_ms": event_ms(lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                           **opts)),
            "plain_fwd_ms": event_ms(lambda: flash.flash_attention_plain(
                q, k, v, **opts)),
            "plain_bwd_ms": event_ms(lambda: flash.flash_attention_bwd_plain(
                q, k, v, o, lse, do, **opts))}
        del q, k, v, do, o, lse, delta
    norms = [n for n, _ in BILEVEL]
    parts = MESH_TRAIN_SIZES[1]                      # the "model" gather
    for layers in depths:
        w_loc = mesh_train_shapes(layers)[3]
        tag = f"train mesh w_up shard {w_loc}"
        tp = tiling.plan_tiles(schedule.compile_schedule(w_loc[1:], BILEVEL),
                               torch.float32)
        yc = randn((w_loc[0],) + tp.canon_shape)
        aggs, acc = lowering.codegen_reduce(yc, tp, norms[:-1], raw=True)
        vfin = lowering.finalize(norms[-2], acc)
        torch.cuda.synchronize()
        aggs_p, vfin_p = lowering.reduce_plain(yc, norms[:-1])
        keep("codegen_reduce", max([check_close(f"{tag} reduce", vfin, vfin_p,
                                                fmax(vfin_p))]
                                   + [check_close(f"{tag} reduce v{t + 1}", a, b,
                                                  fmax(b))
                                      for t, (a, b) in enumerate(zip(aggs, aggs_p))]))
        del aggs, acc, vfin
        vg = torch.cat([vfin_p] + [lowering.reduce_plain(
            randn(yc.shape), norms[:-1])[1] for _ in range(parts - 1)], dim=1)
        radii = RADIUS_FRACTION * vg.sum(1)
        u = l1ball.project_l1_batched(vg, radii)
        torch.cuda.synchronize()
        u_p = l1ball.project_l1_plain(vg, radii)
        keep("l1ball", check_close(f"{tag} l1ball {tuple(vg.shape)}", u, u_p,
                                   fmax(vg)))
        u_loc = u_p[:, :vfin_p.shape[1]].contiguous()
        x = lowering.codegen_apply(yc, aggs_p, vfin_p, u_loc, tp, norms[:-1])
        torch.cuda.synchronize()
        keep("codegen_apply", check_close(
            f"{tag} apply", x, lowering.apply_plain(yc, aggs_p, vfin_p, u_loc,
                                                   norms[:-1]), fmax(yc)))
        del x
        if layers == depths[-1]:
            out = torch.empty_like(yc)
            for name, kern, plain in (
                    ("codegen_reduce",
                     lambda: lowering.codegen_reduce(yc, tp, norms[:-1], raw=True),
                     lambda: lowering.reduce_plain(yc, norms[:-1])),
                    ("l1ball", lambda: l1ball.project_l1_batched(vg, radii),
                     lambda: l1ball.project_l1_plain(vg, radii)),
                    ("codegen_apply",
                     lambda: lowering.codegen_apply(yc, aggs_p, vfin_p, u_loc, tp,
                                                    norms[:-1], out=out),
                     lambda: lowering.apply_plain(yc, aggs_p, vfin_p, u_loc,
                                                  norms[:-1]))):
                times[f"{name} {tuple(w_loc)}"] = {"ms": event_ms(kern),
                                                   "plain_ms": event_ms(plain)}
            del out
        del yc, aggs_p, vfin_p, vg, u, u_p, u_loc
        torch.cuda.empty_cache()
    print(f"train mesh kernels at the ranks' shapes (q {qs}, kv {ks}; w_up "
          f"shards at {list(depths)} layers) vs their plain versions: "
          + ", ".join(f"{k_} max_abs_err {v_:.3e}" for k_, v_ in errs.items()))
    print(f"train mesh kernel times at the ranks' shapes (events, ms): {times}")
    return errs, times


def train_mesh_rank(rank, world, backend, tmp, radius, layers):
    """One rank of phase 9 (``torch.multiprocessing`` spawns it): (a) the
    sharded float32 step from the seed, (b) ``launch.train.run`` on the
    2x2 mesh in bf16, (c) GSP on a (1, 4) mesh, correct and with
    ``skipped_enter_psum``; writes its numbers to
    ``<tmp>/rank<rank>.json`` and its float32 w_up/w_gate shards to
    ``<tmp>/rank<rank>.pt``."""
    import datetime

    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch import _tree, models
    from repro_torch.kernels import _build
    from repro_torch.launch import train as train_cli
    from repro_torch.models.params import param_specs
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import Mesh
    from repro_torch.training import init_state, make_train_step
    from repro_torch.training.sae_factory import _gsp
    from repro_torch.training.step import step_collectives

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600),
                            device_id=dev if backend == "nccl" else None)
    mesh = Mesh(MESH_TRAIN_SIZES, ("data", "model"))
    out = {"rank": rank, "coords": mesh.coords}

    # (a) float32: the step the launcher builds, on its shards of the seed
    f_layers, f_steps = MESH_TRAIN_F32
    cfg, tcfg, pipe = _mesh_train_tcfg(f_layers, f_steps, radius, "float32")
    api = models.get(cfg)
    specs = param_specs(api.template(cfg), sharding.param_rules(mesh),
                        sharding.mesh_shape_dict(mesh))
    state = init_state(cfg, tcfg, api, tcfg.seed, device=dev, mesh=mesh,
                       param_specs=specs)
    step = make_train_step(cfg, tcfg, api, impl="flash", mesh=mesh,
                           param_specs=specs)
    a = {"losses": [], "grad_norms": [], "collectives": []}
    moments = []
    _build.reset_launches()
    mark = tile_search_mark()
    for i in range(f_steps):
        mesh.reset_counts()
        state, m = step(state, {"tokens": torch.from_numpy(pipe.batch(i)).to(dev)})
        torch.cuda.synchronize()
        a["collectives"].append(mesh.counts()["by_op"])
        a["losses"].append(float(m["loss"]))
        a["grad_norms"].append(float(m["grad_norm"]))
        moments.append(_mlp_moments(state))
    a["launches"] = _build.launch_counts()
    # the first step tunes each shard workload's tile plan, once in all
    a["search_launches"] = check_search(f"rank {rank} f32 train steps", mark)
    a["model"] = step_collectives(cfg, tcfg, specs, mesh, pipe.batch(0).shape)
    a["digests"] = {key: {name: _digest(x) for name, x in _tree.leaves_with_paths(
        state["params"] if key == "params" else state["opt"][key])}
        for key in ("params", "m", "v")}
    a["specs"] = {name: list(sp) for name, sp in _tree.leaves_with_paths(specs)}
    torch.save({"params": {k: state["params"]["blocks"]["mlp"][k].cpu()
                           for k in ("w_up", "w_gate")}, "moments": moments},
               tmp / f"rank{rank}.pt")
    out["f32"] = a
    del state, step
    torch.cuda.empty_cache()

    # (b) bf16: the launcher's CLI on the 2x2 mesh
    argv = TRAIN_ARGV[:-4] + ["--steps", str(MESH_TRAIN_BF16_STEPS),
                              "--radius", repr(radius), "--layers", str(layers),
                              "--mesh", "x".join(map(str, MESH_TRAIN_SIZES))]
    torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    _build.reset_launches()
    mark = tile_search_mark()
    run = train_cli.run(argv)
    torch.cuda.synchronize()
    # the main path's launches: the tile search's (the first step tunes
    # each new shard workload's plan, once over all the steps) apart
    search = check_search(f"rank {rank} bf16 train CLI", mark)
    counts = {k: n - search.get(k, 0) for k, n in _build.launch_counts().items()}
    cfg, tcfg, pipe = _mesh_train_tcfg(layers, MESH_TRAIN_BF16_STEPS, radius,
                                       "bfloat16")
    specs = param_specs(api.template(cfg), sharding.param_rules(mesh),
                        sharding.mesh_shape_dict(mesh))
    out["bf16"] = {"argv": argv, "losses": run["losses"],
                   "grad_norms": run["grad_norms"],
                   "step_seconds": run["step_seconds"],
                   "collectives": [c["by_op"] for c in run["collectives"]],
                   "model": step_collectives(cfg, tcfg, specs, mesh,
                                             pipe.batch(0).shape),
                   "launches": counts,
                   "search_launches": search,
                   "peak_bytes": torch.cuda.max_memory_allocated(dev),
                   "sparsity": run["sparsity"]}
    del run
    torch.cuda.empty_cache()

    # (c) GSP whole-network sparsification on a (1, 4) mesh, then again
    # with a fault its check must catch
    gmesh = Mesh(MESH_GSP_SIZES, ("data", "model"))
    out["gsp"] = {dt: _gsp(mesh=gmesh, device=dev, compute_dtype=dt)
                  for dt in MESH_GSP_TOL}
    with skipped_enter_psum():
        out["gsp_fault"] = {dt: _gsp(mesh=gmesh, device=dev, compute_dtype=dt)
                            for dt in MESH_GSP_TOL}
    dist.barrier()
    dist.destroy_process_group()
    (tmp / f"rank{rank}.json").write_text(json.dumps(out))


def train_mesh_phase(dev, backend, randn, rand):
    """Phase 9: its kernels at the ranks' shapes
    (``hold_mesh_train_kernels``), the single-device references (the
    unfused float32 step at MESH_TRAIN_F32's depth; the bf16 launcher at
    (b)'s; GSP), then four ranks (``train_mesh_rank``), then every hold.
    Returns the JSON record and each rank's launches on the bf16 main
    path."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    from repro_torch import models
    from repro_torch.configs.types import ProjectionSpec
    from repro_torch.launch import train as train_cli
    from repro_torch.parallel import sharding
    from repro_torch.training import init_state, make_train_step
    from repro_torch.training.sae_factory import _gsp, constraint_report

    layers = MESH_TRAIN_LAYERS[backend]
    f_layers, f_steps = MESH_TRAIN_F32
    kernel_errs, kernel_times = hold_mesh_train_kernels(randn, rand,
                                                        (f_layers, layers))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    radius, _ = train_radius(dev)
    cfg, tcfg, pipe = _mesh_train_tcfg(f_layers, f_steps, radius, "float32")
    api = models.get(cfg)
    state = init_state(cfg, tcfg, api, tcfg.seed, device=dev)
    step = make_train_step(cfg, tcfg, api, impl="flash", fused=False)
    ref = {"losses": [], "grad_norms": [], "lr": []}
    ref_moments = []
    for i in range(f_steps):
        state, m = step(state, {"tokens": torch.from_numpy(pipe.batch(i)).to(dev)})
        ref["losses"].append(float(m["loss"]))
        ref["grad_norms"].append(float(m["grad_norm"]))
        ref["lr"].append(float(m["lr"]))
        ref_moments.append(_mlp_moments(state))
    ref_mlp = {k: state["params"]["blocks"]["mlp"][k] for k in ("w_up", "w_gate")}
    del state, step
    torch.cuda.empty_cache()
    # the single-device bf16 launcher at (b)'s depth
    argv1 = TRAIN_ARGV[:-4] + ["--steps", str(MESH_TRAIN_BF16_STEPS),
                               "--radius", repr(radius), "--layers", str(layers)]
    torch.cuda.reset_peak_memory_stats(dev)
    one = train_cli.run(argv1)
    one_peak = torch.cuda.max_memory_allocated(dev)
    one.pop("state")
    torch.cuda.empty_cache()
    gsp_one = {dt: _gsp(device=dev, compute_dtype=dt) for dt in MESH_GSP_TOL}
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0

    tmp = ROOT / "build" / "chip_smoke_train_mesh"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    t1 = time.perf_counter()
    try:
        mp.start_processes(train_mesh_rank, args=(MESH_RANKS, backend, tmp,
                                                  radius, layers),
                           nprocs=MESH_RANKS, join=True, start_method="spawn")
    except ProcessException as e:
        raise SmokeFailure(f"train mesh phase: a rank failed:\n{e}") from None
    ranks_s = time.perf_counter() - t1
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(MESH_RANKS)]
    shards = [torch.load(tmp / f"rank{r}.pt") for r in range(MESH_RANKS)]
    shutil.rmtree(tmp, ignore_errors=True)
    sizes = dict(zip(("data", "model"), MESH_TRAIN_SIZES))

    fails = []

    def fail(msg):
        print(f"train mesh FAILED: {msg}")
        fails.append(msg)

    # (a) float32 against the single-device unfused step
    rt = MESH_TRAIN_RTOL["f32"]
    for o in ranks:
        a = o["f32"]
        for k_ in ("losses", "grad_norms"):
            if not np.allclose(a[k_], ref[k_], rtol=rt, atol=0):
                fail(f"f32 rank {o['rank']} {k_} {a[k_]} vs one device {ref[k_]}")
            if a[k_] != ranks[0]["f32"][k_]:
                fail(f"f32 rank {o['rank']} {k_} differ from rank 0's")
        want = {op: {"calls": a["model"]["calls"][op], "bytes": a["model"]["bytes"][op]}
                for op in a["model"]["calls"]}
        if any(c != want for c in a["collectives"]):
            fail(f"f32 rank {o['rank']}: collectives {a['collectives']} != "
                 f"the model {want}")
        if not all(a["launches"][k_] for k_ in F32_FLASH):
            fail(f"f32 rank {o['rank']}: launches {a['launches']}")
    specs = ranks[0]["f32"]["specs"]
    mlp_err, mlp_slack, mom_err = {}, {}, {}
    spec = ProjectionSpec(pattern=r"(w_up|w_gate)", radius=radius)
    b1, b2 = tcfg.beta1, tcfg.beta2

    def unit(mv, t):  # AdamW's normalised update at step t
        m_, v_ = mv
        return (m_ / (1 - b1 ** t)) / (torch.sqrt(v_ / (1 - b2 ** t)) + tcfg.eps)

    for k_ in ("w_up", "w_gate"):
        sp = tuple(specs[f"blocks/mlp/{k_}"])
        mv = [tuple(sharding.unshard_tree([s_["moments"][t][k_][j] for s_ in shards],
                                          sp, sizes) for j in (0, 1))
              for t in range(f_steps)]
        # the moments hold the sharded gradients: each step's m and v within
        # 1e-4 of their largest entry
        mom_err[k_] = {}
        for t in range(f_steps):
            for j, what in enumerate(("m", "v")):
                want_ = ref_moments[t][k_][j]
                e = float((mv[t][j] - want_).abs().max()) / float(want_.abs().max())
                mom_err[k_][f"{what}{t + 1}"] = e
                if not e <= rt:
                    fail(f"f32 {k_} step {t + 1} {what}: {e:.3e} of its largest "
                         f"entry from one device")
        full = sharding.unshard_tree([s_["params"][k_] for s_ in shards], sp, sizes)
        want = ref_mlp[k_].cpu()
        scale = float(want.abs().max())
        err = float((full - want).abs().max())
        # AdamW's own sensitivity (hold_train_step's rule): Σ_t lr_t |Δu_t|
        # from the two runs' moments, read only where the first step's
        # gradient lies within 1e3 eps of 0 (there g / (|g| + eps) turns on
        # the gradient's last bits; elsewhere the moments' hold bounds Δu),
        # and 3 × its largest entry on a projected leaf (the clip moves with
        # its column's max and with θ)
        near = (ref_moments[0][k_][0] / (1 - b1)).abs() < 1e3 * tcfg.eps
        du = sum(ref["lr"][t] * (unit(ref_moments[t][k_], t + 1)
                                 - unit(mv[t], t + 1)).abs() for t in range(f_steps))
        slack = 3.0 * float(du[near].max()) if bool(near.any()) else 0.0
        mlp_err[k_], mlp_slack[k_] = err / scale, slack
        if not err <= rt * scale + slack:
            fail(f"f32 {k_}: max abs err {err:.3e} > {rt} x {scale:.3e} + "
                 f"AdamW's slack {slack:.3e}")
        if not err <= 2 * sum(ref["lr"]):   # AdamW's largest move, 2 steps
            fail(f"f32 {k_}: max abs err {err:.3e} > 2 Σ lr")
        rep = constraint_report({"blocks": {"mlp": {k_: full}}}, spec)
        if not rep["max_violation"] <= 1e-5 * radius:
            fail(f"f32 {k_}: max_violation {rep['max_violation']:.3e}")
    coords = [o["coords"] for o in ranks]
    identical = 0
    for key in ("params", "m", "v"):
        for name, sp in specs.items():
            axes = sharding.spec_axes(tuple(sp))
            for r in range(MESH_RANKS):
                for q in range(r):
                    if all(coords[r][ax] == coords[q][ax] for ax in axes):
                        if ranks[r]["f32"]["digests"][key][name] != \
                                ranks[q]["f32"]["digests"][key][name]:
                            fail(f"f32 {key} {name} differs on ranks {q} and {r}")
                        else:
                            identical += 1
    print(f"train mesh (a) {TRAIN_ARCH} full width {f_layers} layers f32, "
          f"{MESH_TRAIN_SIZES} mesh over {backend}: losses {ranks[0]['f32']['losses']} "
          f"(one device {ref['losses']}), grad norms {ranks[0]['f32']['grad_norms']} "
          f"(one device {ref['grad_norms']}); w_up/w_gate vs one device "
          f"{mlp_err['w_up']:.3e}/{mlp_err['w_gate']:.3e} of the largest entry "
          f"(AdamW's slack {mlp_slack['w_up']:.3e}/{mlp_slack['w_gate']:.3e}), "
          f"their moments (per step, of the largest entry) "
          f"{ {k_: {n: f'{e:.3e}' for n, e in d.items()} for k_, d in mom_err.items()} }; "
          f"every layer feasible; {identical} copy pairs bit-identical; "
          f"collectives per step = the model "
          f"{ranks[0]['f32']['model']['calls']}; launches "
          f"{ {k_: ranks[0]['f32']['launches'][k_] for k_ in F32_FLASH} }")

    # (b) bf16: the launcher on the mesh against the launcher on one device
    steps, batch, micro, seq = train_args()
    n_micro = batch // micro
    bsteps = MESH_TRAIN_BF16_STEPS
    want_l = {"flash_fwd": 2 * layers * n_micro * bsteps,
              "flash_bwd_dq": layers * n_micro * bsteps,
              "flash_bwd_dkv": layers * n_micro * bsteps}
    want_l.update({k_: v_ * bsteps for k_, v_ in MESH_TRAIN_HOOK.items()})
    rt = MESH_TRAIN_RTOL["bf16"]
    per_rank = []
    for o in ranks:
        b = o["bf16"]
        if not (len(b["losses"]) == bsteps and all(np.isfinite(b["losses"]))):
            fail(f"bf16 rank {o['rank']}: losses {b['losses']}")
        if not np.allclose(b["losses"], one["losses"], rtol=rt, atol=0):
            fail(f"bf16 rank {o['rank']}: losses {b['losses']} vs one device "
                 f"{one['losses']}")
        want = {op: {"calls": b["model"]["calls"][op], "bytes": b["model"]["bytes"][op]}
                for op in b["model"]["calls"]}
        if any(c != want for c in b["collectives"]):
            fail(f"bf16 rank {o['rank']}: collectives {b['collectives']} != "
                 f"the model {want}")
        got = {k_: b["launches"][k_] for k_ in want_l}
        if got != want_l:
            fail(f"bf16 rank {o['rank']}: launches {got} != {want_l}")
        warm = statistics.median(b["step_seconds"][1:])
        per_rank.append({"rank": o["rank"], "step_ms": [x * 1e3 for x in b["step_seconds"]],
                         "warm_step_ms": warm * 1e3,
                         "tokens_per_s": batch * seq / warm,
                         "peak_gib": b["peak_bytes"] / 2**30,
                         "collectives_per_step": b["collectives"][0],
                         "launches": got})
        print(f"train mesh (b) rank {o['rank']} ({layers} layers bf16, "
              f"{' '.join(b['argv'])}): losses {b['losses']} (one device "
              f"{one['losses']}), step ms {[round(x * 1e3, 2) for x in b['step_seconds']]}, "
              f"{batch * seq / warm:.1f} tokens/s warm, peak "
              f"{b['peak_bytes'] / 2**30:.2f} GiB, collectives per step "
              f"{b['collectives'][0]} (= the model), launches {got}")
    print(f"train mesh (b) one device: losses {one['losses']}, step ms "
          f"{[round(x * 1e3, 2) for x in one['step_seconds']]}, peak "
          f"{one_peak / 2**30:.2f} GiB")

    # (c) GSP: sharded against one device, in each compute dtype; the run
    # with enter's psum skipped must lie outside the same bars
    gaps, fault_gaps = {}, {}
    for o in ranks:
        if o["gsp"] != ranks[0]["gsp"]:
            fail(f"gsp: rank {o['rank']} reports another record")
    for dt, (l_rtol, pts) in MESH_GSP_TOL.items():
        g4, g1, gf = ranks[0]["gsp"][dt], gsp_one[dt], ranks[0]["gsp_fault"][dt]
        if not (g4["n_projected"] == g1["n_projected"] and g4["feasible"]
                and g1["feasible"]):
            fail(f"gsp {dt}: {g4} vs one device {g1}")
        gap, loss_rel = gaps[dt] = gsp_gap(g4, g1)
        if gap > pts or loss_rel > l_rtol:
            fail(f"gsp {dt}: sparsity {g4['per_leaf_sparsity']} loss {g4['loss']} "
                 f"vs one device {g1['per_leaf_sparsity']} {g1['loss']}")
        f_gap, f_loss = fault_gaps[dt] = gsp_gap(gf, g1)
        if f_gap <= pts and f_loss <= l_rtol:
            fail(f"gsp {dt}: the bars ({pts} points, {l_rtol} relative) miss a "
                 f"skipped psum over 'model' ({f_gap:.4f} points, loss "
                 f"{f_loss:.3e})")
        print(f"train mesh (c) gsp {dt} {MESH_GSP_SIZES} mesh: n_projected "
              f"{g4['n_projected']}, loss {g4['loss']:.7g} (one device "
              f"{g1['loss']:.7g}, {loss_rel:.3e} relative, bar {l_rtol}), largest "
              f"per-leaf sparsity gap {gap:.4f} points (bar {pts}), mean column "
              f"sparsity {g4['mean_col_sparsity']:.4f} % (one device "
              f"{g1['mean_col_sparsity']:.4f} %), both feasible; with enter's "
              f"psum over 'model' skipped: {f_gap:.4f} points, loss "
              f"{f_loss:.3e} relative (caught)")
    print(f"train mesh phase: {MESH_RANKS} ranks over {backend}, references "
          f"{ref_s:.1f} s, ranks {ranks_s:.1f} s wall")
    if fails:
        raise SmokeFailure("train mesh phase: " + "; ".join(fails))
    return {"backend": backend, "layers_bf16": layers, "radius": radius,
            "seconds": {"references": ref_s, "ranks": ranks_s},
            "f32": {"losses": ranks[0]["f32"]["losses"], "one_device": ref,
                    "w_err_rel": mlp_err, "adamw_slack": mlp_slack,
                    "moments_err_rel": mom_err,
                    "identical_pairs": identical,
                    "collectives_per_step": ranks[0]["f32"]["model"]["calls"]},
            "bf16": {"per_rank": per_rank, "one_device": {
                "losses": one["losses"], "step_ms": [x * 1e3 for x in one["step_seconds"]],
                "peak_gib": one_peak / 2**30}},
            "gsp": {"sharded": ranks[0]["gsp"], "one_device": gsp_one,
                    "gap_pts_and_loss_rel": gaps,
                    "skipped_psum_gap_pts_and_loss_rel": fault_gaps},
            "kernels_at_rank_shapes": {"max_abs_err": kernel_errs,
                                       "ms": kernel_times}}


# the generated pipeline under autograd (phase 3b): W1 and W2 of phase 3,
# each through these entry points, held against autograd through the plain
# schedule (method="sort") on the card
GRAD_WORKLOADS = ("W1", "W2")
GRAD_LAUNCHES = {"codegen_reduce": 1, "l1ball": 1, "codegen_apply": 1}


def boundary_cotangent(design, y, eta, band, seed):
    """A standard normal cotangent, zeroed where the Jacobian of the
    projection jumps within ``band`` of Y: elements whose |y| lies within
    ``band`` of their clip radius, the tri-level (n, m) fibres whose
    aggregate lies within it of the outer radius, and the columns whose
    outer aggregate lies within it of θ. Returns ``(cotangent, zeroed
    share, columns within band of θ)``."""
    import torch

    from repro_torch.core import ball

    a = y.abs()
    v1 = a.amax(0)
    v = v1 if design == "bilevel" else v1.amax(0)
    u = ball.project_l1(v, eta, method="sort")
    theta = float((v - u)[u > 0].max()) if bool((u > 0).any()) else 0.0
    edge = (v - theta).abs() <= band
    if design == "bilevel":
        near = ((a - u).abs() <= band) | edge
    else:
        u1 = torch.minimum(v1, u)
        near = (((a - u1).abs() <= band) | ((v1 - u).abs() <= band)
                | edge)
    gen = torch.Generator(device=y.device).manual_seed(seed)
    c = torch.randn(y.shape, generator=gen, device=y.device)
    c[near] = 0
    return c, float(near.float().mean()), int(edge.sum())


def grad_phase(wls):
    """Phase 3b: gradients through the generated pipeline at full width.

    Two cotangents. The first is the plain projection's residual c = P(Y)
    − Y (the gradient of ½‖P(Y) − Y‖² through P): it vanishes where an
    element sits on its clip radius, so the Jacobian's jumps at the ball's
    boundaries, which a θ a few ulps away (the kernel's bisection against
    the plain sort) moves across some elements, carry no weight. It is 0
    wherever |y| < u too, so it leaves the identity branch and the saved X
    unread; the second, random one (``boundary_cotangent``) weighs every
    element except those within a band of a boundary: four times the
    largest |X − X_plain| plus 64 ulps of max v, which covers the two θs'
    distance. Both gradients are held to the projection tolerance. Each
    entry point's forward, counted alone, makes the pipeline's three
    launches (the ``auto`` path: where its ``grad=True`` verdict is
    ``codegen``, else none); its backward is the residual VJP and calls no
    ``schedule.execute``. Times: the grad forward, the backward alone (a
    retained graph), the no-grad forward and the plain schedule's forward
    and backward, events, median of 20; the ``grad=True`` autotune verdict
    at each shape."""
    import torch

    from repro_torch.core import multilevel, plan as planmod, schedule
    from repro_torch.kernels import _build, codegen

    levels = {"bilevel": BILEVEL, "trilevel": TRILEVEL}
    out = {}
    for i_wl, wl in enumerate(GRAD_WORKLOADS):
        design, y0, radii = wls[wl]
        lv, eta = levels[design], radii[0]
        r0 = torch.tensor(eta, device=y0.device)
        y_ref = y0.clone().requires_grad_(True)
        r_ref = r0.clone().requires_grad_(True)
        x_ref = multilevel.multilevel_project(y_ref, lv, r_ref, method="sort")
        build = codegen.build(y0.shape, lv, torch.float32)
        with torch.no_grad():
            dx = float((build(y0, eta) - x_ref).abs().max())
        band = 4 * dx + 64 * 2.0 ** -23 * float(y0.abs().max())
        cots = {"P(Y)-Y": (x_ref - y0).detach()}
        cots["random"], zeroed, edge = boundary_cotangent(
            design, y0, eta, band, seed=23 + i_wl)
        want = {k: torch.autograd.grad(x_ref, (y_ref, r_ref), c,
                                       retain_graph=True)
                for k, c in cots.items()}
        cot = cots["P(Y)-Y"]
        ms = {"plain_forward_ms": event_ms(lambda: multilevel.multilevel_project(
                  y_ref, lv, r_ref, method="sort")),
              "plain_backward_ms": event_ms(lambda: torch.autograd.grad(
                  x_ref, (y_ref, r_ref), cot, retain_graph=True))}
        del x_ref
        auto = planmod.make_plan(y0.shape, torch.float32, lv, method="auto",
                                 grad=True)
        paths = {
            "codegen.build": build,
            "make_plan(grad=True)": planmod.make_plan(
                y0.shape, torch.float32, lv, method="codegen", grad=True),
            "multilevel_project(auto)": lambda y, r: multilevel.multilevel_project(
                y, lv, r, method="auto"),
        }
        rec = {}
        for name, fn in paths.items():
            y = y0.clone().requires_grad_(True)
            r = r0.clone().requires_grad_(True)
            _build.reset_launches()
            x = fn(y, r)
            torch.cuda.synchronize()
            got = {k: n for k, n in _build.launch_counts().items() if n}
            expect = GRAD_LAUNCHES if (name != "multilevel_project(auto)"
                                       or auto.method == "codegen") else {}
            if got != expect:
                raise SmokeFailure(f"grad {wl} {name}: forward launches {got}, "
                                   f"not {expect}")
            if x.grad_fn is None:
                raise SmokeFailure(f"grad {wl} {name}: the result has no grad_fn")
            executed = []
            real = schedule.execute
            schedule.execute = lambda *a, **k: executed.append(1) or real(*a, **k)
            try:
                _build.reset_launches()
                grads = {k: torch.autograd.grad(x, (y, r), c, retain_graph=True)
                         for k, c in cots.items()}
                torch.cuda.synchronize()
            finally:
                schedule.execute = real
            bwd_launches = sum(_build.launch_counts().values())
            if executed or bwd_launches:
                raise SmokeFailure(f"grad {wl} {name}: the backward ran "
                                   f"schedule.execute {len(executed)} times, "
                                   f"{bwd_launches} kernel launches")
            rec[name] = {"launches": got}
            for k, (dy, dr) in grads.items():
                want_dy, want_dr = want[k]
                scale = fmax(want_dy)
                err = check_close(f"grad {wl} {name} [{k}] dY", dy, want_dy,
                                  scale)
                # the random cotangent's dη is a sum of signed terms that
                # may cancel: held to dY's scale, the same terms' size
                rscale = abs(float(want_dr)) if k == "P(Y)-Y" else scale
                err_r = check_close(f"grad {wl} {name} [{k}] dη",
                                    dr.reshape(1), want_dr.reshape(1), rscale)
                rec[name][k] = {"dy_max_abs_err": err, "dy_scale": scale,
                                "dradius": float(dr), "dradius_abs_err": err_r}
                print(f"grad {wl} {design} {tuple(y0.shape)} η={eta:.6g} "
                      f"{name} [{k}]: forward launches {got}, backward 0 "
                      f"launches and 0 schedule.execute calls; dY max_abs_err "
                      f"{err:.3e} (scale {scale:.3e}), dη {float(dr):.7g} vs "
                      f"{float(want_dr):.7g} (err {err_r:.3e})")
            if name == "codegen.build":
                ms["forward_ms"] = event_ms(lambda: fn(y, r))
                ms["backward_ms"] = event_ms(lambda: torch.autograd.grad(
                    x, (y, r), cot, retain_graph=True))
                with torch.no_grad():
                    ms["nograd_forward_ms"] = event_ms(lambda: fn(y0, eta))
            del x, grads, y, r
        print(f"grad {wl} random cotangent: band {band:.3e}, {zeroed:.3e} of "
              f"the elements zeroed, {edge} columns within the band of θ")
        print(f"grad {wl} ms (events, median of {REPS}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in ms.items())
            + f"; grad=True autotune picks {auto.method} "
            f"({ {k: round(v, 1) for k, v in auto.timings_us.items()} } µs)")
        out[wl] = {"design": design, "shape": list(y0.shape), "eta": eta,
                   "paths": rec, "ms": ms, "auto_grad_method": auto.method,
                   "auto_grad_timings_us": auto.timings_us,
                   "random_cotangent": {"band": band, "zeroed_share": zeroed,
                                        "columns_near_theta": edge}}
        del y_ref, r_ref, want, cots, cot
    torch.cuda.empty_cache()
    return out


def refuse_grad_phase(wls):
    """Phase 3c: every kernel without a backward refuses a CUDA input that
    requires grad (a ``ValueError`` naming the differentiable route) and
    launches nothing: the golden wrappers and pipelines at W1 / W2, and
    ``l1ball`` as a bucket and as one vector with its radius by value."""
    import torch

    from repro_torch.kernels import (_build, bilevel_l1inf as bi, l1ball,
                                     trilevel_l1infinf as tri)

    y1, y2 = wls["W1"][1], wls["W2"][1]
    v2, u1 = tri.trilevel_reduce(y2)
    u = bi.colmax(y1)
    vs, radii = y1[:8].clone(), y1[:8].abs().sum(1) * 0.5

    def g(t):
        return t.clone().requires_grad_(True)

    cases = {
        "colmax": lambda: bi.colmax(g(y1)),
        "clip": lambda: bi.clip(y1, g(u)),
        "trilevel_reduce": lambda: tri.trilevel_reduce(g(y2)),
        "trilevel_apply": lambda: tri.trilevel_apply(y2, g(v2), u1),
        "bilevel_l1inf_fused": lambda: bi.bilevel_l1inf_fused(g(y1), 1.0),
        "trilevel_l1infinf_fused": lambda: tri.trilevel_l1infinf_fused(g(y2), 1.0),
        "l1ball bucket": lambda: l1ball.project_l1_batched(g(vs), radii),
        "l1ball one": lambda: l1ball.project_l1(g(vs[0]), 1.0),
    }
    for name, call in cases.items():
        torch.cuda.synchronize()
        _build.reset_launches()
        try:
            call()
        except ValueError as e:
            if "no backward" not in str(e):
                raise SmokeFailure(f"refuse {name}: {e}") from None
        else:
            raise SmokeFailure(f"refuse {name}: no error on an input that "
                               "requires grad")
        torch.cuda.synchronize()
        n = sum(_build.launch_counts().values())
        if n:
            raise SmokeFailure(f"refuse {name}: {n} launches")
    print(f"refuse grad: {len(cases)} kernel calls on inputs that require grad "
          "raise and launch nothing")
    return sorted(cases)


# the §7.3 application (phase 8): training/sae_tables.py at the paper's
# size, and its synthetic bi-level ℓ1,∞ row held against the same run on
# the CPU from the card's seed-0 init: descent-1 losses within this rtol
# (two float32 summation orders; float32 against float64 on the CPU reads
# 1.9e-7 over the 150 steps)
SAE_TABLES_LOSS_RTOL = 1e-4


def sae_tables_phase():
    """Phase 8: the 5-method sweep of paper §7.3 (Tables 2–5) at full size
    on the card: the 10 rows and their seconds; the baseline's column
    sparsity 0; every descent-1 projection of ``enc1/w`` feasible (the
    allowance of phase 3); every masked weight exactly zero after descent
    2; bi-level ℓ1,∞ sparsity above 0; then the synthetic bi-level ℓ1,∞
    row on the CPU from the same init (losses within
    ``SAE_TABLES_LOSS_RTOL``, the differing mask columns printed). The
    path makes no kernel launch: it runs the plain schedule, as the JAX
    training hook runs its jnp one."""
    import dataclasses

    import torch

    from repro_torch import _tree
    from repro_torch.configs import registry
    from repro_torch.core import multilevel
    from repro_torch.data import classification_synthetic
    from repro_torch.kernels import _build
    from repro_torch.models import params as PM, sae
    from repro_torch.training import sae_tables as ST

    rec = {}
    _build.reset_launches()
    t0 = time.perf_counter()
    rows = ST.tables(full=True, device="cuda", record=rec)
    seconds = time.perf_counter() - t0
    launches = {k: n for k, n in _build.launch_counts().items() if n}
    for name, us, derived in rows:
        print(f"sae_tables {name}: {derived} ({us / 1e6:.2f} s)")
    print(f"sae_tables: {len(rows)} rows in {seconds:.1f} s; launches "
          f"{launches or 'none'}")
    if len(rows) != 10:
        raise SmokeFailure(f"sae_tables: {len(rows)} rows, not 10")
    checks = {}
    for ds, methods in rec.items():
        if methods["baseline"]["colsparsity"] != 0.0:
            raise SmokeFailure(f"sae_tables {ds}: baseline sparsity "
                               f"{methods['baseline']['colsparsity']}")
        if not methods["bilevel_l1inf"]["colsparsity"] > 0.0:
            raise SmokeFailure(f"sae_tables {ds}: bi-level l1,inf sparsity 0")
        for mname, kw in ST._specs(1.0).items():
            if mname == "baseline":
                continue
            r = methods[mname]
            spec = kw.get("spec")
            levels = spec.levels if spec else BILEVEL
            eta = spec.radius if spec else kw["exact_radius"]
            trained = r["trained"]["enc1"]["w"].T
            proj = r["projected"]["enc1"]["w"].T
            nrm = float(multilevel.multilevel_norm(proj, levels))
            slack = RTOL * eta + proj.shape[-1] * 2.0 ** -23 * float(
                trained.abs().max())
            if not nrm <= eta + slack:
                raise SmokeFailure(f"sae_tables {ds} {mname}: norm {nrm} > "
                                   f"{eta} + {slack:.3e}")
            alive = sum(int((p[m == 0] != 0).sum()) for p, m in zip(
                _tree.leaves(r["params"]), _tree.leaves(r["mask"])))
            if alive:
                raise SmokeFailure(f"sae_tables {ds} {mname}: {alive} masked "
                                   "weights nonzero after descent 2")
            checks[f"{ds}/{mname}"] = {"norm": nrm, "eta": eta, "slack": slack}
    print(f"sae_tables: baseline sparsity 0, {len(checks)} descent-1 "
          "projections feasible, every masked weight 0 after descent 2")

    # the synthetic bi-level l1,inf row on the CPU from the card's init
    x, y, _ = classification_synthetic(n_samples=1000, n_features=2000,
                                       n_informative=64, class_sep=0.8)
    cfg = dataclasses.replace(registry.get_arch("sae-paper"), d_model=2000)
    init = _tree.tree_map(lambda p: p.cpu(), PM.init_params(
        sae.template(cfg), 0, device="cuda"))
    host = {}
    t0 = time.perf_counter()
    ST.run_dataset("synthetic", x, y, radius=1.0, epochs=150, device="cpu",
                   only=("bilevel_l1inf",), init=init, record=host)
    host_s = time.perf_counter() - t0
    card, cpu = rec["synthetic"]["bilevel_l1inf"], host["bilevel_l1inf"]
    a, b = torch.tensor(card["losses"][0]), torch.tensor(cpu["losses"][0])
    rel = float(((a - b).abs() / b.abs()).max())
    if not rel <= SAE_TABLES_LOSS_RTOL:
        raise SmokeFailure(f"sae_tables synthetic bilevel_l1inf: descent-1 "
                           f"losses card vs CPU rel {rel:.3e}")
    alive_card = card["mask"]["enc1"]["w"].amax(1).cpu() > 0
    alive_cpu = cpu["mask"]["enc1"]["w"].amax(1) > 0
    differ = (alive_card != alive_cpu).nonzero().flatten().tolist()
    print(f"sae_tables synthetic bilevel_l1inf card vs CPU ({host_s:.1f} s): "
          f"descent-1 losses max rel {rel:.3e} (bar {SAE_TABLES_LOSS_RTOL}); "
          f"accuracy {card['accuracy']:.1f} vs {cpu['accuracy']:.1f} %, "
          f"column sparsity {card['colsparsity']:.1f} vs "
          f"{cpu['colsparsity']:.1f} %; mask columns that differ: {differ}")
    return {"rows": [list(r) for r in rows], "seconds": seconds,
            "launches": launches, "feasibility": checks,
            "cpu_hold": {"loss_max_rel": rel, "mask_columns_differ": differ,
                         "accuracy": [card["accuracy"], cpu["accuracy"]],
                         "colsparsity": [card["colsparsity"],
                                         cpu["colsparsity"]],
                         "cpu_seconds": host_s}}


# serving and the rest of the port (phase 10): launch/serve.py at the full
# width and depth of granite-3-2b (seeded float32 params; the hold's bar is
# tests/test_serving.py:70-83's, 5e-3 of the largest logit), the ring cache
# of h2o-danube-1.8b (window 4096) cut to 2 layers with a prompt that wraps
# it, the flush()-driven ProjectionService at the server's shapes, the
# train launcher's in-step telemetry, and int8 AdamW moments
SERVE_ARGV = ["--arch", "granite-3-2b", "--batch", "8", "--prompt-len", "128",
              "--new", "64"]
RING_ARGV = ["--arch", "h2o-danube-1.8b", "--layers", "2", "--batch", "1",
             "--prompt-len", "4160", "--new", "4"]
SERVE_BAR = 5e-3
DECODE_TIMED = 32             # decode steps timed after the held prompt
SERVICE_ODD = ((3000, 1000), BILEVEL)   # one request alone, method="codegen"
TELEMETRY_LAYERS = 8
GATE_ROUNDS = 4               # profiled calls of each step, (d)
WINDOW_PAD = 128              # uncounted spin kernels opening each window
INT8_STEPS = 3
INT8_LAYERS = 8               # (e): granite-3-2b at full width, cut in depth
INT8_PARAM_BAR = 0.2          # params after step 2, of the step's move (H100: 0.061)


def serve_args(argv):
    """{flag: value} of a launcher argv of flag/value pairs."""
    return dict(zip(argv[::2], argv[1::2]))


def _decode_replay(cfg, params, prompts, max_len):
    """The prompt replayed through ``make_decode_step`` (as ``generate``
    does): (the last position's logits, the cache, the step)."""
    import torch

    from repro_torch import models
    from repro_torch.serving import lm

    api = models.get(cfg)
    b, s = prompts.shape
    cache = api.make_cache(cfg, b, max_len, dtype=torch.float32,
                           device=prompts.device)
    step = lm.make_decode_step(cfg, api)
    logits = None
    with torch.inference_mode():
        for i in range(s):
            _, logits, cache = step(params, prompts[:, i], cache, i)
    return logits, cache, step


def hold_decode(tag, res, max_len):
    """The last prompt position's decode logits against the teacher-forced
    ``forward(impl="chunked")``'s, within SERVE_BAR · max|logits|."""
    import torch

    from repro_torch import models

    cfg, params, prompts = res["cfg"], res["params"], res["prompts"]
    logits, cache, step = _decode_replay(cfg, params, prompts, max_len)
    with torch.inference_mode():
        full, _ = models.get(cfg).forward(params, prompts, cfg, impl="chunked",
                                          remat=False)
    want = full[:, -1]
    scale = float(want.abs().max())
    err = float((logits - want).abs().max())
    print(f"serve {tag}: decode vs chunked forward at position "
          f"{prompts.shape[1] - 1}: max_abs_err {err:.3e} (bar {SERVE_BAR} x "
          f"max|logits| {scale:.4g}); ring slots {cache['k'].shape[2]}")
    if not (torch.isfinite(logits).all() and err <= SERVE_BAR * scale):
        raise SmokeFailure(f"serve {tag}: decode logits {err:.3e} from the "
                           f"forward's (bar {SERVE_BAR * scale:.3e})")
    toks = res["tokens"]
    if not (toks.dtype == torch.int32 and int(toks.min()) >= 0
            and int(toks.max()) < cfg.vocab):
        raise SmokeFailure(f"serve {tag}: tokens {toks.dtype} outside "
                           f"[0, {cfg.vocab})")
    return err, logits, cache, step


def decode_bound_ms(cfg, params, batch, length):
    """One decode step's byte bound: every weight read once (the input
    embedding's rows of the batch only, unless it is also the output
    embedding), the cache's valid slots read once, over HBM's rate."""
    import torch

    from repro_torch import _tree

    nbytes = 0
    for name, p in _tree.leaves_with_paths(params):
        if name == "embed" and "unembed" in params:
            nbytes += batch * p.shape[1] * p.element_size()
        else:
            nbytes += p.numel() * p.element_size()
    per = (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim if cfg.mla is not None
           else 2 * cfg.n_kv_heads * cfg.resolved_head_dim)
    kv = cfg.n_layers * batch * length * per * torch.float32.itemsize
    return (nbytes + kv) / HBM_BYTES_PER_S * 1e3, nbytes


def serve_decode(dev):
    """(a) and (b): the serve launcher on the card, each held against the
    teacher-forced forward; (a) also timed per decode step, beside its
    byte bound and the profiler's launches and device time per step."""
    import torch

    from repro_torch import _tree
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as serve_cli

    out = {}
    # ------------------------------------------------------------- (a)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()        # left by earlier phases
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    res = serve_cli.run(SERVE_ARGV)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = {k: n for k, n in _build.launch_counts().items() if n}
    a = serve_args(SERVE_ARGV)
    b, plen, new = int(a["--batch"]), int(a["--prompt-len"]), int(a["--new"])
    cfg, params = res["cfg"], res["params"]
    print(f"serve (a) python -m repro_torch.launch.serve {' '.join(SERVE_ARGV)}: "
          f"{cfg.n_layers} layers d_model {cfg.d_model}, "
          f"{sum(p.numel() for p in _tree.leaves(params))} float32 params; {res['seconds']:.3f} s for {b} x {new} new tokens "
          f"after {plen} prompt tokens ({res['tok_per_s']:.1f} tok/s, host "
          f"clock, prompt replay included); kernel launches {launches}; peak "
          f"device memory {peak / 2**30:.2f} GiB above the {base / 2**30:.2f} "
          f"GiB allocated before")
    err, _, cache, step = hold_decode("(a) granite-3-2b", res, plen + new
                                      + DECODE_TIMED + 2)
    # ms per decode step, continuing after the held prompt
    toks = res["tokens"][:, 0]
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(DECODE_TIMED):
            toks, _, cache = step(params, toks, cache, plen + i)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / DECODE_TIMED
        pos = plen + DECODE_TIMED

        def one():
            step(params, toks, cache, pos)
        per_kernel = device_kernels(one)
        per_count = device_kernels(one, counts=True)
        n_launch = sum(per_count.values())
    busy = sum(per_kernel.values())
    top = sorted(per_count, key=lambda k: -per_count[k])[:8]
    print("serve (a) a decode step's most frequent device kernels: " + "; ".join(
        f"{per_count[k]} x {k[:60]} ({per_kernel.get(k, 0.0):.3f} ms)"
        for k in top))
    bms, wbytes = decode_bound_ms(cfg, params, b, pos + 1)
    bound_by = "host" if busy < 0.5 * step_ms else "device"
    print(f"serve (a) decode step at position {pos} (batch {b}): {step_ms:.3f} ms "
          f"(host clock, mean of {DECODE_TIMED}), {b / step_ms * 1e3:.1f} tok/s; "
          f"byte bound {bms:.3f} ms ({wbytes} bytes of weights + the cache over "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); {n_launch} device kernels and "
          f"copies a step ({n_launch / cfg.n_layers:.1f} a layer), device busy "
          f"{busy:.3f} ms: "
          f"{bound_by}-bound")
    out["a"] = {"argv": SERVE_ARGV, "seconds": res["seconds"],
                "tok_per_s": res["tok_per_s"], "peak_bytes": peak,
                "max_abs_err": err, "decode_step_ms": step_ms,
                "decode_tok_per_s": b / step_ms * 1e3, "bound_ms": bms,
                "weight_bytes": wbytes, "kernels_per_step": n_launch,
                "device_busy_ms": busy, "bound_by": bound_by,
                "launches": launches}
    del res, params, cache, step, toks
    torch.cuda.empty_cache()
    # ------------------------------------------------------------- (b)
    res = serve_cli.run(RING_ARGV)
    torch.cuda.synchronize()
    a = serve_args(RING_ARGV)
    cfg = res["cfg"]
    plen = int(a["--prompt-len"])
    if not plen > cfg.window:
        raise SmokeFailure(f"serve (b): prompt {plen} does not wrap the ring "
                           f"of {cfg.window}")
    err, *_ = hold_decode(f"(b) {cfg.name} {cfg.n_layers} layers window "
                          f"{cfg.window}", res, plen + int(a["--new"]))
    step_ms = res["seconds"] * 1e3 / (plen + int(a["--new"]))
    print(f"serve (b): {step_ms:.3f} ms a decode step (the launcher's run over "
          f"its {plen + int(a['--new'])} steps, host clock)")
    out["b"] = {"argv": RING_ARGV, "seconds": res["seconds"],
                "tok_per_s": res["tok_per_s"], "max_abs_err": err,
                "decode_step_ms": step_ms}
    del res
    torch.cuda.empty_cache()
    return out


def serve_service(randn, rand):
    """(c): ``ProjectionService(method="codegen_batch")`` at the server's
    shapes: 8 requests of each and one odd-shaped ``codegen`` request in
    one flush (one pipeline per group, by launch counts), a bad request
    refused at submit, every result held to the plain projection."""
    import torch

    from repro_torch.core import multilevel
    from repro_torch.kernels import _build
    from repro_torch.serving import ProjectionService

    svc = ProjectionService(method="codegen_batch")
    try:
        svc.submit(randn((4, 6, 2)), list(BILEVEL), 1.0)
    except ValueError as e:
        print(f"service: bad request refused at submit ({e})")
    else:
        raise SmokeFailure("service: a bad request was queued")
    reqs = []
    for i in range(BUCKET):
        for shape, levels in FULL.values():
            y = randn(shape)
            r = float(multilevel.multilevel_norm(y, levels)) \
                * (0.05 + 0.45 * float(rand(())))
            reqs.append((y, levels, r, None))
    shape, levels = SERVICE_ODD
    y = randn(shape)
    reqs.append((y, levels, 0.25 * float(multilevel.multilevel_norm(y, levels)),
                 "codegen"))
    tickets = [svc.submit(y, levels, r, method=m) for y, levels, r, m in reqs]
    torch.cuda.synchronize()
    _build.reset_launches()
    mark = tile_search_mark()
    t0 = time.perf_counter()
    svc.flush()
    torch.cuda.synchronize()
    flush_ms = (time.perf_counter() - t0) * 1e3
    # the odd request's codegen plan tunes its tile plan at its first call
    # (codegen's autotune_tiles): those launches are the search's, held to
    # its protocol and apart
    search = check_search("service flush", mark)
    launches = {k: n - search.get(k, 0)
                for k, n in _build.launch_counts().items() if n}
    groups = len(FULL) + 1
    print(f"service: one flush of {len(reqs)} requests in {groups} groups, "
          f"{flush_ms:.3f} ms (host clock, first call of each plan and the "
          f"odd request's tile search included); launches {launches}, the "
          f"tile search's {search} apart; stats {svc.stats}")
    if launches != dict.fromkeys(SERVER_KERNELS, groups):
        raise SmokeFailure(f"service: launches {launches}, not one pipeline "
                           f"per group ({groups})")
    if svc.stats["executed_batches"] != groups or \
            svc.stats["batched_requests"] != BUCKET * len(FULL):
        raise SmokeFailure(f"service: stats {svc.stats}")
    worst = 0.0
    for i, (t, (y, levels, r, _)) in enumerate(zip(tickets, reqs)):
        x = svc.result(t)
        want = multilevel.multilevel_project(y, list(levels), r,
                                             method="bisect")
        worst = max(worst, check_close(f"service request {i}", x, want,
                                       float(y.abs().max())))
        nrm = float(multilevel.multilevel_norm(x, list(levels)))
        slack = r * RTOL + y.shape[-1] * 2.0 ** -23 * float(y.abs().max())
        if not nrm <= r + slack:
            raise SmokeFailure(f"service request {i}: norm {nrm} > radius {r}")
    print(f"service: {len(reqs)} results equal to the plain projection "
          f"(max_abs_err {worst:.3e}) and feasible")
    # the odd request again, alone: its cached plan, no search
    y, levels, r, m = reqs[-1]
    again = svc.submit(y, levels, r, method=m)
    torch.cuda.synchronize()
    _build.reset_launches()
    svc.flush()
    torch.cuda.synchronize()
    again_launches = {k: n for k, n in _build.launch_counts().items() if n}
    if any(_build.search_counts().values()) or \
            again_launches != dict.fromkeys(SERVER_KERNELS, 1):
        raise SmokeFailure(f"service: the odd request again launched "
                           f"{again_launches}, its search {_build.search_counts()}")
    check_close("service odd request again", svc.result(again),
                multilevel.multilevel_project(y, list(levels), r, method="bisect"),
                float(y.abs().max()))
    print(f"service: the odd request again in a flush of its own: launches "
          f"{again_launches}, no tile search")
    return {"flush_ms": flush_ms, "launches": launches,
            "search_launches": search, "again_launches": again_launches,
            "stats": svc.stats, "max_abs_err": worst}


def _telemetry_argv(radius):
    steps, batch, micro, seq = train_args()
    return ["--arch", TRAIN_ARCH, "--layers", str(TELEMETRY_LAYERS),
            "--batch", str(batch), "--microbatch", str(micro), "--seq",
            str(seq), "--steps", "3", "--radius", repr(radius)]


def serve_telemetry(dev, radius):
    """(d): the train launcher at full width, TELEMETRY_LAYERS layers, 3
    steps, once without telemetry and once with ``--telemetry-every 1
    --telemetry-marks``; the unfused step's projection marks; and, with
    the bridge off, one step built with ``telemetry_every=1`` against one
    built with 0: the same launches and device kernels."""
    import dataclasses as dc

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch import _tree, models
    from repro_torch.configs import registry
    from repro_torch.configs.types import ProjectionSpec, TrainConfig
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.kernels import _build
    from repro_torch.launch import train as train_cli
    from repro_torch.obs import bridge, metrics
    from repro_torch.training import init_state, make_train_step

    argv = _telemetry_argv(radius)
    runs = {}
    for tag, extra in (("off", []), ("on", ["--telemetry-every", "1",
                                            "--telemetry-marks"])):
        torch.cuda.empty_cache()
        prev = metrics.set_registry(metrics.Registry())
        _build.reset_launches()
        try:
            out = train_cli.run(argv + extra)
            snap = metrics.get_registry().snapshot()
        finally:
            metrics.set_registry(prev)
        runs[tag] = {"step_seconds": out["step_seconds"],
                     "losses": out["losses"],
                     "launches": {k: n for k, n in
                                  _build.launch_counts().items() if n},
                     "snapshot": snap}
        del out
        print(f"telemetry {tag}: python -m repro_torch.launch.train "
              f"{' '.join(argv + extra)}: step seconds "
              + " ".join(f"{x:.4f}" for x in runs[tag]["step_seconds"])
              + f"; launches {runs[tag]['launches']}")
    on = runs["on"]["snapshot"]
    leaves = ("blocks/mlp/w_gate", "blocks/mlp/w_up")
    gauges = {}
    for name in ("train_loss", "train_grad_norm", "train_param_zero_frac",
                 "train_feasibility_gap"):
        if name not in on:
            raise SmokeFailure(f"telemetry: {name} missing from the registry")
        gauges[name] = {"/".join(v["labels"].values()) or "-": v["value"]
                        for v in on[name]["values"]}
    for name in ("train_param_zero_frac", "train_feasibility_gap"):
        if sorted(gauges[name]) != sorted(leaves):
            raise SmokeFailure(f"telemetry: {name} leaves {sorted(gauges[name])}")
    loss = runs["on"]["losses"][-1]
    if not abs(gauges["train_loss"]["-"] - loss) <= 1e-6 * abs(loss):
        raise SmokeFailure(f"telemetry: train_loss {gauges['train_loss']} is not "
                           f"the last step's loss {loss}")
    if not all(v <= 1e-5 for v in gauges["train_feasibility_gap"].values()):
        raise SmokeFailure(f"telemetry: infeasible {gauges['train_feasibility_gap']}")
    if not all(0.0 < v < 1.0 for v in gauges["train_param_zero_frac"].values()):
        raise SmokeFailure(f"telemetry: zero fractions "
                           f"{gauges['train_param_zero_frac']}")
    ep = on.get("train_epilogue_seconds", {}).get("values", [])
    if not (ep and ep[0]["count"] == 3):
        raise SmokeFailure(f"telemetry: train_epilogue_seconds {ep}")
    if runs["on"]["launches"] != runs["off"]["launches"]:
        raise SmokeFailure(f"telemetry: launches on {runs['on']['launches']} "
                           f"off {runs['off']['launches']}")
    print(f"telemetry gauges {gauges}; train_epilogue_seconds: "
          f"{ep[0]['count']} observations, mean {ep[0]['sum'] / 3 * 1e3:.3f} ms "
          f"(device time in stream order)")
    # the unfused step's marks, and the gate off against telemetry_every=0
    cfg = dc.replace(registry.get_arch(TRAIN_ARCH), n_layers=TELEMETRY_LAYERS)
    steps, batch, micro, seq = train_args()
    spec = ProjectionSpec(pattern=r"(w_up|w_gate)", radius=radius)
    tcfg = TrainConfig(microbatch=micro, lr=3e-4, total_steps=3, warmup=1,
                       remat=True, master_dtype="", projection=spec)
    api = models.get(cfg)
    pipe = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq + 1,
                                   global_batch=batch, microbatch=micro))
    toks = {"tokens": torch.from_numpy(pipe.batch(0)).to(dev)}
    torch.cuda.empty_cache()
    state = init_state(cfg, tcfg, api, SEED, device=dev)
    prev = metrics.set_registry(metrics.Registry())
    try:
        with bridge.enabled_scope(True):
            unfused = make_train_step(cfg, tcfg, api, impl="flash", fused=False,
                                      telemetry_every=1, telemetry_marks=True)
            unfused(state, toks)
            bridge.drain()
        pr = metrics.get_registry().snapshot().get(
            "train_projection_seconds", {}).get("values", [])
    finally:
        metrics.set_registry(prev)
    if not (pr and pr[0]["count"] == 1):
        raise SmokeFailure(f"telemetry: train_projection_seconds {pr}")
    print(f"telemetry unfused: train_projection_seconds {pr[0]['sum'] * 1e3:.3f} "
          f"ms (one observation)")
    built = {every: make_train_step(cfg, tcfg, api, impl="flash",
                                    telemetry_every=every)
             for every in (0, 1)}
    # every call starts from the same state: the plain θ-solve's launches
    # depend on the data
    snap = _tree.tree_map(torch.clone, state)

    def restore():
        for d, s_ in zip(_tree.leaves(state), _tree.leaves(snap)):
            d.copy_(s_)

    def padded(fn):
        """The step after WINDOW_PAD spin kernels, which are not counted:
        the profiler leaves out some of the first few dozen events of its
        window (scripts/profile_window.py)."""
        def call():
            for _ in range(WINDOW_PAD):
                torch.cuda._sleep(1)
            fn(state, toks)
        return call

    steps = {every: padded(fn) for every, fn in built.items()}

    class Ops(TorchDispatchMode):
        """The aten operations dispatched inside it, in order."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            names.append(str(func))
            return func(*args, **(kwargs or {}))

    ops, launches, seen = {}, {0: [], 1: []}, {0: [], 1: []}
    with bridge.enabled_scope(False):
        for every, step in steps.items():
            names = []
            restore()
            with Ops():
                step()
            ops[every] = names
        # GATE_ROUNDS rounds, the order alternating, each step a warm call
        # and a profiled one from the snapshot (restored outside the
        # profiler's window). Should the profiler still leave out an event,
        # it never adds one, so each step's count of a device kernel or
        # copy is its largest over the rounds: an event the gate-off step
        # issues on every call still shows
        for rnd in range(GATE_ROUNDS):
            for every in ((0, 1), (1, 0))[rnd % 2]:
                _build.reset_launches()
                seen[every].append({k: n for k, n in device_kernels(
                    steps[every], counts=True, setup=restore).items()
                                    if "spin_kernel" not in k})
                launches[every].append({k: n for k, n in
                                        _build.launch_counts().items() if n})
    copies = ("Memcpy", "Memset")
    most = {every: {k: max(d.get(k, 0) for d in seen[every])
                    for k in set().union(*seen[0], *seen[1])}
            for every in (0, 1)}
    for every in (0, 1):
        kern = [sum(n for k, n in d.items() if not k.startswith(copies))
                for d in seen[every]]
        copy = [sum(n for k, n in d.items() if k.startswith(copies))
                for d in seen[every]]
        print(f"telemetry gate off, telemetry_every={every}: launches "
              f"{launches[every][0]} each round; device kernels {kern} and "
              f"copies {copy} by round (order 0 1, 1 0, ...); per name the "
              f"largest count over the rounds sums to "
              f"{sum(most[every].values())}")
    print(f"telemetry gate off: {len(ops[1])} aten operations a step, "
          f"{'the same sequence' if ops[0] == ops[1] else 'ANOTHER sequence'} "
          f"as telemetry_every=0 ({len(ops[0])})")
    if ops[0] != ops[1] or most[0] != most[1] or any(
            d != launches[0][0] for d in launches[0] + launches[1]):
        diff = {k: (most[0][k], most[1][k]) for k in most[0]
                if most[0][k] != most[1][k]}
        raise SmokeFailure(f"telemetry: the gate-off step's operations, launches, "
                           f"device kernels or copies differ from "
                           f"telemetry_every=0's: {diff}; launches {launches}")
    del state, snap, built, unfused
    torch.cuda.empty_cache()
    off_ms = 1e3 * runs["off"]["step_seconds"][-1]
    on_ms = 1e3 * runs["on"]["step_seconds"][-1]
    print(f"telemetry warm step: {on_ms:.2f} ms on, {off_ms:.2f} ms off "
          f"({on_ms / off_ms - 1:+.2%}; host clock, step 3)")
    return {"argv": argv, "step_ms_on": on_ms, "step_ms_off": off_ms,
            "gauges": gauges, "epilogue_ms_mean": ep[0]["sum"] / 3 * 1e3,
            "projection_ms": pr[0]["sum"] * 1e3,
            "launches": runs["on"]["launches"],
            "gate_off_events": {every: sum(most[every].values())
                                for every in (0, 1)},
            "gate_off_ops": len(ops[1])}


def _blocks(x):
    """x (..., n) as (..., n_blocks, 256), zero-padded: the blocks of
    ``adamw.quantize_blockwise``."""
    import torch.nn.functional as F

    n = x.shape[-1]
    npad = -(-n // 256) * 256
    return F.pad(x, (0, npad - n)).reshape(x.shape[:-1] + (npad // 256, 256))


def hold_int8_step2(i8, state, tcfg, dev):
    """Step 2's update is the first that reads dequantized moments (step 1
    reads moments of zero, so both runs reach step 2 from the same params
    and the same gradient). Hold the int8 run's state after it (``i8``:
    its scales after step 1 on the device; its moments and params after
    step 2 and params after step 1 on the host) against the float32-moment
    run's ``state`` after step 2, leaf by leaf.

    With s1, s2 a 256-block's int8 scales after steps 1 and 2 (its largest
    value / 127; rounding moves a value at most s/2), the dequantized m
    lies within (β1·s1 + s2)/2 of the float32 m, and the dequantized √v (v
    is kept in the square-root domain, and the root of β2·a² + c is
    √β2-Lipschitz in a) within (√β2·s1 + s2)/2 of the float32 √v; each
    bar gets 1e-3·s2 for float32 rounding. The params: the distance
    between the runs over the float32 run's step-2 move, per leaf.
    Returns (worst m and √v error over its bar, {leaf: that ratio})."""
    import torch

    from repro_torch import _tree
    from repro_torch.optim import dequantize_blockwise

    params, opt = state["params"], state["opt"]
    coef = {"m": tcfg.beta1, "v": math.sqrt(tcfg.beta2)}
    worst = {"m": 0.0, "v": 0.0}
    moved = {}
    with torch.no_grad():
        for i, (name, p) in enumerate(_tree.leaves_with_paths(params)):
            for part, ref in (("m", opt["m"]), ("v", opt["v"])):
                ref = _tree.leaves(ref)[i]
                ref = ref.sqrt() if part == "v" else ref
                s1, qs = i8["s1"][part][i], i8["q2"][part][i]
                s2 = qs["s"].to(dev)
                got = dequantize_blockwise({"q": qs["q"].to(dev), "s": s2},
                                           p.shape[-1])
                err = _blocks((got - ref).abs()).amax(dim=-1)
                bar = 0.5 * (coef[part] * s1 + s2) + 1e-3 * s2
                worst[part] = max(worst[part], float((err / bar).max()))
                del ref, got, err
            step = float(torch.linalg.vector_norm(p - i8["p1"][i].to(dev)))
            apart = float(torch.linalg.vector_norm(i8["p2"][i].to(dev) - p))
            moved[name] = apart / step if step else (0.0 if not apart
                                                     else math.inf)
    return worst, moved


def serve_int8(dev, radius):
    """(e): ``make_train_step`` at the full width of granite-3-2b cut to
    INT8_LAYERS layers for INT8_STEPS steps with int8 moments, then with float32
    moments from the same init and batches: finite losses, feasible
    projected layers, each run's peak device memory, and the int8 run's
    state after step 2 held to the float32 run's
    (:func:`hold_int8_step2`)."""
    import numpy as np
    import torch

    from repro_torch import _tree, models
    from repro_torch.configs import registry
    from repro_torch.configs.types import ProjectionSpec, TrainConfig
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.models import lm
    from repro_torch.training import init_state, make_train_step
    from repro_torch.training.sae_factory import constraint_report

    cfg = lm.cut_depth(registry.get_arch(TRAIN_ARCH), INT8_LAYERS)
    steps, batch, micro, seq = train_args()
    spec = ProjectionSpec(pattern=r"(w_up|w_gate)", radius=radius)
    api = models.get(cfg)
    pipe = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq + 1,
                                   global_batch=batch, microbatch=micro))
    out, i8 = {}, {}

    def moments_of(state, part):
        return _tree.leaves_up_to(state["params"], state["opt"][part])

    for moments in ("int8", "float32"):
        tcfg = TrainConfig(microbatch=micro, lr=3e-4, total_steps=INT8_STEPS,
                           warmup=1, remat=True, master_dtype="",
                           moment_dtype=moments, projection=spec)
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()    # left by earlier phases
        torch.cuda.reset_peak_memory_stats()
        state = init_state(cfg, tcfg, api, SEED, device=dev)
        opt_bytes = sum(t.numel() * t.element_size() for t in
                        _tree.leaves(state["opt"]))
        fn = make_train_step(cfg, tcfg, api, impl="flash")
        losses, secs = [], []
        for s in range(INT8_STEPS):
            t0 = time.perf_counter()
            state, m = fn(state, {"tokens": torch.from_numpy(
                pipe.batch(s)).to(dev)})
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t0)
            if moments == "int8" and s == 0:
                i8["s1"] = {part: [qs["s"].clone() for qs in
                                   moments_of(state, part)]
                            for part in ("m", "v")}
                i8["p1"] = [p.to("cpu", copy=True) for p in _tree.leaves(state["params"])]
            elif moments == "int8" and s == 1:
                i8["q2"] = {part: [{k: t.to("cpu", copy=True) for k, t in qs.items()}
                                   for qs in moments_of(state, part)]
                            for part in ("m", "v")}
                i8["p2"] = [p.to("cpu", copy=True) for p in _tree.leaves(state["params"])]
            elif moments == "float32" and s == 1:
                worst, moved = hold_int8_step2(i8, state, tcfg, dev)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        rep = constraint_report(state["params"], spec)
        print(f"{moments} moments: granite-3-2b {cfg.n_layers} layers, "
              f"{INT8_STEPS} steps of {batch} x {seq} tokens: losses {losses}, "
              f"step seconds " + " ".join(f"{x:.3f}" for x in secs)
              + f"; optimizer state {opt_bytes / 1e9:.3f} GB; peak device "
              f"memory {peak / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB "
              f"allocated before; max_violation "
              f"{rep['max_violation']:.3e} (radius {radius:.6g})")
        if not all(np.isfinite(losses)):
            raise SmokeFailure(f"{moments} moments: losses {losses}")
        if not rep["max_violation"] <= 1e-5 * radius:
            raise SmokeFailure(f"{moments} moments: infeasible {rep}")
        out[moments] = {"losses": losses, "step_seconds": secs,
                        "peak_bytes": peak, "opt_bytes": opt_bytes,
                        "max_violation": rep["max_violation"]}
        del state, fn, m
        torch.cuda.empty_cache()
    del i8
    far = max(moved, key=moved.get)
    print(f"int8 moments after step 2 (the first update from dequantized "
          f"moments): m within {worst['m']:.4f} and sqrt(v) within "
          f"{worst['v']:.4f} of their per-block bars of the float32 run's; "
          f"params apart by at most {moved[far]:.4f} of the float32 run's "
          f"step-2 move ({far}; bar {INT8_PARAM_BAR}); "
          + "; ".join(f"{k} {v:.4f}" for k, v in sorted(moved.items())))
    l8, l32 = out["int8"]["losses"], out["float32"]["losses"]
    print(f"int8 moments: losses equal to the float32 run's through step 2 "
          f"by construction ({l8[:2] == l32[:2]}); step {INT8_STEPS}'s, the "
          f"first after a quantized update, {l8[-1]!r} against {l32[-1]!r} "
          f"({(l8[-1] - l32[-1]) / abs(l32[-1]):+.3e} relative)")
    if not (worst["m"] <= 1.0 and worst["v"] <= 1.0
            and moved[far] <= INT8_PARAM_BAR):
        raise SmokeFailure(f"int8 moments: after step 2, m {worst['m']:.4f} "
                           f"and sqrt(v) {worst['v']:.4f} of their bars, "
                           f"params {moved[far]:.4f} of the step ({far}, "
                           f"bar {INT8_PARAM_BAR})")
    saved = out["float32"]["peak_bytes"] - out["int8"]["peak_bytes"]
    print(f"int8 moments: peak {out['int8']['peak_bytes'] / 2**30:.2f} GiB against "
          f"{out['float32']['peak_bytes'] / 2**30:.2f} GiB with float32 moments "
          f"({saved / 2**30:.2f} GiB less; the state "
          f"{(out['float32']['opt_bytes'] - out['int8']['opt_bytes']) / 2**30:.2f}"
          f" GiB smaller)")
    out.update(peak_saved_bytes=saved, step2_moments=worst, step2_params=moved)
    return out


def serve_phase(dev, randn, rand):
    """Phase 10: (a)-(e) of the module docstring."""
    rec = serve_decode(dev)
    rec["service"] = serve_service(randn, rand)
    radius, _ = train_radius(dev)
    rec["telemetry"] = serve_telemetry(dev, radius)
    rec["int8"] = serve_int8(dev, radius)
    return rec


# the MoE family (phase 11): deepseek-v3-671b at full width cut to 4
# layers (3 dense MLA layers, 1 MoE layer of 256 experts, top-8, 1 shared),
# seeded float32: 15.11 B parameters, 60.4 GB. Kimi-k2's 384 experts would
# take about 80 GB in float32, so kimi-k2 trains its smoke config only.
MOE_ARCH = "deepseek-v3-671b"
MOE_LAYERS = 4
MOE_SERVE_ARGV = ["--arch", MOE_ARCH, "--layers", str(MOE_LAYERS), "--batch",
                  "8", "--prompt-len", "128", "--new", "16"]
MOE_DECODE_TIMED = 8          # decode steps timed after the held prompt
MOE_TOKENS = (8, 512)         # (c): 4096 tokens of layer 3, cap 160
MOE_ABSORB_BAR = 1e-4         # (b): of max|out|, float32
MOE_DISPATCH_BAR = 1e-5       # (c): of max|out|, float32
MOE_FACTORY = dict(arch=MOE_ARCH, smoke=False, depth=MOE_LAYERS, layers=(3,),
                   harvest_steps=1, seq_len=2048, lm_batch=2, expansion=2,
                   train_steps=4, sae_batch=4096, microbatch=1024)
MOE_SMOKE_STEPS, MOE_SMOKE_LR = 3, 3e-4
MOE_SMOKE_ARGV = ["--smoke", "--attn", "chunked", "--steps", str(MOE_SMOKE_STEPS),
                  "--lr", repr(MOE_SMOKE_LR), "--seq", "32", "--batch", "8",
                  "--microbatch", "4", "--radius", "0.5"]
# (e) trains in the launcher's bf16 compute, so its bars are
# tests/test_torch_train.py's bf16 ones: losses and gradient norms
# relative, params 2 · steps · lr (AdamW moves an entry about lr a step, and
# a gradient entry of the other sign moves it the other way) + 1e-5 of the
# leaf's largest entry; a router decision that flips sits within one bf16
# rounding (2^-7) of a tie
MOE_LOSS_RTOL, MOE_GNORM_RTOL, MOE_PARAM_ATOL = 1e-2, 5e-2, 1e-5
MOE_TIE = BF16_RTOL


def time_decode(step, params, nxt, cache, start, n):
    """``n`` greedy decode steps from position ``start`` (host clock between
    two synchronizes), then one more profiled: (ms a step, {device kernel:
    ms} of one step, device kernels and copies a step, that step's
    position)."""
    import torch

    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            nxt, _, cache = step(params, nxt, cache, start + i)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n
        pos = start + n

        def one():
            step(params, nxt, cache, pos)
        per_kernel = device_kernels(one)
        n_launch = sum(device_kernels(one, counts=True).values())
    return step_ms, per_kernel, n_launch, pos


def moe_serve(dev, smi):
    """(a) the serve launcher at full width, 4 layers, timed per decode step
    beside its byte bound; (b) layer 0's absorbed decode against the full
    expansion on the same hidden states. Returns the record and the
    launcher's result (its params serve (c))."""
    import torch

    from repro_torch import _tree
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    res = serve_cli.run(MOE_SERVE_ARGV)
    torch.cuda.synchronize()
    a = serve_args(MOE_SERVE_ARGV)
    b, plen, new = int(a["--batch"]), int(a["--prompt-len"]), int(a["--new"])
    cfg, params, prompts = res["cfg"], res["params"], res["prompts"]
    n_params = sum(p.numel() for p in _tree.leaves(params))
    toks = res["tokens"]
    if not (toks.dtype == torch.int32 and int(toks.min()) >= 0
            and int(toks.max()) < cfg.vocab and toks.shape == (b, new)):
        raise SmokeFailure(f"moe (a): tokens {toks.dtype} {tuple(toks.shape)} "
                           f"outside [0, {cfg.vocab})")
    print(f"moe (a) python -m repro_torch.launch.serve "
          f"{' '.join(MOE_SERVE_ARGV)}: {cfg.n_layers} layers ("
          f"{cfg.moe.first_dense} dense MLA, {cfg.n_layers - cfg.moe.first_dense}"
          f" MoE of {cfg.moe.n_experts} experts, top-{cfg.moe.top_k}, "
          f"{cfg.moe.n_shared} shared, dispatch {cfg.moe.dispatch}) at d_model "
          f"{cfg.d_model}, {n_params} float32 params ({n_params * 4 / 1e9:.2f} "
          f"GB); {res['seconds']:.3f} s for {b} x {new} new tokens after {plen} "
          f"prompt tokens ({res['tok_per_s']:.2f} tok/s, host clock, prompt "
          f"replay included; {res['seconds'] * 1e3 / (plen + new):.3f} ms a "
          f"decode step over the run's {plen + new}); {smi}")
    logits, cache, step = _decode_replay(cfg, params, prompts,
                                         plen + MOE_DECODE_TIMED + 2)
    if not bool(torch.isfinite(logits).all()):
        raise SmokeFailure("moe (a): non-finite decode logits")
    step_ms, per_kernel, n_launch, pos = time_decode(
        step, params, logits.argmax(-1).to(torch.int32), cache, plen,
        MOE_DECODE_TIMED)
    busy = sum(per_kernel.values())
    top = sorted(per_kernel, key=lambda k: -per_kernel[k])[:6]
    print("moe (a) a decode step's largest device kernels: " + "; ".join(
        f"{per_kernel[k]:.3f} ms {k[:70]}" for k in top))
    bms, wbytes = decode_bound_ms(cfg, params, b, pos + 1)
    per_token = sum(c[:, 0, 0].numel() * c.element_size() for c in cache.values())
    cache_bytes = sum(c.numel() * c.element_size() for c in cache.values())
    peak = torch.cuda.max_memory_allocated()
    print(f"moe (a) decode step at position {pos} (batch {b}): {step_ms:.3f} "
          f"ms (host clock, mean of {MOE_DECODE_TIMED}), {b / step_ms * 1e3:.2f} "
          f"tok/s; byte bound {bms:.3f} ms ({wbytes} bytes of weights, every "
          f"expert's with the einsum dispatch, + the cache over "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); {n_launch} device kernels and "
          f"copies a step, device busy {busy:.3f} ms; peak device memory "
          f"{peak / 2**30:.2f} GiB; cache {per_token} bytes a token "
          f"({cfg.n_layers} layers x {cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim}"
          f" x 4 B), {cache_bytes} bytes for {b} x {cache['c_kv'].shape[2]} "
          f"slots; {smi}")
    rec = {"argv": MOE_SERVE_ARGV, "params": n_params, "seconds": res["seconds"],
           "tok_per_s": res["tok_per_s"], "decode_step_ms": step_ms,
           "decode_tok_per_s": b / step_ms * 1e3, "bound_ms": bms,
           "weight_bytes": wbytes, "kernels_per_step": n_launch,
           "device_busy_ms": busy, "peak_bytes": peak,
           "top_kernels_ms": {k: per_kernel[k] for k in top},
           "cache_bytes_per_token": per_token, "cache_bytes": cache_bytes}
    del cache, step, logits

    # (b) layer 0's absorbed decode over the prompt against the full
    # expansion's rows, on the same hidden states
    lp = _tree.tree_map(lambda t: t[0], params["dense_blocks"])
    m = cfg.mla
    with torch.inference_mode():
        h = L.rms_norm(params["embed"][prompts].float(), lp["ln1"], cfg.norm_eps)
        positions = torch.arange(plen, device=dev)[None].expand(b, plen)
        full = lm._attn_mla(lp["attn"], h, cfg, positions=positions,
                            impl="chunked", window=None)
        lat = {"c_kv": torch.zeros(b, plen, m.kv_lora_rank, device=dev),
               "k_rope": torch.zeros(b, plen, m.qk_rope_dim, device=dev)}
        outs = []
        for p in range(plen):
            freqs = L.rope_frequencies(m.qk_rope_dim, 1.0, cfg.rope_theta,
                                       torch.full((b, 1), p, device=dev))
            outs.append(lm._attn_mla_decode(lp["attn"], h[:, p:p + 1], cfg,
                                            pos=p, freqs=freqs, cache=lat))
        got = torch.cat(outs, dim=1)
    scale = float(full.abs().max())
    err_last = float((got[:, -1] - full[:, -1]).abs().max())
    err = float((got - full).abs().max())
    print(f"moe (b) layer 0 absorbed decode vs the full expansion (chunked) on "
          f"the prompt's hidden states: position {plen - 1} max_abs_err "
          f"{err_last:.3e}, all {plen} positions {err:.3e} (bar "
          f"{MOE_ABSORB_BAR} x max|out| {scale:.4g}, float32); {smi}")
    if not (bool(torch.isfinite(got).all()) and err <= MOE_ABSORB_BAR * scale):
        raise SmokeFailure(f"moe (b): absorbed decode {err:.3e} from the "
                           f"expansion (bar {MOE_ABSORB_BAR * scale:.3e})")
    rec["absorb"] = {"max_abs_err_last": err_last, "max_abs_err": err,
                     "scale": scale, "bar": MOE_ABSORB_BAR}
    del full, got, outs, lat, h
    return rec, res


def moe_dispatch(dev, res, smi):
    """(c) the einsum and the scatter dispatch on the same 4096 tokens of
    layer 3 (the hidden states of seeded tokens through layers 0-2 and
    layer 3's attention): equal routing, outputs and aux within float32
    bars; the dropped share there and at decode (cap 1 at batch 8)."""
    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    cfg, params = res["cfg"], res["params"]
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab, MOE_TOKENS), device=dev)
    bsz, seq = MOE_TOKENS
    positions = torch.arange(seq, device=dev)[None].expand(bsz, seq)
    with torch.inference_mode():
        x = params["embed"][toks]
        dense = params["dense_blocks"]
        for i in range(cfg.moe.first_dense):
            x, _, _ = lm._block(_tree.tree_map(lambda t: t[i], dense), x, cfg,
                                positions=positions, impl="chunked")
        lp = _tree.tree_map(lambda t: t[0], params["moe_blocks"])
        x = x + lm._attn_mla(lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                             cfg, positions=positions, impl="chunked",
                             window=None)
        h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        flat = h2.reshape(bsz * seq, cfg.d_model)
        out, ms = {}, {}
        for d in ("einsum", "scatter"):
            mcfg = dataclasses.replace(cfg.moe, dispatch=d)
            route = L.moe_route(lp["mlp"], flat, mcfg, n_groups=1)
            out[d] = (route, *L.moe_apply(lp["mlp"], flat, mcfg, n_groups=1))
            torch.cuda.synchronize()
            ms[d] = event_ms(lambda: L.moe_apply(lp["mlp"], flat, mcfg,
                                                 n_groups=1), reps=3)
        (r_e, y_e, aux_e), (r_s, y_s, aux_s) = out["einsum"], out["scatter"]
        # the router again on the CPU, from the same inputs (shown only)
        cpu_i = L.moe_route({"router": lp["mlp"]["router"].cpu()}, flat.cpu(),
                            cfg.moe, n_groups=1)["top_i"]
        dec = L.moe_route(lp["mlp"], h2[:, -1], cfg.moe, n_groups=1)
    if r_e["cap"] != 160:
        raise SmokeFailure(f"moe (c): cap {r_e['cap']} at {bsz * seq} tokens, "
                           "not 160")
    if not (torch.equal(r_e["top_i"], r_s["top_i"])
            and torch.equal(r_e["keep"], r_s["keep"])):
        raise SmokeFailure("moe (c): the two dispatches routed differently")
    scale = float(y_e.abs().max())
    err = check_close("moe (c) scatter vs einsum", y_s, y_e, scale, rtol=0.0)
    if not err <= MOE_DISPATCH_BAR * scale:
        raise SmokeFailure(f"moe (c): outputs {err:.3e} apart (bar "
                           f"{MOE_DISPATCH_BAR * scale:.3e})")
    aux_err = abs(float(aux_e) - float(aux_s))
    if not (math.isfinite(float(aux_e)) and aux_err <= RTOL * abs(float(aux_e))):
        raise SmokeFailure(f"moe (c): aux {float(aux_e)} vs {float(aux_s)}")
    dropped = float((~r_e["keep"]).float().mean())
    dec_dropped = float((~dec["keep"]).float().mean())
    same_cpu = float((cpu_i == r_e["top_i"].cpu()).all(-1).float().mean())
    print(f"moe (c) layer 3 at {bsz * seq} tokens (cap {r_e['cap']}): routing "
          f"and keep equal for the two dispatches; scatter vs einsum max_abs_err "
          f"{err:.3e} (bar {MOE_DISPATCH_BAR} x max|out| {scale:.4g}), aux "
          f"{float(aux_e):.6f} vs {float(aux_s):.6f}; dropped share "
          f"{dropped:.4f} of {r_e['keep'].numel()} slots; at decode (batch "
          f"{bsz}, cap {dec['cap']}) {dec_dropped:.4f}; einsum {ms['einsum']:.2f} "
          f"ms, scatter {ms['scatter']:.2f} ms (events, median of 3); tokens "
          f"routed as on the CPU {same_cpu:.4f}; {smi}")
    return {"tokens": bsz * seq, "cap": r_e["cap"], "max_abs_err": err,
            "scale": scale, "aux": [float(aux_e), float(aux_s)],
            "dropped_share": dropped, "decode_cap": dec["cap"],
            "decode_dropped_share": dec_dropped, "einsum_ms": ms["einsum"],
            "scatter_ms": ms["scatter"], "routed_as_cpu": same_cpu}


def moe_harvest(dev, workdir, smi):
    """(d) ``run_factory`` from the same cut model (``depth`` 4, seed 0,
    as the launcher's) with ``impl="chunked"``: one harvest step of 2 x
    2048 tokens at layer 3, then SAE steps at d_model 7168; the LM's
    parameters are gone before the first SAE step (the memory allocated
    there, read through a wrapper of ``train_sae``)."""
    import torch

    from repro_torch.models import lm
    from repro_torch.models import params as PM
    from repro_torch.training import sae_factory as F

    fcfg = F.SAEFactoryConfig(**MOE_FACTORY)
    shutil.rmtree(workdir, ignore_errors=True)
    before = torch.cuda.memory_allocated()
    at_sae = []
    train_sae = F.train_sae

    def watched(*a, **k):
        at_sae.append(torch.cuda.memory_allocated())
        return train_sae(*a, **k)

    F.train_sae = watched
    t0 = time.perf_counter()
    try:
        summary = F.run_factory(fcfg, workdir, seeds=(0, 1), impl="chunked")
    finally:
        F.train_sae = train_sae
        shutil.rmtree(workdir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    rec = summary["layers"][3]
    losses = rec["losses"]
    feasible = all(c["feasible"] for c in rec["constraint"].values())
    finite = all(math.isfinite(v) for ls in losses.values() for v in ls)
    lm_bytes = 4 * PM.count_params(lm.template(F._arch(fcfg)))
    print(f"moe (d) run_factory {MOE_ARCH} depth {MOE_LAYERS} chunked: "
          f"{summary['meta']['rows_per_shard']} rows at layer 3 (d_model "
          f"{summary['meta']['d_model']}), {fcfg.train_steps} SAE steps of "
          f"{fcfg.sae_batch} rows, d_dict "
          f"{fcfg.expansion * summary['meta']['d_model']}, seeds 0 and "
          f"1 in {seconds:.1f} s; losses {losses}; feasible {feasible}; mmcs "
          f"{rec['mmcs']}; memory allocated at each SAE start "
          f"{[round(x / 2**30, 2) for x in at_sae]} GiB ({before / 2**30:.2f} "
          f"GiB before the factory); {smi}")
    if not (finite and feasible):
        raise SmokeFailure(f"moe (d): finite {finite}, feasible {feasible}")
    if not at_sae or max(at_sae) - before > 0.25 * lm_bytes:
        raise SmokeFailure(f"moe (d): {at_sae} bytes allocated at an SAE "
                           "start: the LM was not freed")
    return {"seconds": seconds, "losses": losses, "feasible": feasible,
            "mmcs": rec["mmcs"], "allocated_at_sae": at_sae,
            "meta": summary["meta"]}


def card_vs_cpu(card, cpu, slack):
    """Two launcher runs' largest relative gaps in losses and gradient norms
    (``{"losses", "grad_norms"}``), and the worst parameter gap past
    ``slack``, over its leaf's largest entry."""
    from repro_torch import _tree

    rel = {k: max(abs(a - b) / abs(b) for a, b in zip(card[k], cpu[k]))
           for k in ("losses", "grad_norms")}
    worst = 0.0
    for (_, p), (_, q) in zip(
            _tree.leaves_with_paths(card["state"]["params"]),
            _tree.leaves_with_paths(cpu["state"]["params"])):
        q = q.float()
        d = (p.cpu().float() - q).abs() - slack
        worst = max(worst, float(d.max()) / max(float(q.abs().max()), 1e-30))
    return rel, worst


def _routing_flips(card, cpu):
    """Compare the router's decisions of two runs call by call (each a list
    of ``{"top_i", "keep", "probs"}`` on the host): ``(calls that differ,
    the first such call's index, the largest gap, in the CPU's
    probabilities, between the expert each run chose where they chose
    differently there)``. Before the runs diverge both compute one function
    up to rounding, so their first difference must sit on a near tie."""
    import torch

    if len(card) != len(cpu):
        raise SmokeFailure(f"moe (e): {len(card)} router calls on the card, "
                           f"{len(cpu)} on the CPU")
    differ = [i for i, (a, b) in enumerate(zip(card, cpu))
              if not (torch.equal(a["top_i"], b["top_i"])
                      and torch.equal(a["keep"], b["keep"]))]
    if not differ:
        return 0, None, 0.0
    a, b = card[differ[0]], cpu[differ[0]]
    moved = a["top_i"] != b["top_i"]
    if not bool(moved.any()):
        raise SmokeFailure("moe (e): keep differs where the experts agree")
    p = b["probs"]
    gap = (p.gather(-1, a["top_i"]) - p.gather(-1, b["top_i"])).abs()[moved]
    return len(differ), differ[0], float(gap.max())


def moe_smoke_trains(smi, workdir):
    """(e) the train launcher on both MoE archs' smoke configs, 3 steps in
    its bf16 compute with every ``w_up``/``w_gate`` projected, on the card
    and on the CPU from one init (the launcher's own state at step 0, drawn
    on the CPU and saved with ``--steps 0``, which both runs restore with
    ``--ckpt``), each router decision recorded: losses within
    MOE_LOSS_RTOL, gradient norms within MOE_GNORM_RTOL, the final params
    within 2 · steps · lr + MOE_PARAM_ATOL of each leaf's largest entry;
    where the routing first differs, the experts the two runs chose within
    MOE_TIE of each other in the CPU's probabilities."""
    import torch

    from repro_torch.launch import train as train_cli
    from repro_torch.models import layers as L

    route = L.moe_route
    out = {}
    for arch in (MOE_ARCH, "kimi-k2-1t-a32b"):
        shutil.rmtree(workdir, ignore_errors=True)
        argv = ["--arch", arch] + MOE_SMOKE_ARGV
        with contextlib.redirect_stdout(None):
            train_cli.run(argv + ["--device", "cpu", "--steps", "0", "--ckpt",
                                  str(workdir / "init")])
        runs, calls = {}, {}
        for device in ("cuda", "cpu"):
            calls[device] = []

            def recording(*a, log=calls[device], **k):
                r = route(*a, **k)
                log.append({n: r[n].detach().cpu()
                            for n in ("top_i", "keep", "probs")})
                return r

            shutil.copytree(workdir / "init", workdir / device)
            L.moe_route = recording
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(None):
                    runs[device] = train_cli.run(
                        argv + ["--device", device, "--ckpt", str(workdir / device)])
            finally:
                L.moe_route = route
            runs[device]["wall"] = time.perf_counter() - t0
        shutil.rmtree(workdir, ignore_errors=True)
        card, cpu = runs["cuda"], runs["cpu"]
        n_diff, first, gap = _routing_flips(calls["cuda"], calls["cpu"])
        # each (layer, expert) slice's columns that the projection zeroed
        experts = {k: float((card["state"]["params"]["moe_blocks"]["mlp"][k]
                             .abs().amax(dim=2) == 0).float().mean())
                   for k in ("w_up", "w_gate")}
        slack = 2 * MOE_SMOKE_STEPS * MOE_SMOKE_LR
        rel, worst = card_vs_cpu(card, cpu, slack)
        flips = ("the same routing in all " if not n_diff else
                 f"routing differs in {n_diff} of ") + \
            f"{len(calls['cpu'])} router calls" + (
                "" if not n_diff else f", first at call {first} on a near tie "
                f"(chosen experts' CPU probabilities {gap:.3e} apart, bar "
                f"{MOE_TIE})")
        print(f"moe (e) launch.train {arch} {' '.join(MOE_SMOKE_ARGV)} (bf16 "
              f"compute): {flips}; losses card {card['losses']} cpu "
              f"{cpu['losses']}, max rel {rel['losses']:.3e} (bar "
              f"{MOE_LOSS_RTOL}); gradient norms max rel "
              f"{rel['grad_norms']:.3e} (bar {MOE_GNORM_RTOL}); params worst "
              f"{worst:.3e} of the leaf's largest entry past {slack:.1e} (bar "
              f"{MOE_PARAM_ATOL}); column sparsity "
              f"{card['sparsity']}, per (layer, expert) slice {experts}; "
              f"{card['wall']:.1f} s on the card, "
              f"{cpu['wall']:.1f} s on the CPU; {smi}")
        if not (all(math.isfinite(v) for v in card["losses"])
                and rel["losses"] <= MOE_LOSS_RTOL
                and rel["grad_norms"] <= MOE_GNORM_RTOL
                and worst <= MOE_PARAM_ATOL and gap <= MOE_TIE
                and min(experts.values()) > 0):
            raise SmokeFailure(f"moe (e) {arch}: card vs CPU {rel}, params "
                               f"{worst:.3e}, tie gap {gap:.3e}")
        out[arch] = {"losses": card["losses"], "cpu_losses": cpu["losses"],
                     "max_rel": rel, "params_worst": worst,
                     "router_calls": len(calls["cpu"]),
                     "router_calls_differ": n_diff, "first_differ": first,
                     "tie_gap": gap, "sparsity": card["sparsity"],
                     "expert_columns_zero": experts}
        del runs, card, cpu, calls
    torch.cuda.empty_cache()
    return out


def moe_phase(dev, smi):
    """Phase 11: (a)-(e) of the module docstring, from freed memory; the
    launch counts of every kernel over the phase (all 0: MLA runs the
    chunked attention and the trainer the plain projection)."""
    import torch

    from repro_torch.kernels import _build

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    rec, res = moe_serve(dev, smi)
    rec["dispatch"] = moe_dispatch(dev, res, smi)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    rec["harvest"] = moe_harvest(dev, ROOT / "build" / "chip_smoke_moe", smi)
    rec["smoke_train"] = moe_smoke_trains(smi, ROOT / "build" /
                                          "chip_smoke_moe_train")
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    rec.update(launches=launches, phase_seconds=time.perf_counter() - t0,
               base_bytes=base, phase_peak_bytes=torch.cuda.max_memory_allocated())
    print(f"moe: phase 11 in {rec['phase_seconds']:.1f} s; peak device memory "
          f"{rec['phase_peak_bytes'] / 2**30:.2f} GiB ({base / 2**30:.2f} GiB "
          f"allocated before); kernel launches {launches}; {smi}")
    if any(launches.values()):
        raise SmokeFailure(f"moe: phase 11 launched kernels {launches}; its "
                           "paths run none")
    return rec


# the recurrent families (phase 12): zamba2-7b and xlstm-1.3b at full width,
# seeded float32. Served at full depth; trained cut to 13 and 8 layers (one
# xLSTM super-block: the script's time limit, with phase 16).
REC_SERVE_ARGV = ["--batch", "8", "--prompt-len", "128", "--new", "16"]
REC_DECODE_TIMED = 8          # decode steps timed after the held prompt
REC_SSD_TOKENS = 256          # (b): two of zamba's 128-token chunks
REC_SSD_BAR = 1e-4            # (b): of max|y|, float32
REC_MLSTM_BAR = 1e-4          # (d): of max|y|, float32
REC_PATTERN = r"(w_up|w_gate|w_in)"   # the launcher's; mLSTM's w_gates too
REC_RADIUS_FRACTION = 0.05    # of the init's smallest per-slice l1,inf norm
REC_TRAIN = {  # arch -> the train launcher's argv at full width
    "zamba2-7b": ["--layers", "13", "--batch", "8", "--microbatch", "4",
                  "--seq", "2048", "--steps", "3"],
    "xlstm-1.3b": ["--layers", "8", "--batch", "8", "--microbatch", "8",
                   "--seq", "2048", "--steps", "3"],
}
REC_SMOKE_RADIUS = {"zamba2-7b": 5.0, "xlstm-1.3b": 0.5}
REC_SMOKE_ARGV = ["--smoke", "--steps", str(MOE_SMOKE_STEPS), "--lr",
                  repr(MOE_SMOKE_LR), "--seq", "32", "--batch", "8",
                  "--microbatch", "4"]


def _bilevel_slices(w):
    """A matched leaf's (rows, cols) slices over its leading axes."""
    return w.reshape((-1,) + tuple(w.shape[-2:]))


def rec_radius(dev, cfg):
    """REC_RADIUS_FRACTION of the smallest per-slice bi-level l1,inf norm of
    the launcher's seed-0 init of the leaves REC_PATTERN matches (each leaf
    drawn alone: its generator is seeded from its path), and that norm."""
    from repro_torch import _tree, models
    from repro_torch.configs.types import ProjectionSpec
    from repro_torch.core.multilevel import multilevel_norm
    from repro_torch.models import params as PM

    levels = list(ProjectionSpec().levels)
    norms = []
    for path, pd in _tree.leaves_with_paths(models.get(cfg).template(cfg)):
        if len(pd.shape) < 2 or not re.search(REC_PATTERN, path):
            continue
        one = pd
        for k in reversed(path.split("/")):
            one = {k: one}
        w = _tree.leaves(PM.init_params(one, SEED, device=dev))[0]
        norms += [float(multilevel_norm(x, levels)) for x in _bilevel_slices(w)]
        del w
    return REC_RADIUS_FRACTION * min(norms), min(norms)


def rec_bound_ms(params, cache, batch, valid):
    """One decode step's byte bound: every weight read once (the input
    embedding by the batch's rows), the recurrent state read and written
    once, and the KV cache's ``valid`` slots read once."""
    from repro_torch import _tree

    nbytes = sum(batch * p.shape[1] * p.element_size() if name == "embed"
                 else p.numel() * p.element_size()
                 for name, p in _tree.leaves_with_paths(params))
    state = kv = 0
    for name, c in cache.items():
        if name in ("k", "v"):
            kv += c[:, :, :valid].numel() * c.element_size()
        else:
            state += 2 * c.numel() * c.element_size()
    return (nbytes + state + kv) / HBM_BYTES_PER_S * 1e3, nbytes, state, kv


def rec_serve(dev, smi, arch):
    """(a), and (d)'s serving: the serve launcher at full width and depth,
    held against the teacher-forced forward and timed per decode step."""
    import torch

    from repro_torch import _tree, models
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serving import lm

    argv = ["--arch", arch] + REC_SERVE_ARGV
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = serve_cli.run(argv)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    a = serve_args(argv)
    b, plen, new = int(a["--batch"]), int(a["--prompt-len"]), int(a["--new"])
    cfg, params, prompts = res["cfg"], res["params"], res["prompts"]
    n_params = sum(p.numel() for p in _tree.leaves(params))
    toks = res["tokens"]
    if not (toks.dtype == torch.int32 and int(toks.min()) >= 0
            and int(toks.max()) < cfg.vocab and toks.shape == (b, new)):
        raise SmokeFailure(f"recurrent (a) {arch}: tokens {toks.dtype} "
                           f"{tuple(toks.shape)} outside [0, {cfg.vocab})")
    print(f"recurrent {arch} python -m repro_torch.launch.serve {' '.join(argv)}"
          f": {cfg.n_layers} layers d_model {cfg.d_model}, {n_params} float32 "
          f"params ({n_params * 4 / 1e9:.2f} GB); {res['seconds']:.3f} s for "
          f"{b} x {new} new tokens after {plen} prompt tokens "
          f"({res['tok_per_s']:.2f} tok/s, host clock, prompt replay included;"
          f" {res['seconds'] * 1e3 / (plen + new):.3f} ms a decode step over "
          f"the run's {plen + new}); peak device memory {peak / 2**30:.2f} GiB;"
          f" {smi}")
    logits, cache, step = _decode_replay(cfg, params, prompts,
                                         plen + REC_DECODE_TIMED + 2)
    want = lm.make_prefill(cfg, models.get(cfg))(params, prompts)
    scale = float(want.abs().max())
    err = float((logits - want).abs().max())
    print(f"recurrent {arch}: decode vs the teacher-forced forward at position "
          f"{plen - 1}: max_abs_err {err:.3e} (bar {SERVE_BAR} x max|logits| "
          f"{scale:.4g})")
    if not (bool(torch.isfinite(logits).all()) and err <= SERVE_BAR * scale):
        raise SmokeFailure(f"recurrent {arch}: decode logits {err:.3e} from the "
                           f"forward's (bar {SERVE_BAR * scale:.3e})")
    del want
    step_ms, per_kernel, n_launch, pos = time_decode(
        step, params, logits.argmax(-1).to(torch.int32), cache, plen,
        REC_DECODE_TIMED)
    busy = sum(per_kernel.values())
    top = sorted(per_kernel, key=lambda k: -per_kernel[k])[:6]
    print(f"recurrent {arch} a decode step's largest device kernels: " + "; ".join(
        f"{per_kernel[k]:.3f} ms {k[:70]}" for k in top))
    bms, wbytes, sbytes, kvbytes = rec_bound_ms(params, cache, b, pos + 1)
    bound_by = "host" if busy < 0.5 * step_ms else "device"
    print(f"recurrent {arch} decode step at position {pos} (batch {b}): "
          f"{step_ms:.3f} ms (host clock, mean of {REC_DECODE_TIMED}), "
          f"{b / step_ms * 1e3:.2f} tok/s; byte bound {bms:.3f} ms ({wbytes} "
          f"bytes of weights + {sbytes} of recurrent state read and written + "
          f"{kvbytes} of KV read, over {HBM_BYTES_PER_S / 1e12:.2f} TB/s); "
          f"{n_launch} device kernels and copies a step "
          f"({n_launch / cfg.n_layers:.1f} a layer), device busy {busy:.3f} ms: "
          f"{bound_by}-bound; {smi}")
    rec = {"argv": argv, "params": n_params, "seconds": res["seconds"],
           "tok_per_s": res["tok_per_s"], "peak_bytes": peak,
           "max_abs_err": err, "scale": scale, "decode_step_ms": step_ms,
           "decode_tok_per_s": b / step_ms * 1e3, "bound_ms": bms,
           "weight_bytes": wbytes, "state_bytes_rw": sbytes,
           "kv_bytes": kvbytes, "kernels_per_step": n_launch,
           "device_busy_ms": busy, "bound_by": bound_by,
           "top_kernels_ms": {k: per_kernel[k] for k in top}}
    del cache, step, logits
    return rec, res


def zamba_ssd(dev, smi, res):
    """(b): zamba's layer 0 at full width on REC_SSD_TOKENS seeded tokens,
    the chunked SSD against the token-by-token recurrence (``mamba2_apply``
    with a state, one token a call); then one backward through the chunked
    form, whose dt-gradient must be finite."""
    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.models import layers as L

    cfg, params = res["cfg"], res["params"]
    ssm = cfg.ssm
    lp = _tree.tree_map(lambda t: t[0, 0], params["mamba_super"])
    norm = params["mamba_norm"]["super"][0, 0]
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (2, REC_SSD_TOKENS)), device=dev)
    di = ssm.expand * cfg.d_model
    h = di // ssm.head_dim
    gn = ssm.n_groups * ssm.d_state
    with torch.inference_mode():
        x = L.rms_norm(params["embed"][toks], norm, cfg.norm_eps)
        y, _ = L.mamba2_apply(lp, x, ssm)
        state = (torch.zeros(2, ssm.d_conv, di + 2 * gn, device=dev),
                 torch.zeros(2, h, ssm.d_state, ssm.head_dim, device=dev))
        ys = []
        for t in range(REC_SSD_TOKENS):
            yt, state = L.mamba2_apply(lp, x[:, t:t + 1], ssm, state=state)
            ys.append(yt)
        seq = torch.cat(ys, dim=1)
        # the largest exponent off the causal triangle: (chunk - 1) · max dt
        dt = torch.nn.functional.softplus(
            (x @ lp["w_in"])[..., -h:].float() + lp["dt_bias"].float())
    scale = float(seq.abs().max())
    err = float((y - seq).abs().max())
    off = (ssm.chunk - 1) * float(dt.max())
    x = x.clone().requires_grad_(True)
    w = {k: v.detach().clone().requires_grad_(k == "dt_bias") for k, v in lp.items()}
    out, _ = L.mamba2_apply(w, x, ssm)
    out.float().square().mean().backward()
    finite = bool(torch.isfinite(w["dt_bias"].grad).all()
                  and torch.isfinite(x.grad).all())
    print(f"recurrent (b) zamba layer 0 on {REC_SSD_TOKENS} tokens "
          f"({REC_SSD_TOKENS // ssm.chunk} chunks of {ssm.chunk}, {h} heads "
          f"over {ssm.n_groups} groups): chunked vs token-by-token max_abs_err "
          f"{err:.3e} (bar {REC_SSD_BAR} x max|y| {scale:.4g}); the largest "
          f"off-triangle exponent {off:.2f} (float32 exp overflows past 88.72)"
          f"; dt_bias and input gradients finite {finite}; {smi}")
    if not (err <= REC_SSD_BAR * scale and finite):
        raise SmokeFailure(f"recurrent (b): SSD {err:.3e} from the recurrence "
                           f"(bar {REC_SSD_BAR * scale:.3e}), finite grads {finite}")
    return {"tokens": REC_SSD_TOKENS, "max_abs_err": err, "scale": scale,
            "off_triangle_exponent": off, "grads_finite": finite}


def xlstm_layers(dev, smi, res):
    """(d): xLSTM's layer 0 at full width on the prompts' embeddings, the
    chunkwise mLSTM against the sequential recurrence; then super-block 0's
    sLSTM at the training shape (REC_TRAIN's batch and sequence, bf16
    compute), its time loop timed forward and forward+backward (host clock
    around a synchronize) and its device kernels per time step counted on
    16 steps."""
    import torch

    from repro_torch import _tree
    from repro_torch.models import xlstm

    cfg, params, prompts = res["cfg"], res["params"], res["prompts"]
    lp = _tree.tree_map(lambda t: t[0, 0], params["mlstm"])
    with torch.inference_mode():
        x = params["embed"][prompts]
        ch, st_c = xlstm._mlstm_block(lp, x, cfg, seq_mode="chunkwise")
        sq, st_s = xlstm._mlstm_block(lp, x, cfg, seq_mode="sequential")
    scale = float(sq.abs().max())
    err = float((ch - sq).abs().max())
    c_err = float((st_c[0] - st_s[0]).abs().max()) / float(st_s[0].abs().max())
    print(f"recurrent (d) xlstm layer 0 on the prompts ({tuple(prompts.shape)}, "
          f"chunk {cfg.xlstm.chunk}): chunkwise vs sequential max_abs_err "
          f"{err:.3e} (bar {REC_MLSTM_BAR} x max|y| {scale:.4g}), final C "
          f"{c_err:.3e} of its largest entry; {smi}")
    if not (err <= REC_MLSTM_BAR * scale and c_err <= REC_MLSTM_BAR):
        raise SmokeFailure(f"recurrent (d): chunkwise mLSTM {err:.3e} from the "
                           f"sequential (bar {REC_MLSTM_BAR * scale:.3e}), C "
                           f"{c_err:.3e}")
    del ch, sq, st_c, st_s
    a = serve_args(REC_TRAIN["xlstm-1.3b"])
    b, s = int(a["--microbatch"]), int(a["--seq"])
    sp = _tree.tree_map(lambda t: t[0].to(torch.bfloat16).requires_grad_(),
                        params["slstm"])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xs = torch.randn(b, s, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        xlstm._slstm_block(sp, xs[:, :16], cfg)                # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xlstm._slstm_block(sp, xs, cfg)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        per_step = sum(device_kernels(
            lambda: xlstm._slstm_block(sp, xs[:, :16], cfg), counts=True)
            .values()) / 16
    t0 = time.perf_counter()
    y, _ = xlstm._slstm_block(sp, xs, cfg)
    y.float().square().mean().backward()
    torch.cuda.synchronize()
    fb_ms = (time.perf_counter() - t0) * 1e3
    print(f"recurrent (d) xlstm sLSTM block at ({b}, {s}) bf16: forward "
          f"{fwd_ms:.1f} ms ({fwd_ms / s * 1e3:.1f} us a time step), forward+"
          f"backward {fb_ms:.1f} ms ({fb_ms / s * 1e3:.1f} us a time step; host "
          f"clock); {per_step:.1f} device kernels a forward time step; {smi}")
    del sp, xs, y
    return {"max_abs_err": err, "scale": scale, "state_rel_err": c_err,
            "slstm_shape": [b, s], "slstm_fwd_ms": fwd_ms,
            "slstm_fwd_bwd_ms": fb_ms, "slstm_kernels_per_step": per_step}


def rec_train(dev, smi, arch, train_argv=None, tag="recurrent"):
    """(c), and (d)'s training: the train launcher at full width, cut to
    REC_TRAIN's depth (``train_argv``'s, at full depth without
    ``--layers``), 3 bf16 steps with the constraint on REC_PATTERN."""
    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.configs import registry
    from repro_torch.configs.types import ProjectionSpec
    from repro_torch.launch import train as train_cli
    from repro_torch.models import lm
    from repro_torch.training.sae_factory import constraint_report

    train_argv = train_argv or REC_TRAIN[arch]
    argv = ["--arch", arch] + train_argv
    a = serve_args(train_argv)
    cfg = registry.get_arch(arch)
    if "--layers" in a:
        cfg = lm.cut_depth(cfg, int(a["--layers"]))
    radius, init_norm = rec_radius(dev, cfg)
    argv += ["--radius", repr(radius)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train_cli.run(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    params = out["state"]["params"]
    n_params = sum(p.numel() for p in _tree.leaves(params))
    losses, gnorms = out["losses"], out["grad_norms"]
    step_s = out["step_seconds"]
    steps = int(a["--steps"])
    depth = (f"{cfg.n_enc_layers} encoder + {cfg.n_layers} decoder"
             if cfg.n_enc_layers else str(cfg.n_layers))
    print(f"{tag} {arch} python -m repro_torch.launch.train {' '.join(argv)}"
          f": {depth} layers d_model {cfg.d_model}, {n_params} float32 "
          f"params; {run_s:.1f} s (init and {steps} steps); step seconds "
          + " ".join(f"{x:.3f}" for x in step_s)
          + f"; losses {losses} gradient norms {gnorms}; peak device memory "
          f"{peak / 2**30:.2f} GiB; radius {radius:.6g} = {REC_RADIUS_FRACTION} x "
          f"the init's smallest per-slice l1,inf norm ({init_norm:.6g}); {smi}")
    if not (len(losses) == steps and all(np.isfinite(losses))
            and all(np.isfinite(gnorms))):
        raise SmokeFailure(f"{tag} {arch} train: losses {losses}, gradient "
                           f"norms {gnorms}")
    spec = ProjectionSpec(pattern=REC_PATTERN, radius=radius)
    rep = constraint_report(params, spec)
    if not rep["max_violation"] <= 1e-5 * radius:
        raise SmokeFailure(f"{tag} {arch} train: infeasible {rep}")
    sparsity = {}
    for name, w in _tree.leaves_with_paths(params):
        if name not in rep["norms"]:
            continue
        cols = _bilevel_slices(w).abs().amax(dim=1)
        per = (100.0 * (cols == 0).float().mean(dim=1)).tolist()
        sparsity[name] = per
        print(f"{tag} {arch} train {name} {tuple(w.shape)}: per-slice "
              f"column sparsity min {min(per):.2f}% mean "
              f"{sum(per) / len(per):.2f}% max {max(per):.2f}% over "
              f"{len(per)} slices; largest norm {rep['norms'][name]:.6g}")
        # every slice keeps a column, and the constraint zeroes columns in
        # every leaf: a slice of few columns (mLSTM's 8-column w_gates) may
        # have all of them back after AdamW's next move of about lr
        if not (all(x < 100.0 for x in per) and max(per) > 0.0):
            raise SmokeFailure(f"{tag} {arch} train: {name} per-slice column "
                               f"sparsity {per}: a slice lost every column, or "
                               "the leaf none")
    del out, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"argv": argv, "params": n_params, "losses": losses,
            "grad_norms": gnorms, "step_seconds": step_s, "run_s": run_s,
            "peak_bytes": peak,
            "radius": radius, "init_norm": init_norm,
            "max_violation": rep["max_violation"], "sparsity": sparsity}


def rec_smoke_trains(smi, workdir, radii=None, tag="recurrent (e)"):
    """(e): the train launcher on both archs' smoke configs (``radii``'s
    archs, each with its radius; REC_SMOKE_RADIUS's), 3 steps in its
    bf16 compute with the constraint on, on the card and on the CPU from one
    init (drawn on the CPU and saved with ``--steps 0``, which both runs
    restore with ``--ckpt``): losses within MOE_LOSS_RTOL, gradient norms
    within MOE_GNORM_RTOL, the final params within 2 · steps · lr +
    MOE_PARAM_ATOL of each leaf's largest entry."""
    import torch

    from repro_torch.launch import train as train_cli

    out = {}
    for arch, radius in (radii or REC_SMOKE_RADIUS).items():
        shutil.rmtree(workdir, ignore_errors=True)
        argv = ["--arch", arch, "--radius", repr(radius)] + REC_SMOKE_ARGV
        with contextlib.redirect_stdout(None):
            train_cli.run(argv + ["--device", "cpu", "--steps", "0", "--ckpt",
                                  str(workdir / "init")])
        runs = {}
        for device in ("cuda", "cpu"):
            shutil.copytree(workdir / "init", workdir / device)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(None):
                runs[device] = train_cli.run(
                    argv + ["--device", device, "--ckpt", str(workdir / device)])
            runs[device]["wall"] = time.perf_counter() - t0
        shutil.rmtree(workdir, ignore_errors=True)
        card, cpu = runs["cuda"], runs["cpu"]
        slack = 2 * MOE_SMOKE_STEPS * MOE_SMOKE_LR
        rel, worst = card_vs_cpu(card, cpu, slack)
        print(f"{tag} launch.train {' '.join(argv)} (bf16 compute): "
              f"losses card {card['losses']} cpu {cpu['losses']}, max rel "
              f"{rel['losses']:.3e} (bar {MOE_LOSS_RTOL}); gradient norms max "
              f"rel {rel['grad_norms']:.3e} (bar {MOE_GNORM_RTOL}); params worst "
              f"{worst:.3e} of the leaf's largest entry past {slack:.1e} (bar "
              f"{MOE_PARAM_ATOL}); column sparsity {card['sparsity']}; "
              f"{card['wall']:.1f} s on the card, {cpu['wall']:.1f} s on the "
              f"CPU; {smi}")
        if not (all(math.isfinite(v) for v in card["losses"])
                and rel["losses"] <= MOE_LOSS_RTOL
                and rel["grad_norms"] <= MOE_GNORM_RTOL
                and worst <= MOE_PARAM_ATOL):
            raise SmokeFailure(f"{tag} {arch}: card vs CPU {rel}, params "
                               f"{worst:.3e}")
        out[arch] = {"losses": card["losses"], "cpu_losses": cpu["losses"],
                     "max_rel": rel, "params_worst": worst,
                     "sparsity": card["sparsity"], "card_s": card["wall"],
                     "cpu_s": cpu["wall"]}
        del runs, card, cpu
    torch.cuda.empty_cache()
    return out


def recurrent_phase(dev, smi):
    """Phase 12: (a)-(e) of the module docstring, from freed memory, each
    model freed before the next; the launch counts of every kernel over the
    phase (all 0)."""
    import torch

    from repro_torch.kernels import _build

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    _build.reset_launches()
    t0 = time.perf_counter()
    rec = {}
    rec["zamba_serve"], res = rec_serve(dev, smi, "zamba2-7b")
    rec["zamba_ssd"] = zamba_ssd(dev, smi, res)
    del res
    rec["zamba_train"] = rec_train(dev, smi, "zamba2-7b")
    rec["xlstm_serve"], res = rec_serve(dev, smi, "xlstm-1.3b")
    rec["xlstm_layers"] = xlstm_layers(dev, smi, res)
    del res
    rec["xlstm_train"] = rec_train(dev, smi, "xlstm-1.3b")
    rec["smoke_train"] = rec_smoke_trains(smi, ROOT / "build" /
                                          "chip_smoke_recurrent")
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    if len(launches) != 15:
        raise SmokeFailure(f"recurrent: {len(launches)} kernels registered, "
                           "not the 15 whose launches the phase counts")
    rec.update(launches=launches, phase_seconds=time.perf_counter() - t0,
               base_bytes=base)
    print(f"recurrent: phase 12 in {rec['phase_seconds']:.1f} s "
          f"({base / 2**30:.2f} GiB allocated before); kernel launches "
          f"{launches}; {smi}")
    if any(launches.values()):
        raise SmokeFailure(f"recurrent: phase 12 launched kernels {launches}; "
                           "its paths run none")
    return rec


# whisper-large-v3 (phase 13): the encoder-decoder at full width, seeded
# float32 (1.58 B parameters, 6.3 GB). Its three attentions have heads of
# 1280 / 20 = 64: the encoder's non-causal self-attention over 1500 frames
# (11 x 128 + 92: a ragged last block of keys and of queries), the
# decoder's causal self-attention over its 448-token context, and its
# non-causal cross-attention, 448 queries against 1500 keys
WHISPER_ARCH = "whisper-large-v3"
WHISPER_FLASH = (  # (site, q, k/v, causal) at the train step's micro-batch 4
    ("encoder", (4, 20, 1500, 64), (4, 20, 1500, 64), False),
    ("cross", (4, 20, 448, 64), (4, 20, 1500, 64), False),
    ("decoder", (4, 20, 448, 64), (4, 20, 448, 64), True),
)
WHISPER_SERVE_ARGV = ["--arch", WHISPER_ARCH, "--batch", "8", "--prompt-len",
                      "128", "--new", "64"]
WHISPER_DECODE_TIMED = 8      # decode steps timed after the held prompt
WHISPER_HELD_LAYERS = 4       # (c): 4 encoder and 4 decoder layers
WHISPER_TRAIN_ARGV = ["--batch", "8", "--microbatch", "4", "--seq", "448",
                      "--steps", "3"]
WHISPER_SMOKE_RADIUS = {WHISPER_ARCH: 2.0}


def sdpa_call(qq, kk, vv, causal, window):
    """One scaled_dot_product_attention call on the leaves (``enable_gqa``):
    ``is_causal`` where no window bites (Sq = Sk when causal), else the
    boolean mask of the kernels' rule, queries right-aligned to the keys."""
    import torch

    sq, sk = qq.shape[2], kk.shape[2]
    if window is None or window >= sk:
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            qq, kk, vv, is_causal=causal, enable_gqa=True)
    qpos = torch.arange(sq, device=qq.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=qq.device)[None, :]
    mask = kpos > qpos - window
    if causal:
        mask &= kpos <= qpos
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask, enable_gqa=True)


def flash_sites(randn, smi, sites, tag):
    """The forward, dQ and dK/dV kernels at each of ``sites`` ((site, q, k/v,
    causal, window)) in bf16 and float32, held against their plain
    versions with phase 1's bars (``hold_attention``), then timed (CUDA
    events, median of 20; the plain versions median of 5) beside their
    bounds and one scaled_dot_product_attention call (``sdpa_call``; held
    to the float32 bars first, its bf16 distance read: ``hold_sdpa``; its
    backward is forward+backward minus forward). The bounds count the work
    at the true head dim, causal as half of the non-causal 4·B·H·Sq·Sk·D
    forward (6 and 8 of it for dQ and dK/dV), bf16 at the bf16 rate,
    float32 at the TF32 rate. Returns {kernel: {site: its numbers}}, bf16
    under BF16_FLASH's names and float32 under F32_FLASH's."""
    import torch

    from repro_torch.kernels import flash_attention as flash
    from repro_torch.roofline import costs as C

    out = {n: {} for n in BF16_FLASH + F32_FLASH}
    for site, qs, ks, causal, window in sites:
        for dt, names in ((torch.bfloat16, BF16_FLASH),
                          (torch.float32, F32_FLASH)):
            where = f"{tag} {site}"
            errs, (q, k, v, do, o, lse, delta) = hold_attention(
                randn, where, qs, ks, causal, window, dt)
            qq, kk, vv = (x.detach().clone().requires_grad_(True)
                          for x in (q, k, v))
            sdpa = sdpa_call(qq, kk, vv, causal, window)
            lib_err = hold_sdpa(f"{where} {str(dt)[6:]}", sdpa, (qq, kk, vv), q,
                                k, v, o, lse, do, causal=causal, window=window)
            opt = {"causal": causal, "window": window}
            t = {"flash_fwd": event_ms(lambda: flash.flash_attention(
                     q, k, v, **opt)),
                 "flash_bwd_dq": event_ms(lambda: flash.flash_bwd_dq(
                     q, k, v, do, lse, delta, **opt)),
                 "flash_bwd_dkv": event_ms(lambda: flash.flash_bwd_dkv(
                     q, k, v, do, lse, delta, **opt)),
                 "fwd_plain": event_ms(lambda: flash.flash_attention_plain(
                     q, k, v, **opt), reps=5),
                 "bwd_plain": event_ms(lambda: flash.flash_attention_bwd_plain(
                     q, k, v, o, lse, do, **opt), reps=5),
                 "sdpa_fwd": event_ms(sdpa),
                 "sdpa_fwd_bwd": event_ms(lambda: torch.autograd.grad(
                     sdpa(), (qq, kk, vv), do))}
            t["sdpa_bwd"] = t["sdpa_fwd_bwd"] - t["sdpa_fwd"]
            rate = BF16_OPS_PER_S if dt == torch.bfloat16 else TF32_OPS_PER_S
            spec_ = {  # bytes, operations (roofline/costs.py's table), plain,
                       # library, library's distance
                "flash_fwd": (*C.flash_fwd(q, k, causal, window), t["fwd_plain"],
                              t["sdpa_fwd"], lib_err["fwd"]),
                "flash_bwd_dq": (*C.flash_bwd_dq(q, k, causal, window),
                                 t["bwd_plain"], t["sdpa_bwd"], lib_err["bwd"]),
                "flash_bwd_dkv": (*C.flash_bwd_dkv(q, k, causal, window),
                                  t["bwd_plain"], t["sdpa_bwd"], lib_err["bwd"]),
            }
            for kern, name in zip(BF16_FLASH, names):
                nbytes, nops, plain_ms, lib_ms, lerr = spec_[kern]
                bms, by = bound_ms(nbytes, nops, rate)
                out[name][site] = {
                    "q": list(qs), "kv": list(ks), "causal": causal,
                    "window": window, "ms": t[kern], "plain_ms": plain_ms,
                    "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
                    "max_abs_err": errs[kern], "library_max_abs_err": lerr}
                print(f"time {tag} {site} {name} q{qs} kv{ks} causal={causal} "
                      f"window={window}: {t[kern]:.4f} ms (bound {bms:.4f} ms "
                      f"by {by}, {bms / t[kern]:.3f} of bound), plain "
                      f"{plain_ms:.4f} ms, scaled_dot_product_attention "
                      f"{lib_ms:.4f} ms, max_abs_err {errs[kern]:.3e}; {smi}")
            del q, k, v, do, o, lse, delta, qq, kk, vv, sdpa
    return out


def whisper_flash(randn, smi):
    """(a): ``flash_sites`` at WHISPER_FLASH's shapes (no window)."""
    return flash_sites(randn, smi, [w + (None,) for w in WHISPER_FLASH],
                       "whisper (a)")


COMMON_PART = 0.01   # keys (and values) k̄ + COMMON_PART · ε, k̄ ~ 2 · N(0, 1)
NAIVE_FACTOR = 2.0   # a flash gradient's bar: this times the naive attention's


def whisper_common_keys(smi):
    """(a): the flash Function's gradients where keys share most of their
    value (k = k̄ + 0.01·ε: the cross-attention over the encoder states of
    the zero audio the trainer feeds), against float64 autograd of softmax
    attention on the same values, beside the naive attention's
    (``layers.attention_naive``) in the same dtype. dQ sums dS (K − k̄)
    (``csrc/flash_bwd.cu``); against K itself it was rounding, not signal
    (4.5e+03 of its largest entry in bf16, 62× in float32). With random
    values, at the cross (non-causal) and decoder (causal) shapes, each
    gradient must lie within NAIVE_FACTOR × the naive attention's distance
    or 1e-5 of its largest entry, whichever is larger. With values that
    share most of their value too (v̄ + 0.01·ε, the zero audio's cross
    keys and values), at the cross shape, dq is held so; dk and dv are
    printed beside the naive attention's (delta = rowsum(dO ∘ O) from the
    bf16 O carries O's rounding of v̄ into dS: ROADMAP § 2(c))."""
    import torch

    from repro_torch.kernels import flash_attention as flash
    from repro_torch.models import layers as L

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def rel(got, want):
        return {n: float((g.double() - w).abs().max() / w.abs().max())
                for n, g, w in zip(("dq", "dk", "dv"), got, want)}

    out, fails = {}, []
    for regime, site in (("keys", 1), ("keys", 2), ("keys+values", 1)):
        name, qs, ks, causal = WHISPER_FLASH[site]
        q, do = rn(*qs), rn(*qs)
        k = 2 * rn(*ks[:2], 1, ks[3]) + COMMON_PART * rn(*ks)
        v = (2 * rn(*ks[:2], 1, ks[3]) + COMMON_PART * rn(*ks)
             if regime == "keys+values" else rn(*ks))
        for dt in (torch.float32, torch.bfloat16):
            xs = [x.to(dt) for x in (q, k, v)]
            dod = do.to(dt)
            ref = [x.double().requires_grad_(True) for x in xs]
            s = ref[0] @ ref[1].transpose(-1, -2) * qs[-1] ** -0.5
            if causal:
                s = s.masked_fill(torch.ones(
                    qs[2], ks[2], dtype=torch.bool, device="cuda").triu(
                        ks[2] - qs[2] + 1), float("-inf"))
            want = torch.autograd.grad(torch.softmax(s, -1) @ ref[2], ref,
                                       dod.double())
            del s, ref
            fl = [x.clone().requires_grad_(True) for x in xs]
            got = rel(torch.autograd.grad(flash.flash(*fl, causal=causal), fl,
                                          dod), want)
            nv = [x.clone().requires_grad_(True) for x in xs]
            naive = rel(torch.autograd.grad(L.attention_naive(
                *(x.transpose(1, 2) for x in nv), causal=causal
            ).transpose(1, 2), nv, dod), want)
            held = ("dq",) if regime == "keys+values" else ("dq", "dk", "dv")
            bars = {n: max(NAIVE_FACTOR * naive[n], 1e-5) for n in held}
            tag = f"{regime} {name} {str(dt)[6:]}"
            print(f"whisper (a) the flash Function's gradients on common "
                  f"{regime} (k̄ + {COMMON_PART}·ε) at q{qs} kv{ks} "
                  f"causal={causal} {str(dt)[6:]} vs float64: "
                  + ", ".join(f"{n} {e:.3e}" for n, e in got.items())
                  + " of the largest entry; the naive attention's "
                  + ", ".join(f"{n} {e:.3e}" for n, e in naive.items())
                  + "; held: " + ", ".join(
                      f"{n} bar {b:.3e} ({got[n] / b:.3f} of it)"
                      for n, b in bars.items()) + f"; {smi}")
            fails += [f"{tag} {n} {got[n]:.3e} (bar {b:.3e})"
                      for n, b in bars.items() if not got[n] <= b]
            out[tag] = {"flash": got, "naive": naive, "bars": bars}
            del xs, fl, nv, want
    if fails:
        raise SmokeFailure("whisper (a): flash gradients past their bars: "
                           + "; ".join(fails))
    return out


def whisper_bound_ms(params, cache, batch, valid):
    """One decode step's byte bound: the decoder's weights read once but
    the cross-attention's wk, wv and bv (they made the cross cache, which
    the step reads instead), the tied embedding whole as the unembedding,
    one row of the decoder's positions, the whole cross cache and the self
    cache's ``valid`` slots read once."""
    from repro_torch import _tree

    skip = ("dec_blocks/cross/wk", "dec_blocks/cross/wv", "dec_blocks/cross/bv",
            "pos_enc")
    nbytes = 0
    for name, p in _tree.leaves_with_paths(params):
        if name.startswith("enc_") or name in skip:
            continue
        rows = 1 if name == "pos_dec" else p.shape[0]
        nbytes += rows * p[0].numel() * p.element_size()
    cross = sum(cache[n].numel() * cache[n].element_size() for n in ("xk", "xv"))
    kv = sum(cache[n][:, :, :valid].numel() * cache[n].element_size()
             for n in ("k", "v"))
    return (nbytes + cross + kv) / HBM_BYTES_PER_S * 1e3, nbytes, cross, kv


def whisper_serve(dev, smi):
    """(b): the serve launcher at full width and depth (its zero cross
    cache, as the JAX launcher's); the prompt replayed through the decode
    step against that cache and against one filled from ``encode`` of the
    prefill's zero audio, each held against the teacher-forced forward
    (``make_prefill``): the filled one within SERVE_BAR · max|logits|, the
    zero one printed beside it; then the ms per decode step (host clock)
    beside its byte bound, the profiler's device kernels and busy ms per
    step, and the peak memory."""
    import torch

    from repro_torch import _tree, models
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import whisper
    from repro_torch.serving import lm

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = serve_cli.run(WHISPER_SERVE_ARGV)
    torch.cuda.synchronize()
    run_peak = torch.cuda.max_memory_allocated()
    a = serve_args(WHISPER_SERVE_ARGV)
    b, plen, new = int(a["--batch"]), int(a["--prompt-len"]), int(a["--new"])
    cfg, params, prompts = res["cfg"], res["params"], res["prompts"]
    n_params = sum(p.numel() for p in _tree.leaves(params))
    toks = res["tokens"]
    if not (toks.dtype == torch.int32 and int(toks.min()) >= 0
            and int(toks.max()) < cfg.vocab and toks.shape == (b, new)):
        raise SmokeFailure(f"whisper (b): tokens {toks.dtype} "
                           f"{tuple(toks.shape)} outside [0, {cfg.vocab})")
    print(f"whisper (b) python -m repro_torch.launch.serve "
          f"{' '.join(WHISPER_SERVE_ARGV)}: {cfg.n_enc_layers} encoder + "
          f"{cfg.n_layers} decoder layers d_model {cfg.d_model}, {n_params} "
          f"float32 params ({n_params * 4 / 1e9:.2f} GB); {res['seconds']:.3f} "
          f"s for {b} x {new} new tokens after {plen} prompt tokens "
          f"({res['tok_per_s']:.2f} tok/s, host clock, prompt replay included;"
          f" {res['seconds'] * 1e3 / (plen + new):.3f} ms a decode step over "
          f"the run's {plen + new}); peak device memory {run_peak / 2**30:.2f} "
          f"GiB; {smi}")
    zero_logits, cache, step = _decode_replay(cfg, params, prompts,
                                              plen + WHISPER_DECODE_TIMED + 2)
    want = lm.make_prefill(cfg, models.get(cfg))(params, prompts)
    scale = float(want.abs().max())
    zero_err = float((zero_logits - want).abs().max())
    cross = params["dec_blocks"]["cross"]
    with torch.inference_mode():
        # the prefill's audio: zero frames, through the encoder once
        enc = whisper.encode(params, torch.zeros(
            b, cfg.enc_frames, cfg.d_model, device=dev), cfg, remat=False)
        for i in range(cfg.n_layers):
            cache["xk"][i] = torch.einsum("bsd,dhk->bshk", enc, cross["wk"][i])
            cache["xv"][i] = torch.einsum("bsd,dhk->bshk", enc,
                                          cross["wv"][i]) + cross["bv"][i]
        del enc
        cache["k"].zero_()
        cache["v"].zero_()
        for i in range(plen):
            _, logits, cache = step(params, prompts[:, i], cache, i)
    err = float((logits - want).abs().max())
    print(f"whisper (b) decode vs the teacher-forced forward (make_prefill, "
          f"zero audio) at position {plen - 1}: cross cache filled from encode "
          f"max_abs_err {err:.3e} (bar {SERVE_BAR} x max|logits| {scale:.4g}); "
          f"the launcher's zero cross cache (the JAX package's serving) "
          f"{zero_err:.3e}; {smi}")
    if not (bool(torch.isfinite(logits).all()) and err <= SERVE_BAR * scale):
        raise SmokeFailure(f"whisper (b): decode logits {err:.3e} from the "
                           f"forward's (bar {SERVE_BAR * scale:.3e})")
    del want, zero_logits
    step_ms, per_kernel, n_launch, pos = time_decode(
        step, params, logits.argmax(-1).to(torch.int32), cache, plen,
        WHISPER_DECODE_TIMED)
    busy = sum(per_kernel.values())
    top = sorted(per_kernel, key=lambda k: -per_kernel[k])[:6]
    print("whisper (b) a decode step's largest device kernels: " + "; ".join(
        f"{per_kernel[k]:.3f} ms {k[:70]}" for k in top))
    bms, wbytes, xbytes, kvbytes = whisper_bound_ms(params, cache, b, pos + 1)
    peak = torch.cuda.max_memory_allocated()
    bound_by = "host" if busy < 0.5 * step_ms else "device"
    print(f"whisper (b) decode step at position {pos} (batch {b}): "
          f"{step_ms:.3f} ms (host clock, mean of {WHISPER_DECODE_TIMED}), "
          f"{b / step_ms * 1e3:.2f} tok/s; byte bound {bms:.3f} ms ({wbytes} "
          f"bytes of decoder weights and unembedding + {xbytes} of cross cache "
          f"+ {kvbytes} of self cache, over {HBM_BYTES_PER_S / 1e12:.2f} TB/s);"
          f" {n_launch} device kernels and copies a step "
          f"({n_launch / cfg.n_layers:.1f} a layer), device busy {busy:.3f} ms:"
          f" {bound_by}-bound; peak device memory {peak / 2**30:.2f} GiB; {smi}")
    rec = {"argv": WHISPER_SERVE_ARGV, "params": n_params,
           "seconds": res["seconds"], "tok_per_s": res["tok_per_s"],
           "launcher_peak_bytes": run_peak, "peak_bytes": peak,
           "max_abs_err": err, "zero_cross_max_abs_err": zero_err,
           "scale": scale, "decode_step_ms": step_ms,
           "decode_tok_per_s": b / step_ms * 1e3, "bound_ms": bms,
           "weight_bytes": wbytes, "cross_cache_bytes": xbytes,
           "self_cache_bytes": kvbytes, "kernels_per_step": n_launch,
           "device_busy_ms": busy, "bound_by": bound_by,
           "top_kernels_ms": {k: per_kernel[k] for k in top}}
    del cache, step, logits, res, params
    return rec


def whisper_held_setup(dev, radius):
    """(c)'s configuration, batch and initial parameters, as
    ``held_step_setup`` returns granite's: whisper-large-v3 at full width
    cut to WHISPER_HELD_LAYERS encoder and decoder layers, float32
    compute, the constraint on both stacks' ``w_up`` (REC_PATTERN, the
    launcher's), the first batch of WHISPER_TRAIN_ARGV's pipeline."""
    import torch

    from repro_torch import models
    from repro_torch.configs import registry
    from repro_torch.configs.types import ProjectionSpec, TrainConfig
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.models import lm
    from repro_torch.training import init_state

    cfg = lm.cut_depth(registry.get_arch(WHISPER_ARCH), WHISPER_HELD_LAYERS)
    a = serve_args(WHISPER_TRAIN_ARGV)
    batch, micro, seq = (int(a[k]) for k in ("--batch", "--microbatch", "--seq"))
    spec = ProjectionSpec(pattern=REC_PATTERN, radius=radius)
    tcfg = TrainConfig(microbatch=micro, total_steps=int(a["--steps"]),
                       warmup=1, remat=True, master_dtype="",
                       compute_dtype="float32", projection=spec)
    api = models.get(cfg)
    pipe = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq + 1,
                                   global_batch=batch, microbatch=micro))
    toks = {"tokens": torch.from_numpy(pipe.batch(0)).to(dev)}
    base = init_state(cfg, tcfg, api, SEED, device=dev)["params"]
    return cfg, tcfg, api, spec, toks, base


def whisper_train(dev, smi):
    """(d): the train launcher at full width and depth, the main path of
    the phase: the launches counted from 0 around it, 2 bf16 forwards (remat)
    and one dQ and one dK/dV per attention site (32 encoder + 2 x 32
    decoder) and micro-batch, no float32 kernel and no other kernel."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels import _build

    cfg = registry.get_arch(WHISPER_ARCH)
    a = serve_args(WHISPER_TRAIN_ARGV)
    runs = int(a["--steps"]) * int(a["--batch"]) // int(a["--microbatch"])
    sites = cfg.n_enc_layers + 2 * cfg.n_layers
    _build.reset_launches()
    rec = rec_train(dev, smi, WHISPER_ARCH, WHISPER_TRAIN_ARGV,
                    tag="whisper (d)")
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    want = dict.fromkeys(counts, 0) | {
        "flash_fwd": 2 * sites * runs, "flash_bwd_dq": sites * runs,
        "flash_bwd_dkv": sites * runs}
    print(f"whisper (d) launches over {runs} micro-batches of {sites} attention "
          f"sites: {counts}")
    if counts != want:
        raise SmokeFailure(f"whisper (d): launches {counts}, not {want}")
    rec["launches"] = counts
    return rec


def whisper_phase(dev, smi, randn):
    """Phase 13: (a)-(e) of the module docstring, from freed memory; (d)'s
    launch counts (the main path's) and (c)'s (the float32 kernels')."""
    import torch

    from repro_torch import models
    from repro_torch.configs import registry
    from repro_torch.models import lm

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rec = {"flash": whisper_flash(randn, smi),
           "common_keys": whisper_common_keys(smi)}
    rec["serve"] = whisper_serve(dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = lm.cut_depth(registry.get_arch(WHISPER_ARCH), WHISPER_HELD_LAYERS)
    radius, init_norm = rec_radius(dev, cfg)
    errs, counts, step_ms = hold_train_step(
        dev, radius, setup=whisper_held_setup,
        sites=cfg.n_enc_layers + 2 * cfg.n_layers, tag="whisper (c) held step")
    rec["held"] = {"radius": radius, "init_norm": init_norm, "errs": errs,
                   "launches": counts, "step_ms": step_ms,
                   "params": models.params.count_params(
                       models.get(cfg).template(cfg))}
    rec["train"] = whisper_train(dev, smi)
    rec["smoke_train"] = rec_smoke_trains(
        smi, ROOT / "build" / "chip_smoke_whisper", WHISPER_SMOKE_RADIUS,
        tag="whisper (e)")
    torch.cuda.synchronize()
    rec.update(phase_seconds=time.perf_counter() - t0, base_bytes=base)
    print(f"whisper: phase 13 in {rec['phase_seconds']:.1f} s "
          f"({base / 2**30:.2f} GiB allocated before); (d)'s launches "
          f"{rec['train']['launches']}; (c)'s {counts}; {smi}")
    return rec


def whisper_rows(rec):
    """``--only whisper``'s kernel rows: each flash kernel at the encoder's
    shape (its other shapes under ``"whisper"``), with (d)'s launches for
    the bf16 kernels and (c)'s for the float32 ones."""
    rows = []
    for name in BF16_FLASH + F32_FLASH:
        enc = rec["flash"][name]["encoder"]
        rows.append({
            "name": name, "workload": f"whisper encoder q{tuple(enc['q'])} "
            f"kv{tuple(enc['kv'])} non-causal", "route": "cuda",
            "source": "src/repro_torch/csrc/" + (
                "flash_fwd.cu" if name.startswith("flash_fwd") else "flash_bwd.cu"),
            "replaces": REPLACES[name, False],
            "launches": (rec["train"]["launches"] if name in BF16_FLASH
                         else rec["held"]["launches"])[name],
            **{k: enc[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")},
            "whisper": rec["flash"][name]})
    return rows


# phase 14: the dry run, the cost model and the tile search
LAUNCH_LAYERS = 8             # (b): granite-3-2b at full width, 8 layers
LAUNCH_MEM_BAND = (0.5, 2.0)  # (b): meta estimate / max_memory_allocated
# (d): the variants in two processes of about equal walking time (an xLSTM
# cell takes 11–13 s a walk on an H100 host's CPU)
LAUNCH_HILLCLIMB_GROUPS = (
    ("stablelm_probsbf16", "stablelm_chunk2048", "stablelm_probsbf16_c2048",
     "stablelm_mb64", "stablelm_proj_all", "stablelm_gsp_all", "sae_factory",
     "sae_factory_heads8"),
    ("xlstm_chunk128", "xlstm_chunk256", "xlstm_chunk512",
     "xlstm_chunk128_mb64", "xlstm_shard_r", "xlstm_shard_r_chunk128"))
LAUNCH_HILLCLIMB = sum(LAUNCH_HILLCLIMB_GROUPS, ())
# (d): each hillclimb variant's baseline: the dry run's cell of its arch,
# the SAE factory's variants against the first of them
LAUNCH_BASELINES = (("stablelm", "stablelm-1.6b"), ("xlstm", "xlstm-1.3b"),
                    ("sae_factory_", None))
# (c): the one error a dry-run cell may end in: the MoE archs' train cells,
# whose tuning keeps AdamW's moments in int8 (JAX's) while their 'embed'
# axis splits the blocks of 256 over the ranks (optim/adamw.py:
# check_int8_mesh, raised when the step is built); every other cell of
# theirs walks the sharded MoE/MLA forward
LAUNCH_REFUSAL = "int8 moments quantize each rank's shard"
LAUNCH_REFUSED = {("deepseek-v3-671b", "train_4k"), ("kimi-k2-1t-a32b", "train_4k")}
# (c): the archs in three groups of about equal walking time, one process
# a group and mesh (every assigned arch once). A mesh's walks on an H100
# host's CPU: qwen3-32b 48 s, zamba2-7b 45, chameleon-34b
# 40, whisper-large-v3 28, granite-3-2b 25, xlstm-1.3b and h2o-danube-1.8b
# 18, stablelm-1.6b 13; the MoE pair's prefill and decode about 16
# (deepseek-v3) and 18 (kimi-k2) on a CPU core of this port's test host
LAUNCH_ARCH_GROUPS = (
    ("qwen3-32b", "whisper-large-v3", "kimi-k2-1t-a32b"),
    ("zamba2-7b", "granite-3-2b", "deepseek-v3-671b"),
    ("chameleon-34b", "h2o-danube-1.8b", "xlstm-1.3b", "stablelm-1.6b"))


def launch_search(randn):
    """Phase 14 (a): the tile search at W1 and W2, each candidate held and
    timed, then ``make_plan(method="auto")`` through the tuned plan."""
    import torch

    from repro_torch.core import plan as planmod, schedule
    from repro_torch.kernels import _build, codegen, l1ball
    from repro_torch.kernels.codegen import lowering

    out = {}
    for wl, (shape, levels) in FULL.items():
        codegen.clear_tile_cache()
        _build.reset_launches()
        mark = tile_search_mark()
        t0 = time.perf_counter()
        winner = codegen.autotune_tiles(shape, levels, torch.float32,
                                        device="cuda")
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t0
        search = check_search(f"tile search {wl}", mark)
        if search != {k: n for k, n in _build.launch_counts().items() if n}:
            raise SmokeFailure(f"tile search {wl}: launches outside the search")
        log = codegen.tile_search_log()[codegen._tile_key(
            shape, levels, torch.float32, "cuda")]
        if log["plans"][log["winner"]] != winner:
            raise SmokeFailure(f"tile search {wl}: the cached plan is not the winner")
        _build.reset_launches()
        if codegen.autotune_tiles(shape, levels, torch.float32,
                                  device="cuda") is not winner \
                or any(_build.launch_counts().values()):
            raise SmokeFailure(f"tile search {wl}: the second ask searched again")
        sched = schedule.compile_schedule(shape, levels)
        norms = [q for q, _ in sched.levels]
        y = randn(shape)
        yc = y.reshape((1,) + winner.canon_shape)
        aggs_p, vfin_p = lowering.reduce_plain(yc, norms[:-1])
        radius = 0.25 * float(vfin_p.sum())
        radii = torch.full((1,), radius, device=y.device)
        u_p = l1ball.project_l1_plain(vfin_p, radii)
        x_p = lowering.apply_plain(yc, aggs_p, vfin_p, u_p, norms[:-1])
        r_dev = torch.tensor(radius, device=y.device)
        cands = []
        for i, tp in enumerate(log["plans"]):
            aggs, vfin = lowering.codegen_reduce(yc, tp, norms[:-1])
            x = lowering.codegen_apply(yc, aggs_p, vfin_p, u_p, tp, norms[:-1])
            torch.cuda.synchronize()
            tag = f"tile search {wl} plan {i}"
            e_r = check_close(f"{tag} reduce vfin", vfin, vfin_p, fmax(vfin_p))
            for t, (a, ap) in enumerate(zip(aggs, aggs_p)):
                e_r = max(e_r, check_close(f"{tag} reduce v{t + 1}", a, ap, fmax(ap)))
            e_a = check_close(f"{tag} apply", x, x_p, fmax(yc))
            fn = codegen.build(shape, levels, torch.float32, method="bisect",
                               device="cuda", tile_plan=tp)
            check_close(f"{tag} pipeline", fn(y, r_dev), x_p.reshape(shape),
                        fmax(yc))
            ms20 = graph_ms(lambda: fn(y, r_dev), calls=20)
            geo = {k: getattr(tp, k) for k in ("packs", "splits", "rows", "chunk")}
            cands.append({"plan": geo, "search_ms": log["ms"][i],
                          "search_spread_ms": log["spread"][i],
                          "graph20_ms": ms20, "reduce_err": e_r, "apply_err": e_a,
                          "winner": i == log["winner"]})
            print(f"tile search {wl} {shape} plan {i} {geo}: search {log['ms'][i]:.4f} "
                  f"ms a call (spread {log['spread'][i]:.4f}), 20-call replay "
                  f"{ms20:.4f} ms a call; reduce max_abs_err {e_r:.3e}, apply "
                  f"{e_a:.3e}{' <- verdict' if i == log['winner'] else ''}"
                  f"{' <- fastest' if i == log['fastest'] else ''}")
        # method="auto" from cleared caches: its codegen build runs the
        # search; again from a cleared plan cache: the cached verdict
        planmod.clear_cache()
        codegen.clear_tile_cache()
        _build.reset_launches()
        mark = tile_search_mark()
        plan = planmod.make_plan(shape, torch.float32, levels, method="auto",
                                 device="cuda")
        torch.cuda.synchronize()
        auto_search = check_search(f"{wl} make_plan(method='auto')", mark)
        for k in ("codegen_reduce", "codegen_apply"):
            if not auto_search.get(k):
                raise SmokeFailure(f"{wl}: make_plan(method='auto') ran no tile "
                                   f"search through {k}: {auto_search}")
        planmod.clear_cache()
        _build.reset_launches()
        planmod.make_plan(shape, torch.float32, levels, method="auto",
                          device="cuda")
        torch.cuda.synchronize()
        if any(_build.search_counts().values()):
            raise SmokeFailure(f"{wl}: make_plan(method='auto') searched again "
                               f"{_build.search_counts()}")
        _build.reset_launches()
        x = plan(y, radius)
        torch.cuda.synchronize()
        call = {k: n for k, n in _build.launch_counts().items() if n}
        if plan.method == "codegen" and call != {"codegen_reduce": 1,
                                                 "l1ball": 1, "codegen_apply": 1}:
            raise SmokeFailure(f"{wl}: the auto plan (codegen) launched {call}")
        check_close(f"{wl} auto plan", x, x_p.reshape(shape), fmax(yc))
        w = log["winner"]
        out[wl] = {"shape": list(shape), "seconds": search_s,
                   "search_launches": search, "candidates": cands,
                   "verdict": w, "fastest": log["fastest"],
                   "verdict_graph20_ms": cands[w]["graph20_ms"],
                   "heuristic_graph20_ms": cands[0]["graph20_ms"],
                   "auto": {"method": plan.method, "search_launches": auto_search,
                            "call_launches": call}}
        print(f"tile search {wl}: {len(cands)} plans in {search_s:.2f} s, launches "
              f"{search}; fastest {log['fastest']}, verdict {w} (the heuristic "
              f"unless beaten by more than the spread); 20-call replay of the "
              f"verdict {cands[w]['graph20_ms']:.4f} ms a call, of the heuristic "
              f"{cands[0]['graph20_ms']:.4f}; make_plan(auto) -> {plan.method}, "
              f"its search {auto_search}, one call {call}")
    return out


def launch_cost_model(dev, smi):
    """Phase 14 (b): the walk of one warm step on the card against the walk
    of the same step on meta, the step's time against its roofline bound,
    and the meta memory estimate against max_memory_allocated."""
    import numpy as np
    import torch

    from repro_torch import _tree, models
    from repro_torch.configs import registry
    from repro_torch.configs.types import ProjectionSpec, TrainConfig
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.launch import specs as SP
    from repro_torch.roofline import analysis as RF, costs as C
    from repro_torch.training import init_state, make_train_step

    cfg = dataclasses.replace(registry.get_arch(TRAIN_ARCH), n_layers=LAUNCH_LAYERS)
    steps, batch, micro, seq = train_args()
    tcfg = TrainConfig(microbatch=micro, total_steps=10, warmup=1, remat=True,
                       projection=ProjectionSpec(pattern=r"(w_up|w_gate)",
                                                 radius=5.0))
    api = models.get(cfg)
    pipe = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq + 1,
                                   global_batch=batch, microbatch=micro))
    toks = {"tokens": torch.from_numpy(pipe.batch(0)).to(dev)}
    gc.collect()
    torch.cuda.empty_cache()
    state = init_state(cfg, tcfg, api, SEED, device=dev)
    step = make_train_step(cfg, tcfg, api, impl="flash")
    step(state, toks)                       # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    with C.walk(device="cuda") as wc:
        step(state, toks)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    mstate = SP.abstract_train_state(cfg, tcfg, api)
    mtoks = {"tokens": torch.empty(toks["tokens"].shape,
                                   dtype=toks["tokens"].dtype, device="meta")}
    with C.walk(device="meta") as wm:
        make_train_step(cfg, tcfg, api, impl="flash")(mstate, mtoks)
    cuda, meta = wc.costs, wm.costs
    kern = {k: dict(v) for k, v in meta.kernels.items()}
    if (cuda.flops, cuda.bytes) != (meta.flops, meta.bytes) or kern != {
            k: dict(v) for k, v in cuda.kernels.items()}:
        raise SmokeFailure(f"cost walk: the card's step {cuda.flops:.6e} FLOPs "
                           f"{cuda.bytes:.6e} bytes {dict(cuda.kernels)}, meta "
                           f"{meta.flops:.6e} / {meta.bytes:.6e} {kern}")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if not kern.get(name, {}).get("calls"):
            raise SmokeFailure(f"cost walk: no declared {name} in {kern}")
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, toks)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    step_ms = statistics.median(times)
    roof = RF.analyze(meta, 1)
    bound = roof.bound_s() * 1e3
    ratio = step_ms / bound
    args = sum(t.numel() * t.element_size() for t in _tree.leaves(mstate)) \
        + mtoks["tokens"].numel() * mtoks["tokens"].element_size()
    est = args + meta.peak_bytes
    mem_ratio = est / peak
    print(f"cost model {TRAIN_ARCH} x{LAUNCH_LAYERS} layers, batch {batch} x {seq} "
          f"(micro {micro}), flash, bf16: {meta.flops:.6e} FLOPs, {meta.bytes:.6e} "
          f"bytes (card walk = meta walk), kernels {kern}; step {step_ms:.3f} ms "
          f"(median of {times}) vs the bound {bound:.3f} ms ({roof.bottleneck}: "
          f"compute {roof.t_compute * 1e3:.3f} ms, memory {roof.t_memory * 1e3:.3f} "
          f"ms): {ratio:.3f}x the bound; memory: meta {args} arguments + "
          f"{meta.peak_bytes} peak = {est} bytes vs max_memory_allocated {peak} "
          f"({before} before the step): {mem_ratio:.3f}; {smi}")
    if step_ms < bound:
        raise SmokeFailure(f"cost model: the step took {step_ms:.3f} ms, under "
                           f"its bound {bound:.3f} ms: the count is wrong")
    lo, hi = LAUNCH_MEM_BAND
    if not lo <= mem_ratio <= hi:
        raise SmokeFailure(f"cost model: memory estimate {est} vs {peak} "
                           f"({mem_ratio:.3f}, outside {LAUNCH_MEM_BAND})")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": LAUNCH_LAYERS, "flops": meta.flops, "bytes": meta.bytes,
            "card_flops": cuda.flops, "card_bytes": cuda.bytes, "kernels": kern,
            "step_ms": times, "step_ms_median": step_ms, "bound_ms": bound,
            "bound_by": roof.bottleneck, "t_compute_ms": roof.t_compute * 1e3,
            "t_memory_ms": roof.t_memory * 1e3, "ratio": ratio,
            "argument_bytes": args, "peak_bytes": meta.peak_bytes,
            "card_peak_bytes": cuda.peak_bytes, "max_memory_allocated": peak,
            "memory_ratio": mem_ratio, "card": smi}


def launch_background(workdir, nice=False):
    """Phase 14 (c) and (d) in the background, with no card visible: the
    dry run on each mesh and the hillclimb. Returns the processes, which
    ``stop_background`` ends if they outlive the script's run. ``nice``:
    at the lowest CPU priority, beside the other phases' host work."""
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    # the children see the checkout's src and no card (env(1) sets both)
    env = ["env", f"PYTHONPATH={ROOT / 'src'}", "CUDA_VISIBLE_DEVICES="]
    if nice:
        env = ["nice", "-n", "19"] + env
    procs = {}
    for mesh in ("single", "multi"):
        for i, group in enumerate(LAUNCH_ARCH_GROUPS):
            name = f"dryrun_{mesh}_{i}"
            procs[name] = subprocess.Popen(
                env + [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", ",".join(group), "--shape", "all", "--mesh",
                       mesh, "--out", str(workdir / "dryrun")],
                stdout=open(workdir / f"{name}.log", "w"),
                stderr=subprocess.STDOUT, cwd=ROOT)
    for i, group in enumerate(LAUNCH_HILLCLIMB_GROUPS):
        name = f"hillclimb_{i}"
        procs[name] = subprocess.Popen(
            env + [sys.executable, "-m", "repro_torch.launch.hillclimb",
                   "--cell", ",".join(group), "--out",
                   str(workdir / "hillclimb")],
            stdout=open(workdir / f"{name}.log", "w"),
            stderr=subprocess.STDOUT, cwd=ROOT)
    atexit.register(stop_background, procs)
    return procs


def stop_background(procs):
    """End the background runs that are still going."""
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def launch_sweep(workdir, procs, t0):
    """Phase 14 (c) and (d): wait for the background runs, check and print
    their results."""
    from repro_torch.roofline import fill_experiments, report

    rcs = {k: p.wait(timeout=900) for k, p in procs.items()}
    wall = time.perf_counter() - t0
    for name in procs:
        text = (workdir / f"{name}.log").read_text()
        print(f"phase 14 {name} (exit {rcs[name]}):\n" + text.strip())
    recs = report.load(str(workdir / "dryrun"))
    counts, bad = {}, []
    for r in recs:
        key = (r["mesh"], r["status"])
        counts[key] = counts.get(key, 0) + 1
        refused = (r["arch"], r["shape"]) in LAUNCH_REFUSED
        if r["status"] == "error" and not (refused
                                           and LAUNCH_REFUSAL in r["error"]):
            bad.append((r["arch"], r["shape"], r["mesh"], r["error"]))
        if refused and r["status"] != "error":
            bad.append((r["arch"], r["shape"], r["mesh"], "not refused"))
    if len(recs) != 80:
        bad.append(("records", len(recs)))
    print("dry run: " + ", ".join(f"{m} {st} {n}" for (m, st), n in sorted(counts.items()))
          + f" ({wall:.1f} s wall from their start, eight processes in "
          "parallel: each mesh's three groups of the archs and the "
          "hillclimb's two)")
    report.main([str(workdir / "dryrun")])
    if bad:
        raise SmokeFailure(f"dry run: errors beyond the int8 refusals: {bad}")
    hc = {}
    for f in sorted((workdir / "hillclimb").glob("*.json")):
        v = json.loads(f.read_text())
        hc[v["variant"]] = v
    failed = [k for k in LAUNCH_HILLCLIMB if hc.get(k, {}).get("status") != "ok"]
    if any(rc for k, rc in rcs.items() if k.startswith("hillclimb")) or failed:
        raise SmokeFailure(f"hillclimb: failed variants {failed}")
    deltas = {}
    for prefix, arch in LAUNCH_BASELINES:
        b = hc["sae_factory"] if arch is None else next(
            r for r in recs if (r["arch"], r["shape"], r["mesh"])
            == (arch, "train_4k", "single"))
        variants = [hc[k] for k in sorted(hc) if k.startswith(prefix)]
        name = b.get("variant", f"the dry run's {arch} x train_4k x single")
        print(f"hillclimb against {name}:")
        print(fill_experiments.perf_table(b, variants))
        dom = b["roofline"]["bottleneck"]
        for v in variants:
            deltas[v["variant"]] = {
                "dominant": dom,
                "delta": (v["roofline"][f"t_{dom}"] - b["roofline"][f"t_{dom}"])
                / b["roofline"][f"t_{dom}"]}
    return {"counts": {f"{m} {st}": n for (m, st), n in counts.items()},
            "records": len(recs), "wall_s": wall, "hillclimb": deltas,
            "rcs": rcs}


def launch_phase(dev, smi, randn, background=None):
    """Phase 14: (c) and (d) start in the background (or were started
    earlier: ``background`` is ``(procs, start time)``), then (a) and (b)
    on the card, then (c) and (d) are read."""
    import torch

    t0 = time.perf_counter()
    workdir = ROOT / "build" / "chip_smoke_launch"
    procs, t_bg = background or (launch_background(workdir), t0)
    try:
        rec = {"search": launch_search(randn)}
        torch.cuda.empty_cache()
        rec["cost_model"] = launch_cost_model(dev, smi)
        rec["sweep"] = launch_sweep(workdir, procs, t_bg)
    finally:
        stop_background(procs)
    shutil.rmtree(workdir, ignore_errors=True)
    rec["phase_seconds"] = time.perf_counter() - t0
    print(f"launch: phase 14 in {rec['phase_seconds']:.1f} s; {smi}")
    return rec


# phase 15: the flash kernels at every head width up to 128, danube and
# zamba on their flash paths, the long l1ball, the golden pipelines in bf16
WIDTHS = (8, 24, 48, 80, 96, 112)
# phase 1's ragged cases, run at each width: GQA, block-unaligned,
# non-causal, windows, Sq < Sk (cross, right-aligned, windowed), Sq > Sk
WIDTH_CASES = [FLASH_CASES[i] for i in (3, 4, 5, 6, 9, 10, 11, 12, 13)]
DANUBE_ARCH = "h2o-danube-1.8b"   # 32 q heads over 8 kv heads of 80, window 4096
ZAMBA_ARCH = "zamba2-7b"          # the shared attention's 32 heads of 112
WIDTH_SITES = (  # (site, q, k/v, causal, window)
    ("danube", (4, 32, 2048, 80), (4, 8, 2048, 80), True, 4096),
    ("danube_window", (1, 32, 6144, 80), (1, 8, 6144, 80), True, 4096),
    ("zamba", (4, 32, 2048, 112), (4, 32, 2048, 112), True, None),
)
DANUBE_TRAIN_ARGV = ["--batch", "8", "--microbatch", "4", "--seq", "2048",
                     "--steps", "3"]
ZAMBA_FLASH_LAYERS = 12           # (c): two super-blocks of attn_every = 6
ZAMBA_FLASH_TOKENS = (1, 2048)
ZAMBA_FLASH_BAR = 1e-4            # (c): of max|logits|, float32
LONG_L1 = (51201, 100352, 262144, 524288)   # (d): past the one-CTA limit
LONG_L1_ITEMS = 8
# (e)'s fifth workload: stablelm-1.6b's embedding, one column per token,
# the ℓ1 over its 100,352-token vocabulary; uniform(0, 1) from a numpy seed
W5 = ((2048, 100352), 5)
W5_RADIUS_FRACTION = 0.25         # of its ℓ1,∞ norm, as W1's and W2's radii
BF16_ULP = 2.0 ** -8              # a bf16 rounding to nearest, relative


def widths_flash(randn, smi):
    """(a): the six flash kernels at every width of WIDTHS on WIDTH_CASES
    in both types (phase 1's bars), then at WIDTH_SITES held and timed
    (``flash_sites``), and the ``FlashAttention`` Function's float32
    gradients at danube's shape against autograd of ``attention_naive``."""
    import torch

    case_errs = {}
    for d in WIDTHS:
        for dt in (torch.float32, torch.bfloat16):
            for i, (qs, ks, causal, window) in enumerate(WIDTH_CASES):
                errs, _ = hold_attention(randn, f"widths (a) d={d} case{i}",
                                         qs[:3] + (d,), ks[:3] + (d,), causal,
                                         window, dt)
                for k_, v_ in errs.items():
                    key = f"{k_} {str(dt)[6:]}"
                    case_errs[key] = max(case_errs.get(key, 0.0), v_)
    print(f"widths (a): the flash kernels at head dims {WIDTHS} on "
          f"{len(WIDTH_CASES)} ragged cases each, float32 and bf16, within "
          "phase 1's bars: " + ", ".join(f"{k_} max_abs_err {v_:.3e}"
                                        for k_, v_ in case_errs.items()))
    sites = flash_sites(randn, smi, WIDTH_SITES, "widths (a)")
    grads = hold_function_grads(randn, WIDTH_SITES[0][1:])
    return {"cases": case_errs, "sites": sites, "function_grads": grads}


def widths_danube(dev, smi, workdir):
    """(b): danube's train launcher at full width and depth through its
    default ``--attn flash`` (``rec_train``: finite losses, a feasible
    constraint), its bf16 flash launches held to their count (a forward
    and its remat recompute, one dQ and one dK/dV per layer and
    micro-batch), peak memory; then one harvest step of the SAE factory's
    launcher on danube at full width and depth."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels import _build
    from repro_torch.launch import sae_factory as factory_cli

    cfg = registry.get_arch(DANUBE_ARCH)
    a = serve_args(DANUBE_TRAIN_ARGV)
    _build.reset_launches()
    rec = rec_train(dev, smi, DANUBE_ARCH, DANUBE_TRAIN_ARGV, tag="widths (b)")
    counts = _build.launch_counts()
    per = cfg.n_layers * int(a["--steps"]) * (int(a["--batch"])
                                              // int(a["--microbatch"]))
    want = {"flash_fwd": 2 * per, "flash_bwd_dq": per, "flash_bwd_dkv": per}
    want |= dict.fromkeys(F32_FLASH, 0)
    got = {n: counts[n] for n in want}
    print(f"widths (b) {DANUBE_ARCH} train: flash launches {got} (want {want})"
          f", peak {rec['peak_bytes'] / 2**30:.2f} GiB; {smi}")
    if got != want:
        raise SmokeFailure(f"widths (b): flash launches {got}, not {want}")
    out = workdir / "factory"
    _build.reset_launches()
    t0 = time.perf_counter()
    rc = factory_cli.main(["--arch", DANUBE_ARCH, "--full", "--out", str(out),
                           "--layers", "12", "--harvest-steps", "1",
                           "--train-steps", "1", "--seeds", "0"])
    torch.cuda.synchronize()
    factory_s = time.perf_counter() - t0
    fcounts = {n: c for n, c in _build.launch_counts().items() if c}
    flash_n = sum(fcounts.get(n, 0) for n in BF16_FLASH + F32_FLASH)
    print(f"widths (b) {DANUBE_ARCH} sae_factory --full --layers 12 "
          f"--harvest-steps 1 --train-steps 1: rc {rc}, {factory_s:.1f} s, "
          f"launches {fcounts}; {smi}")
    if rc != 0 or flash_n == 0:
        raise SmokeFailure(f"widths (b): the factory returned {rc} with "
                           f"{flash_n} flash launches")
    shutil.rmtree(out, ignore_errors=True)
    rec.pop("sparsity")
    return dict(rec, launches=got, factory={"rc": rc, "seconds": factory_s,
                                            "launches": fcounts})


def widths_zamba(dev, smi):
    """(c): zamba2-7b at full width cut to ZAMBA_FLASH_LAYERS (two
    super-blocks), ``zamba.forward(impl="flash")`` (the float32 flash
    forward at its 112-wide heads, one launch per shared-attention
    application) held against ``impl="chunked"`` on the card."""
    import numpy as np
    import torch

    from repro_torch import models
    from repro_torch.configs import registry
    from repro_torch.kernels import _build
    from repro_torch.models import lm, params as PM, zamba

    cfg = lm.cut_depth(registry.get_arch(ZAMBA_ARCH), ZAMBA_FLASH_LAYERS)
    params = PM.init_params(models.get(cfg).template(cfg), SEED, device=dev)
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab, ZAMBA_FLASH_TOKENS), device=dev)
    sites = ZAMBA_FLASH_LAYERS // cfg.hybrid.attn_every
    with torch.no_grad():
        _build.reset_launches()
        got, _ = zamba.forward(params, toks, cfg, impl="flash", remat=False)
        torch.cuda.synchronize()
        counts = {n: c for n, c in _build.launch_counts().items() if c}
        want, _ = zamba.forward(params, toks, cfg, impl="chunked", remat=False)
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    print(f"widths (c) {ZAMBA_ARCH} {ZAMBA_FLASH_LAYERS} layers d_model "
          f"{cfg.d_model} heads {cfg.n_heads} x {cfg.resolved_head_dim}, "
          f"tokens {ZAMBA_FLASH_TOKENS}: forward(impl='flash') vs 'chunked' "
          f"logits max_abs_err {err:.3e} (bar {ZAMBA_FLASH_BAR} x max|logits| "
          f"{scale:.4g}); launches {counts}; {smi}")
    if not (bool(torch.isfinite(got).all()) and err <= ZAMBA_FLASH_BAR * scale
            and counts == {"flash_fwd_tf32": sites}):
        raise SmokeFailure(f"widths (c): logits {err:.3e} from chunked, "
                           f"launches {counts}, not {sites} flash_fwd_tf32")
    del params, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": ZAMBA_FLASH_LAYERS, "max_abs_err": err, "scale": scale,
            "launches": counts}


def widths_l1ball(randn, rand, smi):
    """(d): both bodies of ``l1ball_cluster`` at LONG_L1's lengths, float32
    and bf16, on L1_CASES' radii and non-finite values, as a bucket of
    LONG_L1_ITEMS and as one item with its radius by value, against
    ``project_l1_plain`` on the card (phase 1's bars; bf16 within one bf16
    rounding); then timed (bisect, the fraction radii) beside the plain
    version and the PyTorch-ops solve (``ref.project_l1_ref``, one item);
    and ``outer_l1_solve`` one past JAX's limit launches nothing."""
    import torch

    from repro_torch.kernels import _build, l1ball, ref
    from repro_torch.roofline import costs as C

    errs, times = {}, {}
    for n in LONG_L1:
        for dt in (torch.float32, torch.bfloat16):
            tag_t = str(dt)[6:]
            rtol = BF16_RTOL if dt == torch.bfloat16 else RTOL
            for case in L1_CASES:
                v, radii = l1ball_case(randn, rand, n, case, LONG_L1_ITEMS)
                v = v.to(dt)
                nonfinite = case in ("nan", "inf")
                for method in ("bisect", "filter"):
                    before = l1ball.CLUSTER_KERNEL.launches
                    got = l1ball.project_l1_batched(v, radii, method=method)
                    one = l1ball.project_l1(v[-1], float(radii[-1]),
                                            method=method)
                    torch.cuda.synchronize()
                    if l1ball.CLUSTER_KERNEL.launches != before + 2:
                        raise SmokeFailure(f"l1ball_cluster n={n}: "
                                           f"{l1ball.CLUSTER_KERNEL.launches - before}"
                                           " launches for two calls")
                    want = l1ball.project_l1_plain(v, radii, method)
                    tag = f"widths (d) l1ball_cluster {method} n={n} {tag_t} {case}"
                    err = max(check_close(tag, got, want, fmax(v), rtol=rtol,
                                          nonfinite=nonfinite),
                              check_close(f"{tag} one item", one, want[-1],
                                          fmax(v), rtol=rtol,
                                          nonfinite=nonfinite))
                    key = f"{method} {tag_t}"
                    errs[key] = max(errs.get(key, 0.0), err)
                    print(f"{tag}: max_abs_err {err:.3e}")
                if case != "fraction":
                    continue
                one_v, one_r = v[-1].contiguous(), float(radii[-1])
                one_t = torch.tensor([one_r], device=v.device)
                bucket = lambda: l1ball.project_l1_batched(v, radii)  # noqa: E731
                single = lambda: l1ball.project_l1(one_v, one_r)  # noqa: E731
                t = {"bucket_ms": event_ms(bucket), "one_ms": event_ms(single),
                     "plain_bucket_ms": event_ms(
                         lambda: l1ball.project_l1_plain(v, radii), reps=5),
                     "plain_one_ms": event_ms(
                         lambda: l1ball.project_l1_plain(one_v[None], one_t),
                         reps=5),
                     "ref_one_ms": event_ms(
                         lambda: ref.project_l1_ref(one_v, one_r), reps=5)}
                es = v.element_size()
                t["bound_bucket_ms"], t["bound_by"] = bound_ms(
                    *C.l1ball(LONG_L1_ITEMS, n, es))
                t["bound_one_ms"], _ = bound_ms(*C.l1ball(1, n, es))
                times[f"{n} {tag_t}"] = t
                print(f"time widths (d) l1ball_cluster n={n} {tag_t}: bucket of "
                      f"{LONG_L1_ITEMS} {t['bucket_ms']:.4f} ms (bound "
                      f"{t['bound_bucket_ms']:.6f} ms by {t['bound_by']}), plain "
                      f"{t['plain_bucket_ms']:.4f} ms; one item {t['one_ms']:.4f}"
                      f" ms (bound {t['bound_one_ms']:.6f}), plain "
                      f"{t['plain_one_ms']:.4f} ms, ref.project_l1_ref "
                      f"{t['ref_one_ms']:.4f} ms; {smi}")
                del v, radii, one_v, one_t
    n = l1ball.REF_ROUTE_ABOVE + 1
    v = randn((n,))
    r = 0.25 * float(v.abs().sum())
    _build.reset_launches()
    x = l1ball.outer_l1_solve(v, r)
    torch.cuda.synchronize()
    launched = {k: c for k, c in _build.launch_counts().items() if c}
    err = check_close(f"widths (d) outer_l1_solve n={n}", x,
                      l1ball.project_l1_plain(v[None], torch.tensor(
                          [r], device=v.device))[0], fmax(v))
    print(f"widths (d) outer_l1_solve at n={n}: the PyTorch-ops route, "
          f"launches {launched}, max_abs_err {err:.3e} from project_l1_plain")
    if launched:
        raise SmokeFailure(f"widths (d): outer_l1_solve at {n} launched {launched}")
    return {"errs": errs, "times": times, "past_limit_launches": launched}


def widths_golden(randn, smi):
    """(e): the golden Algorithm 2 and 5 pipelines on W1–W5 in float32 and
    bf16, each fused call in a counting window of its own (its three
    kernels once each: ``l1ball_cluster`` for W5's 100,352-value
    aggregate). Float32 is held to the generated pipeline (1e-6, the
    golden pin); bf16 to the plain bf16 chain on the card and to the
    float32 pipeline on the same values and the radius rounded to bf16,
    both within one bf16 rounding (2^-7 |b| + 1e-5 max|Y|). Feasible:
    float32 within phase 3's slack; bf16 within bf16(η)·(1 + 2^-8) (each
    column's radius rounded to bf16, half an ulp) + that slack. Each
    pipeline is timed (CUDA events, median of 20) in both types. Returns
    per workload its numbers, and the launches of every kernel over the
    fused calls."""
    import numpy as np
    import torch

    from repro_torch.core import multilevel
    from repro_torch.kernels import (_build, bilevel_l1inf as bi, codegen,
                                     l1ball, trilevel_l1infinf as tri)

    fused = {"bilevel": bi.bilevel_l1inf_fused,
             "trilevel": tri.trilevel_l1infinf_fused}
    levels = {"bilevel": BILEVEL, "trilevel": TRILEVEL}

    def plain_chain(design, y, eta):
        radii = torch.tensor([eta], device=y.device)
        if design == "bilevel":
            u = l1ball.project_l1_plain(bi.colmax_plain(y)[None], radii)[0]
            return bi.clip_plain(y, u)
        v2, v1 = tri.trilevel_reduce_plain(y)
        u1 = l1ball.project_l1_plain(v1[None], radii)[0]
        return tri.trilevel_apply_plain(y, v2, u1)

    wls = {}
    for wl, (shape, lv) in zip(("W1", "W2"), FULL.values()):
        y = randn(shape)
        wls[wl] = ("bilevel" if lv == BILEVEL else "trilevel", y,
                   (0.25 * float(multilevel.multilevel_norm(y, lv)),))
    for wl, design, (shape, seed, radii) in (("W3", "bilevel", FIG1),
                                              ("W4", "trilevel", FIG3)):
        y = np.random.default_rng(seed).uniform(0.0, 1.0, shape)
        wls[wl] = (design, torch.from_numpy(y.astype(np.float32)).cuda(), radii)
    shape, seed = W5
    y = torch.from_numpy(np.random.default_rng(seed).uniform(
        0.0, 1.0, shape).astype(np.float32)).cuda()
    wls["W5"] = ("bilevel", y, (W5_RADIUS_FRACTION * float(
        multilevel.multilevel_norm(y, BILEVEL)),))
    del y
    per_call = {"bilevel": ("colmax", "l1ball", "clip"),
                "trilevel": ("trilevel_reduce", "l1ball", "trilevel_apply")}
    total, out = {}, {}
    for wl, (design, y, radii) in wls.items():
        lv, fn = levels[design], fused[design]
        m, scale = y.shape[-1], float(y.abs().max())
        solve = "l1ball" if m <= l1ball.L1_ONE_CTA_MAX else "l1ball_cluster"
        want_calls = {k if k != "l1ball" else solve: 1 for k in per_call[design]}
        generated = codegen.build(y.shape, lv, torch.float32, method="bisect")
        yb = y.to(torch.bfloat16)
        recs = []
        for eta in radii:
            eta_b = float(torch.tensor(eta).to(torch.bfloat16))
            rec = {"eta": eta, "eta_bf16": eta_b}
            xs = {}
            for dt, yy in ((torch.float32, y), (torch.bfloat16, yb)):
                _build.reset_launches()
                x = fn(yy, eta)
                torch.cuda.synchronize()
                got = {k: c for k, c in _build.launch_counts().items() if c}
                if got != want_calls:
                    raise SmokeFailure(f"widths (e) {wl} {dt} η={eta}: launches "
                                       f"{got}, not {want_calls}")
                for k, c in got.items():
                    total[k] = total.get(k, 0) + c
                if x.dtype != dt:
                    raise SmokeFailure(f"widths (e) {wl}: {x.dtype} out of {dt}")
                xs[dt] = x
            pin = float((xs[torch.float32] - generated(y, eta)).abs().max())
            if not pin <= 1e-6:
                raise SmokeFailure(f"widths (e) {wl} η={eta}: golden vs "
                                   f"generated {pin:.3e}")
            xb = xs[torch.bfloat16]
            tag = f"widths (e) {wl} bf16 η={eta:.6g}"
            e_plain = check_close(f"{tag} vs the plain bf16 chain", xb,
                                  plain_chain(design, yb, eta), scale,
                                  rtol=BF16_RTOL)
            e_f32 = check_close(f"{tag} vs float32 on its values", xb,
                                fn(yb.float(), eta_b), scale, rtol=BF16_RTOL)
            slack = RTOL * eta + m * 2.0 ** -23 * scale
            nrm = float(multilevel.multilevel_norm(xs[torch.float32], lv))
            nrm_b = float(multilevel.multilevel_norm(xb.float(), lv))
            bar_b = eta_b * (1 + BF16_ULP) + slack
            if not (nrm <= eta + slack and nrm_b <= bar_b):
                raise SmokeFailure(f"widths (e) {wl} η={eta}: norms {nrm} (bar "
                                   f"{eta + slack}), bf16 {nrm_b} (bar {bar_b})")
            rec.update(pin=pin, bf16_vs_plain=e_plain, bf16_vs_f32=e_f32,
                       norm=nrm, norm_bf16=nrm_b, bar_bf16=bar_b)
            print(f"widths (e) golden {wl} {design} {tuple(y.shape)} η={eta:.6g}"
                  f": launches {want_calls} a call in each type; float32 vs "
                  f"generated {pin:.3e}, norm {nrm:.7g} (bar {eta + slack:.7g}); "
                  f"bf16 vs the plain bf16 chain {e_plain:.3e}, vs float32 on "
                  f"its values {e_f32:.3e}, norm {nrm_b:.7g} (bar {bar_b:.7g})")
            recs.append(rec)
            del xs, xb
        eta = radii[0]
        t = {"f32_ms": event_ms(lambda: fn(y, eta)),
             "bf16_ms": event_ms(lambda: fn(yb, eta)),
             "generated_ms": event_ms(lambda: generated(y, eta))}
        print(f"time widths (e) golden {wl} {tuple(y.shape)} η={eta:.6g}: "
              f"float32 {t['f32_ms']:.4f} ms, bf16 {t['bf16_ms']:.4f} ms, the "
              f"generated (float32) {t['generated_ms']:.4f} ms; {smi}")
        out[wl] = {"design": design, "shape": list(y.shape), "checks": recs, **t}
        del yb
    del wls
    torch.cuda.empty_cache()
    return {"workloads": out, "launches": total}


def widths_phase(dev, smi, randn, rand):
    """Phase 15 (see the module docstring): (a)–(e) in order, each from
    freed memory. Returns their records and the phase's seconds."""
    import torch

    t0 = time.perf_counter()
    workdir = ROOT / "build" / "chip_smoke_widths"
    workdir.mkdir(parents=True, exist_ok=True)
    rec = {}
    for key, run in (("flash", lambda: widths_flash(randn, smi)),
                     ("danube", lambda: widths_danube(dev, smi, workdir)),
                     ("zamba", lambda: widths_zamba(dev, smi)),
                     ("l1ball", lambda: widths_l1ball(randn, rand, smi)),
                     ("golden", lambda: widths_golden(randn, smi))):
        gc.collect()
        torch.cuda.empty_cache()
        rec[key] = run()
    shutil.rmtree(workdir, ignore_errors=True)
    rec["phase_seconds"] = time.perf_counter() - t0
    print(f"phase 15: {rec['phase_seconds']:.1f} s")
    return rec


def widths_rows(rec):
    """Phase 15's kernel rows: the six flash kernels at danube's shape
    (their other sites under ``"widths"``), with (b)'s launches for the
    bf16 kernels and the factory's for the float32 ones, and
    ``l1ball_cluster`` on W5's aggregate (one item, float32 bisect; its
    other lengths under ``"widths"``) with (e)'s launches."""
    rows = []
    for name in BF16_FLASH + F32_FLASH:
        site = rec["flash"]["sites"][name]["danube"]
        rows.append({
            "name": name, "workload": f"danube q{tuple(site['q'])} "
            f"kv{tuple(site['kv'])} causal window {site['window']}",
            "route": "cuda", "source": "src/repro_torch/csrc/" + (
                "flash_fwd.cu" if name.startswith("flash_fwd") else "flash_bwd.cu"),
            "replaces": REPLACES[name, False],
            "launches": (rec["danube"]["launches"][name] if name in BF16_FLASH
                         else rec["danube"]["factory"]["launches"].get(name, 0)),
            **{k: site[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
            "widths": rec["flash"]["sites"][name]})
    t = rec["l1ball"]["times"]["100352 float32"]
    rows.append({
        "name": "l1ball_cluster", "workload": "W5 aggregate 1x100352 f32",
        "route": "cuda", "source": "src/repro_torch/csrc/l1ball.cu",
        "replaces": REPLACES["l1ball", False],
        "launches": rec["golden"]["launches"].get("l1ball_cluster", 0),
        "max_abs_err": max(rec["l1ball"]["errs"].values()),
        "ms": t["one_ms"], "plain_ms": t["plain_one_ms"],
        "bound_ms": t["bound_one_ms"], "bound_by": t["bound_by"],
        "library_ms": None, "ref_ms": t["ref_one_ms"],
        "widths": rec["l1ball"]["times"]})
    return rows


# the audio, hybrid and recurrent families trained under a mesh (phase 16):
# each family's sharded forward at full width, cut in depth so that four
# ranks on one card hold it (whisper 2 + 2 layers; zamba2-7b 7 layers: a
# super-group of 5 Mamba layers and one shared-attention site, and one
# trailing Mamba layer; xlstm-1.3b 8 layers: 7 mLSTM and one sLSTM), 2
# sequences a step in one micro-batch (each micro-batch gathers every
# weight again: zamba2's (2, 2) f32 step moves 17 GB through gloo at two),
# the launcher's constraint on (w_up|w_gate|w_in) at REC_RADIUS_FRACTION of
# the init's smallest slice
MF_MOE = "deepseek-v3-671b"
MF_ARCHS = ("whisper-large-v3", "zamba2-7b", "xlstm-1.3b", MF_MOE)
# deepseek-v3: one leading dense MLA layer and one MoE layer
MF_LAYERS = {"whisper-large-v3": 2, "zamba2-7b": 7, "xlstm-1.3b": 8, MF_MOE: 2}
MF_SEQ = {"whisper-large-v3": 448,   # the decoder's context; 1500 frames
          "zamba2-7b": 1024,
          "xlstm-1.3b": 256,         # a short sequence for the sLSTM loop
          MF_MOE: 512}               # about 512 routed slots an expert a step
# deepseek-v3's cut: of the 256 routed experts, 16 (the four cards' share
# under 64-way expert parallelism, 4 a chip; 4 a rank on (1, 4), 8 on
# (2, 2)), one leading dense layer (its template keeps 3); every width, the
# MLA ranks, top-8, the shared expert and the vocabulary as published
MF_MOE_CUT = dict(n_experts=16, first_dense=1)
# MLA's q/k and v heads differ in width: no flash kernel takes them
MF_IMPL = {"whisper-large-v3": "flash", "zamba2-7b": "flash",
           "xlstm-1.3b": "flash", MF_MOE: "chunked"}
# (b): kimi-k2's smoke config under the launcher on 2x2, phase 11 (e)'s argv
MF_KIMI = "kimi-k2-1t-a32b"
MF_KIMI_ARGV = ["--arch", MF_KIMI, "--smoke", "--attn", "chunked", "--steps",
                "2", "--lr", repr(MOE_SMOKE_LR), "--seq", "32", "--batch", "8",
                "--microbatch", "4", "--radius", "0.5", "--mesh", "2x2"]
MF_BATCH, MF_MICRO = 2, 2
MF_SIZES = ((2, 2), (1, 4))          # (a): the held step's meshes
MF_RTOL = 1e-5                       # (a): loss and gradient norm, float32
MF_LAUNCH_STEPS = 2                  # (b): bf16 steps of the launcher, 2x2
MF_FLASH = ("whisper-large-v3", "zamba2-7b")   # the families with attention
MF_HOOK = ("codegen_reduce", "l1ball", "codegen_apply", "codegen_partial_apply")


def mf_argv(arch, radius, steps):
    """The train launcher's argv of a phase 16 family."""
    return ["--arch", arch, "--layers", str(MF_LAYERS[arch]), "--batch",
            str(MF_BATCH), "--microbatch", str(MF_MICRO), "--seq",
            str(MF_SEQ[arch]), "--steps", str(steps), "--radius", repr(radius),
            "--attn", MF_IMPL[arch]]


def mf_full_config(arch):
    """The registry's config of a phase 16 family, deepseek-v3 with the
    experts and leading dense layers of ``MF_MOE_CUT`` (``dataclasses.
    replace``; every width as published)."""
    from repro_torch.configs import registry

    cfg = registry.ARCHS[arch]   # not get_arch, which mf_registry_cut answers
    if arch == MF_MOE:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **MF_MOE_CUT))
    return cfg


@contextlib.contextmanager
def mf_registry_cut():
    """The registry answers deepseek-v3 with its ``MF_MOE_CUT`` config, as
    the train launcher looks its ``--arch`` up."""
    from repro_torch.configs import registry

    get = registry.get_arch
    registry.get_arch = lambda name: (mf_full_config(name) if name == MF_MOE
                                      else get(name))
    try:
        yield
    finally:
        registry.get_arch = get


def mf_setup(arch, radius, compute):
    """(cfg, tcfg, pipeline) of a phase 16 family: the launcher's
    TrainConfig with ``compute`` (remat on)."""
    from repro_torch.configs.types import ProjectionSpec, TrainConfig
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.models import lm

    cfg = lm.cut_depth(mf_full_config(arch), MF_LAYERS[arch])
    tcfg = TrainConfig(microbatch=MF_MICRO, total_steps=1, warmup=1, remat=True,
                       master_dtype="", compute_dtype=compute,
                       projection=ProjectionSpec(pattern=REC_PATTERN,
                                                 radius=radius))
    pipe = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=MF_SEQ[arch] + 1,
                                   global_batch=MF_BATCH, microbatch=MF_MICRO))
    return cfg, tcfg, pipe


def mf_shapes(arch, sizes):
    """The flash sites a phase 16 rank runs on the ``sizes`` mesh: (tag, q,
    k/v, causal) of one micro-batch's slice over "data" and the rank's
    heads; and the largest constrained leaf's shard (its path and shape)."""
    from repro_torch import _tree, models
    from repro_torch.models.params import param_specs
    from repro_torch.parallel import sharding

    cfg, _, _ = mf_setup(arch, 1.0, "float32")
    mesh = dict(zip(("data", "model"), sizes))
    tpl = models.get(cfg).template(cfg)
    specs = dict(_tree.leaves_with_paths(param_specs(
        tpl, sharding.param_rules(mesh), mesh)))
    shapes = dict(_tree.leaves_with_paths(_tree.tree_map(lambda pd: pd.shape, tpl)))
    b = MF_MICRO // sizes[0]
    h, s = cfg.n_heads // sizes[1], MF_SEQ[arch]
    hd = cfg.resolved_head_dim
    sites = []
    if arch == "whisper-large-v3":
        f = cfg.enc_frames
        sites = [("encoder", (b, h, f, hd), (b, h, f, hd), False),
                 ("decoder", (b, h, s, hd), (b, h, s, hd), True),
                 ("cross", (b, h, s, hd), (b, h, f, hd), False)]
    elif arch == "zamba2-7b":
        sites = [("shared", (b, h, s, hd), (b, h, s, hd), True)]
    names = [n for n, sh in shapes.items()
             if len(sh) >= 2 and re.search(REC_PATTERN, n)]
    big = max(names, key=lambda n: math.prod(shapes[n]))
    return sites, (big, sharding.local_shape(shapes[big], specs[big], mesh))


def mf_hold_kernels(randn, rand):
    """Phase 16's kernels at the shapes its ranks give them (``mf_shapes``
    on the (2, 2) mesh), against their plain versions with phase 1's bars:
    the flash forward, dQ and dK/dV in float32 ((a)'s compute) and bf16
    ((b)'s) at each attention site, and the sharded hook's reduce, l1ball
    and apply on the largest constrained shard of each family."""
    import torch

    from repro_torch.core import schedule
    from repro_torch.kernels import l1ball
    from repro_torch.kernels.codegen import lowering, tiling

    errs = {}

    def keep(name, e):
        errs[name] = max(errs.get(name, 0.0), e)

    norms = [n for n, _ in BILEVEL]
    for arch in MF_ARCHS:
        sites, (leaf, w_loc) = mf_shapes(arch, MF_SIZES[0])
        for tag, qs, ks, causal in sites:
            for dtype in (torch.float32, torch.bfloat16):
                e, held = hold_attention(randn, f"mesh families {arch} {tag}",
                                         qs, ks, causal, None, dtype)
                for name, err in e.items():
                    keep(f"{name} {str(dtype)[6:]}", err)
                del held
        lead = math.prod(w_loc[:-2])
        tp = tiling.plan_tiles(schedule.compile_schedule(w_loc[-2:], BILEVEL),
                               torch.float32)
        yc = randn((lead,) + tp.canon_shape)
        tag = f"mesh families {arch} {leaf} shard {tuple(w_loc)}"
        aggs, acc = lowering.codegen_reduce(yc, tp, norms[:-1], raw=True)
        vfin = lowering.finalize(norms[-2], acc)
        torch.cuda.synchronize()
        aggs_p, vfin_p = lowering.reduce_plain(yc, norms[:-1])
        keep("codegen_reduce", check_close(f"{tag} reduce", vfin, vfin_p,
                                           fmax(vfin_p)))
        radii = RADIUS_FRACTION * vfin_p.sum(1)
        u = l1ball.project_l1_batched(vfin_p, radii)
        torch.cuda.synchronize()
        u_p = l1ball.project_l1_plain(vfin_p, radii)
        keep("l1ball", check_close(f"{tag} l1ball", u, u_p, fmax(vfin_p)))
        x = lowering.codegen_apply(yc, aggs_p, vfin_p, u_p, tp, norms[:-1])
        torch.cuda.synchronize()
        keep("codegen_apply", check_close(
            f"{tag} apply", x, lowering.apply_plain(yc, aggs_p, vfin_p, u_p,
                                                   norms[:-1]), fmax(yc)))
        del yc, aggs, acc, vfin, aggs_p, vfin_p, u, u_p, x
        torch.cuda.empty_cache()
    print("mesh families kernels at the ranks' (2, 2) shapes vs their plain "
          "versions: " + ", ".join(f"{k} max_abs_err {v:.3e}"
                                   for k, v in errs.items()))
    return errs


def mf_rank(rank, world, backend, tmp, radii):
    """One rank of phase 16 (``torch.multiprocessing`` spawns it): (a) the
    float32 sharded step of each family on each mesh of MF_SIZES from the
    seed, with its launches, collectives, digests and the body the hook
    gave each constrained leaf (deepseek-v3's router gradient, step 1's
    first moment, gathered and saved by rank 0); (b) the train launcher of
    each family, and of kimi-k2's smoke config, on the 2x2 mesh in bf16,
    feasibility and peak memory. Writes its numbers to
    ``<tmp>/rank<rank>.json``."""
    import datetime

    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch import _tree, models
    from repro_torch.configs import registry
    from repro_torch.configs.types import ProjectionSpec
    from repro_torch.kernels import _build
    from repro_torch.launch import train as train_cli
    from repro_torch.models.params import param_specs
    from repro_torch.optim import projection_hook as PH
    from repro_torch.parallel import collectives, sharding
    from repro_torch.parallel.mesh import Mesh
    from repro_torch.training import init_state, make_train_step
    from repro_torch.training.sae_factory import constraint_report
    from repro_torch.training.step import step_collectives

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # four ranks share one card's 80 GB: segments that grow, not a cache of
    # fixed blocks that fragments under deepseek-v3's 3.45 GiB leaves
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600),
                            device_id=dev if backend == "nccl" else None)
    bodies = []
    resolve = PH._resolve_shard_backend

    def spy(*a, **k):   # the body the hook gives each sharded leaf
        be = resolve(*a, **k)
        bodies.append(be)
        return be

    PH._resolve_shard_backend = spy
    out = {"rank": rank, "a": {}, "b": {}}
    for sizes in MF_SIZES:
        mesh = Mesh(sizes, ("data", "model"))
        for arch in MF_ARCHS:
            cfg, tcfg, pipe = mf_setup(arch, radii[arch], "float32")
            api = models.get(cfg)
            specs = param_specs(api.template(cfg), sharding.param_rules(mesh),
                                sharding.mesh_shape_dict(mesh))
            state = init_state(cfg, tcfg, api, tcfg.seed, device=dev,
                               mesh=mesh, param_specs=specs)
            step = make_train_step(cfg, tcfg, api, impl=MF_IMPL[arch],
                                   n_groups=sharding.dp_shards(mesh),
                                   mesh=mesh, param_specs=specs)
            names = PH.matched_names(state["params"], tcfg.projection)
            bodies.clear()
            mesh.reset_counts()
            _build.reset_launches()
            mark = tile_search_mark()
            t0 = time.perf_counter()
            state, m = step(state, {"tokens": torch.from_numpy(
                pipe.batch(0)).to(dev)})
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            search = tile_search_launches(mark)
            launches = {k: n - search.get(k, 0)
                        for k, n in _build.launch_counts().items() if n}
            key = f"{arch} {sizes}"
            out["a"][key] = {
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "seconds": secs, "collectives": mesh.counts()["by_op"],
                "model": step_collectives(cfg, tcfg, specs, mesh,
                                          pipe.batch(0).shape),
                "launches": launches, "search_launches": search,
                "bodies": dict(zip(names, bodies)) if len(bodies) == len(names)
                else {"unmatched": bodies, "leaves": names},
                "digests": {n: _digest(x) for n, x in
                            _tree.leaves_with_paths(state["params"])},
                "specs": {n: list(sp) for n, sp in _tree.leaves_with_paths(specs)},
                "coords": mesh.coords,
                "peak_bytes": torch.cuda.max_memory_allocated(dev)}
            if arch == MF_MOE:   # step 1's first moment: 0.1 x the router's clipped gradient
                router = collectives.gather_full(
                    state["opt"]["m"]["moe_blocks"]["mlp"]["router"],
                    specs["moe_blocks"]["mlp"]["router"], mesh)
                if rank == 0:
                    torch.save(router.cpu(), tmp / f"router {key}.pt")
            del state, step
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
    launchers = [(arch, mf_argv(arch, radii[arch], MF_LAUNCH_STEPS)
                  + ["--mesh", "2x2"]) for arch in MF_ARCHS]
    for arch, argv in launchers + [(MF_KIMI, MF_KIMI_ARGV)]:
        torch.cuda.reset_peak_memory_stats(dev)
        dist.barrier()
        _build.reset_launches()
        mark = tile_search_mark()
        with mf_registry_cut():
            run = train_cli.run(argv)
        torch.cuda.synchronize()
        search = tile_search_launches(mark)
        launches = {k: n - search.get(k, 0)
                    for k, n in _build.launch_counts().items() if n}
        peak = torch.cuda.max_memory_allocated(dev)
        args = train_cli._parser().parse_args(argv)
        if arch == MF_KIMI:
            cfg = registry.smoke_config(arch)
            micro, seq = args.microbatch, args.seq
        else:
            cfg = mf_setup(arch, radii[arch], "bfloat16")[0]
            micro, seq = MF_MICRO, MF_SEQ[arch]
        tcfg = train_cli.launch_config(args)
        mesh = Mesh((2, 2), ("data", "model"))
        specs = param_specs(models.get(cfg).template(cfg),
                            sharding.param_rules(mesh), mesh.shape)
        flat = dict(_tree.leaves_with_paths(specs))
        spec = ProjectionSpec(pattern=REC_PATTERN, radius=args.radius)
        full = {n: collectives.gather_full(x, flat[n], mesh)
                for n, x in _tree.leaves_with_paths(run["state"]["params"])
                if n in PH.matched_names(run["state"]["params"], spec)}
        rep = constraint_report(full, spec)
        out["b"][arch] = {
            "argv": argv, "losses": run["losses"],
            "grad_norms": run["grad_norms"], "step_seconds": run["step_seconds"],
            "collectives": [c["by_op"] for c in run["collectives"]],
            "model": step_collectives(cfg, tcfg, specs, mesh,
                                      (args.batch // micro, micro, seq + 1)),
            "launches": launches, "peak_bytes": peak, "radius": args.radius,
            "max_violation": rep["max_violation"]}
        del run, full
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()
    (tmp / f"rank{rank}.json").write_text(json.dumps(out))


def mf_moe_cut(smi):
    """Print deepseek-v3's phase 16 cut: what it keeps, its parameters, the
    bytes of float32 weights, gradients and AdamW's two moments, and the
    deployment it stands for."""
    import math as _m

    from repro_torch import _tree, models

    cfg = mf_setup(MF_MOE, 1.0, "float32")[0]
    n = sum(_m.prod(pd.shape) for pd in
            _tree.leaves(models.get(cfg).template(cfg)))
    mo, ml = cfg.moe, cfg.mla
    print(f"mesh families {MF_MOE} cut: {cfg.n_layers} layers ({mo.first_dense} "
          f"dense MLA layer, {cfg.n_layers - mo.first_dense} MoE layer), "
          f"d_model {cfg.d_model}, {cfg.n_heads} MLA heads (q_lora "
          f"{ml.q_lora_rank}, kv_lora {ml.kv_lora_rank}, nope {ml.qk_nope_dim}, "
          f"rope {ml.qk_rope_dim}, v {ml.v_head_dim}), dense ffn {cfg.d_ff}, "
          f"{mo.n_experts} routed experts of {mo.d_expert} (top-{mo.top_k}), "
          f"{mo.n_shared} shared, vocab {cfg.vocab}: {n} parameters, "
          f"{16 * n / 1e9:.2f} GB of float32 weights, gradients and AdamW "
          f"moments; it stands for one MoE layer's share of 4 cards under "
          f"64-way expert parallelism of 256 experts (4 a chip; 4 a rank on "
          f"(1, 4), 8 on (2, 2)); {smi}")
    return n


def mf_one_device(dev, arch, radius, groups):
    """The float32 step's loss and gradient norm of a phase 16 family on one
    device from the seed, its dispatch in ``groups`` token groups: the
    step's own loss function and gradients of its one micro-batch, and
    ``adamw.grad_clip_factor``, without the optimizer's state (deepseek-v3's
    cut keeps 54 GB of it). For deepseek-v3 also step 1's first moment of
    the router, (1 - β1) · clip · g, as ``adamw.update`` makes it from
    zero."""
    import torch

    from repro_torch import _tree, models
    from repro_torch.models import params as PM
    from repro_torch.optim import adamw
    from repro_torch.training import make_loss_fn

    cfg, tcfg, pipe = mf_setup(arch, radius, "float32")
    api = models.get(cfg)
    params = PM.init_params(api.template(cfg), tcfg.seed, torch.float32,
                            device=dev)
    loss_fn = make_loss_fn(cfg, api, impl=MF_IMPL[arch], remat=tcfg.remat,
                           compute_dtype=torch.float32, n_groups=groups)
    leaves = [p.requires_grad_(True) for p in _tree.leaves(params)]
    loss = loss_fn(_tree.unflatten_like(params, leaves),
                   torch.from_numpy(pipe.batch(0)[0]).to(dev))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = _tree.unflatten_like(params, [torch.zeros_like(p) if g is None else g
                                          for p, g in zip(leaves, grads)])
    gnorm, clip = adamw.grad_clip_factor(grads, tcfg)
    out = {"loss": float(loss.detach()), "grad_norm": float(gnorm)}
    if arch == MF_MOE:
        out["router"] = ((1 - tcfg.beta1) * (grads["moe_blocks"]["mlp"]["router"]
                                          * clip)).cpu()
    return out


def mesh_families_phase(dev, smi, backend, randn, rand):
    """Phase 16: the kernels at the ranks' shapes (``mf_hold_kernels``), the
    single-device float32 step of each family from the seed
    (``mf_one_device``; deepseek-v3's for each mesh's ``dp_shards`` token
    groups), then four ranks
    (``mf_rank``; gloo with all four on one card, or NCCL one a card on
    four), then every hold. Returns the record; its ``launches`` are each
    rank's on (b), the bf16 launchers' main path."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    from repro_torch.parallel import sharding

    t_all = time.perf_counter()
    n_moe = mf_moe_cut(smi)
    kernel_errs = mf_hold_kernels(randn, rand)
    radii, ref = {}, {}
    for arch in MF_ARCHS:
        cfg, _, _ = mf_setup(arch, 1.0, "float32")
        radii[arch] = rec_radius(dev, cfg)[0]
        # the dispatch's groups follow each mesh's data ranks (dp_shards)
        for groups in sorted({s[0] for s in MF_SIZES} if arch == MF_MOE else {1}):
            one = mf_one_device(dev, arch, radii[arch], groups)
            for sizes in MF_SIZES:
                if arch != MF_MOE or sizes[0] == groups:
                    ref[f"{arch} {sizes}"] = one
            gc.collect()
            torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t_all

    tmp = ROOT / "build" / "chip_smoke_mesh_families"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    t1 = time.perf_counter()
    try:
        mp.start_processes(mf_rank, args=(MESH_RANKS, backend, tmp, radii),
                           nprocs=MESH_RANKS, join=True, start_method="spawn")
    except ProcessException as e:
        raise SmokeFailure(f"mesh families phase: a rank failed:\n{e}") from None
    ranks_s = time.perf_counter() - t1
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(MESH_RANKS)]
    routers = {key: torch.load(tmp / f"router {key}.pt") for key in ranks[0]["a"]
               if key.startswith(MF_MOE)}
    shutil.rmtree(tmp, ignore_errors=True)

    fails = []

    def fail(msg):
        print(f"mesh families FAILED: {msg}")
        fails.append(msg)

    # (a) float32 on each mesh against one device
    identical, router_err = {}, {}
    for key in ranks[0]["a"]:
        arch = key.split(" ")[0]
        want = ref[key]
        if arch == MF_MOE:
            got_r, want_r = routers[key], want["router"]
            rel = float((got_r - want_r).abs().max() / want_r.abs().max())
            rel_n = abs(float(got_r.norm()) / float(want_r.norm()) - 1)
            router_err[key] = {"max_abs_rel": rel, "norm_rel": rel_n}
            if not (rel <= MF_RTOL and rel_n <= MF_RTOL):
                fail(f"(a) {key}: the router's gradient {rel:.3e} of its largest "
                     f"entry and {rel_n:.3e} in norm from one device's")
            print(f"mesh families (a) {key}: the router's gradient (step 1's first "
                  f"moment, gathered) {rel:.3e} of its largest entry and "
                  f"{rel_n:.3e} in norm from one device's; {smi}")
        for o in ranks:
            a = o["a"][key]
            for k_ in ("loss", "grad_norm"):
                rel = abs(a[k_] - want[k_]) / abs(want[k_])
                if not rel <= MF_RTOL:
                    fail(f"(a) {key} rank {o['rank']} {k_} {a[k_]} vs one "
                         f"device {want[k_]} ({rel:.3e} relative)")
                if a[k_] != ranks[0]["a"][key][k_]:
                    fail(f"(a) {key} rank {o['rank']} {k_} differs from rank 0's")
            model = {op: {"calls": a["model"]["calls"][op],
                          "bytes": a["model"]["bytes"][op]}
                     for op in a["model"]["calls"]}
            if a["collectives"] != model:
                fail(f"(a) {key} rank {o['rank']}: collectives "
                     f"{a['collectives']} != the model {model}")
            plain = [n for n, be in a["bodies"].items() if be != "codegen"]
            if "unmatched" in a["bodies"] or plain or not a["bodies"]:
                fail(f"(a) {key} rank {o['rank']}: a constrained leaf did not "
                     f"take the codegen body: {a['bodies']}")
            flash = {k_: a["launches"].get(k_, 0) for k_ in F32_FLASH}
            hook = {k_: a["launches"].get(k_, 0) for k_ in MF_HOOK}
            if (not all(flash.values()) if arch in MF_FLASH
                    else any(flash.values())):
                fail(f"(a) {key} rank {o['rank']}: flash launches {flash}")
            if hook["codegen_reduce"] != len(a["bodies"]) or not (
                    hook["codegen_apply"] + hook["codegen_partial_apply"]) or (
                    arch == MF_MOE and hook["l1ball"] != len(a["bodies"])):
                fail(f"(a) {key} rank {o['rank']}: hook launches {hook} for "
                     f"{len(a['bodies'])} constrained leaves")
            print(f"mesh families (a) {key} rank {o['rank']}: loss "
                  f"{a['loss']:.7g} (one device {want['loss']:.7g}), grad norm "
                  f"{a['grad_norm']:.7g} (one device {want['grad_norm']:.7g}); "
                  f"{a['seconds']:.2f} s, peak {a['peak_bytes'] / 2**30:.2f} GiB; "
                  f"collectives = the model {a['model']['calls']}; flash "
                  f"launches {flash}; hook launches {hook}; bodies "
                  f"{a['bodies']}; {smi}")
        pairs = 0
        coords = [o["a"][key]["coords"] for o in ranks]
        for name, sp in ranks[0]["a"][key]["specs"].items():
            axes = sharding.spec_axes(tuple(sp))
            for r in range(MESH_RANKS):
                for q in range(r):
                    if all(coords[r][ax] == coords[q][ax] for ax in axes):
                        if ranks[r]["a"][key]["digests"][name] != \
                                ranks[q]["a"][key]["digests"][name]:
                            fail(f"(a) {key} {name} differs on ranks {q} and {r}")
                        else:
                            pairs += 1
        identical[key] = pairs
        print(f"mesh families (a) {key}: {pairs} copy pairs of the parameters "
              f"bit-identical across ranks")

    # (b) bf16: the launcher on the 2x2 mesh
    per_rank = {}
    for arch in ranks[0]["b"]:
        per_rank[arch] = []
        for o in ranks:
            b = o["b"][arch]
            if not (len(b["losses"]) == MF_LAUNCH_STEPS
                    and np.isfinite(b["losses"]).all()
                    and np.isfinite(b["grad_norms"]).all()):
                fail(f"(b) {arch} rank {o['rank']}: losses {b['losses']} "
                     f"gradient norms {b['grad_norms']}")
            if b["losses"] != ranks[0]["b"][arch]["losses"]:
                fail(f"(b) {arch} rank {o['rank']}: losses differ from rank 0's")
            model = {op: {"calls": b["model"]["calls"][op],
                          "bytes": b["model"]["bytes"][op]}
                     for op in b["model"]["calls"]}
            if any(c != model for c in b["collectives"]):
                fail(f"(b) {arch} rank {o['rank']}: collectives != the model")
            if not b["max_violation"] <= 1e-5 * b["radius"]:
                fail(f"(b) {arch} rank {o['rank']}: infeasible, max violation "
                     f"{b['max_violation']:.3e}")
            flash = {k_: b["launches"].get(k_, 0) for k_ in BF16_FLASH}
            hook = {k_: b["launches"].get(k_, 0) for k_ in MF_HOOK}
            if (not all(flash.values()) if arch in MF_FLASH
                    else any(flash.values())):
                fail(f"(b) {arch} rank {o['rank']}: flash launches {flash}")
            if not (hook["codegen_reduce"] and hook["l1ball"]
                    and (hook["codegen_apply"] + hook["codegen_partial_apply"])):
                fail(f"(b) {arch} rank {o['rank']}: hook launches {hook}")
            per_rank[arch].append({"rank": o["rank"], "losses": b["losses"],
                                   "step_ms": [x * 1e3 for x in b["step_seconds"]],
                                   "peak_gib": b["peak_bytes"] / 2**30,
                                   "launches": b["launches"]})
            print(f"mesh families (b) {arch} rank {o['rank']} "
                  f"(python -m repro_torch.launch.train {' '.join(b['argv'])}): "
                  f"losses {b['losses']}, step ms "
                  f"{[round(x * 1e3, 1) for x in b['step_seconds']]}, peak "
                  f"{b['peak_bytes'] / 2**30:.2f} GiB, feasible (max violation "
                  f"{b['max_violation']:.3e}), collectives = the model, flash "
                  f"launches {flash}, hook launches {hook}; {smi}")
    total = time.perf_counter() - t_all
    print(f"mesh families phase: {MESH_RANKS} ranks over {backend}, kernels and "
          f"references {ref_s:.1f} s, ranks {ranks_s:.1f} s wall, phase "
          f"{total:.1f} s; {smi}")
    if fails:
        raise SmokeFailure("mesh families phase: " + "; ".join(fails))
    return {"backend": backend, "radii": radii,
            "one_device": {k_: {f: v[f] for f in ("loss", "grad_norm")}
                           for k_, v in ref.items()},
            "moe_params": n_moe, "router_err": router_err,
            "seconds": {"references": ref_s, "ranks": ranks_s, "phase": total},
            "a": {k_: {o["rank"]: {f: o["a"][k_][f] for f in
                                   ("loss", "grad_norm", "seconds", "launches",
                                    "bodies", "peak_bytes")} for o in ranks}
                  for k_ in ranks[0]["a"]},
            "identical_pairs": identical, "b": per_rank,
            "kernels_at_rank_shapes": kernel_errs}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the port on the card.")
    ap.add_argument("--only", choices=("mesh", "attention", "autograd",
                                       "sae_tables", "train_mesh", "serve",
                                       "moe", "recurrent", "whisper",
                                       "launch", "widths", "mesh_families"),
                    help="run one phase alone: 'mesh' builds the kernels and "
                         "runs phase 7 (the partial apply, then the mesh "
                         "executor on four ranks); 'attention' builds them "
                         "and holds the flash kernels in float32 and bf16 "
                         "(granite's shape and every ragged case), the "
                         "Function's gradients, then times the kernels "
                         "beside their plain versions and SDPA; 'autograd' "
                         "builds them and runs phases 3b and 3c on W1–W4 "
                         "made from the seed; 'sae_tables' runs phase 8; "
                         "'train_mesh' builds them and runs phase 9; "
                         "'serve' builds them and runs phase 10; 'moe' "
                         "builds them and runs phase 11; 'recurrent' builds "
                         "them and runs phase 12; 'whisper' builds them and "
                         "runs phase 13; 'launch' builds them and runs "
                         "phase 14; 'widths' builds them and runs phase 15; "
                         "'mesh_families' builds them and runs phase 16")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.core import multilevel, plan as planmod, schedule
    from repro_torch.kernels import _build, flash_attention as flash, l1ball
    from repro_torch.kernels.codegen import lowering, tiling
    from repro_torch.roofline import costs as C
    from repro_torch.serving.engine import ProjectionEngine
    from repro_torch.training import sae_factory as F

    # the reference is float32: no TF32 in any matmul or convolution
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"{smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall; per source "
          + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()))
    logs = dict.fromkeys(k.library.with_suffix(".log")
                         for k in _build.KERNELS.values())  # one per source
    spills = []   # the clip stream's kernels must not spill
    for log in logs:  # each register/spill line after its kernel's mangled name
        entry = "?"
        source = log.stem.rsplit("-", 1)[0]
        for line in (log.read_text().splitlines() if log.exists() else ()):
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"ptxas {source} {entry}: {line.strip()}")
                spilled = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if (source in ("bilevel_l1inf", "trilevel_l1infinf")
                        and ("clip_kernel" in entry or "apply_kernel" in entry)
                        and spilled and spilled.groups() != ("0", "0")):
                    spills.append(entry)
    if spills:
        raise SmokeFailure(f"the clip stream spills: {spills}")

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(shape, scale=2.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    # phase 7's collective transport: NCCL with one rank per card when the
    # machine has four, else gloo with the four ranks on one card
    mesh_backend = "nccl" if torch.cuda.device_count() >= MESH_RANKS else "gloo"
    print(f"mesh backend: {mesh_backend}, {MESH_RANKS} ranks on "
          + (f"cuda:0–{MESH_RANKS - 1}" if mesh_backend == "nccl" else "cuda:0"))

    def mesh_phases():
        """Phase 7: the partial apply alone, then the four ranks; its
        kernel row (launches from rank 0's main path) and the ranks."""
        torch.cuda.empty_cache()
        row = hold_partial_apply(randn, rand)
        torch.cuda.empty_cache()
        ranks, seconds = mesh_phase(mesh_backend)
        row["launches"] = ranks[0]["leaves"]["wq"]["codegen_launches"][
            "codegen_partial_apply"]
        return row, {"backend": mesh_backend, "seconds": seconds, "ranks": ranks}

    def train_mesh_phases(rows=()):
        """Phase 9 from freed memory; each kernel row of its path gets the
        launches every rank made on (b), the bf16 main path."""
        torch.cuda.empty_cache()
        rec = train_mesh_phase(dev, mesh_backend, randn, rand)
        for row in rows:
            if row["name"] in rec["bf16"]["per_rank"][0]["launches"]:
                row["launches_train_mesh"] = [
                    r["launches"][row["name"]] for r in rec["bf16"]["per_rank"]]
        return rec

    def finish(result):
        """The last three lines: the result's JSON, the card, the verdict."""
        print(json.dumps(result))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if args.only == "attention":
        attn_case_errs, attn_full, _ = hold_attention_all(randn)
        flash_full = hold_flash(randn, "full", *FLASH_FULL)
        rows = time_attention(attn_full, attn_case_errs, function_launches())
        del attn_full
        q, k, v = flash_full[1]
        _build.reset_launches()
        flash.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        rows.append(time_flash_harvest(
            flash_full, _build.launch_counts()["flash_fwd_tf32"]))
        return finish({"kernels": rows})

    if args.only == "mesh":
        row, mesh = mesh_phases()
        return finish({"kernels": [row], "mesh": mesh})

    if args.only == "autograd":
        reqs = {}
        for wl, (shape, levels) in FULL.items():
            y = randn(shape)
            reqs[wl] = (y, (0.25 * float(multilevel.multilevel_norm(y, levels)),))
        wls = golden_workloads(reqs)
        return finish({"kernels": [], "grad": grad_phase(wls),
                       "refuse_grad": refuse_grad_phase(wls)})

    if args.only == "sae_tables":
        return finish({"kernels": [], "sae_tables": sae_tables_phase()})

    if args.only == "train_mesh":
        return finish({"kernels": [], "train_mesh": train_mesh_phases()})

    def serve_phases(rows=()):
        """Phase 10 from freed memory; each kernel row of its paths gets the
        launches of the service's flush or of the instrumented launcher."""
        torch.cuda.empty_cache()
        rec = serve_phase(dev, randn, rand)
        for row in rows:
            for part in ("service", "telemetry"):
                if row["name"] in rec[part]["launches"]:
                    row["launches_serve"] = rec[part]["launches"][row["name"]]
        return rec

    if args.only == "serve":
        return finish({"kernels": [], "serve": serve_phases()})

    if args.only == "moe":
        return finish({"kernels": [], "moe": moe_phase(dev, smi)})

    if args.only == "recurrent":
        return finish({"kernels": [], "recurrent": recurrent_phase(dev, smi)})

    if args.only == "whisper":
        rec = whisper_phase(dev, smi, randn)
        return finish({"kernels": whisper_rows(rec), "whisper": rec})

    if args.only == "launch":
        return finish({"kernels": [], "launch": launch_phase(dev, smi, randn)})

    if args.only == "widths":
        rec = widths_phase(dev, smi, randn, rand)
        return finish({"kernels": widths_rows(rec), "widths": rec})

    def mesh_families_phases(rows=()):
        """Phase 16 from freed memory; each kernel row of its path gets the
        launches every rank made on (b), the bf16 launchers' main path,
        per family."""
        gc.collect()
        torch.cuda.empty_cache()
        rec = mesh_families_phase(dev, smi, mesh_backend, randn, rand)
        for row in rows:
            row["launches_mesh_families"] = {
                arch: [r["launches"].get(row["name"], 0) for r in per]
                for arch, per in rec["b"].items()}
        return rec

    if args.only == "mesh_families":
        return finish({"kernels": [], "mesh_families": mesh_families_phases()})

    marks = [("start", time.perf_counter())]
    # phase 14 (c) and (d) walk on the host's CPU with no card: started
    # now at the lowest priority, they run beside phases 1-13
    background = (launch_background(ROOT / "build" / "chip_smoke_launch",
                                    nice=True), time.perf_counter())

    def mark(name):
        """Print the seconds since the last mark: each phase's command time."""
        marks.append((name, time.perf_counter()))
        print(f"command time: {name} {marks[-1][1] - marks[-2][1]:.1f} s "
              f"(total {marks[-1][1] - marks[0][1]:.1f} s)")

    # ------------------------------------- phase 1: kernels vs plain versions
    for name, shape, levels in DESIGNS:
        for nonfinite in (False, True):
            errs, _ = hold_pipeline(randn, rand, name, shape, levels, 3,
                                    nonfinite)
            print(f"design {name} {shape}{' NaN/±inf' if nonfinite else ''}: "
                  + ", ".join(f"{k} max_abs_err {v:.3e}" for k, v in errs.items()))

    for n in (1, 127, 2048, tiling.L1_ONE_CTA_MAX):
        for case in L1_CASES:
            v, radii = l1ball_case(randn, rand, n, case)
            nonfinite = case in ("nan", "inf")
            for method in ("bisect", "filter"):
                got = l1ball.project_l1_batched(v, radii, method=method)
                # the last item alone, its radius by value (no device copy)
                one = l1ball.project_l1(v[-1], float(radii[-1]), method=method)
                torch.cuda.synchronize()
                want = l1ball.project_l1_plain(v, radii, method)
                tag = f"l1ball {method} n={n} {case}"
                err = max(check_close(tag, got, want, fmax(v), nonfinite=nonfinite),
                          check_close(f"{tag} one item", one, want[-1], fmax(v),
                                      nonfinite=nonfinite))
                print(f"{tag}: max_abs_err {err:.3e}")

    mark("phase 1 (the codegen designs, l1ball)")
    for i, (qs, ks, causal, window) in enumerate(FLASH_CASES):
        hold_flash(randn, f"case{i}", qs, ks, causal, window)
    flash_full = hold_flash(randn, "full", *FLASH_FULL)

    attn_case_errs, attn_full, fn_errs = hold_attention_all(randn)
    golden_errs = hold_golden_kernels(randn, rand)

    full_cases = {}
    for wl, (shape, levels) in FULL.items():
        errs, inputs = hold_pipeline(randn, rand, f"{wl} full", shape,
                                     levels, BUCKET)
        full_cases[wl] = (errs, inputs)
        print(f"{wl} {BUCKET}x{shape}: " + ", ".join(
            f"{k} max_abs_err {v:.3e}" for k, v in errs.items()))
    torch.cuda.empty_cache()

    mark("phase 1 (flash, golden kernels, full-width pipelines)")
    # ------------------------------------- phase 2: the server at full width
    # synchronous engines (start=False: result() dispatches inline), so each
    # workload's 8 requests form exactly one bucket of 8
    eng_batch = ProjectionEngine(device="cuda", method="codegen_batch",
                                 max_batch=BUCKET, start=False)
    eng_single = ProjectionEngine(device="cuda", method="codegen",
                                  max_batch=BUCKET, start=False)
    for wl, (shape, levels) in FULL.items():
        eng_batch.prewarm(shape, torch.float32, levels)
        eng_single.prewarm(shape, torch.float32, levels)
    eng_batch.wait_warm()
    eng_single.wait_warm()

    # the main path, one counting window per path: the bucket of 8 through
    # codegen_batch, then one request through codegen
    launches = {}
    served = 0
    server_reqs = {}  # the first request of each workload, for phase 3
    for wl, (shape, levels) in FULL.items():
        ys = [randn(shape) for _ in range(BUCKET + 1)]
        radii = [float(multilevel.multilevel_norm(y, levels))
                 * (0.05 + 0.45 * float(rand(()))) for y in ys]
        outs = []
        for batch, eng, part in ((BUCKET, eng_batch, slice(0, BUCKET)),
                                 (1, eng_single, slice(BUCKET, BUCKET + 1))):
            _build.reset_launches()
            tickets = [eng.submit(y, levels, r)
                       for y, r in zip(ys[part], radii[part])]
            outs += [eng.result(t, timeout=300) for t in tickets]
            torch.cuda.synchronize()
            launches[wl, batch] = _build.launch_counts()
            print(f"server {wl} {'codegen_batch' if batch > 1 else 'codegen'} "
                  f"x{batch}: launches {launches[wl, batch]}")
            for k in SERVER_KERNELS:
                if launches[wl, batch][k] == 0:
                    raise SmokeFailure(f"server {wl}: kernel {k} never launched")
        m = shape[-1]
        for i, (y, r, x) in enumerate(zip(ys, radii, outs)):
            want = multilevel.multilevel_project(y, levels, r, method="bisect")
            err = check_close(f"server {wl} request {i}", x, want,
                              float(y.abs().max()))
            nrm = float(multilevel.multilevel_norm(x, levels))
            # one float32 ulp of θ per summed aggregate entry
            slack = r * RTOL + m * 2.0 ** -23 * float(y.abs().max())
            if not nrm <= r + slack:
                raise SmokeFailure(f"server {wl} request {i}: norm {nrm} > "
                                   f"radius {r}")
            served += 1
        print(f"server {wl}: {len(outs)} requests correct and feasible "
              f"(last max_abs_err {err:.3e})")
        server_reqs[wl] = (ys[0], (radii[0],))
        del ys, outs, tickets
        torch.cuda.empty_cache()

    # engine latency at full width, bucket 8, after the checks above: the
    # synchronous engine (one bucket of 8 per round) and a threaded one (the
    # dispatcher thread pops whatever has arrived, as a deployed server
    # does), whose answers must equal the synchronous engine's
    eng_threaded = ProjectionEngine(device="cuda", method="codegen_batch",
                                    max_batch=BUCKET)
    latency = {}
    for wl, (shape, levels) in FULL.items():
        ys = [randn(shape) for _ in range(BUCKET)]
        for mode, eng in (("sync", eng_batch), ("threaded", eng_threaded)):
            bucket_s, request_s = [], []
            for _ in range(5):
                t0 = time.perf_counter()
                tickets = [(eng.submit(y, levels, 100.0), time.perf_counter())
                           for y in ys]
                outs, done = [], []
                for t, ts in tickets:
                    outs.append(eng.result(t, timeout=300))
                    torch.cuda.synchronize()
                    done.append(time.perf_counter() - ts)
                bucket_s.append(time.perf_counter() - t0)
                request_s.append(statistics.median(done))
            if mode == "sync":
                latency[wl] = (statistics.median(bucket_s),
                               statistics.median(request_s))
                sync_outs = outs
            else:
                for i, (a, b) in enumerate(zip(outs, sync_outs)):
                    check_close(f"threaded engine {wl} request {i}", a, b,
                                float(ys[i].abs().max()))
            print(f"engine {wl} {mode} bucket {BUCKET}: bucket latency "
                  f"{statistics.median(bucket_s) * 1e3:.3f} ms, per-request "
                  f"latency {statistics.median(request_s) * 1e3:.3f} ms "
                  f"(median of 5, host clock, submit to result)")
        del ys, outs, sync_outs
    for eng in (eng_batch, eng_single, eng_threaded):
        snap = eng.stats_snapshot()
        if snap["failures"] or snap["failed"] or snap["queued"] or snap["inflight"]:
            raise SmokeFailure(f"engine stats show failures: {snap}")
        if (snap["completed"] + snap["failed"] + snap["discarded"]
                + snap["queued"] + snap["inflight"] != snap["submitted"]):
            raise SmokeFailure(f"engine accounting broken: {snap}")
        eng.stop()
    print(f"server: {served} checked requests, 0 failures; plan cache "
          f"{planmod.cache_info()}")

    mark("phase 2")
    # ------------------ phase 3: the hand-written Algorithm 2 and 5 pipelines
    wls = golden_workloads(server_reqs)
    golden = golden_phase(wls)
    del server_reqs

    # ---------- phases 3b, 3c: gradients through the generated pipeline
    grad = grad_phase(wls)
    refused = refuse_grad_phase(wls)

    mark("phases 3, 3b, 3c")
    # ------------------------------ phase 4: the SAE factory at full width
    fac = factory_phase(dev, F.SAEFactoryConfig(**FACTORY), FACTORY_SEEDS,
                        ROOT / "build" / "chip_smoke_factory", randn)

    mark("phase 4")
    # ------------------------------ phase 5: LM training at full width
    trn = training_phase(dev, ROOT / "build" / "chip_smoke_train")
    mark("phase 5")

    # ------------------------------------- phase 6: times at full width
    # each kernel at the bucket of 8 and at one item (the codegen path), on
    # the phase-1 inputs, held once more against its plain version
    rows = []
    stack_ms = {}
    for wl, (_, inputs) in full_cases.items():
        yc8, tp, norms, aggs8, vfin8, u8, radii8 = inputs
        for b in (BUCKET, 1):
            yc, vfin_p, u_p, radii = yc8[:b], vfin8[:b], u8[:b], radii8[:b]
            aggs_p = [a[:b] for a in aggs8]
            elems, m = yc.numel(), tp.m
            agg_elems = sum(a.numel() for a in aggs_p)
            scale = float(yc.abs().max())
            out = torch.empty_like(yc)
            cases = {  # kernel, plain, compare, bytes, operations
                "codegen_reduce": (
                    lambda: lowering.codegen_reduce(yc, tp, norms[:-1]),
                    lambda: lowering.reduce_plain(yc, norms[:-1]),
                    lambda k, p: max(check_close(f"{wl} x{b} reduce", a, c,
                                                 float(c.max()))
                                     for a, c in zip([k[1], *k[0]],
                                                     [p[1], *p[0]])),
                    *C.codegen_reduce(elems, agg_elems, b, m)),
                "l1ball": (
                    lambda: l1ball.project_l1_batched(vfin_p, radii),
                    lambda: l1ball.project_l1_plain(vfin_p, radii),
                    lambda k, p: check_close(f"{wl} x{b} l1ball", k, p,
                                             float(vfin_p.max())),
                    *C.l1ball(b, m)),
                "codegen_apply": (
                    lambda: lowering.codegen_apply(yc, aggs_p, vfin_p, u_p, tp,
                                                   norms[:-1], out=out),
                    lambda: lowering.apply_plain(yc, aggs_p, vfin_p, u_p,
                                                 norms[:-1]),
                    lambda k, p: check_close(f"{wl} x{b} apply", k, p, scale),
                    # vfin is read only for an ℓ2 at the final reduce level
                    *C.codegen_apply(elems, agg_elems, b, m, norms[-2] == "2")),
            }
            # one PyTorch call computing the same output, where there is one:
            # the bi-level reduce's single aggregate (an ℓ∞ vector norm), and
            # the ℓ∞ apply as a clamp with its bounds precomputed (the
            # tri-level reduce has two outputs, v1 and vfin; l1ball's
            # θ-solve has no such call)
            lib = dict.fromkeys(cases)
            w_b = u_p[:, None, :] if wl == "bilevel" \
                else torch.minimum(aggs_p[-1], u_p[:, None])[:, None]
            lo_b = -w_b
            lib["codegen_apply"] = lambda: torch.clamp(yc, lo_b, w_b)  # noqa: E731
            check_close(f"{wl} x{b} apply: torch.clamp", lib["codegen_apply"](),
                        cases["codegen_apply"][1](), scale)
            if wl == "bilevel":
                lib["codegen_reduce"] = lambda: torch.linalg.vector_norm(  # noqa: E731
                    yc, INF, dim=1)
                check_close(f"{wl} x{b} reduce: vector_norm", lib["codegen_reduce"](),
                            cases["codegen_reduce"][1]()[1], scale)
            for name, (kern, plain, compare, nbytes, nops) in cases.items():
                err = compare(kern(), plain())
                torch.cuda.synchronize()
                plain_ms = event_ms(plain)
                ms = event_ms(kern)
                # device time alone (CUDA-graph replay, and per call of a
                # 20-call replay) and host time per call
                dev_ms, host = graph_ms(kern), host_call_ms(kern)
                dev20 = graph_ms(kern, calls=20)
                lf = lib[name]
                lib_ms, lib_dev, lib_host = (None, None, None) if lf is None else (
                    event_ms(lf), graph_ms(lf), host_call_ms(lf))
                bms, by = bound_ms(nbytes, nops)
                rows.append({
                    "name": name, "workload": f"{wl} {b}x{FULL[wl][0]}",
                    "route": "cuda", "source": f"src/repro_torch/csrc/{name}.cu",
                    "replaces": REPLACES[name, b > 1],
                    "launches": launches[wl, b][name], "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                    "bound_by": by, "library_ms": lib_ms, "graph_ms": dev_ms,
                    "graph20_ms": dev20, "host_ms": host,
                    "library_graph_ms": lib_dev, "library_host_ms": lib_host})
                lib_txt = "n/a" if lf is None else (
                    f"{lib_ms:.4f} ms (replay {lib_dev:.4f}, host per call "
                    f"{lib_host:.4f})")
                print(f"time {wl} x{b} {name}: {ms:.4f} ms (bound {bms:.4f} ms "
                      f"by {by}, {bms / ms:.2f} of bound; CUDA-graph replay "
                      f"{dev_ms:.4f} ms, {bms / dev_ms:.2f} of bound; per call "
                      f"of a 20-call replay {dev20:.4f} ms; host per "
                      f"call {host:.4f} ms), plain {plain_ms:.4f} ms, library "
                      f"{lib_txt}, max_abs_err {err:.3e}")
            if b == BUCKET:
                # the engine's other device work per bucket: the stack copy
                items = list(yc.unbind(0))
                stack_ms[wl] = event_ms(lambda: torch.stack(items, out=out))
                print(f"time {wl} x{b} bucket stack: {stack_ms[wl]:.4f} ms")
                del items
            del out
    # the float32 flash forward at the harvest's shape (row 12 f32)
    rows.append(time_flash_harvest(flash_full, fac["flash_launches"]))
    ms = rows[-1]["ms"]
    rows += time_attention(attn_full, attn_case_errs, trn["counts"] | {
        n: trn["held_launches"][n] for n in F32_FLASH[1:]}, trn)
    golden_rows, golden_ms = time_golden(wls, golden, golden_errs)
    rows += golden_rows
    del wls
    step_parts, sae_parts = fac["harvest_step_ms"], fac["sae_step_ms"]
    step_parts["flash_ms"] = fac["n_layers"] * ms
    # the 24 blocks' matmuls, norms, rope and the collect stack
    step_parts["forward_rest_ms"] = step_parts["forward_ms"] \
        - step_parts["flash_ms"] - step_parts["layout_copies_ms"] \
        - step_parts["unembed_ms"]
    for parts in sae_parts.values():
        # AdamW, gradient accumulation and clipping, host dispatch
        parts["rest_ms"] = parts["step_ms"] - parts["fwd_bwd_ms"] \
            - parts["projection_ms"]
    print(f"harvest step breakdown (ms): {step_parts}")
    print(f"SAE step breakdown (ms): {sae_parts}")
    del full_cases, attn_full, flash_full
    mark("phase 6")
    # ------------------------- phase 7: the mesh executor at full width
    mesh_row, mesh = mesh_phases()
    rows.append(mesh_row)
    mark("phase 7")

    # ------------------- phase 8: the §7.3 application at the paper's size
    tables = sae_tables_phase()
    mark("phase 8")

    # ------------------------------------------ phase 9: sharded training
    train_mesh = train_mesh_phases(rows)
    mark("phase 9")

    # ------------------------- phase 10: serving, telemetry, int8 moments
    serve = serve_phases(rows)
    mark("phase 10")

    # ---------------------------- phase 11: the MoE family at full width
    moe = moe_phase(dev, smi)
    mark("phase 11")

    # ------------------------ phase 12: the recurrent families at full width
    recurrent = recurrent_phase(dev, smi)
    mark("phase 12")

    # ---------------------------- phase 13: whisper-large-v3 at full width
    whisper = whisper_phase(dev, smi, randn)
    mark("phase 13")

    # ------------- phase 14: the dry run, the cost model, the tile search
    launch = launch_phase(dev, smi, randn, background)
    mark("phase 14")

    # ------- phase 15: every head width, danube and zamba on flash, the long
    # l1ball and the golden pipelines in bf16
    widths = widths_phase(dev, smi, randn, rand)
    mark("phase 15")

    # ------- phase 16: the audio, hybrid and recurrent families under a mesh
    mesh_families = mesh_families_phases(rows)
    mark("phase 16")
    wrows = widths_rows(widths)
    rows.append(wrows[-1])   # l1ball_cluster; the flash rows ride along
    for row in rows:
        if row["name"] in widths["flash"]["sites"]:
            row["widths"] = widths["flash"]["sites"][row["name"]]
            row["launches_widths"] = next(
                r["launches"] for r in wrows if r["name"] == row["name"])
    for row in rows:
        if row["name"] in ("codegen_reduce", "codegen_apply"):
            row["search_launches"] = {
                wl: r["search_launches"].get(row["name"], 0)
                for wl, r in launch["search"].items()}
            row["search_launches_auto"] = {
                wl: r["auto"]["search_launches"].get(row["name"], 0)
                for wl, r in launch["search"].items()}
    for row in rows:
        row["launches_moe"] = moe["launches"].get(row["name"], 0)
        row["launches_recurrent"] = recurrent["launches"].get(row["name"], 0)
        row["launches_whisper"] = whisper["train"]["launches"].get(row["name"], 0)
        if row["name"] in whisper["flash"]:
            row["whisper"] = whisper["flash"][row["name"]]
            row["launches_whisper_held"] = whisper["held"]["launches"][row["name"]]
    return finish({"kernels": rows, "mesh": mesh, "grad": grad,
                   "train_mesh": train_mesh, "serve": serve, "moe": moe,
                   "recurrent": recurrent, "whisper": whisper,
                   "launch": launch, "widths": widths,
                   "mesh_families": mesh_families,
                   "refuse_grad": refused, "sae_tables": tables,
                   "factory": {"harvest_step_ms": step_parts,
                               "sae_step_ms": sae_parts,
                               "held_sae_step": fac["held_sae_step"],
                               "runs": fac["runs"]},
                   "train": {k_: v_ for k_, v_ in trn.items()
                             if k_ != "per_step"},
                   "flash_function_grad_err": fn_errs,
                   "golden": {wl: dict(golden[wl], pipelines_ms=golden_ms[wl])
                              for wl in golden},
                   "radius_copy": golden_ms["radius_copy"],
                   "engine_ms": {
                       wl: {"bucket_latency": v[0] * 1e3,
                            "per_request_latency": v[1] * 1e3,
                            "bucket_stack": stack_ms[wl]}
                       for wl, v in latency.items()}})


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
