#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main paths at full width on random weights from a
seeded generator: with the flagship Metaformer
(``configs.LSTMFORMER_MODEL_CFG``: hidden 256, 5 blocks, encoders of 5
mixer blocks, 4 heads, 10 s context) offline AR generation, the training
step and the training CLI (and, last, its other decode layouts, a
streaming session and the serving pool); then the same three with lstm_with_sampling
(``configs.LWS_MODEL_CFG``: a 2-layer 128-wide LSTM sampler, two
256-wide layered-LSTM blocks), with the GRU-embedding Metaformer
(``configs.LSTMFORMER_GRU_MODEL_CFG``: the flagship with GRU embeddings)
and with simple_lstm (``configs.SIMPLE_LSTM_MODEL_CFG``: bidirectional
128-wide LSTM encoders over 256-wide affines, 8-head cross-modal
attention, a 5-block decoder, 15-frame context, 120 audio frames).
Phases:

  0. device: name and power limit; TF32 off;
  1. build every CUDA kernel library from csrc/, one nvcc each, all
     started together (timed; registers and spills printed);
  2. mixer-stack inference kernel (K1) vs its plain version, f32, B16 x
     H256 x L5 at T2096 (audio encoder) and T262 (partner-motion
     encoder): <= 1e-4 (sums taken in another order over 5 x 2096
     sequential cells); the layer-lagged chunk schedule at the chunk
     ``chunk_steps`` picks and at chunk = T (layer-major) timed in turns,
     their outputs equal bit for bit, the chunk, rows per cluster,
     clusters and the card's resident clusters printed, and a chunk
     sweep on an earlier line;
  3. decode-rollout kernel (K2) vs its plain version at B16 x T250,
     teacher-forced: f32 kernel vs f32 plain <= 1e-4; bf16 kernel vs f32
     plain <= 5e-2 (the JAX package's bf16 drift bound);
  4. decode main path: ``generate_metaformer`` with the full mask and
     bf16 caches on 3 batches of 16 x 250 frames (lead 12): shape,
     finite, launch counts (K1 +2, K2 +1, the training kernels +0 per
     generation), time per generation; then a teacher-forced f32
     generation at batch 2 against the same weights and inputs on CPU
     tensors (the all-plain path): <= 1e-4; the generation with the
     stack's chunk schedule and at chunk = T, in turns;
  5. mixer-stack training forward (K3) and backward (K4) vs their plain
     versions (autograd through the plain forward), f32, B32 x H256 x L5
     at T2016 and T252, seeded random inputs, weights and cotangents:
     out, hn, cn <= 1e-4 abs; each of the twelve gradients
     max|kernel - plain| / max|plain| <= 1e-3; K3 as K1 in phase 2:
     sweep, the chosen chunk and chunk = T in turns, and out, hn, cn and
     every residual plane equal bit for bit;
  6. LSTM-layer forward (K7, with and without residuals) and backward vs
     plain at B32 x T252 x din 256 x H256 (the Metaformer's self-motion
     LSTMs), B256 x T140 (lstm_with_sampling's blocks) and B256 x T120,
     256 -> 128 (simple_lstm's acoustic LSTMs), the same bounds; each
     chain at the wrapper's rows per cluster (its clusters, one wave, and
     the card's resident clusters at every rows per cluster printed) and
     at R 16 through the wrappers' ``rows``, both held to the plain
     version and timed in turns; cuDNN's ``torch.nn.LSTM`` with the same
     weights timed as a yardstick;
  7. rect-attention forward (K5) and backward (K6) vs plain at B32, Lq
     252, Lk 2016 and 252, E 256, 4 heads, 10% padded rows and keys: the
     same bounds; two K6 calls on the same inputs bit-identical; K6's
     dQ workspace bytes and each of its launches' device time under
     ``torch.profiler``; ``scaled_dot_product_attention`` with the
     boolean mask timed as a yardstick (forward, and its backward through
     autograd);
  8. training main path: ``train.harness.streaming_step_fns`` at B32 x
     T240 (lead 12), AdamW lr 1e-4, weight decay 1e-2: one warm-up
     step, 5 timed steps (ms per step, trained frames/s, peak memory),
     launch counts per step (K5 +10, K6 +10, K3 +2, K4 +2, K7 forward
     +5, K7 backward +5, K1 and K2 +0), finite losses; one eval step
     (K5 +10, K1 +2, K7 forward +5); one more training step under
     ``torch.profiler``: the device's busy share goes into the
     ``train_step`` record, and the table of kernels by device time into
     ``_build/profile_train_step.txt`` of the package, with the share of
     the encoder stack's windows in which two or more layers'
     recurrences ran at once; the step with the stack's chunk schedule
     and at chunk = T in turns (ms, peak memory); then one SGD step
     (lr 1e-2, momentum 0.9) at B2 x T48 on the card and on CPU tensors
     from the same weights and batch: loss within 1e-5 relative, every
     parameter gradient within 1e-3 of its largest magnitude (floored at
     1e-4 of the largest gradient of all: the k-projection biases'
     gradients are zero in exact arithmetic);
  9. training CLI: ``train.cli.main`` with ``configs/lstmformer.yaml``'s
     own settings at batch 32 on a corpus this script writes (4 sessions
     x 540 s, 2,160 s of audio per channel: 108 training and 13
     validation windows of 10 s), one epoch, then one epoch resumed from
     ``last``: finite train, val and generation losses, V/T/G
     checkpoints and ``last``, the epoch records, and the launches of
     every kernel (K5, K6, K3, K4, K7 per train step; K5, K1, K7 and a
     generation's K1 and K2 per validation batch);
 9b. eval CLI: ``infer.cli`` with ``configs/lstmformer.yaml`` at full width
     on phase 9's corpus and its ``last`` checkpoint, batches of 8, bf16
     caches: with PIL and matplotlib ``main`` whole (speed.log, genrt
     loss, per segment ``EVAL_RENDER_FRAMES`` comparison frames, pose
     strips and nod.png), else ``evaluate`` and a line naming the missing
     library; one speed.log line per batch, a finite loss, one rendered
     output and nod.png per segment, launches K1 +2 and K2 one per 16 rows
     per batch and nothing else, the first batch's predictions bit-equal
     to a direct ``generate_metaformer`` call; then the reference
     round trip: ``torch_export`` of ``last`` saved as a Lightning
     ``{"state_dict": {"model.<name>": ...}}``, ``torch_import.main`` on
     it, the imported state_dict bit-equal to ``last``'s and ``evaluate``
     on it bit-equal to the CLI's predictions;
 9c. phase 9 with ``model.dropout=0.1``: per train step K7 +15 / +15 (the
     encoder stacks block by block), K5 +10, K6 +10, no K3 or K4; per
     validation batch as phase 9;
 9d. phase 9 with ``trainer.precision=bf16``: per train step the bf16
     modes, K3 +2, K4 +2, K7 +5 / +5, K5 +2 and K6 +2 (block 0's
     integrators), and K5's and K6's f32 mode +8 each (the later blocks'
     f32 queries); per validation batch in f32, as phase 9; the ``last``
     checkpoint's parameters and optimizer state all f32;
 10. stacked-LSTM wavefront (K9) forward with and without residuals and
     backward vs plain, f32, H128 x L2 at B256 x T1120 (the sampler in
     training) and B16 x T96 (the generation warmup): out, hn, cn <=
     1e-4 abs; each gradient max|kernel - plain| / max|plain| <= 1e-3;
     the wrapper's rows per cluster and R 16 as in phase 6; cuDNN's
     2-layer ``torch.nn.LSTM`` with the same recurrent weights timed as a
     yardstick (it also computes layer 0's input product);
 11. lstm_with_sampling generation: ``generate_lws`` with the full mask
     on 1 batch of 16 x 250 frames (lead 12; cut from 3 for room, the
     same draws): shape, finite, launches per generation (K9 forward +1,
     nothing else), time (no profile: PERF.md quotes its table); then a
     teacher-forced f32
     generation at batch 2 x 125 frames vs CPU tensors: <= 1e-4;
 12. lstm_with_sampling training step at the yaml's batch and window,
     B256 x T128 (lead 12), AdamW with the yaml's optim group: as phase
     8, with launches per step K9 +1 / +1 and K7 +2 / +2, per eval step
     K9 +1 and K7 forward +2, the profiler table in
     ``_build/profile_lws_train_step.txt``;
 13. lstm_with_sampling training CLI: ``configs/lstm_with_sampling.yaml``
     at ``exp.batch_size=32`` on phase 9's corpus, an epoch and a resumed
     epoch, the checks of phase 9, and exact K9 and K7 launches (per
     train step K9 +1 / +1, K7 +2 / +2; per validation batch an eval
     step, K9 +1 and K7 forward +2, and a generation, K9 +1);
13b. lws eval CLI: phase 9b with ``configs/lstm_with_sampling.yaml`` on
     phase 13's checkpoint: launches K9 +1 per batch and nothing else;
13c. phase 13 with ``model.use_scheduled_sampling=true``: per train step
     K9 +1 / +1 (the rollout's warmup), nothing else; per validation
     batch as phase 13; ``scheduled_sampling_rate`` 0 and 0.5 in the
     epoch records (epoch / ``model.max_epochs``);
13d. phase 13 with ``trainer.precision=bf16``: per train step the bf16
     modes, K9 +1 / +1 and K7 +2 / +2, and no f32 training launch; per
     validation batch in f32 (an eval step, K9 +1 and K7 forward +2, and a
     generation, K9 +1); the ``last`` checkpoint's parameters all f32;
 14. GRU recurrence (K10) forward with and without residuals and backward
     vs plain, f32: H256 at B32 x T2016 (an audio-encoder block in
     training), B32 x T252 (the self-motion and partner blocks), B16 x
     T2096 (the decode hoist, forward only) and B128 x T252 (the yaml's
     own batch, past one wave of 16-CTA clusters: 8-CTA clusters), and
     H128 at B32 x T252: ys, h_n <= 1e-4 abs; each gradient max|kernel -
     plain| / max|plain| <= 1e-3; two calls of each kernel on the same
     inputs give the same bits; microseconds per chain step; the bounds
     with the products in 3xTF32 (as the kernels run them) beside their
     FP32 figures; cuDNN's ``torch.nn.GRU`` with the same recurrent
     weights timed as a yardstick (it also computes the input product; at
     the decode hoist its forward alone, without a gradient);
 15. GRU generation: ``generate_metaformer`` with the GRU config, full
     mask, bf16 caches, on 1 batch of 16 x 250 frames (lead 12; cut from
     3 for room, the same draws): shape, finite, launches per generation
     (K10 forward +10, the hoisted encoders; nothing else: the fused
     rollout's gate needs an LSTM main modality, so the rollout runs step
     by step), time (no profile); then a teacher-forced f32 generation at
     batch 2 x 125 frames vs CPU tensors: <= 1e-4;
 16. GRU training step, B32 x T240 (lead 12), f32, AdamW lr 1e-4, decay
     1e-2: as phase 8, with launches per step K10 +15 / +15, K5 +10, K6
     +10, per eval step K10 forward +15 and K5 +10, the profiler table in
     ``_build/profile_gru_train_step.txt``;
 17. GRU training CLI: ``configs/lstmformer_gru.yaml`` at ``batch_size=32``
     on phase 9's corpus, an epoch (no resumed epoch: phase 17b resumes
     the same CLI in bf16), the checks of phase 9, and exact
     K10, K5 and K6 launches (per train step K10 +15 /
     +15, K5 +10, K6 +10; per validation batch an eval step, K10 forward
     +15 and K5 +10, and a generation, K10 forward +10);
17b. phase 17 with ``trainer.precision=bf16``, an epoch and a resumed
     epoch: per train step K10's bf16
     mode +15 / +15, K5 +2 and K6 +2 in bf16 (block 0's integrators) and
     +8 / +8 in f32 (the later blocks' f32 queries), no f32 K10 training
     launch; per validation batch in f32, as phase 17; the ``last``
     checkpoint's parameters and optimizer state all f32;
 18. LSTM recurrence over precomputed inputs (K8) forward with and without
     residuals and backward vs plain, f32: B256 x T120 x H128 (a
     simple_lstm acoustic direction), B32 x T252 x H256 (the flagship's
     self-motion LSTMs under ``MRGEN_FUSED_DW=0``), B20 x T37 x H128 and
     B1 x T120 x H128 (a frame of the ``MRGEN_FUSED_DW=0`` simple_lstm
     rollout): ys, h_n, c_n <= 1e-4 abs; each gradient max|kernel -
     plain| / max|plain| <= 1e-3; two calls of each kernel on the same
     inputs give the same bits; per case the cluster size, us per chain
     step and the 3xTF32 bound beside the FP32 one; cuDNN's
     ``torch.nn.LSTM`` with the same recurrent weights timed as a
     yardstick (it also computes the input product);
     then a bidirectional ``TorchLSTM`` at simple_lstm's acoustic shape
     (B256 x T120, 256 -> 128: K7 on the input and on the flipped input)
     vs the plain recurrences, the same bounds, K7 +2 / +2; and the
     routing case: ``TorchLSTM(81, 128)`` over T120 launches K8 once and
     no K7;
 19. simple_lstm generation: ``sliding_window_generate`` on one rollout of
     250 frames (batch 1, one model call per frame): shape, finite,
     launches per rollout (K7 forward +4 per step, +1,000; nothing else),
     ms per rollout; a 25-frame rollout under ``MRGEN_FUSED_DW=0`` (K8
     forward +4 per step, no K7); then an 8-step f32 rollout vs CPU
     tensors: <= 1e-4;
 20. simple_lstm training step at the yaml's batch, B256 windows (context
     15, audio T120, one target frame), AdamW with the yaml's optim group:
     as phase 8, with launches per step K7 +4 / +4, per eval step K7
     forward +4 (no profile since PR 26: cut for room); then, for
     simple_lstm and
     for the flagship Metaformer, one step with ``MRGEN_FUSED_DW=0``
     (simple_lstm K8 +4 / +4, the flagship K8 +5 / +5, K7 +0, the other
     kernels as in phase 8) and one with the default, on a batch from
     the phase's own generator (``SEED + 20``; simple_lstm's B64 since
     PR 26, cut from B256 for room,
     the flagship's phase 8's B2 x T48): each step's loss and
     gradients within phase 8's bounds of the plain FP32 step's (the same
     weights and batch on CPU tensors); the two card steps' distance from
     each other printed as a reading; then the flagship's and
     lstm_with_sampling's bf16 steps with ``MRGEN_FUSED_DW=0`` on a B2 x
     T48 batch of the same generator (the flagship K8's bf16 mode +5 / +5
     and no K7, the rest as phase 31; lws K8's bf16 mode +2 / +2 and K9's
     +1 / +1), each held card against CPU tensors as phase 31 holds the
     flagship's (the loss and the largest errors; the mean error within
     the model's own bound, ``BF16_STEP_MEAN_TOL`` and
     ``BF16_LWS_STEP_MEAN_TOL``, the CPU's f32 step, the control, beyond
     it);
 21. simple_lstm training CLI: ``configs/simple_lstm.yaml`` and
     ``configs/simple_lstm_best.yaml`` as written (batch 256), passed by
     their paths, on a ``.head`` corpus this script writes (2 sessions x
     12 s), an epoch and a resumed epoch each: finite train
     and val
     losses, V top-k checkpoints and ``last``, exact K7 launches (per
     train step +4 / +4, per validation batch an eval step, +4 forward);
 22. decode layouts on the flagship (``decode_layouts_phase``), B16 x 16
     frames (cut from 32 for room), lead 12: teacher-forced f32
     per-block and in-loop shared against the hoisted K2 path (<= 1e-4),
     per-block int8 against bf16
     (<= 1e-1, tests/test_generate.py's bound), per-block f32 at batch 2
     against CPU tensors (<= 1e-4); the per-block bf16 and int8, in-loop
     bf16 and hoisted bf16 generations timed with the full mask, and a
     ``repeat_with_encoder`` and an mha-embedding flagship (finite,
     timed); launches per generation exact (K1 +1, K2 +0 in the loop;
     K1 +5 with repeat_with_encoder; none with mha embeddings; K1 +2, K2
     +1 hoisted);
 23. a flagship ``StreamingSession`` (``streaming_phase``), batch 1, bf16
     rings: ``prime`` on 12 lead frames (K1 +1), 125 steps of random
     audio (10 s) with no launch, per-step ms p50/p95/p99 beside the 80
     ms hop; the streamed fbank against the offline fbank of the whole
     signal (bits, or within 1e-6 of its largest magnitude); 4 steps
     against CPU tensors (<= 5e-2);
 24. a flagship ``ServingEngine`` (``serving_phase``), bf16 shared
     layout, at 16 and 64 slots, 100 steps: slot s attaches at step 2s,
     two sessions detach and reattach halfway; K1 +1 per attach, none
     per step; step ms p50/p95/p99, attach ms, the pool sizes within the
     hop at p95; slot isolation (bits, or <= 1e-6), a slot against a
     batch-1 session with f32 rings (<= 1e-4), int8 against bf16 (<=
     1e-1);
 25. the flagship's scheduled-sampling step (``scheduled_sampling_phase``:
     the loss on the AR rollout, gradients through its ``SS_FRAMES``
     steps, f32 per-block rings), B8 x T60 + lead 12 (the yaml's T240
     cut for room), rate 0.5, AdamW: ms a step,
     peak memory, launches exact (K3 +1 / K4 +1 over the lead's audio,
     nothing else); the card against CPU tensors at B2, the all-False
     mask over T24 and rate 1 over 8 steps: loss <= 1e-5 relative,
     gradients <= 1e-3 of the largest;
 26. the same for lstm_with_sampling at B32 x T128 (K9 +1 / +1);
 27. dropout steps (``dropout_phase``): the flagship at ``dropout`` 0.1,
     B32 x T240, and lws at ``sampler_dropout_rate`` and ``dropout_rate``
     0.1, B256 x T128: launches exact (the flagship K7 +15 / +15, K5 +10,
     K6 +10; lws K7 +4 / +4; no K3, K4 or K9 in training; the eval steps'
     as phases 8 and 12), ms a step; two kernel-route steps from one seed
     bit-equal, and the plain route on the card from the same seed (the
     same masks): loss <= 1e-5 relative, gradients <= 1e-3;
 28. the flagship step at B32 x T240 with ``remat=True``
     (``remat_accumulation_phase``): loss and gradients bit-equal to the
     plain step, launches exact (every forward kernel twice), ms and peak
     memory of both; AdamW with ``accumulate_grad_batches=2`` over two
     micro-batches against one update on their mean gradient: <= 1e-6 of
     each parameter's largest magnitude;
 29. the bf16 modes of K7 and K9 (``bf16_kernel_phase``, own generator
     ``SEED + 29``): K7 at B256 x T140, 256 -> 256 and K9 at H128 x L2,
     B256 x T1120 (lstm_with_sampling's blocks and sampler in training),
     each also at T16 (K9: T32), and K7 at the flagship's B32 x T252 x
     256; bf16 x and weights (K9: bf16 weights), f32 biases and states:
     forward with and without residuals and backward vs the plain bf16
     versions within ``BF16_SHORT_TOL`` at the short T and
     ``BF16_FULL_TOL`` at full length, each gradient in its input's dtype,
     and the kernel's ys nearer the plain bf16 version's than the plain
     f32 version's (``bf16_check``); the bf16 kernels and the f32 kernels
     on the same values timed in turns, the plain bf16 versions and
     cuDNN's ``torch.nn.LSTM`` in bf16 as the yardstick; then the
     flagship's bf16 modes the same way: the encoder stack (K3 then K4,
     bf16 W_ih, W_hh and W_ff) at B32 x H256 x L5 over T2016 and T252
     (``BF16_FULL_TOL`` and the distance test over the first 4 steps)
     and at L2 x T16 (``BF16_STACK_SHORT_TOL`` and the distance test),
     and rect attention (K5 then K6, bf16 q, k, v) at B32
     x 252 x {2016, 252} x 4 heads (``BF16_ATTN_TOL`` and the distance
     test), with SDPA in bf16 as its yardstick;
29b. the bf16 modes of K10 and K8 (``bf16_recurrence_phase``, phase 29's
     generator): K10 at H256 over B32 x T2016, B32 x T252 and B128 x T252
     (the GRU yaml's batch; each mode's cluster size from its own
     residency), K8 at B256 x T120 x H128 and B32 x T252 x H256, each also
     at T16; bf16 W_hh, f32 xw, biases and states: forward with and
     without residuals and backward vs the plain bf16 versions within
     ``BF16_SHORT_TOL`` at T16 and ``BF16_FULL_TOL`` at full length,
     dW_hh bf16, the kernel's ys nearer the plain bf16 version's than the
     plain f32 version's (``bf16_check``; at full length over the first
     ``BF16_RECURRENCE_MODE_STEPS`` steps), two calls on the same inputs
     the same bits; the bf16 kernels and the f32 kernels on the same
     values timed in turns, the plain bf16 versions and cuDNN's
     ``nn.GRU`` / ``nn.LSTM`` in bf16 as the yardstick;
 30. lstm_with_sampling's bf16 training step (``bf16_step_phase``, own
     generator ``SEED + 30``) as phase 12 (B256 x T128, AdamW; no
     profile since PR 26, cut for room): per
     step the bf16 modes, K9 +1 / +1 and K7 +2 / +2; the eval step in
     f32, K9 +1 and K7 forward +2; the card's bf16 SGD step against the
     same bf16 step on CPU tensors within ``BF16_CARD_CPU_TOL``; then,
     from one model's weights on one batch, the bf16 step's loss within
     ``BF16_LOSS_REL_TOL`` of the f32 step's, the parameters f32 after
     both; ms a step and peak memory beside phase 12's;
 31. the flagship's bf16 training step (own generator ``SEED + 31``) as
     phase 8 runs the f32 one (B32 x T240, AdamW, the profiler table in
     ``_build/profile_bf16_train_step.txt``): per step the bf16 modes, K3
     +2, K4 +2, K7 +5 / +5, K5 +2, K6 +2, and K5's and K6's f32 mode +8
     each; the eval step in f32 as phase 8's; the card's bf16 SGD step at
     B2 x T48 against the same step on CPU tensors within
     ``BF16_FLAGSHIP_CARD_CPU_TOL`` (each gradient's scale floored at 1e-2
     of the largest gradient of all: the k projections' biases, zero in
     exact arithmetic, carry bf16 rounding noise), and its gradients on
     average within ``BF16_STEP_MEAN_TOL`` of the CPU's bf16 step's, where
     the CPU's f32 step, the control, must lie beyond it; the bf16 step's
     loss within
     ``BF16_LOSS_REL_TOL`` of the f32 step's from one model's weights on
     one batch; ms a step and peak memory beside phase 8's;
 32. the GRU Metaformer's bf16 training step (own generator ``SEED +
     32``) as phase 16 runs the f32 one (B32 x T240, AdamW; no profile
     since PR 26, cut for room): per step K10's
     bf16 mode +15 / +15, K5 +2 / K6 +2 in bf16 and +8 / +8 in f32; the
     eval step in f32 as phase 16's; the card's bf16 SGD step at B2 x T48
     against the same step on CPU tensors within phase 31's bounds on
     the loss and the largest errors, and on average within
     ``BF16_GRU_STEP_MEAN_TOL``, the CPU's f32 step, the control, beyond
     it;
     the loss within ``BF16_LOSS_REL_TOL`` of the f32 step's; ms a step
     and peak memory beside phase 16's;
 33. K1's bf16 mode (``bf16_inference_phase``, own generator ``SEED +
     33``) against its plain bf16 version at B16 x L5 x T2096 and L2 x
     T16 (as K3's bf16 mode), the training forward's bits, beside the f32
     kernel on the same values in turns; the flagship's forward without
     gradient on bf16 parameters and inputs at B16 x 250, the counts set
     to 0 before it: K1 bf16 +2, K7 bf16 +5, K5 bf16 +2 and f32 +8; at B2
     x 48 against CPU tensors within ``BF16_FWD_TOL`` and on average
     within ``BF16_MODE_FRAC`` of the CPU's f32 forward's distance;
     ``generate_metaformer`` on the bf16 parameters (K1 bf16 +2, K2 +1 a
     generation), teacher-forced at batch 2 within ``K2_BF16_TOL`` of CPU
     tensors;
 34. ``generate_metaformer(fused_rollout="auto")`` at hidden 128 with 4
     heads and at hidden 256 with 8 heads (``rollout_route_phase``, own
     generator ``SEED + 34``): K1 +2, K2 +0, teacher-forced f32 at batch 2
     x 125 frames (cut from 250 for room) within ``PATH_TOL`` of CPU tensors;
     ``fused_rollout=True`` raises;
 35. data parallel (``mesh_phases``, fresh worker processes of
     ``parallel/multihost_dryrun.py``, launched once with phase 39's): a
     world-size-1 NCCL DDP step against the plain step within
     ``DP_ONE_TOL``; two gloo ranks on the one card, every step path and
     a one-epoch ``Trainer.fit`` against one process within
     ``DP_LOSS_TOL`` / ``DP_PARAM_TOL``;
 36. K9's layer route (``stacked_layers_phase``, own generator ``SEED +
     36``: the stacks the wavefront cannot hold, a layer-lagged window
     schedule of K8's chains with the input products and weight
     gradients on the tensor-core GEMMs) at H256 x L2, B32 x T2016 and
     T252 (forward with and without residuals, backward; ms by window
     length; the chosen window against C = T in turns, the same bits)
     and B16 x T2096 (forward without a gradient) vs plain within phase
     10's bounds, cuDNN's 2-layer LSTM the yardstick, CTAs per cluster
     printed; its bf16 mode at B32 x T2016 (``bf16_case``) beside the
     f32 route in turns;
 37. the flagship under the mixer settings no shipped yaml uses
     (``mixer_kinds_phase``, own generator ``SEED + 37``):
     ``num_internal_layer`` 2 (K9's layer route +15 / +15 a step), GRU
     mixers at 2 inner layers (K10 +30 / +30), ``emb_mixers`` [mlp, mlp,
     lstm] (K7 +5 / +5, K2 +1 a generation) and [lstm, lstm, mlp] (K3 +2
     / K4 +2, the rollout's module loop); K5 / K6 +10 a step per inner
     layer (the integrators' MHA layers): five
     timed steps, the eval step and the card against CPU tensors at B2 x
     T48 as phase 8 (no profile), one generation each (B16 x 125, bf16
     caches, counts from 0; cut from 250 for room), and the 2-inner-layer
     model's bf16 step
     (K9's bf16 mode +15 / +15) held to the CPU as phase 31.
 38. the offline corpus pipeline (``corpus_pipeline_phase``, own
     generator ``SEED + 38``; no kernel): ``ops/xcorr.py align_shift`` on
     a 540 s session (a mix and two channels with planted shifts): the
     card's lags equal the planted ones and the CPU's;
     ``landmarks_to_pose`` over 13,500 frames of 478 landmarks in one
     call and in chunks of 256, card against CPU within
     ``POSE_TOL``; ``ops/dsp_reference.py compute_fbank`` over the 540 s
     channel, card against CPU within ``FBANK_REF_TOL``; then the corpus
     CLIs on a raw corpus the phase writes (``RAW_SESSIONS`` x
     ``RAW_SECONDS``: comp, host and mix wavs with planted shifts and a
     side-by-side array movie; a synthetic landmarker and an array
     trimmer stand in for mediapipe and ffmpeg): ``corpus.alignment``
     (the planted shifts back), ``corpus.landmarks`` (every frame a
     ``.head``, statistics stamped), ``corpus.extract_angle_cent`` (the
     ``.npz`` sections the planted detection gaps imply), the port's
     ``databuild_nx`` manifests and one loader batch (its audio through
     ``utils/native_io.py read_batch``), finite; ms a call and s a stage;
 39. the (data, model) mesh (``mesh_phases``, generator ``SEED + 39``;
     run with phase 35, in the same two launches: the single process's,
     then two gloo ranks on CUDA tensors of the one card): (a) a (1, 2)
     mesh, the flagship's parameters and AdamW state sharded by JAX's
     ``param_sharding``, 3 f32 steps at B32 x T240 against one process
     (loss within ``LOSS_REL_TOL``, parameters within ``DP_PARAM_TOL``,
     the ranks' gathered parameters the same bits, each rank storing half
     of the split parameters and of their AdamW state, per rank exactly
     phase 8's launches a step), the second step's ms per rank beside one
     process's; one bf16 step against one process's within
     ``DP_LOSS_TOL`` / ``DP_PARAM_TOL``, per rank phase 31's launches;
     (b) a one-epoch (1, 2) ``Trainer.fit`` of the dryrun's model against
     one process within ``DP_LOSS_TOL``, rank 0 alone writing, its
     ``last`` loading ``strict=True`` into one process's model equal to
     the ranks' gathered parameters; (c) a 16-slot ``ServingEngine``
     split over the two ranks: f32 rings, 4 steps with staggered
     attaches, against this process's 16-slot engine within
     ``PATH_TOL``; 15 slots raise; bf16 rings, ``SERVE_STEPS`` steps
     (attaches and a detach / reattach as phase 24's), step ms
     p50/p95/p99 per rank beside phase 24's pool; per rank K1 +1 per
     attach it owns, nothing per step. Two ranks on one card say nothing
     of scaling over cards;
 40. every head count and hidden size up to 256 (``shape_phases``,
     generator ``SEED + 40``): (a) each new shape against its plain
     version on the card in f32 and bf16 (``kernel_shapes_phase``: f32
     forward <= 1e-4 abs and gradients <= 1e-3 of the largest, bf16
     within ``BF16_ATTN_TOL`` / ``BF16_FULL_TOL`` and the distance test),
     launches exact, timed beside the plain version, SDPA or cuDNN in the
     same dtype, with the bounds at the real and at the padded width:
     K5/K6 at B32 x 252 x 2016 with head dims 16, 48 (on the 64 tile), 128
     and 256; K10 and K8 at B32 x T252 x H 64, 192 and 100 (on 128); K10 at
     B32 x T2016 x H192; K9's layer route at B256 x T1120 x H192 x L2; (b)
     at full width, through the step functions (``train_path_phase``:
     ``SHAPE_STEPS`` f32 steps, eval, one SGD step card against CPU at B2 x
     T48, launches exact) the GRU Metaformer at hidden 192 and 4 heads (K10
     +15 / +15 at H192, K5/K6 +10 / +10 at head dim 48; one bf16 step with
     phase 32's gates), lstm_with_sampling at hidden 192 and sampler 192
     (B256 x T128: K8 +2 / +2 at H192, K9's layer route +1 / +1; one bf16
     step with phase 20's gates of that route), the flagship at 2 heads
     (head dim 128; one bf16 step with phase 31's gates) and 1 head (256);
     (c) one generation of the GRU Metaformer (K10 +10) and of
     lstm_with_sampling (the layer route +1) at those widths, each with
     its teacher-forced card-against-CPU check;
 41. the encoder stack at every hidden size to 512 and K7 at 384 and 512
     (``stack_shape_phases``, generators ``SEED + 41``): (a) K1 (no
     gradient), K3 and K4 through ``mixer_stack_recurrence`` at B32 x L5 x
     T252 and H 100 (run padded to 128), 192 (8-CTA clusters), 384 and 512
     (16-CTA clusters; FP32 at 512 reads part of W_hh from L2), f32 and
     bf16, against the plain version at the real width (f32 within
     ``K1_TOL`` forward and ``GRAD_REL_TOL`` gradients; bf16 within
     ``BF16_FULL_TOL`` and the distance test over the first
     ``BF16_MODE_STEPS`` steps, within ``BF16_WIDE_MODE_FRAC`` past H
     256), K1's outputs the training forward's bits, launches exact; K7 at B32 x T252 x H 384 and 512 (din = H) the
     same way (the distance test over ``BF16_RECURRENCE_MODE_STEPS``
     steps) beside cuDNN's ``nn.LSTM`` in the same dtype; timed beside the
     plain versions, with the bounds at the real and at the run width,
     the layout (CTAs a cluster, rows or gate columns of W_hh a CTA keeps
     in shared memory, residency); (b) the flagship at hidden 192 and
     512 through the step functions: ``SHAPE_STEPS`` f32 steps at B32 x
     T240 (K3 +2 / K4 +2; K8 at 192, K7 at 512, +5 / +5; K5 / K6 +10 /
     +10), eval, the card against CPU tensors at B2 x T48 within phase
     8's bounds; one bf16 step each, timed, launches exact; (c) one
     generation of the flagship at hidden 192 (B16 x 250, K1 +2, the
     module loop: K2's contract is hidden 256) with its teacher-forced
     card-against-CPU check; (d) the flagship's forward without gradient
     on bf16 parameters and inputs at hidden 192 and 512 (B16 x 250, the
     counts read just before and after it: K1 bf16 +2; K8 bf16 at 192, K7
     bf16 at 512, +5; K5 bf16 +2 and f32 +8), timed, and at B2 x 48
     against CPU tensors as phase 33's (``bf16_forward_check``);

Every kernel's JSON record carries its bound: the larger of its
operations (FP32 at 67 TFLOP/s; the 3xTF32 products of K5's forward,
K6, K4's and K7's and K9's backward, and all of K8's and K10's, as three
TF32 passes at 495; the bf16 modes' products, those of K3/K4, K5/K6, K7
to K10, as bf16 at 989) and its
bytes at 3.35 TB/s (H100 SXM, 700 W).
Any failure raises. The last lines are the kernels' JSON record, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
Run from the repository root: ``python3 chip_smoke.py``.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

B, FRAMES, LEAD, RATIO = 16, 250, 12, 8
AUDIO_DIM, MOTION_DIM = 81, 18
SEED = 0
K1_TOL, K2_F32_TOL, K2_BF16_TOL, PATH_TOL = 1e-4, 1e-4, 5e-2, 1e-4
FWD_TOL, GRAD_REL_TOL, LOSS_REL_TOL = 1e-4, 1e-3, 1e-5
TRAIN_B, TRAIN_FRAMES, TRAIN_STEPS = 32, 240, 5
YAML_B = 128  # the batch_size of configs/lstmformer_gru.yaml
LWS_B, LWS_FRAMES = 256, 128  # configs/lstm_with_sampling.yaml's batch
# configs/simple_lstm.yaml's batch, audio window (15 x 100 / 12.5) and
# motion context
SIMPLE_B, SIMPLE_AUDIO_T, SIMPLE_CONTEXT = 256, 120, 15
SIMPLE_DW0_B = 64  # phase 20's simple_lstm batch (cut for room)
CORPUS_SESSIONS, CORPUS_SECONDS = 4, 540.0
# simple_lstm's corpus: its loader reads 20 pickles and computes a
# 120-frame fbank per window on the host (~9 ms a window on an H100
# machine's host CPU), so it is sized for phase 21 to take about half a
# minute; simple_lstm's timed rollouts (phase 19, host-bound)
V1_SESSIONS, V1_SECONDS = 2, 12.0
SIMPLE_ROLLOUTS = 1
# the encoder stack's chunk sweeps: audio and motion lengths
SWEEP_LONG, SWEEP_SHORT = (16, 32, 64, 128), (16, 32, 64)
DW0_FRAMES = 25  # the MRGEN_FUSED_DW=0 rollout
# comparison frames the eval CLI phases render per segment (every segment
# also gets its pose strips and nod plot)
EVAL_RENDER_FRAMES = 2
# the live-serving phases: generation length of the decode layouts, the
# streamed steps (10 s of dialogue), the serving steps and pool sizes,
# the 80 ms hop a step must keep up with, and the int8 drift bound of
# tests/test_generate.py
# phase 22's layouts at 16 frames (cut from 32 for room)
LAYOUT_FRAMES, STREAM_STEPS, SERVE_STEPS = 16, 125, 100
SERVE_SLOTS, HOP_MS, INT8_TOL = (16, 64), 80.0, 1e-1
# the training options: the scheduled-sampling steps (the flagship's
# batch is sized by its f32 per-block rings, kept for backward at every
# step of the rollout: ~92 MB a step at B8; its rollout is cut from the
# yaml's 240 frames to 60 for room: a host-driven step a frame, ~27 s at
# 240, 17.3 s at 120), the dropout rate of the dropout steps, and the accumulation
# check's bound
SS_STEPS, SS_RATE, SS_B, SS_LWS_B, SS_FRAMES = 1, 0.5, 8, 32, 60
DROPOUT, ACCUM_REL_TOL = 0.1, 1e-6
# the bf16 modes of K7 and K9 against their plain bf16 versions (the two
# round h and the dgates at the same products but sum in other orders, so
# a value on a bf16 rounding boundary may round the other way): at T16
# forward 1e-3 abs, the f32 gradients 2e-3 and the bf16 ones 1e-2 of
# their largest magnitude (a bf16 ulp is 2^-8 to 2^-7 of a value); over
# the full length the JAX bf16 bound (tests/test_pallas_lstm.py:130): 5e-2
# abs on outputs and states, 5e-2 of their largest magnitude on every
# gradient (sums over 10^4 to 10^5 rows: a dW of 200 has a bf16 ulp of
# 1); and the kernel's ys on average within a quarter of the plain f32
# version's distance from the plain bf16 one (the flips are too rare to
# move the mean). The bf16 step's loss within 1e-2 of the f32 step's
# (outputs rounded to bf16, 2^-9 relative each); the bf16 step on the card
# against CPU tensors: loss 1e-3 relative, gradients 3e-2 of their
# largest magnitude (bf16 gradients, a few ulps)
BF16_SHORT_T = 16
BF16_SHORT_TOL, BF16_FULL_TOL, BF16_MODE_FRAC = (1e-3, 2e-3, 1e-2), (
    5e-2, 5e-2, 5e-2), 0.25
BF16_LOSS_REL_TOL, BF16_CARD_CPU_TOL = 1e-2, (1e-3, 3e-2)
# rect attention's bf16 mode against its plain bf16 version: the context
# 1e-2 abs (a normalized weight on a bf16 rounding boundary rounds the
# other way in one of them: 2^-8 of a weight up to 1 times a value up to
# ~5), the bf16 gradients 1e-2 of their largest (an ulp or two); the
# encoder stack's bf16 mode over L5 at T252 and T2016 decorrelates from
# its plain bf16 version as fast as from a 1e-7 perturbation of its own
# input (its LayerNorms and chains amplify a rounding flip), so at the
# full lengths the kernel-vs-f32 distance test (``BF16_MODE_FRAC``) reads
# the first ``BF16_MODE_STEPS`` steps, before flips compound through the
# five layers (there two faithful bf16 stacks, the port's plain version
# and JAX's, differ by 0.02-0.07 of the plain f32 version's distance, and
# a one-ulp input perturbation moves the plain version up to 0.14 of it;
# over 16 steps up to 0.26 and 0.21: tests/
# test_torch_port_bf16_flagship.py), and the whole lengths hold to
# ``BF16_FULL_TOL``
BF16_ATTN_TOL = (1e-2, 1e-2, 1e-2)
# at the short stack a block input or an h on a rounding boundary moves
# the LayerNormed rows after it by up to ~5e-3 (4.9e-3 at B32): its
# forward bound is 1e-2 abs
BF16_MODE_STEPS = 4
BF16_STACK_SHORT = (2, BF16_SHORT_T)  # layers, steps
BF16_STACK_SHORT_TOL = (1e-2, *BF16_SHORT_TOL[1:])
# the flagship's bf16 SGD step on the card against the same step on CPU
# tensors (B2 x T48), from the models and batches of four seeds
# (tools/bf16_phases.py cardcpu): a gradient's largest error reads 3.1e-2
# to 1.5e-1 of its largest magnitude (one input element moved by a bf16
# ulp moves the CPU's own step by up to 4.6e-2: its encoder stacks and
# LayerNorms amplify a rounding flip), as far as the CPU's f32 step reads
# (1.1e-1 to 2.0e-1), so that bound (2e-1) only catches a broken step;
# the mean over the parameters of each gradient's mean error separates
# them, so it holds to a bound of each model's own, between its sound
# steps' largest and its control's (the CPU's f32 step's) least reading,
# and the control must read beyond it; the loss to 1e-3 relative.
# cuBLAS's bf16 partial sums in bf16 or in f32 gave the same bits there
BF16_FLAGSHIP_CARD_CPU_TOL = (1e-3, 2e-1)
# the flagship: 8.4e-3 to 1.6e-2 over four seeds (phase 31), 1.8e-2 under
# MRGEN_FUSED_DW=0 and 2.2e-2 on its default route at phase 20's batch;
# the control 3.7e-2 to 4.8e-2 (tools/bf16_phases.py cardcpu, cardcpu_p20)
BF16_STEP_MEAN_TOL = 2.5e-2
# the GRU Metaformer (phase 32): 1.40e-2 to 2.45e-2 over four seeds, the
# control 3.99e-2 to 5.34e-2 (cardcpu_gru)
BF16_GRU_STEP_MEAN_TOL = 3.1e-2
# lstm_with_sampling under MRGEN_FUSED_DW=0 (phase 20): 7.0e-3 at phase
# 20's batch, 1.5e-3 to 2.2e-3 at four others; the control 2.69e-2 to
# 2.80e-2 at phase 20's batch, 1.24e-2 to 3.80e-2 at the others
# (cardcpu_p20, cardcpu_lws0)
BF16_LWS_STEP_MEAN_TOL = 1e-2
# the bf16 modes of K10 and K8 over their full lengths: a rounding flip
# compounds along the chain, so a one-f32-ulp move of the input moves the
# plain bf16 version itself 0.28-0.51 of the plain f32 version's distance
# over 252 to 2016 steps, but 0.004-0.022 over the first 16
# (tools/bf16_chaos_probe.py; held on the CPU in
# tests/test_torch_port_bf16_recurrence.py): the distance test reads the
# first 16 steps there
BF16_RECURRENCE_MODE_STEPS = 16
# K1's bf16 mode (phase 33) against its plain bf16 version: as K3's
# (``bf16_stack_case``); the flagship's bf16 forward without gradient on
# the card against the same on CPU tensors: within JAX's bf16 output bound
# (5e-2, tests/test_pallas_lstm.py) and on average within
# ``BF16_MODE_FRAC`` of the CPU's f32 forward's distance from its bf16 one
# (read 4.2e-3 and 0.121 at B2 x 48); its bf16-parameter generation
# (teacher-forced, f32 rings) within the JAX package's bf16 drift bound
# ``K2_BF16_TOL`` (read 1.6e-3)
BF16_FWD_TOL = 5e-2
BF16_FWD_BATCH, BF16_FWD_FRAMES = 2, 48
# phase 34: the rollout configs outside K2's shape contract
ROUTE_CONFIGS = {"hidden128_heads4": dict(hidden_size=128),
                 "hidden256_heads8": dict(num_heads=8)}
# the host-driven generations of phases 34 and 37 and the teacher-forced
# card-against-CPU generations of phases 11 and 15, cut from 250 frames to
# 125 for room (their draws unchanged: the batches are cut)
LOOP_FRAMES = 125
# phase 35: data parallel, the dryrun's Metaformer at the flagship's width
# (hidden 256, 2 blocks, 2-block encoders, B8 x T8); the ranks' global
# losses against one process within 1e-4, and their parameters after two
# SGD steps within ``DP_PARAM_TOL`` of its, relative to each tensor's
# largest (the rows split 4 + 4 changes the sums of the weight gradients'
# reductions; bf16 rounds each rank's dW: read 2.6e-5 and 4.0e-6, f32
# 6e-8); the world-size-1 NCCL DDP step within ``DP_ONE_TOL`` of the plain
# step (loss and parameters; read 0)
DP_HIDDEN, DP_LOSS_TOL, DP_PARAM_TOL, DP_ONE_TOL = 256, 1e-4, 1e-4, 1e-6
# phase 38: the offline corpus pipeline. The card against the CPU: the
# head pose's angles within 1e-3 degrees and centroids within 1e-5; the
# Kaldi log-mel and log power within 1e-3 (the JAX package's bounds,
# tests/test_dsp_reference.py). The raw corpus: sessions of 60 s, 16 kHz,
# a 25 fps side-by-side movie of 8 x 16 frames; the alignment's full
# session is the corpus sessions' 540 s
POSE_TOL, FBANK_REF_TOL = (1e-3, 1e-5), (1e-3, 1e-3)
RAW_SESSIONS, RAW_SECONDS, RAW_FRAME = 2, 60.0, (8, 16)
# phase 40: the (E, heads) of K5/K6's new head dims (16, 48, 128, 256),
# the hidden sizes of K8's and K10's (64, 192, and 100 run padded to
# 128), and the f32 steps of each configuration (cut from 5 for room)
SHAPE_HEADS = ((256, 16), (192, 4), (256, 2), (256, 1))
SHAPE_HIDDEN = (64, 192, 100)
SHAPE_STEPS = 2
# phase 41: the encoder stack's new widths (100 runs padded to 128, 192
# on 8-CTA clusters, 384 and 512 on 16-CTA ones). The bf16 stack's
# distance test reads the first BF16_MODE_STEPS steps at every width,
# within BF16_WIDE_MODE_FRAC past H 256: at B32 x L5 x T252 the kernels
# read 0.02, 0.06, 0.21 and 0.32 of the f32 distance there (H 100 to
# 512; two faithful plain bf16 stacks, one with its sums in f64, part by
# 0.15-0.16 at 384 and 512), and the f32 kernel in the bf16 mode's place
# reads about 1 (tools/bf16_sum_order_probe.py --card)
STACK_SHAPE_HIDDEN = (100, 192, 384, 512)
BF16_WIDE_MODE_FRAC = 0.5
LIBS = ("mixer_stack", "decode_rollout", "lstm_layer", "rect_attention",
        "lstm_stacked", "gru", "lstm_recurrence", "attention_bf16")
SRC = "multimodalreactiongeneration_tpu_torch/csrc/"
JAX_OPS = "multimodalreactiongeneration_tpu/ops/"


_START = time.perf_counter()


def log(phase, **kv):
    """One line of a phase's readings, ending in the script's elapsed
    seconds (``at_s``), which say what each phase cost."""
    kv["at_s"] = f"{time.perf_counter() - _START:.1f}"
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def make_batch(rng, batch, frames=FRAMES, lead=LEAD):
    shapes = [
        (batch, frames * RATIO, AUDIO_DIM), (batch, frames, MOTION_DIM),
        (batch, frames, MOTION_DIM), (batch, lead * RATIO, AUDIO_DIM),
        (batch, lead, MOTION_DIM), (batch, lead, MOTION_DIM),
        (batch, frames, MOTION_DIM),
    ]
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes]


def first_frames(batch, frames):
    """A ``make_batch`` batch cut to its first ``frames`` frames (the
    lead kept): a shorter generation from the same draws."""
    cut = (frames * RATIO, frames, frames, None, None, None, frames)
    return [x if n is None else x[:, :n] for x, n in zip(batch, cut)]


def cuda_ms(fn, reps):
    """Mean milliseconds per call by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def plain_time(fn):
    """(ms, output) of one call of a plain version, without a warm-up:
    the plain recurrences loop over their steps on the host, from tens of
    ms to seconds a call, so a warm-up call would only double their
    cost."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def max_err(a, b):
    return max(float((x.detach().float() - y.detach().float()).abs().max())
               for x, y in zip(a, b))


COUNTERS = {  # kernel name -> (module key, counter attribute)
    "mixer_stack": ("K1", "launches"),
    "decode_rollout": ("K2", "launches"),
    "mixer_stack_train_fwd": ("K1", "train_fwd_launches"),
    "mixer_stack_bwd": ("K1", "bwd_launches"),
    "lstm_layer_fwd": ("K7", "fwd_launches"),
    "lstm_layer_bwd": ("K7", "bwd_launches"),
    "rect_attention_fwd": ("K5", "fwd_launches"),
    "rect_attention_bwd": ("K5", "bwd_launches"),
    "lstm_stacked_fwd": ("K9", "fwd_launches"),
    "lstm_stacked_bwd": ("K9", "bwd_launches"),
    "gru_fwd": ("K10", "fwd_launches"),
    "gru_bwd": ("K10", "bwd_launches"),
    "lstm_recurrence_fwd": ("K8", "fwd_launches"),
    "lstm_recurrence_bwd": ("K8", "bwd_launches"),
    "lstm_layer_bf16_fwd": ("K7", "bf16_fwd_launches"),
    "lstm_layer_bf16_bwd": ("K7", "bf16_bwd_launches"),
    "lstm_stacked_bf16_fwd": ("K9", "bf16_fwd_launches"),
    "lstm_stacked_bf16_bwd": ("K9", "bf16_bwd_launches"),
    "mixer_stack_bf16_train_fwd": ("K1", "bf16_train_fwd_launches"),
    "mixer_stack_bf16_bwd": ("K1", "bf16_bwd_launches"),
    "rect_attention_bf16_fwd": ("K5", "bf16_fwd_launches"),
    "rect_attention_bf16_bwd": ("K5", "bf16_bwd_launches"),
    "gru_bf16_fwd": ("K10", "bf16_fwd_launches"),
    "gru_bf16_bwd": ("K10", "bf16_bwd_launches"),
    "lstm_recurrence_bf16_fwd": ("K8", "bf16_fwd_launches"),
    "lstm_recurrence_bf16_bwd": ("K8", "bf16_bwd_launches"),
    "mixer_stack_bf16": ("K1", "bf16_launches"),
    "lstm_stacked_layers_fwd": ("K9", "layers_fwd_launches"),
    "lstm_stacked_layers_bwd": ("K9", "layers_bwd_launches"),
    "lstm_stacked_layers_bf16_fwd": ("K9", "layers_bf16_fwd_launches"),
    "lstm_stacked_layers_bf16_bwd": ("K9", "layers_bf16_bwd_launches"),
}


def counts(mods):
    return {k: getattr(mods[m], a) for k, (m, a) in COUNTERS.items()}


def zero_counts(mods):
    for m, a in COUNTERS.values():
        setattr(mods[m], a, 0)


def check_launches(what, before, after, **want):
    """The launches between two reads of the counters must be exactly
    ``want`` (kernels not named: none)."""
    got = {k: after[k] - before[k] for k in COUNTERS}
    expected = {k: want.get(k, 0) for k in COUNTERS}
    if got != expected:
        raise AssertionError(f"{what}: launches {got}, want {expected}")
    return got


def seeded(rng, dev):
    def r(*shape, s=1.0, mean=0.0):
        x = mean + s * rng.standard_normal(shape)
        return torch.from_numpy(x.astype(np.float32)).to(dev)
    return r


def rel_err(got, want):
    return max(float((g - w).abs().max()) / float(w.abs().max())
               for g, w in zip(got, want))


def chunk_sweep(fn, t, chunks, reps=3):
    """ms of fn(chunk) at each chunk shorter than t and at t (CUDA
    events, mean of ``reps`` after a warm-up)."""
    return {c: cuda_ms(lambda: fn(c), reps)[0]
            for c in sorted({c for c in chunks if c < t} | {t})}


def in_turns(fn, a, b, reps=5):
    """ms of fn(a) and fn(b) in turns (a, b, b, a; CUDA events, mean of
    ``reps`` launches a turn after a warm-up): the mean of each and the
    turns."""
    turns = {a: [], b: []}
    for x in (a, b, b, a):
        turns[x].append(cuda_ms(lambda: fn(x), reps)[0])
    return {x: float(np.mean(v)) for x, v in turns.items()}, turns


def same_bits(xs, ys):
    return all(torch.equal(x, y) for x, y in zip(xs, ys))


@contextlib.contextmanager
def whole_sequence_chunks(K1):
    """Inside, the stack forwards and backward run at chunk = T (the
    layer-major schedule) wherever the caller names no chunk."""
    chosen = K1.chunk_steps, K1.backward_chunk_steps
    K1.chunk_steps = K1.backward_chunk_steps = lambda b, t, h, layers: t
    try:
        yield
    finally:
        K1.chunk_steps, K1.backward_chunk_steps = chosen


def schedule_ab(K1, run, reps):
    """Host-clock ms of ``run()`` to a synchronize with the stack's chunk
    schedule and at chunk = T, in turns (chunked, whole, whole, chunked),
    ``reps`` calls a turn after a warm-up, and the peak memory of each:
    (means, every time, peak GiB)."""
    times, peak = {"chunked": [], "whole": []}, {}
    for key in ("chunked", "whole", "whole", "chunked"):
        with (whole_sequence_chunks(K1) if key == "whole"
              else contextlib.nullcontext()):
            run()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(reps):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times[key].append((time.perf_counter() - t0) * 1000)
            peak[key] = max(peak.get(key, 0.0),
                            torch.cuda.max_memory_allocated() / 2**30)
    return {k: float(np.mean(v)) for k, v in times.items()}, times, peak


def window_overlap(events, kernel="lstm_window_kernel"):
    """From a profile's device events, the stack's recurrence windows
    (``kernel``: the forward's, or the backward's
    ``lstm_cluster_bwd_kernel``): grouped into stack calls where the
    device ran none of them for 0.5 ms, each call's window from its first
    start to its last end; the share of the windows in which two or more
    layers' recurrences ran at once, and in which at least one ran. A
    group of one launch is no stack call (K7 and K8 run the backward
    kernel over a whole sequence in one launch) and is left out."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if kernel in e.name)
    if not spans:
        return None
    calls, end = [], float("-inf")
    for a, b in spans:
        if a - end > 500:
            calls.append([])
        calls[-1].append((a, b))
        end = max(end, b)
    calls = [call for call in calls if len(call) > 1]
    if not calls:
        return None
    window = multi = single = 0.0
    for call in calls:
        window += max(b for _, b in call) - call[0][0]
        marks = sorted([(a, 1) for a, _ in call] + [(b, -1) for _, b in call])
        depth, last = 0, marks[0][0]
        for x, d in marks:
            if depth >= 2:
                multi += x - last
            if depth >= 1:
                single += x - last
            depth, last = depth + d, x
    return {"calls": len(calls), "window_ms": window / 1000,
            "multi_layer_share": multi / window,
            "recurrence_share": single / window}


# H100 SXM peaks (NVIDIA's data sheet, 700 W): FP32 outside the tensor
# cores, dense TF32 and bf16 on them, and HBM3
PEAK_FLOPS, PEAK_TF32, PEAK_BYTES = 67e12, 495e12, 3.35e12
PEAK_BF16 = 989e12


def nbytes(*objs):
    """Bytes of every tensor in ``objs`` (nested tuples, lists, dicts)."""
    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, dict):
            total += nbytes(*o.values())
        elif isinstance(o, (list, tuple)):
            total += nbytes(*o)
    return total


def bound(flops, bytes_, tf32x3_flops=0):
    """(ms, "operations" or "bytes"): the least time the card could take,
    the larger of the operations and the bytes (each input read once,
    each output written once) at 3.35 TB/s. The operations are FP32 at 67
    TFLOP/s, and ``tf32x3_flops`` products in 3xTF32 (three TF32 passes
    at 495 TFLOP/s each)."""
    t_ops = (flops / PEAK_FLOPS + 3 * tf32x3_flops / PEAK_TF32) * 1e3
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def matmul_flops(fn):
    """FLOPs of the matrix products ``fn`` runs (torch's flop counter)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def check_case(name, fwd_err, grad_rel, **kv):
    log(name, fwd_max_abs_err=f"{fwd_err:.3e}",
        grad_max_rel_err=f"{grad_rel:.3e}",
        **{k: f"{v:.3f}" if isinstance(v, float) else v
           for k, v in kv.items()})
    if not fwd_err <= FWD_TOL:
        raise AssertionError(f"{name} {kv}: forward {fwd_err} > {FWD_TOL}")
    if not grad_rel <= GRAD_REL_TOL:
        raise AssertionError(
            f"{name} {kv}: gradients {grad_rel} > {GRAD_REL_TOL}")


def train_kernel_phase(K1, dev, rng):
    """5. The encoder stack's training forward (K3) and backward (K4) vs
    their plain versions at B32 x H256 x L5, audio and motion lengths."""
    b, h, n = TRAIN_B, 256, 5
    r = seeded(rng, dev)
    cases = []
    for t in ((LEAD + TRAIN_FRAMES) * RATIO, LEAD + TRAIN_FRAMES):
        args = (r(b, t, h), r(n, h, 4 * h, s=0.06), r(n, 4 * h, s=0.06),
                r(n, h, 4 * h, s=0.06), r(n, h, h, s=0.06), r(n, h, s=0.1),
                r(n, h, s=0.1, mean=1.0), r(n, h, s=0.1),
                r(n, h, s=0.1, mean=1.0), r(n, h, s=0.1),
                r(n, b, h, s=0.3), r(n, b, h, s=0.3))
        cots = (r(b, t, h), r(n, b, h), r(n, b, h))
        # the wrapper as the model calls it: autograd runs K3, then K4
        leaves = [a.clone().requires_grad_() for a in args]
        y, (hn, cn) = K1.mixer_stack_recurrence(*leaves)
        grads = torch.autograd.grad((y, hn, cn), leaves, cots)
        with torch.no_grad():
            plain_fwd_ms, (yr, (hr, cr)) = plain_time(
                lambda: K1.mixer_stack_forward_reference(*args))
        plain_bwd_ms, want = plain_time(
            K1.mixer_stack_backward_reference(args, *cots, closure=True))
        fwd_err = max_err((y, hn, cn), (yr, hr, cr))
        grad_err = max_err(grads, want)
        grad_rel = rel_err(grads, want)
        # kernel times, each launch on its own: the chunk sweep, then the
        # chosen chunk and chunk = T in turns, and their bits
        chosen = K1.chunk_steps(b, t, h, n)

        def k3(chunk):
            return K1.mixer_stack_train_forward(*args, chunk=chunk)

        sweep = chunk_sweep(k3, t, SWEEP_LONG if t > 1000 else SWEEP_SHORT)
        log("mixer_stack_train_sweep", T=t,
            ms={c: round(v, 3) for c, v in sweep.items()})
        means, turns = in_turns(k3, chosen, t)
        fwd_ms, whole_ms = means[chosen], means[t]
        fwd_out = k3(chosen)
        # out, hn, cn and every residual plane
        whole = k3(t)
        bitwise = same_bits(fwd_out, whole)
        del whole
        res = fwd_out[3]

        # K4 the same way, and its bits: dx0, dh0, dc0 against chunk = T,
        # all twelve gradients run to run
        def k4(chunk):
            return K1.mixer_stack_backward(args, res, *cots, chunk=chunk)

        bwd_chosen = K1.backward_chunk_steps(b, t, h, n)
        bwd_sweep = chunk_sweep(k4, t,
                                SWEEP_LONG if t > 1000 else SWEEP_SHORT)
        log("mixer_stack_bwd_sweep", T=t,
            ms={c: round(v, 3) for c, v in bwd_sweep.items()})
        means, bwd_turns = in_turns(k4, bwd_chosen, t)
        bwd_ms, whole_bwd_ms = means[bwd_chosen], means[t]
        got, again, whole = k4(bwd_chosen), k4(bwd_chosen), k4(t)
        states = (0, 10, 11)  # dx0, dh0, dc0
        bwd_bitwise = same_bits([got[i] for i in states],
                                [whole[i] for i in states])
        bwd_repeat = same_bits(got, again)
        del got, again, whole
        ws_floats = K1._lib().mixer_stack_backward_workspace_floats
        ws_bytes = 4 * ws_floats(b, t, h, n, bwd_chosen)
        whole_ws_bytes = 4 * ws_floats(b, t, h, n, t)
        # the layer-major K4's workspace: B*T*8*H floats and the partials
        parent_ws_bytes = 4 * (b * t * 8 * h + (1 << 22) + (1 << 18))
        # matmul FLOPs per block: x.W_ih and h.W_hh (8 B T H^2 each), the
        # Dense (2 B T H^2); the backward doubles each product: the chain's
        # dgates.W_hh^T in FP32, dW_ih, dW_hh, dx (8 B T H^2 each), dW_ff and
        # dy (2 B T H^2 each) in 3xTF32
        fwd_bound = bound(18 * n * b * t * h * h, nbytes(args, fwd_out))
        bwd_bound = bound(8 * n * b * t * h * h,
                          nbytes(args, res, cots, grads),
                          tf32x3_flops=28 * n * b * t * h * h)
        del res, fwd_out
        rows, resident = K1.ROWS, K1.resident_clusters(h)
        check_case("mixer_stack_train", fwd_err, grad_rel, T=t,
                   fwd_ms=fwd_ms, whole_sequence_fwd_ms=whole_ms,
                   chunk=chosen, rows=rows, resident_clusters=resident,
                   clusters=n * -(-b // rows),
                   bitwise_equal_to_whole=bitwise,
                   plain_fwd_ms=plain_fwd_ms, bwd_ms=bwd_ms,
                   whole_sequence_bwd_ms=whole_bwd_ms, bwd_chunk=bwd_chosen,
                   bwd_states_bitwise_equal_to_whole=bwd_bitwise,
                   bwd_run_to_run_bitwise=bwd_repeat,
                   bwd_workspace_bytes=ws_bytes,
                   whole_sequence_bwd_workspace_bytes=whole_ws_bytes,
                   parent_bwd_workspace_bytes=parent_ws_bytes,
                   plain_bwd_ms=plain_bwd_ms)
        if not bitwise:
            raise AssertionError(
                f"mixer_stack_train T={t}: chunk {chosen} differs from "
                "chunk = T")
        if not bwd_bitwise:
            raise AssertionError(
                f"mixer_stack_bwd T={t}: dx0, dh0, dc0 at chunk "
                f"{bwd_chosen} differ from chunk = T")
        if not bwd_repeat:
            raise AssertionError(
                f"mixer_stack_bwd T={t}: two runs at chunk {bwd_chosen} "
                "differ")
        cases.append(dict(T=t, chunk=chosen, rows=rows,
                          whole_sequence_fwd_ms=whole_ms,
                          fwd_ms_turns=turns, chunk_sweep_ms=sweep,
                          bitwise_equal_to_whole=bitwise,
                          bwd_chunk=bwd_chosen,
                          whole_sequence_bwd_ms=whole_bwd_ms,
                          bwd_ms_turns=bwd_turns,
                          bwd_chunk_sweep_ms=bwd_sweep,
                          bwd_states_bitwise_equal_to_whole=bwd_bitwise,
                          bwd_run_to_run_bitwise=bwd_repeat,
                          bwd_workspace_bytes=ws_bytes,
                          whole_sequence_bwd_workspace_bytes=whole_ws_bytes,
                          parent_bwd_workspace_bytes=parent_ws_bytes,
                          fwd_max_abs_err=fwd_err,
                          grad_max_abs_err=grad_err, grad_max_rel_err=grad_rel,
                          fwd_ms=fwd_ms, plain_fwd_ms=plain_fwd_ms,
                          bwd_ms=bwd_ms, plain_bwd_ms=plain_bwd_ms,
                          fwd_bound=fwd_bound, bwd_bound=bwd_bound))
    return cases


def layout_times(fwd, bwd, chosen):
    """Times of a chain at the rows per cluster the wrapper chooses and at
    R 16, in turns (R 16, chosen, chosen, R 16; R 16 alone where it is the
    choice): forward without and with residuals and backward, ms each
    (mean of 5 launches after a warm-up), the means of the turns by
    layout. fwd(residuals, rows) and bwd(fwd's outputs, rows) call the
    wrapper; rows None is its choice."""
    order = (16,) if chosen == (16, 16) else (16, None, None, 16)
    runs = {}
    for rows in order:
        out = fwd(True, rows)
        runs.setdefault("chosen" if rows is None else "rows16", []).append(
            dict(fwd_ms=cuda_ms(lambda: fwd(False, rows), 5)[0],
                 fwd_res_ms=cuda_ms(lambda: fwd(True, rows), 5)[0],
                 bwd_ms=cuda_ms(lambda: bwd(out, rows), 5)[0]))
        del out
    times = {k: {m: float(np.mean([r[m] for r in v])) for m in v[0]}
             for k, v in runs.items()}
    times.setdefault("chosen", times["rows16"])
    return times


def rows16_errors(fwd, bwd, plain_fwd, plain_grads):
    """The R 16 layout's forward error (abs) and gradient error (relative
    to the largest) against the plain version, through the wrapper's
    ``rows`` argument."""
    out0, out1 = fwd(False, 16), fwd(True, 16)
    grads = bwd(out1, 16)
    return (max(max_err(out0[:3], plain_fwd), max_err(out1[:3], plain_fwd)),
            rel_err(grads, plain_grads))


def layout_record(mod, key, b, chosen):
    """Rows per cluster of both chains, clusters launched, and what the
    card holds at once at every rows per cluster that fits; raises unless
    the clusters run in one wave."""
    resident = {d: mod.layout(0, key, d == "backward")[0]
                for d in ("forward", "backward")}
    lay = dict(rows=dict(zip(("forward", "backward"), chosen)),
               clusters={d: -(-b // r) for d, r in
                         zip(("forward", "backward"), chosen)},
               resident_clusters=resident)
    for d, rows in lay["rows"].items():
        if lay["clusters"][d] > resident[d][rows]:
            raise AssertionError(f"{mod.__name__} B{b} {d}: {lay}: not one "
                                 "wave of clusters")
    return lay


def lstm_layer_phase(K7, dev, rng):
    """6. The LSTM layer (K7): forward without and with residuals and
    backward vs plain at the Metaformer self-motion LSTM's shape (B32 x
    T252, 256 -> 256), at lstm_with_sampling's block shape (B256 x T140,
    256 -> 256) and at simple_lstm's acoustic LSTMs' (B256 x T120,
    256 -> 128); at the wrapper's rows per cluster and at R 16, timed in
    turns."""
    cases = []
    for b, t, din, h in ((TRAIN_B, LEAD + TRAIN_FRAMES, 256, 256),
                         (LWS_B, LEAD + LWS_FRAMES, 256, 256),
                         (SIMPLE_B, SIMPLE_AUDIO_T, 256, 128)):
        r = seeded(rng, dev)
        args = (r(b, t, din), r(din, 4 * h, s=0.06), r(4 * h, s=0.06),
                r(h, 4 * h, s=0.06), r(b, h, s=0.3), r(b, h, s=0.3))
        cots = (r(b, t, h), r(b, h), r(b, h))
        chosen = tuple(K7.rows_for(dev, h, bw, b) for bw in (False, True))
        ys0, (hn0, cn0) = K7.lstm_layer(*args)  # no gradient: no residuals
        leaves = [a.clone().requires_grad_() for a in args]
        ys, (hn, cn) = K7.lstm_layer(*leaves)
        grads = torch.autograd.grad((ys, hn, cn), leaves, cots)
        ys, hn, cn = ys.detach(), hn.detach(), cn.detach()
        with torch.no_grad():
            plain_fwd_ms, (ysr, (hr, cr)) = plain_time(
                lambda: K7.lstm_layer_reference(*args))
        plain_bwd_ms, want = plain_time(
            K7.lstm_layer_backward_reference(args, *cots, closure=True))
        fwd_err = max(max_err((ys0, hn0, cn0), (ysr, hr, cr)),
                      max_err((ys, hn, cn), (ysr, hr, cr)))
        grad_err = max_err(grads, want)
        grad_rel = rel_err(grads, want)

        def fwd(res, rows):
            return K7.lstm_layer_forward(args, res, rows=rows)

        def bwd(out, rows):
            return K7.lstm_layer_backward(args, out[0], out[3], out[4],
                                          *cots, rows=rows)

        r16_fwd_err, r16_grad_rel = rows16_errors(fwd, bwd, (ysr, hr, cr),
                                                  want)
        check_case("lstm_layer_rows16", r16_fwd_err, r16_grad_rel, B=b, T=t)
        times = layout_times(fwd, bwd, chosen)
        ys1, _, _, acts, cs = fwd(True, None)
        # x.W_ih and h.W_hh: 2 B T 4H (Din + H) FLOPs. The backward: the
        # chain's dgates.W_hh^T in FP32, 2 B T 4H H; dW_ih, dW_hh and dx in
        # 3xTF32, 2 B T 4H (2 Din + H)
        fwd_bound = bound(8 * b * t * h * (din + h),
                          nbytes(args, ys1, hn, cn, acts, cs))
        bwd_bound = bound(8 * b * t * h * h,
                          nbytes(args, ys1, acts, cs, cots, grads),
                          tf32x3_flops=8 * b * t * h * (2 * din + h))
        del ys1, acts, cs
        lib_fwd_ms, lib_bwd_ms = cudnn_lstm_ms(args, cots)
        main = times["chosen"]
        lay = layout_record(K7, h, b, chosen)
        check_case("lstm_layer", fwd_err, grad_rel, B=b, T=t, din=din, H=h,
                   rows=chosen, clusters=tuple(lay["clusters"].values()),
                   resident=lay["resident_clusters"], fwd_ms=main["fwd_ms"],
                   fwd_res_ms=main["fwd_res_ms"], bwd_ms=main["bwd_ms"],
                   rows16=times["rows16"], plain_fwd_ms=plain_fwd_ms,
                   plain_bwd_ms=plain_bwd_ms, library_fwd_ms=lib_fwd_ms,
                   library_bwd_ms=lib_bwd_ms, fwd_bound_ms=fwd_bound[0],
                   bwd_bound_ms=bwd_bound[0])
        cases.append(dict(
            B=b, T=t, din=din, H=h, **lay, fwd_max_abs_err=fwd_err,
            grad_max_abs_err=grad_err, grad_max_rel_err=grad_rel,
            rows16_fwd_max_abs_err=r16_fwd_err,
            rows16_grad_max_rel_err=r16_grad_rel, **main,
            rows16_ms=times["rows16"], plain_fwd_ms=plain_fwd_ms,
            plain_bwd_ms=plain_bwd_ms, library_fwd_ms=lib_fwd_ms,
            library_bwd_ms=lib_bwd_ms, fwd_bound=fwd_bound,
            bwd_bound=bwd_bound))
        del args, leaves, grads, want, ys, ys0, ysr
    return cases


def cudnn_ms(rnn, x, hx, cots):
    """Yardstick only, never called by the port: a ``torch.nn.LSTM`` or
    ``torch.nn.GRU`` (cuDNN) forward under grad and its backward, ms each
    (mean of 5 after a warm-up)."""
    fwd_ms, (ys, hn) = cuda_ms(lambda: rnn(x, hx), 5)
    outs = (ys, *hn) if isinstance(hn, tuple) else (ys, hn)
    leaves = [x, *rnn.parameters()]
    bwd_ms, _ = cuda_ms(lambda: torch.autograd.grad(
        outs, leaves, cots, retain_graph=True), 5)
    return fwd_ms, bwd_ms


def cudnn_lstm_ms(args, cots, dtype=torch.float32):
    """cuDNN's one-layer LSTM with K7's weights (``cudnn_ms``), in
    ``dtype`` (bf16: the yardstick of K7's bf16 mode)."""
    x, w_ih_t, b_sum, w_hh_t, h0, c0 = args
    lstm = torch.nn.LSTM(x.shape[-1], h0.shape[-1], batch_first=True).to(
        x.device)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w_ih_t.T)
        lstm.weight_hh_l0.copy_(w_hh_t.T)
        lstm.bias_ih_l0.copy_(b_sum)
        lstm.bias_hh_l0.zero_()
    return cudnn_ms(lstm.to(dtype), x.to(dtype).clone().requires_grad_(),
                    (h0[None].to(dtype), c0[None].to(dtype)),
                    tuple(c.to(dtype) for c in (cots[0], cots[1][None],
                                                 cots[2][None])))


def cudnn_stacked_ms(args, cots, dtype=torch.float32):
    """cuDNN's L-layer LSTM with K9's recurrent weights (``cudnn_ms``), in
    ``dtype``. It also computes layer 0's input product, from an input x
    (B, T, H) standing in for the precomputed xw0 the kernels take."""
    xw0, w_ih_t, b_rest, w_hh_t, h0, c0 = args
    layers, _, h = h0.shape
    lstm = torch.nn.LSTM(h, h, num_layers=layers, batch_first=True).to(
        xw0.device)
    with torch.no_grad():
        for k in range(layers):
            getattr(lstm, f"weight_hh_l{k}").copy_(w_hh_t[k].T)
            getattr(lstm, f"bias_hh_l{k}").zero_()
            if k:
                getattr(lstm, f"weight_ih_l{k}").copy_(w_ih_t[k - 1].T)
                getattr(lstm, f"bias_ih_l{k}").copy_(b_rest[k - 1])
    x = xw0[:, :, :h].to(dtype).contiguous().requires_grad_()
    return cudnn_ms(lstm.to(dtype), x, (h0.to(dtype), c0.to(dtype)),
                    tuple(c.to(dtype) for c in cots))


def cudnn_gru_ms(args, cots=None, dtype=torch.float32):
    """cuDNN's one-layer GRU with K10's recurrent weights (``cudnn_ms``),
    in ``dtype`` (bf16: the yardstick of K10's bf16 mode). It also
    computes the input product, from an input x (B, T, H) and random W_ih
    standing in for the precomputed xw the kernels take. Without
    ``cots``, the forward alone without a gradient (the decode hoist) and
    None for the backward."""
    xw, w_hh_t, b_hh, h0 = args
    h = h0.shape[-1]
    gru = torch.nn.GRU(h, h, batch_first=True).to(xw.device)
    with torch.no_grad():
        gru.weight_hh_l0.copy_(w_hh_t.T)
        gru.bias_hh_l0.copy_(b_hh)
    gru = gru.to(dtype)
    x, h0 = xw[:, :, :h].to(dtype).contiguous(), h0[None].to(dtype)
    if cots is None:
        with torch.no_grad():
            return cuda_ms(lambda: gru(x, h0), 5)[0], None
    return cudnn_ms(gru, x.requires_grad_(), h0,
                    (cots[0].to(dtype), cots[1][None].to(dtype)))


def gru_phase(K10, dev, rng):
    """14. The GRU recurrence (K10): forward without and with residuals
    and backward vs plain at the GRU config's shapes, H256: B32 x T2016
    (an audio-encoder block in training), B32 x T252 (the self-motion and
    partner blocks), B16 x T2096 (the decode hoist, forward only), and at
    the yaml's own batch B128 x T252 (past the clusters of 16 CTAs the
    card holds at once: clusters of 8); and H128 at B32 x T252. Two calls
    of each kernel on the same inputs must give the same bits."""
    r = seeded(rng, dev)
    cases = []
    for b, t, h, backward in (
            (TRAIN_B, (LEAD + TRAIN_FRAMES) * RATIO, 256, True),
            (TRAIN_B, LEAD + TRAIN_FRAMES, 256, True),
            (B, (LEAD + FRAMES) * RATIO, 256, False),
            (TRAIN_B, LEAD + TRAIN_FRAMES, 128, True),
            (YAML_B, LEAD + TRAIN_FRAMES, 256, True)):
        args = (r(b, t, 3 * h, s=0.5), r(h, 3 * h, s=0.06), r(3 * h, s=0.1),
                r(b, h, s=0.3))
        cots = (r(b, t, h), r(b, h))
        # the wrapper as the model calls it: without a gradient the
        # forward without residuals; with one, the forward with
        # residuals, then the backward
        ys0, hn0 = K10.gru_recurrence(*args)
        with torch.no_grad():
            plain_fwd_ms, (ysr, hr) = plain_time(
                lambda: K10.gru_recurrence_reference(*args))
        fwd_err = max_err((ys0, hn0), (ysr, hr))
        fwd_ms, again = cuda_ms(lambda: K10.gru_forward(args, False), 5)
        bits = same_bits((ys0, hn0), again[:2])
        # the chain's products: 2 B T 3H H FLOPs each way, in 3xTF32 (FP32
        # figures beside); the backward call also reduces dW_hh (the same
        # again, 3xTF32)
        flops = 2 * b * t * 3 * h * h
        fwd_bytes = nbytes(args, ys0, hn0)
        case = dict(B=b, T=t, H=h, clusters=-(-b // 16),
                    cluster_ctas=K10.launch_ctas(dev, b, h),
                    fwd_ms=fwd_ms, plain_fwd_ms=plain_fwd_ms,
                    fwd_us_per_step=fwd_ms * 1e3 / t,
                    fwd_no_residual_bound=bound(0, fwd_bytes,
                                                tf32x3_flops=flops),
                    fwd_no_residual_bound_fp32=bound(flops, fwd_bytes))
        kv = {}
        if backward:
            leaves = [a.clone().requires_grad_() for a in args]
            ys, hn = K10.gru_recurrence(*leaves)
            grads = torch.autograd.grad((ys, hn), leaves, cots)
            fwd_err = max(fwd_err, max_err((ys, hn), (ysr, hr)))
            plain_bwd_ms, want = plain_time(
                K10.gru_backward_reference(args, *cots, closure=True))
            grad_err = max_err(grads, want)
            grad_rel = rel_err(grads, want)
            del want
            fwd_res_ms, (ys1, hn1, hh) = cuda_ms(
                lambda: K10.gru_forward(args, True), 5)
            bwd_ms, again = cuda_ms(
                lambda: K10.gru_backward(args, ys1, hh, *cots), 5)
            first = K10.gru_forward(args, True)
            bits = (bits and same_bits(first, (ys1, hn1, hh))
                    and same_bits(grads, again)
                    and same_bits(K10.gru_backward(args, *first[::2], *cots),
                                  again))
            lib_fwd_ms, lib_bwd_ms = cudnn_gru_ms(args, cots)
            fwd_bytes = nbytes(args, ys1, hn1, hh)
            bwd_bytes = nbytes(args, ys1, hh, cots, grads)
            case.update(
                grad_max_abs_err=grad_err, grad_max_rel_err=grad_rel,
                fwd_res_ms=fwd_res_ms, bwd_ms=bwd_ms,
                fwd_res_us_per_step=fwd_res_ms * 1e3 / t,
                bwd_us_per_step=bwd_ms * 1e3 / t,
                plain_bwd_ms=plain_bwd_ms, library_fwd_ms=lib_fwd_ms,
                library_bwd_ms=lib_bwd_ms,
                fwd_bound=bound(0, fwd_bytes, tf32x3_flops=flops),
                fwd_bound_fp32=bound(flops, fwd_bytes),
                bwd_bound=bound(0, bwd_bytes, tf32x3_flops=2 * flops),
                bwd_bound_fp32=bound(2 * flops, bwd_bytes))
            kv = dict(fwd_res_ms=fwd_res_ms, bwd_ms=bwd_ms,
                      plain_bwd_ms=plain_bwd_ms, library_fwd_ms=lib_fwd_ms,
                      library_bwd_ms=lib_bwd_ms,
                      fwd_us_per_step=case["fwd_res_us_per_step"],
                      bwd_us_per_step=case["bwd_us_per_step"],
                      bwd_bound_ms=case["bwd_bound"][0],
                      bwd_bound_fp32_ms=case["bwd_bound_fp32"][0])
            del leaves, grads, ys, ys1, hh, first, again
        else:
            grad_rel = 0.0
            lib_fwd_ms, _ = cudnn_gru_ms(args)
            case["library_fwd_ms"] = lib_fwd_ms
            kv = dict(library_fwd_ms=lib_fwd_ms,
                      fwd_us_per_step=case["fwd_us_per_step"])
        case["fwd_max_abs_err"] = fwd_err
        case["bit_identical"] = bits
        check_case("gru", fwd_err, grad_rel, B=b, T=t, H=h,
                   cluster_ctas=case["cluster_ctas"], fwd_ms=fwd_ms,
                   plain_fwd_ms=plain_fwd_ms,
                   fwd_bound_ms=case["fwd_no_residual_bound"][0],
                   fwd_bound_fp32_ms=case["fwd_no_residual_bound_fp32"][0],
                   bit_identical=bits, **kv)
        if not bits:
            raise AssertionError(
                f"gru B={b} T={t} H={h}: two kernel calls on the same "
                f"inputs differ")
        cases.append(case)
        del args, ys0, ysr
    return cases


def cudnn_recurrence_ms(args, cots, dtype=torch.float32):
    """cuDNN's one-layer LSTM with K8's recurrent weights (``cudnn_ms``),
    in ``dtype`` (bf16: the yardstick of K8's bf16 mode). It also
    computes the input product, from an input x (B, T, H) and random W_ih
    standing in for the precomputed xw the kernels take."""
    xw, w_hh_t, h0, c0 = args
    h = h0.shape[-1]
    lstm = torch.nn.LSTM(h, h, batch_first=True).to(xw.device)
    with torch.no_grad():
        lstm.weight_hh_l0.copy_(w_hh_t.T)
        lstm.bias_hh_l0.zero_()
    x = xw[:, :, :h].to(dtype).contiguous().requires_grad_()
    return cudnn_ms(lstm.to(dtype), x, (h0[None].to(dtype),
                                        c0[None].to(dtype)),
                    tuple(c.to(dtype) for c in (cots[0], cots[1][None],
                                                 cots[2][None])))


def lstm_recurrence_phase(K8, dev, rng):
    """18. The LSTM recurrence over precomputed inputs (K8): forward
    without and with residuals and backward vs plain at B256 x T120 x H128
    (a simple_lstm acoustic direction), B32 x T252 x H256 (the flagship's
    self-motion LSTMs under MRGEN_FUSED_DW=0), B20 x T37 x H128 (ragged
    batch and length) and B1 x T120 x H128 (a frame of the
    MRGEN_FUSED_DW=0 simple_lstm rollout). Two calls of each kernel on the
    same inputs must give the same bits."""
    r = seeded(rng, dev)
    cases = []
    for b, t, h in ((SIMPLE_B, SIMPLE_AUDIO_T, 128),
                    (TRAIN_B, LEAD + TRAIN_FRAMES, 256), (20, 37, 128),
                    (1, SIMPLE_AUDIO_T, 128)):
        args = (r(b, t, 4 * h, s=0.5), r(h, 4 * h, s=0.06), r(b, h, s=0.3),
                r(b, h, s=0.3))
        cots = (r(b, t, h), r(b, h), r(b, h))
        # the wrapper as the model calls it: without a gradient the
        # forward without residuals; with one, the forward with
        # residuals, then the backward
        ys0, (hn0, cn0) = K8.lstm_recurrence(*args)
        leaves = [a.clone().requires_grad_() for a in args]
        ys, (hn, cn) = K8.lstm_recurrence(*leaves)
        grads = torch.autograd.grad((ys, hn, cn), leaves, cots)
        ys, hn, cn = ys.detach(), hn.detach(), cn.detach()
        with torch.no_grad():
            plain_fwd_ms, (ysr, (hr, cr)) = plain_time(
                lambda: K8.lstm_recurrence_reference(*args))
        plain_bwd_ms, want = plain_time(
            K8.lstm_recurrence_backward_reference(args, *cots, closure=True))
        fwd_err = max(max_err((ys0, hn0, cn0), (ysr, hr, cr)),
                      max_err((ys, hn, cn), (ysr, hr, cr)))
        grad_err = max_err(grads, want)
        grad_rel = rel_err(grads, want)
        del ysr, hr, cr, want
        fwd_ms, again = cuda_ms(
            lambda: K8.lstm_recurrence_forward(args, False), 5)
        fwd_res_ms, (ys1, hn1, cn1, acts, cs) = cuda_ms(
            lambda: K8.lstm_recurrence_forward(args, True), 5)
        bwd_ms, grads1 = cuda_ms(lambda: K8.lstm_recurrence_backward(
            args, ys1, acts, cs, *cots), 5)
        first = K8.lstm_recurrence_forward(args, True)
        bits = (same_bits((ys0, hn0, cn0), again[:3])
                and same_bits((ys, hn, cn), (ys1, hn1, cn1))
                and same_bits(first, (ys1, hn1, cn1, acts, cs))
                and same_bits(grads, grads1)
                and same_bits(K8.lstm_recurrence_backward(
                    args, first[0], *first[3:], *cots), grads1))
        # the chain's products h.W_hh: 2 B T 4H H FLOPs; the backward
        # twice that (dgates.W_hh^T on the chain, then dW_hh); all in
        # 3xTF32 (the FP32 figures beside). The backward reads no xw: its
        # gates come from acts
        flops = 2 * b * t * 4 * h * h
        fwd_bytes = nbytes(args, ys1, hn1, cn1, acts, cs)
        nores_bytes = nbytes(args, ys0, hn0, cn0)
        bwd_bytes = nbytes(args[1:], ys1, acts, cs, cots, grads)
        lib_fwd_ms, lib_bwd_ms = cudnn_recurrence_ms(args, cots)
        case = dict(
            B=b, T=t, H=h, clusters=-(-b // 16),
            cluster_ctas=K8.launch_ctas(dev, b, h), fwd_max_abs_err=fwd_err,
            grad_max_abs_err=grad_err, grad_max_rel_err=grad_rel,
            fwd_ms=fwd_ms, fwd_res_ms=fwd_res_ms, plain_fwd_ms=plain_fwd_ms,
            bwd_ms=bwd_ms, plain_bwd_ms=plain_bwd_ms,
            fwd_us_per_step=fwd_ms * 1e3 / t,
            fwd_res_us_per_step=fwd_res_ms * 1e3 / t,
            bwd_us_per_step=bwd_ms * 1e3 / t,
            library_fwd_ms=lib_fwd_ms, library_bwd_ms=lib_bwd_ms,
            fwd_bound=bound(0, fwd_bytes, tf32x3_flops=flops),
            fwd_bound_fp32=bound(flops, fwd_bytes),
            fwd_no_residual_bound=bound(0, nores_bytes, tf32x3_flops=flops),
            fwd_no_residual_bound_fp32=bound(flops, nores_bytes),
            bwd_bound=bound(0, bwd_bytes, tf32x3_flops=2 * flops),
            bwd_bound_fp32=bound(2 * flops, bwd_bytes),
            bit_identical=bits)
        check_case("lstm_recurrence", fwd_err, grad_rel, B=b, T=t, H=h,
                   cluster_ctas=case["cluster_ctas"], fwd_ms=fwd_ms,
                   fwd_res_ms=fwd_res_ms, plain_fwd_ms=plain_fwd_ms,
                   bwd_ms=bwd_ms, plain_bwd_ms=plain_bwd_ms,
                   library_fwd_ms=lib_fwd_ms, library_bwd_ms=lib_bwd_ms,
                   fwd_us_per_step=case["fwd_us_per_step"],
                   fwd_res_us_per_step=case["fwd_res_us_per_step"],
                   bwd_us_per_step=case["bwd_us_per_step"],
                   fwd_bound_ms=case["fwd_bound"][0],
                   fwd_bound_fp32_ms=case["fwd_bound_fp32"][0],
                   bwd_bound_ms=case["bwd_bound"][0],
                   bwd_bound_fp32_ms=case["bwd_bound_fp32"][0],
                   bit_identical=bits)
        if not bits:
            raise AssertionError(
                f"lstm_recurrence B={b} T={t} H={h}: two kernel calls on "
                f"the same inputs differ")
        cases.append(case)
        del args, leaves, grads, grads1, ys, ys0, ys1, acts, cs, first, again
    return cases


def bidirectional_phase(mods, dev, rng):
    """18. A bidirectional ``TorchLSTM`` at simple_lstm's acoustic shape
    (B256 x T120, 256 -> 128): K7 on the input and on the time-flipped
    input (+2 / +2), outputs, states and the gradients of the input and
    every parameter vs the plain recurrences; then the routing case, an
    LSTM of input 81 over T120 without a gradient: K8 +1, no K7."""
    from multimodalreactiongeneration_tpu_torch.nn.recurrent import TorchLSTM
    from multimodalreactiongeneration_tpu_torch.ops.lstm_layer import (
        lstm_layer_reference,
    )

    b, t, din, h = SIMPLE_B, SIMPLE_AUDIO_T, 256, 128
    r = seeded(rng, dev)
    lstm = TorchLSTM(din, h, torch.Generator().manual_seed(SEED),
                     bidirectional=True).to(dev)
    x = r(b, t, din)
    g = r(b, t, 2 * h)
    leaves = [x.clone().requires_grad_(), *lstm.parameters()]
    before = counts(mods)
    ys, (hn, cn) = lstm(leaves[0])
    grads = torch.autograd.grad((ys * g).sum() + hn.sum() + cn.sum(), leaves)
    torch.cuda.synchronize()
    check_launches("bidirectional", before, counts(mods), lstm_layer_fwd=2,
                   lstm_layer_bwd=2)

    def plain(x, *params):
        outs, hs, cs = [], [], []
        z = torch.zeros(b, h, device=dev)
        for d in range(2):
            w_ih, w_hh, b_ih, b_hh = params[4 * d:4 * d + 4]
            xd = torch.flip(x, [1]) if d else x
            y, (hd, cd) = lstm_layer_reference(xd, w_ih.T, b_ih + b_hh,
                                               w_hh.T, z, z)
            outs.append(torch.flip(y, [1]) if d else y)
            hs.append(hd)
            cs.append(cd)
        return torch.cat(outs, -1), torch.stack(hs), torch.stack(cs)

    ref = [a.detach().clone().requires_grad_() for a in leaves]
    ysr, hr, cr = plain(*ref)
    want = torch.autograd.grad((ysr * g).sum() + hr.sum() + cr.sum(), ref)
    fwd_err = max_err((ys, hn, cn), (ysr, hr, cr))
    grad_rel = rel_err(grads, want)
    check_case("bidirectional_k7", fwd_err, grad_rel, B=b, T=t, din=din, H=h)
    del ref, want, grads, ysr

    with torch.no_grad():
        routed = TorchLSTM(AUDIO_DIM, h, torch.Generator().manual_seed(SEED)
                           ).to(dev)
        before = counts(mods)
        routed(r(b, t, AUDIO_DIM))
        torch.cuda.synchronize()
        check_launches("routing: input 81", before, counts(mods),
                       lstm_recurrence_fwd=1)
    log("lstm_routing", input=AUDIO_DIM, hidden=h, steps=t,
        launches="lstm_recurrence_fwd +1, lstm_layer +0")
    return dict(B=b, T=t, din=din, H=h, fwd_max_abs_err=fwd_err,
                grad_max_rel_err=grad_rel)


def lstm_stacked_phase(K9, dev, rng):
    """10. The stacked-LSTM wavefront (K9): forward without and with
    residuals and backward vs plain at lstm_with_sampling's sampler
    shapes, H128 x L2: B256 x T1120 (training) and B16 x T96 (the
    generation warmup); at the wrapper's rows per cluster and at R 16,
    timed in turns."""
    h, layers = 128, 2
    r = seeded(rng, dev)
    cases = []
    for b, t in ((LWS_B, (LEAD + LWS_FRAMES) * RATIO), (B, LEAD * RATIO)):
        args = (r(b, t, 4 * h), r(layers - 1, h, 4 * h, s=0.06),
                r(layers - 1, 4 * h, s=0.06), r(layers, h, 4 * h, s=0.06),
                r(layers, b, h, s=0.3), r(layers, b, h, s=0.3))
        cots = (r(b, t, h), r(layers, b, h), r(layers, b, h))
        chosen = tuple(K9.rows_for(dev, layers, bw, b)
                       for bw in (False, True))
        # the wrapper as the model calls it: without a gradient the
        # forward without residuals; with one, the forward with
        # residuals, then the backward
        ys0, (hn0, cn0) = K9.lstm_stacked_recurrence(*args)
        leaves = [a.clone().requires_grad_() for a in args]
        ys, (hn, cn) = K9.lstm_stacked_recurrence(*leaves)
        grads = torch.autograd.grad((ys, hn, cn), leaves, cots)
        ys, hn, cn = ys.detach(), hn.detach(), cn.detach()
        with torch.no_grad():
            plain_fwd_ms, (ysr, (hr, cr)) = plain_time(
                lambda: K9.lstm_stacked_reference(*args))
        plain_bwd_ms, want = plain_time(
            K9.lstm_stacked_backward_reference(args, *cots, closure=True))
        fwd_err = max(max_err((ys0, hn0, cn0), (ysr, hr, cr)),
                      max_err((ys, hn, cn), (ysr, hr, cr)))
        grad_err = max_err(grads, want)
        grad_rel = rel_err(grads, want)

        def fwd(res, rows):
            return K9.lstm_stacked_forward(args, res, rows=rows)

        def bwd(out, rows):
            return K9.lstm_stacked_backward(args[1:], out[0], *out[3:],
                                            *cots, rows=rows)

        r16_fwd_err, r16_grad_rel = rows16_errors(fwd, bwd, (ysr, hr, cr),
                                                  want)
        check_case("lstm_stacked_rows16", r16_fwd_err, r16_grad_rel, B=b,
                   T=t)
        del ysr, hr, cr, want
        times = layout_times(fwd, bwd, chosen)
        ys1, hn1, cn1, hs, acts, cs = fwd(True, None)
        # h.W_hh of every layer and h.W_ih of layers 1..L-1: 2 B T 4H H
        # (2L - 1) FLOPs; the backward does it twice, dgates . W^T on the
        # chain in FP32 and the dW reductions in 3xTF32
        flops = 2 * b * t * 4 * h * h * (2 * layers - 1)
        fwd_bound = bound(flops, nbytes(args, ys1, hn1, cn1, hs, acts, cs))
        fwd_nores_bound = bound(flops, nbytes(args, ys0, hn0, cn0))
        bwd_bound = bound(flops,
                          nbytes(args[1:], ys1, hs, acts, cs, cots, grads),
                          tf32x3_flops=flops)
        del ys1, hs, acts, cs
        lib_fwd_ms, lib_bwd_ms = cudnn_stacked_ms(args, cots)
        main = times["chosen"]
        lay = layout_record(K9, layers, b, chosen)
        check_case("lstm_stacked", fwd_err, grad_rel, B=b, T=t, L=layers,
                   rows=chosen, clusters=tuple(lay["clusters"].values()),
                   resident=lay["resident_clusters"], fwd_ms=main["fwd_ms"],
                   fwd_res_ms=main["fwd_res_ms"], bwd_ms=main["bwd_ms"],
                   rows16=times["rows16"], plain_fwd_ms=plain_fwd_ms,
                   plain_bwd_ms=plain_bwd_ms, library_fwd_ms=lib_fwd_ms,
                   library_bwd_ms=lib_bwd_ms, fwd_bound_ms=fwd_bound[0],
                   bwd_bound_ms=bwd_bound[0])
        cases.append(dict(
            B=b, T=t, L=layers, H=h, **lay, fwd_max_abs_err=fwd_err,
            grad_max_abs_err=grad_err, grad_max_rel_err=grad_rel,
            rows16_fwd_max_abs_err=r16_fwd_err,
            rows16_grad_max_rel_err=r16_grad_rel, **main,
            rows16_ms=times["rows16"], plain_fwd_ms=plain_fwd_ms,
            plain_bwd_ms=plain_bwd_ms, library_fwd_ms=lib_fwd_ms,
            library_bwd_ms=lib_bwd_ms, fwd_bound=fwd_bound,
            fwd_no_residual_bound=fwd_nores_bound, bwd_bound=bwd_bound))
        del args, leaves, grads, ys, ys0
    return cases


def train_batch(rng, batch, frames, dev=None):
    """(data, lengths) pairs as the loader gives them; 10% of the target
    frames are padding (-100)."""
    data = make_batch(rng, batch, frames=frames)
    pad = rng.random((batch, frames)) < 0.1
    data[-1][torch.from_numpy(pad)] = -100.0
    return [(x.to(dev) if dev is not None else x, None) for x in data]


def window_batch(rng, batch, dev=None):
    """simple_lstm's window batch as the loader stacks it: fbank (B, 120,
    81), motion context (B, 15, 18), one target frame (B, 1, 18)."""
    data = tuple(
        torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        for s in ((batch, SIMPLE_AUDIO_T, AUDIO_DIM),
                  (batch, SIMPLE_CONTEXT, MOTION_DIM), (batch, 1, MOTION_DIM)))
    return data if dev is None else to_device(data, dev)


def to_device(batch, dev):
    """A host batch on ``dev``: stacked arrays (windowed) or (data,
    lengths) pairs (streaming)."""
    if isinstance(batch, tuple):
        return tuple(x.to(dev) for x in batch)
    return [(x.to(dev), n) for x, n in batch]


def spec_batch(spec, rng, batch, dev=None, frames=None):
    """A training batch of the kind ``spec``'s model takes."""
    if spec.get("windowed"):
        return window_batch(rng, batch, dev)
    return train_batch(rng, batch, frames or spec["frames"], dev)


def spec_step_fns(spec, model, optim):
    """(train_step, eval_step) of ``spec``'s model with a fresh optimizer
    from the ``optim`` group."""
    from multimodalreactiongeneration_tpu_torch.train.harness import (
        streaming_step_fns,
        windowed_step_fns,
    )
    from multimodalreactiongeneration_tpu_torch.train.optim import (
        build_optimizer,
    )

    opt = build_optimizer(model.parameters(), optim)
    model_cfg = {**spec["cfg"], **spec["loss"]}
    if spec.get("windowed"):
        return windowed_step_fns(model, model_cfg, spec["metrics"], opt)
    return streaming_step_fns(
        model, model_cfg, spec["metrics"], opt,
        mask_self_motion_input=spec["mask_self"],
        compute_dtype=spec.get("compute_dtype", torch.float32))


def spec_model(spec, device):
    return spec["model"](spec["cfg"],
                         generator=torch.Generator().manual_seed(SEED),
                         device=device)


def grad_mean_rel(model, ref):
    """The mean over the parameters of mean |grad - ref grad| / mean |ref
    grad| (the k projections' biases, zero in exact arithmetic, left
    out)."""
    named_ref = dict(ref.named_parameters())
    errs = [float((p.grad.to(named_ref[n].grad.device) - named_ref[n].grad)
                  .abs().mean() / named_ref[n].grad.abs().mean())
            for n, p in model.named_parameters() if "k_proj_bias" not in n]
    return float(np.mean(errs))


def grad_rel_errs(model, ref, floor=1e-4):
    """(worst, its parameter): max |grad - ref grad| of each parameter over
    the largest magnitude of ``ref``'s, that scale floored at ``floor`` of
    ``ref``'s largest gradient of all (phase 8's bound: 1e-4, for the
    gradients that are zero in exact arithmetic, the k projections'
    biases)."""
    named_ref = dict(ref.named_parameters())
    g_all = max(float(p.grad.abs().max()) for p in named_ref.values())
    worst, worst_name = 0.0, ""
    for name, p in model.named_parameters():
        g_ref = named_ref[name].grad
        scale = max(float(g_ref.abs().max()), floor * g_all)
        e = float((p.grad.to(g_ref.device) - g_ref).abs().max()) / scale
        if e > worst:
            worst, worst_name = e, name
    return worst, worst_name


def train_path_phase(mods, dev, rng, spec):
    """8., 12., 16. and 20. A training main path: the step functions of a
    model at full width, as ``spec`` names it (model class and config
    groups, batch, the launches of a step), then one SGD step on the card
    vs on CPU tensors from the same weights and batch."""
    import copy

    tag, batch_size, frames = spec["tag"], spec["batch"], spec["frames"]
    model = spec_model(spec, dev)
    train_step, eval_step = spec_step_fns(spec, model, spec["optim"])
    batch = spec_batch(spec, rng, batch_size, dev)
    train_step(batch)  # warm-up, not counted
    torch.cuda.synchronize()
    zero_counts(mods)
    losses, times = [], []
    torch.cuda.reset_peak_memory_stats(dev)
    steps = spec.get("steps", TRAIN_STEPS)
    for i in range(steps):
        before = counts(mods)
        t0 = time.perf_counter()
        loss, _ = train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000)
        check_launches(f"{tag} {i}", before, counts(mods), **spec["per_step"])
        losses.append(float(loss))
    launches = counts(mods)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: non-finite losses {losses}")
    step_ms = float(np.mean(times))
    frames_per_s = batch_size * frames / (step_ms / 1000)
    log(tag, batch=batch_size, frames=frames,
        ms_per_step=f"{step_ms:.3f}", frames_per_s=f"{frames_per_s:.1f}",
        step_ms=[round(t, 3) for t in times], losses=losses,
        peak_mem_gib=f"{peak_gib:.3f}", launches=launches)
    before = counts(mods)
    eval_loss, _ = eval_step(batch)
    got = check_launches(f"{tag} eval", before, counts(mods),
                         **spec["per_eval"])
    if not np.isfinite(float(eval_loss)):
        raise AssertionError(f"{tag} eval: loss {float(eval_loss)}")
    log(spec["eval_tag"], loss=f"{float(eval_loss):.6f}",
        launches={k: v for k, v in got.items() if v})

    busy = overlap = None
    if spec["profile"]:
        busy, overlap = profile_step(train_step, batch, spec["profile"])
    ab = None
    if spec.get("stack_ab"):  # the chunk schedule vs chunk = T
        means, each, peak = schedule_ab(mods["K1"], lambda: train_step(batch),
                                        TRAIN_STEPS)
        ab = {"ms": means, "ms_each": each, "peak_mem_gib": peak}
        log(tag, schedule="chunked_vs_whole_in_turns",
            chunked_ms=f"{means['chunked']:.3f}",
            whole_ms=f"{means['whole']:.3f}",
            peak_mem_gib={k: round(v, 3) for k, v in peak.items()})

    if not spec.get("card_vs_cpu", True):  # timed, with its launches
        return {"launches": launches, "record": {
            "batch": batch_size, "frames": frames, "steps": steps,
            "ms": step_ms, "frames_per_s": frames_per_s, "losses": losses,
            "peak_mem_gib": peak_gib, "device_busy_share": busy,
            "stack_overlap": overlap, "stack_schedule_ab": ab}}
    # one SGD step on the card and on CPU tensors, same weights and batch
    model_cpu = spec_model(spec, "cpu")
    model_card = copy.deepcopy(model_cpu).to(dev)
    small = spec_batch(spec, rng, 2, frames=48)
    sgd = dict(use_optimizer="sgd", lr=1e-2, momentum=0.9, weight_decay=0.0)
    loss_card, _ = spec_step_fns(spec, model_card, sgd)[0](
        to_device(small, dev))
    loss_cpu, _ = spec_step_fns(spec, model_cpu, sgd)[0](small)
    loss_rel = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
    worst, worst_name = grad_rel_errs(model_card, model_cpu,
                                      spec.get("grad_floor", 1e-4))
    log(tag, card_vs_cpu_loss_rel_err=f"{loss_rel:.3e}",
        card_vs_cpu_grad_max_rel_err=f"{worst:.3e}", worst=worst_name,
        loss_card=f"{float(loss_card):.7f}", loss_cpu=f"{float(loss_cpu):.7f}")
    loss_tol, grad_tol = spec.get("card_vs_cpu_tol",
                                  (LOSS_REL_TOL, GRAD_REL_TOL))
    if not loss_rel <= loss_tol:
        raise AssertionError(
            f"{tag} card vs CPU loss: {loss_rel} > {loss_tol}")
    if not worst <= grad_tol:
        raise AssertionError(f"{tag} card vs CPU gradient of {worst_name}: "
                             f"{worst} > {grad_tol}")
    mode = None
    if spec.get("f32_twin"):  # the mean errors: the card, the control
        model_f32 = spec_model(spec, "cpu")
        spec_step_fns(spec["f32_twin"](), model_f32, sgd)[0](small)
        mode = dict(vs_bf16=grad_mean_rel(model_card, model_cpu),
                    vs_f32=grad_mean_rel(model_card, model_f32))
        log(tag, card_vs_cpu_grad_mean_rel_err=f"{mode['vs_bf16']:.3e}",
            card_vs_cpu_f32_step_grad_mean_rel_err=f"{mode['vs_f32']:.3e}")
        if not mode["vs_bf16"] <= spec["mean_tol"] < mode["vs_f32"]:
            raise AssertionError(
                f"{tag}: card step {mode['vs_bf16']} from the CPU bf16 step, "
                f"{mode['vs_f32']} from the CPU f32 one, the bound "
                f"{spec['mean_tol']} between")
    return {"launches": launches, "record": {
        "batch": batch_size, "frames": frames, "steps": steps,
        "ms": step_ms, "frames_per_s": frames_per_s, "losses": losses,
        "peak_mem_gib": peak_gib, "device_busy_share": busy,
        "stack_overlap": overlap, "stack_schedule_ab": ab,
        "card_vs_cpu_loss_rel_err": loss_rel,
        "card_vs_cpu_grad_max_rel_err": worst,
        "card_vs_cpu_grad_mean_rel_err": mode}}


@contextlib.contextmanager
def fused_dw(value):
    """``MRGEN_FUSED_DW`` set to ``value`` inside the block (the port reads
    it at call time), restored after."""
    old = os.environ.get("MRGEN_FUSED_DW")
    os.environ["MRGEN_FUSED_DW"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MRGEN_FUSED_DW")
        else:
            os.environ["MRGEN_FUSED_DW"] = old


def fused_dw_off_phase(mods, dev, spec):
    """20. One training step of ``spec``'s model with ``MRGEN_FUSED_DW=0``
    (its single-layer LSTMs on K8) and one with the default (K7), each
    held to the plain FP32 step: the same weights and batch on CPU
    tensors, as phase 8 compares card with CPU. The launches of each step,
    then each loss within 1e-5 relative of the plain step's and every
    gradient within 1e-3 of its plain largest (phase 8's bounds). The
    distance of the two card steps from each other is printed, not held:
    it compares two roundings through the ReLUs. The batch comes from the
    phase's own generator (``SEED + 20``), so what earlier phases draw
    does not move it, at the spec's ``dw0_batch`` (batch, frames). SGD
    with lr 0 leaves the gradients to compare."""
    tag = spec["tag"] + "_fused_dw_0"
    rows, frames = spec["dw0_batch"]
    host = spec_batch(spec, np.random.default_rng(SEED + 20), rows,
                      frames=frames)
    batch = to_device(host, dev)
    sgd0 = dict(use_optimizer="sgd", lr=0.0, momentum=0.0, weight_decay=0.0)
    t0 = time.perf_counter()
    plain = spec_model(spec, "cpu")
    loss_plain, _ = spec_step_fns(spec, plain, sgd0)[0](host)
    loss_plain = float(loss_plain)
    plain_s = time.perf_counter() - t0
    runs, record = {}, {"loss_plain": loss_plain, "plain_step_s": plain_s}
    for flag, want in (("1", spec["per_step"]), ("0", spec["per_step_off"])):
        model = spec_model(spec, dev)
        train_step, _ = spec_step_fns(spec, model, sgd0)
        with fused_dw(flag):
            zero_counts(mods)
            loss, _ = train_step(batch)
            torch.cuda.synchronize()
            got = check_launches(f"{tag} MRGEN_FUSED_DW={flag}",
                                 {k: 0 for k in COUNTERS}, counts(mods),
                                 **want)
        loss = float(loss)
        loss_rel = abs(loss - loss_plain) / abs(loss_plain)
        worst, worst_name = grad_rel_errs(model, plain)
        runs[flag] = (model, got)
        record[f"fused_dw_{flag}"] = {
            "loss": loss, "loss_rel_err_vs_plain": loss_rel,
            "grad_max_rel_err_vs_plain": worst, "worst": worst_name}
        log(tag, flag=f"MRGEN_FUSED_DW={flag}", loss=f"{loss:.7f}",
            loss_plain=f"{loss_plain:.7f}",
            loss_rel_err_vs_plain=f"{loss_rel:.3e}",
            grad_max_rel_err_vs_plain=f"{worst:.3e}", worst=worst_name,
            plain_step_s=f"{plain_s:.1f}",
            launches={k: v for k, v in got.items() if v})
    (model_on, _), (model_off, launches) = runs["1"], runs["0"]
    worst, worst_name = grad_rel_errs(model_off, model_on)
    record["fused_dw_0_vs_1_grad_max_rel_err"] = worst
    log(tag, reading="MRGEN_FUSED_DW=0 vs =1, not held",
        grad_max_rel_err=f"{worst:.3e}", worst=worst_name)
    for flag in ("1", "0"):
        r = record[f"fused_dw_{flag}"]
        if not r["loss_rel_err_vs_plain"] <= LOSS_REL_TOL:
            raise AssertionError(
                f"{tag} MRGEN_FUSED_DW={flag} vs plain loss: "
                f"{r['loss_rel_err_vs_plain']} > {LOSS_REL_TOL}")
        if not r["grad_max_rel_err_vs_plain"] <= GRAD_REL_TOL:
            raise AssertionError(
                f"{tag} MRGEN_FUSED_DW={flag} vs plain gradient of "
                f"{r['worst']}: {r['grad_max_rel_err_vs_plain']} > "
                f"{GRAD_REL_TOL}")
    del runs, model_on, model_off, plain
    return {"launches": launches, "record": record}


def fused_dw_off_bf16_phase(mods, dev, spec):
    """20. ``spec``'s bf16 step with ``MRGEN_FUSED_DW=0`` (the flagship's
    and lstm_with_sampling's: their single-layer LSTMs on K8's bf16
    mode): the launches of the step (``per_step_off``), then the card's
    SGD step against the same bf16 step on CPU tensors under the same
    flag, from the same weights, on a batch of B2 x T48 from the phase's
    own generator (``SEED + 20``), as phases 30 and 31 compare them: the
    loss and every gradient within the spec's ``card_vs_cpu_tol``
    (gradients floored at its ``grad_floor``), and where it has an
    ``f32_twin`` the gradients on average within its ``mean_tol`` of the
    CPU's bf16 step, the CPU's f32 step under the flag, the control,
    beyond it."""
    import copy

    tag = spec["tag"] + "_fused_dw_0"
    host = spec_batch(spec, np.random.default_rng(SEED + 20), 2, frames=48)
    sgd = dict(use_optimizer="sgd", lr=1e-2, momentum=0.9, weight_decay=0.0)
    with fused_dw("0"):
        model_cpu = spec_model(spec, "cpu")
        model_card = copy.deepcopy(model_cpu).to(dev)
        zero_counts(mods)
        loss_card, _ = spec_step_fns(spec, model_card, sgd)[0](
            to_device(host, dev))
        torch.cuda.synchronize()
        launches = check_launches(f"{tag} MRGEN_FUSED_DW=0",
                                  {k: 0 for k in COUNTERS}, counts(mods),
                                  **spec["per_step_off"])
        t0 = time.perf_counter()
        loss_cpu, _ = spec_step_fns(spec, model_cpu, sgd)[0](host)
        cpu_s = time.perf_counter() - t0
        loss_rel = abs(float(loss_card) / float(loss_cpu) - 1)
        worst, worst_name = grad_rel_errs(model_card, model_cpu,
                                          spec.get("grad_floor", 1e-4))
        mode = None
        if spec.get("f32_twin"):
            model_f32 = spec_model(spec, "cpu")
            spec_step_fns(spec["f32_twin"](), model_f32, sgd)[0](host)
            mode = dict(vs_bf16=grad_mean_rel(model_card, model_cpu),
                        vs_f32=grad_mean_rel(model_card, model_f32))
    log(tag, card_vs_cpu_loss_rel_err=f"{loss_rel:.3e}",
        card_vs_cpu_grad_max_rel_err=f"{worst:.3e}", worst=worst_name,
        card_vs_cpu_grad_mean_rel_err=mode and f"{mode['vs_bf16']:.3e}",
        card_vs_cpu_f32_step_grad_mean_rel_err=mode and
        f"{mode['vs_f32']:.3e}", cpu_step_s=f"{cpu_s:.1f}",
        launches={k: v for k, v in launches.items() if v})
    loss_tol, grad_tol = spec["card_vs_cpu_tol"]
    if not (loss_rel <= loss_tol and worst <= grad_tol):
        raise AssertionError(f"{tag} card vs CPU: loss {loss_rel} (bound "
                             f"{loss_tol}), gradient of {worst_name} "
                             f"{worst} (bound {grad_tol})")
    if mode and not mode["vs_bf16"] <= spec["mean_tol"] < mode["vs_f32"]:
        raise AssertionError(
            f"{tag}: card step {mode['vs_bf16']} from the CPU bf16 step, "
            f"{mode['vs_f32']} from the CPU f32 one, the bound "
            f"{spec['mean_tol']} between")
    return {"launches": launches, "record": {
        "card_vs_cpu_loss_rel_err": loss_rel,
        "card_vs_cpu_grad_max_rel_err": worst, "worst": worst_name,
        "card_vs_cpu_grad_mean_rel_err": mode, "cpu_step_s": cpu_s}}


def metaformer_train_spec():
    from multimodalreactiongeneration_tpu_torch import configs
    from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
        Metaformer,
    )

    return dict(
        tag="train_step", eval_tag="eval_step", model=Metaformer,
        cfg=configs.LSTMFORMER_MODEL_CFG, loss=configs.LSTMFORMER_LOSS_CFG,
        metrics=configs.LSTMFORMER_METRICS_CFG,
        # AdamW as benchmarks/train_bench.py runs it: lr 1e-4, decay 1e-2
        optim={**configs.LSTMFORMER_OPTIM_CFG, "lr": 1e-4,
               "weight_decay": 1e-2},
        mask_self=True, batch=TRAIN_B, frames=TRAIN_FRAMES,
        per_step=dict(mixer_stack_train_fwd=2, mixer_stack_bwd=2,
                      lstm_layer_fwd=5, lstm_layer_bwd=5,
                      rect_attention_fwd=10, rect_attention_bwd=10),
        per_eval=dict(mixer_stack=2, lstm_layer_fwd=5, rect_attention_fwd=10),
        stack_ab=True,
        per_step_off=dict(mixer_stack_train_fwd=2, mixer_stack_bwd=2,
                          lstm_recurrence_fwd=5, lstm_recurrence_bwd=5,
                          rect_attention_fwd=10, rect_attention_bwd=10),
        # phase 20 at phase 8's card-vs-CPU batch: the plain CPU step at
        # B32 x T240 took 686 s of an H100 machine's host
        dw0_batch=(2, 48),
        profile="profile_train_step.txt")


def lws_train_spec():
    from multimodalreactiongeneration_tpu_torch import configs
    from multimodalreactiongeneration_tpu_torch.models.lstm_with_sampling \
        import LSTMwithSample

    # the yaml's optim group (AdamW, lr 5e-6, decay 1e-2); the self
    # motion's padding goes into the model as it is, as the CLI does
    return dict(
        tag="lws_train_step", eval_tag="lws_eval_step", model=LSTMwithSample,
        cfg=configs.LWS_MODEL_CFG, loss=configs.LWS_LOSS_CFG,
        metrics=configs.LWS_METRICS_CFG, optim=configs.LWS_OPTIM_CFG,
        mask_self=False, batch=LWS_B, frames=LWS_FRAMES,
        per_step=dict(lstm_stacked_fwd=1, lstm_stacked_bwd=1,
                      lstm_layer_fwd=2, lstm_layer_bwd=2),
        per_eval=dict(lstm_stacked_fwd=1, lstm_layer_fwd=2),
        profile="profile_lws_train_step.txt")


def gru_train_spec():
    from multimodalreactiongeneration_tpu_torch import configs

    # the flagship's step with GRU embeddings: its loss, metrics and optim
    # groups are the lstmformer's
    # the GRU Metaformer has no encoder stack: no chunk-schedule A/B
    return dict(metaformer_train_spec(), tag="gru_train_step",
                eval_tag="gru_eval_step",
                cfg=configs.LSTMFORMER_GRU_MODEL_CFG, stack_ab=False,
                per_step=dict(gru_fwd=15, gru_bwd=15, rect_attention_fwd=10,
                              rect_attention_bwd=10),
                per_eval=dict(gru_fwd=15, rect_attention_fwd=10),
                profile="profile_gru_train_step.txt")


def simple_train_spec():
    from multimodalreactiongeneration_tpu_torch import configs
    from multimodalreactiongeneration_tpu_torch.models.simple_lstm import (
        SimpleLSTM,
    )

    # the yaml's batch and optim group (AdamW, lr 5e-6, decay 1e-2); the
    # model group carries the loss keys (delta_loss_scale, all_static)
    return dict(
        tag="simple_train_step", eval_tag="simple_eval_step",
        model=SimpleLSTM, windowed=True, cfg=configs.SIMPLE_LSTM_MODEL_CFG,
        loss={}, metrics=configs.SIMPLE_LSTM_METRICS_CFG,
        optim=configs.SIMPLE_LSTM_OPTIM_CFG, batch=SIMPLE_B, frames=1,
        per_step=dict(lstm_layer_fwd=4, lstm_layer_bwd=4),
        per_eval=dict(lstm_layer_fwd=4),
        per_step_off=dict(lstm_recurrence_fwd=4, lstm_recurrence_bwd=4),
        # phase 20's card-vs-CPU batch, cut from the yaml's 256 windows for
        # room: the plain CPU step at B256 took 61.4 s of the host; no
        # profile (cut for room: host-bound, busy 0.12, PERF.md section 5)
        dw0_batch=(SIMPLE_DW0_B, 1), profile=None)


def profile_step(step, batch, name):
    """A torch.profiler table of one ``step(batch)`` (a training step or a
    generation), by device time, written to ``_build/<name>`` of the
    package; returns the share of the step's wall time in which a kernel
    or copy ran on the device (the union of their intervals), and the
    encoder stack's layer overlap (``window_overlap``, forward and
    backward; None without a stack call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from multimodalreactiongeneration_tpu_torch import _build

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy = busy_us / wall_us
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    overlap = window_overlap(device)
    bwd_overlap = window_overlap(device, "lstm_cluster_bwd_kernel")
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=60)
    path = _build.BUILD_DIR / name
    path.write_text(table)
    print("\n".join(table.splitlines()[:30]))
    log("profile", table=path, step_wall_ms=f"{wall_us / 1000:.3f}",
        device_busy_ms=f"{busy_us / 1000:.3f}",
        device_busy_share=f"{busy:.4f}")
    if overlap:
        log("profile", stack_windows=overlap["calls"],
            stack_window_ms=f"{overlap['window_ms']:.3f}",
            multi_layer_share=f"{overlap['multi_layer_share']:.4f}",
            recurrence_share=f"{overlap['recurrence_share']:.4f}")
    if bwd_overlap:
        log("profile", stack_bwd_windows=bwd_overlap["calls"],
            stack_bwd_window_ms=f"{bwd_overlap['window_ms']:.3f}",
            bwd_multi_layer_share=f"{bwd_overlap['multi_layer_share']:.4f}",
            bwd_recurrence_share=f"{bwd_overlap['recurrence_share']:.4f}")
        overlap = {**(overlap or {}), "backward": bwd_overlap}
    return busy, overlap


def rect_pairs(q_pad, k_pad):
    """(query, key) pairs one head's attention needs, over the batch: the
    ceil((i+1) Lk / Lq) keys the rect-causal mask leaves to row i, or all
    Lk for a row whose every key is masked (it averages over them)."""
    b, lq = q_pad.shape
    lk = k_pad.shape[1]
    i = torch.arange(lq, device=q_pad.device)
    lim = torch.clamp(((i + 1) * lk + lq - 1) // lq, max=lk)[None].expand(
        b, lq)
    unpadded = ~k_pad
    first = torch.where(unpadded.any(1), unpadded.int().argmax(1),
                        torch.full((b,), lk, device=q_pad.device))
    full = q_pad & (first[:, None] >= lim)
    return int(torch.where(full, lk, lim).sum())


def kernel_device_ms(fn, prefix):
    """Device milliseconds of each kernel whose name starts with
    ``prefix`` in one call of ``fn``, by torch.profiler, keyed by the
    kernel's name without its namespace and arguments."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        found = re.search(rf"\b({prefix}\w*)", e.name)
        if e.device_type == DeviceType.CUDA and found:
            name = found.group(1)
            ms = (e.time_range.end - e.time_range.start) / 1e3
            out[name] = out.get(name, 0.0) + ms
    return out


def rect_attention_phase(K5, dev, rng):
    """7. Rect attention forward (K5) and backward (K6) vs plain at the
    integrators' shapes: B32, Lq 252, Lk 2016 (audio) and 252 (partner
    motion), E 256, 4 heads, 10% padded rows and keys; the library
    yardstick is scaled_dot_product_attention with the boolean mask. Two
    backward calls on the same inputs must give the same bits; K6's dQ
    workspace and each of its launches' device time are printed."""
    import torch.nn.functional as F

    b, lq, e, heads = TRAIN_B, LEAD + TRAIN_FRAMES, 256, 4
    dh = e // heads
    r = seeded(rng, dev)
    cases = []
    for lk in (lq * RATIO, lq):
        q, k, v, g = r(b, lq, e), r(b, lk, e), r(b, lk, e), r(b, lq, e)
        q_pad = torch.from_numpy(rng.random((b, lq)) < 0.1).to(dev)
        k_pad = torch.from_numpy(rng.random((b, lk)) < 0.1).to(dev)
        args = (heads, q, k, v, q_pad, k_pad)
        # the wrapper as the model calls it: autograd runs K5, then K6
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = K5.rect_attention(heads, *leaves, q_pad, k_pad)
        grads = torch.autograd.grad(out, leaves, g)
        with torch.no_grad():
            plain_fwd_ms, want = cuda_ms(
                lambda: K5.rect_attention_reference(*args), 1)
        plain_bwd_ms, wgrads = cuda_ms(
            K5.rect_attention_backward_reference(*args, g, closure=True), 1)
        fwd_err = max_err((out,), (want,))
        grad_err = max_err(grads, wgrads)
        grad_rel = rel_err(grads, wgrads)
        fwd_ms, (ctx, m, l) = cuda_ms(
            lambda: K5.rect_attention_forward(*args, residuals=True), 10)
        fwd_nores_ms, _ = cuda_ms(lambda: K5.rect_attention_forward(*args),
                                  10)
        bwd_ms, again = cuda_ms(
            lambda: K5.rect_attention_backward(*args, ctx, m, l, g), 10)
        first = K5.rect_attention_backward(*args, ctx, m, l, g)
        same_bits = all(torch.equal(x, y) for x, y in zip(first, again))
        ws_bytes = K5.backward_workspace_bytes(heads, b, lq, lk, e)
        bwd_kernels_ms = kernel_device_ms(
            lambda: K5.rect_attention_backward(*args, ctx, m, l, g),
            "rect_attn_bwd")
        log("rect_attention_bwd_kernels", Lk=lk, **{
            k_: f"{v_:.4f}" for k_, v_ in bwd_kernels_ms.items()})
        # yardstick only, never called by the port
        allowed = ~K5.rect_attention_mask(q_pad, k_pad)[:, None]
        lib_leaves = [x.clone().requires_grad_() for x in (q, k, v)]

        def split(x):
            return x.view(b, x.shape[1], heads, dh).transpose(1, 2)

        lib_fwd_ms, lib_out = cuda_ms(lambda: F.scaled_dot_product_attention(
            *[split(x) for x in lib_leaves], attn_mask=allowed), 10)
        lib_bwd_ms, _ = cuda_ms(lambda: torch.autograd.grad(
            lib_out, lib_leaves, split(g), retain_graph=True), 10)
        # per needed (query, key) pair and head dim: q.k and p.v (2 FLOPs
        # each) forward; the backward's S = q.k, dP = dO.v, dV, dK and dQ
        # (10 FLOPs), all in 3xTF32 (three TF32 passes); its FP32 figure
        # is kept beside it
        pairs = rect_pairs(q_pad, k_pad) * heads
        fwd_bound = bound(0, nbytes(args, ctx, m, l),
                          tf32x3_flops=4 * pairs * dh)
        bwd_bytes = nbytes(args, ctx, m, l, g, grads)
        bwd_bound = bound(0, bwd_bytes, tf32x3_flops=10 * pairs * dh)
        bwd_bound_fp32 = bound(10 * pairs * dh, bwd_bytes)
        check_case("rect_attention", fwd_err, grad_rel, Lk=lk, fwd_ms=fwd_ms,
                   fwd_no_residual_ms=fwd_nores_ms, bwd_ms=bwd_ms,
                   plain_fwd_ms=plain_fwd_ms, plain_bwd_ms=plain_bwd_ms,
                   library_fwd_ms=lib_fwd_ms, library_bwd_ms=lib_bwd_ms,
                   fwd_bound_ms=fwd_bound[0], bwd_bound_ms=bwd_bound[0],
                   bwd_bound_fp32_ms=bwd_bound_fp32[0],
                   bwd_bit_identical=same_bits, bwd_workspace_bytes=ws_bytes)
        if not same_bits:
            raise AssertionError(
                f"rect_attention Lk={lk}: two backward calls on the same "
                f"inputs differ")
        cases.append(dict(
            Lq=lq, Lk=lk, fwd_max_abs_err=fwd_err, grad_max_abs_err=grad_err,
            grad_max_rel_err=grad_rel, fwd_ms=fwd_ms,
            fwd_no_residual_ms=fwd_nores_ms, bwd_ms=bwd_ms,
            plain_fwd_ms=plain_fwd_ms, plain_bwd_ms=plain_bwd_ms,
            library_fwd_ms=lib_fwd_ms, library_bwd_ms=lib_bwd_ms,
            fwd_bound=fwd_bound, bwd_bound=bwd_bound,
            bwd_bound_fp32=bwd_bound_fp32, bwd_bit_identical=same_bits,
            bwd_workspace_bytes=ws_bytes, bwd_kernels_ms=bwd_kernels_ms))
        del out, grads, want, wgrads, ctx, m, l, lib_out, allowed, first, again
    return cases


def write_corpus(root, sessions=CORPUS_SESSIONS, seconds=CORPUS_SECONDS):
    """A dyadic corpus in the layout the manifest builder walks, from
    SEED: per session, host and comp wavs whose speakers take turns of
    12 s noise bursts 3 s apart (one 10 s training window per turn), and
    host/comp motion .npz at 25 fps. Returns the seconds of audio per
    channel."""
    from multimodalreactiongeneration_tpu_torch.utils.wavio import write_wav

    rng = np.random.default_rng(SEED)
    sr, fps = 16000, 25
    for s in range(sessions):
        d = os.path.join(root, f"session{s:02d}", f"data{s:02d}")
        os.makedirs(d, exist_ok=True)
        waves = np.zeros((2, int(seconds * sr)), np.float32)
        t, who = 1.0, 0
        while t + 14.0 < seconds:
            a, z = int(t * sr), int((t + 12.0) * sr)
            waves[who, a:z] = 0.3 * rng.standard_normal(z - a)
            t, who = t + 15.0, who ^ 1
        frames = int(seconds * fps)
        for w, name in enumerate(("host", "comp")):
            write_wav(os.path.join(d, f"{name}.wav"), waves[w][None], sr)
            traj = np.cumsum(rng.normal(0, 0.8, (frames, 6)), axis=0) * 0.05
            angle, cent = traj[:, :3] * 5.0, 0.5 + traj[:, 3:] * 0.01
            np.savez(
                os.path.join(d, f"{name}_000000.npz"),
                angle=(angle - angle.mean(0)) / (angle.std(0) + 1e-6),
                centroid=(cent - cent.mean(0)) / (cent.std(0) + 1e-6),
                angle_mean=angle.mean(0), angle_std=angle.std(0) + 1e-6,
                centroid_mean=cent.mean(0), centroid_std=cent.std(0) + 1e-6,
                section=np.array([0, frames]),
            )
    return sessions * seconds


def write_corpus_v1(root, sessions=V1_SESSIONS, seconds=V1_SECONDS):
    """simple_lstm's corpus layout, from SEED: per session, host and comp
    wavs of noise bursts and, beside each, a directory of per-frame
    ``.head`` pickles at 25 fps (a random-walk head pose with its
    standardisation stats). Returns the windows' frames per channel."""
    from multimodalreactiongeneration_tpu_torch.data.head_io import (
        HeadFrame,
        write_head_frame,
    )
    from multimodalreactiongeneration_tpu_torch.utils.wavio import write_wav

    rng = np.random.default_rng(SEED + 1)
    sr, fps = 16000, 25
    frames = int(seconds * fps)
    for s in range(sessions):
        session = os.path.join(root, f"session{s:02d}")
        for who in ("host", "comp"):
            head_dir = os.path.join(session, who)
            os.makedirs(head_dir, exist_ok=True)
            wave = 0.2 * rng.standard_normal(int(seconds * sr))
            write_wav(os.path.join(session, f"{who}.wav"),
                      wave.astype(np.float32)[None], sr)
            traj = np.cumsum(rng.normal(0, 0.5, (frames, 6)), axis=0) * 0.05
            stats = dict(angle_mean=traj[:, :3].mean(0),
                         angle_std=traj[:, :3].std(0) + 1e-6,
                         centroid_mean=traj[:, 3:].mean(0),
                         centroid_std=traj[:, 3:].std(0) + 1e-6)
            for t in range(frames):
                write_head_frame(
                    os.path.join(head_dir, f"{who}_{t:05d}.head"), t,
                    HeadFrame(angle=traj[t, :3], centroid=traj[t, 3:],
                              frame_no=t, fps=float(fps), **stats))
    return sessions * 2 * frames


def cli_phase(mods, run, config, tag, overrides, expect, corpus="corpus",
              monitors="VTG", resume=True):
    """9., 13., 17. and 21. The training CLI, as a user runs it: the yaml
    at ``config``, passed by its path, at full width (its defaults:
    val_check_interval 0.25, the generation eval where the model has one,
    async top-k checkpoints, the audio resident on the card for the
    streaming models) on the corpus ``run / corpus``, one epoch; then
    (``resume``) a resumed epoch from ``last``. ``monitors`` are the top-k
    checkpoint sets the run writes; ``expect(launches, steps)`` gives the
    exact launches of the first run and the validation batches they
    imply."""
    from multimodalreactiongeneration_tpu_torch.train import cli

    ckpt = run / f"ckpt_{tag}" / "smoke"
    config = os.path.abspath(config)  # the run's cwd is ``run``
    common = ["--config", config, "name=smoke", f"data_dir={run / corpus}",
              f"ckpt_path={ckpt.parent}", f"log_dir={run / f'log_{tag}'}",
              f"seed={SEED}", *overrides]
    cwd = os.getcwd()
    os.chdir(run)  # the manifests go under ./data of the run directory
    try:
        zero_counts(mods)
        t0 = time.perf_counter()
        first = cli.main(common + ["max_epochs=1"])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = counts(mods)
        records, resumed_s = first.history, None
        if resume:
            t0 = time.perf_counter()
            resumed = cli.main(common + ["max_epochs=2",
                                         f"resume_from={ckpt / 'last'}"])
            torch.cuda.synchronize()
            resumed_s = time.perf_counter() - t0
            records = records + resumed.history
    finally:
        os.chdir(cwd)
    for rec in records:
        log(f"{tag}_epoch", **{k: (f"{v:.6f}" if isinstance(v, float) else v)
                               for k, v in rec.items()})
        keys = ("train_loss", "val_loss") + (
            ("genrt_loss",) if "G" in monitors else ())
        for key in keys:
            if not np.isfinite(rec.get(key, float("nan"))):
                raise AssertionError(f"{tag} epoch {rec['epoch']}: {key} "
                                     f"{rec.get(key)}")
    if [r["epoch"] for r in records] != [0, 1][:len(records)] or (
            len(records) != 1 + resume):
        raise AssertionError(f"{tag} epochs {[r['epoch'] for r in records]}")
    names = sorted(os.listdir(ckpt))
    if "last" not in names or not all(
            any(n.startswith(f"{m}0-") for n in names) for m in monitors):
        raise AssertionError(f"{tag} checkpoints {names}")
    steps = first.history[0]["step"]
    n_eval = expect(launches, steps)
    if n_eval < first.history[0]["val_checks"]:
        raise AssertionError(f"{tag}: {n_eval} validation batches in "
                             f"{first.history[0]['val_checks']} checks")
    log(tag, train_steps=steps, eval_batches=n_eval, launches=launches,
        first_run_s=f"{first_s:.1f}", resumed_run_s=resumed_s and round(
            resumed_s, 1),
        checkpoints=names)
    return {"launches": launches, "record": {
        "first_run_s": first_s, "resumed_run_s": resumed_s,
        "epochs": records}}


def metaformer_cli_launches(launches, steps):
    """Every train step K5 +10, K6 +10, K3 +2, K4 +2, K7 +5 / +5; every
    validation batch an eval step (K5 +10, K1 +2, K7 forward +5) and a
    generation (K1 +2, K2 one per 16 rows). Returns the validation
    batches."""
    n_eval = (launches["rect_attention_fwd"] - 10 * steps) // 10
    want = dict(rect_attention_fwd=10 * (steps + n_eval),
                rect_attention_bwd=10 * steps,
                mixer_stack_train_fwd=2 * steps, mixer_stack_bwd=2 * steps,
                lstm_layer_fwd=5 * (steps + n_eval), lstm_layer_bwd=5 * steps,
                mixer_stack=4 * n_eval)
    got = {k: launches[k] for k in want}
    others = ("lstm_stacked_fwd", "lstm_stacked_bwd", "gru_fwd", "gru_bwd",
              "lstm_recurrence_fwd", "lstm_recurrence_bwd")
    if (got != want or launches["decode_rollout"] < n_eval
            or any(launches[k] for k in others)):
        raise AssertionError(f"cli launches {launches}, want {want} and "
                             f"decode_rollout >= {n_eval}")
    return n_eval


def metaformer_dropout_cli_launches(launches, steps):
    """``model.dropout=0.1``: every train step K7 +15 / +15 (the encoder
    stacks block by block), K5 +10, K6 +10, no K3 or K4; every validation
    batch as ``metaformer_cli_launches``'. Returns the validation
    batches."""
    n_eval = (launches["rect_attention_fwd"] - 10 * steps) // 10
    want = {k: 0 for k in COUNTERS}
    want.update(rect_attention_fwd=10 * (steps + n_eval),
                rect_attention_bwd=10 * steps,
                lstm_layer_fwd=15 * steps + 5 * n_eval,
                lstm_layer_bwd=15 * steps, mixer_stack=4 * n_eval,
                decode_rollout=launches["decode_rollout"])
    if launches != want or launches["decode_rollout"] < n_eval:
        raise AssertionError(f"dropout cli launches {launches}, want {want} "
                             f"and decode_rollout >= {n_eval}")
    return n_eval


def lws_ss_cli_launches(launches, steps):
    """``model.use_scheduled_sampling=true``: every train step K9 +1 / +1
    (the rollout's warmup over the lead; its steps run the plain
    recurrences); every validation batch as ``lws_cli_launches``'."""
    n_eval = launches["lstm_layer_fwd"] // 2
    want = {k: 0 for k in COUNTERS}
    want.update(lstm_stacked_fwd=steps + 2 * n_eval, lstm_stacked_bwd=steps,
                lstm_layer_fwd=2 * n_eval)
    if launches != want:
        raise AssertionError(f"lws ss cli launches {launches}, want {want}")
    return n_eval

def lws_cli_launches(launches, steps):
    """Every train step K9 +1 / +1 and K7 +2 / +2; every validation batch
    an eval step (K9 +1, K7 forward +2) and a generation (K9 +1: the
    sampler's warmup over the lead); no other kernel."""
    n_eval = (launches["lstm_layer_fwd"] - 2 * steps) // 2
    want = {k: 0 for k in COUNTERS}
    want.update(lstm_stacked_fwd=steps + 2 * n_eval, lstm_stacked_bwd=steps,
                lstm_layer_fwd=2 * (steps + n_eval), lstm_layer_bwd=2 * steps)
    if launches != want:
        raise AssertionError(f"lws cli launches {launches}, want {want}")
    return n_eval


def gru_cli_launches(launches, steps):
    """Every train step K10 +15 / +15, K5 +10, K6 +10; every validation
    batch an eval step (K10 forward +15, K5 +10) and a generation (K10
    forward +10: the hoisted encoders); no other kernel."""
    n_eval = (launches["rect_attention_fwd"] - 10 * steps) // 10
    want = {k: 0 for k in COUNTERS}
    want.update(gru_fwd=15 * steps + 25 * n_eval, gru_bwd=15 * steps,
                rect_attention_fwd=10 * (steps + n_eval),
                rect_attention_bwd=10 * steps)
    if launches != want:
        raise AssertionError(f"gru cli launches {launches}, want {want}")
    return n_eval


def gru_bf16_cli_launches(launches, steps):
    """``trainer.precision=bf16`` on the GRU Metaformer: every train step
    K10's bf16 mode +15 / +15, K5 +2 and K6 +2 in bf16 and +8 / +8 in f32;
    every validation batch in f32, as ``gru_cli_launches``'."""
    n_eval = (launches["rect_attention_fwd"] - 8 * steps) // 10
    want = {k: 0 for k in COUNTERS}
    want.update(gru_bf16_fwd=15 * steps, gru_bf16_bwd=15 * steps,
                gru_fwd=25 * n_eval,
                rect_attention_bf16_fwd=2 * steps,
                rect_attention_bf16_bwd=2 * steps,
                rect_attention_fwd=8 * steps + 10 * n_eval,
                rect_attention_bwd=8 * steps)
    if launches != want:
        raise AssertionError(f"gru bf16 cli launches {launches}, "
                             f"want {want}")
    return n_eval


def simple_cli_launches(launches, steps):
    """Every train step K7 +4 / +4; every validation batch an eval step, K7
    forward +4 (no generation eval); no other kernel."""
    n_eval = (launches["lstm_layer_fwd"] - 4 * steps) // 4
    want = {k: 0 for k in COUNTERS}
    want.update(lstm_layer_fwd=4 * (steps + n_eval), lstm_layer_bwd=4 * steps)
    if launches != want:
        raise AssertionError(f"simple cli launches {launches}, want {want}")
    return n_eval


def render_libs_missing():
    """The rendering's libraries that do not import here (PIL draws the
    frames, matplotlib the nod plots)."""
    import importlib.util

    return [m for m in ("PIL", "matplotlib")
            if importlib.util.find_spec(m) is None]


def speed_log_rates(path):
    """frames/s of each line of a speed.log."""
    with open(path, encoding="utf-8") as f:
        return [float(line.rsplit("(", 1)[1].split()[0]) for line in f]


def eval_cli_phase(mods, run, config, tag, train_tag, per_batch):
    """9b. and 13b. The eval CLI, as a user runs it after training:
    ``infer.cli`` with the yaml at ``config`` at full width on phase 9's
    corpus and the ``last`` checkpoint of the training CLI run
    ``train_tag``, on the card (the flagship with bf16 caches, the CLI's
    default), batches of 8, ``EVAL_RENDER_FRAMES`` comparison frames a
    segment. With PIL and matplotlib it runs ``main`` whole (rendering
    included), else ``evaluate`` and a line that names the missing
    library. Checks: one
    speed.log line per batch, a finite genrt loss, one rendered output
    and one nod.png per segment, exact launches (``per_batch(rows)`` of
    each batch), and the CLI's predictions for its first batch bit-equal
    to a direct generation on that batch. Then the reference-checkpoint
    round trip: ``torch_export`` of ``last``, saved as a Lightning
    ``{"state_dict": {"model.<name>": ...}}``, through ``torch_import``'s
    ``main``: its state_dict equals ``last``'s bit for bit, and
    ``evaluate`` on it gives the CLI's predictions bit for bit."""
    from multimodalreactiongeneration_tpu_torch.configs import load_config
    from multimodalreactiongeneration_tpu_torch.infer import cli
    from multimodalreactiongeneration_tpu_torch.infer.generate import (
        sampling_mask_for,
    )
    from multimodalreactiongeneration_tpu_torch.infer.visualize import (
        generator_for,
    )
    from multimodalreactiongeneration_tpu_torch.models import (
        torch_export,
        torch_import,
    )
    from multimodalreactiongeneration_tpu_torch.train.checkpoint import (
        load_checkpoint,
    )

    config = os.path.abspath(config)  # the run's cwd is ``run``
    last = run / f"ckpt_{train_tag}" / "smoke" / "last"
    out = run / f"eval_{tag}"
    args = ["--config", config, f"data_dir={run / 'corpus'}",
            f"model_path={last}", f"output_path={out}",
            f"log_dir={run / f'log_{tag}'}",
            f"max_render_frames={EVAL_RENDER_FRAMES}"]
    missing = render_libs_missing()
    captured = {}
    orig = cli.generation_speed_log

    def capture(model, model_type, batches, **kw):
        preds = orig(model, model_type, batches, **kw)
        captured.update(model=model, model_type=model_type, batches=batches,
                        preds=preds, at=time.perf_counter())
        return preds

    cwd = os.getcwd()
    os.chdir(run)  # the manifests are phase 9's, under ./data of ``run``
    cli.generation_speed_log = capture
    try:
        zero_counts(mods)
        t0 = time.perf_counter()
        if missing:
            log(tag, rendering="skipped", missing=",".join(missing),
                runs="evaluate (no rendering)")
            _, _, losses = cli.evaluate(load_config(config, args[2:]))
            summary = {"genrt_loss": float(np.mean(losses))}
        else:
            summary = cli.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = counts(mods)
    finally:
        cli.generation_speed_log = orig
        os.chdir(cwd)
    model, batches, preds = (captured["model"], captured["batches"],
                             captured["preds"])
    generation_s = captured["at"] - t0

    rows = [int(b[0].shape[0]) for b in batches]
    want = {k: 0 for k in COUNTERS}
    for r in rows:
        for k, v in per_batch(r).items():
            want[k] += v
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, want {want}")
    rates = speed_log_rates(out / "speed.log")
    if len(rates) != len(batches):
        raise AssertionError(f"{tag}: {len(rates)} speed.log lines for "
                             f"{len(batches)} batches")
    if not np.isfinite(summary["genrt_loss"]):
        raise AssertionError(f"{tag}: genrt_loss {summary['genrt_loss']}")
    segments = sum(rows)
    if not missing:
        outputs = [d for d in sorted(os.listdir(out)) if (out / d).is_dir()]
        rendered = [d for d in outputs if (out / d / f"{d}.mp4").exists()
                    or (out / d / "frame_00000.png").exists()]
        nods = [d for d in outputs if (out / d / "nod.png").exists()]
        if not len(outputs) == len(rendered) == len(nods) == segments:
            raise AssertionError(
                f"{tag}: {len(outputs)} outputs, {len(rendered)} rendered, "
                f"{len(nods)} nod plots for {segments} segments")
    with torch.no_grad():
        full = sampling_mask_for(batches[0][1].shape[1], "full",
                                 device=batches[0][1].device)
        direct = generator_for(captured["model_type"])(
            model, batches[0], full).cpu().numpy()
    first_equal = bool(np.array_equal(direct, preds[0]))
    if not first_equal:
        raise AssertionError(f"{tag}: the CLI's first batch differs from a "
                             "direct generation")
    del model, captured

    # the reference-checkpoint round trip
    t1 = time.perf_counter()
    cfg = load_config(config, args[2:])
    params = load_checkpoint(str(last))["params"]
    exported = torch_export.EXPORTERS[cfg.exp.use_model](
        params, cfg.model.to_dict())
    ref = run / f"reference_{tag}.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in exported.items()},
                "epoch": 0}, ref)
    torch_import.main(["--config", config, "--ckpt", str(ref), "--out",
                       str(run / f"imported_{tag}")])
    imported = load_checkpoint(str(run / f"imported_{tag}" / "last"))["params"]
    same_state = (list(imported) == list(params) and all(
        torch.equal(imported[k], params[k]) for k in params))
    os.chdir(run)
    try:
        again, _, _ = cli.evaluate(load_config(config, [
            *args[2:], f"model_path={run / f'imported_{tag}' / 'last'}",
            f"output_path={run / f'eval_{tag}_imported'}"]))
    finally:
        os.chdir(cwd)
    same_preds = len(again) == len(preds) and all(
        np.array_equal(a, b) for a, b in zip(again, preds))
    round_trip_s = time.perf_counter() - t1
    log(tag, batches=len(batches), segments=segments,
        genrt_loss=f"{summary['genrt_loss']:.6f}", seconds=f"{seconds:.1f}",
        through_generation_s=f"{generation_s:.1f}",
        rendering_s=("skipped" if missing else f"{seconds - generation_s:.1f}"),
        speed_log_frames_per_s=[round(r, 1) for r in rates],
        launches={k: v for k, v in launches.items() if v},
        first_batch_bit_equal_to_direct=first_equal,
        exported_tensors=len(exported), round_trip_state_bit_equal=same_state,
        round_trip_preds_bit_equal=same_preds,
        round_trip_s=f"{round_trip_s:.1f}", card=repr(card_line()))
    if not same_state:
        raise AssertionError(f"{tag}: the imported state_dict differs")
    if not same_preds:
        raise AssertionError(f"{tag}: evaluate on the imported checkpoint "
                             "differs from the CLI's predictions")
    return {"launches": launches, "record": {
        "batches": len(batches), "segments": segments,
        "genrt_loss": summary["genrt_loss"], "seconds": seconds,
        "through_generation_s": generation_s,
        "rendering_s": None if missing else seconds - generation_s,
        "render_libs_missing": missing, "speed_log_frames_per_s": rates,
        "round_trip_s": round_trip_s}}


def metaformer_eval_launches(rows):
    """A flagship eval batch of ``rows`` rows: K1 +2 (the hoisted audio
    and partner-motion encoders), K2 one per 16 rows
    (``decode_rollout.BATCH_PER_LAUNCH``)."""
    return {"mixer_stack": 2, "decode_rollout": -(-rows // 16)}


def lws_eval_launches(rows):
    """An lws eval batch: K9 +1, the sampler's warmup over the lead (the
    rollout's steps are under 16 frames: the plain recurrences)."""
    return {"lstm_stacked_fwd": 1}


def kernel_record(name, source, replaces, launches, max_abs_err, ms,
                  plain_ms, bound_, library_ms, **extra):
    """One entry of the kernels line, with the keys every entry has."""
    return {"name": name, "route": "cuda", "source": SRC + source,
            "replaces": JAX_OPS + replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_[0], "bound_by": bound_[1],
            "library_ms": library_ms, **extra}


def training_records(train, lstm_cases, launches):
    """The JSON entries of the four training kernels (no single PyTorch
    call computes the encoder stack; cuDNN's LSTM is K7's yardstick).
    K7's main case is the Metaformer's (B32 x T252), its second
    lstm_with_sampling's blocks (B256 x T140)."""
    audio, lstm = train[0], lstm_cases[0]
    return [
        kernel_record(
            "mixer_stack_train_fwd", "mixer_stack.cu",
            "pallas_mixer_stack.py:110", launches["mixer_stack_train_fwd"],
            max(c["fwd_max_abs_err"] for c in train), audio["fwd_ms"],
            audio["plain_fwd_ms"], audio["fwd_bound"], None,
            whole_sequence_ms=audio["whole_sequence_fwd_ms"],
            chunk=audio["chunk"], cases=train),
        kernel_record(
            "mixer_stack_bwd", "mixer_stack.cu", "pallas_mixer_stack.py:297",
            launches["mixer_stack_bwd"],
            max(c["grad_max_abs_err"] for c in train), audio["bwd_ms"],
            audio["plain_bwd_ms"], audio["bwd_bound"], None,
            max_rel_err=max(c["grad_max_rel_err"] for c in train),
            whole_sequence_ms=audio["whole_sequence_bwd_ms"],
            chunk=audio["bwd_chunk"]),
        kernel_record(
            "lstm_layer_fwd", "lstm_layer.cu", "pallas_lstm.py:390",
            launches["lstm_layer_fwd"],
            max(c["fwd_max_abs_err"] for c in lstm_cases),
            lstm["fwd_res_ms"], lstm["plain_fwd_ms"], lstm["fwd_bound"],
            lstm["library_fwd_ms"], no_residual_ms=lstm["fwd_ms"],
            cases=lstm_cases),
        kernel_record(
            "lstm_layer_bwd", "lstm_layer.cu", "pallas_lstm.py:448",
            launches["lstm_layer_bwd"],
            max(c["grad_max_abs_err"] for c in lstm_cases), lstm["bwd_ms"],
            lstm["plain_bwd_ms"], lstm["bwd_bound"], lstm["library_bwd_ms"],
            max_rel_err=max(c["grad_max_rel_err"] for c in lstm_cases)),
    ]


def stacked_records(cases, launches, **more_launches):
    """The JSON entries of K9's forward and backward: the main case is
    the sampler in training (B256 x T1120); launches from the lws CLI
    run, those of the generation and training-step phases beside them.
    cuDNN's multi-layer LSTM is the yardstick."""
    main = cases[0]
    extra = {f"launches_{k}": {n: v[n] for n in ("lstm_stacked_fwd",
                                                 "lstm_stacked_bwd")}
             for k, v in more_launches.items()}
    return [
        kernel_record(
            "lstm_stacked_fwd", "lstm_stacked.cu",
            "pallas_lstm_stacked.py:154", launches["lstm_stacked_fwd"],
            max(c["fwd_max_abs_err"] for c in cases), main["fwd_res_ms"],
            main["plain_fwd_ms"], main["fwd_bound"], main["library_fwd_ms"],
            no_residual_ms=main["fwd_ms"],
            no_residual_bound_ms=main["fwd_no_residual_bound"][0],
            cases=cases, **extra),
        kernel_record(
            "lstm_stacked_bwd", "lstm_stacked.cu",
            "pallas_lstm_stacked.py:317", launches["lstm_stacked_bwd"],
            max(c["grad_max_abs_err"] for c in cases), main["bwd_ms"],
            main["plain_bwd_ms"], main["bwd_bound"], main["library_bwd_ms"],
            max_rel_err=max(c["grad_max_rel_err"] for c in cases)),
    ]


def generation_phase(mods, dev, rng, spec):
    """11. and 15. A generation main path at full width (random weights
    from SEED), as ``spec`` names it (tag, model constructor, generate
    function and the launches of one generation), with the full mask on
    3 batches of 16 x 250 frames (lead 12; the first ``batches`` of them
    where the spec names it): shape, finite, launches per generation,
    time; then a teacher-forced f32 generation at batch 2 x
    ``LOOP_FRAMES`` against the same weights and inputs on CPU tensors
    (the all-plain path): <= 1e-4. No profile (cut for room: PERF.md
    quotes their tables)."""
    from multimodalreactiongeneration_tpu_torch.infer.generate import (
        sampling_mask_for,
    )

    tag, generate = spec["tag"], spec["generate"]
    model = spec["model"](dev)
    full = sampling_mask_for(FRAMES, "full", device=dev)
    batches = [[x.to(dev) for x in make_batch(rng, B)]
               for _ in range(3)][:spec.get("batches", 3)]
    generate(model, batches[0], full)  # warm-up, not counted
    torch.cuda.synchronize()
    zero_counts(mods)
    times = []
    for i, bd in enumerate(batches):
        before = counts(mods)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        pred = generate(model, bd, full)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
        if tuple(pred.shape) != (B, FRAMES, MOTION_DIM):
            raise AssertionError(
                f"{tag} generation {i}: shape {tuple(pred.shape)}")
        if not bool(torch.isfinite(pred).all()):
            raise AssertionError(f"{tag} generation {i}: non-finite output")
        d = check_launches(f"{tag} generation {i}", before, counts(mods),
                           **spec["per_generation"])
        log(f"{tag}_generate", batch=i, shape=tuple(pred.shape), finite=True,
            ms=f"{times[-1]:.3f}", launches={k: v for k, v in d.items() if v})
    launches = counts(mods)
    gen_ms = float(np.mean(times))
    frames_per_s = B * FRAMES / (gen_ms / 1000)
    log(f"{tag}_generate", ms_per_generation=f"{gen_ms:.3f}",
        frames_per_s=f"{frames_per_s:.1f}", launches=launches)
    small = first_frames(make_batch(rng, 2), LOOP_FRAMES)
    teacher = sampling_mask_for(LOOP_FRAMES, "teacher")
    on_card = generate(model, [x.to(dev) for x in small], teacher.to(dev),
                       **spec["f32"])
    on_cpu = generate(spec["model"]("cpu"), small, teacher, **spec["f32"])
    err = float((on_card.cpu() - on_cpu).abs().max())
    log(f"{tag}_generate", teacher_f32_batch2_vs_cpu_max_abs_err=f"{err:.3e}")
    if not err <= PATH_TOL:
        raise AssertionError(
            f"{tag} card vs CPU generation: {err} > {PATH_TOL}")
    return {"launches": launches, "record": {
        "batch": B, "frames": FRAMES, "ms": gen_ms,
        "frames_per_s": frames_per_s, "ms_each": times,
        "teacher_batch2_vs_cpu_max_abs_err": err}}


def gru_records(cases, launches, **more_launches):
    """The JSON entries of K10's forward and backward: the main case is an
    audio-encoder block in training (B32 x T2016 x H256); launches from
    the GRU CLI run, those of the generation and training-step phases
    beside them. cuDNN's ``nn.GRU`` is the yardstick."""
    main = cases[0]
    extra = {f"launches_{k}": {n: v[n] for n in ("gru_fwd", "gru_bwd")}
             for k, v in more_launches.items()}
    bwd = [c for c in cases if "bwd_ms" in c]
    return [
        kernel_record(
            "gru_fwd", "gru.cu", "pallas_gru.py:57", launches["gru_fwd"],
            max(c["fwd_max_abs_err"] for c in cases), main["fwd_res_ms"],
            main["plain_fwd_ms"], main["fwd_bound"], main["library_fwd_ms"],
            bound_fp32_ms=main["fwd_bound_fp32"][0],
            us_per_step=main["fwd_res_us_per_step"],
            no_residual_ms=main["fwd_ms"],
            no_residual_bound_ms=main["fwd_no_residual_bound"][0],
            cases=cases, **extra),
        kernel_record(
            "gru_bwd", "gru.cu", "pallas_gru.py:101", launches["gru_bwd"],
            max(c["grad_max_abs_err"] for c in bwd), main["bwd_ms"],
            main["plain_bwd_ms"], main["bwd_bound"], main["library_bwd_ms"],
            bound_fp32_ms=main["bwd_bound_fp32"][0],
            us_per_step=main["bwd_us_per_step"],
            max_rel_err=max(c["grad_max_rel_err"] for c in bwd)),
    ]


def lws_generation_spec():
    """lstm_with_sampling's generation: K9 +1 per generation (the
    sampler's warmup), nothing else; one batch (host-driven steps, ~1.3 s
    a generation)."""
    from multimodalreactiongeneration_tpu_torch.configs import LWS_MODEL_CFG
    from multimodalreactiongeneration_tpu_torch.infer.generate import (
        generate_lws,
    )
    from multimodalreactiongeneration_tpu_torch.models.lstm_with_sampling \
        import LSTMwithSample

    return dict(
        tag="lws", generate=generate_lws, per_generation=dict(
            lstm_stacked_fwd=1), f32={}, batches=1,
        model=lambda device: LSTMwithSample(
            LWS_MODEL_CFG, generator=torch.Generator().manual_seed(SEED),
            device=device))


def gru_generation_spec():
    """The GRU Metaformer's generation, bf16 caches: K10 +10 per
    generation (the hoisted audio and partner-motion encoders, 5 blocks
    each), nothing else; one batch (its host-driven steps take ~4.6 s a
    generation)."""
    from multimodalreactiongeneration_tpu_torch.configs import (
        LSTMFORMER_GRU_MODEL_CFG,
    )
    from multimodalreactiongeneration_tpu_torch.infer.generate import (
        generate_metaformer,
    )
    from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
        Metaformer,
    )

    return dict(
        tag="gru", generate=generate_metaformer, batches=1,
        per_generation=dict(gru_fwd=10), f32=dict(cache_dtype=torch.float32),
        model=lambda device: Metaformer(
            LSTMFORMER_GRU_MODEL_CFG,
            generator=torch.Generator().manual_seed(SEED), device=device))


def simple_generation_phase(mods, dev, rng):
    """19. simple_lstm's generation at full width (random weights from
    SEED): ``sliding_window_generate`` on ``SIMPLE_ROLLOUTS`` rollouts of
    250 frames, batch
    1, one model call per frame over its 120-frame audio window: shape,
    finite, launches per rollout (K7 forward +4 per step), ms per
    rollout; a ``DW0_FRAMES`` rollout under ``MRGEN_FUSED_DW=0`` (K8
    forward +4 per step); then an 8-step f32 rollout against the same
    weights and inputs on CPU tensors (the all-plain path): <= 1e-4."""
    from multimodalreactiongeneration_tpu_torch.configs import (
        SIMPLE_LSTM_MODEL_CFG,
    )
    from multimodalreactiongeneration_tpu_torch.infer.simple_generate import (
        audio_windows,
        sliding_window_generate,
    )
    from multimodalreactiongeneration_tpu_torch.models.simple_lstm import (
        SimpleLSTM,
    )

    def new_model(device):
        return SimpleLSTM(SIMPLE_LSTM_MODEL_CFG,
                          generator=torch.Generator().manual_seed(SEED),
                          device=device)

    def inputs():
        fbank = torch.from_numpy(rng.standard_normal(
            (FRAMES * RATIO + SIMPLE_AUDIO_T, AUDIO_DIM)).astype(np.float32))
        ctx = torch.from_numpy(rng.standard_normal(
            (SIMPLE_CONTEXT, MOTION_DIM)).astype(np.float32))
        return audio_windows(fbank, FRAMES, RATIO, SIMPLE_AUDIO_T), ctx

    model = new_model(dev)
    rollouts = [inputs() for _ in range(SIMPLE_ROLLOUTS + 1)]
    sliding_window_generate(model, rollouts[0][0][:8], rollouts[0][1])
    torch.cuda.synchronize()  # warm-up, not counted

    def rollout(i, windows, ctx, **want):
        before = counts(mods)
        t0 = time.perf_counter()
        pred = sliding_window_generate(model, windows, ctx)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1000
        if tuple(pred.shape) != (len(windows), MOTION_DIM):
            raise AssertionError(f"simple rollout {i}: shape "
                                 f"{tuple(pred.shape)}")
        if not bool(torch.isfinite(pred).all()):
            raise AssertionError(f"simple rollout {i}: non-finite output")
        d = check_launches(f"simple rollout {i}", before, counts(mods),
                           **want)
        log("simple_generate", rollout=i, shape=tuple(pred.shape),
            finite=True, ms=f"{ms:.3f}",
            launches={k: v for k, v in d.items() if v})
        return ms

    zero_counts(mods)
    times = [rollout(i, w, c, lstm_layer_fwd=4 * FRAMES)
             for i, (w, c) in enumerate(rollouts[:SIMPLE_ROLLOUTS])]
    launches = counts(mods)
    gen_ms = float(np.mean(times))
    log("simple_generate", ms_per_rollout=f"{gen_ms:.3f}",
        frames_per_s=f"{FRAMES / (gen_ms / 1000):.1f}", launches=launches)
    with fused_dw("0"):
        zero_counts(mods)
        windows, ctx = rollouts[0]
        off_ms = rollout("fused_dw_0", windows[:DW0_FRAMES], ctx,
                         lstm_recurrence_fwd=4 * DW0_FRAMES)
        launches_off = counts(mods)

    windows, ctx = rollouts[-1]
    on_card = sliding_window_generate(model, windows[:8], ctx)
    on_cpu = sliding_window_generate(new_model("cpu"), windows[:8], ctx,
                                     device="cpu")
    err = float((on_card.cpu() - on_cpu).abs().max())
    log("simple_generate", f32_8_steps_vs_cpu_max_abs_err=f"{err:.3e}")
    if not err <= PATH_TOL:
        raise AssertionError(f"simple card vs CPU rollout: {err} > {PATH_TOL}")
    return {"launches": launches, "launches_fused_dw_0": launches_off,
            "record": {"batch": 1, "frames": FRAMES, "ms": gen_ms,
                       "frames_per_s": FRAMES / (gen_ms / 1000),
                       "ms_each": times, "fused_dw_0_frames": DW0_FRAMES,
                       "fused_dw_0_ms": off_ms,
                       "f32_8_steps_vs_cpu_max_abs_err": err}}


def percentiles(values):
    return {f"p{q}": float(np.percentile(values, q)) for q in (50, 95, 99)}


def fmt(d):
    return {k: round(v, 3) for k, v in d.items()}


def flagship(cfg, device, **changes):
    from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
        Metaformer,
    )

    return Metaformer(dict(cfg, **changes),
                      generator=torch.Generator().manual_seed(SEED),
                      device=device)


def lead_arrays(rng, batch=1, lead=LEAD):
    """A leading segment in feature space: audio, partner, self."""
    return tuple(rng.standard_normal(s).astype(np.float32) for s in (
        (batch, lead * RATIO, AUDIO_DIM), (batch, lead, MOTION_DIM),
        (batch, lead, MOTION_DIM)))


def decode_layouts_phase(mods, dev, cfg):
    """22. The decode layouts on the flagship, B16 x ``LAYOUT_FRAMES``
    frames (lead 12), batch from ``SEED + 22``: teacher-forced f32, the
    per-block and the in-loop shared layouts against the hoisted K2 path
    (<= 1e-4), per-block int8 against per-block bf16 (<= ``INT8_TOL``),
    per-block f32 at batch 2 against the same call on CPU tensors (<=
    1e-4); each layout timed with the full mask after its teacher-forced
    run; a ``repeat_with_encoder`` flagship and an mha-embedding flagship
    (finite, timed). Launches per generation, exact: K1 +1 and K2 +0
    in the loop, K1 +5 with repeat_with_encoder, none with mha
    embeddings, K1 +2 and K2 +1 on the hoisted path."""
    from multimodalreactiongeneration_tpu_torch.infer import generate as G

    rng = np.random.default_rng(SEED + 22)
    model = flagship(cfg, dev)
    batch = [x.to(dev) for x in make_batch(rng, B, frames=LAYOUT_FRAMES)]
    masks = {m: G.sampling_mask_for(LAYOUT_FRAMES, m, device=dev)
             for m in ("teacher", "full")}
    f32, int8 = dict(cache_dtype=torch.float32), dict(cache_dtype=torch.int8)
    per_block = dict(kv_layout="per_block")
    in_loop = dict(kv_layout="shared", hoist_encoders=False)
    in_loop_k = dict(mixer_stack=1)
    hoisted_k = dict(mixer_stack=2, decode_rollout=1)
    record = {"batch": B, "frames": LAYOUT_FRAMES, "ms": {}, "launches": {}}

    def run(tag, mask, want, net=model, **kw):
        torch.cuda.synchronize()
        before = counts(mods)
        t0 = time.perf_counter()
        pred = G.generate_metaformer(net, batch, masks[mask], **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1000
        if tuple(pred.shape) != (B, LAYOUT_FRAMES, MOTION_DIM):
            raise AssertionError(f"{tag}: shape {tuple(pred.shape)}")
        if not bool(torch.isfinite(pred).all()):
            raise AssertionError(f"{tag}: non-finite output")
        d = check_launches(tag, before, counts(mods), **want)
        if mask == "full":
            record["ms"][tag] = ms
            record["launches"][tag] = {k: v for k, v in d.items() if v}
        log("decode_layouts", layout=tag, mask=mask, ms=f"{ms:.3f}",
            launches={k: v for k, v in d.items() if v})
        return pred

    zero_counts(mods)
    ref = run("hoisted_f32", "teacher", hoisted_k, **f32)
    errs = {
        "per_block_f32": float((run("per_block_f32", "teacher", in_loop_k,
                                    **f32, **per_block) - ref).abs().max()),
        "in_loop_f32": float((run("in_loop_f32", "teacher", in_loop_k,
                                  **f32, **in_loop) - ref).abs().max()),
    }
    bf16 = run("per_block_bf16", "teacher", in_loop_k, **per_block)
    errs["int8_vs_bf16"] = float(
        (run("per_block_int8", "teacher", in_loop_k, **int8).float()
         - bf16.float()).abs().max())
    for tag, want, kw in (
            ("hoisted_bf16", hoisted_k, {}),
            ("per_block_bf16", in_loop_k, per_block),
            ("per_block_int8", in_loop_k, int8),
            ("in_loop_bf16", in_loop_k, in_loop)):
        run(tag, "full", want, **kw)
    for tag, want, changes in (
            ("repeat_with_encoder", dict(mixer_stack=5),
             dict(repeat_with_encoder=True)),
            ("mha_embeddings", {}, dict(emb_mixers=["mha", "mha", "mha"]))):
        net = flagship(cfg, dev, **changes)
        run(tag, "teacher", want, net=net)  # warm-up
        run(tag, "full", want, net=net)
        del net

    small = [x[:2] for x in batch]
    teacher = masks["teacher"].cpu()
    on_card = G.generate_metaformer(model, small, teacher.to(dev), **f32,
                                    **per_block)
    on_cpu = G.generate_metaformer(flagship(cfg, "cpu"),
                                   [x.cpu() for x in small], teacher, **f32,
                                   **per_block)
    errs["per_block_f32_batch2_vs_cpu"] = float(
        (on_card.cpu() - on_cpu).abs().max())
    log("decode_layouts", **{f"{k}_max_abs_err": f"{v:.3e}"
                             for k, v in errs.items()})
    for key, tol in (("per_block_f32", PATH_TOL), ("in_loop_f32", PATH_TOL),
                     ("int8_vs_bf16", INT8_TOL),
                     ("per_block_f32_batch2_vs_cpu", PATH_TOL)):
        if not errs[key] <= tol:
            raise AssertionError(f"decode layouts {key}: {errs[key]} > {tol}")
    record["max_abs_err"] = errs
    return record


def streaming_phase(mods, dev, cfg):
    """23. A flagship ``StreamingSession``, batch 1, bf16 rings: ``prime``
    on 12 lead frames (K1 +1), then ``STREAM_STEPS`` steps of random audio
    (10 s of dialogue; no launch), from ``SEED + 23``; per-step ms to the
    returned frame; the streamed fbank of those hops against the offline
    fbank of the whole signal on the card (equal bits, or within 1e-6 of
    the features' largest magnitude);
    the first 4 steps against a session on CPU tensors (<= 5e-2, the bf16
    drift bound)."""
    from multimodalreactiongeneration_tpu_torch.infer.streaming import (
        StreamingSession,
    )
    from multimodalreactiongeneration_tpu_torch.ops import dsp

    rng = np.random.default_rng(SEED + 23)
    session = StreamingSession(flagship(cfg, dev))
    lead = lead_arrays(rng)
    hop = session.hop_samples
    audio = (0.1 * rng.standard_normal((STREAM_STEPS, 1, hop))).astype(
        np.float32)
    mp = rng.standard_normal((STREAM_STEPS, 1, 1, MOTION_DIM)).astype(
        np.float32)
    zero_counts(mods)
    torch.cuda.synchronize()
    before = counts(mods)
    t0 = time.perf_counter()
    session.prime(*lead)
    torch.cuda.synchronize()
    prime_ms = (time.perf_counter() - t0) * 1000
    check_launches("stream prime", before, counts(mods), mixer_stack=1)
    before = counts(mods)
    outs, step_ms = [], []
    for t in range(STREAM_STEPS):
        t0 = time.perf_counter()
        outs.append(session.step(audio[t], mp[t]))
        step_ms.append((time.perf_counter() - t0) * 1000)
    check_launches("stream steps", before, counts(mods))
    launches = counts(mods)
    outs = np.concatenate(outs, axis=1)
    if outs.shape != (1, STREAM_STEPS, MOTION_DIM) or not np.isfinite(
            outs).all():
        raise AssertionError(f"stream: shape {outs.shape} or non-finite")

    fbp, context = session.fb_params, session.context_samples
    wave = torch.from_numpy(audio.reshape(-1)).to(dev)
    tail = torch.zeros(context, device=dev)
    chunks = []
    for t in range(STREAM_STEPS):
        buf = torch.cat([tail, wave[t * hop:(t + 1) * hop]])
        tail = buf[-context:]
        chunks.append(dsp.logmel_with_power(buf, fbp))
    streamed = torch.cat(chunks)[context // fbp.hop:]
    offline = dsp.logmel_with_power(wave, fbp)
    n = min(len(streamed), len(offline))
    fbank_err = float((streamed[:n] - offline[:n]).abs().max())
    fbank_scale = float(offline[:n].abs().max())
    fbank_equal = torch.equal(streamed[:n], offline[:n])

    cpu = StreamingSession(flagship(cfg, "cpu"))
    cpu.prime(*lead)
    on_cpu = np.concatenate([cpu.step(audio[t], mp[t]) for t in range(4)],
                            axis=1)
    cpu_err = float(np.abs(outs[:, :4] - on_cpu).max())
    pct = percentiles(step_ms)
    log("streaming", prime_ms=f"{prime_ms:.3f}", step_ms=fmt(pct),
        hop_ms=HOP_MS, fbank_frames=n, fbank_bit_equal=fbank_equal,
        fbank_max_abs_err=f"{fbank_err:.3e}",
        fbank_max_abs=f"{fbank_scale:.3f}",
        first4_vs_cpu_max_abs_err=f"{cpu_err:.3e}")
    # the card's matrix products block the sums of a 10-row and a
    # 1000-row frame matrix differently: an f32 ulp or two of the
    # features' magnitude
    if not fbank_err <= 1e-6 * fbank_scale:
        raise AssertionError(
            f"streamed vs offline fbank: {fbank_err} > 1e-6 x {fbank_scale}")
    if not cpu_err <= K2_BF16_TOL:
        raise AssertionError(f"stream card vs CPU: {cpu_err} > {K2_BF16_TOL}")
    return {"steps": STREAM_STEPS, "launches": launches,
            "prime_ms": prime_ms, "step_ms": pct,
            "step_ms_each": step_ms, "fbank_frames": n,
            "fbank_bit_equal": fbank_equal, "fbank_max_abs_err": fbank_err,
            "fbank_max_abs": fbank_scale,
            "first4_vs_cpu_max_abs_err": cpu_err}


def serving_phase(mods, dev, cfg):
    """24. A flagship ``ServingEngine``, bf16 shared layout, at each of
    ``SERVE_SLOTS`` slots, ``SERVE_STEPS`` steps from ``SEED + 24``: slot s
    attaches at step 2s, slots 1 and 2 detach and reattach halfway;
    launches K1 +1 per attach, none per step; detached rows zero; step ms
    p50/p95/p99, attach ms. Gates (16 slots): slot 0's outputs equal those
    of an engine where slot 0 runs alone with the other rows zero (bits,
    or <= 1e-6); with f32 rings a slot against a batch-1
    ``StreamingSession`` on the same lead and inputs over 4 steps (<=
    1e-4); an int8 engine against the bf16 one over 4 steps (<= 1e-1)."""
    from multimodalreactiongeneration_tpu_torch.infer.generate import (
        _init_metaformer_states,
    )
    from multimodalreactiongeneration_tpu_torch.infer.serving import (
        ServingEngine,
    )
    from multimodalreactiongeneration_tpu_torch.infer.streaming import (
        StreamingSession,
        fbank_stream_geometry,
    )

    rng = np.random.default_rng(SEED + 24)
    model = flagship(cfg, dev)
    hop = fbank_stream_geometry(cfg)[2]

    def inputs(slots):
        return ((0.1 * rng.standard_normal((slots, hop))).astype(np.float32),
                rng.standard_normal((slots, 1, MOTION_DIM)).astype(
                    np.float32))

    def attach(engine, lead, times):
        torch.cuda.synchronize()
        before = counts(mods)
        t0 = time.perf_counter()
        slot = engine.attach(*lead)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000)
        check_launches("serve attach", before, counts(mods), mixer_stack=1)
        return slot

    def step(engine, a, m, times=None):
        before = counts(mods)
        t0 = time.perf_counter()
        out = engine.step(a, m)
        if times is not None:
            times.append((time.perf_counter() - t0) * 1000)
        check_launches("serve step", before, counts(mods))
        if not np.isfinite(out).all() or (out[~engine.active] != 0).any():
            raise AssertionError("serve step: non-finite or detached row")
        return out

    record, slot0 = {}, {}
    for slots in SERVE_SLOTS:
        engine = ServingEngine(model, slots=slots)
        zero_counts(mods)
        attach_ms, step_ms, outs0 = [], [], []
        feeds = [inputs(slots) for _ in range(SERVE_STEPS)]
        leads = {}
        for t in range(SERVE_STEPS):
            if t == SERVE_STEPS // 2:
                for s in (1, 2):
                    engine.detach(s)
                for s in (1, 2):
                    attach(engine, lead_arrays(rng), attach_ms)
            if t % 2 == 0 and t // 2 < slots:
                leads[t // 2] = lead_arrays(rng)
                attach(engine, leads[t // 2], attach_ms)
            outs0.append(step(engine, *feeds[t], step_ms)[0])
        launches = counts(mods)
        pct = percentiles(step_ms[1:])  # the first step is a warm-up
        record[slots] = {"step_ms": pct, "attach_ms": float(np.mean(
            attach_ms)), "attach_ms_max": float(np.max(attach_ms)),
            "attaches": len(attach_ms), "attached_at_end":
            int(engine.active.sum()), "launches": launches,
            "step_ms_each": step_ms}
        log("serving", slots=slots, step_ms=fmt(pct), hop_ms=HOP_MS,
            attach_ms=f"{record[slots]['attach_ms']:.3f}",
            attaches=len(attach_ms), attached=int(engine.active.sum()),
            launches={k: v for k, v in launches.items() if v})
        if slots == SERVE_SLOTS[0]:
            slot0 = {"lead": leads[0], "feeds": feeds, "outs": outs0}
        del engine

    alone = ServingEngine(model, slots=SERVE_SLOTS[0])
    attach(alone, slot0["lead"], [])
    outs = []
    for a, m in slot0["feeds"]:
        a0, m0 = np.zeros_like(a), np.zeros_like(m)
        a0[0], m0[0] = a[0], m[0]
        outs.append(step(alone, a0, m0)[0])
    isolation_err = float(np.abs(np.stack(outs)
                                 - np.stack(slot0["outs"])).max())
    isolation_equal = bool((np.stack(outs) == np.stack(slot0["outs"])).all())
    del alone

    errs = {"slot_isolation": isolation_err}
    leads = [lead_arrays(rng) for _ in range(3)]
    feeds = [inputs(SERVE_SLOTS[0]) for _ in range(4)]
    got = {}
    for name, dtype in (("f32", torch.float32), ("bf16", None),
                        ("int8", torch.int8)):
        engine = ServingEngine(model, slots=SERVE_SLOTS[0], cache_dtype=dtype)
        for lead in leads:
            attach(engine, lead, [])
        got[name] = np.stack([step(engine, a, m) for a, m in feeds], 1)
        del engine
    session = StreamingSession(model)
    session.states = _init_metaformer_states(cfg, 1, torch.float32,
                                             "shared", device=dev)
    session.prime(*leads[1])
    alone = np.concatenate([session.step(a[1:2], m[1:2]) for a, m in feeds])
    errs["slot_vs_session_f32"] = float(np.abs(got["f32"][1] - alone).max())
    errs["int8_vs_bf16"] = float(
        np.abs(got["int8"][:3] - got["bf16"][:3]).max())
    fits = [s for s in SERVE_SLOTS if record[s]["step_ms"]["p95"] <= HOP_MS]
    log("serving", slot_isolation_bit_equal=isolation_equal,
        **{f"{k}_max_abs_err": f"{v:.3e}" for k, v in errs.items()},
        slots_within_hop_at_p95=max(fits, default=0))
    for key, tol in (("slot_isolation", 1e-6),
                     ("slot_vs_session_f32", PATH_TOL),
                     ("int8_vs_bf16", INT8_TOL)):
        if not errs[key] <= tol:
            raise AssertionError(f"serving {key}: {errs[key]} > {tol}")
    return {"slots": {str(k): v for k, v in record.items()},
            "steps": SERVE_STEPS, "slot_isolation_bit_equal": isolation_equal,
            "max_abs_err": errs, "slots_within_hop_at_p95": max(fits,
                                                                default=0)}


# ---- 25.-28. the training options ---------------------------------------

def grads_equal(a, b):
    """True when every gradient of model ``a`` equals ``b``'s bit for
    bit."""
    named = dict(b.named_parameters())
    return all(torch.equal(p.grad, named[n].grad)
               for n, p in a.named_parameters())


def scheduled_sampling_phase(mods, dev, spec, n):
    """25. and 26. A scheduled-sampling training step
    (``scheduled_sampling_step_fn``, gradients through the AR rollout) of
    ``spec``'s model at full width: ``SS_STEPS`` steps at rate
    ``SS_RATE`` from the phase's own generators (``SEED + n``), the
    launches of each exact (the warmup over the lead: the Metaformer's
    audio stack K3 +1 / K4 +1, lws's sampler K9 +1 / +1; the 8-frame
    steps run the plain recurrences), ms a step and the peak memory; then
    the card against CPU tensors at B2, the same weights, SGD lr 0: the
    all-False mask over T24 (teacher-forced; cut from T48 for room), and
    rate 1 over 8 steps:
    loss within ``LOSS_REL_TOL`` relative, every gradient within
    ``GRAD_REL_TOL`` of its parameter's largest (phase 8's bounds)."""
    from multimodalreactiongeneration_tpu_torch.train.harness import (
        scheduled_sampling_masked_step_fn,
        scheduled_sampling_step_fn,
    )
    from multimodalreactiongeneration_tpu_torch.train.optim import (
        build_optimizer,
    )

    tag = "ss_" + spec["tag"]
    rng = np.random.default_rng(SEED + n)
    model_cfg = {**spec["cfg"], **spec["loss"]}
    model = spec_model(spec, dev)
    opt = build_optimizer(model.parameters(), spec["optim"])
    step = scheduled_sampling_step_fn(model, spec["model_type"], model_cfg,
                                      spec["metrics"], opt)
    gen = torch.Generator().manual_seed(SEED + n)
    batch = spec_batch(spec, rng, spec["batch"], dev)
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(mods)
    for i in range(SS_STEPS):
        before = counts(mods)
        t0 = time.perf_counter()
        loss, _ = step(batch, gen, SS_RATE)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000)
        check_launches(f"{tag} {i}", before, counts(mods), **spec["per_step"])
        losses.append(float(loss))
    launches = counts(mods)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: non-finite losses {losses}")
    log(tag, batch=spec["batch"], frames=spec["frames"], lead=LEAD,
        rate=SS_RATE, ms_per_step=f"{np.mean(times):.3f}",
        step_ms=[round(t, 3) for t in times], losses=losses,
        peak_mem_gib=f"{peak_gib:.3f}",
        launches={k: v for k, v in launches.items() if v})
    del step, opt, model, batch

    sgd0 = dict(use_optimizer="sgd", lr=0.0, momentum=0.0, weight_decay=0.0)
    gates = {}
    for case, frames, mask in (("teacher_T24", 24, False),
                               ("rate1_T8", 8, True)):
        host = spec_batch(spec, rng, 2, frames=frames)
        mask_steps = torch.full((frames,), mask)
        models = {}
        for where in ("card", "cpu"):
            m = spec_model(spec, dev if where == "card" else "cpu")
            masked = scheduled_sampling_masked_step_fn(
                m, spec["model_type"], model_cfg, spec["metrics"],
                build_optimizer(m.parameters(), sgd0))
            loss, _ = masked(host if where == "cpu" else to_device(host, dev),
                             mask_steps)
            models[where] = (m, float(loss))
        (card, loss_card), (cpu, loss_cpu) = models["card"], models["cpu"]
        loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
        worst, worst_name = grad_rel_errs(card, cpu)
        gates[case] = {"loss_rel_err": loss_rel, "grad_max_rel_err": worst,
                       "worst": worst_name}
        log(tag, gate=f"card_vs_cpu_{case}", loss_card=f"{loss_card:.7f}",
            loss_cpu=f"{loss_cpu:.7f}", loss_rel_err=f"{loss_rel:.3e}",
            grad_max_rel_err=f"{worst:.3e}", worst=worst_name)
        if not loss_rel <= LOSS_REL_TOL:
            raise AssertionError(
                f"{tag} {case} card vs CPU loss: {loss_rel} > {LOSS_REL_TOL}")
        if not worst <= GRAD_REL_TOL:
            raise AssertionError(
                f"{tag} {case} card vs CPU gradient of {worst_name}: "
                f"{worst} > {GRAD_REL_TOL}")
        del models, card, cpu
    return {"launches": launches, "record": {
        "batch": spec["batch"], "frames": spec["frames"], "rate": SS_RATE,
        "steps": SS_STEPS, "ms": float(np.mean(times)), "ms_each": times,
        "losses": losses, "peak_mem_gib": peak_gib,
        "card_vs_cpu": gates}}


@contextlib.contextmanager
def plain_route():
    """The modules' LSTM layers and integrator attention on their plain
    PyTorch versions inside, on any device (the kernels' wrappers
    otherwise launch them on CUDA tensors)."""
    from multimodalreactiongeneration_tpu_torch.nn import attention, recurrent
    from multimodalreactiongeneration_tpu_torch.ops.lstm_layer import (
        lstm_layer_reference,
    )
    from multimodalreactiongeneration_tpu_torch.ops.rect_attention import (
        rect_attention_reference,
    )

    saved = recurrent.lstm_layer, attention.rect_attention
    recurrent.lstm_layer = lstm_layer_reference
    attention.rect_attention = rect_attention_reference
    try:
        yield
    finally:
        recurrent.lstm_layer, attention.rect_attention = saved


def dropout_phase(mods, dev, spec, n):
    """27. A training step of ``spec``'s model with dropout on, at its
    phase-8/12 shape, masks from the phase's own generators (``SEED +
    n``): a warm-up and ``TRAIN_STEPS`` timed steps with the spec's
    optimizer, the launches of each exact (active dropout takes the
    encoders and samplers off the fused stack and the stacked LSTM, JAX's
    gates: K7 per block and per layer, no K3, K4 or K9), the eval step's
    as without dropout; then, with SGD lr 0 and one seed, two kernel-route
    steps (the same bits) and a plain-route step on the card
    (``plain_route``: the same masks): loss within ``LOSS_REL_TOL``,
    every gradient within ``GRAD_REL_TOL`` of its plain parameter's
    largest."""
    tag = "dropout_" + spec["tag"]
    rng = np.random.default_rng(SEED + n)
    batch = spec_batch(spec, rng, spec["batch"], dev)
    model = spec_model(spec, dev)
    train_step, eval_step = spec_step_fns(spec, model, spec["optim"])
    gen = torch.Generator().manual_seed(SEED + n)
    train_step(batch, gen)  # warm-up, not counted
    torch.cuda.synchronize()
    zero_counts(mods)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        before = counts(mods)
        t0 = time.perf_counter()
        loss, _ = train_step(batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000)
        check_launches(f"{tag} {i}", before, counts(mods), **spec["per_step"])
        losses.append(float(loss))
    launches = counts(mods)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: non-finite losses {losses}")
    before = counts(mods)
    eval_step(batch)
    check_launches(f"{tag} eval", before, counts(mods), **spec["per_eval"])
    log(tag, batch=spec["batch"], frames=spec["frames"],
        ms_per_step=f"{np.mean(times):.3f}",
        step_ms=[round(t, 3) for t in times], losses=losses,
        peak_mem_gib=f"{peak_gib:.3f}",
        launches={k: v for k, v in launches.items() if v})
    del train_step, eval_step, model

    sgd0 = dict(use_optimizer="sgd", lr=0.0, momentum=0.0, weight_decay=0.0)
    runs = []
    for route in ("kernel", "kernel", "plain"):
        m = spec_model(spec, dev)
        step, _ = spec_step_fns(spec, m, sgd0)
        with plain_route() if route == "plain" else contextlib.nullcontext():
            before = counts(mods)
            loss, _ = step(batch, torch.Generator().manual_seed(SEED + n))
            torch.cuda.synchronize()
            if route == "plain":
                check_launches(f"{tag} plain route", before, counts(mods))
        runs.append((m, float(loss)))
    (k1, loss1), (k2, loss2), (plain, loss_plain) = runs
    bits = loss1 == loss2 and grads_equal(k1, k2)
    loss_rel = abs(loss1 - loss_plain) / abs(loss_plain)
    worst, worst_name = grad_rel_errs(k1, plain)
    log(tag, run_to_run_bit_equal=bits, loss=f"{loss1:.7f}",
        loss_plain=f"{loss_plain:.7f}", loss_rel_err=f"{loss_rel:.3e}",
        grad_max_rel_err=f"{worst:.3e}", worst=worst_name)
    if not bits:
        raise AssertionError(f"{tag}: two steps from one seed differ")
    if not loss_rel <= LOSS_REL_TOL:
        raise AssertionError(
            f"{tag} kernel vs plain loss: {loss_rel} > {LOSS_REL_TOL}")
    if not worst <= GRAD_REL_TOL:
        raise AssertionError(f"{tag} kernel vs plain gradient of "
                             f"{worst_name}: {worst} > {GRAD_REL_TOL}")
    del runs, k1, k2, plain
    return {"launches": launches, "record": {
        "batch": spec["batch"], "frames": spec["frames"],
        "ms": float(np.mean(times)), "ms_each": times, "losses": losses,
        "peak_mem_gib": peak_gib, "run_to_run_bit_equal": bits,
        "kernel_vs_plain_loss_rel_err": loss_rel,
        "kernel_vs_plain_grad_max_rel_err": worst}}


def remat_accumulation_phase(mods, dev, n):
    """28. The flagship step at B32 x T240, batches from ``SEED + n``:
    with ``remat=True`` against the plain step (SGD lr 0, the same
    weights): the same loss and gradients bit for bit, the launches of
    each exact (remat runs every forward kernel twice: K3 +4, K7 +10, K5
    +20; the backward kernels once), their ms and peak memory; then
    AdamW with ``accumulate_grad_batches=2`` over two micro-batches
    (the first leaves the parameters as they were) against one AdamW
    update on the mean (g1 + g2) / 2 of their gradients: each parameter
    within ``ACCUM_REL_TOL`` of its largest magnitude (MultiSteps takes
    the mean as g1 + (g2 - g1) / 2, so the two may differ in the last
    bit of a parameter)."""
    from multimodalreactiongeneration_tpu_torch.train.harness import (
        streaming_step_fns,
    )
    from multimodalreactiongeneration_tpu_torch.train.optim import (
        build_optimizer,
    )

    spec = metaformer_train_spec()
    rng = np.random.default_rng(SEED + n)
    b1, b2 = (spec_batch(spec, rng, TRAIN_B, dev) for _ in range(2))
    model_cfg = {**spec["cfg"], **spec["loss"]}
    sgd0 = dict(use_optimizer="sgd", lr=0.0, momentum=0.0, weight_decay=0.0)
    per_step = spec["per_step"]
    remat_step = {k: v * (2 if k.endswith("fwd") else 1)
                  for k, v in per_step.items()}
    runs = {}
    for remat, want in ((False, per_step), (True, remat_step)):
        model = spec_model(spec, dev)
        step, _ = streaming_step_fns(
            model, model_cfg, spec["metrics"],
            build_optimizer(model.parameters(), sgd0), spec["mask_self"],
            remat=remat)
        step(b1)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = counts(mods)
        t0 = time.perf_counter()
        loss, _ = step(b1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1000
        got = check_launches(f"remat={remat}", before, counts(mods), **want)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        runs[remat] = (model, float(loss), ms, peak, got)
        log("remat_step", remat=remat, ms=f"{ms:.3f}",
            peak_mem_gib=f"{peak:.3f}", loss=f"{float(loss):.7f}",
            launches={k: v for k, v in got.items() if v})
    bits = (runs[True][1] == runs[False][1]
            and grads_equal(runs[True][0], runs[False][0]))
    log("remat_step", bit_equal_to_plain=bits)
    if not bits:
        raise AssertionError("remat step differs from the plain step")
    launches = runs[True][4]
    record = {"remat": {"bit_equal_to_plain": bits,
                        **{("remat" if r else "plain"): {
                            "ms": v[2], "peak_mem_gib": v[3], "loss": v[1]}
                           for r, v in runs.items()}}}
    del runs

    accum = spec_model(spec, dev)
    p0 = {k: p.detach().clone() for k, p in accum.named_parameters()}
    step, _ = streaming_step_fns(
        accum, model_cfg, spec["metrics"],
        build_optimizer(accum.parameters(), spec["optim"],
                        accumulate_grad_batches=2), spec["mask_self"])
    step(b1)
    moved = max(float((p.detach() - p0[k]).abs().max())
                for k, p in accum.named_parameters())
    step(b2)
    once = spec_model(spec, dev)
    grab, _ = streaming_step_fns(
        once, model_cfg, spec["metrics"],
        build_optimizer(once.parameters(), sgd0), spec["mask_self"])
    grads = []
    for b in (b1, b2):
        grab(b)
        grads.append([p.grad.clone() for p in once.parameters()])
    adam = build_optimizer(once.parameters(), spec["optim"])
    for p, g1, g2 in zip(once.parameters(), *grads):
        p.grad = (g1 + g2) / 2
    adam.step()
    named = {k: p.detach() for k, p in once.named_parameters()}
    rel = max(float((p.detach() - named[k]).abs().max())
              / float(named[k].abs().max())
              for k, p in accum.named_parameters())
    update = max(float((p - p0[k]).abs().max()) for k, p in named.items())
    log("accumulate_grad_batches", k=2, moved_after_first=moved,
        max_update=f"{update:.3e}", max_rel_err=f"{rel:.3e}")
    if moved != 0.0:
        raise AssertionError(f"accumulation: the first micro-step moved the "
                             f"parameters by {moved}")
    if not rel <= ACCUM_REL_TOL:
        raise AssertionError(
            f"accumulation vs the mean gradient's update: {rel} > "
            f"{ACCUM_REL_TOL}")
    record["accumulation"] = {"k": 2, "rel_err": rel, "max_update": update}
    return {"launches": launches, "record": record}


def train_options_phases(mods, dev):
    """25.-28. The training options on the flagship and lws; returns each
    phase's launches and record by key."""
    from multimodalreactiongeneration_tpu_torch import configs

    flagship, lws = metaformer_train_spec(), lws_train_spec()
    phases = {
        "ss_flagship": lambda: scheduled_sampling_phase(mods, dev, dict(
            flagship, model_type="lstmformer", batch=SS_B, frames=SS_FRAMES,
            per_step=dict(mixer_stack_train_fwd=1, mixer_stack_bwd=1)), 25),
        "ss_lws": lambda: scheduled_sampling_phase(mods, dev, dict(
            lws, model_type="lstm_with_sampling", batch=SS_LWS_B,
            per_step=dict(lstm_stacked_fwd=1, lstm_stacked_bwd=1)), 26),
        "dropout_flagship": lambda: dropout_phase(mods, dev, dict(
            flagship,
            cfg=dict(configs.LSTMFORMER_MODEL_CFG, dropout=DROPOUT),
            per_step=dict(lstm_layer_fwd=15, lstm_layer_bwd=15,
                          rect_attention_fwd=10, rect_attention_bwd=10)), 27),
        "dropout_lws": lambda: dropout_phase(mods, dev, dict(
            lws, cfg=dict(configs.LWS_MODEL_CFG, dropout_rate=DROPOUT,
                          sampler_dropout_rate=DROPOUT),
            per_step=dict(lstm_layer_fwd=4, lstm_layer_bwd=4)), 27),
        "remat_step": lambda: remat_accumulation_phase(mods, dev, 28),
    }
    return {k: run() for k, run in phases.items()}


def bound_bf16(flops, bytes_):
    """(ms, "operations" or "bytes") of a bf16 mode: its products as bf16
    tensor-core operations at 989 TFLOP/s (dense), or its bytes (each
    input read once, each output written once) at 3.35 TB/s."""
    t_ops = flops / PEAK_BF16 * 1e3
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bf16_check(name, outs, grads, want_outs, want_grads, ys_f32, short,
               tol=None, mode_frac=BF16_MODE_FRAC, mode_steps=None, **kv):
    """A bf16 mode's outputs and gradients against its plain bf16
    version's: within ``tol``, by default ``BF16_SHORT_TOL`` at a short T
    and ``BF16_FULL_TOL`` over the full length (forward abs; the f32 and
    the bf16 gradients relative to their largest magnitude); each
    gradient in its input's dtype; and (``mode_frac`` not None) the
    kernel's ys on average at most ``mode_frac`` as far from the plain
    bf16 ys as the plain f32 ys is (a kernel that took f32 operands would
    not be; over the first ``mode_steps`` rows of the time axis where
    given). Returns the errors."""
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        if g.dtype != w.dtype:
            raise AssertionError(f"{name} {kv}: gradient {i} is {g.dtype}, "
                                 f"the plain version's {w.dtype}")
    pairs = {dt: [(g.float(), w.float()) for g, w in zip(grads, want_grads)
                  if (g.dtype == torch.bfloat16) == (dt == "bf16")]
             for dt in ("f32", "bf16")}
    fwd = max_err(outs, want_outs)
    mean_gap = lambda a, b: float((a.detach().float() - b).abs().mean())
    window = slice(None) if mode_steps is None else slice(0, mode_steps)
    gap = mean_gap(ys_f32[0][:, window], want_outs[0][:, window])
    ys_err = mean_gap(outs[0][:, window], want_outs[0][:, window])
    if tol is None:
        tol = BF16_SHORT_TOL if short else BF16_FULL_TOL
    g32, g16 = (rel_err(*zip(*pairs[dt])) if pairs[dt] else 0.0
                for dt in ("f32", "bf16"))
    log(name, fwd_max_abs_err=f"{fwd:.3e}", grad_f32_max_rel_err=f"{g32:.3e}",
        grad_bf16_max_rel_err=f"{g16:.3e}", ys_mean_abs_err=f"{ys_err:.3e}",
        plain_f32_vs_bf16_ys_mean=f"{gap:.3e}", mode_steps=mode_steps,
        **kv)
    if not (fwd <= tol[0] and g32 <= tol[1] and g16 <= tol[2]):
        raise AssertionError(f"{name} {kv}: errors {fwd}, {g32}, {g16} "
                             f"beyond {tol}")
    if mode_frac is not None and not ys_err <= mode_frac * gap:
        raise AssertionError(f"{name} {kv}: ys {ys_err} from the plain bf16 "
                             f"version, the plain f32 one {gap}")
    return dict(fwd_max_abs_err=fwd, grad_f32_max_rel_err=g32,
                grad_bf16_max_rel_err=g16,
                grad_max_abs_err=max_err(grads, want_grads) if grads else 0.0,
                ys_mean_abs_err=ys_err, plain_f32_vs_bf16_ys_mean=gap)


def bf16_case(name, call, fwd, bwd, plain, plain_bwd, args, cots, flops,
              library, bwd_reads, layout, mode_steps=None, bits=False,
              **shape):
    """One shape of a bf16 mode (phases 29 and 29b): the wrapper as the
    model calls it (no gradient: the forward without residuals; with one,
    the forward with residuals, then the backward) vs the plain bf16
    version (``bf16_check``, the distance test over the first
    ``mode_steps`` steps where given); with ``bits``, two calls of each
    kernel on the same inputs give the same bits; then, in turns (bf16,
    f32, f32, bf16), the bf16 kernels and the f32 kernels on the same
    values converted (exactly) to f32, forward without and with residuals
    and backward (mean of 5 after a warm-up); the plain bf16 version's
    ms, cuDNN's in bf16, the bounds (``flops``: the forward's and the
    backward's products as bf16 operations at 989 TFLOP/s; the bytes of
    the inputs each kernel reads, ``bwd_reads(args, forward's outputs)``
    the backward's besides the cotangents, and of its outputs). ``call``
    and ``plain`` return the outputs flat; fwd(args, residuals) and
    bwd(args, fwd's outputs) call the kernels' wrappers; ``layout()``
    names the mode's layout (rows or CTAs per cluster, residency)."""
    t = shape["T"]
    with torch.no_grad():
        outs0 = call(*args)
    leaves = [a.clone().requires_grad_() for a in args]
    outs = call(*leaves)
    grads = torch.autograd.grad(outs, leaves, cots)
    outs = tuple(o.detach() for o in outs)
    del leaves
    with torch.no_grad():
        plain_fwd_ms, want = plain_time(lambda: plain(*args))
        ys32 = plain(*[a.float() for a in args])[0]
    plain_bwd_ms, want_grads = plain_time(plain_bwd(args, *cots, closure=True))
    errs = bf16_check(name, outs0 + outs, grads, want * 2, want_grads,
                      (ys32,), short=t <= BF16_SHORT_T,
                      mode_steps=mode_steps, **shape)
    del want, want_grads, ys32
    first = fwd(args, True)
    if bits:
        again = fwd(args, True)
        bits = (same_bits([x for x in first if x is not None],
                          [x for x in again if x is not None])
                and same_bits(bwd(args, first), grads)
                and same_bits(bwd(args, again), grads))
        if not bits:
            raise AssertionError(f"{name} {shape}: two kernel calls on the "
                                 f"same inputs differ")
        del again

    def run(a):
        out = fwd(a, True)
        times = dict(fwd_ms=cuda_ms(lambda: fwd(a, False), 5)[0],
                     fwd_res_ms=cuda_ms(lambda: fwd(a, True), 5)[0],
                     bwd_ms=cuda_ms(lambda: bwd(a, out), 5)[0])
        del out
        return times

    times = bf16_in_turns(run, args, [a.float() for a in args])
    res = [x for x in first if x is not None]
    fwd_bound = bound_bf16(flops[0], nbytes(args, res))
    fwd_nores_bound = bound_bf16(flops[0], nbytes(args, res[:len(outs0)]))
    bwd_bound = bound_bf16(flops[1], nbytes(bwd_reads(args, first), cots,
                                            grads))
    del first, res, grads, outs, outs0
    lib_fwd_ms, lib_bwd_ms = library(args, cots, torch.bfloat16)
    lay = layout()
    log(name, **shape, **lay, bit_identical=bits,
        bf16=fmt(times["bf16"]), f32_kernel=fmt(times["f32"]),
        fwd_us_per_step=f"{times['bf16']['fwd_res_ms'] * 1e3 / t:.2f}",
        bwd_us_per_step=f"{times['bf16']['bwd_ms'] * 1e3 / t:.2f}",
        plain_fwd_ms=f"{plain_fwd_ms:.3f}", plain_bwd_ms=f"{plain_bwd_ms:.3f}",
        library_bf16_fwd_ms=f"{lib_fwd_ms:.3f}",
        library_bf16_bwd_ms=f"{lib_bwd_ms:.3f}",
        fwd_bound_ms=f"{fwd_bound[0]:.3f}", bwd_bound_ms=f"{bwd_bound[0]:.3f}")
    return dict(**shape, **lay, bit_identical=bits, **errs,
                **times["bf16"], f32_kernel=times["f32"],
                plain_fwd_ms=plain_fwd_ms, plain_bwd_ms=plain_bwd_ms,
                library_fwd_ms=lib_fwd_ms, library_bwd_ms=lib_bwd_ms,
                fwd_bound=fwd_bound, fwd_no_residual_bound=fwd_nores_bound,
                bwd_bound=bwd_bound)


def flat(fn):
    """``fn`` with its outputs flat: (ys, hn) or (ys, hn, cn)."""
    def call(*a):
        ys, state = fn(*a)
        return (ys, *state) if isinstance(state, tuple) else (ys, state)
    return call


def rows_layout(mod, key, dev, b):
    """``bf16_case``'s layout of K7's or K9's bf16 mode: its rows per
    cluster forward and backward, and the clusters resident at once."""
    return lambda: dict(
        rows=tuple(mod.rows_for(dev, key, bw, b, bf16=True)
                   for bw in (False, True)),
        resident_clusters={d: mod.layout(0, key, d == "backward", True)[0]
                           for d in ("forward", "backward")})


def ctas_layout(mod, dev, b, h):
    """``bf16_case``'s layout of K10's or K8's: the CTAs per cluster of
    the bf16 and the f32 mode."""
    return lambda: dict(cluster_ctas=dict(
        bf16=mod.launch_ctas(dev, b, h, True), f32=mod.launch_ctas(dev, b, h)))


def bf16_kernel_phase(mods, dev, rng):
    """29. The bf16 modes of K7 and K9 at lstm_with_sampling's shapes, in
    training: K7 at B256 x T140, 256 -> 256 (a layered block), K9 at H128
    x L2, B256 x T1120 (the sampler), each also at T16 (``bf16_case``);
    K7 also at the flagship's self-motion LSTMs, B32 x T252; then the
    flagship's bf16 modes of K3/K4 (``bf16_stack_case``) and K5/K6
    (``bf16_attention_case``). Returns (k7, k9, stack, attention)."""
    K7, K9 = mods["K7"], mods["K9"]
    bf = torch.bfloat16
    r = seeded(rng, dev)
    k7, k9 = [], []
    din = 256

    def k7_case(b, t, h=256):
        args = (r(b, t, din).to(bf), r(din, 4 * h, s=0.06).to(bf),
                r(4 * h, s=0.06), r(h, 4 * h, s=0.06).to(bf), r(b, h, s=0.3),
                r(b, h, s=0.3))
        cots = (r(b, t, h), r(b, h), r(b, h))
        # x.W_ih and h.W_hh: 2 B T 4H (din + H); the backward: the chain's
        # dgates.W_hh^T, 2 B T 4H H, and dW_ih, dW_hh and dx, 2 B T 4H
        # (2 din + H)
        return bf16_case(
            "lstm_layer_bf16", flat(K7.lstm_layer),
            lambda a, res: K7.lstm_layer_forward(a, res),
            lambda a, out, c=cots: K7.lstm_layer_backward(
                a, out[0], out[3], out[4], *c),
            flat(K7.lstm_layer_reference), K7.lstm_layer_backward_reference,
            args, cots,
            (8 * b * t * h * (din + h), 8 * b * t * h * (2 * din + 2 * h)),
            cudnn_lstm_ms, lambda a, out: (a, out[0], out[3], out[4]),
            rows_layout(K7, h, dev, b), B=b, T=t, din=din, H=h)

    for t in (LEAD + LWS_FRAMES, BF16_SHORT_T):
        k7.append(k7_case(LWS_B, t))
    h, layers = 128, 2
    for t in ((LEAD + LWS_FRAMES) * RATIO, 2 * BF16_SHORT_T):
        b = LWS_B
        args = (r(b, t, 4 * h), r(layers - 1, h, 4 * h, s=0.06).to(bf),
                r(layers - 1, 4 * h, s=0.06),
                r(layers, h, 4 * h, s=0.06).to(bf), r(layers, b, h, s=0.3),
                r(layers, b, h, s=0.3))
        cots = (r(b, t, h), r(layers, b, h), r(layers, b, h))
        flops = 2 * b * t * 4 * h * h * (2 * layers - 1)
        k9.append(bf16_case(
            "lstm_stacked_bf16", flat(K9.lstm_stacked_recurrence),
            lambda a, res: K9.lstm_stacked_forward(a, res),
            lambda a, out, c=cots: K9.lstm_stacked_backward(
                a[1:], out[0], *out[3:], *c),
            flat(K9.lstm_stacked_reference),
            K9.lstm_stacked_backward_reference, args, cots,
            (flops, 2 * flops), cudnn_stacked_ms,
            lambda a, out: (a[1:], out[0], *out[3:]),
            rows_layout(K9, layers, dev, b), B=b, T=t, L=layers, H=h))
        del args, cots
    k7.append(k7_case(TRAIN_B, LEAD + TRAIN_FRAMES))
    stack = [bf16_stack_case(mods["K1"], r, TRAIN_B, t, layers)
             for layers, t in ((5, (LEAD + TRAIN_FRAMES) * RATIO),
                               (5, LEAD + TRAIN_FRAMES), BF16_STACK_SHORT)]
    attention = [bf16_attention_case(mods["K5"], r, rng, dev, lk)
                 for lk in ((LEAD + TRAIN_FRAMES) * RATIO,
                            LEAD + TRAIN_FRAMES)]
    return k7, k9, stack, attention


def bf16_in_turns(run, args, args32):
    """ms of ``run(a)`` (a dict of timings) on the bf16 arguments and on
    the same values converted to f32 (the f32 kernel), in turns (bf16,
    f32, f32, bf16): the mean of each."""
    runs = {}
    for mode in ("bf16", "f32", "f32", "bf16"):
        runs.setdefault(mode, []).append(
            run(args if mode == "bf16" else args32))
    return {k: {m: float(np.mean([x[m] for x in v])) for m in v[0]}
            for k, v in runs.items()}


def bf16_stack_case(K1, r, b, t, layers, h=256):
    """The encoder stack's bf16 mode (K3 then K4, as the flagship's bf16
    step runs it: bf16 W_ih, W_hh and W_ff, the rest f32) at B x T x
    layers vs the plain bf16 version (``bf16_check``; at the full lengths
    the distance test over the first ``BF16_MODE_STEPS`` steps); the bf16
    kernels and
    the f32 kernels on the same values in turns; the plain bf16 version's
    ms; the bounds of the bf16 mode (its products at 989 TFLOP/s: 18 L B
    T H^2 forward, twice that backward)."""
    n = layers
    args32 = (r(b, t, h), r(n, h, 4 * h, s=0.06), r(n, 4 * h, s=0.06),
              r(n, h, 4 * h, s=0.06), r(n, h, h, s=0.06), r(n, h, s=0.1),
              r(n, h, s=0.1, mean=1.0), r(n, h, s=0.1),
              r(n, h, s=0.1, mean=1.0), r(n, h, s=0.1),
              r(n, b, h, s=0.3), r(n, b, h, s=0.3))
    args = tuple(a.to(torch.bfloat16) if i in K1._WEIGHTS else a
                 for i, a in enumerate(args32))
    args32 = tuple(a.float() for a in args)  # the same values in f32
    cots = (r(b, t, h), r(n, b, h), r(n, b, h))
    leaves = [a.clone().requires_grad_() for a in args]
    y, (hn, cn) = K1.mixer_stack_recurrence(*leaves)
    grads = torch.autograd.grad((y, hn, cn), leaves, cots)
    del leaves
    with torch.no_grad():
        plain_fwd_ms, (yr, (hr, cr)) = plain_time(
            lambda: K1.mixer_stack_forward_reference(*args))
        y32 = K1.mixer_stack_forward_reference(*args32)[0]
    plain_bwd_ms, want = plain_time(
        K1.mixer_stack_backward_reference(args, *cots, closure=True))
    short = (n, t) == BF16_STACK_SHORT
    errs = bf16_check("mixer_stack_bf16", (y, hn, cn), grads, (yr, hr, cr),
                      want, (y32,), short,
                      tol=BF16_STACK_SHORT_TOL if short else BF16_FULL_TOL,
                      mode_steps=None if short else BF16_MODE_STEPS,
                      B=b, T=t, L=n)
    del yr, hr, cr, want, y32

    def run(a):
        out = K1.mixer_stack_train_forward(*a)
        times = dict(
            fwd_ms=cuda_ms(lambda: K1.mixer_stack_train_forward(*a), 3)[0],
            bwd_ms=cuda_ms(lambda: K1.mixer_stack_backward(
                a, out[3], *cots), 3)[0])
        del out
        return times

    times = bf16_in_turns(run, args, args32)
    out = K1.mixer_stack_train_forward(*args)
    fwd_bound = bound_bf16(18 * n * b * t * h * h, nbytes(args, out))
    bwd_bound = bound_bf16(36 * n * b * t * h * h,
                           nbytes(args, out[3], cots, grads))
    del out, grads
    log("mixer_stack_bf16", B=b, T=t, L=n, bf16=fmt(times["bf16"]),
        f32_kernel=fmt(times["f32"]), plain_fwd_ms=f"{plain_fwd_ms:.3f}",
        plain_bwd_ms=f"{plain_bwd_ms:.3f}",
        fwd_bound_ms=f"{fwd_bound[0]:.3f}", bwd_bound_ms=f"{bwd_bound[0]:.3f}",
        chunk=K1.chunk_steps(b, t, h, n),
        bwd_chunk=K1.backward_chunk_steps(b, t, h, n))
    return dict(B=b, T=t, L=n, **errs, **times["bf16"],
                f32_kernel=times["f32"], plain_fwd_ms=plain_fwd_ms,
                plain_bwd_ms=plain_bwd_ms, fwd_bound=fwd_bound,
                bwd_bound=bwd_bound)


def bf16_attention_case(K5, r, rng, dev, lk):
    """Rect attention's bf16 mode (K5 then K6, as block 0's integrators
    run it in the flagship's bf16 step: bf16 q, k, v) at B32 x 252 x Lk x
    4 heads, 10% padded rows and keys, vs the plain bf16 version
    (``bf16_check`` within ``BF16_ATTN_TOL``); the bf16 kernels and the
    f32 kernels on the same values in turns; SDPA in bf16 with the
    boolean mask (forward, and its backward through autograd) as the
    yardstick; the bounds of the bf16 mode over the (query, key) pairs the
    mask leaves (4 and 10 FLOPs per pair and head dim at 989 TFLOP/s); the
    backward's scratch (``bf16_backward_workspace_bytes``)."""
    import torch.nn.functional as F

    b, lq, e, heads = TRAIN_B, LEAD + TRAIN_FRAMES, 256, 4
    dh, bf = e // heads, torch.bfloat16
    q, k, v, g = r(b, lq, e).to(bf), r(b, lk, e).to(bf), r(b, lk, e).to(bf), \
        r(b, lq, e)
    q_pad = torch.from_numpy(rng.random((b, lq)) < 0.1).to(dev)
    k_pad = torch.from_numpy(rng.random((b, lk)) < 0.1).to(dev)
    args = (heads, q, k, v, q_pad, k_pad)
    args32 = (heads, q.float(), k.float(), v.float(), q_pad, k_pad)
    with torch.no_grad():
        out0 = K5.rect_attention(*args)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = K5.rect_attention(heads, *leaves, q_pad, k_pad)
    grads = torch.autograd.grad(out, leaves, g)
    with torch.no_grad():
        plain_fwd_ms, want = cuda_ms(
            lambda: K5.rect_attention_bf16_reference(*args), 1)
        ctx32 = K5.rect_attention_reference(*args32)
    plain_bwd_ms, wgrads = cuda_ms(
        K5.rect_attention_backward_reference(*args, g, closure=True), 1)
    errs = bf16_check("rect_attention_bf16", (out0, out.detach()), grads,
                      (want, want), wgrads, (ctx32,), False,
                      tol=BF16_ATTN_TOL, B=b, Lq=lq, Lk=lk)
    del out0, out, want, wgrads, ctx32

    def run(a):
        ctx, m, l = K5.rect_attention_forward(*a, residuals=True)
        times = dict(
            fwd_ms=cuda_ms(lambda: K5.rect_attention_forward(*a), 5)[0],
            fwd_res_ms=cuda_ms(lambda: K5.rect_attention_forward(
                *a, residuals=True), 5)[0],
            bwd_ms=cuda_ms(lambda: K5.rect_attention_backward(
                *a, ctx, m, l, g), 5)[0])
        del ctx, m, l
        return times

    times = bf16_in_turns(run, args, args32)
    # yardstick only, never called by the port
    allowed = ~K5.rect_attention_mask(q_pad, k_pad)[:, None]
    lib_leaves = [x.clone().requires_grad_() for x in (q, k, v)]

    def split(x):
        return x.view(b, x.shape[1], heads, dh).transpose(1, 2)

    lib_fwd_ms, lib_out = cuda_ms(lambda: F.scaled_dot_product_attention(
        *[split(x) for x in lib_leaves], attn_mask=allowed), 5)
    lib_bwd_ms, _ = cuda_ms(lambda: torch.autograd.grad(
        lib_out, lib_leaves, split(g.to(bf)), retain_graph=True), 5)
    del lib_out, lib_leaves, allowed
    pairs = rect_pairs(q_pad, k_pad) * heads
    ctx, m, l = K5.rect_attention_forward(*args, residuals=True)
    fwd_bound = bound_bf16(4 * pairs * dh, nbytes(args, ctx, m, l))
    bwd_bound = bound_bf16(10 * pairs * dh, nbytes(args, m, l, g, grads))
    scratch = K5.bf16_backward_workspace_bytes(heads, b, lq, lk, e)
    del ctx, m, l, grads
    log("rect_attention_bf16", B=b, Lq=lq, Lk=lk, bf16=fmt(times["bf16"]),
        f32_kernel=fmt(times["f32"]), plain_fwd_ms=f"{plain_fwd_ms:.3f}",
        plain_bwd_ms=f"{plain_bwd_ms:.3f}",
        library_bf16_fwd_ms=f"{lib_fwd_ms:.3f}",
        library_bf16_bwd_ms=f"{lib_bwd_ms:.3f}",
        fwd_bound_ms=f"{fwd_bound[0]:.3f}", bwd_bound_ms=f"{bwd_bound[0]:.3f}",
        bwd_scratch_bytes=scratch)
    return dict(B=b, Lq=lq, Lk=lk, **errs, **times["bf16"],
                f32_kernel=times["f32"], plain_fwd_ms=plain_fwd_ms,
                plain_bwd_ms=plain_bwd_ms, library_fwd_ms=lib_fwd_ms,
                library_bwd_ms=lib_bwd_ms, fwd_bound=fwd_bound,
                bwd_bound=bwd_bound, bwd_scratch_bytes=scratch)


def bf16_recurrence_phase(mods, dev, rng):
    """29b. The bf16 modes of K10 and K8 (``bf16_case``; bf16 W_hh, f32
    xw, biases and states; the distance test over every step of T16 and
    the first ``BF16_RECURRENCE_MODE_STEPS`` of a full length; two calls
    of each kernel give the same bits), drawing after phase 29 from its
    generator: K10 at H256 over B32 x T2016 (an audio-encoder block of the
    GRU Metaformer's bf16 step), B32 x T252 (the self-motion and partner
    blocks) and B128 x T252 (the GRU yaml's batch), each also at T16; K8
    at B256 x T120 x H128 (phase 18's main shape, a simple_lstm acoustic
    direction) and B32 x T252 x H256 (the flagship's self-motion LSTMs
    under MRGEN_FUSED_DW=0), each also at T16; cuDNN's ``nn.GRU`` and
    ``nn.LSTM`` in bf16 the yardsticks. Returns (k10, k8)."""
    K8, K10 = mods["K8"], mods["K10"]
    r = seeded(rng, dev)
    bf = torch.bfloat16

    def steps(t):
        return None if t <= BF16_SHORT_T else BF16_RECURRENCE_MODE_STEPS

    k10, k8 = [], []
    for b, t in ((TRAIN_B, (LEAD + TRAIN_FRAMES) * RATIO),
                 (TRAIN_B, LEAD + TRAIN_FRAMES), (YAML_B, LEAD + TRAIN_FRAMES),
                 (TRAIN_B, BF16_SHORT_T), (YAML_B, BF16_SHORT_T)):
        h = 256
        args = (r(b, t, 3 * h, s=0.5), r(h, 3 * h, s=0.06).to(bf),
                r(3 * h, s=0.1), r(b, h, s=0.3))
        cots = (r(b, t, h), r(b, h))
        flops = 2 * b * t * 3 * h * h
        k10.append(bf16_case(
            "gru_bf16", flat(K10.gru_recurrence),
            lambda a, res: K10.gru_forward(a, res),
            lambda a, out, c=cots: K10.gru_backward(a, out[0], out[2], *c),
            flat(K10.gru_recurrence_reference),
            K10.gru_backward_reference, args, cots, (flops, 2 * flops),
            cudnn_gru_ms, lambda a, out: (a, out[0], out[2]),
            ctas_layout(K10, dev, b, h), mode_steps=steps(t), bits=True,
            B=b, T=t, H=h))
        del args, cots
    for b, t, h in ((LWS_B, SIMPLE_AUDIO_T, 128),
                    (TRAIN_B, LEAD + TRAIN_FRAMES, 256),
                    (LWS_B, BF16_SHORT_T, 128), (TRAIN_B, BF16_SHORT_T, 256)):
        args = (r(b, t, 4 * h, s=0.5), r(h, 4 * h, s=0.06).to(bf),
                r(b, h, s=0.3), r(b, h, s=0.3))
        cots = (r(b, t, h), r(b, h), r(b, h))
        flops = 2 * b * t * 4 * h * h
        k8.append(bf16_case(
            "lstm_recurrence_bf16", flat(K8.lstm_recurrence),
            lambda a, res: K8.lstm_recurrence_forward(a, res),
            lambda a, out, c=cots: K8.lstm_recurrence_backward(
                a, out[0], out[3], out[4], *c),
            flat(K8.lstm_recurrence_reference),
            K8.lstm_recurrence_backward_reference, args, cots,
            (flops, 2 * flops), cudnn_recurrence_ms,
            # the backward reads no xw
            lambda a, out: (a[1:], out[0], out[3], out[4]),
            ctas_layout(K8, dev, b, h), mode_steps=steps(t), bits=True,
            B=b, T=t, H=h))
        del args, cots
    return k10, k8


def lws_bf16_train_spec():
    """lstm_with_sampling's bf16 step (``trainer.precision: bf16``): per
    step the bf16 modes, K9 +1 / +1 and K7 +2 / +2; the eval step in f32,
    K9 +1 and K7 forward +2; the card against CPU tensors within
    ``BF16_CARD_CPU_TOL``."""
    spec = lws_train_spec()
    spec.update(
        tag="lws_bf16_train_step", eval_tag="lws_bf16_eval_step",
        compute_dtype=torch.bfloat16,
        per_step=dict(lstm_stacked_bf16_fwd=1, lstm_stacked_bf16_bwd=1,
                      lstm_layer_bf16_fwd=2, lstm_layer_bf16_bwd=2),
        per_step_off=dict(lstm_stacked_bf16_fwd=1, lstm_stacked_bf16_bwd=1,
                          lstm_recurrence_bf16_fwd=2,
                          lstm_recurrence_bf16_bwd=2),
        per_eval=dict(lstm_stacked_fwd=1, lstm_layer_fwd=2),
        profile=None,  # cut for room: phase 12's f32 step is profiled
        card_vs_cpu_tol=BF16_CARD_CPU_TOL)
    return spec


def lws_bf16_off_spec():
    """lstm_with_sampling's bf16 step as phase 20 holds it under
    ``MRGEN_FUSED_DW=0``: the loss within phase 30's bound, the gradients
    as phase 31 holds the flagship's (the largest error within 2e-1 of
    its parameter's largest, floored at 1e-2 of the largest gradient of
    all; the mean within ``BF16_LWS_STEP_MEAN_TOL``, the CPU's f32 step,
    the control, beyond it). Phase 30's 3e-2 on the largest error does not
    hold at phase 20's batch on either route: ``ff_input.weight`` reads
    4.63e-2 on K8's and 6.36e-2 on K7's, where the f32 step reads 0.111
    (``tools/bf16_phases.py cardcpu_p20``; ``cardcpu_lws1`` reads it at
    other batches up to 7.47e-2 on K7's)."""
    return dict(lws_bf16_train_spec(),
                card_vs_cpu_tol=(BF16_CARD_CPU_TOL[0],
                                 BF16_FLAGSHIP_CARD_CPU_TOL[1]),
                f32_twin=lws_train_spec, grad_floor=1e-2,
                mean_tol=BF16_LWS_STEP_MEAN_TOL)


def metaformer_bf16_train_spec():
    """The flagship's bf16 step (``trainer.precision: bf16``): per step the
    encoder stacks' bf16 mode, K3 +2 / K4 +2, K7's, +5 / +5, and rect
    attention's bf16 mode for block 0's two integrators (bf16 queries),
    K5 +2 / K6 +2, its f32 mode for the later blocks' eight (f32 queries
    out of f32 contexts, as JAX promotes them), K5 +8 / K6 +8; the eval
    step in f32 as phase 8's; the card against CPU tensors within
    ``BF16_FLAGSHIP_CARD_CPU_TOL`` (gradients floored at 1e-2 of the
    largest: the k projections' biases carry bf16 rounding noise), and on
    average within ``BF16_STEP_MEAN_TOL`` of the CPU's bf16 step, the
    CPU's f32 step beyond it."""
    spec = metaformer_train_spec()
    spec.update(
        tag="bf16_train_step", eval_tag="bf16_eval_step",
        compute_dtype=torch.bfloat16, stack_ab=False,
        per_step=dict(mixer_stack_bf16_train_fwd=2, mixer_stack_bf16_bwd=2,
                      lstm_layer_bf16_fwd=5, lstm_layer_bf16_bwd=5,
                      rect_attention_bf16_fwd=2, rect_attention_bf16_bwd=2,
                      rect_attention_fwd=8, rect_attention_bwd=8),
        per_step_off=dict(mixer_stack_bf16_train_fwd=2,
                          mixer_stack_bf16_bwd=2,
                          lstm_recurrence_bf16_fwd=5,
                          lstm_recurrence_bf16_bwd=5,
                          rect_attention_bf16_fwd=2,
                          rect_attention_bf16_bwd=2,
                          rect_attention_fwd=8, rect_attention_bwd=8),
        profile="profile_bf16_train_step.txt",
        card_vs_cpu_tol=BF16_FLAGSHIP_CARD_CPU_TOL,
        f32_twin=metaformer_train_spec, mean_tol=BF16_STEP_MEAN_TOL,
        # the k projections' biases: their gradients are zero in exact
        # arithmetic, so both sides give rounding noise, in bf16 ~2^-8 of
        # the gradients it is summed from
        grad_floor=1e-2)
    return spec


def gru_bf16_train_spec():
    """The GRU Metaformer's bf16 step (``trainer.precision: bf16``): per
    step K10's bf16 mode +15 / +15 (every encoder and self-motion block:
    bf16 W_hh, whatever the dtype of the block's input) and rect
    attention's modes as the flagship's, K5 +2 / K6 +2 in bf16 (block 0's
    bf16 queries), +8 / +8 in f32; the eval step in f32 as phase 16's; the
    card against CPU tensors within phase 31's bounds on the loss and the
    largest errors, on average within ``BF16_GRU_STEP_MEAN_TOL``, the
    CPU's f32 step, the control, beyond it."""
    spec = gru_train_spec()
    spec.update(
        tag="gru_bf16_train_step", eval_tag="gru_bf16_eval_step",
        compute_dtype=torch.bfloat16,
        per_step=dict(gru_bf16_fwd=15, gru_bf16_bwd=15,
                      rect_attention_bf16_fwd=2, rect_attention_bf16_bwd=2,
                      rect_attention_fwd=8, rect_attention_bwd=8),
        profile=None,  # cut for room: phase 16's f32 step is profiled
        card_vs_cpu_tol=BF16_FLAGSHIP_CARD_CPU_TOL, f32_twin=gru_train_spec,
        mean_tol=BF16_GRU_STEP_MEAN_TOL, grad_floor=1e-2)
    return spec


def bf16_step_phase(mods, dev, rng, spec, f32_spec, tag):
    """30. and 31. A bf16 training step as the f32 one's phase runs it
    (``spec``: lstm_with_sampling's, then the flagship's); then, from one
    model's weights on one batch, the bf16 step's loss against the f32
    step's (``f32_spec``), within ``BF16_LOSS_REL_TOL``, the parameters
    f32 after both."""
    step = train_path_phase(mods, dev, rng, spec)
    batch = spec_batch(spec, rng, spec["batch"], dev)
    losses = {}
    for name, s in (("f32", f32_spec), ("bf16", spec)):
        model = spec_model(s, dev)
        losses[name] = float(spec_step_fns(s, model, s["optim"])[0](
            batch)[0])
        dtypes = {p.dtype for p in model.parameters()}
        if dtypes != {torch.float32}:
            raise AssertionError(f"{name} step: parameters {dtypes}")
        del model
    rel = abs(losses["bf16"] - losses["f32"]) / abs(losses["f32"])
    log(tag, loss_f32=f"{losses['f32']:.7f}",
        loss_bf16=f"{losses['bf16']:.7f}", rel_err=f"{rel:.3e}")
    if not rel <= BF16_LOSS_REL_TOL:
        raise AssertionError(f"bf16 step loss {losses['bf16']} vs f32 "
                             f"{losses['f32']}: {rel} > {BF16_LOSS_REL_TOL}")
    step["record"]["loss_vs_f32_step"] = dict(losses, rel_err=rel)
    return step


def lws_bf16_cli_launches(launches, steps):
    """``trainer.precision=bf16``: every train step the bf16 modes, K9 +1
    / +1 and K7 +2 / +2; every validation batch in f32, an eval step (K9
    +1, K7 forward +2) and a generation (K9 +1)."""
    n_eval = launches["lstm_layer_fwd"] // 2
    want = {k: 0 for k in COUNTERS}
    want.update(lstm_stacked_bf16_fwd=steps, lstm_stacked_bf16_bwd=steps,
                lstm_layer_bf16_fwd=2 * steps, lstm_layer_bf16_bwd=2 * steps,
                lstm_stacked_fwd=2 * n_eval, lstm_layer_fwd=2 * n_eval)
    if launches != want:
        raise AssertionError(f"lws bf16 cli launches {launches}, want {want}")
    return n_eval


def metaformer_bf16_cli_launches(launches, steps):
    """``trainer.precision=bf16`` on the flagship: every train step the
    bf16 modes, K3 +2, K4 +2, K7 +5 / +5, K5 +2 and K6 +2, and K5's and
    K6's f32 mode +8 each (the later blocks' f32 queries); every
    validation batch in f32, as ``metaformer_cli_launches``'. Returns the
    validation batches."""
    n_eval = (launches["rect_attention_fwd"] - 8 * steps) // 10
    want = {k: 0 for k in COUNTERS}
    want.update(mixer_stack_bf16_train_fwd=2 * steps,
                mixer_stack_bf16_bwd=2 * steps,
                lstm_layer_bf16_fwd=5 * steps, lstm_layer_bf16_bwd=5 * steps,
                rect_attention_bf16_fwd=2 * steps,
                rect_attention_bf16_bwd=2 * steps,
                rect_attention_fwd=8 * steps + 10 * n_eval,
                rect_attention_bwd=8 * steps,
                lstm_layer_fwd=5 * n_eval, mixer_stack=4 * n_eval,
                decode_rollout=launches["decode_rollout"])
    if launches != want or launches["decode_rollout"] < n_eval:
        raise AssertionError(f"bf16 cli launches {launches}, want {want} "
                             f"and decode_rollout >= {n_eval}")
    return n_eval


def checkpoint_dtypes(run, tag):
    """The dtypes of the parameters and of the optimizer state's floating
    tensors in ``tag``'s ``last`` checkpoint: f32 only, or raise."""
    saved = torch.load(run / f"ckpt_{tag}" / "smoke" / "last",
                       weights_only=True)
    tensors = list(saved["params"].values()) + [
        v for st in saved["opt"]["state"].values() for v in st.values()
        if torch.is_tensor(v) and v.is_floating_point()]
    dtypes = sorted({str(v.dtype) for v in tensors})
    log(tag, checkpoint_dtypes=dtypes)
    if dtypes != ["torch.float32"]:
        raise AssertionError(f"{tag} checkpoint holds {dtypes}")
    return dtypes


def flagship_bf16_records(stack, attention, launches, **more_launches):
    """The JSON entries of the bf16 modes of K3/K4 and K5/K6: launches from
    the flagship's bf16 CLI run (phase 9d), the bf16 train step's beside
    them; the main case the audio encoder (B32 x L5 x T2016) and the
    audio integrator (Lk 2016); the f32 kernel's ms on the same values
    beside; SDPA in bf16 the yardstick of K5/K6; no single PyTorch call
    computes the encoder stack."""
    records = []
    for cases, names, src, fwd_at, bwd_at, fwd_key in (
            (stack, ("mixer_stack_bf16_train_fwd", "mixer_stack_bf16_bwd"),
             "mixer_stack.cu", "pallas_mixer_stack.py:110",
             "pallas_mixer_stack.py:297", "fwd_ms"),
            (attention, ("rect_attention_bf16_fwd", "rect_attention_bf16_bwd"),
             "attention_bf16.cu", "pallas_rect_attention.py:85",
             "pallas_rect_attention.py:117", "fwd_res_ms")):
        main = cases[0]
        extra = {f"launches_{k}": {n: v[n] for n in names}
                 for k, v in more_launches.items()}
        records += [
            kernel_record(
                names[0], src, fwd_at, launches[names[0]],
                max(c["fwd_max_abs_err"] for c in cases), main[fwd_key],
                main["plain_fwd_ms"], main["fwd_bound"],
                main.get("library_fwd_ms"),
                f32_kernel_ms=main["f32_kernel"][fwd_key], dtype="bf16",
                cases=cases, **extra),
            kernel_record(
                names[1], src, bwd_at, launches[names[1]],
                max(c["grad_max_abs_err"] for c in cases), main["bwd_ms"],
                main["plain_bwd_ms"], main["bwd_bound"],
                main.get("library_bwd_ms"),
                f32_kernel_ms=main["f32_kernel"]["bwd_ms"], dtype="bf16"),
        ]
    return records


# the bf16 modes' entries: (CUDA source, the TPU forward kernel, the
# backward)
BF16_SOURCES = {
    "lstm_layer_bf16": ("lstm_layer.cu", "pallas_lstm.py:390",
                        "pallas_lstm.py:448"),
    "lstm_stacked_bf16": ("lstm_stacked.cu", "pallas_lstm_stacked.py:154",
                          "pallas_lstm_stacked.py:317"),
    "gru_bf16": ("gru.cu", "pallas_gru.py:57", "pallas_gru.py:101"),
    "lstm_recurrence_bf16": ("lstm_recurrence.cu", "pallas_lstm.py:117",
                             "pallas_lstm.py:131"),
    "lstm_stacked_layers_bf16": ("lstm_recurrence.cu",
                                 "pallas_lstm_stacked.py:154",
                                 "pallas_lstm_stacked.py:317"),
}


def bf16_records(modes, **more_launches):
    """The JSON entries of the bf16 modes of K7, K9 (phase 29), K10 and
    K8 (29b): ``modes`` maps a mode's name to its ``bf16_case`` cases (the
    main case first) and its launches on a main path, ``more_launches``
    other runs' launches to list beside them; cuDNN in bf16 the
    yardstick; the f32 kernel's ms on the same values beside."""
    records = []
    for name, (cases, launches) in modes.items():
        src, fwd_at, bwd_at = BF16_SOURCES[name]
        main = cases[0]
        keys = (f"{name}_fwd", f"{name}_bwd")
        extra = {f"launches_{k}": {n: v[n] for n in keys}
                 for k, v in more_launches.items()}
        if "cluster_ctas" in main:
            extra["cluster_ctas"] = main["cluster_ctas"]
        records += [
            kernel_record(
                keys[0], src, fwd_at, launches[keys[0]],
                max(c["fwd_max_abs_err"] for c in cases),
                main["fwd_res_ms"], main["plain_fwd_ms"], main["fwd_bound"],
                main["library_fwd_ms"], no_residual_ms=main["fwd_ms"],
                no_residual_bound_ms=main["fwd_no_residual_bound"][0],
                f32_kernel_ms=main["f32_kernel"]["fwd_res_ms"],
                dtype="bf16", cases=cases, **extra),
            kernel_record(
                keys[1], src, bwd_at, launches[keys[1]],
                max(c["grad_max_abs_err"] for c in cases), main["bwd_ms"],
                main["plain_bwd_ms"], main["bwd_bound"],
                main["library_bwd_ms"],
                f32_kernel_ms=main["f32_kernel"]["bwd_ms"], dtype="bf16"),
        ]
    return records


def recurrence_records(cases, launches, **more_launches):
    """The JSON entries of K8's forward and backward: the main case is a
    simple_lstm acoustic direction (B256 x T120 x H128); launches from the
    ``MRGEN_FUSED_DW=0`` runs of the main paths (phases 19 and 20), each
    beside the total. cuDNN's ``nn.LSTM`` is the yardstick."""
    main = cases[0]
    extra = {f"launches_{k}": {n: v[n] for n in ("lstm_recurrence_fwd",
                                                 "lstm_recurrence_bwd")}
             for k, v in more_launches.items()}
    return [
        kernel_record(
            "lstm_recurrence_fwd", "lstm_recurrence.cu", "pallas_lstm.py:117",
            launches["lstm_recurrence_fwd"],
            max(c["fwd_max_abs_err"] for c in cases), main["fwd_res_ms"],
            main["plain_fwd_ms"], main["fwd_bound"], main["library_fwd_ms"],
            bound_fp32_ms=main["fwd_bound_fp32"][0],
            us_per_step=main["fwd_res_us_per_step"],
            cluster_ctas=main["cluster_ctas"],
            no_residual_ms=main["fwd_ms"],
            no_residual_bound_ms=main["fwd_no_residual_bound"][0],
            no_residual_replaces=JAX_OPS + "pallas_lstm.py:66",
            cases=cases, **extra),
        kernel_record(
            "lstm_recurrence_bwd", "lstm_recurrence.cu", "pallas_lstm.py:131",
            launches["lstm_recurrence_bwd"],
            max(c["grad_max_abs_err"] for c in cases), main["bwd_ms"],
            main["plain_bwd_ms"], main["bwd_bound"], main["library_bwd_ms"],
            bound_fp32_ms=main["bwd_bound_fp32"][0],
            us_per_step=main["bwd_us_per_step"],
            cluster_ctas=main["cluster_ctas"],
            max_rel_err=max(c["grad_max_rel_err"] for c in cases)),
    ]


def attention_records(cases, launches):
    """The JSON entries of K5 and K6; launches from the CLI run."""
    audio = cases[0]
    return [
        kernel_record(
            "rect_attention_fwd", "rect_attention.cu",
            "pallas_rect_attention.py:85", launches["rect_attention_fwd"],
            max(c["fwd_max_abs_err"] for c in cases), audio["fwd_ms"],
            audio["plain_fwd_ms"], audio["fwd_bound"],
            audio["library_fwd_ms"], cases=cases),
        kernel_record(
            "rect_attention_bwd", "rect_attention.cu",
            "pallas_rect_attention.py:117", launches["rect_attention_bwd"],
            max(c["grad_max_abs_err"] for c in cases), audio["bwd_ms"],
            audio["plain_bwd_ms"], audio["bwd_bound"],
            audio["library_bwd_ms"],
            max_rel_err=max(c["grad_max_rel_err"] for c in cases)),
    ]

def bf16_inference_case(K1, r, b, t, layers, h=256):
    """K1's bf16 mode (``mixer_stack_forward`` on bf16 W_ih, W_hh and W_ff,
    the rest f32) at B x T x layers: one launch; the training forward's
    bits (the same schedule, without residual stores); against the plain
    bf16 version as K3's bf16 mode is held (``bf16_stack_case``); the bf16
    kernel and the f32 kernel on the same values in turns; the plain bf16
    version's ms; the bound of its products (18 L B T H^2) at 989 TFLOP/s
    or its bytes."""
    n = layers
    args32 = (r(b, t, h), r(n, h, 4 * h, s=0.06), r(n, 4 * h, s=0.06),
              r(n, h, 4 * h, s=0.06), r(n, h, h, s=0.06), r(n, h, s=0.1),
              r(n, h, s=0.1, mean=1.0), r(n, h, s=0.1),
              r(n, h, s=0.1, mean=1.0), r(n, h, s=0.1),
              r(n, b, h, s=0.3), r(n, b, h, s=0.3))
    args = tuple(a.to(torch.bfloat16) if i in K1._WEIGHTS else a
                 for i, a in enumerate(args32))
    args32 = tuple(a.float() for a in args)  # the same values in f32
    with torch.no_grad():
        before = K1.bf16_launches
        y, (hn, cn) = K1.mixer_stack_forward(*args)
        torch.cuda.synchronize()
        if K1.bf16_launches != before + 1:
            raise AssertionError("mixer_stack_bf16: not one bf16 launch")
        train_bits = same_bits((y, hn, cn),
                               K1.mixer_stack_train_forward(*args)[:3])
        plain_ms, (yr, (hr, cr)) = plain_time(
            lambda: K1.mixer_stack_forward_reference(*args))
        y32 = K1.mixer_stack_forward_reference(*args32)[0]
    short = (n, t) == BF16_STACK_SHORT
    errs = bf16_check("mixer_stack_bf16", (y, hn, cn), (), (yr, hr, cr), (),
                      (y32,), short,
                      tol=BF16_STACK_SHORT_TOL if short else BF16_FULL_TOL,
                      mode_steps=None if short else BF16_MODE_STEPS,
                      B=b, T=t, L=n)
    if not train_bits:
        raise AssertionError(f"mixer_stack_bf16 B{b} T{t} L{n}: not the "
                             "training forward's bits")
    del yr, hr, cr, y32

    def run(a):
        with torch.no_grad():
            return {"ms": cuda_ms(lambda: K1.mixer_stack_forward(*a), 3)[0]}

    times = bf16_in_turns(run, args, args32)
    bound_ = bound_bf16(18 * n * b * t * h * h, nbytes(args, y, hn, cn))
    log("mixer_stack_bf16", B=b, T=t, L=n, ms=f"{times['bf16']['ms']:.3f}",
        f32_kernel_ms=f"{times['f32']['ms']:.3f}",
        plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound_[0]:.3f}",
        chunk=K1.chunk_steps(b, t, h, n), training_forward_bits=train_bits)
    return dict(B=b, T=t, L=n, **errs, ms=times["bf16"]["ms"],
                f32_kernel_ms=times["f32"]["ms"], plain_ms=plain_ms,
                bound=bound_, training_forward_bits=train_bits)


def bf16_forward_check(tag, card, cpu, cpu_f32):
    """A bf16 result on the card against the same on CPU tensors: its
    largest error within ``BF16_FWD_TOL`` and its mean within
    ``BF16_MODE_FRAC`` of the CPU's f32 result's mean distance from the
    CPU's bf16 one (the control reads 1)."""
    card, cpu, cpu_f32 = (x.detach().float().cpu() for x in (card, cpu,
                                                             cpu_f32))
    err = float((card - cpu).abs().max())
    mean = float((card - cpu).abs().mean())
    gap = float((cpu_f32 - cpu).abs().mean())
    log(tag, card_vs_cpu_max_abs_err=f"{err:.3e}",
        card_vs_cpu_mean_abs_err=f"{mean:.3e}",
        cpu_f32_vs_bf16_mean=f"{gap:.3e}", mean_frac=f"{mean / gap:.3f}")
    if not err <= BF16_FWD_TOL or not mean <= BF16_MODE_FRAC * gap:
        raise AssertionError(f"{tag}: card vs CPU {err} (mean {mean}), the "
                             f"f32 control's mean {gap}")
    return dict(card_vs_cpu_max_abs_err=err, card_vs_cpu_mean_abs_err=mean,
                cpu_f32_vs_bf16_mean=gap, mean_frac=mean / gap)


def bf16_inference_phase(mods, dev, rng, cfg):
    """33. K1's bf16 mode (``bf16_inference_case``) at B16 x L5 x T2096
    (the audio encoder) and L2 x T16; then its main path, the flagship's
    forward without gradient on bf16 parameters and inputs (JAX's
    ``model.apply`` on ``_cast_tree(params, bf16)``) at B16 x 250 frames,
    the counts set to 0 just before it: K1 bf16 +2 (the audio and
    partner-motion encoders), K7's bf16 mode +5 (the self-motion LSTMs),
    K5's bf16 mode +2 (block 0's bf16 queries) and its f32 mode +8 (the
    later blocks' f32 queries), nothing else; its ms beside the f32
    forward's, in turns; the same forward at B2 x 48 against CPU tensors
    (``bf16_forward_check``); ``generate_metaformer`` on the bf16
    parameters (hoisted encoders K1 bf16 +2, K2 +1), and teacher-forced
    with f32 rings at batch 2 against CPU tensors within
    ``K2_BF16_TOL``."""
    from multimodalreactiongeneration_tpu_torch.infer import generate as G

    K1, bf = mods["K1"], torch.bfloat16
    r = seeded(rng, dev)
    cases = [bf16_inference_case(K1, r, B, (LEAD + FRAMES) * RATIO, 5),
             bf16_inference_case(K1, r, B, BF16_SHORT_T, 2)]
    model32 = flagship(cfg, dev)
    model = flagship(cfg, dev).to(bf)
    ins = [x.to(dev) for x in make_batch(rng, B)[:6]]
    ins16 = [x.to(bf) for x in ins]
    with torch.no_grad():
        model(*ins16)  # warm-up, not counted
        torch.cuda.synchronize()
        zero_counts(mods)
        y = model(*ins16)[0]
        torch.cuda.synchronize()
        launches = counts(mods)
        check_launches("bf16 forward", {k: 0 for k in COUNTERS}, launches,
                       mixer_stack_bf16=2, lstm_layer_bf16_fwd=5,
                       rect_attention_bf16_fwd=2, rect_attention_fwd=8)
        if not bool(torch.isfinite(y).all()) or y.dtype != torch.float32:
            raise AssertionError(f"bf16 forward: {y.dtype}, finite "
                                 f"{bool(torch.isfinite(y).all())}")
        turns = {"bf16": [], "f32": []}
        for mode in ("bf16", "f32", "f32", "bf16"):
            m, a = (model, ins16) if mode == "bf16" else (model32, ins)
            turns[mode].append(cuda_ms(lambda: m(*a), 3)[0])
        fwd_ms = {k: float(np.mean(v)) for k, v in turns.items()}
        small = make_batch(rng, BF16_FWD_BATCH, frames=BF16_FWD_FRAMES)[:6]
        cpu32 = flagship(cfg, "cpu")
        cpu16 = flagship(cfg, "cpu").to(bf)
        on_card = model(*[x.to(dev).to(bf) for x in small])[0]
        on_cpu = cpu16(*[x.to(bf) for x in small])[0]
        forward = bf16_forward_check("bf16_forward", on_card, on_cpu,
                                     cpu32(*small)[0])
    log("bf16_forward", B=B, frames=FRAMES, ms=f"{fwd_ms['bf16']:.3f}",
        f32_ms=f"{fwd_ms['f32']:.3f}", turns=turns,
        launches={k: v for k, v in launches.items() if v})

    full = G.sampling_mask_for(FRAMES, "full", device=dev)
    batch = [x.to(dev) for x in make_batch(rng, B)]
    G.generate_metaformer(model, batch, full)  # warm-up
    torch.cuda.synchronize()
    before = counts(mods)
    gen_ms, pred = cuda_ms(lambda: G.generate_metaformer(model, batch, full),
                           1)
    after = counts(mods)
    # the timed call and its warm-up
    check_launches("bf16 generation", before, after, mixer_stack_bf16=4,
                   decode_rollout=2)
    if tuple(pred.shape) != (B, FRAMES, MOTION_DIM) or not bool(
            torch.isfinite(pred).all()):
        raise AssertionError(f"bf16 generation: {tuple(pred.shape)}")
    small = make_batch(rng, 2)
    teacher = G.sampling_mask_for(FRAMES, "teacher")
    card_gen = G.generate_metaformer(
        model, [x.to(dev) for x in small], teacher.to(dev),
        cache_dtype=torch.float32)
    cpu_gen = G.generate_metaformer(cpu16, small, teacher,
                                    cache_dtype=torch.float32)
    gen_err = float((card_gen.cpu() - cpu_gen).abs().max())
    log("bf16_generate", ms=f"{gen_ms:.3f}",
        teacher_f32_batch2_vs_cpu_max_abs_err=f"{gen_err:.3e}")
    if not gen_err <= K2_BF16_TOL:
        raise AssertionError(f"bf16 generation card vs CPU: {gen_err}")
    return {"cases": cases, "launches": launches, "record": {
        "forward": dict(batch=B, frames=FRAMES, ms=fwd_ms["bf16"],
                        f32_ms=fwd_ms["f32"], turns=turns, **forward),
        "generation": dict(batch=B, frames=FRAMES, ms=gen_ms,
                           teacher_batch2_vs_cpu_max_abs_err=gen_err)}}


def rollout_route_phase(mods, dev, rng, cfg):
    """34. ``generate_metaformer`` under ``fused_rollout="auto"`` on
    configs its gate takes and K2 does not (``ROUTE_CONFIGS``: hidden 128
    with 4 heads, hidden 256 with 8 heads): teacher-forced, f32 rings, at
    batch 2 x ``LOOP_FRAMES`` frames, the module loop on the card (K1 +2,
    K2 +0)
    against CPU tensors within ``PATH_TOL``; ``fused_rollout=True`` raises
    with K2's reason."""
    from multimodalreactiongeneration_tpu_torch.infer import generate as G

    small = first_frames(make_batch(rng, 2), LOOP_FRAMES)
    teacher = G.sampling_mask_for(LOOP_FRAMES, "teacher")
    out = {}
    for name, changes in ROUTE_CONFIGS.items():
        model = flagship(cfg, dev, **changes)
        batch = [x.to(dev) for x in small]
        before = counts(mods)
        t0 = time.perf_counter()
        card = G.generate_metaformer(model, batch, teacher.to(dev),
                                     cache_dtype=torch.float32)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check_launches(f"route {name}", before, counts(mods), mixer_stack=2)
        cpu = G.generate_metaformer(flagship(cfg, "cpu", **changes), small,
                                    teacher, cache_dtype=torch.float32)
        err = float((card.cpu() - cpu).abs().max())
        try:
            G.generate_metaformer(model, batch, teacher.to(dev),
                                  fused_rollout=True)
            raised = None
        except ValueError as exc:
            raised = str(exc)
        log("rollout_route", config=name, decode_rollout_launches=0,
            card_s=f"{seconds:.2f}", card_vs_cpu_max_abs_err=f"{err:.3e}",
            forced_raises=repr(raised))
        if not err <= PATH_TOL:
            raise AssertionError(f"route {name}: card vs CPU {err}")
        if not raised or "decode_rollout kernel" not in raised:
            raise AssertionError(f"route {name}: fused_rollout=True ran")
        out[name] = dict(card_s=seconds, card_vs_cpu_max_abs_err=err,
                         forced_error=raised)
    return out


# chip_smoke.py's kernel-module keys as ``parallel/multihost_dryrun.py``
# names the counters' modules
DRYRUN_MODULES = {"K1": "mixer_stack", "K2": "decode_rollout",
                  "K5": "rect_attention", "K7": "lstm_layer",
                  "K8": "lstm_recurrence", "K9": "lstm_stacked",
                  "K10": "gru"}


def dryrun_launches(per_step, steps):
    """``per_step`` launches (``COUNTERS`` names) over ``steps`` steps, as
    the dryrun keys them (``module.counter``)."""
    return {f"{DRYRUN_MODULES[COUNTERS[k][0]]}.{COUNTERS[k][1]}": n * steps
            for k, n in per_step.items() if n}


def mesh_feeds(rng, hop, slots, steps):
    return ((0.1 * rng.standard_normal((steps, slots, hop))).astype(
                np.float32),
            rng.standard_normal((steps, slots, 1, MOTION_DIM)).astype(
                np.float32))


def mesh_phases(mods, dev, cfg, pool):
    """35. and 39. Data parallel and the (data, model) mesh
    (``parallel/multihost_dryrun.py readings``): ONE launch of a single
    process (its references, then the world-size-1 NCCL DDP steps), then
    ONE launch of two ranks over gloo on CUDA tensors of the one card
    (NCCL refuses two ranks on one GPU), one after the other so that
    neither side's step times contend; each worker a fresh process,
    waited on with a timeout. 35: the NCCL world-size-1 step (f32 and
    bf16) within ``DP_ONE_TOL`` of the plain step; on a (2, 1) mesh the
    five step paths of the dryrun's Metaformer (hidden 256) within
    ``DP_LOSS_TOL`` / ``DP_PARAM_TOL`` of one process, ranks equal, and a
    one-epoch fit. 39 (generator ``SEED + 39``): the module docstring.
    ``pool``: phase 24's record, whose 16-slot step times are printed
    beside the ranks'."""
    from multimodalreactiongeneration_tpu_torch import _build
    from multimodalreactiongeneration_tpu_torch.infer.serving import (
        ServingEngine,
    )
    from multimodalreactiongeneration_tpu_torch.infer.streaming import (
        fbank_stream_geometry,
    )
    from multimodalreactiongeneration_tpu_torch.parallel import (
        multihost_dryrun as dp,
    )

    rng = np.random.default_rng(SEED + 39)
    work = _build.BUILD_DIR / "mesh_run"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    model = flagship(cfg, dev)
    torch.save(model.state_dict(), work / "flagship.pt")
    hop = fbank_stream_geometry(cfg)[2]
    slots = SERVE_SLOTS[0]
    leads = [lead_arrays(rng) for _ in range(slots + 2)]
    # f32: 4 slots attach at each of 4 steps; bf16: phase 24's schedule
    # (slot s at step 2s, slots 1 and 2 detached and retaken halfway)
    events = {"f32": [(s // 4, "attach", s) for s in range(slots)],
              "bf16": [(2 * s, "attach", s) for s in range(slots)] + [
                  (SERVE_STEPS // 2, what, arg) for what, arg in (
                      ("detach", 1), ("detach", 2), ("attach", slots),
                      ("attach", slots + 1))]}
    feeds = {"f32": mesh_feeds(rng, hop, slots, 4),
             "bf16": mesh_feeds(rng, hop, slots, SERVE_STEPS)}
    for name, (audio, mp) in feeds.items():
        np.savez(work / f"serve_{name}.npz",
                 lead_audio=np.stack([x[0] for x in leads]),
                 lead_mp=np.stack([x[1] for x in leads]),
                 lead_ms=np.stack([x[2] for x in leads]), audio=audio, mp=mp)
    requests = [
        dp.step_request(("f32", "bf16"), hidden=DP_HIDDEN, tag="nccl",
                        nccl_world_1=True),
        dp.step_request(dp.VARIANTS, hidden=DP_HIDDEN, tag="dp"),
        dp.fit_request(1, hidden=DP_HIDDEN, tag="dpfit", tol=DP_LOSS_TOL),
        dp.step_request(("f32",), (1, 2), scale="flagship", steps=3,
                        tag="mesh"),
        dp.step_request(("bf16",), (1, 2), scale="flagship", steps=1,
                        tag="mesh_bf16"),
        dp.fit_request(1, (1, 2), hidden=DP_HIDDEN, tag="meshfit",
                       tol=DP_LOSS_TOL),
        *[dp.serving_request(cfg, str(work / "flagship.pt"),
                             str(work / f"serve_{name}.npz"), events[name],
                             slots, name, (2, 1),
                             refuse_slots=slots - 1 if name == "f32" else None,
                             tag=f"serve_{name}")
          for name in ("f32", "bf16")]]
    t0 = time.perf_counter()
    took = []
    (nccl, steps, fit, mesh, mesh_bf16, mesh_fit, serve32,
     serve16) = dp.readings(requests, 2, device="cuda", backend="gloo",
                            timeout=600.0, timed=True, seconds=took)
    seconds = time.perf_counter() - t0
    # the two launches run one after the other: a phase's seconds are its
    # jobs' in the single process plus its jobs' on the slowest rank; the
    # rest is the launches' start-up, which the two phases share
    jobs35, jobs39 = [sum(t["one"] + t["ranks"] for t in part)
                      for part in (took[:3], took[3:])]
    log("mesh", launches_seconds=f"{seconds:.1f}",
        phase35_job_seconds=f"{jobs35:.1f}",
        phase39_job_seconds=f"{jobs39:.1f}", phase39_budget_seconds=45,
        shared_start_up_seconds=f"{seconds - jobs35 - jobs39:.1f}")

    # ---- 35. data parallel -------------------------------------------
    dp_out = {"seconds": seconds}
    for tag, readings, tol in (
            ("nccl_world_1", nccl, (DP_ONE_TOL, DP_ONE_TOL)),
            ("gloo_two_ranks", steps, (DP_LOSS_TOL, DP_PARAM_TOL))):
        for v, rd in readings.items():
            rd.pop("params")
            log("data_parallel", run=tag, variant=v,
                loss_err=f"{rd['loss_err']:.3e}",
                param_err=f"{rd['param_err']:.3e}",
                rank_param_err=rd["rank_param_err"], rows=rd["rows"],
                ddp=rd["rank_ddp"], **(dict(
                    second_step_ms_one_process=f"{rd['single_step_ms'][1]:.1f}",
                    second_step_ms_ranks=[round(m[1], 1)
                                          for m in rd["rank_step_ms"]])
                    if tag == "gloo_two_ranks" else {}))
            dp.check_steps(rd, loss_tol=tol[0], param_tol=tol[1])
        dp_out[tag] = {"steps": readings}
    dp_out["gloo_two_ranks_fit"] = fit
    log("data_parallel", run="gloo_two_ranks_fit",
        **{k: v for k, v in fit.items()})

    # ---- 39. (a) sharded steps ---------------------------------------
    record = {}
    for tag, rd, per_step, n, loss_rel in (
            ("f32", mesh["f32"], metaformer_train_spec()["per_step"], 3,
             LOSS_REL_TOL),
            ("bf16", mesh_bf16["bf16"],
             metaformer_bf16_train_spec()["per_step"], 1, None)):
        rd.pop("params")
        want = dryrun_launches(per_step, n)
        log("mesh_steps", dtype=tag, mesh=rd["mesh"], steps=n,
            loss_rel_err=f"{rd['loss_rel_err']:.3e}",
            param_err=f"{rd['param_err']:.3e}",
            rank_param_err=rd["rank_param_err"], rows=rd["rows"],
            stored_of_whole=[f"{x['stored']}/{x['whole']}"
                             for x in rd["storage"]],
            adamw_state_of_whole=[f"{x['state']}/{x['state_whole']}"
                                  for x in rd["storage"]],
            launches_per_rank=rd["rank_launches"], **(dict(
                second_step_ms_one_process=f"{rd['single_step_ms'][1]:.1f}",
                second_step_ms_ranks=[round(m[1], 1)
                                      for m in rd["rank_step_ms"]])
                if n > 1 else {}))
        dp.check_steps(rd, loss_tol=DP_LOSS_TOL, param_tol=DP_PARAM_TOL,
                       rank_tol=0.0, loss_rel_tol=loss_rel)
        for who, got in [("one process", rd["single_launches"])] + [
                (f"rank {r}", x) for r, x in enumerate(rd["rank_launches"])]:
            if got != want:
                raise AssertionError(
                    f"mesh {tag} steps, {who}: launches {got}, want {want}")
        record[f"steps_{tag}"] = rd

    # ---- 39. (b) the mesh fit ----------------------------------------
    log("mesh_fit", **{k: v for k, v in mesh_fit.items()})
    record["fit"] = mesh_fit

    # ---- 39. (c) the mesh serving pool -------------------------------
    engine = ServingEngine(model, slots=slots, cache_dtype=torch.float32)
    audio, mp = feeds["f32"]
    want, taken = [], []
    for t in range(len(audio)):
        for when, _, arg in events["f32"]:
            if when == t:
                taken.append(engine.attach(*leads[arg]))
        want.append(engine.step(audio[t], mp[t]))
    want = np.stack(want)
    del engine
    err = max(float(np.abs(o - want).max()) for o in serve32["outputs"])
    log("mesh_serving", cache="f32", slots=slots, steps=len(audio),
        vs_one_process_max_abs_err=f"{err:.3e}",
        slots_taken_equal=serve32["slots_taken"] == [taken, taken],
        refused_15_slots=serve32["refused"])
    if not err <= PATH_TOL:
        raise AssertionError(f"mesh serving f32: {err} > {PATH_TOL}")
    if serve32["slots_taken"] != [taken, taken] or serve32["refused"] != [
            True, True]:
        raise AssertionError(f"mesh serving: {serve32}")
    pct = [percentiles(ms[1:]) for ms in serve16["step_ms"]]
    log("mesh_serving", cache="bf16", slots=slots, steps=SERVE_STEPS,
        step_ms_per_rank=[fmt(x) for x in pct],
        one_process_step_ms=fmt(pool["slots"][str(slots)]["step_ms"]),
        note="two ranks on one card: nothing of scaling over cards")
    for r, run in enumerate((serve32, serve16)):
        for rank in range(2):
            got = run["launches"][rank]
            want_k1 = {"mixer_stack.launches": run["owned"][rank]}
            if got != want_k1:
                raise AssertionError(f"mesh serving run {r} rank {rank}: "
                                     f"launches {got}, want {want_k1}")
    log("mesh_serving", attaches_owned=[serve32["owned"], serve16["owned"]],
        k1_launches_per_rank=[[x.get("mixer_stack.launches", 0)
                               for x in run["launches"]]
                              for run in (serve32, serve16)])
    record["serving"] = {
        "slots": slots, "f32_max_abs_err": err,
        "bf16_step_ms_per_rank": pct,
        "one_process_bf16_step_ms": pool["slots"][str(slots)]["step_ms"],
        "owned": [serve32["owned"], serve16["owned"]],
        "launches": [serve32["launches"], serve16["launches"]]}
    shutil.rmtree(work)
    return dp_out, record


def stacked_layers_phase(mods, dev, rng):
    """36. K9's layer route (the stacks the wavefront's one cluster cannot
    hold: ``lstm_stacked_recurrence`` at H256, a layer-lagged window
    schedule of K8's chains, the input products and weight gradients on
    the tensor-core GEMMs) vs plain at the Metaformer's shapes with 2
    inner layers: B32 x T2016 (an audio-encoder block in training) and
    B32 x T252 (the self-motion and partner blocks), forward without and
    with residuals and backward, the forward's ms by window length and
    the chosen window against C = T (the layers one after the other) in
    turns, the same bits; B16 x T2096 (the decode hoist) forward without
    a gradient; cuDNN's 2-layer ``nn.LSTM`` as the yardstick; then its bf16
    mode at B32 x T2016 (``bf16_case``, the distance test over the first
    ``BF16_RECURRENCE_MODE_STEPS`` steps) beside the f32 route in turns.
    Returns (f32 cases, bf16 cases)."""
    K8, K9 = mods["K8"], mods["K9"]
    h, layers = 256, 2
    r = seeded(rng, dev)
    cases = []
    for b, t, grad in ((TRAIN_B, (LEAD + TRAIN_FRAMES) * RATIO, True),
                       (TRAIN_B, LEAD + TRAIN_FRAMES, True),
                       (B, (LEAD + FRAMES) * RATIO, False)):
        args = (r(b, t, 4 * h), r(layers - 1, h, 4 * h, s=0.06),
                r(layers - 1, 4 * h, s=0.06), r(layers, h, 4 * h, s=0.06),
                r(layers, b, h, s=0.3), r(layers, b, h, s=0.3))
        cots = (r(b, t, h), r(layers, b, h), r(layers, b, h))
        ys0, (hn0, cn0) = K9.lstm_stacked_recurrence(*args)
        with torch.no_grad():
            plain_fwd_ms, (ysr, (hr, cr)) = plain_time(
                lambda: K9.lstm_stacked_reference(*args))
        fwd_err = max_err((ys0, hn0, cn0), (ysr, hr, cr))
        fwd_ms, _ = cuda_ms(lambda: K9.lstm_stacked_forward(args, False), 5)
        # h.W_hh of every layer and h.W_ih of layers 1..L-1, all in
        # 3xTF32: 2 B T 4H H (2L - 1); the backward twice that
        flops = 2 * b * t * 4 * h * h * (2 * layers - 1)
        nores_bound = bound(0, nbytes(args, ys0, hn0, cn0),
                            tf32x3_flops=flops)
        case = dict(B=b, T=t, L=layers, H=h, route=K9.route(layers, h),
                    cluster_ctas=K8.launch_ctas(dev, b, h),
                    fwd_max_abs_err=fwd_err, fwd_ms=fwd_ms,
                    plain_fwd_ms=plain_fwd_ms,
                    fwd_no_residual_bound=nores_bound)
        if not grad:  # the decode hoist: cuDNN's forward alone
            lstm = torch.nn.LSTM(h, h, num_layers=layers,
                                 batch_first=True).to(dev)
            x = args[0][:, :, :h].contiguous()
            with torch.no_grad():
                case["library_fwd_ms"] = cuda_ms(lambda: lstm(x), 5)[0]
            check_case("lstm_stacked_layers", fwd_err, 0.0, B=b, T=t,
                       L=layers, fwd_ms=fwd_ms, plain_fwd_ms=plain_fwd_ms,
                       library_fwd_ms=case["library_fwd_ms"],
                       fwd_bound_ms=nores_bound[0])
            cases.append(case)
            del args, ys0, ysr, x, lstm
            continue
        leaves = [a.clone().requires_grad_() for a in args]
        ys, (hn, cn) = K9.lstm_stacked_recurrence(*leaves)
        grads = torch.autograd.grad((ys, hn, cn), leaves, cots)
        fwd_err = max(fwd_err, max_err((ys, hn, cn), (ysr, hr, cr)))
        del ysr, hr, cr, leaves
        plain_bwd_ms, want = plain_time(
            K9.lstm_stacked_backward_reference(args, *cots, closure=True))
        grad_err, grad_rel = max_err(grads, want), rel_err(grads, want)
        del want
        out = K9.lstm_stacked_forward(args, True)
        fwd_res_ms, _ = cuda_ms(lambda: K9.lstm_stacked_forward(args, True),
                                5)
        bwd_ms, _ = cuda_ms(lambda: K9.lstm_stacked_backward(
            args[1:], out[0], *out[3:], *cots), 5)
        fwd_bound = bound(0, nbytes(args, out), tf32x3_flops=flops)
        bwd_bound = bound(0, nbytes(args[1:], out[0], *out[3:], cots, grads),
                          tf32x3_flops=2 * flops)
        del out
        # the window schedule: ms by window length, then the chosen window
        # against C = T (the layers one after the other) in turns, a
        # training forward and backward each, and their bits
        chosen = K9.layers_chunk(t)
        sweep = chunk_sweep(
            lambda c: K9.lstm_stacked_forward(args, False, chunk=c), t,
            SWEEP_LONG if t > 1000 else SWEEP_SHORT)
        log("lstm_stacked_layers_sweep", T=t,
            fwd_ms={c: round(v, 3) for c, v in sweep.items()})

        def train_pair(c):
            o = K9.lstm_stacked_forward(args, True, chunk=c)
            return [x for x in o if x is not None] + list(
                K9.lstm_stacked_backward(args[1:], o[0], *o[3:], *cots,
                                         chunk=c))

        means, turns = in_turns(train_pair, chosen, t)
        bitwise = same_bits(train_pair(chosen), train_pair(t))
        if not bitwise:
            raise AssertionError(f"lstm_stacked_layers T={t}: window "
                                 f"{chosen} differs from C = T")
        case.update(chunk=chosen, chunk_sweep_fwd_ms=sweep,
                    train_pair_ms=means[chosen],
                    whole_sequence_train_pair_ms=means[t],
                    train_pair_turns=turns, bitwise_equal_to_whole=bitwise)
        lib_fwd_ms, lib_bwd_ms = cudnn_stacked_ms(args, cots)
        check_case("lstm_stacked_layers", fwd_err, grad_rel, B=b, T=t,
                   L=layers, cluster_ctas=case["cluster_ctas"],
                   chunk=chosen, bitwise_equal_to_whole=bitwise,
                   train_pair_ms=means[chosen],
                   whole_sequence_train_pair_ms=means[t],
                   fwd_ms=fwd_ms, fwd_res_ms=fwd_res_ms, bwd_ms=bwd_ms,
                   fwd_us_per_step=fwd_res_ms * 1e3 / t,
                   plain_fwd_ms=plain_fwd_ms, plain_bwd_ms=plain_bwd_ms,
                   library_fwd_ms=lib_fwd_ms, library_bwd_ms=lib_bwd_ms,
                   fwd_bound_ms=fwd_bound[0], bwd_bound_ms=bwd_bound[0])
        case.update(fwd_max_abs_err=fwd_err, grad_max_abs_err=grad_err,
                    grad_max_rel_err=grad_rel, fwd_res_ms=fwd_res_ms,
                    bwd_ms=bwd_ms, plain_bwd_ms=plain_bwd_ms,
                    library_fwd_ms=lib_fwd_ms, library_bwd_ms=lib_bwd_ms,
                    fwd_bound=fwd_bound, bwd_bound=bwd_bound)
        cases.append(case)
        del args, cots, grads, ys, ys0
    bf = torch.bfloat16
    b, t = TRAIN_B, (LEAD + TRAIN_FRAMES) * RATIO
    args = (r(b, t, 4 * h), r(layers - 1, h, 4 * h, s=0.06).to(bf),
            r(layers - 1, 4 * h, s=0.06), r(layers, h, 4 * h, s=0.06).to(bf),
            r(layers, b, h, s=0.3), r(layers, b, h, s=0.3))
    cots = (r(b, t, h), r(layers, b, h), r(layers, b, h))
    flops = 2 * b * t * 4 * h * h * (2 * layers - 1)
    bf16 = [bf16_case(
        "lstm_stacked_layers_bf16", flat(K9.lstm_stacked_recurrence),
        lambda a, res: K9.lstm_stacked_forward(a, res),
        lambda a, out: K9.lstm_stacked_backward(a[1:], out[0], *out[3:],
                                                *cots),
        flat(K9.lstm_stacked_reference), K9.lstm_stacked_backward_reference,
        args, cots, (flops, 2 * flops), cudnn_stacked_ms,
        lambda a, out: (a[1:], out[0], *out[3:]),
        ctas_layout(K8, dev, b, h),
        mode_steps=BF16_RECURRENCE_MODE_STEPS, B=b, T=t, L=layers, H=h)]
    return cases, bf16


def stacked_layers_records(cases, bf16_cases, launches, bf16_launches,
                           **more_launches):
    """The JSON entries of K9's layer route, forward and backward (f32)
    and its bf16 mode: the main case an audio-encoder block in training
    (B32 x T2016 x H256 x L2); launches from the 2-inner-layer
    Metaformer's training steps (f32 and bf16), those of its generation
    and eval step beside them; cuDNN's 2-layer LSTM the yardstick."""
    main = cases[0]
    keys = ("lstm_stacked_layers_fwd", "lstm_stacked_layers_bwd")
    extra = {f"launches_{k}": {n: v[n] for n in keys}
             for k, v in more_launches.items()}
    bwd = [c for c in cases if "bwd_ms" in c]
    return [
        kernel_record(
            keys[0], "lstm_recurrence.cu", "pallas_lstm_stacked.py:154",
            launches[keys[0]], max(c["fwd_max_abs_err"] for c in cases),
            main["fwd_res_ms"], main["plain_fwd_ms"], main["fwd_bound"],
            main["library_fwd_ms"], no_residual_ms=main["fwd_ms"],
            no_residual_bound_ms=main["fwd_no_residual_bound"][0],
            cluster_ctas=main["cluster_ctas"], cases=cases, **extra),
        kernel_record(
            keys[1], "lstm_recurrence.cu", "pallas_lstm_stacked.py:317",
            launches[keys[1]], max(c["grad_max_abs_err"] for c in bwd),
            main["bwd_ms"], main["plain_bwd_ms"], main["bwd_bound"],
            main["library_bwd_ms"],
            max_rel_err=max(c["grad_max_rel_err"] for c in bwd)),
        *bf16_records({"lstm_stacked_layers_bf16": (bf16_cases,
                                                    bf16_launches)}),
    ]


MIXER_KINDS = {  # the lstmformer.yaml mixer settings no shipped yaml uses
    "inner2": dict(num_internal_layer=2),
    "gru_inner2": dict(emb_mixers=["gru"] * 3, num_internal_layer=2),
    "mlp_encoders": dict(emb_mixers=["mlp", "mlp", "lstm"]),
    "mlp_main": dict(emb_mixers=["lstm", "lstm", "mlp"]),
}


def mixer_kind_spec(kind):
    """The flagship's training spec with the ``MIXER_KINDS[kind]`` mixers
    and the launches of its step, eval step and generation (5 blocks,
    5-block encoders): 2-layer LSTM mixers take K9's layer route, one a
    block (15 a step); 2-layer GRU mixers K10 per layer (30); MLP
    encoders no kernel (the self-motion LSTMs K7, as the flagship's);
    an MLP main mixer none (the encoders K3/K4, as the flagship's, the
    rollout the module loop: the fused rollout needs an LSTM main
    mixer)."""
    from multimodalreactiongeneration_tpu_torch import configs

    cfg = dict(configs.LSTMFORMER_MODEL_CFG, **MIXER_KINDS[kind])
    # num_internal_layer also sets the integrators' MHA layers (2 x 5
    # blocks x the inner layers), as in the JAX package
    k5 = 10 * cfg["num_internal_layer"]
    attn = dict(rect_attention_fwd=k5, rect_attention_bwd=k5)
    runs = {
        "inner2": (dict(lstm_stacked_layers_fwd=15,
                        lstm_stacked_layers_bwd=15),
                   dict(lstm_stacked_layers_fwd=15),
                   dict(lstm_stacked_layers_fwd=10)),
        "gru_inner2": (dict(gru_fwd=30, gru_bwd=30), dict(gru_fwd=30),
                       dict(gru_fwd=20)),
        "mlp_encoders": (dict(lstm_layer_fwd=5, lstm_layer_bwd=5),
                         dict(lstm_layer_fwd=5), dict(decode_rollout=1)),
        "mlp_main": (dict(mixer_stack_train_fwd=2, mixer_stack_bwd=2),
                     dict(mixer_stack=2), dict(mixer_stack=2)),
    }
    step, ev, gen = runs[kind]
    return dict(
        metaformer_train_spec(), tag=f"{kind}_train_step",
        eval_tag=f"{kind}_eval_step",
        cfg=cfg, stack_ab=False, profile=None, per_step=dict(step, **attn),
        per_eval=dict(ev, rect_attention_fwd=k5), per_generation=gen)


def mixer_kind_bf16_spec():
    """The 2-inner-layer Metaformer's bf16 step: K9's layer route in its
    bf16 mode, +15 / +15; rect attention's bf16 mode for the first inner
    MHA layer of block 0's two integrators (bf16 queries), K5 +2 / K6 +2,
    its f32 mode for the other 18 (the second inner layer's query comes
    out of the first's f32 context, as JAX promotes it); the eval step in
    f32; the card against CPU tensors within the
    flagship's bounds (``BF16_FLAGSHIP_CARD_CPU_TOL``,
    ``BF16_STEP_MEAN_TOL``, the CPU's f32 step, the control, beyond it)."""
    spec = mixer_kind_spec("inner2")
    spec.update(
        tag="inner2_bf16_train_step", eval_tag="inner2_bf16_eval_step",
        compute_dtype=torch.bfloat16,
        per_step=dict(lstm_stacked_layers_bf16_fwd=15,
                      lstm_stacked_layers_bf16_bwd=15,
                      rect_attention_bf16_fwd=2, rect_attention_bf16_bwd=2,
                      rect_attention_fwd=18, rect_attention_bwd=18),
        card_vs_cpu_tol=BF16_FLAGSHIP_CARD_CPU_TOL,
        f32_twin=lambda: mixer_kind_spec("inner2"),
        mean_tol=BF16_STEP_MEAN_TOL, grad_floor=1e-2)
    return spec


def mixer_kinds_phase(mods, dev, rng):
    """37. The flagship under the mixer settings ``MIXER_KINDS``, each
    driven as a user would (``mixer_kind_spec``): the training step
    (``train_path_phase``: five timed f32 steps at B32 x T240 with exact
    launches, the eval step, the card against CPU tensors at B2 x T48),
    then one ``generate_metaformer`` at B16 x ``LOOP_FRAMES`` (bf16
    caches, full mask, "auto" routes), its counts set to 0 before it:
    shape, finite,
    exact launches, ms; and the 2-inner-layer model's bf16 step
    (``mixer_kind_bf16_spec``). Returns the records and launches by
    kind."""
    from multimodalreactiongeneration_tpu_torch.infer.generate import (
        generate_metaformer,
        sampling_mask_for,
    )

    out = {}
    full = sampling_mask_for(LOOP_FRAMES, "full", device=dev)
    for kind in MIXER_KINDS:
        spec = mixer_kind_spec(kind)
        step = train_path_phase(mods, dev, rng, spec)
        model = spec_model(spec, dev)
        batch = [x.to(dev) for x in first_frames(make_batch(rng, B),
                                                 LOOP_FRAMES)]
        zero_counts(mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = generate_metaformer(model, batch, full)
        torch.cuda.synchronize()
        gen_ms = (time.perf_counter() - t0) * 1000
        if tuple(pred.shape) != (B, LOOP_FRAMES, MOTION_DIM):
            raise AssertionError(f"{kind} generation: {tuple(pred.shape)}")
        if not bool(torch.isfinite(pred).all()):
            raise AssertionError(f"{kind} generation: non-finite output")
        gen_launches = counts(mods)
        check_launches(f"{kind} generation", dict.fromkeys(COUNTERS, 0),
                       gen_launches, **spec["per_generation"])
        log(f"{kind}_generate", batch=B, frames=LOOP_FRAMES,
            ms=f"{gen_ms:.3f}",
            launches={k: v for k, v in gen_launches.items() if v})
        out[kind] = dict(step, generation_launches=gen_launches,
                         generation_ms=gen_ms)
        del model, batch, pred
    out["inner2_bf16"] = train_path_phase(mods, dev, rng,
                                          mixer_kind_bf16_spec())
    return out


# ---- 38. the offline corpus pipeline -------------------------------------
SR, FPS = 16000, 25


def raw_channels(rng, seconds):
    """A dyadic session's clean channels: comp and host take turns of
    3-8 s noise bursts 2.5-4 s apart, and the listener answers within the
    first 4 s of each turn with a 0.4-0.8 s burst at half the loudness,
    so both channels sound in any 10 s window (the alignment's fine stage
    correlates one). Both speak equally loud: the coarse stage correlates
    RMS envelopes, and a louder partner's turn could outweigh a channel's
    own. The mix is their mean."""
    n = int(seconds * SR)
    waves = np.zeros((2, n), np.float32)
    t, who = 1.0, 0
    while True:
        length = rng.uniform(3.0, 8.0)
        if t + length + 1.0 > seconds:
            break
        a, z = int(t * SR), int((t + length) * SR)
        waves[who, a:z] += 0.3 * rng.standard_normal(z - a)
        b = t + rng.uniform(0.5, min(length - 1.0, 3.0))
        a, z = int(b * SR), int((b + rng.uniform(0.4, 0.8)) * SR)
        waves[1 - who, a:z] += 0.15 * rng.standard_normal(z - a)
        t, who = t + length + rng.uniform(2.5, 4.0), who ^ 1
    return waves[0], waves[1], 0.5 * (waves[0] + waves[1])


def plant(clean, shift):
    """``clean`` recorded ``shift`` samples late (positive: leading
    silence) or early (negative: its head cut)."""
    if shift >= 0:
        return np.concatenate([np.zeros(shift, np.float32), clean])
    return clean[-shift:]


def side_by_side_movie(frames):
    """(frames, h, w, 3) uint8: the frame index in pixels 0 and 1 of each
    half's first pixel, the half (0 comp, 1 host) in pixel 2."""
    h, w = RAW_FRAME
    movie = np.zeros((frames, h, w, 3), np.uint8)
    t = np.arange(frames)
    for side, x in ((0, 0), (1, w // 2)):
        movie[:, 0, x, 0] = t % 256
        movie[:, 0, x, 1] = t // 256
        movie[:, 0, x, 2] = side
    return movie


class SyntheticLandmarker:
    """Stands in for mediapipe: a fixed random face (MediaPipe's eye,
    chin and forehead points placed) posed by a smooth trajectory of the
    frame index the movie carries (within +-40 degrees), no face on a
    3-frame gap every 400 frames (interpolated by extract_angle_cent) and
    on a 20-frame gap of the host (a split)."""

    def __init__(self, seed):
        from multimodalreactiongeneration_tpu_torch.ops import rotations

        self.rot = rotations
        base = np.random.default_rng(seed).uniform(-0.15, 0.15, (478, 3))
        base[rotations.LM_EYE_R] = [-0.2, 0.0, 0.0]
        base[rotations.LM_EYE_L] = [0.2, 0.0, 0.0]
        base[rotations.LM_FOREHEAD] = [0.0, -0.25, 0.0]
        base[rotations.LM_CHIN] = [0.0, 0.25, 0.0]
        self.base = base

    def __call__(self, frame):
        t = int(frame[0, 0, 0]) + 256 * int(frame[0, 0, 1])
        side = int(frame[0, 0, 2])
        if t % 400 in (200, 201, 202) or (side and 700 <= t < 720):
            return None
        return self.face(t, side)

    def face(self, t, side):
        """(478, 3) float32 landmarks of frame ``t`` of a side."""
        ang = np.array([20.0 * np.sin(2 * np.pi * t / 250 + side),
                        10.0 * np.sin(2 * np.pi * t / 170),
                        5.0 * np.sin(2 * np.pi * t / 330)])
        m = self.rot.angles_to_matrix(ang, "xyz")
        center = np.array([0.5 + 0.05 * np.sin(t / 90.0), 0.5, 0.0])
        return (self.base @ m + center).astype(np.float32)


def open_array_movie(path):
    """A movie stored as a numpy array (the raw corpus's stand-in for an
    mp4)."""
    from multimodalreactiongeneration_tpu_torch.corpus.video import (
        ArrayVideoReader,
    )

    return ArrayVideoReader(np.load(path), fps=FPS)


def array_trim_runner(cmd, check):
    """Stands in for ffmpeg in ``infer/video.py trim_video``: the frames
    of ``-i`` in [``-ss``, ``-to``) seconds to the last argument."""
    frames = np.load(cmd[cmd.index("-i") + 1])
    a = round(float(cmd[cmd.index("-ss") + 1]) * FPS)
    z = round(float(cmd[cmd.index("-to") + 1]) * FPS)
    with open(cmd[-1], "wb") as f:
        np.save(f, frames[a:z])


def write_raw_corpus(root, sessions=RAW_SESSIONS, seconds=RAW_SECONDS,
                     seed=SEED + 38):
    """Raw sessions ``data00``.. as recorded: comp.wav and host.wav with
    planted shifts against the session mix pair.wav, and the side-by-side
    movie.mp4 (an array movie) over the mix. Returns the planted shifts
    by session."""
    from multimodalreactiongeneration_tpu_torch.utils.wavio import write_wav

    rng = np.random.default_rng(seed)
    planted = {}
    for s in range(sessions):
        d = os.path.join(root, f"data{s:02d}")
        os.makedirs(d, exist_ok=True)
        comp, host, mix = raw_channels(rng, seconds)
        shifts = {"comp": int(rng.integers(800, 8000)),
                  "host": -int(rng.integers(800, 8000))}
        write_wav(os.path.join(d, "pair.wav"), mix[None], SR)
        for who, clean in (("comp", comp), ("host", host)):
            write_wav(os.path.join(d, f"{who}.wav"),
                      plant(clean, shifts[who])[None], SR)
        with open(os.path.join(d, "movie.mp4"), "wb") as f:
            np.save(f, side_by_side_movie(int(seconds * FPS)))
        planted[f"data{s:02d}"] = shifts
    return planted


def corpus_chain(root, device, planted, config="configs/lstmformer.yaml"):
    """The corpus CLIs, as a user runs them, on the raw corpus at
    ``root / raw``: ``corpus.alignment``, ``corpus.landmarks`` (into the
    aligned tree, beside its wavs), ``corpus.extract_angle_cent``, then
    the training CLI's loaders at ``config`` over the built corpus (the
    manifests under ./data of ``root``; per-batch native PCM16 reads, no
    audio cache) and one batch. Checks each stage; returns the seconds of
    each and the batch."""
    from multimodalreactiongeneration_tpu_torch.configs import load_config
    from multimodalreactiongeneration_tpu_torch.corpus import (
        alignment,
        extract_angle_cent,
        landmarks,
    )
    from multimodalreactiongeneration_tpu_torch.data.head_io import (
        load_head_file,
    )
    from multimodalreactiongeneration_tpu_torch.train.cli import (
        make_streaming_loaders,
    )
    from multimodalreactiongeneration_tpu_torch.utils.logging import (
        DummyLogger,
    )

    raw, aligned, npz = (os.path.join(root, d)
                         for d in ("raw", "aligned", "npz"))
    on = ["--device", str(device)]
    seconds = {}
    t0 = time.perf_counter()
    alignment.main(["--target", raw, "--output", aligned, *on],
                   video_runner=array_trim_runner)
    seconds["alignment"] = time.perf_counter() - t0
    for session, want in planted.items():
        with open(os.path.join(aligned, session, "alignment.json")) as f:
            got = json.load(f)["shifts"]
        if got != want:
            raise AssertionError(f"{session}: shifts {got}, planted {want}")
    t0 = time.perf_counter()
    landmarks.main(["--target", aligned, "--output", aligned, *on],
                   landmarker=SyntheticLandmarker(SEED + 38),
                   open_video_fn=open_array_movie)
    seconds["landmarks"] = time.perf_counter() - t0
    heads = 0
    for session in planted:
        frames = len(np.load(os.path.join(aligned, session, "movie.mp4")))
        for who in ("comp", "host"):
            d = os.path.join(aligned, session, who)
            names = sorted(n for n in os.listdir(d) if n.endswith(".head"))
            if len(names) != frames:
                raise AssertionError(f"{d}: {len(names)} heads, {frames} "
                                     "frames")
            _, head = load_head_file(os.path.join(d, names[0]))
            if head is None or not np.all(head.angle_std > 0):
                raise AssertionError(f"{d}: statistics not stamped")
            heads += len(names)
    t0 = time.perf_counter()
    extract_angle_cent.main(["--path", aligned, "--output", npz, *on])
    seconds["extract_angle_cent"] = time.perf_counter() - t0
    sections = {}
    for session in planted:
        names = sorted(os.listdir(os.path.join(npz, session)))
        sections[session] = [n for n in names if n.endswith(".npz")]
        # the host's 20-frame gap splits it in two; comp's 3-frame gaps
        # are interpolated
        if [n.split("_")[0] for n in sections[session]] != [
                "comp", "host", "host"] or "comp.wav" not in names:
            raise AssertionError(f"{session}: {names}")
    cwd = os.getcwd()
    config = os.path.abspath(config)
    os.chdir(root)  # the manifests go under ./data of ``root``
    try:
        cfg = load_config(config, [f"data_dir={npz}", "batch_size=4",
                                   "trainer.cache_audio_mb=0",
                                   "trainer.prefetch_batches=0"])
        t0 = time.perf_counter()
        train, _, _, dataset = make_streaming_loaders(cfg, DummyLogger(),
                                                      device)
        batch = next(iter(train))
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds["databuild_and_batch"] = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    for m, (data, lengths) in enumerate(batch):
        data = torch.as_tensor(data)
        if not bool(torch.isfinite(data).all()) or len(lengths) != 4:
            raise AssertionError(f"loader batch entry {m}: not finite or "
                                 f"{len(lengths)} rows")
    return {"seconds": seconds, "heads": heads, "segments": len(dataset),
            "npz_sections": sections, "batch": batch}


def corpus_pipeline_phase(dev, card):
    """38. (module docstring)"""
    from multimodalreactiongeneration_tpu_torch import _build
    from multimodalreactiongeneration_tpu_torch.ops import (
        dsp_reference,
        rotations,
        xcorr,
    )

    cpu = torch.device("cpu")
    rng = np.random.default_rng(SEED + 38)
    record = {}
    # the lag search on a corpus session's 540 s
    comp, host, mix = raw_channels(rng, CORPUS_SECONDS)
    planted = {"comp": int(rng.integers(800, 8000)),
               "host": -int(rng.integers(800, 8000))}
    chans = {"comp": plant(comp, planted["comp"]),
             "host": plant(host, planted["host"])}
    lags, ms = {}, {}
    for where, d in (("card", dev), ("cpu", cpu)):
        xcorr.align_shift(mix, chans["comp"], SR, device=d)  # warm-up
        t0 = time.perf_counter()
        lags[where] = {who: xcorr.align_shift(mix, ch, SR, device=d)
                       for who, ch in chans.items()}
        ms[where] = (time.perf_counter() - t0) * 1000 / len(chans)
    log("corpus_align_shift", seconds=CORPUS_SECONDS, planted=planted,
        card=lags["card"], cpu=lags["cpu"], ms_card=f"{ms['card']:.3f}",
        ms_cpu=f"{ms['cpu']:.3f}", card_line=repr(card))
    if not lags["card"] == lags["cpu"] == planted:
        raise AssertionError(f"align_shift: card {lags['card']}, cpu "
                             f"{lags['cpu']}, planted {planted}")
    record["align_shift"] = {"seconds_of_audio": CORPUS_SECONDS,
                             "lags": lags["card"], "ms_card": ms["card"],
                             "ms_cpu": ms["cpu"]}

    # the head pose of a 540 s side's frames, at once and in chunks
    frames = int(CORPUS_SECONDS * FPS)
    lm = SyntheticLandmarker(SEED + 38)
    lms = np.stack([lm.face(t, 0) for t in range(frames)])
    w, h = 640.0, 480.0
    ms_pose, ang_card = cuda_ms(
        lambda: rotations.landmarks_to_pose(lms, w, h, device=dev), 3)
    ms_chunks, chunks = cuda_ms(lambda: [
        rotations.landmarks_to_pose(lms[i:i + 256], w, h, device=dev)
        for i in range(0, frames, 256)], 1)
    ang_cpu, cen_cpu = rotations.landmarks_to_pose(lms, w, h, device=cpu)
    errs = {}
    for tag, (a, c) in (("whole", ang_card), ("chunks", (
            torch.cat([x[0] for x in chunks]),
            torch.cat([x[1] for x in chunks])))):
        errs[tag] = (float((a.cpu() - ang_cpu).abs().max()),
                     float((c.cpu() - cen_cpu).abs().max()))
    log("corpus_landmarks_to_pose", frames=frames, landmarks=478,
        angle_err_deg=f"{max(e[0] for e in errs.values()):.3e}",
        centroid_err=f"{max(e[1] for e in errs.values()):.3e}",
        ms_whole=f"{ms_pose:.3f}", ms_chunks_of_256=f"{ms_chunks:.3f}",
        card_line=repr(card))
    for tag, (ea, ec) in errs.items():
        if not (ea <= POSE_TOL[0] and ec <= POSE_TOL[1]):
            raise AssertionError(f"landmarks_to_pose {tag}: {ea}, {ec} > "
                                 f"{POSE_TOL}")
    record["landmarks_to_pose"] = {"frames": frames, "errors": errs,
                                   "ms_whole": ms_pose,
                                   "ms_chunks_of_256": ms_chunks}

    # the Kaldi reference extractor over the 540 s channel
    p = dsp_reference.KaldiParams(dither=0.0)
    ms_fbank, (fb, lp) = cuda_ms(
        lambda: dsp_reference.compute_fbank(comp, p, device=dev), 3)
    fb_cpu, lp_cpu = dsp_reference.compute_fbank(comp, p, device=cpu)
    fb_err = float((fb.cpu() - fb_cpu).abs().max())
    lp_err = float((lp.cpu() - lp_cpu).abs().max())
    log("corpus_fbank_reference", frames=tuple(fb.shape),
        logmel_err=f"{fb_err:.3e}", log_power_err=f"{lp_err:.3e}",
        ms=f"{ms_fbank:.3f}", card_line=repr(card))
    if not (fb_err <= FBANK_REF_TOL[0] and lp_err <= FBANK_REF_TOL[1]):
        raise AssertionError(f"compute_fbank: {fb_err}, {lp_err} > "
                             f"{FBANK_REF_TOL}")
    record["fbank_reference"] = {"frames": int(fb.shape[0]),
                                 "logmel_err": fb_err,
                                 "log_power_err": lp_err, "ms": ms_fbank}

    # the corpus CLIs on a short raw corpus
    root = str(_build.BUILD_DIR / "corpus_run")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    planted = write_raw_corpus(os.path.join(root, "raw"))
    write_s = time.perf_counter() - t0
    try:
        chain = corpus_chain(root, dev, planted)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("corpus_cli_chain", sessions=RAW_SESSIONS, seconds=RAW_SECONDS,
        heads=chain["heads"], segments=chain["segments"],
        npz_sections=chain["npz_sections"], write_s=f"{write_s:.1f}",
        **{f"{k}_s": f"{v:.2f}" for k, v in chain["seconds"].items()},
        card_line=repr(card))
    record["cli_chain"] = {k: chain[k] for k in ("seconds", "heads",
                                                  "segments", "npz_sections")}
    return record


def attention_shape_case(K5, r, rng, dev, e, heads, bf16):
    """Phase 40, K5/K6 at one (E, heads) of the rate-aligned integrators'
    shape (B32 x Lq 252 x Lk 2016, 10% padded rows and keys), f32 or bf16
    operands: the wrapper as the model calls it (the forward without a
    gradient, then with one and the backward: launches exact), against
    the plain version of the mode (f32: ``check_case``; bf16:
    ``bf16_check`` within ``BF16_ATTN_TOL``); the wrapper's ms (a head
    dim that is no tile includes its padded copies), the plain version's,
    SDPA's with the boolean mask in the same dtype; the bounds at the
    real head dim and at its tile."""
    import torch.nn.functional as F

    b, lq, lk = TRAIN_B, LEAD + TRAIN_FRAMES, (LEAD + TRAIN_FRAMES) * RATIO
    d = e // heads
    dp = K5.padded_head_dim(d)
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, v, g = (r(b, lq, e).to(dt), r(b, lk, e).to(dt), r(b, lk, e).to(dt),
                  r(b, lq, e))
    q_pad = torch.from_numpy(rng.random((b, lq)) < 0.1).to(dev)
    k_pad = torch.from_numpy(rng.random((b, lk)) < 0.1).to(dev)
    args = (heads, q, k, v, q_pad, k_pad)
    keys = (("rect_attention_bf16_fwd", "rect_attention_bf16_bwd") if bf16
            else ("rect_attention_fwd", "rect_attention_bwd"))
    read = lambda: {n: getattr(K5, COUNTERS[n][1]) for n in keys}
    before = read()
    with torch.no_grad():
        out0 = K5.rect_attention(*args)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = K5.rect_attention(heads, *leaves, q_pad, k_pad)
    grads = torch.autograd.grad(out, leaves, g)
    got = {n: v - before[n] for n, v in read().items()}
    if got != {keys[0]: 2, keys[1]: 1}:
        raise AssertionError(f"rect attention E{e} x {heads} heads: "
                             f"launches {got}")
    tag = "rect_attention_shapes" + ("_bf16" if bf16 else "")
    shape = dict(B=b, Lq=lq, Lk=lk, E=e, heads=heads, head_dim=d, tile=dp)
    plain = (K5.rect_attention_bf16_reference if bf16
             else K5.rect_attention_reference)
    with torch.no_grad():
        plain_fwd_ms, want = cuda_ms(lambda: plain(*args), 1)
    plain_bwd_ms, wgrads = cuda_ms(
        K5.rect_attention_backward_reference(*args, g, closure=True), 1)
    if bf16:
        with torch.no_grad():
            ctx32 = K5.rect_attention_reference(
                heads, q.float(), k.float(), v.float(), q_pad, k_pad)
        errs = bf16_check(tag, (out0, out.detach()), grads, (want, want),
                          wgrads, (ctx32,), False, tol=BF16_ATTN_TOL,
                          **shape)
        del ctx32
    else:
        errs = dict(fwd_max_abs_err=max_err((out0, out), (want, want)),
                    grad_max_abs_err=max_err(grads, wgrads),
                    grad_max_rel_err=rel_err(grads, wgrads))
    del out0, out, want, wgrads
    ctx, m, l = K5.rect_attention_forward(*args, residuals=True)
    fwd_ms, _ = cuda_ms(lambda: K5.rect_attention_forward(*args), 5)
    fwd_res_ms, _ = cuda_ms(
        lambda: K5.rect_attention_forward(*args, residuals=True), 5)
    bwd_ms, _ = cuda_ms(
        lambda: K5.rect_attention_backward(*args, ctx, m, l, g), 5)
    # yardstick only, never called by the port
    allowed = ~K5.rect_attention_mask(q_pad, k_pad)[:, None]
    lib_leaves = [x.clone().requires_grad_() for x in (q, k, v)]

    def split(x):
        return x.view(b, x.shape[1], heads, d).transpose(1, 2)

    lib_fwd_ms, lib_out = cuda_ms(lambda: F.scaled_dot_product_attention(
        *[split(x) for x in lib_leaves], attn_mask=allowed), 5)
    lib_bwd_ms, _ = cuda_ms(lambda: torch.autograd.grad(
        lib_out, lib_leaves, split(g.to(dt)), retain_graph=True), 5)
    del lib_out, lib_leaves, allowed
    # per visible (query, key) pair and head dim: 4 FLOPs forward, 10
    # backward (3xTF32 in the f32 mode, bf16 in the bf16 mode); the bytes
    # of every input and output; at the tile both grow by dp / d
    pairs = rect_pairs(q_pad, k_pad) * heads
    fwd_bytes = nbytes(args, ctx, m, l)
    bwd_bytes = nbytes(args, m, l, g, grads) + (0 if bf16 else nbytes(ctx))

    def at(width, flops, bytes_):
        if bf16:
            return bound_bf16(flops * width, bytes_)
        return bound(0, bytes_, tf32x3_flops=flops * width)

    grow = dp / d
    bounds = dict(fwd_bound=at(d, 4 * pairs, fwd_bytes),
                  bwd_bound=at(d, 10 * pairs, bwd_bytes),
                  fwd_tile_bound=at(dp, 4 * pairs, fwd_bytes * grow),
                  bwd_tile_bound=at(dp, 10 * pairs, bwd_bytes * grow))
    del ctx, m, l, grads
    times = dict(fwd_ms=fwd_ms, fwd_res_ms=fwd_res_ms, bwd_ms=bwd_ms,
                 plain_fwd_ms=plain_fwd_ms, plain_bwd_ms=plain_bwd_ms,
                 library_fwd_ms=lib_fwd_ms, library_bwd_ms=lib_bwd_ms)
    if not bf16:
        check_case(tag, errs["fwd_max_abs_err"], errs["grad_max_rel_err"],
                   **shape, **times,
                   **{k_: v_[0] for k_, v_ in bounds.items()})
    else:
        log(tag, **shape, **fmt(times),
            **{k_: round(v_[0], 4) for k_, v_ in bounds.items()})
    return dict(**shape, **errs, **times, **bounds)


def entry_point_case(tag, shape, kernels, mod, entry, plain, plain_bwd,
                     args, cots, launches, bf16, mode_steps, tol=None,
                     mode_frac=BF16_MODE_FRAC, library=None):
    """The run phases 40 and 41 make of one shape of a recurrence's entry
    point ``entry`` (flat outputs; ``kernels`` names its kernels in an
    error): without a gradient, then with one and the backward, module
    ``mod``'s counters move by exactly ``launches``;
    against the plain version ``plain`` / ``plain_bwd`` of the mode (f32:
    forward and gradient errors; bf16: ``bf16_check`` over the full
    length within ``tol``, the distance test over the first
    ``mode_steps`` steps within ``mode_frac``); the entry point's ms (forward without a
    gradient, with one, forward plus backward), the plain version's and
    ``library``'s (args, cots, dtype -> forward and backward ms) where
    given. Returns the errors, the times, the bytes the forward and the
    backward read and write, and whether the outputs without a gradient
    are the bits of those with one."""
    wt = torch.bfloat16 if bf16 else torch.float32
    read = lambda: {k: getattr(mod, COUNTERS[k][1]) for k in launches}  # noqa
    before = read()
    with torch.no_grad():
        outs0 = entry(*args)
    leaves = [a.clone().requires_grad_() for a in args]
    outs = entry(*leaves)
    grads = torch.autograd.grad(outs, leaves, cots)
    outs = tuple(o.detach() for o in outs)
    got = {k: v - before[k] for k, v in read().items()}
    if got != launches:
        raise AssertionError(f"{tag} {shape}: launches {got} ({kernels})")
    with torch.no_grad():
        plain_fwd_ms, want = plain_time(lambda: plain(*args))
    plain_bwd_ms, want_grads = plain_time(plain_bwd(args, *cots, closure=True))
    if bf16:
        with torch.no_grad():
            ys32 = plain(*[a.float() for a in args])[0]
        errs = bf16_check(tag, outs0 + outs, grads, want * 2, want_grads,
                          (ys32,), short=False, tol=tol,
                          mode_frac=mode_frac, mode_steps=mode_steps,
                          **shape)
        del ys32
    else:
        errs = dict(fwd_max_abs_err=max_err(outs0 + outs, want * 2),
                    grad_max_abs_err=max_err(grads, want_grads),
                    grad_max_rel_err=rel_err(grads, want_grads))
    del want, want_grads

    def pair():
        lv = [a.clone().requires_grad_() for a in args]
        return torch.autograd.grad(entry(*lv), lv, cots)

    with torch.no_grad():
        fwd_ms, _ = cuda_ms(lambda: entry(*args), 3)
    fwd_res_ms, _ = cuda_ms(lambda: entry(*leaves), 3)
    pair_ms, _ = cuda_ms(pair, 3)
    times = dict(fwd_ms=fwd_ms, fwd_res_ms=fwd_res_ms,
                 bwd_ms=pair_ms - fwd_res_ms, train_pair_ms=pair_ms,
                 fwd_us_per_step=fwd_res_ms * 1e3 / args[0].shape[1],
                 plain_fwd_ms=plain_fwd_ms, plain_bwd_ms=plain_bwd_ms)
    if library is not None:
        times["library_fwd_ms"], times["library_bwd_ms"] = library(
            args, cots, wt)
    return (errs, times, nbytes(args, outs), nbytes(args, outs, cots, grads),
            same_bits(outs0, outs))


def shape_case_record(tag, bf16, errs, times, bounds, **info):
    """Logs one case of phases 40 and 41 (f32: ``check_case``'s gates) and
    returns its record."""
    if not bf16:
        check_case(tag, errs["fwd_max_abs_err"], errs["grad_max_rel_err"],
                   **info, **times,
                   **{k_: v_[0] for k_, v_ in bounds.items()})
    else:
        log(tag, **info, **fmt(times),
            **{k_: round(v_[0], 4) for k_, v_ in bounds.items()})
    return dict(**info, **errs, **times, **bounds)


def recurrence_shape_case(kind, mod, r, dev, b, t, h, bf16, layers=2):
    """Phase 40, one shape of K10 (``kind`` "gru"), K8 ("lstm") or K9's
    layer route ("stacked", ``layers`` deep), f32 or bf16 W, through
    ``entry_point_case`` (launches +2 / +1; a hidden size the kernels are
    not built for runs padded; bf16: the distance test over the first
    ``BF16_RECURRENCE_MODE_STEPS`` steps; cuDNN in the same dtype); the
    bounds at the real H and at the H the kernels run."""
    from multimodalreactiongeneration_tpu_torch.ops.hidden_pad import (
        padded_hidden,
    )

    wt = torch.bfloat16 if bf16 else torch.float32
    hp = padded_hidden(h)
    if kind == "gru":
        g = 3
        args = (r(b, t, 3 * h, s=0.5), r(h, 3 * h, s=0.06).to(wt),
                r(3 * h, s=0.1), r(b, h, s=0.3))
        cots = (r(b, t, h), r(b, h))
        entry, plain = flat(mod.gru_recurrence), flat(
            mod.gru_recurrence_reference)
        plain_bwd, lib = mod.gru_backward_reference, cudnn_gru_ms
        keys, nmat = ("gru_fwd", "gru_bwd"), 1
    elif kind == "lstm":
        g = 4
        args = (r(b, t, 4 * h, s=0.5), r(h, 4 * h, s=0.06).to(wt),
                r(b, h, s=0.3), r(b, h, s=0.3))
        cots = (r(b, t, h), r(b, h), r(b, h))
        entry, plain = flat(mod.lstm_recurrence), flat(
            mod.lstm_recurrence_reference)
        plain_bwd, lib = (mod.lstm_recurrence_backward_reference,
                          cudnn_recurrence_ms)
        keys, nmat = ("lstm_recurrence_fwd", "lstm_recurrence_bwd"), 1
    else:
        g = 4
        args = (r(b, t, 4 * h), r(layers - 1, h, 4 * h, s=0.06).to(wt),
                r(layers - 1, 4 * h, s=0.06),
                r(layers, h, 4 * h, s=0.06).to(wt),
                r(layers, b, h, s=0.3), r(layers, b, h, s=0.3))
        cots = (r(b, t, h), r(layers, b, h), r(layers, b, h))
        entry, plain = flat(mod.lstm_stacked_recurrence), flat(
            mod.lstm_stacked_reference)
        plain_bwd, lib = mod.lstm_stacked_backward_reference, cudnn_stacked_ms
        keys = ("lstm_stacked_layers_fwd", "lstm_stacked_layers_bwd")
        nmat = 2 * layers - 1
    if bf16:
        keys = tuple(k.replace("_fwd", "_bf16_fwd").replace(
            "_bwd", "_bf16_bwd") for k in keys)
    modk = {"gru": "K10", "lstm": "K8", "stacked": "K9"}[kind]
    tag = f"{kind}_shapes" + ("_bf16" if bf16 else "")
    shape = dict(B=b, T=t, H=h, H_run=hp, **(
        dict(L=layers, route=mod.route(layers, h)) if kind == "stacked"
        else {}))
    errs, times, fwd_bytes, bwd_bytes, _ = entry_point_case(
        tag, shape, modk, mod, entry, plain, plain_bwd, args, cots,
        {keys[0]: 2, keys[1]: 1}, bf16, BF16_RECURRENCE_MODE_STEPS,
        library=lib)
    # the chains' products h W_hh (and, stacked, h W_ih of the layers
    # above the first): 2 B T gH H each, forward; the backward twice that
    # (its carry product and the weight reductions); 3xTF32 in the f32
    # mode, bf16 in the bf16 mode; the bytes of every input and output
    flops = 2 * b * t * g * h * h * nmat

    def at(n, bytes_):
        if bf16:
            return bound_bf16(n, bytes_)
        return bound(0, bytes_, tf32x3_flops=n)

    grow = hp / h
    bounds = dict(fwd_bound=at(flops, fwd_bytes),
                  bwd_bound=at(2 * flops, bwd_bytes),
                  fwd_run_bound=at(flops * grow * grow, fwd_bytes * grow),
                  bwd_run_bound=at(2 * flops * grow * grow,
                                   bwd_bytes * grow))
    return shape_case_record(tag, bf16, errs, times, bounds, **shape)


def kernel_shapes_phase(mods, dev, rng):
    """40a. The shapes this slice opens, each kernel against its plain
    version on the card in the existing gates (f32: forward 1e-4 abs,
    gradients 1e-3 of the largest; bf16: ``BF16_ATTN_TOL``, the
    ``BF16_FULL_TOL`` of a full length), f32 and bf16: K5/K6 at B32 x 252
    x 2016 with head dims 16 (E 256, 16 heads), 48 (E 192, 4 heads: run
    on the 64 tile), 128 (E 256, 2 heads) and 256 (E 256, 1 head); K10
    and K8 at B32 x T252 x H 64, 192 and 100 (run on 128); K10 at B32 x
    T2016 x H192 (f32: its bf16 mode at T2016 is phase 29b's, cut here
    for room); K9's layer route at B256 x T1120 x H192 x L2. Returns
    {kernel: [cases]}."""
    r = seeded(rng, dev)
    out = {}
    for bf16 in (False, True):
        sfx = "_bf16" if bf16 else ""
        out["rect_attention" + sfx] = [
            attention_shape_case(mods["K5"], r, rng, dev, e, heads, bf16)
            for e, heads in SHAPE_HEADS]
        out["gru" + sfx] = [
            recurrence_shape_case("gru", mods["K10"], r, dev, b, t, h, bf16)
            for b, t, h in [(TRAIN_B, LEAD + TRAIN_FRAMES, h)
                            for h in SHAPE_HIDDEN] + [
                (TRAIN_B, (LEAD + TRAIN_FRAMES) * RATIO, 192)][
                    :len(SHAPE_HIDDEN) + (not bf16)]]
        out["lstm_recurrence" + sfx] = [
            recurrence_shape_case("lstm", mods["K8"], r, dev, TRAIN_B,
                                  LEAD + TRAIN_FRAMES, h, bf16)
            for h in SHAPE_HIDDEN]
        out["lstm_stacked_layers" + sfx] = [
            recurrence_shape_case("stacked", mods["K9"], r, dev, LWS_B,
                                  (LWS_FRAMES + LEAD) * RATIO, 192, bf16)]
    return out


def shape_model_specs():
    """40b. The configurations this slice opens, at full width, as the
    shipped yamls with ``hidden_size`` / ``num_heads`` overridden: the
    GRU Metaformer at hidden 192, 4 heads (K10 at H192 in its 15 GRU
    blocks, K5/K6 at head dim 48), lstm_with_sampling at hidden 192,
    sampler 192 (K8 at H192 in its two blocks, K9's layer route at H192
    x L2), the flagship at 2 heads (head dim 128) and 1 head (256). Each
    spec: its f32 step, its bf16 step (where named), whether it runs an
    eval step and a generation."""
    from multimodalreactiongeneration_tpu_torch import configs

    gru = dict(configs.LSTMFORMER_GRU_MODEL_CFG, hidden_size=192,
               num_heads=4)
    lws = dict(configs.LWS_MODEL_CFG, hidden_size=192,
               sampler_hidden_size=192)
    specs = []
    for name, f32, bf16, extra in (
            ("gru_h192_heads4", gru_train_spec, gru_bf16_train_spec,
             dict(cfg=gru)),
            # its blocks run K8 (as under MRGEN_FUSED_DW=0): phase 20's
            # bf16 gates on that route
            ("lws_h192", lws_train_spec, lws_bf16_off_spec, dict(cfg=lws)),
            ("flagship_heads2", metaformer_train_spec,
             metaformer_bf16_train_spec,
             dict(cfg=dict(configs.LSTMFORMER_MODEL_CFG, num_heads=2))),
            ("flagship_heads1", metaformer_train_spec, None,
             dict(cfg=dict(configs.LSTMFORMER_MODEL_CFG, num_heads=1)))):
        step = dict(f32(), **extra, tag=f"{name}_train_step",
                    eval_tag=f"{name}_eval_step", profile=None,
                    stack_ab=False, steps=SHAPE_STEPS)
        if name.startswith("lws"):  # K8 at H192 in the blocks, K9's layers
            step.update(per_step=dict(lstm_stacked_layers_fwd=1,
                                      lstm_stacked_layers_bwd=1,
                                      lstm_recurrence_fwd=2,
                                      lstm_recurrence_bwd=2),
                        per_eval=dict(lstm_stacked_layers_fwd=1,
                                      lstm_recurrence_fwd=2))
        half = None
        if bf16 is not None:
            twin = step
            half = dict(bf16(), **extra, tag=f"{name}_bf16_train_step",
                        eval_tag=f"{name}_bf16_eval_step", profile=None,
                        stack_ab=False, steps=1)
            if "f32_twin" in half:  # the control: this configuration's
                half["f32_twin"] = lambda s=twin: s
            if name.startswith("lws"):
                half.update(per_step=dict(lstm_stacked_layers_bf16_fwd=1,
                                          lstm_stacked_layers_bf16_bwd=1,
                                          lstm_recurrence_bf16_fwd=2,
                                          lstm_recurrence_bf16_bwd=2),
                            per_eval=step["per_eval"])
        specs.append((name, step, half))
    return specs


def shape_generation_specs():
    """40c. One generation of the GRU Metaformer at hidden 192, 4 heads
    (K10 +10: its hoisted encoders) and of lstm_with_sampling at hidden
    192, sampler 192 (K9's layer route +1: the sampler's warmup), each as
    phase 15 / 11 runs it (one batch of 16 x 250, then the teacher-forced
    f32 generation at B2 against CPU tensors)."""
    from multimodalreactiongeneration_tpu_torch import configs
    from multimodalreactiongeneration_tpu_torch.models.lstm_with_sampling \
        import LSTMwithSample
    from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
        Metaformer,
    )

    gru = dict(configs.LSTMFORMER_GRU_MODEL_CFG, hidden_size=192,
               num_heads=4)
    lws = dict(configs.LWS_MODEL_CFG, hidden_size=192,
               sampler_hidden_size=192)
    return [
        dict(gru_generation_spec(), tag="gru_h192_heads4",
             model=lambda device: Metaformer(
                 gru, generator=torch.Generator().manual_seed(SEED),
                 device=device)),
        dict(lws_generation_spec(), tag="lws_h192",
             per_generation=dict(lstm_stacked_layers_fwd=1),
             model=lambda device: LSTMwithSample(
                 lws, generator=torch.Generator().manual_seed(SEED),
                 device=device))]


def shape_phases(mods, dev, kernels=True, models=True):
    """40. The head counts and hidden sizes this slice opens
    (``SEED + 40``): with ``kernels`` the kernels at each new shape
    against their plain versions (``kernel_shapes_phase``), then with
    ``models`` the configurations at full width through the step
    functions (``train_path_phase``: the f32 steps, eval, one SGD step
    card against CPU at B2 x T48; the bf16 step with phase 31's, 32's and
    20's gates) and the generations. Each part draws from a generator of
    its own (``SEED + 40``), so the kernel cases do not move the models'
    batches. Returns the kernel cases ({} without ``kernels``), the model
    runs' launches and their records."""
    cases = (kernel_shapes_phase(mods, dev, np.random.default_rng(SEED + 40))
             if kernels else {})
    rng = np.random.default_rng(SEED + 40)
    launches = {k: 0 for k in COUNTERS}
    records = {}
    runs = []
    if models:
        runs = [(spec["tag"], lambda s=spec: train_path_phase(mods, dev, rng,
                                                              s))
                for _, step, half in shape_model_specs()
                for spec in (step, half) if spec is not None]
        runs += [(f"{spec['tag']}_generation",
                  lambda s=spec: generation_phase(mods, dev, rng, s))
                 for spec in shape_generation_specs()]
    for tag, run in runs:
        out = run()
        records[tag] = out["record"]
        for k, v in out["launches"].items():
            launches[k] += v
    return cases, launches, records


def shape_records(kernels, launches):
    """The JSON entries of phase 40: for each kernel and mode, its
    forward and backward over the new shapes (the first case the main
    one), launches from the phase's model runs; SDPA and cuDNN the
    yardsticks."""
    where = {
        "rect_attention": ("rect_attention.cu", "pallas_rect_attention.py:85",
                           "pallas_rect_attention.py:117"),
        "rect_attention_bf16": ("attention_bf16.cu",
                                "pallas_rect_attention.py:85",
                                "pallas_rect_attention.py:117"),
        "gru": ("gru.cu", "pallas_gru.py:57", "pallas_gru.py:101"),
        "lstm_recurrence": ("lstm_recurrence.cu", "pallas_lstm.py:66",
                            "pallas_lstm.py:131"),
        "lstm_stacked_layers": ("lstm_recurrence.cu",
                                "pallas_lstm_stacked.py:495",
                                "pallas_lstm_stacked.py:595"),
    }
    out = []
    for key, cases in kernels.items():
        base = key.replace("_bf16", "") if key != "rect_attention_bf16" \
            else key
        src, fwd_at, bwd_at = where[base]
        mode = "_bf16" if key.endswith("_bf16") else ""
        stem = key[:-len("_bf16")] if mode else key
        main = cases[0]
        for way, at in (("fwd", fwd_at), ("bwd", bwd_at)):
            counter = f"{stem}{mode}_{way}"
            err = (max(c["fwd_max_abs_err"] for c in cases) if way == "fwd"
                   else max(c["grad_max_abs_err"] for c in cases))
            ms = main["fwd_res_ms" if way == "fwd" else "bwd_ms"]
            out.append(kernel_record(
                f"{counter}_shapes", src, at, launches[counter], err, ms,
                main[f"plain_{way}_ms"], main[f"{way}_bound"],
                main[f"library_{way}_ms"],
                cases=cases if way == "fwd" else None))
    return out



# ---- 41. the encoder stack at every H to 512, K7 at 384 and 512 ----------

def stack_shape_case(K1, r, b, t, h, bf16, layers=5):
    """Phase 41, one width of the encoder stack, f32 or bf16 weights,
    through ``entry_point_case``: without a gradient K1, with one K3 then
    K4, each +1 (a width the kernels are not built for runs padded,
    ``stack_hidden``), K1's outputs the training forward's bits; the plain
    version at the real width, bf16 within ``BF16_FULL_TOL`` and the
    distance test over the first ``BF16_MODE_STEPS`` steps (within
    ``BF16_WIDE_MODE_FRAC`` past H 256); the bounds at
    the real H and at the H the kernels run (products: 18 L B T H^2
    forward; the backward's FP32 chain 8 L B T H^2 and 3xTF32 products 28
    L B T H^2, in the bf16 mode 36 L B T H^2 at 989 TFLOP/s); the layout
    (CTAs a cluster, the rows or gate columns of W_hh a chain CTA keeps in
    shared memory)."""
    n = layers
    wt = torch.bfloat16 if bf16 else torch.float32
    args = (r(b, t, h), r(n, h, 4 * h, s=0.06).to(wt), r(n, 4 * h, s=0.06),
            r(n, h, 4 * h, s=0.06).to(wt), r(n, h, h, s=0.06).to(wt),
            r(n, h, s=0.1), r(n, h, s=0.1, mean=1.0), r(n, h, s=0.1),
            r(n, h, s=0.1, mean=1.0), r(n, h, s=0.1), r(n, b, h, s=0.3),
            r(n, b, h, s=0.3))
    cots = (r(b, t, h), r(n, b, h), r(n, b, h))
    keys = (("mixer_stack_bf16", "mixer_stack_bf16_train_fwd",
             "mixer_stack_bf16_bwd") if bf16 else
            ("mixer_stack", "mixer_stack_train_fwd", "mixer_stack_bwd"))
    tag = "mixer_stack_widths" + ("_bf16" if bf16 else "")
    hp = K1.stack_hidden(h)
    shape = dict(B=b, T=t, L=n, H=h, H_run=hp)
    errs, times, fwd_bytes, bwd_bytes, bits = entry_point_case(
        tag, shape, "K1/K3/K4", K1, flat(K1.mixer_stack_recurrence),
        flat(K1.mixer_stack_forward_reference),
        K1.mixer_stack_backward_reference, args, cots,
        {k: 1 for k in keys}, bf16, BF16_MODE_STEPS, tol=BF16_FULL_TOL,
        mode_frac=BF16_WIDE_MODE_FRAC if h > 256 else BF16_MODE_FRAC)
    if not bits:
        raise AssertionError(f"{tag} {shape}: K1's outputs differ from the "
                             "training forward's")
    grow = hp / h

    def at(f, bytes_, backward):
        f *= grow * grow
        if bf16:
            return bound_bf16((36 if backward else 18) * f, bytes_)
        if backward:
            return bound(8 * f, bytes_, tf32x3_flops=28 * f)
        return bound(18 * f, bytes_)

    f = n * b * t * h * h
    bounds = dict(fwd_bound=at(f / grow ** 2, fwd_bytes, False),
                  bwd_bound=at(f / grow ** 2, bwd_bytes, True),
                  fwd_run_bound=at(f, fwd_bytes * grow, False),
                  bwd_run_bound=at(f, bwd_bytes * grow, True))
    lay = dict(cluster_ctas=K1.launch_ctas(hp),
               kept_rows_fwd=K1.kept(hp, False, bf16),
               kept_columns_bwd=K1.kept(hp, True, bf16),
               resident_clusters=K1.resident_clusters(hp),
               chunk=K1.chunk_steps(b, t, hp, n),
               bwd_chunk=K1.backward_chunk_steps(b, t, hp, n),
               k1_bits_equal_k3=bits)
    return shape_case_record(tag, bf16, errs, times, bounds, **shape, **lay)


def wide_lstm_layer_case(K7, r, dev, b, t, h, bf16):
    """Phase 41, K7 at H 384 or 512 (din = H, the flagship's block LSTMs
    at that width), f32 or bf16, through ``entry_point_case`` (launches +2
    / +1; bf16: the distance test over the first
    ``BF16_RECURRENCE_MODE_STEPS`` steps, as K8's; cuDNN's ``nn.LSTM`` in
    the same dtype); the bounds (products 2 B T 4H (din + H) forward;
    backward the FP32 chain 2 B T 4H H and the 3xTF32 dW_ih, dW_hh and dx
    2 B T 4H (2 din + H), in the bf16 mode all at 989 TFLOP/s); the rows a
    cluster and what a CTA keeps of W_hh."""
    wt = torch.bfloat16 if bf16 else torch.float32
    din = h
    args = (r(b, t, din).to(wt), r(din, 4 * h, s=0.06).to(wt),
            r(4 * h, s=0.06), r(h, 4 * h, s=0.06).to(wt), r(b, h, s=0.3),
            r(b, h, s=0.3))
    cots = (r(b, t, h), r(b, h), r(b, h))
    keys = (("lstm_layer_bf16_fwd", "lstm_layer_bf16_bwd") if bf16 else
            ("lstm_layer_fwd", "lstm_layer_bwd"))
    tag = "lstm_layer_wide" + ("_bf16" if bf16 else "")
    shape = dict(B=b, T=t, din=din, H=h)
    errs, times, fwd_bytes, bwd_bytes, _ = entry_point_case(
        tag, shape, "K7", K7, flat(K7.lstm_layer),
        flat(K7.lstm_layer_reference), K7.lstm_layer_backward_reference,
        args, cots, {keys[0]: 2, keys[1]: 1}, bf16,
        BF16_RECURRENCE_MODE_STEPS, library=cudnn_lstm_ms)
    fwd_f, chain_f = 8 * b * t * h * (din + h), 8 * b * t * h * h
    prod_f = 8 * b * t * h * (2 * din + h)
    if bf16:
        bounds = dict(fwd_bound=bound_bf16(fwd_f, fwd_bytes),
                      bwd_bound=bound_bf16(chain_f + prod_f, bwd_bytes))
    else:
        bounds = dict(fwd_bound=bound(fwd_f, fwd_bytes),
                      bwd_bound=bound(chain_f, bwd_bytes,
                                      tf32x3_flops=prod_f))
    rows = tuple(K7.rows_for(dev, h, bw, b, bf16) for bw in (False, True))
    lay = dict(rows=rows, cluster_ctas=K7.launch_ctas(h),
               kept=tuple(K7.kept(h, bw, r_, bf16)
                          for bw, r_ in zip((False, True), rows)))
    return shape_case_record(tag, bf16, errs, times, bounds, **shape, **lay)


def stack_kernel_phase(mods, dev, rng):
    """41a. The encoder stack's kernels at ``STACK_SHAPE_HIDDEN`` (100 runs
    padded to 128; 192 on 8-CTA clusters; 384 and 512 on 16-CTA ones, FP32
    at 512 reading part of W_hh from L2) at the motion encoder's B32 x
    L5 x T252, and K7 at 384 and 512 at the flagship's B32 x T252, f32
    and bf16. Returns {kernel: [cases]}."""
    r = seeded(rng, dev)
    out = {}
    t = LEAD + TRAIN_FRAMES
    for bf16 in (False, True):
        sfx = "_bf16" if bf16 else ""
        out["mixer_stack" + sfx] = [
            stack_shape_case(mods["K1"], r, TRAIN_B, t, h, bf16)
            for h in STACK_SHAPE_HIDDEN]
        out["lstm_layer" + sfx] = [
            wide_lstm_layer_case(mods["K7"], r, dev, TRAIN_B, t, h, bf16)
            for h in (384, 512)]
    return out


def stack_model_specs():
    """41b. The flagship (``configs/lstmformer.yaml``) at hidden 192 and
    512 through the step functions: ``SHAPE_STEPS`` f32 steps (K3 +2 /
    K4 +2 a step, the two encoders; the five block LSTMs on K8 at 192,
    K7 at 512, +5 / +5; K5 / K6 +10 / +10), eval, the card against CPU
    tensors at B2 x T48 within phase 8's bounds; one bf16 step each
    (the stack's and K8's or K7's bf16 modes +2 / +2 and +5 / +5, K5 / K6
    +2 / +2 in bf16 and +8 / +8 in f32), timed with its launches (its
    card-against-CPU check is phase 31's, at hidden 256)."""
    from multimodalreactiongeneration_tpu_torch import configs

    specs = []
    for h in (192, 512):
        cfg = dict(configs.LSTMFORMER_MODEL_CFG, hidden_size=h)
        k8 = h % 128 != 0  # JAX routes unaligned sizes to K8
        block = "lstm_recurrence" if k8 else "lstm_layer"
        step = dict(metaformer_train_spec(), cfg=cfg,
                    tag=f"flagship_h{h}_train_step",
                    eval_tag=f"flagship_h{h}_eval_step", profile=None,
                    stack_ab=False, steps=SHAPE_STEPS)
        step["per_step"] = dict(step["per_step_off" if k8 else "per_step"])
        step["per_eval"] = dict(mixer_stack=2, rect_attention_fwd=10,
                                **{f"{block}_fwd": 5})
        half = dict(metaformer_bf16_train_spec(), cfg=cfg,
                    tag=f"flagship_h{h}_bf16_train_step",
                    eval_tag=f"flagship_h{h}_bf16_eval_step", profile=None,
                    stack_ab=False, steps=1, per_eval=step["per_eval"],
                    card_vs_cpu=False)
        half["per_step"] = dict(half["per_step_off" if k8 else "per_step"])
        specs.append((f"flagship_h{h}", step, half))
    return specs


def stack_bf16_forward(mods, dev, rng, h):
    """41d. The flagship at hidden ``h`` without gradient on bf16
    parameters and inputs (JAX's ``model.apply`` on ``_cast_tree(params,
    bf16)``) at B16 x 250, the path of K1's bf16 mode: launches exact (K1
    bf16 +2, the audio and partner-motion encoders; the five block LSTMs'
    bf16 mode +5, K8 at unaligned h, K7 at 128 multiples; K5 bf16 +2 and
    f32 +8), finite f32 output, ms; at B2 x 48 against CPU tensors within
    phase 33's bounds (``bf16_forward_check``)."""
    from multimodalreactiongeneration_tpu_torch import configs

    bf = torch.bfloat16
    cfg = dict(configs.LSTMFORMER_MODEL_CFG, hidden_size=h)
    tag = f"flagship_h{h}_bf16_forward"
    block = "lstm_recurrence_bf16_fwd" if h % 128 else "lstm_layer_bf16_fwd"
    model = flagship(cfg, dev).to(bf)
    ins16 = [x.to(dev).to(bf) for x in make_batch(rng, B)[:6]]
    with torch.no_grad():
        torch.cuda.synchronize()
        before = counts(mods)
        y = model(*ins16)[0]
        torch.cuda.synchronize()
        launches = check_launches(
            tag, before, counts(mods), mixer_stack_bf16=2, **{block: 5},
            rect_attention_bf16_fwd=2, rect_attention_fwd=8)
        if not bool(torch.isfinite(y).all()) or y.dtype != torch.float32:
            raise AssertionError(f"{tag}: {y.dtype}, finite "
                                 f"{bool(torch.isfinite(y).all())}")
        ms, _ = cuda_ms(lambda: model(*ins16), 3)
        small = make_batch(rng, BF16_FWD_BATCH, frames=BF16_FWD_FRAMES)[:6]
        cpu16 = flagship(cfg, "cpu").to(bf)
        forward = bf16_forward_check(
            tag, model(*[x.to(dev).to(bf) for x in small])[0],
            cpu16(*[x.to(bf) for x in small])[0],
            flagship(cfg, "cpu")(*small)[0])
    log(tag, B=B, frames=FRAMES, ms=f"{ms:.3f}",
        launches={k: v for k, v in launches.items() if v})
    return {"launches": launches,
            "record": dict(batch=B, frames=FRAMES, ms=ms, **forward)}


def stack_generation_spec():
    """41c. One generation of the flagship at hidden 192 (B16 x 250, bf16
    caches, ``fused_rollout="auto"``: K2's contract is hidden 256, so the
    module loop): K1 +2 (the hoisted audio and partner-motion encoders),
    then the teacher-forced f32 generation at B2 against CPU tensors."""
    from multimodalreactiongeneration_tpu_torch import configs
    from multimodalreactiongeneration_tpu_torch.infer.generate import (
        generate_metaformer,
    )
    from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
        Metaformer,
    )

    cfg = dict(configs.LSTMFORMER_MODEL_CFG, hidden_size=192)
    return dict(
        tag="flagship_h192", generate=generate_metaformer, batches=1,
        per_generation=dict(mixer_stack=2),
        f32=dict(cache_dtype=torch.float32),
        model=lambda device: Metaformer(
            cfg, generator=torch.Generator().manual_seed(SEED),
            device=device))


def stack_shape_phases(mods, dev, kernels=True, models=True):
    """41. The encoder stack at every hidden size to 512 and K7 at 384
    and 512 (generators ``SEED + 41``, one for the kernels and one for the
    models): with ``kernels`` 41a, with ``models`` 41b to 41d. Returns
    the kernel cases ({} without ``kernels``), the model runs' launches
    and their records."""
    cases = (stack_kernel_phase(mods, dev, np.random.default_rng(SEED + 41))
             if kernels else {})
    rng = np.random.default_rng(SEED + 41)
    launches = {k: 0 for k in COUNTERS}
    records = {}
    runs = []
    if models:
        runs = [(spec["tag"], lambda s=spec: train_path_phase(mods, dev, rng,
                                                              s))
                for _, step, half in stack_model_specs()
                for spec in (step, half)]
        spec = stack_generation_spec()
        runs.append((f"{spec['tag']}_generation",
                     lambda s=spec: generation_phase(mods, dev, rng, s)))
        runs += [(f"flagship_h{h}_bf16_forward",
                  lambda h=h: stack_bf16_forward(mods, dev, rng, h))
                 for h in (192, 512)]
    for tag, run in runs:
        out = run()
        records[tag] = out["record"]
        for k, v in out["launches"].items():
            launches[k] += v
    return cases, launches, records


def stack_shape_records(kernels, launches):
    """The JSON entries of phase 41: K1 (no gradient), K3, K4 and K7's
    forward and backward in each mode over the new widths (the first
    case the main one: H 100 for the stack, 384 for K7), launches from
    the phase's model runs; cuDNN the yardstick of K7, none of the
    stack."""
    out = []
    for key, cases in kernels.items():
        mode = "_bf16" if key.endswith("_bf16") else ""
        stem = key[:-len(mode)] if mode else key
        main = cases[0]
        if stem == "mixer_stack":
            names = (f"mixer_stack{mode}", f"mixer_stack{mode}_train_fwd",
                     f"mixer_stack{mode}_bwd")
            ways = (("fwd_ms", "fwd", "pallas_mixer_stack.py:215", names[0]),
                    ("fwd_res_ms", "fwd", "pallas_mixer_stack.py:110",
                     names[1]),
                    ("bwd_ms", "bwd", "pallas_mixer_stack.py:297", names[2]))
            src, lib = "mixer_stack.cu", False
        else:
            ways = (("fwd_res_ms", "fwd", "pallas_lstm.py:390",
                     f"lstm_layer{mode}_fwd"),
                    ("bwd_ms", "bwd", "pallas_lstm.py:448",
                     f"lstm_layer{mode}_bwd"))
            src, lib = "lstm_layer.cu", True
        for ms_key, way, at, counter in ways:
            err = (max(c["fwd_max_abs_err"] for c in cases) if way == "fwd"
                   else max(c["grad_max_abs_err"] for c in cases))
            out.append(kernel_record(
                f"{counter}_wide_shapes", src, at, launches[counter], err,
                main[ms_key], main[f"plain_{way}_ms"], main[f"{way}_bound"],
                main[f"library_{way}_ms"] if lib else None,
                cases=cases if ms_key == ways[0][0] else None))
    return out


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device; nothing was run")
    from multimodalreactiongeneration_tpu_torch import _build
    from multimodalreactiongeneration_tpu_torch.configs import (
        LSTMFORMER_MODEL_CFG,
    )
    from multimodalreactiongeneration_tpu_torch.infer import generate as G
    from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
        Metaformer,
    )
    from multimodalreactiongeneration_tpu_torch.ops import (
        decode_rollout as K2,
        lstm_layer as K7,
        lstm_recurrence as K8,
        gru as K10,
        lstm_stacked as K9,
        mixer_stack as K1,
        rect_attention as K5,
    )

    mods = {"K1": K1, "K2": K2, "K5": K5, "K7": K7, "K8": K8, "K9": K9,
            "K10": K10}
    t_start = time.perf_counter()

    # ---- 0. device ---------------------------------------------------
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", card=repr(card), torch_name=repr(kind),
        torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 1. build ----------------------------------------------------
    t0 = time.perf_counter()
    for name, seconds in _build.build_all(LIBS).items():
        log("build", kernel=name, seconds=f"{seconds:.1f}")
        for line in (_build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("   ", line.strip())
    log("build", total_seconds=f"{time.perf_counter() - t0:.1f}")

    cfg = LSTMFORMER_MODEL_CFG
    gen = torch.Generator().manual_seed(SEED)
    model = Metaformer(cfg, generator=gen, device=dev)
    rng = np.random.default_rng(SEED)

    # ---- 2. mixer stack vs plain -------------------------------------
    stack = model.metaformer.block_0.emb_1
    blocks = [getattr(stack, f"block_{i}") for i in range(stack.num_layerd)]

    def st(fn):
        return torch.stack([fn(b) for b in blocks]).detach().float().contiguous()

    weights = (
        st(lambda b: b.mixer.weight_ih_l0.T),
        st(lambda b: b.mixer.bias_ih_l0 + b.mixer.bias_hh_l0),
        st(lambda b: b.mixer.weight_hh_l0.T),
        st(lambda b: b.feed_forward.feedforward.weight.T),
        st(lambda b: b.feed_forward.feedforward.bias),
        st(lambda b: b.mixer_norm.weight),
        st(lambda b: b.mixer_norm.bias),
        st(lambda b: b.feed_forward.LayerNorm_0.weight),
        st(lambda b: b.feed_forward.LayerNorm_0.bias),
    )
    k1_cases = []
    nl, hid = len(blocks), cfg["hidden_size"]

    for t in ((LEAD + FRAMES) * RATIO, LEAD + FRAMES):
        x0 = torch.from_numpy(
            rng.standard_normal((B, t, hid)).astype(np.float32)).to(dev)
        h0 = torch.from_numpy(
            0.3 * rng.standard_normal((nl, B, hid)).astype(np.float32)).to(dev)
        c0 = torch.from_numpy(
            0.3 * rng.standard_normal((nl, B, hid)).astype(np.float32)).to(dev)
        args = (x0, *weights, h0, c0)
        chosen = K1.chunk_steps(B, t, hid, nl)

        def k1(chunk):
            return K1.mixer_stack_forward(*args, chunk=chunk)

        with torch.no_grad():
            sweep = chunk_sweep(k1, t, SWEEP_LONG if t > 1000 else SWEEP_SHORT)
            log("mixer_stack_sweep", T=t,
                ms={c: round(v, 3) for c, v in sweep.items()})
            means, turns = in_turns(k1, chosen, t)
            ms, whole_ms = means[chosen], means[t]
            y, (hn, cn) = k1(chosen)
            yw, (hnw, cnw) = k1(t)
            bitwise = same_bits((y, hn, cn), (yw, hnw, cnw))
            plain_ms, (yr, (hr, cr)) = plain_time(
                lambda: K1.mixer_stack_forward_reference(*args))
        err = max_err((y, hn, cn), (yr, hr, cr))
        rows, resident = K1.ROWS, K1.resident_clusters(hid)
        log("mixer_stack", T=t, chunk=chosen, rows=rows,
            clusters=nl * -(-B // rows), resident_clusters=resident,
            bitwise_equal_to_whole=bitwise,
            max_abs_err=f"{err:.3e}", ms=f"{ms:.3f}",
            whole_sequence_ms=f"{whole_ms:.3f}", plain_ms=f"{plain_ms:.3f}")
        if not err <= K1_TOL:
            raise AssertionError(f"mixer_stack T={t}: {err} > {K1_TOL}")
        if not bitwise:
            raise AssertionError(
                f"mixer_stack T={t}: chunk {chosen} differs from chunk = T")
        # matmul FLOPs per block: x.W_ih and h.W_hh (8 B T H^2 each), the
        # Dense (2 B T H^2)
        k1_bound = bound(18 * nl * B * t * hid * hid,
                         nbytes(args, y, hn, cn))
        k1_cases.append(dict(T=t, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound=k1_bound, chunk=chosen, rows=rows,
                             resident_clusters=resident,
                             whole_sequence_ms=whole_ms, ms_turns=turns,
                             chunk_sweep_ms=sweep,
                             bitwise_equal_to_whole=bitwise))
        del args, y, hn, cn, yw, hnw, cnw, yr, hr, cr

    # ---- 3. decode rollout vs plain ----------------------------------
    batch = [x.to(dev) for x in make_batch(rng, B)]
    teacher = G.sampling_mask_for(FRAMES, "teacher", device=dev)
    rollout = {}
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            states, ea, em, ms_, la, lm = G._hoist_and_warmup(model, batch, dt)
            rollout[dt] = G._fused_rollout_args(
                model, states, ea, em, ms_, teacher, dt, la, lm)
        a32, kw = rollout[torch.float32]
        plain_ms, ref = plain_time(
            lambda: K2.decode_rollout_reference(*a32, **kw))
        k2_cases = []
        # the plain version's matrix products count the work (the same
        # products in both cache dtypes)
        flops = matmul_flops(lambda: K2.decode_rollout_reference(*a32, **kw))
        for dt, tol in ((torch.float32, K2_F32_TOL),
                        (torch.bfloat16, K2_BF16_TOL)):
            a, kw_dt = rollout[dt]
            ms, out = cuda_ms(lambda: K2.decode_rollout(*a, **kw_dt), 3)
            case = {}
            if dt == torch.bfloat16:
                plain_bf16_ms, ref_bf16 = plain_time(
                    lambda: K2.decode_rollout_reference(*a, **kw_dt))
                # same numerics on both sides: reported, not gated
                case["max_abs_err_vs_plain_bf16"] = max_err((out,), (ref_bf16,))
            err = max_err((out,), (ref,))
            name = str(dt).replace("torch.", "")
            log("decode_rollout", dtype=name, max_abs_err=f"{err:.3e}",
                ms=f"{ms:.3f}", plain_f32_ms=f"{plain_ms:.3f}",
                **{k: f"{v:.3e}" for k, v in case.items()})
            if not err <= tol:
                raise AssertionError(f"decode_rollout {name}: {err} > {tol}")
            case["bound"] = bound(flops, nbytes(a, out))
            k2_cases.append(dict(dtype=name, max_abs_err=err, ms=ms, **case))
        k2_cases[0]["plain_ms"] = plain_ms
        k2_cases[1]["plain_ms"] = plain_bf16_ms
        log("decode_rollout", plain_bf16_ms=f"{plain_bf16_ms:.3f}")

    # ---- 4. main path ------------------------------------------------
    full = G.sampling_mask_for(FRAMES, "full", device=dev)
    batches = [[x.to(dev) for x in make_batch(rng, B)] for _ in range(3)]
    G.generate_metaformer(model, batches[0], full)  # warm-up, not counted
    torch.cuda.synchronize()
    zero_counts(mods)
    times = []
    for i, bd in enumerate(batches):
        before = counts(mods)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        pred = G.generate_metaformer(model, bd, full)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
        if tuple(pred.shape) != (B, FRAMES, MOTION_DIM):
            raise AssertionError(f"generation {i}: shape {tuple(pred.shape)}")
        if not bool(torch.isfinite(pred).all()):
            raise AssertionError(f"generation {i}: non-finite output")
        d = check_launches(f"generation {i}", before, counts(mods),
                           mixer_stack=2, decode_rollout=1)
        log("generate", batch=i, shape=tuple(pred.shape), finite=True,
            ms=f"{times[-1]:.3f}", mixer_stack_launches=f"+{d['mixer_stack']}",
            decode_rollout_launches=f"+{d['decode_rollout']}")
    launches = counts(mods)
    gen_ms = float(np.mean(times))
    log("generate", ms_per_generation=f"{gen_ms:.3f}",
        frames_per_s=f"{B * FRAMES / (gen_ms / 1000):.1f}",
        card=repr(card), launches=launches)
    gen_ab, gen_ab_each, _ = schedule_ab(
        K1, lambda: G.generate_metaformer(model, batches[0], full), 3)
    log("generate", schedule="chunked_vs_whole_in_turns",
        chunked_ms=f"{gen_ab['chunked']:.3f}",
        whole_ms=f"{gen_ab['whole']:.3f}")

    small = make_batch(rng, 2)
    teacher_cpu = G.sampling_mask_for(FRAMES, "teacher")
    on_card = G.generate_metaformer(
        model, [x.to(dev) for x in small], teacher_cpu.to(dev),
        cache_dtype=torch.float32)
    model_cpu = Metaformer(cfg, generator=torch.Generator().manual_seed(SEED),
                           device="cpu")
    on_cpu = G.generate_metaformer(model_cpu, small, teacher_cpu,
                                   cache_dtype=torch.float32)
    err = float((on_card.cpu() - on_cpu).abs().max())
    log("generate", teacher_f32_batch2_vs_cpu_max_abs_err=f"{err:.3e}")
    if not err <= PATH_TOL:
        raise AssertionError(f"card vs CPU generation: {err} > {PATH_TOL}")

    # ---- 5.-9. training kernels, the training step, the training CLI --
    train = train_kernel_phase(K1, dev, rng)
    lstm = lstm_layer_phase(K7, dev, rng)
    attention = rect_attention_phase(K5, dev, rng)
    step = train_path_phase(mods, dev, rng, metaformer_train_spec())
    run = _build.BUILD_DIR / "cli_run"
    shutil.rmtree(run, ignore_errors=True)
    run.mkdir(parents=True)
    t0 = time.perf_counter()
    audio_s = write_corpus(str(run / "corpus"))
    log("cli", corpus_seconds_of_audio=audio_s, sessions=CORPUS_SESSIONS,
        write_s=f"{time.perf_counter() - t0:.1f}")
    cli_run = cli_phase(mods, run, "configs/lstmformer.yaml", "cli",
                        ["batch_size=32"], metaformer_cli_launches)
    eval_cli = eval_cli_phase(mods, run, "configs/lstmformer.yaml",
                              "eval_cli", "cli", metaformer_eval_launches)
    dropout_cli = cli_phase(mods, run, "configs/lstmformer.yaml",
                            "dropout_cli", ["batch_size=32",
                                            f"model.dropout={DROPOUT}"],
                            metaformer_dropout_cli_launches)
    bf16_cli = cli_phase(mods, run, "configs/lstmformer.yaml", "bf16_cli",
                         ["batch_size=32", "trainer.precision=bf16"],
                         metaformer_bf16_cli_launches)
    bf16_cli["record"]["checkpoint_dtypes"] = checkpoint_dtypes(run,
                                                                "bf16_cli")

    # ---- 10.-13. lstm_with_sampling: K9, generation, step, CLI ---------
    stacked = lstm_stacked_phase(K9, dev, rng)
    lws_gen = generation_phase(mods, dev, rng, lws_generation_spec())
    lws_step = train_path_phase(mods, dev, rng, lws_train_spec())
    lws_cli = cli_phase(mods, run, "configs/lstm_with_sampling.yaml",
                        "lws_cli", ["exp.batch_size=32"], lws_cli_launches)
    lws_eval_cli = eval_cli_phase(
        mods, run, "configs/lstm_with_sampling.yaml", "lws_eval_cli",
        "lws_cli", lws_eval_launches)
    lws_ss_cli = cli_phase(mods, run, "configs/lstm_with_sampling.yaml",
                           "lws_ss_cli", ["exp.batch_size=32",
                                          "model.use_scheduled_sampling=true"],
                           lws_ss_cli_launches)
    rates = [r.get("scheduled_sampling_rate")
             for r in lws_ss_cli["record"]["epochs"]]
    if rates != [0.0, 0.5]:  # epoch / model.max_epochs (1, then 2)
        raise AssertionError(f"lws ss cli scheduled_sampling_rate {rates}")
    lws_bf16_cli = cli_phase(mods, run, "configs/lstm_with_sampling.yaml",
                             "lws_bf16_cli", ["exp.batch_size=32",
                                              "trainer.precision=bf16"],
                             lws_bf16_cli_launches)
    lws_bf16_cli["record"]["checkpoint_dtypes"] = checkpoint_dtypes(
        run, "lws_bf16_cli")

    # ---- 14.-17. the GRU Metaformer: K10, generation, step, CLI ---------
    gru = gru_phase(K10, dev, rng)
    gru_gen = generation_phase(mods, dev, rng, gru_generation_spec())
    gru_step = train_path_phase(mods, dev, rng, gru_train_spec())
    # phase 17b resumes the GRU CLI in bf16: this run stops after an epoch
    gru_cli = cli_phase(mods, run, "configs/lstmformer_gru.yaml", "gru_cli",
                        ["batch_size=32"], gru_cli_launches, resume=False)
    gru_bf16_cli = cli_phase(mods, run, "configs/lstmformer_gru.yaml",
                             "gru_bf16_cli", ["batch_size=32",
                                              "trainer.precision=bf16"],
                             gru_bf16_cli_launches)
    gru_bf16_cli["record"]["checkpoint_dtypes"] = checkpoint_dtypes(
        run, "gru_bf16_cli")

    # ---- 18.-21. K8, simple_lstm: generation, step, CLI ----------------
    recurrence = lstm_recurrence_phase(K8, dev, rng)
    bidirectional = bidirectional_phase(mods, dev, rng)
    simple_gen = simple_generation_phase(mods, dev, rng)
    simple_step = train_path_phase(mods, dev, rng, simple_train_spec())
    simple_off = fused_dw_off_phase(mods, dev, simple_train_spec())
    flagship_off = fused_dw_off_phase(mods, dev, metaformer_train_spec())
    bf16_off = {"flagship": fused_dw_off_bf16_phase(
                    mods, dev, metaformer_bf16_train_spec()),
                "lws": fused_dw_off_bf16_phase(mods, dev,
                                               lws_bf16_off_spec())}
    t0 = time.perf_counter()
    v1_frames = write_corpus_v1(str(run / "corpus_v1"))
    log("simple_cli", corpus_frames=v1_frames, sessions=V1_SESSIONS,
        seconds=V1_SECONDS, write_s=f"{time.perf_counter() - t0:.1f}")
    simple_cli = {
        name: cli_phase(mods, run, f"configs/{name}.yaml", f"{name}_cli", [],
                        simple_cli_launches, corpus="corpus_v1", monitors="V")
        for name in ("simple_lstm", "simple_lstm_best")}
    shutil.rmtree(run)  # the corpora, manifests and checkpoints

    # ---- 22.-24. live serving: decode layouts, streaming, serving ------
    layouts = decode_layouts_phase(mods, dev, cfg)
    streaming = streaming_phase(mods, dev, cfg)
    serving = serving_phase(mods, dev, cfg)

    # ---- 25.-28. the training options ------------------------------------
    options = train_options_phases(mods, dev)
    k8_runs = {"generation": simple_gen["launches_fused_dw_0"],
               "simple_train_step": simple_off["launches"],
               "flagship_train_step": flagship_off["launches"]}
    k8_launches = {k: sum(v[k] for v in k8_runs.values())
                   for k in ("lstm_recurrence_fwd", "lstm_recurrence_bwd")}

    # ---- 29.-32. bf16 training: the bf16 modes, the lws, flagship and GRU
    # steps
    rng29 = np.random.default_rng(SEED + 29)
    bf16_k7, bf16_k9, bf16_stack, bf16_attention = bf16_kernel_phase(
        mods, dev, rng29)
    bf16_k10, bf16_k8 = bf16_recurrence_phase(mods, dev, rng29)
    bf16_step = bf16_step_phase(
        mods, dev, np.random.default_rng(SEED + 30), lws_bf16_train_spec(),
        lws_train_spec(), "lws_bf16_vs_f32_step")
    flagship_bf16_step = bf16_step_phase(
        mods, dev, np.random.default_rng(SEED + 31),
        metaformer_bf16_train_spec(), metaformer_train_spec(),
        "bf16_vs_f32_step")
    gru_bf16_step = bf16_step_phase(
        mods, dev, np.random.default_rng(SEED + 32), gru_bf16_train_spec(),
        gru_train_spec(), "gru_bf16_vs_f32_step")
    k8_bf16_launches = {k: sum(v["launches"][k] for v in bf16_off.values())
                        for k in COUNTERS}
    lws_bf16_launches = lws_bf16_cli["launches"]

    # ---- 33.-35., 39. K1's bf16 mode, the rollout route, data parallel
    # and the (data, model) mesh ---------------------------------------
    bf16_inference = bf16_inference_phase(
        mods, dev, np.random.default_rng(SEED + 33), cfg)
    route = rollout_route_phase(mods, dev, np.random.default_rng(SEED + 34),
                                cfg)
    t0 = time.perf_counter()
    data_parallel, mesh = mesh_phases(mods, dev, cfg, serving)
    mesh["seconds"] = time.perf_counter() - t0
    log("mesh", seconds=f"{mesh['seconds']:.1f}")
    k1_bf16 = bf16_inference["cases"][0]

    # ---- 36.-37. K9's layer route, the other mixer kinds ---------------
    layers_f32, layers_bf16 = stacked_layers_phase(
        mods, dev, np.random.default_rng(SEED + 36))
    kinds = mixer_kinds_phase(mods, dev, np.random.default_rng(SEED + 37))

    # ---- 38. the offline corpus pipeline (no kernel) --------------------
    corpus_pipeline = corpus_pipeline_phase(dev, card)

    # ---- 40. every head count and hidden size up to 256 ------------------
    t0 = time.perf_counter()
    shape_kernels, shape_launches, shape_runs = shape_phases(mods, dev)
    log("shapes", seconds=f"{time.perf_counter() - t0:.1f}")

    # ---- 41. the encoder stack at every H to 512, K7 at 384 and 512 -----
    t0 = time.perf_counter()
    stack_kernels, stack_launches, stack_runs = stack_shape_phases(mods, dev)
    log("stack_shapes", seconds=f"{time.perf_counter() - t0:.1f}")

    k1_main, k2_main = k1_cases[0], k2_cases[1]
    # no single PyTorch call computes the encoder stack or the rollout
    record = {"kernels": [
        kernel_record(
            "mixer_stack", "mixer_stack.cu", "pallas_mixer_stack.py:215",
            launches["mixer_stack"], max(c["max_abs_err"] for c in k1_cases),
            k1_main["ms"], k1_main["plain_ms"], k1_main["bound"], None,
            whole_sequence_ms=k1_main["whole_sequence_ms"],
            chunk=k1_main["chunk"], cases=k1_cases,
            launches_eval_cli=eval_cli["launches"]["mixer_stack"],
            launches_decode_layouts=layouts["launches"],
            launches_streaming=streaming["launches"]["mixer_stack"],
            launches_serving={k: v["launches"]["mixer_stack"]
                              for k, v in serving["slots"].items()}),
        kernel_record(
            "decode_rollout", "decode_rollout.cu",
            "pallas_decode_rollout.py:103", launches["decode_rollout"],
            max(c["max_abs_err"] for c in k2_cases), k2_main["ms"],
            k2_main["plain_ms"], k2_main["bound"], None, cases=k2_cases,
            launches_eval_cli=eval_cli["launches"]["decode_rollout"]),
        *training_records(train, lstm, step["launches"]),
        *attention_records(attention, cli_run["launches"]),
        *stacked_records(stacked, lws_cli["launches"],
                         generation=lws_gen["launches"],
                         train_step=lws_step["launches"],
                         eval_cli=lws_eval_cli["launches"]),
        *gru_records(gru, gru_cli["launches"],
                     generation=gru_gen["launches"],
                     train_step=gru_step["launches"]),
        *recurrence_records(recurrence, k8_launches, **k8_runs),
        *bf16_records({"lstm_layer_bf16": (bf16_k7, lws_bf16_launches),
                       "lstm_stacked_bf16": (bf16_k9, lws_bf16_launches)},
                      train_step=bf16_step["launches"],
                      flagship_bf16_cli=bf16_cli["launches"],
                      flagship_bf16_train_step=flagship_bf16_step["launches"]),
        *flagship_bf16_records(bf16_stack, bf16_attention,
                               bf16_cli["launches"],
                               train_step=flagship_bf16_step["launches"]),
        *bf16_records(
            {"gru_bf16": (bf16_k10, gru_bf16_cli["launches"]),
             "lstm_recurrence_bf16": (bf16_k8, k8_bf16_launches)},
            gru_bf16_train_step=gru_bf16_step["launches"],
            **{f"{k}_bf16_fused_dw_0_step": v["launches"]
               for k, v in bf16_off.items()}),
        kernel_record(
            "mixer_stack_bf16", "mixer_stack.cu", "pallas_mixer_stack.py:215",
            bf16_inference["launches"]["mixer_stack_bf16"],
            max(c["fwd_max_abs_err"] for c in bf16_inference["cases"]),
            k1_bf16["ms"], k1_bf16["plain_ms"], k1_bf16["bound"], None,
            f32_kernel_ms=k1_bf16["f32_kernel_ms"], dtype="bf16",
            cases=bf16_inference["cases"]),
        *stacked_layers_records(
            layers_f32, layers_bf16, kinds["inner2"]["launches"],
            kinds["inner2_bf16"]["launches"],
            generation=kinds["inner2"]["generation_launches"]),
        *shape_records(shape_kernels, shape_launches),
        *stack_shape_records(stack_kernels, stack_launches),
    ], "generation": {"batch": B, "frames": FRAMES, "ms": gen_ms,
                      "frames_per_s": B * FRAMES / (gen_ms / 1000),
                      "stack_schedule_ab": {"ms": gen_ab,
                                            "ms_each": gen_ab_each}},
        "train_step": step["record"],
        "cli": {"corpus_seconds_of_audio": audio_s, **cli_run["record"]},
        "eval_cli": eval_cli["record"], "lws_eval_cli": lws_eval_cli["record"],
        "lws_generation": lws_gen["record"],
        "lws_train_step": lws_step["record"], "lws_cli": lws_cli["record"],
        "gru_generation": gru_gen["record"],
        "gru_train_step": gru_step["record"], "gru_cli": gru_cli["record"],
        "bidirectional_k7": bidirectional,
        "simple_generation": simple_gen["record"],
        "simple_train_step": simple_step["record"],
        "simple_fused_dw_0_step": simple_off["record"],
        "flagship_fused_dw_0_step": flagship_off["record"],
        "simple_cli": {"corpus_frames": v1_frames,
                       **{k: v["record"] for k, v in simple_cli.items()}},
        "decode_layouts": layouts, "streaming": streaming,
        "serving": serving,
        "train_options": {k: v["record"] for k, v in options.items()},
        "dropout_cli": dropout_cli["record"],
        "lws_ss_cli": lws_ss_cli["record"],
        "lws_bf16_cli": lws_bf16_cli["record"],
        "bf16_cli": bf16_cli["record"],
        "bf16_train_step": dict(
            flagship_bf16_step["record"], f32_ms=step["record"]["ms"],
            f32_peak_mem_gib=step["record"]["peak_mem_gib"]),
        "lws_bf16_train_step": dict(
            bf16_step["record"], f32_ms=lws_step["record"]["ms"],
            f32_peak_mem_gib=lws_step["record"]["peak_mem_gib"]),
        "gru_bf16_train_step": dict(
            gru_bf16_step["record"], f32_ms=gru_step["record"]["ms"],
            f32_peak_mem_gib=gru_step["record"]["peak_mem_gib"]),
        "gru_bf16_cli": gru_bf16_cli["record"],
        **{f"{k}_bf16_fused_dw_0_step": v["record"]
           for k, v in bf16_off.items()},
        "bf16_inference": bf16_inference["record"],
        "rollout_route": route, "data_parallel": data_parallel,
        "mesh": mesh,
        "mixer_kinds": {k: dict(v["record"], launches=v["launches"],
                                **{n: v[n] for n in ("generation_ms",
                                                     "generation_launches")
                                   if n in v})
                        for k, v in kinds.items()},
        "corpus_pipeline": corpus_pipeline, "shapes": shape_runs,
        "stack_shapes": stack_runs,
        "seconds": time.perf_counter() - t_start}
    options = dict(options, dropout_cli=dropout_cli, lws_ss_cli=lws_ss_cli)
    for entry in record["kernels"]:  # the training options' launches
        extra = {k: v["launches"][entry["name"]] for k, v in options.items()
                 if v["launches"].get(entry["name"])}
        if extra:
            entry["launches_train_options"] = extra
    log("done", seconds=f"{record['seconds']:.1f}")
    print(json.dumps(record))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
