#!/usr/bin/env python3
"""End-to-end smoke run of paddle_tpu_torch (the PyTorch / CUDA port) on one
NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from paddle_tpu_torch/csrc with nvcc for
   sm_90a, one nvcc per source, all started at once; report the
   tensor-core flash kernels' (K1-K3) registers, spills (none allowed at
   head dim 64, nor in any of the six head-dim-256 instantiations, float32
   ones included) and dynamic shared memory, and the same of the recurrent
   kernels (K5-K6; none allowed at 4 units a column group, the stacked
   LSTM's and the NMT encoder's) with the plan each shape gets;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes its path gives it (decode attention: the serving tick, odd
   shapes, and the cases that exercise its split of the cache — T = 1, T
   one past a chunk boundary, dh not a multiple of 4, rows whose mask
   leaves only the first position or nothing, a peaked softmax — and the
   NMT decoder's q [32, 1, 512] over [32, 64, 512] forward and gradient;
   flash attention forward, dQ and dK/dV: the LM's training shape, a
   packed batch with segment ids, Tq != Tk, T not a multiple of the tile,
   head dims 32, 128 and 256, head dims 16, 40, 96 and 160 (which the
   wrappers zero-pad to 32, 64, 128 and 256), rows with no visible key,
   and on the wide-head route head dims 300, 384, 512, 1000, 1100 and
   1152 (300, 1000 and 1100 padded to 384, 1024 and 1152; above 1024 two
   clusters a tile) with the same masks, each in bfloat16
   and float32 (bfloat16 runs on the tensor cores and is held to the
   per-term bounds of ops/flash_attention.py, taken on the padded tensors,
   and wrong kernels must be rejected by the same check: three for each
   output; float32 at 1e-5);
   the whole-sequence LSTM and GRU: the stacked LSTM's and the NMT
   encoder's shapes forward and reversed with ragged lengths including 0,
   H = 16 and 100, the GRU at B = 80 (three passes of 32 rows), and the
   large hidden sizes H = 1100 and 2048 (both kernels, both directions),
   where a block owns more than 4 units and reads its w through L2), then
   time kernel, plain version and the PyTorch library call that
   computes the same function: each one's calls captured in a CUDA graph
   (no host launch cost in the time) over rotating input sets larger than
   the 50 MB L2, replayed in turns between CUDA events (SDPA's backward,
   the flash backward's yardstick: its captured forward and backward less
   its forward; K1-K3 also at head dims 256 and 512, with the kernels
   SDPA's backend runs at 512; the controls rejected at 64 and 512);
4. serve: ContinuousBatchingEngine on CUDAPlace(0) at the Transformer LM's
   full width (vocab 32000, d_model 512, d_inner 2048, 8 heads, 6 layers),
   16 slots, max_len 256, random weights from the startup program's seed,
   48 requests with prompts of 8-96 tokens and 32 new tokens each. Launch
   counts are zeroed just before and read just after: every kernel of the
   path must have run (decode attention: 6 launches, one per layer, each
   tick);
5. reference check on a small input: the same engine at a small width on
   the card and on the CPU (where the plain versions run) from the same
   weights in float32 must generate identical tokens;
6. where a tick's time goes: torch.profiler over steady-state ticks of
   the phase-4 engine — wall and device-busy time per tick, the device's
   idle share, the top device kernels (a profile that records the
   device's activity alone, as every profile read only for its kernels
   does), and host time per op type over 8 ticks (each op lowering
   wrapped in a record_function named by its op type, for this phase
   only). Diagnostics; it changes no result above;
7. train: the repo's LM training configuration (tools/bench_breadth.py
   build_transformer: vocab 32000, max_len 512, d_model 512, d_inner
   2048, 8 heads, 6 layers, batch 16, Adam lr 1e-4) built with
   transformer_lm + optimizer.Adam(...).minimize(loss), initialized by the
   startup program from its seed on CUDAPlace(0), 30 steps through
   Executor.run over 4 batches of the repo's Markov tokens: tokens/s,
   step time, the loss of the first and last steps (finite, falling) and
   peak device memory. Each flash kernel must launch 6 times (one per
   layer) each step, on its bfloat16 tensor-core route (`flash_fwd_tc`,
   `flash_bwd_dq_tc`, `flash_bwd_dkv_tc`);
8. the same model packed: 64 ragged sequences (lognormal lengths 32-512)
   packed by pack_lm_batch into rows of 512 with segment ids, 10 steps,
   the same launch counts, a finite loss;
9. training reference check: a small LM in float32 on the card and on the
   CPU from the same weights, 3 Adam steps on the same batches: losses,
   gradients and updated parameters agree;
10. where a training step's time goes: phase 6's profile over steady-state
   steps of the phase-7 trainer (the host's time per op type over one
   step), with the autograd region's forward and backward shown apart;
11. train the stacked LSTM classifier at its own full width (dict 30000,
   emb 512, hid 512, 3 layers, max_len 100), batch 64 of lengths 16-100,
   Adam 5e-4, 20 steps: examples/s, step time, loss, peak memory; the
   LSTM kernel must launch 3 times (one per layer) each step;
12. train the GRU-attention NMT model at full width (dict 10000, embed
   256, hidden 512, batch 32, 64 source and target tokens), Adam, 10
   steps: target tokens/s and the rest; the GRU kernel must launch once a
   step and decode attention 64 times (one per target position);
13. recurrent training reference check: both models small, float32, on
   the card and on the CPU from the same weights, 3 Adam steps: losses,
   gradients (the decoder's attention path included) and parameters
   agree;
14. where a recurrent training step's time goes: one profiled step of
   each, device busy, idle share and the top device kernels;
15. train the encoder-decoder Transformer-base (paddle_tpu/models/
   transformer.py:157's defaults: vocab 30000 each side, max_len 64,
   d_model 512, d_inner 2048, 8 heads, 6 + 6 layers, dropout and label
   smoothing 0.1) through Trainer with Adam (β2 0.98, ε 1e-9) and
   noam_decay(512, 4000): 64 pairs of the shift-copy task (lengths
   16-64), 20 steps over 4 batches from a data.batch reader and the
   DataFeeder, a checkpoint at step 10: target tokens/s, step time, loss
   (finite, falling), peak memory, the dropout op's launches and keep
   fraction; Trainer.test over a held batch; a new Trainer on the step-10
   checkpoint resumes at step 10 with every persistable bit-equal;
16. its is_test program (dropout 0.1 as scaling) saved with
   io.save_inference_model and served through Inferencer: K1 launches
   18 times a batch, all on flash_fwd_tc; finite logits, equal in two
   runs;
17. the encoder-decoder small (2 layers, d_model 64) in float32 with the
   global-norm clip, L2 decay and noam, dropout 0 (K1-K3 in float32 on
   the training path): 3 Adam steps card against CPU (each from the same
   state), the step counter equal; then its dropout-0.1 is_test logits;
18. where a Transformer-base step's time goes: phase 10's profile of the
   phase-15 trainer;
19. train ResNet-50 as the JAX package's bench.py builds it (224x224x3
   NHWC images declared uint8-staged, bfloat16 convs on cuDNN's
   channels_last kernels, Momentum 3e-3 / 0.9, batch 256, cuDNN
   autotuning on): 8 distinct batches by bench.py's recipe, quantized to
   uint8 and fed through the DevicePrefetcher (pinned buffers, a side
   stream), 21 steps: images/s over the median step, step median and p95
   (step 1, with the autotuning, apart), losses (finite; the mean over the
   last 8 steps below the first 8's), peak device memory, the bytes of a
   staged batch against float32's; the fed tensor must reach the card as
   uint8, and a forward on the uint8 batch must give the loss of one on
   uint8 * float32(1/255) made on the host, and that of one on its
   float32 source within 1%; then phase 10's profile of the step. It
   launches none of K1-K6;
20. the trained ResNet-50 saved with io.save_inference_model, loaded and
   served through Inferencer at batch 16 (median of 10); its top-1 equals
   the trained program's is_test clone's on the same batch;
21. ResNet-8 (resnet_cifar10, depth 8) in float32, 3 Momentum steps card
   against CPU from the same weights (losses, gradients, parameters and
   the BN running statistics), and one step of SE-ResNeXt-50 at 64x64
   (grouped convs; loss, running statistics, and each gradient's cosine
   and norm, its float32 gradients being chaotic at initialization);
22. train DeepFM as tools/bench_breadth.py:254-275 builds it (batch 4096,
   39 fields, a 1M-row table with is_sparse and row_pad 128, Adam 3e-4;
   8 distinct batches by its recipe), 20 steps: step median and p95,
   examples/s, peak memory, the loss (finite; the last 8 steps' mean
   below the first 8's); no table-sized tensor made inside the autograd
   region (the table takes no dense gradient), none at all in a
   merged-rows step; 3 steps of the dense-masked path and 1 of the
   merged-rows path under torch.cuda.set_sync_debug_mode("error"); then
   3 steps of each path from one state: the beta powers equal, every
   other element within 1e-7 + 1e-5 |x| but for at most 1e-4 of a
   tensor's elements (within 2 * lr a step: Adam's sign rule), and the
   untouched rows bit-equal to the start on both;
23. phase 7's LM under transpiler.memory_optimize at levels 0 and 1 (the
   region as about sqrt(n) checkpointed segments), 5 steps each from the
   un-rematerialized run's start: K1 launches 12 times a step (6 in the
   forward, 6 recomputed in the backward), K2 and K3 6; the peak below
   the un-rematerialized run's; the step-1 loss at rtol 1e-5 and each
   step-1 gradient within 4e-3 of its norm (a bfloat16 rounding); the
   losses at rtol 2e-3 and each parameter's 5-step update within 5% of
   its norm; then dropout 0.1, level 1 against the un-rematerialized
   run, 3 steps, held the same way (the recompute must draw the
   forward's masks);
24. the rest of training, small, card against CPU: seven optimizer
   classes (Adagrad, Adamax, DecayedAdagrad, Adadelta, RMSProp centered
   with momentum, Ftrl at lr_power -0.5 and -0.3, Lamb) 3 steps each
   from the same state, the proximal_gd and proximal_adagrad ops,
   ModelAverage's apply and restore, DeepFM sparse on both Adam paths
   (tests/test_models.py:112's size), ResNet-8 under memory_optimize
   against its un-rematerialized run on the card (running statistics
   updated once a step), and a piecewise_decay learning rate with no
   host sync after the planning step;
25. paged serving: PagedKVEngine (blocks of 8) from phase 4's weights
   serves phase 4's 48 prompts (their tokens must be phase 4's, token for
   token: the gathered view feeds decode attention the same bytes; 6
   launches a tick), then 16 requests sharing a 64-token prefix (one to
   fill the prefix cache, then 15 that must hit it), the pool checked
   whole; paged_beam_search (beam 4, 8 new tokens) on 4 prompts, best
   first; a profiled step;
26. weight-quantized serving from phase 4's weights: phase 4's float32
   engine again (this phase's baseline), quant="int8" and "int4", and
   PagedKVEngine(kv_quant=True), each over phase 4's prompts: freed
   bytes, tokens/s, the tick, the share of tokens equal to phase 4's
   (reported: the JAX package's int4 bound holds at its test size, not
   at this width); the float32 and int8 steps profiled;
27. speculative serving (SpecConfig(gamma=4, draft="int8")) on the slot
   and the paged engine (its pool checked every round): tokens equal to
   phase 4's but where the target's top-2 logits are closer than 1e-2
   (printed with the margin), the acceptance rate, rounds, tokens/s, and
   decode_attention_multi launching 6 times a verify forward; the slot
   engine's round profiled;
28. the paged (and beam), int8, int4, int8-KV and speculative (slot and
   paged) engines at phase 5's small size in float32, card against CPU:
   identical tokens;
29. serve through EngineServer(metrics_port=0) over phase 4's slot engine
   (its weights): 4 EngineClient connections on loopback, each pipelining
   12 of phase 4's prompts, every request answered with phase 4's tokens;
   tokens/s through the server beside an in-process engine, in turns;
   decode attention 6 launches a server tick; one /metrics scrape
   (ptpu_engine_*, ptpu_memory_*, ptpu_ckpt_* families) and one /healthz
   (`serving`); drain() returns True;
30. two-tier paging: PagedKVEngine with 65 blocks of 8 (about four
   128-token requests) on phase 4's prompts, device-only and then with
   the pinned host tier (HostTierConfig(host_blocks=256,
   prefetch_distance=2, rotate_quantum=8): spills on a CUDA side stream,
   reloads issued ahead and ordered by events): both give phase 25's
   tokens; the byte census is exact and check_two_tier() passes; mean
   resident requests under backlog (no lower than the device-only
   engine's), tokens/s and time to first token beside the device-only
   engine, admitted requests as a scheduler counter; the deleted
   engine's device memory given back (with a small control whose stream
   keeps its staged reloads); prefetch hits and misses, the d2h
   and h2d rates beside the PCIe link, the tick against phase 25's, a
   profiled step's idle share;
   then two-tier engines with float32 and int8 pools at phase 5's small
   size under pressure, card against CPU: identical tokens and spills;
31. phase 30's two-tier engine on 16 prompts with the KV sanitizer on:
   zero divergences, ops mirrored, phase 4's tokens; then phase 4's slot
   engine for 20 ticks with tracing on: aggregate() of the tick, dispatch
   and admission spans and the spans' host cost a tick;
32. translate with phase 12's trained NMT model (its parameters through
   io.save_params / load_params into a fresh machine_translation.
   infer_net(beam_size=4, max_len=64)): 3 batches of 32 of phase 12's
   ragged sources after a warm-up, each under
   torch.cuda.set_sync_debug_mode("error"): seconds per batch, beam
   positions/s (B x max_len) and emitted tokens/s (the best beams up to
   their eos), K6 once and K4 64 times a batch (the beams as G = 4 query
   rows), a profiled batch's busy and idle share and top kernels; scores
   finite and sorted best-first, every id in the vocabulary;
33. train the BiLSTM-CRF of tests/test_book.py:178-243 at the book's
   widths (embedding 32, 128 LSTM units a direction, 59 labels) on the
   port's conll05 generator, batch 64, Adam 5e-3, 40 steps (steps 2-40
   under sync-debug "error"): step time, examples/s, the loss falling,
   K5 twice a step, a profiled step; then Viterbi decoding and
   chunk_eval on a held-out batch (under sync-debug "error"): accuracy
   and chunk F1;
34. phases 32 and 33's graphs at test width card against CPU (the
   decode's sequences and scores; 3 Adam steps of the BiLSTM-CRF, then
   its Viterbi paths and chunk counts), tests/test_control_flow.py's
   programs (While, DynamicRNN, IfElse, lazy_cond, Switch, tensor
   arrays) card against CPU, and this slice's ops on tie, NaN,
   out-of-range and empty inputs card against CPU;
35. train the SSD detector at its defaults (paddle_tpu/models/ssd.py: 21
   classes, 3x128x128 images, 8 ground-truth rows, 5376 priors, 870,476
   parameters), batch 32, Adam 3e-3, 20 steps over 4 seeded batches
   (1-8 boxes an image painted on noise, the other rows zero-area
   padding; steps 2-20 under sync-debug "error"): images/s, step median
   and p95, the loss falling, no kernel of csrc/ launched, a profiled
   step; then ssd_decode (decode + NMS, keep_top_k 100) on a held-out
   batch of 32 under sync-debug "error": ms a batch, detections an image,
   metrics.DetectionMAP against the batch's boxes;
36. train CRNN-CTC at its defaults (models/ocr_crnn.py: 36 classes and the
   blank, 1x32x128 images, 16 labels, hidden 96, 331,429 parameters),
   batch 64, Adam 1e-3, 40 steps over 8 batches of images drawn from their
   labels (steps 2-40 under sync-debug "error"): examples/s, step median
   and p95, the loss falling, K6 twice a step (the forward and the
   reversed GRU at B 64, T 32, H 96), a profiled step; then the greedy
   CTC decode of a held-out batch under sync-debug "error": character and
   sequence accuracy through metrics.EditDistance;
37. SSD and CRNN at test width (tests/test_models.py:225-290) in float32,
   3 Adam steps card against CPU each from the same state (losses at
   1e-5, gradients by cosine and norm: a max-pool window within rounding
   of a tie routes its gradient by device), their decodes (SSD's labels
   and counts equal, boxes and scores at 1e-5; CRNN's greedy paths equal,
   probabilities at 1e-5), and this slice's ops on their edges (NMS ties
   and all scores under the threshold, infeasible CTC rows, mod by
   negative divisors, stable-sort and argmin ties, out-of-range scatter
   indices) card against CPU;
38. generate with phase 7's trained LM (its parameters through
   io.save_params / load_params into transformer_lm_generate at its
   widths) at tools/bench_generate.py's shapes: max_gen 64, greedy at
   batch 16 and 64, beam 4 at batch 16, Markov-chain prompts; each a
   warm-up call and 3 calls under sync-debug "error": generated tokens/s,
   ms a step, K4 6 launches a step (every layer's cached self-attention
   fused, counted in the plan), ids in the vocabulary, scores finite and
   best first, the share of transitions the Markov rule allows (a
   diagnostic); the beam call profiled (busy, idle share, top kernels);
39. generate with phase 15's trained Transformer-base through
   transformer_generate (bench_generate.py's measure_nmt: batch 16,
   source 64, max_gen 32, beam 4; then beam 1): the same numbers, K1 6
   launches a call in the is_test encoder, K4 6 a step at beam 4 and 12
   at beam 1, where the cross-attention's bfloat16 keys and values are
   fused too (none of its chains at beam 4), the share of shift-copy
   tokens;
40. this slice's paths at test width, card against CPU in float32: both
   generators greedy and at beam 3 (tokens equal, scores within 1e-4),
   Executor.run_steps against 3 calls of run on a small LM (K1-K3 in
   float32), a py_reader with double_buffer staging batches on the card,
   fusion.fused_lstm_sequence / fused_gru_sequence on K5 / K6 against the
   plain versions, and ROADMAP.md §3's fault cases (an int32 X into
   softmax, log_softmax, gelu, softplus, logsigmoid and layer_norm;
   floordiv and mod by zero in int32 and float32, and of INT_MIN by -1)
   against the JAX package's values;
41. the analyzers, the memory planner, the cost model, the measured
   census, the profiler and the flight recorder on phase 7's LM at full
   width: check_program and infer_program over the LM and the programs
   phases 12, 15, 19 and 22 train (no error diagnostic; host times);
   memory_plan_pass under the pass sanitizer at the default budget (no
   remat fits) and at a wide one (remat), and the LM trained from the
   same weights in turns as kept (every intermediate kept to the step's
   end, the control), released (at last use, every plan's default),
   planned and remat (max_memory_allocated a step beside plan_report's
   predicted peaks and search_remat's decision, losses equal at step 1
   to 1e-5, after at 2e-3); Executor.cost_analysis / memory_analysis /
   memory_census on the card, a step with no transients read as temp 0, the census in a
   LedgerRow's check_memory_identity at the 0.1 residual, MFU and
   roofline_fields of the median step; profiler.profiler("All") over a
   warm-up step and 3 more, each of which must launch every flash kernel 6
   times in the profiler's device trace (kernels tied to the step by
   their launches' correlation ids), beside the executor's span ranges in
   the exported trace (the device's idle share);
   and a Trainer stopped by an injected EnforceError, whose dossier the
   installed flight recorder writes and `analyze` reads back.
42. data- and tensor-parallel training over NCCL: a world over every
   visible card (one rank a card, paddle_tpu_torch.distributed.launch;
   one rank on a one-card machine) trains phase 7's LM at full width in
   float32 (TF32 off), 3 Adam steps from the same weights and batches,
   through ParallelExecutor in four modes — AllReduce, Reduce (ZeRO-1),
   ReduceScatter on the int8 wire with error feedback, and annotate_tp +
   tp_shard_pass over a tp axis of the world's size (ReduceScatter, the
   JAX package's tp mode) — each held against the plain Executor on the
   same card (the 3 steps' losses to 1e-5 relative, 1e-3 on the int8
   wire; each parameter, after a fourth step that torch.profiler reads
   NCCL's calls and kernels from, within Adam's largest move, 2 lr a
   step), with K1-K3's launches counted (6 a step), and a step's time
   beside the plain Executor's; on more than one card also the ring over an sp axis of
   the whole world against one K1 call. Then the ring schedule in one
   process (parallel/ring_attention.py's block functions, the held K/V
   block indexed rather than sent) at 4 blocks, causal, bfloat16: the
   LM's attention shape (B 16, H 8, T 512, D 64), the same packed with
   segment ids (rows that see no key in some blocks), and B 1, T 16384;
   o, lse, dq, dk and dv held against one K1-K3 call over the whole
   sequence within 3 slacks of ops/flash_attention.py's bounds, no NaN,
   K1 launched 10 times for an unpacked causal forward, and both timed.
43. pipeline-parallel training of phase 7's LM: the one-process engine at
   K 2 (GPipe, 1F1B) and K 4 held against the plain Executor, a world
   over the cards through ParallelExecutor (pp 2 refused on one card),
   and the auto-parallel planner's plans and adoption.
44. elastic training of phase 7's LM at full width in float32 (TF32 and
   use_bf16_matmul off): (a) in a world of one rank on NCCL, through
   ParallelExecutor in Reduce (ZeRO-1) and ReduceScatter on the int8 wire
   with error feedback, 4 uninterrupted steps; 2 steps, a snapshot with
   block=False (the copy into pinned memory on a side stream, the
   compute stream ordered after it), 2 more; a fresh scope and executor
   restoring it and running steps 3-4; the same with block=True — every
   run's losses, state and per-step K1-K3 launches bitwise the
   uninterrupted run's, with the snapshot's bytes, the async save's cost
   on the step path against the blocking save's wall, d2h and write
   GB/s and restore seconds; (c) on one card, the plain Executor's
   snapshot restored into ParallelExecutor(auto_parallel=True), which
   runs replan_on_restore (its record logged), the next 2 steps held
   against the plain run's; (b) this script as a supervised child
   (`--phase44-child`, Trainer with CheckpointConfig(elastic=True,
   async_save=True, step_interval=2), 6 steps), killed once by
   crash_at_step:4 and once by crash_mid_save inside the step-4
   snapshot's staged payload: each run restarts once and ends with the
   uninterrupted child's state bitwise, resumed at step 2.
45. ParallelExecutor on phase 7's LM at full width in float32 (TF32 and
   use_bf16_matmul off), Adam from one init, in a world over every
   visible card on NCCL (one rank on a one-card machine), each run held
   against the plain Executor on the same card: (a) Reduce (ZeRO-1) with
   offload_optimizer_state off and on, 4 steps each: losses and the
   whole state bitwise, the offloaded bytes equal to the program's
   reckoning, the scope holding no accumulator between steps, the
   memory allocated between steps lower by at least 90% of those bytes,
   the peak inside a step, d2h / h2d GB/s on the side stream, the step
   times, last_restore_wait_s and costs.predict's offload section;
   (b) Reduce with memory_plan=True on the rewritten program: losses
   within 1e-5 relative, peak, step and the plan's record, then one
   auto-parallel prepare (its chosen point, memory plans in its space);
   (c) AllReduce with enable_sequence_parallel on {"sp": world} (sp 1
   on one card: the split, the override and a one-block ring), and
   dp 2 x sp 2 on four cards: losses within 1e-5 relative, the first
   step's gradients within 1e-2 of their norm and the parameters settled
   (`_adam_parity`), K1-K3 6·(i+1) a step on sp rank i (the causal ring's
   live blocks).
46. export and the native programs: the programs ptpu_predict and
   ptpu_train (paddle_tpu_torch/csrc/native/, built with g++ against
   this torch beside phase 2's nvcc builds, the ptpu:: ops' CUDA
   implementations linked to the kernel libraries) run torch.export
   archives without Python. (a) phase 38's LM generator (phase 7's
   weights, batch 16, beam 4) and (b) phase 39's Transformer-base
   generator (phase 15's weights, batch 16, beam 4), max_gen cut to
   EXPORT["max_gen"] (the graph unrolls every step of every layer),
   (c) phase 11's stacked LSTM (startup weights, its batch) and phase
   32's beam translation (phase 12's weights, max_len cut the same way):
   each exported by io.export_inference_model on the card (the five
   exports, the train step's included, in child processes at once,
   started after phase 20 and run beside phases 21-45 at a lower
   priority: an export is host-bound Python), loaded cold by
   ExportedPredictor and run
   by `ptpu_predict --device cuda`; tokens
   identical across the three and with Executor.run (the LSTM's logits
   within 1e-6), each kernel of the path launched the same number of
   times a call in all three (K4; K1 and K4; K5; K6 and K4); each timed
   in turns (the C++ process by its own timer around the run). (d)
   `ptpu_predict --serve` on (a)'s archive at a batch the export never
   traced: 4 PredictorClient threads, one pipelining 8 requests, every
   answer the one-shot run's; a float64 feed and a wrong name answered
   with errors on a connection that serves again. (e) phase 7's LM step
   in float32 through io.export_train_program and `ptpu_train --steps
   5` against 5 Executor.run steps from the same state: losses within
   1e-5 relative, parameters within 1e-5, K1-K3 6 launches a step each
   in the C++ process.
47. the transpilers, RecordIO and the concurrency utilities on the card.
   (a) phase 19's trained ResNet-50 (its parameters and moved running
   statistics saved after phase 19), its is_test program at phase 20's
   batch 16 through `Analyzer()` (the default list, `bn_fold_pass`) on a
   clone with a copy of the scope: the 53 batch_norms gone, the folded
   values CUDA tensors of the dtypes they replace; the folded logits
   against the unfolded within 1e-4 of their largest magnitude on a
   float32 build (TF32 off) and within BN_FOLD_BF16_BOUND relative L2 as
   phase 20 serves it (NHWC, bfloat16 convs); both timed. (b) phase 7's
   LM built with `QuantizeTranspiler().training_transpile` before Adam,
   10 steps from phase 7's init on its batches: the loss falls, K1-K3 6
   launches a step; `quant_freeze_pass` through `Analyzer(passes=...)`
   on the is_test program: every quantized weight on its own abs-max
   grid, the frozen eval loss within 1e-5 relative of the unfrozen one.
   (c) the LM's program through `DistributeTranspiler` over two
   endpoints with RoundRobin and with HashName (every parameter covered
   once), two Adam steps by the trainer's `Executor.run` and by each
   endpoint's pserver program on the card fed the trainer's flattened
   gradient shards: the reassembled parameters, moments and beta powers
   equal the trainer's (bitwise, or within 1e-7). (d) phase 7's four
   batches written by `write_numpy_records` (and as raw records for
   `layers.io.open_files`) into two files each, one compressed; read back
   bitwise through `open_files` and through a 4-thread
   `ParallelRecordLoader` (its records/s and MB/s over the files); a
   `concurrency.go` producer sends the loader's batches over a
   `Channel(capacity=2)` to 8 training steps from phase 7's init: the
   losses equal, bit for bit, those of the same batches fed as arrays,
   K1-K3 6 launches on every step. Phase 47 takes at most 120 s.
48. the port's command-line tools and examples as a user runs them, each
   a `sys.executable` child (`-m paddle_tpu_torch.tools.<name>`; an
   example through runpy, which then reports its process's launches),
   the two drills of (b) at once and the other children in
   P48_SLOTS slots beside them; (a)'s sweeps and gate runs and (f) start
   after phase 20 (BACKGROUND_SLOTS at a time, beside phases 21-45) and
   (b)'s drills as phase 46 starts (beside it; phase 47 waits for them),
   all at a lower priority, and are checked here. (a)
   `lint_program --all --json` plain and at --dp 2, --tp 2,
   --pipeline_stages 2, --memory_plan, --offload and --serving (the
   parallel ones with --allow_gate_rejects): exit 0, 23 rows, no error;
   `--model mnist --tp 2 --json` exits 2, and 0 with
   --allow_gate_rejects; after (b), `--restore_dir` exits 0 on its
   committed snapshots and 1 (`restore-uncommitted`) on the directory its
   phase C's killed save left. (b) `recovery_smoke --dp 1 --phases A`
   and `--phases C`, two drills at once: a gang of one rank on NCCL
   killed at step 5 and relaunched by the Supervisor resumes at step 4
   bitwise; a save killed at byte 0 commits nothing and the restart is
   bitwise. (c) phase 7's LM saved with
   `io.save_program`, 3 iterations at batch 8 through `demo_trainer`
   (float32, TF32 off) within 1e-5 of `Executor.run` on the same
   `synth_feed`; its main() again in this process: K1-K3 6 launches a
   step. (d) `generate_text` (the loss falls from step 0 to step 200;
   K1-K3 and K4 launches), `serve_model` (the in-process, TCP and C++
   legs' first three outputs within 1e-4), `train_mnist` (the reloaded
   predictor answers). (e) a barrier round of a simulated world of 2
   ranks with the flight recorder installed, through `trace_merge`: the
   barrier spans on rank lanes 0 and 1, the memory counters on the
   `memory` lane. (f) `print_signatures --check` exits 0. Every number
   is logged beside nvidia-smi's name and power limit; phase 48 takes at
   most PHASE48_BUDGET_S.

Phase 3 also holds the bfloat16 cells of K5 / K6 (x, w and states in
bfloat16, h and c carried in bfloat16 as the reference's composite
carries them) at the stacked LSTM's, the NMT encoder's and CRNN's shapes
forward and reversed with ragged lengths including 0, at H 1100 (w through
L2) and the GRU past one pass of rows: each step held against the plain
version's step from the state the kernel carried into it, within the
per-term slack of fusion/recurrent.py `recurrent_step_check`, with three
wrong kernels rejected a cell (gate columns rotated, no length freeze,
the freeze at the reversed steps), and timed beside the plain version and
cuDNN's bfloat16 LSTM / GRU. It also holds decode attention at the generators' shape (R = B·K
64, T 64, dh 64, bf16 q) and on a bfloat16 cache (the encoder-decoder's
cross-attention at beam 1), each timed beside SDPA, its verify-window
route (G = 5 query rows) and int8 route (int8 caches, alone and with
G = 5) at the serving shape against the plain version, each row of a G = 5 launch bit-equal
to a G = 1 launch, and times them beside SDPA on the same inputs; and
its beam route (phase 32's shape: R 1, nh 32, G 4, T 64, dh 512,
float32, the [32, 1, 64] mask broadcast over the rows) against the plain
version at 1e-5, timed beside SDPA; K5 at the BiLSTM-CRF's shape (B 64,
T 30, H 128, both directions); K6 at CRNN's shape (B 64, T 32, H 96,
both directions) against the plain version, timed beside cuDNN's GRU.

Float32 matrix products run without TF32 here
(torch.backends.cuda.matmul.allow_tf32 = False, and cudnn's too), so
float32 comparisons are full float32.

The line before last is one JSON object with each kernel's launches on its
path's run (decode attention: phase 4, with `launches_nmt` from phase 12,
`launches_multi` from phase 27 and `launches_int8` from phase 3's checks,
no serving path feeding it an int8 cache, and each route's `*_multi`,
`*_int8`, `*_int8_multi` error, time, bound and SDPA time;
flash kernels: phase 7; LSTM: phase 11; GRU: phase 12), error against its
plain version (`max_abs_err` at the path's shape in float32;
`max_abs_err_bf16_q` / `max_abs_err_bf16` the same shape in the path's
bfloat16; decode attention's `*_nmt` keys at the NMT shape and `splits`,
the chunks of the cache a call is split into, at each path's shape; the
flash kernels' `routes` per type, `err_over_tolerance_bf16`,
`beyond_one_step_bf16`, the controls' `control_err_over_tolerance`,
`launches_tc_bf16`, `d256` and `d512`, their times and bound at head
dims 256 and 512; `launches_per_step_remat`, K1-K3's launches a step in
phase 23; `launches_server`, `launches_two_tier`, `launches_sanitized`
and `launches_traced`, decode attention's on phases 29-31;
`launches_beam` and the `*_beam` keys, decode attention's on phase 32
and at its shape; `launches_infer`, the GRU kernel's on phase 32;
`launches_crf`, the LSTM kernel's on phase 33; `launches_crnn`, the GRU
kernel's on phase 36, and the GRU's `*_crnn` keys, its error, time,
bound and cuDNN time at CRNN's shape; `launches_generate` and
`launches_generate_nmt`, decode attention's on phases 38 and 39, with
its `*_generate` and `*_bf16_cache` keys at the generators' and the
cross-attention's shapes; `launches_generate` of the flash forward, K1's
in phase 39's encoder; `launches_phase41` / `launches_phase41_tc`, K1-K3's
over phase 41's four variants' turns; `launches_phase42_<mode>`, K1-K3's
over each parallel mode's 3 steps on rank 0, and `launches_phase42_ring`,
K1's in the ring's causal forward at the LM shape;
`launches_per_step_phase43_<run>` and `launches_per_step_phase44_<mode>`,
K1-K3's a step of phase 43's pipelined runs and phase 44's uninterrupted
runs; K5 / K6's `*_bf16` and the
GRU's `*_crnn_bf16` keys, their bfloat16 rows, with `err_over_slack_bf16`
and `launches_bf16_checks`, phase 3's bfloat16 launches: no path of the
model zoo runs a bfloat16 recurrent cell), `launches_native`, each
kernel's launches inside phase 46's native processes,
`launches_phase47_qat` / `_recordio` / `_pserver`, K1-K3's over phase
47's QAT steps, RecordIO-fed steps and the pserver check's trainer
steps, `launches_phase48_demo_trainer` / `_generate_text`, K1-K3's over
demo_trainer's steps and K1-K3's and K4's in generate_text's process
(phase 48), times, and `paths`: phases 15-48's numbers; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or without the
repository beside this file, it exits non-zero and prints no result.
"""

import atexit
import contextlib
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

SEED = 1234

# serving configuration: the engine's default model, 16 slots of 256
SERVE = dict(n_slots=16, vocab=32000, max_len=256, d_model=512, d_inner=2048,
             num_heads=8, num_layers=6)
N_REQUESTS, PROMPT_LO, PROMPT_HI, MAX_NEW = 48, 8, 96, 32

# phases 25-28: the paged, weight-quantized and speculative engines on the
# serving configuration and phase 4's weights and prompts. Blocks of 8
# positions (the JAX engine's default, paddle_tpu/serving/kv_pager.py:679);
# 16 more requests sharing a 64-token prefix (one fills the prefix cache,
# then 15); beam 4 over 8 new tokens on 4 prompts; speculative gamma 4
# with an int8 draft (paddle_tpu/serving/speculative.py:96-97, its
# defaults). A speculative token may differ from phase 4's only where the
# target's top-2 logits are closer than SPEC_MARGIN.
PAGED = dict(block_size=8, shared=16, shared_prefix=64, beam=4, beam_new=8,
             beam_prompts=4)
SPEC = dict(gamma=4, draft="int8")
SPEC_MARGIN = 1e-2
# phases 29-31: EngineServer with 4 clients over phase 4's prompts; the
# two-tier pager at 65 blocks of 8 (64 usable, 192 KiB each at this width:
# about four 128-token requests) with 256 pinned host blocks; the
# sanitized run on 16 prompts and 20 traced ticks
SERVER = dict(clients=4)
TWO_TIER = dict(n_blocks=65)
HOST_TIER = dict(host_blocks=256, prefetch_distance=2, rotate_quantum=8)
SANITIZE = dict(prompts=16, trace_ticks=20)
# device memory a deleted two-tier engine may leave allocated: well under
# its 12 MiB of pools, far under one staged reload kept per spill
LEAK_SLACK_BYTES = 8 << 20
LOGITS = "lm_head.tmp_1"       # the decode tick's logits (lm_head's output)

# training configuration: the repo's LM training cell
# (tools/bench_breadth.py:188 build_transformer), batch 16 of 512 tokens
TRAIN = dict(vocab=32000, max_len=512, d_model=512, d_inner=2048,
             num_heads=8, num_layers=6, batch=16, lr=1e-4)
TRAIN_STEPS, TRAIN_BATCHES, PACKED_STEPS, PACKED_SEQS = 30, 4, 10, 64

# published H100 rates by part (NVIDIA data sheets): memory bytes/s,
# float32 (non-tensor-core) flop/s and dense bfloat16 tensor-core flop/s
_RATES = {"PCIe": (2.0e12, 51e12, 756e12), "NVL": (3.9e12, 60e12, 835e12),
          "SXM": (3.35e12, 67e12, 989e12)}

_KERNEL_META = {
    "decode_attention": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/decode_attention.cu",
        "replaces": "paddle_tpu/fusion/decode_attention.py:60",
    },
    "flash_fwd": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:130",
    },
    "flash_bwd_dq": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:351",
    },
    "flash_bwd_dkv": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:395",
    },
    "lstm_seq": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/recurrent.cu",
        "replaces": "paddle_tpu/fusion/recurrent.py:80",
    },
    "gru_seq": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/recurrent.cu",
        "replaces": "paddle_tpu/fusion/recurrent.py:118",
    },
}

# the stacked LSTM classifier at its own defaults (models/stacked_lstm.py:
# dict 30000, emb 512, hid 512, 3 layers, max_len 100), batch 64 of lengths
# 16-100, token-sum-parity labels (tools/bench_breadth.py:156-173), Adam
LSTM = dict(dict_dim=30000, emb_dim=512, hid_dim=512, stacked_num=3,
            max_len=100, batch=64, len_lo=16, lr=5e-4)
LSTM_STEPS, LSTM_BATCHES = 20, 4
# the GRU-attention NMT model at tools/benchmark.py:111-130's configuration:
# dict 10000, embed 256, hidden 512, batch 32, Ts = Tt = 64, ragged sources
NMT = dict(dict_size=10000, embed_dim=256, hidden_dim=512, batch=32,
           src_len=64, tgt_len=64, src_lo=16, lr=1e-3)
NMT_STEPS, NMT_BATCHES = 10, 2
# Transformer-base ("Attention Is All You Need", Table 3 "base"; the
# defaults of paddle_tpu/models/transformer.py:157): vocab 30000 each side,
# max_len 64, d_model 512, d_inner 2048, 8 heads, 6 + 6 layers, dropout and
# label smoothing 0.1 (§5.4), Adam with noam_decay(512, 4000) (§5.3); batch
# 64 pairs of the shift-copy task, lengths 16-64
TRANSFORMER = dict(src_vocab=30000, tgt_vocab=30000, max_len=64,
                   d_model=512, d_inner=2048, num_heads=8, num_layers=6,
                   dropout=0.1, label_smooth=0.1, batch=64, len_lo=16,
                   warmup=4000)
TRANSFORMER_STEPS, TRANSFORMER_BATCHES, TRANSFORMER_CKPT_STEP = 20, 4, 10
BOS = 0
# phase 17's small encoder-decoder; `lr` is the largest rate its noam
# schedule reaches in the 3 steps (0.125 * 3 * 10**-1.5), which the
# card-against-CPU check needs for its tiny-gradient bound
TRANSFORMER_SMALL = dict(src_vocab=97, tgt_vocab=89, max_len=32, d_model=64,
                         d_inner=128, num_heads=4, num_layers=2,
                         dropout=0.0, label_smooth=0.1, batch=4, len_lo=5,
                         warmup=10, lr=0.012)
# ResNet-50 as the JAX package's own benchmark builds it (bench.py:57-76):
# 224x224x3 NHWC images declared with uint8 staging, bfloat16 convs,
# Momentum(3e-3, 0.9), batch 256 (bench.py:503); 8 distinct batches made
# by bench.py's recipe (:83-103); inference at batch 16 (bench.py:189)
RESNET = dict(depth=50, image=224, classes=1000, batch=256, lr=3e-3,
              momentum=0.9, batches=8, infer_batch=16)
RESNET_STEPS = 21            # step 1 (planning, cuDNN autotuning) + 20
# phase 21: resnet_cifar10(depth=8) at 32x32, batch 8, 3 Momentum steps;
# se_resnext_imagenet (grouped convs, the SE gate) at 64x64, batch 4, one
# step (its float32 gradients at initialization are chaotic after one)
RESNET_SMALL = dict(depth=8, image=32, classes=10, batch=8, lr=0.05)
SE_RESNEXT_SMALL = dict(image=64, classes=10, batch=4, lr=1e-3)
# phase 22: DeepFM as tools/bench_breadth.py:254-275 builds it: batch 4096,
# 39 fields, a 1M-row table with is_sparse and row_pad 128 (1M x 128
# float32, 512 MB; 1.5 GB with Adam's moments), Adam 3e-4, 8 distinct
# batches by its recipe
DEEPFM = dict(num_fields=39, vocab=1000000, embed_dim=16,
              fc_sizes=(400, 400, 400), row_pad=128, batch=4096, lr=3e-4,
              batches=8)
DEEPFM_STEPS, DEEPFM_CHECK_STEPS = 20, 3
# the merged-rows path's limit for the comparison: below the 512 MB table
DEEPFM_ROWS_MAX_BYTES = 256 << 20
# phase 23: phase 7's LM under transpiler.memory_optimize
REMAT_STEPS, REMAT_DROPOUT, REMAT_DROPOUT_STEPS = 5, 0.1, 3
# phase 24: tests/test_models.py:112's DeepFM, sparse, card against CPU
DEEPFM_SMALL = dict(num_fields=5, vocab=500, embed_dim=8, fc_sizes=(32,),
                    row_pad=None, batch=16, lr=1e-3, batches=3)
# phase 32: beam-search translation with phase 12's trained NMT model:
# infer_net's defaults (beam 4, bos 0, eos 1) but max_len, set to phase
# 12's target length (64); batches of 32 of phase 12's ragged sources
# (lengths 16-64), the first a warm-up
BEAM = dict(beam_size=4, max_len=64, bos_id=0, eos_id=1, batches=4)
# phase 33: the BiLSTM-CRF of tests/test_book.py:178-243 at the book's
# widths (word embedding 32; dynamic_lstm size 512, so 128 units a
# direction; default activations, so both directions run on K5) over the
# port's conll05 generator (4000 words, 59 labels, lengths 5-30), batch
# 64, Adam 5e-3, labels by the test's learnable rule words % 59
SRL = dict(vocab=4000, labels=59, max_len=30, emb=32, size=512, batch=64,
           lr=5e-3, batches=8)
SRL_STEPS = 40
# phase 34: phases 32 and 33's graphs at test width, card against CPU
NMT_INFER_SMALL = dict(dict_size=24, embed_dim=16, hidden_dim=32, batch=8,
                       src_len=5, tgt_len=5, src_lo=1, beam_size=3,
                       max_len=5)
SRL_SMALL = dict(vocab=30, labels=5, max_len=7, emb=8, size=64, batch=4,
                 lr=5e-3, batches=3)
# phase 35: the SSD detector at its defaults (paddle_tpu/models/ssd.py:
# 21 classes, 3x128x128 images, 8 ground-truth rows; 5376 priors over three
# scales), batch 32, Adam 3e-3, 20 steps over 4 batches made from a seed:
# 1-8 boxes an image painted in their class's colour on noise, the other
# rows zero-area padding; then ssd_decode's defaults (keep_top_k 100, NMS
# 0.45 over nms_top_k 400) on a held-out batch of 32
SSD = dict(num_classes=21, image=128, num_gt=8, batch=32, lr=3e-3,
           batches=4)
SSD_STEPS, SSD_DECODES = 20, 3
# phase 36: CRNN-CTC at its defaults (models/ocr_crnn.py: 36 classes and
# the blank, 1x32x128 images, 16 labels, hidden 96; 32 columns, so K6 at
# B 64, T 32, H 96 in both directions), batch 64, Adam 1e-3, 40 steps over
# 8 batches of images drawn from their labels: each label owns 8 of the
# 128 columns, filled with its class's row pattern plus noise
CRNN = dict(num_classes=36, height=32, width=128, max_label_len=16,
            hidden=96, batch=64, lr=1e-3, batches=8)
CRNN_STEPS = 40
# phase 37: both at test width (tests/test_models.py:225-290), card
# against CPU
SSD_SMALL = dict(num_classes=4, image=64, num_gt=4, batch=2, lr=3e-3,
                 batches=3)
CRNN_SMALL = dict(num_classes=10, height=32, width=64, max_label_len=4,
                  hidden=32, batch=2, lr=3e-3, batches=3)
# generation through the model zoo at tools/bench_generate.py's shapes:
# transformer_lm_generate at TRAIN's widths (phase 7's weights), max_gen 64,
# greedy at batch 16 and 64 and beam 4 at batch 16 (its `measure`); then
# transformer_generate with phase 15's Transformer-base, batch 16, source
# 64, max_gen 32, beam 4 (its `measure_nmt`) and beam 1
GENERATE = dict(max_gen=64, runs=((16, 1), (64, 1), (16, 4)), reps=3)
GENERATE_NMT = dict(batch=16, max_gen=32, beams=(4, 1), reps=3)
# phase 40: both generators at tests/test_torch_generate.py's width
GENERATE_SMALL = dict(vocab=50, src_len=7, max_gen=6, d_model=32,
                      d_inner=64, num_heads=4, num_layers=2, batch=4,
                      beams=(1, 3))
# phase 40: run_steps against k runs on a small LM
RUN_STEPS_SMALL = dict(vocab=97, max_len=16, d_model=32, d_inner=64,
                       num_heads=4, num_layers=2, lr=1e-3, batch=4, steps=3)


_T0 = time.perf_counter()


def log(*a):
    """Print a line of the run's log; with CHIP_SMOKE_STAMPS=1 in the
    environment, each line starts with the seconds since the start."""
    if os.environ.get("CHIP_SMOKE_STAMPS") == "1":
        a = (f"[{time.perf_counter() - _T0:7.1f}]", *a)
    print(*a, flush=True)


#: the niceness of the children that run beside earlier phases (phase
#: 46's exports, phase 48's lint sweeps, signature check and drills): the
#: phase in this process keeps its cores
BACKGROUND_NICE = 10
#: every child started through _track: main() stops, with its process
#: group, each one still running when it exits
_CHILDREN = []


def _lower_priority(pid, nice):
    """Raise the niceness of child `pid` (before it has imported anything,
    so the processes it starts inherit it); if the OS declines, it stays
    as is."""
    try:
        os.setpriority(os.PRIO_PROCESS, pid, nice)
    except OSError:
        pass


def _track(proc):
    """Register `proc` (started with start_new_session=True) for
    _stop_children; returns it."""
    _CHILDREN.append(proc)
    return proc


def _stop_children():
    """Kill the process group of every tracked child still running (a
    drill's gang of ranks included)."""
    for proc in _CHILDREN:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except OSError:
                proc.kill()
            proc.wait()


def card_rates(name):
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, _RATES[key]
    return "SXM", _RATES["SXM"]


def time_in_turns(fns, sets, reps=100, rounds=3):
    """Median device ms per call of each fn. Each fn's `reps` calls,
    cycling through `sets`, are captured once in a CUDA graph, so host
    launch cost is out of the measurement; the graphs then replay in turns
    (a b c, c b a, a b c) between CUDA events."""
    import torch
    graphs = {}
    for name, fn in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):           # warm-up before capture
            for s in sets:
                fn(s)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(reps):
                fn(sets[i % len(sets)])
        graphs[name] = g
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    order = list(fns)
    for rnd in range(rounds):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[name].replay()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / reps)
    return {n: sorted(v)[len(v) // 2] for n, v in times.items()}


def check_decode_attention(ptt, name, rates):
    """Phase 3 for the decode-attention kernel. Returns its JSON fields
    (all but launches)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.fusion.decode_attention import (
        decode_attention_chunk, decode_attention_cuda, decode_attention_plain)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def make(r, nh, t, dh, q_dtype, masks="ends", q_mult=1.0):
        q = (torch.randn(r, nh, dh, device=dev, generator=gen)
             * q_mult).to(q_dtype)
        k = torch.randn(r, nh, t, dh, device=dev, generator=gen)
        v = torch.randn(r, nh, t, dh, device=dev, generator=gen)
        # per-row masks ending at different positions, shared by every
        # head (stride 0), as the tick's [S,1,1,1,T] bias reaches the op
        ends = torch.randint(1, t + 1, (r, 1), device=dev, generator=gen)
        if masks == "first_or_none":
            # row 0 sees only position 0 (every later chunk is all masked),
            # row 1 sees nothing (the plain version's uniform average)
            ends[0], ends[1] = 1, 0
        keep = torch.arange(t, device=dev)[None] < ends
        mask = torch.where(keep, 0.0, -1e9).to(torch.float32)
        return q, k, v, mask[:, None, :].expand(r, nh, t)

    # correctness: the serving shape in both q types, odd shapes (heads
    # not a power of two, dh not a multiple of 32, a long T, dh 256), and
    # the split's edges: T = 1, T one past a chunk boundary, dh not a
    # multiple of 4 (4-byte copies), all-masked chunks and rows, and q
    # scaled by 8 (a peaked softmax whose chunk maxima differ widely: a
    # merge that did not rescale would fail at 1e-5)
    r, nh, t, dh = SERVE["n_slots"], SERVE["num_heads"], SERVE["max_len"], \
        SERVE["d_model"] // SERVE["num_heads"]
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(r, nh, t, dh, bf16, "ends", 1.0),
             (r, nh, t, dh, f32, "ends", 1.0),
             (3, 6, 40, 48, bf16, "ends", 1.0),
             (2, 2, 16384, 64, f32, "ends", 1.0),
             (4, 4, 1000, 256, f32, "ends", 1.0),
             (4, 8, 1, 64, f32, "ends", 1.0),
             (4, 8, 1, 64, bf16, "ends", 1.0),
             (r, nh, 257, dh, f32, "ends", 1.0),
             (2, 3, 77, 30, f32, "ends", 1.0),
             (2, 3, 77, 30, bf16, "ends", 1.0),
             (4, 4, 300, 64, f32, "first_or_none", 1.0),
             (4, 4, 300, 64, bf16, "first_or_none", 1.0),
             (r, nh, t, dh, f32, "ends", 8.0)]
    tol = {f32: (1e-5, 0.0), bf16: (1e-2, 1e-2)}
    errs = {}
    for case in cases:
        cr, cnh, ct, cdh, dt, masks, q_mult = case
        q, k, v, bias = make(cr, cnh, ct, cdh, dt, masks, q_mult)
        scale = cdh ** -0.5
        chunk = decode_attention_chunk(cr, cnh, ct, cdh)
        splits = -(-ct // chunk)
        if ct == 257:
            assert splits >= 2 and (ct - 1) % chunk == 0, (
                f"T={ct} is not one past a chunk boundary (chunk {chunk})")
        out = decode_attention_cuda(q, k, v, bias, scale)
        ref = decode_attention_plain(q, k, v, bias, scale)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        atol, rtol = tol[dt]
        ok = bool((diff <= atol + rtol * ref.float().abs()).all())
        err = float(diff.max())
        log(f"  decode_attention R={cr} nh={cnh} T={ct} dh={cdh} "
            f"q={str(dt)[6:]}{'' if masks == 'ends' else ' masks=' + masks}"
            f"{'' if q_mult == 1 else f' q*{q_mult:g}'} ({splits} chunks of "
            f"{chunk}): max_abs_err={err:.3e} (tolerance atol {atol} + rtol "
            f"{rtol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"decode_attention disagrees with its plain "
                                 f"version at {case}: max abs err {err}")
        errs[case] = err
    splits = -(-t // decode_attention_chunk(r, nh, t, dh))

    # timing at the serving path's shape and types (bf16 q, f32 caches),
    # rotating input sets whose K/V exceed the L2 three times over
    kv_bytes = 2 * r * nh * t * dh * 4
    n_sets = max(4, math.ceil(3 * 50e6 / kv_bytes))
    sets = []
    for _ in range(n_sets):
        q, k, v, bias = make(r, nh, t, dh, torch.bfloat16)
        sets.append({"q": q, "k": k, "v": v, "bias": bias,
                     # SDPA takes one dtype: q in float32, computed once
                     "q4": q.float()[:, :, None, :],
                     "mask4": bias[:, :, None, :]})
    scale = dh ** -0.5
    times = time_in_turns({
        "kernel": lambda s: decode_attention_cuda(s["q"], s["k"], s["v"],
                                                  s["bias"], scale),
        "plain": lambda s: decode_attention_plain(s["q"], s["k"], s["v"],
                                                  s["bias"], scale),
        "library": lambda s: F.scaled_dot_product_attention(
            s["q4"], s["k"], s["v"], attn_mask=s["mask4"], scale=scale),
    }, sets)
    # least time: each input read once (q, K, V, the [R,T] mask the
    # heads share), the output written once; flops 4 per cache element
    # (q.k and p.v) + ~5 per score (scale, bias, max, exp, sum)
    nbytes = (r * nh * dh * 2 + kv_bytes + r * t * 4 + r * nh * dh * 2)
    flops = 4 * r * nh * t * dh + 5 * r * nh * t
    mem_rate, f32_rate, _ = rates
    bound_ms = max(nbytes / mem_rate, flops / f32_rate) * 1e3
    bound_by = "bytes" if nbytes / mem_rate >= flops / f32_rate else \
        "operations"
    log(f"  decode_attention timing R={r} nh={nh} T={t} dh={dh} q=bf16 "
        f"({splits} chunks a row and head), {n_sets} input sets of "
        f"{kv_bytes / 1e6:.1f} MB K/V: kernel "
        f"{times['kernel'] * 1e3:.2f} us, plain {times['plain'] * 1e3:.2f} "
        f"us, SDPA {times['library'] * 1e3:.2f} us, bound "
        f"{bound_ms * 1e3:.2f} us ({bound_by}: {nbytes / 1e6:.2f} MB at "
        f"{mem_rate / 1e12:.2f} TB/s)")
    # the error at the serving shape with float32 q shows the kernel's own
    # arithmetic; with bfloat16 q both outputs round to bfloat16, which
    # hides it, so that one is reported beside it under its own key
    return {"max_abs_err": errs[cases[1]],
            "max_abs_err_bf16_q": errs[cases[0]], "splits": splits,
            "ms": times["kernel"], "plain_ms": times["plain"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": times["library"]}


def check_decode_attention_routes(rates):
    """Phase 3 for decode attention's two new routes at the serving shape
    (R=16, nh=8, T=256, dh=64): a verify window of G = 5 query rows (the
    speculative engines' gamma 4) over the float32 caches, G = 1 over int8
    caches with one scale per 8 positions, and G = 5 over int8 caches.
    Each against its plain version, in float32 q (1e-5) and bfloat16 q
    (the serving type; 1e-2 + 1e-2 |ref|); every row of a G = 5 launch
    must be bit-equal to a G = 1 launch with that row's q and bias. Then
    kernel, plain version and SDPA (on the same inputs, int8 caches
    dequantized first, with the same float mask) timed in turns. Returns
    the JSON fields of the routes (`*_multi`, `*_int8`, `*_int8_multi`)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.fusion.decode_attention import (
        decode_attention_cuda, decode_attention_plain,
        dequantize_kv_time_blocks, quantize_kv_time_blocks)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    r, nh, t, dh = SERVE["n_slots"], SERVE["num_heads"], SERVE["max_len"], \
        SERVE["d_model"] // SERVE["num_heads"]
    scale = dh ** -0.5
    g_spec = SPEC["gamma"] + 1

    def make(g, q_dtype, int8):
        q = torch.randn(r, nh, g, dh, device=dev, generator=gen).to(q_dtype)
        k = torch.randn(r, nh, t, dh, device=dev, generator=gen)
        v = torch.randn(r, nh, t, dh, device=dev, generator=gen)
        # the verify tick's causal window: row j of slot i sees positions
        # <= base_i + j, one mask shared by every head (stride 0)
        base = torch.randint(0, t - g + 1, (r, 1, 1), device=dev,
                             generator=gen)
        keep = torch.arange(t, device=dev)[None, None] <= \
            base + torch.arange(g, device=dev)[None, :, None]
        bias = torch.where(keep, 0.0, -1e9).float()[:, None].expand(
            r, nh, g, t)
        s = {"q": q, "k": k, "v": v, "bias": bias, "ks": None, "vs": None}
        if int8:
            s["k"], s["ks"] = quantize_kv_time_blocks(k, 8)
            s["v"], s["vs"] = quantize_kv_time_blocks(v, 8)
        # SDPA takes one dtype: q in float32 and the caches dequantized
        # as the kernel does (to q's dtype, then float32), made once
        s["q_f"] = q.float()
        s["k_f"] = (dequantize_kv_time_blocks(s["k"], s["ks"], q_dtype)
                    .float() if int8 else k)
        s["v_f"] = (dequantize_kv_time_blocks(s["v"], s["vs"], q_dtype)
                    .float() if int8 else v)
        s["mask"] = bias[:, :1]
        return s

    def kernel(s):
        return decode_attention_cuda(s["q"], s["k"], s["v"], s["bias"],
                                     scale, s["ks"], s["vs"])

    def plain(s):
        return decode_attention_plain(s["q"], s["k"], s["v"], s["bias"],
                                      scale, s["ks"], s["vs"])

    def library(s):
        return F.scaled_dot_product_attention(
            s["q_f"], s["k_f"], s["v_f"], attn_mask=s["mask"], scale=scale)

    out = {}
    mem_rate, f32_rate, _ = rates
    # the int8 route's launches in these checks (no serving path feeds K4
    # an int8 cache: the paged engine's int8 pools are dequantized into
    # the float32 view the fused op reads, as in the JAX package)
    int8_checks = 0
    for key, g, int8 in (("multi", g_spec, False), ("int8", 1, True),
                         ("int8_multi", g_spec, True)):
        errs = {}
        n0 = kernels.LAUNCHES["decode_attention_int8"]
        for dt in (torch.float32, torch.bfloat16):
            s = make(g, dt, int8)
            got, ref = kernel(s), plain(s)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs()
            atol, rtol = (1e-5, 0.0) if dt == torch.float32 else (1e-2, 1e-2)
            ok = bool((diff <= atol + rtol * ref.float().abs()).all())
            errs[dt] = float(diff.max())
            rows_equal = all(
                torch.equal(decode_attention_cuda(
                    s["q"][:, :, j:j + 1].contiguous(), s["k"], s["v"],
                    s["bias"][:, :, j:j + 1], scale, s["ks"], s["vs"]),
                    got[:, :, j:j + 1]) for j in range(g))
            torch.cuda.synchronize()
            log(f"  decode_attention {key} R={r} nh={nh} G={g} T={t} "
                f"dh={dh} q={str(dt)[6:]} K/V="
                f"{'int8 (bt 8)' if int8 else 'float32'}: max_abs_err="
                f"{errs[dt]:.3e} (tolerance atol {atol} + rtol {rtol}) "
                f"{'ok' if ok else 'FAIL'}; rows bit-equal to G = 1 "
                f"launches: {rows_equal}")
            if not ok:
                raise AssertionError(f"decode_attention {key} disagrees "
                                     f"with its plain version ({dt}): max "
                                     f"abs err {errs[dt]}")
            if not rows_equal:
                raise AssertionError(f"decode_attention {key}: a row of the "
                                     f"G={g} launch is not bit-equal to a "
                                     f"G = 1 launch ({dt})")
        int8_checks += kernels.LAUNCHES["decode_attention_int8"] - n0
        # timing on the serving path's types (bf16 q), rotating sets
        # whose caches exceed the L2 three times over
        elem = 1 if int8 else 4
        kv_bytes = 2 * r * nh * t * dh * elem
        sc_bytes = 2 * r * nh * (t // 8) * 4 if int8 else 0
        n_sets = max(4, math.ceil(3 * 50e6 / (kv_bytes + sc_bytes)))
        sets = [make(g, torch.bfloat16, int8) for _ in range(n_sets)]
        times = time_in_turns({"kernel": kernel, "plain": plain,
                               "library": library}, sets)
        # least time: q, K, V (+ scales), the [R, G, T] mask the heads
        # share read once, the output written once; flops 4 a cache
        # element and query row + ~5 a score, and 2 a cache element to
        # dequantize an int8 cache
        nbytes = (2 * r * nh * g * dh * 2 + kv_bytes + sc_bytes
                  + r * g * t * 4)
        flops = g * (4 * r * nh * t * dh + 5 * r * nh * t) + \
            (4 * r * nh * t * dh if int8 else 0)
        bound_ms = max(nbytes / mem_rate, flops / f32_rate) * 1e3
        bound_by = "bytes" if nbytes / mem_rate >= flops / f32_rate else \
            "operations"
        log(f"  decode_attention {key} timing (q bf16, {n_sets} input sets "
            f"of {(kv_bytes + sc_bytes) / 1e6:.2f} MB K/V): kernel "
            f"{times['kernel'] * 1e3:.2f} us, plain "
            f"{times['plain'] * 1e3:.2f} us, SDPA "
            f"{times['library'] * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} "
            f"us ({bound_by}: {nbytes / 1e6:.2f} MB at "
            f"{mem_rate / 1e12:.2f} TB/s)")
        out.update({f"max_abs_err_{key}": errs[torch.float32],
                    f"max_abs_err_bf16_q_{key}": errs[torch.bfloat16],
                    f"rows_bit_equal_{key}": True,
                    f"ms_{key}": times["kernel"],
                    f"plain_ms_{key}": times["plain"],
                    f"bound_ms_{key}": bound_ms, f"bound_by_{key}": bound_by,
                    f"library_ms_{key}": times["library"]})
    assert int8_checks > 0, "the int8 route never launched in phase 3"
    out["launches_int8"] = int8_checks
    return out


def _rnn_err(out, ref):
    """(max abs error, within tolerance): |err| <= 1e-4 * max(1, max|ref|),
    float32 rounding of the recurrent products' differently ordered sums,
    carried through up to 100 steps of the recurrence."""
    diff = float((out - ref).abs().max())
    return diff, diff <= 1e-4 * max(1.0, float(ref.abs().max()))


def check_recurrent(ptt, rates):
    """Phase 3 for the whole-sequence LSTM and GRU kernels: each against
    its plain version on the card (hs, cs and the gate stash) at its
    paths' shapes (the stacked LSTM's, the BiLSTM-CRF's, the NMT
    encoder's), forward and reversed, with ragged lengths including 0, at H = 16
    and 100, the GRU past one pass of rows (B = 80), and at H = 1100 and
    2048 in both directions; then kernel, plain version and cuDNN's LSTM / GRU timed
    at the path's shape as phase 3 times the others (the kernels'
    cooperative launches are captured in CUDA graphs like any other).
    Returns {kernel name: JSON fields (all but launches)}."""
    import torch
    from paddle_tpu_torch.fusion.recurrent import (
        gru_seq_cuda, gru_seq_plain, lstm_seq_cuda, lstm_seq_plain,
        recurrent_plan)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def blocks(kind, b, h):
        p = recurrent_plan(kind, b, h, dev)
        return (f"{p['blocks']} blocks of {p['ug'] * p['groups']} units, w "
                f"{'through L2' if p['stream_w'] else 'in shared memory'}")

    def make(n_gates, b, t, h, lengths):
        x = torch.randn(b, t, n_gates * h, device=dev, generator=gen) * 0.5
        w = torch.randn(h, n_gates * h, device=dev, generator=gen) * h ** -0.5
        h0 = torch.randn(b, h, device=dev, generator=gen) * 0.1
        c0 = torch.randn(b, h, device=dev, generator=gen) * 0.1
        sl = torch.tensor(lengths, dtype=torch.int64, device=dev)
        return x, w, h0, c0, sl

    def ragged(b, t):
        lens = torch.randint(1, t + 1, (b,), generator=torch.Generator()
                             .manual_seed(SEED + b + t)).tolist()
        lens[0], lens[1 % b], lens[2 % b] = t, 0, 1
        return lens

    lb, lt, lh = LSTM["batch"], LSTM["max_len"], LSTM["hid_dim"]
    gb, gt, gh = NMT["batch"], NMT["src_len"], NMT["hidden_dim"]
    cb, ct, ch = SRL["batch"], SRL["max_len"], SRL["size"] // 4
    # CRNN's BiGRU: B 64, T = width / 4 columns, H 96
    ob, ot, oh = CRNN["batch"], CRNN["width"] // 4, CRNN["hidden"]
    cases = [("lstm", lb, lt, lh, False), ("lstm", lb, lt, lh, True),
             ("lstm", cb, ct, ch, False), ("lstm", cb, ct, ch, True),
             ("lstm", 5, 13, 16, False), ("lstm", 37, 9, 100, True),
             ("lstm", 8, 9, 1100, False), ("lstm", 8, 9, 1100, True),
             ("lstm", 4, 5, 2048, False), ("lstm", 4, 5, 2048, True),
             ("gru", gb, gt, gh, False), ("gru", gb, gt, gh, True),
             ("gru", ob, ot, oh, False), ("gru", ob, ot, oh, True),
             ("gru", 5, 13, 16, True), ("gru", 37, 9, 100, False),
             ("gru", 80, 9, gh, False), ("gru", 80, 9, gh, True),
             ("gru", 8, 9, 1100, False), ("gru", 8, 9, 1100, True),
             ("gru", 4, 5, 2048, False), ("gru", 4, 5, 2048, True)]
    errs = {"lstm_seq": 0.0, "gru_seq": 0.0, "gru_seq_crnn": 0.0}
    for kind, b, t, h, rev in cases:
        x, w, h0, c0, sl = make(4 if kind == "lstm" else 3, b, t, h,
                                ragged(b, t))
        if kind == "lstm":
            outs = lstm_seq_cuda(x, h0, c0, w, sl, rev, True)
            refs = lstm_seq_plain(x, h0, c0, w, sl, rev, True)
            kname, labels = "lstm_seq", ("hs", "cs", "stash")
        else:
            outs = gru_seq_cuda(x, h0, w, sl, rev, True)
            refs = gru_seq_plain(x, h0, w, sl, rev, True)
            kname, labels = "gru_seq", ("hs", "stash")
        torch.cuda.synchronize()
        # a row of length 0 keeps its initial state at every step
        assert bool((outs[0][1] == h0[1]).all()), f"{kname}: row of length " \
            f"0 moved"
        worst, ok = 0.0, True
        for label, out, ref in zip(labels, outs, refs):
            e, good = _rnn_err(out, ref)
            worst, ok = max(worst, e), ok and good
        log(f"  {kname} B={b} T={t} H={h} reverse={rev} "
            f"({blocks(kind, b, h)}): max_abs_err={worst:.3e} over "
            f"{', '.join(labels)} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{kname} disagrees with its plain version "
                                 f"at B={b} T={t} H={h} reverse={rev}: "
                                 f"{worst}")
        if (b, t, h) in ((lb, lt, lh), (gb, gt, gh)):
            errs[kname] = max(errs[kname], worst)
        if (kind, b, t, h) == ("gru", ob, ot, oh):
            errs["gru_seq_crnn"] = max(errs["gru_seq_crnn"], worst)

    # timing at the paths' shapes, with the stash (training writes it),
    # lengths uniform over the cells' range; cuDNN's LSTM / GRU (input
    # size H, packed for the lengths) as the yardstick
    mem_rate, f32_rate, _ = rates
    lin = torch.nn.utils.rnn
    out = {}
    for kname, b, t, h, lo, key in (
            ("lstm_seq", lb, lt, lh, LSTM["len_lo"], "lstm_seq"),
            ("gru_seq", gb, gt, gh, NMT["src_lo"], "gru_seq"),
            # CRNN's columns all count: every row runs the full T
            ("gru_seq", ob, ot, oh, ot, "gru_seq_crnn")):
        ng = 4 if kname == "lstm_seq" else 3
        cls = torch.nn.LSTM if kname == "lstm_seq" else torch.nn.GRU
        lib = cls(h, h, batch_first=True).to(dev)
        sets = []
        for _ in range(2 if kname == "lstm_seq" else 4):
            lens = torch.randint(lo, t + 1, (b,), generator=gen,
                                 device=dev)
            x, w, h0, c0, sl = make(ng, b, t, h, lens.tolist())
            xin = torch.randn(b, t, h, device=dev, generator=gen)
            sets.append({"x": x, "w": w, "h0": h0, "c0": c0, "sl": sl,
                         "packed": lin.pack_padded_sequence(
                             xin, lens.cpu(), batch_first=True,
                             enforce_sorted=False)})
        if kname == "lstm_seq":
            fns = {"kernel": lambda s: lstm_seq_cuda(
                       s["x"], s["h0"], s["c0"], s["w"], s["sl"], False,
                       True),
                   "plain": lambda s: lstm_seq_plain(
                       s["x"], s["h0"], s["c0"], s["w"], s["sl"], False,
                       True)}
        else:
            fns = {"kernel": lambda s: gru_seq_cuda(
                       s["x"], s["h0"], s["w"], s["sl"], False, True),
                   "plain": lambda s: gru_seq_plain(
                       s["x"], s["h0"], s["w"], s["sl"], False, True)}
        with torch.no_grad():
            fns["library"] = lambda s: lib(s["packed"])
            times = time_in_turns(fns, sets, reps=10)
        # least time: x, w, h0 (c0), seqlen read once; hs (cs) and the
        # stash written once; the recurrent product's 2 B T H (ng H) flops
        # over the float32 rate (every step of every row computes its
        # gates, as in the TPU kernel; frozen rows keep the old state)
        nbytes = 4 * (2 * b * t * ng * h + h * ng * h + b
                      + (2 if ng == 4 else 1) * (b * h + b * t * h))
        flops = 2 * b * t * h * ng * h
        t_bytes, t_ops = nbytes / mem_rate, flops / f32_rate
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        n_sync = t if ng == 4 else 2 * t
        log(f"  {kname} timing B={b} T={t} H={h} float32 with stash "
            f"({blocks(kname[:-4], b, h)}, {n_sync + 1} grid barriers): "
            f"kernel {times['kernel'] * 1e3:.1f} us, plain "
            f"{times['plain'] * 1e3:.1f} us, cuDNN "
            f"{'LSTM' if ng == 4 else 'GRU'} {times['library'] * 1e3:.1f} "
            f"us, bound {bound_ms * 1e3:.1f} us ({bound_by}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at "
            f"{f32_rate / 1e12:.0f} TFLOP/s float32)")
        row = {"max_abs_err": errs[key], "ms": times["kernel"],
               "plain_ms": times["plain"], "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": times["library"]}
        if key == "gru_seq_crnn":
            out["gru_seq"].update({f"{k}_crnn": v for k, v in row.items()})
        else:
            out[kname] = row
    log("  (cuDNN's LSTM also computes the input product x.W_ih (input size "
        "H), the kernel takes x pre-projected; cuDNN's GRU applies r after "
        "the recurrent product, r (W_hn h), where this GRU computes "
        "(r h) W_c: a different function of the same cost)")
    return out


def check_recurrent_bf16(ptt, rates):
    """Phase 3's bfloat16 rows of K5 / K6: x, w and the states bfloat16,
    h and c carried in bfloat16 as the reference's XLA composite carries
    them. Each case (the stacked LSTM's shape, the NMT encoder's and
    CRNN's GRU shapes, forward and reversed, ragged lengths with 0 and 1;
    the streamed-w plans at H 1100; the GRU past one pass of rows) is held
    step by step against the plain version: every step of the plain cell
    is evaluated from the states the kernel carried into it, and each
    output must lie within the step's per-term slack
    (fusion/recurrent.py `recurrent_step_check`: each rounded term of the
    plain step moves by at most bfloat16's unit roundoff 2^-8 of its size,
    the kernel adds the rounding of the new c and h, and the float32 sums
    over H in another order). Three wrong kernels a cell must be rejected
    by the same check: w's gate columns rotated, the length freeze
    dropped, the freeze taken at the reversed steps. Then kernel, plain
    version and cuDNN's bfloat16 LSTM / GRU are timed at the three path
    shapes. Returns {kernel: {key_bf16: value}}."""
    import torch
    from paddle_tpu_torch.fusion.recurrent import (
        gru_seq_cuda, gru_seq_plain, lstm_seq_cuda, lstm_seq_plain,
        recurrent_step_check)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    bf = torch.bfloat16

    def make(ng, b, t, h, lengths):
        x = (torch.randn(b, t, ng * h, device=dev, generator=gen)
             * 0.5).to(bf)
        w = (torch.randn(h, ng * h, device=dev, generator=gen)
             * h ** -0.5).to(bf)
        h0 = (torch.randn(b, h, device=dev, generator=gen) * 0.1).to(bf)
        c0 = (torch.randn(b, h, device=dev, generator=gen) * 0.1).to(bf)
        sl = torch.tensor(lengths, dtype=torch.int64, device=dev)
        return x, w, h0, c0, sl

    def ragged(b, t):
        lens = torch.randint(1, t + 1, (b,), generator=torch.Generator()
                             .manual_seed(SEED + 3 * b + t)).tolist()
        lens[0], lens[1 % b], lens[2 % b] = t, 0, 1
        return lens

    def run(kind, x, h0, c0, w, sl, rev):
        if kind == "lstm":
            return lstm_seq_cuda(x, h0, c0, w, sl, rev, True)
        return gru_seq_cuda(x, h0, w, sl, rev, True)

    lb, lt, lh = LSTM["batch"], LSTM["max_len"], LSTM["hid_dim"]
    gb, gt, gh = NMT["batch"], NMT["src_len"], NMT["hidden_dim"]
    ob, ot, oh = CRNN["batch"], CRNN["width"] // 4, CRNN["hidden"]
    cases = [("lstm", lb, lt, lh, False), ("lstm", lb, lt, lh, True),
             ("lstm", 8, 9, 1100, False), ("lstm", 8, 9, 1100, True),
             ("gru", gb, gt, gh, False), ("gru", gb, gt, gh, True),
             ("gru", ob, ot, oh, False), ("gru", ob, ot, oh, True),
             ("gru", 80, 9, gh, True), ("gru", 8, 9, 1100, False),
             ("gru", 8, 9, 1100, True)]
    errs = {"lstm_seq": 0.0, "gru_seq": 0.0, "gru_seq_crnn": 0.0}
    ratios = {"lstm_seq": 0.0, "gru_seq": 0.0, "gru_seq_crnn": 0.0}
    n_launch = {"lstm_seq": 0, "gru_seq": 0}
    # cuBLAS's bfloat16 products reduce in float32 here, so the plain
    # step's dot rounds once, as the slack counts it
    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    try:
        for kind, b, t, h, rev in cases:
            ng = 4 if kind == "lstm" else 3
            x, w, h0, c0, sl = make(ng, b, t, h, ragged(b, t))
            outs = run(kind, x, h0, c0, w, sl, rev)
            n_launch[f"{kind}_seq"] += 1
            assert all(o.dtype == bf for o in outs)
            ok, err, ratio = recurrent_step_check(kind, x, h0, c0, w, sl,
                                                  rev, outs)
            # a row of length 0 keeps its initial state at every step
            assert bool((outs[0][1] == h0[1]).all()), \
                f"{kind}_seq bf16: row of length 0 moved"
            controls = []
            if (b, t, h) in ((lb, lt, lh), (gb, gt, gh), (ob, ot, oh)):
                rot = torch.roll(w.reshape(h, ng, h), 1, dims=1).reshape(
                    h, ng * h)
                for label, args in (
                        ("rotated gates", (x, h0, c0, rot, sl, rev)),
                        ("no freeze", (x, h0, c0, w,
                                       torch.full_like(sl, t), rev)),
                        ("freeze reversed", (x, h0, c0, w, sl, not rev))):
                    bad = run(kind, *args)
                    n_launch[f"{kind}_seq"] += 1
                    rej = not recurrent_step_check(kind, x, h0, c0, w, sl,
                                                   rev, bad)[0]
                    controls.append(f"{label} {'rejected' if rej else 'PASSED'}")
                    assert rej, f"{kind}_seq bf16 control {label} passed"
            log(f"  {kind}_seq bf16 B={b} T={t} H={h} reverse={rev}: "
                f"max_abs_err={err:.3e}, largest error / slack "
                f"{ratio:.3f} {'ok' if ok else 'FAIL'}"
                + (f"; controls: {', '.join(controls)}" if controls else ""))
            if not ok:
                raise AssertionError(
                    f"{kind}_seq bf16 disagrees with its plain version "
                    f"beyond the per-term slack at B={b} T={t} H={h} "
                    f"reverse={rev}: error / slack {ratio}")
            key = ("gru_seq_crnn" if (kind, b, t, h) == ("gru", ob, ot, oh)
                   else f"{kind}_seq" if (b, t, h) in ((lb, lt, lh),
                                                       (gb, gt, gh))
                   else None)
            if key:
                errs[key] = max(errs[key], err)
                ratios[key] = max(ratios[key], ratio)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = saved

    mem_rate, _, bf16_rate = rates
    lin = torch.nn.utils.rnn
    out = {"lstm_seq": {}, "gru_seq": {}}
    for kname, b, t, h, lo, key in (
            ("lstm_seq", lb, lt, lh, LSTM["len_lo"], "lstm_seq"),
            ("gru_seq", gb, gt, gh, NMT["src_lo"], "gru_seq"),
            ("gru_seq", ob, ot, oh, ot, "gru_seq_crnn")):
        ng = 4 if kname == "lstm_seq" else 3
        cls = torch.nn.LSTM if kname == "lstm_seq" else torch.nn.GRU
        lib = cls(h, h, batch_first=True).to(dev).to(bf)
        sets = []
        for _ in range(2 if kname == "lstm_seq" else 4):
            lens = torch.randint(lo, t + 1, (b,), generator=gen,
                                 device=dev)
            x, w, h0, c0, sl = make(ng, b, t, h, lens.tolist())
            xin = torch.randn(b, t, h, device=dev, generator=gen).to(bf)
            sets.append({"x": x, "w": w, "h0": h0, "c0": c0, "sl": sl,
                         "packed": lin.pack_padded_sequence(
                             xin, lens.cpu(), batch_first=True,
                             enforce_sorted=False)})
        kind = kname[:-4]
        plain = lstm_seq_plain if kind == "lstm" else gru_seq_plain

        def kernel_fn(s, kind=kind):
            return run(kind, s["x"], s["h0"], s["c0"], s["w"], s["sl"],
                       False)

        def plain_fn(s, kind=kind, plain=plain):
            if kind == "lstm":
                return plain(s["x"], s["h0"], s["c0"], s["w"], s["sl"],
                             False, True)
            return plain(s["x"], s["h0"], s["w"], s["sl"], False, True)

        fns = {"kernel": kernel_fn, "plain": plain_fn,
               "library": lambda s: lib(s["packed"])}
        with torch.no_grad():
            try:     # the yardstick only: cuDNN may not take bfloat16
                lib(sets[0]["packed"])
            except RuntimeError as e:
                log(f"  (cuDNN's bfloat16 {cls.__name__} refused: {e}; "
                    f"library_ms is null)")
                del fns["library"]
            times = time_in_turns(fns, sets, reps=10)
        times.setdefault("library", None)
        # least time: x, w, h0 (c0), seqlen read once and hs (cs) and the
        # stash written once, 2 bytes an element; the recurrent product's
        # 2 B T H (ng H) flops at the dense bfloat16 rate of the inputs'
        # type
        nbytes = (2 * (b * t * ng * h + h * ng * h
                       + (2 if ng == 4 else 1) * (b * h + b * t * h)
                       + b * t * ng * h) + 8 * b)
        flops = 2 * b * t * h * ng * h
        t_bytes, t_ops = nbytes / mem_rate, flops / bf16_rate
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"  {kname} bf16 timing B={b} T={t} H={h} with stash: kernel "
            f"{times['kernel'] * 1e3:.1f} us, plain "
            f"{times['plain'] * 1e3:.1f} us, cuDNN bf16 "
            f"{'LSTM' if ng == 4 else 'GRU'} "
            f"{'-' if times['library'] is None else round(times['library'] * 1e3, 1)} "
            f"us, bound {bound_ms * 1e3:.2f} us ({bound_by}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at "
            f"{bf16_rate / 1e12:.0f} TFLOP/s bfloat16)")
        sfx = "_crnn_bf16" if key == "gru_seq_crnn" else "_bf16"
        out[kname].update({f"max_abs_err{sfx}": errs[key],
                           f"err_over_slack{sfx}": ratios[key],
                           f"ms{sfx}": times["kernel"],
                           f"plain_ms{sfx}": times["plain"],
                           f"bound_ms{sfx}": bound_ms,
                           f"bound_by{sfx}": bound_by,
                           f"library_ms{sfx}": times["library"]})
    # the bfloat16 cells are on no model's path (no zoo model casts its
    # recurrent layers): their launches are phase 3's checks
    for kname, n in n_launch.items():
        out[kname]["launches_bf16_checks"] = n
    return out


def check_decode_attention_nmt(rates):
    """Phase 3 for the decode-attention kernel at the NMT decoder's shape
    (q [B, 1, H] over the encoder's [B, T, H], so R = 1, nh = B, dh = H =
    512, float32): the forward against the plain version, and the gradient
    of `fused_decode_attention` (its autograd function) against autograd
    of the plain version. Returns the JSON fields it adds to the kernel's
    entry."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.fusion.decode_attention import (
        decode_attention_chunk, decode_attention_cuda, decode_attention_plain,
        fused_decode_attention)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    b, t, h = NMT["batch"], NMT["src_len"], NMT["hidden_dim"]
    splits = -(-t // decode_attention_chunk(1, b, t, h))

    def make():
        q = torch.randn(b, 1, h, device=dev, generator=gen)
        enc = torch.randn(b, t, h, device=dev, generator=gen)
        lens = torch.randint(1, t + 1, (b, 1), device=dev, generator=gen)
        bias = torch.where(torch.arange(t, device=dev)[None] < lens, 0.0,
                           -1e9)[:, None, :]
        return q, enc, bias

    q, enc, bias = make()
    out = fused_decode_attention(q, enc, enc, bias, 1.0)
    ref = decode_attention_plain(q.reshape(1, b, h), enc[None], enc[None],
                                 bias.reshape(1, b, t), 1.0).reshape(b, 1, h)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    ok = err <= 1e-5 * max(1.0, float(ref.abs().max()))
    log(f"  decode_attention NMT shape R=1 nh={b} T={t} dh={h} float32: "
        f"max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"decode_attention at dh={h}: {err}")

    # gradient: the same upstream gradient through both
    dout = torch.randn(b, 1, h, device=dev, generator=gen)
    leaves = [a.detach().clone().requires_grad_() for a in (q, enc, bias)]
    out = fused_decode_attention(leaves[0], leaves[1], leaves[1], leaves[2],
                                 1.0)
    assert out.grad_fn is not None, \
        "fused_decode_attention on the card records no gradient"
    kgrads = torch.autograd.grad(out, leaves, dout)
    plain_leaves = [a.detach().clone().requires_grad_() for a in (q, enc,
                                                                  bias)]
    pq, pe, pb = plain_leaves
    pout = decode_attention_plain(pq.reshape(1, b, h), pe[None], pe[None],
                                  pb.reshape(1, b, t), 1.0)
    pgrads = torch.autograd.grad(pout.reshape(b, 1, h), plain_leaves, dout)
    gerr = 0.0
    for name, kg, pg in zip(("q", "k=v", "bias"), kgrads, pgrads):
        e = float((kg - pg).abs().max())
        gerr = max(gerr, e)
        if e > 1e-5 * max(1.0, float(pg.abs().max())):
            raise AssertionError(f"decode_attention gradient d{name} at "
                                 f"dh={h}: {e}")
    log(f"  decode_attention gradient (autograd function against autograd "
        f"of the plain version), dq, d(k=v), dbias: max_abs_err="
        f"{gerr:.3e} ok")

    sets = [dict(zip(("q", "enc", "bias"), make())) for _ in range(8)]
    for st in sets:
        st["q3"] = st["q"].reshape(1, b, h)
        st["k4"] = st["enc"][None]
        st["b3"] = st["bias"].reshape(1, b, t)
        st["mask4"] = st["bias"][None]
    times = time_in_turns({
        "kernel": lambda s: decode_attention_cuda(s["q3"], s["k4"], s["k4"],
                                                  s["b3"], 1.0),
        "plain": lambda s: decode_attention_plain(s["q3"], s["k4"], s["k4"],
                                                  s["b3"], 1.0),
        "library": lambda s: F.scaled_dot_product_attention(
            s["q3"][:, :, None], s["k4"], s["k4"],
            attn_mask=s["b3"][:, :, None], scale=1.0),
    }, sets)
    mem_rate, f32_rate, _ = rates
    # q and the output [B, H], the encoder's [B, T, H] read once (the
    # decoder passes it as both K and V), the [B, T] mask
    nbytes = 4 * (b * h + b * t * h + b * t + b * h)
    flops = 4 * b * t * h + 5 * b * t
    bound_ms = max(nbytes / mem_rate, flops / f32_rate) * 1e3
    log(f"  decode_attention timing at the NMT shape ({splits} chunks a "
        f"row and head): kernel "
        f"{times['kernel'] * 1e3:.2f} us, plain {times['plain'] * 1e3:.2f} "
        f"us, SDPA {times['library'] * 1e3:.2f} us, bound "
        f"{bound_ms * 1e3:.2f} us (bytes: {nbytes / 1e6:.2f} MB, the "
        f"encoder's output counted once: K and V are one tensor)")
    return {"max_abs_err_nmt": err, "max_abs_err_grad_nmt": gerr,
            "splits_nmt": splits, "ms_nmt": times["kernel"],
            "plain_ms_nmt": times["plain"],
            "bound_ms_nmt": bound_ms, "library_ms_nmt": times["library"]}


def check_decode_attention_beam(rates):
    """Phase 3 for the decode-attention kernel at the beam decoder's shape
    (phase 32): the K = BEAM["beam_size"] beams of a row attend over the
    encoder's [B, T, H] outputs as G = K query rows, so R = 1, nh = B,
    G = K, dh = H = 512, float32, and the [B, 1, T] source mask is
    broadcast over the K rows (stride 0). The forward through
    `fused_decode_attention` (the op's route) against the plain version
    at 1e-5, then kernel, plain and SDPA (the same float mask, the
    library yardstick) timed in turns. Returns the `*_beam` fields."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.fusion.decode_attention import (
        decode_attention_chunk, decode_attention_cuda, decode_attention_plain,
        fused_decode_attention)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    b, t, h, g = NMT["batch"], NMT["src_len"], NMT["hidden_dim"], \
        BEAM["beam_size"]
    splits = -(-t // decode_attention_chunk(1, b, t, h))

    def make():
        q = torch.randn(b, g, h, device=dev, generator=gen)
        enc = torch.randn(b, t, h, device=dev, generator=gen)
        lens = torch.randint(NMT["src_lo"], t + 1, (b, 1), device=dev,
                             generator=gen)
        bias = torch.where(torch.arange(t, device=dev)[None] < lens, 0.0,
                           -1e9)[:, None, :]
        return q, enc, bias

    q, enc, bias = make()
    out = fused_decode_attention(q, enc, enc, bias, 1.0)
    ref = decode_attention_plain(q[None], enc[None], enc[None],
                                 bias.expand(b, g, t)[None], 1.0)[0]
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    ok = err <= 1e-5 * max(1.0, float(ref.abs().max()))
    log(f"  decode_attention beam shape R=1 nh={b} G={g} T={t} dh={h} "
        f"float32, mask [{b}, 1, {t}] over the G rows ({splits} chunks a "
        f"row and head): max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"decode_attention at the beam shape: {err}")

    sets = [dict(zip(("q", "enc", "bias"), make())) for _ in range(8)]
    for st in sets:
        st["q4"] = st["q"][None]                        # [1, B, K, H]
        st["k4"] = st["enc"][None]                      # [1, B, T, H]
        st["b4"] = st["bias"].expand(b, g, t)[None]     # stride 0 over K
        st["mask4"] = st["b4"]
    times = time_in_turns({
        "kernel": lambda s: decode_attention_cuda(s["q4"], s["k4"], s["k4"],
                                                  s["b4"], 1.0),
        "plain": lambda s: decode_attention_plain(s["q4"], s["k4"], s["k4"],
                                                  s["b4"], 1.0),
        "library": lambda s: F.scaled_dot_product_attention(
            s["q4"], s["k4"], s["k4"], attn_mask=s["mask4"], scale=1.0),
    }, sets)
    mem_rate, f32_rate, _ = rates
    # q and the output [B, K, H], the encoder's [B, T, H] read once (the
    # decoder passes it as both K and V), the [B, T] mask read once
    nbytes = 4 * (2 * b * g * h + b * t * h + b * t)
    flops = 4 * b * g * t * h + 5 * b * g * t
    bound_ms = max(nbytes / mem_rate, flops / f32_rate) * 1e3
    bound_by = "bytes" if nbytes / mem_rate >= flops / f32_rate else \
        "operations"
    log(f"  decode_attention timing at the beam shape: kernel "
        f"{times['kernel'] * 1e3:.2f} us, plain {times['plain'] * 1e3:.2f} "
        f"us, SDPA {times['library'] * 1e3:.2f} us, bound "
        f"{bound_ms * 1e3:.2f} us ({bound_by}: {nbytes / 1e6:.2f} MB, "
        f"{flops / 1e6:.1f} MFLOP)")
    return {"max_abs_err_beam": err, "splits_beam": splits,
            "ms_beam": times["kernel"], "plain_ms_beam": times["plain"],
            "bound_ms_beam": bound_ms, "bound_by_beam": bound_by,
            "library_ms_beam": times["library"]}


def _segments(gen, b, t, dev):
    """[b, t] int32 packed-row segment ids: each row holds sequences of
    random lengths 16-160 back to back (ids 1, 2, ...), then padding 0."""
    import torch
    ids = torch.zeros(b, t, dtype=torch.int32)
    for r in range(b):
        pos, sid = 0, 1
        while True:
            n = int(torch.randint(16, 161, (1,), generator=gen))
            if pos + n > t:
                break
            ids[r, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    return ids.to(dev)


def _flash_controls(q, k, v, do, lse, delta, scale, refs, slacks):
    """Phase 3's controls on the LM-shape bfloat16 case: wrong kernels'
    outputs, computed by the plain version, each of which the bound check
    must reject (for every kernel, three). Returns {control: {kernel:
    largest err/tolerance}}; raises unless every control is rejected."""
    from paddle_tpu_torch.ops.flash_attention import (
        flash_bwd_plain, flash_check, flash_control_masks, flash_fwd_plain)
    tq, tk = q.shape[2], k.shape[2]
    ratios = {}
    for name, mask in flash_control_masks(tq, tk, q.device).items():
        mask = mask[None, None]
        o_c, _ = flash_fwd_plain(q, k, v, scale, True, mask=mask)
        dq_c, dk_c, dv_c = flash_bwd_plain(q, k, v, None, lse, do, scale,
                                           True, delta=delta, mask=mask)
        ratios[name] = {
            "flash_fwd": flash_check(o_c, refs["o"], slacks["o"])["ratio"],
            "flash_bwd_dq": flash_check(dq_c, refs["dq"],
                                        slacks["dq"])["ratio"],
            "flash_bwd_dkv": max(
                flash_check(dk_c, refs["dk"], slacks["dk"])["ratio"],
                flash_check(dv_c, refs["dv"], slacks["dv"])["ratio"])}
    # dS not multiplied by scale: scale is a power of two at D = 64, so this
    # is exactly the plain version without it
    dk_c = (refs["dk"].float() / scale).to(refs["dk"].dtype)
    ratios["dk_without_scale"] = {"flash_bwd_dkv": flash_check(
        dk_c, refs["dk"], slacks["dk"])["ratio"]}
    dq_c = (refs["dq"].float() / scale).to(refs["dq"].dtype)
    ratios["dq_without_scale"] = {"flash_bwd_dq": flash_check(
        dq_c, refs["dq"], slacks["dq"])["ratio"]}
    for name, per in ratios.items():
        log(f"  control {name}: largest err/bound "
            + ", ".join(f"{k} {r:.3g}" for k, r in per.items())
            + (" rejected" if min(per.values()) > 1 else " ADMITTED"))
        if not min(per.values()) > 1:
            raise AssertionError(f"the bound check admits the control "
                                 f"{name}: {per}")
    return ratios


def _ptxas_props(log_text):
    """{mangled kernel name: {"regs", "spill"}} from nvcc's -Xptxas -v."""
    props, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:entry function '|Function properties for )"
                      r"(\w+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            props.setdefault(cur, {})["spill"] = int(m.group(1)) + int(
                m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            props.setdefault(cur, {})["regs"] = int(m.group(1))
    return props


def _tc_build_report(kernels):
    """Phase 2's report of the flash kernels from nvcc's -Xptxas -v:
    registers and spills of each tensor-core instantiation, with the
    dynamic shared memory each launch asks for, and of the float32 ones at
    D = 256. Raises on a spill at D = 64 and on any at D = 256, where the
    bfloat16 blocks each compute one half of the output columns and the
    float32 K2 and K3 take 32-row query tiles so as to fit."""
    from paddle_tpu_torch.ops.flash_attention import _bind
    lib = kernels.load("flash_attention")
    _bind(lib)
    if "flash_attention" not in kernels.BUILD_LOGS:
        log("  (flash_attention was built by an earlier run: no ptxas report)")
        return
    props = _ptxas_props(kernels.BUILD_LOGS["flash_attention"])
    for which, tag, bf16 in ((0, "flash_fwd_tc", 1), (1, "flash_dq_tc", 1),
                             (2, "flash_dkv_tc", 1), (0, "flash_fwd", 0),
                             (1, "flash_dq", 0), (2, "flash_dkv", 0)):
        for dh in ((32, 64, 128, 256) if bf16 else (256,)):
            name = next((n for n in props
                         if f"{tag}_kernelILi{dh}E" in n), None)
            pr = props.get(name, {})
            log(f"  [{tag} D={dh}] registers {pr.get('regs')}, spill bytes "
                f"{pr.get('spill')}, dynamic shared memory "
                f"{lib.ptt_flash_smem_bytes(which, bf16, dh)} bytes")
            if dh in (64, 256):
                assert name is not None, f"no ptxas report for {tag} D={dh}"
                assert pr.get("spill") == 0, f"{tag} D={dh} spills: {pr}"
    # the wide-head route (D > 256) on the CUDA cores: float32 K1-K3 and
    # bfloat16 K3, one instantiation per type, D a runtime argument, the
    # same shared memory at every D
    for which, tag, types in ((0, "flash_fwd_wide", (0,)),
                              (1, "flash_dq_wide", (0,)),
                              (2, "flash_dkv_wide", (0, 1))):
        for bf16 in types:
            tname = "13__nv_bfloat16" if bf16 else "f"
            name = next((n for n in props
                         if f"{tag}_kernelI{tname}E" in n), None)
            pr = props.get(name, {})
            log(f"  [{tag} {'bf16' if bf16 else 'f32'}] registers "
                f"{pr.get('regs')}, spill bytes {pr.get('spill')}, dynamic "
                f"shared memory {lib.ptt_flash_smem_bytes(which, bf16, 512)} "
                f"bytes (any D)")
            assert name is not None, f"no ptxas report for {tag} {tname}"
    # bfloat16 K1 and K2 there, on the tensor cores in clusters of
    # min(8, D / 128) blocks: <true> up to D = 1024 (Q's, dO's fragments
    # held), <false> above; shared memory by D
    for which, tag in ((0, "flash_fwd_wide_tc"), (1, "flash_dq_wide_tc")):
        for hold, dims in ((1, (384, 512, 1024)), (0, (1152, 2048))):
            name = next((n for n in props
                         if f"{tag}_kernelILb{hold}E" in n), None)
            pr = props.get(name, {})
            smem = {dh: lib.ptt_flash_smem_bytes(which, 1, dh) for dh in dims}
            log(f"  [{tag}<{'true' if hold else 'false'}> bf16] registers "
                f"{pr.get('regs')}, spill bytes {pr.get('spill')}, dynamic "
                f"shared memory by D {smem}")
            assert name is not None, f"no ptxas report for {tag} <{hold}>"
            assert pr.get("spill") == 0, f"{tag} <{hold}> spills: {pr}"


def _recurrent_build_report(kernels):
    """Phase 2's report of the recurrent kernels K5 (lstm_seq_kernel<UG>)
    and K6 (gru_seq_kernel<UG>), UG units a column group: registers and
    spills per instantiation from nvcc's -Xptxas -v, and the plan (units,
    blocks, where w lives, dynamic shared memory) at the paths' shapes and
    the large hidden sizes. Raises on a spill of either at UG = 4, the
    stacked LSTM's and the NMT encoder's."""
    import torch
    from paddle_tpu_torch.fusion.recurrent import recurrent_plan
    dev = torch.device("cuda", 0)
    if "recurrent" not in kernels.BUILD_LOGS:
        log("  (recurrent was built by an earlier run: no ptxas report)")
    else:
        props = _ptxas_props(kernels.BUILD_LOGS["recurrent"])
        for kind in ("lstm", "gru"):
            for ug in (1, 2, 4):
                # <UG, float> and <UG, __nv_bfloat16>
                for etype, mangled in (("float32", "fE"),
                                       ("bfloat16", "13__nv_bfloat16E")):
                    tag = f"{kind}_seq_kernelILi{ug}E{mangled}"
                    name = next((n for n in props if tag in n), None)
                    pr = props.get(name, {})
                    log(f"  [{kind}_seq_kernel<{ug}, {etype}>] registers "
                        f"{pr.get('regs')}, spill bytes {pr.get('spill')}")
                    if ug == 4:
                        assert name is not None, \
                            f"no ptxas report for {kind}_seq UG=4 {etype}"
                        assert pr.get("spill") == 0, \
                            f"{kind}_seq UG=4 {etype} spills: {pr}"
    for kind, b, h in (("lstm", LSTM["batch"], LSTM["hid_dim"]),
                       ("lstm", 8, 1100), ("lstm", 4, 2048),
                       ("gru", NMT["batch"], NMT["hidden_dim"]),
                       ("gru", 80, NMT["hidden_dim"]), ("gru", 8, 1100),
                       ("gru", 4, 2048)):
        p = recurrent_plan(kind, b, h, dev)
        where = "through L2" if p["stream_w"] else "in shared memory"
        log(f"  [{kind}_seq B={b} H={h}] {p['blocks']} blocks of "
            f"{p['ug'] * p['groups']} units ({p['groups']} column groups of "
            f"{p['ug']}), w {where}, dynamic shared memory {p['smem']} "
            f"bytes")


def _time_flash(make, b, h, t, d, rates, names=None):
    """K1, K2 and K3 (or those of `names`) timed at [b, h, t, d] in
    bfloat16, causal, with the plain versions and the library's yardstick
    (SDPA's forward; for the backward kernels SDPA's backward for all three:
    its captured forward and backward less its forward), over rotating input
    sets that exceed the L2 three times over. Returns {kernel name: {"ms",
    "plain_ms", "bound_ms", "bound_by", "library_ms"}}."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_bwd_plain, flash_delta,
        flash_fwd_cuda, flash_fwd_plain)
    bf16 = torch.bfloat16
    scale = d ** -0.5
    set_bytes = 4 * b * h * t * d * 2
    n_sets = max(4, math.ceil(3 * 50e6 / set_bytes))
    sets = []
    for _ in range(n_sets):
        q, k, v, do = make(b, h, t, t, d, bf16)
        o, lse = flash_fwd_cuda(q, k, v, scale, True)
        sets.append({"q": q, "k": k, "v": v, "do": do, "o": o, "lse": lse,
                     "delta": flash_delta(o, do)})
    for st in sets:      # SDPA's backward differentiates leaf copies
        st.update({n + "_leaf": st[n].detach().clone().requires_grad_()
                   for n in ("q", "k", "v")})

    def sdpa_fwd_bwd(st):
        leaves = (st["q_leaf"], st["k_leaf"], st["v_leaf"])
        o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                           scale=scale)
        torch.autograd.grad(o, leaves, st["do"])

    fns = {
        "fwd": lambda s: flash_fwd_cuda(s["q"], s["k"], s["v"], scale, True),
        "fwd_plain": lambda s: flash_fwd_plain(s["q"], s["k"], s["v"],
                                               scale, True),
        "fwd_lib": lambda s: F.scaled_dot_product_attention(
            s["q"], s["k"], s["v"], is_causal=True, scale=scale),
        "dq": lambda s: flash_bwd_dq_cuda(s["q"], s["k"], s["v"], s["do"],
                                          s["lse"], s["delta"], scale, True),
        "dkv": lambda s: flash_bwd_dkv_cuda(s["q"], s["k"], s["v"], s["do"],
                                            s["lse"], s["delta"], scale,
                                            True),
        "bwd_plain": lambda s: flash_bwd_plain(
            s["q"], s["k"], s["v"], None, s["lse"], s["do"], scale, True,
            delta=s["delta"]),
        "fwd_bwd_lib": sdpa_fwd_bwd,
    }
    names = FLASH if names is None else names
    if "flash_bwd_dkv" not in names:
        del fns["dkv"]
    times = time_in_turns(fns, sets, reps=20)
    lib_bwd = times["fwd_bwd_lib"] - times["fwd_lib"]
    mem_rate, _, tc_rate = rates
    tile = b * h * t * d * 2            # one [B,H,T,D] bf16 tensor
    rows = b * h * t * 4                # one [B,H,T] float32 vector
    causal_pairs = b * h * t * (t + 1) / 2
    work = {   # bytes: inputs read once, outputs written once; causal flops
        "flash_fwd": (3 * tile + tile + rows, 4 * causal_pairs * d),
        "flash_bwd_dq": (4 * tile + 2 * rows + tile, 6 * causal_pairs * d),
        "flash_bwd_dkv": (4 * tile + 2 * rows + 2 * tile,
                          8 * causal_pairs * d),
    }
    kernel_ms = {"flash_fwd": times["fwd"], "flash_bwd_dq": times["dq"],
                 "flash_bwd_dkv": times.get("dkv")}
    plain_ms = {"flash_fwd": times["fwd_plain"],
                "flash_bwd_dq": times["bwd_plain"],
                "flash_bwd_dkv": times["bwd_plain"]}
    library_ms = {"flash_fwd": times["fwd_lib"], "flash_bwd_dq": lib_bwd,
                  "flash_bwd_dkv": lib_bwd}
    out = {}
    for kname, (nbytes, flops) in work.items():
        if kname not in names:
            continue
        t_bytes, t_ops = nbytes / mem_rate, flops / tc_rate
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"  {kname} timing B={b} H={h} T={t} D={d} bf16 causal, "
            f"{n_sets} input sets: kernel {kernel_ms[kname] * 1e3:.1f} us, "
            f"plain {plain_ms[kname] * 1e3:.1f} us, library "
            f"{library_ms[kname] * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} "
            f"us ({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
            f"GFLOP at {tc_rate / 1e12:.0f} TFLOP/s bf16)")
        out[kname] = {"ms": kernel_ms[kname], "plain_ms": plain_ms[kname],
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": library_ms[kname]}
    return out


def _sdpa_kernels(make, b, h, t, d):
    """The device kernels of one SDPA forward (causal, bfloat16) at
    [b, h, t, d], from the profiler: which of its backends took the
    shape."""
    import torch
    import torch.nn.functional as F
    q, k, v, _ = make(b, h, t, t, d, torch.bfloat16)
    F.scaled_dot_product_attention(q, k, v, is_causal=True)
    wall, events = _profile(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 1,
        annotate=False)
    names = [e.key[:60] for e in sorted(device_kernels(events),
                                        key=dev_self, reverse=True)[:4]]
    log(f"  SDPA at B={b} H={h} T={t} D={d} bf16 causal runs {names}")
    return names


def check_flash(ptt, rates):
    """Phase 3 for the flash-attention kernels K1 (forward), K2 (dQ) and
    K3 (dK/dV): each against its plain version on the card over the LM's
    shape and the edge cases in both types (head dims 16, 40, 96 and 160
    run zero-padded to 32, 64, 128 and 256 inside the wrappers; 300, 384,
    512, 1000, 1100 and 1152 on the wide-head route, 300, 1000 and 1100
    padded to 384, 1024 and 1152, with the same masks), then timed at the
    LM shape and at head dims 256 and 512, K1 and K2 also at 1024 (an
    8-block cluster) and 2048 (two clusters a tile); the controls are
    rejected at D = 64 and 512.
    bfloat16 (the tensor-core kernels) is held to the per-term bounds of
    ops/flash_attention.py (`flash_fwd_bound`, `flash_bwd_dq_bound`,
    `flash_bwd_dkv_bound`), float32 to 1e-5 max(1, |ref|) (`flash_check`).
    Returns {kernel name: JSON fields (all but launches)}."""
    import torch
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_bound, flash_bwd_dkv_cuda, flash_bwd_dq_bound,
        flash_bwd_dq_cuda, flash_bwd_plain, flash_check, flash_delta,
        flash_fwd_bound, flash_fwd_cuda, flash_fwd_plain, kernel_head_dim,
        launch_route, pad_head_dim)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cpu_gen = torch.Generator().manual_seed(SEED)
    b, h, t, d = (TRAIN["batch"], TRAIN["num_heads"], TRAIN["max_len"],
                  TRAIN["d_model"] // TRAIN["num_heads"])
    bf16, f32 = torch.bfloat16, torch.float32

    def make(cb, ch, tq, tk, cd, dt):
        q = torch.randn(cb, ch, tq, cd, device=dev, generator=gen).to(dt)
        k = torch.randn(cb, ch, tk, cd, device=dev, generator=gen).to(dt)
        v = torch.randn(cb, ch, tk, cd, device=dev, generator=gen).to(dt)
        do = torch.randn(cb, ch, tq, cd, device=dev, generator=gen).to(dt)
        return q, k, v, do

    # (label, B, H, Tq, Tk, D, causal, segment ids), each in both types
    packed = _segments(cpu_gen, 4, t, dev)
    kv_ids = torch.full((2, 96), 7, dtype=torch.int32, device=dev)
    q_ids = kv_ids.clone()
    q_ids[:, :40] = 99           # an id no key carries: those rows see nothing
    # two segments and padding a row, unaligned to the 64-row tiles
    halves = torch.zeros(2, 130, dtype=torch.int32)
    halves[0, :50], halves[0, 50:110] = 1, 2
    halves[1, :90], halves[1, 90:] = 1, 2
    halves = halves.to(dev)
    shapes = [
        ("lm", b, h, t, t, d, True, None),
        ("packed", 4, h, t, t, d, True, packed),
        ("tq<tk", 2, 4, 200, 328, d, True, None),
        ("odd_t", 3, 2, 200, 200, d, False, None),
        ("d128", 2, 4, 256, 256, 128, True, None),
        ("d32", 2, 2, 96, 96, 32, True, None),
        ("d16", 2, 4, 128, 128, 16, True, None),    # padded to 32
        ("d40", 2, 2, 200, 200, 40, True, None),    # padded to 64
        ("d96", 2, 4, 256, 160, 96, False, None),   # padded to 128
        ("d160", 2, 4, 256, 256, 160, True, None),  # padded to 256
        ("d256", 2, 4, 256, 200, 256, True, None),
        ("no_key", 2, 2, 160, 96, d, True, None),   # rows 0-63 causal
        ("no_key_seg", 2, 2, 96, 96, d, False, (q_ids, kv_ids)),
        # the wide-head route (D > 256, padded to a multiple of 128)
        ("d300", 2, 2, 130, 130, 300, True, None),  # padded to 384
        ("d512", 2, 4, 200, 256, 512, True, None),
        ("d512_packed", 4, 2, t, t, 512, True, packed),
        ("d512_no_key", 1, 2, 160, 96, 512, True, None),
        ("d384_no_key_seg", 2, 2, 96, 96, 384, False, (q_ids, kv_ids)),
        ("d1000", 1, 2, 96, 96, 1000, False, None),  # padded to 1024
        # above D 1024: two clusters a tile, Q's and dO's slices streamed;
        # block 0 sums two of the nine score slices, blocks 1-7 one each
        ("d1152", 1, 2, 130, 130, 1152, True, None),
        ("d1100_seg", 2, 2, 130, 130, 1100, True, halves),  # padded to 1152
    ]
    errs, controls, controls_512 = {}, None, None
    kernels.reset_launch_counts()
    for (label, cb, ch, tq, tk, cd, causal, seg) in shapes:
        for dt in (bf16, f32):
            q, k, v, do = make(cb, ch, tq, tk, cd, dt)
            scale = cd ** -0.5
            qs, ks = seg if isinstance(seg, tuple) else (seg, seg)
            o, lse = flash_fwd_cuda(q, k, v, scale, causal, qs, ks)
            o_ref, lse_ref = flash_fwd_plain(q, k, v, scale, causal, qs, ks)
            delta = flash_delta(o, do)
            dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal,
                                   qs, ks)
            dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale,
                                        causal, qs, ks)
            dq_ref, dk_ref, dv_ref = flash_bwd_plain(
                q, k, v, None, lse, do, scale, causal, qs, ks, delta=delta)
            torch.cuda.synchronize()
            if label.startswith("no_key"):
                dead = (lse_ref <= -1e29)
                assert bool(dead.any()), f"{label}: no row without a key"
                assert bool((o.float()[dead] == 0).all()), \
                    f"{label}: a row with no visible key has a nonzero output"
            slack = dict.fromkeys(("o", "lse", "dq", "dk", "dv"))
            if dt == bf16:
                # the tensor cores sum over the padded head dim: the bounds
                # are taken on the tensors the kernels ran on, then sliced
                kd = kernel_head_dim(cd)
                qp, kp, vp, dop, op_ref, dqp, dkp, dvp = pad_head_dim(
                    kd, q, k, v, do, o_ref, dq_ref, dk_ref, dv_ref)
                slack["o"], slack["lse"] = flash_fwd_bound(
                    qp, kp, vp, op_ref, lse_ref, scale, causal, qs, ks)
                slack["dq"] = flash_bwd_dq_bound(
                    qp, kp, vp, dop, lse, delta, dqp, scale, causal, qs, ks)
                slack["dk"], slack["dv"] = flash_bwd_dkv_bound(
                    qp, kp, vp, dop, lse, delta, dkp, dvp, scale, causal,
                    qs, ks)
                for n in ("o", "dq", "dk", "dv"):
                    slack[n] = slack[n][..., :cd]
                del qp, kp, vp, dop, op_ref, dqp, dkp, dvp
            res = {}
            for kname, pairs in (
                    ("flash_fwd", [("o", o, o_ref), ("lse", lse, lse_ref)]),
                    ("flash_bwd_dq", [("dq", dq, dq_ref)]),
                    ("flash_bwd_dkv", [("dk", dk, dk_ref),
                                       ("dv", dv, dv_ref)])):
                checks = {n: flash_check(out, ref, slack.get(n))
                          for n, out, ref in pairs}
                worst = max(c["max_abs_err"] for c in checks.values())
                ratio = max(c["ratio"] for c in checks.values())
                ok = all(c["ok"] for c in checks.values())
                res[kname] = {"err": worst, "ratio": ratio, "beyond_step": {
                    n: c["beyond_step"] for n, c in checks.items()}}
                tol = "1e-5" if dt == f32 else "per-term bound"
                log(f"  {kname} {label} B={cb} H={ch} Tq={tq} Tk={tk} "
                    f"D={cd} {str(dt)[6:]} causal={causal} "
                    f"segments={'yes' if seg is not None else 'no'}: "
                    f"max_abs_err={worst:.3e} err/tol={ratio:.3g} ({tol})"
                    + ("; beyond one bf16 step: " + ", ".join(
                        f"{n} {c['beyond_step']:.2e}"
                        for n, c in checks.items() if n != "lse")
                       if dt == bf16 else "")
                    + f" {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{kname} disagrees with its plain "
                                         f"version ({label}, {dt}): {checks}")
            errs[(label, dt)] = res
            if label in ("lm", "d512") and dt == bf16:
                ctl = _flash_controls(
                    q, k, v, do, lse, delta, scale,
                    {"o": o_ref, "dq": dq_ref, "dk": dk_ref, "dv": dv_ref},
                    slack)
                controls = ctl if label == "lm" else controls
                controls_512 = ctl if label == "d512" else None
            del slack

    # the eight D > 256 cases in both types: bfloat16 K1 and K2 on the
    # tensor cores, float32 K1-K3 and bfloat16 K3 on the CUDA cores
    by_name = {n: c for n, c in kernels.LAUNCHES.items()
               if n.startswith("flash_")}
    wide = {k: kernels.LAUNCHES[k] for k in FLASH_WIDE}
    log(f"  wide-head route launches over the cases above: {wide}")
    want = {"flash_fwd_wide": 8, "flash_bwd_dq_wide": 8,
            "flash_bwd_dkv_wide": 2 * 8, "flash_fwd_wide_tc": 8,
            "flash_bwd_dq_wide_tc": 8}
    assert wide == want, \
        f"the D > 256 cases took other routes than {want}: {wide}"

    # timing at the LM's shape and type (bf16, causal), and at head dims
    # 256 and 512 (B 2, H 8, T 512), which no path of the port reaches yet
    timed = _time_flash(make, b, h, t, d, rates)
    timed_256 = _time_flash(make, 2, 8, t, 256, rates)
    timed_512 = _time_flash(make, 2, 8, t, 512, rates)
    # an 8-block cluster: K1 and K2 at D = 1024 (K3 there runs the CUDA
    # cores' design of D = 512, not timed again)
    timed_1024 = _time_flash(make, 2, 4, t, 1024, rates,
                             names=("flash_fwd", "flash_bwd_dq"))
    # two clusters a tile (each sums S, K2 also dP, over all of D)
    timed_2048 = _time_flash(make, 2, 4, t, 2048, rates,
                             names=("flash_fwd", "flash_bwd_dq"))
    sdpa_512 = _sdpa_kernels(make, 2, 8, t, 512)
    out = {}
    for kname, tm in timed.items():
        out[kname] = {"max_abs_err": errs[("lm", f32)][kname]["err"],
                      "max_abs_err_bf16": errs[("lm", bf16)][kname]["err"],
                      "err_over_tolerance_bf16":
                          errs[("lm", bf16)][kname]["ratio"],
                      "beyond_one_step_bf16":
                          errs[("lm", bf16)][kname]["beyond_step"],
                      "routes": {"bfloat16": "tc_bf16", "float32": "simt",
                                 "bfloat16_d_above_256":
                                     launch_route(kname, True, 512),
                                 "float32_d_above_256":
                                     launch_route(kname, False, 512)},
                      "phase3_launches_by_name": {
                          n: c for n, c in by_name.items()
                          if n == kname or n.startswith(kname + "_")},
                      "control_err_over_tolerance": {
                          c: r[kname] for c, r in controls.items()
                          if kname in r},
                      **tm,
                      "d256": {**timed_256[kname],
                               "max_abs_err_bf16":
                                   errs[("d256", bf16)][kname]["err"],
                               "err_over_tolerance_bf16":
                                   errs[("d256", bf16)][kname]["ratio"],
                               "max_abs_err":
                                   errs[("d256", f32)][kname]["err"]},
                      "d512": {**timed_512[kname],
                               "route": launch_route(kname, True, 512),
                               "max_abs_err_bf16":
                                   errs[("d512", bf16)][kname]["err"],
                               "err_over_tolerance_bf16":
                                   errs[("d512", bf16)][kname]["ratio"],
                               "max_abs_err":
                                   errs[("d512", f32)][kname]["err"],
                               "err_over_tolerance_d1000_bf16":
                                   errs[("d1000", bf16)][kname]["ratio"],
                               "max_abs_err_d1000":
                                   errs[("d1000", f32)][kname]["err"],
                               "err_over_tolerance_d1152_bf16": max(
                                   errs[(c, bf16)][kname]["ratio"]
                                   for c in ("d1152", "d1100_seg")),
                               "max_abs_err_d1152": max(
                                   errs[(c, f32)][kname]["err"]
                                   for c in ("d1152", "d1100_seg")),
                               "control_err_over_tolerance": {
                                   c: r[kname]
                                   for c, r in controls_512.items()
                                   if kname in r},
                               "library_kernels": sdpa_512},
                      **({"d1024": timed_1024[kname],
                          "d2048": timed_2048[kname]}
                         if kname in timed_1024 else {})}
    log("  (plain_ms of flash_bwd_dq and flash_bwd_dkv is the one plain "
        "backward that computes dq, dk and dv; library_ms of both is SDPA's "
        "backward for all three: SDPA forward+backward less its forward)")
    return out


def serve(ptt, kernels):
    """Phase 4: the main path at full width. Returns (launch counts,
    engine, its weights, prompts and tokens for phases 25-28)."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    eng = ptt.ContinuousBatchingEngine(place=ptt.CUDAPlace(0), **SERVE)
    torch.cuda.synchronize()
    log(f"  engine built and initialized in {time.perf_counter() - t0:.2f} s"
        f" (KV caches {eng.stats()['kv_cache_bytes'] / 1e6:.1f} MB)")
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, SERVE["vocab"],
                           rng.randint(PROMPT_LO, PROMPT_HI + 1)).tolist()
               for _ in range(N_REQUESTS)]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, MAX_NEW) for p in prompts]
    done = eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    assert len(done) == N_REQUESTS and all(r.done for r in reqs), \
        "not every request completed"
    for r in reqs:
        assert len(r.tokens) == MAX_NEW, (r.rid, len(r.tokens))
        assert all(0 <= tok < SERVE["vocab"] for tok in r.tokens), r.rid
    # percentiles: the highest with at least ten samples beyond it
    ticks = np.asarray(eng.tick_seconds) * 1e3
    ttft = np.asarray([r.first_token_pc - r.submitted_pc for r in reqs])
    prompt_tokens = sum(len(p) for p in prompts)
    log(f"  served {N_REQUESTS} requests, {N_REQUESTS} completed, 0 failed "
        f"({prompt_tokens} prompt + {eng.tokens_out} generated tokens) in "
        f"{eng.n_ticks} ticks, {wall:.3f} s: "
        f"{eng.tokens_out / wall:.1f} generated tokens/s, "
        f"{(prompt_tokens + eng.tokens_out) / wall:.1f} tokens/s all")
    log(f"  tick (the gap between a slot's tokens): median "
        f"{np.median(ticks):.3f} ms, p95 {np.percentile(ticks, 95):.3f} ms "
        f"({len(ticks)} ticks); time to first token (all requests queued "
        f"at once): median {np.median(ttft):.3f} s, p75 "
        f"{np.percentile(ttft, 75):.3f} s ({len(ttft)} requests); "
        f"occupancy {eng.occupancy():.3f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB")
    log(f"  launches on the serving run: {launches}")
    expect = eng.n_ticks * SERVE["num_layers"]
    assert launches["decode_attention"] == expect, (
        f"decode_attention launched {launches['decode_attention']} times in "
        f"{eng.n_ticks} ticks; the path must launch it {expect} times")
    base = _snapshot(ptt, eng, prompts, reqs)
    base["generated_tokens_per_s"] = eng.tokens_out / wall
    return launches, eng, base


def _serve_stats(label, eng, reqs, wall, prompts):
    """Log phase 4's serving line for `eng`'s run of `reqs`; returns its
    numbers."""
    import numpy as np
    ticks = np.asarray(eng.tick_seconds) * 1e3
    ttft = np.asarray([r.first_token_pc - r.submitted_pc for r in reqs])
    gen = sum(len(r.tokens) for r in reqs)
    stats = {"requests": len(reqs), "generated_tokens": gen,
             "wall_s": wall, "generated_tokens_per_s": gen / wall,
             "ticks": eng.n_ticks,
             "tick_ms_median": float(np.median(ticks)),
             "tick_ms_p95": float(np.percentile(ticks, 95)),
             "ttft_s_median": float(np.median(ttft)),
             "ttft_s_p75": float(np.percentile(ttft, 75))}
    log(f"  [{label}] {len(reqs)} requests ({sum(len(p) for p in prompts)} "
        f"prompt + {gen} generated tokens) in {eng.n_ticks} ticks, "
        f"{wall:.3f} s: {stats['generated_tokens_per_s']:.1f} generated "
        f"tokens/s; tick median {stats['tick_ms_median']:.3f} ms, p95 "
        f"{stats['tick_ms_p95']:.3f} ms; time to first token median "
        f"{stats['ttft_s_median']:.3f} s, p75 {stats['ttft_s_p75']:.3f} s")
    return stats


def _run_requests(eng, prompts, max_new=None):
    """Submit every prompt at once, tick until idle; returns (requests,
    wall seconds). Every request must complete with max_new (default
    MAX_NEW) tokens."""
    import torch
    max_new = MAX_NEW if max_new is None else max_new
    eng.tick_seconds.clear()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new) for p in prompts]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        assert r.done and len(r.tokens) == max_new, (r.rid, len(r.tokens))
    return reqs, wall


def _snapshot(ptt, eng, prompts, reqs):
    """Phase 4's weights (numpy), prompts and tokens, for phases 25-28."""
    from paddle_tpu_torch.framework.executor import as_numpy
    return {"params": {p.name: as_numpy(eng.scope.get(p.name))
                       for p in eng._program.all_parameters()},
            "prompts": prompts, "tokens": [list(r.tokens) for r in reqs]}


def _fresh_scope(ptt, base):
    return ptt.load_numpy_params(base["params"], ptt.Scope(),
                                 ptt.CUDAPlace(0))


def _token_share(got, want):
    """(share of positions equal, share of first tokens equal)."""
    same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
    total = sum(len(w) for w in want)
    first = sum(g[:1] == w[:1] for g, w in zip(got, want))
    return same / total, first / len(want)


def _profile_serving(label, eng, warm=2, n=8):
    """Where a step of `eng` goes (phase 6's measure, without the per-op
    annotation): 16 fresh requests of 64 prompt and 64 new tokens keep
    every slot busy; after `warm` steps, `n` steps without the profiler
    (wall) and `n` under torch.profiler (wall, device busy, the idle share
    of that window, the top device kernels); then the engine drains.
    A step is a tick, or a round on a speculative engine."""
    import numpy as np
    import torch
    rng = np.random.RandomState(SEED + 6)
    length = min(64, SERVE["max_len"] // 4)
    for _ in range(SERVE["n_slots"]):
        eng.submit(rng.randint(0, SERVE["vocab"], length).tolist(), length)
    for _ in range(warm):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    wall_plain = (time.perf_counter() - t0) / n
    wall, events = _profile(eng.step, n, annotate=False)
    kern = device_kernels(events)
    busy_us = sum(dev_self(e) for e in kern)
    out = {"step_ms_no_profiler": wall_plain * 1e3,
           "step_ms_profiled": wall / n * 1e3,
           "device_busy_ms": busy_us / n / 1e3 if busy_us > 0 else None,
           "idle_share": 1 - busy_us / 1e6 / wall if busy_us > 0 else None,
           "top_kernels": [[e.key[:60], dev_self(e) / n / 1e3]
                           for e in sorted(kern, key=dev_self,
                                           reverse=True)[:5]]}
    busy = ("not measured (the profiler saw no device time)"
            if busy_us <= 0 else
            f"device busy {out['device_busy_ms']:.3f} ms, idle share "
            f"{out['idle_share']:.3f}")
    log(f"  [{label}] a step: {out['step_ms_no_profiler']:.3f} ms without "
        f"the profiler, {out['step_ms_profiled']:.3f} ms under it; {busy}")
    for name, ms in out["top_kernels"]:
        log(f"    device {ms * 1e3:8.1f} us/step  {name}")
    eng.run_until_idle()
    return out


def serve_paged(ptt, kernels, base):
    """Phase 25: PagedKVEngine at the serving width from phase 4's weights:
    phase 4's 48 prompts (their tokens must be phase 4's, token for
    token), then 16 requests sharing a 64-token prefix (one first, to fill
    the prefix cache, then 15 that must hit it), the pool checked after
    each, decode attention launched 6 times a tick; then paged_beam_search
    (beam 4, 8 new tokens) on 4 of the prompts."""
    import numpy as np
    import torch
    cuda = ptt.CUDAPlace(0)
    t0 = time.perf_counter()
    eng = ptt.PagedKVEngine(place=cuda, scope=_fresh_scope(ptt, base),
                            block_size=PAGED["block_size"],
                            topk_k=PAGED["beam"], **SERVE)
    torch.cuda.synchronize()
    log(f"  paged engine built in {time.perf_counter() - t0:.2f} s: "
        f"{eng.n_blocks} blocks of {eng.block_size} positions "
        f"({eng.stats()['kv_cache_bytes'] / 1e6:.1f} MB of pools), "
        f"{eng.blocks_per_req} a request at most")
    kernels.reset_launch_counts()
    reqs, wall = _run_requests(eng, base["prompts"])
    launches = dict(kernels.LAUNCHES)
    out = {"phase4_prompts": _serve_stats("paged, phase 4's prompts", eng,
                                          reqs, wall, base["prompts"])}
    got = [list(r.tokens) for r in reqs]
    bad = [i for i, (g, w) in enumerate(zip(got, base["tokens"])) if g != w]
    assert not bad, (f"paged tokens differ from phase 4's for requests "
                     f"{bad[:8]} (first: {got[bad[0]]} vs "
                     f"{base['tokens'][bad[0]]})")
    log(f"  all {len(reqs)} requests generated phase 4's tokens, token for "
        f"token")
    assert launches["decode_attention"] == eng.n_ticks * SERVE["num_layers"], \
        (launches["decode_attention"], eng.n_ticks)
    eng.pager.pool.check()

    rng = np.random.RandomState(SEED + 25)
    prefix = rng.randint(0, SERVE["vocab"], PAGED["shared_prefix"]).tolist()
    shared = [prefix + rng.randint(0, SERVE["vocab"],
                                   rng.randint(8, 33)).tolist()
              for _ in range(PAGED["shared"])]
    hits0 = eng.pager.prefix_hits
    kernels.reset_launch_counts()
    ticks0 = eng.n_ticks
    first, wall1 = _run_requests(eng, shared[:1])
    rest, wall2 = _run_requests(eng, shared[1:])
    n_ticks = eng.n_ticks - ticks0
    assert kernels.LAUNCHES["decode_attention"] == \
        n_ticks * SERVE["num_layers"]
    st = eng.pager.stats()
    hits = st["prefix_hits"] - hits0
    out["shared_prefix"] = _serve_stats(
        "paged, 16 requests on a 64-token prefix (1, then 15)", eng,
        first + rest, wall1 + wall2, shared)
    out["shared_prefix"].update(prefix_hits=hits,
                                blocks_used=st["blocks_used"],
                                blocks_cached=st["blocks_cached"])
    log(f"  prefix hits {hits} of {len(rest)}, blocks used "
        f"{st['blocks_used']} (cached {st['blocks_cached']}) of "
        f"{eng.n_blocks - 1}, {st['blocks_per_request']:.2f} private blocks "
        f"a request, evictions {st['evictions']}")
    assert hits >= len(rest), f"only {hits} prefix hits in {len(rest)}"
    eng.pager.pool.check()

    t0 = time.perf_counter()
    cow0 = eng.pager.cow_copies
    beams = []
    for p in base["prompts"][:PAGED["beam_prompts"]]:
        res = ptt.paged_beam_search(eng, p, max_new=PAGED["beam_new"],
                                    beam_size=PAGED["beam"])
        assert len(res) == PAGED["beam"] and all(
            len(toks) == PAGED["beam_new"] for toks, _ in res), res
        scores = [sc for _, sc in res]
        assert scores == sorted(scores, reverse=True) and all(
            math.isfinite(sc) for sc in scores), scores
        eng.pager.pool.check()
        beams.append(res)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cow = eng.pager.cow_copies - cow0
    log(f"  paged_beam_search: {len(beams)} prompts, beam "
        f"{PAGED['beam']}, {PAGED['beam_new']} new tokens, in {wall:.3f} s; "
        f"best scores {[round(b[0][1], 4) for b in beams]}; CoW copies "
        f"{cow}; the pool checked whole after each")
    out["beam_search"] = {"prompts": len(beams), "wall_s": wall,
                          "cow_copies": cow,
                          "best_scores": [b[0][1] for b in beams]}
    out["profile"] = _profile_serving("paged", eng)
    out["launches"] = launches
    st = eng.pager.stats()
    out["pager"] = {k: st[k] for k in ("blocks_used", "blocks_cached",
                                       "prefix_hits", "cow_copies",
                                       "evictions")}
    return out, got


def serve_quantized(ptt, kernels, base):
    """Phase 26: weight-quantized serving at the serving width from phase
    4's weights: quant="int8" and "int4" on the slot engine and
    PagedKVEngine(kv_quant=True), each over phase 4's 48 prompts, after
    phase 4's float32 engine again as this phase's baseline (its tokens
    must be phase 4's). Reports the freed bytes, tokens/s, the tick and
    each engine's share of tokens (and of first tokens) equal to phase
    4's, and profiles the float32 and int8 engines' steps. The JAX package states its
    int4 bound (every first token equals float32's) at its test size
    (tests/test_quant_serving.py:226-239), where the port is held to it
    on the CPU (tests/test_torch_quant_serving.py); at this width int4's
    weight error flips near-tied argmaxes of the random-weight model, so
    the share is reported here, as int8's identity is."""
    import torch
    cuda = ptt.CUDAPlace(0)
    out = {}
    for label, cls, kw in (
            # phase 4's engine again: the float32 baseline of this phase
            # and the next (host-bound ticks vary over a run)
            ("float32", ptt.ContinuousBatchingEngine, {}),
            ("int8", ptt.ContinuousBatchingEngine, {"quant": "int8"}),
            ("int4", ptt.ContinuousBatchingEngine, {"quant": "int4"}),
            ("kv_quant", ptt.PagedKVEngine,
             {"kv_quant": True, "block_size": PAGED["block_size"]})):
        eng = cls(place=cuda, scope=_fresh_scope(ptt, base), **kw, **SERVE)
        kernels.reset_launch_counts()
        reqs, wall = _run_requests(eng, base["prompts"])
        assert kernels.LAUNCHES["decode_attention"] == \
            eng.n_ticks * SERVE["num_layers"]
        stats = _serve_stats(label, eng, reqs, wall, base["prompts"])
        same, first = _token_share([r.tokens for r in reqs], base["tokens"])
        freed = eng.kv_quant_freed_bytes if label == "kv_quant" else \
            eng.quant_freed_bytes
        stats.update(freed_bytes=freed, share_equal_phase4=same,
                     first_token_share_equal_phase4=first)
        if label in ("float32", "int8"):
            stats["profile"] = _profile_serving(label, eng)
        if label == "float32":
            assert same == 1.0, "the float32 engine differs from phase 4"
            out[label] = stats
            del eng
            continue
        if label == "kv_quant":
            eng.pager.pool.check()
            stats["n_blocks"] = eng.n_blocks
            what = (f"{eng.n_blocks - 1} blocks at the float32 pools' "
                    f"bytes")
        else:
            stats.update(params_bytes_f32=eng.params_bytes_f32,
                         params_bytes_quantized=eng.params_bytes_quantized)
            what = (f"weights {eng.params_bytes_f32 / 1e6:.1f} -> "
                    f"{eng.params_bytes_quantized / 1e6:.1f} MB")
        log(f"  [{label}] freed {freed / 1e6:.2f} MB ({what}); tokens equal "
            f"to phase 4's: {same:.3f} of positions, {first:.3f} of first "
            f"tokens")
        out[label] = stats
        del eng
        torch.cuda.empty_cache()
    return out


def _target_margin(step, feeds, seq):
    """Feed `seq` through slot 0 of a plain tick position by position (the
    other slots idle) and return (argmax, top-1 minus top-2 logit) at its
    last position: the target's own decision there."""
    import torch
    for pos, tok in enumerate(seq):
        for a in feeds.values():
            a[:] = 0
        feeds["tick_tok"][0, 0] = tok
        feeds["tick_pos"][0, 0, 0] = float(pos)
        ids, logits = step.run(feeds)
    top = torch.topk(logits[0, 0].float(), 2)
    return int(ids[0, 0]), float(top.values[0] - top.values[1])


def serve_speculative(ptt, kernels, base):
    """Phase 27: SpecConfig(gamma=4, draft="int8") on the slot engine and on
    the paged engine (its pool checked every round), phase 4's weights
    and prompts. Greedy speculative tokens must be phase 4's (= phase
    25's); a divergence is allowed only where the target's top-2 logits at
    that position are closer than SPEC_MARGIN (the fc products at
    M = S·G and M = S round differently), printed with its margin, and no
    later token of that sequence is compared. decode_attention_multi
    launches 6 times a verify forward. The slot engine's round is
    profiled."""
    import torch
    cuda = ptt.CUDAPlace(0)
    margin_eng = ptt.ContinuousBatchingEngine(
        place=cuda, scope=_fresh_scope(ptt, base), **SERVE)
    feeds = {k: v.copy() for k, v in margin_eng._feeds.items()}
    margin_step = margin_eng._exe.prepare(
        margin_eng._program, feeds, [margin_eng._next_ids, LOGITS],
        margin_eng.scope)
    phase4 = None
    out = {}
    for label, cls, kw in (
            ("slot", ptt.ContinuousBatchingEngine, {}),
            ("paged", ptt.PagedKVEngine,
             {"block_size": PAGED["block_size"]})):
        os.environ["PTPU_SPEC_POOL_CHECK"] = "1" if label == "paged" else "0"
        try:
            eng = cls(place=cuda, scope=_fresh_scope(ptt, base),
                      speculative=ptt.SpecConfig(**SPEC), **kw, **SERVE)
        finally:
            os.environ.pop("PTPU_SPEC_POOL_CHECK", None)
        kernels.reset_launch_counts()
        reqs, wall = _run_requests(eng, base["prompts"])
        launches = dict(kernels.LAUNCHES)
        stats = _serve_stats(f"speculative, {label}", eng, reqs, wall,
                             base["prompts"])
        sp = eng.spec.stats()
        diverged = []
        for i, (r, want) in enumerate(zip(reqs, base["tokens"])):
            j = next((j for j, (a, b) in enumerate(zip(r.tokens, want))
                      if a != b), None)
            if j is None:
                continue
            prompt = base["prompts"][i]
            tok, margin = _target_margin(margin_step, feeds,
                                         prompt + want[:j])
            log(f"    request {i}: token {j} is {r.tokens[j]}, phase 4's "
                f"{want[j]} (the plain tick's argmax here: {tok}); the "
                f"target's top-2 margin {margin:.4g}")
            diverged.append({"request": i, "token": j, "margin": margin})
            assert margin < SPEC_MARGIN, (
                f"speculative token {j} of request {i} differs from the "
                f"target-only token where the target's top-2 margin is "
                f"{margin} >= {SPEC_MARGIN}")
        multi = launches["decode_attention_multi"]
        assert multi == sp["verify_forwards"] * SERVE["num_layers"], \
            (multi, sp["verify_forwards"])
        # every draft tick, verify forward and plain tick: once a layer
        assert launches["decode_attention"] == \
            (sp["draft_ticks"] + eng.target_forwards) * SERVE["num_layers"]
        if label == "paged":
            eng.pager.pool.check()
        per_forward = eng.tokens_out / max(eng.target_forwards, 1)
        log(f"  [speculative, {label}] {len(reqs) - len(diverged)} of "
            f"{len(reqs)} requests token-identical to phase 4's, "
            f"{len(diverged)} diverged at a near-tie; acceptance rate "
            f"{sp['acceptance_rate']:.3f} ({sp['draft_accepted']} of "
            f"{sp['draft_proposed']}), {sp['rounds']} rounds, "
            f"{sp['verify_forwards']} verify forwards, {sp['draft_ticks']} "
            f"draft ticks, tokens per target forward {per_forward:.3f}; "
            f"decode_attention_multi launches {multi}; draft weights "
            f"{sp['draft_param_bytes'] / 1e6:.1f} MB; rolled-back blocks "
            f"{sp['rolled_back_blocks']}")
        if label == "slot":     # a round's breakdown (the paged one's
            #                     device work is the same to 3%)
            stats["profile"] = _profile_serving(f"speculative, {label}",
                                                eng)
        stats.update(acceptance_rate=sp["acceptance_rate"],
                     tokens_per_target_forward=per_forward,
                     rounds=sp["rounds"],
                     verify_forwards=sp["verify_forwards"],
                     draft_ticks=sp["draft_ticks"],
                     launches_multi=multi, diverged=diverged,
                     rolled_back_blocks=sp["rolled_back_blocks"])
        out[label] = stats
        del eng
        torch.cuda.empty_cache()
    return out


def paged_quant_spec_reference_check(ptt):
    """Phase 28: phase 5's small model in float32, card against CPU from the
    same weights: the paged engine (and beam 3 over it), int8 and int4
    weights, int8 KV pools, and greedy speculative decoding on the slot
    engine (int8 draft) and the paged engine (int4 draft) generate
    identical tokens."""
    from paddle_tpu_torch.framework.executor import as_numpy
    small = dict(n_slots=4, vocab=97, max_len=32, d_model=64, d_inner=128,
                 num_heads=4, num_layers=2)
    prompts = [[(7 * i + j) % small["vocab"] for j in range(n)]
               for i, n in enumerate((3, 9, 1, 14, 6, 11))]
    prev = ptt.flags.get_flag("use_bf16_matmul")
    ptt.flags.set_flag("use_bf16_matmul", False)
    try:
        seed_eng = ptt.ContinuousBatchingEngine(
            place=ptt.CUDAPlace(0), scope=ptt.Scope(), **small)
        params = {p.name: as_numpy(seed_eng.scope.get(p.name))
                  for p in seed_eng._program.all_parameters()}
        configs = (
            ("paged", ptt.PagedKVEngine, dict(block_size=4, topk_k=3)),
            ("int8", ptt.ContinuousBatchingEngine, dict(quant="int8")),
            ("int4", ptt.ContinuousBatchingEngine, dict(quant="int4")),
            ("kv_quant", ptt.PagedKVEngine, dict(block_size=4,
                                                 kv_quant=True)),
            ("spec_slot", ptt.ContinuousBatchingEngine,
             dict(speculative=ptt.SpecConfig(gamma=4, draft="int8"))),
            ("spec_paged", ptt.PagedKVEngine,
             dict(block_size=4, speculative=ptt.SpecConfig(
                 gamma=3, draft="int4"))))
        done = {}
        for label, cls, kw in configs:
            toks = []
            for place in (ptt.CUDAPlace(0), ptt.CPUPlace()):
                eng = cls(place=place, scope=ptt.load_numpy_params(
                    params, ptt.Scope(), place), **kw, **small)
                reqs = [eng.submit(p, 8) for p in prompts]
                eng.run_until_idle()
                run = [r.tokens for r in reqs]
                if label == "paged":
                    run.append(ptt.paged_beam_search(eng, prompts[3], 5, 3))
                    eng.pager.pool.check()
                toks.append(run)
            card, cpu = toks
            if label == "paged":
                cb, pb = card.pop(), cpu.pop()
                assert [b[0] for b in cb] == [b[0] for b in pb], (cb, pb)
                assert all(abs(a[1] - b[1]) <= 1e-4 * abs(b[1]) + 1e-5
                           for a, b in zip(cb, pb)), (cb, pb)
            assert card == cpu, f"{label}: card {card} != CPU {cpu}"
            done[label] = True
            log(f"  small {label} engine, float32: card and CPU generate "
                f"identical tokens ({len(prompts)} requests"
                f"{', and beam 3 over one' if label == 'paged' else ''})")
    finally:
        ptt.flags.set_flag("use_bf16_matmul", prev)
    return done


def _mean(xs):
    return sum(xs) / len(xs) if xs else 0.0


def _server_run(ptt, srv, prompts):
    """Phase 29's server turn: 4 EngineClient connections on loopback, each
    pipelining a quarter of `prompts` (sent all at once, then read back in
    the engine's completion order). Returns (tokens by prompt, wall s)."""
    clients = [ptt.EngineClient(*srv.address)
               for _ in range(SERVER["clients"])]
    try:
        t0 = time.perf_counter()
        owner = {}
        for i, p in enumerate(prompts):
            c = clients[i % len(clients)]
            owner[(i % len(clients), c.send_gen(p, MAX_NEW,
                                                request_id=f"p{i}"))] = i
        got = [None] * len(prompts)
        for k, c in enumerate(clients):
            for _ in range(sum(1 for (j, _) in owner if j == k)):
                tag, tokens, _ = c.recv_done()
                got[owner[(k, tag)]] = tokens
        wall = time.perf_counter() - t0
    finally:
        for c in clients:
            c.close()
    return got, wall


def serve_server(ptt, kernels, base):
    """Phase 29: EngineServer(metrics_port=0) over phase 4's slot engine
    (its weights, rebuilt), 4 EngineClient connections each pipelining 12
    of phase 4's 48 prompts: every request must get phase 4's tokens.
    Tokens/s through the server beside an in-process engine of the same
    weights, timed in turns (in-process, server, server, in-process);
    decode attention launched 6 times a server tick; one /metrics scrape
    with the ptpu_engine_*, ptpu_memory_* and ptpu_ckpt_* families, one
    /healthz reading `serving`; then drain() must return True."""
    import torch
    cuda = ptt.CUDAPlace(0)
    local = ptt.ContinuousBatchingEngine(place=cuda,
                                         scope=_fresh_scope(ptt, base),
                                         **SERVE)
    served = ptt.ContinuousBatchingEngine(place=cuda,
                                          scope=_fresh_scope(ptt, base),
                                          **SERVE)
    prompts = base["prompts"]
    srv = ptt.EngineServer(served, metrics_port=0).start()
    out = {"in_process": [], "server": []}
    launches = None
    try:
        for turn in ("in_process", "server", "server", "in_process"):
            if turn == "in_process":
                reqs, wall = _run_requests(local, prompts)
                got = [list(r.tokens) for r in reqs]
            else:
                ticks0 = served.n_ticks
                kernels.reset_launch_counts()
                got, wall = _server_run(ptt, srv, prompts)
                torch.cuda.synchronize()
                n = kernels.LAUNCHES["decode_attention"]
                ticks = served.n_ticks - ticks0
                assert n == ticks * SERVE["num_layers"], (n, ticks)
                launches = n if launches is None else launches
            bad = [i for i, (g, w) in enumerate(zip(got, base["tokens"]))
                   if g != w]
            assert not bad, (f"{turn}: tokens differ from phase 4's for "
                             f"requests {bad[:8]}")
            gen = sum(len(g) for g in got)
            out[turn].append(gen / wall)
            log(f"  [{turn}] {len(prompts)} requests, {gen} generated "
                f"tokens in {wall:.3f} s: {gen / wall:.1f} generated "
                f"tokens/s; every request got phase 4's tokens")
        host, port = srv.metrics_address
        text = ptt.serving.scrape_metrics(host, port)
        fams = sorted(set(re.findall(r"^# TYPE (\S+) ", text, re.M)))
        for prefix in ("ptpu_engine_", "ptpu_memory_", "ptpu_ckpt_"):
            assert any(f.startswith(prefix) for f in fams), prefix
        health = ptt.serving.scrape_healthz(host, port)
        assert health["status"] == "serving", health["status"]
        log(f"  /metrics: {len(fams)} families "
            f"({sum(f.startswith('ptpu_engine_') for f in fams)} "
            f"ptpu_engine_*, "
            f"{sum(f.startswith('ptpu_memory_') for f in fams)} "
            f"ptpu_memory_*, "
            f"{sum(f.startswith('ptpu_ckpt_') for f in fams)} ptpu_ckpt_*); "
            f"/healthz status {health['status']}, "
            f"{health['engine']['ticks']} ticks, pending checkpoints "
            f"{health['checkpoints']['pending_async']}")
    finally:
        drained = srv.drain(timeout=60)
    assert drained, "EngineServer.drain() did not drain"
    stats = {"in_process_tokens_per_s": out["in_process"],
             "server_tokens_per_s": out["server"],
             "server_over_in_process": (_mean(out["server"])
                                        / _mean(out["in_process"])),
             "launches": launches, "metric_families": len(fams),
             "healthz_status": health["status"], "drained": drained}
    log(f"  server {_mean(out['server']):.1f} against in-process "
        f"{_mean(out['in_process']):.1f} generated tokens/s (x"
        f"{stats['server_over_in_process']:.3f}); drain() True")
    return stats


def _run_backlogged(eng, prompts):
    """Submit every prompt at once and step until idle, sampling after
    each step while requests still wait for admission: the admitted
    requests (`n_active`, suspended ones included) and the resident ones
    (those holding device blocks). Returns (requests, wall s, admitted
    samples, resident samples)."""
    import torch
    eng.tick_seconds.clear()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, MAX_NEW) for p in prompts]
    admitted, resident = [], []
    while eng.n_active or eng.n_pending:
        backlogged = eng.n_pending > 0
        eng.step()
        if backlogged:
            n = eng.n_active
            admitted.append(n)
            resident.append(n - len(getattr(eng, "_ht_queue", ())))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        assert r.done and len(r.tokens) == MAX_NEW, (r.rid, len(r.tokens))
    return reqs, wall, admitted, resident


def _pcie_link():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.current,"
         "pcie.link.width.current", "--format=csv"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[-1] if out.returncode == 0 \
        else f"not read ({out.stderr.strip()[:80]})"


def serve_two_tier(ptt, kernels, base, paged):
    """Phase 30: PagedKVEngine with blocks of 8 and n_blocks=65 (64 usable
    blocks, about four 128-token requests) on phase 4's weights and 48
    prompts, first device-only, then with the pinned host tier
    (HostTierConfig(host_blocks=256, prefetch_distance=2,
    rotate_quantum=8)). Both must give phase 25's tokens (= phase 4's);
    the two-tier byte census must be exact (d2h bytes = host evictions x
    a block's bytes, h2d the same with reloads) and check_two_tier()
    must pass. The result is what users feel, beside the device-only
    engine: mean resident requests under backlog (the tier must not
    lower it), generated tokens/s and time to first token. Admitted
    requests (suspended ones included) are a scheduler counter: two-tier
    admission fills the free slots, which checks that path and nothing
    more. Deleting the two-tier engine must give its device memory back
    (to within LEAK_SLACK_BYTES): the transfer stream keeps no staged
    tensor. Prints prefetch hits and misses, the d2h and h2d rates (the
    side stream's timing events) beside the PCIe link, the tick against
    phase 25's, and a profiled step's idle share. Then
    `two_tier_reference_check` and `two_tier_leak_control`."""
    import gc
    import torch
    from paddle_tpu_torch.framework import offload
    cuda = ptt.CUDAPlace(0)
    offload.reset_offload()
    kw = dict(block_size=PAGED["block_size"], n_blocks=TWO_TIER["n_blocks"],
              **SERVE)
    out = {}
    for label, tier in (("device_only", None),
                        ("two_tier", ptt.HostTierConfig(**HOST_TIER))):
        gc.collect()
        torch.cuda.synchronize()
        allocated_before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng = ptt.PagedKVEngine(place=cuda, scope=_fresh_scope(ptt, base),
                                host_tier=tier, **kw)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        kernels.reset_launch_counts()
        reqs, wall, admitted, resident = _run_backlogged(
            eng, base["prompts"])
        launches = kernels.LAUNCHES["decode_attention"]
        assert launches == eng.n_ticks * SERVE["num_layers"], \
            (launches, eng.n_ticks)
        got = [list(r.tokens) for r in reqs]
        bad = [i for i, (g, w) in enumerate(zip(got, base["tokens"]))
               if g != w]
        assert not bad, (f"{label}: tokens differ from phase 25's for "
                         f"requests {bad[:8]}")
        stats = _serve_stats(label, eng, reqs, wall, base["prompts"])
        stats.update(launches=launches, built_s=built,
                     admitted_under_backlog=_mean(admitted),
                     resident_under_backlog=_mean(resident),
                     pool_bytes=eng._kv_bytes_static)
        log(f"  [{label}] {eng.n_blocks - 1} blocks "
            f"({eng._kv_bytes_static / 2**20:.1f} MiB of pools): mean "
            f"admitted {stats['admitted_under_backlog']:.2f}, resident "
            f"{stats['resident_under_backlog']:.2f} requests under backlog "
            f"({len(admitted)} ticks); every request got phase 25's "
            f"tokens")
        if tier is not None:
            pager = eng.pager
            ht = pager.stats()["host_tier"]
            per = eng._ht_per_block_bytes
            pager.check_two_tier()
            assert ht["host_evictions"] > 0, "the host tier never spilled"
            assert eng.ht_d2h_bytes == ht["host_evictions"] * per
            assert eng.ht_h2d_bytes == ht["host_reloads"] * per
            assert pager.host_blocks_used == 0 and not eng._ht_queue
            eng._ht_stream.drain()
            eng._reap_host_frees()
            assert eng._ht_slab.n_free == HOST_TIER["host_blocks"]
            assert eng._ht_slab.pinned and eng._ht_slab.tensor.is_pinned()
            rates = eng._ht_stream.rates()
            link = _pcie_link()
            stats.update(host_tier=ht, per_block_bytes=per,
                         d2h_bytes=eng.ht_d2h_bytes,
                         h2d_bytes=eng.ht_h2d_bytes, rates=rates,
                         pcie_link=link,
                         slab_bytes=eng._ht_slab.tensor.numel())
            log(f"  host tier: {ht['host_evictions']} blocks spilled and "
                f"{ht['host_reloads']} reloaded, {per} bytes a block "
                f"(census exact: d2h {eng.ht_d2h_bytes} B, h2d "
                f"{eng.ht_h2d_bytes} B); prefetch hits "
                f"{ht['prefetch_hits']}, misses {ht['prefetch_misses']}; "
                f"check_two_tier passed; {stats['slab_bytes'] / 2**20:.0f} "
                f"MiB pinned")
            for d in ("d2h", "h2d"):
                r = rates[d]
                gbs = ("not measured" if r["gb_per_s"] is None
                       else f"{r['gb_per_s']:.2f} GB/s")
                log(f"  {d}: {r['bytes']} B in {r['seconds'] * 1e3:.3f} ms "
                    f"of side-stream copies: {gbs}")
            log(f"  PCIe link (gen, width): {link}")
            dev = out["device_only"]
            vs = {k: stats[k] / dev[k] for k in (
                "resident_under_backlog", "generated_tokens_per_s",
                "ttft_s_median", "admitted_under_backlog")}
            stats["over_device_only"] = vs
            log(f"  against the device-only engine: resident requests "
                f"under backlog x{vs['resident_under_backlog']:.3f}, "
                f"generated tokens/s x{vs['generated_tokens_per_s']:.3f}, "
                f"median time to first token "
                f"x{vs['ttft_s_median']:.3f}; tick median "
                f"{stats['tick_ms_median']:.3f} ms against phase 25's "
                f"{paged['phase4_prompts']['tick_ms_median']:.3f} ms")
            log(f"  scheduler counter: admitted requests (suspended "
                f"included) x{vs['admitted_under_backlog']:.2f} the "
                f"device-only engine's: two-tier admission fills free "
                f"slots, it adds no resident request")
            assert vs["resident_under_backlog"] >= 0.9, \
                (f"the host tier lowered resident concurrency: "
                 f"x{vs['resident_under_backlog']:.3f}")
            assert vs["admitted_under_backlog"] >= 1.5, \
                (f"two-tier admission did not fill the free slots: "
                 f"x{vs['admitted_under_backlog']:.2f}")
            stats["profile"] = _profile_serving("two-tier", eng)
            eng.run_until_idle()
        out[label] = stats
        del eng, reqs
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated() - allocated_before
        stats["device_bytes_left_after_delete"] = left
        log(f"  [{label}] deleting the engine leaves {left} B of device "
            f"memory allocated against before it was built")
        if tier is not None:
            assert left <= LEAK_SLACK_BYTES, \
                (f"the two-tier engine held {left} B on the card after "
                 f"it was deleted")
    out["small_reference"] = two_tier_reference_check(ptt)
    out["leak_control"] = two_tier_leak_control(ptt)
    return out


def two_tier_leak_control(ptt):
    """The control of phase 30's device-memory check: a small two-tier
    engine (phase 5's size, 9 blocks of 4 for 6 slots, so it spills) on
    the card whose transfer stream is made to keep every job's result,
    as it once kept its tickets. Deleting the engine must then leave at
    least the kept staged bytes allocated, and releasing them must give
    the memory back: the check sees what a kept tensor holds."""
    import gc
    import torch
    from paddle_tpu_torch.framework import offload
    cuda = ptt.CUDAPlace(0)
    small = dict(n_slots=6, vocab=97, max_len=32, d_model=64, d_inner=128,
                 num_heads=4, num_layers=2)
    prompts = [[(5 * i + j) % small["vocab"] for j in range(n)]
               for i, n in enumerate((3, 9, 1, 14, 6, 11, 7, 4))]
    stream = offload.shared_stream(cuda)
    kept = []

    def keeping(*a, **k):
        t = offload.TransferStream.submit(stream, *a, **k)
        kept.append(t.result)
        return t

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    stream.submit = keeping
    try:
        eng = ptt.PagedKVEngine(
            place=cuda, scope=ptt.Scope(), block_size=4, n_blocks=9,
            host_tier=ptt.HostTierConfig(host_blocks=64, prefetch_distance=2,
                                         rotate_quantum=4), **small)
        for p in prompts:
            eng.submit(p, 8)
        eng.run_until_idle()
        assert eng.pager.host_reloads > 0, "the control never reloaded"
    finally:
        del stream.submit
    del eng
    gc.collect()
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - before
    kept_bytes = sum(t.numel() * t.element_size() for t in kept
                     if isinstance(t, torch.Tensor))
    kept.clear()
    gc.collect()
    torch.cuda.synchronize()
    released = torch.cuda.memory_allocated() - before
    log(f"  leak control: a stream keeping its {kept_bytes} B of staged "
        f"reloads leaves {left} B allocated after the engine is deleted, "
        f"{released} B once they are released")
    assert 0 < kept_bytes <= left, (kept_bytes, left)
    assert released <= LEAK_SLACK_BYTES, released
    return {"kept_bytes": kept_bytes, "left_bytes": left,
            "released_bytes": released}


def two_tier_reference_check(ptt):
    """Phase 30's small check: two-tier engines (float32 and int8 pools)
    at phase 5's small size in float32 under pressure (9 blocks of 4 for
    6 slots), card against CPU from the same weights: identical tokens
    and the same spills and reloads (the scheduler is host logic); the
    card's side-stream copies move every pool's rows, the int8 pools'
    scales with their payloads."""
    from paddle_tpu_torch.framework.executor import as_numpy
    small = dict(n_slots=6, vocab=97, max_len=32, d_model=64, d_inner=128,
                 num_heads=4, num_layers=2)
    prompts = [[(5 * i + j) % small["vocab"] for j in range(n)]
               for i, n in enumerate((3, 9, 1, 14, 6, 11, 7, 4))]
    prev = ptt.flags.get_flag("use_bf16_matmul")
    ptt.flags.set_flag("use_bf16_matmul", False)
    out = {}
    try:
        seed_eng = ptt.ContinuousBatchingEngine(
            place=ptt.CUDAPlace(0), scope=ptt.Scope(), **small)
        params = {p.name: as_numpy(seed_eng.scope.get(p.name))
                  for p in seed_eng._program.all_parameters()}
        for kv_quant in (False, True):
            runs = []
            for place in (ptt.CUDAPlace(0), ptt.CPUPlace()):
                eng = ptt.PagedKVEngine(
                    place=place, kv_quant=kv_quant, block_size=4,
                    n_blocks=9, scope=ptt.load_numpy_params(
                        params, ptt.Scope(), place),
                    host_tier=ptt.HostTierConfig(
                        host_blocks=64, prefetch_distance=2,
                        rotate_quantum=4), **small)
                reqs = [eng.submit(p, 8) for p in prompts]
                eng.run_until_idle()
                eng.pager.check_two_tier()
                st = eng.pager.stats()["host_tier"]
                runs.append(([r.tokens for r in reqs],
                             st["host_evictions"], st["host_reloads"]))
            label = "int8 pools" if kv_quant else "float32 pools"
            assert runs[0] == runs[1], f"{label}: card {runs[0]} != CPU"
            assert runs[0][1] > 0, f"{label}: nothing spilled"
            out[label] = {"host_evictions": runs[0][1],
                          "host_reloads": runs[0][2]}
            log(f"  small two-tier engine, {label}, float32: card and CPU "
                f"generate identical tokens ({len(prompts)} requests), "
                f"{runs[0][1]} blocks spilled and {runs[0][2]} reloaded "
                f"on both")
    finally:
        ptt.flags.set_flag("use_bf16_matmul", prev)
    return out


def sanitize_and_trace(ptt, kernels, base):
    """Phase 31: phase 30's two-tier engine on 16 of phase 4's prompts
    with kv_sanitize on (the sanitizer attached at construction): zero
    divergences, ops mirrored, and phase 4's tokens. Then phase 4's slot
    engine for 20 ticks with trace on: aggregate() of the tick, dispatch
    and admission spans and the spans' cost per tick."""
    import torch
    from paddle_tpu_torch.observability import tracing
    cuda = ptt.CUDAPlace(0)
    n = SANITIZE["prompts"]
    prev = ptt.flags.get_flag("kv_sanitize")
    ptt.flags.set_flag("kv_sanitize", True)
    try:
        eng = ptt.PagedKVEngine(
            place=cuda, scope=_fresh_scope(ptt, base),
            host_tier=ptt.HostTierConfig(**HOST_TIER),
            block_size=PAGED["block_size"], n_blocks=TWO_TIER["n_blocks"],
            **SERVE)
    finally:
        ptt.flags.set_flag("kv_sanitize", prev)
    san = eng.pager.sanitizer
    assert san is not None, "kv_sanitize on, but no sanitizer attached"
    kernels.reset_launch_counts()
    reqs, wall = _run_requests(eng, base["prompts"][:n])
    launches = kernels.LAUNCHES["decode_attention"]
    assert launches == eng.n_ticks * SERVE["num_layers"], launches
    got = [list(r.tokens) for r in reqs]
    assert got == base["tokens"][:n], "sanitized tokens differ from phase 4"
    san.verify_full("phase 31")
    eng.pager.check_two_tier()
    sst = san.stats()
    ht = eng.pager.stats()["host_tier"]
    assert sst["ops_mirrored"] > 0 and sst["tables_live"] == 0, sst
    out = {"sanitizer": dict(sst, divergences=0, launches=launches,
                             ticks=eng.n_ticks, wall_s=wall,
                             host_evictions=ht["host_evictions"],
                             host_reloads=ht["host_reloads"])}
    log(f"  sanitized two-tier engine: {n} requests in {eng.n_ticks} ticks, "
        f"{wall:.3f} s; {sst['ops_mirrored']} ops mirrored, "
        f"{sst['full_checks']} full checks, 0 divergences; "
        f"{ht['host_evictions']} blocks spilled, {ht['host_reloads']} "
        f"reloaded; phase 4's tokens")
    del eng
    torch.cuda.empty_cache()

    eng = ptt.ContinuousBatchingEngine(place=cuda,
                                       scope=_fresh_scope(ptt, base),
                                       **SERVE)
    prev = ptt.flags.get_flag("trace")
    ptt.flags.set_flag("trace", True)
    try:
        for p in base["prompts"][:SERVE["n_slots"]]:
            eng.submit(p, MAX_NEW)
        for _ in range(2):
            eng.step()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        ticks0 = eng.n_ticks
        mark = tracing.mark()
        for _ in range(SANITIZE["trace_ticks"]):
            eng.step()
        torch.cuda.synchronize()
        spans = tracing.spans_since(mark)
        ticks = eng.n_ticks - ticks0
        launches_trace = kernels.LAUNCHES["decode_attention"]
        assert launches_trace == ticks * SERVE["num_layers"]
        agg = tracing.aggregate(spans)
        per_span = tracing.span_overhead_s()
        eng.run_until_idle()
    finally:
        ptt.flags.set_flag("trace", prev)
    per_tick = len(spans) / ticks
    rows = {k: agg[k] for k in ("engine/tick", "engine/dispatch",
                                "engine/admit")}
    for k, r in rows.items():
        log(f"  span {k}: {r['calls']} calls, mean {r['avg_ms']:.3f} ms, "
            f"max {r['max_ms']:.3f} ms")
    overhead = per_tick * per_span
    log(f"  {len(spans)} spans in {ticks} ticks ({per_tick:.1f} a tick); a "
        f"span costs {per_span * 1e6:.2f} us on the host here, so "
        f"{overhead * 1e6:.1f} us a tick, "
        f"{overhead / (rows['engine/tick']['avg_ms'] / 1e3):.4f} of the "
        f"tick span's mean")
    out["tracing"] = {"ticks": ticks, "spans": len(spans),
                      "spans_per_tick": per_tick,
                      "span_cost_us": per_span * 1e6,
                      "overhead_us_per_tick": overhead * 1e6,
                      "aggregate": rows, "launches": launches_trace}
    return out


def reference_check(ptt):
    """Phase 5: small width, float32, card vs CPU from the same weights:
    identical tokens."""
    from paddle_tpu_torch.framework.executor import as_numpy
    small = dict(n_slots=4, vocab=97, max_len=32, d_model=64, d_inner=128,
                 num_heads=4, num_layers=2)
    prev = ptt.flags.get_flag("use_bf16_matmul")
    ptt.flags.set_flag("use_bf16_matmul", False)
    try:
        gpu = ptt.ContinuousBatchingEngine(place=ptt.CUDAPlace(0),
                                           scope=ptt.Scope(), **small)
        params = {p.name: as_numpy(gpu.scope.get(p.name))
                  for p in gpu._program.all_parameters()}
        cpu = ptt.ContinuousBatchingEngine(
            place=ptt.CPUPlace(),
            scope=ptt.load_numpy_params(params, ptt.Scope(), ptt.CPUPlace()),
            **small)
        prompts = [[(7 * i + j) % small["vocab"] for j in range(n)]
                   for i, n in enumerate((3, 9, 1, 14, 6, 11))]
        g = [gpu.submit(p, 8) for p in prompts]
        c = [cpu.submit(p, 8) for p in prompts]
        gpu.run_until_idle()
        cpu.run_until_idle()
    finally:
        ptt.flags.set_flag("use_bf16_matmul", prev)
    gt, ct = [r.tokens for r in g], [r.tokens for r in c]
    assert gt == ct, f"card tokens {gt} != CPU tokens {ct}"
    log(f"  small engine, float32: card and CPU generate identical tokens "
        f"({len(prompts)} requests, {gpu.n_ticks} ticks)")


def _profile(step, n, annotate, cpu=None):
    """torch.profiler over `n` calls of `step`; with `annotate`, each op
    lowering runs inside a record_function named by its op type. The
    host's operators are recorded only with `cpu` (default: `annotate`):
    a run read for its device kernels alone records those, which cuts
    the profiler's processing on the host several times over (tens of
    seconds for a generator's call). A profiler that returns no kernel
    that way is run again with the host's operators."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from paddle_tpu_torch.framework import lowering

    cpu = annotate if cpu is None else cpu

    run_op = lowering.run_op

    def named_run_op(op, env, ctx):
        with record_function(op.type):
            run_op(op, env, ctx)

    if annotate:
        lowering.run_op = named_run_op
    try:
        torch.cuda.synchronize()
        activities = [ProfilerActivity.CUDA]
        if cpu:
            activities.insert(0, ProfilerActivity.CPU)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        lowering.run_op = run_op
    events = prof.key_averages()
    if not cpu and not device_kernels(events):
        return _profile(step, n, annotate, cpu=True)
    return wall, events


def dev_self(e):
    """A profiler event's own device time (us)."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0)) or 0


def dev_total(e):
    """A profiler event's device time with its children's (us): for an
    op lowering's annotation, the kernels it launched."""
    return getattr(e, "device_time_total",
                   getattr(e, "cuda_time_total", 0)) or 0


def device_kernels(events):
    """The profiled device kernels: CUDA events with device time, less the
    record_function annotations the profiler mirrors onto the device
    timeline (their time is their kernels', counted already)."""
    from torch.autograd import DeviceType
    return [e for e in events if e.device_type == DeviceType.CUDA
            and dev_self(e) > 0 and not getattr(e, "is_user_annotation",
                                                False)
            and e.key not in ("vjp_region/forward", "vjp_region/backward")]


def profile_ticks(eng, warm=8, n=32, n_annotated=8):
    """Phase 6: torch.profiler over steady-state ticks of the serving
    engine (16 fresh requests keep every slot busy throughout): the same
    number of ticks without the profiler (wall only), one profile as it
    runs (wall, device busy and the idle share of that window, top
    kernels), one with the op lowerings annotated over `n_annotated`
    ticks (host time per op type; the annotations add host cost, so read
    those as shares)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    rng = np.random.RandomState(SEED + 1)
    for _ in range(SERVE["n_slots"]):
        eng.submit(rng.randint(0, SERVE["vocab"], 64).tolist(), 64)
    for _ in range(warm):
        eng.step()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    log(f"  {n} steady-state ticks, no profiler: wall "
        f"{(time.perf_counter() - t0) / n * 1e3:.3f} ms/tick")
    wall, events = _profile(eng.step, n, annotate=False)
    kernels_ = device_kernels(events)
    busy_us = sum(dev_self(e) for e in kernels_)
    log(f"  {n} ticks under the profiler: wall {wall / n * 1e3:.3f} "
        f"ms/tick")
    if busy_us <= 0:
        log("  the profiler saw no device time: device busy share not "
            "measured")
    else:
        log(f"  device busy {busy_us / n / 1e3:.3f} ms/tick "
            f"({len(kernels_)} distinct kernels), idle share of the "
            f"profiled window {1 - busy_us / 1e6 / wall:.3f}")
    for e in sorted(kernels_, key=dev_self, reverse=True)[:8]:
        log(f"    device {dev_self(e) / n:8.1f} us/tick {e.count / n:6.1f}"
            f" calls/tick  {e.key[:80]}")
    n = n_annotated
    wall, events = _profile(eng.step, n, annotate=True)
    op_types = {op.type for op in eng._step._plan.ops}
    host = [e for e in events
            if e.key in op_types and e.device_type == DeviceType.CPU]
    total = sum(e.cpu_time_total for e in host)
    log(f"  host time in op lowerings, annotated run of {n} ticks (wall "
        f"{wall / n * 1e3:.3f} ms/tick):")
    for e in sorted(host, key=lambda e: e.cpu_time_total, reverse=True):
        log(f"    host {e.cpu_time_total / n:8.1f} us/tick "
            f"{e.cpu_time_total / max(total, 1e-9):6.1%} "
            f"{e.count / n:5.1f} calls/tick  op {e.key}")
    eng.run_until_idle()


def _markov_tokens(rng, b, t, vocab):
    """tok[i+1] = (tok[i]*13 + 7 + eps) % vocab, eps in [0, 8): the repo's
    learnable LM data (a copy of tools/bench_breadth.py:176)."""
    import numpy as np
    toks = np.empty((b, t), np.int64)
    toks[:, 0] = rng.randint(0, vocab, (b,))
    for i in range(1, t):
        toks[:, i] = (toks[:, i - 1] * 13 + 7
                      + rng.randint(0, 8, (b,))) % vocab
    return toks


def _ragged_corpus(rng, n_seqs, t, vocab):
    """Lognormal lengths (median ~100) clipped to 32..t, random tokens: a
    copy of tools/bench_breadth.py:280 _ragged_corpus."""
    import numpy as np
    lengths = np.clip((np.exp(rng.randn(n_seqs) * 0.6 + 4.6)).astype(int),
                      32, t)
    return [rng.randint(1, vocab, (n,)).astype(np.int64) for n in lengths]


def _train_program(ptt, cfg, packed=False, dropout=0.0, mean_loss=False):
    """transformer_lm + Adam(lr).minimize(loss), as a user builds it."""
    from paddle_tpu_torch.models import transformer
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        loss, _ = transformer.transformer_lm(
            vocab=cfg["vocab"], max_len=cfg["max_len"],
            d_model=cfg["d_model"], d_inner=cfg["d_inner"],
            num_heads=cfg["num_heads"], num_layers=cfg["num_layers"],
            dropout=dropout, packed=packed, mean_loss=mean_loss)
        ptt.optimizer.Adam(learning_rate=cfg["lr"]).minimize(loss)
    return main, start, loss


FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# the bfloat16 tensor-core routes of K1-K3 (the LM trains in bfloat16), in
# FLASH's order
FLASH_TC = ("flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc")
# the wide-head route's counts (head dims above 256): the CUDA cores'
# kernels, then bfloat16 K1 and K2 on the tensor cores
FLASH_WIDE = ("flash_fwd_wide", "flash_bwd_dq_wide", "flash_bwd_dkv_wide",
              "flash_fwd_wide_tc", "flash_bwd_dq_wide_tc")


def _run_steps(exe, main, scope, loss, feeds, steps, kernels):
    """`steps` training steps through Executor.run (the loss fetched as
    numpy each step, so each step ends synchronized). Launch counts are
    zeroed just before and read just after. Returns (losses, step seconds,
    launches)."""
    import torch
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses, secs = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        out, = exe.run(main, feed=feeds[i % len(feeds)], fetch_list=[loss],
                       scope=scope)
        secs.append(time.perf_counter() - t0)
        losses.append(float(out))
    return losses, secs, dict(kernels.LAUNCHES)


def _report_steps(label, losses, secs, tokens, launches, layers, steps):
    import numpy as np
    import torch
    st = np.asarray(secs[1:]) * 1e3          # the first step plans
    log(f"  {label}: {steps} steps, {tokens} tokens/step: step time median "
        f"{np.median(st):.1f} ms, p95 {np.percentile(st, 95):.1f} ms (steps "
        f"2-{steps}; step 1 {secs[0] * 1e3:.1f} ms), "
        f"{tokens / (np.median(st) / 1e3):.0f} tokens/s; loss step 1 "
        f"{losses[0]:.4f}, step {steps} {losses[-1]:.4f}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e6:.1f} MB")
    log(f"  launches: {launches}")
    assert all(math.isfinite(x) for x in losses), f"{label}: loss {losses}"
    for k in FLASH + FLASH_TC:
        assert launches[k] == layers * steps, (
            f"{label}: {k} launched {launches[k]} times in {steps} steps; "
            f"the path must launch it {layers * steps} times")


def train(ptt, kernels):
    """Phase 7: the LM training step at full width. Returns (launches,
    trainer state for phase 10)."""
    import numpy as np
    import torch
    cfg = TRAIN
    rng = np.random.RandomState(SEED)
    b, t = cfg["batch"], cfg["max_len"]
    feeds = []
    for _ in range(TRAIN_BATCHES):
        toks = _markov_tokens(rng, b, t + 1, cfg["vocab"])
        feeds.append({"tokens": toks[:, :-1].copy(),
                      "tokens@SEQLEN": np.full((b,), t, "int32"),
                      "targets": toks[:, 1:].copy()})
    t0 = time.perf_counter()
    main, start, loss = _train_program(ptt, cfg)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CUDAPlace(0))
    exe.run(start, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    log(f"  built and initialized in {time.perf_counter() - t0:.2f} s: "
        f"{n_params / 1e6:.2f}M parameters")
    torch.cuda.reset_peak_memory_stats()
    losses, secs, launches = _run_steps(exe, main, scope, loss, feeds,
                                        TRAIN_STEPS, kernels)
    _report_steps("padded LM, Adam", losses, secs, b * t, launches,
                  cfg["num_layers"], TRAIN_STEPS)
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    return launches, (exe, main, scope, loss, feeds)


def train_packed(ptt, kernels):
    """Phase 8: the packed ragged corpus at full width."""
    import numpy as np
    import torch
    from paddle_tpu_torch.data import pack_lm_batch
    cfg = TRAIN
    rng = np.random.RandomState(SEED + 2)
    seqs = _ragged_corpus(rng, PACKED_SEQS, cfg["max_len"], cfg["vocab"])
    feed = pack_lm_batch(seqs, cfg["max_len"])
    main, start, loss = _train_program(ptt, cfg, packed=True)
    attn = [op for op in main.global_block().ops
            if op.type == "fused_attention"]
    assert attn and all(op.inputs.get("QSeg") for op in attn), \
        "the packed program's attention carries no segment ids"
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CUDAPlace(0))
    exe.run(start, scope=scope)
    torch.cuda.reset_peak_memory_stats()
    losses, secs, launches = _run_steps(exe, main, scope, loss, [feed],
                                        PACKED_STEPS, kernels)
    real = sum(len(s) - 1 for s in seqs)
    log(f"  {len(seqs)} sequences ({real} trainable tokens) packed into "
        f"{feed['tokens'].shape[0]} rows of {cfg['max_len']}")
    _report_steps("packed LM, Adam", losses, secs,
                  int(feed["tokens"].size), launches, cfg["num_layers"],
                  PACKED_STEPS)
    return launches


def train_reference_check(ptt):
    """Phase 9: small width, float32: the card and the CPU from the same
    weights take 3 Adam steps on the same batches. Losses agree within
    1e-5 relative; parameters within 1e-6 + 1e-5 |p|, except where a
    step's gradient is below 1e-5 in magnitude: Adam moves such an element
    by about lr * sign(g), and a sign set by rounding may differ, so there
    the bound is 2 * lr per step."""
    import numpy as np
    from paddle_tpu_torch.framework.executor import as_numpy
    cfg = dict(vocab=97, max_len=64, d_model=64, d_inner=128, num_heads=2,
               num_layers=2, lr=1e-3)
    steps, b = 3, 4
    prev = ptt.flags.get_flag("use_bf16_matmul")
    ptt.flags.set_flag("use_bf16_matmul", False)
    try:
        main, start, loss = _train_program(ptt, cfg)
        names = [p.name for p in main.all_parameters()]
        gpu_scope = ptt.Scope()
        gpu = ptt.Executor(ptt.CUDAPlace(0))
        gpu.run(start, scope=gpu_scope)
        state = {n: as_numpy(gpu_scope.get(n))
                 for n in gpu_scope.local_var_names()}
        cpu_scope = ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())
        cpu = ptt.Executor(ptt.CPUPlace())
        rng = np.random.RandomState(SEED + 3)
        fetch = [loss.name] + [n + "@GRAD" for n in names]
        small = {n: None for n in names}
        for i in range(steps):
            toks = _markov_tokens(rng, b, cfg["max_len"] + 1, cfg["vocab"])
            feed = {"tokens": toks[:, :-1].copy(),
                    "tokens@SEQLEN": np.array([64, 50, 33, 64], "int32"),
                    "targets": toks[:, 1:].copy()}
            g_out = gpu.run(main, feed=feed, fetch_list=fetch,
                            scope=gpu_scope)
            c_out = cpu.run(main, feed=feed, fetch_list=fetch,
                            scope=cpu_scope)
            np.testing.assert_allclose(g_out[0], c_out[0], rtol=1e-5,
                                       err_msg=f"loss, step {i + 1}")
            for n, gg, cg in zip(names, g_out[1:], c_out[1:]):
                np.testing.assert_allclose(
                    gg, cg, atol=1e-5 * max(1.0, float(np.abs(cg).max())),
                    err_msg=f"{n}@GRAD, step {i + 1}")
                tiny = np.abs(cg) < 1e-5
                small[n] = tiny if small[n] is None else small[n] | tiny
            log(f"  step {i + 1}: loss card {float(g_out[0]):.6f}, CPU "
                f"{float(c_out[0]):.6f}")
        worst = 0.0
        for n in names:
            gp, cp = as_numpy(gpu_scope.get(n)), as_numpy(cpu_scope.get(n))
            tol = np.where(small[n], 2 * cfg["lr"] * steps, 0.0) \
                + 1e-6 + 1e-5 * np.abs(cp)
            diff = np.abs(gp - cp)
            assert (diff <= tol).all(), (n, float(diff.max()))
            worst = max(worst, float(np.where(small[n], 0, diff).max()))
    finally:
        ptt.flags.set_flag("use_bf16_matmul", prev)
    log(f"  small LM, float32, {steps} Adam steps: losses, gradients and "
        f"{len(names)} parameters agree (largest parameter difference "
        f"away from tiny gradients {worst:.2e})")


def profile_train(trainer, warm=2, n=3, n_annotated=1):
    """Phase 10: where a training step's time goes — torch.profiler over
    steady-state steps of the phase-7 trainer, as phase 6 does for
    ticks (the annotated run over `n_annotated` steps)."""
    import torch
    from torch.autograd import DeviceType
    exe, main, scope, loss, feeds = trainer
    it = iter(range(10 ** 9))

    def step():
        exe.run(main, feed=feeds[next(it) % len(feeds)], fetch_list=[loss],
                scope=scope)

    for _ in range(warm):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    log(f"  {n} steady-state steps, no profiler: wall "
        f"{(time.perf_counter() - t0) / n * 1e3:.1f} ms/step")
    wall, events = _profile(step, n, annotate=False)
    kernels_ = device_kernels(events)
    busy_us = sum(dev_self(e) for e in kernels_)
    log(f"  {n} steps under the profiler: wall {wall / n * 1e3:.1f} ms/step")
    if busy_us <= 0:
        log("  the profiler saw no device time: device busy share not "
            "measured")
    else:
        log(f"  device busy {busy_us / n / 1e3:.1f} ms/step "
            f"({len(kernels_)} distinct kernels), idle share of the "
            f"profiled window {1 - busy_us / 1e6 / wall:.3f}")
    top = sorted(kernels_, key=dev_self, reverse=True)[:12]
    for e in top:
        log(f"    device {dev_self(e) / n / 1e3:8.2f} ms/step "
            f"{e.count / n:6.1f} calls/step  {e.key[:80]}")
    summary = {"wall_ms": wall / n * 1e3,
               "device_busy_ms": busy_us / n / 1e3 if busy_us > 0 else None,
               "idle_share": 1 - busy_us / 1e6 / wall if busy_us > 0
               else None,
               "top_kernels": [[e.key[:60], dev_self(e) / n / 1e3]
                               for e in top[:6]]}
    n = n_annotated
    wall, events = _profile(step, n, annotate=True)
    op_types = {op.type for op in main.global_block().ops}
    regions = {"vjp_region/forward", "vjp_region/backward"}
    host = [e for e in events if (e.key in op_types or e.key in regions)
            and e.device_type == DeviceType.CPU]
    log(f"  host and device time per op type, annotated run of {n} "
        f"step(s) (wall {wall / n * 1e3:.1f} ms/step; vjp_region/forward "
        f"holds the "
        f"forward ops below it, vjp_region/backward is autograd's "
        f"backward; an op's device time is its kernels' in the forward):")
    for e in sorted(host, key=lambda e: e.cpu_time_total, reverse=True):
        log(f"    host {e.cpu_time_total / n / 1e3:8.2f} ms/step, device "
            f"{dev_total(e) / n / 1e3:8.2f} ms/step {e.count / n:6.1f} "
            f"calls/step  {e.key}")
    node = "autograd::engine::evaluate_function: "
    bwd = [e for e in events if e.key.startswith(node) and dev_total(e) > 0]
    log("  device time of autograd's backward by node:")
    for e in sorted(bwd, key=dev_total, reverse=True)[:8]:
        log(f"    device {dev_total(e) / n / 1e3:8.2f} ms/step "
            f"{e.count / n:6.1f} calls/step  {e.key[len(node):]}")
    return summary


def _lstm_program(ptt, cfg):
    """stacked_lstm_net + Adam(lr).minimize(loss), as a user builds it."""
    from paddle_tpu_torch.models import stacked_lstm
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        loss, _, _ = stacked_lstm.stacked_lstm_net(
            dict_dim=cfg["dict_dim"], emb_dim=cfg["emb_dim"],
            hid_dim=cfg["hid_dim"], stacked_num=cfg["stacked_num"],
            max_len=cfg["max_len"])
        ptt.optimizer.Adam(learning_rate=cfg["lr"]).minimize(loss)
    return main, start, loss


def _lstm_feeds(rng, cfg, n):
    """Token ids with lengths uniform in [len_lo, max_len] (padding id 0)
    and labels = the parity of the token sum (tools/bench_breadth.py:
    156-173)."""
    import numpy as np
    b, t = cfg["batch"], cfg["max_len"]
    feeds = []
    for _ in range(n):
        lens = rng.randint(cfg["len_lo"], t + 1, (b,))
        words = rng.randint(1, cfg["dict_dim"], (b, t)).astype("int64")
        words[np.arange(t)[None, :] >= lens[:, None]] = 0
        feeds.append({"words": words, "words@SEQLEN": lens.astype("int32"),
                      "label": (words.sum(1, keepdims=True) % 2)
                      .astype("int64")})
    return feeds


def _nmt_program(ptt, cfg):
    """machine_translation.train_net + Adam(lr).minimize(loss)."""
    from paddle_tpu_torch.models import machine_translation as mt
    L = ptt.layers
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        src = L.data("src", shape=[cfg["src_len"]], dtype="int64")
        src_lens = L.data("src_lens", shape=[], dtype="int64")
        tgt_in = L.data("tgt_in", shape=[cfg["tgt_len"]], dtype="int64")
        tgt_out = L.data("tgt_out", shape=[cfg["tgt_len"]], dtype="int64")
        tgt_mask = L.data("tgt_mask", shape=[cfg["tgt_len"]],
                          dtype="float32")
        loss, _ = mt.train_net(src, src_lens, tgt_in, tgt_out, tgt_mask,
                               dict_size=cfg["dict_size"],
                               embed_dim=cfg["embed_dim"],
                               hidden_dim=cfg["hidden_dim"])
        ptt.optimizer.Adam(learning_rate=cfg["lr"]).minimize(loss)
    return main, start, loss


def _nmt_feeds(rng, cfg, n):
    """A copy task (≙ tests/test_machine_translation.py _toy_batch): source
    ids of lengths uniform in [src_lo, src_len], the target the source's
    tokens then end-of-sequence (id 1, bos 0), the mask over the target's
    length."""
    import numpy as np
    b, ts, tt, v = cfg["batch"], cfg["src_len"], cfg["tgt_len"], \
        cfg["dict_size"]
    feeds = []
    for _ in range(n):
        lens = rng.randint(cfg["src_lo"], ts + 1, (b,))
        src = rng.randint(2, v, (b, ts)).astype("int64")
        src[np.arange(ts)[None, :] >= lens[:, None]] = 0
        tlen = np.minimum(lens + 1, tt)
        tgt = np.zeros((b, tt), "int64")
        tgt[:, :tt - 1] = src[:, :tt - 1]
        tgt[np.arange(b), tlen - 1] = 1
        tgt_in = np.concatenate([np.zeros((b, 1), "int64"), tgt[:, :-1]], 1)
        feeds.append({"src": src, "src_lens": lens.astype("int64"),
                      "tgt_in": tgt_in, "tgt_out": tgt,
                      "tgt_mask": (np.arange(tt)[None, :] < tlen[:, None])
                      .astype("float32")})
    return feeds


def _train_recurrent(ptt, kernels, label, main, start, loss, feeds, steps,
                     units):
    """`steps` training steps of a recurrent model at full width on
    CUDAPlace(0), launch counts zeroed just before and read just after.
    `units` is what one step trains (examples or target tokens) for the
    rate. Returns (launches, trainer state)."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CUDAPlace(0))
    exe.run(start, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    log(f"  built and initialized in {time.perf_counter() - t0:.2f} s: "
        f"{n_params / 1e6:.2f}M parameters")
    torch.cuda.reset_peak_memory_stats()
    losses, secs, launches = _run_steps(exe, main, scope, loss, feeds,
                                        steps, kernels)
    st = np.asarray(secs[1:]) * 1e3          # the first step plans
    k = len(feeds)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    log(f"  {label}: {steps} steps, {units[1]} {units[0]}/step: step time "
        f"median {np.median(st):.1f} ms, p95 {np.percentile(st, 95):.1f} ms "
        f"(steps 2-{steps}; step 1 {secs[0] * 1e3:.1f} ms), "
        f"{units[1] / (np.median(st) / 1e3):.1f} {units[0]}/s; loss step 1 "
        f"{losses[0]:.4f}, step {steps} {losses[-1]:.4f} (mean over the "
        f"{k} batches: first pass {first:.4f}, last pass {last:.4f}); peak "
        f"device memory {torch.cuda.max_memory_allocated() / 1e6:.1f} MB")
    log(f"  launches: {launches}")
    assert all(math.isfinite(x) for x in losses), f"{label}: loss {losses}"
    assert last < first, f"{label}: the loss did not fall: {losses}"
    return launches, (exe, main, scope, loss, feeds)


def train_lstm(ptt, kernels):
    """Phase 11: the stacked LSTM classifier at full width."""
    import numpy as np
    cfg = LSTM
    main, start, loss = _lstm_program(ptt, cfg)
    types = [op.type for op in main.global_block().ops]
    assert types.count("dynamic_lstm") == cfg["stacked_num"], types
    feeds = _lstm_feeds(np.random.RandomState(SEED + 6), cfg, LSTM_BATCHES)
    launches, trainer = _train_recurrent(
        ptt, kernels, "stacked LSTM, Adam", main, start, loss, feeds,
        LSTM_STEPS, ("examples", cfg["batch"]))
    expect = {"lstm_seq": cfg["stacked_num"] * LSTM_STEPS, "gru_seq": 0,
              "decode_attention": 0}
    for k, n in expect.items():
        assert launches[k] == n, (f"stacked LSTM: {k} launched "
                                  f"{launches[k]} times in {LSTM_STEPS} "
                                  f"steps; the path launches it {n} times")
    return launches, trainer


def train_nmt(ptt, kernels):
    """Phase 12: the GRU-attention NMT model at full width."""
    import numpy as np
    cfg = NMT
    main, start, loss = _nmt_program(ptt, cfg)
    feeds = _nmt_feeds(np.random.RandomState(SEED + 7), cfg, NMT_BATCHES)
    tokens = int(sum(f["tgt_mask"].sum() for f in feeds) / len(feeds))
    launches, trainer = _train_recurrent(
        ptt, kernels, "GRU-attention NMT, Adam", main, start, loss, feeds,
        NMT_STEPS, ("target tokens", tokens))
    expect = {"gru_seq": NMT_STEPS, "lstm_seq": 0,
              "decode_attention": cfg["tgt_len"] * NMT_STEPS}
    for k, n in expect.items():
        assert launches[k] == n, (f"NMT: {k} launched {launches[k]} times "
                                  f"in {NMT_STEPS} steps; the path launches "
                                  f"it {n} times")
    return launches, trainer


RECURRENT_SMALL = {
    "stacked_lstm": (dict(dict_dim=300, emb_dim=16, hid_dim=16,
                          stacked_num=3, max_len=10, batch=4, len_lo=1,
                          lr=1e-2), _lstm_program, _lstm_feeds),
    "nmt": (dict(dict_size=50, embed_dim=16, hidden_dim=32, batch=4,
                 src_len=6, tgt_len=5, src_lo=1, lr=1e-2), _nmt_program,
            _nmt_feeds),
}


def recurrent_reference_check(ptt):
    """Phase 13: both recurrent models small, float32, on the card and on
    the CPU from the same weights, 3 Adam steps on the same batches:
    losses within 1e-5 relative; gradients, the NMT decoder's attention
    path included, within 1e-5 of the largest element's magnitude (or 1);
    parameters within 1e-6 + 1e-5 |p|, except where a step's gradient is
    below 1e-5 in magnitude (there Adam moves an element by about
    lr * sign(g), and a sign set by rounding may differ: 2 lr per
    step). Then a control: the NMT check once more with the decode-
    attention kernel's output cut from the graph on the card, as the port
    ran it before that kernel had a backward; the phase fails unless the
    check then rejects a gradient."""
    for label, (cfg, build, make_feeds) in RECURRENT_SMALL.items():
        _card_against_cpu(ptt, label, cfg, build, make_feeds)
    cfg, build, make_feeds = RECURRENT_SMALL["nmt"]
    try:
        with _decode_attention_without_backward():
            _card_against_cpu(ptt, "nmt (control)", cfg, build, make_feeds)
    except AssertionError as e:
        where = [ln for ln in str(e).splitlines() if "@GRAD" in ln]
        if not where:
            raise
        log(f"  control, the decode-attention kernel's output cut from the "
            f"graph on the card: the check rejects it ({where[0].strip()})")
    else:
        raise AssertionError("control: the NMT check passed with the "
                             "decode-attention kernel's output cut from the "
                             "graph; it cannot see a missing backward")


@contextlib.contextmanager
def _decode_attention_without_backward():
    """`fused_decode_attention` on CUDA tensors returns the kernel's output
    with no gradient function, as before the kernel had a backward; CPU
    tensors keep the differentiable plain version."""
    from paddle_tpu_torch.fusion import decode_attention as tda
    fn = tda._DecodeAttention

    class Cut:
        @staticmethod
        def apply(q4, k4, v4, bias4, scale, ks, vs):
            if not q4.is_cuda:
                return fn.apply(q4, k4, v4, bias4, scale, ks, vs)
            return tda.decode_attention_cuda(
                q4.contiguous(), k4.contiguous(), v4.contiguous(), bias4,
                scale, ks, vs).detach()

    tda._DecodeAttention = Cut
    try:
        yield
    finally:
        tda._DecodeAttention = fn


def _card_against_cpu(ptt, label, cfg, build, make_feeds, steps=3,
                      exact=(), resync=False, opt="Adam"):
    """One model of phase 13 (and phase 17): raises AssertionError where
    the card and the CPU disagree. Losses at rtol 1e-5, gradients at
    1e-5 of each one's largest element, parameters at 1e-6 + 1e-5 |p|
    except where the gradient an update applied (after any clipping and
    weight decay) was below 1e-5 in some step: there Adam moves an element
    by about lr * sign(g), or, near its epsilon, in proportion to g, so
    rounding-level differences of g move it by up to 2 * lr a step.
    With `resync`, the parameters are compared after every step and the
    CPU then continues from the card's state, so each step is compared
    from the same state (otherwise such a move changes the next step's
    forward, and the comparison measures that drift instead of the
    step). `exact` names state that must end equal (a step counter).
    Non-trainable parameters (batch_norm's running statistics) are held
    with the parameters, at 1e-6 + 1e-5 |p|. Returns the card's scope."""
    import numpy as np
    from paddle_tpu_torch.framework.executor import as_numpy
    main, start, loss = build(ptt, cfg)
    names = [p.name for p in main.all_parameters() if p.trainable]
    stats = [p.name for p in main.all_parameters() if not p.trainable]
    gpu_scope = ptt.Scope()
    gpu = ptt.Executor(ptt.CUDAPlace(0))
    gpu.run(start, scope=gpu_scope)

    def card_state():
        return {n: as_numpy(gpu_scope.get(n))
                for n in gpu_scope.local_var_names()}

    cpu_scope = ptt.load_numpy_params(card_state(), ptt.Scope(),
                                      ptt.CPUPlace())
    cpu = ptt.Executor(ptt.CPUPlace())
    # the gradient each update op applies: n@GRAD, or what gradient
    # clipping and weight decay made of it (Adam's tiny-gradient rule
    # below is about the applied one)
    applied = {op.outputs["ParamOut"][0]: op.inputs["Grad"][0]
               for op in main.global_block().ops if "ParamOut" in op.outputs}
    fetch = ([loss.name] + [n + "@GRAD" for n in names]
             + [applied[n] for n in names])
    small = {n: None for n in names}
    worst = 0.0

    def compare_params(n_steps):
        nonlocal worst
        for n in names:
            gp, cp = as_numpy(gpu_scope.get(n)), as_numpy(cpu_scope.get(n))
            tol = np.where(small[n], 2 * cfg["lr"] * n_steps, 0.0) \
                + 1e-6 + 1e-5 * np.abs(cp)
            diff = np.abs(gp - cp)
            assert (diff <= tol).all(), (label, n, float(diff.max()))
            worst = max(worst, float(np.where(small[n], 0, diff).max()))
        for n in stats:
            gp, cp = as_numpy(gpu_scope.get(n)), as_numpy(cpu_scope.get(n))
            diff = np.abs(gp - cp)
            assert (diff <= 1e-6 + 1e-5 * np.abs(cp)).all(), \
                (label, n, float(diff.max()))

    feeds = make_feeds(np.random.RandomState(SEED + 8), cfg, steps)
    for i, feed in enumerate(feeds):
        g_out = gpu.run(main, feed=feed, fetch_list=fetch,
                        scope=gpu_scope)
        c_out = cpu.run(main, feed=feed, fetch_list=fetch,
                        scope=cpu_scope)
        np.testing.assert_allclose(g_out[0], c_out[0], rtol=1e-5,
                                   err_msg=f"{label}: loss, step "
                                           f"{i + 1}")
        k = len(names)
        for n, gg, cg, ca in zip(names, g_out[1:k + 1], c_out[1:k + 1],
                                 c_out[k + 1:]):
            np.testing.assert_allclose(
                gg, cg, atol=1e-5 * max(1.0, float(np.abs(cg).max())),
                err_msg=f"{label}: {n}@GRAD, step {i + 1}")
            tiny = np.abs(ca) < 1e-5
            small[n] = tiny if small[n] is None else small[n] | tiny
        log(f"  {label} step {i + 1}: loss card {float(g_out[0]):.6f}, "
            f"CPU {float(c_out[0]):.6f}")
        if resync:
            compare_params(1)
            small = {n: None for n in names}
            cpu_scope = ptt.load_numpy_params(card_state(), cpu_scope,
                                              ptt.CPUPlace())
    if not resync:
        compare_params(steps)
    for n in exact:
        gv, cv = as_numpy(gpu_scope.get(n)), as_numpy(cpu_scope.get(n))
        assert np.array_equal(gv, cv), (label, n, gv, cv)
        log(f"  {label}: {n} card {gv.tolist()}, CPU {cv.tolist()}")
    log(f"  small {label}, float32, {steps} {opt} steps"
        + (" (each from the same state)" if resync else "")
        + f": losses, gradients, {len(names)} parameters"
        + (f" and {len(stats)} running statistics" if stats else "")
        + f" agree (largest parameter difference away from tiny gradients "
        f"{worst:.2e})")
    return gpu_scope


def profile_recurrent(trainers):
    """Phase 14: one profiled steady-state step of each recurrent trainer:
    wall, device busy, the idle share and the top device kernels."""
    import torch
    for label, (exe, main, scope, loss, feeds) in trainers.items():
        def step():
            exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        log(f"  {label}: one steady-state step, no profiler: wall "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        _profile_one(f"{label}: one step", step)


def _shift_copy_batch(rng, cfg):
    """One minibatch of the shift-copy task (tests/test_models.py:360-368:
    tgt token = (src token + 5) % V, teacher-forced behind a BOS) as
    (src, tgt, lbl) samples, lengths cfg["len_lo"]..max_len. The first
    sample has the full max_len: the program's shapes are static, and the
    DataFeeder pads a batch to its longest sequence."""
    import numpy as np
    b, t, v = cfg["batch"], cfg["max_len"], cfg["tgt_vocab"]
    lens = rng.randint(cfg["len_lo"], t + 1, b)
    lens[0] = t
    out = []
    for n in lens:
        src = rng.randint(2, min(cfg["src_vocab"], v), n).astype(np.int64)
        trans = (src + 5) % v
        tgt = np.concatenate([[BOS], trans[:-1]]).astype(np.int64)
        lbl = np.zeros(t, np.int64)
        lbl[:n] = trans
        out.append((src, tgt, lbl))
    return out


def _transformer_model(ptt, cfg, is_test=False, dropout=None):
    """models.transformer.transformer at `cfg`'s widths; returns (loss,
    logits)."""
    from paddle_tpu_torch.models import transformer
    return transformer.transformer(
        src_vocab=cfg["src_vocab"], tgt_vocab=cfg["tgt_vocab"],
        max_len=cfg["max_len"], d_model=cfg["d_model"],
        d_inner=cfg["d_inner"], num_heads=cfg["num_heads"],
        num_layers=cfg["num_layers"],
        dropout=cfg["dropout"] if dropout is None else dropout,
        is_test=is_test, label_smooth=cfg["label_smooth"])


def _transformer_trainer(ptt, cfg, checkpoint_dir):
    """Trainer over the encoder-decoder with the paper's Adam (§5.3: β1
    0.9, β2 0.98, ε 1e-9, noam_decay(d_model, warmup)), checkpointing
    every TRANSFORMER_CKPT_STEP steps, built under a fresh name
    generator so that its parameter and accumulator names are the same in
    every build (the resumed trainer's and the inference program's)."""
    def train_func():
        return _transformer_model(ptt, cfg)[0]

    def optimizer_func():
        lr = ptt.layers.noam_decay(cfg["d_model"], cfg["warmup"])
        return ptt.optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.98,
                                  epsilon=1e-9)

    with ptt.unique_name.guard():
        return ptt.Trainer(
            train_func, optimizer_func, place=ptt.CUDAPlace(0),
            checkpoint_config=ptt.CheckpointConfig(
                checkpoint_dir, max_num_checkpoints=3, epoch_interval=2,
                step_interval=TRANSFORMER_CKPT_STEP))


@contextlib.contextmanager
def _counted_dropout(stats):
    """Count the `dropout` op's lowerings (its launches: each is one mask
    draw and one multiply) into stats["calls"]; while stats["measure"] is
    set, also sum the masks drawn (on the device, no sync) for the keep
    fraction."""
    import torch
    from paddle_tpu_torch.framework import registry
    opdef = registry.lookup_op("dropout")
    base = opdef.lower

    def counted(ctx, ins, attrs):
        outs = base(ctx, ins, attrs)
        stats["calls"] += 1
        if stats["measure"]:
            m = outs["Mask"][0]
            stats["kept"] += m.sum(dtype=torch.float64)
            stats["n"] += m.numel()
        return outs

    opdef.lower = counted
    try:
        yield
    finally:
        opdef.lower = base


def train_transformer(ptt, kernels, root):
    """Phase 15: Transformer-base trained through Trainer at full width.
    Returns (numbers for the JSON line, trainer, feeds, batches)."""
    import shutil
    import numpy as np
    import torch
    cfg = TRANSFORMER
    rng = np.random.RandomState(SEED + 9)
    batches = [_shift_copy_batch(rng, cfg)
               for _ in range(TRANSFORMER_BATCHES)]
    held = _shift_copy_batch(rng, cfg)
    order = ["src", "tgt", "lbl"]

    def samples():
        for i in range(TRANSFORMER_STEPS):
            yield from batches[i % len(batches)]

    reader = ptt.data.batch(samples, cfg["batch"])
    ckpt = os.path.join(root, "checkpoints")
    preempted = os.path.join(root, "preempted")
    t0 = time.perf_counter()
    trainer = _transformer_trainer(ptt, cfg, ckpt)
    torch.cuda.synchronize()
    main = trainer.train_program
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    n_drop = sum(op.type == "dropout" for op in main.global_block().ops)
    persist = sorted(v.name for v in main.global_block().vars.values()
                     if v.persistable)
    log(f"  built and initialized in {time.perf_counter() - t0:.2f} s: "
        f"{n_params / 1e6:.2f}M parameters, {n_drop} dropout ops, "
        f"{len(persist)} persistables")
    dev = torch.device("cuda", 0)
    stats = {"calls": 0, "measure": False, "n": 0,
             "kept": torch.zeros((), dtype=torch.float64, device=dev)}
    losses, secs, tokens, snapshot, clock = [], [], [], {}, [0.0]
    lens = [int(sum(len(s[1]) for s in bt)) for bt in batches]

    def handler(ev):
        if isinstance(ev, ptt.BeginStepEvent):
            stats["measure"] = ev.step == 0
            if ev.step == TRANSFORMER_CKPT_STEP:
                # right after step 10's checkpoint: keep the directory as
                # a run preempted here would leave it, and the state
                shutil.copytree(ckpt, preempted)
                snapshot.update({n: trainer.scope.get(n).clone()
                                 for n in persist})
            torch.cuda.synchronize()
            clock[0] = time.perf_counter()
        elif isinstance(ev, ptt.EndStepEvent):
            # the loss is fetched as numpy: the step has finished
            secs.append(time.perf_counter() - clock[0])
            losses.append(float(ev.metrics[0]))
            tokens.append(lens[ev.step % len(batches)])

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with _counted_dropout(stats):
        trainer.train(1, handler, reader, order)
    launches = dict(kernels.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    keep = float(stats["kept"]) / max(stats["n"], 1)
    st = np.asarray(secs[1:]) * 1e3          # the first step plans
    k = len(batches)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    tok_s = float(np.sum(tokens[1:]) / np.sum(secs[1:]))
    log(f"  Transformer-base, Adam + noam, dropout {cfg['dropout']}, label "
        f"smoothing {cfg['label_smooth']}: {len(losses)} steps of "
        f"{cfg['batch']} pairs ({np.mean(tokens):.0f} target tokens a "
        f"step on average): step time median {np.median(st):.1f} ms, p95 "
        f"{np.percentile(st, 95):.1f} ms (steps 2-{len(losses)}; step 1 "
        f"{secs[0] * 1e3:.1f} ms), {tok_s:.0f} target tokens/s; loss step "
        f"1 {losses[0]:.4f}, step {len(losses)} {losses[-1]:.4f} (mean over "
        f"the {k} batches: first pass {first:.4f}, last pass {last:.4f}); "
        f"peak device memory {peak_mb:.1f} MB")
    log(f"  losses: {[round(x, 4) for x in losses]}")
    log(f"  dropout: {stats['calls']} launches ({n_drop} a step), keep "
        f"fraction {keep:.5f} over step 1's {stats['n']} mask elements "
        f"(expected {1 - cfg['dropout']}); launches {launches}")
    assert len(losses) == TRANSFORMER_STEPS, losses
    assert all(math.isfinite(x) for x in losses), f"loss {losses}"
    assert last < first, f"the loss did not fall: {losses}"
    assert stats["calls"] == n_drop * TRANSFORMER_STEPS, stats["calls"]
    p = cfg["dropout"]
    assert abs(keep - (1 - p)) < 4 * math.sqrt(p * (1 - p) / stats["n"]), \
        f"keep fraction {keep} is not 1 - {p} within 4 sigma"
    # attention-weight dropout takes the explicit softmax route in training
    assert launches["flash_fwd"] == 0, launches

    test_loss = trainer.test(lambda: iter([held]), order)
    log(f"  Trainer.test over one held batch: loss {test_loss[0]:.4f}")
    assert all(math.isfinite(x) for x in test_loss), test_loss

    serials = sorted(os.listdir(preempted))
    resumed = _transformer_trainer(ptt, cfg, preempted)
    ccfg = resumed.checkpoint_cfg
    log(f"  a new Trainer on the checkpoint dir of step "
        f"{TRANSFORMER_CKPT_STEP} ({serials}) resumes at epoch "
        f"{ccfg.epoch_id}, step {ccfg.step_id}")
    assert (ccfg.epoch_id, ccfg.step_id) == (0, TRANSFORMER_CKPT_STEP)
    differ = [n for n in persist
              if not torch.equal(resumed.scope.get(n), snapshot[n])]
    assert not differ, f"resumed state differs from the saved: {differ}"
    log(f"  all {len(persist)} persistables (parameters, Adam moments and "
        f"beta powers, the noam step counter "
        f"{int(resumed.scope.get('@LR_DECAY_COUNTER@1@'))}) bit-equal to "
        f"the state at the checkpoint")
    del resumed, snapshot
    torch.cuda.empty_cache()
    feeder = ptt.DataFeeder(order, program=main)
    feeds = [feeder.feed(bt) for bt in batches]
    numbers = {"target_tokens_per_s": tok_s,
               "step_ms_median": float(np.median(st)),
               "step_ms_p95": float(np.percentile(st, 95)),
               "loss_first": losses[0], "loss_last": losses[-1],
               "loss_first_pass": first, "loss_last_pass": last,
               "test_loss": float(test_loss[0]), "peak_mb": peak_mb,
               "dropout_launches": stats["calls"], "keep_fraction": keep,
               "resumed_step": ccfg.step_id}
    return numbers, trainer, feeds, held


def infer_transformer(ptt, kernels, trainer, held, root):
    """Phase 16: the trained weights served through Inferencer from
    save_inference_model's directory: the is_test program, whose attention
    is K1 on its bfloat16 tensor-core route."""
    import numpy as np
    import torch
    cfg = TRANSFORMER
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        _, logits = _transformer_model(ptt, cfg, is_test=True,
                                       dropout=cfg["dropout"])
    model_dir = os.path.join(root, "inference")
    ptt.io.save_inference_model(model_dir, ["src", "tgt"], [logits],
                                executor=trainer.exe, main_program=main,
                                scope=trainer.scope)
    inf = ptt.Inferencer(model_dir, place=ptt.CUDAPlace(0))
    feed = ptt.DataFeeder(["src", "tgt"], program=inf.program).feed(
        [(s, t) for s, t, _ in held])
    kernels.reset_launch_counts()
    out1 = inf.infer(feed, return_numpy=False)[0]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        out2 = inf.infer(feed, return_numpy=False)[0]
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    n_attn = 3 * cfg["num_layers"]
    log(f"  Inferencer on CUDAPlace(0): logits {tuple(out1.shape)} "
        f"{out1.dtype}, {np.median(secs) * 1e3:.1f} ms a batch of "
        f"{cfg['batch']} (median of 3); launches in one batch {launches}")
    assert tuple(out1.shape) == (cfg["batch"], cfg["max_len"],
                                 cfg["tgt_vocab"]), out1.shape
    assert bool(torch.isfinite(out1).all()), "non-finite logits"
    assert torch.equal(out1, out2), "two runs gave different logits"
    for kname in ("flash_fwd", "flash_fwd_tc"):
        assert launches[kname] == n_attn, (
            f"{kname} launched {launches[kname]} times; the inference "
            f"program attends {n_attn} times a batch")
    return {"flash_fwd_tc_launches": launches["flash_fwd_tc"],
            "infer_ms": float(np.median(secs)) * 1e3}


def transformer_reference_check(ptt):
    """Phase 17: the encoder-decoder small and in float32, card against
    CPU from the same weights: 3 Adam steps with the global-norm clip,
    L2 decay and noam_decay at dropout 0 (so K1-K3 in float32 on the
    training path, cross-attention included); then the dropout-0.1
    is_test inference program's logits."""
    import numpy as np
    from paddle_tpu_torch.framework.executor import as_numpy
    cfg = TRANSFORMER_SMALL

    def build(ptt, cfg):
        main, start = ptt.Program(), ptt.Program()
        with ptt.program_guard(main, start), ptt.unique_name.guard():
            loss, _ = _transformer_model(ptt, cfg, dropout=0.0)
            ptt.clip.set_gradient_clip(
                ptt.clip.GradientClipByGlobalNorm(1.0))
            lr = ptt.layers.noam_decay(cfg["d_model"], cfg["warmup"])
            ptt.optimizer.Adam(
                learning_rate=lr,
                regularization=ptt.regularizer.L2Decay(1e-4)).minimize(loss)
        return main, start, loss

    def make_feeds(rng, cfg, n):
        data = ptt.Program()
        with ptt.program_guard(data, ptt.Program()):
            slots = [ptt.layers.data(name, [cfg["max_len"]], "int64",
                                     lod_level=lod)
                     for name, lod in (("src", 1), ("tgt", 1), ("lbl", 0))]
        feeder = ptt.DataFeeder(slots)
        return [feeder.feed(_shift_copy_batch(rng, cfg)) for _ in range(n)]

    prev = ptt.flags.get_flag("use_bf16_matmul")
    ptt.flags.set_flag("use_bf16_matmul", False)
    try:
        gpu_scope = _card_against_cpu(ptt, "encoder-decoder", cfg, build,
                                      make_feeds, resync=True,
                                      exact=("@LR_DECAY_COUNTER@1@",))
        main, start = ptt.Program(), ptt.Program()
        with ptt.program_guard(main, start), ptt.unique_name.guard():
            _, logits = _transformer_model(ptt, cfg, is_test=True,
                                           dropout=0.1)
        names = [p.name for p in main.all_parameters()]
        params = {n: as_numpy(gpu_scope.get(n)) for n in names}
        feed = make_feeds(np.random.RandomState(SEED + 10), cfg, 1)[0]
        outs = []
        for place in (ptt.CUDAPlace(0), ptt.CPUPlace()):
            scope = ptt.load_numpy_params(params, ptt.Scope(), place)
            outs.append(ptt.Executor(place).run(
                main, feed=feed, fetch_list=[logits], scope=scope)[0])
    finally:
        ptt.flags.set_flag("use_bf16_matmul", prev)
    card, cpu = outs
    err = float(np.abs(card - cpu).max())
    tol = 1e-5 * max(1.0, float(np.abs(cpu).max()))
    log(f"  is_test program (dropout 0.1), float32: logits "
        f"{card.shape}, card against CPU max_abs_err {err:.3e} "
        f"(tolerance {tol:.1e})")
    assert np.isfinite(card).all() and err <= tol, (err, tol)
    return {"infer_max_abs_err": err}


def _staged_batches(batch, n, seed, image=224):
    """bench.py's `_staged_batches` (bench.py:83-103) in numpy: n distinct
    batches of 224x224x3 float32 images in [0, 1), each image's label (one
    of 1000) a global brightness offset of 0.3 * label / 1000, so that the
    task can be learned and the loss fall."""
    import numpy as np
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        label = rng.randint(0, 1000, (batch, 1)).astype("int64")
        img = (rng.rand(batch, image, image, 3) * 0.7
               + (label / 1000.0)[:, :, None, None] * 0.3).astype("float32")
        out.append({"img": img, "label": label})
    return out


def _resnet_program(ptt, cfg, is_test=False, use_bf16=True):
    """ResNet-50 as bench.py:57-76 builds it: (main, start, loss, logits).
    The names are the same in every build (a fresh name generator);
    `use_bf16=False` runs its convs in float32 (phase 47)."""
    from paddle_tpu_torch.models import resnet
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        img = ptt.layers.data(name="img", shape=[cfg["image"]] * 2 + [3],
                              staging_dtype="uint8")
        loss, _, logits = resnet.resnet_imagenet(
            img=img, depth=cfg["depth"], class_num=cfg["classes"],
            is_test=is_test, data_format="NHWC", use_bf16=use_bf16)
        if not is_test:
            ptt.optimizer.Momentum(learning_rate=cfg["lr"],
                                   momentum=cfg["momentum"]).minimize(loss)
    return main, start, loss, logits


def train_resnet(ptt, kernels):
    """Phase 19: ResNet-50 trained at full width, fed uint8 through the
    DevicePrefetcher. Returns (numbers for the JSON line, the trainer for
    phases 20 and 19's profile)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.data import feeder
    cfg = RESNET
    # cuDNN picks each conv's algorithm by timing them at its first call
    # (XLA's conv autotuning in the JAX package): step 1 holds that
    torch.backends.cudnn.benchmark = True
    t0 = time.perf_counter()
    main, start, loss, logits = _resnet_program(ptt, cfg)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CUDAPlace(0))
    dev = exe.device
    exe.run(start, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters()
                   if p.trainable)
    ops = main.global_block().ops
    n_conv = sum(op.type == "conv2d" for op in ops)
    n_bn = sum(op.type == "batch_norm" for op in ops)
    log(f"  built and initialized in {time.perf_counter() - t0:.2f} s: "
        f"{n_params / 1e6:.2f}M trainable parameters, {n_conv} conv2d, "
        f"{n_bn} batch_norm, {len(ops)} ops")
    t0 = time.perf_counter()
    source = _staged_batches(cfg["batch"], cfg["batches"], SEED,
                             cfg["image"])
    specs = feeder.staging_specs(main)
    # quantized once on the host, as a decoder hands uint8 images over;
    # the prefetcher's stage_batch then passes them as they are
    wire = [feeder.stage_batch(b, specs) for b in source]
    wire_mb = wire[0]["img"].nbytes / 1e6
    f32_mb = source[0]["img"].nbytes / 1e6
    pix_err = float(np.abs(wire[0]["img"] * np.float32(1 / 255.0)
                           - source[0]["img"]).max())
    log(f"  {cfg['batches']} distinct batches of {cfg['batch']} made and "
        f"quantized in {time.perf_counter() - t0:.2f} s; staging {specs}: "
        f"one batch's images {wire_mb:.1f} MB as uint8 against "
        f"{f32_mb:.1f} MB as float32; largest pixel change {pix_err:.3e} "
        f"(1/510 = {1 / 510:.3e})")
    assert pix_err <= 1 / 510 + 1e-6, pix_err

    def reader():
        for i in range(RESNET_STEPS):
            yield wire[i % len(wire)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, secs, fed = [], [], []
    t_loop = time.perf_counter()
    for feed in ptt.data.DevicePrefetcher(reader, capacity=2,
                                          place=ptt.CUDAPlace(0),
                                          staging=specs):
        fed.append((feed["img"].dtype, feed["img"].device))
        t0 = time.perf_counter()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        secs.append(time.perf_counter() - t0)
        losses.append(float(out))
    loop_s = time.perf_counter() - t_loop
    launches = dict(kernels.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    assert all(f == (torch.uint8, dev) for f in fed), fed
    st = np.asarray(secs[1:]) * 1e3
    imgs_s = cfg["batch"] / (np.median(st) / 1e3)
    k = cfg["batches"]
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    log(f"  ResNet-50, NHWC, bf16, Momentum({cfg['lr']}, "
        f"{cfg['momentum']}), batch {cfg['batch']}: {len(losses)} steps, "
        f"each batch on the card as {fed[0][0]} ({fed[0][1]}); step median "
        f"{np.median(st):.1f} ms, p95 {np.percentile(st, 95):.1f} ms "
        f"(steps 2-{len(losses)}; step 1, with cuDNN's autotuning, "
        f"{secs[0] * 1e3:.1f} ms): {imgs_s:.1f} images/s over the median "
        f"step, {cfg['batch'] * (len(losses) - 1) / (loop_s - secs[0]):.1f}"
        f" images/s over the loop's wall after step 1; peak device memory "
        f"{peak_mb:.1f} MB")
    log(f"  loss step 1 {losses[0]:.4f}, step {len(losses)} "
        f"{losses[-1]:.4f}; mean over the first {k} steps {first:.4f}, "
        f"over the last {k} {last:.4f}")
    log(f"  losses: {[round(x, 4) for x in losses]}")
    log(f"  launches of K1-K6 on this path (none expected): {launches}")
    assert all(math.isfinite(x) for x in losses), f"loss {losses}"
    assert last < first, f"the loss did not fall: {losses}"

    # staging on the card: the training forward (batch statistics) from
    # the same state, each run on its own copy of it. (a) On the uint8
    # batch and on uint8 · float32(1/255) made on the host: the card's
    # cast and scale are that multiply, so the losses are equal. (b) On
    # the uint8 batch and on its float32 source: each pixel moves by at
    # most 1/510, below a bfloat16 activation's own rounding (2^-9 of
    # it), so the losses may differ by what two bfloat16 forwards of
    # nearly equal inputs differ by, held at 1% of the loss
    fwd = main.prune([loss])

    def forward(feed):
        copy = ptt.Scope()
        for n in scope.local_var_names():
            copy.set_var(n, scope.get(n).clone())
        return float(exe.run(fwd, feed=feed, fetch_list=[loss],
                             scope=copy)[0])

    dequant = dict(wire[0], img=wire[0]["img"].astype("float32")
                   * np.float32(1 / 255.0))
    u8, host, f32 = (forward(f) for f in (wire[0], dequant, source[0]))
    pair = [u8, f32]
    log(f"  one forward from the trained state: loss on the uint8 batch "
        f"{u8:.6f}, on uint8 * float32(1/255) made on the host {host:.6f}, "
        f"on the float32 source {f32:.6f} (difference {abs(u8 - f32):.2e}, "
        f"tolerance {0.01 * abs(f32):.2e})")
    assert u8 == host, (u8, host)
    assert math.isfinite(u8) and abs(u8 - f32) <= 0.01 * abs(f32), pair
    numbers = {"images_per_s": float(imgs_s),
               "step_ms_median": float(np.median(st)),
               "step_ms_p95": float(np.percentile(st, 95)),
               "step1_ms": secs[0] * 1e3, "loss_first": losses[0],
               "loss_last": losses[-1], "loss_first_8": first,
               "loss_last_8": last, "peak_mb": peak_mb,
               "staged_batch_mb": wire_mb, "float32_batch_mb": f32_mb,
               "staging_loss_pair": pair}
    dev_feeds = [{k_: torch.from_numpy(v).to(dev) for k_, v in w.items()}
                 for w in wire[:3]]
    return numbers, (exe, main, scope, loss, logits, dev_feeds, source[0])


def infer_resnet(ptt, trained, root):
    """Phase 20: the trained ResNet-50 saved with save_inference_model,
    loaded back and served through Inferencer at batch 16; its top-1
    against the trained program's is_test clone on the same batch."""
    import numpy as np
    import torch
    cfg = RESNET
    exe, main, scope, _, logits, _, source = trained
    imain, _, _, ilogits = _resnet_program(ptt, cfg, is_test=True)
    model_dir = os.path.join(root, "resnet50_inference")
    ptt.io.save_inference_model(model_dir, ["img"], [ilogits],
                                executor=exe, main_program=imain,
                                scope=scope)
    inf = ptt.Inferencer(model_dir, place=ptt.CUDAPlace(0))
    # the saved program carries no staging spec (as in the JAX package):
    # it is fed float32
    feed = {"img": source["img"][:cfg["infer_batch"]]}
    out = inf.infer(feed, return_numpy=False)[0]
    secs = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inf.infer(feed, return_numpy=False)[0]
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    clone = main.prune([logits]).clone(for_test=True)
    ref = exe.run(clone, feed=feed, fetch_list=[logits], scope=scope,
                  return_numpy=False)[0]
    top1, ref1 = out.float().argmax(-1), ref.float().argmax(-1)
    ms = float(np.median(secs)) * 1e3
    log(f"  Inferencer on CUDAPlace(0): logits {tuple(out.shape)} "
        f"{out.dtype}, {ms:.2f} ms a batch of {cfg['infer_batch']} "
        f"(median of 10, {cfg['infer_batch'] / ms * 1e3:.1f} images/s); "
        f"top-1 {top1.tolist()}; the is_test clone's {ref1.tolist()}")
    assert tuple(out.shape) == (cfg["infer_batch"], cfg["classes"])
    assert bool(torch.isfinite(out.float()).all()), "non-finite logits"
    assert torch.equal(top1, ref1), "top-1 differs from the is_test clone"
    return {"infer_ms": ms, "images_per_s": cfg["infer_batch"] / ms * 1e3}


def _no_dropout(program):
    """Dropout 0 in `program`: the card and the CPU draw different masks."""
    for op in program.global_block().ops:
        if op.type == "dropout":
            op.attrs["dropout_prob"] = 0.0


def _cosine(a, b):
    import numpy as np
    a, b = a.ravel().astype("float64"), b.ravel().astype("float64")
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


def se_resnext_step_check(ptt):
    """Phase 21, second half: one Momentum step of se_resnext_imagenet
    (grouped 3x3 convs, the SE gate) at 64x64 in float32, card against
    CPU from the card's initial state. Like the CPU test against the JAX
    package: the loss at rtol 1e-4, the BN running statistics at 1e-3 of
    each one's largest magnitude, each gradient at a cosine of at least
    0.99 and a norm within 2% (gradients below 1e-5 of the largest are
    rounding noise: a conv bias under BN has an analytic gradient of 0)."""
    import numpy as np
    from paddle_tpu_torch.framework.executor import as_numpy
    from paddle_tpu_torch.models import se_resnext
    cfg = SE_RESNEXT_SMALL
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        img = ptt.layers.data("img", shape=[cfg["image"]] * 2 + [3])
        loss, _, _ = se_resnext.se_resnext_imagenet(
            img=img, class_num=cfg["classes"], use_bf16=False)
        ptt.optimizer.Momentum(learning_rate=cfg["lr"],
                               momentum=0.9).minimize(loss)
    _no_dropout(main)
    params = [p for p in main.all_parameters()]
    names = [p.name for p in params if p.trainable]
    stats = [p.name for p in params if not p.trainable]
    gpu_scope = ptt.Scope()
    ptt.Executor(ptt.CUDAPlace(0)).run(start, scope=gpu_scope)
    state = {n: as_numpy(gpu_scope.get(n))
             for n in gpu_scope.local_var_names()}
    cpu_scope = ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())
    rng = np.random.RandomState(SEED + 11)
    feed = {"img": rng.rand(cfg["batch"], cfg["image"], cfg["image"],
                            3).astype("float32"),
            "label": rng.randint(0, cfg["classes"],
                                 (cfg["batch"], 1)).astype("int64")}
    fetch = [loss.name] + [n + "@GRAD" for n in names]
    g = ptt.Executor(ptt.CUDAPlace(0)).run(main, feed=feed,
                                           fetch_list=fetch,
                                           scope=gpu_scope)
    c = ptt.Executor(ptt.CPUPlace()).run(main, feed=feed, fetch_list=fetch,
                                         scope=cpu_scope)
    np.testing.assert_allclose(g[0], c[0], rtol=1e-4,
                               err_msg="SE-ResNeXt loss")
    for n in stats:
        gv, cv = as_numpy(gpu_scope.get(n)), as_numpy(cpu_scope.get(n))
        assert np.abs(gv - cv).max() <= 1e-3 * np.abs(cv).max(), n
    gmax = max(float(np.abs(cg).max()) for cg in c[1:])
    worst_cos, worst_norm, checked = 1.0, 0.0, 0
    for n, gg, cg in zip(names, g[1:], c[1:]):
        if max(np.abs(gg).max(), np.abs(cg).max()) <= 1e-5 * gmax:
            continue
        cos = _cosine(gg, cg)
        nrm = abs(float(np.linalg.norm(gg) / np.linalg.norm(cg)) - 1)
        assert cos >= 0.99 and nrm <= 0.02, (n, cos, nrm)
        worst_cos, worst_norm = min(worst_cos, cos), max(worst_norm, nrm)
        checked += 1
    n_groups = sum(op.type == "conv2d" and op.attrs.get("groups", 1) > 1
                   for op in main.global_block().ops)
    log(f"  SE-ResNeXt-50 at {cfg['image']}x{cfg['image']}, batch "
        f"{cfg['batch']}, float32, one Momentum step ({n_groups} grouped "
        f"convs): loss card {float(g[0]):.6f}, CPU {float(c[0]):.6f}; "
        f"{checked} of {len(names)} gradients held (the rest below 1e-5 of "
        f"the largest), worst cosine {worst_cos:.5f}, worst norm ratio "
        f"{worst_norm:.2e}; {len(stats)} running statistics within 1e-3")
    return {"loss_card": float(g[0]), "loss_cpu": float(c[0]),
            "worst_cosine": worst_cos, "worst_norm_ratio": worst_norm}


def resnet_reference_check(ptt):
    """Phase 21: ResNet-8 (resnet_cifar10, depth 8) in float32 with TF32
    off, 3 Momentum steps card against CPU from the same weights: losses,
    gradients, parameters and the BN running statistics; then one
    SE-ResNeXt-50 step."""
    from paddle_tpu_torch.models import resnet
    cfg = RESNET_SMALL

    def build(ptt, cfg):
        main, start = ptt.Program(), ptt.Program()
        with ptt.program_guard(main, start), ptt.unique_name.guard():
            img = ptt.layers.data("img", shape=[cfg["image"]] * 2 + [3])
            loss, _, _ = resnet.resnet_cifar10(img=img, depth=cfg["depth"],
                                               class_num=cfg["classes"])
            ptt.optimizer.Momentum(learning_rate=cfg["lr"],
                                   momentum=0.9).minimize(loss)
        return main, start, loss

    def make_feeds(rng, cfg, n):
        return [{"img": rng.rand(cfg["batch"], cfg["image"], cfg["image"],
                                 3).astype("float32"),
                 "label": rng.randint(0, cfg["classes"], (cfg["batch"], 1))
                 .astype("int64")} for _ in range(n)]

    _card_against_cpu(ptt, "ResNet-8 (cifar)", cfg, build, make_feeds,
                      steps=3, opt="Momentum")
    return {"se_resnext_step": se_resnext_step_check(ptt)}


def _new_tensors_mode():
    """A TorchDispatchMode recording the shape of every tensor an op
    creates; an in-place op's result, which is its input, is not
    recorded."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class NewTensors(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = {id(a) for a in args if isinstance(a, torch.Tensor)}
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor) and id(o) not in ins:
                    self.shapes.append(tuple(o.shape))
            return out
    return NewTensors()


def _deepfm_program(ptt, cfg):
    """deepfm(is_sparse=True) + Adam(lr).minimize(loss), as
    tools/bench_breadth.py:254-275 builds it; the same names each build."""
    from paddle_tpu_torch.models import deepfm
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        loss, _ = deepfm.deepfm(
            num_fields=cfg["num_fields"], vocab_size=cfg["vocab"],
            embed_dim=cfg["embed_dim"], fc_sizes=cfg["fc_sizes"],
            is_sparse=True, row_pad=cfg["row_pad"])
        ptt.optimizer.Adam(learning_rate=cfg["lr"]).minimize(loss)
    return main, start, loss


def _deepfm_feeds(rng, cfg, n):
    """tools/bench_breadth.py:262-273's recipe: near-unique ids over the
    1M rows, and labels a function of the dense values (learnable through
    the shared MLP, not memorizable through per-example rows)."""
    b, f = cfg["batch"], cfg["num_fields"]
    out = []
    for _ in range(n):
        vals = rng.rand(b, f).astype("float32")
        label = (vals.mean(axis=1, keepdims=True) > 0.5).astype("float32")
        out.append({"feat_ids": rng.randint(0, cfg["vocab"],
                                            (b, f)).astype("int64"),
                    "feat_vals": vals, "label": label})
    return out


def _table_sized(shapes, height):
    return [s for s in shapes if s and s[0] == height]


def _one_step_shapes(exe, main, feed, loss, scope):
    """One step under `_new_tensors_mode`: (the shapes made inside the
    autograd region, the shapes made in the whole step)."""
    from paddle_tpu_torch.framework import lowering
    seen, marks = _new_tensors_mode(), []
    real = lowering.run_vjp_region

    def tagged(op, env, ctx):
        marks.append(len(seen.shapes))
        real(op, env, ctx)
        marks.append(len(seen.shapes))
    lowering.run_vjp_region = tagged
    try:
        with seen:
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                    return_numpy=False)
    finally:
        lowering.run_vjp_region = real
    return seen.shapes[marks[0]:marks[1]], seen.shapes


def _adam_state_close(label, a, b, snap, lr, steps):
    """Two Adam runs from one state whose gradients differ by summation
    order: the beta powers equal; every other element within 1e-7 +
    1e-5 |x|, but for at most 1e-4 of each tensor's elements, which may
    move by up to 2 * lr a step (Adam moves an element by about lr * sign
    of its first moment, which rounding flips where the gradient is
    rounding-sized). Returns the largest such fraction."""
    import torch
    worst = 0.0
    for n, av in a.items():
        bv = b[n]
        if "beta" in n:
            assert torch.equal(av, bv), (label, n)
            continue
        diff = (av - bv).abs()
        tight = 1e-7 + 1e-5 * av.abs()
        loose = (diff > tight).float().mean().item()
        worst = max(worst, loose)
        assert loose <= 1e-4, (label, n, loose)
        bound = 2 * lr * steps + tight
        assert bool((diff <= bound).all()), (label, n, diff.max().item())
    return worst


def train_deepfm(ptt, kernels):
    """Phase 22: DeepFM at full width with sparse gradients. Returns its
    numbers for the JSON line."""
    import numpy as np
    import torch
    cfg = DEEPFM
    height = cfg["vocab"]
    rng = np.random.RandomState(SEED + 22)
    host = _deepfm_feeds(rng, cfg, cfg["batches"])
    t0 = time.perf_counter()
    main, start, loss = _deepfm_program(ptt, cfg)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CUDAPlace(0))
    exe.run(start, scope=scope)
    feeds = [{k: torch.from_numpy(v).to(exe.device) for k, v in f.items()}
             for f in host]
    torch.cuda.synchronize()
    table = next(p.name for p in main.all_parameters()
                 if p.shape[0] == height)
    width = scope.get(table).shape[1]
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    log(f"  built and initialized in {time.perf_counter() - t0:.2f} s: "
        f"table {table} [{height}, {width}] "
        f"({height * width * 4 / 1e6:.1f} MB), {n_params / 1e6:.2f}M "
        f"parameters")
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for i in range(DEEPFM_STEPS):
        s0 = time.perf_counter()
        out, = exe.run(main, feed=feeds[i % len(feeds)], fetch_list=[loss],
                       scope=scope, return_numpy=False)
        losses.append(float(out))
        secs.append(time.perf_counter() - s0)
    st = np.asarray(secs[1:]) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e6
    log(f"  {DEEPFM_STEPS} steps of batch {cfg['batch']}: step time median "
        f"{np.median(st):.3f} ms, p95 {np.percentile(st, 95):.3f} ms "
        f"(steps 2-{DEEPFM_STEPS}; step 1 {secs[0] * 1e3:.1f} ms), "
        f"{cfg['batch'] / (np.median(st) / 1e3):.1f} examples/s; peak "
        f"device memory {peak:.1f} MB")
    log(f"  loss: {[round(x, 5) for x in losses]}")
    assert all(math.isfinite(x) for x in losses), losses
    k = cfg["batches"]
    assert np.mean(losses[-k:]) < np.mean(losses[:k]), \
        f"loss did not fall: {losses}"

    # no dense gradient of the table: nothing table-sized is made inside
    # the autograd region (the dense-masked apply's scatter buffer and
    # masked temporaries are the optimizer's); with the merged-rows path,
    # nothing table-sized anywhere in the step
    region, step = _one_step_shapes(exe, main, feeds[0], loss, scope)
    assert not _table_sized(region, height), _table_sized(region, height)
    dense_apply = len(_table_sized(step, height))
    ptt.flags.set_flag("sparse_dense_apply_max_bytes",
                       DEEPFM_ROWS_MAX_BYTES)
    try:
        region_r, step_r = _one_step_shapes(exe, main, feeds[1], loss,
                                            scope)
    finally:
        ptt.flags.set_flag("sparse_dense_apply_max_bytes", 1 << 30)
    assert not _table_sized(step_r, height), _table_sized(step_r, height)
    log(f"  table-sized tensors made in a step: 0 in the autograd region; "
        f"{dense_apply} in the dense-masked Adam apply; 0 in a whole step "
        f"on the merged-rows path ({len(step_r)} tensors made)")

    # no host sync on the step's path
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(3):
            exe.run(main, feed=feeds[2 + i], fetch_list=[loss], scope=scope,
                    return_numpy=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # and the merged-rows path's sort and run heads
    ptt.flags.set_flag("sparse_dense_apply_max_bytes",
                       DEEPFM_ROWS_MAX_BYTES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        exe.run(main, feed=feeds[5], fetch_list=[loss], scope=scope,
                return_numpy=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        ptt.flags.set_flag("sparse_dense_apply_max_bytes", 1 << 30)
    torch.cuda.synchronize()
    log("  3 dense-masked steps and 1 merged-rows step under "
        "torch.cuda.set_sync_debug_mode('error'): no host sync")

    # the two apply paths of lazy Adam from one state
    snap = {n: scope.get(n).clone() for n in scope.local_var_names()}
    check = feeds[5:5 + DEEPFM_CHECK_STEPS]
    ids = np.concatenate([host[5 + i]["feat_ids"].ravel()
                          for i in range(DEEPFM_CHECK_STEPS)])
    untouched = torch.ones(height, dtype=torch.bool, device=exe.device)
    untouched[torch.from_numpy(np.unique(ids)).to(exe.device)] = False
    ends, times = {}, {}
    for path, max_bytes in (("dense_masked", 1 << 30),
                            ("merged_rows", DEEPFM_ROWS_MAX_BYTES)):
        for n, t in snap.items():
            scope.get(n).copy_(t)
        ptt.flags.set_flag("sparse_dense_apply_max_bytes", max_bytes)
        ms = []
        try:
            for f in check:
                torch.cuda.synchronize()
                s0 = time.perf_counter()
                exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                        return_numpy=False)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - s0) * 1e3)
        finally:
            ptt.flags.set_flag("sparse_dense_apply_max_bytes", 1 << 30)
        times[path] = ms
        ends[path] = {n: scope.get(n).clone() for n in snap}
        for n in snap:
            if scope.get(n).shape[:1] == (height,):
                assert torch.equal(ends[path][n][untouched],
                                   snap[n][untouched]), (path, n)
    worst = _adam_state_close("dense-masked vs merged rows",
                              ends["dense_masked"], ends["merged_rows"],
                              snap, cfg["lr"], DEEPFM_CHECK_STEPS)
    log(f"  {DEEPFM_CHECK_STEPS} steps from one state, dense-masked and "
        f"merged-rows Adam: every persistable agrees (share of elements "
        f"beyond 1e-7 + 1e-5|x|: {worst:.2e}, at most 1e-4 allowed); "
        f"{int(untouched.sum())} untouched rows bit-equal to the start on "
        f"both; step ms (synchronized) dense-masked "
        f"{[round(x, 3) for x in times['dense_masked']]}, merged rows "
        f"{[round(x, 3) for x in times['merged_rows']]}")
    del ends, snap
    return {"batch": cfg["batch"], "steps": DEEPFM_STEPS,
            "step_ms_median": float(np.median(st)),
            "step_ms_p95": float(np.percentile(st, 95)),
            "step1_ms": secs[0] * 1e3,
            "examples_per_s": float(cfg["batch"] / (np.median(st) / 1e3)),
            "peak_mb": peak, "loss": losses,
            "table_sized_in_region": 0,
            "table_sized_in_dense_masked_step": dense_apply,
            "table_sized_in_merged_rows_step": 0,
            "paths_beyond_tight_share": worst,
            "check_step_ms": times}


def train_lm_remat(ptt, kernels):
    """Phase 23: phase 7's LM under transpiler.memory_optimize at levels 0
    and 1, each run from the state the un-rematerialized run starts from.
    Returns its numbers for the JSON line."""
    import numpy as np
    import torch
    cfg = TRAIN
    rng = np.random.RandomState(SEED)
    b, t = cfg["batch"], cfg["max_len"]
    feeds = []
    for _ in range(TRAIN_BATCHES):
        toks = _markov_tokens(rng, b, t + 1, cfg["vocab"])
        feeds.append({"tokens": toks[:, :-1].copy(),
                      "tokens@SEQLEN": np.full((b,), t, "int32"),
                      "targets": toks[:, 1:].copy()})
    main0, start0, loss0 = _train_program(ptt, cfg)
    scope0 = ptt.Scope()
    ptt.Executor(ptt.CUDAPlace(0)).run(start0, scope=scope0)
    snap = {n: scope0.get(n).clone() for n in scope0.local_var_names()}
    del scope0
    params = [p.name for p in main0.all_parameters()]

    def program(level, dropout=0.0):
        main, _, loss = _train_program(ptt, cfg, dropout=dropout)
        if level is not None:
            ptt.transpiler.memory_optimize(main, level=level)
        return main, loss

    def run(main, loss, steps, grads=False):
        scope = ptt.Scope()
        for n, v in snap.items():
            scope.set_var(n, v.clone())
        exe = ptt.Executor(ptt.CUDAPlace(0))
        fetch = [loss] + ([n + "@GRAD" for n in params] if grads else [])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        losses, secs, g = [], [], None
        for i in range(steps):
            s0 = time.perf_counter()
            out = exe.run(main, feed=feeds[i % len(feeds)],
                          fetch_list=fetch, scope=scope,
                          return_numpy=grads)
            losses.append(float(out[0]))
            secs.append(time.perf_counter() - s0)
            if grads:
                g = out[1:]
        return dict(losses=losses, secs=secs, grads=g,
                    launches=dict(kernels.LAUNCHES),
                    peak=torch.cuda.max_memory_allocated() / 1e6,
                    update={n: scope.get(n) - snap[n] for n in params})

    def update_rel(r, p):
        """The largest ‖Δu‖ / ‖u‖ over the parameters, u the run's update
        of the parameter from the shared start."""
        return max(float((r["update"][n] - p["update"][n]).norm()
                         / p["update"][n].norm().clamp_min(1e-30))
                   for n in params)

    out = {}
    runs = {}
    for level in (None, 0, 1):
        name = "plain" if level is None else f"level{level}"
        main, loss = program(level)
        g1 = run(main, loss, 1, grads=True)
        r = run(main, loss, REMAT_STEPS)
        r["grads1"], r["loss1"] = g1["grads"], g1["losses"][0]
        runs[name] = r
    plain = runs["plain"]
    pst = np.asarray(plain["secs"][1:]) * 1e3
    out["plain"] = {"peak_mb": plain["peak"],
                    "step_ms_median": float(np.median(pst)),
                    "launches_per_step": {k: plain["launches"][k]
                                          / REMAT_STEPS
                                          for k in FLASH + FLASH_TC},
                    "loss": plain["losses"]}
    log(f"  un-rematerialized: peak {plain['peak']:.1f} MB, step median "
        f"{np.median(pst):.1f} ms, launches a step "
        f"{out['plain']['launches_per_step']}, losses "
        f"{[round(x, 5) for x in plain['losses']]}")
    for name in ("level0", "level1"):
        r = runs[name]
        gworst = max(float(np.linalg.norm(rg - pg)
                           / max(np.linalg.norm(pg), 1e-30))
                     for rg, pg in zip(r["grads1"], plain["grads1"]))
        uworst = update_rel(r, plain)
        per = {k: r["launches"][k] / REMAT_STEPS
               for k in FLASH + FLASH_TC}
        st = np.asarray(r["secs"][1:]) * 1e3
        log(f"  {name}: peak {r['peak']:.1f} MB; step median "
            f"{np.median(st):.1f} ms; launches a step {per}; losses "
            f"{[round(x, 5) for x in r['losses']]}; step-1 loss "
            f"{r['loss1']:.6f} (un-rematerialized {plain['loss1']:.6f}), "
            f"gradients within {gworst:.2e} of their norms, "
            f"{REMAT_STEPS}-step updates within {uworst:.2e}")
        out[name] = {"peak_mb": r["peak"],
                     "step_ms_median": float(np.median(st)),
                     "launches_per_step": per, "loss": r["losses"],
                     "loss1": r["loss1"], "grad_rel_worst": gworst,
                     "update_rel_worst": uworst}
    del runs
    # the checks, once every number is out
    assert out["plain"]["launches_per_step"]["flash_fwd_tc"] == \
        cfg["num_layers"], out["plain"]
    for name in ("level0", "level1"):
        o, per = out[name], out[name]["launches_per_step"]
        np.testing.assert_allclose(o["loss1"], plain["loss1"], rtol=1e-5,
                                   err_msg=f"{name}: step-1 loss")
        assert o["grad_rel_worst"] <= 4e-3, (name, o["grad_rel_worst"])
        np.testing.assert_allclose(o["loss"], plain["losses"], rtol=2e-3,
                                   err_msg=f"{name}: losses")
        assert o["update_rel_worst"] <= 0.05, (name, o["update_rel_worst"])
        assert per["flash_fwd"] == per["flash_fwd_tc"] == \
            2 * cfg["num_layers"], (name, per)
        for k in ("flash_bwd_dq", "flash_bwd_dkv"):
            assert per[k] == per[k + "_tc"] == cfg["num_layers"], \
                (name, per)
        assert o["peak_mb"] < plain["peak"], (name, o["peak_mb"],
                                              plain["peak"])

    # dropout: the recompute must draw the forward's masks
    d = {}
    for name, level in (("plain", None), ("level1", 1)):
        main, loss = program(level, dropout=REMAT_DROPOUT)
        d[name] = run(main, loss, REMAT_DROPOUT_STEPS)
    dworst = update_rel(d["level1"], d["plain"])
    log(f"  dropout {REMAT_DROPOUT}, level 1 against un-rematerialized, "
        f"{REMAT_DROPOUT_STEPS} steps: losses "
        f"{[round(x, 5) for x in d['level1']['losses']]} against "
        f"{[round(x, 5) for x in d['plain']['losses']]}, updates within "
        f"{dworst:.2e} of their norms; peak {d['level1']['peak']:.1f} MB "
        f"against {d['plain']['peak']:.1f} MB")
    np.testing.assert_allclose(d["level1"]["losses"], d["plain"]["losses"],
                               rtol=2e-3, err_msg="dropout: losses")
    assert dworst <= 0.05, ("dropout", dworst)
    out["dropout"] = {"loss_level1": d["level1"]["losses"],
                      "loss_plain": d["plain"]["losses"],
                      "update_rel_worst": dworst}
    del d, snap
    return out


def _steps_card_against_cpu(ptt, label, build, feeds, lr, grads_of=None):
    """Each step from the same state (the CPU takes the card's state before
    every step), compares the loss at rtol 1e-5 and every persistable at
    1e-6 + 1e-5 |x|, except where the CPU's gradient (`grads_of`: the
    trainable parameters, from a probe run that fetches them densely) is
    below 1e-5: Adam moves such an element by about lr * sign(g), so there
    the bound is 2 * lr. Returns the card's scope."""
    import numpy as np
    from paddle_tpu_torch.framework.executor import as_numpy
    main, start, loss = build(ptt)
    names = [p.name for p in main.all_parameters() if p.trainable]
    gpu_scope = ptt.Scope()
    gpu = ptt.Executor(ptt.CUDAPlace(0))
    gpu.run(start, scope=gpu_scope)
    cpu = ptt.Executor(ptt.CPUPlace())
    for i, feed in enumerate(feeds):
        state = {n: as_numpy(gpu_scope.get(n))
                 for n in gpu_scope.local_var_names()}
        probe = ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())
        grads = cpu.run(main, feed=feed, fetch_list=[n + "@GRAD"
                                                     for n in names],
                        scope=probe)
        tiny = {n: np.abs(g) < 1e-5 for n, g in zip(names, grads)}
        cpu_scope = ptt.load_numpy_params(state, ptt.Scope(),
                                          ptt.CPUPlace())
        g_loss, = gpu.run(main, feed=feed, fetch_list=[loss],
                          scope=gpu_scope)
        c_loss, = cpu.run(main, feed=feed, fetch_list=[loss],
                          scope=cpu_scope)
        np.testing.assert_allclose(g_loss, c_loss, rtol=1e-5,
                                   err_msg=f"{label}: loss, step {i + 1}")
        for n in state:
            gp, cp = as_numpy(gpu_scope.get(n)), as_numpy(cpu_scope.get(n))
            tol = 1e-6 + 1e-5 * np.abs(cp)
            if n in tiny:
                tol = tol + np.where(tiny[n], 2 * lr, 0.0)
            diff = np.abs(gp - cp)
            assert (diff <= tol).all(), (label, n, i, float(diff.max()))
    log(f"  {label}: {len(feeds)} steps, each from the same state, card "
        f"and CPU agree ({len(names)} parameters and every accumulator)")
    return gpu_scope


def _small_fc(opt):
    def build(ptt, cfg=None):
        main, start = ptt.Program(), ptt.Program()
        with ptt.program_guard(main, start), ptt.unique_name.guard():
            x = ptt.layers.data(name="x", shape=[24], dtype="float32")
            y = ptt.layers.data(name="y", shape=[1], dtype="float32")
            h = ptt.layers.fc(x, size=32, act="tanh")
            d = ptt.layers.elementwise_sub(ptt.layers.fc(h, size=1), y)
            loss = ptt.layers.mean(ptt.layers.elementwise_mul(d, d))
            opt(ptt).minimize(loss)
        return main, start, loss
    return build


def _fc_feeds(rng, cfg, n):
    return [{"x": rng.randn(16, 24).astype("float32"),
             "y": rng.randn(16, 1).astype("float32")} for _ in range(n)]


# phase 24's optimizer classes: (label, learning rate, factory); with the
# proximal ops below, every one of the nine update ops
_OPTIMIZERS = (
    ("Adagrad", 0.01, lambda p: p.optimizer.Adagrad(learning_rate=0.01)),
    ("Adamax", 0.01, lambda p: p.optimizer.Adamax(learning_rate=0.01)),
    ("DecayedAdagrad", 0.01,
     lambda p: p.optimizer.DecayedAdagrad(learning_rate=0.01)),
    ("Adadelta", 1.0, lambda p: p.optimizer.Adadelta(learning_rate=1.0)),
    ("RMSProp centered, momentum", 0.01,
     lambda p: p.optimizer.RMSProp(learning_rate=0.01, momentum=0.9,
                                   centered=True)),
    ("Ftrl", 0.1, lambda p: p.optimizer.Ftrl(learning_rate=0.1, l1=0.01,
                                             l2=0.01)),
    ("Ftrl lr_power -0.3", 0.1,
     lambda p: p.optimizer.Ftrl(learning_rate=0.1, lr_power=-0.3)),
    ("Lamb", 0.01, lambda p: p.optimizer.Lamb(learning_rate=0.01)),
)


def _proximal_ops_check():
    """proximal_gd and proximal_adagrad (ops with no optimizer class):
    one update on the card and on the CPU from the same inputs."""
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.core.places import resolve_device
    from paddle_tpu_torch.framework.executor import as_numpy
    from paddle_tpu_torch.framework.registry import LowerCtx, lookup_op
    card = resolve_device(ptt.CUDAPlace(0))
    rng = np.random.RandomState(SEED + 24)
    ins = {"Param": rng.randn(64, 32).astype("float32"),
           "Grad": rng.randn(64, 32).astype("float32") * 0.1,
           "Moment": np.abs(rng.randn(64, 32)).astype("float32") * 0.01,
           "LearningRate": np.array([0.1], "float32")}
    attrs = {"l1": 0.01, "l2": 0.01}
    for op in ("proximal_gd", "proximal_adagrad"):
        use = {k: v for k, v in ins.items()
               if op == "proximal_adagrad" or k != "Moment"}
        outs = [lookup_op(op).lower(
            LowerCtx(device=dev),
            {k: [torch.from_numpy(v).to(dev)] for k, v in use.items()},
            dict(attrs)) for dev in (card, torch.device("cpu"))]
        for slot, (g,) in outs[0].items():
            c = as_numpy(outs[1][slot][0])
            np.testing.assert_allclose(as_numpy(g), c, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{op} {slot}")
    log("  proximal_gd, proximal_adagrad: card and CPU agree")


def _model_average_check(ptt):
    """ModelAverage over 3 SGD steps on the card and the CPU from the same
    state: apply swaps in equal averages, an evaluation sees them, restore
    brings back the trained parameters."""
    import numpy as np
    from paddle_tpu_torch.framework.executor import as_numpy
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        x = ptt.layers.data(name="x", shape=[24], dtype="float32")
        y = ptt.layers.data(name="y", shape=[1], dtype="float32")
        d = ptt.layers.elementwise_sub(ptt.layers.fc(x, size=1), y)
        loss = ptt.layers.mean(ptt.layers.elementwise_mul(d, d))
        ptt.optimizer.SGD(learning_rate=0.1).minimize(loss)
        test_prog = main.clone(for_test=True)
        avg = ptt.optimizer.ModelAverage(average_window_rate=0.3)
        avg.build(main.all_parameters())
    gscope = ptt.Scope()
    gpu = ptt.Executor(ptt.CUDAPlace(0))
    gpu.run(start, scope=gscope)
    cscope = ptt.load_numpy_params(
        {n: as_numpy(gscope.get(n)) for n in gscope.local_var_names()},
        ptt.Scope(), ptt.CPUPlace())
    cpu = ptt.Executor(ptt.CPUPlace())
    feeds = _fc_feeds(np.random.RandomState(SEED + 25), None, 4)
    for f in feeds[:3]:
        gpu.run(main, feed=f, fetch_list=[loss], scope=gscope)
        cpu.run(main, feed=f, fetch_list=[loss], scope=cscope)
    params = [p.name for p in main.all_parameters()]
    trained = {n: as_numpy(gscope.get(n)) for n in params}
    avg.apply(gscope)
    avg.apply(cscope)
    for n in params:
        np.testing.assert_allclose(as_numpy(gscope.get(n)),
                                   as_numpy(cscope.get(n)), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    g, = gpu.run(test_prog, feed=feeds[3], fetch_list=[loss], scope=gscope)
    c, = cpu.run(test_prog, feed=feeds[3], fetch_list=[loss], scope=cscope)
    np.testing.assert_allclose(g, c, rtol=1e-5)
    avg.restore(gscope)
    for n in params:
        assert np.array_equal(as_numpy(gscope.get(n)), trained[n]), n
    log(f"  ModelAverage: averages equal card and CPU, evaluation loss "
        f"{float(g):.6f} (CPU {float(c):.6f}), restore exact")


def _resnet8_remat_check(ptt):
    """ResNet-8 on the card under memory_optimize (levels 0, 1) against
    its un-rematerialized run from the same state, 3 Momentum steps, cuDNN
    deterministic: every persistable, the 18 running statistics included,
    within 1e-6 + 1e-5 |x|, and each statistic moved. A running-statistic
    update applied again by the recompute would be off by (1 - momentum)
    of the batch statistic, far outside."""
    import numpy as np
    import torch
    from paddle_tpu_torch.framework.executor import as_numpy
    from paddle_tpu_torch.models import resnet
    cfg = RESNET_SMALL

    def build(level):
        main, start = ptt.Program(), ptt.Program()
        with ptt.program_guard(main, start), ptt.unique_name.guard():
            img = ptt.layers.data("img", shape=[cfg["image"]] * 2 + [3])
            loss, _, _ = resnet.resnet_cifar10(img=img, depth=cfg["depth"],
                                               class_num=cfg["classes"])
            ptt.optimizer.Momentum(learning_rate=cfg["lr"],
                                   momentum=0.9).minimize(loss)
        if level is not None:
            ptt.transpiler.memory_optimize(main, level=level)
        return main, start, loss

    rng = np.random.RandomState(SEED + 26)
    feeds = [{"img": rng.rand(cfg["batch"], cfg["image"], cfg["image"], 3)
              .astype("float32"),
              "label": rng.randint(0, cfg["classes"], (cfg["batch"], 1))
              .astype("int64")} for _ in range(3)]
    main, start, loss = build(None)
    scope = ptt.Scope()
    ptt.Executor(ptt.CUDAPlace(0)).run(start, scope=scope)
    init = {n: as_numpy(scope.get(n)) for n in scope.local_var_names()}
    stats = [p.name for p in main.all_parameters() if not p.trainable]
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        ends = {}
        for level in (None, 0, 1):
            main, _, loss = build(level)
            sc = ptt.load_numpy_params(init, ptt.Scope(), ptt.CUDAPlace(0))
            exe = ptt.Executor(ptt.CUDAPlace(0))
            for f in feeds:
                exe.run(main, feed=f, fetch_list=[loss], scope=sc)
            ends[level] = {n: as_numpy(sc.get(n)) for n in init}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = prev
    worst = 0.0
    for level in (0, 1):
        for n, ref in ends[None].items():
            diff = np.abs(ends[level][n] - ref)
            assert (diff <= 1e-6 + 1e-5 * np.abs(ref)).all(), \
                (level, n, float(diff.max()))
            worst = max(worst, float(diff.max()))
    for n in stats:
        assert not np.array_equal(ends[1][n], init[n]), n
    log(f"  ResNet-8 under memory_optimize levels 0 and 1: {len(stats)} "
        f"running statistics and every parameter agree with the "
        f"un-rematerialized run (largest difference {worst:.2e})")
    return worst


def _piecewise_decay_sync_check(ptt):
    """A step whose learning rate is piecewise_decay runs with no host
    sync once planned, and gives the schedule's values."""
    import numpy as np
    import torch
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        x = ptt.layers.data(name="x", shape=[24], dtype="float32")
        y = ptt.layers.data(name="y", shape=[1], dtype="float32")
        d = ptt.layers.elementwise_sub(ptt.layers.fc(x, size=1), y)
        loss = ptt.layers.mean(ptt.layers.elementwise_mul(d, d))
        lr = ptt.layers.piecewise_decay([2, 4], [0.1, 0.05, 0.01])
        ptt.optimizer.SGD(learning_rate=lr).minimize(loss)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CUDAPlace(0))
    exe.run(start, scope=scope)
    feeds = [{k: torch.from_numpy(v).to(exe.device) for k, v in f.items()}
             for f in _fc_feeds(np.random.RandomState(SEED + 27), None, 6)]
    seen = [exe.run(main, feed=feeds[0], fetch_list=[lr], scope=scope,
                    return_numpy=False)[0].clone()]        # plans
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for f in feeds[1:]:
            seen.append(exe.run(main, feed=f, fetch_list=[lr], scope=scope,
                                return_numpy=False)[0].clone())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = [float(v) for v in seen]
    want = [0.1, 0.1, 0.05, 0.05, 0.01, 0.01]
    np.testing.assert_allclose(got, want, rtol=1e-7)
    log(f"  piecewise_decay: 5 steps under set_sync_debug_mode('error') "
        f"after the planning step, learning rates {got}")
    return got


def rest_reference_check(ptt):
    """Phase 24: the rest of training, small, card against CPU: the nine
    optimizer ops (seven classes, two ops), ModelAverage, DeepFM sparse
    on both apply paths, ResNet-8 under memory_optimize, and
    piecewise_decay with no host sync."""
    for label, lr, make in _OPTIMIZERS:
        cfg = {"lr": lr}
        _card_against_cpu(ptt, label, cfg, _small_fc(make), _fc_feeds,
                          steps=3, resync=True, opt=label)
    _proximal_ops_check()
    _model_average_check(ptt)
    import numpy as np
    cfg = DEEPFM_SMALL
    feeds = _deepfm_feeds(np.random.RandomState(SEED + 28), cfg,
                          cfg["batches"])
    for path, max_bytes in (("dense-masked", 1 << 30), ("merged rows", 0)):
        ptt.flags.set_flag("sparse_dense_apply_max_bytes", max_bytes)
        try:
            _steps_card_against_cpu(
                ptt, f"DeepFM sparse, {path}",
                lambda p: _deepfm_program(p, cfg), feeds, cfg["lr"])
        finally:
            ptt.flags.set_flag("sparse_dense_apply_max_bytes", 1 << 30)
    worst = _resnet8_remat_check(ptt)
    lrs = _piecewise_decay_sync_check(ptt)
    return {"optimizers": [o[0] for o in _OPTIMIZERS]
            + ["proximal_gd", "proximal_adagrad", "ModelAverage"],
            "resnet8_remat_max_diff": worst, "piecewise_decay_lr": lrs}


def _profile_one(label, step):
    """One call of `step` under torch.profiler: wall, device busy, the
    idle share and the top device kernels, logged and returned."""
    wall, events = _profile(step, 1, annotate=False)
    kernels_ = device_kernels(events)
    busy_us = sum(dev_self(e) for e in kernels_)
    prof = {"wall_ms": wall * 1e3}
    if busy_us <= 0:
        log("  the profiler saw no device time: device busy share not "
            "measured")
    else:
        prof.update(busy_ms=busy_us / 1e3,
                    idle_share=1 - busy_us / 1e6 / wall)
        log(f"  {label} under the profiler: wall {wall * 1e3:.1f} ms, "
            f"device busy {busy_us / 1e3:.2f} ms ({len(kernels_)} distinct "
            f"kernels), idle share {1 - busy_us / 1e6 / wall:.3f}")
    prof["top"] = []
    for e in sorted(kernels_, key=dev_self, reverse=True)[:8]:
        prof["top"].append([e.key[:80], dev_self(e) / 1e3, e.count])
        log(f"    device {dev_self(e) / 1e3:8.3f} ms {e.count:6d} calls  "
            f"{e.key[:80]}")
    return prof


def _nmt_infer_program(ptt, cfg, beam):
    """machine_translation.infer_net at `cfg`'s width (the trained
    parameters' names), as a user builds it."""
    from paddle_tpu_torch.models import machine_translation as mt
    L = ptt.layers
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        src = L.data("src", shape=[cfg["src_len"]], dtype="int64")
        src_lens = L.data("src_lens", shape=[], dtype="int64")
        seqs, scores = mt.infer_net(
            src, src_lens, dict_size=cfg["dict_size"],
            embed_dim=cfg["embed_dim"], hidden_dim=cfg["hidden_dim"],
            beam_size=beam["beam_size"], max_len=beam["max_len"],
            bos_id=beam.get("bos_id", 0), eos_id=beam.get("eos_id", 1))
    return main, start, [seqs, scores]


def _check_beams(label, seqs, scores, vocab):
    """The decode's checks: scores finite and sorted best-first, every id
    a vocabulary id."""
    import numpy as np
    assert np.isfinite(scores).all(), f"{label}: scores {scores}"
    assert (np.diff(scores, axis=1) <= 0).all(), \
        f"{label}: beams not sorted best-first: {scores}"
    assert ((seqs >= 0) & (seqs < vocab)).all(), \
        f"{label}: ids outside [0, {vocab})"


def translate_nmt(ptt, kernels, params_dir):
    """Phase 32: beam-search translation at full width. Phase 12's trained
    parameters, saved with io.save_params, load with io.load_params into
    a fresh infer_net(beam_size=4, max_len=64) program on CUDAPlace(0);
    BEAM["batches"] batches of 32 of phase 12's ragged sources decode
    (the first a warm-up that plans), each under
    torch.cuda.set_sync_debug_mode("error") with its feeds on the card:
    no host sync on the decode's path. Launch counts are zeroed after the
    warm-up and read after the last batch: K6 once a batch (the encoder),
    K4 max_len times (the attention of the K beams, G = K query rows, each
    step). Prints seconds per batch (median), beam positions/s (B x
    max_len, the fixed-shape work a batch does, over the median batch),
    emitted tokens/s (the best beams' tokens up to and including their
    first eos, over the median batch) with the share of best beams that
    ended on eos, the counts, and one profiled batch's device busy and
    idle share with its top kernels."""
    import numpy as np
    import torch
    cfg, beam = NMT, BEAM
    cuda = ptt.CUDAPlace(0)
    main, start, fetch = _nmt_infer_program(ptt, cfg, beam)
    scope = ptt.Scope()
    exe = ptt.Executor(cuda)
    exe.run(start, scope=scope)
    ptt.io.load_params(exe, params_dir, main_program=main, scope=scope)
    feeds = _nmt_feeds(np.random.RandomState(SEED + 7), cfg,
                       beam["batches"])
    dev_feeds = [{k: torch.from_numpy(f[k]).to(exe.device)
                  for k in ("src", "src_lens")} for f in feeds]

    def decode(i):
        return exe.run(main, feed=dev_feeds[i], fetch_list=fetch,
                       scope=scope, return_numpy=False)

    t0 = time.perf_counter()
    warm = [t.cpu().numpy() for t in decode(0)]
    log(f"  warm-up batch (plans): {time.perf_counter() - t0:.2f} s")
    _check_beams("warm-up", *warm, cfg["dict_size"])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    secs, outs = [], []
    for i in range(1, beam["batches"]):
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = decode(i)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append([t.cpu().numpy() for t in out])
    launches = dict(kernels.LAUNCHES)
    n = beam["batches"] - 1
    expect = {"gru_seq": n, "decode_attention": n * beam["max_len"],
              "decode_attention_multi": n * beam["max_len"], "lstm_seq": 0}
    for k, want in expect.items():
        assert launches[k] == want, (f"beam decode: {k} launched "
                                     f"{launches[k]} times in {n} batches; "
                                     f"the path launches it {want} times")
    for seqs, scores in outs:
        _check_beams("beam decode", seqs, scores, cfg["dict_size"])
        assert seqs.shape == (cfg["batch"], beam["max_len"],
                              beam["beam_size"]), seqs.shape
    med = float(np.median(secs))
    positions = cfg["batch"] * beam["max_len"]
    is_eos = [s[:, :, 0] == beam["eos_id"] for s, _ in outs]
    ended = float(np.mean([e.any(1).mean() for e in is_eos]))
    # a best beam's tokens: up to and including its first eos, else all
    emitted = float(np.mean([np.where(e.any(1), e.argmax(1) + 1,
                                      beam["max_len"]).sum()
                             for e in is_eos]))
    log(f"  {n} batches of {cfg['batch']} sources (lengths "
        f"{cfg['src_lo']}-{cfg['src_len']}), beam {beam['beam_size']}, "
        f"{beam['max_len']} steps, each under set_sync_debug_mode('error')"
        f": {med:.4f} s/batch median (all {[round(x, 4) for x in secs]}), "
        f"{positions / med:.1f} beam positions/s (B x max_len); "
        f"{emitted / med:.1f} emitted tokens/s (best beams up to their "
        f"eos, {emitted / cfg['batch']:.2f} tokens a row); best-beam "
        f"scores median {float(np.median(outs[0][1][:, 0])):.3f}; share of "
        f"best beams that emitted eos {ended:.3f}")
    log(f"  launches: {launches}")

    prof = _profile_one("a decode batch", lambda: decode(1))
    return {"s_per_batch_median": med, "s_per_batch": secs,
            "beam_positions_per_s": positions / med,
            "emitted_tokens_per_s": emitted / med,
            "emitted_tokens_per_row": emitted / cfg["batch"],
            "best_beams_ended_on_eos": ended, "launches": launches,
            "profile": prof}


def _srl_net(ptt, cfg):
    """tests/test_book.py:178-243's network up to the emission: embedding
    -> fc -> dynamic_lstm forward and reverse -> concat -> fc."""
    L = ptt.layers
    seq = L.sequence
    words = L.data("words", shape=[cfg["max_len"]], dtype="int64",
                   lod_level=1)
    label = L.data("label", shape=[cfg["max_len"]], dtype="int64")
    length = seq.get_seqlen(words)
    emb = seq.tag_sequence(
        L.embedding(words, size=[cfg["vocab"], cfg["emb"]]), length)
    fwd_in = seq.tag_sequence(
        L.fc(emb, size=cfg["size"], num_flatten_dims=2), length)
    bwd_in = seq.tag_sequence(
        L.fc(emb, size=cfg["size"], num_flatten_dims=2), length)
    fwd, _ = seq.dynamic_lstm(fwd_in, size=cfg["size"])
    bwd, _ = seq.dynamic_lstm(bwd_in, size=cfg["size"], is_reverse=True)
    hidden = seq.tag_sequence(L.concat([fwd, bwd], axis=2), length)
    emission = L.fc(hidden, size=cfg["labels"], num_flatten_dims=2)
    return emission, label, length


def _srl_program(ptt, cfg):
    """The BiLSTM-CRF trained by linear_chain_crf's negative
    log-likelihood with Adam(lr), the transition named srl_crfw."""
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        emission, label, length = _srl_net(ptt, cfg)
        cost = ptt.layers.linear_chain_crf(
            emission, label, length, param_attr=ptt.ParamAttr(
                name="srl_crfw"))
        loss = ptt.layers.mean(cost)
        ptt.optimizer.Adam(learning_rate=cfg["lr"]).minimize(loss)
    return main, start, loss


def _srl_decode_program(ptt, cfg):
    """The same network with crf_decoding against the trained srl_crfw
    and chunk_eval (plain scheme, one chunk type a label). Returns
    (program, [path, precision, recall, f1, inferred, labelled, correct])
    ."""
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        emission, label, length = _srl_net(ptt, cfg)
        seq = ptt.layers.sequence
        path = seq.crf_decoding(emission, length, param_attr=ptt.ParamAttr(
            name="srl_crfw"))
        evals = seq.chunk_eval(path, label, length, chunk_scheme="plain",
                               num_chunk_types=cfg["labels"])
    return main, [path] + list(evals)


def _srl_feeds(rng, cfg, n, split="train"):
    """Batches from the port's conll05 generator (data/datasets.py): the
    word slot padded with 0 to max_len, its lengths, and the labels
    words % labels (tests/test_book.py's learnable rule)."""
    import numpy as np
    from paddle_tpu_torch.data import datasets
    b, t = cfg["batch"], cfg["max_len"]
    reader = getattr(datasets.conll05, split)(n * b)()
    feeds = []
    for _ in range(n):
        words = np.zeros((b, t), "int64")
        lens = np.zeros((b,), "int32")
        for i in range(b):
            w = next(reader)[0][:t] % cfg["vocab"]
            words[i, :len(w)] = w
            lens[i] = len(w)
        feeds.append({"words": words, "words@SEQLEN": lens,
                      "label": words % cfg["labels"]})
    return feeds


def _run_steps_no_sync(exe, main, scope, loss, dev, steps):
    """`steps` steps over the device feeds `dev` in turn; steps 2.. under
    torch.cuda.set_sync_debug_mode("error"). (losses, seconds)."""
    import torch
    losses, secs = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        if i:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out, = exe.run(main, feed=dev[i % len(dev)], fetch_list=[loss],
                           scope=scope, return_numpy=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(out)
    return [float(x) for x in losses], secs


def train_srl(ptt, kernels):
    """Phase 33: the BiLSTM-CRF at the book's widths on conll05's sizes,
    SRL_STEPS Adam steps over SRL["batches"] batches (feeds on the card);
    step 1 plans, steps 2-N each run under
    torch.cuda.set_sync_debug_mode("error"): the CRF's forward algorithm,
    its gradient and the LSTMs read no length on the host. K5 must launch
    twice a step (both directions; counted from zero around the run).
    Then Viterbi decoding and chunk_eval on a held-out batch of conll05's
    test split, also under sync-debug "error": the share of tags right
    and the chunk F1."""
    import numpy as np
    import torch
    cfg = SRL
    cuda = ptt.CUDAPlace(0)
    main, start, loss = _srl_program(ptt, cfg)
    types = [op.type for op in main.global_block().ops]
    assert types.count("dynamic_lstm") == 2 and \
        types.count("linear_chain_crf") == 1, types
    scope = ptt.Scope()
    exe = ptt.Executor(cuda)
    exe.run(start, scope=scope)
    feeds = _srl_feeds(np.random.RandomState(SEED + 30), cfg, cfg["batches"])
    dev = [{k: torch.from_numpy(v).to(exe.device) for k, v in f.items()}
           for f in feeds]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses, secs = _run_steps_no_sync(exe, main, scope, loss, dev, SRL_STEPS)
    launches = dict(kernels.LAUNCHES)
    assert launches["lstm_seq"] == 2 * SRL_STEPS, (
        f"BiLSTM-CRF: lstm_seq launched {launches['lstm_seq']} times in "
        f"{SRL_STEPS} steps; the path launches it {2 * SRL_STEPS} times")
    assert launches["gru_seq"] == launches["decode_attention"] == 0, launches
    st = np.asarray(secs[1:]) * 1e3
    k = len(feeds)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    tokens = int(np.mean([f["words@SEQLEN"].sum() for f in feeds]))
    log(f"  BiLSTM-CRF, Adam: {SRL_STEPS} steps, {cfg['batch']} examples "
        f"({tokens} tokens)/step: step time median {np.median(st):.2f} ms, "
        f"p95 {np.percentile(st, 95):.2f} ms (steps 2-{SRL_STEPS} under "
        f"set_sync_debug_mode('error'); step 1 {secs[0] * 1e3:.1f} ms), "
        f"{cfg['batch'] / (np.median(st) / 1e3):.1f} examples/s; loss step "
        f"1 {losses[0]:.4f}, step {SRL_STEPS} {losses[-1]:.4f} (mean over "
        f"the {k} batches: first pass {first:.4f}, last pass {last:.4f})")
    log(f"  launches: {launches}")
    assert all(math.isfinite(x) for x in losses), losses
    assert last < first, f"BiLSTM-CRF: the loss did not fall: {losses}"
    prof = _profile_one("a BiLSTM-CRF step", lambda: exe.run(
        main, feed=dev[0], fetch_list=[loss], scope=scope,
        return_numpy=False))

    dmain, evals = _srl_decode_program(ptt, cfg)
    held = _srl_feeds(np.random.RandomState(SEED + 31), cfg, 1, "test")[0]
    hdev = {k: torch.from_numpy(v).to(exe.device) for k, v in held.items()}
    exe.run(dmain, feed=hdev, fetch_list=evals, scope=scope)    # plans
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = exe.run(dmain, feed=hdev, fetch_list=evals, scope=scope,
                      return_numpy=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    path, prec, rec, f1, n_inf, n_lab, n_cor = [t.cpu().numpy()
                                                for t in got]
    valid = np.arange(cfg["max_len"])[None] < held["words@SEQLEN"][:, None]
    acc = float((path == held["label"])[valid].mean())
    assert ((path >= 0) & (path < cfg["labels"])).all()
    assert (path[~valid] == 0).all()
    log(f"  held-out batch (conll05 test split), decoded under "
        f"set_sync_debug_mode('error'): Viterbi accuracy {acc:.4f}, chunk "
        f"precision {float(prec[0]):.4f} recall {float(rec[0]):.4f} F1 "
        f"{float(f1[0]):.4f} ({int(n_cor[0])} of {int(n_lab[0])} chunks "
        f"found, {int(n_inf[0])} inferred)")
    return {"step_ms_median": float(np.median(st)),
            "step_ms_p95": float(np.percentile(st, 95)),
            "examples_per_s": cfg["batch"] / (np.median(st) / 1e3),
            "loss_first": losses[0], "loss_last": losses[-1],
            "viterbi_accuracy": acc, "chunk_f1": float(f1[0]),
            "launches": launches, "profile": prof}


def _nmt_infer_reference(ptt):
    """Phase 32's graph at test width (B 8, Ts 5, K 3, V 24, H 32) with
    the same random parameters on the card and the CPU: scores at 1e-5
    and sequences equal (a parting would have to be a near-tie: none is
    allowed here)."""
    import numpy as np
    from paddle_tpu_torch.framework.executor import as_numpy
    cfg = NMT_INFER_SMALL
    main, start, fetch = _nmt_infer_program(ptt, cfg, cfg)
    gscope = ptt.Scope()
    gpu = ptt.Executor(ptt.CUDAPlace(0))
    gpu.run(start, scope=gscope)
    cscope = ptt.load_numpy_params(
        {n: as_numpy(gscope.get(n)) for n in gscope.local_var_names()},
        ptt.Scope(), ptt.CPUPlace())
    feed = _nmt_feeds(np.random.RandomState(SEED + 32), cfg, 1)[0]
    feed = {k: feed[k] for k in ("src", "src_lens")}
    g = gpu.run(main, feed=feed, fetch_list=fetch, scope=gscope)
    c = ptt.Executor(ptt.CPUPlace()).run(main, feed=feed, fetch_list=fetch,
                                         scope=cscope)
    _check_beams("small decode", *g, cfg["dict_size"])
    np.testing.assert_allclose(g[1], c[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(g[0], c[0])
    log(f"  infer_net small (B {cfg['batch']}, Ts {cfg['src_len']}, K "
        f"{cfg['beam_size']}, V {cfg['dict_size']}, H {cfg['hidden_dim']})"
        f": card and CPU decode the same sequences, scores within "
        f"{float(np.abs(g[1] - c[1]).max()):.2e}")


def _srl_reference(ptt):
    """Phase 33's graph at test width: 3 Adam steps card against CPU (as
    phase 13), then the decode program on both from the card's trained
    state: Viterbi paths and chunk counts equal."""
    import numpy as np
    from paddle_tpu_torch.framework.executor import as_numpy
    cfg = SRL_SMALL
    gscope = _card_against_cpu(ptt, "BiLSTM-CRF", cfg, _srl_program,
                               _srl_feeds)
    cscope = ptt.load_numpy_params(
        {n: as_numpy(gscope.get(n)) for n in gscope.local_var_names()},
        ptt.Scope(), ptt.CPUPlace())
    dmain, evals = _srl_decode_program(ptt, cfg)
    held = _srl_feeds(np.random.RandomState(SEED + 33), cfg, 1, "test")[0]
    g = ptt.Executor(ptt.CUDAPlace(0)).run(dmain, feed=held,
                                           fetch_list=evals, scope=gscope)
    c = ptt.Executor(ptt.CPUPlace()).run(dmain, feed=held, fetch_list=evals,
                                         scope=cscope)
    for v, a, b in zip(evals, g, c):
        np.testing.assert_array_equal(a, b, err_msg=v.name)
    log(f"  BiLSTM-CRF small: Viterbi paths and chunk counts equal on card "
        f"and CPU ({int(g[6][0])} of {int(g[5][0])} chunks right)")


def _control_flow_programs(ptt):
    """tests/test_control_flow.py's programs built with the port:
    name -> (build() -> fetch list, feed, expected or None)."""
    import numpy as np
    from paddle_tpu_torch.layers import control_flow as cf
    L = ptt.layers
    r = np.random.RandomState(SEED + 34)
    x64 = r.rand(2, 6, 4).astype("float32")

    def while_counts():
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 10)
        total = L.fill_constant([1], "float32", 0.0)
        c = L.less_than(i, n)
        w = cf.While(c)
        with w.block():
            L.assign(L.elementwise_add(total, L.cast(i, "float32")),
                     output=total)
            L.assign(L.increment(i, value=1), output=i)
            L.less_than(i, n, cond=c)
        return [total, i]

    def dynamic_rnn():
        x = L.data(name="x", shape=[6, 4], lod_level=1)
        zero = L.fill_constant_batch_size_like(x, [-1, 4], "float32", 0.0)
        drnn = cf.DynamicRNN()
        with drnn.block():
            xt = drnn.step_input(x)
            acc = drnn.memory(init=zero)
            s = L.elementwise_add(acc, xt)
            drnn.update_memory(acc, s)
            drnn.step_output(s)
        return [drnn(), drnn.final_memories()]

    def ifelse():
        x = L.data(name="x", shape=[4])
        flag = L.data(name="flag", shape=[1], dtype="bool")
        ie = cf.IfElse(flag)
        with ie.true_block():
            ie.output(L.scale(x, scale=2.0))
        with ie.false_block():
            ie.output(L.scale(x, scale=-1.0))
        return ie()

    def lazy_cond():
        pred = L.fill_constant([1], "bool", True)
        a = L.fill_constant([2], "float32", 3.0)
        b = L.fill_constant([2], "float32", 5.0)
        return [cf.cond(pred, lambda: L.elementwise_add(a, b),
                        lambda: L.elementwise_sub(a, b))]

    def switch():
        step = L.fill_constant([1], "float32", 7.0)
        b1 = L.fill_constant([1], "float32", 5.0)
        b2 = L.fill_constant([1], "float32", 10.0)
        lr = L.create_tensor("float32", name="lr_value")
        sw = cf.Switch()
        with sw.case(L.less_than(step, b1)):
            L.assign(L.fill_constant([1], "float32", 0.1), output=lr)
        with sw.case(L.less_than(step, b2)):
            L.assign(L.fill_constant([1], "float32", 0.01), output=lr)
        with sw.default():
            L.assign(L.fill_constant([1], "float32", 0.001), output=lr)
        return [sw.finish(lr)]

    def arrays():
        x = L.data("x", shape=[4])
        arr = cf.create_array("float32", max_len=3, shape=[2, 4])
        i0 = L.fill_constant([], "int64", 0)
        i1 = L.fill_constant([], "int64", 1)
        arr = cf.array_write(x, i0, arr)
        arr = cf.array_write(x * 2.0, i1, arr)
        return [cf.array_read(arr, i0), cf.array_read(arr, i1),
                cf.array_length(arr)]

    xa = r.rand(2, 4).astype("float32")
    xi = r.rand(6, 4).astype("float32")
    flag = np.array([[1], [0], [1], [0], [1], [0]], bool)
    return {
        "While counting to ten": (while_counts, {},
                                  [[45.0], [10]]),
        "DynamicRNN with lengths": (
            dynamic_rnn, {"x": x64, "x@SEQLEN": np.array([3, 6], "int32")},
            [None, np.stack([x64[0, :3].sum(0), x64[1].sum(0)])]),
        "IfElse mask merge": (ifelse, {"x": xi, "flag": flag},
                              [np.where(flag, 2 * xi, -xi)]),
        "lazy_cond": (lazy_cond, {}, [[8.0, 8.0]]),
        "Switch piecewise": (switch, {}, [[0.01]]),
        "tensor arrays": (arrays, {"x": xa}, [xa, 2 * xa, 3]),
    }


def _control_flow_reference(ptt):
    """The control-flow programs on the card and on the CPU: values
    equal (at 1e-6) and as tests/test_control_flow.py states them."""
    import numpy as np
    for name, (build, feed, want) in _control_flow_programs(ptt).items():
        main, start = ptt.Program(), ptt.Program()
        with ptt.program_guard(main, start), ptt.unique_name.guard():
            fetch = build()
        got = []
        for place in (ptt.CUDAPlace(0), ptt.CPUPlace()):
            exe, scope = ptt.Executor(place), ptt.Scope()
            exe.run(start, scope=scope)
            got.append(exe.run(main, feed=feed, fetch_list=fetch,
                               scope=scope))
        for a, b, w in zip(got[0], got[1], want):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
            if w is not None:
                np.testing.assert_allclose(a, np.asarray(w), rtol=1e-5,
                                           err_msg=name)
        log(f"  {name}: card = CPU, as tests/test_control_flow.py states")


def _slice_op_cases():
    """This slice's ops on tie, NaN, boundary and empty inputs (and a
    random draw each): (label, op type, numpy inputs, attrs)."""
    import numpy as np
    r = np.random.RandomState(SEED + 35)

    def f32(*shape):
        return r.randn(*shape).astype("float32")

    lp = np.log(r.dirichlet(np.ones(6), (2, 3))).astype("float32")
    return [
        ("beam_search", "beam_search",
         {"PreIds": np.array([[3, 1, 4], [0, 2, 2]]),
          "PreScores": np.array([[-0.5, -0.7, -1e9], [0.0, -1e9, -1e9]],
                                "float32"), "Scores": lp},
         {"beam_size": 3, "end_id": 1}),
        ("beam_search ties", "beam_search",
         {"PreIds": np.array([[2, 2, 2]]),
          "PreScores": np.zeros((1, 3), "float32"),
          "Scores": np.full((1, 3, 4), -1.25, "float32")},
         {"beam_size": 3, "end_id": 1}),
        ("beam_search NaN", "beam_search",
         {"PreIds": np.array([[0, 3]]),
          "PreScores": np.array([[0.0, -1.0]], "float32"),
          "Scores": np.array([[[-1.0, np.nan, -2.0], [-0.5, -np.inf, -3.0]]],
                             "float32")}, {"beam_size": 2, "end_id": 1}),
        ("gather_tree out-of-range parents", "gather_tree",
         {"Ids": np.arange(12).reshape(1, 4, 3),
          "Parents": np.array([[[0, 1, 2], [5, -1, 0], [2, 2, 1],
                                [-4, 0, 1]]])}, {}),
        ("expand", "expand", {"X": f32(2, 1, 3)},
         {"expand_times": [1, 4, 1]}),
        ("array_write past the end", "array_write",
         {"Array": f32(3, 2), "X": f32(2), "I": np.array([5])}, {}),
        ("array_read negative", "array_read",
         {"Array": f32(3, 2), "I": np.array(-1)}, {}),
        ("not_equal NaN", "not_equal",
         {"X": np.array([1.0, np.nan, 0.0], "float32"),
          "Y": np.array([1.0, np.nan, -0.0], "float32")}, {}),
        ("logical_xor", "logical_xor",
         {"X": np.array([[True], [False]]),
          "Y": np.array([True, False, True])}, {}),
        ("is_empty empty", "is_empty", {"X": np.zeros((0, 3), "float32")},
         {}),
        ("where", "where", {"Condition": np.array([[True], [False]]),
                            "X": f32(2, 3), "Y": f32(2, 3)}, {}),
        ("linear_chain_crf lengths 5, 3, 1, 0", "linear_chain_crf",
         {"Emission": f32(4, 5, 3), "Transition": f32(5, 3),
          "Label": r.randint(0, 3, (4, 5)),
          "Length": np.array([5, 3, 1, 0])}, {}),
        ("crf_decoding ties", "crf_decoding",
         {"Emission": np.zeros((2, 4, 3), "float32"),
          "Transition": np.zeros((5, 3), "float32"),
          "Length": np.array([4, 0])}, {}),
        ("crf_decoding label", "crf_decoding",
         {"Emission": f32(2, 5, 3), "Transition": f32(5, 3),
          "Length": np.array([5, 2]), "Label": r.randint(0, 3, (2, 5))},
         {}),
        ("chunk_eval IOE", "chunk_eval",
         {"Inference": np.array([[0, 1, 2, 3, 4], [1, 1, 0, 4, 3]]),
          "Label": np.array([[0, 1, 2, 2, 3], [1, 0, 0, 4, 3]]),
          "Length": np.array([5, 4])},
         {"chunk_scheme": "IOE", "num_chunk_types": 2,
          "excluded_chunk_types": []}),
        ("chunk_eval empty", "chunk_eval",
         {"Inference": np.array([[0, 1]]), "Label": np.array([[0, 1]]),
          "Length": np.array([0])},
         {"chunk_scheme": "IOB", "num_chunk_types": 1,
          "excluded_chunk_types": []}),
        ("dynamic_lstmp", "dynamic_lstmp",
         {"Input": f32(3, 4, 8), "Weight": f32(3, 8) * 0.5,
          "ProjWeight": f32(2, 3) * 0.5, "Bias": f32(14) * 0.5,
          "SeqLen": np.array([4, 2, 0], "int32")},
         {"use_peepholes": True, "proj_activation": "tanh"}),
        ("lstm_unit", "lstm_unit", {"X": f32(3, 8), "C_prev": f32(3, 2)},
         {"forget_bias": 1.0}),
        ("gru_unit", "gru_unit",
         {"Input": f32(3, 6), "HiddenPrev": f32(3, 2),
          "Weight": f32(2, 6), "Bias": f32(6)}, {}),
        ("sequence_softmax empty row", "sequence_softmax",
         {"X": f32(3, 5), "SeqLen": np.array([5, 2, 0], "int32")}, {}),
        ("sequence_reverse", "sequence_reverse",
         {"X": f32(3, 4, 2), "SeqLen": np.array([4, 2, 0], "int32")}, {}),
        ("sequence_slice past T", "sequence_slice",
         {"X": f32(3, 5, 2), "Offset": np.array([[0], [2], [4]])},
         {"length": 2}),
        ("edit_distance", "edit_distance",
         {"Hyps": np.array([[1, 2, 3, 4], [5, 5, 0, 0], [7, 8, 9, 1]]),
          "Refs": np.array([[1, 3, 4], [5, 6, 5], [1, 1, 1]]),
          "HypsLen": np.array([4, 2, 0]), "RefsLen": np.array([3, 3, 2])},
         {"normalized": True}),
        ("sequence_conv", "sequence_conv",
         {"X": f32(2, 5, 3), "Filter": f32(9, 4),
          "SeqLen": np.array([5, 2], "int32")},
         {"contextLength": 3, "contextStart": -1, "contextStride": 1}),
        ("row_conv", "row_conv", {"X": f32(2, 5, 3), "Filter": f32(3, 3)},
         {}),
    ]


def _ops_reference(cases, label, card=None):
    """Each case's lowering on tensors on the card (`card`, default
    cuda:0) against the same lowering on CPU tensors: integers and
    booleans equal, floats at 1e-5 (NaN where NaN)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.framework import registry
    card = card or torch.device("cuda", 0)
    for case, op_type, ins, attrs in cases:
        outs = []
        for dev in (card, torch.device("cpu")):
            t = {s: [torch.as_tensor(np.asarray(a)).to(dev)]
                 for s, a in ins.items()}
            o = registry.lookup_op(op_type).lower(
                registry.LowerCtx(device=dev), t, dict(attrs))
            outs.append({s: [v.detach().cpu().numpy() for v in vs]
                         for s, vs in o.items()})
        g, c = outs
        assert set(g) == set(c), case
        for slot in g:
            for a, b in zip(g[slot], c[slot]):
                assert a.dtype == b.dtype and a.shape == b.shape, \
                    (case, slot)
                if a.dtype.kind in "biu":
                    np.testing.assert_array_equal(a, b,
                                                  err_msg=f"{case} {slot}")
                else:
                    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                               equal_nan=True,
                                               err_msg=f"{case} {slot}")
    log(f"  {len(cases)} cases of {label}: card = CPU")


def _slice_ops_reference(card=None):
    """Phase 34's op cases, card (default cuda:0) against CPU."""
    _ops_reference(_slice_op_cases(), "the recurrent slice's ops (ties, "
                   "NaN, out-of-range indices, empty rows and batches)",
                   card)


def recurrent_rest_reference_check(ptt):
    """Phase 34: phases 32 and 33's graphs at test width, the control-flow
    programs and this slice's ops, card against CPU, float32 with TF32
    off."""
    _nmt_infer_reference(ptt)
    _srl_reference(ptt)
    _control_flow_reference(ptt)
    _slice_ops_reference()
    return {"ok": True}


# ---- phases 35-37: SSD detection and CRNN-CTC OCR ------------------------


def _ssd_program(ptt, cfg, is_test=False):
    """models/ssd.py's detector at cfg's width: (program, startup, loss)
    trained by Adam(lr), or with is_test (no loss, no ground truth) the
    decode program, (program, [detections, counts])."""
    from paddle_tpu_torch.models import ssd
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        loss, head = ssd.ssd_detector(
            num_classes=cfg["num_classes"],
            image_shape=(3, cfg["image"], cfg["image"]),
            num_gt=cfg["num_gt"], is_test=is_test)
        if is_test:
            out, num = ssd.ssd_decode(*head)
            return main, [out, num]
        ptt.optimizer.Adam(learning_rate=cfg["lr"]).minimize(loss)
    return main, start, loss


def _ssd_feeds(rng, cfg, n):
    """n batches: each image noise with 1..num_gt boxes (corners in
    [0, 1], sides 0.1-0.5) painted in their class's colour, labels
    1..classes-1; the rows past an image's boxes zero-area padding."""
    import numpy as np
    b, g, s, c = cfg["batch"], cfg["num_gt"], cfg["image"], \
        cfg["num_classes"]
    colours = np.random.RandomState(SEED + 50).uniform(0, 1, (c, 3))
    feeds = []
    for _ in range(n):
        img = (rng.rand(b, 3, s, s) * 0.3).astype("float32")
        gb = np.zeros((b, g, 4), "float32")
        gl = np.zeros((b, g), "int64")
        for i in range(b):
            k = rng.randint(1, g + 1)
            wh = rng.uniform(0.1, 0.5, (k, 2))
            lo = rng.uniform(0, 1, (k, 2)) * (1 - wh)
            gb[i, :k] = np.concatenate([lo, lo + wh], 1)
            gl[i, :k] = rng.randint(1, c, k)
            for j in range(k):
                x1, y1, x2, y2 = (gb[i, j] * s).astype(int)
                img[i, :, y1:y2, x1:x2] += colours[gl[i, j]][:, None, None]
        feeds.append({"img": img, "gt_box": gb, "gt_label": gl})
    return feeds


def _step_report(label, cfg, losses, secs, unit, steps):
    import numpy as np
    st = np.asarray(secs[1:]) * 1e3
    k = cfg["batches"]
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    log(f"  {label}, Adam: {steps} steps, batch {cfg['batch']}: step time "
        f"median {np.median(st):.2f} ms, p95 {np.percentile(st, 95):.2f} ms "
        f"(steps 2-{steps} under set_sync_debug_mode('error'); step 1 "
        f"{secs[0] * 1e3:.1f} ms), "
        f"{cfg['batch'] / (np.median(st) / 1e3):.1f} {unit}/s; loss step 1 "
        f"{losses[0]:.4f}, step {steps} {losses[-1]:.4f} (mean over the {k} "
        f"batches: first pass {first:.4f}, last pass {last:.4f})")
    assert all(math.isfinite(x) for x in losses), losses
    assert last < first, f"{label}: the loss did not fall: {losses}"
    return {"step_ms_median": float(np.median(st)),
            "step_ms_p95": float(np.percentile(st, 95)),
            f"{unit}_per_s": cfg["batch"] / (np.median(st) / 1e3),
            "loss_first": losses[0], "loss_last": losses[-1],
            "loss_first_pass": first, "loss_last_pass": last}


def train_ssd(ptt, kernels):
    """Phase 35: SSD at its defaults, SSD_STEPS Adam steps (step 1 plans;
    the rest under sync-debug "error": matching, mining and the loss read
    nothing on the host); no hand-written kernel lies on this path (every
    detection op is torch calls), so none may launch. A profiled step.
    Then ssd_decode (decode + NMS over every image and class at once) on a
    held-out batch, SSD_DECODES timed runs under sync-debug "error": ms a
    batch, detections an image, and DetectionMAP (metrics.py, integral AP
    at IoU 0.5) against the batch's boxes."""
    import numpy as np
    import torch
    cfg = SSD
    cuda = ptt.CUDAPlace(0)
    main, start, loss = _ssd_program(ptt, cfg)
    types = [op.type for op in main.global_block().ops]
    assert types.count("ssd_loss") == 1 and types.count("prior_box") == 3, \
        types
    scope = ptt.Scope()
    exe = ptt.Executor(cuda)
    exe.run(start, scope=scope)
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    feeds = _ssd_feeds(np.random.RandomState(SEED + 51), cfg, cfg["batches"])
    dev = [{k: torch.from_numpy(v).to(exe.device) for k, v in f.items()}
           for f in feeds]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses, secs = _run_steps_no_sync(exe, main, scope, loss, dev, SSD_STEPS)
    launches = dict(kernels.LAUNCHES)
    assert not any(launches.values()), launches
    op = next(o for o in main.global_block().ops if o.type == "ssd_loss")
    n_priors = main.global_block().var(op.inputs["PriorBox"][0]).shape[0]
    res = _step_report(f"SSD ({n_params} parameters, {n_priors} priors)",
                       cfg, losses, secs, "images", SSD_STEPS)
    res.update(parameters=n_params, priors=n_priors)
    res["profile"] = _profile_one("an SSD step", lambda: exe.run(
        main, feed=dev[0], fetch_list=[loss], scope=scope,
        return_numpy=False))

    dmain, fetch = _ssd_program(ptt, cfg, is_test=True)
    held = _ssd_feeds(np.random.RandomState(SEED + 52), cfg, 1)[0]
    himg = {"img": torch.from_numpy(held["img"]).to(exe.device)}
    exe.run(dmain, feed=himg, fetch_list=fetch, scope=scope)     # plans
    torch.cuda.synchronize()
    dsecs = []
    for _ in range(SSD_DECODES):
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = exe.run(dmain, feed=himg, fetch_list=fetch, scope=scope,
                          return_numpy=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        dsecs.append(time.perf_counter() - t0)
    rows, num = (t.cpu().numpy() for t in got)
    assert rows.shape == (cfg["batch"], 100, 6), rows.shape
    assert ((num >= 0) & (num <= 100)).all()
    dets = np.concatenate([rows[i, :num[i]] for i in range(len(num))])
    assert np.isfinite(dets).all()
    assert ((dets[:, 0] >= 1) & (dets[:, 0] < cfg["num_classes"])).all()
    assert (np.diff(rows[..., 1], axis=1)[rows[:, 1:, 0] >= 0] <= 0).all()
    valid = held["gt_box"][..., 2] > held["gt_box"][..., 0]
    gts = np.concatenate([np.concatenate(
        [held["gt_label"][i, valid[i], None].astype("float32"),
         held["gt_box"][i, valid[i]]], 1) for i in range(cfg["batch"])])
    metric = ptt.metrics.DetectionMAP(overlap_threshold=0.5)
    metric.update(dets, num.tolist(), gts, valid.sum(1).tolist())
    m_ap = metric.eval()
    ms = float(np.median(dsecs)) * 1e3
    log(f"  ssd_decode, batch {cfg['batch']}, under set_sync_debug_mode("
        f"'error'): {ms:.1f} ms a batch (median of "
        f"{', '.join(f'{x * 1e3:.1f}' for x in dsecs)}), "
        f"{float(num.mean()):.1f} detections an image, DetectionMAP "
        f"{m_ap:.4f} against the batch's {int(valid.sum())} boxes")
    res.update(decode_ms=ms, detections_per_image=float(num.mean()),
               detection_map=m_ap, launches=launches)
    return res


def _crnn_program(ptt, cfg, is_test=False):
    """models/ocr_crnn.py's recognizer at cfg's width: (program, startup,
    loss) trained by Adam(lr), or with is_test the greedy CTC decode
    program, (program, [decoded, decoded length, per-column
    probabilities])."""
    from paddle_tpu_torch.models import ocr_crnn
    L = ptt.layers
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        loss, logits, seqlen = ocr_crnn.crnn_ctc(
            num_classes=cfg["num_classes"],
            image_shape=(1, cfg["height"], cfg["width"]),
            max_label_len=cfg["max_label_len"], hidden=cfg["hidden"],
            is_test=is_test)
        if is_test:
            probs = L.softmax(logits)
            dec, dec_len = L.sequence.ctc_greedy_decoder(
                probs, blank=cfg["num_classes"], input_length=seqlen)
            return main, [dec, dec_len, probs]
        ptt.optimizer.Adam(learning_rate=cfg["lr"]).minimize(loss)
    return main, start, loss


def _crnn_feeds(rng, cfg, n):
    """n batches of max_label_len labels each and images drawn from them:
    label j owns columns [j w/L, (j+1) w/L), filled with its class's row
    pattern (a fixed random height-vector a class) plus noise."""
    import numpy as np
    b, h, w, nl = cfg["batch"], cfg["height"], cfg["width"], \
        cfg["max_label_len"]
    pattern = np.random.RandomState(SEED + 60).randn(cfg["num_classes"], h)
    cols = w // nl
    feeds = []
    for _ in range(n):
        label = rng.randint(0, cfg["num_classes"], (b, nl)).astype("int64")
        img = np.repeat(pattern[label].transpose(0, 2, 1), cols, axis=2)
        img = img + rng.randn(b, h, nl * cols) * 0.3
        feeds.append({"img": img[:, None].astype("float32"),
                      "label": label})
    return feeds


def _ctc_accuracy(ptt, dec, dec_len, label):
    """(character accuracy, sequence accuracy) of greedy decodes against
    their labels: edit distances by the port's edit_distance op, summed by
    metrics.EditDistance."""
    import numpy as np
    import torch
    from paddle_tpu_torch.framework import registry
    b, nl = label.shape
    dist = registry.lookup_op("edit_distance").lower(
        registry.LowerCtx(), {
            "Hyps": [torch.as_tensor(dec)], "Refs": [torch.as_tensor(label)],
            "HypsLen": [torch.as_tensor(dec_len).reshape(-1)],
            "RefsLen": [torch.full((b,), nl, dtype=torch.int64)]},
        {"normalized": False})
    metric = ptt.metrics.EditDistance()
    metric.update(dist["Out"][0].numpy(), dist["SequenceNum"][0].numpy())
    avg, instance_error = metric.eval()
    return 1.0 - avg / nl, 1.0 - instance_error


def train_crnn(ptt, kernels):
    """Phase 36: CRNN-CTC at its defaults, CRNN_STEPS Adam steps (step 1
    plans; the rest under sync-debug "error": the CTC forward algorithm
    and its gradient read nothing on the host). K6 must launch twice a
    step (the forward and the reversed GRU; their backward is plain
    PyTorch), nothing else. A profiled step. Then the greedy CTC decode
    of a held-out batch under sync-debug "error": character and sequence
    accuracy."""
    import numpy as np
    import torch
    cfg = CRNN
    cuda = ptt.CUDAPlace(0)
    main, start, loss = _crnn_program(ptt, cfg)
    types = [op.type for op in main.global_block().ops]
    assert types.count("dynamic_gru") == 2 and types.count("warpctc") == 1, \
        types
    scope = ptt.Scope()
    exe = ptt.Executor(cuda)
    exe.run(start, scope=scope)
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    feeds = _crnn_feeds(np.random.RandomState(SEED + 61), cfg,
                        cfg["batches"])
    dev = [{k: torch.from_numpy(v).to(exe.device) for k, v in f.items()}
           for f in feeds]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses, secs = _run_steps_no_sync(exe, main, scope, loss, dev,
                                      CRNN_STEPS)
    launches = dict(kernels.LAUNCHES)
    assert launches["gru_seq"] == 2 * CRNN_STEPS, (
        f"CRNN: gru_seq launched {launches['gru_seq']} times in "
        f"{CRNN_STEPS} steps; the path launches it {2 * CRNN_STEPS} times")
    assert sum(launches.values()) == launches["gru_seq"], launches
    res = _step_report(f"CRNN-CTC ({n_params} parameters, T "
                       f"{cfg['width'] // 4}, K6 at H {cfg['hidden']})", cfg,
                       losses, secs, "examples", CRNN_STEPS)
    log(f"  launches: {launches}")
    res["parameters"] = n_params
    res["profile"] = _profile_one("a CRNN step", lambda: exe.run(
        main, feed=dev[0], fetch_list=[loss], scope=scope,
        return_numpy=False))

    dmain, fetch = _crnn_program(ptt, cfg, is_test=True)
    held = _crnn_feeds(np.random.RandomState(SEED + 62), cfg, 1)[0]
    himg = {"img": torch.from_numpy(held["img"]).to(exe.device)}
    exe.run(dmain, feed=himg, fetch_list=fetch, scope=scope)     # plans
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = exe.run(dmain, feed=himg, fetch_list=fetch, scope=scope,
                      return_numpy=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    dec, dec_len = (t.cpu().numpy() for t in got[:2])
    assert ((dec_len >= 0) & (dec_len <= cfg["width"] // 4)).all()
    for i in range(cfg["batch"]):
        assert ((dec[i, :dec_len[i, 0]] >= 0)
                & (dec[i, :dec_len[i, 0]] < cfg["num_classes"])).all()
    char_acc, seq_acc = _ctc_accuracy(ptt, dec, dec_len, held["label"])
    log(f"  held-out batch of {cfg['batch']}, greedy CTC decode under "
        f"set_sync_debug_mode('error'): character accuracy {char_acc:.4f}, "
        f"sequence accuracy {seq_acc:.4f} (EditDistance), decoded lengths "
        f"{int(dec_len.min())}-{int(dec_len.max())} of "
        f"{cfg['max_label_len']}")
    res.update(char_accuracy=char_acc, seq_accuracy=seq_acc,
               launches=launches)
    return res


def _slice15_op_cases():
    """This slice's ops on the edges that decide their meaning (NMS ties
    and all scores under the threshold, infeasible CTC rows, mod by
    negative divisors, stable-sort ties, matching ties, out-of-range
    scatter indices) and random draws: (label, op type, inputs, attrs)."""
    import numpy as np
    r = np.random.RandomState(SEED + 70)

    def f32(*shape):
        return r.randn(*shape).astype("float32")

    def boxes(*lead):
        a = np.sort(r.uniform(0, 1, lead + (2, 2)), axis=-2)
        return a.reshape(lead + (4,))[..., [0, 2, 1, 3]].astype("float32")

    same = np.float32([[[0, 0, 1, 1], [0, 0, 1, 1], [2, 2, 3, 3]]])
    return [
        ("multiclass_nms", "multiclass_nms",
         {"BBoxes": boxes(2, 40), "Scores": r.uniform(0, 1, (2, 5, 40))
          .astype("float32")}, {"keep_top_k": 30, "nms_threshold": 0.3}),
        ("multiclass_nms ties", "multiclass_nms",
         {"BBoxes": same, "Scores": np.full((1, 2, 3), 0.5, "float32")},
         {"background_label": -1, "keep_top_k": 6}),
        ("multiclass_nms all under the threshold", "multiclass_nms",
         {"BBoxes": boxes(1, 8), "Scores": np.full((1, 3, 8), 0.005,
                                                   "float32")},
         {"keep_top_k": 5}),
        ("bipartite_match ties", "bipartite_match",
         {"DistMat": np.float32([[0.5, 0.5, 0.0], [0.5, 0.5, 0.2]])},
         {"match_type": "per_prediction", "dist_threshold": 0.1}),
        ("ssd_loss", "ssd_loss",
         {"Location": f32(2, 30, 4), "Confidence": f32(2, 30, 4),
          "GTBox": np.concatenate([boxes(2, 3), np.zeros((2, 1, 4),
                                                         "float32")], 1),
          "GTLabel": r.randint(1, 4, (2, 4)), "PriorBox": boxes(30)},
         {"overlap_threshold": 0.3}),
        ("detection_map", "detection_map",
         {"DetectRes": np.concatenate([r.randint(0, 3, (2, 6, 1)),
                                       r.uniform(0, 1, (2, 6, 1)).round(1),
                                       boxes(2, 6)], -1).astype("float32"),
          "Label": np.concatenate([r.randint(0, 3, (2, 3, 1)),
                                   boxes(2, 3)], -1).astype("float32")},
         {"class_num": 3}),
        ("roi_pool", "roi_pool",
         {"X": f32(2, 3, 8, 9),
          "ROIs": np.float32([[0, 0, 0, 7, 6], [1, 2.4, 1.6, 8.6, 7.5],
                              [0, -3, 2, 20, 3]])},
         {"pooled_height": 3, "pooled_width": 2}),
        ("generate_proposals", "generate_proposals",
         {"Scores": r.uniform(0, 1, (2, 30)).astype("float32"),
          "BboxDeltas": f32(2, 30, 4) * 0.3, "Anchors": boxes(30) * 60,
          "ImInfo": np.float32([[64, 64, 1.0], [48, 56, 0.5]])},
         {"pre_nms_top_n": 20, "post_nms_top_n": 8, "min_size": 2.0}),
        ("warpctc with infeasible rows", "warpctc",
         {"Logits": f32(4, 6, 5),
          "Label": np.int64([[1, 2, 3], [2, 2, 0], [1, 2, 3], [3, 3, 3]]),
          "LogitsLength": np.int64([6, 3, 2, 4]),
          "LabelLength": np.int64([3, 2, 3, 3])}, {"blank": 0}),
        ("warpctc blank last, norm_by_times, label length 0", "warpctc",
         {"Logits": f32(3, 5, 5), "Label": np.int64([[0, 1], [2, 2],
                                                     [3, 0]]),
          "LogitsLength": np.int64([5, 5, 2]),
          "LabelLength": np.int64([2, 2, 0])},
         {"blank": 4, "norm_by_times": True}),
        ("ctc_align", "ctc_align",
         {"Input": np.int64([[1, 1, 0, 2, 2, 0, 1], [0, 3, 3, 3, 0, 0, 3]]),
          "InputLength": np.int64([7, 5])}, {"blank": 0}),
        ("im2sequence", "im2sequence", {"X": f32(2, 3, 5, 6)},
         {"kernels": [2, 3], "strides": [1, 2]}),
        ("elementwise_mod by negatives", "elementwise_mod",
         {"X": np.float32([-7.5, 7.5, -3.0, 3.0]),
          "Y": np.float32([2.0, -2.0, -2.0, 2.0])}, {}),
        ("elementwise_mod int by negatives", "elementwise_mod",
         {"X": np.int32([-7, 7, -3, 3]), "Y": np.int32([2, -2, -2, 2])},
         {}),
        ("argsort ties", "argsort",
         {"X": np.float32([[2, 1, 2, 1, 0, 1], [0, 0, 0, 0, 0, 0]])}, {}),
        ("arg_min ties", "arg_min",
         {"X": np.float32([[1, 0, 0, 2], [3, 3, 3, 3]])}, {"axis": 1}),
        ("gelu", "gelu", {"X": f32(3, 7) * 3}, {}),
        ("scatter out of range", "scatter",
         {"X": f32(5, 3), "Ids": np.int64([3, -1, 0, 7]),
          "Updates": f32(4, 3)}, {"overwrite": True}),
        ("bilinear_interp", "bilinear_interp", {"X": f32(1, 2, 8, 9)},
         {"out_h": 3, "out_w": 13}),
        ("hierarchical_sigmoid", "hierarchical_sigmoid",
         {"X": f32(4, 5), "Label": np.int64([[0], [5], [2], [3]]),
          "W": f32(5, 5), "Bias": f32(5, 1)}, {"num_classes": 6}),
        ("auc", "auc",
         {"Predict": r.dirichlet([1, 1], 16).astype("float32"),
          "Label": r.randint(0, 2, (16, 1)),
          "StatPos": np.zeros(201, "float32"),
          "StatNeg": np.zeros(201, "float32")}, {"num_thresholds": 200}),
    ]


def _decode_card_against_cpu(ptt, cfg, gscope, decode, feed):
    """The decode program's fetches on the card and on the CPU from the
    card's state: (card's, CPU's), numpy."""
    from paddle_tpu_torch.framework.executor import as_numpy
    cscope = ptt.load_numpy_params(
        {n: as_numpy(gscope.get(n)) for n in gscope.local_var_names()},
        ptt.Scope(), ptt.CPUPlace())
    dmain, fetch = decode(ptt, cfg, is_test=True)
    g = ptt.Executor(ptt.CUDAPlace(0)).run(dmain, feed=feed,
                                           fetch_list=fetch, scope=gscope)
    c = ptt.Executor(ptt.CPUPlace()).run(dmain, feed=feed, fetch_list=fetch,
                                         scope=cscope)
    return g, c


def _pooled_card_against_cpu(ptt, label, cfg, build, make_feeds, steps=3):
    """Phase 37's training check for the max-pooled models (SSD's four
    and CRNN's four 2x2 max pools): `steps` Adam steps, each from the
    card's state on both devices; the loss at rtol 1e-5 and each gradient
    at a cosine of at least 0.999 and a norm within 1% (gradients below
    1e-5 of the largest are rounding noise). Not element-wise: a pool
    window whose two largest values lie within the devices' float32
    rounding of each other (the convolutions' algorithms differ) sends
    that unit's gradient to another position, which moves every weight
    gradient below it. In one run on an H100, step 3 moved 476 of the
    864 elements of SSD's first weight gradient by up to 2.0e-3 while
    the loss agreed; a rerun found every prior match and mined negative
    equal on both devices at each step. Returns the card's scope."""
    import numpy as np
    from paddle_tpu_torch.framework.executor import as_numpy
    main, start, loss = build(ptt, cfg)
    names = [p.name for p in main.all_parameters()]
    gpu_scope = ptt.Scope()
    gpu = ptt.Executor(ptt.CUDAPlace(0))
    gpu.run(start, scope=gpu_scope)
    cpu = ptt.Executor(ptt.CPUPlace())
    fetch = [loss.name] + [n + "@GRAD" for n in names]
    worst_cos, worst_norm, exact = 1.0, 0.0, []
    for i, feed in enumerate(make_feeds(np.random.RandomState(SEED + 8),
                                        cfg, steps)):
        cpu_scope = ptt.load_numpy_params(
            {n: as_numpy(gpu_scope.get(n))
             for n in gpu_scope.local_var_names()}, ptt.Scope(),
            ptt.CPUPlace())
        g = gpu.run(main, feed=feed, fetch_list=fetch, scope=gpu_scope)
        c = cpu.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
        np.testing.assert_allclose(g[0], c[0], rtol=1e-5,
                                   err_msg=f"{label}: loss, step {i + 1}")
        gmax = max(float(np.abs(cg).max()) for cg in c[1:])
        close = True
        for n, gg, cg in zip(names, g[1:], c[1:]):
            close = close and bool(np.allclose(
                gg, cg, rtol=0, atol=1e-5 * max(1.0, np.abs(cg).max())))
            if max(np.abs(gg).max(), np.abs(cg).max()) <= 1e-5 * gmax:
                continue
            cos = _cosine(gg, cg)
            nrm = abs(float(np.linalg.norm(gg) / np.linalg.norm(cg)) - 1)
            assert cos >= 0.999 and nrm <= 0.01, (label, n, i + 1, cos, nrm)
            worst_cos, worst_norm = min(worst_cos, cos), max(worst_norm, nrm)
        exact.append(close)
        log(f"  {label} step {i + 1}: loss card {float(g[0]):.6f}, CPU "
            f"{float(c[0]):.6f}; every gradient within 1e-5 element-wise: "
            f"{close}")
    log(f"  small {label}, float32, {steps} Adam steps (each from the same "
        f"state): losses agree, {len(names)} gradients held, worst cosine "
        f"{worst_cos:.6f}, worst norm ratio {worst_norm:.2e}")
    return gpu_scope


def ocr_detection_reference_check(ptt):
    """Phase 37: SSD and CRNN at test width in float32, 3 Adam steps card
    against CPU each from the same state (`_pooled_card_against_cpu`),
    then each decode
    from the card's state on both (SSD: labels and counts equal, boxes and
    scores at 1e-5; CRNN: the greedy decodes equal); then this slice's
    ops on their edge inputs, card against CPU."""
    import numpy as np
    gscope = _pooled_card_against_cpu(ptt, "SSD", SSD_SMALL, _ssd_program,
                                      _ssd_feeds)
    held = _ssd_feeds(np.random.RandomState(SEED + 71), SSD_SMALL, 1)[0]
    (grows, gnum), (crows, cnum) = _decode_card_against_cpu(
        ptt, SSD_SMALL, gscope, _ssd_program, {"img": held["img"]})
    np.testing.assert_array_equal(gnum, cnum)
    np.testing.assert_array_equal(grows[..., 0], crows[..., 0])
    np.testing.assert_allclose(grows[..., 1:], crows[..., 1:], rtol=1e-5,
                               atol=1e-5)
    log(f"  SSD small decode: {int(gnum.sum())} detections, labels and "
        f"counts equal, boxes and scores within 1e-5, card against CPU")
    gscope = _pooled_card_against_cpu(ptt, "CRNN", CRNN_SMALL,
                                      _crnn_program, _crnn_feeds)
    held = _crnn_feeds(np.random.RandomState(SEED + 72), CRNN_SMALL, 1)[0]
    g, c = _decode_card_against_cpu(ptt, CRNN_SMALL, gscope, _crnn_program,
                                    {"img": held["img"]})
    np.testing.assert_array_equal(g[0], c[0])
    np.testing.assert_array_equal(g[1], c[1])
    np.testing.assert_allclose(g[2], c[2], rtol=1e-5, atol=1e-6)
    log(f"  CRNN small greedy decode: lengths {g[1][:, 0].tolist()} and "
        f"paths equal, per-column probabilities within 1e-5, card against "
        f"CPU")
    _ops_reference(_slice15_op_cases(), "this slice's ops (NMS ties and "
                   "empty rows, infeasible CTC rows, mod by negatives, "
                   "stable-sort ties)")
    return {"ok": True}


# ---- phases 38-40: generation through the model zoo, run_steps, readers ----


def check_decode_attention_generate(rates, dev=None):
    """Phase 3 for the decode-attention kernel at the generators' shape
    (phase 38's beam-4 run; its greedy batch-64 run has the same rows):
    each layer's cached self-attention of transformer_lm_generate, q
    [B, K, nh, 1, dh] over the caches [B, K, nh, T, dh] with the step mask
    [B, K, 1, 1, T] (the positions up to the step's), through
    `fused_decode_attention` (the op's route: K4's G = 1 route with B·K·nh
    rows) against the plain version, with float32 q at 1e-5 and the
    path's bfloat16 q at 1e-2; then kernel, plain and SDPA timed in turns
    at the path's types (`dev`, default cuda:0); then the same at the
    encoder-decoder's cross-attention at beam 1, whose keys and values are
    bfloat16 (`*_bf16_cache`). Returns the `*_generate` and
    `*_bf16_cache` fields."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.fusion.decode_attention import (
        decode_attention_chunk, decode_attention_cuda, decode_attention_plain,
        fused_decode_attention)

    dev = dev or torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    b, k = GENERATE["runs"][-1]
    nh = TRAIN["num_heads"]
    dh = TRAIN["d_model"] // nh
    t = GENERATE["max_gen"]
    r = b * k
    splits = -(-t // decode_attention_chunk(r, nh, t, dh))

    def make(q_dtype, pos):
        q = torch.randn(b, k, nh, 1, dh, device=dev, generator=gen)
        kc = torch.randn(b, k, nh, t, dh, device=dev, generator=gen)
        vc = torch.randn(b, k, nh, t, dh, device=dev, generator=gen)
        keep = torch.arange(t, device=dev) <= pos
        bias = torch.where(keep, 0.0, -1e9).expand(b, k, 1, 1, t)
        return q.to(q_dtype), kc, vc, bias

    errs = {}
    for q_dtype, tol, pos in ((torch.float32, 1e-5, t // 3),
                              (torch.bfloat16, 1e-2, t - 1),
                              (torch.float32, 1e-5, 0)):
        q, kc, vc, bias = make(q_dtype, pos)
        out = fused_decode_attention(q, kc, vc, bias, dh ** -0.5)
        ref = decode_attention_plain(
            q.reshape(r, nh, 1, dh), kc.reshape(r, nh, t, dh),
            vc.reshape(r, nh, t, dh), bias.expand(b, k, nh, 1, t).reshape(
                r, nh, 1, t), dh ** -0.5).reshape(q.shape)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        ok = bool((diff <= tol + tol * ref.float().abs()).all())
        log(f"  decode_attention generation shape B={b} K={k} nh={nh} "
            f"T={t} dh={dh} q={str(q_dtype)[6:]} position {pos} ({splits} "
            f"chunks a row and head): max_abs_err={err:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"decode_attention at the generation "
                                 f"shape: {err}")
        errs.setdefault(str(q_dtype)[6:], err)

    kv_bytes = 2 * r * nh * t * dh * 4
    sets = []
    for _ in range(max(4, math.ceil(3 * 50e6 / kv_bytes))):
        q, kc, vc, bias = make(torch.bfloat16, t - 1)
        st = {"q": q.reshape(r, nh, 1, dh), "k": kc.reshape(r, nh, t, dh),
              "v": vc.reshape(r, nh, t, dh),
              # the step mask, one row per (batch, beam), stride 0 on heads
              "bias": bias.reshape(r, 1, 1, t).expand(r, nh, 1, t)}
        st["q4"] = st["q"].float()          # SDPA takes one dtype
        sets.append(st)
    scale = dh ** -0.5
    times = time_in_turns({
        "kernel": lambda s: decode_attention_cuda(s["q"], s["k"], s["v"],
                                                  s["bias"], scale),
        "plain": lambda s: decode_attention_plain(s["q"], s["k"], s["v"],
                                                  s["bias"], scale),
        "library": lambda s: F.scaled_dot_product_attention(
            s["q4"], s["k"], s["v"], attn_mask=s["bias"], scale=scale),
    }, sets)
    # each input read once: q (bf16), the caches (float32, every position:
    # the kernel reads the masked ones too), the [B·K, T] mask; the output
    # written once. 4 flops a cache element, ~5 a score
    nbytes = r * nh * dh * 2 + kv_bytes + r * t * 4 + r * nh * dh * 2
    flops = 4 * r * nh * t * dh + 5 * r * nh * t
    mem_rate, f32_rate, _ = rates
    bound_ms = max(nbytes / mem_rate, flops / f32_rate) * 1e3
    bound_by = "bytes" if nbytes / mem_rate >= flops / f32_rate else \
        "operations"
    log(f"  decode_attention timing at the generation shape R={r} nh={nh} "
        f"T={t} dh={dh} q=bf16: kernel {times['kernel'] * 1e3:.2f} us, plain "
        f"{times['plain'] * 1e3:.2f} us, SDPA {times['library'] * 1e3:.2f} "
        f"us, bound {bound_ms * 1e3:.2f} us ({bound_by}: "
        f"{nbytes / 1e6:.2f} MB)")
    fields = {"max_abs_err_generate": errs["float32"],
              "max_abs_err_bf16_q_generate": errs["bfloat16"],
              "splits_generate": splits, "ms_generate": times["kernel"],
              "plain_ms_generate": times["plain"],
              "bound_ms_generate": bound_ms, "bound_by_generate": bound_by,
              "library_ms_generate": times["library"]}

    # the encoder-decoder's cross-attention at beam 1 (phase 39): q
    # [B, 1, nh, 1, dh] over the encoder's keys and values [B, 1, nh, Ts,
    # dh], both bfloat16 (bfloat16 fc layers), under the source mask
    bn, ts = GENERATE_NMT["batch"], TRANSFORMER["max_len"]

    def make_cross():
        q = torch.randn(bn, 1, nh, 1, dh, device=dev, generator=gen)
        kc = torch.randn(bn, 1, nh, ts, dh, device=dev, generator=gen)
        vc = torch.randn(bn, 1, nh, ts, dh, device=dev, generator=gen)
        lens = torch.randint(TRANSFORMER["len_lo"], ts + 1, (bn, 1, 1, 1, 1),
                             device=dev, generator=gen)
        bias = torch.where(torch.arange(ts, device=dev) < lens, 0.0, -1e9)
        return (q.bfloat16(), kc.bfloat16(), vc.bfloat16(), bias)

    q, kc, vc, bias = make_cross()
    out = fused_decode_attention(q, kc, vc, bias, dh ** -0.5)
    ref = decode_attention_plain(
        q.reshape(bn, nh, 1, dh), kc.reshape(bn, nh, ts, dh),
        vc.reshape(bn, nh, ts, dh), bias.reshape(bn, 1, 1, ts).expand(
            bn, nh, 1, ts), dh ** -0.5).reshape(q.shape)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    ok = bool((diff <= 1e-2 + 1e-2 * ref.float().abs()).all())
    log(f"  decode_attention cross-attention shape R={bn} nh={nh} T={ts} "
        f"dh={dh}, bf16 q and bf16 K/V: max_abs_err={err:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"decode_attention on a bfloat16 cache: {err}")
    sets = []
    for _ in range(8):
        q, kc, vc, bias = make_cross()
        st = {"q": q.reshape(bn, nh, 1, dh), "k": kc.reshape(bn, nh, ts, dh),
              "v": vc.reshape(bn, nh, ts, dh),
              "bias": bias.reshape(bn, 1, 1, ts).expand(bn, nh, 1, ts)}
        st["mask4"] = st["bias"].bfloat16()   # SDPA takes one dtype
        sets.append(st)
    times = time_in_turns({
        "kernel": lambda s: decode_attention_cuda(s["q"], s["k"], s["v"],
                                                  s["bias"], scale),
        "plain": lambda s: decode_attention_plain(s["q"], s["k"], s["v"],
                                                  s["bias"], scale),
        "library": lambda s: F.scaled_dot_product_attention(
            s["q"], s["k"], s["v"], attn_mask=s["mask4"], scale=scale),
    }, sets)
    nbytes = 2 * (2 * bn * nh * dh + 2 * bn * nh * ts * dh) + bn * ts * 4
    flops = 4 * bn * nh * ts * dh + 5 * bn * nh * ts
    bound_ms = max(nbytes / mem_rate, flops / f32_rate) * 1e3
    bound_by = "bytes" if nbytes / mem_rate >= flops / f32_rate else \
        "operations"
    log(f"  decode_attention timing at the cross-attention shape (bf16 "
        f"cache): kernel {times['kernel'] * 1e3:.2f} us, plain "
        f"{times['plain'] * 1e3:.2f} us, SDPA {times['library'] * 1e3:.2f} "
        f"us, bound {bound_ms * 1e3:.2f} us ({bound_by}: "
        f"{nbytes / 1e6:.2f} MB)")
    fields.update({"max_abs_err_bf16_cache": err,
                   "ms_bf16_cache": times["kernel"],
                   "plain_ms_bf16_cache": times["plain"],
                   "bound_ms_bf16_cache": bound_ms,
                   "bound_by_bf16_cache": bound_by,
                   "library_ms_bf16_cache": times["library"]})
    return fields


def _lm_generate_program(ptt, cfg, max_gen, beam):
    """transformer_lm_generate at `cfg`'s widths (phase 7's parameter
    names), as a user builds it."""
    from paddle_tpu_torch.models import transformer
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        seqs, scores = transformer.transformer_lm_generate(
            vocab=cfg["vocab"], max_gen=max_gen, d_model=cfg["d_model"],
            d_inner=cfg["d_inner"], num_heads=cfg["num_heads"],
            num_layers=cfg["num_layers"], beam_size=beam)
    return main, start, [seqs, scores]


def _nmt_generate_program(ptt, cfg, max_gen, beam):
    """transformer_generate at `cfg`'s widths with its train graph's
    dropout (the inference scaling of every dropout site)."""
    from paddle_tpu_torch.models import transformer
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        seqs, scores = transformer.transformer_generate(
            src_vocab=cfg["src_vocab"], tgt_vocab=cfg["tgt_vocab"],
            max_src_len=cfg["max_len"], max_gen=max_gen,
            d_model=cfg["d_model"], d_inner=cfg["d_inner"],
            num_heads=cfg["num_heads"], num_layers=cfg["num_layers"],
            bos_id=BOS, beam_size=beam, dropout=cfg["dropout"])
    return main, start, [seqs, scores]


def _card(ptt):
    """The torch device of CUDAPlace(0)."""
    from paddle_tpu_torch.core.places import place_to_device
    return place_to_device(ptt.CUDAPlace(0))


def _planned_ops(exe, main, op_type):
    """How many `op_type` ops the executor's plan of `main` holds (the
    fused program, the loop's sub-block included)."""
    plan, = (p for key, p in exe._cache.items() if key[0] == id(main))
    return sum(op.type == op_type for blk in plan.program.blocks
               for op in blk.ops)


def _generate(ptt, kernels, label, params_dir, build, feed, reps, expect,
              vocab, profile):
    """Build a generator (`build()` → main, start, fetch), load
    `params_dir` into it on CUDAPlace(0) and decode `feed` (on the card):
    a warm-up call that plans, then `reps` calls each under
    torch.cuda.set_sync_debug_mode("error") (no host sync on the path),
    launch counts zeroed after the warm-up and held to `expect` (a call's
    launches per kernel), the outputs checked (ids in the vocabulary,
    scores finite and best first), one call profiled if `profile`
    (the profiler's processing of a call's ~10k events takes seconds).
    Returns (the
    calls' outputs, seconds, launches, the profile, the count of
    fused_decode_attention ops in the plan)."""
    import torch
    main, start, fetch = build()
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CUDAPlace(0))
    exe.run(start, scope=scope)
    ptt.io.load_params(exe, params_dir, main_program=main, scope=scope)

    def call():
        return exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                       return_numpy=False)

    t0 = time.perf_counter()
    warm = [x.cpu().numpy() for x in call()]
    _check_beams(f"{label} warm-up", *warm, vocab)
    log(f"  [{label}] warm-up call (plans): "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    outs, secs = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append([x.cpu().numpy() for x in out])
    launches = dict(kernels.LAUNCHES)
    for k, per_call in expect.items():
        assert launches[k] == per_call * reps, (
            f"{label}: {k} launched {launches[k]} times in {reps} calls; "
            f"the path launches it {per_call} times a call")
    for seqs, scores in outs:
        _check_beams(label, seqs, scores, vocab)
        assert (seqs == outs[0][0]).all(), f"{label}: calls differ"
    prof = _profile_one(f"[{label}] a call", call) if profile else None
    return outs, secs, launches, prof, _planned_ops(
        exe, main, "fused_decode_attention")


def _markov_share(prompt, seqs, vocab):
    """The share of the best beams' transitions (the prompt's token into
    the first, then each into the next) that _markov_tokens' rule allows:
    next = (13 * tok + 7 + eps) % vocab, eps in [0, 8)."""
    import numpy as np
    toks = np.concatenate([prompt, seqs[:, :, 0]], axis=1)
    eps = (toks[:, 1:] - 13 * toks[:, :-1] - 7) % vocab
    return float((eps < 8).mean())


def generate_lm(ptt, kernels, params_dir):
    """Phase 38: transformer_lm_generate at TRAIN's widths from phase 7's
    trained parameters (io.save_params / load_params), at
    tools/bench_generate.py's shapes: max_gen 64, greedy at batch 16 and
    64, beam 4 at batch 16; prompts are Markov-chain tokens. Each shape:
    a warm-up call, GENERATE["reps"] calls under sync-debug "error"
    (tokens/s over the median call, ms a step), K4 launched once a layer
    a step (6 a step: the fusion pass rewrote every layer's cached
    self-attention, counted in the plan), and the share of transitions
    the Markov rule allows (a diagnostic: chance is 8 / vocab); the beam
    run's call profiled: busy and idle share and top kernels."""
    import numpy as np
    import torch
    cfg, gen = TRAIN, GENERATE
    layers, max_gen = cfg["num_layers"], gen["max_gen"]
    rng = np.random.RandomState(SEED + 13)
    out = {}
    total = 0
    for b, beam in gen["runs"]:
        label = f"LM b{b} beam{beam}"
        prompt = rng.randint(0, cfg["vocab"], (b, 1)).astype("int64")
        feed = {"prompt": torch.from_numpy(prompt).to(_card(ptt))}
        outs, secs, launches, prof, fused = _generate(
            ptt, kernels, label, params_dir,
            lambda: _lm_generate_program(ptt, cfg, max_gen, beam), feed,
            gen["reps"], {"decode_attention": layers * max_gen,
                          "decode_attention_multi": 0}, cfg["vocab"],
            profile=beam > 1)
        assert fused == layers, f"{label}: {fused} fused attentions"
        med = float(np.median(secs))
        seqs, scores = outs[0]
        assert seqs.shape == (b, max_gen, beam), seqs.shape
        share = _markov_share(prompt, seqs, cfg["vocab"])
        log(f"  [{label}] {max_gen} steps: {med * 1e3:.1f} ms a call median "
            f"(all {[round(s * 1e3, 1) for s in secs]}), "
            f"{b * max_gen / med:.1f} generated tokens/s, "
            f"{med / max_gen * 1e3:.3f} ms a step; K4 "
            f"{launches['decode_attention'] / gen['reps'] / max_gen:.0f} "
            f"launches a step, {fused} of {layers} layers' attention fused; "
            f"best-beam score median {float(np.median(scores[:, 0])):.3f}; "
            f"Markov transitions {share:.3f} (chance "
            f"{8 / cfg['vocab']:.5f})")
        total += launches["decode_attention"]
        out[label] = {"batch": b, "beam": beam, "max_gen": max_gen,
                      "s_per_call_median": med, "s_per_call": secs,
                      "tokens_per_s": b * max_gen / med,
                      "ms_per_step": med / max_gen * 1e3,
                      "k4_launches_per_step":
                          launches["decode_attention"] / gen["reps"]
                          / max_gen,
                      "fused_layers": fused, "markov_share": share,
                      "profile": prof}
        torch.cuda.empty_cache()
    out["launches"] = {"decode_attention": total}
    return out


def _nmt_generate_feed(cfg, b, seed):
    """`b` shift-copy sources (phase 15's task) padded to max_len, and the
    translations a trained model would emit: (feed, lengths, targets)."""
    import numpy as np
    samples = _shift_copy_batch(np.random.RandomState(seed),
                                dict(cfg, batch=b))
    t = cfg["max_len"]
    src = np.zeros((b, t), "int64")
    lens = np.zeros(b, "int32")
    want = np.zeros((b, t), "int64")
    for i, (s, _, lbl) in enumerate(samples):
        src[i, :len(s)] = s
        lens[i] = len(s)
        want[i] = lbl
    return {"src": src, "src@SEQLEN": lens}, lens, want


def generate_nmt(ptt, kernels, params_dir):
    """Phase 39: transformer_generate with phase 15's trained
    Transformer-base (io.save_params / load_params) at
    tools/bench_generate.py's measure_nmt shape: batch 16, source 64,
    max_gen 32, beam 4, then beam 1. K1 (`fused_attention` of the
    is_test encoder) launches once a layer a call; K4 once a layer a step
    for the self-attention, and at beam 1 once more for the
    cross-attention, whose [B, 1, nh, Ts, dh] keys match the query's
    layout only there (at beam 4 it stays a batched matmul). The same
    numbers as phase 38, with the share of positions (within each
    source's length) where the best beam emits the shift-copy
    translation (the beam-4 call profiled)."""
    import numpy as np
    import torch
    cfg, gen = TRANSFORMER, GENERATE_NMT
    layers, max_gen, b = cfg["num_layers"], gen["max_gen"], gen["batch"]
    feed, lens, want = _nmt_generate_feed(cfg, b, SEED + 17)
    dev_feed = {k: torch.from_numpy(v).to(_card(ptt))
                for k, v in feed.items()}
    out = {}
    totals = {"decode_attention": 0, "flash_fwd": 0}
    for beam in gen["beams"]:
        label = f"NMT b{b} beam{beam}"
        cross = layers if beam == 1 else 0
        outs, secs, launches, prof, fused = _generate(
            ptt, kernels, label, params_dir,
            lambda: _nmt_generate_program(ptt, cfg, max_gen, beam),
            dev_feed, gen["reps"],
            {"decode_attention": (layers + cross) * max_gen,
             "flash_fwd": layers}, cfg["tgt_vocab"], profile=beam > 1)
        assert fused == layers + cross, f"{label}: {fused} fused attentions"
        med = float(np.median(secs))
        seqs, scores = outs[0]
        assert seqs.shape == (b, max_gen, beam), seqs.shape
        valid = np.arange(max_gen)[None, :] < lens[:, None]
        hit = float((seqs[:, :, 0] == want[:, :max_gen])[valid].mean())
        log(f"  [{label}] {max_gen} steps: {med * 1e3:.1f} ms a call median "
            f"(all {[round(s * 1e3, 1) for s in secs]}), "
            f"{b * max_gen / med:.1f} generated tokens/s, "
            f"{med / max_gen * 1e3:.3f} ms a step; K1 "
            f"{launches['flash_fwd'] // gen['reps']} launches a call in the "
            f"encoder ({launches['flash_fwd_tc'] // gen['reps']} on "
            f"flash_fwd_tc); K4 "
            f"{launches['decode_attention'] / gen['reps'] / max_gen:.0f} a "
            f"step; cross-attention chains on K4: {fused - layers} of "
            f"{layers}; shift-copy tokens {hit:.3f}")
        for k in totals:
            totals[k] += launches[k]
        out[label] = {"batch": b, "beam": beam, "max_gen": max_gen,
                      "s_per_call_median": med, "s_per_call": secs,
                      "tokens_per_s": b * max_gen / med,
                      "ms_per_step": med / max_gen * 1e3,
                      "k1_launches_per_call":
                          launches["flash_fwd"] / gen["reps"],
                      "k4_launches_per_step":
                          launches["decode_attention"] / gen["reps"]
                          / max_gen,
                      "cross_attention_fused": fused - layers,
                      "shift_copy_share": hit, "profile": prof}
        torch.cuda.empty_cache()
    out["launches"] = totals
    return out


def _generate_small_reference(ptt):
    """Both generators at GENERATE_SMALL's width in float32, greedy and
    beam, card against CPU from the same startup draws: tokens equal,
    scores within 1e-4."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import transformer
    cfg = GENERATE_SMALL
    b, dims = cfg["batch"], {k: cfg[k] for k in (
        "max_gen", "d_model", "d_inner", "num_heads", "num_layers")}
    r = np.random.RandomState(SEED + 19)
    feeds = {"lm": {"prompt": r.randint(0, cfg["vocab"], (b, 1))
                    .astype("int64")},
             "nmt": {"src": r.randint(2, cfg["vocab"], (b, cfg["src_len"]))
                     .astype("int64"),
                     "src@SEQLEN": np.array([cfg["src_len"], 3, 5, 1],
                                            "int32")}}
    for gen in ("lm", "nmt"):
        for beam in cfg["beams"]:
            main, start = ptt.Program(), ptt.Program()
            with ptt.program_guard(main, start), ptt.unique_name.guard():
                if gen == "lm":
                    seqs, scores = transformer.transformer_lm_generate(
                        vocab=cfg["vocab"], beam_size=beam, **dims)
                else:
                    seqs, scores = transformer.transformer_generate(
                        src_vocab=cfg["vocab"], tgt_vocab=cfg["vocab"],
                        max_src_len=cfg["src_len"], beam_size=beam, **dims)
            cpu_scope = ptt.Scope()
            cpu = ptt.Executor(ptt.CPUPlace())
            cpu.run(start, scope=cpu_scope)
            params = {p.name: cpu_scope.get(p.name).numpy()
                      for p in main.all_parameters()}
            card_scope = ptt.load_numpy_params(params, ptt.Scope(),
                                               ptt.CUDAPlace(0))
            fetch = [seqs, scores]
            got = ptt.Executor(ptt.CUDAPlace(0)).run(
                main, feed=feeds[gen], fetch_list=fetch, scope=card_scope)
            want = cpu.run(main, feed=feeds[gen], fetch_list=fetch,
                           scope=cpu_scope)
            np.testing.assert_array_equal(got[0], want[0],
                                          err_msg=f"{gen} beam {beam}")
            np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4,
                                       err_msg=f"{gen} beam {beam}")
            torch.cuda.synchronize()
    log(f"  generators at test width (greedy and beam "
        f"{cfg['beams'][-1]}, LM and encoder-decoder): card = CPU")


def _run_steps_reference(ptt, kernels):
    """Executor.run_steps against k calls of Executor.run on the card from
    one state: a small LM (K1-K3 in float32) with Adam, 3 steps; the
    stacked losses and a parameter fetched each step, and every
    parameter after the last step, within 1e-6 (the same kernels in the
    same order)."""
    import numpy as np
    import torch
    cfg = RUN_STEPS_SMALL
    main, start, loss = _train_program(ptt, cfg)
    rng = np.random.RandomState(SEED + 23)
    feeds = []
    for _ in range(cfg["steps"]):
        toks = _markov_tokens(rng, cfg["batch"], cfg["max_len"] + 1,
                              cfg["vocab"])
        feeds.append({"tokens": toks[:, :-1].copy(),
                      "tokens@SEQLEN": np.full((cfg["batch"],),
                                               cfg["max_len"], "int32"),
                      "targets": toks[:, 1:].copy()})
    cuda = ptt.CUDAPlace(0)
    exe = ptt.Executor(cuda)
    base = ptt.Scope()
    exe.run(start, scope=base)
    state = {n: base.get(n).cpu().numpy() for n in base.local_var_names()}
    param = main.all_parameters()[0].name
    seq_scope = ptt.load_numpy_params(state, ptt.Scope(), cuda)
    seq = [exe.run(main, feed=f, fetch_list=[loss, param], scope=seq_scope)
           for f in feeds]
    steps_scope = ptt.load_numpy_params(state, ptt.Scope(), cuda)
    kernels.reset_launch_counts()
    curve, p_steps = ptt.Executor(cuda).run_steps(
        feeds, fetch_list=[loss, param], program=main, scope=steps_scope)
    launches = dict(kernels.LAUNCHES)
    np.testing.assert_allclose(curve, [s[0] for s in seq], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(p_steps, np.stack([s[1] for s in seq]),
                               rtol=1e-6, atol=1e-6)
    for p in main.all_parameters():
        np.testing.assert_allclose(steps_scope.get(p.name).cpu().numpy(),
                                   seq_scope.get(p.name).cpu().numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=p.name)
    for k in FLASH:
        assert launches[k] == cfg["num_layers"] * cfg["steps"], launches
    log(f"  run_steps ({cfg['steps']} steps of a small LM, Adam) = "
        f"{cfg['steps']} x run on the card: losses {np.round(curve, 5)}; "
        f"K1-K3 {[launches[k] for k in FLASH]} launches")


def _py_reader_reference(ptt):
    """A py_reader with double_buffer (its default) feeding the card: each
    batch arrives as CUDA tensors staged on the prefetcher's side stream,
    and 4 SGD steps give the losses of the same batches fed as numpy."""
    import numpy as np
    import torch
    L = ptt.layers
    b = 8
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        reader = L.io.py_reader(capacity=2, shapes=[[b, 6], [b, 1]],
                                dtypes=["float32", "float32"],
                                names=["x", "y"])
        x = main.global_block().var("x")
        y = main.global_block().var("y")
        pred = L.fc(L.fc(x, size=16, act="relu"), size=1)
        loss = L.reduce_mean(L.square(pred - y))
        ptt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    r = np.random.RandomState(SEED + 29)
    batches = [(r.rand(b, 6).astype("float32"),
                r.rand(b, 1).astype("float32")) for _ in range(4)]
    cuda = ptt.CUDAPlace(0)
    exe = ptt.Executor(cuda)
    base = ptt.Scope()
    exe.run(start, scope=base)
    state = {n: base.get(n).cpu().numpy() for n in base.local_var_names()}
    scope = ptt.load_numpy_params(state, ptt.Scope(), cuda)
    reader.decorate_sample_list_generator(lambda: iter(batches)).start()
    got = []
    for feed in reader:
        assert all(v.device == _card(ptt) for v in feed.values()), \
            "not staged on the card"
        got.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                 scope=scope)[0]))
    direct = ptt.load_numpy_params(state, ptt.Scope(), cuda)
    want = [float(exe.run(main, feed={"x": xb, "y": yb}, fetch_list=[loss],
                          scope=direct)[0]) for xb, yb in batches]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    torch.cuda.synchronize()
    log(f"  py_reader with double_buffer: {len(got)} batches staged on the "
        f"card, losses = direct feeding ({np.round(got, 5)})")


def _fused_sequences_reference(ptt, kernels):
    """fusion.fused_lstm_sequence / fused_gru_sequence on CUDA tensors
    (K5 / K6) against their plain versions on the same inputs, both
    directions, ragged lengths with a 0, at 1e-5."""
    import torch
    from paddle_tpu_torch import fusion
    from paddle_tpu_torch.fusion.recurrent import gru_seq_plain, \
        lstm_seq_plain
    dev = _card(ptt)
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    b, t, h = 4, 6, 32
    seqlen = torch.tensor([6, 4, 1, 0], device=dev)
    kernels.reset_launch_counts()
    worst = 0.0
    for kind, g in (("lstm", 4), ("gru", 3)):
        x = torch.randn(b, t, g * h, device=dev, generator=gen) * .3
        h0 = torch.randn(b, h, device=dev, generator=gen) * .1
        c0 = torch.randn(b, h, device=dev, generator=gen) * .1
        w = torch.randn(h, g * h, device=dev, generator=gen) * .1
        for reverse in (False, True):
            xs = torch.flip(x, (1,)) if reverse else x
            if kind == "lstm":
                got = fusion.fused_lstm_sequence(x, h0, c0, w, seqlen,
                                                 reverse)
                ref = lstm_seq_plain(xs, h0, c0, w, seqlen, reverse, False)
            else:
                got = (fusion.fused_gru_sequence(x, h0, w, seqlen,
                                                 reverse),)
                ref = gru_seq_plain(xs, h0, w, seqlen, reverse, False)
            if reverse:
                ref = tuple(torch.flip(a, (1,)) for a in ref)
            for a, e in zip(got, ref):
                err = float((a - e).abs().max())
                worst = max(worst, err)
                assert err <= 1e-5, (kind, reverse, err)
    launches = dict(kernels.LAUNCHES)
    assert launches["lstm_seq"] == launches["gru_seq"] == 2, launches
    log(f"  fused_lstm_sequence / fused_gru_sequence on K5 / K6 = plain "
        f"(max abs err {worst:.2e}), {launches['lstm_seq']} and "
        f"{launches['gru_seq']} launches")


# ROADMAP §3's four faults' op cases: the JAX package's outputs
# (tests/test_torch_ops.py takes them from the JAX registry on the CPU;
# written here as constants, as this script imports no jax)
_INT_X = [[0, 1, -1, 7, -7, 3]]
_FAULT_CASES = (
    ("softmax", {}, {"Out": [[0.0008922151755541563, 0.002425292506814003,
                              0.0003282276156824082, 0.9784327745437622,
                              8.135949656207231e-07, 0.01792062260210514]]}),
    ("log_softmax", {"axis": -1},
     {"Out": [[-7.021803379058838, -6.021803379058838, -8.02180290222168,
               -0.021803203970193863, -14.02180290222168,
               -4.021803379058838]]}),
    ("gelu", {}, {"Out": [[0.0, 0.8411920070648193, -0.15880796313285828,
                           7.0, -0.0, 2.9963626861572266]]}),
    ("softplus", {}, {"Out": [[0.6931471824645996, 1.3132617473602295,
                               0.3132616877555847, 7.000911235809326,
                               0.000911466486286372, 3.0485873222351074]]}),
    ("logsigmoid", {}, {"Out": [[-0.6931471824645996, -0.3132616877555847,
                                 -1.3132617473602295, -0.000911466486286372,
                                 -7.000911235809326,
                                 -0.04858735203742981]]}),
    ("layer_norm", {"begin_norm_axis": 1, "epsilon": 1e-5},
     {"Y": [[-0.11812485754489899, 0.11812485754489899, -0.35437458753585815,
             1.5356231927871704, -1.771872878074646, 0.5906242728233337]],
      "Mean": [0.5], "Variance": [17.91666603088379]}),
)
# X [5, -5, 0] over a zero divisor; INT_MIN, 7, -7 over -1
_DIVISIONS = (("int32", "elementwise_floordiv", [5, -5, 0], 0, [-2, -2, -1]),
              ("int32", "elementwise_mod", [5, -5, 0], 0, [0, 0, 0]),
              ("float32", "elementwise_floordiv", [5, -5, 0], 0,
               [math.nan] * 3),
              ("float32", "elementwise_mod", [5, -5, 0], 0, [math.nan] * 3),
              ("int32", "elementwise_floordiv", [-2 ** 31, 7, -7], -1,
               [-2 ** 31, -7, 7]),
              ("int32", "elementwise_mod", [-2 ** 31, 7, -7], -1, [0, 0, 0]))


def _fault_cases_on_the_card(ptt):
    """The four faults' op inputs on the card: int32 X into the float ops
    (float32 outputs), X [5, -5, 0] over a zero divisor in int32 and
    float32, and int32 INT_MIN over -1, each against the JAX package's
    values (at 1e-5; integers and NaN exactly)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.framework import registry
    dev = _card(ptt)
    ctx = registry.LowerCtx(device=dev)
    x = torch.tensor(_INT_X, dtype=torch.int32, device=dev)
    for op_type, attrs, want in _FAULT_CASES:
        out = registry.lookup_op(op_type).lower(ctx, {"X": [x]}, dict(attrs))
        for slot, vals in want.items():
            got = out[slot][0]
            assert got.dtype == torch.float32, (op_type, slot, got.dtype)
            np.testing.assert_allclose(got.cpu().numpy(), np.float32(vals),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{op_type} {slot}")
    for dt, op_type, xv, yv, want in _DIVISIONS:
        xs = torch.tensor(xv, dtype=getattr(torch, dt), device=dev)
        out = registry.lookup_op(op_type).lower(
            ctx, {"X": [xs], "Y": [torch.full_like(xs, yv)]}, {})["Out"][0]
        np.testing.assert_array_equal(out.cpu().numpy(),
                                      np.asarray(want, dt),
                                      err_msg=f"{op_type} {dt}")
    torch.cuda.synchronize()
    log(f"  the slice's fault cases on the card ({len(_FAULT_CASES)} float "
        f"ops of an int32 X, {len(_DIVISIONS)} divisions by 0 and -1) = the "
        f"JAX package's values")


def generate_reference_check(ptt, kernels):
    """Phase 40: this slice's paths at test width, card against CPU (or
    against the JAX package's values written here), float32 with TF32
    off: the generators, run_steps, py_reader with double_buffer, the
    fused whole-sequence entry points, and the fault cases."""
    from paddle_tpu_torch.core import flags
    saved = flags.get_flag("use_bf16_matmul")
    flags.set_flag("use_bf16_matmul", False)
    try:
        _generate_small_reference(ptt)
        _run_steps_reference(ptt, kernels)
    finally:
        flags.set_flag("use_bf16_matmul", saved)
    _py_reader_reference(ptt)
    _fused_sequences_reference(ptt, kernels)
    _fault_cases_on_the_card(ptt)
    return {"ok": True}


# phase 41: phase 7's LM; steps a variant in the kept / released / planned /
# remat turns, and the profiled steps
ANALYSIS_STEPS, PROFILE_STEPS = 4, 3
#: the remat variant's time budget: wide enough to admit search_remat's
#: segments, whose recompute the default 2% of the step does not admit
REMAT_BUDGET_S = 10.0


def _analyzed_programs(ptt):
    """The programs phases 7, 12, 15, 19 and 22 train, built as they build
    them: {label: program}."""
    from paddle_tpu_torch.models import transformer  # noqa: F401
    out = {"lm": _train_program(ptt, TRAIN)[0],
           "nmt": _nmt_program(ptt, NMT)[0],
           "resnet50": _resnet_program(ptt, RESNET)[0],
           "deepfm": _deepfm_program(ptt, DEEPFM)[0]}
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        loss, _ = _transformer_model(ptt, TRANSFORMER)
        ptt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    out["transformer_base"] = main
    return out


def _device_busy(events):
    """(busy us, window us) of a device timeline: the union of the kernel,
    copy and set intervals over the span from the first start to the last
    end."""
    iv = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                if e.get("ph") == "X")
    if not iv:
        return 0.0, 0.0
    busy, cur_s, cur_e = 0.0, iv[0][0], iv[0][1]
    for a, b in iv[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    return busy, iv[-1][1] - iv[0][0]


def _kernels_per_step(events, names):
    """From a torch.profiler Chrome trace: for each `executor/run` range on
    the host (a span the profiler mirrors as a record_function), how many
    device kernels of each of `names` were launched inside it, each kernel
    tied to its launch by the trace's correlation id. [{name: count}] in
    step order."""
    runs = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                  if e.get("cat") == "user_annotation"
                  and e.get("name") == "executor/run")
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    per_step = [dict.fromkeys(names, 0) for _ in runs]
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name = next((n for n in names if n in e.get("name", "")), None)
        at = launched.get(e.get("args", {}).get("correlation"))
        if name is None or at is None:
            continue
        for i, (a, b) in enumerate(runs):
            if a <= at <= b:
                per_step[i][name] += 1
                break
    return per_step


def analyze_plan_profile(ptt, kernels):
    """Phase 41: the analyzers, the memory planner, the cost model, the
    measured census, the profiler and the flight recorder on phase 7's LM
    at full width (6 x 512, vocab 32000, max_len 512, batch 16, Adam).

    - check_program and infer_program on the LM and on the programs phases
      12, 15, 19 and 22 build: no error diagnostic; their host times.
    - memory_plan_pass (under the pass sanitizer) on copies of the LM, at
      the default budget (2% of the step: search_remat must keep the
      stash) and at REMAT_BUDGET_S (it must choose remat). Four variants
      train from the same weights, in turns, ANALYSIS_STEPS steps each:
      kept (the unplanned program with every intermediate kept to the
      step's end: the control), released (the unplanned program, each
      transient dropped at its last use), planned and remat. Each step's
      max_memory_allocated beside plan_report's predicted peaks and
      search_remat's decision; released must peak no higher than kept,
      remat below released. Losses against kept: step 1 at rtol 1e-5 (the
      same forward from the same weights), later steps at 2e-3 (phase
      23's tolerance: bfloat16 gradients of a recomputed segment round
      in another order).
    - Executor.cost_analysis / memory_analysis / memory_census of the
      released step on the card; memory_analysis of a step that only
      adds 1 in place to a 256 MiB state must read temp 0 (under 1 MiB:
      the census's copy of the state is no transient); the census into a LedgerRow against
      costs.predict, check_memory_identity at the JAX package's 0.1
      residual (printed, not asserted: a residual past the band is a
      finding), and mfu / roofline_fields of the median step at the H100
      constants.
    - profiler.profiler("All") over a warm-up step and PROFILE_STEPS
      more: each of those must hold flash_fwd_tc_kernel,
      flash_dq_tc_kernel and flash_dkv_tc_kernel 6 times in the device
      trace, and the exported Chrome trace the kernels and the
      executor's span ranges; the summary's top rows and the device's
      idle share.
    - the flight recorder installed on a dossier directory: a Trainer
      stopped by an injected EnforceError goes through the installed
      excepthook, which writes one dossier holding its last spans;
      flight_recorder.analyze reads it back.
    Launch counts are zeroed just before the four variants' turns and
    read just after. Returns its numbers."""
    import numpy as np
    import torch
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.framework import analysis, costs, memory_plan
    from paddle_tpu_torch.observability import flight_recorder, ledger

    out = {}
    # -- the analyzers over five full-width programs -----------------------
    progs = _analyzed_programs(ptt)
    out["analysis"] = {}
    for label, prog in progs.items():
        t0 = time.perf_counter()
        analysis.check_program(prog)
        t1 = time.perf_counter()
        res = analysis.infer_program(prog)
        t2 = time.perf_counter()
        warn = sorted({d.code for d in res.diagnostics})
        assert not res.errors, (label, [str(d) for d in res.errors][:5])
        out["analysis"][label] = {
            "check_s": t1 - t0, "infer_s": t2 - t1, "ops": res.n_ops,
            "inferred": res.n_inferred, "skipped": res.n_skipped,
            "warnings": warn}
        log(f"  {label}: check_program {1e3 * (t1 - t0):.1f} ms, "
            f"infer_program {1e3 * (t2 - t1):.1f} ms over {res.n_ops} ops "
            f"({res.n_inferred} inferred, {res.n_skipped} skipped, warnings "
            f"{warn or 'none'}); no error diagnostic")
    del progs

    # -- plan the LM, train four variants in turns -------------------------
    cfg = TRAIN
    rng = np.random.RandomState(SEED + 41)
    b, t = cfg["batch"], cfg["max_len"]
    feeds = []
    for _ in range(TRAIN_BATCHES):
        toks = _markov_tokens(rng, b, t + 1, cfg["vocab"])
        feeds.append({"tokens": toks[:, :-1].copy(),
                      "tokens@SEQLEN": np.full((b,), t, "int32"),
                      "targets": toks[:, 1:].copy()})
    main, start, loss = _train_program(ptt, cfg)
    reps = {}
    progs = {"kept": main, "released": main}
    for which, budget in (("planned", None), ("remat", REMAT_BUDGET_S)):
        t0 = time.perf_counter()
        progs[which] = ptt.get_pass(
            "memory_plan_pass", protected=[loss.name], nominal_batch=b,
            time_budget_s=budget)(main)
        plan_s = time.perf_counter() - t0
        rep = reps[which] = memory_plan.plan_report(progs[which])
        remat = rep["remat"] or {}
        log(f"  memory_plan_pass, {which} (sanitized, budget "
            f"{'2% of the step' if budget is None else f'{budget} s'}) "
            f"{plan_s:.2f} s: predicted peak "
            f"{rep['predicted_peak_before'] / 1e6:.1f} -> "
            f"{rep['predicted_peak_after'] / 1e6:.1f} MB, {rep['n_slots']} "
            f"slots over {rep['shared_vars']} vars, reordered "
            f"{rep['schedule']['reordered']}; search_remat chose "
            f"{remat.get('chosen')} ({remat.get('segments')} segments, "
            f"policy {remat.get('policy')}, stash "
            f"{remat.get('stash_bytes_unsegmented', 0) / 1e6:.1f} MB -> "
            f"{remat.get('predicted_stash_bytes', 0) / 1e6:.1f} MB, "
            f"recompute priced {remat.get('extra_seconds_bound', 0) * 1e3:.3f}"
            f" ms of a {remat.get('time_budget_s', 0) * 1e3:.3f} ms budget; "
            f"cheapest candidate "
            f"{min((c['extra_seconds_bound'] for c in remat.get('candidates', ())), default=0) * 1e3:.3f} ms)")
    # at 2% of the step no segmentation fits once recompute is priced
    # at the host's lowerings: the default plan keeps the stash
    assert reps["planned"]["remat"]["chosen"] == "stash", reps["planned"]
    assert reps["remat"]["remat"]["chosen"] == "remat", reps["remat"]
    scopes = {}
    exe0 = ptt.Executor(ptt.CUDAPlace(0))
    base = ptt.Scope()
    exe0.run(start, scope=base)
    for which in progs:
        scopes[which] = ptt.Scope()
        for n in base.local_var_names():
            scopes[which].set_var(n, base.get(n).clone())
    del base
    exes = {w: ptt.Executor(ptt.CUDAPlace(0)) for w in scopes}
    runs = {w: {"loss": [], "peak": [], "secs": []} for w in scopes}
    order = list(progs)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for i in range(ANALYSIS_STEPS + 1):          # step 0 plans, untimed
        for w in (order if i % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            lv, = exes[w].run(progs[w], feed=feeds[i % len(feeds)],
                              fetch_list=[loss], scope=scopes[w])
            torch.cuda.synchronize()
            if i:
                runs[w]["secs"].append(time.perf_counter() - t0)
                runs[w]["peak"].append(torch.cuda.max_memory_allocated())
            else:
                runs[w]["loss"].append(float(lv))
                if w == "kept":
                    # the control: its plan keeps every intermediate
                    # until the step ends, as before release at last use
                    for plan in exes[w]._cache.values():
                        plan.release = None
                continue
            runs[w]["loss"].append(float(lv))
    launches = dict(kernels.LAUNCHES)
    for w in order:
        r = runs[w]
        log(f"  {w}: losses {[round(x, 5) for x in r['loss']]}, "
            f"max_memory_allocated a step "
            f"{[round(x / 1e6, 1) for x in r['peak']]} MB, step median "
            f"{np.median(r['secs']) * 1e3:.1f} ms")
    for w in order[1:]:
        np.testing.assert_allclose(runs[w]["loss"][0], runs["kept"]["loss"][0],
                                   rtol=1e-5, err_msg=f"{w}: step-1 loss")
        np.testing.assert_allclose(runs[w]["loss"], runs["kept"]["loss"],
                                   rtol=2e-3, err_msg=f"{w}: losses")
    peak = {w: runs[w]["peak"] for w in order}
    # release at last use never raises the step's peak (on this LM the
    # peak is inside the autograd region, whose saved tensors autograd
    # holds: release frees what lives after it); remat lowers it
    assert max(peak["released"]) <= min(peak["kept"]), peak
    assert max(peak["remat"]) < min(peak["released"]), peak
    med = {w: float(np.median(runs[w]["secs"]) * 1e3) for w in order}
    log(f"  peak a step, release alone {1 - min(peak['released']) / min(peak['kept']):.1%} "
        f"below keeping every intermediate, the default plan "
        f"{1 - min(peak['planned']) / min(peak['kept']):.1%}, remat "
        f"{1 - min(peak['remat']) / min(peak['kept']):.1%}; step median "
        f"planned / released {med['planned'] / med['released']:.3f}, remat "
        f"/ released {med['remat'] / med['released']:.3f}")
    out["plan"] = {**{f"{w}_plan": {
                       "predicted_peak_before": reps[w]["predicted_peak_before"],
                       "predicted_peak_after": reps[w]["predicted_peak_after"],
                       "n_slots": reps[w]["n_slots"],
                       "remat": {k: (reps[w]["remat"] or {}).get(k) for k in (
                           "chosen", "segments", "policy",
                           "stash_bytes_unsegmented", "predicted_stash_bytes",
                           "extra_seconds_bound", "time_budget_s")}}
                      for w in reps},
                   **{w: {"loss": runs[w]["loss"],
                          "peak_bytes": runs[w]["peak"],
                          "step_ms_median": med[w]} for w in order},
                   "launches": launches}
    log(f"  launches over the four programs' {4 * (ANALYSIS_STEPS + 1)} "
        f"steps: { {k: launches[k] for k in FLASH + FLASH_TC} }")
    for k in FLASH + FLASH_TC:
        assert launches[k] > 0, f"phase 41: {k} never launched"
    del exes
    for w in ("kept", "planned", "remat"):
        del scopes[w]

    # -- the cost model and the measured census on the card ----------------
    exe, scope = ptt.Executor(ptt.CUDAPlace(0)), scopes["released"]
    feed = feeds[0]
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    ca = exe.cost_analysis(main, feed, [loss], scope)
    ma = exe.memory_analysis(main, feed, [loss], scope)
    census = exe.memory_census(feed, main, scope, fetch_list=[loss])
    report = costs.predict(main, nominal_batch=b)
    row = ledger.CostLedger("phase41").row("lm", batch=b)
    row.set_prediction(report)
    row.set_memory_census(census)
    ident = row.check_memory_identity(0.1)
    step_s = float(np.median(runs["released"]["secs"]))
    roof = costs.roofline_fields(step_s, ca["flops"], ca["bytes accessed"])
    mfu = costs.mfu(ca["flops"], step_s)
    log(f"  cost_analysis: {ca['flops'] / 1e12:.3f} TFLOP, "
        f"{ca['bytes accessed'] / 1e9:.2f} GB a step (the port's op count)")
    log(f"  memory_analysis ({ma['temp_source']}): argument "
        f"{ma['argument_bytes'] / 1e6:.1f} MB, output "
        f"{ma['output_bytes'] / 1e6:.1f} MB, alias "
        f"{ma['alias_bytes'] / 1e6:.1f} MB, temp {ma['temp_bytes'] / 1e6:.1f} "
        f"MB; predicted transient peak "
        f"{report['memory']['per_device']['transient_peak'] / 1e6:.1f} MB")
    log(f"  memory_census: state {census['state']['categories']}, feeds "
        f"{census['feeds']['per_device_bytes']:.0f} B, peak "
        f"{census['peak_bytes'] / 1e6:.1f} MB, live "
        f"{census['live']['committed_bytes'] / 1e6:.1f} MB "
        f"({census['live']['source']}, untracked "
        f"{census['live']['untracked_bytes'] / 1e6:.1f} MB)")
    checks = {c["what"]: c["ok"] for c in row.checks}
    log(f"  check_memory_identity(0.1): {checks}; buckets "
        f"{ident['buckets']}; unattributed bound "
        f"{ident['predicted']} B against {ident['measured']} B measured "
        f"(peak {ident['peak_bytes'] / 1e6:.1f} MB)")
    log(f"  median step {step_s * 1e3:.1f} ms: mfu {mfu:.4f} at "
        f"{costs.H100_PEAK_FLOPS / 1e12:.0f} TFLOP/s; roofline_fields {roof}")
    assert next(c for c in row.checks
                if c["what"] == "memory_args_balance")["ok"], row.checks
    # a step with no transients: one in-place add to a 256 MiB state
    flat = ptt.Program()
    with ptt.program_guard(flat, ptt.Program()):
        w = flat.global_block().create_var(
            name="census_w", shape=[64 << 20], dtype="float32",
            persistable=True)
        ptt.layers.increment(w, in_place=True)
    flat_scope = ptt.Scope()
    flat_scope.set_var("census_w", torch.zeros(64 << 20, device=exe.device))
    flat_ma = exe.memory_analysis(flat, {}, [], flat_scope)
    log(f"  memory_analysis of an in-place add to a 256 MiB state: temp "
        f"{flat_ma['temp_bytes']} B, alias {flat_ma['alias_bytes']} B")
    assert flat_ma["alias_bytes"] == 4 << 26, flat_ma
    assert flat_ma["temp_bytes"] < 1 << 20, flat_ma
    assert float(flat_scope.get("census_w")[0]) == 0.0
    del flat_scope
    out["census"] = {"cost_analysis": ca, "memory_analysis": ma,
                     "identity_checks": checks,
                     "identity_buckets": ident["buckets"],
                     "peak_bytes": census["peak_bytes"],
                     "no_transient_temp_bytes": flat_ma["temp_bytes"],
                     "mfu": mfu, "roofline": roof}

    # -- the profiler -------------------------------------------------------
    # the window's first step is a warm-up, outside the checks: in a long
    # process CUPTI can miss the first kernels of a window (one of 18
    # flash_fwd_tc_kernels in the first step, in both full runs of this
    # script; none in a short process)
    tdir = tempfile.mkdtemp(prefix="chip_smoke_prof_")
    trace_path = os.path.join(tdir, "trace.json")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with profiler.profiler("All", sorted_key="total",
                           profile_path=trace_path, trace_dir=tdir):
        for i in range(PROFILE_STEPS + 1):
            exe.run(main, feed=feeds[i % len(feeds)], fetch_list=[loss],
                    scope=scope)
    wall = time.perf_counter() - t0
    prof_launches = dict(kernels.LAUNCHES)
    with open(trace_path) as f:
        trace = json.load(f)
    with open(os.path.join(tdir, "device_trace.json")) as f:
        raw = json.load(f)["traceEvents"]
    shutil.rmtree(tdir, ignore_errors=True)
    names = ("flash_fwd_tc_kernel", "flash_dq_tc_kernel",
             "flash_dkv_tc_kernel")
    per_step = _kernels_per_step(raw, names)
    evs = trace["traceEvents"]
    dev = [e for e in evs if e.get("pid", 0) > 0 and e.get("ph") == "X"]
    named = {k: sum(1 for e in dev if k in e["name"]) for k in names}
    host = {}
    for e in evs:
        if e.get("pid") == 0 and e.get("ph") == "X":
            host[e["name"]] = host.get(e["name"], 0) + 1
    busy, window = _device_busy(dev)
    log(f"  profiled {PROFILE_STEPS + 1} steps (the first a warm-up) in "
        f"{wall * 1e3:.1f} ms: device events {len(dev)}, flash kernels in "
        f"the exported trace {named}, by step {per_step}; host span ranges "
        f"{host}; device busy {busy / 1e3:.1f} of {window / 1e3:.1f} ms "
        f"(idle share {1 - busy / max(window, 1e-9):.3f})")
    assert len(per_step) == PROFILE_STEPS + 1, per_step
    for counts in per_step[1:]:
        assert all(n == cfg["num_layers"] for n in counts.values()), \
            per_step
    for k, n in named.items():
        assert n >= cfg["num_layers"] * PROFILE_STEPS, (k, n, named)
    assert host.get("executor/run") == PROFILE_STEPS + 1, host
    assert prof_launches["flash_fwd_tc"] == cfg["num_layers"] * \
        (PROFILE_STEPS + 1), prof_launches
    out["profile"] = {"kernels_in_trace": named, "kernels_by_step": per_step,
                      "host_spans": host, "busy_ms": busy / 1e3,
                      "window_ms": window / 1e3,
                      "idle_share": 1 - busy / max(window, 1e-9),
                      "launches": {k: prof_launches[k]
                                   for k in FLASH + FLASH_TC}}
    del exe, scopes

    # -- the flight recorder --------------------------------------------------
    d = tempfile.mkdtemp(prefix="chip_smoke_dossier_")
    try:
        flight_recorder.install(d, excepthook=True, sigterm=False)

        def train_func():
            x = ptt.layers.data("x", [64])
            y = ptt.layers.data("y", [1])
            return [ptt.layers.mean(ptt.layers.square_error_cost(
                ptt.layers.fc(x, 1), y))]

        with ptt.unique_name.guard():
            trainer = ptt.Trainer(
                train_func, lambda: ptt.optimizer.SGD(learning_rate=0.01),
                place=ptt.CUDAPlace(0))
        drng = np.random.RandomState(SEED)

        def reader():
            for _ in range(8):
                yield [(drng.randn(64).astype("float32"),
                        drng.randn(1).astype("float32")) for _ in range(8)]

        def stop_at_step_3(event):
            if isinstance(event, ptt.EndStepEvent) and event.step == 3:
                raise EnforceError("phase 41: injected stop at step 3")

        try:
            trainer.train(num_epochs=1, event_handler=stop_at_step_3,
                          reader=reader, feed_order=["x", "y"])
            raise AssertionError("the injected EnforceError did not stop "
                                 "the Trainer")
        except EnforceError as e:
            sys.excepthook(type(e), e, e.__traceback__)
        dossiers = flight_recorder.collect_dossiers(d)
        verdict = flight_recorder.analyze(d)
        spans = [s["name"] for s in dossiers[0]["spans"]] if dossiers \
            else []
        log(f"  flight recorder: {len(dossiers)} dossier(s), reason "
            f"{verdict['dossier_reasons']}, its last spans "
            f"{spans[-4:]}")
        assert len(dossiers) == 1 and "executor/run" in spans, dossiers
        assert verdict["n_dossiers"] == 1, verdict
        out["flight_recorder"] = {"dossiers": len(dossiers),
                                  "reasons": verdict["dossier_reasons"],
                                  "last_spans": spans[-4:]}
    finally:
        flight_recorder.reset()
        shutil.rmtree(d, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 42: data- and tensor-parallel training over NCCL, and the ring
# ---------------------------------------------------------------------------

PARALLEL_STEPS = 3
# the ring at the LM's attention shape and at a long sequence, 4 blocks
RING_BLOCKS = 4
RING_CASES = (("lm", 16, 8, 512, 64, False), ("lm_packed", 16, 8, 512, 64,
                                               True),
              ("long", 1, 8, 16384, 64, False))


def _nccl_events(events):
    """(host calls, device kernels) of NCCL in profiler events: the
    process group's `nccl:*` / `c10d::*` ranges on the host, and the
    kernels NCCL put on the card."""
    from torch.autograd import DeviceType
    host = sum(e.count for e in events
               if e.key.startswith(("nccl:", "c10d::")))
    dev = sum(e.count for e in events if e.device_type == DeviceType.CUDA
              and "nccl" in e.key.lower())
    return host, dev


def phase42_rank(rank, world, out_path):
    """One rank of phase 42(a)'s NCCL world (paddle_tpu_torch.distributed.
    launch runs it; its card is CUDAPlace(local rank)): phase 7's LM at
    full width in float32 (TF32 off), 3 timed Adam steps and a profiled
    fourth from the same weights and batches in four modes through
    ParallelExecutor, each held against the plain Executor on this card:
    the losses of the 3, every step's gradients (through Adam's first
    moments) and the parameters after the 4 (`_adam_parity`). Writes the
    rank's numbers to out_path.<rank> as JSON, and prints them; any
    mismatch then raises (the launch fails)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.parallel import (BuildStrategy, DeviceMesh,
                                           ParallelExecutor, ReduceStrategy,
                                           annotate_tp)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ptt.flags.set_flag("use_bf16_matmul", False)
    kernels.build(["flash_attention"])     # built by phase 2: loads
    dev = torch.cuda.current_device()
    place = ptt.CUDAPlace(dev)
    cfg = TRAIN
    steps, lr = PARALLEL_STEPS, cfg["lr"]
    dp_mesh = DeviceMesh(axes={"dp": world})
    tp_axes = ({"dp": world // 2, "tp": 2} if world >= 4
               else {"dp": 1, "tp": world})
    tp_mesh = DeviceMesh(axes=tp_axes)
    rng = np.random.RandomState(SEED + 42)
    b, t = cfg["batch"], cfg["max_len"]
    feeds = []
    for _ in range(steps + 1):
        toks = _markov_tokens(rng, b, t + 1, cfg["vocab"])
        feeds.append({"tokens": toks[:, :-1].copy(),
                      "tokens@SEQLEN": np.full((b,), t, "int32"),
                      "targets": toks[:, 1:].copy()})
    main, start, loss = _train_program(ptt, cfg, mean_loss=True)
    scope0 = ptt.Scope()
    ptt.Executor(place).run(start, scope=scope0)
    init = {n: scope0.get(n).clone() for n in scope0.local_var_names()}
    del scope0
    names = [p.name for p in main.all_parameters()]

    def fresh_scope():
        sc = ptt.Scope()
        for n, v in init.items():
            sc.set_var(n, v.clone())
        return sc

    # Adam's first-moment accumulator of each parameter (the gradients
    # of every step, through m_s = b1 m_(s-1) + (1 - b1) g_s)
    m1_of = {v.accumulator_of: v.name
             for v in main.global_block().vars.values()
             if getattr(v, "accumulator_of", None) in names
             and "_moment1_acc" in v.name}
    assert sorted(m1_of) == sorted(names), sorted(set(names) - set(m1_of))

    def timed_steps(run, after):
        kernels.reset_launch_counts()
        losses, secs = [], []
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run(feeds[i])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            x = out[0]
            losses.append(float(x.reshape(-1)[0]) if torch.is_tensor(x)
                          else float(np.asarray(x).ravel()[0]))
            after(out)
        launches = dict(kernels.LAUNCHES)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = run(feeds[steps])
            torch.cuda.synchronize()
        after(out)
        return losses, secs, launches, _nccl_events(prof.key_averages())

    sc = fresh_scope()
    exe = ptt.Executor(place)
    fetch = [loss] + [n + "@GRAD" for n in names]
    # each step's |g| and first moments, the parameters after the first
    plain_g, plain_m1, plain_p1 = (_Snapshots(steps + 1),
                                   _Snapshots(steps + 1), _Snapshots(1))

    def plain_after(out):
        for g in plain_g(dict(zip(names, out[1:]))).values():
            g.abs_()
        plain_m1({n: sc.get(m1_of[n]) for n in names})
        if not plain_p1.steps:
            plain_p1({n: sc.get(n) for n in names})
    plain_losses, plain_secs, plain_launches, _ = timed_steps(
        lambda f: exe.run(main, feed=f, fetch_list=fetch, scope=sc,
                          return_numpy=False), plain_after)
    # the parameters after all steps taken (the 3 timed and the profiled
    # one): each mode's are compared with these
    plain = {n: sc.get(n).clone() for n in names}
    del sc, exe
    sc = fresh_scope()
    exe = ptt.Executor(place)
    rep_m1, rep_p1 = _Snapshots(steps + 1), _Snapshots(1)

    def rep_after(out):
        rep_m1({n: sc.get(m1_of[n]) for n in names})
        if not rep_p1.steps:
            rep_p1({n: sc.get(n) for n in names})
    timed_steps(lambda f: exe.run(main, feed=f, fetch_list=[loss], scope=sc,
                                  return_numpy=False), rep_after)
    rep = _adam_parity(names, m1_of, plain, plain_g.steps, plain_m1.steps,
                       plain_p1.steps[0], {n: sc.get(n) for n in names},
                       rep_m1.steps, rep_p1.steps[0], lr)
    del sc, exe, rep_m1, rep_p1
    modes = (("allreduce", ReduceStrategy.AllReduce, "", dp_mesh, False),
             ("reduce_zero1", ReduceStrategy.Reduce, "", dp_mesh, False),
             ("reduce_scatter_int8_ef", ReduceStrategy.ReduceScatter,
              "int8", dp_mesh, False),
             ("tp", ReduceStrategy.ReduceScatter, "", tp_mesh, True))
    res = {"world": world, "rank": rank, "tp_axes": tp_axes,
           "plain_repeat": rep, "plain_launches": plain_launches,
           "plain": {"losses": plain_losses,
                     "step_ms": float(np.median(plain_secs[1:]) * 1e3)}}
    failed = []
    for label, mode, quant, mesh, tp in modes:
        m, _, lo = _train_program(ptt, cfg, mean_loss=True)
        if tp:
            annotate_tp(m)
        sc = fresh_scope()
        pe = ParallelExecutor(
            use_cuda=True, loss_name=lo.name, main_program=m, scope=sc,
            mesh=mesh, build_strategy=BuildStrategy(
                reduce_strategy=mode, quant_comm=quant,
                comm_error_feedback=bool(quant)))
        pe_m1, pe_p1 = _Snapshots(steps + 1), _Snapshots(1)

        def pe_after(out):
            pe_m1({n: sc.get(m1_of[n]) for n in names})
            if not pe_p1.steps:
                pe_p1({n: sc.get(n) for n in names})
        losses, secs, launches, nccl = timed_steps(
            lambda f: pe.run(fetch_list=[lo], feed=f), pe_after)
        prog = pe.prepare_program()
        par = _adam_parity(names, m1_of, plain, plain_g.steps,
                           plain_m1.steps, plain_p1.steps[0],
                           {n: sc.get(n) for n in names}, pe_m1.steps,
                           pe_p1.steps[0], lr, pe.mesh,
                           lambda name: pe.state_sharding(prog, name))
        del pe_m1, pe_p1
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
        # losses within 1e-5 (float32) or 1e-3 (the int8 wire, lossy by
        # design); the first step's gradients within F32_G_NORM or
        # INT8_G_NORM of each tensor's norm, and its parameters within
        # what Adam makes of the two gradients; after all steps, the
        # parameters within 1e-6 + 1e-5|p| wherever the gradients agreed
        # to a SETTLED-th of themselves, and within Adam's largest move
        # elsewhere (`_adam_parity`).
        checks = [("loss", rel <= (1e-3 if quant else 1e-5)),
                  ("first_step_params", par["p1_beyond"] == 0),
                  ("params", par["beyond_settled"] == 0),
                  ("grads", par["g_norm_rel"][0] <= (
                      INT8_G_NORM if quant else F32_G_NORM)),
                  ("adam_move", par["worst"] <= 2 * lr * (steps + 1)
                   + 1e-5)]
        checks += [(f"launches {k}", launches[k] == cfg["num_layers"] * steps)
                   for k in FLASH]
        checks.append(("nccl", nccl[0] > 0 or not mesh.joined))
        res[label] = {
            "losses": losses, "max_loss_rel": rel,
            "parity": par,
            "step_ms": float(np.median(secs[1:]) * 1e3),
            "step_ms_all": [x * 1e3 for x in secs],
            "launches": {k: launches[k] for k in FLASH},
            "launches_all": launches,
            "nccl_host_calls": nccl[0], "nccl_device_kernels": nccl[1],
            "tp_applied": bool(getattr(prog, "_tp_applied", False)),
            "ops": sorted({op.type for op in prog.global_block().ops
                           if op.type.startswith(("dp_", "tp_"))}),
            "failed": [c for c, ok in checks if not ok],
        }
        failed += [(label, c) for c, ok in checks if not ok]
        del pe, sc
        torch.cuda.empty_cache()
    if world > 1:
        res["ring_sp"] = _ring_over_world(world)
    print("phase42 rank", rank, json.dumps(res), flush=True)
    with open(f"{out_path}.{rank}", "w") as f:
        json.dump(res, f)
    assert not failed, failed


#: Adam's beta1, beta2 and epsilon (optimizer.Adam's defaults, as
#: `_train_program` builds it)
ADAM_BETA1, ADAM_BETA2, ADAM_EPS = 0.9, 0.999, 1e-8
#: the first step's gradients, ||Δg_1|| / ||g_1|| per tensor: float32
#: modes (sums in another order, ReLU kinks at pre-activations within
#: their rounding of 0) and the int8 wire (two roundings, each within
#: half an int8 step of its block's largest magnitude: at most
#: 2 · 8 / 254 of the norm for blocks of 64)
F32_G_NORM = 1e-2
INT8_G_NORM = 2 * 8 / 254
#: an element whose gradient at every step is SETTLED times its own
#: difference from the plain one: Adam's update m/sqrt(v) then moves by
#: at most ~2 / SETTLED of lr a step differently (the first-order terms
#: of m and sqrt(v)), 8e-7 over 4 steps at lr 1e-4, inside the 1e-6
#: floor of the parameter check
SETTLED = 1000.0


class _Snapshots:
    """Copies of a dict of tensors, one a step, into buffers allocated for
    all `k` steps at the first copy, so no later step pays for their
    allocation in its timing. `steps` holds the copies taken."""

    def __init__(self, k):
        self.k, self.steps, self.bufs = k, [], None

    def __call__(self, tensors):
        import torch
        if self.bufs is None:
            self.bufs = [{n: torch.empty_like(t) for n, t in tensors.items()}
                         for _ in range(self.k)]
        buf = self.bufs[len(self.steps)]
        for n, t in tensors.items():
            buf[n].copy_(t)
        self.steps.append(buf)
        return buf


def _sub_block(t, outer, inner, mesh):
    """This rank's block under placement `inner` of its block `t` under
    `outer`, where each dim of `inner` names `outer`'s axes and then more
    (split further by their coordinates, the first major)."""
    def names(s):
        return () if s is None else tuple(s) if isinstance(
            s, (tuple, list)) else (s,)
    for d in range(len(inner)):
        o = names(outer[d]) if d < len(outer) else ()
        extra = names(inner[d])
        assert extra[:len(o)] == o, (outer, inner)
        idx, parts = 0, 1
        for a in extra[len(o):]:
            idx = idx * mesh.axis_size(a) + mesh.axis_index(a)
            parts *= mesh.axis_size(a)
        c = t.shape[d] // parts
        t = t.narrow(d, idx * c, c)
    return t


def _adam_parity(names, m1_of, plain, plain_g, plain_m1, plain_p1, params,
                 m1s, p1, lr, mesh=None, place=None):
    """Phase 42(a)'s parity of one mode's Adam steps with the plain
    Executor's, on this rank's blocks: `place(name)` is the mode's
    placement of a var on `mesh` (None: the plain Executor's own, every
    var whole), and each element is compared where this rank holds the
    first moments (ZeRO-1 splits them, not the parameters). The
    gradients, through the first moments
    m_s = b1 m_(s-1) + (1 - b1) g_s: each step's gradient difference is
    Δg_s = (Δm_s - b1 Δm_(s-1)) / (1 - b1), elementwise. Per step,
    `g_norm_rel` is the largest ||Δg_s|| / ||g_s|| over the tensors and
    `g_rel` the largest max|Δg_s| / max|g_s|; the first step's (from
    equal parameters) is the mode's own, later ones add the parameters'
    divergence. The first step's parameters: Adam moves each by
    lr · m/(|m| + eps1) (m = (1 - b1) g, v = (1 - b2) g², eps1 =
    eps (1 - b1) / sqrt(1 - b2)), so `p1_beyond` counts the elements whose
    difference passes that move's difference for the two first moments,
    plus 1e-6 + 1e-5|p|. After the last step, `beyond` counts the
    elements past 1e-6 + 1e-5|p|; `near` the elements whose plain |g_s|
    fell below SETTLED · |Δg_s| at some step (Adam's update there is not
    held by the gradient's agreement, up to 2 lr a step);
    `beyond_settled` the elements past the bound that are not near;
    `top` lists the tensors with the most elements beyond. For the
    tensors with the largest first-step norm ratio, `first_step_top`
    lists it, max|Δg_1| / max|g_1|, and for a matrix the share of
    ||Δg_1||² in its 8 heaviest columns."""
    import torch
    b1 = ADAM_BETA1
    k = len(m1s)
    st = {"g_norm_rel": [0.0] * k, "g_rel": [0.0] * k, "worst": 0.0,
          "worst_settled": 0.0, "beyond": 0, "near": 0, "beyond_settled": 0,
          "n": 0, "p1_beyond": 0, "p1_worst": 0.0}
    eps1 = ADAM_EPS * (1 - b1) / (1 - ADAM_BETA2) ** 0.5
    per, first = [], []

    def cut(t, name):
        return t if place is None else mesh.local_slice(t, place(name))
    for n in names:
        want = cut(plain[n], n).float()
        diff = (params[n].float() - want).abs()
        diff1 = (p1[n].float() - cut(plain_p1[n], n).float()).abs()
        if place is not None and place(n) != place(m1_of[n]):
            # the moments split further than their parameter (ZeRO-1):
            # this rank's part of its parameter block
            want = cut(plain[n], m1_of[n]).float()
            diff, diff1 = (_sub_block(x, place(n), place(m1_of[n]), mesh)
                           for x in (diff, diff1))
        m, mp = m1s[0][n].float(), cut(plain_m1[0][n], m1_of[n]).float()
        move = lr * (m / (m.abs() + eps1) - mp / (mp.abs() + eps1)).abs()
        p1_tol = move + 1e-6 + 1e-5 * cut(plain_p1[n], m1_of[n]).float().abs()
        st["p1_beyond"] += int((diff1 > p1_tol).sum())
        st["p1_worst"] = max(st["p1_worst"], float((diff1 - move).max()))
        d_prev = None
        near = torch.zeros_like(diff, dtype=torch.bool)
        for s in range(k):
            d = m1s[s][n].float() - cut(plain_m1[s][n], m1_of[n]).float()
            dg = (d if d_prev is None else d - b1 * d_prev).abs() / (1 - b1)
            d_prev = d
            g = cut(plain_g[s][n], m1_of[n]).float()
            near |= g < SETTLED * dg
            gmax, dmax = float(g.max()), float(dg.max())
            nr = float(dg.norm()) / max(float(g.norm()), 1e-30)
            st["g_norm_rel"][s] = max(st["g_norm_rel"][s], nr)
            st["g_rel"][s] = max(st["g_rel"][s], dmax / max(gmax, 1e-30))
            if s == 0:
                conc = None
                if dg.dim() == 2 and dmax > 0:
                    cols = dg.square().sum(0)
                    conc = float(cols.topk(min(8, cols.numel())).values.sum()
                                 / cols.sum())
                first.append((nr, n, dmax / max(gmax, 1e-30), conc))
        beyond = diff > 1e-6 + 1e-5 * want.abs()
        nb = int(beyond.sum())
        st["n"] += diff.numel()
        st["beyond"] += nb
        st["near"] += int(near.sum())
        st["beyond_settled"] += int((beyond & ~near).sum())
        st["worst"] = max(st["worst"], float(diff.max()))
        st["worst_settled"] = max(st["worst_settled"], float(
            torch.where(near, torch.zeros_like(diff), diff).max()))
        per.append((nb, n, diff.numel()))
    st["top"] = sorted(per, reverse=True)[:6]
    st["first_step_top"] = sorted(first, reverse=True)[:6]
    return st


def _ring_over_world(world):
    """Phase 42(c): the distributed ring at the LM's attention shape over
    an sp mesh of the whole world (each rank's sequence block, the K/V
    blocks and then the dK / dV accumulators hopping over NCCL). Each
    rank's output block is held against one K1 call over the whole
    sequence within 3 slacks of `flash_fwd_bound` (as phase 42(b)); its
    dq, dk and dv blocks from autograd (`_RingAttention.backward`) against
    one K2 / K3 call given the ring's own o and lse (the one-process ring's
    forward: the same block calls and merges), within 3 slacks of
    `flash_bwd_dq_bound` / `flash_bwd_dkv_bound`."""
    import torch

    from paddle_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_bound, flash_bwd_dkv_cuda, flash_bwd_dq_bound,
        flash_bwd_dq_cuda, flash_check, flash_delta, flash_fwd_bound,
        flash_fwd_cuda)
    from paddle_tpu_torch.parallel import DeviceMesh
    from paddle_tpu_torch.parallel.ring_attention import (ring_attention,
                                                          ring_forward_local)
    mesh = DeviceMesh(axes={"sp": world})
    gen = torch.Generator().manual_seed(SEED + 43)
    q, k, v, do = (torch.randn(16, 512, 8, 64, generator=gen).to(
        "cuda", torch.bfloat16) for _ in range(4))
    i, t = mesh.axis_index("sp"), 512 // world
    blk = slice(i * t, (i + 1) * t)
    ql, kl, vl = (x[:, blk].clone().requires_grad_() for x in (q, k, v))
    with mesh:
        o = ring_attention(ql, kl, vl, causal=True)
    o.backward(do[:, blk].contiguous())
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    o1, lse1 = flash_fwd_cuda(qh, kh, vh, 0.125, True)
    slack, _ = flash_fwd_bound(qh[:, :, blk], kh[:, :, :(i + 1) * t],
                               vh[:, :, :(i + 1) * t], o1[:, :, blk],
                               lse1[:, :, blk], 0.125, True)
    out = {}
    r = flash_check(o.detach().transpose(1, 2), o1[:, :, blk], 3 * slack)
    out["o"] = r
    o_r, lse_r, _ = ring_forward_local(qh, kh, vh, world, causal=True,
                                       scale=0.125)
    o_r = o_r.to(torch.bfloat16)
    delta = flash_delta(o_r, doh)
    dq1 = flash_bwd_dq_cuda(qh, kh, vh, doh, lse_r, delta, 0.125, True)
    dk1, dv1 = flash_bwd_dkv_cuda(qh, kh, vh, doh, lse_r, delta, 0.125, True)
    got = {"dq": ql.grad, "dk": kl.grad, "dv": vl.grad}
    for hh in range(8):
        sl = slice(hh, hh + 1)
        a = (qh[:, sl], kh[:, sl], vh[:, sl], doh[:, sl], lse_r[:, sl],
             delta[:, sl])
        sdq = flash_bwd_dq_bound(*a, dq1[:, sl], 0.125, True)
        sdk, sdv = flash_bwd_dkv_bound(*a, dk1[:, sl], dv1[:, sl], 0.125,
                                       True)
        for name, ref, sk in (("dq", dq1, sdq), ("dk", dk1, sdk),
                              ("dv", dv1, sdv)):
            g = got[name].transpose(1, 2)[:, sl]
            r = flash_check(g, ref[:, sl, blk], 3 * sk[:, :, blk])
            if name not in out or r["ratio"] > out[name]["ratio"]:
                out[name] = r
    for name, r in out.items():
        assert r["ok"], (name, r)
    return {"err_over_3_slacks": {n: r["ratio"] for n, r in out.items()},
            "max_abs_err_vs_one_call": {n: r["max_abs_err"]
                                        for n, r in out.items()}}


def _ring_one_process(ptt, kernels):
    """Phase 42(b): the ring's own per-step block functions at full width
    in one process, held against one K1-K3 call over the whole sequence.
    Each of the two lies within one slack of the plain version (the
    bounds of ops/flash_attention.py); the ring's bfloat16 block outputs
    and its n logsumexp merges add at most one more (their first-order
    terms, u·A|V| and u·|dS||K|, are among the slack's), so the ring is
    held within 3 slacks (plus the output's bfloat16 step) of the one
    call. The bounds assume both sides take the same lse and delta, so the
    backward ring is held twice: given the one call's residuals, and, as
    `_RingAttention.backward` runs it, given the ring's own bfloat16 o and
    merged lse, against one K2 / K3 call given the same. Returns per case:
    errors, K1 launches, live steps, times."""
    import torch

    from paddle_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_bound, flash_bwd_dkv_cuda, flash_bwd_dq_bound,
        flash_bwd_dq_cuda, flash_check, flash_delta, flash_fwd_bound,
        flash_fwd_cuda)
    from paddle_tpu_torch.parallel.ring_attention import (
        ring_backward_local, ring_forward_local)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED + 44)
    n = RING_BLOCKS
    out = {}
    for label, b, h, t, d, packed in RING_CASES:
        q, k, v, do = (torch.randn(b, h, t, d, generator=gen).to(
            dev, torch.bfloat16) for _ in range(4))
        scale = 1.0 / d ** 0.5
        ids = _segments(gen, b, t, dev) if packed else None

        def one_call():
            o1, lse1 = flash_fwd_cuda(q, k, v, scale, True, ids, ids)
            delta = flash_delta(o1, do)
            dq1 = flash_bwd_dq_cuda(q, k, v, do, lse1, delta, scale, True,
                                    ids, ids)
            dk1, dv1 = flash_bwd_dkv_cuda(q, k, v, do, lse1, delta, scale,
                                          True, ids, ids)
            return o1, lse1, delta, dq1, dk1, dv1

        def ring():
            o, lse, live = ring_forward_local(q, k, v, n, causal=True,
                                              scale=scale, segment_ids=ids)
            ob = o.to(torch.bfloat16)
            dq, dk, dv = ring_backward_local(q, k, v, ob, lse, do, n,
                                             causal=True, scale=scale,
                                             segment_ids=ids)
            return ob, lse, live, dq, dk, dv

        o1, lse1, delta, dq1, dk1, dv1 = one_call()
        kernels.reset_launch_counts()
        o, lse, live = ring_forward_local(q, k, v, n, causal=True,
                                          scale=scale, segment_ids=ids)
        torch.cuda.synchronize()
        fwd_launches = kernels.LAUNCHES["flash_fwd"]
        o = o.to(torch.bfloat16)
        # the backward ring takes the global residuals in (the ring's lse
        # and delta are those of the whole sequence): here the one call's,
        # so the comparison holds the block kernels to the bounds' own
        # premise, the same lse and delta on both sides
        dq, dk, dv = ring_backward_local(q, k, v, o1, lse1, do, n,
                                         causal=True, scale=scale,
                                         segment_ids=ids)
        torch.cuda.synchronize()
        bwd_launches = {k_: kernels.LAUNCHES[k_]
                        for k_ in ("flash_bwd_dq", "flash_bwd_dkv")}
        for name, x in (("o", o), ("lse", lse), ("dq", dq), ("dk", dk),
                        ("dv", dv)):
            assert bool(torch.isfinite(x).all()), f"{label}: {name} has NaN"
        assert fwd_launches == live, (label, fwd_launches, live)
        if not packed:
            assert live == n * (n + 1) // 2, (label, live)
        # the real path's residuals: the ring's own bfloat16 o and merged
        # lse on both sides (the one K2 / K3 call takes them too)
        delta_own = flash_delta(o, do)
        dq1o = flash_bwd_dq_cuda(q, k, v, do, lse, delta_own, scale, True,
                                 ids, ids)
        dk1o, dv1o = flash_bwd_dkv_cuda(q, k, v, do, lse, delta_own, scale,
                                        True, ids, ids)
        dqo, dko, dvo = ring_backward_local(q, k, v, o, lse, do, n,
                                            causal=True, scale=scale,
                                            segment_ids=ids)
        for name, x in (("dq_own", dqo), ("dk_own", dko), ("dv_own", dvo)):
            assert bool(torch.isfinite(x).all()), f"{label}: {name} has NaN"
        # the bounds, one head at a time ([B, 1, T, T] float32 each)
        ratio, ok, err = {}, True, {}
        for hh in range(h):
            sl = slice(hh, hh + 1)
            qh, kh, vh, doh = q[:, sl], k[:, sl], v[:, sl], do[:, sl]
            so, slse = flash_fwd_bound(qh, kh, vh, o1[:, sl], lse1[:, sl],
                                       scale, True, ids, ids)
            checks = [("o", o, o1, so), ("lse", lse, lse1, slse)]
            for sfx, l_, d_, rq, rk, rv, gq, gk, gv in (
                    ("", lse1, delta, dq1, dk1, dv1, dq, dk, dv),
                    ("_own", lse, delta_own, dq1o, dk1o, dv1o, dqo, dko,
                     dvo)):
                sdq = flash_bwd_dq_bound(qh, kh, vh, doh, l_[:, sl],
                                         d_[:, sl], rq[:, sl], scale, True,
                                         ids, ids)
                sdk, sdv = flash_bwd_dkv_bound(qh, kh, vh, doh, l_[:, sl],
                                               d_[:, sl], rk[:, sl],
                                               rv[:, sl], scale, True, ids,
                                               ids)
                checks += [("dq" + sfx, gq.to(torch.bfloat16), rq, sdq),
                           ("dk" + sfx, gk.to(torch.bfloat16), rk, sdk),
                           ("dv" + sfx, gv.to(torch.bfloat16), rv, sdv)]
            for name, got, ref, slack in checks:
                r = flash_check(got[:, sl], ref[:, sl], 3 * slack)
                ratio[name] = max(ratio.get(name, 0.0), r["ratio"])
                err[name] = max(err.get(name, 0.0), r["max_abs_err"])
                ok = ok and r["ok"]
            del so, slse, sdq, sdk, sdv, checks
        if label == "lm":
            # a control the check must reject: a ring whose hops are off
            # by one (each step holds the neighbouring block's K / V)
            kr, vr = (torch.roll(x, t // n, dims=2) for x in (k, v))
            o_c, _, _ = ring_forward_local(q, kr, vr, n, causal=True,
                                           scale=scale)
            so_all, _ = flash_fwd_bound(q, k, v, o1, lse1, scale, True)
            ctrl = flash_check(o_c.to(torch.bfloat16), o1, 3 * so_all)
            assert not ctrl["ok"], ("the ring check admits a ring whose "
                                    "hops are off by one", ctrl)
            ratio["control_off_by_one_hop"] = ctrl["ratio"]
            del kr, vr, o_c, so_all
        log(f"  ring [{label}] B {b} H {h} T {t} D {d}, {n} blocks, causal"
            f"{', packed' if packed else ''}: {live} live steps, K1 "
            f"launched {fwd_launches} times, K2/K3 {bwd_launches}; err / "
            f"(3 slacks) " + ", ".join(f"{k_} {r:.3g}" for k_, r in
                                       ratio.items()))
        assert ok, (label, ratio)
        t_one = _cuda_ms(one_call)
        t_ring = _cuda_ms(ring)
        log(f"    one K1-K3 call {t_one:.3f} ms, the ring's {n} blocks "
            f"{t_ring:.3f} ms (forward + backward, one process)")
        out[label] = {"live_steps": live, "k1_launches": fwd_launches,
                      "bwd_launches": bwd_launches,
                      "err_over_3_slacks": ratio, "max_abs_err": err,
                      "one_call_ms": t_one, "ring_ms": t_ring}
        del q, k, v, do, o, lse, dq, dk, dv, o1, lse1, delta, dq1, dk1, dv1
        del delta_own, dq1o, dk1o, dv1o, dqo, dko, dvo
        torch.cuda.empty_cache()
    return out


def _fmt(xs):
    return "[" + ", ".join(f"{x:.2e}" for x in xs) + "]"


def _cuda_ms(fn, reps=5):
    """Median milliseconds of `fn` between CUDA events, after a warm-up."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return sorted(times)[len(times) // 2]


def parallel_train_and_ring(ptt, kernels):
    """Phase 42: (a) a world over every visible card on NCCL (one rank per
    card: one on a one-card machine) trains phase 7's LM through
    ParallelExecutor in four modes, each held against the plain Executor;
    (b) the ring schedule at full width in this process. Returns the
    numbers for `paths` and the ranks' launch counts."""
    import torch
    world = torch.cuda.device_count()
    root = tempfile.mkdtemp(prefix="chip_smoke_world_")
    try:
        t0 = time.perf_counter()
        ptt.distributed.launch(
            f"{os.path.abspath(__file__)}:phase42_rank", world,
            args=[os.path.join(root, "rank")], place="cuda",
            timeout_s=300, store_dir=root)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            with open(os.path.join(root, f"rank.{r}")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    r0 = ranks[0]
    log(f"  a world of {world} rank(s) on NCCL, spawned, joined, trained "
        f"and left in {spawn_s:.1f} s; tp mesh {r0['tp_axes']}")
    log(f"  plain Executor: losses {r0['plain']['losses']}, step "
        f"{r0['plain']['step_ms']:.1f} ms; run again from the same state: "
        f"largest gradient difference by step "
        f"{_fmt(r0['plain_repeat']['g_rel'])}, parameters beyond "
        f"{r0['plain_repeat']['beyond']}")
    for label in ("allreduce", "reduce_zero1", "reduce_scatter_int8_ef",
                  "tp"):
        m = r0[label]
        par = m["parity"]
        top = [(n, f"{nr:.2e}", c and round(c, 3))
               for nr, n, _, c in par["first_step_top"][:3]]
        log(f"  [{label}] losses {m['losses']} (largest relative difference "
            f"{m['max_loss_rel']:.2e}); gradients by step, the largest "
            f"||Δg|| / ||g|| {_fmt(par['g_norm_rel'])}, max|Δg| / max|g| "
            f"{_fmt(par['g_rel'])}; the first step's largest (tensor, norm "
            f"ratio, share in 8 columns) {top}; parameters: after the first "
            f"step {par['p1_beyond']} past Adam's move of the two gradients, "
            f"after the last largest difference {par['worst']:.2e}, share "
            f"beyond 1e-6 + 1e-5|p| {par['beyond'] / par['n']:.2e}, share "
            f"near (|g| below {SETTLED:g} |Δg|) {par['near'] / par['n']:.2e},"
            f" beyond and not near {par['beyond_settled']}; step "
            f"{m['step_ms']:.1f} ms (plain {r0['plain']['step_ms']:.1f}); "
            f"K1-K3 launches {m['launches']}; NCCL: {m['nccl_host_calls']} "
            f"host calls, {m['nccl_device_kernels']} device kernels in one "
            f"profiled step; ops {m['ops']}"
            f"{'; tp rewrite applied' if m['tp_applied'] else ''}")
    if "ring_sp" in r0:
        parts = ("o", "dq", "dk", "dv")
        ratio = {n: max(r["ring_sp"]["err_over_3_slacks"][n] for r in ranks)
                 for n in parts}
        err = {n: max(r["ring_sp"]["max_abs_err_vs_one_call"][n]
                      for r in ranks) for n in parts}
        log(f"  distributed ring over sp {world}, each rank's blocks against "
            f"one K1-K3 call: largest err / (3 slacks) {ratio}, largest "
            f"errors {err}")
    ring = _ring_one_process(ptt, kernels)
    return {"spawn_s": spawn_s, "ranks": ranks, "ring": ring}

# ---------------------------------------------------------------------------
# phase 43: pipeline-parallel training of phase 7's LM and the planner
# ---------------------------------------------------------------------------

#: (label, stages K, microbatches M, schedule) of phase 43(a)'s runs
PIPE_RUNS = (("k2_gpipe", 2, 4, "gpipe"), ("k2_1f1b", 2, 4, "1f1b"),
             ("k4_1f1b", 4, 8, "1f1b"))
#: the planner's device counts in phase 43(c)
PLAN_DEVICES = (1, 4, 8)


def _lm_steps_feeds(cfg, steps, seed):
    import numpy as np
    rng = np.random.RandomState(seed)
    b, t = cfg["batch"], cfg["max_len"]
    out = []
    for _ in range(steps):
        toks = _markov_tokens(rng, b, t + 1, cfg["vocab"])
        out.append({"tokens": toks[:, :-1].copy(),
                    "tokens@SEQLEN": np.full((b,), t, "int32"),
                    "targets": toks[:, 1:].copy()})
    return out


class _PlainAdam:
    """Phase 7's LM at full width in float32 trained `steps` Adam steps by
    the plain Executor from one init: the reference each pipelined run is
    held to by `_adam_parity` (the gradients of every step through Adam's
    first moments, the parameters after the first and the last step)."""

    def __init__(self, ptt, place, cfg, feeds):
        import torch
        self.ptt, self.place, self.cfg, self.feeds = ptt, place, cfg, feeds
        self.main, start, self.loss = _train_program(ptt, cfg,
                                                     mean_loss=True)
        sc = ptt.Scope()
        ptt.Executor(place).run(start, scope=sc)
        self.init = {n: sc.get(n).clone() for n in sc.local_var_names()}
        del sc
        self.names = [p.name for p in self.main.all_parameters()]
        self.m1_of = {v.accumulator_of: v.name
                      for v in self.main.global_block().vars.values()
                      if getattr(v, "accumulator_of", None) in self.names
                      and "_moment1_acc" in v.name}
        steps = len(feeds)
        sc = self.scope()
        exe = ptt.Executor(place)
        fetch = [self.loss] + [n + "@GRAD" for n in self.names]
        self.g, self.m1, self.p1 = (_Snapshots(steps), _Snapshots(steps),
                                    _Snapshots(1))

        def after(out):
            for g in self.g(dict(zip(self.names, out[1:]))).values():
                g.abs_()
            self._after(sc, self.m1, self.p1)
        self.losses, self.secs = self.steps(
            lambda f: exe.run(self.main, feed=f, fetch_list=fetch,
                              scope=sc, return_numpy=False), after)
        self.params = {n: sc.get(n).clone() for n in self.names}
        del sc, exe
        torch.cuda.empty_cache()

    def scope(self):
        sc = self.ptt.Scope()
        for n, v in self.init.items():
            sc.set_var(n, v.clone())
        return sc

    def _after(self, sc, m1, p1):
        m1({n: sc.get(self.m1_of[n]) for n in self.names})
        if not p1.steps:
            p1({n: sc.get(n) for n in self.names})

    def steps(self, run, after):
        import numpy as np
        import torch
        losses, secs = [], []
        for f in self.feeds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run(f)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            x = out[0]
            losses.append(float(x.reshape(-1)[0]) if torch.is_tensor(x)
                          else float(np.asarray(x).ravel()[0]))
            after(out)
        return losses, secs

    def parity(self, sc, m1, p1, mesh=None, place=None):
        """`_adam_parity` of a run's state against the plain one, and the
        checks phase 42 makes of it (float32)."""
        par = _adam_parity(self.names, self.m1_of, self.params,
                           self.g.steps, self.m1.steps, self.p1.steps[0],
                           {n: sc.get(n) for n in self.names}, m1.steps,
                           p1.steps[0], self.cfg["lr"], mesh, place)
        steps = len(self.feeds)
        return par, [("first_step_params", par["p1_beyond"] == 0),
                     ("params", par["beyond_settled"] == 0),
                     ("grads", par["g_norm_rel"][0] <= F32_G_NORM),
                     ("adam_move", par["worst"] <= 2 * self.cfg["lr"]
                      * steps + 1e-5)]


def _pipeline_tables(prog, rows):
    """(schedule census, per-stage live transfers) of a partitioned
    program at `rows` rows a microbatch, read off the tick tables."""
    from paddle_tpu_torch.parallel import pipeline
    region = next(op for op in prog.global_block().ops
                  if op.type == "pp_pipeline_region")
    a = region.attrs
    sched = pipeline.build_schedule(a["schedule"], a["num_microbatches"],
                                    a["num_stages"])
    return (pipeline.schedule_census(a["schedule"], a["num_microbatches"],
                                     a["num_stages"]),
            pipeline.pp_live_transfers(
                sched, pipeline.cut_numels(prog.global_block(), rows)))


def _pipeline_one_card(ptt, kernels, plain):
    """Phase 43(a): the partitioned LM through the one-process engine
    (every stage on this card, the tables' stashes, recompute and
    accumulation), at K 2 / M 4 under gpipe and 1f1b and K 4 / M 8 under
    1f1b, 3 Adam steps each from the plain run's init."""
    import numpy as np
    import torch

    from paddle_tpu_torch.framework.passes import get_pass
    from paddle_tpu_torch.parallel import pipeline
    cfg, place = plain.cfg, plain.place
    L = cfg["num_layers"]
    steps = len(plain.feeds)
    out, failed = {}, []
    for label, k, m, schedule in PIPE_RUNS:
        prog = get_pass("pipeline_partition_pass", num_stages=k,
                        num_microbatches=m, schedule=schedule, dp_axis="",
                        reduce_dp=False)(plain.main)
        region = next(op for op in prog.global_block().ops
                      if op.type == "pp_pipeline_region")
        census, live = _pipeline_tables(prog, cfg["batch"] // m)
        sc = plain.scope()
        exe = ptt.Executor(place)
        m1, p1 = _Snapshots(steps), _Snapshots(1)
        peaks, moved = [], []

        def after(_out):
            plain._after(sc, m1, p1)
            peaks.append(list(pipeline.LAST_STEP["peak_stash_per_stage"]))
            moved.append(pipeline.LAST_STEP["moved_bytes"])
        kernels.reset_launch_counts()
        losses, secs = plain.steps(
            lambda f: pipeline.run_one_process(
                exe, prog, feed=f, fetch_list=[plain.loss], scope=sc,
                return_numpy=False), after)
        launches = {kk: kernels.LAUNCHES[kk] for kk in FLASH}
        par, checks = plain.parity(sc, m1, p1)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain.losses))
        tables_bytes = sum(x["send_bytes"] for x in live)
        want = {"flash_fwd": 2 * L * m * steps,
                "flash_bwd_dq": L * m * steps,
                "flash_bwd_dkv": L * m * steps}
        checks += [("loss", rel <= 1e-5),
                   ("peak_stash", all(p == census["peak_stash_per_stage"]
                                      for p in peaks)),
                   ("boundary_bytes", all(b == tables_bytes
                                          for b in moved))]
        checks += [(f"launches {kk}", launches[kk] == want[kk])
                   for kk in FLASH]
        out[label] = {
            "stages": k, "microbatches": m, "schedule": schedule,
            "stage_ops": [len(s) for s in region.attrs["stages"]],
            "cuts": [op.inputs["X"] for op in prog.global_block().ops
                     if op.type == "pp_send"],
            "losses": losses, "max_loss_rel": rel, "parity": par,
            "step_ms": float(np.median(secs[1:]) * 1e3),
            "step_ms_all": [x * 1e3 for x in secs],
            "launches_per_step": {kk: launches[kk] / steps for kk in FLASH},
            "launches_expected_per_step": {kk: want[kk] / steps
                                           for kk in FLASH},
            "peak_stash_per_stage": peaks[-1],
            "census_peak_stash_per_stage": census["peak_stash_per_stage"],
            "boundary_bytes_per_step": moved[-1],
            "tables_boundary_bytes_per_step": tables_bytes,
            "jax_engine_boundary_bytes_per_step": pipeline.
            pp_boundary_wire_bytes(prog, cfg["batch"] // m)[
                "pp_boundary_bytes"],
            "bubble_fraction": census["bubble_fraction"],
            "failed": [c for c, ok in checks if not ok],
        }
        failed += [(label, c) for c, ok in checks if not ok]
        del exe, sc, m1, p1
        torch.cuda.empty_cache()
    return out, failed


def phase43_rank(rank, world, out_path):
    """One rank of phase 43(b)-(c)'s NCCL world over every visible card
    (two or more): pp = world through ParallelExecutor, and at four cards
    dp 2 x pp 2 under AllReduce and ReduceScatter, then
    `BuildStrategy.auto_parallel`; each 3 Adam steps held against the
    plain Executor on this card as phase 43(a) holds its runs, and one
    profiled step's measured census held to the engine's tables (the
    point-to-point sends) and to `costs.predicted_wire_bytes`. Writes the
    rank's numbers to out_path.<rank> and prints them; any mismatch then
    raises."""
    import torch

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.framework import costs
    from paddle_tpu_torch.parallel import (BuildStrategy, DeviceMesh,
                                           ParallelExecutor, ReduceStrategy,
                                           pipeline)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ptt.flags.set_flag("use_bf16_matmul", False)
    kernels.build(["flash_attention"])
    place = ptt.CUDAPlace(torch.cuda.current_device())
    cfg = TRAIN
    plain = _PlainAdam(ptt, place, cfg,
                       _lm_steps_feeds(cfg, PARALLEL_STEPS, SEED + 43))
    modes = [(f"pp{world}", {"pp": world}, 2 * world, "AllReduce")]
    if world == 4:
        modes += [("dp2pp2_allreduce", {"dp": 2, "pp": 2}, 4, "AllReduce"),
                  ("dp2pp2_reduce_scatter", {"dp": 2, "pp": 2}, 4,
                   "ReduceScatter")]
    meshes = {label: DeviceMesh(axes=axes) for label, axes, _, _ in modes}
    res = {"world": world, "rank": rank,
           "plain": {"losses": plain.losses, "step_ms": float(
               sorted(plain.secs[1:])[len(plain.secs[1:]) // 2] * 1e3)}}
    failed = []
    runs = [(label, meshes[label], BuildStrategy(
        pipeline_stages=axes["pp"], num_microbatches=m,
        pipeline_schedule="1f1b",
        reduce_strategy=getattr(ReduceStrategy, mode)))
        for label, axes, m, mode in modes]
    runs.append(("auto_parallel", DeviceMesh(axes={"dp": world}),
                 BuildStrategy(auto_parallel=True)))
    for label, mesh, bst in runs:
        m_, _, lo = _train_program(ptt, cfg, mean_loss=True)
        sc = plain.scope()
        pe = ParallelExecutor(use_cuda=True, loss_name=lo.name,
                              main_program=m_, scope=sc, mesh=mesh,
                              build_strategy=bst)
        m1, p1 = _Snapshots(PARALLEL_STEPS), _Snapshots(1)
        kernels.reset_launch_counts()
        losses, secs = plain.steps(
            lambda f: pe.run(fetch_list=[lo], feed=f),
            lambda _o: plain._after(sc, m1, p1))
        launches = {k: kernels.LAUNCHES[k] for k in FLASH}
        prog = pe.prepare_program()
        par, checks = plain.parity(
            sc, m1, p1, pe.mesh, lambda n: pe.state_sharding(prog, n))
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain.losses))
        checks.append(("loss", rel <= 1e-5))
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU],
                record_shapes=True) as prof:
            pe.run(fetch_list=[lo], feed=plain.feeds[0])
            torch.cuda.synchronize()
        r = {"mesh": dict(pe.mesh.axes), "losses": losses,
             "max_loss_rel": rel, "parity": par,
             "step_ms": float(sorted(secs[1:])[len(secs[1:]) // 2] * 1e3),
             "launches": launches}
        try:
            census = costs.measured_collective_census(prof)
        except ValueError as e:
            # the events the census could not read, for the log
            r["census_error"] = str(e)
            r["comm_events"] = [
                [e.name(), str(e.shapes()), str(e.dtypes()),
                 str(e.extra_meta() if hasattr(e, "extra_meta") else "")]
                for e in prof.profiler.kineto_results.events()
                if e.name().startswith(("c10d::", "nccl:", "gloo:"))
                or e.name() == "record_param_comms"][:80]
            census = {}
        sends = census.pop("collective-permute", [])
        n = max(pe.mesh.axis_size(a) for a in pe.mesh.axes)
        wire = costs.census_wire_bytes(census, n, min_bytes=16)
        predicted = costs.predicted_wire_bytes(
            pe.cost_report(nominal_batch=cfg["batch"]))
        checks += [("census", "census_error" not in r),
                   ("census_wire", abs(wire - predicted) <= 1.0)]
        r.update(census_wire_bytes=wire, predicted_wire_bytes=predicted,
                 p2p_sends=[len(sends), sum(b for b, _ in sends)])
        if getattr(prog, "_pp_applied", False):
            census_pp, live = _pipeline_tables(
                prog, cfg["batch"] // pe.mesh.axis_size("dp")
                // prog._pp_microbatches)
            k = pe.mesh.axis_index("pp")
            r["tables_sends"] = [live[k]["sends"], live[k]["send_bytes"]]
            r["peak_stash"] = pipeline.LAST_STEP["peak_stash_per_stage"]
            checks += [("p2p_sends", r["p2p_sends"] == r["tables_sends"]),
                       ("peak_stash", r["peak_stash"] == [
                           census_pp["peak_stash_per_stage"][k]])]
        if label == "auto_parallel":
            r["chosen"] = pe.auto_plan_report().point.describe()
        r["failed"] = [c for c, ok in checks if not ok]
        failed += [(label, c) for c, ok in checks if not ok]
        res[label] = r
        del pe, sc, m1, p1
        torch.cuda.empty_cache()
    print("phase43 rank", rank, json.dumps(res), flush=True)
    with open(f"{out_path}.{rank}", "w") as f:
        json.dump(res, f)
    assert not failed, failed


def _plan_on_one_card(ptt, kernels, plain):
    """Phase 43(c) on one card: the planner prices phase 7's LM for 1, 4
    and 8 devices; `ParallelExecutor(auto_parallel=True)` on this card (a
    mesh of one rank) adopts its plan and trains 3 steps held against the
    plain Executor, and one profiled step's measured census is held to the
    adopted strategy's `predicted_wire_bytes`."""
    import torch

    from paddle_tpu_torch.framework import auto_parallel, costs
    from paddle_tpu_torch.parallel import (BuildStrategy, DeviceMesh,
                                           ParallelExecutor)
    cfg = plain.cfg
    out, failed = {"plans": {}}, []
    for n in PLAN_DEVICES:
        t0 = time.perf_counter()
        r = auto_parallel.plan(plain.main, n, nominal_batch=cfg["batch"])
        out["plans"][n] = {"chosen": r.point.describe(),
                           "mesh_axes": r.mesh_axes,
                           "predicted_step_ms": r.predicted_step_s * 1e3,
                           "device_bytes": r.device_bytes,
                           "n_enumerated": r.n_enumerated,
                           "n_feasible": r.n_feasible,
                           "rejections": r.rejections,
                           "search_s": time.perf_counter() - t0}
    m_, _, lo = _train_program(ptt, cfg, mean_loss=True)
    sc = plain.scope()
    pe = ParallelExecutor(use_cuda=True, loss_name=lo.name, main_program=m_,
                          scope=sc, mesh=DeviceMesh(axes={"dp": 1}),
                          build_strategy=BuildStrategy(auto_parallel=True))
    m1, p1 = _Snapshots(PARALLEL_STEPS), _Snapshots(1)
    kernels.reset_launch_counts()
    losses, secs = plain.steps(lambda f: pe.run(fetch_list=[lo], feed=f),
                               lambda _o: plain._after(sc, m1, p1))
    launches = {k: kernels.LAUNCHES[k] for k in FLASH}
    par, checks = plain.parity(sc, m1, p1)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain.losses))
    checks.append(("loss", rel <= 1e-5))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        pe.run(fetch_list=[lo], feed=plain.feeds[0])
        torch.cuda.synchronize()
    census = costs.measured_collective_census(prof)
    wire = costs.census_wire_bytes(census, 1, min_bytes=16)
    predicted = costs.predicted_wire_bytes(
        pe.cost_report(nominal_batch=cfg["batch"]))
    checks.append(("census_wire", abs(wire - predicted) <= 1.0))
    checks += [(f"launches {k}", launches[k] > 0) for k in FLASH]
    out["adopted"] = {
        "chosen": pe.auto_plan_report().point.describe(),
        "mesh": dict(pe.mesh.axes), "losses": losses, "max_loss_rel": rel,
        "parity": par, "launches": launches,
        "step_ms": float(sorted(secs[1:])[len(secs[1:]) // 2] * 1e3),
        "census": {k: len(v) for k, v in census.items()},
        "census_wire_bytes": wire, "predicted_wire_bytes": predicted,
        "failed": [c for c, ok in checks if not ok]}
    failed += [("auto_parallel", c) for c, ok in checks if not ok]
    del pe, sc
    torch.cuda.empty_cache()
    return out, failed


def pipeline_train_and_plan(ptt, kernels):
    """Phase 43: (a) the pipelined LM on this card in one process; (b) a
    world over every visible card through ParallelExecutor (pp = world,
    dp 2 x pp 2 at four cards), or, on one card, pp 2 refused with the
    JAX package's mesh-size error; (c) the planner and its adoption."""
    import torch

    from paddle_tpu_torch.core.enforce import InvalidArgumentError
    from paddle_tpu_torch.parallel import (BuildStrategy, DeviceMesh,
                                           ParallelExecutor)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    old = ptt.flags.get_flag("use_bf16_matmul")
    ptt.flags.set_flag("use_bf16_matmul", False)
    try:
        place = ptt.CUDAPlace(0)
        cfg = TRAIN
        t0 = time.perf_counter()
        plain = _PlainAdam(ptt, place, cfg,
                           _lm_steps_feeds(cfg, PARALLEL_STEPS, SEED + 43))
        out = {"plain": {"losses": plain.losses,
                         "step_ms": float(sorted(plain.secs[1:])[
                             len(plain.secs[1:]) // 2] * 1e3)}}
        runs, failed = _pipeline_one_card(ptt, kernels, plain)
        out["one_card"] = runs
        for label, r in runs.items():
            par = r["parity"]
            log(f"  (a) [{label}] stages of {r['stage_ops']} ops, cuts "
                f"{r['cuts']}; losses {r['losses']} (plain "
                f"{plain.losses}, largest relative difference "
                f"{r['max_loss_rel']:.2e}); gradients by step, the largest "
                f"||Δg|| / ||g|| {_fmt(par['g_norm_rel'])}; parameters: "
                f"after the first step {par['p1_beyond']} past Adam's move, "
                f"after the last largest difference {par['worst']:.2e}, "
                f"beyond and not near {par['beyond_settled']}; K1-K3 a step "
                f"{r['launches_per_step']} (2·L·M / L·M: "
                f"{r['launches_expected_per_step']}); peak stash "
                f"{r['peak_stash_per_stage']} (census "
                f"{r['census_peak_stash_per_stage']}); boundary bytes a step "
                f"{r['boundary_bytes_per_step']} (tables "
                f"{r['tables_boundary_bytes_per_step']}; the JAX engine's "
                f"every-tick shifts {r['jax_engine_boundary_bytes_per_step']})"
                f"; step {r['step_ms']:.1f} ms (plain "
                f"{out['plain']['step_ms']:.1f}); failed {r['failed']}")
        world = torch.cuda.device_count()
        if world >= 2:
            root = tempfile.mkdtemp(prefix="chip_smoke_pp_world_")
            try:
                ptt.distributed.launch(
                    f"{os.path.abspath(__file__)}:phase43_rank", world,
                    args=[os.path.join(root, "rank")], place="cuda",
                    timeout_s=300, store_dir=root)
                ranks = []
                for r in range(world):
                    with open(os.path.join(root, f"rank.{r}")) as f:
                        ranks.append(json.load(f))
            finally:
                shutil.rmtree(root, ignore_errors=True)
            out["world"] = ranks
            for label, r in ranks[0].items():
                if isinstance(r, dict) and "parity" in r:
                    log(f"  (b) [{label}] mesh {r['mesh']}: losses "
                        f"{r['losses']} (largest relative difference "
                        f"{r['max_loss_rel']:.2e}); gradients ||Δg|| / ||g||"
                        f" {_fmt(r['parity']['g_norm_rel'])}; census wire "
                        f"{r['census_wire_bytes']} (predicted "
                        f"{r['predicted_wire_bytes']}); p2p sends "
                        f"{r['p2p_sends']} (tables "
                        f"{r.get('tables_sends')}); step {r['step_ms']:.1f} "
                        f"ms; {r.get('chosen', '')}")
        else:
            m_, _, lo = _train_program(ptt, cfg, mean_loss=True)
            pe = ParallelExecutor(
                use_cuda=True, loss_name=lo.name, main_program=m_,
                scope=plain.scope(), mesh=DeviceMesh(axes={"dp": 1}),
                build_strategy=BuildStrategy(pipeline_stages=2,
                                             num_microbatches=4))
            try:
                pe.run(fetch_list=[lo], feed=plain.feeds[0])
                refused = ""
            except InvalidArgumentError as e:
                refused = str(e)
            want = ("BuildStrategy.pipeline_stages=2 needs a 'pp' mesh axis "
                    "of exactly that size; this mesh has axes {'dp': 1}")
            out["refused"] = refused
            log(f"  (b) one card: pp 2 on a world of one refused: "
                f"{refused!r}")
            if refused != want:
                failed.append(("one_card_refusal", refused))
        plans, plan_failed = _plan_on_one_card(ptt, kernels, plain)
        failed += plan_failed
        out["planner"] = plans
        for n, p in plans["plans"].items():
            log(f"  (c) plan for {n} device(s): {p['chosen']} "
                f"{p['mesh_axes']}, predicted {p['predicted_step_ms']:.3f} "
                f"ms, {p['device_bytes'] / 2**30:.2f} GiB a device, "
                f"{p['n_feasible']} of {p['n_enumerated']} points feasible, "
                f"rejections {p['rejections']}, {p['search_s']:.1f} s")
        a = plans["adopted"]
        log(f"  (c) adopted on this card: {a['chosen']} {a['mesh']}; losses "
            f"{a['losses']} (largest relative difference "
            f"{a['max_loss_rel']:.2e}); census {a['census']}, wire "
            f"{a['census_wire_bytes']} (predicted "
            f"{a['predicted_wire_bytes']}); failed {a['failed']}")
        out["phase_s"] = time.perf_counter() - t0
        log(f"  phase 43 in {out['phase_s']:.1f} s")
        assert not failed, f"phase 43: {failed}"
        return out
    finally:
        ptt.flags.set_flag("use_bf16_matmul", old)


# ---------------------------------------------------------------------------
# phase 44: elastic training of phase 7's LM (snapshots, crash and resume)
# ---------------------------------------------------------------------------

#: (a): the uninterrupted run's steps, and the step after which a run
#: snapshots; (b): the supervised child's steps and its snapshot interval
ELASTIC_STEPS, ELASTIC_SAVE_AT = 4, 2
CHILD_STEPS, CHILD_INTERVAL = 6, 2
#: (a)'s two modes: (label, ReduceStrategy name, quantized wire)
ELASTIC_MODES = (("reduce_zero1", "Reduce", ""),
                 ("reduce_scatter_int8_ef", "ReduceScatter", "int8"))


def _state_bytes(main):
    """The bytes of the program's persistable state (what a snapshot of
    it writes, less the containers' headers)."""
    import numpy as np
    from paddle_tpu_torch.core.dtypes import convert_dtype
    total = 0
    for v in main.global_block().vars.values():
        if v.persistable and v.shape and -1 not in v.shape:
            import torch
            total += int(np.prod(v.shape)) * torch.empty(
                (), dtype=convert_dtype(v.dtype)).element_size()
    return total


def _state_of(scope):
    return {n: scope.get(n).detach().clone() for n in scope.local_var_names()
            if hasattr(scope.get(n), "detach")}


def _bitwise(a, b):
    """Names whose tensors differ in any bit (or are missing) between two
    state dicts."""
    import torch
    bad = sorted(set(a) ^ set(b))
    for n in sorted(set(a) & set(b)):
        x, y = a[n], b[n]
        if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(
                x.reshape(-1).view(torch.uint8) if x.dtype != torch.bool
                else x, y.reshape(-1).view(torch.uint8)
                if y.dtype != torch.bool else y):
            bad.append(n)
    return bad


class _ElasticLM:
    """Phase 7's LM at full width in float32 through ParallelExecutor on
    `mesh` in one mode, from phase 44's one init: `steps(feeds)` runs them
    timed, each step's K1-K3 launches counted from zero around it."""

    def __init__(self, ptt, kernels, init, mode, quant, mesh,
                 auto=False):
        from paddle_tpu_torch.parallel import (BuildStrategy,
                                               ParallelExecutor,
                                               ReduceStrategy)
        self.kernels = kernels
        self.main, _, self.loss = _train_program(ptt, TRAIN, mean_loss=True)
        self.scope = ptt.Scope()
        for n, v in init.items():
            self.scope.set_var(n, v.clone())
        bst = (BuildStrategy(auto_parallel=True) if auto else
               BuildStrategy(reduce_strategy=getattr(ReduceStrategy, mode),
                             quant_comm=quant,
                             comm_error_feedback=bool(quant)))
        self.pe = ParallelExecutor(use_cuda=True, loss_name=self.loss.name,
                                   main_program=self.main, scope=self.scope,
                                   mesh=mesh, build_strategy=bst)

    def steps(self, feeds):
        import torch
        losses, secs, launches = [], [], []
        for f in feeds:
            torch.cuda.synchronize()
            self.kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out = self.pe.run(fetch_list=[self.loss], feed=f,
                              return_numpy=False)
            losses.append(float(out[0].reshape(-1)[0]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            launches.append({k: self.kernels.LAUNCHES[k] for k in FLASH})
        return losses, secs, launches


def _snapshot_resume_one_card(ptt, kernels, mesh, init, feeds, root):
    """Phase 44(a): in each mode, the uninterrupted run; a run that
    snapshots after step 2 without blocking (block=False: the copy on
    the side stream, ordered before step 3's in-place updates) and runs
    on; a fresh scope and executor restoring that snapshot; the same with
    block=True. Every run's losses, state and per-step K1-K3 launches
    must be bitwise the uninterrupted run's."""
    import torch
    from paddle_tpu_torch.parallel import elastic
    out, failed = {}, []
    k = ELASTIC_SAVE_AT
    for label, mode, quant in ELASTIC_MODES:
        ref = _ElasticLM(ptt, kernels, init, mode, quant, mesh)
        ref_l, ref_s, ref_n = ref.steps(feeds)
        ref_state = _state_of(ref.scope)
        snap_bytes = _state_bytes(ref.pe.prepare_program())
        del ref
        r = {"losses": ref_l, "step_ms": [x * 1e3 for x in ref_s],
             "launches_per_step": ref_n, "state_bytes": snap_bytes}
        for block in (False, True):
            tag = "block" if block else "async"
            root_b = os.path.join(root, f"{label}_{tag}")
            run = _ElasticLM(ptt, kernels, init, mode, quant, mesh)
            l1, s1, n1 = run.steps(feeds[:k])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = elastic.save_train_state(root_b, executor=run.pe,
                                         program=run.main, scope=run.scope,
                                         step=k, block=block)
            call_s = time.perf_counter() - t0
            l2, s2, n2 = run.steps(feeds[k:])
            if not block:
                t0 = time.perf_counter()
                path = h.result(timeout=600)
                drain_s = time.perf_counter() - t0
            else:
                path, drain_s = h, 0.0
            stats = dict(elastic.last_save)
            assert stats["path"] == path
            got = _bitwise(_state_of(run.scope), ref_state)
            del run
            fresh = _ElasticLM(ptt, kernels, init, mode, quant, mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            meta = elastic.restore_train_state(
                path, program=fresh.main, scope=fresh.scope,
                executor=fresh.pe)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            l3, s3, n3 = fresh.steps(feeds[k:])
            resumed = _bitwise(_state_of(fresh.scope), ref_state)
            del fresh
            nbytes = stats["bytes"]
            r[tag] = {
                "losses": l1 + l2, "resumed_losses": l3,
                "save_call_ms": call_s * 1e3,
                "step_after_save_ms": s2[0] * 1e3,
                "step_path_cost_ms": (call_s + s2[0] - ref_s[k]) * 1e3,
                "drain_after_steps_ms": drain_s * 1e3,
                "snapshot_bytes": nbytes,
                "d2h_gb_s": (nbytes / stats["d2h_s"] / 1e9
                             if stats["d2h_s"] else None),
                "write_gb_s": nbytes / stats["write_s"] / 1e9,
                "write_s": stats["write_s"], "restore_s": restore_s,
                "restored_run_counter": meta["run_counter"],
                "launches_per_step": n1 + n2,
                "resumed_launches_per_step": n3,
                "state_not_bitwise": got, "resumed_not_bitwise": resumed}
            checks = [(f"{label}_{tag}_losses", l1 + l2 == ref_l),
                      (f"{label}_{tag}_state", not got),
                      (f"{label}_{tag}_resumed_losses", l3 == ref_l[k:]),
                      (f"{label}_{tag}_resumed_state", not resumed),
                      (f"{label}_{tag}_launches", n1 + n2 == ref_n),
                      (f"{label}_{tag}_resumed_launches", n3 == ref_n[k:]),
                      (f"{label}_{tag}_bytes",
                       abs(nbytes - snap_bytes) <= 0.01 * snap_bytes)]
            failed += [c for c, ok in checks if not ok]
            x = r[tag]
            log(f"  (a) [{label}, {tag}] losses {x['losses']} (uninterrupted"
                f" {ref_l}); restored: {l3}; state bitwise: "
                f"{not got and not resumed} (differing {got + resumed}); "
                f"snapshot {nbytes / 1e9:.3f} GB (program's state "
                f"{snap_bytes / 1e9:.3f} GB); save call "
                f"{x['save_call_ms']:.1f} ms, the next step "
                f"{x['step_after_save_ms']:.1f} ms (uninterrupted "
                f"{ref_s[k] * 1e3:.1f}), on the step path "
                f"{x['step_path_cost_ms']:.1f} ms; d2h "
                f"{x['d2h_gb_s'] or 0:.2f} GB/s, write+commit "
                f"{stats['write_s']:.2f} s ({x['write_gb_s']:.2f} GB/s); "
                f"restore {restore_s:.2f} s; K1-K3 a step "
                f"{n3[0]} (uninterrupted {ref_n[k]})")
        out[label] = r
    return out, failed


def _replan_one_card(ptt, kernels, mesh, init, feeds, root):
    """Phase 44(c) on one card: the plain Executor's snapshot (no mesh)
    restored into ParallelExecutor(auto_parallel=True) on the world of
    one: the saved world differs from the mesh, so replan_on_restore
    prices keeping against re-planning; the next 2 steps are held
    against the plain run's (losses 1e-5 relative, parameters within
    Adam's move)."""
    import torch
    from paddle_tpu_torch.parallel import elastic
    k = ELASTIC_SAVE_AT
    main, start, loss = _train_program(ptt, TRAIN, mean_loss=True)
    sc = ptt.Scope()
    for n, v in init.items():
        sc.set_var(n, v.clone())
    exe = ptt.Executor(ptt.CUDAPlace(0))
    plain = []
    for i, f in enumerate(feeds):
        plain.append(float(exe.run(main, feed=f, fetch_list=[loss],
                                   scope=sc)[0]))
        if i + 1 == k:
            path = elastic.save_train_state(os.path.join(root, "plain"),
                                            program=main, scope=sc,
                                            executor=exe, step=k)
    want = {p.name: sc.get(p.name).clone() for p in main.all_parameters()}
    del sc, exe
    run = _ElasticLM(ptt, kernels, init, None, "", mesh, auto=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meta = elastic.restore_train_state(path, program=run.main,
                                       scope=run.scope, executor=run.pe)
    restore_s = time.perf_counter() - t0
    losses, _, launches = run.steps(feeds[k:])
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain[k:]))
    worst = max(float((run.scope.get(n) - w).abs().max())
                for n, w in want.items())
    rp = meta["replan"]
    out = {"replan": {"replanned": rp["replanned"],
                      "kept": rp["kept"]["strategy"],
                      "chosen": rp["chosen"]["point"],
                      "gain_s_per_step": rp["gain_s_per_step"],
                      "amortize_steps": rp["amortize_steps"],
                      "search_s": rp["search_s"]},
           "losses": losses, "plain_losses": plain[k:],
           "max_loss_rel": rel, "param_worst": worst,
           "restore_s": restore_s, "launches_per_step": launches}
    log(f"  (c) one card: the plain Executor's snapshot (world {{}}) into "
        f"ParallelExecutor(auto_parallel) on {dict(mesh.axes)}: replan "
        f"{out['replan']}; losses {losses} (plain {plain[k:]}, largest "
        f"relative difference {rel:.2e}); parameters within {worst:.2e} "
        f"(Adam's move {2 * TRAIN['lr'] * k:.1e}); read "
        f"{meta['restore_read_bytes']} B (the reshard plan's "
        f"{meta['reshard']['rank_read_bytes']}); restore "
        f"{restore_s:.2f} s; K1-K3 a step {launches[0]}")
    out["read_bytes"] = meta["restore_read_bytes"]
    out["planned_read_bytes"] = meta["reshard"]["rank_read_bytes"]
    failed = [c for c, ok in (("replan_losses", rel <= 1e-5),
                              ("replan_params",
                               worst <= 2 * TRAIN["lr"] * k + 1e-6),
                              ("replan_read_bytes", out["read_bytes"]
                               == out["planned_read_bytes"]))
              if not ok]
    return out, failed


def phase44_child(root, out, fault=""):
    """Phase 44(b)'s child (`chip_smoke.py --phase44-child root out
    [fault]`): phase 7's LM in float32 through Trainer, CHILD_STEPS
    steps, an async elastic snapshot every CHILD_INTERVAL steps, resuming
    from the latest committed one. `fault` arms PTPU_FAULT_INJECT in the
    first incarnation only (a file in `root` marks it): `crash_at_step`
    kills the process before step 4 (after the step-2 snapshot
    committed); `crash_mid_save:<offset>` kills it that far into the
    step-4 snapshot's staged payload. Writes its state, the step it
    resumed at and each step's K1-K3 launches to `out` (torch.save)."""
    import torch

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.parallel import elastic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ptt.flags.set_flag("use_bf16_matmul", False)
    kernels.build(["flash_attention"])
    armed = os.path.join(root, "armed")
    arm = bool(fault) and not os.path.exists(armed)
    if arm:
        os.makedirs(root, exist_ok=True)
        open(armed, "w").close()
    feeds = _lm_steps_feeds(TRAIN, CHILD_STEPS, SEED + 44)

    def samples():
        for f in feeds:
            yield from zip(f["tokens"], f["targets"])

    def train_func():
        from paddle_tpu_torch.models import transformer
        c = TRAIN
        return transformer.transformer_lm(
            vocab=c["vocab"], max_len=c["max_len"], d_model=c["d_model"],
            d_inner=c["d_inner"], num_heads=c["num_heads"],
            num_layers=c["num_layers"], mean_loss=True)[0]

    # epoch_interval 2: one epoch here, so its end snapshots once (the
    # final snapshot), not twice with the same state
    cfg = ptt.CheckpointConfig(os.path.join(root, "ckpt"),
                               step_interval=CHILD_INTERVAL,
                               epoch_interval=2, elastic=True,
                               async_save=True)
    with ptt.unique_name.guard():
        tr = ptt.Trainer(train_func,
                         lambda: ptt.optimizer.Adam(learning_rate=TRAIN["lr"]),
                         place=ptt.CUDAPlace(0), checkpoint_config=cfg)
    resumed_at = cfg.step_id
    launches, losses = [], []

    def handler(ev):
        if isinstance(ev, ptt.BeginStepEvent):
            kernels.reset_launch_counts()
        elif isinstance(ev, ptt.EndStepEvent):
            losses.append(float(ev.metrics[0]))
            launches.append({k: kernels.LAUNCHES[k] for k in FLASH})
            if arm and ev.step == 2:
                # the step-2 snapshot commits before the fault arms
                elastic.wait_for_pending()
                os.environ["PTPU_FAULT_INJECT"] = (
                    "crash_at_step:4" if fault == "crash_at_step"
                    else fault)

    reader = ptt.data.batch(samples, TRAIN["batch"])
    tr.train(1, handler, reader, ["tokens", "targets"])
    torch.save({"state": {n: v.cpu() for n, v in _state_of(tr.scope)
                          .items()},
                "resumed_at": resumed_at, "losses": losses,
                "launches": launches}, out)


def _supervised_crashes(ptt, root, state_bytes):
    """Phase 44(b): two supervised runs of the child (this script with a
    private argument) that crash once and resume — crash_at_step, and
    crash_mid_save a third of the way into the step-4 snapshot's staged
    payload (past its manifest, inside the shard container; that
    uncommitted snapshot must be skipped: the run resumes at step 2) —
    each Supervisor on its own thread, while this process runs the
    uninterrupted child. Each must finish with the uninterrupted
    child's state, bitwise."""
    import threading

    import torch
    runs = {"crash_at_step": "crash_at_step",
            "crash_mid_save": f"crash_mid_save:{state_bytes // 3}"}
    sups, results = {}, {}

    def supervise(label):
        t0 = time.perf_counter()
        results[label] = (sups[label].run(), time.perf_counter() - t0)

    threads = []
    for label, fault in runs.items():
        sups[label] = ptt.trainer.Supervisor(
            [sys.executable, os.path.abspath(__file__), "--phase44-child",
             os.path.join(root, label), os.path.join(root, f"{label}.pt"),
             fault], max_restarts=2, backoff_s=0.0, sleep_fn=lambda s: None)
        threads.append(threading.Thread(target=supervise, args=(label,)))
        threads[-1].start()
    t0 = time.perf_counter()
    ref_out = os.path.join(root, "ref.pt")
    phase44_child(os.path.join(root, "ref"), ref_out)
    ref = torch.load(ref_out)
    out, failed = {"uninterrupted_s": time.perf_counter() - t0,
                   "losses": ref["losses"]}, []
    for t in threads:
        t.join(900)
    for label in runs:
        sup = sups[label]
        rc, wall = results.get(label, (None, None))
        o = os.path.join(root, f"{label}.pt")
        got = torch.load(o) if rc == 0 else {"state": {}, "launches": [],
                                              "resumed_at": None}
        diff = _bitwise(got["state"], ref["state"])
        steps_run = len(got["launches"])
        out[label] = {"rc": rc, "restarts": sup.restarts,
                      "exit_codes": sup.exit_codes,
                      "resumed_at": got["resumed_at"],
                      "steps_after_resume": steps_run, "not_bitwise": diff,
                      "launches_per_step": got["launches"], "wall_s": wall}
        log(f"  (b) [{label}] Supervisor: exit codes {sup.exit_codes}, "
            f"{sup.restarts} restart(s); resumed at step "
            f"{got['resumed_at']}, ran {steps_run} step(s); state bitwise "
            f"the uninterrupted child's: {not diff} {diff[:4]}; K1-K3 a "
            f"step {got['launches'][:1]} (uninterrupted "
            f"{ref['launches'][:1]}); {wall or 0:.1f} s")
        failed += [f"{label}_{c}" for c, ok in (
            ("rc", rc == 0), ("restarts", sup.restarts == 1),
            ("killed", sup.exit_codes[:1] == [-9]),
            ("state", not diff),
            ("resumed_at", got["resumed_at"] == CHILD_INTERVAL),
            ("launches", got["launches"]
             == ref["launches"][CHILD_STEPS - steps_run:])) if not ok]
    log(f"  (b) the uninterrupted child in this process: "
        f"{out['uninterrupted_s']:.1f} s, beside the two supervised runs")
    return out, failed


def phase44_rank(rank, world, out_path):
    """One rank of phase 44(c)'s NCCL world of four cards: phase 7's LM
    in float32 through ParallelExecutor in Reduce (ZeRO-1) at dp 4, 4
    uninterrupted steps with a multi-writer snapshot after step 2 (each
    rank stages its blocks, the chief commits over the world's store);
    then restored as dp 2 x tp 2 (annotate_tp) and as dp 2 over ranks
    [0, 1]: steps 3-4's losses within 1e-5 relative of the dp 4 run's,
    each parameter block within Adam's move (2 lr a step), each rank
    reading exactly the bytes the reshard plan gives its blocks. Writes
    the rank's numbers to out_path.<rank>; any mismatch then raises."""
    import torch

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.parallel import (BuildStrategy, DeviceMesh,
                                           ParallelExecutor, ReduceStrategy,
                                           annotate_tp, elastic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ptt.flags.set_flag("use_bf16_matmul", False)
    kernels.build(["flash_attention"])
    place = ptt.CUDAPlace(torch.cuda.current_device())
    cfg, k = TRAIN, ELASTIC_SAVE_AT
    feeds = _lm_steps_feeds(cfg, ELASTIC_STEPS, SEED + 44)
    snap_root = os.path.join(os.path.dirname(out_path), "snapshots")
    # every rank builds every mesh, in one order (new_group is collective)
    meshes = {"dp4": DeviceMesh(axes={"dp": 4}),
              "dp2tp2": DeviceMesh(axes={"dp": 2, "tp": 2}),
              "dp2_ranks01": DeviceMesh(ranks=[0, 1], axes={"dp": 2})}
    _, start, _ = _train_program(ptt, cfg, mean_loss=True)
    sc0 = ptt.Scope()
    ptt.Executor(place).run(start, scope=sc0)
    init = {n: sc0.get(n).clone() for n in sc0.local_var_names()}
    del sc0

    def build(mesh, tp):
        m_, _, lo = _train_program(ptt, cfg, mean_loss=True)
        if tp:
            annotate_tp(m_)
        sc = ptt.Scope()
        for n, v in init.items():
            sc.set_var(n, v.clone())
        pe = ParallelExecutor(use_cuda=True, loss_name=lo.name,
                              main_program=m_, scope=sc, mesh=mesh,
                              build_strategy=BuildStrategy(
                                  reduce_strategy=ReduceStrategy.Reduce))
        return m_, lo, sc, pe

    def steps(pe, lo, fs):
        losses, launches = [], []
        for f in fs:
            kernels.reset_launch_counts()
            out = pe.run(fetch_list=[lo], feed=f, return_numpy=False)
            losses.append(float(out[0].reshape(-1)[0]))
            torch.cuda.synchronize()
            launches.append({kk: kernels.LAUNCHES[kk] for kk in FLASH})
        return losses, launches

    main, lo, sc, pe = build(meshes["dp4"], False)
    l1, n1 = steps(pe, lo, feeds[:k])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = elastic.save_train_state(snap_root, program=main, scope=sc,
                                    executor=pe, step=k)
    save_s = time.perf_counter() - t0
    l2, n2 = steps(pe, lo, feeds[k:])
    ref = {p.name: sc.get(p.name).clone() for p in main.all_parameters()}
    res = {"world": world, "rank": rank, "losses": l1 + l2,
           "launches_per_step": n1 + n2, "snapshot": os.path.basename(
               str(path)), "save_s": save_s}
    failed = [] if path is not None else ["dp4_snapshot"]
    del sc, pe
    for label, tp in (("dp2tp2", True), ("dp2_ranks01", False)):
        mesh = meshes[label]
        if not mesh.in_mesh:
            continue
        main, lo, sc, pe = build(mesh, tp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meta = elastic.restore_train_state(path, program=main, scope=sc,
                                           executor=pe)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        l3, n3 = steps(pe, lo, feeds[k:])
        prog = pe.prepare_program()
        worst = max(float((sc.get(n) - mesh.local_slice(
            w, pe.state_sharding(prog, n))).abs().max())
            for n, w in ref.items())
        rel = max(abs(a - b) / abs(b) for a, b in zip(l3, l2))
        rs = meta["reshard"]
        r = {"losses": l3, "max_loss_rel": rel, "param_worst": worst,
             "restore_s": restore_s, "launches_per_step": n3,
             "reshard": {x: rs[x] for x in ("old_world", "new_world",
                                            "n_vars", "n_moved",
                                            "wire_bytes", "read_bytes",
                                            "steps", "rank_read_bytes")},
             "read_bytes": meta["restore_read_bytes"]}
        res[label] = r
        failed += [f"{label}_{c}" for c, ok in (
            ("loss", rel <= 1e-5),
            ("params", worst <= 2 * cfg["lr"] * (ELASTIC_STEPS - k) + 1e-6),
            ("read_bytes", r["read_bytes"] == rs["rank_read_bytes"]),
            ("launches", n3 == n2)) if not ok]
        del sc, pe
    res["failed"] = failed
    with open(f"{out_path}.{rank}", "w") as f:
        json.dump(res, f)
    print(json.dumps(res), flush=True)
    assert not failed, f"phase 44(c) rank {rank}: {failed}"


def _mesh_change_four_cards(ptt, root):
    """Phase 44(c) on four cards: phase44_rank in a world of four on
    NCCL."""
    d = os.path.join(root, "world")
    os.makedirs(d)
    t0 = time.perf_counter()
    ptt.distributed.launch(f"{os.path.abspath(__file__)}:phase44_rank", 4,
                           args=[os.path.join(d, "rank")], place="cuda",
                           timeout_s=300, store_dir=d)
    ranks = []
    for r in range(4):
        with open(os.path.join(d, f"rank.{r}")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    log(f"  (c) four cards: dp 4 (ZeRO-1) {r0['losses']}, the multi-writer "
        f"snapshot {r0['snapshot']} in {r0['save_s']:.2f} s (rank 0); "
        f"K1-K3 a step {r0['launches_per_step'][0]}; "
        f"{time.perf_counter() - t0:.1f} s with the spawn")
    for label in ("dp2tp2", "dp2_ranks01"):
        for r in ranks:
            if label not in r:
                continue
            x = r[label]
            log(f"  (c) [{label}] rank {r['rank']}: losses {x['losses']} "
                f"(largest relative difference {x['max_loss_rel']:.2e}); "
                f"parameters within {x['param_worst']:.2e}; reshard "
                f"{x['reshard']}; read {x['read_bytes']} B (planned "
                f"{x['reshard']['rank_read_bytes']}); restore "
                f"{x['restore_s']:.2f} s")
    return {"ranks": ranks}, [f for r in ranks for f in r["failed"]]


def elastic_train(ptt, kernels):
    """Phase 44: (a) snapshot and resume on one card in a world of one
    rank on NCCL, both modes; (b) crash and resume under the Supervisor;
    (c) a snapshot into a changed world (one card: a plain Executor's
    into an auto-parallel ParallelExecutor, replan_on_restore). All
    snapshots go under a temporary directory, deleted at the end."""
    import torch
    from paddle_tpu_torch.distributed import (DistributedEnv,
                                              destroy_parallel_env,
                                              init_parallel_env)
    from paddle_tpu_torch.parallel import DeviceMesh, set_default_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    old = ptt.flags.get_flag("use_bf16_matmul")
    ptt.flags.set_flag("use_bf16_matmul", False)
    root = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    t0 = time.perf_counter()
    out, failed = {}, []
    try:
        _, start, _ = _train_program(ptt, TRAIN, mean_loss=True)
        sc = ptt.Scope()
        ptt.Executor(ptt.CUDAPlace(0)).run(start, scope=sc)
        init = {n: sc.get(n).clone() for n in sc.local_var_names()}
        del sc
        feeds = _lm_steps_feeds(TRAIN, ELASTIC_STEPS, SEED + 44)
        init_parallel_env(DistributedEnv(num_trainers=1), timeout_s=300,
                          place=ptt.CUDAPlace(0),
                          store_path=os.path.join(root, "store"))
        try:
            mesh = DeviceMesh(axes={"dp": 1})
            out["one_card"], f = _snapshot_resume_one_card(
                ptt, kernels, mesh, init, feeds, root)
            failed += f
            out["replan"], f = _replan_one_card(ptt, kernels, mesh, init,
                                                feeds, root)
            failed += f
        finally:
            set_default_mesh(None)
            destroy_parallel_env()
        torch.cuda.empty_cache()
        if torch.cuda.device_count() >= 4:
            out["mesh_change"], f = _mesh_change_four_cards(ptt, root)
            failed += f
        out["supervised"], f = _supervised_crashes(
            ptt, root, _state_bytes(_train_program(ptt, TRAIN)[0]))
        failed += f
    finally:
        shutil.rmtree(root, ignore_errors=True)
        ptt.flags.set_flag("use_bf16_matmul", old)
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 44 in {out['phase_s']:.1f} s")
    assert not failed, f"phase 44: {failed}"
    return out


# ---------------------------------------------------------------------------
# phase 45: ParallelExecutor's optimizer-state offload, its memory plan on
# the rewritten program and sequence parallelism, on phase 7's LM
# ---------------------------------------------------------------------------

#: the steps of each run of phase 45
P45_STEPS = 4


def _p45_free():
    """Drop a finished run's tensors before the next run's readings of
    memory_allocated (a program's objects may sit in reference cycles)."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _p45_opt_bytes(pe, scope):
    """The optimizer state's bytes on this rank, reckoned from the
    program as the executor rewrote it (declared shapes, ZeRO-1 rows cut
    over dp), and the names it holds."""
    import torch
    from paddle_tpu_torch.core.dtypes import convert_dtype
    from paddle_tpu_torch.framework import offload as ofl
    prog = pe.prepare_program()
    names = ofl.optimizer_state_names(prog, scope)
    total = 0
    for n in names:
        v = pe._find_var(prog, n)
        shape = list(v.shape)
        for d, s in enumerate(pe.state_sharding(prog, n)):
            for a in (s if isinstance(s, (tuple, list)) else (s,)) \
                    if s else ():
                shape[d] //= pe.mesh.axis_size(a)
        total += int(math.prod(shape)) * torch.empty(
            (), dtype=convert_dtype(v.dtype)).element_size()
    return names, total


class _P45Run:
    """Phase 7's LM at full width in float32 through ParallelExecutor,
    from phase 45's one init: each step timed, with the device memory
    allocated after it (synchronized) and its peak inside it, and K1-K3's
    launches counted from zero around it."""

    def __init__(self, ptt, kernels, init, mesh, **strategy):
        from paddle_tpu_torch.parallel import BuildStrategy, ParallelExecutor
        self.kernels = kernels
        self.main, _, self.loss = _train_program(ptt, TRAIN, mean_loss=True)
        self.scope = ptt.Scope()
        for n, v in init.items():
            self.scope.set_var(n, v.clone())
        self.pe = ParallelExecutor(use_cuda=True, loss_name=self.loss.name,
                                   main_program=self.main, scope=self.scope,
                                   mesh=mesh,
                                   build_strategy=BuildStrategy(**strategy))

    def steps(self, feeds, after=None):
        import torch
        out = {"losses": [], "secs": [], "allocated": [], "peak": [],
               "launches": []}
        for f in feeds:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.kernels.reset_launch_counts()
            t0 = time.perf_counter()
            r = self.pe.run(fetch_list=[self.loss], feed=f,
                            return_numpy=False)
            out["losses"].append(float(r[0].reshape(-1)[0]))
            torch.cuda.synchronize()
            out["secs"].append(time.perf_counter() - t0)
            out["launches"].append({k: self.kernels.LAUNCHES[k]
                                    for k in FLASH})
            out["peak"].append(torch.cuda.max_memory_allocated())
            # an allocation lets the caching allocator free the blocks
            # whose side-stream copies (record_stream) have completed
            torch.empty(1, device="cuda")
            out["allocated"].append(torch.cuda.memory_allocated())
            if after is not None:
                after(self)
        out["step_ms"] = float(sorted(out["secs"][1:])[
            len(out["secs"][1:]) // 2] * 1e3)
        return out


def _p45_offload(ptt, kernels, init, feeds, mesh):
    """Phase 45(a): Reduce (ZeRO-1) with offload_optimizer_state off and
    on: losses and the whole state bitwise, the offloaded bytes, device
    memory between and inside steps, the side stream's rates, the step
    times, restore waits and the cost model's offload section."""
    import torch
    from paddle_tpu_torch.framework import offload as ofl
    from paddle_tpu_torch.parallel import ReduceStrategy
    res, failed = {}, []
    states = {}
    for label, on in (("offload_off", False), ("offload_on", True)):
        # one run on the card at a time: memory_allocated is the process's
        run = _P45Run(ptt, kernels, init, mesh,
                      reduce_strategy=ReduceStrategy.Reduce,
                      offload_optimizer_state=on)
        res[label] = run.steps(feeds)
        if on:
            ho = run.pe._host_opt
            held = [n for n in ho.names if run.scope.has_var(n)]
            roundtrips = ho.roundtrips
            ofl.restore_offloaded(run.scope)
            names, reckoned = _p45_opt_bytes(run.pe, run.scope)
            rates = ofl.shared_stream(run.pe.place).rates()
            res[label].update(
                offloaded_bytes=ho.bytes_per_direction,
                reckoned_bytes=reckoned, n_vars=len(names),
                roundtrips=roundtrips,
                last_restore_wait_s=ho.last_restore_wait_s,
                slab_pinned=bool(ho._slab.pinned),
                host_optimizer_bytes=ofl.shared_host_pool().used_bytes(
                    "optimizer"),
                names_match=sorted(names) == sorted(ho.names),
                scope_holds=held,
                d2h_gbps=rates["d2h"]["gb_per_s"],
                h2d_gbps=rates["h2d"]["gb_per_s"],
                cost_offload=run.pe.cost_report(
                    nominal_batch=TRAIN["batch"])["offload"])
        states[label] = {n: t.cpu() for n, t in _state_of(run.scope).items()}
        del run
        _p45_free()
    off, on = res["offload_off"], res["offload_on"]
    bad = _bitwise(states["offload_off"], states["offload_on"])
    fell = off["allocated"][-1] - on["allocated"][-1]
    res["state_bitwise_mismatch"] = bad
    res["allocated_fell_bytes"] = fell
    checks = [("losses_bitwise", on["losses"] == off["losses"]),
              ("state_bitwise", not bad),
              ("bytes_reckoned", on["offloaded_bytes"]
               == on["reckoned_bytes"]),
              ("allocated_fell", fell >= 0.9 * on["offloaded_bytes"]),
              ("scope_empty_between_steps", not on["scope_holds"]),
              ("names", on["names_match"]),
              ("pinned", on["slab_pinned"]),
              ("roundtrips", on["roundtrips"] == P45_STEPS - 1)]
    checks += [(f"launches {label} {k}", all(
        s[k] == TRAIN["num_layers"] for s in res[label]["launches"]))
        for label in states for k in FLASH]
    failed += [("offload", c) for c, ok in checks if not ok]
    return res, failed


def _p45_plan(ptt, kernels, init, feeds, mesh, base_losses):
    """Phase 45(b): Reduce with memory_plan=True, losses within 1e-5 of
    the unplanned run's, the plan's record; then one prepare with
    auto_parallel=True and its chosen point."""
    import torch
    from paddle_tpu_torch.framework import memory_plan as tmp
    from paddle_tpu_torch.parallel import ReduceStrategy
    run = _P45Run(ptt, kernels, init, mesh,
                  reduce_strategy=ReduceStrategy.Reduce, memory_plan=True)
    res = run.steps(feeds)
    prog = run.pe.prepare_program()
    rep = tmp.plan_report(prog)
    remat = rep.get("remat") or {}
    res["plan"] = {
        "applied": bool(getattr(prog, "_memory_plan_applied", False)),
        "predicted_peak_before": rep.get("predicted_peak_before"),
        "predicted_peak_after": rep.get("predicted_peak_after"),
        "schedule": rep.get("schedule"),
        "remat_chosen": remat.get("chosen"),
        "remat_segments": remat.get("segments") or remat.get("n_segments"),
        "time_budget_s": remat.get("time_budget_s")}
    rel = max(abs(a - b) / abs(b) for a, b in zip(res["losses"],
                                                   base_losses))
    res["max_loss_rel"] = rel
    del run
    _p45_free()
    auto = _P45Run(ptt, kernels, init, mesh, auto_parallel=True)
    auto.pe._feed_shapes = {n: tuple(v.shape) for n, v in feeds[0].items()}
    auto.pe.prepare_program()
    plan = auto.pe.auto_plan_report()
    res["auto"] = {"point": plan.point.describe(),
                   "mesh_axes": dict(plan.mesh_axes),
                   "memory_plan": bool(plan.point.memory_plan),
                   "predicted_step_s": plan.predicted_step_s,
                   "n_feasible": plan.n_feasible}
    del auto
    _p45_free()
    failed = [("plan", c) for c, ok in (
        ("applied", res["plan"]["applied"]), ("losses", rel <= 1e-5))
        if not ok]
    return res, failed


def _p45_sequence(ptt, kernels, init, feeds, mesh, plain):
    """Phase 45(c): AllReduce with enable_sequence_parallel on `mesh`:
    the losses within 1e-5 of the plain Executor's, the gradients by the
    per-step norm ratio `_adam_parity` reads through Adam's first moments,
    the parameters after the steps, and K1-K3's launches per step on this
    rank (a causal ring over sp launches K1 once per live block)."""
    import torch
    from paddle_tpu_torch.parallel import ReduceStrategy
    run = _P45Run(ptt, kernels, init, mesh,
                  reduce_strategy=ReduceStrategy.AllReduce,
                  enable_sequence_parallel=True)
    m1, p1 = _Snapshots(len(feeds)), _Snapshots(1)
    res = run.steps(feeds, after=lambda r: plain._after(r.scope, m1, p1))
    par, checks = plain.parity(run.scope, m1, p1)
    rel = max(abs(a - b) / abs(b) for a, b in zip(res["losses"],
                                                   plain.losses))
    sp = mesh.axis_size("sp")
    idx = mesh.axis_index("sp")
    # the causal ring: this rank's query block meets idx + 1 key blocks
    want = TRAIN["num_layers"] * (idx + 1)
    checks = [("losses", rel <= 1e-5)] + checks + [
        (f"launches {k}", all(s[k] == want for s in res["launches"]))
        for k in FLASH]
    res.update(max_loss_rel=rel, parity={
        k: par[k] for k in ("g_norm_rel", "g_rel", "worst", "beyond",
                            "beyond_settled", "p1_beyond", "n")},
        sp=sp, sp_index=idx, mesh=dict(mesh.axes),
        k1_per_step_expected=want,
        failed=[c for c, ok in checks if not ok])
    del run
    _p45_free()
    return res, [(f"sp {dict(mesh.axes)}", c) for c in res["failed"]]


def phase45_rank(rank, world, out_path, parts="abc"):
    """One rank of phase 45's NCCL world over every visible card (one
    rank on a one-card machine): phase 7's LM at full width in float32
    (TF32 and use_bf16_matmul off) with Adam from one init. (a) Reduce
    mode with the optimizer state offloaded and not; (b) Reduce with the
    memory plan on the rewritten program, and one auto-parallel prepare;
    (c) sequence parallelism on {"sp": world} (sp 1 on one card: the
    split, the override and a one-block ring), and on four cards
    dp 2 x sp 2 too, each against the plain Executor on this card.
    `parts` names the parts to run. Writes the rank's numbers to
    out_path.<rank> as JSON."""
    import torch

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.parallel import DeviceMesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ptt.flags.set_flag("use_bf16_matmul", False)
    kernels.build(["flash_attention"])     # built by phase 2: loads
    place = ptt.CUDAPlace(torch.cuda.current_device())
    t0 = time.perf_counter()
    feeds = _lm_steps_feeds(TRAIN, P45_STEPS, SEED + 45)
    plain = _PlainAdam(ptt, place, TRAIN, feeds)
    res = {"world": world, "rank": rank,
           "plain": {"losses": plain.losses, "step_ms": float(sorted(
               plain.secs[1:])[len(plain.secs[1:]) // 2] * 1e3)}}
    failed = []
    dp_mesh = DeviceMesh(axes={"dp": world})
    if "a" in parts:
        res["offload"], f = _p45_offload(ptt, kernels, plain.init, feeds,
                                         dp_mesh)
        failed += f
    if "b" in parts:
        res["plan"], f = _p45_plan(
            ptt, kernels, plain.init, feeds, dp_mesh,
            res["offload"]["offload_off"]["losses"] if "a" in parts
            else plain.losses)
        failed += f
    meshes = [{"sp": world}] + ([{"dp": 2, "sp": world // 2}]
                                if world >= 4 else [])
    res["sp"] = {}
    for axes in meshes if "c" in parts else ():
        label = "x".join(f"{a}{n}" for a, n in axes.items())
        res["sp"][label], f = _p45_sequence(
            ptt, kernels, plain.init, feeds, DeviceMesh(axes=axes), plain)
        failed += f
    res["phase_s"] = time.perf_counter() - t0
    res["failed"] = failed
    print(f"phase45 rank {rank}: {res['phase_s']:.1f} s, failed {failed}",
          flush=True)
    with open(f"{out_path}.{rank}", "w") as f:
        json.dump(res, f)
    assert not failed, failed


def _p45_log_ab(r0):
    """Phase 45(a) and (b)'s log lines (rank 0's numbers)."""
    gb = 1e9
    off, on = r0["offload"]["offload_off"], r0["offload"]["offload_on"]
    log(f"  (a) offload, Reduce: losses {on['losses']} bitwise "
        f"{on['losses'] == off['losses']}, state mismatches "
        f"{r0['offload']['state_bitwise_mismatch']}; offloaded "
        f"{on['offloaded_bytes'] / gb:.4f} GB ({on['n_vars']} vars, "
        f"reckoned from the program {on['reckoned_bytes'] / gb:.4f} GB); "
        f"allocated between steps {off['allocated'][-1] / gb:.4f} -> "
        f"{on['allocated'][-1] / gb:.4f} GB (fell "
        f"{r0['offload']['allocated_fell_bytes'] / gb:.4f}); peak in a step "
        f"{max(off['peak']) / gb:.4f} -> {max(on['peak']) / gb:.4f} GB; "
        f"d2h {on['d2h_gbps']:.2f} GB/s, h2d {on['h2d_gbps']:.2f} GB/s on "
        f"the side stream; step {off['step_ms']:.1f} -> "
        f"{on['step_ms']:.1f} ms; last_restore_wait_s "
        f"{on['last_restore_wait_s']:.6f}; costs.predict offload "
        f"{on['cost_offload']}")
    pl = r0["plan"]
    log(f"  (b) memory plan, Reduce: losses {pl['losses']} (largest "
        f"relative difference {pl['max_loss_rel']:.2e}); peak "
        f"{max(off['peak']) / gb:.4f} -> {max(pl['peak']) / gb:.4f} GB; "
        f"step {off['step_ms']:.1f} -> {pl['step_ms']:.1f} ms; K1-K3 a step "
        f"{pl['launches'][-1]}; plan {pl['plan']}; auto_parallel chose "
        f"{pl['auto']}")


def offload_plan_sequence(ptt, kernels, world=None, parts="abc"):
    """Phase 45: phase45_rank in a world over every visible card on NCCL
    (or `world` of them), its `parts`. Returns the ranks' numbers for
    `paths`."""
    import torch
    world = world or torch.cuda.device_count()
    root = tempfile.mkdtemp(prefix="chip_smoke_p45_")
    try:
        t0 = time.perf_counter()
        ptt.distributed.launch(
            f"{os.path.abspath(__file__)}:phase45_rank", world,
            args=[os.path.join(root, "rank"), parts], place="cuda",
            timeout_s=600, store_dir=root)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            with open(os.path.join(root, f"rank.{r}")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    r0 = ranks[0]
    log(f"  a world of {world} rank(s) on NCCL in {spawn_s:.1f} s; plain "
        f"Executor losses {r0['plain']['losses']}, step "
        f"{r0['plain']['step_ms']:.1f} ms")
    if "a" in parts and "b" in parts:
        _p45_log_ab(r0)
    for r in ranks:
        for label, s in r["sp"].items():
            log(f"  (c) sp {label} rank {r['rank']}: losses {s['losses']} "
                f"(largest relative difference {s['max_loss_rel']:.2e}); "
                f"gradients ||Δg|| / ||g|| by step "
                f"{_fmt(s['parity']['g_norm_rel'])}; parameters beyond "
                f"{s['parity']['beyond']} (not settled "
                f"{s['parity']['beyond_settled']}); step {s['step_ms']:.1f} "
                f"ms; K1-K3 a step {s['launches'][-1]}")
    log(f"  phase 45 in {r0['phase_s']:.1f} s on rank 0")
    return {"spawn_s": spawn_s, "ranks": ranks}


# phase 46: export and the native programs (ptpu_predict / ptpu_train).
# The generators keep phase 38's (batch 16, beam 4) and phase 39's (batch
# 16, beam 4) shapes with max_gen cut to EXPORT["max_gen"]: the exported
# graph unrolls every step of every layer, ~1,500 nodes a step of the LM
# and ~2,000 of the encoder-decoder, and torch 2.11 on the card's host
# exports ~11-35 ms a node (12,011 nodes took 266 s at max_gen 8).
# Phase 32's beam translation is cut the same way (max_len); the stacked
# LSTM is phase 11's model at its batch; the train step is phase 7's LM
# in float32.
EXPORT = dict(max_gen=2, beam_max_len=4, serve_batch=3, serve_clients=4,
              pipelined=8, train_steps=5, reps=3)
NATIVE_DEVICE = "cuda"     # the native programs' --device


def _native_run(exe_path, args, timeout=600):
    """Run a native program; returns (stdout, its `launches` line as a
    dict, its `run_ms` / `step_ms` list, its graph's node count). Raises
    with its stderr when it fails."""
    r = subprocess.run([exe_path, *args], capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"{os.path.basename(exe_path)} {args[:2]} exit "
                           f"{r.returncode}: {r.stderr[-3000:]}")
    fields = {}
    for ln in r.stdout.splitlines():
        key, _, rest = ln.partition(" ")
        if key in ("launches", "run_ms", "step_ms", "nodes"):
            fields[key] = json.loads(rest)
    return (r.stdout, fields["launches"],
            fields.get("run_ms", fields.get("step_ms")), fields["nodes"])


def _save_feeds(d, feed, names):
    import numpy as np
    paths = []
    for i, n in enumerate(names):
        paths.append(os.path.join(d, f"in{i}.npy"))
        np.save(paths[-1], np.asarray(feed[n]))
    return paths


def _export_program(ptt, label):
    """Phase 46's program `label` as a user builds it: (program, startup,
    fetch vars, feed names). "train" is phase 7's LM step (Adam)."""
    gen = EXPORT["max_gen"]
    if label == "lm_generate":
        return (*_lm_generate_program(ptt, TRAIN, gen, GENERATE["runs"][2][1]),
                ["prompt"])
    if label == "nmt_generate":
        return (*_nmt_generate_program(ptt, TRANSFORMER, gen,
                                       GENERATE_NMT["beams"][0]),
                ["src", "src@SEQLEN"])
    if label == "nmt_beam_translate":
        return (*_nmt_infer_program(ptt, NMT, dict(
            BEAM, max_len=EXPORT["beam_max_len"])), ["src", "src_lens"])
    if label == "train":
        main, start, loss = _train_program(ptt, TRAIN)
        return main, start, [loss], ["tokens", "tokens@SEQLEN", "targets"]
    from paddle_tpu_torch.models import stacked_lstm
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        _, _, logits = stacked_lstm.stacked_lstm_net(
            dict_dim=LSTM["dict_dim"], emb_dim=LSTM["emb_dim"],
            hid_dim=LSTM["hid_dim"], stacked_num=LSTM["stacked_num"],
            max_len=LSTM["max_len"])
    return main, start, [logits], ["words", "words@SEQLEN"]


def _export_scope(ptt, label, params_dir):
    """(executor, program, scope, fetch vars, feed names) of `label` on
    the card with `params_dir`'s weights; the train step in float32."""
    if label == "train":
        ptt.flags.set_flag("use_bf16_matmul", False)
    main, start, fetch, feeds = _export_program(ptt, label)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CUDAPlace(0))
    exe.run(start, scope=scope)
    ptt.io.load_params(exe, params_dir, main_program=main, scope=scope)
    if label != "train":
        main = main.clone(for_test=True).prune([f.name for f in fetch])
    return exe, main, scope, fetch, feeds


def export_child(label, params_dir, out_dir):
    """Phase 46's exporter (`chip_smoke.py --export-child label params
    out`): `label`'s program with `params_dir`'s weights exported on the
    card into `out_dir` by io.export_inference_model (native meta
    included) or, for "train", io.export_train_program; the export's
    seconds and nodes to `out_dir`/export.json. Phase 46 runs one a
    program, all at once: an export is host-bound Python (torch's
    symbolic shapes), ~10-30 ms a node on the card's host."""
    import torch

    import paddle_tpu_torch as ptt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exe, main, scope, fetch, feeds = _export_scope(ptt, label, params_dir)
    t0 = time.perf_counter()
    if label == "train":
        ptt.io.export_train_program(out_dir, feeds, fetch,
                                    main_program=main, scope=scope)
        meta = open(os.path.join(out_dir, "__exported_train__.meta")).read()
        info = {"seconds": time.perf_counter() - t0}
    else:
        info = ptt.io.export_inference_model(out_dir, feeds,
                                             [f.name for f in fetch], main,
                                             scope=scope, native=True)
        meta = open(os.path.join(out_dir, "__exported_native__.meta")).read()
    info["export_write_s"] = time.perf_counter() - t0
    assert f"archive {NATIVE_DEVICE} " in meta, meta
    with open(os.path.join(out_dir, "export.json"), "w") as f:
        json.dump(info, f)


def start_exports(ptt, lm_params, tr_params, nmt_params,
                  nice=BACKGROUND_NICE):
    """Phase 46's five exports, each in a child process (`export_child`),
    all started now: main() starts them after phase 20 (phase 18 saved
    the last weights they need), so they run beside phases 21-45 (an
    export is host-bound Python on its own core). The stacked LSTM's
    weights are its startup weights (phase 11's trained ones are gone
    with phase 14). Returns what export_native collects."""
    root = tempfile.mkdtemp(prefix="chip_smoke_export_")
    lstm_params = os.path.join(root, "lstm_params")
    main, start, _, _ = _export_program(ptt, "stacked_lstm")
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CUDAPlace(0))
    exe.run(start, scope=scope)
    ptt.io.save_params(exe, lstm_params, main_program=main, scope=scope)
    params = {"lm_generate": lm_params, "nmt_generate": tr_params,
              "stacked_lstm": lstm_params,
              "nmt_beam_translate": nmt_params, "train": lm_params}
    procs = {}
    t0 = time.perf_counter()
    for label, params_dir in params.items():
        d = os.path.join(root, label)
        os.makedirs(d)
        procs[label] = _track(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--export-child",
             label, params_dir, d], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True))
        if nice:
            _lower_priority(procs[label].pid, nice)
    return {"root": root, "params": params, "procs": procs, "t0": t0}


def _collect_exports(started):
    """Wait for start_exports' children. Returns ({label: its
    export.json}, seconds from their start to the last one's end)."""
    root, procs = started["root"], started["procs"]
    failed, infos = [], {}
    for label, proc in procs.items():
        try:
            out, _ = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{label} (exit {proc.returncode}): {out[-3000:]}")
            continue
        with open(os.path.join(root, label, "export.json")) as f:
            infos[label] = json.load(f)
    wall = time.perf_counter() - started["t0"]
    assert not failed, "export failed: " + "\n".join(failed)
    return infos, wall


def _export_case(ptt, kernels, progs, d, label, params_dir, feed, expect,
                 tol, reps, info):
    """One exported program through the three runners: Executor.run (of
    the program `label` with `params_dir`'s weights), the archive in `d`
    through ExportedPredictor, and `ptpu_predict --device cuda`. The
    first output (the tokens of a generator) must be equal to
    Executor.run's where `tol` is None, and every other output within
    `tol` (1e-5 for beam scores) or, where `tol` is a number, every output
    within it; each kernel of `expect` launched once or more a call on
    every runner, the same count on each. Times each runner `reps` calls
    a turn, two turns in turns (Executor.run, ExportedPredictor, the C++
    process's own timer around the run and the outputs' copy to the
    host)."""
    import numpy as np
    import torch
    exe, prog, scope, fetch, names = _export_scope(ptt, label, params_dir)
    fetch_names = [f.name for f in fetch]

    def py_call():
        return exe.run(prog, feed=feed, fetch_list=fetch_names, scope=scope)

    ref = py_call()                         # plans
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    ref = py_call()
    py_launches = {k: kernels.LAUNCHES[k] for k in expect}
    t0 = time.perf_counter()
    pred = ptt.Predictor.from_exported(d, place=ptt.CUDAPlace(0))
    load_s = time.perf_counter() - t0
    pred.run(feed)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got_ep = pred.run(feed)
    ep_launches = {k: kernels.LAUNCHES[k] for k in expect}
    ins = _save_feeds(d, feed, names)
    cpp_args = [d, *ins, "--device", NATIVE_DEVICE, "--out", d, "--repeat",
                str(reps)]
    _, cpp_launches, cpp_ms, nodes = _native_run(progs["ptpu_predict"],
                                                 cpp_args)
    got_cpp = [np.load(os.path.join(d, f"out{i}.npy"))
               for i in range(len(fetch_names))]
    worst = 0.0
    for i, (name, r, e, c) in enumerate(zip(fetch_names, ref, got_ep,
                                            got_cpp)):
        assert r.shape == e.shape == c.shape, (label, name, r.shape,
                                               e.shape, c.shape)
        if tol is None and i == 0:
            assert np.array_equal(r, e) and np.array_equal(r, c), (
                f"{label}: {name} differs across Executor.run, "
                f"ExportedPredictor and ptpu_predict")
        else:
            err = max(float(np.abs(r - e).max()), float(np.abs(r - c).max()))
            assert err <= (tol or 1e-5), f"{label}: {name} differs by {err}"
            worst = max(worst, err)
    for k in expect:
        assert py_launches[k] > 0, f"{label}: {k} never launched"
        assert ep_launches[k] == py_launches[k], (
            f"{label}: ExportedPredictor launched {k} {ep_launches[k]} "
            f"times a call, Executor.run {py_launches[k]}")
        assert cpp_launches[k] == reps * py_launches[k], (
            f"{label}: ptpu_predict launched {k} {cpp_launches[k]} times "
            f"in {reps} runs, Executor.run {py_launches[k]} a call")
    # the checked native run is the first turn's C++ times
    times = {"executor_ms": [], "exported_ms": [], "native_ms": cpp_ms}
    for turn in range(2):
        for key, fn in (("executor_ms", py_call),
                        ("exported_ms", lambda: pred.run(feed))):
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                times[key].append((time.perf_counter() - t0) * 1e3)
        if turn:
            times["native_ms"] += _native_run(progs["ptpu_predict"],
                                              cpp_args)[2]
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"  [{label}] export {info['seconds']:.1f} s ({info['nodes']} "
        f"nodes; {info['export_write_s']:.1f} s with the write), "
        f"ExportedPredictor cold load {load_s:.1f} s; "
        f"{'tokens identical, ' if tol is None else ''}"
        f"outputs within {worst:.2e} across Executor.run, ExportedPredictor "
        f"and ptpu_predict; launches a call {py_launches} on each; median "
        f"ms a call: Executor.run {med['executor_ms']:.2f}, "
        f"ExportedPredictor {med['exported_ms']:.2f}, ptpu_predict "
        f"{med['native_ms']:.2f}")
    del pred
    torch.cuda.empty_cache()
    return {**info, "native_nodes": nodes, "load_s": load_s,
            "launches_per_call": py_launches, "max_abs_err": worst,
            "launches_native": {k: cpp_launches[k] for k in expect},
            **times, **{k.replace("_ms", "_ms_median"): v
                        for k, v in med.items()}}


def _native_serve(progs, d, feed, names):
    """`ptpu_predict --serve` on `d`'s archive: EXPORT["serve_clients"]
    PredictorClient threads, the first pipelining EXPORT["pipelined"]
    requests before it reads, the others two blocking calls each, at a
    batch the export never traced; every answer equal to the one-shot
    run's on the same feed. Then a float64 feed and a wrong feed name are
    answered with errors on one connection, which serves again."""
    import threading
    import numpy as np
    from paddle_tpu_torch.serving import PredictorClient
    ins = _save_feeds(d, feed, names)
    _native_run(progs["ptpu_predict"], [d, *ins, "--device", NATIVE_DEVICE,
                                        "--out", d])
    want = np.load(os.path.join(d, "out0.npy"))
    proc = subprocess.Popen([progs["ptpu_predict"], d, "--serve", "0",
                             "--device", NATIVE_DEVICE],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("LISTENING "), line
        port = int(line.split()[1])
        got, errors = [], []

        def client(i):
            try:
                with PredictorClient("127.0.0.1", port) as c:
                    if i == 0:
                        for _ in range(EXPORT["pipelined"]):
                            c.send(feed)
                        got.extend(c.recv()[0]
                                   for _ in range(EXPORT["pipelined"]))
                    else:
                        got.extend(c.infer(feed)[0] for _ in range(2))
            except Exception as e:     # reported below, after the join
                errors.append(repr(e))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(EXPORT["serve_clients"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        assert not errors, errors
        n = EXPORT["pipelined"] + 2 * (EXPORT["serve_clients"] - 1)
        assert len(got) == n and all(np.array_equal(g, want) for g in got), \
            "served outputs differ from the one-shot run's"
        refused = []
        with PredictorClient("127.0.0.1", port) as c:
            bad = dict(feed)
            bad[names[0]] = np.asarray(feed[names[0]], "float64")
            for label, f, word in (("float64", bad, "dtype"),
                                   ("wrong name", {"nope": feed[names[0]]},
                                    "missing feed")):
                try:
                    c.infer(f)
                except RuntimeError as e:
                    assert word in str(e), str(e)
                    refused.append(label)
            assert np.array_equal(c.infer(feed)[0], want)
        assert refused == ["float64", "wrong name"], refused
    finally:
        proc.kill()
        proc.wait(timeout=60)
    log(f"  [serve] {n} requests over {EXPORT['serve_clients']} "
        f"connections (one pipelining {EXPORT['pipelined']}) at batch "
        f"{len(want)}: every answer equal to the one-shot run's, "
        f"{wall:.2f} s; a float64 feed and a wrong feed name answered with "
        f"errors, the connection served again")
    return {"requests": n, "wall_s": wall, "refused": refused}


def _native_train(ptt, kernels, progs, d, params_dir, info):
    """Phase 7's LM train step (Adam) in float32 (use_bf16_matmul off, TF32
    off, as phase 9 runs it) from `params_dir`'s weights, exported into
    `d` by export_child: EXPORT["train_steps"] steps by `ptpu_train
    --device cuda` and by Executor.run from the same state on the same
    batch: losses within 1e-5 relative, every parameter within 1e-5 of
    its magnitude (at least 1), K1-K3 6 launches a step each in the C++
    process; each one's step times."""
    import numpy as np
    import torch
    from paddle_tpu_torch.framework.executor import as_numpy
    cfg, steps = TRAIN, EXPORT["train_steps"]
    prev = ptt.flags.get_flag("use_bf16_matmul")
    try:
        exe, main, scope, (loss,), names = _export_scope(ptt, "train",
                                                         params_dir)
        rng = np.random.RandomState(SEED + 46)
        toks = _markov_tokens(rng, cfg["batch"], cfg["max_len"] + 1,
                              cfg["vocab"])
        feed = {"tokens": toks[:, :-1].copy(),
                "tokens@SEQLEN": np.full((cfg["batch"],), cfg["max_len"],
                                         "int32"),
                "targets": toks[:, 1:].copy()}
        ins = _save_feeds(d, feed, names)
        stdout, launches, step_ms, nodes = _native_run(
            progs["ptpu_train"], [d, *ins, "--steps", str(steps), "--device",
                                  NATIVE_DEVICE, "--out", d])
        cpp = [float(ln.split()[3]) for ln in stdout.splitlines()
               if ln.startswith("step ")]
        py, py_ms = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            py.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0]))
            py_ms.append((time.perf_counter() - t0) * 1e3)
        np.testing.assert_allclose(cpp, py, rtol=1e-5,
                                   err_msg="ptpu_train losses")
        meta = open(os.path.join(d, "__exported_train__.meta")).read()
        in_names = [ln.split()[1] for ln in meta.splitlines()
                    if ln.startswith("in ")]
        worst = 0.0
        for p in main.all_parameters():
            want = as_numpy(scope.get(p.name))
            got = np.load(os.path.join(d, f"state{in_names.index(p.name)}"
                                          f".npy"))
            err = float(np.abs(got - want).max())
            assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), \
                (p.name, err)
            worst = max(worst, err)
        for k in FLASH:
            assert launches[k] == cfg["num_layers"] * steps, (
                f"ptpu_train launched {k} {launches[k]} times in {steps} "
                f"steps; the step launches it {cfg['num_layers']} times")
    finally:
        ptt.flags.set_flag("use_bf16_matmul", prev)
    log(f"  [train] export {info['seconds']:.1f} s ({nodes} nodes); {steps} "
        f"steps: losses {[round(x, 6) for x in cpp]} within 1e-5 of "
        f"Executor.run's, parameters within {worst:.2e}; C++ launches "
        f"{launches}; median ms a step: Executor.run "
        f"{np.median(py_ms[1:]):.1f}, ptpu_train {np.median(step_ms[1:]):.1f}"
        f" (first steps {py_ms[0]:.1f} / {step_ms[0]:.1f})")
    return {**info, "nodes": nodes, "losses": cpp, "executor_losses": py,
            "max_param_err": worst, "launches_native": launches,
            "executor_step_ms": py_ms, "native_step_ms": step_ms}


def export_native(ptt, kernels, lm_params, tr_params, nmt_params,
                  started=None):
    """Phase 46: export and native runs (module docstring). The exports
    run in child processes, all at once (`started`: start_exports'
    children, started earlier, else started now); the checks and times
    here."""
    import numpy as np
    from paddle_tpu_torch import native
    progs = native.build()     # built in phase 2, beside the kernels
    out = {"build": dict(native.BUILD_SECONDS)}
    rng = np.random.RandomState(SEED + 46)
    b = GENERATE["runs"][2][0]
    prompt = rng.randint(0, TRAIN["vocab"], (b, 1)).astype("int64")
    nmt_feed, _, _ = _nmt_generate_feed(TRANSFORMER, GENERATE_NMT["batch"],
                                        SEED + 17)
    lstm_feed = _lstm_feeds(rng, LSTM, 1)[0]
    del lstm_feed["label"]
    src = _nmt_feeds(rng, NMT, 1)[0]
    started = started or start_exports(ptt, lm_params, tr_params,
                                       nmt_params, nice=0)
    root, params = started["root"], started["params"]
    try:
        t0 = time.perf_counter()
        infos, out["export_wall_s"] = _collect_exports(started)
        out["export_wait_s"] = time.perf_counter() - t0
        log(f"  five exports in parallel child processes: "
            f"{out['export_wall_s']:.1f} s from their start, "
            f"{out['export_wait_s']:.1f} s of it waited for here")
        cases = [("lm_generate", {"prompt": prompt}, ("decode_attention",),
                  None),
                 ("nmt_generate", nmt_feed, ("flash_fwd",
                                             "decode_attention"), None),
                 ("stacked_lstm", lstm_feed, ("lstm_seq",), 1e-6),
                 ("nmt_beam_translate",
                  {"src": src["src"], "src_lens": src["src_lens"]},
                  ("gru_seq", "decode_attention"), None)]
        for label, feed, expect, tol in cases:
            out[label] = _export_case(
                ptt, kernels, progs, os.path.join(root, label), label,
                params[label], feed, expect, tol, EXPORT["reps"],
                infos[label])
        out["serve"] = _native_serve(
            progs, os.path.join(root, "lm_generate"),
            {"prompt": prompt[:EXPORT["serve_batch"]]}, ["prompt"])
        out["train"] = _native_train(ptt, kernels, progs,
                                     os.path.join(root, "train"), lm_params,
                                     infos["train"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 47: the transpilers, RecordIO and the concurrency utilities
# ---------------------------------------------------------------------------

#: phase 47(a): the bound on the bfloat16 build's folded logits, relative
#: L2 against the unfolded ones. Each of ResNet-50's 53 convs rounds three
#: operands to bfloat16 (filter, input, output; unit roundoff u = 2^-8).
#: The folded path rounds the scaled filter where the unfolded path rounds
#: the unscaled one, and once the values differ the two paths' roundings of
#: the activations are independent too: each rounding's difference has
#: variance 2u²/3, a conv's 2u², n convs' 2nu² (added in quadrature down
#: the net). Three of that deviation: 3·sqrt(2·53)·2^-8 = 0.1207
BN_FOLD_BF16_BOUND = 3 * math.sqrt(2 * 53) * 2.0 ** -8
#: phase 47(b) and (d): QAT steps, RecordIO-fed steps
QAT_STEPS, RECORDIO_STEPS = 10, 8
#: phase 47(d): the loader's files hold phase 7's batches this many times
#: over (a rate over ~34 MB, not over four records)
RECORDIO_REPS = 64
PHASE47_BUDGET_S = 120.0


def _scope_copy(ptt, scope):
    """A new scope holding clones of `scope`'s values."""
    copy = ptt.Scope()
    for n in scope.local_var_names():
        v = scope.get(n)
        copy.set_var(n, v.clone() if hasattr(v, "clone") else v)
    return copy


def _p47_bn_fold(ptt, resnet_params):
    """Phase 47(a): ResNet-50's is_test program with phase 19's weights,
    folded by Analyzer() on a clone with a copy of the scope, in the
    bfloat16 build phase 20 serves and in a float32 build."""
    import numpy as np
    import torch
    cfg = RESNET
    img = _staged_batches(cfg["infer_batch"], 1, SEED + 47,
                          cfg["image"])[0]["img"]
    out = {}
    for label, bf16 in (("float32", False), ("bf16", True)):
        imain, _, _, logits = _resnet_program(ptt, cfg, is_test=True,
                                              use_bf16=bf16)
        prog = imain.prune([logits])
        exe = ptt.Executor(ptt.CUDAPlace(0))
        scope = ptt.Scope()
        ptt.io.load_params(exe, resnet_params, main_program=prog,
                           scope=scope)
        folded = _scope_copy(ptt, scope)
        kinds = {n: (folded.get(n).device, folded.get(n).dtype)
                 for n in folded.local_var_names()}
        fprog = ptt.Analyzer().run(prog.clone(), folded)
        n_bn = [sum(op.type == "batch_norm" for op in p.global_block().ops)
                for p in (prog, fprog)]
        assert n_bn == [53, 0], f"47(a) {label}: batch_norms {n_bn}"
        for n in folded.local_var_names():
            t = folded.get(n)
            assert t.device == exe.device, f"47(a): {n} on {t.device}"
            if n in kinds:
                assert (t.device, t.dtype) == kinds[n], (n, t.dtype)
        feed = {"img": img}

        def run(p, sc):
            return exe.run(p, feed=feed, fetch_list=[logits], scope=sc,
                           return_numpy=False)[0].float()

        u, f = run(prog, scope), run(fprog, folded)
        assert bool(torch.isfinite(f).all()), f"47(a) {label}: non-finite"
        rel_l2 = float((f - u).norm() / u.norm())
        rel_max = float((f - u).abs().max() / u.abs().max())
        top1 = float((f.argmax(-1) == u.argmax(-1)).float().mean())
        ms_u = _cuda_ms(lambda: run(prog, scope), reps=10)
        ms_f = _cuda_ms(lambda: run(fprog, folded), reps=10)
        log(f"  [{label}] 53 batch_norms folded away by Analyzer(): "
            f"folded logits against unfolded rel L2 {rel_l2:.3e}, max "
            f"|diff| / max |logit| {rel_max:.3e}, top-1 agreement "
            f"{top1:.3f}; {ms_u:.2f} ms a batch of {cfg['infer_batch']} "
            f"unfolded, {ms_f:.2f} folded (median of 10)")
        if bf16:
            assert rel_l2 <= BN_FOLD_BF16_BOUND, \
                f"47(a) bf16: rel L2 {rel_l2} > {BN_FOLD_BF16_BOUND}"
        else:
            assert rel_max <= 1e-4, f"47(a) float32: {rel_max} > 1e-4"
        out[label] = {"rel_l2": rel_l2, "rel_max": rel_max, "top1": top1,
                      "unfolded_ms": ms_u, "folded_ms": ms_f}
        del scope, folded
        torch.cuda.empty_cache()
    out["bf16_bound"] = BN_FOLD_BF16_BOUND
    return out


def _qat_program(ptt, cfg):
    """Phase 7's LM with QuantizeTranspiler's fake-quant ops inserted
    before Adam.minimize, as a user builds it."""
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.transpiler import QuantizeTranspiler
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        loss, _ = transformer.transformer_lm(
            vocab=cfg["vocab"], max_len=cfg["max_len"],
            d_model=cfg["d_model"], d_inner=cfg["d_inner"],
            num_heads=cfg["num_heads"], num_layers=cfg["num_layers"])
        QuantizeTranspiler().training_transpile(main, start)
        ptt.optimizer.Adam(learning_rate=cfg["lr"]).minimize(loss)
    return main, start, loss


def _p47_qat(ptt, kernels, feeds):
    """Phase 47(b): QAT of phase 7's LM for QAT_STEPS steps, then the
    weight freeze on its is_test program."""
    import numpy as np
    import torch
    cfg = TRAIN
    main, start, loss = _qat_program(ptt, cfg)
    ops = [op.type for op in main.global_block().ops]
    n_fq = ops.count("fake_quantize_abs_max")
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CUDAPlace(0))
    exe.run(start, scope=scope)
    losses, secs, launches = _run_steps(exe, main, scope, loss, feeds,
                                        QAT_STEPS, kernels)
    log(f"  QAT: {n_fq} fake_quantize_abs_max ops in the program")
    _report_steps("QAT LM, Adam", losses, secs, cfg["batch"] *
                  cfg["max_len"], launches, cfg["num_layers"], QAT_STEPS)
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    assert last < first, f"47(b): the QAT loss did not fall: {losses}"

    test = main.clone(for_test=True).prune([loss])
    frozen = _scope_copy(ptt, scope)
    quantized = [op for op in test.global_block().ops
                 if op.type == "fake_quantize_abs_max"
                 and scope.has_var(op.inputs["X"][0])]
    before = {op.inputs["X"][0]: scope.get(op.inputs["X"][0]).cpu().double()
              .numpy() for op in quantized}
    ftest = ptt.Analyzer(passes=["quant_freeze_pass"]).run(test.clone(),
                                                          frozen)
    worst = 0.0
    for op in quantized:
        w = before[op.inputs["X"][0]]
        s = np.abs(w).max()
        inv = 127 / s
        want = (np.round(w * inv) / inv).astype(np.float32)
        got = frozen.get(op.inputs["X"][0])
        assert got.device == exe.device and got.dtype == torch.float32
        got = got.cpu().numpy()
        assert got.tobytes() == want.tobytes(), op.inputs["X"][0]
        alt = np.round(w * 127 / s) * s / 127
        worst = max(worst, float(np.abs(got - alt).max() / s))
        assert float(frozen.get(op.outputs["OutScale"][0])) == \
            np.float32(s), op.inputs["X"][0]
    ev = [float(exe.run(p, feed=feeds[0], fetch_list=[loss], scope=sc)[0])
          for p, sc in ((test, scope), (ftest, frozen))]
    rel = abs(ev[1] - ev[0]) / abs(ev[0])
    log(f"  quant_freeze_pass: {len(quantized)} weights on their own "
        f"grids (round(w·127/s)·s/127 within {worst:.1e} of s); eval loss "
        f"unfrozen {ev[0]:.6f}, frozen {ev[1]:.6f} (rel {rel:.2e}, bound "
        f"1e-5)")
    assert len(quantized) == cfg["num_layers"] * 6 + 1, len(quantized)
    assert rel <= 1e-5, f"47(b): frozen eval loss {ev} (rel {rel})"
    return {"fake_quant_ops": n_fq, "losses": losses,
            "step_ms_median": float(np.median(secs[1:]) * 1e3),
            "launches": {k: launches[k] for k in FLASH + FLASH_TC},
            "frozen_weights": len(quantized), "eval_losses": ev,
            "frozen_rel": rel}


def _p47_pserver(ptt, kernels, init, feeds):
    """Phase 47(c): the parameter-shard planner on the LM's program. The
    trainer takes two Adam steps through Executor.run (its gradients
    fetched); each endpoint's pserver program takes the same two steps on
    the card, fed the flattened gradient shards."""
    import torch
    from paddle_tpu_torch import transpiler as tr
    cfg = TRAIN
    main, _, loss = _train_program(ptt, cfg)
    eps = "ps0:6174,ps1:6174"
    planners = {}
    for label, split in (("round_robin", tr.RoundRobin),
                         ("hash_name", tr.HashName)):
        t = tr.DistributeTranspiler(tr.DistributeTranspilerConfig(
            split_method=split))
        t.transpile(trainer_id=0, program=main, pservers=eps, trainers=1)
        plan = t.get_shard_plan()
        for p in main.all_parameters():
            blocks = sorted(vb.begin for vb, _ in plan.by_var[p.name])
            sizes = {vb.begin: vb.size for vb, _ in plan.by_var[p.name]}
            assert blocks[0] == 0 and all(
                b + sizes[b] == n for b, n in zip(blocks, blocks[1:])), \
                p.name
            assert blocks[-1] + sizes[blocks[-1]] == \
                int(torch.tensor(p.shape).prod()), p.name
        planners[label] = t
    params = [p.name for p in main.all_parameters()]
    scope = _scope_copy(ptt, init)
    exe = ptt.Executor(ptt.CUDAPlace(0))
    grads = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for i in range(2):
        out = exe.run(main, feed=feeds[i], fetch_list=[loss] + [
            n + "@GRAD" for n in params], scope=scope, return_numpy=False)
        grads.append({n: g.detach().clone().reshape(-1)
                      for n, g in zip(params, out[1:])})
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in FLASH + FLASH_TC}
    for k in FLASH:
        assert launches[k] == 2 * cfg["num_layers"], (k, launches)
    trainer_adam = {op.inputs["Param"][0]: op
                    for op in main.global_block().ops if op.type == "adam"}
    res = {"launches": launches}
    for label, t in planners.items():
        worst, bitwise, n_shards = 0.0, True, 0
        for ep in eps.split(","):
            ps = t.get_pserver_program(ep)
            pscope = ptt.Scope()
            pexe = ptt.Executor(ptt.CUDAPlace(0))
            pexe.run(t.get_startup_program(ep, ps), scope=pscope)
            # (the endpoint's adam op, its parameter, its flat slice)
            shards = []
            for op in ps.global_block().ops:
                if op.type != "adam":
                    continue
                src, blk = op.inputs["Param"][0].rsplit(".block", 1)
                vb = next(vb for vb, e in t.get_shard_plan().by_var[src]
                          if e == ep and vb.block_id == int(blk))
                shards.append((op, src, slice(vb.begin, vb.begin + vb.size)))
            for op, src, cut in shards:
                pscope.set_var(op.inputs["Param"][0],
                               init.get(src).reshape(-1)[cut].clone())
                lr = op.inputs["LearningRate"][0]
                pscope.set_var(lr, scope.get(lr).clone())
            for i in range(2):
                pexe.run(ps, feed={op.inputs["Grad"][0]: grads[i][src][cut]
                                   for op, src, cut in shards},
                         fetch_list=[], scope=pscope)
            for op, src, cut in shards:
                # each shard var against the trainer's slice of its var
                # (the beta powers keep their own shape)
                pairs = [(pscope.get(op.inputs["Param"][0]),
                          scope.get(src).reshape(-1)[cut])]
                for slot in ("Moment1", "Moment2", "Beta1Pow", "Beta2Pow"):
                    whole = scope.get(
                        trainer_adam[src].inputs[slot][0]).reshape(-1)
                    mine = pscope.get(op.inputs[slot][0]).reshape(-1)
                    pairs.append((mine, whole if whole.numel() !=
                                  init.get(src).numel() else whole[cut]))
                for a, b in pairs:
                    assert a.shape == b.shape, (src, a.shape, b.shape)
                    d = float((a - b).abs().max())
                    worst = max(worst, d / max(1.0, float(b.abs().max())))
                    bitwise = bitwise and torch.equal(a, b)
                n_shards += 1
        log(f"  [{label}] pserver programs on the card: {n_shards} shards "
            f"over 2 endpoints, 2 Adam steps: parameters, moments and beta "
            f"powers {'bitwise equal to' if bitwise else 'within'} the "
            f"trainer's (largest |diff| / max(1, |x|) {worst:.2e})")
        assert worst <= 1e-7, f"47(c) {label}: {worst}"
        res[label] = {"shards": n_shards, "bitwise": bitwise,
                      "worst_rel": worst}
    return res


def _p47_recordio(ptt, kernels, init, feeds, root):
    """Phase 47(d): phase 7's batches through RecordIO into 8 training
    steps (a concurrency.go producer over a Channel), against the same
    batches fed as arrays."""
    import numpy as np
    import torch
    from paddle_tpu_torch import concurrency
    from paddle_tpu_torch.data import recordio
    from paddle_tpu_torch.layers import io as lio
    cfg = TRAIN
    names = ["tokens", "tokens@SEQLEN", "targets"]
    # (1) raw records for layers.io.open_files, one file compressed
    raw = [os.path.join(root, f"raw{i}.rio") for i in range(2)]
    for i, path in enumerate(raw):
        with recordio.RecordIOWriter(path, compress=bool(i)) as w:
            for f in feeds[2 * i:2 * i + 2]:
                w.write(b"".join(f[n].tobytes() for n in names))
    got = list(lio.open_files(
        raw, shapes=[feeds[0][n].shape for n in names],
        dtypes=[feeds[0][n].dtype.name for n in names], names=names)())
    assert len(got) == len(feeds)
    for g, f in zip(got, feeds):
        for n in names:
            assert g[n].dtype == f[n].dtype and g[n].tobytes() == \
                f[n].tobytes(), n
    # (2) numpy records (each with its batch index) for the loader
    npf = [os.path.join(root, f"np{i}.rio") for i in range(2)]
    t0 = time.perf_counter()
    for i, path in enumerate(npf):
        recordio.write_numpy_records(path, (
            tuple(feeds[j][n] for n in names) + (np.array([j]),)
            for _ in range(RECORDIO_REPS) for j in (2 * i, 2 * i + 1)),
            compress=bool(i))
    write_s = time.perf_counter() - t0
    file_mb = sum(os.path.getsize(p) for p in npf) / 1e6
    t0 = time.perf_counter()
    with recordio.ParallelRecordLoader(npf, num_threads=4) as ld:
        recs = list(ld)
    read_s = time.perf_counter() - t0
    n_rec, n_bytes = len(recs), sum(len(r) for r in recs)
    assert n_rec == 4 * RECORDIO_REPS, n_rec
    # every record of both files, decoded, is its batch bit for bit
    seen = [0] * len(feeds)
    for rec in recordio.read_numpy_records(recs):
        j = int(rec[3][0])
        seen[j] += 1
        assert all(a.tobytes() == feeds[j][n].tobytes()
                   for a, n in zip(rec, names)), j
    assert seen == [RECORDIO_REPS] * len(feeds), seen
    del recs
    log(f"  RecordIO: {n_rec} records ({n_bytes / 1e6:.1f} MB, "
        f"{file_mb:.1f} MB in 2 files, one compressed) written in "
        f"{write_s:.2f} s; ParallelRecordLoader (4 threads) read them in "
        f"{read_s:.3f} s: {n_rec / read_s:.0f} records/s, "
        f"{n_bytes / 1e6 / read_s:.1f} MB/s")

    # (3) the training loop fed by a go producer over a channel
    ch = concurrency.Channel(capacity=2)
    loader = recordio.ParallelRecordLoader(npf, num_threads=4)

    def produce():
        sent = 0
        try:
            for rec in recordio.read_numpy_records(loader):
                if sent == RECORDIO_STEPS:
                    break
                feed = dict(zip(names, rec[:3]))
                assert all(feed[n].tobytes() == feeds[int(rec[3][0])][n]
                           .tobytes() for n in names)
                if not ch.send((int(rec[3][0]), feed), timeout=60):
                    raise TimeoutError("47(d): the training loop stopped")
                sent += 1
        finally:
            # the loop ends on close, also when this thread failed (its
            # error surfaces at join)
            ch.close()
            loader.close()
        return sent

    main, _, loss = _train_program(ptt, cfg)
    exe = ptt.Executor(ptt.CUDAPlace(0))

    scope = _scope_copy(ptt, init)
    producer = concurrency.go(produce)
    order, fed_losses, per_step = [], [], []
    while True:
        item, ok = ch.recv(timeout=60)
        if not ok:
            break
        idx, feed = item
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        per_step.append({k: kernels.LAUNCHES[k] for k in FLASH})
        order.append(idx)
        fed_losses.append(float(out))
    assert producer.join(timeout=60) == RECORDIO_STEPS
    launches = {k: sum(s[k] for s in per_step) for k in FLASH}
    scope = _scope_copy(ptt, init)
    arr_losses = [float(exe.run(main, feed=feeds[i], fetch_list=[loss],
                                scope=scope)[0]) for i in order]
    del scope
    same = fed_losses == arr_losses
    log(f"  {len(order)} steps fed by the loader through a "
        f"Channel(capacity=2), batches {order}: losses "
        f"{[round(x, 6) for x in fed_losses]}; fed as arrays "
        f"{'bit for bit the same' if same else arr_losses}; K1-K3 a step "
        f"{per_step[0]}")
    assert len(order) == RECORDIO_STEPS and same, (fed_losses, arr_losses)
    for s in per_step:
        for k in FLASH:
            assert s[k] == cfg["num_layers"], f"47(d): {k} {per_step}"
    return {"records": n_rec, "record_mb": n_bytes / 1e6,
            "file_mb": file_mb, "write_s": write_s, "read_s": read_s,
            "records_per_s": n_rec / read_s,
            "mb_per_s": n_bytes / 1e6 / read_s, "order": order,
            "losses": fed_losses, "launches": launches}


def transpile_and_recordio(ptt, kernels, resnet_params):
    """Phase 47: (a) BN folding on ResNet-50, (b) QAT and the weight
    freeze on phase 7's LM, (c) the parameter-shard planner's pserver
    programs on the card, (d) RecordIO feeding the LM through a go
    producer and a channel."""
    import torch
    t0 = time.perf_counter()
    out = {}
    log("  (a) batch-norm folding on phase 19's ResNet-50")
    out["bn_fold"] = _p47_bn_fold(ptt, resnet_params)
    torch.cuda.empty_cache()
    feeds = _lm_steps_feeds(TRAIN, TRAIN_BATCHES, SEED)   # phase 7's
    log("  (b) quantization-aware training of phase 7's LM")
    out["qat"] = _p47_qat(ptt, kernels, feeds)
    torch.cuda.empty_cache()
    # the LM's startup state, which (c) and (d) start from
    _, start, _ = _train_program(ptt, TRAIN)
    init = ptt.Scope()
    ptt.Executor(ptt.CUDAPlace(0)).run(start, scope=init)
    log("  (c) the parameter-shard planner's pserver programs")
    out["pserver"] = _p47_pserver(ptt, kernels, init, feeds)
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_rio_")
    try:
        log("  (d) RecordIO feeding the LM")
        out["recordio"] = _p47_recordio(ptt, kernels, init, feeds, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 47 in {out['phase_s']:.1f} s (budget "
        f"{PHASE47_BUDGET_S:.0f} s)")
    assert out["phase_s"] <= PHASE47_BUDGET_S, out["phase_s"]
    return out


# ---------------------------------------------------------------------------
# phase 48: the command-line tools and the examples, as a user runs them
# ---------------------------------------------------------------------------

#: phase 48(a): the lint sweeps, each `--all --json` with these flags
LINT_SWEEPS = {"plain": [], "dp2": ["--dp", "2"], "tp2": ["--tp", "2"],
               "pp2": ["--pipeline_stages", "2"],
               "memory_plan": ["--memory_plan"], "offload": ["--offload"],
               "serving": ["--serving"]}
#: phase 48(c): demo_trainer's iterations and batch on phase 7's LM
DEMO_ITERS, DEMO_BATCH = 3, 8
#: phase 48's wall-clock bound (s)
PHASE48_BUDGET_S = 240.0
_TOOLS = "paddle_tpu_torch.tools."
#: runs an example as `python -m` does, then reports the kernel launches
#: of its process on stderr (the example prints only its own lines)
_EXAMPLE_RUNNER = (
    "import json, runpy, sys\n"
    "from paddle_tpu_torch import kernels\n"
    "name = sys.argv[1]\n"
    "sys.argv = [name]\n"
    "try:\n"
    "    runpy.run_module(name, run_name='__main__', alter_sys=True)\n"
    "except SystemExit as e:\n"
    "    assert e.code in (0, None), e.code\n"
    "print('LAUNCHES ' + json.dumps(dict(kernels.LAUNCHES)), "
    "file=sys.stderr)\n")


#: phase 48: children that may run at once beside the two drills. The
#: drills' gang launches in turn are the phase's path; an interpreter
#: start takes ~8 s on the card's host alone and far longer in a crowd
#: (print_signatures 10.2 s alone, 35.4 s among 18 children)
P48_SLOTS = 4
#: the lint and signature children that run at once beside phases 21-45
#: (phase 46's five exports run there too, on a host of 8 cores)
BACKGROUND_SLOTS = 2


class _Job:
    """One `sys.executable` child of phase 48, its output in files. With
    `slots` (a semaphore) it starts when a slot is free; with `nice` it
    runs at that niceness; a thread waits for it, so its seconds run from
    its start to its exit."""

    def __init__(self, tmp, label, argv, env=None, slots=None, nice=0):
        import threading
        self.label = label
        self.out = open(os.path.join(tmp, f"{label}.out"), "w+")
        self.err = open(os.path.join(tmp, f"{label}.err"), "w+")
        self.proc = self.t0 = self.t1 = None
        self.error = None
        argv = [sys.executable, *argv]
        env = {**os.environ, **(env or {})}

        def run():
            try:
                with slots or contextlib.nullcontext():
                    self.t0 = time.perf_counter()
                    self.proc = _track(subprocess.Popen(
                        argv, stdout=self.out, stderr=self.err,
                        cwd=os.path.dirname(os.path.abspath(__file__)),
                        env=env, start_new_session=True))
                    if nice:
                        _lower_priority(self.proc.pid, nice)
                    self.proc.wait()
                    self.t1 = time.perf_counter()
            except BaseException as e:  # surfaced by wait()
                self.error = e

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def join(self, timeout=900):
        """Wait for the child to exit, at most `timeout` seconds; wait()
        reads its result."""
        self.thread.join(timeout)

    def wait(self, timeout=900):
        """(exit code, stdout, stderr, seconds from start to exit); a
        child not done within `timeout` is killed and raises."""
        self.thread.join(timeout)
        if self.thread.is_alive():
            if self.proc is not None:
                os.killpg(self.proc.pid, signal.SIGKILL)
            raise TimeoutError(f"phase 48: {self.label} did not end")
        if self.error is not None:
            raise self.error
        texts = []
        for f in (self.out, self.err):
            f.seek(0)
            texts.append(f.read())
            f.close()
        return self.proc.returncode, texts[0], texts[1], self.t1 - self.t0


def _p48_lint_rows(label, rc, out, err, want_rc=0):
    assert rc == want_rc, f"48(a) {label}: exit {rc}\n{err[-3000:]}"
    return json.loads(out)


def _p48_check_lint(jobs, card):
    """Phase 48(a): each sweep exits 0 with 23 clean rows; the gate
    contract on `--model mnist --tp 2`."""
    out = {}
    for label, job in jobs.items():
        rc, text, err, secs = job.wait()
        if label == "tp_gate":
            rows = _p48_lint_rows(label, rc, text, err, want_rc=2)
            assert rows[0]["gate_rejected"], rows
        else:
            rows = _p48_lint_rows(label, rc, text, err)
        if label in LINT_SWEEPS:
            assert len(rows) == 23, (label, len(rows))
            assert sum(r["errors"] for r in rows) == 0, \
                [r["diagnostics"] for r in rows if r["errors"]]
        out[label] = {"exit": rc, "rows": len(rows), "seconds": secs,
                      "gate_rejected": sum(bool(r["gate_rejected"])
                                           for r in rows)}
        log(f"  (a) lint {label}: exit {rc}, {len(rows)} row(s), "
            f"{out[label]['gate_rejected']} gate-rejected, {secs:.1f} s "
            f"({card})")
    return out


def _p48_drill(jobs, tmp, card):
    """Phase 48(b): recovery_smoke's phases A and C at dp 1 (a gang of one
    rank on NCCL), two drills at once."""
    rep, secs = {}, {}
    for ph, job in jobs.items():
        rc, text, err, secs[ph] = job.wait()
        assert rc == 0, f"48(b) phase {ph}: recovery_smoke exit {rc}\n" \
                        f"{text[-3000:]}\n{err[-3000:]}"
        with open(os.path.join(tmp, f"drill_{ph}.json")) as f:
            rep[ph] = json.load(f)[ph]
    a, c = rep["A"], rep["C"]
    assert a["restarts"] == 1 and a["exit_codes"] == [-9, 0], a
    assert a["resume_step"] == 4, a
    assert c["crash_rc"] == -9 and c["leftovers"] >= 1, c
    log(f"  (b) recovery drill at dp 1 on NCCL: phase A {a['restarts']} "
        f"restart(s), exit codes {a['exit_codes']}, resumed at step "
        f"{a['resume_step']}, bitwise, {secs['A']:.1f} s; phase C killed at "
        f"byte 0 (exit {c['crash_rc']}), {c['leftovers']} uncommitted "
        f"dir(s) left, restart from step {c['resume_step']} bitwise, "
        f"{secs['C']:.1f} s ({card})")
    return {"report": rep, "seconds": secs}


def _p48_demo_args(ptt, tmp):
    """Phase 7's LM saved with io.save_program; demo_trainer's argv."""
    d = os.path.join(tmp, "lm_program")
    main_p, start_p, loss = _train_program(ptt, TRAIN)
    ptt.io.save_program(d, main_program=main_p, startup_program=start_p,
                        feed_names=["tokens", "tokens@SEQLEN", "targets"],
                        fetch_names=[loss])
    return ["--model_dir", d, "--iters", str(DEMO_ITERS), "--batch_size",
            str(DEMO_BATCH)]


def _p48_demo(ptt, kernels, job, argv, card):
    """Phase 48(c): the saved LM trained through demo_trainer (`job`, a
    child, float32, TF32 off) against Executor.run on the same
    synth_feed here; the tool's main() again in this process to count
    its launches."""
    import io as _io

    import torch
    from paddle_tpu_torch.tools import demo_trainer
    d = argv[1]
    old = ptt.flags.get_flag("use_bf16_matmul")
    ptt.flags.set_flag("use_bf16_matmul", False)
    try:
        m2, s2, feeds, fetches = ptt.io.load_program(d)
        exe = ptt.Executor(ptt.CUDAPlace(0))
        exe.run(s2)
        feed = demo_trainer.synth_feed(m2, feeds, DEMO_BATCH)
        want = [float(exe.run(m2, feed=feed, fetch_list=fetches)[0]
                      .reshape(-1)[0]) for _ in range(DEMO_ITERS)]
        del exe
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        buf = _io.StringIO()
        with contextlib.redirect_stdout(buf):
            demo_trainer.main([*argv, "--place", "cuda"])
        torch.cuda.synchronize()
        launches = {k: kernels.LAUNCHES[k] for k in FLASH}
    finally:
        ptt.flags.set_flag("use_bf16_matmul", old)
    rc, text, err, secs = job.wait()
    assert rc == 0, f"48(c): demo_trainer exit {rc}\n{err[-3000:]}"
    lines = text.splitlines()
    got = [float(ln.split("=")[-1]) for ln in lines[:DEMO_ITERS]]
    assert [ln.split(":")[0] for ln in lines[:DEMO_ITERS]] == \
        [f"iter {i}" for i in range(DEMO_ITERS)], lines
    assert json.loads(lines[-1])["status"] == "ok", lines[-1]
    worst = max(abs(a - b) for a, b in zip(got, want))
    assert worst <= 1e-5, f"48(c): tool {got} vs Executor.run {want}"
    n_layers = TRAIN["num_layers"]
    assert buf.getvalue().splitlines()[:DEMO_ITERS] == lines[:DEMO_ITERS]
    for k in FLASH:
        assert launches[k] == n_layers * DEMO_ITERS, (k, launches)
    log(f"  (c) demo_trainer on phase 7's LM (vocab {TRAIN['vocab']}, "
        f"d_model {TRAIN['d_model']}, {n_layers} layers, max_len "
        f"{TRAIN['max_len']}) at batch {DEMO_BATCH}: losses {got}, "
        f"Executor.run {want}, max |diff| {worst:.2e}; K1-K3 launches "
        f"{launches} ({n_layers} a step each); the child took {secs:.1f} s "
        f"({card})")
    return {"losses": got, "reference": want, "max_abs_diff": worst,
            "launches": launches, "seconds": secs}


def _p48_examples(jobs, card):
    """Phase 48(d): the three examples' lines and launches."""
    out = {}
    for label, job in jobs.items():
        rc, text, err, secs = job.wait()
        assert rc == 0, f"48(d) {label}: exit {rc}\n{err[-3000:]}"
        lines = text.splitlines()
        launches = json.loads(next(ln for ln in err.splitlines()
                                   if ln.startswith("LAUNCHES "))[9:])
        row = {"lines": lines, "seconds": secs, "launches": launches}
        if label == "generate_text":
            loss = {int(ln.split()[1][:-1]): float(ln.split()[-1])
                    for ln in lines if ln.startswith("step ")}
            assert sorted(loss) == [0, 100, 200], lines
            assert loss[200] < loss[0], loss
            assert lines[-1].startswith("generated: 't"), lines[-1]
            for k in FLASH + ("decode_attention",):
                assert launches[k] > 0, (k, launches)
            row["loss"] = loss
        elif label == "serve_model":
            legs = {}
            for ln in lines:
                key, _, vals = ln.partition(":")
                legs[key] = [float(v) for v in
                             vals.strip().strip("[]").split()]
            assert list(legs) == ["in-process", "served (4 pipelined)",
                                  "C++ server"], lines
            # one archive on one card: the legs agree within the
            # printed digits (cuDNN may pick another algorithm in the C++
            # process)
            for key, vals in legs.items():
                assert len(vals) == 3 and all(
                    abs(a - b) <= 1e-4 for a, b in
                    zip(vals, legs["in-process"])), (key, legs)
            row["legs"] = legs
        else:
            assert lines[0].startswith("epoch 0 step 0: loss "), lines
            assert re.fullmatch(r"reloaded predictor says: \d", lines[-1]), \
                lines
        out[label] = row
        shown = {k: launches[k] for k in FLASH + ("decode_attention",)}
        log(f"  (d) {label}: exit 0 in {secs:.1f} s, lines {lines}, "
            f"launches {shown} ({card})")
    return out


def _p48_trace(ptt, tmp, card):
    """Phase 48(e): a barrier round over a simulated world of 2 ranks on
    the card's state, with the flight recorder installed and memory
    watermarks under each rank's tags; its trace through trace_merge."""
    import torch
    from paddle_tpu_torch.observability import flight_recorder
    from paddle_tpu_torch.observability import memory as obs_memory
    from paddle_tpu_torch.observability import tracing
    from paddle_tpu_torch.parallel import elastic
    from paddle_tpu_torch.parallel.process_world import ProcessWorld
    from paddle_tpu_torch.tools import recovery_smoke as drill
    flight_recorder.install(os.path.join(tmp, "dossiers"), excepthook=False)
    mark = tracing.mark()
    world = ProcessWorld(2)
    arrays = drill.world_atomic_arrays(0)
    prog, scope = drill._program_and_scope(arrays)
    for n in arrays:
        scope.set_var(n, scope.get(n).cuda())
    path = elastic.save_train_state(os.path.join(tmp, "trace_snap"),
                                    program=prog, scope=scope,
                                    executor=drill._MeshOnly(2), step=0,
                                    world=world, barrier_deadline_s=30)
    assert path is not None, "48(e): the barrier did not commit"
    for r in range(2):
        with tracing.rank_scope(world.world_id, r, 2):
            obs_memory.update_watermark("device_state_bytes",
                                        torch.cuda.memory_allocated())
    src = tracing.export_chrome_trace(os.path.join(tmp, "ranks.json"),
                                      tracing.spans_since(mark))
    flight_recorder.configure(None)
    merged = os.path.join(tmp, "merged.json")
    rc, text, err, secs = _Job(tmp, "trace_merge",
                               ["-m", _TOOLS + "trace_merge", src, "-o",
                                merged]).wait()
    assert rc == 0, f"48(e): trace_merge exit {rc}\n{err[-2000:]}"
    with open(merged) as f:
        doc = json.load(f)
    evs = [e for e in doc["traceEvents"] if e.get("ph") != "M"]
    meta = [e for e in doc["traceEvents"] if e.get("ph") == "M"]
    barrier = {e["pid"] for e in evs
               if str(e.get("name", "")).startswith("barrier/")}
    assert barrier == {0, 1}, barrier
    pnames = {e["pid"]: e["args"]["name"] for e in meta
              if e["name"] == "process_name"}
    assert pnames[0].startswith("rank 0") and pnames[1].startswith("rank 1")
    lanes = {(e["pid"], e["tid"]): e["args"]["name"] for e in meta
             if e["name"] == "thread_name"}
    counters = [e for e in evs if e.get("ph") == "C"]
    assert {c["pid"] for c in counters} >= {0, 1}, counters
    assert all(lanes[(c["pid"], c["tid"])] == "memory" for c in counters)
    stage = [e["ts"] for e in evs if e.get("name") == "barrier/stage"]
    assert stage and abs(min(stage)) < 1e-6, stage
    log(f"  (e) trace_merge: {text.strip()}; barrier spans on rank lanes "
        f"{sorted(barrier)}, {len(counters)} memory counter event(s) on "
        f"the 'memory' lane, {secs:.1f} s ({card})")
    return {"events": len(doc["traceEvents"]), "seconds": secs}


def start_lint_and_signatures(tmp, nice=BACKGROUND_NICE, slots=P48_SLOTS):
    """Phase 48(a)'s lint sweeps and gate runs and (f)'s signature check,
    started as children now, `slots` at a time (main() starts them after
    phase 20, beside phase 46's exports: they need no kernel and no
    weight) and checked in phase 48. Returns {"lint": {label: job},
    "sigs": job}."""
    import threading
    slots = threading.BoundedSemaphore(slots)
    lint = {label: _Job(tmp, f"lint_{label}", [
        "-m", _TOOLS + "lint_program", "--all", "--json", *flags,
        *(["--allow_gate_rejects"] if flags else [])], slots=slots,
        nice=nice) for label, flags in LINT_SWEEPS.items()}
    gate = ["-m", _TOOLS + "lint_program", "--model", "mnist", "--tp",
            "2", "--json"]
    lint["tp_gate"] = _Job(tmp, "lint_tp_gate", gate, slots=slots,
                           nice=nice)
    lint["tp_gate_allowed"] = _Job(tmp, "lint_tp_gate_allowed",
                                   gate + ["--allow_gate_rejects"],
                                   slots=slots, nice=nice)
    sigs = _Job(tmp, "print_signatures",
                ["-m", _TOOLS + "print_signatures", "--check"], slots=slots,
                nice=nice)
    return {"lint": lint, "sigs": sigs}


def start_drills(tmp, nice=BACKGROUND_NICE):
    """Phase 48(b)'s two drills, started as children now (main() starts
    them as phase 46 begins and waits for them as it ends: a gang of one
    MNIST rank is light on the card) and checked in phase 48. Returns
    {phase: job}."""
    return {ph: _Job(tmp, f"recovery_smoke_{ph}", [
        "-m", _TOOLS + "recovery_smoke", "--dp", "1", "--phases", ph,
        "--keep_root", os.path.join(tmp, f"drill_{ph}"), "--report",
        os.path.join(tmp, f"drill_{ph}.json")], nice=nice) for ph in "AC"}


def tools_and_examples(ptt, kernels, card, early=None, tmp=None):
    """Phase 48: the port's tools and examples run as a user runs them,
    in `sys.executable` children: (a) lint_program's sweeps and its gate
    contract, then --restore_dir on what (b) left, (b) recovery_smoke's
    phases A and C at dp 1, (c) demo_trainer on phase 7's LM, (d) the
    three examples, (e) trace_merge on a rank-tagged trace, (f)
    print_signatures --check. The drills start at once; the other
    children but (a)'s --restore_dir queue for P48_SLOTS slots beside
    them; (c)'s reference and (e)'s trace are made in this process
    meanwhile. `card` is nvidia-smi's name and power
    limit. `early` holds the children main() started before this
    phase (start_lint_and_signatures, start_drills, in `tmp`); what it
    lacks starts here."""
    import threading
    t0 = time.perf_counter()
    early = dict(early or {})
    tmp = tmp or tempfile.mkdtemp(prefix="chip_smoke_tools_")
    out = {}
    try:
        drills_early = "drills" in early
        drills = early.get("drills") or start_drills(tmp, nice=0)
        if "lint" not in early:
            early.update(start_lint_and_signatures(tmp, nice=0))
        lint, sigs = early["lint"], early["sigs"]
        # the rest queue for P48_SLOTS slots, the longest first
        slots = threading.BoundedSemaphore(P48_SLOTS)
        examples = {n: _Job(tmp, n, ["-c", _EXAMPLE_RUNNER,
                                     f"paddle_tpu_torch.examples.{n}"],
                            slots=slots)
                    for n in ("serve_model", "generate_text",
                              "train_mnist")}
        demo_argv = _p48_demo_args(ptt, tmp)
        demo = _Job(tmp, "demo_trainer", ["-m", _TOOLS + "demo_trainer",
                                          *demo_argv],
                    env={"PTPU_USE_BF16_MATMUL": "0"}, slots=slots)

        def drill_then_restore():
            # the --restore_dir runs start once the drills have left
            # their snapshots
            log("  (b) recovery_smoke")
            out["drill"] = _p48_drill(drills, tmp, card)
            rep = out["drill"]["report"]
            return {
                "committed": _Job(tmp, "lint_restore_committed", [
                    "-m", _TOOLS + "lint_program", "--model", "mnist",
                    "--optimizer", "momentum", "--json", "--restore_dir",
                    os.path.join(tmp, "drill_A", "a")]),
                "uncommitted": _Job(tmp, "lint_restore_uncommitted", [
                    "-m", _TOOLS + "lint_program", "--model", "mnist",
                    "--optimizer", "momentum", "--json", "--restore_dir",
                    rep["C"]["leftover_kept"]])}

        if drills_early:
            restore = drill_then_restore()
        log("  (c) demo_trainer")
        out["demo"] = _p48_demo(ptt, kernels, demo, demo_argv, card)
        log("  (e) trace_merge")
        out["trace_merge"] = _p48_trace(ptt, tmp, card)
        log("  (a) lint_program")
        out["lint"] = _p48_check_lint(lint, card)
        log("  (d) the examples")
        out["examples"] = _p48_examples(examples, card)
        rc, text, err, secs = sigs.wait()
        assert rc == 0, f"48(f): print_signatures --check exit {rc}\n" \
                        f"{text[-3000:]}"
        out["print_signatures"] = {"line": text.strip().splitlines()[-1],
                                   "seconds": secs}
        log(f"  (f) print_signatures --check: "
            f"{out['print_signatures']['line']}, {secs:.1f} s ({card})")
        if not drills_early:
            restore = drill_then_restore()
        for label, want in (("committed", 0), ("uncommitted", 1)):
            rc, text, err, secs = restore[label].wait()
            rows = _p48_lint_rows(f"--restore_dir {label}", rc, text, err,
                                  want_rc=want)
            codes = [d["code"] for d in rows[0]["diagnostics"]]
            assert codes == ([] if want == 0 else ["restore-uncommitted"]), \
                codes
            out["lint"][f"restore_{label}"] = {"exit": rc, "seconds": secs,
                                               "codes": codes}
            log(f"  (a) lint --restore_dir on (b)'s {label} snapshot: exit "
                f"{rc} {codes}, {secs:.1f} s ({card})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 48 in {out['phase_s']:.1f} s (budget "
        f"{PHASE48_BUDGET_S:.0f} s; {card})")
    assert out["phase_s"] <= PHASE48_BUDGET_S, out["phase_s"]
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["--phase44-child"]:
        phase44_child(*sys.argv[2:])
        return 0
    if sys.argv[1:2] == ["--export-child"]:
        export_child(*sys.argv[2:])
        return 0
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    started = [time.perf_counter(), None]

    def _phase(title):
        """Log the seconds the previous phase took, then the next title."""
        now = time.perf_counter()
        if started[1] is not None:
            log(f"  ({started[1]} took {now - started[0]:.1f} s)")
        started[0], started[1] = now, title and title.split(":")[0]
        if title:
            log(title)

    _phase("phase 1: card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    part, rates = card_rates(name)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {name} "
        f"(rates of the H100 {part} part: {rates[0] / 1e12:.2f} TB/s, "
        f"{rates[1] / 1e12:.0f} TFLOP/s float32, {rates[2] / 1e12:.0f} "
        f"TFLOP/s dense bfloat16)")

    _phase("phase 2: build kernels")
    t0 = time.perf_counter()
    # phase 46's native programs compile (g++) beside the kernels' nvcc
    # builds, and link once those are on disk
    from concurrent.futures import ThreadPoolExecutor
    from paddle_tpu_torch import native
    from paddle_tpu_torch.data import recordio
    with ThreadPoolExecutor(2) as pool:
        native_build = pool.submit(native.build)
        # the RecordIO container's library (phase 47), g++ beside them
        rio_build = pool.submit(lambda: (recordio.build(),
                                         time.perf_counter() - t0))
        took = kernels.build()
        log(f"  built {sorted(took)} in {time.perf_counter() - t0:.2f} s "
            f"(per source: {took})")
        native_build.result()
        rio_path, rio_s = rio_build.result()
    log(f"  built the native programs beside them (phase 46): "
        f"{time.perf_counter() - t0:.2f} s in all, g++ "
        f"{native.BUILD_SECONDS}; the RecordIO library "
        f"{os.path.basename(rio_path)} by {rio_s:.2f} s")
    for kname, text in kernels.BUILD_LOGS.items():
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill", text)]
        log(f"  [{kname}] {len(regs)} instantiations, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, spill bytes "
            f"{max(spills, default=0)}")

    _tc_build_report(kernels)
    _recurrent_build_report(kernels)

    _phase("phase 3: kernels against their plain versions")
    results = {"decode_attention": check_decode_attention(ptt, name, rates)}
    results["decode_attention"].update(check_decode_attention_nmt(rates))
    results["decode_attention"].update(check_decode_attention_beam(rates))
    results["decode_attention"].update(check_decode_attention_routes(rates))
    results["decode_attention"].update(
        check_decode_attention_generate(rates))
    results.update(check_flash(ptt, rates))
    results.update(check_recurrent(ptt, rates))
    for kname, row in check_recurrent_bf16(ptt, rates).items():
        results[kname].update(row)

    _phase("phase 4: serve the Transformer LM at full width")
    serve_launches, eng, base = serve(ptt, kernels)

    _phase("phase 5: reference check on a small input")
    reference_check(ptt)

    _phase("phase 6: where a serving tick's time goes")
    profile_ticks(eng)
    del eng

    _phase("phase 7: train the Transformer LM at full width")
    train_launches, trainer = train(ptt, kernels)
    # its trained parameters, for phase 38's generation
    lm_params = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    atexit.register(shutil.rmtree, lm_params, ignore_errors=True)
    ptt.io.save_params(trainer[0], lm_params, main_program=trainer[1],
                       scope=trainer[2])

    _phase("phase 8: train on packed ragged sequences at full width")
    train_packed(ptt, kernels)

    _phase("phase 9: training reference check on a small input")
    train_reference_check(ptt)

    _phase("phase 10: where a training step's time goes")
    profile_train(trainer)
    del trainer

    _phase("phase 11: train the stacked LSTM at full width")
    lstm_launches, lstm_trainer = train_lstm(ptt, kernels)

    _phase("phase 12: train the GRU-attention NMT model at full width")
    nmt_launches, nmt_trainer = train_nmt(ptt, kernels)
    # its trained parameters, for phase 32's beam decoding
    nmt_params = tempfile.mkdtemp(prefix="chip_smoke_nmt_")
    atexit.register(shutil.rmtree, nmt_params, ignore_errors=True)
    ptt.io.save_params(nmt_trainer[0], nmt_params,
                       main_program=nmt_trainer[1], scope=nmt_trainer[2])

    _phase("phase 13: recurrent training reference check on small inputs")
    recurrent_reference_check(ptt)

    _phase("phase 14: where a recurrent training step's time goes")
    profile_recurrent({"stacked LSTM": lstm_trainer, "NMT": nmt_trainer})
    del lstm_trainer, nmt_trainer

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        _phase("phase 15: train the encoder-decoder Transformer-base through "
            "Trainer")
        paths = {"transformer_base_train": None}
        paths["transformer_base_train"], tr_trainer, tr_feeds, held = \
            train_transformer(ptt, kernels, root)

        _phase("phase 16: serve its is_test program through Inferencer (K1)")
        paths["transformer_base_infer"] = infer_transformer(
            ptt, kernels, tr_trainer, held, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    _phase("phase 17: encoder-decoder reference check on a small input")
    paths["transformer_small_reference"] = transformer_reference_check(ptt)

    _phase("phase 18: where a Transformer-base training step's time goes")
    paths["transformer_base_profile"] = profile_train(
        (tr_trainer.exe, tr_trainer.train_program, tr_trainer.scope,
         tr_trainer.loss, tr_feeds))
    # its trained parameters, for phase 39's generation
    tr_params = tempfile.mkdtemp(prefix="chip_smoke_transformer_")
    atexit.register(shutil.rmtree, tr_params, ignore_errors=True)
    ptt.io.save_params(tr_trainer.exe, tr_params,
                       main_program=tr_trainer.train_program,
                       scope=tr_trainer.scope)
    del tr_trainer, tr_feeds
    torch.cuda.empty_cache()

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        _phase("phase 19: train ResNet-50 at full width, fed uint8 through "
            "the DevicePrefetcher")
        paths["resnet50_train"], resnet_trained = train_resnet(ptt, kernels)
        exe_, main_, scope_, loss_, _, dev_feeds, _ = resnet_trained
        # its trained parameters and moved running statistics, for phase
        # 47's batch-norm folding
        resnet_params = tempfile.mkdtemp(prefix="chip_smoke_resnet_")
        atexit.register(shutil.rmtree, resnet_params, ignore_errors=True)
        ptt.io.save_params(exe_, resnet_params, main_program=main_,
                           scope=scope_)
        log("  where a ResNet-50 step's time goes:")
        paths["resnet50_profile"] = profile_train(
            (exe_, main_, scope_, loss_, dev_feeds))

        _phase("phase 20: serve ResNet-50 through Inferencer at batch 16")
        paths["resnet50_infer"] = infer_resnet(ptt, resnet_trained, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del resnet_trained, exe_, main_, scope_, dev_feeds
    torch.cuda.empty_cache()
    # phase 46's exports have every weight they need now, and phase 48's
    # lint sweeps and signature check need none: they run beside phases
    # 21-45, at a lower priority, the lint children two at a time. Not
    # before: cuDNN's autotuning in phases 19-20 picks ResNet-50's
    # convolutions by their times (phase 47 folds with phase 20's picks)
    exports = start_exports(ptt, lm_params, tr_params, nmt_params)
    tools_tmp = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    atexit.register(shutil.rmtree, tools_tmp, ignore_errors=True)
    early = start_lint_and_signatures(tools_tmp, slots=BACKGROUND_SLOTS)
    log("  phase 46's five exports and phase 48's lint and signature "
        "children started beside the phases to come")

    _phase("phase 21: image models card against CPU (ResNet-8, SE-ResNeXt)")
    paths["resnet_reference"] = resnet_reference_check(ptt)
    torch.cuda.empty_cache()

    _phase("phase 22: train DeepFM at full width with sparse gradients")
    paths["deepfm_sparse_train"] = train_deepfm(ptt, kernels)
    torch.cuda.empty_cache()

    _phase("phase 23: train the LM under memory_optimize over K1-K3")
    paths["lm_remat_train"] = train_lm_remat(ptt, kernels)
    torch.cuda.empty_cache()

    _phase("phase 24: the rest of training card against CPU (optimizers, "
        "ModelAverage, DeepFM sparse, ResNet-8 remat, piecewise_decay)")
    paths["training_rest_reference"] = rest_reference_check(ptt)
    torch.cuda.empty_cache()

    _phase("phase 25: paged serving at full width (PagedKVEngine, prefix "
           "sharing, paged_beam_search)")
    paths["paged_serve"], paged_tokens = serve_paged(ptt, kernels, base)
    torch.cuda.empty_cache()

    _phase("phase 26: weight-quantized serving at full width (int8, int4, "
           "int8 KV pools)")
    paths["quant_serve"] = serve_quantized(ptt, kernels, base)

    _phase("phase 27: speculative serving at full width (gamma 4, int8 "
           "draft; slot and paged engines)")
    paths["spec_serve"] = serve_speculative(ptt, kernels, base)
    for label in ("slot", "paged"):
        log(f"  [speculative, {label}] "
            f"{paths['spec_serve'][label]['generated_tokens_per_s']:.1f} "
            f"generated tokens/s against phase 4's "
            f"{base['generated_tokens_per_s']:.1f} and phase 26's float32 "
            f"engine's "
            f"{paths['quant_serve']['float32']['generated_tokens_per_s']:.1f}")

    _phase("phase 28: small reference check of the paged, quantized and "
           "speculative engines, card against CPU")
    paths["paged_quant_spec_reference"] = \
        paged_quant_spec_reference_check(ptt)
    torch.cuda.empty_cache()

    _phase("phase 29: serve through EngineServer (4 clients, /metrics, "
           "/healthz, drain)")
    paths["server"] = serve_server(ptt, kernels, base)
    torch.cuda.empty_cache()

    _phase("phase 30: two-tier paging to pinned host memory (65 device "
           "blocks, 256 host blocks)")
    paths["two_tier"] = serve_two_tier(ptt, kernels, base,
                                       paths["paged_serve"])

    _phase("phase 31: the KV sanitizer on the two-tier engine, and "
           "tracing spans")
    paths["sanitize_trace"] = sanitize_and_trace(ptt, kernels, base)
    torch.cuda.empty_cache()

    _phase("phase 32: translate with the NMT model at full width (beam 4 "
           "through infer_net)")
    # (nmt_params stays for phase 46; atexit removes it)
    paths["nmt_beam_translate"] = translate_nmt(ptt, kernels, nmt_params)
    torch.cuda.empty_cache()

    _phase("phase 33: train and decode the BiLSTM-CRF (label semantic "
           "roles) at the book's widths")
    paths["bilstm_crf"] = train_srl(ptt, kernels)
    torch.cuda.empty_cache()

    _phase("phase 34: beam decoding, the BiLSTM-CRF, the control-flow "
           "programs and this slice's ops, card against CPU")
    paths["recurrent_rest_reference"] = recurrent_rest_reference_check(ptt)
    torch.cuda.empty_cache()

    _phase("phase 35: train and decode SSD at its defaults (21 classes, "
           "128x128, batch 32)")
    paths["ssd_train"] = train_ssd(ptt, kernels)
    torch.cuda.empty_cache()

    _phase("phase 36: train and decode CRNN-CTC at its defaults (K6 at "
           "B 64, T 32, H 96, both directions)")
    paths["crnn_train"] = train_crnn(ptt, kernels)
    torch.cuda.empty_cache()

    _phase("phase 37: SSD and CRNN at test width and this slice's ops, "
           "card against CPU")
    paths["ocr_detection_reference"] = ocr_detection_reference_check(ptt)
    torch.cuda.empty_cache()

    _phase("phase 38: generate with phase 7's LM at full width "
           "(transformer_lm_generate: greedy b16 and b64, beam 4 b16)")
    paths["lm_generate"] = generate_lm(ptt, kernels, lm_params)

    _phase("phase 39: generate with phase 15's Transformer-base "
           "(transformer_generate: beam 4 and 1, K1 in the encoder)")
    paths["nmt_generate"] = generate_nmt(ptt, kernels, tr_params)
    torch.cuda.empty_cache()

    _phase("phase 40: generators, run_steps, py_reader, the fused "
           "sequences and the fault cases, card against CPU")
    paths["generate_reference"] = generate_reference_check(ptt, kernels)
    torch.cuda.empty_cache()

    _phase("phase 41: the analyzers, the memory planner, the cost model, "
           "the census, the profiler and the flight recorder on phase 7's "
           "LM")
    paths["analysis_plan_profile"] = analyze_plan_profile(ptt, kernels)
    torch.cuda.empty_cache()

    _phase("phase 42: data- and tensor-parallel training of phase 7's LM "
           "over NCCL (AllReduce, ZeRO-1, ReduceScatter int8, tp), and the "
           "ring schedule over K1-K3")
    paths["parallel"] = parallel_train_and_ring(ptt, kernels)
    torch.cuda.empty_cache()

    _phase("phase 43: pipeline-parallel training of phase 7's LM (the "
           "one-process engine at K 2 and 4, a world over the cards, the "
           "refusal on one) and the auto-parallel planner")
    paths["pipeline"] = pipeline_train_and_plan(ptt, kernels)
    torch.cuda.empty_cache()

    _phase("phase 44: elastic training of phase 7's LM (async and "
           "blocking snapshots, restores, supervised crashes, a changed "
           "world)")
    paths["elastic"] = elastic_train(ptt, kernels)
    torch.cuda.empty_cache()

    _phase("phase 45: ParallelExecutor on phase 7's LM: the optimizer "
           "state offloaded to pinned host memory, the memory plan on the "
           "rewritten program, sequence parallelism over the ring")
    paths["offload_plan_sp"] = offload_plan_sequence(ptt, kernels)
    torch.cuda.empty_cache()

    _phase("phase 46: export and native runs (torch.export archives, "
           "ExportedPredictor, ptpu_predict one-shot and --serve, "
           "ptpu_train)")
    # phase 48's drills run beside phase 46 (phase 47 runs alone: cuDNN's
    # autotuning picks its convolutions by their times)
    early["drills"] = start_drills(tools_tmp)
    paths["export_native"] = export_native(ptt, kernels, lm_params,
                                           tr_params, nmt_params,
                                           started=exports)
    for job in early["drills"].values():
        job.join()
    torch.cuda.empty_cache()

    _phase("phase 47: the transpilers (BN folding on ResNet-50, QAT and "
           "the freeze, the pserver programs), RecordIO and the channels "
           "feeding the LM")
    paths["transpile_recordio"] = transpile_and_recordio(ptt, kernels,
                                                         resnet_params)
    torch.cuda.empty_cache()

    _phase("phase 48: the command-line tools and the examples as a user "
           "runs them (lint_program, recovery_smoke, demo_trainer, the "
           "three examples, trace_merge, print_signatures)")
    paths["tools_examples"] = tools_and_examples(ptt, kernels, smi,
                                                 early=early, tmp=tools_tmp)
    _phase(None)

    # each kernel's launches on its own path: decode attention on the
    # serving run (phase 4; its NMT run beside it), the flash kernels on
    # the LM training run (phase 7), the LSTM kernel on the stacked LSTM's
    # (phase 11), the GRU kernel on the NMT model's (phase 12)
    launches = {"decode_attention": serve_launches["decode_attention"],
                **{k: train_launches[k] for k in FLASH},
                "lstm_seq": lstm_launches["lstm_seq"],
                "gru_seq": nmt_launches["gru_seq"]}
    results["decode_attention"]["launches_nmt"] = \
        nmt_launches["decode_attention"]
    # the verify window's launches on the speculative path (phase 27,
    # both engines); the int8 route's in phase 3's checks
    results["decode_attention"]["launches_multi"] = sum(
        paths["spec_serve"][e]["launches_multi"] for e in ("slot", "paged"))
    # decode attention on the server, two-tier and sanitized/traced paths
    # (phases 29-31), each counted from zero around its run
    results["decode_attention"]["launches_server"] = \
        paths["server"]["launches"]
    results["decode_attention"]["launches_two_tier"] = \
        paths["two_tier"]["two_tier"]["launches"]
    results["decode_attention"]["launches_sanitized"] = \
        paths["sanitize_trace"]["sanitizer"]["launches"]
    results["decode_attention"]["launches_traced"] = \
        paths["sanitize_trace"]["tracing"]["launches"]
    launches["decode_attention_multi"] = \
        results["decode_attention"]["launches_multi"]
    launches["decode_attention_int8"] = \
        results["decode_attention"]["launches_int8"]
    for k, tc in zip(FLASH, FLASH_TC):
        results[k]["launches_tc_bf16"] = train_launches[tc]
        # phase 23: a step's launches under remat (K1 runs again in the
        # backward's recompute)
        results[k]["launches_per_step_remat"] = {
            lv: paths["lm_remat_train"][lv]["launches_per_step"][tc]
            for lv in ("plain", "level0", "level1")}
    for k, n in launches.items():
        assert n > 0, f"kernel {k} was never launched on its path"
    for k in ("server", "two_tier", "sanitized", "traced"):
        assert results["decode_attention"][f"launches_{k}"] > 0, \
            f"decode_attention was never launched on the {k} path"
    # the beam decode's K4 (G = K rows) and K6 (phase 32), the
    # BiLSTM-CRF's K5 in both directions (phase 33), each counted from
    # zero around its run
    beam_launches = paths["nmt_beam_translate"]["launches"]
    results["decode_attention"]["launches_beam"] = \
        beam_launches["decode_attention"]
    results["gru_seq"]["launches_infer"] = beam_launches["gru_seq"]
    results["lstm_seq"]["launches_crf"] = \
        paths["bilstm_crf"]["launches"]["lstm_seq"]
    # the CRNN's K6, forward and reversed (phase 36)
    results["gru_seq"]["launches_crnn"] = \
        paths["crnn_train"]["launches"]["gru_seq"]
    for kern, k in (("decode_attention", "launches_beam"),
                    ("gru_seq", "launches_infer"),
                    ("lstm_seq", "launches_crf"),
                    ("gru_seq", "launches_crnn")):
        assert results[kern][k] > 0, \
            f"{kern} was never launched on its {k[9:]} path"
    # phase 41: K1-K3 over the four variants' turns
    for k in FLASH + FLASH_TC:
        results[k.replace("_tc", "") if k in FLASH_TC else k][
            f"launches_phase41{'_tc' if k in FLASH_TC else ''}"] = \
            paths["analysis_plan_profile"]["plan"]["launches"][k]
    results["flash_fwd"]["launches_tc_transformer_base_infer"] = \
        paths["transformer_base_infer"]["flash_fwd_tc_launches"]
    # phase 42: K1-K3 on each parallel mode's 3 steps (rank 0), and the
    # ring's K1 launches (its causal forward at the LM shape: 10)
    for mode in ("allreduce", "reduce_zero1", "reduce_scatter_int8_ef",
                 "tp"):
        for k in FLASH:
            results[k][f"launches_phase42_{mode}"] = \
                paths["parallel"]["ranks"][0][mode]["launches"][k]
    results["flash_fwd"]["launches_phase42_ring"] = \
        paths["parallel"]["ring"]["lm"]["k1_launches"]
    # phase 43: K1-K3 a step of each pipelined run (one process, float32:
    # K1 twice a layer a microbatch, the backward's recompute included)
    for label, run in paths["pipeline"]["one_card"].items():
        for k in FLASH:
            results[k][f"launches_per_step_phase43_{label}"] = \
                run["launches_per_step"][k]
            assert run["launches_per_step"][k] > 0, \
                f"{k} was never launched on phase 43's {label} path"
    # phase 44: K1-K3 a step of each mode's uninterrupted run (its
    # snapshots and restores launch none: every run and restored run
    # launches these, step by step, or phase 44 failed)
    for label, _, _ in ELASTIC_MODES:
        run = paths["elastic"]["one_card"][label]
        for k in FLASH:
            results[k][f"launches_per_step_phase44_{label}"] = \
                run["launches_per_step"][0][k]
            assert run["launches_per_step"][0][k] > 0, \
                f"{k} was never launched on phase 44's {label} path"
    # phase 45: K1-K3 a step of (a)'s two runs, (b)'s planned run and
    # (c)'s sequence-parallel runs (rank 0: its causal ring's live blocks)
    p45 = paths["offload_plan_sp"]["ranks"][0]
    p45_runs = {**p45["offload"], "planned": p45["plan"],
                **{f"sp_{k}": v for k, v in p45["sp"].items()}}
    for label, run in p45_runs.items():
        if not isinstance(run, dict) or "launches" not in run:
            continue
        for k in FLASH:
            results[k][f"launches_per_step_phase45_{label}"] = \
                run["launches"][0][k]
            assert run["launches"][0][k] > 0, \
                f"{k} was never launched on phase 45's {label} path"
    # generation (phases 38-39): K4 in every decode step of both
    # generators, K1 in the encoder-decoder's encoder
    results["decode_attention"]["launches_generate"] = \
        paths["lm_generate"]["launches"]["decode_attention"]
    results["decode_attention"]["launches_generate_nmt"] = \
        paths["nmt_generate"]["launches"]["decode_attention"]
    results["flash_fwd"]["launches_generate"] = \
        paths["nmt_generate"]["launches"]["flash_fwd"]
    for kern, k in (("decode_attention", "launches_generate"),
                    ("decode_attention", "launches_generate_nmt"),
                    ("flash_fwd", "launches_generate")):
        assert results[kern][k] > 0, \
            f"{kern} was never launched on its {k[9:]} path"
    # phase 46: each kernel's launches inside the native processes
    p46 = paths["export_native"]
    native_runs = [p46[c]["launches_native"] for c in (
        "lm_generate", "nmt_generate", "stacked_lstm",
        "nmt_beam_translate")] + [p46["train"]["launches_native"]]
    for k in results:
        results[k]["launches_native"] = sum(r.get(k, 0) for r in native_runs)
        assert results[k]["launches_native"] > 0, \
            f"{k} was never launched in a native process (phase 46)"
    # phase 47: K1-K3 over the QAT run's steps, the RecordIO-fed steps and
    # the pserver check's trainer steps
    p47 = paths["transpile_recordio"]
    for part, key in (("qat", "qat"), ("recordio", "recordio"),
                      ("pserver", "pserver")):
        for k in FLASH:
            results[k][f"launches_phase47_{key}"] = p47[part]["launches"][k]
            assert results[k][f"launches_phase47_{key}"] > 0, \
                f"{k} was never launched on phase 47's {key} path"
    # phase 48: K1-K3 over demo_trainer's steps on phase 7's LM (counted
    # in this process), K1-K3 and K4 in generate_text's process
    p48 = paths["tools_examples"]
    gen48 = p48["examples"]["generate_text"]["launches"]
    for k in FLASH:
        results[k]["launches_phase48_demo_trainer"] = p48["demo"]["launches"][k]
        results[k]["launches_phase48_generate_text"] = gen48[k]
    results["decode_attention"]["launches_phase48_generate_text"] = \
        gen48["decode_attention"]
    for k in FLASH + ("decode_attention",):
        for key in ("launches_phase48_demo_trainer",
                    "launches_phase48_generate_text"):
            assert results[k].get(key, 1) > 0, \
                f"{k} was never launched on phase 48's {key[17:]} path"
    del launches["decode_attention_multi"], launches["decode_attention_int8"]
    line = {"kernels": [dict(name=k, **_KERNEL_META[k],
                             launches=launches[k], **results[k])
                        for k in results],
            "paths": paths}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        _stop_children()
