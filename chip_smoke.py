#!/usr/bin/env python3
"""On-card smoke test of paddle_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
 1. device   the card's name and power limit (nvidia-smi), torch and CUDA
             versions;
 2. build    every CUDA source of the port with nvcc (sm_90a), timed; the
             registers, spill stores and shared memory of every kernel
             instance;
 3. kernels  the paged kernel K4 against its plain PyTorch version on the
             card, float32 and bf16, head_dim 64 and 128, decode and verify
             spans of 4, 5 and 8 rows, over ragged live lengths, lengths on
             the edges of its split chunk and (spans of 5 and 8) lengths
             past the table's last row, as a verify span at the cache
             ceiling passes them, held elementwise to the stated tolerance
             and, per (slot, head), relative to the plain version computed
             in float32; then at two decode shapes (8 slots x 1024 live
             rows, 2 slots x 2048) and one verify shape (8 slots x 5 rows
             x 1024) launched twice for bitwise-equal outputs, and the
             kernel (with L2 cold), its plain version and one library call
             timed with CUDA events, beside the least time the card could
             take; per shard: K4 on each rank's contiguous 16 of the
             serving case's 32 heads (phase 13's instance) bitwise equal
             to the 32-head kernel's output on those heads, and timed;
 4. serving  gpt3-1.3B in bf16 (full width and depth, random weights from a
             seed) behind GenerationServer answers 16 requests; the decode
             step is captured once into a CUDA graph and replayed: one
             capture, more steady steps than rebuilds, no demotion, the
             paged kernel launched once per layer per step (counted on the
             card by the kernel itself, per instance, over the timed
             window; the replay count in Python agrees; torch.profiler
             over steady replays sees the kernels inside the graph) and
             the plain version never;
 4c. swap    the same mix on a fresh server (seed-0 weights, driven step by
             step on this thread) with a swap to seed-1 weights, given as a
             reference-layout numpy state, landing mid-decode: every
             request finishes, one swap and no failure is counted, the
             decode graph is not recaptured, the card counts n_layer K4
             launches per decode step of the window, and afterwards 8
             greedy requests equal a fresh server's on the new weights
             token for token; then a swap of a truncated state is refused
             and the tokens do not change. The swap's staging and copy,
             and the decode step before and after it, are reported;
 4d. retry   a fault injected after a step's graph replay (the device
             cursors advanced, the host's view not) is retried once on a
             recaptured graph: one retry, one re-prime, one capture, and
             the greedy tokens of an unfaulted run; two faults in a row
             fail the batch through the server's worker loop;
 4e. handoff disaggregated serving (gpt3-1.3B bf16, full width and
             depth, seed-0 weights): engine A (rng_seed 7) prefills phase
             4's 16 requests and exports each; engine B's scheduler
             (rng_seed 99: the exported key must rule) adopts the
             payloads and decodes; B's tokens equal a monolithic engine
             M's (rng_seed 7) bitwise, greedy and sampled; B runs no
             prefill, counts 16 imports and n_layer K4 launches per decode
             step (on the card), both pools audit clean and B's prefix
             cache holds the adopted prompts' full blocks. Export and
             import time per request against the payload's bytes, B's p50
             TTFT and decode step are reported. Then a spec engine
             (float32, 2 layers, twin drafter) adopts a handoff with plain
             decode's tokens, and the staleness cases: a re-prime on the
             decode side alone is adopted; a swap between export and
             import is refused and prefilled again, with a fresh engine's
             tokens on the new weights; a re-prime on the prefill side
             then a swap on the decode side is refused;
 4f. prefill graphs  one prompt per bucket (16..2048) on a fresh engine:
             one graph captured per bucket, the replay's first token and
             K/V rows bitwise equal to the same body called directly on
             the same buffers, both timed (host and device), the graphs'
             shared pool measured; phase 4 has checked that its prefills
             captured one graph per bucket they used, all at warm-up;
 4g. observability  4e's mix again with tracing on: every request's
             trace holds queue_wait, prefill, kv_export, kv_import,
             kv_adopt and decode; a chrome trace loads back; the ttft and
             inter_token histogram p50s lie within one bucket of the
             measured p50s; the decode step with tracing on and off. Then
             the fault points (testing.faults): page_pool_exhausted keeps
             requests queued and changes no token; decode_error is retried
             once; kill_during_swap leaves the old weights serving;
             replica_kill fails the batch through the server's loop, which
             dumps the flight recorder; draft_garbage (float32, 2 layers)
             changes no spec token; an engine captured with
             kernel_mismatch armed gives K4 output phase 3's parity check
             rejects (and passes with it off). Every fault is disarmed in
             a finally;
 5. parity   the same request through a kernel engine and a plain engine
             on the card (gpt3-1.3B width, 2 layers, float32), both
             replaying their graphs: decode logits within tolerance,
             greedy tokens equal; then speculative engines (K=4) with a
             twin drafter (every draft accepted) and an independent
             1-layer drafter: tokens equal to plain decode's, greedy and
             sampled;
 5b. spec    speculative serving at full width: gpt3-1.3B bf16 verified,
             gpt2-small bf16 drafting (seed 2), K=4, the same 16 requests;
             every request finishes, both pools audit clean, and each
             round launches the paged kernel n_layer times at a span of 5
             rows (verify) and (K+1) x 12 times at 1 row (draft round), by
             the card's count per instance and by torch.profiler; the
             share of greedy requests and tokens equal to phase 4's plain
             decode is reported (bf16: not asserted); the drafter's
             prompt ingestion replays one graph per bucket, each captured
             once at warm-up, and each replay's drafter K/V rows equal
             its body's called directly, bitwise;
 5c. spec swap  a speculative engine's target and drafter swapped together
             mid-stream: in float32 at 2 layers the tokens equal plain
             decode's under the same swap, with two weight generations of
             acceptance; at full width in bf16 (gpt2-small drafting) the
             match is reported;
 6. kernels (training)  the flash-attention kernels K1-K3 against their
             plain versions over float32 and bf16, causal and not, head_dim
             64/96/128/256 and seq_len 128/256/2048, on strided unbind views
             as the model hands them over, and at the training step's shape
             (batch 4 x 32 heads, seq_len 2048, head_dim 64, bf16, causal);
             every output held elementwise and, block by block, relative to
             the plain version's norm; each launched twice on the same
             inputs (REPEAT_CASES: bf16 causal at the step's shape and at
             H=128, T=2048; float32 non-causal at phase 14's shape and at
             H=128, causal at T=2048), the outputs bitwise equal (K1, K2
             and K3); then each timed at the
             step's shape beside its plain version, one library call and
             its bound; and the encoder path's non-causal instances
             (bf16 at 16 x 12 heads x 512, float32 at 16 x 12 x 128, head
             dim 64) held to their plain versions and timed the same way,
             SDPA with is_causal=False beside them;
 7. training gpt3-1.3B in bf16 (full width and depth, random weights from
             a seed) trains through TrainStep + AdamW with master weights,
             batch 4 x 2048, on one batch: 3 steps of the same step_fn in
             a plain eager loop, then TrainStep's one CUDA graph (eager
             call, capture and replay, replay) and 5 timed replays; the
             loss must be finite and falling, one capture, every replay
             must launch K1, K2 and K3 once per layer on the card's count
             and the plain attention never, and a steady step no kernel
             from the host (torch.profiler); graph and eager step time,
             MFU and peak memory are reported;
 7b. train -> serve  the trained model saved as a checkpoint (model state,
             float32 on disk, into a temporary directory that is removed
             after); a running server on the seed-0 weights, answering a
             stream of requests, follows the directory and swaps it in
             with no failed request and no recapture; its greedy tokens
             then equal a fresh server's on the trained model. The save,
             its bytes, the follower's load and swap and the swap's stall
             are reported. Then the whole training state (2 layers, full
             width: model, AdamW moments and master weights, step count,
             cosine LR) through a checkpoint into a fresh model and
             optimizer: 2 more steps equal the uninterrupted run's,
             bitwise;
 8. training parity  one model through the kernel route and the plain
             route on the card (gpt3-1.3B width, 2 layers): in float32 at
             seq_len 256, loss and every gradient of one step, and the
             parameters after 3 AdamW steps, within tolerance; in bf16 (the
             kernels' tensor-core branch) at seq_len 2048, loss and every
             gradient of one step within a bound relative to the plain
             route's.
 9. moe serving  gpt3-1.3B bf16 at full width and depth as a Mixture of
             Experts (MOE: 8 experts, top-2, capacity factor 1.25, in
             every other block; 4.14 B parameters, seed 0) through phase
             4's server, mix and checks: one decode capture, K4 launched
             decode steps x 24 times on the card's count, no kernel
             launched from the host in a steady step, one prefill capture
             per bucket used, all at warm-up; phase 4f's check of every
             bucket (replay equal to its direct body, bitwise); the decode
             graph's tokens equal to the eager body's (8 slots); the drop
             fraction by moe.metrics.publish after one eager forward of 8
             prompts of 512 tokens; peak memory;
 9b. moe spec  phase 5b on the MoE target (gpt2-small drafting, K=4),
             drafter buckets included; then phase 5 on the MoE layout in
             float32 at 2 layers and full width, with random and with
             zeroed gate weights: K4 against its plain route (decode
             logits, greedy tokens), and spec tokens equal plain decode's
             with a twin and an independent drafter, greedy and sampled
             (a zeroed gate crowds every row onto two experts; the verify
             routes each row alone, as decode does);
 9c. moe training  the MoE layout at full width and 4 layers (2 MoE),
             bf16, TrainStep + AdamW with master weights, batch 4 x 2048,
             loss + moe_aux_loss(), 3 steps on one batch: both finite,
             the loss falling, K1-K3 launched once per layer per step;
             the autograd engine's AccumulateGrad stream warnings per
             call (and with the MoE aux loss dropped after the warm-up)
             and the host's waits over two replays are reported;
 9d. older cache forms  gpt3-1.3B width, 2 layers, float32: greedy tokens
             through the slot cache and through one-row concat decoding
             equal the paged engine's.
10. recompute  phase 7's step (full width and depth, bf16, batch 4 x 2048)
             under each policy of bench.py's ladder (none, full, dots,
             attn, dots_attn) through TrainStep's graph: the loss finite
             and falling, one capture, per step on the card's count K1
             48 times under full and dots and 24 under the rest, K2 and K3
             24; full recompute's peak memory below none's; step time, MFU
             and peak memory per policy. Then at 2 layers in float32 each
             policy's loss and gradients against none's, within 1e-5 and
             reported bitwise or not;
10b. recipe  the GPT-3 recipe (AdamW with master weights and decay off
             biases and LayerNorms, linear warm-up into cosine stepped
             between calls, global-norm clip 1.0) at full width, 2 layers,
             bf16: 4 graph steps equal the eager loop's bitwise (losses,
             parameters, slots); with attention dropout 0.1 each replay
             keeps 90% within 0.01, scales exactly and draws new masks;
             every other optimizer, regularizer and clip on a small MLP:
             captured steps equal eager ones bitwise;
10c. recapture  mutate_signature (mode=aval) armed: one capture more and
             the same losses; a restore that rebinds the parameters'
             storage: the next call captures again and the run continues
             bitwise as it did from the snapshot.
11. fit      hapi.Model(GPTForPretraining).prepare(AdamW,
             GPTPretrainingCriterion, amp_configs="O1").fit(DataLoader(...,
             shuffle=True, num_workers=2)) at gpt3-1.3B, full width and
             depth, float32 parameters: 8 batches of 4 x 2048 over 8
             sequences each seen 4 times, through the shm ring. One
             TrainStep capture; K1-K3 8 x 24 each on the card's count, all
             on the bf16 instance; the loss finite and falling; no worker
             initialised CUDA. Reports the p50 host time of a batch beside
             phase 7's step, tokens/s, MFU, peak memory, dataloader.wait,
             worker_busy and the workers' start;
11b. resume  full width, 2 layers, O1: fit(epochs=2) against fit(epochs=1)
             then a fresh fit(epochs=2, resume=True): the second epoch's
             losses, parameters and optimizer slots bitwise equal;
             max_ckpt_to_keep=1 keeps one epoch; a torn .pdparams is
             skipped; nan_loss:step=3 gives a NaN loss there and training
             goes on;
11c. fp16    full width, 2 layers: 4 eager steps under
             auto_cast(dtype="float16") with GradScaler: finite losses, the
             attention on the plain route with a kernel_fallback record
             naming float16 and K1 not launched; a step with an inf
             gradient leaves the parameters bitwise and halves the scale;
             scaler.step inside TrainStep is refused before any capture.
12. distributed  two ranks, children of this script, on cuda:0 with gloo
             carrying CUDA tensors (the card machine has one card, and two
             NCCL ranks cannot share it): fleet.init(mp_degree=2), phase
             7's model (gpt3-1.3B bf16, full width and depth, seed 0)
             through fleet.distributed_model, its AdamW with master weights
             and its batch: the first-step logits (each rank's vocabulary
             block) within MP_LOGITS_TOL of phase 7's model's, built whole
             in the rank from the same seed, where the same model with q,
             k and v split as one contiguous block (the control) must miss
             them by more; 3 eager steps: the losses within MP_LOSS_TOL of
             phase 7's first three, K1-K3 launched 3 x 24 times on each
             rank's card count at 16 heads a rank, TrainStep refusing to
             capture over the gloo group; step time, bytes all-reduced per
             step and per-rank peak memory reported;
12b.         the same world at dp = 2 and at mp = 2, gpt3-1.3B width at 2
             layers in float32, SGD: the parameters after 3 steps (merged
             back over mp) within SMALL_PARAM_TOL of a single-process run;
             the dp = 2 state saved as a sharded checkpoint at world 2 and
             read back whole by this process;
12c.         init_parallel_env() alone at world 1 in a child process picks
             NCCL and runs one all_reduce and one barrier.
13. mesh serving  phase 12's world: gpt3-1.3B bf16 (full width and depth,
             seed 0) behind GenerationServer(mesh=serving_mesh(2),
             max_batch_size=8) with phase 4's base key; rank 0 serves
             phase 4's 16 requests, rank 1 follows. Both ranks emit the
             same tokens; K4 launched decode steps x 24 times at its
             16-head instance on each rank's card count; the decode
             bodies uncaptured (gloo) and said so; every pool
             [None, None, "mp"] at 16 heads a rank; every request's
             first-token logits within MP_LOGITS_TOL of phase 4's, and a
             request whose tokens differ from phase 4's differs first
             where the single card's sampler had a near-tie (its top two
             scores within 2 x MP_LOGITS_TOL in logit units); the bytes
             all-reduced and gathered per decode step and rank within 1%
             of the prediction from the shapes; p50 decode step (host
             clock) and per-rank peak memory reported;
13b.         the same world, gpt3-1.3B width at 2 layers in float32 (TF32
             off) at mp = 2: plain decode and spec decode (a gpt2-small
             drafter at 2 layers, K = 4, mp-sharded) token-bitwise equal
             to a single-card engine's; a whole seed-1 state swapped in
             mid-flight, no request failed, tokens equal to a single-card
             engine swapped at the same step; a single-card prefill's
             export imported, continuing token for token.
14. bert     bert-base pretraining as tools/model_bench.py:73-107 runs it
             (BertForPretraining, BertPretrainingCriterion(30522),
             AdamW(1e-4), dropout 0.1, one batch of 16 x 128 random ids
             that are the MLM labels too, no padding mask), float32,
             through TrainStep's CUDA graph, 10 steps: the loss finite and
             falling, one capture, K1, K2 and K3 launched 12 times a step
             on the card's count, all on the float32 instance and
             non-causal, no plain attention; p50 step, tokens/s, MFU
             (against 67 TFLOP/s float32) and peak memory. Run after 11c
             and before the distributed phases, on the one card;
14b.         the same in bf16 (bf16 parameters, float32 master weights) at
             16 x 512, the preset's full 512 positions: the Hopper
             instances of K1-K3, non-causal;
14c. bert parity  bert-base width at 2 layers, dropout 0, float32 and
             bf16: the kernel route against the plain route (MLM logits,
             loss, every gradient) within FLASH_PARITY_TOL; a padded batch
             takes the plain route with a kernel_fallback per layer naming
             the mask and no K1-K3 launch on the card;
             memory_efficient_attention with no bias, LowerTriangularMask
             and a tensor bias against its plain version, and a
             FusedTransformerEncoderLayer forward and backward against its
             plain route;
14d. ernie   ErnieForSequenceClassification(ernie_3p0_medium(), 3) in eval
             mode, bf16, 16 x 128: 6 K1 launches a forward and no K2 or
             K3 on the card's count, the logits within FLASH_PARITY_TOL of
             the plain route's; p50 forward and samples/s.
15. resnet   BASELINE config 1 (tools/model_bench.py:43-70): resnet50()
             (1000 classes, 25.6 M parameters, float32, seed-0 weights),
             32 x 3 x 224 x 224 synthetic images from a seeded generator,
             labels in [0, 10), cross_entropy and Momentum(0.1) through
             TrainStep's CUDA graph, 10 steps: losses finite, one capture,
             0 kernels launched from the host a step (torch.profiler);
             p50 step (host clock, synchronised), images/s, MFU (conv and
             FC multiply-adds counted from the model's shapes, 3 forwards
             a step, against 67 TFLOP/s float32 FMA), device time a step,
             peak memory; then the same step under auto_cast O1 (conv in
             bf16, batch norm in float32): images/s, peak memory;
15b. resnet parity  resnet18(num_classes=10) at 4 x 3 x 32 x 32 (the
             benchmark's tiny scale) under cudnn.deterministic: 3 steps
             through the graph against 3 eager steps of a twin (losses,
             parameters, running statistics within RESNET_GRAPH_TOL); the
             card's float32 forward, loss and gradients at step 0 against
             the port's CPU float64 run of the same weights
             (RESNET_CPU_TOL, gradients relative in norm).
16. ernie static  BASELINE config 5 (tools/model_bench.py:166-202):
             ErnieForSequenceClassification(ErnieModel(ErnieConfig()), 3)
             (bert-base widths, float32, seed-0 weights, eval) recorded by
             build_static_inference_program from static.data
             ("input_ids", [None, 128], "int64") under program_guard and
             run by static.Executor at 16 x 128 as one CUDA graph: p50 run
             (host clock, numpy feed and fetch included), samples/s,
             device time and the host's CUDA calls a run (torch.profiler:
             one graph launch, the feed, output and fetch copies, 0
             kernels), 12 K1 launches a run on the card's count, 1
             capture; the logits
             against the module's eager forward and the plain route
             (FLASH_PARITY_TOL); a batch-4 feed captures a second graph and
             gives batch 16's first rows; the eager forward's p50 beside;
16a.         save_inference_model of phase 16's Program (torch.export,
             dynamic batch) served by create_predictor at batch 16 and 4
             from the one artifact (12 K1 launches a run); jit.save /
             jit.load of the classifier against both;
16b.         the classifier (dropout 0) recorded with static.data ids and
             labels, cross_entropy and AdamW(1e-4).minimize: 5 Executor
             runs at 16 x 128 through one graph, K1, K2 and K3 12 times a
             run, 0 kernels from the host on a replay; losses against
             TrainStep's from the same weights (STATIC_TRAIN_TOL); then
             static.save, load_program and one more run, bitwise the
             original's next run;
16c.         a static.nn.cond / while_loop Program on the card: its values
             and its route (uncaptured, with the reason).
17. lstm lm  the "large" PTB model of Zaremba et al. (arXiv:1409.2329
             section 4, LSTM_LM): Embedding(10000, 1500), a 2-layer LSTM
             of 1500 units with dropout 0.65, Linear(1500, 10000), float32,
             SGD(1.0) with a global-norm clip of 10, batch 20 x 35 seeded
             ids, 10 steps through TrainStep's graph: losses finite, one
             capture, 0 kernels launched from the host a step
             (torch.profiler: the dropout key is a counter on the card);
             p50 step, tokens/s, device time, peak memory; 3 graph steps
             against an eager twin's; the step's loss and gradients at
             batch 2 x 5 against the port's CPU float64 run; the LSTM
             forward at the step's shape against cuDNN's torch.nn.LSTM
             holding the same weights (max error, both device times: a
             yardstick only, not on the path);
17a. gru, rnnt, functional  a 3-layer bidirectional GRU 1024 wide over
             16 padded sequences of 100-400 frames with sequence_length,
             forward and backward (zeros past each length; against CPU
             float64 at its 2 shortest sequences); rnnt_loss at B 8, T 250, U 50, V
             1024 forward and backward (timed; against CPU float64 at B 2,
             T 40); each functional name of the slice on the card against
             the CPU at the shape of a named model's layer
             (functional_cases); F.scaled_dot_product_attention at bert-base's
             float32 16 x 128 x 12 x 64 launching K1 once a call and
             F.paged_attention(kernel="pallas") at phase 3's decode case
             launching K4 once a call (the card's counts), each bitwise
             equal to ops.flash_attention / ops.paged_attention;
18. yolov3   YOLOv3-608's three heads at batch 8 (255 channels at 19, 38
             and 76 squared, the paper's nine anchors, seeded values):
             yolo_box, the top 1000 (box, class) pairs above 0.01,
             category-aware nms at 0.45, 100 kept per image (timed, peak
             memory), each image's picks equal to the port's CPU nms on
             the card's boxes; yolo_loss over the three heads with 50
             ground-truth boxes an image, forward and backward (timed,
             peak memory, its loss and input gradients against the
             CPU's float64);
18a. detection heads  (DETECT) generate_proposals of the R50-C4 RPN (pre
             6000, post 1000, NMS 0.7) and roi_align 14 x 14 (scale 1/16,
             adaptive sampling, aligned) over its RoIs on a 1024-channel
             map; roi_pool at Fast R-CNN's conv5; psroi_pool at R-FCN's
             3969 channels; distribute_fpn_proposals on 2000 RoIs; DCNv2's
             deform_conv2d forward and backward; SSD300's prior_box and
             box_coder decode (8732 priors). Each timed, its peak memory
             above its inputs held within DETECTION_MEM_CAP beyond its
             outputs, and checked against the port's CPU run of the same
             inputs (float64 for the smooth ops; exactly for indices,
             counts and roi_pool's maxima, against its float32 run).
19. elastic training  tools/elastic_gpt_trainer.py under python -m
             paddle_tpu_torch.distributed.launch --elastic --nproc_per_node
             2: two ranks on cuda:0, each with gpt3-1.3B at full width and 2
             layers, bf16, AdamW(multi_precision=True), batch 2 a rank x
             2048, CheckpointHook(elastic=ElasticTrainContext, shard=True,
             reshard=True). Two kinds of world: data parallel (--dp: each
             rank calls init_parallel_env(backend="gloo") on the launcher's
             PADDLE_COORDINATOR, wraps the model in DataParallel and runs
             an eager step on a batch of its own, the gradients averaged
             over gloo), and replicas (the same batch on every rank through
             TrainStep's graph, which captures no gloo collective, in step
             through the fenced store barrier). First 19a-19b, data
             parallel, alone on the card (saves at steps 3 and 7 of 11);
             then side by side the uninterrupted data-parallel run (the
             ranks' losses differ and their states after every step agree:
             the gradients were exchanged), 19c and 19d;
19a.         kill_at_step on rank 1 at step 5: the launcher restarts it on a
             fresh PADDLE_COORDINATOR; rank 0's next collective fails, it
             restores checkpoint 3 in place and forms the world again on
             that coordinator: every loss and every state after a step
             bitwise the uninterrupted run's at its rank and step;
19b.         rank 1 killed again at step 9 with its budget spent: the
             launcher shrinks the world to one (world epoch 1) on a third
             coordinator, whose rank resumes through load_resharded at step
             8 (checkpoint 7, no step lost or repeated): its losses and
             states bitwise a one-rank run resumed here from checkpoint 7;
             this process, holding the old world's epoch, tries a save on
             the live store and is fenced, the checkpoint directory
             unchanged;
19c.         the replicas: rank 1 killed at step 3 is restarted and rank 0
             restores checkpoint 2 in place (its graph kept: one capture a
             process); then rank_preempt on rank 0 at step 4: both ranks'
             emergency manifests at step 5 name preempt_target 5,
             coordinated 2; every loss bitwise a TrainStep run here;
19d.         the replicas: step_hang on rank 1 at step 4 with a 10 s
             watchdog (it times a rank's steps, not its wait for peers; no
             checkpoint, as a save takes longer than the deadline): it
             exits 98 with its thread stacks in its worker log, the
             launcher respawns it, rank 0 (nothing to go back to) restarts
             afresh too, and the run ends at step 6, every loss the
             TrainStep run's.
             Every leg: captures (at most 1 a process), K1-K3 launched on
             the card by every process that finished, the kill-to-first-
             step times, a process start's phases, the save and restore
             times and the fault counters;
20. supervised serving  ReplicaSupervisor over 2 replicas of gpt3-1.3B
             bf16 (full width and depth) sharing one model, rng_seed 7:
             16 requests (prompts of 16-256 tokens, 32 new; 12 greedy, 4
             at temperature 0.8) and then 8 more, undisturbed and then
             with replica_kill armed in the first 16: every request's
             tokens bitwise the undisturbed run's, one restart, the
             respawn's decode graph captured once (in the second wave,
             while its sibling replays), K4 launched on the card by each
             replica, allocated memory after the respawn
             within one engine's pools of before the kill, the time from
             the kill to a replayed request's first token;
20a.         the autoscaler at 2 layers: one replica to two under a burst
             of 24 queued requests, back to one when idle;
21. pipeline phase 12's two-rank world at pp = 2: phase 7's model
             (gpt3-1.3B bf16, full width and depth, 12 blocks a stage,
             the others freed), AdamW with master weights, phase 7's
             batch in 4 microbatches, 3 GPipe steps through
             hapi.Model.train_batch (which builds a PipelineSpmdStep):
             losses within MP_LOSS_TOL of phase 7's, K1-K3 launched
             3 x 4 x 12 times on each rank's card, the bytes sent across
             the boundary a step (both ranks) equal to 2 x M x mb x T x
             d_model x 2, the tied word embedding bitwise equal on both
             ranks;
21a. 1f1b    the same through fleet.HybridParallelEngine's 1F1B schedule:
             the same checks, against phase 7's and 21's losses, at most
             2pp - 1 microbatches in flight on a stage, each rank's peak
             memory beside 21's;
21b. zero    gpt3-1.3B width at 4 layers, batch 4 x 2048 split over
             sharding = 2: 3 steps at each group_sharded_parallel level
             (os, os_g, p_g_os) and one of os_g with offload, within
             MP_LOSS_TOL of an unsharded dp = 2 run in the same world; the
             bytes each rank holds, counted from its tensors: optimizer
             state halved (none on the card with offload), gradients
             halved from os_g, 2-d parameters halved at p_g_os;
21c. ep      phase 9c's MoE model at ep = 2 (4 of 8 experts a rank, the
             batch split over ep), 3 steps: losses within MP_LOSS_TOL of
             an ep = 1 run of the same weights and batch in this process,
             aux losses within MOE_AUX_STEP0_REL of it (relative) at step
             0 and MOE_AUX_LATER_REL after, block 0's expert counts at
             step 0 equal to it, the all-to-all bytes a step equal to 4 x layers x E x G x
             C x H x 2, K1-K3 launched on each rank's card.

A kernel's time ("ms") is device time: calls captured in a CUDA graph
and replayed (``device_ms``), so the host's cost per call does not count;
"eager_ms" beside it is the same kernel called from Python in a loop. K4's
calls take copies of its pools in turn (``cold_copies``), so it reads them
from device memory and not from L2; "warm_ms" is K4 on one copy.

Every K4 row's "launches" is what the card counted for the row's instance
over the main path's timed window: phase 4's decode steps (bf16, Dh 64,
one row) for the decode rows, phase 5b's verifies (the 8-row instance) for
the verify row, phase 7's graph replays for K1-K3 (phases 14 and 14b's
for their non-causal float32 and bf16 rows, with phases 16-16b's static
runs and phase 17a's F.scaled_dot_product_attention calls under
"launches_by_path"; phase 17a's F.paged_attention calls under K4's decode
row's), each counted on the
card by the kernel itself; "launches_by_path" adds the MoE paths' windows
(9, 9b, 9c) and, for K1-K3, phase 11's fit (its bf16 instance), phase
10's launches per step by policy and phase 19's uninterrupted ranks;
K4's decode row adds phase 20's supervised window. The per-shard row's
are phase 13's rank 0's (the 16-head instance), with rank 1's beside
them.

Before it prints a result it stops the DataLoader's fork server, the
resource tracker and any worker still running, and fails if any other
process it started is still alive; on a failed phase it stops them too.

Prints a {"phases": {...}} line (each phase's seconds), a {"kernels":
[...]} line and the nvidia-smi line before the last line, {"ok": true, "device": {...}}. Without CUDA, or without the rest of
the repository beside it, it prints no result and exits 2.
"""
from __future__ import annotations

import copy
import ctypes
import gc
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
# H100 SXM data sheet at its 700 W limit: HBM3 bandwidth and dense peaks by
# operand type (a card set to a lower power limit runs slower under load)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the encoder path's non-causal instances at bert-base's shapes (phases
# 14 and 14b): B x 12 heads x head_dim 64, bf16 at the preset's full 512
# positions, float32 at the reference benchmark's 128
NONCAUSAL_SHAPES = {torch.bfloat16: (16, 512, 12, 64),
                    torch.float32: (16, 128, 12, 64)}
# the rate the flash kernels' operations are held to: bf16 on the tensor
# cores (dense); float32 as split TF32, three TF32 products per float32
# product on the tensor cores (dense), the least time float32-accurate work
# can take on the card. PEAK_FLOPS keeps 67 TFLOP/s for float32: phase
# 14's MFU reads it, and its GEMMs run on the FMA units (TF32 stays off).
FLASH_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
# BASELINE config 1 (tools/model_bench.py:43-70): ResNet-50 at batch 32 x
# 3 x 224 x 224, labels in [0, 10), Momentum 0.1; and its tiny scale
RESNET_FULL = dict(batch=32, side=224, num_classes=1000)
RESNET_TINY = dict(batch=4, side=32, num_classes=10)
# phase 15b: graph against eager (the same kernels, cudnn.deterministic:
# held to float32 noise); the card's float32 against the CPU's float64
# (logits and loss elementwise; gradients relative in norm per parameter:
# cuDNN sums a weight's gradient over 4 x 32 x 32 positions and more in
# float32, and the worst parameter measured 2.7e-4)
RESNET_GRAPH_TOL = 1e-5
RESNET_CPU_TOL = dict(logits=1e-4, grad_rel=1e-3)
PEAK_NAMES = {torch.bfloat16: "989 TFLOP/s bf16 tensor cores, dense",
              torch.float32: "3 TF32 products at 495 TFLOP/s, dense "
                             "(split TF32)"}
# the MoE layout of phases 9-9c: GShard's top-2 in every other FFN
# (Lepikhin et al. 2020, arXiv:2006.16668 section 2), with the reference's
# defaults for k and the capacity factor
MOE = dict(moe_num_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
           moe_every=2)
PAGED_REPLACES = "paddle_tpu/ops/pallas_ops.py:475"  # _paged_attn_kernel
PAGED_SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
FLASH_SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
# kernel -> (the TPU kernel it replaces, tensor-core products per score)
FLASH_KERNELS = {
    "flash_fwd": ("paddle_tpu/ops/pallas_ops.py:93", 2),      # K1
    "flash_bwd_dq": ("paddle_tpu/ops/pallas_ops.py:137", 3),  # K2
    "flash_bwd_dkv": ("paddle_tpu/ops/pallas_ops.py:172", 4),  # K3
}
_WMMA = ("(b) WMMA m16n16k16 (bf16) or float32 FMA through shared memory, "
         "accumulators in shared memory, 128 threads, 64-row tiles")
_TF32 = ("(c) split TF32 (x = hi + lo; lo.hi + hi.lo + hi.hi) on mma.sync "
         "m16n8k8, 128 threads of 16 rows per warp, accumulators in "
         "registers, a 2-stage cp.async ring, rows padded to H+4 floats; ")
DESIGNS = {
    "paged_attention": "split-KV (flash-decoding): grid (head, slot, split "
                       "of 256 keys), 16-byte loads double-buffered in "
                       "registers, online softmax in registers, float32 "
                       "partials per split in a workspace sized from shapes; "
                       "a combine kernel merges the splits in index order",
    "flash_fwd": "(a) bf16 at H=64/128: warp-specialised, TMA producer "
                 "(setmaxnreg 40/232) into a 3-stage (H=64) or 2-stage "
                 "(H=128) mbarrier ring of 128-key K/V tiles, two consumer "
                 "warpgroups of 64 query rows on wgmma with register "
                 "accumulators; float32 at H=64/128: " + _TF32 + "64 query "
                 "rows, Q split once into hi/lo tiles, 32-key K/V tiles, "
                 "P the register A operand of O += P V in a permuted key "
                 "order, 3 blocks per SM at H=64; float32 and bf16 at "
                 "H=96/256: " + _WMMA,
    "flash_bwd_dq": "(a) bf16 at H=64/128: warp-specialised, TMA producer "
                    "(setmaxnreg 40/232) into a 4-stage (H=64) or 3-stage "
                    "(H=128) mbarrier ring of 64-key K/V tiles, Q/dO/lse/"
                    "delta resident, two consumer warpgroups of 64 query "
                    "rows: S and dP on wgmma, dS as the register A operand "
                    "of dQ += dS K, dQ in registers; float32 at H=64/128: "
                    + _TF32 + "64 query rows, Q and dO split once into "
                    "resident hi/lo tiles (2 blocks per SM at H=64), lse "
                    "and delta in registers, 32-key K/V tiles, dS the register A operand of dQ += dS K in a "
                    "permuted key order, dQ in registers; "
                    "float32 and bf16 at H=96/256: " + _WMMA,
    "flash_bwd_dkv": "(a) bf16 at H=64/128: warp-specialised, TMA "
                     "producer (setmaxnreg 24/232) into a 3-stage mbarrier "
                     "ring of Q/dO/lse/delta tiles, 64 keys resident per "
                     "block, one consumer warpgroup on wgmma with register "
                     "accumulators, 2 blocks per SM; float32 at H=64/128: "
                     + _TF32 + "64 keys with K and V split once into "
                     "resident hi/lo tiles, 32-row Q/dO/lse/delta tiles, "
                     "P^T and dS^T the register A operands of dV += P^T dO "
                     "and dK += dS^T Q, 2 blocks per SM at H=64; float32 "
                     "and bf16 at H=96/256: " + _WMMA,
}


PHASE_SECONDS = {}


def instance_design(dtype, H):
    """The design, "a", "b" or "c" (``csrc/flash_attention.cu``'s header),
    that K1, K2 and K3 launch at ``dtype`` and head_dim ``H``."""
    if H not in (64, 128):
        return "b"
    return "a" if dtype == torch.bfloat16 else "c"


def timed(name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its seconds kept under ``name`` for the
    ``phases`` line."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_SECONDS[name] = round(time.perf_counter() - t0, 3)


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=50):
    """Mean milliseconds per call over ``iters`` calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls=20, replays=5):
    """Mean milliseconds of device time per call: ``calls`` calls captured
    in one CUDA graph and replayed ``replays`` times between CUDA events,
    so the host's cost of each call (the wrapper's checks, the ctypes call,
    the launches) does not count, as ``cuda_ms`` counts it when the host is
    slower than the card. ``fn`` is one callable, or a list of callables
    the calls take in turn (``cold_copies``). Warmed up on a side stream
    first, as capture requires."""
    fns = fn if isinstance(fn, (list, tuple)) else [fn]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns * 2:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


# H100 SXM: 50 MB of L2
L2_BYTES = 50 * 2 ** 20


def cold_copies(args, live_bytes, pools=(1, 2)):
    """Copies of ``args`` with the tensors at ``pools`` cloned, enough that
    between two uses of one copy the others touch at least twice L2's size
    of live data: calls that take them in turn read those tensors from
    device memory, as a decode step whose 24 layers each read their own
    pools does, and not from what the call before left in L2."""
    n = 1 + -(-2 * L2_BYTES // live_bytes)
    return [tuple(a.clone() if i in pools else a for i, a in enumerate(args))
            for _ in range(n)]


# --------------------------------------------------------------- kernels --
def paged_case(dev, dtype, T, seq_lens, H=32, Dh=64, bs=16, M=128, Nb=1025,
               inactive=(), share=None, seed=0):
    """Random q and pools, distinct random blocks per lane; ``inactive``
    lanes get a zeroed table row, seq_len 1 and cursor 0; ``share=(a, b,
    n)`` makes lane b's first n table entries lane a's."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    B = len(seq_lens)
    q = torch.randn(B, T, H, Dh, generator=g).to(dev, dtype)
    kp = torch.randn(Nb, bs, H, Dh, generator=g).to(dev, dtype)
    vp = torch.randn(Nb, bs, H, Dh, generator=g).to(dev, dtype)
    bt = (torch.randperm(Nb - 1, generator=g)[:B * M] + 1).view(B, M)
    sl = torch.tensor(seq_lens)
    qo = (sl - T).clamp(min=0)
    for lane in inactive:
        bt[lane] = 0
        sl[lane] = 1
        qo[lane] = 0
    if share is not None:
        a, b, n = share
        bt[b, :n] = bt[a, :n]
    return (q, kp, vp, bt.to(dev, torch.int32).contiguous(),
            sl.to(dev, torch.int32), qo.to(dev, torch.int32))


def paged_bound(q, kp, bt, sl, qo):
    """Least time (ms) for the card: each live K/V row, q, the output and
    the table entries moved once, against the data-sheet bandwidth; the
    QK and PV products against the peak for the operand type. Returns
    (ms, "bytes" | "operations")."""
    B, T, H, Dh = q.shape
    bs, es = kp.shape[1], q.element_size()
    live = torch.minimum(qo.long() + T, sl.long()).cpu()
    rows = int(live.sum())
    nbytes = (rows * H * Dh * 2 * es + 2 * q.numel() * es
              + int(((live + bs - 1) // bs).sum()) * 4 + 2 * B * 4)
    ops = 4 * rows * T * H * Dh
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(got, want, tol, what):
    atol, rtol = tol
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements outside atol={atol} "
            f"rtol={rtol}; max |err| {float(err.max()):.3e}")
    return float(err.max())


def paged_parity_cases():
    """``(dtype, Dh, T, seq_lens, seed)`` of the K4 parity sweep: float32
    and bf16, head_dim 64 and 128, decode and verify spans of 4, 5 and 8
    rows, over ragged live lengths and over lengths on the edges of the
    kernel's split chunk C: C - 1, C and C + 1, a slot shorter than one
    chunk beside a slot of 2048, and C + 2, whose 4-row span ends in two
    splits (rows 0 and 1 find every key of split 1 masked). Spans of 5 and
    8 rows (a verify of K = 4 and of the largest K, 7) also take lengths
    past the table's 2048 rows, as a verify span at the cache ceiling
    gives them: the kernel must stop at the table's last row, as the plain
    version's view does. Lane 6 is inactive and lane 7 shares lane 4's
    first 16 blocks (``paged_case``)."""
    from paddle_tpu_torch.ops import paged_attention as pa

    C = pa.split_keys()

    ragged = [1, 15, 16, 17, 700, 2048, 1, 300]
    edges = [C - 1, C, C + 1, 100, 2048, C + 2, 1, 3 * C + 1]
    for dtype in (torch.float32, torch.bfloat16):
        for Dh in (64, 128):
            for T in (1, 4, 5, 8):
                # cursors up to the table's last row, spans past it
                ceiling = [2047 + T, 2046 + T, 2047, 64, 2048, 2044 + T, 1,
                           2049]
                cases = (ragged, edges) + ((ceiling,) if T >= 5 else ())
                for i, lens in enumerate(cases):
                    yield (dtype, Dh, T, [max(n, T) for n in lens],
                           T + Dh + 2 * i)


def paged_errors(got, args):
    """K4's output ``got`` on ``args`` against its plain version: ``(max
    |err|, elements outside PAGED_PARITY_TOL or not finite, paged_rel_err
    against the plain version computed in float32 on the same values)``."""
    from paddle_tpu_torch.ops import paged_attention as pa

    want = pa.paged_attention_ref(*args)
    exact = want if want.dtype == torch.float32 else pa.paged_attention_ref(
        *(a.float() for a in args[:3]), *args[3:])
    atol, rtol = pa.PAGED_PARITY_TOL[want.dtype]
    err = (got.float() - want.float()).abs()
    bad = ~(err <= atol + rtol * want.float().abs())  # NaN counts as bad
    return (float(err.nan_to_num(float("inf")).max()), int(bad.sum()),
            pa.paged_rel_err(got, exact))


def paged_parity_errors(dev):
    """K4 against its plain version over ``paged_parity_cases``:
    ``[(case, dtype, max |err|, elements outside PAGED_PARITY_TOL or not
    finite, relative error)]`` (``paged_errors``)."""
    from paddle_tpu_torch.ops import paged_attention as pa

    out = []
    for dtype, Dh, T, lens, seed in paged_parity_cases():
        args = paged_case(dev, dtype, T, lens, Dh=Dh, inactive=(6,),
                          share=(4, 7, 16), seed=seed)
        got = pa.paged_attention(*args)
        torch.cuda.synchronize()
        out.append((f"{str(dtype)[6:]} Dh={Dh} T={T} seq_lens={lens}",
                    dtype, *paged_errors(got, args)))
    return out


def check_paged(what, dtype, err, n_bad, rel):
    """Raise unless one K4 case is finite and inside both bounds."""
    from paddle_tpu_torch.ops import paged_attention as pa

    if n_bad or not rel <= pa.PAGED_PARITY_REL[dtype]:
        raise AssertionError(
            f"paged_attention {what}: {n_bad} elements outside "
            f"{pa.PAGED_PARITY_TOL[dtype]} or not finite, max |err| "
            f"{err:.3e}; relative error {rel:.3e} (bound "
            f"{pa.PAGED_PARITY_REL[dtype]})")


# timed K4 shapes, bf16: (what, span rows, live lengths, seed). Decode: the
# serving phase's batch (8 slots x 1024 live rows), and few long slots (2
# slots x 2048), a server at low concurrency holding long contexts, where
# the split matters most; a verify span of K + 1 = 5 rows over the serving
# batch (phase 5b's verify)
PAGED_TIMED = {
    "paged_attention": ("8 slots x 1024 live rows", 1, [1024] * 8, 7),
    "paged_attention_2x2048": ("2 slots x 2048 live rows", 1, [2048] * 2, 8),
    "paged_attention_verify": ("8 slots x 5 rows x 1024 live rows", 5,
                               [1024] * 8, 9)}


def phase_kernels(dev):
    from paddle_tpu_torch.ops import paged_attention as pa

    max_err = 0.0
    max_rel = dict.fromkeys(("float32", "bfloat16"), 0.0)
    for what, dtype, err, n_bad, rel in paged_parity_errors(dev):
        check_paged(what, dtype, err, n_bad, rel)
        max_err = max(max_err, err)
        max_rel[str(dtype)[6:]] = max(max_rel[str(dtype)[6:]], rel)
        log(f"kernels: paged_attention {what} max|err|={err:.3e} tol="
            f"{pa.PAGED_PARITY_TOL[dtype]}, relative {rel:.3e} bound "
            f"{pa.PAGED_PARITY_REL[dtype]}")

    rows = []
    lib = torch.nn.functional.scaled_dot_product_attention
    for name, (shape, T, lens, seed) in PAGED_TIMED.items():
        args = paged_case(dev, torch.bfloat16, T, lens, seed=seed)
        q, kp, vp, bt, sl, qo = args
        outs = [pa.paged_attention(*args) for _ in range(2)]
        err, n_bad, rel = paged_errors(outs[0], args)
        check_paged(shape, torch.bfloat16, err, n_bad, rel)
        max_err = max(max_err, err)
        max_rel["bfloat16"] = max(max_rel["bfloat16"], rel)
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError(
                f"paged_attention {shape}: two launches on the same inputs "
                f"differ in {int((outs[0] != outs[1]).sum())} elements")
        k_view, v_view = pa.paged_view(kp, bt), pa.paged_view(vp, bt)
        # the span's keep-mask: causal inside the span, live rows only
        mask = pa.position_mask(qo, sl, T, k_view.shape[1])
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k_view, v_view))
        row_bytes = 2 * kp[0, 0].numel() * kp.element_size()  # a K and a V
        copies = cold_copies(args, int(torch.minimum(qo + T, sl).sum())
                             * row_bytes)
        cold = [lambda a=a: pa.paged_attention(*a) for a in copies]
        lib_cold = [lambda a=a: lib(*a[:3], attn_mask=a[3]) for a in
                    cold_copies((qt, kt, vt, mask),
                                2 * kt.numel() * kt.element_size())]
        kern = lambda: pa.paged_attention(*args)  # noqa: E731
        ms = device_ms(cold)
        warm_ms = device_ms(kern)
        eager_ms = cuda_ms(kern)
        plain_ms = cuda_ms(lambda: pa.paged_attention_ref(*args), iters=10)
        library_ms = device_ms(lib_cold)
        ms2 = device_ms(cold)
        n_copies = len(copies)
        del copies, cold, lib_cold
        bound_ms, bound_by = paged_bound(q, kp, bt, sl, qo)
        log(f"kernels: paged_attention bf16 {shape}: max|err|={err:.3e}, "
            f"relative {rel:.3e}, two launches bitwise equal; kernel "
            f"{ms:.5f} / {ms2:.5f} ms (device time, CUDA graph, L2 cold: "
            f"{n_copies} copies of the pools in turn), {warm_ms:.5f} ms "
            f"on one copy (L2 warm), {eager_ms:.5f} ms called eagerly; "
            f"plain {plain_ms:.4f} ms, library (sdpa on the gathered view, "
            f"L2 cold) {library_ms:.5f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}), {bound_ms / min(ms, ms2):.1%} of it")
        rows.append({"name": name, "route": "cuda", "source": PAGED_SOURCE,
                     "replaces": PAGED_REPLACES, "shape": f"bf16 {shape}",
                     "max_abs_err": max_err,
                     "tolerance": {str(k)[6:]: v
                                   for k, v in pa.PAGED_PARITY_TOL.items()},
                     "max_rel_err": dict(max_rel),
                     "rel_bound": {str(k)[6:]: v
                                   for k, v in pa.PAGED_PARITY_REL.items()},
                     "ms": min(ms, ms2), "kernel_ms": min(ms, ms2),
                     "l2": "cold", "warm_ms": warm_ms,
                     "eager_ms": eager_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "bound_share": bound_ms / min(ms, ms2),
                     "design": DESIGNS["paged_attention"],
                     "library_ms": library_ms})
    rows.append(paged_shard_row(dev, max_err, max_rel))
    return rows


# phase 13's K4 instance: rank r of mp = 2 runs the kernel on its 16 of
# gpt3-1.3B's 32 heads; held on phase 3's serving-batch decode case
MP_SHARD = ("paged_attention_mp_shard",
            "8 slots x 1024 live rows, 16 of 32 heads (one rank of mp = 2)")


def paged_shard_row(dev, max_err, max_rel):
    """K4 per shard: on each rank's contiguous copy of 16 of the 32 heads
    of ``PAGED_TIMED["paged_attention"]``'s case, the kernel's output must
    equal the 32-head kernel's on those heads bitwise (each head is
    computed on its own and the split chunk does not depend on the head
    count); then rank 0's shard is timed as the other rows are."""
    from paddle_tpu_torch.ops import paged_attention as pa

    name, shape = MP_SHARD
    _, T, lens, seed = PAGED_TIMED["paged_attention"]
    whole = paged_case(dev, torch.bfloat16, T, lens, seed=seed)
    out = pa.paged_attention(*whole)
    H = whole[0].shape[2]
    shards = []
    for r in range(2):
        heads = slice(r * H // 2, (r + 1) * H // 2)
        args = (*(x[:, :, heads].contiguous() for x in whole[:3]),
                *whole[3:])
        got = pa.paged_attention(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, out[:, :, heads]):
            raise AssertionError(
                f"paged_attention per shard: rank {r}'s 16 heads differ from "
                f"the 32-head kernel's in "
                f"{int((got != out[:, :, heads]).sum())} elements")
        shards.append(args)
    args = shards[0]
    q, kp, vp, bt, sl, qo = args
    err, n_bad, rel = paged_errors(pa.paged_attention(*args), args)
    check_paged(shape, torch.bfloat16, err, n_bad, rel)
    row_bytes = 2 * kp[0, 0].numel() * kp.element_size()
    copies = cold_copies(args, int(torch.minimum(qo + T, sl).sum())
                         * row_bytes)
    cold = [lambda a=a: pa.paged_attention(*a) for a in copies]
    k_view, v_view = pa.paged_view(kp, bt), pa.paged_view(vp, bt)
    mask = pa.position_mask(qo, sl, T, k_view.shape[1])
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k_view, v_view))
    lib = torch.nn.functional.scaled_dot_product_attention
    lib_cold = [lambda a=a: lib(*a[:3], attn_mask=a[3]) for a in
                cold_copies((qt, kt, vt, mask),
                            2 * kt.numel() * kt.element_size())]
    ms = min(device_ms(cold), device_ms(cold))
    warm_ms = device_ms(lambda: pa.paged_attention(*args))
    plain_ms = cuda_ms(lambda: pa.paged_attention_ref(*args), iters=10)
    library_ms = device_ms(lib_cold)
    del copies, cold, lib_cold
    bound_ms, bound_by = paged_bound(q, kp, bt, sl, qo)
    log(f"kernels: paged_attention per shard, bf16 {shape}: equal bitwise "
        f"to the 32-head kernel's heads on both ranks; kernel {ms:.5f} ms "
        f"(device time, L2 cold), {warm_ms:.5f} ms L2 warm; plain "
        f"{plain_ms:.4f} ms, library (sdpa on the gathered 16-head view, "
        f"L2 cold) {library_ms:.5f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by}), {bound_ms / ms:.1%} of it")
    return {"name": name, "route": "cuda", "source": PAGED_SOURCE,
            "replaces": PAGED_REPLACES,
            "per_shard_of": "paddle_tpu/ops/pallas_ops.py:574",
            "shape": f"bf16 {shape}", "max_abs_err": max(max_err, err),
            "tolerance": {str(k)[6:]: v
                          for k, v in pa.PAGED_PARITY_TOL.items()},
            "max_rel_err": dict(max_rel, bfloat16=max(max_rel["bfloat16"],
                                                      rel)),
            "rel_bound": {str(k)[6:]: v
                          for k, v in pa.PAGED_PARITY_REL.items()},
            "per_shard_bitwise": True, "ms": ms, "kernel_ms": ms,
            "l2": "cold", "warm_ms": warm_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms,
            "design": DESIGNS["paged_attention"], "library_ms": library_ms}


# ------------------------------------------------------- flash kernels --
# the training step's attention: batch 4 x 32 heads, T=2048, head_dim 64
STEP_SHAPE = (4, 2048, 32, 64)


def flash_case(dev, dtype, B, T, N, H, seed, strided):
    """q, k, v ``[B, T, N, H]`` (unbind views of one fused projection when
    ``strided``, as the model hands them over) and an output gradient."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    if strided:
        q, k, v = torch.randn(B, T, 3, N, H, generator=g).to(
            dev, dtype).unbind(2)
    else:
        q, k, v = (torch.randn(B, T, N, H, generator=g).to(dev, dtype)
                   for _ in range(3))
    return q, k, v, torch.randn(B, T, N, H, generator=g).to(dev, dtype)


def flash_cases():
    """``(dtype, causal, H, T, B, N, strided, seed)`` of the parity sweep:
    float32 and bf16, causal and not, every head_dim the kernels take,
    T of one and two 128-row tiles and of the training step."""
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            for H in (64, 96, 128, 256):
                for T in (128, 256, 2048):
                    B, N = (1, 2) if T == 2048 else (2, 3)
                    yield (dtype, causal, H, T, B, N, T != 128,
                           T + H + causal)


def flash_case_errors(q, k, v, do, causal):
    """Each kernel's outputs against its plain version's on one case:
    ``{output: (max |err|, elements outside FLASH_PARITY_TOL or not finite,
    flash_rel_err or None)}``. K2 and K3 take the plain forward's lse and
    delta; lse is held to (1e-4, 1e-4) elementwise."""
    from paddle_tpu_torch.ops import flash_attention as fa

    out, lse = fa.flash_fwd(q, k, v, causal)
    ref, ref_lse = fa.flash_fwd_ref(q, k, v, causal)
    delta = fa.flash_delta(ref, do)
    dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal)
    rdq = fa.flash_bwd_dq_ref(q, k, v, do, ref_lse, delta, causal)
    rdk, rdv = fa.flash_bwd_dkv_ref(q, k, v, do, ref_lse, delta, causal)
    torch.cuda.synchronize()
    tol = fa.FLASH_PARITY_TOL[q.dtype]

    def elementwise(got, want, tol):
        atol, rtol = tol
        got, want = got.float(), want.float()
        err = (got - want).abs()
        bad = ~(err <= atol + rtol * want.abs())  # NaN counts as bad
        return float(err.nan_to_num(float("inf")).max()), int(bad.sum())

    res = {"flash_fwd lse": (*elementwise(lse, ref_lse, (1e-4, 1e-4)),
                             None)}
    for name, got, want in (("flash_fwd out", out, ref),
                            ("flash_bwd_dq dq", dq, rdq),
                            ("flash_bwd_dkv dk", dk, rdk),
                            ("flash_bwd_dkv dv", dv, rdv)):
        res[name] = (*elementwise(got, want, tol),
                     fa.flash_rel_err(got, want))
    return res


def check_flash_case(res, dtype, what):
    """Raise unless every output of ``flash_case_errors`` is finite, within
    FLASH_PARITY_TOL elementwise and within FLASH_PARITY_REL."""
    from paddle_tpu_torch.ops import flash_attention as fa

    rel_tol = fa.FLASH_PARITY_REL[dtype]
    for name, (err, n_bad, rel) in res.items():
        if n_bad or (rel is not None and not rel <= rel_tol):
            raise AssertionError(
                f"{name} {what}: {n_bad} elements outside "
                f"{fa.FLASH_PARITY_TOL[dtype]} or not finite, max |err| "
                f"{err:.3e}; relative error {rel} (bound {rel_tol})")


def flash_bound(name, q, causal):
    """Least time (ms) for the card to run kernel ``name`` on ``q``'s shape:
    its tensor-core products over the score pairs the mask keeps, against
    ``FLASH_FLOPS`` for the operand type (float32: three TF32 products
    each), or its inputs read once and outputs written once, against the
    data-sheet bandwidth. Returns (ms, "bytes" | "operations")."""
    B, T, N, H = q.shape
    es = q.element_size()
    pairs = T * (T + 1) // 2 if causal else T * T
    ops = 2 * H * pairs * FLASH_KERNELS[name][1] * B * N
    tile, rows = q.numel() * es, B * N * T * 4
    nbytes = {"flash_fwd": 4 * tile + rows,            # q k v -> out, lse
              "flash_bwd_dq": 5 * tile + 2 * rows,     # q k v do lse delta
              "flash_bwd_dkv": 6 * tile + 2 * rows}[name]
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / FLASH_FLOPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# cases of the run-to-run check, (dtype, causal, [B, T, N, H]): bf16 causal
# at the training step's shape and at H=128; float32 non-causal at phase
# 14's shape and at H=128, and causal at T=2048 (the split-TF32 instances)
REPEAT_CASES = ((torch.bfloat16, True, STEP_SHAPE),
                (torch.bfloat16, True, (2, 2048, 8, 128)),
                (torch.float32, False, NONCAUSAL_SHAPES[torch.float32]),
                (torch.float32, False, (4, 256, 4, 128)),
                (torch.float32, True, (1, 2048, 2, 64)))


def flash_repeat_check(dev, dtype, causal, B, T, N, H, seed=11):
    """Launch K1, K2 and K3 twice each on the same inputs (unbind views) and
    raise unless both launches give bitwise-equal outputs: a ring stage
    read after the producer overwrote it shows up as a run-to-run
    difference that a tolerance could hide. The kernels sum in a fixed
    order and use no atomics, so equal inputs give equal bits."""
    from paddle_tpu_torch.ops import flash_attention as fa

    q, k, v, do = flash_case(dev, dtype, B, T, N, H, seed, strided=True)
    fwd = [fa.flash_fwd(q, k, v, causal) for _ in range(2)]
    lse = fwd[0][1]
    delta = fa.flash_delta(fwd[0][0], do)
    dq = [fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
          for _ in range(2)]
    dkv = [fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
           for _ in range(2)]
    torch.cuda.synchronize()
    pairs = {"flash_fwd out": (fwd[0][0], fwd[1][0]),
             "flash_fwd lse": (fwd[0][1], fwd[1][1]),
             "flash_bwd_dq dq": tuple(dq),
             "flash_bwd_dkv dk": (dkv[0][0], dkv[1][0]),
             "flash_bwd_dkv dv": (dkv[0][1], dkv[1][1])}
    for name, (a, b) in pairs.items():
        if not torch.equal(a, b):
            raise AssertionError(
                f"{name} {str(dtype)[6:]} causal={causal} B*N={B * N} "
                f"T={T} H={H}: two launches on the same inputs differ in "
                f"{int((a != b).sum())} elements")


def flash_timings(q, k, v, do, causal):
    """K1, K2 and K3 on these inputs timed beside their plain versions, one
    library call and their bounds: ``{kernel: {"ms", "kernel_ms",
    "eager_ms", "plain_ms", "bound_ms", "bound_by", "bound_rate",
    "bound_share", "library_ms", "library_call"}}``. The kernel's "ms" is
    the lower of two device-time readings. The library yardstick is SDPA
    in its own ``[B, N, T, H]`` layout: its forward for K1 (``device_ms``),
    its whole backward (dq, dk and dv together) for K2 and K3, as device
    time: the kernels of eager calls through autograd, summed by
    torch.profiler (``profiled_ms``)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    F = torch.nn.functional
    B, T, N, H = q.shape
    out, lse = fa.flash_fwd(q, k, v, causal)
    delta = fa.flash_delta(out, do)
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal),
                      lambda: fa.flash_fwd_ref(q, k, v, causal)),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
            lambda: fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, causal)),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal),
            lambda: fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal)),
    }
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous().requires_grad_()
                       for x in (q, k, v, do))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    library = {
        "flash_fwd": device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), calls=10, replays=2),
        "bwd": profiled_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot.detach(), retain_graph=True),
            calls=10)}
    tag = f"{str(q.dtype)[6:]} B*N={B * N} T={T} H={H} " + (
        "causal" if causal else "non-causal")
    rows = {}
    for name, (kern, plain) in calls.items():
        ms = device_ms(kern, calls=10, replays=2)
        eager_ms = cuda_ms(kern, iters=20)
        plain_ms = cuda_ms(plain, iters=3)
        ms2 = device_ms(kern, calls=10, replays=2)
        bound_ms, bound_by = flash_bound(name, q, causal)
        lib_ms = library.get(name, library["bwd"])
        log(f"kernels (training): {name} {tag}: kernel {ms:.4f} / "
            f"{ms2:.4f} ms (device time, CUDA graph), {eager_ms:.4f} ms "
            f"called eagerly; plain {plain_ms:.4f} ms, library "
            f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
            f"{PEAK_NAMES[q.dtype]})")
        rows[name] = {
            "ms": min(ms, ms2), "kernel_ms": min(ms, ms2),
            "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_rate": PEAK_NAMES[q.dtype],
            "bound_share": bound_ms / min(ms, ms2), "library_ms": lib_ms,
            "library_call": f"scaled_dot_product_attention(is_causal="
            f"{causal}) " + ("forward" if name == "flash_fwd"
                             else "backward (dq, dk and dv together, "
                             "torch.profiler's kernel sum)")}
    return rows


def profiled_ms(fn, calls=10):
    """Mean device milliseconds per call of ``fn``: the durations of the
    kernels (and copies) that torch.profiler records on the card over
    ``calls`` eager calls, summed, so the host's gaps between them do not
    count. For a call that launches many kernels and cannot be captured in
    a graph as it stands (autograd's backward). Raises if the profiler saw
    no device time."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if not us > 0:
        raise AssertionError("torch.profiler recorded no device time")
    return us / 1e3 / calls


def phase_flash_kernels(dev):
    from paddle_tpu_torch.ops import flash_attention as fa

    max_err = dict.fromkeys(FLASH_KERNELS, 0.0)
    max_rel = {str(d)[6:]: dict.fromkeys(FLASH_KERNELS, 0.0)
               for d in (torch.float32, torch.bfloat16)}

    def record(res, dtype):
        for name, (err, _, rel) in res.items():
            kern = name.split()[0]
            max_err[kern] = max(max_err[kern], err)
            if rel is not None:
                row = max_rel[str(dtype)[6:]]
                row[kern] = max(row[kern], rel)

    n_cases = 0
    for dtype, causal, H, T, B, N, strided, seed in flash_cases():
        q, k, v, do = flash_case(dev, dtype, B, T, N, H, seed, strided)
        res = flash_case_errors(q, k, v, do, causal)
        check_flash_case(res, dtype, f"{str(dtype)[6:]} causal={causal} "
                         f"H={H} T={T}")
        record(res, dtype)
        n_cases += 1

    # the training step's shape, on the unbind views of a fused projection:
    # held to the plain versions, then timed
    B, T, N, H = STEP_SHAPE
    q, k, v, do = flash_case(dev, torch.bfloat16, B, T, N, H, seed=9,
                             strided=True)
    res = flash_case_errors(q, k, v, do, True)
    check_flash_case(res, torch.bfloat16,
                     f"bf16 causal B*N={B * N} T={T} H={H} (training step)")
    record(res, torch.bfloat16)
    log(f"kernels (training): K1-K3 held to their plain versions over "
        f"{n_cases} cases (float32 and bf16, causal and not, H in "
        f"{fa.HEAD_DIMS}, T in (128, 256, 2048)) and the training step's "
        f"shape; max |err| "
        + ", ".join(f"{k} {v:.3e}" for k, v in max_err.items())
        + f" (tol {fa.FLASH_PARITY_TOL}); max relative error {max_rel} "
        f"(bound {fa.FLASH_PARITY_REL}); at the step's shape "
        + ", ".join(f"{k} {e:.3e} / {r:.3e}" for k, (e, _, r)
                    in res.items() if r is not None))

    for dtype, causal, shape in REPEAT_CASES:
        flash_repeat_check(dev, dtype, causal, *shape)
    log("kernels (training): K1-K3 repeat bitwise on the same inputs, "
        "(dtype, causal, [B, T, N, H]) in " + ", ".join(
            f"({str(d)[6:]}, {c}, {list(s)})" for d, c, s in REPEAT_CASES))

    rows = {}
    for name, row in flash_timings(q, k, v, do, True).items():
        rows[name] = {
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": FLASH_KERNELS[name][0], "max_abs_err": max_err[name],
            "tolerance": {str(d)[6:]: t
                          for d, t in fa.FLASH_PARITY_TOL.items()},
            "max_rel_err": {d: r[name] for d, r in max_rel.items()},
            "rel_bound": {str(d)[6:]: t
                          for d, t in fa.FLASH_PARITY_REL.items()},
            **row, "design": DESIGNS[name],
            "instance_design": instance_design(torch.bfloat16,
                                               STEP_SHAPE[3])}
    for dtype, shape in NONCAUSAL_SHAPES.items():
        rows.update(noncausal_rows(dev, dtype, shape))
    return rows


def noncausal_rows(dev, dtype, shape):
    """K1-K3's non-causal instances at ``shape`` ([B, T, N, H] of q, on
    the unbind views of a fused projection, as the encoder's projections
    hand them over): each held to its plain version (FLASH_PARITY_TOL,
    FLASH_PARITY_REL), then timed (``flash_timings``). Rows named
    ``<kernel>_noncausal_<dtype>``."""
    from paddle_tpu_torch.ops import flash_attention as fa

    B, T, N, H = shape
    tag = str(dtype)[6:]
    q, k, v, do = flash_case(dev, dtype, B, T, N, H, seed=13, strided=True)
    res = flash_case_errors(q, k, v, do, False)
    check_flash_case(res, dtype, f"{tag} non-causal B*N={B * N} T={T} "
                     f"H={H}")
    rows = {}
    for name, row in flash_timings(q, k, v, do, False).items():
        errs = [e for o, (e, _, _) in res.items() if o.split()[0] == name]
        rels = [r for o, (_, _, r) in res.items()
                if o.split()[0] == name and r is not None]
        log(f"kernels (training): {name} {tag} non-causal against its plain "
            f"version: max |err| {max(errs):.3e}, relative "
            f"{max(rels):.3e}")
        row_name = f"{name}_noncausal_{tag}"
        rows[row_name] = {
            "name": row_name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": FLASH_KERNELS[name][0], "max_abs_err": max(errs),
            "tolerance": list(fa.FLASH_PARITY_TOL[dtype]),
            "max_rel_err": max(rels), "rel_bound": fa.FLASH_PARITY_REL[dtype],
            "shape": [B, T, N, H], "causal": False, **row,
            "design": DESIGNS[name],
            "instance_design": instance_design(dtype, H)}
    return rows


# -------------------------------------------------------------- training --
def training_setup(dev, preset="gpt3-1.3B", batch=4, seq_len=2048, seed=0,
                   learning_rate=1e-4, graph=True, distribute=False,
                   **cfg_over):
    """The pretraining step of ``bench.py``: ``preset`` in bf16 (dropout 0,
    random weights from ``seed``), ``GPTPretrainingCriterion`` (plus the
    model's ``moe_aux_loss()`` for an MoE config),
    ``AdamW(learning_rate, multi_precision=True)`` under ``TrainStep``, and
    one fixed batch of tokens from seed 0 with its next-token labels.
    Returns ``(cfg, model, opt, train, tokens, labels)``; ``train(tokens,
    labels)`` is one step and returns the loss (aux loss included): the
    first call eager, the second captured as a CUDA graph and replayed, and
    every later one a replay; ``train.step_fn(tokens, labels)`` is the same
    step run eagerly. ``graph=False``: ``train`` is that eager step itself.
    ``distribute``: the model goes through ``fleet.distributed_model``
    (after ``fleet.init``) before the optimizer is built."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    cfg, model = pretraining_model(dev, preset, seq_len, seed, **cfg_over)
    if distribute:
        from paddle_tpu_torch.distributed import fleet

        fleet.distributed_model(model)
    crit = GPTPretrainingCriterion()
    opt = AdamW(learning_rate=learning_rate, multi_precision=True,
                parameters=model.parameters())

    def step_fn(tokens, labels):
        loss = crit(model(tokens), labels)
        aux = model.moe_aux_loss()
        if aux is not None:
            loss = loss + aux
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    train = TrainStep(step_fn, model, opt) if graph else step_fn
    tokens, labels = pretraining_batch(dev, cfg.vocab_size, batch, seq_len)
    return cfg, model, opt, train, tokens, labels


def pretraining_model(dev, preset="gpt3-1.3B", seq_len=2048, seed=0,
                      **cfg_over):
    """``training_setup``'s model: ``(cfg, GPTForPretraining)``."""
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)

    cfg = GPTConfig.preset(preset, seq_len=seq_len, dtype="bfloat16",
                           dropout=0.0, **cfg_over)
    return cfg, GPTForPretraining(GPTModel(
        cfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed)))


def pretraining_batch(dev, vocab, batch=4, seq_len=2048):
    """``training_setup``'s batch (seed 0) and its next-token labels."""
    toks = np.random.default_rng(0).integers(0, vocab, (batch, seq_len))
    return (torch.from_numpy(toks).to(dev),
            torch.from_numpy(np.roll(toks, -1, axis=1)).to(dev))


def flash_device_counts():
    """K1-K3 launches the card counted since the last
    ``reset_device_launches`` (both dtypes)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    counts = fa.device_launches()
    counts.pop("by_dtype")
    return counts


def phase_training(dev, preset="gpt3-1.3B", batch=4, seq_len=2048,
                   eager_steps=3, warmup=3, steps=5, **cfg_over):
    """7: the pretraining step through ``TrainStep``'s CUDA graph, beside
    the same ``step_fn`` in a plain eager loop (first, ``eager_steps``
    steps, the first untimed). The graph: ``warmup`` calls (eager, capture
    and replay, replay), then ``steps`` timed replays and 2 profiled ones.
    Checks: the loss finite and falling; one capture; K1-K3 launched
    steps x n_layer times on the card's count over the timed window, the
    plain attention never; no kernel launched from the host in a steady
    step (torch.profiler: one graph launch a step). Returns the result and
    the trained model (its optimizer dropped)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.profiler import registry

    t0 = time.perf_counter()
    cfg, model, opt, train, tokens, labels = training_setup(
        dev, preset, batch, seq_len, **cfg_over)
    log(f"training: {preset} bf16 n_layer={cfg.n_layer} attention route "
        f"{model.gpt.attn_kernel!r}, built in {time.perf_counter() - t0:.1f}"
        " s")
    registry.reset("jit")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, eager_s = [], []
    for _ in range(eager_steps):
        t1 = time.perf_counter()
        losses.append(float(train.step_fn(tokens, labels).detach()))
        eager_s.append(time.perf_counter() - t1)
    eager_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    free_memory()
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(warmup):
        losses.append(float(train(tokens, labels)))
    torch.cuda.synchronize()
    registry.reset("kernels")
    fa.reset_device_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = train(tokens, labels)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    losses.append(float(loss))
    counts = flash_device_counts()
    py_counts = fa.launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    prof = profile_steps(lambda: train(tokens, labels), 2)
    jit = dict(registry.counters("jit"))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training: losses {losses} are not finite and "
                             "falling")
    if model.gpt.attn_kernel != "cuda":
        raise AssertionError(f"training: the model resolved "
                             f"{model.gpt.attn_kernel!r} on the card")
    if jit["train_step_captures"] != 1 or jit["train_step_eager"] != 1:
        raise AssertionError(f"training: TrainStep counters {jit}, want one "
                             "eager call and one capture")
    for name in FLASH_KERNELS:
        if counts[name] != steps * cfg.n_layer:
            raise AssertionError(
                f"training: the card counted {counts[name]} {name} launches "
                f"over {steps} replays, want {steps} x {cfg.n_layer} layers")
    if any(py_counts.values()):
        raise AssertionError(f"training: replays moved the Python counters "
                             f"or took the plain attention: {py_counts}")
    if prof["kernel_launches"] or prof["graph_launches"] != 2:
        raise AssertionError(f"training: a steady step launched "
                             f"{prof['kernel_launches'] / 2} kernels from the "
                             f"host and {prof['graph_launches'] / 2} graphs")
    tokens_per_step = batch * seq_len
    flops = cfg.flops_per_token() * tokens_per_step
    eager_dt = float(np.mean(eager_s[1:]))
    result = {"preset": preset, "batch": batch, "seq_len": seq_len,
              "steps": steps,
              "trained_steps": eager_steps + warmup + steps + 2,
              "step_ms": dt * 1e3,
              "tokens_per_s": tokens_per_step / dt,
              "mfu": flops / dt / PEAK_FLOPS[torch.bfloat16],
              "eager_step_ms": eager_dt * 1e3,
              "eager_tokens_per_s": tokens_per_step / eager_dt,
              "eager_mfu": flops / eager_dt / PEAK_FLOPS[torch.bfloat16],
              "losses": losses, "peak_memory_gb": peak_gb,
              "eager_peak_memory_gb": eager_peak_gb,
              "kernels_per_step": prof["kernels"] / 2,
              "host_kernel_launches_per_step": prof["kernel_launches"] / 2,
              "train_step": jit, "launches": counts}
    log("training: " + json.dumps(result))
    del opt, train
    free_memory()
    return result, model


def phase_training_parity(dev, preset="gpt3-1.3B", n_layer=2, seq_len=256,
                          batch=2, steps=3, loss_tol=(1e-5, 1e-5),
                          grad_tol=(1e-5, 1e-3), param_tol=(1e-4, 1e-4)):
    """One float32 model through the kernel route and the plain route.
    Tolerances: the routes differ only in the attention's summation order
    (kernel tiles against one einsum), carried through two layers and the
    50304-wide LM head into the grads. AdamW divides each moment by the
    root of the second: where an element's gradients cancel across steps,
    that ratio magnifies a gradient difference of a few ulps, so a handful
    of elements may move by a fraction of one update (lr 1e-4) after three
    steps; the bound is that one update, and the log counts the elements
    that differ by more than 1e-6."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import registry

    cfg, models, tokens, labels, crit = _parity_models(
        dev, preset, n_layer, seq_len, batch, "float32")
    opts = [AdamW(learning_rate=1e-4, parameters=m.parameters())
            for m in models]
    registry.reset("kernels")
    max_err = {"loss": 0.0, "grad": 0.0, "param": 0.0}
    for step in range(steps):
        losses = []
        for m in models:
            loss = crit(m(tokens), labels)
            loss.backward()
            losses.append(loss.detach())
        max_err["loss"] = max(max_err["loss"], check_close(
            losses[0], losses[1], loss_tol, f"parity loss step {step}"))
        if step == 0:
            grads = [dict(m.named_parameters()) for m in models]
            for name, p in grads[0].items():
                max_err["grad"] = max(max_err["grad"], check_close(
                    p.grad, grads[1][name].grad, grad_tol,
                    f"parity grad {name}"))
        for o in opts:
            o.step()
            o.clear_grad()
    n_off = 0
    for (name, a), b in zip(models[0].named_parameters(),
                            models[1].parameters()):
        max_err["param"] = max(max_err["param"], check_close(
            a.detach(), b.detach(), param_tol,
            f"parity param {name} after {steps} steps"))
        n_off += int(((a - b).abs() > 1e-6).sum())
    n_params = sum(p.numel() for p in models[0].parameters())
    counts = fa.launches()
    if counts["flash_fwd"] != steps * n_layer or \
            counts["flash_attention_ref"] != steps * n_layer:
        raise AssertionError(f"training parity: routes not taken: {counts}")
    log(f"training parity: kernel vs plain route, {n_layer} layers d_model "
        f"{cfg.d_model} float32 T={seq_len}: max |err| loss "
        f"{max_err['loss']:.3e} (tol {loss_tol}), grads {max_err['grad']:.3e}"
        f" (tol {grad_tol}), params after {steps} AdamW steps "
        f"{max_err['param']:.3e} (tol {param_tol}; {n_off} of {n_params} "
        "elements differ by more than 1e-6)")
    return max_err


def phase_training_parity_bf16(dev, preset="gpt3-1.3B", n_layer=2,
                               seq_len=2048, batch=2, loss_rel=1e-3,
                               grad_rel=5e-2):
    """One bf16 model through the kernel route (K1-K3 on the tensor cores)
    and the plain route: the loss within ``loss_rel`` of the plain route's,
    and every gradient within ``grad_rel`` of the plain route's in norm
    (``||g - g_plain|| / ||g_plain||``, per parameter). The losses compared
    are the float32 cross-entropy of each route's bf16 logits: the
    criterion's own bf16 loss moves in steps of 2**-4 near 11, a relative
    5.6e-3, so it is either equal or a whole step apart. Tolerances: the
    plain route rounds the scores and the probabilities to bf16 where the
    kernels round P and dS, each a relative step of 2**-9, carried through
    two layers of bf16 GEMMs into the grads (about 1e-2 in norm); a fault
    that spoils one tile of the attention's gradients moves some
    parameter's gradient by tens of percent."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.profiler import registry

    cfg, models, tokens, labels, crit = _parity_models(
        dev, preset, n_layer, seq_len, batch, "bfloat16")
    registry.reset("kernels")
    losses = []
    for m in models:
        logits = m(tokens)
        crit(logits, labels).backward()
        losses.append(float(torch.nn.functional.cross_entropy(
            logits.detach().float().flatten(0, 1), labels.flatten())))
    loss_err = abs(losses[0] - losses[1]) / abs(losses[1])
    grads = [dict(m.named_parameters()) for m in models]
    rel = {}
    for name, p in grads[0].items():
        g, want = p.grad.float(), grads[1][name].grad.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"bf16 parity: non-finite grad {name}")
        rel[name] = float((g - want).norm() / want.norm())
    worst = max(rel, key=rel.get)
    counts = fa.launches()
    if counts["flash_fwd"] != n_layer or counts["flash_bwd_dkv"] != n_layer \
            or counts["flash_attention_ref"] != n_layer:
        raise AssertionError(f"bf16 parity: routes not taken: {counts}")
    log(f"training parity: kernel vs plain route, {n_layer} layers d_model "
        f"{cfg.d_model} bf16 T={seq_len}: float32 loss of the logits "
        f"{losses[0]:.6f} vs {losses[1]:.6f}, relative {loss_err:.3e} "
        f"(bound {loss_rel}); "
        f"grads relative in norm: max {rel[worst]:.3e} ({worst}), median "
        f"{sorted(rel.values())[len(rel) // 2]:.3e} (bound {grad_rel})")
    if not loss_err <= loss_rel or not rel[worst] <= grad_rel:
        raise AssertionError(f"bf16 parity: loss {loss_err:.3e} or grad "
                             f"{worst} {rel[worst]:.3e} out of bounds")
    return {"loss": loss_err, "grad": rel[worst]}


# ------------------------------------------- recompute and the step graph --
# bench.py's recompute ladder: name -> GPTConfig overrides
RECOMPUTE = {"none": {},
             "full": dict(use_recompute=True),
             "dots": dict(use_recompute=True, recompute_policy="dots"),
             "attn": dict(use_recompute=True, recompute_policy="attn"),
             "dots_attn": dict(use_recompute=True,
                               recompute_policy="dots_attn")}
# K1 launches per layer per step: the policies that keep the attention's
# output run it once, full recompute and "dots" twice
K1_PER_LAYER = {"none": 1, "full": 2, "dots": 2, "attn": 1, "dots_attn": 1}


def phase_recompute(dev, preset="gpt3-1.3B", batch=4, seq_len=2048,
                    warmup=2, steps=3):
    """10: each recompute policy at full width and depth (bf16, batch 4 x
    2048, seed-0 weights, AdamW with master weights) through
    ``TrainStep``: ``warmup`` calls (eager; capture and replay), then
    ``steps`` timed replays. Checks: the loss finite and falling, one
    capture, and per step on the card's count K1 n_layer times
    ``K1_PER_LAYER`` and K2, K3 n_layer times; full recompute's peak memory
    below ``none``'s. Reports step time, MFU and peak memory per policy."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.profiler import registry

    out = {}
    for name, over in RECOMPUTE.items():
        free_memory()
        torch.cuda.reset_peak_memory_stats(dev)
        cfg, model, opt, train, tokens, labels = training_setup(
            dev, preset, batch, seq_len, **over)
        registry.reset("jit")
        losses = [float(train(tokens, labels)) for _ in range(warmup)]
        torch.cuda.synchronize()
        fa.reset_device_launches()
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = train(tokens, labels)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / steps
        losses.append(float(loss))
        counts = flash_device_counts()
        per_step = {k: v / steps for k, v in counts.items()}
        want = {"flash_fwd": K1_PER_LAYER[name] * cfg.n_layer,
                "flash_bwd_dq": cfg.n_layer, "flash_bwd_dkv": cfg.n_layer}
        jit = dict(registry.counters("jit"))
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"recompute {name}: losses {losses}")
        if per_step != want or jit["train_step_captures"] != 1:
            raise AssertionError(f"recompute {name}: launches per step "
                                 f"{per_step}, want {want}; {jit}")
        out[name] = {"step_ms": dt * 1e3,
                     "mfu": cfg.flops_per_token() * batch * seq_len / dt
                     / PEAK_FLOPS[torch.bfloat16],
                     "peak_memory_gb":
                         torch.cuda.max_memory_allocated(dev) / 1e9,
                     "losses": losses, "launches_per_step": per_step}
        log(f"recompute {name}: " + json.dumps(out[name]))
        del model, opt, train
    free_memory()
    if not out["full"]["peak_memory_gb"] < out["none"]["peak_memory_gb"]:
        raise AssertionError(
            f"recompute: full recompute's peak "
            f"{out['full']['peak_memory_gb']:.2f} GB is not below none's "
            f"{out['none']['peak_memory_gb']:.2f}")
    return out


def phase_recompute_parity(dev, preset="gpt3-1.3B", n_layer=2, batch=2,
                           seq_len=2048, tol=(1e-5, 1e-5)):
    """10: each policy at full width and 2 layers in float32 (seed-0
    weights), one forward and backward: the loss and every gradient
    within ``tol`` of the ``none`` run's (the recomputation repeats the
    same kernels), and whether they are bitwise equal."""
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion

    runs, report = {}, {}
    for name, over in RECOMPUTE.items():
        model = build_gpt(dev, 0, preset, n_layer=n_layer, seq_len=seq_len,
                          **over)
        tokens, labels = token_batch(dev, model, batch, seq_len, seed=1)
        loss = GPTPretrainingCriterion()(model(tokens), labels)
        loss.backward()
        runs[name] = (loss.detach(), [p.grad for p in model.parameters()])
        del model
        if name == "none":
            continue
        (l0, g0), (l1, g1) = runs["none"], runs[name]
        err = max([check_close(l1, l0, tol, f"recompute {name} loss")]
                  + [check_close(b, a, tol, f"recompute {name} grad")
                     for a, b in zip(g0, g1)])
        report[name] = {"max_abs_err": err, "bitwise": bool(
            torch.equal(l0, l1) and all(torch.equal(a, b)
                                        for a, b in zip(g0, g1)))}
        runs.pop(name)
    log(f"recompute parity (float32, {n_layer} layers, batch {batch} x "
        f"{seq_len}, against none, tol {tol}): {json.dumps(report)}")
    free_memory()
    return report


def token_batch(dev, model, batch, seq_len, seed):
    """Random tokens from ``seed`` over ``model``'s vocabulary and their
    next-token labels, on the card."""
    toks = np.random.default_rng(seed).integers(
        0, model.gpt.cfg.vocab_size, (batch, seq_len))
    return (torch.from_numpy(toks).to(dev),
            torch.from_numpy(np.roll(toks, -1, axis=1)).to(dev))


def recipe_setup(dev, seed, preset="gpt3-1.3B", n_layer=2, seq_len=2048,
                 attn_dropout=0.0):
    """The GPT-3 pretraining recipe at ``preset``'s width: AdamW with master
    weights and decoupled decay on every weight but biases and LayerNorms,
    a linear warm-up into a cosine decay (stepped by the caller between
    steps), a global-norm clip of 1.0. Returns ``(model, opt, sched,
    step_fn)``."""
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)

    model = build_gpt(dev, seed, preset, n_layer=n_layer, seq_len=seq_len,
                      dtype="bfloat16", dropout=0.0,
                      attn_dropout=attn_dropout)
    sched = LinearWarmup(CosineAnnealingDecay(3e-4, T_max=8, eta_min=3e-5),
                         warmup_steps=2, start_lr=1e-4, end_lr=3e-4)
    opt = AdamW(learning_rate=sched, weight_decay=0.1, multi_precision=True,
                parameters=list(model.named_parameters()),
                grad_clip=ClipGradByGlobalNorm(1.0),
                apply_decay_param_fun=lambda n: not (
                    n.endswith(".bias") or ".ln" in n))
    crit = GPTPretrainingCriterion()

    def step_fn(tokens, labels):
        loss = crit(model(tokens), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return model, opt, sched, step_fn


class DropoutRecorder:
    """Test instrumentation: the GPT's ``hashed_dropout`` wrapped to keep
    the input and output of each call with a rate above 0 made while a
    CUDA graph captures; replays rewrite those tensors in place."""

    def __init__(self):
        from paddle_tpu_torch.models import gpt

        self.mod, self.orig, self.calls = gpt, gpt.hashed_dropout, []

    def __enter__(self):
        def rec(y, p, key, site, *shard):
            res = self.orig(y, p, key, site, *shard)
            if p > 0 and torch.cuda.is_current_stream_capturing():
                self.calls.append((y, res, p))
            return res

        self.mod.hashed_dropout = rec
        return self

    def __exit__(self, *exc):
        self.mod.hashed_dropout = self.orig


def optimizer_cases():
    """(label, optimizer class name, keyword arguments) for phase 10b's
    captured-step check: every optimizer, regularizer and clip of the
    port beside AdamW's recipe, on dense gradients (under the graph a
    sparse embedding takes the dense path: ``refusals`` checks it)."""
    from paddle_tpu_torch import nn as N
    from paddle_tpu_torch import regularizer as R

    return [("SGD", "SGD", dict(learning_rate=0.1)),
            ("Momentum", "Momentum", dict(learning_rate=0.1)),
            ("Momentum nesterov", "Momentum",
             dict(learning_rate=0.1, use_nesterov=True)),
            ("Lars", "Lars", dict(learning_rate=0.5, lars_coeff=0.01)),
            ("Adamax", "Adamax", dict(learning_rate=0.01)),
            ("Adagrad", "Adagrad", dict(learning_rate=0.05)),
            ("Adadelta", "Adadelta", dict(learning_rate=1.0)),
            ("RMSProp centered", "RMSProp",
             dict(learning_rate=0.01, momentum=0.5, centered=True)),
            ("Lamb", "Lamb", dict(learning_rate=0.01)),
            ("SGD + L1Decay", "SGD", dict(learning_rate=0.1,
                                          weight_decay=R.L1Decay(0.01))),
            ("Momentum + L2Decay", "Momentum",
             dict(learning_rate=0.1, weight_decay=R.L2Decay(0.01))),
            ("Adagrad + ClipGradByValue", "Adagrad",
             dict(learning_rate=0.05, grad_clip=N.ClipGradByValue(0.01))),
            ("RMSProp + ClipGradByNorm", "RMSProp",
             dict(learning_rate=0.01, grad_clip=N.ClipGradByNorm(0.1)))]


def captured_equals_eager(dev, label, cls, kw, steps=3):
    """A small MLP under ``cls(**kw)`` (its first weight at half the rate),
    ``steps`` calls of ``TrainStep`` (eager, capture and replay, replay)
    against the same ``step_fn`` run eagerly: parameters and slots bitwise
    equal."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.jit import TrainStep

    x = torch.randn(64, 256, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))

    def build():
        torch.manual_seed(0)
        net = torch.nn.Sequential(torch.nn.Linear(256, 512),
                                  torch.nn.GELU(),
                                  torch.nn.Linear(512, 256)).to(dev)
        net[0].weight.optimize_attr = {"learning_rate": 0.5}
        opt = getattr(O, cls)(parameters=net.parameters(), **kw)

        def step_fn(inp):
            loss = (net(inp) - inp).square().mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        return net, opt, step_fn

    ng, og, fg = build()
    ne, oe, fe = build()
    train = TrainStep(fg, ng, og)
    for _ in range(steps):
        train(x)
        fe(x)
    torch.cuda.synchronize()
    sg, se = og.state_dict(), oe.state_dict()
    same = all(torch.equal(a, b) for a, b in
               zip(ng.parameters(), ne.parameters())) and \
        sorted(sg) == sorted(se) and all(
            torch.equal(sg[k], se[k]) if isinstance(sg[k], torch.Tensor)
            else sg[k] == se[k] for k in sg)
    if not same:
        raise AssertionError(f"recipe: {label}: {steps} TrainStep calls "
                             "differ from the eager step")
    return len(sg) - 1


def refusals(dev):
    """A ``step_fn`` that reads the host is refused from its first call,
    twice, with nothing captured; then a good step still captures and
    replays in this process (no capture was left invalidated); a sparse
    embedding takes the dense gradient path under the graph, with a
    ``kernel_fallback`` event naming it (one capture, finite losses).
    Returns the messages."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.profiler import explainer, registry

    lin = torch.nn.Linear(64, 64).to(dev)
    opt = O.SGD(0.1, parameters=lin.parameters())

    def reads_host(x):
        loss = lin(x).square().mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        if float(loss) > 1e9:
            print("large")
        return loss

    registry.reset("jit")
    x = torch.ones(8, 64, device=dev)
    step, said = TrainStep(reads_host, lin, opt), {}
    for _ in range(2):
        try:
            step(x)
        except RuntimeError as e:
            if "could not be captured" not in str(e):
                raise
            said["host_read"] = str(e)[:120]
        else:
            raise AssertionError("refusals: a step that reads the host ran")
    if registry.counters("jit")["train_step_captures"]:
        raise AssertionError("refusals: a refused step was captured")
    captured_equals_eager(dev, "SGD after the refusals", "SGD",
                          dict(learning_rate=0.1))
    emb = torch.nn.Embedding(64, 64, sparse=True).to(dev)
    eopt = O.Adam(0.1, parameters=emb.parameters(), lazy_mode=True)

    def emb_step(ids):
        loss = emb(ids).square().mean()
        loss.backward()
        eopt.step()
        eopt.clear_grad()
        return loss

    n0 = len(explainer.events(kind="kernel_fallback"))
    captures = registry.counters("jit")["train_step_captures"]
    sparse_step = TrainStep(emb_step, emb, eopt)
    ev = explainer.events(kind="kernel_fallback")[n0:]
    ids = torch.tensor([[1, 3, 3, 0], [5, 1, 2, 3]], device=dev)
    losses = [float(sparse_step(ids)) for _ in range(3)]
    if [e["op"] for e in ev] != ["nn.Embedding(sparse=True)"] or \
            registry.counters("jit")["train_step_captures"] != captures + 1 \
            or not all(np.isfinite(losses)):
        raise AssertionError(f"refusals: a sparse embedding under the graph "
                             f"gave events {ev}, losses {losses}")
    said["sparse"] = ev[0]["why"][:120]
    return said


def phase_recipe_graph(dev, preset="gpt3-1.3B", n_layer=2, batch=4,
                       seq_len=2048, steps=4, p=0.1):
    """10b: the GPT-3 recipe (``recipe_setup``) at full width, 2 layers,
    bf16. Without dropout, ``steps`` ``TrainStep`` calls give losses,
    parameters and optimizer slots bitwise equal to the same ``step_fn``
    in an eager loop, the scheduler stepped between calls on both sides
    (a rate baked in at capture would break it from the third step). With
    attention dropout ``p``, each replay's masks (read from the graph's
    own tensors, layer 0) keep ``1 - p`` of the outputs within 0.01,
    scale the kept ones by ``1 / (1 - p)`` exactly, and differ from the
    replay before. Then every optimizer, regularizer and clip of the
    port: a captured step equals its eager step (``optimizer_cases``),
    the steps ``TrainStep`` cannot capture are refused and a sparse
    embedding takes the dense path (``refusals``)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.profiler import registry

    runs = []
    for graph in (True, False):
        model, opt, sched, step_fn = recipe_setup(dev, 0, preset, n_layer,
                                                  seq_len)
        tokens, labels = token_batch(dev, model, batch, seq_len, seed=2)
        train = TrainStep(step_fn, model, opt) if graph else step_fn
        registry.reset("jit")
        losses, rates = [], []
        for _ in range(steps):
            rates.append(sched())
            losses.append(train(tokens, labels).detach().float())
            sched.step()
        torch.cuda.synchronize()
        runs.append((losses, rates, list(model.parameters()),
                     opt.state_dict(), dict(registry.counters("jit"))))
        del train, step_fn
    (lg, rg, pg, sg, jit), (le, re_, pe, se, _) = runs
    same = (all(torch.equal(a, b) for a, b in zip(lg, le))
            and all(torch.equal(a, b) for a, b in zip(pg, pe))
            and all(torch.equal(sg[k], se[k]) for k in sg
                    if isinstance(sg[k], torch.Tensor)))
    if not same or rg != re_ or len(set(rg)) != steps or \
            jit["train_step_captures"] != 1:
        raise AssertionError(f"recipe: graph losses {lg} vs eager {le} "
                             f"(bitwise equal: {same}), rates {rg}, {jit}")
    del runs, pg, pe, sg, se
    free_memory()
    result = {"losses": [float(x) for x in lg], "rates": rg,
              "bitwise": True}

    model, opt, sched, step_fn = recipe_setup(dev, 0, preset, n_layer,
                                              seq_len, attn_dropout=p)
    train = TrainStep(step_fn, model, opt)
    with DropoutRecorder() as rec:
        train(tokens, labels)
        train(tokens, labels)  # captured here
    if len(rec.calls) != n_layer:
        raise AssertionError(f"recipe: {len(rec.calls)} dropout calls "
                             f"captured, want {n_layer}")
    inp, out, _ = rec.calls[0]
    masks, rates = [], []
    for i in range(3):
        if i:
            train(tokens, labels)
        torch.cuda.synchronize()
        keep = out != 0
        rates.append(float(keep.float().mean()))
        want = torch.where(keep, inp / (1.0 - p), torch.zeros_like(inp))
        if abs(rates[-1] - (1 - p)) > 0.01 or not torch.equal(out, want):
            raise AssertionError(f"recipe: replay {i}: keep rate "
                                 f"{rates[-1]:.4f} or the scale is off")
        masks.append(keep.clone())
    changed = [float((a != b).float().mean())
               for a, b in zip(masks, masks[1:])]
    if min(changed) < p:
        raise AssertionError(f"recipe: replays share their dropout masks "
                             f"(changed fractions {changed})")
    result["dropout"] = {"keep_rates": rates, "mask_changed": changed}
    del model, opt, train, rec, inp, out, masks
    free_memory()

    result["optimizers"] = {label: captured_equals_eager(dev, label, cls, kw)
                            for label, cls, kw in optimizer_cases()}
    result["refusals"] = refusals(dev)
    log(f"recipe (graph, {preset} width, {n_layer} layers, bf16): "
        + json.dumps(result))
    return result


def phase_recapture(dev, preset="gpt3-1.3B", n_layer=2, batch=2,
                    seq_len=1024, steps=5):
    """10c: ``mutate_signature:nth=2,mode=aval`` armed over ``steps`` calls
    of the recipe (no dropout) captures once more than an unarmed run,
    with bitwise the same losses. Then a restore taken after 3 steps that
    rebinds every parameter's storage (``p.data = ...``; the optimizer's
    slots and the schedule restored in place) makes the next call capture
    again, and the 2 steps after it equal the 2 the run took from there,
    losses and parameters bitwise."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.testing import faults

    def setup():
        model, opt, sched, step_fn = recipe_setup(dev, 0, preset, n_layer,
                                                  seq_len)
        registry.reset("jit")
        return model, opt, sched, TrainStep(step_fn, model, opt)

    def steps_of(run, n):
        model, _, sched, train = run
        tokens, labels = token_batch(dev, model, batch, seq_len, seed=3)
        losses = []
        for _ in range(n):
            losses.append(train(tokens, labels).float())
            sched.step()
        return losses

    def captures():
        return registry.counters("jit")["train_step_captures"]

    runs = {}
    for spec in (None, "mutate_signature:nth=2,mode=aval"):
        run = setup()
        try:
            if spec:
                faults.configure(spec)
            losses = steps_of(run, steps)
        finally:
            faults.reset()
        runs[spec] = (losses, captures())
        del run
        free_memory()
    (plain, plain_caps), (armed, armed_caps) = runs.values()
    if armed_caps != plain_caps + 1 or not all(
            torch.equal(a, b) for a, b in zip(plain, armed)):
        raise AssertionError(f"recapture: armed {armed_caps} captures, "
                             f"losses {armed}; unarmed {plain_caps}, "
                             f"{plain}")

    run = setup()
    model, opt, sched, _ = run
    steps_of(run, 3)
    snap = ([p.detach().clone() for p in model.parameters()],
            {k: v.clone() if isinstance(v, torch.Tensor) else v
             for k, v in opt.state_dict().items()},
            sched.state_dict(), sched.lr_sched.state_dict())
    want = steps_of(run, 2)
    want_params = [p.detach().clone() for p in model.parameters()]
    before = captures()
    with torch.no_grad():
        for p, v in zip(model.parameters(), snap[0]):
            p.data = v.clone()
    opt.set_state_dict(snap[1])
    sched.set_state_dict(snap[2])
    sched.lr_sched.set_state_dict(snap[3])
    got = steps_of(run, 2)
    recaptured = captures() - before
    same = all(torch.equal(a, b) for a, b in zip(got, want)) and all(
        torch.equal(a, b) for a, b in zip(model.parameters(), want_params))
    if recaptured != 1 or not same:
        raise AssertionError(f"recapture: after a rebinding restore "
                             f"{recaptured} captures, losses {got} vs "
                             f"{want} (parameters equal: {same})")
    result = {"mutate_signature_captures": [plain_caps, armed_caps],
              "losses": [float(x) for x in plain],
              "restore_recaptures": recaptured,
              "resumed_losses": [float(x) for x in got]}
    log("recapture: " + json.dumps(result))
    del run, model, opt, snap
    free_memory()
    return result


# -------------------------------------------- Model.fit, AMP, the scaler --
def fit_dataset(vocab, n_seq=8, repeats=4, seq_len=2048, seed=0):
    """``n_seq`` distinct ``seq_len + 1``-token sequences (numpy, ``seed``),
    each ``repeats`` times, as an ``io.TensorDataset`` of (inputs, next
    tokens): a dataset whose loss can fall within one epoch."""
    from paddle_tpu_torch import io

    seqs = np.random.default_rng(seed).integers(0, vocab,
                                                (n_seq, seq_len + 1))
    rows = np.tile(np.arange(n_seq), repeats)
    return io.TensorDataset([seqs[rows, :-1], seqs[rows, 1:]])


def fit_model(dev, n_layer=None, seed=0, lr=1e-4, preset="gpt3-1.3B"):
    """``preset`` at full width (``n_layer`` cut when given) with
    float32 parameters from ``seed``, dropout 0, behind ``hapi.Model``
    prepared with ``AdamW(lr)``, ``GPTPretrainingCriterion`` and
    ``amp_configs="O1"``. Returns ``(cfg, model)``."""
    from paddle_tpu_torch import hapi
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel,
                                             GPTPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW

    over = {} if n_layer is None else {"n_layer": n_layer}
    cfg = GPTConfig.preset(preset, dropout=0.0, attn_dropout=0.0, **over)
    net = GPTForPretraining(GPTModel(
        cfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed)))
    model = hapi.Model(net)
    model.prepare(AdamW(learning_rate=lr, parameters=net.parameters()),
                  GPTPretrainingCriterion(), amp_configs="O1")
    return cfg, model


def batch_recorder():
    """A ``hapi`` callback keeping each batch's logged loss and host time
    (``on_train_batch_begin`` to ``_end``: the step, its host read of the
    loss included, the wait for the batch not)."""
    from paddle_tpu_torch.callbacks import Callback

    class Recorder(Callback):
        def __init__(self):
            self.losses, self.seconds = [], []

        def on_train_batch_begin(self, step, logs=None):
            self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.seconds.append(time.perf_counter() - self._t0)
            self.losses.append(logs["loss"])

    return Recorder()


def worker_import_s():
    """Seconds a fresh interpreter takes to load the DataLoader's worker
    file as a worker does (by path: the standard library and numpy, no
    torch): the fixed share of a worker's start."""
    code = ("import time; t = time.perf_counter(); import runpy; "
            "runpy.run_path('paddle_tpu_torch/io/_worker.py'); "
            "print(time.perf_counter() - t)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    return float(out.stdout.strip().splitlines()[-1])


def phase_fit(dev, train_step_ms, batches=8, batch=4, seq_len=2048,
              workers=2):
    """11: ``hapi.Model(GPTForPretraining).prepare(AdamW,
    GPTPretrainingCriterion, amp_configs="O1").fit(DataLoader(...,
    shuffle=True, num_workers=2))`` at gpt3-1.3B, full width and depth,
    float32 parameters: one epoch of ``batches`` batches of ``batch`` x
    ``seq_len`` over 8 distinct sequences each seen 4 times. Checks: one
    TrainStep capture; K1-K3 ``batches`` x 24 each on the card's count,
    all on the bf16 instance and none on float32; every logged loss
    finite and the last below the first; every batch from the workers,
    none of which initialised CUDA. Reports the p50 host time of a batch
    beside phase 7's graph step (``train_step_ms``), tokens/s and MFU at
    that p50, peak memory, ``dataloader.wait`` and ``worker_busy``, the
    workers' start (to their first batch) in the first epoch and in a
    second iteration of the loader, and what importing the worker module
    costs a fresh interpreter."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.profiler import registry

    t0 = time.perf_counter()
    cfg, model = fit_model(dev)
    built_s = time.perf_counter() - t0
    ds = fit_dataset(cfg.vocab_size, repeats=batches * batch // 8,
                     seq_len=seq_len)
    loader = io.DataLoader(ds, batch_size=batch, shuffle=True,
                           num_workers=workers)
    rec = batch_recorder()
    for scope in ("jit", "dataloader", "timings", "kernels"):
        registry.reset(scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_device_launches()
    np.random.seed(0)
    t0 = time.perf_counter()
    hist = model.fit(loader, epochs=1, verbose=0, callbacks=[rec])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = fa.device_launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    jit = dict(registry.counters("jit"))
    dl = dict(registry.counters("dataloader"))
    timings = registry.timings("timings")
    # a second epoch's workers fork from the fork server, which imported
    # numpy once for the first
    registry.reset("timings")
    next(iter(loader))
    restart_s = registry.timings("timings")[
        "timings.dataloader.worker_start"]["total_s"]
    n_layer = cfg.n_layer
    if model.network.gpt.attn_kernel != "cuda":
        raise AssertionError(f"fit: attention route "
                             f"{model.network.gpt.attn_kernel!r}")
    if jit["train_step_captures"] != 1:
        raise AssertionError(f"fit: TrainStep counters {jit}, want one "
                             "capture")
    for name in FLASH_KERNELS:
        got = counts["by_dtype"]["bfloat16"][name]
        if got != batches * n_layer or counts["by_dtype"]["float32"][name]:
            raise AssertionError(
                f"fit: the card counted {counts['by_dtype']} launches, want "
                f"{batches} x {n_layer} of each kernel on bf16, 0 on float32")
    if len(rec.losses) != batches or not all(np.isfinite(rec.losses)) or \
            not rec.losses[-1] < rec.losses[0]:
        raise AssertionError(f"fit: losses {rec.losses} are not finite and "
                             "falling")
    if dl.get("worker_batches") != batches or dl.get("worker_cuda_inits") \
            or dl.get("worker_torch_imports"):
        raise AssertionError(f"fit: dataloader counters {dl} (no worker "
                             "may initialise CUDA or import torch)")
    steady = rec.seconds[2:]  # after the eager call and the capture
    p50_s = _median(steady)
    tokens = batch * seq_len
    result = {
        "preset": "gpt3-1.3B", "params": "float32", "amp": "O1 bf16",
        "batch": batch, "seq_len": seq_len, "batches": batches,
        "workers": workers, "built_s": built_s, "fit_s": fit_s,
        "losses": rec.losses, "history": hist,
        "batch_ms": [s * 1e3 for s in rec.seconds],
        "batch_p50_ms": p50_s * 1e3, "train_step_ms_phase_7": train_step_ms,
        "tokens_per_s": tokens / p50_s,
        "mfu": cfg.flops_per_token() * tokens / p50_s
        / PEAK_FLOPS[torch.bfloat16],
        "peak_memory_gb": peak_gb, "train_step": jit, "dataloader": dl,
        "dataloader_wait_p50_ms": timings["timings.dataloader.wait"][
            "p50_ms"],
        "dataloader_wait_ms": timings["timings.dataloader.wait"],
        "worker_busy_s": timings["timings.dataloader.worker_busy"][
            "total_s"],
        "worker_start_s": timings["timings.dataloader.worker_start"][
            "total_s"],
        "worker_restart_s": restart_s,
        "worker_import_s": worker_import_s(),
        "launches": {k: counts[k] for k in FLASH_KERNELS},
        "launches_by_dtype": counts["by_dtype"]}
    log("fit: " + json.dumps(result))
    del model, loader
    free_memory()
    return result


def _state_of(model):
    return ([p.detach().clone() for p in model.network.parameters()],
            {k: v.clone() for k, v in model._optimizer.state_dict().items()
             if isinstance(v, torch.Tensor)})


def phase_fit_resume(dev, n_layer=2, batch=4, seq_len=2048):
    """11b: full width, ``n_layer`` layers, float32 parameters under O1,
    ``shuffle=False``, attention dropout 0, 4 batches an epoch:
    ``fit(epochs=2, save_dir=A, max_ckpt_to_keep=1)`` against ``fit(epochs=1,
    save_dir=B)`` and then a fresh ``Model(...).fit(epochs=2, save_dir=B,
    resume=True)``: the second epoch's losses, the final parameters and the
    optimizer's slots bitwise equal; A keeps one epoch's files. A torn
    ``.pdparams`` (truncated) is skipped with a ``checkpoint_skip`` record
    and the run resumes from the epoch before. ``nan_loss:step=3`` armed
    gives a NaN loss at that batch, and training goes on."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.profiler import explainer
    from paddle_tpu_torch.testing import faults

    def run(save_dir=None, epochs=1, resume=False, **kw):
        cfg, model = fit_model(dev, n_layer=n_layer)
        ds = fit_dataset(cfg.vocab_size, repeats=2, seq_len=seq_len)
        rec = batch_recorder()
        t0 = time.perf_counter()
        model.fit(io.DataLoader(ds, batch_size=batch, shuffle=False),
                  epochs=epochs, save_dir=save_dir, resume=resume, verbose=0,
                  callbacks=[rec], **kw)
        torch.cuda.synchronize()
        return model, rec.losses, time.perf_counter() - t0

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_fit_"))
    try:
        a, b = str(root / "a"), str(root / "b")
        full, full_losses, full_s = run(a, epochs=2, max_ckpt_to_keep=1)
        want = _state_of(full)
        del full
        free_memory()
        kept = sorted(os.listdir(a))
        if kept != ["1.pdmeta", "1.pdopt", "1.pdparams"]:
            raise AssertionError(f"fit resume: max_ckpt_to_keep=1 left {kept}")
        _, first_losses, _ = run(b, epochs=1)
        resumed, resumed_losses, resumed_s = run(b, epochs=2, resume=True)
        got = _state_of(resumed)
        del resumed
        free_memory()
        params_equal = all(torch.equal(x, y) for x, y in zip(got[0],
                                                               want[0]))
        slots_equal = got[1].keys() == want[1].keys() and all(
            torch.equal(got[1][k], want[1][k]) for k in want[1])
        if resumed_losses != full_losses[4:] or first_losses != \
                full_losses[:4] or not params_equal or not slots_equal:
            raise AssertionError(
                f"fit resume: losses {first_losses} + {resumed_losses} vs "
                f"{full_losses}; parameters equal {params_equal}, slots "
                f"equal {slots_equal}")
        ckpt_bytes = sum((Path(b) / f).stat().st_size
                         for f in os.listdir(b) if f.startswith("1."))
        with open(os.path.join(b, "1.pdparams"), "r+b") as f:
            f.truncate(4096)
        n_skip = len(explainer.events(kind="checkpoint_skip"))
        _, torn_losses, _ = run(b, epochs=1, resume=True)
        skips = explainer.events(kind="checkpoint_skip")[n_skip:]
        restored = explainer.events(kind="checkpoint_restore")[-1]
        if len(skips) != 1 or skips[0]["epoch"] != 1 or torn_losses or \
                restored["epoch"] != 0:
            raise AssertionError(f"fit resume: a torn checkpoint gave skips "
                                 f"{skips}, restore {restored}, losses "
                                 f"{torn_losses}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    faults.configure("nan_loss:step=3")
    try:
        model, nan_losses, _ = run(epochs=1)
    finally:
        faults.reset()
    finite = all(torch.isfinite(p).all() for p in model.network.parameters())
    if not (len(nan_losses) == 4 and np.isnan(nan_losses[3])
            and np.isfinite(nan_losses[:3]).all() and finite):
        raise AssertionError(f"fit resume: nan_loss gave {nan_losses}, "
                             f"parameters finite {finite}")
    del model
    free_memory()
    result = {"n_layer": n_layer, "losses": full_losses,
              "resumed_losses": resumed_losses, "bitwise": True,
              "checkpoint_gb": ckpt_bytes / 1e9,
              "fit_2_epochs_s": full_s, "resumed_fit_s": resumed_s,
              "torn_skipped_epoch": skips[0]["epoch"],
              "nan_loss_losses": nan_losses}
    log("fit resume: " + json.dumps(result))
    return result


def phase_fp16_scaler(dev, n_layer=2, batch=4, seq_len=2048, steps=4):
    """11c: full width, ``n_layer`` layers, float32 parameters: ``steps``
    eager steps under ``auto_cast(dtype="float16")`` with ``GradScaler``:
    the losses finite, the attention on the plain route with a
    ``kernel_fallback`` record naming float16 (the kernels take float32
    and bf16, as the reference's), K1 not launched. Then a step whose
    gradient is set to inf before ``scaler.step``: the parameters bitwise
    unchanged and the scale halved. Then a ``step_fn`` calling
    ``scaler.step`` under ``TrainStep``: refused before anything is
    captured."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.profiler import explainer, registry

    cfg, model = fit_model(dev, n_layer=n_layer)
    net, opt, crit = model.network, model._optimizer, model._loss
    scaler = amp.GradScaler()
    tokens, labels = token_batch(dev, net, batch, seq_len, seed=5)

    def step_fn(x, y):
        with amp.auto_cast(dtype="float16"):
            loss = crit(net(x), y)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return loss

    torch.cuda.synchronize()
    fa.reset_device_launches()
    n_fb = len(explainer.events(kind="kernel_fallback"))
    losses, scales, times = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step_fn(tokens, labels).detach()))
        times.append(time.perf_counter() - t0)
        scales.append(scaler._scale)
    fallbacks = explainer.events(kind="kernel_fallback")[n_fb:]
    k1 = fa.device_launches()["flash_fwd"]
    if not all(np.isfinite(losses)) or k1 or \
            len(fallbacks) != steps * n_layer or \
            not all("float16" in e["why"] for e in fallbacks):
        raise AssertionError(f"fp16: losses {losses}, K1 launches {k1}, "
                             f"fallback records {fallbacks[-2:]} "
                             f"({len(fallbacks)})")
    with amp.auto_cast(dtype="float16"):
        loss = crit(net(tokens), labels)
    scaler.scale(loss).backward()
    next(net.parameters()).grad.fill_(float("inf"))
    before = [p.detach().clone() for p in net.parameters()]
    scale = scaler._scale
    scaler.step(opt)
    scaler.update()
    opt.clear_grad()
    unchanged = all(torch.equal(a, p) for a, p in zip(before,
                                                       net.parameters()))
    if not unchanged or scaler._scale != scale / 2:
        raise AssertionError(f"fp16: the inf step changed the parameters "
                             f"({not unchanged}) or the scale {scale} -> "
                             f"{scaler._scale}")
    registry.reset("jit")
    try:
        TrainStep(step_fn, net, opt)(tokens, labels)
    except RuntimeError as e:
        if "could not be captured" not in str(e):
            raise
        refusal = str(e).split("(")[0]
    else:
        raise AssertionError("fp16: TrainStep captured a step that calls "
                             "scaler.step")
    if registry.counters("jit")["train_step_captures"]:
        raise AssertionError("fp16: the refused step was captured")
    opt.clear_grad()
    result = {"n_layer": n_layer, "losses": losses, "scales": scales,
              "step_ms": [t * 1e3 for t in times],
              "fallback_why": fallbacks[0]["why"], "k1_launches": k1,
              "inf_step": {"parameters_unchanged": True,
                           "scale": [scale, scaler._scale]},
              "train_step_refusal": refusal}
    log("fp16 scaler: " + json.dumps(result))
    del model, net, opt
    free_memory()
    return result


# --------------------------------------------------------- train -> serve --
def phase_train_to_serve(dev, trained, step, preset="gpt3-1.3B",
                         dtype="bfloat16", max_batch_size=8, block_size=16,
                         prompt_len=64, new_tokens=64, interval=0.2):
    """7b: phase 7's trained model saved with ``save_checkpoint`` (model
    state only, float32 on disk) into a temporary directory; a server on
    the seed-0 weights, answering a stream of requests, follows the
    directory (``watch_checkpoints``) and swaps the checkpoint in mid-flight
    with no failed request; its greedy tokens then equal a fresh server's
    built on the trained model itself."""
    from paddle_tpu_torch.incubate import checkpoint as ckpt
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import GenerationServer

    cfg = GPTConfig.preset(preset, dtype=dtype)
    base = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        log(f"train->serve: {shutil.disk_usage(base).free / 1e9:.1f} GB "
            f"free under {os.path.dirname(base)}")
        t_ck = registry.timings("checkpoint")
        t0 = time.perf_counter()
        ckpt.save_checkpoint(base, ckpt.capture_training_state(trained),
                             step)
        save_s = time.perf_counter() - t0
        t_ck1 = registry.timings("checkpoint")
        payload = Path(base, f"ckpt-{step:08d}", "data-rank00000.pkl")
        result = {
            "step": step, "bytes": payload.stat().st_size, "save_s": save_s,
            "snapshot_s": t_ck1["checkpoint.save.snapshot"]["total_s"]
            - t_ck.get("checkpoint.save.snapshot", {"total_s": 0})["total_s"],
            "pickle_crc_write_fsync_s":
            t_ck1["checkpoint.save.write"]["total_s"]
            - t_ck.get("checkpoint.save.write", {"total_s": 0})["total_s"]}

        srv = GenerationServer(GPTForPretraining(GPTModel(
            cfg, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))),
            max_batch_size=max_batch_size, block_size=block_size,
            max_queue_size=64, device=dev).start()
        try:
            srv.generate(list(range(1, 40)), max_new_tokens=4)
            c0, sw0 = registry.counters("serving"), swap_timings()
            rng = np.random.default_rng(7)
            handles = []

            def feed():
                while srv.scheduler.queued() < max_batch_size:
                    handles.append(srv.submit(
                        rng.integers(0, cfg.vocab_size, prompt_len).tolist(),
                        max_new_tokens=new_tokens, seed=len(handles)))

            t0 = time.perf_counter()
            srv.watch_checkpoints(base, interval=interval)
            while srv.last_swap_step != step:
                err = srv.scheduler.last_swap_error
                if err is not None or time.perf_counter() - t0 > 600:
                    raise AssertionError(f"train->serve: the follower did "
                                         f"not swap in 600 s ({err!r})")
                feed()
                time.sleep(0.005)
            follow_s = time.perf_counter() - t0
            in_flight = srv.scheduler.active()
            feed()
            for h in handles:
                h.result(timeout=600)
            c1, sw1 = registry.counters("serving"), swap_timings()
            bad = [h for h in handles if h.status != "done"
                   or len(h.tokens) != new_tokens]
            if bad or c1["requests_failed"] != c0["requests_failed"] or \
                    c1["weight_swaps"] != c0["weight_swaps"] + 1 or \
                    c1["decode_compiles"] != c0["decode_compiles"]:
                raise AssertionError(
                    f"train->serve: {len(bad)} requests unfinished, "
                    f"counters {c0} -> {c1}")
            reqs = greedy_requests(cfg.vocab_size, 5)
            got = [h.result(timeout=600).tokens
                   for h in [srv.submit(p, **o) for p, o in reqs]]
        finally:
            srv.shutdown(timeout=600)
        del srv
        free_memory()
        fresh = GenerationServer(trained, max_batch_size=max_batch_size,
                                 block_size=block_size, max_queue_size=64,
                                 device=dev).start()
        try:
            want = [h.result(timeout=600).tokens
                    for h in [fresh.submit(p, **o) for p, o in reqs]]
        finally:
            fresh.shutdown(timeout=600)
        if got != want:
            raise AssertionError("train->serve: the follower's tokens differ "
                                 "from a fresh server's on the trained model")
        result.update({
            "follow_load_and_swap_s": follow_s,
            "swap_stage_s": sw1["stage"] - sw0["stage"],
            "swap_commit_s": sw1["commit"] - sw0["commit"],
            "requests_served_across": len(handles),
            "requests_in_flight_at_swap": in_flight,
            "greedy_tokens_equal_fresh_server": True})
        log("train->serve: " + json.dumps(result))
        return result
    finally:
        shutil.rmtree(base, ignore_errors=True)
        free_memory()


def phase_train_state_round_trip(dev, preset="gpt3-1.3B", n_layer=2,
                                 seq_len=2048, batch=4, before=3, after=2):
    """7b: the whole training state (model, AdamW moments and master
    weights, step count, LR schedule) through a checkpoint at full width
    and 2 layers: saved after ``before`` steps, restored into a fresh
    model and optimizer, then ``after`` steps whose losses, parameters and
    optimizer slots must equal the uninterrupted run's, bitwise."""
    from paddle_tpu_torch.incubate import checkpoint as ckpt
    from paddle_tpu_torch.optimizer.lr import CosineAnnealingDecay

    def setup(seed):
        sched = CosineAnnealingDecay(1e-4, T_max=10)
        out = training_setup(dev, preset, batch, seq_len, seed=seed,
                             learning_rate=sched, n_layer=n_layer)
        return (sched,) + out

    def steps(run, n):
        sched, _, _, _, train, tokens, labels = run
        losses = []
        for _ in range(n):
            losses.append(float(train(tokens, labels).detach()))
            sched.step()
        return losses

    base = tempfile.mkdtemp(prefix="chip_smoke_state_")
    try:
        run = setup(0)
        steps(run, before)
        ckpt.save_checkpoint(base, ckpt.capture_training_state(run[2],
                                                               run[3]),
                             before - 1)
        want = steps(run, after)
        state, man = ckpt.load_latest(base)
        resumed = setup(5)
        ckpt.restore_training_state(resumed[2], resumed[3], state)
        got = steps(resumed, after)
        opt_step = resumed[3]._opt_step
        pairs = list(zip(run[2].parameters(), resumed[2].parameters()))
        a, b = run[3].state_dict(), resumed[3].state_dict()
        pairs += [(a[k], b[k]) for k in a if isinstance(a[k], torch.Tensor)]
        same = all(torch.equal(x, y) for x, y in pairs)
        lr = (run[0](), resumed[0]())
    finally:
        shutil.rmtree(base, ignore_errors=True)
    if got != want or not same or opt_step != before + after or \
            lr[0] != lr[1]:
        raise AssertionError(
            f"training state round trip: losses {got} vs {want}, "
            f"parameters and slots equal: {same}, step count {opt_step}, "
            f"learning rates {lr}")
    log(f"train->serve: training state of {preset} (n_layer={n_layer}, "
        f"bf16, AdamW with master weights, cosine LR) through checkpoint "
        f"step {man['step']}: {after} resumed steps equal the uninterrupted "
        f"run's bitwise (losses {got}, {len(pairs)} parameters and slots)")
    free_memory()
    return got


def _parity_models(dev, preset, n_layer, seq_len, batch, dtype):
    """Two copies of one seeded model, on the kernel route and on the plain
    route, a batch from seed 1 and the criterion."""
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel,
                                             GPTPretrainingCriterion)

    cfg = GPTConfig.preset(preset, n_layer=n_layer, seq_len=seq_len,
                           dtype=dtype)
    models = [GPTForPretraining(GPTModel(
        cfg, device=dev, attn_kernel=kind,
        generator=torch.Generator(device=dev).manual_seed(1)))
        for kind in ("cuda", "torch")]
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (batch, seq_len))
    tokens = torch.from_numpy(toks).to(dev)
    labels = torch.from_numpy(np.roll(toks, -1, axis=1)).to(dev)
    return cfg, models, tokens, labels, GPTPretrainingCriterion()


# --------------------------------------------------------------- serving --
def serving_requests(vocab, n=16, seed=0):
    """16 prompts of 16..1000 tokens; four share a 256-token prefix; half
    greedy, half temperature 0.8 / top_p 0.9; 32 new tokens each."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 256).tolist()
    out = []
    for i in range(n):
        if i % 4 == 1:
            prompt = shared + rng.integers(0, vocab, int(
                rng.integers(16, 500))).tolist()
        else:
            prompt = rng.integers(0, vocab, int(
                rng.integers(16, 1001))).tolist()
        opts = dict(max_new_tokens=32, seed=i)
        if i % 2:
            opts.update(temperature=0.8, top_p=0.9)
        out.append((prompt, opts))
    return out


_SPLIT = re.compile(r"paged_attention_split_kernel<[^,>]+, ?(\d+), ?(\d+)>")


def profile_steps(step, n):
    """Run ``step()`` ``n`` times under torch.profiler and count what the
    card ran: ``{"split": {(Dh, rows of the instance): launches of K4's
    split pass}, "combine": launches of its combine, "kernels": every
    kernel, "graph_launches": cudaGraphLaunch calls, "kernel_launches":
    kernel launch calls made from the host, "device_ms": the kernels'
    summed durations}``. CUPTI reports each kernel of a replayed CUDA graph
    as its own activity, so the kernels inside the graph are counted one
    by one."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    out = {"split": {}, "combine": 0, "kernels": 0, "graph_launches": 0,
           "kernel_launches": 0, "host_syncs": {}, "device_ms": 0.0}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out["kernels"] += 1
            out["device_ms"] += (e.time_range.end - e.time_range.start) / 1e3
            m = _SPLIT.search(e.name)
            if m:
                key = (int(m.group(1)), int(m.group(2)))
                out["split"][key] = out["split"].get(key, 0) + 1
            elif "paged_attention_combine_kernel" in e.name:
                out["combine"] += 1
        elif e.name == "cudaGraphLaunch":
            out["graph_launches"] += 1
        elif e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                        "cuLaunchKernel", "cuLaunchKernelEx"):
            out["kernel_launches"] += 1
        elif e.name in _SYNCS:
            out["host_syncs"][e.name] = out["host_syncs"].get(e.name, 0) + 1
    return out


# host calls that wait for the card (the profile's own final synchronize
# counts one cudaDeviceSynchronize)
_SYNCS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
          "cudaEventSynchronize", "cudaStreamWaitEvent")


def fill_slots(engine, vocab, n_slots, prompt_len=512, seed=5):
    """Admit ``n_slots`` prompts of random tokens into an idle engine."""
    rng = np.random.default_rng(seed)
    for slot in range(n_slots):
        engine.prefill(slot, rng.integers(0, vocab, prompt_len).tolist(),
                       seed=slot, max_new_tokens=64)


def free_memory():
    """Drop what a phase left: an engine and its captured graphs refer to
    each other, so they go with a collection."""
    gc.collect()
    torch.cuda.empty_cache()


class BucketLog:
    """Test instrumentation: the prompt buckets an engine's prefills use,
    recorded where its prefill looks its bucket up
    (``GenerationEngine._prefill_bucket``, the target's prefill only)."""

    def __init__(self, engine):
        self.used = set()
        self._orig = engine._prefill_bucket
        engine._prefill_bucket = self

    def __call__(self, L):
        self.used.add(L)
        return self._orig(L)


class PrefillLogits:
    """Test instrumentation: each prefill's first-token logits
    (``engine.last_prefill_logits``, float32, the whole vocabulary), kept
    on the device by prompt, its token, and the prompt each slot was
    given, where ``engine.prefill`` is called."""

    def __init__(self, engine):
        self.by_prompt = {}
        self.tokens = []
        self.slots = {}
        self._engine = engine
        self._orig = engine.prefill
        engine.prefill = self

    def __call__(self, slot, prompt_ids, **kw):
        tok = self._orig(slot, prompt_ids, **kw)
        prompt = tuple(int(t) for t in prompt_ids)
        self.by_prompt[prompt] = self._engine.last_prefill_logits[0].clone()
        self.tokens.append(int(tok))
        self.slots[slot] = prompt
        return tok

    def of(self, prompts):
        """The host copies for ``prompts``, in order."""
        return [self.by_prompt[tuple(p)].cpu() for p in prompts]


def serve(srv, reqs, vocab):
    """Serve ``reqs`` after a warm-up: one request whose decode step
    captures the engine's decode graphs, then one single-token request per
    prompt bucket up to the mix's longest prompt, whose prefills capture
    the buckets' graphs, so the timed window captures nothing. Returns the
    handles, the wall time and the counters, graph replays and K4's
    launches as the card counted them (``counts["device"]``, per instance)
    of the timed window, with the prefill buckets used
    (``counts["prefill_buckets"]``, warm-up and window) and the captures at
    warm-up of the target's and a spec drafter's prefill buckets."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving.engine import StepGraph

    eng = srv.engine
    graphs = {a: g for a, g in vars(eng).items()
              if isinstance(g, StepGraph)}
    buckets = BucketLog(eng)

    c0 = registry.counters("serving")
    srv.generate(list(range(1, 40)), max_new_tokens=4)
    top = eng.bucket_for(max(len(p) for p, _ in reqs))
    rng = np.random.default_rng(99)
    for b in eng.buckets:
        if b <= top:
            srv.generate(rng.integers(0, vocab, b - 1).tolist(),
                         max_new_tokens=1)
    c1 = registry.counters("serving")
    compiles = c1["decode_compiles"] - c0["decode_compiles"]
    prefill_captures = c1["prefill_compiles"] - c0["prefill_compiles"]
    draft_captures = c1["draft_prefill_compiles"] \
        - c0["draft_prefill_compiles"]
    for scope in ("kernels", "serving", "fastpath"):
        registry.reset(scope)
    pa.reset_device_launches()
    replays = {a: g.replays for a, g in graphs.items()}
    t0 = time.perf_counter()
    handles = [srv.submit(p, **o) for p, o in reqs]
    for h in handles:
        h.result(timeout=600)
    wall = time.perf_counter() - t0
    bad = [h for h in handles if h.status != "done"
           or len(h.tokens) != h.max_new_tokens]
    if bad:
        raise AssertionError(f"unfinished requests {bad}")
    toks = [t for h in handles for t in h.tokens]
    if not all(0 <= t < vocab for t in toks):
        raise AssertionError("token id out of range")
    counts = {scope: registry.counters(scope)
              for scope in ("kernels", "serving", "fastpath")}
    counts["device"] = pa.device_launches()
    counts["captures_at_warmup"] = compiles
    counts["prefill_captures_at_warmup"] = prefill_captures
    counts["draft_prefill_captures_at_warmup"] = draft_captures
    counts["prefill_buckets"] = sorted(buckets.used)
    del eng._prefill_bucket  # the instrumentation goes
    counts["replays"] = {a: g.replays - replays[a] for a, g in graphs.items()}
    ttft = sorted(h.ttft_s for h in handles)
    step_t = registry.timings("serving")["serving.decode_step"]
    return handles, wall, counts, {
        "requests": len(handles), "tokens": len(toks), "wall_s": wall,
        "tokens_per_s": len(toks) / wall,
        "ttft_p50_ms": ttft[len(ttft) // 2] * 1e3,
        "decode_step_p50_ms": step_t["p50_ms"]}


def instance_name(key):
    """``"bfloat16 Dh=64 rows=1"`` for a K4 instance ``(dtype, Dh, rows)``
    of ``paged_attention.device_launches``."""
    return f"{key[0]} Dh={key[1]} rows={key[2]}"


def check_device_launches(what, counts, want):
    """K4's launches as the card counted them over the timed window, per
    instance, against ``want``; the Python counter (replays x the launches
    a capture recorded) must sum to the same."""
    got = counts["device"]
    derived = counts["kernels"]["paged_attention"]
    named = {instance_name(k): v for k, v in got.items()}
    if got != want or sum(got.values()) != derived:
        raise AssertionError(
            f"{what}: the card counted K4 launches {named}; want "
            f"{dict((instance_name(k), v) for k, v in want.items())}, and "
            f"{derived} by the replay count")
    return named


def weights_sum(model):
    """The sum of every parameter in float64: two phases that build the
    same model from one seed must agree on it."""
    return float(sum(p.sum(dtype=torch.float64) for p in model.parameters()))


def check_fast_path(what, counts, captures):
    """One capture per graph at warm-up and none after; steady steps
    outnumber rebuilds; no demotion. One prefill graph captured per
    distinct bucket its prompts used, all at warm-up."""
    fp = counts["fastpath"]
    if counts["prefill_captures_at_warmup"] != \
            len(counts["prefill_buckets"]) or \
            counts["serving"]["prefill_compiles"]:
        raise AssertionError(
            f"{what}: {counts['prefill_captures_at_warmup']} prefill "
            f"graphs captured at warm-up and "
            f"{counts['serving']['prefill_compiles']} after it, for the "
            f"buckets {counts['prefill_buckets']}")
    if counts["captures_at_warmup"] != captures or \
            counts["serving"]["decode_compiles"]:
        raise AssertionError(
            f"{what}: {counts['captures_at_warmup']} graph captures at "
            f"warm-up (want {captures}) and "
            f"{counts['serving']['decode_compiles']} after it (want 0)")
    if not fp["decode_fast_steps"] > fp["decode_rebuilds"] or \
            fp["decode_demotions"]:
        raise AssertionError(f"{what}: fast path {fp}")


def phase_serving(dev, preset="gpt3-1.3B", dtype="bfloat16",
                  max_batch_size=8, block_size=16, n_requests=16,
                  profiled_steps=4, model=None, **cfg_over):
    """Phase 4 (and 9's serving): ``model`` (built here from seed 0 when
    None, and dropped after) behind a ``GenerationServer``."""
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)
    from paddle_tpu_torch.serving import GenerationServer

    cfg = GPTConfig.preset(preset, dtype=dtype, **cfg_over)
    t0 = time.perf_counter()
    if model is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        model = GPTForPretraining(GPTModel(cfg, device=dev, generator=gen))
    srv = GenerationServer(model, max_batch_size=max_batch_size,
                           block_size=block_size, max_queue_size=64,
                           device=dev)
    eng = srv.engine
    what = "moe serving" if cfg.moe_num_experts else "serving"
    log(f"{what}: {preset} {dtype} n_layer={cfg.n_layer} built in "
        f"{time.perf_counter() - t0:.1f} s; paged kernel "
        f"{eng.paged_kernel!r}")
    first = PrefillLogits(eng)
    reqs = serving_requests(cfg.vocab_size, n=n_requests)
    try:
        handles, wall, counts, result = serve(srv, reqs, cfg.vocab_size)
    finally:
        srv.shutdown()
        del eng.prefill  # the instrumentation goes
    launches = counts["kernels"]
    steps = counts["serving"]["decode_steps"]
    want = steps * cfg.n_layer
    head_dim = cfg.d_model // cfg.n_head
    if eng.paged_kernel != "cuda":
        raise AssertionError(f"serving: the engine resolved "
                             f"{eng.paged_kernel!r} on the card")
    check_fast_path("serving", counts, captures=1)
    if launches["paged_attention"] != want or steps == 0:
        raise AssertionError(
            f"serving: {launches['paged_attention']} kernel launches for "
            f"{steps} decode steps x {cfg.n_layer} layers = {want}")
    if launches["paged_attention_ref"]:
        raise AssertionError(f"serving: the plain version ran "
                             f"{launches['paged_attention_ref']} times")
    device = check_device_launches("serving", counts,
                                   {(dtype, head_dim, 1): want})
    if counts["serving"]["prefix_hits"] < 3:
        raise AssertionError(
            f"serving: {counts['serving']['prefix_hits']} prefix hits for "
            "four requests sharing a 256-token prefix")
    eng.pool.audit()

    # the launches inside the graph, seen by the profiler: steady replays
    # of a full batch, after the rebuild that admitting it asks for
    fill_slots(eng, cfg.vocab_size, max_batch_size)
    eng.decode_step()
    prof = profile_steps(eng.decode_step, profiled_steps)
    split = prof["split"].get((head_dim, 1), 0)
    if split != cfg.n_layer * profiled_steps or \
            prof["combine"] != split or prof["graph_launches"] != \
            profiled_steps or prof["kernel_launches"]:
        raise AssertionError(
            f"serving: over {profiled_steps} steady steps the profiler saw "
            f"{prof}; want {cfg.n_layer * profiled_steps} split passes and "
            f"combines, {profiled_steps} graph launches and no kernel "
            "launched from the host")
    result.update({
        "decode_steps": steps, "prefix_hits":
        counts["serving"]["prefix_hits"], "launches": launches,
        "prefill_buckets": counts["prefill_buckets"],
        "prefill_graphs": counts["prefill_captures_at_warmup"],
        "device_launches": device,
        "decode_launches": counts["device"][(dtype, head_dim, 1)],
        "fastpath": counts["fastpath"], "graph_captures": 1,
        "profiled_steps": profiled_steps,
        "profiled": {"split_passes": split, "combines": prof["combine"],
                     "kernels_per_step": prof["kernels"] / profiled_steps,
                     "graph_launches": prof["graph_launches"],
                     "host_kernel_launches": prof["kernel_launches"]}})
    log(f"{what}: " + json.dumps(result))
    plain = {"tokens": [h.tokens for h in handles],
             "greedy": [not o.get("temperature") for _, o in
                        serving_requests(cfg.vocab_size, n=n_requests)],
             "weights_sum": weights_sum(model),
             "first_logits": first.of([p for p, _ in reqs]),
             "base_key": eng._base_key.clone()}
    del srv, eng, model
    free_memory()
    return result, plain


def _spec_run(engine, prompt, n, **opts):
    out = [engine.prefill(0, prompt, **opts)]
    step = getattr(engine, "decode_step_spec", None)
    while len(out) < n:
        out.extend(step()[0] if step else [int(engine.decode_step()[0])])
    engine.release(0)
    return out[:n]


def phase_parity(dev, preset="gpt3-1.3B", n_layer=2, steps=8,
                 tol=(1e-3, 1e-3), draft_k=4, spec_tokens=24,
                 zero_gate=False, **cfg_over):
    """One request through a kernel engine and a plain engine sharing one
    float32 model, both replaying their captured steps. Tolerance: float32
    reduction order (kernel vs gather) carried through two layers and the
    50304-wide LM head. Then speculative engines against plain decode on
    the same model: a twin drafter (the same weights) must have every
    draft accepted, and an independent 1-layer drafter must leave the
    tokens as they are; greedy and sampled. ``cfg_over`` may make the
    models MoE (``MOE``), with every gate weight zeroed under
    ``zero_gate``."""
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import DraftVerifyEngine, GenerationEngine

    cfg = GPTConfig.preset(preset, n_layer=n_layer, dtype="float32",
                           **cfg_over)

    def build(seed, layers=n_layer):
        model = build_gpt(dev, seed, preset, n_layer=layers,
                          dtype="float32", **cfg_over)
        return zero_gates(model) if zero_gate else model

    model = build(1)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               333).tolist()
    kinds = ("cuda", "torch")
    engines = [GenerationEngine(model, max_batch_size=2, rng_seed=0,
                                paged_kernel=k, device=dev) for k in kinds]
    toks = [[e.prefill(0, prompt, seed=0)] for e in engines]
    max_err = 0.0
    for _ in range(steps):
        for e, tk in zip(engines, toks):
            tk.append(int(e.decode_step()[0]))
        a, b = (e.last_logits[0] for e in engines)
        max_err = max(max_err, check_close(a, b, tol, "decode logits"))
    if toks[0] != toks[1]:
        raise AssertionError(f"parity: greedy tokens differ {toks}")
    if not all(e._decode_graph.captured for e in engines):
        raise AssertionError("parity: an engine did not capture its step")
    for e in engines:
        e.release(0)
    what = (f"{'zeroed-gate ' if zero_gate else ''}MoE "
            if cfg.moe_num_experts else "")
    log(f"parity: {what}{kinds[0]} vs {kinds[1]} engine (CUDA graphs), "
        f"{cfg.n_layer} layers d_model {cfg.d_model} float32, {steps} "
        f"decode steps: max |logit err| {max_err:.3e} (tol {tol}), greedy "
        "tokens equal")

    plain = engines[0]
    drafters = {"twin": build(1), "independent 1-layer": build(2, 1)}
    spec = {}
    for name, drafter in drafters.items():
        eng = DraftVerifyEngine(model, drafter, draft_k=draft_k,
                                max_batch_size=2, rng_seed=0, device=dev)
        for opts in (dict(seed=0), dict(seed=3, temperature=0.8,
                                        top_p=0.9)):
            c0 = registry.counters("serving")
            got = _spec_run(eng, prompt, spec_tokens, **opts)
            c1 = registry.counters("serving")
            want = _spec_run(plain, prompt, spec_tokens, **opts)
            if got != want:
                raise AssertionError(f"parity: spec ({name} drafter, "
                                     f"{opts}) tokens {got} != plain {want}")
            acc = (c1["spec_accepted"] - c0["spec_accepted"]) / (
                c1["spec_proposed"] - c0["spec_proposed"])
            spec[f"{name} {'greedy' if len(opts) == 1 else 'sampled'}"] = acc
            if name == "twin" and acc != 1.0:
                raise AssertionError(f"parity: twin drafter acceptance "
                                     f"{acc}, want 1.0 ({opts})")
        eng.pool.audit()
        eng.draft_pool.audit()
    log(f"parity: spec engines (K={draft_k}, CUDA graphs) against plain "
        f"decode, {spec_tokens} tokens each: tokens equal; acceptance "
        + ", ".join(f"{k} {v:.3f}" for k, v in spec.items()))
    del engines, plain, eng, drafters, model
    free_memory()
    return max_err


def spec_plain_match(spec_tokens, plain):
    """How far the spec phase's greedy requests follow phase 4's plain
    decode on the same prompts and weights: requests equal, and tokens
    before each request's first difference. (Sampled requests are left
    out: each server draws its own base key.) In bf16 the verify's logits
    (M = B (K+1) rows, K4's 8-row instance) may differ in the last bits
    from decode's (M = B, the 1-row instance), so this is reported, not
    asserted; float32 equality is phase 5's."""
    pairs = [(a, b) for a, b, g in zip(spec_tokens, plain["tokens"],
                                       plain["greedy"]) if g]
    same = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 len(a)) for a, b in pairs]
    return {"greedy_requests": len(pairs),
            "requests_equal": sum(a == b for a, b in pairs),
            "tokens": sum(len(a) for a, _ in pairs),
            "tokens_before_first_difference": sum(same)}


def phase_spec_serving(dev, plain, preset="gpt3-1.3B",
                       draft_preset="gpt2-small", dtype="bfloat16",
                       draft_k=4, max_batch_size=8, block_size=16,
                       n_requests=16, profiled_rounds=3, **cfg_over):
    """Speculative serving at full width: the target verifies through K4 at
    a span of K + 1 rows, the drafter proposes through K4 at one row.
    ``plain``: phase 4's tokens on the same requests and target. The
    drafter's prompt ingestion replays one graph per bucket: each bucket
    the mix used is captured once, at warm-up, and its replay equals its
    body called directly (``check_draft_buckets``)."""
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)
    from paddle_tpu_torch.serving import GenerationServer

    cfg = GPTConfig.preset(preset, dtype=dtype, **cfg_over)
    dcfg = GPTConfig.preset(draft_preset, seq_len=cfg.seq_len, dtype=dtype)
    t0 = time.perf_counter()
    model = GPTForPretraining(GPTModel(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0)))
    drafter = GPTForPretraining(GPTModel(
        dcfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(2)))
    srv = GenerationServer(model, draft_model=drafter, draft_k=draft_k,
                           max_batch_size=max_batch_size,
                           block_size=block_size, max_queue_size=64,
                           device=dev)
    eng = srv.engine
    what = "moe spec" if cfg.moe_num_experts else "spec"
    log(f"{what}: {preset} {dtype} verifying, {draft_preset} drafting "
        f"(n_layer={dcfg.n_layer}, seed 2), K={draft_k}, built in "
        f"{time.perf_counter() - t0:.1f} s; paged kernels "
        f"{eng.paged_kernel!r} / {eng._draft_kernel!r}")
    try:
        handles, wall, counts, result = serve(
            srv, serving_requests(cfg.vocab_size, n=n_requests),
            cfg.vocab_size)
    finally:
        srv.shutdown()
    check_fast_path(what, counts, captures=2)
    # (the CPU, where the script is rehearsed, runs the bodies directly)
    on_card = dev.type == "cuda"
    if counts["draft_prefill_captures_at_warmup"] != \
            len(eng._draft_buckets) * on_card or \
            counts["serving"]["draft_prefill_compiles"] or \
            not all(pb.graph.captured == on_card
                    for pb in eng._draft_buckets.values()):
        raise AssertionError(
            f"{what}: {counts['draft_prefill_captures_at_warmup']} drafter "
            f"prefill graphs captured at warm-up and "
            f"{counts['serving']['draft_prefill_compiles']} after it, for "
            f"the drafter's buckets {sorted(eng._draft_buckets)}")
    draft_buckets = check_draft_buckets(eng, cfg.vocab_size)
    sc = counts["serving"]
    rounds = sc["spec_rounds"]
    verifies = counts["replays"]["_verify_graph"]
    per_round = cfg.n_layer + (draft_k + 1) * dcfg.n_layer
    launches = counts["kernels"]
    if rounds == 0 or rounds != verifies or \
            launches["paged_attention"] != rounds * per_round or \
            launches["paged_attention_ref"]:
        raise AssertionError(
            f"spec: {launches} kernel launches for {rounds} rounds "
            f"({verifies} verify replays) x ({cfg.n_layer} + "
            f"{draft_k + 1} x {dcfg.n_layer})")
    head_dim = cfg.d_model // cfg.n_head
    verify_key = (dtype, head_dim, 8)
    draft_key = (dtype, dcfg.d_model // dcfg.n_head, 1)
    device = check_device_launches("spec", counts, {
        verify_key: rounds * cfg.n_layer,
        draft_key: rounds * (draft_k + 1) * dcfg.n_layer})
    eng.pool.audit()
    eng.draft_pool.audit()
    if weights_sum(model) != plain["weights_sum"]:
        raise AssertionError("spec: the target's weights differ from phase "
                             "4's, so its tokens cannot be compared")
    match = spec_plain_match([h.tokens for h in handles], plain)

    fill_slots(eng, cfg.vocab_size, max_batch_size)
    eng.decode_step_spec()
    prof = profile_steps(eng.decode_step_spec, profiled_rounds)
    want = {(head_dim, 8): cfg.n_layer * profiled_rounds,
            (dcfg.d_model // dcfg.n_head, 1):
            (draft_k + 1) * dcfg.n_layer * profiled_rounds}
    if prof["split"] != want or prof["graph_launches"] != \
            2 * profiled_rounds or prof["kernel_launches"]:
        raise AssertionError(
            f"spec: over {profiled_rounds} rounds the profiler saw {prof}; "
            f"want split passes {want} ((Dh, rows of the instance): the "
            f"verify's span of {draft_k + 1} rows takes the 8-row "
            "instance), two graph launches a round and no kernel launched "
            "from the host")
    for slot in range(max_batch_size):
        eng.release(slot)
    eng.pool.audit()
    eng.draft_pool.audit()
    result.update({
        "draft_k": draft_k, "rounds": rounds,
        "acceptance": sc["spec_accepted"] / sc["spec_proposed"],
        "emitted_per_round": sc["spec_emitted"] / rounds,
        "emitted_per_slot_round": sc["spec_emitted"] / sc["spec_slot_rounds"],
        "round_p50_ms": result.pop("decode_step_p50_ms"),
        "launches": launches, "device_launches": device,
        "verify_launches": counts["device"][verify_key],
        "plain_match": match, "draft_prefill_buckets": draft_buckets,
        "fastpath": counts["fastpath"], "graph_captures": 2,
        "profiled_rounds": profiled_rounds,
        "profiled": {"split_passes": {f"Dh={k[0]} rows={k[1]}": v
                                      for k, v in prof["split"].items()},
                     "kernels_per_round": prof["kernels"] / profiled_rounds,
                     "graph_launches": prof["graph_launches"],
                     "host_kernel_launches": prof["kernel_launches"]}})
    log(f"{what}: " + json.dumps(result))
    del srv, eng, model, drafter
    free_memory()
    return result


def check_draft_buckets(eng, vocab):
    """Each captured drafter prefill bucket of a spec engine, replayed on a
    prompt of its own length: the drafter's K/V rows after the replay
    must equal those of the same body called directly on the same
    buffers, bitwise, with no capture. Returns the buckets and their
    replays."""
    from paddle_tpu_torch.profiler import registry

    c0 = registry.counters("serving")["draft_prefill_compiles"]
    rng = np.random.default_rng(6)
    for L in sorted(eng._draft_buckets):
        pb = eng._draft_buckets[L]
        eng.prefill(0, rng.integers(0, vocab, L - 1).tolist(), seed=L,
                    max_new_tokens=1)
        idx = torch.tensor(eng._draft_blocks[0], device=eng.device)
        graph_kv = [(k[idx].clone(), v[idx].clone()) for k, v in eng._dkv]
        with torch.no_grad():
            pb.body()
        if not all(torch.equal(k[idx], gk) and torch.equal(v[idx], gv)
                   for (k, v), (gk, gv) in zip(eng._dkv, graph_kv)):
            raise AssertionError(
                f"drafter prefill bucket {L}: the graph's K/V rows differ "
                "from the direct body's")
        eng.release(0)
        del graph_kv
    if registry.counters("serving")["draft_prefill_compiles"] != c0:
        raise AssertionError("drafter prefill buckets: a replay captured")
    return {L: pb.graph.replays for L, pb in
            sorted(eng._draft_buckets.items())}


# ------------------------------------------------ weight swap and retry --
def reference_state(model):
    """``model``'s trunk state as the reference's checkpoints hold it:
    float32 numpy in the reference's names, Linear weights ``[in, out]``."""
    from paddle_tpu_torch import convert

    return {k: v.to(torch.float32, memory_format=torch.contiguous_format)
            .cpu().numpy()
            for k, v in convert.state_to_paddle_tpu(model.gpt).items()}


def greedy_requests(vocab, seed):
    """The 8 greedy requests of ``serving_requests(vocab, seed=seed)``."""
    return [(p, dict(max_new_tokens=o["max_new_tokens"], seed=o["seed"]))
            for p, o in serving_requests(vocab, seed=seed)
            if not o.get("temperature")]


def run_sync(sched, reqs, step_s=None):
    """Submit ``reqs`` and step ``sched`` on this thread until it is idle;
    every request must finish with all its tokens. Returns the tokens;
    ``step_s`` collects each step's wall time."""
    from paddle_tpu_torch.serving import GenerationRequest

    handles = [sched.submit(GenerationRequest(p, **o)) for p, o in reqs]
    while sched.has_work():
        t = time.perf_counter()
        sched.step()
        if step_s is not None:
            step_s.append(time.perf_counter() - t)
    bad = [h for h in handles if h.status != "done"
           or len(h.tokens) != h.max_new_tokens]
    if bad:
        raise AssertionError(f"unfinished requests {bad}")
    return [h.tokens for h in handles]


class DecodeFaults:
    """Test code: raise from ``engine._finish_decode`` on chosen calls, that
    is after the step's graph replay has advanced the device cursors and
    before the host mirrors advance."""

    def __init__(self, engine):
        self.calls = 0
        self.at = set()
        self._orig = engine._finish_decode
        engine._finish_decode = self

    def arm(self, *offsets):
        self.at = {self.calls + k for k in offsets}

    def __call__(self, *args):
        self.calls += 1
        if self.calls in self.at:
            raise RuntimeError(f"injected decode fault (call {self.calls})")
        return self._orig(*args)


def swap_timings():
    from paddle_tpu_torch.profiler import registry

    t = registry.timings("serving")
    return {k: t.get(f"serving.swap_{k}", {"total_s": 0.0})["total_s"]
            for k in ("stage", "commit")}


def _p50(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] * 1e3 if xs else None


def phase_swap(dev, preset="gpt3-1.3B", dtype="bfloat16", max_batch_size=8,
               block_size=16, n_requests=16, swap_after=40):
    """4c: phase 4's mix on weights A (seed 0) with a swap to B (seed 1),
    given as a reference-layout numpy state, staged after ``swap_after``
    decode steps (every request admitted, the second wave mid-decode);
    then a refused swap. 4d: a fault after the graph replay, retried, and
    two in a row. The scheduler is driven on this thread, step by step."""
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import GenerationRequest, GenerationServer

    cfg = GPTConfig.preset(preset, dtype=dtype)

    def build(seed):
        return GPTForPretraining(GPTModel(
            cfg, device=dev,
            generator=torch.Generator(device=dev).manual_seed(seed)))

    def server(model):
        return GenerationServer(model, max_batch_size=max_batch_size,
                                block_size=block_size, max_queue_size=64,
                                device=dev)

    model_b = build(1)
    state_b = reference_state(model_b)
    srv = server(build(0))
    sched, eng = srv.scheduler, srv.engine
    run_sync(sched, [(list(range(1, 40)), dict(max_new_tokens=4))])

    # 4c: the swap lands between two decode steps of the served mix
    c0, t0 = registry.counters("serving"), swap_timings()
    k0 = registry.counters("kernels")["paged_attention"]
    pa.reset_device_launches()
    handles = [sched.submit(GenerationRequest(p, **o))
               for p, o in serving_requests(cfg.vocab_size, n=n_requests)]
    steps, staged, active_at_swap = [], False, None
    while sched.has_work():
        c = registry.counters("serving")
        if not staged and c["decode_steps"] - c0["decode_steps"] \
                >= swap_after:
            sched.request_swap(state_b, source="chip_smoke phase 4c")
            staged, active_at_swap = True, sched.active()
        prefills, swaps = c["prefills"], sched.swap_count
        t = time.perf_counter()
        sched.step()
        steps.append((time.perf_counter() - t,
                      registry.counters("serving")["prefills"] != prefills,
                      sched.swap_count != swaps))
    c1, t1 = registry.counters("serving"), swap_timings()
    device = pa.device_launches()
    k1 = registry.counters("kernels")["paged_attention"]
    n_steps = c1["decode_steps"] - c0["decode_steps"]
    bad = [h for h in handles if h.status != "done"
           or len(h.tokens) != h.max_new_tokens]
    if bad or c1["requests_failed"] != c0["requests_failed"]:
        raise AssertionError(f"swap: failed requests {bad}")
    if c1["weight_swaps"] != c0["weight_swaps"] + 1 or \
            c1["swap_failures"] != c0["swap_failures"] or not active_at_swap:
        raise AssertionError(
            f"swap: weight_swaps {c0['weight_swaps']} -> "
            f"{c1['weight_swaps']}, swap_failures {c0['swap_failures']} -> "
            f"{c1['swap_failures']}, {active_at_swap} requests in flight")
    if c1["decode_compiles"] != c0["decode_compiles"]:
        raise AssertionError("swap: the decode graph was recaptured")
    check_device_launches(
        "swap", {"device": device, "kernels": {"paged_attention": k1 - k0}},
        {(dtype, cfg.d_model // cfg.n_head, 1): n_steps * cfg.n_layer})
    at = next(i for i, (_, _, sw) in enumerate(steps) if sw)
    steady = [(i, dt) for i, (dt, pf, sw) in enumerate(steps)
              if not pf and not sw]
    result = {
        "decode_steps": n_steps, "decode_steps_before_swap": sum(
            1 for i, _ in steady if i < at),
        "requests_in_flight_at_swap": active_at_swap,
        "swap_stage_s": t1["stage"] - t0["stage"],
        "swap_commit_s": t1["commit"] - t0["commit"],
        "step_with_swap_ms": steps[at][0] * 1e3,
        "steady_step_p50_ms_before": _p50([dt for i, dt in steady
                                           if i < at]),
        "steady_step_p50_ms_after": _p50([dt for i, dt in steady
                                          if i > at]),
        "k4_launches": {instance_name(k): v for k, v in device.items()}}

    # the swapped server against a fresh one built on B; new prompts each
    # time, so neither server finds them in its prefix cache
    fresh = server(model_b)
    want = {s: run_sync(fresh.scheduler, greedy_requests(cfg.vocab_size, s))
            for s in (1, 2, 3)}
    del fresh
    if run_sync(sched, greedy_requests(cfg.vocab_size, 1)) != want[1]:
        raise AssertionError("swap: greedy tokens after the swap differ "
                             "from a fresh server's on the new weights")
    bad_state = dict(state_b)
    name = "blocks.0.attn.qkv_proj.weight"
    bad_state[name] = bad_state[name][:-1]
    c2 = registry.counters("serving")
    sched.request_swap(bad_state, source="chip_smoke phase 4c (truncated)")
    if run_sync(sched, greedy_requests(cfg.vocab_size, 2)) != want[2]:
        raise AssertionError("swap: a refused swap changed the tokens")
    c3 = registry.counters("serving")
    if c3["swap_failures"] != c2["swap_failures"] + 1 or \
            c3["weight_swaps"] != c2["weight_swaps"]:
        raise AssertionError(f"swap: a truncated weight was not refused "
                             f"({c2} -> {c3})")
    result["refused_swap"] = repr(sched.last_swap_error)[:160]
    log("swap: " + json.dumps(result))

    # 4d: one fault after the replay is retried on a recaptured graph
    faults = DecodeFaults(eng)
    faults.arm(6)
    c4 = registry.counters("serving")
    step_s = []
    got = run_sync(sched, greedy_requests(cfg.vocab_size, 3), step_s)
    c5 = registry.counters("serving")
    moved = {k: c5[k] - c4[k] for k in ("step_retries", "reprimes",
                                        "decode_compiles",
                                        "requests_failed")}
    # (the card captures graphs; the CPU, where the script is rehearsed,
    # runs the step body directly)
    if moved != {"step_retries": 1, "reprimes": 1,
                 "decode_compiles": int(dev.type == "cuda"),
                 "requests_failed": 0}:
        raise AssertionError(f"retry: counters moved {moved}")
    if got != want[3]:
        raise AssertionError("retry: tokens after the retry differ from an "
                             "unfaulted run's")
    # two in a row fail the batch, through the server's worker loop
    faults.arm(3, 4)
    srv.start()
    try:
        hs = [srv.submit(p, **o)
              for p, o in greedy_requests(cfg.vocab_size, 4)]
        for h in hs:
            h.result(timeout=600)
    finally:
        srv.shutdown(timeout=600)
    if any(h.status != "error" for h in hs) or \
            "injected decode fault" not in str(srv.last_error):
        raise AssertionError(f"retry: two faults in a row left {hs}, "
                             f"last error {srv.last_error!r}")
    retry = {"counters_moved": moved, "tokens_equal_unfaulted": True,
             "retried_step_ms": max(step_s[1:]) * 1e3,
             "other_steps_p50_ms": _p50(sorted(step_s[1:])[:-1]),
             "second_fault": repr(srv.last_error)[:120],
             "failed_requests": len(hs)}
    log("retry: " + json.dumps(retry))
    del srv, sched, eng, model_b, state_b, faults
    free_memory()
    return result, retry


def phase_spec_swap(dev, preset="gpt3-1.3B", draft_preset="gpt2-small",
                    n_layer=2, draft_k=4, n_tokens=24, n_bf16=4):
    """5c: a ``DraftVerifyEngine`` whose target and drafter swap together
    in the middle of a stream, against plain decode under the same swap.
    float32 at 2 layers (twin drafters, from the target's seed): the
    tokens must be equal. Then bf16 at full width (gpt2-small drafting),
    one stream per greedy prompt, swapped A -> B mid-stream and back
    between streams: the match is reported."""
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import DraftVerifyEngine, GenerationEngine

    def build(seed, preset=preset, **over):
        return GPTForPretraining(GPTModel(
            GPTConfig.preset(preset, **over), device=dev,
            generator=torch.Generator(device=dev).manual_seed(seed)))

    def stream(engine, prompt, n, swap, swap_at, logits=None):
        """Greedy ``prompt``; ``swap(engine)`` once ``swap_at(tokens)``.
        ``logits`` collects a plain engine's logits of each decode step."""
        spec = getattr(engine, "decode_step_spec", None)
        out, at = [engine.prefill(0, prompt, seed=0)], None
        while len(out) < n:
            if at is None and swap_at(out):
                swap(engine)
                at = len(out)
            if spec:
                out.extend(spec()[0])
                continue
            out.append(int(engine.decode_step()[0]))
            if logits is not None:
                logits.append(engine.last_logits[0].clone())
        engine.release(0)
        return out, at

    def first_difference(got, want, logits):
        """Index of the first differing token, and there the plain logits'
        margin of plain decode's token over the spec engine's."""
        i = next((i for i, (x, y) in enumerate(zip(got, want)) if x != y),
                 None)
        if i is None:
            return len(got), None
        row = logits[i - 1]
        return i, float(row[want[i]] - row[got[i]])

    f32 = dict(n_layer=n_layer, dtype="float32")
    state_b = build(3, **f32).state_dict()
    eng = DraftVerifyEngine(build(1, **f32), build(1, **f32),
                            draft_k=draft_k, max_batch_size=2, rng_seed=0,
                            device=dev)
    prompt = np.random.default_rng(1).integers(
        0, eng._gpt.cfg.vocab_size, 333).tolist()
    c0 = registry.counters("serving")
    rounds = []
    got, at = stream(eng, prompt, n_tokens,
                     lambda e: e.swap_weights(state_b, draft_state=state_b),
                     lambda out: rounds.append(1) or len(rounds) > 3)
    c1 = registry.counters("serving")
    plain = GenerationEngine(build(1, **f32), max_batch_size=2, rng_seed=0,
                             device=dev)
    want, _ = stream(plain, prompt, len(got),
                     lambda e: e.swap_weights(state_b),
                     lambda out: len(out) == at)
    gens = eng.acceptance_by_generation()
    if c1["draft_swaps"] != c0["draft_swaps"] + 1 or len(gens) != 2:
        raise AssertionError(f"spec swap: draft_swaps "
                             f"{c1['draft_swaps'] - c0['draft_swaps']}, "
                             f"generations {gens}")
    if got != want:
        raise AssertionError(f"spec swap: tokens {got} != plain decode's "
                             f"{want} under the same swap")
    eng.pool.audit()
    eng.draft_pool.audit()
    result = {"float32": {"tokens": len(got), "swapped_after": at,
                          "tokens_equal": True,
                          "acceptance_by_generation": gens}}
    # the drafter catches up: an independent drafter swapped, mid-stream,
    # to the target's own weights (the target "swapped" to itself). Its KV
    # is rebuilt from the history, so it must now agree with the target
    # on every draft
    state_a = build(1, **f32).state_dict()
    eng = DraftVerifyEngine(build(1, **f32), build(2, **f32),
                            draft_k=draft_k, max_batch_size=2, rng_seed=0,
                            device=dev)
    rounds = []
    got, at = stream(eng, prompt, n_tokens,
                     lambda e: e.swap_weights(state_a, draft_state=state_a),
                     lambda out: rounds.append(1) or len(rounds) > 3)
    plain.swap_weights(state_a)  # back from B
    want, _ = stream(plain, prompt, len(got), None, lambda out: False)
    gens = eng.acceptance_by_generation()
    if got != want or list(gens.values())[-1] != 1.0:
        raise AssertionError(f"spec swap: after the drafter's swap to the "
                             f"target's weights, acceptance {gens} (want "
                             f"1.0 in the new generation) and tokens "
                             f"{'equal' if got == want else 'differ'}")
    result["float32"]["drafter_to_target_acceptance"] = gens
    del eng, plain, state_a, state_b
    free_memory()

    bf = dict(dtype="bfloat16")
    seq = GPTConfig.preset(preset).seq_len
    target, drafter = build(0, **bf), build(2, draft_preset, seq_len=seq,
                                            **bf)
    snap = ({k: v.clone() for k, v in target.state_dict().items()},
            {k: v.clone() for k, v in drafter.state_dict().items()})
    new = (build(1, **bf).state_dict(),
           build(3, draft_preset, seq_len=seq, **bf).state_dict())
    eng = DraftVerifyEngine(target, drafter, draft_k=draft_k,
                            max_batch_size=1, rng_seed=0, device=dev)
    plain = GenerationEngine(build(0, **bf), max_batch_size=1, rng_seed=0,
                             device=dev)
    match, lengths, margins, control = [], [], [], []
    for prompt, opts in greedy_requests(eng._gpt.cfg.vocab_size, 0)[:n_bf16]:
        n = opts["max_new_tokens"]
        rounds, logits = [], []
        got, at = stream(eng, prompt, n,
                         lambda e: e.swap_weights(new[0],
                                                  draft_state=new[1]),
                         lambda out: rounds.append(1) or len(rounds) > 2)
        eng.swap_weights(snap[0], draft_state=snap[1])
        want, _ = stream(plain, prompt, len(got),
                         lambda e: e.swap_weights(new[0]),
                         lambda out: len(out) == at, logits)
        plain.swap_weights(snap[0])
        lengths.append(len(got))
        i, margin = first_difference(got, want, logits)
        match.append(i)
        margins.append(margin)
        # the same stream with no swap: phase 5b's spec-against-plain
        # comparison, one stream at a time
        logits = []
        got, _ = stream(eng, prompt, n, None, lambda out: False)
        want, _ = stream(plain, prompt, len(got), None, lambda out: False,
                         logits)
        control.append(first_difference(got, want, logits))
    eng.pool.audit()
    eng.draft_pool.audit()
    result["bfloat16"] = {
        "streams": len(match), "tokens_before_first_difference": match,
        "streams_equal": sum(m == n for m, n in zip(match, lengths)),
        "logit_margin_at_first_difference": margins,
        "without_swap": control,
        "acceptance_by_generation": eng.acceptance_by_generation()}
    log("spec swap: " + json.dumps(result))
    del eng, plain, target, drafter, snap, new
    free_memory()
    return result


# ---------------------------------------------- prefill→decode handoff --
def build_gpt(dev, seed, preset="gpt3-1.3B", **over):
    """A random model of ``preset`` on the card, its weights from ``seed``."""
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)

    return GPTForPretraining(GPTModel(
        GPTConfig.preset(preset, **over), device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed)))


class Timed:
    """Test instrumentation: ``obj.name`` replaced by a wrapper that keeps
    each call's host seconds, up to the end of the card's work."""

    def __init__(self, obj, name):
        self.obj, self.name = obj, name
        self._orig = getattr(obj, name)
        self.seconds = []
        setattr(obj, name, self)

    def __call__(self, *args, **kw):
        t = time.perf_counter()
        out = self._orig(*args, **kw)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t)
        return out

    def restore(self):
        delattr(self.obj, self.name)


def export_all(engine, reqs):
    """The prefill side of a handoff: prefill each request in slot 0 of
    ``engine``, export it and release the slot. The prefix cache is
    flushed first, so the prefills hit the prefixes a fresh monolithic
    engine hits on the same sequence: a prefix hit prefills a shorter
    window, whose bf16 rows may round otherwise. Returns the payloads and
    each export's host seconds (the copy to the host synchronises)."""
    engine.prefix_cache.flush()
    payloads, secs = [], []
    for p, o in reqs:
        engine.prefill(0, p, **o)
        t = time.perf_counter()
        payloads.append(engine.export_request_kv(0))
        secs.append(time.perf_counter() - t)
        engine.release(0)
    return payloads, secs


def payload_bytes(payload):
    return sum(t.numel() * t.element_size()
               for t in payload["kv_k"] + payload["kv_v"])


def adopt_all(sched, reqs, payloads, step_ends=None):
    """The decode side: submit ``reqs`` carrying their payloads and step
    ``sched`` on this thread until it is idle; every request must finish
    with all its tokens. ``step_ends`` collects, after each step, the
    monotonic clock and every request's token count. Returns the
    handles."""
    handles = [sched.submit(r) for r in handoff_requests(reqs, payloads)]
    while sched.has_work():
        sched.step()
        if step_ends is not None:
            step_ends.append((time.monotonic(),
                              [len(h.tokens) for h in handles]))
    bad = [h for h in handles if h.status != "done"
           or len(h.tokens) != h.max_new_tokens]
    if bad:
        raise AssertionError(f"unfinished requests {bad}")
    return handles


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def first_difference(got, want):
    """``(request, token)`` of the first difference of two token lists of
    lists, or None."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return i, next((j for j, (x, y) in enumerate(zip(a, b))
                            if x != y), min(len(a), len(b)))
    return None if len(got) == len(want) else (min(len(got), len(want)), 0)


def phase_handoff(dev, preset="gpt3-1.3B", dtype="bfloat16",
                  max_batch_size=8, block_size=16, n_requests=16):
    """4e: disaggregated serving at full width. A prefills each of phase
    4's requests, exports and releases it; B's scheduler adopts the
    payloads and decodes; M, a monolithic engine on the same weights and
    base key as A, serves the same requests. B's key differs on purpose:
    the exported request key must rule. Then a handoff into a spec engine
    and the staleness cases. Returns the result and, for 4f and 4g, the
    engines and the reference tokens."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import (ContinuousBatchScheduler,
                                          GenerationEngine)

    t0 = time.perf_counter()
    model = build_gpt(dev, 0, preset, dtype=dtype)
    cfg = model.gpt.cfg
    ekw = dict(max_batch_size=max_batch_size, block_size=block_size,
               device=dev)
    a = GenerationEngine(model, rng_seed=7, **ekw)
    m = GenerationEngine(model, rng_seed=7, **ekw)
    b = GenerationEngine(build_gpt(dev, 0, preset, dtype=dtype),
                         rng_seed=99, **ekw)
    log(f"handoff: {preset} {dtype}, engines A (prefill, rng_seed 7), B "
        f"(decode, rng_seed 99), M (monolithic, rng_seed 7) built in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = serving_requests(cfg.vocab_size, n=n_requests)
    want = run_sync(ContinuousBatchScheduler(m, max_queue_size=64), reqs)
    sched = ContinuousBatchScheduler(b, max_queue_size=64)
    warm = [(list(range(1, 40)), dict(max_new_tokens=4, seed=99))]
    adopt_all(sched, warm, export_all(a, warm)[0])  # captures B's graph

    payloads, export_s = export_all(a, reqs)
    for scope in ("kernels", "serving", "fastpath"):
        registry.reset(scope)
    pa.reset_device_launches()
    imports = Timed(b, "import_request_kv")
    t = time.perf_counter()
    try:
        handles = adopt_all(sched, reqs, payloads)
    finally:
        imports.restore()
    wall = time.perf_counter() - t
    c = registry.counters("serving")
    got = [h.tokens for h in handles]
    diff = first_difference(got, want)
    if diff is not None:
        raise AssertionError(f"handoff: B's tokens differ from M's at "
                             f"(request, token) {diff}")
    moved = {k: c[k] for k in ("prefills", "handoff_imports",
                               "handoff_stale", "requests_completed",
                               "decode_compiles", "prefill_compiles")}
    if moved != {"prefills": 0, "handoff_imports": n_requests,
                 "handoff_stale": 0, "requests_completed": n_requests,
                 "decode_compiles": 0, "prefill_compiles": 0}:
        raise AssertionError(f"handoff: B's counters moved {moved}")
    for e in (a, b, m):
        e.pool.audit()
    short = [i for i, (p, _) in enumerate(reqs)
             if len(b.prefix_cache.match(p)) != len(p) // block_size]
    if short:
        raise AssertionError(f"handoff: B's prefix cache lacks the full "
                             f"blocks of requests {short}")
    steps = c["decode_steps"]
    device = check_device_launches(
        "handoff", {"device": pa.device_launches(),
                    "kernels": registry.counters("kernels")},
        {(dtype, cfg.d_model // cfg.n_head, 1): steps * cfg.n_layer})
    nbytes = [payload_bytes(p) for p in payloads]
    ttft = sorted(h.ttft_s for h in handles)
    result = {
        "requests": n_requests, "tokens_equal_monolithic": True,
        "greedy_and_sampled": True, "decode_steps": steps,
        "k4_launches": device, "payload_mb_p50": _median(nbytes) / 1e6,
        "payload_mb_max": max(nbytes) / 1e6,
        "export_ms_p50": _p50(export_s), "import_ms_p50": _p50(
            imports.seconds),
        "export_gb_s": sum(nbytes) / sum(export_s) / 1e9,
        "import_gb_s": sum(nbytes) / sum(imports.seconds) / 1e9,
        "ttft_p50_ms": ttft[len(ttft) // 2] * 1e3,
        "decode_step_p50_ms":
            registry.timings("serving")["serving.decode_step"]["p50_ms"],
        "tokens_per_s": sum(map(len, got)) / wall}
    log("handoff: " + json.dumps(result))
    result["spec"] = phase_spec_handoff(dev, preset)
    model_1 = build_gpt(dev, 1, preset, dtype=dtype)
    result["stale"] = phase_stale_handoff(dev, a, model, model_1, reqs,
                                          want, ekw, preset, dtype)
    return result, {"a": a, "b": b, "model": model, "model_1": model_1,
                    "reqs": reqs, "want": want,
                    "decode_step_p50_ms": result["decode_step_p50_ms"]}


def phase_spec_handoff(dev, preset, n_layer=2, draft_k=4, n_tokens=24):
    """4e, spec: a plain engine's export adopted by a ``DraftVerifyEngine``
    (float32, ``n_layer`` layers at full width, a twin drafter): its tokens
    equal plain decode's, greedy and sampled, and the drafter, which
    ingests the prompt again, has every draft accepted."""
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import DraftVerifyEngine, GenerationEngine

    target = build_gpt(dev, 1, preset, n_layer=n_layer, dtype="float32")
    plain = GenerationEngine(target, max_batch_size=2, rng_seed=7,
                             device=dev)
    spec = DraftVerifyEngine(
        target, build_gpt(dev, 1, preset, n_layer=n_layer, dtype="float32"),
        draft_k=draft_k, max_batch_size=2, rng_seed=99, device=dev)
    prompt = np.random.default_rng(1).integers(
        0, target.gpt.cfg.vocab_size, 333).tolist()
    out = {}
    for opts in (dict(seed=0), dict(seed=3, temperature=0.8, top_p=0.9)):
        want = _spec_run(plain, prompt, n_tokens, **opts)
        payload = export_all(plain, [(prompt, opts)])[0][0]
        c0 = registry.counters("serving")
        got = [spec.import_request_kv(0, payload, prompt_ids=prompt)]
        while len(got) < n_tokens:
            got.extend(spec.decode_step_spec()[0])
        spec.release(0)
        c1 = registry.counters("serving")
        if got[:n_tokens] != want:
            raise AssertionError(f"handoff: spec tokens {got} != plain "
                                 f"decode's {want} ({opts})")
        acc = (c1["spec_accepted"] - c0["spec_accepted"]) / (
            c1["spec_proposed"] - c0["spec_proposed"])
        if acc != 1.0:
            raise AssertionError(f"handoff: twin drafter acceptance {acc}")
        out["sampled" if len(opts) > 1 else "greedy"] = "equal"
    spec.pool.audit()
    spec.draft_pool.audit()
    log(f"handoff: spec engine ({n_layer} layers float32, twin drafter, "
        f"K={draft_k}) adopting a plain engine's export: {n_tokens} tokens "
        f"equal plain decode's, {out}, acceptance 1.0")
    return out


def phase_stale_handoff(dev, a, model, model_1, reqs, want, ekw, preset,
                        dtype):
    """4e, staleness, on a decode engine D of its own (seed-0 weights,
    rng_seed 99) against exports from A: a re-prime on D alone leaves
    the weight generation and the handoff is adopted; a swap on D (to
    seed-1 weights) between an export and its import gets the payload
    refused and prefilled again on D, with the tokens of a fresh engine
    on seed-1 weights; a re-prime on A followed by a swap on D (back to
    seed 0) is refused too."""
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import (ContinuousBatchScheduler,
                                          GenerationEngine, StaleHandoffError)

    two = reqs[:2]  # one greedy, one sampled
    d = GenerationEngine(build_gpt(dev, 0, preset, dtype=dtype),
                         rng_seed=99, **ekw)
    fresh = run_sync(ContinuousBatchScheduler(
        GenerationEngine(model_1, rng_seed=99, **ekw)), two)

    def adopt(payloads):
        c0 = registry.counters("serving")
        got = [h.tokens for h in adopt_all(ContinuousBatchScheduler(d),
                                           two, payloads)]
        c1 = registry.counters("serving")
        return got, {k: c1[k] - c0[k] for k in (
            "handoff_imports", "handoff_stale", "prefills")}

    out = {}
    d.reprime()
    got, moved = adopt(export_all(a, two)[0])
    if got != want[:2] or moved != {"handoff_imports": 2,
                                    "handoff_stale": 0, "prefills": 0}:
        raise AssertionError(f"stale: after a re-prime on D: {moved}, "
                             f"tokens equal M's: {got == want[:2]}")
    out["reprime_on_decode_side"] = "adopted"
    payloads = export_all(a, two)[0]
    d.swap_weights({k: v.detach() for k, v in
                    model_1.gpt.state_dict().items()})
    got, moved = adopt(payloads)
    if got != fresh or moved != {"handoff_imports": 0, "handoff_stale": 2,
                                 "prefills": 2}:
        raise AssertionError(f"stale: a swap between export and import: "
                             f"{moved}, tokens equal a fresh engine's on "
                             f"the new weights: {got == fresh}")
    out["swap_between_export_and_import"] = \
        "refused, prefilled again, tokens equal a fresh engine's"
    a.reprime()
    payload = export_all(a, two[:1])[0][0]
    d.swap_weights({k: v.detach() for k, v in model.gpt.state_dict().items()})
    try:
        d.import_request_kv(0, payload, prompt_ids=two[0][0])
    except StaleHandoffError:
        out["reprime_on_prefill_side_then_swap"] = "refused"
    else:
        raise AssertionError("stale: a payload exported after a re-prime "
                             "on A was adopted by D after a swap")
    d.pool.audit()
    log("handoff (staleness): " + json.dumps(out))
    return out


# ------------------------------------------------------- prefill graphs --
def host_and_device_ms(fn, n=5):
    """Median host milliseconds (to the end of the card's work) and device
    milliseconds (CUDA events) of ``n`` calls of ``fn``."""
    host, device = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
        device.append(e0.elapsed_time(e1))
    return sorted(host)[n // 2], sorted(device)[n // 2]


def phase_prefill_graphs(dev, model, max_batch_size=8, block_size=16):
    """4f: one prompt per bucket (16..2048) on a fresh engine: one graph
    captured per bucket; the replay's first token and K/V rows equal
    those of the same body called directly on the same input buffers,
    bitwise; each timed both ways; the graphs' shared pool measured."""
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import GenerationEngine

    eng = GenerationEngine(model, max_batch_size=max_batch_size,
                           block_size=block_size, rng_seed=7, device=dev)
    vocab = model.gpt.cfg.vocab_size
    rng = np.random.default_rng(4)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_stats(dev)
    c0 = registry.counters("serving")["prefill_compiles"]
    rows = {}
    for L in eng.buckets:
        prompt = rng.integers(0, vocab, L - 1).tolist()
        tok = eng.prefill(0, prompt, seed=L, temperature=0.8, top_p=0.9,
                          max_new_tokens=1)
        pb = eng._prefill_buckets[L]
        idx = torch.tensor(eng._slot_blocks[0], device=dev)

        def kv_rows():
            return [(k[idx].clone(), v[idx].clone()) for k, v in eng._kv]

        graph_kv = kv_rows()
        with torch.no_grad():
            pb.body()  # the same body, called directly on the buffers
        direct_tok, direct_kv = int(pb.token.item()), kv_rows()
        if direct_tok != tok or not all(
                torch.equal(x, y) for g, d in zip(graph_kv, direct_kv)
                for x, y in zip(g, d)):
            raise AssertionError(
                f"prefill graphs: bucket {L}: the graph's token {tok} and "
                f"K/V rows against the direct call's {direct_tok}: not "
                "bitwise equal")
        graph_ms = host_and_device_ms(pb.graph)
        direct_ms = host_and_device_ms(pb.body)
        rows[L] = {"graph_host_ms": graph_ms[0],
                   "graph_device_ms": graph_ms[1],
                   "direct_host_ms": direct_ms[0],
                   "direct_device_ms": direct_ms[1]}
        eng.release(0)
        del graph_kv, direct_kv
    captures = registry.counters("serving")["prefill_compiles"] - c0
    # (the CPU, where the script is rehearsed, runs the bodies directly)
    if captures != len(eng.buckets) * (dev.type == "cuda") or \
            sorted(eng._prefill_buckets) != list(eng.buckets):
        raise AssertionError(f"prefill graphs: {captures} captures for "
                             f"the buckets {eng.buckets}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    m1 = torch.cuda.memory_stats(dev)
    key = "reserved_bytes.all.current"
    result = {"buckets": list(eng.buckets), "captures": captures,
              "bitwise_equal_direct": True, "per_bucket": rows,
              "graph_pool_reserved_mb": (m1[key] - m0[key]) / 1e6,
              "reserved_before_mb": m0[key] / 1e6,
              "reserved_after_mb": m1[key] / 1e6}
    log("prefill graphs: " + json.dumps(result))
    del eng
    free_memory()
    return result


# ------------------------------------ traces, histograms, fault points --
class RouteRecorder:
    """Test instrumentation: the model's K4 route calls made while a CUDA
    graph captures, as (arguments, output). The tensors stay referenced,
    so the graph's replays rewrite them in place."""

    def __init__(self):
        from paddle_tpu_torch.models import gpt

        self._mod, self._orig = gpt, gpt.paged_attention_route
        self.calls = []
        gpt.paged_attention_route = self

    def __call__(self, kernel, *args, **kw):
        out = self._orig(kernel, *args, **kw)
        if torch.cuda.is_current_stream_capturing():
            self.calls.append((args, out))
        return out

    def restore(self):
        self._mod.paged_attention_route = self._orig


def hist_index(ms):
    """The histogram bucket a duration of ``ms`` falls in."""
    from paddle_tpu_torch.profiler import registry

    return math.frexp(ms / 1e3)[1] - registry.HIST_EMIN


def token_gaps(step_ends):
    """Each request's gaps between consecutive tokens, from the clock read
    after each step (the scheduler stamps a step's tokens with one clock
    read). A step that gave a request two tokens (its admission and its
    first decode) hides the gap between them, which is left out."""
    gaps = []
    for r in range(len(step_ends[0][1])):
        last = None
        for t, counts in step_ends:
            n = counts[r] - (last[1] if last else 0)
            if n and last is not None and last[1]:
                gaps.append(t - last[0])
            if n:
                last = (t, counts[r])
    return gaps


def phase_observability(dev, ctx, n_layer=2):
    """4g: traces, histograms and the serving fault points at full width
    on 4e's engines A and B (``ctx``), every fault disarmed in a
    ``finally``."""
    from paddle_tpu_torch.profiler import registry, tracing
    from paddle_tpu_torch.serving import (ContinuousBatchScheduler,
                                          DraftVerifyEngine, GenerationEngine,
                                          GenerationServer)
    from paddle_tpu_torch.testing import faults

    a, b, reqs, want = ctx["a"], ctx["b"], ctx["reqs"], ctx["want"]
    greedy = [i for i, (_, o) in enumerate(reqs) if not o.get("temperature")]
    out = {}
    flight_dir = tempfile.mkdtemp(prefix="chip_smoke_flight_")
    old_dir = os.environ.get("PADDLE_TPU_FLIGHT_DIR")
    os.environ["PADDLE_TPU_FLIGHT_DIR"] = flight_dir
    try:
        # traces and histograms: 4e's mix again with tracing on
        off_p50 = ctx["decode_step_p50_ms"]
        registry.reset("serving")
        tracing.drain_spans()
        tracing.enable()
        step_ends = []
        handles = adopt_all(ContinuousBatchScheduler(b, max_queue_size=64),
                            reqs, export_all(a, reqs)[0], step_ends)
        tracing.disable()
        spans = tracing.drain_spans()
        if [h.tokens for h in handles] != want:
            raise AssertionError("traces: tokens with tracing on differ")
        names = {"queue_wait", "prefill", "kv_export", "kv_import",
                 "kv_adopt", "decode"}
        for (_, o), h in zip(reqs, handles):
            tid = tracing.trace_id_for_seed(o["seed"])
            mine = {s[1] for s in spans if s[0] == tid}
            if h.trace_id != tid or not names <= mine:
                raise AssertionError(f"traces: request seed {o['seed']}: "
                                     f"trace {h.trace_id} spans {mine}")
        col = tracing.FleetTraceCollector()
        col.add_spans("chip_smoke", spans, pid=os.getpid())
        with tempfile.TemporaryDirectory() as d:
            with open(col.write(os.path.join(d, "trace.json"))) as f:
                doc = json.load(f)
        events = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        if len(events) != len(spans) or len(col.traces()) != len(reqs) + 1:
            raise AssertionError(f"traces: the chrome trace holds "
                                 f"{len(events)} of {len(spans)} spans")
        hists, times = registry.histograms("serving"), \
            registry.timings("serving")
        # the measured p50 at the histogram's rank: the smallest value
        # that half the observations do not exceed
        measured = {"ttft": [h.ttft_s for h in handles],
                    "inter_token": token_gaps(step_ends)}
        pairs = {}
        for k, xs in measured.items():
            exact_ms = sorted(xs)[math.ceil(len(xs) / 2) - 1] * 1e3
            pairs[k] = (hists[f"serving.{k}"]["p50_ms"], exact_ms)
            if abs(hist_index(pairs[k][0]) - 1 - hist_index(exact_ms)) > 1:
                raise AssertionError(f"histograms: {k} p50 {pairs[k][0]} "
                                     f"ms against {exact_ms} ms measured")
        pairs["ttft_reservoir_p50_ms"] = times["serving.ttft"]["p50_ms"]
        out["traces"] = {
            "spans": len(spans), "requests_traced": len(reqs),
            "chrome_trace_events": len(events),
            "hist_vs_measured_p50_ms": pairs,
            "decode_step_p50_ms_tracing_on": times["serving.decode_step"][
                "p50_ms"],
            "decode_step_p50_ms_tracing_off": off_p50}

        # page_pool_exhausted: requests stay queued, then all finish
        payloads = export_all(a, reqs)[0]
        c0 = registry.counters("serving")
        faults.configure("page_pool_exhausted:times=3")
        sched = ContinuousBatchScheduler(b, max_queue_size=64)
        handles = [sched.submit(h) for h in handoff_requests(reqs, payloads)]
        queued = []
        while sched.has_work():
            sched.step()
            queued.append(sched.queued())
        faults.reset()
        c1 = registry.counters("serving")
        if queued[:3] != [len(reqs)] * 3 or [h.tokens for h in handles] \
                != want or c1["pool_exhausted"] - c0["pool_exhausted"] != 3:
            raise AssertionError(f"page_pool_exhausted: queued {queued[:4]}"
                                 f", tokens equal "
                                 f"{[h.tokens for h in handles] == want}")
        out["page_pool_exhausted"] = {"queued_after_steps": queued[:4],
                                      "tokens_equal": True}

        # decode_error beside phase 4d's own injection
        sub = [reqs[i] for i in greedy]
        payloads = export_all(a, sub)[0]
        c0 = registry.counters("serving")
        faults.configure("decode_error:fails=1")
        got = [h.tokens for h in adopt_all(
            ContinuousBatchScheduler(b, max_queue_size=64), sub, payloads)]
        faults.reset()
        c1 = registry.counters("serving")
        moved = {k: c1[k] - c0[k] for k in ("step_retries", "reprimes",
                                            "decode_compiles",
                                            "requests_failed")}
        if moved != {"step_retries": 1, "reprimes": 1,
                     "decode_compiles": int(dev.type == "cuda"),
                     "requests_failed": 0} or \
                got != [want[i] for i in greedy]:
            raise AssertionError(f"decode_error: {moved}, tokens equal "
                                 f"{got == [want[i] for i in greedy]}")
        out["decode_error"] = moved

        # kill_during_swap: the old weights serve the same tokens
        payloads = export_all(a, sub)[0]
        gen0 = b._weight_gen
        c0 = registry.counters("serving")
        faults.configure("kill_during_swap")
        sched = ContinuousBatchScheduler(b, max_queue_size=64)
        sched.request_swap({k: v.detach() for k, v in
                            ctx["model_1"].gpt.state_dict().items()})
        got = [h.tokens for h in adopt_all(sched, sub, payloads)]
        faults.reset()
        c1 = registry.counters("serving")
        if c1["swap_failures"] - c0["swap_failures"] != 1 or \
                c1["weight_swaps"] != c0["weight_swaps"] or \
                b._weight_gen != gen0 or got != [want[i] for i in greedy]:
            raise AssertionError(f"kill_during_swap: {sched.last_swap_error}"
                                 f", tokens equal "
                                 f"{got == [want[i] for i in greedy]}")
        out["kill_during_swap"] = repr(sched.last_swap_error)[:100]

        # replica_kill: the worker loop fails the batch and dumps
        payloads = export_all(a, sub)[0]
        srv = GenerationServer(engine=b, max_queue_size=64)
        faults.configure("replica_kill:nth=5")
        try:
            hs = [srv.submit_request(r)
                  for r in handoff_requests(sub, payloads)]
            for h in hs:
                h.result(timeout=600)
        finally:
            faults.reset()
            srv.shutdown(timeout=600)
        path = tracing.flight_dump_path()
        dump = tracing.load_flight_dump(path)
        fatal = [e for e in dump["events"] if e["event"] == "fatal"]
        if any(h.status != "error" for h in hs) or \
                "replica_kill" not in str(srv.fatal_error) or not fatal or \
                not dump["reason"].startswith("fatal_engine_error"):
            raise AssertionError(f"replica_kill: {hs}, fatal "
                                 f"{srv.fatal_error!r}, dump {dump['reason']}")
        out["replica_kill"] = {"failed_requests": len(hs),
                               "flight_events": len(dump["events"]),
                               "fatal": fatal[-1]["detail"]["error"][:80]}

        # draft_garbage and kernel_mismatch, float32 at n_layer layers
        target = build_gpt(dev, 1, n_layer=n_layer, dtype="float32")
        prompt = np.random.default_rng(1).integers(
            0, target.gpt.cfg.vocab_size, 333).tolist()
        plain = GenerationEngine(target, max_batch_size=2, rng_seed=0,
                                 device=dev)
        spec = DraftVerifyEngine(
            target, build_gpt(dev, 1, n_layer=n_layer, dtype="float32"),
            draft_k=4, max_batch_size=2, rng_seed=0, device=dev)
        c0 = registry.counters("serving")
        faults.configure("draft_garbage:rounds=3")
        got = _spec_run(spec, prompt, 24, seed=3, temperature=0.8)
        faults.reset()
        c1 = registry.counters("serving")
        if got != _spec_run(plain, prompt, 24, seed=3, temperature=0.8) \
                or c1["spec_accepted"] - c0["spec_accepted"] >= \
                c1["spec_proposed"] - c0["spec_proposed"]:
            raise AssertionError("draft_garbage: spec tokens differ from "
                                 "plain decode's, or every draft was "
                                 "accepted")
        out["draft_garbage"] = {
            "tokens_equal_plain": True,
            "accepted": c1["spec_accepted"] - c0["spec_accepted"],
            "proposed": c1["spec_proposed"] - c0["spec_proposed"]}
        del spec, plain

        rejected = {}
        for armed in (True, False):
            rec = RouteRecorder()
            try:
                if armed:
                    faults.configure("kernel_mismatch")
                eng = GenerationEngine(target, max_batch_size=2, rng_seed=0,
                                       device=dev)
                eng.prefill(0, prompt, seed=0)
                eng.decode_step()  # captures the graph, then replays it
                torch.cuda.synchronize()
            finally:
                faults.reset()
                rec.restore()
            args, got = rec.calls[0]  # layer 0
            try:
                check_paged("decode in a graph captured with "
                            f"kernel_mismatch {'armed' if armed else 'off'}",
                            torch.float32, *paged_errors(got, args))
            except AssertionError as e:
                rejected[armed] = str(e)[:160]
            else:
                rejected[armed] = None
            del eng, rec
        if rejected[True] is None or rejected[False] is not None:
            raise AssertionError(f"kernel_mismatch: the parity check "
                                 f"{rejected}")
        out["kernel_mismatch"] = {"rejected_when_armed": rejected[True],
                                  "passed_when_off": True}
    finally:
        faults.reset()
        tracing.disable()
        if old_dir is None:
            os.environ.pop("PADDLE_TPU_FLIGHT_DIR", None)
        else:
            os.environ["PADDLE_TPU_FLIGHT_DIR"] = old_dir
        shutil.rmtree(flight_dir, ignore_errors=True)
    a.pool.audit()
    b.pool.audit()
    log("observability: " + json.dumps(out))
    return out


def handoff_requests(reqs, payloads):
    """``GenerationRequest`` handles carrying the payloads."""
    from paddle_tpu_torch.serving import GenerationRequest

    out = []
    for (p, o), payload in zip(reqs, payloads):
        r = GenerationRequest(p, **o)
        r.kv_payload = payload
        out.append(r)
    return out


# ------------------------------------------------------------------- MoE --
def zero_gates(model):
    """``model`` with every MoE gate weight zeroed: every row then picks
    experts 0 and 1 (uniform probabilities, first index on ties), which
    crowds them and forces drops."""
    from paddle_tpu_torch.nn.moe import MoEMLP

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MoEMLP):
                m.gate.weight.zero_()
    return model


def graph_against_eager(dev, model, steps=8, max_batch_size=8):
    """Two engines (rng_seed 3) on ``model``, 8 slots of 512-token prompts
    each: one replays its decode graph, the other calls the same step
    body from Python on its buffers. Their tokens must be equal."""
    from paddle_tpu_torch.serving import GenerationEngine

    vocab = model.gpt.cfg.vocab_size
    outs = []
    for replay in (True, False):
        eng = GenerationEngine(model, max_batch_size=max_batch_size,
                               block_size=16, rng_seed=3, device=dev)
        fill_slots(eng, vocab, max_batch_size)
        if not replay:
            for buf, host in eng._mirrors():
                buf.copy_(torch.from_numpy(np.ascontiguousarray(host)))
        toks = []
        for _ in range(steps):
            if replay:
                toks.append(eng.decode_step().tolist())
            else:
                eng._decode_body()
                t = eng._d_toks.cpu().numpy()
                eng._finish_decode(eng._active, max_batch_size, t)
                toks.append(t.tolist())
        outs.append(toks)
        if replay and dev.type == "cuda" and not eng._decode_graph.captured:
            raise AssertionError("moe serving: the decode graph was not "
                                 "captured")
        del eng
    if outs[0] != outs[1]:
        raise AssertionError(f"moe serving: the decode graph's tokens "
                             f"{outs[0]} differ from the eager body's "
                             f"{outs[1]}")
    return steps * max_batch_size


def phase_moe_serving(dev, preset="gpt3-1.3B", dtype="bfloat16"):
    """9: the MoE model (``MOE``, full width and depth, bf16, seed 0)
    through phase 4's server and checks (one decode capture, K4 launched
    decode steps x n_layer times on the card's count, 0 kernels launched
    from the host in a steady step, one prefill capture per bucket, all
    at warm-up), then phase 4f's check of every prefill bucket (replay
    equal to its direct body, bitwise), the decode graph's tokens against
    the eager body's, and ``moe.metrics.publish`` on one eager forward of
    8 prompts of 512 tokens. Returns the result and phase 4's view of the
    tokens (for 9b)."""
    from paddle_tpu_torch.nn.moe import metrics

    t0 = time.perf_counter()
    model = build_gpt(dev, 0, preset, dtype=dtype, **MOE)
    cfg = model.gpt.cfg
    n_params = sum(p.numel() for p in model.parameters())
    log(f"moe serving: {preset} {dtype} {json.dumps(MOE)}: "
        f"{n_params / 1e9:.3f} B parameters, "
        f"{n_params * 2 / 1e9:.2f} GB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    result, plain = phase_serving(dev, preset, dtype, model=model, **MOE)
    result["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    result["parameters"] = n_params
    graphs = phase_prefill_graphs(dev, model)
    result["prefill_graphs"] = {
        "captures": graphs["captures"],
        "device_ms": {L: r["graph_device_ms"]
                      for L, r in graphs["per_bucket"].items()}}
    result["graph_equals_eager_tokens"] = graph_against_eager(dev, model)
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 512)))
    with torch.no_grad():
        model.gpt(tokens.to(dev))
    pub = metrics.publish(model)
    if pub is None or not 0.0 <= pub["drop_fraction"] < 1.0:
        raise AssertionError(f"moe serving: metrics.publish gave {pub}")
    result["eager_forward_8x512"] = {
        "drop_fraction": pub["drop_fraction"],
        "expert_tokens": pub["expert_tokens"].tolist(),
        "capacity_per_expert": moe_capacity_of(cfg, 512)}
    log("moe serving: " + json.dumps({k: v for k, v in result.items()
                                      if k not in ("launches", "fastpath")}))
    del model
    free_memory()
    return result, plain


def moe_capacity_of(cfg, rows):
    from paddle_tpu_torch.nn.moe import moe_capacity

    return moe_capacity(rows, cfg.moe_num_experts, cfg.moe_top_k,
                        cfg.moe_capacity_factor)


def phase_moe_spec(dev, plain, preset="gpt3-1.3B"):
    """9b: phase 5b's speculative serving on the MoE target (bf16, full
    width and depth, gpt2-small drafting), then phase 5 on the MoE layout
    in float32 at 2 layers, with random and with zeroed gate weights: K4
    against its plain route, and spec tokens against plain decode's with
    a twin drafter (every draft accepted, so every verify runs a full
    span) and an independent 1-layer one, greedy and sampled. The verify
    routes each row as its own group, as decode does, so no row loses
    its expert slot to its neighbours."""
    result = phase_spec_serving(dev, plain, preset, **MOE)
    result["float32_parity_max_logit_err"] = {
        gate: phase_parity(dev, preset, zero_gate=gate == "zero", **MOE)
        for gate in ("random", "zero")}
    return result


def phase_moe_training(dev, preset="gpt3-1.3B", n_layer=4, batch=4,
                       seq_len=2048, steps=4):
    """9c: the MoE model (``MOE``, full width, 4 layers, 2 of them MoE)
    trained through ``TrainStep`` + AdamW with master weights on one
    batch of 4 x 2048, loss + ``moe_aux_loss()`` (the first step eager,
    the second captured and replayed, the rest replays): the loss and
    the aux loss finite, the loss falling, K1-K3 launched once per layer
    per step on the card's count and the plain attention never. Reports
    the AccumulateGrad stream-mismatch warnings of each call, again with
    the MoE layers' ``aux_loss`` dropped after the warm-up, and the host
    calls that wait for the card over two steady replays."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.profiler import registry

    t0 = time.perf_counter()
    cfg, model, opt, train, tokens, labels = training_setup(
        dev, preset, batch, seq_len, n_layer=n_layer, **MOE)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"moe training: {preset} bf16 n_layer={n_layer} {json.dumps(MOE)}"
        f": {n_params / 1e9:.3f} B parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    registry.reset("kernels")
    fa.reset_device_launches()
    losses, auxes, times, warned = [], [], [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        with stream_mismatch_warnings() as seen:
            loss = train(tokens, labels)
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        warned.append(len(seen))
        losses.append(float(loss.detach()))
        auxes.append(float(model.moe_aux_loss().detach()))
    counts = dict(flash_device_counts(), flash_attention_ref=fa.launches()[
        "flash_attention_ref"])
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    prof = profile_steps(lambda: train(tokens, labels), 2)
    if not (all(np.isfinite(losses)) and all(np.isfinite(auxes))) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"moe training: losses {losses}, aux "
                             f"{auxes}: not finite and falling")
    for name in FLASH_KERNELS:
        if counts[name] != steps * n_layer:
            raise AssertionError(f"moe training: {counts[name]} {name} "
                                 f"launches, want {steps} x {n_layer}")
    if counts["flash_attention_ref"]:
        raise AssertionError("moe training: the plain attention ran")
    result = {"preset": preset, "n_layer": n_layer, "moe": MOE,
              "parameters": n_params, "batch": batch, "seq_len": seq_len,
              "losses": losses, "aux_losses": auxes,
              "step_ms": [t * 1e3 for t in times],
              "replay_step_ms": sorted(times[2:])[len(times[2:]) // 2]
              * 1e3,
              "tokens_per_s": batch * seq_len / min(times[2:]),
              "peak_memory_gb": peak_gb, "launches": counts,
              "stream_mismatch_warnings": warned,
              "host_syncs_2_replays": prof["host_syncs"],
              "graph_launches_2_replays": prof["graph_launches"]}
    del model, opt, train
    free_memory()
    result["stream_mismatch_warnings_aux_dropped"] = \
        moe_warnings_with_aux_dropped(dev, preset, n_layer, batch, seq_len)
    log("moe training: " + json.dumps(result))
    return result


class stream_mismatch_warnings:
    """``with stream_mismatch_warnings() as seen:`` records the autograd
    engine's AccumulateGrad stream-mismatch warnings raised inside."""

    def __enter__(self):
        self._cm = warnings.catch_warnings(record=True)
        self._seen = self._cm.__enter__()
        warnings.simplefilter("always")
        self.hits = []
        return self.hits

    def __exit__(self, *exc):
        self.hits.extend(w for w in self._seen
                         if "AccumulateGrad" in str(w.message))
        return self._cm.__exit__(*exc)


def moe_warnings_with_aux_dropped(dev, preset, n_layer, batch, seq_len):
    """9c's first two TrainStep calls (eager warm-up, capture) again, the
    MoE layers' ``aux_loss`` and ``last_stats`` (which hold the warm-up's
    autograd graph) dropped between them: the stream-mismatch warnings
    per call."""
    from paddle_tpu_torch.nn.moe import MoEMLP

    _, model, opt, train, tokens, labels = training_setup(
        dev, preset, batch, seq_len, n_layer=n_layer, **MOE)
    warned = []
    for _ in range(2):
        with stream_mismatch_warnings() as seen:
            train(tokens, labels)
            torch.cuda.synchronize()
        warned.append(len(seen))
        for m in model.modules():
            if isinstance(m, MoEMLP):
                m.aux_loss = m.last_stats = None
    del model, opt, train
    free_memory()
    return warned


# -------------------------------------------------- older cache forms --
def greedy_slot_cache(model, prompt, n, S):
    """Greedy tokens through the reference's slot-cache form: one prefill
    span into ``[1, S, H, Dh]`` buffers, then one row a step; the float32
    LM head, as the engine's."""
    gpt = model.gpt
    dev = gpt.device
    caches = [tuple(torch.zeros(1, S, b.attn.n_head, b.attn.head_dim,
                                device=dev, dtype=gpt.ln_f.weight.dtype)
                    for _ in range(2)) for b in gpt.blocks]
    head = gpt.embeddings.word_embeddings.weight.float()
    ids, off, out = list(prompt), 0, []
    with torch.no_grad():
        while len(out) < n:
            T = len(ids)
            x = torch.tensor([ids], device=dev)
            pos = torch.arange(off, off + T, device=dev)[None]
            h, caches = gpt(x, pos, caches=caches,
                            cache_offsets=torch.tensor([off], device=dev,
                                                       dtype=torch.int32),
                            seq_lens=torch.tensor([off + T], device=dev,
                                                  dtype=torch.int32))
            tok = int((h[0, -1].float() @ head.t()).argmax())
            out.append(tok)
            off += T
            ids = [tok]
    return out


def greedy_concat(model, prompt, n):
    """Greedy tokens through the growing-concat form, one row a step, the
    prompt included."""
    gpt = model.gpt
    dev = gpt.device
    caches = [tuple(torch.zeros(1, 0, b.attn.n_head, b.attn.head_dim,
                                device=dev, dtype=gpt.ln_f.weight.dtype)
                    for _ in range(2)) for b in gpt.blocks]
    head = gpt.embeddings.word_embeddings.weight.float()
    seq, out = list(prompt), []
    with torch.no_grad(), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the one-time legacy warning
        for t in range(len(prompt) + n - 1):
            h, caches = gpt(torch.tensor([[seq[t]]], device=dev),
                            torch.tensor([[t]], device=dev), caches=caches)
            if t >= len(prompt) - 1:
                tok = int((h[0, -1].float() @ head.t()).argmax())
                out.append(tok)
                seq.append(tok)
    return out


def phase_legacy_cache(dev, preset="gpt3-1.3B", n_layer=2, n_tokens=16):
    """9d: the reference's older cache forms at gpt3-1.3B width (2 layers,
    float32): greedy tokens through the slot cache and through one-row
    concat decoding equal the paged engine's (graphs, K4)."""
    from paddle_tpu_torch.serving import GenerationEngine

    model = build_gpt(dev, 3, preset, n_layer=n_layer, dtype="float32")
    prompt = np.random.default_rng(3).integers(
        0, model.gpt.cfg.vocab_size, 40).tolist()
    eng = GenerationEngine(model, max_batch_size=2, rng_seed=0, device=dev)
    paged = _spec_run(eng, prompt, n_tokens, seed=0)
    slot = greedy_slot_cache(model, prompt, n_tokens, S=64)
    concat = greedy_concat(model, prompt, n_tokens)
    if not paged == slot == concat:
        raise AssertionError(f"legacy caches: paged {paged}, slot cache "
                             f"{slot}, concat {concat}")
    log(f"legacy caches: {preset} width, {n_layer} layers float32, "
        f"{n_tokens} greedy tokens: slot cache and one-row concat equal the "
        "paged engine's")
    del eng, model
    free_memory()
    return {"tokens": n_tokens, "equal": True}


# ------------------------------------------------ encoder models (14-14d) --
def bert_flops_per_token(cfg, seq_len, training=True, lm_head=True):
    """Model FLOPs per token, in ``GPTConfig.flops_per_token``'s accounting:
    2 per weight of every matmul a token passes through (each layer's q, k,
    v, out and FFN; with ``lm_head`` the head's transform and the tied
    decoder; the pooler and the NSP or classifier head act on one token of
    a sequence and are left out), 4 * d * T per layer for the scores and
    the values (non-causal: every pair), and 3 forwards for a training
    step."""
    d, L = cfg.hidden_size, cfg.num_hidden_layers
    weights = L * (4 * d * d + 2 * d * cfg.intermediate_size)
    if lm_head:
        weights += d * d + cfg.vocab_size * d
    fwd = 2 * weights + 4 * L * d * seq_len
    return 3 * fwd if training else fwd


def bert_model(dev, dtype="float32", seed=0, dropout=True, attn_kernel=None,
               **cfg_over):
    """``BertForPretraining(bert_base(...))`` (random weights from ``seed``,
    the preset's dropout of 0.1 unless ``dropout`` is False), cast to
    ``dtype``. Returns ``(cfg, model)``."""
    from paddle_tpu_torch.models.bert import BertForPretraining, bert_base

    if not dropout:
        cfg_over.update(hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)
    bert = bert_base(device=dev, attn_kernel=attn_kernel,
                     generator=torch.Generator(device=dev).manual_seed(seed),
                     **cfg_over)
    model = BertForPretraining(bert)
    if dtype == "bfloat16":
        model.to(torch.bfloat16)
    return bert.cfg, model


def bert_batch(dev, vocab, batch, seq_len, seed=0):
    """The reference benchmark's batch (``tools/model_bench.py:92-96``):
    random ids from a seeded numpy generator, which are the MLM labels too,
    and NSP labels of 0."""
    ids = np.random.default_rng(seed).integers(0, vocab, (batch, seq_len))
    return (torch.from_numpy(ids).to(dev),
            torch.zeros(batch, 1, dtype=torch.int64, device=dev))


def fallbacks_since(seq):
    from paddle_tpu_torch.profiler import explainer

    return [e for e in explainer.events(kind="kernel_fallback")
            if e["seq"] > seq]


def last_event_seq():
    from paddle_tpu_torch.profiler import explainer

    evs = explainer.events()
    return evs[-1]["seq"] if evs else 0


def bert_training_setup(dev, dtype="float32", batch=16, seq_len=128,
                        seed=0):
    """Phase 14's step: ``bert_model`` in ``dtype`` (bf16: bf16 parameters,
    float32 master weights), ``BertPretrainingCriterion``, ``AdamW(1e-4)``
    under ``TrainStep`` and ``bert_batch``. Returns ``(cfg, model, opt,
    train, ids, nsp)``; ``train(ids, nsp)`` is one step (eager, then
    capture, then replays), ``train.step_fn(ids, nsp)`` the same step
    run eagerly."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.bert import BertPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    cfg, model = bert_model(dev, dtype, seed=seed)
    opt = AdamW(learning_rate=1e-4, multi_precision=dtype == "bfloat16",
                parameters=model.parameters())
    crit = BertPretrainingCriterion(cfg.vocab_size)
    ids, nsp = bert_batch(dev, cfg.vocab_size, batch, seq_len, seed=seed)

    def step_fn(ids, nsp):
        scores, rel = model(ids)
        loss = crit(scores, rel, ids, nsp)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return cfg, model, opt, TrainStep(step_fn, model, opt), ids, nsp


def phase_bert_pretraining(dev, dtype="float32", batch=16, seq_len=128,
                           steps=10):
    """14 / 14b: bert-base pretraining as the reference benchmarks it
    (``tools/model_bench.py:73-107``: ``BertForPretraining(bert_base())``,
    ``BertPretrainingCriterion(30522)``, ``AdamW(1e-4)``, one fixed batch,
    dropout 0.1, no padding mask) through ``TrainStep``'s CUDA graph in
    ``dtype`` (bf16: bf16 parameters, float32 master weights): ``steps``
    calls (eager, capture and replay, then timed replays). Checks: the
    loss finite and falling; one capture; K1, K2 and K3 launched once per
    layer per step on the card's count over the timed replays, all on the
    ``dtype`` instance, non-causal; no plain attention and no
    ``kernel_fallback``. Reports the p50 step (host clock, each step
    synchronised), tokens/s, MFU against ``dtype``'s peak and peak
    memory."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.profiler import registry

    t0 = time.perf_counter()
    cfg, model, opt, train, ids, nsp = bert_training_setup(
        dev, dtype, batch, seq_len)
    bf16 = dtype == "bfloat16"
    build_s = time.perf_counter() - t0
    registry.reset("jit")
    seq0 = last_event_seq()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses = [float(train(ids, nsp)) for _ in range(2)]
    torch.cuda.synchronize()
    registry.reset("kernels")
    fa.reset_device_launches()
    step_s = []
    for _ in range(steps - 2):
        t1 = time.perf_counter()
        losses.append(float(train(ids, nsp)))
        step_s.append(time.perf_counter() - t1)
    counts = fa.device_launches()
    py = fa.launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    jit = dict(registry.counters("jit"))
    L, n = cfg.num_hidden_layers, steps - 2
    other = "float32" if bf16 else "bfloat16"
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"bert {dtype}: losses {losses} are not finite "
                             "and falling")
    if model.bert.attn_kernel != "cuda":
        raise AssertionError(f"bert {dtype}: route "
                             f"{model.bert.attn_kernel!r} on the card")
    if jit["train_step_captures"] != 1 or jit["train_step_eager"] != 1:
        raise AssertionError(f"bert {dtype}: TrainStep counters {jit}")
    for name in FLASH_KERNELS:
        if counts["by_dtype"][dtype][name] != n * L or \
                counts["by_dtype"][other][name]:
            raise AssertionError(
                f"bert {dtype}: the card counted {counts['by_dtype']} "
                f"launches over {n} replays, want {n} x {L} {name} on the "
                f"{dtype} instance and none on {other}")
    fb = fallbacks_since(seq0)
    if any(py.values()) or fb:
        raise AssertionError(f"bert {dtype}: replays moved the Python "
                             f"counters {py} or fell back: {fb[-2:]}")
    p50 = sorted(step_s)[math.ceil(len(step_s) / 2) - 1]
    tokens = batch * seq_len
    flops = bert_flops_per_token(cfg, seq_len) * tokens
    peak = PEAK_FLOPS[torch.bfloat16 if bf16 else torch.float32]
    result = {"dtype": dtype, "batch": batch, "seq_len": seq_len,
              "n_layer": L, "steps": steps, "build_s": build_s,
              "step_p50_ms": p50 * 1e3,
              "step_ms": [round(s * 1e3, 3) for s in step_s],
              "tokens_per_s": tokens / p50, "mfu": flops / p50 / peak,
              "mfu_peak": PEAK_NAMES[torch.bfloat16] if bf16
              else "67 TFLOP/s float32 FMA (TF32 off)",
              "flops_per_step": flops, "losses": losses,
              "peak_memory_gb": peak_gb, "train_step": jit,
              "launches": {k: counts["by_dtype"][dtype][k]
                           for k in FLASH_KERNELS},
              "designs": dict.fromkeys(FLASH_KERNELS, instance_design(
                  torch.bfloat16 if bf16 else torch.float32,
                  cfg.hidden_size // cfg.num_attention_heads))}
    log(f"bert pretraining ({dtype}): " + json.dumps(result))
    del train, opt, model
    free_memory()
    return result


def resnet_macs(model, dev, side):
    """Multiply-adds of one image's forward through ``model``'s
    convolutions and Linear layers, counted from the shapes a forward at
    batch 1 gives them (eval mode, no gradient)."""
    from paddle_tpu_torch.nn.layer.conv import _ConvNd

    macs = [0]

    def conv_hook(mod, args, out):
        k = math.prod(mod.weight.shape[2:])
        cin = mod.weight.shape[0] if mod._transpose else mod.weight.shape[1]
        macs[0] += out.numel() * cin * k

    def linear_hook(mod, args, out):
        macs[0] += out.numel() * mod.in_features

    hooks = [m.register_forward_hook(conv_hook if isinstance(m, _ConvNd)
                                     else linear_hook)
             for m in model.modules()
             if isinstance(m, (_ConvNd, torch.nn.Linear))]
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(torch.zeros(1, 3, side, side, device=dev))
    finally:
        model.train(was)
        for h in hooks:
            h.remove()
    return macs[0]


def resnet_batch(dev, batch, side, seed=0):
    """``model_bench``'s synthetic batch: normal images and labels in
    [0, 10) from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 3, side, side)).astype(np.float32)
    y = rng.integers(0, 10, (batch,))
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def resnet_training_setup(dev, depth=50, batch=32, side=224,
                          num_classes=1000, seed=0, amp=None):
    """Phase 15's step (``tools/model_bench.py:43-70``): ``resnet<depth>``
    with seed-``seed`` weights, ``Momentum(0.1)``, ``F.cross_entropy``
    (the forward under ``auto_cast(level=amp)`` when ``amp`` is given)
    under ``TrainStep``, and the batch. Returns ``(model, opt, train, x,
    y)``; ``train(x, y)`` is one step (eager, then capture, then replays),
    ``train.step_fn(x, y)`` the same step run eagerly."""
    import contextlib

    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import models

    model = getattr(models, f"resnet{depth}")(
        num_classes=num_classes, device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed))
    opt = Momentum(0.1, parameters=model.parameters())
    x, y = resnet_batch(dev, batch, side, seed)

    def step_fn(xb, yb):
        with (auto_cast(level=amp) if amp else contextlib.nullcontext()):
            loss = F.cross_entropy(model(xb), yb)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return model, opt, TrainStep(step_fn, model, opt), x, y


def resnet_run(dev, steps, amp=None):
    """``steps`` calls of phase 15's step through the graph: the eager
    call and the capture, then timed replays (host clock, each read
    synchronised), then 2 replays under torch.profiler."""
    from paddle_tpu_torch.profiler import registry

    t0 = time.perf_counter()
    model, opt, train, x, y = resnet_training_setup(dev, amp=amp,
                                                    **RESNET_FULL)
    build_s = time.perf_counter() - t0
    macs = resnet_macs(model, dev, RESNET_FULL["side"])
    registry.reset("jit")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses = [float(train(x, y).detach()) for _ in range(2)]
    step_s = []
    for _ in range(steps - 2):
        t1 = time.perf_counter()
        losses.append(float(train(x, y)))
        step_s.append(time.perf_counter() - t1)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    jit = dict(registry.counters("jit"))
    prof = profile_steps(lambda: train(x, y), 2)
    p50 = sorted(step_s)[math.ceil(len(step_s) / 2) - 1]
    batch = RESNET_FULL["batch"]
    flops = 3 * 2 * macs * batch
    result = {"amp": amp or "float32", "batch": batch,
              "side": RESNET_FULL["side"], "steps": steps,
              "build_s": build_s, "step_p50_ms": p50 * 1e3,
              "step_ms": [round(t * 1e3, 3) for t in step_s],
              "images_per_s": batch / p50,
              "macs_per_image": macs, "flops_per_step": flops,
              "mfu": flops / p50 / PEAK_FLOPS[torch.float32],
              "mfu_peak": "67 TFLOP/s float32 FMA (TF32 off)",
              "least_step_ms": flops / PEAK_FLOPS[torch.float32] * 1e3,
              "losses": losses, "peak_memory_gb": peak_gb,
              "train_step": jit,
              "params": sum(p.numel() for p in model.parameters()),
              "host_kernel_launches_per_step": prof["kernel_launches"] / 2,
              "graph_launches_per_step": prof["graph_launches"] / 2,
              "kernels_per_step": prof["kernels"] / 2,
              "device_ms_per_step": prof["device_ms"] / 2}
    del train, opt, model
    free_memory()
    return result


def phase_resnet_training(dev, steps=10):
    """15: BASELINE config 1's ResNet-50 step at full scale through
    ``TrainStep``'s graph, float32, then under O1 (see the module's
    docstring). Checks: losses finite, one capture and one eager call a
    route, 0 kernels launched from the host a step (float32 route)."""
    fp32 = resnet_run(dev, steps)
    o1 = resnet_run(dev, steps, amp="O1")
    for r in (fp32, o1):
        if not all(np.isfinite(r["losses"])):
            raise AssertionError(f"resnet {r['amp']}: losses {r['losses']}")
        jit = r["train_step"]
        if jit["train_step_captures"] != 1 or jit["train_step_eager"] != 1:
            raise AssertionError(f"resnet {r['amp']}: TrainStep {jit}")
        if r["host_kernel_launches_per_step"] != 0 or \
                r["graph_launches_per_step"] != 1:
            raise AssertionError(
                f"resnet {r['amp']}: {r['host_kernel_launches_per_step']} "
                "kernels launched from the host and "
                f"{r['graph_launches_per_step']} graph launches a step")
    if fp32["params"] != 25557032:
        raise AssertionError(f"resnet50: {fp32['params']} parameters")
    log("resnet training: " + json.dumps({"float32": fp32, "O1": o1}))
    return fp32, o1


def _resnet_state(model):
    return {k: v.detach().float().cpu().clone()
            for k, v in model.state_dict().items()}


def _max_gap(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def phase_resnet_parity(dev, steps=3):
    """15b: ``resnet18(num_classes=10)`` at the tiny scale under
    ``cudnn.deterministic``: the graph route against a twin's eager steps,
    then the card's float32 step-0 forward, loss and gradients against the
    port's CPU float64 run of the same weights."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.vision import models

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _, _, graph, x, y = resnet_training_setup(dev, depth=18,
                                                  **RESNET_TINY)
        _, _, eager, _, _ = resnet_training_setup(dev, depth=18,
                                                  **RESNET_TINY)
        g_losses = [float(graph(x, y).detach()) for _ in range(steps)]
        e_losses = [float(eager.step_fn(x, y).detach())
                    for _ in range(steps)]
        g_state = _resnet_state(graph._models[0])
        e_state = _resnet_state(eager._models[0])
        scale = max(float(v.abs().max()) for v in e_state.values())
        gap = _max_gap(g_state, e_state)
        loss_gap = max(abs(a - b) for a, b in zip(g_losses, e_losses))
        if gap > RESNET_GRAPH_TOL * scale or loss_gap > RESNET_GRAPH_TOL * \
                max(abs(v) for v in e_losses):
            raise AssertionError(
                f"resnet parity: graph against eager: losses {g_losses} / "
                f"{e_losses}, state gap {gap} (scale {scale})")
        # the card's float32 step 0 against the CPU's float64
        card = models.resnet18(
            num_classes=10, device=dev,
            generator=torch.Generator(device=dev).manual_seed(1))
        cpu = models.resnet18(num_classes=10, device="cpu").double()
        cpu.load_state_dict({k: v.double() if v.is_floating_point() else v
                             for k, v in _resnet_state(card).items()})
        outs = []
        for m, xb in ((card, x), (cpu, x.cpu().double())):
            logits = m(xb)
            loss = F.cross_entropy(logits, y.to(xb.device))
            loss.backward()
            outs.append((logits.detach().cpu().double(),
                         loss.detach().cpu().double(),
                         {n: p.grad.detach().cpu().double()
                          for n, p in m.named_parameters()}))
        (lc, sc, gc_), (lf, sf, gf) = outs
        logits_gap = float((lc - lf).abs().max())
        loss_gap64 = float((sc - sf).abs())
        grad_rel, worst = max((float((gc_[n] - gf[n]).norm() / gf[n].norm()),
                               n) for n in gf)
        tol = RESNET_CPU_TOL
        if logits_gap > tol["logits"] * max(1.0, float(lf.abs().max())) or \
                loss_gap64 > tol["logits"] * max(1.0, float(sf.abs())) or \
                grad_rel > tol["grad_rel"]:
            raise AssertionError(
                f"resnet parity: card against CPU float64: logits gap "
                f"{logits_gap}, loss gap {loss_gap64}, gradients {grad_rel} "
                f"({worst})")
    finally:
        torch.backends.cudnn.deterministic = det
    result = {"graph_vs_eager": {"losses": g_losses, "eager": e_losses,
                                 "state_gap": gap, "state_scale": scale,
                                 "tol": RESNET_GRAPH_TOL},
              "card_vs_cpu_float64": {"logits_gap": logits_gap,
                                      "loss_gap": loss_gap64,
                                      "grad_rel_max": grad_rel,
                                      "grad_rel_worst": worst,
                                      "tol": tol}}
    log("resnet parity: " + json.dumps(result))
    free_memory()
    return result


# bf16 gradients of the kernel route against the plain route, relative in
# norm per parameter: phase 8's bound for two layers (the routes round P
# and dS, and the scores and probabilities, to bf16 in different places)
BF16_GRAD_REL = 5e-2


def phase_bert_parity(dev, n_layer=2, batch=4, seq_len=256):
    """14c at bert-base width and ``n_layer`` layers, dropout 0: for float32
    and bf16, one model on the kernel route and its copy on the plain
    route: the MLM logits and the loss within FLASH_PARITY_TOL, every
    gradient too in float32 and, in bf16, within ``BF16_GRAD_REL`` of the
    plain route's in norm. Then, on the kernel route in float32, a padded batch
    (a 2-D mask): the plain route taken, one ``kernel_fallback`` per layer
    naming the mask, K1-K3 not launched on the card's count;
    ``memory_efficient_attention`` with no bias, ``LowerTriangularMask``
    and a tensor bias against its plain version (output and gradients);
    a ``FusedTransformerEncoderLayer`` forward and backward against its
    plain route."""
    from paddle_tpu_torch.incubate import nn as inc
    from paddle_tpu_torch.models.bert import BertPretrainingCriterion
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.profiler import registry

    report = {}
    for dtype in ("float32", "bfloat16"):
        tol = fa.FLASH_PARITY_TOL[getattr(torch, dtype)]
        models = [bert_model(dev, dtype, seed=1, dropout=False,
                             attn_kernel=k, num_hidden_layers=n_layer)
                  for k in ("cuda", "torch")]
        cfg = models[0][0]
        crit = BertPretrainingCriterion(cfg.vocab_size)
        ids, nsp = bert_batch(dev, cfg.vocab_size, batch, seq_len, seed=1)
        registry.reset("kernels")
        outs = []
        for _, m in models:
            scores, rel = m(ids)
            loss = crit(scores, rel, ids, nsp)
            loss.backward()
            outs.append((scores.detach(), loss.detach()))
        err = {"logits": check_close(outs[0][0], outs[1][0], tol,
                                     f"bert parity {dtype} logits"),
               "loss": check_close(outs[0][1], outs[1][1], tol,
                                   f"bert parity {dtype} loss"),
               "grad": 0.0}
        plain = dict(models[1][1].named_parameters())
        for name, p in models[0][1].named_parameters():
            want = plain[name].grad
            # k_proj's bias has no gradient in exact arithmetic (softmax
            # ignores a shift shared by every key): both routes give
            # rounding noise there, held elementwise
            if dtype == "float32" or name.endswith("k_proj.bias"):
                err["grad"] = max(err["grad"], check_close(
                    p.grad, want, tol, f"bert parity {dtype} grad {name}"))
                continue
            # bf16: a weight's gradient sums the whole batch's rounded
            # terms, so it is held in norm (phase 8's bound)
            g = p.grad.float()
            rel = float((g - want.float()).norm() / want.float().norm())
            if not torch.isfinite(g).all() or not rel <= BF16_GRAD_REL:
                raise AssertionError(f"bert parity bf16 grad {name}: "
                                     f"relative error {rel:.3e} in norm "
                                     f"(bound {BF16_GRAD_REL})")
            err["grad"] = max(err["grad"], rel)
        counts = fa.launches()
        if counts["flash_fwd"] != n_layer or \
                counts["flash_bwd_dkv"] != n_layer or \
                counts["flash_attention_ref"] != n_layer:
            raise AssertionError(f"bert parity {dtype}: routes not taken: "
                                 f"{counts}")
        report[dtype] = err
        del models, outs
        free_memory()

    # a padded batch on the kernel route: the plain route, recorded
    cfg, model = bert_model(dev, "float32", seed=1, dropout=False,
                            num_hidden_layers=n_layer)
    ids, nsp = bert_batch(dev, cfg.vocab_size, batch, seq_len, seed=2)
    mask = torch.ones_like(ids)
    mask[:, seq_len // 2:] = 0
    torch.cuda.synchronize()
    registry.reset("kernels")
    fa.reset_device_launches()
    seq0 = last_event_seq()
    scores, rel = model(ids, attention_mask=mask)
    BertPretrainingCriterion(cfg.vocab_size)(scores, rel, ids,
                                             nsp).backward()
    torch.cuda.synchronize()
    fb = fallbacks_since(seq0)
    dev_counts = flash_device_counts()
    if any(dev_counts.values()) or \
            fa.launches()["flash_attention_ref"] != n_layer or \
            len(fb) != n_layer or \
            not all("attn_mask" in e["why"] for e in fb):
        raise AssertionError(f"bert parity: a padded batch launched "
                             f"{dev_counts} on the card, fell back "
                             f"{fb[-2:]} ({len(fb)})")
    report["padding_mask_fallback"] = fb[0]["why"]
    del model, scores, rel
    free_memory()

    # memory_efficient_attention and the fused encoder layer
    B, T, N, H = batch, seq_len, cfg.num_attention_heads, 64
    q, k, v, do = flash_case(dev, torch.float32, B, T, N, H, seed=3,
                             strided=True)
    bias = torch.randn(B, N, T, T, generator=torch.Generator(
        device="cpu").manual_seed(4)).to(dev)
    tol = fa.FLASH_PARITY_TOL[torch.float32]
    mea = {}
    for kind, attn_bias, mask, causal, launches in (
            ("none", None, None, False, 1),
            ("causal", inc.LowerTriangularMask(), None, True, 1),
            ("tensor", bias, bias, False, 0)):
        ins = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        ref_ins = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        registry.reset("kernels")
        out = inc.memory_efficient_attention(*ins, attn_bias=attn_bias)
        want = fa.flash_attention(*ref_ins, mask=mask, causal=causal,
                                  kernel="torch")
        out.backward(do)
        want.backward(do)
        got_k1 = fa.launches()["flash_fwd"]
        if got_k1 != launches:
            raise AssertionError(f"memory_efficient_attention {kind}: K1 "
                                 f"launched {got_k1} times, want {launches}")
        mea[kind] = max(check_close(a, b, tol, f"mea {kind} {what}")
                        for a, b, what in (
                            (out, want, "out"),
                            *((g.grad, w.grad, f"grad {i}") for i, (g, w)
                              in enumerate(zip(ins, ref_ins)))))
    report["memory_efficient_attention"] = mea
    layer = inc.FusedTransformerEncoderLayer(
        cfg.hidden_size, N, cfg.intermediate_size, 0.0,
        activation="gelu").to(dev)
    plain = copy.deepcopy(layer)
    plain.fused_attn.kernel = "torch"
    x = torch.randn(B, T, cfg.hidden_size, generator=torch.Generator(
        device="cpu").manual_seed(5)).to(dev)
    registry.reset("kernels")
    outs = []
    for m in (layer, plain):
        xi = x.clone().requires_grad_()
        y = m(xi)
        y.backward(torch.ones_like(y))
        outs.append((y.detach(), xi.grad))
    if fa.launches()["flash_fwd"] != 1 or \
            fa.launches()["flash_bwd_dkv"] != 1:
        raise AssertionError(f"fused layer: routes not taken "
                             f"{fa.launches()}")
    fused = max(check_close(outs[0][0], outs[1][0], tol, "fused out"),
                check_close(outs[0][1], outs[1][1], tol, "fused dx"))
    pgrads = dict(plain.named_parameters())
    for name, p in layer.named_parameters():
        if p.grad is not None:
            fused = max(fused, check_close(p.grad, pgrads[name].grad, tol,
                                           f"fused grad {name}"))
    report["fused_encoder_layer"] = fused
    log(f"bert parity: kernel vs plain route at bert-base width, {n_layer} "
        f"layers, batch {batch} x {seq_len}, max |err| "
        + json.dumps(report) + f" (FLASH_PARITY_TOL {fa.FLASH_PARITY_TOL})")
    free_memory()
    return report


def phase_ernie_inference(dev, batch=16, seq_len=128, iters=20):
    """14d: ``ErnieForSequenceClassification(ernie_3p0_medium(), 3)`` in
    eval mode, bf16, batch ``batch`` x ``seq_len``: each forward launches
    K1 once per layer (6) and never K2 or K3 on the card's count; the
    logits within FLASH_PARITY_TOL of the same model on the plain route.
    Reports the p50 forward (host clock, synchronised) and samples/s."""
    from paddle_tpu_torch.models.ernie import (
        ErnieForSequenceClassification, ernie_3p0_medium)
    from paddle_tpu_torch.nn.layer.transformer import MultiHeadAttention
    from paddle_tpu_torch.ops import flash_attention as fa

    ernie = ernie_3p0_medium(
        device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    model = ErnieForSequenceClassification(ernie, 3).to(torch.bfloat16)
    model.eval()
    cfg = ernie.cfg
    ids, _ = bert_batch(dev, cfg.vocab_size, batch, seq_len, seed=3)
    with torch.no_grad():
        model(ids)  # warm-up
        torch.cuda.synchronize()
        fa.reset_device_launches()
        fwd_s = []
        for _ in range(iters):
            t0 = time.perf_counter()
            logits = model(ids)
            torch.cuda.synchronize()
            fwd_s.append(time.perf_counter() - t0)
        counts = flash_device_counts()
        L = cfg.num_hidden_layers
        if counts != {"flash_fwd": iters * L, "flash_bwd_dq": 0,
                      "flash_bwd_dkv": 0}:
            raise AssertionError(f"ernie: the card counted {counts} over "
                                 f"{iters} forwards, want K1 {iters} x {L}")
        for mod in model.modules():
            if isinstance(mod, MultiHeadAttention):
                mod.kernel = "torch"
        plain = model(ids)
    tol = fa.FLASH_PARITY_TOL[torch.bfloat16]
    err = check_close(logits, plain, tol, "ernie logits kernel vs plain")
    p50 = sorted(fwd_s)[math.ceil(iters / 2) - 1]
    flops = bert_flops_per_token(cfg, seq_len, training=False,
                                 lm_head=False) * batch * seq_len
    result = {"batch": batch, "seq_len": seq_len, "n_layer": L,
              "forward_p50_ms": p50 * 1e3, "samples_per_s": batch / p50,
              "mfu": flops / p50 / PEAK_FLOPS[torch.bfloat16],
              "launches_per_forward": counts["flash_fwd"] / iters,
              "max_abs_err": err, "tolerance": list(tol)}
    log("ernie inference (bf16): " + json.dumps(result))
    del model, ernie
    free_memory()
    return result


ERNIE_STATIC = dict(batch=16, seq_len=128, small_batch=4, runs=20)
# 16b: the Executor's static training against TrainStep's eager-built
# step on the same weights and data (the same kernels in the same order:
# equality is expected; the bound allows float32 reassociation)
STATIC_TRAIN_TOL = 1e-5
STATIC_NO_DROPOUT = dict(hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0)


def ernie_classifier(dev, seed=0, **over):
    """BASELINE config 5's model (tools/model_bench.py:166-202):
    ``ErnieForSequenceClassification(ErnieModel(ErnieConfig()), 3)``,
    bert-base widths (12 layers, hidden 768, 12 heads, vocab 30522),
    float32, weights from ``seed``."""
    from paddle_tpu_torch.models.ernie import (
        ErnieConfig, ErnieForSequenceClassification, ErnieModel)

    ernie = ErnieModel(ErnieConfig(**over), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(seed))
    return ErnieForSequenceClassification(ernie, 3)


def ernie_static_setup(dev, batch=16, seq_len=128):
    """Phase 16's Program: ``ernie_classifier`` in eval mode recorded by
    ``build_static_inference_program`` (``static.data("input_ids", [None,
    seq_len], "int64")``). Returns ``(model, program, fetch, ids)``, ids a
    seeded numpy batch."""
    from paddle_tpu_torch.models.ernie import build_static_inference_program

    model = ernie_classifier(dev)
    model.eval()
    prog, _, fetch = build_static_inference_program(model, seq_len=seq_len)
    ids = np.random.default_rng(0).integers(
        0, model.ernie.cfg.vocab_size, (batch, seq_len)).astype(np.int64)
    return model, prog, fetch, ids


def ernie_static_training_setup(dev, batch=16, seq_len=128, n_feeds=6):
    """Phase 16b's Program: ``ernie_classifier`` without dropout, recorded
    with ``static.data`` ids and labels, ``cross_entropy`` and
    ``AdamW(1e-4).minimize``. Returns ``(model, program, loss, feeds)``,
    ``n_feeds`` seeded numpy batches."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.framework import disable_static, enable_static
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    model = ernie_classifier(dev, **STATIC_NO_DROPOUT)
    rng = np.random.default_rng(1)
    feeds = [{"ids": rng.integers(0, model.ernie.cfg.vocab_size,
                                  (batch, seq_len)).astype(np.int64),
              "labels": rng.integers(0, 3, (batch,)).astype(np.int64)}
             for _ in range(n_feeds)]
    prog = static.Program()
    enable_static()
    try:
        with static.program_guard(prog):
            ids = static.data("ids", [None, seq_len], "int64")
            labels = static.data("labels", [None], "int64")
            loss = F.cross_entropy(model(ids), labels)
            AdamW(learning_rate=1e-4).minimize(loss)
    finally:
        disable_static()
    return model, prog, loss, feeds


def host_calls(step, n):
    """``step()`` ``n`` times under torch.profiler: per call, the CUDA
    calls the host made by name (kernel launches, graph launches, copies),
    the card's activities and their summed time."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    calls, device_ms, activities = {}, 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            activities += 1
            device_ms += (e.time_range.end - e.time_range.start) / 1e3
        elif e.name.startswith(("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                                "cudaMemcpy", "cudaMemset")):
            calls[e.name] = calls.get(e.name, 0) + 1
    return {"host_calls": {k: v / n for k, v in sorted(calls.items())},
            "kernel_launches": sum(v for k, v in calls.items()
                                   if "Launch" in k and "Graph" not in k)
            / n,
            "device_activities": activities / n, "device_ms": device_ms / n}


def _set_attention_route(model, route):
    from paddle_tpu_torch.nn.layer.transformer import MultiHeadAttention

    for mod in model.modules():
        if isinstance(mod, MultiHeadAttention):
            mod.kernel = route


def phase_ernie_static(dev, **kw):
    """16: BASELINE config 5 at full width through the static Executor.
    The classifier is recorded by ``build_static_inference_program``
    (``static.data("input_ids", [None, 128], "int64")`` under
    ``program_guard``) and run by ``Executor.run`` at 16 x 128: run 1
    eagerly, run 2 captures one CUDA graph, the timed runs replay it (host
    clock, the numpy feed and the fetch included). The card counts 12 K1
    launches a run and no K2 or K3; the logits equal the same module's
    eager forward (the same kernels) and are within FLASH_PARITY_TOL of
    the plain attention route. A batch-4 feed captures a second graph,
    whose logits are the first four rows of batch 16's."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.profiler import registry

    cfg = dict(ERNIE_STATIC, **kw)
    B, T, runs = cfg["batch"], cfg["seq_len"], cfg["runs"]
    t0 = time.perf_counter()
    model, prog, fetch, ids_np = ernie_static_setup(dev, B, T)
    setup_s = time.perf_counter() - t0
    L = model.ernie.cfg.num_hidden_layers
    ids = torch.from_numpy(ids_np).to(dev)
    with torch.no_grad():
        model(ids)
        torch.cuda.synchronize()
        eager_s = []
        for _ in range(runs):
            t0 = time.perf_counter()
            eager = model(ids)
            torch.cuda.synchronize()
            eager_s.append(time.perf_counter() - t0)
        _set_attention_route(model, "torch")
        plain = model(ids)
        _set_attention_route(model, model.ernie.attn_kernel)
    scope = static.Scope()
    with static.scope_guard(scope):
        exe = static.Executor()
        registry.reset("jit")
        registry.reset("static")
        torch.cuda.reset_peak_memory_stats(dev)
        feed = {"input_ids": ids_np}
        for _ in range(2):  # the eager run, then the capture
            logits, = exe.run(prog, feed=feed, fetch_list=[fetch])
        torch.cuda.synchronize()
        fa.reset_device_launches()
        run_s = []
        for _ in range(runs):
            t0 = time.perf_counter()
            logits, = exe.run(prog, feed=feed, fetch_list=[fetch])
            run_s.append(time.perf_counter() - t0)
        counts = flash_device_counts()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        if counts != {"flash_fwd": runs * L, "flash_bwd_dq": 0,
                      "flash_bwd_dkv": 0}:
            raise AssertionError(f"ernie static: the card counted {counts} "
                                 f"over {runs} runs, want K1 {runs} x {L}")
        captures = registry.counters("jit")["train_step_captures"]
        if captures != 1:
            raise AssertionError(f"ernie static: {captures} captures for "
                                 "one feed signature")
        prof = host_calls(lambda: exe.run(prog, feed=feed,
                                          fetch_list=[fetch]), 3)
        small = ids_np[:cfg["small_batch"]]
        for _ in range(2):
            logits_small, = exe.run(prog, feed={"input_ids": small},
                                    fetch_list=[fetch])
        captures_after = registry.counters("jit")["train_step_captures"]
        static_counts = dict(registry.counters("static"))
    got = torch.from_numpy(logits)
    tol = fa.FLASH_PARITY_TOL[torch.float32]
    eager_err = float((got - eager.cpu()).abs().max())
    plain_err = check_close(got, plain.cpu(), tol,
                            "ernie static logits vs the plain route")
    check_close(got, eager.cpu(), tol, "ernie static logits vs eager")
    small_err = check_close(torch.from_numpy(logits_small),
                            got[:cfg["small_batch"]], tol,
                            "ernie static batch 4 vs rows of batch 16")
    if captures_after != 2:
        raise AssertionError(f"ernie static: {captures_after} captures for "
                             "two feed signatures")
    p50 = sorted(run_s)[math.ceil(runs / 2) - 1]
    eager_p50 = sorted(eager_s)[math.ceil(runs / 2) - 1]
    flops = bert_flops_per_token(model.ernie.cfg, T, training=False,
                                 lm_head=False) * B * T
    result = {"batch": B, "seq_len": T, "n_layer": L, "runs": runs,
              "setup_s": setup_s, "ops": len(prog.ops),
              "params": len(prog.params),
              "run_p50_ms": p50 * 1e3, "samples_per_s": B / p50,
              "run_ms": [round(t * 1e3, 3) for t in run_s],
              "eager_forward_p50_ms": eager_p50 * 1e3,
              "least_run_ms": flops / PEAK_FLOPS[torch.float32] * 1e3,
              "device_ms_per_run": prof["device_ms"],
              "device_activities_per_run": prof["device_activities"],
              "host_calls_per_run": prof["host_calls"],
              "host_kernel_launches_per_run": prof["kernel_launches"],
              "k1_launches_per_run": counts["flash_fwd"] / runs,
              "captures": captures, "captures_after_batch_4": captures_after,
              "static_counters": static_counts,
              "max_abs_err_vs_eager": eager_err,
              "max_abs_err_vs_plain": plain_err,
              "max_abs_err_batch_4": small_err, "tolerance": list(tol),
              "peak_memory_gb": peak_gb}
    log("ernie static (16): " + json.dumps(result))
    return result, (model, prog, fetch, scope, ids_np, logits, logits_small)


def phase_ernie_static_io(dev, ctx):
    """16a: phase 16's Program saved by ``save_inference_model`` and served
    by ``create_predictor(Config(prefix))`` on the card from that one
    artifact at batch 16 and batch 4 (each signature: an eager run, a
    capture, replays): equal to phase 16's logits, 12 K1 launches a run
    on the card's count. ``jit.save`` / ``jit.load`` of the same
    classifier agrees with both."""
    from paddle_tpu_torch import inference, jit, static
    from paddle_tpu_torch.ops import flash_attention as fa

    model, prog, fetch, scope, ids_np, logits, logits_small = ctx
    L = model.ernie.cfg.num_hidden_layers
    tol = fa.FLASH_PARITY_TOL[torch.float32]
    d = tempfile.mkdtemp(prefix="chip_smoke_static_")
    try:
        t0 = time.perf_counter()
        with static.scope_guard(scope):
            static.save_inference_model(
                f"{d}/ernie", [prog.feed_vars["input_ids"]], [fetch],
                static.Executor(), program=prog)
        export_s = time.perf_counter() - t0
        pred = inference.create_predictor(inference.Config(f"{d}/ernie"))
        small = ids_np[:logits_small.shape[0]]
        for _ in range(2):
            out16 = pred.run([ids_np])[0]
            out4 = pred.run([small])[0]
        torch.cuda.synchronize()
        fa.reset_device_launches()
        runs, run_s = 5, []
        for _ in range(runs):
            t1 = time.perf_counter()
            out16 = pred.run([ids_np])[0]
            run_s.append(time.perf_counter() - t1)
        counts = flash_device_counts()
        if counts["flash_fwd"] != runs * L:
            raise AssertionError(f"predictor: the card counted {counts} "
                                 f"over {runs} runs, want K1 {runs} x {L}")
        err16 = check_close(torch.from_numpy(out16), torch.from_numpy(logits),
                            tol, "predictor batch 16 vs the Executor")
        err4 = check_close(torch.from_numpy(out4),
                           torch.from_numpy(logits_small), tol,
                           "predictor batch 4 vs the Executor")
        t0 = time.perf_counter()
        jit.save(model, f"{d}/jit", input_spec=[
            static.InputSpec([None, ids_np.shape[1]], "int64")])
        jit_save_s = time.perf_counter() - t0
        layer = jit.load(f"{d}/jit")
        out_jit = layer(torch.from_numpy(ids_np)).cpu()
        err_jit = check_close(out_jit, torch.from_numpy(logits), tol,
                              "jit.load vs the Executor")
        err_jit_pred = check_close(out_jit, torch.from_numpy(out16), tol,
                                   "jit.load vs the Predictor")
        jit_pred = inference.create_predictor(inference.Config(f"{d}/jit"))
        err_jit_served = check_close(
            torch.from_numpy(jit_pred.run([small])[0]),
            torch.from_numpy(logits_small), tol,
            "jit.save artifact through the Predictor vs the Executor")
        size_mb = sum(os.path.getsize(f"{d}/ernie{x}")
                      for x in (".pdmodel", ".pdiparams")) / 1e6
    finally:
        shutil.rmtree(d, ignore_errors=True)
    p50 = sorted(run_s)[math.ceil(runs / 2) - 1]
    result = {"export_s": export_s, "jit_save_s": jit_save_s,
              "artifact_mb": size_mb, "predictor_run_p50_ms": p50 * 1e3,
              "k1_launches_per_run": counts["flash_fwd"] / runs,
              "max_abs_err_batch_16": err16, "max_abs_err_batch_4": err4,
              "max_abs_err_jit_vs_executor": err_jit,
              "max_abs_err_jit_vs_predictor": err_jit_pred,
              "max_abs_err_jit_predictor_batch_4": err_jit_served}
    log("ernie static save/load (16a): " + json.dumps(result))
    return result


def phase_ernie_static_training(dev, steps=5, batch=16, seq_len=128):
    """16b: the same classifier (dropout 0) recorded with
    ``static.data`` ids and labels, ``F.cross_entropy`` and
    ``AdamW(1e-4).minimize(loss)``; ``steps`` Executor runs at 16 x 128
    float32 through one graph: K1, K2 and K3 12 times a run on the card's
    count, no kernel launched from the host on a replay (only the feed,
    scalar, output and fetch copies). The losses against the same model trained
    by TrainStep from the same weights (STATIC_TRAIN_TOL). Then
    ``static.save``, ``load_program`` into a fresh scope and one more run:
    bitwise the run the original Program makes next."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import registry

    model, prog, loss, feeds = ernie_static_training_setup(
        dev, batch, seq_len, steps + 1)
    L = model.ernie.cfg.num_hidden_layers
    scope = static.Scope()
    d = tempfile.mkdtemp(prefix="chip_smoke_static_")
    try:
        with static.scope_guard(scope):
            exe = static.Executor()
            registry.reset("jit")
            torch.cuda.synchronize()
            fa_counts, losses, step_s = [], [], []
            for f in feeds[:steps]:
                fa.reset_device_launches()
                t0 = time.perf_counter()
                losses.append(float(exe.run(prog, feed=f,
                                            fetch_list=[loss])[0]))
                step_s.append(time.perf_counter() - t0)
                fa_counts.append(flash_device_counts())
            captures = registry.counters("jit")["train_step_captures"]
            want = {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
            if any(c != want for c in fa_counts):
                raise AssertionError(f"static training: the card counted "
                                     f"{fa_counts}, want {want} a run")
            static.save(prog, f"{d}/ckpt")
            continued = float(exe.run(prog, feed=feeds[steps],
                                      fetch_list=[loss])[0])
            prof = host_calls(lambda: exe.run(prog, feed=feeds[steps],
                                              fetch_list=[loss]), 1)
        with static.scope_guard(static.Scope()):
            loaded = static.load_program(f"{d}/ckpt")
            resumed = float(static.Executor().run(
                loaded, feed=feeds[steps],
                fetch_list=[loaded.vars[loss.name]])[0])
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if resumed != continued:
        raise AssertionError(f"static training: the loaded Program's next "
                             f"loss {resumed!r}, the original's "
                             f"{continued!r}")
    del exe, prog, scope, loaded, model
    free_memory()
    # TrainStep from the same weights on the same data
    twin = ernie_classifier(dev, **STATIC_NO_DROPOUT)
    opt = AdamW(learning_rate=1e-4, parameters=twin.parameters())

    def step_fn(ids, labels):
        out = F.cross_entropy(twin(ids), labels)
        out.backward()
        opt.step()
        opt.clear_grad()
        return out

    train = TrainStep(step_fn, twin, opt)
    ref = [float(train(torch.from_numpy(f["ids"]).to(dev),
                       torch.from_numpy(f["labels"]).to(dev)).detach())
           for f in feeds[:steps]]
    gaps = [abs(a - b) for a, b in zip(losses, ref)]
    if max(gaps) > STATIC_TRAIN_TOL * max(abs(x) for x in ref):
        raise AssertionError(f"static training losses {losses} vs "
                             f"TrainStep's {ref}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"static training: losses {losses}")
    del twin, opt, train
    free_memory()
    p50 = sorted(step_s[2:])[math.ceil((steps - 2) / 2) - 1]
    result = {"batch": batch, "seq_len": seq_len, "steps": steps,
              "losses": losses, "trainstep_losses": ref,
              "max_loss_gap": max(gaps), "tolerance": STATIC_TRAIN_TOL,
              "step_p50_ms": p50 * 1e3,
              "step_ms": [round(t * 1e3, 3) for t in step_s],
              "captures": captures,
              "launches_per_run": fa_counts[-1],
              "host_calls_per_replay": prof["host_calls"],
              "host_kernel_launches_per_replay": prof["kernel_launches"],
              "device_ms_per_replay": prof["device_ms"],
              "resumed_loss": resumed, "continued_loss": continued}
    if prof["kernel_launches"] != 0:
        raise AssertionError(f"static training: {prof['host_calls']} from "
                             "the host on a replay")
    log("ernie static training (16b): " + json.dumps(result))
    return result


def phase_static_control_flow(dev):
    """16c: a small Program holding ``static.nn.while_loop`` (a counter
    summing a feed) and ``static.nn.cond`` (a branch on the feed's sign)
    on the card, three runs: the values against numpy, and the route the
    Executor took, with the reason it gives."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.framework import disable_static, enable_static
    from paddle_tpu_torch.profiler import explainer, registry

    prog = static.Program()
    enable_static()
    try:
        with static.program_guard(prog):
            x = static.data("x", [None, 4], "float32")
            limit = static.data("limit", [1], "float32")
            i, acc = static.nn.while_loop(
                lambda i, a: i < limit, lambda i, a: [i + 1.0, a + x.sum()],
                [torch.zeros(1), torch.zeros(1)])
            out = static.nn.cond(x.sum() > 0.0, lambda: x * 2.0,
                                 lambda: x - 10.0)
    finally:
        disable_static()
    registry.reset("static")
    registry.reset("jit")
    seq = last_event_seq()
    xs = np.arange(8, dtype=np.float32).reshape(2, 4) - 3.0
    with static.scope_guard(static.Scope()):
        exe = static.Executor()
        for sign in (1.0, -1.0, 1.0):
            feed = {"x": sign * xs, "limit": np.array([5.0], np.float32)}
            iv, av, ov = exe.run(prog, feed=feed, fetch_list=[i, acc, out])
            want = sign * xs * 2.0 if (sign * xs).sum() > 0 \
                else sign * xs - 10.0
            if float(iv[0]) != 5.0 or float(av[0]) != 5 * float(
                    (sign * xs).sum()) or not np.array_equal(ov, want):
                raise AssertionError(f"static control flow: {iv} {av} {ov}")
    counters = dict(registry.counters("static"))
    events = [e for e in explainer.events(kind="static_uncaptured")
              if e["seq"] > seq]
    if counters["uncaptured_runs"] != 3 or len(events) != 1 or \
            registry.counters("jit")["train_step_captures"]:
        raise AssertionError(f"static control flow: counters {counters}, "
                             f"events {events}")
    result = {"route": "uncaptured", "why": events[0]["why"],
              "uncaptured_runs": counters["uncaptured_runs"],
              "captures": 0}
    log("static control flow (16c): " + json.dumps(result))
    return result


# ------------------------------------------------------------------ main --
_ENTRY = re.compile(r"Compiling entry function '\S*?\d((?:flash|paged)_\w*?"
                    r"_kernel(?:_sm90|_tf32)?)I(\w*?)E+v")
_TYPES = {"13__nv_bfloat16": "bf16", "f": "float32"}


# ------------------------------------------- distributed on one card (12) --
MP_STEPS = 3
# phase 12's loss gap to phase 7's, two bf16 ulps at a loss of 8 to 16:
# both losses are rounded to bf16 (one ulp, 0.0625, between them at
# most), and the row-parallel layers round each rank's partial product to
# bf16 before the all-reduce adds them, where one GEMM rounds once; the
# logits move by about one of their own ulps, the mean loss by far less
MP_LOSS_TOL = 0.125
# phase 12's first-step logits (this rank's vocabulary block) against
# phase 7's model whole, the largest gap over 4 x 2048 x 25152 logits: an
# H100 read 0.078-0.085 (mean 0.0106, mean |logit| 0.72), the bf16
# row-parallel sums' rounding; three times that, 16 bf16 ulps where
# |logit| is 2 to 4, while the contiguous-qkv control misses by 5.0-5.8
MP_LOGITS_TOL = 0.25
# 12b: float32 with TF32 off, SGD: the only differences are the order of
# the float32 sums (the row-parallel partial products, the averaged
# gradients), about 1e-6 relative; 3 steps at rate 0.1 keep them ~1e-7
SMALL_PARAM_TOL = 1e-5


def _fleet_init(dp, mp):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    fleet.init(is_collective=True, strategy=s)
    return fleet.get_hybrid_communicate_group()


def mp_rank_leg(steps, setup_kw):
    """Phase 12 on one rank (a child of this script, gloo on its device):
    ``fleet.init(mp_degree=2)``, phase 7's model (gpt3-1.3B bf16, full
    width and depth, seed 0; ``setup_kw`` for ``training_setup``) through
    ``fleet.distributed_model``, its AdamW with master weights and its
    batch, ``steps`` eager steps. Then ``TrainStep`` over the same model
    must refuse the gloo group."""
    from paddle_tpu_torch.distributed import parallel_env
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.profiler import registry

    dev = parallel_env.device()
    t0 = time.perf_counter()
    hcg = _fleet_init(1, 2)
    mp = hcg.get_model_parallel_group()
    model_kw = {k: v for k, v in setup_kw.items()
                if k not in ("batch", "learning_rate")}
    # phase 7's model whole (the same seed and builder): its first-step
    # logits, this rank's block of the vocabulary
    _, whole = pretraining_model(dev, **model_kw)
    tokens, _ = pretraining_batch(dev, whole.gpt.cfg.vocab_size,
                                  setup_kw.get("batch", 4),
                                  whole.gpt.cfg.seq_len)
    with torch.no_grad():
        want = vocab_block(whole(tokens), mp.rank, mp.nranks)
    del whole
    cfg, model, opt, step_fn, tokens, labels = training_setup(
        dev, graph=False, distribute=True, **setup_kw)
    with torch.no_grad():
        logits_gap = gap_of(model(tokens), want)
    heads = model.gpt.blocks[0].attn.qkv_proj.weight.shape[0] // (
        3 * model.gpt.blocks[0].attn.head_dim)
    build_s = time.perf_counter() - t0
    cuda = dev.type == "cuda"  # the CPU only in a rehearsal
    registry.reset("collective")
    if cuda:
        fa.reset_device_launches()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        losses.append(float(step_fn(tokens, labels).detach()))
        if cuda:
            torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t1)
    counts = flash_device_counts() if cuda else None
    coll = dict(registry.counters("collective"))
    reduced = sum(v for k, v in coll.items()
                  if k.endswith(".bytes") and k.split(".")[0] in (
                      "psum", "pmax", "all_reduce"))
    try:
        TrainStep(step_fn, model, opt)
        refused = None
    except ValueError as e:
        refused = str(e)
    state_gb = sum(t.numel() * t.element_size() for t in (
        *model.parameters(),
        *(v for st in opt._accumulators.values() for v in st.values())))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
    del model, opt, step_fn
    control = contiguous_qkv_gap(dev, model_kw, tokens, want)
    return {"rank": hcg.get_model_parallel_rank(), "heads": heads,
            "n_head": cfg.n_head, "n_layer": cfg.n_layer,
            "losses": losses, "step_s": step_s, "build_s": build_s,
            "launches": counts, "bytes_reduced_per_step": reduced / steps,
            "collective": coll, "peak_memory_gb": peak_gb,
            "state_gb": state_gb / 1e9, "capture_refused": refused,
            "logits_gap": logits_gap, "contiguous_qkv_gap": control}


def vocab_block(logits, rank, nranks):
    """Rank ``rank``'s block of ``nranks`` of the vocabulary (the mp
    form's LM head's columns)."""
    v = logits.shape[-1] // nranks
    return logits[..., rank * v:(rank + 1) * v].clone()


def gap_of(got, want):
    """The largest and the mean absolute gap of two logits tensors, and
    the mean absolute logit."""
    d = (got.float() - want.float()).abs()
    return {"max": float(d.max()), "mean": float(d.mean()),
            "mean_abs_logit": float(want.float().abs().mean())}


def contiguous_qkv_gap(dev, model_kw, tokens, want):
    """The control of phase 12's logits check: phase 7's model with q, k
    and v split as one contiguous block of ``qkv_proj``'s columns (a third
    of the heads' q, k and v each, not whole heads), through
    ``fleet.distributed_model``; its first-step logits' gap to ``want``."""
    from paddle_tpu_torch.distributed import fleet

    _, model = pretraining_model(dev, **model_kw)
    for blk in model.gpt.blocks:
        for p in (blk.attn.qkv_proj.weight, blk.attn.qkv_proj.bias):
            p.shard_layout = (1, 1)
    fleet.distributed_model(model)
    with torch.no_grad():
        return gap_of(model(tokens), want)


def _small_model(dev, n_layer, preset="gpt3-1.3B", seed=0, **over):
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)

    cfg = GPTConfig.preset(preset, n_layer=n_layer, seq_len=512,
                           dropout=0.0, **over)
    return cfg, GPTForPretraining(GPTModel(
        cfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed)))


def small_rank_leg(dp, mp, ckpt_dir, model_kw, steps=3, n_layer=2,
                   batch=4):
    """Phase 12b on one rank: gpt3-1.3B width at ``n_layer`` layers in
    float32 (seed 0), SGD(0.1), ``steps`` eager steps on batch x 512
    tokens (seed 0), once in this process alone and once at ``dp x mp``
    (this rank's rows of the batch, its mp slices); the parameters merged
    back against the single-process run's. At dp > 1 the trained state is
    then saved as a sharded checkpoint (this rank's chunk)."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import (collective, fleet, parallel_env,
                                              spmd)
    from paddle_tpu_torch.incubate.checkpoint import (CheckpointManager,
                                                      capture_training_state)
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import SGD

    dev = parallel_env.device()
    crit = GPTPretrainingCriterion()
    vocab = model_kw.get("vocab_size", 50304)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, vocab, (batch, 513))).to(dev)

    def train(model, x, y):
        opt = SGD(learning_rate=0.1, parameters=model.parameters())
        out = []
        for _ in range(steps):
            loss = crit(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            out.append(loss.detach())
        return out

    _, plain = _small_model(dev, n_layer, **model_kw)
    plain_losses = train(plain, toks[:, :-1], toks[:, 1:])
    want = {k: v.detach().cpu() for k, v in
            convert.state_to_paddle_tpu(plain).items()}
    del plain
    hcg = _fleet_init(dp, mp)
    _, model = _small_model(dev, n_layer, **model_kw)
    fleet.distributed_model(model)
    x, y = (spmd.shard_batch(t) for t in (toks[:, :-1], toks[:, 1:]))
    losses = train(model, x, y)
    for loss in losses:
        collective.all_reduce(loss, collective.ReduceOp.AVG,
                              group=hcg.get_data_parallel_group())
    got = convert.merged_state_to_paddle_tpu(model)
    diff = max(float((got[k].float() - want[k].float()).abs().max())
               for k in want)
    loss_diff = max(abs(float(a) - float(b))
                    for a, b in zip(losses, plain_losses))
    saved = None
    if dp > 1:
        mgr = CheckpointManager(ckpt_dir, async_save=False, shard=True)
        mgr.save(capture_training_state(model), step=steps)
        saved = {k: float(v.double().sum())
                 for k, v in convert.state_to_paddle_tpu(model).items()}
    return {"max_param_diff": diff, "max_loss_diff": loss_diff,
            "rows": tuple(x.shape), "saved_sums": saved}


NCCL_WORLD_1 = """
import torch
from paddle_tpu_torch.distributed import (barrier, collective,
                                          init_parallel_env, parallel_env)
import torch.distributed as dist
init_parallel_env(timeout=120)
t = torch.ones(8, device="cuda")
collective.all_reduce(t)
barrier()
torch.cuda.synchronize()
print(dist.get_backend(), float(t.sum()), str(parallel_env.device()))
dist.destroy_process_group()
"""


def two_ranks(dev, root):
    """Phases 12 and 13's world: two ranks, children of this script, on
    the card (``cuda:0``) over gloo; on the CPU in a rehearsal."""
    from paddle_tpu_torch.testing.world import World

    device = "cuda:0" if dev.type == "cuda" else "cpu"
    return World(2, root, timeout=600, device=device, backend="gloo")


def phase_distributed(dev, world, phase7_losses, setup_kw=None,
                      model_kw=None):
    """12, 12b, 12c on ``world`` (``two_ranks``): see the module's
    docstring. ``setup_kw`` and ``model_kw`` cut the models of 12 and 12b
    (a rehearsal on the CPU)."""
    from paddle_tpu_torch.incubate.checkpoint import load_resharded

    free_memory()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    result = {}
    try:
        ranks = world.run(mp_rank_leg, MP_STEPS, setup_kw or {})
        small = {kind: world.run(small_rank_leg, dp, mp,
                                 os.path.join(tmp, "ckpt"), model_kw or {})
                 for kind, (dp, mp) in (("dp2", (2, 1)), ("mp2", (1, 2)))}
        log("distributed: first-step logits against phase 7's model's: "
            + json.dumps([{k: r[k] for k in (
                "rank", "logits_gap", "contiguous_qkv_gap")} for r in ranks]))
        for r in ranks:
            if not r["logits_gap"]["max"] <= MP_LOGITS_TOL:
                raise AssertionError(
                    f"tensor parallel: rank {r['rank']}'s first-step logits "
                    f"miss phase 7's model's by {r['logits_gap']} > "
                    f"{MP_LOGITS_TOL}")
            if not r["contiguous_qkv_gap"]["max"] > MP_LOGITS_TOL:
                raise AssertionError(
                    f"tensor parallel: the contiguous qkv split's logits "
                    f"pass the check ({r['contiguous_qkv_gap']}): it has "
                    "no teeth")
            gaps = [abs(a - b) for a, b in zip(r["losses"], phase7_losses)]
            if max(gaps) > MP_LOSS_TOL or not all(
                    np.isfinite(r["losses"])):
                raise AssertionError(
                    f"tensor parallel: rank {r['rank']}'s losses "
                    f"{r['losses']} against phase 7's {phase7_losses[:3]}: "
                    f"gaps {gaps} > {MP_LOSS_TOL}")
            r["loss_gaps"] = gaps
            if r["heads"] != r["n_head"] // 2:
                raise AssertionError(f"tensor parallel: {r['heads']} heads "
                                     f"a rank, want {r['n_head']} / 2")
            for name in FLASH_KERNELS if r["launches"] is not None else ():
                if r["launches"][name] != MP_STEPS * r["n_layer"]:
                    raise AssertionError(
                        f"tensor parallel: rank {r['rank']} counted "
                        f"{r['launches'][name]} {name} launches, want "
                        f"{MP_STEPS} x {r['n_layer']}")
            if r["launches"] is not None and (
                    not r["capture_refused"]
                    or "gloo" not in r["capture_refused"]):
                raise AssertionError("tensor parallel: TrainStep did not "
                                     "refuse a gloo group on the card")
        for kind, res in small.items():
            for i, r in enumerate(res):
                if r["max_param_diff"] > SMALL_PARAM_TOL:
                    raise AssertionError(
                        f"12b {kind}: rank {i}'s parameters after 3 steps "
                        f"miss the single-process run's by "
                        f"{r['max_param_diff']} > {SMALL_PARAM_TOL}")
        state, man = load_resharded(os.path.join(tmp, "ckpt"), rank=0,
                                    world_size=1)
        sums = {k: float(np.asarray(v, np.float64).sum())
                for k, v in state["model"].items()}
        want = small["dp2"][0]["saved_sums"]
        for res in small.values():
            for r in res:
                r.pop("saved_sums")
        if not man["sharded"] or man["world_size"] != 2 or any(
                abs(sums[k] - v) > 1e-9 * max(1.0, abs(v))
                for k, v in want.items()):
            raise AssertionError("12b: the sharded checkpoint written at "
                                 "world 2 did not read back whole")
        result.update(ranks=ranks, small=small, checkpoint_world_2={
            "manifest_world_size": man["world_size"],
            "sharded": man["sharded"]})
        result["nccl_world_1"] = nccl_world_1()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("distributed: " + json.dumps(result, default=str))
    return result


# ------------------- pipeline, ZeRO and expert parallelism (21-21c) --
PP_M = 4  # microbatches a step in 21 and 21a (1 row of 2048 each)
# 21c's aux loss against the ep = 1 run, relative. At step 0 both runs
# hold the same weights and batch, and the ep ranks all-reduce the [E]
# sums of f and P before the product, so only the order of the sums
# differs: an H100 read 0.023484081 against 0.023484079 (7.9e-8). A mean
# of the ranks' local aux losses is another number, and fails it. Later
# steps follow weights that the bf16 updates moved apart: it read
# 0.0383454 against 0.0383840 (1.0e-3), then 0.0581708 against 0.0593080
# (1.9e-2).
MOE_AUX_STEP0_REL = 1e-5
MOE_AUX_LATER_REL = 5e-2


def _hybrid_fleet(**degrees):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict(degrees)
    s.pipeline_configs = {"accumulate_steps": PP_M}
    fleet.init(is_collective=True, strategy=s)
    return s, fleet.get_hybrid_communicate_group()


def _sent_bytes():
    from paddle_tpu_torch.profiler import registry

    return registry.counters("collective").get("send.bytes", 0)


def _staged():
    from paddle_tpu_torch.profiler import registry

    return {k: v for k, v in registry.counters("collective").items()
            if "staged" in k}


def _digest(t):
    import hashlib

    return hashlib.sha256(t.detach().contiguous().view(torch.int16).cpu()
                          .numpy().tobytes()).hexdigest()


def pp_rank_leg(kind, steps, setup_kw):
    """21 (``kind`` "gpipe") or 21a ("1f1b") on one rank of the two-rank
    world: ``fleet.init(pp_degree=2)`` with ``PP_M`` microbatches, phase
    7's model (gpt3-1.3B bf16, full width and depth, seed 0; ``setup_kw``
    cuts it in a rehearsal), AdamW with master weights, phase 7's batch,
    ``steps`` steps. GPipe goes through ``hapi.Model.train_batch`` on the
    pp mesh (which builds a ``PipelineSpmdStep``); 1F1B through
    ``fleet.HybridParallelEngine``."""
    from paddle_tpu_torch import hapi
    from paddle_tpu_torch.distributed import fleet, parallel_env
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import registry

    dev = parallel_env.device()
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    strategy, hcg = _hybrid_fleet(pp_degree=2)
    model_kw = {k: v for k, v in setup_kw.items()
                if k not in ("batch", "learning_rate")}
    cfg, model = pretraining_model(dev, **model_kw)
    tokens, labels = pretraining_batch(dev, cfg.vocab_size,
                                       setup_kw.get("batch", 4), cfg.seq_len)
    opt = AdamW(learning_rate=setup_kw.get("learning_rate", 1e-4),
                multi_precision=True, parameters=model.parameters())
    crit = GPTPretrainingCriterion()
    if kind == "gpipe":
        m = hapi.Model(model)
        m.prepare(optimizer=opt, loss=crit)

        def step():
            return m.train_batch([tokens], [labels])[0]
    else:
        engine = fleet.HybridParallelEngine(model, opt, hcg, strategy, crit)

        def step():
            return float(engine.train_batch([tokens, labels]))
    build_s = time.perf_counter() - t0
    registry.reset("collective")
    if cuda:
        fa.reset_device_launches()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s, sent = [], [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        before = _sent_bytes()
        losses.append(step())
        if cuda:
            torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t1)
        sent.append(_sent_bytes() - before)
    counts = flash_device_counts() if cuda else None
    runner = m._pp_step.runner if kind == "gpipe" else engine.runner
    out = {"rank": hcg.get_stage_id(), "kind": kind, "losses": losses,
           "step_s": step_s, "build_s": build_s, "launches": counts,
           "sent_bytes_per_step": sent, "staged": _staged(),
           "step_type": type(m._pp_step).__name__ if kind == "gpipe"
           else type(engine).__name__,
           "live_inputs_max": runner.live_max,
           "layers_held": len(runner.my_blocks), "n_layer": cfg.n_layer,
           "stage_param_gb": runner.stage_param_bytes / 1e9,
           "tied_embedding_sha256": _digest(
               model.gpt.embeddings.word_embeddings.weight),
           "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9
           if cuda else None}
    del model, opt, runner
    if kind == "gpipe":
        del m
    else:
        del engine
    free_memory()
    return out


def zero_rank_leg(level, steps, offload=False, model_kw=None, batch=4):
    """21b on one rank: gpt3-1.3B width at 4 layers bf16 (seed 0), AdamW
    with master weights, the batch of 4 x 2048 split over sharding = 2;
    ``level`` None is the unsharded yardstick (dp = 2 in the same world),
    else ``group_sharded_parallel(level, offload)``. Returns the losses
    (the whole batch's), step times, peak memory and the bytes of the
    tensors this rank holds on the card after the last backward
    (parameters, gradients, optimizer state)."""
    from paddle_tpu_torch.distributed import (collective, fleet,
                                              parallel_env, spmd)
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    dev = parallel_env.device()
    cuda = dev.type == "cuda"
    kw = dict(n_layer=4, **(model_kw or {}))
    if level is None:
        _hybrid_fleet(dp_degree=2)
    else:
        _hybrid_fleet(sharding_degree=2)
    cfg, model = pretraining_model(dev, **kw)
    tokens, labels = pretraining_batch(dev, cfg.vocab_size, batch,
                                       cfg.seq_len)
    opt = AdamW(learning_rate=1e-4, multi_precision=True,
                parameters=model.parameters())
    n_elem = sum(p.numel() for p in model.parameters())
    bytes_2d = sum(p.numel() * p.element_size() for p in model.parameters()
                   if p.dim() >= 2)
    if level is None:
        fleet.distributed_model(model)
    else:
        model, opt, _ = group_sharded_parallel(model, opt, level,
                                               offload=offload)
    crit = GPTPretrainingCriterion()
    x, y = spmd.shard_batch(tokens), spmd.shard_batch(labels)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s, held = [], [], None
    for i in range(steps):
        t1 = time.perf_counter()
        loss = crit(model(x), y)
        loss.backward()
        if i == steps - 1 and level is not None:
            held = opt.held_bytes()
        opt.step()
        opt.clear_grad()
        loss = loss.detach().float()
        collective.all_reduce(loss, collective.ReduceOp.AVG)
        losses.append(float(loss))
        if cuda:
            torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t1)
    inner = getattr(model, "_layers", model)
    out = {"level": level, "offload": offload, "losses": losses,
           "step_s": step_s, "held": held, "param_elements": n_elem,
           "bytes_2d_whole": bytes_2d,
           "bytes_2d_held": sum(p.numel() * p.element_size()
                                for p in inner.parameters() if p.dim() >= 2),
           "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9
           if cuda else None}
    del model, opt, inner
    free_memory()
    return out


def moe_ep_rank_leg(steps, model_kw):
    """21c on one rank: phase 9c's MoE model (``MOE``, gpt3-1.3B width, 4
    layers, 2 of them MoE) at ep = 2 (4 experts of each bank a rank), the
    batch of 4 x 2048 split over ep, AdamW with master weights, ``steps``
    eager steps; the losses and aux losses, block 0's per-expert token
    counts at step 0, the all-to-all bytes of each step."""
    from paddle_tpu_torch.distributed import (collective, fleet,
                                              parallel_env, spmd)
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.nn.moe import MoEMLP
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import registry

    dev = parallel_env.device()
    cuda = dev.type == "cuda"
    _hybrid_fleet(ep_degree=2)
    cfg, model = pretraining_model(dev, **dict(MOE, n_layer=4, **model_kw))
    fleet.distributed_model(model)
    tokens, labels = pretraining_batch(dev, cfg.vocab_size, 4, cfg.seq_len)
    opt = AdamW(learning_rate=1e-4, multi_precision=True,
                parameters=model.parameters())
    crit = GPTPretrainingCriterion()
    x, y = spmd.shard_batch(tokens), spmd.shard_batch(labels)
    moe = [b.mlp for b in model.gpt.blocks if isinstance(b.mlp, MoEMLP)]
    if cuda:
        fa.reset_device_launches()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    losses, auxes, step_s, a2a, counts = [], [], [], [], None
    for i in range(steps):
        t1 = time.perf_counter()
        before = registry.counters("collective").get("all_to_all.bytes", 0)
        loss = crit(model(x), y)
        aux = model.moe_aux_loss()
        (loss + aux).backward()
        opt.step()
        opt.clear_grad()
        if i == 0:
            counts = moe[0].last_stats["expert_tokens"].tolist()
        loss = loss.detach().float()
        collective.all_reduce(loss, collective.ReduceOp.AVG)
        losses.append(float(loss))
        auxes.append(float(aux.detach()))
        if cuda:
            torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t1)
        a2a.append(registry.counters("collective").get(
            "all_to_all.bytes", 0) - before)
    out = {"losses": losses, "aux_losses": auxes, "step_s": step_s,
           "counts_step0": counts, "a2a_bytes_per_step": a2a,
           "experts_held": int(moe[0].w1.shape[0]), "moe_layers": len(moe),
           "rows": tuple(x.shape), "staged": _staged(),
           "launches": flash_device_counts() if cuda else None,
           "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9
           if cuda else None}
    del model, opt, moe
    free_memory()
    return out


def moe_ep1_run(dev, steps, model_kw):
    """21c's yardstick in this process: phase 9c's model and step
    (``training_setup``) uncaptured, the same weights and batch at ep 1."""
    from paddle_tpu_torch.nn.moe import MoEMLP

    cfg, model, opt, step_fn, tokens, labels = training_setup(
        dev, graph=False, **dict(MOE, **model_kw))
    moe = [b.mlp for b in model.gpt.blocks if isinstance(b.mlp, MoEMLP)]
    losses, auxes, counts = [], [], None
    for i in range(steps):
        total = step_fn(tokens, labels)
        aux = float(model.moe_aux_loss().detach())
        if i == 0:
            counts = moe[0].last_stats["expert_tokens"].tolist()
        losses.append(float(total.detach()) - aux)
        auxes.append(aux)
    from paddle_tpu_torch.nn.moe.gate import moe_capacity

    E = cfg.moe_num_experts
    cap = moe_capacity(cfg.seq_len, E, cfg.moe_top_k,
                       cfg.moe_capacity_factor)
    elem = torch.tensor([], dtype=cfg.torch_dtype).element_size()
    out = {"losses": losses, "aux_losses": auxes, "counts_step0": counts,
           "shape": (E, tokens.shape[0] // 2, cap, cfg.d_model),
           "moe_layers": len(moe), "element_size": elem}
    del model, opt, step_fn
    free_memory()
    return out


def phase_parallel_axes(dev, world, phase7_losses, setup_kw=None,
                        model_kw=None):
    """21, 21a, 21b, 21c on ``world`` (``two_ranks``): see the module's
    docstring. ``setup_kw`` / ``model_kw`` cut the models in a rehearsal
    on the CPU."""
    setup_kw = setup_kw or {}
    model_kw = model_kw or {}
    free_memory()
    res = {}
    t0 = time.perf_counter()
    gp = world.run(pp_rank_leg, "gpipe", MP_STEPS, setup_kw)
    res["gpipe_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    f1 = world.run(pp_rank_leg, "1f1b", MP_STEPS, setup_kw)
    res["1f1b_s"] = time.perf_counter() - t0
    cuda = dev.type == "cuda"
    n_layer = gp[0]["n_layer"]
    batch = setup_kw.get("batch", 4)
    seq = setup_kw.get("seq_len", 2048)
    d_model = model_kw.get("d_model", 2048)
    mb = batch // PP_M
    want_sent = 2 * PP_M * mb * seq * d_model * 2
    for name, legs in (("gpipe", gp), ("1f1b", f1)):
        if legs[0]["tied_embedding_sha256"] != \
                legs[1]["tied_embedding_sha256"]:
            raise AssertionError(f"21 {name}: the tied word embedding "
                                 "differs between the two stages")
        for r in legs:
            gaps = [abs(a - b) for a, b in zip(r["losses"], phase7_losses)]
            if not all(np.isfinite(r["losses"])) or max(gaps) > MP_LOSS_TOL:
                raise AssertionError(
                    f"21 {name}: rank {r['rank']}'s losses {r['losses']} "
                    f"against phase 7's {phase7_losses}: gaps {gaps} > "
                    f"{MP_LOSS_TOL}")
            r["loss_gaps"] = gaps
            if r["layers_held"] != n_layer // 2:
                raise AssertionError(f"21 {name}: rank {r['rank']} holds "
                                     f"{r['layers_held']} blocks")
            want_k = MP_STEPS * PP_M * n_layer // 2
            for kern in FLASH_KERNELS if cuda else ():
                if r["launches"][kern] != want_k:
                    raise AssertionError(
                        f"21 {name}: rank {r['rank']} counted "
                        f"{r['launches'][kern]} {kern} launches, want "
                        f"{MP_STEPS} x {PP_M} x {n_layer // 2}")
        sent = [a + b for a, b in zip(legs[0]["sent_bytes_per_step"],
                                      legs[1]["sent_bytes_per_step"])]
        if any(s != want_sent for s in sent):
            raise AssertionError(f"21 {name}: boundary bytes a step {sent}, "
                                 f"predicted {want_sent}")
        res[name] = {"ranks": legs, "sent_bytes_per_step": sent,
                     "sent_bytes_predicted": want_sent}
    if gp[0]["step_type"] != "PipelineSpmdStep":
        raise AssertionError("21: hapi did not build a PipelineSpmdStep")
    live = [r["live_inputs_max"] for r in f1]
    if max(live) > 2 * 2 - 1:
        raise AssertionError(f"21a: {live} live microbatch inputs > 2pp-1")
    gaps = [abs(a - b) for a, b in zip(f1[0]["losses"], gp[0]["losses"])]
    if max(gaps) > MP_LOSS_TOL:
        raise AssertionError(f"21a: 1F1B losses {f1[0]['losses']} against "
                             f"GPipe's {gp[0]['losses']}")
    res["1f1b_vs_gpipe_gaps"] = gaps

    # 21b ZeRO
    t0 = time.perf_counter()
    plain = world.run(zero_rank_leg, None, MP_STEPS, False, model_kw)
    levels = {lv: world.run(zero_rank_leg, lv, MP_STEPS, False, model_kw)
              for lv in ("os", "os_g", "p_g_os")}
    offload = world.run(zero_rank_leg, "os_g", 1, True, model_kw)
    res["zero_s"] = time.perf_counter() - t0
    for lv, legs in (*levels.items(), ("os_g offload", offload)):
        for r in legs:
            gaps = [abs(a - b) for a, b in zip(r["losses"],
                                               plain[0]["losses"])]
            if max(gaps) > MP_LOSS_TOL or not all(np.isfinite(r["losses"])):
                raise AssertionError(f"21b {lv}: losses {r['losses']} "
                                     f"against unsharded "
                                     f"{plain[0]['losses']}")
            r["loss_gaps"] = gaps
            h, n = r["held"], r["param_elements"]
            opt_whole = n * 12  # two float32 moments + a float32 master
            grads_whole = n * 2  # bf16 gradients
            want_opt = 0 if r["offload"] else opt_whole // 2
            want_grads = grads_whole if lv == "os" else grads_whole // 2
            want_2d = r["bytes_2d_whole"] // (2 if lv == "p_g_os" else 1)
            if h["optimizer"] != want_opt or h["grads"] != want_grads or \
                    r["bytes_2d_held"] != want_2d:
                raise AssertionError(
                    f"21b {lv}: held {h}, 2-d parameters "
                    f"{r['bytes_2d_held']}; want optimizer {want_opt}, "
                    f"grads {want_grads}, 2-d parameters {want_2d}")
    res["zero"] = {"unsharded": plain, **levels, "os_g offload": offload}

    # 21c expert parallelism: the ep 1 yardstick here, then the ranks
    t0 = time.perf_counter()
    ep1 = moe_ep1_run(dev, MP_STEPS, dict(n_layer=4, **model_kw))
    ep2 = world.run(moe_ep_rank_leg, MP_STEPS, model_kw)
    res["moe_s"] = time.perf_counter() - t0
    E, G, C, H = ep1["shape"]
    want_a2a = 4 * ep1["moe_layers"] * E * G * C * H * ep1["element_size"]
    for r in ep2:
        gaps = [abs(a - b) for a, b in zip(r["losses"], ep1["losses"])]
        if max(gaps) > MP_LOSS_TOL:
            raise AssertionError(f"21c: losses {r['losses']} against ep 1's "
                                 f"{ep1['losses']}")
        rel = [abs(a - b) / abs(b)
               for a, b in zip(r["aux_losses"], ep1["aux_losses"])]
        limits = [MOE_AUX_STEP0_REL] + [MOE_AUX_LATER_REL] * (len(rel) - 1)
        if any(g > lim for g, lim in zip(rel, limits)):
            raise AssertionError(
                f"21c: aux losses {r['aux_losses']} against ep 1's "
                f"{ep1['aux_losses']}: relative gaps {rel} over {limits}")
        r["aux_rel_gaps"] = rel
        if r["counts_step0"] != ep1["counts_step0"]:
            raise AssertionError(f"21c: expert counts {r['counts_step0']} "
                                 f"against ep 1's {ep1['counts_step0']}")
        if any(b != want_a2a for b in r["a2a_bytes_per_step"]):
            raise AssertionError(f"21c: all-to-all bytes "
                                 f"{r['a2a_bytes_per_step']}, predicted "
                                 f"{want_a2a}")
        if r["experts_held"] != E // 2:
            raise AssertionError(f"21c: {r['experts_held']} experts a rank")
        for kern in FLASH_KERNELS if cuda else ():
            if not r["launches"][kern]:
                raise AssertionError(f"21c: {kern} never launched")
    res["moe"] = {"ep2": ep2, "ep1": ep1, "a2a_predicted": want_a2a}
    log("parallel axes: " + json.dumps(res, default=str))
    return res


# ------------------------------------------ serving on a mesh (13, 13b) --
MESH_BATCH = 8


class MeshStream:
    """Test instrumentation on one rank of a mesh engine: its prefills
    (``PrefillLogits``), every decode step's token block, the bytes each
    decode step moved through the ``collective`` scope's all-reduces and
    all-gathers, and, for each prompt whose tokens leave ``want``'s (by
    prompt), the step's logits row at the first position they differ. The
    follower's engine runs its calls through the same attributes."""

    def __init__(self, engine, want=None):
        from paddle_tpu_torch.profiler import registry

        self._registry = registry
        self.engine = engine
        self.first = PrefillLogits(engine)
        self.decoded = []
        self.step_bytes = []
        self.want = want or {}
        self.differ = {}  # prompt -> (position, logits row on the device)
        self._made = {}   # slot -> [prompt, tokens so far]
        self._decode = engine.decode_step
        engine.decode_step = self.decode_step

    def _bytes(self):
        c = self._registry.counters("collective")
        return {kind: sum(v for k, v in c.items() if k.endswith(".bytes")
                          and k.split(".")[0] in ops)
                for kind, ops in (("reduced", ("psum", "all_reduce")),
                                  ("gathered", ("all_gather",)))}

    def decode_step(self):
        active = np.nonzero(self.engine._active)[0]
        b0 = self._bytes()
        toks = self._decode()
        b1 = self._bytes()
        self.step_bytes.append({k: b1[k] - b0[k] for k in b1})
        self.decoded.append(toks.tolist())
        for s in active:
            prompt = self.first.slots[s]
            made = self._made.get(s)
            if made is None or made[0] != prompt:
                made = self._made[s] = [prompt, 1]
            want, pos = self.want.get(prompt, ()), made[1]
            if pos < len(want) and prompt not in self.differ and \
                    int(toks[s]) != want[pos]:
                self.differ[prompt] = (pos, self.engine.last_logits[s].clone())
            made[1] += 1
        return toks

    def restore(self):
        del self.engine.prefill, self.engine.decode_step


def mesh_step_bytes(cfg, batch=MESH_BATCH, mp=2):
    """The bytes one rank's decode step must all-reduce and gather at mp:
    per layer the attention's and the MLP's row-parallel partial sums
    ``[batch, 1, d_model]``, the embedding lookup's, and the logits
    ``[batch, vocab / mp]`` float32 gathered (the local input of each)."""
    es = torch.finfo(cfg.torch_dtype).bits // 8
    reduced = (2 * cfg.n_layer + 1) * batch * cfg.d_model * es
    return {"reduced": reduced,
            "gathered": batch * cfg.vocab_size // mp * 4}


def mesh_serving_rank(base_key, want, n_requests, preset="gpt3-1.3B",
                      model_kw=None):
    """Phase 13 on one rank (a child of this script, gloo on its device):
    phase 4's model (gpt3-1.3B bf16, seed 0, full width and depth; cut by
    ``model_kw`` in a rehearsal) behind ``GenerationServer(mesh=
    serving_mesh(2))`` with phase 4's base key. Rank 0 serves phase 4's
    mix and shuts down; rank 1 follows. Each rank returns what it
    computed: the prefill and decode tokens, the bytes each decode step
    moved, its K4 launches, peak memory, rank 0's answers and, for each
    request whose tokens leave phase 4's (``want``, by request), its
    logits at the first position they differ."""
    from paddle_tpu_torch.distributed import parallel_env, spmd
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import GenerationServer

    dev = parallel_env.device()
    cuda = dev.type == "cuda"  # the CPU only in a rehearsal
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = build_gpt(dev, 0, preset, dtype="bfloat16", **(model_kw or {}))
    cfg = model.gpt.cfg
    mesh = spmd.serving_mesh(2, model=model)
    srv = GenerationServer(model, max_batch_size=MESH_BATCH, block_size=16,
                           max_queue_size=64, device=dev, mesh=mesh)
    eng = srv.engine
    eng._base_key = base_key.clone()  # phase 4's engine's, on every rank
    del model
    build_s = time.perf_counter() - t0
    reqs = serving_requests(cfg.vocab_size, n=n_requests)
    stream = MeshStream(eng, {tuple(p): w for (p, _), w in zip(reqs, want)})
    for scope in ("collective", "serving", "fastpath", "kernels"):
        registry.reset(scope)
    if cuda:
        build_peak = torch.cuda.max_memory_allocated(dev) / 1e9
        pa.reset_device_launches()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out = {"rank": mesh.rank, "build_s": build_s,
           "local_heads": int(eng._kv[0][0].shape[2]),
           "n_layer": cfg.n_layer}
    if mesh.rank == 0:
        t1 = time.perf_counter()
        try:
            handles = [srv.submit(p, **o) for p, o in reqs]
            for h in handles:
                h.result(timeout=900)
        finally:
            srv.shutdown()
        out["wall_s"] = time.perf_counter() - t1
        bad = [h.rid for h in handles if h.status != "done"
               or len(h.tokens) != h.max_new_tokens]
        if bad:
            raise AssertionError(f"mesh serving: unfinished requests {bad}")
        out["tokens"] = [list(h.tokens) for h in handles]
        out["first_logits"] = stream.first.of([p for p, _ in reqs])
        out["differ"] = {i: (stream.differ[tuple(p)][0],
                             stream.differ[tuple(p)][1].cpu())
                         for i, (p, _) in enumerate(reqs)
                         if tuple(p) in stream.differ}
        out["describe"] = eng.describe_sharding()
        st = eng.stats()
        out["stats"] = {k: st[k] for k in (
            "mesh_axes", "paged_kernel", "paged_kernel_sharded",
            "paged_kernel_reason", "decode_graph", "decode_graph_reason")}
        out["decode_step_p50_ms"] = registry.timings("serving")[
            "serving.decode_step"]["p50_ms"]
    else:
        out["followed"] = srv.follow()
    stream.restore()
    out["events"] = (stream.first.tokens, stream.decoded)
    steps = len(stream.step_bytes)
    out["decode_steps"] = steps
    out["bytes_per_step"] = {k: sum(b[k] for b in stream.step_bytes) / steps
                             for k in ("reduced", "gathered")}
    out["serving"] = {k: v for k, v in registry.counters("serving").items()
                      if v}
    out["launches"] = ({instance_name(k): v for k, v in
                        pa.device_launches().items()} if cuda else
                       {"plain": registry.counters("kernels")[
                           "paged_attention_ref"]})
    out["peak_memory_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                             if cuda else None)
    out["build_peak_memory_gb"] = build_peak if cuda else None
    return out


def decision_gap(logits, temperature, top_k, top_p, gumbel):
    """The sampler's decision margin in logit units: twice the largest
    error every logit may carry while ``sample_tokens`` still picks the
    same token (a logit error of d moves a gap between two logits by up to
    2d). Greedy: the top two logits' gap. Sampled: the least of the top
    two scores' gap (filtered, scaled logits plus the Gumbel noise) times
    the temperature, and, with a nucleus (``top_p < 1``), how far the
    nucleus is from dropping the chosen token or admitting a token of a
    higher score: token t's probability mass ranked above it, B_t, moves
    by a factor of at most exp(2d / T), so t crosses the nucleus' edge
    ``top_p`` once 2d >= T |ln(B_t / top_p)|."""
    from paddle_tpu_torch.serving import sampling

    logits = logits.float().reshape(1, -1)
    dev = logits.device
    if not temperature:
        top = logits[0].topk(2).values
        return float(top[0] - top[1])
    T = float(temperature)
    scaled = sampling.filter_top_k(logits / T,
                                   torch.tensor([int(top_k)], device=dev))
    kept = sampling.filter_top_p(scaled,
                                 torch.tensor([float(top_p)], device=dev))
    scores = (kept + gumbel)[0]
    top = scores.topk(2)
    margins = [float(top.values[0] - top.values[1]) * T]
    if top_p < 1.0:
        order = scaled[0].argsort(descending=True)
        probs = torch.softmax(scaled[0][order].double(), -1)
        above = torch.empty_like(probs)
        above[order] = torch.cumsum(probs, -1) - probs
        chosen = int(top.indices[0])
        if above[chosen] > 0:
            margins.append(T * float(torch.log(top_p / above[chosen])))
        rivals = ~torch.isfinite(kept[0]) & (scaled[0] + gumbel[0]
                                            > top.values[0])
        if bool(rivals.any()):
            margins.append(T * float(torch.log(above[rivals].min()
                                               / top_p)))
    return min(margins)


def near_tie_gaps(dev, reqs, tokens, diffs, base_key, preset="gpt3-1.3B",
                  model_kw=None):
    """For each ``(request, position)`` of ``diffs``: the single-card
    engine's decision margin (``decision_gap``) at that position of the
    request, on phase 4's weights and base key, and its logits there,
    taken by prefilling the prompt and ``tokens[request][:position]``."""
    from paddle_tpu_torch.serving import GenerationEngine, sampling

    eng = GenerationEngine(build_gpt(dev, 0, preset, dtype="bfloat16",
                                     **(model_kw or {})),
                           max_batch_size=MESH_BATCH, block_size=16,
                           device=dev)
    eng._base_key = base_key.clone()
    V = eng.vocab_size
    out = []
    for i, pos in diffs:
        prompt, o = reqs[i]
        eng.prefill(0, list(prompt) + list(tokens[i][:pos]), seed=o["seed"],
                    max_new_tokens=1)
        logits = eng.last_prefill_logits[0].clone()
        eng.release(0)
        key = torch.as_tensor(eng._request_key(o["seed"])).to(dev)
        gum = sampling.gumbel_rows(key[None],
                                   torch.tensor([pos], device=dev), V)
        out.append((decision_gap(logits, o.get("temperature", 0.0),
                                 o.get("top_k", 0), o.get("top_p", 1.0),
                                 gum), logits.cpu()))
    del eng
    free_memory()
    return out


def phase_mesh_serving(dev, world, plain, n_requests=16, preset="gpt3-1.3B",
                       model_kw=None):
    """13: gpt3-1.3B bf16 served at mp = 2 by two ranks on the card over
    gloo (``mesh_serving_rank``): both ranks' tokens equal, K4 launched
    at its 16-head instance decode steps x 24 times on each, every
    request's first-token logits within ``MP_LOGITS_TOL`` of phase 4's
    (``plain``), and each request whose tokens differ from phase 4's
    differing first at a near-tie of the single card's: its decision
    margin there (``decision_gap``) within 2 x ``MP_LOGITS_TOL``, and the
    mesh's logits at that position within ``MP_LOGITS_TOL`` of the single
    card's. The decode step's collective bytes must match
    ``mesh_step_bytes`` within 1%."""
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig.preset(preset, dtype="bfloat16", **(model_kw or {}))
    ranks = world.run(mesh_serving_rank, plain["base_key"], plain["tokens"],
                      n_requests, preset, model_kw)
    r0, r1 = ranks
    if r0["events"] != r1["events"]:
        raise AssertionError("mesh serving: the two ranks emitted other "
                             "tokens")
    want_heads = cfg.n_head // 2
    pools = r0["describe"]["kv_pools"]
    if any(r["local_heads"] != want_heads for r in ranks) or any(
            p["spec"] != [None, None, "mp"] or p["shape"][2] != cfg.n_head
            for p in pools) or len(pools) != 2 * cfg.n_layer:
        raise AssertionError(
            f"mesh serving: {[r['local_heads'] for r in ranks]} heads a "
            f"rank (want {want_heads}), pools {pools[:2]}")
    if not r0["stats"]["paged_kernel_sharded"] or \
            r0["stats"]["decode_graph"]:
        raise AssertionError(f"mesh serving: {r0['stats']}")
    for r in ranks:
        want = r["decode_steps"] * cfg.n_layer
        got = r["launches"]
        name = instance_name(("bfloat16", cfg.d_model // cfg.n_head, 1))
        if dev.type == "cuda" and got != {name: want} or \
                dev.type != "cuda" and got["plain"] != want:
            raise AssertionError(
                f"mesh serving: rank {r['rank']} counted K4 launches {got}, "
                f"want {r['decode_steps']} steps x {cfg.n_layer}")
    predicted = mesh_step_bytes(cfg)
    for r in ranks:
        for k, v in predicted.items():
            if abs(r["bytes_per_step"][k] - v) > 0.01 * v:
                raise AssertionError(
                    f"mesh serving: rank {r['rank']} {k} "
                    f"{r['bytes_per_step'][k]:.0f} bytes per decode step, "
                    f"predicted {v}")
    gaps = [float((a.float() - b.float()).abs().max())
            for a, b in zip(r0["first_logits"], plain["first_logits"])]
    if max(gaps) > MP_LOGITS_TOL:
        raise AssertionError(f"mesh serving: first-token logits miss phase "
                             f"4's by {max(gaps)} > {MP_LOGITS_TOL}")
    reqs = serving_requests(cfg.vocab_size, n=n_requests)
    diffs = []
    for i, (a, b) in enumerate(zip(r0["tokens"], plain["tokens"])):
        if a != b:
            diffs.append((i, next(j for j, (x, y) in enumerate(zip(a, b))
                                  if x != y)))
    near = near_tie_gaps(dev, reqs, plain["tokens"], diffs,
                         plain["base_key"], preset, model_kw) if diffs else []
    firsts = []
    for (i, j), (gap, single) in zip(diffs, near):
        pos, mesh_row = r0["differ"][i] if j else (0, r0["first_logits"][i])
        firsts.append({"request": i, "position": j,
                       "greedy": not reqs[i][1].get("temperature"),
                       "single_card_gap": gap,
                       "logits_gap": float((mesh_row.float() - single.float())
                                           .abs().max()),
                       "recorded_at": pos})
    bad = [f for f in firsts if f["single_card_gap"] > 2 * MP_LOGITS_TOL
           or f["logits_gap"] > MP_LOGITS_TOL
           or f["recorded_at"] != f["position"]]
    if bad:
        raise AssertionError(
            f"mesh serving: tokens differ from phase 4's away from a "
            f"near-tie (decision margin > 2 x {MP_LOGITS_TOL}, or logits "
            f"apart by more than {MP_LOGITS_TOL} there): {bad}")
    result = {
        "requests": n_requests, "matched_whole": n_requests - len(diffs),
        "first_differences": firsts,
        "first_logits_gap_max": max(gaps),
        "first_logits_gap_mean": float(np.mean(gaps)),
        "decode_steps": r0["decode_steps"],
        "decode_step_p50_ms": r0["decode_step_p50_ms"],
        "wall_s": r0["wall_s"],
        "tokens_per_s": sum(len(t) for t in r0["tokens"]) / r0["wall_s"],
        "bytes_per_step": {r["rank"]: r["bytes_per_step"] for r in ranks},
        "bytes_per_step_predicted": predicted,
        "launches": {r["rank"]: r["launches"] for r in ranks},
        "local_heads": r0["local_heads"],
        "peak_memory_gb": {r["rank"]: r["peak_memory_gb"] for r in ranks},
        "build_peak_memory_gb": {r["rank"]: r["build_peak_memory_gb"]
                                 for r in ranks},
        "build_s": {r["rank"]: r["build_s"] for r in ranks},
        "followed_calls": r1["followed"], "stats": r0["stats"],
        "serving_counters": r0["serving"]}
    log("mesh serving: " + json.dumps(result, default=str))
    return result


def mesh_small_rank(reqs, payload, swap_state, swap_after, model_kw):
    """Phase 13b on one rank: gpt3-1.3B width at 2 layers in float32 (seed
    0) and a gpt2-small drafter at 2 layers (seed 1), both mp-sharded,
    behind a spec engine (K = 4) and a plain engine on one serving mesh.
    Rank 0 drives, step by step: the spec engine over ``reqs``; the plain
    engine over ``reqs``, then adopting ``payload`` (a single-card
    prefill's export of ``reqs[0]``), then ``reqs`` again with the whole
    ``swap_state`` staged after ``swap_after`` steps. Rank 1 follows."""
    from paddle_tpu_torch.distributed import parallel_env, spmd
    from paddle_tpu_torch.serving import (ContinuousBatchScheduler,
                                          DraftVerifyEngine,
                                          GenerationEngine)

    dev = parallel_env.device()
    kw, dkw = small_models_kw(model_kw)
    model = build_gpt(dev, 0, **kw)
    drafter = build_gpt(dev, 1, **dkw)
    mesh = spmd.serving_mesh(2, model=model)
    ekw = dict(max_batch_size=MESH_BATCH, block_size=16, rng_seed=5,
               device=dev, mesh=mesh)
    spec = DraftVerifyEngine(model, drafter, draft_k=4, **ekw)
    plain = GenerationEngine(model, **ekw)
    if mesh.rank:
        return {"followed": (spec.follow(), plain.follow()),
                "stats": spec.stats()["draft_kernel_sharded"]}
    out = {"draft_kernel_sharded": spec.stats()["draft_kernel_sharded"],
           "draft_pools": [p["spec"] for p in spec.describe_sharding()[
               "kv_pools"] if p.get("draft")]}
    try:
        out["spec"] = run_sync(ContinuousBatchScheduler(spec), reqs)
        out["acceptance"] = spec.acceptance_rate()
        spec.close()
        out["plain"] = run_sync(ContinuousBatchScheduler(plain), reqs)
        handles = adopt_all(ContinuousBatchScheduler(plain), reqs[:1],
                            [payload])
        out["imported"] = list(handles[0].tokens)
        out["swap"] = swap_run(plain, reqs, swap_state, swap_after)
    finally:
        spec.close()
        plain.close()
    return out


def small_models_kw(model_kw=None):
    """Phase 13b's target and drafter configurations (``model_kw`` cuts
    the target in a rehearsal): the drafter covers the target's positions
    and vocabulary."""
    from paddle_tpu_torch.models.gpt import GPTConfig

    kw = dict(preset="gpt3-1.3B", n_layer=2, dtype="float32",
              **(model_kw or {}))
    cfg = GPTConfig.preset(kw["preset"], **{k: v for k, v in kw.items()
                                            if k != "preset"})
    dkw = dict(preset="gpt2-small", n_layer=2, dtype="float32",
               seq_len=cfg.seq_len, vocab_size=cfg.vocab_size)
    return kw, dkw


def swap_run(engine, reqs, state, swap_after):
    """``reqs`` through a fresh scheduler on ``engine``, stepped on this
    thread, with the whole ``state`` staged after ``swap_after`` steps.
    Returns the tokens and the requests that failed."""
    from paddle_tpu_torch.serving import (ContinuousBatchScheduler,
                                          GenerationRequest)

    sched = ContinuousBatchScheduler(engine)
    handles = [sched.submit(GenerationRequest(p, **o)) for p, o in reqs]
    steps = 0
    while sched.has_work():
        if steps == swap_after:
            sched.request_swap(state, source="seed 1")
        sched.step()
        steps += 1
    if sched.swap_count != 1:
        raise AssertionError(f"13b: {sched.swap_count} swaps applied "
                             f"(error {sched.last_swap_error})")
    return {"tokens": [list(h.tokens) for h in handles],
            "failed": [h.rid for h in handles if h.status != "done"]}


def phase_mesh_small(dev, world, n_requests=8, max_new_tokens=16,
                     swap_after=6, model_kw=None):
    """13b: ``mesh_small_rank`` against single-card engines on the card
    (TF32 off, the port's default): plain and spec decode at mp = 2 equal
    a single-card plain engine's tokens; the import continues a
    single-card prefill's export token for token; the swap to the whole
    seed-1 state fails no request and equals a single-card engine swapped
    at the same step."""
    from paddle_tpu_torch.serving import (ContinuousBatchScheduler,
                                          GenerationEngine)

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("13b: TF32 is on; float32 parity needs it off")
    kw, _ = small_models_kw(model_kw)
    reqs = [(p, dict(o, max_new_tokens=max_new_tokens))
            for p, o in serving_requests(kw.get("vocab_size", 50304),
                                         n=n_requests)]
    ekw = dict(max_batch_size=MESH_BATCH, block_size=16, rng_seed=5,
               device=dev)
    single = GenerationEngine(build_gpt(dev, 0, **kw), **ekw)
    want = run_sync(ContinuousBatchScheduler(single), reqs)
    prefill_side = GenerationEngine(build_gpt(dev, 0, **kw), **ekw)
    payloads, _ = export_all(prefill_side, reqs[:1])
    del prefill_side
    state1 = reference_state(build_gpt(dev, 1, **kw))
    swapped = swap_run(GenerationEngine(build_gpt(dev, 0, **kw), **ekw),
                       reqs, state1, swap_after)
    del single
    free_memory()
    r0, r1 = world.run(mesh_small_rank, reqs, payloads[0], state1,
                       swap_after, model_kw)
    checks = {"spec == single plain": r0["spec"] == want,
              "plain == single plain": r0["plain"] == want,
              "import == monolithic": r0["imported"] == want[0],
              "swap == single swapped": r0["swap"]["tokens"]
              == swapped["tokens"],
              "swap failed no request": not r0["swap"]["failed"],
              "drafter sharded": r0["draft_kernel_sharded"] and all(
                  s == [None, None, "mp"] for s in r0["draft_pools"])}
    result = {"checks": checks, "acceptance": r0["acceptance"],
              "followed_calls": r1["followed"], "requests": n_requests,
              "max_new_tokens": max_new_tokens, "swap_after": swap_after}
    log("mesh 13b: " + json.dumps(result, default=str))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(
            f"13b: {failed}; first differences: spec "
            f"{first_difference(r0['spec'], want)}, plain "
            f"{first_difference(r0['plain'], want)}, swap "
            f"{first_difference(r0['swap']['tokens'], swapped['tokens'])}")
    return result


# ------------------------------------------- recurrent, detection (17-18a) --
# phase 17: the "large" PTB model of Zaremba, Sutskever & Vinyals
# (arXiv:1409.2329 section 4): vocabulary 10000, 2 LSTM layers of 1500
# units, dropout 0.65 on the non-recurrent connections, weights uniform in
# [-0.04, 0.04], SGD at rate 1 with the gradients' global norm clipped at
# 10, batch 20 x 35 unrolled steps (each batch from zero states here: the
# paper carries them across batches)
LSTM_LM = dict(vocab=10000, hidden=1500, layers=2, dropout=0.65, batch=20,
               steps=35, init=0.04, lr=1.0, clip=10.0)
# the card's float32 against the CPU's float64 (17: the LM's loss, and its
# gradients relative in norm per parameter; 17a: the GRU's outputs and
# gradients, rnnt_loss's loss and gradient relative to their largest)
CPU64_TOL = dict(loss_rel=1e-5, grad_rel=1e-4, out_abs=1e-4)
# 17a: each functional name on the card against the CPU's float32, relative
# to the CPU result's largest magnitude
FUNCTIONAL_TOL = 1e-5
# 17a: a 3-layer bidirectional GRU 1024 wide over 16 padded sequences of
# 100-400 frames; rnnt_loss at a transducer's size
GRU_CASE = dict(width=1024, layers=3, batch=16, min_len=100, max_len=400)
RNNT_CASE = dict(B=8, T=250, U=50, V=1024)
# 18: YOLOv3-608 on COCO (arXiv:1804.02767): three heads of 3 x (5 + 80)
# channels at strides 32, 16, 8, the paper's nine anchors, and
# PaddleDetection's YOLOv3 post-process (yolo_box at conf 0.005, the top
# 1000 (box, class) pairs above 0.01, NMS at 0.45 per class, 100 kept)
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]
YOLO_HEADS = [(19, [6, 7, 8], 32), (38, [3, 4, 5], 16), (76, [0, 1, 2], 8)]
YOLO = dict(batch=8, classes=80, image=608, conf=0.005, score=0.01,
            pre_nms=1000, nms=0.45, keep=100, gt=50, ignore=0.7)
# 18a: the heads' shapes: Faster R-CNN R50-C4's RPN at an 800 x 1333 image
# (stride 16: a 50 x 84 map, 15 anchors, batch 2) and its 1024-channel
# RoIAlign input; Fast R-CNN's VGG16 conv5 (512 channels, 38 x 63, 128
# RoIs); R-FCN's 81 x 7 x 7 score maps over 300 RoIs; FPN levels over 2000
# RoIs; DCNv2's 3 x 3, 256 -> 256 on [2, 256, 50, 84]; SSD300 decoding a
# batch of 8 over its 8732 priors
DETECT = dict(rpn_map=(50, 84), rpn_batch=2, align_channels=1024,
              conv5=(512, 38, 63), pool_rois=128, rfcn=(81 * 49, 300),
              fpn_rois=2000, dcn=(2, 256, 50, 84), ssd_batch=8)
# 18a: no detection op may allocate more than this above its inputs and
# outputs
DETECTION_MEM_CAP = 4 << 30


def lstm_lm(dev, seed=0):
    """Phase 17's language model on ``dev``: Embedding, dropout, the
    2-layer LSTM (dropout between its layers), dropout, Linear, weights
    uniform in [-init, init] from a generator seeded ``seed``. Every
    dropout hashes one key (``nn.DropoutKeys``) that the training forward
    advances on the card (a counter in a buffer): a replayed graph draws new
    masks with no generator to refill from the host, and the masks are the
    same on any device for the same counter."""
    from paddle_tpu_torch import nn

    cfg = LSTM_LM

    class LM(torch.nn.Module):
        def __init__(self):
            super().__init__()
            V, H = cfg["vocab"], cfg["hidden"]
            self.embed = nn.Embedding(V, H)
            self.drop_in = nn.Dropout(cfg["dropout"])
            self.rnn = nn.LSTM(H, H, num_layers=cfg["layers"],
                               dropout=cfg["dropout"])
            self.drop_out = nn.Dropout(cfg["dropout"])
            self.head = nn.Linear(H, V)
            self.keys = nn.DropoutKeys()
            self.keys.attach(self)
            self.register_buffer("draws", torch.tensor([seed, 0]))

        def forward(self, tokens):
            if self.training:
                self.draws[1:].add_(1)
                self.keys.key = self.draws
            out, _ = self.rnn(self.drop_in(self.embed(tokens)))
            return self.head(self.drop_out(out))

    with torch.device(dev):
        model = LM()
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.uniform_(-cfg["init"], cfg["init"], generator=g)
    return model


def lstm_lm_setup(dev, seed=0, batch=None, steps=None):
    """Phase 17's step: ``lstm_lm``, SGD(lr) with the global-norm clip,
    cross entropy over every position, under ``TrainStep``; and one batch
    of seeded token ids. Returns ``(model, opt, train, x, y)``."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import SGD

    cfg = LSTM_LM
    B, T, V = batch or cfg["batch"], steps or cfg["steps"], cfg["vocab"]
    model = lstm_lm(dev, seed)
    opt = SGD(cfg["lr"], parameters=model.parameters(),
              grad_clip=ClipGradByGlobalNorm(cfg["clip"]))
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, V, (B, T + 1))).to(dev)
    x, y = toks[:, :-1].contiguous(), toks[:, 1:].contiguous()

    def step_fn(xb, yb):
        loss = F.cross_entropy(model(xb).reshape(-1, V), yb.reshape(-1))
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return model, opt, TrainStep(step_fn, model, opt), x, y


def _grads_rel(card, cpu):
    """The largest relative gap in norm, per parameter, between two models'
    gradients, and its parameter."""
    want = {n: p.grad.detach().double() for n, p in cpu.named_parameters()}
    return max((float((p.grad.detach().cpu().double() - want[n]).norm()
                      / want[n].norm().clamp_min(1e-30)), n)
               for n, p in card.named_parameters())


def _cpu_twin(model, build):
    """``build()`` on the CPU in float64, holding ``model``'s state."""
    twin = build().double()
    twin.load_state_dict({k: v.detach().cpu().double()
                          if v.is_floating_point() else v.cpu()
                          for k, v in model.state_dict().items()})
    return twin


def phase_lstm_lm(dev, steps=10):
    """17: the large PTB LSTM LM (see ``LSTM_LM``) through ``TrainStep``'s
    graph, float32, 10 steps: losses finite, one capture, 0 kernels from
    the host a step (torch.profiler); p50 step, tokens/s, device time,
    peak memory; 3 graph steps against an eager twin's; the step's loss
    and gradients at batch 2 x 5 against the port's CPU float64 run; the
    LSTM forward at the step's shape against cuDNN's ``torch.nn.LSTM``
    holding the same weights (a yardstick: max error, both device
    times)."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.profiler import registry

    cfg = LSTM_LM
    B, T, V = cfg["batch"], cfg["steps"], cfg["vocab"]
    t0 = time.perf_counter()
    model, opt, train, x, y = lstm_lm_setup(dev)
    build_s = time.perf_counter() - t0
    registry.reset("jit")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses = [float(train(x, y)) for _ in range(2)]
    step_s = []
    for _ in range(steps - 2):
        t1 = time.perf_counter()
        losses.append(float(train(x, y)))
        step_s.append(time.perf_counter() - t1)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    jit = dict(registry.counters("jit"))
    prof = profile_steps(lambda: train(x, y), 2)
    p50 = sorted(step_s)[math.ceil(len(step_s) / 2) - 1]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"lstm lm: losses {losses}")
    if jit["train_step_captures"] != 1 or jit["train_step_eager"] != 1:
        raise AssertionError(f"lstm lm: TrainStep {jit}")
    if prof["kernel_launches"] != 0 or prof["graph_launches"] != 2:
        raise AssertionError(
            f"lstm lm: {prof['kernel_launches']} kernels launched from the "
            f"host and {prof['graph_launches']} graph launches over 2 steps")
    result = {"batch": B, "steps": T, "build_s": build_s,
              "params": sum(p.numel() for p in model.parameters()),
              "losses": losses, "step_p50_ms": p50 * 1e3,
              "step_ms": [round(t * 1e3, 3) for t in step_s],
              "tokens_per_s": B * T / p50, "peak_memory_gb": peak_gb,
              "train_step": jit,
              "host_kernel_launches_per_step": prof["kernel_launches"] / 2,
              "graph_launches_per_step": prof["graph_launches"] / 2,
              "kernels_per_step": prof["kernels"] / 2,
              "device_ms_per_step": prof["device_ms"] / 2}
    marks = {"train": time.perf_counter() - t0}
    # the yardstick: the LSTM's forward at the step's shape, eval mode
    import torch.nn as tnn

    rnn = model.rnn.eval()
    cudnn = tnn.LSTM(cfg["hidden"], cfg["hidden"], cfg["layers"],
                     batch_first=True).to(dev)
    cudnn.load_state_dict(rnn.state_dict())
    h = torch.randn(B, T, cfg["hidden"], device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    with torch.no_grad():
        err = float((rnn(h)[0] - cudnn(h)[0]).abs().max())
        port_ms = device_ms(lambda: rnn(h), calls=2)
        cudnn_ms = device_ms(lambda: cudnn(h), calls=2)
    result["yardstick"] = {"max_abs_err": err, "port_device_ms": port_ms,
                           "cudnn_device_ms": cudnn_ms,
                           "cudnn_tf32": torch.backends.cudnn.allow_tf32}
    del train, opt, model, rnn, cudnn
    free_memory()
    marks["yardstick"] = time.perf_counter() - t0
    # graph against an eager twin: the same weights, batch and key counter
    _, _, graph, xg, yg = lstm_lm_setup(dev, seed=1)
    _, _, eager, _, _ = lstm_lm_setup(dev, seed=1)
    g_losses = [float(graph(xg, yg)) for _ in range(3)]
    e_losses = [float(eager.step_fn(xg, yg)) for _ in range(3)]
    gap = max(float((a - b).abs().max()) for a, b in zip(
        graph._models[0].parameters(), eager._models[0].parameters()))
    loss_gap = max(abs(a - b) for a, b in zip(g_losses, e_losses))
    if gap > 1e-5 or loss_gap > 1e-5 * max(map(abs, e_losses)):
        raise AssertionError(f"lstm lm: graph {g_losses} against eager "
                             f"{e_losses}, parameter gap {gap}")
    result["graph_vs_eager"] = {"losses": g_losses, "eager": e_losses,
                                "parameter_gap": gap,
                                "bitwise": gap == 0 and loss_gap == 0}
    del graph, eager
    free_memory()
    marks["graph_vs_eager"] = time.perf_counter() - t0
    # the card's float32 step at batch 2 x 5 against the CPU's float64
    card = lstm_lm(dev, seed=2)
    cpu = _cpu_twin(card, lambda: lstm_lm("cpu", seed=2))
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, V, (2, 6)))
    losses64 = []
    for m, d in ((card, dev), (cpu, "cpu")):
        t = toks.to(d)
        loss = F.cross_entropy(m(t[:, :-1]).reshape(-1, V),
                               t[:, 1:].reshape(-1))
        loss.backward()
        losses64.append(float(loss))
    loss_rel = abs(losses64[0] - losses64[1]) / abs(losses64[1])
    grad_rel, worst = _grads_rel(card, cpu)
    if loss_rel > CPU64_TOL["loss_rel"] or grad_rel > CPU64_TOL["grad_rel"]:
        raise AssertionError(f"lstm lm: card against CPU float64: loss "
                             f"{losses64}, gradients {grad_rel} ({worst})")
    result["card_vs_cpu_float64"] = {"losses": losses64,
                                     "loss_rel": loss_rel,
                                     "grad_rel_max": grad_rel,
                                     "grad_rel_worst": worst,
                                     "tol": CPU64_TOL}
    del card, cpu
    free_memory()
    marks["cpu_float64"] = time.perf_counter() - t0
    result["seconds_at"] = marks
    log("lstm lm: " + json.dumps(result))
    return result


def _nbytes(out):
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (tuple, list)):
        return sum(_nbytes(o) for o in out)
    return 0


def memory_above(fn):
    """``fn()`` once from a clean peak: ``(result, peak bytes allocated
    above what was live before, the result's own bytes)``."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base, _nbytes(out)


def _gap(got, want):
    """Largest absolute gap, and the largest relative to ``want``'s
    largest magnitude."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    return err, err / max(float(want.abs().max()) if want.numel() else 0.0,
                          1e-30)


def functional_cases(g):
    """17a's functional names, each at the shape of a named model's layer
    (float32 inputs from the CPU generator ``g``): ``{name: (fn, args,
    kwargs, the layer)}``."""
    from paddle_tpu_torch.nn import functional as F

    def r(*shape):
        return torch.randn(*shape, generator=g)

    lens = torch.from_numpy(np.random.default_rng(17).integers(
        GRU_CASE["min_len"], GRU_CASE["max_len"] + 1, GRU_CASE["batch"]))
    theta = r(32, 2, 3) * 0.1 + torch.tensor([[1.0, 0, 0], [0, 1.0, 0]])
    # the pooled maps and their indices that the unpools scatter back
    segnet = F.max_pool2d_with_index(r(2, 64, 360, 480), 2, 2)
    c3d = F.max_pool3d_with_index(r(2, 128, 16, 56, 56), 2, 2)
    bert = F.max_pool2d_with_index(r(16, 768, 1, 128), (1, 2), (1, 2))
    arc = torch.randint(0, 85742, (128,), generator=g)
    ptb = torch.randint(0, 10000, (700,), generator=g)
    return {
        "linear": (F.linear, (r(16, 128, 768), r(768, 3072) * 0.03,
                              r(3072)), {},
                   "bert-base's FFN up-projection, 16 x 128 x 768 -> 3072"),
        "embedding": (F.embedding, (torch.randint(0, 30522, (16, 128),
                                                  generator=g),
                                    r(30522, 768)), dict(padding_idx=0),
                      "bert-base's word embeddings, 30522 x 768, 16 x 128"),
        "sequence_mask": (F.sequence_mask, (lens,), {},
                          "phase 17a's GRU lengths, 16 of 100-400"),
        "grid_sample": (F.grid_sample, (r(32, 3, 224, 224),
                                        F.affine_grid(theta,
                                                      [32, 3, 224, 224])),
                        dict(mode="bilinear", padding_mode="border"),
                        "a spatial transformer's sampler (arXiv:1506.02025)"
                        " on ResNet-50's 32 x 3 x 224^2 input"),
        "affine_grid": (F.affine_grid, (theta, [32, 3, 224, 224]), {},
                        "the same transformer's grid, 32 x 224^2"),
        "temporal_shift": (F.temporal_shift, (r(16, 256, 56, 56), 8),
                           dict(shift_ratio=0.125),
                           "TSM ResNet-50's res2 input (arXiv:1811.08383), "
                           "2 clips x 8 segments x 256 x 56^2"),
        "max_pool2d_with_index": (F.max_pool2d_with_index,
                                  (r(8, 64, 112, 112), 3, 2, 1), {},
                                  "ResNet-50's stem pool, 8 x 64 x 112^2"),
        "max_pool3d_with_index": (F.max_pool3d_with_index,
                                  (r(2, 128, 16, 56, 56), 2, 2), {},
                                  "C3D's pool2 (arXiv:1412.0767), 2 x 128 x "
                                  "16 x 56^2"),
        "max_unpool1d": (F.max_unpool1d, (bert[0][:, :, 0],
                                          bert[1][:, :, 0], 2), {},
                         "bert-base's 16 x 768 x 128 hidden states, "
                         "pooled by 2"),
        "max_unpool2d": (F.max_unpool2d, (*segnet, 2, 2), {},
                         "SegNet's first decoder (arXiv:1511.00561), 2 x 64 "
                         "x 180 x 240 -> 360 x 480"),
        "max_unpool3d": (F.max_unpool3d, (*c3d, 2, 2), {},
                         "C3D's pool2 undone, 2 x 128 x 8 x 28^2"),
        "margin_cross_entropy": (F.margin_cross_entropy,
                                 (torch.tanh(r(128, 85742)), arc),
                                 dict(return_softmax=True),
                                 "ArcFace on MS1MV2 (arXiv:1801.07698), "
                                 "128 x 85742 classes"),
        "hsigmoid_loss": (F.hsigmoid_loss,
                          (r(700, 1500), ptb, 10000, r(9999, 1500) * 0.03,
                           r(9999, 1)), {},
                          "phase 17's LM outputs (700 x 1500) over a "
                          "10000-word tree"),
        "class_center_sample": (F.class_center_sample, (arc, 85742, 8574),
                                {}, "PartialFC (arXiv:2010.05222) on "
                                "MS1MV2, 10% of 85742 classes, 128 labels"),
        "rnnt_loss": (F.rnnt_loss, (r(2, 40, RNNT_CASE["U"] + 1,
                                      RNNT_CASE["V"]),
                                    torch.randint(1, RNNT_CASE["V"],
                                                  (2, RNNT_CASE["U"]),
                                                  generator=g),
                                    torch.tensor([40, 31]),
                                    torch.tensor([RNNT_CASE["U"], 37])),
                      dict(reduction="none"),
                      "phase 17a's transducer at B 2, T 40, U 50, V 1024"),
    }


def functional_on_card(dev):
    """Each of 17a's functional names (``functional_cases``) on the card
    against its CPU result on the same float32 inputs: ``{name: {"gap":
    largest gap relative to the CPU result's largest magnitude, "layer":
    ...}}`` (0 for indices, masks and sampled classes, which must be
    equal)."""
    gaps = {}
    for name, (fn, args, kw, layer) in functional_cases(
            torch.Generator().manual_seed(17)).items():
        cpu = fn(*args, **kw)
        card = fn(*[a.to(dev) if torch.is_tensor(a) else a for a in args],
                  **kw)
        cpu = cpu if isinstance(cpu, tuple) else (cpu,)
        card = card if isinstance(card, tuple) else (card,)
        worst = 0.0
        for c, w in zip(card, cpu):
            if w.is_floating_point():
                worst = max(worst, _gap(c, w)[1])
            elif not torch.equal(c.cpu(), w):
                raise AssertionError(f"17a {name}: the card's indices "
                                     "differ from the CPU's")
        if worst > FUNCTIONAL_TOL:
            raise AssertionError(f"17a {name}: card against CPU {worst} of "
                                 "the largest")
        gaps[name] = {"gap": worst, "layer": layer}
        del cpu, card
    free_memory()
    return gaps


def phase_rnn_rnnt_functional(dev, calls=3):
    """17a: the 3-layer bidirectional GRU over padded sequences with
    ``sequence_length`` (zeros past each length; against CPU float64 at
    its 2 shortest sequences), ``rnnt_loss`` at a transducer's size (timed; against CPU
    float64 at B 2, T 40), every functional name of the slice on the card
    against the CPU, and the two attention entries: each call of
    ``F.scaled_dot_product_attention`` at bert-base's float32 16 x 128 x
    12 x 64 launches K1 once and ``F.paged_attention(kernel="pallas")`` at
    phase 3's decode case K4 once (the card's counts), each bitwise equal to
    ``ops.flash_attention`` / ``ops.paged_attention``."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.layer.layers import init_parameters
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    t0 = time.perf_counter()
    c = GRU_CASE
    W = c["width"]
    rng = np.random.default_rng(17)
    lens = rng.integers(c["min_len"], c["max_len"] + 1, c["batch"])
    T = int(lens.max())

    def gru_on(d):
        with torch.device(d):
            m = nn.GRU(W, W, num_layers=c["layers"], direction="bidirect")
        return init_parameters(m, torch.Generator(device=d).manual_seed(4))

    gru = gru_on(dev)
    x = torch.from_numpy(rng.standard_normal((c["batch"], T, W)).astype(
        np.float32)).to(dev)
    seq = torch.from_numpy(lens).to(dev)

    def fwd_bwd():
        xi = x.detach().requires_grad_()
        out, _ = gru(xi, sequence_length=seq)
        out.square().sum().backward()
        gru.zero_grad(set_to_none=True)
        return out.detach()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = fwd_bwd()
    torch.cuda.synchronize()
    gru_ms = (time.perf_counter() - t0) * 1e3
    gru_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    past = torch.arange(T, device=dev)[None, :] >= seq[:, None]
    if out[past].abs().max() != 0:
        raise AssertionError("17a gru: outputs past a length are not zero")
    # the 2 shortest sequences against the CPU's float64
    two = np.argsort(lens, kind="stable")[:2].tolist()
    T2 = int(lens[two].max())
    cpu = _cpu_twin(gru, lambda: gru_on("cpu"))
    outs = []
    for m, d in ((gru, dev), (cpu, "cpu")):
        xi = x[two, :T2].detach().to(d)
        xi = (xi.double() if d == "cpu" else xi).requires_grad_()
        o, h = m(xi, sequence_length=seq[two].to(d))
        (o.square().sum() + h.sum()).backward()
        outs.append((o.detach(), xi.grad))
    out_gap = _gap(outs[0][0], outs[1][0])[0]
    x_rel = float((outs[0][1].cpu().double() - outs[1][1]).norm()
                  / outs[1][1].norm())
    w_rel, worst = _grads_rel(gru, cpu)
    if out_gap > CPU64_TOL["out_abs"] or max(x_rel, w_rel) > \
            CPU64_TOL["grad_rel"]:
        raise AssertionError(f"17a gru: card against CPU float64: outputs "
                             f"{out_gap}, input gradient {x_rel}, weights "
                             f"{w_rel} ({worst})")
    marks = {"gru": time.perf_counter() - t0}
    result = {"gru": {"batch": c["batch"], "lengths": lens.tolist(),
                      "fwd_bwd_ms": gru_ms, "peak_memory_gb": gru_peak,
                      "zeros_past_lengths": True,
                      "vs_cpu_float64": {"out_abs": out_gap,
                                         "x_grad_rel": x_rel,
                                         "weight_grad_rel": w_rel,
                                         "worst": worst}}}
    del gru, cpu, x, outs
    free_memory()
    # rnnt_loss at B 8, T 250, U 50, V 1024, then B 2, T 40 against float64
    r = RNNT_CASE
    g = torch.Generator().manual_seed(18)

    def rnnt_inputs(B, T, U, V):
        logits = torch.randn(B, T, U + 1, V, generator=g)
        labels = torch.randint(1, V, (B, U), generator=g)
        il = torch.randint(T // 2, T + 1, (B,), generator=g)
        ll = torch.randint(U // 2, U + 1, (B,), generator=g)
        il[0], ll[0] = T, U
        return logits, labels, il, ll

    big = [a.to(dev) for a in rnnt_inputs(r["B"], r["T"], r["U"], r["V"])]

    def rnnt_step():
        xi = big[0].detach().requires_grad_()
        loss = F.rnnt_loss(xi, *big[1:])
        loss.backward()
        return loss.detach()

    loss, rnnt_peak, _ = memory_above(rnnt_step)
    rnnt_ms, rnnt_device_ms = host_and_device_ms(rnnt_step, n=3)
    if not torch.isfinite(loss):
        raise AssertionError(f"17a rnnt_loss: {loss}")
    small = rnnt_inputs(2, 40, r["U"], r["V"])
    got = []
    for d, dt in ((dev, torch.float32), ("cpu", torch.float64)):
        xi = small[0].to(d, dt).clone().requires_grad_()
        loss_s = F.rnnt_loss(xi, *[a.to(d) for a in small[1:]],
                             reduction="sum")
        loss_s.backward()
        got.append((loss_s.detach(), xi.grad))
    rnnt_rel = _gap(got[0][0], got[1][0])[1]
    rnnt_grad = _gap(got[0][1], got[1][1])[1]
    if rnnt_rel > CPU64_TOL["loss_rel"] or rnnt_grad > CPU64_TOL["grad_rel"]:
        raise AssertionError(f"17a rnnt_loss: card against CPU float64: "
                             f"loss {rnnt_rel}, gradient {rnnt_grad}")
    result["rnnt"] = {**r, "fwd_bwd_ms": rnnt_ms,
                      "fwd_bwd_device_ms": rnnt_device_ms,
                      "loss": float(loss),
                      "peak_above_inputs_gb": rnnt_peak / 1e9,
                      "vs_cpu_float64": {"B": 2, "T": 40,
                                         "loss_rel": rnnt_rel,
                                         "grad_rel_to_max": rnnt_grad}}
    del big
    free_memory()
    marks["rnnt"] = time.perf_counter() - t0
    result["functional_vs_cpu"] = functional_on_card(dev)
    marks["functional"] = time.perf_counter() - t0
    # the two attention entries: their kernels launched, bitwise equal
    q, k, v = (torch.randn(*NONCAUSAL_SHAPES[torch.float32], device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(s)) for s in (1, 2, 3))
    fa.reset_device_launches()
    sdpa = [F.scaled_dot_product_attention(q, k, v) for _ in range(calls)]
    k1 = fa.device_launches()["flash_fwd"]
    want = fa.flash_attention(q, k, v)
    plain = F.scaled_dot_product_attention(q.cpu(), k.cpu(), v.cpu())
    atol, rtol = fa.FLASH_PARITY_TOL[torch.float32]
    sdpa_gap = _gap(sdpa[0], plain)[0]
    if k1 != calls or not all(torch.equal(o, want) for o in sdpa) or \
            sdpa_gap > atol + rtol * float(plain.abs().max()):
        raise AssertionError(f"17a sdpa: K1 {k1} launches for {calls} "
                             f"calls, against the plain route {sdpa_gap}")
    args = paged_case(dev, torch.bfloat16, 1, PAGED_TIMED[
        "paged_attention"][2], seed=PAGED_TIMED["paged_attention"][3])
    pa.reset_device_launches()
    paged = [F.paged_attention(*args, kernel="pallas")
             for _ in range(calls)]
    k4 = sum(pa.device_launches().values())
    want = pa.paged_attention(*args)
    if k4 != calls or not all(torch.equal(o, want) for o in paged):
        raise AssertionError(f"17a paged_attention: K4 {k4} launches for "
                             f"{calls} calls or outputs unequal")
    result["attention"] = {"sdpa_k1_launches": k1, "sdpa_calls": calls,
                           "sdpa_vs_plain": sdpa_gap,
                           "paged_k4_launches": k4, "paged_calls": calls,
                           "bitwise_equal_to_ops": True}
    marks["attention"] = time.perf_counter() - t0
    result["seconds_at"] = marks
    log("rnn, rnnt, functional: " + json.dumps(result))
    return result


def yolo_heads(dev, seed=0):
    """Phase 18's seeded head values ``[8, 255, s, s]`` per stride."""
    g = torch.Generator(device=dev).manual_seed(seed)
    C = 3 * (5 + YOLO["classes"])
    return [torch.randn(YOLO["batch"], C, s, s, device=dev, generator=g)
            for s, _, _ in YOLO_HEADS]


def yolo_postprocess(heads, img):
    """yolo_box per head at conf 0.005, the top 1000 (box, class) pairs
    above 0.01 per image, category-aware NMS at 0.45, 100 kept: per
    image, ``(kept pair indices, boxes, scores, classes)`` of the pairs."""
    from paddle_tpu_torch.vision import ops

    boxes, scores = [], []
    for x, (_, mask, down) in zip(heads, YOLO_HEADS):
        anchors = [a for m in mask for a in YOLO_ANCHORS[2 * m:2 * m + 2]]
        b, s = ops.yolo_box(x, img, anchors, YOLO["classes"], YOLO["conf"],
                            downsample_ratio=down)
        boxes.append(b)
        scores.append(s)
    boxes, scores = torch.cat(boxes, 1), torch.cat(scores, 1)
    C = YOLO["classes"]
    flat = scores.flatten(1)
    top, idx = flat.topk(YOLO["pre_nms"], dim=1)
    top = torch.where(top > YOLO["score"], top,
                      torch.full_like(top, float("-inf")))
    out = []
    for n in range(boxes.shape[0]):
        b, c = boxes[n][idx[n] // C], idx[n] % C
        keep = ops.nms(b, YOLO["nms"], top[n], c, top_k=YOLO["keep"])
        out.append((keep, b, top[n], c))
    return out


def yolo_targets(dev, seed=0):
    """50 seeded ground-truth boxes per image (cx, cy, w, h in pixels of
    the 608 image) and their classes."""
    g = torch.Generator().manual_seed(seed)
    B, G, S = YOLO["batch"], YOLO["gt"], YOLO["image"]
    wh = torch.rand(B, G, 2, generator=g) * 0.5 * S + 8
    cxy = torch.rand(B, G, 2, generator=g) * (S - wh) + wh / 2
    lab = torch.randint(0, YOLO["classes"], (B, G), generator=g)
    return torch.cat([cxy, wh], -1).to(dev), lab.to(dev)


def phase_yolov3(dev):
    """18: YOLOv3-608's three heads (``YOLO_HEADS``) at batch 8: the
    post-process (``yolo_postprocess``) timed with its peak memory, each
    image's NMS picks on the card bitwise equal to the port's CPU NMS on
    the card's own boxes; ``yolo_loss`` over the three heads with 50
    ground-truth boxes an image, forward and backward, timed with its
    peak memory, its loss and each head's input gradient against the
    CPU's float64."""
    from paddle_tpu_torch.vision import ops

    heads = yolo_heads(dev)
    img = torch.full((YOLO["batch"], 2), YOLO["image"], device=dev)
    res, peak, _ = memory_above(lambda: yolo_postprocess(heads, img))
    post_ms, post_device_ms = host_and_device_ms(
        lambda: yolo_postprocess(heads, img), n=3)
    kept = []
    for n, (keep, b, s, c) in enumerate(res):
        cpu = ops.nms(b.cpu(), YOLO["nms"], s.cpu(), c.cpu(),
                      top_k=YOLO["keep"])
        if not torch.equal(keep.cpu(), cpu):
            raise AssertionError(f"18 nms: image {n}: the card's picks "
                                 "differ from the CPU's")
        kept.append(int(keep.numel()))
    gt, lab = yolo_targets(dev)

    def loss_of(hs, g_, l_):
        total = 0
        for x, (_, mask, down) in zip(hs, YOLO_HEADS):
            total = total + ops.yolo_loss(
                x, g_, l_, YOLO_ANCHORS, mask, YOLO["classes"],
                YOLO["ignore"], down).sum()
        return total

    def fwd_bwd(hs, g_, l_):
        hs = [h.detach().requires_grad_() for h in hs]
        loss = loss_of(hs, g_, l_)
        loss.backward()
        return loss.detach(), [h.grad for h in hs]

    (loss, grads), loss_peak, _ = memory_above(
        lambda: fwd_bwd(heads, gt, lab))
    loss_ms, loss_device_ms = host_and_device_ms(
        lambda: fwd_bwd(heads, gt, lab), n=3)
    want, want_grads = fwd_bwd([h.cpu().double() for h in heads],
                               gt.cpu().double(), lab.cpu())
    loss_rel = _gap(loss, want)[1]
    # each head's input gradient, relative to its largest entry
    grad_rel = [_gap(c, w)[1] for c, w in zip(grads, want_grads)]
    if not torch.isfinite(loss) or loss_rel > CPU64_TOL["loss_rel"] or \
            max(grad_rel) > CPU64_TOL["grad_rel"]:
        raise AssertionError(f"18 yolo_loss {float(loss)} against the CPU's "
                             f"float64 {float(want)}; input gradients "
                             f"{grad_rel}")
    result = {"batch": YOLO["batch"], "postprocess_ms": post_ms,
              "postprocess_device_ms": post_device_ms,
              "postprocess_peak_above_inputs_gb": peak / 1e9,
              "kept_per_image": kept, "nms_equal_cpu": True,
              "loss_fwd_bwd_ms": loss_ms,
              "loss_fwd_bwd_device_ms": loss_device_ms,
              "loss_peak_above_inputs_gb": loss_peak / 1e9,
              "loss": float(loss),
              "loss_vs_cpu_float64_rel": loss_rel,
              "input_grad_vs_cpu_float64_rel": grad_rel}
    del heads, grads, want_grads
    free_memory()
    log("yolov3: " + json.dumps(result))
    return result


def rpn_inputs(dev, seed=0):
    """Faster R-CNN R50-C4's RPN at an 800 x 1333 image: a 50 x 84 map at
    stride 16, 15 anchors (sizes 32-512, ratios 0.5 / 1 / 2), seeded
    scores and deltas, unit variances."""
    (H, W), stride, batch = DETECT["rpn_map"], 16, DETECT["rpn_batch"]
    sizes, ratios = (32, 64, 128, 256, 512), (0.5, 1.0, 2.0)
    base = []
    for s in sizes:
        for r in ratios:
            w, h = s / math.sqrt(r), s * math.sqrt(r)
            base.append([-w / 2, -h / 2, w / 2, h / 2])
    base = torch.tensor(base)                                    # [15, 4]
    ys, xs = torch.meshgrid(torch.arange(H) * stride + stride / 2,
                            torch.arange(W) * stride + stride / 2,
                            indexing="ij")
    shift = torch.stack([xs, ys, xs, ys], -1)[:, :, None]       # [H, W, 1, 4]
    anchors = (shift + base).float()
    g = torch.Generator().manual_seed(seed)
    A = len(base)
    scores = torch.randn(batch, A, H, W, generator=g)
    deltas = torch.randn(batch, 4 * A, H, W, generator=g) * 0.2
    img = torch.tensor([[H * 16.0, W * 16.0 - 11]] * batch)
    return [t.to(dev) for t in (scores, deltas, img, anchors,
                                torch.ones_like(anchors))]


def ssd300_priors(dev):
    """SSD300's six maps (arXiv:1512.02325): 8732 prior boxes and their
    variances, ``[8732, 4]`` each."""
    from paddle_tpu_torch.vision import ops

    maps = [38, 19, 10, 5, 3, 1]
    mins = [30, 60, 111, 162, 213, 264]
    maxs = [60, 111, 162, 213, 264, 315]
    ars = [[2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0], [2.0]]
    steps = [8, 16, 32, 64, 100, 300]
    image = torch.empty(1, 3, 300, 300, device=dev)
    boxes, var = [], []
    for m, lo, hi, ar, st in zip(maps, mins, maxs, ars, steps):
        fm = torch.empty(1, 1, m, m, device=dev)
        b, v = ops.prior_box(fm, image, [lo], [hi], ar, flip=True,
                             clip=True, steps=(st, st))
        boxes.append(b.reshape(-1, 4))
        var.append(v.reshape(-1, 4))
    return torch.cat(boxes), torch.cat(var)


def phase_detection_heads(dev):
    """18a: each op timed (host clock and CUDA events, median of 3 after its
    first call), its peak memory above its inputs
    held within ``DETECTION_MEM_CAP`` beyond its outputs, and its result
    against the port's CPU run of the same inputs (float64 for the smooth
    ops; exactly for indices and counts): the R50-C4 RPN's
    generate_proposals, roi_align over its RoIs on a 1024-channel map;
    roi_pool at Fast R-CNN's VGG16 conv5; psroi_pool at R-FCN's 3969
    channels; distribute_fpn_proposals on 2000 RoIs; DCNv2's deformable
    convolution forward and backward; SSD300's prior_box and box_coder."""
    from paddle_tpu_torch.vision import ops

    result = {}

    def run(name, fn, check):
        out, peak, out_bytes = memory_above(fn)
        ms, device = host_and_device_ms(fn, n=3)
        above = peak - out_bytes
        if above > DETECTION_MEM_CAP:
            raise AssertionError(f"18a {name}: {above / 2**30:.2f} GiB above "
                                 "its inputs and outputs")
        gaps = check(out)
        result[name] = {"ms": ms, "device_ms": device,
                        "peak_above_inputs_gb": peak / 1e9,
                        "outputs_gb": out_bytes / 1e9,
                        "above_inputs_and_outputs_gb": above / 1e9,
                        **gaps}
        log(f"18a {name}: {json.dumps(result[name])}")
        return out

    def close64(got, want, tol=1e-5, what=""):
        err, rel = _gap(got, want)
        if rel > tol:
            raise AssertionError(f"18a {what}: card against CPU float64 "
                                 f"{err} ({rel} of the largest)")
        return rel

    # the RPN: proposals, then RoIAlign over them on a 1024-channel map
    rpn = rpn_inputs(dev)
    kw = dict(pre_nms_top_n=6000, post_nms_top_n=1000, nms_thresh=0.7,
              min_size=0.0)

    def proposals_check(out):
        cpu = ops.generate_proposals(*[a.cpu() for a in rpn], **kw)
        if not torch.equal(out[2].cpu(), cpu[2]):
            raise AssertionError(f"18a generate_proposals: counts "
                                 f"{out[2].tolist()} against {cpu[2]}")
        return {"rois_per_image": out[2].tolist(),
                "rois_vs_cpu": _gap(out[0], cpu[0])[0]}

    rois, _, num = run("generate_proposals",
                       lambda: ops.generate_proposals(*rpn, **kw),
                       proposals_check)
    feat = torch.randn(DETECT["rpn_batch"], DETECT["align_channels"],
                       *DETECT["rpn_map"], device=dev,
                       generator=torch.Generator(device=dev).manual_seed(1))
    akw = dict(output_size=14, spatial_scale=1 / 16, sampling_ratio=0,
               aligned=True)

    def align_check(out):
        # the first 32 RoIs of each image in float64 on the CPU
        n0, n1 = (min(32, int(n)) for n in num)
        pick = torch.cat([torch.arange(n0), int(num[0]) + torch.arange(n1)])
        want = ops.roi_align(feat.cpu().double(), rois[pick].cpu().double(),
                             torch.tensor([n0, n1]), **akw)
        return {"vs_cpu_float64_rel": close64(out[pick.to(dev)], want,
                                              what="roi_align"),
                "rois": int(rois.shape[0])}

    run("roi_align", lambda: ops.roi_align(feat, rois, num, **akw),
        align_check)
    del feat
    free_memory()
    g = torch.Generator().manual_seed(2)

    def boxes(n, w, h, lo=16.0):
        xy = torch.rand(n, 2, generator=g) * torch.tensor([w, h]) * 0.8
        wh = lo + torch.rand(n, 2, generator=g) * torch.tensor([w, h]) * 0.5
        return torch.cat([xy, xy + wh], 1)

    # Fast R-CNN's RoIPool on VGG16's conv5 (600 x 1000 image, stride 16)
    C5, H5, W5 = DETECT["conv5"]
    n_pool = DETECT["pool_rois"]
    conv5 = torch.randn(1, C5, H5, W5, generator=g)
    r_pool = boxes(n_pool, W5 * 16, H5 * 16)
    args = [conv5.to(dev), r_pool.to(dev),
            torch.tensor([n_pool], device=dev)]
    # maxima over bins whose edges come from rounded corners: the CPU's
    # float32 run takes the same edges, and the same elements
    def pool_check(out):
        if not torch.equal(out.cpu(), ops.roi_pool(
                *[a.cpu() for a in args], 7, 1 / 16)):
            raise AssertionError("18a roi_pool: the card's maxima differ "
                                 "from the CPU's")
        return {"equal_cpu_float32": True}

    run("roi_pool", lambda: ops.roi_pool(*args, 7, 1 / 16), pool_check)
    # R-FCN's position-sensitive pool: 81 classes x 7 x 7 channels
    C_ps, n_ps = DETECT["rfcn"]
    score_map = torch.randn(1, C_ps, H5, W5, generator=g)
    r_ps = boxes(n_ps, W5 * 16, H5 * 16)
    args = [score_map.to(dev), r_ps.to(dev),
            torch.tensor([n_ps], device=dev)]
    m = min(64, n_ps)  # the first 64 RoIs in float64 on the CPU
    run("psroi_pool", lambda: ops.psroi_pool(*args, 7, 1 / 16),
        lambda out: {"vs_cpu_float64_rel": close64(
            out[:m], ops.psroi_pool(args[0].cpu().double(),
                                    r_ps[:m].double(), torch.tensor([m]),
                                    7, 1 / 16),
            what="psroi_pool")})
    # FPN levels 2-5 over 2000 RoIs of an 800 x 1333 image
    r_fpn = boxes(DETECT["fpn_rois"], 1333, 800, lo=4.0).to(dev)

    def fpn_check(out):
        cpu = ops.distribute_fpn_proposals(r_fpn.cpu(), 2, 5, 4, 224)
        if not torch.equal(out[1].cpu(), cpu[1]) or any(
                not torch.equal(a.cpu(), b) for a, b in zip(out[2], cpu[2])):
            raise AssertionError("18a distribute_fpn_proposals: restore "
                                 "index or counts differ from the CPU's")
        return {"per_level": [int(n) for n in out[2]]}

    run("distribute_fpn_proposals",
        lambda: ops.distribute_fpn_proposals(r_fpn, 2, 5, 4, 224), fpn_check)
    # DCNv2: 3 x 3, 256 -> 256, with a mask, forward and backward
    # offsets on a 1/64 grid: a tap's position is then exact in float32
    # and float64 alike, so both take the same bilinear corners (the
    # offsets' gradient jumps where a position crosses a pixel)
    N, C, H, W = DETECT["dcn"]
    dcn = [torch.randn(N, C, H, W, generator=g),
           (torch.randn(N, 18, H, W, generator=g) * 128).round() / 64,
           torch.randn(C, C, 3, 3, generator=g) * 0.02,
           torch.randn(C, generator=g),
           torch.rand(N, 9, H, W, generator=g)]

    def dcn_step(ins):
        ins = [t.detach().requires_grad_() for t in ins]
        out = ops.deform_conv2d(ins[0], ins[1], ins[2], ins[3], padding=1,
                                mask=ins[4])
        out.square().sum().backward()
        return (out.detach(), *[t.grad for t in ins])

    card_in = [t.to(dev) for t in dcn]

    def dcn_check(out):
        want = dcn_step([t.double() for t in dcn])
        rels = [close64(o, w, 1e-5, f"deform_conv2d {i}")
                for i, (o, w) in enumerate(zip(out, want))]
        return {"vs_cpu_float64_rel": max(rels)}

    run("deform_conv2d", lambda: dcn_step(card_in), dcn_check)
    del card_in
    free_memory()
    # SSD300: 8732 priors, decoded for a batch of 8
    deltas = (torch.randn(DETECT["ssd_batch"], 8732, 4, generator=g)
              * 0.5).to(dev)

    def ssd():
        pb, pv = ssd300_priors(dev)
        return ops.box_coder(pb, pv, deltas, "decode_center_size"), pb

    def ssd_check(out):
        if out[1].shape[0] != 8732:
            raise AssertionError(f"18a ssd300: {out[1].shape[0]} priors")
        pb, pv = ssd300_priors("cpu")
        want = ops.box_coder(pb.double(), pv.double(),
                             deltas.cpu().double(), "decode_center_size")
        return {"priors": 8732, "vs_cpu_float64_rel": close64(
            out[0], want, what="prior_box + box_coder")}

    run("prior_box + box_coder", ssd, ssd_check)
    log("detection heads: " + json.dumps(result))
    return result


def nccl_world_1():
    """12c: ``init_parallel_env()`` in a child process at world 1."""
    t1 = time.perf_counter()
    env = dict(os.environ, PADDLE_TRAINERS_NUM="1", PADDLE_TRAINER_ID="0",
               PADDLE_MASTER=f"127.0.0.1:{free_port()}",
               PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", NCCL_WORLD_1], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"12c: init_parallel_env at world 1 failed:\n"
                             f"{out.stderr[-2000:]}")
    backend, total, device = out.stdout.split()[-3:]
    if backend != "nccl" or float(total) != 8.0:
        raise AssertionError(f"12c: {out.stdout!r}")
    return {"backend": backend, "device": device,
            "seconds": time.perf_counter() - t1}


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ptxas_instances(lib_path):
    """Every kernel instance in the library's ``-Xptxas -v`` log:
    ``[{"kernel", "args", "registers", "spill_stores", "lines"}]``, with
    ``args`` its template arguments (``["bf16", "64", "1"]``) and ``lines``
    its register, spill and shared-memory lines."""
    out = []
    for line in Path(f"{lib_path}.log").read_text().splitlines():
        m = _ENTRY.search(line)
        if m:
            out.append({"kernel": m.group(1), "args": [
                _TYPES.get(a, a[2:]) for a in re.findall(
                    r"13__nv_bfloat16|f|Li\d+", m.group(2))],
                "registers": None, "spill_stores": None, "lines": []})
            continue
        if not out or ("registers" not in line and "spill" not in line):
            continue
        out[-1]["lines"].append(line.strip())
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out[-1]["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
    return out


def flash_instances(lib_path):
    """Every flash kernel instance of ``ptxas_instances``: ``[{"kernel",
    "dtype", "H", "registers", "spill_stores", "smem_bytes"}]``.
    ``registers`` is the count at launch (the Hopper design's warpgroups
    then move to their setmaxnreg budgets); ``smem_bytes`` is the dynamic
    shared memory its launch requests, which ptxas does not see. The
    Hopper design's kernels take H alone (they are bf16 only), and so do
    the split-TF32 design's (float32 only)."""
    lib = ctypes.CDLL(str(lib_path))
    lib.flash_attention_smem.restype = ctypes.c_int
    kinds = {"flash_fwd": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 2}
    out = []
    for r in ptxas_instances(lib_path):
        if r["kernel"].split("_kernel")[0] not in kinds:
            continue
        only = "float32" if r["kernel"].endswith("_tf32") else "bf16"
        dtype, H = (only, *r["args"])[-2:]
        out.append({"kernel": r["kernel"], "dtype": dtype, "H": int(H),
                    "registers": r["registers"],
                    "spill_stores": r["spill_stores"],
                    "smem_bytes": lib.flash_attention_smem(
                        kinds[r["kernel"].split("_kernel")[0]],
                        int(dtype == "bf16"), int(H))})
    return out


def child_processes():
    """[(pid, command line)] of every live process whose parent is this
    one (zombies are not counted: they have ended)."""
    me = str(os.getpid())
    out = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            # the fields after the command, which may hold ")" itself
            stat = (d / "stat").read_text()
            state, ppid = stat.rsplit(")", 1)[1].split()[:2]
            if ppid == me and state != "Z":
                cmd = (d / "cmdline").read_bytes().replace(b"\0", b" ")
                out.append((int(d.name), cmd.decode(errors="replace")[:160]))
        except (OSError, ValueError):
            continue
    return out


# -- phases 19-20a: resilience ------------------------------------------------

ELASTIC_TRAINER = REPO / "tools" / "elastic_gpt_trainer.py"
# 19a-19b, data parallel: steps, the checkpoint interval (saves at steps 3
# and 7) and the kills (rank 1 at step 5, then at step 9)
ELASTIC_STEPS, ELASTIC_SAVE_INTERVAL, ELASTIC_KILLS = 11, 4, "1:5,9"
# 19c, the replicas: steps, the checkpoint interval (a save at step 2),
# rank 1 killed at step 3, rank 0 preempted at step 4 (the fleet saves at 5)
REPLICA_STEPS, REPLICA_SAVE_INTERVAL, REPLICA_KILL = 7, 3, "1:3"
REPLICA_PREEMPT = "rank_preempt:step=4,rank=0"


def elastic_events(work):
    try:
        with open(os.path.join(work, "events.jsonl")) as f:
            return [json.loads(ln) for ln in f if ln.strip()]
    except OSError:
        return []


def start_leg(work, steps, kill_at="", fault="", max_restarts=3,
              save_interval=ELASTIC_SAVE_INTERVAL, deadline=0.0, dp=False,
              trainer_args=()):
    """Start one run of ``tools/elastic_gpt_trainer.py`` under ``python -m
    paddle_tpu_torch.distributed.launch --elastic --nproc_per_node 2``:
    two ranks on ``cuda:0`` (gpt3-1.3B at 2 layers, bf16, batch 2 a rank,
    2048 tokens), data parallel over gloo with ``dp``, else replicas
    through ``TrainStep``. ``fault`` goes to ``FLAGS_fault_inject``.
    Returns a handle for :func:`finish_leg`."""
    os.makedirs(work, exist_ok=True)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--elastic", "--nproc_per_node", "2",
           "--max_restarts", str(max_restarts), "--restart_backoff", "0.2",
           "--terminate_grace", "3", "--log_dir", os.path.join(work, "log"),
           str(ELASTIC_TRAINER), "--work", work, "--steps", str(steps),
           "--save-interval", str(save_interval), *trainer_args]
    if dp:
        cmd.append("--dp")
    if kill_at:
        cmd += ["--kill-at", kill_at]
    if deadline:
        cmd += ["--step-deadline", str(deadline)]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("FLAGS_fault_inject", None)
    if fault:
        env["FLAGS_fault_inject"] = fault
    launcher_log = os.path.join(work, "launcher.log")
    with open(launcher_log, "w") as out:
        proc = subprocess.Popen(cmd, env=env, cwd=str(REPO), stdout=out,
                                stderr=subprocess.STDOUT)
    ended = []  # when the launcher exited, whenever the leg is waited for
    threading.Thread(target=lambda: ended.append(
        (proc.wait(), time.perf_counter())[1]), daemon=True).start()
    return proc, work, launcher_log, time.perf_counter(), ended


def finish_leg(handle, timeout=900):
    """Wait for a :func:`start_leg` run: the launcher's exit code, the
    trainers' event records, the launcher's log and the seconds from its
    start to its exit."""
    proc, work, launcher_log, t0, ended = handle
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    deadline = time.monotonic() + 5
    while not ended and time.monotonic() < deadline:
        time.sleep(0.01)
    with open(launcher_log) as f:
        text = f.read()
    end = ended[0] if ended else time.perf_counter()
    return rc, elastic_events(work), text, end - t0


def elastic_leg(work, steps, during=None, **kw):
    """:func:`start_leg`, ``during(proc, work)`` while it runs, then
    :func:`finish_leg`."""
    handle = start_leg(work, steps, **kw)
    try:
        if during is not None:
            during(handle[0], work)
    finally:
        out = finish_leg(handle)
    return out


def worker_logs(work):
    d = os.path.join(work, "log")
    return {n: open(os.path.join(d, n), errors="replace").read()
            for n in sorted(os.listdir(d))} if os.path.isdir(d) else {}


def launcher_counters(text):
    """The launcher's own ``fault`` counters, from its last log line."""
    m = re.search(r"fault counters (\{.*\})", text)
    return json.loads(m.group(1)) if m else {}


def check_leg(what, rc, ev, text, work):
    if rc != 0:
        tails = {n: t[-1500:] for n, t in worker_logs(work).items()}
        raise AssertionError(f"{what}: the launcher exited {rc}:\n"
                             f"{text[-3000:]}\n{json.dumps(tails)}")
    bad = [e for e in ev if e["ev"] == "step"
           and not math.isfinite(e["loss"])]
    if bad:
        raise AssertionError(f"{what}: non-finite losses {bad[:3]}")


def check_log_lines(what, text, lines):
    for line in lines:
        if line not in text:
            raise AssertionError(f"{what}: no {line!r} in the launcher's "
                                 f"log:\n{text[-3000:]}")


def check_losses(what, ev, want_bits):
    """Every step record of ``ev`` has the loss bits of ``want_bits`` at
    its step (the replicas: one batch for every rank)."""
    off = [(e["rank"], e["pid"], e["step"]) for e in ev if e["ev"] == "step"
           and e["loss_bits"] != want_bits[e["step"]]]
    if off:
        raise AssertionError(f"{what}: losses not bitwise the TrainStep "
                             f"run's at (rank, pid, step) {off}")


def process_summary(ev):
    """Per process: rank, restart count, world, its coordinator, its
    steps, the ``TrainStep`` captures it reached, its in-place restores
    (and the coordinators it formed the world again on), the phases of
    its start, and its final record's K1-K3 launches and fault
    counters."""
    out = {}
    for e in ev:
        p = out.setdefault(e["pid"], {"pid": e["pid"], "rank": e["rank"],
                                      "steps": [], "captures": 0,
                                      "restored": [], "reformed_on": []})
        if e["ev"] == "start":
            p.update(restart=e["restart"], world=e["world"], gen=e["gen"],
                     epoch=e["epoch"], first_step=e["step"], t_start=e["t"],
                     coordinator=e["coordinator"], start_s={
                         "imports": e["t_imported"] - e["t_exec"],
                         "device": e["t_device"] - e["t_imported"],
                         "model": e["t_built"] - e["t_device"],
                         "restore": e["t_restored"] - e["t_built"],
                         "world": e["t_formed"] - e["t_restored"]})
        elif e["ev"] == "step":
            p["steps"].append(e["step"])
            p["captures"] = max(p["captures"], e["captures"])
            p.setdefault("t_first_step", e["t"])
        elif e["ev"] == "restored":
            p["restored"].append(e["step"])
            p["reformed_on"].append(e["coordinator"])
            p.setdefault("t_restored", e["t"])
            p.setdefault("restored_s", {k: e[k] for k in (
                "wait_s", "restore_s", "form_s")})
        elif e["ev"] == "final":
            p["final"] = {k: e[k] for k in ("step", "status", "digest")}
            p["flash_launches"] = e.get("flash_launches")
            p["fault"] = {k: v for k, v in e["fault"].items()
                          if k.startswith("elastic.") and v}
    return out


def check_processes(what, procs, on_card):
    """At most one capture a process; on the card, every process that
    finished launched each of K1-K3 (the card's count)."""
    for pid, p in procs.items():
        if p["captures"] > 1:
            raise AssertionError(f"{what}: process {pid} (rank {p['rank']})"
                                 f" captured {p['captures']} graphs")
        fl = p.get("flash_launches")
        if on_card and "final" in p and not (
                fl and all(v > 0 for v in fl.values())):
            raise AssertionError(f"{what}: process {pid} launched K1-K3 "
                                 f"{fl} on the card")


def step_time(ev, pid, step):
    return max(e["t"] for e in ev if e["ev"] == "step" and e["pid"] == pid
               and e["step"] == step)


def save_seconds(ev):
    return sorted(e["seconds"] for e in ev if e["ev"] == "saved")


def complete_checkpoints(ckpt_dir):
    """(step, world size) of every checkpoint all of whose ranks
    committed."""
    from paddle_tpu_torch.incubate import checkpoint as ckpt

    out = []
    for s in ckpt.list_steps(ckpt_dir):
        d = os.path.join(ckpt_dir, f"ckpt-{s:08d}")
        try:
            with open(os.path.join(d, "MANIFEST.json")) as f:
                w = int(json.load(f)["world_size"])
        except OSError:
            continue
        if all(os.path.exists(os.path.join(
                d, f"MANIFEST-rank{r:05d}.json")) for r in range(1, w)):
            out.append((s, w))
    return out


def elastic_zombie(proc, work):
    """During 19b: once the launcher has shrunk the world (the store's
    world epoch moved to 1), this process acts as a rank of the old world
    (epoch 0, rank 1 of 2) on the launcher's store and tries a periodic
    save through ``CheckpointHook``: the fence refuses it, and the
    checkpoint directory shows nothing new."""
    from paddle_tpu_torch.distributed.fleet.elastic import (
        ElasticTrainContext, GenerationFence, world_epoch)
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.incubate.checkpoint import CheckpointHook
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)

    cfg = GPTConfig.preset("gpt2-tiny", vocab_size=96)
    tiny = GPTForPretraining(GPTModel(cfg, device=torch.device(
        "cuda", 0) if torch.cuda.is_available() else "cpu"))
    deadline = time.monotonic() + 480
    start = None
    while start is None and time.monotonic() < deadline \
            and proc.poll() is None:
        start = next((e for e in elastic_events(work)
                      if e["ev"] == "start"), None)
        time.sleep(0.05)
    if start is None:
        ZOMBIE["error"] = "no rank ever started"
        return
    host, _, port = start["master"].rpartition(":")
    store = TCPStore(host, int(port))
    while world_epoch(store) < 1 and time.monotonic() < deadline \
            and proc.poll() is None:
        time.sleep(0.02)
    ckpt_dir = os.path.join(work, "ckpt")

    def listing():
        return sorted((r, f, os.path.getsize(os.path.join(r, f)))
                      for r, _, fs in os.walk(ckpt_dir) for f in fs)

    before = listing()
    ctx = ElasticTrainContext(store=store, rank=1, world=2, gen=0)
    ctx.fence = GenerationFence(store, gen=0, rank=1)
    hook = CheckpointHook(ckpt_dir, tiny, save_interval=1, async_save=False,
                          rank=1, world_size=2, shard=True,
                          install_sigterm=False, elastic=ctx)
    from paddle_tpu_torch.profiler import registry

    fenced = registry.counters("fault")["elastic.fenced_zombies"]
    ZOMBIE.update(status=hook.on_step_end(ELASTIC_STEPS),
                  fenced_zombies=registry.counters("fault")[
                      "elastic.fenced_zombies"] - fenced,
                  world_epoch=world_epoch(store),
                  unchanged=listing() == before)
    hook.close()
    del store


ZOMBIE = {}


def elastic_yardsticks(dev, ckpt_dir, rehearsal=None):
    """The runs phase 19's legs are held to, here in one process with the
    trainer's own model, step and batches: the replicas' ``TrainStep`` run
    from seed 0 (the loss bits of steps 0 to ``REPLICA_STEPS - 1``), and
    the data-parallel world of one resumed from ``ckpt_dir``'s checkpoint
    7 merged to world 1, an eager step on rank 0's batches (per step from
    8 on: the loss bits and the state's digest)."""
    from paddle_tpu_torch.incubate import checkpoint as ckpt
    from paddle_tpu_torch.jit import TrainStep

    sys.path.insert(0, str(REPO / "tools"))
    import elastic_gpt_trainer as trainer

    shape = ("gpt3-1.3B", 2048, None) if rehearsal is None else (
        rehearsal["preset"], rehearsal["seq_len"], rehearsal["vocab"])

    def built():
        return trainer.build(shape[0], 2, shape[1], shape[2], dev, 1e-4)

    def bits(loss):
        return int(np.float32(loss.float().item()).view(np.uint32))

    cfg, model, crit, opt = built()
    train = TrainStep(trainer.step_of(model, crit, opt), model, opt)
    replicas = {s: bits(train(*trainer.batch_of(
        s, cfg.vocab_size, 2, cfg.seq_len, dev)))
        for s in range(REPLICA_STEPS)}
    del train, model, opt
    free_memory()
    cfg, model, crit, opt = built()
    state, man = ckpt.load_resharded(ckpt_dir, world_size=1, step=7)
    if state is None:
        raise AssertionError("elastic shrink: checkpoint 7 unreadable")
    ckpt.restore_training_state(model, opt, state)
    del state
    step = trainer.step_of(model, crit, opt)
    shrunk = {}
    for s in range(int(man["step"]) + 1, ELASTIC_STEPS):
        loss = step(*trainer.batch_of(s, cfg.vocab_size, 2, cfg.seq_len,
                                      dev, shard=0))
        shrunk[s] = (bits(loss), trainer.state_digest(model, opt))
    del step, model, opt
    free_memory()
    return replicas, shrunk


def check_data_parallel(ev_u, ev, procs, shrunk, text):
    """19a-19b's checks (see the module's docstring); returns their
    numbers."""
    want = {(e["rank"], e["step"]): (e["loss_bits"], e["digest"])
            for e in ev_u if e["ev"] == "step"}
    batches = {(e["rank"], e["step"]): e["batch"] for e in ev_u
               if e["ev"] == "step"}
    if sorted(want) != [(r, s) for r in (0, 1)
                        for s in range(ELASTIC_STEPS)]:
        raise AssertionError(f"19 (uninterrupted): steps {sorted(want)}")
    for s in range(ELASTIC_STEPS):
        if batches[0, s] == batches[1, s] or want[0, s][1] != want[1, s][1]:
            raise AssertionError(
                f"19 (uninterrupted): at step {s} the ranks' batches "
                f"{batches[0, s]}, {batches[1, s]} and states "
                f"{want[0, s][1][:12]}, {want[1, s][1][:12]}: want "
                "batches of their own and one state (averaged gradients)")
    off = [(e["rank"], e["pid"], e["step"]) for e in ev
           if e["ev"] == "step" and e["world"] == 2
           and want[e["rank"], e["step"]] != (e["loss_bits"], e["digest"])]
    if off:
        raise AssertionError("19a: losses or states not bitwise the "
                             f"uninterrupted run's at (rank, pid, step) "
                             f"{off}")
    check_log_lines("19a/19b", text, (
        "rank 1 died: rc=137 (restart 1/1)", "exhausted its restart budget",
        "elastic resize 2 -> 1"))
    by = sorted(procs.values(), key=lambda p: p["t_start"])
    r1 = [p for p in by if p["rank"] == 1]
    r0 = [p for p in by if p["rank"] == 0 and p["world"] == 2]
    w1 = [p for p in by if p["world"] == 1]
    if len(r1) != 2 or len(r0) != 1 or len(w1) != 1:
        raise AssertionError(f"19a/19b: processes {by}")
    r0, survivor = r0[0], w1[0]
    if r1[1]["restart"] != 1 or r1[1]["first_step"] != 4 or \
            r0["restored"] != [4]:
        raise AssertionError(
            f"19a: rank 1 respawned at step {r1[1]['first_step']} (restart "
            f"{r1[1]['restart']}), rank 0 restored in place at "
            f"{r0['restored']}; want both at step 4 (checkpoint 3)")
    coords = [r0["coordinator"], r1[1]["coordinator"],
              survivor["coordinator"]]
    if r1[0]["coordinator"] != coords[0] or \
            r0["reformed_on"] != [coords[1]] or len(set(coords)) != 3:
        raise AssertionError(
            f"19a/19b: coordinators: the first world's {coords[0]} and "
            f"{r1[0]['coordinator']}, the respawn's {coords[1]}, rank 0 "
            f"formed again on {r0['reformed_on']}, the world of one's "
            f"{coords[2]}; want one, then a fresh one both ranks join, "
            "then another")
    if survivor["first_step"] != 8 or survivor["epoch"] != 1 or \
            survivor["steps"] != list(range(8, ELASTIC_STEPS)):
        raise AssertionError(f"19b: the world of one {survivor}; want "
                             "epoch 1, steps 8.. from checkpoint 7")
    got = {e["step"]: (e["loss_bits"], e["digest"]) for e in ev
           if e["ev"] == "step" and e["world"] == 1}
    if got != shrunk or survivor["final"]["digest"] != \
            shrunk[ELASTIC_STEPS - 1][1]:
        raise AssertionError(f"19b: the world of one's steps {got} are not "
                             f"the one-rank run resumed here {shrunk}")
    kill1 = step_time(ev, r1[0]["pid"], 5)
    kill2 = step_time(ev, r1[1]["pid"], 9)
    a = {"restart_first_step_s": r1[1]["t_first_step"] - kill1,
         "rank0_world_formed_again_after_s": r0["t_restored"] - kill1,
         "rank0_rejoin_s": r0["restored_s"],
         "respawn_start_s": r1[1]["start_s"],
         "coordinators": coords}
    b = {"shrink_first_step_s": survivor["t_first_step"] - kill2,
         "survivor_start_s": survivor["start_s"]}
    return a, b


def phase_elastic(dev, rehearsal=None):
    """19-19d: see the module's docstring. ``rehearsal`` (``{"preset",
    "seq_len", "vocab"}``) runs the trainers on the CPU at that size."""
    free_memory()
    root = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    res = {}
    on_card = rehearsal is None
    targs = () if rehearsal is None else (
        "--device", "cpu", "--preset", rehearsal["preset"], "--seq-len",
        str(rehearsal["seq_len"]), "--vocab", str(rehearsal["vocab"]))
    try:
        # 19a + 19b, alone on the card: data parallel, rank 1 killed at
        # step 5 (restarted), then at step 9 with its budget spent (the
        # world shrinks to one)
        work = os.path.join(root, "kill_shrink")
        ZOMBIE.clear()
        rc, ev, text, secs = elastic_leg(
            work, ELASTIC_STEPS, kill_at=ELASTIC_KILLS, max_restarts=1,
            dp=True, during=elastic_zombie, trainer_args=targs)
        log(f"elastic 19a-19b (alone): {secs:.1f} s")
        check_leg("19a/19b", rc, ev, text, work)
        ckpt_dir = os.path.join(work, "ckpt")
        complete = complete_checkpoints(ckpt_dir)
        if [s for s, w in complete if w == 2 and s >= 8] or \
                (7, 2) not in complete:
            raise AssertionError(f"19b: complete checkpoints {complete}")
        if ZOMBIE.get("status") != "fenced" or not ZOMBIE.get("unchanged"):
            raise AssertionError(f"19b: the old world's save {ZOMBIE}")

        # beside each other: the uninterrupted data-parallel run (no
        # checkpoint: a save changes nothing the run computes), 19c (the
        # replicas: rank 1 killed at step 3, then rank 0 preempted) and
        # 19d (the replicas: rank 1's step 4 wedged, the watchdog's
        # deadline 10 s; no checkpoint, as a save takes longer than that),
        # and this process's yardsticks
        work_u = os.path.join(root, "uninterrupted")
        work_c = os.path.join(root, "restart_preempt")
        work_d = os.path.join(root, "hang")
        legs = [start_leg(work_u, ELASTIC_STEPS, save_interval=1000,
                          dp=True, trainer_args=targs)]
        legs.append(start_leg(work_c, REPLICA_STEPS, kill_at=REPLICA_KILL,
                              fault=REPLICA_PREEMPT,
                              save_interval=REPLICA_SAVE_INTERVAL,
                              trainer_args=targs))
        legs.append(start_leg(work_d, 6,
                              fault="step_hang:step=4,rank=1,secs=600",
                              save_interval=1000, deadline=10.0,
                              trainer_args=targs))
        try:
            t0 = time.perf_counter()
            replicas, shrunk = elastic_yardsticks(dev, ckpt_dir, rehearsal)
            log("elastic yardsticks (beside 19c, 19d and the uninterrupted "
                f"run): {time.perf_counter() - t0:.1f} s")
        finally:
            (rc_u, ev_u, text_u, secs_u), preempted, hanged = (
                finish_leg(h) for h in legs)

        check_leg("19 (uninterrupted)", rc_u, ev_u, text_u, work_u)
        procs_u = process_summary(ev_u)
        check_processes("19 (uninterrupted)", procs_u, on_card)
        if len(procs_u) != 2:
            raise AssertionError(f"19 (uninterrupted): {procs_u}")
        res["uninterrupted"] = {
            "seconds": secs_u, "launches": {p["rank"]: p["flash_launches"]
                                            for p in procs_u.values()},
            "start_s": {p["rank"]: p["start_s"] for p in procs_u.values()}}
        log("elastic (uninterrupted, data parallel): "
            + json.dumps(res["uninterrupted"]))

        procs = process_summary(ev)
        check_processes("19a/19b", procs, on_card)
        a, b = check_data_parallel(ev_u, ev, procs, shrunk, text)
        survivor = next(p for p in procs.values() if p["world"] == 1)
        b.update(complete_checkpoints=complete, zombie=dict(ZOMBIE))
        res["restart"], res["shrink"] = a, b
        res["kill_shrink"] = {
            "seconds": secs, "save_s": save_seconds(ev),
            "fault": {"launcher": launcher_counters(text),
                      "survivor": survivor["fault"]},
            "survivor_launches": survivor["flash_launches"]}
        log(f"elastic 19a: {json.dumps(a)}; 19b: {json.dumps(b)}; "
            + json.dumps(res["kill_shrink"]))

        rc, ev, text, secs = preempted
        check_leg("19c", rc, ev, text, work_c)
        check_losses("19c", ev, replicas)
        procs = process_summary(ev)
        check_processes("19c", procs, on_card)
        check_log_lines("19c", text, ("rank 1 died: rc=137 (restart 1/",))
        by = sorted(procs.values(), key=lambda p: p["t_start"])
        r1 = [p for p in by if p["rank"] == 1]
        r0 = [p for p in by if p["rank"] == 0]
        if len(r1) != 2 or len(r0) != 1 or r1[1]["first_step"] != 3 or \
                r0[0]["restored"] != [3] or \
                (on_card and r0[0]["captures"] != 1):
            raise AssertionError(
                f"19c: processes {by}; want rank 1 respawned and rank 0 "
                "restored in place at step 3 (checkpoint 2), rank 0's "
                "graph kept (one capture)")
        d = os.path.join(work_c, "ckpt", "ckpt-00000005")
        mans = []
        for name in ("MANIFEST.json", "MANIFEST-rank00001.json"):
            with open(os.path.join(d, name)) as f:
                mans.append(json.load(f))
        got = [(m["step"], m["user"].get("emergency"),
                m["user"].get("coordinated"), m["user"].get("preempt_target"))
               for m in mans]
        finals = [p for p in by if "final" in p]
        if got != [(5, True, 2, 5)] * 2 or sorted(
                p["final"]["status"] for p in finals) != ["preempted"] * 2:
            raise AssertionError(f"19c: manifests {got}, processes {by}")
        kill = step_time(ev, r1[0]["pid"], 3)
        res["preempt"] = {
            "seconds": secs, "manifests": got,
            "restart_first_step_s": r1[1]["t_first_step"] - kill,
            "rank0_restored_after_s": r0[0]["t_restored"] - kill,
            "rank0_rejoin_s": r0[0]["restored_s"],
            "captures": {p["pid"]: p["captures"] for p in by},
            "save_s": save_seconds(ev),
            "emergency_save_s": sorted(e["seconds"] for e in ev
                                       if e["ev"] == "preempted"),
            "fault": {"launcher": launcher_counters(text),
                      **{p["rank"]: p["fault"] for p in finals}},
            "launches": {p["rank"]: p["flash_launches"] for p in finals}}
        log("elastic 19c: " + json.dumps(res["preempt"]))

        rc, ev, text, secs = hanged
        check_leg("19d", rc, ev, text, work_d)
        check_losses("19d", ev, replicas)
        procs = process_summary(ev)
        check_processes("19d", procs, on_card)
        logs = worker_logs(work_d)
        if "rank 1 hung: step watchdog escalated" not in text or \
                "WATCHDOG" not in logs.get("workerlog.1", "") or \
                "--- thread" not in logs.get("workerlog.1", ""):
            raise AssertionError(f"19d: launcher log {text[-2000:]}")
        respawned = [p for p in procs.values()
                     if p["rank"] == 1 and p.get("restart") == 1]
        finals = [p for p in procs.values() if "final" in p]
        if not respawned or sorted(p["rank"] for p in finals) != [0, 1] or \
                any(p["final"]["step"] != 6 for p in finals) or \
                respawned[0]["first_step"] != 0:
            raise AssertionError(f"19d: processes {procs}")
        hang_t = max(e["t"] for e in ev if e["ev"] == "step"
                     and e["rank"] == 1 and e["step"] == 4
                     and e["pid"] != respawned[0]["pid"])
        res["hang"] = {
            "seconds": secs,
            "hang_to_first_step_s": respawned[0]["t_first_step"] - hang_t,
            "rank0_restarted": any(p["rank"] == 0 and p.get("restart")
                                   for p in procs.values()),
            "fault": {"launcher": launcher_counters(text),
                      **{p["rank"]: p["fault"] for p in finals}},
            "launches": {p["rank"]: p["flash_launches"] for p in finals}}
        log("elastic 19d: " + json.dumps(res["hang"]))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


WAVE = 16  # phase 20's first wave (the kill lands in it); 8 follow


def supervised_requests(vocab, n=WAVE + 8, seed=3, longest=256):
    """Phase 20's mix: prompts of 16-256 tokens, 32 new tokens; every
    fourth sampled at temperature 0.8, the rest greedy; no seed (the
    supervisor pins one per request)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(0, vocab, int(
            rng.integers(16, longest + 1))).tolist()
        out.append((prompt, dict(max_new_tokens=32, temperature=0.8)
                    if i % 4 == 3 else dict(max_new_tokens=32)))
    return out


def supervised_run(dev, model, reqs, fault=None):
    """One ``ReplicaSupervisor`` of 2 replicas sharing ``model``
    (``rng_seed`` 7): each replica warmed with one request per prompt
    bucket of the mix (its graphs captured; K4's launches on the card
    counted per replica), then the first ``WAVE`` of ``reqs`` served with
    ``fault`` armed, then the rest."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.profiler import explainer, registry
    from paddle_tpu_torch.serving import GenerationEngine, ReplicaSupervisor
    from paddle_tpu_torch.testing import faults

    def factory():
        return GenerationEngine(model, max_batch_size=8, block_size=16,
                                rng_seed=7, device=dev)

    sup = ReplicaSupervisor(factory, replicas=2, restart_backoff=0.05,
                            monitor_interval=0.02, max_queue_size=64)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    allocated = torch.cuda.memory_allocated if on_card else (lambda: 0)
    out = {}
    try:
        eng = sup._replicas[0].server.engine
        pool_bytes = sum(k.nbytes + v.nbytes for k, v in eng._kv)
        buckets = sorted({eng.bucket_for(len(p)) for p, _ in reqs})
        # held here, replica 0's engine would outlive its death (the kill
        # lands on whichever replica takes the armed step) and read as a
        # leak in the memory check below
        del eng
        rng = np.random.default_rng(5)
        k4 = []
        for rep in sup._replicas:
            if on_card:
                pa.reset_device_launches()
            for b in buckets:
                rep.server.generate(rng.integers(
                    0, 90, b - 1).tolist(), max_new_tokens=4)
            k4.append(sum(pa.device_launches().values()) if on_card else 0)
        deaths = []
        orig = sup._handle_death

        def spy(rep, now):
            t = time.monotonic()
            orig(rep, now)
            deaths.append((rep.rid, t, list(sup._held)))

        sup._handle_death = spy
        sync()
        mem0 = allocated()
        c0 = registry.counters("serving")
        e0 = len(explainer.events())
        if on_card:
            pa.reset_device_launches()
        if fault:
            faults.configure(fault)
        try:
            handles = [sup.submit(p, **o) for p, o in reqs[:WAVE]]
            for h in handles:
                h.result(timeout=600)
        finally:
            faults.reset()
        # the second wave: the least-loaded placement gives the respawned
        # replica work, so it captures its decode graph while its sibling
        # replays its own
        second = [sup.submit(p, **o) for p, o in reqs[WAVE:]]
        for h in second:
            h.result(timeout=600)
        handles += second
        sync()
        mem1 = allocated()
        c1 = registry.counters("serving")
        bad = [h for h in handles if h.status != "done"
               or len(h.tokens) != h.max_new_tokens]
        if bad:
            raise AssertionError(f"supervised serving: unfinished {bad}")
        kills = [e for e in explainer.events()[e0:]
                 if e["kind"] == "fault_injected"
                 and e.get("op") == "replica_kill"]
        out = {"tokens": [list(h.tokens) for h in handles],
               "k4_warmup_per_replica": k4,
               "k4_window": sum(pa.device_launches().values())
               if on_card else 0,
               "counters": {k: c1[k] - c0.get(k, 0) for k in (
                   "replica_restarts", "requeued_requests",
                   "decode_compiles", "prefill_compiles", "replicas_retired")},
               "memory_before_gb": mem0 / 1e9, "memory_after_gb": mem1 / 1e9,
               "pool_gb": pool_bytes / 1e9, "stats": sup.stats()}
        if deaths:
            rid, t_dead, held = deaths[0]
            # the explainer's clock is the wall's; the requests' monotonic
            t_kill = kills[0]["ts"] - (time.time() - time.monotonic()) \
                if kills else t_dead
            firsts = [h.first_tok_ts for h in held
                      if h.first_tok_ts is not None]
            out.update(dead_replica=rid, orphans=len(held),
                       kill_to_replayed_first_token_s=min(firsts) - t_kill
                       if firsts else None)
    finally:
        sup.shutdown()
    return out


def phase_supervisor(dev, rehearsal=None):
    """20 and 20a: see the module's docstring. ``rehearsal`` (``{"preset",
    "vocab"}``) runs them on the CPU at that size."""
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.serving import GenerationEngine, ReplicaSupervisor

    free_memory()
    over = {"dtype": "bfloat16"} if rehearsal is None else {
        "vocab_size": rehearsal["vocab"]}
    preset = "gpt3-1.3B" if rehearsal is None else rehearsal["preset"]
    cfg = GPTConfig.preset(preset, **over)
    model = GPTForPretraining(GPTModel(
        cfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0)))
    reqs = supervised_requests(cfg.vocab_size, longest=min(
        256, cfg.seq_len - 40))
    t0 = time.perf_counter()
    calm = supervised_run(dev, model, reqs)
    calm_s = time.perf_counter() - t0
    free_memory()
    t0 = time.perf_counter()
    hit = supervised_run(dev, model, reqs, fault="replica_kill:nth=24")
    hit_s = time.perf_counter() - t0
    same = [i for i, (a, b) in enumerate(zip(calm["tokens"], hit["tokens"]))
            if a == b]
    c = hit["counters"]
    if len(same) != len(reqs):
        raise AssertionError(f"20: {len(same)} of {len(reqs)} requests "
                             "equal the undisturbed run's")
    # on the card the respawned engine captures its decode graph once
    if c["replica_restarts"] != 1 or not hit.get("orphans") or \
            c["decode_compiles"] != int(dev.type == "cuda"):
        raise AssertionError(f"20: counters {c}, orphans "
                             f"{hit.get('orphans')}")
    if dev.type == "cuda" and (not all(
            n > 0 for n in hit["k4_warmup_per_replica"])
            or hit["k4_window"] <= 0):
        raise AssertionError(f"20: K4 launches {hit['k4_warmup_per_replica']}"
                             f", {hit['k4_window']}")
    if abs(hit["memory_after_gb"] - hit["memory_before_gb"]) > \
            hit["pool_gb"]:
        raise AssertionError(
            f"20: memory {hit['memory_before_gb']:.3f} GB before the kill, "
            f"{hit['memory_after_gb']:.3f} after the respawn; one engine's "
            f"pools are {hit['pool_gb']:.3f} GB")
    res = {"undisturbed_s": calm_s, "with_kill_s": hit_s,
           "requests_equal": len(same),
           **{k: v for k, v in hit.items() if k != "tokens"}}
    del calm, hit
    free_memory()
    # 20a: the autoscaler at 2 layers, one replica to two and back
    small = GPTForPretraining(GPTModel(
        GPTConfig.preset(preset, n_layer=2, **over), device=dev,
        generator=torch.Generator(device=dev).manual_seed(0)))
    c0 = registry.counters("serving")
    sup = ReplicaSupervisor(
        lambda: GenerationEngine(small, max_batch_size=2, block_size=16,
                                 rng_seed=7, device=dev),
        replicas=1, min_replicas=1, max_replicas=2, scale_up_queue_depth=4,
        scale_interval=0.1, monitor_interval=0.02, max_queue_size=64)
    try:
        rng = np.random.default_rng(8)
        t0 = time.perf_counter()
        burst = [sup.submit(rng.integers(0, 90, 64).tolist(),
                            max_new_tokens=48) for _ in range(24)]
        most = 1
        while not all(h.done for h in burst):
            most = max(most, sup.replicas())
            time.sleep(0.01)
            if time.perf_counter() - t0 > 300:
                raise AssertionError("20a: the burst never finished")
        t_up = time.perf_counter() - t0
        deadline = time.monotonic() + 60
        while sup.replicas() > 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        down = sup.replicas()
        c1 = registry.counters("serving")
        scale = {k: c1[k] - c0.get(k, 0) for k in ("scale_ups",
                                                   "scale_downs")}
        if most < 2 or down != 1 or scale["scale_ups"] < 1 or \
                scale["scale_downs"] < 1 or \
                registry.gauge("serving.replicas") != 1:
            raise AssertionError(f"20a: most {most} replicas, {down} when "
                                 f"idle, {scale}")
        res["autoscale"] = {"most_replicas": most, "burst_s": t_up,
                            "idle_replicas": down, **scale}
    finally:
        sup.shutdown()
    del small, model
    free_memory()
    return res


def stop_children():
    """Stop the DataLoader's workers and fork server and multiprocessing's
    resource tracker (they would end a moment after this process), then
    every other child still alive. Returns those others: the script starts none that should
    still run here."""
    dataloader = sys.modules.get("paddle_tpu_torch.io.dataloader")
    if dataloader is not None:
        dataloader.stop_servers()
    # phase 12's spawned ranks start multiprocessing's resource tracker
    from multiprocessing import resource_tracker

    resource_tracker._resource_tracker._stop()
    left = child_processes()
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid, _ in child_processes():
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + 10
        while child_processes() and time.monotonic() < deadline:
            time.sleep(0.1)
    return left


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a "
              "GPU", file=sys.stderr)
        return 2
    if not (REPO / "paddle_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: paddle_tpu_torch not found beside {__file__}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import paddle_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from paddle_tpu_torch.ops import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log(f"device: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = timed("2 build", _build.build)
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for r in ptxas_instances(libs["paged_attention"]):
        for line in r["lines"]:
            log(f"build: {r['kernel']}<{','.join(r['args'])}>: {line}")
    for r in flash_instances(libs["flash_attention"]):
        log(f"build: {r['kernel']} {r['dtype']} H={r['H']}: "
            f"{r['registers']} registers, {r['spill_stores']} bytes spill "
            f"stores, {r['smem_bytes']} bytes shared memory")

    paged = timed("3 kernels", phase_kernels, dev)
    served, plain = timed("4 serving", phase_serving, dev)
    swapped, retried = timed("4c-4d swap, retry", phase_swap, dev)
    handoff, ctx = timed("4e handoff", phase_handoff, dev)
    graphs = timed("4f prefill graphs", phase_prefill_graphs, dev,
                   ctx["model"])
    observed = timed("4g observability", phase_observability, dev, ctx)
    del ctx
    free_memory()
    timed("5 parity", phase_parity, dev)
    spec = timed("5b spec", phase_spec_serving, dev, plain)
    timed("5c spec swap", phase_spec_swap, dev)
    moe_served, moe_plain = timed("9 moe serving", phase_moe_serving, dev)
    moe_spec = timed("9b moe spec", phase_moe_spec, dev, moe_plain)
    timed("9d older cache forms", phase_legacy_cache, dev)
    for row in paged:  # launches the card counted on the main paths
        verify = row["name"] == "paged_attention_verify"
        row["launches"] = (spec["verify_launches"] if verify
                           else served["decode_launches"])
        row["launches_by_path"] = (
            {"spec": spec["verify_launches"],
             "moe spec": moe_spec["verify_launches"]} if verify else
            {"serving": served["decode_launches"],
             "moe serving": moe_served["decode_launches"]})
    flash = timed("6 kernels (training)", phase_flash_kernels, dev)
    trained, model = timed("7 training", phase_training, dev)
    for name, row in flash.items():
        if name in FLASH_KERNELS:
            row["launches"] = trained["launches"][name]
    followed = timed("7b train -> serve", phase_train_to_serve, dev, model,
                     step=trained["trained_steps"])
    del model
    free_memory()
    timed("7b state round trip", phase_train_state_round_trip, dev)
    timed("8 training parity", phase_training_parity, dev)
    timed("8 training parity bf16", phase_training_parity_bf16, dev)
    moe_trained = timed("9c moe training", phase_moe_training, dev)
    policies = timed("10 recompute", phase_recompute, dev)
    policy_parity = timed("10 recompute parity", phase_recompute_parity,
                          dev)
    recipe = timed("10b recipe", phase_recipe_graph, dev)
    recaptured = timed("10c recapture", phase_recapture, dev)
    fitted = timed("11 fit", phase_fit, dev, trained["step_ms"])
    resumed = timed("11b resume", phase_fit_resume, dev)
    fp16 = timed("11c fp16", phase_fp16_scaler, dev)
    bert = timed("14 bert float32", phase_bert_pretraining, dev)
    bert_bf16 = timed("14b bert bf16", phase_bert_pretraining, dev,
                      "bfloat16", seq_len=512)
    bert_parity = timed("14c bert parity", phase_bert_parity, dev)
    ernie = timed("14d ernie inference", phase_ernie_inference, dev)
    resnet, resnet_o1 = timed("15 resnet", phase_resnet_training, dev)
    resnet_parity = timed("15b resnet parity", phase_resnet_parity, dev)
    static_run, static_ctx = timed("16 ernie static", phase_ernie_static,
                                   dev)
    static_io = timed("16a static save/load", phase_ernie_static_io, dev,
                      static_ctx)
    del static_ctx
    free_memory()
    static_train = timed("16b static training",
                         phase_ernie_static_training, dev)
    static_cf = timed("16c static control flow", phase_static_control_flow,
                      dev)
    free_memory()
    lstm = timed("17 lstm lm", phase_lstm_lm, dev)
    rnn_fn = timed("17a gru, rnnt, functional", phase_rnn_rnnt_functional,
                   dev)
    yolo = timed("18 yolov3", phase_yolov3, dev)
    heads = timed("18a detection heads", phase_detection_heads, dev)
    runs = {"bfloat16": ("14b", bert_bf16), "float32": ("14", bert)}
    for name, row in flash.items():  # the encoder path's instances
        if "_noncausal_" not in name:
            continue
        kern, dtype = name.split("_noncausal_")
        phase, run = runs[dtype]
        row["launches"] = run["launches"][kern]
        row["launches_by_path"] = {
            f"bert pretraining {dtype} (phase {phase}, "
            f"{run['steps'] - 2} replays)": run["launches"][kern]}
        if kern == "flash_fwd" and dtype == "bfloat16":
            row["launches_by_path"]["ernie inference (phase 14d, per "
                                    "forward)"] = \
                ernie["launches_per_forward"]
        if dtype == "float32":
            paths = row["launches_by_path"]
            if kern == "flash_fwd":
                paths["ernie static Executor (phase 16, per run)"] = \
                    static_run["k1_launches_per_run"]
                paths["ernie Predictor (phase 16a, per run)"] = \
                    static_io["k1_launches_per_run"]
            paths["ernie static training (phase 16b, per run)"] = \
                static_train["launches_per_run"][kern]
            if kern == "flash_fwd":
                paths["F.scaled_dot_product_attention (phase 17a, "
                      f"{rnn_fn['attention']['sdpa_calls']} calls)"] = \
                    rnn_fn["attention"]["sdpa_k1_launches"]
    for row in paged:  # the functional entry's launches of K4's row
        if row["name"] == "paged_attention":
            row["launches_by_path"][
                "F.paged_attention(kernel='pallas') (phase 17a, "
                f"{rnn_fn['attention']['paged_calls']} calls)"] = \
                rnn_fn["attention"]["paged_k4_launches"]
    world_dir = tempfile.mkdtemp(prefix="chip_smoke_world_")
    t0 = time.perf_counter()
    world = two_ranks(dev, world_dir)
    world_start_s = time.perf_counter() - t0
    try:
        dist = timed("12 distributed", phase_distributed, dev, world,
                     trained["losses"][:3])
        dist["world_start_s"] = world_start_s
        mesh = timed("13 mesh serving", phase_mesh_serving, dev, world,
                     plain)
        mesh_small = timed("13b mesh spec, swap, handoff", phase_mesh_small,
                           dev, world)
        axes = timed("21-21c pipeline, zero, ep", phase_parallel_axes, dev,
                     world, trained["losses"][:3])
    finally:
        world.close()
        shutil.rmtree(world_dir, ignore_errors=True)
    shard = instance_name(("bfloat16", 64, 1))
    for row in paged:
        if row["name"] == MP_SHARD[0]:
            row["launches"] = mesh["launches"][0][shard]
            row["launches_by_path"] = {
                f"mesh serving rank {r} (gloo, uncaptured)": n[shard]
                for r, n in mesh["launches"].items()}
    for name, row in flash.items():
        if name not in FLASH_KERNELS:
            continue
        row["launches_by_path"] = {
            "training": trained["launches"][name],
            "fit (bf16 instance)": fitted["launches"][name],
            "moe training": moe_trained["launches"][name],
            **{f"recompute {pol} (per step)": r["launches_per_step"][name]
               for pol, r in policies.items()},
            **{f"mp=2 rank {r['rank']} (gloo, eager)": r["launches"][name]
               for r in dist["ranks"]},
            **{f"pp=2 {kind} stage {r['rank']} (phase {ph}, gloo, eager)":
               r["launches"][name] for kind, ph in (("gpipe", "21"),
                                                    ("1f1b", "21a"))
               for r in axes[kind]["ranks"]},
            **{f"ep=2 rank {i} (phase 21c, gloo, eager)": r["launches"][name]
               for i, r in enumerate(axes["moe"]["ep2"])}}
    log(f"serving on {smi}: {served['tokens_per_s']:.1f} tokens/s, p50 TTFT "
        f"{served['ttft_p50_ms']:.1f} ms, p50 decode step "
        f"{served['decode_step_p50_ms']:.2f} ms (CUDA graph)")
    log(f"spec serving on {smi}: {spec['tokens_per_s']:.1f} tokens/s, p50 "
        f"TTFT {spec['ttft_p50_ms']:.1f} ms, p50 round "
        f"{spec['round_p50_ms']:.2f} ms, acceptance {spec['acceptance']:.4f}"
        f", {spec['emitted_per_round']:.2f} tokens per round; against plain "
        f"decode {json.dumps(spec['plain_match'])}")
    log(f"swap on {smi}: stage {swapped['swap_stage_s']:.3f} s, copy "
        f"{swapped['swap_commit_s'] * 1e3:.2f} ms, step with the swap "
        f"{swapped['step_with_swap_ms']:.1f} ms, steady step p50 "
        f"{swapped['steady_step_p50_ms_before']:.2f} ms before / "
        f"{swapped['steady_step_p50_ms_after']:.2f} ms after; retry "
        f"{json.dumps(retried['counters_moved'])}")
    log(f"handoff on {smi}: B's tokens equal M's for "
        f"{handoff['requests']} requests; export "
        f"{handoff['export_ms_p50']:.2f} ms, import "
        f"{handoff['import_ms_p50']:.2f} ms per request (p50, payload "
        f"{handoff['payload_mb_p50']:.1f} MB); B's p50 TTFT "
        f"{handoff['ttft_p50_ms']:.1f} ms, p50 decode step "
        f"{handoff['decode_step_p50_ms']:.2f} ms")
    log(f"prefill graphs on {smi}: " + ", ".join(
        f"{L}: {r['graph_device_ms']:.2f}/{r['direct_device_ms']:.2f} ms"
        for L, r in graphs["per_bucket"].items())
        + f" (graph/direct, device); shared pool "
        f"{graphs['graph_pool_reserved_mb']:.0f} MB; phase 4 p50 TTFT "
        f"{served['ttft_p50_ms']:.1f} ms with prefill graphs")
    log(f"observability on {smi}: decode step p50 "
        f"{observed['traces']['decode_step_p50_ms_tracing_on']:.2f} ms "
        f"with tracing on, "
        f"{observed['traces']['decode_step_p50_ms_tracing_off']:.2f} off; "
        f"fault points {sorted(k for k in observed if k != 'traces')}")
    log(f"train->serve on {smi}: {followed['bytes'] / 1e9:.2f} GB saved in "
        f"{followed['save_s']:.1f} s, followed (load and swap) in "
        f"{followed['follow_load_and_swap_s']:.1f} s, swap stage "
        f"{followed['swap_stage_s']:.3f} s")
    log(f"training on {smi}: {trained['preset']} bf16 batch "
        f"{trained['batch']} x {trained['seq_len']}: step "
        f"{trained['step_ms']:.1f} ms, {trained['tokens_per_s']:.0f} "
        f"tokens/s, MFU {trained['mfu']:.4f}, peak memory "
        f"{trained['peak_memory_gb']:.1f} GB")
    log(f"moe serving on {smi}: {moe_served['tokens_per_s']:.1f} tokens/s, "
        f"p50 TTFT {moe_served['ttft_p50_ms']:.1f} ms, p50 decode step "
        f"{moe_served['decode_step_p50_ms']:.2f} ms (CUDA graph), peak "
        f"memory {moe_served['peak_memory_gb']:.1f} GB; K4 "
        f"{moe_served['decode_launches']} launches = "
        f"{moe_served['decode_steps']} steps x 24; drop fraction of one "
        f"eager forward "
        f"{moe_served['eager_forward_8x512']['drop_fraction']:.4f}")
    log(f"moe spec on {smi}: {moe_spec['tokens_per_s']:.1f} tokens/s, p50 "
        f"TTFT {moe_spec['ttft_p50_ms']:.1f} ms, p50 round "
        f"{moe_spec['round_p50_ms']:.2f} ms; dense spec p50 TTFT "
        f"{spec['ttft_p50_ms']:.1f} ms with drafter prefill graphs "
        f"{json.dumps(spec['draft_prefill_buckets'])}")
    log(f"training graph on {smi}: step {trained['step_ms']:.1f} ms "
        f"(graph) / {trained['eager_step_ms']:.1f} ms (eager loop), MFU "
        f"{trained['mfu']:.4f} / {trained['eager_mfu']:.4f}, peak memory "
        f"{trained['peak_memory_gb']:.1f} / "
        f"{trained['eager_peak_memory_gb']:.1f} GB, "
        f"{trained['host_kernel_launches_per_step']:.0f} kernels launched "
        f"from the host per step")
    log(f"recompute on {smi}: " + ", ".join(
        f"{pol} {r['step_ms']:.1f} ms MFU {r['mfu']:.4f} peak "
        f"{r['peak_memory_gb']:.1f} GB K1 "
        f"{r['launches_per_step']['flash_fwd']:.0f}/step"
        for pol, r in policies.items())
        + f"; float32 parity against none {json.dumps(policy_parity)}")
    log(f"recipe on {smi}: graph == eager bitwise over "
        f"{len(recipe['losses'])} steps, rates {recipe['rates']}; dropout "
        f"{json.dumps(recipe['dropout'])}; {len(recipe['optimizers'])} "
        f"optimizer cases captured == eager; recapture "
        f"{json.dumps(recaptured)}")
    log(f"moe training on {smi}: {moe_trained['n_layer']} layers, batch "
        f"{moe_trained['batch']} x {moe_trained['seq_len']}: step "
        f"{moe_trained['replay_step_ms']:.1f} ms (graph replay), "
        f"losses {moe_trained['losses']}, peak memory "
        f"{moe_trained['peak_memory_gb']:.1f} GB; AccumulateGrad stream "
        f"warnings per call {moe_trained['stream_mismatch_warnings']}, "
        f"{moe_trained['stream_mismatch_warnings_aux_dropped']} with "
        f"aux_loss dropped after the warm-up; host syncs over 2 replays "
        f"{moe_trained['host_syncs_2_replays']}")
    log(f"fit on {smi}: gpt3-1.3B float32 parameters under O1, batch "
        f"{fitted['batch']} x {fitted['seq_len']}, {fitted['workers']} "
        f"workers: p50 batch {fitted['batch_p50_ms']:.1f} ms (phase 7's "
        f"graph step {trained['step_ms']:.1f} ms), "
        f"{fitted['tokens_per_s']:.0f} tokens/s, MFU {fitted['mfu']:.4f}, "
        f"peak memory {fitted['peak_memory_gb']:.1f} GB; dataloader.wait "
        f"p50 {fitted['dataloader_wait_p50_ms']:.3f} ms, worker_busy "
        f"{fitted['worker_busy_s']:.3f} s, workers' first batch after "
        f"{fitted['worker_start_s']:.2f} s, "
        f"{fitted['worker_restart_s']:.3f} s in a second epoch (worker "
        f"module import {fitted['worker_import_s']:.2f} s); losses "
        f"{fitted['losses'][0]:.4f} -> {fitted['losses'][-1]:.4f}")
    log(f"fit resume on {smi}: bitwise over epoch 2 "
        f"{resumed['resumed_losses']}, checkpoint "
        f"{resumed['checkpoint_gb']:.2f} GB, torn epoch "
        f"{resumed['torn_skipped_epoch']} skipped, nan_loss "
        f"{resumed['nan_loss_losses']}; fp16 losses {fp16['losses']}, "
        f"scales {fp16['scales']}, fallback \"{fp16['fallback_why']}\", "
        f"inf step {json.dumps(fp16['inf_step'])}")
    for run in (bert, bert_bf16):
        log(f"bert pretraining on {smi}: bert-base {run['dtype']} batch "
            f"{run['batch']} x {run['seq_len']} through TrainStep's graph: "
            f"p50 step {run['step_p50_ms']:.2f} ms, "
            f"{run['tokens_per_s']:.0f} tokens/s, MFU {run['mfu']:.4f} "
            f"({run['mfu_peak']}), peak memory "
            f"{run['peak_memory_gb']:.2f} GB; losses {run['losses'][0]:.4f}"
            f" -> {run['losses'][-1]:.4f}; K1-K3 {run['launches']} by "
            f"design {run['designs']}")
    log(f"ernie inference on {smi}: ernie-3.0-medium bf16 batch "
        f"{ernie['batch']} x {ernie['seq_len']}: p50 forward "
        f"{ernie['forward_p50_ms']:.2f} ms, {ernie['samples_per_s']:.0f} "
        f"samples/s, K1 {ernie['launches_per_forward']:.0f} per forward; "
        f"bert parity {json.dumps(bert_parity)}")
    for run in (resnet, resnet_o1):
        log(f"resnet training on {smi}: resnet50 {run['amp']} batch "
            f"{run['batch']} x 3 x {run['side']}^2 through TrainStep's "
            f"graph: p50 step {run['step_p50_ms']:.2f} ms, "
            f"{run['images_per_s']:.1f} images/s, MFU {run['mfu']:.4f} "
            f"({run['mfu_peak']}; least step "
            f"{run['least_step_ms']:.2f} ms), device "
            f"{run['device_ms_per_step']:.2f} ms a step, "
            f"{run['host_kernel_launches_per_step']:.0f} kernels launched "
            f"from the host a step, peak memory "
            f"{run['peak_memory_gb']:.2f} GB; losses "
            f"{run['losses'][0]:.4f} -> {run['losses'][-1]:.4f}")
    log(f"resnet parity on {smi}: {json.dumps(resnet_parity)}")
    log(f"ernie static on {smi}: bert-base float32 batch "
        f"{static_run['batch']} x {static_run['seq_len']} through "
        f"Executor.run's CUDA graph: p50 run {static_run['run_p50_ms']:.2f} "
        f"ms (numpy feed and fetch included), "
        f"{static_run['samples_per_s']:.0f} samples/s, device "
        f"{static_run['device_ms_per_run']:.2f} ms a run, host calls a run "
        f"{json.dumps(static_run['host_calls_per_run'])}; eager forward "
        f"p50 {static_run['eager_forward_p50_ms']:.2f} ms (phase 14d, "
        f"ernie-3.0-medium bf16: {ernie['forward_p50_ms']:.2f} ms); K1 "
        f"{static_run['k1_launches_per_run']:.0f} a run, captures "
        f"{static_run['captures']}; logits vs eager "
        f"{static_run['max_abs_err_vs_eager']:.3e}, vs plain "
        f"{static_run['max_abs_err_vs_plain']:.3e}; peak memory "
        f"{static_run['peak_memory_gb']:.2f} GB")
    log(f"ernie static save/load on {smi}: {json.dumps(static_io)}")
    log(f"ernie static training on {smi}: p50 step "
        f"{static_train['step_p50_ms']:.2f} ms, losses "
        f"{static_train['losses']} (TrainStep "
        f"{static_train['trainstep_losses']}, gap "
        f"{static_train['max_loss_gap']:.3e}); host calls a replay "
        f"{json.dumps(static_train['host_calls_per_replay'])}; loaded and "
        f"continued {static_train['resumed_loss']!r} == "
        f"{static_train['continued_loss']!r}; control flow "
        f"{json.dumps(static_cf)}")
    log(f"lstm lm on {smi}: {LSTM_LM['vocab']} x {LSTM_LM['hidden']} x "
        f"{LSTM_LM['layers']} layers, float32, batch {lstm['batch']} x "
        f"{lstm['steps']} through TrainStep's graph: p50 step "
        f"{lstm['step_p50_ms']:.2f} ms, {lstm['tokens_per_s']:.0f} tokens/s, "
        f"device {lstm['device_ms_per_step']:.2f} ms a step, "
        f"{lstm['host_kernel_launches_per_step']:.0f} kernels launched from "
        f"the host a step, peak memory {lstm['peak_memory_gb']:.2f} GB; "
        f"losses {lstm['losses'][0]:.4f} -> {lstm['losses'][-1]:.4f}; graph "
        f"vs eager {json.dumps(lstm['graph_vs_eager'])}; card vs CPU "
        f"float64 {json.dumps(lstm['card_vs_cpu_float64'])}; cuDNN "
        f"yardstick {json.dumps(lstm['yardstick'])}")
    log(f"gru, rnnt, functional on {smi}: {json.dumps(rnn_fn)}")
    log(f"yolov3 on {smi}: {json.dumps(yolo)}")
    log(f"detection heads on {smi}: {json.dumps(heads)}")
    r0 = dist["ranks"][0]
    peak = max(r["peak_memory_gb"] for r in dist["ranks"])
    staged = {k: v for k, v in r0["collective"].items() if "staged" in k}
    small = {k: [r["max_param_diff"] for r in v]
             for k, v in dist["small"].items()}
    log(f"tensor parallel on {smi}: gpt3-1.3B bf16 at mp=2, two ranks on "
        f"cuda:0 over gloo: steps {[round(x, 3) for x in r0['step_s']]} s, "
        f"{r0['bytes_reduced_per_step'] / 1e9:.3f} GB all-reduced per step "
        f"and rank, peak {peak:.1f} GB per rank, state "
        f"{r0['state_gb']:.2f} GB per rank; losses {r0['losses']} against "
        f"phase 7's {trained['losses'][:3]} (gaps {r0['loss_gaps']}); host "
        f"staged {staged}; 12b parameter gaps {json.dumps(small)}; 12c "
        f"{json.dumps(dist['nccl_world_1'])}")
    log(f"mesh serving on {smi}: gpt3-1.3B bf16 at mp=2, two ranks on "
        f"cuda:0 over gloo (uncaptured): {mesh['requests']} requests, "
        f"{mesh['matched_whole']} token-for-token equal to phase 4's, "
        f"first differences {json.dumps(mesh['first_differences'])}; "
        f"first-token logits gap max {mesh['first_logits_gap_max']:.4f}; "
        f"p50 decode step {mesh['decode_step_p50_ms']:.1f} ms (host clock), "
        f"{mesh['tokens_per_s']:.1f} tokens/s; bytes per step and rank "
        f"{json.dumps(mesh['bytes_per_step'])} (predicted "
        f"{json.dumps(mesh['bytes_per_step_predicted'])}); peak memory "
        f"{json.dumps(mesh['peak_memory_gb'])} GB; K4 "
        f"{json.dumps(mesh['launches'])} for {mesh['decode_steps']} steps; "
        f"13b {json.dumps(mesh_small['checks'])}")
    for kind, ph in (("gpipe", "21"), ("1f1b", "21a")):
        rs = axes[kind]["ranks"]
        log(f"pipeline {kind} (phase {ph}) on {smi}: gpt3-1.3B bf16 at pp=2 "
            f"x {PP_M} microbatches, two ranks on cuda:0 over gloo: steps "
            f"{[[round(x, 3) for x in r['step_s']] for r in rs]} s, losses "
            f"{rs[0]['losses']} (gaps to phase 7 {rs[0]['loss_gaps']}), "
            f"boundary bytes a step {axes[kind]['sent_bytes_per_step']} "
            f"(predicted {axes[kind]['sent_bytes_predicted']}), peak "
            f"{[round(r['peak_memory_gb'], 2) for r in rs]} GB, live inputs "
            f"{[r['live_inputs_max'] for r in rs]}, K1-K3 "
            f"{[r['launches'] for r in rs]}, host staged "
            f"{rs[0]['staged']}")
    zero = axes["zero"]
    log(f"zero (phase 21b) on {smi}: " + json.dumps({
        lv: {"step_s": [round(x, 3) for x in legs[0]["step_s"]],
             "peak_gb": [round(r["peak_memory_gb"], 2) for r in legs],
             "held": legs[0]["held"], "losses": legs[0]["losses"]}
        for lv, legs in zero.items()}))
    log(f"expert parallel (phase 21c) on {smi}: " + json.dumps({
        k: [r[k] for r in axes["moe"]["ep2"]]
        for k in ("losses", "aux_losses", "aux_rel_gaps", "step_s",
                  "a2a_bytes_per_step", "peak_memory_gb", "launches")})
        + f"; ep 1 {json.dumps(axes['moe']['ep1'])}")
    elastic = timed("19 elastic training", phase_elastic, dev)
    supervised = timed("20 supervised serving", phase_supervisor, dev)
    for name, row in flash.items():
        if name in FLASH_KERNELS:
            row["launches_by_path"].update({
                f"elastic trainer rank {r} (phase 19, data parallel, 11 "
                f"steps)": n[name]
                for r, n in elastic["uninterrupted"]["launches"].items()})
    for row in paged:
        if row["name"] == "paged_attention":
            row["launches_by_path"]["supervised serving (phase 20, both "
                                    "replicas, with the kill)"] = \
                supervised["k4_window"]
    log(f"elastic training on {smi}: " + json.dumps(
        {k: elastic[k] for k in ("restart", "shrink", "preempt", "hang")}))
    log(f"supervised serving on {smi}: " + json.dumps(supervised))
    left = stop_children()
    if left:
        raise AssertionError(f"processes still running at the end: {left}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    PHASE_SECONDS["total"] = round(time.perf_counter() - t_start, 3)
    print(json.dumps({"phases": PHASE_SECONDS}))
    print(json.dumps({"kernels": [*paged, *flash.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:  # a failed phase leaves nothing running either
        stop_children()
    sys.exit(rc)
