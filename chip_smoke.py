#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py [--before DIR]

Phases (each one fails the run; nothing falls back to the CPU):
  1. print the card's name and power limit; turn TF32 off;
  2. build the Hopper kernels from src/repro_torch/kernels/csrc (timed);
  3. hold the block-sparse attention kernel against its plain PyTorch
     version on the card: a sweep over fp32/bf16, causal / non-causal /
     causal + sliding window, G in {1, 4, 7}, empty rows, clamped padded
     tables and global offsets; then the bf16 (tensor-core) kernel at every
     head dim and block it takes, with column ids outside the K range mixed
     into the tables; then the serving path's own shape in fp32 and in bf16
     (each bf16 element of o within 2 bf16 ulps of itself);
     then the dQ and dK/dV kernels likewise, with empty columns, the plan's
     and the fallback transposed tables; then the bf16 (tensor-core) dQ and
     dK/dV at every head dim and block they take, with row and column ids
     outside the range mixed into the tables; and the serving path's shape;
  4. serve qwen2-7b at full width and depth in bf16 with random weights
     from a seed: ServeEngine(slots=4, max_len=2048) over a SPION plan of
     random causal block masks, six requests of 16 new tokens; the kernel's
     launch count must rise by 28 (one per layer) for every fused prefill;
     then one 1024-token prompt prefilled through a fully covering plan
     (the kernel) and densely must give the same logits in fp32, and in
     bf16 the kernel's prefill must be no farther from the fp32 logits
     than the dense bf16 prefill is;
  4a. serve a shared prompt prefix with the same qwen2-7b and plan, prefix
     sharing on at the engine's defaults: a 1024-token system prompt (8
     pages) first, then four requests whose suffixes (two short, two long)
     are prefilled fused with those pages shared and left alone, a repeat
     (a full hit: cached first token, forked tail page) and an unrelated
     prompt; every request's tokens equal those of an engine with
     share_prefix=False and its time to first token is at most
     TTFT_SLACK x that engine's + TTFT_FLOOR_S; fewer pages are used, 28
     launches a fused prefill and none for a cached admission; then the
     two short suffixes prefilled stepwise through the shared pages
     (stepwise_suffix_max=STEPWISE_MAX, no launch): their first-token
     logits within TOL_STEPWISE of the unshared fused prefill's, and the
     same path at 2 layers in fp32, the stepwise prefill's last logits and
     15 decode steps', within TOL_STEPWISE32 of a fused prefill of the
     same sequence; then qwen2-7b's parameters are freed;
  4b. serve mixtral-8x7b at full width, 8 of its 32 layers, bf16, through
     the paged sliding-window ring (max_len 4096 = the window) over a
     random causal plan of 5120 positions: one 4090-token prompt that
     wraps the ring during decode and four of 4097-4992 that wrap it at
     prefill; 16 tokens each, finite logits, 8 launches a fused prefill,
     the tokens of a contiguous ring engine; the forward kernel against its
     plain version and timed at this path's shape (G 4, hd 128, window
     4096); then at 2 layers in fp32 with a dropless MoE, every decode
     step's logits, across the wrap and after a ring insert, within
     TOL_RING of a fused prefill of the same sequence;
  4c. zamba2-1.2b at full width and depth (38 Mamba2 layers, one shared
     attention block applied 6 times, 32 heads of 64), bf16, a random
     causal plan of one block mask per application (block 128, 2048
     positions): a sparse forward of 2 x 2048 tokens launches the forward
     kernel 6 times; a sparse train step (make_loss_and_grads, remat of
     the Mamba part only) 6 forward, 6 dQ and 6 dK/dV kernels, loss and
     gradients finite; a covering plan against dense (fp32 logits within
     TOL_LOGITS; bf16 logits and the shared block's bf16 gradients at most
     BF16_LOGITS_SLACK x the dense path's distance from fp32; the gate
     rejects an attention of coarser q, k or gradients, COVERING_CONTROLS);
     the three
     kernels against their plain versions and timed at this shape (N 64,
     G 1, hd 64, block 128, causal); ServeEngine(slots=4, max_len=2048,
     spion=plan), paged by the registry with 6 pool layers and page 128:
     four prompts of RECURRENT_PROMPTS tokens prefilled stepwise (no
     launch), 16 tokens each, equal to a paged=False engine's; a dense
     engine's logits finite; then at 6 layers in fp32 every teacher-forced
     decode step of 256 tokens within TOL_RECURRENT of the chunked sparse
     forward;
  4d. rwkv6-7b at full width and depth (32 layers, d_model 4096, 64 heads
     of 64), bf16: ServeEngine(spion=), ServeEngine(paged=True) and
     make_serve_step(spion=True) raise NotImplementedError before any
     byte is allocated; the default (contiguous) engine serves four
     prompts stepwise, 16 tokens each, finite, no launch; then
     examples/long_context_decode_torch.py's loop on these parameters (B 1,
     init_cache(1, max_len=1), 20 tokens at each of the positions 1,000,
     100,000 and 524,288): the state's bytes and ms a token printed, the
     logits at 1,000 and 524,288 from one state bitwise equal; at 2 layers
     in fp32 decode against the chunked forward within TOL_RECURRENT; the
     parameters are freed;
  4e. whisper-tiny at full width and depth (4 encoder + 4 decoder layers,
     d_model 384, 6 heads of 64), bf16, a random causal plan per decoder
     layer (block 64, 448 positions): a sparse forward of 4 x (1500
     frames, 448 tokens) launches the forward kernel 4 times, a sparse
     train step (remat) 8 + 4 + 4; forward(capture=) -> SpionController ->
     a plan -> one train step on it; covering plan against dense
     (covering_gate on the decoder's attention leaves,
     WHISPER_QK_GRAD_SLACK for those dq and dk feed, and its controls);
     the three kernels against their plain versions and timed at N 24, G 1,
     hd 64, block 64, S 448; ServeEngine(slots=4, max_len=512, spion=plan)
     paged with page 64 serves four prompts stepwise (no launch), tokens
     equal to a paged=False engine's, cross K/V zero at max_len as the
     reference engine leaves them; at full depth in fp32, precompute_cross
     + teacher-forced decode (contiguous and paged, dense and sparse)
     within TOL_DECODE of the forward, and two planted faults (the cross
     K/V of the previous layer, the encoder's positions one off) past it;
  4f. internvl2-2b at full width and depth (24 layers, d_model 2048, 16/8
     heads of 128, 256 patch tokens), bf16, a random causal plan per layer
     (block 64, 2048 positions): a sparse forward of 2 x (256 patch
     embeddings + 1792 tokens) launches 24 forward kernels, a train step
     48 + 24 + 24, its peak memory printed; the loss equals cross-entropy
     over the text logits taken apart; the covering gate (the leaves dq
     and dk feed at INTERNVL2_QK_GRAD_SLACK); the three
     kernels at N 16, G 2, hd 128, block 64, S 2048; four text prompts
     served stepwise, paged tokens equal contiguous; at 2 layers in fp32
     teacher-forced decode within TOL_DECODE of the forward;
  4g. the forward kernel at the attention shapes of qwen2.5-14b (G 5),
     command-r-35b (G 8) and mistral-large-123b (G 12): N 8, S 2048, hd
     128, block 128, causal, against its plain version in fp32 and bf16
     and timed;
  5. train spion-lra at its published width under the LRA ListOps preset
     (batch 128 x 2048 tokens) through Trainer for 20 steps: dense steps,
     the flood-fill transition, then sparse steps that must each launch 8
     forward, 4 dQ and 4 dK/dV kernels; profile one sparse step;
  6. hold the three kernels against their plain versions at the training
     path's shape on the trained plan's tables, in fp32 and bf16;
  7. one train step through a fully covering plan against the dense step:
     equal in fp32, and in bf16 no farther from the fp32 gradients than
     1.1 x the dense step, leaf by leaf on each layer's attention leaves;
  8. time every kernel, its plain version and PyTorch's
     scaled_dot_product_attention (forward, or its backward for dQ and
     dK/dV) beside the kernel's bound; with --before DIR (another checkout,
     e.g. the parent commit unpacked by git archive), that checkout's
     kernels too (the forward at the serving, training and mixtral
     shapes, dQ and dK/dV at the training shape), in turns with these, as
     before_ms;
 8a. the kernel autotuner (cache under build/chip_smoke_autotune, which
     every exec of the run reads): at the training, qwen2-7b serving and
     mixtral shapes, the host's shared-memory formula equals the
     launchers' for every config of the grid; tune (bf16) on the tables
     each path launches with: every candidate's forward, dQ and dK/dV
     times and shared memory, and its o, lse, dq, dk and dv bitwise equal
     to the default config's (a mismatch fails the run); the configs
     config_fits refuses are printed, and one raises ValueError in the
     wrapper before any launch; a cold SparseAttentionExec finds each
     winner; a sparse train step through the tuned exec against two with
     SPION_AUTOTUNE=0 (loss and every gradient bitwise equal, but the
     token embedding's, within TOL_RESUME), 8 + 4 + 4 launches each; a
     qwen2-7b prefill of 2048 tokens through the tuned exec against the
     default config (logits, K and V bitwise equal), 28 launches each;
 8b. the dry run (launch/dryrun.py), after 8a and before the
     multi-process phases: (a) spion-lra's sparse train step at phase 5's
     shape (128 x 2048) on phase 5's trained plan, as a one-rank cell
     traced once on meta tensors (the dry run's own pass, as the CLI
     runs it; the tables real beside them), then run for real on the card
     (random weights and tokens from the seed, the same tables):
     FlopCounterMode's count of the real step equals the meta pass's
     bitwise (the three kernels through their formulas, kernels/work.py),
     and the meta pass's MemTracker peak over its
     inputs is within TOL_DRYRUN_PEAK (10%) of the real step's rise in
     torch.cuda.max_memory_allocated over the memory allocated before it:
     both count the tensors the step makes beyond its inputs (the fp32
     masters, their AdamW moments and the batch, which exist before
     either); 8 + 4 + 4 launches in the traced and in a second, plain run
     (timed); the output finite; the roofline time (989 TFLOP/s, 3.35
     TB/s) printed beside the step's ms; (b) the same for qwen2-7b's
     sparse prefill of 1024 tokens at full width, 4 of 28 layers, on a
     random causal plan (inputs: the bf16 parameters and the tokens; 4
     launches a run); (c) `python -m repro_torch.launch.dryrun` on the
     host (no card visible), one process a cell, for qwen2-7b train_4k and
     mixtral-8x7b prefill_32k sparse on the single production mesh (data
     16, model 16), started with the phase and read after 12c (at most
     DRYRUN_TIMEOUT_S from their start), so that they run beside phases
     9-12c, which time no kernel, and beside no phase that does (the
     dense cells are the CPU tests' and the host sweep's): every cell
     `ok` on 256 chips; per-rank GB, the dominant roofline term and the
     useful fraction printed as the dry run's arithmetic with the H100
     constants;
  9. resume: train spion-lra as in 5 with checkpoints under
     build/chip_smoke_ckpt (steps 7 and 14), resume a fresh Trainer from
     the sparse-phase checkpoint: step, data offset, phase, plan digest,
     masters and moments as saved; one sparse step run twice from it,
     bitwise or not (printed; chip_repro.py finds the op that is not);
     every resumed sparse step launches 8 + 4 + 4 kernels; the losses
     equal phase 5's within TOL_RESUME;
 10. rollback: NaN-poison the masters at sparse step 17 (ChaosMonkey) on a
     copy of those checkpoints: one rollback to the pinned good step 16,
     the poisoned save quarantined, the data offset advanced by the window,
     the replayed steps on the restored plan's kernels, every loss finite;
 11. respawn: FleetSupervisor (nproc 1) runs this script as the training
     worker (--train-worker DIR) from the dense checkpoint of step 7 with
     SPION_CHAOS_KILL_STEP=16: one respawn, generation 1 resumes in the
     sparse phase to bitwise the state generation 0 saved at step 14 and
     finishes, the stitched losses equal phase 5's within TOL_RESUME, the
     heartbeat payload reads back. Save, restore, respawn and rollback
     seconds are printed beside the card's name and power limit. The
     phase runs beside 12b and 12c (a thread of the parent waits for its
     worker), so its seconds are those of a card that three other
     processes share;
 12. multi-process, ranks of this script sharing the one card over gloo
     (the parent frees its cached memory first; a failure of any rank
     fails the run), in the order 12b, 12c (beside phase 11), 12a, 12d,
     ..., 12h:
     12a. four ranks (`--seq-worker DIR`) run kernels/sharded.py's
     sequence-parallel op on 2 and on 4 of them, in fp32 and bf16, at
     spion-lra's attention (128 x 4 rows, hd 16, block 64, S 2048,
     non-causal) and qwen2-7b's (KV 4, G 7, hd 128, block 128, causal, S
     8192), on dry-run plans banded to the shards' halo, in the plan form
     and the plan-less form: o, lse and dq bitwise the unsharded kernels'
     on the same card, dk and dv within grad_limit; the halo exchange's
     time, the kernels' and the op's, per rank (bf16, plan form);
     12b. spion-lra at ListOps size through phase 5's 20 steps as a
     data-parallel job of 2 ranks (`--dp-worker DIR`, 64 sequences a
     rank): 8 + 4 + 4 launches a sparse step on every rank, plan digests
     and masters equal across the ranks, the dense losses within TOL_DP
     of phase 5's; two planted faults (a rank that skips its gradient
     all-reduce: the masters split; both ranks on the same half batch:
     the losses miss TOL_DP); whether the plan equals phase 5's, step
     times and peak memory per rank;
     12c. FleetSupervisor(nproc=2) from 12b's sparse checkpoint, rank 1
     SIGKILLed: one respawn, generation 1 resumes from process 0's
     checkpoint, stitched losses within TOL_RESUME of 12b's; and, run by
     12b's ranks after their training (no spawn of its own), one SIGTERM
     on rank 1 makes both ranks save at the same step;
     12d. training over a 'seq' axis: four ranks (`--seqtrain-worker DIR`)
     on a mesh of seq 2 x data 2 train spion-lra through phase 5's 20
     steps (its configuration, data and seed; 64 sequences x 1024
     positions a rank): dense losses within TOL_DP of phase 5's, each
     capture within TOL_CAPTURE of phase 5's (a planted capture whose last
     panel reads zero rows past it), plan digests equal, the plan phase
     5's when the maps are, else this process's controller's on the ranks'
     map, 8 + 4 + 4 launches a sparse step on every rank, masters equal;
     the trained plan's branch (halo exchange or gathered fallback) and
     kernel_seq_axis' reason printed. Then internvl2-2b at full width, 2 of
     24 layers, fp32, 2 x (256 patches + 1792 tokens) on the same mesh: a
     dense and a sparse make_loss_and_grads (a plan banded to halo (8, 0),
     so the halo exchange runs) within TOL_SEQ_LOSS and TOL_SEQ_GRAD of
     one process on the card, gradients equal across the ranks, and a
     planted K/V gather whose backward skips the sum over 'seq' past the
     gate. Step, capture and gather ms and peak memory per rank.
     12e. the hybrid, ssm and encdec families over a 'seq' axis. First four
     ranks (`--carry-worker DIR`) run one layer's Mamba2 and WKV6 scans at
     zamba2-1.2b's and rwkv6-7b's widths on a 'seq' mesh of 4, so that a
     shard's state composes more than one earlier shard's: within
     TOL_SCAN_CARRY of the whole sequence's scan, and a dropped carry and
     one from the previous shard alone past the gate. Then two ranks
     (`--seqscan-worker DIR`) on a 'seq' mesh of 2. zamba2-1.2b at full
     width with 12 of 38 layers (two applications of the shared block),
     rwkv6-7b at full width with 2 of 32 layers and whisper-tiny whole,
     fp32: dense steps, and for zamba2 and whisper sparse steps on a plan
     banded to halo (1, 0) (the halo exchange), within TOL_SEQ_LOSS and
     TOL_SEQ_GRAD of one process on the global batch (rank 0), gradients
     bitwise equal across the ranks, 2 + 2 + 2 (zamba2) and 8 + 4 + 4
     (whisper) launches a sparse step a rank; planted faults past a gate:
     the scans' state carry dropped, the conv's and token shift's halo
     rows zeroed, whisper's cross-attention over the local encoder shard,
     and C2's forward that ignored the mesh (all of those, positions from 0).
     zamba2's bf16 Trainer through the transition (the capture on the
     shards within TOL_CAPTURE of one process's, one plan digest, sparse
     steps on the trained plan through whichever sharded path it takes,
     masters equal) and whisper's bf16 sparse steps on the kernels. Step
     ms (a dense step also without the gather timer's synchronizes), the
     carry's, halo rows', K/V and encoder gathers' ms, capture ms and peak
     memory per rank.
     12f. tensor, expert and vocabulary parallelism over a 'model' axis:
     four ranks (`--model-worker DIR`) on a mesh of data 2 x model 2 train
     spion-lra through phase 5's 20 steps (its configuration, data and
     seed; each rank 64 sequences, 2 of the 4 heads, half of d_ff and of
     the vocabulary): dense losses within TOL_DP of phase 5's, captures
     within TOL_CAPTURE of phase 5's (a capture averaging the rank's own
     heads alone past it), one plan digest (phase 5's when the maps are
     bitwise, else this process's controller's on the ranks' map), 8 + 4
     + 4 launches a sparse step on each rank's 2 KV heads, shards equal
     across each data line and replicated leaves across the ranks; its
     step-14 checkpoint (every sharded leaf gathered before process 0
     writes) restored in this process, whose next loss is within
     TOL_RESUME of the ranks'; the three kernels against their plain
     versions and timed at a rank's shard of the training shape (N 128).
     Then ranks 0 and 1, a model line of 2: qwen2-7b at full width, 2 of
     28 layers (14 q and 2 KV heads a rank, the vocab-parallel loss over
     152,064), and mixtral-8x7b at full width, 1 of 32 layers (4 experts
     a rank), fp32, 2 x 2048 tokens, a sparse step on a random causal
     plan within TOL_SEQ_LOSS and TOL_SEQ_GRAD of one process on the card
     (each rank runs it in turn and keeps its slice of the gradients),
     the global norm within TOL_SEQ_LOSS of one process's; planted faults
     past a gate: the gradients summed over the whole mesh, attn_out
     without its model-line sum, the vocab-parallel loss without the
     line's max and sums, the MoE's partial combine without its sum, a
     norm of the rank's shards alone. Step ms, the model line's all-reduce
     ms, capture ms and peak memory per rank; the row-parallel partial
     product at qwen2-7b's w_out shard, bf16 against fp32 operands.
     12g. the hybrid, ssm and encdec families over a 'model' axis: two
     ranks (`--modelscan-worker DIR`) on a model line of 2. zamba2-1.2b at
     full width with 6 of 38 layers (MODELSCAN_ZAMBA_LAYERS: one
     application of the shared block, cut from 12 for the script's time
     limit, where 12e and 12h run two; 16 q and 16 KV heads and 32 SSM
     heads a rank, in_proj by segment and head, the vocab-parallel loss
     over 32,000), rwkv6-7b at full width with 2 of 32 layers (32 heads
     and half of d_ff a rank, vocab-parallel over 65,536) and
     whisper-tiny whole (1500 frames, 448
     decoder tokens, 3 heads a rank, the vocabulary of 51,865 replicated),
     fp32, 2 x 2048 tokens (whisper 4 x 448): a dense step and (zamba2,
     whisper) a sparse step on a random causal plan through the three
     kernels within TOL_SEQ_LOSS and TOL_SEQ_GRAD of one process on the
     card (each rank runs it in turn and keeps its shard of the
     gradients), the replicated leaves' gradients bitwise equal across the
     line, the global norm within TOL_SEQ_LOSS of one process's, 1 + 1 +
     1 (zamba2) and 8 + 4 + 4 (whisper) launches a sparse step a rank;
     planted faults past a gate: in_proj cut contiguously, out_norm's and
     ln_x's statistic of the rank's slice alone or summed in the forward
     only, conv_w / A_log (and RWKV6's w0, u, ...) used without
     copy_to_model. zamba2's bf16 Trainer through the transition on the
     line (6 steps, saved at the end, then a seventh): captures within
     TOL_CAPTURE of one process's on the gathered masters, one plan
     digest, sparse steps on the kernels at the rank's shard, the
     replicated masters equal; its checkpoint (every sharded leaf
     gathered before process 0 writes) restored in this process, every
     rank's shards of it bitwise the rank's own, its next loss within
     TOL_RESUME of one process's on the line's gathered masters; the line
     resumed from it within TOL_RESUME of its uninterrupted seventh step,
     and a restore that cuts in_proj contiguously past it. The three
     kernels against their plain versions and timed at both shard shapes
     (zamba2 N 32, whisper N 12). Step ms, the model line's sums and the
     B‖C gather ms, capture ms and peak memory per rank.
     12h. 'seq' together with 'model', and the reference's fallback for
     head counts |model| does not divide: four ranks
     (`--seqmodel-worker DIR`). First this process computes the fp32
     legs' one-process references once (the ranks share the card) and
     writes each model index's shard of the gradients to DIR. (a) On
     (seq 2, model 2) (`make_distributed_mesh(seq=2, model=2)`: model
     lines {0, 1}, {2, 3}): spion-lra at ListOps size (2 of 4 heads and
     1024 positions a rank) through 14 of phase 5's steps: dense losses
     within TOL_DP of phase 5's, captures within TOL_CAPTURE of phase 5's,
     one plan digest (phase 5's, or the controller's on the ranks' map),
     8 + 4 + 4 launches a sparse step a rank, the shards equal across
     each 'seq' line and the replicated masters across all; zamba2-1.2b
     (12 of 38 layers, 2 x 2048) and whisper-tiny (4 x (1500 frames, 512
     tokens)) fp32 dense and sparse steps, the plan banded to halo (1, 0)
     (the halo exchange on a rank's KV-head shard). (b) On model 4 (data
     1), the fallback: whisper-tiny's 6 heads (wq's 96 columns a rank, 1.5
     heads; 4 x 448 tokens) dense and sparse (its kernels on every head on
     every rank: 8 + 4 + 4 a rank, as one process), and qwen2-7b with 2 KV
     heads at 1 of 28 layers (wk's 64 columns a rank, half a head; RoPE
     after the gather; 1 x 512) dense; and the scan fallback, reduced
     (no repo config reaches it on <= 4 ranks: every full scan width is
     a power of two): rwkv6-7b at full d_model, d_ff and vocabulary with
     6 WKV heads of 64 (w_r's 96 columns a rank, 1.5 heads) at 2 of 32
     layers (1 x 1024) dense, zamba2-1.2b at full width with state_size
     65 (2N = 130: in_proj whole, out_proj's rows split) at 6 of 38
     layers (1 x 2048) dense and sparse (its shared block on 8 of 32
     heads a rank through the kernels: 1 + 1 + 1 a rank), and zamba2's 8
     decode tokens (B 2, its SSM state over heads, each layer gathering
     it) within TOL_SEQ_LOSS of one process. Every fp32 step within
     TOL_SEQ_LOSS (loss and global norm) and TOL_SEQ_GRAD (each leaf) of
     one process, the replicated leaves' gradients bitwise equal across
     each model line and every leaf's across each 'seq' line; planted
     faults past a gate: the gradient all-reduce over the data axes
     only, the halo neighbours from the global rank order, RoPE before
     the fallback's gather, its backward without the sum or summed twice,
     the global norm summed over 'seq' as well. The three kernels against
     their plain versions and timed at the new shapes (spion-lra's as its
     trained plan runs, zamba2's and whisper's halo storage, whisper's 6
     heads whole, the fallback zamba2's 8 heads a rank). Step ms, the
     model-line sums, the 'seq' gathers, the halo exchange and the
     gradient all-reduce ms, capture ms and peak memory per rank.
     rwkv6-7b at its own 64 heads is not stepped here (PERF.md).
     12i. the explicit collectives, on 12h's four ranks after 12h's legs
     (this process computes their references while the ranks run
     spion-lra). (a) On (pod 2, data 2) (`make_mesh`), each rank's tree of spion-lra's
     leaves (seeded, scaled by rank + 1) in fp32 and in bf16 through
     compressed_grad_sync over 'data' and over ('pod', 'data') and
     hierarchical_grad_sync: q, the scales, the int32 totals, the mean
     scales and the results bitwise this process's CPU arithmetic; 0.25
     syncs to 0.5 and (hierarchically) 1.0, and scales summed instead of
     averaged (planted) miss it; each sync's ms beside
     runtime.all_reduce_sum's of the same tree. (b) On (pod 4),
     spion-lra's 4 layers as 4 stages of pipeline_apply
     (models/transformer._block on the stage's layer, a seeded non-causal
     plan at the training shape through the three kernels), batch 32 x
     2048 in 4 microbatches: fp32 output within TOL_SEQ_LOSS and dx and
     every stage's gradients within TOL_SEQ_GRAD of the layers in sequence
     in one process; bf16 no farther from that fp32 run than the bf16
     sequence, times PIPE_SLACK (mean distance); 8 forward, 4 dQ and 4
     dK/dV launches a call a stage; planted faults past a gate (the
     output's cotangent summed over the line, stage 2 sending zeros in
     place of its input's gradient); ms a call, of it the hops', and the
     peak per rank. The three kernels at a stage's microbatch shape (N 32,
     S 2048, hd 16, non-causal) on every stage's tables, against their
     plain versions in fp32 and bf16, and timed.
     12j. prefill and decode steps under a mesh, on 12h's four ranks after
     12i (its one-process references computed here beside spion-lra):
     qwen2-7b at full width reduced to 2 of 28 layers, fp32 and bf16, its
     parameters each rank's shards. (a) On (seq 2, model 2), B 2: a sparse
     prefill of a 4,096-token prompt with the cache through
     make_prefill_step(mesh=) (a causal plan banded to halo (1, 0): the
     forward kernel on each rank's KV-head shard through the halo
     exchange, 2 launches a rank), then 16 dense and 16 sparse decode
     steps through make_serve_step(mesh=). (b) On (data 2, model 2), B 1
     at 524,288 positions (the long_500k layout: the cache's positions
     over 'data', its KV heads over 'model'), filled from the seed below
     524,000: 8 dense and 8 sparse steps. (c) On model 4 with 2 KV heads
     (head_dim over 'model'), B 2, filled below 2048: 16 dense and 16
     sparse steps. fp32 prefill logits (every 64th row and the last),
     decode logits and the cache after gather_cache ((b): each data
     rank's last 512 positions) within TOL_SEQ_LOSS of one process's; bf16
     within SERVE_BF16_SLACK of one process's mean distance from fp32; the
     seeded positions bitwise. (d) On (data 2, model 2), B 2, filled
     below 2048: 8 dense and 8 sparse steps through a paged pool
     replicated on every rank (the reference's cache_pspecs: every pool
     leaf P()), against one process's paged decode with the same gates,
     every rank's pool bitwise equal (a digest), its mapped pages within
     TOL_SEQ_LOSS (fp32) of the contiguous cache decoded from the same
     start on the same mesh. The three kernels at (a)'s shard halo shape
     (serve_mesh_shape).
The line before the last is the kernels' JSON record (launches_serve,
launches_serve_shared, launches_mixtral, launches_zamba2,
launches_whisper, launches_internvl2, launches_train, launches_resume,
launches_rollback, launches_respawn, launches_dp (both ranks of 12b),
launches_fleet (both ranks of 12c's generation 1), launches_seqtrain
(12d's four ranks, training and the decoder's sparse step) and
launches_seqscan (12e's two ranks: the fp32 sparse steps, the Trainer and
whisper's bf16 steps) and launches_model (12f's four ranks' training
and the legs' sound sparse steps; not the planted faults' steps nor the
restored step in this process) and launches_modelscan (12g's two ranks:
the sound sparse steps and the Trainer's seven) and launches_seqmodel
(12h's four ranks: spion-lra's steps and the legs' sound sparse steps)
and launches_pipeline (12i's four stages: the sound fp32 and bf16 calls)
and launches_serve_mesh (12j's four ranks' sparse prefills) and
launches_dryrun (8b's real steps, traced and plain) count each
kernel's launches in phases 4, 4a, 4b, 4c, 4e, 4f (their sparse forward
and train step), 5, 8b, 9-11 and 12, each read from zero; `seq_parallel` holds phase
12a's worst differences and per-rank times; the forward's mixtral_shape
holds its check
and timing at phase 4b's shape and its qwen2_5_14b_shape,
command_r_35b_shape and mistral_large_123b_shape at phase 4g's, and every
kernel's zamba2_shape, whisper_shape and internvl2_shape its check and
timing at phases 4c, 4e and 4f, model_shard_shape at 12f's shard of
the training shape, modelscan_zamba2_shape and modelscan_whisper_shape
at 12g's shard shapes, and seqmodel_lra_shape, seqmodel_zamba2_shape,
seqmodel_whisper_shape and seqmodel_whisper6_shape at 12h's, and
pipeline_shape at 12i's stage microbatch (every stage's tables; the
errors the worst over the stages), serve_mesh_shape at 12j (a)'s shard
halo storage; `tuned` holds each kernel's phase 8a winner and its time beside the default's at
each shape); the last line is
{"ok": true, "device": {...}}.
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
DEVICE = "cuda"
TOL_O = {"float32": 3e-5, "bfloat16": 6e-2}
BF16_ULPS = 2     # bf16 o: each element within 2 units in its last place
TOL_LSE = 1e-4
TOL_LOGITS = 6e-2
# bf16 prefill through the kernel vs through dense attention, each against
# the fp32 dense logits: the kernel's max and mean distance may exceed the
# dense path's by 10% (on the card they read 0.986 and 0.964 of it)
BF16_LOGITS_SLACK = 1.1
PATH = dict(N=4, G=7, S=2048, hd=128, block=128)   # qwen2-7b prefill, B=1
# spion-lra under the LRA ListOps preset: N = B * KV = 128 * 4
TRAIN_PATH = dict(N=512, G=1, S=2048, hd=16, block=64)
# dq, dk, dv (fp32 outputs) against their plain versions: fp32 inputs
# within TOL_GRAD and at most GRAD_SHARE of the mean |grad|; bf16 inputs
# within BF16_ULPS bf16 ulps of the element plus BF16_GRAD_FLOOR
TOL_GRAD = 1e-3
GRAD_SHARE = 0.01
BF16_GRAD_FLOOR = 2e-6   # over 3x the most an element needed on the card
TOL_PLAN = 1e-6     # dK/dV through the plan's tables vs bcsr_transpose's
SOURCES = "src/repro_torch/kernels/csrc/"
REPLACES = "src/repro/kernels/block_sparse_attn.py:"
KERNELS = {         # wrapper: (source, the TPU kernel it replaces)
    "block_sparse_fwd": (SOURCES + "block_sparse_fwd_sm90.cuh",
                         REPLACES + "138"),
    "block_sparse_dq": (SOURCES + "block_sparse_dq_sm90.cuh",
                        REPLACES + "281"),
    "block_sparse_dkv": (SOURCES + "block_sparse_dkv_sm90.cuh",
                         REPLACES + "377"),
}


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of fn() over `iters` runs, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_tables(rng, nrb, ncb, *, causal, empty_rows=(), empty_cols=(),
                  pad=2, diag_offset=0):
    """Seeded block mask (diagonal set) as clamped, padded BCSR tables."""
    import numpy as np
    mask = rng.random((nrb, ncb)) < 0.5
    mask[np.arange(nrb), np.arange(nrb) + diag_offset] = True
    if causal:
        mask &= np.arange(ncb)[None, :] <= np.arange(nrb)[:, None] + \
            diag_offset
    for r in empty_rows:
        mask[r] = False
    for c in empty_cols:
        mask[:, c] = False
    K = int(mask.sum(1).max()) + pad
    col = np.zeros((nrb, K), np.int32)
    nvalid = mask.sum(1).astype(np.int32)
    for r in range(nrb):
        idx = np.nonzero(mask[r])[0]
        col[r, :len(idx)] = idx
        col[r, len(idx):] = idx[-1] if len(idx) else 0
    return col, nvalid


def with_bad_ids(rng, col, nvalid, ncb):
    """Kernel tables listing the same tiles as (col, nvalid), with column
    ids outside [0, ncb) mixed in among the listed entries (the kernel
    skips them) and in the padding past nvalid (never read); the plain
    version takes (col, nvalid) itself."""
    import numpy as np
    rows = []
    for r in range(len(nvalid)):
        ids = [int(c) for c in col[r, :nvalid[r]]]
        for bad in (-3, ncb, ncb + 5):
            if rng.random() < 0.5:
                ids.insert(int(rng.integers(0, len(ids) + 1)), bad)
        rows.append(ids)
    width = max(len(ids) for ids in rows) + 2
    out = np.where(rng.random((len(rows), width)) < 0.5, -1,
                   ncb + 9).astype(np.int32)
    for r, ids in enumerate(rows):
        out[r, :len(ids)] = ids
    return out, np.array([len(ids) for ids in rows], np.int32)


def o_limit(dtype, o, ref):
    """Limit on |o - plain|, element by element. Kernel and plain version
    both compute in fp32 and round once to o's dtype, so in bf16 an element
    may differ by one rounding step of its own magnitude: the limit is
    BF16_ULPS bf16 ulps of it, plus 1e-6 for fp32 summation order (capped at
    TOL_O). Long causal rows average many values to a typical |o| near
    0.05, while the first rows keep |o| near 3; a limit taken from the
    largest |o| would be as large as the typical value."""
    if dtype == "float32":
        return TOL_O[dtype]
    import torch
    top = torch.maximum(o.float().abs(), ref.float().abs())
    _, e = torch.frexp(top)                   # top = m * 2**e, m in [0.5, 1)
    ulp = torch.where(top > 0, torch.ldexp(torch.ones_like(top), e - 8), 0.0)
    return (BF16_ULPS * ulp + 1e-6).clamp(max=TOL_O[dtype])


def compare_kernel(case, gen, rng, tables=None):
    """Kernel vs plain version on one case; returns (max |do|, the limit of
    that element, the largest |do| / limit, mean |plain o|, max |dlse|,
    inputs). `tables` = (col_idx, nvalid) numpy replaces the random ones."""
    import torch
    from repro_torch.kernels.block_sparse_attn import (
        block_sparse_fwd, fused_forward_reference)
    dt = getattr(torch, case["dtype"])
    N, G, S, hd, block = (case[k] for k in ("N", "G", "S", "hd", "block"))
    offsets = case.get("offsets")
    extra = 0 if offsets is None else block
    nrb = S // block
    col, nvalid = tables if tables is not None else random_tables(
        rng, nrb, (S + extra) // block, causal=case["causal"],
        empty_rows=case.get("empty_rows", ()), pad=case.get("pad", 2),
        diag_offset=extra // block)
    dev = DEVICE
    q = torch.randn((N, G, S, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((N, S + extra, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((N, S + extra, hd), generator=gen, device=dev).to(dt)
    colt = torch.as_tensor(col, device=dev)
    nvt = torch.as_tensor(nvalid, device=dev)
    kcol, knvt = colt, nvt
    if case.get("bad_ids"):
        bad_col, bad_nv = with_bad_ids(rng, col, nvalid, (S + extra) // block)
        kcol = torch.as_tensor(bad_col, device=dev)
        knvt = torch.as_tensor(bad_nv, device=dev)
    kw = dict(block=block, causal=case["causal"],
              sliding_window=case.get("sw"), offsets=offsets,
              seq_len=None if offsets is None else 2 * (S + extra))
    o, lse = block_sparse_fwd(q, k, v, kcol, knvt, **kw)
    torch.cuda.synchronize()
    ro, rlse = fused_forward_reference(q, k, v, colt, nvt, **kw)
    diff = (o.float() - ro.float()).abs()
    limit = o_limit(case["dtype"], o, ro)
    share = (diff / limit).max().item()       # 1 is the limit
    err = diff.max().item()
    tol = limit if isinstance(limit, float) else \
        limit.flatten()[diff.argmax()].item()
    typical = ro.float().abs().mean().item()
    check(math.isfinite(share) and share <= 1.0,
          f"kernel o differs by up to {err} (up to {share:.3g} of the "
          f"limit; mean |o| {typical}) on {case}")
    inf, rinf = torch.isinf(lse), torch.isinf(rlse)
    check(torch.equal(inf, rinf), f"lse +inf pattern differs on {case}")
    lerr = (lse[~inf] - rlse[~rinf]).abs().max().item() if (~inf).any() \
        else 0.0
    check(lerr <= TOL_LSE, f"kernel lse differs by {lerr} on {case}")
    return err, tol, share, typical, lerr, (q, k, v, colt, nvt, kw)


def phase_kernel_sweep(gen, rng):
    sweep = []
    shapes = [(16, 16), (32, 32), (64, 64), (128, 128), (64, 32), (128, 64)]
    i = 0
    for dtype in ("float32", "bfloat16"):
        for causal, sw in ((True, None), (False, None), (True, 48)):
            for G in (1, 4, 7):
                hd, block = shapes[i % len(shapes)]
                i += 1
                sweep.append(dict(dtype=dtype, causal=causal, sw=sw, G=G,
                                  N=2, S=256, hd=hd, block=block,
                                  empty_rows=(1,)))
    sweep.append(dict(dtype="float32", causal=True, G=4, N=2, S=256, hd=64,
                      block=32, offsets=(3, 2), empty_rows=(0,)))
    sweep.append(dict(dtype="bfloat16", causal=False, G=7, N=2, S=256,
                      hd=128, block=64, offsets=(2, 1), pad=4))
    worst = {"float32": 0.0, "bfloat16": 0.0}
    most = 0.0         # the largest |do| / limit of a bf16 element
    for case in sweep:
        err, _, share, _, _, _ = compare_kernel(case, gen, rng)
        worst[case["dtype"]] = max(worst[case["dtype"]], err)
        if case["dtype"] == "bfloat16":
            most = max(most, share)
    log(f"kernel sweep: {len(sweep)} cases pass; worst |o - plain| "
        f"fp32 {worst['float32']:.3e} (tol {TOL_O['float32']}), bf16 "
        f"{worst['bfloat16']:.3e} (no bf16 element past {most:.3f} of its "
        f"limit of {BF16_ULPS} bf16 ulps of itself)")
    phase_bf16_shapes()
    # the path's shape in fp32 (the same kernel template, held at 3e-5),
    # then in bf16 as the serving prefill runs it
    for dtype in ("float32", "bfloat16"):
        path = dict(dtype=dtype, causal=True, pad=0, **PATH)
        err, tol, share, typical, _, inputs = compare_kernel(path, gen,
                                                             rng)
        log(f"kernel at the path's shape {PATH} {dtype} causal: "
            f"|o - plain| = {err:.3e} (that element's limit {tol:.3e}; "
            f"no element past {share:.3f} of its limit; mean |o| "
            f"{typical:.3e})")
    return err, tol, inputs


def bf16_shape_cases():
    """Every head dim and block the bf16 (tensor-core) forward takes, each
    pair once, cycling through causal / non-causal / sliding window 48, G 1,
    4 and 7, global offsets and out-of-range column ids, then K/V of fewer
    rows (N x Sk = 32) than one key tile reads; every case has an empty row
    and clamped padding."""
    from repro_torch.kernels.block_sparse_attn import _HEAD_DIMS
    cases = []
    modes = ((True, None), (False, None), (True, 48))
    for i, (hd, block) in enumerate(
            (hd, block) for hd in _HEAD_DIMS
            for block in (16, 32, 64, 80, 96, 128)):
        causal, sw = modes[i % 3]
        cases.append(dict(dtype="bfloat16", causal=causal, sw=sw,
                          G=(1, 4, 7)[(i // 3) % 3], N=2,
                          S=480 if block in (80, 96) else 256, hd=hd,
                          block=block, empty_rows=(1,), bad_ids=i % 2 == 0,
                          offsets=(2, 1) if i % 4 == 1 else None))
    cases.append(dict(dtype="bfloat16", causal=True, sw=None, G=4, N=1, S=32,
                      hd=16, block=16, empty_rows=(1,), bad_ids=False,
                      offsets=None))
    return cases


def phase_bf16_shapes():
    """The cases of bf16_shape_cases, from random streams of their own (the
    later phases draw what they drew before these cases existed)."""
    import numpy as np
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    rng = np.random.default_rng(SEED + 1)
    cases = bf16_shape_cases()
    most, worst = 0.0, 0.0
    for case in cases:
        err, _, share, _, _, _ = compare_kernel(case, gen, rng)
        most, worst = max(most, share), max(worst, err)
    log(f"bf16 kernel at every head dim x block: {len(cases)} cases pass "
        f"(causal, non-causal, window 48; G 1/4/7; offsets; out-of-range "
        f"column ids; empty rows); worst |o - plain| {worst:.3e}, no element "
        f"past {most:.3f} of its limit of {BF16_ULPS} bf16 ulps of itself")


# -- the backward kernels ----------------------------------------------------

def grad_limit(dtype, got, ref):
    """Limit on |grad - plain|, element by element. Kernel and plain version
    both compute in fp32 from the same inputs and return fp32, so they
    differ by summation order only. fp32 inputs: TOL_GRAD, or GRAD_SHARE of
    the mean |plain grad| where that is smaller. bf16 inputs: BF16_ULPS
    bf16 ulps of the element plus BF16_GRAD_FLOOR, a floor for elements
    that cancel to near zero (set from the readings, PERF.md)."""
    import torch
    if dtype == "float32":
        return min(TOL_GRAD, GRAD_SHARE * ref.abs().mean().item())
    top = torch.maximum(got.abs(), ref.abs())
    _, e = torch.frexp(top)
    ulp = torch.where(top > 0, torch.ldexp(torch.ones_like(top), e - 8), 0.0)
    return BF16_ULPS * ulp + BF16_GRAD_FLOOR


def hold_grad(name, dtype, got, ref, case):
    """Check one gradient against its plain version; returns (max |diff|,
    the largest |diff| / limit, mean |plain|, the floor this element
    needed: |diff| less its ulp part, bf16 only)."""
    import torch
    diff = (got - ref).abs()
    limit = grad_limit(dtype, got, ref)
    share = (diff / limit).max().item() if diff.numel() else 0.0
    err = diff.max().item() if diff.numel() else 0.0
    typical = ref.abs().mean().item()
    need = 0.0
    if dtype != "float32":
        need = (diff - (limit - BF16_GRAD_FLOOR)).max().clamp(min=0).item()
    check(math.isfinite(share) and share <= 1.0 and
          torch.isfinite(got).all().item(),
          f"kernel {name} differs from its plain version by up to {err} "
          f"({share:.3g} of the limit; mean |{name}| {typical}) on {case}")
    return err, share, typical, need


def backward_inputs(case, gen, rng, tables=None):
    """q, k, v, dO; the forward kernel's o and lse; delta = rowsum(dO * O)
    in fp32 (as the op's backward computes it); the forward tables and both
    transposed tables: the plan's (width KT*) and bcsr_transpose's (width
    nrb). `tables` = (col_idx, nvalid) numpy replaces the random ones."""
    import torch
    from repro_torch.core.sparse_attention import (bcsr_transpose,
                                                   host_transpose_tables)
    from repro_torch.kernels.block_sparse_attn import block_sparse_fwd
    dt = getattr(torch, case["dtype"])
    N, G, S, hd, block = (case[k] for k in ("N", "G", "S", "hd", "block"))
    offsets = case.get("offsets")
    extra = 0 if offsets is None else block
    nrb, ncb = S // block, (S + extra) // block
    if tables is None:
        tables = random_tables(
            rng, nrb, ncb, causal=case["causal"],
            empty_rows=case.get("empty_rows", ()),
            empty_cols=case.get("empty_cols", ()), pad=case.get("pad", 2),
            diag_offset=extra // block)
    col, nvalid = tables
    row_idx, nvalid_t, kt = host_transpose_tables(col, nvalid, ncb=ncb)
    dev = DEVICE
    colt = torch.as_tensor(col, device=dev)
    nvt = torch.as_tensor(nvalid, device=dev)
    fb_row, fb_nvt = bcsr_transpose(colt, nvt, ncb=ncb)
    q = torch.randn((N, G, S, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((N, S + extra, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((N, S + extra, hd), generator=gen, device=dev).to(dt)
    do = torch.randn((N, G, S, hd), generator=gen, device=dev).to(dt)
    fkw = dict(block=block, causal=case["causal"],
               sliding_window=case.get("sw"), offsets=offsets,
               seq_len=None if offsets is None else 2 * (S + extra))
    o, lse = block_sparse_fwd(q, k, v, colt, nvt, **fkw)
    delta = (do.float() * o.float()).sum(dim=-1)
    kw = dict(fkw)
    kw.pop("seq_len")
    return dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta, col=colt,
                nvalid=nvt, row=torch.as_tensor(row_idx, device=dev),
                nvalid_t=torch.as_tensor(nvalid_t, device=dev), kt=kt,
                fb_row=fb_row, fb_nvalid_t=fb_nvt, kw=kw)


def compare_backward(case, gen, rng, tables=None):
    """dQ and dK/dV kernels against their plain versions on one case, with
    the plan's transposed tables (or bcsr_transpose's when case["tables"]
    is "fallback"), and out-of-range ids mixed into the kernels' tables
    when case["bad_ids"]; with the plan's, dK/dV through the fallback
    tables too, held to TOL_PLAN. Returns {grad: (err, share, mean |plain|, floor
    needed)} and the inputs."""
    import torch
    from repro_torch.kernels.block_sparse_attn import (
        block_sparse_dkv, block_sparse_dq, fused_dkv_reference,
        fused_dq_reference)
    x = backward_inputs(case, gen, rng, tables)
    args = (x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"])
    plan = case.get("tables", "plan") == "plan"
    row, nvt = (x["row"], x["nvalid_t"]) if plan else \
        (x["fb_row"], x["fb_nvalid_t"])
    check(not plan or row.shape[1] == x["kt"], "plan table width is not KT*")
    kcol, knv, krow, knvt = x["col"], x["nvalid"], row, nvt
    if case.get("bad_ids"):
        # the kernels' tables list the same in-range tiles with ids outside
        # the range mixed in; the plain versions take the clean ones
        nrb, ncb = x["q"].shape[2] // case["block"], \
            x["k"].shape[1] // case["block"]
        kcol, knv, krow, knvt = (
            torch.as_tensor(t, device=DEVICE) for t in
            with_bad_ids(rng, kcol.cpu().numpy(), knv.cpu().numpy(), ncb)
            + with_bad_ids(rng, krow.cpu().numpy(), knvt.cpu().numpy(),
                           nrb))
    dq = block_sparse_dq(*args, kcol, knv, **x["kw"])
    dk, dv = block_sparse_dkv(*args, krow, knvt, **x["kw"])
    torch.cuda.synchronize()
    rdq = fused_dq_reference(*args, x["col"], x["nvalid"], **x["kw"])
    rdk, rdv = fused_dkv_reference(*args, row, nvt, **x["kw"])
    out = {}
    for name, got, ref in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        check(got.dtype == torch.float32 and got.shape == ref.shape,
              f"{name} is {got.dtype} {tuple(got.shape)}")
        out[name] = hold_grad(name, case["dtype"], got, ref, case)
    block = case["block"]
    for r in case.get("empty_rows", ()):
        check(not dq[:, :, r * block:(r + 1) * block].any().item(),
              f"dq of the empty row block {r} is not 0 on {case}")
    for c in case.get("empty_cols", ()):
        check(not dk[:, c * block:(c + 1) * block].any().item() and
              not dv[:, c * block:(c + 1) * block].any().item(),
              f"dk/dv of the empty column block {c} are not 0 on {case}")
    if plan:
        fdk, fdv = block_sparse_dkv(*args, x["fb_row"], x["fb_nvalid_t"],
                                    **x["kw"])
        gap = max((fdk - dk).abs().max().item(),
                  (fdv - dv).abs().max().item())
        check(gap <= TOL_PLAN, f"dK/dV through the plan tables differ from "
              f"the fallback tables by {gap} on {case}")
        out["plan_vs_fallback"] = gap
    return out, x


def phase_backward_sweep(gen, rng):
    """The dQ and dK/dV kernels against their plain versions: a sweep like
    the forward's, then the serving path's shape (the training path's shape
    is held after training, with the trained plan's tables)."""
    shapes = [(16, 16), (32, 32), (64, 64), (128, 128), (64, 32), (128, 64),
              (16, 128), (80, 16)]
    sweep, i = [], 0
    for dtype in ("float32", "bfloat16"):
        for causal, sw in ((True, None), (False, None), (True, 48)):
            for G in (1, 4, 7):
                hd, block = shapes[i % len(shapes)]
                i += 1
                sweep.append(dict(dtype=dtype, causal=causal, sw=sw, G=G,
                                  N=2, S=256, hd=hd, block=block,
                                  empty_rows=(1,), empty_cols=(1,),
                                  tables="plan" if i % 2 else "fallback"))
    sweep.append(dict(dtype="float32", causal=True, G=4, N=2, S=256, hd=64,
                      block=32, offsets=(3, 2), empty_rows=(0,)))
    sweep.append(dict(dtype="bfloat16", causal=False, G=7, N=2, S=256,
                      hd=128, block=64, offsets=(2, 1), pad=4,
                      tables="fallback"))
    sweep.append(dict(dtype="float32", causal=False, G=1, N=3, S=512, hd=96,
                      block=128, empty_cols=(1,)))
    # blocks above 64 that are not 128: the backward programs take half a
    # block each
    sweep.append(dict(dtype="float32", causal=True, G=2, N=2, S=480, hd=48,
                      block=96, empty_rows=(2,)))
    sweep.append(dict(dtype="bfloat16", causal=False, G=3, N=2, S=400,
                      hd=112, block=80, empty_cols=(0,), tables="fallback"))
    worst = {"float32": 0.0, "bfloat16": 0.0}
    share_most = {"float32": 0.0, "bfloat16": 0.0}
    need, gap, lowest_mean = 0.0, 0.0, math.inf
    for case in sweep:
        res, _ = compare_backward(case, gen, rng)
        gap = max(gap, res.pop("plan_vs_fallback", 0.0))
        for err, share, typical, floor in res.values():
            worst[case["dtype"]] = max(worst[case["dtype"]], err)
            share_most[case["dtype"]] = max(share_most[case["dtype"]], share)
            need = max(need, floor)
            if case["dtype"] == "float32":
                lowest_mean = min(lowest_mean, typical)
    log(f"backward sweep: {len(sweep)} cases pass (dq, dk, dv; plan and "
        f"fallback tables; empty rows and columns; offsets); worst |grad - "
        f"plain| fp32 {worst['float32']:.3e} (limit min({TOL_GRAD}, "
        f"{GRAD_SHARE} x mean |grad|), smallest mean |grad| "
        f"{lowest_mean:.3e}; no element past {share_most['float32']:.3g} of "
        f"its limit), bf16 {worst['bfloat16']:.3e} (no element past "
        f"{share_most['bfloat16']:.3g} of its limit of {BF16_ULPS} bf16 ulps "
        f"+ {BF16_GRAD_FLOOR}; the largest floor needed {need:.3e}); plan "
        f"vs fallback dK/dV {gap:.3e} (tol {TOL_PLAN})")
    phase_bf16_backward_shapes()
    for dtype in ("float32", "bfloat16"):
        res, _ = compare_backward(dict(dtype=dtype, causal=True, pad=0,
                                       **PATH), gen, rng)
        log_backward_path("serving", PATH, dtype, res)


def bf16_backward_shape_cases():
    """Every head dim and block the bf16 (tensor-core) dQ and dK/dV kernels
    take, each pair once, cycling through causal / non-causal / sliding
    window 48, G 1, 4 and 7, global offsets, out-of-range row and column
    ids, and the plan's and the fallback transposed tables; then Q/dO and
    K/V of fewer rows (N G S = N Sk = 32) than one 64-row box reads. Every
    case has an empty row block and an empty column block."""
    from repro_torch.kernels.block_sparse_attn import _HEAD_DIMS
    cases = []
    modes = ((True, None), (False, None), (True, 48))
    for i, (hd, block) in enumerate(
            (hd, block) for hd in _HEAD_DIMS
            for block in (16, 32, 64, 80, 96, 128)):
        causal, sw = modes[i % 3]
        cases.append(dict(dtype="bfloat16", causal=causal, sw=sw,
                          G=(1, 4, 7)[(i // 3) % 3], N=2,
                          S=480 if block in (80, 96) else 256, hd=hd,
                          block=block, empty_rows=(1,), empty_cols=(0,),
                          bad_ids=i % 2 == 0,
                          offsets=(2, 1) if i % 4 == 1 else None,
                          tables="fallback" if i % 5 == 2 else "plan"))
    cases.append(dict(dtype="bfloat16", causal=True, sw=None, G=1, N=1, S=32,
                      hd=16, block=16, empty_rows=(1,), empty_cols=(1,),
                      bad_ids=True, offsets=None, tables="plan"))
    return cases


def phase_bf16_backward_shapes():
    """The cases of bf16_backward_shape_cases, from random streams of their
    own, each held by compare_backward at grad_limit and TOL_PLAN."""
    import numpy as np
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    rng = np.random.default_rng(SEED + 2)
    cases = bf16_backward_shape_cases()
    most, worst, need, gap = 0.0, 0.0, 0.0, 0.0
    for case in cases:
        res, _ = compare_backward(case, gen, rng)
        gap = max(gap, res.pop("plan_vs_fallback", 0.0))
        for err, share, _, floor in res.values():
            most, worst = max(most, share), max(worst, err)
            need = max(need, floor)
    log(f"bf16 backward at every head dim x block: {len(cases)} cases pass "
        f"(causal, non-causal, window 48; G 1/4/7; offsets; out-of-range row "
        f"and column ids; empty rows and columns; plan and fallback tables); "
        f"worst |grad - plain| {worst:.3e}, no element past {most:.3f} of "
        f"its limit of {BF16_ULPS} bf16 ulps + {BF16_GRAD_FLOOR} (the "
        f"largest floor needed {need:.3e}); plan vs fallback dK/dV {gap:.3e} "
        f"(tol {TOL_PLAN})")


def log_backward_path(label, shape, dtype, res):
    gap = res.pop("plan_vs_fallback", None)
    parts = [f"{name} |diff| {err:.3e} ({share:.3g} of its limit; mean "
             f"|{name}| {typical:.3e}"
             + (f"; floor needed {need:.3e})" if dtype != "float32" else ")")
             for name, (err, share, typical, need) in res.items()]
    log(f"backward at the {label} path's shape {shape} {dtype}: "
        + "; ".join(parts)
        + ("" if gap is None else f"; plan vs fallback {gap:.3e}"))


def bwd_bytes_flops(x):
    """(dq flops, dq bytes, dkv flops, dkv bytes) that these inputs need
    (kernels/work.py: the count the dry run's FLOPs use too)."""
    from repro_torch.kernels.work import dkv_work, dq_work
    kw = {k: x["kw"].get(k) for k in ("causal", "sliding_window",
                                      "offsets")}
    dq_f, dq_b = dq_work(x["q"], x["k"], x["col"], x["nvalid"],
                         block=x["kw"]["block"], **kw)
    dkv_f, dkv_b = dkv_work(x["q"], x["k"], x["row"], x["nvalid_t"],
                            block=x["kw"]["block"], **kw)
    return dq_f, dq_b, dkv_f, dkv_b


def bound(flops, nbytes):
    """(ms, "operations" or "bytes") of the card's least time for `flops`
    bf16 operations and `nbytes` bytes (launch/mesh.py's H100 SXM5
    data-sheet rates)."""
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    t_ops, t_bytes = flops / PEAK_FLOPS_BF16, nbytes / HBM_BW
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def parent_kernels(path):
    """The kernel module of another checkout of this repository at `path`
    (its src/repro_torch/kernels/block_sparse_attn.py, which builds that
    checkout's csrc into that checkout's build/), so that its backward
    kernels are timed beside these on the same inputs."""
    import importlib.util
    src = os.path.join(os.path.abspath(path), "src", "repro_torch",
                       "kernels", "block_sparse_attn.py")
    check(os.path.exists(src), f"--before {path}: no {src}")
    spec = importlib.util.spec_from_file_location("before_block_sparse_attn",
                                                  src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def backward_timing(x, before=None):
    """ms of the dQ and dK/dV kernels and their plain versions on the
    inputs `x`, their bounds, and the autograd backward of PyTorch's dense
    scaled_dot_product_attention at the same shape (dq, dk and dv
    together, over every row) as the library yardstick; with `before` (a
    parent_kernels module), that tree's kernels too, timed in turns with
    these (before, these, these, before), as before_ms."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.block_sparse_attn import (
        block_sparse_dkv, block_sparse_dq, fused_dkv_reference,
        fused_dq_reference)
    args = (x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"])
    kw = x["kw"]
    calls = {"block_sparse_dq": args + (x["col"], x["nvalid"]),
             "block_sparse_dkv": args + (x["row"], x["nvalid_t"])}
    plain = {"block_sparse_dq": fused_dq_reference,
             "block_sparse_dkv": fused_dkv_reference}
    wrapper = {"block_sparse_dq": block_sparse_dq,
               "block_sparse_dkv": block_sparse_dkv}
    out = {}
    for name, a in calls.items():
        def now():
            return wrapper[name](*a, **kw)
        if before is None:
            out[name] = dict(ms=cuda_ms(now, 20))
        else:
            def old():
                return getattr(before, name)(*a, **kw)
            b1 = cuda_ms(old, 20)
            m1, m2 = cuda_ms(now, 20), cuda_ms(now, 20)
            b2 = cuda_ms(old, 20)
            out[name] = dict(ms=(m1 + m2) / 2, before_ms=(b1 + b2) / 2,
                             runs=(b1, m1, m2, b2))
        out[name]["plain_ms"] = cuda_ms(lambda: plain[name](*a, **kw), 3)
        # the same launch with nothing listed: what a program costs
        # before and after its tiles (the order, the stores of 0)
        empty = a[:-1] + (torch.zeros_like(a[-1]),)
        out[name]["empty_ms"] = cuda_ms(lambda: wrapper[name](*empty, **kw),
                                        20)
    q, k, v = (x[n].detach().requires_grad_() for n in "qkv")
    N, G, S, hd = q.shape
    kx = k[:, None].expand(N, G, k.shape[1], hd)
    vx = v[:, None].expand(N, G, k.shape[1], hd)
    o = F.scaled_dot_product_attention(q, kx, vx, is_causal=kw["causal"])
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        o, (q, k, v), x["do"], retain_graph=True), 10)
    dq_f, dq_b, dkv_f, dkv_b = bwd_bytes_flops(x)
    for name, flops, nbytes in (("block_sparse_dq", dq_f, dq_b),
                                ("block_sparse_dkv", dkv_f, dkv_b)):
        b_ms, by = bound(flops, nbytes)
        out[name].update(bound_ms=b_ms, bound_by=by, library_ms=library_ms,
                         flops=flops, bytes=nbytes)
        t = out[name]
        was = "" if before is None else (
            f"; before (the --before tree's kernel, timed in turns "
            f"before/now/now/before: {', '.join(f'{r:.4f}' for r in t['runs'])}"
            f" ms) {t['before_ms']:.4f} ms, {t['before_ms'] / t['ms']:.2f}x")
        log(f"{name} at N={N} G={G} S={S} hd={hd} block={kw['block']} "
            f"{q.dtype}: {t['ms']:.4f} ms{was}; with nothing listed "
            f"{t['empty_ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; "
            f"sdpa backward (dense, dq+dk+dv) {library_ms:.4f} ms; bound "
            f"{b_ms:.5f} ms by {by} ({flops:.4g} flop, {nbytes} bytes); "
            f"{b_ms / t['ms']:.4f} of the bound")
    return out


def kernel_timing(inputs, label, before=None):
    """ms of the forward kernel, its plain version and SDPA on `inputs`,
    and the kernel's bound from these tables; with `before` (a
    parent_kernels module), that tree's forward too, timed in turns with
    this one (before, these, these, before), as before_ms."""
    import torch.nn.functional as F
    from repro_torch.kernels.block_sparse_attn import (
        block_sparse_fwd, fused_forward_reference)
    from repro_torch.kernels.work import fwd_work, masked_pairs
    q, k, v, col, nvalid, kw = inputs
    N, G, S, hd = q.shape
    block = kw["block"]

    def now():
        return block_sparse_fwd(q, k, v, col, nvalid, **kw)
    was, extra = "", {}
    if before is None:
        ms = cuda_ms(now, 20)
    else:
        def old():
            return before.block_sparse_fwd(q, k, v, col, nvalid, **kw)
        b1 = cuda_ms(old, 20)
        m1, m2 = cuda_ms(now, 20), cuda_ms(now, 20)
        b2 = cuda_ms(old, 20)
        ms = (m1 + m2) / 2
        extra = dict(before_ms=(b1 + b2) / 2, runs=(b1, m1, m2, b2))
        was = (f"; before (the --before tree's kernel, timed in turns "
               f"before/now/now/before: "
               f"{', '.join(f'{r:.4f}' for r in extra['runs'])} ms) "
               f"{extra['before_ms']:.4f} ms, "
               f"{extra['before_ms'] / ms:.2f}x")
    plain_ms = cuda_ms(
        lambda: fused_forward_reference(q, k, v, col, nvalid, **kw), 5)
    # yardstick only: PyTorch's fused attention over the same rows, dense
    # (what the kernel computes when the plan covers everything)
    kx = k[:, None].expand(N, G, k.shape[1], hd).contiguous()
    vx = v[:, None].expand(N, G, k.shape[1], hd).contiguous()
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, kx, vx, is_causal=kw["causal"]), 20)
    pairs, listed, _ = masked_pairs(col, nvalid, block, kw)
    flops, nbytes = fwd_work(q, k, col, nvalid, block=block,
                             **{n: kw.get(n) for n in ("causal",
                                                       "sliding_window",
                                                       "offsets")})
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"block_sparse_fwd at {label} N={N} G={G} S={S} hd={hd} "
        f"block={block} {q.dtype}: {ms:.4f} ms{was}; plain {plain_ms:.4f} ms; "
        f"sdpa (dense{', causal' if kw['causal'] else ''}) "
        f"{library_ms:.4f} ms; bound {bound_ms:.5f} ms by {bound_by} "
        f"({flops:.4g} flop over the {pairs} (q, k) pairs the mask keeps "
        f"in {listed} listed tiles, {nbytes} bytes); "
        f"{bound_ms / ms:.4f} of the bound")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, **extra)


def profile_serving(eng, cfg, rng):
    """Device time by kernel for one sparse fused prefill of 1024 tokens and
    one decode tick of the engine's 4 slots (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    prefill = make_prefill_step(cfg, spion=True, with_cache=True)
    decode = make_serve_step(cfg, spion=True)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 1024)),
                           device=DEVICE)
    pex = eng._sparse_prefill_exec(1024)
    tok1 = torch.zeros((eng.slots, 1), dtype=torch.long, device=DEVICE)
    pos = torch.as_tensor(eng.pos.clip(0), dtype=torch.int32, device=DEVICE)
    steps = {
        "prefill 1024": lambda: prefill(eng.params, {"tokens": toks}, pex),
        "decode tick": lambda: decode(eng.params, eng.pool.cache(eng._pt_dev),
                                      tok1, pos, eng.exec),
    }
    calls = 3

    def window(fn):
        """ms a call of fn() on the host clock over `calls` calls."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / calls * 1e3

    for label, fn in steps.items():
        with torch.inference_mode():
            fn()
            plain_wall = window(fn)
            # busy time and wall time from the same profiled calls
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                wall = window(fn)
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        check(rows, f"the profiler saw no device time in {label}")
        busy = sum(e.self_device_time_total for e in rows) / 1e3 / calls
        log(f"profile {label}, {calls} calls: {wall:.2f} ms a call on the "
            f"host clock under the profiler ({plain_wall:.2f} ms without "
            f"it); device busy {busy:.2f} ms a call; idle share of the "
            f"profiled window {max(0.0, 1 - busy / wall):.3f}")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"  {e.self_device_time_total / 1e3 / calls:9.3f} ms "
                f"{e.count // calls:5d}x {e.key[:90]}")


def cast_params(tree, dtype):
    """A copy of a ParamTree with every tensor cast to `dtype`."""
    from repro_torch.models.layers import ParamTree

    def conv(node):
        return {k: conv(v) if isinstance(v, ParamTree) else v.to(dtype)
                for k, v in node.items()}
    return ParamTree(conv(tree))


def covering_and_dense(cfg, params, toks):
    """fp32 logits of a prefill through a fully covering plan (the kernel
    in every layer) and of a dense one."""
    import torch
    from repro_torch.kernels.block_sparse_attn import block_sparse_fwd
    from repro_torch.launch.steps import causal_band_tables, make_prefill_step
    prefill = make_prefill_step(cfg, spion=True, with_cache=True)
    block = cfg.spion.block_size
    cover = dict(causal_band_tables(cfg.num_layers, toks.shape[1] // block),
                 block=block)
    with torch.inference_mode():
        before = block_sparse_fwd.launches
        ls, _, _ = prefill(params, {"tokens": toks}, cover)
        check(block_sparse_fwd.launches - before == cfg.num_layers,
              "the covering prefill did not run the kernel in every layer")
        ld, _, _ = prefill(params, {"tokens": toks}, None)
        return ls.float(), ld.float()


def timed(fn, times, bad):
    """fn with its host-clock seconds (synchronized) appended to `times`,
    and the call's index appended to `bad` when its first output (the
    logits) is not all finite."""
    import torch

    def wrapped(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if not torch.isfinite(out[0]).all():
            bad.append(len(times))
        return out
    return wrapped


def random_plan(rng, layers, nrb, block):
    """A SparsityPlan of seeded random causal block masks, one per layer,
    with its stacked (col_idx, nvalid)."""
    import numpy as np
    from repro_torch.core.sparse_attention import build_sparsity_plan
    tabs = [random_tables(rng, nrb, nrb, causal=True, pad=0)
            for _ in range(layers)]
    K = max(c.shape[1] for c, _ in tabs)
    col = np.stack([np.pad(c, ((0, 0), (0, K - c.shape[1])), mode="edge")
                    for c, _ in tabs])
    nvalid = np.stack([n for _, n in tabs])
    return col, nvalid, build_sparsity_plan(col, nvalid, block)


def phase_serve(gen, rng):
    """qwen2-7b at full width and depth, bf16, through ServeEngine."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.block_sparse_attn import block_sparse_fwd
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models.registry import build

    cfg = get_config("qwen2-7b")
    check(cfg.dtype == "bfloat16" and cfg.spion.block_size == 128,
          "qwen2-7b config changed")
    t0 = time.perf_counter()
    params = build(cfg).init(gen, device=DEVICE)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in params.parameters())
    log(f"qwen2-7b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}: {nparams} parameters initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    max_len, block = 2048, cfg.spion.block_size
    nrb = max_len // block
    col, _, plan = random_plan(rng, cfg.num_layers, nrb, block)
    K = col.shape[-1]
    log(f"plan: {nrb} row-blocks of {block}, K={K}, density "
        f"{np.mean(plan.stats['per_layer_density']):.3f}")

    eng = ServeEngine(cfg, params, slots=4, max_len=max_len, spion=plan,
                      device=DEVICE)
    # one short request first, so that the timed run does not pay for the
    # first calls into cuBLAS and the caching allocator
    eng.run([Request(rid=-1, prompt=np.arange(128, dtype=np.int32),
                     max_new=2)])
    prefill_s, decode_s, bad = [], [], []
    eng._prefill = timed(eng._prefill, prefill_s, bad)
    eng._decode = timed(eng._decode, decode_s, bad)
    lens = rng.integers(200, 1501, size=6)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=int(n))
                    .astype(np.int32), max_new=16)
            for i, n in enumerate(lens)]

    warm = eng.prefill_fused
    block_sparse_fwd.launches = 0
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = block_sparse_fwd.launches

    check(all(r.done and len(r.out) == 16 for r in reqs),
          "a request did not get its 16 tokens")
    check(not bad, "a logit is not finite")
    prefills = eng.prefill_fused - warm
    check(prefills == len(reqs), "not every request was prefilled")
    check(launches == cfg.num_layers * prefills,
          f"{launches} kernel launches for {prefills} fused prefills of "
          f"{cfg.num_layers} layers")
    prefill_ms = 1e3 * float(np.median(prefill_s))
    decode_ms = 1e3 * float(np.median(decode_s))
    # window totals beside the medians: a stall inside the window moves
    # these and not the medians
    prefill_mean = 1e3 * sum(prefill_s) / len(prefill_s)
    decode_mean = 1e3 * sum(decode_s) / len(decode_s)
    log(f"serve: prompts {lens.tolist()}, 6 x 16 tokens in {wall:.2f} s; "
        f"kernel launches {launches} over {prefills} fused prefills; "
        f"prefill {prefill_ms:.2f} ms median, all {len(prefill_s)} "
        f"prefills {1e3 * sum(prefill_s):.2f} ms ({prefill_mean:.2f} ms "
        f"each) ({', '.join(f'{1e3 * t:.1f}' for t in prefill_s)}); decode "
        f"{decode_ms:.2f} ms per tick median, all {len(decode_s)} ticks "
        f"{1e3 * sum(decode_s):.2f} ms ({decode_mean:.2f} ms each)")
    profile_serving(eng, cfg, rng)

    # sparse (fully covering plan, so the kernel) vs dense prefill of one
    # prompt, in bf16 and with the same weights cast to fp32. In fp32 the two
    # are the same function up to summation order: gated at TOL_LOGITS. In
    # bf16 the dense path rounds scores and probabilities to bf16 (the JAX
    # package's semantics) where the kernel keeps them in fp32, so both bf16
    # prefills are held against the fp32 dense logits: the kernel's path
    # may be no farther from them than BF16_LOGITS_SLACK x the dense path.
    del eng
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 1024)),
                           device=DEVICE)
    s16, d16 = covering_and_dense(cfg, params, toks)
    p32 = cast_params(params, torch.float32)
    s32, d32 = covering_and_dense(cfg.replace(dtype="float32"), p32, toks)
    del p32

    def diff(a, b):
        d = (a - b).abs()
        return d.max().item(), d.mean().item()
    e32, e32_mean = diff(s32, d32)
    es16, es16_mean = diff(s16, d32)
    ed16, ed16_mean = diff(d16, d32)
    gap16, _ = diff(s16, d16)
    log(f"covering sparse prefill vs dense, 1024 tokens (mean |logit| "
        f"{d32.abs().mean().item():.4e}, max {d32.abs().max().item():.4e}): "
        f"fp32 sparse - fp32 dense max {e32:.4e} mean {e32_mean:.4e} (tol "
        f"{TOL_LOGITS}); against fp32 dense, bf16 sparse max {es16:.4e} "
        f"mean {es16_mean:.4e}, bf16 dense max {ed16:.4e} mean "
        f"{ed16_mean:.4e} (the sparse at most {BF16_LOGITS_SLACK} x the "
        f"dense); bf16 "
        f"sparse - bf16 dense max {gap16:.4e}")
    check(math.isfinite(e32) and e32 <= TOL_LOGITS,
          f"covering sparse prefill logits differ from dense by {e32} in "
          f"fp32")
    check(math.isfinite(es16) and es16 <= BF16_LOGITS_SLACK * ed16 and
          es16_mean <= BF16_LOGITS_SLACK * ed16_mean,
          f"the bf16 sparse prefill is farther from the fp32 logits "
          f"({es16}, mean {es16_mean}) than {BF16_LOGITS_SLACK} x the bf16 "
          f"dense one ({ed16}, mean {ed16_mean})")
    return dict(launches=launches, prefill_ms=prefill_ms,
                decode_ms=decode_ms, prefill_mean=prefill_mean,
                decode_mean=decode_mean, cfg=cfg, params=params, plan=plan)


# -- serving with a shared prompt prefix -----------------------------------------

SHARED_PROMPT = 1024        # tokens of the system prompt: 8 pages of 128
# suffixes after it: two short ones (stepwise through the shared pages when
# the engine is asked to, STEPWISE_MAX) and two longer ones; at the
# engine's defaults all four take the fused prefill, which leaves the 8
# shared pages alone
SHARED_SUFFIX = {"short": (37, 201), "long": (300, 517)}
UNRELATED_PROMPT = 700
STEPWISE_MAX = 256          # the reference's default: 2 pages
# each request's time to first token (submit to first token) with sharing
# at the engine's defaults, against the unshared engine's, each the less of
# two runs taken in turns: at most TTFT_SLACK x it + TTFT_FLOOR_S (one run
# of a request read 20 ms apart on one card; PERF.md, Findings)
TTFT_SLACK, TTFT_FLOOR_S = 1.5, 0.010
# bf16 first-token logits of a stepwise suffix prefill (28 decode steps a
# token: M = 1 matmuls, the decode gather with bf16 probabilities) against
# the unshared engine's fused prefill (the kernel, fp32 probabilities) at
# the last prompt position. On one H100 these read max 0.25, mean 0.042;
# with the shared pages mapped rolled by one, max 6.45, mean 1.15 (PERF.md,
# Findings)
TOL_STEPWISE = {"max": 0.5, "mean": 0.2}
# fp32, 2 layers: the stepwise prefill's last logits and each decode
# step's against a fused prefill of the same full sequence (one H100: 2.5e-5;
# the shared pages rolled by one: 6.5)
TOL_STEPWISE32 = 1e-3


def stepwise_correctness(cfg, block):
    """qwen2-7b at full width, 2 layers, fp32: a 1024-token system prompt,
    then a request whose 37-token suffix is prefilled stepwise through the
    8 shared pages and which decodes 15 tokens more; the stepwise prefill's
    last logits and each decode step's are compared with a fused prefill of
    the same full sequence at those positions. Returns the max |gap| of
    each of the 16 positions."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.registry import build

    cfg = cfg.replace(num_layers=2, dtype="float32")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    rng = np.random.default_rng(SEED + 6)
    params = build(cfg).init(gen, device=DEVICE)
    _, _, plan = random_plan(rng, cfg.num_layers, 2048 // block, block)
    system = rng.integers(0, cfg.vocab_size, size=SHARED_PROMPT)
    prompt = np.concatenate([system, rng.integers(
        0, cfg.vocab_size, size=SHARED_SUFFIX["short"][0])]).astype(
        np.int32)
    with torch.inference_mode():
        eng = ServeEngine(cfg, params, slots=4, max_len=2048, spion=plan,
                          share_prefix=True, stepwise_suffix_max=STEPWISE_MAX,
                          device=DEVICE)
        eng.run([Request(rid=-1, prompt=system.astype(np.int32), max_new=2)])
        rows = []
        step1, decode = eng._decode1_step(), eng._decode

        def step1_kept(*a, **kw):
            out = step1(*a, **kw)
            rows[:] = [out[0][0].float()]
            return out

        def decode_kept(*a, **kw):
            out = decode(*a, **kw)
            rows.append(out[0][r.slot].float())
            return out
        eng._decode1, eng._decode = step1_kept, decode_kept
        r = Request(rid=0, prompt=prompt.copy(), max_new=16)
        eng.run([r])
        check(eng.prefill_stepwise_tokens == len(prompt) - SHARED_PROMPT,
              f"the fp32 check prefilled {eng.prefill_stepwise_tokens} "
              f"tokens stepwise")
        P = len(prompt)
        seq = np.concatenate([prompt, np.asarray(r.out[:-1], np.int32)])
        Sp = eng._prefill_len(len(seq))
        toks = torch.zeros((1, Sp), dtype=torch.long, device=DEVICE)
        toks[0, :len(seq)] = torch.as_tensor(seq, device=DEVICE)
        prefill = make_prefill_step(cfg, spion=True, with_cache=True)
        want, _, _ = prefill(params, {"tokens": toks},
                             eng._sparse_prefill_exec(Sp))
        want = want[0, P - 1:len(seq)].float()
        got = torch.stack(rows)
        check(got.shape == want.shape, f"{got.shape} stepwise and decode "
              f"rows for {want.shape} prefill rows")
        gaps = (got - want).abs().amax(dim=-1).cpu().numpy()
    log(f"stepwise correctness (qwen2-7b, fp32, 2 layers, card "
        f"{card_line()}): a {P - SHARED_PROMPT}-token suffix prefilled "
        f"stepwise through {SHARED_PROMPT // block} shared pages, then 15 "
        f"decode steps, vs a fused prefill of the same sequence: max |logit "
        f"gap| {', '.join(f'{g:.3e}' for g in gaps)} (the first is the "
        f"stepwise prefill's last step); limit {TOL_STEPWISE32}; mean "
        f"|logit| {want.abs().mean().item():.4e}")
    return gaps


def phase_serve_shared(serve):
    """qwen2-7b of phase_serve (same parameters and plan) with prefix
    sharing on at the engine's defaults: a 1024-token system prompt served
    first, then six requests — four suffixes after it (fused prefills with
    its 8 pages shared), a repeat of one of them (a full hit: cached first
    token, tail page forked) and an unrelated prompt — against the same
    requests with share_prefix=False: tokens, pages, launches and each
    request's time to first token. Then the two short suffixes prefilled
    stepwise through the shared pages (stepwise_suffix_max=STEPWISE_MAX),
    their first-token logits against the unshared fused prefill's, and the
    same path in fp32 at 2 layers against a fused prefill."""
    import numpy as np
    import torch
    from repro_torch.kernels.block_sparse_attn import block_sparse_fwd
    from repro_torch.launch.serve import Request, ServeEngine

    cfg, params, plan = serve["cfg"], serve["params"], serve["plan"]
    rng = np.random.default_rng(SEED + 2)

    def draw(n):
        return rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
    system = draw(SHARED_PROMPT)
    kinds = ["short", "long", "short", "long"]
    suffixes = [SHARED_SUFFIX["short"][0], SHARED_SUFFIX["long"][0],
                SHARED_SUFFIX["short"][1], SHARED_SUFFIX["long"][1]]
    prompts = [np.concatenate([system, draw(n)]) for n in suffixes]
    prompts.append(prompts[1].copy())
    kinds.append("cached")
    prompts.append(draw(UNRELATED_PROMPT))
    kinds.append("unrelated")
    short = [i for i, k in enumerate(kinds) if k == "short"]
    check(all((n <= STEPWISE_MAX) == (k == "short")
              for n, k in zip(suffixes, kinds)), "suffix lengths changed")

    def engine(share, **kw):
        eng = ServeEngine(cfg, params, slots=4, max_len=2048, spion=plan,
                          share_prefix=share, device=DEVICE, **kw)
        check(eng.share_prefix == share, "share_prefix default changed")
        # the system prompt alone first: its 8 pages are prefilled once
        # and stay registered after it finishes
        eng.run([Request(rid=-1, prompt=system.copy(), max_new=2)])
        return eng

    def run(eng, which):
        """Requests `which` through `eng`: the requests, this run's fused
        prefills, kernel launches and pages allocated, the peak of live
        pages before a decode tick, and the decode ticks' seconds."""
        live, decode_s, bad = [], [], []
        plain_decode = eng._decode
        decode = timed(plain_decode, decode_s, bad)

        def decode_live(*a, **kw):
            live.append(eng.pool.live_pages())
            return decode(*a, **kw)
        eng._decode = decode_live
        reqs = [Request(rid=i, prompt=prompts[i].copy(), max_new=16)
                for i in which]
        fused0, allocs0 = eng.prefill_fused, eng.pool.stats["allocs"]
        launches0 = block_sparse_fwd.launches
        eng.run(reqs)
        torch.cuda.synchronize()
        eng._decode = plain_decode
        check(all(r.done and len(r.out) == 16 for r in reqs),
              "a shared-prefix request did not get its 16 tokens")
        check(not bad, "a logit is not finite in the shared-prefix phase")
        return dict(reqs=reqs, fused=eng.prefill_fused - fused0,
                    launches=block_sparse_fwd.launches - launches0,
                    allocs=eng.pool.stats["allocs"] - allocs0,
                    peak=max(live), decode_s=decode_s,
                    ttft=[r.t_first - r.t_submit for r in reqs])

    everyone = range(len(prompts))
    base = engine(False)
    first_logits = []          # the unshared fused prefills' last rows
    base_prefill = base._prefill

    def base_prefill_kept(*a, **kw):
        out = base_prefill(*a, **kw)
        P = len(prompts[len(first_logits) % len(prompts)])
        first_logits.append(out[0][0, P - 1].float())
        return out
    base._prefill = base_prefill_kept
    # once untimed, so that no timed run pays for the first calls at these
    # prompt lengths; then unshared, shared, shared, unshared, each shared
    # run on a fresh engine (a second run on one engine would be full hits)
    run(base, everyone)
    first_logits.clear()
    unshared = run(base, everyone)
    eng = engine(True)
    check(eng.stepwise_suffix_max == 0, "stepwise_suffix_max default "
          "changed")
    st0 = eng.prefix_stats
    shared = run(eng, everyone)
    st = eng.prefix_stats
    hits, lookups = st["hits"] - st0["hits"], st["lookups"] - st0["lookups"]
    del eng
    again = engine(True)
    shared2 = run(again, everyone)
    del again
    unshared2 = run(base, everyone)
    del base
    ttft = [min(a, b) for a, b in zip(shared["ttft"], shared2["ttft"])]
    base_ttft = [min(a, b) for a, b in zip(unshared["ttft"],
                                           unshared2["ttft"])]

    step_eng = engine(True, stepwise_suffix_max=STEPWISE_MAX)
    step_s, bad, now, last, launched = [], [], [], {}, []
    step1 = timed(step_eng._decode1_step(), step_s, bad)

    def step1_kept(*a, **kw):
        out = step1(*a, **kw)
        now[:] = [out[0][0].float()]
        return out
    step_eng._decode1 = step1_kept
    stepwise = step_eng._stepwise_prefill_paged

    def stepwise_counted(r, s, start):
        before = block_sparse_fwd.launches
        first = stepwise(r, s, start)
        launched.append(block_sparse_fwd.launches - before)
        last[r.rid] = now[0]
        return first
    step_eng._stepwise_prefill_paged = stepwise_counted
    stepped = run(step_eng, short)
    step_tokens = step_eng.prefill_stepwise_tokens
    del step_eng
    gaps = {}
    for i in short:
        d = (last[i] - first_logits[i]).abs()
        gaps[i] = (d.max().item(), d.mean().item())
    check(not bad, "a stepwise logit is not finite")
    gaps32 = stepwise_correctness(cfg, cfg.spion.block_size)

    same = [r.out == r2.out == b.out for r, r2, b in
            zip(shared["reqs"], shared2["reqs"], unshared["reqs"])]
    ttft_ok = [a <= TTFT_SLACK * b + TTFT_FLOOR_S
               for a, b in zip(ttft, base_ttft)]
    mean_logit = first_logits[0].abs().mean().item()
    log(f"serve shared prefix (default engine, stepwise_suffix_max 0): "
        f"system prompt {SHARED_PROMPT} tokens, requests "
        f"{[f'{k} {len(p)}' for k, p in zip(kinds, prompts)]}; fused "
        f"prefills {shared['fused']} (unshared {unshared['fused']}), "
        f"{shared['launches']} kernel launches; prefix hit rate "
        f"{hits}/{lookups} of this run's page lookups "
        f"({st['prefix_hit_rate']:.3f} with the system prompt's), "
        f"prefill_reused {st['prefill_reused']}, forks {st['forks']}; pages "
        f"allocated {shared['allocs']} (unshared {unshared['allocs']}), "
        f"peak live {shared['peak']} (unshared {unshared['peak']}); tokens "
        f"equal to the unshared run's (both shared runs): "
        f"{[f'{k} {x}' for k, x in zip(kinds, same)]}")
    log(f"serve shared prefix: time to first token s, the less of two runs "
        f"shared / unshared (limit {TTFT_SLACK} x unshared + "
        f"{TTFT_FLOOR_S}): " + ", ".join(
            f"{k} {a:.4f} / {b:.4f}" for k, a, b in
            zip(kinds, ttft, base_ttft)) + "; the runs in turns (unshared, "
        "shared, shared, unshared): " + "; ".join(
            f"{k} " + " ".join(f"{r['ttft'][i]:.4f}" for r in
                               (unshared, shared, shared2, unshared2))
            for i, k in enumerate(kinds)))
    for i, (mx, mean) in gaps.items():
        log(f"  stepwise request {i} (suffix {len(prompts[i]) - SHARED_PROMPT}"
            f", stepwise_suffix_max {STEPWISE_MAX}): first-token logits vs "
            f"the unshared fused prefill's max {mx:.4e} mean {mean:.4e} "
            f"(limit {TOL_STEPWISE}; mean |logit| {mean_logit:.4e}); "
            f"tokens equal to the unshared run's: "
            f"{stepped['reqs'][short.index(i)].out == unshared['reqs'][i].out}")
    step_ms = 1e3 * sum(step_s) / len(step_s)
    decode_ms = 1e3 * float(np.median(shared["decode_s"]))
    log(f"serve shared prefix: stepwise suffix prefill {step_ms:.2f} ms a "
        f"token ({len(step_s)} tokens, {1e3 * sum(step_s):.2f} ms, median "
        f"{1e3 * float(np.median(step_s)):.2f}; stepwise windows launched "
        f"{launched}); decode {decode_ms:.2f} ms per tick median, all "
        f"{len(shared['decode_s'])} ticks "
        f"{1e3 * sum(shared['decode_s']):.2f} ms")
    for i, kind in enumerate(kinds):
        check(same[i], f"the {kind} request {i} generated "
              f"{shared['reqs'][i].out}, the unshared engine "
              f"{unshared['reqs'][i].out}")
        check(ttft_ok[i], f"the {kind} request {i}: time to first token "
              f"{ttft[i]:.4f} s shared, {base_ttft[i]:.4f} s unshared")
    for i, (mx, mean) in gaps.items():
        check(mx <= TOL_STEPWISE["max"] and mean <= TOL_STEPWISE["mean"],
              f"stepwise request {i}: first-token logits differ from the "
              f"unshared fused prefill's by max {mx}, mean {mean}")
    worst32 = float(gaps32.max())
    check(math.isfinite(worst32) and worst32 <= TOL_STEPWISE32,
          f"fp32 stepwise logits differ from the fused prefill by {worst32}")
    check(shared["allocs"] < unshared["allocs"]
          and shared["peak"] < unshared["peak"],
          f"sharing used {shared['allocs']} pages (peak {shared['peak']}), "
          f"the unshared run {unshared['allocs']} (peak {unshared['peak']})")
    check(shared["fused"] == len(prompts) - 1,
          f"{shared['fused']} fused prefills in the shared run")
    check(shared["launches"] == cfg.num_layers * shared["fused"],
          f"{shared['launches']} kernel launches for {shared['fused']} fused "
          f"prefills")
    check(stepped["fused"] == 0 and launched == [0, 0],
          f"a stepwise prefill launched the kernel: {launched}, "
          f"{stepped['fused']} fused prefills")
    check(step_tokens == sum(SHARED_SUFFIX["short"]),
          f"{step_tokens} tokens prefilled stepwise")
    check(st["prefill_reused"] == 1 and st["forks"] == 1,
          f"the repeated prompt was no full hit: {st}")
    check(hits > 0, "no prefix hit")
    return dict(launches=shared["launches"], step_ms=step_ms,
                decode_ms=decode_ms, allocs=shared["allocs"],
                base_allocs=unshared["allocs"], gaps=gaps,
                gap32=worst32, ttft=ttft, base_ttft=base_ttft)


# -- serving mixtral-8x7b through sliding-window ring caches ---------------------

MIXTRAL_LAYERS = 8          # of 32 (all 32 are 93 GB in bf16)
MIXTRAL_RING = 4096         # ServeEngine(max_len): the ring equals the window
MIXTRAL_COVER = 5120        # positions the random plan covers (40 blocks)
MIXTRAL_LONG = (4097, 4992)  # prompts that wrap the ring at prefill
MIXTRAL_SHORT = 4090        # a prompt that wraps it during decode
# fp32 decode logits against a fused prefill of the same sequence, both
# dropless (the reasoning is in PERF.md, Findings)
TOL_RING = 1e-3


@contextlib.contextmanager
def dropless_moe(cfg):
    """The MoE's capacity raised so that no token is dropped: C = the group's
    tokens x top_k. A fused prefill routes ~1000 tokens a group under
    CAPACITY_FACTOR 1.25 and drops some (GShard), a 4-token decode tick
    never does, so only a dropless pair computes the same function."""
    from repro_torch.models import moe
    old = moe.CAPACITY_FACTOR
    moe.CAPACITY_FACTOR = cfg.moe.num_experts
    try:
        yield
    finally:
        moe.CAPACITY_FACTOR = old


def ring_correctness(cfg8, col, nvalid, rng):
    """mixtral at full width, 2 layers, fp32: a 4090-token prompt (the ring
    wraps at decode position 4096) and a longer one (inserted in ring
    layout) decode 15 steps through the paged ring; each step's logits are
    held against a fused prefill of the same full sequence at that
    position."""
    import numpy as np
    import torch
    from repro_torch.core.sparse_attention import build_sparsity_plan
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.registry import build

    cfg = cfg8.replace(num_layers=2, dtype="float32")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    params = build(cfg).init(gen, device=DEVICE)
    plan = build_sparsity_plan(col[:2], nvalid[:2], cfg.spion.block_size)
    lens = (MIXTRAL_SHORT, int(rng.integers(*MIXTRAL_LONG)))
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    with dropless_moe(cfg), torch.inference_mode():
        eng = ServeEngine(cfg, params, slots=4, max_len=MIXTRAL_RING,
                          spion=plan, device=DEVICE)
        rows = []
        decode = eng._decode

        def kept(*a, **kw):
            out = decode(*a, **kw)
            rows.append(out[0][:len(prompts)].float())
            return out
        eng._decode = kept
        reqs = [Request(rid=i, prompt=p.copy(), max_new=16)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        prefill = make_prefill_step(cfg, spion=True, with_cache=True)
        gaps = []
        for s, r in enumerate(reqs):
            P = len(r.prompt)
            seq = np.concatenate([r.prompt, np.asarray(r.out[:-1], np.int32)])
            Sp = eng._prefill_len(len(seq))
            toks = torch.zeros((1, Sp), dtype=torch.long, device=DEVICE)
            toks[0, :len(seq)] = torch.as_tensor(seq, device=DEVICE)
            want, _, _ = prefill(params, {"tokens": toks},
                                 eng._sparse_prefill_exec(Sp))
            want = want[0, P:len(seq)].float()
            got = torch.stack([row[s] for row in rows])
            check(got.shape == want.shape, f"{got.shape} decode rows for "
                  f"{want.shape} prefill rows")
            gaps.append((got - want).abs().amax(dim=-1).cpu().numpy())
            mean_logit = want.abs().mean().item()
    wrap = MIXTRAL_RING - MIXTRAL_SHORT          # the tick at position 4096
    log(f"mixtral ring correctness (fp32, 2 layers, dropless MoE, card "
        f"{card_line()}): decode vs fused prefill of the same sequence, "
        f"max |logit gap| a step: prompt {lens[0]} (wraps at decode) "
        f"{', '.join(f'{g:.3e}' for g in gaps[0])} — at position "
        f"{MIXTRAL_RING}, the first after the wrap, {gaps[0][wrap]:.3e}; "
        f"prompt {lens[1]} (ring insert) "
        f"{', '.join(f'{g:.3e}' for g in gaps[1])}; limit {TOL_RING}; mean "
        f"|logit| {mean_logit:.4e}")
    worst = max(float(g.max()) for g in gaps)
    check(math.isfinite(worst) and worst <= TOL_RING,
          f"ring decode logits differ from the fused prefill by {worst}")
    return worst


def phase_mixtral_ring(before=None):
    """mixtral-8x7b at full width, 8 of 32 layers, bf16, through the paged
    ring engine over a random causal plan; then the same requests through
    the contiguous ring engine, the forward kernel at this path's shape
    (and `before`'s, as in kernel_timing), and the fp32 ring correctness
    check. Returns, besides the numbers, the plan's tables sliced as the
    engine's exec for the longest prompt slices them (phase 8a tunes
    them)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.block_sparse_attn import block_sparse_fwd
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models.registry import build

    t_phase = time.perf_counter()
    full = get_config("mixtral-8x7b")
    check(full.num_layers == 32 and full.sliding_window == MIXTRAL_RING and
          full.dtype == "bfloat16" and full.spion.block_size == 128,
          "mixtral-8x7b config changed")
    cfg = full.replace(num_layers=MIXTRAL_LAYERS)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    rng = np.random.default_rng(SEED + 3)
    t0 = time.perf_counter()
    params = build(cfg).init(gen, device=DEVICE)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in params.parameters())
    log(f"mixtral-8x7b: {cfg.num_layers} of {full.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
        f"d_ff {cfg.d_ff}, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.top_k}, vocab {cfg.vocab_size}, window "
        f"{cfg.sliding_window}: {nparams} parameters initialised on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    block = cfg.spion.block_size
    col, nvalid, plan = random_plan(rng, cfg.num_layers,
                                    MIXTRAL_COVER // block, block)
    lens = [MIXTRAL_SHORT] + sorted(
        int(n) for n in rng.integers(MIXTRAL_LONG[0], MIXTRAL_LONG[1] + 1,
                                     size=4))
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    warm = rng.integers(0, cfg.vocab_size, size=256).astype(np.int32)

    def engine(paged):
        eng = ServeEngine(cfg, params, slots=4, max_len=MIXTRAL_RING,
                          spion=plan, paged=paged, device=DEVICE)
        check(not eng.share_prefix, "prefix sharing on a ring")
        eng.run([Request(rid=-1, prompt=warm.copy(), max_new=2)])
        return eng

    runs = {}
    for paged in (True, False):
        eng = engine(paged)
        prefill_s, decode_s, bad = [], [], []
        eng._prefill = timed(eng._prefill, prefill_s, bad)
        eng._decode = timed(eng._decode, decode_s, bad)
        reqs = [Request(rid=i, prompt=p.copy(), max_new=16)
                for i, p in enumerate(prompts)]
        fused0 = eng.prefill_fused
        block_sparse_fwd.launches = 0
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        runs[paged] = dict(
            wall=time.perf_counter() - t0, launches=block_sparse_fwd.launches,
            prefills=eng.prefill_fused - fused0, reqs=reqs, bad=bad,
            prefill_s=prefill_s, decode_s=decode_s,
            buckets=[eng._prefill_len(n) for n in lens])
        del eng
    run = runs[True]
    for paged, r in runs.items():
        what = "paged" if paged else "contiguous"
        check(all(q.done and len(q.out) == 16 for q in r["reqs"]),
              f"a {what} mixtral request did not get its 16 tokens")
        check(not r["bad"], f"a {what} mixtral logit is not finite")
        check(r["prefills"] == len(prompts) and
              r["launches"] == cfg.num_layers * r["prefills"],
              f"{what}: {r['launches']} kernel launches for "
              f"{r['prefills']} fused prefills of {cfg.num_layers} layers")
    same = [a.out == b.out for a, b in zip(runs[True]["reqs"],
                                           runs[False]["reqs"])]
    prefill_ms = 1e3 * float(np.median(run["prefill_s"]))
    decode_ms = 1e3 * float(np.median(run["decode_s"]))
    log(f"serve mixtral ring: prompts {lens} (buckets {run['buckets']}), "
        f"5 x 16 tokens in {run['wall']:.2f} s; kernel launches "
        f"{run['launches']} over {run['prefills']} fused prefills; prefill "
        f"{prefill_ms:.2f} ms median, all {len(run['prefill_s'])} "
        f"{1e3 * sum(run['prefill_s']):.2f} ms "
        f"({', '.join(f'{1e3 * t:.1f}' for t in run['prefill_s'])}); decode "
        f"{decode_ms:.2f} ms per tick median, all {len(run['decode_s'])} "
        f"ticks {1e3 * sum(run['decode_s']):.2f} ms; contiguous ring engine: "
        f"prefill {1e3 * float(np.median(runs[False]['prefill_s'])):.2f} ms, "
        f"decode {1e3 * float(np.median(runs[False]['decode_s'])):.2f} ms "
        f"median; paged tokens equal the contiguous engine's: {same}")
    check(all(same), "the paged ring engine's tokens differ from the "
          "contiguous ring engine's")

    # the forward kernel at this path's shape: layer 0's tables over the
    # longest bucket, G = 4 query heads a KV head, the window of 4096
    S = max(run["buckets"])
    nrb = S // block
    case = dict(dtype="bfloat16", causal=True, sw=cfg.sliding_window,
                G=cfg.num_heads // cfg.num_kv_heads, N=cfg.num_kv_heads, S=S,
                hd=cfg.resolved_head_dim, block=block)
    kgen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    err, tol, share, typical, lerr, inputs = compare_kernel(
        case, kgen, np.random.default_rng(SEED + 4),
        tables=(col[0, :nrb], nvalid[0, :nrb]))
    log(f"kernel at mixtral's shape {case}: |o - plain| = {err:.3e} (that "
        f"element's limit {tol:.3e}; no element past {share:.3f} of its "
        f"limit; mean |o| {typical:.3e}); |lse - plain| {lerr:.3e}")
    timing = kernel_timing(inputs, "mixtral's sparse ring prefill", before)
    launches = run["launches"]
    tables = {k: plan.tables[k][:, :nrb] for k in ("col_idx", "nvalid")}
    del inputs, params, runs, run
    torch.cuda.empty_cache()
    ring_gap = ring_correctness(cfg, col, nvalid, rng)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"serve mixtral ring: the phase took {seconds:.1f} s")
    return dict(launches=launches, prefill_ms=prefill_ms,
                decode_ms=decode_ms, seconds=seconds, ring_gap=ring_gap,
                kernel=dict(timing, max_abs_err=err, tol=tol, shape=case),
                tables=tables)


# -- the recurrent families: zamba2-1.2b (hybrid) and rwkv6-7b (ssm) -------------

ZAMBA_S = 2048              # positions the zamba2 plan covers (16 blocks)
ZAMBA_BATCH = 2             # sequences of the sparse forward and train step
# prompt lengths the recurrent engines serve, every token stepwise (about
# 50 ms a token on one H100, so 24-160 took phase 4c to 80 s; PERF.md)
RECURRENT_PROMPTS = (24, 80)
# fp32 teacher-forced decode against the chunked forward of the same 256
# tokens (two chunks of 128), max |logit gap| over every step. On one H100
# sound runs read 1.645e-5 (zamba2, 6 layers) and 2.241e-5 (rwkv6, 2
# layers); planted decode faults read 1.322e-3 (rwkv6's y read from the
# decayed state), 2.924e-3 (zamba2's decay exp(1.01 a)) and 6.35 (zamba2's
# conv window one step off) (PERF.md, Findings)
TOL_RECURRENT = 2e-4
DECODE_S = 256
# controls of zamba2's bf16 covering gate (coarse_attention): the shared
# block's attention with q and k, or with dq, dk and dv, rounded to fewer
# significand bits than bf16's 7, and whether the gate must reject it. On
# one H100 the worst leaf read, by mean/rms, 1.0006x sound; q and k at 5 / 3
# / 1 bits 1.0211 / 1.1951 / 2.7208x; dq, dk and dv 1.0067 / 1.0612 /
# 1.7204x: the 38 bf16 Mamba layers of both paths hide a backward at fp8's
# 3 bits, which the kernels' plain-version check at this shape holds
# instead (PERF.md, Findings)
COVERING_CONTROLS = (("scores", 5, False), ("scores", 3, True),
                     ("scores", 1, True), ("backward", 5, False),
                     ("backward", 3, False), ("backward", 1, True))


def stepwise_requests(rng, cfg, lens, n=4):
    """n prompts of `lens` = (least, most) tokens, for an engine that
    prefills them stepwise."""
    import numpy as np
    lo, hi = lens
    lens = rng.integers(lo, hi + 1, size=n)
    return [rng.integers(0, cfg.vocab_size, size=int(k)).astype(np.int32)
            for k in lens]


def serve_stepwise(cfg, params, prompts, max_len=2048, max_new=16, **kw):
    """ServeEngine(slots=4, max_len=max_len, **kw) serving `prompts`
    (`max_new` new tokens each) after a short warm-up request. Returns the
    engine, the requests, the host seconds of every stepwise prefill token
    and every decode tick, the indices of calls whose logits were not
    finite and the kernel launches of the run."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import Request, ServeEngine
    eng = ServeEngine(cfg, params, slots=4, max_len=max_len, device=DEVICE,
                      **kw)
    eng.run([Request(rid=-1, prompt=np.arange(8, dtype=np.int32),
                     max_new=2)])
    step_s, decode_s, bad = [], [], []
    eng._decode1 = timed(eng._decode1_step(), step_s, bad)
    eng._decode = timed(eng._decode, decode_s, bad)
    reqs = [Request(rid=i, prompt=p.copy(), max_new=max_new)
            for i, p in enumerate(prompts)]
    tokens0 = eng.prefill_stepwise_tokens
    reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = launch_counts()
    check(all(r.done and len(r.out) == max_new for r in reqs),
          f"a {cfg.name} request did not get its {max_new} tokens")
    check(eng.prefill_stepwise_tokens - tokens0 == sum(map(len, prompts))
          and eng.prefill_fused == 0,
          f"{cfg.name}: {eng.prefill_stepwise_tokens - tokens0} stepwise "
          f"tokens and {eng.prefill_fused} fused prefills for prompts of "
          f"{[len(p) for p in prompts]}")
    check(not any(launched.values()),
          f"{cfg.name}'s stepwise serving launched a kernel: {launched}")
    return dict(eng=eng, reqs=reqs, step_s=step_s, decode_s=decode_s,
                bad=bad, wall=wall)


def decode_against_forward(cfg, params, spion=None, seed=0):
    """fp32: the chunked forward of 256 tokens and a teacher-forced decode
    of the same tokens through a fresh contiguous cache; returns the max
    |logit gap| of every step and the forward's mean |logit|. `spion` is a
    tables payload: the forward runs the kernel, the decode gathers."""
    import numpy as np
    import torch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.registry import build
    S = DECODE_S
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, S)),
                           device=DEVICE)
    sparse = spion is not None
    with torch.inference_mode():
        fwd = make_prefill_step(cfg, spion=sparse)(
            params, {"tokens": toks}, *((spion,) if sparse else ()))
        step = make_serve_step(cfg, spion=sparse)
        cache = build(cfg).init_cache(1, S, device=DEVICE)
        gaps = []
        for t in range(S):
            lg, cache = step(params, cache, toks[:, t:t + 1], t,
                             *((spion,) if sparse else ()))
            gaps.append((lg[0].float() - fwd[0, t].float()).abs().max())
        gaps = torch.stack(gaps).cpu().numpy()
    return gaps, fwd.float().abs().mean().item()


def log_stepwise_serving(name, run, base, same):
    """Print an engine's stepwise and decode times (and, with `base` =
    (label, run), another engine's beside them); returns (ms a stepwise
    token, mean; ms a decode tick, median)."""
    import numpy as np
    step_ms = 1e3 * sum(run["step_s"]) / len(run["step_s"])
    decode_ms = 1e3 * float(np.median(run["decode_s"]))
    lens = [len(r.prompt) for r in run["reqs"]]
    log(f"serve {name}: prompts {lens} prefilled stepwise, 4 x "
        f"{run['reqs'][0].max_new} tokens in "
        f"{run['wall']:.2f} s; stepwise prefill {step_ms:.2f} ms a token "
        f"(mean of {len(run['step_s'])}, median "
        f"{1e3 * float(np.median(run['step_s'])):.2f}); decode "
        f"{decode_ms:.2f} ms per tick median, all {len(run['decode_s'])} "
        f"ticks {1e3 * sum(run['decode_s']):.2f} ms; no kernel launched"
        + ("" if base is None else
           f"; {base[0]} engine: stepwise "
           f"{1e3 * sum(base[1]['step_s']) / len(base[1]['step_s']):.2f} ms "
           f"a token, decode "
           f"{1e3 * float(np.median(base[1]['decode_s'])):.2f} ms per tick"
           f" median; tokens equal to its: {same}"))
    return step_ms, decode_ms


def sparse_forward_and_step(label, cfg, params, plan, batch, *, fwd, step,
                            leaf):
    """A model phase's main path: a sparse forward of `batch` (without its
    labels) through the plan's prefill exec, then a sparse train step
    (make_loss_and_grads from fp32 masters of `params`) through its train
    exec, each after a warm-up, with their launches read from zero and held
    to `fwd` and `step`; logits, loss and gradients finite, and `leaf`'s
    gradient not zero. Returns the times, launches and peak memory of the
    step, and the masters."""
    import torch
    from repro_torch.core.attention_exec import SparseAttentionExec
    from repro_torch.launch.steps import make_loss_and_grads, make_prefill_step
    from repro_torch.launch.train import masters_of
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    prefill = make_prefill_step(cfg, spion=True)
    pex = SparseAttentionExec.from_plan(plan, phase="prefill",
                                        dtype=cfg.dtype).to(DEVICE)
    with torch.inference_mode():
        prefill(params, inputs, pex)                            # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        logits = prefill(params, inputs, pex)
        torch.cuda.synchronize()
        fwd_ms = 1e3 * (time.perf_counter() - t0)
    fwd_launches = launch_counts()
    check(bool(torch.isfinite(logits).all()), f"a {label} logit is not "
          f"finite")
    check(fwd_launches == fwd, f"the {label} sparse forward launched "
          f"{fwd_launches}, not {fwd}")
    del logits
    masters = masters_of(params)
    tex = SparseAttentionExec.from_plan(plan, phase="train",
                                        dtype=cfg.dtype).to(DEVICE)
    loss_and_grads = make_loss_and_grads(cfg)
    loss_and_grads(masters, batch, tex)                         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    loss, grads = loss_and_grads(masters, batch, tex)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    step_launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(step_launches == step, f"the {label} sparse train step launched "
          f"{step_launches}, not {step}")
    check(math.isfinite(loss.item()) and
          all(bool(torch.isfinite(g).all()) for g in grads.values()),
          f"a {label} loss or gradient is not finite")
    check(grads[leaf].abs().max().item() > 0, f"{label}'s {leaf} has no "
          f"gradient")
    shapes = ", ".join(f"{k} {tuple(v.shape)}" for k, v in inputs.items())
    log(f"{label} sparse forward of {shapes}: {fwd_ms:.2f} ms, launches "
        f"{fwd_launches}; sparse train step (remat): {step_ms:.2f} ms, loss "
        f"{loss.item():.6f}, launches {step_launches}, peak device memory "
        f"{peak_gb:.2f} GB")
    return dict(fwd_ms=fwd_ms, train_ms=step_ms, fwd_launches=fwd_launches,
                step_launches=step_launches, peak_gb=peak_gb,
                loss=loss.item(), masters=masters)


def phase_zamba2(before=None):
    """zamba2-1.2b at full width and depth, bf16, with a random causal plan
    of one block mask per application of the shared attention block (6 at
    block 128 over ZAMBA_S positions):
      - a sparse forward of ZAMBA_BATCH x ZAMBA_S tokens launches the
        forward kernel once per application (6);
      - a sparse train step (make_loss_and_grads, remat: only the Mamba
        part of a layer is recomputed, the shared block is not) launches
        6 forward, 6 dQ and 6 dK/dV kernels; loss and gradients finite;
      - a fully covering plan against dense attention: fp32 logits within
        TOL_LOGITS; bf16 logits (max and mean), and the bf16 gradients of
        the shared block's leaves (mean and rms), at most
        BF16_LOGITS_SLACK x as far from the fp32 dense ones as the bf16
        dense ones are; the gate rejects the COVERING_CONTROLS it must;
      - the three kernels against their plain versions at this path's
        shape (N = B x 32 heads, G 1, hd 64, block 128, causal), fp32 and
        bf16, then timed beside their bounds;
      - ServeEngine(slots=4, max_len=2048, spion=plan): paged by the
        registry, 6 pool layers, page = block = 128, no prefix sharing;
        four prompts prefilled stepwise (no kernel launch: decode
        gathers), 16 tokens each, equal to a paged=False engine's with the
        same plan; a dense engine's tokens and logits finite;
      - at 6 layers (one application) in fp32, every teacher-forced decode
        step of 256 tokens within TOL_RECURRENT of the chunked sparse
        forward.
    Returns the launches of the sparse forward and train step, the kernel
    records at this shape and the serving times."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.hybrid import n_attn_apps
    from repro_torch.models.registry import build

    t_phase = time.perf_counter()
    cfg = get_config("zamba2-1.2b")
    napps = n_attn_apps(cfg)
    check(cfg.num_layers == 38 and cfg.d_model == 2048 and
          cfg.num_heads == cfg.num_kv_heads == 32 and
          cfg.resolved_head_dim == 64 and cfg.d_ff == 8192 and
          cfg.vocab_size == 32000 and napps == 6 and cfg.remat and
          cfg.dtype == "bfloat16" and cfg.spion.block_size == 128,
          "zamba2-1.2b config changed")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    rng = np.random.default_rng(SEED + 7)
    t0 = time.perf_counter()
    params = build(cfg).init(gen, device=DEVICE)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in params.parameters())
    log(f"zamba2-1.2b: {cfg.num_layers} Mamba2 layers (d_model "
        f"{cfg.d_model}, {cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim} "
        f"SSM heads of {cfg.ssm.head_dim}, state {cfg.ssm.state_size}, chunk "
        f"{cfg.ssm.chunk}) and one shared attention block ({cfg.num_heads} "
        f"heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}) applied {napps} "
        f"times, vocab {cfg.vocab_size}: {nparams} parameters initialised on "
        f"the card in {time.perf_counter() - t0:.1f} s")
    block = cfg.spion.block_size
    nrb = ZAMBA_S // block
    col, nvalid, plan = random_plan(rng, napps, nrb, block)
    log(f"zamba2 plan: {napps} applications x {nrb} row-blocks of {block}, "
        f"K={col.shape[-1]}, density "
        f"{np.mean(plan.stats['per_layer_density']):.3f}")
    toks = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(ZAMBA_BATCH, ZAMBA_S + 1)),
        device=DEVICE)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    # the main path: the sparse forward, then the sparse train step
    main = sparse_forward_and_step(
        "zamba2", cfg, params, plan, batch,
        fwd={"block_sparse_fwd": napps, "block_sparse_dq": 0,
             "block_sparse_dkv": 0},
        step=dict.fromkeys(KERNELS, napps), leaf="shared_attn.attn.wq")
    masters = main.pop("masters")
    fwd_launches, step_launches = main["fwd_launches"], main["step_launches"]
    fwd_ms, step_ms = main["fwd_ms"], main["train_ms"]

    covering_zamba2(cfg, masters, batch)
    del masters
    torch.cuda.empty_cache()
    kernels = zamba2_kernels(cfg, col, nvalid, before)

    # serving: paged (the registry's default) and contiguous with the plan,
    # then dense
    prompts = stepwise_requests(rng, cfg, RECURRENT_PROMPTS)
    runs = {}
    for name, kw in (("paged", dict(spion=plan)),
                     ("contiguous", dict(spion=plan, paged=False)),
                     ("dense", dict())):
        runs[name] = serve_stepwise(cfg, params, prompts, **kw)
        eng = runs[name].pop("eng")
        check(not runs[name]["bad"], f"a {name} zamba2 logit is not finite")
        if name == "paged":
            check(eng.paged and eng.pool.kp.shape[0] == napps and
                  eng.page == block and not eng.share_prefix and
                  eng._prefill is None,
                  f"the zamba2 engine: paged {eng.paged}, pool layers "
                  f"{eng.pool.kp.shape[0]}, page {eng.page}, share_prefix "
                  f"{eng.share_prefix}")
        del eng
    same = [a.out == b.out for a, b in zip(runs["paged"]["reqs"],
                                           runs["contiguous"]["reqs"])]
    step_tok_ms, decode_ms = log_stepwise_serving(
        "zamba2-1.2b, sparse, paged", runs["paged"],
        ("the contiguous", runs["contiguous"]), same)
    dense_tok_ms, dense_ms = log_stepwise_serving(
        "zamba2-1.2b, dense, paged", runs["dense"], None, None)
    check(all(same), "the paged zamba2 engine's tokens differ from the "
          "contiguous engine's")
    del params, runs
    torch.cuda.empty_cache()

    # fp32 at 6 layers: one application, its tables over 256 positions
    cfg6 = cfg.replace(num_layers=6, dtype="float32")
    p6 = build(cfg6).init(torch.Generator(device=DEVICE)
                          .manual_seed(SEED + 8), device=DEVICE)
    nr = DECODE_S // block
    tabs = dict(col_idx=col[:1, :nr], nvalid=nvalid[:1, :nr], block=block)
    gaps, mean_logit = decode_against_forward(cfg6, p6, tabs, SEED + 8)
    log(f"zamba2 decode vs chunked forward (fp32, 6 layers, 1 application, "
        f"256 tokens = 2 chunks, sparse; card {card_line()}): max |logit "
        f"gap| {gaps.max():.3e} (step {int(gaps.argmax())}), mean over steps "
        f"{gaps.mean():.3e}; limit {TOL_RECURRENT}; mean |logit| "
        f"{mean_logit:.4e}")
    check(math.isfinite(float(gaps.max())) and gaps.max() <= TOL_RECURRENT,
          f"zamba2 decode logits differ from the chunked forward by "
          f"{gaps.max()}")
    del p6
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"zamba2: the phase took {seconds:.1f} s")
    return dict(launches={k: fwd_launches[k] + step_launches[k]
                          for k in fwd_launches},
                kernels=kernels, step_ms=step_tok_ms, decode_ms=decode_ms,
                dense_step_ms=dense_tok_ms, dense_decode_ms=dense_ms,
                fwd_ms=fwd_ms, train_ms=step_ms, gap32=float(gaps.max()),
                seconds=seconds)


def round_bits(x, bits):
    """x with its significand rounded to `bits` explicit bits (bf16 keeps
    7, fp8 e4m3 3), its exponent range kept."""
    import torch
    m, e = torch.frexp(x.float())
    scale = 2.0 ** (bits + 1)
    return torch.ldexp(torch.round(m * scale) / scale, e).to(x.dtype)


@contextlib.contextmanager
def coarse_attention(kind, bits):
    """A control of the bf16 covering gate: while it is open, every sparse
    attention (zamba2's shared block, a decoder's layers) runs with q and k
    rounded to `bits`
    significand bits (kind "scores": the forward's scores and the
    backward's recomputed probabilities come from coarser operands; the
    gradient passes straight through), or with its dq, dk and dv rounded
    so (kind "backward")."""
    import torch
    from repro_torch.core.attention_exec import SparseAttentionExec

    class Round(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return round_bits(x, bits) if kind == "scores" else x.clone()

        @staticmethod
        def backward(ctx, g):
            return g if kind == "scores" else round_bits(g, bits)

    sound = SparseAttentionExec.attend

    def attend(self, cfg, q, k, v, layer_tables):
        if kind == "scores":
            q, k = Round.apply(q), Round.apply(k)
        else:
            q, k, v = Round.apply(q), Round.apply(k), Round.apply(v)
        return sound(self, cfg, q, k, v, layer_tables)
    SparseAttentionExec.attend = attend      # attend_app calls attend
    try:
        yield
    finally:
        SparseAttentionExec.attend = sound


def covering_zamba2(cfg, masters, batch):
    """covering_gate on zamba2's shared block, one plan row per
    application, with its controls (COVERING_CONTROLS)."""
    from repro_torch.models.hybrid import n_attn_apps
    covering_gate("zamba2", cfg, masters, batch, layers=n_attn_apps(cfg),
                  leaves=("shared_attn.",), controls=COVERING_CONTROLS)


def covering_gate(label, cfg, masters, batch, *, layers, leaves,
                  controls=(), qk_slack=BF16_LOGITS_SLACK):
    """A fully covering plan (the kernels in each of `layers` attention
    layers or applications) against dense attention from the same masters
    and the batch's first sequence: the fp32 logits within TOL_LOGITS; the
    bf16 logits no farther from the fp32 dense ones than BF16_LOGITS_SLACK
    x the bf16 dense ones, by max and by mean; the bf16 gradients of the
    leaves whose names start with one of `leaves` likewise by mean and by
    root mean square, their max printed beside; the leaves that dq and dk
    feed (the q and k projections and the attention's input norm) at
    `qk_slack` x instead. Then each of `controls` (coarse_attention)
    through the same readings, printed beside the sound ones with whether
    the gate rejects it; the run fails if the gate passes a control it must
    reject."""
    import torch
    from repro_torch.core.attention_exec import SparseAttentionExec
    from repro_torch.core.sparse_attention import build_sparsity_plan
    from repro_torch.launch.steps import (causal_band_tables, compute_params,
                                          make_loss_and_grads)
    from repro_torch.models.registry import build
    S = batch["tokens"].shape[1] + (cfg.num_patch_tokens
                                    if "patch_embeds" in batch else 0)
    band = causal_band_tables(layers, S // cfg.spion.block_size)
    cover = build_sparsity_plan(band["col_idx"], band["nvalid"],
                                cfg.spion.block_size)
    one = {k: v[:1] for k, v in batch.items()}
    inputs = {k: v for k, v in one.items() if k != "labels"}

    def run(dtype, sparse):
        c = cfg.replace(dtype=dtype)
        ex = SparseAttentionExec.from_plan(cover, dtype=dtype).to(DEVICE) \
            if sparse else None
        with torch.inference_mode():
            lg, _ = build(c).forward(
                compute_params(masters, getattr(torch, dtype)), inputs,
                spion=ex)
        _, grads = make_loss_and_grads(c)(masters, one, ex)
        return lg.float(), {k: g.float() for k, g in grads.items()
                            if k.startswith(leaves)}

    ls32, gs32 = run("float32", True)
    ld32, gd32 = run("float32", False)
    ld16, gd16 = run("bfloat16", False)
    e32 = (ls32 - ld32).abs().max().item()
    g32 = max((gs32[k] - gd32[k]).abs().max().item() for k in gd32)

    def dist(a, ref):
        d = (a - ref).abs()
        return d.max().item(), d.mean().item(), d.square().mean().sqrt().item()
    ed, ed_mean, _ = dist(ld16, ld32)

    def slack(name):
        fed = name.rsplit(".", 1)[-1] in ("wq", "wk", "bq", "bk") or \
            ".attn_norm." in name
        return qk_slack if fed else BF16_LOGITS_SLACK

    def readings(ls16, gs16):
        """The bf16 sparse run's distances from fp32 dense over the bf16
        dense run's: logits by max and mean, and per leaf the gated
        max(mean, rms) ratio with its distances."""
        es, es_mean, _ = dist(ls16, ld32)
        leaves = {}
        for name, ref in gd32.items():
            (sm, sa, sr), (dm, da, dr) = dist(gs16[name], ref), \
                dist(gd16[name], ref)
            ratio = max(sa / da if da else math.inf,
                        sr / dr if dr else math.inf)
            leaves[name] = (ratio, sm / dm if dm else math.inf,
                            (sm, sa, sr, dm, da, dr))
        worst = max(leaves, key=lambda n: leaves[n][0])
        ok = (math.isfinite(es) and es <= BF16_LOGITS_SLACK * ed and
              es_mean <= BF16_LOGITS_SLACK * ed_mean)
        far = [(n, r[0]) for n, r in leaves.items()
               if not (math.isfinite(r[0]) and r[0] <= slack(n))]
        return dict(es=es, es_mean=es_mean, max_ratio=es / ed,
                    mean_ratio=es_mean / ed_mean, leaves=leaves,
                    worst=worst, logits_ok=ok, far=far)

    sound = readings(*run("bfloat16", True))
    log(f"{label} covering plan vs dense, 1 x {S} tokens (mean |logit| "
        f"{ld32.abs().mean().item():.4e}): fp32 logits max |diff| {e32:.4e} "
        f"(tol {TOL_LOGITS}); fp32 attention grads max |diff| {g32:.4e}; "
        f"against fp32 dense logits: bf16 sparse max {sound['es']:.4e} mean "
        f"{sound['es_mean']:.4e}, bf16 dense max {ed:.4e} mean "
        f"{ed_mean:.4e}")
    check(math.isfinite(e32) and e32 <= TOL_LOGITS,
          f"{label} covering fp32 logits differ from dense by {e32}")
    check(sound["logits_ok"],
          f"the {label} bf16 covering logits are farther from fp32 "
          f"({sound['es']}, mean {sound['es_mean']}) than "
          f"{BF16_LOGITS_SLACK} x the dense ones ({ed}, mean {ed_mean})")
    shown = list(sound["leaves"])
    if len(shown) > 12:
        shown = sorted(shown, key=lambda n: -sound["leaves"][n][0])[:8]
        log(f"  the {len(shown)} of {len(sound['leaves'])} leaves farthest "
            f"by mean/rms:")
    for name in shown:
        ratio, mx, (sm, sa, sr, dm, da, dr) = sound["leaves"][name]
        log(f"  {name:28s} mean |grad| {gd32[name].abs().mean().item():.4e}; "
            f"bf16 from fp32 dense: sparse max {sm:.4e} mean {sa:.4e} rms "
            f"{sr:.4e}, dense max {dm:.4e} mean {da:.4e} rms {dr:.4e} "
            f"(mean/rms ratio {ratio:.4f}, gated at {slack(name)}; max "
            f"ratio {mx:.4f})")
    check(not sound["far"], f"{label} bf16 covering gradients farther from "
          f"fp32 than {BF16_LOGITS_SLACK} x (the leaves dq and dk feed: "
          f"{qk_slack} x) the dense ones (mean or rms): {sound['far']}")
    missed = []
    for kind, bits, must in controls:
        with coarse_attention(kind, bits):
            r = readings(*run("bfloat16", True))
        rejected = not r["logits_ok"] or bool(r["far"])
        if must and not rejected:
            missed.append((kind, bits))
        log(f"{label} covering control, the attention's "
            f"{'q and k' if kind == 'scores' else 'dq, dk and dv'} at "
            f"{bits} significand bits: logits {r['max_ratio']:.4f}x dense's "
            f"distance by max, {r['mean_ratio']:.4f}x by mean; worst leaf "
            f"{r['worst']} {r['leaves'][r['worst']][0]:.4f}x by mean/rms "
            f"(max {r['leaves'][r['worst']][1]:.4f}x); "
            f"{len(r['far'])} of {len(r['leaves'])} leaves past their "
            f"limit; the gate "
            f"{'rejects' if rejected else 'PASSES'} it"
            f"{' (must reject)' if must else ''}")
    log(f"{label} covering, sound: logits {sound['max_ratio']:.4f}x by max, "
        f"{sound['mean_ratio']:.4f}x by mean; worst leaf {sound['worst']} "
        f"{sound['leaves'][sound['worst']][0]:.4f}x by mean/rms")
    check(not missed, f"the {label} bf16 covering gate passed controls it "
          f"must reject (kind, significand bits): {missed}")
    return dict(logits_max=sound["max_ratio"], logits_mean=sound["mean_ratio"],
                worst_leaf=sound["leaves"][sound["worst"]][0], fp32=e32)


def zamba2_kernels(cfg, col, nvalid, before=None):
    """path_kernels at zamba2's shape (N = ZAMBA_BATCH x 32 heads, G 1, hd
    64, block 128, causal) on application 0's tables."""
    shape = dict(N=ZAMBA_BATCH * cfg.num_kv_heads,
                 G=cfg.num_heads // cfg.num_kv_heads, S=ZAMBA_S,
                 hd=cfg.resolved_head_dim, block=cfg.spion.block_size)
    return path_kernels("zamba2", shape, (col[0], nvalid[0]),
                        "application 0's", SEED + 9, before)


def path_kernels(label, shape, tables, which, seed, before=None,
                 causal=True):
    """The three kernels at a path's `shape` (causal unless `causal` is
    False) on `tables` = (col_idx, nvalid) numpy (`which` names them):
    against their plain versions in fp32 and bf16, then timed (bf16) beside
    their bounds and PyTorch's SDPA. Returns {kernel: record}."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    err = {}
    mask = "causal" if causal else "non-causal"
    for dtype in ("float32", "bfloat16"):
        case = dict(dtype=dtype, causal=causal, **shape)
        o_err, tol, share, typical, lerr, _ = compare_kernel(
            case, gen, None, tables=tables)
        log(f"kernel at {label}'s shape {shape} {dtype} {mask}, {which} "
            f"tables ({int(tables[1].sum())} listed tiles): |o - plain| "
            f"= {o_err:.3e} (that element's limit {tol:.3e}; no element past "
            f"{share:.3f} of its limit; mean |o| {typical:.3e}); |lse - "
            f"plain| {lerr:.3e}")
        res, x = compare_backward(case, gen, None, tables=tables)
        log_backward_path(label, shape, dtype, res)
        err[dtype] = dict(o=o_err, **{n: res[n][0] for n in ("dq", "dk",
                                                             "dv")})
    timing = backward_timing(x, before)
    timing["block_sparse_fwd"] = kernel_timing(
        (x["q"], x["k"], x["v"], x["col"], x["nvalid"], x["kw"]),
        f"{label}'s shape", before)
    checks = {"block_sparse_fwd": ("o",), "block_sparse_dq": ("dq",),
              "block_sparse_dkv": ("dk", "dv")}
    out = {}
    for name, t in timing.items():
        out[name] = dict(
            shape=dict(shape, causal=causal),
            max_abs_err=max(err["bfloat16"][g] for g in checks[name]),
            max_abs_err_fp32=max(err["float32"][g] for g in checks[name]),
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "before_ms") if k in t})
    return out


def phase_rwkv6():
    """rwkv6-7b at full width and depth, bf16, seeded random weights:
      - ServeEngine(spion=...), ServeEngine(paged=True) and
        make_serve_step(spion=True) raise NotImplementedError before the
        card's allocated memory moves;
      - the default engine (contiguous, the registry's
        supports_paged_cache) serves four prompts stepwise, 16 tokens
        each: tokens and logits finite, no kernel launched;
      - at 2 layers in fp32, every teacher-forced decode step of 256 tokens
        within TOL_RECURRENT of the chunked forward.
    The parameters are freed at the end."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.registry import build

    t_phase = time.perf_counter()
    cfg = get_config("rwkv6-7b")
    check(cfg.family == "ssm" and cfg.num_layers == 32 and
          cfg.d_model == 4096 and cfg.num_heads == 64 and
          cfg.resolved_head_dim == 64 and cfg.d_ff == 14336 and
          cfg.vocab_size == 65536 and cfg.dtype == "bfloat16",
          "rwkv6-7b config changed")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    rng = np.random.default_rng(SEED + 10)
    t0 = time.perf_counter()
    params = build(cfg).init(gen, device=DEVICE)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"rwkv6-7b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}: {nparams} parameters ({nbytes / 1e9:.2f} "
        f"GB) initialised on the card in {time.perf_counter() - t0:.1f} s")
    nrb = 2048 // 128
    plan = random_plan(rng, cfg.num_layers, nrb, 128)[2]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    refused = []
    for what, make in (
            ("ServeEngine(spion=plan)", lambda: ServeEngine(
                cfg, params, slots=4, max_len=2048, spion=plan,
                device=DEVICE)),
            ("ServeEngine(paged=True)", lambda: ServeEngine(
                cfg, params, slots=4, max_len=2048, paged=True,
                device=DEVICE)),
            ("make_serve_step(spion=True)",
             lambda: make_serve_step(cfg, spion=True))):
        try:
            make()
        except NotImplementedError as e:
            refused.append(what)
            log(f"rwkv6 refuses {what}: {str(e)[:90]}...")
        torch.cuda.synchronize()
        check(torch.cuda.memory_allocated() == held,
              f"{what} allocated {torch.cuda.memory_allocated() - held} "
              f"bytes before it raised")
    check(len(refused) == 3, f"rwkv6-7b refused only {refused}")
    prompts = stepwise_requests(rng, cfg, RECURRENT_PROMPTS)
    run = serve_stepwise(cfg, params, prompts)
    eng = run.pop("eng")
    check(not eng.paged and eng._prefill is None,
          "the rwkv6-7b engine is paged or built a fused prefill")
    check(not run["bad"], "an rwkv6-7b logit is not finite")
    check(all(0 <= t < cfg.vocab_size for r in run["reqs"] for t in r.out),
          "an rwkv6-7b token is out of the vocabulary")
    del eng
    step_ms, decode_ms = log_stepwise_serving("rwkv6-7b, dense, contiguous",
                                               run, None, None)
    long_ms, state_bytes = long_context_decode(cfg, params)
    del params, run
    torch.cuda.empty_cache()
    cfg2 = cfg.replace(num_layers=2, dtype="float32")
    p2 = build(cfg2).init(torch.Generator(device=DEVICE)
                          .manual_seed(SEED + 11), device=DEVICE)
    gaps, mean_logit = decode_against_forward(cfg2, p2, None, SEED + 11)
    log(f"rwkv6 decode vs chunked forward (fp32, 2 layers, 256 tokens = 2 "
        f"chunks; card {card_line()}): max |logit gap| {gaps.max():.3e} "
        f"(step {int(gaps.argmax())}), mean over steps {gaps.mean():.3e}; "
        f"limit {TOL_RECURRENT}; mean |logit| {mean_logit:.4e}")
    check(math.isfinite(float(gaps.max())) and gaps.max() <= TOL_RECURRENT,
          f"rwkv6 decode logits differ from the chunked forward by "
          f"{gaps.max()}")
    del p2
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"rwkv6: the phase took {seconds:.1f} s")
    return dict(step_ms=step_ms, decode_ms=decode_ms, gap32=float(gaps.max()),
                seconds=seconds, long_ms=long_ms, state_bytes=state_bytes)


def load_example(name):
    """examples/<name>.py of this checkout as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def long_context_decode(cfg, params):
    """Phase 4d's long-context decode: examples/long_context_decode_torch.py's
    loop at full width on 4d's parameters (B 1, init_cache(1, max_len=1),
    a warm-up step, then TOKENS decode steps from each virtual position),
    its state's bytes and ms a token printed; from one state and token the
    logits at positions 1,000 and 524,288 are bitwise equal (decode_step
    does not read the position). Returns ({position: ms}, bytes)."""
    import torch
    from repro_torch.models.registry import build
    ex = load_example("long_context_decode_torch")
    full = ex.decode_config(full=True)
    check(full.replace(remat=cfg.remat) == cfg,
          "the example's full rwkv6-7b is not phase 4d's")
    bundle = build(full)
    cache = bundle.init_cache(1, max_len=1, device=DEVICE)
    nbytes = ex.state_bytes(cache)
    tok = torch.zeros((1, 1), dtype=torch.long, device=DEVICE)
    ms, _ = ex.decode_positions(bundle, params, cache, tok)
    logits = []
    with torch.no_grad():
        for pos in (ex.POSITIONS[0], ex.POSITIONS[-1]):
            state = {k: v.clone() for k, v in cache.items()}
            logits.append(bundle.decode_step(params, state, tok, pos)[0])
    same = torch.equal(logits[0], logits[1])
    log(f"rwkv6 long-context decode (examples/long_context_decode_torch.py "
        f"at full width, B 1): recurrent state {nbytes} bytes; "
        + ", ".join(f"context {p:,} {t:.3f} ms/token" for p, t in ms.items())
        + f" ({ex.TOKENS} tokens each, host time to a synchronize); logits at "
        f"{ex.POSITIONS[0]:,} and {ex.POSITIONS[-1]:,} from one state "
        f"{'bitwise equal' if same else 'DIFFER'} ({card_line()})")
    check(same, "rwkv6 decode logits depend on the position")
    check(all(math.isfinite(t) for t in ms.values()),
          "the long-context decode did not time")
    return {str(p): t for p, t in ms.items()}, nbytes


# -- the encoder-decoder and vision-language families: whisper-tiny, internvl2-2b

WHISPER_BATCH = 4
WHISPER_ENC = 1500          # encoder frames of a 30 s window
WHISPER_S = 448             # decoder tokens: 7 blocks of 64
WHISPER_DECODE_S = 128      # tokens of the fp32 decode check (2 blocks)
INTERNVL_BATCH = 2
INTERNVL_S = 2048           # 256 patch embeddings + 1792 text tokens
TEXT_PROMPTS = (16, 48)     # prompts of these engines, TEXT_NEW tokens each
TEXT_NEW = 8
# fp32 teacher-forced decode against the forward, max |logit gap| over
# every step: whisper-tiny at full depth (contiguous and paged, dense and
# sparse) and internvl2-2b at 2 layers. Sound readings must lie below it,
# whisper's two planted faults (the cross K/V of the previous layer; the
# encoder's positions one off) above it. On one H100 sound runs read
# 2.146e-6 to 2.384e-6 (whisper) and 1.359e-5 (internvl2); the planted
# faults 1.433e-2 (positions) and 2.382 (cross K/V) (PERF.md, Findings)
TOL_DECODE = 2e-4
# internvl2's loss against cross-entropy over the text logits taken apart
# (the same forward twice), relative
TOL_LOSS_SPLIT = 1e-6
# covering_gate's limit on the bf16 gradients that dq and dk feed (wq, wk,
# bq, bk, the attention's input norm), as a multiple of dense bf16
# attention's distance from fp32 dense: the op's backward takes delta =
# rowsum(dO * O) from the bf16 output, as the JAX package's does, so where
# attention is near uniform (random weights) the small ds = p (dp - delta)
# carries that rounding. The other leaves keep BF16_LOGITS_SLACK. Each
# cell's limit lies between its own sound reading and its smallest control
# that must be rejected. On one H100 the worst of those leaves read, by
# mean/rms: whisper-tiny 1.3714x sound (wq), q and k at 3 significand bits
# 4.1143x, dq, dk and dv at 3 bits 2.7297x and at 1 bit 9.3488x;
# internvl2-2b 0.9234x sound (attn_norm), q and k at 3 bits 3.9390x, dq,
# dk and dv at 3 bits 1.0940x and at 1 bit 2.4792x (PERF.md, Findings)
WHISPER_QK_GRAD_SLACK = 2.0
INTERNVL2_QK_GRAD_SLACK = BF16_LOGITS_SLACK
COVERING_CONTROLS_DECODER = (("scores", 3, True), ("scores", 1, True),
                             ("backward", 3, False), ("backward", 1, True))
# the dense configs' attention shapes (S 2048, hd 128, block 128, causal,
# one sequence of 8 KV heads): (arch, G)
DENSE_SHAPES = (("qwen2.5-14b", 5), ("command-r-35b", 8),
                ("mistral-large-123b", 12))
DENSE_S = 2048


@contextlib.contextmanager
def shifted_encoder_positions():
    """A planted fault: while open, the encoder's sinusoidal table starts at
    position 1 instead of 0."""
    from repro_torch.models import layers as Lyr
    sound = Lyr.sinusoidal_positions

    def shifted(length, d, device="cpu"):
        return sound(length + 1, d, device)[1:]
    Lyr.sinusoidal_positions = shifted
    try:
        yield
    finally:
        Lyr.sinusoidal_positions = sound


def encdec_decode_check(cfg, params, col, nvalid, seed):
    """fp32 whisper at full depth: the forward of WHISPER_DECODE_S tokens
    of 2 sequences over WHISPER_ENC frames against teacher-forced decode
    after precompute_cross, contiguous and paged (page = block), dense and
    sparse (the plan's first row blocks); then two planted faults through
    the contiguous dense decode: the cross K/V of the previous decoder
    layer, and the encoder's positions one off. Returns {reading: max
    |logit gap| over every step} and the forward's mean |logit|."""
    import numpy as np
    import torch
    from repro_torch.core.attention_exec import SparseAttentionExec
    from repro_torch.core.kv_pool import PagePool
    from repro_torch.models import encdec
    from repro_torch.models.registry import build
    rng = np.random.default_rng(seed)
    B, S, block = 2, WHISPER_DECODE_S, cfg.spion.block_size
    nr = S // block
    frames = torch.as_tensor(
        rng.standard_normal((B, WHISPER_ENC, cfg.d_model), np.float32),
        device=DEVICE)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(B, S)),
                           device=DEVICE)
    tabs = dict(col_idx=col[:, :nr], nvalid=nvalid[:, :nr], block=block)
    bundle = build(cfg)
    dex = SparseAttentionExec(tabs, block=block, phase="decode").to(DEVICE)
    with torch.inference_mode():
        fwd = {sparse: bundle.forward(
            params, {"frames": frames, "tokens": toks},
            spion=tabs if sparse else None)[0].float()
            for sparse in (False, True)}
        ck, cv = encdec.precompute_cross(params, cfg, frames)
        with shifted_encoder_positions():
            sck, scv = encdec.precompute_cross(params, cfg, frames)

        def gap(paged, sparse, ck, cv):
            if paged:
                pool = PagePool(layers=cfg.num_layers, num_pages=1 + B * nr,
                                page=block, kv_heads=cfg.num_kv_heads,
                                head_dim=cfg.resolved_head_dim,
                                dtype=torch.float32, device=DEVICE)
                pt = torch.arange(1, 1 + B * nr, dtype=torch.int32,
                                  device=DEVICE).reshape(B, nr)
                cache = {"kv": pool.cache(pt), "ck": ck, "cv": cv}
            else:
                cache = dict(bundle.init_cache(B, S, device=DEVICE), ck=ck,
                             cv=cv)
            gaps = []
            for t in range(S):
                lg, cache = bundle.decode_step(params, cache,
                                               toks[:, t:t + 1], t,
                                               spion=dex if sparse else None)
                gaps.append((lg.float() - fwd[sparse][:, t]).abs().max())
            return torch.stack(gaps).max().item()
        out = {f"{'paged' if paged else 'contiguous'} "
               f"{'sparse' if sparse else 'dense'}": gap(paged, sparse, ck, cv)
               for paged in (False, True) for sparse in (False, True)}
        out["planted: cross K/V of the previous layer"] = gap(
            False, False, ck.roll(1, 0), cv.roll(1, 0))
        out["planted: encoder positions one off"] = gap(False, False, sck,
                                                        scv)
    return out, fwd[False].abs().mean().item()


def phase_whisper(before=None):
    """whisper-tiny at full width and depth (4 encoder and 4 decoder
    layers, d_model 384, 6 heads of 64), bf16, with a random causal plan of
    one block mask per decoder layer (block 64 over WHISPER_S positions):
      - a sparse forward of WHISPER_BATCH x (WHISPER_ENC frames,
        WHISPER_S tokens) launches the forward kernel once per decoder
        layer (4); a sparse train step (make_loss_and_grads, remat: each
        layer recomputed) 8 forward, 4 dQ and 4 dK/dV kernels;
      - forward(capture=) gives finite pooled maps, SpionController turns
        them into a plan, and one train step runs on it (8 + 4 + 4);
      - covering_gate on the decoder's self-attention leaves (those dq
        and dk feed at WHISPER_QK_GRAD_SLACK) with COVERING_CONTROLS_DECODER;
      - the three kernels against their plain versions and timed at this
        shape (N 24, G 1, hd 64, block 64, S 448, causal);
      - at full depth in fp32, teacher-forced decode within TOL_DECODE of
        the forward, contiguous and paged, dense and sparse; two planted
        faults past it (encdec_decode_check);
      - ServeEngine(slots=4, max_len=512, spion=plan), paged with page 64:
        four prompts of TEXT_PROMPTS tokens prefilled stepwise (no launch),
        TEXT_NEW tokens each, equal to a paged=False engine's; its cross
        K/V at max_len and zero, as the reference engine leaves them.
    Returns the launches of the sparse forward and train step, the kernel
    records at this shape and the phase's readings."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.spion import SpionController, SpionState
    from repro_torch.launch.steps import make_loss_and_grads
    from repro_torch.models.registry import build

    t_phase = time.perf_counter()
    cfg = get_config("whisper-tiny")
    L, block = cfg.num_layers, cfg.spion.block_size
    check(cfg.family == "audio" and cfg.encoder_layers == 4 and L == 4 and
          cfg.d_model == 384 and cfg.num_heads == cfg.num_kv_heads == 6 and
          cfg.resolved_head_dim == 64 and cfg.d_ff == 1536 and
          cfg.vocab_size == 51865 and cfg.remat and
          cfg.dtype == "bfloat16" and block == 64,
          "whisper-tiny config changed")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    rng = np.random.default_rng(SEED + 12)
    t0 = time.perf_counter()
    params = build(cfg).init(gen, device=DEVICE)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in params.parameters())
    log(f"whisper-tiny: {cfg.encoder_layers} encoder and {L} decoder "
        f"layers, d_model {cfg.d_model}, {cfg.num_heads} heads of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: "
        f"{nparams} parameters (the 65,536-row learned position table "
        f"included) initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    nrb = WHISPER_S // block
    col, nvalid, plan = random_plan(rng, L, nrb, block)
    log(f"whisper plan: {L} decoder layers x {nrb} row-blocks of {block}, "
        f"K={col.shape[-1]}, density "
        f"{np.mean(plan.stats['per_layer_density']):.3f}")
    frames = torch.randn((WHISPER_BATCH, WHISPER_ENC, cfg.d_model),
                         generator=gen, device=DEVICE)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        size=(WHISPER_BATCH, WHISPER_S + 1)),
                           device=DEVICE)
    batch = {"frames": frames, "tokens": toks[:, :-1], "labels": toks[:, 1:]}

    main = sparse_forward_and_step(
        "whisper-tiny", cfg, params, plan, batch,
        fwd={"block_sparse_fwd": L, "block_sparse_dq": 0,
             "block_sparse_dkv": 0},
        step=sparse_launches(cfg), leaf="dec_layers.attn.wq")
    masters = main.pop("masters")

    # capture -> flood fill -> plan -> one train step on it
    ctl = SpionController(cfg.spion, causal=True, seq_len=WHISPER_S)
    state = SpionState()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        _, aux = build(cfg).forward(
            params, {"frames": frames, "tokens": batch["tokens"]},
            capture=ctl.capture_kwargs(state))
    pooled, frob = (t.float().cpu() for t in aux["captured"])
    capture_ms = 1e3 * (time.perf_counter() - t0)
    check(tuple(pooled.shape) == (L, nrb, nrb) and
          bool(torch.isfinite(pooled).all()) and
          bool(torch.isfinite(frob).all()) and pooled.sum().item() > 0,
          f"whisper capture: {tuple(pooled.shape)}, finite "
          f"{bool(torch.isfinite(pooled).all())}")
    t0 = time.perf_counter()
    state = ctl.generate(state, pooled.numpy())
    fill_ms = 1e3 * (time.perf_counter() - t0)
    cex = ctl.attention_exec(state, dtype=cfg.dtype).to(DEVICE)
    reset_launch_counts()
    loss, grads = make_loss_and_grads(cfg)(masters, batch, cex)
    torch.cuda.synchronize()
    launched = launch_counts()
    check(launched == sparse_launches(cfg) and math.isfinite(loss.item())
          and all(bool(torch.isfinite(g).all()) for g in grads.values()),
          f"the train step on the captured plan launched {launched}, loss "
          f"{loss.item()}")
    log(f"whisper capture -> plan: {L} pooled maps of {nrb} x {nrb} "
        f"(Frobenius {', '.join(f'{f:.4f}' for f in frob.sqrt())}) in "
        f"{capture_ms:.1f} ms, flood fill {fill_ms:.1f} ms, density "
        f"{state.density:.3f}, K={state.tables['col_idx'].shape[-1]}; a "
        f"train step on it: loss {loss.item():.6f}, launches {launched}")
    del grads, loss

    covering = covering_gate(
        "whisper-tiny", cfg, masters, batch, layers=L,
        leaves=("dec_layers.attn.", "dec_layers.attn_norm."),
        controls=COVERING_CONTROLS_DECODER, qk_slack=WHISPER_QK_GRAD_SLACK)
    del masters
    torch.cuda.empty_cache()
    kernels = path_kernels(
        "whisper-tiny", dict(N=WHISPER_BATCH * cfg.num_kv_heads,
                             G=cfg.num_heads // cfg.num_kv_heads,
                             S=WHISPER_S, hd=cfg.resolved_head_dim,
                             block=block),
        (col[0], nvalid[0]), "decoder layer 0's", SEED + 13, before)

    prompts = stepwise_requests(rng, cfg, TEXT_PROMPTS)
    runs = {}
    for name, kw in (("paged", dict(spion=plan)),
                     ("contiguous", dict(spion=plan, paged=False))):
        runs[name] = serve_stepwise(cfg, params, prompts, max_len=512,
                                    max_new=TEXT_NEW, **kw)
        eng = runs[name].pop("eng")
        check(not runs[name]["bad"], f"a {name} whisper logit is not finite")
        cross = eng._extra_cache if eng.paged else eng.cache
        want = (L, 4, 512, cfg.num_kv_heads, cfg.resolved_head_dim)
        check(all(tuple(cross[k].shape) == want and not cross[k].any()
                  for k in ("ck", "cv")),
              f"the {name} whisper engine's cross K/V are "
              f"{tuple(cross['ck'].shape)}, not zeros of {want}")
        if name == "paged":
            check(eng.paged and eng.page == block and eng._prefill is None
                  and not eng.share_prefix,
                  f"the whisper engine: paged {eng.paged}, page {eng.page}, "
                  f"share_prefix {eng.share_prefix}")
        del eng
    same = [a.out == b.out for a, b in zip(runs["paged"]["reqs"],
                                           runs["contiguous"]["reqs"])]
    step_tok_ms, decode_ms = log_stepwise_serving(
        "whisper-tiny, sparse, paged (cross K/V zero, as the reference "
        "engine serves it)", runs["paged"], ("the contiguous",
                                             runs["contiguous"]), same)
    check(all(same), "the paged whisper engine's tokens differ from the "
          "contiguous engine's")
    del params, runs
    torch.cuda.empty_cache()

    cfg32 = cfg.replace(dtype="float32")
    p32 = build(cfg32).init(torch.Generator(device=DEVICE)
                            .manual_seed(SEED + 14), device=DEVICE)
    gaps, mean_logit = encdec_decode_check(cfg32, p32, col, nvalid,
                                           SEED + 14)
    sound = {k: v for k, v in gaps.items() if not k.startswith("planted")}
    planted = {k: v for k, v in gaps.items() if k.startswith("planted")}
    log(f"whisper decode vs forward (fp32, full depth, 2 x "
        f"{WHISPER_DECODE_S} tokens over {WHISPER_ENC} frames; card "
        f"{card_line()}): max |logit gap| "
        + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
        + f"; limit {TOL_DECODE}; mean |logit| {mean_logit:.4e}")
    check(all(math.isfinite(v) and v <= TOL_DECODE for v in sound.values()),
          f"whisper decode logits differ from the forward: {sound}")
    check(all(v > TOL_DECODE for v in planted.values()),
          f"TOL_DECODE passes a planted whisper decode fault: {planted}")
    del p32
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"whisper: the phase took {seconds:.1f} s")
    return dict(launches={k: main["fwd_launches"][k]
                          + main["step_launches"][k] for k in KERNELS},
                kernels=kernels, fwd_ms=main["fwd_ms"],
                train_ms=main["train_ms"], peak_gb=main["peak_gb"],
                step_ms=step_tok_ms, decode_ms=decode_ms,
                gap32=max(sound.values()), planted=min(planted.values()),
                covering=covering, seconds=seconds)


def phase_internvl2(before=None):
    """internvl2-2b at full width and depth (24 layers, d_model 2048, 16
    query heads over 8 KV heads of 128, 256 patch tokens), bf16, with a
    random causal plan per layer (block 64 over INTERNVL_S positions):
      - a sparse forward of INTERNVL_BATCH x (256 patch embeddings + 1792
        text tokens) launches the forward kernel 24 times; a sparse train
        step (remat) 48 forward, 24 dQ and 24 dK/dV kernels; its peak
        memory printed;
      - the loss equals cross-entropy over the text logits taken apart
        (TOL_LOSS_SPLIT);
      - covering_gate on the attention leaves, as in phase_whisper but
        with INTERNVL2_QK_GRAD_SLACK for those dq and dk feed;
      - the three kernels against their plain versions and timed at this
        shape (N 16, G 2, hd 128, block 64, S 2048, causal);
      - ServeEngine(slots=4, max_len=2048, spion=plan): four text prompts
        of TEXT_PROMPTS tokens prefilled stepwise (no launch; the engine
        serves text only, as the reference's), TEXT_NEW tokens each; the
        paged engine's tokens equal the contiguous one's;
      - at 2 layers in fp32, teacher-forced decode of 256 text tokens
        within TOL_DECODE of the sparse forward."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.attention_exec import SparseAttentionExec
    from repro_torch.models.registry import build, cross_entropy

    t_phase = time.perf_counter()
    cfg = get_config("internvl2-2b")
    L, block, P = cfg.num_layers, cfg.spion.block_size, cfg.num_patch_tokens
    check(cfg.family == "vlm" and L == 24 and cfg.d_model == 2048 and
          cfg.num_heads == 16 and cfg.num_kv_heads == 8 and
          cfg.resolved_head_dim == 128 and cfg.d_ff == 8192 and
          cfg.vocab_size == 92553 and P == 256 and not cfg.tie_embeddings
          and cfg.remat and cfg.dtype == "bfloat16" and block == 64,
          "internvl2-2b config changed")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 15)
    rng = np.random.default_rng(SEED + 15)
    t0 = time.perf_counter()
    bundle = build(cfg)
    params = bundle.init(gen, device=DEVICE)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"internvl2-2b: {L} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} query heads over {cfg.num_kv_heads} KV heads of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{P} patch tokens: {nparams} parameters ({nbytes / 1e9:.2f} GB) "
        f"initialised on the card in {time.perf_counter() - t0:.1f} s")
    nrb = INTERNVL_S // block
    col, nvalid, plan = random_plan(rng, L, nrb, block)
    log(f"internvl2 plan: {L} layers x {nrb} row-blocks of {block}, "
        f"K={col.shape[-1]}, density "
        f"{np.mean(plan.stats['per_layer_density']):.3f}")
    T = INTERNVL_S - P
    patches = torch.randn((INTERNVL_BATCH, P, cfg.d_model), generator=gen,
                          device=DEVICE)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        size=(INTERNVL_BATCH, T + 1)),
                           device=DEVICE)
    batch = {"patch_embeds": patches, "tokens": toks[:, :-1],
             "labels": toks[:, 1:]}

    main = sparse_forward_and_step(
        "internvl2-2b", cfg, params, plan, batch,
        fwd={"block_sparse_fwd": L, "block_sparse_dq": 0,
             "block_sparse_dkv": 0},
        step=sparse_launches(cfg), leaf="layers.attn.wq")
    masters = main.pop("masters")

    ex = SparseAttentionExec.from_plan(plan, phase="prefill",
                                       dtype=cfg.dtype).to(DEVICE)
    with torch.inference_mode():
        logits, _ = bundle.forward(params, batch, spion=ex)
        apart = cross_entropy(logits[:, P:], batch["labels"]).item()
        loss = bundle.loss(params, batch, spion=ex)[0].item()
    split_gap = abs(loss - apart) / abs(apart)
    log(f"internvl2 loss over the text: {loss:.6f}; cross-entropy over "
        f"logits[:, {P}:] of the {tuple(logits.shape)} logits "
        f"{apart:.6f}; relative gap {split_gap:.3e} (limit "
        f"{TOL_LOSS_SPLIT})")
    check(tuple(logits.shape) == (INTERNVL_BATCH, INTERNVL_S, cfg.vocab_size)
          and split_gap <= TOL_LOSS_SPLIT,
          f"internvl2's loss {loss} is not cross-entropy over the text "
          f"logits ({apart})")
    del logits

    covering = covering_gate(
        "internvl2-2b", cfg, masters, batch, layers=L,
        leaves=("layers.attn.", "layers.attn_norm."),
        controls=COVERING_CONTROLS_DECODER, qk_slack=INTERNVL2_QK_GRAD_SLACK)
    del masters
    torch.cuda.empty_cache()
    kernels = path_kernels(
        "internvl2-2b", dict(N=INTERNVL_BATCH * cfg.num_kv_heads,
                             G=cfg.num_heads // cfg.num_kv_heads,
                             S=INTERNVL_S, hd=cfg.resolved_head_dim,
                             block=block),
        (col[0], nvalid[0]), "layer 0's", SEED + 16, before)

    prompts = stepwise_requests(rng, cfg, TEXT_PROMPTS)
    runs = {}
    for name, kw in (("paged", dict(spion=plan)),
                     ("contiguous", dict(spion=plan, paged=False))):
        runs[name] = serve_stepwise(cfg, params, prompts, max_new=TEXT_NEW,
                                    **kw)
        eng = runs[name].pop("eng")
        check(not runs[name]["bad"], f"a {name} internvl2 logit is not "
              f"finite")
        if name == "paged":
            check(eng.paged and eng.page == block and eng._prefill is None
                  and not eng.share_prefix and eng._extra_cache == {},
                  f"the internvl2 engine: paged {eng.paged}, page "
                  f"{eng.page}, share_prefix {eng.share_prefix}, extra "
                  f"state {list(eng._extra_cache)}")
        del eng
    same = [a.out == b.out for a, b in zip(runs["paged"]["reqs"],
                                           runs["contiguous"]["reqs"])]
    step_tok_ms, decode_ms = log_stepwise_serving(
        "internvl2-2b, text only, sparse, paged", runs["paged"],
        ("the contiguous", runs["contiguous"]), same)
    check(all(same), "the paged internvl2 engine's tokens differ from the "
          "contiguous engine's")
    del params, runs, bundle
    torch.cuda.empty_cache()

    cfg2 = cfg.replace(num_layers=2, dtype="float32")
    p2 = build(cfg2).init(torch.Generator(device=DEVICE)
                          .manual_seed(SEED + 17), device=DEVICE)
    nr = DECODE_S // block
    tabs = dict(col_idx=col[:2, :nr], nvalid=nvalid[:2, :nr], block=block)
    gaps, mean_logit = decode_against_forward(cfg2, p2, tabs, SEED + 17)
    log(f"internvl2 decode vs forward (fp32, 2 layers, {DECODE_S} text "
        f"tokens, sparse; card {card_line()}): max |logit gap| "
        f"{gaps.max():.3e} (step {int(gaps.argmax())}), mean over steps "
        f"{gaps.mean():.3e}; limit {TOL_DECODE}; mean |logit| "
        f"{mean_logit:.4e}")
    check(math.isfinite(float(gaps.max())) and gaps.max() <= TOL_DECODE,
          f"internvl2 decode logits differ from the forward by {gaps.max()}")
    del p2
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"internvl2: the phase took {seconds:.1f} s")
    return dict(launches={k: main["fwd_launches"][k]
                          + main["step_launches"][k] for k in KERNELS},
                kernels=kernels, fwd_ms=main["fwd_ms"],
                train_ms=main["train_ms"], peak_gb=main["peak_gb"],
                step_ms=step_tok_ms, decode_ms=decode_ms,
                gap32=float(gaps.max()), covering=covering, seconds=seconds)


def phase_dense_shapes(before=None):
    """The forward kernel at the attention shapes of the three other dense
    configs (DENSE_SHAPES: one sequence of 8 KV heads, S 2048, hd 128,
    block 128, causal, random tables): against its plain version in fp32
    and bf16 (phase 3's gates), then timed (bf16) beside its bound and
    SDPA. Their model path is qwen2-7b's (phase 4). Returns {arch:
    record}."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 18)
    rng = np.random.default_rng(SEED + 18)
    out = {}
    for arch, G in DENSE_SHAPES:
        cfg = get_config(arch)
        shape = dict(N=cfg.num_kv_heads, G=G, S=DENSE_S,
                     hd=cfg.resolved_head_dim, block=cfg.spion.block_size)
        check(cfg.num_heads // cfg.num_kv_heads == G and
              cfg.num_kv_heads == 8 and shape["hd"] == 128 and
              shape["block"] == 128, f"{arch} config changed")
        nrb = shape["S"] // shape["block"]
        tables = random_tables(rng, nrb, nrb, causal=True, pad=0)
        err = {}
        for dtype in ("float32", "bfloat16"):
            err[dtype], tol, share, typical, lerr, inputs = compare_kernel(
                dict(dtype=dtype, causal=True, **shape), gen, None,
                tables=tables)
            log(f"kernel at {arch}'s shape {shape} {dtype} causal "
                f"({int(tables[1].sum())} listed tiles): |o - plain| = "
                f"{err[dtype]:.3e} (that element's limit {tol:.3e}; no "
                f"element past {share:.3f} of its limit; mean |o| "
                f"{typical:.3e}); |lse - plain| {lerr:.3e}")
        t = kernel_timing(inputs, f"{arch}'s shape", before)
        out[arch] = dict(
            shape=dict(shape, causal=True), max_abs_err=err["bfloat16"],
            max_abs_err_fp32=err["float32"],
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "before_ms") if k in t})
        del inputs
    return out


# -- training ------------------------------------------------------------------

TRAIN_STEPS = 20
STEPS_PER_EPOCH = 4


def launch_counts():
    from repro_torch.kernels import block_sparse_attn as bsa
    return {name: getattr(bsa, name).launches for name in KERNELS}


def reset_launch_counts():
    from repro_torch.kernels import block_sparse_attn as bsa
    for name in KERNELS:
        getattr(bsa, name).launches = 0


def listops_data_fn(batch, seq_len):
    """data_fn(step): a ListOps batch of `batch` sequences of seq_len + 1
    tokens from the grammar, seeded by (SEED, step); next-token targets."""
    import numpy as np
    from repro_torch.data.listops import make_listops_batch

    def data_fn(step):
        rng = np.random.default_rng([SEED, step])
        xs, _ = make_listops_batch(rng, batch, seq_len + 1)
        return {"tokens": xs[:, :-1], "labels": xs[:, 1:]}
    return data_fn


def lra_config():
    """spion-lra at its published width with the smoke's phase schedule
    (min/max dense epochs 1/3), and the LRA ListOps preset."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.spion_lra import LRA_TASKS
    task = LRA_TASKS["listops"]
    cfg = get_config("spion-lra")
    check(cfg.num_layers == 4 and cfg.d_model == 64 and cfg.num_heads == 4
          and cfg.spion.block_size == task["block_size"] and cfg.remat,
          "spion-lra config changed")
    cfg = cfg.replace(spion=dataclasses.replace(
        cfg.spion, min_dense_epochs=1, max_dense_epochs=3))
    return cfg, task


def lra_trainer(**kw):
    """Trainer of spion-lra under the ListOps preset on the card, from the
    seed; `kw` adds to the Trainer's arguments (ckpt_dir, chaos, ...)."""
    from repro_torch.launch.train import Trainer
    cfg, task = lra_config()
    S, B = task["seq_len"], task["batch"]
    data_fn = listops_data_fn(B, S)
    tr = Trainer(cfg, seq_len=S, batch=B, steps_per_epoch=STEPS_PER_EPOCH,
                 data_fn=data_fn, seed=SEED, device=DEVICE, **kw)
    return tr, cfg, data_fn


def record_steps(tr):
    """Wrap tr._one_step so that every step appends {phase, s, loss,
    launches} to the returned list: its phase, host seconds to the end of
    its device work, loss and the kernels it launched. Returns (records,
    undo)."""
    import torch
    steps, inner = [], tr._one_step

    def one_step(batch):
        phase = tr.spion_state.phase
        before = launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = inner(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        after = launch_counts()
        steps.append(dict(phase=phase, s=dt, loss=float(metrics["loss"]),
                          launches={k: after[k] - before[k] for k in after}))
        return metrics

    def undo():
        tr._one_step = inner
    tr._one_step = one_step
    return steps, undo


def sparse_launches(cfg):
    """Kernel launches of one sparse step: the forward runs once per layer
    in the forward and once more per layer when remat recomputes the layer
    in the backward; dQ and dK/dV run once per layer."""
    L = cfg.num_layers
    return {"block_sparse_fwd": (2 if cfg.remat else 1) * L,
            "block_sparse_dq": L, "block_sparse_dkv": L}


def phase_train():
    """Three-phase SPION training of spion-lra at its published width under
    the LRA ListOps preset, through launch/train.Trainer on the card."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    tr, cfg, data_fn = lra_trainer()
    S, B, L = tr.seq_len, lra_config()[1]["batch"], cfg.num_layers
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in tr.params.parameters())
    log(f"spion-lra: {L} layers, d_model {cfg.d_model}, {cfg.num_heads} "
        f"heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, remat {cfg.remat}, "
        f"{cfg.dtype} over fp32 masters: {nparams} parameters; ListOps "
        f"seq_len {S}, batch {B}; trainer ready in "
        f"{time.perf_counter() - t0:.1f} s")
    init = {n: p.detach().clone() for n, p in tr.params.named_parameters()}

    captures, fills, pooled = [], [], []
    inner_capture = tr.capture
    inner_generate = tr.spion_ctl.generate

    def capture(batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner_capture(batch)
        torch.cuda.synchronize()
        captures.append(time.perf_counter() - t)
        pooled.append(out[0].float().cpu().numpy())   # phase 12d's reference
        return out

    def generate(state, pooled):
        t = time.perf_counter()
        out = inner_generate(state, pooled)
        fills.append(time.perf_counter() - t)
        return out

    steps, undo = record_steps(tr)
    tr.capture, tr.spion_ctl.generate = capture, generate
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = tr.train(TRAIN_STEPS, log_every=STEPS_PER_EPOCH,
                      log=lambda m: log(f"  train: {m}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = launch_counts()
    undo()
    tr.capture, tr.spion_ctl.generate = inner_capture, inner_generate

    st = tr.spion_state
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
          f"a training loss is not finite: {losses}")
    check(st.phase == "sparse", f"training ended in phase {st.phase}")
    check(st.density is not None and 0 < st.density < 1,
          f"plan density {st.density}")
    dense = [r for r in steps if r["phase"] == "dense"]
    sparse = [r for r in steps if r["phase"] == "sparse"]
    check(len(dense) <= 3 * STEPS_PER_EPOCH and
          len(sparse) >= TRAIN_STEPS - 3 * STEPS_PER_EPOCH,
          f"{len(dense)} dense and {len(sparse)} sparse steps")
    want = sparse_launches(cfg)
    for r in dense:
        check(not any(r["launches"].values()),
              f"a dense step launched a sparse kernel: {r['launches']}")
    for r in sparse:
        check(r["launches"] == want, f"a sparse step launched "
              f"{r['launches']}, not {want}")
    check(launches == {k: n * len(sparse) for k, n in want.items()},
          f"launches over the run {launches}")
    moved = max((p.detach() - init[n]).abs().max().item()
                for n, p in tr.params.named_parameters())
    check(moved > 0, "training did not change the parameters")

    def ms(rs):
        xs = [1e3 * r["s"] for r in rs]
        return float(np.median(xs)), float(sum(xs)), len(xs)
    d_med, d_tot, d_n = ms(dense[1:])      # the first step pays for warm-up
    s_med, s_tot, s_n = ms(sparse[1:])
    stats = st.plan_stats
    log(f"train: {TRAIN_STEPS} steps in {wall:.2f} s; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; phase {st.phase} after "
        f"{len(dense)} dense steps; plan density {st.density:.4f} "
        f"(per layer {stats['per_layer_density']}), K {stats['K']}, KT* "
        f"{stats['kt_star']}; launches {launches} ({want} per sparse step); "
        f"peak device memory {peak_gb:.2f} GB")
    log(f"train steps: dense {d_med:.2f} ms median, {d_n} steps after the "
        f"first {d_tot:.2f} ms ({d_tot / d_n:.2f} ms each), first "
        f"{1e3 * dense[0]['s']:.2f} ms; sparse {s_med:.2f} ms median, "
        f"{s_n} steps after the first {s_tot:.2f} ms ({s_tot / s_n:.2f} ms "
        f"each), first {1e3 * sparse[0]['s']:.2f} ms; capture "
        f"{', '.join(f'{1e3 * c:.2f}' for c in captures)} ms; host flood "
        f"fill and plan {', '.join(f'{1e3 * f:.2f}' for f in fills)} ms")
    profile_sparse_step(tr, tr._one_step)
    return dict(trainer=tr, cfg=cfg, launches=launches, dense_ms=d_med,
                sparse_ms=s_med, data_fn=data_fn, losses=losses,
                dense_steps=len(dense), pooled=pooled)


def profile_sparse_step(tr, step_fn):
    """torch.profiler device time of one sparse train step, and the share
    of the three kernels in it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    batch = tr._next_batch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step_fn(batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    check(rows, "the profiler saw no device time in the sparse step")
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    share = {}
    for name in KERNELS:
        share[name] = sum(e.self_device_time_total for e in rows
                          if f"{name}_kernel" in e.key) / 1e3
    log(f"profile sparse train step: {wall:.2f} ms on the host clock under "
        f"the profiler; device busy {busy:.2f} ms (idle share "
        f"{max(0.0, 1 - busy / wall):.3f}); "
        + ", ".join(f"{n} {ms_:.3f} ms ({ms_ / busy:.3f})"
                    for n, ms_ in share.items()))
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
            f"{e.key[:90]}")


def phase_train_path_kernels(train, gen, before=None):
    """The three kernels at the training path's shape, on layer 0's tables
    of the trained plan: the forward (o and lse, where the Alg. 6
    correction for the unstored positions dominates the denominator at
    this density), dQ and dK/dV against their plain versions in fp32 and
    bf16, then timed (bf16, as the path runs them) beside their bounds."""
    st = train["trainer"].spion_state
    tables = (st.tables["col_idx"][0].cpu().numpy(),
              st.tables["nvalid"][0].cpu().numpy())
    out = {}
    for dtype in ("float32", "bfloat16"):
        case = dict(dtype=dtype, causal=False, **TRAIN_PATH)
        err, tol, share, typical, lerr, _ = compare_kernel(
            case, gen, None, tables=tables)
        log(f"kernel at the training path's shape {TRAIN_PATH} {dtype} "
            f"non-causal, trained layer-0 tables ({int(tables[1].sum())} "
            f"listed tiles): |o - plain| = {err:.3e} (that element's limit "
            f"{tol:.3e}; no element past {share:.3f} of its limit; mean |o| "
            f"{typical:.3e}); |lse - plain| {lerr:.3e} (tol {TOL_LSE})")
        res, x = compare_backward(case, gen, None, tables=tables)
        log_backward_path("training", TRAIN_PATH, dtype, res)
        out[dtype] = {n: res[n][0] for n in ("dq", "dk", "dv")}
        out[dtype]["o"] = err
    timing = backward_timing(x, before)
    timing["block_sparse_fwd"] = kernel_timing(
        (x["q"], x["k"], x["v"], x["col"], x["nvalid"], x["kw"]),
        "the training path's shape", before)
    return out, timing


COVER_BATCH = 32     # sequences in the covering-plan step check
TOL_LOSS_REL = 1e-5
TOL_STEP_GRAD = 1e-3


def phase_covering_step(train):
    """One train step's loss and gradients through a fully covering
    non-causal plan (the three kernels in every layer) against the dense
    step, from the trained masters and one ListOps batch: equal in fp32
    (every gradient element within TOL_STEP_GRAD); in bf16 both held
    against the fp32 dense gradients leaf by leaf, each layer's leaves
    split apart. On each layer's attention leaves (the projections, which
    take dq, dk, dv and o straight from the kernels, and the attention
    norm) the kernels' path may be at most BF16_LOGITS_SLACK x as far as
    the dense path, by max and by mean; the other leaves are printed."""
    import numpy as np
    import torch
    from repro_torch.core.attention_exec import SparseAttentionExec
    from repro_torch.core.sparse_attention import build_sparsity_plan
    from repro_torch.launch.steps import make_loss_and_grads
    tr, cfg = train["trainer"], train["cfg"]
    S, L, block = tr.seq_len, cfg.num_layers, cfg.spion.block_size
    nrb = S // block
    col = np.tile(np.arange(nrb, dtype=np.int32), (L, nrb, 1))
    plan = build_sparsity_plan(col, np.full((L, nrb), nrb, np.int32), block)
    cover = SparseAttentionExec.from_plan(plan).to(DEVICE)
    host = listops_data_fn(COVER_BATCH, S)(10_000)
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in host.items()}
    want = {"block_sparse_fwd": (2 if cfg.remat else 1) * L,
            "block_sparse_dq": L, "block_sparse_dkv": L}

    def run(dtype, tables):
        """The step's loss and {leaf: fp32 gradient}, a stacked per-layer
        tensor split into one leaf per layer ("layers.attn.wq[2]")."""
        fn = make_loss_and_grads(cfg.replace(dtype=dtype))
        before = launch_counts()
        loss, grads = fn(tr.params, batch, tables)
        torch.cuda.synchronize()
        got = {k: launch_counts()[k] - before[k] for k in before}
        check(got == (want if tables is not None else
                      dict.fromkeys(want, 0)),
              f"the {dtype} step launched {got}")
        leaves = {}
        for name, g in grads.items():
            g = g.float()
            if name == "pos_embed.w":
                g = g[:S]     # the positions past seq_len get no gradient
            if name.startswith("layers."):
                leaves.update({f"{name}[{i}]": g[i] for i in range(L)})
            else:
                leaves[name] = g
        return loss.item(), leaves

    ls32, gs32 = run("float32", cover)
    ld32, gd32 = run("float32", None)
    ls16, gs16 = run("bfloat16", cover)
    ld16, gd16 = run("bfloat16", None)
    rel = abs(ls32 - ld32) / abs(ld32)
    g32, worst = 0.0, {"gated": 0.0, "other": 0.0}
    for name, ref in gd32.items():
        d32 = (gs32[name] - ref).abs().max().item()
        g32 = max(g32, d32)
        es, ed = (gs16[name] - ref).abs(), (gd16[name] - ref).abs()
        es_max, es_mean = es.max().item(), es.mean().item()
        ed_max, ed_mean = ed.max().item(), ed.mean().item()
        ratio = max(es_max / ed_max if ed_max else
                    (0.0 if es_max == 0 else math.inf),
                    es_mean / ed_mean if ed_mean else
                    (0.0 if es_mean == 0 else math.inf))
        gated = name.startswith("layers.attn")
        worst["gated" if gated else "other"] = max(
            worst["gated" if gated else "other"], ratio)
        log(f"  {name:24s} mean |grad| {ref.abs().mean().item():.4e}; fp32 "
            f"|sparse - dense| {d32:.4e}; bf16 from fp32 dense: sparse max "
            f"{es_max:.4e} mean {es_mean:.4e}, dense max {ed_max:.4e} mean "
            f"{ed_mean:.4e} (ratio {ratio:.4f}{', gated' if gated else ''})")
        check(math.isfinite(d32) and d32 <= TOL_STEP_GRAD,
              f"covering-plan fp32 gradient of {name} differs from dense by "
              f"{d32}")
        check(not gated or (math.isfinite(es_max) and
                            es_max <= BF16_LOGITS_SLACK * ed_max and
                            es_mean <= BF16_LOGITS_SLACK * ed_mean),
              f"the bf16 covering-plan gradient of {name} is farther from the "
              f"fp32 one ({es_max}, mean {es_mean}) than {BF16_LOGITS_SLACK} "
              f"x the bf16 dense one ({ed_max}, mean {ed_mean})")
    allg = torch.cat([g.flatten() for g in gd32.values()])
    log(f"covering-plan step vs dense step, spion-lra, {COVER_BATCH} x {S} "
        f"ListOps tokens, {len(gd32)} leaves, {allg.numel()} gradient "
        f"elements (mean |grad| {allg.abs().mean().item():.4e}, max "
        f"{allg.abs().max().item():.4e}): fp32 loss {ls32:.8f} vs {ld32:.8f} "
        f"(rel {rel:.3e}, tol {TOL_LOSS_REL}); fp32 grads max |diff| "
        f"{g32:.4e} (tol {TOL_STEP_GRAD}); bf16 sparse / dense distance from "
        f"the fp32 dense grads, the larger of the max and mean ratios: at "
        f"most {worst['gated']:.4f} on the attention leaves (limit "
        f"{BF16_LOGITS_SLACK}), {worst['other']:.4f} on the others; bf16 "
        f"losses {ls16:.6f} / {ld16:.6f}")
    check(math.isfinite(rel) and rel <= TOL_LOSS_REL,
          f"covering-plan fp32 loss differs from dense by {rel} (relative)")


# -- the kernel autotuner --------------------------------------------------------

AUTOTUNE_DIR = os.path.join(ROOT, "build", "chip_smoke_autotune")
SMEM_KINDS = {"fwd": 0, "dq": 1, "dkv": 2}   # spion_sm90_smem_bytes' kinds
TUNE_REPS = 5
EMBED_LEAF = "tok_embed.w"


def tune_shapes(train, serve, mixtral):
    """The three shapes the main path launches the kernels at, each with
    the tables it launches with: {name: (tables, block, tune kwargs)}. The
    serving plan is tuned under its full tables' digest (the exec the
    engine is built with; a prefill of 2048 tokens runs it unsliced), the
    mixtral plan under the digest of its slice to 39 row blocks (the
    engine's exec for its longest prompts, phase 4b's kernel check)."""
    st = train["trainer"].spion_state
    tp = TRAIN_PATH
    return {
        "train": (st.tables, st.tables["block"],
                  dict(heads=tp["N"], group=tp["G"], head_dim=tp["hd"],
                       causal=False)),
        "serve": (serve["plan"].tables, PATH["block"],
                  dict(heads=PATH["N"], group=PATH["G"], head_dim=PATH["hd"],
                       causal=True)),
        "mixtral": (mixtral["tables"], mixtral["kernel"]["shape"]["block"],
                    dict(heads=mixtral["kernel"]["shape"]["N"],
                         group=mixtral["kernel"]["shape"]["G"],
                         head_dim=mixtral["kernel"]["shape"]["hd"],
                         causal=True,
                         sliding_window=mixtral["kernel"]["shape"]["sw"])),
    }


def check_smem_formula(name, shape):
    """The host's shared-memory formula (block_sparse_attn.smem_bytes)
    equals the launchers' (spion_sm90_smem_bytes) for every config of the
    grid at this shape; returns the configs config_fits refuses."""
    import torch
    from repro_torch.kernels import autotune
    from repro_torch.kernels.block_sparse_attn import (config_fits,
                                                       config_smem,
                                                       launch_config,
                                                       load_library)
    lib = load_library()
    refused = []
    for c in autotune.candidate_grid("cuda", torch.bfloat16):
        for kind, host in config_smem(c, **shape).items():
            width = shape["KT"] if kind == "dkv" else shape["K"]
            depth, nwg = launch_config(kind, c, width)
            card = lib.spion_sm90_smem_bytes(SMEM_KINDS[kind], shape["hd"],
                                             shape["block"], shape["G"],
                                             depth, nwg, width)
            check(card == host, f"{name}: {kind} under {c} needs {card} "
                  f"bytes by the launcher's formula, {host} by the host's")
        if not config_fits(c, **shape):
            refused.append(c)
    return refused


def refusal_before_launch(config, shape, gen):
    """Each kernel whose shared memory a config that config_fits refuses
    overflows raises ValueError in its wrapper on CUDA tensors at this
    shape, and nothing launches; returns those kernels."""
    import torch
    from repro_torch.kernels import block_sparse_attn as bsa
    N, G, hd, block = PATH["N"], shape["G"], shape["hd"], shape["block"]
    nrb = PATH["S"] // block

    def randn(*s):
        return torch.randn(s, generator=gen, device=DEVICE).bfloat16()
    q, do = randn(N, G, nrb * block, hd), randn(N, G, nrb * block, hd)
    k, v = randn(N, nrb * block, hd), randn(N, nrb * block, hd)
    lse = torch.zeros((N, G, nrb * block), device=DEVICE)
    col = torch.zeros((nrb, shape["K"]), dtype=torch.int32, device=DEVICE)
    nvalid = torch.ones(nrb, dtype=torch.int32, device=DEVICE)
    row = torch.zeros((nrb, shape["KT"]), dtype=torch.int32, device=DEVICE)
    calls = {"fwd": lambda: bsa.block_sparse_fwd(
                 q, k, v, col, nvalid, block=block, config=config),
             "dq": lambda: bsa.block_sparse_dq(
                 q, k, v, do, lse, lse, col, nvalid, block=block,
                 config=config),
             "dkv": lambda: bsa.block_sparse_dkv(
                 q, k, v, do, lse, lse, row, nvalid, block=block,
                 config=config)}
    smem = bsa.config_smem(config, **shape)
    refused = [kind for kind, need in smem.items() if need > bsa.SMEM_LIMIT]
    check(refused, f"{config} fits at {shape}: {smem}")
    for kind in refused:
        before = launch_counts()
        try:
            calls[kind]()
            check(False, f"{kind} launched under {config} ({smem[kind]} "
                  f"bytes of shared memory)")
        except ValueError as e:
            check("shared memory" in str(e), f"{kind}: {e}")
        check(launch_counts() == before, f"{kind} launched under {config}")
    return refused


def tuned_train_step(train, best):
    """One sparse step's loss and gradients through the tuned exec against
    two through the default (SPION_AUTOTUNE=0), each at 8 + 4 + 4
    launches: the loss and every gradient bitwise equal, but for the token
    embedding's, whose backward (F.embedding) the card does not reproduce
    bit for bit (see TOL_RESUME): that one within TOL_RESUME of its
    largest element, beside the two default runs' own gap."""
    import numpy as np
    import torch
    from repro_torch.launch.steps import make_loss_and_grads
    tr, cfg = train["trainer"], train["cfg"]
    st = tr.spion_state
    tuned = tr.spion_ctl.attention_exec(st, dtype=cfg.dtype).to(DEVICE)
    os.environ["SPION_AUTOTUNE"] = "0"
    try:
        plain = tr.spion_ctl.attention_exec(st, dtype=cfg.dtype).to(DEVICE)
    finally:
        del os.environ["SPION_AUTOTUNE"]
    check(tuned.kernel_config == best and plain.kernel_config is None,
          f"the train exec's configs: tuned {tuned.kernel_config}, with "
          f"SPION_AUTOTUNE=0 {plain.kernel_config}")
    lg = make_loss_and_grads(cfg)
    batch = {k: torch.as_tensor(np.asarray(v), device=DEVICE)
             for k, v in train["data_fn"](TRAIN_STEPS).items()}
    want = sparse_launches(cfg)

    def run(ex):
        reset_launch_counts()
        loss, grads = lg(tr.params, batch, ex)
        torch.cuda.synchronize()
        check(launch_counts() == want, f"a step under {ex.kernel_config} "
              f"launched {launch_counts()}, not {want}")
        return loss.detach(), {n: g.detach() for n, g in grads.items()}
    a, t, b = run(plain), run(tuned), run(plain)
    from repro_torch.kernels.autotune import _bitwise_equal
    check(_bitwise_equal(t[0], a[0]), f"tuned loss {t[0].item()} != "
          f"default {a[0].item()}")
    differ = [n for n in a[1] if n != EMBED_LEAF and
              not _bitwise_equal(t[1][n], a[1][n])]
    check(not differ, f"tuned gradients differ from the default's: {differ}")
    scale = a[1][EMBED_LEAF].abs().max().item()
    gap = (t[1][EMBED_LEAF] - a[1][EMBED_LEAF]).abs().max().item()
    gap_aa = (b[1][EMBED_LEAF] - a[1][EMBED_LEAF]).abs().max().item()
    log(f"autotune: a sparse train step (spion-lra, ListOps size) through "
        f"the tuned exec ({tuned.kernel_config}) against SPION_AUTOTUNE=0, "
        f"{want} launches each: loss bitwise equal ({t[0].item():.6f}), "
        f"{len(a[1]) - 1} gradient leaves bitwise equal; {EMBED_LEAF} "
        f"|diff| {gap:.3e} (default against default {gap_aa:.3e}; max |g| "
        f"{scale:.3e}, gate {TOL_RESUME} of it)")
    check(gap <= TOL_RESUME * scale, f"{EMBED_LEAF} differs by {gap}")
    return dict(embed_gap=gap, embed_gap_default=gap_aa)


def tuned_prefill(serve_plan, best, gen):
    """One qwen2-7b prefill of 2048 tokens (the plan's full coverage, so
    the unsliced exec) through the tuned exec and through one with the
    default config: logits and the K/V it returns bitwise equal, 28
    launches each."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.attention_exec import SparseAttentionExec
    from repro_torch.kernels.autotune import _bitwise_equal
    from repro_torch.kernels.dispatch import DEFAULT_CONFIG
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.registry import build
    cfg = get_config("qwen2-7b")
    params = build(cfg).init(gen, device=DEVICE)
    tuned = SparseAttentionExec.from_plan(serve_plan, phase="prefill",
                                          dtype=cfg.dtype).to(DEVICE)
    plain = SparseAttentionExec.from_plan(
        serve_plan, phase="prefill", dtype=cfg.dtype,
        kernel_config=DEFAULT_CONFIG).to(DEVICE)
    check(tuned.kernel_config == best, f"the serving exec's config "
          f"{tuned.kernel_config}, not the winner {best}")
    prefill = make_prefill_step(cfg, spion=True, with_cache=True)
    rng = np.random.default_rng(SEED + 5)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        size=(1, tuned.coverage)),
                           device=DEVICE)
    outs = []
    for ex in (plain, tuned):
        reset_launch_counts()
        with torch.inference_mode():
            outs.append(prefill(params, {"tokens": toks}, ex))
        torch.cuda.synchronize()
        check(launch_counts()["block_sparse_fwd"] == cfg.num_layers,
              f"a prefill launched {launch_counts()}")
    same = [_bitwise_equal(x, y) for x, y in zip(*outs)]
    log(f"autotune: a qwen2-7b prefill of {tuned.coverage} tokens through "
        f"the tuned exec ({best}) against the default config, "
        f"{cfg.num_layers} launches each: logits, K and V bitwise equal "
        f"{same}")
    check(all(same), "the tuned prefill differs from the default's")
    del params, outs
    torch.cuda.empty_cache()


def phase_autotune(train, serve, mixtral, gen):
    """The autotuner on the card: at each of the three shapes, the host's
    shared-memory formula against the launchers', then tune (every
    candidate's forward, dQ and dK/dV timed, o, lse, dq, dk and dv held
    bitwise against the default's: a mismatch fails the run), a refused
    config raising before any launch, a cold exec hitting the cache; then
    a tuned train step and a tuned qwen2-7b prefill against the
    default's."""
    import torch
    from repro_torch.core.attention_exec import SparseAttentionExec
    from repro_torch.kernels import autotune
    from repro_torch.kernels.block_sparse_attn import config_smem
    from repro_torch.kernels.dispatch import compiled_backend
    t0 = time.perf_counter()
    card = card_line()
    out = {}
    for name, (tables, block, kw) in tune_shapes(train, serve,
                                                 mixtral).items():
        shape = autotune.tune_shape(tables, block, group=kw["group"],
                                    head_dim=kw["head_dim"])
        refused = check_smem_formula(name, shape)
        best, report = autotune.tune(tables, block, dtype=torch.bfloat16,
                                     device=DEVICE, generator=gen,
                                     reps=TUNE_REPS, **kw)
        fits = autotune.candidates(compiled_backend(DEVICE) or "cpu",
                                   torch.bfloat16, shape)
        check([r["config"] for r in report[1:]] ==
              [c for c in fits if c != report[0]["config"]],
              f"{name}: the sweep ran {[r['config'] for r in report]}")
        log(f"autotune at the {name} shape {shape} (N {kw['heads']}), "
            f"{len(report)} candidates, us by CUDA events (min of "
            f"{TUNE_REPS} means of 10), {card}:")
        for r in report:
            log(f"  {autotune.describe(r['config']):18s} fwd "
                f"{r['us']:9.2f} dq {r['dq_us']:9.2f} dkv {r['dkv_us']:9.2f}"
                f" us; smem {r['smem']}; bitwise {r['bitwise']}")
        log(f"  refused by config_fits before any launch: "
            + (", ".join(f"{autotune.describe(c)} "
                         f"{config_smem(c, **shape)}"
                         for c in refused) or "none"))
        bad = [r["config"] for r in report if not r["bitwise"]]
        check(not bad, f"{name}: candidates changed a kernel's output "
              f"bitwise: {bad}")
        if refused:
            kinds = refusal_before_launch(refused[0], shape, gen) \
                if name == "serve" else None
            if kinds:
                log(f"  {autotune.describe(refused[0])} raised in "
                    f"{kinds} before launching")
        cold = SparseAttentionExec(tables, block=block, dtype=torch.bfloat16)
        check(cold.kernel_config == best, f"{name}: a cold exec found "
              f"{cold.kernel_config}, the sweep's winner is {best}")
        default = report[0]
        win = next(r for r in report if r["config"] == best)
        log(f"  winner {autotune.describe(best)}: fwd {win['us']:.2f} us "
            f"(default {default['us']:.2f}), dq {win['dq_us']:.2f} "
            f"({default['dq_us']:.2f}), dkv {win['dkv_us']:.2f} "
            f"({default['dkv_us']:.2f}); a cold exec hits it")
        out[name] = dict(best=best, report=report, refused=refused,
                         shape=shape)
    step = tuned_train_step(train, out["train"]["best"])
    tuned_prefill(serve["plan"], out["serve"]["best"], gen)
    log(f"autotune: the phase took {time.perf_counter() - t0:.1f} s")
    return dict(shapes=out, **step)


def tuned_record(autotuned):
    """{kernel: {shape: winner, its ms and the default's}} for the JSON
    line (the forward decides the winner; dQ's and dK/dV's times are under
    it)."""
    from repro_torch.kernels.autotune import describe
    keys = {"block_sparse_fwd": "us", "block_sparse_dq": "dq_us",
            "block_sparse_dkv": "dkv_us"}
    rec = {}
    for kernel, key in keys.items():
        rec[kernel] = {}
        for name, t in autotuned["shapes"].items():
            rep = t["report"]
            win = next(r for r in rep if r["config"] == t["best"])
            rec[kernel][name] = dict(
                config=describe(t["best"]), ms=win[key] / 1e3,
                default_ms=rep[0][key] / 1e3, candidates=len(rep),
                refused=[describe(c) for c in t["refused"]])
    return rec


DRYRUN_DIR = os.path.join(ROOT, "build", "chip_smoke_dryrun")
# phase 8b (c): sparse cells of `python -m repro_torch.launch.dryrun` on
# the host
DRYRUN_CELLS = (("qwen2-7b", "train_4k"), ("mixtral-8x7b", "prefill_32k"))
DRYRUN_PREFILL_LAYERS = 4     # qwen2-7b's prefill at full width, 4 of 28
DRYRUN_PREFILL_S = 1024
# the meta pass's peak over its inputs against the real step's rise in
# max_memory_allocated, relative to the real rise
TOL_DRYRUN_PEAK = 0.10
DRYRUN_TIMEOUT_S = 300        # (c)'s host processes, from their start


def start_dryrun_cells():
    """Phase 8b (c)'s host processes: one `python -m
    repro_torch.launch.dryrun --mode sparse` per DRYRUN_CELLS entry on the
    single production mesh, with no card visible, records in DRYRUN_DIR.
    Returns [(arch, shape, Popen, start time)]; each is killed if this
    process exits first."""
    import atexit
    import shutil
    import signal
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    os.makedirs(DRYRUN_DIR)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for arch, shape in DRYRUN_CELLS:
        out = open(os.path.join(DRYRUN_DIR, f"log_{arch}.txt"), "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--mode", "sparse",
             "--out", DRYRUN_DIR],
            stdout=out, stderr=subprocess.STDOUT, env=env, cwd=ROOT,
            start_new_session=True)
        procs.append((arch, shape, proc, time.perf_counter()))

    def stop():
        for _, _, p, _ in procs:
            if p.poll() is None:
                os.killpg(os.getpgid(p.pid), signal.SIGKILL)
                p.wait()
    atexit.register(stop)
    return procs


def dryrun_step(label, cfg, shape, tables, want):
    """Phase 8b's (a) or (b): the one-rank cell's step traced on meta
    tensors, then run for real on the same tables with random inputs from
    the seed; the FLOPs bitwise, the peaks within TOL_DRYRUN_PEAK, the
    launches `want`. Returns the readings."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo import roofline_terms
    from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW_PER_GPU,
                                         PEAK_FLOPS_BF16)
    dev = torch.device(DEVICE, torch.cuda.current_device())
    t = time.perf_counter()
    traced = dryrun.trace_cell(*dryrun.build_cell(cfg, shape, None, "sparse",
                                                  tables=tables))
    meta_s = time.perf_counter() - t
    fmem, fcost = dryrun.analyse_memory(traced), dryrun.cost_of(traced)
    del traced
    step, args, tracked = dryrun.build_cell(
        cfg, shape, None, "sparse", device=dev, tables=tables,
        make=dryrun.random_inputs(cfg, SEED))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = launch_counts()
    done = dryrun.trace_cell(step, args, tracked)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    traced_launches = {k: launch_counts()[k] - before[k] for k in before}
    rcost, rmem = dryrun.cost_of(done), dryrun.analyse_memory(done)
    out = done["out"]
    loss = out[2]["loss"] if isinstance(out, tuple) and len(out) == 3 \
        else out
    check(bool(torch.isfinite(loss.float()).all()),
          f"dry run {label}: the real step's output is not finite")
    del done, out, loss
    # the step once more, out of the counting modes: its time and launches
    before = launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    step(*args)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t)
    plain_launches = {k: launch_counts()[k] - before[k] for k in before}
    del step, args, tracked
    torch.cuda.empty_cache()
    check(traced_launches == want and plain_launches == want,
          f"dry run {label}: the real steps launched {traced_launches} and "
          f"{plain_launches}, not {want}")
    check(fcost["flops"] == rcost["flops"],
          f"dry run {label}: the meta pass counts {fcost['flops']!r} FLOPs, "
          f"the real step {rcost['flops']!r}")
    gap = abs(fmem["step_peak_bytes"] - rise) / rise
    check(gap <= TOL_DRYRUN_PEAK,
          f"dry run {label}: the meta peak over the inputs "
          f"{fmem['step_peak_bytes']} bytes against the real rise {rise} "
          f"({gap:.3f} apart; gate {TOL_DRYRUN_PEAK})")
    terms = roofline_terms(fcost["flops"], fcost["hbm_bytes"],
                           fcost["coll_bytes"], 1,
                           peak_flops=PEAK_FLOPS_BF16, hbm_bw=HBM_BW,
                           link_bw=NVLINK_BW_PER_GPU)
    dom = max(terms, key=terms.get)
    log(f"dry run {label}: meta pass {meta_s:.2f} s; FLOPs {fcost['flops']:.6e}"
        f" meta = real (the kernels {fcost['census']['custom-call']} ops); "
        f"peak over the inputs meta {fmem['step_peak_bytes'] / 1e9:.4f} GB, "
        f"real max_memory_allocated rise {rise / 1e9:.4f} GB ({gap:.4f} "
        f"apart), MemTracker on the real step "
        f"{rmem['step_peak_bytes'] / 1e9:.4f} GB; inputs "
        f"{fmem['inputs_bytes'] / 1e9:.4f} GB; eager HBM bytes "
        f"{fcost['hbm_bytes']:.6e}; roofline {1e3 * terms[dom]:.3f} ms "
        f"({dom}; compute {1e3 * terms['t_compute']:.3f}, memory "
        f"{1e3 * terms['t_memory']:.3f}) beside the step's {ms:.3f} ms; "
        f"launches {plain_launches}")
    return dict(meta_s=meta_s, flops=fcost["flops"], rise=rise,
                meta_peak=fmem["step_peak_bytes"], gap=gap, ms=ms,
                roofline_ms=1e3 * terms[dom], dominant=dom,
                launches={k: traced_launches[k] + plain_launches[k]
                          for k in want})


def phase_dryrun(train):
    """8b. The dry run (launch/dryrun.py): (a) spion-lra's trained sparse
    step, (b) qwen2-7b's sparse prefill, each meta against real; (c) the
    host processes' production-mesh cells, started first and read by
    `finish_dryrun` (they run beside phases 9-12c, which time no
    kernel)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.attention_exec import SparseAttentionExec
    t0 = time.perf_counter()
    procs = start_dryrun_cells()
    tr, cfg = train["trainer"], train["cfg"]
    lra = ShapeSpec("lra_listops", tr.seq_len, lra_config()[1]["batch"],
                    "train")
    runs = {"a": dryrun_step("(a) spion-lra train", cfg, lra,
                             tr._attention_exec(), sparse_launches(cfg))}
    qcfg = get_config("qwen2-7b").replace(num_layers=DRYRUN_PREFILL_LAYERS)
    block = qcfg.spion.block_size
    _, _, plan = random_plan(np.random.default_rng(SEED), qcfg.num_layers,
                             DRYRUN_PREFILL_S // block, block)
    pex = SparseAttentionExec.from_plan(plan, phase="prefill",
                                        dtype=qcfg.dtype).to(DEVICE)
    runs["b"] = dryrun_step(
        f"(b) qwen2-7b prefill, {DRYRUN_PREFILL_LAYERS} of 28 layers", qcfg,
        ShapeSpec("prefill_1024", DRYRUN_PREFILL_S, 1, "prefill"), pex,
        {"block_sparse_fwd": qcfg.num_layers, "block_sparse_dq": 0,
         "block_sparse_dkv": 0})
    card_s = time.perf_counter() - t0
    log(f"dry run (phase 8b): (a) and (b) on the card in {card_s:.1f} s "
        f"({card_line()}); (c) runs on the host beside phases 9-12c")
    return dict(runs=runs, procs=procs, t0=t0, card_s=card_s)


def finish_dryrun(dry):
    """8b (c): wait for the host processes that `phase_dryrun` started and
    check their records."""
    import json as json_
    runs, t0 = dry["runs"], dry["t0"]
    t_wait = time.perf_counter()
    cells = {}
    for arch, shape, proc, started in dry["procs"]:
        left = DRYRUN_TIMEOUT_S - (time.perf_counter() - started)
        try:
            rc = proc.wait(timeout=max(left, 1))
        except subprocess.TimeoutExpired:
            check(False, f"dry run (c) {arch} {shape}: still running after "
                  f"{DRYRUN_TIMEOUT_S} s")
        tail = open(os.path.join(DRYRUN_DIR, f"log_{arch}.txt")).read()
        check(rc == 0, f"dry run (c) {arch} {shape}: exit {rc}\n"
              f"{tail[-2000:]}")
        name = f"{arch}__{shape}__single__sparse"
        rec = json_.load(open(os.path.join(DRYRUN_DIR, name + ".json")))
        check(rec["status"] == "ok" and rec["chips"] == 256,
              f"dry run (c) {name}: {rec.get('status')} "
              f"{rec.get('error', '')[:500]}")
        cells[name] = rec
        log(f"dry run (c) {name}, the host's arithmetic with the H100 "
            f"constants: {rec['memory']['per_device_gb']:.3f} GB a "
            f"rank, dominant {rec['dominant']} (compute "
            f"{1e3 * rec['roofline']['t_compute']:.1f} ms, memory "
            f"{1e3 * rec['roofline']['t_memory']:.1f} ms, collective "
            f"{1e3 * rec['roofline']['t_collective']:.1f} ms), useful "
            f"fraction {rec['useful_fraction']:.4f}, n_micro "
            f"{rec['n_micro']}, traced in {rec['t_total_s']} s")
        log(f"dry run (c) {arch} {shape}: its record read "
            f"{time.perf_counter() - started:.1f} s after its start")
    seconds = time.perf_counter() - t0
    log(f"dry run (phase 8b): (c) read {seconds:.1f} s after 8b's start, "
        f"{time.perf_counter() - t_wait:.1f} s of it waited for after 12c")
    launches = {k: runs["a"]["launches"][k] + runs["b"]["launches"][k]
                for k in KERNELS}
    return dict(runs=runs, cells=cells, seconds=seconds,
                card_s=dry["card_s"], launches=launches)


# -- self-healing training -----------------------------------------------------

CKPT_DIR = os.path.join(ROOT, "build", "chip_smoke_ckpt")
CKPT_EVERY = 7      # saves at step 7 (dense) and step 14 (sparse), then 20
RESUME_AT = 14      # the sparse-phase checkpoint the resume phase continues
KILL_STEP = 16      # the respawn phase's worker is SIGKILLed here
NAN_STEP = 17       # the rollback phase poisons the masters here
ROLLBACK_EVERY = 2  # the rollback phase's saves: 16 (good), 18 (poisoned)
# resumed and stitched losses against the uninterrupted run's, relative.
# Not 0: F.embedding's backward on the card is not bitwise reproducible
# (chip_repro.py: the token embedding's gradient, alone of all leaves,
# differed in 7 of 60 repeated dense steps), so the dense steps before a
# checkpoint may leave another state than phase 5's. On one H100 80GB
# HBM3 at 700 W sound runs read 0 or 1.102e-6 (resumed in 2 of 8 runs,
# stitched in 4 of 7); restores planted by chip_repro.py read 2.625e-5
# with the count one ahead, 1.758e-3 with the data offset one ahead,
# 6.462e-3 with the first moments at zero. Both phases also hold the
# restored state bitwise.
TOL_RESUME = 1e-5


def loss_gap(got, want):
    """Largest relative difference of two loss lists (0.0 when bitwise)."""
    check(len(got) == len(want), f"{len(got)} losses against {len(want)}")
    return max((abs(a - b) / abs(b) for a, b in zip(got, want)), default=0.0)


def state_snapshot(tr):
    """Host copies of a trainer's masters, moments and count."""
    import torch
    snap = {f"params.{n}": p.detach().cpu().clone()
            for n, p in tr.params.named_parameters()}
    for k in ("mu", "nu"):
        snap.update({f"{k}.{n}": t.cpu().clone()
                     for n, t in tr.opt[k].items()})
    snap["count"] = tr.opt["count"].cpu().clone()
    return {k: v.to(torch.float64) if v.is_floating_point() else v
            for k, v in snap.items()}


def state_gap(a, b):
    """Largest |difference| between two snapshots, and the leaves that
    differ at all."""
    check(a.keys() == b.keys(), "the snapshots hold different leaves")
    gaps = {k: (a[k] - b[k]).abs().max().item() if a[k].numel() else 0.0
            for k in a}
    return max(gaps.values()), sorted(k for k, g in gaps.items() if g)


def plan_digest_of(state):
    from repro_torch.core.spion import plan_digest
    return plan_digest(state.table_arrays(), state.tables["block"])


def recovery_record(tr):
    """What a restore must reproduce: step, data offset, phase, plan digest,
    and the masters, moments and count (state_snapshot)."""
    st = tr.spion_state
    return {"step": tr.step, "data_offset": tr.data_offset, "phase": st.phase,
            "digest": plan_digest_of(st) if st.tables else None,
            "state": state_snapshot(tr)}


def check_sparse_steps(steps, cfg, what):
    want = sparse_launches(cfg)
    for r in steps:
        check(r["phase"] == "sparse" and r["launches"] == want,
              f"{what}: a step in phase {r['phase']} launched "
              f"{r['launches']}, not {want}")


def reproducibility(tr):
    """One sparse step run twice from the state restored at RESUME_AT:
    whether its loss and the updated state are bitwise the same (printed;
    chip_repro.py repeats the steps and names the op that is not)."""
    runs = []
    for _ in range(2):
        tr._restore_latest(step=RESUME_AT)
        batch = tr._next_batch()
        loss = float(tr._one_step(batch)["loss"])
        runs.append((loss, state_snapshot(tr)))
    gap, leaves = state_gap(runs[0][1], runs[1][1])
    bitwise = runs[0][0] == runs[1][0] and not leaves
    log(f"resume: one sparse step twice from step {RESUME_AT}: losses "
        f"{runs[0][0]!r} / {runs[1][0]!r}, updated state max |diff| {gap:.3e}"
        f" ({len(leaves)} leaves differ{': ' if leaves else ''}"
        f"{', '.join(leaves[:8])}): "
        f"{'bitwise reproducible' if bitwise else 'NOT bitwise reproducible'}")
    return bitwise


def phase_resume(train):
    """Train spion-lra into the sparse phase with checkpoints under build/
    (CKPT_EVERY), then resume from the sparse-phase checkpoint with a fresh
    Trainer: the restored step, data offset, phase, plan digest, masters
    and moments must be the saved ones, every sparse step after the resume
    must launch the three kernels, and the resumed losses must equal the
    uninterrupted run's (phase 5) within TOL_RESUME."""
    import shutil
    import torch
    ref = train["losses"]
    d = os.path.join(CKPT_DIR, "resume")
    shutil.rmtree(d, ignore_errors=True)
    first, cfg, _ = lra_trainer(ckpt_dir=d)
    t0 = time.perf_counter()
    lead = first.train(RESUME_AT, ckpt_every=CKPT_EVERY, log_every=10**9,
                       log=lambda m: None)
    torch.cuda.synchronize()
    lead_s = time.perf_counter() - t0
    check(first.spion_state.phase == "sparse" and
          first.ckpt.all_steps() == [CKPT_EVERY, RESUME_AT],
          f"the first leg ended in phase {first.spion_state.phase} with "
          f"checkpoints {first.ckpt.all_steps()}")
    saved = state_snapshot(first)
    saved_digest = plan_digest_of(first.spion_state)
    t0 = time.perf_counter()
    first.save()           # the same step again: what one save costs
    first.ckpt.wait()
    save_s = time.perf_counter() - t0
    del first

    t0 = time.perf_counter()
    tr, _, _ = lra_trainer(ckpt_dir=d)
    check(tr.maybe_resume(), "the fresh trainer found no checkpoint")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    st = tr.spion_state
    gap, leaves = state_gap(state_snapshot(tr), saved)
    check(tr.step == RESUME_AT and tr.data_offset == 0 and
          st.phase == "sparse" and plan_digest_of(st) == saved_digest,
          f"restored step {tr.step}, data offset {tr.data_offset}, phase "
          f"{st.phase}, plan digest {plan_digest_of(st)} (saved "
          f"{saved_digest})")
    check(not leaves, f"restored state differs from the saved one by {gap} "
          f"in {leaves}")
    bitwise = reproducibility(tr)
    tr._restore_latest(step=RESUME_AT)
    reset_launch_counts()
    steps, undo = record_steps(tr)
    resumed = tr.train(TRAIN_STEPS - RESUME_AT, ckpt_every=CKPT_EVERY,
                       log_every=10**9, log=lambda m: None)
    undo()
    launches = launch_counts()
    check_sparse_steps(steps, cfg, "after the resume")
    check(launches == {k: n * len(steps)
                       for k, n in sparse_launches(cfg).items()},
          f"the resumed run launched {launches}")
    check(tr._exec_tables is tr.spion_state.tables,
          "the sparse exec was not rebuilt from the restored plan")
    lead_gap = loss_gap(lead, ref[:RESUME_AT])
    gap = loss_gap(resumed, ref[RESUME_AT:])
    log(f"resume: first leg {RESUME_AT} steps from the seed in {lead_s:.2f} s "
        f"(checkpoints {CKPT_EVERY}, {RESUME_AT}), its losses vs phase 5's "
        f"max rel {lead_gap:.3e}; save of one checkpoint {1e3 * save_s:.1f} "
        f"ms; fresh Trainer + maybe_resume {1e3 * restore_s:.1f} ms: step "
        f"{tr.step - len(resumed)}, phase sparse, plan digest {saved_digest}, "
        f"masters and moments bitwise; {len(resumed)} resumed steps launched "
        f"{launches} (per step {sparse_launches(cfg)}); resumed losses "
        f"{', '.join(f'{x:.6f}' for x in resumed)} vs phase 5's max rel "
        f"{gap:.3e} (gate {TOL_RESUME})")
    check(gap <= TOL_RESUME and lead_gap <= TOL_RESUME,
          f"resumed losses differ from the uninterrupted run's by {gap} "
          f"(first leg {lead_gap}); gate {TOL_RESUME}")
    return dict(dir=d, save_s=save_s, restore_s=restore_s, bitwise=bitwise,
                launches=launches, gap=gap, lead_gap=lead_gap)


def phase_rollback(resume):
    """A NaN poisoning (ChaosMonkey(nan_step=NAN_STEP)) in the sparse phase,
    in-process, from a copy of the resume phase's checkpoints: one rollback
    to the pinned good step, the poisoned save quarantined, the data offset
    advanced by the window, the replayed sparse steps launching the three
    kernels on the restored tables, every stitched loss finite."""
    import shutil
    import torch
    from repro_torch.distributed.chaos import ChaosMonkey
    d = os.path.join(CKPT_DIR, "rollback")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(resume["dir"], d)
    for name in os.listdir(d):
        if name.startswith("step_") and int(name.split("_")[1]) > RESUME_AT:
            shutil.rmtree(os.path.join(d, name))
    tr, cfg, _ = lra_trainer(ckpt_dir=d, chaos=ChaosMonkey(nan_step=NAN_STEP))
    check(tr.maybe_resume() and tr.step == RESUME_AT,
          f"the rollback phase resumed at step {tr.step}")
    digest = plan_digest_of(tr.spion_state)
    reset_launch_counts()
    steps, undo = record_steps(tr)
    t0 = time.perf_counter()
    tr.train(TRAIN_STEPS - RESUME_AT, ckpt_every=ROLLBACK_EVERY,
             log_every=10**9, log=lambda m: log(f"  rollback: {m}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    undo()
    launches = launch_counts()
    ev = [e for e in tr.events if e["event"] == "rollback"]
    good = NAN_STEP - NAN_STEP % ROLLBACK_EVERY
    window = NAN_STEP - good + 1
    check(tr.rollback_count == 1 and len(ev) == 1 and
          ev[0]["from_step"] == NAN_STEP and ev[0]["to_step"] == good,
          f"rollbacks {tr.rollback_count}, events {ev}")
    check(os.path.exists(os.path.join(
        d, f"quarantined_step_{good + ROLLBACK_EVERY:09d}")),
          "the poisoned save was not quarantined")
    check(tr.data_offset == window and tr.step == TRAIN_STEPS,
          f"data offset {tr.data_offset} (window {window}), step {tr.step}")
    check(plan_digest_of(tr.spion_state) == digest and
          tr._exec_tables is tr.spion_state.tables,
          "the replay did not run on the restored plan")
    replay = steps[NAN_STEP - RESUME_AT + 1:]
    check(len(replay) == TRAIN_STEPS - good, f"{len(replay)} replayed steps")
    check_sparse_steps(steps, cfg, "around the rollback")
    hist = [tr.loss_history[s] for s in range(RESUME_AT, TRAIN_STEPS)]
    check(sorted(tr.loss_history) == list(range(RESUME_AT, TRAIN_STEPS)) and
          all(math.isfinite(x) for x in hist),
          f"stitched losses {tr.loss_history}")
    log(f"rollback: NaN at step {NAN_STEP}, rolled back to step {good} in "
        f"{ev[0]['seconds']:.3f} s, step {good + ROLLBACK_EVERY}'s save "
        f"quarantined, data offset {tr.data_offset}; {len(steps)} sparse "
        f"steps ({len(replay)} replayed) launched {launches} in {wall:.2f} s;"
        f" stitched losses {', '.join(f'{x:.6f}' for x in hist)}")
    return dict(seconds=ev[0]["seconds"], launches=launches)


def train_worker(d):
    """The respawn phase's worker (`--train-worker DIR`): spion-lra from
    DIR's latest checkpoint (or the seed) to step TRAIN_STEPS with
    checkpoints every CKPT_EVERY steps; each step appends {pid, step,
    phase, loss, launches, t} to DIR/losses.jsonl, and the end writes
    DIR/done_<pid>.json. The recovery_record of the state it saves at
    RESUME_AT goes to DIR/saved_<pid>.pt, and that of the state it resumed
    to DIR/restored_<pid>.pt."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # heartbeat_interval 0: every step's beat is written, the last one too
    tr, _, _ = lra_trainer(ckpt_dir=d, heartbeat_interval=0.0)
    start = tr.step
    resumed = tr.maybe_resume()
    steps, _ = record_steps(tr)
    pid = os.getpid()
    if resumed:
        torch.save(recovery_record(tr), os.path.join(d, f"restored_{pid}.pt"))
    inner_save = tr.save

    def save():
        inner_save()
        if tr.step == RESUME_AT:
            torch.save(recovery_record(tr),
                       os.path.join(d, f"saved_{pid}.pt"))
    tr.save = save

    def on_step(step, loss):
        r = steps[-1]
        with open(os.path.join(d, "losses.jsonl"), "a") as f:
            f.write(json.dumps({"pid": pid, "step": step, "loss": loss,
                                "phase": r["phase"], "launches":
                                r["launches"], "t": time.time()}) + "\n")
    tr.step_callback = on_step
    log(f"worker {pid}: {'resumed at' if resumed else 'from'} step "
        f"{tr.step if resumed else start}, phase {tr.spion_state.phase}")
    tr.train(TRAIN_STEPS - tr.step, ckpt_every=CKPT_EVERY, log_every=10**9,
             log=lambda m: None)
    with open(os.path.join(d, f"done_{pid}.json"), "w") as f:
        json.dump({"launches": launch_counts(), "step": tr.step,
                   "phase": tr.spion_state.phase}, f)
    return 0


def phase_respawn(train, resume):
    """FleetSupervisor with nproc 1 runs this script as the training worker
    with SPION_CHAOS_KILL_STEP at a sparse step, on a copy of the resume
    phase's dense checkpoint (step CKPT_EVERY; the dense steps before it
    are phase 5's and the resume phase's): generation 0 resumes in the
    dense phase, reaches the sparse phase and is killed; one respawn;
    generation 1 resumes in the sparse phase, its step, data offset, phase,
    plan digest, masters, moments and count bitwise those generation 0
    saved there, and finishes; the stitched loss history equals phase 5's
    within TOL_RESUME; the heartbeat payload reads back."""
    import gc
    import shutil
    import torch
    from repro_torch.distributed.fault import Heartbeat
    from repro_torch.distributed.supervisor import FleetSupervisor
    cfg = train["cfg"]
    d = os.path.join(CKPT_DIR, "respawn")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    name = f"step_{CKPT_EVERY:09d}"
    shutil.copytree(os.path.join(resume["dir"], name), os.path.join(d, name))
    gc.collect()
    torch.cuda.empty_cache()   # the workers need the card's memory
    env = dict(os.environ, SPION_CHAOS_KILL_STEP=str(KILL_STEP),
               SPION_CHAOS_ONCE_DIR=os.path.join(d, "once"))
    sup = FleetSupervisor(
        [sys.executable, os.path.abspath(__file__), "--train-worker", d], 1,
        d, dead_timeout=180.0, hang_timeout=180.0, poll_interval=0.2,
        max_respawns=2, backoff_base=0.1, backoff_max=1.0, env=env,
        sleep_fn=stoppable_sleep, log=lambda m: log(f"  respawn: {m}"))
    t0 = time.perf_counter()
    rc = sup.run()
    wall = time.perf_counter() - t0
    check(rc == 0 and sup.respawns == 1,
          f"the supervisor returned {rc} after {sup.respawns} respawns")
    with open(os.path.join(d, "losses.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    pids = list(dict.fromkeys(x["pid"] for x in lines))
    check(len(pids) == 2, f"{len(pids)} worker generations wrote losses")
    gen0 = [x for x in lines if x["pid"] == pids[0]]
    gen1 = [x for x in lines if x["pid"] == pids[1]]
    check([x["step"] for x in gen0] == list(range(CKPT_EVERY, KILL_STEP)) and
          gen0[0]["phase"] == "dense" and
          [x["step"] for x in gen1] == list(range(RESUME_AT, TRAIN_STEPS)),
          f"generation 0 ran steps {[x['step'] for x in gen0]}, generation "
          f"1 {[x['step'] for x in gen1]}")
    check(os.path.exists(os.path.join(d, f"done_{pids[1]}.json")) and
          not os.path.exists(os.path.join(d, f"done_{pids[0]}.json")),
          "generation 1 did not finish, or generation 0 was not killed")
    with open(os.path.join(d, f"done_{pids[1]}.json")) as f:
        done = json.load(f)
    want = sparse_launches(cfg)
    for x in gen1:
        check(x["phase"] == "sparse" and x["launches"] == want,
              f"a resumed worker step in phase {x['phase']} launched "
              f"{x['launches']}, not {want}")
    check(done["launches"] == {k: n * len(gen1) for k, n in want.items()},
          f"generation 1 launched {done['launches']}")
    saved = torch.load(os.path.join(d, f"saved_{pids[0]}.pt"))
    restored = torch.load(os.path.join(d, f"restored_{pids[1]}.pt"))
    state_diff, leaves = state_gap(restored.pop("state"), saved.pop("state"))
    stitched = {x["step"]: x["loss"] for x in lines}
    gap = loss_gap([stitched[s] for s in range(CKPT_EVERY, TRAIN_STEPS)],
                   train["losses"][CKPT_EVERY:])
    hb = Heartbeat.read(os.path.join(d, "hb_0"))
    respawn_s = gen1[0]["t"] - gen0[-1]["t"]
    log(f"respawn: worker killed at step {KILL_STEP} (generation 0 resumed at "
        f"step {CKPT_EVERY} in phase dense and ran steps {CKPT_EVERY}-"
        f"{KILL_STEP - 1}), generation 1 resumed at step {RESUME_AT} "
        f"in phase sparse to {restored} against generation 0's {saved} "
        f"(masters, moments and count: {len(leaves)} leaves differ, max "
        f"|diff| {state_diff:.3e}) and finished; from generation 0's last "
        f"step to generation 1's first {respawn_s:.2f} s; supervisor "
        f"{wall:.2f} s in all; generation 1 launched {done['launches']}; "
        f"heartbeat {hb}; stitched losses vs phase 5's max rel {gap:.3e} "
        f"(gate {TOL_RESUME})")
    check(restored == saved and saved["step"] == RESUME_AT and not leaves,
          f"generation 1 resumed to {restored}, leaves {leaves} off by "
          f"{state_diff}; generation 0 saved {saved}")
    check(hb is not None and hb.get("step") == TRAIN_STEPS and
          hb.get("phase") == "sparse" and hb.get("pid") == pids[1],
          f"heartbeat payload {hb}")
    check(gap <= TOL_RESUME, f"stitched losses differ from the uninterrupted "
          f"run's by {gap}; gate {TOL_RESUME}")
    return dict(seconds=respawn_s, wall=wall, launches=done["launches"],
                gap=gap)


# -- multi-process (phase 12) ------------------------------------------------------

# 12a: the sequence-parallel op at two attention shapes, the dry-run plans
# banded to `max_extent` blocks so that the halo fits the shards of 4 ranks
SEQ_SHAPES = {
    "spion_lra": dict(arch="spion-lra", B=128, KV=4, G=1, S=2048, hd=16,
                      block=64, causal=False, max_extent=4),
    "qwen2_7b": dict(arch="qwen2-7b", B=1, KV=4, G=7, S=8192, hd=128,
                     block=128, causal=True, max_extent=8),
}
SEQ_RANKS = (2, 4)
SEQ_TIMING_REPS = 5
DP_RANKS = 2
DP_FAULT_STEPS = 2       # dense steps of each planted data-parallel fault
DP_KILL_STEP = 16        # 12c: rank 1 is SIGKILLed here (sparse phase)
DP_TERM_STEP = 17        # 12c: rank 1 gets one SIGTERM here
DP_DIR = os.path.join(ROOT, "build", "chip_smoke_dp")
# 12b: the 2-rank run's dense-phase losses against phase 5's one-process
# losses, relative. Not 0: the loss and the gradients are sums of two
# halves, and F.embedding's backward is not bitwise reproducible on the
# card (TOL_RESUME). On one H100 80GB HBM3 at 700 W the sound run read
# 5.455e-07 over 12 dense steps, a planted fault training both ranks on
# the same half batch 1.060e-03; a rank that skips its gradient all-reduce
# read only 3.277e-06 there (the warmup keeps the first steps' updates
# small), so that fault is held by the masters' digest, which must be equal
# on every rank after the run (it differs after the fault's first step).
TOL_DP = 1e-5


def rank_context():
    """The multiprocessing context that starts the ranks: a fork server
    that imported this script, numpy and torch once (without touching the
    card), so that a rank starts without the 7-14 s that a fresh
    interpreter took to import torch beside the other ranks (rank 0's
    wall-clock lines, H100 80GB HBM3 machine)."""
    import multiprocessing
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["__main__", "numpy", "torch"])
    return ctx


RANKS = []      # every rank that spawn_ranks started, for stop_rank_server


def stop_rank_server():
    """Kill every rank of `spawn_ranks` that still runs, then stop the fork
    server and the resource tracker that `rank_context` started and wait
    for both. Left alone they outlive this process by seconds (the fork
    server tears torch down after its last client has gone)."""
    import signal
    from multiprocessing import forkserver, resource_tracker
    for p in RANKS:
        p.kill()
    server = forkserver._forkserver
    if server._forkserver_pid is not None:
        # it serves no rank now; killed, it is reaped by _stop's waitpid
        os.kill(server._forkserver_pid, signal.SIGKILL)
        server._stop()
    tracker = resource_tracker._resource_tracker
    if tracker._pid is not None:
        # it exits once the last end of its pipe closes, and this is it
        os.close(tracker._fd)
        os.waitpid(tracker._pid, 0)
        tracker._fd = tracker._pid = None


BACKGROUND = []     # every Background job, for the end of the run
STOPPING = threading.Event()    # set at the end of the run


def stoppable_sleep(seconds):
    """A FleetSupervisor's sleep that raises once the run is ending, so
    that a supervisor in a Background job kills its fleet and returns
    instead of spawning a new generation."""
    if STOPPING.wait(seconds):
        raise RuntimeError("chip_smoke: the run is ending")


class Background:
    """`fn(*args)` in a thread of this process; `result()` waits for it and
    returns its value or raises its exception."""

    def __init__(self, fn, *args):
        self.value, self.error = None, None
        self.thread = threading.Thread(target=self._run, args=(fn, args),
                                       daemon=True)
        BACKGROUND.append(self)
        self.thread.start()

    def _run(self, fn, args):
        try:
            self.value = fn(*args)
        except BaseException as e:      # re-raised by result()
            self.error = e

    def result(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.value


def stop_background(timeout=60.0):
    """End the run's Background jobs: set STOPPING, then wait for each."""
    STOPPING.set()
    for job in BACKGROUND:
        job.thread.join(timeout)


def become_subreaper():
    """Make this process the reaper of its orphaned descendants (Linux's
    PR_SET_CHILD_SUBREAPER on this process alone): a process that a rank, a
    worker or the fork server leaves behind is then still below this one
    for `end_descendants`, instead of being handed to the machine's init."""
    import ctypes
    try:
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def descendants():
    """The pids of every process below this one, from /proc's parent
    links, with each one's command line."""
    kids = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # after the ")" that ends the command: state, then the parent's pid
        ppid = int(stat[stat.rindex(")") + 2:].split()[1])
        kids.setdefault(ppid, []).append(int(name))
    out, todo = {}, [os.getpid()]
    while todo:
        for pid in kids.get(todo.pop(), []):
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            except OSError:
                cmd = "?"
            out[pid] = cmd.strip() or "(exited)"
            todo.append(pid)
    return out


def end_descendants(timeout=60.0):
    """SIGKILL every process below this one and reap it (the orphans among
    them are this process's children, `become_subreaper`), until none is
    left or `timeout` seconds have passed; those found are named on
    stderr. Returns the number left."""
    import signal
    left = descendants()
    if left:
        print(f"chip_smoke: ending {len(left)} processes left below this "
              "one: " + "; ".join(f"{p} {c[:120]}" for p, c in left.items()),
              file=sys.stderr)
    deadline = time.time() + timeout
    while left:
        for pid in left:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        while True:
            try:
                pid, _ = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                break
            if pid == 0:
                break
        left = descendants()
        if left and time.time() > deadline:
            print(f"chip_smoke: {len(left)} processes still below this one "
                  f"after {timeout} s: {sorted(left)}", file=sys.stderr)
            break
        time.sleep(0.05)
    return len(left)


def _rank_main(args, env):
    """A rank, forked by the fork server: a session and an environment of
    its own, then this script's main with `args`."""
    os.setsid()
    os.environ.clear()
    os.environ.update(env)
    sys.exit(main(args))


class _Rank:
    """A rank of `spawn_ranks`, with the Popen calls `wait_ranks` makes."""

    def __init__(self, proc):
        self.proc, self.pid = proc, proc.pid

    def poll(self):
        return self.proc.exitcode

    returncode = property(poll)

    def wait(self):
        self.proc.join()
        return self.proc.exitcode

    def kill(self):
        """SIGKILL the rank's session if it still runs, and reap it. A rank
        that has not reached its setsid yet is still in this script's
        process group: then the rank alone."""
        import signal
        if self.poll() is None:
            try:
                if os.getpgid(self.pid) == self.pid:
                    os.killpg(self.pid, signal.SIGKILL)
                else:
                    os.kill(self.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            self.wait()


def spawn_ranks(args, n, env=None):
    """Start `n` ranks of this script with `args` (`rank_context`), as one
    job over a fresh localhost port (the SPION_* environment)."""
    from repro_torch.distributed.supervisor import free_port
    port = free_port()
    ctx = rank_context()
    procs = []
    for i in range(n):
        e = dict(os.environ if env is None else env,
                 SPION_COORDINATOR=f"localhost:{port}",
                 SPION_NUM_PROCESSES=str(n), SPION_PROCESS_ID=str(i))
        proc = ctx.Process(target=_rank_main, args=(list(args), e))
        proc.start()
        procs.append(_Rank(proc))
    RANKS.extend(procs)
    return procs


def wait_ranks(procs, what, timeout=600):
    """Wait for every rank; any rank's failure fails the phase, and the
    others are killed then (a rank left alone waits in a collective)."""
    t0 = time.time()
    try:
        while any(p.poll() is None for p in procs):
            bad = [p.returncode for p in procs
                   if p.returncode not in (None, 0)]
            check(not bad, f"{what}: a rank exited with {bad}")
            check(time.time() - t0 < timeout, f"{what}: ranks still running "
                  f"after {timeout} s")
            time.sleep(0.1)
        rcs = [p.returncode for p in procs]
        check(rcs == [0] * len(procs), f"{what}: ranks exited with {rcs}")
    finally:
        for p in procs:
            p.kill()


def seq_tables(shp):
    """Layer 0 of the dry-run plan of a SEQ_SHAPES entry: (col, nvalid,
    row_idx, nvalid_t, halo), host numpy."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import spion_dryrun_tables
    cfg = get_config(shp["arch"])
    cfg = cfg.replace(spion=dataclasses.replace(cfg.spion,
                                                block_size=shp["block"]))
    check(cfg.causal == shp["causal"], f"{shp['arch']}: causal changed")
    t = spion_dryrun_tables(cfg, shp["S"], layers=1,
                            max_extent=shp["max_extent"])
    return tuple(t[k][0].numpy() for k in ("col_idx", "nvalid", "row_idx",
                                           "nvalid_t")) + (tuple(t["halo"]),)


def seq_worker(d):
    """Phase 12a's rank (`--seq-worker DIR`, 4 ranks on the card over
    gloo): for each SEQ_SHAPES entry, dtype and job size (2 and 4 ranks;
    ranks 2 and 3 wait out the 2-rank runs), the sharded op on this rank's
    rows against the unsharded kernels on the same card: o, lse and dq
    bitwise, dk and dv at grad_limit, in the plan form and the plan-less
    form; then the bf16 plan form timed. Writes DIR/seq_<rank>.json."""
    import numpy as np
    import torch
    from repro_torch.distributed import runtime
    from repro_torch.distributed.sharding import (kernel_pspecs_from_axes,
                                                  local_slices)
    from repro_torch.kernels import sharded as sh
    from repro_torch.kernels.block_sparse_attn import (
        block_sparse_fwd, fused_block_sparse_attention, load_library)
    from repro_torch.launch.mesh import make_mesh, make_seq_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    check(runtime.initialize(), "the seq worker did not join its job")
    pid = runtime.process_index()
    load_library()
    meshes = {4: make_seq_mesh(4, 1),
              2: make_mesh((2, 1), ("seq", "data"), ranks=[0, 1])}
    out = {"rank": pid, "runs": []}
    for name, shp in SEQ_SHAPES.items():
        col, nvalid, row, nvt, halo = seq_tables(shp)
        B, KV, G, S, hd, block = (shp[k] for k in
                                  ("B", "KV", "G", "S", "hd", "block"))
        dev = DEVICE
        colt, nvt_ = (torch.as_tensor(a, device=dev) for a in (col, nvalid))
        rowt, nvtt = (torch.as_tensor(a, device=dev) for a in (row, nvt))
        kw = dict(block=block, causal=shp["causal"])
        for dtype in ("float32", "bfloat16"):
            gen = torch.Generator(device=dev).manual_seed(SEED)
            dt = getattr(torch, dtype)
            full = {n: torch.randn(s, generator=gen, device=dev).to(dt)
                    for n, s in (("q", (B, KV, G, S, hd)),
                                 ("k", (B, KV, S, hd)), ("v", (B, KV, S, hd)),
                                 ("g", (B, KV, G, S, hd)))}
            N = B * KV
            o_ref, lse_ref = block_sparse_fwd(
                full["q"].reshape(N, G, S, hd), full["k"].reshape(N, S, hd),
                full["v"].reshape(N, S, hd), colt, nvt_, **kw)
            refs = {}
            for form in ("plan", "planless"):
                q, k, v = (full[n].clone().requires_grad_() for n in "qkv")
                tk = dict(row_idx=rowt, nvalid_t=nvtt) if form == "plan" \
                    else {}
                o = fused_block_sparse_attention(
                    q.reshape(N, G, S, hd), k.reshape(N, S, hd),
                    v.reshape(N, S, hd), colt, nvt_, **tk, **kw)
                o.backward(full["g"].reshape(N, G, S, hd))
                refs[form] = {"dq": q.grad, "dk": k.grad, "dv": v.grad}
            o_ref = o_ref.reshape(B, KV, G, S, hd)
            lse_ref = lse_ref.reshape(B, KV, G, S)
            for n_r in SEQ_RANKS:
                if pid < n_r:
                    out["runs"] += seq_rank_runs(
                        meshes[n_r], name, shp, dtype, full, o_ref, lse_ref,
                        refs, (colt, nvt_, rowt, nvtt, halo), d)
                runtime.barrier(f"seq {name} {dtype} {n_r}")
    out["transport"] = runtime.transport(meshes[4].group("seq"),
                                         torch.zeros(1, device=DEVICE))
    with open(os.path.join(d, f"seq_{pid}.json"), "w") as f:
        json.dump(out, f)
    runtime.shutdown(0)   # ends the process
    return 0


def seq_rank_runs(mesh, name, shp, dtype, full, o_ref, lse_ref, refs,
                  tables, d):
    """One rank's share of one (shape, dtype, job size) of seq_worker:
    the plan form and the plan-less form held, the bf16 plan form timed."""
    import torch
    from repro_torch.distributed.sharding import (kernel_pspecs_from_axes,
                                                  local_slices)
    from repro_torch.kernels import sharded as sh
    from repro_torch.kernels.block_sparse_attn import (
        block_sparse_fwd, fused_block_sparse_attention)
    colt, nvt_, rowt, nvtt, halo = tables
    B, KV, G, S, hd, block = (shp[k] for k in
                              ("B", "KV", "G", "S", "hd", "block"))
    qs, ks, _ = kernel_pspecs_from_axes(None, None, "seq")
    sl_q = local_slices(mesh, qs, full["q"].shape)
    sl_k = local_slices(mesh, ks, full["k"].shape)
    n = mesh.shape["seq"]
    S_l, W = S // n, S // n // block
    r0 = mesh.axis_index("seq") * W
    h_l, h_r = halo
    N = B * KV
    runs = []
    for form in ("plan", "planless"):
        tk = dict(row_idx=rowt, nvalid_t=nvtt) if form == "plan" else {}
        q, k, v = (full[x][sl].clone().requires_grad_()
                   for x, sl in (("q", sl_q), ("k", sl_k), ("v", sl_k)))

        def op():
            return sh.sharded_fused_attention(
                mesh, q, k, v, colt, nvt_, halo=halo, causal=shp["causal"],
                block=block, **tk)
        o = op()
        o.backward(full["g"][sl_q])
        with torch.no_grad():     # lse on the halo storage, kernel level
            kh, vh = sh.halo_forward(
                sh.Halo(mesh, h_l * block, h_r * block, k),
                k.reshape(N, S_l, hd), v.reshape(N, S_l, hd))
            col_l, nv_l, row_l, nvt_l = sh.local_tables(
                colt, nvt_, tk.get("row_idx"), tk.get("nvalid_t"), r0=r0,
                W=W, h_l=h_l, h_r=h_r)
            lkw = dict(block=block, causal=shp["causal"],
                       offsets=(r0, r0 - h_l), seq_len=S)
            o2, lse = block_sparse_fwd(q.reshape(N, G, S_l, hd).contiguous(),
                                       kh.contiguous(), vh.contiguous(),
                                       col_l, nv_l, **lkw)
        got = {"o": o.detach(), "o_kernel": o2.reshape(o.shape),
               "lse": lse.reshape(B, KV, G, S_l)}
        want = {"o": o_ref[sl_q], "o_kernel": o_ref[sl_q],
                "lse": lse_ref[sl_q[:4]]}
        rec = {"shape": name, "dtype": dtype, "ranks": n, "form": form,
               "halo": list(halo)}
        for key in ("o", "o_kernel", "lse"):
            diff = (got[key].float() - want[key].float()).abs().max().item()
            rec[key] = diff
            check(diff == 0.0, f"seq {name} {dtype} {n} ranks {form}: {key} "
                  f"differs from the unsharded kernel's by {diff}")
        ref = refs[form]
        rows = {"dq": (q.grad, ref["dq"][sl_q]),
                "dk": (k.grad, ref["dk"][sl_k]),
                "dv": (v.grad, ref["dv"][sl_k])}
        dq = (rows["dq"][0].float() - rows["dq"][1].float()).abs().max()
        rec["dq"] = dq.item()
        check(rec["dq"] == 0.0, f"seq {name} {dtype} {n} ranks {form}: dq "
              f"differs from the unsharded kernel's by {rec['dq']}")
        for g in ("dk", "dv"):
            got_g, ref_g = (t.float() for t in rows[g])
            err, share, _, _ = hold_grad(g, dtype, got_g, ref_g,
                                         f"seq {name} {n} ranks {form}")
            rec[g], rec[f"{g}_share"] = err, share
        if dtype == "bfloat16" and form == "plan":
            go = full["g"][sl_q]

            def step():
                op().backward(go)
            h0 = sh.halo_seconds
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(SEQ_TIMING_REPS):
                step()
            torch.cuda.synchronize()
            rec["op_ms"] = 1e3 * (time.perf_counter() - t) / SEQ_TIMING_REPS
            rec["halo_ms"] = 1e3 * (sh.halo_seconds - h0) / SEQ_TIMING_REPS
            ql = q.detach().reshape(N, G, S_l, hd).clone().requires_grad_()
            kl, vl = (x.detach().clone().requires_grad_() for x in (kh, vh))
            gl = go.reshape(N, G, S_l, hd)

            def kernels():
                fused_block_sparse_attention(
                    ql, kl, vl, col_l, nv_l, row_idx=row_l, nvalid_t=nvt_l,
                    block=block, causal=shp["causal"], offsets=(r0, r0 - h_l),
                    seq_len=S).backward(gl)
            rec["kernels_ms"] = cuda_ms(kernels, SEQ_TIMING_REPS)
        runs.append(rec)
    return runs


def dp_worker(d, stages):
    """A rank of a data-parallel spion-lra job (`--dp-worker DIR`, the
    SPION_* environment): the ListOps preset's global batch over the ranks,
    checkpoints in DIR every CKPT_EVERY steps, to step TRAIN_STEPS, resumed
    from DIR's latest checkpoint when there is one. Every step appends
    {pid, step, phase, loss, launches, s} to DIR/losses_<rank>.jsonl; the
    end writes DIR/done_<rank>_<pid>.json (step, phase, plan digest,
    preempted, launches, peak memory). SPION_SMOKE_DP=train (12b) adds the
    planted faults' losses and the SIGTERM leg of 12c (`dp_term`).
    `stages` holds the wall-clock times of main()'s start and of torch's
    import; the worker adds its own start-up stages and writes them to
    DIR/start_<rank>_<pid>.json before its first step."""
    import numpy as np
    import torch
    from repro_torch.distributed import runtime
    from repro_torch.kernels.block_sparse_attn import load_library
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(runtime.initialize(), "the data-parallel worker did not join")
    stages["joined"] = time.time()
    rank, pid = runtime.process_index(), os.getpid()
    mode = os.environ.get("SPION_SMOKE_DP", "fleet")
    torch.zeros(1, device=DEVICE)
    torch.cuda.synchronize()
    stages["cuda"] = time.time()
    load_library()
    stages["library"] = time.time()
    reduce_s, inner_reduce = [], runtime.all_reduce_sum

    def all_reduce_sum(tensors, **kw):
        """The step's gradient all-reduce, timed (host clock around a
        synchronize on each side)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner_reduce(tensors, **kw)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t)
        return out
    runtime.all_reduce_sum = all_reduce_sum   # the steps bind it when made
    tr, cfg, _ = lra_trainer(ckpt_dir=d, heartbeat_interval=0.0)
    stages["trainer"] = time.time()
    runtime.all_reduce_sum = inner_reduce
    check(tr.mesh is not None and tr.mesh.size == runtime.process_count(),
          f"rank {rank}: the trainer's mesh is {tr.mesh}")
    tr.install_preemption_handler()
    resumed = tr.maybe_resume()
    stages["resumed"] = time.time()
    with open(os.path.join(d, f"start_{rank}_{pid}.json"), "w") as f:
        json.dump(stages, f)
    start = tr.step
    steps, _ = record_steps(tr)
    fills = []
    inner_generate = tr.spion_ctl._generate_local

    def generate(state, pooled):
        t = time.perf_counter()
        out = inner_generate(state, pooled)
        fills.append(time.perf_counter() - t)
        return out
    tr.spion_ctl._generate_local = generate

    def on_step(step, loss):
        r = steps[-1]
        with open(os.path.join(d, f"losses_{rank}.jsonl"), "a") as f:
            f.write(json.dumps({"pid": pid, "step": step, "loss": loss,
                                "phase": r["phase"], "s": r["s"],
                                "launches": r["launches"],
                                "t": time.time()}) + "\n")
    tr.step_callback = on_step
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    tr.train(TRAIN_STEPS - tr.step, ckpt_every=CKPT_EVERY, log_every=10**9,
             log=lambda m: None)
    stages["trained"] = time.time()
    st = tr.spion_state
    done = {"rank": rank, "pid": pid, "resumed": resumed, "start": start,
            "step": tr.step, "phase": st.phase, "preempted": tr.preempted,
            "digest": plan_digest_of(st) if st.tables else None,
            "masters": masters_digest(tr),
            "launches": launch_counts(), "fills": fills,
            "allreduce_ms": 1e3 * float(np.median(reduce_s)) if reduce_s
            else None,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "stats": st.plan_stats}
    if mode == "train":
        done["faults"] = dp_faults(rank)
        stages["faults"] = time.time()
        done["term"] = dp_term(d)
        stages["term"] = time.time()
    done["stages"] = stages
    with open(os.path.join(d, f"done_{rank}_{pid}.json"), "w") as f:
        json.dump(done, f)
    runtime.shutdown(0)   # ends the process
    return 0


def masters_digest(tr):
    """Digest of a trainer's fp32 masters (bytes and names): equal on every
    rank of a sound data-parallel run."""
    import hashlib
    h = hashlib.sha256()
    for n, p in tr.params.named_parameters():
        h.update(n.encode())
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:32]


def dp_faults(rank):
    """Planted data-parallel faults, DP_FAULT_STEPS dense steps each from
    the seed: "no_allreduce" (each rank updates with its own gradient
    share) and "one_shard" (every rank trains on the first half of the
    batch). Returns {fault: {"losses", "masters" (digest)}}."""
    import numpy as np
    import torch
    from repro_torch.distributed import runtime
    out = {}
    for fault in ("no_allreduce", "one_shard"):
        inner = runtime.all_reduce_sum
        if fault == "no_allreduce":
            runtime.all_reduce_sum = lambda ts, **kw: ts
        try:
            tr, _, _ = lra_trainer(sentinel=False)
        finally:
            runtime.all_reduce_sum = inner
        if fault == "one_shard":
            half = lra_config()[1]["batch"] // DP_RANKS

            def first_half(b, tr=tr):
                return {k: torch.as_tensor(np.asarray(v)[:half],
                                           device=tr.device)
                        for k, v in b.items()}
            tr._device_batch = first_half
        losses = tr.train(DP_FAULT_STEPS, ckpt_every=0, log_every=10**9,
                          log=lambda m: None)
        out[fault] = {"losses": losses, "masters": masters_digest(tr)}
        del tr
        runtime.barrier(f"fault {fault}")
    return out


def dp_term(d):
    """12c's SIGTERM leg, on 12b's ranks after their run: a trainer resumed
    from the checkpoint of step RESUME_AT (copied to DIR/term by process
    0), rank 1 sends itself one SIGTERM at DP_TERM_STEP. Returns {step,
    preempted, committed}: the step both ranks stopped at, and whether its
    checkpoint is committed."""
    import shutil
    from repro_torch.distributed import runtime
    from repro_torch.distributed.chaos import ChaosMonkey
    td = os.path.join(d, "term")
    src = f"step_{RESUME_AT:09d}"
    if runtime.is_coordinator():
        shutil.copytree(os.path.join(d, src), os.path.join(td, src))
    runtime.barrier("term copy")
    tr, _, _ = lra_trainer(ckpt_dir=td, heartbeat_interval=0.0,
                           chaos=ChaosMonkey(kill_step=DP_TERM_STEP,
                                             kill_process=1, sig="TERM"))
    tr.install_preemption_handler()
    check(tr.maybe_resume() and tr.step == RESUME_AT,
          f"the SIGTERM leg resumed at step {tr.step}")
    tr.train(TRAIN_STEPS - tr.step, ckpt_every=CKPT_EVERY, log_every=10**9,
             log=lambda m: None)
    return {"step": tr.step, "preempted": tr.preempted,
            "committed": os.path.exists(os.path.join(
                td, f"step_{tr.step:09d}", "DONE"))}


START_STAGES = (("main", "to main()"), ("torch", "import torch"),
                ("joined", "join the job"), ("cuda", "CUDA context"),
                ("library", "kernel library"), ("trainer", "trainer"),
                ("resumed", "resume"))


def stage_split(t0, stages, more=(), start=START_STAGES):
    """{stage: seconds since the stage before} of a worker's wall-clock
    `stages`, the first from `t0`: the `start` stages, then `more`."""
    out, prev = {}, t0
    for key, name in tuple(start) + tuple(more):
        out[name] = stages[key] - prev
        prev = stages[key]
    return out


def fmt_split(split):
    return ", ".join(f"{k} {v:.2f}" for k, v in split.items())


def read_dp(d):
    """(losses by rank: {step: record} of the last writer, done records by
    rank) of a data-parallel run in `d`."""
    losses, done = {}, {}
    for name in sorted(os.listdir(d)):
        path = os.path.join(d, name)
        if name.startswith("losses_"):
            with open(path) as f:
                rows = [json.loads(x) for x in f]
            losses[int(name[7:-6])] = rows
        elif name.startswith("done_"):
            with open(path) as f:
                rec = json.load(f)
            done.setdefault(rec["rank"], []).append(rec)
    return losses, done


def phase_seq_parallel():
    """12a: four ranks of this script on the card (gloo) run the
    sequence-parallel op at the SEQ_SHAPES and hold it against the
    unsharded kernels; their records are printed here."""
    import shutil
    d = os.path.join(DP_DIR, "seq")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    t0 = time.perf_counter()
    wait_ranks(spawn_ranks(["--seq-worker", d], max(SEQ_RANKS)),
               "the sequence-parallel ranks")
    wall = time.perf_counter() - t0
    recs = []
    for r in range(max(SEQ_RANKS)):
        with open(os.path.join(d, f"seq_{r}.json")) as f:
            recs.append(json.load(f))
    transport = recs[0]["transport"]
    runs = [dict(run, rank=rec["rank"]) for rec in recs for run in rec["runs"]]
    want = len(SEQ_SHAPES) * 2 * 2 * sum(SEQ_RANKS)
    check(len(runs) == want, f"{len(runs)} sequence-parallel runs, not "
          f"{want}")
    out = {}
    for name, shp in SEQ_SHAPES.items():
        for n_r in SEQ_RANKS:
            sel = [r for r in runs if r["shape"] == name and r["ranks"] == n_r]
            worst = {k: max(r[k] for r in sel)
                     for k in ("o", "lse", "dq", "dk", "dv", "dk_share",
                               "dv_share")}
            timed = [r for r in sel if "op_ms" in r]
            log(f"seq-parallel {name} ({shp['B']}x{shp['KV']} rows, G "
                f"{shp['G']}, S {shp['S']}, hd {shp['hd']}, block "
                f"{shp['block']}, {'causal' if shp['causal'] else 'non-causal'}"
                f", halo {sel[0]['halo']}) on {n_r} ranks, fp32 and bf16, plan "
                f"and plan-less tables: o, lse and dq bitwise the unsharded "
                f"kernels' (max |diff| {worst['o']}, {worst['lse']}, "
                f"{worst['dq']}); dk, dv within grad_limit (max |diff| "
                f"{worst['dk']:.3e}, {worst['dv']:.3e}; at most "
                f"{max(worst['dk_share'], worst['dv_share']):.3f} of it); bf16 "
                f"plan form per rank: " + "; ".join(
                    f"rank {r['rank']} op fwd+bwd {r['op_ms']:.3f} ms, halo "
                    f"exchange {r['halo_ms']:.3f} ms, kernels "
                    f"{r['kernels_ms']:.3f} ms" for r in timed))
            out[f"{name}_{n_r}"] = dict(
                worst, op_ms=[r["op_ms"] for r in timed],
                halo_ms=[r["halo_ms"] for r in timed],
                kernels_ms=[r["kernels_ms"] for r in timed])
    log(f"seq-parallel: halo transport {transport} (ranks sharing a card "
        f"talk over gloo, which moves CUDA tensors only for broadcast and "
        f"all_reduce, so each neighbour's edge blocks cross as one message "
        f"through pinned host buffers); 4 ranks share the one card, so "
        f"their times overlap; phase 12a {wall:.1f} s")
    return dict(runs=out, transport=transport, seconds=wall)


def phase_data_parallel(train):
    """12b: spion-lra at ListOps size through phase 5's TRAIN_STEPS steps
    as a job of DP_RANKS ranks on the card (64 sequences a rank): every
    sparse step of every rank launches 8 + 4 + 4 kernels, the ranks' plan
    digests are equal, the dense-phase losses equal phase 5's within
    TOL_DP; the planted faults' gaps, whether the plan equals phase 5's,
    step times and peak memory are printed."""
    import shutil
    import numpy as np
    d = os.path.join(DP_DIR, "train")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    t0, t_spawn = time.perf_counter(), time.time()
    wait_ranks(spawn_ranks(["--dp-worker", d], DP_RANKS,
                           env=dict(os.environ, SPION_SMOKE_DP="train")),
               "the data-parallel ranks")
    wall = time.perf_counter() - t0
    losses, done = read_dp(d)
    check(sorted(done) == list(range(DP_RANKS)) and
          all(len(v) == 1 for v in done.values()),
          f"done records {sorted(done)}")
    done = {r: v[0] for r, v in done.items()}
    cfg, ref = train["cfg"], train["losses"]
    want = sparse_launches(cfg)
    for r in range(DP_RANKS):
        rows = losses[r]
        check([x["step"] for x in rows] == list(range(TRAIN_STEPS)),
              f"rank {r} ran steps {[x['step'] for x in rows]}")
        sparse = [x for x in rows if x["phase"] == "sparse"]
        check(sparse and all(x["launches"] == want for x in sparse),
              f"rank {r}: a sparse step launched other than {want}: "
              f"{[x['launches'] for x in sparse]}")
        check(done[r]["launches"] == {k: n * len(sparse)
                                      for k, n in want.items()},
              f"rank {r} launched {done[r]['launches']}")
        check(all(not any(x["launches"].values()) for x in rows
                  if x["phase"] == "dense"), f"rank {r}: a dense step "
              "launched a kernel")
    digests = {done[r]["digest"] for r in range(DP_RANKS)}
    check(len(digests) == 1 and None not in digests,
          f"the ranks' plan digests differ: {digests}")
    got = [x["loss"] for x in losses[0]]
    check(got == [x["loss"] for x in losses[1]],
          "the ranks' losses differ")
    dense_n = min(train["dense_steps"],
                  sum(x["phase"] == "dense" for x in losses[0]))
    gap = loss_gap(got[:dense_n], ref[:dense_n])
    sparse_gap = loss_gap(got[dense_n:], ref[dense_n:]) \
        if dense_n < TRAIN_STEPS else 0.0
    masters = {done[r]["masters"] for r in range(DP_RANKS)}
    check(len(masters) == 1, f"the ranks' masters differ after the run: "
          f"{masters}")
    faults = done[0]["faults"]
    fault_gaps = {f: loss_gap(v["losses"], ref[:DP_FAULT_STEPS])
                  for f, v in faults.items()}
    split = {f: done[0]["faults"][f]["masters"] !=
             done[1]["faults"][f]["masters"] for f in faults}
    same_plan = done[0]["digest"] == plan_digest_of(
        train["trainer"].spion_state)
    step_ms = {r: {ph: float(np.median([1e3 * x["s"] for x in losses[r][1:]
                                        if x["phase"] == ph]))
                   for ph in ("dense", "sparse")} for r in range(DP_RANKS)}
    log(f"data-parallel: {DP_RANKS} ranks on the card (gloo), spion-lra at "
        f"ListOps size, {lra_config()[1]['batch'] // DP_RANKS} sequences a "
        f"rank: {TRAIN_STEPS} steps in {wall:.1f} s (spawn included); "
        f"{dense_n} dense steps then sparse, each sparse step {want} per "
        f"rank; plan digests equal ({done[0]['digest']}); the plan from the "
        f"reduced pooled map {'equals' if same_plan else 'DIFFERS from'} "
        f"phase 5's; dense losses vs phase 5's max rel {gap:.3e}, sparse "
        f"{sparse_gap:.3e} (gate {TOL_DP} on the dense ones); masters "
        f"bitwise equal across the ranks; planted faults over "
        f"{DP_FAULT_STEPS} dense steps: " + ", ".join(
            f"{f} loss gap {g:.3e}, masters "
            f"{'split' if split[f] else 'equal'} across the ranks"
            for f, g in fault_gaps.items())
        + "; per rank: " + "; ".join(
            f"rank {r} step median dense {step_ms[r]['dense']:.2f} ms sparse "
            f"{step_ms[r]['sparse']:.2f} ms, gradient all-reduce median "
            f"{done[r]['allreduce_ms']:.3f} ms, peak {done[r]['peak_gb']:.2f} GB"
            f", flood fill {', '.join(f'{1e3 * s:.1f}' for s in done[r]['fills']) or 'none'} ms"
            for r in range(DP_RANKS)))
    log(f"data-parallel losses: {', '.join(f'{x:.6f}' for x in got)}")
    clock = stage_split(t_spawn, done[0]["stages"], (
        ("trained", f"{TRAIN_STEPS} steps"), ("faults", "planted faults"),
        ("term", "SIGTERM leg")))
    clock["exit"] = wall - sum(clock.values())
    log(f"data-parallel wall clock, rank 0, s: {fmt_split(clock)}; "
        f"{wall:.1f} in all; the steps themselves "
        f"{sum(x['s'] for x in losses[0]):.2f} of the {TRAIN_STEPS} steps'")
    check(gap <= TOL_DP, f"the 2-rank dense losses differ from phase 5's "
          f"by {gap}; gate {TOL_DP}")
    check(split["no_allreduce"] and fault_gaps["one_shard"] > TOL_DP,
          f"a planted fault passes the gates: {fault_gaps}, masters split "
          f"{split}")
    return dict(dir=d, losses=got, launches={
        k: sum(done[r]["launches"][k] for r in range(DP_RANKS))
        for k in KERNELS}, gap=gap, fault_gaps=fault_gaps,
        term=[done[r]["term"] for r in range(DP_RANKS)],
        same_plan=same_plan, step_ms=step_ms, seconds=wall,
        allreduce_ms=[done[r]["allreduce_ms"] for r in range(DP_RANKS)],
        peak_gb=[done[r]["peak_gb"] for r in range(DP_RANKS)])


def phase_fleet(dp):
    """12c: the fleet's recovery. (i) FleetSupervisor(nproc=DP_RANKS) from
    12b's sparse checkpoint of step RESUME_AT, rank 1 SIGKILLed at
    DP_KILL_STEP: one respawn of the whole generation, which resumes from
    process 0's checkpoint of step RESUME_AT and finishes; the stitched
    losses equal 12b's within TOL_RESUME; every step of both generations
    8 + 4 + 4 a rank. (ii) 12b's ranks ran the SIGTERM leg (`dp_term`):
    both ranks saved at DP_TERM_STEP and stopped."""
    import shutil
    from repro_torch.distributed.supervisor import FleetSupervisor
    cfg_launch = sparse_launches(lra_config()[0])
    kd = os.path.join(DP_DIR, "kill")
    shutil.rmtree(kd, ignore_errors=True)
    os.makedirs(kd)
    src = f"step_{RESUME_AT:09d}"
    shutil.copytree(os.path.join(dp["dir"], src), os.path.join(kd, src))
    t0 = time.perf_counter()
    env = dict(os.environ, SPION_CHAOS_KILL_STEP=str(DP_KILL_STEP),
               SPION_CHAOS_KILL_PROC="1",
               SPION_CHAOS_ONCE_DIR=os.path.join(kd, "once"))
    sup = FleetSupervisor(
        [sys.executable, os.path.abspath(__file__), "--dp-worker", kd],
        DP_RANKS, kd, dead_timeout=180.0, hang_timeout=180.0,
        poll_interval=0.2, max_respawns=2, backoff_base=0.1, backoff_max=1.0,
        env=env, log=lambda m: log(f"  {m}"))
    rc = sup.run()
    wall = time.perf_counter() - t0
    check(rc == 0 and sup.respawns == 1,
          f"the supervisor returned {rc} after {sup.respawns} respawns")
    losses, done = read_dp(kd)
    check(all(len(done.get(r, [])) == 1 for r in range(DP_RANKS)),
          f"generation 1's done records {done}")
    gen1 = {r: done[r][0]["pid"] for r in range(DP_RANKS)}
    rows = losses[0]
    g0 = [x for x in rows if x["pid"] != gen1[0]]
    g1 = [x for x in rows if x["pid"] == gen1[0]]
    check([x["step"] for x in g0] == list(range(RESUME_AT, DP_KILL_STEP))
          and [x["step"] for x in g1] == list(range(RESUME_AT, TRAIN_STEPS)),
          f"generation 0 ran steps {[x['step'] for x in g0]}, generation 1 "
          f"{[x['step'] for x in g1]}")
    for r in range(DP_RANKS):
        check(all(x["phase"] == "sparse" and x["launches"] == cfg_launch
                  for x in losses[r]), f"rank {r}: a resumed step launched "
              f"other than {cfg_launch}")
    stitched = {x["step"]: x["loss"] for x in rows}
    gap = loss_gap([stitched[s] for s in range(RESUME_AT, TRAIN_STEPS)],
                   dp["losses"][RESUME_AT:])
    respawn_s = g1[0]["t"] - g0[-1]["t"]
    with open(os.path.join(kd, f"start_0_{gen1[0]}.json")) as f:
        split = stage_split(g0[-1]["t"], json.load(f))
    split["first step"] = g1[0]["t"] - g0[-1]["t"] - sum(split.values())
    # the first stage: the supervisor sees the death, ends rank 0, backs
    # off and starts generation 1, whose interpreter reaches main()
    split = {("teardown and spawn to main()" if k == "to main()" else k): v
             for k, v in split.items()}
    hbs = [os.path.exists(os.path.join(kd, f"hb_{r}"))
           for r in range(DP_RANKS)]
    check(all(hbs), f"heartbeat files {hbs}")
    term = dp["term"]
    check(all(t["preempted"] and t["committed"] for t in term) and
          {t["step"] for t in term} == {DP_TERM_STEP},
          f"the SIGTERM leg ended {term}")
    log(f"fleet: rank 1 of {DP_RANKS} SIGKILLed at step {DP_KILL_STEP}; the "
        f"supervisor respawned the generation once; generation 1 resumed at "
        f"step {RESUME_AT} (process 0's checkpoint) and finished; from "
        f"generation 0's last step to generation 1's first {respawn_s:.2f} "
        f"s (rank 0, s: {fmt_split(split)}); stitched losses vs 12b's max "
        f"rel {gap:.3e} (gate {TOL_RESUME}); phase 12c {wall:.1f} s; 12b's ranks, one SIGTERM on rank 1 at step "
        f"{DP_TERM_STEP}: both saved at step {DP_TERM_STEP} and stopped")
    check(gap <= TOL_RESUME, f"stitched losses differ from 12b's by {gap}; "
          f"gate {TOL_RESUME}")
    return dict(seconds=respawn_s, wall=wall, gap=gap, launches={
        k: sum(done[r][0]["launches"][k] for r in range(DP_RANKS))
        for k in KERNELS})


SEQ_TRAIN_MESH = (2, 2)     # 12d: 'seq' x 'data', four ranks on the card
SEQ_DECODER_LAYERS = 2      # internvl2-2b's 24 layers cut to 2 (reduced)
SEQ_DECODER_BATCH = 2       # sequences of 256 patches + 1792 tokens
SEQ_DECODER_EXTENT = 8      # the decoder plan's band: halo (<= 8, 0) blocks
# 12d: the capture on the ranks' shards against phase 5's, as a share of
# the map's largest entry. The shards' bf16 q and k round where phase 5's
# do not (other matmul shapes, masters within TOL_DP): on one H100 80GB
# HBM3 at 700 W the sound captures read up to 5.630e-05, the planted zero
# rows in the last panel 4.815e-02.
TOL_CAPTURE = 1e-3
# 12d's decoder steps, fp32 on the card: the loss's relative gap to one
# process, and each gradient leaf's largest |difference| over its largest
# |element|. The shards' sums run in another order than one process's.
TOL_SEQ_LOSS = 3e-5
TOL_SEQ_GRAD = 1e-4


def gather_timer():
    """Wrap distributed.sharding.GatherSeq so that its forward (the
    all_gather) and backward (the all-reduce) add their host seconds to
    the returned dict's "fwd" and "bwd" (a synchronize on each side)."""
    import torch
    from repro_torch.distributed import sharding
    secs = {"fwd": 0.0, "bwd": 0.0}
    fwd, bwd = sharding.GatherSeq.forward, sharding.GatherSeq.backward

    def timed(key, fn):
        def run(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            secs[key] += time.perf_counter() - t
            return out
        return staticmethod(run)
    sharding.GatherSeq.forward = timed("fwd", fwd)
    sharding.GatherSeq.backward = timed("bwd", bwd)
    return secs


def zero_next_rows(q, nf):
    """Phase 12d's planted capture fault: the last panel of every shard
    reads zero rows in place of the next shard's first rows."""
    return q.new_zeros((q.shape[0], nf, *q.shape[2:]))


def kv_local_backward(ctx, g):
    """Phase 12d's planted K/V fault: the gather's backward keeps this
    shard's rows of the gradient without summing them over 'seq'."""
    return (g.narrow(ctx.dim, ctx.idx * ctx.rows, ctx.rows), None, None,
            None, None)


def seqtrain_lra(mesh, d, rank):
    """12d's main path on one rank: spion-lra at ListOps size through
    phase 5's TRAIN_STEPS steps on `mesh`, every capture timed and kept;
    the first capture also run with the planted zero rows."""
    import numpy as np
    import torch
    from repro_torch.distributed.sharding import kernel_seq_axis
    from repro_torch.models import attention as A
    tr, cfg, _ = lra_trainer(mesh=mesh)
    check(tr.mesh is mesh, f"rank {rank}: the trainer's mesh is {tr.mesh}")
    steps, undo = record_steps(tr)
    secs = gather_timer()
    caps, pooled, planted = [], [], []
    in_captures = [0.0]          # gather seconds inside the captures
    inner_capture = tr.capture

    def capture(batch):
        g0 = secs["fwd"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner_capture(batch)
        torch.cuda.synchronize()
        caps.append({"ms": 1e3 * (time.perf_counter() - t),
                     "gather_ms": 1e3 * (secs["fwd"] - g0)})
        pooled.append(out[0].float().cpu().numpy())
        if not planted:
            sound, A.next_shard_rows = A.next_shard_rows, zero_next_rows
            try:
                planted.append(inner_capture(batch)[0].float().cpu().numpy())
            finally:
                A.next_shard_rows = sound
        in_captures[0] += secs["fwd"] - g0
        return out
    tr.capture = capture
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    gather_steps = []

    def on_step(step, loss):
        gather_steps.append(
            1e3 * (secs["fwd"] + secs["bwd"] - in_captures[0]))
    tr.step_callback = on_step
    tr.train(TRAIN_STEPS, ckpt_every=0, log_every=10**9, log=lambda m: None)
    undo()
    st = tr.spion_state
    block = cfg.spion.block_size
    axis, reason = kernel_seq_axis(mesh, tr.seq_len // block,
                                   st.plan_stats["halo"])
    np.savez(os.path.join(d, f"pooled_{rank}.npz"),
             **{f"p{i}": p for i, p in enumerate(pooled)},
             zero_rows=planted[0])
    # the K/V gathers' ms a step (forward and backward)
    gathers = np.diff([0.0] + gather_steps).tolist()
    out = {"losses": [r["loss"] for r in steps],
           "phases": [r["phase"] for r in steps],
           "launches": [r["launches"] for r in steps],
           "step_ms": [1e3 * r["s"] for r in steps],
           "gather_ms": gathers, "captures": caps,
           "digest": plan_digest_of(st), "stats": st.plan_stats,
           "masters": masters_digest(tr),
           "branch": "halo" if axis else "gathered fallback",
           "reason": reason, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del tr
    return out


def seqtrain_decoder(mesh, rank):
    """12d's decoder part on one rank: internvl2-2b at full width,
    SEQ_DECODER_LAYERS layers, fp32, SEQ_DECODER_BATCH sequences: a dense
    and a sparse make_loss_and_grads on `mesh` (the plan banded so that
    the halo exchange runs), and the dense one again with the planted K/V
    fault. Rank 0 also runs both steps in one process on the global batch
    and holds the mesh steps (and the fault) against them."""
    import hashlib
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import local_batch
    from repro_torch.distributed import runtime, sharding
    from repro_torch.distributed.sharding import kernel_seq_axis
    from repro_torch.launch.steps import (make_loss_and_grads,
                                          spion_dryrun_tables)
    from repro_torch.launch.train import masters_of
    from repro_torch.models.registry import build
    cfg = get_config("internvl2-2b").replace(num_layers=SEQ_DECODER_LAYERS,
                                             dtype="float32")
    P, block, S = cfg.num_patch_tokens, cfg.spion.block_size, INTERNVL_S
    check(P == 256 and cfg.d_model == 2048 and block == 64 and cfg.remat,
          "internvl2-2b config changed")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 21)
    params = masters_of(build(cfg).init(gen, device=DEVICE))
    rng = np.random.default_rng(SEED + 21)
    toks = rng.integers(0, cfg.vocab_size, size=(SEQ_DECODER_BATCH,
                                                 S - P + 1)).astype(np.int64)
    gb = {"patch_embeds": rng.standard_normal(
              (SEQ_DECODER_BATCH, P, cfg.d_model)).astype(np.float32),
          "tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tables = spion_dryrun_tables(cfg, S, max_extent=SEQ_DECODER_EXTENT)
    tables = {k: v.to(DEVICE) if torch.is_tensor(v) else v
              for k, v in tables.items()}
    axis, reason = kernel_seq_axis(mesh, S // block, tables["halo"])
    check(axis == "seq", f"the decoder plan does not take the halo path: "
          f"{reason}")
    batch = local_batch(mesh, gb, DEVICE)
    f = make_loss_and_grads(cfg, mesh=mesh, halo=tables["halo"])
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for kind in ("dense", "sparse", "planted"):
        tabs = tables if kind == "sparse" else None
        inner = sharding.GatherSeq.backward
        if kind == "planted":
            sharding.GatherSeq.backward = staticmethod(kv_local_backward)
        try:
            reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, grads = f(params, batch, tabs)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t)
        finally:
            sharding.GatherSeq.backward = inner
        h = hashlib.sha256()
        for k in sorted(grads):
            h.update(grads[k].cpu().numpy().tobytes())
        runs[kind] = {"loss": float(loss), "ms": ms,
                      "launches": launch_counts(),
                      "grads": h.hexdigest()[:32]}
        if rank == 0:
            runs[kind]["_grads"] = grads
        else:
            del grads
    peak = torch.cuda.max_memory_allocated() / 1e9
    if rank == 0:
        one = make_loss_and_grads(cfg)
        full = {k: torch.as_tensor(v, device=DEVICE) for k, v in gb.items()}
        for kind in ("dense", "sparse"):
            loss, ref = one(params, full, tables if kind == "sparse" else None)
            for k_ in ([kind, "planted"] if kind == "dense" else [kind]):
                got = runs[k_].pop("_grads")
                rel = {n: ((got[n] - g).abs().max() /
                           g.abs().max().clamp(min=1e-30)).item()
                       for n, g in ref.items()}
                worst = max(rel, key=rel.get)
                runs[k_].update(ref_loss=float(loss), grad_rel=rel[worst],
                                worst_leaf=worst,
                                loss_gap=loss_gap([runs[k_]["loss"]],
                                                  [float(loss)]))
                del got
            del ref
    runtime.barrier("decoder reference")
    return {"runs": runs, "peak_gb": peak, "reason": reason,
            "halo": list(tables["halo"]),
            "launches_want": sparse_launches(cfg)}


def seqtrain_worker(d, stages):
    """A rank of phase 12d (`--seqtrain-worker DIR`, the SPION_* environment
    of a job of 4): on the SEQ_TRAIN_MESH mesh, `seqtrain_lra` then
    `seqtrain_decoder`; writes DIR/seqtrain_<rank>.json and its start-up
    stages."""
    import gc
    import torch
    from repro_torch.distributed import runtime
    from repro_torch.kernels.block_sparse_attn import load_library
    from repro_torch.launch.mesh import make_seq_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(runtime.initialize(), "the 'seq' worker did not join its job")
    stages["joined"] = time.time()
    rank = runtime.process_index()
    torch.zeros(1, device=DEVICE)
    torch.cuda.synchronize()
    stages["cuda"] = time.time()
    load_library()
    stages["library"] = time.time()
    mesh = make_seq_mesh(*SEQ_TRAIN_MESH)
    out = {"rank": rank, "coords": mesh.coords()}
    out["lra"] = seqtrain_lra(mesh, d, rank)
    stages["trained"] = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    out["decoder"] = seqtrain_decoder(mesh, rank)
    stages["decoder"] = time.time()
    out["stages"] = stages
    with open(os.path.join(d, f"seqtrain_{rank}.json"), "w") as f:
        json.dump(out, f)
    runtime.shutdown(0)   # ends the process
    return 0


def phase_seq_train(train):
    """12d: SPION training over a 'seq' axis, four ranks of this script on
    the card (`--seqtrain-worker DIR`, mesh SEQ_TRAIN_MESH). The main path
    at phase 5's configuration, data and seed: dense losses within TOL_DP
    of phase 5's; each capture within TOL_CAPTURE of phase 5's and the
    planted zero rows past it; plan digests equal across the ranks, equal
    to phase 5's when the maps are bitwise phase 5's, else to this
    process's controller on the ranks' map; every sparse step 8 + 4 + 4 on
    every rank; masters bitwise equal across the ranks. The decoder:
    internvl2-2b's dense and sparse steps within TOL_SEQ_LOSS and
    TOL_SEQ_GRAD of one process, launches as a sparse step's, gradients
    bitwise equal across the ranks, the planted K/V fault past
    TOL_SEQ_GRAD."""
    import shutil
    import numpy as np
    from repro_torch.core.spion import SpionState
    d = os.path.join(DP_DIR, "seqtrain")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    n = SEQ_TRAIN_MESH[0] * SEQ_TRAIN_MESH[1]
    t0, t_spawn = time.perf_counter(), time.time()
    wait_ranks(spawn_ranks(["--seqtrain-worker", d], n),
               "the 'seq' training ranks")
    wall = time.perf_counter() - t0
    recs = []
    for r in range(n):
        with open(os.path.join(d, f"seqtrain_{r}.json")) as f:
            recs.append(json.load(f))
    pooled = [dict(np.load(os.path.join(d, f"pooled_{r}.npz")))
              for r in range(n)]
    cfg, ref = train["cfg"], train["losses"]
    want = sparse_launches(cfg)
    lra = [rec["lra"] for rec in recs]
    got = lra[0]["losses"]
    check(all(x["losses"] == got for x in lra), "the ranks' losses differ")
    for r, x in enumerate(lra):
        for ph, ln in zip(x["phases"], x["launches"]):
            check(ln == want if ph == "sparse" else not any(ln.values()),
                  f"rank {r}: a {ph} step launched {ln}")
    check("sparse" in lra[0]["phases"], "the 'seq' run never went sparse")
    dense_n = min(train["dense_steps"], lra[0]["phases"].count("dense"))
    gap = loss_gap(got[:dense_n], ref[:dense_n])
    check(len({x["digest"] for x in lra}) == 1,
          f"the ranks' plan digests differ: {[x['digest'] for x in lra]}")
    check(len({x["masters"] for x in lra}) == 1,
          "the ranks' masters differ after the run")
    # the captures against phase 5's
    caps = [k for k in pooled[0] if k != "zero_rows"]
    check(len(caps) == len(train["pooled"]), f"{len(caps)} captures, phase "
          f"5 made {len(train['pooled'])}")
    bitwise = True
    for r in range(n):
        for i, want_map in enumerate(train["pooled"]):
            m = pooled[r][f"p{i}"]
            check(np.array_equal(m, pooled[0][f"p{i}"]),
                  f"rank {r}'s capture {i} differs from rank 0's")
            bitwise &= bool(np.array_equal(m, want_map))
    cap_gaps = [float(np.abs(pooled[0][f"p{i}"] - w).max() / np.abs(w).max())
                for i, w in enumerate(train["pooled"])]
    cap_gap = max(cap_gaps)
    planted = float(np.abs(pooled[0]["zero_rows"] - train["pooled"][0]).max()
                    / np.abs(train["pooled"][0]).max())
    if bitwise:
        plan_ref, which = plan_digest_of(train["trainer"].spion_state), \
            "phase 5's"
    else:
        tr5 = train["trainer"]
        st = tr5.spion_ctl.generate(SpionState(),
                                    pooled[0][f"p{len(caps) - 1}"])
        plan_ref = plan_digest_of(st)
        which = "the controller's on the ranks' map"
    same_plan = lra[0]["digest"] == plan_ref
    phase5_plan = lra[0]["digest"] == plan_digest_of(
        train["trainer"].spion_state)
    # the decoder
    dec = [rec["decoder"] for rec in recs]
    d0 = dec[0]["runs"]
    for r, x in enumerate(dec):
        for kind in ("dense", "sparse"):
            ln = x["runs"][kind]["launches"]
            check(ln == (x["launches_want"] if kind == "sparse"
                         else {k: 0 for k in ln}),
                  f"rank {r}: the decoder's {kind} step launched {ln}")
            check(x["runs"][kind]["grads"] == d0[kind]["grads"],
                  f"rank {r}: the decoder's {kind} gradients differ from "
                  f"rank 0's")
    card = card_line()
    log(f"seq-train: {n} ranks on the card (gloo), mesh seq "
        f"{SEQ_TRAIN_MESH[0]} x data {SEQ_TRAIN_MESH[1]}, spion-lra at "
        f"ListOps size ({lra_config()[1]['batch'] // SEQ_TRAIN_MESH[1]} "
        f"sequences x {lra_config()[1]['seq_len'] // SEQ_TRAIN_MESH[0]} "
        f"positions a rank): {TRAIN_STEPS} steps, {dense_n} dense, then "
        f"sparse at {want} a step on every rank; dense losses vs phase 5's "
        f"max rel {gap:.3e} (gate {TOL_DP}); captures vs phase 5's "
        f"{', '.join('%.3e' % g for g in cap_gaps)} of the map's largest "
        f"entry ({'bitwise' if bitwise else 'not bitwise'}; gate "
        f"{TOL_CAPTURE}), planted zero rows {planted:.3e}; plan digests "
        f"equal ({lra[0]['digest']}), "
        f"{'equal to' if same_plan else 'DIFFERENT from'} {which}, "
        f"{'equal to' if phase5_plan else 'not'} phase 5's; the "
        f"trained plan (halo {lra[0]['stats']['halo']}) takes the "
        f"{lra[0]['branch']} ({lra[0]['reason']}); masters bitwise equal "
        f"across the ranks")
    for r, x in enumerate(lra):
        def med(ph):
            xs = [ms for ms, p in zip(x["step_ms"][1:], x["phases"][1:])
                  if p == ph]
            return float(np.median(xs)) if xs else float("nan")
        dense_g = [g for g, p in zip(x["gather_ms"][1:], x["phases"][1:])
                   if p == "dense"]
        cap_ms = ", ".join("%.2f" % c["ms"] for c in x["captures"])
        cap_g = ", ".join("%.2f" % c["gather_ms"] for c in x["captures"])
        log(f"seq-train rank {r} {recs[r]['coords']}: step median dense "
            f"{med('dense'):.2f} ms, sparse {med('sparse'):.2f} ms; K/V "
            f"gathers a dense step median {float(np.median(dense_g)):.2f} ms; "
            f"captures {cap_ms} ms (their gathers {cap_g} ms); launches "
            f"{sum_launches(x['launches'])}; peak {x['peak_gb']:.2f} GB "
            f"({card})")
    log(f"seq-train decoder: internvl2-2b, d_model 2048, "
        f"{SEQ_DECODER_LAYERS} of 24 layers, fp32, {SEQ_DECODER_BATCH} x "
        f"(256 patches + 1792 tokens), plan halo {dec[0]['halo']} "
        f"({dec[0]['reason']}): "
        + "; ".join(f"{kind} loss {d0[kind]['loss']:.6f} vs one process "
                    f"{d0[kind]['ref_loss']:.6f} (rel "
                    f"{d0[kind]['loss_gap']:.3e}), worst gradient leaf {d0[kind]['worst_leaf']} "
                    f"{d0[kind]['grad_rel']:.3e} of its largest"
                    for kind in ("dense", "sparse", "planted"))
        + f" (gates {TOL_SEQ_LOSS}, {TOL_SEQ_GRAD}); per rank: " + "; ".join(
            f"rank {r} dense {x['runs']['dense']['ms']:.1f} ms, sparse "
            f"{x['runs']['sparse']['ms']:.1f} ms, launches "
            f"{x['runs']['sparse']['launches']}, peak {x['peak_gb']:.2f} GB"
            for r, x in enumerate(dec)))
    clock = stage_split(t_spawn, recs[0]["stages"], (
        ("trained", f"trainer and {TRAIN_STEPS} steps"),
        ("decoder", "decoder steps")), start=START_STAGES[:5])
    clock["exit"] = wall - sum(clock.values())
    log(f"seq-train wall clock, rank 0, s: {fmt_split(clock)}; phase 12d "
        f"{wall:.1f} s")
    check(gap <= TOL_DP, f"the 'seq' dense losses differ from phase 5's by "
          f"{gap}; gate {TOL_DP}")
    check(cap_gap <= TOL_CAPTURE < planted, f"captures {cap_gap}, planted "
          f"{planted}; gate {TOL_CAPTURE}")
    check(same_plan, f"the ranks' plan differs from {which}")
    for kind in ("dense", "sparse"):
        check(d0[kind]["loss_gap"] <= TOL_SEQ_LOSS and
              d0[kind]["grad_rel"] <= TOL_SEQ_GRAD,
              f"the decoder's {kind} step misses one process's: {d0[kind]}")
    check(d0["planted"]["grad_rel"] > TOL_SEQ_GRAD,
          f"the planted K/V fault passes the gradient gate: {d0['planted']}")
    launches = {k: sum(sum(ln[k] for ln in x["launches"]) for x in lra)
                + sum(x["runs"]["sparse"]["launches"][k] for x in dec)
                for k in KERNELS}
    return dict(seconds=wall, launches=launches, gap=gap, cap_gap=cap_gap,
                planted=planted, branch=lra[0]["branch"],
                reason=lra[0]["reason"], peak_gb=[x["peak_gb"] for x in lra],
                decoder=d0)


SCAN_RANKS = 2              # 12e: a 'seq' mesh of 2, both ranks on the card
SCAN_S = 2048               # zamba2's and rwkv6's positions: 8 chunks of 128
SCAN_BATCH = 2              # sequences of zamba2's and rwkv6's steps
SCAN_ZAMBA_LAYERS = 12      # zamba2-1.2b's 38 layers cut to 12 (reduced):
                            # two applications of the shared block
SCAN_RWKV_LAYERS = 2        # rwkv6-7b's 32 layers cut to 2 (reduced)
SCAN_WHISPER_S = 512        # whisper's decoder tokens: 8 blocks of 64 (the
                            # reference's 448 = 7 blocks do not split into
                            # two whole-block shards)
SCAN_WHISPER_BATCH = 4
SCAN_TRAIN_STEPS = 8        # zamba2's bf16 Trainer: dense, capture, sparse
SCAN_STEPS_PER_EPOCH = 2
SCAN_BF16_STEPS = 3         # whisper's bf16 sparse steps on the kernels
# 12e's planted faults, each on the step whose gate it must miss: the carry
# dropped (every shard's scan from zero), the halo rows zeros, whisper's
# cross-attention over the local encoder shard, and C2's forward
# (no carry, no halo, positions from 0 on every shard)
SCAN_FAULTS = {"zamba2": (("carry", "sparse"), ("halo", "dense"),
                          ("c2", "sparse")),
               "rwkv6": (("carry", "dense"), ("halo", "dense")),
               "whisper": (("cross", "dense"),)}


def no_carry(decay, final):
    """The planted dropped carry: every shard's scan from zero (C2)."""
    import torch
    return torch.zeros_like(final)


def last_shard_carry(decay, final):
    """A planted composition fault: each shard's scan from the previous
    shard's final state alone, right on a 'seq' line of 2 and wrong where
    more than one earlier shard's summaries compose."""
    import torch
    from repro_torch.distributed.sharding import active_mesh, gather_seq
    i = active_mesh().axis_index("seq")
    lines = gather_seq(final[None], 0)
    return torch.where(torch.tensor(i == 0, device=final.device), 0.0,
                       lines[max(i - 1, 0)])


@contextlib.contextmanager
def planted_scan_fault(kind):
    """Phase 12e's planted faults (SCAN_FAULTS), by replacing the models'
    entry points for the duration; None plants nothing."""
    import torch
    from repro_torch.distributed import sharding
    from repro_torch.models import encdec, hybrid, mamba, rwkv
    saved = []

    def put(mod, name, fn):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def zero_rows(x, rows):
        return x.new_zeros((x.shape[0], rows, *x.shape[2:]))
    if kind in ("carry", "c2"):
        put(sharding, "seq_carry", no_carry)
    if kind in ("halo", "c2"):
        for mod in (mamba, rwkv):
            put(mod, "seq_left_rows", zero_rows)
    if kind == "c2":
        put(hybrid, "seq_positions", lambda rows, device: (
            0, *[torch.arange(rows, device=device)] * 2))
    if kind == "cross":
        put(encdec, "gather_seq", lambda x, dim: x)
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


GATHER_TIMING = [True]      # labelled_gather_timer's switch (untimed())


@contextlib.contextmanager
def untimed():
    """labelled_gather_timer's wrappers pass straight through, with no
    synchronize, for the duration."""
    GATHER_TIMING[0] = False
    try:
        yield
    finally:
        GATHER_TIMING[0] = True


def labelled_gather_timer():
    """Host seconds of the 'seq' gathers (GatherSeq's all_gather and its
    backward's all-reduce, a synchronize on each side), by what called
    them: "carry" (the scans' state carry), "halo" (the conv's and token
    shift's left rows), "kv" (the dense attention's K/V), "enc" (whisper's
    encoder output), "other"; and "grads", the steps' gradient all-reduce
    (runtime.all_reduce_sum, bound by steps made after this call). Returns
    the dict of seconds; the halo exchange of the sparse kernels is
    kernels/sharded.halo_seconds. The synchronizes slow a step: under
    `untimed()` the wrappers only call through."""
    import collections
    import torch
    from repro_torch.distributed import sharding
    from repro_torch.models import encdec, hybrid, mamba, rwkv
    secs = collections.defaultdict(float)
    label = ["other"]
    fwd, bwd = sharding.GatherSeq.forward, sharding.GatherSeq.backward

    def timed_fwd(ctx, *a):
        ctx.label = label[0]
        if not GATHER_TIMING[0]:
            return fwd(ctx, *a)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fwd(ctx, *a)
        torch.cuda.synchronize()
        secs[ctx.label] += time.perf_counter() - t
        return out

    def timed_bwd(ctx, g):
        if not GATHER_TIMING[0]:
            return bwd(ctx, g)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = bwd(ctx, g)
        torch.cuda.synchronize()
        secs[ctx.label] += time.perf_counter() - t
        return out
    sharding.GatherSeq.forward = staticmethod(timed_fwd)
    sharding.GatherSeq.backward = staticmethod(timed_bwd)

    def labelled(mod, name, lab):
        inner = getattr(mod, name)

        def run(*a, **k):
            prev, label[0] = label[0], lab
            try:
                return inner(*a, **k)
            finally:
                label[0] = prev
        setattr(mod, name, run)
    labelled(sharding, "seq_carry", "carry")
    for mod in (mamba, rwkv):
        labelled(mod, "seq_left_rows", "halo")
    for mod in (hybrid, encdec):
        labelled(mod, "gather_kv", "kv")
    labelled(encdec, "gather_seq", "enc")
    from repro_torch.distributed import runtime
    inner_sum = runtime.all_reduce_sum

    def timed_sum(*a, **k):      # the steps' gradient all-reduce
        if not GATHER_TIMING[0]:
            return inner_sum(*a, **k)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner_sum(*a, **k)
        torch.cuda.synchronize()
        secs["grads"] += time.perf_counter() - t
        return out
    runtime.all_reduce_sum = timed_sum
    return secs


def scan_sparse_launches(cfg):
    """A sparse step's launches on one rank: zamba2's shared block once per
    application (its remat recomputes the Mamba part only), whisper's
    decoder twice per layer forward (remat) and once backward."""
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import n_attn_apps
        n = n_attn_apps(cfg)
        return {k: n for k in KERNELS}
    return sparse_launches(cfg)


def scan_config(name, dtype="float32", whisper_s=SCAN_WHISPER_S,
                zamba_layers=SCAN_ZAMBA_LAYERS):
    """Phase 12e's configurations at full width: zamba2-1.2b at
    `zamba_layers` layers, rwkv6-7b at SCAN_RWKV_LAYERS, whisper-tiny
    whole (`whisper_s` decoder tokens); and the global batch each leg runs
    on (seeded)."""
    import numpy as np
    from repro_torch.configs import get_config
    rng = np.random.default_rng(SEED + 22)
    if name == "zamba2":
        cfg = get_config("zamba2-1.2b")
        check(cfg.d_model == 2048 and cfg.num_heads == 32 and
              cfg.ssm.expand == 2 and cfg.ssm.state_size == 64 and
              cfg.ssm.chunk == 128 and cfg.spion.block_size == 128 and
              cfg.remat, "zamba2-1.2b config changed")
        cfg = cfg.replace(num_layers=zamba_layers, dtype=dtype)
        B, S = SCAN_BATCH, SCAN_S
    elif name == "rwkv6":
        cfg = get_config("rwkv6-7b")
        check(cfg.d_model == 4096 and cfg.num_heads == 64 and
              cfg.ssm.chunk == 128, "rwkv6-7b config changed")
        cfg = cfg.replace(num_layers=SCAN_RWKV_LAYERS, dtype=dtype)
        B, S = SCAN_BATCH, SCAN_S
    else:
        cfg = get_config("whisper-tiny")
        check(cfg.d_model == 384 and cfg.encoder_layers == 4 and
              cfg.num_layers == 4 and cfg.spion.block_size == 64 and
              cfg.remat, "whisper-tiny config changed")
        cfg = cfg.replace(dtype=dtype)
        B, S = SCAN_WHISPER_BATCH, whisper_s
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int64)
    gb = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        gb["frames"] = rng.standard_normal(
            (B, WHISPER_ENC, cfg.d_model)).astype(np.float32)
    return cfg, gb


def grads_hash(grads, chunk=1 << 24):
    """A digest of the gradients' bits, summed on the card: per leaf the
    (wrapping) int64 sums of its words, of their squares and of each word
    times its position plus one, hashed with the leaf names on the host.
    Any single word that differs changes the digest, and so does a leaf's
    words in another order; it moves no leaf to the host."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for k in sorted(grads):
        g = grads[k].detach().contiguous().view(-1)
        w = g.view(torch.int32 if g.element_size() == 4 else torch.int16)
        acc = torch.zeros(3, dtype=torch.int64, device=g.device)
        for i in range(0, w.numel(), chunk):
            part = w[i:i + chunk].long()
            at = torch.arange(i + 1, i + 1 + part.numel(), device=g.device)
            acc += torch.stack([part.sum(), (part * part).sum(),
                                (part * at).sum()])
        h.update(k.encode())
        h.update(acc.cpu().numpy().tobytes())
    return h.hexdigest()[:32]


def scan_steps(name, mesh, rank, secs):
    """12e's fp32 leg of one family on one rank: make_loss_and_grads on
    `mesh`, dense and (zamba2, whisper) sparse on a plan banded to halo
    (1, 0), then each SCAN_FAULTS step planted; rank 0 also runs the steps
    in one process on the global batch and measures each mesh step's loss
    gap and worst gradient leaf against it."""
    import gc
    import torch
    from repro_torch.data.pipeline import local_batch
    from repro_torch.distributed import runtime
    from repro_torch.distributed.sharding import kernel_seq_axis
    from repro_torch.kernels import sharded
    from repro_torch.launch.steps import (make_loss_and_grads,
                                          spion_dryrun_tables)
    from repro_torch.launch.train import masters_of
    from repro_torch.models.registry import build
    cfg, gb = scan_config(name)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 22)
    params = masters_of(build(cfg).init(gen, device=DEVICE))
    tables, reason = None, None
    if cfg.spion.enabled:
        S, block = gb["tokens"].shape[1], cfg.spion.block_size
        layers = None
        if cfg.family == "hybrid":
            from repro_torch.models.hybrid import n_attn_apps
            layers = n_attn_apps(cfg)
        tables = spion_dryrun_tables(cfg, S, layers=layers, max_extent=1)
        tables = {k: v.to(DEVICE) if torch.is_tensor(v) else v
                  for k, v in tables.items()}
        axis, reason = kernel_seq_axis(mesh, S // block, tables["halo"])
        check(axis == "seq", f"12e {name}: the plan does not take the halo "
              f"path: {reason}")
    f = make_loss_and_grads(cfg, mesh=mesh,
                            halo=None if tables is None else tables["halo"])
    batch = local_batch(mesh, gb, DEVICE)
    # the planted faults first: they take the first steps' one-off costs
    kinds = [(f"{fault}:{on}", fault) for fault, on in SCAN_FAULTS[name]] + \
        [("dense", None)] + ([("sparse", None)] if tables else [])
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for kind, fault in kinds:
        sparse = kind.split(":")[-1] == "sparse"
        with planted_scan_fault(fault):
            reset_launch_counts()
            before = dict(secs)
            h0 = sharded.halo_seconds
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, grads = f(params, batch, tables if sparse else None)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t)
        runs[kind] = {"loss": float(loss), "ms": ms,
                      "launches": launch_counts(), "grads": grads_hash(grads),
                      "gather_ms": {k: 1e3 * (v - before.get(k, 0.0))
                                    for k, v in secs.items()},
                      "halo_ms": 1e3 * (sharded.halo_seconds - h0)}
        if rank == 0:
            runs[kind]["_grads"] = {k: g.cpu() for k, g in grads.items()}
        del grads
    # a dense step again without the timer's synchronizes: its time beside
    # the instrumented step's
    with untimed():
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, grads = f(params, batch, None)
        torch.cuda.synchronize()
        runs["dense"]["untimed_ms"] = 1e3 * (time.perf_counter() - t)
    del loss, grads
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the card is shared: every rank hands its cached blocks back before
    # rank 0's one-process steps (rwkv6's WKV exp(D) terms of a whole
    # sequence are tens of GB)
    gc.collect()
    torch.cuda.empty_cache()
    runtime.barrier(f"12e {name} mesh steps")
    if rank == 0:
        one = make_loss_and_grads(cfg)
        full = {k: torch.as_tensor(v, device=DEVICE) for k, v in gb.items()}
        for ref_kind in [k for k, _ in kinds if ":" not in k]:
            loss, ref = one(params, full,
                            tables if ref_kind == "sparse" else None)
            for kind in [k for k, _ in kinds
                         if k.split(":")[-1] == ref_kind]:
                got = runs[kind].pop("_grads")
                rel = {n: ((got[n].to(DEVICE) - g).abs().max() /
                           g.abs().max().clamp(min=1e-30)).item()
                       for n, g in ref.items()}
                worst = max(rel, key=rel.get)
                runs[kind].update(ref_loss=float(loss), grad_rel=rel[worst],
                                  worst_leaf=worst,
                                  loss_gap=loss_gap([runs[kind]["loss"]],
                                                    [float(loss)]))
            del ref
    else:
        for r in runs.values():
            r.pop("_grads", None)
    runtime.barrier(f"12e {name} reference")
    del params, f
    gc.collect()
    torch.cuda.empty_cache()
    return {"runs": runs, "peak_gb": peak, "reason": reason,
            "launches_want": scan_sparse_launches(cfg) if tables else None}


def scan_bf16_steps(mesh, secs):
    """12e's whisper leg in bf16: SCAN_BF16_STEPS sparse make_loss_and_grads
    on the kernels (the plan banded to halo (1, 0)), each step's loss,
    launches, time and gradients' digest."""
    import gc
    import torch
    from repro_torch.data.pipeline import local_batch
    from repro_torch.launch.steps import (make_loss_and_grads,
                                          spion_dryrun_tables)
    from repro_torch.launch.train import masters_of
    from repro_torch.models.registry import build
    cfg, gb = scan_config("whisper", dtype="bfloat16")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 22)
    params = masters_of(build(cfg).init(gen, device=DEVICE))
    tables = spion_dryrun_tables(cfg, gb["tokens"].shape[1], max_extent=1)
    f = make_loss_and_grads(cfg, mesh=mesh, halo=tables["halo"])
    batch = local_batch(mesh, gb, DEVICE)
    steps = []
    for _ in range(SCAN_BF16_STEPS):
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, grads = f(params, batch, tables)
        torch.cuda.synchronize()
        steps.append({"loss": float(loss),
                      "ms": 1e3 * (time.perf_counter() - t),
                      "launches": launch_counts(),
                      "grads": grads_hash(grads),
                      "finite": all(bool(torch.isfinite(g).all())
                                    for g in grads.values())})
        check(math.isfinite(steps[-1]["loss"]), "12e whisper bf16 loss "
              "not finite")
    del params, f, grads
    gc.collect()
    torch.cuda.empty_cache()
    return {"steps": steps, "launches_want": scan_sparse_launches(cfg)}


def lm_data_fn(cfg, batch, seq_len):
    """data_fn(step): `batch` random token sequences of seq_len + 1 tokens,
    seeded by (SEED, step); next-token targets."""
    import numpy as np

    def data_fn(step):
        rng = np.random.default_rng([SEED + 22, step])
        toks = rng.integers(0, cfg.vocab_size,
                            size=(batch, seq_len + 1)).astype(np.int64)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return data_fn


def scan_trainer(mesh, rank, secs):
    """12e's zamba2 Trainer on one rank: bf16, SCAN_ZAMBA_LAYERS layers,
    SCAN_BATCH x SCAN_S through SCAN_TRAIN_STEPS steps on `mesh` (dense
    steps, the capture on the shards at each epoch boundary, the flood
    fill on process 0 and its broadcast, sparse steps on the trained plan
    through whichever sharded path it takes). Each capture is timed and,
    on rank 0, held against the capture of one process on the global
    batch."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.distributed.sharding import (gather_seq,
                                                  kernel_seq_axis,
                                                  mesh_context)
    from repro_torch.launch.steps import compute_params
    from repro_torch.launch.train import Trainer
    cfg, _ = scan_config("zamba2", dtype="bfloat16")
    cfg = cfg.replace(spion=dataclasses.replace(
        cfg.spion, min_dense_epochs=1, max_dense_epochs=2))
    tr = Trainer(cfg, seq_len=SCAN_S, batch=SCAN_BATCH,
                 steps_per_epoch=SCAN_STEPS_PER_EPOCH,
                 data_fn=lm_data_fn(cfg, SCAN_BATCH, SCAN_S), seed=SEED + 22,
                 device=DEVICE, mesh=mesh, sentinel=False)
    check(tr.mesh is mesh, f"rank {rank}: the trainer's mesh is {tr.mesh}")
    steps, undo = record_steps(tr)
    caps = []
    inner_capture = tr.capture

    def capture(batch):
        g0 = dict(secs)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner_capture(batch)
        torch.cuda.synchronize()
        rec = {"ms": 1e3 * (time.perf_counter() - t),
               "gather_ms": 1e3 * sum(v - g0.get(k, 0.0)
                                      for k, v in secs.items())}
        with torch.no_grad():
            full = {k: gather_seq(v, 1, mesh) for k, v in batch.items()}
            if rank == 0:
                cap = tr.spion_ctl.capture_kwargs(tr.spion_state)
                pc = compute_params(tr.params, getattr(torch, cfg.dtype))
                with mesh_context(None):
                    want = tr.bundle.forward(pc, full, capture=cap)[1]
                want = want["captured"][0].float()
                rec["gap"] = float((out[0].float() - want).abs().max() /
                                   want.abs().max())
                del pc
        rec["digest"] = grads_hash({"p": out[0]})
        caps.append(rec)
        return out
    tr.capture = capture
    torch.cuda.reset_peak_memory_stats()
    tr.train(SCAN_TRAIN_STEPS, ckpt_every=0, log_every=10**9,
             log=lambda m: None)
    undo()
    st = tr.spion_state
    check(st.phase == "sparse", f"rank {rank}: zamba2's 'seq' Trainer never "
          f"went sparse")
    axis, reason = kernel_seq_axis(mesh, SCAN_S // cfg.spion.block_size,
                                   st.plan_stats["halo"])
    out = {"losses": [r["loss"] for r in steps],
           "phases": [r["phase"] for r in steps],
           "launches": [r["launches"] for r in steps],
           "step_ms": [1e3 * r["s"] for r in steps],
           "captures": caps, "digest": plan_digest_of(st),
           "halo": st.plan_stats["halo"],
           "density": st.plan_stats.get("density"),
           "masters": masters_digest(tr),
           "branch": "halo exchange" if axis else "gathered fallback",
           "reason": reason,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_want": scan_sparse_launches(cfg)}
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    check(all(np.isfinite(out["losses"])), "zamba2's 'seq' losses not finite")
    return out


def seqscan_worker(d, stages):
    """A rank of phase 12e (`--seqscan-worker DIR`, the SPION_* environment
    of a job of SCAN_RANKS): on a 'seq' mesh of SCAN_RANKS, zamba2's fp32
    steps, its bf16 Trainer, rwkv6's fp32 steps, whisper's fp32 steps and
    bf16 sparse steps; writes DIR/seqscan_<rank>.json."""
    import torch
    from repro_torch.distributed import runtime
    from repro_torch.kernels.block_sparse_attn import load_library
    from repro_torch.launch.mesh import make_seq_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(runtime.initialize(), "the 12e worker did not join its job")
    stages["joined"] = time.time()
    rank = runtime.process_index()
    torch.zeros(1, device=DEVICE)
    torch.cuda.synchronize()
    stages["cuda"] = time.time()
    load_library()
    stages["library"] = time.time()
    mesh = make_seq_mesh(SCAN_RANKS, 1)
    secs = labelled_gather_timer()
    out = {"rank": rank, "coords": mesh.coords()}
    out["zamba2"] = scan_steps("zamba2", mesh, rank, secs)
    stages["zamba2"] = time.time()
    out["trainer"] = scan_trainer(mesh, rank, secs)
    stages["trainer"] = time.time()
    out["rwkv6"] = scan_steps("rwkv6", mesh, rank, secs)
    stages["rwkv6"] = time.time()
    out["whisper"] = scan_steps("whisper", mesh, rank, secs)
    out["whisper_bf16"] = scan_bf16_steps(mesh, secs)
    stages["whisper"] = time.time()
    out["stages"] = stages
    with open(os.path.join(d, f"seqscan_{rank}.json"), "w") as f:
        json.dump(out, f)
    runtime.shutdown(0)   # ends the process
    return 0


CARRY_RANKS = 4             # 12e's carry check: a 'seq' line of 4
TOL_SCAN_CARRY = 3e-5       # its output, of the whole sequence's largest


def carry_case(name):
    """One layer's scan at full width over SCAN_BATCH x SCAN_S, made on the
    card from a seed (equal on every rank): (the scan as a function of its
    inputs, the inputs, the names of those split over 'seq'). "ssd":
    `mamba.ssd_chunked` at zamba2-1.2b's widths, the heads' dt scales
    spaced evenly in log over [1e-3, 1e-1] and their A over [-1, -16]
    (Mamba2's init ranges); "wkv": `rwkv.wkv6_chunked` at rwkv6-7b's, log
    decays -exp(w), the channels' w spaced evenly over [-6, -1]. The
    tokens vary each around its head's or channel's scale (x 1.13 on
    average), as the models' data-dependent dt and decay do around their
    biases. The slowest heads and channels keep their state past two
    whole shards."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import mamba, rwkv
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
    B, S = SCAN_BATCH, SCAN_S

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE)
    if name == "ssd":
        cfg = get_config("zamba2-1.2b")
        _, H, P, N, _ = mamba._widths(cfg)
        dt = torch.logspace(-3.0, -1.0, H, device=DEVICE)
        t = {"x": normal(B, S, H, P),
             "dt": dt * torch.exp(0.5 * normal(B, S, H)),
             "A": -torch.linspace(1.0, 16.0, H, device=DEVICE),
             "B": normal(B, S, 1, N),
             "C": normal(B, S, 1, N), "D": torch.ones(H, device=DEVICE)}
        return (lambda t: mamba.ssd_chunked(t["x"], t["dt"], t["A"], t["B"],
                                            t["C"], t["D"], cfg.ssm.chunk),
                t, {"x", "dt", "B", "C"})
    cfg = get_config("rwkv6-7b")
    H, K = cfg.num_heads, cfg.resolved_head_dim
    t = {"r": normal(B, S, H, K), "k": normal(B, S, H, K) / math.sqrt(K),
         "v": normal(B, S, H, K),
         "a": -torch.exp(torch.linspace(-6.0, -1.0, H * K, device=DEVICE)
                         .reshape(H, K) + 0.5 * normal(B, S, H, K)),
         "u": 0.1 * normal(H, K)}
    return (lambda t: rwkv.wkv6_chunked(t["r"], t["k"], t["v"], t["a"],
                                        t["u"], cfg.ssm.chunk),
            t, {"r", "k", "v", "a"})


def carry_worker(d):
    """A rank of 12e's carry check (`--carry-worker DIR`, the SPION_*
    environment of a job of CARRY_RANKS): each carry_case on its shard of
    a 'seq' mesh of CARRY_RANKS, right and with each planted carry fault
    (none, no_carry, last_shard_carry), the shards gathered; rank 0 holds
    them against the scan on the whole sequence. Writes
    DIR/carry_<rank>.json."""
    import torch
    from repro_torch.distributed import runtime, sharding
    from repro_torch.distributed.sharding import gather_seq, mesh_context
    from repro_torch.launch.mesh import make_seq_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(runtime.initialize(), "the 12e carry worker did not join its job")
    rank = runtime.process_index()
    mesh = make_seq_mesh(CARRY_RANKS, 1)
    L = SCAN_S // CARRY_RANKS
    out = {"rank": rank}
    right = sharding.seq_carry
    for name in ("ssd", "wkv"):
        fn, t, split = carry_case(name)
        loc = {k: v[:, rank * L:(rank + 1) * L] if k in split else v
               for k, v in t.items()}
        ref = None
        if rank == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                ref = fn(t)
            torch.cuda.synchronize()
            out[f"{name}/whole_ms"] = 1e3 * (time.perf_counter() - t0)
        for fault, carry in (("right", right), ("dropped", no_carry),
                             ("last_only", last_shard_carry)):
            sharding.seq_carry = carry
            try:
                with mesh_context(mesh), torch.no_grad():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    y = fn(loc)
                    torch.cuda.synchronize()
                    ms = 1e3 * (time.perf_counter() - t0)
                    whole = gather_seq(y, 1)
            finally:
                sharding.seq_carry = right
            out[f"{name}/{fault}/ms"] = ms
            if rank == 0:
                err = (whole - ref).abs()
                scale = ref.abs().max().item()
                out[f"{name}/{fault}/gap"] = err.max().item() / scale
                out[f"{name}/{fault}/shard_gaps"] = [
                    err[:, i * L:(i + 1) * L].max().item() / scale
                    for i in range(CARRY_RANKS)]
        del t, loc, ref, y, whole
    with open(os.path.join(d, f"carry_{rank}.json"), "w") as f:
        json.dump(out, f)
    runtime.shutdown(0)   # ends the process
    return 0


def check_carry(d):
    """12e's carry check on CARRY_RANKS ranks: the right carry within
    TOL_SCAN_CARRY of the whole sequence's scan on every shard; the
    dropped carry right on the first shard only, the previous shard's
    state alone on the first two only, each past the gate after them."""
    t0 = time.perf_counter()
    wait_ranks(spawn_ranks(["--carry-worker", d], CARRY_RANKS),
               "the 12e carry ranks")
    wall = time.perf_counter() - t0
    recs = []
    for r in range(CARRY_RANKS):
        with open(os.path.join(d, f"carry_{r}.json")) as f:
            recs.append(json.load(f))
    r0 = recs[0]
    for name, what in (("ssd", "Mamba2's ssd_chunked at zamba2-1.2b's "
                        "widths"), ("wkv", "WKV6's wkv6_chunked at "
                                    "rwkv6-7b's widths")):
        gaps = {f: r0[f"{name}/{f}/shard_gaps"]
                for f in ("right", "dropped", "last_only")}
        check(max(gaps["right"]) <= TOL_SCAN_CARRY,
              f"12e carry: {name} on {CARRY_RANKS} shards misses the whole "
              f"sequence's scan: {gaps['right']}; gate {TOL_SCAN_CARRY}")
        for fault, good in (("dropped", 1), ("last_only", 2)):
            g = gaps[fault]
            check(max(g[:good]) <= TOL_SCAN_CARRY and
                  min(g[good:]) > TOL_SCAN_CARRY,
                  f"12e carry: the planted {fault} carry of {name} is not "
                  f"right on the first {good} shard(s) and past the gate "
                  f"after them: {g}")
        log(f"seq-scan carry, {what}, {SCAN_BATCH} x {SCAN_S} on "
            f"{CARRY_RANKS} 'seq' ranks, fp32: shards' gaps to the whole "
            f"sequence's scan {', '.join('%.3e' % x for x in gaps['right'])}"
            f" of its largest (gate {TOL_SCAN_CARRY}); planted dropped "
            f"carry {', '.join('%.3e' % x for x in gaps['dropped'])}; the "
            f"previous shard's state alone "
            f"{', '.join('%.3e' % x for x in gaps['last_only'])}; a shard "
            + ", ".join("%.2f" % rec[f"{name}/right/ms"] for rec in recs)
            + f" ms a rank, the whole sequence {r0[f'{name}/whole_ms']:.2f}"
            f" ms on one")
    log(f"seq-scan carry check: {wall:.1f} s")
    return wall


def fmt_gathers(run):
    g = run["gather_ms"]
    return (f"carry {g.get('carry', 0.0):.2f}, halo rows "
            f"{g.get('halo', 0.0):.2f}, K/V {g.get('kv', 0.0):.2f}, encoder "
            f"{g.get('enc', 0.0):.2f}, kernels' halo exchange "
            f"{run['halo_ms']:.2f} ms; gradient all-reduce "
            f"{g.get('grads', 0.0):.2f} ms")


def phase_seq_scan():
    """12e: the hybrid, ssm and encdec families over a 'seq' axis, SCAN_RANKS
    ranks of this script on the card (`--seqscan-worker DIR`, a 'seq' mesh
    of SCAN_RANKS). zamba2-1.2b (SCAN_ZAMBA_LAYERS layers), rwkv6-7b
    (SCAN_RWKV_LAYERS layers) and whisper-tiny at full width, fp32: dense
    and (zamba2, whisper) sparse steps within TOL_SEQ_LOSS and TOL_SEQ_GRAD
    of one process on rank 0, gradients bitwise equal across the ranks,
    the sparse steps' launches scan_sparse_launches'; each planted fault of
    SCAN_FAULTS past a gate. zamba2's bf16 Trainer through the transition:
    captures within TOL_CAPTURE of one process's, one plan digest, sparse
    steps at scan_sparse_launches on every rank, masters equal. whisper's
    bf16 sparse steps: finite, launches as stated, gradients equal across
    the ranks."""
    import shutil
    d = os.path.join(DP_DIR, "seqscan")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    carry_s = check_carry(d)
    t0, t_spawn = time.perf_counter(), time.time()
    wait_ranks(spawn_ranks(["--seqscan-worker", d], SCAN_RANKS),
               "the 12e ranks")
    wall = time.perf_counter() - t0
    recs = []
    for r in range(SCAN_RANKS):
        with open(os.path.join(d, f"seqscan_{r}.json")) as f:
            recs.append(json.load(f))
    card = card_line()
    launches = {k: 0 for k in KERNELS}
    faults = {}
    for name in ("zamba2", "rwkv6", "whisper"):
        legs = [rec[name] for rec in recs]
        r0 = legs[0]["runs"]
        for r, leg in enumerate(legs):
            for kind, run in leg["runs"].items():
                check(run["grads"] == r0[kind]["grads"],
                      f"12e {name} {kind}: rank {r}'s gradients differ from "
                      f"rank 0's")
                want = leg["launches_want"] if kind == "sparse" else \
                    {k: 0 for k in KERNELS}
                if ":" not in kind:
                    check(run["launches"] == want, f"12e {name}: rank {r}'s "
                          f"{kind} step launched {run['launches']}, not "
                          f"{want}")
            if "sparse" in leg["runs"]:
                for k in KERNELS:
                    launches[k] += leg["runs"]["sparse"]["launches"][k]
        for kind, run in r0.items():
            if ":" in kind:
                faults[f"{name} {kind}"] = run
                continue
            check(run["loss_gap"] <= TOL_SEQ_LOSS and
                  run["grad_rel"] <= TOL_SEQ_GRAD,
                  f"12e {name}'s {kind} step misses one process's: "
                  f"{ {k: v for k, v in run.items() if k != 'launches'} }")
        log(f"seq-scan {name}: {SCAN_RANKS} ranks on 'seq', fp32; "
            + "; ".join(
                f"{kind} loss {run['loss']:.6f} vs one process "
                f"{run['ref_loss']:.6f} (rel {run['loss_gap']:.3e}), worst "
                f"gradient leaf {run['worst_leaf']} {run['grad_rel']:.3e} of "
                f"its largest" for kind, run in r0.items() if ":" not in kind)
            + f" (gates {TOL_SEQ_LOSS}, {TOL_SEQ_GRAD})")
        for r, leg in enumerate(legs):
            log(f"seq-scan {name} rank {r}: "
                + "; ".join(f"{kind} {run['ms']:.1f} ms ("
                            f"{fmt_gathers(run)})"
                            for kind, run in leg["runs"].items()
                            if ":" not in kind)
                + f"; dense again untimed (no synchronize around the "
                f"gathers) {leg['runs']['dense']['untimed_ms']:.1f} ms"
                + f"; sparse launches "
                f"{leg['runs'].get('sparse', {}).get('launches')}; peak "
                f"{leg['peak_gb']:.2f} GB ({card})")
    for what, run in faults.items():
        missed = run["loss_gap"] > TOL_SEQ_LOSS or \
            run["grad_rel"] > TOL_SEQ_GRAD
        log(f"seq-scan planted {what}: loss rel {run['loss_gap']:.3e}, worst "
            f"gradient leaf {run['worst_leaf']} {run['grad_rel']:.3e} -> "
            f"{'misses' if missed else 'PASSES'} the gate")
        check(missed, f"12e: the planted {what} passes the gates: {run}")
    # zamba2's Trainer
    trs = [rec["trainer"] for rec in recs]
    t0_ = trs[0]
    check(all(x["losses"] == t0_["losses"] for x in trs),
          "12e: the Trainer ranks' losses differ")
    check(len({x["digest"] for x in trs}) == 1,
          f"12e: the ranks' plan digests differ: "
          f"{[x['digest'] for x in trs]}")
    check(len({x["masters"] for x in trs}) == 1,
          "12e: the ranks' masters differ after the Trainer")
    for r, x in enumerate(trs):
        check([c["digest"] for c in x["captures"]] ==
              [c["digest"] for c in t0_["captures"]],
              f"12e: rank {r}'s captures differ from rank 0's")
        for ph, ln in zip(x["phases"], x["launches"]):
            check(ln == x["launches_want"] if ph == "sparse"
                  else not any(ln.values()),
                  f"12e: rank {r}'s {ph} Trainer step launched {ln}")
            for k in KERNELS:
                launches[k] += ln[k]
    cap_gap = max((c["gap"] for c in t0_["captures"]), default=math.inf)
    check(cap_gap <= TOL_CAPTURE,
          f"12e: zamba2's captures on the shards miss one process's: "
          f"{cap_gap}; gate {TOL_CAPTURE}")
    log(f"seq-scan zamba2 Trainer: bf16, {SCAN_ZAMBA_LAYERS} layers, "
        f"{SCAN_BATCH} x {SCAN_S} on {SCAN_RANKS} 'seq' ranks, "
        f"{SCAN_TRAIN_STEPS} steps ({t0_['phases'].count('dense')} dense, "
        f"then sparse at {t0_['launches_want']} a step a rank); captures vs "
        f"one process {', '.join('%.3e' % c['gap'] for c in t0_['captures'])} "
        f"of the map's largest (gate {TOL_CAPTURE}); one plan digest "
        f"({t0_['digest']}, halo {t0_['halo']}, density {t0_['density']}) "
        f"through the {t0_['branch']} ({t0_['reason']}); masters equal")
    for r, x in enumerate(trs):
        def med(ph):
            xs = [ms for ms, p in zip(x["step_ms"][1:], x["phases"][1:])
                  if p == ph]
            return sorted(xs)[len(xs) // 2] if xs else float("nan")
        log(f"seq-scan zamba2 Trainer rank {r}: step median dense "
            f"{med('dense'):.1f} ms, sparse {med('sparse'):.1f} ms; captures "
            f"{', '.join('%.1f' % c['ms'] for c in x['captures'])} ms (their "
            f"gathers {', '.join('%.1f' % c['gather_ms'] for c in x['captures'])}"
            f" ms); peak {x['peak_gb']:.2f} GB ({card})")
    # whisper in bf16
    bf = [rec["whisper_bf16"] for rec in recs]
    for r, x in enumerate(bf):
        for i, s in enumerate(x["steps"]):
            check(s["finite"] and s["launches"] == x["launches_want"],
                  f"12e whisper bf16 rank {r} step {i}: {s}")
            check(s["grads"] == bf[0]["steps"][i]["grads"],
                  f"12e whisper bf16: rank {r}'s gradients differ")
            for k in KERNELS:
                launches[k] += s["launches"][k]
    log(f"seq-scan whisper bf16 sparse steps: losses "
        f"{', '.join('%.6f' % s['loss'] for s in bf[0]['steps'])}; per rank "
        + "; ".join(f"rank {r} " + ", ".join("%.1f" % s["ms"]
                                            for s in x["steps"]) + " ms"
                    for r, x in enumerate(bf))
        + f"; launches a step a rank {bf[0]['launches_want']}")
    clock = stage_split(t_spawn, recs[0]["stages"], (
        ("zamba2", "zamba2 fp32 steps"), ("trainer", "zamba2 Trainer"),
        ("rwkv6", "rwkv6 fp32 steps"), ("whisper", "whisper steps")),
        start=START_STAGES[:5])
    clock["exit"] = wall - sum(clock.values())
    log(f"seq-scan wall clock, rank 0, s: {fmt_split(clock)}; phase 12e "
        f"{wall:.1f} s")
    return dict(seconds=wall + carry_s, launches=launches, cap_gap=cap_gap,
                branch=t0_["branch"], faults={k: v["loss_gap"]
                                              for k, v in faults.items()},
                gaps={name: {kind: run["loss_gap"]
                             for kind, run in recs[0][name]["runs"].items()
                             if ":" not in kind}
                      for name in ("zamba2", "rwkv6", "whisper")})


# -- phase 12f: the 'model' axis -------------------------------------------------

MODEL_MESH = (2, 2)         # 12f: 'data' x 'model', four ranks on the card
MODEL_LEG_RANKS = 2         # 12f's qwen2-7b and mixtral legs: a model line
MODEL_QWEN_LAYERS = 2       # qwen2-7b's 28 layers cut to 2 (reduced)
MODEL_MIXTRAL_LAYERS = 1    # mixtral-8x7b's 32 layers cut to 1 (reduced)
MODEL_BATCH = 2             # sequences of those legs' steps
MODEL_S = 2048              # tokens a sequence (16 blocks of 128)
# the planted step faults of each leg (a norm of the rank's shards alone
# is read from the sound step's gradients)
MODEL_FAULTS = {"qwen2-7b": ("whole_mesh", "attn_out", "vocab_loss"),
                "mixtral-8x7b": ("moe_combine",)}


@contextlib.contextmanager
def planted_model_fault(kind):
    """Phase 12f's planted faults, by replacing an entry point for the
    duration; None plants nothing:
      - whole_mesh: the loss terms and gradients summed over the whole mesh
        instead of its data line;
      - attn_out: the output projection's partial products kept without
        their sum over the model line;
      - vocab_loss: the vocab-parallel loss without the line's max and sums;
      - moe_combine: the MoE's partial combine without its sum;
      - local_heads: the capture averaging the rank's own heads only."""
    from repro_torch.launch import steps
    from repro_torch.models import attention, moe, registry
    saved = []

    def put(mod, name, fn):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)
    if kind == "whole_mesh":
        put(steps, "reduce_axes", lambda mesh: mesh.axis_names)
    if kind == "attn_out":
        put(attention, "row_parallel", lambda x, w: x @ w.to(x.dtype))
    if kind == "vocab_loss":
        put(registry, "model_max", lambda x: x)
        put(registry, "reduce_from_model", lambda x, dtype=None: x)
    if kind == "moe_combine":
        put(moe, "reduce_from_model",
            lambda x, dtype=None: x.to(dtype or x.dtype))
    if kind == "local_heads":
        put(attention, "model_mean", lambda x: x)
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def model_line_timer():
    """Host seconds of the model line's sums (the fp32 all-reduces of
    reduce_from_model's forward and copy_to_model's backward), a
    synchronize on each side; returns a one-element list."""
    import torch
    from repro_torch.distributed import sharding
    secs, inner = [0.0], sharding._sum_fp32

    def timed(x, group):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(x, group)
        torch.cuda.synchronize()
        secs[0] += time.perf_counter() - t
        return out
    sharding._sum_fp32 = timed
    return secs


def leaves_digest(tr, replicated):
    """Digest of a trainer's masters, of the leaves 'model' leaves whole
    (`replicated`) or of its shards (the others)."""
    import hashlib
    from repro_torch.distributed.sharding import sharded_dim
    h = hashlib.sha256()
    for n, p in tr.params.named_parameters():
        if (sharded_dim(tr._specs[n]) is None) == replicated:
            h.update(n.encode())
            h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:32]


def model_lra(mesh, d, rank, secs):
    """12f's main path on one rank: spion-lra at ListOps size through phase
    5's TRAIN_STEPS steps on (data 2, model 2), checkpoints at RESUME_AT
    and at the end, every capture timed and kept; the first capture also
    run averaging the rank's own heads only. `secs`: model_line_timer's."""
    import numpy as np
    import torch
    tr, cfg, _ = lra_trainer(mesh=mesh, ckpt_dir=os.path.join(d, "ckpt"))
    check(tr.mesh is mesh and tr._specs is not None,
          f"rank {rank}: the trainer's mesh is {tr.mesh}")
    steps, undo = record_steps(tr)
    caps, pooled, planted = [], [], []
    in_captures = [0.0]
    inner_capture = tr.capture

    def capture(batch):
        s0 = secs[0]
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner_capture(batch)
        torch.cuda.synchronize()
        caps.append({"ms": 1e3 * (time.perf_counter() - t)})
        pooled.append(out[0].float().cpu().numpy())
        if not planted:
            with planted_model_fault("local_heads"):
                planted.append(inner_capture(batch)[0].float().cpu().numpy())
        in_captures[0] += secs[0] - s0
        return out
    tr.capture = capture
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    sums = []
    tr.step_callback = lambda step, loss: sums.append(
        1e3 * (secs[0] - in_captures[0]))
    tr.train(TRAIN_STEPS, ckpt_every=RESUME_AT, log_every=10**9,
             log=lambda m: None)
    undo()
    st = tr.spion_state
    np.savez(os.path.join(d, f"pooled_{rank}.npz"),
             **{f"p{i}": p for i, p in enumerate(pooled)},
             local_heads=planted[0])
    if rank == 0:
        np.savez(os.path.join(d, "plan_layer0.npz"),
                 col=st.tables["col_idx"][0].cpu().numpy(),
                 nvalid=st.tables["nvalid"][0].cpu().numpy())
    out = {"losses": [r["loss"] for r in steps],
           "phases": [r["phase"] for r in steps],
           "launches": [r["launches"] for r in steps],
           "step_ms": [1e3 * r["s"] for r in steps],
           "sum_ms": np.diff([0.0] + sums).tolist(), "captures": caps,
           "digest": plan_digest_of(st), "stats": st.plan_stats,
           "shards": leaves_digest(tr, replicated=False),
           "replicated": leaves_digest(tr, replicated=True),
           "wq": list(tr.params["layers"]["attn"]["wq"].shape),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del tr
    return out


def row_parallel_cost():
    """A bf16 row-parallel partial product at qwen2-7b's full-width w_out
    shard on a model line of MODEL_LEG_RANKS (MODEL_BATCH x MODEL_S tokens,
    d_ff / 2 of the contraction, d_model out): the port's GEMM in bf16
    (fp32 accumulation, its output upcast for the fp32 sum) against both
    operands upcast to fp32 (TF32 off), by CUDA events, and the two
    results' worst difference over the largest entry."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-7b")
    ff = cfg.d_ff // MODEL_LEG_RANKS
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 25)
    h = torch.randn(MODEL_BATCH * MODEL_S, ff, generator=gen,
                    device=DEVICE).bfloat16()
    w = (torch.randn(ff, cfg.d_model, generator=gen, device=DEVICE)
         / math.sqrt(ff)).bfloat16()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        bf16_ms = cuda_ms(lambda: (h @ w).float(), 20)
        fp32_ms = cuda_ms(lambda: h.float() @ w.float(), 20)
        a, b = (h @ w).float(), h.float() @ w.float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    diff = float((a - b).abs().max() / b.abs().max())
    del h, w, a, b
    torch.cuda.empty_cache()
    return {"shape": [MODEL_BATCH * MODEL_S, ff, cfg.d_model],
            "bf16_ms": bf16_ms, "fp32_ms": fp32_ms, "rel_diff": diff}


def model_leg_config(name):
    """qwen2-7b or mixtral-8x7b at full width, cut to 12f's depth, fp32."""
    from repro_torch.configs import get_config
    cfg = get_config(name)
    if name == "qwen2-7b":
        check(cfg.d_model == 3584 and cfg.num_heads == 28 and
              cfg.num_kv_heads == 4 and cfg.vocab_size == 152_064,
              "qwen2-7b config changed")
        return cfg.replace(num_layers=MODEL_QWEN_LAYERS, dtype="float32")
    check(cfg.d_model == 4096 and cfg.d_ff == 14_336 and
          cfg.moe.num_experts == 8 and cfg.num_kv_heads == 8,
          "mixtral-8x7b config changed")
    return cfg.replace(num_layers=MODEL_MIXTRAL_LAYERS, dtype="float32")


def model_leg(name, mesh, rank, secs):
    """12f's leg (ii) or (iii) on one rank of the model line `mesh`: the
    sparse make_loss_and_grads on a random causal plan, sound and with
    each MODEL_FAULTS fault; every rank also runs the step in one process
    on the global batch (one rank at a time: the card is shared) and keeps
    its slice of those gradients, so each leaf's worst difference is read
    over the line without gathering the shards."""
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.data.pipeline import local_batch
    from repro_torch.distributed.sharding import (local_slices, param_pspecs,
                                                  shard_params, sharded_dim)
    from repro_torch.launch.steps import make_loss_and_grads
    from repro_torch.launch.train import masters_of, nest
    from repro_torch.models.layers import ParamTree
    from repro_torch.models.registry import build
    from repro_torch.optim import global_norm
    cfg = model_leg_config(name)
    line = mesh.group("model")
    block = cfg.spion.block_size
    rng = np.random.default_rng(SEED + 23)
    toks = rng.integers(0, cfg.vocab_size,
                        size=(MODEL_BATCH, MODEL_S + 1)).astype(np.int64)
    gb = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    col, nvalid, _ = random_plan(rng, cfg.num_layers, MODEL_S // block, block)
    tables = {"col_idx": torch.as_tensor(col, device=DEVICE),
              "nvalid": torch.as_tensor(nvalid, device=DEVICE),
              "block": block}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
    full = masters_of(build(cfg).init(gen, device=DEVICE))
    specs = param_pspecs(full, mesh)
    params = ParamTree(nest(shard_params(full, mesh, specs)), trainable=True)
    ref = None
    torch.cuda.reset_peak_memory_stats()
    for r in range(mesh.size):
        if r == rank:
            batch1 = {k: torch.as_tensor(v, device=DEVICE)
                      for k, v in gb.items()}
            loss1, g1 = make_loss_and_grads(cfg)(full, batch1, tables)
            ref = {"loss": float(loss1), "norm": float(global_norm(g1)),
                   "max": {n: g.abs().max().item() for n, g in g1.items()},
                   "slices": {n: g[local_slices(mesh, specs[n], g.shape)]
                              .contiguous() for n, g in g1.items()}}
            del loss1, g1, batch1
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier(group=line)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    sharded = {n for n, spec in specs.items()
               if sharded_dim(spec) is not None}
    batch = local_batch(mesh, gb, DEVICE)
    runs = {}
    for kind in ("sound",) + MODEL_FAULTS[name]:
        with planted_model_fault(None if kind == "sound" else kind):
            # built inside: the step reads its reduction axes when made
            f = make_loss_and_grads(cfg, mesh=mesh)
            reset_launch_counts()
            s0 = secs[0]
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, grads = f(params, batch, tables)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t)
        names = sorted(grads)
        worst = torch.tensor([(grads[n] - ref["slices"][n]).abs().max()
                              .item() for n in names], dtype=torch.float64)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=line)
        rel = {n: float(w) / max(ref["max"][n], 1e-30)
               for n, w in zip(names, worst)}
        leaf = max(rel, key=rel.get)
        runs[kind] = {"loss": float(loss), "ref_loss": ref["loss"],
                      "loss_gap": loss_gap([float(loss)], [ref["loss"]]),
                      "grad_rel": rel[leaf], "worst_leaf": leaf, "ms": ms,
                      "sum_ms": 1e3 * (secs[0] - s0),
                      "launches": launch_counts()}
        if kind == "sound":
            runs[kind]["gnorm"] = float(global_norm(grads, sharded, line))
            runs[kind]["gnorm_local"] = float(global_norm(grads))
            runs[kind]["gnorm_ref"] = ref["norm"]
        del loss, grads
    out = {"runs": runs, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "wq": list(params["layers"]["attn"]["wq"].shape),
           "launches_want": sparse_launches(cfg)}
    if cfg.moe is not None:
        out["experts"] = list(params["layers"]["moe"]["experts"]["w_in"]
                              .shape)
    del params, ref, f
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier(group=line)
    return out


def model_worker(d, stages):
    """A rank of phase 12f (`--model-worker DIR`, the SPION_* environment of
    a job of 4): `model_lra` on (data 2, model 2), then ranks 0 and 1 run
    `model_leg` for qwen2-7b and mixtral-8x7b on a model line of 2; writes
    DIR/model_<rank>.json and its start-up stages."""
    import gc
    import torch
    from repro_torch.distributed import runtime
    from repro_torch.kernels.block_sparse_attn import load_library
    from repro_torch.launch.mesh import make_distributed_mesh, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(runtime.initialize(), "the 'model' worker did not join its job")
    stages["joined"] = time.time()
    rank = runtime.process_index()
    torch.zeros(1, device=DEVICE)
    torch.cuda.synchronize()
    stages["cuda"] = time.time()
    load_library()
    stages["library"] = time.time()
    mesh = make_distributed_mesh(data=MODEL_MESH[0], model=MODEL_MESH[1])
    check(mesh.shape == {"pod": 1, "data": MODEL_MESH[0],
                         "model": MODEL_MESH[1]}, f"12f mesh {mesh}")
    # every process builds the legs' groups; ranks 0 and 1 use them
    line = make_mesh((1, MODEL_LEG_RANKS), ("data", "model"),
                     ranks=list(range(MODEL_LEG_RANKS)))
    out = {"rank": rank, "coords": mesh.coords()}
    secs = model_line_timer()
    out["lra"] = model_lra(mesh, d, rank, secs)
    stages["trained"] = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    out["legs"] = {}
    if rank < MODEL_LEG_RANKS:
        for name in MODEL_FAULTS:
            out["legs"][name] = model_leg(name, line, rank, secs)
    runtime.barrier("12f legs")
    stages["legs"] = time.time()
    out["stages"] = stages
    with open(os.path.join(d, f"model_{rank}.json"), "w") as f:
        json.dump(out, f)
    runtime.shutdown(0)   # ends the process
    return 0


def phase_model_parallel(train):
    """12f: tensor, expert and vocabulary parallelism over a 'model' axis,
    four ranks of this script on the card (`--model-worker DIR`).
    (i) spion-lra at phase 5's configuration, data and seed on (data 2,
    model 2): dense losses within TOL_DP of phase 5's, captures within
    TOL_CAPTURE of phase 5's (the rank's own heads alone past it), plan
    digests equal across the ranks (phase 5's plan when the maps are
    bitwise, else this process's controller's on the ranks' map), 8 + 4 +
    4 launches a sparse step on each rank's 2 KV heads, shards equal
    across each data line and replicated leaves across all ranks; its
    step-14 checkpoint restored in this process, whose next loss is within
    TOL_RESUME of the ranks'; the three kernels against their plain
    versions at a rank's shard of the training shape. (ii) qwen2-7b and
    (iii) mixtral-8x7b at full width (2 and 1 layers, fp32) on a model
    line of 2: the sparse step within TOL_SEQ_LOSS and TOL_SEQ_GRAD of one
    process, the global norm within TOL_SEQ_LOSS of it, and each planted
    fault (MODEL_FAULTS, and a norm of the rank's shards alone) past a
    gate."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.core.spion import SpionState
    d = os.path.join(DP_DIR, "model")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    n = MODEL_MESH[0] * MODEL_MESH[1]
    t0, t_spawn = time.perf_counter(), time.time()
    wait_ranks(spawn_ranks(["--model-worker", d], n),
               "the 'model' ranks")
    wall = time.perf_counter() - t0
    recs = []
    for r in range(n):
        with open(os.path.join(d, f"model_{r}.json")) as f:
            recs.append(json.load(f))
    pooled = [dict(np.load(os.path.join(d, f"pooled_{r}.npz")))
              for r in range(n)]
    cfg, ref = train["cfg"], train["losses"]
    want = sparse_launches(cfg)
    lra = [rec["lra"] for rec in recs]
    got = lra[0]["losses"]
    check(all(x["losses"] == got for x in lra), "the ranks' losses differ")
    for r, x in enumerate(lra):
        for ph, ln in zip(x["phases"], x["launches"]):
            check(ln == want if ph == "sparse" else not any(ln.values()),
                  f"rank {r}: a {ph} step launched {ln}")
        check(x["wq"] == [cfg.num_layers, cfg.d_model,
                          cfg.num_heads * cfg.resolved_head_dim // 2],
              f"rank {r} holds wq {x['wq']}")
    check("sparse" in lra[0]["phases"], "the 'model' run never went sparse")
    dense_n = min(train["dense_steps"], lra[0]["phases"].count("dense"))
    gap = loss_gap(got[:dense_n], ref[:dense_n])
    check(len({x["digest"] for x in lra}) == 1,
          f"the ranks' plan digests differ: {[x['digest'] for x in lra]}")
    check(len({x["replicated"] for x in lra}) == 1,
          "the replicated masters differ across the ranks")
    by_model = {}
    for rec, x in zip(recs, lra):
        by_model.setdefault(rec["coords"]["model"], set()).add(x["shards"])
    check(all(len(v) == 1 for v in by_model.values()) and
          len(by_model) == MODEL_MESH[1],
          f"the shards differ across a data line: {by_model}")
    caps = [k for k in pooled[0] if k != "local_heads"]
    check(len(caps) == len(train["pooled"]), f"{len(caps)} captures, phase "
          f"5 made {len(train['pooled'])}")
    bitwise = True
    for r in range(n):
        for i, want_map in enumerate(train["pooled"]):
            m = pooled[r][f"p{i}"]
            check(np.array_equal(m, pooled[0][f"p{i}"]),
                  f"rank {r}'s capture {i} differs from rank 0's")
            bitwise &= bool(np.array_equal(m, want_map))
    cap_gaps = [float(np.abs(pooled[0][f"p{i}"] - w).max() / np.abs(w).max())
                for i, w in enumerate(train["pooled"])]
    cap_gap = max(cap_gaps)
    planted = float(np.abs(pooled[0]["local_heads"] - train["pooled"][0])
                    .max() / np.abs(train["pooled"][0]).max())
    tr5 = train["trainer"]
    if bitwise:
        plan_ref, which = plan_digest_of(tr5.spion_state), "phase 5's"
    else:
        st = tr5.spion_ctl.generate(SpionState(),
                                    pooled[0][f"p{len(caps) - 1}"])
        plan_ref = plan_digest_of(st)
        which = "the controller's on the ranks' map"
    same_plan = lra[0]["digest"] == plan_ref
    phase5_plan = lra[0]["digest"] == plan_digest_of(tr5.spion_state)
    # the sharded checkpoint in one process: step RESUME_AT + 1 again
    one, _, _ = lra_trainer(ckpt_dir=os.path.join(d, "ckpt"))
    check(one._restore_latest(step=RESUME_AT) and one.step == RESUME_AT,
          "the 'model' checkpoint did not restore in one process")
    check(plan_digest_of(one.spion_state) == lra[0]["digest"],
          "the restored plan differs from the ranks'")
    reset_launch_counts()
    next_loss = one.train(1, ckpt_every=0, log_every=10**9,
                          log=lambda m: None)[0]
    resume_launches = launch_counts()
    resume_gap = loss_gap([next_loss], [got[RESUME_AT]])
    del one
    torch.cuda.empty_cache()
    # the kernels at a rank's shard of the training shape
    with np.load(os.path.join(d, "plan_layer0.npz")) as z:
        tables = (z["col"], z["nvalid"])
    shard_shape = dict(TRAIN_PATH, N=TRAIN_PATH["N"] // n)
    kernels = path_kernels("model-shard", shard_shape, tables,
                           "12f's trained layer-0", SEED + 24, causal=False)
    legs = recs[0]["legs"]
    card = card_line()
    cost = row_parallel_cost()
    log(f"model-parallel row-parallel partial product (qwen2-7b's w_out "
        f"shard, {cost['shape']}): bf16 GEMM {cost['bf16_ms']:.4f} ms, both "
        f"operands in fp32 {cost['fp32_ms']:.4f} ms (TF32 off), rel diff "
        f"{cost['rel_diff']:.3e} ({card})")
    log(f"model-parallel: {n} ranks on the card (gloo), mesh data "
        f"{MODEL_MESH[0]} x model {MODEL_MESH[1]}, spion-lra at ListOps size "
        f"({lra_config()[1]['batch'] // MODEL_MESH[0]} sequences a rank, "
        f"{cfg.num_heads // MODEL_MESH[1]} heads and "
        f"{cfg.d_ff // MODEL_MESH[1]} of d_ff a rank): {TRAIN_STEPS} steps, "
        f"{dense_n} dense, then sparse at {want} a step on every rank; "
        f"dense losses vs phase 5's max rel {gap:.3e} (gate {TOL_DP}); "
        f"captures vs phase 5's {', '.join('%.3e' % g for g in cap_gaps)} "
        f"of the map's largest entry ({'bitwise' if bitwise else 'not bitwise'}"
        f"; gate {TOL_CAPTURE}), the rank's own heads alone {planted:.3e}; "
        f"plan digests equal ({lra[0]['digest']}), "
        f"{'equal to' if same_plan else 'DIFFERENT from'} {which}, "
        f"{'equal to' if phase5_plan else 'not'} phase 5's; shards equal "
        f"across each data line, replicated leaves across the ranks; the "
        f"step-{RESUME_AT} checkpoint's next loss in one process vs the "
        f"ranks' rel {resume_gap:.3e} (gate {TOL_RESUME}; launches "
        f"{resume_launches})")
    for r, x in enumerate(lra):
        def med(ph, key="step_ms"):
            xs = [ms for ms, p in zip(x[key][1:], x["phases"][1:])
                  if p == ph]
            return float(np.median(xs)) if xs else float("nan")
        log(f"model-parallel rank {r} {recs[r]['coords']}: step median dense "
            f"{med('dense'):.2f} ms, sparse {med('sparse'):.2f} ms; "
            f"model-line all-reduces a step median dense "
            f"{med('dense', 'sum_ms'):.2f} ms, sparse "
            f"{med('sparse', 'sum_ms'):.2f} ms; captures "
            f"{', '.join('%.2f' % c['ms'] for c in x['captures'])} ms; "
            f"launches {sum_launches(x['launches'])}; peak "
            f"{x['peak_gb']:.2f} GB (ranks share the card: not a time on "
            f"{n} cards; {card})")
    for name in MODEL_FAULTS:
        runs = [rec["legs"][name]["runs"] for rec in recs[:MODEL_LEG_RANKS]]
        s = runs[0]["sound"]
        log(f"model-parallel {name} ({legs[name]['wq']} wq a rank"
            + (f", experts {legs[name]['experts']}" if "experts" in legs[name]
               else "") + f"), fp32, {MODEL_BATCH} x {MODEL_S} tokens, a "
            f"random causal plan, on a model line of {MODEL_LEG_RANKS}: "
            + "; ".join(f"{kind} loss {r['loss']:.6f} vs one process "
                        f"{r['ref_loss']:.6f} (rel {r['loss_gap']:.3e}), "
                        f"worst gradient leaf {r['worst_leaf']} "
                        f"{r['grad_rel']:.3e} of its largest"
                        for kind, r in runs[0].items())
            + f" (gates {TOL_SEQ_LOSS}, {TOL_SEQ_GRAD}); global norm "
            f"{s['gnorm']:.6f} vs one process {s['gnorm_ref']:.6f}, the "
            f"rank's shards alone {s['gnorm_local']:.6f}; per rank: "
            + "; ".join(f"rank {r} step {x['sound']['ms']:.1f} ms (model-line "
                        f"all-reduces {x['sound']['sum_ms']:.1f} ms), "
                        f"launches {x['sound']['launches']}, peak "
                        f"{rec['legs'][name]['peak_gb']:.2f} GB"
                        for r, (x, rec) in enumerate(zip(runs, recs)))
            + f" ({card})")
    clock = stage_split(t_spawn, recs[0]["stages"], (
        ("trained", f"trainer and {TRAIN_STEPS} steps"),
        ("legs", "qwen2-7b and mixtral legs")), start=START_STAGES[:5])
    clock["exit"] = wall - sum(clock.values())
    log(f"model-parallel wall clock, rank 0, s: {fmt_split(clock)}; phase "
        f"12f {wall:.1f} s")
    check(gap <= TOL_DP, f"the 'model' dense losses differ from phase 5's by "
          f"{gap}; gate {TOL_DP}")
    check(cap_gap <= TOL_CAPTURE < planted, f"captures {cap_gap}, the "
          f"rank's own heads {planted}; gate {TOL_CAPTURE}")
    check(same_plan, f"the ranks' plan differs from {which}")
    check(resume_gap <= TOL_RESUME, f"the 'model' checkpoint's next loss in "
          f"one process differs by {resume_gap}; gate {TOL_RESUME}")
    check(resume_launches == want, f"the resumed step launched "
          f"{resume_launches}")
    for name in MODEL_FAULTS:
        for r in range(MODEL_LEG_RANKS):
            leg = recs[r]["legs"][name]
            runs = leg["runs"]
            s = runs["sound"]
            check(s["loss_gap"] <= TOL_SEQ_LOSS and
                  s["grad_rel"] <= TOL_SEQ_GRAD,
                  f"rank {r}: {name}'s step misses one process's: {s}")
            check(s["launches"] == leg["launches_want"],
                  f"rank {r}: {name}'s sparse step launched {s['launches']}")
            check(abs(s["gnorm"] - s["gnorm_ref"]) <=
                  TOL_SEQ_LOSS * s["gnorm_ref"] and abs(
                      s["gnorm_local"] - s["gnorm_ref"]) >
                  TOL_SEQ_LOSS * s["gnorm_ref"],
                  f"rank {r}: {name}'s global norm {s['gnorm']}, the "
                  f"shards alone {s['gnorm_local']}, one process "
                  f"{s['gnorm_ref']}")
            for kind in MODEL_FAULTS[name]:
                x = runs[kind]
                check(x["loss_gap"] > TOL_SEQ_LOSS or
                      x["grad_rel"] > TOL_SEQ_GRAD,
                      f"rank {r}: the planted {kind} fault passes the "
                      f"gates: {x}")
    # the main path's own runs only: the four ranks' training and the legs'
    # sound steps (not the planted faults, nor the restored step here)
    launches = {k: sum(sum(ln[k] for ln in x["launches"]) for x in lra)
                + sum(rec["legs"][nm]["runs"]["sound"]["launches"][k]
                      for rec in recs[:MODEL_LEG_RANKS]
                      for nm in MODEL_FAULTS)
                for k in KERNELS}
    return dict(seconds=wall, launches=launches, gap=gap, cap_gap=cap_gap,
                planted=planted, resume_gap=resume_gap, kernels=kernels,
                row_parallel=cost,
                legs={name: recs[0]["legs"][name]["runs"]["sound"]
                      for name in MODEL_FAULTS},
                peak_gb=[x["peak_gb"] for x in lra])


# -- phase 12g: the 'model' axis for the scan families -----------------------

MODELSCAN_RANKS = 2         # 12g: a model line of 2, both ranks on the card
MODELSCAN_WHISPER_S = 448   # whisper's decoder tokens: 7 blocks of 64
MODELSCAN_RESUME_AT = 6     # zamba2's Trainer saves here, then steps on
MODELSCAN_ZAMBA_LAYERS = 6  # zamba2-1.2b here: one application of the
                            # shared block (12e and 12h run two), cut from
                            # 12 for the script's time limit
# 12g's planted step faults, each on the dense step (a restore that cuts
# in_proj contiguously is planted on the Trainer's checkpoint)
MODELSCAN_FAULTS = {"zamba2": ("in_proj_contiguous", "norm_local",
                               "norm_forward_only", "leaf_no_copy"),
                    "rwkv6": ("norm_local", "norm_forward_only"),
                    "whisper": ()}


@contextlib.contextmanager
def planted_modelscan_fault(kind):
    """Phase 12g's planted faults, by replacing an entry point for the
    duration; None plants nothing:
      - in_proj_contiguous: Mamba2's packed in_proj cut as the reference's
        contiguous shard and read as segments;
      - norm_local: out_norm's and ln_x's statistic of the rank's slice
        alone;
      - norm_forward_only: that statistic summed over the line in the
        forward only (each rank's gradient its own share);
      - leaf_no_copy: conv_w, conv_b, A_log, D, dt_bias and the out_norm
        scale (RWKV6's w0, w_lora_b, u, ln_x) used in part without
        copy_to_model;
      - restore_contiguous: the Trainer's restore cutting in_proj
        contiguously."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import train
    from repro_torch.models import layers, mamba, rwkv
    saved = []

    def put(mod, name, fn):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)
    if kind == "in_proj_contiguous":
        put(sharding, "packed_segments", lambda name, cfg: None)
    if kind == "norm_local":
        put(layers, "model_line_sum", lambda x: x * sharding.model_size())
    if kind == "norm_forward_only":
        put(layers, "model_line_sum", sharding.reduce_from_model)
    if kind == "leaf_no_copy":
        for mod in (mamba, rwkv):
            put(mod, "model_part", lambda leaf, idx: leaf[idx])
    if kind == "restore_contiguous":
        put(train, "local_index", lambda mesh, name, spec, shape, cfg=None,
            rank=None: sharding.local_slices(mesh, spec, shape, rank))
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def modelscan_plan(cfg, S):
    """12g's random causal plan of `cfg` over S positions: one block mask
    per application of zamba2's shared block, per decoder layer of
    whisper; (col_idx, nvalid) numpy, seeded."""
    import numpy as np
    from repro_torch.models.hybrid import n_attn_apps
    block = cfg.spion.block_size
    layers = n_attn_apps(cfg) if cfg.family == "hybrid" else cfg.num_layers
    rng = np.random.default_rng(SEED + 24)
    col, nvalid, _ = random_plan(rng, layers, S // block, block)
    return col, nvalid


def modelscan_leg(name, mesh, rank, secs, gsecs):
    """12g's fp32 leg of one family on one rank of the model line `mesh`:
    make_loss_and_grads dense and (zamba2, whisper) sparse on a random
    causal plan, and each MODELSCAN_FAULTS fault on the dense step. Every
    rank also runs the steps in one process on the global batch (one rank
    at a time: the card is shared) and keeps its shard of those gradients
    (`local_index`: in_proj by segment and head), so each leaf's worst
    difference is read over the line without gathering the shards; the
    replicated leaves' gradients are digested for the bitwise check across
    the line. `secs`: model_line_timer's; `gsecs`: labelled_gather_timer's
    (the B‖C gather is its "other")."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.data.pipeline import local_batch
    from repro_torch.distributed.sharding import (local_index, param_pspecs,
                                                  shard_params, sharded_dim)
    from repro_torch.launch.steps import make_loss_and_grads
    from repro_torch.launch.train import masters_of, nest
    from repro_torch.models.layers import ParamTree
    from repro_torch.models.registry import build
    from repro_torch.optim import global_norm
    cfg, gb = scan_config(name, whisper_s=MODELSCAN_WHISPER_S,
                          zamba_layers=MODELSCAN_ZAMBA_LAYERS)
    line = mesh.group("model")
    S = gb["tokens"].shape[1]
    tables = None
    if cfg.spion.enabled:
        col, nvalid = modelscan_plan(cfg, S)
        tables = {"col_idx": torch.as_tensor(col, device=DEVICE),
                  "nvalid": torch.as_tensor(nvalid, device=DEVICE),
                  "block": cfg.spion.block_size}
    kinds = ["dense"] + (["sparse"] if tables else [])
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 24)
    full = masters_of(build(cfg).init(gen, device=DEVICE))
    specs = param_pspecs(full, mesh)
    sharded = {n for n, spec in specs.items()
               if sharded_dim(spec) is not None}
    refs = {}
    torch.cuda.reset_peak_memory_stats()
    for r in range(mesh.size):
        if r == rank:
            batch1 = {k: torch.as_tensor(v, device=DEVICE)
                      for k, v in gb.items()}
            one = make_loss_and_grads(cfg)
            for kind in kinds:
                loss1, g1 = one(full, batch1,
                                tables if kind == "sparse" else None)
                refs[kind] = {
                    "loss": float(loss1), "norm": float(global_norm(g1)),
                    "max": {n: g.abs().max().item() for n, g in g1.items()},
                    "slices": {n: g[local_index(mesh, n, specs[n],
                                                g.shape, cfg)].contiguous()
                               for n, g in g1.items()}}
                del loss1, g1
            del batch1
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier(group=line)
    batch = local_batch(mesh, gb, DEVICE)
    runs = {}
    # the planted faults first: they take the first steps' one-off costs
    for kind, fault in [(f"{f}:dense", f) for f in MODELSCAN_FAULTS[name]] \
            + [(k, None) for k in kinds]:
        sparse = kind.split(":")[-1] == "sparse"
        with planted_modelscan_fault(fault):
            params = ParamTree(nest(shard_params(full, mesh, specs, cfg)),
                               trainable=True)
            f = make_loss_and_grads(cfg, mesh=mesh)
            reset_launch_counts()
            s0, g0 = secs[0], gsecs.get("other", 0.0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, grads = f(params, batch, tables if sparse else None)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t)
        ref = refs[kind.split(":")[-1]]
        names = sorted(grads)
        worst = torch.tensor([(grads[n] - ref["slices"][n]).abs().max()
                              .item() for n in names], dtype=torch.float64)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=line)
        rel = {n: float(w) / max(ref["max"][n], 1e-30)
               for n, w in zip(names, worst)}
        leaf = max(rel, key=rel.get)
        runs[kind] = {"loss": float(loss), "ref_loss": ref["loss"],
                      "loss_gap": loss_gap([float(loss)], [ref["loss"]]),
                      "grad_rel": rel[leaf], "worst_leaf": leaf, "ms": ms,
                      "sum_ms": 1e3 * (secs[0] - s0),
                      "gather_ms": 1e3 * (gsecs.get("other", 0.0) - g0),
                      "launches": launch_counts(),
                      "replicated": grads_hash({n: g for n, g in
                                                grads.items()
                                                if n not in sharded})}
        if fault is None:
            runs[kind]["gnorm"] = float(global_norm(grads, sharded, line))
            runs[kind]["gnorm_local"] = float(global_norm(grads))
            runs[kind]["gnorm_ref"] = ref["norm"]
        del params, loss, grads, f
    out = {"runs": runs, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_want": scan_sparse_launches(cfg) if tables else None}
    if cfg.family == "hybrid":
        out["in_proj"] = [int(x) for x in
                          full["layers"]["mamba"]["in_proj"].shape]
    del full, refs
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier(group=line)
    return out


def modelscan_config():
    """12g's Trainer configuration: zamba2-1.2b as 12e's Trainer (bf16)
    at MODELSCAN_ZAMBA_LAYERS layers, dense for two epochs at most."""
    import dataclasses
    cfg, _ = scan_config("zamba2", dtype="bfloat16",
                         zamba_layers=MODELSCAN_ZAMBA_LAYERS)
    return cfg.replace(spion=dataclasses.replace(
        cfg.spion, min_dense_epochs=1, max_dense_epochs=2))


def modelscan_trainer_of(cfg, **kw):
    """A Trainer of 12g's configuration on SCAN_BATCH x SCAN_S."""
    from repro_torch.launch.train import Trainer
    return Trainer(cfg, seq_len=SCAN_S, batch=SCAN_BATCH,
                   steps_per_epoch=SCAN_STEPS_PER_EPOCH,
                   data_fn=lm_data_fn(cfg, SCAN_BATCH, SCAN_S),
                   seed=SEED + 22, device=DEVICE, sentinel=False, **kw)


def trainer_state(tr):
    """{kind/name: tensor} of a Trainer's masters and AdamW moments."""
    return {**{f"p/{n}": p for n, p in tr.params.named_parameters()},
            **{f"mu/{n}": v for n, v in tr.opt["mu"].items()},
            **{f"nu/{n}": v for n, v in tr.opt["nu"].items()}}


def shard_digests(state, mesh=None, specs=None, cfg=None, rank=None):
    """The digest of a `trainer_state`: as it is (this rank's shards), or
    with `specs`, `rank`'s shards of its whole leaves (`local_index`)."""
    from repro_torch.distributed.sharding import local_index
    if specs is not None:
        state = {k: x[local_index(mesh, k.split("/", 1)[1],
                                  specs[k.split("/", 1)[1]], x.shape, cfg,
                                  rank)]
                 for k, x in state.items()}
    return grads_hash({k: x.detach() for k, x in state.items()})


def modelscan_trainer(mesh, d, rank, secs):
    """12g's zamba2 Trainer on one rank of the model line `mesh`: bf16,
    MODELSCAN_ZAMBA_LAYERS layers, SCAN_BATCH x SCAN_S through
    MODELSCAN_RESUME_AT steps (dense steps, the capture at each epoch
    boundary, the flood fill on process 0 and its broadcast, sparse steps
    on the trained plan at the rank's KV-head shard), saved at the end
    under DIR/ckpt (every sharded leaf gathered before process 0 writes).
    Each capture is timed and, on rank 0, held against one process's
    capture on the gathered masters. Then the digest of the rank's shards
    of the masters and moments (what the checkpoint must give back), and
    on rank 0 the next step's loss in one process on the gathered
    masters; then the next step on the line, uninterrupted, and again
    after restoring the checkpoint, soundly and with the restore cutting
    in_proj contiguously."""
    import gc
    import numpy as np
    import torch
    from repro_torch.distributed.sharding import (gather_params,
                                                  mesh_context)
    from repro_torch.launch.steps import compute_params
    from repro_torch.launch.train import nest
    cfg = modelscan_config()
    clock = [("start", time.perf_counter())]
    tr = modelscan_trainer_of(cfg, mesh=mesh,
                              ckpt_dir=os.path.join(d, "ckpt"))
    clock.append(("trainer", time.perf_counter()))
    check(tr.mesh is mesh and tr._specs is not None,
          f"rank {rank}: the trainer's mesh is {tr.mesh}")
    steps, undo = record_steps(tr)
    caps = []
    inner_capture = tr.capture

    def masters():
        return gather_params(dict(tr.params.named_parameters()), tr._specs,
                             mesh, cfg)

    def capture(batch):
        s0 = secs[0]
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner_capture(batch)
        torch.cuda.synchronize()
        rec = {"ms": 1e3 * (time.perf_counter() - t),
               "sum_ms": 1e3 * (secs[0] - s0),
               "digest": grads_hash({"p": out[0]})}
        full = masters()
        if rank == 0:
            with torch.no_grad(), mesh_context(None):
                pc = compute_params(nest(full), getattr(torch, cfg.dtype))
                want = tr.bundle.forward(
                    pc, batch, capture=tr.spion_ctl.capture_kwargs(
                        tr.spion_state))[1]["captured"][0].float()
            rec["gap"] = float((out[0].float() - want).abs().max() /
                               want.abs().max())
            del pc, want
        del full
        caps.append(rec)
        return out
    tr.capture = capture
    torch.cuda.reset_peak_memory_stats()
    tr.train(MODELSCAN_RESUME_AT, ckpt_every=0, log_every=10**9,
             log=lambda m: None)
    clock.append(("steps, captures and the save", time.perf_counter()))
    st = tr.spion_state
    check(st.phase == "sparse", f"rank {rank}: zamba2's 'model' Trainer "
          f"never went sparse")
    # what the checkpoint holds: this rank's shards, and on rank 0 the
    # next step's loss in one process on the gathered masters
    out = {"shards": shard_digests(trainer_state(tr))}
    full = masters()
    if rank == 0:
        with torch.no_grad(), mesh_context(None):
            b = {k: torch.as_tensor(v, device=DEVICE) for k, v in
                 tr.data_fn(MODELSCAN_RESUME_AT).items()}
            pc = compute_params(nest(full), getattr(torch, cfg.dtype))
            out["one_next"] = float(tr.bundle.loss(
                pc, b, spion=tr._attention_exec())[0])
        del pc, b
    del full
    clock.append(("digests and one process's next loss", time.perf_counter()))
    # the next step on the line (recorded with the others), then twice
    # more from the checkpoint: soundly, and with in_proj cut contiguously
    out["next"] = float(tr._fetch_and_step()[1]["loss"])
    undo()
    clock.append(("the next step", time.perf_counter()))
    for kind in ("resumed", "restore_contiguous"):
        with planted_modelscan_fault(None if kind == "resumed" else kind):
            check(tr._restore_latest(step=MODELSCAN_RESUME_AT),
                  f"rank {rank}: the line did not restore its checkpoint")
        clock.append((f"{kind}: restore", time.perf_counter()))
        out[kind] = float(tr._fetch_and_step()[1]["loss"])
        clock.append((f"{kind}: step", time.perf_counter()))
    out.update({"losses": [r["loss"] for r in steps],
                "phases": [r["phase"] for r in steps],
                "launches": [r["launches"] for r in steps],
                "step_ms": [1e3 * r["s"] for r in steps],
                "captures": caps, "digest": plan_digest_of(st),
                "replicated": leaves_digest(tr, replicated=True),
                "in_proj": list(tr.params["layers"]["mamba"]["in_proj"]
                                .shape),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches_want": scan_sparse_launches(cfg),
                "clock": {k: t - clock[i][1]
                          for i, (k, t) in enumerate(clock[1:])}})
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    check(all(np.isfinite(out["losses"])), "zamba2's 'model' losses not "
          "finite")
    return out


def modelscan_worker(d, stages):
    """A rank of phase 12g (`--modelscan-worker DIR`, the SPION_*
    environment of a job of MODELSCAN_RANKS): on a model line of
    MODELSCAN_RANKS, zamba2's fp32 steps, its bf16 Trainer, rwkv6's and
    whisper's fp32 steps; writes DIR/modelscan_<rank>.json."""
    import gc
    import torch
    from repro_torch.distributed import runtime
    from repro_torch.kernels.block_sparse_attn import load_library
    from repro_torch.launch.mesh import make_distributed_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(runtime.initialize(), "the 12g worker did not join its job")
    stages["joined"] = time.time()
    rank = runtime.process_index()
    torch.zeros(1, device=DEVICE)
    torch.cuda.synchronize()
    stages["cuda"] = time.time()
    load_library()
    stages["library"] = time.time()
    mesh = make_distributed_mesh(model=MODELSCAN_RANKS)
    check(mesh.shape == {"pod": 1, "data": 1, "model": MODELSCAN_RANKS},
          f"12g mesh {mesh}")
    out = {"rank": rank, "coords": mesh.coords()}
    secs, gsecs = model_line_timer(), labelled_gather_timer()
    for name in ("zamba2", "trainer", "rwkv6", "whisper"):
        if name == "trainer":
            out[name] = modelscan_trainer(mesh, d, rank, secs)
        else:
            out[name] = modelscan_leg(name, mesh, rank, secs, gsecs)
        gc.collect()
        torch.cuda.empty_cache()
        stages[name] = time.time()
    runtime.barrier("12g done")
    out["stages"] = stages
    with open(os.path.join(d, f"modelscan_{rank}.json"), "w") as f:
        json.dump(out, f)
    runtime.shutdown(0)   # ends the process
    return 0


def phase_model_scan():
    """12g: the hybrid, ssm and encdec families over a 'model' axis,
    MODELSCAN_RANKS ranks of this script on the card
    (`--modelscan-worker DIR`, a model line). zamba2-1.2b
    (MODELSCAN_ZAMBA_LAYERS layers), rwkv6-7b (SCAN_RWKV_LAYERS layers) and
    whisper-tiny (MODELSCAN_WHISPER_S decoder tokens) at full width, fp32:
    dense and (zamba2, whisper) sparse steps on a random causal plan within
    TOL_SEQ_LOSS and TOL_SEQ_GRAD of one process on the card, the
    replicated leaves' gradients bitwise equal across the line, the global
    norm within TOL_SEQ_LOSS of one process's, the sparse steps'
    launches scan_sparse_launches'; each planted fault of MODELSCAN_FAULTS
    past a gate. zamba2's bf16 Trainer through the transition: captures
    within TOL_CAPTURE of one process's on the gathered masters, one plan
    digest, sparse steps at scan_sparse_launches on every rank, the
    replicated masters equal; its checkpoint at MODELSCAN_RESUME_AT
    restored in this process: every rank's shards of it bitwise the
    rank's own, its next loss within TOL_RESUME of one process's on the
    line's gathered masters; the line's own resume within TOL_RESUME of
    its uninterrupted next step, and a restore that cuts in_proj
    contiguously past it. The three kernels against their plain versions
    and timed at both shard shapes."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import param_pspecs
    from repro_torch.launch.mesh import Mesh
    d = os.path.join(DP_DIR, "modelscan")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    t0, t_spawn = time.perf_counter(), time.time()
    wait_ranks(spawn_ranks(["--modelscan-worker", d], MODELSCAN_RANKS),
               "the 12g ranks")
    wall = time.perf_counter() - t0
    recs = []
    for r in range(MODELSCAN_RANKS):
        with open(os.path.join(d, f"modelscan_{r}.json")) as f:
            recs.append(json.load(f))
    card = card_line()
    launches = {k: 0 for k in KERNELS}
    faults, gaps = {}, {}
    for name in ("zamba2", "rwkv6", "whisper"):
        legs = [rec[name] for rec in recs]
        r0 = legs[0]["runs"]
        for r, leg in enumerate(legs):
            for kind, run in leg["runs"].items():
                want = leg["launches_want"] if kind == "sparse" else \
                    {k: 0 for k in KERNELS}
                check(run["launches"] == want, f"12g {name}: rank {r}'s "
                      f"{kind} step launched {run['launches']}, not {want}")
                if ":" in kind:
                    continue
                check(run["replicated"] == r0[kind]["replicated"],
                      f"12g {name} {kind}: rank {r}'s replicated leaves' "
                      f"gradients differ from rank 0's")
                check(run["loss_gap"] <= TOL_SEQ_LOSS and
                      run["grad_rel"] <= TOL_SEQ_GRAD,
                      f"12g {name}'s {kind} step on rank {r} misses one "
                      f"process's: "
                      f"{ {k: v for k, v in run.items() if k != 'launches'} }")
                check(abs(run["gnorm"] - run["gnorm_ref"]) <=
                      TOL_SEQ_LOSS * run["gnorm_ref"],
                      f"12g {name}'s {kind} global norm {run['gnorm']} vs "
                      f"one process {run['gnorm_ref']}")
            if "sparse" in leg["runs"]:
                for k in KERNELS:
                    launches[k] += leg["runs"]["sparse"]["launches"][k]
        for kind, run in r0.items():
            if ":" in kind:
                apart = legs[1]["runs"][kind]["replicated"] != \
                    run["replicated"]
                faults[f"{name} {kind.split(':')[0]}"] = dict(run,
                                                              apart=apart)
            else:
                gaps[f"{name} {kind}"] = (run["loss_gap"], run["grad_rel"])
        log(f"model-scan {name}: {MODELSCAN_RANKS} ranks on 'model', fp32"
            + (f", in_proj {legs[0]['in_proj']} (a rank's columns: the "
               f"r-th half of z, x, B‖C and dt)" if "in_proj" in legs[0]
               else "") + "; "
            + "; ".join(
                f"{kind} loss {run['loss']:.6f} vs one process "
                f"{run['ref_loss']:.6f} (rel {run['loss_gap']:.3e}), worst "
                f"gradient leaf {run['worst_leaf']} {run['grad_rel']:.3e} of "
                f"its largest, global norm {run['gnorm']:.6f} vs "
                f"{run['gnorm_ref']:.6f} (the rank's shards alone "
                f"{run['gnorm_local']:.6f})"
                for kind, run in r0.items() if ":" not in kind)
            + f" (gates {TOL_SEQ_LOSS}, {TOL_SEQ_GRAD}); replicated "
            f"leaves' gradients bitwise equal across the line")
        for r, leg in enumerate(legs):
            log(f"model-scan {name} rank {r}: "
                + "; ".join(f"{kind} {run['ms']:.1f} ms (model-line sums "
                            f"{run['sum_ms']:.1f} ms, B‖C gather "
                            f"{run['gather_ms']:.1f} ms)"
                            for kind, run in leg["runs"].items()
                            if ":" not in kind)
                + f"; sparse launches "
                f"{leg['runs'].get('sparse', {}).get('launches')}; peak "
                f"{leg['peak_gb']:.2f} GB ({card})")
    for what, run in faults.items():
        missed = run["loss_gap"] > TOL_SEQ_LOSS or \
            run["grad_rel"] > TOL_SEQ_GRAD or run["apart"]
        log(f"model-scan planted {what}: loss rel {run['loss_gap']:.3e}, "
            f"worst gradient leaf {run['worst_leaf']} {run['grad_rel']:.3e}"
            f"{', replicated leaves apart' if run['apart'] else ''} -> "
            f"{'misses' if missed else 'PASSES'} the gate")
        check(missed, f"12g: the planted {what} passes the gates: {run}")
    # zamba2's Trainer on the line
    trs = [rec["trainer"] for rec in recs]
    t0_ = trs[0]
    check(all(x["losses"] == t0_["losses"] for x in trs),
          "12g: the Trainer ranks' losses differ")
    check(len({x["digest"] for x in trs}) == 1,
          f"12g: the ranks' plan digests differ: "
          f"{[x['digest'] for x in trs]}")
    check(len({x["replicated"] for x in trs}) == 1,
          "12g: the ranks' replicated masters differ after the Trainer")
    for r, x in enumerate(trs):
        check([c["digest"] for c in x["captures"]] ==
              [c["digest"] for c in t0_["captures"]],
              f"12g: rank {r}'s captures differ from rank 0's")
        for ph, ln in zip(x["phases"], x["launches"]):
            check(ln == x["launches_want"] if ph == "sparse"
                  else not any(ln.values()),
                  f"12g: rank {r}'s {ph} Trainer step launched {ln}")
            for k in KERNELS:
                launches[k] += ln[k]
    check(t0_["phases"][-1] == "sparse", f"12g: the Trainer's step "
          f"{MODELSCAN_RESUME_AT + 1} is not sparse")
    cap_gap = max((c["gap"] for c in t0_["captures"]), default=math.inf)
    check(cap_gap <= TOL_CAPTURE,
          f"12g: zamba2's captures on the line miss one process's: "
          f"{cap_gap}; gate {TOL_CAPTURE}")
    line_resume = loss_gap([t0_["resumed"]], [t0_["next"]])
    planted_resume = loss_gap([t0_["restore_contiguous"]], [t0_["next"]])
    # the line's checkpoint in this process: each rank's shards of the
    # restored state bitwise the rank's own, and the next loss against one
    # process's on the line's gathered masters
    cfg = modelscan_config()
    t_one = time.perf_counter()
    one = modelscan_trainer_of(cfg, ckpt_dir=os.path.join(d, "ckpt"))
    check(one._restore_latest(step=MODELSCAN_RESUME_AT) and
          one.step == MODELSCAN_RESUME_AT,
          "12g: the line's checkpoint did not restore in one process")
    check(plan_digest_of(one.spion_state) == t0_["digest"],
          "12g: the restored plan differs from the line's")
    line = Mesh(np.arange(MODELSCAN_RANKS).reshape(1, 1, MODELSCAN_RANKS),
                ("pod", "data", "model"))
    specs = param_pspecs(one.params, line)
    restored = trainer_state(one)
    for r, x in enumerate(trs):
        check(shard_digests(restored, line, specs, cfg, rank=r) ==
              x["shards"], f"12g: rank {r}'s shards of the state restored "
              f"in one process differ from the rank's own")
    del restored
    reset_launch_counts()
    next_loss = float(one._fetch_and_step()[1]["loss"])
    resume_launches = launch_counts()
    del one
    torch.cuda.empty_cache()
    t_one = time.perf_counter() - t_one
    one_resume = loss_gap([next_loss], [t0_["one_next"]])
    # beside the line's: bf16 partial products round before the line's sums
    line_vs_one = loss_gap([next_loss], [t0_["next"]])
    log(f"model-scan zamba2 Trainer: bf16, {MODELSCAN_ZAMBA_LAYERS} layers, "
        f"{SCAN_BATCH} x {SCAN_S} on a model line of {MODELSCAN_RANKS} "
        f"(in_proj {t0_['in_proj']} a rank), {len(t0_['phases'])} steps "
        f"({t0_['phases'].count('dense')} dense, then sparse at "
        f"{t0_['launches_want']} a step a rank); captures vs one process on "
        f"the gathered masters "
        f"{', '.join('%.3e' % c['gap'] for c in t0_['captures'])} of the "
        f"map's largest (gate {TOL_CAPTURE}); one plan digest "
        f"({t0_['digest']}); replicated masters equal; the step-"
        f"{MODELSCAN_RESUME_AT} checkpoint restored in one process: every "
        f"rank's shards of it bitwise the rank's own, its next loss "
        f"{next_loss:.6f} vs one process's on the line's masters "
        f"{t0_['one_next']:.6f} (rel {one_resume:.3e}; gate {TOL_RESUME}; "
        f"launches {resume_launches}) and vs the line's {t0_['next']:.6f} "
        f"(rel {line_vs_one:.3e}: bf16 partial products round before the "
        f"line's sums); the line resumed from it {line_resume:.3e} from "
        f"its uninterrupted step (gate {TOL_RESUME}), a restore cutting "
        f"in_proj contiguously {planted_resume:.3e}")
    for r, x in enumerate(trs):
        def med(ph):
            xs = [ms for ms, p in zip(x["step_ms"][1:], x["phases"][1:])
                  if p == ph]
            return sorted(xs)[len(xs) // 2] if xs else float("nan")
        log(f"model-scan zamba2 Trainer rank {r}: step median dense "
            f"{med('dense'):.1f} ms, sparse {med('sparse'):.1f} ms; captures "
            f"{', '.join('%.1f' % c['ms'] for c in x['captures'])} ms (their "
            f"model-line sums "
            f"{', '.join('%.1f' % c['sum_ms'] for c in x['captures'])} ms); "
            f"peak {x['peak_gb']:.2f} GB; wall clock, s: {fmt_split(x['clock'])}"
            f" ({card})")
    check(line_resume <= TOL_RESUME < planted_resume,
          f"12g: the line resumed {line_resume}, a restore cutting in_proj "
          f"contiguously {planted_resume}; gate {TOL_RESUME}")
    check(one_resume <= TOL_RESUME, f"12g: the checkpoint's next loss in "
          f"one process differs from one process's on the line's masters by "
          f"{one_resume}; gate {TOL_RESUME}")
    check(resume_launches == t0_["launches_want"],
          f"12g: the resumed step launched {resume_launches}")
    # the kernels at both shard shapes
    t_kernels = time.perf_counter()
    kernels = {}
    for name, arch in (("zamba2", "zamba2-1.2b"), ("whisper", "whisper-tiny")):
        c = get_config(arch)
        S = SCAN_S if name == "zamba2" else MODELSCAN_WHISPER_S
        batch = SCAN_BATCH if name == "zamba2" else SCAN_WHISPER_BATCH
        col, nvalid = modelscan_plan(c, S)
        shape = dict(N=batch * c.num_kv_heads // MODELSCAN_RANKS,
                     G=c.num_heads // c.num_kv_heads, S=S,
                     hd=c.resolved_head_dim, block=c.spion.block_size)
        kernels[name] = path_kernels(f"modelscan-{name}", shape,
                                     (col[0], nvalid[0]),
                                     "12g's random layer-0", SEED + 25)
    clock = stage_split(t_spawn, recs[0]["stages"], (
        ("zamba2", "zamba2 fp32 steps"), ("trainer", "zamba2 Trainer"),
        ("rwkv6", "rwkv6 fp32 steps"), ("whisper", "whisper steps")),
        start=START_STAGES[:5])
    clock["exit"] = wall - sum(clock.values())
    t_kernels = time.perf_counter() - t_kernels
    log(f"model-scan wall clock, rank 0, s: {fmt_split(clock)}; phase 12g "
        f"{wall:.1f} s, then in this process the restore and its step "
        f"{t_one:.1f} s, the kernels at both shard shapes {t_kernels:.1f} s")
    return dict(seconds=wall + t_one + t_kernels, launches=launches,
                cap_gap=cap_gap, gaps=gaps,
                faults={k: (v["loss_gap"], v["grad_rel"])
                                   for k, v in faults.items()},
                line_resume=line_resume, one_resume=one_resume,
                planted_resume=planted_resume, kernels=kernels)


# -- phase 12h: 'seq' together with 'model', and the head fallback ---------

SEQMODEL_MESH = (2, 2)      # 12h (a): 'seq' x 'model' (data 1), four ranks
SEQMODEL_FALLBACK = 4       # 12h (b): a model line of 4 (data 1)
SEQMODEL_RANKS = 4
SEQMODEL_LRA_STEPS = 14     # spion-lra: phase 5's 12 dense steps, 2 sparse
SEQMODEL_WHISPER_S = 448    # (b): whisper's decoder tokens, as 12g's
SEQMODEL_QWEN_LAYERS = 1    # (b): qwen2-7b with 2 KV heads, 1 of 28 layers
SEQMODEL_QWEN_BATCH = 1
SEQMODEL_QWEN_S = 512
# (b) the scan fallback, reduced: no repo config reaches it on <= 4 ranks
# (every full scan width is a power of two), so two widths of each family
# are changed and the depth cut. rwkv6-7b at full d_model, d_ff and
# vocabulary with 6 WKV heads of 64 (w_r's 384 columns, 96 a rank: 1.5
# heads) and 2 of its 32 layers; zamba2-1.2b at full width with state_size
# 65 (2N = 130: in_proj's 8386 columns whole, out_proj's 4096 rows split)
# and 6 of its 38 layers (one application of the shared block, 8 of its
# 32 heads a rank through the kernels)
SEQMODEL_RWKV_LAYERS = 2
SEQMODEL_RWKV_HEADS = 6
SEQMODEL_RWKV_S = 1024
SEQMODEL_ZAMBA_LAYERS = 6
SEQMODEL_ZAMBA_STATE = 65
SEQMODEL_ZAMBA_S = 2048
SEQMODEL_SCAN_BATCH = 1
SEQMODEL_DECODE = ("zamba2f", 2, 8, 64)   # leg, batch, tokens, cache length
# 12h's fp32 legs: leg -> (the mesh it runs on, its step kinds, its planted
# faults as fault:kind). Under the fallback whisper-tiny's 6 heads are 1.5
# a rank (wq's 384 columns, 96 a rank) and qwen2-7b's 2 KV heads half a
# head a rank (wk's 256 columns, 64 a rank)
SEQMODEL_MESHES = ("seq_model", "fallback")
SEQMODEL_LEGS = {
    "zamba2": ("seq_model", ("dense", "sparse"), ()),
    "whisper": ("seq_model", ("dense", "sparse"),
                ("grads_data_only:dense", "halo_global:sparse")),
    "whisper6": ("fallback", ("dense", "sparse"),
                 ("gather_no_sum:dense", "gather_sum_twice:dense")),
    "qwen2kv2": ("fallback", ("dense",), ("rope_before_gather:dense",)),
    "rwkv6f": ("fallback", ("dense",), ()),
    "zamba2f": ("fallback", ("dense", "sparse"), ()),
}


class _GatherBackward:
    """12h's planted fallback-gather faults: `gather_model` whose backward
    keeps the rank's part of its own gradient without the sum over the
    line (times 0), or sums it twice (times 2)."""

    @staticmethod
    def make(times):
        import torch
        import torch.distributed as dist
        from repro_torch.distributed import sharding

        class Gather(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, dim):
                # the backward runs on autograd's device thread, outside
                # the forward's mesh context: keep the line here
                mesh = sharding.active_mesh()
                ctx.dim, ctx.rows = dim, x.shape[dim]
                ctx.group = mesh.group("model")
                ctx.idx = mesh.axis_index("model")
                return sharding.gather_model(x.detach(), dim)

            @staticmethod
            def backward(ctx, g):
                g = g.float().clone()
                for _ in range(times):
                    dist.all_reduce(g, group=ctx.group)
                return g.narrow(ctx.dim, ctx.idx * ctx.rows,
                                ctx.rows), None
        return lambda x, dim: Gather.apply(x, dim)


@contextlib.contextmanager
def planted_seqmodel_fault(kind):
    """Phase 12h's planted faults, by replacing an entry point for the
    duration; None plants nothing:
      - grads_data_only: the loss terms and gradients summed over the data
        axes only (not over 'seq');
      - halo_global: the halo exchange's neighbours taken from the global
        rank order (the next rank holds the same shard's other KV heads)
        instead of the rank's 'seq' line;
      - rope_before_gather: RoPE on each rank's columns of q and k before
        the fallback's gather (blocks of up to head_dim columns taken as
        heads: mid-head columns rotate the wrong pairs), none after it;
      - gather_no_sum / gather_sum_twice: the fallback gather's backward
        without its sum over the line, or summed twice."""
    import torch
    from repro_torch.distributed import runtime, sharding
    from repro_torch.kernels import sharded
    from repro_torch.launch import steps
    from repro_torch.models import attention
    from repro_torch.models.layers import rope
    saved = []

    def put(mod, name, fn):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)
    if kind == "grads_data_only":
        put(steps, "reduce_axes", lambda mesh: sharding.data_axes(mesh))
    if kind == "halo_global":
        def global_order(mesh):
            r, n = runtime.process_index(), mesh.size
            return mesh.group(mesh.axis_names), (r - 1) % n, (r + 1) % n
        put(sharded, "halo_peers", global_order)
    if kind == "rope_before_gather":
        sound = attention.gather_columns
        cfg = seqmodel_config("qwen2kv2")[0]

        def rope_first(parts):
            hd, out = cfg.resolved_head_dim, []
            for i, t in enumerate(parts):
                if t is not None and i < 2:
                    w = min(hd, t.shape[-1])
                    pos = torch.arange(t.shape[1], device=t.device)
                    t = rope(t.reshape(*t.shape[:2], -1, w), pos,
                             cfg.rope_theta).reshape(t.shape)
                out.append(t)
            return sound(out)
        put(attention, "gather_columns", rope_first)
        put(attention, "rope_heads", lambda cfg, q, k, positions: (q, k))
    if kind in ("gather_no_sum", "gather_sum_twice"):
        put(attention, "gather_model",
            _GatherBackward.make(0 if kind == "gather_no_sum" else 2))
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def seqmodel_config(name):
    """12h's fp32 legs at full width, and the global batch of each (seeded):
    zamba2-1.2b at SCAN_ZAMBA_LAYERS layers and whisper-tiny whole with
    SCAN_WHISPER_S decoder tokens on (seq 2, model 2), as 12e's; on model 4
    whisper-tiny with SEQMODEL_WHISPER_S tokens (6 heads) and qwen2-7b at
    SEQMODEL_QWEN_LAYERS layer with 2 KV heads (RoPE; a head count of no
    repo config: the fallback's KV-only case with RoPE at full width)."""
    import numpy as np
    from repro_torch.configs import get_config
    if name == "zamba2":
        return scan_config("zamba2")
    if name == "whisper":
        return scan_config("whisper")
    if name == "whisper6":
        cfg, gb = scan_config("whisper", whisper_s=SEQMODEL_WHISPER_S)
        check(cfg.num_heads == cfg.num_kv_heads == 6, "whisper-tiny's heads")
        return cfg, gb
    if name in ("rwkv6f", "zamba2f"):
        import dataclasses
        from repro_torch.distributed.sharding import scan_split
        if name == "rwkv6f":
            cfg = get_config("rwkv6-7b")
            check(cfg.d_model == 4096 and cfg.d_ff == 14336 and
                  cfg.vocab_size == 65536 and cfg.resolved_head_dim == 64,
                  "rwkv6-7b config changed")
            cfg = cfg.replace(num_layers=SEQMODEL_RWKV_LAYERS,
                              num_heads=SEQMODEL_RWKV_HEADS,
                              num_kv_heads=SEQMODEL_RWKV_HEADS, head_dim=64,
                              dtype="float32")
            S = SEQMODEL_RWKV_S
        else:
            cfg = get_config("zamba2-1.2b")
            check(cfg.d_model == 2048 and cfg.ssm.state_size == 64 and
                  cfg.num_heads == 32 and cfg.spion.block_size == 128,
                  "zamba2-1.2b config changed")
            cfg = cfg.replace(num_layers=SEQMODEL_ZAMBA_LAYERS,
                              ssm=dataclasses.replace(
                                  cfg.ssm, state_size=SEQMODEL_ZAMBA_STATE),
                              dtype="float32")
            S = SEQMODEL_ZAMBA_S
        mesh = seqmodel_meshes()["fallback"]
        check(not scan_split(cfg, mesh), f"12h {name}: the scan splits by "
              f"heads on model {SEQMODEL_FALLBACK}")
        rng = np.random.default_rng(SEED + 46)
        toks = rng.integers(0, cfg.vocab_size, size=(
            SEQMODEL_SCAN_BATCH, S + 1)).astype(np.int64)
        return cfg, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    cfg = get_config("qwen2-7b")
    check(cfg.d_model == 3584 and cfg.num_heads == 28 and
          cfg.num_kv_heads == 4 and cfg.resolved_head_dim == 128 and
          cfg.qkv_bias and cfg.rope_theta, "qwen2-7b config changed")
    cfg = cfg.replace(num_layers=SEQMODEL_QWEN_LAYERS, num_kv_heads=2,
                      dtype="float32")
    rng = np.random.default_rng(SEED + 26)
    toks = rng.integers(0, cfg.vocab_size, size=(
        SEQMODEL_QWEN_BATCH, SEQMODEL_QWEN_S + 1)).astype(np.int64)
    return cfg, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def seqmodel_meshes():
    """(a) and (b) as Meshes without groups, laid out as the workers'
    make_distributed_mesh(seq=2, model=2) and make_distributed_mesh(
    model=4): the parent cuts the references by them."""
    import numpy as np
    from repro_torch.launch.mesh import Mesh
    s, m = SEQMODEL_MESH
    return {"seq_model": Mesh(np.arange(s * m).reshape(1, s, 1, m),
                              ("pod", "seq", "data", "model")),
            "fallback": Mesh(np.arange(SEQMODEL_FALLBACK).reshape(
                1, 1, SEQMODEL_FALLBACK), ("pod", "data", "model"))}


def seqmodel_tables(name, cfg, S):
    """A leg's sparse tables on the card: on (seq 2, model 2) the dry-run
    plan banded to halo (1, 0) (the halo exchange on the rank's KV-head
    shard), on model 4 12g's random causal plan; None for qwen2kv2 and
    rwkv6f (dense only)."""
    import torch
    from repro_torch.launch.steps import spion_dryrun_tables
    if name in ("qwen2kv2", "rwkv6f"):
        return None
    if SEQMODEL_LEGS[name][0] == "fallback":
        col, nvalid = modelscan_plan(cfg, S)
        return {"col_idx": torch.as_tensor(col, device=DEVICE),
                "nvalid": torch.as_tensor(nvalid, device=DEVICE),
                "block": cfg.spion.block_size, "halo": None}
    layers = None
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import n_attn_apps
        layers = n_attn_apps(cfg)
    tables = spion_dryrun_tables(cfg, S, layers=layers, max_extent=1)
    return {k: v.to(DEVICE) if torch.is_tensor(v) else v
            for k, v in tables.items()}


def seqmodel_masters(cfg):
    """A leg's fp32 masters on the card from the leg's seed: the same on
    every rank and in the parent."""
    import torch
    from repro_torch.launch.train import masters_of
    from repro_torch.models.registry import build
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 25)
    return masters_of(build(cfg).init(gen, device=DEVICE))


def seqmodel_decode(cfg, full, mesh=None):
    """SEQMODEL_DECODE's tokens decoded from a zero cache, one process or
    this rank of `mesh` (its shards of `full` and of the cache under
    cache_pspecs; the Mamba2 layers gather the state leaves the specs
    split and keep their shards): {"logits": (tokens, B, V) whole, "cache":
    the final cache whole (gather_cache)} on the host in fp32, with the
    step times."""
    import numpy as np
    import torch
    from repro_torch.distributed.sharding import (data_axes, gather_cache,
                                                  param_pspecs, reshard,
                                                  sanitize_spec, shard_cache,
                                                  shard_params)
    from repro_torch.launch.steps import cache_pspecs, make_serve_step
    from repro_torch.launch.train import nest
    from repro_torch.models.layers import ParamTree
    from repro_torch.models.registry import build
    _, B, n, S = SEQMODEL_DECODE
    cache = build(cfg).init_cache(B, S, device=DEVICE)
    params, specs = full, None
    if mesh is not None:
        params = ParamTree(nest(shard_params(full, mesh, param_pspecs(
            full, mesh), cfg)))
        specs = cache_pspecs(cfg, cache, mesh, B)
        cache = shard_cache(cache, specs, mesh, cfg)
        ospec = sanitize_spec(mesh, (data_axes(mesh), "model"),
                              (B, cfg.vocab_size))
    serve = make_serve_step(cfg, mesh=mesh, specs=specs)
    rng = np.random.default_rng(SEED + 47)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(n, B, 1)),
                           device=DEVICE)
    logits, ms = [], []
    with torch.no_grad():
        for p in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            lg, cache = serve(params, cache, toks[p], p)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t))
            if mesh is not None:
                lg = reshard(lg, ospec, (), mesh)
            logits.append(lg.float().cpu())
    if mesh is not None:
        cache = gather_cache(cache, specs, mesh, cfg)
    return {"logits": torch.stack(logits), "ms": ms,
            "cache": {k: v.float().cpu() for k, v in cache.items()}}


REFS_READY = "refs_ready"    # written by the parent once every reference is


def seqmodel_references(d):
    """12h's one-process references, computed once in this process while
    the ranks start and run spion-lra (the card is shared: four
    one-process steps at once would not fit): per leg and step kind the loss, the global norm and
    each leaf's largest |gradient| in DIR/ref_<leg>.json, and each rank's
    shard of every gradient (`local_index` under the leg's mesh) in
    DIR/ref_<leg>_<kind>_<rank>.pt. Returns {leg: seconds}."""
    import gc
    import torch
    from repro_torch.distributed.sharding import local_index, param_pspecs
    from repro_torch.launch.steps import make_loss_and_grads
    from repro_torch.optim import global_norm
    meshes = seqmodel_meshes()
    secs = {}
    for name, (mesh_name, kinds, _) in SEQMODEL_LEGS.items():
        t0 = time.perf_counter()
        cfg, gb = seqmodel_config(name)
        mesh = meshes[mesh_name]
        full = seqmodel_masters(cfg)
        specs = param_pspecs(full, mesh)
        batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in gb.items()}
        tables = seqmodel_tables(name, cfg, gb["tokens"].shape[1])
        one = make_loss_and_grads(cfg)
        torch.cuda.reset_peak_memory_stats()
        rec = {}
        for kind in kinds:
            loss, grads = one(full, batch, tables if kind == "sparse"
                              else None)
            rec[kind] = {"loss": float(loss),
                         "norm": float(global_norm(grads)),
                         "max": {n: g.abs().max().item()
                                 for n, g in grads.items()}}
            # a shard depends on the model index alone: ranks 0..|model|-1
            # are the first model line of both meshes
            for i in range(mesh.shape["model"]):
                torch.save({n: g[local_index(mesh, n, specs[n], g.shape, cfg,
                                             rank=i)].cpu().contiguous()
                            for n, g in grads.items()},
                           os.path.join(d, f"ref_{name}_{kind}_m{i}.pt"))
            del loss, grads
        if name == SEQMODEL_DECODE[0]:
            t_dec = time.perf_counter()
            torch.save(seqmodel_decode(cfg, full),
                       os.path.join(d, f"ref_{name}_decode.pt"))
            rec["decode_s"] = time.perf_counter() - t_dec
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        with open(os.path.join(d, f"ref_{name}.json"), "w") as f:
            json.dump(rec, f)
        del full, batch, tables, one
        gc.collect()
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t0
    return secs


def seqmodel_lra(mesh, d, rank, secs, gsecs):
    """12h's main path on one rank of (seq 2, model 2): spion-lra at
    ListOps size (2 of 4 heads, half the sequence a rank) through
    SEQMODEL_LRA_STEPS of phase 5's steps, every capture timed and kept.
    `secs`: model_line_timer's; `gsecs`: labelled_gather_timer's."""
    import numpy as np
    import torch
    from repro_torch.distributed.sharding import kernel_seq_axis
    from repro_torch.kernels import sharded
    tr, cfg, _ = lra_trainer(mesh=mesh)
    check(tr.mesh is mesh and tr._specs is not None,
          f"rank {rank}: the trainer's mesh is {tr.mesh}")
    steps, undo = record_steps(tr)
    caps, pooled = [], []
    in_captures = [0.0, 0.0]       # model-line sums and gathers in captures
    inner_capture = tr.capture

    def gathers():
        return sum(v for k, v in gsecs.items() if k != "grads")

    def capture(batch):
        s0, g0 = secs[0], gathers()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner_capture(batch)
        torch.cuda.synchronize()
        caps.append({"ms": 1e3 * (time.perf_counter() - t),
                     "sum_ms": 1e3 * (secs[0] - s0),
                     "gather_ms": 1e3 * (gathers() - g0)})
        in_captures[0] += secs[0] - s0
        in_captures[1] += gathers() - g0
        pooled.append(out[0].float().cpu().numpy())
        return out
    tr.capture = capture
    split = []

    def on_step(step, loss):
        split.append((secs[0] - in_captures[0], gathers() - in_captures[1],
                      gsecs.get("grads", 0.0), sharded.halo_seconds))
    tr.step_callback = on_step
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    tr.train(SEQMODEL_LRA_STEPS, ckpt_every=0, log_every=10**9,
             log=lambda m: None)
    undo()
    st = tr.spion_state
    axis, reason = kernel_seq_axis(mesh, tr.seq_len // cfg.spion.block_size,
                                   st.plan_stats["halo"])
    np.savez(os.path.join(d, f"pooled_{rank}.npz"),
             **{f"p{i}": p for i, p in enumerate(pooled)})
    if rank == 0:
        np.savez(os.path.join(d, "plan_layer0.npz"),
                 col=st.tables["col_idx"][0].cpu().numpy(),
                 nvalid=st.tables["nvalid"][0].cpu().numpy())
    deltas = np.diff(np.array([(0.0, 0.0, 0.0, 0.0)] + split), axis=0)
    out = {"losses": [r["loss"] for r in steps],
           "phases": [r["phase"] for r in steps],
           "launches": [r["launches"] for r in steps],
           "step_ms": [1e3 * r["s"] for r in steps],
           "sum_ms": (1e3 * deltas[:, 0]).tolist(),
           "gather_ms": (1e3 * deltas[:, 1]).tolist(),
           "allreduce_ms": (1e3 * deltas[:, 2]).tolist(),
           "halo_ms": (1e3 * deltas[:, 3]).tolist(),
           "captures": caps, "digest": plan_digest_of(st),
           "stats": st.plan_stats,
           "shards": leaves_digest(tr, replicated=False),
           "replicated": leaves_digest(tr, replicated=True),
           "wq": list(tr.params["layers"]["attn"]["wq"].shape),
           "branch": "halo" if axis else "gathered fallback",
           "reason": reason,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del tr
    return out


def seqmodel_leg(name, meshes, rank, d, secs, gsecs):
    """12h's fp32 leg of one configuration on one rank: make_loss_and_grads
    on the leg's mesh, the planted faults first, then the sound dense and
    (but qwen2kv2) sparse steps, each against the parent's one-process
    reference (the rank's shard of each gradient from DIR: each leaf's
    worst difference is read over the mesh without gathering the shards).
    The replicated leaves' gradients are digested for the check across the
    model line, every leaf's for the check across the 'seq' line; the
    global norm as the step computes it and, on (seq 2, model 2), summed
    over 'seq' as well (planted)."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.data.pipeline import local_batch
    from repro_torch.distributed.sharding import (kernel_seq_axis,
                                                  param_pspecs, shard_params,
                                                  sharded_dim)
    from repro_torch.kernels import sharded as sharded_mod
    from repro_torch.launch.steps import make_loss_and_grads
    from repro_torch.launch.train import nest
    from repro_torch.models.layers import ParamTree
    from repro_torch.optim import global_norm
    mesh_name, kinds, faults = SEQMODEL_LEGS[name]
    mesh = meshes[mesh_name]
    cfg, gb = seqmodel_config(name)
    with open(os.path.join(d, f"ref_{name}.json")) as f:
        refs = json.load(f)
    tables = seqmodel_tables(name, cfg, gb["tokens"].shape[1])
    if tables is not None and mesh_name == "seq_model":
        S, block = gb["tokens"].shape[1], cfg.spion.block_size
        axis, reason = kernel_seq_axis(mesh, S // block, tables["halo"])
        check(axis == "seq", f"12h {name}: the plan does not take the halo "
              f"path: {reason}")
    full = seqmodel_masters(cfg)
    specs = param_pspecs(full, mesh)
    sharded = {n for n, spec in specs.items()
               if sharded_dim(spec) is not None}
    batch = local_batch(mesh, gb, DEVICE)
    whole = mesh.group(mesh.axis_names)
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for kind, fault in [(f, f.split(":")[0]) for f in faults] + \
            [(k, None) for k in kinds]:
        sparse = kind.split(":")[-1] == "sparse"
        with planted_seqmodel_fault(fault):
            params = ParamTree(nest(shard_params(full, mesh, specs, cfg)),
                               trainable=True)
            f = make_loss_and_grads(
                cfg, mesh=mesh,
                halo=tables["halo"] if sparse and tables else None)
            reset_launch_counts()
            s0, g0 = secs[0], dict(gsecs)
            h0 = sharded_mod.halo_seconds
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, grads = f(params, batch, tables if sparse else None)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t)
        ref = refs[kind.split(":")[-1]]
        mine = torch.load(os.path.join(
            d, f"ref_{name}_{kind.split(':')[-1]}_m"
            f"{mesh.axis_index('model')}.pt"))
        names = sorted(grads)
        worst = torch.tensor([(grads[n] - mine[n].to(DEVICE)).abs().max()
                              .item() for n in names], dtype=torch.float64)
        del mine
        dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=whole)
        rel = {n: float(w) / max(ref["max"][n], 1e-30)
               for n, w in zip(names, worst)}
        leaf = max(rel, key=rel.get)
        run = {"loss": float(loss), "ref_loss": ref["loss"],
               "loss_gap": loss_gap([float(loss)], [ref["loss"]]),
               "grad_rel": rel[leaf], "worst_leaf": leaf, "ms": ms,
               "sum_ms": 1e3 * (secs[0] - s0),
               "gather_ms": {k: 1e3 * (v - g0.get(k, 0.0))
                             for k, v in gsecs.items()
                             if v - g0.get(k, 0.0) > 0},
               "halo_ms": 1e3 * (sharded_mod.halo_seconds - h0),
               "launches": launch_counts(),
               "replicated": grads_hash({n: g for n, g in grads.items()
                                         if n not in sharded}),
               "all": grads_hash(grads)}
        if fault is None:
            line = mesh.group("model")
            run["gnorm"] = float(global_norm(grads, sharded, line))
            run["gnorm_ref"] = ref["norm"]
            if mesh_name == "seq_model":
                # planted: the sharded leaves' squares summed over 'seq' too
                sq = sum(((grads[n].float() ** 2).sum() for n in sharded),
                         torch.zeros((), device=DEVICE))
                dist.all_reduce(sq, group=line)
                dist.all_reduce(sq, group=mesh.group("seq"))
                rep = sum(((g.float() ** 2).sum() for n, g in grads.items()
                           if n not in sharded),
                          torch.zeros((), device=DEVICE))
                run["gnorm_over_seq"] = float(torch.sqrt(sq + rep))
        runs[kind] = run
        if fault is None and name in ("whisper6", "qwen2kv2"):
            lp = params["dec_layers" if cfg.family == "audio"
                        else "layers"]["attn"]
            attn = {k: [int(x) for x in lp[k].shape[1:]]
                    for k in ("wq", "wk", "wo")}
        if fault is None and name in ("rwkv6f", "zamba2f"):
            # the scan's leaves a rank holds: the reference's spec shards
            scan = {n: list(p.shape[1:]) for n, p in params.named_parameters()
                    if n.startswith("layers.") and n.endswith((
                        "in_proj", "out_proj", "w_r", "w_in", "conv_w"))}
        del params, loss, grads, f
    out = {"runs": runs, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "ref_peak_gb": refs["peak_gb"],
           "launches_want": scan_sparse_launches(cfg) if tables else None,
           "halo": None if tables is None else tables["halo"]}
    if name == SEQMODEL_DECODE[0]:
        t = time.perf_counter()
        s0, g0 = secs[0], sum(gsecs.values())
        dec = seqmodel_decode(cfg, full, mesh)
        ref = torch.load(os.path.join(d, f"ref_{name}_decode.pt"))
        out["decode"] = {
            "logits_gap": serve_gap(dec["logits"], ref["logits"]),
            "cache_gap": {k: serve_gap(v, ref["cache"][k])
                          for k, v in dec["cache"].items()},
            "ms": dec["ms"], "ref_ms": ref["ms"],
            "seconds": time.perf_counter() - t,
            "sum_ms": 1e3 * (secs[0] - s0),
            "gather_ms": 1e3 * (sum(gsecs.values()) - g0),
            "tokens": SEQMODEL_DECODE[2]}
        del dec, ref
    if name in ("rwkv6f", "zamba2f"):
        out["scan_shards"] = scan
    if name in ("whisper6", "qwen2kv2"):
        out["attn_shards"] = attn
    del full
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier(group=whole)
    return out


def seqmodel_worker(d, stages):
    """A rank of phase 12h (`--seqmodel-worker DIR`, the SPION_* environment
    of a job of SEQMODEL_RANKS): spion-lra's Trainer, zamba2's and
    whisper's fp32 steps on (seq 2, model 2), then whisper's (6 heads) and
    qwen2-7b's (2 KV heads) on model 4, then 12i's collectives and 12j's
    serving legs; writes DIR/seqmodel_<rank>.json."""
    import gc
    import torch
    from repro_torch.distributed import runtime
    from repro_torch.kernels.block_sparse_attn import load_library
    from repro_torch.launch.mesh import make_distributed_mesh, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(runtime.initialize(), "the 12h worker did not join its job")
    stages["joined"] = time.time()
    rank = runtime.process_index()
    torch.zeros(1, device=DEVICE)
    torch.cuda.synchronize()
    stages["cuda"] = time.time()
    load_library()
    stages["library"] = time.time()
    s, m = SEQMODEL_MESH
    meshes = {"seq_model": make_distributed_mesh(seq=s, model=m),
              "fallback": make_distributed_mesh(model=SEQMODEL_FALLBACK),
              "sync": make_mesh(*SYNC_MESH), "pipe": make_mesh(*PIPE_MESH),
              "serve_data": make_distributed_mesh(model=2, data=2)}
    check(meshes["seq_model"].shape == {"pod": 1, "seq": s, "data": 1,
                                        "model": m},
          f"12h mesh {meshes['seq_model']}")
    out = {"rank": rank,
           "coords": {k: v.coords() for k, v in meshes.items()},
           "lines": {k: {a: v.line(a) for a in ("seq", "model")
                         if a in v.shape}
                     for k, v in meshes.items() if k in SEQMODEL_MESHES}}
    secs, gsecs = model_line_timer(), labelled_gather_timer()
    out["lra"] = seqmodel_lra(meshes["seq_model"], d, rank, secs, gsecs)
    gc.collect()
    torch.cuda.empty_cache()
    stages["lra"] = time.time()
    # the parent writes the legs' references while spion-lra runs
    t = time.time()
    while not os.path.exists(os.path.join(d, REFS_READY)):
        check(time.time() - t < 600, "12h: the parent's references did not "
              "come within 600 s")
        time.sleep(0.1)
    stages["refs"] = time.time()
    for name in SEQMODEL_LEGS:
        out[name] = seqmodel_leg(name, meshes, rank, d, secs, gsecs)
        stages[name] = time.time()
    # 12i on the same ranks
    out["sync"] = sync_leg(meshes["sync"], rank)
    stages["sync"] = time.time()
    out["pipe"] = pipe_leg(meshes["pipe"], rank, d)
    stages["pipe"] = time.time()
    # 12j on the same ranks
    out["serve"] = serve_legs(meshes, rank, d)
    stages["serve"] = time.time()
    runtime.barrier("12h done")
    out["stages"] = stages
    with open(os.path.join(d, f"seqmodel_{rank}.json"), "w") as f:
        json.dump(out, f)
    runtime.shutdown(0)   # ends the process
    return 0


def halo_kernels(label, shape, tables, halo, seed, causal=True):
    """The three kernels as the halo exchange runs them on the last shard of
    a 'seq' line of 2 (`kernels/sharded`: the shard's rows of the
    replicated tables rebased into halo storage by `local_tables`, K/V of
    the halo-extended rows, global offsets and sequence length), against
    their plain versions in fp32 and bf16, then timed (bf16) beside their
    bounds and SDPA. `shape` = N, G, S (the shard's rows), hd, block;
    `tables` = (col_idx, nvalid) numpy of the whole sequence; `halo` (left,
    right) in blocks. Returns {kernel: record}."""
    import torch
    from repro_torch.kernels.block_sparse_attn import (
        block_sparse_dkv, block_sparse_dq, block_sparse_fwd,
        fused_dkv_reference, fused_dq_reference, fused_forward_reference)
    from repro_torch.kernels.sharded import local_tables
    N, G, S, hd, block = (shape[k] for k in ("N", "G", "S", "hd", "block"))
    W, (h_l, h_r) = S // block, halo
    r0 = W                              # the second shard of two
    col, nvalid = (torch.as_tensor(t, device=DEVICE) for t in tables)
    col_l, nv_l, row_l, nvt_l = local_tables(col, nvalid, None, None,
                                             r0=r0, W=W, h_l=h_l, h_r=h_r)
    M = h_l + W + h_r
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    err, x = {}, None
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        q, do = (torch.randn((N, G, S, hd), generator=gen, device=DEVICE)
                 .to(dt) for _ in range(2))
        k, v = (torch.randn((N, M * block, hd), generator=gen,
                            device=DEVICE).to(dt) for _ in range(2))
        kw = dict(block=block, causal=causal, sliding_window=None,
                  offsets=(r0, r0 - h_l))
        fkw = dict(kw, seq_len=2 * S)
        o, lse = block_sparse_fwd(q, k, v, col_l, nv_l, **fkw)
        torch.cuda.synchronize()
        ro, rlse = fused_forward_reference(q, k, v, col_l, nv_l, **fkw)
        diff = (o.float() - ro.float()).abs()
        share = (diff / o_limit(dtype, o, ro)).max().item()
        check(share <= 1.0, f"kernel o at {label}'s halo shape {shape} "
              f"{dtype}: {share:.3g} of the limit")
        check(torch.equal(torch.isinf(lse), torch.isinf(rlse)) and
              (lse - rlse).nan_to_num(0.0, 0.0, 0.0).abs().max().item()
              <= TOL_LSE, f"lse at {label}'s halo shape {dtype}")
        delta = (do.float() * o.float()).sum(dim=-1)
        args = (q, k, v, do, lse, delta)
        dq = block_sparse_dq(*args, col_l, nv_l, **kw)
        dk, dv = block_sparse_dkv(*args, row_l, nvt_l, **kw)
        torch.cuda.synchronize()
        rdq = fused_dq_reference(*args, col_l, nv_l, **kw)
        rdk, rdv = fused_dkv_reference(*args, row_l, nvt_l, **kw)
        res = {n: hold_grad(n, dtype, g, r, shape) for n, g, r in
               (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv))}
        log_backward_path(f"{label} halo", shape, dtype, res)
        err[dtype] = dict(o=diff.max().item(),
                          **{n: res[n][0] for n in res})
        x = dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta, col=col_l,
                 nvalid=nv_l, row=row_l, nvalid_t=nvt_l, kw=kw)
    log(f"kernels at {label}'s halo shape {shape} halo ({h_l}, {h_r}) "
        f"blocks: the shard's {int(nv_l.sum())} listed tiles over {M} "
        f"stored column blocks")
    timing = backward_timing(x)
    timing["block_sparse_fwd"] = kernel_timing(
        (x["q"], x["k"], x["v"], x["col"], x["nvalid"],
         dict(x["kw"], seq_len=2 * S)), f"{label}'s halo shape")
    checks = {"block_sparse_fwd": ("o",), "block_sparse_dq": ("dq",),
              "block_sparse_dkv": ("dk", "dv")}
    return {name: dict(shape=dict(shape, causal=causal, halo=list(halo)),
                       max_abs_err=max(err["bfloat16"][g]
                                       for g in checks[name]),
                       max_abs_err_fp32=max(err["float32"][g]
                                            for g in checks[name]),
                       **{k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")})
            for name, t in timing.items()}


def phase_seq_model(train):
    """12h: 'seq' together with 'model', and the reference's fallback for
    head counts |model| does not divide; SEQMODEL_RANKS ranks of this
    script on the card (`--seqmodel-worker DIR`). While the ranks start
    and run spion-lra, this process computes the legs' one-process
    references (seqmodel_references; 12i's and 12j's too), and the ranks
    wait for them before their legs. (a) On
    (seq 2, model 2): spion-lra at phase 5's configuration, data and seed
    through SEQMODEL_LRA_STEPS steps (2 of 4 heads and half the sequence a
    rank): dense losses within TOL_DP of phase 5's, captures within
    TOL_CAPTURE of phase 5's, one plan digest equal to phase 5's (or the
    controller's on the ranks' map), every sparse step 8 + 4 + 4 on every
    rank, the shards equal across each 'seq' line and the replicated
    leaves across all; zamba2-1.2b (SCAN_ZAMBA_LAYERS layers) and
    whisper-tiny (SCAN_WHISPER_S tokens) fp32 dense and sparse steps (a
    plan banded to halo (1, 0): the halo exchange on a rank's KV-head
    shard). (b) On model 4, the fallback: whisper-tiny's 6 heads (1.5 a
    rank) dense and sparse, qwen2-7b with 2 KV heads (half a head a rank,
    RoPE) dense. Every fp32 step within TOL_SEQ_LOSS (loss and global
    norm) and TOL_SEQ_GRAD (each leaf) of one process, the replicated
    leaves' gradients bitwise equal across each model line and every
    leaf's across each 'seq' line, launches scan_sparse_launches' (the
    fallback's kernels on whole heads: as one process's); each planted
    fault of SEQMODEL_LEGS past a gate, and the global norm summed over
    'seq' as well past TOL_SEQ_LOSS. Then the three kernels against their
    plain versions and timed at the new shapes."""
    import gc
    import shutil
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.spion import SpionState
    d = os.path.join(DP_DIR, "seqmodel")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    gc.collect()
    torch.cuda.empty_cache()
    t0, t_spawn = time.perf_counter(), time.time()
    procs = spawn_ranks(["--seqmodel-worker", d], SEQMODEL_RANKS)
    # the references while the ranks start and run spion-lra, which reads
    # none of them; the ranks wait for REFS_READY before their legs
    t_ref = time.perf_counter()
    ref_secs = seqmodel_references(d)
    coll_secs = sync_references(d) + pipe_references(d)
    serve_secs = serve_references(d)
    with open(os.path.join(d, REFS_READY), "w") as f:
        f.write("ok")
    t_ref = time.perf_counter() - t_ref
    wait_ranks(procs, "the 12h ranks")
    wall = time.perf_counter() - t0
    recs = []
    for r in range(SEQMODEL_RANKS):
        with open(os.path.join(d, f"seqmodel_{r}.json")) as f:
            recs.append(json.load(f))
    card = card_line()
    launches = {k: 0 for k in KERNELS}
    # (a) spion-lra's Trainer against phase 5
    cfg, ref = train["cfg"], train["losses"]
    want = sparse_launches(cfg)
    lra = [rec["lra"] for rec in recs]
    got = lra[0]["losses"]
    check(all(x["losses"] == got for x in lra),
          "12h: the ranks' losses differ")
    for r, x in enumerate(lra):
        for ph, ln in zip(x["phases"], x["launches"]):
            check(ln == want if ph == "sparse" else not any(ln.values()),
                  f"12h: rank {r}'s {ph} step launched {ln}")
            for k in KERNELS:
                launches[k] += ln[k]
    check("sparse" in lra[0]["phases"], "12h: spion-lra never went sparse")
    dense_n = min(train["dense_steps"], lra[0]["phases"].count("dense"))
    gap = loss_gap(got[:dense_n], ref[:dense_n])
    check(len({x["digest"] for x in lra}) == 1,
          f"12h: the ranks' plan digests differ: {[x['digest'] for x in lra]}")
    check(len({x["replicated"] for x in lra}) == 1,
          "12h: the replicated masters differ across the ranks")
    for line in {tuple(rec["lines"]["seq_model"]["seq"]) for rec in recs}:
        check(len({lra[r]["shards"] for r in line}) == 1,
              f"12h: the masters' shards differ across the 'seq' line {line}")
    check(lra[0]["shards"] != lra[1]["shards"],
          "12h: a model line's two ranks hold the same shards")
    pooled = [dict(np.load(os.path.join(d, f"pooled_{r}.npz")))
              for r in range(SEQMODEL_RANKS)]
    n_caps = len(pooled[0])
    check(n_caps == len(train["pooled"]), f"12h: {n_caps} captures, phase 5 "
          f"made {len(train['pooled'])}")
    bitwise = True
    for r in range(SEQMODEL_RANKS):
        for i, w in enumerate(train["pooled"]):
            check(np.array_equal(pooled[r][f"p{i}"], pooled[0][f"p{i}"]),
                  f"12h: rank {r}'s capture {i} differs from rank 0's")
            bitwise &= bool(np.array_equal(pooled[r][f"p{i}"], w))
    cap_gaps = [float(np.abs(pooled[0][f"p{i}"] - w).max() / np.abs(w).max())
                for i, w in enumerate(train["pooled"])]
    cap_gap = max(cap_gaps)
    if bitwise:
        plan_ref, which = plan_digest_of(train["trainer"].spion_state), \
            "phase 5's"
    else:
        st = train["trainer"].spion_ctl.generate(
            SpionState(), pooled[0][f"p{n_caps - 1}"])
        plan_ref, which = plan_digest_of(st), \
            "the controller's on the ranks' map"
    same_plan = lra[0]["digest"] == plan_ref
    phase5_plan = lra[0]["digest"] == plan_digest_of(
        train["trainer"].spion_state)
    log(f"seq-model lra: {SEQMODEL_RANKS} ranks on the card (gloo), mesh "
        f"seq {SEQMODEL_MESH[0]} x model {SEQMODEL_MESH[1]} (model lines "
        f"{sorted({tuple(rec['lines']['seq_model']['model']) for rec in recs})}"
        f", 'seq' lines "
        f"{sorted({tuple(rec['lines']['seq_model']['seq']) for rec in recs})}"
        f"), spion-lra at ListOps size ({lra_config()[1]['batch']} sequences "
        f"x {lra_config()[1]['seq_len'] // SEQMODEL_MESH[0]} positions, wq "
        f"{lra[0]['wq']} a rank): {len(got)} steps, {dense_n} dense, then "
        f"sparse at {want} a step on every rank; dense losses vs phase 5's "
        f"max rel {gap:.3e} (gate {TOL_DP}); captures vs phase 5's "
        f"{', '.join('%.3e' % g for g in cap_gaps)} of the map's largest "
        f"({'bitwise' if bitwise else 'not bitwise'}; gate {TOL_CAPTURE}); "
        f"plan digests equal ({lra[0]['digest']}), "
        f"{'equal to' if same_plan else 'DIFFERENT from'} {which}, "
        f"{'equal to' if phase5_plan else 'not'} phase 5's; the trained plan "
        f"(halo {lra[0]['stats']['halo']}) takes the {lra[0]['branch']} "
        f"({lra[0]['reason']}); shards equal across each 'seq' line, "
        f"replicated masters across all")
    for r, x in enumerate(lra):
        def med(key, ph):
            xs = [v for v, p in zip(x[key][1:], x["phases"][1:]) if p == ph]
            return float(np.median(xs)) if xs else float("nan")
        log(f"seq-model lra rank {r} {recs[r]['coords']['seq_model']}: step "
            f"median dense {med('step_ms', 'dense'):.2f} ms (model-line sums "
            f"{med('sum_ms', 'dense'):.2f}, 'seq' gathers "
            f"{med('gather_ms', 'dense'):.2f}, gradient all-reduce "
            f"{med('allreduce_ms', 'dense'):.2f}), sparse "
            f"{med('step_ms', 'sparse'):.2f} ms (sums "
            f"{med('sum_ms', 'sparse'):.2f}, gathers "
            f"{med('gather_ms', 'sparse'):.2f}, halo "
            f"{med('halo_ms', 'sparse'):.2f}, all-reduce "
            f"{med('allreduce_ms', 'sparse'):.2f}); captures "
            f"{', '.join('%.1f' % c['ms'] for c in x['captures'])} ms (their "
            f"sums {', '.join('%.1f' % c['sum_ms'] for c in x['captures'])}, "
            f"gathers "
            f"{', '.join('%.1f' % c['gather_ms'] for c in x['captures'])}); "
            f"peak {x['peak_gb']:.2f} GB ({card})")
    check(gap <= TOL_DP, f"12h: spion-lra's dense losses differ from phase "
          f"5's by {gap}; gate {TOL_DP}")
    check(cap_gap <= TOL_CAPTURE, f"12h: captures {cap_gap}; gate "
          f"{TOL_CAPTURE}")
    check(same_plan, f"12h: the ranks' plan differs from {which}")
    # the fp32 legs
    faults, gaps = {}, {}
    for name, (mesh_name, kinds, _) in SEQMODEL_LEGS.items():
        legs = [rec[name] for rec in recs]
        r0 = legs[0]["runs"]
        model_lines = {tuple(rec["lines"][mesh_name]["model"])
                       for rec in recs}
        seq_lines = {tuple(rec["lines"][mesh_name]["seq"]) for rec in recs
                     if "seq" in rec["lines"][mesh_name]}
        for r, leg in enumerate(legs):
            for kind, run in leg["runs"].items():
                if ":" in kind:
                    continue
                want_l = leg["launches_want"] if kind == "sparse" else \
                    {k: 0 for k in KERNELS}
                check(run["launches"] == want_l, f"12h {name}: rank {r}'s "
                      f"{kind} step launched {run['launches']}, not {want_l}")
                check(run["loss_gap"] <= TOL_SEQ_LOSS and
                      run["grad_rel"] <= TOL_SEQ_GRAD,
                      f"12h {name}'s {kind} step on rank {r} misses one "
                      f"process's: "
                      f"{ {k: v for k, v in run.items() if k != 'launches'} }")
                check(abs(run["gnorm"] - run["gnorm_ref"]) <=
                      TOL_SEQ_LOSS * run["gnorm_ref"],
                      f"12h {name}'s {kind} global norm {run['gnorm']} vs "
                      f"one process {run['gnorm_ref']}")
            if "sparse" in leg["runs"]:
                for k in KERNELS:
                    launches[k] += leg["runs"]["sparse"]["launches"][k]
        for kind in kinds:
            for line in model_lines:
                check(len({legs[r]["runs"][kind]["replicated"]
                           for r in line}) == 1,
                      f"12h {name} {kind}: the replicated leaves' gradients "
                      f"differ across the model line {line}")
            for line in seq_lines:
                check(len({legs[r]["runs"][kind]["all"] for r in line}) == 1,
                      f"12h {name} {kind}: the gradients differ across the "
                      f"'seq' line {line}")
            gaps[f"{name} {kind}"] = (r0[kind]["loss_gap"],
                                      r0[kind]["grad_rel"])
        for kind, run in r0.items():
            if ":" in kind:
                worst = max((leg["runs"][kind] for leg in legs),
                            key=lambda x: (x["loss_gap"], x["grad_rel"]))
                apart = any(len({legs[r]["runs"][kind]["replicated"]
                                 for r in line}) > 1 for line in model_lines)
                faults[f"{name} {kind.split(':')[0]}"] = dict(worst,
                                                              apart=apart)
        if "gnorm_over_seq" in r0.get("dense", {}):
            run = r0["dense"]
            faults[f"{name} norm_over_seq"] = dict(
                run, loss_gap=abs(run["gnorm_over_seq"] - run["gnorm_ref"])
                / run["gnorm_ref"], grad_rel=0.0, apart=False,
                worst_leaf="(the global norm)")
        log(f"seq-model {name}: {mesh_name} "
            f"({'seq %d x model %d' % SEQMODEL_MESH if mesh_name == 'seq_model' else 'model %d' % SEQMODEL_FALLBACK}), "
            f"fp32"
            + (f", attention shards a rank {legs[0]['attn_shards']}"
               if "attn_shards" in legs[0] else "")
            + (f", plan halo {legs[0]['halo']}" if legs[0]["halo"] else "")
            + "; " + "; ".join(
                f"{kind} loss {run['loss']:.6f} vs one process "
                f"{run['ref_loss']:.6f} (rel {run['loss_gap']:.3e}), worst "
                f"gradient leaf {run['worst_leaf']} {run['grad_rel']:.3e} of "
                f"its largest, global norm {run['gnorm']:.6f} vs "
                f"{run['gnorm_ref']:.6f}"
                for kind, run in r0.items() if ":" not in kind)
            + f" (gates {TOL_SEQ_LOSS}, {TOL_SEQ_GRAD}); replicated leaves' "
            f"gradients bitwise equal across each model line"
            + (", every leaf's across each 'seq' line" if seq_lines else "")
            + f"; one-process reference peak {legs[0]['ref_peak_gb']:.2f} GB"
            f" in {ref_secs[name]:.1f} s")
        if "scan_shards" in legs[0]:
            log(f"seq-model {name}: the scan fallback (2N / heads that "
                f"model {SEQMODEL_FALLBACK} does not divide), the scan's "
                f"leaves a rank (layer axis dropped) {legs[0]['scan_shards']}")
        if "decode" in legs[0]:
            for r, leg in enumerate(legs):
                dec = leg["decode"]
                worst = max([dec["logits_gap"], *dec["cache_gap"].values()])
                gaps[f"{name} decode"] = max(gaps.get(f"{name} decode",
                                                  (0.0, 0.0))[0], worst), 0.0
                check(worst <= TOL_SEQ_LOSS, f"12h {name}: rank {r}'s "
                      f"decode misses one process's: {dec}")
                log(f"seq-model {name} decode rank {r}: {dec['tokens']} "
                    f"tokens from a zero cache (B {SEQMODEL_DECODE[1]}), "
                    f"logits {dec['logits_gap']:.3e} of one process's "
                    f"largest, final cache "
                    + ", ".join(f"{k} {v:.3e}" for k, v in
                                dec["cache_gap"].items())
                    + f" (gate {TOL_SEQ_LOSS}); a token median "
                    f"{np.median(dec['ms']):.2f} ms (one process "
                    f"{np.median(dec['ref_ms']):.2f} ms), of the "
                    f"{dec['seconds']:.1f} s model-line sums "
                    f"{dec['sum_ms']:.1f} ms and gathers "
                    f"{dec['gather_ms']:.1f} ms ({card})")
        for r, leg in enumerate(legs):
            log(f"seq-model {name} rank {r}: " + "; ".join(
                f"{kind} {run['ms']:.1f} ms (model-line sums "
                f"{run['sum_ms']:.1f} ms, gathers "
                + (", ".join(f"{k} {v:.1f}" for k, v in
                             sorted(run["gather_ms"].items())) or "none")
                + f" ms, halo {run['halo_ms']:.1f} ms)"
                for kind, run in leg["runs"].items() if ":" not in kind)
                + f"; sparse launches "
                f"{leg['runs'].get('sparse', {}).get('launches')}; peak "
                f"{leg['peak_gb']:.2f} GB ({card})")
    for what, run in faults.items():
        missed = run["loss_gap"] > TOL_SEQ_LOSS or \
            run["grad_rel"] > TOL_SEQ_GRAD or run["apart"]
        log(f"seq-model planted {what}: loss (or norm) rel "
            f"{run['loss_gap']:.3e}, worst gradient leaf {run['worst_leaf']} "
            f"{run['grad_rel']:.3e}"
            f"{', replicated leaves apart' if run['apart'] else ''} -> "
            f"{'misses' if missed else 'PASSES'} the gate")
        check(missed, f"12h: the planted {what} passes the gates: {run}")
    coll = check_collectives(recs, d, coll_secs)
    # the kernels at the new shapes
    t_kernels = time.perf_counter()
    kernels = {}
    lra_cfg, task = lra_config()
    B, S = task["batch"], task["seq_len"]
    plan = np.load(os.path.join(d, "plan_layer0.npz"))
    kv = lra_cfg.num_kv_heads // SEQMODEL_MESH[1]
    if lra[0]["branch"] == "halo":
        kernels["lra"] = halo_kernels(
            "seqmodel-lra", dict(N=B * kv, G=1, S=S // SEQMODEL_MESH[0],
                                 hd=lra_cfg.resolved_head_dim,
                                 block=lra_cfg.spion.block_size),
            (plan["col"], plan["nvalid"]), lra[0]["stats"]["halo"], SEED + 27,
            causal=False)
    else:
        kernels["lra"] = path_kernels(
            "seqmodel-lra", dict(N=B * kv, G=1, S=S,
                                 hd=lra_cfg.resolved_head_dim,
                                 block=lra_cfg.spion.block_size),
            (plan["col"], plan["nvalid"]), "the trained plan's layer-0",
            SEED + 27, causal=False)
    for name, arch, batch, s_all in (
            ("zamba2", "zamba2-1.2b", SCAN_BATCH, SCAN_S),
            ("whisper", "whisper-tiny", SCAN_WHISPER_BATCH, SCAN_WHISPER_S)):
        c = get_config(arch)
        leg_cfg = seqmodel_config(name)[0]
        tables = seqmodel_tables(name, leg_cfg, s_all)
        kernels[name] = halo_kernels(
            f"seqmodel-{name}",
            dict(N=batch * c.num_kv_heads // SEQMODEL_MESH[1],
                 G=c.num_heads // c.num_kv_heads, S=s_all // SEQMODEL_MESH[0],
                 hd=c.resolved_head_dim, block=c.spion.block_size),
            (tables["col_idx"][0].cpu().numpy(),
             tables["nvalid"][0].cpu().numpy()), tables["halo"], SEED + 28)
    c = get_config("whisper-tiny")
    col, nvalid = modelscan_plan(c, SEQMODEL_WHISPER_S)
    kernels["whisper6"] = path_kernels(
        "seqmodel-whisper6", dict(N=SCAN_WHISPER_BATCH * c.num_kv_heads,
                                  G=1, S=SEQMODEL_WHISPER_S,
                                  hd=c.resolved_head_dim,
                                  block=c.spion.block_size),
        (col[0], nvalid[0]), "12g's random layer-0", SEED + 29)
    zcfg = seqmodel_config("zamba2f")[0]
    col, nvalid = modelscan_plan(zcfg, SEQMODEL_ZAMBA_S)
    kernels["zamba2f"] = path_kernels(
        "seqmodel-zamba2f", dict(
            N=SEQMODEL_SCAN_BATCH * zcfg.num_kv_heads // SEQMODEL_FALLBACK,
            G=zcfg.num_heads // zcfg.num_kv_heads, S=SEQMODEL_ZAMBA_S,
            hd=zcfg.resolved_head_dim, block=zcfg.spion.block_size),
        (col[0], nvalid[0]), "12g's random application-0", SEED + 48)
    coll["kernels"] = pipe_kernels()
    serve = check_serving(recs, serve_secs)
    t_serve_kernels = time.perf_counter()
    cfg = serve_config("a")
    tables = serve_tables("a", cfg, prefill=True)
    kv = cfg.num_kv_heads // SEQMODEL_MESH[1]
    serve["kernels"] = halo_kernels(
        "serve-mesh", dict(N=SERVE_BATCH * kv,
                           G=cfg.num_heads // cfg.num_kv_heads,
                           S=SERVE_S // SEQMODEL_MESH[0],
                           hd=cfg.resolved_head_dim,
                           block=cfg.spion.block_size),
        (tables["col_idx"][0].cpu().numpy(),
         tables["nvalid"][0].cpu().numpy()), tables["halo"], SEED + 45)
    t_serve_kernels = time.perf_counter() - t_serve_kernels
    t_kernels = time.perf_counter() - t_kernels
    clock = stage_split(t_spawn, recs[0]["stages"], (
        ("lra", f"spion-lra's {SEQMODEL_LRA_STEPS} steps"),
        ("refs", "waiting for the references"),
        *((name, f"{name} fp32 steps") for name in SEQMODEL_LEGS),
        ("sync", "12i int8 syncs"), ("pipe", "12i pipeline"),
        ("serve", SERVE_STAGE)),
        start=START_STAGES[:5])
    clock["exit"] = wall - sum(clock.values())
    # 12j's own time: its legs on the ranks and its kernels here (its
    # references ran beside spion-lra's steps)
    serve["seconds"] = clock[SERVE_STAGE] + t_serve_kernels
    log(f"seq-model wall clock, rank 0, s: {fmt_split(clock)}; phases 12h, "
        f"12i and 12j {wall:.1f} s, of it the one-process references in "
        f"this process {t_ref:.1f} s (12i's {coll_secs:.1f}, 12j's "
        f"{sum(serve_secs.values()):.1f}), after them the kernels at the new "
        f"shapes {t_kernels:.1f} s (12j's {t_serve_kernels:.1f}); phase 12j "
        f"{serve['seconds']:.1f} s beside its references")
    return dict(seconds=wall + t_kernels, launches=launches,
                pipeline=coll, serve=serve,
                gap=gap, cap_gap=cap_gap, gaps=gaps,
                branch=lra[0]["branch"],
                faults={k: (v["loss_gap"], v["grad_rel"])
                        for k, v in faults.items()},
                peak_gb=[x["peak_gb"] for x in lra], kernels=kernels)


# -- phase 12j: prefill and decode steps under a mesh, on 12h's four ranks

SERVE_LAYERS = 2            # qwen2-7b at full width, 2 of its 28 layers
SERVE_BATCH = 2             # (a), (c)
SERVE_S = 4096              # (a): the prompt, over 'seq'
SERVE_ROW_STRIDE = 64       # (a): prefill logits' rows held (and the last)
SERVE_LONG_WINDOW = 512     # (b): each data rank's last positions gathered
SERVE_BF16_SLACK = 1.1      # bf16: of one process's distance from fp32
SERVE_DTYPES = ("float32", "bfloat16")
SERVE_STAGE = "12j serving legs"    # its ranks' stage in 12h's wall clock
# leg -> (mesh, batch, cache positions, positions filled before the decode
# (a: by the prefill, b and c: from the seed), decode steps a kind, KV heads)
SERVE_LEGS = {"a": ("seq_model", SERVE_BATCH, 4224, SERVE_S, 16, 4),
              "b": ("serve_data", 1, 524_288, 524_000, 8, 4),
              "c": ("fallback", SERVE_BATCH, 2176, 2048, 16, 2),
              "d": ("serve_data", SERVE_BATCH, 2176, 2048, 8, 4)}
# (d) decodes through a paged pool, replicated on every rank as the
# reference's cache_pspecs leave it (and, on the mesh, through the
# contiguous cache from the same start, which its mapped pages must equal)
SERVE_PAGED = ("d",)


def serve_config(leg, dtype="float32"):
    """12j's model: qwen2-7b at full width (d 3584, 28 heads, vocabulary
    152,064), SERVE_LAYERS of its 28 layers; leg (c) with 2 KV heads (no
    repo config has 2: the head_dim split of the cache), else its 4."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-7b")
    check(cfg.d_model == 3584 and cfg.num_heads == 28 and
          cfg.num_kv_heads == 4 and cfg.resolved_head_dim == 128 and
          cfg.vocab_size == 152_064 and cfg.spion.block_size == 128,
          "qwen2-7b config changed")
    return cfg.replace(num_layers=SERVE_LAYERS,
                       num_kv_heads=SERVE_LEGS[leg][5], dtype=dtype)


def serve_params(leg, dtype, mesh=None):
    """The leg's parameters on the card from its seed, fp32 drawn and cast
    to `dtype`'s model dtypes as `init` casts them: whole, or this rank's
    shards under `mesh` (the whole tree freed)."""
    import torch
    from repro_torch.distributed.sharding import param_pspecs, shard_params
    from repro_torch.launch.train import nest
    from repro_torch.models.layers import ParamTree
    from repro_torch.models.registry import build, params_specs
    cfg = serve_config(leg, dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 40)
    full = build(cfg.replace(dtype="float32")).init(gen, device=DEVICE)
    named = dict(full.named_parameters())
    if mesh is not None:
        named = shard_params(full, mesh, param_pspecs(full, mesh), cfg)
    del full
    dtypes = {n: p.dtype for n, p in params_specs(cfg).named_parameters()}
    return ParamTree(nest({n: x.to(dtypes[n]) for n, x in named.items()}))


def serve_tables(leg, cfg, prefill=False):
    """(a)'s prefill: the dry-run plan banded to halo (1, 0), on the card.
    Decode: each row-block lists the first 8 column blocks and its last 56
    (fewer below row 64), so the zero correction counts every position
    between them, and under (b)'s data split both ranks hold listed
    blocks."""
    import numpy as np
    import torch
    from repro_torch.launch.steps import spion_dryrun_tables
    if prefill:
        t = spion_dryrun_tables(cfg, SERVE_S, max_extent=1)
        return {k: torch.as_tensor(v, device=DEVICE)
                if isinstance(v, np.ndarray) else v for k, v in t.items()}
    nrb = SERVE_LEGS[leg][2] // cfg.spion.block_size
    r = np.arange(nrb)[:, None]
    cols = np.concatenate([np.broadcast_to(np.arange(8), (nrb, 8)),
                           r - 55 + np.arange(56)[None, :]], 1)
    nvalid = np.full(nrb, 64)
    low = r[:, 0] < 63
    cols[low] = np.minimum(np.arange(64)[None, :], r[low])
    nvalid[low] = r[low, 0] + 1
    stack = lambda a: torch.as_tensor(np.broadcast_to(
        a, (cfg.num_layers, *a.shape)).astype(np.int32).copy(), device=DEVICE)
    return {"col_idx": stack(cols), "nvalid": stack(nvalid)}


def serve_start_cache(leg, cfg, specs=None, mesh=None):
    """The cache the decode starts from: zeros for (a) (the prefill fills
    it), else K and V from the seed below the leg's filled position and
    zeros above it; whole, or this rank's shard under `specs` (each layer
    drawn whole, cut and freed)."""
    import torch
    from repro_torch.distributed.sharding import local_slices
    _, B, S, filled, _, KV = SERVE_LEGS[leg]
    hd, dt = cfg.resolved_head_dim, getattr(torch, cfg.dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 44)
    out = {}
    for name in ("k", "v"):
        layers = []
        for _ in range(cfg.num_layers):
            x = torch.zeros((B, S, KV, hd), device=DEVICE) if leg == "a" \
                else torch.randn((B, S, KV, hd), generator=gen,
                                 device=DEVICE)
            x[:, filled:] = 0
            if specs is not None:
                x = x[local_slices(mesh, specs[name][1:], x.shape)]
            layers.append(x.to(dt))
            del x
        out[name] = torch.stack(layers)
    return out


def serve_window(cache, leg, mesh=None):
    """(b)'s cache check: each data rank's last SERVE_LONG_WINDOW positions
    (on one process: the two windows side by side)."""
    W, S = SERVE_LONG_WINDOW, SERVE_LEGS[leg][2]
    if mesh is not None:
        return {k: v[:, :, -W:] for k, v in cache.items()}
    import torch
    return {k: torch.cat([v[:, :, S // 2 - W:S // 2], v[:, :, S - W:]], 2)
            for k, v in cache.items()}


def serve_pool(cfg, cache):
    """A whole contiguous cache {k, v} (L, B, S, KV, hd) as a paged pool of
    block-sized pages under a seeded shuffled page table (page 0 the
    scratch page)."""
    import numpy as np
    import torch
    from repro_torch.core.kv_pool import PagedKVCache
    k, v = cache["k"], cache["v"]
    L, B, S = k.shape[:3]
    page = cfg.spion.block_size
    NB = S // page
    perm = np.random.default_rng(SEED + 49).permutation(B * NB) + 1
    pt = torch.as_tensor(perm.reshape(B, NB).astype(np.int32), device=DEVICE)
    pools = []
    for x in (k, v):
        p = torch.zeros((L, 1 + B * NB, page, *x.shape[3:]), dtype=x.dtype,
                        device=DEVICE)
        p[:, pt.reshape(-1).long()] = x.reshape(L, B * NB, page,
                                                 *x.shape[3:])
        pools.append(p)
    return PagedKVCache(pools[0], pools[1], pt, page=page)


def pool_pages(pool):
    """The pool's mapped pages in the contiguous layout (L, B, S, KV, hd)."""
    B, NB = pool.pt.shape
    return {n: t[:, pool.pt.long()].reshape(t.shape[0], B, NB * pool.page,
                                            *t.shape[3:])
            for n, t in (("k", pool.kp), ("v", pool.vp))}


def serve_run(leg, dtype, mesh=None, specs=None):
    """One leg in one dtype: (a) the sparse prefill with the cache through
    make_prefill_step, then each leg's dense and sparse decode steps
    through make_serve_step, on `mesh` (this rank's shards; None: one
    process). Returns the logits it holds (the prefill's held rows, every
    step's) and the cache to check (whole, (b) its windows; gathered on a
    mesh), on the host in fp32, with times and launches."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import local_batch
    from repro_torch.distributed.sharding import gather_cache
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    cfg = serve_config(leg, dtype)
    _, B, S, filled, steps, _ = SERVE_LEGS[leg]
    params = serve_params(leg, dtype, mesh)
    cache = serve_start_cache(leg, cfg, specs, mesh)
    out, launches = {}, {k: 0 for k in KERNELS}
    if leg == "a":
        tabs = serve_tables(leg, cfg, prefill=True)
        rng = np.random.default_rng(SEED + 42)
        prompt = {"tokens": rng.integers(0, cfg.vocab_size, size=(
            B, SERVE_S)).astype(np.int64)}
        batch = local_batch(mesh, prompt, DEVICE) if mesh is not None else \
            {"tokens": torch.as_tensor(prompt["tokens"], device=DEVICE)}
        step = make_prefill_step(cfg, spion=True, with_cache=True, mesh=mesh,
                                 halo=tabs["halo"])
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, ks, vs = step(params, batch, tabs)
        torch.cuda.synchronize()
        out["prefill_ms"] = 1e3 * (time.perf_counter() - t)
        out["prefill_launches"] = launch_counts()
        for k in KERNELS:
            launches[k] += out["prefill_launches"][k]
        rows = list(range(0, SERVE_S, SERVE_ROW_STRIDE)) + [SERVE_S - 1]
        out["prefill"] = logits[:, rows].float().cpu()
        del logits
        cache["k"][:, :, :SERVE_S] = ks
        cache["v"][:, :, :SERVE_S] = vs
        del ks, vs
    rng = np.random.default_rng(SEED + 43 + ord(leg))
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(
        2 * steps, B, 1)).astype(np.int64), device=DEVICE)
    tabs = serve_tables(leg, cfg)
    if mesh is not None:
        # the tokens' rows a rank holds (batch_pspecs: over 'data' at B 2)
        from repro_torch.distributed.sharding import local_slices
        from repro_torch.launch.steps import batch_pspecs
        tspec = batch_pspecs(cfg, {"t": toks[0]}, mesh)["t"]
        toks = torch.stack([t[local_slices(mesh, tspec, t.shape)]
                            for t in toks])

    def decode(cache, specs):
        logits, ms = [], []
        reset_launch_counts()
        for kind in ("dense", "sparse"):
            serve = make_serve_step(cfg, spion=kind == "sparse", mesh=mesh,
                                    specs=specs)
            for i in range(steps):
                j = len(ms)
                args = (params, cache, toks[j], filled + j)
                torch.cuda.synchronize()
                t = time.perf_counter()
                lg, cache = serve(*args, tabs) if kind == "sparse" else \
                    serve(*args)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t))
                logits.append(lg.float().cpu())
        return cache, torch.stack(logits), ms, launch_counts()

    if leg in SERVE_PAGED:
        from repro_torch.launch.steps import cache_pspecs
        if mesh is not None:
            # the contiguous cache from the same start, on the same mesh
            c, out["contiguous_decode"], _, _ = decode(cache, specs)
            contiguous = {k: v.float().cpu() for k, v in
                          gather_cache(c, specs, mesh).items()}
            del c, cache
            cache = serve_start_cache(leg, cfg)
        pool = serve_pool(cfg, cache)
        del cache
        pspecs = None if mesh is None else cache_pspecs(cfg, pool, mesh, B)
        pool, out["decode"], out["decode_ms"], out["decode_launches"] = \
            decode(pool, pspecs)
        out["pool_digest"] = grads_hash({"kp": pool.kp, "vp": pool.vp})
        out["pool_specs"] = pspecs
        out["cache"] = {k: v.float().cpu()
                        for k, v in pool_pages(pool).items()}
        if mesh is not None:
            out["pool_vs_contiguous"] = {
                k: serve_gap(out["cache"][k], contiguous[k])
                for k in contiguous}
            out["pool_equals_contiguous"] = all(
                torch.equal(out["cache"][k], contiguous[k])
                for k in contiguous)
        out["launches"] = launches
        del params, pool
        return out
    cache, out["decode"], out["decode_ms"], out["decode_launches"] = \
        decode(cache, specs)
    check_cache = serve_window(cache, leg, mesh) if leg == "b" else cache
    if mesh is not None:
        check_cache = gather_cache(check_cache, specs, mesh)
    out["cache"] = {k: v.float().cpu() for k, v in check_cache.items()}
    out["launches"] = launches
    del params, cache, check_cache
    return out


def serve_references(d):
    """12j's one-process references, in this process before the ranks
    start, one leg and dtype at a time: DIR/serve_ref_<leg>_<dtype>.pt.
    Returns {leg: seconds}."""
    import gc
    import torch
    secs = {}
    for leg in SERVE_LEGS:
        t0 = time.perf_counter()
        for dtype in SERVE_DTYPES:
            torch.cuda.reset_peak_memory_stats()
            rec = serve_run(leg, dtype)
            rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            torch.save(rec, os.path.join(d, f"serve_ref_{leg}_{dtype}.pt"))
            del rec
            gc.collect()
            torch.cuda.empty_cache()
        secs[leg] = time.perf_counter() - t0
    return secs


def serve_gap(got, want):
    """max |got - want| over want's largest |element| (inf where `got` is
    not finite)."""
    import torch
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30))


def serve_legs(meshes, rank, d):
    """12j on one rank: each leg in fp32 and bf16 on its mesh, held against
    the parent's references (the rank's vocabulary shard of the logits;
    the cache gathered): fp32 gaps, bf16 distances from the fp32 reference
    (mean |difference|) beside one process's. Returns the rank's
    record."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.sharding import kernel_seq_axis, local_slices
    from repro_torch.launch.steps import batch_pspecs, cache_pspecs
    from repro_torch.models.registry import cache_specs
    rec = {}
    for leg, (mesh_name, B, S, filled, steps, _) in SERVE_LEGS.items():
        mesh = meshes[mesh_name]
        cfg = serve_config(leg)
        specs = cache_pspecs(cfg, cache_specs(cfg, B, S), mesh, B)
        m, mi = mesh.shape.get("model", 1), mesh.axis_index("model")
        V = cfg.vocab_size // m
        vocab = slice(mi * V, (mi + 1) * V)
        # the logits' rows a rank holds: the batch over 'data' at B 2 (d)
        rows = local_slices(mesh, batch_pspecs(
            cfg, {"t": torch.empty((B, 1), device="meta")}, mesh)["t"],
            (B, 1))[0]
        refs = {dt: torch.load(os.path.join(d, f"serve_ref_{leg}_{dt}.pt"))
                for dt in SERVE_DTYPES}
        legrec = {"specs": {k: [list(e) if isinstance(e, tuple) else e
                                for e in v] for k, v in specs.items()}}
        if leg == "a":
            axis, reason = kernel_seq_axis(
                mesh, SERVE_S // cfg.spion.block_size,
                serve_tables(leg, cfg, prefill=True)["halo"])
            legrec["halo_path"] = [axis, reason]
        for dtype in SERVE_DTYPES:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            run = serve_run(leg, dtype, mesh, specs)
            secs = time.perf_counter() - t0
            r32, rdt = refs["float32"], refs[dtype]
            got = {"decode": run["decode"]}
            want = {"decode": r32["decode"][:, rows, vocab]}
            one = {"decode": rdt["decode"][:, rows, vocab]}
            if "prefill" in run:
                got["prefill"] = run["prefill"]
                want["prefill"] = r32["prefill"][..., vocab]
                one["prefill"] = rdt["prefill"][..., vocab]
            for k in run["cache"]:
                got[f"cache_{k}"] = run["cache"][k]
                want[f"cache_{k}"] = r32["cache"][k]
                one[f"cache_{k}"] = rdt["cache"][k]
            x = {"seconds": secs,
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                 "decode_ms": run["decode_ms"],
                 "paged": {k: run[k] for k in (
                     "pool_digest", "pool_vs_contiguous",
                     "pool_equals_contiguous", "pool_specs") if k in run},
                 "prefill_ms": run.get("prefill_ms"),
                 "prefill_launches": run.get("prefill_launches"),
                 "decode_launches": run["decode_launches"],
                 "launches": run["launches"],
                 "ref_peak_gb": rdt["peak_gb"]}
            if dtype == "float32":
                x["gaps"] = {k: serve_gap(got[k], want[k]) for k in got}
            else:
                x["dist"] = {k: float((got[k] - want[k]).abs().mean())
                             for k in got}
                x["dist_one"] = {k: float((one[k] - want[k]).abs().mean())
                                 for k in got}
            # copies only: the seeded positions the decode never wrote
            if leg != "a":
                for k in ("k", "v"):
                    c, w = run["cache"][k], rdt["cache"][k]
                    # (b): the first window whole, the second below filled
                    W = SERVE_LONG_WINDOW
                    keep = slice(0, W + filled - (S - W) if leg == "b"
                                 else filled)
                    x.setdefault("bitwise", {})[k] = bool(torch.equal(
                        c[:, :, keep], w[:, :, keep]))
            legrec[dtype] = x
            del run, got, want, one
            gc.collect()
            torch.cuda.empty_cache()
        rec[leg] = legrec
        del refs
        gc.collect()
        dist.barrier(group=mesh.group(mesh.axis_names))
    return rec


def serve_paged_what(legs, B, filled):
    """The log's description of a paged leg: its layout, whether its pools
    are bitwise equal across the ranks, and its mapped pages against the
    contiguous cache decoded from the same start on the same mesh."""
    x0 = legs[0]
    same = all(lr[dt]["paged"]["pool_digest"] ==
               x0[dt]["paged"]["pool_digest"]
               for lr in legs for dt in SERVE_DTYPES)
    return (f"data 2 x model 2, B {B}, a paged pool replicated on every "
            f"rank (pages of {serve_config('d').spion.block_size} under a "
            f"shuffled page table; every row's and KV head's new K/V "
            f"gathered before each rank writes it), filled below {filled}; "
            f"its pools "
            f"{'bitwise equal across the ranks' if same else 'APART'}"
            f", its mapped pages vs the contiguous cache from the same start "
            f"on the same mesh: " + "; ".join(
                f"{dt} " + ", ".join(
                    f"{k} {g:.3e}" for k, g in
                    x0[dt]["paged"]["pool_vs_contiguous"].items())
                + (" (bitwise)" if x0[dt]["paged"]["pool_equals_contiguous"]
                   else "")
                for dt in SERVE_DTYPES))


def check_serving(recs, ref_secs):
    """12j's gates on the ranks' records: the halo path for (a)'s prefill;
    every fp32 gap within TOL_SEQ_LOSS of the reference's largest element;
    every bf16 distance from the fp32 reference within SERVE_BF16_SLACK of
    one process's; the seeded cache positions bitwise one process's; the
    sparse prefill's launches SERVE_LAYERS forward kernels a rank and dtype,
    the decode none. Returns the phase's record."""
    import numpy as np
    card = card_line()
    launches = {k: 0 for k in KERNELS}
    gaps, ratios = {}, {}
    for leg, (mesh_name, B, S, filled, steps, KV) in SERVE_LEGS.items():
        legs = [rec["serve"][leg] for rec in recs]
        if leg == "a":
            check(legs[0]["halo_path"][0] == "seq",
                  f"12j (a): the prefill plan does not take the halo path: "
                  f"{legs[0]['halo_path']}")
        want_l = {k: SERVE_LAYERS if k == "block_sparse_fwd" else 0
                  for k in KERNELS}
        for r, lr in enumerate(legs):
            for dtype in SERVE_DTYPES:
                x = lr[dtype]
                if leg == "a":
                    check(x["prefill_launches"] == want_l,
                          f"12j (a) rank {r} {dtype}: the prefill launched "
                          f"{x['prefill_launches']}, not {want_l}")
                if leg in SERVE_PAGED:
                    pg = x["paged"]
                    check(all(e == [] for e in pg["pool_specs"].values()),
                          f"12j ({leg}): the pool's specs {pg['pool_specs']}")
                    check(pg["pool_digest"] ==
                          legs[0][dtype]["paged"]["pool_digest"],
                          f"12j ({leg}) rank {r} {dtype}: its pool differs "
                          f"from rank 0's")
                    worst = max(pg["pool_vs_contiguous"].values())
                    check(dtype != "float32" or worst <= TOL_SEQ_LOSS,
                          f"12j ({leg}) rank {r}: the pool's mapped pages "
                          f"{worst:.3e} from the contiguous leg's cache; "
                          f"gate {TOL_SEQ_LOSS}")
                check(not any(x["decode_launches"].values()),
                      f"12j ({leg}) rank {r} {dtype}: the decode launched "
                      f"{x['decode_launches']}")
                for k in KERNELS:
                    launches[k] += x["launches"][k]
                check(all(x.get("bitwise", {}).values()),
                      f"12j ({leg}) rank {r} {dtype}: the seeded cache "
                      f"positions differ from one process's")
            for k, g in lr["float32"]["gaps"].items():
                gaps[f"{leg} {k}"] = max(gaps.get(f"{leg} {k}", 0.0), g)
                check(g <= TOL_SEQ_LOSS, f"12j ({leg}) rank {r}: fp32 {k} "
                      f"{g:.3e} of the reference's largest; gate "
                      f"{TOL_SEQ_LOSS}")
            x = lr["bfloat16"]
            for k, dist_ in x["dist"].items():
                one = x["dist_one"][k]
                ratios[f"{leg} {k}"] = max(ratios.get(f"{leg} {k}", 0.0),
                                           dist_ / one if one else 0.0)
                check(dist_ <= SERVE_BF16_SLACK * one,
                      f"12j ({leg}) rank {r}: bf16 {k} {dist_:.3e} from the "
                      f"fp32 reference, one process {one:.3e}; slack "
                      f"{SERVE_BF16_SLACK}")
        x0 = legs[0]
        what = serve_paged_what(legs, B, filled) if leg in SERVE_PAGED \
            else {"a": f"seq {SEQMODEL_MESH[0]} x model {SEQMODEL_MESH[1]}, "
                       f"B {B}, a {SERVE_S}-token prompt, a causal plan "
                       f"banded to halo (1, 0)",
                  "b": f"data 2 x model 2, B 1, the cache's {S} positions "
                       f"over 'data' and its KV heads over 'model', filled "
                       f"from the seed below {filled}",
                  "c": f"model {SEQMODEL_FALLBACK}, 2 KV heads (head_dim "
                       f"over 'model'), B {B}, filled below {filled}"}[leg]
        log(f"serve-mesh ({leg}) qwen2-7b reduced to {SERVE_LAYERS} of 28 "
            f"layers at full width, {what}; cache specs "
            f"{x0['specs']['k']}; " + "; ".join(
                f"{dtype}: " + (", ".join(
                    f"{k} {g:.3e}" for k, g in x0[dtype]["gaps"].items())
                    + f" of the largest (gate {TOL_SEQ_LOSS})"
                    if dtype == "float32" else ", ".join(
                        f"{k} {x0[dtype]['dist'][k]:.3e} vs one process "
                        f"{x0[dtype]['dist_one'][k]:.3e}"
                        for k in x0[dtype]["dist"])
                    + f" mean |x - fp32| (slack {SERVE_BF16_SLACK})")
                + (f", prefill {x0[dtype]['prefill_ms']:.1f} ms"
                   if x0[dtype]["prefill_ms"] else "")
                + f", decode {np.median(x0[dtype]['decode_ms']):.2f} ms a "
                f"token (median of {len(x0[dtype]['decode_ms'])}; "
                f"{steps} dense, {steps} sparse)"
                f", peak {x0[dtype]['peak_gb']:.2f} GB a rank (one process "
                f"{x0[dtype]['ref_peak_gb']:.2f})"
                for dtype in SERVE_DTYPES)
            + f"; one-process references {ref_secs[leg]:.1f} s ({card})")
        for r, lr in enumerate(legs):
            log(f"serve-mesh ({leg}) rank {r}: " + "; ".join(
                f"{dtype} {lr[dtype]['seconds']:.1f} s, decode ms a token "
                f"median {np.median(lr[dtype]['decode_ms'][:steps]):.2f} "
                f"(dense) / "
                f"{np.median(lr[dtype]['decode_ms'][steps:]):.2f} (sparse)"
                + (f", prefill {lr[dtype]['prefill_ms']:.1f} ms"
                   if lr[dtype]["prefill_ms"] else "")
                for dtype in SERVE_DTYPES) + f" ({card})")
    return dict(launches=launches, gaps=gaps, ratios=ratios)


# -- phase 12i: the explicit collectives (int8 and hierarchical gradient
# sync, the GPipe pipeline), on 12h's four ranks

SYNC_MESH = ((2, 2), ("pod", "data"))   # 12i (a)
PIPE_MESH = ((4,), ("pod",))            # 12i (b): spion-lra's 4 layers
PIPE_BATCH = 32                 # sequences of 2048 positions
PIPE_MICRO = 4                  # microbatches of 8
PIPE_TIMED = 3                  # bf16 calls timed after the gated ones
PIPE_SLACK = 1.1                # bf16: the covering rule's slack
SYNC_KINDS = ("data", "poddata", "hier")
# planted (fp32): the output's cotangent summed over the line, stage 2
# sending zeros in place of its input's gradient
PIPE_FAULTS = ("cotangent_summed", "no_dx_send")


def tensor_digest(tree):
    """sha256 of a {name: tensor} tree's bytes, leaves in name order."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for n in sorted(tree):
        t = tree[n].detach().reshape(-1).contiguous().cpu()
        h.update(n.encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:32]


def sync_shapes():
    """{leaf: shape} of spion-lra's masters at phase 5's configuration: the
    gradient tree 12i (a) syncs."""
    import torch
    from repro_torch.models.registry import build
    cfg, _ = lra_config()
    return {n: tuple(p.shape) for n, p in build(cfg).init(
        torch.Generator().manual_seed(0), device="cpu").named_parameters()}


def sync_tree(rank, shapes):
    """Rank `rank`'s partial gradients: seeded normals in each leaf's shape,
    scaled by 10^-(i mod 4) and by rank + 1, fp32 numpy."""
    import numpy as np
    out = {}
    for i, (n, shp) in enumerate(sorted(shapes.items())):
        rng = np.random.default_rng([SEED + 30, rank, i])
        out[n] = (rng.standard_normal(shp) * 10.0 ** -(i % 4)
                  * (rank + 1)).astype(np.float32)
    return out


def np_quantize(x):
    """quantize_int8's arithmetic in numpy float32."""
    import numpy as np
    amax = np.max(np.abs(x))
    scale = np.float32(amax / np.float32(127.0)) if amax > 0 \
        else np.float32(1.0)
    return np.clip(np.round(x / scale), -127, 127).astype(np.int8), scale


def as_dtype(a, dtype):
    """float32 numpy -> a CPU tensor of `dtype` (round to nearest even)."""
    import torch
    return torch.from_numpy(a).to(getattr(torch, dtype))


def sync_reference(trees, line, dtype):
    """The reference's compressed_psum over the ranks `line` (in the line's
    order) of each rank's float32 tree: ({leaf: int32 total}, [mean scale
    by leaf in name order], {leaf: result tensor of `dtype`})."""
    import numpy as np
    totals, means, outs = {}, [], {}
    for n in sorted(trees[line[0]]):
        qs, ss = zip(*(np_quantize(trees[r][n]) for r in line))
        total = qs[0].astype(np.int32)
        for q in qs[1:]:
            total = total + q.astype(np.int32)
        s = ss[0]
        for x in ss[1:]:
            s = np.float32(s + x)
        s = np.float32(s / np.float32(len(line)))
        totals[n], outs[n] = total, as_dtype(total.astype(np.float32) * s,
                                             dtype)
        means.append(float(s))
    return totals, means, outs


def sync_references(d):
    """12i (a)'s expected bits, computed on the CPU while the ranks run
    spion-lra: per dtype and rank, the digests of its q and its scales, and per sync
    kind the digests of the int32 totals and of the result and the mean
    scales (DIR/ref_12i_sync.json)."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    shapes = sync_shapes()
    (rows, cols), _ = SYNC_MESH
    grid = np.arange(rows * cols).reshape(rows, cols)
    ref = {"elements": sum(int(np.prod(s)) for s in shapes.values())}
    for dtype in ("float32", "bfloat16"):
        # the rank's tree as its dtype holds it
        trees = {r: {n: as_dtype(a, dtype).float().numpy() for n, a in
                     sync_tree(r, shapes).items()} for r in range(grid.size)}
        # the hierarchical sum's pod step reads each data line's fp32 sum
        data_sum = {int(r): {n: as_dtype(trees[grid[p, 0]][n]
                                         + trees[grid[p, 1]][n],
                                         dtype).float().numpy()
                             for n in trees[0]}
                    for p in range(rows) for r in grid[p]}
        per = {}
        for r in range(grid.size):
            p, j = divmod(r, cols)
            names = sorted(trees[r])
            q, s = zip(*(np_quantize(trees[r][n]) for n in names))
            rec = {"q": tensor_digest({n: torch.from_numpy(x) for n, x in
                                       zip(names, q)}),
                   "scales": [float(x) for x in s]}
            for kind, line, src in (("data", grid[p], trees),
                                    ("poddata", grid.reshape(-1), trees),
                                    ("hier", grid[:, j], data_sum)):
                totals, means, outs = sync_reference(
                    src, [int(x) for x in line], dtype)
                rec[kind] = {
                    "totals": tensor_digest({n: torch.from_numpy(v) for n, v
                                             in totals.items()}),
                    "mean": means, "out": tensor_digest(outs)}
            per[r] = rec
        ref[dtype] = per
    ref["seconds"] = time.perf_counter() - t0
    with open(os.path.join(d, "ref_12i_sync.json"), "w") as f:
        json.dump(ref, f)
    return ref["seconds"]


def sync_parts(tree, group):
    """This rank's steps of compressed_psum on `tree` over `group`, taken
    one by one through the functions it calls (quantize_int8,
    runtime.all_reduce_sum of the int32 payloads, line_mean of the
    scales): (q digest, scales, totals digest, mean scales)."""
    import torch
    from repro_torch.distributed import runtime
    from repro_torch.optim.grad import line_mean, quantize_int8
    names = sorted(tree)
    q, s = zip(*(quantize_int8(tree[n]) for n in names))
    totals = runtime.all_reduce_sum([x.to(torch.int32) for x in q],
                                    group=group)
    mean = line_mean(torch.stack(s), group)
    return (tensor_digest(dict(zip(names, q))), [float(x) for x in s],
            tensor_digest(dict(zip(names, totals))),
            [float(x) for x in mean.cpu()])


def sync_leg(mesh, rank):
    """12i (a) on one rank of (pod 2, data 2): its tree of spion-lra's
    leaves in fp32 and in bf16 through compressed_grad_sync over 'data'
    and over ('pod', 'data') and hierarchical_grad_sync, each step's bits
    digested (sync_parts; the hierarchical sum's pod step on the data
    line's fp32 sum), each sync timed beside runtime.all_reduce_sum of the
    same tree over the same group; then the reference test's 0.25 cases
    and the scales summed instead of averaged (planted)."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import runtime
    from repro_torch.distributed.collectives import (compressed_grad_sync,
                                                     hierarchical_grad_sync)
    from repro_torch.optim import grad as grad_mod
    shapes = sync_shapes()
    groups = {"data": mesh.group("data"),
              "poddata": mesh.group(("pod", "data")),
              "hier": mesh.group("pod")}
    run = {
        "data": lambda t: compressed_grad_sync(mesh, t),
        "poddata": lambda t: compressed_grad_sync(mesh, t,
                                                  axes=("pod", "data")),
        "hier": lambda t: hierarchical_grad_sync(mesh, t)}
    out = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        tree = {n: torch.from_numpy(a).to(DEVICE).to(dt)
                for n, a in sync_tree(rank, shapes).items()}
        rec = {}
        for kind in SYNC_KINDS:
            src = tree
            if kind == "hier":
                sums = runtime.all_reduce_sum(
                    [tree[n].to(torch.float32, copy=True) for n in
                     sorted(tree)], group=groups["data"])
                src = {n: s.to(dt) for n, s in zip(sorted(tree), sums)}
            q, scales, totals, mean = sync_parts(src, groups[kind])
            if kind == "data":
                rec["q"], rec["scales"] = q, scales
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            synced = run[kind](tree)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            plain = [tree[n].to(torch.float32, copy=True) for n in
                     sorted(tree)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runtime.all_reduce_sum(
                plain, group=groups["poddata" if kind == "hier" else kind])
            torch.cuda.synchronize()
            rec[kind] = {"totals": totals, "mean": mean,
                         "out": tensor_digest(synced), "ms": ms,
                         "plain_ms": 1e3 * (time.perf_counter() - t0)}
        out[dtype] = rec
    quarter = {"w": torch.full((8, 8), 0.25, device=DEVICE)}
    out["quarter"] = {k: float(run[k](quarter)["w"].max()) for k in
                      ("data", "hier")}
    sound = grad_mod.line_mean
    grad_mod.line_mean = lambda v, group: sound(v, group) * (
        1 if group is None else dist.get_world_size(group))
    try:
        out["quarter"]["planted_scales"] = float(
            run["data"](quarter)["w"].max())
    finally:
        grad_mod.line_mean = sound
    return out


def pipe_plan(cfg, S):
    """12i (b)'s seeded non-causal random plan over S positions: one block
    mask a layer, (col_idx (L, nrb, K) edge-padded to the widest layer,
    nvalid (L, nrb)) numpy."""
    import numpy as np
    block = cfg.spion.block_size
    rng = np.random.default_rng(SEED + 31)
    tabs = [random_tables(rng, S // block, S // block, causal=False, pad=0)
            for _ in range(cfg.num_layers)]
    K = max(c.shape[1] for c, _ in tabs)
    col = np.stack([np.pad(c, ((0, 0), (0, K - c.shape[1])), mode="edge")
                    for c, _ in tabs])
    return col, np.stack([n for _, n in tabs])


def pipe_kernels():
    """The three kernels at a pipeline stage's microbatch shape
    (PIPE_BATCH // PIPE_MICRO sequences x spion-lra's 4 heads, 2048
    positions, hd 16, block 64, non-causal) on every stage's tables of
    pipe_plan: against their plain versions in fp32 and bf16, then timed.
    Returns stage 0's records, each error the worst over the stages."""
    cfg, task = lra_config()
    S = task["seq_len"]
    col, nvalid = pipe_plan(cfg, S)
    shape = dict(N=PIPE_BATCH // PIPE_MICRO * cfg.num_kv_heads,
                 G=cfg.num_heads // cfg.num_kv_heads, S=S,
                 hd=cfg.resolved_head_dim, block=cfg.spion.block_size)
    recs = [path_kernels("pipeline", shape, (col[s], nvalid[s]),
                         f"stage {s}'s seeded", SEED + 33 + s, causal=False)
            for s in range(cfg.num_layers)]
    out = recs[0]
    for name, rec in out.items():
        for k in ("max_abs_err", "max_abs_err_fp32"):
            rec[k] = max(r[name][k] for r in recs)
    return out


def pipe_inputs(dtype):
    """12i (b)'s inputs on the card, the same on every rank and in the
    parent: spion-lra's fp32 masters (phase 5's configuration, seeded), a
    seeded non-causal random plan of one block mask a layer at the
    training shape (2048 positions, block 64), the exec of it, and x and
    the output's cotangent (PIPE_BATCH, 2048, d_model) of `dtype`."""
    import torch
    from repro_torch.core.attention_exec import SparseAttentionExec
    from repro_torch.core.sparse_attention import build_sparsity_plan
    cfg, task = lra_config()
    S, block = task["seq_len"], cfg.spion.block_size
    check(S == 2048 and block == 64 and cfg.d_model == 64 and
          cfg.num_heads == 4 and cfg.resolved_head_dim == 16,
          "12i: spion-lra's training shape changed")
    masters = seqmodel_masters(cfg)
    col, nvalid = pipe_plan(cfg, S)
    ex = SparseAttentionExec.from_plan(
        build_sparsity_plan(col, nvalid, block),
        dtype=getattr(torch, dtype)).to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 32)
    x = torch.randn((PIPE_BATCH, S, cfg.d_model), generator=gen,
                    device=DEVICE)
    cot = torch.randn((PIPE_BATCH, S, cfg.d_model), generator=gen,
                      device=DEVICE)
    dt = getattr(torch, dtype)
    return cfg.replace(dtype=dtype), masters, ex, x.to(dt), cot.to(dt)


def pipe_stage_fn(cfg, ex, layer):
    """stage_fn of spion-lra's layer `layer`: models/transformer._block on
    the layer's leaves cast to the run's dtype (as compute_params casts
    the stacked masters), its sparse attention through the layer's tables
    of `ex` (the Hopper kernels on the card)."""
    import torch
    from repro_torch.models.layers import tree_map
    from repro_torch.models.transformer import _block
    dt = getattr(torch, cfg.dtype)
    sp = {k: t[layer] for k, t in ex.scan_tables().items()}

    def stage_fn(lp, h):
        pos = torch.arange(h.shape[1], device=h.device)
        return _block(cfg, tree_map(lambda v: v.to(dt), lp), h, pos, pos,
                      ex, sp)[0]
    return stage_fn


def layer_leaves(masters, layer):
    """Layer `layer`'s fp32 master leaves as tensors of their own that
    require grad ({flat name: tensor})."""
    from repro_torch.models.layers import layer_view, tree_map
    return tree_map(lambda v: v.detach().clone().requires_grad_(),
                    layer_view(masters["layers"], layer))


def flat_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def pipe_references(d):
    """12i (b)'s one-process reference, while the ranks run 12h's
    spion-lra: spion-lra's 4 layers in sequence on the whole batch (the same microbatches, kept
    together), fp32 and bf16, from the same masters and inputs: the fp32
    output, dx and each layer's gradients to DIR/ref_12i_pipe.pt, and the
    bf16 run's distances from them (pipe_distance) to
    DIR/ref_12i_pipe.json. Returns seconds."""
    import torch
    t0 = time.perf_counter()
    runs = {}
    for dtype in ("float32", "bfloat16"):
        cfg, masters, ex, x, cot = pipe_inputs(dtype)
        layers = [layer_leaves(masters, s) for s in range(cfg.num_layers)]
        xt = x.clone().requires_grad_()
        h = xt
        for s in range(cfg.num_layers):
            h = pipe_stage_fn(cfg, ex, s)(layers[s], h)
        h.backward(cot)
        runs[dtype] = {"out": h.detach().float(), "dx": xt.grad.float(),
                       "g": [{k: v.grad for k, v in
                              flat_leaves(layers[s]).items()}
                             for s in range(cfg.num_layers)]}
        del masters, ex, x, cot, layers, xt, h
    ref = runs["float32"]
    torch.save({k: ([{n: g.cpu() for n, g in gs.items()} for gs in v]
                    if k == "g" else v.cpu()) for k, v in ref.items()},
               os.path.join(d, "ref_12i_pipe.pt"))
    dist16 = [pipe_distance(runs["bfloat16"], ref, s)
              for s in range(len(ref["g"]))]
    del runs
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    with open(os.path.join(d, "ref_12i_pipe.json"), "w") as f:
        json.dump({"bf16_seq": dist16, "seconds": secs}, f)
    return secs


def pipe_distance(run, ref, stage):
    """The mean |difference| of a run's output and dx from the fp32
    reference's, and of stage `stage`'s gradients, each leaf over its fp32
    largest |element|, taken together."""
    import torch

    def mean(a, b):
        return float((a.float() - b.to(a.device)).abs().mean())
    gs = [((run["g"][stage][n].float() - g.to(DEVICE)).abs()
           / max(g.abs().max().item(), 1e-30)).reshape(-1)
          for n, g in ref["g"][stage].items()]
    return {"out": mean(run["out"], ref["out"]),
            "dx": mean(run["dx"], ref["dx"]),
            "grads": float(torch.cat(gs).mean())}


def pipe_gaps(run, ref, stage):
    """The fp32 gates' readings: the largest |difference| of the output, dx
    and each of stage `stage`'s gradients over the reference's largest
    |element| of it; (out, dx, worst leaf's gap, worst leaf)."""
    def rel(a, b):
        b = b.to(DEVICE)
        return float((a.float() - b).abs().max()) / max(
            float(b.abs().max()), 1e-30)
    leaf = {n: rel(run["g"][stage][n], g) for n, g in
            ref["g"][stage].items()}
    worst = max(leaf, key=leaf.get)
    return {"out": rel(run["out"], ref["out"]),
            "dx": rel(run["dx"], ref["dx"]), "grad": leaf[worst],
            "worst_leaf": worst}


class _SumOverLine:
    """12i's planted cotangent fault: identity forward, the cotangent
    summed over the line in the backward (so the last stage takes |line|
    times its own)."""

    @staticmethod
    def make(group):
        import torch
        import torch.distributed as dist

        class Sum(torch.autograd.Function):
            @staticmethod
            def forward(ctx, y):
                return y.clone()

            @staticmethod
            def backward(ctx, g):
                g = g.clone()
                dist.all_reduce(g, group=group)
                return g
        return Sum.apply


def pipe_leg(mesh, rank, d):
    """12i (b) on one rank of (pod 4): stage `rank` of spion-lra's 4
    layers under pipeline_apply, PIPE_MICRO microbatches of PIPE_BATCH,
    fp32 (against the parent's sequential run: gaps), the planted faults
    (fp32), bf16 (distances from the fp32 reference), then PIPE_TIMED bf16
    calls timed: ms a call, of it the hops', the launches of every call and
    the peak."""
    import gc
    import torch
    from repro_torch.distributed import pipeline
    ref = torch.load(os.path.join(d, "ref_12i_pipe.pt"))
    stage = mesh.axis_index("pod")
    out = {"stage": stage, "runs": {}, "launches": [], "ms": [],
           "hop_ms": []}
    torch.cuda.reset_peak_memory_stats()
    plan = [("float32", None)] + [("float32", f) for f in PIPE_FAULTS] + \
        [("bfloat16", None)] * (1 + PIPE_TIMED)
    sound_backward = pipeline.stage_backward
    for i, (dtype, fault) in enumerate(plan):
        cfg, masters, ex, x, cot = pipe_inputs(dtype)
        lp = layer_leaves(masters, stage)
        xt = x.clone().requires_grad_()
        if fault == "no_dx_send":
            def zero_dx(*a, **kw):
                da, grads = sound_backward(*a, **kw)
                return (torch.zeros_like(da) if stage == 2 else da), grads
            pipeline.stage_backward = zero_dx
        try:
            reset_launch_counts()
            h0 = pipeline.hop_seconds
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = pipeline.pipeline_apply(mesh, "pod",
                                        pipe_stage_fn(cfg, ex, stage), lp,
                                        xt, PIPE_MICRO)
            if fault == "cotangent_summed":
                y = _SumOverLine.make(mesh.group("pod"))(y)
            y.backward(cot)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        finally:
            pipeline.stage_backward = sound_backward
        run = {"out": y.detach(), "dx": xt.grad,
               "g": {stage: {k: v.grad for k, v in flat_leaves(lp).items()}}}
        if fault is None:
            out["launches"].append(launch_counts())
            out["ms"].append(ms)
            out["hop_ms"].append(1e3 * (pipeline.hop_seconds - h0))
        if i < len(plan) - PIPE_TIMED:
            key = dtype if fault is None else f"planted {fault}"
            reading = pipe_gaps if dtype == "float32" else pipe_distance
            out["runs"][key] = reading(run, ref, stage)
        del cfg, masters, ex, x, cot, lp, xt, y, run
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pipe_launches():
    """Kernel launches of one pipeline call on one stage: the forward wave
    runs the forward kernel once a microbatch; the backward recomputes the
    stage (forward again) and runs dQ and dK/dV once a microbatch."""
    return {"block_sparse_fwd": 2 * PIPE_MICRO,
            "block_sparse_dq": PIPE_MICRO, "block_sparse_dkv": PIPE_MICRO}


def check_collectives(recs, d, ref_secs):
    """12i's gates in the parent on the ranks' records; returns the
    pipeline's launches (the sound calls of every rank) and readings."""
    import numpy as np
    with open(os.path.join(d, "ref_12i_sync.json")) as f:
        sref = json.load(f)
    with open(os.path.join(d, "ref_12i_pipe.json")) as f:
        pref = json.load(f)
    card = card_line()
    # (a) bitwise against the parent's CPU arithmetic
    for r, rec in enumerate(recs):
        sync = rec["sync"]
        for dtype in ("float32", "bfloat16"):
            want, got = sref[dtype][str(r)], sync[dtype]
            check(got["q"] == want["q"] and got["scales"] == want["scales"],
                  f"12i: rank {r}'s {dtype} q or scales differ from the "
                  f"CPU's")
            for kind in SYNC_KINDS:
                for part in ("totals", "mean", "out"):
                    check(got[kind][part] == want[kind][part],
                          f"12i: rank {r}'s {dtype} {kind} {part} differs "
                          f"from the CPU's arithmetic")
        q = sync["quarter"]
        check(abs(q["data"] - 0.5) < 0.01 and abs(q["hier"] - 1.0) < 0.02,
              f"12i: rank {r}'s 0.25 cases read {q}")
        check(abs(q["planted_scales"] - 0.5) > 0.01,
              f"12i: the summed scales pass the 0.5 gate: {q}")
    q = recs[0]["sync"]["quarter"]
    log(f"collectives (a) int8 gradient sync: {SYNC_MESH[0][0]} pods x "
        f"{SYNC_MESH[0][1]} data ranks sharing the card (gloo, "
        f"host-staged), spion-lra's gradient tree ({sref['elements']} "
        f"elements, seeded, x (rank + 1)) in fp32 and bf16: q, scales, int32 "
        f"totals, mean scales (summed in the line's rank order: bitwise, no "
        f"ulp) and results bitwise the CPU's arithmetic on every rank; 0.25 "
        f"syncs to {q['data']} over 'data', {q['hier']} hierarchically; "
        f"scales summed (planted) {q['planted_scales']} (gate 0.5 +- 0.01); "
        f"the CPU reference {sref['seconds']:.1f} s")
    for r, rec in enumerate(recs):
        log(f"collectives (a) rank {r} ms, sync / runtime.all_reduce_sum of "
            f"the same tree in fp32 (4 bytes an element either way): "
            + "; ".join(f"{dtype} " + ", ".join(
                f"{k} {rec['sync'][dtype][k]['ms']:.2f} / "
                f"{rec['sync'][dtype][k]['plain_ms']:.2f}"
                for k in SYNC_KINDS) for dtype in ("float32", "bfloat16"))
            + f" ({card})")
    # (b) the pipeline
    cfg, _ = lra_config()
    want = pipe_launches()
    launches = {k: 0 for k in KERNELS}
    faults = {}
    for r, rec in enumerate(recs):
        pipe = rec["pipe"]
        for ln in pipe["launches"]:
            check(ln == want, f"12i: stage {pipe['stage']}'s call launched "
                  f"{ln}, not {want}")
            for k in KERNELS:
                launches[k] += ln[k]
        g = pipe["runs"]["float32"]
        check(g["out"] <= TOL_SEQ_LOSS and g["dx"] <= TOL_SEQ_GRAD and
              g["grad"] <= TOL_SEQ_GRAD,
              f"12i: stage {pipe['stage']}'s fp32 pipeline misses one "
              f"process's: {g}")
        b, s = pipe["runs"]["bfloat16"], pref["bf16_seq"][pipe["stage"]]
        for k in ("out", "dx", "grads"):
            check(b[k] <= PIPE_SLACK * s[k],
                  f"12i: stage {pipe['stage']}'s bf16 {k} is {b[k]} from the "
                  f"fp32 reference, the sequential bf16 {s[k]}")
        for f in PIPE_FAULTS:
            x = pipe["runs"][f"planted {f}"]
            faults[f] = max(faults.get(f, 0.0), x["dx"], x["grad"])
    for f, gap in faults.items():
        log(f"collectives (b) planted {f}: worst dx or gradient gap "
            f"{gap:.3e} -> {'misses' if gap > TOL_SEQ_GRAD else 'PASSES'} "
            f"the gate {TOL_SEQ_GRAD}")
        check(gap > TOL_SEQ_GRAD, f"12i: the planted {f} passes the gate")
    p0 = [rec["pipe"] for rec in recs]
    log(f"collectives (b) GPipe: spion-lra's {cfg.num_layers} layers as "
        f"{len(p0)} stages on pod {len(p0)} (gloo, host-staged hops), batch "
        f"{PIPE_BATCH} x {lra_config()[1]['seq_len']} in {PIPE_MICRO} "
        f"microbatches, a seeded "
        f"non-causal plan through the kernels; fp32 against the layers in "
        f"sequence in one process: "
        + "; ".join(f"stage {p['stage']} out {p['runs']['float32']['out']:.3e}"
                    f" dx {p['runs']['float32']['dx']:.3e} worst leaf "
                    f"{p['runs']['float32']['worst_leaf']} "
                    f"{p['runs']['float32']['grad']:.3e}" for p in p0)
        + f" (gates {TOL_SEQ_LOSS}, {TOL_SEQ_GRAD}); bf16 mean distance from "
        f"the fp32 reference, pipeline / sequential (gate x{PIPE_SLACK}): "
        + "; ".join(f"stage {p['stage']} " + ", ".join(
            f"{k} {p['runs']['bfloat16'][k]:.3e} / "
            f"{pref['bf16_seq'][p['stage']][k]:.3e}"
            for k in ("out", "dx", "grads")) for p in p0)
        + f"; launches a call a stage {want}; the one-process reference "
        f"{pref['seconds']:.1f} s ({card})")
    for p in p0:
        log(f"collectives (b) stage {p['stage']}: ms a call (fp32, bf16, "
            f"then bf16 timed) "
            + ", ".join(f"{ms:.1f} (hops {h:.1f})"
                        for ms, h in zip(p["ms"], p["hop_ms"]))
            + f"; peak {p['peak_gb']:.2f} GB ({card})")
    bf = [np.median(p["ms"][-PIPE_TIMED:]) for p in p0]
    hop = [np.median(p["hop_ms"][-PIPE_TIMED:]) for p in p0]
    return dict(launches=launches, faults=faults, ms=bf, hop_ms=hop,
                sync_ms={k: [rec["sync"]["float32"][k]["ms"] for rec in recs]
                         for k in SYNC_KINDS},
                ref_seconds=ref_secs)


def sum_launches(per_step):
    """The kernels' launches summed over a run's steps."""
    return {k: sum(ln[k] for ln in per_step) for k in KERNELS}


def phase_multiprocess(train, resume, dry):
    """Phase 12 after the parent frees its cached memory for the ranks:
    12b and 12c with phase 11 beside them (a thread of this process waits
    for its worker), then 8b (c)'s records, then 12a (which times the
    kernels, beside nothing), 12d, 12e, 12f, 12g and 12h."""
    import gc
    import shutil
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"multi-process: the parent holds "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB of the card")
    shutil.rmtree(DP_DIR, ignore_errors=True)
    respawn = Background(phase_respawn, train, resume)
    dp = phase_data_parallel(train)
    fleet = phase_fleet(dp)
    respawn = respawn.result()
    dry = finish_dryrun(dry)
    seq = phase_seq_parallel()
    seqtrain = phase_seq_train(train)
    seqscan = phase_seq_scan()
    gc.collect()
    torch.cuda.empty_cache()
    model = phase_model_parallel(train)
    gc.collect()
    torch.cuda.empty_cache()
    modelscan = phase_model_scan()
    gc.collect()
    torch.cuda.empty_cache()
    seqmodel = phase_seq_model(train)
    return dict(seq=seq, dp=dp, fleet=fleet, seqtrain=seqtrain,
                seqscan=seqscan, model=model, modelscan=modelscan,
                seqmodel=seqmodel, respawn=respawn, dry=dry)


def main(argv):
    t_main = time.time()
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--before", metavar="DIR", help="another checkout "
                        "of this repository (e.g. the parent commit from "
                        "git archive): its kernels are built and timed "
                        "beside these (the forward at the serving, training "
                        "and mixtral shapes, dQ and dK/dV at the training "
                        "shape)")
    parser.add_argument("--train-worker", metavar="DIR", help="run as the "
                        "respawn phase's training worker with checkpoints "
                        "in DIR (started by the phase's FleetSupervisor)")
    parser.add_argument("--seq-worker", metavar="DIR", help="run as a rank "
                        "of phase 12a (the SPION_* environment names the "
                        "job); records go to DIR")
    parser.add_argument("--dp-worker", metavar="DIR", help="run as a rank "
                        "of phases 12b and 12c's data-parallel training "
                        "with checkpoints in DIR")
    parser.add_argument("--seqtrain-worker", metavar="DIR", help="run as a "
                        "rank of phase 12d's training over a 'seq' axis; "
                        "records go to DIR")
    parser.add_argument("--seqscan-worker", metavar="DIR", help="run as a "
                        "rank of phase 12e (the hybrid, ssm and encdec "
                        "families over a 'seq' axis); records go to DIR")
    parser.add_argument("--carry-worker", metavar="DIR", help="run as a "
                        "rank of phase 12e's 4-rank check of the scans' "
                        "state carry; records go to DIR")
    parser.add_argument("--model-worker", metavar="DIR", help="run as a "
                        "rank of phase 12f (tensor, expert and vocabulary "
                        "parallelism over a 'model' axis); records go to "
                        "DIR")
    parser.add_argument("--modelscan-worker", metavar="DIR", help="run as "
                        "a rank of phase 12g (the hybrid, ssm and encdec "
                        "families over a 'model' axis); records go to DIR")
    parser.add_argument("--seqmodel-worker", metavar="DIR", help="run as a "
                        "rank of phase 12h ('seq' together with 'model', "
                        "and the head fallback on 'model'); records and the "
                        "one-process references are in DIR")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_torch = time.time()
    if args.train_worker:
        return train_worker(args.train_worker)
    if args.seq_worker:
        return seq_worker(args.seq_worker)
    if args.dp_worker:
        return dp_worker(args.dp_worker, {"main": t_main, "torch": t_torch})
    if args.seqtrain_worker:
        return seqtrain_worker(args.seqtrain_worker,
                               {"main": t_main, "torch": t_torch})
    if args.seqscan_worker:
        return seqscan_worker(args.seqscan_worker,
                              {"main": t_main, "torch": t_torch})
    if args.carry_worker:
        return carry_worker(args.carry_worker)
    if args.model_worker:
        return model_worker(args.model_worker,
                            {"main": t_main, "torch": t_torch})
    if args.modelscan_worker:
        return modelscan_worker(args.modelscan_worker,
                                {"main": t_main, "torch": t_torch})
    if args.seqmodel_worker:
        return seqmodel_worker(args.seqmodel_worker,
                               {"main": t_main, "torch": t_torch})
    import shutil
    import numpy as np
    # every exec of this run (and of the respawn phase's worker, which
    # inherits the environment) looks its kernel config up here, and only
    # phase 8a writes it
    shutil.rmtree(AUTOTUNE_DIR, ignore_errors=True)
    os.environ["SPION_AUTOTUNE_DIR"] = AUTOTUNE_DIR
    os.environ.pop("SPION_AUTOTUNE", None)
    from repro_torch.kernels.block_sparse_attn import (library_path,
                                                       load_library)

    log(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    start = t0 = time.perf_counter()
    before, builder = None, None
    if args.before:
        import threading
        before = parent_kernels(args.before)
        builder = threading.Thread(target=before.load_library)
        builder.start()       # its nvcc processes run beside this tree's
    load_library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    from multiprocessing import forkserver
    rank_context()
    forkserver.ensure_running()    # the ranks' fork server, from now on
    if builder is not None:
        builder.join()
        before.load_library()         # raises here if that build failed
        log(f"the --before tree's kernels built and loaded by "
            f"{time.perf_counter() - t0:.1f} s")
    report = library_path().parent / "build.log"
    if report.exists():
        name = "?"
        for line in report.read_text().splitlines():
            if "_kernel" in line and "Compiling" in line:
                name = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                log(f"ptxas {name[:70]}: {line.split(':', 1)[-1].strip()}")

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    err, tol, inputs = phase_kernel_sweep(gen, rng)
    phase_backward_sweep(gen, rng)
    served = {}
    for name, phase in (("serve", lambda: phase_serve(gen, rng)),
                        ("serve_shared", lambda: phase_serve_shared(serve)),
                        ("mixtral", lambda: phase_mixtral_ring(before))):
        reset_launch_counts()
        out = phase()
        served[name] = launch_counts()
        check(served[name]["block_sparse_dq"] == 0 and
              served[name]["block_sparse_dkv"] == 0,
              f"serving launched a backward kernel: {served[name]}")
        if name == "serve":
            serve = out
        elif name == "serve_shared":
            shared = out
            # qwen2-7b's parameters (15 GB) make room for mixtral's
            del serve["params"]
            torch.cuda.empty_cache()
        else:
            mixtral = out
    zamba = phase_zamba2(before)
    rwkv = phase_rwkv6()
    whisper = phase_whisper(before)
    internvl = phase_internvl2(before)
    dense_shapes = phase_dense_shapes(before)
    train = phase_train()
    train_err, train_timing = phase_train_path_kernels(train, gen, before)
    phase_covering_step(train)
    timing = kernel_timing(inputs, "the serving path's shape", before)
    del inputs
    autotuned = phase_autotune(train, serve, mixtral, gen)
    dry = phase_dryrun(train)
    resume = phase_resume(train)
    rollback = phase_rollback(resume)
    multi = phase_multiprocess(train, resume, dry)
    dry, respawn = multi["dry"], multi["respawn"]
    dp, fleet, seqtrain = multi["dp"], multi["fleet"], multi["seqtrain"]
    seqscan, model = multi["seqscan"], multi["model"]
    modelscan, seqmodel = multi["modelscan"], multi["seqmodel"]
    pipeline, serve_mesh = seqmodel["pipeline"], seqmodel["serve"]

    fwd = {"launches": serve["launches"] + shared["launches"]
           + mixtral["launches"]
           + sum(run["launches"]["block_sparse_fwd"]
                 for run in (zamba, whisper, internvl, train, dp, seqtrain,
                             seqscan, model, modelscan, seqmodel,
                             pipeline, serve_mesh, dry)),
           "launches_serve": serve["launches"],
           "launches_serve_shared": shared["launches"],
           "launches_mixtral": mixtral["launches"],
           "launches_zamba2": zamba["launches"]["block_sparse_fwd"],
           "launches_whisper": whisper["launches"]["block_sparse_fwd"],
           "launches_internvl2": internvl["launches"]["block_sparse_fwd"],
           "launches_train": train["launches"]["block_sparse_fwd"],
           "max_abs_err": err, "tol": tol,
           "train_shape": dict(train_timing.pop("block_sparse_fwd"),
                               max_abs_err=train_err["bfloat16"]["o"]),
           "mixtral_shape": mixtral["kernel"],
           **{f"{arch.replace('-', '_').replace('.', '_')}_shape": rec
              for arch, rec in dense_shapes.items()},
           **timing}
    rows = {"block_sparse_fwd": fwd}
    tuned = tuned_record(autotuned)
    for name, grads in (("block_sparse_dq", ("dq",)),
                        ("block_sparse_dkv", ("dk", "dv"))):
        t = train_timing[name]
        rows[name] = {"launches": sum(run["launches"][name] for run in
                                      (train, zamba, whisper, internvl, dp,
                                       seqtrain, seqscan, model, modelscan,
                                       seqmodel, pipeline, serve_mesh, dry)),
                      "launches_zamba2": zamba["launches"][name],
                      "launches_whisper": whisper["launches"][name],
                      "launches_internvl2": internvl["launches"][name],
                      "launches_train": train["launches"][name],
                      "max_abs_err": max(train_err["bfloat16"][g]
                                         for g in grads),
                      **{k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms",
                                           "before_ms") if k in t}}
    for name, row in rows.items():
        row["zamba2_shape"] = zamba["kernels"][name]
        row["whisper_shape"] = whisper["kernels"][name]
        row["internvl2_shape"] = internvl["kernels"][name]
        row["tuned"] = tuned[name]
        for path, run in (("resume", resume), ("rollback", rollback),
                          ("respawn", respawn), ("dp", dp),
                          ("fleet", fleet), ("seqtrain", seqtrain),
                          ("seqscan", seqscan), ("model", model),
                          ("modelscan", modelscan), ("seqmodel", seqmodel),
                          ("pipeline", pipeline), ("serve_mesh", serve_mesh),
                          ("dryrun", dry)):
            row[f"launches_{path}"] = run["launches"][name]
        row["model_shard_shape"] = model["kernels"][name]
        row["modelscan_zamba2_shape"] = modelscan["kernels"]["zamba2"][name]
        row["modelscan_whisper_shape"] = \
            modelscan["kernels"]["whisper"][name]
        for leg, rec in seqmodel["kernels"].items():
            row[f"seqmodel_{leg}_shape"] = rec[name]
        row["pipeline_shape"] = pipeline["kernels"][name]
        row["serve_mesh_shape"] = serve_mesh["kernels"][name]
        row["seq_parallel"] = multi["seq"]["runs"]
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], **row} for name, row in rows.items()]}
    log(f"serve prefill_ms median {serve['prefill_ms']:.3f} mean "
        f"{serve['prefill_mean']:.3f}; decode_ms_per_tick median "
        f"{serve['decode_ms']:.3f} mean {serve['decode_mean']:.3f}; shared "
        f"prefix stepwise_ms_per_token {shared['step_ms']:.3f}, "
        f"decode_ms_per_tick median {shared['decode_ms']:.3f}, pages "
        f"{shared['allocs']} (unshared {shared['base_allocs']}), fp32 "
        f"stepwise gap {shared['gap32']:.3e}; mixtral "
        f"ring prefill_ms median {mixtral['prefill_ms']:.3f}, "
        f"decode_ms_per_tick median {mixtral['decode_ms']:.3f}, fp32 ring "
        f"gap {mixtral['ring_gap']:.3e}, phase {mixtral['seconds']:.1f} s; "
        f"zamba2 sparse forward {zamba['fwd_ms']:.2f} ms, train step "
        f"{zamba['train_ms']:.2f} ms, stepwise_ms_per_token sparse "
        f"{zamba['step_ms']:.3f} dense {zamba['dense_step_ms']:.3f}, "
        f"decode_ms_per_tick median sparse {zamba['decode_ms']:.3f} dense "
        f"{zamba['dense_decode_ms']:.3f}, fp32 decode gap "
        f"{zamba['gap32']:.3e}, phase {zamba['seconds']:.1f} s; rwkv6 "
        f"stepwise_ms_per_token {rwkv['step_ms']:.3f}, decode_ms_per_tick "
        f"median {rwkv['decode_ms']:.3f}, fp32 decode gap "
        f"{rwkv['gap32']:.3e}, long-context ms/token "
        + "/".join(f"{t:.3f}" for t in rwkv["long_ms"].values())
        + f" at {'/'.join(rwkv['long_ms'])}, phase {rwkv['seconds']:.1f} s; "
        + "; ".join(
            f"{label} sparse forward {run['fwd_ms']:.2f} ms, train step "
            f"{run['train_ms']:.2f} ms (peak {run['peak_gb']:.2f} GB), "
            f"stepwise_ms_per_token {run['step_ms']:.3f}, decode_ms_per_tick "
            f"median {run['decode_ms']:.3f}, fp32 decode gap "
            f"{run['gap32']:.3e}, covering logits "
            f"{run['covering']['logits_max']:.4f}x by max, worst leaf "
            f"{run['covering']['worst_leaf']:.4f}x, phase "
            f"{run['seconds']:.1f} s"
            for label, run in (("whisper", whisper), ("internvl2", internvl)))
        + f"; whisper planted decode faults from "
        f"{whisper['planted']:.3e}; train "
        f"dense_step_ms median {train['dense_ms']:.3f}, sparse_step_ms median "
        f"{train['sparse_ms']:.3f}")
    card = card_line()
    for what, sec in (("save of one checkpoint", resume["save_s"]),
                      ("restore (fresh Trainer + maybe_resume)",
                       resume["restore_s"]),
                      ("respawn (killed worker's last step to the new "
                       "worker's first)", respawn["seconds"]),
                      ("rollback", rollback["seconds"])):
        log(f"recovery, spion-lra at ListOps size, {what}: {sec:.3f} s "
            f"({card})")
    log(f"multi-process, spion-lra at ListOps size on {DP_RANKS} ranks "
        f"sharing the card (gloo): step median per rank "
        + ", ".join(f"rank {r} dense {ms['dense']:.2f} ms sparse "
                    f"{ms['sparse']:.2f} ms" for r, ms in dp["step_ms"].items())
        + f"; gradient all-reduce median per rank "
        f"{', '.join(f'{x:.3f}' for x in dp['allreduce_ms'])} ms"
        + f"; peak per rank {', '.join(f'{g:.2f}' for g in dp['peak_gb'])} "
        f"GB; fleet respawn (killed rank's last step to the new generation's "
        f"first) {fleet['seconds']:.3f} s; halo transport "
        f"{multi['seq']['transport']} ({card})")
    log(f"training over 'seq' (phase 12d, {seqtrain['seconds']:.1f} s): "
        f"spion-lra on seq {SEQ_TRAIN_MESH[0]} x data {SEQ_TRAIN_MESH[1]} "
        f"ranks sharing the card, dense gap {seqtrain['gap']:.3e}, captures "
        f"{seqtrain['cap_gap']:.3e} (planted {seqtrain['planted']:.3e}), the "
        f"trained plan through the {seqtrain['branch']}; peak per rank "
        f"{', '.join(f'{g:.2f}' for g in seqtrain['peak_gb'])} GB; "
        f"internvl2-2b dense / sparse rel loss gap "
        f"{seqtrain['decoder']['dense']['loss_gap']:.3e} / "
        f"{seqtrain['decoder']['sparse']['loss_gap']:.3e} ({card})")
    log(f"the scan families over 'seq' (phase 12e, "
        f"{seqscan['seconds']:.1f} s): fp32 rel loss gaps to one process "
        + "; ".join(f"{name} " + ", ".join(f"{k} {v:.3e}"
                                          for k, v in gaps.items())
                    for name, gaps in seqscan["gaps"].items())
        + f"; planted faults " + ", ".join(f"{k} {v:.3e}" for k, v in
                                           seqscan["faults"].items())
        + f"; zamba2's Trainer captures {seqscan['cap_gap']:.3e}, the "
        f"trained plan through the {seqscan['branch']} ({card})")
    log(f"tensor parallelism over 'model' (phase 12f, "
        f"{model['seconds']:.1f} s): spion-lra on data {MODEL_MESH[0]} x "
        f"model {MODEL_MESH[1]} ranks sharing the card, dense gap "
        f"{model['gap']:.3e}, captures {model['cap_gap']:.3e} (the rank's "
        f"own heads {model['planted']:.3e}), the checkpoint's next loss in "
        f"one process {model['resume_gap']:.3e}; peak per rank "
        f"{', '.join(f'{g:.2f}' for g in model['peak_gb'])} GB; "
        + "; ".join(f"{name} rel loss gap {r['loss_gap']:.3e}, worst "
                    f"gradient leaf {r['grad_rel']:.3e}"
                    for name, r in model["legs"].items()) + f" ({card})")
    log(f"the scan families over 'model' (phase 12g, "
        f"{modelscan['seconds']:.1f} s): fp32 rel loss gap and worst "
        f"gradient leaf to one process "
        + "; ".join(f"{k} {a:.3e} / {b:.3e}"
                    for k, (a, b) in modelscan["gaps"].items())
        + "; planted faults " + ", ".join(
            f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in
            modelscan["faults"].items())
        + f"; zamba2's Trainer captures {modelscan['cap_gap']:.3e}, resumed "
        f"on the line {modelscan['line_resume']:.3e}, in one process "
        f"{modelscan['one_resume']:.3e}, in_proj restored contiguously "
        f"{modelscan['planted_resume']:.3e} ({card})")
    log(f"'seq' together with 'model' and the head fallback (phase 12h, "
        f"{seqmodel['seconds']:.1f} s): spion-lra on seq {SEQMODEL_MESH[0]} x "
        f"model {SEQMODEL_MESH[1]} dense gap {seqmodel['gap']:.3e}, captures "
        f"{seqmodel['cap_gap']:.3e}, the trained plan through the "
        f"{seqmodel['branch']}; fp32 rel loss gap and worst gradient leaf to "
        f"one process "
        + "; ".join(f"{k} {a:.3e} / {b:.3e}"
                    for k, (a, b) in seqmodel["gaps"].items())
        + "; planted faults " + ", ".join(
            f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in
            seqmodel["faults"].items()) + f" ({card})")
    log(f"the explicit collectives (phase 12i, on 12h's ranks): int8 sync "
        f"ms over 'data' / ('pod', 'data') / hierarchical, fp32, rank 0 "
        + " / ".join(f"{pipeline['sync_ms'][k][0]:.2f}" for k in SYNC_KINDS)
        + f" (4 bytes an element on the wire, as fp32); GPipe over pod 4, "
        f"bf16 ms a call a stage "
        + ", ".join(f"{x:.1f}" for x in pipeline["ms"])
        + ", of it the hops " + ", ".join(f"{x:.1f}"
                                          for x in pipeline["hop_ms"])
        + "; planted " + ", ".join(f"{k} {v:.3e}" for k, v in
                                   pipeline["faults"].items())
        + f" ({card})")
    log(f"prefill and decode steps under a mesh (phase 12j, on 12h's ranks, "
        f"{serve_mesh['seconds']:.1f} s): qwen2-7b reduced to {SERVE_LAYERS} "
        f"of 28 layers at full width; fp32 worst gaps to one process "
        + ", ".join(f"{k} {v:.3e}" for k, v in serve_mesh["gaps"].items())
        + "; bf16 distance from fp32 over one process's, worst "
        + ", ".join(f"{k} {v:.3f}" for k, v in serve_mesh["ratios"].items())
        + f" ({card})")
    log(f"recovery: supervisor {respawn['wall']:.2f} s in all; a sparse step "
        f"run twice is {'' if resume['bitwise'] else 'NOT '}bitwise "
        f"reproducible; max rel gap to the uninterrupted run's losses (gate "
        f"{TOL_RESUME}): first leg {resume['lead_gap']:.3e}, resumed "
        f"{resume['gap']:.3e}, respawn's stitched {respawn['gap']:.3e}")
    log(f"chip_smoke: every phase passed in {time.perf_counter() - start:.1f} s")
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    become_subreaper()
    try:
        rc = main(sys.argv[1:])
    finally:
        try:
            stop_background()
            stop_rank_server()
        finally:
            end_descendants()
    sys.exit(rc)
