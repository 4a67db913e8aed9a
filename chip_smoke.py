#!/usr/bin/env python3
"""Drive the oatx_torch port once on one CUDA card and check it.

    python3 chip_smoke.py [--parent-ln-linear LIB] [--parent-ln-mlp LIB]
                          [--parent-space-attention LIB] [--sweep-query-splits]
                          [--only-trainer] [--only-objects] [--only-data]
                          [--only-towers] [--only-wide] [--only-dp] [--only-shard]
                          [--only-tp] [--only-pp] [--only-extract] [--only-viz]
                          [--only-optim] [--only-finetune] [--only-decode]
                          [--only-serve-extras] [--dp-nccl] [--tp-nccl] [--pp-nccl]

--parent-ln-linear names a library built from another csrc/ln_linear.cu
with the same C interface (`ln_linear_fwd_bf16`), e.g. an earlier commit's:
the kernels phase then also checks it and times it in turns with this
tree's kernel (parent, this, this, parent), alone and under forward +
backward, at the train step's shape. --parent-ln-mlp does the same for an
earlier csrc/ln_mlp.cu with the one-kernel C interface (8 pointers, 4 ints,
eps, stream), at each R of LN_MLP_ROWS. --parent-space-attention does it
for an earlier csrc/space_attention.cu with the Dh-64 C interface that
this tree keeps (space_attention_fwd_bf16 / space_attention_bwd_bf16,
with log-sum-exp and the backward kernels), forward, backward and both,
at each shape of SA_SHAPES, and holds its outputs bitwise against this
tree's. --sweep-query-splits also times kernel 2's forward at 1-4 blocks
per frame group at each shape, the choice that `_query_split` encodes.
--only-trainer builds the kernels and runs phase 5 alone, --only-objects
phase 6, --only-data phase 7, --only-towers phase 8, --only-wide phase 9,
--only-dp phase 10, --only-shard phase 11, --only-tp phase 12, --only-pp
phase 13, --only-extract phase 14, --only-viz phase 15, --only-optim phase
16, --only-finetune phase 17, --only-decode phase 18, --only-serve-extras
phase 3's extras (a) and (b) (no record, no `ok` line). --dp-nccl runs phase 10 (b) and then
phase 11's pod recipes alone with one rank per visible card over NCCL (2
or more cards).
--tp-nccl runs the pod recipes as shipped (model_parallel 4: ViT-H/14,
ViT-L/16 and pod_v5p's ViT-B/16 over 16 frames) with a rank on each of 4
cards over NCCL (TP_NCCL_RUNS; no record, no `ok` line).
--pp-nccl runs the pod recipes with pipeline true on their 4 stages, a rank
on each of 4 cards over NCCL (PP_NCCL_RUNS; no record, no `ok` line).

Phases (any failure raises: the exit code is then not 0 and no `ok` line is
printed):
  1. environment — the card's name and power limit (nvidia-smi), torch and
     CUDA versions, the decoding libraries the machine holds (nvJPEG's and
     NVDEC's headers and libraries: decode_probe), and the nvcc build of
     every kernel in oatx_torch/csrc;
  2. kernels — each hand-written kernel against its plain PyTorch version on
     the card (bf16): kernel 1 (ln_mlp) at R = 197, 785, 3140, 3152 and
     6280 rows (3152: the object-aware recipes' 1-frame object frame at batch 16; its
     record at bucket 4's 3140, with the ms of each split of its second
     product up to R = LN_MLP_SPLIT_ROWS), kernel 2 (space_attention) and its backward kernels
     (space_attention_bwd, against autograd of the plain version and, not
     checked, both against the exact f64 gradient) at B = 1, 4 and 8 of the
     serving shapes (4 frames, T = 785), at B = 16 over one frame (T = 197,
     the object frame; `by_batch` key "16_F1") and over SA_TAIL_DRAWS more
     draws at B = 4 (records at bucket 4, `by_batch` for each shape),
     kernel 3 (ln_linear) at the
     train step's LN→qkv shape; kernels 1 and 2 also at one 224² frame
     of ViT-B/16 (phases 14 and 15's shapes: R = 197; B = 1 over one frame,
     T = 197, `by_batch` key "1_F1"; the plain version timed there too) and
     at region_mem's eval chunk of 8 (phase 15: R = 1576 and 6280, B = 8
     over one frame, "8_F1", and over 4 frames; the plain version timed
     there too), and at pod_v5p's one-card shapes (R = 16·3137 = 50192;
     B = 16 over 16 frames, T = 3137, "16_F16") and MSR-VTT fine-tuning's
     batch of 64 (phase 17: R = 64·785 = 50240; B = 64, T = 785), the
     plain forward and backward timed there too, each
     with its time (CUDA events, and device
     busy time from traces that must hold every kernel launched), achieved
     TFLOP/s, ptxas registers and spills, the plain version's time, one
     PyTorch library call's (SDPA and its backward for kernel 2) and the
     card's bound; and for all three the forward + backward time (and
     device busy time) through the kernel's autograd.Function at the train
     step's shapes;
  3. serve — the full-width zero-shot config (configs/ft/msrvtt/zsl/normal.json:
     ViT-B/16 over 4×224² frames + DistilBERT-base, bf16, random weights from
     seed 0) built through oatx_torch.cli.serve, its HTTP server on a
     localhost port, and real requests: /embed_video at batch 1 and 4,
     /embed_text, /index_video, /search, /stats; then per bucket a latency
     pass (LAT_ROUNDS rounds of LAT_REQUESTS requests after warm-up, each
     round's p50 read back from /stats) and a device trace of
     PROFILED_REQUESTS requests (device busy time, idle share of the
     unprofiled p50, device time by kernel group). The launch counters are
     set to 0 just before and read just after; every kernel must have run 12
     times per video-tower forward. The served embedding is held against the
     same model with the plain versions. Extras (serve_extras): (a) the same
     config served with --quantize int8 --index-quantize int8 (the same
     requests, counted under "serve_int8": 12 launches of kernels 1 and 2 a
     video forward; the embedding against the same int8 model on the plain
     versions, cosine >= E2E_MIN_COSINE, and against the full-precision
     model, cosine > INT8_MIN_COSINE, oatx's bar; the int8 report, the
     model's device bytes int8 and full, the int8 corpus's top-5 overlap
     with an f32 index of the same rows; p50 per bucket by phase 3's method,
     EXTRA_LAT_ROUNDS × EXTRA_LAT_REQUESTS requests); (b) `python -m
     oatx_torch.cli.export_serving` full and --quantize int8, the two
     processes started together while (a) checks its server, each artifact
     served through cli.serve --artifact: /embed_video at batches 1, 3 and 4
     (3 is no bucket) and /embed_text counted under "artifact" (12 + 12
     launches a video forward: the kernels run inside the exported
     program), each embedding against the in-process service of the same
     weights (cosine >= E2E_MIN_COSINE, largest difference printed), the
     artifact's bytes and its p50 at batch 4; then the host µs that a call
     through each kernel's custom op costs above a direct launch.
  4. train — the flagship pretraining step that bench.py builds (ViT-B/16
     divided space-time over 4×224² + DistilBERT-base, 256-d projections,
     bf16 compute with f32 master weights, NormSoftmax at 0.05, AdamW at
     2e-4, batch 8, seq_len 24, random weights from seed 0, one fixed
     numpy-seeded batch), through oatx_torch.train.step's init_state and
     make_train_step, once with fused_qkv=True and once with False. Per run:
     TRAIN_STEPS counted steps (launch counters set to 0 just before and read
     just after: 12 ln_mlp, 12 space_attention, 12 space_attention_bwd and
     24 or 0 ln_linear per step), each step's loss (finite, and lower at the
     end than at step 1), the median step time over TIME_WINDOWS windows
     with their spread, clips/s, MFU, peak device memory (after a
     gc.collect(), with the memory held before the run), a CUDA-only device
     trace, and one step's gradients through the kernels against the same
     through the plain versions: every parameter must have a finite
     gradient. The two runs' step-1 losses agree within bf16 tolerance.
  5. trainer — oatx_torch.train.trainer.Trainer.train() on the pretrain
     recipes (configs/pt/cc3m_webvid/), full width, over an in-memory corpus
     of seeded separable 4-frame 256² clips (MemoryClips) through
     ShardedLoader → Collator → device_prefetch → on-device train_augment:
     norm.json at its per-GPU batch of 16 (init_val, TRAINER_EPOCHS epochs
     of TRAINER_LEN_EPOCH steps, validation and a checkpoint after each;
     the loss must fall and t2v R@1 rise from init_val), a Trainer resumed
     from checkpoint-epoch1 (restored state bitwise, epoch 2's losses within
     RESUME_LOSS_RTOL; a 2-step trace inside its loop gives the loop's idle
     share), the same model at batch 16 with remat off / full / dots /
     dots_all (one step's gradients under grad_check against remat off,
     REMAT_STEPS counted steps, a device trace), and large_batch_pod.json
     at batch 64 with fwd_chunk 8 (finite losses), then without fwd_chunk
     if it fits. Each run's launches are counted around it and must equal
     the counts derived from the code (want_launches); step ms, clips/s,
     MFU, idle share and peak memory are printed for every setting.
  6. objects — the paper's object-aware pretraining through
     Trainer.train(): configs/pt/cc3m_webvid/local_region_loss.json
     (global_local) and configs/pt/webvid/region_mem.json (region_mem), each
     with its model at full width (remat off), its AdamW and its per-GPU
     batch of 16, over the trainer phase's 32 clips with object extras
     through the port's `_add_object_extras` (object_corpus: a 1-frame
     object frame and a BUTD npz of 10-36 boxes per clip; no vocab file,
     the seeded region bank): init_val, TRAINER_EPOCHS epochs of
     OBJECTS_LEN_EPOCH steps, validation and a checkpoint after each. Every
     loss term must be finite and the loss must fall; launches must equal
     want_launches with two video streams (the clip and the object frame);
     one step's gradients on a fixed batch through the kernels must be
     finite and non-zero for every parameter (the variant heads and
     region_norm included) and agree with the plain versions by grad_check;
     a Trainer resumed from checkpoint-epoch1 restores bitwise and repeats
     epoch 2's loss terms within RESUME_LOSS_RTOL (a 2-step trace inside its
     loop gives device busy by group and the idle share). Step ms, clips/s,
     MFU (object_flops_per_clip_step), peak memory, each loss term's first
     and last value and t2v / v2t R@1 per validation are printed per recipe.
  7. data — the file-backed data plane and the two CLIs, in a temp dir. The
     port's writer (seeded apart, 8 threads) writes a WebVid layout (TSVs,
     DATA_CLIPS train / val MJPEG clips at 320×240, 64 frames, under the
     adapter's `.mp4` names), a CC3M layout (DATA_STILLS JPEG stills at
     400×300) and an MSR-VTT layout (MSR_VTT.json, the jsfusion lists and
     caption index, DATA_MSRVTT clips). The decode rate: ms per clip of
     probe + 4-frame decode at short side 256 on one thread and on the
     loader's num_workers threads. Then `oatx_torch.cli.train.main` on a copy
     of norm.json pointed at the corpora, both loaders strict (a file that
     fails to decode raises), trainer cut to TRAINER_EPOCHS
     epochs of DATA_CYCLES cycles (a CC3M 1-frame step and a WebVid 4-frame
     step each) with a checkpoint per epoch, full width, bf16, batch 16:
     every loss term finite, each loader's loss falling, vocab.txt and
     checkpoint-epoch2 written, launches as want_launches derives,
     input_wait, step ms per loader (the intervals ending at its steps),
     clips/s and MFU over a cycle of both, peak memory, and a CUDA-only
     trace of the last CC3M and WebVid steps (device busy, idle share,
     device ms by group) printed. Then `oatx_torch.cli.test.main` on
     zsl/normal.json from that checkpoint with --sliding_window_stride
     DATA_WINDOW_STRIDE: the windows ensemble to one row per video, the
     embeddings and t2v / v2t metrics are finite (R@1 printed, not
     checked), 12 launches of kernels 1 and 2 per video-tower forward.
     Then `oatx_torch.cli.build_index.main` on the same split, windows and
     checkpoint (the same launches as cli.test; one id per video) and one
     /search of a cli.serve server on the index it saved.
  8. towers — every tower a config can name, through the entry points, at
     full width, bf16, batch 16, random weights from seed 0; each run's
     launches are counted around it and must equal want_launches, and its
     step ms (untraced steps), clips/s, MFU by each stream's FLOPs at its
     own shape (towers_flops_per_clip_step; train/flops.py's count beside
     it where its formula applies) and peak memory are printed:
     (1) stream 3: norm.json with arch.stream 3 and object_nce_weight
     STREAM3_NCE_WEIGHT through Trainer.train() over the trainer phase's 32
     clips with BUTD npz files (object_corpus; the loader's input_objects,
     top_k STREAM3_TOP_K), TRAINER_EPOCHS epochs of TOWERS_LEN_EPOCH steps:
     loss and loss_object finite and falling, every object-tower tensor
     moved, a 2-step trace at the end (device ms by group, idle share), then
     retrieval_eval.evaluate over the same clips with their features (o2v /
     o2t finite, R@1 printed); the same run at weight 0 must leave
     object_tower.* and obj_proj.* bitwise unchanged after every step;
     (2) BERT: norm.json with bert-base-uncased (12 × 768) through
     Trainer.train(), the same epochs: loss falling, a 2-step trace;
     (3) CLIP text: oatx_torch.cli.train on norm.json with CLIP_TEXT_MODEL
     (12 × 512, 8 heads, context 77, the byte-level BPE learned from the
     captions) over phase 7's corpora, 1 epoch of TOWERS_CLIP_CYCLES
     cycles: clip_bpe.txt.gz beside the checkpoint, the loss falling; then
     oatx_torch.cli.test on zsl/normal.json with the same text model from
     that checkpoint: the tokenizer it resolves is that file (the same ids
     for the same captions), finite metrics;
     (4) the region bank: oatx_torch.cli.build_region_memory --backend clip
     on the card over REGION_CLASSES names (random init, synthetic merges):
     a finite (1600, 512) float32 bank labelled random-init; then
     region_mem.json as shipped with region_memory_path at that file, 1
     epoch of TOWERS_LEN_EPOCH steps over the 32 clips with object extras:
     the dataset serves the file's rows, every loss term (the region BCE
     too) finite, launches with backward_depths (12, 6).
  9. wide — the repo's demanding configurations, ViT-L/16 (24 × 1024,
     16 heads of 64), ViT-H/14 (32 × 1280, 16 heads of 80, 257 keys a
     frame group) and pod_v5p's ViT-B/16 over 16 frames (T = 3137), full
     width and depth. First the kernels at their shapes
     against the plain versions on the card: kernel 2's forward and backward
     at (4 and 8, 1025, 16, 80) over 4 frames (the forward within
     SPACE_ATTENTION_ATOL + 2^-7·|ref| + the flip allowance, the backward
     by relative L2 and by grad_check) and at Dh 64 (B 4, T 785, 12 heads,
     the serving record's shape), kernel 1 at WIDE_MLP and kernel 3 at WIDE_QKV, each with
     ms (events and device), bound, plain ms and the library's (SDPA and its
     backward; the cuBLAS chain). Then configs/pt/cc3m_webvid/
     vit_large_pod.json (batch 16, remat off; 2 epochs of 4 steps) and
     vit_huge_pod.json (batch 8 as 2 micro-batches of 4, remat dots_all; 6
     steps) and pod_v5p.json (batch 16, remat on, zero1 replicated on one
     process; 4 steps, the last 2 traced) with `model_parallel` 1 (the only
     change: one card cannot hold a model axis of 4) through Trainer.train()
     over 32 seeded clips of as many frames as the tower takes
     (recipe_clips: the trainer phase's 4-frame clips, 16 frames for
     pod_v5p, whose loaders sample 4 and 1), one loader (the recipes' CC3M
     loader is cut), init_val and a validation each epoch, no checkpoints:
     every loss term finite (the loss is printed, not checked: ViT-L and
     ViT-H warm up over 2500 steps, pod_v5p's first update at its full lr
     lifts it), launches as want_launches derives them with accum_steps,
     one step's gradients on a fixed batch at full depth, at the seed-0
     weights before any update, through the kernels against the plain
     versions (grad_check over the tensors whose exact gradient is not 0)
     and both against the same step in f32 (WIDE_F32_RATIO's note), step ms
     (the untraced intervals), clips/s, MFU (train/flops.py), peak memory
     (of the run, without the gradient check's), and from a CUDA-only trace
     of the last 2 steps the idle share and device ms by group.
 10. dp — data parallelism across processes (train/step.py,
     parallel/collectives.py). (a) `oatx_torch.cli.train` on norm.json over
     phase 7's corpora (written again) under OATX_MULTIHOST=1 with oatx's
     three variables at a world of 1 (NCCL, cuda:0), DP_CYCLES cycles, then
     the same run without OATX_MULTIHOST: every loss term and the final
     parameters bitwise equal, the group torn down, launches as
     want_launches derives. (b) DP_WORLD ranks, this script started again
     with --dp-rank (a gloo group over a file:// rendezvous; NCCL refuses two
     ranks on one card), both on cuda:0: first a probe that gloo takes CUDA
     tensors for all_gather, all_reduce (f32, bf16) and broadcast (if not,
     (b) waits and says so); then through Trainer.train() over the trainer
     phase's 32 clips, each rank its shard at batch DP_RANK_BATCH: norm.json
     DP_NORM_STEPS steps, local_region_loss.json (global_local) and
     region_mem.json one step each over the objects phase's corpus. Each
     held against one process at batch DP_WORLD·DP_RANK_BATCH on the same
     global batch (GlobalBatches, as many steps): step 1's loss terms within
     DP_LOSS_RTOL relative, the reduced gradients by grad_check, global
     norms within GRAD_NORM_RTOL, cosine ≥ GRAD_MIN_GLOBAL_COSINE, every
     rank's gradients and loss terms equal, the gradient all-reduce exactly
     the trainable f32 bytes a step, launches per rank as want_launches
     derives. Printed: the all-reduce and all-gather bytes and calls a step
     by purpose, step ms and peak memory per rank and of the one process
     (the ranks' step ms is not a data-parallel speed here: they share one
     card and gloo stages CUDA tensors through the host; with --dp-nccl it
     is).
 11. shard — sharded training state across ranks (parallel/sharding.py,
     the fsdp path of train/step.py, AdamW's shares, the placement and
     snapshots of train/trainer.py and train/checkpoint.py). DP_WORLD ranks
     on cuda:0 over gloo, this script started again with --dp-rank and
     --dp-phase shard: phase 10's probe, and that gloo takes
     reduce_scatter_tensor and all_gather_into_tensor on CUDA tensors (the
     sharded layouts' collectives; parallel/collectives.py); then
     norm.json at batch DP_RANK_BATCH a rank through Trainer.train(),
     SHARD_EPOCHS epochs of SHARD_LEN_EPOCH steps, replicated, under zero1
     and under fsdp (the zero1 and fsdp runs write a snapshot each epoch,
     and each save's device memory above what the rank held as it began
     stays within SAVE_SLACK_TENSORS whole tensors of the largest: the
     state is gathered one tensor at a time, never whole). Each held
     against one process at batch DP_WORLD·DP_RANK_BATCH on the same global
     batches (GlobalBatches): step 1's loss terms within DP_LOSS_RTOL, step
     1's whole gradients by grad_check; the whole parameters after the last
     step bitwise the replicated ranks' (the same elements through the same
     arithmetic); every rank's loss terms equal; each rank's held state
     bytes (parameters + gradients + moments, from the tensors' storage)
     exactly sharding.state_bytes and, sharded, below the replicated
     state's; launches per rank as want_launches derives; the fsdp snapshot
     of epoch 1 restored in one process repeats the ranks' step 3 within
     DP_LOSS_RTOL. Then the same under Adafactor (SHARD_ADAFACTOR_MODES:
     zero1 and fsdp): step 1's terms and gradients as above (step 1
     precedes any update), each rank's held bytes exactly
     state_bytes(kind="Adafactor"), its factor_sums / factor_split /
     factor_mean / block_rms bytes exactly optim_traffic's; and Adafactor on fixed
     gradients (optim_fixed: norm.json's seeded towers, OPTIM_FIXED_STEPS
     steps, no forward) under zero1 and fsdp, the whole parameters and
     v_row / v_col / v within OPTIM_FIXED_RTOL of one process's on the card;
     each Adafactor rank's peak memory at most the AdamW rank's of the same
     mode, in training and in the update alone on those fixed gradients
     (adafactor_peaks). Printed: the collectives' bytes and calls a step by
     purpose, step ms and peak memory per rank. With --dp-nccl (a rank on
     each card): SHARD_NCCL_RUNS, vit_huge_pod.json under fsdp
     (model_parallel 4 → 1, batch 8 a rank as 2 micro-batches, dots_all, 3
     steps) and large_batch_pod.json under zero1 (batch 64 a rank,
     fwd_chunk 8, 2 steps), each with its peak per rank beside one process
     at the same batch on cuda:0.
 12. tp — tensor and sequence parallelism over a model axis
     (parallel/tensor.py, the Megatron splits of parallel/sharding.py, the
     towers' enable_model_parallel). First kernels 1 and 2 at the shapes a
     rank gives them (TP_MLP: the hidden shard of ViT-B at mp 2, ViT-L and
     ViT-H at mp 4, with a zero fc2 bias, also held against the plain chain
     less b2; TP_SA: the local heads, forward and backward) against their
     plain versions, with ms, bound, plain and library ms (the `tp` key of
     each kernel's record; TP_MLP / TP_SA also hold the object-aware
     recipes' 1-frame object frame at a rank's shapes: R = 16·197, 768 →
     1536; B 16, F 1, N 196, 6 heads; and pod_v5p's at mp 4: R = 16·3137,
     768 → 768; B 16, F 16, N 196, 3 heads). Then TP_WORLD ranks on cuda:0 over
     gloo, this script started again with --dp-rank and --dp-phase tp:
     phase 11's probe plus bf16 token-axis gathers; then TP_RUNS at
     model_parallel TP_WORLD, one model group at TP_BATCH, through
     Trainer.train() (tp_recipe, tp_data): norm.json for TP_STEPS steps
     with sequence_parallel off and on, and one with fused_mlp false (the
     plain MLP chain; no config key, set on the tower config);
     local_region_loss.json (global_local) and region_mem.json as shipped
     with sequence_parallel on, 2 steps each over the objects phase's
     corpus with patch masks and BUTD files (the second text and video
     streams, the object frame's 197 tokens padded to 2 × 99, region_mem's
     layer-6 tap on the gathered stream); norm.json with BERT-base text and
     arch.stream 3 at STREAM3_NCE_WEIGHT (BERT's layers and vocabulary
     split, the object tower's layers split), and with CLIP's text tower
     (the packed in_proj by whole heads under the causal mask), 1 step
     each. Each against one process at TP_BATCH on the same rows: step 1's
     loss terms within TP_LOSS_RTOL, step 1's whole gradients (gathered
     from the parts) by grad_check, the model peers' replicated parameters
     bitwise equal after every step, each rank's held state bytes exactly
     sharding.state_bytes of the split, the tp_reduce / sp_gather /
     sp_scatter bytes exactly tp_traffic's count and the tp_norm bytes the
     partial gradients', and 12 launches of kernels 1 and 2 a forward a
     rank for each video stream (24 for the two-stream variants; 0 of
     kernel 1 for fused_mlp false) and kernel 2's backward once a block
     the loss reaches (tp_reached: 12 a step, 24 for global_local, 12 + 6
     for region_mem). TP_RUNS' last, 'adafactor', is norm.json with SP on
     for 1 step under Adafactor (TP_OPTIMIZER): the same checks, its held
     bytes state_bytes(kind="Adafactor") of the split and its optimizer
     bytes optim_traffic's; then optim_fixed at model_parallel TP_WORLD
     against one process, as phase 11's. Printed: step ms, peak and
     collectives a rank (gloo: no speed). With --tp-nccl (4 cards):
     vit_huge_pod.json, vit_large_pod.json and pod_v5p.json (over 16-frame
     clips; zero1 over a data axis of 1) as shipped, a rank a card
     over NCCL: per rank peak GiB, step ms, MFU (a rank's FLOPs over one
     card's peak) and idle share (a 2-step trace), beside each recipe in
     one process at model_parallel 1 on cuda:0 at the same batch.
 13. pp — pipeline stages over the model axis (parallel/pipeline.py, the
     stage placement of parallel/sharding.py, `trainer.pipeline`). First
     kernels 1 and 2 (forward and backward) at a stage's micro-batch shapes
     of the pod recipes (PP_MLP, PP_SA: ViT-L/16 at 4 rows of 785 tokens,
     ViT-H/14 at 1 row of 1025; ViT-B/16's at norm.json's 16 over 4
     micro-batches are phase 2's record shapes) against their plain
     versions, with ms, bound, plain and library ms (the `pp` key of each
     kernel's record). Then PP_WORLD ranks on cuda:0 over gloo, this script
     started again with --dp-rank and --dp-phase pp: phase 12's probe plus
     the pipeline's own sends and broadcast on CUDA tensors (over gloo a
     send crosses the host); then norm.json with pipeline true at
     model_parallel PP_WORLD and PP_MICRO micro-batches, one pipeline group
     at PP_BATCH, through Trainer.train(): PP_STEPS steps with a validation
     and a snapshot, one step with fused_qkv true (kernel 3 on each stage)
     and one under zero1. Each against one process at PP_BATCH on the same
     rows: step 1's loss terms within PP_LOSS_RTOL, step 1's whole
     gradients (the other stage's blocks gathered) by grad_check, the
     stages' replicated parameters bitwise equal after every step, each
     rank's held state bytes exactly sharding.state_bytes(pipeline=True),
     the pp_* bytes (pp_send, pp_grad, pp_bcast, pp_embed, pp_host) exactly
     pp_traffic's, kernels 1, 2 and 2's backward launched L/P × M = 24
     times a step a rank, every launch as derived (validation's included),
     the snapshot restored by one process bitwise, then training on, and
     the ranks' validation embeddings within PP_EVAL_MIN_COSINE of that
     process's on the same (restored) weights.
     With --pp-nccl (4 cards): vit_huge_pod.json and vit_large_pod.json
     with pipeline true at their model_parallel 4 (fsdp and
     sequence_parallel off, as oatx requires), a rank a card over NCCL:
     per rank peak GiB, step ms, MFU (a rank's 1/4 of the FLOPs over one
     card's peak), idle share and device ms by group (NCCL's send / receive
     kernels among them) from a 2-step trace, the derived bubble (P − 1) /
     (M + P − 1), beside each recipe in one process at model_parallel 1
     on cuda:0 at the same batch.
 14. extract — offline object extraction (data/extraction.py,
     cli/extract.py, ops/roi_align.py). (a) EXTRACT_CLIP_FRAMES MJPEG clips
     of 320×240 written by the port's writer (one shorter than the 8-slot
     grid), under SyntheticVideoText's names; (b) `oatx_torch.cli.extract`
     with --detector roi_backbone on local_region_loss.json's tower
     (ViT-B/16 at 224², bf16, random weights from seed 0), EXTRACT_WORKERS
     threads, EXTRACT_REGIONS regions: 64 frames, 12 launches of kernels 1
     and 2 a frame (counted around the call: `launches_by_phase["extract"]`),
     every .npz's x (10, 2048) finite and exactly 0 from column 768 on, its
     bbox inside the frame, its info complete; (c) the same run through the
     plain versions (no launch): each region's features within cosine
     E2E_MIN_COSINE; (d) a second run writes nothing and skips every clip,
     --missing-only lists none, then after one .npz is deleted exactly that
     clip, whose loss list run with --overwrite writes it again (the same
     boxes, features within the same cosine); (e) --detector torch on
     BoxColour, scripted in the phase, on the card through the CLI against
     the same module on the CPU through extract_dataset, every file within
     EXTRACT_TORCH_ATOL; (f) local_region_loss.json's loader
     (SyntheticVideoText over the clips, object_dir the extracted tree,
     strict loading) and Trainer at EXTRACT_TRAIN_BATCH, EXTRACT_TRAIN_STEPS
     counted steps (`launches_by_phase["extract_train"]`, as want_launches
     derives with two streams): every loss term finite; (g) printed: frames/s
     of (b) and of the same run on one worker, device busy ms a frame from a
     CUDA-only trace of EXTRACT_TRACED_FRAMES frames through one extractor
     (warmed, and run before (b): a process's first use of the card's
     libraries falls there), the idle share of (b)'s pool and of one thread,
     the phase's seconds.
 15. viz — visualization and region maps (cli/visualize.py,
     visualization/*, utils/html_viz.py, eval/retrieval_eval.
     export_region_maps, utils/profiler.py, cli/average_checkpoints.py).
     (a) `oatx_torch.cli.visualize --backbone tower` on
     configs/ft/msrvtt/zsl/normal.json as shipped (ViT-B/16 at 224²,
     DistilBERT, bf16) from a port snapshot of its seed-0 towers (-r), one
     MJPEG clip of the port's writer and VIZ_CAPTION: 12 + 12 launches of
     kernels 1 and 2 (counted around the call: `launches_by_phase["viz"]`),
     the projected patches (196, 256) within VIZ_MIN_COSINE of the same
     forward through the plain versions, one PNG a heuristic noun, each 448
     × 274 by the port's PNG reader; the 1-frame forward's host ms and
     device busy ms (VIZ_TIMED_FORWARDS, a CUDA-only trace); (b) `--backbone
     clip` from a random CLIP ViT-B/16 state_dict (visual side by
     `convert.clip_vision_to_torch`, the text side the port's ClipText's)
     and a synthetic BPE table, f32, on the card and on the CPU: patches
     (196, 512), finite, within VIZ_CLIP_TOL of the CPU's; (c)
     `oatx_torch.cli.test` on configs/pt/webvid/region_mem.json as shipped
     with `"visualizer": {"type": "RetrievalVis"}`, over VIZ_REGION_CLIPS
     WebVid-layout clips, their 8_frame_object files from `cli.extract
     --detector stub` and phase 8's seeded (1600, 512) bank from
     `cli.build_region_memory`: launches as derived (evaluate's chunks of 8
     and one export forward a batch, each of the clip and the object
     frame), one 672 × 224 region map a sample, the gallery listing every
     caption with its top 5, the region logits within VIZ_MIN_COSINE of
     the same export through the plain versions, and
     `plots.tsne_embedding_plot` of its eval embeddings (clips and captions,
     labels 0 and 1; the port's numpy t-SNE): a 720 × 720 PNG holding both
     labels' tab10 colours; (d) the 1-frame forward
     under `profiler.trace`, once bare and once under
     `annotate("viz_tower")`: `summarize_trace` names kernels 1 and 2 and
     `summarize_by_source` puts the annotated forward's 24 of them under
     viz_tower; `memory_summary` has cuda0_mem_mb; (e) `cli.
     average_checkpoints` of (a)'s seed-0 and seed-1 snapshots is exactly
     their f64 mean cast back. The phase's seconds close its line.
 16. optim — the optimizer families (train/optim.py: Adafactor, Lion,
     momentum SGD, each as oatx's optax chain computes it). norm.json at
     full width and depth (ViT-B/16 over 4 × 224², DistilBERT-base, bf16)
     through Trainer.train() under each of OPTIM_FAMILIES at norm.json's lr
     2e-4, at its batch of 16 over OPTIM_CLIPS clips (the same clips every
     step), OPTIM_EPOCHS epochs of OPTIM_LEN_EPOCH steps, a snapshot after
     epoch 1: launches as want_launches derives, every loss finite and the
     mean of the last 2 below the first 2's; the held state (parameters,
     gradients, the family's state) exactly sharding.state_bytes(kind=...);
     the first step's gradients (at the weights before any update, the same
     seed-0 init for every family) through the kernels against the plain
     versions by grad_check and phase 5's bars (family_grads), and the
     update alone on them timed (update_ms: OPTIM_UPDATE_REPS steps;
     beside Adafactor's, an AdamW's over the same parameters); the
     snapshot resumed (resume_epoch2): the state bitwise, the later
     epochs' loss terms again within RESUME_LOSS_RTOL, a
     CUDA-only trace of 2 of its steps (idle share). Then vit_huge_pod.json
     (ViT-H/14 at 8 as 2 × 4, dots_all, model_parallel 1) under Adafactor
     for OPTIM_HUGE_STEPS steps: launches, finite terms, held bytes exactly
     state_bytes, the peak device memory and step ms printed beside phase
     9's AdamW run of the same recipe (with --only-optim: "not measured in
     this run"). Phases 11 and 12 run the families' sharded layouts.
 17. finetune — configs/ft/msrvtt/fine_tune/normal_1_cl.json as shipped
     (ViT-B/16 over 4 × 224² + DistilBERT-base, bf16, batch 64, AdamW at
     3e-5, init_val) through `oatx_torch.cli.train`, its arch.load_checkpoint
     pointed at a port snapshot of norm.json (phase 5's checkpoint-epoch1
     when it ran in this process, else a seed-0 one from save_checkpoint),
     over an MSR-VTT jsfusion layout of the port's writer (FT_TRAIN_CLIPS
     train clips, FT_TEST_CLIPS test clips of FT_FRAMES frames): one epoch of
     FT_STEPS steps (trainer.len_epoch; the loader cycles), validation on
     the test clips: the imported weights bitwise the snapshot's before step
     1, every loss term finite, launches as want_launches derives (12 + 12
     + 12 a step, 12 + 12 a validation forward), the weights moved, step ms
     (step 2), clips/s, MFU, peak GiB, the idle share of a CUDA-only trace
     of the last 2 steps; the snapshot, vocab.txt and config.json written.
     Then the fine-tuned `<save_dir>/checkpoint-epoch1` served through
     `cli.serve -r` (build_service, a localhost port): /embed_video of the
     test clips and /embed_text of their captions, counted (12 + 12
     launches a video forward), each row within E2E_MIN_COSINE of
     `cli.build_index` on the same snapshot (evaluate's embeddings), whose
     launches are counted too.
 18. decode — H.264 in mp4 (WebVid's and MSR-VTT's codec) through the
     reader on the card: the host demuxer (native/mp4.cpp), the port's own
     host decoder (native/h264.h: CAVLC I and P slices) and the NV12 → RGB
     kernel (csrc/nvdec.cu, ops/kernels/nv12_rgb.py), over the committed
     fixtures of tests/torch_h264/. First NVDEC's caps for 8-bit 4:2:0
     H.264 (or the driver's refusal, which must be the one observed:
     cuvidGetDecoderCaps returning CUDA_ERROR_OUT_OF_MEMORY where the
     container withholds the driver's video capability), each fixture's
     probe and whole-clip plan against oatx's stored probe. Then every
     digest-stored fixture — CAVLC (cavlc.mp4: 596×336 High, 8×8 transform,
     3 references, weighted prediction, 4 slices; cbase.mp4: 320×240
     Constrained Baseline, constrained intra; cfour.mp4: 4 frames;
     cpcm.mp4: I_PCM) and CABAC / B (high.mp4 / four.mp4 from oatx's
     transcode; cmed.mp4 x264's default preset; ctemp.mp4 temporal direct;
     cbcavlc.mp4 CAVLC B; cpcmb.mp4 I_PCM in CABAC; cidc1.mp4
     cabac_init_idc 1; copen.mp4 an open GOP) — at every frame and stored
     short side (0 / 224 / 256) equal to oatx's SHA-256 and channel means,
     the 'rand' / 'uniform' samples and past the end equal to the
     every-frame decode, one nv12_rgb launch a read; base.mp4 / one.mp4
     equal to oatx's stored frames. The kernel against its
     plain version on the host decoder's NV12 pictures, equal (integer
     arithmetic), with ms, plain ms and the bytes bound at each shape.
     NVDEC, called directly (the reader does not go there): where refused,
     each of its fixtures raises UnsupportedMedia with the observed
     refusal; where it opens, its fixtures against oatx's stored frames
     within the reader test's bounds (unverified glue: data/nvdec.py).
     `cli.train` on norm.json's WebVid loader for DECODE_TRAIN_STEPS steps
     over a WebVid layout of four.mp4 / cmed.mp4 copies (finite losses,
     launches counted: nv12_rgb at least once a clip read; each frame of
     the first batch equal to the canonical square of a digest-verified
     frame of its clip, in order). The read rate: ms a clip of read_frames
     over cavlc.mp4 (CAVLC) and high.mp4 (CABAC, B) on 1 and 8 threads
     beside the MJPEG host decoder's, and the host decoder's frames/s per
     thread alone.
In the run without arguments phases 10-13 overlap: their kernels are timed
first, alone; then their gloo rank groups run RANK_GROUPS_AT_ONCE at a time
while this process takes the phases' one-process references (so those
references' step ms are taken beside the ranks, not alone), and each phase
holds its ranks' records against them once they exit. A `chip_smoke lap`
line after each step gives its seconds; the line "chip_smoke seconds by
step" gathers them before the record.
The last line is {"ok": true, "device": {...}}; the line before it holds the
per-kernel JSON record.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import ctypes
import dataclasses
import gc
import hashlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "configs", "ft", "msrvtt", "zsl", "normal.json")
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# Kernel vs plain version, both bf16 on the card, elementwise
# |got - want| <= atol + BF16_RTOL * |want|. The two round to bf16 at the same
# points (z and h in ln_mlp, p in space_attention, then the output) from f32
# sums taken in another order. So an output may land one bf16 ulp apart
# (at most 2^-7 * |want|), and a rounding of z, h or p that lands the other
# way reaches the output as an absolute error well below one ulp at the
# output's typical size: atol, set per kernel from that size.
BF16_RTOL = 2.0 ** -7
# ln_mlp's output at these inputs has rms 0.37 and max 1.9 on an H100 (fc2
# sums 3072 GELU values times N(0, 0.02²) weights); atol is 0.8 % of the rms.
# Observed: max_abs_err 7.8e-3 (one ulp at 1.9), 0.79 of the tolerance at
# atol 2e-3.
LN_MLP_ATOL = 3e-3
# space_attention's output is a softmax-weighted mean of ~197 N(0, 1) rows:
# rms 0.12, max 0.94 on an H100; atol is 0.9 % of the rms. Observed:
# max_abs_err 1.95e-3, 0.91 of the tolerance at atol 5e-4.
SPACE_ATTENTION_ATOL = 1e-3
# ln_linear's output at these inputs (LN(x) rows of 768 times N(0, 0.02²)
# weights, plus a bias) has rms ≈ 0.56; both versions sum the same bf16
# products in f32, so only a flipped bf16 rounding of z or of the output
# separates them: atol 2e-3, 0.4 % of the rms.
LN_LINEAR_ATOL = 2e-3
# Served embedding (12 blocks, bf16) vs the same model with the plain versions
# on the card: the per-layer differences above compound through depth.
E2E_MIN_COSINE = 0.999
TRAIN_BATCH = 8        # bench.py:83-85: batch 8, 4 frames, seq_len 24
TRAIN_SEQ = 24
TRAIN_STEPS = 10       # counted steps per fused_qkv setting (the loss must fall)
TIME_WINDOWS = 5       # timed windows after them; the first is dropped
WINDOW_STEPS = 5       # steps per timed window
PROFILED_STEPS = 2
TOP_OTHER = 8          # largest "other" kernels listed in a train step's trace
# One step's gradients through the kernels vs through the plain versions on
# the card, same weights and batch (bf16 compute through 12 + 6 layers; the
# two backward passes round at different points): per tensor
# ‖g − r‖ ≤ GRAD_RTOL·‖r‖ + GRAD_ATOL·(global ‖r‖) (grad_check), and the
# global norms' relative difference.
# Measured (NVIDIA H100 80GB HBM3, 700.00 W): the tensors that carry the
# gradient agree to ≤ 4.5 % each (patch_embed.proj.weight, the worst), the
# time branch's to 6-106 % of their own size but ≤ 0.6 % of the global norm;
# global norms within 0.53 %, global cosine ≥ 0.99987.
GRAD_RTOL = 0.1
GRAD_ATOL = 0.02
GRAD_NORM_RTOL = 0.02
GRAD_MIN_GLOBAL_COSINE = 0.999
# fused_qkv on vs off, step 1 from the same weights: the same function with
# the qkv product summed by kernel 3 instead of cuBLAS and its bias added in
# f32 instead of bf16 (zero at init): bf16 roundings only. Measured 8.4e-4
# on an H100.
FUSED_LOSS_RTOL = 1e-2
LAT_REQUESTS = 30      # timed requests per bucket and round, after warm-up
LAT_ROUNDS = 3         # rounds per bucket: the p50's spread inside one call
LAT_WARMUP = 5
PROFILED_REQUESTS = 10
TRACE_ATTEMPTS = 3     # traces of one measurement before lost records fail the run
TRACE_PAD_LAUNCHES = 256  # throwaway launches at either end of a device trace
TRACE_PAD_S = 0.05        # and the wait after them
# device kernels by name, for the per-group breakdown of a video request
KERNEL_GROUPS = (("ln_mlp", ("ln_mlp_",)),
                 ("space_attention_bwd", ("space_attention_bwd", "space_attention_cls_bwd",
                                          "space_attention_cls_key")),
                 ("space_attention", ("space_attention_",)),
                 ("ln_linear", ("ln_linear_kernel",)),
                 ("matmul", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
                 ("softmax", ("softmax",)),
                 ("conv", ("conv", "implicit")),
                 ("memcpy", ("memcpy",)),
                 ("nccl_p2p", ("sendrecv",)),
                 ("nccl", ("nccl",)))


def decode_probe():
    """What the host offers a decoder beyond JPEG on the CPU: nvJPEG's
    header and library, NVDEC's (nvcuvid) header and library, under the CUDA
    toolkit and on the loader's paths (`ldconfig -p`, LD_LIBRARY_PATH)."""
    import glob

    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    incs = [os.path.join(cuda, "include"), os.path.join(cuda, "targets", "x86_64-linux",
                                                        "include"), "/usr/include"]
    libs = [os.path.join(cuda, "lib64"), os.path.join(cuda, "targets", "x86_64-linux", "lib"),
            "/usr/lib/x86_64-linux-gnu", "/usr/lib64", "/usr/local/lib"]
    libs += [d for d in os.environ.get("LD_LIBRARY_PATH", "").split(":") if d]
    try:
        loader = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True,
                                timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        loader = ""

    def found(dirs, pattern):
        return sorted({p for d in dirs for p in glob.glob(os.path.join(d, pattern))})

    return {"nvjpeg.h": found(incs, "nvjpeg.h"),
            "libnvjpeg": found(libs, "libnvjpeg.so*") + re.findall(r"libnvjpeg\.so\S*", loader),
            "nvcuvid.h": found(incs, "nvcuvid.h") + found(incs, "cuviddec.h"),
            "libnvcuvid": found(libs, "libnvcuvid.so*")
            + re.findall(r"libnvcuvid\.so\S*", loader)}


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


T_START = time.perf_counter()
LAPS = [("start", T_START)]  # (label, perf_counter): the run's time budget, step by step


def lap(label):
    """Print the seconds since the previous lap and since the start."""
    LAPS.append((label, time.perf_counter()))
    print(f"chip_smoke lap {label}: {LAPS[-1][1] - LAPS[-2][1]:.1f} s, "
          f"{LAPS[-1][1] - T_START:.1f} s since start", flush=True)


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_report(log):
    """Registers and spill bytes of every kernel in one nvcc -Xptxas -v log,
    e.g. [{"kernel": "ln_linear_kernel", "registers": 168,
    "spill_stores": 36, "spill_loads": 56}]."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            k = re.search(r"\d+([a-z_]+_kernel)(I(?:Li\d+E)+E)?", m.group(1))
            name = k.group(1) if k else m.group(1)
            if k and k.group(2):
                name += "<" + ", ".join(re.findall(r"Li(\d+)E", k.group(2))) + ">"
            cur = {"kernel": name}
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m:
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"] = int(m.group(1))
    return out


def kernel_name(name):
    """The `..._kernel` identifier in a device kernel's name from a trace."""
    m = re.search(r"\w+_kernel", name)
    return m.group(0) if m else name


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want, atol, allow=None):
    """Errors of got against want, and the share of the tolerance used.
    `allow`, a per-element term added to atol + BF16_RTOL·|want| (kernel 2's
    p rounding, space_attention_flip_allowance), also gives the share of the
    tolerance without it (`tol_used_bare`, measured, not checked)."""
    want = want.float()
    err = (got.float() - want).abs()
    bare = atol + BF16_RTOL * want.abs()
    rec = {"max_abs_err": float(err.max()),
           "max_rel_err": float((err / want.abs().clamp_min(1e-3)).max()),
           "tol_used": float((err / (bare if allow is None else bare + allow)).max()),
           "ref_rms": float(want.square().mean().sqrt()),
           "ref_max": float(want.abs().max()), "atol": atol}
    if allow is not None:
        rec["tol_used_bare"] = float((err / bare).max())
        rec["allow_max"] = float(allow.max())
    if not rec["tol_used"] <= 1 or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: outside |err| <= {atol} + {BF16_RTOL}·|ref|"
                             f"{'' if allow is None else ' + allow'} "
                             f"(or non-finite output): {rec}")
    return rec


# one 224² frame (cli.extract's roi_backbone); serving buckets 1 and 4; the
# object-aware recipes' object frame at batch 16 (16·197); bucket 16's halves
# and the train step; pod_v5p on one card (16 clips of 16 frames: 16·3137)
# and MSR-VTT fine-tuning (phase 17: 64 clips of 4 frames, 64·785)
LN_MLP_ROWS = (197, 785, 1576, 3140, 3152, 6280, 50192, 50240)
LN_MLP_RECORD_ROWS = 3140        # the record's ms, errors and bound
LN_MLP_PLAIN_ROWS = (197, 1576, 3140, 6280, 50192, 50240)  # where the plain is timed too
LN_MLP_SPLITS = (1, 2, 3, 6)     # K ranges of the second product, timed at each R
LN_MLP_SPLIT_ROWS = 6280         # the largest R of that sweep (the new rows: the rule's split)
LN_MLP_EXPECT = (("ln_mlp_", 1),)  # device kernels a call launches at least (device_trace)


def load_parent_ln_mlp(path):
    """The library at `path`, built from an earlier csrc/ln_mlp.cu with the
    one-kernel C interface ln_mlp_fwd_bf16(x, gamma, beta, w1, b1, w2, b2, y,
    R, K, H, N, eps, stream), as a drop-in for ln_mlp's `_launch`."""
    lib = ctypes.CDLL(os.path.abspath(path))
    f = lib.ln_mlp_fwd_bf16
    f.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    f.restype = ctypes.c_int

    def launch(x2, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, eps):
        dev, f32, bf = x2.device, torch.float32, torch.bfloat16
        args = [x2.contiguous(), ln_w.to(f32).contiguous(), ln_b.to(f32).contiguous(),
                fc1_w.to(bf).contiguous(), fc1_b.to(f32).contiguous(),
                fc2_w.to(bf).contiguous(), fc2_b.to(f32).contiguous()]
        y = torch.empty((x2.shape[0], fc2_w.shape[0]), dtype=bf, device=dev)
        err = f(*[a.data_ptr() for a in args], y.data_ptr(), x2.shape[0], x2.shape[1],
                fc1_w.shape[0], fc2_w.shape[0], float(eps),
                torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"parent ln_mlp: CUDA error {err}")
        return y

    return launch


@contextlib.contextmanager
def ln_mlp_library(parent):
    """ln_mlp's Function launches `parent` instead of its own kernels (None:
    its own)."""
    from oatx_torch.ops.kernels import ln_mlp as plm

    saved = plm._launch
    if parent is not None:
        plm._launch = parent
    try:
        yield
    finally:
        plm._launch = saved


def kernel_ln_mlp(dev, g, parent=None):
    """Kernel 1 at each of LN_MLP_ROWS (ViT-B/16's MLP, 768 → 3072 → 768):
    errors against the plain version, ms, bound, library ms and TFLOP/s; ms
    at each split of the second product (stage B); with `parent`, the
    parent's errors and ms in turns (parent, this, this, parent). The
    record's top-level numbers are those at LN_MLP_RECORD_ROWS."""
    from oatx_torch.ops.kernels import ln_mlp as plm

    D, H = 768, 3072
    bf = torch.bfloat16
    xs = torch.randn(max(LN_MLP_ROWS), D, device=dev, generator=g).to(bf)
    gamma = 1 + 0.1 * torch.randn(D, device=dev, generator=g)
    beta = 0.1 * torch.randn(D, device=dev, generator=g)
    w1 = (0.02 * torch.randn(H, D, device=dev, generator=g)).to(bf)
    b1 = 0.02 * torch.randn(H, device=dev, generator=g)
    w2 = (0.02 * torch.randn(D, H, device=dev, generator=g)).to(bf)
    b2 = 0.02 * torch.randn(D, device=dev, generator=g)
    gb, bb, b1b, b2b = (t.to(bf) for t in (gamma, beta, b1, b2))
    by_rows = {}
    for R in LN_MLP_ROWS:
        x = xs[:R]
        args = (x, gamma, beta, w1, b1, w2, b2, 1e-6)
        got = plm.ln_mlp(*args)
        torch.cuda.synchronize()
        want = plm.ln_mlp_plain(*args)
        rec = check_close(f"ln_mlp R={R}", got, want, LN_MLP_ATOL)

        def library():
            z = F.layer_norm(x, (D,), gb, bb, 1e-6)
            return F.linear(F.gelu(F.linear(z, w1, b1b)), w2, b2b)

        nbytes = 2 * R * D * 2 + 2 * D * H * 2 + (2 * D + H + D) * 4
        flops = 2 * R * D * H * 2
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops)
        rec["flops"] = flops
        call = lambda: plm.ln_mlp(*args)  # noqa: E731
        rec["ms"] = time_ms(call)
        # the same calls' device busy time, without the host's gaps that
        # events count where a call's host work outlasts its kernels, and
        # its device kernels' ms (up, down or part + sum)
        busy, _, _, kernels = device_trace(call, 20, top_of="ln_mlp", expect=LN_MLP_EXPECT)
        rec["device_ms"] = busy
        rec["device_ms_by_kernel"] = {kernel_name(k): v for k, v in kernels}
        rec["library_ms"] = time_ms(library)
        rec["library_device_ms"] = device_trace(library, 20)[0]
        rec["tflops"] = flops / rec["ms"] / 1e9
        rec["split_rule"] = plm._down_split(R, H, D, torch.cuda.get_device_properties(dev)
                                            .multi_processor_count)
        # stage B: each split of the second product in place of
        # `_down_split`'s choice, launched without the autograd.Function
        # (events, device busy)
        splits, rule = {}, plm._down_split
        fn = lambda: plm._launch(*args)  # noqa: E731
        try:
            for sp in LN_MLP_SPLITS if R <= LN_MLP_SPLIT_ROWS else ():
                plm._down_split = lambda *_, sp=sp: sp
                check_close(f"ln_mlp R={R} split={sp}", fn(), want, LN_MLP_ATOL)
                splits[sp] = (time_ms(fn), device_trace(fn, 20, expect=LN_MLP_EXPECT)[0])
        finally:
            plm._down_split = rule
        rec["ms_by_split"] = {sp: t[0] for sp, t in splits.items()}
        rec["device_ms_by_split"] = {sp: t[1] for sp, t in splits.items()}
        if R in LN_MLP_PLAIN_ROWS:
            rec["plain_ms"] = time_ms(lambda: plm.ln_mlp_plain(*args), iters=5)
        if parent is not None:
            with ln_mlp_library(parent):
                perr = check_close(f"ln_mlp R={R} (parent)", plm.ln_mlp(*args), want,
                                   LN_MLP_ATOL)
            turns, busy = [], []
            for lib in (parent, None, None, parent):
                with ln_mlp_library(lib):
                    turns.append(time_ms(call))
                    busy.append(device_trace(call, 20, expect=LN_MLP_EXPECT)[0])
            rec["parent"] = {"ms_turns": turns, "device_ms_turns": busy,
                             "max_abs_err": perr["max_abs_err"], "tol_used": perr["tol_used"]}
        by_rows[R] = rec
    top = by_rows[LN_MLP_RECORD_ROWS]
    return {
        "name": "ln_mlp", "route": "cuda", "source": "oatx_torch/csrc/ln_mlp.cu",
        "replaces": "oatx/ops/pallas/ln_mlp.py:98",
        **{k: top[k] for k in ("max_abs_err", "max_rel_err", "tol_used", "ref_rms",
                               "ref_max", "atol", "ms", "plain_ms", "bound_ms", "bound_by",
                               "flops", "library_ms")},
        "by_rows": {R: {k: v for k, v in r.items() if k != "flops"}
                    for R, r in by_rows.items()},
        "shape": f"x ({LN_MLP_RECORD_ROWS}, {D}) bf16, hidden {H}",
    }


# (batch, frames): serving bucket 1, bucket 4 (the record), bucket 16's halves
# and the train step at 4 frames; the object-aware recipes' 1-frame object
# frame at their batch of 16 (T = 197); one 224² frame (cli.extract's
# roi_backbone, cli.visualize); region_mem's eval chunk of 8 object frames
# (cli.test); pod_v5p on one card (16 clips of 16 frames, T = 3137) and
# MSR-VTT fine-tuning's batch of 64 (phase 17)
SA_SHAPES = ((1, 4), (4, 4), (8, 4), (16, 1), (1, 1), (8, 1), (16, 16), (64, 4))
SA_RECORD_BATCH = 4       # the record's ms, errors and bound (serving bucket 4)
SA_PLAIN_SHAPES = ((SA_RECORD_BATCH, 4), (1, 1), (8, 4), (8, 1), (16, 16),
                   (64, 4))  # where the plain version is timed too
SA_SPLITS = (1, 2, 3, 4)  # blocks per frame group, timed at each batch (--sweep-query-splits)
SA_FWD_EXPECT = (("space_attention_kernel", 1),)
SA_BWD_EXPECT = (("space_attention_cls_bwd_kernel", 1), ("space_attention_bwd_kernel", 1),
                 ("space_attention_cls_key_kernel", 1))
SA_FWD_BWD_EXPECT = SA_FWD_EXPECT + SA_BWD_EXPECT
SA_TAIL_DRAWS = 40        # more draws at the record batch, each checked
# Kernel 2 and its plain version round p to bf16 from f32 values that differ
# a little (S summed in another order, another exp): where a p lies that
# close to a bf16 rounding boundary the two round it to neighbouring values,
# and the output moves by ulp(p)·|v|, over atol once p ≥ 1/8 and |v| ≳ 2
# (the WMMA kernel before it too). space_attention_flip_allowance adds that term for
# exactly those p, from a bound on how far either version's f32 p can lie
# from the exact one: per f32 addition a relative 2^-23 of the running sum
# (round to nearest gives 2^-24; the tensor cores' truncating adders 2^-23),
# 2^-21 for either version's exp (the SFU's 2^x: 2 ulps).
SA_ADD_ERR = 2.0 ** -23
SA_EXP_ERR = 2.0 ** -21
# Backward kernels vs autograd of the plain version, both bf16 on the card,
# per gradient tensor by relative L2 error: the plain version rounds dP to
# bf16 (the cast of p), the kernels round dS and P for their products; as
# tests/test_torch_cuda.py's GRAD_REL.
SA_GRAD_REL = 2e-2


def load_parent_space_attention(path):
    """The library at `path`, built from an earlier csrc/space_attention.cu
    with the Dh-64 C interface (space_attention_fwd_bf16: 6 pointers, 12
    strides, B, T, H, F, split, stream; space_attention_bwd_bf16: 9
    pointers, 15 strides, B, T, H, F, stream; Dh 64 only), set up to stand
    in for this tree's library in space_attention's `_lib()`: its forward
    and its backward kernels then run under this tree's wrapper."""
    lib = ctypes.CDLL(os.path.abspath(path))
    fwd, bwd = lib.space_attention_fwd_bf16, lib.space_attention_bwd_bf16
    fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 15 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int

    def dh64(fn):
        def call(*args):  # (..., head_dim, stream) -> (..., stream)
            if args[-2] != 64:
                raise ValueError(f"the parent space_attention takes Dh 64, got {args[-2]}")
            return fn(*args[:-2], args[-1])
        return call

    return types.SimpleNamespace(
        space_attention_fwd_bf16_hd=dh64(fwd), space_attention_bwd_bf16_hd=dh64(bwd),
        max_tokens=lib.space_attention_max_tokens(),
        oatx_cuda_error_string=lib.oatx_cuda_error_string)


def space_attention_plain_vjp(q, k, v, dout, num_frames):
    """Autograd of space_attention_plain: the backward before the kernels."""
    from oatx_torch.ops.kernels.space_attention import space_attention_plain

    with torch.enable_grad():
        leaves = [a.detach().requires_grad_() for a in (q, k, v)]
        return torch.autograd.grad(space_attention_plain(*leaves, num_frames), leaves, dout)


@contextlib.contextmanager
def space_attention_library(parent):
    """space_attention's Function launches `parent`'s forward and backward
    kernels (load_parent_space_attention) instead of its own (None: its
    own)."""
    from oatx_torch.ops.kernels import space_attention as psa

    saved = psa._lib
    if parent is not None:
        psa._lib = lambda: parent
    try:
        yield
    finally:
        psa._lib = saved


def _rel_l2(got, want):
    return [float((a.double() - b.double()).norm() / b.double().norm())
            for a, b in zip(got, want)]


def grad_errors(name, got, want, exact):
    """Per-tensor relative L2 error of (dq, dk, dv) against the plain VJP,
    checked; and, measured, of both against `exact`, the VJP of the same
    function in f64 with p unrounded (`grad_rel_exact`): how far each
    version's bf16 roundings take it from the exact gradient."""
    rel = _rel_l2(got, want)
    rec = {"max_abs_err": max(float((a.float() - b.float()).abs().max())
                              for a, b in zip(got, want)),
           "grad_rel": dict(zip("qkv", rel)), "tol_used": max(rel) / SA_GRAD_REL,
           "grad_rel_tol": SA_GRAD_REL,
           "grad_rel_exact": {"kernel": dict(zip("qkv", _rel_l2(got, exact))),
                              "plain": dict(zip("qkv", _rel_l2(want, exact)))}}
    if not rec["tol_used"] <= 1 or not all(bool(torch.isfinite(a).all()) for a in got):
        raise AssertionError(f"{name}: relative L2 error above {SA_GRAD_REL} "
                             f"(or non-finite gradient): {rec}")
    return rec


def _flip_weight(s, a, dh):
    """ulp(p) of each p = softmax(s) (f64 logits, keys last) that lies within
    either version's error bound of a bf16 rounding boundary, else 0. `a` is
    Σ_d |q_d·k_d| per logit, which bounds the error of an f32 sum of S."""
    p = torch.softmax(s, dim=-1)
    m = s.abs().amax(-1, keepdim=True)
    r = s.amax(-1, keepdim=True) - s.amin(-1, keepdim=True)
    # relative error of either version's f32 p: S of this key and of the
    # others (through the sum), the exp's argument (≤ 2 roundings of |s - m|,
    # |m|) and the exp, numerator and sum, then the sum and the division
    delta = (2 * dh * SA_ADD_ERR * a.amax(-1, keepdim=True)
             + 2 * (2 * SA_ADD_ERR * (m + r) + SA_EXP_ERR)
             + (s.shape[-1] + 1) * SA_ADD_ERR)
    # p's bf16 neighbours below and above (f32 holds every bf16 midpoint)
    lo = p.float().view(torch.int32) & -65536
    hi = (lo + 65536).view(torch.float32).double()
    lo = lo.view(torch.float32).double()
    return torch.where((p - (lo + hi) / 2).abs() <= delta * p, hi - lo, 0.0)


def space_attention_flip_allowance(q, k, v, num_frames):
    """Per output element of kernel 2, Σ_j ulp(p_j)·|v_j| over the p_j that
    the kernel and the plain version may round to bf16 to neighbouring values
    (_flip_weight), in f32: the term added to SPACE_ATTENTION_ATOL +
    2^-7·|ref| where those roundings move the output."""
    b, t, h, dh = q.shape
    f = num_frames
    n = (t - 1) // f
    qd, kd, vd = (a.double() for a in (q, k, v))
    qc = qd[:, :1]
    cls = torch.einsum("bhqk,bkhd->bqhd", _flip_weight(
        torch.einsum("bqhd,bkhd->bhqk", qc, kd),
        torch.einsum("bqhd,bkhd->bhqk", qc.abs(), kd.abs()), dh), vd.abs())

    def group(a):
        return torch.cat([a[:, None, :1].expand(b, f, 1, h, dh),
                          a[:, 1:].reshape(b, f, n, h, dh)], dim=2)

    qp, kg = qd[:, 1:].reshape(b, f, n, h, dh), group(kd)
    out = torch.einsum("bfhqk,bfkhd->bfqhd", _flip_weight(
        torch.einsum("bfqhd,bfkhd->bfhqk", qp, kg),
        torch.einsum("bfqhd,bfkhd->bfhqk", qp.abs(), kg.abs()), dh), group(vd.abs()))
    return torch.cat([cls, out.reshape(b, f * n, h, dh)], dim=1).float()


def space_attention_tail(dev, parent=None):
    """Kernel 2 over SA_TAIL_DRAWS more draws (seeds 0..) at the record
    batch, each checked against the plain version within SPACE_ATTENTION_ATOL
    + 2^-7·|ref| + space_attention_flip_allowance; with `parent`, the
    parent's errors on the same draws, measured, not checked. Returns per
    version the largest share of the tolerance per draw, with the allowance
    and without it (`bare_*`)."""
    from oatx_torch.ops.kernels import space_attention as psa

    B, Fr, T = SA_RECORD_BATCH, 4, 785
    used = {"this": [], "parent": []}
    for seed in range(SA_TAIL_DRAWS):
        g = torch.Generator(dev).manual_seed(seed)
        qkv = torch.randn(B, T, 3, 12, 64, device=dev, generator=g).to(torch.bfloat16)
        q, k, v = qkv[:, :, 0] * 0.125, qkv[:, :, 1], qkv[:, :, 2]
        want = psa.space_attention_plain(q, k, v, Fr).float()
        allow = space_attention_flip_allowance(q, k, v, Fr)
        bare = SPACE_ATTENTION_ATOL + BF16_RTOL * want.abs()
        for name, lib in (("this", None), ("parent", parent)):
            if name == "parent" and parent is None:
                continue
            with space_attention_library(lib):
                got = psa.space_attention(q, k, v, Fr)
            if name == "this":
                check_close(f"space_attention tail draw {seed}", got, want,
                            SPACE_ATTENTION_ATOL, allow)
            err = (got.float() - want).abs()
            used[name].append((float((err / (bare + allow)).max()), float((err / bare).max())))
    return {name: {"draws": len(u), "over_1": sum(x > 1 for x, _ in u),
                   "max": max(x for x, _ in u), "median": float(np.median([x for x, _ in u])),
                   "bare_over_1": sum(y > 1 for _, y in u), "bare_max": max(y for _, y in u)}
            for name, u in used.items() if u}


def sdpa_inputs(q, k, v, frames):
    """Kernel 2's yardstick's inputs: SDPA over the (B·F, H, N, N + 1) frame
    groups plus the CLS row over all T keys, gathered into its layout
    beforehand (not timed)."""
    b, t, h, dh = q.shape
    n = (t - 1) // frames
    qh, kh, vh = (a.permute(0, 2, 1, 3) for a in (q, k, v))  # (B, H, T, Dh)

    def groups(a):
        p = a[:, :, 1:].reshape(b, h, frames, n, dh).permute(0, 2, 1, 3, 4)
        return p.reshape(b * frames, h, n, dh)

    def with_cls(a):
        c = a[:, :, :1].unsqueeze(1).expand(b, frames, h, 1, dh).reshape(b * frames, h, 1, dh)
        return torch.cat([c, groups(a)], dim=2).contiguous()

    return [groups(qh).contiguous(), with_cls(kh), with_cls(vh),
            qh[:, :, :1].contiguous(), kh.contiguous(), vh.contiguous()]


def sdpa(lib_in):
    """The yardstick: one SDPA call over the frame groups, one over the CLS row."""
    return (F.scaled_dot_product_attention(*lib_in[:3], scale=1.0),
            F.scaled_dot_product_attention(*lib_in[3:], scale=1.0))


def sdpa_backward_ms(lib_in):
    """SDPA's backward: its forward + backward under autograd, minus its
    forward, by CUDA events and by device busy time."""
    leaves = [t.detach().requires_grad_() for t in lib_in]
    douts = [o.detach().clone() for o in sdpa(lib_in)]
    fb = lambda: torch.autograd.grad(sdpa(leaves), leaves, douts)  # noqa: E731
    f = lambda: sdpa(leaves)  # noqa: E731
    return {"library_ms": time_ms(fb) - time_ms(f),
            "library_device_ms": device_trace(fb, 20)[0] - device_trace(f, 20)[0]}


def sa_key(b, frames):
    """The `by_batch` key of a kernel 2 shape: B at 4 frames, "B_F<frames>"
    at any other count ("16_F1", "16_F16")."""
    return b if frames == 4 else f"{b}_F{frames}"


def kernel_space_attention(dev, g, parent=None, sweep=False):
    """Kernel 2 at each of SA_SHAPES (ViT-B/16 over F frames of 224²: T =
    1 + 196·F, 12 heads): the forward's errors against the plain version, ms,
    device ms, bound, library ms (SDPA) and TFLOP/s, with `sweep` also ms
    at each of SA_SPLITS query splits;
    the backward kernels' errors against autograd of the plain version, ms,
    bound and library ms (SDPA's backward); forward + backward through the
    Function; with `parent`, the parent's errors and times in turns (parent,
    this, this, parent), alone and under forward + backward (the parent
    tree's backward is the plain one). Returns the forward's and the
    backward's records; their top-level numbers are those at
    SA_RECORD_BATCH."""
    from oatx_torch.ops.kernels import space_attention as psa

    N, Hh, Dh = 196, 12, 64
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fwd, bwd = {}, {}
    for B, Fr in SA_SHAPES:
        T = 1 + Fr * N
        tag = f"B={B}" + ("" if Fr == 4 else f" F={Fr}")
        qkv = torch.randn(B, T, 3, Hh, Dh, device=dev, generator=g).to(torch.bfloat16)
        q = qkv[:, :, 0] * Dh ** -0.5  # as ops.attention.qkv_heads gives them
        k, v = qkv[:, :, 1], qkv[:, :, 2]
        got = psa.space_attention(q, k, v, Fr)
        torch.cuda.synchronize()
        want = psa.space_attention_plain(q, k, v, Fr)
        allow = space_attention_flip_allowance(q, k, v, Fr)
        rec = check_close(f"space_attention {tag}", got, want, SPACE_ATTENTION_ATOL, allow)

        lib_in = sdpa_inputs(q, k, v, Fr)
        library = lambda: sdpa(lib_in)  # noqa: E731
        nbytes = 4 * B * T * Hh * Dh * 2
        flops = 2 * 2 * B * Hh * (T + Fr * N * (N + 1)) * Dh
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops)
        rec["flops"] = flops
        call = lambda: psa.space_attention(q, k, v, Fr)  # noqa: E731
        rec["ms"] = time_ms(call)
        rec["device_ms"] = device_trace(call, 20, expect=SA_FWD_EXPECT)[0]
        rec["library_ms"] = time_ms(library)
        rec["library_device_ms"] = device_trace(library, 20)[0]
        rec["tflops"] = flops / rec["ms"] / 1e9
        rec["device_tflops"] = flops / rec["device_ms"] / 1e9
        rec["split_rule"] = psa._query_split(B * Fr * Hh, -(-N // 16), sms)
        if sweep:
            splits, rule = {}, psa._query_split
            try:
                for sp in SA_SPLITS:
                    psa._query_split = lambda *_, sp=sp: sp
                    check_close(f"space_attention {tag} split={sp}", call(), want,
                                SPACE_ATTENTION_ATOL, allow)
                    splits[sp] = (time_ms(call), device_trace(call, 20, expect=SA_FWD_EXPECT)[0])
            finally:
                psa._query_split = rule
            rec["ms_by_split"] = {sp: t[0] for sp, t in splits.items()}
            rec["device_ms_by_split"] = {sp: t[1] for sp, t in splits.items()}
        if (B, Fr) in SA_PLAIN_SHAPES:
            rec["plain_ms"] = time_ms(lambda: psa.space_attention_plain(q, k, v, Fr), iters=5)

        # the backward kernels alone, from the forward's log-sum-exp
        qd = q.detach()
        _, lse = psa._launch(qd, k, v, Fr, with_lse=True)
        dout = torch.randn(B, T, Hh, Dh, device=dev, generator=g).to(torch.bfloat16)
        bcall = lambda: psa.space_attention_backward(qd, k, v, dout, Fr, lse)  # noqa: E731
        brec = grad_errors(f"space_attention backward {tag}", bcall(),
                           space_attention_plain_vjp(qd, k, v, dout, Fr),
                           space_attention_plain_vjp(*(a.double() for a in (qd, k, v, dout)), Fr))
        # dV, dP, dQ, dK and S recomputed: 5 products of the forward's 2;
        # q, k, v, dO read and dq, dk, dv written once
        bflops = flops * 5 // 2
        brec["bound_ms"], brec["bound_by"] = bound_ms(7 * B * T * Hh * Dh * 2, bflops)
        brec["flops"] = bflops
        brec["ms"] = time_ms(bcall)
        brec["device_ms"] = device_trace(bcall, 20, expect=SA_BWD_EXPECT)[0]
        brec["tflops"] = bflops / brec["ms"] / 1e9
        brec["device_tflops"] = bflops / brec["device_ms"] / 1e9
        if (B, Fr) in ((SA_RECORD_BATCH, 4), (16, 16), (64, 4)):
            brec["plain_ms"] = time_ms(
                lambda: space_attention_plain_vjp(qd, k, v, dout, Fr), iters=5)
        brec.update(sdpa_backward_ms(lib_in))

        # forward + backward through the Function (the train step's use)
        leaf = qkv.detach().requires_grad_()
        fb = lambda: torch.autograd.grad(  # noqa: E731
            psa.space_attention(leaf[:, :, 0] * 0.125, leaf[:, :, 1], leaf[:, :, 2], Fr),
            leaf, dout)
        rec["fwd_bwd_ms"] = time_ms(fb, iters=10)
        rec["fwd_bwd_device_ms"] = device_trace(fb, 5, expect=SA_FWD_BWD_EXPECT)[0]
        if parent is not None:
            with space_attention_library(parent):
                perr = check_close(f"space_attention {tag} (parent)", call(), want,
                                   SPACE_ATTENTION_ATOL, allow)
                pberr = grad_errors(f"space_attention backward {tag} (parent)", bcall(),
                                    space_attention_plain_vjp(qd, k, v, dout, Fr),
                                    space_attention_plain_vjp(*(a.double() for a in
                                                                (qd, k, v, dout)), Fr))
            turns = {"ms": [], "device_ms": [], "bwd_ms": [], "bwd_device_ms": [],
                     "fwd_bwd_ms": [], "fwd_bwd_device_ms": []}
            for lib in (parent, None, None, parent):
                with space_attention_library(lib):
                    turns["ms"].append(time_ms(call))
                    turns["device_ms"].append(device_trace(call, 20, expect=SA_FWD_EXPECT)[0])
                    turns["bwd_ms"].append(time_ms(bcall))
                    turns["bwd_device_ms"].append(device_trace(bcall, 20,
                                                               expect=SA_BWD_EXPECT)[0])
                    turns["fwd_bwd_ms"].append(time_ms(fb, iters=10))
                    turns["fwd_bwd_device_ms"].append(device_trace(fb, 5,
                                                                   expect=SA_FWD_BWD_EXPECT)[0])
            with space_attention_library(parent):
                pout, pgrads = call(), bcall()
            rec["parent"] = {**{f"{k_}_turns": t for k_, t in turns.items()},
                             **{k_: perr[k_] for k_ in ("max_abs_err", "tol_used",
                                                        "tol_used_bare")},
                             "bwd_grad_rel": pberr["grad_rel"],
                             "fwd_bitwise": torch.equal(pout, call()),
                             "bwd_bitwise": all(torch.equal(a, b_) for a, b_ in
                                                zip(pgrads, bcall()))}
        fwd[sa_key(B, Fr)], bwd[sa_key(B, Fr)] = rec, brec
    top, btop = fwd[SA_RECORD_BATCH], bwd[SA_RECORD_BATCH]
    top["tol_tail"] = space_attention_tail(dev, parent)
    # the forward kernel's residency at the record's shape, as launched
    Fr, T = 4, 1 + 4 * N
    lib, blocks, smem = psa._lib(), ctypes.c_int(), ctypes.c_int()
    occ = lib.space_attention_fwd_occupancy_hd
    occ.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    with torch.cuda.device(dev):
        if occ(T, Fr, Dh, ctypes.byref(blocks), ctypes.byref(smem)):
            raise RuntimeError("space_attention_fwd_occupancy_hd failed")
    top["occupancy"] = {"blocks_per_sm": blocks.value, "warps_per_sm": 4 * blocks.value,
                        "smem_bytes_per_block": smem.value}
    shape = f"q/k/v ({SA_RECORD_BATCH}, {T}, {Hh}, {Dh}) bf16, {Fr} frames"
    drop = ("flops",)
    return [{
        "name": "space_attention", "route": "cuda",
        "source": "oatx_torch/csrc/space_attention.cu",
        "replaces": "oatx/ops/pallas/spacetime_attention.py:60",
        **{k_: top[k_] for k_ in ("max_abs_err", "max_rel_err", "tol_used", "tol_used_bare",
                                  "allow_max", "tol_tail", "ref_rms",
                                  "ref_max", "atol", "ms", "device_ms", "plain_ms", "bound_ms",
                                  "bound_by", "flops", "library_ms", "library_device_ms",
                                  "occupancy")},
        "by_batch": {B: {k_: v_ for k_, v_ in r.items() if k_ not in drop}
                     for B, r in fwd.items()},
        "shape": shape,
    }, {
        "name": "space_attention_bwd", "route": "cuda",
        "source": "oatx_torch/csrc/space_attention.cu",
        "replaces": "oatx/ops/pallas/spacetime_attention.py:123",
        **{k_: btop[k_] for k_ in ("max_abs_err", "tol_used", "grad_rel", "grad_rel_tol",
                                   "grad_rel_exact", "ms",
                                   "device_ms", "plain_ms", "bound_ms", "bound_by", "flops",
                                   "library_ms", "library_device_ms")},
        "by_batch": {B: {k_: v_ for k_, v_ in r.items() if k_ not in drop}
                     for B, r in bwd.items()},
        "shape": shape + ", dO bf16",
    }]


def load_parent_ln_linear(path):
    """The library at `path`, built from another csrc/ln_linear.cu with the
    same C interface, set up as ln_linear's `_lib()` sets up its own."""
    lib = ctypes.CDLL(os.path.abspath(path))
    f = lib.ln_linear_fwd_bf16
    f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def ln_linear_library(lib):
    """ln_linear launches `lib`'s kernel instead of its own (None: its own)."""
    from oatx_torch.ops.kernels import ln_linear as pll

    saved = pll._lib
    if lib is not None:
        pll._lib = lambda: lib
    try:
        yield
    finally:
        pll._lib = saved


def kernel_ln_linear(dev, g, parent=None):
    from oatx_torch.ops.kernels.ln_linear import ln_linear, ln_linear_plain

    R, K, N = TRAIN_BATCH * 785, 768, 2304  # the train step's LN→qkv
    bf = torch.bfloat16
    x = torch.randn(R, K, device=dev, generator=g).to(bf)
    gamma = 1 + 0.1 * torch.randn(K, device=dev, generator=g)
    beta = 0.1 * torch.randn(K, device=dev, generator=g)
    w = (0.02 * torch.randn(N, K, device=dev, generator=g)).to(bf)
    b = 0.02 * torch.randn(N, device=dev, generator=g)
    args = (x, gamma, beta, w, b, 1e-6)
    got = ln_linear(*args)
    torch.cuda.synchronize()
    want = ln_linear_plain(*args)
    errs = check_close("ln_linear", got, want, LN_LINEAR_ATOL)
    gb, bb, bbf = (t.to(bf) for t in (gamma, beta, b))

    def library():
        return F.linear(F.layer_norm(x, (K,), gb, bb, 1e-6), w, bbf)

    nbytes = R * K * 2 + N * K * 2 + R * N * 2 + (2 * K + N) * 4
    flops = 2 * R * K * N
    bound, by = bound_ms(nbytes, flops)
    call = lambda: ln_linear(*args)  # noqa: E731
    rec = {
        "name": "ln_linear", "route": "cuda", "source": "oatx_torch/csrc/ln_linear.cu",
        "replaces": "oatx/ops/pallas/ln_linear.py:58", **errs,
        "ms": time_ms(call),
        "device_ms": device_trace(call, 20, expect=(("ln_linear_kernel", 1),))[0],
        "plain_ms": time_ms(lambda: ln_linear_plain(*args), iters=5),
        "bound_ms": bound, "bound_by": by, "flops": flops,
        "library_ms": time_ms(library), "library_device_ms": device_trace(library, 20)[0],
        "shape": f"x ({R}, {K}) bf16 -> ({R}, {N})",
    }
    if parent is not None:
        with ln_linear_library(parent):
            perr = check_close("ln_linear (parent)", ln_linear(*args), want, LN_LINEAR_ATOL)
        turns = []
        for lib in (parent, None, None, parent):
            with ln_linear_library(lib):
                turns.append(time_ms(lambda: ln_linear(*args)))
        rec["parent"] = {"ms_turns": turns, "max_abs_err": perr["max_abs_err"],
                         "tol_used": perr["tol_used"]}
    return rec


def fwd_bwd_ms(dev, g, parent=None):
    """Forward + backward through kernel 3's and kernel 2's autograd.Functions
    at the train step's shapes (B = 8, T = 785: 6280 rows; f32 master
    weights as the model holds them; kernel 1's is ln_mlp_fwd_bwd's, kernel
    2's at B = 1 and 4 kernel_space_attention's): (ms by CUDA events over 10
    iterations after warm-up, which counts the host's gaps between launches;
    device busy ms of one call from a CUDA-only trace of 5, which does not).
    With `parent`, "ln_linear_parent" holds the same through the parent's
    kernel, timed before and after this tree's: ((events ms, events ms),
    device ms)."""
    from oatx_torch.ops.kernels.ln_linear import ln_linear
    from oatx_torch.ops.kernels.space_attention import space_attention

    R, D = TRAIN_BATCH * 785, 768

    def leaf(*shape, scale=1.0, dtype=torch.float32, offset=0.0):
        t = offset + scale * torch.randn(*shape, device=dev, generator=g)
        return t.to(dtype).requires_grad_()

    x = leaf(R, D, dtype=torch.bfloat16)
    ln = (leaf(D, scale=0.1, offset=1.0), leaf(D, scale=0.1))
    qkv = leaf(TRAIN_BATCH, 785, 3, 12, 64, dtype=torch.bfloat16)
    calls = {
        "ln_linear": (ln_linear, (x, *ln, leaf(3 * D, D, scale=0.02),
                                  leaf(3 * D, scale=0.02)), (("ln_linear_kernel", 1),)),
        "space_attention": (lambda t: space_attention(t[:, :, 0] * 0.125, t[:, :, 1],
                                                      t[:, :, 2], 4), (qkv,), SA_FWD_BWD_EXPECT),
    }
    out = {}
    for name, (fn, args, expect) in calls.items():
        dy = torch.randn(fn(*args).shape, device=dev, generator=g).to(torch.bfloat16)
        call = lambda: torch.autograd.grad(fn(*args), args, dy)  # noqa: E731
        if name == "ln_linear" and parent is not None:
            with ln_linear_library(parent):
                before = time_ms(call, iters=10)
        out[name] = time_ms(call, iters=10), device_trace(call, 5, expect=expect)[0]
        if name == "ln_linear" and parent is not None:
            with ln_linear_library(parent):
                out["ln_linear_parent"] = ((before, time_ms(call, iters=10)),
                                           device_trace(call, 5, expect=expect)[0])
    return out


def ln_mlp_fwd_bwd(dev, g, parent=None):
    """Forward + backward through ln_mlp's Function at each of LN_MLP_ROWS
    (f32 master weights, as the model holds them): {R: {"ms": CUDA events
    over 10 calls, "device_ms": device busy of one call from a trace of 5}};
    with `parent`, the same through the parent's kernel, timed before and
    after this tree's ("parent_ms": [before, after], "parent_device_ms")."""
    from oatx_torch.ops.kernels.ln_mlp import ln_mlp

    D, H = 768, 3072

    def leaf(*shape, scale=1.0, dtype=torch.float32, offset=0.0):
        t = offset + scale * torch.randn(*shape, device=dev, generator=g)
        return t.to(dtype).requires_grad_()

    params = (leaf(D, scale=0.1, offset=1.0), leaf(D, scale=0.1), leaf(H, D, scale=0.02),
              leaf(H, scale=0.02), leaf(D, H, scale=0.02), leaf(D, scale=0.02))
    out = {}
    for R in LN_MLP_ROWS:
        args = (leaf(R, D, dtype=torch.bfloat16), *params)
        dy = torch.randn(R, D, device=dev, generator=g).to(torch.bfloat16)
        call = lambda: torch.autograd.grad(ln_mlp(*args), args, dy)  # noqa: E731
        rec = {}
        if parent is not None:
            with ln_mlp_library(parent):
                before = time_ms(call, iters=10)
        rec["ms"] = time_ms(call, iters=10)
        rec["device_ms"] = device_trace(call, 5, expect=LN_MLP_EXPECT)[0]
        if parent is not None:
            with ln_mlp_library(parent):
                rec["parent_ms"] = [before, time_ms(call, iters=10)]
                rec["parent_device_ms"] = device_trace(call, 5, expect=LN_MLP_EXPECT)[0]
        out[R] = rec
    return out


@contextlib.contextmanager
def plain_versions():
    """Route the towers through the kernels' plain versions (reference run;
    autograd differentiates them directly)."""
    from oatx_torch.models import vit_spacetime
    from oatx_torch.ops import attention
    from oatx_torch.ops.kernels.ln_linear import ln_linear_plain
    from oatx_torch.ops.kernels.ln_mlp import ln_mlp_plain
    from oatx_torch.ops.kernels.space_attention import space_attention_plain

    saved = vit_spacetime.ln_mlp, attention.space_attention, attention.ln_linear
    vit_spacetime.ln_mlp = ln_mlp_plain
    attention.space_attention = space_attention_plain
    attention.ln_linear = ln_linear_plain
    try:
        yield
    finally:
        vit_spacetime.ln_mlp, attention.space_attention, attention.ln_linear = saved


def post(url, payload):
    data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def npy_b64(a):
    buf = io.BytesIO()
    np.save(buf, a)
    return base64.b64encode(buf.getvalue()).decode()


def device_records(prof):
    """The profiler's raw device records, (start µs, end µs, name), sorted."""
    return sorted((e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3, e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA
                  and e.duration_ns() > 0)


def busy_union_us(recs):
    """µs covered by the union of the records' intervals."""
    if not recs:
        return 0.0
    busy_us, (cur_s, cur_e) = 0.0, recs[0][:2]
    for s, e, _ in recs[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy_us + cur_e - cur_s


def trace_pad():
    """Throwaway work at either end of a trace (`cuda_trace`)."""
    x = torch.empty(1, device="cuda")
    for _ in range(TRACE_PAD_LAUNCHES):
        x.fill_(1.0)
    torch.cuda.synchronize()
    time.sleep(TRACE_PAD_S)


@contextlib.contextmanager
def cuda_trace(warm=None):
    """A torch.profiler trace of CUDA activity only (no host-side tracing to
    slow the host-bound path) around the block. Late in this script the
    profiler kept no device record of a trace's first launches (some
    tens, whatever the wait before them), and it dropped records near
    either end of a trace whose device timestamps ran milliseconds off the
    host's. So the trace opens with `trace_pad`, `warm` (an untimed call)
    and a marker kernel (ATen's spin_kernel), and closes with a second
    marker and `trace_pad`. Yields a namespace whose `recs`, after the
    block, holds the device records between the markers, or None if a
    marker is missing."""
    from torch.profiler import ProfilerActivity, profile

    out = types.SimpleNamespace(recs=None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trace_pad()
        if warm is not None:
            warm()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)  # the first marker
        torch.cuda.synchronize()
        yield out
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)  # the second marker
        trace_pad()
    recs = device_records(prof)
    marks = [(s, e) for s, e, name in recs if "spin_kernel" in name]
    if len(marks) == 2:
        out.recs = [r for r in recs if marks[0][1] <= r[0] and r[1] <= marks[1][0]]


def device_trace(fn, n, top_of="other", expect=()):
    """Trace n calls of fn (`cuda_trace`, with one untimed call of fn
    first). Returns per call: device busy ms (the union of kernel and copy
    intervals), device activities, device ms by group, and the TOP_OTHER
    largest kernels of the group `top_of` by ms.

    `expect`: (name substring, device kernels per call) pairs; the trace
    must hold at least n times that many kernels of each name, and some
    device activity in any case. A trace that lost records is taken again,
    up to TRACE_ATTEMPTS times, then the call raises, so a lost record
    never shrinks a device time."""
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with cuda_trace(warm=fn) as trace:
            for _ in range(n):
                fn()
        iv = trace.recs or []
        lost = [f"{sum(key in name for _, _, name in iv)} '{key}' kernels of {per_call * n}"
                for key, per_call in expect
                if sum(key in name for _, _, name in iv) < per_call * n]
        if trace.recs is None:
            lost.append("a marker missing")
        elif not iv:
            lost.append("no device activity")
        if not lost:
            break
        print(f"device_trace: attempt {attempt} holds {', '.join(lost)}: records were lost",
              file=sys.stderr, flush=True)
    else:
        raise AssertionError(f"device_trace: every one of {TRACE_ATTEMPTS} traces lost records")
    groups, top = group_ms(iv, n, top_of)
    return busy_union_us(iv) / 1e3 / n, len(iv) / n, groups, top


def group_ms(recs, n, top_of="other"):
    """Device ms per call of n calls' records by KERNEL_GROUPS, and the
    TOP_OTHER largest kernels of the group `top_of` by ms."""
    groups: dict = {}
    other: dict = {}
    for s, e, name in recs:
        low = name.lower()
        g = next((g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)), "other")
        groups[g] = groups.get(g, 0.0) + (e - s) / 1e3 / n
        if g == top_of:
            other[name[:80]] = other.get(name[:80], 0.0) + (e - s) / 1e3 / n
    return groups, sorted(other.items(), key=lambda kv: -kv[1])[:TOP_OTHER]


def bucket_latency(url, svc, payload_v, payload_t, rounds_n=LAT_ROUNDS,
                   requests=LAT_REQUESTS):
    """`rounds_n` rounds of `requests` video + text requests after warm-up;
    each round's service-time percentiles come back from /stats, and the
    client's wall time per video request gives the HTTP layer's share."""
    from oatx_torch.serve.embed_service import LatencyStats

    for _ in range(LAT_WARMUP):
        post(url + "/embed_video", payload_v)
        post(url + "/embed_text", payload_t)
    rounds = []
    for _ in range(rounds_n):
        svc.stats = {"video": LatencyStats(), "text": LatencyStats()}
        wall = []
        for _ in range(requests):
            t0 = time.perf_counter()
            post(url + "/embed_video", payload_v)
            wall.append((time.perf_counter() - t0) * 1e3)
            post(url + "/embed_text", payload_t)
        s = get(url + "/stats")
        if s["video"]["count"] != requests or s["text"]["count"] != requests:
            raise AssertionError(f"/stats counted {s['video']['count']} video, "
                                 f"{s['text']['count']} text requests of {requests}")
        rounds.append({"video_p50_ms": s["video"]["p50_ms"],
                       "video_p90_ms": s["video"]["p90_ms"],
                       "text_p50_ms": s["text"]["p50_ms"],
                       "http_video_p50_ms": float(np.median(wall))})
    rec = {"requests": requests, "rounds": rounds}
    for key in rounds[0]:
        vals = [r[key] for r in rounds]
        mid = float(np.median(vals))
        rec[key] = mid
        rec[key.replace("_ms", "_spread")] = (max(vals) - min(vals)) / mid
    return rec


def finite_matrix(name, rows, shape):
    a = np.asarray(rows, np.float32)
    if a.shape != shape or not np.isfinite(a).all():
        raise AssertionError(f"{name}: got {a.shape} (finite={np.isfinite(a).all()}), "
                             f"want finite {shape}")
    return a


def serve_phase(tmp, smi, record=None):
    from oatx_torch.cli.serve import build_service, make_server
    from oatx_torch.config.schema import ExperimentCfg
    from oatx_torch.ops.kernels.ln_mlp import ln_mlp
    from oatx_torch.ops.kernels.space_attention import space_attention
    from oatx_torch.serve.retrieval_index import RetrievalIndex

    rng = np.random.default_rng(0)
    dim = ExperimentCfg.from_json(CONFIG).arch.projection_dim
    index_path = os.path.join(tmp, "index.npz")
    RetrievalIndex(rng.standard_normal((64, dim)).astype(np.float32),
                   [f"corpus{i}" for i in range(64)], pad_multiple=64,
                   device="cpu").save(index_path)
    t0 = time.perf_counter()
    svc, tok, index, our = build_service(
        ["-c", CONFIG, "--port", "0", "--index", index_path])
    print(f"serve: model built and warmed up (buckets {svc.buckets}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    server = make_server(svc, tok, index, our)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    frames = 4
    try:
        if get(url + "/healthz") != {"status": "ok"}:
            raise AssertionError("/healthz")
        clip1 = rng.integers(0, 256, (1, frames, 256, 256, 3), dtype=np.uint8)
        clip4 = rng.integers(0, 256, (4, frames, 256, 256, 3), dtype=np.uint8)
        texts = ["a man is cooking in a kitchen", "a video", "two dogs play"]

        # ---- the main path, counted ----
        ln_mlp.launches = 0
        space_attention.launches = 0
        svc.tower_calls = {"video": 0, "text": 0}
        e1 = finite_matrix("embed_video b1", post(url + "/embed_video", {
            "video_b64": npy_b64(clip1)})["embeddings"], (1, dim))
        e4 = finite_matrix("embed_video b4", post(url + "/embed_video", {
            "video_b64": npy_b64(clip4)})["embeddings"], (4, dim))
        finite_matrix("embed_text", post(url + "/embed_text", {"texts": texts})[
            "embeddings"], (3, dim))
        r = post(url + "/index_video", {"video_b64": npy_b64(clip4),
                                        "ids": ["new0", "new1", "new2", "new3"]})
        if r != {"indexed": 4, "size": 68}:
            raise AssertionError(f"/index_video: {r}")
        res = post(url + "/search", {"texts": texts[:2], "k": 5})["results"]
        for row in res:
            scores = [h["score"] for h in row]
            if len(row) != 5 or scores != sorted(scores, reverse=True) or \
                    not all(-1 - 1e-5 <= s <= 1 + 1e-5 for s in scores) or \
                    [h["rank"] for h in row] != list(range(5)):
                raise AssertionError(f"/search result not a ranked top-5: {row}")
        stats = get(url + "/stats")
        if stats["index"] != {"size": 68, "dim": dim} or stats["video"]["count"] != 3:
            raise AssertionError(f"/stats: {stats}")
        # per bucket: latency from /stats, then the device trace; the idle
        # share is 1 - device busy / the unprofiled service p50
        perf = {}
        for b in svc.buckets:
            clips = rng.integers(0, 256, (b, frames, 256, 256, 3), dtype=np.uint8)
            payload_v = json.dumps({"video_b64": npy_b64(clips)}).encode()
            payload_t = json.dumps({"texts": (texts * b)[:b]}).encode()
            rec = bucket_latency(url, svc, payload_v, payload_t)
            calls0 = svc.tower_calls["video"]
            post(url + "/embed_video", payload_v)
            per_request = svc.tower_calls["video"] - calls0  # video forwards a request
            for tower, payload in (("video", payload_v), ("text", payload_t)):
                expect = [(key, 12 * per_request) for key in ("space_attention_kernel", "ln_mlp_")
                          if tower == "video"]
                busy, acts, groups, _ = device_trace(
                    lambda: post(f"{url}/embed_{tower}", payload), PROFILED_REQUESTS,
                    expect=expect)
                rec[f"{tower}_device_busy_ms"] = busy
                rec[f"{tower}_idle_share"] = 1 - busy / rec[f"{tower}_p50_ms"]
                rec[f"{tower}_device_activities"] = acts
                if tower == "video":
                    rec["video_device_ms_by_group"] = groups
            perf[b] = rec
            print(f"serve bucket {b} ({smi}): " + json.dumps(rec), flush=True)
        launches = {"ln_mlp": ln_mlp.launches, "space_attention": space_attention.launches}
        forwards = svc.tower_calls["video"]
        # ---- end of the counted run ----
        for name, n in launches.items():
            if forwards == 0 or n != 12 * forwards:
                raise AssertionError(f"{name}: {n} launches for {forwards} video "
                                     "forwards, want 12 per forward")
        print(f"serve: /embed_video b1 {e1.shape} b4 {e4.shape}, /embed_text, "
              f"/index_video, /search top-5 sorted, /stats ok; {forwards} video "
              f"forwards, launches {launches}", flush=True)
        print(f"serve p50 per bucket ({smi}): " + json.dumps({
            b: {k: r[k] for k in ("video_p50_ms", "video_p50_spread", "text_p50_ms",
                                  "text_p50_spread", "video_idle_share")}
            for b, r in perf.items()}), flush=True)

        # the served embedding against the same model on the plain versions
        with plain_versions():
            ref = svc.embed_video(clip1)
        cos = float((e1 * ref).sum() / np.linalg.norm(e1) / np.linalg.norm(ref))
        err = float(np.abs(e1 - ref).max())
        print(f"serve: b1 embedding vs plain versions on the card: cosine {cos:.6f}, "
              f"max_abs_err {err:.3e} (|ref|max {np.abs(ref).max():.3e})", flush=True)
        if not cos >= E2E_MIN_COSINE:
            raise AssertionError(f"served embedding cosine {cos} < {E2E_MIN_COSINE}")
        if record is not None:  # phase 3's p50s, beside which the extras print theirs
            record["p50"] = {b: {k: r[k] for k in ("video_p50_ms", "text_p50_ms")}
                             for b, r in perf.items()}
        return launches
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)


# ------------------------------------------------------------ serve extras
# The serving flags on phase 3's config: (a) the int8 server
# (--quantize int8 --index-quantize int8), (b) an artifact exported by
# cli.export_serving, full and int8, served through cli.serve --artifact.
EXTRA_LAT_ROUNDS = 2      # rounds per bucket of the extra servers' latency pass
EXTRA_LAT_REQUESTS = 10   # timed requests a round (phase 3: LAT_REQUESTS)
ARTIFACT_BATCHES = (1, 3, 4)  # 3 is no bucket: the program's symbolic batch
# The int8 server's embedding against the full-precision one on the same
# weights: oatx's own bar (tests/test_quant_serving.py:113-114).
INT8_MIN_COSINE = 0.98
DISPATCH_CALLS = 200      # calls a turn of the custom-op dispatch reading


def model_bytes(model):
    """Bytes of a model's parameters and buffers (on the card)."""
    return int(sum(t.nbytes for t in list(model.parameters()) + list(model.buffers())))


def cosines(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return (got * want).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(want, axis=-1)


def start_exports(tmp):
    """`python -m oatx_torch.cli.export_serving` on the card, full and int8,
    started together; → {mode: (Popen, artifact dir, log path)}."""
    procs = {}
    for mode in ("full", "int8"):
        out = os.path.join(tmp, f"artifact_{mode}")
        log = os.path.join(tmp, f"export_{mode}.log")
        cmd = [sys.executable, "-m", "oatx_torch.cli.export_serving", "-c", CONFIG,
               "--out", out] + (["--quantize", "int8"] if mode == "int8" else [])
        with open(log, "w") as f:
            procs[mode] = (subprocess.Popen(cmd, cwd=HERE, stdout=f, stderr=subprocess.STDOUT),
                           out, log)
    return procs


def wait_exports(procs, t0):
    """Each export's JSON line and its wall; raises if one failed."""
    lines = {}
    for mode, (proc, out, log) in procs.items():
        rc = proc.wait(timeout=900)
        text = open(log).read()
        if rc != 0:
            raise AssertionError(f"export_serving {mode}: rc {rc}\n{text[-4000:]}")
        lines[mode] = json.loads(text.strip().splitlines()[-1])
        lines[mode]["wall_s"] = time.perf_counter() - t0
    return lines


def dispatch_cost(dev, smi):
    """Host µs a call of each kernel's custom op above a direct `_launch` on
    the same inputs, at serving bucket 1's shapes, in turns (op, direct,
    direct, op; DISPATCH_CALLS calls a turn, ended by a synchronize). Not a
    counted run."""
    from oatx_torch.ops.kernels import ln_mlp as plm
    from oatx_torch.ops.kernels import space_attention as psa

    g = torch.Generator(dev).manual_seed(3)
    bf = torch.bfloat16

    def r(*shape, dtype=torch.float32):
        return (0.05 * torch.randn(*shape, device=dev, generator=g)).to(dtype)

    mlp = (r(785, 768, dtype=bf), 1 + r(768), r(768), r(3072, 768, dtype=bf), r(3072),
           r(768, 3072, dtype=bf), r(768), 1e-6)
    qkv = r(1, 785, 3, 12, 64, dtype=bf)
    sa = (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], 4)
    cases = {"ln_mlp": (lambda: torch.ops.oatx_torch.ln_mlp(*mlp), lambda: plm._launch(*mlp)),
             "space_attention": (lambda: torch.ops.oatx_torch.space_attention(*sa, False),
                                 lambda: psa._launch(*sa))}
    out = {}
    for name, (op, direct) in cases.items():
        us = {"op": [], "direct": []}
        for which in ("op", "direct", "direct", "op"):
            fn = op if which == "op" else direct
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DISPATCH_CALLS):
                fn()
            torch.cuda.synchronize()
            us[which].append((time.perf_counter() - t0) / DISPATCH_CALLS * 1e6)
        out[name] = {"op_us": float(np.mean(us["op"])), "direct_us": float(np.mean(us["direct"])),
                     "turns_us": us}
        out[name]["dispatch_us"] = out[name]["op_us"] - out[name]["direct_us"]
    out["per_video_forward_us"] = 12 * (out["ln_mlp"]["dispatch_us"]
                                        + out["space_attention"]["dispatch_us"])
    print(f"serve extras: custom-op dispatch ({smi}): " + json.dumps(out), flush=True)
    return out


def serve_int8(smi, index_path, full, exports, t_phase):
    """(a): the int8 server on phase 3's config and a 64-row index; its
    latency pass waits for `exports` (start_exports) to end, so that their
    host work does not reach the p50s. → (launches, the service, summary,
    p50 per bucket, the exports' JSON lines)."""
    from oatx_torch.cli.serve import build_service, make_server
    from oatx_torch.serve.retrieval_index import RetrievalIndex

    rng = np.random.default_rng(17)
    frames, dim = 4, full.cfg.projection_dim
    t0 = time.perf_counter()
    svc, tok, index, our = build_service(
        ["-c", CONFIG, "--port", "0", "--index", index_path, "--quantize", "int8",
         "--index-quantize", "int8"])
    built_s = time.perf_counter() - t0
    server = make_server(svc, tok, index, our)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        clip1 = rng.integers(0, 256, (1, frames, 256, 256, 3), dtype=np.uint8)
        clip4 = rng.integers(0, 256, (4, frames, 256, 256, 3), dtype=np.uint8)
        texts = ["a man is cooking in a kitchen", "a video", "two dogs play"]
        launches = {}
        svc.tower_calls = {"video": 0, "text": 0}
        with counted(launches):  # ---- the main path, counted ----
            e1 = finite_matrix("int8 embed_video b1", post(url + "/embed_video", {
                "video_b64": npy_b64(clip1)})["embeddings"], (1, dim))
            finite_matrix("int8 embed_video b4", post(url + "/embed_video", {
                "video_b64": npy_b64(clip4)})["embeddings"], (4, dim))
            finite_matrix("int8 embed_text", post(url + "/embed_text", {"texts": texts})[
                "embeddings"], (3, dim))
            r = post(url + "/index_video", {"video_b64": npy_b64(clip4),
                                            "ids": ["new0", "new1", "new2", "new3"]})
            if r != {"indexed": 4, "size": 68}:
                raise AssertionError(f"int8 /index_video: {r}")
            res = post(url + "/search", {"texts": texts[:2], "k": 5})["results"]
            stats = get(url + "/stats")
        forwards = svc.tower_calls["video"]
        for name in ("ln_mlp", "space_attention"):
            if forwards == 0 or launches[name] != 12 * forwards:
                raise AssertionError(f"int8 server: {name} {launches[name]} launches for "
                                     f"{forwards} video forwards, want 12 per forward")
        for row in res:
            scores = [h["score"] for h in row]
            if len(row) != 5 or scores != sorted(scores, reverse=True):
                raise AssertionError(f"int8 /search result not a ranked top-5: {row}")
        if stats["index"] != {"size": 68, "dim": dim} or stats["video"]["count"] != 3:
            raise AssertionError(f"int8 /stats: {stats}")
        if svc.model.video_model.blocks[0].mlp.fc1.weight_q8.dtype != torch.int8 or \
                index._corpus()[0].dtype != torch.int8:
            raise AssertionError("int8 server: weights or corpus not held as int8")
        # the served embedding against the same quantized model on the plain
        # versions, and against the full-precision model (oatx's bar)
        with plain_versions():
            ref = svc.embed_video(clip1)
        cos_plain = float(cosines(e1, ref)[0])
        cos_full = float(cosines(e1, full.embed_video(clip1))[0])
        # the int8 corpus's top-5 against an f32 index of the same rows
        t = tok(texts, max_length=svc.seq_len)
        q = svc.embed_text(t["input_ids"], t["attention_mask"])
        f32 = RetrievalIndex(index._emb, index.ids, pad_multiple=index.pad_multiple,
                             device=svc.device)
        overlap = [len({h["id"] for h in a} & {h["id"] for h in b}) / 5
                   for a, b in zip(index.search(q, 5), f32.search(q, 5))]
        summary = {"built_s": built_s, "forwards": forwards, "launches": launches,
                   "cosine_vs_plain": cos_plain, "max_abs_err_vs_plain":
                   float(np.abs(e1 - ref).max()), "cosine_vs_full": cos_full,
                   "quantization_report": svc.quant_report,
                   "device_bytes_int8": model_bytes(svc.model),
                   "device_bytes_full": model_bytes(full.model),
                   "top5_overlap_vs_f32_index": overlap}
        print(f"serve extras (a) int8 server ({smi}): " + json.dumps(summary), flush=True)
        if not cos_plain >= E2E_MIN_COSINE:
            raise AssertionError(f"int8 served embedding vs plain cosine {cos_plain} < "
                                 f"{E2E_MIN_COSINE}")
        if not cos_full > INT8_MIN_COSINE:
            raise AssertionError(f"int8 served embedding vs full cosine {cos_full} <= "
                                 f"{INT8_MIN_COSINE}")
        lines = wait_exports(exports, t_phase)
        p50 = extra_latency(url, svc, rng, texts, svc.buckets)
        return launches, svc, summary, p50, lines
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)


def extra_latency(url, svc, rng, texts, buckets, trace_at=4):
    """p50 per bucket by phase 3's method (`bucket_latency`), fewer requests;
    at bucket `trace_at` also a device trace of PROFILED_REQUESTS video
    requests (device busy, idle share of the p50, device ms by group)."""
    out = {}
    for b in buckets:
        clips = rng.integers(0, 256, (b, 4, 256, 256, 3), dtype=np.uint8)
        payload_v = json.dumps({"video_b64": npy_b64(clips)}).encode()
        payload_t = json.dumps({"texts": (texts * b)[:b]}).encode()
        rec = bucket_latency(url, svc, payload_v, payload_t, EXTRA_LAT_ROUNDS,
                             EXTRA_LAT_REQUESTS)
        out[b] = {k: rec[k] for k in ("video_p50_ms", "video_p50_spread", "text_p50_ms",
                                      "http_video_p50_ms")}
        if b == trace_at:  # one video forward a request at bucket 4
            busy, _, groups, _ = device_trace(
                lambda: post(url + "/embed_video", payload_v), PROFILED_REQUESTS,
                expect=[("space_attention_kernel", 12), ("ln_mlp_", 12)])
            out[b].update(video_device_busy_ms=busy,
                          video_idle_share=1 - busy / rec["video_p50_ms"],
                          video_device_ms_by_group=groups)
    return out


def serve_artifact(mode, path, line, ref, smi):
    """(b): one artifact served through cli.serve --artifact. → (launches,
    summary)."""
    from oatx_torch.cli.serve import build_service, make_server

    rng = np.random.default_rng(23)
    t0 = time.perf_counter()
    svc, tok, _, our = build_service(["-c", CONFIG, "--port", "0", "--artifact", path])
    loaded_s = time.perf_counter() - t0
    server = make_server(svc, tok, None, our)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        clips = {b: rng.integers(0, 256, (b, 4, 256, 256, 3), dtype=np.uint8)
                 for b in ARTIFACT_BATCHES}
        texts = ["a man is cooking in a kitchen", "a video", "two dogs play"]
        launches, got = {}, {}
        with counted(launches):  # ---- the main path, counted ----
            for b, c in clips.items():
                got[b] = finite_matrix(f"artifact {mode} b{b}", post(
                    url + "/embed_video", {"video_b64": npy_b64(c)})["embeddings"],
                    (b, ref.cfg.projection_dim))
            finite_matrix(f"artifact {mode} text", post(url + "/embed_text", {
                "texts": texts})["embeddings"], (3, ref.cfg.projection_dim))
        forwards = len(ARTIFACT_BATCHES)  # one program call a request
        for name in ("ln_mlp", "space_attention"):
            if launches[name] != 12 * forwards:
                raise AssertionError(f"artifact {mode}: {name} {launches[name]} launches for "
                                     f"{forwards} video forwards, want 12 per forward")
        cos, err = {}, {}
        for b, c in clips.items():
            want = ref.embed_video(c)
            cos[b] = float(cosines(got[b], want).min())
            err[b] = float(np.abs(got[b] - want).max())
        lat = extra_latency(url, svc, rng, texts, (4,))[4]
        summary = {"mode": mode, "bytes": line["bytes"], "export_wall_s": line["wall_s"],
                   "loaded_s": loaded_s, "launches": launches, "forwards": forwards,
                   "cosine_vs_in_process": cos, "max_abs_err_vs_in_process": err,
                   "bucket4": lat}
        print(f"serve extras (b) artifact {mode} ({smi}): " + json.dumps(summary), flush=True)
        for b, c in cos.items():
            if not c >= E2E_MIN_COSINE:
                raise AssertionError(f"artifact {mode} b{b}: cosine {c} vs the in-process "
                                     f"service < {E2E_MIN_COSINE}")
        return launches, summary
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)


def serve_extras(tmp, smi, base=None):
    """Phase 3's extras, (a) and (b) (module docstring). `base`: phase 3's
    record (its p50 per bucket), None when run alone. → the launches of
    (a) and of (b)."""
    from oatx_torch import resolve_device
    from oatx_torch.config.schema import ExperimentCfg, build_tower_config, precision_dtype
    from oatx_torch.models.towers import DualTower
    from oatx_torch.serve.embed_service import EmbedService
    from oatx_torch.serve.retrieval_index import RetrievalIndex

    t_phase = time.perf_counter()
    procs = start_exports(tmp)  # the exports run while (a) checks its server
    try:
        exp = ExperimentCfg.from_json(CONFIG)
        dev = resolve_device()
        tower_cfg = build_tower_config(
            exp.arch, compute_dtype=precision_dtype(exp.trainer.precision))
        full = EmbedService(DualTower(tower_cfg, device=dev,
                                      generator=torch.Generator(dev).manual_seed(0)),
                            tower_cfg, device=dev)  # the full-precision service, in process
        rng = np.random.default_rng(0)
        index_path = os.path.join(tmp, "index_extras.npz")
        RetrievalIndex(rng.standard_normal((64, tower_cfg.projection_dim)).astype(np.float32),
                       [f"corpus{i}" for i in range(64)], pad_multiple=64,
                       device="cpu").save(index_path)
        l_int8, int8, summary, p50, lines = serve_int8(smi, index_path, full, procs,
                                                       t_phase)
        print(f"serve extras (a) int8 p50 per bucket ({smi}; {EXTRA_LAT_ROUNDS} rounds × "
              f"{EXTRA_LAT_REQUESTS} requests): " + json.dumps(p50) + "; phase 3's: "
              + json.dumps((base or {}).get("p50")), flush=True)
        l_art = {}
        arts = {}
        for mode, line in lines.items():
            if line["platforms"] != [dev.type] or (line["quantize"] is None) != (mode == "full"):
                raise AssertionError(f"export_serving {mode}: {line}")
            ref = full if mode == "full" else int8
            got, arts[mode] = serve_artifact(mode, line["artifact"], line, ref, smi)
            for k, n in got.items():
                l_art[k] = l_art.get(k, 0) + n
        dispatch = dispatch_cost(dev, smi)
        print(f"serve extras summary ({smi}): " + json.dumps({
            "int8_p50": {b: r["video_p50_ms"] for b, r in p50.items()},
            "phase3_p50": {b: r["video_p50_ms"] for b, r in ((base or {}).get("p50")
                                                             or {}).items()},
            "int8_cosine_vs_full": summary["cosine_vs_full"],
            "device_bytes_int8_full": [summary["device_bytes_int8"],
                                       summary["device_bytes_full"]],
            "artifact_bytes": {m: a["bytes"] for m, a in arts.items()},
            "artifact_bucket4_p50": {m: a["bucket4"]["video_p50_ms"] for m, a in arts.items()},
            "bucket4_device_busy_ms": {"int8_server": p50[4]["video_device_busy_ms"], **{
                f"artifact_{m}": a["bucket4"]["video_device_busy_ms"] for m, a in arts.items()}},
            "export_wall_s": {m: a["export_wall_s"] for m, a in arts.items()},
            "dispatch_us_per_video_forward": dispatch["per_video_forward_us"],
            "launches": {"serve_int8": l_int8, "artifact": l_art},
            "phase_s": time.perf_counter() - t_phase}), flush=True)
        return l_int8, l_art
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def tensor_used(got, ref):
    """grad_check's reading per tensor: (‖g − r‖, ‖r‖, the global ‖r‖,
    ‖g − r‖ / (GRAD_RTOL·‖r‖ + GRAD_ATOL·‖r‖_all)) by name."""
    d = {n: float((got[n].double() - ref[n].double()).norm()) for n in ref}
    r = {n: float(ref[n].double().norm()) for n in ref}
    total = float(np.sqrt(sum(v * v for v in r.values())))
    return d, r, total, {n: d[n] / (GRAD_RTOL * r[n] + GRAD_ATOL * total) for n in ref}


def grad_check(got, ref):
    """Per-tensor agreement of two gradient sets: ‖g − r‖ ≤ GRAD_RTOL·‖r‖ +
    GRAD_ATOL·‖r‖_all, where ‖r‖_all is the global norm (the absolute part
    covers tensors whose gradient is rounding noise in both: at time_init
    'zeros' the time branch adds a constant to every channel, which norm1
    removes, so its true gradient is 0). Returns the record's grad_* keys."""
    d, r, total, used = tensor_used(got, ref)
    gnorm = float(np.sqrt(sum(float(g.double().square().sum()) for g in got.values())))
    dot = sum(float((got[n].double() * ref[n].double()).sum()) for n in ref)
    worst = sorted(used, key=used.get, reverse=True)[:6]
    return {"grad_norm": gnorm, "plain_grad_norm": total,
            "grad_norm_rel_diff": abs(gnorm - total) / total,
            "grad_global_cosine": dot / (gnorm * total),
            "grad_tol_used": used[worst[0]], "grad_tensors": len(ref),
            "grad_worst": [(n, round(used[n], 4), r[n] / total, d[n] / max(r[n], 1e-30))
                           for n in worst]}


def train_cfg(fused_qkv):
    """bench.py:101-113's model: ViT-B/16 over 4 frames (time attention
    zero-initialised), DistilBERT-base, 256-d projections, bf16 compute."""
    from oatx_torch.models import distilbert as dbert
    from oatx_torch.models import towers
    from oatx_torch.models import vit_spacetime as vst

    return towers.TowerConfig(
        video=vst.SpaceTimeViTConfig(num_frames=4, time_init="zeros", fused_qkv=fused_qkv),
        text=dbert.DistilBertConfig(), projection_dim=256, variant="baseline",
        compute_dtype=torch.bfloat16)


def train_run(fused_qkv, batch, smi, dev):
    """One fused_qkv setting of the train phase; returns its record."""
    from oatx_torch.ops.kernels.ln_linear import ln_linear
    from oatx_torch.ops.kernels.ln_mlp import ln_mlp
    from oatx_torch.ops.kernels.space_attention import space_attention, \
        space_attention_backward
    from oatx_torch.train import optim, step as steplib
    from oatx_torch.train.flops import flops_forward_per_clip

    cfg = train_cfg(fused_qkv)
    depth = cfg.video.depth
    # memory left by earlier phases counts in the peak: collect what is
    # unreachable first, and record what stays held
    before = torch.cuda.memory_allocated(dev)
    gc.collect()
    held = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    state = steplib.init_state(cfg, optim.make_optimizer(lr=2e-4), device=dev,
                               generator=torch.Generator(dev).manual_seed(0))
    train_step = steplib.make_train_step(cfg, steplib.LossConfig(), device=dev)
    tag = f"train fused_qkv={fused_qkv}"
    print(f"{tag}: model and AdamW built in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in state.model.parameters())} parameters)", flush=True)

    # ---- the main path, counted ----
    for k in (ln_mlp, space_attention, space_attention_backward, ln_linear):
        k.launches = 0
    losses = []
    for _ in range(TRAIN_STEPS):
        state, m = train_step(state, batch)
        losses.append(float(m["loss"]))
    launches = {"ln_mlp": ln_mlp.launches, "space_attention": space_attention.launches,
                "space_attention_bwd": space_attention_backward.launches,
                "ln_linear": ln_linear.launches}
    # ---- end of the counted run ----
    want = {"ln_mlp": depth, "space_attention": depth, "space_attention_bwd": depth,
            "ln_linear": 2 * depth if fused_qkv else 0}
    for name, n in launches.items():
        if n != want[name] * TRAIN_STEPS:
            raise AssertionError(f"{tag}: {name} launched {n} times in {TRAIN_STEPS} "
                                 f"steps, want {want[name]} per step")
    print(f"{tag}: losses {json.dumps(losses)}; launches {launches} in "
          f"{TRAIN_STEPS} steps", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: loss not finite or not falling: {losses}")

    torch.cuda.reset_peak_memory_stats(dev)
    windows = []
    for _ in range(TIME_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WINDOW_STEPS):
            state, m = train_step(state, batch)
        float(m["loss"])
        windows.append((time.perf_counter() - t0) / WINDOW_STEPS * 1e3)
    kept = windows[1:]
    step_ms = float(np.median(kept))
    peak = torch.cuda.max_memory_allocated(dev)
    expect = [(key, depth) for key in ("ln_mlp_", "space_attention_kernel",
                                       "space_attention_bwd_kernel")]
    if fused_qkv:
        expect.append(("ln_linear_kernel", 2 * depth))
    busy, acts, groups, top = device_trace(lambda: train_step(state, batch), PROFILED_STEPS,
                                           expect=expect)
    flops = 3.0 * flops_forward_per_clip(cfg.video, cfg.text, TRAIN_SEQ)
    rec = {"fused_qkv": fused_qkv, "step1_loss": losses[0], "last_loss": losses[-1],
           "step_ms": step_ms, "step_ms_spread": (max(kept) - min(kept)) / step_ms,
           "windows_ms": windows, "clips_per_s": TRAIN_BATCH / step_ms * 1e3,
           "mfu": TRAIN_BATCH / step_ms * 1e3 * flops / PEAK_BF16_FLOPS,
           "flops_per_clip_step": flops, "peak_mem_gib": peak / 2 ** 30,
           "mem_held_gib": held / 2 ** 30, "mem_freed_by_gc_gib": (before - held) / 2 ** 30,
           "device_busy_ms": busy, "idle_share": 1 - busy / step_ms,
           "device_activities": acts, "device_ms_by_group": groups,
           "device_top_other_ms": top,
           "launches": launches}

    # one step's gradients, kernels vs plain versions (not counted, no update)
    model = state.model

    def grads():
        model.zero_grad(set_to_none=True)
        loss, _ = steplib.loss_fn(model, steplib.LossConfig(), batch)
        loss.backward()
        return {n: (p.grad.detach().clone() if p.grad is not None else None)
                for n, p in model.named_parameters()}

    got = grads()
    with plain_versions():
        ref = grads()
    model.zero_grad(set_to_none=True)
    missing = [n for n, g in got.items() if g is None or not bool(torch.isfinite(g).all())]
    if missing:
        raise AssertionError(f"{tag}: {len(missing)} parameters without a finite "
                             f"gradient through the kernels, e.g. {missing[:5]}")
    rec.update(grad_check(got, ref))
    print(f"{tag} ({smi}): " + json.dumps(rec), flush=True)
    if rec["grad_tol_used"] > 1 or rec["grad_norm_rel_diff"] > GRAD_NORM_RTOL \
            or rec["grad_global_cosine"] < GRAD_MIN_GLOBAL_COSINE:
        raise AssertionError(f"{tag}: gradients through the kernels disagree with the "
                             f"plain versions: {rec['grad_worst']}")
    return rec


def train_phase(smi, dev, res=224):
    """The train step at full width, fused_qkv on then off (module docstring)."""
    rng = np.random.default_rng(0)  # bench.py:115-120
    batch = {
        "video": torch.from_numpy(rng.standard_normal(
            (TRAIN_BATCH, 4, res, res, 3)).astype(np.float32)).to(dev, torch.bfloat16),
        "input_ids": torch.from_numpy(rng.integers(0, 30522, (TRAIN_BATCH, TRAIN_SEQ))).to(dev),
        "attention_mask": torch.ones(TRAIN_BATCH, TRAIN_SEQ, dtype=torch.int32, device=dev),
    }
    runs = [train_run(fused, batch, smi, dev) for fused in (True, False)]
    on, off = runs
    rel = abs(on["step1_loss"] - off["step1_loss"]) / abs(off["step1_loss"])
    print(f"train: step-1 loss fused_qkv on {on['step1_loss']:.6f} vs off "
          f"{off['step1_loss']:.6f} (rel {rel:.2e}); step ms {on['step_ms']:.3f} vs "
          f"{off['step_ms']:.3f}, clips/s {on['clips_per_s']:.3f} vs {off['clips_per_s']:.3f}, "
          f"MFU {on['mfu']:.4f} vs {off['mfu']:.4f}, peak GiB {on['peak_mem_gib']:.2f} vs "
          f"{off['peak_mem_gib']:.2f} (held before the run {on['mem_held_gib']:.2f} vs "
          f"{off['mem_held_gib']:.2f}) ({smi})", flush=True)
    if rel > FUSED_LOSS_RTOL:
        raise AssertionError(f"fused_qkv on/off step-1 losses differ by {rel:.3e}")
    return {name: on["launches"][name] + off["launches"][name] for name in on["launches"]}


# ------------------------------------------------------------------ trainer
NORM_CONFIG = os.path.join(HERE, "configs", "pt", "cc3m_webvid", "norm.json")
LARGE_CONFIG = os.path.join(HERE, "configs", "pt", "cc3m_webvid", "large_batch_pod.json")
CORPUS_CLIPS = 32        # two of norm.json's per-GPU batches of 16: memorisable
CORPUS_FRAMES = 4
CANON = 256              # canonical frames: short side 256, centre-cropped
TRAINER_EPOCHS = 2
TRAINER_LEN_EPOCH = 16   # steps per epoch (len_epoch cycles of one loader)
REMAT_SETTINGS = (None, "full", "dots", "dots_all")
REMAT_STEPS = 3          # counted steps per remat setting at batch 16
LARGE_BATCH = 64         # large_batch_pod.json's per-chip batch
LARGE_STEPS = 3
RESUME_LOSS_RTOL = 1e-3  # the resumed epoch's losses against the uninterrupted run's
TEXT_LEN = 30            # the Collator's max_text_len (the reference's)
WORDS = ("alpha", "beta", "gamma", "delta", "eps", "zeta")  # caption i: alpha{i} beta{i} ...


class MemoryClips:
    """An in-memory corpus of n separable clips: each a distinct colour under
    a sine grating of its own angle and frequency that drifts across its
    `frames` frames, plus noise, as canonical uint8 (F, 256, 256, 3) frames
    from `seed`; and a caption of six words that no other caption shares (at
    random init DistilBERT's CLS output is nearly the same for captions that
    share most of their words, and a few steps do not tell them apart).
    `get_sample(i, rng)` is what the port's ShardedLoader reads."""

    dataset_name = "MemoryClips"

    def __init__(self, n, seed, frames=CORPUS_FRAMES):
        rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:CANON, 0:CANON].astype(np.float32) / CANON
        self.videos = np.empty((n, frames, CANON, CANON, 3), np.uint8)
        for i in range(n):
            colour = rng.uniform(40, 215, 3).astype(np.float32)
            theta, freq, phase = np.pi * i / n, 2 + i % 5, rng.uniform(0, 2 * np.pi)
            for f in range(frames):
                wave = np.sin(2 * np.pi * freq * (xx * np.cos(theta) + yy * np.sin(theta))
                              + phase + 0.3 * f)
                img = colour + 35 * wave[..., None] + rng.normal(0, 6, (CANON, CANON, 3))
                self.videos[i, f] = np.clip(img, 0, 255).astype(np.uint8)
        self.captions = [" ".join(f"{w}{i}" for w in WORDS) for i in range(n)]

    def __len__(self):
        return len(self.captions)

    def get_sample(self, i, rng):
        return {"video": self.videos[i], "text": self.captions[i], "meta": {"index": i}}


def corpus_loaders(ds, batch, with_valid=True):
    from oatx_torch.data.loader import Collator, ShardedLoader
    from oatx_torch.data.tokenizer import WordPieceTokenizer

    col = Collator(WordPieceTokenizer.build_from_corpus(ds.captions), max_text_len=TEXT_LEN)
    train = [ShardedLoader(ds, batch, col, seed=0, num_workers=4)]
    valid = [ShardedLoader(ds, batch, col, shuffle=False, drop_last=False, num_workers=4)]
    return train, valid if with_valid else []


def recipe(path, **trainer):
    """A recipe from configs/ with the chip run's trainer keys set."""
    from oatx_torch.config.schema import ExperimentCfg

    with open(path) as f:
        raw = json.load(f)
    raw["trainer"].update(trainer)
    return ExperimentCfg.from_dict(raw)


def set_video(exp, **video):
    """exp with arch.args.video_params keys replaced."""
    from oatx_torch.config.schema import ExperimentCfg

    raw = json.loads(json.dumps(exp.raw))
    raw["arch"]["args"]["video_params"].update(video)
    return ExperimentCfg.from_dict(raw)


def kernel_counts():
    from oatx_torch.ops.kernels.ln_linear import ln_linear
    from oatx_torch.ops.kernels.ln_mlp import ln_mlp
    from oatx_torch.ops.kernels.space_attention import space_attention, \
        space_attention_backward

    return {"ln_mlp": ln_mlp, "space_attention": space_attention,
            "space_attention_bwd": space_attention_backward, "ln_linear": ln_linear}


@contextlib.contextmanager
def counted(out):
    """Sets every launch count to 0, and fills `out` with the counts at exit."""
    ks = kernel_counts()
    for k in ks.values():
        k.launches = 0
    yield
    torch.cuda.synchronize()
    out.update({name: k.launches for name, k in ks.items()})


def want_launches(depth, steps, remat, chunks=None, forwards=0, backward_depths=None,
                  accum_steps=1):
    """Launches derived from the code. With `accum_steps` > 1 a step runs
    that many micro-batches, each a forward and a backward as a step
    without accumulation does. `backward_depths` holds, per video
    stream of a step, how many of its blocks the loss reaches (default one
    stream, all blocks): the object-aware variants send the clip and the
    1-frame object frame through the tower, (depth, depth) for global_local
    and (depth, K) for region_mem, whose object frame feeds the loss only
    through the layer-K tap, so autograd never reaches its later blocks. A
    step without remat runs kernels 1 and 2 once a block of each stream in
    the forward and kernel 2's backward once a reached block; per-block remat
    runs a block's forward again before its backward. fwd_chunk (one stream)
    runs each of its `chunks` sub-batches under a checkpoint of its own,
    whose recompute runs the chunk's forward again (2·depth a chunk) and,
    with per-block remat inside it, each block once more in its own
    recompute (3·depth a chunk); the backward runs once a chunk. Eval
    forwards (`forwards`) launch kernels 1 and 2 once a block of each stream
    and no backward."""
    reached = tuple(backward_depths or (depth,))
    streams = len(reached)
    if chunks is None:
        fwd = streams * depth + (sum(reached) if remat else 0)
        bwd = sum(reached)
    else:
        if streams != 1 or reached != (depth,):
            raise ValueError("fwd_chunk launches are derived for one full stream")
        fwd = depth * chunks * (3 if remat else 2)
        bwd = depth * chunks
    per_eval = forwards * depth * streams
    steps *= accum_steps
    return {"ln_mlp": steps * fwd + per_eval, "space_attention": steps * fwd + per_eval,
            "space_attention_bwd": steps * bwd, "ln_linear": 0}


def eval_forwards(validations, clips, batch):
    """Video-tower forwards of `validations` passes over `clips` in batches
    of `batch`, each embedded in chunks of 8 (the Trainer's eval step)."""
    return validations * -(-clips // batch) * -(-batch // 8)


def check_launches(tag, got, want):
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, derived {want}")


class StepRecorder:
    """Wraps a Trainer's train_step: after each step a CUDA event and the loss
    tensor, no sync (a step's time is the interval between consecutive
    events: the device's view of the trainer loop, host stalls included).
    With `trace_at` = k, steps k and k + 1 run inside a `cuda_trace`,
    whose device records between its markers give the loop's device idle
    share (1 − busy / the window's wall time); `expect` as device_trace's.
    A trace that lost records is taken again by `traced()`, as
    device_trace's are, up to TRACE_ATTEMPTS traces in all: a retake
    replays the traced steps' batches on the Trainer's state after its
    run (steps that move the state on, outside every launch count, loss
    and event), in one process only, since a rank cannot replay alone a
    step whose collectives its peers do not run."""

    def __init__(self, trainer, trace_at=None, expect=()):
        self.step, self.trainer = trainer.train_step, trainer
        self.events, self.losses, self.terms = [], [], []
        self.trace_at, self.expect = trace_at, expect
        self.window, self.attempts, self.lost, self._trace = [], 0, None, None
        trainer.train_step = self

    def __call__(self, state, batch):
        i = len(self.losses) + 1
        traced = self.trace_at is not None and 0 <= i - self.trace_at < PROFILED_STEPS
        if traced:
            self.window.append(batch)
        if i == self.trace_at:
            self._open()
        state, m = self.step(state, batch)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)
        self.losses.append(m["loss"])
        self.terms.append({k: v for k, v in m.items() if k.startswith("loss")})
        if traced and i == self.trace_at + PROFILED_STEPS - 1:
            self._close()
        return state, m

    def _open(self):
        self._cm = cuda_trace()
        self._held = self._cm.__enter__()
        self._t0 = time.perf_counter()

    def _close(self):
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - self._t0) * 1e3
        self._cm.__exit__(None, None, None)
        self.attempts += 1
        recs = self._held.recs
        if recs is None:
            self.lost = "a marker"
        else:
            self.lost = [key for key, per in self.expect
                         if sum(key in r[2] for r in recs) < per * PROFILED_STEPS]
            self.lost = self.lost or (None if recs else "every kernel")
        if self.lost:
            print(f"trainer trace: attempt {self.attempts} lost records of {self.lost}",
                  file=sys.stderr, flush=True)
            return
        busy = busy_union_us(recs) / 1e3
        self._trace = {"wall_ms": wall_ms / PROFILED_STEPS,
                       "device_busy_ms": busy / PROFILED_STEPS,
                       "idle_share": 1 - busy / wall_ms,
                       "device_ms_by_group": group_ms(recs, PROFILED_STEPS)[0],
                       "trace_attempt": self.attempts}

    def traced(self):
        """The trace's record (None where no step was traced), after taking
        again a trace that lost records; raises once TRACE_ATTEMPTS traces
        lost records."""
        if not self.attempts:
            return None
        dist = torch.distributed
        ranks = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        while self._trace is None:
            if self.attempts >= TRACE_ATTEMPTS or ranks > 1:
                raise AssertionError(f"trainer trace: {self.attempts} traces lost records of "
                                     f"{self.lost}")
            state = self.trainer.state
            self._open()
            for batch in self.window:
                state, _ = self.step(state, batch)
            self._close()
            self.trainer.state = state
        return self._trace

    def step_ms(self, per_epoch):
        """Intervals between consecutive steps inside each epoch of
        `per_epoch` steps (step 1 of an epoch has no predecessor there)."""
        torch.cuda.synchronize()
        out = []
        for e0 in range(0, len(self.events), per_epoch):
            evs = self.events[e0:e0 + per_epoch]
            out += [a.elapsed_time(b) for a, b in zip(evs, evs[1:])]
        return out

    def loss_values(self):
        return [float(v) for v in self.losses]

    def term_values(self):
        """{term: [value per step]} of every loss metric the steps returned."""
        return {k: [float(m[k]) for m in self.terms] for k in self.terms[0]}


def speed(ms_list, batch, flops_per_clip):
    step_ms = float(np.median(ms_list))
    return {"step_ms": step_ms, "step_ms_spread": (max(ms_list) - min(ms_list)) / step_ms,
            "steps_timed": len(ms_list), "clips_per_s": batch / step_ms * 1e3,
            "mfu": batch / step_ms * 1e3 * flops_per_clip / PEAK_BF16_FLOPS}


def fresh_peak(dev):
    """Collect garbage, then start the peak count; → GiB held now."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev) / 2 ** 30


def flops_per_clip_step(cfg):
    from oatx_torch.train.flops import flops_forward_per_clip

    return 3.0 * flops_forward_per_clip(cfg.video, cfg.text, TEXT_LEN)


def state_equal(a, b):
    """Tensors of two nested dicts bitwise equal (b on the host)."""
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(state_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a.detach().cpu(), b)
    return a == b


def norm_recipe(tmp, smi, dev, ds):
    """norm.json at its per-GPU batch of 16 through Trainer.train(), then a
    Trainer resumed from its epoch-1 checkpoint running epoch 2 again."""
    from oatx_torch.train.trainer import Trainer

    exp = recipe(NORM_CONFIG, epochs=TRAINER_EPOCHS, len_epoch=TRAINER_LEN_EPOCH,
                 save_period=1, verbosity=1)
    batch = exp.data_loaders[0].batch_size
    train, valid = corpus_loaders(ds, batch)
    held = fresh_peak(dev)
    t0 = time.perf_counter()
    tr = Trainer(exp, train, valid, save_dir=os.path.join(tmp, "norm"), device=dev)
    depth = tr.tower_cfg.video.depth
    print(f"trainer norm@{batch}: Trainer built in {time.perf_counter() - t0:.1f} s "
          f"(remat {tr.tower_cfg.video.remat}, fwd_chunk {exp.trainer.fwd_chunk})", flush=True)
    rec = StepRecorder(tr)
    launches = {}
    t0 = time.perf_counter()
    with counted(launches):  # ---- the main path, counted ----
        hist = tr.train()
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check_launches(f"trainer norm@{batch}", launches, want_launches(
        depth, TRAINER_EPOCHS * TRAINER_LEN_EPOCH, False,
        forwards=eval_forwards(1 + TRAINER_EPOCHS, len(ds), batch)))  # init_val + each epoch
    losses = rec.loss_values()
    r1_init = tr.init_val_log["val_0_t2v_R1"]
    r1_end = hist[TRAINER_EPOCHS]["val_0_t2v_R1"]
    out = {"recipe": "norm.json", "batch": batch, "remat": False, "fwd_chunk": 0,
           "losses": losses, "epoch_loss": [hist[e]["loss_0"] for e in (1, 2)],
           "val_loss": [tr.init_val_log["val_loss_0"]] + [hist[e]["val_loss_0"] for e in (1, 2)],
           "t2v_R1": [r1_init] + [hist[e]["val_0_t2v_R1"] for e in (1, 2)],
           "v2t_R1": [tr.init_val_log["val_0_v2t_R1"]] + [hist[e]["val_0_v2t_R1"]
                                                          for e in (1, 2)],
           "input_wait": [hist[e]["input_wait"] for e in (1, 2)],
           "train_wall_s": wall_s, "peak_mem_gib": peak, "mem_held_gib": held,
           "launches": launches,
           **speed(rec.step_ms(TRAINER_LEN_EPOCH), batch, flops_per_clip_step(tr.tower_cfg))}
    if not all(np.isfinite(losses)) or not np.mean(losses[-2:]) < np.mean(losses[:2]):
        raise AssertionError(f"trainer norm@{batch}: loss not finite or not falling: {losses}")
    if not r1_end > r1_init:
        raise AssertionError(f"trainer norm@{batch}: t2v R@1 {r1_init} at init_val, "
                             f"{r1_end} after epoch {TRAINER_EPOCHS}: no gain")

    del tr
    expect = [("ln_mlp_", depth), ("space_attention_kernel", depth),
              ("space_attention_bwd_kernel", depth)]
    out["resume"], launches2, trace = resume_epoch2(
        f"trainer norm@{batch}", exp, lambda: corpus_loaders(ds, batch),
        os.path.join(tmp, "norm", "checkpoint-epoch1"), dev, TRAINER_LEN_EPOCH, expect,
        want_launches(depth, TRAINER_LEN_EPOCH, False, forwards=eval_forwards(2, len(ds), batch)),
        rec.term_values())
    out.update(trace)
    print(f"trainer norm@{batch} ({smi}): " + json.dumps(out), flush=True)
    return out, [launches, launches2]


def resume_epoch2(tag, exp, loaders, ckpt, dev, len_epoch, expect, want, terms):
    """A Trainer resumed from `ckpt` (a run's checkpoint-epoch1, over
    `loaders()`) must hold the saved state bitwise and start at epoch 2; its
    run is counted against `want` and must repeat `terms` ({loss term:
    values per step of the uninterrupted run}) from step len_epoch on,
    within RESUME_LOSS_RTOL. A CUDA-only trace of 2 steps inside its loop
    (`expect` as device_trace's) gives the loop's idle share. Returns the
    resume record, the launches and the trace's record."""
    from oatx_torch.train import checkpoint as ckptlib
    from oatx_torch.train.trainer import Trainer

    snap = torch.load(os.path.join(ckpt, ckptlib.STATE_FILE), map_location="cpu",
                      weights_only=True)
    train, valid = loaders()
    tr = Trainer(exp, train, valid, resume=ckpt, device=dev)
    restored = (state_equal(tr.state.model.state_dict(), snap["model"])
                and state_equal(tr.state.optimizer.named_state(), snap["optimizer"])
                and tr.state.step == snap["step"] == len_epoch)
    if not restored or tr.start_epoch != 2:
        raise AssertionError(f"{tag} resume: the restored state is not the saved one "
                             f"(start epoch {tr.start_epoch}, step {tr.state.step})")
    rec = StepRecorder(tr, trace_at=3, expect=expect)
    launches = {}
    with counted(launches):  # ---- the main path, counted ----
        tr.train()
    check_launches(f"{tag} resume", launches, want)
    again = rec.term_values()
    first = {k: v[len_epoch:] for k, v in terms.items()}
    rel = max(abs(a - b) / abs(b) for k, v in first.items() for a, b in zip(again[k], v))
    if rel > RESUME_LOSS_RTOL:
        raise AssertionError(f"{tag} resume: epoch 2's loss terms {again} vs {first} "
                             f"(rel {rel:.2e})")
    return ({"restored_bitwise": restored, "losses": again["loss"], "max_rel_diff": rel,
             "bitwise": again == first}, launches, rec.traced())


def remat_runs(smi, dev, ds):
    """norm.json's model at batch 16: remat off, full, dots, dots_all — one
    step's gradients against remat off (grad_check), REMAT_STEPS counted
    steps with their times and peak memory, a device trace of 2."""
    from oatx_torch.config.schema import build_tower_config, precision_dtype
    from oatx_torch.data.transforms import TransformConfig, eval_transform
    from oatx_torch.train import optim, step as steplib

    base = recipe(NORM_CONFIG)
    batch_n = base.data_loaders[0].batch_size
    train, _ = corpus_loaders(ds, batch_n, with_valid=False)
    host = next(iter(train[0]))
    host.pop("meta")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    fixed = {**batch, "video": eval_transform(batch["video"], TransformConfig())}
    runs, all_launches, ref = {}, [], None
    for policy in REMAT_SETTINGS:
        exp = set_video(base, remat=policy is not None, remat_policy=policy or "full")
        cfg = build_tower_config(exp.arch, compute_dtype=precision_dtype(exp.trainer.precision))
        depth = cfg.video.depth
        tag = f"trainer remat={policy or 'off'}@{batch_n}"
        state = steplib.init_state(cfg, optim.make_optimizer(lr=exp.optimizer.lr), device=dev,
                                   generator=torch.Generator(dev).manual_seed(0))
        model = state.model
        loss, _ = steplib.loss_fn(model, steplib.LossConfig(), fixed)
        loss.backward()
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        rec = {"remat": policy or "off", "batch": batch_n}
        if ref is None:
            ref = grads
        else:
            rec.update(grad_check(grads, ref))
            rec["grad_tensors_bitwise"] = sum(torch.equal(grads[n], ref[n]) for n in ref)
            if rec["grad_tol_used"] > 1 or rec["grad_norm_rel_diff"] > GRAD_NORM_RTOL \
                    or rec["grad_global_cosine"] < GRAD_MIN_GLOBAL_COSINE:
                raise AssertionError(f"{tag}: gradients disagree with remat off: "
                                     f"{rec['grad_worst']}")
        del grads
        train_step = steplib.make_train_step(
            cfg, steplib.LossConfig(), base_seed=1, device=dev,
            augment=steplib.make_augmenter(train=True, tower_cfg=cfg))
        rec["mem_held_gib"] = fresh_peak(dev)
        launches, events, losses = {}, [], []
        with counted(launches):  # ---- the main path, counted ----
            for _ in range(REMAT_STEPS):
                state, m = train_step(state, batch)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
                losses.append(m["loss"])
        check_launches(tag, launches, want_launches(depth, REMAT_STEPS, policy is not None))
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        rec["losses"] = [float(v) for v in losses]
        if not all(np.isfinite(rec["losses"])):
            raise AssertionError(f"{tag}: non-finite loss {rec['losses']}")
        rec.update(speed([a.elapsed_time(b) for a, b in zip(events, events[1:])], batch_n,
                         flops_per_clip_step(cfg)))
        expect = [("ln_mlp_", depth * (2 if policy else 1)), ("space_attention_bwd_kernel", depth)]
        busy, _, groups, _ = device_trace(lambda: train_step(state, batch), PROFILED_STEPS,
                                          expect=expect)
        rec.update(device_busy_ms=busy, idle_share=1 - busy / rec["step_ms"],
                   device_ms_by_group=groups, launches=launches)
        print(f"{tag} ({smi}): " + json.dumps(rec), flush=True)
        runs[rec["remat"]] = rec
        all_launches.append(launches)
        del state, model, train_step
    return runs, all_launches


def large_batch_recipe(smi, dev):
    """large_batch_pod.json on one card: batch 64, fwd_chunk 8, remat full,
    chunked NormSoftmax, cosine schedule, LARGE_STEPS steps through
    Trainer.train(); then the same without fwd_chunk, if it fits."""
    from oatx_torch.train.trainer import Trainer

    ds = MemoryClips(LARGE_BATCH, seed=1)
    out, all_launches = {}, []
    for fwd_chunk in (8, 0):
        exp = recipe(LARGE_CONFIG, epochs=1, len_epoch=LARGE_STEPS, init_val=False,
                     save_period=100, verbosity=1, fwd_chunk=fwd_chunk)
        batch = exp.data_loaders[0].batch_size
        tag = f"trainer large_batch@{batch} fwd_chunk={fwd_chunk}"
        train, _ = corpus_loaders(ds, batch, with_valid=False)
        held = fresh_peak(dev)
        try:
            tr = Trainer(exp, train, [], device=dev)
            depth = tr.tower_cfg.video.depth
            rec = StepRecorder(tr)
            launches = {}
            with counted(launches):  # ---- the main path, counted ----
                tr.train()
        except torch.cuda.OutOfMemoryError as e:
            if fwd_chunk:
                raise
            out[fwd_chunk] = {"fits": False, "error": str(e).splitlines()[0]}
            print(f"{tag}: does not fit on the card ({smi}): {out[fwd_chunk]}", flush=True)
            break
        chunks = batch // fwd_chunk if fwd_chunk else None
        check_launches(tag, launches, want_launches(depth, LARGE_STEPS, True, chunks=chunks))
        losses = rec.loss_values()
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{tag}: non-finite loss {losses}")
        r = {"recipe": "large_batch_pod.json", "batch": batch, "fwd_chunk": fwd_chunk,
             "remat": tr.tower_cfg.video.remat_policy, "fits": True, "losses": losses,
             "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
             "mem_held_gib": held, "launches": launches,
             **speed(rec.step_ms(LARGE_STEPS), batch, flops_per_clip_step(tr.tower_cfg))}
        host = next(iter(train[0]))
        host.pop("meta")
        expect = [("space_attention_bwd_kernel", depth * (chunks or 1))]
        busy, _, groups, _ = device_trace(lambda: rec.step(tr.state, host), PROFILED_STEPS,
                                          expect=expect)
        r.update(device_busy_ms=busy, idle_share=1 - busy / r["step_ms"],
                 device_ms_by_group=groups)
        print(f"{tag} ({smi}): " + json.dumps(r), flush=True)
        out[fwd_chunk] = r
        all_launches.append(launches)
        del tr, rec
    return out, all_launches


# ------------------------------------------------------------------ objects
OBJECT_CONFIGS = {  # the object-aware recipes: variant → config
    "global_local": os.path.join(HERE, "configs", "pt", "cc3m_webvid", "local_region_loss.json"),
    "region_mem": os.path.join(HERE, "configs", "pt", "webvid", "region_mem.json"),
}
OBJECTS_LEN_EPOCH = 8    # steps per epoch of each object-aware recipe
OBJECT_BOXES = (10, 36)  # boxes in a clip's BUTD npz, drawn inclusive


def object_corpus(base, object_dir, options, seed=0):
    """`base`'s clips and captions (MemoryClips) as a dataset of the port's
    `ObjectAwareDataset` with `options`' extras: each clip's frame indices
    are 0..3 of a 4-frame source, so its aligned extraction slot is 0 and its
    1-frame object frame is its first frame; clip i's slot-0 BUTD npz under
    object_dir holds 10-36 boxes on the 256² frame, class ids in
    [0, 1600), confidences and 2048-d features, from `seed`."""
    from oatx_torch.data.datasets.base import ObjectAwareDataset

    class ObjectClips(ObjectAwareDataset):
        dataset_name = "ObjectClips"
        captions = base.captions

        def __len__(self):
            return len(base)

        def _get_object_path(self, rec, frame_index=0):
            return os.path.join(object_dir, f"clip{rec}", f"{frame_index}.npz")

        def _decode_object_frame(self, rec, frame_index):
            return base.videos[rec][frame_index:frame_index + 1]

        def get_sample(self, i, rng):
            sample = base.get_sample(i, rng)
            self._add_object_extras(sample, i, list(range(CORPUS_FRAMES)), CORPUS_FRAMES, rng)
            return sample

    ds = ObjectClips(options)
    rng = np.random.default_rng(seed)
    for i in range(len(base)):
        n = int(rng.integers(OBJECT_BOXES[0], OBJECT_BOXES[1] + 1))
        x1, y1 = rng.uniform(0, CANON - 32, (2, n))
        x2 = np.minimum(x1 + rng.uniform(16, 128, n), CANON)
        y2 = np.minimum(y1 + rng.uniform(16, 128, n), CANON)
        os.makedirs(os.path.join(object_dir, f"clip{i}"), exist_ok=True)
        np.savez(ds._get_object_path(i, 0),
                 x=rng.standard_normal((n, 2048)).astype(np.float32),
                 bbox=np.stack([x1, y1, x2, y2], axis=1).astype(np.float32),
                 info={"objects_id": rng.integers(0, 1600, n),
                       "objects_conf": rng.uniform(0.1, 1.0, n).astype(np.float32),
                       "image_w": float(CANON), "image_h": float(CANON)})
    return ds


def object_flops_per_clip_step(cfg, pad_len):
    """Model FLOPs of one clip's train step (3× the forward) at each stream's
    shape, from train/flops.py's formula: the 4-frame clip with its caption
    (TEXT_LEN tokens), plus the 1-frame object frame with, for global_local,
    the caption + tags stream (pad_len tokens; the formula's text part at
    seq_len 0 is its projection alone, taken off for region_mem)."""
    from oatx_torch.train.flops import flops_forward_per_clip

    frame = dataclasses.replace(cfg.video, num_frames=1)
    second = (flops_forward_per_clip(frame, cfg.text, pad_len) if cfg.variant == "global_local"
              else flops_forward_per_clip(frame, cfg.text, 0) - 2 * cfg.text.dim * 256)
    return 3.0 * (flops_forward_per_clip(cfg.video, cfg.text, TEXT_LEN) + second)


def objects_recipe(variant, tmp, smi, dev, base):
    """One object-aware recipe through Trainer.train() at its per-GPU batch
    (module docstring, phase 6); returns its record and launch counts."""
    from oatx_torch.data import factory
    from oatx_torch.data.loader import Collator, ShardedLoader
    from oatx_torch.data.tokenizer import WordPieceTokenizer
    from oatx_torch.train import step as steplib
    from oatx_torch.train.trainer import Trainer

    exp = recipe(OBJECT_CONFIGS[variant], epochs=TRAINER_EPOCHS, len_epoch=OBJECTS_LEN_EPOCH,
                 save_period=1, verbosity=1)
    dl = exp.data_loaders[0]
    batch = dl.batch_size
    opts = factory.object_options_for_variant(variant, dl, factory.load_region_bank(exp))
    ds = object_corpus(base, os.path.join(tmp, "objects"), opts)
    tok = WordPieceTokenizer.build_from_corpus(ds.captions + [f"obj{i}" for i in range(1600)])
    col = Collator(tok, max_text_len=TEXT_LEN,
                   tag_token_lens=factory.tag_token_lens_for(ds, tok) if opts.tags else None)

    def loaders():
        return ([ShardedLoader(ds, batch, col, seed=0, num_workers=4)],
                [ShardedLoader(ds, batch, col, shuffle=False, drop_last=False,
                               num_workers=4)])

    tag = f"objects {variant}@{batch}"
    train, valid = loaders()
    held = fresh_peak(dev)
    t0 = time.perf_counter()
    tr = Trainer(exp, train, valid, save_dir=os.path.join(tmp, variant), device=dev)
    cfg = tr.tower_cfg
    depth = cfg.video.depth
    # the blocks of (clip, object frame) the loss reaches: region_mem's object
    # frame only through the layer-K tap
    reached = (depth, depth if variant == "global_local" else cfg.video.region_tap_layer)
    print(f"{tag}: Trainer built in {time.perf_counter() - t0:.1f} s ({cfg.variant}, "
          f"region tap {cfg.video.region_tap_layer}, pooling {cfg.video.pooling}, "
          f"remat {cfg.video.remat})", flush=True)
    rec = StepRecorder(tr)
    launches = {}
    t0 = time.perf_counter()
    with counted(launches):  # ---- the main path, counted ----
        hist = tr.train()
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    steps = TRAINER_EPOCHS * OBJECTS_LEN_EPOCH
    check_launches(tag, launches, want_launches(
        depth, steps, False, forwards=eval_forwards(1 + TRAINER_EPOCHS, len(ds), batch),
        backward_depths=reached))
    terms = rec.term_values()
    losses = terms["loss"]
    bad = [k for k, v in terms.items() if not all(np.isfinite(v))]
    if bad or not np.mean(losses[-2:]) < np.mean(losses[:2]):
        raise AssertionError(f"{tag}: a loss term not finite ({bad}) or the loss not "
                             f"falling: {terms}")
    log = [tr.init_val_log] + [hist[e] for e in range(1, TRAINER_EPOCHS + 1)]
    out = {"recipe": os.path.basename(OBJECT_CONFIGS[variant]), "variant": variant,
           "batch": batch, "remat": cfg.video.remat, "backward_blocks": reached,
           "terms_first_last": {k: [v[0], v[-1]] for k, v in terms.items()},
           "losses": losses, "val_loss": [e["val_loss_0"] for e in log],
           "t2v_R1": [e["val_0_t2v_R1"] for e in log], "v2t_R1": [e["val_0_v2t_R1"] for e in log],
           "input_wait": [hist[e]["input_wait"] for e in range(1, TRAINER_EPOCHS + 1)],
           "train_wall_s": wall_s, "peak_mem_gib": peak, "mem_held_gib": held,
           "launches": launches, "launches_per_step": {
               k: v for k, v in want_launches(depth, 1, False,
                                              backward_depths=reached).items() if v},
           **speed(rec.step_ms(OBJECTS_LEN_EPOCH), batch,
                   object_flops_per_clip_step(cfg, col.max_pad_text_len))}

    # one step's gradients on a fixed batch, kernels vs plain versions (not counted)
    host = next(iter(train[0]))
    host.pop("meta")
    fixed = steplib.make_augmenter(train=False, tower_cfg=cfg)(
        None, {k: torch.from_numpy(v).to(dev) for k, v in host.items()})
    model = tr.state.model

    def grads():
        model.zero_grad(set_to_none=True)
        loss, _ = steplib.loss_fn(model, tr.loss_cfg, fixed)
        loss.backward()
        return {n: (p.grad.detach().clone() if p.grad is not None else None)
                for n, p in model.named_parameters()}

    got = grads()
    with plain_versions():
        ref = grads()
    model.zero_grad(set_to_none=True)
    missing = [n for n, g in got.items()
               if g is None or not bool(torch.isfinite(g).all()) or not bool(g.any())]
    if missing:
        raise AssertionError(f"{tag}: {len(missing)} parameters without a finite, non-zero "
                             f"gradient through the kernels, e.g. {missing[:5]}")
    heads = [n for n in got if n.startswith(("video_model.region_norm", "txt_proj_2",
                                             "text_local_proj", "vid_local_proj"))]
    out.update(grad_check(got, ref), head_tensors=len(heads))
    if out["grad_tol_used"] > 1 or out["grad_norm_rel_diff"] > GRAD_NORM_RTOL \
            or out["grad_global_cosine"] < GRAD_MIN_GLOBAL_COSINE:
        raise AssertionError(f"{tag}: gradients through the kernels disagree with the "
                             f"plain versions: {out['grad_worst']}")
    del got, ref, fixed

    del tr, model
    expect = [("ln_mlp_", 2 * depth), ("space_attention_kernel", 2 * depth),
              ("space_attention_bwd_kernel", sum(reached))]
    out["resume"], launches2, trace = resume_epoch2(
        tag, exp, loaders, os.path.join(tmp, variant, "checkpoint-epoch1"), dev,
        OBJECTS_LEN_EPOCH, expect,
        want_launches(depth, OBJECTS_LEN_EPOCH, False, forwards=eval_forwards(2, len(ds), batch),
                      backward_depths=reached), terms)
    out.update(trace)
    print(f"{tag} ({smi}): " + json.dumps(out), flush=True)
    return out, [launches, launches2]


def objects_phase(smi, dev):
    """The object-aware recipes through Trainer.train() (module docstring,
    phase 6)."""
    base = MemoryClips(CORPUS_CLIPS, seed=0)
    runs, launches = {}, []
    for variant in OBJECT_CONFIGS:
        with tempfile.TemporaryDirectory() as tmp:
            runs[variant], more = objects_recipe(variant, tmp, smi, dev, base)
        launches += more
    print(f"objects summary ({smi}): " + json.dumps({
        v: {k: r[k] for k in ("step_ms", "step_ms_spread", "clips_per_s", "mfu",
                              "device_busy_ms", "idle_share", "peak_mem_gib", "t2v_R1",
                              "v2t_R1", "terms_first_last")}
        for v, r in runs.items()}), flush=True)
    return {name: sum(l[name] for l in launches) for name in launches[0]}


def trainer_phase(smi, dev, keep_dir=None):
    """Trainer.train() at full width (module docstring, phase 5); with
    `keep_dir`, norm.json's checkpoint-epoch1 is moved there (phase 17's
    initial weights)."""
    ds = MemoryClips(CORPUS_CLIPS, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        norm, launches = norm_recipe(tmp, smi, dev, ds)
        if keep_dir is not None:
            os.rename(os.path.join(tmp, "norm", "checkpoint-epoch1"),
                      os.path.join(keep_dir, "checkpoint-epoch1"))
    lap("5 trainer: norm and its resume")
    remat, more = remat_runs(smi, dev, ds)
    launches += more
    lap("5 trainer: remat")
    large, more = large_batch_recipe(smi, dev)
    launches += more
    rows = [("norm@16 trainer", norm)] + [(f"norm@16 remat {k}", v) for k, v in remat.items()] \
        + [(f"large_batch@64 fwd_chunk {k}", v) for k, v in large.items() if v.get("fits")]
    print(f"trainer summary ({smi}): " + json.dumps({
        name: {k: r[k] for k in ("step_ms", "step_ms_spread", "clips_per_s", "mfu",
                                 "idle_share", "peak_mem_gib") if k in r}
        for name, r in rows}), flush=True)
    return {name: sum(l[name] for l in launches) for name in launches[0]}


# -------------------------------------------------------------------- data
DATA_CLIPS = (64, 16)       # WebVid train / val clips (tools/bench_train_e2e.py's geometry)
DATA_CLIP_SIZE = (320, 240, 64)
DATA_STILLS = (64, 16)      # CC3M train / val JPEG stills
DATA_STILL_SIZE = (400, 300)
DATA_MSRVTT = 32            # MSR-VTT test clips (jsfusion cut)
DATA_MSRVTT_FRAMES = 32
DATA_CYCLES = 4             # cycles (one CC3M + one WebVid step) per epoch
DATA_WINDOW_STRIDE = 2
DATA_DECODE_PASSES = 2      # passes over the WebVid train clips per decode-rate reading


def data_caption(kind, i):
    """Six words no other caption shares (as MemoryClips' captions)."""
    return " ".join(f"{w}{kind}{i}" for w in WORDS)


def write_corpora(root):
    """The WebVid, CC3M and MSR-VTT layouts the adapters read (oatx's adapter
    tests' layouts), each clip / still seeded apart (fixture_seeded), written
    by the port's writer on 8 threads. MJPEG-in-AVI content sits under the
    adapters' `.mp4` names. → (seconds spent, files)."""
    from oatx_torch.data import video_reader as vr

    jobs = []
    w, h, nf = DATA_CLIP_SIZE
    web = os.path.join(root, "webvid")
    for split, n, tsv, base in (("train", DATA_CLIPS[0], "webvid_training_success_full.tsv", 1),
                                ("val", DATA_CLIPS[1], "webvid_validation_success_full.tsv",
                                 1000)):
        os.makedirs(os.path.join(web, split), exist_ok=True)
        os.makedirs(os.path.join(web, "meta_data"), exist_ok=True)
        rows = ["caption\tvideoid"]
        for i in range(n):
            vid = str(base + i)
            rows.append(f"{data_caption('w', base + i)}\t{vid}")
            jobs.append((vr.write_test_video, (os.path.join(web, split, vid + ".mp4"), w, h, nf, 8,
                                              base + i)))
        with open(os.path.join(web, "meta_data", tsv), "w") as f:
            f.write("\n".join(rows) + "\n")
    cc = os.path.join(root, "cc3m")
    sw, shh = DATA_STILL_SIZE
    for split, sub, n, tsv, base in (("train", "training", DATA_STILLS[0],
                                      "cc3m_training_success_full.tsv", 2000),
                                     ("val", "validation", DATA_STILLS[1],
                                      "cc3m_validation_success_full.tsv", 3000)):
        os.makedirs(os.path.join(cc, sub), exist_ok=True)
        os.makedirs(os.path.join(cc, "meta_data"), exist_ok=True)
        rows = ["caption\tfile"]
        for i in range(n):
            rows.append(f"{data_caption('c', base + i)}\timg{base + i}.jpg")
            jobs.append((vr.write_test_image, (os.path.join(cc, sub, f"img{base + i}.jpg"), sw, shh,
                                              base + i)))
        with open(os.path.join(cc, "meta_data", tsv), "w") as f:
            f.write("\n".join(rows) + "\n")
    vids = [f"video{i}" for i in range(DATA_MSRVTT)]
    jobs += msrvtt_layout(os.path.join(root, "msrvtt"), vids[:4], vids, DATA_MSRVTT_FRAMES)
    return run_jobs(jobs), len(jobs)


def msrvtt_layout(ms, train, test, frames):
    """The MSR-VTT jsfusion layout oatx's adapter tests write under `ms`:
    MSR_VTT.json with three captions a clip, the train and val lists,
    each test clip's designated caption; → the clips' write jobs (test
    clip i seeded 4000 + i, train clip i 6000 + i; ids may be in both)."""
    import pickle

    from oatx_torch.data import video_reader as vr

    w, h, _ = DATA_CLIP_SIZE
    sdir = os.path.join(ms, "high-quality", "structured-symlinks")
    os.makedirs(sdir, exist_ok=True)
    os.makedirs(os.path.join(ms, "annotation"), exist_ok=True)
    os.makedirs(os.path.join(ms, "videos", "all"), exist_ok=True)
    seeds = {**{v: 6000 + i for i, v in enumerate(train)}, **{v: 4000 + i for i, v in
                                                              enumerate(test)}}
    anns = [{"image_id": v, "caption": data_caption(f"m{c}x", seeds[v])}
            for v in seeds for c in range(3)]
    with open(os.path.join(ms, "annotation", "MSR_VTT.json"), "w") as f:
        json.dump({"annotations": anns}, f)
    with open(os.path.join(sdir, "train_list_jsfusion.txt"), "w") as f:
        f.write("\n".join(train) + "\n")
    with open(os.path.join(sdir, "val_list_jsfusion.txt"), "w") as f:
        f.write("\n".join(test) + "\n")
    with open(os.path.join(sdir, "jsfusion_val_caption_idx.pkl"), "wb") as f:
        pickle.dump({v: i % 3 for i, v in enumerate(test)}, f)
    return [(vr.write_test_video, (os.path.join(ms, "videos", "all", v + ".mp4"), w, h, frames,
                                   8, seed)) for v, seed in seeds.items()]


def run_jobs(jobs):
    """(fn, args) jobs on 8 threads → seconds spent."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        for fut in [pool.submit(fn, *args) for fn, args in jobs]:
            fut.result()
    return time.perf_counter() - t0


def decode_rate(root, workers):
    """ms per clip of probe + 4-frame decode at short side 256 (read_frames,
    the dataset's call) over the WebVid train clips, on one thread and on
    `workers` threads (wall time over clips: the loader's throughput)."""
    from concurrent.futures import ThreadPoolExecutor

    from oatx_torch.data import video_reader as vr

    paths = sorted(os.path.join(root, "webvid", "train", p)
                   for p in os.listdir(os.path.join(root, "webvid", "train")))
    work = paths * DATA_DECODE_PASSES

    def one(i_path):
        i, p = i_path
        frames, _, _ = vr.read_frames(p, 4, rng=np.random.default_rng(i), short_side=256)
        assert frames.shape == (4, 256, 340, 3), frames.shape

    one((0, paths[0]))  # the build, outside the timing
    t0 = time.perf_counter()
    for item in enumerate(work):
        one(item)
    single = (time.perf_counter() - t0) / len(work) * 1e3
    t0 = time.perf_counter()
    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(one, enumerate(work)))
    multi = (time.perf_counter() - t0) / len(work) * 1e3
    return {"clips": len(work), "ms_per_clip_1_thread": single,
            f"ms_per_clip_{workers}_threads": multi, "clips_per_s": 1e3 / multi,
            "threads": workers, "decoder": vr.native_version()}


def mixed_flops_per_clip_step(cfg):
    """A step's FLOPs per clip averaged over norm.json's alternation of a
    1-frame CC3M batch and a 4-frame WebVid batch."""
    one = dataclasses.replace(cfg, video=dataclasses.replace(cfg.video, num_frames=1))
    return (flops_per_clip_step(one) + flops_per_clip_step(cfg)) / 2


def cycle_speed(rec, trace_at, per_epoch, batch, flops):
    """Speeds of a run that alternates a 1-frame CC3M and a 4-frame WebVid
    loader (`flops`: per clip, averaged over the cycle). The interval
    between the events of steps i - 1 and i times step i (1-based), which
    is loader (i - 1) % 2's; an epoch's first step and the traced steps
    (from `trace_at` on) are left out. Per-loader speeds carry no clips/s
    or MFU: those are the cycle's."""
    torch.cuda.synchronize()
    by_loader = [[], []]
    for i in range(2, trace_at):
        if (i - 1) % per_epoch:
            by_loader[(i - 1) % 2].append(rec.events[i - 2].elapsed_time(rec.events[i - 1]))
    cycle_ms = sum(float(np.median(b)) for b in by_loader)
    per = [speed(b, batch, flops) for b in by_loader]
    for r in per:
        del r["clips_per_s"], r["mfu"]
    return {"step_ms_cc3m": per[0], "step_ms_webvid": per[1], "cycle_ms": cycle_ms,
            "clips_per_s": 2 * batch / cycle_ms * 1e3,
            "mfu": 2 * batch / cycle_ms * 1e3 * flops / PEAK_BF16_FLOPS}


@contextlib.contextmanager
def recorded_trainers(out, trace_at=None, on_init=None):
    """Every Trainer built inside gets a StepRecorder (appended to `out` with
    the Trainer's history when train() returns), tracing PROFILED_STEPS
    steps from `trace_at` on; `on_init(trainer)` runs once it is built,
    before its first step."""
    from oatx_torch.train import trainer as trainer_mod

    cls = trainer_mod.Trainer
    init, train = cls.__init__, cls.train

    def rec_init(self, *a, **k):
        init(self, *a, **k)
        depth = self.tower_cfg.video.depth
        expect = [("ln_mlp_", depth), ("space_attention_kernel", depth),
                  ("space_attention_bwd_kernel", depth)]
        out.append({"trainer": self, "rec": StepRecorder(self, trace_at, expect)})
        if on_init is not None:
            on_init(self)

    def rec_train(self):
        hist = train(self)
        next(r for r in out if r["trainer"] is self)["hist"] = hist
        return hist

    cls.__init__, cls.train = rec_init, rec_train
    try:
        yield
    finally:
        cls.__init__, cls.train = init, train


def data_train(root, tmp, smi, dev):
    """cli.train on norm.json over the written corpora (phase 7, step 2)."""
    from oatx_torch.cli import train as cli_train

    with open(NORM_CONFIG) as f:
        raw = json.load(f)
    for dl, name in zip(raw["data_loader"], ("cc3m", "webvid")):
        dl["args"].update(data_dir=os.path.join(root, name), metadata_dir=os.path.join(root, name))
        # strict: a file the decoder fails on raises instead of being replaced
        dl["args"]["video_params"]["loading"] = "strict"
    batch = raw["data_loader"][0]["args"]["batch_size"]
    raw["trainer"].update(epochs=TRAINER_EPOCHS, save_period=1, verbosity=1,
                          save_dir=os.path.join(tmp, "exps"),
                          max_samples_per_epoch=DATA_CYCLES * batch * len(raw["data_loader"]))
    cfg = os.path.join(tmp, "norm_data.json")
    with open(cfg, "w") as f:
        json.dump(raw, f)
    made = []
    held = fresh_peak(dev)
    launches = {}
    steps = TRAINER_EPOCHS * DATA_CYCLES * len(raw["data_loader"])
    trace_at = steps - PROFILED_STEPS + 1  # the run's last CC3M and WebVid steps
    t0 = time.perf_counter()
    with recorded_trainers(made, trace_at), counted(launches):  # ---- the main path ----
        rc = cli_train.main(["-c", cfg, "--no_timestamp"])
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if rc != 0 or len(made) != 1 or "hist" not in made[0]:
        raise AssertionError(f"data train: cli.train returned {rc}, {len(made)} trainers")
    tr, rec, hist = made[0]["trainer"], made[0]["rec"], made[0]["hist"]
    depth = tr.tower_cfg.video.depth
    val_forwards = sum(eval_forwards(1 + TRAINER_EPOCHS, len(l.dataset), l.batch_size)
                       for l in tr.valid_loaders)
    check_launches("data train", launches, want_launches(depth, steps, False,
                                                         forwards=val_forwards))
    save_dir = os.path.join(tmp, "exps", "models", raw["name"])
    for name in ("vocab.txt", f"checkpoint-epoch{TRAINER_EPOCHS}"):
        if not os.path.exists(os.path.join(save_dir, name)):
            raise AssertionError(f"data train: {name} not written in {save_dir}")
    losses = rec.loss_values()
    per_loader = [losses[i::2] for i in range(2)]
    terms = rec.term_values()
    if not all(np.isfinite(v).all() for v in terms.values()):
        raise AssertionError(f"data train: a loss term is not finite: {terms}")
    for i, ls in enumerate(per_loader):
        if not np.mean(ls[-2:]) < np.mean(ls[:2]):
            raise AssertionError(f"data train: loader {i}'s loss does not fall: {ls}")
    waits = [hist[e]["input_wait"] for e in sorted(hist)]
    out = {"config": "norm.json", "loaders": [l.dataset.dataset_name for l in tr.train_loaders],
           "batch": batch, "steps": steps, "losses_cc3m": per_loader[0],
           "losses_webvid": per_loader[1], "input_wait": waits,
           "val_loss": [hist[e]["val_loss_0"] for e in sorted(hist)],
           "t2v_R1": [hist[e]["val_0_t2v_R1"] for e in sorted(hist)],
           "train_wall_s": wall_s, "peak_mem_gib": peak, "mem_held_gib": held,
           "launches": launches,
           **cycle_speed(rec, trace_at, DATA_CYCLES * len(raw["data_loader"]), batch,
                         mixed_flops_per_clip_step(tr.tower_cfg)),
           "trace_cc3m_webvid": rec.traced()}
    print(f"data train ({smi}): input_wait {waits}, step ms CC3M 1-frame "
          f"{out['step_ms_cc3m']['step_ms']:.1f}, WebVid 4-frame "
          f"{out['step_ms_webvid']['step_ms']:.1f}, clips/s {out['clips_per_s']:.1f}, idle "
          f"share {out['trace_cc3m_webvid']['idle_share']:.3f}, peak {peak:.2f} GiB: "
          + json.dumps(out), flush=True)
    del tr, made
    return out, launches, os.path.join(save_dir, f"checkpoint-epoch{TRAINER_EPOCHS}")


def data_test(root, tmp, smi, dev, ckpt):
    """cli.test on zsl/normal.json with sliding windows over the MSR-VTT
    corpus, from the trained checkpoint (phase 7, step 3)."""
    from oatx_torch.cli import test as cli_test
    from oatx_torch.config.schema import ExperimentCfg, build_tower_config
    from oatx_torch.eval import retrieval_eval

    with open(CONFIG) as f:  # configs/ft/msrvtt/zsl/normal.json
        raw = json.load(f)
    raw["data_loader"]["args"].update(data_dir=os.path.join(root, "msrvtt"))
    cfg = os.path.join(tmp, "zsl_data.json")
    with open(cfg, "w") as f:
        json.dump(raw, f)
    seen = {}
    evaluate = retrieval_eval.evaluate

    def keep(*a, **k):
        seen["result"] = r = evaluate(*a, **k)
        seen["loader"] = a[2]
        return r

    retrieval_eval.evaluate = keep
    launches = {}
    t0 = time.perf_counter()
    try:
        with counted(launches):  # ---- the main path, counted ----
            rc = cli_test.main(["-c", cfg, "-r", ckpt,
                                "--sliding_window_stride", str(DATA_WINDOW_STRIDE)])
    finally:
        retrieval_eval.evaluate = evaluate
    wall_s = time.perf_counter() - t0
    if rc != 0 or "result" not in seen:
        raise AssertionError(f"data test: cli.test returned {rc}")
    res, loader = seen["result"], seen["loader"]
    rows = len(loader.dataset)
    if res.video_embeds.shape[0] != DATA_MSRVTT or res.sims.shape != (DATA_MSRVTT, DATA_MSRVTT) \
            or rows <= DATA_MSRVTT:
        raise AssertionError(f"data test: {rows} window rows gave {res.video_embeds.shape[0]} "
                             f"videos, sims {res.sims.shape}")
    forwards = -(-rows // loader.batch_size) * -(-loader.batch_size // 8)
    depth = build_tower_config(ExperimentCfg.from_dict(raw).arch).video.depth
    check_launches("data test", launches, {"ln_mlp": forwards * depth,
                                           "space_attention": forwards * depth,
                                           "space_attention_bwd": 0, "ln_linear": 0})
    if not (np.isfinite(res.text_embeds).all() and np.isfinite(res.video_embeds).all()):
        raise AssertionError("data test: embeddings not finite")
    for name, m in res.metrics.items():
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"data test: {name} not finite: {m}")
    out = {"config": "zsl/normal.json", "videos": DATA_MSRVTT, "window_rows": rows,
           "stride": DATA_WINDOW_STRIDE, "forwards": forwards, "launches": launches,
           "t2v_R1": res.metrics["t2v_metrics"]["R1"],
           "v2t_R1": res.metrics["v2t_metrics"]["R1"], "wall_s": wall_s}
    print(f"data test ({smi}): " + json.dumps(out), flush=True)
    l_index = data_index(cfg, tmp, smi, ckpt, {"ln_mlp": forwards * depth,
                                               "space_attention": forwards * depth,
                                               "space_attention_bwd": 0, "ln_linear": 0})
    return out, {name: n + l_index[name] for name, n in launches.items()}


def data_index(cfg, tmp, smi, ckpt, want):
    """cli.build_index on the same split, windows and checkpoint as
    cli.test (phase 7, step 4), then one /search of a server on the index it
    saved. → its launches, which must equal `want` (cli.test's)."""
    from oatx_torch.cli import build_index
    from oatx_torch.cli.serve import build_service, make_server
    from oatx_torch.serve.retrieval_index import RetrievalIndex

    path = os.path.join(tmp, "msrvtt_index.npz")
    launches, buf = {}, io.StringIO()
    t0 = time.perf_counter()
    with counted(launches), contextlib.redirect_stdout(buf):  # ---- counted ----
        rc = build_index.main(["-c", cfg, "-r", ckpt, "--sliding_window_stride",
                               str(DATA_WINDOW_STRIDE), "--index-out", path])
    wall_s = time.perf_counter() - t0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or line["videos"] != DATA_MSRVTT or line["split"] != "test":
        raise AssertionError(f"data index: cli.build_index returned {rc}: {line}")
    check_launches("data index", launches, want)
    ids = RetrievalIndex.load(path, device="cpu").ids
    svc, tok, index, our = build_service(["-c", cfg, "--port", "0", "--buckets", "1",
                                          "--index", path])
    server = make_server(svc, tok, index, our)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        res = post(url + "/search", {"texts": ["a video of people"], "k": 5})["results"][0]
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)
    scores = [h["score"] for h in res]
    if len(res) != 5 or scores != sorted(scores, reverse=True) or \
            not all(h["id"] in ids for h in res) or len(set(ids)) != DATA_MSRVTT:
        raise AssertionError(f"data index: /search on the saved index: {res}")
    print(f"data index ({smi}): " + json.dumps({**line, "wall_s": wall_s,
                                                "launches": launches, "search_top5": res}),
          flush=True)
    return launches


def data_phase(smi, dev):
    """The file-backed data plane and the CLIs (module docstring, phase 7)."""
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "corpora")
        t0 = time.perf_counter()
        from oatx_torch.data import video_reader as vr

        vr.native_version()  # the decoder's build (c++), timed apart
        build_s = time.perf_counter() - t0
        write_s, files = write_corpora(root)
        rate = decode_rate(root, json.load(open(NORM_CONFIG))["data_loader"][1]["args"]
                           ["num_workers"])
        print(f"data corpora ({smi}): decoder built in {build_s:.1f} s; {files} files written "
              f"in {write_s:.1f} s; decode rate: " + json.dumps(rate), flush=True)
        train, l_train, ckpt = data_train(root, tmp, smi, dev)
        test, l_test = data_test(root, tmp, smi, dev, ckpt)
        print(f"data summary ({smi}): " + json.dumps({
            "decode_ms_per_clip": [rate["ms_per_clip_1_thread"],
                                   rate[f"ms_per_clip_{rate['threads']}_threads"]],
            "input_wait": train["input_wait"],
            "step_ms_cc3m_webvid": [train["step_ms_cc3m"]["step_ms"],
                                    train["step_ms_webvid"]["step_ms"]],
            "clips_per_s": train["clips_per_s"], "mfu": train["mfu"],
            "idle_share": train["trace_cc3m_webvid"]["idle_share"],
            "peak_mem_gib": train["peak_mem_gib"],
            "t2v_R1": test["t2v_R1"], "phase_s": time.perf_counter() - t0}), flush=True)
    return {name: l_train[name] + l_test[name] for name in l_train}


# ------------------------------------------------------------------ towers
TOWERS_LEN_EPOCH = 4        # steps per epoch of phase 8's Trainer runs (2 epochs; region 1)
TOWERS_CLIP_CYCLES = 4      # cli.train cycles (a CC3M and a WebVid step) of the CLIP run, 1 epoch
STREAM3_NCE_WEIGHT = 0.5    # oatx's tests/test_object_tower.py:177; no shipped config sets one
STREAM3_TOP_K = 10
CLIP_TEXT_MODEL = "openai/clip-vit-base-patch32"  # a clip* name: CLIP ViT-B's text tower
REGION_CLASSES = 1600       # BUTD classes after __background__
TOWER_EXPECT = (("ln_mlp_", 12), ("space_attention_kernel", 12),
                ("space_attention_bwd_kernel", 12))  # one 12-block stream per traced step


def text_flops(tcfg, family, seq_len):
    """Matmul FLOPs of one caption's text-tower forward at `seq_len` tokens,
    txt_proj (→ 256) included: (distil)bert as train/flops.py counts its
    text part (bert adds its pooler); CLIP text with its 4·W MLP and the EOT
    row's text_projection."""
    if family == "clip":
        w, e = tcfg.width, tcfg.embed_dim
        block = 8 * seq_len * w * w + 16 * seq_len * w * w + 4 * seq_len * seq_len * w
        return tcfg.layers * block + 2 * w * e + 2 * e * 256
    d = tcfg.dim
    block = 8 * seq_len * d * d + 4 * seq_len * d * tcfg.hidden_dim + 4 * seq_len * seq_len * d
    return tcfg.n_layers * block + (2 * d * d if family == "bert" else 0) + 2 * d * 256


def object_flops(ocfg, slots):
    """Matmul FLOPs of the object tower's forward over `slots` objects, its
    embedding, attention pooling and obj_proj (→ 256) included."""
    d = ocfg.dim
    block = 8 * slots * d * d + 4 * slots * d * ocfg.hidden_dim + 4 * slots * slots * d
    return 2 * slots * ocfg.feature_dim * d + ocfg.n_layers * block + 4 * slots * d + 2 * d * 256


def towers_flops_per_clip_step(cfg, seq_len, slots=0):
    """3× the forward of one clip at each stream's own shape: the video tower
    (train/flops.py's video part), the text tower at `seq_len`, and the
    object tower over `slots` objects when the loss runs it."""
    import types

    from oatx_torch.train.flops import flops_forward_per_clip

    video = flops_forward_per_clip(cfg.video, types.SimpleNamespace(dim=0, hidden_dim=0,
                                                                    n_layers=0), 0)
    obj = object_flops(cfg.object_tower, slots) if slots else 0.0
    return 3.0 * (video + text_flops(cfg.text, cfg.text_family, seq_len) + obj)


def tower_speed(rec, per_epoch, batch, cfg, seq_len, slots=0):
    """`speed` by the per-stream count over the run's untraced steps, with
    train/flops.py's count beside it where its formula applies (a text
    config with dim / hidden_dim / n_layers; it counts no object tower)."""
    flops = towers_flops_per_clip_step(cfg, seq_len, slots)
    ms = rec.step_ms(per_epoch)
    if rec.trace_at is not None:  # the traced steps close the run
        ms = ms[:-PROFILED_STEPS]
    out = {**speed(ms, batch, flops), "flops_per_clip_step": flops}
    old = flops_per_clip_step(cfg) if hasattr(cfg.text, "dim") else None
    out["flops_py_per_clip_step"] = old
    out["mfu_flops_py"] = out["mfu"] * old / flops if old else None
    return out


def norm_raw(**trainer):
    """norm.json as a dict, its trainer keys set for phase 8 (no init_val,
    no monitor, no checkpoint)."""
    with open(NORM_CONFIG) as f:
        raw = json.load(f)
    raw["trainer"].update(init_val=False, monitor="off", verbosity=1, **trainer)
    return raw


class FrozenCheck:
    """Wraps a Trainer's train_step: after every step each tensor named under
    `roots` must equal its value before the run, bitwise."""

    def __init__(self, trainer, roots):
        self.step, self.roots, self.steps = trainer.train_step, roots, 0
        self.before = {n: p.detach().clone() for n, p in trainer.state.model.named_parameters()
                       if n.startswith(roots)}
        trainer.train_step = self

    def __call__(self, state, batch):
        state, m = self.step(state, batch)
        moved = [n for n, p in state.model.named_parameters()
                 if n in self.before and not torch.equal(p.detach(), self.before[n])]
        if moved or len(self.before) == 0:
            raise AssertionError(f"frozen {self.roots} changed at step {self.steps + 1}: "
                                 f"{moved[:5]} of {len(self.before)}")
        self.steps += 1
        return state, m


def stream3_run(weight, tmp, smi, dev, base):
    """norm.json's towers with arch.stream 3 (object_nce_weight `weight`)
    through Trainer.train() over the 32 clips with BUTD features (phase 8,
    run 1); at weight 0 the object tower must stay bitwise frozen, at 0.5 it
    must move, and retrieval_eval.evaluate reports its o2v / o2t streams."""
    from oatx_torch.config.schema import ExperimentCfg
    from oatx_torch.data import factory
    from oatx_torch.data.loader import Collator, ShardedLoader
    from oatx_torch.data.tokenizer import WordPieceTokenizer
    from oatx_torch.eval import retrieval_eval
    from oatx_torch.train.trainer import Trainer

    raw = norm_raw(epochs=TRAINER_EPOCHS, len_epoch=TOWERS_LEN_EPOCH, save_period=100)
    raw["arch"]["stream"] = 3
    raw["arch"]["args"]["object_params"].update(input_objects=True, top_k=STREAM3_TOP_K)
    raw["data_loader"][0]["args"]["object_params"] = {"input_objects": True,
                                                      "top_k": STREAM3_TOP_K}
    raw["loss"]["args"]["object_nce_weight"] = weight
    exp = ExperimentCfg.from_dict(raw)
    dl = exp.data_loaders[0]
    batch = dl.batch_size
    opts = factory.object_options_for_variant("baseline", dl)
    if not (opts.features and opts.features_top_k == STREAM3_TOP_K):
        raise AssertionError(f"stream 3: the loader's options serve no features: {opts}")
    ds = object_corpus(base, os.path.join(tmp, "objects"), opts)
    col = Collator(WordPieceTokenizer.build_from_corpus(ds.captions), max_text_len=TEXT_LEN)
    tag = f"towers stream3 w{weight}@{batch}"
    held = fresh_peak(dev)
    tr = Trainer(exp, [ShardedLoader(ds, batch, col, seed=0, num_workers=4)],
                 save_dir=os.path.join(tmp, f"stream3_{weight}"), device=dev)
    cfg = tr.tower_cfg
    model = tr.state.model
    if cfg.object_tower is None or not hasattr(model, "object_tower"):
        raise AssertionError(f"{tag}: no object tower built from arch.stream 3")
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.startswith(("object_tower", "obj_proj"))}
    frozen = FrozenCheck(tr, ("object_tower", "obj_proj")) if not weight else None
    steps = TRAINER_EPOCHS * TOWERS_LEN_EPOCH
    rec = StepRecorder(tr, trace_at=None if frozen else steps - PROFILED_STEPS + 1,
                       expect=TOWER_EXPECT)
    launches = {}
    t0 = time.perf_counter()
    with counted(launches):  # ---- the main path, counted ----
        tr.train()
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    depth = cfg.video.depth
    check_launches(tag, launches, want_launches(depth, steps, False))
    terms = rec.term_values()
    want_terms = ["loss", "loss_object"] if weight else ["loss"]
    if sorted(terms) != want_terms or not all(np.isfinite(v).all() for v in terms.values()):
        raise AssertionError(f"{tag}: loss terms {sorted(terms)} (want {want_terms}) or not "
                             f"finite: {terms}")
    for k, v in terms.items():
        if not np.mean(v[-2:]) < np.mean(v[:2]):
            raise AssertionError(f"{tag}: {k} does not fall: {v}")
    moved = [n for n, p in model.named_parameters()
             if n in before and not torch.equal(p.detach(), before[n])]
    if weight and len(moved) != len(before):
        raise AssertionError(f"{tag}: {len(before) - len(moved)} object-tower tensors did not "
                             f"move")
    if not weight and (moved or frozen.steps != steps):
        raise AssertionError(f"{tag}: frozen tensors moved {moved[:5]}, or checked "
                             f"{frozen.steps} of {steps} steps")
    out = {"config": "norm.json + arch.stream 3", "object_nce_weight": weight, "batch": batch,
           "slots": STREAM3_TOP_K, "terms_first_last": {k: [v[0], v[-1]] for k, v in terms.items()},
           "losses": terms["loss"], "object_tensors": len(before),
           "object_tensors_moved": len(moved), "train_wall_s": wall_s, "peak_mem_gib": peak,
           "mem_held_gib": held, "launches": launches,
           **tower_speed(rec, TOWERS_LEN_EPOCH, batch, cfg, TEXT_LEN,
                         STREAM3_TOP_K if weight else 0)}
    if frozen:
        out["frozen_bitwise_steps"] = frozen.steps
    else:
        out.update(rec.traced())
        # the o2v / o2t eval streams over the same clips with their features
        valid = ShardedLoader(ds, batch, col, shuffle=False, drop_last=False, num_workers=4)
        l_eval = {}
        with counted(l_eval):  # ---- the main path, counted ----
            res = retrieval_eval.evaluate(model, cfg, valid, exp.metrics, device=dev)
        fwd = eval_forwards(1, len(ds), batch)
        check_launches(f"{tag} evaluate", l_eval, want_launches(depth, 0, False, forwards=fwd))
        if sorted(res.object_streams) != ["o2t", "o2v"] or res.object_embeds.shape != (
                len(ds), cfg.projection_dim) or not np.isfinite(res.object_embeds).all():
            raise AssertionError(f"{tag} evaluate: streams {sorted(res.object_streams)}, "
                                 f"object embeds {res.object_embeds.shape}")
        for s, ms in res.object_streams.items():
            for name, m in ms.items():
                if not all(np.isfinite(v) for v in m.values()):
                    raise AssertionError(f"{tag} evaluate: {s} {name} not finite: {m}")
        out["eval_R1"] = {f"{s}_{n.split('_')[0]}": ms[n]["R1"]
                          for s, ms in res.object_streams.items() for n in ms}
        out["eval_R1"].update(t2v=res.metrics["t2v_metrics"]["R1"])
        launches = {k: launches[k] + l_eval[k] for k in launches}
    print(f"{tag} ({smi}): " + json.dumps(out), flush=True)
    return out, launches


def bert_run(tmp, smi, dev, base):
    """norm.json with BERT-base text (bert-base-uncased: 12 × 768, post-LN,
    tanh pooler) through Trainer.train() (phase 8, run 2)."""
    from oatx_torch.config.schema import ExperimentCfg
    from oatx_torch.train.trainer import Trainer

    raw = norm_raw(epochs=TRAINER_EPOCHS, len_epoch=TOWERS_LEN_EPOCH, save_period=100)
    raw["arch"]["args"]["text_params"]["model"] = "bert-base-uncased"
    exp = ExperimentCfg.from_dict(raw)
    batch = exp.data_loaders[0].batch_size
    train, _ = corpus_loaders(base, batch, with_valid=False)
    tag = f"towers bert@{batch}"
    held = fresh_peak(dev)
    tr = Trainer(exp, train, save_dir=os.path.join(tmp, "bert"), device=dev)
    cfg = tr.tower_cfg
    t = cfg.text
    if (cfg.text_family, t.dim, t.n_layers, t.n_heads, t.hidden_dim) != ("bert", 768, 12, 12,
                                                                         3072):
        raise AssertionError(f"{tag}: text tower {cfg.text_family} {t}")
    steps = TRAINER_EPOCHS * TOWERS_LEN_EPOCH
    rec = StepRecorder(tr, trace_at=steps - PROFILED_STEPS + 1, expect=TOWER_EXPECT)
    launches = {}
    t0 = time.perf_counter()
    with counted(launches):  # ---- the main path, counted ----
        tr.train()
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check_launches(tag, launches, want_launches(cfg.video.depth, steps, False))
    losses = rec.loss_values()
    if not all(np.isfinite(losses)) or not np.mean(losses[-2:]) < np.mean(losses[:2]):
        raise AssertionError(f"{tag}: loss not finite or not falling: {losses}")
    out = {"config": "norm.json + bert-base-uncased", "batch": batch, "losses": losses,
           "train_wall_s": wall_s, "peak_mem_gib": peak, "mem_held_gib": held,
           "launches": launches, **tower_speed(rec, TOWERS_LEN_EPOCH, batch, cfg, TEXT_LEN),
           **rec.traced()}
    print(f"{tag} ({smi}): " + json.dumps(out), flush=True)
    return out, launches


def clip_run(root, tmp, smi, dev):
    """cli.train on norm.json with CLIP's text tower over the written corpora,
    then cli.test on zsl/normal.json with the same text model from that
    checkpoint (phase 8, run 3)."""
    from oatx_torch.cli import test as cli_test
    from oatx_torch.cli import train as cli_train
    from oatx_torch.config.schema import ExperimentCfg, build_tower_config
    from oatx_torch.data.clip_tokenizer import ClipBatchTokenizer
    from oatx_torch.eval import retrieval_eval

    raw = norm_raw()
    raw["arch"]["args"]["text_params"]["model"] = CLIP_TEXT_MODEL
    for dl, name in zip(raw["data_loader"], ("cc3m", "webvid")):
        dl["args"].update(data_dir=os.path.join(root, name), metadata_dir=os.path.join(root, name))
        dl["args"]["video_params"]["loading"] = "strict"
    batch = raw["data_loader"][0]["args"]["batch_size"]
    raw["trainer"].update(epochs=1, save_period=1, save_dir=os.path.join(tmp, "exps"),
                          max_samples_per_epoch=TOWERS_CLIP_CYCLES * batch * 2)
    cfg_path = os.path.join(tmp, "norm_clip.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    tag = f"towers clip train@{batch}"
    made, launches = [], {}
    steps = TOWERS_CLIP_CYCLES * 2
    trace_at = steps - PROFILED_STEPS + 1  # the run's last CC3M and WebVid steps
    held = fresh_peak(dev)
    t0 = time.perf_counter()
    with recorded_trainers(made, trace_at), counted(launches):
        rc = cli_train.main(["-c", cfg_path, "--no_timestamp"])  # ---- the main path ----
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if rc != 0 or len(made) != 1 or "hist" not in made[0]:
        raise AssertionError(f"{tag}: cli.train returned {rc}, {len(made)} trainers")
    tr, rec = made[0]["trainer"], made[0]["rec"]
    cfg = tr.tower_cfg
    if (cfg.text_family, cfg.text.width, cfg.text.layers, cfg.text.heads,
            cfg.text.context_length) != ("clip", 512, 12, 8, 77):
        raise AssertionError(f"{tag}: text tower {cfg.text_family} {cfg.text}")
    depth = cfg.video.depth
    val_fwd = sum(eval_forwards(1, len(l.dataset), l.batch_size) for l in tr.valid_loaders)
    check_launches(tag, launches, want_launches(depth, steps, False, forwards=val_fwd))
    save_dir = os.path.join(tmp, "exps", "models", raw["name"])
    bpe = os.path.join(save_dir, "clip_bpe.txt.gz")
    ckpt = os.path.join(save_dir, "checkpoint-epoch1")
    if not (os.path.exists(bpe) and os.path.exists(ckpt)):
        raise AssertionError(f"{tag}: clip_bpe.txt.gz or checkpoint-epoch1 not in {save_dir}")
    losses = rec.loss_values()
    if not all(np.isfinite(losses)) or not np.mean(losses[-2:]) < np.mean(losses[:2]):
        raise AssertionError(f"{tag}: loss not finite or not falling: {losses}")
    train_tok = tr.train_loaders[0].collate.tokenizer
    if not isinstance(train_tok, ClipBatchTokenizer):
        raise AssertionError(f"{tag}: tokenizer {type(train_tok).__name__}")
    cycle_flops = sum(towers_flops_per_clip_step(
        dataclasses.replace(cfg, video=dataclasses.replace(cfg.video, num_frames=f)), TEXT_LEN)
        for f in (1, 4)) / 2  # a 1-frame CC3M and a 4-frame WebVid step
    out = {"config": f"norm.json + {CLIP_TEXT_MODEL}", "batch": batch, "steps": steps,
           "losses": losses, "merges": len(train_tok.tok.rank),
           "vocab_size": train_tok.vocab_size, "train_wall_s": wall_s, "peak_mem_gib": peak,
           "mem_held_gib": held, "launches": launches,
           **cycle_speed(rec, trace_at, steps, batch, cycle_flops),
           "flops_per_clip_step": cycle_flops, "flops_py_per_clip_step": None, **rec.traced()}
    del tr, made

    # cli.test from that checkpoint: the persisted tokenizer, the metrics
    with open(CONFIG) as f:  # configs/ft/msrvtt/zsl/normal.json
        zraw = json.load(f)
    zraw["data_loader"]["args"].update(data_dir=os.path.join(root, "msrvtt"))
    zraw["arch"]["args"]["text_params"]["model"] = CLIP_TEXT_MODEL
    zcfg = os.path.join(tmp, "zsl_clip.json")
    with open(zcfg, "w") as f:
        json.dump(zraw, f)
    seen, evaluate = {}, retrieval_eval.evaluate

    def keep(*a, **k):
        seen["result"] = r = evaluate(*a, **k)
        seen["loader"] = a[2]
        return r

    retrieval_eval.evaluate = keep
    l_test = {}
    try:
        with counted(l_test):  # ---- the main path, counted ----
            rc = cli_test.main(["-c", zcfg, "-r", ckpt])
    finally:
        retrieval_eval.evaluate = evaluate
    if rc != 0 or "result" not in seen:
        raise AssertionError(f"towers clip test: cli.test returned {rc}")
    res, loader = seen["result"], seen["loader"]
    test_tok = loader.collate.tokenizer
    captions = [data_caption(f"m{c}x", i) for i in range(DATA_MSRVTT) for c in range(3)] + \
        [data_caption("w", 1 + i) for i in range(DATA_CLIPS[0])]
    same = (isinstance(test_tok, ClipBatchTokenizer) and test_tok.bpe_path == bpe
            and np.array_equal(test_tok(captions, max_length=TEXT_LEN)["input_ids"],
                               train_tok(captions, max_length=TEXT_LEN)["input_ids"]))
    if not same:
        raise AssertionError(f"towers clip test: cli.test did not resolve {bpe} "
                             f"({type(test_tok).__name__}, {getattr(test_tok, 'bpe_path', None)})")
    rows = len(loader.dataset)
    forwards = -(-rows // loader.batch_size) * -(-loader.batch_size // 8)
    zdepth = build_tower_config(ExperimentCfg.from_dict(zraw).arch).video.depth
    check_launches("towers clip test", l_test, want_launches(zdepth, 0, False, forwards=forwards))
    if not (np.isfinite(res.text_embeds).all() and np.isfinite(res.video_embeds).all()) or \
            not all(np.isfinite(v) for m in res.metrics.values() for v in m.values()):
        raise AssertionError(f"towers clip test: embeddings or metrics not finite: {res.metrics}")
    out["test"] = {"config": f"zsl/normal.json + {CLIP_TEXT_MODEL}", "rows": rows,
                   "forwards": forwards, "launches": l_test, "tokenizer": "clip_bpe.txt.gz",
                   "t2v_R1": res.metrics["t2v_metrics"]["R1"],
                   "v2t_R1": res.metrics["v2t_metrics"]["R1"]}
    print(f"{tag} ({smi}): " + json.dumps(out), flush=True)
    return out, {k: launches[k] + l_test[k] for k in launches}


def region_run(tmp, smi, dev, base):
    """cli.build_region_memory --backend clip on the card over 1600 class
    names, then region_mem.json as shipped trained from that bank (phase 8,
    run 4)."""
    from oatx_torch.cli import build_region_memory
    from oatx_torch.config.schema import ExperimentCfg
    from oatx_torch.data import factory
    from oatx_torch.data.loader import Collator, ShardedLoader
    from oatx_torch.data.tokenizer import WordPieceTokenizer
    from oatx_torch.train.trainer import Trainer

    vocab, npy = os.path.join(tmp, "objects_vocab.txt"), os.path.join(tmp, "region_memory.npy")
    with open(vocab, "w") as f:  # row 0, __background__, is implied by the format
        f.write("".join(f"obj{i}\n" for i in range(REGION_CLASSES)))
    said = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said):
        rc = build_region_memory.main(["--vocab", vocab, "--out", npy, "--backend", "clip"])
    build_s = time.perf_counter() - t0
    bank = np.load(npy)
    if rc != 0 or bank.shape != (REGION_CLASSES, 512) or bank.dtype != np.float32 or \
            not np.isfinite(bank).all() or "(random init!)" not in said.getvalue():
        raise AssertionError(f"towers region: the builder returned {rc}, {bank.shape} "
                             f"{bank.dtype}: {said.getvalue()!r}")
    distinct = int(np.unique(bank, axis=0).shape[0])

    with open(OBJECT_CONFIGS["region_mem"]) as f:
        raw = json.load(f)
    raw["trainer"].update(epochs=1, len_epoch=TOWERS_LEN_EPOCH, save_period=100, init_val=False,
                          monitor="off", verbosity=1)
    raw["data_loader"][0]["args"]["object_params"]["region_memory_path"] = npy
    exp = ExperimentCfg.from_dict(raw)
    dl = exp.data_loaders[0]
    batch = dl.batch_size
    served = factory.load_region_bank(exp)
    if not np.array_equal(served.embeddings, bank):
        raise AssertionError("towers region: load_region_bank did not read the written bank")
    ds = object_corpus(base, os.path.join(tmp, "objects"),
                       factory.object_options_for_variant("region_mem", dl, served))
    rows = {r.tobytes() for r in bank}
    for i in range(4):
        got = ds.get_sample(i, np.random.default_rng(i))["text_region_embedding"]
        if not all(r.tobytes() in rows for r in np.asarray(got, np.float32)):
            raise AssertionError(f"towers region: clip {i}'s region rows are not the file's")
    col = Collator(WordPieceTokenizer.build_from_corpus(ds.captions), max_text_len=TEXT_LEN)
    tag = f"towers region_mem@{batch}"
    held = fresh_peak(dev)
    tr = Trainer(exp, [ShardedLoader(ds, batch, col, seed=0, num_workers=4)],
                 save_dir=os.path.join(tmp, "region"), device=dev)
    cfg = tr.tower_cfg
    depth = cfg.video.depth
    rec = StepRecorder(tr)
    launches = {}
    t0 = time.perf_counter()
    with counted(launches):  # ---- the main path, counted ----
        tr.train()
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check_launches(tag, launches, want_launches(
        depth, TOWERS_LEN_EPOCH, False, backward_depths=(depth, cfg.video.region_tap_layer)))
    terms = rec.term_values()
    if "loss_region" not in terms or not all(np.isfinite(v).all() for v in terms.values()):
        raise AssertionError(f"{tag}: region BCE missing or a term not finite: {terms}")
    out = {"config": "region_mem.json + region_memory_path", "batch": batch,
           "bank": list(bank.shape), "bank_distinct_rows": distinct,
           "bank_rms": float(np.sqrt(np.mean(np.square(bank)))), "build_s": build_s,
           "builder": said.getvalue().strip().split(" from ")[-1],
           "terms_first_last": {k: [v[0], v[-1]] for k, v in terms.items()},
           "train_wall_s": wall_s, "peak_mem_gib": peak, "mem_held_gib": held,
           "launches": launches,
           **speed(rec.step_ms(TOWERS_LEN_EPOCH), batch,
                   object_flops_per_clip_step(cfg, col.max_pad_text_len))}
    print(f"{tag} ({smi}): " + json.dumps(out), flush=True)
    return out, launches


def towers_phase(smi, dev):
    """Every tower a config can name, through the entry points (module
    docstring, phase 8)."""
    base = MemoryClips(CORPUS_CLIPS, seed=0)
    t0 = time.perf_counter()
    runs, launches = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for weight in (STREAM3_NCE_WEIGHT, 0.0):
            runs[f"stream3_w{weight}"], more = stream3_run(weight, tmp, smi, dev, base)
            launches.append(more)
    with tempfile.TemporaryDirectory() as tmp:
        runs["bert"], more = bert_run(tmp, smi, dev, base)
        launches.append(more)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "corpora")
        write_corpora(root)
        runs["clip"], more = clip_run(root, tmp, smi, dev)
        launches.append(more)
    with tempfile.TemporaryDirectory() as tmp:
        runs["region_mem"], more = region_run(tmp, smi, dev, base)
        launches.append(more)
    print(f"towers summary ({smi}): " + json.dumps({
        **{name: {k: r.get(k) for k in ("step_ms", "cycle_ms", "step_ms_spread", "clips_per_s",
                                        "mfu",
                                        "mfu_flops_py", "device_busy_ms", "idle_share",
                                        "device_ms_by_group", "peak_mem_gib")}
           for name, r in runs.items()},
        "phase_s": time.perf_counter() - t0}), flush=True)
    return {name: sum(l[name] for l in launches) for name in launches[0]}


# -------------------------------------------------------------------- wide
WIDE_CONFIGS = {  # the pod recipes, run with model_parallel 1 on one card
    "vit_large_pod": os.path.join(HERE, "configs", "pt", "cc3m_webvid", "vit_large_pod.json"),
    "vit_huge_pod": os.path.join(HERE, "configs", "pt", "cc3m_webvid", "vit_huge_pod.json"),
    # ViT-B/16 over its 16 frames (T = 3137), remat on; its loaders sample 4
    # and 1 frames, so the corpus's 16-frame clips (recipe_clips) drive the
    # tower at the length its config sets
    "pod_v5p": os.path.join(HERE, "configs", "pt", "cc3m_webvid", "pod_v5p.json"),
}
# (epochs, steps an epoch); pod_v5p's 4: a timed interval (step 2) before the
# traced last two
WIDE_RUNS = {"vit_large_pod": (2, 4), "vit_huge_pod": (1, 6), "pod_v5p": (1, 4)}
# kernel 2 at ViT-H/14's (B, 1 + 4·256, 16, 80) at B 4 (the micro-batch) and
# 8 (the per-GPU batch), and at ViT-B/16's Dh 64, B 4, 4 frames (the record's)
WIDE_SA_SHAPES = ((4, 4, 256, 16, 80), (8, 4, 256, 16, 80), (4, 4, 196, 12, 64))
WIDE_MLP = ((12560, 1024, 4096), (4100, 1280, 5120))  # kernel 1: ViT-L at 16, ViT-H at 4
WIDE_QKV = ((12560, 1024, 3072), (4100, 1280, 3840))  # kernel 3: LN → qkv, the same
# One step's gradients in the wide runs, at full depth: through the kernels
# (bf16), through the plain versions (bf16), and through the plain versions
# in f32 (the exact gradient up to f32 rounding). Every tensor whose exact
# gradient is not zero passes grad_check against the plain versions, and
# its grad_check reading against the f32 step is at most max(1,
# WIDE_F32_RATIO x the plain versions'); over the whole gradient the
# kernels' relative L2 distance from the f32 step is at most WIDE_F32_RATIO
# x the plain versions'. A tensor whose f32 gradient is under WIDE_ZERO_GRAD
# of the whole has an exact gradient of 0: block 0's time-branch qkv at
# time_init zeros, whose constant norm1 removes. Its bf16 value is rounding
# noise in every version, 0.34-1.49 % of the whole gradient's norm by
# version and batch (ViT-H/14; ViT-L/16's plain versions 1.37 % where the
# kernels give 0.81 %; NVIDIA H100 80GB HBM3, 700 W), up to 2.6 % apart
# between two versions, past grad_check's absolute term: such tensors are
# held to WIDE_NOISE_BOUND of the whole gradient's norm instead. Through
# ViT-H's 32 bf16 blocks both versions land 5-10 % from the f32 step.
WIDE_F32_RATIO = 1.25
WIDE_ZERO_GRAD = 1e-3
WIDE_NOISE_BOUND = 2 * GRAD_ATOL


def wide_space_attention(dev, g, shapes=WIDE_SA_SHAPES):
    """Kernel 2's forward and backward at `shapes` against the plain
    version: the forward within SPACE_ATTENTION_ATOL + 2^-7·|ref| + the
    flip allowance, the backward by relative L2 (SA_GRAD_REL, with both
    versions' distance from the exact f64 gradient) and by grad_check; ms by
    events, device ms, bound, plain ms and SDPA's (forward and backward).
    Returns (forward records, backward records) by shape."""
    from oatx_torch.ops.kernels import space_attention as psa

    fwd, bwd = {}, {}
    for B, Fr, N, Hh, Dh in shapes:
        T, key = 1 + Fr * N, f"B{B}_T{1 + Fr * N}_H{Hh}_Dh{Dh}"
        qkv = torch.randn(B, T, 3, Hh, Dh, device=dev, generator=g).to(torch.bfloat16)
        q, k, v = qkv[:, :, 0] * Dh ** -0.5, qkv[:, :, 1], qkv[:, :, 2]
        call = lambda: psa.space_attention(q, k, v, Fr)  # noqa: E731
        got = call()
        torch.cuda.synchronize()
        want = psa.space_attention_plain(q, k, v, Fr)
        rec = check_close(f"space_attention {key}", got, want, SPACE_ATTENTION_ATOL,
                          space_attention_flip_allowance(q, k, v, Fr))
        flops = 2 * 2 * B * Hh * (T + Fr * N * (N + 1)) * Dh
        rec["bound_ms"], rec["bound_by"] = bound_ms(4 * B * T * Hh * Dh * 2, flops)
        lib_in = sdpa_inputs(q, k, v, Fr)
        rec.update(ms=time_ms(call), device_ms=device_trace(call, 20, expect=SA_FWD_EXPECT)[0],
                   plain_ms=time_ms(lambda: psa.space_attention_plain(q, k, v, Fr), iters=5),
                   library_ms=time_ms(lambda: sdpa(lib_in)),
                   library_device_ms=device_trace(lambda: sdpa(lib_in), 20)[0],
                   split_rule=psa._query_split(B * Fr * Hh, -(-N // 16),
                                               torch.cuda.get_device_properties(dev)
                                               .multi_processor_count,
                                               psa._blocks_per_sm(Dh, N)))
        rec["tflops"] = flops / rec["device_ms"] / 1e9

        qd = q.detach()
        _, lse = psa._launch(qd, k, v, Fr, with_lse=True)
        dout = torch.randn(B, T, Hh, Dh, device=dev, generator=g).to(torch.bfloat16)
        bcall = lambda: psa.space_attention_backward(qd, k, v, dout, Fr, lse)  # noqa: E731
        gk = bcall()
        gp = space_attention_plain_vjp(qd, k, v, dout, Fr)
        brec = grad_errors(f"space_attention backward {key}", gk, gp,
                           space_attention_plain_vjp(*(a.double() for a in (qd, k, v, dout)),
                                                     Fr))
        gc_rec = grad_check(dict(zip("qkv", gk)), dict(zip("qkv", gp)))
        if gc_rec["grad_tol_used"] > 1 or gc_rec["grad_global_cosine"] < GRAD_MIN_GLOBAL_COSINE:
            raise AssertionError(f"space_attention backward {key}: grad_check {gc_rec}")
        brec.update({f"grad_check_{k_}": gc_rec[k_] for k_ in
                     ("grad_tol_used", "grad_norm_rel_diff", "grad_global_cosine")})
        bflops = flops * 5 // 2
        brec["bound_ms"], brec["bound_by"] = bound_ms(7 * B * T * Hh * Dh * 2, bflops)
        brec.update(ms=time_ms(bcall),
                    device_ms=device_trace(bcall, 20, expect=SA_BWD_EXPECT)[0],
                    plain_ms=time_ms(lambda: space_attention_plain_vjp(qd, k, v, dout, Fr),
                                     iters=5),
                    **sdpa_backward_ms(lib_in))
        brec["tflops"] = bflops / brec["device_ms"] / 1e9
        fwd[key], bwd[key] = rec, brec
        del qkv, q, k, v, got, want, gk, gp, lse, dout, lib_in
    return fwd, bwd


def wide_ln_mlp(dev, g, shapes=WIDE_MLP, zero_b2=False):
    """Kernel 1 at `shapes` (R rows, D, hidden H) against the plain version
    (LN_MLP_ATOL + 2^-7·|ref|); ms, device ms, bound, plain ms and the
    cuBLAS chain's (layer_norm → linear → gelu → linear). `zero_b2`: fc2's
    bias is 0, as a rank of a model group calls it (its sum over the group
    takes b2 once), and the result is also held against the plain chain
    with b2 minus b2."""
    from oatx_torch.ops.kernels import ln_mlp as plm

    out, bf = {}, torch.bfloat16
    for R, D, H in shapes:
        x = torch.randn(R, D, device=dev, generator=g).to(bf)
        gamma = 1 + 0.1 * torch.randn(D, device=dev, generator=g)
        beta = 0.1 * torch.randn(D, device=dev, generator=g)
        w1 = (0.02 * torch.randn(H, D, device=dev, generator=g)).to(bf)
        b1 = 0.02 * torch.randn(H, device=dev, generator=g)
        w2 = (0.02 * torch.randn(D, H, device=dev, generator=g)).to(bf)
        b2 = 0.02 * torch.randn(D, device=dev, generator=g)
        if zero_b2:
            full_b2, b2 = b2, torch.zeros_like(b2)
        args = (x, gamma, beta, w1, b1, w2, b2, 1e-6)
        gb, bb, b1b, b2b = (t.to(bf) for t in (gamma, beta, b1, b2))
        call = lambda: plm.ln_mlp(*args)  # noqa: E731
        got = call()
        torch.cuda.synchronize()
        rec = check_close(f"ln_mlp {R}x{D}->{H}", got, plm.ln_mlp_plain(*args), LN_MLP_ATOL)
        if zero_b2:  # the chain with its bias, less the bias
            minus = (plm.ln_mlp_plain(x, gamma, beta, w1, b1, w2, full_b2, 1e-6).float()
                     - full_b2).to(bf)
            rec["zero_b2_vs_plain_minus_b2"] = check_close(
                f"ln_mlp {R}x{D}->{H} zero b2", got, minus, LN_MLP_ATOL)

        def library():
            z = F.layer_norm(x, (D,), gb, bb, 1e-6)
            return F.linear(F.gelu(F.linear(z, w1, b1b)), w2, b2b)

        flops = 2 * R * D * H * 2
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            2 * R * D * 2 + 2 * D * H * 2 + (2 * D + H + D) * 4, flops)
        rec.update(ms=time_ms(call), device_ms=device_trace(call, 20, expect=LN_MLP_EXPECT)[0],
                   plain_ms=time_ms(lambda: plm.ln_mlp_plain(*args), iters=5),
                   library_ms=time_ms(library), library_device_ms=device_trace(library, 20)[0])
        rec["tflops"] = flops / rec["device_ms"] / 1e9
        out[f"{R}x{D}->{H}"] = rec
    return out


def wide_ln_linear(dev, g):
    """Kernel 3 at WIDE_QKV against the plain version (LN_LINEAR_ATOL +
    2^-7·|ref|); ms, device ms, bound, plain ms and cuBLAS's layer_norm →
    linear."""
    from oatx_torch.ops.kernels.ln_linear import ln_linear, ln_linear_plain

    out, bf = {}, torch.bfloat16
    for R, K, N in WIDE_QKV:
        x = torch.randn(R, K, device=dev, generator=g).to(bf)
        gamma = 1 + 0.1 * torch.randn(K, device=dev, generator=g)
        beta = 0.1 * torch.randn(K, device=dev, generator=g)
        w = (0.02 * torch.randn(N, K, device=dev, generator=g)).to(bf)
        b = 0.02 * torch.randn(N, device=dev, generator=g)
        args = (x, gamma, beta, w, b, 1e-6)
        gb, bb, bbf = (t.to(bf) for t in (gamma, beta, b))
        call = lambda: ln_linear(*args)  # noqa: E731
        library = lambda: F.linear(F.layer_norm(x, (K,), gb, bb, 1e-6), w, bbf)  # noqa: E731
        got = call()
        torch.cuda.synchronize()
        rec = check_close(f"ln_linear {R}x{K}->{N}", got, ln_linear_plain(*args),
                          LN_LINEAR_ATOL)
        flops = 2 * R * K * N
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            R * K * 2 + N * K * 2 + R * N * 2 + (2 * K + N) * 4, flops)
        rec.update(ms=time_ms(call),
                   device_ms=device_trace(call, 20, expect=(("ln_linear_kernel", 1),))[0],
                   plain_ms=time_ms(lambda: ln_linear_plain(*args), iters=5),
                   library_ms=time_ms(library), library_device_ms=device_trace(library, 20)[0])
        rec["tflops"] = flops / rec["device_ms"] / 1e9
        out[f"{R}x{K}->{N}"] = rec
    return out


@contextlib.contextmanager
def f32_compute(model):
    """The model's towers compute in f32 (its weights are f32 already)."""
    saved = model.cfg
    model.cfg = dataclasses.replace(saved, compute_dtype=torch.float32)
    try:
        yield
    finally:
        model.cfg = saved


def wide_grads(tag, model, loss_cfg, fixed):
    """One step's gradients of `model` on `fixed` through the kernels (bf16),
    the plain versions (bf16) and the plain versions in f32, checked as
    WIDE_F32_RATIO's note says: grad_check's keys over the tensors whose
    exact gradient is not zero, `grad_zero_tensors` (each version's norm of
    the others, over the whole f32 gradient's), `grad_f32_*` (grad_check's
    reading of each version against the f32 step, and the relative L2
    distance of the whole gradient from it)."""
    from oatx_torch.train import step as steplib

    def grads():
        model.zero_grad(set_to_none=True)
        loss, _ = steplib.loss_fn(model, loss_cfg, fixed)
        loss.backward()
        return {n: (p.grad.detach().clone() if p.grad is not None else None)
                for n, p in model.named_parameters()}

    got = grads()
    with plain_versions():
        ref = grads()
        with f32_compute(model):
            exact = grads()
    model.zero_grad(set_to_none=True)
    missing = [n for n, gr in got.items() if gr is None or not bool(torch.isfinite(gr).all())]
    if missing:
        raise AssertionError(f"{tag}: {len(missing)} parameters without a finite gradient "
                             f"through the kernels, e.g. {missing[:5]}")
    _, r, norm, uk = tensor_used(got, exact)
    *_, up = tensor_used(ref, exact)
    zero = {n for n in exact if r[n] < WIDE_ZERO_GRAD * norm}
    rec = grad_check({n: got[n] for n in exact if n not in zero},
                     {n: ref[n] for n in exact if n not in zero})
    rec["grad_zero_tensors"] = {n: {v: float(g[n].double().norm()) / norm
                                    for v, g in (("kernels", got), ("plain", ref))}
                                for n in sorted(zero)}
    over = {n: uk[n] / max(1.0, WIDE_F32_RATIO * up[n]) for n in exact if n not in zero}
    worst = sorted(over, key=over.get, reverse=True)[:6]
    rec["grad_f32_tol_used"] = {"kernels": max(uk[n] for n in over),
                                "plain": max(up[n] for n in over)}
    rec["grad_f32_worst"] = [(n, round(uk[n], 4), round(up[n], 4), r[n] / norm) for n in worst]
    rec["grad_rel_f32"] = {
        v: float(np.sqrt(sum(float((g[n].double() - exact[n].double()).square().sum())
                             for n in exact))) / norm
        for v, g in (("kernels", got), ("plain", ref))}
    f32 = rec["grad_rel_f32"]
    noisy = [n for n, v in rec["grad_zero_tensors"].items() if v["kernels"] > WIDE_NOISE_BOUND]
    if rec["grad_tol_used"] > 1 or rec["grad_norm_rel_diff"] > GRAD_NORM_RTOL \
            or over[worst[0]] > 1 or f32["kernels"] > WIDE_F32_RATIO * f32["plain"] or noisy:
        raise AssertionError(f"{tag}: gradients through the kernels disagree with the "
                             f"plain versions: {rec}")
    return rec


def recipe_clips(exp, n=CORPUS_CLIPS):
    """MemoryClips for `exp`: n clips, at least one batch of its first
    loader, each of as many frames as its video tower takes."""
    return MemoryClips(max(n, exp.data_loaders[0].batch_size), seed=0,
                       frames=exp.arch.video_params.num_frames)


def wide_recipe(name, smi, dev):
    """One pod recipe through Trainer.train() on one card (module docstring,
    phase 9) over recipe_clips; returns its record and launch counts."""
    from oatx_torch.train import step as steplib
    from oatx_torch.train.trainer import Trainer

    epochs, len_epoch = WIDE_RUNS[name]
    exp = recipe(WIDE_CONFIGS[name], model_parallel=1, epochs=epochs, len_epoch=len_epoch,
                 verbosity=1)
    t = exp.trainer
    batch = exp.data_loaders[0].batch_size
    tag = f"wide {name}@{batch}"
    ds = recipe_clips(exp)
    train, valid = corpus_loaders(ds, batch)
    held = fresh_peak(dev)
    t0 = time.perf_counter()
    tr = Trainer(exp, train, valid, device=dev)  # no save_dir: no checkpoints
    cfg = tr.tower_cfg
    v = cfg.video
    depth, accum, steps = v.depth, t.accum_steps, epochs * len_epoch
    print(f"{tag}: Trainer built in {time.perf_counter() - t0:.1f} s ({v.embed_dim} x "
          f"{depth}, {v.num_heads} heads of {v.head_dim}, patch {v.patch_size}, "
          f"{v.patches_per_frame + 1} keys a frame group, remat "
          f"{v.remat_policy if v.remat else 'off'}, accum_steps {accum}, fsdp {t.fsdp}, "
          f"sequence_parallel {v.sequence_parallel}, chunked loss {exp.loss.chunked})",
          flush=True)
    # one step's gradients on a fixed batch at full depth, the loader's batch
    # in one pass, at the seed-0 weights before any update (pod_v5p trains
    # at its full lr from step 1, and past a first update at random init the
    # bf16 gradients are noise against f32: phase 16's finding): kernels vs
    # plain versions and both vs the f32 step (not counted)
    host = next(iter(corpus_loaders(ds, batch, with_valid=False)[0][0]))
    host.pop("meta")
    fixed = steplib.make_augmenter(train=False, tower_cfg=cfg)(
        None, {k: torch.from_numpy(a).to(dev) for k, a in host.items()})
    grads = wide_grads(tag, tr.state.model, tr.loss_cfg, fixed)
    del fixed, host
    fresh_peak(dev)  # the run's peak, without the gradient check's
    per_step = depth * accum
    rec = StepRecorder(tr, trace_at=steps - 1, expect=[
        ("ln_mlp_", per_step * (2 if v.remat else 1)),
        ("space_attention_kernel", per_step * (2 if v.remat else 1)),
        ("space_attention_bwd_kernel", per_step)])
    launches = {}
    t0 = time.perf_counter()
    with counted(launches):  # ---- the main path, counted ----
        hist = tr.train()
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    validations = (1 if t.init_val else 0) + epochs
    check_launches(tag, launches, want_launches(
        depth, steps, v.remat, forwards=eval_forwards(validations, len(ds), batch),
        accum_steps=accum))
    terms = rec.term_values()
    bad = [k for k, vals in terms.items() if not all(np.isfinite(vals))]
    if bad:
        raise AssertionError(f"{tag}: loss terms not finite: {bad}: {terms}")
    # step intervals inside each epoch, without those the trace of the last
    # two steps touches (its syncs and the profiler's start and stop)
    torch.cuda.synchronize()
    ms = [rec.events[i - 2].elapsed_time(rec.events[i - 1]) for i in range(2, steps + 1)
          if (i - 1) % len_epoch and i < steps - 1]
    out = {"recipe": os.path.basename(WIDE_CONFIGS[name]), "batch": batch,
           "accum_steps": accum, "micro_batch": batch // accum,
           "remat": v.remat_policy if v.remat else "off", "embed_dim": v.embed_dim,
           "depth": depth, "heads": v.num_heads, "head_dim": v.head_dim,
           "tokens": 1 + v.num_frames * v.patches_per_frame, "steps": steps,
           "terms": terms, "val_loss": [tr.init_val_log["val_loss_0"]] +
           [hist[e]["val_loss_0"] for e in range(1, epochs + 1)],
           "train_wall_s": wall_s, "peak_mem_gib": peak, "mem_held_gib": held,
           "launches": launches,
           "launches_per_step": {k: n for k, n in want_launches(
               depth, 1, v.remat, accum_steps=accum).items() if n},
           **speed(ms, batch, flops_per_clip_step(cfg)), **(rec.traced() or {}), **grads}
    print(f"{tag} ({smi}): " + json.dumps(out), flush=True)
    del tr, rec
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def wide_phase(smi, dev):
    """Kernels 1-3 at the ViT-L/16 and ViT-H/14 widths, then both pod
    recipes through Trainer.train() (module docstring, phase 9). Returns
    the launch counts of the recipes' runs, the kernels' records and the
    recipes' records."""
    t0 = time.perf_counter()
    g = torch.Generator(dev).manual_seed(9)
    sa_fwd, sa_bwd = wide_space_attention(dev, g)
    kernels = {"space_attention": sa_fwd, "space_attention_bwd": sa_bwd,
               "ln_mlp": wide_ln_mlp(dev, g), "ln_linear": wide_ln_linear(dev, g)}
    for name, recs in kernels.items():
        print(f"wide kernels {name} ({smi}): " + json.dumps(recs), flush=True)
    runs, launches = {}, []
    for name in WIDE_CONFIGS:
        runs[name], more = wide_recipe(name, smi, dev)
        launches.append(more)
    print(f"wide summary ({smi}): " + json.dumps({
        name: {k: r.get(k) for k in ("batch", "accum_steps", "remat", "step_ms",
                                     "step_ms_spread", "clips_per_s", "mfu", "device_busy_ms",
                                     "idle_share", "device_ms_by_group", "peak_mem_gib",
                                     "grad_tol_used", "grad_global_cosine")}
        for name, r in runs.items()}) + f", phase {time.perf_counter() - t0:.1f} s", flush=True)
    return {name: sum(l[name] for l in launches) for name in launches[0]}, kernels, runs


# ---------------------------------------------------------------------- dp
DP_WORLD = 2             # ranks of (b), both on cuda:0 over gloo
DP_RANK_BATCH = 8        # per rank: norm.json's per-GPU 16 as a global batch
DP_NORM_STEPS = 4        # norm.json steps of (b); the object recipes take 1
DP_CYCLES = 2            # (a): cycles of cli.train (a CC3M and a WebVid step each)
DP_LOSS_RTOL = 2e-3      # (b) step 1's loss terms against one process at batch 16
DP_RANK_TIMEOUT_S = 600
DP_RECIPES = ("norm", "global_local", "region_mem")
RANK_GROUPS_AT_ONCE = 2  # rank groups of phases 10-13 sharing the card at a time


class Ranks:
    """`world` ranks of this script started again with --dp-rank and
    --dp-phase `phase` (gloo: all on cuda:0; nccl: one card each), writing
    into `tmp` (default: a temporary directory of their own), with `env`
    (default: this process's environment)."""

    def __init__(self, world, backend, phase, tmp=None, env=None):
        self.own = None if tmp else tempfile.TemporaryDirectory()
        self.tmp = tmp or self.own.name
        self.world, self.phase, self.t0 = world, phase, time.time()
        url = "file://" + os.path.join(self.tmp, "store")
        self.logs = [os.path.join(self.tmp, f"rank{r}.log") for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-rank", str(r), "--dp-world",
             str(world), "--dp-init", url, "--dp-backend", backend, "--dp-out", self.tmp,
             "--dp-phase", phase], stdout=open(self.logs[r], "w"), stderr=subprocess.STDOUT,
            env=env) for r in range(world)]

    def running(self):
        return any(p.poll() is None for p in self.procs)

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def wait(self):
        """→ each rank's record (rank{r}.json), after their exit; their log
        tails printed and AssertionError if one failed. `wall_s`: from the
        start to the last record written."""
        try:
            for p in self.procs:
                p.wait(timeout=DP_RANK_TIMEOUT_S)
        finally:
            self.stop()
        if any(p.returncode for p in self.procs):
            for r, log in enumerate(self.logs):
                print(f"{self.phase} rank {r} log tail:\n" + open(log).read()[-3000:],
                      flush=True)
            raise AssertionError(f"{self.phase}: ranks exited "
                                 f"{[p.returncode for p in self.procs]}")
        files = [os.path.join(self.tmp, f"rank{r}.json") for r in range(self.world)]
        self.wall_s = max(os.path.getmtime(f) for f in files) - self.t0
        return [json.load(open(f)) for f in files]

    def cleanup(self):
        self.stop()
        if self.own is not None:
            self.own.cleanup()


class RankGroups:
    """Phases 10-13's gloo rank groups, started in the order given, at most
    RANK_GROUPS_AT_ONCE at a time, by a thread that starts the next when a
    group exits, while the main process runs those phases' one-process
    references. The ranks' step ms are no speed anyway (they share the card
    and gloo stages CUDA tensors through the host). Every group gets the
    environment as it is here, not as phase 10 (a) sets it for a while."""

    def __init__(self, specs):
        self.specs, self.groups, self.halt = list(specs), {}, threading.Event()
        self.env = dict(os.environ)
        self.started = {phase: threading.Event() for phase, _ in self.specs}
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            for phase, world in self.specs:
                while not self.halt.is_set() and sum(
                        g.running() for g in self.groups.values()) >= RANK_GROUPS_AT_ONCE:
                    time.sleep(0.2)
                if self.halt.is_set():
                    break
                self.groups[phase] = Ranks(world, "gloo", phase, env=self.env)
                self.started[phase].set()
        finally:  # a group never started fails in group(), not in a wait forever
            for e in self.started.values():
                e.set()

    def group(self, phase):
        self.started[phase].wait()
        if phase not in self.groups:
            raise AssertionError(f"{phase}: its ranks were never started")
        return self.groups[phase]

    def stop(self):
        """Start no more groups; stop and remove those started."""
        self.halt.set()
        self.thread.join()
        for g in self.groups.values():
            g.cleanup()


def dp_recipe(name, steps):
    """norm.json or an object-aware recipe for phase 10: one epoch of
    `steps` steps, no init_val, no checkpoint."""
    path = NORM_CONFIG if name == "norm" else OBJECT_CONFIGS[name]
    return recipe(path, epochs=1, len_epoch=steps, init_val=False, save_period=10 ** 6,
                  verbosity=1)


def dp_steps(name):
    return DP_NORM_STEPS if name == "norm" else 1


def dp_data(name, exp, base, tmp):
    """(dataset, collator) of recipe `name` over `base`'s clips (the object
    recipes with object_corpus' extras, files under `tmp`)."""
    from oatx_torch.data import factory
    from oatx_torch.data.loader import Collator
    from oatx_torch.data.tokenizer import WordPieceTokenizer

    if name == "norm":
        return base, Collator(WordPieceTokenizer.build_from_corpus(base.captions),
                              max_text_len=TEXT_LEN)
    dl = exp.data_loaders[0]
    opts = factory.object_options_for_variant(name, dl, factory.load_region_bank(exp))
    ds = object_corpus(base, os.path.join(tmp, "objects"), opts)
    tok = WordPieceTokenizer.build_from_corpus(ds.captions + [f"obj{i}" for i in range(1600)])
    return ds, Collator(tok, max_text_len=TEXT_LEN,
                        tag_token_lens=factory.tag_token_lens_for(ds, tok) if opts.tags else None)


def whole(model, tensors, to_host):
    """{name: tensor} of `model`'s parameters (or their gradients), fsdp
    shares and model-axis parts gathered whole, other pipeline stages'
    blocks from their ranks (every rank calls it); on the host if
    `to_host`."""
    from oatx_torch.parallel import sharding

    params = dict(model.named_parameters())
    stages = sharding.stage_plan_of(model)
    out = {}
    for n in (stages.params if stages is not None else params):
        p = params.get(n)
        t = tensors(p) if p is not None else None
        if stages is not None and stages.owner(n) is not None:  # from its stage
            t = stages.fetch(n, None if t is None else t.detach())
        elif t is None:
            continue
        else:
            t = sharding.held_whole(t.detach(), p, "check")
        out[n] = t.float().cpu() if to_host else None
    return out


class FirstGrads:
    """Wraps a Trainer's train_step: the model's gradients after its first
    step (under data parallelism the reduced ones; fsdp shares gathered
    whole, every rank taking part), on the host where `keep`."""

    def __init__(self, trainer, keep=True):
        self.step, self.model, self.keep, self.grads = trainer.train_step, \
            trainer.state.model, keep, None
        trainer.train_step = self

    def __call__(self, state, batch):
        state, m = self.step(state, batch)
        if self.grads is None:
            self.grads = whole(self.model, lambda p: p.grad, self.keep)
        return state, m


def dp_probe(dev, rank, world):
    """Whether the group takes CUDA tensors between the ranks: all_gather
    into a list, all_reduce in f32 and bf16, broadcast, each checked."""
    import torch.distributed as dist

    try:
        x = torch.full((4,), rank + 1.0, device=dev)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        s = x.clone()
        dist.all_reduce(s)
        h = x.to(torch.bfloat16)
        dist.all_reduce(h)
        b = x.clone()
        dist.broadcast(b, 0)
        want = float(sum(range(1, world + 1)))
        ok = ([float(p[0]) for p in parts] == [r + 1.0 for r in range(world)]
              and float(s[0]) == want and float(h[0]) == want and float(b[0]) == 1.0
              and all(t.device == dev for t in (parts[0], s, h, b)))
        return {"ok": ok, "device": str(dev), "all_gather": [float(p[0]) for p in parts],
                "all_reduce_f32": float(s[0]), "all_reduce_bf16": float(h[0]),
                "broadcast": float(b[0])}
    except Exception as e:  # the probe's answer, not a failure of the port
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}


def dp_run(name, trainer_of, steps, dev):
    """Trainer.train() over `steps` steps of recipe `name` → the record of
    the run (loss terms, launches, collectives' traffic a step, step ms,
    peak memory) and its first step's gradients on the host."""
    from oatx_torch.parallel import collectives as coll

    held = fresh_peak(dev)
    tr = trainer_of()
    cfg = tr.tower_cfg
    reached = ((cfg.video.depth,) if name == "norm" else
               (cfg.video.depth, cfg.video.depth if name == "global_local"
                else cfg.video.region_tap_layer))
    rec = StepRecorder(tr)
    first = FirstGrads(tr)
    launches = {}
    coll.reset_traffic()
    with counted(launches):  # ---- the main path, counted ----
        tr.train()
    traffic = {k: {q: v / steps for q, v in t.items()} for k, t in coll.TRAFFIC.items()}
    check_launches(f"dp {name}", launches,
                   want_launches(cfg.video.depth, steps, False, backward_depths=reached))
    grads = first.grads
    return {"steps": steps, "terms": rec.term_values(), "launches": launches,
            "traffic_per_step": traffic, "step_ms": rec.step_ms(steps), "mem_held_gib": held,
            "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "trainable_f32_bytes": 4 * sum(g.numel() for g in grads.values())}, grads


def dp_rank_main(rank, world, url, out, backend):
    """One rank of phase 10 (b), started by dp_ranks: a `backend` group over
    `url` (gloo: every rank on cuda:0; nccl: cuda:rank), the probe, then each
    recipe through Trainer.train() over this rank's shard; its record →
    out/rank{rank}.json, rank 0's first step's gradients →
    out/grads_{recipe}.pt."""
    import datetime

    import torch.distributed as dist

    from oatx_torch.data.loader import ShardedLoader
    from oatx_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=url, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=DP_RANK_TIMEOUT_S))
    try:
        record = {"probe": dp_probe(dev, rank, world), "runs": {}}
        if record["probe"]["ok"]:
            base = MemoryClips(CORPUS_CLIPS, seed=0)
            for name in DP_RECIPES:
                exp = dp_recipe(name, dp_steps(name))
                ds, col = dp_data(name, exp, base, os.path.join(out, f"rank{rank}"))
                train = [ShardedLoader(ds, DP_RANK_BATCH, col, seed=0, num_workers=4,
                                       shard_id=rank, num_shards=world)]
                run, grads = dp_run(name, lambda: Trainer(exp, train, [], device=dev),
                                    dp_steps(name), dev)
                if rank == 0:
                    torch.save(grads, os.path.join(out, f"grads_{name}.pt"))
                run["grad_sums"] = [[float(g.double().sum()), float(g.double().square().sum())]
                                    for g in grads.values()]
                record["runs"][name] = run
                del grads
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(record, f)
    finally:
        dist.destroy_process_group()
    return 0


def dp_reference(name, base, tmp, dev, world):
    """One process at batch world·DP_RANK_BATCH over the ranks' global
    batches (GlobalBatches: the shards' batches in rank order), as many
    steps as the ranks took: its record and its first step's gradients."""
    from oatx_torch.data.loader import GlobalBatches, ShardedLoader
    from oatx_torch.train.trainer import Trainer

    exp = dp_recipe(name, dp_steps(name))
    ds, col = dp_data(name, exp, base, os.path.join(tmp, "reference"))
    train = [GlobalBatches([ShardedLoader(ds, DP_RANK_BATCH, col, seed=0, num_workers=4,
                                          shard_id=r, num_shards=world)
                            for r in range(world)])]
    return dp_run(name, lambda: Trainer(exp, train, [], device=dev), dp_steps(name), dev)


def dp_refs(dev, world=DP_WORLD):
    """Phase 10 (b)'s one process for each recipe (dp_reference) → {recipe:
    (record, first step's gradients)}."""
    base = MemoryClips(CORPUS_CLIPS, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        return {name: dp_reference(name, base, tmp, dev, world) for name in DP_RECIPES}


def dp_ranks(smi, dev, world=DP_WORLD, backend="gloo", group=None, refs=None):
    """Phase 10 (b): `world` ranks, this script started again with
    --dp-rank (gloo: all on cuda:0; nccl: one card each; `group`: started
    already), each recipe against one process on the same global batch
    (`refs`: dp_refs's, taken already). → (record, launches)."""
    gc.collect()
    torch.cuda.empty_cache()
    where = "one card over gloo" if backend == "gloo" else f"{world} cards over NCCL"
    group = group or Ranks(world, backend, "dp")
    try:
        tmp = group.tmp
        ranks = group.wait()
        wall_s = group.wall_s
        print(f"dp (b) {backend} on CUDA tensors, probe ({smi}): "
              + json.dumps([r["probe"] for r in ranks]), flush=True)
        if not all(r["probe"]["ok"] for r in ranks):
            print(f"dp (b) waits: {backend} refused CUDA tensors between the ranks", flush=True)
            return {"probe": [r["probe"] for r in ranks]}, []
        refs = refs or dp_refs(dev, world)
        out = {"backend": backend, "world": world, "ranks_wall_s": wall_s, "runs": {}}
        for name in DP_RECIPES:
            runs = [r["runs"][name] for r in ranks]
            if any(r["grad_sums"] != runs[0]["grad_sums"] or r["terms"] != runs[0]["terms"]
                   for r in runs):
                raise AssertionError(f"dp (b) {name}: the ranks disagree")
            one, ref = refs.pop(name)
            got = torch.load(os.path.join(tmp, f"grads_{name}.pt"))
            rel = {k: abs(runs[0]["terms"][k][0] - v[0]) / abs(v[0])
                   for k, v in one["terms"].items()}
            check = grad_check(got, ref)
            del got, ref
            rec = {"steps": runs[0]["steps"], "rank_batch": DP_RANK_BATCH,
                   "global_batch": world * DP_RANK_BATCH, "step1_terms": {
                       k: [runs[0]["terms"][k][0], v[0]] for k, v in one["terms"].items()},
                   "step1_rel_diff": rel, "losses": runs[0]["terms"]["loss"],
                   "one_process_losses": one["terms"]["loss"],
                   "launches_per_rank": runs[0]["launches"],
                   "traffic_per_step": runs[0]["traffic_per_step"],
                   "trainable_f32_bytes": runs[0]["trainable_f32_bytes"],
                   "rank_step_ms": [r["step_ms"] for r in runs],
                   "one_process_step_ms": one["step_ms"],
                   "peak_mem_gib": [r["peak_mem_gib"] for r in runs],
                   "one_process_peak_mem_gib": one["peak_mem_gib"],
                   "mem_held_gib": [r["mem_held_gib"] for r in runs],
                   **{k: check[k] for k in ("grad_norm", "plain_grad_norm", "grad_norm_rel_diff",
                                            "grad_global_cosine", "grad_tol_used",
                                            "grad_tensors", "grad_worst")}}
            out["runs"][name] = rec
            note = (" (rank step ms NOT a data-parallel speed: the ranks share one card and "
                    "gloo stages CUDA tensors through the host)" if backend == "gloo" else "")
            print(f"dp (b) {name}, {world} ranks x batch {DP_RANK_BATCH} on {where} "
                  f"({smi}){note}: " + json.dumps(rec), flush=True)
            grad_bytes = rec["traffic_per_step"]["grad"]["bytes"]
            if max(rel.values()) > DP_LOSS_RTOL or rec["grad_tol_used"] > 1 \
                    or rec["grad_norm_rel_diff"] > GRAD_NORM_RTOL \
                    or rec["grad_global_cosine"] < GRAD_MIN_GLOBAL_COSINE \
                    or grad_bytes != rec["trainable_f32_bytes"]:
                raise AssertionError(f"dp (b) {name}: {world} ranks disagree with one "
                                     f"process: {rel}, {rec['grad_worst']}, all-reduced "
                                     f"{grad_bytes} of {rec['trainable_f32_bytes']} bytes")
    finally:
        group.cleanup()
    launches = [r["runs"][name]["launches"] for r in ranks for name in r["runs"]]
    return out, launches


def dp_world1(root, tmp, smi, dev):
    """Phase 10 (a): cli.train on norm.json over phase 7's corpora under
    OATX_MULTIHOST=1 at a world of 1 (NCCL, cuda:0), then the same run
    without it: every loss term and the final parameters bitwise equal.
    → (record, launches of both runs)."""
    import socket

    import torch.distributed as dist

    from oatx_torch.cli import train as cli_train

    with open(NORM_CONFIG) as f:
        raw = json.load(f)
    for dl, name in zip(raw["data_loader"], ("cc3m", "webvid")):
        dl["args"].update(data_dir=os.path.join(root, name), metadata_dir=os.path.join(root, name))
        dl["args"]["video_params"]["loading"] = "strict"
    batch = raw["data_loader"][0]["args"]["batch_size"]
    raw["trainer"].update(epochs=1, init_val=False, save_period=1, verbosity=1,
                          max_samples_per_epoch=DP_CYCLES * batch * len(raw["data_loader"]))
    steps = DP_CYCLES * len(raw["data_loader"])
    runs, launches = {}, []
    for mode in ("multihost", "plain"):
        raw["trainer"]["save_dir"] = os.path.join(tmp, mode)
        cfg = os.path.join(tmp, f"dp_{mode}.json")
        with open(cfg, "w") as f:
            json.dump(raw, f)
        env = {}
        if mode == "multihost":
            with socket.socket() as s:
                s.bind(("localhost", 0))
                port = s.getsockname()[1]
            env = {"OATX_MULTIHOST": "1", "OATX_COORDINATOR": f"localhost:{port}",
                   "OATX_NUM_PROCESSES": "1", "OATX_PROCESS_ID": "0"}
        os.environ.update(env)
        made, counts = [], {}
        t0 = time.perf_counter()
        try:
            with recorded_trainers(made), counted(counts):  # ---- the main path ----
                rc = cli_train.main(["-c", cfg, "--no_timestamp"])
        finally:
            for k in env:
                del os.environ[k]
        if rc != 0 or len(made) != 1 or dist.is_initialized():
            raise AssertionError(f"dp (a) {mode}: rc {rc}, {len(made)} trainers, group left "
                                 f"{dist.is_initialized()}")
        tr = made[0]["trainer"]
        val = sum(eval_forwards(1, len(l.dataset), l.batch_size) for l in tr.valid_loaders)
        check_launches(f"dp (a) {mode}", counts, want_launches(tr.tower_cfg.video.depth, steps,
                                                               False, forwards=val))
        runs[mode] = {"terms": made[0]["rec"].term_values(), "wall_s": time.perf_counter() - t0,
                      "params": {k: v.detach().cpu().clone()
                                 for k, v in tr.state.model.state_dict().items()}}
        launches.append(counts)
        del tr, made
    same_terms = runs["multihost"]["terms"] == runs["plain"]["terms"]
    same_params = state_equal(runs["multihost"]["params"], runs["plain"]["params"])
    out = {"config": "norm.json", "steps": steps, "backend": "nccl", "world": 1,
           "losses": runs["multihost"]["terms"]["loss"], "terms_bitwise": same_terms,
           "params_bitwise": same_params, "tensors": len(runs["plain"]["params"]),
           "wall_s": [runs[m]["wall_s"] for m in runs], "launches": launches[0]}
    print(f"dp (a) cli.train under OATX_MULTIHOST=1, world 1, NCCL, against the plain run "
          f"({smi}): " + json.dumps(out), flush=True)
    if not (same_terms and same_params):
        raise AssertionError("dp (a): the world-1 run is not bitwise the plain run")
    return out, launches


def dp_pre(smi, dev):
    """Phase 10's work in the main process before the ranks' records: (a),
    then (b)'s one-process references → ((a)'s record, its launches, the
    references)."""
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "corpora")
        write_corpora(root)
        a, launches = dp_world1(root, tmp, smi, dev)
    return a, launches, dp_refs(dev)


def dp_phase(smi, dev, group, pre):
    """Data parallelism across processes (module docstring, phase 10): the
    ranks of `group` against dp_pre's `pre`."""
    a, launches, refs = pre
    b, more = dp_ranks(smi, dev, group=group, refs=refs)
    launches += more
    print(f"dp summary ({smi}): " + json.dumps({
        "a_bitwise": a["terms_bitwise"] and a["params_bitwise"], "a_wall_s": a["wall_s"],
        "b": {name: {k: r[k] for k in ("step1_rel_diff", "grad_norm_rel_diff",
                                       "grad_global_cosine", "grad_tol_used",
                                       "traffic_per_step", "rank_step_ms", "peak_mem_gib")}
              for name, r in b.get("runs", {}).items()},
        "b_probe": b.get("probe")}), flush=True)
    return {name: sum(l[name] for l in launches) for name in launches[0]}


# ------------------------------------------------------------------- shard
SHARD_MODES = (None, "zero1", "fsdp")  # phase 11's rank runs: replicated, then each mode
SHARD_ADAFACTOR_MODES = ("zero1", "fsdp")  # then each under Adafactor (phase 16's family)
SHARD_EPOCHS, SHARD_LEN_EPOCH = 2, 2   # 4 steps; zero1 and fsdp save each epoch
# a checkpoint save holds the tensor it gathers and, inside the gloo
# collective, one more of its size (norm.json on an H100: 179.4-180.0 MiB
# above the save's start for 89.4 MiB word embeddings), plus the
# allocator's block rounding; the whole state would be gigabytes
SAVE_SLACK_TENSORS, SAVE_SLACK_BYTES = 2, 8 * 2 ** 20
# --dp-nccl: (recipe, mode, epochs, steps an epoch, trainer keys) a rank on each card
SHARD_NCCL_RUNS = (("vit_huge_pod", "fsdp", 1, 3, dict(model_parallel=1)),
                   ("large_batch_pod", "zero1", 1, 2, dict(fwd_chunk=8)))
SHARD_NCCL_BATCH = {"vit_huge_pod": 8, "large_batch_pod": LARGE_BATCH}


def shard_corpus(name, world):
    """The clips of an --dp-nccl run: a batch a rank, or 32 clips."""
    n = max(CORPUS_CLIPS, SHARD_NCCL_BATCH[name] * world)
    return MemoryClips(n, seed=0 if n == CORPUS_CLIPS else 1)


def shard_exp(mode, path=NORM_CONFIG, epochs=SHARD_EPOCHS, len_epoch=SHARD_LEN_EPOCH,
              **trainer):
    """A recipe for phase 11 under `mode` (None: replicated): no init_val,
    a checkpoint each epoch (only where a save_dir is given)."""
    return recipe(path, epochs=epochs, len_epoch=len_epoch, init_val=False, save_period=1,
                  verbosity=1, fsdp=mode == "fsdp", zero1=mode == "zero1", **trainer)


def shard_probe(dev, rank, world):
    """phase 10's probe, and whether the group also takes
    reduce_scatter_tensor and all_gather_into_tensor on CUDA tensors, which
    the sharded layouts send (parallel/collectives.py): 'ok' needs all."""
    import torch.distributed as dist

    out = dp_probe(dev, rank, world)
    x = torch.arange(2.0 * world, device=dev) + rank

    def scatter():
        got = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(got, x.clone())
        want = world * (torch.arange(2.0, device=dev) + 2 * rank) + sum(range(world))
        return torch.equal(got, want)

    def gather():
        got = torch.empty(2 * world, device=dev)
        dist.all_gather_into_tensor(got, x[:2].clone())
        return torch.equal(got.view(world, 2) - torch.arange(world, device=dev)[:, None],
                           torch.arange(2.0, device=dev).expand(world, 2))

    for name, fn in (("reduce_scatter_tensor", scatter), ("all_gather_into_tensor", gather)):
        try:
            out[name] = fn()
        except Exception as e:  # the probe's answer, not a failure of the port
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    out["ok"] = out["ok"] and all(out[k] is True for k in ("reduce_scatter_tensor",
                                                          "all_gather_into_tensor"))
    return out


@contextlib.contextmanager
def watched_saves(dev, saves):
    """checkpoint.save_checkpoint wrapped for the context: each save
    appends {'prior': the peak allocated before it, 'before': allocated as
    it starts, 'peak': the most allocated during it} in bytes (a save's
    peak needs the count reset; 'prior' keeps the run's)."""
    from oatx_torch.train import checkpoint as ckptlib

    save = ckptlib.save_checkpoint

    def watched(*args, **kwargs):
        prior = torch.cuda.max_memory_allocated(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            return save(*args, **kwargs)
        finally:
            saves.append({"prior": prior, "before": before,
                          "peak": torch.cuda.max_memory_allocated(dev)})

    ckptlib.save_checkpoint = watched
    try:
        yield
    finally:
        ckptlib.save_checkpoint = save


def shard_run(tag, trainer_of, steps, dev, keep):
    """Trainer.train() over `steps` steps → (record: loss terms, launches,
    traffic a step, held and predicted state bytes, step ms, peak memory;
    step 1's whole gradients and the last whole parameters on the host
    where `keep`)."""
    from oatx_torch.parallel import collectives as coll
    from oatx_torch.parallel import sharding

    held0 = fresh_peak(dev)
    tr = trainer_of()
    t = tr.exp.trainer
    cfg = tr.tower_cfg
    v = cfg.video
    shapes = {n: tuple(getattr(p, "_oatx_shard", p).shape)
              for n, p in tr.state.model.named_parameters()}
    rec = StepRecorder(tr)
    first = FirstGrads(tr, keep)
    launches, saves = {}, []
    coll.reset_traffic()
    t0 = time.perf_counter()
    with counted(launches), watched_saves(dev, saves):  # ---- the main path, counted ----
        tr.train()
    wall_s = time.perf_counter() - t0
    traffic = {k: {q: n / steps for q, n in r.items()} for k, r in coll.TRAFFIC.items()
               if k != "check"}  # whole() gathers step 1's gradients for the check
    peak = max([torch.cuda.max_memory_allocated(dev)] + [x["prior"] for x in saves]) / 2 ** 30
    # a save holds at most the tensor it gathers and the collective's own
    # buffer of its size (SAVE_SLACK_TENSORS): never the whole state
    largest = 4 * max(math.prod(x) for x in shapes.values())
    save_bound = SAVE_SLACK_TENSORS * largest + SAVE_SLACK_BYTES
    save_mem = [{"before_gib": x["before"] / 2 ** 30, "peak_gib": x["peak"] / 2 ** 30,
                 "above_before_mib": (x["peak"] - x["before"]) / 2 ** 20} for x in saves]
    if any(x["peak"] - x["before"] > save_bound for x in saves):
        raise AssertionError(f"{tag}: a checkpoint save took more device memory than "
                             f"{save_bound / 2 ** 20:.1f} MiB ({SAVE_SLACK_TENSORS} of the "
                             f"largest whole tensor): {save_mem}")
    chunks = (tr.exp.data_loaders[0].batch_size // t.fwd_chunk
              if t.fwd_chunk and not (t.fsdp and tr.layout.spans_processes) else None)
    check_launches(tag, launches, want_launches(v.depth, steps, v.remat, chunks=chunks,
                                                accum_steps=t.accum_steps))
    held = sharding.held_bytes(tr.state.model, tr.state.optimizer)
    mode = tr.shard_mode if tr.layout.spans_processes else None
    want = sharding.state_bytes(shapes, tr.layout.data_size, mode, ema=bool(t.ema_decay),
                                kind=tr.exp.optimizer.type)
    terms = rec.term_values()
    if not all(np.isfinite(x) for vals in terms.values() for x in vals):
        raise AssertionError(f"{tag}: loss terms not finite: {terms}")
    params = sharding.full_state_dict(tr.state.model, to_host=True, keep=keep) or {}
    out = {"mode": mode or "replicated", "steps": steps, "terms": terms, "launches": launches,
           "traffic_per_step": traffic, "step_ms": rec.step_ms(tr.cycles_per_epoch),
           "train_wall_s": wall_s, "mem_held_gib": held0, "peak_mem_gib": peak,
           "held_bytes": held, "predicted_bytes": want, "saves": save_mem,
           "save_bound_mib": save_bound / 2 ** 20,
           "shared_params": sum(hasattr(p, "_oatx_shard") for p in tr.state.model.parameters()),
           "zero1_params": sum(s is not None for s in tr.state.optimizer.zero1)}
    grads = first.grads
    del tr, rec, first
    gc.collect()
    torch.cuda.empty_cache()
    return out, grads, params


def shard_rank_main(rank, world, url, out, backend):
    """One rank of phase 11, started by shard_ranks: a `backend` group over
    `url` (gloo: every rank on cuda:0; nccl: cuda:rank), the probe, then the
    runs (gloo: norm.json replicated, under zero1 and under fsdp, the zero1
    and fsdp runs writing snapshots; nccl: SHARD_NCCL_RUNS); its record →
    out/rank{rank}.json, rank 0's whole gradients and parameters →
    out/{run}_{grads,params}.pt."""
    import datetime

    import torch.distributed as dist

    from oatx_torch.data.loader import ShardedLoader
    from oatx_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=url, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=DP_RANK_TIMEOUT_S))
    try:
        record = {"probe": shard_probe(dev, rank, world), "runs": {}}
        if record["probe"]["ok"]:
            base = MemoryClips(CORPUS_CLIPS, seed=0)
            if backend == "gloo":
                runs = [(mode or "replicated", shard_exp(mode), DP_RANK_BATCH, base)
                        for mode in SHARD_MODES] + [
                    (f"adafactor_{mode}", with_optimizer(shard_exp(mode), "Adafactor"),
                     DP_RANK_BATCH, base) for mode in SHARD_ADAFACTOR_MODES]
            else:
                runs = [(name, shard_exp(mode, WIDE_CONFIGS.get(name, LARGE_CONFIG), e, n, **kw),
                         SHARD_NCCL_BATCH[name], shard_corpus(name, world))
                        for name, mode, e, n, kw in SHARD_NCCL_RUNS]
            for name, exp, batch, ds in runs:
                _, col = dp_data("norm", exp, ds, out)
                train = [ShardedLoader(ds, batch, col, seed=0, num_workers=4,
                                       shard_id=rank, num_shards=world)]
                save = {"fsdp": os.path.join(out, "ckpt"),
                        "zero1": os.path.join(out, "ckpt_zero1")}.get(name)
                steps = exp.trainer.epochs * exp.trainer.len_epoch
                run, grads, params = shard_run(
                    f"shard {name} rank {rank}",
                    lambda: Trainer(exp, train, [], save_dir=save, device=dev), steps, dev,
                    keep=rank == 0 and backend == "gloo")
                if rank == 0 and backend == "gloo":
                    torch.save(grads, os.path.join(out, f"{name}_grads.pt"))
                    torch.save(params, os.path.join(out, f"{name}_params.pt"))
                record["runs"][name] = run
                del grads, params
            if backend == "gloo":  # Adafactor and AdamW on fixed gradients (optim_fixed)
                record["fixed"], record["fixed_adamw"] = {}, {}
                for mode in SHARD_ADAFACTOR_MODES:
                    rec, params, named = optim_fixed(dev, mode, keep=rank == 0)
                    if rank == 0:
                        torch.save((params, named), os.path.join(out, f"fixed_{mode}.pt"))
                    record["fixed"][mode] = rec
                    del params, named
                    record["fixed_adamw"][mode] = optim_fixed(dev, mode, keep=False,
                                                              kind="adamw")[0]
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(record, f)
    finally:
        dist.destroy_process_group()
    return 0


def shard_one_process(tag, exp, ds, batch, world, dev, resume=None, save=None):
    """One process at batch world·`batch` over the ranks' global batches
    (GlobalBatches), replicated: its record and step 1's gradients."""
    from oatx_torch.data.loader import GlobalBatches, ShardedLoader
    from oatx_torch.train.trainer import Trainer

    _, col = dp_data("norm", exp, ds, None)
    train = [GlobalBatches([ShardedLoader(ds, batch, col, seed=0, num_workers=4, shard_id=r,
                                          num_shards=world) for r in range(world)])]
    steps = exp.trainer.epochs * exp.trainer.len_epoch
    if resume:
        steps = exp.trainer.len_epoch * (exp.trainer.epochs - 1)
    run, grads, params = shard_run(tag, lambda: Trainer(exp, train, [], resume=resume,
                                                        device=dev), steps, dev, keep=True)
    return run, grads, params


def shard_pre(dev, world=DP_WORLD):
    """Phase 11's one process at batch world·DP_RANK_BATCH over the ranks'
    global batches (shard_one_process): its record and step 1's
    gradients; and optim_fixed in one process (its parameters and state)."""
    one, ref, _ = shard_one_process("shard one process", shard_exp(None),
                                    MemoryClips(CORPUS_CLIPS, seed=0), DP_RANK_BATCH, world, dev)
    return one, ref, optim_fixed(dev)[1:]


def shard_ranks(smi, dev, world=DP_WORLD, backend="gloo", group=None, pre=None):
    """Phase 11: `world` ranks, this script started again with --dp-rank
    and --dp-phase shard (gloo: all on cuda:0; nccl: one card each;
    `group`: started already; `pre`: shard_pre's, for gloo). → the record
    and the ranks' launches."""
    gc.collect()
    torch.cuda.empty_cache()
    where = "one card over gloo" if backend == "gloo" else f"{world} cards over NCCL"
    group = group or Ranks(world, backend, "shard")
    try:
        tmp = group.tmp
        ranks = group.wait()
        wall_s = group.wall_s
        print(f"shard {backend} on CUDA tensors, probe ({smi}): "
              + json.dumps([r["probe"] for r in ranks]), flush=True)
        if not all(r["probe"]["ok"] for r in ranks):
            raise AssertionError(f"shard: {backend} refused CUDA tensors between the ranks")
        for name in ranks[0]["runs"]:
            if any(r["runs"][name]["terms"] != ranks[0]["runs"][name]["terms"] for r in ranks):
                raise AssertionError(f"shard {name}: the ranks' loss terms differ")
        launches = [r["runs"][n]["launches"] for r in ranks for n in r["runs"]]
        out = {"backend": backend, "world": world, "ranks_wall_s": wall_s, "runs": {}}
        for name, run in ranks[0]["runs"].items():
            held = [r["runs"][name]["held_bytes"]["total"] for r in ranks]
            want = run["predicted_bytes"]
            rec = {k: run[k] for k in ("mode", "steps", "terms", "traffic_per_step",
                                       "shared_params", "zero1_params", "predicted_bytes")}
            rec.update(held_bytes=[r["runs"][name]["held_bytes"] for r in ranks],
                       held_gb=[h / 1e9 for h in held],
                       rank_step_ms=[r["runs"][name]["step_ms"] for r in ranks],
                       peak_mem_gib=[r["runs"][name]["peak_mem_gib"] for r in ranks],
                       mem_held_gib=[r["runs"][name]["mem_held_gib"] for r in ranks],
                       saves=[r["runs"][name]["saves"] for r in ranks],
                       save_bound_mib=run["save_bound_mib"],
                       launches_per_rank=run["launches"])
            if backend == "gloo" and any(h != want["bytes"] for h in held):
                raise AssertionError(f"shard {name}: ranks hold {held} bytes of state, "
                                     f"sharding.state_bytes gives {want['bytes']}")
            if run["mode"] != "replicated" and not max(held) < want["replicated"]:
                raise AssertionError(f"shard {name}: a rank holds the replicated state")
            out["runs"][name] = rec
        if backend == "gloo":
            out["fixed_ranks"] = {m: [r["fixed"][m] for r in ranks]
                                  for m in SHARD_ADAFACTOR_MODES}
            out["adafactor_peaks"] = adafactor_peaks(ranks)
            shard_check_gloo(out, tmp, dev, world, smi, pre)
        else:
            shard_nccl_peaks(out, dev, smi)
    finally:
        group.cleanup()
    note = (" (rank step ms NOT a speed: the ranks share one card and gloo stages CUDA tensors "
            "through the host)" if backend == "gloo" else "")
    print(f"shard {world} ranks on {where} ({smi}){note}: " + json.dumps(out), flush=True)
    return out, launches


def shard_check_gloo(out, tmp, dev, world, smi, pre):
    """Phase 11's checks against one process at batch 16 on the same global
    batches (`pre`: shard_pre's): step 1's loss terms and whole
    gradients; the whole parameters after the last step against the
    replicated ranks' (the same arithmetic: bitwise) under AdamW, the
    optimizer's traffic against optim_traffic's under Adafactor; the ranks'
    optim_fixed against one process's (optim_fixed_check); the fsdp
    snapshot of epoch 1 restored in one process repeats the ranks' next
    step."""
    base = MemoryClips(CORPUS_CLIPS, seed=0)
    one, ref, fixed = pre
    out["one_process"] = {k: one[k] for k in ("terms", "step_ms", "peak_mem_gib", "held_bytes",
                                              "predicted_bytes")}
    rep_params = torch.load(os.path.join(tmp, "replicated_params.pt"))
    from oatx_torch.parallel.mesh import Layout

    layout = Layout(0, world)
    for name, rec in out["runs"].items():
        got = torch.load(os.path.join(tmp, f"{name}_grads.pt"))
        check = grad_check(got, ref)
        rel = {k: abs(rec["terms"][k][0] - v[0]) / abs(v[0]) for k, v in one["terms"].items()}
        params = torch.load(os.path.join(tmp, f"{name}_params.pt"))
        diff = max(float((params[k] - rep_params[k]).abs().max()) for k in rep_params)
        # step 1 precedes any update: its terms and gradients are the one
        # process's under every family. AdamW's shares update with the
        # replicated ranks' arithmetic (bitwise); Adafactor's sums cross the
        # ranks (optim_fixed's check), and its traffic is optim_traffic's
        adafactor = name.startswith("adafactor_")
        rec.update(step1_rel_diff=rel, params_max_abs_diff_vs_replicated=diff,
                   params_bitwise_vs_replicated=state_equal(params, rep_params),
                   **{k: check[k] for k in ("grad_norm", "plain_grad_norm", "grad_norm_rel_diff",
                                            "grad_global_cosine", "grad_tol_used",
                                            "grad_tensors", "grad_worst")})
        optimizer_traffic = None
        if adafactor:
            optimizer_traffic = {
                "got": {k: rec["traffic_per_step"].get(k, {}).get("bytes", 0)
                        for k in OPTIM_PURPOSES},
                "derived": optim_traffic(norm_shapes(), layout, rec["mode"])}
            rec["optimizer_traffic"] = optimizer_traffic
        if max(rel.values()) > DP_LOSS_RTOL or check["grad_tol_used"] > 1 \
                or check["grad_norm_rel_diff"] > GRAD_NORM_RTOL \
                or check["grad_global_cosine"] < GRAD_MIN_GLOBAL_COSINE \
                or not (adafactor or rec["params_bitwise_vs_replicated"]) \
                or (adafactor and optimizer_traffic["got"] != optimizer_traffic["derived"]):
            raise AssertionError(f"shard {name}: against one process {rel}, "
                                 f"{check['grad_worst']}; parameters against the replicated "
                                 f"ranks' differ by up to {diff}; optimizer traffic "
                                 f"{optimizer_traffic}")
        del got, params
    out["fixed"] = {mode: optim_fixed_check(
        f"shard Adafactor {mode}", os.path.join(tmp, f"fixed_{mode}.pt"),
        fixed, out["fixed_ranks"][mode], layout, mode)
        for mode in SHARD_ADAFACTOR_MODES}
    # the fsdp ranks' snapshot of epoch 1, restored in one process (epoch 2)
    resumed, _, _ = shard_one_process(
        "shard resumed in one process", shard_exp(None), base, DP_RANK_BATCH, world, dev,
        resume=os.path.join(tmp, "ckpt", "checkpoint-epoch1"))
    want = {k: v[SHARD_LEN_EPOCH] for k, v in out["runs"]["fsdp"]["terms"].items()}
    rel = {k: abs(resumed["terms"][k][0] - w) / abs(w) for k, w in want.items()}
    out["resume_fsdp_to_one_process"] = {"terms": resumed["terms"], "rel_diff": rel}
    if max(rel.values()) > DP_LOSS_RTOL:
        raise AssertionError(f"shard resume: one process from the fsdp snapshot {rel}")


def adafactor_peaks(ranks):
    """Phase 11's Adafactor ranks' device memory beside AdamW's in each of
    SHARD_ADAFACTOR_MODES, rank by rank: the training runs' peak GiB and
    the update's own peak on fixed gradients (optim_fixed's
    update_peak_mib: what `step()` allocates above what the rank held as it
    began). Adafactor's state is smaller and its update builds no tensor of
    a parameter's whole size for a share, so each must be at most AdamW's
    → the reading, or AssertionError."""
    out = {}
    for mode in SHARD_ADAFACTOR_MODES:
        out[mode] = {
            "peak_mem_gib": {"adafactor": [r["runs"][f"adafactor_{mode}"]["peak_mem_gib"]
                                           for r in ranks],
                             "adamw": [r["runs"][mode]["peak_mem_gib"] for r in ranks]},
            "update_peak_mib": {"adafactor": [r["fixed"][mode]["update_peak_mib"]
                                              for r in ranks],
                                "adamw": [r["fixed_adamw"][mode]["update_peak_mib"]
                                          for r in ranks]}}
    bad = [(mode, what) for mode, rec in out.items() for what, by in rec.items()
           if any(a > b for a, b in zip(by["adafactor"], by["adamw"]))]
    if bad:
        raise AssertionError(f"shard Adafactor: a rank's device memory above AdamW's in {bad}: "
                             f"{out}")
    return out


def shard_nccl_peaks(out, dev, smi):
    """--dp-nccl: each pod recipe in one process at a rank's batch on
    cuda:0, replicated, for its peak memory beside the ranks'."""
    for name, mode, e, n, kw in SHARD_NCCL_RUNS:
        from oatx_torch.data.loader import ShardedLoader
        from oatx_torch.train.trainer import Trainer

        exp = shard_exp(None, WIDE_CONFIGS.get(name, LARGE_CONFIG), e, n, **kw)
        ds = shard_corpus(name, 1)
        _, col = dp_data("norm", exp, ds, None)
        train = [ShardedLoader(ds, SHARD_NCCL_BATCH[name], col, seed=0, num_workers=4)]
        run, _, _ = shard_run(f"shard {name} one process", lambda: Trainer(
            exp, train, [], device=dev), e * n, dev, keep=False)
        out["runs"][name]["one_process"] = {k: run[k] for k in (
            "terms", "step_ms", "peak_mem_gib", "held_bytes", "predicted_bytes")}


def shard_phase(smi, dev, group, pre):
    """Sharded training state across ranks (module docstring, phase 11):
    the ranks of `group` against shard_pre's `pre`."""
    out, launches = shard_ranks(smi, dev, group=group, pre=pre)
    print(f"shard summary ({smi}): " + json.dumps({
        "runs": {name: {k: r.get(k) for k in (
            "held_gb", "step1_rel_diff", "grad_tol_used", "grad_global_cosine",
            "params_bitwise_vs_replicated", "traffic_per_step", "rank_step_ms", "peak_mem_gib",
            "saves", "save_bound_mib")}
            for name, r in out["runs"].items()},
        "resume": out["resume_fsdp_to_one_process"]["rel_diff"],
        "adafactor_peaks": out["adafactor_peaks"]}), flush=True)
    return {name: sum(l[name] for l in launches) for name in launches[0]}


# ---------------------------------------------------------------------- tp
TP_WORLD = 2          # phase 12: one model group of 2 ranks on cuda:0 over gloo
TP_BATCH = 16         # norm.json's per-GPU batch, one model group's rows
TP_STEPS = 2          # norm.json's sp_off / sp_on steps (depth given up for time: ROADMAP)
TP_RUNS = (  # (name, recipe, video_params keys, tower keys, steps) of phase 12 at
    # model_parallel 2 (tp_recipe); fused_mlp is no config key (in oatx neither): the
    # run sets it on the tower config the Trainer builds
    ("sp_off", "norm", dict(sequence_parallel=False), {}, TP_STEPS),
    ("sp_on", "norm", dict(sequence_parallel=True), {}, TP_STEPS),
    ("unfused_mlp", "norm", dict(sequence_parallel=True), dict(fused_mlp=False), 1),
    ("global_local", "global_local", dict(sequence_parallel=True), {}, 2),
    ("region_mem", "region_mem", dict(sequence_parallel=True), {}, 2),
    ("bert_stream3", "bert_stream3", {}, {}, 1),
    ("clip", "clip", {}, {}, 1),
    ("adafactor", "norm", dict(sequence_parallel=True), {}, 1))
TP_OPTIMIZER = {"adafactor": "Adafactor"}  # runs under another family than the recipe's AdamW
TP_LOSS_RTOL = 2e-3   # step 1's loss terms against one process at 16
# TP_F32_NOTE: step 1's loss terms and whole gradients of the ranks and of
# one process (both bf16) are also read against the same step of one
# process in f32 through the plain versions (tp_f32_step), the exact step
# up to f32 rounding, as phase 9 reads the wide recipes' (WIDE_F32_RATIO).
# The ranks' gradient's relative L2 distance from it is at most
# WIDE_F32_RATIO x one process's. Two bf16 results with independent
# rounding noise from the exact one differ by about the sum of their
# distances from it: where one process's own loss term is over
# TP_LOSS_RTOL / 2 from the f32 step's, the ranks' term is held to
# TP_LOSS_RTOL of the f32 step's instead of one process's, and where one
# process's own 1 − cos from the f32 gradient exceeds half of 1 −
# GRAD_MIN_GLOBAL_COSINE, the bf16 pair is not held to
# GRAD_MIN_GLOBAL_COSINE and the f32 reading decides (at random init the
# BERT-base and CLIP text towers' bf16 steps are that far from f32:
# PERF.md §6).
PAD_TEXT_LEN = 60     # the Collator's max_pad_text_len: global_local's caption + tags
# the kernels at a rank's shapes: kernel 1 on the hidden shard (R, D, 4D/mp),
# kernel 2 on the local heads (B, frames, N, H/mp, Dh)
TP_MLP = ((12560, 768, 1536), (12560, 1024, 1024), (4100, 1280, 1280), (3152, 768, 1536),
          (50192, 768, 768))
TP_SA = ((16, 4, 196, 6, 64), (16, 4, 196, 4, 64), (4, 4, 256, 4, 80), (16, 1, 196, 6, 64),
         (16, 16, 196, 3, 64))
TP_SHAPES_OF = {"ViT-B/16 mp 2 @16 (norm.json, phase 12)": (0, 0),
                "ViT-L/16 mp 4 @16 (vit_large_pod)": (1, 1),
                "ViT-H/14 mp 4 @4 (vit_huge_pod micro-batch)": (2, 2),
                "ViT-B/16 mp 2 object frame @16 (local_region_loss, region_mem; "
                "phase 12)": (3, 3),
                "ViT-B/16 mp 4 @16 over 16 frames (pod_v5p)": (4, 4)}
# --tp-nccl: (recipe, epochs, steps an epoch) as shipped, a rank on each card
TP_NCCL_RUNS = (("vit_huge_pod", 1, 5), ("vit_large_pod", 1, 5), ("pod_v5p", 1, 5))


def tp_exp(steps, path=NORM_CONFIG, **video):
    """A recipe for phase 12 / --tp-nccl: one epoch of `steps` steps, no
    init_val, no checkpoint; norm.json and the object-aware recipes at
    model_parallel TP_WORLD (the pod recipes keep theirs)."""
    kw = {} if path in WIDE_CONFIGS.values() else dict(model_parallel=TP_WORLD)
    exp = recipe(path, epochs=1, len_epoch=steps, init_val=False, save_period=10 ** 6,
                 verbosity=1, **kw)
    return set_video(exp, **video) if video else exp


def tp_recipe(name, steps, video):
    """Phase 12's recipe `name` (TP_RUNS) through tp_exp: norm.json, the
    object-aware recipes as shipped, norm.json with BERT-base text and
    arch.stream 3 at STREAM3_NCE_WEIGHT over STREAM3_TOP_K objects
    ('bert_stream3'), or with CLIP's text tower ('clip': 512 × 12, 8 heads,
    context 77)."""
    from oatx_torch.config.schema import ExperimentCfg

    exp = tp_exp(steps, OBJECT_CONFIGS.get(name, NORM_CONFIG), **video)
    if name not in ("bert_stream3", "clip"):
        return exp
    raw = json.loads(json.dumps(exp.raw))
    args = raw["arch"]["args"]
    if name == "clip":
        args["text_params"]["model"] = CLIP_TEXT_MODEL
        return ExperimentCfg.from_dict(raw)
    args["text_params"]["model"] = "bert-base-uncased"
    raw["arch"]["stream"] = 3
    args["object_params"].update(input_objects=True, top_k=STREAM3_TOP_K)
    raw["data_loader"][0]["args"]["object_params"] = {"input_objects": True,
                                                      "top_k": STREAM3_TOP_K}
    raw["loss"]["args"]["object_nce_weight"] = STREAM3_NCE_WEIGHT
    return ExperimentCfg.from_dict(raw)


def tp_data(name, exp, base, tmp):
    """(dataset, collator) of phase 12's recipe `name` over `base`'s clips:
    dp_data's for norm.json and the object-aware recipes (their files under
    `tmp`), stream 3's BUTD features (object_corpus) for 'bert_stream3', the
    CLIP tokenizer the CLI resolves from the captions for 'clip'."""
    from oatx_torch.cli.common import resolve_tokenizer
    from oatx_torch.data import factory
    from oatx_torch.data.loader import Collator
    from oatx_torch.data.tokenizer import WordPieceTokenizer

    if name == "clip":
        return base, Collator(resolve_tokenizer(exp, corpus=base.captions),
                              max_text_len=TEXT_LEN)
    if name != "bert_stream3":
        return dp_data(name if name in OBJECT_CONFIGS else "norm", exp, base, tmp)
    opts = factory.object_options_for_variant("baseline", exp.data_loaders[0])
    ds = object_corpus(base, os.path.join(tmp, "objects"), opts)
    return ds, Collator(WordPieceTokenizer.build_from_corpus(ds.captions),
                        max_text_len=TEXT_LEN)


def tp_reached(cfg):
    """Blocks of each video stream a step's loss reaches (want_launches'
    backward_depths): the clip's all; the object-aware variants' 1-frame
    object frame all under global_local, up to the tap under region_mem."""
    v = cfg.video
    if cfg.variant == "baseline":
        return (v.depth,)
    return v.depth, (v.depth if cfg.variant == "global_local" else v.region_tap_layer)


def tp_f32_step(exp, ds, col, dev, tower):
    """Step 1 of `exp` (one step of it) in one process at TP_BATCH on the
    rows tp_run's one process reads, in f32 through the plain versions: the
    exact step up to f32 rounding → (its loss terms, its gradients on the
    host)."""
    from oatx_torch.data.loader import ShardedLoader
    from oatx_torch.train.trainer import Trainer

    train = [ShardedLoader(ds, TP_BATCH, col, seed=0, num_workers=4)]
    with tower_keys(**tower):
        tr = Trainer(set_model_parallel(exp, 1), train, [], device=dev)
    first = FirstGrads(tr)
    rec = StepRecorder(tr)
    with plain_versions(), f32_compute(tr.state.model):
        tr.train()
    terms, grads = {k: v[0] for k, v in rec.term_values().items()}, first.grads
    del tr, first, rec
    gc.collect()
    torch.cuda.empty_cache()
    return terms, grads


def tp_f32_reading(got, ref, exact):
    """Each bf16 gradient's distance from the f32 step (tp_f32_grads):
    relative L2 over the whole gradient and global cosine, for the ranks'
    (`got`) and one process's (`ref`)."""
    norm = float(np.sqrt(sum(float(e.double().square().sum()) for e in exact.values())))
    out = {}
    for v, g in (("ranks", got), ("one_process", ref)):
        diff = sum(float((g[n].double() - exact[n].double()).square().sum()) for n in exact)
        dot = sum(float((g[n].double() * exact[n].double()).sum()) for n in exact)
        gn = float(np.sqrt(sum(float(g[n].double().square().sum()) for n in exact)))
        out[v] = {"rel_l2": float(np.sqrt(diff)) / norm, "cosine": dot / (gn * norm)}
    return out


def tp_slots(cfg, exp):
    """Objects a clip the loss runs the object tower over (0: none)."""
    return STREAM3_TOP_K if cfg.object_tower is not None and \
        exp.loss.object_nce_weight > 0 else 0


def tp_flops_per_clip_step(cfg, exp):
    """Model FLOPs of one clip's train step of phase 12's recipe: train/
    flops.py's for norm.json and the pod recipes, each stream at its own
    shape for the object-aware variants (object_flops_per_clip_step) and
    for the other text families and the object tower
    (towers_flops_per_clip_step)."""
    if cfg.variant != "baseline":
        return object_flops_per_clip_step(cfg, PAD_TEXT_LEN)
    if cfg.text_family != "distilbert" or cfg.object_tower is not None:
        return towers_flops_per_clip_step(cfg, TEXT_LEN, tp_slots(cfg, exp))
    return flops_per_clip_step(cfg)


def tp_traffic(cfg, batch, seq_len, mp, steps=1, remat=False, accum_steps=1,
               pad_len=PAD_TEXT_LEN, slots=0):
    """Bytes a rank hands to the model group's collectives in `steps` steps
    of `accum_steps` micro-batches of `batch` rows (parallel/collectives.py's
    purposes), derived from the code. Per ViT block 3 sublayers, each
    entered and left once forward and, where the loss reaches the block
    (tp_reached), once backward, over each video stream: the clip and, with
    an object-aware variant, its 1-frame object frame (T = 1 + N). Under
    sequence parallelism the stream's rows are padded to mp·⌈T/mp⌉; its
    split (backward all-gather), its final gather (forward) and the region
    tap's gather (forward) add a rank's rows each. A remat recompute runs a
    block's forward collectives again but the last: torch's checkpoint stops
    recomputing once it has every tensor the backward needs, and the MLP's
    leave feeds none. Per layer of the text tower (DistilBERT, BERT, CLIP
    text; never token-sharded) 2 sublayers, each left forward and entered
    backward, once a text stream: the caption at `seq_len` and, under
    global_local, the caption + tags at `pad_len`; CLIP's second pass
    (encode_text_tokens) runs only for return_tokens, which no train step
    asks for (CLIP text with global_local is refused). The (Distil)BERT
    vocabulary-parallel lookup's f32 all-reduce where the vocabulary
    divides, once a text stream. With `slots` (the loss runs the object
    tower) its 2 sublayers a layer over (batch, slots, dim)."""
    v, t = cfg.video, cfg.text
    es = torch.finfo(cfg.compute_dtype).bits // 8
    out = {"tp_reduce": 0, "sp_gather": 0, "sp_scatter": 0}
    r = 1 if remat else 0
    frames = (v.num_frames,) if cfg.variant == "baseline" else (v.num_frames, 1)
    for f, reached in zip(frames, tp_reached(cfg)):
        tokens = 1 + f * v.patches_per_frame
        rows = -(-tokens // mp)
        unit = batch * v.embed_dim * es
        if v.sequence_parallel:
            taps = 1 if v.region_tap_layer is not None else 0
            out["sp_gather"] += (3 * v.depth + 3 * (1 + r) * reached + 2 + taps) * rows * unit
            out["sp_scatter"] += (3 * v.depth + (3 + 2 * r) * reached) * mp * rows * unit
        else:
            out["tp_reduce"] += (3 * v.depth + (3 + 2 * r) * reached) * tokens * unit
    clip = cfg.text_family == "clip"
    layers, dim = (t.layers, t.width) if clip else (t.n_layers, t.dim)
    for length in (seq_len,) + ((pad_len,) if cfg.variant == "global_local" else ()):
        out["tp_reduce"] += layers * 2 * 2 * batch * length * dim * es
        if not clip and t.vocab_size % mp == 0:
            out["tp_reduce"] += batch * length * dim * 4
    if slots:
        o = cfg.object_tower
        out["tp_reduce"] += o.n_layers * 2 * 2 * batch * slots * o.dim * es
    return {k: n * steps * accum_steps for k, n in out.items()}


def tp_partial_bytes(model):
    """f32 bytes of the gradients a model rank holds in part (summed over the
    group once a step: 'tp_norm')."""
    return sum(4 * p.numel() for p in model.tp_partial_params())


def tp_probe(dev, rank, world):
    """shard_probe, and whether the group takes the token axis' bf16
    all_gather_into_tensor and reduce_scatter_tensor on 3-D CUDA tensors
    (parallel/collectives.py's gather_tokens / scatter_tokens)."""
    import torch.distributed as dist

    out = shard_probe(dev, rank, world)
    try:
        x = torch.full((2, 3, 4), rank + 1.0, device=dev, dtype=torch.bfloat16)
        got = torch.empty((world * 2, 3, 4), device=dev, dtype=torch.bfloat16)
        dist.all_gather_into_tensor(got, x)
        red = torch.empty((2, 3, 4), device=dev, dtype=torch.bfloat16)
        dist.reduce_scatter_tensor(red, torch.ones((world * 2, 3, 4), device=dev,
                                                   dtype=torch.bfloat16))
        out["bf16_tokens"] = bool(float(got[-1, 0, 0]) == world and float(red[0, 0, 0]) == world)
    except Exception as e:  # the probe's answer, not a failure of the port
        out["bf16_tokens"] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    out["ok"] = out["ok"] and out["bf16_tokens"] is True
    return out


class ReplicatedHashes:
    """Wraps a Trainer's train_step: after each step a digest of the
    parameters every model rank holds whole (neither split, shared nor a
    pipeline stage's), on the host, so model peers can be compared
    bitwise."""

    def __init__(self, trainer):
        import hashlib

        self.step, self.model, self.digests, self.hashlib = trainer.train_step, \
            trainer.state.model, [], hashlib
        trainer.train_step = self

    def __call__(self, state, batch):
        state, m = self.step(state, batch)
        h = self.hashlib.sha1()
        for n, p in self.model.named_parameters():
            if all(getattr(p, a, None) is None for a in ("_oatx_tp", "_oatx_shard", "_oatx_pp")):
                h.update(n.encode())
                h.update(p.detach().float().cpu().numpy().tobytes())
        self.digests.append(h.hexdigest())
        return state, m


@contextlib.contextmanager
def tower_keys(**video):
    """Trainers built inside get these SpaceTimeViTConfig keys on the tower
    config they build from their recipe."""
    from oatx_torch.train import trainer as trainer_mod

    build = trainer_mod.build_tower_config

    def patched(*args, **kwargs):
        cfg = build(*args, **kwargs)
        return dataclasses.replace(cfg, video=dataclasses.replace(cfg.video, **video))

    trainer_mod.build_tower_config = patched if video else build
    try:
        yield
    finally:
        trainer_mod.build_tower_config = build


def tp_run(tag, exp, ds, batch, dev, trace=False, keep_grads=True, tower=None,
           digests=True, col=None):
    """Trainer.train() of `exp` (with `tower` keys on its tower config) over
    `ds` at `batch` rows a data position on this rank, collated by `col`
    (default: norm.json's) → (record: loss terms, launches, traffic a step,
    held and predicted state bytes, replicated digests when `digests` (a
    host copy each step, inside the step intervals), step ms, MFU, peak
    memory, idle share when `trace`; step 1's whole gradients on the host
    when `keep_grads`)."""
    import torch.distributed as dist

    from oatx_torch.data.loader import ShardedLoader
    from oatx_torch.parallel import collectives as coll
    from oatx_torch.parallel import mesh as meshlib
    from oatx_torch.parallel import sharding
    from oatx_torch.train.trainer import Trainer

    t = exp.trainer
    layout = meshlib.current_layout(t.dcn_slices, t.model_parallel)
    if col is None:
        _, col = dp_data("norm", exp, ds, None)
    train = [ShardedLoader(ds, batch, col, seed=0, num_workers=4, shard_id=layout.position,
                           num_shards=layout.batch_shards)]
    held0 = fresh_peak(dev)
    with tower_keys(**(tower or {})):
        tr = Trainer(exp, train, [], device=dev)
    cfg, v = tr.tower_cfg, tr.tower_cfg.video
    steps, accum = t.epochs * t.len_epoch, t.accum_steps
    whole = {n: tuple((getattr(p, "_oatx_tp", None) or getattr(p, "_oatx_shard", None) or p).shape)
             for n, p in tr.state.model.named_parameters()}
    reps = 2 if v.remat else 1
    reached = tp_reached(cfg)
    streams = len(reached)
    rec = StepRecorder(tr, trace_at=steps - 1 if trace else None, expect=[
        ("space_attention_kernel", v.depth * accum * reps * streams),
        ("space_attention_bwd_kernel", sum(reached) * accum)] + (
        [("ln_mlp_", v.depth * accum * reps * streams)] if v.fused_mlp else []))
    hashes = ReplicatedHashes(tr) if digests else None
    first = FirstGrads(tr, keep_grads) if keep_grads else None
    launches = {}
    coll.reset_traffic()
    t0 = time.perf_counter()
    with counted(launches):  # ---- the main path, counted ----
        tr.train()
    wall_s = time.perf_counter() - t0
    traffic = {k: dict(r) for k, r in coll.TRAFFIC.items() if k != "check"}
    want = want_launches(v.depth, steps, v.remat, accum_steps=accum, backward_depths=reached)
    if not v.fused_mlp:
        want["ln_mlp"] = 0
    check_launches(tag, launches, want)
    terms = rec.term_values()
    if not all(np.isfinite(x) for vals in terms.values() for x in vals):
        raise AssertionError(f"{tag}: loss terms not finite: {terms}")
    mode = tr.shard_mode if layout.spans_processes else None
    predicted = sharding.state_bytes(whole, layout.data_size, mode, ema=bool(t.ema_decay),
                                     model_parallel=layout.model_parallel,
                                     kind=exp.optimizer.type)
    held = sharding.held_bytes(tr.state.model, tr.state.optimizer)
    torch.cuda.synchronize()
    # step intervals, without those the trace of the last two steps touches
    ms = [a.elapsed_time(b) for a, b in zip(rec.events, rec.events[1:])]
    if trace:
        ms = ms[:-2]
    flops = tp_flops_per_clip_step(cfg, exp) / layout.model_parallel  # a rank's share
    out = {"steps": steps, "batch_per_group": batch, "accum_steps": accum,
           "variant": cfg.variant, "text_family": cfg.text_family,
           "object_tower": cfg.object_tower is not None, "backward_depths": reached,
           "sequence_parallel": v.sequence_parallel, "fused_mlp": v.fused_mlp,
           "remat": v.remat_policy if v.remat else "off", "terms": terms,
           "launches": launches, "launches_per_forward": {
               k: launches[k] / (steps * accum * reps) for k in ("ln_mlp", "space_attention")},
           "bwd_launches_per_step": launches["space_attention_bwd"] / (steps * accum),
           "traffic": traffic, "held_bytes": held, "predicted_bytes": predicted,
           "partial_bytes": tp_partial_bytes(tr.state.model),
           "digests": hashes.digests if hashes is not None else None,
           "split_params": sum(getattr(p, "_oatx_tp", None) is not None
                               for p in tr.state.model.parameters()),
           "train_wall_s": wall_s, "mem_held_gib": held0,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           **(speed(ms, batch, flops) if ms else {}), **(rec.traced() or {})}
    grads = first.grads if first is not None else None
    del tr, rec, hashes, first
    gc.collect()
    torch.cuda.empty_cache()
    return out, grads


def tp_rank_main(rank, world, url, out, backend):
    """One rank of phase 12 (gloo, cuda:0) or --tp-nccl (NCCL, cuda:rank),
    started by tp_ranks: the probe, then the runs; its record →
    out/rank{rank}.json, rank 0's step-1 whole gradients →
    out/{run}_grads.pt (phase 12)."""
    import datetime

    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=url, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=DP_RANK_TIMEOUT_S))
    try:
        record = {"probe": tp_probe(dev, rank, world), "runs": {}}
        if record["probe"]["ok"]:
            if backend == "gloo":
                base = MemoryClips(CORPUS_CLIPS, seed=0)
                for name, kind, video, tower, steps in TP_RUNS:
                    exp = tp_optimizer(name, tp_recipe(kind, steps, video))
                    ds, col = tp_data(kind, exp, base, os.path.join(out, f"rank{rank}"))
                    run, grads = tp_run(f"tp {name} rank {rank}", exp, ds, TP_BATCH, dev,
                                        tower=tower, col=col)
                    if rank == 0:
                        torch.save(grads, os.path.join(out, f"{name}_grads.pt"))
                    record["runs"][name] = run
                    del grads
                # Adafactor on fixed gradients at the model axis (optim_fixed)
                rec, params, named = optim_fixed(dev, None, TP_WORLD, keep=rank == 0)
                if rank == 0:
                    torch.save((params, named), os.path.join(out, "fixed_mp.pt"))
                record["fixed"] = rec
                del params, named
            else:
                for name, epochs, steps in TP_NCCL_RUNS:
                    exp = recipe(WIDE_CONFIGS[name], epochs=epochs, len_epoch=steps,
                                 init_val=False, save_period=10 ** 6, verbosity=1)
                    batch = exp.data_loaders[0].batch_size
                    run, _ = tp_run(f"tp-nccl {name} rank {rank}", exp, recipe_clips(exp),
                                    batch, dev, trace=True, keep_grads=False, digests=False)
                    record["runs"][name] = run
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(record, f)
    finally:
        dist.destroy_process_group()
    return 0


def tp_ranks(world, backend, tmp, phase="tp", group=None):
    """`world` ranks of this script started again with --dp-rank and
    --dp-phase `phase` ('tp' or 'pp'; gloo: all on cuda:0; nccl: one card
    each), writing into `tmp` (`group`: started already, writing into its
    own) → each rank's record (their log tails printed if one fails)."""
    ranks = (group or Ranks(world, backend, phase, tmp)).wait()
    print(f"{phase} {backend} probe: " + json.dumps([r["probe"] for r in ranks]), flush=True)
    if not all(r["probe"]["ok"] for r in ranks):
        raise AssertionError(f"{phase}: {backend} refused the model group's collectives on "
                             "CUDA tensors")
    for name in ranks[0]["runs"]:
        runs = [r["runs"][name] for r in ranks]
        if any(x["terms"] != runs[0]["terms"] for x in runs):
            raise AssertionError(f"{phase} {name}: the model peers' loss terms differ")
        if any(x["digests"] != runs[0]["digests"] for x in runs):
            raise AssertionError(f"{phase} {name}: the model peers' replicated parameters "
                                 "differ after some step")
    return ranks


def tp_kernels(dev, smi):
    """Kernels 1 and 2 at the shard shapes a rank gives them (TP_SHAPES_OF),
    against their plain versions; kernel 1 with a zero fc2 bias, as the
    model group calls it; printed → {kernel: {shape: record}}."""
    g = torch.Generator(dev).manual_seed(12)
    mlp = wide_ln_mlp(dev, g, TP_MLP, zero_b2=True)
    sa_fwd, sa_bwd = wide_space_attention(dev, g, TP_SA)
    out = {"ln_mlp": {}, "space_attention": {}, "space_attention_bwd": {}}
    for label, (i, j) in TP_SHAPES_OF.items():
        R, D, H = TP_MLP[i]
        B, Fr, N, Hh, Dh = TP_SA[j]
        key = f"B{B}_T{1 + Fr * N}_H{Hh}_Dh{Dh}"
        out["ln_mlp"][label] = {"shape": f"{R}x{D}->{H}", **mlp[f"{R}x{D}->{H}"]}
        out["space_attention"][label] = {"shape": key, **sa_fwd[key]}
        out["space_attention_bwd"][label] = {"shape": key, **sa_bwd[key]}
    for name, recs in out.items():
        print(f"tp kernels {name} at the shard shapes ({smi}): " + json.dumps(recs), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_pre(dev):
    """Phase 12's references for each of TP_RUNS: one process at TP_BATCH
    on the ranks' rows (tp_run) and the f32 step (tp_f32_step) → {run:
    (record, its step-1 gradients, f32 terms, f32 gradients)}. One process
    has no model axis, so sequence_parallel changes nothing there: runs that
    differ only in it share one run; the f32 step through the plain
    versions is the same function with fused_mlp on or off, so the runs of
    one recipe share it."""
    base = MemoryClips(CORPUS_CLIPS, seed=0)
    refs, ones, f32_steps = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, kind, video, tower, steps in TP_RUNS:
            exp = tp_optimizer(name, tp_recipe(kind, steps, video))
            ds, col = tp_data(kind, exp, base, os.path.join(tmp, "reference"))
            key = (kind, steps, json.dumps(tower, sort_keys=True), exp.optimizer.type)
            if key not in ones:
                ones[key] = tp_run(f"tp {name} one process", set_model_parallel(exp, 1), ds,
                                   TP_BATCH, dev, tower=tower, digests=False, col=col)
            if kind not in f32_steps:
                f32_steps[kind] = tp_f32_step(tp_recipe(kind, 1, video), ds, col, dev, tower)
            refs[name] = ones[key] + f32_steps[kind]
    refs["fixed"] = optim_fixed(dev)[1:]  # optim_fixed's check in one process
    return refs


def tp_phase(smi, dev, group, refs):
    """Tensor and sequence parallelism over a model axis (module docstring,
    phase 12): the ranks of `group` against tp_pre's `refs` → launches of
    the ranks' main paths."""
    from oatx_torch.parallel.mesh import Layout

    try:
        ranks = tp_ranks(TP_WORLD, "gloo", group.tmp, group=group)
        tmp = group.tmp
        out = {"world": TP_WORLD, "model_parallel": TP_WORLD, "batch_per_group": TP_BATCH,
               "ranks_wall_s": group.wall_s, "runs": {}}
        for name, kind, video, tower, steps in TP_RUNS:
            exp = tp_optimizer(name, tp_recipe(kind, steps, video))
            runs = [r["runs"][name] for r in ranks]
            one, ref, f32_terms, exact = refs.pop(name)
            got = torch.load(os.path.join(tmp, f"{name}_grads.pt"))
            check = grad_check(got, ref)
            f32 = tp_f32_reading(got, ref, exact)
            del got, ref, exact
            rel = {k: abs(runs[0]["terms"][k][0] - w[0]) / abs(w[0])
                   for k, w in one["terms"].items()}
            # against the f32 step, for the ranks and for one process (TP_F32_NOTE)
            rel_f32 = {v: {k: abs(terms[k][0] - w) / abs(w) for k, w in f32_terms.items()}
                       for v, terms in (("ranks", runs[0]["terms"]),
                                        ("one_process", one["terms"]))}
            from oatx_torch.config.schema import build_tower_config, precision_dtype

            cfg = build_tower_config(exp.arch, compute_dtype=precision_dtype(
                exp.trainer.precision))
            cfg = dataclasses.replace(cfg, video=dataclasses.replace(cfg.video, **tower))
            want = tp_traffic(cfg, TP_BATCH, TEXT_LEN, TP_WORLD, steps, slots=tp_slots(cfg, exp))
            got_traffic = {k: runs[0]["traffic"].get(k, {}).get("bytes", 0) for k in want}
            held = [r["held_bytes"]["total"] for r in runs]
            rec = {"steps": steps, "recipe": kind, **{k: runs[0][k] for k in (
                       "variant", "text_family", "object_tower", "backward_depths",
                       "sequence_parallel", "fused_mlp", "launches_per_forward",
                       "bwd_launches_per_step", "split_params", "predicted_bytes",
                       "partial_bytes")},
                   "step1_terms": {k: [runs[0]["terms"][k][0], w[0]]
                                   for k, w in one["terms"].items()},
                   "step1_rel_diff": rel, "f32_terms": f32_terms,
                   "step1_rel_diff_f32": rel_f32, "losses": runs[0]["terms"]["loss"],
                   "one_process_losses": one["terms"]["loss"],
                   "traffic_per_step": {k: n / steps for k, n in got_traffic.items()},
                   "traffic_derived_per_step": {k: n / steps for k, n in want.items()},
                   "tp_norm_bytes_per_step": runs[0]["traffic"].get("tp_norm", {}).get(
                       "bytes", 0) / steps,
                   "held_bytes": held, "one_process_held_bytes": one["held_bytes"]["total"],
                   "rank_step_ms": [r.get("step_ms") for r in runs],
                   "one_process_step_ms": one.get("step_ms"),
                   "peak_mem_gib": [r["peak_mem_gib"] for r in runs],
                   "one_process_peak_mem_gib": one["peak_mem_gib"],
                   **{k: check[k] for k in ("grad_norm", "plain_grad_norm",
                                            "grad_norm_rel_diff", "grad_global_cosine",
                                            "grad_tol_used", "grad_tensors", "grad_worst")},
                   "grad_f32": f32}
            if name in TP_OPTIMIZER:  # the optimizer's own collectives (optim_traffic)
                rec["optimizer_traffic"] = {
                    "got": {k: runs[0]["traffic"].get(k, {}).get("bytes", 0) / steps
                            for k in OPTIM_PURPOSES},
                    "derived": optim_traffic(norm_shapes(), Layout(0, TP_WORLD, 1, TP_WORLD),
                                             None)}
            out["runs"][name] = rec
            print(f"tp {name}: {kind} at model_parallel {TP_WORLD}, {TP_WORLD} ranks on one "
                  f"card over gloo against one process at {TP_BATCH} ({smi}; rank step ms NOT "
                  "a tensor-parallel speed: the ranks share one card and gloo stages CUDA "
                  "tensors through the host): " + json.dumps(rec), flush=True)
            bad = []
            # a term one process's bf16 step holds to under TP_LOSS_RTOL / 2 of the f32
            # step's is held against one process; a noisier one against the f32 step
            for k, r in rel.items():
                noisy_term = rel_f32["one_process"][k] > TP_LOSS_RTOL / 2
                if (rel_f32["ranks"][k] if noisy_term else r) > TP_LOSS_RTOL:
                    bad.append(f"step 1's {k}: {r} from one process, {rel_f32}")
            # the ranks' gradient no farther from the f32 step than WIDE_F32_RATIO x one
            # process's; the bf16 pair's cosine under GRAD_MIN_GLOBAL_COSINE passes only
            # where one process alone spends over half of its budget (TP_F32_NOTE)
            noisy = 1 - f32["one_process"]["cosine"] > (1 - GRAD_MIN_GLOBAL_COSINE) / 2
            if check["grad_tol_used"] > 1 or check["grad_norm_rel_diff"] > GRAD_NORM_RTOL \
                    or (check["grad_global_cosine"] < GRAD_MIN_GLOBAL_COSINE and not noisy) \
                    or f32["ranks"]["rel_l2"] > WIDE_F32_RATIO * f32["one_process"]["rel_l2"]:
                bad.append(f"gradients {check['grad_worst']}, against the f32 step {f32}")
            if any(h != runs[0]["predicted_bytes"]["bytes"] for h in held):
                bad.append(f"held bytes {held} against the plan's "
                           f"{runs[0]['predicted_bytes']['bytes']}")
            if got_traffic != want:
                bad.append(f"collective bytes {got_traffic}, derived {want}")
            if name in TP_OPTIMIZER and rec["optimizer_traffic"]["got"] \
                    != rec["optimizer_traffic"]["derived"]:
                bad.append(f"optimizer traffic {rec['optimizer_traffic']}")
            if rec["tp_norm_bytes_per_step"] != runs[0]["partial_bytes"]:
                bad.append(f"tp_norm bytes {rec['tp_norm_bytes_per_step']}, derived "
                           f"{runs[0]['partial_bytes']}")
            # kernels 1 and 2 once a block of each video stream a forward, kernel
            # 2's backward once a block the loss reaches (tp_reached)
            lpf, reached = runs[0]["launches_per_forward"], tp_reached(cfg)
            per = 12 * len(reached)
            if lpf["space_attention"] != per or lpf["ln_mlp"] != (per if tower.get(
                    "fused_mlp", True) else 0) or runs[0]["bwd_launches_per_step"] != sum(
                    reached):
                bad.append(f"launches per forward {lpf}, backward a step "
                           f"{runs[0]['bwd_launches_per_step']}")
            if bad:
                raise AssertionError(f"tp {name}: " + "; ".join(bad))
        out["fixed"] = optim_fixed_check(
            "tp Adafactor mp 2", os.path.join(tmp, "fixed_mp.pt"), refs.pop("fixed"),
            [r["fixed"] for r in ranks], Layout(0, TP_WORLD, 1, TP_WORLD), None)
        print(f"tp Adafactor on fixed gradients at model_parallel {TP_WORLD} against one "
              f"process ({smi}): " + json.dumps(out["fixed"]), flush=True)
    finally:
        group.cleanup()
    launches = [r["runs"][n]["launches"] for r in ranks for n in r["runs"]]
    print(f"tp summary ({smi}): " + json.dumps({
        "runs": {n: {k: r[k] for k in ("step1_rel_diff", "step1_rel_diff_f32",
                                       "grad_tol_used", "grad_global_cosine", "grad_f32",
                                       "held_bytes", "traffic_per_step",
                                       "launches_per_forward", "bwd_launches_per_step")}
                 for n, r in out["runs"].items()}}), flush=True)
    return {name: sum(l[name] for l in launches) for name in launches[0]}


def tp_optimizer(name, exp):
    """exp under the optimizer family TP_OPTIMIZER names for run `name`."""
    return with_optimizer(exp, TP_OPTIMIZER[name]) if name in TP_OPTIMIZER else exp


def set_model_parallel(exp, mp):
    from oatx_torch.config.schema import ExperimentCfg

    raw = json.loads(json.dumps(exp.raw))
    raw["trainer"]["model_parallel"] = mp
    return ExperimentCfg.from_dict(raw)


def tp_nccl(smi, dev):
    """--tp-nccl: TP_NCCL_RUNS, the pod recipes as shipped (model_parallel 4,
    sequence_parallel, fsdp over a data axis of 1), a rank on each of 4
    cards over NCCL; per rank peak GiB, step ms, MFU (a rank's 1/4 of the
    FLOPs over one card's peak) and idle share; then each recipe in one
    process at model_parallel 1 on cuda:0 at the same batch beside them."""
    world = torch.cuda.device_count()
    if world != 4:
        raise SystemExit(f"--tp-nccl needs 4 cards (model_parallel 4), {world} visible")
    with tempfile.TemporaryDirectory() as tmp:
        ranks = tp_ranks(world, "nccl", tmp)
    out = {}
    for name, epochs, steps in TP_NCCL_RUNS:
        runs = [r["runs"][name] for r in ranks]
        exp = recipe(WIDE_CONFIGS[name], epochs=epochs, len_epoch=steps, init_val=False,
                     save_period=10 ** 6, verbosity=1)
        batch = exp.data_loaders[0].batch_size
        one, _ = tp_run(f"tp-nccl {name} one process", set_model_parallel(exp, 1),
                        recipe_clips(exp), batch, dev, trace=True, keep_grads=False,
                        digests=False)
        rel = {k: abs(runs[0]["terms"][k][0] - w[0]) / abs(w[0])
               for k, w in one["terms"].items()}
        keys = ("peak_mem_gib", "step_ms", "step_ms_spread", "mfu", "clips_per_s",
                "idle_share", "device_busy_ms", "held_bytes", "train_wall_s")
        rec = {"recipe": os.path.basename(WIDE_CONFIGS[name]), "model_parallel": world,
               "batch_per_group": batch, "accum_steps": runs[0]["accum_steps"],
               "remat": runs[0]["remat"], "sequence_parallel": runs[0]["sequence_parallel"],
               "steps": runs[0]["steps"], "losses": runs[0]["terms"]["loss"],
               "per_rank": {k: [r.get(k) for r in runs] for k in keys},
               "predicted_bytes": runs[0]["predicted_bytes"],
               "launches_per_forward": runs[0]["launches_per_forward"],
               "traffic_per_step": {k: v["bytes"] / runs[0]["steps"]
                                    for k, v in runs[0]["traffic"].items()},
               "one_process": {k: one.get(k) for k in keys + ("terms",)},
               "step1_rel_diff_vs_one_process": rel}
        out[name] = rec
        print(f"tp-nccl {name} as shipped, a rank on each of {world} cards over NCCL "
              f"({smi}): " + json.dumps(rec), flush=True)
        if any(h["total"] != runs[0]["predicted_bytes"]["bytes"]
               for h in rec["per_rank"]["held_bytes"]):
            raise AssertionError(f"tp-nccl {name}: held bytes {rec['per_rank']['held_bytes']} "
                                 f"against the plan's {runs[0]['predicted_bytes']}")
        if max(rel.values()) > TP_LOSS_RTOL:
            raise AssertionError(f"tp-nccl {name}: step 1's loss terms against one process "
                                 f"{rel}")
    return out




# ---------------------------------------------------------------------- pp
PP_WORLD = 2          # phase 13: one pipeline group of 2 stages on cuda:0 over gloo
PP_BATCH = 16         # norm.json's per-GPU batch, one pipeline group's rows
PP_MICRO = 4          # pipeline_microbatches (the schema's default)
PP_STEPS = 4
PP_RUNS = (  # (name, trainer keys, tower keys, steps) of phase 13: norm.json with
    # pipeline true at model_parallel 2; fused_qkv is no config key: the run sets it
    # on the tower config the Trainer builds
    ("plain", {}, {}, PP_STEPS),
    ("fused_qkv", {}, dict(fused_qkv=True), 1),
    ("zero1", dict(zero1=True), {}, 1))
PP_LOSS_RTOL = 2e-3   # step 1's loss terms against one process at 16
PP_EVAL_MIN_COSINE = 0.999  # each validation embedding against one process on the same weights
# the kernels at a stage's micro-batch shapes (ViT-B/16's, norm.json at 16 over
# 4 micro-batches, are phase 2's record shapes: R 3140 and B 4 × 785 tokens):
# kernel 1 (R, D, 4D), kernel 2 (B, frames, N, H, Dh)
PP_MLP = ((3140, 1024, 4096), (1025, 1280, 5120))
PP_SA = ((4, 4, 196, 16, 64), (1, 4, 256, 16, 80))
PP_SHAPES_OF = {"ViT-L/16 pp micro-batch of 4 (vit_large_pod @16, M 4)": (0, 0),
                "ViT-H/14 pp micro-batch of 1 (vit_huge_pod @8 as 2 x 4, M 4)": (1, 1)}
# --pp-nccl: (recipe, epochs, steps an epoch), pipeline at the shipped model_parallel 4
PP_NCCL_RUNS = (("vit_huge_pod", 1, 5), ("vit_large_pod", 1, 5))


def pp_exp(steps, path=NORM_CONFIG, epochs=1, **trainer):
    """A recipe for phase 13 / --pp-nccl: `epochs` epochs of `steps` steps,
    no init_val, no monitor, no checkpoint unless `trainer` asks (its keys
    win), `pipeline` true over PP_MICRO micro-batches;
    norm.json at model_parallel PP_WORLD, the pod recipes at their own 4
    with fsdp and sequence_parallel off (oatx refuses either with
    pipeline)."""
    kw = dict(epochs=epochs, len_epoch=steps, init_val=False, save_period=10 ** 6,
              monitor="off", verbosity=1, pipeline=True, pipeline_microbatches=PP_MICRO)
    kw.update(dict(model_parallel=PP_WORLD) if path == NORM_CONFIG else dict(fsdp=False))
    kw.update(trainer)
    return set_video(recipe(path, **kw), sequence_parallel=False)


def pp_embed_bytes(cfg):
    """f32 bytes of the video embedding's parameters (their gradients are
    summed over the model group once a step: 'pp_embed')."""
    v = cfg.video
    d = v.embed_dim
    return 4 * (d * v.in_chans * v.patch_size ** 2 + d + d + (v.patches_per_frame + 1) * d
                + v.num_frames * d)


def pp_traffic(cfg, rows, stage, stages, steps, accum_steps=1, eval_rows=0, staged=False):
    """Bytes a rank of `stage` of `stages` hands to the pipeline's sends in
    `steps` steps of `accum_steps` micro-batches of `rows` rows and a
    validation of `eval_rows` rows (parallel/pipeline.py, parallel/
    collectives.py's purposes), derived from the code: per tower forward
    the stack's (rows, T, D) output leaves every stage but the last once
    ('pp_send') and is broadcast from the last ('pp_bcast', counted on every
    stage); per backward the cotangent of a stage's input leaves every stage
    but the first once ('pp_grad'); the embedding's f32 gradients are summed
    over the model group once a step ('pp_embed'). `staged` (gloo): every
    send and receive crosses the host ('pp_host': the bytes sent and
    received)."""
    v = cfg.video
    es = torch.finfo(cfg.compute_dtype).bits // 8
    act = (1 + v.num_frames * v.patches_per_frame) * v.embed_dim * es
    train = steps * accum_steps * rows * act
    fwd = train + eval_rows * act
    first, last = stage == 0, stage == stages - 1
    out = {"pp_send": 0 if last else fwd, "pp_grad": 0 if first else train,
           "pp_bcast": fwd, "pp_embed": steps * pp_embed_bytes(cfg)}
    if staged:
        out["pp_host"] = (out["pp_send"] + out["pp_grad"] + (0 if first else fwd)
                          + (0 if last else train))
    return out


def pp_probe(dev, rank, world):
    """tp_probe, and the pipeline's own calls on CUDA tensors through
    parallel/collectives.py: a bf16 send to the next rank and a receive from
    the previous (over gloo through a host copy: gloo's transport aborts the
    process on a CUDA address) and a broadcast from the last rank: 'ok'
    needs all."""
    from oatx_torch.parallel import collectives as coll

    out = tp_probe(dev, rank, world)
    try:
        x = torch.full((3, 5), rank + 1.0, device=dev, dtype=torch.bfloat16)
        if rank + 1 < world:
            coll.send_to(x, rank + 1, "probe")
        got = coll.recv_from(x.shape, x.dtype, dev, rank - 1) if rank else None
        b = torch.full((4,), float(rank), device=dev)
        coll.broadcast_from(b, world - 1, None, "probe")
        out["p2p"] = bool((got is None or (got.device == dev and float(got[2, 4]) == rank))
                          and float(b[3]) == world - 1)
    except Exception as e:  # the probe's answer, not a failure of the port
        out["p2p"] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    out["ok"] = out["ok"] and out["p2p"] is True
    return out


class EvalEmbeds:
    """Wraps a Trainer's eval_step: every eval step's text and video
    embeddings, on the host."""

    def __init__(self, trainer):
        self.step, self.rows = trainer.eval_step, {"text_embeds": [], "video_embeds": []}
        trainer.eval_step = self

    def __call__(self, model, batch):
        out = self.step(model, batch)
        for k in self.rows:
            self.rows[k].append(out[k].float().cpu())
        return out

    def embeds(self):
        return {k: torch.cat(v) for k, v in self.rows.items() if v}


def pp_run(tag, exp, ds, batch, dev, trace=False, keep_grads=True, tower=None,
           digests=True, valid=False, save_dir=None):
    """Trainer.train() of `exp` (with `tower` keys on its tower config) over
    `ds` at `batch` rows a data position on this rank, with a validation
    over the position's clips when `valid` and a snapshot under `save_dir`
    → (record: loss terms, launches against the derived ones, pp_* traffic
    against pp_traffic, held and predicted state bytes, replicated digests
    when `digests`, step ms, MFU (a rank's 1/P of the FLOPs), peak memory,
    idle share and device ms by group (NCCL's send / receive kernels among
    them) when `trace`; step 1's whole gradients and the validation's
    embeddings on the host)."""
    import torch.distributed as dist

    from oatx_torch.data.loader import ShardedLoader
    from oatx_torch.parallel import collectives as coll
    from oatx_torch.parallel import mesh as meshlib
    from oatx_torch.parallel import sharding
    from oatx_torch.train.trainer import Trainer

    t = exp.trainer
    layout = meshlib.current_layout(t.dcn_slices, t.model_parallel, t.pipeline)
    stages = layout.model_parallel if layout.pipeline else 1
    _, col = dp_data("norm", exp, ds, None)
    shard = dict(shard_id=layout.position, num_shards=layout.batch_shards, num_workers=4)
    train = [ShardedLoader(ds, batch, col, seed=0, **shard)]
    valid_l = [ShardedLoader(ds, batch, col, shuffle=False, drop_last=False, **shard)] \
        if valid else []
    held0 = fresh_peak(dev)
    with tower_keys(**(tower or {})):
        tr = Trainer(exp, train, valid_l, save_dir=save_dir, device=dev)
    cfg, v = tr.tower_cfg, tr.tower_cfg.video
    steps, accum = t.epochs * t.len_epoch, t.accum_steps
    micro = v.pipeline_microbatches if stages > 1 else 1
    depth = v.depth // stages  # a stage's blocks
    reps = 2 if v.remat else 1
    rec = StepRecorder(tr, trace_at=steps - 1 if trace else None, expect=[
        ("space_attention_kernel", depth * micro * accum * reps),
        ("space_attention_bwd_kernel", depth * micro * accum),
        ("ln_mlp_", depth * micro * accum * reps)])
    hashes = ReplicatedHashes(tr) if digests else None
    first = FirstGrads(tr, keep_grads) if keep_grads else None
    evals = EvalEmbeds(tr) if valid else None
    launches = {}
    coll.reset_traffic()
    t0 = time.perf_counter()
    with counted(launches):  # ---- the main path, counted ----
        tr.train()
    wall_s = time.perf_counter() - t0
    traffic = {k: dict(r) for k, r in coll.TRAFFIC.items() if k not in ("check", "probe")}
    # the validation embeds the position's clips in chunks of 8 (eval_forwards);
    # a chunk of 8 rows runs min(M, 8) micro-batches through a stage's blocks
    n_val = len(ds) // layout.batch_shards if valid else 0
    eval_launches = eval_forwards(1, n_val, batch) * depth * (min(micro, 8) if valid else 0)
    want = want_launches(depth * micro, steps, v.remat, accum_steps=accum)
    for k in ("ln_mlp", "space_attention"):
        want[k] += eval_launches
    if v.fused_qkv:
        want["ln_linear"] = 2 * steps * accum * reps * depth * micro + 2 * eval_launches
    check_launches(tag, launches, want)
    terms = rec.term_values()
    if not all(np.isfinite(x) for vals in terms.values() for x in vals):
        raise AssertionError(f"{tag}: loss terms not finite: {terms}")
    whole_shapes = tower_shapes(cfg)
    mode = tr.shard_mode if layout.spans_processes else None
    predicted = sharding.state_bytes(whole_shapes, layout.data_size, mode,
                                     ema=bool(t.ema_decay), model_parallel=stages,
                                     pipeline=stages > 1, kind=exp.optimizer.type)
    held = sharding.held_bytes(tr.state.model, tr.state.optimizer)
    derived = pp_traffic(cfg, batch // accum, layout.stage if stages > 1 else 0, stages,
                         steps, accum, n_val, staged=dist.get_backend() == "gloo"
                         ) if stages > 1 else {}
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(rec.events, rec.events[1:])]
    if trace:
        ms = ms[:-2]
    flops = flops_per_clip_step(cfg) / stages  # a rank's share
    out = {"steps": steps, "batch_per_group": batch, "accum_steps": accum,
           "stages": stages, "microbatches": micro, "stage_blocks": depth,
           "fused_qkv": v.fused_qkv, "remat": v.remat_policy if v.remat else "off",
           "zero1": bool(t.zero1), "terms": terms, "launches": launches,
           "launches_derived": want, "launches_per_forward": {
               k: (launches[k] - (eval_launches if k != "space_attention_bwd" else 0))
               / (steps * accum * reps if k != "space_attention_bwd" else steps * accum)
               for k in ("ln_mlp", "space_attention", "space_attention_bwd")},
           "traffic": traffic, "pp_traffic_derived": derived,
           "held_bytes": held, "predicted_bytes": predicted,
           "digests": hashes.digests if hashes is not None else None,
           "train_wall_s": wall_s, "mem_held_gib": held0,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           **(speed(ms, batch, flops) if ms else {}), **(rec.traced() or {})}
    grads = first.grads if first is not None else None
    embeds = evals.embeds() if evals is not None else None
    del tr, rec, hashes, first, evals
    gc.collect()
    torch.cuda.empty_cache()
    return out, grads, embeds


def tower_shapes(cfg):
    """{name: shape} of the whole model of a tower config, built on the meta
    device (no weights)."""
    from oatx_torch.models.towers import DualTower

    with torch.device("meta"):
        model = DualTower(dataclasses.replace(cfg, video=dataclasses.replace(
            cfg.video, pipeline_stages=1)), device="meta", generator=torch.Generator())
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def pp_rank_main(rank, world, url, out, backend):
    """One rank of phase 13 (gloo, cuda:0) or --pp-nccl (NCCL, cuda:rank),
    started by tp_ranks: the probe, then the runs; its record →
    out/rank{rank}.json, rank 0's step-1 whole gradients and validation
    embeddings → out/{run}_grads.pt, out/{run}_evals.pt (phase 13)."""
    import datetime

    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=url, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=DP_RANK_TIMEOUT_S))
    try:
        record = {"probe": pp_probe(dev, rank, world), "runs": {}}
        if record["probe"]["ok"]:
            if backend == "gloo":
                base = MemoryClips(CORPUS_CLIPS, seed=0)
                for name, trainer, tower, steps in PP_RUNS:
                    plain = name == "plain"
                    run, grads, embeds = pp_run(
                        f"pp {name} rank {rank}", pp_exp(steps, save_period=1 if plain
                                                         else 10 ** 6, **trainer),
                        base, PP_BATCH, dev, tower=tower, valid=plain,
                        save_dir=os.path.join(out, "ckpt") if plain else None)
                    if rank == 0:
                        torch.save(grads, os.path.join(out, f"{name}_grads.pt"))
                        torch.save(embeds, os.path.join(out, f"{name}_evals.pt"))
                    record["runs"][name] = run
                    del grads, embeds
            else:
                for name, epochs, steps in PP_NCCL_RUNS:
                    exp = pp_exp(steps, WIDE_CONFIGS[name], epochs=epochs)
                    batch = exp.data_loaders[0].batch_size
                    run, _, _ = pp_run(f"pp-nccl {name} rank {rank}", exp,
                                       MemoryClips(max(CORPUS_CLIPS, batch), seed=0), batch,
                                       dev, trace=True, keep_grads=False, digests=False)
                    record["runs"][name] = run
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(record, f)
    finally:
        dist.destroy_process_group()
    return 0


def pp_kernels(dev, smi):
    """Kernels 1 and 2 (forward and backward) at a stage's micro-batch
    shapes of the pod recipes (PP_SHAPES_OF) against their plain versions;
    printed → {kernel: {shape: record}}."""
    g = torch.Generator(dev).manual_seed(13)
    mlp = wide_ln_mlp(dev, g, PP_MLP)
    sa_fwd, sa_bwd = wide_space_attention(dev, g, PP_SA)
    out = {"ln_mlp": {}, "space_attention": {}, "space_attention_bwd": {}}
    for label, (i, j) in PP_SHAPES_OF.items():
        R, D, H = PP_MLP[i]
        B, Fr, N, Hh, Dh = PP_SA[j]
        key = f"B{B}_T{1 + Fr * N}_H{Hh}_Dh{Dh}"
        out["ln_mlp"][label] = {"shape": f"{R}x{D}->{H}", **mlp[f"{R}x{D}->{H}"]}
        out["space_attention"][label] = {"shape": key, **sa_fwd[key]}
        out["space_attention_bwd"][label] = {"shape": key, **sa_bwd[key]}
    for name, recs in out.items():
        print(f"pp kernels {name} at the micro-batch shapes ({smi}): " + json.dumps(recs),
              flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pp_key(tower):
    """The one-process reference a run of PP_RUNS is held against: zero1
    changes no number, so plain's serves it."""
    return "fused_qkv" if tower.get("fused_qkv") else "plain"


def pp_pre(dev):
    """Phase 13's one-process references (pp_run at PP_BATCH) → {pp_key:
    (record, step-1 gradients)}."""
    base = MemoryClips(CORPUS_CLIPS, seed=0)
    refs = {}
    for name, trainer, tower, steps in PP_RUNS:
        if pp_key(tower) not in refs:
            refs[pp_key(tower)] = pp_run(
                f"pp {name} one process", set_model_parallel(pp_exp(steps, **trainer), 1),
                base, PP_BATCH, dev, tower=tower, digests=False)[:2]
    return refs


def pp_phase(smi, dev, group, refs):
    """Pipeline stages over the model axis (module docstring, phase 13):
    the ranks of `group` against pp_pre's `refs` → launches of the ranks'
    main paths."""
    base = MemoryClips(CORPUS_CLIPS, seed=0)
    try:
        ranks = tp_ranks(PP_WORLD, "gloo", group.tmp, phase="pp", group=group)
        tmp, ranks_s = group.tmp, group.wall_s
        out = {"world": PP_WORLD, "stages": PP_WORLD, "microbatches": PP_MICRO,
               "batch_per_group": PP_BATCH, "ranks_wall_s": ranks_s, "runs": {}}
        for name, trainer, tower, steps in PP_RUNS:
            runs = [r["runs"][name] for r in ranks]
            one, ref = refs[pp_key(tower)]
            got = torch.load(os.path.join(tmp, f"{name}_grads.pt"))
            check = grad_check(got, ref)
            del got
            rel = {k: abs(runs[0]["terms"][k][0] - w[0]) / abs(w[0])
                   for k, w in one["terms"].items()}
            held = [r["held_bytes"]["total"] for r in runs]
            traffic = [{k: r["traffic"].get(k, {}).get("bytes", 0)
                        for k in r["pp_traffic_derived"]} for r in runs]
            rec = {"steps": steps, **{k: runs[0][k] for k in (
                       "fused_qkv", "zero1", "stage_blocks", "microbatches",
                       "launches_per_forward", "predicted_bytes")},
                   "step1_terms": {k: [runs[0]["terms"][k][0], w[0]]
                                   for k, w in one["terms"].items()},
                   "step1_rel_diff": rel, "losses": runs[0]["terms"]["loss"],
                   "one_process_losses": one["terms"]["loss"][:steps],
                   "traffic": traffic, "traffic_derived": [r["pp_traffic_derived"]
                                                           for r in runs],
                   "held_bytes": held, "one_process_held_bytes": one["held_bytes"]["total"],
                   "rank_step_ms": [r.get("step_ms") for r in runs],
                   "one_process_step_ms": one.get("step_ms"),
                   "peak_mem_gib": [r["peak_mem_gib"] for r in runs],
                   "one_process_peak_mem_gib": one["peak_mem_gib"],
                   **{k: check[k] for k in ("grad_norm", "plain_grad_norm",
                                            "grad_norm_rel_diff", "grad_global_cosine",
                                            "grad_tol_used", "grad_tensors", "grad_worst")}}
            bad = []
            if name == "plain":
                rec["resume"], one_evals = pp_resume(os.path.join(tmp, "ckpt"), base, dev)
                evals = torch.load(os.path.join(tmp, "plain_evals.pt"))
                cos = {k: float(F.cosine_similarity(evals[k], one_evals[k], dim=1).min())
                       for k in one_evals}
                rec["eval_min_cosine"] = cos
                if min(cos.values()) < PP_EVAL_MIN_COSINE or \
                        evals["video_embeds"].shape != one_evals["video_embeds"].shape:
                    bad.append(f"validation embeddings' cosine {cos}")
                if not rec["resume"]["bitwise"]:
                    bad.append(f"the snapshot's restore in one process {rec['resume']}")
            out["runs"][name] = rec
            print(f"pp {name}: norm.json with pipeline on {PP_WORLD} stages, {PP_MICRO} "
                  f"micro-batches, {PP_WORLD} ranks on one card over gloo against one process "
                  f"at {PP_BATCH} ({smi}; rank step ms NOT a pipeline speed: the ranks share "
                  "one card and gloo stages every send through the host): " + json.dumps(rec),
                  flush=True)
            if max(rel.values()) > PP_LOSS_RTOL:
                bad.append(f"step 1's loss terms {rel}")
            if check["grad_tol_used"] > 1 or check["grad_norm_rel_diff"] > GRAD_NORM_RTOL \
                    or check["grad_global_cosine"] < GRAD_MIN_GLOBAL_COSINE:
                bad.append(f"gradients {check['grad_worst']}")
            if any(h != runs[0]["predicted_bytes"]["bytes"] for h in held):
                bad.append(f"held bytes {held} against the plan's "
                           f"{runs[0]['predicted_bytes']['bytes']}")
            if any(g != r["pp_traffic_derived"] for g, r in zip(traffic, runs)):
                bad.append(f"pp bytes {traffic}, derived {rec['traffic_derived']}")
            lpf = runs[0]["launches_per_forward"]
            want_lpf = 12 // PP_WORLD * PP_MICRO
            if any(n != want_lpf for n in lpf.values()):
                bad.append(f"launches per forward {lpf}, derived {want_lpf}")
            if bad:
                raise AssertionError(f"pp {name}: " + "; ".join(bad))
    finally:
        group.cleanup()
    launches = [r["runs"][n]["launches"] for r in ranks for n in r["runs"]]
    print(f"pp summary ({smi}): " + json.dumps({
        "runs": {n: {k: r.get(k) for k in ("step1_rel_diff", "grad_tol_used",
                                           "grad_global_cosine", "held_bytes", "traffic",
                                           "launches_per_forward", "eval_min_cosine")}
                 for n, r in out["runs"].items()},
        "ranks_wall_s": ranks_s}), flush=True)
    return {name: sum(l[name] for l in launches) for name in launches[0]}


def pp_resume(save_dir, base, dev):
    """The ranks' checkpoint-epoch1 restored by one process (pipeline on a
    model axis of 1) → (record: the restored parameters and moments bitwise
    the snapshot's, then one more step with finite loss terms; that
    process's validation embeddings on the restored weights, the weights
    the ranks validated with before they saved)."""
    from oatx_torch.data.loader import ShardedLoader
    from oatx_torch.train.trainer import Trainer

    snap = os.path.join(save_dir, "checkpoint-epoch1")
    saved = torch.load(os.path.join(snap, "state.pt"), map_location="cpu", weights_only=True)
    exp = set_model_parallel(pp_exp(1, epochs=2), 1)
    _, col = dp_data("norm", exp, base, None)
    tr = Trainer(exp, [ShardedLoader(base, PP_BATCH, col, seed=0, num_workers=4)],
                 [ShardedLoader(base, PP_BATCH, col, shuffle=False, drop_last=False,
                                num_workers=4)], resume=snap, device=dev)
    model = {k: v.cpu() for k, v in tr.state.model.state_dict().items()}
    opt = tr.state.optimizer.named_state(to_host=True)
    bitwise = (sorted(model) == sorted(saved["model"])
               and all(torch.equal(model[k], v) for k, v in saved["model"].items())
               and all(torch.equal(opt[q][k], v) for q in ("mu", "nu")
                       for k, v in saved["optimizer"][q].items()))
    evals = EvalEmbeds(tr)
    tr._validate(1)
    embeds = evals.embeds()
    tr.valid_loaders = []
    rec = StepRecorder(tr)
    tr.train()
    terms = rec.term_values()
    out = {"bitwise": bool(bitwise), "tensors": len(saved["model"]), "resumed_terms": terms,
           "finite": all(np.isfinite(x) for vals in terms.values() for x in vals)}
    out["bitwise"] = out["bitwise"] and out["finite"]
    del tr, rec, evals
    gc.collect()
    torch.cuda.empty_cache()
    return out, embeds


def pp_nccl(smi, dev):
    """--pp-nccl: PP_NCCL_RUNS, the pod recipes with pipeline true at their
    shipped model_parallel 4 (fsdp and sequence_parallel off), a rank on
    each of 4 cards over NCCL; per rank peak GiB, step ms, MFU (a rank's
    1/4 of the FLOPs over one card's peak), idle share and device ms by
    group (NCCL's send / receive kernels, waiting included, among them)
    from a 2-step trace; then each recipe in one process at model_parallel
    1 on cuda:0 at the same batch beside them."""
    world = torch.cuda.device_count()
    if world != 4:
        raise SystemExit(f"--pp-nccl needs 4 cards (model_parallel 4), {world} visible")
    with tempfile.TemporaryDirectory() as tmp:
        ranks = tp_ranks(world, "nccl", tmp, phase="pp")
    out = {}
    for name, epochs, steps in PP_NCCL_RUNS:
        runs = [r["runs"][name] for r in ranks]
        exp = pp_exp(steps, WIDE_CONFIGS[name], epochs=epochs)
        batch = exp.data_loaders[0].batch_size
        one, _, _ = pp_run(f"pp-nccl {name} one process", set_model_parallel(exp, 1),
                           MemoryClips(max(CORPUS_CLIPS, batch), seed=0), batch, dev,
                           trace=True, keep_grads=False, digests=False)
        rel = {k: abs(runs[0]["terms"][k][0] - w[0]) / abs(w[0])
               for k, w in one["terms"].items()}
        keys = ("peak_mem_gib", "step_ms", "step_ms_spread", "mfu", "clips_per_s",
                "idle_share", "device_busy_ms", "device_ms_by_group", "held_bytes",
                "train_wall_s")
        m = runs[0]["microbatches"]
        rec = {"recipe": os.path.basename(WIDE_CONFIGS[name]), "stages": world,
               "microbatches": m, "stage_blocks": runs[0]["stage_blocks"],
               "bubble_derived": (world - 1) / (m + world - 1),
               "batch_per_group": batch, "accum_steps": runs[0]["accum_steps"],
               "remat": runs[0]["remat"], "steps": runs[0]["steps"],
               "losses": runs[0]["terms"]["loss"],
               "per_rank": {k: [r.get(k) for r in runs] for k in keys},
               "predicted_bytes": runs[0]["predicted_bytes"],
               "launches_per_forward": runs[0]["launches_per_forward"],
               "traffic_per_step": [{k: v["bytes"] / r["steps"] for k, v in r["traffic"].items()}
                                    for r in runs],
               "one_process": {k: one.get(k) for k in keys + ("terms",)},
               "step1_rel_diff_vs_one_process": rel}
        out[name] = rec
        print(f"pp-nccl {name} with pipeline on {world} stages, a rank on each of {world} "
              f"cards over NCCL ({smi}): " + json.dumps(rec), flush=True)
        if any(h["total"] != runs[0]["predicted_bytes"]["bytes"]
               for h in rec["per_rank"]["held_bytes"]):
            raise AssertionError(f"pp-nccl {name}: held bytes {rec['per_rank']['held_bytes']} "
                                 f"against the plan's {runs[0]['predicted_bytes']}")
        if max(rel.values()) > PP_LOSS_RTOL:
            raise AssertionError(f"pp-nccl {name}: step 1's loss terms against one process "
                                 f"{rel}")
        for r in runs:
            got = {k: r["traffic"].get(k, {}).get("bytes", 0) for k in r["pp_traffic_derived"]}
            if got != r["pp_traffic_derived"]:
                raise AssertionError(f"pp-nccl {name}: pp bytes {got}, derived "
                                     f"{r['pp_traffic_derived']}")
    return out


# ------------------------------------------------------------- phases 10-13
RANK_WORLDS = {"dp": DP_WORLD, "shard": DP_WORLD, "tp": TP_WORLD, "pp": PP_WORLD}


def rank_phases(smi, dev, names=("dp", "shard", "tp", "pp")):
    """Phases 10-13 (those in `names`): tp's and pp's kernels timed first,
    alone; then the phases' gloo rank groups (RankGroups) while this
    process takes their one-process references; then each phase holds its
    ranks' records against them → ({phase: launches}, {phase: kernel
    records at its shapes})."""
    kernels = {n: f(dev, smi) for n, f in (("tp", tp_kernels), ("pp", pp_kernels))
               if n in names}
    if kernels:
        lap("12-13 kernels at the shard and micro-batch shapes")
    groups = RankGroups((n, RANK_WORLDS[n]) for n in names)
    try:
        takes = {"dp": lambda: dp_pre(smi, dev), "tp": lambda: tp_pre(dev),
                 "pp": lambda: pp_pre(dev), "shard": lambda: shard_pre(dev)}
        pre = {}
        for n in [n for n in takes if n in names]:
            pre[n] = takes[n]()
            lap(f"{n}: the references")
        checks = {"dp": dp_phase, "shard": shard_phase, "tp": tp_phase, "pp": pp_phase}
        launches = {}
        for n in names:
            launches[n] = checks[n](smi, dev, groups.group(n), pre.pop(n))
            lap(f"{n}: the ranks held against them")
    finally:
        groups.stop()
    return launches, kernels


# ----------------------------------------------------------------- extract
EXTRACT_CONFIG = OBJECT_CONFIGS["global_local"]  # local_region_loss.json: ViT-B/16 at 224², bf16
EXTRACT_CLIP_SIZE = (320, 240)
EXTRACT_CLIP_FRAMES = (5, 16, 24, 32, 40, 48, 56, 64)  # the first is shorter than the grid
EXTRACT_SLOTS = 8           # cli.extract's --frames default: the uniform 8-slot grid
EXTRACT_WORKERS = 4         # extract_dataset's default pool of threads
EXTRACT_REGIONS = 10
EXTRACT_WIDTH = 768         # ViT-B/16's embed_dim: the features' columns before the zero pad
EXTRACT_TORCH_ATOL = 1e-5   # (e): the scripted detector on the card against the CPU
EXTRACT_TORCH_SLOTS = 2
EXTRACT_TRACED_FRAMES = 8
EXTRACT_TRAIN_BATCH = 4     # (f): 8 clips, 2 steps
EXTRACT_TRAIN_STEPS = 2
EXTRACT_EXPECT = (("ln_mlp_", 12), ("space_attention_kernel", 12))


class BoxColour(torch.nn.Module):
    """(e)'s detector, scripted in the phase: each of 4 fixed boxes' mean
    colour through a linear layer, the boxes in the frame's pixels."""

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(3, 64)

    def forward(self, img: torch.Tensor):
        h, w = img.shape[1], img.shape[2]
        rel = torch.tensor([[0.0, 0.0, 0.5, 0.5], [0.25, 0.25, 1.0, 0.75],
                            [0.5, 0.0, 1.0, 1.0], [0.1, 0.6, 0.4, 0.9]], device=img.device)
        boxes = rel * torch.tensor([float(w), float(h), float(w), float(h)],
                                   device=img.device)
        b = boxes.long()
        feats = []
        for i in range(4):
            feats.append(img[:, b[i, 1]:b[i, 3], b[i, 0]:b[i, 2]].mean(dim=(1, 2)))
        return (self.proj(torch.stack(feats)), boxes, torch.arange(4, device=img.device),
                torch.linspace(0.9, 0.5, 4, device=img.device))


def extract_cli(argv):
    """oatx_torch.cli.extract.main(argv) → (its stdout lines, its stderr)."""
    from oatx_torch.cli import extract as cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli.extract {argv}: exit {rc}\n{err.getvalue()}")
    return out.getvalue().splitlines(), err.getvalue()


def extract_stats(argv, want):
    """The stats line of a cli.extract run, held to `want` (its counts)."""
    stats = json.loads(extract_cli(argv)[0][-1])
    got = {k: stats[k] for k in want}
    if got != want:
        raise AssertionError(f"cli.extract {argv}: stats {stats}, expected {want}")
    return stats


def read_npz(path):
    with np.load(path, allow_pickle=True) as z:
        return z["x"], z["bbox"], z["info"].item()


def check_extracted(root, items, width):
    """Every slot of every clip under root: x (regions, 2048) finite with
    columns width onward exactly 0, bbox inside the frame, info with
    objects_id, objects_conf, image_w and image_h → {(clip, slot): x}."""
    fw, fh = EXTRACT_CLIP_SIZE
    feats = {}
    for vid, _ in items:
        for s in range(EXTRACT_SLOTS):
            x, bbox, info = read_npz(os.path.join(root, vid, f"{s}.npz"))
            k = EXTRACT_REGIONS
            bad = []
            if x.shape != (k, 2048) or x.dtype != np.float32 or not np.isfinite(x).all():
                bad.append(f"x {x.shape} {x.dtype}")
            elif np.any(x[:, width:]) or not np.any(x[:, :width]):
                bad.append("x not zero past the tower's width, or zero before it")
            if bbox.shape != (k, 4) or not (np.all(bbox >= 0) and np.all(bbox[:, 2] <= fw)
                                            and np.all(bbox[:, 3] <= fh)
                                            and np.all(bbox[:, :2] <= bbox[:, 2:])):
                bad.append(f"bbox {bbox.tolist()}")
            if sorted(info) != ["image_h", "image_w", "objects_conf", "objects_id"] or \
                    (info["image_w"], info["image_h"]) != (fw, fh) or \
                    np.shape(info["objects_id"]) != (k,) or np.shape(info["objects_conf"]) != (k,):
                bad.append(f"info {info}")
            if bad:
                raise AssertionError(f"extract {vid}/{s}.npz: {bad}")
            feats[vid, s] = x[:, :width]
    return feats


def region_cosines(got, want):
    """Cosine of each region's features between two runs, over every file."""
    a = np.concatenate([got[k] for k in sorted(want)]).astype(np.float64)
    b = np.concatenate([want[k] for k in sorted(want)]).astype(np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def extract_torch_detector(tmp, lst, items, dev):
    """(e): BoxColour scripted and saved, run on the card through cli.extract
    and on the CPU through extract_dataset: every file within
    EXTRACT_TORCH_ATOL."""
    from oatx_torch.data import extraction as ex

    torch.manual_seed(0)
    art = os.path.join(tmp, "box_colour.torchscript")
    torch.jit.script(BoxColour()).save(art)
    card, cpu = os.path.join(tmp, "torch_card"), os.path.join(tmp, "torch_cpu")
    n = len(items)
    want = {"processed": n, "skipped": 0, "failed": 0, "frames": n * EXTRACT_TORCH_SLOTS}
    extract_stats(["--list", lst, "--out", card, "--frames", str(EXTRACT_TORCH_SLOTS),
                   "--detector", "torch", "--detector-weights", art, "--device", str(dev)],
                  want)
    stats = ex.extract_dataset(items, cpu, ex.load_torch_detector(art, "cpu"),
                               num_extraction_frames=EXTRACT_TORCH_SLOTS)
    if {k: stats[k] for k in want} != want:
        raise AssertionError(f"extract (e) on the CPU: {stats}")
    worst = 0.0
    for vid, _ in items:
        for s in range(EXTRACT_TORCH_SLOTS):
            got, ref = read_npz(os.path.join(card, vid, f"{s}.npz")), \
                read_npz(os.path.join(cpu, vid, f"{s}.npz"))
            pairs = [(got[0], ref[0]), (got[1], ref[1])] + \
                [(got[2][k], ref[2][k]) for k in ref[2]]
            for a, b in pairs:
                if np.shape(a) != np.shape(b):
                    raise AssertionError(f"extract (e) {vid}/{s}: {np.shape(a)} vs {np.shape(b)}")
                worst = max(worst, float(np.abs(np.asarray(a, np.float64) - b).max()))
    if worst > EXTRACT_TORCH_ATOL:
        raise AssertionError(f"extract (e): the card's files {worst:.3e} from the CPU's "
                             f"(> {EXTRACT_TORCH_ATOL})")
    return {"files": n * EXTRACT_TORCH_SLOTS, "max_abs_diff": worst}


def extract_train(videos, objects, dev):
    """(f): local_region_loss.json's global_local loader (SyntheticVideoText
    over the clips, object_dir the extracted tree, strict loading) and its
    Trainer, EXTRACT_TRAIN_STEPS counted steps at EXTRACT_TRAIN_BATCH."""
    from oatx_torch.cli.common import dataset_captions
    from oatx_torch.config.schema import ExperimentCfg
    from oatx_torch.data.factory import build_loaders
    from oatx_torch.data.tokenizer import WordPieceTokenizer
    from oatx_torch.train.trainer import Trainer

    with open(EXTRACT_CONFIG) as f:
        raw = json.load(f)
    dl = raw["data_loader"][0]["args"]
    dl.update(dataset_name="SyntheticVideoText", data_dir=videos, object_dir=objects,
              batch_size=EXTRACT_TRAIN_BATCH, num_workers=4)
    dl["video_params"].update(num_videos=len(EXTRACT_CLIP_FRAMES), loading="strict")
    raw["trainer"].update(epochs=1, len_epoch=EXTRACT_TRAIN_STEPS, init_val=False,
                          monitor="off", verbosity=0)
    exp = ExperimentCfg.from_dict(raw)
    tok = WordPieceTokenizer.build_from_corpus(dataset_captions(exp)
                                               + [f"obj{i}" for i in range(1600)])
    tr = Trainer(exp, build_loaders(exp, tok), [], device=dev)
    depth = tr.tower_cfg.video.depth
    rec = StepRecorder(tr)
    launches = {}
    with counted(launches):  # ---- the hand-off to training, counted ----
        tr.train()
    check_launches("extract (f)", launches, want_launches(
        depth, EXTRACT_TRAIN_STEPS, False, backward_depths=(depth, depth)))
    terms = rec.term_values()
    if len(terms["loss"]) != EXTRACT_TRAIN_STEPS or \
            not all(np.isfinite(v).all() for v in terms.values()):
        raise AssertionError(f"extract (f): loss terms {terms}")
    return {"steps": EXTRACT_TRAIN_STEPS, "batch": EXTRACT_TRAIN_BATCH,
            "terms": terms}, launches


def extract_phase(smi, dev):
    """Offline object extraction (module docstring, phase 14) → (its record,
    the launches of (b), the launches of (f))."""
    from concurrent.futures import ThreadPoolExecutor

    from oatx_torch.cli import extract as cli
    from oatx_torch.data import video_reader as vr

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the clips, named as SyntheticVideoText names them
        videos = os.path.join(tmp, "videos")
        os.makedirs(videos)
        fw, fh = EXTRACT_CLIP_SIZE
        items = [(f"clip{i:04d}", os.path.join(videos, f"clip{i:04d}.avi"))
                 for i in range(len(EXTRACT_CLIP_FRAMES))]
        with ThreadPoolExecutor(8) as pool:
            for fut in [pool.submit(vr.write_test_video, p, fw, fh, n, 8, i)
                        for i, ((_, p), n) in enumerate(zip(items, EXTRACT_CLIP_FRAMES))]:
                fut.result()
        lst = os.path.join(tmp, "items.tsv")
        with open(lst, "w") as f:
            f.write("".join(f"{v}\t{p}\n" for v, p in items))
        n = len(items)
        frames = n * EXTRACT_SLOTS
        objects, plain = os.path.join(tmp, "objects"), os.path.join(tmp, "plain")
        roi = ["--list", lst, "--workers", str(EXTRACT_WORKERS), "--regions",
               str(EXTRACT_REGIONS), "--detector", "roi_backbone", "--detector-config",
               EXTRACT_CONFIG, "--device", str(dev)]
        all_done = {"processed": n, "skipped": 0, "failed": 0, "frames": frames}

        # (g) device busy a frame and the idle share: one extractor, warmed
        # (the process's first use of the card's libraries is not timed),
        # then a CUDA-only trace of EXTRACT_TRACED_FRAMES frames (not counted)
        det = cli._build_roi_backbone(EXTRACT_CONFIG, None, EXTRACT_REGIONS, dev)
        sample = [vr.decode_indices(p, [0])[0] for _, p in items][:EXTRACT_TRACED_FRAMES]
        for fr in sample:
            det(fr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for fr in sample:
            det(fr)
        one_ms = (time.perf_counter() - t0) * 1e3 / len(sample)
        turn = [0]

        def next_frame():
            turn[0] += 1
            return det(sample[turn[0] % len(sample)])

        busy, _, groups, _ = device_trace(next_frame, len(sample), expect=EXTRACT_EXPECT)
        del det
        out.update(device_busy_ms_per_frame=busy, device_ms_by_group=groups,
                   one_thread_ms_per_frame=one_ms, idle_share_one_thread=1 - busy / one_ms)

        # (b) the ViT-B/16 tower through cli.extract, counted
        launches = {}
        t0 = time.perf_counter()
        with counted(launches):  # ---- the main path, counted ----
            stats = extract_stats([*roi, "--out", objects], all_done)
        out["cli_wall_s"] = time.perf_counter() - t0
        check_launches("extract (b)", launches, {"ln_mlp": 12 * frames,
                                                 "space_attention": 12 * frames,
                                                 "space_attention_bwd": 0, "ln_linear": 0})
        width = EXTRACT_WIDTH
        got = check_extracted(objects, items, width)
        out.update(frames=frames, frames_per_s=stats["frames_per_sec"],
                   pool_s=stats["seconds"], launches=launches,
                   idle_share_pool=1 - busy * stats["frames_per_sec"] / 1e3)
        one = extract_stats([*roi, "--out", os.path.join(tmp, "one"), "--workers", "1"],
                            all_done)
        out["frames_per_s_one_worker"] = one["frames_per_sec"]

        # (c) the same extraction through the plain versions
        plain_launches = {}
        with plain_versions(), counted(plain_launches):
            extract_stats([*roi, "--out", plain], all_done)
        if any(plain_launches.values()):
            raise AssertionError(f"extract (c): the plain run launched {plain_launches}")
        cos = region_cosines(got, check_extracted(plain, items, width))
        out["min_region_cosine"] = float(cos.min())
        if out["min_region_cosine"] < E2E_MIN_COSINE:
            raise AssertionError(f"extract (c): region cosine {cos.min():.6f} against the "
                                 f"plain versions (< {E2E_MIN_COSINE})")

        # (d) resumability: a second run skips every clip; the loss list
        extract_stats([*roi, "--out", objects],
                      {"processed": 0, "skipped": n, "failed": 0, "frames": 0})
        miss = ["--list", lst, "--out", objects, "--missing-only"]
        if extract_cli(miss)[0]:
            raise AssertionError("extract (d): --missing-only lists clips after a full run")
        gone = os.path.join(objects, items[3][0], "5.npz")
        before = read_npz(gone)
        os.remove(gone)
        listed, _ = extract_cli(miss)
        if listed != [f"{items[3][0]}\t{items[3][1]}"]:
            raise AssertionError(f"extract (d): --missing-only lists {listed}")
        loss_list = os.path.join(tmp, "loss_list.tsv")
        with open(loss_list, "w") as f:
            f.write("\n".join(listed) + "\n")
        extract_stats([*roi, "--list", loss_list, "--out", objects, "--overwrite"],
                      {"processed": 1, "skipped": 0, "failed": 0, "frames": EXTRACT_SLOTS})
        after = read_npz(gone)
        rewrite_cos = region_cosines({0: after[0][:, :width]}, {0: before[0][:, :width]})
        if extract_cli(miss)[0] or not np.array_equal(after[1], before[1]) or \
                rewrite_cos.min() < E2E_MIN_COSINE:
            raise AssertionError("extract (d): the rewritten file differs or the loss list "
                                 "is not empty")
        out["rewrite_min_cosine"] = float(rewrite_cos.min())

        # (e) a TorchScript detector on the card
        out["torch_detector"] = extract_torch_detector(tmp, lst, items, dev)

        # (f) the extracted tree feeds global_local's Trainer
        out["train"], train_launches = extract_train(videos, objects, dev)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"extract ({smi}): " + json.dumps(out), flush=True)
    return launches, train_launches


# --------------------------------------------------------------------- viz
VIZ_CAPTION = "a dog chases the ball past a tree near the house"
VIZ_MIN_COSINE = 0.9999     # the kernels' forward against the plain versions' (phase 14's
                            # regions held 0.99999, above E2E_MIN_COSINE)
VIZ_CLIP_TOL = 1e-4         # the CLIP path on the card against the CPU, of each output's scale
VIZ_TIMED_FORWARDS = 10     # 1-frame forwards timed by the host clock and traced (device busy)
VIZ_REGION_CLIPS = 8        # WebVid-layout clips of (c)
VIZ_REGION_CLIP = (320, 240, 32)
VIZ_MAPS_LIMIT = 16         # export_region_maps' default limit
VIZ_TOWER = {"ln_mlp": 12, "space_attention": 12, "space_attention_bwd": 0, "ln_linear": 0}
VIZ_TOWER_PATCHES = (196, 256)  # ViT-B/16's 14² patches through vid_proj
VIZ_CLIP_PATCHES = (196, 512)   # CLIP ViT-B/16's 14² patches through proj


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def run_cli(module, argv):
    """module.main(argv) with its stdout captured → its lines; a non-zero
    exit raises."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = module.main(argv)
    if rc != 0:
        raise AssertionError(f"{module.__name__} {argv}: exit {rc}\n{out.getvalue()}")
    return out.getvalue().splitlines()


def rendered(seen):
    """heatmap.render_caption_heatmaps recording its word embeddings and
    patches into `seen`."""
    from oatx_torch.visualization import heatmap

    render = heatmap.render_caption_heatmaps

    def recording(caption, words, patches, frame, prefix, *a, **k):
        seen.update(words=np.stack(words), patches=patches, frame=frame)
        return render(caption, words, patches, frame, prefix, *a, **k)

    return patched(heatmap, "render_caption_heatmaps", recording)


def check_heatmaps(tag, lines, prefix):
    """The CLI printed one PNG a heuristic noun of VIZ_CAPTION, each
    448 × 274 RGB by the port's own reader."""
    from oatx_torch.visualization.heatmap import is_probable_noun
    from oatx_torch.visualization.png import read_png

    want = [f"{prefix}_token_{i}.png" for i, w in enumerate(VIZ_CAPTION.split(" "))
            if is_probable_noun(w)]
    if lines[-len(want):] != want or len(want) < 3:
        raise AssertionError(f"viz {tag}: printed {lines[-len(want):]}, expected {want}")
    shapes = {read_png(p).shape for p in want}
    if shapes != {(274, 448, 3)}:
        raise AssertionError(f"viz {tag}: PNG shapes {shapes}")
    return len(want)


def viz_profile(model, video, tmp):
    """(d): the 1-frame forward under profiler.trace, an untimed forward
    first and then one under annotate("viz_tower"), both padded like
    cuda_trace; summarize_trace must name kernels 1 and 2, and
    summarize_by_source, read over the trace's kernel 1 and 2 device kernels
    alone, must put the annotated forward's half of them under viz_tower
    and the other forward's under "?". A trace that lost kernel records is
    taken again (TRACE_ATTEMPTS)."""
    from oatx_torch.utils import profiler

    keys = ("ln_mlp_", "space_attention_kernel")  # kernel 1's device kernels and kernel 2's
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        d = os.path.join(tmp, f"trace{attempt}")
        with torch.no_grad(), profiler.trace(d):
            trace_pad()
            model.compute_video(video)
            with profiler.annotate("viz_tower"):
                model.compute_video(video)
            torch.cuda.synchronize()
            trace_pad()
        with open(os.path.join(d, "trace.0.json")) as f:
            events = json.load(f)["traceEvents"]
        kern = [e for e in events if e.get("cat") == "kernel"]
        # one up-projection kernel a launch of kernel 1, one kernel a launch of kernel 2
        held = {k: sum(k in e["name"] for e in kern)
                for k in ("ln_mlp_up_kernel", "space_attention_kernel")}
        if all(n == 24 for n in held.values()):
            break
        print(f"viz (d): trace attempt {attempt} holds {held} of 24 each", file=sys.stderr,
              flush=True)
    else:
        raise AssertionError("viz (d): every trace lost kernel records")
    names = [r["name"] for r in profiler.summarize_trace(d, top=10 ** 6)]
    if not all(any(k in n for n in names) for k in keys):
        raise AssertionError(f"viz (d): summarize_trace names no {keys}: {names[:20]}")
    only = os.path.join(tmp, "trace_kernels")
    os.makedirs(only)
    with open(os.path.join(only, "trace.json"), "w") as f:
        json.dump({"traceEvents": [e for e in events if e.get("cat") not in (
            "kernel", "gpu_memcpy", "gpu_memset") or any(k in e["name"] for k in keys)]}, f)
    by_source = {r["source"]: r for r in profiler.summarize_by_source(only)}
    ops = {s: r["ops_per_step"] for s, r in by_source.items()}
    half = sum(any(k in e["name"] for k in keys) for e in kern) // 2
    if ops != {"viz_tower": half, "?": half}:
        raise AssertionError(f"viz (d): kernels 1 and 2 by source {ops}, {half} each expected")
    return {"trace_attempts": attempt, "summarize_trace_top5": [
        {k: r[k] for k in ("name", "total_ms")} for r in profiler.summarize_trace(d, top=5)],
        "by_source_kernels_1_2": {s: r["ms_per_step"] for s, r in by_source.items()},
        "by_source_all": profiler.summarize_by_source(d, top=4)}


def viz_tower(tmp, clip, smi, dev, out):
    """(a): cli.visualize --backbone tower on zsl/normal.json from a port
    snapshot of its seed-0 towers (-r), counted; → (launches, the two
    snapshots)."""
    from oatx_torch.cli import visualize as cli
    from oatx_torch.config.parser import load_experiment
    from oatx_torch.config.schema import build_tower_config, precision_dtype
    from oatx_torch.models.towers import DualTower
    from oatx_torch.utils import profiler

    with open(CONFIG) as f:
        raw = json.load(f)
    run = os.path.join(tmp, "run")
    os.makedirs(run)
    with open(os.path.join(run, "config.json"), "w") as f:  # -r reads its parent's config
        json.dump(raw, f)
    exp = load_experiment(["-c", CONFIG], test=True)
    cfg = build_tower_config(exp.cfg.arch,
                             compute_dtype=precision_dtype(exp.cfg.trainer.precision))
    snaps = []
    for seed in (0, 1):  # seed 1: the second snapshot of (e)
        model = DualTower(cfg, dev, torch.Generator(dev).manual_seed(seed))
        snaps.append(os.path.join(run, f"seed{seed}"))
        os.makedirs(snaps[-1])
        torch.save({"model": {k: v.cpu() for k, v in model.state_dict().items()},
                    "optimizer": {}, "step": 0}, os.path.join(snaps[-1], "state.pt"))
        del model
    seen, stash = {}, {}
    compute = DualTower.compute_video

    def stashing(self, video):
        stash.update(model=self, video=video)
        return compute(self, video)

    prefix = os.path.join(tmp, "tower")
    launches = {}
    t0 = time.perf_counter()
    with rendered(seen), patched(DualTower, "compute_video", stashing), \
            counted(launches):  # ---- the main path, counted ----
        lines = run_cli(cli, ["-c", CONFIG, "-r", snaps[0], "--video", clip, "--caption",
                              VIZ_CAPTION, "--out", prefix, "--device", str(dev)])
    out["tower_cli_s"] = time.perf_counter() - t0
    check_launches("viz tower", launches, VIZ_TOWER)
    out["tower_pngs"] = check_heatmaps("tower", lines, prefix)
    model, video = stash["model"], stash["video"]
    with torch.no_grad(), plain_versions():
        plain = model.vid_proj(model.compute_video(video)["patches"][0].float()).cpu().numpy()
    cos = cosines(seen["patches"], plain)
    out["tower_patches"] = list(seen["patches"].shape)
    out["tower_min_cosine"] = float(cos.min())
    if seen["patches"].shape != VIZ_TOWER_PATCHES or cos.min() < VIZ_MIN_COSINE or \
            not np.isfinite(seen["words"]).all():
        raise AssertionError(f"viz tower: patches {seen['patches'].shape}, cosine {cos.min()} "
                             f"against the plain versions (< {VIZ_MIN_COSINE})")
    # the 1-frame forward: host ms by the clock, device busy ms from a trace
    with torch.no_grad():
        fwd = lambda: model.compute_video(video)  # noqa: E731
        fwd()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(VIZ_TIMED_FORWARDS):
            fwd()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / VIZ_TIMED_FORWARDS
        busy, _, groups, _ = device_trace(fwd, VIZ_TIMED_FORWARDS, expect=EXTRACT_EXPECT)
    out.update(forward_host_ms=host, forward_device_busy_ms=busy,
               forward_device_ms_by_group=groups, forward_idle_share=1 - busy / host)
    out["profiler"] = viz_profile(model, video, tmp)
    out["memory_summary"] = profiler.memory_summary()
    if "cuda0_mem_mb" not in out["memory_summary"]:
        raise AssertionError(f"viz (d): memory_summary {out['memory_summary']}")
    stash.clear()
    del model, video
    return launches, snaps


def viz_clip(tmp, clip, smi, dev, out):
    """(b): cli.visualize --backbone clip from a random CLIP ViT-B/16 .pt
    with its text side, on the card (f32) and on the CPU."""
    from oatx_torch.cli import visualize as cli
    from oatx_torch.data.clip_tokenizer import ClipBatchTokenizer, ClipTokenizer
    from oatx_torch.models import clip_text as ct
    from oatx_torch.models import clip_vision as cv
    from oatx_torch.models import convert

    vision = cv.ClipVision(cv.ClipVisionConfig(), dev, torch.Generator(dev).manual_seed(0))
    text = ct.ClipText(ct.ClipTextConfig(), dev, torch.Generator(dev).manual_seed(1))
    ckpt = os.path.join(tmp, "clip_vit_b16.pt")
    torch.save({**convert.clip_vision_to_torch(vision),
                **{k: v.cpu() for k, v in text.state_dict().items()}}, ckpt)
    del vision, text
    os.makedirs(os.path.join(tmp, "bpe"))
    bpe = ClipBatchTokenizer(ClipTokenizer.for_tests([VIZ_CAPTION])).save_vocab(
        os.path.join(tmp, "bpe", "vocab"))
    runs = {}
    for where in (str(dev), "cpu"):
        seen, prefix = {}, os.path.join(tmp, "clip_" + where.split(":")[0])
        t0 = time.perf_counter()
        with rendered(seen):
            lines = run_cli(cli, ["--backbone", "clip", "--clip-ckpt", ckpt, "--bpe-vocab", bpe,
                                  "--video", clip, "--caption", VIZ_CAPTION,
                                  "--out", prefix, "--device", where])
        out[f"clip_cli_s_{where.split(':')[0]}"] = time.perf_counter() - t0
        out["clip_pngs"] = check_heatmaps(f"clip on {where}", lines, prefix)
        runs[where] = seen
    got, want = runs[str(dev)], runs["cpu"]
    errs = {k: float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
            for k in ("patches", "words")}
    out["clip_patches"] = list(got["patches"].shape)
    out["clip_rel_err_vs_cpu"] = errs
    if got["patches"].shape != VIZ_CLIP_PATCHES or not np.isfinite(got["patches"]).all() or \
            max(errs.values()) > VIZ_CLIP_TOL:
        raise AssertionError(f"viz clip: patches {got['patches'].shape}, the card against "
                             f"the CPU {errs} (> {VIZ_CLIP_TOL} of scale)")


def viz_region(tmp, smi, dev, out):
    """(c): cli.test on region_mem.json as shipped over WebVid-layout clips,
    their stub object files and the phase-8 bank, with RetrievalVis,
    counted; → launches."""
    from concurrent.futures import ThreadPoolExecutor

    from oatx_torch.cli import build_region_memory
    from oatx_torch.cli import test as cli
    from oatx_torch.data import video_reader as vr
    from oatx_torch.eval import retrieval_eval as R
    from oatx_torch.visualization.png import read_png

    n = VIZ_REGION_CLIPS
    web = os.path.join(tmp, "webvid")
    os.makedirs(os.path.join(web, "test"))
    os.makedirs(os.path.join(web, "meta_data"))
    vids = [str(5000 + i) for i in range(n)]
    caps = [data_caption("r", 5000 + i) for i in range(n)]
    with open(os.path.join(web, "meta_data", "webvid_validation_success_full.tsv"), "w") as f:
        f.write("caption\tvideoid\n" + "".join(f"{c}\t{v}\n" for c, v in zip(caps, vids)))
    w, h, nf = VIZ_REGION_CLIP
    items = [(v, os.path.join(web, "test", v + ".mp4")) for v in vids]
    with ThreadPoolExecutor(8) as pool:
        for fut in [pool.submit(vr.write_test_video, p, w, h, nf, 8, 5000 + i)
                    for i, (_, p) in enumerate(items)]:
            fut.result()
    lst = os.path.join(tmp, "region_items.tsv")
    with open(lst, "w") as f:
        f.write("".join(f"{v}\t{p}\n" for v, p in items))
    objects = os.path.join(web, "8_frame_object")
    extract_stats(["--list", lst, "--out", os.path.join(objects, "test")],
                  {"processed": n, "skipped": 0, "failed": 0, "frames": n * EXTRACT_SLOTS})
    vocab, npy = os.path.join(tmp, "objects_vocab.txt"), os.path.join(tmp, "region_memory.npy")
    with open(vocab, "w") as f:
        f.write("".join(f"obj{i}\n" for i in range(REGION_CLASSES)))
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        rc = build_region_memory.main(["--vocab", vocab, "--out", npy, "--backend", "clip"])
    if rc != 0 or np.load(npy).shape != (REGION_CLASSES, 512):
        raise AssertionError(f"viz region: the bank builder returned {rc}: {said.getvalue()}")
    with open(OBJECT_CONFIGS["region_mem"]) as f:
        raw = json.load(f)
    dl = raw["data_loader"][0]["args"]
    dl.update(data_dir=web, object_dir=objects, num_workers=4)
    dl["object_params"]["region_memory_path"] = npy
    raw["trainer"].update(save_dir=os.path.join(tmp, "exps"), verbosity=1)
    raw["visualizer"] = {"type": "RetrievalVis"}
    cfg = os.path.join(tmp, "region_mem_vis.json")
    with open(cfg, "w") as f:
        json.dump(raw, f)
    batch = dl["batch_size"]
    stash, logits = {}, {"kernels": [], "plain": []}
    export = R.export_region_maps

    @contextlib.contextmanager
    def capturing(model, into):
        fwd = model.forward_region_mem

        def capture(b):
            res = fwd(b)
            into.append(res["region_sim_logits"].float().cpu().numpy())
            return res

        model.forward_region_mem = capture
        try:
            yield
        finally:
            del model.forward_region_mem

    def exporting(model, tower_cfg, loader, out_dir, *a, **k):
        stash.update(model=model, cfg=tower_cfg, loader=loader)
        with capturing(model, logits["kernels"]):
            return export(model, tower_cfg, loader, out_dir, *a, **k)

    evaluate = R.evaluate

    def evaluating(*a, **k):
        stash["result"] = r = evaluate(*a, **k)
        return r

    launches = {}
    t0 = time.perf_counter()
    with patched(R, "export_region_maps", exporting), patched(R, "evaluate", evaluating), \
            counted(launches):  # -- main path --
        run_cli(cli, ["-c", cfg, "--no_timestamp", "--device", str(dev)])
    out["region_cli_s"] = time.perf_counter() - t0
    viz_tsne(stash.pop("result"), tmp, out)
    # evaluate: batches padded to `batch`, chunks of 8; the export: one
    # forward a batch; each forward runs the clip and the object frame
    batches = -(-n // batch)
    check_launches("viz region", launches, want_launches(
        12, 0, False, forwards=batches * -(-batch // 8) + batches, backward_depths=(12, 12)))
    web_dir = os.path.join(tmp, "exps", "web", raw["name"])
    maps = sorted(os.listdir(os.path.join(web_dir, "region_maps")))
    want = sorted(f"{i}_predict.png" for i in range(min(VIZ_MAPS_LIMIT, n)))
    shapes = {read_png(os.path.join(web_dir, "region_maps", m)).shape for m in maps}
    if maps != want or shapes != {(224, 672, 3)}:
        raise AssertionError(f"viz region: maps {maps} of {shapes}")
    with open(os.path.join(web_dir, "index.html")) as f:
        page = f.read()
    queries = page.split('<div class="query">')[1:]
    if len(queries) != n or any(q.count('<div class="meta">#') != 5 for q in queries) or \
            any(f'<div class="caption">{c}</div>' not in page for c in caps):
        raise AssertionError(f"viz region: index.html holds {len(queries)} queries")
    with capturing(stash["model"], logits["plain"]), plain_versions():
        export(stash["model"], stash["cfg"], stash["loader"], os.path.join(tmp, "plain_maps"),
               device=dev)
    got, want = (np.concatenate(logits[k]) for k in ("kernels", "plain"))
    got, want = got.reshape(len(got), -1), want.reshape(len(want), -1)
    cos = cosines(got, want)  # a sample's (K, 196) logits each
    out.update(region_maps=len(maps), gallery_queries=len(queries),
               region_logits_min_cosine=float(cos.min()),
               region_logits_cosine_all=float(cosines(got.reshape(-1), want.reshape(-1))),
               region_launches=launches)
    if cos.min() < VIZ_MIN_COSINE:
        raise AssertionError(f"viz region: region_sim_logits cosine {cos.min()} against the "
                             f"plain versions (< {VIZ_MIN_COSINE})")
    stash.clear()
    return launches


def viz_tsne(result, tmp, out):
    """tsne_embedding_plot of (c)'s eval embeddings, the clips' and the
    captions' (labels 0 and 1), where neither sklearn nor matplotlib need
    be: a 720 × 720 PNG with both labels' colours."""
    from oatx_torch.visualization import plots, tsne
    from oatx_torch.visualization.png import read_png

    emb = np.concatenate([np.asarray(result.video_embeds), np.asarray(result.text_embeds)])
    labels = np.repeat([0, 1], len(result.video_embeds))
    t0 = time.perf_counter()
    img = read_png(plots.tsne_embedding_plot(emb, labels, os.path.join(tmp, "tsne.png")))
    colours = {tuple(c) for c in img.reshape(-1, 3)}
    out["tsne"] = {"points": len(emb), "png": list(img.shape), "s": time.perf_counter() - t0,
                   "sklearn_or_matplotlib_loaded": sorted(
                       m for m in sys.modules if m.split(".")[0] in ("sklearn", "matplotlib"))}
    if img.shape != (tsne.SIZE, tsne.SIZE, 3) or \
            not {tuple(c) for c in tsne.label_colours(np.array([0, 1]))} <= colours:
        raise AssertionError(f"viz t-SNE: {out['tsne']}")


def viz_average(tmp, snaps, dev, out):
    """(e): cli.average_checkpoints of (a)'s two snapshots reloads to
    exactly their f64 mean cast to f32, through import_initial_weights."""
    from oatx_torch.cli import average_checkpoints as cli
    from oatx_torch.train import checkpoint as ckptlib

    soup = os.path.join(tmp, "soup")
    line = json.loads(run_cli(cli, [*snaps, "--out", soup, "--device", str(dev)])[-1])
    a, b = (torch.load(os.path.join(p, ckptlib.STATE_FILE), weights_only=True)["model"]
            for p in snaps)
    got = torch.load(os.path.join(soup, ckptlib.STATE_FILE), weights_only=True)["model"]
    bad = [k for k in a if not torch.equal(got[k], ((a[k].double() + b[k].double()) / 2)
                                           .to(a[k].dtype))]
    if bad or sorted(got) != sorted(a) or line["averaged"] != 2 or \
            line["param_tensors"] != len(a):
        raise AssertionError(f"viz average: {line}, {len(bad)} tensors off the mean: {bad[:3]}")
    out["average"] = line


def viz_phase(smi, dev):
    """Visualization and region maps (module docstring, phase 15) → the
    launches of (a) and (c)."""
    from oatx_torch.data import video_reader as vr

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "clip.avi")  # one MJPEG clip of the port's writer
        vr.write_test_video(clip, 320, 240, 16, 8, 7)
        tower, snaps = viz_tower(tmp, clip, smi, dev, out)
        viz_clip(tmp, clip, smi, dev, out)
        region = viz_region(tmp, smi, dev, out)
        viz_average(tmp, snaps, dev, out)
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"viz ({smi}): " + json.dumps(out), flush=True)
    return {k: tower[k] + region[k] for k in tower}


# ------------------------------------------------------------------- optim
# phase 16: the optimizer families (train/optim.py) on norm.json and ViT-H,
# and the fixed-gradient Adafactor check that phases 11 and 12 run on ranks
OPTIM_FAMILIES = ("Adafactor", "Lion", "SGD")  # each at norm.json's lr 2e-4
OPTIM_CLIPS = 16          # one batch of norm.json's 16: every step reads the same clips
# 9 steps; a snapshot after epoch 1, resumed. The recipe's first update at
# random init lifts the loss (AdamW too: phases 5 and 11), and it falls below
# the first two steps' mean from step 6 or so
OPTIM_EPOCHS, OPTIM_LEN_EPOCH = 3, 3
OPTIM_HUGE_STEPS = 4      # vit_huge_pod under Adafactor: one epoch, no validation
OPTIM_FIXED_STEPS = 2     # Adafactor steps on fixed gradients (optim_fixed)
OPTIM_FIXED_RTOL = 1e-5   # ranks against one process there: f32, of each tensor's largest
OPTIM_PURPOSES = ("factor_sums", "factor_split", "factor_mean", "block_rms")
OPTIM_UPDATE_REPS = 5     # timed optimizer steps alone (update_ms)


def with_optimizer(exp, kind, lr=None):
    """exp with optimizer.type `kind` (and optimizer.args.lr `lr`, if
    given)."""
    from oatx_torch.config.schema import ExperimentCfg

    raw = json.loads(json.dumps(exp.raw))
    raw["optimizer"]["type"] = kind
    if lr is not None:
        raw["optimizer"].setdefault("args", {})["lr"] = lr
    return ExperimentCfg.from_dict(raw)


def norm_shapes():
    """norm.json's parameter shapes, whole (a meta-device DualTower)."""
    from oatx_torch.config.schema import build_tower_config
    from oatx_torch.models.towers import DualTower

    cfg = build_tower_config(recipe(NORM_CONFIG).arch)
    with torch.device("meta"):
        model = DualTower(cfg, device="meta", generator=torch.Generator())
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def optim_traffic(shapes, layout, mode):
    """Adafactor's bytes a step a rank hands to collectives, by purpose,
    derived from the factoring rule (sharding.factoring) and the layout:
    'factor_sums' the row and column sums of g² of an fsdp share (zero1's
    come from the whole gradient every rank holds); 'factor_split' under a model axis the sums over a
    split dim; 'factor_mean' v_row's sums over a split d1; 'block_rms' one
    f32 a leaf for each group of ranks holding parts of it (its data-axis
    shares, its model-axis parts)."""
    from oatx_torch.parallel import sharding
    from oatx_torch.train import optim

    depths = sharding._depths(shapes)
    mp = layout.split_size
    data = sharding.plan(shapes, layout, mode) if mode else {}
    out = dict.fromkeys(OPTIM_PURPOSES, 0)
    data_leaves, split_leaves = set(), set()
    for n, s in shapes.items():
        split = sharding._model_split(n, s, depths, mp)
        if n in data:
            data_leaves.add(optim._leaf_key(n))
        if split is not None:
            split_leaves.add(optim._leaf_key(n))
        f = sharding.factoring(n, s, depths)
        if f is None:
            continue
        k = None if split is None else f.perm.index(split[0])
        rows = math.prod(f.row_shape) // (mp if k not in (None, f.d0) else 1)
        cols = math.prod(f.col_shape) // (mp if k not in (None, f.d1) else 1)
        if n in data and mode == "fsdp":  # zero1's sums come from the whole gradient
            out["factor_sums"] += 4 * (rows + cols)
        out["factor_split"] += 4 * (rows if k == f.d0 else cols if k == f.d1 else 0)
        if k == f.d1:
            out["factor_mean"] += 4 * (rows // (f.dims[f.d1] // mp))
    out["block_rms"] = 4 * (len(data_leaves) + len(split_leaves))
    return out


def optim_fixed(dev, mode=None, mp=1, keep=True, kind="adafactor"):
    """norm.json's towers (seed 0), placed by `mode` and a model axis of
    `mp` on this process's layout, under family `kind` as norm.json sets it
    (lr 2e-4, weight decay 0.01), OPTIM_FIXED_STEPS steps on fixed
    gradients: each parameter's whole gradient drawn on the card from a
    seed of its own, the same on every rank and in one process, this rank's
    part set as its .grad; no forward, so the steps differ only in the
    optimizer's arithmetic and its collectives → (record: the optimizer's
    traffic a step, held and predicted state bytes, the update's peak (MiB
    a step allocates above what the rank held as it began, the most of the
    steps); the whole parameters and optimizer state on the host where
    `keep`, else None)."""
    from oatx_torch.config.schema import build_tower_config, precision_dtype
    from oatx_torch.parallel import collectives as coll
    from oatx_torch.parallel import mesh as meshlib
    from oatx_torch.parallel import sharding
    from oatx_torch.train import optim
    from oatx_torch.train import step as steplib

    exp = recipe(NORM_CONFIG)
    cfg = build_tower_config(exp.arch, compute_dtype=precision_dtype(exp.trainer.precision))
    layout = meshlib.current_layout(1, mp)
    state = steplib.init_state(
        cfg, optim.make_optimizer(lr=exp.optimizer.lr, weight_decay=exp.optimizer.weight_decay,
                                  kind=kind),
        device=dev, generator=torch.Generator(dev).manual_seed(0), shard_mode=mode,
        layout=layout)
    model, opt = state.model, state.optimizer
    whole = {n: tuple((getattr(p, "_oatx_tp", None) or getattr(p, "_oatx_shard", None)
                       or p).shape) for n, p in model.named_parameters()}
    coll.reset_traffic()
    peak = 0
    for step in range(OPTIM_FIXED_STEPS):
        for i, (n, p) in enumerate(model.named_parameters()):
            g = torch.randn(whole[n], device=dev,
                            generator=torch.Generator(dev).manual_seed(1 + 1000 * step + i))
            p.grad = sharding.held_part(g, p).contiguous()
        del g
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        opt.step()
        torch.cuda.synchronize()
        peak = max(peak, torch.cuda.max_memory_allocated(dev) - before)
    traffic = {k: coll.TRAFFIC[k]["bytes"] / OPTIM_FIXED_STEPS for k in OPTIM_PURPOSES
               if k in coll.TRAFFIC}
    rec = {"mode": mode or "replicated", "model_parallel": mp, "kind": kind,
           "traffic_per_step": traffic, "update_peak_mib": peak / 2 ** 20,
           "held_bytes": sharding.held_bytes(model, opt)["total"],
           "predicted_bytes": sharding.state_bytes(
               whole, layout.data_size, mode if layout.spans_processes else None,
               model_parallel=layout.model_parallel, kind=kind)["bytes"]}
    params = sharding.full_state_dict(model, to_host=True, keep=keep)
    named = opt.named_state(to_host=True, keep=keep)
    del state, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return rec, params, named


def optim_fixed_check(tag, path, ref, rec, layout, mode):
    """The whole parameters and Adafactor state a rank group saved at `path`
    (optim_fixed's, rank 0's) against one process's (`ref`): every tensor
    within OPTIM_FIXED_RTOL of its largest entry; the ranks' held bytes
    exactly state_bytes; the optimizer's traffic a step exactly
    optim_traffic's → the reading, or AssertionError."""
    got_params, got_opt = torch.load(path)
    want_params, want_opt = ref
    worst, used = None, 0.0
    pairs = [("params", got_params, want_params)] + [
        (k, got_opt[k], want_opt[k]) for k in ("v_row", "v_col", "v")]
    for what, got, want in pairs:
        if sorted(got) != sorted(want):
            raise AssertionError(f"{tag}: {what} names differ")
        for n, w in want.items():
            err = float((got[n] - w).abs().max())
            u = err / (OPTIM_FIXED_RTOL * max(float(w.abs().max()), 1e-30))
            if u > used:
                used, worst = u, (what, n, err)
    want_traffic = optim_traffic(norm_shapes(), layout, mode)
    got_traffic = {k: rec[0]["traffic_per_step"].get(k, 0) for k in OPTIM_PURPOSES}
    out = {"tol_used": used, "worst": worst, "held_bytes": [r["held_bytes"] for r in rec],
           "predicted_bytes": rec[0]["predicted_bytes"], "traffic_per_step": got_traffic,
           "traffic_derived": want_traffic, "count": got_opt["count"]}
    if used > 1 or any(r["held_bytes"] != r["predicted_bytes"] for r in rec) \
            or any({k: r["traffic_per_step"].get(k, 0) for k in OPTIM_PURPOSES}
                   != want_traffic for r in rec) or got_opt["count"] != OPTIM_FIXED_STEPS:
        raise AssertionError(f"{tag}: Adafactor on fixed gradients against one process: "
                             f"{out}")
    return out


def update_ms(opt, reps=OPTIM_UPDATE_REPS):
    """`opt.step()` on the gradients its parameters hold, `reps` times after
    one warm-up: the median ms between CUDA events around each call (the
    device's view, host gaps included) and of the call's return on the host
    (no sync inside)."""
    opt.step()
    torch.cuda.synchronize()
    dev_ms, host_ms = [], []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        opt.step()
        b.record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        dev_ms.append(a.elapsed_time(b))
    return {"ms": float(np.median(dev_ms)), "host_ms": float(np.median(host_ms)),
            "reps": reps}


def family_grads(tag, model, loss_cfg, fixed):
    """One step's gradients of `model` on `fixed` through the kernels
    against the plain versions (bf16 both), held to phase 5's grad_check
    bars → grad_check's keys. The plain gradients stay on the
    parameters."""
    from oatx_torch.train import step as steplib

    def grads():
        model.zero_grad(set_to_none=True)
        loss, _ = steplib.loss_fn(model, loss_cfg, fixed)
        loss.backward()
        return {n: (p.grad.detach().clone() if p.grad is not None else None)
                for n, p in model.named_parameters()}

    got = grads()
    with plain_versions():
        ref = grads()
    missing = [n for n, g in got.items() if g is None or not bool(torch.isfinite(g).all())]
    if missing:
        raise AssertionError(f"{tag}: {len(missing)} parameters without a finite "
                             f"gradient through the kernels, e.g. {missing[:5]}")
    rec = grad_check(got, ref)
    if rec["grad_tol_used"] > 1 or rec["grad_norm_rel_diff"] > GRAD_NORM_RTOL \
            or rec["grad_global_cosine"] < GRAD_MIN_GLOBAL_COSINE:
        raise AssertionError(f"{tag}: gradients through the kernels disagree with the plain "
                             f"versions: {rec}")
    return rec


def optim_family_run(kind, tmp, smi, dev, ds):
    """norm.json at full width and depth under optimizer family `kind`
    through Trainer.train() (module docstring, phase 16) → (record,
    [launches of the run, launches of the resumed run])."""
    from oatx_torch.parallel import sharding
    from oatx_torch.train import step as steplib
    from oatx_torch.train.trainer import Trainer

    exp = with_optimizer(recipe(NORM_CONFIG, epochs=OPTIM_EPOCHS, len_epoch=OPTIM_LEN_EPOCH,
                                save_period=1, verbosity=1, init_val=False), kind)
    batch = exp.data_loaders[0].batch_size
    tag = f"optim {kind} norm@{batch}"

    def loaders():
        return corpus_loaders(ds, batch, with_valid=False)

    train, _ = loaders()
    held0 = fresh_peak(dev)
    t0 = time.perf_counter()
    tr = Trainer(exp, train, [], save_dir=os.path.join(tmp, kind), device=dev)
    build_s = time.perf_counter() - t0
    depth = tr.tower_cfg.video.depth
    shapes = {n: tuple(p.shape) for n, p in tr.state.model.named_parameters()}
    # the weights the family's first step starts from (the seed-0 init)
    start = {n: p.detach().clone() for n, p in tr.state.model.named_parameters()}
    rec = StepRecorder(tr)
    steps = OPTIM_EPOCHS * OPTIM_LEN_EPOCH
    launches = {}
    t0 = time.perf_counter()
    with counted(launches):  # ---- the main path, counted ----
        tr.train()
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check_launches(tag, launches, want_launches(depth, steps, False))
    losses, terms = rec.loss_values(), rec.term_values()
    held = sharding.held_bytes(tr.state.model, tr.state.optimizer)
    want = sharding.state_bytes(shapes, 1, None, kind=kind)
    out = {"optimizer": kind, "lr": exp.optimizer.lr, "weight_decay": exp.optimizer.weight_decay,
           "batch": batch, "clips": len(ds), "losses": losses, "trainer_build_s": build_s,
           "train_wall_s": wall_s, "peak_mem_gib": peak, "mem_held_gib": held0,
           "held_bytes": held, "predicted_bytes": want, "launches": launches,
           **speed(rec.step_ms(OPTIM_LEN_EPOCH), batch, flops_per_clip_step(tr.tower_cfg))}
    if not all(np.isfinite(losses)) or not np.mean(losses[-2:]) < np.mean(losses[:2]):
        raise AssertionError(f"{tag}: loss not finite or not falling: {losses}")
    if held["total"] != want["bytes"]:
        raise AssertionError(f"{tag}: holds {held} bytes, state_bytes gives {want}")
    # the first step's gradients, at the weights before any update, kernels
    # against the plain versions (not counted, no update): past the first
    # update norm.json's loss leaps (6.5 → 16) and its bf16 gradients
    # there are noise in both versions, which grad_check cannot hold
    # (PERF.md, PR 20)
    host = next(iter(train[0]))
    host.pop("meta")
    fixed = steplib.make_augmenter(train=False, tower_cfg=tr.tower_cfg)(
        None, {k: torch.from_numpy(a).to(dev) for k, a in host.items()})
    model = tr.state.model
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(start.pop(n))
    out.update(family_grads(tag, model, tr.loss_cfg, fixed))
    # the update alone on the plain gradients (the weights move on; the
    # resume below starts from the snapshot): this family's and, beside it
    # once, AdamW's over the same parameters
    out["update"] = update_ms(tr.state.optimizer)
    if kind == "Adafactor":
        from oatx_torch.train import optim

        out["adamw_update"] = update_ms(optim.make_optimizer(lr=exp.optimizer.lr)(
            model.named_parameters()))
    model.zero_grad(set_to_none=True)
    del fixed, tr, rec, model
    gc.collect()
    torch.cuda.empty_cache()
    # the epoch-1 snapshot, resumed: the state bitwise, the later epochs' loss
    # terms again, and a trace of 2 of its steps (the loop's idle share)
    expect = [("ln_mlp_", depth), ("space_attention_kernel", depth),
              ("space_attention_bwd_kernel", depth)]
    out["resume"], launches2, trace = resume_epoch2(
        tag, exp, loaders, os.path.join(tmp, kind, "checkpoint-epoch1"), dev, OPTIM_LEN_EPOCH,
        expect, want_launches(depth, steps - OPTIM_LEN_EPOCH, False), terms)
    out.update(trace or {})
    print(f"{tag} ({smi}): " + json.dumps(out), flush=True)
    return out, [launches, launches2]


def optim_huge(smi, dev, adamw):
    """vit_huge_pod.json (ViT-H/14 at 8 as 2 × 4, dots_all, model_parallel
    1) under Adafactor through Trainer.train(), OPTIM_HUGE_STEPS steps: peak
    device memory and step ms beside phase 9's AdamW run of the same recipe
    (`adamw`: its record, None when phase 9 did not run) → (record,
    launches)."""
    from oatx_torch.parallel import sharding
    from oatx_torch.train.trainer import Trainer

    exp = with_optimizer(recipe(WIDE_CONFIGS["vit_huge_pod"], model_parallel=1, epochs=1,
                                len_epoch=OPTIM_HUGE_STEPS, init_val=False, verbosity=1),
                         "Adafactor")
    t = exp.trainer
    batch = exp.data_loaders[0].batch_size
    tag = f"optim Adafactor vit_huge_pod@{batch}"
    ds = MemoryClips(CORPUS_CLIPS, seed=0)
    train, _ = corpus_loaders(ds, batch, with_valid=False)
    held0 = fresh_peak(dev)
    t0 = time.perf_counter()
    tr = Trainer(exp, train, [], device=dev)
    build_s = time.perf_counter() - t0
    v = tr.tower_cfg.video
    shapes = {n: tuple(p.shape) for n, p in tr.state.model.named_parameters()}
    rec = StepRecorder(tr)
    launches = {}
    t0 = time.perf_counter()
    with counted(launches):  # ---- the main path, counted ----
        tr.train()
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check_launches(tag, launches, want_launches(v.depth, OPTIM_HUGE_STEPS, v.remat,
                                                accum_steps=t.accum_steps))
    terms = rec.term_values()
    held = sharding.held_bytes(tr.state.model, tr.state.optimizer)
    want = sharding.state_bytes(shapes, 1, None, kind="adafactor")
    adamw_want = sharding.state_bytes(shapes, 1, None, kind="adamw")
    out = {"recipe": "vit_huge_pod.json", "optimizer": "Adafactor", "batch": batch,
           "accum_steps": t.accum_steps, "remat": v.remat_policy if v.remat else "off",
           "steps": OPTIM_HUGE_STEPS, "terms": terms, "trainer_build_s": build_s,
           "train_wall_s": wall_s, "peak_mem_gib": peak, "mem_held_gib": held0,
           "held_bytes": held, "predicted_bytes": want,
           "adamw_predicted_bytes": adamw_want, "launches": launches,
           **speed(rec.step_ms(OPTIM_HUGE_STEPS), batch, flops_per_clip_step(tr.tower_cfg)),
           "adamw": ({k: adamw[k] for k in ("peak_mem_gib", "step_ms", "step_ms_spread",
                                             "steps", "mem_held_gib")}
                     if adamw else "not measured in this run (phase 9 did not run)")}
    del tr, rec
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{tag} ({smi}): " + json.dumps(out), flush=True)
    if not all(np.isfinite(x) for vals in terms.values() for x in vals):
        raise AssertionError(f"{tag}: loss terms not finite: {terms}")
    if held["total"] != want["bytes"]:
        raise AssertionError(f"{tag}: holds {held} bytes, state_bytes gives {want}")
    return out, launches


def optim_phase(smi, dev, adamw_huge=None):
    """The optimizer families (module docstring, phase 16) → launches of
    its main paths."""
    t0 = time.perf_counter()
    ds = MemoryClips(OPTIM_CLIPS, seed=0)
    runs, launches = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for kind in OPTIM_FAMILIES:
            runs[kind], more = optim_family_run(kind, tmp, smi, dev, ds)
            launches += more
            lap(f"16 optim: {kind}")
    huge, more = optim_huge(smi, dev, adamw_huge)
    launches.append(more)
    lap("16 optim: vit_huge_pod")
    print(f"optim summary ({smi}): " + json.dumps({
        **{kind: {k: r.get(k) for k in ("losses", "step_ms", "idle_share", "peak_mem_gib",
                                         "grad_tol_used", "grad_global_cosine", "update",
                                         "adamw_update")}
           | {"held_bytes": r["held_bytes"]["total"], "resume_max_rel_diff":
              r["resume"]["max_rel_diff"]}
           for kind, r in runs.items()},
        "vit_huge_pod": {"adafactor": {k: huge[k] for k in ("peak_mem_gib", "step_ms",
                                                              "step_ms_spread")},
                         "adamw": huge["adamw"],
                         "state_bytes": {"adafactor": huge["predicted_bytes"]["bytes"],
                                         "adamw": huge["adamw_predicted_bytes"]["bytes"]}}})
        + f", phase {time.perf_counter() - t0:.1f} s", flush=True)
    return {name: sum(l[name] for l in launches) for name in launches[0]}


# ---------------------------------------------------------------- finetune
# phase 17: configs/ft/msrvtt/fine_tune/normal_1_cl.json as shipped, from a
# port snapshot of norm.json, then its own snapshot served
FT_CONFIG = os.path.join(HERE, "configs", "ft", "msrvtt", "fine_tune", "normal_1_cl.json")
FT_TRAIN_CLIPS = 128      # MSR-VTT jsfusion train clips: 2 batches of the recipe's 64
FT_TEST_CLIPS = DATA_MSRVTT
FT_FRAMES = 8             # frames a written clip holds (the adapter samples 4)
FT_STEPS = 4              # trainer.len_epoch of the 1 epoch (the loader cycles): step 2
                          # timed, steps 3-4 traced


def ft_seed0_snapshot(tmp, dev):
    """A seed-0 norm.json state written by save_checkpoint under `tmp` → its
    path (phase 17's initial weights when phase 5 did not run)."""
    from oatx_torch.config.schema import ExperimentCfg, build_tower_config, precision_dtype
    from oatx_torch.train import checkpoint as ckptlib
    from oatx_torch.train import optim as optimlib
    from oatx_torch.train import step as steplib

    exp = ExperimentCfg.from_json(NORM_CONFIG)
    cfg = build_tower_config(exp.arch, compute_dtype=precision_dtype(exp.trainer.precision))
    state = steplib.init_state(cfg, optimlib.make_optimizer(lr=exp.optimizer.lr),
                               device=dev, generator=torch.Generator(dev).manual_seed(0))
    return str(ckptlib.save_checkpoint(tmp, "norm_seed0", state, 0, float("inf")))


def ft_serve(cfg, snap, ds):
    """cli.serve's service on the fine-tuned snapshot (`-r`, as phase 3 builds
    it) on a localhost port: /embed_video of the test clips and /embed_text
    of their captions, counted → (video, text embeddings, launches, video
    forwards, its build seconds)."""
    from oatx_torch.cli.serve import build_service, make_server

    t0 = time.perf_counter()
    svc, tok, index, our = build_service(["-c", cfg, "-r", snap, "--port", "0"])
    build_s = time.perf_counter() - t0
    server = make_server(svc, tok, index, our)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    samples = [ds.get_sample(i) for i in range(len(ds))]
    clips = np.stack([x["video"] for x in samples])
    texts = [x["text"] for x in samples]
    launches = {}
    try:
        svc.tower_calls = {"video": 0, "text": 0}
        with counted(launches):  # ---- the main path, counted ----
            vid = post(url + "/embed_video", {"video_b64": npy_b64(clips)})["embeddings"]
            txt = post(url + "/embed_text", {"texts": texts})["embeddings"]
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)
    dim = len(vid[0])
    return (finite_matrix("finetune /embed_video", vid, (len(ds), dim)),
            finite_matrix("finetune /embed_text", txt, (len(ds), dim)), launches,
            svc.tower_calls["video"], build_s)


def ft_index(cfg, snap, tmp):
    """cli.build_index on the fine-tuned snapshot over the test split,
    counted, keeping evaluate's embeddings (before the index normalizes
    them) → (result, launches, forwards, its JSON line)."""
    from oatx_torch.cli import build_index
    from oatx_torch.eval import retrieval_eval

    seen, launches, buf = {}, {}, io.StringIO()

    def keeping(*a, **k):
        seen["result"] = r = evaluate(*a, **k)
        seen["loader"] = a[2]
        return r

    evaluate = retrieval_eval.evaluate
    with patched(retrieval_eval, "evaluate", keeping), counted(launches), \
            contextlib.redirect_stdout(buf):  # ---- the main path, counted ----
        rc = build_index.main(["-c", cfg, "-r", snap,
                               "--index-out", os.path.join(tmp, "ft_index.npz")])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or line["videos"] != FT_TEST_CLIPS:
        raise AssertionError(f"finetune index: cli.build_index returned {rc}: {line}")
    loader = seen["loader"]
    forwards = -(-len(loader.dataset) // loader.batch_size) * -(-loader.batch_size // 8)
    return seen["result"], launches, forwards, line


def finetune_phase(smi, dev, init=None):
    """MSR-VTT fine-tuning from a port snapshot of norm.json (`init`: phase
    5's checkpoint-epoch1; None: a seed-0 one) through cli.train, then the
    fine-tuned snapshot served by cli.serve and indexed by cli.build_index
    (module docstring, phase 17) → launches."""
    from oatx_torch.cli import train as cli_train
    from oatx_torch.config.schema import ExperimentCfg
    from oatx_torch.data.factory import build_dataset
    from oatx_torch.train import checkpoint as ckptlib

    t_phase = time.perf_counter()
    out = {"config": os.path.relpath(FT_CONFIG, HERE),
           "init": "a seed-0 norm.json snapshot (save_checkpoint)" if init is None
           else "phase 5's norm.json checkpoint-epoch1"}
    with tempfile.TemporaryDirectory() as tmp:
        init = init or ft_seed0_snapshot(tmp, dev)
        snap0 = torch.load(os.path.join(init, ckptlib.STATE_FILE), map_location="cpu",
                           weights_only=True)["model"]
        root = os.path.join(tmp, "msrvtt")
        train_ids = [f"video{7000 + i}" for i in range(FT_TRAIN_CLIPS)]
        test_ids = [f"video{i}" for i in range(FT_TEST_CLIPS)]
        out["write_s"] = run_jobs(msrvtt_layout(root, train_ids, test_ids, FT_FRAMES))
        with open(FT_CONFIG) as f:
            raw = json.load(f)
        dl = raw["data_loader"][0]["args"]
        batch = dl["batch_size"]
        # strict: a file the decoder fails on raises instead of being replaced
        dl.update(data_dir=root)
        dl["video_params"]["loading"] = "strict"
        raw["arch"]["args"]["load_checkpoint"] = init
        raw["trainer"].update(epochs=1, save_period=1, verbosity=1,
                              save_dir=os.path.join(tmp, "exps"), len_epoch=FT_STEPS)
        cfg = os.path.join(tmp, "normal_1_cl.json")
        with open(cfg, "w") as f:
            json.dump(raw, f)

        made, launches, imported = [], {}, {}

        def imported_bitwise(trainer):
            imported["bitwise"] = state_equal(trainer.state.model.state_dict(), snap0)

        held = fresh_peak(dev)
        t0 = time.perf_counter()
        with recorded_trainers(made, FT_STEPS - 1, imported_bitwise), \
                counted(launches):  # ---- the main path, counted ----
            rc = cli_train.main(["-c", cfg, "--no_timestamp"])
        out["train_wall_s"] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        if rc != 0 or len(made) != 1 or "hist" not in made[0]:
            raise AssertionError(f"finetune: cli.train returned {rc}, {len(made)} trainers")
        if not imported.get("bitwise"):
            raise AssertionError(f"finetune: the imported weights differ from {out['init']}")
        tr, rec = made[0]["trainer"], made[0]["rec"]
        depth = tr.tower_cfg.video.depth
        valid = tr.valid_loaders[0]
        check_launches("finetune train", launches, want_launches(
            depth, FT_STEPS, False,
            forwards=eval_forwards(2, len(valid.dataset), valid.batch_size)))  # init_val + 1
        terms = rec.term_values()
        if not all(np.isfinite(v).all() for v in terms.values()):
            raise AssertionError(f"finetune: a loss term is not finite: {terms}")
        final = tr.state.model.state_dict()
        moved = [k for k, v in snap0.items() if v.is_floating_point()
                 and not torch.equal(final[k].detach().cpu(), v)]
        floats = sum(v.is_floating_point() for v in snap0.values())
        if not moved:
            raise AssertionError("finetune: no weight moved in training")
        torch.cuda.synchronize()
        ms = [rec.events[0].elapsed_time(rec.events[1])]  # step 2, before the trace
        save_dir = os.path.join(tmp, "exps", "models", raw["name"])
        snap = os.path.join(save_dir, "checkpoint-epoch1")
        for name in ("vocab.txt", "config.json", "checkpoint-epoch1", "model_best"):
            if not os.path.exists(os.path.join(save_dir, name)):
                raise AssertionError(f"finetune: {name} not written in {save_dir}")
        hist = made[0]["hist"]
        out.update(batch=batch, steps=FT_STEPS, terms=terms, imported_bitwise=True,
                   moved_tensors=f"{len(moved)} of {floats}",
                   val_loss=[tr.init_val_log["val_loss_0"], hist[1]["val_loss_0"]],
                   t2v_R1=[tr.init_val_log["val_0_t2v_R1"], hist[1]["val_0_t2v_R1"]],
                   input_wait=hist[1]["input_wait"], peak_mem_gib=peak, mem_held_gib=held,
                   launches_train=dict(launches),
                   **speed(ms, batch, flops_per_clip_step(tr.tower_cfg)),
                   **(rec.traced() or {}))
        del tr, made, rec, final
        gc.collect()
        torch.cuda.empty_cache()
        lap("17 finetune: cli.train")

        exp = ExperimentCfg.from_json(cfg)
        ds = build_dataset(exp.data_loaders[0], exp.arch.variant, "test", None,
                           seed=exp.trainer.seed)
        vid, txt, l_serve, forwards, build_s = ft_serve(cfg, snap, ds)
        for name, n in l_serve.items():
            want = depth * forwards if name in ("ln_mlp", "space_attention") else 0
            if forwards == 0 or n != want:
                raise AssertionError(f"finetune serve: {name} {n} launches for {forwards} "
                                     f"video forwards, want 12 per forward")
        result, l_index, idx_forwards, line = ft_index(cfg, snap, tmp)
        check_launches("finetune index", l_index, {
            "ln_mlp": depth * idx_forwards, "space_attention": depth * idx_forwards,
            "space_attention_bwd": 0, "ln_linear": 0})
        cos_v, cos_t = cosines(vid, result.video_embeds), cosines(txt, result.text_embeds)
        out.update(serve_build_s=build_s, serve_video_forwards=forwards,
                   launches_serve=l_serve, launches_index=l_index, index=line,
                   served_vs_index_min_cosine={"video": float(cos_v.min()),
                                               "text": float(cos_t.min())})
        if cos_v.min() < E2E_MIN_COSINE or cos_t.min() < E2E_MIN_COSINE:
            raise AssertionError(f"finetune: served embeddings against cli.build_index's: "
                                 f"video {cos_v.min()}, text {cos_t.min()} "
                                 f"(< {E2E_MIN_COSINE})")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"finetune ({smi}): step ms {out['step_ms']:.1f}, clips/s {out['clips_per_s']:.1f}, "
          f"peak {peak:.2f} GiB, idle share {out.get('idle_share', float('nan')):.3f}: "
          + json.dumps(out), flush=True)
    return {k: launches[k] + l_serve[k] + l_index[k] for k in launches}


# ------------------------------------------------------------------ decode
# phase 18: H.264 in mp4 through the reader on the card (host demuxer → the
# port's host decoder → the NV12 → RGB kernel), held against oatx's frames
# stored beside the fixtures (tests/torch_h264/make_fixtures.py, written
# where FFmpeg is): SHA-256 of every frame for all but base / one
H264_DIR = os.path.join(HERE, "tests", "torch_h264")
H264_CLIPS = ("high", "base", "one", "four")   # the NVDEC glue's fixtures
# the host decoder's, held to oatx's digests: CAVLC, then CABAC / B slices
DIGEST_CLIPS = ("cavlc", "cbase", "cfour", "cpcm", "high", "four", "cmed", "ctemp", "cbcavlc",
                "cpcmb", "cidc1", "copen")
DECODE_TRAIN_CLIPS = ("four", "cmed")  # cli.train's WebVid layout, in turn
DECODE_COST_CLIPS = ("cavlc", "high")  # the read rate: CAVLC I / P, CABAC with B
H264_PIX_MEAN, H264_PIX_MAX = 0.05, 4  # tests/test_torch_video_reader.py's bounds (NVDEC)
H264_MEANS_TOL = 0.05    # a frame's per-channel means, for frames whose pixels are not stored
DECODE_TRAIN_IDS = 32    # WebVid train ids (two batches of 16), DECODE_TRAIN_CLIPS in turn
DECODE_VAL_IDS = 4
DECODE_TRAIN_STEPS = 2
DECODE_COST_READS = 32   # read_frames calls (probe + 4 frames) per decode-cost reading
MJPEG_HOST_MS = "5.87-8.19 ms on 1 thread, 0.80-1.22 ms on 8 (PERF.md, the data phase)"


def h264_fixtures():
    sys.path.insert(0, H264_DIR)
    import make_fixtures

    return make_fixtures


def frame_sha(frame):
    return np.frombuffer(hashlib.sha256(np.ascontiguousarray(frame).tobytes()).digest(),
                         np.uint8)


def pixels_close(tag, got, want):
    """mean |Δ| ≤ H264_PIX_MEAN and max ≤ H264_PIX_MAX per channel value."""
    if got.shape != want.shape:
        raise AssertionError(f"{tag}: shape {got.shape}, oatx's {want.shape}")
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    rec = {"mean": float(d.mean()), "max": int(d.max())}
    if rec["mean"] > H264_PIX_MEAN or rec["max"] > H264_PIX_MAX:
        raise AssertionError(f"{tag}: against oatx's frames {rec} (bounds mean "
                             f"{H264_PIX_MEAN}, max {H264_PIX_MAX})")
    return rec


def decode_host_fixtures():
    """Each digest-stored fixture (CAVLC, CABAC, B slices) through the
    reader on the card (host decoder, one nv12_rgb launch a read): at each
    stored short side every frame's SHA-256 and channel means equal oatx's,
    and the 'rand' / 'uniform' samples and indices past the end equal the
    every-frame decode at their clamped indices; base.mp4 / one.mp4 (x264's
    ultrafast Baseline) equal oatx's stored frames. → (the record, the
    verified frames of each clip by short side)."""
    from oatx_torch.data import video_reader as vr
    from oatx_torch.ops.kernels import nv12_rgb

    mf = h264_fixtures()
    out, verified = {}, {}
    for clip in DIGEST_CLIPS:
        path = os.path.join(H264_DIR, clip + ".mp4")
        ref = np.load(os.path.join(H264_DIR, clip + ".npz"))
        rec = {}
        with vr.VideoHandle(path) as hd:
            n = hd.info()[0]
            for ss in mf.SHORT_SIDES[clip]:
                before = nv12_rgb.nv12_to_rgb.launches
                every = hd.decode(list(range(n)), ss)
                if nv12_rgb.nv12_to_rgb.launches != before + 1:
                    raise AssertionError(f"{clip} at {ss}: the read launched nv12_rgb "
                                         f"{nv12_rgb.nv12_to_rgb.launches - before} times")
                bad = [i for i, f in enumerate(every)
                       if not np.array_equal(frame_sha(f), ref[f"s{ss}_sha256"][i])]
                if bad:
                    raise AssertionError(f"{clip} at {ss}: frames {bad} differ from oatx's "
                                         "(SHA-256)")
                if not np.array_equal(every.reshape(n, -1, 3).mean(1), ref[f"s{ss}_means"]):
                    raise AssertionError(f"{clip} at {ss}: channel means differ from oatx's")
                for kind, ix in mf.samples(n).items():
                    if not np.array_equal(hd.decode(ix, ss), every[np.minimum(ix, n - 1)]):
                        raise AssertionError(f"{clip} at {ss}, {kind} {ix}: frames differ from "
                                             "the every-frame decode's")
                rec[f"s{ss}"] = {"frames": n, "sha256_equal": n, "shape": list(every.shape)}
                verified.setdefault(clip, {})[ss] = every
        out[clip] = rec
    for clip in ("base", "one"):
        path = os.path.join(H264_DIR, clip + ".mp4")
        ref = np.load(os.path.join(H264_DIR, clip + ".npz"))
        n = vr.probe(path)[0]
        for ss in mf.SHORT_SIDES[clip]:
            every = vr.decode_indices(path, list(range(n)), ss)
            if not np.array_equal(every[ref[f"s{ss}_idx"]], ref[f"s{ss}_frames"]):
                raise AssertionError(f"{clip} at {ss}: stored frames differ from oatx's")
        out[clip] = {"stored_frames_equal": True}
    return out, verified


def decode_nvdec_fixtures(demux, verified):
    """Where NVDEC opens: each of its fixtures through nvdec.decode (called
    directly; the reader decodes on the host) at each stored short side
    against oatx's frames within the reader test's bounds (base / one: the
    stored frames; high / four: the host decoder's, equal to oatx's
    digests, `verified`), every frame's channel means within
    H264_MEANS_TOL; NVDEC's coded size against the demuxer's. Unverified
    glue (data/nvdec.py)."""
    from oatx_torch.data import nvdec
    from oatx_torch.data import video_reader as vr

    mf = h264_fixtures()
    out = {}
    for clip in H264_CLIPS:
        path = os.path.join(H264_DIR, clip + ".mp4")
        ref = np.load(os.path.join(H264_DIR, clip + ".npz"))
        n, _, w, h = demux[clip]["probe"]
        rec = {}
        with vr.VideoHandle(path) as hd:
            for ss in mf.SHORT_SIDES[clip]:
                every = nvdec.decode(hd, list(range(n)), ss)
                d_means = float(np.abs(every.reshape(n, -1, 3).mean(1)
                                       - ref[f"s{ss}_means"]).max())
                if d_means > H264_MEANS_TOL:
                    raise AssertionError(f"{clip} at {ss}: a frame's channel mean is "
                                         f"{d_means} off oatx's")
                if clip in verified:
                    idx, want = np.arange(n), verified[clip][ss]
                else:
                    idx, want = ref[f"s{ss}_idx"], ref[f"s{ss}_frames"]
                rec[f"s{ss}"] = {"every_frame": pixels_close(f"{clip} at {ss}", every[idx],
                                                             want),
                                 "means_max_diff": d_means}
            fmt = hd.nvdec_decoder(torch.cuda.current_device()).format()
            cw, ch, full_range, _ = hd.h264_info()
        if (fmt["coded_width"], fmt["coded_height"]) != (cw, ch) or \
                (fmt["right"] - fmt["left"], fmt["bottom"] - fmt["top"]) != (w, h):
            raise AssertionError(f"{clip}: NVDEC's sequence header {fmt}, the demuxer's "
                                 f"coded {cw}x{ch}, display {w}x{h}")
        rec["nvdec_format"] = fmt
        out[clip] = rec
    return out


def decode_kernel(smi):
    """The NV12 → RGB kernel against its plain version on the host
    decoder's NV12 pictures of CABAC and CAVLC fixtures, with its ms, the
    plain version's and the bound. The record's shape is the main path's:
    four.mp4's 4 frames to the canonical short side 256, as cli.train
    reads them."""
    from oatx_torch.data import h264
    from oatx_torch.data import video_reader as vr
    from oatx_torch.ops.kernels import nv12_rgb

    shapes = {}
    record = None
    for clip, sides in (("four", (256,)), ("cmed", (0, 224, 256)), ("cavlc", (0, 224)),
                        ("cbase", (0, 224))):
        path = os.path.join(H264_DIR, clip + ".mp4")
        with vr.VideoHandle(path) as hd:
            n, _, w, h = hd.info()
            full_range = hd.h264_info()[2]
            host = np.empty((n, h * 3 // 2, w), np.uint8)
            h264.decode_nv12(hd, list(range(n)), host)
            nv12 = torch.from_numpy(host).cuda()
            for ss in sides:
                ow, oh = hd.out_size(ss)
                got = nv12_rgb.nv12_to_rgb(nv12, ow, oh, full_range)
                want = nv12_rgb.nv12_to_rgb_plain(nv12, ow, oh, full_range)
                err = int((got.int() - want.int()).abs().max())
                if err:
                    bad = (got != want).any(-1).nonzero()
                    raise AssertionError(f"nv12_rgb at {clip} {ss}: {err} off the plain version "
                                         f"at {bad.shape[0]} pixels, first {bad[:4].tolist()}")
                ms = time_ms(lambda: nv12_rgb.nv12_to_rgb(nv12, ow, oh, full_range), iters=50)
                plain_ms = time_ms(lambda: nv12_rgb.nv12_to_rgb_plain(nv12, ow, oh, full_range),
                                   iters=5, warmup=1)
                b_ms, b_by = bound_ms(nv12.numel() + got.numel(), 0)
                key = f"{n}x{w}x{h}->{ow}x{oh}"
                shapes[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                               "max_abs_err": err, "bytes": nv12.numel() + got.numel()}
                if record is None:
                    record = {"name": "nv12_rgb", "route": "cuda",
                              "source": "oatx_torch/csrc/nvdec.cu",
                              "replaces": "none: a port-only kernel (oatx converts on the host, "
                                          "oatx/native/oatx_decode.cpp:130 sws_scale)",
                              "shape": key, "max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                              "library_ms": None}
    record["by_shape"] = shapes
    record["surfaces"] = "the host decoder's NV12 pictures of CABAC and CAVLC fixtures"
    print(f"decode kernel nv12_rgb ({smi}): " + json.dumps(record), flush=True)
    return record


def decode_demuxer():
    """The host demuxer on this machine: each fixture's probe against
    oatx's stored one, and the plan of every frame (segments, packets)."""
    from oatx_torch.data import video_reader as vr

    out = {}
    for clip in dict.fromkeys(H264_CLIPS + DIGEST_CLIPS):
        path = os.path.join(H264_DIR, clip + ".mp4")
        want = np.load(os.path.join(H264_DIR, clip + ".npz"))["probe"]
        n, fps, w, h = probe = vr.probe(path)
        if (n, w, h) != tuple(int(v) for v in want[[0, 2, 3]]) or abs(fps - want[1]) > 1e-9:
            raise AssertionError(f"{clip}: probe {probe}, oatx's {tuple(want)}")
        with vr.VideoHandle(path) as hd:
            plan = hd.h264_plan(list(range(n)))
            out[clip] = {"probe": probe, "coded": hd.h264_info()[:2],
                         "segments": len(plan.seg_end), "packets": len(plan.pkt_end),
                         "annexb_bytes": len(plan.data)}
    return out


def decode_nvdec_refused(refused):
    """Where the container withholds NVDEC: its decode, called directly,
    raises UnsupportedMedia with the observed refusal for every one of its
    fixtures (the reader does not go there)."""
    from oatx_torch.data import nvdec
    from oatx_torch.data import video_reader as vr

    for clip in H264_CLIPS:
        with vr.VideoHandle(os.path.join(H264_DIR, clip + ".mp4")) as hd:
            try:
                nvdec.decode(hd, [0], 224)
            except vr.UnsupportedMedia as e:
                if not nvdec.is_observed_refusal(str(e)):
                    raise AssertionError(f"{clip}: UnsupportedMedia without the observed "
                                         f"refusal {nvdec.OBSERVED_REFUSAL}: {e}")
            else:
                raise AssertionError(f"{clip}: NVDEC decoded although it refused: {refused}")
    return {"nvdec.decode": "UnsupportedMedia for every fixture"}


def decode_train(tmp, smi, dev, verified):
    """cli.train on norm.json's WebVid loader alone for DECODE_TRAIN_STEPS
    steps over a WebVid layout of four.mp4 / cmed.mp4 copies (CABAC, B
    slices); each frame of the first batch's video equal to the canonical
    square of a frame of its clip verified against oatx's SHA-256
    (`verified`, short side 256), in order."""
    from oatx_torch.cli import train as cli_train
    from oatx_torch.data import loader as loader_mod
    from oatx_torch.data.host_transforms import host_canonicalize
    from oatx_torch.ops.kernels import nv12_rgb

    root = os.path.join(tmp, "webvid")
    os.makedirs(os.path.join(root, "meta_data"))
    kind_of = {}
    for split, n, base, tsv in (("train", DECODE_TRAIN_IDS, 1,
                                 "webvid_training_success_full.tsv"),
                                ("val", DECODE_VAL_IDS, 1000,
                                 "webvid_validation_success_full.tsv")):
        os.makedirs(os.path.join(root, split))
        rows = ["caption\tvideoid"]
        for i in range(n):
            vid = str(base + i)
            kind_of[vid] = DECODE_TRAIN_CLIPS[i % len(DECODE_TRAIN_CLIPS)]
            shutil.copy(os.path.join(H264_DIR, kind_of[vid] + ".mp4"),
                        os.path.join(root, split, vid + ".mp4"))
            rows.append(f"{data_caption('h', base + i)}\t{vid}")
        with open(os.path.join(root, "meta_data", tsv), "w") as f:
            f.write("\n".join(rows) + "\n")
    with open(NORM_CONFIG) as f:
        raw = json.load(f)
    raw["data_loader"] = [raw["data_loader"][1]]  # the WebVid loader
    args = raw["data_loader"][0]["args"]
    args.update(data_dir=root, metadata_dir=root)
    args["video_params"]["loading"] = "strict"
    batch = args["batch_size"]
    raw["trainer"].update(epochs=1, save_period=1, verbosity=1,
                          save_dir=os.path.join(tmp, "exps"),
                          max_samples_per_epoch=DECODE_TRAIN_STEPS * batch)
    cfg = os.path.join(tmp, "norm_h264.json")
    with open(cfg, "w") as f:
        json.dump(raw, f)
    first = {}
    collate = loader_mod.Collator.__call__

    def keep_first(self, samples):
        out = collate(self, samples)
        first.setdefault("batch", out)
        return out

    made, launches = [], {}
    loader_mod.Collator.__call__ = keep_first
    nv12_rgb.nv12_to_rgb.launches = 0
    try:
        t0 = time.perf_counter()
        with recorded_trainers(made), counted(launches):  # ---- the main path, counted ----
            rc = cli_train.main(["-c", cfg, "--no_timestamp"])
        wall = time.perf_counter() - t0
    finally:
        loader_mod.Collator.__call__ = collate
    launches["nv12_rgb"] = nv12_rgb.nv12_to_rgb.launches
    if rc != 0 or len(made) != 1 or "hist" not in made[0]:
        raise AssertionError(f"decode train: cli.train returned {rc}, {len(made)} trainers")
    tr, rec = made[0]["trainer"], made[0]["rec"]
    valid = tr.valid_loaders[0]
    want = want_launches(tr.tower_cfg.video.depth, DECODE_TRAIN_STEPS, False,
                         forwards=eval_forwards(2, len(valid.dataset), valid.batch_size))
    check_launches("decode train", {k: v for k, v in launches.items() if k != "nv12_rgb"},
                   want)
    reads = DECODE_TRAIN_STEPS * batch
    if launches["nv12_rgb"] < reads:
        raise AssertionError(f"decode train: {launches['nv12_rgb']} nv12_rgb launches for "
                             f"{reads} training clips read")
    losses = rec.loss_values()
    if len(losses) != DECODE_TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"decode train: losses {losses}")
    got = np.asarray(first["batch"]["video"])
    canon = {c: host_canonicalize(verified[c][256], got.shape[-2]) for c in DECODE_TRAIN_CLIPS}
    picked = []
    for i, meta in enumerate(first["batch"]["meta"]):
        clip = kind_of[os.path.splitext(os.path.basename(meta["paths"]))[0]]
        ks = []
        for t, frame in enumerate(got[i]):
            hit = [k for k, c in enumerate(canon[clip]) if np.array_equal(c, frame)]
            if not hit:
                raise AssertionError(f"decode train: sample {i} frame {t} ({clip}) is no "
                                     "verified frame of its clip")
            ks.append(hit[0])
        if ks != sorted(ks) or (clip == "four" and ks != [0, 1, 2, 3]):
            raise AssertionError(f"decode train: sample {i} ({clip}) holds frames {ks}")
        picked.append([clip, ks])
    out = {"config": "norm.json (WebVid loader)", "batch": batch, "steps": DECODE_TRAIN_STEPS,
           "losses": losses, "first_batch_frames": picked,
           "input_wait": made[0]["hist"][1]["input_wait"], "train_wall_s": wall,
           "launches": launches}
    print(f"decode train ({smi}): " + json.dumps(out), flush=True)
    del tr, made, rec
    gc.collect()
    return out, launches


def decode_cost(smi, tmp, clip):
    """The H.264 read rate of `clip`: ms a clip of read_frames (probe + 4
    'rand' frames at short side 256, the datasets' call) over copies of it
    on 1 and 8 threads, and frames/s per thread of the host decoder alone
    (every frame of the clip to NV12) on 1 and 8 threads."""
    from concurrent.futures import ThreadPoolExecutor

    from oatx_torch.data import h264
    from oatx_torch.data import video_reader as vr

    paths = []
    for i in range(8):
        p = os.path.join(tmp, f"cost_{clip}{i}.mp4")
        shutil.copy(os.path.join(H264_DIR, clip + ".mp4"), p)
        paths.append(p)
    work = [paths[i % len(paths)] for i in range(DECODE_COST_READS)]
    with vr.VideoHandle(paths[0]) as hd:
        shape = (4, *hd.out_size(256)[::-1], 3)

    def one(i):
        frames, _, _ = vr.read_frames(work[i], 4, rng=np.random.default_rng(i), short_side=256)
        assert frames.shape == shape, frames.shape

    one(0)
    t0 = time.perf_counter()
    for i in range(len(work)):
        one(i)
    single = (time.perf_counter() - t0) / len(work) * 1e3
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(one, range(8)))  # each thread's stream, outside the timing
        t0 = time.perf_counter()
        list(pool.map(one, range(len(work))))
        multi = (time.perf_counter() - t0) / len(work) * 1e3

    def all_frames(i):
        with vr.VideoHandle(paths[i % len(paths)]) as hd:
            n, _, w, h = hd.info()
            host = np.empty((n, h * 3 // 2, w), np.uint8)
            t = time.perf_counter()
            h264.decode_nv12(hd, list(range(n)), host)
            return n, time.perf_counter() - t

    all_frames(0)
    runs = [all_frames(i) for i in range(4)]
    fps_1 = sum(n for n, _ in runs) / sum(t for _, t in runs)
    with ThreadPoolExecutor(8) as pool:
        runs = list(pool.map(all_frames, range(16)))
    fps_8 = sum(n for n, _ in runs) / sum(t for _, t in runs)  # per thread
    about = {"cavlc": "cavlc.mp4 (596x336, 50 frames, High CAVLC, 4 slices, gop 25)",
             "high": "high.mp4 (596x336, 50 frames, x264 veryfast: CABAC, B-frames, gop 25)"}
    out = {"ms_per_clip_1_thread": single, "ms_per_clip_8_threads": multi,
           "decoder_frames_per_s_1_thread": fps_1,
           "decoder_frames_per_s_per_thread_8_threads": fps_8, "reads": len(work),
           "clip": about.get(clip, clip), "mjpeg_host_decoder": MJPEG_HOST_MS,
           "host_cpus": os.cpu_count()}
    print(f"decode cost {clip} ({smi}): " + json.dumps(out), flush=True)
    return out


def decode_phase(smi, dev):
    """H.264 in mp4 on the card (module docstring, phase 18) → (the
    nv12_rgb record, the main path's launches)."""
    from oatx_torch.data import nvdec
    from oatx_torch.data import video_reader as vr

    t0 = time.perf_counter()
    try:
        caps, refused = nvdec.caps(torch.cuda.current_device()), None
    except vr.UnsupportedMedia as e:
        caps, refused = None, str(e)
    print(f"decode caps (NVDEC, H.264 8-bit 4:2:0; {smi}): "
          + json.dumps(caps if refused is None else {"refused": refused}), flush=True)
    if refused is not None and not nvdec.is_observed_refusal(refused):
        raise AssertionError(f"NVDEC refused without the signature of the one refusal seen "
                             f"(a container without the video capability: "
                             f"{nvdec.OBSERVED_REFUSAL}): {refused}")
    if caps is not None and (not caps["supported"] or caps["max_width"] < 1920
                             or caps["max_height"] < 1080):
        raise AssertionError(f"NVDEC's caps for H.264 8-bit 4:2:0: {caps}")
    demux = decode_demuxer()
    print(f"decode demuxer ({smi}): " + json.dumps(demux), flush=True)
    fixtures, verified = decode_host_fixtures()
    print(f"decode fixtures ({smi}): " + json.dumps(fixtures), flush=True)
    lap("18 decode: fixtures")
    record = decode_kernel(smi)
    summary = {"caps": caps, "refused": refused, "demuxer": demux,
               "kernel_ms": record["ms"], "kernel_max_abs_err": record["max_abs_err"]}
    if refused is not None:
        summary["nvdec"] = decode_nvdec_refused(refused)
    else:
        summary["nvdec"] = decode_nvdec_fixtures(demux, verified)
    with tempfile.TemporaryDirectory() as tmp:
        train, launches = decode_train(tmp, smi, dev, verified)
        del verified
        lap("18 decode: cli.train")
        costs = {clip: decode_cost(smi, tmp, clip) for clip in DECODE_COST_CLIPS}
    summary.update(train_losses=train["losses"], first_batch_frames=train["first_batch_frames"])
    for clip, cost in costs.items():  # [1 thread, 8 threads]
        summary[f"{clip}_ms_per_clip"] = [cost["ms_per_clip_1_thread"],
                                          cost["ms_per_clip_8_threads"]]
        summary[f"{clip}_decoder_frames_per_s"] = [
            cost["decoder_frames_per_s_1_thread"],
            cost["decoder_frames_per_s_per_thread_8_threads"]]
    summary["phase_s"] = time.perf_counter() - t0
    print(f"decode summary ({smi}): " + json.dumps(summary), flush=True)
    return record, launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-ln-linear", metavar="LIB",
                    help="library built from another csrc/ln_linear.cu, timed beside this one")
    ap.add_argument("--parent-ln-mlp", metavar="LIB",
                    help="library built from an earlier csrc/ln_mlp.cu (one-kernel C "
                         "interface), timed beside this one")
    ap.add_argument("--parent-space-attention", metavar="LIB",
                    help="library built from an earlier csrc/space_attention.cu (the "
                         "Dh-64 C interface), forward and backward timed beside this one")
    ap.add_argument("--sweep-query-splits", action="store_true",
                    help="also time kernel 2's forward at each of 1-4 blocks per frame "
                         "group (the choice behind _query_split)")
    ap.add_argument("--only-trainer", action="store_true",
                    help="build the kernels and run the trainer phase alone (no record, "
                         "no ok line): the quick loop on that phase")
    ap.add_argument("--only-objects", action="store_true",
                    help="build the kernels and run the objects phase alone (no record, "
                         "no ok line): the quick loop on that phase")
    ap.add_argument("--only-data", action="store_true",
                    help="build the kernels and run the data phase alone (no record, "
                         "no ok line): the quick loop on that phase")
    ap.add_argument("--only-towers", action="store_true",
                    help="build the kernels and run the towers phase alone (no record, "
                         "no ok line): the quick loop on that phase")
    ap.add_argument("--only-wide", action="store_true",
                    help="build the kernels and run the wide phase alone (no record, "
                         "no ok line): the quick loop on that phase")
    ap.add_argument("--only-dp", action="store_true",
                    help="build the kernels and run the dp phase alone (no record, "
                         "no ok line): the quick loop on that phase")
    ap.add_argument("--only-shard", action="store_true",
                    help="build the kernels and run the shard phase alone (no record, "
                         "no ok line): the quick loop on that phase")
    ap.add_argument("--dp-nccl", action="store_true",
                    help="build the kernels and run phase 10 (b), then phase 11's pod "
                         "recipes, alone with one rank per visible card over NCCL (needs 2 "
                         "or more cards; no record, no ok line)")
    ap.add_argument("--only-tp", action="store_true",
                    help="build the kernels and run the tp phase alone (no record, "
                         "no ok line): the quick loop on that phase")
    ap.add_argument("--tp-nccl", action="store_true",
                    help="build the kernels and run the pod recipes as shipped "
                         "(model_parallel 4) with one rank on each of 4 cards over NCCL "
                         "(no record, no ok line)")
    ap.add_argument("--only-serve-extras", action="store_true",
                    help="build the kernels and run phase 3's extras alone: the int8 "
                         "server and the exported artifacts (no record, no ok line)")
    ap.add_argument("--only-pp", action="store_true",
                    help="build the kernels and run the pp phase alone (no record, "
                         "no ok line): the quick loop on that phase")
    ap.add_argument("--only-extract", action="store_true",
                    help="build the kernels and run the extract phase alone (no record, "
                         "no ok line): the quick loop on that phase")
    ap.add_argument("--only-viz", action="store_true",
                    help="build the kernels and run the viz phase alone (no record, "
                         "no ok line): the quick loop on that phase")
    ap.add_argument("--only-optim", action="store_true",
                    help="build the kernels and run the optim phase alone (no record, "
                         "no ok line): the quick loop on that phase")
    ap.add_argument("--only-finetune", action="store_true",
                    help="build the kernels and run the finetune phase alone (no record, "
                         "no ok line): the quick loop on that phase")
    ap.add_argument("--only-decode", action="store_true",
                    help="build the kernels and run the decode phase alone (no record, "
                         "no ok line): the quick loop on that phase")
    ap.add_argument("--pp-nccl", action="store_true",
                    help="build the kernels and run the pod recipes with pipeline true "
                         "on their 4 stages, one rank on each of 4 cards over NCCL (no "
                         "record, no ok line)")
    ap.add_argument("--dp-rank", type=int, help=argparse.SUPPRESS)  # phase 10's ranks
    ap.add_argument("--dp-world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dp-init", help=argparse.SUPPRESS)
    ap.add_argument("--dp-backend", default="gloo", help=argparse.SUPPRESS)
    ap.add_argument("--dp-out", help=argparse.SUPPRESS)
    ap.add_argument("--dp-phase", default="dp",
                    help=argparse.SUPPRESS)  # 'dp' | 'shard' | 'tp' | 'pp'
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if opts.dp_rank is not None:  # one rank of phase 10 (b) or 11, started by their parent
        rank_main = {"shard": shard_rank_main, "tp": tp_rank_main,
                     "pp": pp_rank_main}.get(opts.dp_phase, dp_rank_main)
        return rank_main(opts.dp_rank, opts.dp_world, opts.dp_init, opts.dp_out,
                         opts.dp_backend)
    from oatx_torch.ops.kernels import _build

    # TF32 off: the plain versions and every f32 matmul / convolution on the
    # card must run in full f32 to serve as references (cuDNN convs default
    # to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader", "-i", "0"])
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    print("decode libraries on the host: " + json.dumps(decode_probe()), flush=True)
    secs = _build.build_all()
    ptxas = {k: ptxas_report(log) for k, log in _build.build_logs.items()}
    print(f"build: nvcc {secs:.1f} s for {[s.name for s in _build.sources()]} "
          f"(sm_90a); ptxas: {json.dumps(ptxas)}", flush=True)
    lap("environment and build")

    if opts.only_serve_extras:
        with tempfile.TemporaryDirectory() as tmp:
            serve_extras(tmp, smi)
        print("chip_smoke: --only-serve-extras ran the int8 server and the artifacts alone",
              flush=True)
        return 0
    if opts.only_trainer:
        trainer_phase(smi, dev)
        print("chip_smoke: --only-trainer ran the trainer phase alone", flush=True)
        return 0
    if opts.only_objects:
        objects_phase(smi, dev)
        print("chip_smoke: --only-objects ran the objects phase alone", flush=True)
        return 0
    if opts.only_data:
        data_phase(smi, dev)
        print("chip_smoke: --only-data ran the data phase alone", flush=True)
        return 0
    if opts.only_towers:
        towers_phase(smi, dev)
        print("chip_smoke: --only-towers ran the towers phase alone", flush=True)
        return 0
    if opts.only_wide:
        wide_phase(smi, dev)
        print("chip_smoke: --only-wide ran the wide phase alone", flush=True)
        return 0
    if opts.only_dp:
        rank_phases(smi, dev, ("dp",))
        print("chip_smoke: --only-dp ran the dp phase alone", flush=True)
        return 0
    if opts.only_shard:
        rank_phases(smi, dev, ("shard",))
        print("chip_smoke: --only-shard ran the shard phase alone", flush=True)
        return 0
    if opts.only_tp:
        rank_phases(smi, dev, ("tp",))
        print("chip_smoke: --only-tp ran the tp phase alone", flush=True)
        return 0
    if opts.only_pp:
        rank_phases(smi, dev, ("pp",))
        print("chip_smoke: --only-pp ran the pp phase alone", flush=True)
        return 0
    if opts.only_extract:
        extract_phase(smi, dev)
        print("chip_smoke: --only-extract ran the extract phase alone", flush=True)
        return 0
    if opts.only_viz:
        viz_phase(smi, dev)
        print("chip_smoke: --only-viz ran the viz phase alone", flush=True)
        return 0
    if opts.only_optim:
        optim_phase(smi, dev)
        print("chip_smoke: --only-optim ran the optim phase alone", flush=True)
        return 0
    if opts.only_finetune:
        finetune_phase(smi, dev)
        print("chip_smoke: --only-finetune ran the finetune phase alone", flush=True)
        return 0
    if opts.only_decode:
        decode_phase(smi, dev)
        print("chip_smoke: --only-decode ran the decode phase alone", flush=True)
        return 0
    if opts.pp_nccl:
        pp_nccl(smi, dev)
        print("chip_smoke: --pp-nccl ran the pod recipes with pipeline stages on 4 cards "
              "over NCCL", flush=True)
        return 0
    if opts.tp_nccl:
        tp_nccl(smi, dev)
        print("chip_smoke: --tp-nccl ran the pod recipes as shipped on 4 cards over NCCL",
              flush=True)
        return 0
    if opts.dp_nccl:
        world = torch.cuda.device_count()
        if world < 2:
            raise SystemExit(f"--dp-nccl needs 2 or more cards, {world} visible")
        dp_ranks(smi, dev, world, "nccl")
        shard_ranks(smi, dev, world, "nccl")
        print(f"chip_smoke: --dp-nccl ran phase 10 (b) and phase 11's pod recipes on {world} "
              "cards over NCCL", flush=True)
        return 0
    parent = None
    if opts.parent_ln_linear:
        parent = load_parent_ln_linear(opts.parent_ln_linear)
    parent_mlp = load_parent_ln_mlp(opts.parent_ln_mlp) if opts.parent_ln_mlp else None
    parent_sa = (load_parent_space_attention(opts.parent_space_attention)
                 if opts.parent_space_attention else None)
    g = torch.Generator(dev).manual_seed(0)
    kernels = [kernel_ln_mlp(dev, g, parent_mlp)]
    lap("2 kernels: ln_mlp")
    kernels += kernel_space_attention(dev, g, parent_sa, opts.sweep_query_splits)
    lap("2 kernels: space_attention")
    kernels.append(kernel_ln_linear(dev, g, parent))
    lap("2 kernels: ln_linear")
    by_name = {k["name"]: k for k in kernels}
    fb = fwd_bwd_ms(dev, g, parent)
    fb["space_attention_bwd"] = fb["space_attention"]
    for R, rec in ln_mlp_fwd_bwd(dev, g, parent_mlp).items():
        by_name["ln_mlp"]["by_rows"][R]["fwd_bwd"] = rec
    train_rows = by_name["ln_mlp"]["by_rows"][TRAIN_BATCH * 785]["fwd_bwd"]
    fb["ln_mlp"] = train_rows["ms"], train_rows["device_ms"]
    print(f"ln_mlp by rows ({smi}): {json.dumps(by_name['ln_mlp']['by_rows'])}", flush=True)
    for name in ("space_attention", "space_attention_bwd"):
        print(f"{name} by batch ({smi}): {json.dumps(by_name[name]['by_batch'])}", flush=True)
    if parent is not None:
        (ev0, ev1), busy = fb["ln_linear_parent"]
        by_name["ln_linear"]["parent"].update(fwd_bwd_ms=[ev0, ev1], fwd_bwd_device_ms=busy)
        print(f"ln_linear parent ({opts.parent_ln_linear}): "
              f"{json.dumps(by_name['ln_linear']['parent'])}", flush=True)
    for k in kernels:
        k["fwd_bwd_ms"], k["fwd_bwd_device_ms"] = fb[k["name"]]
        k["tflops"] = k["flops"] / k["ms"] / 1e9  # achieved, 2 flops per multiply-add
        # the source's ptxas report; kernel 2's split into forward and backward kernels
        report = ptxas.get(os.path.splitext(os.path.basename(k["source"]))[0]) or []
        if k["name"].startswith("space_attention"):
            bwd = [r for r in report if "bwd" in r["kernel"] or "cls_key" in r["kernel"]]
            report = bwd if k["name"] == "space_attention_bwd" else \
                [r for r in report if r not in bwd]
        k["ptxas"] = report
    print("kernels " + " | ".join(
        f"{k['name']}: {k['shape']}, max_abs_err {k['max_abs_err']:.3e}, "
        + (f"max_rel_err {k['max_rel_err']:.3e}, tolerance |err| <= {k['atol']} + "
           f"2^-7·|ref| used to {k['tol_used']:.3f}, ref rms {k['ref_rms']:.3e} "
           f"max {k['ref_max']:.3e}, " if "atol" in k else
           f"relative L2 {json.dumps(k['grad_rel'])} <= {k['grad_rel_tol']} used to "
           f"{k['tol_used']:.3f}, ")
        + f"kernel_ms {k['ms']:.4f}, plain_ms {k['plain_ms']:.4f}, "
        f"library_ms {k['library_ms']:.4f}, bound_ms {k['bound_ms']:.4f} "
        f"({k['bound_by']}), {k['tflops']:.1f} TFLOP/s, "
        f"fwd_bwd_ms at the train shape {k['fwd_bwd_ms']:.4f} "
        f"(device busy {k['fwd_bwd_device_ms']:.4f})"
        for k in kernels) + f" [{smi}]", flush=True)
    lap("2 kernels")

    with tempfile.TemporaryDirectory() as tmp:
        base = {}
        phases = {"serve": serve_phase(tmp, smi, base)}
        lap("3 serve")
        phases["serve_int8"], phases["artifact"] = serve_extras(tmp, smi, base)
        lap("3 serve extras")
    phases["train"] = train_phase(smi, dev)
    lap("4 train")
    kept = tempfile.TemporaryDirectory()  # phase 5's snapshot, phase 17's initial weights
    phases["trainer"] = trainer_phase(smi, dev, kept.name)
    lap("5 trainer")
    phases["objects"] = objects_phase(smi, dev)
    lap("6 objects")
    phases["data"] = data_phase(smi, dev)
    lap("7 data")
    phases["towers"] = towers_phase(smi, dev)
    lap("8 towers")
    phases["wide"], wide, wide_runs = wide_phase(smi, dev)
    lap("9 wide")
    launches, rank_kernels = rank_phases(smi, dev)
    phases.update(launches)
    tp, pp = rank_kernels["tp"], rank_kernels["pp"]
    phases["extract"], phases["extract_train"] = extract_phase(smi, dev)
    lap("14 extract")
    phases["viz"] = viz_phase(smi, dev)
    lap("15 viz")
    phases["optim"] = optim_phase(smi, dev, wide_runs["vit_huge_pod"])
    lap("16 optim")
    phases["finetune"] = finetune_phase(smi, dev, os.path.join(kept.name, "checkpoint-epoch1"))
    kept.cleanup()
    lap("17 finetune")
    nv12, phases["decode"] = decode_phase(smi, dev)
    kernels.append(nv12)
    lap("18 decode")
    print("chip_smoke seconds by step: " + json.dumps(
        {b[0]: round(b[1] - a[1], 1) for a, b in zip(LAPS, LAPS[1:])}), flush=True)
    for name, recs in wide.items():
        by_name[name]["wide"] = recs
    for name, recs in tp.items():
        by_name[name]["tp"] = recs
    for name, recs in pp.items():
        by_name[name]["pp"] = recs
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "tol_used", "tol_used_bare", "tol_tail", "grad_rel", "grad_rel_exact", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms", "tflops", "fwd_bwd_ms",
            "fwd_bwd_device_ms", "ptxas", "occupancy", "launches_by_phase", "parent", "by_rows",
            "by_batch", "by_shape", "wide", "tp", "pp")
    for k in kernels:
        k["launches_by_phase"] = {ph: n[k["name"]] for ph, n in phases.items()
                                  if n.get(k["name"])}
        k["launches"] = sum(k["launches_by_phase"].values())
        if not k["launches"]:
            raise AssertionError(f"{k['name']}: no launch on any main path")
    print(json.dumps({"kernels": [{key: k[key] for key in keys if key in k} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
