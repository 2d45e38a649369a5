#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (radialog_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and the CUDA toolkit (nvcc). Phases, one JSON line
each; any failing phase exits non-zero:

  device  card name and power limit, torch/CUDA versions; builds every
          kernel from csrc/ (one nvcc per source, started together)
  k1      W8A8 GEMM kernel vs its plain version, bitwise, at the five
          Vicuna-7B weight shapes x M in {1, 5, 6, 16, 18, 20, 56, 48, 256,
          440, 448, 56*80} (5, 6, 18, 20 and 48: verify blocks)
          (16 and 256: the serve phase's decode lanes and a full admission;
          1, 440 and 448: the eval CLI's batch-1 decode and correction
          prefills after its default 300-token reports, whose last 64-row
          tile is partial); each
          line names the launch plan's route (TMA + wgmma on 128 x 256 or
          128 x 128 tiles, or swapped operands at M <= 64); layer sums of the
          four projections at M = 56, 16, 4480, 1 and 440 against
          torch._int_mm and the bound
  k2      int8 flash-decode kernel vs its plain version (atol=rtol=2e-3) at
          B=56, H=32, D=128, S=384, L=32, shared prefix P0=48, at the
          binary-QA prefix (B=14, P0=427 of 448 rows), and with the serving
          ring's per-lane slot intervals and no prefix (B=16, S=384, prompts
          of 100-256 rows: a window inside the ring, a wrapped window, a full
          ring, a lane with no valid slot, a full prompt region), at the
          eval CLI's batch-1 correction decode (B=1, no prefix, S=768, a
          437-token prompt in 440 slots, steps 0, 128 and 255: 12 blocks of
          slots over 6 splits of one cluster); K2'' (the
          step's own row attended as an operand and written in place) at the
          report shape at steps 0, 150 and 298 and without a prefix at a slot
          in b1's block and at the last slot S - 1, the slot zeroed first:
          within K2_TOL of its plain version and of K2 on the cache with the
          row in place, the row bitwise, every other byte of the four buffers
          unchanged; each case run twice, bitwise equal, its launch plan
          printed (ops/flash_decode.py _plan: splits, prefix tiles, warps,
          loads); times, prefix_kernel and lane_kernel apart on the card's
          clock, and with the L2 flushed by a read
  tproto  the TPU microbench tools' prototypes: T1 (K2 over one interleaved
          k|v buffer) bitwise equal to K2 and within K2_TOL of its plain
          version at tools/microbench_kvfused.py's defaults; T2 and T3
          (per-column W4A8, exact int32; TMA + register-operand wgmma)
          bitwise equal to the plain product at the four Vicuna-7B
          projection shapes, M in {32, 5, 1, 16, 64, 256} (the wn boundaries
          and one tiling of rows above 64), each line naming its launch plan;
          times, with torch._int_mm on the widened codes as the yardstick
          where M > 16; layer sums at M = 32, 5 and 256, and at M = 32 and 5
          the plan beside three other configurations (64 or 128 weight rows
          a block everywhere; no K split); the M = 32 layer again with a read as the L2 flush
          and by torch.profiler's device time; each tool's chain, whose
          launches the kernels line reports
  k3      flash-attention kernel vs its plain version (K3_TOL, beside the
          plain version's own spread between key blocks of 64 and 256) at
          H=32, D=128, bf16, causal: B=1 with T=S in {256, 448, 1024}, the
          serve phase's admission (B=1, T=S=256, length 230, fused views), B=12
          with T=S=448 and lengths 300-448, and the qa phase's B=1 shapes
          T=S in {431, 436} and the eval CLI's correction prefills (437
          of 440 and 445 of 448 rows) with q/k/v as views of one fused
          projection, the float phase's binary-QA batch (B=14, T=S=440,
          lengths 431-440) and correction prefill (437 of 440) with q/k/v
          contiguous,
          the train phase's shape (B=2, T=S=600, lengths 600 and 413); and
          H=4, D=16, f32, B=2, T=300; each line names the kernel that ran
          (TMA + wgmma for bf16 at D 64 and 128); times, with
          scaled_dot_product_attention as the yardstick
  k4      W4A8 GEMM kernel vs its plain version (bitwise: each group's
          integer sum is exact and both add the groups in K order with
          single rounded f32 operations, also where K splits) at the four
          Vicuna-7B layer shapes, asymmetric and symmetric grids, M in {16,
          56, 256}, and at the mock model's shapes, each case twice and
          bitwise equal; each line names the route and the launch plan;
          times, at the Vicuna shapes also on the card's clock
  k5      the flash-attention backward kernels K5a (dq) and K5b (dk, dv) vs
          their plain versions (K5_TOL, beside the plain version's own spread
          between blocks of 64 and 256), fed K3's own out and lse, causal, at
          H=32, D=128: bf16 at the train phase's shape (B=2, T=S=600, lengths
          600 and 413, q/k/v contiguous as the stacked layout's separate
          projections give them), the same with q/k/v as views of one fused
          projection, the same with q scaled by 3 (peaked attention, where a
          dropped key tile shows), B=1 with T=S=256, a lane of length 0
          beside a live one, non-causal with a length mask; the TMA route's
          tile boundaries (T of 1 with 64 or 129 keys, 63, 65, 127, 129,
          causal and not), the qa prefix's T=431 (lse rows not 16-byte
          aligned), D=64 at the train shape; f32; H=4, D=16 in f32 and bf16
          (the mock; the mma.sync route). Each case holds K5a and K5b, and
          the whole backward (on the TMA route K5a computes delta itself),
          each run twice and bitwise equal, and names its route; times the
          kernels, the whole backward, the PyTorch delta alone and the
          backward of scaled_dot_product_attention (the yardstick), and at
          the train shape the same on the card's own clock (torch.profiler)
  small   the mock pipeline on the card vs the same weights on the CPU:
          query embeddings, prefill and teacher-forced decode logits, for
          the report batch (48-token shared prefix), for a batch whose
          shared prefix holds the image and is 273 tokens long (K3 in the
          prefix prefill, K2 over the long prefix), and for a batch of 2
          300-token prompts sharing only BOS (K3, then install_prefill);
          then, with W8A8 and with W4A8 weights, the mock pipeline through
          RaDialogServer over the int8 ring with staggered submits until the
          ring wraps, and teacher-forced logits of a hand-stepped ring
          schedule; every kernel call held against its plain version there;
          the report batch again with RADIALOG_DEFER_KV=1 (K2'' at every
          decode layer, K2 never) and with the bf16 KV cache (no flash-decode),
          held the same way; a sampled generation on the card run twice with
          one seed, equal; then the mock LoRA trainer (TINY_LLAMA, cutoff 256 so that flash
          attention runs, 4 micro-steps with accumulation 2, float base in
          FP32 and int8 base in BF16) on the card vs the same run on the
          CPU: losses and the updated LoRA tree, every K3/K5a/K5b call held
          against its plain version; then the eval command line
          (apps/evaluate.py main) over the mock at W8A8 on the CPU and on the
          card from the same weights, and at W4A8 on the card (K4 launched):
          its four files, finite metrics, and per record the teacher-forced
          logits of the report turn and of its correction turn at LOGIT_TOL;
          then the float mock (quantize=False: the stacked f32 tree over the
          bf16 cache) on the card vs the CPU: embeddings, prefill and
          teacher-forced logits of the report batch and of 2 prompts of
          300+ tokens (K3) at FLOAT_LOGIT_TOL, no launch of K1, K2 or K4
  slice   the full-width pipeline (Vicuna-7B W8A8, 32 layers, int8 KV,
          BioViL-T at 448, BERT-base Q-Former, CheXpert classifier at 488)
          with random weights from a seeded generator: 56 uint8 X-rays,
          128-token prompts sharing 48 tokens, greedy decode of 300 tokens
          with EOS disabled, after a warm-up; kernel launch counts of that
          run and reports/s; then the pass with RADIALOG_DEFER_KV=1 at 64
          tokens (SLICE_DEFER_NEW): K2'' 32 x 63 times, K2 never, K1 as
          often as a pass of that length without it, reports/s both ways and
          the share of tokens equal to the first pass's first 64 (reported,
          not held)
  bench   the repo's measurement entry points (tools/bench_torch.py and the
          tools/bench_*_torch.py twins of the JAX tools) at full width,
          each on its own synthetic weights (one W8A8 set shared, a W4A8
          set, the int8 training base), cut in depth only (runs, sessions,
          tokens; each cut listed in its line): the report pass, the sweep
          (W8A8 and W4A8, --mem), the binary and all-findings QA passes,
          the ring (int8 and W4A8), speculation batch-1 and batched, the
          chat, LoRA training with flash attention and stage 1, the
          composed input pipeline and the loader. Each tool's lines parse,
          have the JAX tool's keys, and every number in them is finite and
          positive; each kernel the tool's path runs launched (BENCH_TOOLS)
  qa      the evaluation follow-up passes on the slice's pipeline, over the
          slice's own conversations (prompt + 300 generated tokens) and
          image embeddings: the binary-QA pass over 2 studies (14 lanes,
          the image in a shared prefix of ~427 tokens), the all-QA pass over
          5, one batch-1 follow-up of 32 tokens (the correction pass's
          shape: prefill without a cache, then install_prefill) and the
          BERT-base CheXbert labels of 16 reports; seconds, launches per
          kernel (K3 exactly 32 x 3) and the metrics
  eval    the evaluation harness at full width through the eval command
          line (apps/evaluate.py main, the root test.py's counterpart):
          --synthetic --int8 --use_embs --do_corr --do_cp_bin_qa
          --do_cp_all_qa over the first test study of tests/fixtures,
          batch 12, 150 new tokens (EVAL_NEW, cut from the CLI's 300; the
          correction prompts stay past 256 tokens), files under
          build/chip_eval/: the report
          pass, the batch-1 correction pass (256 tokens a study), binary QA,
          all-QA, CheXbert labels; seconds per pass, launches of K1, K2 and
          K3 (K3 exactly as models/llama.py _use_flash predicts from the
          prompts that reached the pipeline), the four files and finite
          metrics; K1 (bitwise), K2 and K3 held against their plain
          versions on the inputs the run gave them in the correction; cut
          from the test split in depth only (1 study)
  spec    speculative decoding at full width on the eval phase's pipeline
          and prompts: the int8 verify attention card against CPU at S=1280
          (integer sums bitwise past 2^24, where an f32 product misses);
          generate_spec (k 4) on the first correction prompt, 24 tokens
          over each cache (verifies, tokens per verify,
          seconds, stream waits per verify, where the tokens part from the
          eval phase's batch-1 loop); the eval command line with --corr_spec
          5 (one SpecCompactBatcher for the corrections, the report pass
          answered from the eval phase's run: seconds beside the batch-1
          loop's, each correction's share of tokens equal to it, the files);
          SpecRingBatcher on the bf16 ring, 4 sessions x 64 tokens. Every
          run held by teacher forcing: its tokens through the plain prefill
          and decode steps, every verify row on the final sequence within
          SPEC_TOL (LOGIT_TOL printed beside); the batch-1 runs' rows
          bitwise those of the verify forward fed the same tokens
  chat    the chat app at full width on the slice's pipeline: the image's
          / 255 card against CPU for all 256 uint8 values; ChatSession with
          speculation (k 5) over the bf16 session cache: a 300-token report
          on the slice's first X-ray, a follow-up (incremental prefill logits
          against a full re-prefill, SPEC_TOL), a speculative turn teacher-
          forced through the plain session, an ask_stream turn equal to ask's
          tokens; seconds per turn and to the first chunk, verifies, peak
          memory; then python -m radialog_tpu_torch.apps.demo --cli --mock
          with two turns on stdin

  serve   the multi-session server at full width on the slice's weights:
          RaDialogServer over the int8 ring, 16 lanes, prompt region 256,
          ring 128, 8 steps per chunk; 4 client threads submit 32 sessions
          (image prompts of 100-250 tokens with the pipeline's own image
          embeddings, 64 new tokens, EOS disabled) and one oversized prompt;
          every future, every streamed delta and every kernel's launch count
          is checked; aggregate tokens/s, seconds to the first token, peak
          memory. Then 16 sessions x 32 tokens with W4A8 layers (K4 128
          times and K1 once per forward)
  datatools  the data tools, in the ckpt phase's process after it, on a
          W8A8 pipeline built as the slice's (the same seed):
          create_sections over a report tree the phase writes (its rows
          checked against the tree), create_data --mode RG over
          tests/fixtures, and --mode INS --mock over those fixtures with
          each train study repeated 18 times (teacher calls of 12, 12, 12
          and 3 prompts) and that W8A8 pipeline as the teacher, 64
          new tokens (the mock's cut of the CLI's 256), once through
          generate_texts_ring (12 lanes, the int8 ring: K1, and K2 only
          under per-lane intervals, K2') and once with --teacher batch
          through generate_texts (K1, K2); the teacher's tokens/s and
          seconds a call, launches, the fused JSON's task counts equal to
          a CPU run's with a stub teacher
  float   the float path at full width (PipelineConfig(quantize=False), the
          JAX package's default): Vicuna-7B bf16 in the stacked layout over
          the bf16 cache, random from a seed, with the slice's vision models.
          The report pass (56 images, 128-token prompts, 64 tokens
          (FLOAT_REPORT_NEW), EOS disabled, after a warm-up; reports/s, peak
          memory); the server on
          its weights (the bf16 ring, 16 lanes, prompt region 256, ring 128,
          8 steps a chunk, 16 sessions x 32 tokens of 100-250-token image
          prompts from 4 client threads; tokens/s, first-token seconds);
          ContinuousBatcher (4 lanes, 8 staggered sessions x 16 tokens, each
          session's logits against the same session alone at batch 1,
          teacher-forced with its tokens, within CB_TOL); then the eval
          command line without --int8 (--synthetic --use_embs --do_corr
          --do_cp_bin_qa --do_cp_all_qa over the first test study of
          tests/fixtures, files under build/chip_eval_float/): seconds per
          pass, the four files, finite metrics, K3 exactly as _use_flash
          predicts (every cache-free prefill of 256+ tokens: the correction,
          the 14-lane binary-QA batch, all-QA) and held against its plain
          version on the run's own inputs in the correction prefill and the
          binary-QA batch. No part launches K1, K2 or K4
  train   LoRA finetuning at full width through apps/finetune_lora.train:
          Vicuna-7B (32 layers), int8 frozen base, bf16 compute, LoRA rank 8
          on wq/wv plus img_proj, per-layer recomputation, micro-batch 2 x
          cutoff 600, image embeddings; one warm-up and 8 timed micro-steps
          (accumulation 2) with flash attention (K3 twice and K5a, K5b once
          per layer and micro-step), then the same without (no launch of
          them); losses, gradient norms, the LoRA tree, the untouched base,
          the checkpoint read back; tokens/s (the sequences' own tokens, padding
          not counted, over the whole timed span), the mean and the median
          ms/step and peak memory of both. Then its optim part: make_adamw at
          finetune_lora's settings (clip 1.0, no decay, its warm-up-cosine
          schedule) and at stage 1's (decay 0.05, no clip, warm-up 1,000
          from 1e-6), each at accumulation 3, OPTIM_UPDATES updates of the
          LoRA tree at Vicuna-7B width on the card and on the CPU from the
          same seeded gradients: entries apart in mu, nu, the update and the
          parameters (none at stage 1's settings; within OPTIM_CLIP_TOL with
          the clip, whose norm sums in another order on each device), the
          bits of Adam's divisors and the schedule's rate on both; the same
          in the arithmetic before optax's, for the record; pack_q4c at
          tools/microbench_w4_torch.py's spot-check weight on the card
          against the tool's numpy packer, bit for bit (and what a division
          by the Python scalar 7.0 left apart)

  stage1  Q-Former stage-1 training from raw JPEGs (the fixtures under
          tests/fixtures/cxr): at the mock's size (TINY_QFORMER, BioViL-T at
          64 px) the loader's uint8 batches through DevicePrefetcher onto the
          card (bitwise the host's, pinned staging), their f32 form card
          against CPU (bitwise), one raw train step card against CPU from the
          same weights and negatives (the four losses and every gradient leaf
          within STAGE1_SMALL_TOL) and the greedy captions (equal); then full
          width: Blip2Config() (BERT-base Q-Former, 32 queries, encoder width
          1408, max_txt_len 256) over BioViL-T at 448, batch 32, captions of
          40-120 words, the fixtures cycled to 64 paths through
          CxrLoader(threads=4, emit_u8=True) -> stage1_raw_batches ->
          DevicePrefetcher(depth=2) -> make_stage1_raw_train_step: from the
          initial weights on the first batch BF16 with itm_chunks 1 and 3
          (losses within STAGE1_CHUNK_TOL, peak memory of each), FP32 against
          float64 (both at itm_chunks 3; losses and the gradients of
          ln_vision, query_tokens and itm_head within STAGE1_F64_TOL); then 8
          BF16 steps (finite losses; s/step, samples/s, prefetch waits, peak
          memory) and 2 under torch.profiler (the device's busy share); the
          loader's batches/s alone and its route (never "pil" where g++ and
          jpeglib.h exist); precompute_embeddings over the fixtures into an
          npz that a pipeline built with emb_cache= returns row for row,
          equal to blip2_forward_image; python -m
          radialog_tpu_torch.apps.pretrain --mock --raw on the card. No
          kernel of K1-K5 or T1-T3 launches in the phase
  trainers  the findings-classifier and CheXbert trainers (after stage1):
          card against CPU at the CPU tests' sizes from host-drawn weights
          (3 FP32 classifier steps, BioViL-T with a (1,1,1,1) basic trunk at
          488 px, batch 2, without and with the augmentation, the card's
          draws replayed on the CPU: losses, the parameters' 99th
          percentile and largest difference, the BatchNorm running stats
          within CLS_SMALL_TOL; 3 CheXbert steps of the mock's tiny BERT
          with the card's dropout masks replayed on the CPU, within
          BERT_SMALL_TOL); the norms audit (train-mode BatchNorm's batch
          mean and variance at ResNet-50 widths, LayerNorm at 768, RMSNorm
          at 4096: ulps card against CPU, the card's own mean against an
          IEEE division of its sum, recorded; the outputs within NORM_Y_TOL
          and dropout's division bitwise, held); the softmax audit
          (softmax and log-softmax at each site's path shape: mha at the
          float decode, mha_shared_prefix at the report prefill, the int8
          verify, the sampling nucleus, beams, the LoRA, Q-Former, ITC, ITM
          and CheXbert losses: ulps of the softmax alone card against CPU,
          the kept nuclei and beam orders apart, recorded; each site's
          output within SOFTMAX_TOL and the sampling temperature's division
          bitwise, held); full width: the
          classifier (ResNet-50 trunk, 488 px, batch 32, FP32) and CheXbert
          (BERT-base, 16 x 512, FP32, dropout on), 2 warm and 5 timed steps
          and 1 profiled on one batch each (s/step, images or reports/s,
          busy share, launches a step, peak memory; finite losses that
          fall); the chexpert_train, run_chexbert train and run_chexbert
          label command lines as processes on the card. No kernel of K1-K5
          or T1-T3 launches in the phase
  quality  the quantization-budget tools' functions (tools/measure_*_torch.py)
          at Vicuna-7B width: the int8 cache's teacher-forced logit error
          against the bf16 cache at the tool's defaults (3 seeds, 4 layers)
          beside the W8A8 weights' own prefill error against FP32 at the
          same depth; bf16, W8A8 and W4A8 (asymmetric) against FP32 at 1
          layer and 1 seed (pack_q4's host cost); free-running agreement
          of the int8 cache at 2 of 8 seeds; K1, K2 and K4 launched, every
          figure finite
  tp      tensor-parallel serving (parallel/tp_serving.py, tp_ring.py):
          two rank processes of this script (``--tp-rank``) on the one card
          over gloo, TP = 2, each with a Vicuna-7B-width shard (16 heads,
          FFN 5,504), started before the quality phase and running beside
          it; 2 layers (the 4-bit case 1): make_tp_generate over the int8
          cache with a 272-token shared prefix (8 reports x 32 tokens: K1,
          K2 at 16 heads, K3), W4A8 shards (K4: groups restarting at the
          shard boundary), 2 beams over the bf16 cache, RaDialogServer over
          TPRingBatcher from 4 clients (K3 in its 256-slot admissions); both
          ranks' tokens and ring chunks equal; each case's teacher-forced
          logits against the same weights unsharded here within its bound
          (TP_RING_GAP's comment); every first call of a kernel a case and
          shape makes held against its plain version (K1, K4 bitwise);
          K1 and K4 at every 2- and 4-way shard shape bitwise (down's K of
          2,752 at four ways); the same code at world size 1 over NCCL,
          token-equal to the unsharded run; TP = 2 over NCCL where the
          machine has two cards. tokens/s only as what they are: two ranks
          sharing one card
  tptrain training across ranks (parallel/partition.py, collectives.py, the
          Megatron pair in models/llama.py, make_lora_train_step(mesh=),
          finetune_lora.train inside a process group): Vicuna-7B's widths
          at 2 layers (vocab 32,001 padded to 2 x 16,001 rows), the int8
          base, LoRA r 8 on wq/wv, remat, flash, cutoff 600 with the train
          phase's records, global micro-batch 4. The one-process reference
          here (an SGD step, 3 AdamW micro-steps through finetune_lora.train,
          stage 1's SGD step at BERT-base widths over synthetic patch tokens,
          batch 32 x 256 text tokens, FP32, its hard negatives drawn once),
          then rank processes of this script (``--tptrain-rank``): two over
          gloo on the one card for TP = 2 (1 x 2, 16 heads: K3, K5a, K5b
          counted and held against their plain versions at that shape), DP =
          2 (2 x 1) and stage 1 at DP = 2 with the same negatives; then one
          over NCCL at world size 1, bitwise the reference. Each case: loss
          and grad_norm within TPTRAIN_TOL, each LoRA leaf's update cosine
          and largest element error (stage 1's too), the replicated leaves bitwise equal on both ranks, ms a micro-step,
          the collectives a micro-step issues and their ms


  ckpt    (in a process of its own with datatools and warmup, started
          after bench and waited for before stage1: CHILD_TIMEOUT_S; their
          lines are printed then)
          checkpoints on disk at full size, loaded back through the port's
          loaders (ROADMAP queue 1 item 3) with both tokenizer loaders
          replaced by the WhitespaceTokenizer at the Vicuna layout: Vicuna-7B
          v1.3's HF layout in fp16 (32 layers, 32,000 embedding rows, two
          pytorch_model-*.bin shards and their index, ~13.5 GB, random from
          per-tensor seeds), a PEFT adapter (r 8, alpha 16, q/v, img_proj),
          a LAVIS BLIP-2 .pth with BioViL-T, a Lightning classifier .ckpt, a
          CheXbert .pth (module. prefix) and an emb_cache npz, in a fresh
          directory under build/ (16 GiB free asked first, removed at the
          end). The W8A8 pipeline from the files: load seconds by stage,
          peak host RSS so far, device memory; layers 0 and 31, lm_head,
          embed, the LoRA and every BLIP-2, BioViL-T, classifier and CheXbert leaf
          bitwise against the same tensors converted and packed on the host;
          the report batch (56 x CKPT_NEW = 32; logits finite with the image,
          NaN without it, as JAX's jnp.take gives them) and a 4-beam run (2
          prompts x 32 tokens: K1, never K2); the bf16 pipeline (layers 0
          and 31 bitwise); apps/evaluate.py main with every checkpoint flag,
          --num_beams 4, --do_corr, --do_cp_bin_qa over 1 fixture study,
          --max_new_tokens EVAL_NEW (K3);
          the trainer from the files (int8 base, the adapter, flash, 2
          micro-steps: K3, K5a, K5b); pack_q4's seconds for the o_proj and by
          weights for a layer
  warmup  (in that process after datatools) cold and warm boot:
          tools/bench_warmup_torch.py at full width (Vicuna-7B W8A8, bf16
          LoRA and session cache, --max-new 32: WARMUP_CUTS), each run a
          process of its own with its launches counted there (--warmup-tool):
          cold with --cache-dir an empty directory under build/ (removed
          after), warm with the default build/kernels/. Held: each line has
          the JAX tool's keys and device, every number finite and positive,
          the card's name and power limit; the cold directory empty before
          and holding one library for each kernel the run loaded after; the
          default directory's listing unchanged by the warm run; K1 launched
          in both. Recorded: each run's seconds, the card's free memory
          before, the cold warm-up's seconds over the warm one's (nvcc's
          share)

``python3 chip_smoke.py --time-report ROOT [ROOT ...]`` runs only the slice
phase's report batch, of each checkout at ROOT in turn (its own package and
chip_smoke.py, a process each), to compare commits in one call: the stream
waits the host makes in an 8-token warm-up (torch's sync debug mode), then
two timed passes' reports/s, launches and a checksum of the tokens.

Each phase's start goes to stderr ("chip_smoke: <phase> starts at <t> s"),
and at WATCHDOG_S seconds every thread's stack (faulthandler), so that a run
stopped at its time limit says where it was.

The line before the last is a JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}. A kernel's time is the
median over launches timed with CUDA events, the 50 MB L2 flushed before
each, all queued behind a sleep on the card so that no launch waits for the
host.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12       # dense int8 tensor-core peak
BATCH, PROMPT, SHARED, NEW = 56, 128, 48, 300
# new tokens of the slice phase's second pass (in-kernel KV writes) and of
# the float phase's report pass: the slice's 300, cut for the script's time
# (each checks a path the first pass times; the script's time on a slow host
# went past 1,200 s)
SLICE_DEFER_NEW, FLOAT_REPORT_NEW = 64, 64
BF16_OPS_PER_S = 989e12        # dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
K2_TOL = dict(atol=2e-3, rtol=2e-3)
# K3 against its plain version: the plain version's own spread between key
# blocks of 64 and 256 on the same inputs is 3.9e-3 in bf16 (one bf16 step
# of an O(1) output) and 2.4e-7 in f32 (measured on the CPU at these shapes;
# each run prints it again beside its error); the kernel's 64-key tiles
# differ from both, so its running max and the rounding of p to bf16 may
# differ as much
K3_TOL = {"bfloat16": dict(atol=1e-2, rtol=1e-2), "float32": dict(atol=1e-5, rtol=1e-5)}
# K5a/K5b against their plain versions: each of dq, dk and dv by its largest
# |error| over its own largest |reference value|. A gradient rounds to bf16
# once, so the largest entry alone may land one bf16 step (2^-8 to 2^-7 of
# its value) from the reference, and ds and p round to bf16 before the second
# products, in tiles of 64 in the kernel and blocks of 256 in the plain
# version; the plain version's own spread between blocks of 64 and 256 is
# printed beside each error, on the same scale (up to 2.1e-3 in bf16 at
# these shapes on an H100, the kernels' errors up to 3.7e-3; a kernel that
# skips the last partial tile of keys or of queries misses by 0.13 to 0.15).
# f32: only the order of the f32 sums differs (errors up to 1.1e-6)
K5_TOL = {"bfloat16": 8e-3, "float32": 1e-5}
QA_STUDIES, ALL_QA_STUDIES, LABELED, FOLLOW_UP_NEW = 2, 5, 16, 32
# the eval command line's batch-1 correction turn at full width and its
# default 300 report tokens: 437, 442 and 445 prompt tokens over the first
# three fixture studies (a 118-token report prompt, its 300 generated
# tokens, the correction request; the eval phase, at EVAL_NEW report
# tokens, prints its own), padded to a multiple of
# 8 (apps/tokenization.py pad_batch_right): 440 and 448 rows, whose last
# 64-row tile is partial; 256 new tokens in a cache of 768 slots
# (decode/kvcache.py bucket_length). The eval phase also holds each kernel
# against its plain version on the inputs the run itself gave it there
CORR_T, CORR_T2, CORR_LEN, CORR_LEN2, CORR_NEW, CORR_S = 440, 448, 437, 445, 256, 768
# test studies of the eval phase (and so of spec's --corr_spec): 1, cut from
# 3 for the script's time on a slow host (a correction takes ~36 s there and
# brings no new shape: the k phases hold the second and third studies'
# 442/445-token rows)
EVAL_STUDIES = 1
# new tokens of the eval command lines' report pass (eval, float, ckpt):
# the CLI's 300, cut for the script's time; the correction prompts then
# hold ~287 tokens, still past K3's 256, and the k phases keep the shapes
# of a 300-token report (CORR_T, CORR_T2)
EVAL_NEW = 150
# new tokens of the ckpt phase's report batch (the slice phase's 300, cut to
# 32 for the script's time: it checks the weights
# loaded from files, the slice phase times the pass; the eval command line
# keeps 300, which makes the 256+-token correction prompts that K3 serves)
CKPT_NEW = 32
# the speculative phases: K1's rows in a verify block (batch 1 at k = 4 and
# 5; 8 compact lanes at k = 5); batch-1 drafts and new tokens (the
# correction turn's 256); the chat's drafts, reply tokens after its 300-token
# report, and chunk; SpecRingBatcher's lanes, sessions, new tokens, drafts,
# verifies a chunk and ring (a multiple of k + 1 above 64 verifies x 5 slots);
# the S of the int8 verify attention held card against CPU, where 127 x 127 x
# 1,280 passes 2^24
VERIFY_M = (5, 6, 48)
SPEC_K, CORR_SPEC_K, CHAT_K, CHAT_NEW, CHAT_CHUNK = 4, 5, 5, 48, 16
SPEC_BF16_NEW = 24      # the bf16-cache batch-1 run, cut from 256 (then 128, 64, 32) for
SPEC_INT8_NEW = 24      # the script's time; the int8-cache one the same
RING_LANES, RING_NEW, RING_K, RING_CHUNK, RING_LEN = 4, 64, 4, 8, 325
VERIFY_S = 1280
# tokens of each speculative run teacher-forced through the plain steps (cut
# from 128, then 64 and 32, for the script's time); generated rows of the batch-1
# runs held bitwise against one row at a time (_tf_verify one_row), and
# against the control
SPEC_TF_N, ONE_ROW_N = 24, 16
# the bound of the speculative runs' rows against the plain decode steps fed
# the same tokens (teacher forcing). LOGIT_TOL cannot hold there at 32
# layers: over the int8 cache the verify attention is another function than
# K2 (the JAX package's int8 fallback: p requantized per row), and bf16 GEMMs
# of other row counts round apart. Sound runs of the spec phase read up to
# 0.81 (mean 0.078) over the int8 cache and 0.52 (0.054) over the bf16 one
# (H100 80GB HBM3, 700 W). A verify that misses its own row stays as close
# (the phase's control, printed), so this bound catches gross faults only:
# the batch-1 runs are also held bitwise against the verify forward fed the
# same tokens in blocks (_tf_verify) and one row at a time (one_row), and
# the control must fail the latter
SPEC_TOL = {"max": 1.2, "mean": 0.12}
# the float path's binary-QA prefill: the 14 questions about one study as
# 14 prompts of ~431-440 tokens (the float path shares no prefix), q, k and
# v contiguous from the separate wq/wk/wv projections of the stacked layout
FLOAT_QA_B, FLOAT_QA_T = 14, 440
FLOAT_QA_LENS = list(range(431, 441)) + [433, 435, 437, 439]
LOGIT_TOL = {"mean": 3e-2, "max": 0.3}   # why: phase_small's docstring
FLOAT_LOGIT_TOL = {"mean": 2e-4, "max": 2e-3}   # why: _small_float's docstring
# the float phase: eval studies; server sessions and new tokens (16 lanes,
# prompt region 256, ring 128, 8 steps a chunk, as the serve phase);
# ContinuousBatcher lanes, sessions, new tokens, cache slots a lane, and the
# bound of a session's logits against the same session alone at batch 1:
# bf16 GEMMs of 4 rows and of 1 round differently, which moved the logits
# (std 1.0) by up to 0.090, 0.0147 on average, and put the batcher's token
# up to 0.0625 below the lone run's largest logit (an H100 80GB HBM3 at
# 700 W); the bound is ~3x that
FLOAT_STUDIES, FLOAT_SESSIONS, FLOAT_NEW = 1, 16, 32
# (CB_NEW: cut from 32 for the script's time)
CB_LANES, CB_SESSIONS, CB_NEW, CB_CACHE = 4, 8, 16, 320
CB_TOL = {"max": 0.3, "mean": 0.05, "margin": 0.2}
# the serve phase: lanes, prompt region, cache length (ring 128), steps per chunk
LANES, PROMPT_REGION, CACHE_LEN, CHUNK = 16, 256, 384, 8
SESSIONS, SESSION_NEW, CLIENTS = 32, 64, 4
W4_SESSIONS, W4_NEW = 16, 32
# the train phase: micro-batch, cutoff, accumulation, micro-steps (the first warms up)
MICRO, CUTOFF, ACCUM, TRAIN_STEPS = 2, 600, 2, 9
# the mock trainer on the card against the CPU: FP32 sums in another order,
# then AdamW divides by sqrt(v), so a tree entry may differ by a fraction of
# the learning rate (3e-4); in BF16 the matmuls round differently on the two
# devices, and an entry whose gradient is near 0 may move a whole step the
# other way
SMALL_TRAIN_TOL = {"fp32": {"loss": 1e-4, "tree": 2e-4}, "bf16": {"loss": 5e-2, "tree": 1.5e-3}}


_START = time.time()


# each phase's start goes to stderr, so that a run stopped at its time limit
# shows where it was; at WATCHDOG_S seconds every thread's stack follows
WATCHDOG_S = 1140


def _begin(phase: str) -> None:
    print(f"chip_smoke: {phase} starts at {time.time() - _START:.1f} s", file=sys.stderr,
          flush=True)


def _watchdog() -> None:
    import faulthandler
    faulthandler.dump_traceback_later(max(1.0, WATCHDOG_S - (time.time() - _START)))


def emit(phase: str, **kw) -> None:
    """One JSON line; ``elapsed_s``: seconds since the script's start."""
    print(json.dumps({"phase": phase, **kw, "elapsed_s": round(time.time() - _START, 1)}),
          flush=True)


@contextlib.contextmanager
def _env(name: str, value: str):
    """Set an environment variable for the block, then restore it."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def timed_ms(fn, iters: int, flush) -> float:
    """Median device time of fn over iters launches, L2 flushed before each.

    Every launch is queued behind a sleep on the card, so the card never
    waits for the host between the two events: a decode-sized launch lasts
    tens of microseconds, as long as the wrapper's own host time."""
    import torch
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    torch.cuda._sleep(20_000_000)       # ~10 ms of card clock cycles
    for e0, e1 in events:
        flush()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return statistics.median(e0.elapsed_time(e1) for e0, e1 in events)


def phase_k1(torch, tq8, flush):
    """Every LLaMA projection shape at the report path's decode, prefix and
    prefill rows and at the serve phase's: 16 lanes at decode, a batch-1
    admission of a full prompt region (256 rows); and at the eval CLI's:
    batch-1 decode (M = 1) and the correction prefill (440 and 448 rows, a
    partial last 64-row tile). Each line names the route of the launch
    plan. The summary is one decoder layer's four projections at M = 56,
    with the same sums at M = 16, at the report prefill's M = 4480, at
    M = 1 and at the correction prefill's M = 440; and at the speculative
    verify blocks: batch 1 at k = 4 and 5 (M = 5, 6) and 8 compact lanes
    at k = 5 (M = 48); the spec phase's 3 compact lanes at k = 5 and 4 ring
    lanes at k = 4 (M = 18, 20) are held bitwise too."""
    h, inter, v = 4096, 11008, 32001
    shapes = {"wqkv": (h, 3 * h), "wo": (h, h), "gateup": (h, 2 * inter),
              "down": (inter, h), "lm_head": (h, v)}
    prefill = BATCH * (PROMPT - SHARED)
    g = torch.Generator(device="cuda").manual_seed(1)
    refused = {}
    sums = {m: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                "bytes_bound": 0} for m in (BATCH, LANES, prefill, 1, CORR_T) + VERIFY_M}
    for name, (k, n) in shapes.items():
        w8 = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
        for m in (1, 5, 6, LANES, 18, 20, 56, 48, PROMPT_REGION, CORR_T, CORR_T2, prefill):
            x8 = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
            got = tq8.q8_matmul_int32(x8, w8)
            ref = tq8.q8_matmul_int32_plain(x8, w8)
            torch.cuda.synchronize()
            err = int((got.long() - ref.long()).abs().max())
            if err:
                raise AssertionError(f"K1 {name} M={m}: int32 differs from plain by {err}")
            plan = tq8._plan(m, n, k)
            ms = timed_ms(lambda: tq8.q8_matmul_int32(x8, w8), 20, flush)
            plain_ms = timed_ms(lambda: tq8.q8_matmul_int32_plain(x8, w8), 3, flush)
            lib_ms = lib_refused = None
            try:        # torch._int_mm's shape rules (M > 16 in the releases we know)
                torch._int_mm(x8, w8.t())
                lib_ms = timed_ms(lambda: torch._int_mm(x8, w8.t()), 20, flush)
            except RuntimeError as e:
                lib_refused = str(e).splitlines()[0][:200]
                if name != "lm_head":       # the layer sums' refusal, not the vocab's N
                    refused[m] = lib_refused
            nbytes = m * k + n * k + 4 * m * n
            b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            b_ops = 2 * m * n * k / INT8_OPS_PER_S * 1e3
            emit("k1", weight=name, m=m, k=k, n=n, bitwise=True, route=plan.route,
                 tile=list(plan.tile), wn=plan.wn, stages=plan.stages, splits=plan.splits,
                 kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                 library_refused=lib_refused, bound_ms=max(b_bytes, b_ops),
                 bound_by="bytes" if b_bytes >= b_ops else "operations",
                 roofline_share=max(b_bytes, b_ops) / ms)
            if m in sums and name != "lm_head":
                # one decoder layer's four projections at these rows
                acc = sums[m]
                acc["ms"] += ms
                acc["plain_ms"] += plain_ms
                acc["library_ms"] = None if lib_ms is None or acc["library_ms"] is None \
                    else acc["library_ms"] + lib_ms
                acc["bound_ms"] += max(b_bytes, b_ops)
                acc["bytes_bound"] += b_bytes >= b_ops
        del w8
    for m, what in ((LANES, "the serve phase's decode"), (prefill, "the report prefill"),
                    (1, "batch-1 decode"), (CORR_T, "the correction prefill"),
                    (5, "a batch-1 verify block, k = 4"), (6, "a batch-1 verify block, k = 5"),
                    (48, "8 compact lanes' verify blocks, k = 5")):
        emit("k1", layer_sum=f"one decoder layer's 4 projections at {what}", m=m,
             roofline_share=sums[m]["bound_ms"] / sums[m]["ms"],
             **{key: val for key, val in sums[m].items() if key != "bytes_bound"})
    summary = sums[BATCH]
    summary["max_abs_err"] = 0
    summary["ms_m16"], summary["bound_ms_m16"] = sums[LANES]["ms"], sums[LANES]["bound_ms"]
    summary["library_ms_m16"] = sums[LANES]["library_ms"]
    summary["library_refused_m16"] = refused.get(LANES)
    summary["library_refused_m1"] = refused.get(1)
    summary["ms_prefill"] = sums[prefill]["ms"]
    summary["library_ms_prefill"] = sums[prefill]["library_ms"]
    summary["bound_ms_prefill"] = sums[prefill]["bound_ms"]
    for m, key in ((1, "m1"), (CORR_T, "correction_prefill"), (5, "m5"), (6, "m6"),
                   (48, "m48")):
        summary[f"ms_{key}"], summary[f"bound_ms_{key}"] = sums[m]["ms"], sums[m]["bound_ms"]
        summary[f"library_ms_{key}"] = sums[m]["library_ms"]
        summary[f"plain_ms_{key}"] = sums[m]["plain_ms"]
    for m in VERIFY_M:
        summary[f"library_refused_m{m}"] = refused.get(m)
    summary["bound_by"] = "bytes" if summary.pop("bytes_bound") == 4 else "operations"
    return summary


def _k2_bound(b, h, d, rows, prefix_rows, written_rows=0):
    """(bound ms, bound_by) of flash-decode: ``rows`` lane rows read (K, V,
    both scales), the live prefix rows once, ``written_rows`` rows written
    (K2''), q in and out once, over the memory rate; against 4*H*D
    operations per attended row over the int8 peak."""
    row = 2 * h * d + 4 * h
    nbytes = (rows + prefix_rows + written_rows) * row + 2 * 4 * b * h * d
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = 4 * (rows + b * prefix_rows) * h * d / INT8_OPS_PER_S * 1e3
    return max(b_bytes, b_ops), "bytes" if b_bytes >= b_ops else "operations"


def _read_flush(torch):
    """Flush the 50 MB L2 by reading 64 MB: unlike flush(), which writes,
    it leaves no dirty lines to be written back while the next kernel
    reads."""
    buf = getattr(_read_flush, "buf", None)
    if buf is None:
        buf = _read_flush.buf = torch.zeros(16 * 1024 * 1024, device="cuda")
    buf.amax()


def _k2_repeat_plan(torch, tfd, fn, first, b, s, d, p0, flush):
    """A K2 case's second run, which must equal the first bit for bit; its
    launch plan (ops/flash_decode.py ``_plan``: splits per (head, lane),
    blocks of bs slots per split, warps, bytes and threads per head row,
    rows per warp chunk; ``_prefix_plan``); the card's own time of
    prefix_kernel and lane_kernel in fn() (torch.profiler); and fn's time
    with the L2 flushed by a read (``_read_flush``)."""
    again = fn()
    torch.cuda.synchronize()
    if not torch.equal(again, first):
        raise AssertionError(f"K2 B={b} S={s}: a second run differs bitwise")
    plan = dataclasses.asdict(tfd._plan(b, 32, d, s, tfd.default_bs(s)))
    plan["prefix_tiles"], plan["prefix_sub_tiles"] = tfd._prefix_plan(p0)
    return {"plan": plan, "bitwise_repeat": True,
            "prefix_device_ms": _device_ms(torch, fn, flush, "prefix_kernel") if p0 else None,
            "lane_device_ms": _device_ms(torch, fn, flush, "lane_kernel"),
            "read_flush_ms": timed_ms(fn, 20, lambda: _read_flush(torch))}


def _k2c_check(torch, tfd, flush, cache, q8, qs, lens, t1, step, layer, shared, p0, k2_out):
    """K2'' at slot t1 + step of ``layer``: the row is taken from the cache
    as it stands, that slot is zeroed in every layer, and the kernel attends
    the row as an operand (mask to step - 1) and writes it back. Held: the
    output within K2_TOL of the plain version and of K2 on the cache with the
    row in place (``k2_out``), the row bitwise, every other byte of the four
    buffers unchanged (against a clone). Returns the numbers."""
    b, h, d = q8.shape
    slot = t1 + step
    if slot >= cache[0].shape[2]:
        raise AssertionError(f"K2'' slot {slot} is past the cache")
    cur = [x[layer, :, slot:slot + 1].clone() for x in cache]
    for x in cache:
        x[:, :, slot] = 0
    before = [x.clone() for x in cache]
    args = (q8, qs, *cache, tfd.slot_masks(lens, t1, step - 1), layer, d ** -0.5,
            tfd.default_bs(cache[0].shape[2]))
    kw = dict(shared=shared, p0=p0, current=cur, write_cache=True)
    got = tfd.flash_decode_int8_current_kernel(*args, **kw)
    torch.cuda.synchronize()
    for x, old, c in zip(cache, before, cur):
        if not torch.equal(x[layer, :, slot], c[:, 0]):
            raise AssertionError(f"K2'' step {step}: the written row differs")
        old[layer, :, slot] = c[:, 0]
        if not torch.equal(x, old):
            raise AssertionError(f"K2'' step {step}: a byte outside the slot row changed")
    del before
    ref = tfd.flash_decode_int8_plain(*args, **kw)
    if not torch.isfinite(got).all():
        raise AssertionError(f"K2'' step {step}: non-finite output")
    torch.testing.assert_close(got, ref, **K2_TOL)
    torch.testing.assert_close(got, k2_out, **K2_TOL)
    extra = _k2_repeat_plan(torch, tfd, lambda: tfd.flash_decode_int8_current_kernel(*args, **kw),
                            got, b, cache[0].shape[2], d, p0 if shared is not None else 0, flush)
    ms = timed_ms(lambda: tfd.flash_decode_int8_current_kernel(*args, **kw), 20, flush)
    plain_ms = timed_ms(lambda: tfd.flash_decode_int8_plain(*args, **kw), 3, flush)
    # lane rows read from the cache (the slot row comes from the operand),
    # the current rows read once and written once
    rows = int(lens.long().sum()) + b * step
    bound, by = _k2_bound(b, h, d, rows + b, p0 if shared is not None else 0, written_rows=b)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "max_abs_err": float((got - ref).abs().max()),
            "max_abs_err_vs_k2": float((got - k2_out).abs().max()), **extra}


def _k2_case(torch, tfd, flush, b, s, p0, t1, steps, seed, current=(), lens=None):
    """K2 at one cache shape: lanes of t1 remainder slots (ragged, one
    empty; or the one length ``lens``), a shared prefix of p0 live rows
    padded to 32 (none at p0 = 0), decode steps ``steps``; also K2'' at the
    steps in ``current`` (``_k2c_check``). Emits one line per step; returns
    {step: numbers} and, with ``current``, {step: K2'' numbers}."""
    h, d, L, layer = 32, 128, 32, 16
    g = torch.Generator(device="cuda").manual_seed(seed)
    k8 = torch.randint(-127, 128, (L, b, s, h * d), generator=g, device="cuda", dtype=torch.int8)
    v8 = torch.randint(-127, 128, (L, b, s, h * d), generator=g, device="cuda", dtype=torch.int8)
    ks = (torch.rand((L, b, s, h), generator=g, device="cuda") * 0.01 + 0.002).to(torch.bfloat16)
    vs = (torch.rand((L, b, s, h), generator=g, device="cuda") * 0.01 + 0.002).to(torch.bfloat16)
    p0p = -(-p0 // 32) * 32
    k0 = torch.randint(-127, 128, (p0p, h * d), generator=g, device="cuda", dtype=torch.int8)
    v0 = torch.randint(-127, 128, (p0p, h * d), generator=g, device="cuda", dtype=torch.int8)
    ks0 = (torch.rand((p0p, h), generator=g, device="cuda") * 0.01 + 0.002).to(torch.bfloat16)
    vs0 = (torch.rand((p0p, h), generator=g, device="cuda") * 0.01 + 0.002).to(torch.bfloat16)
    q = torch.randn((b, h, d), generator=g, device="cuda", dtype=torch.float32)
    if lens is None:
        lens = torch.full((b,), t1, dtype=torch.int32, device="cuda")
        lens[::3] = max(t1 - 7, 1)          # ragged remainders
        lens[1] = 0                          # a lane with only its shared prefix
    else:
        lens = torch.full((b,), lens, dtype=torch.int32, device="cuda")
    q8, qs = tfd.quantize_q(q)
    shared = (k0, ks0, v0, vs0) if p0 else None
    out, out_c = {}, {}
    for step in steps:
        masks = tfd.slot_masks(lens, t1, step)
        args = (q8, qs, k8, ks, v8, vs, masks, layer, d ** -0.5, tfd.default_bs(s))
        got = tfd.flash_decode_int8_kernel(*args, shared=shared, p0=p0)
        ref = tfd.flash_decode_int8_plain(*args, shared=shared, p0=p0)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"K2 step {step}: non-finite output")
        torch.testing.assert_close(got, ref, **K2_TOL)
        err = float((got - ref).abs().max())
        extra = _k2_repeat_plan(torch, tfd,
                                lambda: tfd.flash_decode_int8_kernel(*args, shared=shared, p0=p0),
                                got, b, s, d, p0, flush)
        ms = timed_ms(lambda: tfd.flash_decode_int8_kernel(*args, shared=shared, p0=p0), 20,
                      flush)
        plain_ms = timed_ms(lambda: tfd.flash_decode_int8_plain(*args, shared=shared, p0=p0),
                            3, flush)
        # bytes this run's data needs: each lane's valid rows (prompt and
        # generated; K, V, both scales), the live prefix rows once, q in
        # and out once
        bound, by = _k2_bound(b, h, d, int(lens.long().sum()) + b * (step + 1), p0)
        out[step] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                     "max_abs_err": err, **extra}
        emit("k2", batch=b, slots=s, prefix_rows=p0p, step=step, max_abs_err=err, kernel_ms=ms,
             plain_ms=plain_ms, library_ms=None, bound_ms=bound, bound_by=by,
             roofline_share=bound / ms, **extra)
        if step in current:
            c = out_c[step] = _k2c_check(torch, tfd, flush, [k8, ks, v8, vs], q8, qs, lens, t1,
                                         step, layer, shared, p0, got)
            emit("k2", mode="current row written in place (K2'')", batch=b, prefix_rows=p0p,
                 step=step, slot=t1 + step, row_bitwise=True, rest_unchanged=True,
                 kernel_ms=c["ms"], k2_ms=ms, library_ms=None, roofline_share=c["bound_ms"] / c["ms"],
                 **{k: v for k, v in c.items() if k != "ms"})
    del k8, v8
    return (out, out_c) if current else out


def _k2c_awkward(torch, tfd, flush):
    """K2'' without a prefix at the awkward slots: one in the 64-row block
    that holds b1 (slot 83 after b1 = 82) and the cache's last slot S - 1,
    16 lanes of 384 slots."""
    h, d, L, layer, b, s, t1 = 32, 128, 4, 2, LANES, CACHE_LEN, 80
    g = torch.Generator(device="cuda").manual_seed(7)
    cache = [torch.randint(-127, 128, (L, b, s, h * d), generator=g, device="cuda",
                           dtype=torch.int8) if i % 2 == 0 else
             (torch.rand((L, b, s, h), generator=g, device="cuda") * 0.01 + 0.002
              ).to(torch.bfloat16) for i in range(4)]          # k8, ks, v8, vs
    q8, qs = tfd.quantize_q(torch.randn((b, h, d), generator=g, device="cuda"))
    lens = torch.randint(1, t1 + 1, (b,), generator=g, device="cuda", dtype=torch.int32)
    worst = 0.0
    for step in (3, s - 1 - t1):
        k2_out = tfd.flash_decode_int8_kernel(q8, qs, *cache, tfd.slot_masks(lens, t1, step),
                                              layer, d ** -0.5, tfd.default_bs(s))
        c = _k2c_check(torch, tfd, flush, cache, q8, qs, lens, t1, step, layer, None, 0, k2_out)
        emit("k2", mode="current row written in place (K2''), no prefix", batch=b,
             step=step, slot=t1 + step, row_bitwise=True, rest_unchanged=True,
             kernel_ms=c["ms"], library_ms=None, **{k: v for k, v in c.items() if k != "ms"})
        worst = max(worst, c["max_abs_err"])
    return worst


def _k2_ring_case(torch, tfd, flush):
    """K2 with the serving ring's per-lane closed slot intervals and no
    shared prefix, at the serve phase's cache shape: 16 lanes of 384 slots,
    prompt region [0, 256), ring [256, 384). Lane 0: a window inside the
    ring; 1: a wrapped window, both intervals live, with a dead gap of a
    former session's rows between its prompt and the ring; 2: a full ring;
    3: no session, no valid slot (zeros expected); 4: a prompt that fills the
    prompt region; the rest: windows of 1-120 writes ending at ring position
    70, some wrapped."""
    h, d, L, layer = 32, 128, 32, 16
    b, s, p, ring = LANES, CACHE_LEN, PROMPT_REGION, CACHE_LEN - PROMPT_REGION
    g = torch.Generator(device="cuda").manual_seed(6)
    k8 = torch.randint(-127, 128, (L, b, s, h * d), generator=g, device="cuda", dtype=torch.int8)
    v8 = torch.randint(-127, 128, (L, b, s, h * d), generator=g, device="cuda", dtype=torch.int8)
    ks = (torch.rand((L, b, s, h), generator=g, device="cuda") * 0.01 + 0.002).to(torch.bfloat16)
    vs = (torch.rand((L, b, s, h), generator=g, device="cuda") * 0.01 + 0.002).to(torch.bfloat16)
    q = torch.randn((b, h, d), generator=g, device="cuda", dtype=torch.float32)
    from radialog_tpu_torch.decode.continuous import ring_intervals
    lens = torch.randint(100, 257, (b,), generator=g, device="cuda", dtype=torch.int32)
    e = 70
    writes = torch.randint(1, 121, (b,), generator=g, device="cuda", dtype=torch.int32)
    writes[0], writes[1], writes[2], lens[4] = 31, 100, ring, p
    lens[3], writes[3] = 0, 0
    a1, b1, a2, b2 = ring_intervals(writes, e, p, ring)
    assert int(b2[1]) == s - 1 and int(b2[0]) == -1 and int(a2[2]) == p + e + 1
    q8, qs = tfd.quantize_q(q)
    masks = tfd.slot_masks(lens, gen_intervals=(a1, b1, a2, b2))
    args = (q8, qs, k8, ks, v8, vs, masks, layer, d ** -0.5, tfd.default_bs(s))
    got = tfd.flash_decode_int8_kernel(*args)
    ref = tfd.flash_decode_int8_plain(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all() or bool((got[3] != 0).any()):
        raise AssertionError("K2 intervals: a lane with no valid slot must give zeros")
    torch.testing.assert_close(got, ref, **K2_TOL)
    err = float((got - ref).abs().max())
    extra = _k2_repeat_plan(torch, tfd, lambda: tfd.flash_decode_int8_kernel(*args), got, b, s,
                            d, 0, flush)
    ms = timed_ms(lambda: tfd.flash_decode_int8_kernel(*args), 20, flush)
    plain_ms = timed_ms(lambda: tfd.flash_decode_int8_plain(*args), 3, flush)
    # bytes this run's data needs: each lane's valid rows (K, V, both
    # scales), q in and out once
    pos = torch.arange(s, device="cuda")[None]
    lm, m1, n1, m2, n2 = (x[:, None] for x in masks)
    rows = int(((pos < lm) | ((pos >= m1) & (pos <= n1)) | ((pos >= m2) & (pos <= n2))).sum())
    b_bytes = (rows * (2 * h * d + 4 * h) + 2 * 4 * b * h * d) / HBM_BYTES_PER_S * 1e3
    b_ops = 4 * rows * h * d / INT8_OPS_PER_S * 1e3
    out = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(b_bytes, b_ops),
           "bound_by": "bytes" if b_bytes >= b_ops else "operations", "max_abs_err": err,
           **extra}
    emit("k2", mode="ring intervals", batch=b, slots=s, valid_rows=rows,
         bs=tfd.default_bs(s), max_abs_err=err, kernel_ms=ms, plain_ms=plain_ms,
         library_ms=None, bound_ms=out["bound_ms"], bound_by=out["bound_by"],
         roofline_share=out["bound_ms"] / ms, **extra)
    return out


def phase_k2(torch, tfd, flush):
    """The report path's decode shape (B=56, P0=48), the binary-QA pass's
    (14 lanes of one study, the whole 427-token history in the prefix, a
    10-token answer in a 128-slot cache), the correction pass's (one lane,
    no prefix, 768 slots) and the serving ring's (per-lane intervals).
    Returns the summaries of the static-slot and the interval mode."""
    report, current = _k2_case(torch, tfd, flush, BATCH, 384, SHARED, PROMPT - SHARED,
                               (0, 150, NEW - 2, NEW - 1), seed=2, current=(0, 150, NEW - 2))
    qa = _k2_case(torch, tfd, flush, 14, 128, 427, 8, (0, 9), seed=4)
    summary = dict(report[150])
    summary["max_abs_err"] = max(r["max_abs_err"] for r in [*report.values(), *qa.values()])
    for key in ("ms", "plain_ms", "bound_ms", "prefix_device_ms", "lane_device_ms",
                "read_flush_ms"):
        summary[f"{key}_qa"] = qa[9][key]
    # the eval CLI's batch-1 correction decode: one lane, no prefix, a
    # 437-token prompt padded to 440 slots in a 768-slot cache, steps 0,
    # 128 and 255: 12 blocks of 64 slots over the plan's splits of one
    # cluster (32 heads on 132 SMs)
    corr = _k2_case(torch, tfd, flush, 1, CORR_S, 0, CORR_T, (0, 128, CORR_NEW - 1), seed=8,
                    lens=CORR_LEN)
    summary["max_abs_err"] = max(summary["max_abs_err"], *(c["max_abs_err"] for c in corr.values()))
    for key in ("ms", "plain_ms", "bound_ms", "lane_device_ms", "plan"):
        summary[f"{key}_correction"] = corr[128][key]
    ring = _k2_ring_case(torch, tfd, flush)
    summary_c = dict(current[150])
    summary_c["max_abs_err"] = max(_k2c_awkward(torch, tfd, flush),
                                   *(c["max_abs_err"] for c in current.values()))
    _read_flush.buf = None
    return summary, ring, summary_c


def _k4_bound(m, k, n, groups, asym):
    """(bound ms, what bounds it) of one K4 call: the activations, the packed
    weight, the scales (and offsets) and the f32 output moved once, against
    2 M N K int8 operations."""
    nbytes = m * k + n * k // 2 + 4 * groups * n * (2 if asym else 1) + 4 * m * n
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = 2 * m * n * k / INT8_OPS_PER_S * 1e3
    return max(b_bytes, b_ops), "bytes" if b_bytes >= b_ops else "operations"


def phase_k4(torch, tq4, flush):
    """K4 at every W4A8 layer shape of Vicuna-7B, on both grids, at the
    serve phase's decode rows (16), the report batch's (56) and a prefill's
    (256); then the mock model's shapes. Held bitwise: each group's integer
    sum is exact, and kernel and plain version add the groups in K order
    with one rounded f32 multiply and add each, also where K is split (the
    last block of a tile adds the splits' group terms in order); each case
    runs twice, bitwise equal. Each line names the route and the launch
    plan (ops/q4_matmul.py _plan) and times the call by CUDA events and, at
    the Vicuna shapes, the kernel on the card's clock (torch.profiler). No
    single PyTorch call computes this function, so library_ms is null. The
    summary is one decoder layer's four projections at M = 16 on the
    asymmetric grid, with the same at M = 56 and 256."""
    h, inter = 4096, 11008
    shapes = {"wqkv": (h, 3 * h), "wo": (h, h), "gateup": (h, 2 * inter), "down": (inter, h)}
    tiny = {"tiny_wqkv": (64, 192), "tiny_gateup": (64, 256), "tiny_down": (128, 64)}
    g = torch.Generator(device="cuda").manual_seed(8)
    layer = {m: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_bound": 0}
             for m in (16, 56, 256)}
    worst = 0.0
    for name, (k, n) in {**shapes, **tiny}.items():
        bk = tq4.pick_bk(k)
        group = tq4.GROUP if bk % tq4.GROUP == 0 else bk
        groups = -(-k // bk) * bk // group
        w = torch.randint(-128, 128, (n, k // 2), generator=g, device="cuda", dtype=torch.int8)
        gscale = (torch.rand((groups, n), generator=g, device="cuda") + 0.5) / (4.6 * k ** 0.5)
        offsets = (torch.rand((groups, n), generator=g, device="cuda") - 0.5) * gscale
        for mode, goff in (("asym", offsets), ("sym", None)):
            for m in (16, 56, 256):
                x8 = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                                   dtype=torch.int8)
                got = tq4.q4_matmul_acc(x8, w, gscale, goff, group)
                again = tq4.q4_matmul_acc(x8, w, gscale, goff, group)
                ref = tq4.q4_matmul_acc_plain(x8, w, gscale, goff, group)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                if not torch.isfinite(got).all() or err != 0.0 or not torch.equal(got, again):
                    raise AssertionError(f"K4 {name} {mode} M={m}: differs from plain by {err} "
                                         f"or from its second run")
                worst = max(worst, err)

                def fn():
                    return tq4.q4_matmul_acc(x8, w, gscale, goff, group)
                ms = timed_ms(fn, 20, flush)
                dev_ms = None
                for _ in range(3 if name in shapes else 0):   # the profiler may catch nothing
                    dev_ms = _device_ms(torch, fn, flush, "q4_tma_kernel")
                    if dev_ms == dev_ms:
                        break
                plain_ms = timed_ms(
                    lambda: tq4.q4_matmul_acc_plain(x8, w, gscale, goff, group), 3, flush)
                bound, by = _k4_bound(m, k, n, groups, goff is not None)
                plan = tq4._plan(m, n, k, group, goff is not None)
                emit("k4", weight=name, mode=mode, m=m, k=k, n=n, group=group, bitwise=True,
                     repeat_bitwise=True, route="tma", plan=dataclasses.asdict(plan),
                     max_abs_err=err, kernel_ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                     library_ms=None, bound_ms=bound, bound_by=by, roofline_share=bound / ms)
                if mode == "asym" and name in shapes:
                    x = layer[m]
                    x["ms"] += ms
                    x["device_ms"] += dev_ms
                    x["plain_ms"] += plain_ms
                    x["bound_ms"] += bound
                    x["bytes_bound"] += by == "bytes"
        del w
    for m, x in layer.items():
        x["bound_by"] = "bytes" if x.pop("bytes_bound") == 4 else "operations"
        emit("k4", layer_sum=f"one layer's 4 projections at M={m}, asym",
             roofline_share=x["bound_ms"] / x["ms"], **x)
    summary = dict(layer[LANES], max_abs_err=worst)
    if summary["device_ms"] != summary["device_ms"]:
        summary["device_ms"] = None           # not measured: no NaN in the kernels line
    for m in (56, 256):
        summary[f"ms_m{m}"], summary[f"bound_ms_m{m}"] = layer[m]["ms"], layer[m]["bound_ms"]
    return summary


def _k3_bound(b, t, h, d, lens, elt, ops_per_s):
    """(bound ms, bound_by) of causal attention: q, k, v read once and out
    written once over the memory rate, against 4*H*D operations per valid
    (query, key) pair of these lengths over the peak of the type."""
    nbytes = 4 * b * t * h * d * elt
    # query i attends keys j < n with j <= i
    pairs = sum(min(i + 1, min(int(n), t)) for n in lens for i in range(t))
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = 4 * h * d * pairs / ops_per_s * 1e3
    return max(b_bytes, b_ops), "bytes" if b_bytes >= b_ops else "operations"


def phase_k3(torch, tfa, flush):
    """Square shapes; the serve phase's admission of a 230-token prompt in
    its 256-row bucket (a partial last key tile, query rows past the
    length); and the qa phase's own: the binary-QA prefix (431 tokens) and
    the batch-1 follow-up (436), both ending in a partial 64-row tile, and
    the eval CLI's correction prefills (437 of 440 and 445 of 448 rows),
    with q/k/v read as views of one fused (B, T, 3*H*D) projection:
    the strided route, stricter than the dense q/k/v the eval run's
    cache-free prefill hands over (phase eval holds those); and the float
    path's own, q/k/v contiguous: its binary-QA batch (14 prompts of
    431-440 tokens in 440 rows) and its correction prefill (437 of 440)."""
    shapes = [(1, 256, 32, 128, "bfloat16", False, False),
              (1, 256, 32, 128, "bfloat16", [230], True),
              (1, 448, 32, 128, "bfloat16", False, False),
              (1, 1024, 32, 128, "bfloat16", False, False),
              (12, 448, 32, 128, "bfloat16", True, False),
              (1, 431, 32, 128, "bfloat16", False, True),
              (1, 436, 32, 128, "bfloat16", False, True),
              (1, CORR_T, 32, 128, "bfloat16", [CORR_LEN], True),
              (1, CORR_T2, 32, 128, "bfloat16", [CORR_LEN2], True),
              (FLOAT_QA_B, FLOAT_QA_T, 32, 128, "bfloat16", FLOAT_QA_LENS, False),
              (1, CORR_T, 32, 128, "bfloat16", [CORR_LEN], False),
              (2, CUTOFF, 32, 128, "bfloat16", [CUTOFF, 413], False),
              (2, 300, 4, 16, "float32", True, False)]
    f = torch.nn.functional
    summary, train, worst, extra = None, None, 0.0, {}
    for i, (b, t, h, d, dt, ragged, fused) in enumerate(shapes):
        dtype = getattr(torch, dt)
        g = torch.Generator(device="cuda").manual_seed(30 + i)
        if fused:
            qkv = torch.randn((b, t, 3 * h * d), generator=g, device="cuda").to(dtype)
            q, k, v = (x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=-1))
            assert not any(x.is_contiguous() for x in (q, k, v))
        else:
            q, k, v = (torch.randn((b, t, h, d), generator=g, device="cuda").to(dtype)
                       for _ in range(3))
        lens = torch.full((b,), t, dtype=torch.int32, device="cuda")
        if isinstance(ragged, list):
            lens = torch.tensor(ragged, dtype=torch.int32, device="cuda")
        elif ragged:
            lens = torch.randint(t * 2 // 3, t + 1, (b,), generator=g, device="cuda",
                                 dtype=torch.int32)
        got = tfa.flash_attention_kernel(q, k, v, lens)
        ref = tfa.flash_attention_plain(q, k, v, lens)
        spread = float((tfa.flash_attention_plain(q, k, v, lens, bk=64).float()
                        - ref.float()).abs().max())
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"K3 {b}x{t}: non-finite output")
        torch.testing.assert_close(got.float(), ref.float(), **K3_TOL[dt])
        err = float((got.float() - ref.float()).abs().max())
        worst = max(worst, err)
        pos = torch.arange(t, device="cuda")
        mask = ((pos[None, :] <= pos[:, None])[None]
                & (pos[None, None, :] < lens[:, None, None].long()))[:, None]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = timed_ms(lambda: tfa.flash_attention_kernel(q, k, v, lens), 20, flush)
        route = tfa._route(dtype, d)
        plain_ms = timed_ms(lambda: tfa.flash_attention_plain(q, k, v, lens), 3, flush)
        lib_ms = timed_ms(lambda: f.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
                          20, flush)
        bound, by = _k3_bound(b, t, h, d, lens.tolist(), q.element_size(),
                              BF16_OPS_PER_S if dt == "bfloat16" else F32_OPS_PER_S)
        emit("k3", batch=b, t=t, heads=h, head_dim=d, dtype=dt, fused_qkv_views=fused,
             lengths=[int(x) for x in lens.tolist()], route=route,
             grid=list(tfa._grid(b, t, h, route)), max_abs_err=err, tol=K3_TOL[dt],
             plain_block_spread=spread, kernel_ms=ms, plain_ms=plain_ms,
             library_ms=lib_ms, bound_ms=bound, bound_by=by, roofline_share=bound / ms)
        if (b, t, dt) == (1, 431, "bfloat16"):
            # the binary-QA prefix prefill, one layer
            summary = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": bound, "bound_by": by}
        if (b, t, dt) == (2, CUTOFF, "bfloat16"):
            train = {"ms_train": ms, "library_ms_train": lib_ms, "bound_ms_train": bound}
        for key, where in (("correction", (1, CORR_T, True)),
                           ("float_qa", (FLOAT_QA_B, FLOAT_QA_T, False)),
                           ("float_correction", (1, CORR_T, False))):
            if (b, t, fused) == where and dt == "bfloat16":
                extra[key] = {f"ms_{key}": ms, f"plain_ms_{key}": plain_ms,
                              f"library_ms_{key}": lib_ms, f"bound_ms_{key}": bound}
    summary["max_abs_err"] = worst
    summary.update(train)
    for numbers in extra.values():
        summary.update(numbers)
    return summary


def _k5_bounds(b, t, s, h, d, lens, causal, elt, ops_per_s):
    """(bound ms, bound_by) of K5a, of K5b and of the whole backward: q, do
    and the f32 row statistics read once, k and v read once up to each
    lane's length (no query attends a later key), dq (K5a) or dk and dv
    (K5b) written once, over the memory rate, against 6*H*D (K5a: q.k, do.v,
    ds.k) or 8*H*D (K5b: k.q, v.do, p.do, ds.q) operations per valid (query,
    key) pair of these lengths over the peak of the type. The whole
    backward reads out too and writes all three gradients, and needs 10*H*D
    operations a pair (s, dp, dv, dk, dq: FA2's five products)."""
    pairs = sum(min(i + 1, min(int(n), s)) if causal else min(int(n), s)
                for n in lens for i in range(t))
    kv_rows = sum(min(int(n), s) for n in lens)
    out = []
    for q_side, kv_out, stats, per_pair in ((3, 0, 2, 6), (2, 2, 2, 8), (4, 2, 1, 10)):
        # q-side tensors (q, do, out, dq) of T rows, dk and dv of S rows, the
        # f32 statistics (lse, delta) of T rows
        b_bytes = ((q_side * b * t + 2 * kv_rows + kv_out * b * s) * h * d * elt
                   + stats * 4 * b * h * t) / HBM_BYTES_PER_S * 1e3
        b_ops = per_pair * h * d * pairs / ops_per_s * 1e3
        out.append((max(b_bytes, b_ops), "bytes" if b_bytes >= b_ops else "operations"))
    return out


def _k5_check(torch, name, got, want, want64, lens, dt, what):
    """(err, largest, err of largest, plain block spread) of one gradient;
    raises past K5_TOL, on a non-finite value, or on a non-zero row of dk/dv
    past a lane's length (dq of a dead lane too)."""
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"K5 {what}: non-finite {name}")
    largest = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    spread = float((want64.float() - want.float()).abs().max()) / largest
    if err / largest > K5_TOL[dt]:
        raise AssertionError(f"K5 {what}: {name} differs from plain by {err} (largest value "
                             f"{largest})")
    for j, n in enumerate(lens):     # rows past the length, a dead lane
        if (name != "dq" and bool(got[j, n:].any())) or (n == 0 and bool(got[j].any())):
            raise AssertionError(f"K5 {what}: lane {j} of length {n} must give zeros in {name}")
    return err, largest, err / largest, spread


def phase_k5(torch, tfa, flush):
    """K5a and K5b on K3's own out and lse, as autograd hands them over. The
    summary is one layer of the train phase: B=2, T=S=600, lengths 600 and
    413, bf16, q/k/v contiguous (the stacked layout projects them apart).
    The case with q scaled by 3 has peaked attention: a few keys carry a
    row's gradient, so a kernel that lost a key tile would miss by far more
    than the tolerance. Each case holds K5a (given delta) and K5b, and the
    whole backward (on the TMA route K5a computes delta itself), to the plain
    versions, each twice and bitwise equal; it times the kernels, the whole
    backward, the PyTorch delta alone and SDPA's whole backward. The TMA
    route's boundary cases: T of 1 (64 or 129 keys), 63, 65, 127 and 129
    with and without causal masking (one row short of and past one and two
    64-row tiles), T = 431 (lse rows not 16-byte aligned), D = 64. T = 1
    is non-causal only: causal, its one query attends key 0 alone, p = 1
    and dq = dk = 0 exactly, so both versions give the rounding noise of
    dp - delta and a relative check says nothing."""
    # b, t, h, d, dtype, causal, lengths, q/k/v fused views, q scale, keys (None: t)
    shapes = [(2, CUTOFF, 32, 128, "bfloat16", True, [CUTOFF, 413], False, 1.0, None),
              (2, CUTOFF, 32, 128, "bfloat16", True, [CUTOFF, 413], True, 1.0, None),
              (2, CUTOFF, 32, 128, "bfloat16", True, [CUTOFF, 413], False, 3.0, None),
              (1, 256, 32, 128, "bfloat16", True, None, False, 1.0, None),
              (2, 300, 32, 128, "bfloat16", True, [0, 300], True, 1.0, None),
              (2, 200, 32, 128, "bfloat16", False, [200, 77], True, 1.0, None),
              (1, 1, 8, 128, "bfloat16", False, [64], False, 1.0, 64),
              *[(2, t, 8, 128, "bfloat16", causal, [t, t // 2 + 1], True, 3.0, None)
                for t in (63, 65, 127, 129) for causal in (True, False)],
              (1, 431, 32, 128, "bfloat16", True, None, True, 1.0, None),
              (2, CUTOFF, 32, 64, "bfloat16", True, [CUTOFF, 413], False, 1.0, None),
              (3, 200, 8, 64, "bfloat16", False, [200, 77, 131], True, 3.0, None),
              (1, 1, 4, 64, "bfloat16", False, [50], True, 1.0, 129),
              (2, CUTOFF, 32, 128, "float32", True, [CUTOFF, 413], False, 1.0, None),
              (2, 300, 4, 16, "float32", True, [300, 211], True, 1.0, None),
              (2, 300, 4, 16, "bfloat16", True, [300, 211], True, 1.0, None)]
    f = torch.nn.functional
    summary, worst = None, {"dq": 0.0, "dkv": 0.0}
    for i, (b, t, h, d, dt, causal, lens_list, fused, q_scale, s) in enumerate(shapes):
        s = s or t
        dtype = getattr(torch, dt)
        what = f"{b}x{t}x{s} h{h} d{d} {dt} causal={causal} q*{q_scale}"
        g = torch.Generator(device="cuda").manual_seed(50 + i)
        if fused and s == t:
            qkv = torch.randn((b, t, 3 * h * d), generator=g, device="cuda")
            qkv[..., :h * d] *= q_scale
            qkv = qkv.to(dtype)
            q, k, v = (x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=-1))
            assert not any(x.is_contiguous() for x in (q, k, v))
        elif fused:     # k and v as views of one fused projection of S rows
            q = (torch.randn((b, t, h, d), generator=g, device="cuda") * q_scale).to(dtype)
            kv = torch.randn((b, s, 2 * h * d), generator=g, device="cuda").to(dtype)
            k, v = (x.reshape(b, s, h, d) for x in kv.split(h * d, dim=-1))
        else:
            q = torch.randn((b, t, h, d), generator=g, device="cuda")
            k, v = (torch.randn((b, s, h, d), generator=g, device="cuda") for _ in range(2))
            q, k, v = (q * q_scale).to(dtype), k.to(dtype), v.to(dtype)
        do = torch.randn((b, t, h, d), generator=g, device="cuda").to(dtype)
        lens = torch.tensor(lens_list or [s] * b, dtype=torch.int32, device="cuda")
        lens_l = [min(int(n), s) for n in lens.tolist()]
        out, lse = tfa.flash_attention_kernel(q, k, v, lens, causal=causal, with_lse=True)
        delta = tfa._delta(out, do)
        args = (q, k, v, lens, lse, delta, do, causal, None)
        bwd_args = (q, k, v, lens, out, lse, do, causal, None)
        dq = tfa.flash_attention_dq_kernel(*args)
        dk, dv = tfa.flash_attention_dkv_kernel(*args)
        whole = tfa.flash_attention_bwd_kernel(*bwd_args)
        dq2 = tfa.flash_attention_dq_kernel(*args)
        dk2, dv2 = tfa.flash_attention_dkv_kernel(*args)
        whole2 = tfa.flash_attention_bwd_kernel(*bwd_args)
        torch.cuda.synchronize()
        if not (torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
                and all(torch.equal(x, y) for x, y in zip(whole, whole2))):
            raise AssertionError(f"K5 {what}: a second run differs from the first")
        ref = (tfa.flash_attention_dq_plain(*args), *tfa.flash_attention_dkv_plain(*args))
        ref64 = (tfa.flash_attention_dq_plain(*args, bq=64, bk=64),
                 *tfa.flash_attention_dkv_plain(*args, bq=64, bk=64))
        errs, spread, largest, rel, whole_rel = {}, {}, {}, {}, {}
        for name, got, want, want64, w in zip(("dq", "dk", "dv"), (dq, dk, dv), ref, ref64,
                                              whole):
            errs[name], largest[name], rel[name], spread[name] = _k5_check(
                torch, name, got, want, want64, lens_l, dt, what)
            whole_rel[name] = _k5_check(torch, name, w, want, want64, lens_l, dt,
                                        what + " whole backward")[2]
        worst["dq"] = max(worst["dq"], errs["dq"])
        worst["dkv"] = max(worst["dkv"], errs["dk"], errs["dv"])
        route = tfa._bwd_route(dtype, d)
        pos_q, pos_k = torch.arange(t, device="cuda"), torch.arange(s, device="cuda")
        mask = (pos_k[None, None, :] < lens[:, None, None].long()).expand(b, t, s)
        if causal:
            mask = mask & (pos_k[None, :] <= pos_q[:, None])[None]
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
        lib_out = f.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None])
        dot = do.transpose(1, 2)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)

        if i == 0:
            # the phase's first timed run can read 3x slow (K5a 0.124 against
            # 0.041 ms on an H100 at 700 W, after phase k4): spend it on a
            # throwaway
            timed_ms(lambda: tfa.flash_attention_dq_kernel(*args), 20, flush)
        dq_ms = timed_ms(lambda: tfa.flash_attention_dq_kernel(*args), 20, flush)
        dkv_ms = timed_ms(lambda: tfa.flash_attention_dkv_kernel(*args), 20, flush)
        bwd_ms = timed_ms(lambda: tfa.flash_attention_bwd_kernel(*bwd_args), 20, flush)
        delta_ms = timed_ms(lambda: tfa._delta(out, do), 20, flush)
        dq_plain_ms = timed_ms(lambda: tfa.flash_attention_dq_plain(*args), 3, flush)
        dkv_plain_ms = timed_ms(lambda: tfa.flash_attention_dkv_plain(*args), 3, flush)
        lib_ms = timed_ms(lib_bwd, 20, flush)
        (dq_bound, dq_by), (dkv_bound, dkv_by), (bwd_bound, bwd_by) = _k5_bounds(
            b, t, s, h, d, lens.tolist(), causal, q.element_size(),
            BF16_OPS_PER_S if dt == "bfloat16" else F32_OPS_PER_S)
        line = dict(batch=b, t=t, s=s, heads=h, head_dim=d, dtype=dt, causal=causal,
                    fused_qkv_views=fused, q_scale=q_scale,
                    lengths=[int(x) for x in lens.tolist()], route=route,
                    dq_grid=list(tfa._bwd_grid("dq", b, t, s, h, route)),
                    dkv_grid=list(tfa._bwd_grid("dkv", b, t, s, h, route)),
                    blocks_per_sm=({k: tfa._bwd_blocks_per_sm(k, d) for k in ("dq", "dkv")}
                                   if route == "tma" else None),
                    max_abs_err=errs, largest_gradient=largest, err_of_largest=rel,
                    whole_backward_err_of_largest=whole_rel, tol_of_largest=K5_TOL[dt],
                    plain_block_spread_of_largest=spread, bitwise_repeat=True,
                    dq_kernel_ms=dq_ms, dkv_kernel_ms=dkv_ms, whole_backward_ms=bwd_ms,
                    delta_ms=delta_ms,
                    delta_share_unfolded=delta_ms / (delta_ms + dq_ms + dkv_ms),
                    dq_plain_ms=dq_plain_ms, dkv_plain_ms=dkv_plain_ms,
                    library_backward_ms=lib_ms, dq_bound_ms=dq_bound, dq_bound_by=dq_by,
                    dkv_bound_ms=dkv_bound, dkv_bound_by=dkv_by, whole_bound_ms=bwd_bound,
                    whole_bound_by=bwd_by, dq_roofline_share=dq_bound / dq_ms,
                    dkv_roofline_share=dkv_bound / dkv_ms,
                    whole_roofline_share=bwd_bound / bwd_ms)
        if i == 0:
            # the card's own clock (torch.profiler), like for like
            line["device_ms"] = {
                "dq": _device_ms(torch, lambda: tfa.flash_attention_dq_kernel(*args), flush,
                                 "dq_"),
                "dkv": _device_ms(torch, lambda: tfa.flash_attention_dkv_kernel(*args), flush,
                                  "dkv_"),
                "whole_backward": _device_total_ms(
                    torch, lambda: tfa.flash_attention_bwd_kernel(*bwd_args), flush),
                "delta": _device_total_ms(torch, lambda: tfa._delta(out, do), flush),
                "library_backward": _device_total_ms(torch, lib_bwd, flush)}
            summary = {"dq": {"ms": dq_ms, "plain_ms": dq_plain_ms, "bound_ms": dq_bound,
                              "bound_by": dq_by, "library_ms": lib_ms, "launch_route": route,
                              "whole_backward_ms": bwd_ms, "whole_bound_ms": bwd_bound,
                              "delta_ms": delta_ms},
                       "dkv": {"ms": dkv_ms, "plain_ms": dkv_plain_ms, "bound_ms": dkv_bound,
                               "bound_by": dkv_by, "library_ms": lib_ms, "launch_route": route}}
        emit("k5", **line)
    summary["dq"]["max_abs_err"], summary["dkv"]["max_abs_err"] = worst["dq"], worst["dkv"]
    return summary


def _device_ms(torch, fn, flush, key: str, n: int = 10) -> float:
    """The card's own time of the kernels of fn() whose names hold ``key``,
    from torch.profiler: the median over n runs, each after flush()."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush()
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == DeviceType.CUDA and key in e.name]
    return statistics.median(times) if times else float("nan")


def _device_total_ms(torch, fn, flush, n: int = 10) -> float:
    """The card's own time of every kernel of fn() (the flush's fill not
    counted), from torch.profiler: the total over n runs, each after
    flush(), divided by n."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush()
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
               if e.device_type == DeviceType.CUDA and "FillFunctor" not in e.name) / n


def _w4_breakdown(torch, tw, weights, shapes, g, flush):
    """What a T2/T3 layer time at M = 32 holds besides the kernels' reading:
    CUDA events around an empty call; the same layer with the L2 flushed by
    a read (the default flush writes 64 MB, and the dirty lines it leaves
    are written back while the kernel reads its weight); the card's own
    kernel time (torch.profiler); torch._int_mm beside each, and a PyTorch
    reduction that only reads the packed weights (amax of their bytes as
    f32) as the yardstick of reading those bytes at all."""
    rbuf = torch.zeros(64 * 1024 * 1024 // 4, device="cuda")

    def read_flush():
        rbuf.amax()

    row = {"empty_event_ms": timed_ms(lambda: None, 20, flush)}
    keys = ("T2", "T3", "int_mm", "read_w")
    row.update({f"{key}_{what}": 0.0 for key in keys
                for what in ("ms", "read_flush_ms", "device_ms")})
    for wname, (k, n) in shapes.items():
        w = weights[wname].w
        codes = tw.unpack_q4(w)
        x8 = torch.randint(-127, 128, (32, k), generator=g, device="cuda", dtype=torch.int8)
        xlo, xhi = tw.split_even_odd(x8)
        wf = w.view(torch.float32)
        for key, fn, kernel in (("T2", lambda: tw.w4_int32_split(xlo, xhi, w), "w4_tma_kernel"),
                                ("T3", lambda: tw.w4_int32(x8, w), "w4_tma_kernel"),
                                ("int_mm", lambda: torch._int_mm(x8, codes.t()), "gemm"),
                                ("read_w", lambda: wf.amax(), "reduce")):
            row[f"{key}_ms"] += timed_ms(fn, 20, flush)
            row[f"{key}_read_flush_ms"] += timed_ms(fn, 20, read_flush)
            row[f"{key}_device_ms"] += _device_ms(torch, fn, flush, kernel)
        del codes
    emit("tproto", breakdown="one layer's 4 projections at M=32", **row)


def phase_tproto(torch, tfd, tw, flush):
    """The prototypes of the TPU microbench tools at their tools' shapes.
    T1 (fused k|v flash-decode) at tools/microbench_kvfused.py's defaults
    (B=56, S=384, prompt pad 128, step 150, bs 64, 8 layers): bitwise equal
    to K2 on the same data and within K2_TOL of its plain version, timed
    beside K2. T2 and T3 (per-column W4A8, exact int32) bitwise equal to the
    plain product at the four Vicuna-7B projection shapes at M = 32 (the
    tool's decode rows), 5, 1, 16, 64 and 256, each line naming its launch
    plan, timed against the byte bound and against torch._int_mm on the
    codes widened to int8; at M = 32 and 5 the plan is timed beside 64 and
    128 weight rows a block everywhere and beside no K split, and the M = 32 layer is
    timed with a read as the L2 flush and by the profiler's device time
    (``_w4_breakdown``). Then each tool's chain
    (T1: the 8 layer calls; T2, T3: 32 layers of the four projections, one
    distinct layer cycled) with the launch counts that the kernels line
    reports. Returns the summaries of T1, T2 and T3."""
    b, s, h, d, L, pp, st, bs = BATCH, 384, 32, 128, 8, 128, 150, 64
    g = torch.Generator(device="cuda").manual_seed(13)
    shape = (L, b, s, h * d)
    k8 = torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)
    v8 = torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)
    ks = (torch.rand(shape[:3] + (h,), generator=g, device="cuda") * 0.02).to(torch.bfloat16)
    vs = (torch.rand(shape[:3] + (h,), generator=g, device="cuda") * 0.02).to(torch.bfloat16)
    kv8, kvs = torch.cat([k8, v8], dim=-1), torch.cat([ks, vs], dim=-1)
    q = torch.randn((L, b, h, d), generator=g, device="cuda")
    lens = torch.full((b,), pp, dtype=torch.int32, device="cuda")
    masks = tfd.slot_masks(lens, pp, st)
    q8, qs = tfd.quantize_q(q[0])
    t1_args = (q8, qs, kv8, kvs, masks, 0, d ** -0.5, bs)
    k2_args = (q8, qs, k8, ks, v8, vs, masks, 0, d ** -0.5, bs)
    got = tfd.flash_decode_int8_fused_kernel(*t1_args)
    k2 = tfd.flash_decode_int8_kernel(*k2_args)
    ref = tfd.flash_decode_int8_fused_plain(*t1_args)
    torch.cuda.synchronize()
    if not torch.equal(got, k2):
        raise AssertionError("T1 differs from K2 on the same data")
    torch.testing.assert_close(got, ref, **K2_TOL)
    t1 = {"ms": timed_ms(lambda: tfd.flash_decode_int8_fused_kernel(*t1_args), 20, flush),
          "k2_ms": timed_ms(lambda: tfd.flash_decode_int8_kernel(*k2_args), 20, flush),
          "plain_ms": timed_ms(lambda: tfd.flash_decode_int8_fused_plain(*t1_args), 3, flush),
          "library_ms": None, "max_abs_err": float((got - ref).abs().max())}
    t1["bound_ms"], t1["bound_by"] = _k2_bound(b, h, d, b * (pp + st + 1), 0)
    tfd.flash_decode_int8_fused_kernel.launches = 0
    for i in range(L):                      # the tool's chain of layer calls
        tfd.flash_decode_int8_fused(q[i], kv8, kvs, lens, pp, st, layer_idx=i, bs=bs)
    torch.cuda.synchronize()
    t1["launches"] = tfd.flash_decode_int8_fused_kernel.launches
    emit("tproto", kernel="T1", batch=b, cache=s, prompt_pad=pp, step=st, bs=bs,
         bitwise_equal_to_k2=True, roofline_share=t1["bound_ms"] / t1["ms"], **t1)
    del k8, v8, ks, vs, kv8, kvs

    shapes = {"wqkv": (4096, 3 * 4096), "wo": (4096, 4096), "gateup": (4096, 2 * 11008),
              "down": (11008, 4096)}
    rows_m, summed = (32, 5, 1, 16, 64, 256), (32, 5, 256)
    sums = {(name, m): {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                        "library_ms": 0.0 if m > 16 else None, "bytes_bound": 0}
            for name in ("T2", "T3") for m in summed}
    # the plan against the same kernel with 64 or 128 weight rows a block
    # everywhere and with no K split, at the tool's decode rows and at M = 5:
    # layer sums of kernel ms
    sweep = {(name, m, cfg): 0.0 for name in ("T2", "T3") for m in (32, 5)
             for cfg in ("plan", "rows64", "rows128", "nosplit")}
    weights = {}
    for wname, (k, n) in shapes.items():
        w = weights[wname] = tw.random_q4c(k, n, g, "cuda")
        codes = tw.unpack_q4(w.w)                        # (N, K) int8, for _int_mm
        for m in rows_m:
            x8 = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
            xlo, xhi = tw.split_even_odd(x8)
            plain = tw.w4_int32_plain(x8, w.w)
            plain_ms = timed_ms(lambda: tw.w4_int32_plain(x8, w.w), 3, flush)
            lib_ms = (timed_ms(lambda: torch._int_mm(x8, codes.t()), 20, flush)
                      if m > 16 else None)              # torch._int_mm takes M > 16
            b_bytes = (m * k + n * k // 2 + 4 * m * n) / HBM_BYTES_PER_S * 1e3
            b_ops = 2 * m * n * k / INT8_OPS_PER_S * 1e3
            plan = tw._plan(m, n, k)
            for name, split, xs in (("T2", True, (xlo, xhi)), ("T3", False, (x8,))):
                fn = (lambda: tw.w4_int32_split(xlo, xhi, w.w)) if split else \
                    (lambda: tw.w4_int32(x8, w.w))
                out = fn()
                torch.cuda.synchronize()
                if not torch.equal(out, plain):
                    raise AssertionError(f"{name} {wname} M={m}: differs from the plain product")
                ms = timed_ms(fn, 20, flush)
                emit("tproto", kernel=name, weight=wname, m=m, k=k, n=n, bitwise=True,
                     plan=dataclasses.asdict(plan), kernel_ms=ms, plain_ms=plain_ms,
                     library_ms=lib_ms, bound_ms=max(b_bytes, b_ops),
                     bound_by="bytes" if b_bytes >= b_ops else "operations",
                     roofline_share=max(b_bytes, b_ops) / ms)
                if m in summed:
                    x = sums[(name, m)]
                    x["ms"] += ms
                    x["plain_ms"] += plain_ms
                    if lib_ms is not None:
                        x["library_ms"] += lib_ms
                    x["bound_ms"] += max(b_bytes, b_ops)
                    x["bytes_bound"] += b_bytes >= b_ops
                if m not in (32, 5):
                    continue
                ktiles = -(-k // tw.KTILE)
                others = {"plan": plan, "rows64": tw._plan(m, n, k, rows=64),
                          "rows128": tw._plan(m, n, k, rows=128),
                          "nosplit": dataclasses.replace(plan, splits=1, per=ktiles)}
                for cfg, p in others.items():
                    other = tw._launch(split, xs, w.w, m, k, p)
                    torch.cuda.synchronize()
                    if not torch.equal(other, plain):
                        raise AssertionError(f"{name} {wname} M={m} {cfg}: differs from plain")
                    sweep_ms = timed_ms(lambda: tw._launch(split, xs, w.w, m, k, p), 20, flush)
                    sweep[(name, m, cfg)] += sweep_ms
                    emit("tproto", kernel=name, weight=wname, m=m, config=cfg,
                         plan=dataclasses.asdict(p), bitwise=True,
                         kernel_ms=sweep_ms)
        del codes
    for (name, m, cfg), ms in sweep.items():
        emit("tproto", kernel=name, layer_sum=f"one layer's 4 projections at M={m}", config=cfg,
             kernel_ms=ms)
    for (name, m), x in sums.items():
        x["bound_by"] = "bytes" if x.pop("bytes_bound") == 4 else "operations"
        emit("tproto", kernel=name, layer_sum=f"one layer's 4 projections at M={m}",
             roofline_share=x["bound_ms"] / x["ms"], **x)
    _w4_breakdown(torch, tw, weights, shapes, g, flush)
    out = {}
    for name, variant, fn in (("T2", "w4", tw.w4_int32_split), ("T3", "w4p", tw.w4_int32)):
        x = dict(sums[(name, 32)], max_abs_err=0)
        for m in (5, 256):
            x[f"ms_m{m}"], x[f"bound_ms_m{m}"] = sums[(name, m)]["ms"], sums[(name, m)]["bound_ms"]
        x["library_ms_m256"] = sums[(name, 256)]["library_ms"]
        fn.launches = 0
        h0 = torch.randn((32, 4096), generator=g, device="cuda").to(torch.bfloat16)
        for _ in range(32):                 # the tool's chain, one distinct layer cycled
            a = tw.q4c_matmul(h0, weights["wqkv"], variant)
            bb = tw.q4c_matmul(a[:, :4096], weights["wo"], variant)
            c = tw.q4c_matmul(h0, weights["gateup"], variant)
            dd = tw.q4c_matmul(c[:, :11008], weights["down"], variant)
            h0 = (h0 + 0.001 * (bb + dd)).to(torch.bfloat16)
        torch.cuda.synchronize()
        x["launches"] = fn.launches
        if not bool(torch.isfinite(h0).all()) or x["launches"] != 4 * 32:
            raise AssertionError(f"{name}: the tool's chain failed")
        emit("tproto", kernel=name, chain_launches=x["launches"])
        out[name] = x
    return t1, out["T2"], out["T3"]


def _prompts(tok, n: int, img_tokens: int):
    """n prompts of PROMPT tokens (BOS included) sharing the first SHARED:
    per request 4 words, the <IMG> run, then words to fill."""
    shared = " ".join(f"sys{i}" for i in range(SHARED - 1))
    rest = PROMPT - SHARED - 4 - img_tokens
    return [f"{shared} req{j} a{j} b{j} c{j} " + "<IMG> " * img_tokens
            + " ".join(f"w{j}x{i}" for i in range(rest)) for j in range(n)]


class _Checked:
    """Stand-in for a kernel wrapper during the small phase: on each call it
    runs the kernel and the plain version on the same CUDA inputs and keeps
    the largest difference, the largest plain value and the largest
    difference of one result over that result's own largest plain value
    (``rel``), so every kernel is
    also held at the mock pipeline's own shapes (K1: K=64/128, N up to 256;
    K2: H=4, D=16; K3: H=4, D=16, f32)."""

    def __init__(self, kernel, plain):
        self.kernel, self.plain, self.calls, self.err, self.ref_max = kernel, plain, 0, 0.0, 0.0
        self.rel = 0.0
        # the kernel counts its launches on the name it is bound to, which
        # is this object while it stands in; those launches are not counted
        self.launches = 0

    def __call__(self, *args, **kw):
        if not args[0].is_cuda:
            # the CPU pipeline's call: the wrapper takes its plain version,
            # which is no launch and proves nothing about the kernel
            return self.kernel(*args, **kw)
        got = self.kernel(*args, **kw)
        ref = self.plain(*args, **kw)
        self.calls += 1
        pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
        for g, r in pairs:      # K3 with its lse, K5b's dk and dv
            err = float((g.double() - r.double()).abs().max())
            ref_max = float(r.double().abs().max())
            self.err, self.ref_max = max(self.err, err), max(self.ref_max, ref_max)
            self.rel = max(self.rel, err / ref_max if ref_max else err)
        return got


def phase_small(torch, te, pipeline_mod, tq8, tfd, tfa, tq4):
    """Mock pipeline on the card vs the same weights on the CPU.

    The tolerance is loose on purpose. W8A8 rounds every activation row to
    int8, so a float difference of one ulp (the card sums in another order)
    can move a value across a rounding edge and shift the logits by a
    quantization step. On the CPU alone, relative perturbations of 1e-6 to
    1e-5 of the query embeddings move these logits (std 1.00) by up to
    0.086, 0.011 on average. Small wiring faults, measured the same way,
    move them more: attention that drops one shared-prefix row by up to 1.5
    (mean 0.063), one that drops the newest slot by up to 0.54 (mean 0.033),
    the neighbouring layer's cache by up to 6.3 (mean 1.0). So the logits
    are held at max |err| < 0.3 and mean |err| < 0.03, and each kernel is
    held tightly against its plain version on the card at these shapes."""
    cfg = pipeline_mod.PipelineConfig(mock=True, device="cpu", seed=5)
    cpu = pipeline_mod.RaDialogPipeline(cfg)
    gpu = pipeline_mod.RaDialogPipeline(cfg).to("cuda")
    k1 = _Checked(tq8.q8_matmul_int32, tq8.q8_matmul_int32_plain)
    k2 = _Checked(tfd.flash_decode_int8_kernel, tfd.flash_decode_int8_plain)
    k2c = _Checked(tfd.flash_decode_int8_current_kernel, tfd.flash_decode_int8_plain)
    k3 = _Checked(tfa.flash_attention_kernel, tfa.flash_attention_plain)
    k4 = _Checked(tq4.q4_matmul_acc, tq4.q4_matmul_acc_plain)
    tq8.q8_matmul_int32, tfd.flash_decode_int8_kernel, tfa.flash_attention_kernel = k1, k2, k3
    tq4.q4_matmul_acc, tfd.flash_decode_int8_current_kernel = k4, k2c
    try:
        _small_run(torch, te, pipeline_mod, cpu, gpu, k1, k2, k3, k2c)
        _small_float(torch, te, pipeline_mod, k1, k2, k3, k4)
        _small_serve(torch, pipeline_mod, {8: (cpu, gpu)}, k1, k2, k4)
        _small_eval(torch, te, pipeline_mod, k1, k2, k4)
    finally:
        tq8.q8_matmul_int32, tfd.flash_decode_int8_kernel = k1.kernel, k2.kernel
        tfa.flash_attention_kernel, tq4.q4_matmul_acc = k3.kernel, k4.kernel
        tfd.flash_decode_int8_current_kernel = k2c.kernel
    _small_train(torch, tfa)


@contextlib.contextmanager
def _eval_pipelines(ev, factory):
    """apps/evaluate.py's main builds its pipeline through ``factory`` for
    the block (main's own PipelineConfig is passed through)."""
    real = ev.RaDialogPipeline
    ev.RaDialogPipeline = lambda cfg: factory(real, cfg)
    try:
        yield
    finally:
        ev.RaDialogPipeline = real


EVAL_FILES = ("predictions_{}.csv", "predictions_{}_after_corrections.csv", "labels_{}.csv",
              "results_{}.txt")


def _eval_argv(extra, out_dir, studies, new):
    return [*extra, "--use_embs", "--do_corr", "--do_cp_bin_qa", "--do_cp_all_qa",
            "--fixture-dir", "tests/fixtures", "--truncate", str(studies), "--batch_size", "12",
            "--max_new_tokens", str(new), "--output_dir", str(out_dir)]


def _eval_outputs(out_dir, results, n):
    """Whether the four files of an eval run are there, with n reports and
    labels in {-1, 0, 1, NaN}, and every metric finite."""
    import math
    import numpy as np
    from radialog_tpu_torch.eval.ce_metrics import CHEXBERT_CONDITIONS, read_labels_csv
    exp = "img_matching_examples_ig2_noexamples_IMG_findings_embs"
    paths = [out_dir / f.format(exp) for f in EVAL_FILES]
    if not all(p.is_file() for p in paths):
        return False, {"missing": [p.name for p in paths if not p.is_file()]}
    labels = read_labels_csv(paths[2], cols=CHEXBERT_CONDITIONS)
    vals = set(labels[~np.isnan(labels)].tolist())
    lines = [p.read_text().splitlines() for p in paths[:2]]
    ok = (labels.shape == (n, 14) and vals <= {-1.0, 0.0, 1.0}
          and all(len(x) == n and all(ln.startswith('"') and ln.endswith('"') for ln in x)
                  for x in lines)
          and paths[3].read_text().startswith("Prompt: ") and "Avg Bleu 1: " in paths[3].read_text()
          and all(math.isfinite(v) for v in results.values()))
    return ok, {"files": [p.name for p in paths], "label_values": sorted(vals),
                "label_blank": int(np.isnan(labels).sum())}


def _small_eval(torch, te, pipeline_mod, k1, k2, k4):
    """The port's eval command line (apps/evaluate.py main, the root
    test.py's counterpart) over the mock: at W8A8 on the CPU and on the card
    from the same weights (built on the CPU, then moved), and at W4A8 on the
    card (K4 launched). Each run writes its four files; per record, the
    teacher-forced logits of the report turn and of its correction turn are
    held at LOGIT_TOL between the two W8A8 pipelines (phase_small says why
    that bound)."""
    import tempfile
    from pathlib import Path
    from radialog_tpu_torch.apps import evaluate as ev
    from radialog_tpu_torch.data.datasets import MimicPaths, ReportGenData
    made, corr_prompts = {}, []

    def same_weights(real, cfg):
        p = real(dataclasses.replace(cfg, device="cpu"))
        if cfg.device == "cpu":
            gen = p.generate_texts

            def recording(prompts, img_embs=None, max_new_tokens=None, **kw):
                if max_new_tokens == ev.CORRECTION_NEW:
                    corr_prompts.append(prompts[0])
                return gen(prompts, img_embs=img_embs, max_new_tokens=max_new_tokens, **kw)
            p.generate_texts = recording
        else:
            p = p.to(cfg.device)
        made[(cfg.device, cfg.weight_bits)] = p
        return p

    runs, ok = {}, True
    studies = 2
    with tempfile.TemporaryDirectory() as tmp, _eval_pipelines(ev, same_weights):
        for dev, bits in (("cpu", "--int8"), ("cuda", "--int8"), ("cuda", "--w4")):
            out = Path(tmp) / f"{dev}{bits}"
            before = (k1.calls, k2.calls, k4.calls)
            results = ev.main(_eval_argv(["--mock", bits, "--device", dev], out, studies, 8))
            good, files = _eval_outputs(out, results, studies)
            calls = {"k1": k1.calls - before[0], "k2": k2.calls - before[1],
                     "k4": k4.calls - before[2]}
            runs[f"{dev}{bits}"] = {"metrics": results, "kernel_calls": calls, **files}
            ok = ok and good and (dev == "cpu" or (calls["k2"] > 0 and (
                calls["k4"] > 0 if bits == "--w4" else calls["k1"] > 0 and calls["k4"] == 0)))
    cpu, gpu = made[("cpu", 8)], made[("cuda", 8)]
    fx = Path("tests/fixtures")
    records = ReportGenData(MimicPaths(str(fx / "split.csv"), str(fx / "sectioned.csv"),
                                       str(fx / "chexpert.csv"), str(fx / "preds.json")),
                            truncate=studies).records()
    provider = ev.mock_emb_provider(cpu.llama_cfg.num_img_tokens, cpu.llama_cfg.qformer_dim)
    cases = {}
    for i, r in enumerate(records):
        e = torch.as_tensor(provider([r["dicom"]]))
        for turn, prompt in (("report", r["text_input"]), ("correction", corr_prompts[i])):
            cases[f"{r['dicom']}_{turn}"] = _small_case(torch, te, pipeline_mod, cpu, gpu,
                                                        [prompt], e)
    ok = ok and len(corr_prompts) == studies and all(
        c["teacher_forced_logit_mean_abs_err"] < LOGIT_TOL["mean"]
        and c["teacher_forced_logit_max_abs_err"] < LOGIT_TOL["max"] for c in cases.values())
    emit("small_eval", runs=runs, records=cases, logit_tol=LOGIT_TOL, ok=ok)
    if not ok:
        raise AssertionError("the eval command line on the mock failed a check")


def _train_records(n: int, words) -> list:
    """n instruct records, half report generation and half another task: a
    prompt of ~60 tokens with the 32 <IMG> slots and an answer of
    ``words(j)`` words."""
    return [{"instruction": "Image information: " + "<IMG>" * 32 + f". Predicted Findings: "
                            f"edema f{j}. Write the findings section.",
             "input": f"USER: scan {j} ASSISTANT:",
             "output": " ".join(f"r{j}w{i}" for i in range(words(j))) + ".",
             "dicom": f"dcm{j:03d}", "task": "RG" if j % 2 == 0 else "EL"} for j in range(n)]


def _small_train(torch, tfa):
    """The mock LoRA trainer through apps/finetune_lora.train on the card
    and on the CPU from the same seeded weights: 4 micro-steps, accumulation
    2, sequences of 90-256 tokens padded to 256 so that flash attention runs,
    with the float base (FP32) and the int8 base (BF16). Every K3, K5a and
    K5b call on the card is held against its plain version."""
    import tempfile
    from pathlib import Path
    from radialog_tpu_torch.apps import finetune_lora as ft
    from radialog_tpu_torch.train.optim import tree_leaves
    names = ("flash_attention_kernel", "flash_attention_dq_kernel", "flash_attention_dkv_kernel")
    plains = (tfa.flash_attention_plain, tfa.flash_attention_dq_plain,
              tfa.flash_attention_dkv_plain)
    cases, ok = {}, True
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "instruct.json"
        data.write_text(json.dumps(_train_records(14, lambda j: 30 + 17 * j)))
        for label, quantize in (("fp32", False), ("bf16", True)):
            checked = [_Checked(getattr(tfa, n), p) for n, p in zip(names, plains)]
            runs = {}
            try:
                for n, c in zip(names, checked):
                    setattr(tfa, n, c)
                for dev in ("cpu", "cuda"):
                    losses = []
                    cfg = ft.FinetuneConfig(
                        mock=True, data_path=str(data), batch_size=4, micro_batch_size=2,
                        num_epochs=2, max_steps=4, cutoff_len=256, val_set_size=2,
                        use_embs=True, use_instruct_data=True, quantize_base=quantize,
                        flash=True, output_dir=str(Path(tmp) / f"{label}-{dev}"), device=dev)
                    state = ft.train(cfg, log_fn=lambda m: None,
                                     on_step=lambda s_, m: losses.append(float(m["loss"])))
                    runs[dev] = (losses, [x.float().cpu() for x in tree_leaves(state.params)])
            finally:
                for n, c in zip(names, checked):
                    setattr(tfa, n, c.kernel)
            tol = SMALL_TRAIN_TOL[label]
            loss_err = max(abs(a - b) for a, b in zip(*(runs[d][0] for d in ("cpu", "cuda"))))
            tree_err = max(float((a - b).abs().max())
                           for a, b in zip(*(runs[d][1] for d in ("cpu", "cuda"))))
            k3, k5a, k5b = checked
            k3_tol = K3_TOL["bfloat16" if quantize else "float32"]
            k5_tol = K5_TOL["bfloat16" if quantize else "float32"]
            cases[label] = {
                "losses_card": runs["cuda"][0], "losses_cpu": runs["cpu"][0],
                "loss_max_abs_err": loss_err, "lora_tree_max_abs_err": tree_err, "tol": tol,
                "k3_calls": k3.calls, "k3_max_abs_err": k3.err, "k5a_calls": k5a.calls,
                "k5a_max_abs_err": k5a.err, "k5a_largest_gradient": k5a.ref_max,
                "k5a_err_of_largest": k5a.rel, "k5b_calls": k5b.calls,
                "k5b_max_abs_err": k5b.err, "k5b_largest_gradient": k5b.ref_max,
                "k5b_err_of_largest": k5b.rel}
            # per micro-step and layer: K3 in the forward and again in the
            # recomputation, K5a and K5b once; plus one validation batch
            ok = (ok and len(runs["cuda"][0]) == 4 and loss_err < tol["loss"]
                  and tree_err < tol["tree"] and k3.calls == 2 * (2 * 4 + 1)
                  and k5a.calls == k5b.calls == 2 * 4
                  and k3.err <= k3_tol["atol"] + k3_tol["rtol"] * max(k3.ref_max, 1.0)
                  and k5a.rel <= k5_tol and k5b.rel <= k5_tol)
    emit("small_train", cases=cases, k5_tol_of_largest=K5_TOL, ok=ok)
    if not ok:
        raise AssertionError("card and CPU disagree on the mock LoRA trainer")


def _teacher_forced(torch, te, pipeline_mod, p, ids, emb, forced, dp):
    """Per-step logits of pipeline p on its device with the ids ``forced``
    fed back, through the engine calls that generate_ids makes for these
    prompts (shared-prefix or plain prefill)."""
    from radialog_tpu_torch.apps.tokenization import pad_batch_right
    from radialog_tpu_torch.models.llama import find_img_start, init_cache, llama_apply, \
        prefill_bias
    n, dev, kv_int8 = len(ids), p.device, p.cfg.use_kv_int8()
    p0, img_in_prefix = p._shared_prefix_len(ids, emb)
    if p0 >= pipeline_mod.SHARED_PREFIX_MIN:
        rem, lens = pad_batch_right([s[p0:] for s in ids], 0)
        rem, lens = torch.as_tensor(rem, device=dev), torch.as_tensor(lens, device=dev)
        t1 = rem.shape[1]
        shared = te.prefix_kv(p.llama, p.llama_cfg, torch.as_tensor(ids[0][:p0], device=dev),
                              lora=p.lora, policy=p.policy,
                              img_embs=emb[:1] if img_in_prefix else None)
        rem_emb = None if img_in_prefix else emb
        cache = init_cache(p.llama_cfg, n, te.default_cache_len(t1, dp), device=dev,
                           quantized=kv_int8)
        first, cache = llama_apply(
            p.llama, p.llama_cfg, rem, p0 + torch.arange(t1, device=dev)[None].repeat(n, 1),
            prefill_bias(lens, t1), cache=cache, img_embs=rem_emb,
            img_start=(find_img_start(rem, p.llama_cfg.img_token_id)
                       if rem_emb is not None else None),
            lora=p.lora, policy=p.policy, lengths=lens, last_pos=lens - 1, shared_kv=shared)
        first = first[:, 0]
        kw = dict(shared_kv=te.decode_prefix(shared, cache), pos_offset=p0, shared_p0=p0)
    else:
        tok, lens = pad_batch_right(ids, 0)
        tok, lens = torch.as_tensor(tok, device=dev), torch.as_tensor(lens, device=dev)
        t1 = tok.shape[1]
        cache, first = te.prefill(p.llama, p.llama_cfg, tok, lens, te.default_cache_len(t1, dp),
                                  img_embs=emb, lora=p.lora, policy=p.policy, kv_int8=kv_int8)
        kw = {}
    out = [first]
    for step in range(forced.shape[1] - 1):
        out.append(te.decode_step(p.llama, p.llama_cfg, cache, forced[:, step].to(dev), lens,
                                  t1, step, lora=p.lora, policy=p.policy, **kw))
    return torch.stack(out, 1).cpu()


def _small_case(torch, te, pipeline_mod, cpu, gpu, prompts, e_cpu, new=12):
    ids = [cpu.tokenizer(x)["input_ids"] for x in prompts]
    dp = cpu.decode_params(max_new_tokens=new, eos_token_id=-1)
    res_cpu = cpu.generate_ids(ids, e_cpu, dp)
    res_gpu = gpu.generate_ids(ids, e_cpu.cuda(), dp)
    agree = float((res_gpu.tokens.cpu() == res_cpu.tokens).float().mean())
    # teacher-forced logits on the CPU's greedy ids
    forced = res_cpu.tokens
    a = _teacher_forced(torch, te, pipeline_mod, cpu, ids, e_cpu, forced, dp)
    b = _teacher_forced(torch, te, pipeline_mod, gpu, ids, e_cpu.cuda(), forced, dp)
    diff = (a - b).abs()
    return {"prompt_tokens": max(len(x) for x in ids),
            "shared_prefix": cpu._shared_prefix_len(ids, e_cpu)[0],
            "teacher_forced_logit_max_abs_err": float(diff.max()),
            "teacher_forced_logit_mean_abs_err": float(diff.mean()),
            "logit_std": float(a.std()), "greedy_agreement": agree}


def _small_run(torch, te, pipeline_mod, cpu, gpu, k1, k2, k3, k2c):
    from radialog_tpu_torch.ops.image import expand_cxr_u8
    u8 = torch.randint(0, 256, (4, 64, 64), generator=torch.Generator().manual_seed(0),
                       dtype=torch.uint8)
    e_cpu = cpu.embed_images(expand_cxr_u8(u8))
    e_gpu = gpu.embed_images(expand_cxr_u8(u8.cuda()))
    emb_err = float((e_gpu.cpu() - e_cpu).abs().max())
    img = "<IMG> " * 32
    # the report batch: 4 images, a 48-token shared prefix before them
    cases = {"report": _small_case(torch, te, pipeline_mod, cpu, gpu,
                                   _prompts(cpu.tokenizer, 4, 32), e_cpu)}
    # one image for every lane, joining a 273-token shared prefix
    hist = " ".join(f"sys{i}" for i in range(40)) + f" {img}" + " ".join(
        f"h{i}" for i in range(200))
    k3_before = k3.calls
    cases["long_prefix"] = _small_case(
        torch, te, pipeline_mod, cpu, gpu,
        [f"{hist} q{j} a{j} b{j} c{j}" for j in range(4)], e_cpu[:1].repeat(4, 1, 1))
    k3_long = k3.calls - k3_before
    # 2 prompts of 300+ tokens sharing only BOS: prefill without a cache,
    # then install_prefill
    k3_before = k3.calls
    cases["no_prefix"] = _small_case(
        torch, te, pipeline_mod, cpu, gpu,
        [f"p{j} {img}" + " ".join(f"p{j}w{i}" for i in range(268)) for j in range(2)],
        e_cpu[:2])
    k3_plain_prefill = k3.calls - k3_before
    # the report batch again with in-kernel KV writes (K2'' at every decode
    # layer, K2 never), then over the bf16 cache (no flash-decode at all)
    before = (k2.calls, k2c.calls)
    with _env("RADIALOG_DEFER_KV", "1"):
        cases["report_defer_kv"] = _small_case(torch, te, pipeline_mod, cpu, gpu,
                                               _prompts(cpu.tokenizer, 4, 32), e_cpu)
    defer_calls = {"k2": k2.calls - before[0], "k2_current": k2c.calls - before[1]}
    cfg16 = pipeline_mod.PipelineConfig(mock=True, device="cpu", seed=5, kv_int8=False)
    cpu16 = pipeline_mod.RaDialogPipeline(cfg16)
    gpu16 = pipeline_mod.RaDialogPipeline(cfg16).to("cuda")
    before = (k2.calls, k2c.calls)
    cases["report_bf16_kv"] = _small_case(torch, te, pipeline_mod, cpu16, gpu16,
                                          _prompts(cpu.tokenizer, 4, 32), e_cpu)
    bf16_k2_calls = k2.calls + k2c.calls - sum(before)
    # sampling on the card: one seed, the same texts twice
    sample_prompts = _prompts(cpu.tokenizer, 4, 32)
    sampled = [gpu.generate_texts(sample_prompts, img_embs=e_gpu, max_new_tokens=12,
                                  do_sample=True, temperature=0.9) for _ in range(2)]
    greedy = gpu.generate_texts(sample_prompts, img_embs=e_gpu, max_new_tokens=12)
    k3_tol = K3_TOL["float32"]
    emit("small", embed_max_abs_err=emb_err, logit_tol=LOGIT_TOL, cases=cases,
         k1_calls=k1.calls, k1_max_abs_err=k1.err, k2_calls=k2.calls, k2_max_abs_err=k2.err,
         k2_current_calls=k2c.calls, k2_current_max_abs_err=k2c.err,
         calls_with_defer_kv=defer_calls, flash_decode_calls_bf16_kv=bf16_k2_calls,
         sampled_twice_equal=sampled[0] == sampled[1], sampled_differs_from_greedy=sampled[0] != greedy,
         k3_calls=k3.calls, k3_calls_long_prefix=k3_long, k3_calls_no_prefix=k3_plain_prefill,
         k3_max_abs_err=k3.err, k3_tol=k3_tol)
    ok = (emb_err < 1e-3 and k1.calls and k1.err == 0 and k2.calls and k2.err < K2_TOL["atol"]
          and defer_calls["k2"] == 0 and defer_calls["k2_current"] > 0
          and k2c.err < K2_TOL["atol"] and bf16_k2_calls == 0 and sampled[0] == sampled[1]
          and all(t.startswith(q) for t, q in zip(sampled[0], sample_prompts))
          and k3.calls and k3_long and k3_plain_prefill
          and k3.err <= k3_tol["atol"] + k3_tol["rtol"] * k3.ref_max
          and cases["long_prefix"]["shared_prefix"] >= 256
          and cases["no_prefix"]["shared_prefix"] < pipeline_mod.SHARED_PREFIX_MIN
          and all(c["teacher_forced_logit_mean_abs_err"] < LOGIT_TOL["mean"]
                  and c["teacher_forced_logit_max_abs_err"] < LOGIT_TOL["max"]
                  for c in cases.values()))
    if not ok:
        raise AssertionError("card and CPU disagree on the mock pipeline")


def _small_float(torch, te, pipeline_mod, k1, k2, k3, k4):
    """The float mock (PipelineConfig(quantize=False): the stacked f32 tree
    over the bf16 cache) on the card vs the same weights on the CPU, TF32
    off: query embeddings, and prefill and teacher-forced decode logits of
    the report batch and of 2 prompts of 300+ tokens (K3 in f32 at the
    mock's shape, held on each card call). Nothing rounds to int8 on this
    path, so the logits are held far tighter than the W8A8 mock's, at max
    |err| < 2e-3 and mean |err| < 2e-4: the card sums f32 in another order
    (~1e-6), and a K/V value on a bf16 rounding edge installs one bf16 step
    apart, which moves logits by ~2e-5 a value (tests/test_torch_float_llama.py;
    measured on an H100 80GB HBM3 at 700 W: max 2.3e-4, mean 5.9e-6); a
    decode mask that leaves out the newest row moves them by up to 0.62,
    0.061 on average (the report batch on the CPU)."""
    from radialog_tpu_torch.ops.image import expand_cxr_u8
    cfg = pipeline_mod.PipelineConfig(mock=True, quantize=False, device="cpu", seed=5)
    cpu = pipeline_mod.RaDialogPipeline(cfg)
    gpu = pipeline_mod.RaDialogPipeline(cfg).to("cuda")
    u8 = torch.randint(0, 256, (4, 64, 64), generator=torch.Generator().manual_seed(0),
                       dtype=torch.uint8)
    e_cpu = cpu.embed_images(expand_cxr_u8(u8))
    emb_err = float((gpu.embed_images(expand_cxr_u8(u8.cuda())).cpu() - e_cpu).abs().max())
    before = [k.calls for k in (k1, k2, k3, k4)]
    img = "<IMG> " * 32
    cases = {"report": _small_case(torch, te, pipeline_mod, cpu, gpu,
                                   _prompts(cpu.tokenizer, 4, 32), e_cpu),
             "long": _small_case(torch, te, pipeline_mod, cpu, gpu,
                                 [f"p{j} {img}" + " ".join(f"p{j}w{i}" for i in range(268))
                                  for j in range(2)], e_cpu[:2])}
    calls = dict(zip(("k1", "k2", "k3", "k4"),
                     (k.calls - b for k, b in zip((k1, k2, k3, k4), before))))
    emit("small_float", embed_max_abs_err=emb_err, logit_tol=FLOAT_LOGIT_TOL, cases=cases,
         kernel_calls=calls, k3_max_abs_err=k3.err)
    k3_tol = K3_TOL["float32"]
    ok = (emb_err < 1e-3 and calls["k3"] == 2 * cpu.llama_cfg.num_layers
          and k3.err <= k3_tol["atol"] + k3_tol["rtol"] * k3.ref_max
          and calls["k1"] == calls["k2"] == calls["k4"] == 0
          and isinstance(gpu.llama["layers"], dict)
          and all(c["shared_prefix"] == 0
                  and c["teacher_forced_logit_mean_abs_err"] < FLOAT_LOGIT_TOL["mean"]
                  and c["teacher_forced_logit_max_abs_err"] < FLOAT_LOGIT_TOL["max"]
                  for c in cases.values()))
    if not ok:
        raise AssertionError("card and CPU disagree on the float mock pipeline")


def _ring_run(torch, p, requests, new, chunk):
    """The requests through RaDialogServer on pipeline p's device: int8
    ring of 32 slots behind a 64-slot prompt region, 2 lanes; two submits,
    the rest after the first result. Returns (tokens per request, ring_pos)."""
    from radialog_tpu_torch.apps.serve import RaDialogServer
    from radialog_tpu_torch.decode.engine import DecodeParams
    srv = RaDialogServer(p.llama, p.llama_cfg, lanes=2, cache_len=96, prompt_len=64,
                         dp=DecodeParams(max_new_tokens=new, eos_token_id=-1), lora=p.lora,
                         policy=p.policy, steps_per_call=chunk, kv_int8=True, device=p.device)
    try:
        futs = [srv.submit(ids, img_embs=emb.to(p.device)) for ids, emb in requests[:2]]
        futs[0].result(timeout=300)
        futs += [srv.submit(ids, img_embs=emb.to(p.device)) for ids, emb in requests[2:]]
        tokens = [f.result(timeout=300) for f in futs]
    finally:
        srv.shutdown()
    return tokens, srv._rb.ring_pos


def _ring_teacher_forced(torch, p, requests, forced):
    """Per-step logits of pipeline p's ring path with the ids ``forced``
    (steps, 2) fed back, a schedule stepped by hand over the batcher's own
    prefill and the model's interval mode: lane 0 decodes steps 0-24 and is
    admitted again at step 30; lane 1 has no session until step 20 (no valid
    slot), then decodes to the end, its window wrapping the 32-slot ring.
    Returns the logits of the lanes with a session, (n, V)."""
    from radialog_tpu_torch.decode.continuous import RingBatcher, ring_intervals
    from radialog_tpu_torch.decode.engine import DecodeParams
    from radialog_tpu_torch.models.llama import llama_apply
    dev, prompt, ring = p.device, 64, 32
    rb = RingBatcher(p.llama, p.llama_cfg, lanes=2, cache_len=prompt + ring, prompt_len=prompt,
                     dp=DecodeParams(max_new_tokens=26, eos_token_id=-1), lora=p.lora,
                     policy=p.policy, kv_int8=True, device=dev)
    lens = torch.zeros(2, dtype=torch.int32, device=dev)
    cur, writes = lens.clone(), lens.clone()
    active = torch.zeros(2, dtype=torch.bool, device=dev)

    def admit(lane, req):
        ids, emb = req
        tokens = torch.tensor([ids + [0] * (prompt - len(ids))], dtype=torch.int32, device=dev)
        rb._prefill_fn(tokens, len(ids), lane, emb.to(dev))
        lens[lane], cur[lane], writes[lane], active[lane] = len(ids), len(ids), 0, True

    out = []
    admit(0, requests[0])
    with torch.no_grad():
        for step in range(forced.shape[0]):
            if step == 20:
                admit(1, requests[1])
            if step == 25:
                active[0] = False
            if step == 30:
                admit(0, requests[2])
            e = step % ring
            writes = writes + active
            logits, _ = llama_apply(p.llama, p.llama_cfg, forced[step].to(dev)[:, None],
                                    cur[:, None], None, cache=rb.cache, write_pos=prompt + e,
                                    lora=p.lora, policy=p.policy, lengths=lens,
                                    slot_info=ring_intervals(writes, e, prompt, ring))
            out.append(logits[:, 0][active].cpu())
            cur = cur + active
    return torch.cat(out)


def _small_serve(torch, pipeline_mod, pipes, k1, k2, k4):
    """The mock pipeline through RaDialogServer over the int8 ring, on the
    card and on the CPU, with W8A8 and with W4A8 weights: six image prompts
    of 12 new tokens through 2 lanes in chunks of 4, so the 32-slot ring
    wraps; then teacher-forced logits of the hand-stepped ring schedule
    under phase_small's bound. Greedy agreement is reported, not held: a
    rounding edge may flip a token (phase_small's docstring)."""
    cfg4 = pipeline_mod.PipelineConfig(mock=True, device="cpu", seed=5, weight_bits=4)
    pipes[4] = (pipeline_mod.RaDialogPipeline(cfg4),
                pipeline_mod.RaDialogPipeline(cfg4).to("cuda"))
    cpu = pipes[8][0]
    from radialog_tpu_torch.ops.image import expand_cxr_u8
    u8 = torch.randint(0, 256, (6, 64, 64), generator=torch.Generator().manual_seed(9),
                       dtype=torch.uint8)
    embs = cpu.embed_images(expand_cxr_u8(u8))
    requests = [(cpu.tokenizer(f"s{j} t{j} " + "<IMG> " * 32
                               + " ".join(f"r{j}w{i}" for i in range(2 + 4 * j)))["input_ids"],
                 embs[j:j + 1]) for j in range(6)]
    forced = torch.randint(3, 240, (45, 2), generator=torch.Generator().manual_seed(10),
                           dtype=torch.int32)
    cases, ok = {}, True
    for bits, (cpu_p, gpu_p) in pipes.items():
        before = (k1.calls, k2.calls, k4.calls)
        tok_cpu, _ = _ring_run(torch, cpu_p, requests, 12, 4)
        tok_gpu, ring_pos = _ring_run(torch, gpu_p, requests, 12, 4)
        a = _ring_teacher_forced(torch, cpu_p, requests, forced)
        b = _ring_teacher_forced(torch, gpu_p, requests, forced)
        diff = (a - b).abs()
        agree = sum(x == y for tc_, tg in zip(tok_cpu, tok_gpu) for x, y in zip(tc_, tg))
        cases[f"w{bits}"] = {
            "sessions": len(tok_gpu), "ring_pos": ring_pos, "ring_len": 32,
            "greedy_agreement": agree / (12 * len(requests)),
            "teacher_forced_logit_max_abs_err": float(diff.max()),
            "teacher_forced_logit_mean_abs_err": float(diff.mean()),
            "logit_std": float(a.std()), "k1_calls": k1.calls - before[0],
            "k2_calls": k2.calls - before[1], "k4_calls": k4.calls - before[2]}
        ok = (ok and ring_pos > 32 and all(len(t) == 12 for t in tok_gpu)
              and a.shape == b.shape and bool(torch.isfinite(b).all())
              and float(diff.mean()) < LOGIT_TOL["mean"] and float(diff.max()) < LOGIT_TOL["max"]
              and k2.calls > before[1] and k1.calls > before[0]
              and (k4.calls > before[2]) == (bits == 4))
    emit("small_serve", logit_tol=LOGIT_TOL, cases=cases, k1_max_abs_err=k1.err,
         k2_max_abs_err=k2.err, k4_calls=k4.calls, k4_max_abs_err=k4.err)
    if not (ok and k1.err == 0 and k2.err < K2_TOL["atol"] and k4.err == 0):
        raise AssertionError("card and CPU disagree on the mock pipeline's ring serving")


def _report_batch(torch, pipe):
    """The report batch of a full-width pipeline: BATCH seeded uint8 X-rays
    and PROMPT-token prompts. Returns (prompts, ids, report_step), where
    report_step(n) classifies the findings, embeds the images and decodes n
    greedy tokens with EOS disabled."""
    from radialog_tpu_torch.ops.image import expand_cxr_u8
    g = torch.Generator(device="cuda").manual_seed(3)
    xray448 = torch.randint(0, 256, (BATCH, 448, 448), generator=g, device="cuda",
                            dtype=torch.uint8)
    xray488 = torch.randint(0, 256, (BATCH, 488, 488), generator=g, device="cuda",
                            dtype=torch.uint8)
    prompts = _prompts(pipe.tokenizer, BATCH, pipe.llama_cfg.num_img_tokens)
    ids = [pipe.tokenizer(p)["input_ids"] for p in prompts]
    assert all(len(s) == PROMPT for s in ids)

    def report_step(new_tokens: int):
        findings = pipe.classify_findings(expand_cxr_u8(xray488))
        embs = pipe.embed_images(expand_cxr_u8(xray448))
        dp = pipe.decode_params(max_new_tokens=new_tokens, eos_token_id=-1)
        return findings, embs, pipe.generate_ids(ids, embs, dp)
    return prompts, ids, report_step


def phase_slice(torch, te, pipeline_mod, tq8, tfd):
    t0 = time.time()
    pipe = pipeline_mod.RaDialogPipeline(pipeline_mod.PipelineConfig(synthetic=True, seed=0))
    torch.cuda.synchronize()
    build_s = time.time() - t0
    prompts, ids, report_step = _report_batch(torch, pipe)
    counted = {"q8_matmul": tq8.q8_matmul_int32, "flash_decode_int8": tfd.flash_decode_int8_kernel,
               "flash_decode_int8_current": tfd.flash_decode_int8_current_kernel}
    _zero(counted)
    report_step(8)                      # warm-up: cuDNN plans, allocator
    warm_k1 = tq8.q8_matmul_int32.launches

    def timed_pass(new):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero(counted)
        t0 = time.time()
        findings, embs, res = report_step(new)
        tokens = res.tokens.cpu()
        return (findings, embs, res, tokens, time.time() - t0, _read(counted))

    findings, embs, res, tokens, dt, launches = timed_pass(NEW)
    p0, _ = pipe._shared_prefix_len(ids, embs)
    ok = (tokens.shape == (BATCH, NEW) and int(tokens.min()) >= 0
          and int(tokens.max()) < pipe.llama_cfg.vocab_size
          and bool(torch.isfinite(embs).all()) and embs.shape == (BATCH, 32, 768)
          and len(findings) == BATCH and p0 == SHARED and all(res.lengths.cpu() == NEW)
          and launches["q8_matmul"] > 0 and launches["flash_decode_int8"] > 0
          and launches["flash_decode_int8_current"] == 0)
    emit("slice", reports_per_s=BATCH / dt, seconds=dt, batch=BATCH, prompt=PROMPT,
         shared_prefix=p0, new_tokens=NEW, defer_kv=False, launches=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, build_s=build_s,
         distinct_tokens=int(tokens.unique().numel()), ok=ok)
    if not ok:
        raise AssertionError("the full-width slice produced a malformed result")
    # the same pass with in-kernel KV writes, SLICE_DEFER_NEW tokens: K2'' at
    # every layer of every decode step (32 x 63 launches), K2 and the row
    # copies never; K1 as often as a pass of that length without them (K1's
    # launches grow by the same count a token: the warm-up's 8 tokens and the
    # first pass's NEW give the line)
    n_d = SLICE_DEFER_NEW
    with _env("RADIALOG_DEFER_KV", "1"):
        _, _, res_d, tokens_d, dt_d, launches_d = timed_pass(n_d)
    layers = pipe.llama_cfg.num_layers
    k1_step, k1_rest = divmod(launches["q8_matmul"] - warm_k1, NEW - 8)
    differs = tokens_d != tokens[:, :n_d]
    first_diff = torch.where(differs.any(dim=1), differs.int().argmax(dim=1),
                             torch.full((BATCH,), n_d))         # n_d: the lane is equal
    ok_d = (tokens_d.shape == (BATCH, n_d) and int(tokens_d.min()) >= 0
            and int(tokens_d.max()) < pipe.llama_cfg.vocab_size
            and all(res_d.lengths.cpu() == n_d)
            and launches_d["flash_decode_int8"] == 0
            and launches_d["flash_decode_int8_current"] == layers * (n_d - 1)
            and k1_rest == 0 and k1_step > 0
            and launches_d["q8_matmul"] == warm_k1 + (n_d - 8) * k1_step)
    emit("slice", reports_per_s=BATCH / dt_d, seconds=dt_d, batch=BATCH, prompt=PROMPT,
         shared_prefix=p0, new_tokens=n_d, defer_kv=True, launches=launches_d,
         k1_launches_per_token=k1_step,
         reports_per_s_defer_off=BATCH / dt, new_tokens_defer_off=NEW,
         # reported, not held: the current row is summed in another order, so
         # a rounding edge may flip a token and the rest of its lane
         token_share_equal_to_defer_off=float((tokens_d == tokens[:, :n_d]).float().mean()),
         lanes_equal_to_defer_off=int((first_diff == n_d).sum()),
         first_different_step_median=float(first_diff.float().median()),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, ok=ok_d)
    if not ok_d:
        raise AssertionError("the full-width slice with in-kernel KV writes failed a check")
    return launches, launches_d, {"pipe": pipe, "prompts": prompts, "tokens": tokens,
                                  "lengths": res.lengths.cpu(), "embs": embs}


# the bench phase: each tool's flags (cut in depth only), the kernels its
# path must launch, and the JAX tool's keys of each line it prints (the
# port adds "device" and "runs_s", bench_interactive "ignored")
K1, K2, K3, K4 = "q8_matmul", "flash_decode_int8", "flash_attention", "q4_matmul"
K5A, K5B = "flash_attention_dq", "flash_attention_dkv"
_SWEEP_KEYS = {"batch", "kv_int8", "w4", "two_phase", "shared_prefix", "cache_len",
               "new_tokens", "reports_per_sec", "ms_per_token"}
_SPEC_ROW = {"mode", "tok_s", "forwards", "ms_per_forward", "accepted_per_forward"}
_RING_ROW = {"mode", "tok_s", "reports_s", "accepted_per_verify", "lanes_token_exact_vs_plain",
             "cache_slots"}
_CHAT_ROW = {"mode", "cold_turns_s", "warm_turns_s", "warm_followup_mean_s",
             "warm_report_tok_s"}
_RING_KEYS = {"lanes", "sessions", "prompt_len", "new_tokens", "cache_len", "steps_per_call",
              "w4", "aggregate_tok_per_s", "per_session_tok_per_s", "chunk_ms", "ms_per_tok",
              "admit_ms_warm", "ignored"}
BENCH_TOOLS = {
    "bench": ([], (K1, K2), [{"metric", "value", "unit", "vs_baseline"}]),
    "sweep": (["--batch", "16", "--kv-int8", "--shared-prefix", "48", "--new-tokens", "16",
               "--runs", "1"], (K1, K2), [_SWEEP_KEYS]),
    "sweep_w4": (["--batch", "16", "--kv-int8", "--w4", "--new-tokens", "16", "--runs", "1"],
                 (K1, K2, K4), [_SWEEP_KEYS]),
    "sweep_mem": (["--batch", "16", "--kv-int8", "--shared-prefix", "48", "--new-tokens", "16",
                   "--mem"], (K1, K2),
                  [{"batch", "kv_int8", "cache_len", "argument_gib", "output_gib", "temp_gib",
                    "alias_gib", "peak_gib"}]),
    "qa": (["--runs", "1"], (K1, K2, K3),
           [{"batch", "hist_len", "q_len", "new_tokens", "kv_int8", "plain_s_per_study",
             "shared_s_per_study", "speedup"}]),
    "allqa": (["--runs", "1", "--new-tokens", "10"], (K1, K2, K3),
              [{"batch", "hist_len", "q_len", "prefix", "new_tokens", "kv_int8",
                "plain_s_per_batch", "shared_s_per_batch", "plain_s_per_study",
                "shared_s_per_study", "speedup"}]),
    "interactive_int8": (["--kv-int8", "--sessions", "8", "--new-tokens", "32"], (K1, K2),
                         [_RING_KEYS]),
    "interactive_w4": (["--w4", "--sessions", "8", "--new-tokens", "32", "--no-donate"],
                       (K1, K4), [_RING_KEYS]),
    "spec": (["--kv-int8", "--new-tokens", "12", "--runs", "1", "--accept-pattern", "1,2"],
             (K1, K3), [{"k", "m", "prompt_len", "new_tokens", "kv", "note", "accept_pattern"}]
             + [_SPEC_ROW] * 5),
    "spec_ring": (["--compact", "--kv-int8", "--new-tokens", "8", "--runs", "1"], (K1, K2, K3),
                  [{"k", "lanes", "prompt_len", "new_tokens", "compact", "kv_int8", "spc_plain",
                    "spc_spec", "note"}, {"mode", "tok_s", "reports_s", "cache_slots"}]
                  + [_RING_ROW] * 4),
    "chat": (["--report-tokens", "52", "--reply-tokens", "2"], (K1, K3),
             [{"prompt_len", "turn_len", "report_tokens", "reply_tokens", "turns", "cache_len",
               "unroll", "note"}] + [_CHAT_ROW] * 2),
    "train_flash": (["--flash", "--micro", "2", "--runs", "1"], (K3, K5A, K5B),
                    [{"micro_batch", "cutoff", "ms_per_step", "tokens_per_sec", "loss",
                      "grad_norm"}]),
    "train_stage1": (["--stage1", "--micro", "8", "--runs", "1", "--itm-chunks", "2"], (),
                     [{"mode", "batch", "ms_per_step", "images_per_sec", "loss", "loss_itc",
                       "loss_itm", "loss_lm"}]),
    "pipeline": (["--steps", "4", "--imgs", "16"], (),
                 [{"mode", "batch", "steps", "threads", "depth", "wall_s", "images_per_sec",
                   "ms_per_step", "no_step", "no_prefetch", "step_ms_p50", "step_ms_p90",
                   "first5_ms", "note"}]),
    "loader": (["--n", "32", "--repeat", "1"], (), None),
}
# what each run cuts from its tool's defaults, in depth only
BENCH_CUTS = {
    "bench": "runs 3 -> 1, new tokens 300 -> 32 (the warm-up too)",
    "sweep": "runs 2 -> 1, new tokens 300 -> 16", "sweep_w4": "runs 2 -> 1, new tokens 300 -> 16",
    "sweep_mem": "new tokens 300 -> 16", "qa": "runs 4 -> 1", "allqa": "runs 4 -> 1, new "
    "tokens 30 -> 10", "interactive_int8": "sessions 16 -> 8, new tokens 64 -> 32 (the "
    "warm-up's timed third chunk still decodes)",
    "interactive_w4": "sessions 16 -> 8, new tokens 64 -> 32",
    "spec": "runs 2 -> 1, new tokens 300 -> 12", "spec_ring": "runs 2 -> 1, new tokens 300 "
    "-> 8", "chat": "report tokens 300 -> 52, reply tokens 64 -> 2 (the fourth turn's re-prefill "
    "still 256 tokens: K3)", "train_flash": "micro-batches 2/4/8 -> 2, runs 3 -> 1",
    "train_stage1": "batches 2/4/8 -> 8, runs 3 -> 1", "pipeline": "steps 50 -> 4, images "
    "96 -> 16", "loader": "files 128 -> 32, repeats 2 -> 1"}
BENCH_NEW = 32
BENCH_ZERO_OK = {"shared_prefix"}     # a flag's echo: 0 where no prefix is shared


def _bench_numbers_ok(value, key=None) -> bool:
    """Every number in a tool's line finite and positive (booleans, None,
    strings and BENCH_ZERO_OK's echoes of a 0 flag aside)."""
    if isinstance(value, dict):
        return all(_bench_numbers_ok(v, k) for k, v in value.items())
    if isinstance(value, list):
        return all(_bench_numbers_ok(v, key) for v in value)
    if isinstance(value, bool) or value is None or isinstance(value, str):
        return True
    return math.isfinite(value) and (value > 0 or (key in BENCH_ZERO_OK and value == 0))


def phase_bench(torch, counted):
    """The measurement entry points at full width (module docstring): each
    tool's run through its own ``run`` (or ``bench_lora`` / ``bench_stage1``)
    on the card, its printed lines parsed and checked, the launches of each
    kernel over it. Returns {tool: launches}."""
    from tools import (bench_allqa_pass_torch, bench_chat_torch, bench_interactive_torch,
                       bench_loader_torch, bench_pipeline_torch, bench_qa_pass_torch,
                       bench_spec_ring_torch, bench_spec_torch, bench_sweep_torch, bench_torch,
                       bench_train_torch)
    from radialog_tpu_torch.ops.layers import BF16
    dev = torch.device("cuda")
    model = bench_torch.full_model()
    t0 = time.time()
    models = bench_torch.build_models(model, dev)
    params4 = bench_torch.build_serving_params(
        model.llama, torch.Generator(device=dev).manual_seed(0), bits=4, device=dev)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    models4 = {**models, "params": params4}
    runs = {   # each tool: its module (whose parser reads the flags) and its run
        "bench": (bench_torch, lambda a: bench_torch.run(models, model, bench_torch.Shape(
            new_tokens=BENCH_NEW, runs=1), dev)),
        "sweep": (bench_sweep_torch, lambda a: bench_sweep_torch.run(a, models, model, dev)),
        "sweep_w4": (bench_sweep_torch,
                     lambda a: bench_sweep_torch.run(a, models4, model, dev)),
        "sweep_mem": (bench_sweep_torch,
                      lambda a: bench_sweep_torch.run(a, models, model, dev)),
        "qa": (bench_qa_pass_torch, lambda a: bench_qa_pass_torch.run(a, models, model, dev)),
        "allqa": (bench_allqa_pass_torch,
                  lambda a: bench_allqa_pass_torch.run(a, models, model, dev)),
        "interactive_int8": (bench_interactive_torch, lambda a: bench_interactive_torch.run(
            a, models["params"], model, dev)),
        "interactive_w4": (bench_interactive_torch,
                           lambda a: bench_interactive_torch.run(a, params4, model, dev)),
        "spec": (bench_spec_torch, lambda a: bench_spec_torch.run(a, models, model, dev)),
        "spec_ring": (bench_spec_ring_torch, lambda a: bench_spec_ring_torch.run(
            a, models["params"], models["lora"], model.llama, BF16, dev)),
        "chat": (bench_chat_torch, lambda a: bench_chat_torch.run(a, models, model, dev)),
        "train_flash": (bench_train_torch,
                        lambda a: bench_train_torch.bench_lora(a, model, dev)),
        "train_stage1": (bench_train_torch,
                         lambda a: bench_train_torch.bench_stage1(a, model, dev)),
        "pipeline": (bench_pipeline_torch, lambda a: bench_pipeline_torch.run(a, dev)),
        "loader": (bench_loader_torch, lambda a: bench_loader_torch.run(a, dev)),
    }
    out = {}
    for name, (argv, kernels, keys) in BENCH_TOOLS.items():
        module, run = runs[name]
        args = module.build_parser().parse_args(argv)
        _zero(counted)
        buf = io.StringIO()
        t1 = time.time()
        with contextlib.redirect_stdout(buf):
            run(args)
        torch.cuda.synchronize()
        secs = time.time() - t1
        launches = _read(counted)
        lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.strip()]
        got = [set(x) - {"device", "runs_s"} for x in lines]
        keys_ok = (got == keys if keys is not None else
                   got[0] == {"n", "jpeg_side", "host_cores", "device_rate_to_beat"}
                   and all(k <= {"mode", "images_s", "note"} for k in got[1:]))
        card = smi()
        ok = (bool(lines) and keys_ok and all(_bench_numbers_ok(x) for x in lines)
              and all(x["device"] == card for x in lines)
              and all(launches[k] > 0 for k in kernels))
        emit("bench", tool=name, argv=argv, cuts=BENCH_CUTS[name], seconds=secs, lines=lines,
             kernels_expected=list(kernels), launches=launches, keys_ok=keys_ok, ok=ok)
        if not ok:
            raise AssertionError(f"bench tool {name}: a line, key, number or launch failed")
        out[name] = launches
        bench_torch.free(dev)
    emit("bench", tools=len(out), build_s=build_s, seconds=time.time() - t0,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, ok=True)
    del models, models4, params4
    bench_torch.free(dev)
    return out


def phase_qa(torch, tq8, tfd, tfa, sl):
    """The follow-up passes over the slice's conversations: each history is
    a slice prompt and its 300 generated tokens as decoded text, with the
    slice's image embeddings of that request."""
    import numpy as np
    from radialog_tpu_torch.apps import evaluate as ev
    from radialog_tpu_torch.data.downstream import all_qa_prompt, binary_qa_prompts
    from radialog_tpu_torch.eval.ce_metrics import CHEXPERT_COLS
    pipe, embs, tok = sl["pipe"], sl["embs"], sl["pipe"].tokenizer
    reports = [tok.decode(row[:int(n)].tolist(), skip_special_tokens=True)
               for row, n in zip(sl["tokens"], sl["lengths"])]
    hists = [p + " " + r for p, r in zip(sl["prompts"], reports)]
    records = [{"dicom": str(j)} for j in range(len(hists))]

    def provider(dicoms):
        return embs[[int(d) for d in dicoms]]

    gt = np.random.default_rng(7).choice([np.nan, 1.0, 0.0, -1.0], size=(len(hists), 14))
    opts = ev.EvalOptions(use_embs=True)
    bin_ids = [tok(x)["input_ids"] for x in binary_qa_prompts(hists[0], CHEXPERT_COLS)]
    p0, img_in_prefix = pipe._shared_prefix_len(bin_ids, embs[:1].repeat(len(bin_ids), 1, 1))
    counted = {"q8_matmul": tq8.q8_matmul_int32,
               "flash_decode_int8": tfd.flash_decode_int8_kernel,
               "flash_attention": tfa.flash_attention_kernel}
    for fn in counted.values():
        fn.launches = 0
    seconds = {}

    def timed(name, fn):
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.time() - t0
        return out

    binary = timed("binary_qa", lambda: ev.run_binary_qa_pass(
        pipe, records[:QA_STUDIES], hists[:QA_STUDIES], gt[:QA_STUDIES], opts, provider))
    k2_binary = tfd.flash_decode_int8_kernel.launches
    all_qa = timed("all_qa", lambda: ev.run_all_qa_pass(
        pipe, records[:ALL_QA_STUDIES], hists[:ALL_QA_STUDIES], gt[:ALL_QA_STUDIES], opts,
        provider))
    follow_prompt = all_qa_prompt(hists[0])
    follow = timed("follow_up_batch1", lambda: pipe.generate_texts(
        [follow_prompt], img_embs=embs[:1], max_new_tokens=FOLLOW_UP_NEW))
    labels = timed("label_reports", lambda: pipe.label_reports(reports[:LABELED]))
    launches = {name: fn.launches for name, fn in counted.items()}
    metrics = {**binary, **all_qa}
    values = labels[~np.isnan(labels)]
    ok = (launches["flash_attention"] == pipe.llama_cfg.num_layers * (QA_STUDIES + 1)
          and k2_binary > 0 and p0 >= 256 and img_in_prefix
          and all(np.isfinite(v) for v in metrics.values())
          and labels.shape == (LABELED, 14) and set(np.unique(values)) <= {-1.0, 0.0, 1.0}
          and follow[0].startswith(follow_prompt)
          and len(follow[0]) > len(follow_prompt))
    emit("qa", seconds=seconds, studies={"binary_qa": QA_STUDIES, "all_qa": ALL_QA_STUDIES,
                                         "labeled": LABELED},
         history_tokens=[len(tok(h)["input_ids"]) for h in hists[:ALL_QA_STUDIES]],
         binary_qa_prefix=p0, binary_qa_img_in_prefix=img_in_prefix,
         follow_up_prompt_tokens=len(tok(follow_prompt)["input_ids"]),
         follow_up_new_tokens=FOLLOW_UP_NEW, launches=launches,
         k2_launches_binary_qa=k2_binary, metric_keys=sorted(metrics), metrics=metrics,
         label_counts={str(v): int((labels == v).sum()) for v in (-1.0, 0.0, 1.0)},
         label_blank=int(np.isnan(labels).sum()), ok=ok)
    if not ok:
        raise AssertionError("the follow-up passes produced a malformed result")
    return launches


def _k3_forwards(pipeline_mod, pipe, prompts, embs) -> int:
    """Cache-free forwards of 256 tokens or more (each runs K3 once a
    layer) that pipe.generate_texts makes for these prompts, by the
    pipeline's and the engine's own rules: a shared prefix of
    SHARED_PREFIX_MIN tokens or more (never on the float path) is
    prefilled alone (prefix_kv), the remainders over it with the cache;
    otherwise the padded batch is prefilled without a cache unless the
    engine prefills it directly (decode/engine.py prefills_directly)."""
    import numpy as np
    from radialog_tpu_torch.apps.tokenization import pad_batch_right
    from radialog_tpu_torch.decode.engine import prefills_directly
    from radialog_tpu_torch.models.llama import _use_flash
    ids = [pipe.tokenizer(p)["input_ids"] for p in prompts]
    p0, _ = pipe._shared_prefix_len(ids, embs)
    if p0 >= pipeline_mod.SHARED_PREFIX_MIN:
        return int(_use_flash(np.asarray([p0]), p0))
    tokens, lengths = pad_batch_right(ids, pipe.tokenizer.pad_token_id)
    direct = prefills_directly(pipe.llama, len(ids), pipe.cfg.use_kv_int8())
    return int(not direct and _use_flash(lengths, tokens.shape[1]))


class _Kept:
    """Stand-in for a kernel wrapper during the eval run. Every call goes to
    the kernel, whose launches count on this object while it stands in; for
    the calls ``pick(state, index, args)`` selects (``index``: this call's
    place among the calls made under the current ``state``), the inputs and
    the kernel's output are copied, so that after the run the output the
    main path used can be held against the plain version on the very inputs
    that path gave the kernel."""

    def __init__(self, kernel, plain, state, pick):
        self.kernel, self.plain, self.state, self.pick = kernel, plain, state, pick
        self.launches, self.kept, self.index, self.at = 0, [], 0, None

    def __call__(self, *args, **kw):
        out = self.kernel(*args, **kw)
        if self.state.get("corr") != self.at:
            self.at, self.index = self.state.get("corr"), 0
        if self.pick(self.state, self.index, args):
            # a copy of a strided view is dense: note which inputs came as views
            views = [hasattr(a, "is_contiguous") and not a.is_contiguous() for a in args[:3]]
            self.kept.append((self.state["corr"], self.index, _copy(args), dict(kw), _copy(out),
                              views))
        self.index += 1
        return out


def _copy(x):
    """x with every tensor in it cloned (tuples and lists followed)."""
    if isinstance(x, (list, tuple)):
        return type(x)(_copy(y) for y in x)
    return x.clone() if hasattr(x, "clone") else x


def _eval_holds(torch, kept_by_name):
    """Each kept call of an eval run (a {kernel name: _Kept} dict) against
    its plain version on the same inputs: K1 and K4 bitwise, K2 within
    K2_TOL (K2'' too), K3 within K3_TOL. Returns one entry per kept call."""
    held = []
    for name, kept in kept_by_name.items():
        for study, index, args, kw, got, views in kept.kept:
            ref = kept.plain(*args, **kw)
            err = float((got.double() - ref.double()).abs().max())
            ref_max = float(ref.double().abs().max())
            if name in ("q8_matmul", "q4_matmul"):    # K4's weight is (N, K/2) bytes
                ok, where = err == 0, {"m": args[0].shape[0], "n": args[1].shape[0],
                                       "k": args[0].shape[1]}
            elif name.startswith("flash_decode_int8"):     # K2, K2''
                ok = bool(torch.allclose(got, ref, **K2_TOL))
                lens, a1, b1 = (int(m[0]) for m in args[6][:3])
                where = {"step": b1 - a1, "layer": args[7], "s": args[2].shape[2],
                         "prompt_pad": a1, "length": lens}
            else:
                ok = bool(torch.allclose(got.float(), ref.float(), **K3_TOL["bfloat16"]))
                where = {"layer": index, "b": args[0].shape[0], "t": args[0].shape[1],
                         "lengths": [int(x) for x in args[3]], "qkv_views": views}
            held.append({"kernel": name, "study": study, **where, "max_abs_err": err,
                         "ref_max": ref_max, "ok": ok})
    return held


def _timed_pipelines(torch, made, calls, state, label):
    """A factory for ``_eval_pipelines``: the pipeline main builds, kept in
    ``made``, whose generate_texts and label_reports calls are timed and
    recorded in ``calls``. During a generate_texts call ``state["corr"]``
    holds ``label(max_new_tokens, n)`` (n: the calls made before it with
    the same max_new_tokens), by which ``_Kept`` picks the calls it keeps."""
    def factory(real, cfg):
        p = real(cfg)
        made.append(p)
        gen, lab = p.generate_texts, p.label_reports

        def generate_texts(prompts, img_embs=None, max_new_tokens=None, **kw):
            t0 = time.time()
            state["corr"] = label(max_new_tokens,
                                  sum(c.get("new") == max_new_tokens for c in calls))
            try:
                out = gen(prompts, img_embs=img_embs, max_new_tokens=max_new_tokens, **kw)
                torch.cuda.synchronize()
            finally:
                state["corr"] = None
            calls.append({"prompts": list(prompts), "embs": img_embs, "new": max_new_tokens,
                          "s": time.time() - t0, "out": out})
            return out

        def label_reports(texts, *a, **kw):
            t0 = time.time()
            out = lab(texts, *a, **kw)
            torch.cuda.synchronize()
            calls.append({"labels": len(texts), "s": time.time() - t0})
            return out
        p.generate_texts, p.label_reports = generate_texts, label_reports
        return p
    return factory


def phase_eval(torch, pipeline_mod, tq8, tfd, tfa):
    """The evaluation harness at Vicuna-7B width through the port's eval
    command line (apps/evaluate.py main, the root test.py's counterpart):
    synthetic W8A8 weights, int8 KV, image embeddings, the report pass over
    the first EVAL_STUDIES test studies of tests/fixtures (one batch, EVAL_NEW
    new tokens), the batch-1 correction pass (256 new tokens a study), the
    binary-QA and all-QA passes, CheXbert labels, the four files. Launches of
    K1, K2 and K3 over the whole run; K3 exactly as models/llama.py
    _use_flash predicts from the prompts that reached generate_texts.

    The correction pass's shapes come from the reports the run writes, so
    besides the kernel phases' cases at those shapes, the kernels are held
    on the run's own inputs there: in the first and the last study, K1's
    first call of each weight in the prefill and at batch-1 decode
    (bitwise), K3 at layers 0, 8, 16 and 24 of the cache-free prefill
    (K3_TOL; each entry says which of q, k, v came as views) and K2 at
    decode steps 0 (layer
    0), 128 (layer 16) and 254 (the last of a full turn, layer 31; K2_TOL),
    each against its plain version after the run."""
    import shutil
    from pathlib import Path
    from radialog_tpu_torch.apps import evaluate as ev
    out_dir = Path("build/chip_eval")
    shutil.rmtree(out_dir, ignore_errors=True)
    made, calls, state = [], [], {"corr": None}
    timed = _timed_pipelines(
        torch, made, calls, state,
        lambda new, n: n if new == ev.CORRECTION_NEW else None)

    held_studies = (0, EVAL_STUDIES - 1)
    seen_n = set()

    def pick_k1(st, index, args):
        if st["corr"] not in held_studies:
            return False
        key = (st["corr"], args[0].shape[0] > 1, tuple(args[1].shape))
        if key in seen_n:
            return False
        seen_n.add(key)
        return True
    k1 = _Kept(tq8.q8_matmul_int32, tq8.q8_matmul_int32_plain, state, pick_k1)
    def pick_k2(st, index, args):
        layers = made[0].llama_cfg.num_layers
        return st["corr"] in held_studies and divmod(index, layers) in (
            (0, 0), (128, layers // 2), (CORR_NEW - 2, layers - 1))
    k2 = _Kept(tfd.flash_decode_int8_kernel, tfd.flash_decode_int8_plain, state, pick_k2)
    k3 = _Kept(tfa.flash_attention_kernel, tfa.flash_attention_plain, state,
               lambda st, i, a: st["corr"] in held_studies and i % 8 == 0)
    counted = {"q8_matmul": k1, "flash_decode_int8": k2, "flash_attention": k3}
    argv = _eval_argv(["--synthetic", "--int8"], out_dir, EVAL_STUDIES, EVAL_NEW)
    tq8.q8_matmul_int32, tfd.flash_decode_int8_kernel, tfa.flash_attention_kernel = k1, k2, k3
    try:
        with _eval_pipelines(ev, timed):
            torch.cuda.synchronize()
            t0 = time.time()
            results = ev.main(argv)
            torch.cuda.synchronize()
            seconds = time.time() - t0
            launches = {name: fn.launches for name, fn in counted.items()}
    finally:
        tq8.q8_matmul_int32, tfd.flash_decode_int8_kernel = k1.kernel, k2.kernel
        tfa.flash_attention_kernel = k3.kernel
    pipe = made[0]
    held = _eval_holds(torch, counted)
    gens = [c for c in calls if "new" in c]
    by = {n: [c for c in gens if c["new"] == n] for n in (EVAL_NEW, ev.CORRECTION_NEW, 10, 30)}
    k3_want = pipe.llama_cfg.num_layers * sum(_k3_forwards(pipeline_mod, pipe, c["prompts"],
                                                           c["embs"]) for c in gens)
    corr_tokens = [len(pipe.tokenizer(c["prompts"][0])["input_ids"]) for c in by[ev.CORRECTION_NEW]]
    files_ok, files = _eval_outputs(out_dir, results, EVAL_STUDIES)
    per_pass = {"report": sum(c["s"] for c in by[EVAL_NEW]),
                "correction_per_study": [c["s"] for c in by[ev.CORRECTION_NEW]],
                "binary_qa": sum(c["s"] for c in by[10]), "all_qa": sum(c["s"] for c in by[30]),
                "labels": sum(c["s"] for c in calls if "labels" in c)}
    kinds = {(h["kernel"], h["study"]) for h in held}
    ok = (files_ok and len(gens) == sum(len(x) for x in by.values())
          and len(by[EVAL_NEW]) == 1 and len(by[ev.CORRECTION_NEW]) == EVAL_STUDIES
          and len(by[10]) == EVAL_STUDIES
          and all(o.startswith(p) for c in gens for o, p in zip(c["out"], c["prompts"]))
          and launches["q8_matmul"] > 0 and launches["flash_decode_int8"] > 0
          and launches["flash_attention"] == k3_want > 0
          and all(h["ok"] for h in held)
          and kinds == {(k, s) for k in counted for s in held_studies})
    emit("eval", seconds=seconds, seconds_per_pass=per_pass,
         seconds_per_study={"report": per_pass["report"] / EVAL_STUDIES,
                            "correction": sum(per_pass["correction_per_study"]) / EVAL_STUDIES,
                            "binary_qa": per_pass["binary_qa"] / EVAL_STUDIES,
                            "all_qa": per_pass["all_qa"] / EVAL_STUDIES},
         studies=EVAL_STUDIES, argv=argv, launches=launches, k3_predicted=k3_want,
         report_prompt_tokens=[len(pipe.tokenizer(p)["input_ids"])
                               for p in by[EVAL_NEW][0]["prompts"]],
         correction_prompt_tokens=corr_tokens,
         correction_prefill_rows=[-(-n // 8) * 8 for n in corr_tokens],
         held_on_the_run_s_inputs=held, metrics=results, ok=ok, **files)
    if not ok:
        raise AssertionError("the full-width eval phase failed a check")
    k1.kept.clear(), k2.kept.clear(), k3.kept.clear()
    # the spec phase runs on this pipeline and these prompts: its batch-1
    # correction loop is the plain run the speculative decoders are put beside
    return launches, {"pipe": made.pop(), "argv": argv,
                      "report": by[EVAL_NEW][0], "corrections": by[ev.CORRECTION_NEW]}


class _VerifyRecorder:
    """Stand-in for ``llama_apply`` in a decoder module for a block: every
    call goes through; of each verify call the block's tokens, positions and
    f32 logits are kept on the card."""

    def __init__(self, module):
        self.module, self.real, self.calls = module, module.llama_apply, []

    def __enter__(self):
        self.module.llama_apply = self
        return self

    def __exit__(self, *exc):
        self.module.llama_apply = self.real

    def __call__(self, *args, **kw):
        out = self.real(*args, **kw)
        if kw.get("verify"):    # kept on the card: a copy to the host would be a stream wait
            self.calls.append((args[2].clone(), args[3].clone(), out[0].float()))
        return out


class _RoundTrip:
    """The pipeline's WhitespaceTokenizer with words "w<id>" that encode
    back to <id> and "</s>" as eos, so that a chat reply re-tokenizes to
    its own ids and each turn prefills only its new tokens (the
    WhitespaceTokenizer decodes to "tok<id>", which encodes to other ids)."""

    def __init__(self, base):
        self.base = base
        self.eos_token_id, self.pad_token_id = base.eos_token_id, base.pad_token_id

    def _ids(self, text):
        out = []
        for w in text.replace("</s>", " </s> ").split():
            if w == "</s>":
                out.append(self.eos_token_id)
            elif w[:1] == "w" and w[1:].isdigit() and int(w[1:]) < self.base.vocab_size:
                out.append(int(w[1:]))
            else:
                out.extend(self.base.encode(w, add_bos=False))
        return out

    def __call__(self, text, **_):
        ids = [self.base.bos_token_id] + self._ids(text)
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}

    def decode(self, ids, skip_special_tokens=True):
        # pad and bos ids a reply may hold keep their words; eos is the "</s>"
        # the conversation template writes after the reply
        return " ".join(f"w{int(i)}" for i in ids
                        if not (skip_special_tokens and int(i) == self.eos_token_id))


def _tok_ids(text):
    """The ids of a text the WhitespaceTokenizer decoded ("tok<id>" words)."""
    import re
    return [int(x) for x in re.findall(r"\btok(\d+)\b", text)]


def _tf_logits(torch, te, pipe, seqs, kv_int8):
    """Teacher-forced logits: each of ``seqs`` (prompt ids, its image
    embeddings (1, 32, 768), generated ids) through the engine's prefill and
    greedy decode steps at batch len(seqs) (prompts right-padded, the
    static-slot decode of ``generate``), its own ids fed back. Returns per
    sequence its (len(generated), V) logits on the card: row i the logits
    before generated id i."""
    from radialog_tpu_torch.apps.tokenization import pad_batch_right
    dev, cfg = pipe.device, pipe.llama_cfg
    tok, lens = (torch.as_tensor(x, device=dev) for x in pad_batch_right([s[0] for s in seqs], 0))
    n = max(len(s[2]) for s in seqs)
    forced = torch.zeros((len(seqs), n), dtype=torch.int32)
    for i, s in enumerate(seqs):
        forced[i, :len(s[2])] = torch.tensor(s[2])
    forced = forced.to(dev)
    dp = te.DecodeParams(max_new_tokens=n)
    with torch.no_grad():
        cache, first = te.prefill(pipe.llama, cfg, tok, lens,
                                  te.default_cache_len(tok.shape[1], dp),
                                  img_embs=torch.cat([s[1] for s in seqs]), lora=pipe.lora,
                                  policy=pipe.policy, kv_int8=kv_int8)
        out = [first]
        for step in range(n - 1):
            out.append(te.decode_step(pipe.llama, cfg, cache, forced[:, step], lens, tok.shape[1],
                                      step, lora=pipe.lora, policy=pipe.policy))
    logits = torch.stack(out, 1)
    return [logits[i, :len(s[2])] for i, s in enumerate(seqs)]


def _tf_verify(torch, te, pipe, ids, emb, gen, kv_int8, cache_len, k, n=None,
               one_row=False, drop_own=False):
    """Teacher forcing through the verify forward: the prompt prefilled as
    generate_spec does, then the first ``n`` generated ids (all by default)
    fed in blocks of k + 1 (``llama_apply(verify=True)``, causal over the
    cache of ``cache_len`` slots). Every block has k + 1 rows, as the
    speculative run's (the last is padded): a block of other rows would run
    its GEMMs at another M and round apart. one_row: a block starts at every
    position and only its first row is kept, so each kept row attends only
    rows that earlier blocks' first rows wrote: one token at a time, at the
    run's GEMM shape, with nothing of a block's own structure (its triangle,
    its later rows, their writes) in any kept row. drop_own: each row's own
    slot masked out of the bias, a verify that misses its own row (the
    control). Returns (n, V) logits, row i those before gen[i]."""
    from radialog_tpu_torch.models.llama import llama_apply
    from radialog_tpu_torch.ops.attention import NEG_INF, causal_mask_bias
    t = len(ids)
    n = len(gen) if n is None else min(n, len(gen))
    hist = torch.tensor(ids + gen + [0] * k, device=pipe.device)
    js = torch.arange(k + 1, device=pipe.device)
    with torch.no_grad():
        cache, first = te.prefill(pipe.llama, pipe.llama_cfg, hist[None, :t],
                                  torch.full((1,), t, device=pipe.device), cache_len,
                                  img_embs=emb, lora=pipe.lora, policy=pipe.policy,
                                  kv_int8=kv_int8)
        out = [first[0]]
        for base in range(t, t + n - 1, 1 if one_row else k + 1):
            bias = causal_mask_bias(k + 1, cache_len, offset=base, device=pipe.device)
            if drop_own:
                bias[0, 0, js, base + js] = NEG_INF
            logits, _ = llama_apply(
                pipe.llama, pipe.llama_cfg, hist[base:base + k + 1][None], base + js[None],
                bias, cache=cache, write_pos=base, lora=pipe.lora, policy=pipe.policy,
                verify=True)
            out.extend(logits[0, j] for j in range(1 if one_row else k + 1)
                       if base + j + 1 - t < n)
    return torch.stack(out)


def _rows_err(a, b):
    """{"max", "mean", "rows"} of |a - b| over rows 1.. (row 0 is the
    prefill's, shared by every teacher-forced run)."""
    d = (a[1:] - b[1:a.shape[0]]).abs()
    return {"max": float(d.max()), "mean": float(d.mean()), "rows": d.shape[0]}


def _verify_err(torch, calls, lanes):
    """Each verify row of ``calls`` (a _VerifyRecorder's) against the
    teacher-forced logits of its position. lanes: per batch row of the
    calls, (the sequence's ids, its prompt length t, its _tf_logits) or
    None. A row counts where the block's tokens up to it are the sequence's
    at their positions (a row after a rejected draft saw another context);
    its logits are those before the token at position p + 1, teacher-forced
    row p + 1 - t. Returns {"max", "mean", "rows"} over every compared
    logit."""
    got, want = [], []
    for tokens, positions, logits in calls:
        tokens, positions = tokens.cpu(), positions.cpu()
        for b, lane in enumerate(lanes):
            if lane is None:
                continue
            seq, t, tf = lane
            for j in range(tokens.shape[1]):
                p = int(positions[b, j])
                i = p + 1 - t
                if not (1 <= i < tf.shape[0]) or tokens[b, :j + 1].tolist() != seq[p - j:p + 1]:
                    break
                got.append(logits[b, j])
                want.append(tf[i])
    if not got:
        return {"max": float("nan"), "mean": float("nan"), "rows": 0}
    d = (torch.stack(got) - torch.stack(want)).abs()
    return {"max": float(d.max()), "mean": float(d.mean()), "rows": len(got)}


def _within(err, tol=SPEC_TOL) -> bool:
    return err["rows"] > 0 and err["max"] < tol["max"] and err["mean"] < tol["mean"]


def _first_parting(a, b) -> int:
    """The first index where two id lists differ (min length if neither)."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def _equal_share(a, b) -> float:
    n = max(len(a), len(b))
    return sum(x == y for x, y in zip(a, b)) / n if n else 1.0


def _verify_attention_card_vs_cpu(torch):
    """The int8 verify attention (models/llama.py ``_attention_int8_verify``)
    on the card against the CPU at B=1, T=5, H=32, D=128, S=VERIFY_S with
    constant scales and v codes of 100-127: near-uniform softmax weights
    quantize to ~127, so a p . v sum reaches ~127 x 113 x 1280 > 2^24,
    past f32's exact integers. The integer sums bitwise (and an f32 product
    on the card shown to miss them), the output within 1e-4."""
    from radialog_tpu_torch.models import llama as tl
    g = torch.Generator().manual_seed(VERIFY_S)
    b, t, h, d, s = 1, SPEC_K + 1, 32, 128, VERIFY_S
    q = torch.randn(b, t, h, d, generator=g) * 0.01
    k8 = torch.randint(-127, 128, (1, b, s, h * d), generator=g, dtype=torch.int8)
    v8 = torch.randint(100, 128, (1, b, s, h * d), generator=g, dtype=torch.int8)
    sc = torch.full((1, b, s, h), 0.02, dtype=torch.bfloat16)
    bias = torch.zeros(b, 1, t, s)
    cache = tl.KVCache(k8, v8, sc, sc)
    p8, _ = tl.quantize_kv(torch.softmax(torch.randn(b, h, t, s, generator=g) * 0.01, -1)
                           * 0.02, torch.float32)
    vv = v8[0].view(b, s, h, d).permute(0, 2, 1, 3)
    want = tl.int8_dot_exact(p8, vv)
    got = tl.int8_dot_exact(p8.cuda(), vv.cuda()).cpu()
    f32 = torch.matmul(p8.cuda().float(), vv.cuda().float()).cpu()
    ref = tl._attention_int8_verify(q, cache, 0, bias, d)
    out = tl._attention_int8_verify(q.cuda(), tl.KVCache(*(x.cuda() for x in (k8, v8, sc, sc))),
                                    0, bias.cuda(), d).cpu()
    res = {"s": s, "p8_min": int(p8.min()), "sum_max": float(want.abs().max()),
           "sums_bitwise": bool(torch.equal(got, want)),
           "f32_sums_differ": int((f32.double() != want).sum()),
           "out_max_abs_err": float((out - ref).abs().max())}
    res["ok"] = (res["sums_bitwise"] and res["sum_max"] > 2 ** 24 and res["f32_sums_differ"] > 0
                 and res["out_max_abs_err"] < 1e-4)
    return res


def phase_spec(torch, te, tq8, tfd, tfa, ev_state):
    """Speculative decoding at Vicuna-7B width on the eval phase's pipeline
    (W8A8, the same synthetic weights) and its prompts:
      * generate_spec (k = SPEC_K) on the first study's correction prompt
        with its image embeddings, SPEC_INT8_NEW new tokens over the int8 cache
        and SPEC_BF16_NEW over the bf16 one: verifies, tokens per verify, seconds, stream waits
        per verify (torch's sync debug mode), and where the tokens part from
        the eval phase's batch-1 loop on the same prompt (int8) and from the
        teacher-forced run's argmax (both);
      * the eval command line with --corr_spec CORR_SPEC_K over the eval
        phase's studies (main, the report pass answered from the eval
        phase's run on the same prompts, asserted): the correction pass
        through one SpecCompactBatcher, its seconds beside the batch-1
        loop's, verifies, tokens per verify, each correction's share of
        tokens equal to the batch-1 loop's, the four files;
      * SpecRingBatcher, the bf16 ring, RING_LANES sessions x RING_NEW tokens
        of image prompts;
      * the int8 verify attention, card against CPU at S = VERIFY_S.
    The bar of every speculative run: teacher forcing. Its first SPEC_TF_N
    tokens go through the engine's plain prefill and decode steps
    (_tf_logits), and
    every verify row whose context is the final sequence lies within
    SPEC_TOL of them (LOGIT_TOL is printed beside: it cannot hold at full
    width, see SPEC_TOL); the batch-1 runs' rows also equal, bitwise, the
    verify forward fed the same tokens (_tf_verify), in blocks of k + 1 and,
    over the first ONE_ROW_N rows, one row at a time; a verify whose rows
    miss their own slot (the control) must part from the latter, and its
    readings against both references are printed. Token equality is
    printed, not held: on random weights greedy picks sit near ties, and
    over the int8 cache the verify attention is another function than K2.
    Launches of K1, K2 and K3 are counted over the speculative runs only
    (no teacher forcing)."""
    import shutil
    from pathlib import Path
    from radialog_tpu_torch.apps import evaluate as ev
    from radialog_tpu_torch.decode import spec_ring as tsr
    from radialog_tpu_torch.decode import speculative as tsp
    pipe, corr = ev_state["pipe"], ev_state["corrections"]
    for attr in ("generate_texts", "label_reports"):     # the eval phase's timing wrappers
        pipe.__dict__.pop(attr, None)
    cfg, tok = pipe.llama_cfg, pipe.tokenizer
    counted = {"q8_matmul": tq8.q8_matmul_int32, "flash_decode_int8": tfd.flash_decode_int8_kernel,
               "flash_attention": tfa.flash_attention_kernel}
    launches = dict.fromkeys(counted, 0)

    def main_path(fn):
        torch.cuda.synchronize()
        for f in counted.values():
            f.launches = 0
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        for name, f in counted.items():
            launches[name] += f.launches
        return out, time.time() - t0

    torch.cuda.reset_peak_memory_stats()
    attn = _verify_attention_card_vs_cpu(torch)
    emit("spec", part="int8 verify attention, card vs CPU", **attn)
    ok = attn["ok"]

    # ---- batch-1 generate_spec on the first correction prompt
    import warnings
    prompt, emb = corr[0]["prompts"][0], corr[0]["embs"]
    ids = tok(prompt)["input_ids"]
    b1_loop = _tok_ids(corr[0]["out"][0][len(prompt):])
    runs = {}
    for kv_int8, new in ((True, SPEC_INT8_NEW), (False, SPEC_BF16_NEW)):
        dp = te.DecodeParams(max_new_tokens=new, eos_token_id=tok.eos_token_id)
        with _VerifyRecorder(tsp) as rec, warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                res, secs = main_path(lambda: tsp.generate_spec(
                    pipe.llama, cfg, torch.tensor([ids], device="cuda"), dp, k=SPEC_K,
                    img_embs=emb, lora=pipe.lora, policy=pipe.policy, kv_int8=kv_int8))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        gen = res.tokens[0, :int(res.lengths[0])].tolist()
        waits = [w for w in caught if "synchroniz" in str(w.message)]
        sites = {}
        for w in waits:     # where the host waited: file:line of the Python frame
            site = f"{os.path.basename(w.filename)}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
        runs[kv_int8] = {"rec": rec, "gen": gen, "seconds": secs, "iters": res.iters,
                         "waits": len(waits), "sites": sites,
                         "cache_len": te.bucket_length(len(ids) + new + SPEC_K + 1)}

    # ---- the eval command line with --corr_spec
    out_dir = Path("build/chip_eval_spec")
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = [a for a in ev_state["argv"] if a not in ("--do_cp_bin_qa", "--do_cp_all_qa")]
    argv[argv.index("--output_dir") + 1] = str(out_dir)
    argv += ["--corr_spec", str(CORR_SPEC_K)]
    made, ring_calls = [], []
    real_cls = tsr.SpecCompactBatcher

    class Recorded(real_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    report = ev_state["report"]

    def report_replay(prompts, img_embs=None, max_new_tokens=None, **kw):
        assert (list(prompts), max_new_tokens) == (report["prompts"], EVAL_NEW)
        assert torch.equal(img_embs, report["embs"])
        return report["out"]

    def ring(prompts, **kw):
        t0 = time.time()
        out = type(pipe).generate_texts_ring(pipe, prompts, **kw)
        torch.cuda.synchronize()
        ring_calls.append({"prompts": list(prompts), "embs": kw["img_embs"], "out": out,
                           "s": time.time() - t0, "lanes": kw["lanes"], "k": kw["spec_k"]})
        return out

    def factory(real, cfg_):
        pipe.generate_texts, pipe.generate_texts_ring = report_replay, ring
        return pipe
    tsr.SpecCompactBatcher = Recorded
    try:
        with _VerifyRecorder(tsr) as rec_c, _eval_pipelines(ev, factory):
            results, main_s = main_path(lambda: ev.main(argv))
    finally:
        tsr.SpecCompactBatcher = real_cls
        pipe.__dict__.pop("generate_texts", None)
        pipe.__dict__.pop("generate_texts_ring", None)
    rb, (rc,) = made[0], ring_calls
    sess = [rb.finished[s] for s in sorted(rb.finished)]
    files_ok, files = _eval_outputs(out_dir, results, EVAL_STUDIES)

    # ---- SpecRingBatcher, the bf16 ring
    reqs = _serve_requests(pipe, torch.cat([c["embs"] for c in corr]), RING_LANES, seed=21)
    sr = tsr.SpecRingBatcher(pipe.llama, cfg, lanes=RING_LANES, cache_len=PROMPT_REGION + RING_LEN,
                             prompt_len=PROMPT_REGION,
                             dp=te.DecodeParams(max_new_tokens=RING_NEW, eos_token_id=-1),
                             lora=pipe.lora, policy=pipe.policy, steps_per_call=RING_CHUNK,
                             spec_k=RING_K, device="cuda")
    with _VerifyRecorder(tsr) as rec_r:
        done, ring_s = main_path(lambda: [sr.submit(i, img_embs=e) for i, e in reqs] and sr.run())
    ring_sess = [done[s] for s in sorted(done)]
    spec_launches = dict(launches)

    # ---- the bar: teacher forcing, int8 then bf16
    t0 = time.time()
    n = SPEC_TF_N
    tf8 = _tf_logits(torch, te, pipe, [(ids, emb, runs[True]["gen"][:n])]
                     + [(s.prompt_ids, rc["embs"][i:i + 1], s.tokens[:n])
                        for i, s in enumerate(sess)], kv_int8=True)
    tf16 = _tf_logits(torch, te, pipe, [(ids, emb, runs[False]["gen"][:n])]
                      + [(s.prompt_ids, e, s.tokens[:n]) for s, (_, e) in zip(ring_sess, reqs)],
                      kv_int8=False)
    tf_s = time.time() - t0
    for kv_int8, tf in ((True, tf8[0]), (False, tf16[0])):
        r = runs[kv_int8]
        lane = (ids + r["gen"], len(ids))
        err = _verify_err(torch, r["rec"].calls, [lane + (tf,)])
        t0 = time.time()
        args = (torch, te, pipe, ids, emb, r["gen"], kv_int8, r["cache_len"], SPEC_K)
        exact = _verify_err(torch, r["rec"].calls, [lane + (_tf_verify(*args),)])
        one = _tf_verify(*args, n=ONE_ROW_N + 1, one_row=True)
        rowwise = _verify_err(torch, r["rec"].calls, [lane + (one,)])
        faulted = _tf_verify(*args, n=ONE_ROW_N + 1, drop_own=True)
        control = {"vs_one_row": _rows_err(faulted, one),
                   "vs_plain_steps": _rows_err(faulted, tf)}
        control["caught_by_one_row"] = control["vs_one_row"]["max"] > 0
        control["caught_by_spec_tol"] = not _within(control["vs_plain_steps"])
        verify_tf_s = time.time() - t0
        n = len(r["gen"])
        line = {"cache": "int8" if kv_int8 else "bf16", "k": SPEC_K, "prompt_tokens": len(ids),
                "new_tokens": n, "verifies": r["iters"],
                "tokens_per_verify": (n - 1) / max(r["iters"], 1), "seconds": r["seconds"],
                "stream_waits": r["waits"], "stream_waits_per_verify": r["waits"] / max(r["iters"], 1),
                "stream_wait_sites": r["sites"],
                "first_parting_from_plain_steps_argmax": _first_parting(
                    r["gen"], tf.argmax(-1).tolist()),
                "vs_plain_steps": err, "vs_plain_steps_within_logit_tol": _within(err, LOGIT_TOL),
                "vs_verify_forward": exact, "vs_one_row": rowwise,
                "control_missing_own_row": control, "verify_teacher_forcing_s": verify_tf_s,
                "ok": (_within(err) and exact["rows"] > 0 and exact["max"] == 0.0 and n > 0
                       and rowwise["rows"] > 0 and rowwise["max"] == 0.0
                       and control["caught_by_one_row"])}
        if kv_int8:
            line["batch1_loop_seconds"] = corr[0]["s"]
            line["first_parting_from_batch1_loop"] = _first_parting(
                [x for x in r["gen"] if x > 2], b1_loop)
        emit("spec", part="generate_spec, batch 1", **line)
        ok = ok and line["ok"]
        r["rec"].calls.clear()
    lanes = [(s.prompt_ids + s.tokens, len(s.prompt_ids), tf8[1 + i]) for i, s in enumerate(sess)]
    per_lane = [_verify_err(torch, rec_c.calls, [lane if j == i else None for j in range(len(sess))])
                for i, lane in enumerate(lanes)]
    b1_ids = [_tok_ids(c["out"][0][len(c["prompts"][0]):]) for c in corr]
    gen_tokens = sum(len(s.tokens) - 1 for s in sess)
    line = {"argv": argv, "seconds": main_s, "correction_s": rc["s"],
            "batch1_loop_correction_s": [c["s"] for c in corr], "lanes": rc["lanes"], "k": rc["k"],
            "cache_len": rb.cache_len, "kv_int8": rb.kv_int8, "verifies": rb.verifies,
            "tokens_per_verify": gen_tokens / max(rb.verifies, 1),
            "new_tokens": [len(s.tokens) for s in sess],
            "equal_share_to_batch1_loop": [_equal_share([x for x in s.tokens if x > 2], b)
                                           for s, b in zip(sess, b1_ids)],
            "vs_plain_steps_per_lane": per_lane,
            "vs_plain_steps_within_logit_tol": [_within(e, LOGIT_TOL) for e in per_lane],
            "metrics": results, **files}
    line["ok"] = (files_ok and len(sess) == EVAL_STUDIES and rb.kv_int8
                  and all(_within(e) for e in per_lane)
                  and [c["prompts"][0] for c in corr] == rc["prompts"])
    emit("spec", part="SpecCompactBatcher, eval --corr_spec", **line)
    ok = ok and line["ok"]
    rec_c.calls.clear()
    per_lane = [_verify_err(torch, rec_r.calls, [
        (s.prompt_ids + s.tokens, len(s.prompt_ids), tf16[1 + i]) if j == i else None
        for j in range(RING_LANES)]) for i, s in enumerate(ring_sess)]
    line = {"lanes": RING_LANES, "sessions": len(ring_sess), "new_tokens": RING_NEW, "k": RING_K,
            "steps_per_call": RING_CHUNK, "cache_len": sr.cache_len, "seconds": ring_s,
            "verifies": sr.verifies,
            "tokens_per_verify": sum(len(s.tokens) - 1 for s in ring_sess) / max(sr.verifies, 1),
            "prompt_tokens": [len(i) for i, _ in reqs], "vs_plain_steps_per_lane": per_lane,
            "vs_plain_steps_within_logit_tol": [_within(e, LOGIT_TOL) for e in per_lane],
            "ok": all(_within(e) for e in per_lane) and all(len(s.tokens) == RING_NEW
                                                            for s in ring_sess)}
    emit("spec", part="SpecRingBatcher, bf16 ring", **line)
    ok = ok and line["ok"]
    rec_r.calls.clear()
    emit("spec", part="summary", launches=spec_launches, teacher_forcing_s=tf_s,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, ok=ok)
    if not ok or spec_launches["q8_matmul"] == 0 or spec_launches["flash_attention"] == 0:
        raise AssertionError("the speculative phase failed a check")
    return spec_launches


def _copy_session(session):
    """A second InteractiveSession in the same state, with its own cache."""
    twin = type(session).__new__(type(session))
    for name in ("params", "cfg", "lora", "policy", "cache_len", "device", "cur_len",
                 "_last_logits"):
        setattr(twin, name, getattr(session, name))
    twin.cache = type(session.cache)(session.cache.k.clone(), session.cache.v.clone())
    twin.token_ids, twin._pending_tail = list(session.token_ids), list(session._pending_tail)
    return twin


def phase_chat(torch, te, tq8, tfd, tfa, sl):
    """The chat app at Vicuna-7B width on the slice's W8A8 pipeline:
    ChatSession(speculative=True, spec_k=CHAT_K) over the session's bf16
    cache, with a tokenizer whose replies re-tokenize to their own ids (so
    turns prefill incrementally). First the image's / 255 on the card
    against the CPU for all 256 uint8 values (expand_cxr_u8, preprocess_cxr;
    the old form x / 255.0 beside them). The image turn on the slice's first
    synthetic X-ray writes a 300-token report; then, CHAT_NEW tokens a
    turn: a follow-up whose incremental-prefill logits are held against a
    full re-prefill of the whole conversation (SPEC_TOL: other block
    shapes over the bf16 cache; LOGIT_TOL printed beside); a speculative
    turn teacher-forced through the plain session on the same history
    (decode steps fed its tokens; SPEC_TOL); an ask_stream turn whose tokens
    must equal ask's on the same history (a plain session). Seconds per
    turn, to the first streamed chunk, verifies, tokens per verify, peak
    memory; K1/K2/K3 launches over the chat's own turns (each counted from
    0 just before it; the full re-prefill, the plain session and ask's twin
    run outside those windows). Then the demo's command line
    (python -m radialog_tpu_torch.apps.demo --cli --mock) with two turns on
    stdin."""
    import copy
    from radialog_tpu_torch.apps.chat import ChatSession
    from radialog_tpu_torch.decode import speculative as tsp
    from radialog_tpu_torch.decode.session import InteractiveSession
    from radialog_tpu_torch.ops import image as timage
    pipe = sl["pipe"]
    cfg = pipe.llama_cfg
    torch.cuda.reset_peak_memory_stats()
    # ---- the image's division by 255, card against CPU
    u8 = torch.arange(256, dtype=torch.uint8).reshape(16, 16)
    big = u8.repeat(28, 28)                 # 448 x 448: resize and crop are the identity
    audit = {"expand_cxr_u8_bitwise": bool(torch.equal(
                 timage.expand_cxr_u8(u8.cuda()[None]).cpu(), timage.expand_cxr_u8(u8[None]))),
             "preprocess_cxr_bitwise": bool(torch.equal(
                 timage.preprocess_cxr(big.cuda(), 448, 448).cpu(),
                 timage.preprocess_cxr(big, 448, 448))),
             "old_form_values_differing": int((u8.cuda().float() / 255.0).cpu().ne(
                 u8.float() / 255.0).sum())}
    emit("chat", part="image / 255, card vs CPU, all 256 uint8 values", **audit,
         ok=audit["expand_cxr_u8_bitwise"] and audit["preprocess_cxr_bitwise"])
    ok = audit["expand_cxr_u8_bitwise"] and audit["preprocess_cxr_bitwise"]
    counted = {"q8_matmul": tq8.q8_matmul_int32, "flash_decode_int8": tfd.flash_decode_int8_kernel,
               "flash_attention": tfa.flash_attention_kernel}
    chat_launches = dict.fromkeys(counted, 0)
    real_tok, real_new = pipe.tokenizer, pipe.cfg.max_new_tokens
    pipe.tokenizer = _RoundTrip(real_tok)
    try:
        g = torch.Generator(device="cuda").manual_seed(3)    # the report batch's first X-ray
        x448 = torch.randint(0, 256, (BATCH, 448, 448), generator=g, device="cuda",
                             dtype=torch.uint8)[:1]
        x488 = torch.randint(0, 256, (BATCH, 488, 488), generator=g, device="cuda",
                             dtype=torch.uint8)[:1]
        cs = ChatSession(pipe, speculative=True, spec_k=CHAT_K)
        replies = {}
        real_spec = cs.session.generate_spec

        def spec(dp, k=4, m=3):
            replies["ids"] = real_spec(dp, k=k, m=m)
            return replies["ids"]
        cs.session.generate_spec = spec

        def turn(fn, chat=True):
            """fn's result, seconds and verify calls; the launches of a
            chat turn (not of a reference run) are counted."""
            torch.cuda.synchronize()
            for f in counted.values():
                f.launches = 0
            t0 = time.time()
            with _VerifyRecorder(tsp) as rec:
                out = fn()
            torch.cuda.synchronize()
            secs = time.time() - t0
            if chat:
                for name, f in counted.items():
                    chat_launches[name] += f.launches
            return out, secs, rec
        pipe.cfg.max_new_tokens = 300
        (report, findings), image_s, rec = turn(lambda: cs.image_turn(
            timage.expand_cxr_u8(x448)[0], timage.expand_cxr_u8(x488)[0], "chip-xray-0"))
        n = len(replies["ids"])
        emit("chat", part="image turn", findings=findings, report_tokens=n, seconds=image_s,
             verifies=len(rec.calls), tokens_per_verify=(n - 1) / max(len(rec.calls), 1),
             ok=n == 300 or replies["ids"][-1] == real_tok.eos_token_id)
        ok = ok and n > 0
        rec.calls.clear()
        pipe.cfg.max_new_tokens = CHAT_NEW

        # ---- follow-up: incremental prefill against a full re-prefill
        seen = {}
        real_append = cs.session.append_tokens      # bound before the stand-in is set

        def append(delta, img_embs=None):
            seen["cur_len"] = cs.session.cur_len
            real_append(delta, img_embs=img_embs)
            seen["logits"], seen["ids"] = cs.session._last_logits.clone(), list(cs.session.token_ids)
        cs.session.append_tokens = append
        q1 = "Are there any signs of pneumonia or of a pleural effusion in this image?"
        reply1, s1, rec = turn(lambda: cs.ask(q1))
        del cs.session.append_tokens
        full = InteractiveSession(pipe.llama, cfg, lora=pipe.lora, policy=pipe.policy,
                                  cache_len=cs.session.cache_len, device="cuda")
        with torch.no_grad():
            full.append_tokens(seen["ids"], img_embs=cs.img_embs)
        d = (seen["logits"] - full._last_logits).abs()
        err = {"max": float(d.max()), "mean": float(d.mean()), "rows": 1}
        del full
        line = {"incremental_from": seen["cur_len"], "conversation_tokens": len(seen["ids"]),
                "reply_tokens": len(replies["ids"]), "seconds": s1, "verifies": len(rec.calls),
                "incremental_vs_full_prefill": err,
                "within_logit_tol": _within(err, LOGIT_TOL),
                "ok": seen["cur_len"] > 0 and _within(err)}
        emit("chat", part="follow-up turn", **line)
        ok = ok and line["ok"]
        rec.calls.clear()

        # ---- speculative turn, teacher-forced through the plain session
        plain = _copy_session(cs.session)
        conv = cs.conv.copy()
        q2 = "Please rewrite the report in plain words for the patient, sentence by sentence."
        reply2, s2, rec = turn(lambda: cs.ask(q2))
        got = replies["ids"]
        conv.append_user(q2)
        conv.append_assistant(None)
        full_ids = pipe.tokenizer(conv.get_prompt())["input_ids"]
        prev = plain.token_ids + plain._pending_tail
        assert full_ids[:len(prev)] == prev
        with torch.no_grad():
            plain.append_tokens(full_ids[len(prev):])
            t = plain.cur_len
            lens = torch.tensor([t], device="cuda")
            tf = [plain._last_logits[0]]
            for step, tk in enumerate(got[:-1]):
                tf.append(te.decode_step(pipe.llama, cfg, plain.cache,
                                         torch.tensor([tk], device="cuda"), lens, t, step,
                                         lora=pipe.lora, policy=pipe.policy)[0])
        err = _verify_err(torch, rec.calls, [(plain.token_ids + got, t, torch.stack(tf))])
        line = {"reply_tokens": len(got), "seconds": s2, "verifies": len(rec.calls),
                "tokens_per_verify": (len(got) - 1) / max(len(rec.calls), 1),
                "first_parting_from_plain_steps_argmax": _first_parting(
                    got, torch.stack(tf).argmax(-1).tolist()),
                "vs_plain_steps": err, "vs_plain_steps_within_logit_tol": _within(err, LOGIT_TOL),
                "ok": _within(err)}
        emit("chat", part="speculative turn", **line)
        ok = ok and line["ok"]
        rec.calls.clear()
        del plain, tf

        # ---- ask_stream against ask on the same history
        twin = copy.copy(cs)
        twin.session, twin.conv, twin.speculative = _copy_session(cs.session), \
            cs.conv.copy(), False
        q3 = "Is the heart size normal?"
        first = []

        def stream():
            t0 = time.time()
            out = []
            for part in cs.ask_stream(q3, chunk_size=CHAT_CHUNK):
                if not out:
                    torch.cuda.synchronize()
                    first.append(time.time() - t0)
                out.append(part)
            return out
        partials, stream_s, _ = turn(stream)
        first_s = first[0] if first else None
        want, ask_s, _ = turn(lambda: twin.ask(q3), chat=False)
        del twin
        line = {"chunks": len(partials), "chunk": CHAT_CHUNK, "seconds": stream_s,
                "first_chunk_s": first_s, "ask_seconds": ask_s,
                "reply_words": len(want.split()), "equal_to_ask": partials[-1] == want,
                "ok": bool(partials) and partials[-1] == want}
        emit("chat", part="ask_stream turn", **line)
        ok = ok and line["ok"]
    finally:
        pipe.tokenizer, pipe.cfg.max_new_tokens = real_tok, real_new
    peak = torch.cuda.max_memory_allocated() / 1e9

    # ---- the demo's command line on the card
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "radialog_tpu_torch.apps.demo", "--cli", "--mock"],
                          input="Hello, what can you see in this scan?\nIs there any pneumonia?\n"
                                "quit\n", capture_output=True, text=True, timeout=300)
    demo_ok = proc.returncode == 0 and proc.stdout.count("ASSISTANT:") == 2
    emit("chat", part="demo --cli --mock", rc=proc.returncode, seconds=time.time() - t0,
         stdout_tail=proc.stdout[-600:], stderr_tail=proc.stderr[-600:], ok=demo_ok)
    emit("chat", part="summary", launches=chat_launches, peak_mem_gb=peak, ok=ok and demo_ok)
    if not (ok and demo_ok) or chat_launches["q8_matmul"] == 0:
        raise AssertionError("the chat phase failed a check")
    return chat_launches


def _serve_requests(pipe, embs, n, seed):
    """n image prompts of 100-250 tokens (BOS included): words, the <IMG>
    run, words; each with one row of the pipeline's own image embeddings."""
    import numpy as np
    rng = np.random.default_rng(seed)
    img = pipe.llama_cfg.num_img_tokens
    out = []
    for j in range(n):
        total = int(rng.integers(100, 251))
        head = int(rng.integers(5, 40))
        text = (" ".join(f"c{j}h{i}" for i in range(head)) + " " + "<IMG> " * img
                + " ".join(f"c{j}w{i}" for i in range(total - 1 - head - img)))
        ids = pipe.tokenizer(text)["input_ids"]
        assert len(ids) == total, (len(ids), total)
        out.append((ids, embs[j % embs.shape[0]][None]))
    return out


def _serve_run(torch, counted, params, pipe, requests, new, clients, bad=None, kv_int8=True):
    """One server over ``params`` and the int8 ring (or, without
    ``kv_int8``, the bf16 one): warm-up, then ``clients`` threads submit
    the requests (each streams its deltas) and, with ``bad``, one oversized
    prompt. Returns the numbers and whether every check held."""
    import threading
    from radialog_tpu_torch.apps.serve import RaDialogServer
    from radialog_tpu_torch.decode.continuous import _bucket32
    from radialog_tpu_torch.decode.engine import DecodeParams
    cfg = pipe.llama_cfg
    srv = RaDialogServer(params, cfg, lanes=LANES, cache_len=CACHE_LEN,
                         prompt_len=PROMPT_REGION,
                         dp=DecodeParams(max_new_tokens=new, eos_token_id=-1), lora=pipe.lora,
                         policy=pipe.policy, steps_per_call=CHUNK, kv_int8=kv_int8,
                         device=pipe.device)
    rb = srv._rb
    results, streamed, first_s, errors = {}, {}, {}, []
    try:
        warm_s = srv.warmup(prompt_buckets=(128, 256), timeout=600)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counted.values():
            fn.launches = 0
        ring0 = rb.ring_pos
        t0 = time.time()

        def client(c):
            try:
                futs = []
                for j in range(c, len(requests), clients):
                    ids, emb = requests[j]
                    streamed[j] = []
                    submitted = time.time()

                    def on_tokens(delta, done, j=j, submitted=submitted):
                        if delta and j not in first_s:
                            first_s[j] = time.time() - submitted
                        streamed[j].append((list(delta), done))
                    futs.append((j, srv.submit(ids, img_embs=emb, on_tokens=on_tokens)))
                for j, f in futs:
                    results[j] = f.result(timeout=900)
            except Exception as exc:   # reported by the caller, which fails the phase
                errors.append(repr(exc))

        threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
        for t in threads:
            t.start()
        bad_error = None
        if bad is not None:
            try:
                srv.submit(bad).result(timeout=900)
            except ValueError as exc:
                bad_error = str(exc)
        for t in threads:
            t.join(timeout=900)
        torch.cuda.synchronize()
        seconds = time.time() - t0
    finally:
        srv.shutdown()
    steps = rb.ring_pos - ring0
    forwards = steps + len(requests)            # decode steps and batch-1 prefills
    launches = {name: fn.launches for name, fn in counted.items()}
    k3_prefills = sum(_bucket32(len(ids)) >= 256 for ids, _ in requests)
    firsts = sorted(first_s.values())
    ok = (not errors and not any(t.is_alive() for t in threads)
          and sorted(results) == list(range(len(requests)))
          and all(len(results[j]) == new for j in results)
          and all([x for d, _ in streamed[j] for x in d] == results[j]
                  and [done for _, done in streamed[j]].count(True) == 1
                  and streamed[j][-1][1] for j in results)
          and all(0 <= x < cfg.vocab_size for r in results.values() for x in r)
          and (bad is None or (bad_error is not None and "prompt region" in bad_error))
          and launches["flash_decode_int8"] == (cfg.num_layers * steps if kv_int8 else 0)
          and launches["flash_attention"] == cfg.num_layers * k3_prefills
          and len(firsts) == len(requests) and rb.active_lanes == 0 and not rb.finished)
    numbers = {"sessions": len(requests), "new_tokens": new, "clients": clients,
               "lanes": LANES, "prompt_region": PROMPT_REGION, "ring_len": rb.ring_len,
               "steps_per_call": CHUNK, "seconds": seconds, "warmup_s": warm_s,
               "tokens_per_s": len(requests) * new / seconds,
               "first_token_s_median": statistics.median(firsts) if firsts else None,
               "first_token_s_max": max(firsts) if firsts else None,
               "decode_steps": steps, "ms_per_decode_step_and_admissions": seconds / steps * 1e3,
               "ring_pos": rb.ring_pos, "prompt_tokens": [len(ids) for ids, _ in requests],
               "k3_prefills": k3_prefills, "launches": launches, "oversized_error": bad_error,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "errors": errors}
    return numbers, ok, forwards


def phase_serve(torch, tq8, tfd, tfa, tq4, sl):
    """Interactive multi-session serving at Vicuna-7B width on the slice's
    weights and image embeddings, W8A8 and then W4A8 layers."""
    from radialog_tpu_torch.ops.quant import random_serving_params
    pipe, embs = sl["pipe"], sl["embs"]
    cfg = pipe.llama_cfg
    counted = {"q8_matmul": tq8.q8_matmul_int32, "flash_decode_int8": tfd.flash_decode_int8_kernel,
               "flash_attention": tfa.flash_attention_kernel, "q4_matmul": tq4.q4_matmul_acc}
    requests = _serve_requests(pipe, embs, SESSIONS, seed=11)
    bad = list(range(3, 3 + PROMPT_REGION + 44))        # 300 tokens: over the prompt region
    w8, ok8, forwards = _serve_run(torch, counted, pipe.llama, pipe, requests, SESSION_NEW,
                                   CLIENTS, bad=bad)
    per_forward = 4 * cfg.num_layers
    ok8 = (ok8 and w8["ring_pos"] > w8["ring_len"]
           and w8["launches"]["q8_matmul"] == (per_forward + 1) * forwards
           and w8["launches"]["q4_matmul"] == 0)
    emit("serve", weights="W8A8", ok=ok8, **w8)
    if not ok8:
        raise AssertionError("the full-width serve phase (W8A8) failed a check")
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(12)
    params4 = random_serving_params(cfg, gen, bits=4)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    w4, ok4, forwards = _serve_run(torch, counted, params4, pipe, requests[:W4_SESSIONS], W4_NEW,
                                   CLIENTS)
    ok4 = (ok4 and w4["launches"]["q4_matmul"] == per_forward * forwards
           and w4["launches"]["q8_matmul"] == forwards)
    emit("serve", weights="W4A8", ok=ok4, params_build_s=build_s, **w4)
    if not ok4:
        raise AssertionError("the full-width serve phase (W4A8) failed a check")
    return w8["launches"], w4["launches"]


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _float_report(torch, pipe, counted):
    """The float report pass: BATCH images, PROMPT-token prompts,
    FLOAT_REPORT_NEW greedy tokens with EOS disabled, after a warm-up.
    Returns (numbers, ok, embs)."""
    from radialog_tpu_torch.decode.engine import default_cache_len
    cfg = pipe.llama_cfg
    _, ids, report_step = _report_batch(torch, pipe)
    report_step(8)                      # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counted)
    t0 = time.time()
    findings, embs, res = report_step(FLOAT_REPORT_NEW)
    tokens = res.tokens.cpu()
    dt = time.time() - t0
    launches = _read(counted)
    cache_len = default_cache_len(PROMPT, pipe.decode_params(max_new_tokens=FLOAT_REPORT_NEW))
    ok = (tokens.shape == (BATCH, FLOAT_REPORT_NEW) and int(tokens.min()) >= 0
          and int(tokens.max()) < cfg.vocab_size and all(res.lengths.cpu() == FLOAT_REPORT_NEW)
          and bool(torch.isfinite(embs).all()) and embs.shape == (BATCH, 32, 768)
          and len(findings) == BATCH and all(v == 0 for v in launches.values())
          and isinstance(pipe.llama["layers"], dict)
          and pipe.llama["layers"]["wq"]["w"].dtype == torch.bfloat16
          and pipe._shared_prefix_len(ids, embs) == (0, False))
    cache_bytes = 2 * cfg.num_layers * BATCH * cache_len * cfg.hidden_size * 2
    # a decode step reads every weight but the embedding table, and the
    # whole cache, once
    step_bytes = _tree_bytes({k: v for k, v in pipe.llama.items() if k != "embed"}) + cache_bytes
    numbers = {"reports_per_s": BATCH / dt, "seconds": dt, "batch": BATCH, "prompt": PROMPT,
               "new_tokens": FLOAT_REPORT_NEW, "cache_len": cache_len, "launches": launches,
               "ms_per_token_all_stages": dt / FLOAT_REPORT_NEW * 1e3, "cache_gb": cache_bytes / 1e9,
               "decode_step_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "distinct_tokens": int(tokens.unique().numel())}
    return numbers, ok, embs


def _float_continuous(torch, te, pipe, embs, counted):
    """ContinuousBatcher over the float weights: CB_SESSIONS staggered
    image sessions through CB_LANES lanes, each session's logits (its
    admission's and those of every step it took part in) held against the
    same session's prefill and decode steps run alone at batch 1 and
    teacher-forced with its tokens, and its tokens against its solo
    ``generate``."""
    from radialog_tpu_torch.decode import continuous as dc
    cfg, dev = pipe.llama_cfg, pipe.device
    requests = _serve_requests(pipe, embs, CB_SESSIONS, seed=13)
    dp = te.DecodeParams(max_new_tokens=CB_NEW, eos_token_id=-1)
    cb = dc.ContinuousBatcher(pipe.llama, cfg, lanes=CB_LANES, cache_len=CB_CACHE, dp=dp,
                              lora=pipe.lora, policy=pipe.policy, device=dev)
    seen = []           # per forward: ("admit" or "step", logits rows, lane -> sid)
    real = dc.llama_apply

    def recording(*args, **kw):
        logits, out = real(*args, **kw)
        if kw.get("cache") is None:
            seen.append(("admit", logits[0, 0].float().cpu(), None))
        else:
            seen.append(("step", logits[:, 0].float().cpu(),
                         [s.sid if s is not None else None for s in cb.lane_session]))
        return logits, out

    dc.llama_apply = recording
    try:
        _zero(counted)
        batches, sids, it = [2, 3, 3], [], iter(requests)
        for n, steps in zip(batches, (3, 5, 0)):
            sids += [cb.submit(ids, img_embs=e) for ids, e in (next(it) for _ in range(n))]
            for _ in range(steps):
                cb.step()
        finished = cb.run()
        torch.cuda.synchronize()
        launches = _read(counted)
    finally:
        dc.llama_apply = real
    per = {sid: [] for sid in sids}
    admitted = iter(sids)        # admission is first in, first out
    for kind, rows, lanes in seen:
        if kind == "admit":
            per[next(admitted)].append(rows)
        else:
            for lane, sid in enumerate(lanes):
                if sid is not None:
                    per[sid].append(rows[lane])
    worst, mean, margin, same, std = 0.0, [], 0.0, [], []
    with torch.no_grad():
        for sid, (ids, e) in zip(sids, requests):
            toks = finished[sid].tokens
            tok = torch.tensor([ids], dtype=torch.int32, device=dev)
            lens = torch.tensor([len(ids)], dtype=torch.int32, device=dev)
            cache, logits = te.prefill(pipe.llama, cfg, tok, lens,
                                       te.default_cache_len(len(ids), dp), img_embs=e,
                                       lora=pipe.lora, policy=pipe.policy, kv_int8=False)
            solo = [logits[0]]
            for step, t in enumerate(toks[:-1]):
                solo.append(te.decode_step(pipe.llama, cfg, cache,
                                           torch.tensor([t], dtype=torch.int32, device=dev),
                                           lens, len(ids), step, lora=pipe.lora,
                                           policy=pipe.policy)[0])
            solo = torch.stack(solo).float().cpu()
            got = torch.stack(per[sid])
            diff = (got - solo).abs()
            worst, std = max(worst, float(diff.max())), std + [float(solo.std())]
            mean.append(float(diff.mean()))
            picked = solo[torch.arange(len(toks)), torch.tensor(toks)]
            margin = max(margin, float((solo.max(dim=-1).values - picked).max()))
            alone = te.generate(pipe.llama, cfg, tok, lens, dp, img_embs=e, lora=pipe.lora,
                                policy=pipe.policy, kv_int8=False).tokens[0].tolist()
            same.append(sum(a == b for a, b in zip(alone, toks)) / len(toks))
    k3_admissions = sum(dc._bucket32(len(ids)) >= 256 for ids, _ in requests)
    numbers = {"sessions": len(sids), "lanes": CB_LANES, "cache_len": CB_CACHE,
               "new_tokens": CB_NEW, "prompt_tokens": [len(ids) for ids, _ in requests],
               "k3_admissions": k3_admissions, "launches": launches, "tol": CB_TOL,
               "logit_max_abs_err": worst, "logit_mean_abs_err": max(mean),
               "logit_std": statistics.mean(std), "largest_margin_of_its_token": margin,
               "token_share_equal_to_solo_generate": statistics.mean(same)}
    ok = (sorted(finished) == sorted(sids) and all(len(finished[s].tokens) == CB_NEW for s in sids)
          and all(len(per[s]) == CB_NEW for s in sids)
          and launches["flash_attention"] == cfg.num_layers * k3_admissions
          and all(v == 0 for k, v in launches.items() if k != "flash_attention")
          and worst < CB_TOL["max"] and max(mean) < CB_TOL["mean"]
          and margin < CB_TOL["margin"])
    return numbers, ok


def _float_eval(torch, pipeline_mod, tfa, counted):
    """The eval command line without --int8 (the root test.py's default: the
    float pipeline) at full width over FLOAT_STUDIES fixture studies, every
    pass, files under build/chip_eval_float/. K3 is held against its plain
    version on the inputs the run gave it in the correction prefill and in
    the binary-QA batch (every 8th layer)."""
    import shutil
    from pathlib import Path
    from radialog_tpu_torch.apps import evaluate as ev
    out_dir = Path("build/chip_eval_float")
    shutil.rmtree(out_dir, ignore_errors=True)
    made, calls, state = [], [], {"corr": None}
    passes = {ev.CORRECTION_NEW: "correction", 10: "binary_qa"}
    timed = _timed_pipelines(torch, made, calls, state,
                             lambda new, n: (passes[new], n) if new in passes else None)
    k3 = _Kept(tfa.flash_attention_kernel, tfa.flash_attention_plain, state,
               lambda st, i, a: st["corr"] is not None and i % 8 == 0)
    argv = _eval_argv(["--synthetic"], out_dir, FLOAT_STUDIES, EVAL_NEW)
    tfa.flash_attention_kernel = k3
    try:
        with _eval_pipelines(ev, timed):
            _zero(counted)
            torch.cuda.synchronize()
            t0 = time.time()
            results = ev.main(argv)
            torch.cuda.synchronize()
            seconds = time.time() - t0
            launches = {**_read(counted), "flash_attention": k3.launches}
    finally:
        tfa.flash_attention_kernel = k3.kernel
    pipe = made[0]
    held = _eval_holds(torch, {"flash_attention": k3})
    gens = [c for c in calls if "new" in c]
    by = {n: [c for c in gens if c["new"] == n] for n in (EVAL_NEW, ev.CORRECTION_NEW, 10, 30)}
    k3_want = pipe.llama_cfg.num_layers * sum(_k3_forwards(pipeline_mod, pipe, c["prompts"],
                                                           c["embs"]) for c in gens)
    files_ok, files = _eval_outputs(out_dir, results, FLOAT_STUDIES)
    per_pass = {"report": sum(c["s"] for c in by[EVAL_NEW]),
                "correction": sum(c["s"] for c in by[ev.CORRECTION_NEW]),
                "binary_qa": sum(c["s"] for c in by[10]), "all_qa": sum(c["s"] for c in by[30]),
                "labels": sum(c["s"] for c in calls if "labels" in c)}
    tok = pipe.tokenizer
    numbers = {"seconds": seconds, "seconds_per_pass": per_pass, "studies": FLOAT_STUDIES,
               "argv": argv, "launches": launches, "k3_predicted": k3_want,
               "prompt_tokens": {n: [len(tok(p)["input_ids"]) for c in by[n] for p in c["prompts"]]
                                 for n in by},
               "held_on_the_run_s_inputs": held, "metrics": results, **files}
    ok = (files_ok and not pipe.cfg.quantize and isinstance(pipe.llama["layers"], dict)
          and len(gens) == sum(len(x) for x in by.values()) and len(by[EVAL_NEW]) == 1
          and len(by[ev.CORRECTION_NEW]) == FLOAT_STUDIES and len(by[10]) == FLOAT_STUDIES
          and all(o.startswith(p) for c in gens for o, p in zip(c["out"], c["prompts"]))
          and launches["flash_attention"] == k3_want > 0
          and all(v == 0 for k, v in launches.items() if k != "flash_attention")
          and held and all(h["ok"] for h in held)
          and {h["study"][0] for h in held} == set(passes.values()))
    made.clear()
    k3.kept.clear()
    return numbers, ok


def _zero(counted):
    for fn in counted.values():
        fn.launches = 0


def _read(counted):
    return {name: fn.launches for name, fn in counted.items()}


def phase_float(torch, te, pipeline_mod, tq8, tfd, tfa, tq4):
    """The float path at Vicuna-7B width: bf16 weights in the stacked
    layout over the bf16 cache (PipelineConfig(quantize=False), the JAX
    package's default), random from a seed. The report pass, the server and
    ContinuousBatcher on its weights, then the eval command line without
    --int8 (its own pipeline). No part launches K1, K2 or K4; K3 runs in
    every cache-free prefill of 256 tokens or more, as _use_flash predicts.
    Returns the K3 launches of the phase's runs."""
    counted = {"q8_matmul": tq8.q8_matmul_int32, "flash_decode_int8": tfd.flash_decode_int8_kernel,
               "flash_decode_int8_current": tfd.flash_decode_int8_current_kernel,
               "flash_attention": tfa.flash_attention_kernel, "q4_matmul": tq4.q4_matmul_acc}
    t0 = time.time()
    pipe = pipeline_mod.RaDialogPipeline(pipeline_mod.PipelineConfig(synthetic=True,
                                                                     quantize=False, seed=0))
    torch.cuda.synchronize()
    build_s = time.time() - t0
    report, ok, embs = _float_report(torch, pipe, counted)
    emit("float", part="report", build_s=build_s, weights_gb=_tree_bytes(pipe.llama) / 1e9,
         ok=ok, **report)
    if not ok:
        raise AssertionError("the full-width float report pass failed a check")
    requests = _serve_requests(pipe, embs, FLOAT_SESSIONS, seed=11)
    serve, ok, _ = _serve_run(torch, counted, pipe.llama, pipe, requests, FLOAT_NEW, CLIENTS,
                              kv_int8=False)
    ok = (ok and serve["k3_prefills"] > 0
          and all(v == 0 for k, v in serve["launches"].items() if k != "flash_attention"))
    emit("float", part="serve", weights="bf16, stacked", ok=ok, **serve)
    if not ok:
        raise AssertionError("the full-width float server failed a check")
    cont, ok = _float_continuous(torch, te, pipe, embs, counted)
    emit("float", part="continuous_batcher", ok=ok, **cont)
    if not ok:
        raise AssertionError("the full-width ContinuousBatcher failed a check")
    del pipe, embs, requests
    gc.collect()
    torch.cuda.empty_cache()
    evl, ok = _float_eval(torch, pipeline_mod, tfa, counted)
    emit("float", part="eval", ok=ok, **evl)
    if not ok:
        raise AssertionError("the full-width float eval run failed a check")
    return {"report": report["launches"]["flash_attention"],
            "serve": serve["launches"]["flash_attention"],
            "continuous_batcher": cont["launches"]["flash_attention"],
            "eval": evl["launches"]["flash_attention"]}


def _checksum(torch, base):
    """A few sums over the frozen base, to show that a run left it as it was."""
    wq = base["layers"]["wq"]
    return [int(wq["w_q"][::8].to(torch.int32).sum()), float(wq["scale"].sum()),
            float(base["embed"].float().sum()),
            int(base["lm_head"]["w_q"][::64].to(torch.int32).sum()),
            float(base["layers"]["input_ln"].sum())]


def _train_run(torch, tfa, ft, base, data, out_dir, flash):
    """TRAIN_STEPS micro-steps of apps/finetune_lora.train at full width on
    ``base``; the first step warms up. Returns the numbers and whether every
    check held."""
    from radialog_tpu_torch.core.checkpoint import load_checkpoint
    from radialog_tpu_torch.train.optim import tree_leaves
    counted = {"flash_attention": tfa.flash_attention_kernel,
               "flash_attention_dq": tfa.flash_attention_dq_kernel,
               "flash_attention_dkv": tfa.flash_attention_dkv_kernel}
    cfg = ft.FinetuneConfig(synthetic=True, data_path=data, output_dir=out_dir,
                            batch_size=MICRO * ACCUM, micro_batch_size=MICRO, num_epochs=4,
                            max_steps=TRAIN_STEPS, cutoff_len=CUTOFF, val_set_size=2,
                            use_embs=True, use_instruct_data=True, quantize_base=True,
                            flash=flash)
    before = _checksum(torch, base)
    stamps, per_step, logs = [], [], []

    def on_step(step, metrics):
        torch.cuda.synchronize()
        stamps.append(time.time())
        per_step.append({"loss": float(metrics["loss"]),
                         "grad_norm": float(metrics["grad_norm"]),
                         "tokens": metrics["tokens"],
                         **{n: f.launches for n, f in counted.items()}})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted.values():
        fn.launches = 0
    t0 = time.time()
    state = ft.train(cfg, log_fn=logs.append, on_step=on_step, base=base)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = {n: f.launches for n, f in counted.items()}
    layers = 32
    per = {n: [b[n] - a[n] for a, b in zip(per_step, per_step[1:])] for n in counted}
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    losses = [m["loss"] for m in per_step]
    lora = state.params
    b_norms = {t: float(ab["b"].float().norm()) for t, ab in lora["layers"].items()}
    saved, meta = load_checkpoint(out_dir, "last", target=lora)
    val = [m for m in logs if "val_loss" in m]
    expect = ({"flash_attention": 2 * layers, "flash_attention_dq": layers,
               "flash_attention_dkv": layers} if flash else dict.fromkeys(counted, 0))
    ok = (len(per_step) == TRAIN_STEPS and state.step == TRAIN_STEPS
          and all(x == x and abs(x) != float("inf") for x in losses)
          and losses[-1] < 2 * losses[0] and all(m["grad_norm"] > 0 for m in per_step)
          and all(v > 0 for v in b_norms.values()) and _checksum(torch, base) == before
          and all(x == expect[n] for n in counted for x in [per_step[0][n], *per[n]])
          # the run's total: the micro-steps and one validation batch (K3 only)
          and launches == {n: TRAIN_STEPS * expect[n] for n in counted}
          | {"flash_attention": TRAIN_STEPS * expect["flash_attention"] + (layers if flash else 0)}
          and len(val) == 1 and val[0]["val_loss"] == val[0]["val_loss"]
          and meta.get("step") == TRAIN_STEPS
          and all(torch.equal(a, b) for a, b in zip(tree_leaves(saved), tree_leaves(lora))))
    # end to end: the sequences' own tokens (padding is not counted) of the
    # steps after the warm-up over the whole span from the first stamp to the
    # last, so that a stalled step shows; the median is the step's own figure
    tokens = [m["tokens"] for m in per_step[1:]]
    span_s = stamps[-1] - stamps[0]
    return {"flash": flash, "micro_batch": MICRO, "cutoff": CUTOFF, "accum": ACCUM,
            "micro_steps": TRAIN_STEPS, "tokens_per_s": sum(tokens) / span_s,
            "tokens_per_step": tokens,
            "padded_positions_per_s": len(tokens) * MICRO * CUTOFF / span_s,
            "ms_per_step_mean": span_s * 1e3 / len(step_ms),
            "ms_per_step_median": statistics.median(step_ms), "ms_per_step_all": step_ms,
            "seconds_with_validation": seconds,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "losses": losses,
            "grad_norms": [m["grad_norm"] for m in per_step],
            "val_loss": val and val[0]["val_loss"],
            "lora_b_norms": b_norms, "launches": launches, "launches_per_micro_step": expect,
            "base_untouched": _checksum(torch, base) == before,
            "checkpoint_step": meta.get("step"), "ok": ok}, ok


# the train phase's optim part: apps/finetune_lora.py's make_adamw (clip 1.0,
# no decay, warm-up 100 at lr 3e-4, then cosine to lr / 10) and stage 1's
# (configs/stage1_pretrain.yaml: decay 0.05, no clip, warm-up 1,000 from 1e-6
# to 1e-4, cosine to 1e-5), each at accumulation 3; the clip's norm sums each
# leaf in another order on the card and on the CPU, so with the clip on the
# parameters are held within the CPU tests' bound against optax
# (tests/test_torch_optim.py CLIP_TOL), without it bit for bit
OPTIM_UPDATES, OPTIM_ACCUM = 10, 3
OPTIM_CONFIGS = {
    "finetune": {"schedule": (3e-4, 3e-5, 100, 1000), "weight_decay": 0.0, "grad_clip": 1.0},
    "stage1": {"schedule": (1e-4, 1e-5, 1000, 100000, 1e-6), "weight_decay": 0.05,
               "grad_clip": None}}
OPTIM_CLIP_TOL = 2.5e-7


def _f32_hex(x) -> str:
    import numpy as np
    return np.asarray(x, np.float32).reshape(()).view(np.uint32).item().to_bytes(4, "big").hex()


def _trees_apart(torch, card, cpu):
    """(entries apart, largest |difference|) of a tree on the card against
    the same tree on the CPU (f32 leaves a few ulps apart: their difference
    is exact in f32)."""
    from radialog_tpu_torch.train.optim import tree_leaves
    apart, diff = 0, 0.0
    for a, b in zip(tree_leaves(card), tree_leaves(cpu)):
        a = a.cpu()
        apart += int((a != b).sum())
        diff = max(diff, float((a - b).abs().max()))
    return apart, diff


@contextlib.contextmanager
def _pre_optax_arithmetic(torch, to):
    """The optimizer's arithmetic before it took optax's, for the record of
    what that changed on the card: Adam's divisors in Python double,
    divisions by Python scalars (the card multiplies by their reciprocal),
    PyTorch's own f32 sqrt."""
    saved = to._bias_correction, to.div_scalar, to._sqrt
    to._bias_correction = lambda b, count: 1 - b ** count
    to.div_scalar = lambda x, value: x / value
    to._sqrt = torch.sqrt
    try:
        yield
    finally:
        to._bias_correction, to.div_scalar, to._sqrt = saved


def _optim_run(torch, to, cfg, updates=OPTIM_UPDATES):
    """``updates`` updates of make_adamw at ``cfg`` of the LoRA tree at
    Vicuna-7B width (lora_init: r 8, wq and wv, 32 layers, img_proj_layer),
    on the card and on the CPU from the same seeded gradients (drawn on the
    card; the odd updates' large enough for a clip at 1.0 to bite, their
    mean's norm ~1.6, the even ones' ~0.16): per update the entries apart
    and the largest difference in mu, nu, the update and the parameters,
    and the bits of the divisors and the rate on both."""
    from radialog_tpu_torch.models.llama import VICUNA_7B, lora_init
    from radialog_tpu_torch.ops.layers import _scalar
    cpu = lora_init(torch.Generator().manual_seed(0), VICUNA_7B, "cpu")
    card = to.tree_map(lambda x: x.to("cuda"), cpu)
    sched = to.linear_warmup_cosine(*cfg["schedule"])
    tx = to.make_adamw(sched, weight_decay=cfg["weight_decay"], grad_clip=cfg["grad_clip"],
                       accum_steps=OPTIM_ACCUM)
    st_cpu, st_card = tx.init(cpu), tx.init(card)
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for micro in range(updates * OPTIM_ACCUM):
        scale = 1e-3 if (micro // OPTIM_ACCUM) % 2 == 0 else 1e-4
        grads = to.tree_map(lambda p: torch.randn(p.shape, generator=gen, device=dev) * scale,
                            card)
        up_card, st_card = tx.update(grads, st_card, card)
        up_cpu, st_cpu = tx.update(to.tree_map(lambda g: g.cpu(), grads), st_cpu, cpu)
        cpu, card = to.apply_updates(cpu, up_cpu), to.apply_updates(card, up_card)
        if up_cpu is None:
            continue
        count = st_cpu["inner"]["count"]
        divisors = [to._bias_correction(b, count) for b in (0.9, 0.999)]
        row = {"count": count, "grad_scale": scale}
        for what, a, b in (("mu", st_card["inner"]["mu"], st_cpu["inner"]["mu"]),
                           ("nu", st_card["inner"]["nu"], st_cpu["inner"]["nu"]),
                           ("update", up_card, up_cpu), ("params", card, cpu)):
            row[what + "_apart"], row[what + "_max_diff"] = _trees_apart(torch, a, b)
        row["divisors_cpu"] = [_f32_hex(c) for c in divisors]
        row["divisors_card"] = [_f32_hex(_scalar(c, dev, torch.float32).cpu()) for c in divisors]
        row["lr"] = _f32_hex(sched(count - 1))
        rows.append(row)
    return rows


def _optim_pack_q4c(torch):
    """pack_q4c on the card at tools/microbench_w4_torch.py's spot-check
    weight ((4096, 4096), std 0.02, drawn after its activations from its
    seed) against the tool's numpy packer (tools/microbench_w4.py pack_q4's
    codes and scales): entries apart now, and left apart by the division by
    the Python scalar 7.0 that it replaced."""
    import numpy as np
    from radialog_tpu_torch.ops.w4_colscale import pack_q4c, unpack_q4
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.randn((32, 4096), generator=gen, device="cuda")
    w = torch.randn((4096, 4096), generator=gen, device="cuda") * 0.02
    packed = pack_q4c(w)
    wn = w.cpu().numpy()
    scale = np.maximum(np.abs(wn).max(axis=0) / 7.0, 1e-8).astype(np.float32)
    codes = np.clip(np.round(wn / scale[None, :]), -7, 7).astype(np.int8).T
    old_scale = torch.clamp(w.abs().amax(dim=0) / 7.0, min=1e-8)
    old_codes = torch.clamp(torch.round(w / old_scale[None, :]), -7, 7).to(torch.int8).t()
    return {"shape": [4096, 4096],
            "scales_apart": int((packed.scale.cpu().numpy() != scale).sum()),
            "codes_apart": int((unpack_q4(packed.w).cpu().numpy() != codes).sum()),
            "scales_apart_python_scalar": int((old_scale.cpu().numpy() != scale).sum()),
            "codes_apart_python_scalar": int((old_codes.cpu().numpy() != codes).sum())}


def _phase_optim(torch):
    """The train phase's optim part (module docstring); raises if the card
    parts from the CPU beyond the CPU tests' bars."""
    from radialog_tpu_torch.train import optim as to
    t0 = time.time()
    out, ok = {}, True
    for name, cfg in OPTIM_CONFIGS.items():
        rows = _optim_run(torch, to, cfg)
        if cfg["grad_clip"] is None:
            held = all(r[k] == 0 for r in rows for k in r if k.endswith("_apart"))
        else:
            held = all(r["params_max_diff"] <= OPTIM_CLIP_TOL for r in rows)
        held = held and all(r["divisors_cpu"] == r["divisors_card"] for r in rows)
        emit("train", optim=name, **cfg, accum_steps=OPTIM_ACCUM, updates=rows, held=held)
        out[name], ok = held, ok and held
    with _pre_optax_arithmetic(torch, to):
        before = _optim_run(torch, to, OPTIM_CONFIGS["stage1"], updates=3)
    emit("train", optim="stage1 in the arithmetic before optax's (for the record)",
         updates=before)
    pack = _optim_pack_q4c(torch)
    pack_ok = pack["scales_apart"] == 0 and pack["codes_apart"] == 0
    emit("train", optim="pack_q4c", **pack, held=pack_ok, optim_s=time.time() - t0)
    if not (ok and pack_ok):
        raise AssertionError(f"the optim part: the card parts from the CPU ({out}, "
                             f"pack_q4c {pack})")


def phase_train(torch, tfa):
    """LoRA finetuning of Vicuna-7B over the int8 base, with flash attention
    and then without, on the same base and batches."""
    import tempfile
    from pathlib import Path
    from radialog_tpu_torch.apps import finetune_lora as ft
    from radialog_tpu_torch.models.llama import VICUNA_7B
    from radialog_tpu_torch.ops.quant import random_q8_train_base
    torch.cuda.synchronize()
    before_gb = torch.cuda.memory_allocated() / 1e9     # what earlier phases left behind
    t0 = time.time()
    base = random_q8_train_base(VICUNA_7B, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    build_s = time.time() - t0
    base_gb = torch.cuda.memory_allocated() / 1e9 - before_gb
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "instruct.json"
        # answers of 360-690 words after a ~60-token prompt: sequences of
        # ~420 tokens up to the cutoff, where the longer ones are truncated
        data.write_text(json.dumps(_train_records(14, lambda j: 360 + 30 * (j % 12))))
        for flash in (True, False):
            numbers, ok = _train_run(torch, tfa, ft, base, str(data),
                                     str(Path(tmp) / f"lora-{flash}"), flash)
            emit("train", base_build_s=build_s, base_gb=base_gb,
                 allocated_before_the_phase_gb=before_gb, **numbers)
            if not ok:
                raise AssertionError(f"the full-width train phase (flash={flash}) failed a check")
            out[flash] = numbers
    del base
    gc.collect()
    torch.cuda.empty_cache()
    _phase_optim(torch)
    return out[True]["launches"]


# the stage1 phase: full width (configs/stage1_pretrain.yaml: batch 32 at 448 px,
# captions padded to max_txt_len 256), the fixtures cycled to 64 paths, STAGE1_STEPS BF16 steps;
# the small part's batch, trunk size and caption length (pretrain.py run_mock_raw's)
STAGE1_BATCH, STAGE1_PATHS, STAGE1_STEPS, STAGE1_PROFILED = 32, 64, 4, 2   # steps cut from 8
STAGE1_SMALL_B, STAGE1_SMALL_RESIZE, STAGE1_SMALL_CROP, STAGE1_SMALL_TXT = 4, 72, 64, 16
# card against CPU (tiny model, FP32, TF32 off): sums in another order, ~1e-6 of
# a loss and of a gradient leaf's largest entry; FP32 against float64 at full width
# (losses relative, gradients over the leaf's largest entry): f32 rounding through
# BERT-base and ResNet-50 stays near 1e-5, where TF32's 10-bit mantissa or a lost
# upcast gives 1e-3 or more; itm_chunks 3 against 1 in BF16: the same math, GEMMs of
# other row counts may round apart in the ITM loss; ITC and LM do not see the
# chunks and must be bitwise equal
STAGE1_SMALL_TOL = {"loss": 1e-4, "grad": 1e-3}
STAGE1_F64_TOL = {"loss": 1e-4, "grad": 1e-3}
STAGE1_CHUNK_TOL = {"loss_itm": 2e-2}
CXR_DIR = os.path.join("tests", "fixtures", "cxr")


class _Negatives:
    """Stands in for models/blip2.py sample_negatives: the first call draws
    with the real one and keeps what it drew; every later call hands that
    back, so that each run trains on the same hard negatives."""

    def __init__(self, real):
        self.real, self.drawn = real, None

    def __call__(self, w_t2i, w_i2t, gen):
        if self.drawn is None:
            out = self.real(w_t2i, w_i2t, gen)
            self.drawn = tuple(x.cpu() for x in out)
            return out
        return tuple(x.to(w_t2i.device) for x in self.drawn)


def _grad_step(torch, steps, cfg, gen, params, visual, vstate, batch, policy, chunks):
    """One raw stage-1 step whose optimizer only keeps the gradients: (the
    four losses as floats, the gradient tree)."""
    from radialog_tpu_torch.train.optim import GradientTransformation, tree_map
    kept = []

    def update(grads, state, p):
        kept.append(grads)
        return tree_map(torch.zeros_like, grads), state
    tx = GradientTransformation(lambda p: {}, update)
    step = steps.make_stage1_raw_train_step(tx, cfg, policy=policy, itm_chunks=chunks)
    _, m = step(steps.TrainState.create(params, tx), visual, vstate, batch, gen)
    return {k: float(v) for k, v in m.items()}, kept[0]


def _leaf_err(torch, got, want, names=None):
    """{leaf: largest |got - want| over want's largest |entry|} of two trees,
    the scale floored at 1e-4 of the largest entry of the whole tree: the
    attention key biases' gradient is 0 in exact arithmetic (softmax ignores
    a shift of every score), so both sides hold rounding noise there."""
    from radialog_tpu_torch.train.optim import tree_leaves

    def paths(tree, prefix=""):
        if isinstance(tree, dict):
            return [x for k in tree for x in paths(tree[k], f"{prefix}/{k}")]
        if isinstance(tree, (list, tuple)):
            return [x for i, v in enumerate(tree) for x in paths(v, f"{prefix}/{i}")]
        return [prefix]
    floor = 1e-4 * max(float(b.abs().max()) for b in tree_leaves(want))
    out = {}
    for name, a, b in zip(paths(want), tree_leaves(got), tree_leaves(want)):
        if names is None or any(name.startswith(n) for n in names):
            a, b = a.double().cpu(), b.double().cpu()
            out[name] = float((a - b).abs().max()) / max(float(b.abs().max()), floor)
    return out


def _stage1_small(torch, tb, steps):
    """Card against CPU at the mock's size (TINY_QFORMER, BioViL-T at 64 px)
    from the same weights and negatives: the loader's uint8 batches through
    DevicePrefetcher, their f32 form, one raw train step (the four losses and
    every gradient leaf) and the greedy captions."""
    import glob
    from radialog_tpu_torch.apps.tokenization import WhitespaceTokenizer
    from radialog_tpu_torch.data.prefetch import DevicePrefetcher, pad_text_batch
    from radialog_tpu_torch.models.biovil_t import biovil_t_init
    from radialog_tpu_torch.models.qformer import TINY_QFORMER
    from radialog_tpu_torch.native import loader as nl
    from radialog_tpu_torch.ops.image import expand_cxr_u8
    from radialog_tpu_torch.ops.layers import FP32, layernorm
    from radialog_tpu_torch.train.optim import tree_map
    paths = sorted(glob.glob(os.path.join(CXR_DIR, "*.jpg")))
    with nl.CxrLoader(paths, batch=STAGE1_SMALL_B, resize=STAGE1_SMALL_RESIZE,
                      crop=STAGE1_SMALL_CROP, threads=1, emit_u8=True) as ld:
        host = list(ld.epoch(seed=0))
    route = ld.route
    src = [{"images": imgs, "idx": idx} for imgs, idx in host]
    with DevicePrefetcher(iter(src), depth=2, device="cuda") as pf:
        staged = [b for b in pf]
    staged_equal = all(torch.equal(b["images"].cpu(), torch.from_numpy(h["images"]))
                       and torch.equal(b["idx"].cpu(), torch.from_numpy(h["idx"]))
                       for b, h in zip(staged, src))
    on_card = all(b["images"].is_cuda and b["images"].dtype == torch.uint8 for b in staged)
    f32_equal = all(torch.equal(expand_cxr_u8(b["images"]).cpu(),
                                expand_cxr_u8(torch.from_numpy(h["images"])))
                    for b, h in zip(staged, src))

    bcfg = tb.Blip2Config(qformer=TINY_QFORMER, max_txt_len=STAGE1_SMALL_TXT)
    gen = torch.Generator().manual_seed(3)
    params, _ = tb.blip2_init(gen, bcfg, "cpu", with_vision=False)
    visual, vstate = biovil_t_init(gen, "cpu", joint_feature_size=TINY_QFORMER.encoder_width)
    tok = WhitespaceTokenizer(vocab_size=TINY_QFORMER.bert.vocab_size)
    words = ["lungs", "clear", "no", "effusion", "mild", "cardiomegaly", "right", "base"]
    caps = [" ".join(words[(i + j) % 8] for j in range(5 + 3 * i)) for i in range(STAGE1_SMALL_B)]
    ids, mask = pad_text_batch([tok(c, max_length=STAGE1_SMALL_TXT)["input_ids"] for c in caps],
                               STAGE1_SMALL_TXT)
    batch = {"images": src[0]["images"], "text_ids": ids, "text_mask": mask}
    real, tb.sample_negatives = tb.sample_negatives, _Negatives(tb.sample_negatives)
    try:
        out = {}
        for dev in ("cuda", "cpu"):               # the card draws, the CPU replays
            mv = lambda t: t.to(dev)  # noqa: E731
            out[dev] = _grad_step(torch, steps, bcfg, torch.Generator(device=dev).manual_seed(5),
                                  tree_map(mv, params), tree_map(mv, visual),
                                  tree_map(mv, vstate), batch, FP32, 1)
    finally:
        tb.sample_negatives = real
    loss_err = max(abs(out["cuda"][0][k] - out["cpu"][0][k]) for k in out["cpu"][0])
    grad_err = _leaf_err(torch, out["cuda"][1], out["cpu"][1])
    with torch.no_grad():
        tokens = tb.blip2_trunk_tokens(visual, vstate, expand_cxr_u8(torch.from_numpy(
            src[0]["images"])))
        embeds = layernorm(params["ln_vision"], tokens)
        cap_cpu = tb.blip2_generate_caption(params, bcfg, embeds, max_length=12, min_length=4)
        cap_card = tb.blip2_generate_caption(tree_map(lambda t: t.cuda(), params), bcfg,
                                             embeds.cuda(), max_length=12, min_length=4)
    captions_equal = torch.equal(cap_card.cpu(), cap_cpu)
    ok = (staged_equal and on_card and f32_equal and pf.all_pinned and pf.staged == len(src)
          and loss_err <= STAGE1_SMALL_TOL["loss"]
          and max(grad_err.values()) <= STAGE1_SMALL_TOL["grad"] and captions_equal)
    emit("stage1", part="small", ok=ok, route=route, batches=len(src),
         staged_bitwise=staged_equal, staged_on_card=on_card, staged_pinned=pf.all_pinned,
         f32_form_bitwise=f32_equal, losses_card=out["cuda"][0], losses_cpu=out["cpu"][0],
         loss_max_abs_err=loss_err, grad_max_rel_err=max(grad_err.values()),
         grad_worst_leaf=max(grad_err, key=grad_err.get),
         grad_leaves=len(grad_err), tol=STAGE1_SMALL_TOL, captions_equal=captions_equal,
         caption_tokens=cap_card[0].tolist())
    return ok, route


def _stage1_tree(root, n, seed):
    """A MIMIC-like tree under ``root``: n image paths cycling the fixture
    JPEGs (links), and split and sectioned CSVs whose findings are captions
    of 40-120 words. Returns MimicPaths."""
    import glob
    import numpy as np
    from radialog_tpu_torch.data.datasets import MimicPaths
    fixtures = sorted(os.path.abspath(p) for p in glob.glob(os.path.join(CXR_DIR, "*.jpg")))
    rng = np.random.default_rng(seed)
    split, sect = ["dicom_id,split"], ["findings,dicom_id,Img_Folder,Img_Filename,Note_file"]
    for i in range(n):
        folder = f"files/p10/p10{i:06d}/s5{i:07d}"
        os.makedirs(os.path.join(root, "images", folder))
        os.symlink(fixtures[i % len(fixtures)], os.path.join(root, "images", folder, f"d{i}.jpg"))
        words = " ".join(f"w{int(w)}" for w in rng.integers(0, 5000, int(rng.integers(40, 121))))
        split.append(f"d{i},train")
        sect.append(f"{words},d{i},{folder},d{i}.jpg,s5{i:07d}.txt")
    for name, rows in (("split.csv", split), ("sectioned.csv", sect)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(rows) + "\n")
    return MimicPaths(split_csv=os.path.join(root, "split.csv"),
                      sectioned_csv=os.path.join(root, "sectioned.csv"), chexpert_csv="",
                      image_root=os.path.join(root, "images"))


def _stage1_full(torch, tb, steps, root):
    """Stage 1 at full width: Blip2Config() (BERT-base Q-Former, 32 queries,
    encoder width 1408, max_txt_len 256) over BioViL-T at 448, random weights
    from a seeded generator on the card, batch 32 from the fixture JPEGs
    cycled to 64 paths through CxrLoader(threads=4, emit_u8=True) ->
    stage1_raw_batches -> DevicePrefetcher(depth=2) ->
    make_stage1_raw_train_step. Returns (numbers, ok, params, visual, vstate)."""
    import itertools
    from radialog_tpu_torch.apps.tokenization import WhitespaceTokenizer
    from radialog_tpu_torch.data.datasets import Stage1Data
    from radialog_tpu_torch.data.prefetch import DevicePrefetcher, stage1_raw_batches
    from radialog_tpu_torch.native.loader import native_available
    from radialog_tpu_torch.ops.layers import BF16, DTypePolicy, FP32
    from radialog_tpu_torch.train.optim import make_adamw, tree_map
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = tb.Blip2Config()
    data = Stage1Data(_stage1_tree(root, STAGE1_PATHS, seed=1), split="train",
                      custom_epochs_per_epoch=1)
    tok = WhitespaceTokenizer(vocab_size=cfg.qformer.bert.vocab_size)

    def batches(epochs, first=0):
        return itertools.chain.from_iterable(
            stage1_raw_batches(data, tok, cfg.max_txt_len, batch=STAGE1_BATCH, sub_epoch=0,
                               threads=4, seed=e) for e in range(first, first + epochs))

    route = "native" if native_available() else "pil"
    t0 = time.time()
    n = sum(1 for _ in batches(2, first=100))                   # the loader alone
    loader_bps = n / (time.time() - t0)
    first = next(iter(batches(1)))
    t0 = time.time()
    params, state = tb.blip2_init(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    visual, vstate = params.pop("visual"), state["visual"]
    torch.cuda.synchronize()
    init_s = time.time() - t0
    card = {k: torch.as_tensor(v, device="cuda") for k, v in first.items()}

    # checks from the initial weights on the first batch, all with the negatives
    # that the first run draws
    f64 = DTypePolicy(torch.float64, torch.float64, torch.float64)
    real, tb.sample_negatives = tb.sample_negatives, _Negatives(tb.sample_negatives)
    runs, mem = {}, {}
    try:
        for name, policy, chunks in (("bf16_chunks1", BF16, 1), ("bf16_chunks3", BF16, 3),
                                     ("fp32", FP32, 3), ("f64", f64, 3)):
            trees = (params, visual, vstate)
            if policy is f64:
                trees = tuple(tree_map(lambda t: t.double(), x) for x in trees)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            gen = torch.Generator(device="cuda").manual_seed(5)
            runs[name] = _grad_step(torch, steps, cfg, gen, *trees, card, policy, chunks)
            torch.cuda.synchronize()
            mem[name] = torch.cuda.max_memory_allocated() / 1e9
            del trees
    finally:
        tb.sample_negatives = real
    (l1, _), (l3, _) = runs["bf16_chunks1"], runs["bf16_chunks3"]
    chunk_err = {k: abs(l1[k] - l3[k]) for k in l1}
    (l32, g32), (l64, g64) = runs["fp32"], runs["f64"]
    f64_loss_err = {k: abs(l32[k] - l64[k]) / max(abs(l64[k]), 1e-30) for k in l64}
    f64_grad_err = _leaf_err(torch, g32, g64, ("/ln_vision", "/qformer/query_tokens", "/itm_head"))
    all_grad_err = max(_leaf_err(torch, g32, g64).values())
    del runs, g32, g64

    # the timed run: STAGE1_STEPS BF16 steps, then 2 under the profiler
    tx = make_adamw(1e-4, weight_decay=0.05)
    train_state = steps.TrainState.create(params, tx)
    step = steps.make_stage1_raw_train_step(tx, cfg, policy=BF16, itm_chunks=1)
    gen = torch.Generator(device="cuda").manual_seed(7)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stamps, losses, on_card = [], [], True
    torch.cuda.synchronize()
    stamps.append(time.time())
    with DevicePrefetcher(batches(STAGE1_STEPS // 2), depth=2, device="cuda") as pf:
        for batch in pf:
            on_card &= all(t.is_cuda for t in batch.values())
            train_state, m = step(train_state, visual, vstate, batch, gen)
            losses.append(m)
            torch.cuda.synchronize()
            stamps.append(time.time())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [{k: float(v) for k, v in m.items()} for m in losses]
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    timed = step_s[1:]                                  # the first step warms up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(STAGE1_PROFILED):
            train_state, _ = step(train_state, visual, vstate, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
    top = {n: ms / STAGE1_PROFILED for n, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}
    finite = all(v == v and abs(v) != float("inf") for m in losses for v in m.values())
    ok = (len(losses) == STAGE1_STEPS and finite and on_card and pf.all_pinned
          and train_state.step == STAGE1_STEPS + STAGE1_PROFILED and bool(kernels)
          and max(f64_loss_err.values()) <= STAGE1_F64_TOL["loss"]
          and max(f64_grad_err.values()) <= STAGE1_F64_TOL["grad"]
          and chunk_err["loss_itm"] <= STAGE1_CHUNK_TOL["loss_itm"]
          and chunk_err["loss_itc"] == chunk_err["loss_lm"] == 0.0)
    numbers = {"batch": STAGE1_BATCH, "image": 448, "max_txt_len": cfg.max_txt_len,
               "steps": STAGE1_STEPS, "policy": "bf16", "itm_chunks": 1, "route": route,
               "init_s": init_s, "s_per_step_mean": sum(timed) / len(timed),
               "s_per_step_median": statistics.median(timed), "s_per_step_all": step_s,
               "samples_per_s": STAGE1_BATCH * len(timed) / sum(timed),
               "device_busy_share": busy_ms / wall_ms,
               # the profiler slows the host: the busy time against the unprofiled step
               "device_busy_share_unprofiled": busy_ms / STAGE1_PROFILED / 1e3 / (
                   sum(timed) / len(timed)),
               "device_busy_ms_per_step":
               busy_ms / STAGE1_PROFILED, "profiled_wall_ms_per_step": wall_ms / STAGE1_PROFILED,
               "kernel_launches_per_step": len(kernels) / STAGE1_PROFILED,
               "top_kernels_ms_per_step": top,
               "loader_batches_per_s": loader_bps,
               "prefetch_wait_s_per_step": pf.waits_s, "peak_mem_gb": peak_gb,
               "peak_mem_gb_one_step": mem, "staged_pinned": pf.all_pinned,
               "staged_on_card": on_card, "losses": losses,
               "fp32_vs_f64_loss_rel_err": f64_loss_err,
               "fp32_vs_f64_grad_rel_err": f64_grad_err,
               "fp32_vs_f64_grad_rel_err_every_leaf": all_grad_err,
               "losses_fp32": l32, "losses_f64": l64, "f64_tol": STAGE1_F64_TOL,
               "chunks3_vs_chunks1_abs_err": chunk_err, "losses_chunks1": l1,
               "losses_chunks3": l3, "chunk_tol": STAGE1_CHUNK_TOL, "ok": ok}
    return numbers, ok, train_state.params, visual, vstate


def _stage1_embeddings(torch, tb, pipeline_mod, params, visual, vstate, root):
    """precompute_embeddings at full width over the fixture JPEGs into an
    npz; a pipeline built with emb_cache= that npz returns its rows, and
    those rows equal blip2_forward_image on the same images."""
    import glob
    import numpy as np
    from radialog_tpu_torch.models.qformer import QFormerConfig
    from radialog_tpu_torch.native.loader import CxrLoader
    from radialog_tpu_torch.ops.image import expand_cxr_u8
    from radialog_tpu_torch.train.runner import precompute_embeddings
    cfg = tb.Blip2Config()
    paths = sorted(glob.glob(os.path.join(CXR_DIR, "*.jpg")))
    dicoms = [os.path.basename(p)[:-4] for p in paths]
    with CxrLoader(paths, batch=4, shuffle=False, emit_u8=True) as ld:
        host = list(ld.epoch())
    order = np.argsort(np.concatenate([idx for _, idx in host]))   # workers finish in any order
    images = expand_cxr_u8(torch.from_numpy(np.concatenate([h for h, _ in host])[order]).cuda())
    full = dict(params, visual=visual)

    def forward(imgs):
        with torch.no_grad():
            return tb.blip2_forward_image(params, cfg,
                                          tb.blip2_encode_image(full, {"visual": vstate}, imgs))

    npz = os.path.join(root, "embs.npz")
    n = precompute_embeddings(forward, ((
        [dicoms[i] for i in idx], expand_cxr_u8(torch.from_numpy(h).cuda())) for h, idx in host),
        npz)
    pipe = pipeline_mod.RaDialogPipeline(pipeline_mod.PipelineConfig(mock=True, emb_cache=npz,
                                                                     device="cuda"))
    pipe.blip2 = {"qformer": params["qformer"], "ln_vision": params["ln_vision"]}
    pipe.visual, pipe.visual_state, pipe.qformer_cfg = visual, vstate, QFormerConfig()
    stored = np.load(npz)
    rows = np.stack([stored[d] for d in dicoms])
    cached = pipe.embed_images(images, dicoms).cpu().numpy()
    direct = forward(images).cpu().numpy()
    computed = pipe.embed_images(images).cpu().numpy()
    err = float(np.abs(rows - direct).max())
    ok = (n == len(paths) and rows.shape == (len(paths), 32, 768) and np.array_equal(cached, rows)
          and err <= 2e-4 and float(np.abs(computed - direct).max()) <= 2e-4)
    emit("stage1", part="embeddings", ok=ok, written=n, shape=list(rows.shape),
         pipeline_rows_bitwise=bool(np.array_equal(cached, rows)),
         npz_vs_forward_max_abs_err=err,
         pipeline_computed_vs_forward_max_abs_err=float(np.abs(computed - direct).max()),
         tol=2e-4)
    return ok


def phase_stage1(torch, pipeline_mod, counted):
    """Q-Former stage-1 training from raw JPEGs: card against CPU at the
    mock's size, the full-width BF16 run with its checks and numbers, the
    embeddings' npz read back through the pipeline, and the pretrain command
    line on the card. K1-K5 and T1-T3 launch no time in the phase."""
    import shutil
    import tempfile
    from radialog_tpu_torch.models import blip2 as tb
    from radialog_tpu_torch.train import steps
    _zero(counted)
    has_gxx = shutil.which("g++") is not None
    has_jpeglib = os.path.exists("/usr/include/jpeglib.h")
    ok_small, route = _stage1_small(torch, tb, steps)
    if not ok_small:
        raise AssertionError("the stage1 phase's small card-vs-CPU part failed a check")
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="stage1-", dir="build")
    try:
        numbers, ok_full, params, visual, vstate = _stage1_full(torch, tb, steps, root)
        emit("stage1", part="full", card=smi(), gxx=has_gxx, jpeglib_h=has_jpeglib, **numbers)
        ok_emb = _stage1_embeddings(torch, tb, pipeline_mod, params, visual, vstate, root)
        del params, visual, vstate
        gc.collect()
        torch.cuda.empty_cache()
        proc = subprocess.run([sys.executable, "-m", "radialog_tpu_torch.apps.pretrain",
                               "--mock", "--raw", "--max-epoch", "1", "--steps-per-epoch", "2"],
                              capture_output=True, text=True, timeout=300)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    lines = proc.stdout.strip().splitlines()
    ok_cli = (proc.returncode == 0 and len(lines) == 5 and lines[0].startswith("epoch 0.0 it 0:")
              and lines[-1].startswith("raw-image stage-1 mock done"))
    emit("stage1", part="cli", ok=ok_cli, rc=proc.returncode, lines=lines,
         stderr_tail=proc.stderr[-1500:] if proc.returncode else "")
    launches = _read(counted)
    # the loader never falls back to PIL where it could have built
    route_ok = route == "native" or not (has_gxx and has_jpeglib)
    emit("stage1", part="kernels", ok=not any(launches.values()) and route_ok,
         launches=launches, route=route, gxx=has_gxx, jpeglib_h=has_jpeglib)
    if not (ok_full and ok_emb and ok_cli and route_ok) or any(launches.values()):
        raise AssertionError("the stage1 phase failed a check")
    return launches


# the trainers phase: the classifier's full-width batch and crop (the CLI's
# FP32 policy), the labeler's batch of 16 reports cut at 512 tokens, warm and
# timed steps; the card-against-CPU part at the CPU tests' sizes (3 steps,
# batch 2 at 488 px, a (1,1,1,1) basic trunk; the CLI mock's tiny BERT at
# batch 4 x 12 tokens) and its bars: 4x the largest card-against-CPU reading
# of four runs of these functions on an H100 80GB HBM3 at 700 W (PERF.md
# section 4), to two figures. The card's cuDNN convolutions sum in another
# order than the CPU's, and a ReLU on a rounding edge spreads through the
# BatchNorms (tests/test_torch_classifier_train.py); the largest entry's
# bar stays below lr (1e-4) augmented and near it plain, where one AdamW
# step moves an entry by about lr.
CLS_BATCH, CLS_CROP, BERT_BATCH, BERT_T, TRAINER_WARM, TRAINER_TIMED = 32, 488, 16, 512, 2, 5
TRAINER_LR, TRAINER_EPS, SMALL_STEPS = 1e-4, 1e-3, 3
CLS_SMALL_TOL = {False: {"loss": 8.4e-6, "q99": 6.3e-6, "max": 1.3e-4,
                         "mean": 2.0e-4, "var": 2.0e-5},
                 True: {"loss": 1.1e-6, "q99": 7.8e-7, "max": 2.7e-5,
                        "mean": 3.0e-5, "var": 5.8e-6}}
BERT_SMALL_TOL = {"loss": 3.6e-7, "param": 7.6e-7}
# the norms audit's inputs: BatchNorm at ResNet-50 widths of the classifier's
# batch (the stem, a layer1 output, layer4), LayerNorm at BERT-base's 768
# (the labeler's batch), RMSNorm at Vicuna-7B's 4096 (the report prefill)
NORM_BN_SHAPES = ((CLS_BATCH, 244, 244, 64), (CLS_BATCH, 122, 122, 256), (CLS_BATCH, 16, 16, 2048))
NORM_LN_SHAPE, NORM_RMS_SHAPE = (BERT_BATCH, BERT_T, 768), (56, 128, 4096)
# the norms' outputs card against CPU: 5x the largest of PR 16's readings,
# 1.9e-6 (LayerNorm) and 1.4e-6 (BatchNorm), as the card-only tests hold them
NORM_Y_TOL = 1e-5
# the softmax audit's bars, card against CPU, each site's function output
# (the losses relative to their value): 4x the first reading on an H100
# 80GB HBM3 at 700 W, where it was not 0: mha at the float decode 9.8e-4 and
# at the report prefill 3.9e-3 (one bf16 step of an output: the sums of
# exp and of p . v round per device), beam's log-probabilities 2.9e-6, the
# LoRA loss 1.3e-7, ITM's weights 6.0e-8. Where the reading was 0 the bar
# is that of the same kind of site: the int8 verify's bf16 output mha's at
# the decode, the Q-Former, ITC and CheXbert losses the LoRA loss's. The
# nucleus' kept logits are the tempered logits themselves: bitwise
SOFTMAX_TOL = {"mha_float_decode": 3.9e-3, "mha_shared_prefix_report": 1.6e-2,
               "int8_verify": 3.9e-3, "top_p": 0.0, "beam": 1.2e-5, "lora_ce": 5.1e-7,
               "qformer_lm": 5.1e-7, "itc": 5.1e-7, "itm_weights": 2.4e-7, "chexbert": 5.1e-7}
REPORTS_LABELED = 16


def _flat_np(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _flat_np(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree) for p, v in _flat_np(x, f"{prefix}/{i}").items()}
    return {prefix: tree.detach().double().cpu().numpy()}


def _tree_gap(a, b):
    """(99th percentile, largest) |a - b| over every entry of two trees."""
    import numpy as np
    fa, fb = _flat_np(a), _flat_np(b)
    d = np.concatenate([np.abs(fa[k] - fb[k]).ravel() for k in fa])
    return float(np.quantile(d, 0.99)), float(d.max())


def _state_gap(a, b):
    """Largest |a - b| of the BatchNorm running means, variances, counts."""
    fa, fb = _flat_np(a), _flat_np(b)
    out = {}
    for k in fa:
        kind = k.rsplit("/", 1)[1]
        out[kind] = max(out.get(kind, 0.0), float(abs(fa[k] - fb[k]).max()))
    return out


def _classifier_small(torch, dev="cuda"):
    """Three FP32 steps of make_classifier_train_step on the card and on the
    CPU from the same host-drawn weights and batches, without and with the
    augmentation (the card's draws handed to the CPU run)."""
    import numpy as np
    from radialog_tpu_torch.models.biovil_t import biovil_t_init
    from radialog_tpu_torch.ops import augment as ta
    from radialog_tpu_torch.ops.layers import linear_init
    from radialog_tpu_torch.train import classifier as tcl
    from radialog_tpu_torch.train import steps
    from radialog_tpu_torch.train.optim import make_adamw, tree_map
    host = torch.Generator().manual_seed(3)
    params = {}
    params["biovil"], vstate = biovil_t_init(host, "cpu", 128, (1, 1, 1, 1), False)
    params["fc1"] = linear_init(host, 128 * 4 * 4, 512, "cpu")
    params["fc2"] = linear_init(host, 512, 14, "cpu")
    rng = np.random.default_rng(7)
    images = rng.random((SMALL_STEPS, 2, CLS_CROP, CLS_CROP, 3)).astype(np.float32)
    labels = rng.integers(0, 2, (SMALL_STEPS, 2, 14)).astype(np.float32)
    pw = tcl.class_weights(rng.integers(0, 2, (16, 14)), "log")
    real = ta.augment_draws
    out = {}
    for augment in (False, True):
        drawn = []

        def record(n, gen, *a, **kw):
            d = real(n, gen, *a, **kw)
            drawn.append({k: v.cpu() for k, v in d.items()})
            return d

        runs = {}
        for on, draws in ((dev, record), ("cpu", lambda n, gen, *a, **kw: drawn.pop(0))):
            ta.augment_draws = draws
            try:
                tx = make_adamw(TRAINER_LR, weight_decay=0.0, eps=TRAINER_EPS)
                state = steps.TrainState.create(tree_map(lambda t: t.to(on), params), tx)
                ms = {"biovil": tree_map(lambda t: t.to(on), vstate)}
                step = tcl.make_classifier_train_step(tx, pw, augment=augment)
                gen = torch.Generator(device=on).manual_seed(9)
                losses = []
                for i in range(SMALL_STEPS):
                    state, ms, m = step(state, ms, {"images": images[i], "labels": labels[i]},
                                        gen)
                    losses.append(float(m["loss"]))
                runs[draws is record] = (losses, state.params, ms)
            finally:
                ta.augment_draws = real
        (lc, pc, sc), (lh, ph, sh) = runs[True], runs[False]
        q99, mx = _tree_gap(pc, ph)
        sg = _state_gap(sc, sh)
        bar = CLS_SMALL_TOL[augment]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
        ok = (loss_err <= bar["loss"] and q99 <= bar["q99"] and mx <= bar["max"]
              and sg["mean"] <= bar["mean"] and sg["var"] <= bar["var"] and sg["count"] == 0
              and not drawn)
        out["augment" if augment else "plain"] = {
            "losses_card": lc, "losses_cpu": lh, "loss_rel_err": loss_err, "param_q99": q99,
            "param_max": mx, "state_gap": sg, "tol": bar, "ok": ok}
    return out


def _chexbert_small(torch, dev="cuda"):
    """Three FP32 CheXbert steps (the run_chexbert mock's tiny BERT) on the
    card and on the CPU with the same dropout masks: the card's, drawn as
    ops/layers.py dropout draws them, recorded and applied again on the CPU
    through ``apply_dropout_mask``."""
    import numpy as np
    from radialog_tpu_torch.models import bert as tbert
    from radialog_tpu_torch.models import chexbert as tcb
    from radialog_tpu_torch.ops.layers import apply_dropout_mask
    from radialog_tpu_torch.train import chexbert_train as tct
    from radialog_tpu_torch.train import steps
    from radialog_tpu_torch.train.optim import make_adamw, tree_map
    cfg = tbert.BertConfig(vocab_size=256, hidden_size=32, num_layers=2, num_heads=4,
                           intermediate_size=64, max_position=64)
    params = tcb.chexbert_init(torch.Generator().manual_seed(11), cfg, "cpu")
    rng = np.random.default_rng(12)
    ids = rng.integers(4, 250, (SMALL_STEPS, 4, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[:, 1, 9:] = 0
    labels = np.concatenate([rng.integers(0, 4, (SMALL_STEPS, 4, 13)),
                             rng.integers(0, 2, (SMALL_STEPS, 4, 1))], axis=2)
    masks = []

    def record(x, rate, train, gen):
        if not train or rate <= 0.0 or gen is None:
            return x
        keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
        masks.append(keep.cpu())
        return apply_dropout_mask(x, keep, rate)

    def replay(x, rate, train, gen):
        if not train or rate <= 0.0 or gen is None:
            return x
        return apply_dropout_mask(x, masks.pop(0), rate)

    real = tbert.dropout, tcb.dropout
    runs = {}
    for on, fn in ((dev, record), ("cpu", replay)):
        tbert.dropout = tcb.dropout = fn
        try:
            tx = make_adamw(1e-3, weight_decay=0.0, eps=TRAINER_EPS)
            state = steps.TrainState.create(tree_map(lambda t: t.to(on), params), tx)
            step = tct.make_chexbert_train_step(tx, cfg)
            gen = torch.Generator(device=on).manual_seed(1)
            losses = []
            for i in range(SMALL_STEPS):
                state, m = step(state, {"input_ids": ids[i], "attention_mask": mask[i],
                                        "labels": labels[i]}, gen)
                losses.append(float(m["loss"]))
            runs[fn is record] = (losses, state.params)
        finally:
            tbert.dropout, tcb.dropout = real
    (lc, pc), (lh, ph) = runs[True], runs[False]
    _, mx = _tree_gap(pc, ph)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    ok = loss_err <= BERT_SMALL_TOL["loss"] and mx <= BERT_SMALL_TOL["param"] and not masks
    return {"losses_card": lc, "losses_cpu": lh, "loss_rel_err": loss_err, "param_max": mx,
            "masks": SMALL_STEPS * (2 * cfg.num_layers + 2), "tol": BERT_SMALL_TOL, "ok": ok}


def _ulps(torch, a, b) -> int:
    """Largest distance in f32 ulps between two f32 tensors on the CPU."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def _norms_audit(torch, dev="cuda"):
    """The norms' reductions on the card against the CPU (ROADMAP queue 3):
    train-mode BatchNorm's batch mean and variance at ResNet-50 widths,
    LayerNorm's mean at 768, RMSNorm's mean square at 4096, in f32 ulps
    (the outputs, many near 0, by their largest absolute error), and how
    many of the card's means differ from its own sums divided by n (CUDA's
    mean multiplies by 1/n; the CPU's divides): recorded, not held, since
    a reduction's mean cannot be bitwise across devices. Held: the outputs
    within NORM_Y_TOL, and the one elementwise division by a Python scalar
    on the training path, dropout's ``x / (1 - rate)`` (``apply_dropout_mask``
    through ``div_scalar``), bitwise the CPU's."""
    from radialog_tpu_torch.ops import layers as tl
    g = torch.Generator().manual_seed(21)
    out, held = {}, True

    def division(xc, dims):
        n = 1
        for d in dims:
            n *= xc.shape[d]
        return {"n": n, "native_mean_entries_apart": int(
            (xc.mean(dims) != tl.div_scalar(xc.sum(dims), n)).sum())}

    for shape in NORM_BN_SHAPES:
        x = torch.randn(shape, generator=g) * 2 + 0.5
        c = shape[-1]
        p = {"scale": torch.ones(c), "bias": torch.zeros(c)}
        s = {"mean": torch.zeros(c), "var": torch.zeros(c), "count": torch.zeros(())}
        y, st = tl.batchnorm(p, s, x, train=True, momentum=1.0)
        xc = x.to(dev)
        yc, stc = tl.batchnorm({k: v.to(dev) for k, v in p.items()},
                               {k: v.to(dev) for k, v in s.items()}, xc, train=True, momentum=1.0)
        err = float((yc.cpu() - y).abs().max())
        held &= err <= NORM_Y_TOL
        out[f"batchnorm_{'x'.join(map(str, shape))}"] = {
            "mean_ulps": _ulps(torch, stc["mean"].cpu(), st["mean"]),
            "var_ulps": _ulps(torch, stc["var"].cpu(), st["var"]),
            "y_max_abs_err": err, **division(xc, tuple(range(len(shape) - 1)))}
        del x, xc, y, yc
    x = torch.randn(NORM_LN_SHAPE, generator=g) * 3 + 1
    p = {"scale": torch.randn(768, generator=g), "bias": torch.randn(768, generator=g)}
    y = tl.layernorm(p, x)
    yc = tl.layernorm({k: v.to(dev) for k, v in p.items()}, x.to(dev))
    err = float((yc.cpu() - y).abs().max())
    held &= err <= NORM_Y_TOL
    out["layernorm_768"] = {"y_max_abs_err": err, "mean_ulps": _ulps(
        torch, x.to(dev).mean(-1).cpu(), x.mean(-1)), **division(x.to(dev), (2,))}
    x = torch.randn(NORM_RMS_SHAPE, generator=g).bfloat16()
    scale = (torch.randn(4096, generator=g) * 0.1 + 1).bfloat16()
    y = tl.rmsnorm(scale, x)
    yc = tl.rmsnorm(scale.to(dev), x.to(dev))
    sq = x.float() * x.float()
    # 4096 is a power of two: 1/n is exact, so the card's product is its division
    out["rmsnorm_4096"] = {"y_bf16_entries_apart": int((yc.cpu() != y).sum()),
                           "mean_square_ulps": _ulps(torch, sq.to(dev).mean(-1).cpu(),
                                                     sq.mean(-1)),
                           **division(sq.to(dev), (2,))}
    x = torch.randn(NORM_LN_SHAPE, generator=g) * 3 + 1
    keep = torch.rand(NORM_LN_SHAPE, generator=g) < 0.9
    drop = torch.equal(tl.apply_dropout_mask(x.to(dev), keep.to(dev), 0.1).cpu(),
                       tl.apply_dropout_mask(x, keep, 0.1))
    # the card's own division by the Python scalar, for the record
    native = int((torch.where(keep.to(dev), x.to(dev) / 0.9, 0.0).cpu()
                  != tl.apply_dropout_mask(x, keep, 0.1)).sum())
    held &= drop
    out["dropout_division"] = {"bitwise": drop, "native_division_entries_apart": native}
    return out, held


def _ulp_stats(torch, a, b, dev="cuda"):
    """Distances in f32 ulps between two f32 tensors of one shape (on the
    card): the largest, its 99th percentile and the entries that differ."""
    def ordered(x):
        i = x.detach().float().contiguous().to(dev).view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    d = (ordered(a) - ordered(b)).abs().flatten()
    counts = torch.bincount(d.clamp(max=1 << 20))
    q99 = int(torch.searchsorted(counts.cumsum(0), math.ceil(0.99 * d.numel())))
    return {"max_ulps": int(d.max()), "q99_ulps": q99, "entries_apart": int((d != 0).sum()),
            "entries": d.numel()}


def _softmax_audit(torch, dev="cuda"):
    """Softmax and log-softmax on the card against the CPU (ROADMAP queue
    3), at the shapes of the paths that reach each site, from seeded
    inputs on the host: each site's softmax alone on the same f32 scores
    (ulps: the largest, the 99th percentile, the entries apart), and the
    site's function on the same inputs (its largest absolute error, relative
    for a loss, held within SOFTMAX_TOL); for sampling also the rows whose
    kept nucleus differs, for beams the rows whose top-k order differs.
    Held as well: the sampling temperature's division (``sampling_logits``
    through ``div_scalar``) bitwise the CPU's, beside the count of entries
    the card's own division by the Python scalar leaves apart. The losses'
    divisions of a sum by a count are means, which cannot be bitwise
    across devices (the norms audit): they stay."""
    import torch.nn.functional as F
    from radialog_tpu_torch.decode import engine as te
    from radialog_tpu_torch.models import blip2 as tb
    from radialog_tpu_torch.models import llama as tl
    from radialog_tpu_torch.models.qformer import lm_loss
    from radialog_tpu_torch.ops import attention as ta
    from radialog_tpu_torch.train.chexbert_train import chexbert_loss
    from radialog_tpu_torch.train.steps import IGNORE_INDEX, masked_ce
    g = torch.Generator().manual_seed(31)
    out, held = {}, True

    def on(x):
        if torch.is_tensor(x):
            return x.to(dev)
        return type(x)(on(t) for t in x) if isinstance(x, (list, tuple)) else x

    def site(name, op_in, op, fn_args, fn, rel=False):
        """Record the softmax alone on ``op_in``, hold ``fn`` on ``fn_args``
        (where both outputs are finite: the nucleus' filtered entries are
        NEG_INF)."""
        nonlocal held
        y = fn(*fn_args)
        yc = fn(*(on(a) for a in fn_args)).cpu()
        both = (y > ta.NEG_INF) & (yc > ta.NEG_INF)
        e = float((yc.double() - y.double()).abs()[both].max())
        if rel:
            e /= float(y.double().abs().max())
        ok = e <= SOFTMAX_TOL[name]
        held &= ok
        out[name] = {**_ulp_stats(torch, op(op_in.to(dev)), op(op_in), dev),
                     "rel_err" if rel else "max_abs_err": e, "tol": SOFTMAX_TOL[name],
                     "held": ok}
        return y, yc

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g) * std

    soft = lambda x: torch.softmax(x, dim=-1)           # noqa: E731
    logsoft = lambda x: torch.log_softmax(x, dim=-1)    # noqa: E731
    h, d = 32, 128
    # ops/attention.py mha: the float report pass's decode step, 56 lanes
    # over 448 slots of the bf16 cache, 160-448 live
    lens = torch.randint(160, 449, (56,), generator=g)
    bias = torch.where(torch.arange(448)[None] < lens[:, None], 0.0, ta.NEG_INF)[:, None, None]
    q, k, v = (randn(*sh).bfloat16() for sh in ((56, 1, h, d), (56, 448, h, d),
                                                (56, 448, h, d)))
    site("mha_float_decode", randn(56, h, 1, 448) + bias, soft, (q, k, v, bias), ta.mha)
    # mha_shared_prefix: the report prefill, 56 lanes of 80 tokens after
    # the 48 shared ones, causal within the lanes' own rows
    q, k1, v1 = (randn(56, 80, h, d).bfloat16() for _ in range(3))
    k0, v0 = (randn(48, h, d).bfloat16() for _ in range(2))
    causal = ta.causal_mask_bias(80, 80)
    site("mha_shared_prefix_report", randn(56, h, 80, 128), soft,
         (q, k0, v0, k1, v1, causal), ta.mha_shared_prefix)
    # models/llama.py _attention_int8_verify: a batch-1 verify block of
    # k + 1 = 5 rows over 1,280 slots of the int8 cache
    s = VERIFY_S
    cache = (torch.randint(-127, 128, (1, 1, s, h * d), generator=g, dtype=torch.int8),
             torch.randint(-127, 128, (1, 1, s, h * d), generator=g, dtype=torch.int8),
             (torch.rand(1, 1, s, h, generator=g) * 0.02 + 0.005).bfloat16(),
             (torch.rand(1, 1, s, h, generator=g) * 0.02 + 0.005).bfloat16())
    vbias = ta.causal_mask_bias(5, s, offset=s - 5)
    site("int8_verify", randn(1, h, 5, s, std=3.0), soft,
         (randn(1, 5, h, d).bfloat16(), cache, vbias),
         lambda q_, c_, b_: tl._attention_int8_verify(q_, tl.KVCache(*c_), 0, b_, d))
    # decode/engine.py sampling: the nucleus over the report batch's logits
    # (56 x 32,001) at temperature 0.7, top_p 0.9
    logits = randn(56, 32001, std=3.0)
    dp = te.DecodeParams(do_sample=True, temperature=0.7, top_p=0.9)
    sorted_logits = torch.sort(logits / 0.7, dim=-1, descending=True).values
    y, yc = site("top_p", sorted_logits, soft, (logits, dp), te.sampling_logits)
    out["top_p"]["rows_kept_set_apart"] = int(
        ((yc > ta.NEG_INF) != (y > ta.NEG_INF)).any(-1).sum())
    # the temperature's division: IEEE on both (div_scalar), and the card's
    # own product with the reciprocal for the record
    native = int(((logits.to(dev) / 0.7).cpu() != logits / 0.7).sum())
    bitwise = torch.equal(te.sampling_logits(logits.to(dev), te.DecodeParams(
        do_sample=True, temperature=0.7)).cpu(), te.sampling_logits(
        logits, te.DecodeParams(do_sample=True, temperature=0.7)))
    held &= bitwise
    out["temperature_division"] = {"bitwise": bitwise, "native_division_entries_apart": native}
    # decode/beam.py: log-softmax over the vocabulary, 2 prompts x 4 beams
    beam_logits = randn(8, 32001, std=3.0)
    y, yc = site("beam", beam_logits, logsoft, (beam_logits,), logsoft)
    out["beam"]["rows_topk_order_apart"] = int(
        (torch.topk(yc, 4, dim=-1).indices != torch.topk(y, 4, dim=-1).indices)
        .any(-1).sum())
    # train/steps.py masked_ce (F.cross_entropy): the LoRA micro-batch, 2 x
    # 600 tokens, the first 100 of each prompt masked
    lora_logits = randn(2, 600, 32001, std=3.0)
    labels = torch.randint(0, 32001, (2, 600), generator=g)
    labels[:, :100] = IGNORE_INDEX
    site("lora_ce", lora_logits[:, :-1].reshape(-1, 32001), logsoft, (lora_logits, labels),
         masked_ce, rel=True)
    # models/qformer.py lm_loss: stage 1's captions, 32 x 128 text tokens
    # over BERT's 30,522 words
    qf_logits = randn(32, 128, 30522, std=3.0)
    qf_labels = torch.randint(0, 30522, (32, 128), generator=g)
    qf_labels[:, 100:] = -100
    site("qformer_lm", qf_logits, logsoft, (qf_logits, qf_labels), lm_loss, rel=True)
    del lora_logits, qf_logits
    # models/blip2.py: ITC's smoothed cross entropy over the (32, 32)
    # similarities, and the softmax weights of the hard negatives
    sim = randn(32, 32, std=10.0)
    targets = torch.arange(32)
    site("itc", sim, logsoft, (sim, targets, 0.1), tb._smoothed_ce, rel=True)
    site("itm_weights", sim, soft, (sim,), soft)
    # train/chexbert_train.py: 13 four-way heads and one two-way head, 16 reports
    heads = [randn(16, 4, std=2.0) for _ in range(13)] + [randn(16, 2, std=2.0)]
    cb_labels = torch.cat([torch.randint(0, 4, (16, 13), generator=g),
                           torch.randint(0, 2, (16, 1), generator=g)], dim=1)
    site("chexbert", torch.cat(heads[:13]), logsoft, (heads, cb_labels), chexbert_loss,
         rel=True)
    return out, held


def _timed_steps(torch, run_step, n_warm, n_timed):
    """n_warm + n_timed steps of ``run_step() -> loss`` (synchronized), then
    one under torch.profiler: (losses, seconds of each timed step, device
    busy ms, kernel launches and wall ms of the profiled step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    losses, secs = [], []
    for i in range(n_warm + n_timed):
        torch.cuda.synchronize()
        t0 = time.time()
        losses.append(float(run_step()))
        if i >= n_warm:
            secs.append(time.time() - t0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        losses.append(float(run_step()))
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return losses, secs, busy_ms, len(kernels), wall_ms


def _trainer_numbers(batch, losses, secs, busy_ms, launches, wall_ms, peak_gb, unit):
    mean_s = sum(secs) / len(secs)
    finite = all(v == v and abs(v) != float("inf") for v in losses)
    return {"batch": batch, "s_per_step_mean": mean_s, "s_per_step_median":
            statistics.median(secs), "s_per_step_all": secs, f"{unit}_per_s": batch / mean_s,
            "device_busy_ms_per_step": busy_ms, "profiled_wall_ms_per_step": wall_ms,
            "device_busy_share": busy_ms / wall_ms,
            "device_busy_share_unprofiled": busy_ms / 1e3 / mean_s,
            "kernel_launches_per_step": launches, "peak_mem_gb": peak_gb, "losses": losses,
            "ok": finite and losses[-1] < losses[0]}


def _classifier_full(torch, dev="cuda"):
    """The CheXpert classifier at full width: BioViL-T's ResNet-50 trunk at
    488 px, batch 32, FP32, AdamW, every BatchNorm on batch statistics; one
    batch of random images and labels, so the loss must fall."""
    from radialog_tpu_torch.models.chexpert import chexpert_classifier_init
    from radialog_tpu_torch.train import classifier as tcl
    from radialog_tpu_torch.train import steps
    from radialog_tpu_torch.train.optim import make_adamw
    gen = torch.Generator(device=dev).manual_seed(0)
    params, ms = chexpert_classifier_init(gen, dev)
    images = torch.rand((CLS_BATCH, CLS_CROP, CLS_CROP, 3), generator=gen, device=dev)
    labels = (torch.rand((CLS_BATCH, 14), generator=gen, device=dev) < 0.3).float()
    tx = make_adamw(TRAINER_LR, weight_decay=0.0)
    step = tcl.make_classifier_train_step(tx, tcl.class_weights(labels.cpu().numpy(), "log"))
    box = {"state": steps.TrainState.create(params, tx), "ms": ms}
    del params, ms

    def run_step():
        box["state"], box["ms"], m = step(box["state"], box["ms"],
                                          {"images": images, "labels": labels})
        return m["loss"]

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    got = _timed_steps(torch, run_step, TRAINER_WARM, TRAINER_TIMED)
    peak = torch.cuda.max_memory_allocated() / 1e9
    counts = [float(v) for k, v in _flat_np(box["ms"]).items() if k.endswith("/count")]
    numbers = _trainer_numbers(CLS_BATCH, *got, peak, "images")
    numbers.update(crop=CLS_CROP, policy="fp32", trunk="resnet50",
                   bn_counts_equal_steps=set(counts) == {float(len(got[0]))})
    numbers["ok"] &= numbers["bn_counts_equal_steps"]
    return numbers


def _chexbert_full(torch, dev="cuda", cfg=None):
    """CheXbert at full width: BERT-base, 16 reports cut at 512 tokens (rows
    of 320-512 real tokens), FP32, dropout on, AdamW; one batch, so the
    loss must fall."""
    from radialog_tpu_torch.models.bert import BertConfig
    from radialog_tpu_torch.models.chexbert import chexbert_init
    from radialog_tpu_torch.train import chexbert_train as tct
    from radialog_tpu_torch.train import steps
    from radialog_tpu_torch.train.optim import make_adamw
    cfg = cfg or BertConfig()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = chexbert_init(gen, cfg, dev)
    ids = torch.randint(1000, cfg.vocab_size, (BERT_BATCH, BERT_T), generator=gen, device=dev)
    lengths = torch.randint(BERT_T * 5 // 8, BERT_T + 1, (BERT_BATCH,), generator=gen, device=dev)
    mask = (torch.arange(BERT_T, device=dev)[None] < lengths[:, None]).int()
    labels = torch.cat([torch.randint(0, 4, (BERT_BATCH, 13), generator=gen, device=dev),
                        torch.randint(0, 2, (BERT_BATCH, 1), generator=gen, device=dev)], 1)
    tx = make_adamw(TRAINER_LR, weight_decay=0.0)
    step = tct.make_chexbert_train_step(tx, cfg)
    box = {"state": steps.TrainState.create(params, tx)}
    del params

    def run_step():
        box["state"], m = step(box["state"], {"input_ids": ids, "attention_mask": mask,
                                              "labels": labels}, gen)
        return m["loss"]

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    got = _timed_steps(torch, run_step, TRAINER_WARM, TRAINER_TIMED)
    numbers = _trainer_numbers(BERT_BATCH, *got, torch.cuda.max_memory_allocated() / 1e9,
                               "reports")
    numbers.update(tokens=BERT_T, policy="fp32", model="bert-base",
                   real_tokens=int(lengths.sum()))
    return numbers


def _trainer_clis(torch, out_dir, dev="cuda"):
    """The three command lines on the card, started together as processes:
    chexpert_train (ResNet-50, the JPEG mock), run_chexbert train and
    run_chexbert label over a CSV of 16 reports."""
    import csv
    os.makedirs(out_dir, exist_ok=True)
    reports = [f"the lungs are clear , study {i} . {'mild edema .' if i % 3 else 'no effusion .'}"
               for i in range(REPORTS_LABELED)]
    with open(os.path.join(out_dir, "reports.csv"), "w", newline="") as f:
        csv.writer(f).writerows([r] for r in reports)
    labels_csv = os.path.join(out_dir, "labels.csv")
    cmds = {
        "chexpert_train": ["radialog_tpu_torch.apps.chexpert_train", "--mock", "--epochs", "1",
                           "--steps", "3", "--train", "--save_preds", "--output_dir",
                           os.path.join(out_dir, "classifier"), "--run_name", "card"],
        "chexbert_train": ["radialog_tpu_torch.apps.run_chexbert", "train", "--mock",
                           "--output_dir", os.path.join(out_dir, "chexbert")],
        "chexbert_label": ["radialog_tpu_torch.apps.run_chexbert", "label", "--mock",
                           "--reports_path", os.path.join(out_dir, "reports.csv"),
                           "--output_path", labels_csv]}
    t0 = time.time()
    procs = {k: subprocess.Popen([sys.executable, "-m"] + v + ["--device", dev],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for k, v in cmds.items()}
    res = {}
    for k, p in procs.items():
        try:
            so, se = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
        res[k] = (p.returncode, so.strip().splitlines(), se)
    seconds = time.time() - t0
    rc, lines, _ = res["chexpert_train"]
    cls_dir = os.path.join(out_dir, "classifier")
    preds_path = os.path.join(cls_dir, "structured_preds_card.json")
    preds = {}
    if os.path.exists(preds_path):
        with open(preds_path) as f:
            preds = json.load(f)
    ok_cls = (rc == 0 and len(lines) == 3 and lines[0].startswith("class weights")
              and sorted(json.loads(lines[1])) == ["epoch", "loss", "val_acc", "val_f1"]
              and lines[2].startswith("wrote 8 structured predictions") and len(preds) == 8
              and all(os.path.exists(os.path.join(cls_dir, n, "tree.pt")) for n in ("best", "last")))
    rc, lines, _ = res["chexbert_train"]
    ok_cbt = (rc == 0 and [ln.split(":")[0] for ln in lines] == ["step 1", "step 3", "step 5"]
              and os.path.exists(os.path.join(out_dir, "chexbert", "best", "tree.pt")))
    rc, lines, _ = res["chexbert_label"]
    rows = []
    if os.path.exists(labels_csv):
        with open(labels_csv, newline="") as f:
            rows = list(csv.reader(f))
    ok_lab = (rc == 0 and lines == [f"labeled {REPORTS_LABELED} reports -> {labels_csv}"]
              and len(rows) == REPORTS_LABELED + 1 and [r[0] for r in rows[1:]] == reports)
    return {"seconds": seconds, "ok": {"chexpert_train": ok_cls, "chexbert_train": ok_cbt,
                                       "chexbert_label": ok_lab},
            "stdout": {k: v[1] for k, v in res.items()},
            "stderr_tail": {k: v[2][-1500:] for k, v in res.items() if v[0] != 0}}


def phase_trainers(torch, counted):
    """The findings-classifier and CheXbert trainers: card against CPU at
    the CPU tests' sizes, the norms audit, both at full width (timed), and
    their three command lines on the card. No hand-written kernel runs:
    convolutions are cuDNN's (``lax.conv`` in the JAX package), BERT's
    attention is ``mha``."""
    import shutil
    _zero(counted)
    t0 = time.time()
    small = {"classifier": _classifier_small(torch), "chexbert": _chexbert_small(torch)}
    ok_small = small["classifier"]["plain"]["ok"] and small["classifier"]["augment"]["ok"] \
        and small["chexbert"]["ok"]
    emit("trainers", part="card_vs_cpu", seconds=time.time() - t0, **small, ok=ok_small)
    t0 = time.time()
    audit, held = _norms_audit(torch)
    emit("trainers", part="norms_audit", seconds=time.time() - t0, **audit, ok=held)
    t0 = time.time()
    softmax, soft_held = _softmax_audit(torch)
    held &= soft_held
    emit("trainers", part="softmax_audit", seconds=time.time() - t0, **softmax, ok=soft_held)
    gc.collect()
    torch.cuda.empty_cache()
    cls = _classifier_full(torch)
    gc.collect()
    torch.cuda.empty_cache()
    cbt = _chexbert_full(torch)
    emit("trainers", part="full", card=smi(), classifier=cls, chexbert=cbt,
         ok=cls["ok"] and cbt["ok"])
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = os.path.join("build", "chip_trainers")
    shutil.rmtree(out_dir, ignore_errors=True)
    clis = _trainer_clis(torch, out_dir)
    launches = _read(counted)
    emit("trainers", part="clis", **clis, launches=launches)
    if not (ok_small and held and cls["ok"] and cbt["ok"] and all(clis["ok"].values())) \
            or any(launches.values()):
        raise AssertionError("the trainers phase failed a check")
    return launches


# the datatools phase: tests/fixtures' 4 train studies each repeated
# INS_REPS times, so that each of create_data's teacher calls for EL, SU and
# RQA (its chunks of 12 prompts) fills the 12-lane ring, as the calls of a
# run over thousands of studies do; the mock's 3 correction prompts follow
INS_REPS = 18


class _TimedTeacher:
    """A pipeline's two teacher calls, timed (a synchronize after each), with
    the tokens each generated (up to and including an EOS, as the pipeline
    cuts them: the ring's sessions, the batch's ``lengths``) and the K2
    launches by mask (models/llama.py's ``flash_decode_int8`` calls on the
    card: per-lane intervals, K2', or the static-slot mask, K2)."""

    def __init__(self, torch, pipe):
        self.torch, self.pipe, self.calls, self.tokens = torch, pipe, [], 0
        self.k2_modes = {"intervals": 0, "static": 0}

    def _timed(self, kind, fn, prompts, **kw):
        from radialog_tpu_torch.decode import continuous
        from radialog_tpu_torch.models import llama
        real_run, real_fd, real_ids = continuous.RingBatcher.run, llama.flash_decode_int8, \
            self.pipe.generate_ids
        eos, before = self.pipe.tokenizer.eos_token_id, self.tokens

        def run(rb, *a, **k):
            done = real_run(rb, *a, **k)
            for sess in done.values():
                toks = list(sess.tokens)
                self.tokens += toks.index(eos) + 1 if eos in toks else len(toks)
            return done

        def flash_decode_int8(q, *a, **k):
            if q.is_cuda and k.get("current") is None:
                self.k2_modes["intervals" if k.get("gen_intervals") is not None
                              else "static"] += 1
            return real_fd(q, *a, **k)

        def generate_ids(*a, **k):
            res = real_ids(*a, **k)
            self.tokens += int(res.lengths.sum())
            return res

        continuous.RingBatcher.run, llama.flash_decode_int8 = run, flash_decode_int8
        self.pipe.generate_ids = generate_ids
        try:
            self.torch.cuda.synchronize()
            t0 = time.time()
            out = fn(prompts, **kw)
            self.torch.cuda.synchronize()
            seconds = time.time() - t0
        finally:
            continuous.RingBatcher.run, llama.flash_decode_int8 = real_run, real_fd
            del self.pipe.generate_ids
        self.calls.append({"kind": kind, "prompts": len(prompts), "seconds": seconds,
                           "tokens": self.tokens - before,
                           "max_new_tokens": kw.get("max_new_tokens")})
        return out

    def generate_texts_ring(self, prompts, **kw):
        return self._timed("ring", self.pipe.generate_texts_ring, prompts, **kw)

    def generate_texts(self, prompts, **kw):
        return self._timed("batch", self.pipe.generate_texts, prompts, **kw)


class _StubTeacher:
    """The CPU run's teacher: the prompt and a fixed reply."""

    def generate_texts_ring(self, prompts, **kw):
        return [p + " stub reply." for p in prompts]

    generate_texts = generate_texts_ring


def _report_tree(root):
    """A miniature MIMIC-CXR report tree (two p-groups, 9 studies in three
    formats, 0-3 dicoms each) and its JPEG tree (empty files): the reports'
    root, the JPEGs' root and each study's dicom ids in the walk's order."""
    import random
    head = "                                 FINAL REPORT\n"
    texts = [head + " EXAMINATION:  CHEST (PA AND LAT)\n \n INDICATION:  Cough.\n \n "
             "COMPARISON:  None.\n \n FINDINGS: \n \n The lungs are clear.\n \n IMPRESSION: "
             "\n \n No acute process.\n",
             " The heart is mildly enlarged.\n \n No acute cardiopulmonary process.\n",
             head + " HISTORY:  Fever.\n \n FINDNGS:  Right effusion.\n \n IMPRESSON:  "
             "Pneumonia.\n"]
    r = random.Random(0)
    n, studies = 0, []
    for grp, patients in (("p11", ("p11000003", "p11000001")), ("p10", ("p10000002",))):
        for patient in patients:
            for _ in range(3):
                stem = f"s5{n:07d}"
                os.makedirs(os.path.join(root, "reports", grp, patient), exist_ok=True)
                with open(os.path.join(root, "reports", grp, patient, stem + ".txt"), "w") as f:
                    f.write(texts[n % 3])
                img = os.path.join(root, "jpgs", grp, patient, stem)
                os.makedirs(img)
                dicoms = [f"{n:03d}-{d}" for d in range(r.randint(0, 3))]
                for d in dicoms:
                    open(os.path.join(img, d + ".jpg"), "wb").close()
                studies.append((grp, patient, stem, dicoms))
                n += 1
    return os.path.join(root, "reports"), os.path.join(root, "jpgs"), studies


def _replicated_fixtures(src, dst, reps):
    """tests/fixtures with each train study's rows repeated ``reps`` times
    under new dicom ids (``dcm008_00`` ...) in split.csv, sectioned.csv,
    chexpert.csv and preds.json, the other splits' rows once. Returns the
    number of train studies written."""
    import csv
    os.makedirs(dst, exist_ok=True)
    with open(os.path.join(src, "split.csv"), newline="") as f:
        train = {r["dicom_id"] for r in csv.DictReader(f) if r["split"] == "train"}

    def ids(d):
        return [f"{d}_{k:02d}" for k in range(reps)] if d in train else [d]

    for name in ("split.csv", "sectioned.csv", "chexpert.csv"):
        with open(os.path.join(src, name), newline="") as f:
            rows = list(csv.reader(f))
        col = rows[0].index("dicom_id")
        with open(os.path.join(dst, name), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(rows[0])
            w.writerows(r[:col] + [d] + r[col + 1:] for r in rows[1:] for d in ids(r[col]))
    with open(os.path.join(src, "preds.json")) as f:
        preds = json.load(f)
    with open(os.path.join(dst, "preds.json"), "w") as f:
        json.dump({d: v for k, v in preds.items() for d in ids(k)}, f)
    return len(train) * reps


def phase_datatools(torch, sl, counted):
    """The data tools: create_sections over a report tree the phase writes
    (one row per dicom, the walk's order, the header's columns, the sections
    of the formatted reports), create_data --mode RG over tests/fixtures,
    and --mode INS over those fixtures with each train study repeated
    INS_REPS times, with ``sl["pipe"]`` (the slice's Vicuna-7B-width W8A8
    pipeline, or one built as it) as the
    teacher through generate_texts_ring (12 lanes, the int8 ring: K1, and
    K2 only under per-lane intervals, K2') and with --teacher batch through
    generate_texts (K1, and K2 only under the static-slot mask), 64 new
    tokens (the mock's cut of the CLI's 256, for the script's time); the
    fused JSON's tasks as many as a CPU run's with a stub teacher; the
    teacher's tokens/s over all its calls."""
    import csv
    import io
    import shutil
    from radialog_tpu_torch.apps import create_data, create_sections
    from radialog_tpu_torch.data.section_parser import SECTIONED_COLUMNS
    root = os.path.join("build", "chip_datatools")
    shutil.rmtree(root, ignore_errors=True)
    reports, jpgs, studies = _report_tree(root)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        create_sections.main(["--reports_path", reports, "--mimic_cxr_jpg_path", jpgs,
                              "--output_path", os.path.join(root, "sections")])
    sections_csv = os.path.join(root, "sections", "mimic_cxr_sectioned.csv")
    with open(sections_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    # the walk is sorted by p-group, patient and study; a study's dicoms in
    # the listing's order, compared as a set
    walk = sorted(studies)
    ok_sections = (
        buf.getvalue().strip() == f"wrote {len(rows)} rows -> {sections_csv}"
        and list(rows[0]) == list(SECTIONED_COLUMNS)
        and [r["Note_file"] for r in rows] == [f"{st}.txt" for _, _, st, ds in walk for _ in ds]
        and sorted(r["dicom_id"] for r in rows) == sorted(d for *_, ds in walk for d in ds)
        and all(r["Img_Folder"] == f"files/{g}/{p}/{st}" and r["Img_Filename"] ==
                r["dicom_id"] + ".jpg" for r in rows for g, p, st, _ in walk
                if r["Note_file"] == f"{st}.txt")
        and all(r["findings"] == "The lungs are clear." and r["impression"] == "No acute process."
                for r in rows if int(r["Note_file"][2:-4]) % 3 == 0))
    fixtures = os.path.join("tests", "fixtures")
    with contextlib.redirect_stdout(io.StringIO()):
        create_data.main(["--mode", "RG", "--fixture-dir", fixtures, "--output-dir",
                          os.path.join(root, "rg")])
    with open(os.path.join(root, "rg", "mimic_cxr_reports_stratified.json")) as f:
        rg = json.load(f)
    ok_rg = bool(rg) and all(r["task"] == "RG" and r["output"] for r in rg)
    ins_fixtures = os.path.join(root, "ins_fixtures")
    train_studies = _replicated_fixtures(fixtures, ins_fixtures, INS_REPS)

    def ins(tag, teacher, extra=()):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            create_data.main(["--mode", "INS", "--mock", "--fixture-dir", ins_fixtures,
                              "--output-dir", os.path.join(root, tag), *extra],
                             teacher_pipeline=teacher)
        with open(os.path.join(root, tag, "mimic_cxr_instruct_stratified.json")) as f:
            fused = json.load(f)
        counts = {}
        for r in fused:
            counts[r["task"]] = counts.get(r["task"], 0) + 1
        return fused, counts, buf.getvalue().strip().splitlines()

    runs = {}
    for tag, extra in (("ring", ()), ("batch", ("--teacher", "batch"))):
        teacher = _TimedTeacher(torch, sl["pipe"])
        _zero(counted)
        t0 = time.time()
        fused, counts, lines = ins(tag, teacher, extra)
        secs = sum(c["seconds"] for c in teacher.calls)
        runs[tag] = {"seconds": time.time() - t0, "task_counts": counts, "lines": lines,
                     "teacher_calls": teacher.calls, "teacher_seconds": secs,
                     "teacher_tokens": teacher.tokens,
                     "teacher_tokens_per_s": teacher.tokens / secs,
                     "k2_calls_by_mask": teacher.k2_modes, "launches": _read(counted),
                     "outputs_nonempty": all(r["output"] for r in fused)}
    _, stub_counts, _ = ins("cpu_stub", _StubTeacher())
    mode = {"ring": "intervals", "batch": "static"}
    ok_ins = {tag: (r["task_counts"] == stub_counts and r["outputs_nonempty"]
                    and r["launches"]["q8_matmul"] > 0
                    and r["launches"]["flash_decode_int8"] > 0
                    and r["k2_calls_by_mask"][mode[tag]] == r["launches"]["flash_decode_int8"]
                    and sum(r["k2_calls_by_mask"].values()) == r["launches"]["flash_decode_int8"]
                    and sum(c["prompts"] == 12 for c in r["teacher_calls"]) >= 3
                    and all(c["kind"] == tag and c["max_new_tokens"] == 64 and c["tokens"] > 0
                            for c in r["teacher_calls"]))
              for tag, r in runs.items()}
    emit("datatools", sections_rows=len(rows), rg_examples=len(rg),
         ins_train_studies=train_studies, stub_task_counts=stub_counts, card=smi(), **runs,
         ok={"sections": ok_sections, "rg": ok_rg, **ok_ins})
    if not (ok_sections and ok_rg and all(ok_ins.values())):
        raise AssertionError("the datatools phase failed a check")
    return {tag: r["launches"] for tag, r in runs.items()}


# the quality phase: the quantization-budget tools' functions at Vicuna-7B
# width (tools/measure_*_torch.py), cut for the script's time; their full
# defaults run alone (PERF.md §2). measure_kv_logit_err at its defaults (3
# seeds, 4 layers, batch 4, 128-token prompts, 32 steps) beside the W8A8
# weights' own error at the same depth (measure_quant's W8A8 row, 1 seed);
# measure_quant's W4A8 row at 1 layer and 1 seed (pack_q4 takes ~38 s a
# layer on the host); measure_kv_int8 at 2 of its 8 seeds, 4 layers
QUALITY_LAYERS, QUALITY_KV_SEEDS, QUALITY_W4_LAYERS, QUALITY_INT8_SEEDS = 4, 3, 1, 2
# the tp phase: two ranks on the one card over gloo, TP = 2, each with a
# Vicuna-7B-width shard (16 heads, FFN 5504), cut in depth: TP_LAYERS for
# the 8-bit cases, one layer for the 4-bit case (its shards are packed by
# pack_q4 on the host), the weights of seed TP_SEED (8-bit) and of
# measure_quant's seed 0 (4-bit, so the quality phase's unsharded pack is
# its reference). The cases: a report batch over the int8 cache with a
# shared prefix of TP_PREFIX tokens (K3 in its prefill), the 4-bit batch,
# beams over the bf16 cache, and RaDialogServer over TPRingBatcher with
# TP_CLIENTS clients (3 admissions of a 256-slot bucket: K3)
TP_SEED, TP_LAYERS, TP_TIMEOUT_S = 21, 2, 600
TP_BATCH, TP_PREFIX, TP_REST, TP_NEW, TP_W4_T = 8, 272, 32, 32, 64
TP_BEAM_B, TP_BEAMS, TP_BEAM_T, TP_BEAM_NEW = 2, 2, 64, 16
TP_RING = dict(lanes=4, cache_len=320, prompt_len=256, steps_per_call=8)
TP_RING_LENS, TP_RING_NEW, TP_CLIENTS = (230, 120, 180, 250, 100, 140, 240, 160), 16, 4
# the bounds of the TP runs against the same weights unsharded on the card,
# teacher-forced with the TP run's tokens, on measure_kv_logit_err's scale
# (mean |logit difference| over the vocabulary / the unsharded logits' std,
# averaged over rows and steps): the 8-bit cases within the W8A8 weights'
# own error against FP32 on the same weights and depth (measure_quant's
# metric, computed in this phase), the 4-bit case within the W4A8 weights'
# own error (the quality phase's row on the same weights): TP re-quantizes
# the row-parallel wo/down per shard (and at 4 bits restarts their groups
# at the shard boundary), a second rounding of two of the four projections
# that must cost less than the quantization itself. Each session of the ring
# is held by its tokens: each within TP_RING_GAP standard deviations of the
# unsharded forced logits' largest (a gross-fault bound, as SPEC_TOL)
TP_RING_GAP = 1.0


def phase_quality(torch, counted, dev="cuda"):
    """The three quantization-budget tools' measurements on the card (their
    int8 paths through K1 and K2, W4A8 through K4). Returns the numbers and
    the unsharded W4A8 pack of measure_quant's seed 0 (the tp phase's 4-bit
    reference)."""
    from tools import measure_kv_int8_torch as mki
    from tools import measure_kv_logit_err_torch as mkl
    from tools import measure_quant_torch as mq
    cfg = _tp_cfg(QUALITY_LAYERS)
    _zero(counted)
    t0 = time.time()
    kv = mkl.measure(cfg, QUALITY_KV_SEEDS, 4, 128, 32, dev, log=lambda line: None)
    t1 = time.time()
    # the W8A8 weights' own error at the same depth, measure_quant's metric
    w8 = _w8_own_error(torch, mq, cfg, 0, dev)
    t2 = time.time()
    kept = {}

    def keep(seed, name, params):
        if name == "w4a8-asym":
            kept["w4"] = params
    rows = mq.measure(_tp_cfg(QUALITY_W4_LAYERS), 1, 50, 8, 64, "asym", dev, on_params=keep)
    t3 = time.time()
    int8 = mki.measure(cfg, QUALITY_INT8_SEEDS, 4, 128, 50, device=dev, log=lambda line: None)
    t4 = time.time()
    launches = _read(counted)
    quant = {r["mode"]: r for r in rows}
    figures = [kv["logit_err_per_sigma_mean"], w8, int8["mean_agreement"]] + \
        [r["logit_err_vs_fp32"] for r in rows]
    ok = (all(x == x and abs(x) != float("inf") for x in figures)
          and launches["q8_matmul"] > 0 and launches["flash_decode_int8"] > 0
          and launches["q4_matmul"] > 0 and "w4" in kept)
    emit("quality", card=smi(), kv_logit_err=kv, w8a8_err_same_depth=w8,
         kv_int8_within_w8a8=kv["logit_err_per_sigma_mean"] <= w8,
         quant={k: {kk: vv for kk, vv in v.items() if kk != "note"} for k, v in quant.items()},
         kv_int8=int8, seconds={"kv_logit_err": t1 - t0, "w8a8_same_depth": t2 - t1,
                                "quant_w4": t3 - t2, "kv_int8": t4 - t3},
         launches=launches, ok=ok)
    if not ok:
        raise AssertionError("the quality phase failed a check")
    return {"launches": launches, "w4_err": quant["w4a8-asym"]["logit_err_vs_fp32"],
            "w8_err": w8}, kept["w4"]


def _w8_own_error(torch, mq, cfg, seed, dev, params32=None):
    """measure_quant's W8A8 prefill error against FP32 (batch 8, 64-token
    prompts, numpy's tokens of ``seed``) on the float weights ``params32``,
    by default those of ``seed`` at ``cfg``."""
    import numpy as np
    from radialog_tpu_torch.models.llama import llama_init
    if params32 is None:
        params32 = llama_init(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(3, 30000, (8, 64)).astype(np.int32)).to(dev)
    lens = torch.full((8,), 64, dtype=torch.int32, device=dev)
    out = mq.measure_seed(params32, cfg, toks, lens, 1, [("w8a8", 8, "asym")], 64 + 1 + 14)
    return out["w8a8"][0]


def _tp_inputs():
    """The tp phase's token inputs (numpy, the same in every rank and in the
    parent): the shared prefix and remainders, the 4-bit and beam prompts,
    the ring's prompts."""
    import numpy as np
    rng = np.random.default_rng(TP_SEED)

    def toks(b, t, lo):
        x = rng.integers(3, 30000, (b, t)).astype(np.int32)
        lens = rng.integers(lo, t + 1, (b,)).astype(np.int32)
        for i in range(b):
            x[i, lens[i]:] = 0
        return x, lens
    prefix = rng.integers(3, 30000, (TP_PREFIX,)).astype(np.int32)
    rest, rest_lens = toks(TP_BATCH, TP_REST, 20)
    w4, w4_lens = toks(TP_BATCH, TP_W4_T, 40)
    beam, beam_lens = toks(TP_BEAM_B, TP_BEAM_T, 40)
    ring = [rng.integers(3, 30000, (n,)).tolist() for n in TP_RING_LENS]
    return dict(prefix=prefix, rest=rest, rest_lens=rest_lens, w4=w4, w4_lens=w4_lens,
                beam=beam, beam_lens=beam_lens, ring=ring)


def _tp_cfg(layers):
    """Vicuna-7B's widths at ``layers`` layers, as the quality tools build it."""
    from tools.measure_kv_logit_err_torch import llama_config
    return llama_config(32001, 4096, layers, 32, 11008)


def _sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _forced_logits(torch, params, cfg, toks, lens, forced, kv_int8, prefix=None, group=None):
    """Teacher-forced logits (B, steps, V) f32 over the serving path the
    batch engine runs (``generate`` / ``generate_shared_prefix``, BF16): the
    prefill's last logits, then one decode step per forced token but the
    last. ``group``: a rank's model group, its shard in ``params``."""
    from radialog_tpu_torch.decode import engine as te
    from radialog_tpu_torch.models.llama import init_cache, llama_apply, prefill_bias
    from radialog_tpu_torch.ops.layers import BF16
    b, t = toks.shape
    dp = te.DecodeParams(max_new_tokens=forced.shape[1], eos_token_id=-1)
    cache_len = te.default_cache_len(t, dp)
    shared, p0 = None, 0
    with torch.no_grad():
        if prefix is not None:
            p0 = prefix.shape[0]
            kv = te.prefix_kv(params, cfg, prefix, policy=BF16, tp_group=group)
            cache = init_cache(cfg, b, cache_len, device=toks.device, quantized=kv_int8)
            pos = p0 + torch.arange(t, device=toks.device)[None].repeat(b, 1)
            logits, cache = llama_apply(params, cfg, toks, pos, prefill_bias(lens, t),
                                        cache=cache, lengths=lens, last_pos=lens - 1,
                                        shared_kv=kv, policy=BF16, tp_group=group)
            first, shared = logits[:, 0], te.decode_prefix(kv, cache)
        else:
            cache, first = te.prefill(params, cfg, toks, lens, cache_len, policy=BF16,
                                      kv_int8=kv_int8, tp_group=group)
        rows = [first]
        for step in range(forced.shape[1] - 1):
            rows.append(te.decode_step(params, cfg, cache, forced[:, step], lens, t, step,
                                       policy=BF16, shared_kv=shared, pos_offset=p0,
                                       shared_p0=p0 if prefix is not None else None,
                                       tp_group=group))
    return torch.stack(rows, 1).float()


def _normalized_err(got, ref):
    """measure_kv_logit_err's scale: mean over rows and steps of mean |got -
    ref| over the vocabulary / ref's std there."""
    sigma = ref.std(dim=-1, unbiased=False)
    return float(((got - ref).abs().mean(-1) / sigma).mean())


def _tp_counted(torch):
    """The kernels of the tp phase's paths, as _Kept stand-ins installed in
    their modules: each keeps its first call per case and shape, for the
    holds against the plain versions at the shard's shapes."""
    from radialog_tpu_torch.ops import flash_attention as tfa
    from radialog_tpu_torch.ops import flash_decode as tfd
    from radialog_tpu_torch.ops import q4_matmul as tq4
    from radialog_tpu_torch.ops import q8_matmul as tq8
    state = {"corr": None}
    seen = set()

    def first_per_shape(st, index, args):
        key = (st["corr"], tuple(args[1].shape), args[0].shape[0] > 1)
        if key in seen:
            return False
        seen.add(key)
        return True
    kept = {"q8_matmul": _Kept(tq8.q8_matmul_int32, tq8.q8_matmul_int32_plain, state,
                               first_per_shape),
            "q4_matmul": _Kept(tq4.q4_matmul_acc, tq4.q4_matmul_acc_plain, state,
                               first_per_shape),
            "flash_decode_int8": _Kept(tfd.flash_decode_int8_kernel, tfd.flash_decode_int8_plain,
                                       state, lambda st, i, a: i in (0, 1 + TP_LAYERS * 9)),
            "flash_decode_int8_current": _Kept(tfd.flash_decode_int8_current_kernel,
                                               tfd.flash_decode_int8_plain, state,
                                               lambda st, i, a: i in (0, 1 + TP_LAYERS * 9)),
            "flash_attention": _Kept(tfa.flash_attention_kernel, tfa.flash_attention_plain, state,
                                     lambda st, i, a: i == 0)}
    tq8.q8_matmul_int32, tq4.q4_matmul_acc = kept["q8_matmul"], kept["q4_matmul"]
    tfd.flash_decode_int8_kernel = kept["flash_decode_int8"]
    tfd.flash_decode_int8_current_kernel = kept["flash_decode_int8_current"]
    tfa.flash_attention_kernel = kept["flash_attention"]
    return kept, state


def _tp_case(torch, kept, state, name, run, dev):
    """Run one case under its name: (its result, seconds, launches by
    kernel, the holds of its kept calls)."""
    state["corr"] = name
    _zero(kept)
    _sync(torch, dev)
    t0 = time.time()
    out = run()
    _sync(torch, dev)
    seconds = time.time() - t0
    launches = _read(kept)
    holds = _eval_holds(torch, kept)
    for k in kept.values():
        k.kept.clear()
    return out, seconds, launches, holds


def _all_reduce_ms(torch, group, dev, n: int = 20):
    """Host ms of one ``reduce_from_group`` of a decode step's bf16 activations
    (TP_BATCH x 4096) over ``group``, and of a prefill's (TP_BATCH x
    TP_REST rows), each the mean of n after a warm-up."""
    from radialog_tpu_torch.parallel.collectives import reduce_from_group
    out = {}
    for name, rows in (("decode", TP_BATCH), ("prefill", TP_BATCH * TP_REST)):
        x = torch.ones((rows, 4096), dtype=torch.bfloat16, device=dev)
        reduce_from_group(x, group)
        _sync(torch, dev)
        t0 = time.time()
        for _ in range(n):
            reduce_from_group(x, group)
        _sync(torch, dev)
        out[name] = (time.time() - t0) / n * 1e3
    return out


def _tp_rank(job_path: str) -> int:
    """One rank of the tp phase (``chip_smoke.py --tp-rank JOB``): joins the
    process group from the RADIALOG_* environment, takes its shards and runs
    the job's cases in lock step with the other ranks; rank 0 writes the
    numbers and its teacher-forced logits next to JOB."""
    import threading
    import numpy as np
    import torch
    from radialog_tpu_torch.apps.serve import RaDialogServer
    from radialog_tpu_torch.core import mesh as tm
    from radialog_tpu_torch.decode.engine import DecodeParams
    from radialog_tpu_torch.models.llama import llama_init
    from radialog_tpu_torch.ops.layers import BF16, set_precision
    from radialog_tpu_torch.parallel.tp_ring import TPRingBatcher
    from radialog_tpu_torch.parallel.tp_serving import (make_tp_generate, shard_config,
                                                        shard_quantized_llama)
    with open(job_path) as f:
        job = json.load(f)
    world = int(os.environ["RADIALOG_NUM_PROCESSES"])
    dev = torch.device("cpu")
    if job["device"] == "cuda":
        dev = torch.device("cuda",
                           int(os.environ["RADIALOG_PROCESS_ID"]) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    set_precision()
    t_start = time.time()
    tm.init_distributed(device=job["device"], backend=job["backend"], timeout=TP_TIMEOUT_S)
    mesh = tm.make_mesh(tm.MeshSpec(1, world), device=job["device"], timeout=TP_TIMEOUT_S)
    group, rank = tm.axis_group(mesh, tm.MODEL_AXIS), tm.axis_rank(mesh, tm.MODEL_AXIS)
    kept, state = _tp_counted(torch)
    inp = {k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v)
           for k, v in _tp_inputs().items()}
    out = {"rank": rank, "world": world, "backend": job["backend"], "device": str(dev),
           "init_s": time.time() - t_start, "cases": {},
           "all_reduce_ms": _all_reduce_ms(torch, group, dev)}
    logits = {}

    def shard(seed, layers, bits):
        cfg = _tp_cfg(layers)
        tree = llama_init(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
        check = float(tree["layers"]["wq"]["w"].double().sum() + tree["embed"].double().sum())
        t0 = time.time()
        params = shard_quantized_llama(tree, cfg, world, rank, bits=bits, device=dev)
        del tree
        local = shard_config(cfg, world)
        lp = params["layers"][0]
        shapes = {name: list(getattr(lp[name], "w").shape) for name in
                  ("wqkv", "wo", "gateup", "down")}
        return cfg, params, {"tree_checksum": check, "pack_s": time.time() - t0,
                             "local_heads": local.num_heads, "local_ffn": local.intermediate_size,
                             "packed_weight_shapes": shapes}

    def record(name, res, seconds, launches, holds, forced_logits=None, **extra):
        out["cases"][name] = {"seconds": seconds, "launches": launches, "holds": holds,
                              **extra}
        if res is not None:
            out["cases"][name]["tokens"] = res.tokens.cpu().tolist()
        if forced_logits is not None and rank == 0:
            logits[name] = forced_logits.cpu().numpy()

    cfg8, p8, info8 = shard(TP_SEED, TP_LAYERS, 8)
    out["shard8"] = info8
    local8 = shard_config(cfg8, world)
    if "int8_prefix" in job["cases"]:
        dp = DecodeParams(max_new_tokens=TP_NEW, eos_token_id=-1)
        fn = make_tp_generate(mesh, cfg8, dp, kv_int8=True, shared_prefix=True, policy=BF16,
                              device=dev)
        res, s, launches, holds = _tp_case(torch, kept, state, "int8_prefix", lambda: fn(
            p8, inp["rest"], inp["rest_lens"], prefix_tokens=inp["prefix"]), dev)
        tf = _forced_logits(torch, p8, local8, inp["rest"], inp["rest_lens"], res.tokens, True,
                            inp["prefix"], group)
        record("int8_prefix", res, s, launches, holds, tf,
               tokens_per_s=TP_BATCH * TP_NEW / s, reports_per_s=TP_BATCH / s)
    if "defer" in job["cases"]:
        # the same batch with in-kernel KV writes: K2'' in place of K2
        with _env("RADIALOG_DEFER_KV", "1"):
            dp = DecodeParams(max_new_tokens=TP_NEW, eos_token_id=-1)
            fn = make_tp_generate(mesh, cfg8, dp, kv_int8=True, shared_prefix=True,
                                  policy=BF16, device=dev)
            res, s, launches, holds = _tp_case(torch, kept, state, "defer", lambda: fn(
                p8, inp["rest"], inp["rest_lens"], prefix_tokens=inp["prefix"]), dev)
            tf = _forced_logits(torch, p8, local8, inp["rest"], inp["rest_lens"], res.tokens,
                                True, inp["prefix"], group)
        record("defer", res, s, launches, holds, tf, tokens_per_s=TP_BATCH * TP_NEW / s)
    if "beam" in job["cases"]:
        dp = DecodeParams(max_new_tokens=TP_BEAM_NEW, eos_token_id=-1)
        fn = make_tp_generate(mesh, cfg8, dp, kv_int8=False, num_beams=TP_BEAMS, policy=BF16,
                              device=dev)
        res, s, launches, holds = _tp_case(torch, kept, state, "beam", lambda: fn(
            p8, inp["beam"], inp["beam_lens"]), dev)
        tf = _forced_logits(torch, p8, local8, inp["beam"], inp["beam_lens"], res.tokens, False,
                            None, group)
        record("beam", res, s, launches, holds, tf, tokens_per_s=TP_BEAM_B * TP_BEAM_NEW / s)
    if "ring" in job["cases"]:
        dp = DecodeParams(max_new_tokens=TP_RING_NEW, eos_token_id=-1)
        tp = TPRingBatcher(mesh, p8, cfg8, dp=dp, policy=BF16, device=dev, **TP_RING)

        def serve():
            if rank != 0:
                return {"chunks": tp.serve_follower()}
            srv = RaDialogServer(batcher=tp)
            futs, errors = {}, []

            def client(c):
                try:
                    for j in range(c, len(inp["ring"]), TP_CLIENTS):
                        futs[j] = srv.submit(inp["ring"][j])
                except Exception as exc:     # reported, and fails the phase
                    errors.append(repr(exc))
            threads = [threading.Thread(target=client, args=(c,)) for c in range(TP_CLIENTS)]
            try:
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(TP_TIMEOUT_S)
                served = [futs[j].result(timeout=TP_TIMEOUT_S) for j in range(len(inp["ring"]))]
            finally:
                srv.shutdown()
                tp.close()
            return {"served": served, "errors": errors}
        got, s, launches, holds = _tp_case(torch, kept, state, "ring", serve, dev)
        record("ring", None, s, launches, holds, digests=list(tp.chunk_digests),
               tokens_per_s=len(TP_RING_LENS) * TP_RING_NEW / s, **got)
    if "w4" in job["cases"]:
        cfg4, p4, info4 = shard(0, QUALITY_W4_LAYERS, 4)
        out["shard4"] = info4
        dp = DecodeParams(max_new_tokens=TP_NEW, eos_token_id=-1)
        fn = make_tp_generate(mesh, cfg4, dp, kv_int8=True, policy=BF16, device=dev)
        res, s, launches, holds = _tp_case(torch, kept, state, "w4", lambda: fn(
            p4, inp["w4"], inp["w4_lens"]), dev)
        tf = _forced_logits(torch, p4, shard_config(cfg4, world), inp["w4"], inp["w4_lens"],
                            res.tokens, True, None, group)
        record("w4", res, s, launches, holds, tf, tokens_per_s=TP_BATCH * TP_NEW / s)
    out["total_s"] = time.time() - t_start
    torch.distributed.destroy_process_group()
    with open(f"{job_path}.{rank}.json", "w") as f:
        json.dump(out, f)
    if logits:
        np.savez(f"{job_path}.logits.npz", **logits)
    return 0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tp_start(name: str, world: int, backend: str, cases, dev="cuda", flag="--tp-rank",
              sub="tp", **job_fields):
    """Start ``world`` rank processes of this script (``flag JOB``) on the
    card, meeting at a free localhost port; the job file under build/``sub``
    holds the backend, the cases (a list of names, or a dict) and
    ``job_fields``. Returns (job path,
    processes)."""
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", sub)
    os.makedirs(out_dir, exist_ok=True)
    job = os.path.join(out_dir, f"{name}.json")
    for old in (f"{job}.{r}.json" for r in range(world)):
        if os.path.exists(old):
            os.remove(old)
    with open(job, "w") as f:
        json.dump({"backend": backend, "device": dev,
                   "cases": cases if isinstance(cases, dict) else list(cases), **job_fields}, f)
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RADIALOG_COORDINATOR=f"localhost:{port}",
                   RADIALOG_NUM_PROCESSES=str(world), RADIALOG_PROCESS_ID=str(r),
                   PYTHONPATH=root)
        log = open(f"{job}.{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, job],
                                       env=env, stdout=log, stderr=subprocess.STDOUT,
                                       cwd=root), log))
    return job, procs


def _tp_wait(job, procs):
    """Wait for a group's ranks (killing them at TP_TIMEOUT_S); returns their
    outputs in rank order, or raises with the tails of their logs."""
    deadline = time.time() + TP_TIMEOUT_S
    try:
        for p, log in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if any(p.returncode for p, _ in procs):
        tails = [open(f"{job}.{r}.log").read()[-3000:] for r in range(len(procs))]
        raise AssertionError(f"tp ranks of {job} failed (rc "
                             f"{[p.returncode for p, _ in procs]}):\n" + "\n---\n".join(tails))
    outs = []
    for r in range(len(procs)):
        with open(f"{job}.{r}.json") as f:
            outs.append(json.load(f))
    return outs


def _tp_shape_holds(torch, dev="cuda"):
    """K1 and K4 at every projection shape of a 2- and a 4-way Vicuna-7B
    shard (N halved or quartered for wqkv and gateup, K for wo and down:
    down's K is 5,504 and 2,752, the latter not a multiple of 128, which K4's
    groups cover as 6 groups of 512 rows in pick_bk's 1,024-row blocks, the
    last half zeros) at the tp phase's decode rows, each against its plain
    version, bitwise; K4 on both grids."""
    from radialog_tpu_torch.ops import q4_matmul as tq4
    from radialog_tpu_torch.ops import q8_matmul as tq8
    g = torch.Generator(device=dev).manual_seed(23)
    held = []
    for n_shards in (2, 4):
        h, inter = 4096, 11008
        shapes = {"wqkv": (h, 3 * h // n_shards), "wo": (h // n_shards, h),
                  "gateup": (h, 2 * inter // n_shards), "down": (inter // n_shards, h)}
        for name, (k, n) in shapes.items():
            x8 = torch.randint(-127, 128, (TP_BATCH, k), generator=g, device=dev,
                               dtype=torch.int8)
            w8 = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
            k1 = bool(torch.equal(tq8.q8_matmul_int32(x8, w8), tq8.q8_matmul_int32_plain(x8, w8)))
            bk = tq4.pick_bk(k)
            group = tq4.GROUP if bk % tq4.GROUP == 0 else bk
            groups = -(-k // bk) * bk // group
            w4 = torch.randint(-128, 128, (n, k // 2), generator=g, device=dev,
                               dtype=torch.int8)
            gscale = (torch.rand((groups, n), generator=g, device=dev) + 0.5) / (4.6 * k ** 0.5)
            goff = (torch.rand((groups, n), generator=g, device=dev) - 0.5) * gscale
            k4 = all(bool(torch.equal(tq4.q4_matmul_acc(x8, w4, gscale, off, group),
                                      tq4.q4_matmul_acc_plain(x8, w4, gscale, off, group)))
                     for off in (goff, None))
            held.append({"shards": n_shards, "weight": name, "m": TP_BATCH, "k": k, "n": n,
                         "k4_group": group, "k4_groups": groups, "k1_bitwise": k1,
                         "k4_bitwise": k4})
    return held


def phase_tp(torch, started, quality, w4_ref, dev="cuda"):
    """Tensor-parallel serving on the card: the ranks started by _tp_start
    (two over gloo, TP = 2; one over NCCL, TP = 1; two over NCCL where the
    machine has two cards) against the same weights unsharded here. Checks:
    every rank exits 0; both gloo ranks' tokens and ring chunks equal; each
    case's teacher-forced logits within its bound (TP_RING_GAP's comment) of
    the unsharded run's; K1, K2, K3 and K4 launched at the shard's shapes and
    each kept call held against its plain version (K1, K4 bitwise, K2
    K2_TOL, K3 K3_TOL); NCCL at TP = 1 token-equal to the unsharded run."""
    import numpy as np
    from radialog_tpu_torch.decode import engine as te
    from radialog_tpu_torch.decode.beam import generate_beam
    from radialog_tpu_torch.models.llama import llama_init
    from radialog_tpu_torch.ops.layers import BF16
    from radialog_tpu_torch.ops.quant import quantize_llama_host
    from tools import measure_quant_torch as mq
    gloo = _tp_wait(*started["gloo"])
    nccl1 = _tp_wait(*started["nccl1"])
    nccl2 = _tp_wait(*started["nccl2"]) if "nccl2" in started else None
    job = started["gloo"][0]
    tp_logits = dict(np.load(f"{job}.logits.npz"))
    inp = {k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v)
           for k, v in _tp_inputs().items()}
    t0 = time.time()
    cfg8 = _tp_cfg(TP_LAYERS)
    tree = llama_init(torch.Generator(device=dev).manual_seed(TP_SEED), cfg8, device=dev)
    check = float(tree["layers"]["wq"]["w"].double().sum() + tree["embed"].double().sum())
    w8_err = _w8_own_error(torch, mq, cfg8, TP_SEED, dev, tree)
    full8 = quantize_llama_host(tree, device=dev)
    del tree
    cases, ok = {}, True
    g0 = gloo[0]["cases"]

    def tok(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    # the report batch, int8 cache, shared prefix
    dp = te.DecodeParams(max_new_tokens=TP_NEW, eos_token_id=-1)
    with torch.no_grad():
        ref_a = te.generate_shared_prefix(full8, cfg8, inp["prefix"], inp["rest"],
                                          inp["rest_lens"], dp, policy=BF16).tokens.cpu()
    forced = tok(g0["int8_prefix"]["tokens"])
    ref = _forced_logits(torch, full8, cfg8, inp["rest"], inp["rest_lens"], forced, True,
                         inp["prefix"])
    err = _normalized_err(torch.from_numpy(tp_logits["int8_prefix"]).to(dev), ref)
    cases["int8_prefix"] = {"err": err, "bound": w8_err, "within": err <= w8_err,
                            "tokens_equal_unsharded": float((forced.cpu() == ref_a).float().mean()),
                            "nccl_tp1_equal_unsharded": nccl1[0]["cases"]["int8_prefix"]["tokens"]
                            == ref_a.tolist()}
    # the same with in-kernel KV writes (K2'')
    forced = tok(g0["defer"]["tokens"])
    with _env("RADIALOG_DEFER_KV", "1"):
        ref = _forced_logits(torch, full8, cfg8, inp["rest"], inp["rest_lens"], forced, True,
                             inp["prefix"])
    err = _normalized_err(torch.from_numpy(tp_logits["defer"]).to(dev), ref)
    cases["defer"] = {"err": err, "bound": w8_err, "within": err <= w8_err,
                      "tokens_equal_defer_off": float(
                          (forced.cpu() == torch.tensor(g0["int8_prefix"]["tokens"])).float()
                          .mean())}
    # beams over the bf16 cache
    dp = te.DecodeParams(max_new_tokens=TP_BEAM_NEW, eos_token_id=-1)
    with torch.no_grad():
        ref_c = generate_beam(full8, cfg8, inp["beam"], inp["beam_lens"], dp, TP_BEAMS,
                              policy=BF16).tokens.cpu()
    forced = tok(g0["beam"]["tokens"])
    ref = _forced_logits(torch, full8, cfg8, inp["beam"], inp["beam_lens"], forced, False)
    err = _normalized_err(torch.from_numpy(tp_logits["beam"]).to(dev), ref)
    cases["beam"] = {"err": err, "bound": w8_err, "within": err <= w8_err,
                     "tokens_equal_unsharded": float((forced.cpu() == ref_c).float().mean())}
    # the ring's sessions: each served token against the unsharded forced logits
    served = g0["ring"]["served"]
    t_max = max(TP_RING_LENS)
    prompts = np.zeros((len(served), t_max), np.int32)
    for j, ids in enumerate(inp["ring"]):
        prompts[j, :len(ids)] = ids
    plens = tok(list(TP_RING_LENS))
    forced = tok(served)
    ref = _forced_logits(torch, full8, cfg8, tok(prompts.tolist()), plens, forced, False)
    sigma = ref.std(dim=-1, unbiased=False)
    gap = (ref.amax(-1) - ref.gather(-1, forced.long()[..., None])[..., 0]) / sigma
    cases["ring"] = {"gap_max_sigma": float(gap.max()), "gap_mean_sigma": float(gap.mean()),
                     "bound": TP_RING_GAP, "within": float(gap.max()) <= TP_RING_GAP,
                     "argmax_equal": float((gap == 0).float().mean())}
    del full8
    # the 4-bit batch, against the quality phase's unsharded W4A8 pack
    dp = te.DecodeParams(max_new_tokens=TP_NEW, eos_token_id=-1)
    cfg4 = _tp_cfg(QUALITY_W4_LAYERS)
    forced = tok(g0["w4"]["tokens"])
    with torch.no_grad():
        ref_b = te.generate(w4_ref, cfg4, inp["w4"], inp["w4_lens"], dp, policy=BF16).tokens.cpu()
    ref = _forced_logits(torch, w4_ref, cfg4, inp["w4"], inp["w4_lens"], forced, True)
    err = _normalized_err(torch.from_numpy(tp_logits["w4"]).to(dev), ref)
    cases["w4"] = {"err": err, "bound": quality["w4_err"], "within": err <= quality["w4_err"],
                   "tokens_equal_unsharded": float((forced.cpu() == ref_b).float().mean())}
    ref_s = time.time() - t0
    shape_holds = _tp_shape_holds(torch, dev)
    # ranks: equal tokens, every kernel at shard shapes, every hold
    ranks_equal = all(r["cases"][c]["tokens"] == g0[c]["tokens"]
                      for r in gloo[1:] for c in ("int8_prefix", "defer", "beam", "w4")) and \
        all(r["cases"]["ring"]["digests"] == g0["ring"]["digests"]
            and r["cases"]["ring"]["chunks"] == len(g0["ring"]["digests"]) > 0
            for r in gloo[1:])
    need = {"int8_prefix": ("q8_matmul", "flash_decode_int8", "flash_attention"),
            "defer": ("q8_matmul", "flash_decode_int8_current", "flash_attention"),
            "beam": ("q8_matmul",), "ring": ("q8_matmul", "flash_attention"),
            "w4": ("q4_matmul", "q8_matmul", "flash_decode_int8")}
    launched = (all(r["cases"][c]["launches"][k] > 0 for r in gloo
                    for c, ks in need.items() for k in ks)
                and all(r["cases"]["defer"]["launches"]["flash_decode_int8"] == 0 for r in gloo))
    holds = [h for r in gloo for c in r["cases"].values() for h in c["holds"]]
    held = bool(holds) and all(h["ok"] for h in holds)
    shard_shapes = {"shard8": gloo[0]["shard8"], "shard4": gloo[0]["shard4"]}
    checksums = [r[k]["tree_checksum"] for r in gloo for k in ("shard8",)] + [check]
    ok = (ranks_equal and launched and held and len(set(checksums)) == 1
          and all(x["k1_bitwise"] and x["k4_bitwise"] for x in shape_holds)
          and all(c["within"] for c in cases.values())
          and cases["int8_prefix"]["nccl_tp1_equal_unsharded"]
          and not g0["ring"]["errors"] and len(served) == len(TP_RING_LENS)
          and all(len(s) == TP_RING_NEW for s in served))
    nccl2_equal = None
    if nccl2 is not None:
        nccl2_equal = nccl2[0]["cases"]["int8_prefix"]["tokens"] == g0["int8_prefix"]["tokens"]
        ok = ok and nccl2_equal
    emit("tp", card=smi(), cards=torch.cuda.device_count(), layers=TP_LAYERS,
         w4_layers=QUALITY_W4_LAYERS, cases=cases, w8a8_err_same_weights=w8_err,
         ranks_equal=ranks_equal, launched_at_shard_shapes=launched, holds_ok=held,
         holds=len(holds), holds_worst={k: max((h["max_abs_err"] for h in holds
                                               if h["kernel"] == k), default=None)
                                        for k in need["int8_prefix"] + need["defer"][1:2]
                                        + ("q4_matmul",)},
         held_shapes=sorted({(h["kernel"], h.get("n"), h.get("k"), h.get("s"), h.get("t"))
                             for h in holds}, key=str),
         shards=shard_shapes, shard_shape_holds=shape_holds, tree_checksums_equal=len(set(checksums)) == 1,
         rank_seconds={c: g0[c]["seconds"] for c in g0}, rank_init_s=gloo[0]["init_s"],
         rank_total_s=gloo[0]["total_s"], reference_s=ref_s,
         all_reduce_ms={"gloo": gloo[0]["all_reduce_ms"], "nccl_world1": nccl1[0]["all_reduce_ms"]},
         tokens_per_s={c: g0[c]["tokens_per_s"] for c in g0},
         reports_per_s=g0["int8_prefix"]["reports_per_s"],
         launches_rank0={c: g0[c]["launches"] for c in g0},
         nccl_tp1={"launches": nccl1[0]["cases"]["int8_prefix"]["launches"],
                   "seconds": nccl1[0]["cases"]["int8_prefix"]["seconds"]},
         nccl_tp2=("not run: one card" if nccl2 is None else {"tokens_equal_gloo": nccl2_equal}),
         note="tokens/s of two ranks sharing one card over gloo: no measure of TP speed-up",
         ok=ok)
    if not ok:
        raise AssertionError("the tp phase failed a check")
    return {k: sum(g0[c]["launches"].get(k, 0) for c in g0) for k in
            ("q8_matmul", "flash_decode_int8", "flash_decode_int8_current", "flash_attention",
             "q4_matmul")}


# the tptrain phase: the depth of the Vicuna-7B-width model, the global
# micro-batch, AdamW micro-steps, the weights' seed; stage 1's global batch,
# text tokens and patch tokens; the SGD learning rates (1: the update is
# the gradient)
TPTRAIN_LAYERS, TPTRAIN_MICRO, TPTRAIN_STEPS, TPTRAIN_SEED = 2, 4, 3, 31
TPTRAIN_S1_BATCH, TPTRAIN_S1_TXT, TPTRAIN_S1_PATCHES = 32, 256, 196
TPTRAIN_LR, TPTRAIN_S1_LR = 1.0, 0.1
# bounds of the sharded runs against the one-process run on the card
# (BF16 compute for LoRA, FP32 for stage 1): relative loss and grad_norm
# errors, the least cosine of a leaf's update with the reference's, and a
# leaf's largest element error over its largest update (a cosine does not
# see scale: a gradient summed twice reads 1.0 there). Set at a few times
# the readings on an H100 at 700 W (PERF.md section 6): update error 0.056
# (TP = 2) and 0.046 (DP = 2) in bf16, 4.9e-4 for stage 1; stage 1's least
# cosine 1 - 3.0e-9
TPTRAIN_TOL = {"loss_rel": 1e-4, "grad_norm_rel": 1e-3, "cos": 0.999, "update_rel": 0.2,
               "adamw_loss_rel": 5e-4, "s1_loss_rel": 1e-5, "s1_cos": 1 - 1e-8,
               "s1_update_rel": 2e-3}


def _tptrain_cfg():
    from radialog_tpu_torch.models.llama import VICUNA_7B
    return dataclasses.replace(VICUNA_7B, num_layers=TPTRAIN_LAYERS)


def _tptrain_weights(torch, dev):
    """(cfg, base, lora) of the phase, the same bits in every process on
    the card: the int8 base from a device generator, the adapters from the
    host's, with b drawn (zero, it would leave a without a gradient)."""
    from radialog_tpu_torch.models.llama import lora_init
    from radialog_tpu_torch.ops.quant import random_q8_train_base
    from radialog_tpu_torch.train.optim import tree_map
    cfg = _tptrain_cfg()
    base = random_q8_train_base(cfg, torch.Generator(device=dev).manual_seed(TPTRAIN_SEED),
                                device=dev)
    gen = torch.Generator().manual_seed(TPTRAIN_SEED)
    lora = lora_init(gen, cfg, device="cpu")
    for ab in lora["layers"].values():
        ab["b"] = torch.randn(ab["b"].shape, generator=gen) * 0.02
    return cfg, base, tree_map(lambda x: x.to(dev), lora)


def _tptrain_batch(cfg, records):
    """The global micro-batch of the SGD step (numpy): the train phase's
    tokenization of records 2-5 (their valid label counts differ, so the two
    data ranks hold different counts)."""
    from radialog_tpu_torch.apps import finetune_lora as ft
    from radialog_tpu_torch.apps.tokenization import WhitespaceTokenizer
    tok = WhitespaceTokenizer(vocab_size=cfg.vocab_size, num_img_tokens=cfg.num_img_tokens,
                              img_token_id=cfg.img_token_id)
    fcfg = ft.FinetuneConfig(synthetic=True, cutoff_len=CUTOFF, use_embs=True)
    return ft._make_batcher(records[2:], tok, fcfg, cfg, {})(list(range(TPTRAIN_MICRO)))


def _tptrain_sgd(torch, cfg, base, lora, batch, dev, mesh=None, before_timed=None):
    """One SGD LoRA step (BF16, remat, flash) of the global micro-batch,
    twice from the same state: the first warms up, the second is timed
    (``before_timed()`` is called just before it). Returns (loss, grad_norm,
    the new local tree, ms of the timed step)."""
    from radialog_tpu_torch.core.mesh import shard_batch
    from radialog_tpu_torch.ops.layers import BF16
    from radialog_tpu_torch.train.optim import make_sgd
    from radialog_tpu_torch.train.steps import TrainState, make_lora_train_step
    tx = make_sgd(TPTRAIN_LR, momentum=0.0)
    step = make_lora_train_step(tx, cfg, policy=BF16, remat=True, flash=True, mesh=mesh)
    local = shard_batch(mesh, batch, dev)
    for timed in (False, True):
        if timed and before_timed is not None:
            before_timed()
        _sync(torch, dev)
        t0 = time.time()
        state, m = step(TrainState.create(lora, tx), base, local)
        _sync(torch, dev)
        ms = (time.time() - t0) * 1e3
    return float(m["loss"]), float(m["grad_norm"]), state.params, ms


def _tptrain_adamw(torch, cfg, base, lora, data, out_dir, dev, mesh_model=1):
    """TPTRAIN_STEPS micro-steps of apps/finetune_lora.train (AdamW,
    micro-batch TPTRAIN_MICRO, no accumulation, one validation batch) at
    this phase's depth: the micro-steps' losses and grad norms and the
    validation loss (None on a rank that does not log)."""
    from radialog_tpu_torch.apps import finetune_lora as ft
    cfg_full = ft.VICUNA_7B
    fcfg = ft.FinetuneConfig(synthetic=True, data_path=data, output_dir=out_dir,
                             batch_size=TPTRAIN_MICRO, micro_batch_size=TPTRAIN_MICRO,
                             num_epochs=1, max_steps=TPTRAIN_STEPS, cutoff_len=CUTOFF,
                             val_set_size=2, use_embs=True, quantize_base=True, flash=True,
                             mesh_model=mesh_model, device=torch.device(dev).type)
    steps, logs = [], []
    ft.VICUNA_7B = cfg        # the synthetic run's config, cut to this depth
    try:
        ft.train(fcfg, log_fn=logs.append, base=base, lora=lora,
                 on_step=lambda i, m: steps.append((float(m["loss"]), float(m["grad_norm"]))))
    finally:
        ft.VICUNA_7B = cfg_full
    val = [m["val_loss"] for m in logs if "val_loss" in m]
    return {"losses": [x for x, _ in steps], "grad_norms": [g for _, g in steps],
            "val_loss": val[0] if val else None}


def _tptrain_s1_setup(torch, dev):
    """Stage 1 at BERT-base widths: (cfg, params on ``dev``, the global
    batch in numpy) from the phase's seed, alike in every process."""
    import numpy as np
    from radialog_tpu_torch.models.blip2 import Blip2Config, blip2_init
    cfg = Blip2Config()
    params, _ = blip2_init(torch.Generator(device=dev).manual_seed(TPTRAIN_SEED), cfg, dev,
                           with_vision=False)
    rng = np.random.default_rng(TPTRAIN_SEED)
    b, t = TPTRAIN_S1_BATCH, TPTRAIN_S1_TXT
    ids = rng.integers(4, cfg.qformer.bert.vocab_size, (b, t)).astype(np.int32)
    ids[:, 0] = 101
    lens = rng.integers(t // 6, t + 1, (b,))
    mask = (np.arange(t)[None] < lens[:, None]).astype(np.int32)
    ids = np.where(mask > 0, ids, 0).astype(np.int32)
    embeds = rng.normal(size=(b, TPTRAIN_S1_PATCHES, cfg.qformer.encoder_width))
    return cfg, params, {"image_embeds": embeds.astype(np.float32), "text_ids": ids,
                         "text_mask": mask}


def _tptrain_s1_step(torch, cfg, params, batch, dev, negatives, mesh=None):
    """One FP32 SGD stage-1 step of the global batch, the hard negatives
    from ``negatives`` (a sample_negatives stand-in): (losses, new params,
    ms)."""
    from radialog_tpu_torch.core.mesh import DATA_AXIS, axis_group, shard_batch
    from radialog_tpu_torch.models import blip2 as tb
    from radialog_tpu_torch.train.optim import make_sgd
    from radialog_tpu_torch.train.steps import TrainState, make_stage1_train_step
    tx = make_sgd(TPTRAIN_S1_LR, momentum=0.0)
    step = make_stage1_train_step(tx, cfg, data_group=axis_group(mesh, DATA_AXIS))
    local = shard_batch(mesh, batch, dev)
    real, tb.sample_negatives = tb.sample_negatives, negatives
    try:
        _sync(torch, dev)
        t0 = time.time()
        state, m = step(TrainState.create(params, tx), local, None)
        _sync(torch, dev)
    finally:
        tb.sample_negatives = real
    return {k: float(v) for k, v in m.items()}, state.params, (time.time() - t0) * 1e3


def _tptrain_kept(torch):
    """_Kept stand-ins for K3 and K5a/K5b in their module: each keeps its
    first call under the current case, for the holds at the shard's
    shapes."""
    from radialog_tpu_torch.ops import flash_attention as tfa
    state = {"corr": None}
    first = lambda st, i, a: i == 0      # noqa: E731
    kept = {"flash_attention": _Kept(tfa.flash_attention_kernel, tfa.flash_attention_plain,
                                     state, first),
            "flash_attention_dq": _Kept(tfa.flash_attention_dq_delta_kernel,
                                        tfa.flash_attention_dq_delta_plain, state, first),
            "flash_attention_dkv": _Kept(tfa.flash_attention_dkv_kernel,
                                         tfa.flash_attention_dkv_plain, state, first)}
    tfa.flash_attention_kernel = kept["flash_attention"]
    tfa.flash_attention_dq_delta_kernel = kept["flash_attention_dq"]
    tfa.flash_attention_dkv_kernel = kept["flash_attention_dkv"]
    return kept, state


def _tptrain_holds(torch, kept):
    """Each kept call against its plain version on the same inputs: K3's
    out within K3_TOL, K5a's dq and K5b's dk and dv within K5_TOL of their
    own largest value (bf16); with the head count of the call."""
    held = []
    for name, k in kept.items():
        for corr, _, args, kw, got, _ in k.kept:
            ref = k.plain(*args, **kw)
            pairs = [(got[0], ref[0])] if name != "flash_attention_dkv" else list(zip(got, ref))
            errs = []
            for g, r in pairs:
                largest = float(r.float().abs().max())
                err = float((g.float() - r.float()).abs().max())
                ok = (bool(torch.allclose(g.float(), r.float(), **K3_TOL["bfloat16"]))
                      if name == "flash_attention" else err <= K5_TOL["bfloat16"] * largest)
                errs.append((err, largest, ok))
            held.append({"kernel": name, "case": corr, "heads": int(args[0].shape[2]),
                         "b": int(args[0].shape[0]), "t": int(args[0].shape[1]),
                         "max_abs_err": max(e for e, _, _ in errs),
                         "ref_max": max(m for _, m, _ in errs), "ok": all(o for _, _, o in errs)})
        k.kept.clear()
    return held


def _crc(torch, tree, prefix=""):
    """{leaf path: crc32 of its bytes} of a tree of dicts and lists."""
    import zlib
    items = tree.items() if isinstance(tree, dict) else \
        enumerate(tree) if isinstance(tree, (list, tuple)) else None
    if items is not None:
        return {p: v for k, sub in items for p, v in _crc(torch, sub, f"{prefix}{k}/").items()}
    x = tree.detach().contiguous().cpu().reshape(-1)
    return {prefix.rstrip("/"): zlib.crc32(x.view(torch.uint8).numpy().tobytes())}


def _tptrain_rank(job_path: str) -> int:
    """One rank of the tptrain phase (``chip_smoke.py --tptrain-rank JOB``):
    joins the process group from the RADIALOG_* environment, builds the
    phase's weights, runs the job's cases and writes its numbers next to
    JOB; rank 0 also saves the gathered trees the parent compares."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from radialog_tpu_torch.core import mesh as tm
    from radialog_tpu_torch.ops.layers import set_precision
    from radialog_tpu_torch.parallel import collectives as tc
    from radialog_tpu_torch.parallel.partition import (gather_params, llama_partition_specs,
                                                       lora_partition_specs, shard_params)
    from radialog_tpu_torch.train.optim import tree_leaves, tree_map
    with open(job_path) as f:
        job = json.load(f)
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda",
                           int(os.environ["RADIALOG_PROCESS_ID"]) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    set_precision()
    t_start = time.time()
    tm.init_distributed(device=dev.type, backend=job["backend"], timeout=TP_TIMEOUT_S)
    rank = dist.get_rank()
    kept, state = _tptrain_kept(torch)
    # launches: K3 and K5b count on their stand-ins; K5a's delta-folding
    # kernel counts on flash_attention_dq_kernel, whose stand-in it is not
    from radialog_tpu_torch.ops import flash_attention as tfa
    counted = {"flash_attention": kept["flash_attention"],
               "flash_attention_dq": tfa.flash_attention_dq_kernel,
               "flash_attention_dkv": kept["flash_attention_dkv"]}
    cfg, base, lora = _tptrain_weights(torch, dev)
    batch = dict(np.load(job["batch"]))
    counters = (tc.copy_to_group, tc.reduce_from_group, tc.gather_last_dim, tc.gather_batch,
                tc.sum_over)
    out = {"rank": rank, "backend": job["backend"], "base_checksum": _checksum(torch, base),
           "init_s": time.time() - t_start, "cases": {}}
    while job.get("wait_for") and not os.path.exists(job["wait_for"]):
        if time.time() - t_start > TP_TIMEOUT_S:
            raise TimeoutError(f"{job['wait_for']} never came")
        time.sleep(0.2)
    for name, shape in job["cases"].items():
        if name == "stage1":
            continue
        mesh = tm.make_mesh(tm.MeshSpec(*shape), device=dev.type, timeout=TP_TIMEOUT_S)
        specs = lora_partition_specs(lora)
        lb = shard_params(mesh, base, llama_partition_specs(base))
        ll = shard_params(mesh, lora, specs)
        calls = {}

        def zero():
            state["corr"] = name
            _zero(counted)
            for k in kept.values():
                k.kept.clear()
            calls.update({f.__name__: f.calls for f in counters})
        loss, gnorm, new, ms = _tptrain_sgd(torch, cfg, lb, ll, batch, dev, mesh, zero)
        launches = _read(counted)
        issued = {f.__name__: f.calls - calls[f.__name__] for f in counters}
        holds = _tptrain_holds(torch, kept)
        gathered = gather_params(mesh, new, specs)
        if rank == 0:
            torch.save(tree_map(lambda x: x.cpu(), gathered), f"{job_path}.{name}.pt")
        # one activation sum of the model group and one gradient sum of the
        # data group, each the mean of 5 after a warm-up
        n_data, n_model = shape
        act = torch.ones((TPTRAIN_MICRO // n_data, CUTOFF, cfg.hidden_size),
                         dtype=torch.bfloat16, device=dev)
        grads = tree_leaves(new)
        timing = {}
        for what, fn in (("activation_sum_model", lambda: tc.reduce_from_group(
                act, tm.axis_group(mesh, tm.MODEL_AXIS))),
                         ("gradient_sum_data", lambda: tc.sum_over(
                             grads, tm.axis_group(mesh, tm.DATA_AXIS)))):
            fn()
            _sync(torch, dev)
            t0 = time.time()
            for _ in range(5):
                fn()
            _sync(torch, dev)
            timing[what] = (time.time() - t0) / 5 * 1e3
        del lb, ll, act, grads, gathered
        adamw = _tptrain_adamw(torch, cfg, base, lora, job["data"],
                               os.path.join(os.path.dirname(job_path), f"lora-{name}"), dev,
                               mesh_model=n_model)
        out["cases"][name] = {"mesh": shape, "loss": loss, "grad_norm": gnorm,
                              "ms_per_micro_step": ms, "launches": launches,
                              "collectives_per_micro_step": issued, "collective_ms": timing,
                              "holds": holds, "crc": _crc(torch, new), "adamw": adamw}
        gc.collect()
        torch.cuda.empty_cache()
    if "stage1" in job["cases"]:
        mesh = tm.make_mesh(tm.MeshSpec(*job["cases"]["stage1"]), device=dev.type,
                            timeout=TP_TIMEOUT_S)
        s1cfg, params, s1batch = _tptrain_s1_setup(torch, dev)
        drawn = np.load(job["negatives"])
        negs = tuple(torch.from_numpy(drawn[k]).to(dev) for k in ("neg_img", "neg_txt"))
        calls = {f.__name__: f.calls for f in counters}
        losses, new, ms = _tptrain_s1_step(torch, s1cfg, params, s1batch, dev,
                                           lambda w_t2i, w_i2t, gen: negs, mesh)
        if rank == 0:
            torch.save(tree_map(lambda x: x.cpu(), new), f"{job_path}.stage1.pt")
        out["cases"]["stage1"] = {"losses": losses, "ms_per_step": ms,
                                  "collectives_per_step": {f.__name__: f.calls - calls[f.__name__]
                                                           for f in counters},
                                  "crc": _crc(torch, new)}
    out["total_s"] = time.time() - t_start
    dist.destroy_process_group()
    with open(f"{job_path}.{rank}.json", "w") as f:
        json.dump(out, f)
    return 0


def _paths(tree, prefix=""):
    """[(leaf path, leaf)] of a tree of dicts and lists, in tree_leaves order."""
    items = tree.items() if isinstance(tree, dict) else \
        enumerate(tree) if isinstance(tree, (list, tuple)) else None
    if items is None:
        return [(prefix.rstrip("/"), tree)]
    return [pl for k, sub in items for pl in _paths(sub, f"{prefix}{k}/")]


def _update_cos(torch, got, want, start, skip=()):
    """{leaf path: (cosine of got - start with want - start, max |got -
    want| over max |want - start|)} over three trees, leaving out the paths
    that end with one of ``skip``; a leaf that the reference leaves unmoved
    (no gradient reaches it) must stay unmoved: (1, 0) if it does."""
    out = {}
    for (path, g), (_, w), (_, s0) in zip(_paths(got), _paths(want), _paths(start)):
        if path.endswith(tuple(skip)):
            continue
        dg, dw = (g.double().to(s0.device) - s0.double()), (w.double() - s0.double())
        if not bool(dw.any()):
            out[path] = (1.0, 0.0) if not bool(dg.any()) else (0.0, float("inf"))
            continue
        cos = float((dg * dw).sum() / (dg.norm() * dw.norm()).clamp_min(1e-300))
        out[path] = (cos, float((dg - dw).abs().max() / dw.abs().max()))
    return out


def phase_tptrain(torch, counted, dev="cuda"):
    """Training across ranks on the card (module docstring): the one-process
    reference here, then the gloo pair (TP = 2, DP = 2, stage 1 at DP = 2)
    and NCCL at world size 1; checks every case against the reference.
    Returns the launches of K3, K5a and K5b in the gloo ranks' timed TP and
    DP micro-steps on rank 0. ``dev="cpu"`` rehearses the phase's control
    at a tiny width with the kernels' plain versions (no launches)."""
    import numpy as np
    from radialog_tpu_torch.models import blip2 as tb
    from radialog_tpu_torch.train.optim import tree_leaves
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "tptrain")
    os.makedirs(root, exist_ok=True)
    for old in os.listdir(root):
        if old.endswith((".pt", ".json", ".npz", ".go", ".log")):
            os.remove(os.path.join(root, old))
    t_phase = time.time()
    cfg, base, lora = _tptrain_weights(torch, dev)
    records = _train_records(14, lambda j: 360 + 30 * (j % 12))
    data = os.path.join(root, "instruct.json")
    with open(data, "w") as f:
        json.dump(records, f)
    batch = _tptrain_batch(cfg, records)
    np.savez(os.path.join(root, "batch.npz"), **batch)
    fa = {k: counted[k] for k in ("flash_attention", "flash_attention_dq", "flash_attention_dkv")}

    # case 1: the one-process reference
    loss, gnorm, ref_new, ref_ms = _tptrain_sgd(torch, cfg, base, lora, batch, dev,
                                                before_timed=lambda: _zero(fa))
    ref_launches = _read(fa)
    ref_adamw = _tptrain_adamw(torch, cfg, base, lora, data, os.path.join(root, "lora-ref"), dev)
    s1cfg, s1params, s1batch = _tptrain_s1_setup(torch, dev)
    negs = _Negatives(tb.sample_negatives)
    s1_losses, s1_new, s1_ms = _tptrain_s1_step(torch, s1cfg, s1params, s1batch, dev, negs)
    np.savez(os.path.join(root, "negatives.npz"), neg_img=negs.drawn[0].numpy(),
             neg_txt=negs.drawn[1].numpy())
    with torch.no_grad():       # ITC of each half alone, its own in-batch negatives
        half = [float(tb.blip2_stage1_losses(
            s1params, s1cfg, *(torch.from_numpy(s1batch[k][sl]).to(dev) for k in
                               ("image_embeds", "text_ids", "text_mask")),
            torch.Generator(device=dev).manual_seed(0)).loss_itc)
            for sl in (slice(0, TPTRAIN_S1_BATCH // 2), slice(TPTRAIN_S1_BATCH // 2, None))]
    ref_s = time.time() - t_phase
    gc.collect()                # the ranks share the card: hand back the cached blocks
    if dev == "cuda":
        torch.cuda.empty_cache()

    # the gloo pair, then NCCL at world size 1 (started together; it waits)
    go = os.path.join(root, "gloo.go")
    gloo = _tp_start("tptrain_gloo", 2, "gloo", {"tp2": [1, 2], "dp2": [2, 1], "stage1": [2, 1]},
                     dev=dev, flag="--tptrain-rank", sub="tptrain",
                     batch=os.path.join(root, "batch.npz"), data=data,
                     negatives=os.path.join(root, "negatives.npz"))
    nccl = _tp_start("tptrain_nccl1", 1, "nccl" if dev == "cuda" else "gloo", {"nccl1": [1, 1]},
                     dev=dev, flag="--tptrain-rank", sub="tptrain",
                     batch=os.path.join(root, "batch.npz"), data=data, wait_for=go)
    try:
        ranks = _tp_wait(*gloo)
        open(go, "w").close()
        one = _tp_wait(*nccl)[0]
    finally:
        for _, procs in (gloo, nccl):
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
    ref_crc = _crc(torch, ref_new)
    tol = TPTRAIN_TOL
    cases, ok = {}, True
    for name, replicated in (("tp2", ("img_proj", "scale", "/a")), ("dp2", ("",))):
        r0 = ranks[0]["cases"][name]
        got = torch.load(f"{gloo[0]}.{name}.pt")
        ups = list(_update_cos(torch, got, ref_new, lora).values())
        loss_rel = abs(r0["loss"] - loss) / abs(loss)
        gnorm_rel = abs(r0["grad_norm"] - gnorm) / abs(gnorm)
        adamw_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["adamw"]["losses"],
                                                             ref_adamw["losses"]))
        same = [k for k in r0["crc"] if any(t in k for t in replicated)]
        bitwise = bool(same) and all(ranks[1]["cases"][name]["crc"][k] == r0["crc"][k]
                                     for k in same)
        holds = [h for r in ranks for h in r["cases"][name]["holds"]]
        heads = sorted({h["heads"] for h in holds})
        launched = all(r["cases"][name]["launches"][k] > 0 for r in ranks for k in fa)
        c_ok = (loss_rel <= tol["loss_rel"] and gnorm_rel <= tol["grad_norm_rel"]
                and min(c for c, _ in ups) >= tol["cos"]
                and max(e for _, e in ups) <= tol["update_rel"]
                and adamw_rel <= tol["adamw_loss_rel"]
                and bitwise and launched and bool(holds) and all(h["ok"] for h in holds)
                and (name != "tp2" or heads == [cfg.num_heads // 2]))
        ok = ok and c_ok
        cases[name] = {
            "mesh": r0["mesh"], "loss": r0["loss"], "loss_rel_err": loss_rel,
            "loss_bound": tol["loss_rel"], "grad_norm": r0["grad_norm"],
            "grad_norm_rel_err": gnorm_rel, "grad_norm_bound": tol["grad_norm_rel"],
            "update_cos_min": min(c for c, _ in ups), "cos_bound": tol["cos"],
            "update_err_max_rel": max(e for _, e in ups), "update_err_bound": tol["update_rel"],
            "adamw_losses": r0["adamw"]["losses"], "adamw_loss_rel_err_max": adamw_rel,
            "adamw_loss_bound": tol["adamw_loss_rel"],
            "adamw_val_loss": r0["adamw"]["val_loss"],
            "replicated_bitwise_on_both_ranks": bitwise, "replicated_leaves": len(same),
            "ms_per_micro_step_rank0": r0["ms_per_micro_step"],
            "ms_per_micro_step_rank1": ranks[1]["cases"][name]["ms_per_micro_step"],
            "collectives_per_micro_step": r0["collectives_per_micro_step"],
            "collective_ms": r0["collective_ms"], "launches_rank0": r0["launches"],
            "holds": len(holds), "held_heads": heads,
            "holds_worst": {k: max((h["max_abs_err"] / h["ref_max"] for h in holds
                                    if h["kernel"] == k), default=None) for k in fa},
            "ok": c_ok}
    # NCCL at world size 1: the reference's bits
    n1 = one["cases"]["nccl1"]
    got = torch.load(f"{nccl[0]}.nccl1.pt")
    cases["nccl1"] = {
        "loss_equal": n1["loss"] == loss, "grad_norm_equal": n1["grad_norm"] == gnorm,
        "lora_bitwise": all(torch.equal(a, b.cpu()) for a, b in
                            zip(tree_leaves(got), tree_leaves(ref_new))),
        "crc_equal": n1["crc"] == ref_crc,
        "adamw_losses_equal": n1["adamw"]["losses"] == ref_adamw["losses"],
        "adamw_val_equal": n1["adamw"]["val_loss"] == ref_adamw["val_loss"],
        "ms_per_micro_step": n1["ms_per_micro_step"],
        "collectives_per_micro_step": n1["collectives_per_micro_step"],
        "collective_ms": n1["collective_ms"], "launches": n1["launches"]}
    ok = ok and all(v for k, v in cases["nccl1"].items() if k.endswith(("_equal", "_bitwise")))
    # stage 1 at DP = 2
    s1 = ranks[0]["cases"]["stage1"]
    got = torch.load(f"{gloo[0]}.stage1.pt")
    # the attention key biases' gradient is 0 in exact arithmetic (a softmax
    # ignores a shift of every score): both runs step on rounding noise
    ups = _update_cos(torch, got, s1_new, s1params, skip=("k/b",))
    worst = min(ups, key=lambda k: ups[k][0])
    ups = list(ups.values())
    s1_rel = {k: abs(s1["losses"][k] - v) / abs(v) for k, v in s1_losses.items()}
    s1_bitwise = s1["crc"] == ranks[1]["cases"]["stage1"]["crc"]
    s1_ok = (max(s1_rel.values()) <= tol["s1_loss_rel"]
             and min(c for c, _ in ups) >= tol["s1_cos"]
             and max(e for _, e in ups) <= tol["s1_update_rel"] and s1_bitwise
             and all(abs(h - s1_losses["loss_itc"]) > 1e-2 for h in half))
    ok = ok and s1_ok
    cases["stage1_dp2"] = {"losses": s1["losses"], "losses_one_process": s1_losses,
                           "loss_rel_err": s1_rel, "loss_bound": tol["s1_loss_rel"],
                           "update_cos_min": min(c for c, _ in ups), "cos_bound": tol["s1_cos"],
                           "update_cos_min_leaf": worst,
                           "update_err_max_rel": max(e for _, e in ups),
                           "update_err_bound": tol["s1_update_rel"],
                           "leaves_held": len(ups), "key_biases_left_out": True,
                           "params_bitwise_on_both_ranks": s1_bitwise,
                           "half_batch_itc": half, "ms_per_step_rank0": s1["ms_per_step"],
                           "ms_per_step_one_process": s1_ms,
                           "collectives_per_step": s1["collectives_per_step"], "ok": s1_ok}
    checksums = {r["base_checksum"] == _checksum(torch, base) for r in ranks + [one]}
    ok = ok and checksums == {True}
    emit("tptrain", card=smi(), layers=TPTRAIN_LAYERS, micro_batch=TPTRAIN_MICRO,
         cutoff=CUTOFF, reference={"loss": loss, "grad_norm": gnorm,
                                   "ms_per_micro_step": ref_ms, "launches": ref_launches,
                                   "adamw": ref_adamw, "stage1": s1_losses},
         cases=cases, base_checksums_equal=checksums == {True}, reference_s=ref_s,
         rank_init_s=ranks[0]["init_s"], rank_total_s=ranks[0]["total_s"],
         nccl1_total_s=one["total_s"], phase_s=time.time() - t_phase,
         note="two ranks sharing one card over gloo: every activation sum goes through the "
              "host; ms are no measure of multi-card speed", ok=ok)
    del ref_new, s1_new, s1params
    if not ok:
        raise AssertionError("the tptrain phase failed a check")
    return {k: sum(ranks[0]["cases"][c]["launches"][k] for c in ("tp2", "dp2")) for k in fa}


# the ckpt phase: Vicuna-7B v1.3's published shapes (32,000 embedding rows, one
# short of the port's vocab 32,001 with <IMG> = 32,000), the adapter's rank
# and alpha, the beam run, the trainer's steps; bytes of free disk it needs
CKPT_VOCAB, CKPT_LORA_R, CKPT_LORA_ALPHA = 32000, 8, 16
CKPT_BEAMS, CKPT_BEAM_PROMPTS, CKPT_BEAM_NEW, CKPT_TRAIN_STEPS = 4, 2, 32, 2
CKPT_FREE_BYTES = 16 * 1024 ** 3


def _spec_lin(name, o, i, bias=True):
    return [(f"{name}.weight", (o, i), "w")] + ([(f"{name}.bias", (o,), "bias")] if bias else [])


def _spec_ln(name, c):
    return [(f"{name}.weight", (c,), "norm"), (f"{name}.bias", (c,), "bias")]


def _spec_bn(name, c):
    return _spec_ln(name, c) + [(f"{name}.running_mean", (c,), "mean"),
                                (f"{name}.running_var", (c,), "var"),
                                (f"{name}.num_batches_tracked", (), "count")]


def _spec_conv(name, o, i, k, bias=False):
    return [(f"{name}.weight", (o, i, k, k), "conv")] + ([(f"{name}.bias", (o,), "bias")]
                                                         if bias else [])


def _spec_biovil(p, j):
    """BioViL-T ImageModel keys (ResNet-50 trunk, 3-block ViT pooler of width
    256, projector to ``j``) under prefix ``p``."""
    s = _spec_conv(p + "encoder.encoder.conv1", 64, 3, 7) + _spec_bn(p + "encoder.encoder.bn1", 64)
    cin = 64
    for stage, (w, blocks) in enumerate([(64, 3), (128, 4), (256, 6), (512, 3)], start=1):
        for b in range(blocks):
            q = f"{p}encoder.encoder.layer{stage}.{b}"
            c = cin if b == 0 else 4 * w
            s += (_spec_conv(q + ".conv1", w, c, 1) + _spec_bn(q + ".bn1", w)
                  + _spec_conv(q + ".conv2", w, w, 3) + _spec_bn(q + ".bn2", w)
                  + _spec_conv(q + ".conv3", 4 * w, w, 1) + _spec_bn(q + ".bn3", 4 * w))
            if b == 0:
                s += _spec_conv(q + ".downsample.0", 4 * w, c, 1) + _spec_bn(q + ".downsample.1", 4 * w)
        cin = 4 * w
    s += _spec_conv(p + "encoder.backbone_to_vit", 256, 2048, 1)
    s += [(p + "encoder.missing_previous_emb", (1, 256, 1, 1), "emb")]
    for i in range(3):
        q = f"{p}encoder.vit_pooler.blocks.{i}"
        s += _spec_ln(q + ".norm1", 256) + _spec_ln(q + ".norm2", 256)
        for n in ("proj_q", "proj_k", "proj_v"):
            s += _spec_lin(f"{q}.attn.{n}", 256, 256, bias=False)
        s += (_spec_lin(q + ".attn.proj", 256, 256) + _spec_lin(q + ".mlp.fc1", 256, 256)
              + _spec_lin(q + ".mlp.fc2", 256, 256))
    s += _spec_ln(p + "encoder.vit_pooler.norm_post", 256)
    s += [(p + "encoder.vit_pooler.type_embed", (2, 1, 256), "emb")]
    return (s + _spec_conv(p + "projector.model.0", j, 512, 1) + _spec_bn(p + "projector.model.1", j)
            + _spec_conv(p + "projector.model.3", j, j, 1, bias=True))


def _spec_bert_layer(q, h, inter):
    s = []
    for n in ("query", "key", "value"):
        s += _spec_lin(f"{q}.attention.self.{n}", h, h)
    return (s + _spec_lin(q + ".attention.output.dense", h, h)
            + _spec_ln(q + ".attention.output.LayerNorm", h)
            + _spec_lin(q + ".intermediate.dense", inter, h) + _spec_lin(q + ".output.dense", h, inter)
            + _spec_ln(q + ".output.LayerNorm", h))


def _spec_blip2(qcfg):
    """The LAVIS Blip2Qformer stage-1 ``model`` keys at the Q-Former's
    widths (BERT-base, cross-attention every second layer onto
    ``encoder_width``), with BioViL-T under ``visual_encoder.``."""
    b, h, enc = qcfg.bert, qcfg.bert.hidden_size, qcfg.encoder_width
    p = "Qformer.bert."
    s = [("query_tokens", (1, qcfg.num_query_tokens, h), "emb"),
         (p + "embeddings.word_embeddings.weight", (b.vocab_size, h), "emb"),
         (p + "embeddings.position_embeddings.weight", (b.max_position, h), "emb")]
    s += _spec_ln(p + "embeddings.LayerNorm", h)
    for i in range(b.num_layers):
        q = f"{p}encoder.layer.{i}"
        s += _spec_bert_layer(q, h, b.intermediate_size)
        s += (_spec_lin(q + ".intermediate_query.dense", b.intermediate_size, h)
              + _spec_lin(q + ".output_query.dense", h, b.intermediate_size)
              + _spec_ln(q + ".output_query.LayerNorm", h))
        if i % qcfg.cross_attention_freq == 0:
            s += (_spec_lin(q + ".crossattention.self.query", h, h)
                  + _spec_lin(q + ".crossattention.self.key", h, enc)
                  + _spec_lin(q + ".crossattention.self.value", h, enc)
                  + _spec_lin(q + ".crossattention.output.dense", h, h)
                  + _spec_ln(q + ".crossattention.output.LayerNorm", h))
    s += (_spec_lin("Qformer.cls.predictions.transform.dense", h, h)
          + _spec_ln("Qformer.cls.predictions.transform.LayerNorm", h)
          + [("Qformer.cls.predictions.bias", (b.vocab_size,), "bias")])
    s += (_spec_ln("ln_vision", enc) + _spec_lin("vision_proj", 256, h)
          + _spec_lin("text_proj", 256, h) + _spec_lin("itm_head", 2, h) + [("temp", (), "temp")])
    return s + _spec_biovil("visual_encoder.", enc)


def _spec_chexbert(bcfg):
    """CheXbert's bert_labeler keys under DataParallel's ``module.``."""
    h, p = bcfg.hidden_size, "module.bert."
    s = [(p + "embeddings.word_embeddings.weight", (bcfg.vocab_size, h), "emb"),
         (p + "embeddings.position_embeddings.weight", (bcfg.max_position, h), "emb"),
         (p + "embeddings.token_type_embeddings.weight", (bcfg.type_vocab_size, h), "emb")]
    s += _spec_ln(p + "embeddings.LayerNorm", h)
    for i in range(bcfg.num_layers):
        s += _spec_bert_layer(f"{p}encoder.layer.{i}", h, bcfg.intermediate_size)
    s += _spec_lin(p + "pooler.dense", h, h)
    for i in range(14):
        s += _spec_lin(f"module.linear_heads.{i}", 2 if i == 13 else 4, h)
    return s


def _spec_classifier():
    return (_spec_biovil("model.biovil_encoder.", 128) + _spec_lin("model.fc1", 512, 2048)
            + _spec_lin("model.fc2", 14, 512))


def _spec_vicuna_layer(i, h=4096, inter=11008):
    p = f"model.layers.{i}."
    s = [(p + f"self_attn.{n}_proj.weight", (h, h), "w") for n in ("q", "k", "v", "o")]
    return s + [(p + "mlp.gate_proj.weight", (inter, h), "w"),
                (p + "mlp.up_proj.weight", (inter, h), "w"),
                (p + "mlp.down_proj.weight", (h, inter), "w"),
                (p + "input_layernorm.weight", (h,), "norm"),
                (p + "post_attention_layernorm.weight", (h,), "norm")]


def _spec_vicuna_shards(layers=32, h=4096):
    """The two shards of HF's Vicuna-7B v1.3 layout: the embedding and the
    first half of the layers, then the rest, the final norm and lm_head."""
    half = layers // 2
    first = [("model.embed_tokens.weight", (CKPT_VOCAB, h), "emb")]
    for i in range(half):
        first += _spec_vicuna_layer(i)
    second = []
    for i in range(half, layers):
        second += _spec_vicuna_layer(i)
    second += [("model.norm.weight", (h,), "norm"), ("lm_head.weight", (CKPT_VOCAB, h), "w")]
    return [first, second]


def _spec_adapter(layers=32, h=4096, qformer_dim=768):
    s = []
    for i in range(layers):
        for t in ("q", "v"):
            q = f"base_model.model.model.layers.{i}.self_attn.{t}_proj"
            s += [(q + ".lora_A.weight", (CKPT_LORA_R, h), "w"), (q + ".lora_B.weight", (h, CKPT_LORA_R), "emb")]
    return s + _spec_lin("base_model.model.model.img_proj_layer", h, qformer_dim)


def _draw(torch, key, shape, kind, dtype):
    """One checkpoint tensor, from a generator seeded by its key on the card
    (the same tensor every time it is drawn): linear weights with std
    fan_in ** -0.5 (as llama_init), convolutions sqrt(2 / fan_in), norms and
    batch-norm scales 1 + N(0, 0.05), embeddings N(0, 0.02), biases and
    running means N(0, 0.02), running variances 1 + |N(0, 0.05)|."""
    import zlib
    if kind == "count":
        return torch.tensor(0)
    if kind == "temp":
        return torch.tensor(0.07, dtype=dtype)
    g = torch.Generator(device="cuda").manual_seed(zlib.crc32(key.encode()))
    x = torch.randn(shape, generator=g, device="cuda", dtype=torch.float32)
    fan_in = 1
    for d in shape[1:]:
        fan_in *= d
    x = {"w": lambda: x * fan_in ** -0.5, "conv": lambda: x * (2.0 / fan_in) ** 0.5,
         "norm": lambda: 1 + 0.05 * x, "emb": lambda: 0.02 * x, "bias": lambda: 0.02 * x,
         "mean": lambda: 0.02 * x, "var": lambda: 1 + 0.05 * x.abs()}[kind]()
    return x.to(dtype).cpu()


def _fill(torch, spec, dtype):
    return {k: _draw(torch, k, shape, kind, dtype) for k, shape, kind in spec}


def _rss_peak_gb() -> float:
    """The process's peak resident set size so far (the ckpt phase runs in a
    process of its own, so it is the phase's up to the call)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024 / 1e9
    except OSError:
        pass
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def _write_ckpt(torch, root):
    """Every checkpoint of the phase under ``root``, in the formats the
    reference reads. Returns ({name: path}, {name: bytes}, seconds, the
    small state dicts kept for the checks)."""
    import csv
    import numpy as np
    from pathlib import Path
    from radialog_tpu_torch.models.bert import BertConfig
    from radialog_tpu_torch.models.qformer import QFormerConfig
    t0 = time.time()
    vic = Path(root) / "vicuna"
    vic.mkdir()
    shards = _spec_vicuna_shards()
    weight_map, total = {}, 0
    for j, spec in enumerate(shards):
        name = f"pytorch_model-{j + 1:05d}-of-{len(shards):05d}.bin"
        sd = _fill(torch, spec, torch.float16)
        total += sum(t.numel() * t.element_size() for t in sd.values())
        torch.save(sd, vic / name)
        weight_map.update(dict.fromkeys(sd, name))
        del sd
    (vic / "pytorch_model.bin.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    ad = Path(root) / "adapter"
    ad.mkdir()
    adapter = _fill(torch, _spec_adapter(), torch.float32)
    torch.save(adapter, ad / "adapter_model.bin")
    (ad / "adapter_config.json").write_text(json.dumps(
        {"r": CKPT_LORA_R, "lora_alpha": CKPT_LORA_ALPHA, "lora_dropout": 0.05,
         "target_modules": ["q_proj", "v_proj"], "task_type": "CAUSAL_LM"}))
    small = {"blip2": _fill(torch, _spec_blip2(QFormerConfig()), torch.float32),
             "classifier": _fill(torch, _spec_classifier(), torch.float32),
             "chexbert": _fill(torch, _spec_chexbert(BertConfig()), torch.float32)}
    paths = {"vicuna": vic, "adapter": ad / "adapter_model.bin",
             "blip2": Path(root) / "blip2_stage1.pth", "classifier": Path(root) / "classifier.ckpt",
             "chexbert": Path(root) / "chexbert.pth", "emb_cache": Path(root) / "emb_cache.npz"}
    # a LAVIS .pth and a Lightning .ckpt hold entries that are no tensors
    torch.save({"model": small["blip2"], "config": {"arch": "blip2_qformer"}, "epoch": 9},
               paths["blip2"])
    torch.save({"state_dict": small["classifier"], "hyper_parameters": {"lr": 1e-4},
                "epoch": 20, "pytorch-lightning_version": "1.9.0"}, paths["classifier"])
    torch.save({"model_state_dict": small["chexbert"], "epoch": 7}, paths["chexbert"])
    with open("tests/fixtures/split.csv") as f:
        dicoms = [r["dicom_id"] for r in csv.DictReader(f) if r["split"] == "test"]
    rng = np.random.default_rng(11)
    np.savez(paths["emb_cache"], **{d: rng.normal(size=(32, 768)).astype(np.float32)
                                    for d in dicoms})
    sizes = {k: sum(f.stat().st_size for f in (p.iterdir() if p.is_dir() else [p]))
             for k, p in paths.items()}
    small["adapter"] = adapter
    return paths, sizes, time.time() - t0, small


def _vicuna_layer(torch, i):
    """Layer i's nine tensors of the written checkpoint, drawn again."""
    return {k.split(f"layers.{i}.")[1]: _draw(torch, k, shape, kind, torch.float16)
            for k, shape, kind in _spec_vicuna_layer(i)}


def _leaves_equal(torch, got, want) -> bool:
    """Whether two trees have the same structure and every leaf is bitwise
    equal (``got`` on any device, ``want`` on the CPU)."""
    if isinstance(want, dict):
        return (isinstance(got, dict) and got.keys() == want.keys()
                and all(_leaves_equal(torch, got[k], want[k]) for k in want))
    if isinstance(want, (list, tuple)):
        return (len(got) == len(want)
                and all(_leaves_equal(torch, a, b) for a, b in zip(got, want)))
    return got.dtype == want.dtype and torch.equal(got.cpu(), want)


def _ckpt_w8a8(torch, pipeline_mod, paths, small, counted):
    """The W8A8 pipeline from the files, its leaves against the same state
    dicts converted and packed in memory, the report batch and a beam run."""
    import numpy as np
    from radialog_tpu_torch.ops.q8_matmul import pack_q8
    from radialog_tpu_torch.utils import hf_weights as hfw
    from radialog_tpu_torch.apps.pipeline import move_tree
    from radialog_tpu_torch.decode import engine as te
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.time()
    cfg = pipeline_mod.PipelineConfig(
        vicuna_path=str(paths["vicuna"]), lora_path=str(paths["adapter"]),
        blip2_checkpoint=str(paths["blip2"]), classifier_checkpoint=str(paths["classifier"]),
        chexbert_checkpoint=str(paths["chexbert"]), emb_cache=str(paths["emb_cache"]),
        quantize=True, seed=0)
    pipe = pipeline_mod.RaDialogPipeline(cfg)
    torch.cuda.synchronize()
    load = {"seconds": time.time() - t0, "llama_stages": dict(pipe.load_seconds),
            "peak_host_rss_gb": _rss_peak_gb(),
            "device_gb": (torch.cuda.memory_allocated() - mem0) / 1e9}

    def packed_eq(got, w):
        want = pack_q8(w)
        return torch.equal(got.w.cpu(), want.w) and torch.equal(got.scale.cpu(), want.scale)
    held = {}
    for i in (0, 31):
        sd = _vicuna_layer(torch, i)
        t = {k: v.float().T.numpy() for k, v in sd.items() if v.ndim == 2}
        lp = pipe.llama["layers"][i]
        held[f"layer{i}"] = (
            packed_eq(lp["wqkv"], np.concatenate([t["self_attn.q_proj.weight"],
                                                  t["self_attn.k_proj.weight"],
                                                  t["self_attn.v_proj.weight"]], -1))
            and packed_eq(lp["gateup"], np.concatenate([t["mlp.gate_proj.weight"],
                                                        t["mlp.up_proj.weight"]], -1))
            and packed_eq(lp["wo"], t["self_attn.o_proj.weight"])
            and packed_eq(lp["down"], t["mlp.down_proj.weight"])
            and torch.equal(lp["input_ln"].cpu(), sd["input_layernorm.weight"].float())
            and torch.equal(lp["post_ln"].cpu(), sd["post_attention_layernorm.weight"].float()))
    spec = {k: (shape, kind) for k, shape, kind in _spec_vicuna_shards()[1]}
    head = _draw(torch, "lm_head.weight", *spec["lm_head.weight"], torch.float16)
    held["lm_head"] = packed_eq(pipe.llama["lm_head"], head.float().T.numpy())
    emb = _draw(torch, "model.embed_tokens.weight", (CKPT_VOCAB, 4096), "emb", torch.float16)
    held["embed"] = torch.equal(pipe.llama["embed"].cpu(), emb.to(torch.bfloat16))
    held["embed_rows"] = pipe.llama["embed"].shape[0] == CKPT_VOCAB < pipe.llama_cfg.vocab_size
    want_lora = move_tree(hfw.convert_peft_lora(small["adapter"], 32, adapter_config={
        "r": CKPT_LORA_R, "lora_alpha": CKPT_LORA_ALPHA}), "cpu", torch.bfloat16)
    held["lora_and_img_proj"] = _leaves_equal(torch, pipe.lora, want_lora)
    bp, bs = hfw.convert_blip2(small["blip2"])
    held["blip2"] = _leaves_equal(torch, pipe.blip2, move_tree(bp, "cpu", torch.float32))
    held["biovil_t"] = (_leaves_equal(torch, pipe.visual, move_tree(bp["visual"], "cpu", torch.float32))
                        and _leaves_equal(torch, pipe.visual_state,
                                          move_tree(bs["visual"], "cpu", torch.float32)))
    cp, cs = hfw.convert_chexpert_classifier(small["classifier"])
    held["classifier"] = (_leaves_equal(torch, pipe.classifier, move_tree(cp, "cpu", torch.float32))
                          and _leaves_equal(torch, pipe.classifier_state,
                                            move_tree(cs, "cpu", torch.float32)))
    held["chexbert"] = _leaves_equal(torch, pipe.chexbert, move_tree(
        hfw.convert_chexbert(small["chexbert"]), "cpu", torch.float32))
    del head, emb
    # the report batch of the slice phase, on the loaded weights
    prompts, ids, report_step = _report_batch(torch, pipe)
    _zero(counted)
    torch.cuda.synchronize()
    t0 = time.time()
    findings, embs, res = report_step(CKPT_NEW)
    tokens = res.tokens.cpu()
    dt = time.time() - t0
    report_launches = _read(counted)
    two = [ids[0], ids[1]]
    toks, lens = pipeline_mod.pad_batch_right(two, 0)
    with torch.no_grad():
        _, first = te.prefill(pipe.llama, pipe.llama_cfg, torch.as_tensor(toks, device="cuda"),
                              torch.as_tensor(lens, device="cuda"), toks.shape[1] + 8,
                              img_embs=embs[:2], lora=pipe.lora, policy=pipe.policy)
        _, no_img = te.prefill(pipe.llama, pipe.llama_cfg, torch.as_tensor(toks, device="cuda"),
                               torch.as_tensor(lens, device="cuda"), toks.shape[1] + 8,
                               lora=pipe.lora, policy=pipe.policy)
    report = {"reports_per_s": BATCH / dt, "seconds": dt, "new_tokens": CKPT_NEW,
              "launches": report_launches,
              "logits_finite": bool(torch.isfinite(first).all()),
              # JAX's jnp.take fills the <IMG> row past the 32,000-row table with NaN
              "logits_without_image_nan": bool(torch.isnan(no_img).all()),
              "embs_finite": bool(torch.isfinite(embs).all()),
              "distinct_tokens": int(tokens.unique().numel())}
    ok_report = (tokens.shape == (BATCH, CKPT_NEW) and int(tokens.max()) < CKPT_VOCAB
                 and report["logits_finite"] and report["embs_finite"]
                 and report["logits_without_image_nan"] and len(findings) == BATCH
                 and report_launches["q8_matmul"] > 0 and report_launches["flash_decode_int8"] > 0)
    # beam search on the bf16 cache: K1 in every step, never K2
    _zero(counted)
    t0 = time.time()
    beams = pipe.generate_texts(prompts[:CKPT_BEAM_PROMPTS], img_embs=embs[:CKPT_BEAM_PROMPTS],
                                max_new_tokens=CKPT_BEAM_NEW, num_beams=CKPT_BEAMS)
    torch.cuda.synchronize()
    beam = {"seconds": time.time() - t0, "launches": _read(counted), "beams": CKPT_BEAMS,
            "prompts": CKPT_BEAM_PROMPTS, "new_tokens": CKPT_BEAM_NEW,
            "generated_words": [len(b.split()) - len(p.split()) for b, p in zip(beams, prompts)]}
    ok_beam = (len(beams) == CKPT_BEAM_PROMPTS and all(b.startswith(p) for b, p in zip(beams, prompts))
               and beam["launches"]["q8_matmul"] > 0 and beam["launches"]["flash_decode_int8"] == 0)
    launches = {k: report_launches[k] + beam["launches"][k] for k in report_launches}
    ok = all(held.values()) and ok_report and ok_beam
    emit("ckpt", part="w8a8", load=load, held_bitwise=held, report=report, beam=beam, ok=ok)
    return pipe, launches, load, ok


def _ckpt_bf16(torch, pipeline_mod, paths):
    """The float pipeline (quantize=False) from the same files: its load and
    layers 0 and 31 against the checkpoint's fp16 tensors cast to bf16."""
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.time()
    pipe = pipeline_mod.RaDialogPipeline(pipeline_mod.PipelineConfig(
        vicuna_path=str(paths["vicuna"]), lora_path=str(paths["adapter"]), quantize=False,
        seed=0))
    torch.cuda.synchronize()
    load = {"seconds": time.time() - t0, "llama_stages": dict(pipe.load_seconds),
            "peak_host_rss_gb": _rss_peak_gb(),
            "device_gb": (torch.cuda.memory_allocated() - mem0) / 1e9}
    names = {"wq": "self_attn.q_proj.weight", "wk": "self_attn.k_proj.weight",
             "wv": "self_attn.v_proj.weight", "wo": "self_attn.o_proj.weight",
             "gate": "mlp.gate_proj.weight", "up": "mlp.up_proj.weight",
             "down": "mlp.down_proj.weight"}
    held = {}
    for i in (0, 31):
        sd = _vicuna_layer(torch, i)
        lp = pipe.llama["layers"]
        held[f"layer{i}"] = (
            all(torch.equal(lp[n]["w"][i].cpu(), sd[k].T.to(torch.bfloat16)) for n, k in names.items())
            and torch.equal(lp["input_ln"][i].cpu(), sd["input_layernorm.weight"].to(torch.bfloat16))
            and torch.equal(lp["post_ln"][i].cpu(),
                            sd["post_attention_layernorm.weight"].to(torch.bfloat16)))
    ok = all(held.values()) and isinstance(pipe.llama["layers"], dict)
    emit("ckpt", part="bf16", load=load, held_bitwise=held, ok=ok)
    del pipe
    return load, ok


def _ckpt_eval(torch, paths, counted):
    """apps/evaluate.py main with the checkpoint flags, beams, the correction
    and binary-QA passes over one fixture study (the float pipeline)."""
    import shutil
    from pathlib import Path
    from radialog_tpu_torch.apps import evaluate as ev
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = Path("build/chip_eval_ckpt")
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--vicuna_path", str(paths["vicuna"]), "--lora_model", str(paths["adapter"]),
            "--blip2_checkpoint", str(paths["blip2"]), "--chexbert_checkpoint", str(paths["chexbert"]),
            "--emb_cache", str(paths["emb_cache"]), "--use_embs", "--num_beams", str(CKPT_BEAMS),
            "--do_corr", "--do_cp_bin_qa", "--fixture-dir", "tests/fixtures", "--truncate", "1",
            "--max_new_tokens", str(EVAL_NEW), "--output_dir", str(out_dir)]
    made, calls, state = [], [], {"corr": None}
    _zero(counted)
    t0 = time.time()
    with _eval_pipelines(ev, _timed_pipelines(torch, made, calls, state, lambda new, n: None)):
        results = ev.main(argv)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = _read(counted)
    pipe = made[0]
    files_ok, files = _eval_outputs(out_dir, results, 1)
    gens = [c for c in calls if "new" in c]
    per_pass = {"report_beams": sum(c["s"] for c in gens if c["new"] == EVAL_NEW),
                "correction": sum(c["s"] for c in gens if c["new"] == ev.CORRECTION_NEW),
                "binary_qa": sum(c["s"] for c in gens if c["new"] == 10),
                "labels": sum(c["s"] for c in calls if "labels" in c)}
    rows = [torch.from_numpy(v) for v in pipe.emb_cache.values()]
    cache_hit = bool(rows) and all(
        c["embs"] is not None and any(torch.equal(c["embs"][0].cpu(), r) for r in rows)
        for c in gens)
    ok = (files_ok and not pipe.cfg.quantize and launches["flash_attention"] > 0
          and launches["q8_matmul"] == 0 and launches["flash_decode_int8"] == 0 and cache_hit
          and len(gens) == 3)
    emit("ckpt", part="eval", argv=argv, seconds=seconds, load_seconds=dict(pipe.load_seconds),
         seconds_per_pass=per_pass, launches=launches, emb_cache_rows=len(pipe.emb_cache),
         metrics=results, ok=ok, **files)
    made.clear()
    calls.clear()
    return launches, ok


def _ckpt_train(torch, tfa, root, paths):
    """apps/finetune_lora.train from the Vicuna files and the adapter: the
    int8 base quantized on the card, flash attention, two micro-steps."""
    from pathlib import Path
    from radialog_tpu_torch.apps import finetune_lora as ft
    gc.collect()
    torch.cuda.empty_cache()
    counted = {"flash_attention": tfa.flash_attention_kernel,
               "flash_attention_dq": tfa.flash_attention_dq_kernel,
               "flash_attention_dkv": tfa.flash_attention_dkv_kernel}
    data = Path(root) / "instruct.json"
    data.write_text(json.dumps(_train_records(8, lambda j: 360 + 30 * j)))
    losses, t_steps = [], []
    cfg = ft.FinetuneConfig(base_model=str(paths["vicuna"]), lora_weights=str(paths["adapter"]),
                            quantize_base=True, flash=True, micro_batch_size=MICRO,
                            batch_size=MICRO * ACCUM, cutoff_len=CUTOFF,
                            max_steps=CKPT_TRAIN_STEPS, data_path=str(data), val_set_size=2,
                            use_embs=True, output_dir=str(Path(root) / "lora-out"))
    _zero(counted)
    t0 = time.time()

    def on_step(step, metrics):
        torch.cuda.synchronize()
        t_steps.append(time.time())
        losses.append(float(metrics["loss"]))

    state = ft.train(cfg, log_fn=lambda m: None, on_step=on_step)
    torch.cuda.synchronize()
    launches = _read(counted)
    load_s = t_steps[0] - t0 if t_steps else None
    ok = (len(losses) == CKPT_TRAIN_STEPS and all(x == x and abs(x) != float("inf") for x in losses)
          and all(v > 0 for v in launches.values()) and state.step == CKPT_TRAIN_STEPS)
    emit("ckpt", part="train", seconds=time.time() - t0,
         load_and_first_step_seconds=load_s, peak_host_rss_gb=_rss_peak_gb(),
         losses=losses, launches=launches, ok=ok)
    return launches, ok


def _ckpt_w4_pack(torch):
    """Seconds of pack_q4 (the host packer of --w4) for the o_proj of the
    written checkpoint's layer 0 (4096 x 4096), and the layer's and the 32
    layers' by its weights: the packer's cost grows with the weights (PR
    13-15 timed every projection of a layer: 0.153-0.170 s a million
    weights; one projection since PR 16, for the script's time)."""
    from radialog_tpu_torch.ops.q4_matmul import pack_q4
    sd = _vicuna_layer(torch, 0)
    w = sd["self_attn.o_proj.weight"].float().T.numpy()
    per_layer = sum(v.numel() for v in sd.values() if v.ndim == 2)
    t0 = time.time()
    pack_q4(w)
    wo = time.time() - t0
    layer = wo * per_layer / w.size
    emit("ckpt", part="w4_pack", seconds_wo=wo, seconds_per_layer_estimated=layer,
         seconds_32_layers_estimated=32 * layer, ok=True)
    return layer


def phase_ckpt(torch, pipeline_mod, tq8, tfd, tfa):
    """Vicuna-7B-sized checkpoints written to disk and loaded back through
    the port's loaders, with both tokenizer loaders replaced by the
    WhitespaceTokenizer at the Vicuna layout (no tokenizer files in the
    repository, and the card's machine may lack transformers). The
    directory is removed at the end, whatever happened; a failure still
    fails the run."""
    import shutil
    import tempfile
    from pathlib import Path
    from radialog_tpu_torch.apps import tokenization as tk
    from radialog_tpu_torch.models.bert import BertConfig
    Path("build").mkdir(exist_ok=True)
    free = shutil.disk_usage("build").free
    if free < CKPT_FREE_BYTES:
        raise AssertionError(f"the ckpt phase needs {CKPT_FREE_BYTES} bytes free under build/; "
                             f"{free} are")
    counted = {"q8_matmul": tq8.q8_matmul_int32, "flash_decode_int8": tfd.flash_decode_int8_kernel,
               "flash_attention": tfa.flash_attention_kernel}
    loaders = tk.load_vicuna_tokenizer, tk.load_bert_tokenizer
    tk.load_vicuna_tokenizer = lambda path, num_img_tokens=32: tk.WhitespaceTokenizer(
        vocab_size=32001, num_img_tokens=num_img_tokens, img_token_id=32000)
    tk.load_bert_tokenizer = lambda path=None: tk.WhitespaceTokenizer(
        vocab_size=BertConfig().vocab_size)
    root = Path(tempfile.mkdtemp(prefix="ckpt-", dir="build"))
    try:
        paths, sizes, write_s, small = _write_ckpt(torch, root)
        emit("ckpt", part="write", bytes=sizes, seconds=write_s, disk_free_before=free,
             tokenizers="load_vicuna_tokenizer and load_bert_tokenizer replaced by "
                        "WhitespaceTokenizer at the Vicuna layout (vocab 32001, <IMG> 32000)")
        pipe, launches, w8_load, ok8 = _ckpt_w8a8(torch, pipeline_mod, paths, small, counted)
        del pipe
        bf_load, okb = _ckpt_bf16(torch, pipeline_mod, paths)
        eval_launches, oke = _ckpt_eval(torch, paths, counted)
        train_launches, okt = _ckpt_train(torch, tfa, root, paths)
        w4_s = _ckpt_w4_pack(torch)
    finally:
        tk.load_vicuna_tokenizer, tk.load_bert_tokenizer = loaders
        shutil.rmtree(root, ignore_errors=True)
    if not (ok8 and okb and oke and okt):
        raise AssertionError("the ckpt phase failed a check")
    return {"q8_matmul": launches["q8_matmul"],
            "flash_decode_int8": launches["flash_decode_int8"],
            "flash_attention": eval_launches["flash_attention"], "train": train_launches,
            "load_seconds": {"w8a8": w8_load["seconds"], "bf16": bf_load["seconds"]},
            "w4_pack_seconds_per_layer": w4_s}


def _kernel_counters():
    """Every kernel wrapper with a launch counter, by the kernels line's names."""
    from radialog_tpu_torch.ops import flash_attention as tfa
    from radialog_tpu_torch.ops import flash_decode as tfd
    from radialog_tpu_torch.ops import q4_matmul as tq4
    from radialog_tpu_torch.ops import q8_matmul as tq8
    from radialog_tpu_torch.ops import w4_colscale as tw
    return {"q8_matmul": tq8.q8_matmul_int32,
            "flash_decode_int8": tfd.flash_decode_int8_kernel,
            "flash_decode_int8_current": tfd.flash_decode_int8_current_kernel,
            "flash_decode_int8_fused": tfd.flash_decode_int8_fused_kernel,
            "flash_attention": tfa.flash_attention_kernel,
            "flash_attention_dq": tfa.flash_attention_dq_kernel,
            "flash_attention_dkv": tfa.flash_attention_dkv_kernel,
            "q4_matmul": tq4.q4_matmul_acc, "w4_int32_split": tw.w4_int32_split,
            "w4_int32": tw.w4_int32}


# the warmup phase (after datatools, in their process): cold boot is a
# process's boot, so tools/bench_warmup_torch.py runs as a process of its
# own (``--warmup-tool``), twice at full width: cold, its --cache-dir an
# empty directory under build/ (removed after), and warm, the default
# build/kernels/ that the device phase built. Both cut in depth only.
# WARMUP_KERNELS: the kernels its path runs, K1 in every projection of the
# session (its prefill goes through the verify forward, its decode over the
# bf16 cache: neither reaches K2 or K3)
WARMUP_ARGV = ("--max-new", "32")
WARMUP_CUTS = "new tokens 300 -> 32 (the warm-up's reply and the first turn's)"
WARMUP_KEYS = {"weights_s", "warmup_s", "first_turn_s", "tokens", "cache_dir", "device"}
WARMUP_KERNELS = ("q8_matmul",)
WARMUP_TIMEOUT_S = 300


def warmup_tool(result: str, argv) -> int:
    """The tool's main in this process (``--warmup-tool RESULT ARGS``), its
    line on stdout; {launches by kernel, the kernels loaded, peak memory}
    into ``result``."""
    import torch
    from radialog_tpu_torch.ops import _build
    from tools import bench_warmup_torch
    counted = _kernel_counters()
    _zero(counted)
    bench_warmup_torch.main(list(argv))
    with open(result, "w") as f:
        json.dump({"launches": _read(counted), "loaded": sorted(_build._loaded),
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}, f)
    return 0


def _listing(path):
    """{file name: (size, mtime_ns)} of a directory ({} if it is missing)."""
    if not os.path.isdir(path):
        return {}
    return {e.name: (e.stat().st_size, e.stat().st_mtime_ns) for e in os.scandir(path)}


def _warmup_run(cache_dir=None):
    """One run of the tool in a process of its own (``cache_dir`` None: its
    default): (its printed lines, the counts it wrote, the process's
    seconds)."""
    root = os.path.dirname(os.path.abspath(__file__))
    result = os.path.join(root, "build", "phase_process", "warmup.json")
    os.makedirs(os.path.dirname(result), exist_ok=True)
    if os.path.exists(result):
        os.remove(result)
    argv = [*WARMUP_ARGV, *(["--cache-dir", cache_dir] if cache_dir else [])]
    t0 = time.time()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--warmup-tool", result,
                           *argv], capture_output=True, text=True, cwd=root,
                          env=dict(os.environ, PYTHONPATH=root), timeout=WARMUP_TIMEOUT_S)
    secs = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"bench_warmup_torch {argv} failed (rc {proc.returncode}):\n"
                             f"{proc.stderr[-3000:]}")
    with open(result) as f:
        counts = json.load(f)
    return [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")], counts, secs


def phase_warmup(torch):
    """Cold and warm boot through tools/bench_warmup_torch.py (module
    docstring). Returns {"cold": launches, "warm": launches}."""
    import shutil
    import tempfile
    from radialog_tpu_torch.ops import _build
    card = smi()
    free_gb = torch.cuda.mem_get_info()[0] / 1e9    # the card's, beside the other processes
    default = str(_build.DEFAULT_BUILD_DIR)
    os.makedirs("build", exist_ok=True)
    cold_dir = os.path.abspath(tempfile.mkdtemp(prefix="warmup-cold-", dir="build"))
    try:
        cold_before = _listing(cold_dir)
        cold = _warmup_run(cold_dir)
        cold_after = _listing(cold_dir)
    finally:
        shutil.rmtree(cold_dir, ignore_errors=True)
    warm_before = _listing(default)
    warm = _warmup_run()
    warm_after = _listing(default)
    out, ok = {}, True
    for run, (lines, counts, secs), dir_ok in (
            ("cold", cold, not cold_before and {n for n in cold_after if n.endswith(".so")}
             == {_build.library_path(k).name for k in cold[1]["loaded"]}),
            ("warm", warm, warm_before == warm_after and all(
                _build.library_path(k).name in warm_after for k in warm[1]["loaded"]))):
        line = lines[0] if len(lines) == 1 else {}
        run_ok = (set(line) == WARMUP_KEYS and _bench_numbers_ok(line)
                  and line["device"] == card and line["tokens"] == int(WARMUP_ARGV[1])
                  and dir_ok and bool(counts["loaded"])
                  and all(counts["launches"][k] > 0 for k in WARMUP_KERNELS))
        emit("warmup", run=run, argv=[*WARMUP_ARGV] + (["--cache-dir", cold_dir]
                                                     if run == "cold" else []),
             cuts=WARMUP_CUTS, line=line, process_s=secs, launches=counts["launches"],
             loaded=counts["loaded"], peak_gb=counts["peak_gb"],
             built=sorted(n for n in cold_after if n.endswith(".so")) if run == "cold" else [],
             build_dir_unchanged=warm_before == warm_after if run == "warm" else None,
             ok=run_ok)
        out[run] = counts["launches"]
        ok &= run_ok
    # recorded, not held: the cold boot's warm-up over the warm one's, nvcc's share
    emit("warmup", card=card, card_free_gb_before=free_gb,
         nvcc_share_s=cold[0][0]["warmup_s"] - warm[0][0]["warmup_s"] if ok else None, ok=ok)
    if not ok:
        raise AssertionError("the warmup phase failed a check")
    return out


# the ckpt phase, then datatools (on its own W8A8 pipeline, the slice's
# weights from the same seed), then warmup, run in a process of their own
# (``--phase-process ckpt,datatools,warmup``), started after bench and
# waited for before stage1: their disk writes, host reads and host loops
# overlap the parent's decode phases, whose host loops leave the card idle
# most of the time. The process holds up to ~16 GB of the card beside their
# peaks of up to ~47 GB (tptrain beside stage1 and trainers ran out of the
# card's 80 GB); warmup's tool processes, after the process freed its own,
# ~8 GB each, one at a time. Its lines follow the phases it ran beside. It
# is killed at CHILD_TIMEOUT_S from its start
CHILD_TIMEOUT_S = 900
CHILD_PHASES = ("ckpt", "datatools", "warmup")


def _child_start(names):
    """Start the process of the phases ``names``, run in that order;
    returns what _child_join takes."""
    name = ",".join(names)
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", "phase_process")
    os.makedirs(out_dir, exist_ok=True)
    result, out = (os.path.join(out_dir, f"{name}.{n}") for n in ("json", "log"))
    for old in (result, out):
        if os.path.exists(old):
            os.remove(old)
    log = open(out, "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--phase-process", name,
                             result, repr(_START)], stdout=log, cwd=root,
                            env=dict(os.environ, PYTHONPATH=root))
    return {"name": name, "proc": proc, "log": log, "result": result, "out": out,
            "t0": time.time()}


def _child_stop(run) -> None:
    proc = run["proc"]
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    run["log"].close()


def _child_join(run):
    """Wait for a phase's process (killed at CHILD_TIMEOUT_S from its
    start), print its lines and return its result; a failure raises (its
    stderr is this script's)."""
    proc = run["proc"]
    try:
        proc.wait(timeout=max(1.0, CHILD_TIMEOUT_S - (time.time() - run["t0"])))
    except subprocess.TimeoutExpired:
        pass
    _child_stop(run)
    with open(run["out"]) as f:
        for line in f:
            if line.startswith("{"):
                print(line.rstrip("\n"), flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"the {run['name']} phase's process failed (rc {proc.returncode})")
    with open(run["result"]) as f:
        return json.load(f)


def phase_process(names: str, result: str, start: str) -> int:
    """The phases ``names`` (comma-separated, of CHILD_PHASES), in the
    process _child_start starts: the kernels the parent built, the phases'
    lines on stdout on the parent's clock, {phase: its return value} into
    ``result``."""
    global _START
    _START = float(start)
    _watchdog()
    import torch
    from radialog_tpu_torch.apps import pipeline as pipeline_mod
    from radialog_tpu_torch.ops import _build
    from radialog_tpu_torch.ops import flash_attention as tfa
    from radialog_tpu_torch.ops import flash_decode as tfd
    from radialog_tpu_torch.ops import q8_matmul as tq8
    from radialog_tpu_torch.ops.layers import set_precision
    set_precision()
    torch.set_num_threads(4)        # the host's other cores run the parent's phases
    _build.build()
    out = {}
    for name in names.split(","):
        _begin(f"{name} (in its own process)")
        if name == "ckpt":
            out[name] = phase_ckpt(torch, pipeline_mod, tq8, tfd, tfa)
        elif name == "datatools":
            pipe = pipeline_mod.RaDialogPipeline(pipeline_mod.PipelineConfig(synthetic=True,
                                                                             seed=0))
            out[name] = phase_datatools(torch, {"pipe": pipe}, {
                "q8_matmul": tq8.q8_matmul_int32,
                "flash_decode_int8": tfd.flash_decode_int8_kernel,
                "flash_attention": tfa.flash_attention_kernel})
            del pipe
        elif name == "warmup":
            out[name] = phase_warmup(torch)
        else:
            raise ValueError(f"no phase {name} runs in a process of its own")
        gc.collect()
        torch.cuda.empty_cache()
    with open(result, "w") as f:
        json.dump(out, f)
    return 0


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is missing ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    try:
        from radialog_tpu_torch.apps import pipeline as pipeline_mod
        from radialog_tpu_torch.decode import engine as te
        from radialog_tpu_torch.ops import _build
        from radialog_tpu_torch.ops import flash_attention as tfa
        from radialog_tpu_torch.ops import flash_decode as tfd
        from radialog_tpu_torch.ops import q4_matmul as tq4
        from radialog_tpu_torch.ops import q8_matmul as tq8
        from radialog_tpu_torch.ops import w4_colscale as tw
        from radialog_tpu_torch.ops.layers import set_precision
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2

    card = smi()
    set_precision()
    _watchdog()
    _begin("device")
    t0 = time.time()
    reports = _build.build()
    regs = {n: [ln.strip() for ln in r.splitlines() if "registers" in ln or "spill" in ln]
            for n, r in reports.items()}
    emit("device", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         build_s=time.time() - t0, ptxas=regs)

    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")

    def flush():
        flush_buf.zero_()

    # the first timed run of a process reads up to twice as slow as later
    # ones (K1 at M=1 on an H100 80GB HBM3 at 700 W): spend it on a throwaway
    warm = torch.randn((8192, 8192), device="cuda", dtype=torch.bfloat16)
    timed_ms(lambda: warm @ warm, 50, flush)
    del warm
    _begin("k1")
    k1 = phase_k1(torch, tq8, flush)
    _begin("k2")
    k2, k2_ring, k2c = phase_k2(torch, tfd, flush)
    _begin("k3")
    k3 = phase_k3(torch, tfa, flush)
    _begin("k4")
    k4 = phase_k4(torch, tq4, flush)
    _begin("k5")
    k5 = phase_k5(torch, tfa, flush)
    _begin("tproto")
    t1, t2, t3 = phase_tproto(torch, tfd, tw, flush)
    _begin("small")
    phase_small(torch, te, pipeline_mod, tq8, tfd, tfa, tq4)
    del flush_buf
    torch.cuda.empty_cache()
    _begin("slice")
    launches, defer_launches, sl = phase_slice(torch, te, pipeline_mod, tq8, tfd)
    every_kernel = _kernel_counters()
    _begin("bench")
    bench_launches = phase_bench(torch, every_kernel)
    gc.collect()
    torch.cuda.empty_cache()
    _begin("ckpt, datatools and warmup (their own process, beside the phases up to stage1)")
    child = _child_start(CHILD_PHASES)
    try:
        _begin("qa")
        qa_launches = phase_qa(torch, tq8, tfd, tfa, sl)
        _begin("eval")
        eval_launches, ev_state = phase_eval(torch, pipeline_mod, tq8, tfd, tfa)
        gc.collect()
        torch.cuda.empty_cache()
        _begin("spec")
        spec_launches = phase_spec(torch, te, tq8, tfd, tfa, ev_state)
        del ev_state
        gc.collect()                            # the eval run's pipeline
        torch.cuda.empty_cache()
        _begin("chat")
        chat_launches = phase_chat(torch, te, tq8, tfd, tfa, sl)
        gc.collect()
        torch.cuda.empty_cache()
        _begin("serve")
        serve_launches, serve4_launches = phase_serve(torch, tq8, tfd, tfa, tq4, sl)
        gc.collect()
        torch.cuda.empty_cache()
        del sl                                  # the W8A8 weights make room for the float ones
        gc.collect()                            # the servers' reference cycles hold their params
        torch.cuda.empty_cache()
        _begin("float")
        float_launches = phase_float(torch, te, pipeline_mod, tq8, tfd, tfa, tq4)
        gc.collect()                            # the float pipelines make room for the trainer
        torch.cuda.empty_cache()
        _begin("train")
        train_launches = phase_train(torch, tfa)
        gc.collect()
        torch.cuda.empty_cache()
        _begin("ckpt, datatools and warmup: waiting for their process")
        done = _child_join(child)
    finally:
        _child_stop(child)
    ckpt, datatools_launches, warmup_launches = done["ckpt"], done["datatools"], done["warmup"]
    _begin("stage1")
    stage1_launches = phase_stage1(torch, pipeline_mod, every_kernel)
    gc.collect()
    torch.cuda.empty_cache()
    _begin("trainers")
    trainers_launches = phase_trainers(torch, every_kernel)
    gc.collect()
    torch.cuda.empty_cache()
    # the tp phase's ranks start first and run beside the quality phase:
    # their shards' pack_q4 and the quality phase's use the host's cores
    started = {"gloo": _tp_start("gloo", 2, "gloo",
                                 ("int8_prefix", "defer", "beam", "ring", "w4")),
               "nccl1": _tp_start("nccl1", 1, "nccl", ("int8_prefix",))}
    if torch.cuda.device_count() >= 2:
        started["nccl2"] = _tp_start("nccl2", 2, "nccl", ("int8_prefix",))
    try:
        _begin("quality")
        quality, w4_ref = phase_quality(torch, every_kernel)
        _begin("tp")
        tp_launches = phase_tp(torch, started, quality, w4_ref)
    finally:
        for _, procs in started.values():
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
    del w4_ref
    gc.collect()
    torch.cuda.empty_cache()
    _begin("tptrain")
    tptrain_launches = phase_tptrain(torch, every_kernel)

    kernels = [
        {"name": "q8_matmul", "route": "cuda", "source": "radialog_tpu_torch/csrc/q8_matmul.cu",
         "replaces": "radialog_tpu/ops/q8_matmul.py:102", "launches": launches["q8_matmul"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"], "ms_m16": k1["ms_m16"],
         "bound_ms_m16": k1["bound_ms_m16"], "library_ms_m16": k1["library_ms_m16"],
         "library_refused_m16": k1["library_refused_m16"], "ms_prefill": k1["ms_prefill"],
         "library_ms_prefill": k1["library_ms_prefill"],
         "bound_ms_prefill": k1["bound_ms_prefill"],
         **{k: v for k, v in k1.items()
            if k.endswith(("_m1", "_correction_prefill", "_m5", "_m6", "_m48"))},
         "launches_eval": eval_launches["q8_matmul"], "launches_ckpt": ckpt["q8_matmul"],
         "launches_spec": spec_launches["q8_matmul"], "launches_chat": chat_launches["q8_matmul"],
         "work": "one decoder layer's 4 projections at decode, M=56 (report batch); "
                 "*_m16: the same at the serve phase's 16 lanes; library_refused_*: "
                 "torch._int_mm's refusal at those rows; "
                 "*_prefill: the same at the report prefill's M=4480; *_m1: at batch-1 "
                 "decode; *_correction_prefill: at the correction prefill's M=440; "
                 "launches_eval: the eval phase's; launches_ckpt: the ckpt phase's report "
                 "batch and beam run on the W8A8 weights loaded from files; *_m5, *_m6, "
                 "*_m48: the speculative verify blocks (batch 1 at k = 4 and 5, 8 compact "
                 "lanes at k = 5); launches_spec, launches_chat: the spec phase's "
                 "speculative runs and the chat phase's turns"},
        {"name": "flash_decode_int8", "route": "cuda",
         "source": "radialog_tpu_torch/csrc/flash_decode.cu",
         "replaces": "radialog_tpu/ops/flash_decode.py:128",
         "launches": launches["flash_decode_int8"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None,
         **{k: v for k, v in k2.items() if k.endswith(("_qa", "device_ms", "read_flush_ms"))
            or k == "plan"},
         "launches_qa": qa_launches["flash_decode_int8"],
         **{k: v for k, v in k2.items() if k.endswith("_correction")},
         "launches_eval": eval_launches["flash_decode_int8"],
         "launches_ckpt": ckpt["flash_decode_int8"],
         "work": "one layer at decode step 150, B=56, S=384, P0=48; prefix_device_ms and "
                 "lane_device_ms: the card's own time of the two kernels; read_flush_ms: the "
                 "L2 flushed by a read; *_qa: the binary-QA pass's shape, B=14, 427 of 448 "
                 "prefix rows, S=128, step 9, and the qa phase's launches; *_correction: the "
                 "correction decode's, B=1, no prefix, S=768, step 128; launches_eval: the "
                 "eval phase's; launches_ckpt: the ckpt phase's report batch"},
        {"name": "flash_decode_int8_intervals", "route": "cuda",
         "source": "radialog_tpu_torch/csrc/flash_decode.cu",
         "replaces": "radialog_tpu/ops/flash_decode.py:521",
         "launches": serve_launches["flash_decode_int8"],
         "max_abs_err": k2_ring["max_abs_err"], "ms": k2_ring["ms"],
         "plain_ms": k2_ring["plain_ms"], "bound_ms": k2_ring["bound_ms"],
         "bound_by": k2_ring["bound_by"], "library_ms": None, "plan": k2_ring["plan"],
         "lane_device_ms": k2_ring["lane_device_ms"],
         "read_flush_ms": k2_ring["read_flush_ms"],
         "work": "one layer, the ring's per-lane slot intervals, no prefix, B=16, S=384, "
                 "prompts of 100-256 rows; launches of the serve phase (W8A8)"},
        {"name": "flash_attention", "route": "cuda",
         "source": "radialog_tpu_torch/csrc/flash_attention.cu",
         "replaces": "radialog_tpu/ops/flash_attention.py:44",
         "launches": qa_launches["flash_attention"], "max_abs_err": k3["max_abs_err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
         "ms_train": k3["ms_train"],
         "library_ms_train": k3["library_ms_train"], "bound_ms_train": k3["bound_ms_train"],
         **{k: v for k, v in k3.items() if k.endswith(("_correction", "_float_qa"))},
         "launches_eval": eval_launches["flash_attention"],
         "launches_spec": spec_launches["flash_attention"],
         "launches_chat": chat_launches["flash_attention"],
         "launches_float": sum(float_launches.values()),
         "launches_float_by_part": float_launches,
         "work": "one layer's binary-QA prefix attention, B=1, T=S=431, H=32, D=128, bf16, "
                 "causal, q/k/v views of the fused projection; launches of the qa phase; "
                 "*_train: the train phase's shape, B=2, T=S=600, lengths 600 and 413; "
                 "*_correction: the correction prefill's, B=1, T=S=440, length 437; "
                 "launches_eval: the eval phase's; launches_ckpt: the ckpt phase's eval "
                 "command line from files; launches_ckpt_train: its trainer from files; "
                 "launches_spec: the spec phase's prefills and admissions of 256+ tokens; "
                 "launches_chat: the chat phase's turns (the session prefills through "
                 "verify, never K3); "
                 "*_float_qa: the float path's binary-QA "
                 "batch, B=14, T=S=440, lengths 431-440, q/k/v contiguous; "
                 "*_float_correction: its correction prefill, B=1, T=S=440, length 437, "
                 "contiguous; launches_float: the float phase's (report pass, server, "
                 "ContinuousBatcher, eval command line)",
         "launches_train": train_launches["flash_attention"],
         "launches_ckpt": ckpt["flash_attention"],
         "launches_ckpt_train": ckpt["train"]["flash_attention"]},
        {"name": "q4_matmul", "route": "cuda", "source": "radialog_tpu_torch/csrc/q4_matmul.cu",
         "replaces": "radialog_tpu/ops/q4_matmul.py:177",
         "launches": serve4_launches["q4_matmul"], "max_abs_err": k4["max_abs_err"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": k4["bound_by"], "library_ms": None, "device_ms": k4["device_ms"],
         "ms_m56": k4["ms_m56"], "bound_ms_m56": k4["bound_ms_m56"],
         "ms_m256": k4["ms_m256"], "bound_ms_m256": k4["bound_ms_m256"],
         "work": "one decoder layer's 4 projections at decode, M=16, asymmetric grid; "
                 "device_ms: the same on the card's clock; *_m56, *_m256: the same at M=56 "
                 "and 256; launches of the serve phase (W4A8)"},
        {"name": "flash_attention_dq", "route": "cuda",
         "source": "radialog_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "radialog_tpu/ops/flash_attention.py:124",
         "launches": train_launches["flash_attention_dq"], **k5["dq"],
         "launches_ckpt_train": ckpt["train"]["flash_attention_dq"],
         "work": "one layer's dq at the train phase's shape, B=2, T=S=600, lengths 600 and "
                 "413, H=32, D=128, bf16, causal, q/k/v contiguous; "
                 "library_ms: the whole backward of scaled_dot_product_attention (dq, dk "
                 "and dv); launches of the train phase with flash; launches_ckpt_train: the "
                 "ckpt phase's trainer from files"},
        {"name": "flash_attention_dkv", "route": "cuda",
         "source": "radialog_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "radialog_tpu/ops/flash_attention.py:159",
         "launches": train_launches["flash_attention_dkv"], **k5["dkv"],
         "launches_ckpt_train": ckpt["train"]["flash_attention_dkv"],
         "work": "one layer's dk and dv at the same shape; library_ms as for dq"},
        {"name": "flash_decode_int8_current", "route": "cuda",
         "source": "radialog_tpu_torch/csrc/flash_decode.cu",
         "replaces": "radialog_tpu/ops/flash_decode.py:245",
         "launches": defer_launches["flash_decode_int8_current"], "library_ms": None, **k2c,
         "work": "one layer at decode step 150, B=56, S=384, P0=48, the current row attended "
                 "and written in place; launches of the slice's pass with RADIALOG_DEFER_KV=1"},
        {"name": "flash_decode_int8_fused", "route": "cuda",
         "source": "radialog_tpu_torch/csrc/flash_decode.cu",
         "replaces": "tools/microbench_kvfused.py:94", **t1,
         "work": "one layer at the tool's defaults, B=56, S=384, prompt pad 128, step 150, one "
                 "interleaved k|v buffer; k2_ms: K2 on the same data; launches of the tool's "
                 "8-layer chain in the tproto phase"},
        {"name": "w4_int32_split", "route": "cuda",
         "source": "radialog_tpu_torch/csrc/w4_colscale.cu",
         "replaces": "tools/microbench_w4.py:93", **t2,
         "work": "one decoder layer's 4 projections at M=32, int4 per column, activations "
                 "split even/odd, TMA + register-operand wgmma, wn 32, 64 weight rows a "
                 "block (128 for gateup), K split 4 ways for wo and down; library_ms: "
                 "torch._int_mm on the codes widened to int8; *_m5, *_m256: the same at M=5 "
                 "and 256; launches of the tool's 32-layer chain in the tproto phase"},
        {"name": "w4_int32", "route": "cuda", "source": "radialog_tpu_torch/csrc/w4_colscale.cu",
         "replaces": "tools/microbench_w4.py:153", **t3,
         "work": "as w4_int32_split with whole activation rows"},
    ]
    # the bench phase's: K2's counter splits by mode, the ring's per-lane
    # intervals (K2') in the int8 ring runs, the static slot elsewhere
    ring_tools = {"interactive_int8", "spec_ring"}
    for k in kernels:
        counter = {"flash_decode_int8_intervals": "flash_decode_int8"}.get(k["name"], k["name"])
        tools = [t for t in bench_launches
                 if counter != "flash_decode_int8"
                 or (t in ring_tools) == (k["name"] == "flash_decode_int8_intervals")]
        k["launches_bench"] = sum(bench_launches[t][counter] for t in tools)
        k["launches_bench_by_tool"] = {t: bench_launches[t][counter] for t in tools
                                       if bench_launches[t][counter]}
    for k in kernels:       # the stage1 and trainers phases' launches (the intervals mode is K2's counter)
        counter = {"flash_decode_int8_intervals": "flash_decode_int8"}.get(k["name"], k["name"])
        k["launches_stage1"] = stage1_launches[counter]
        k["launches_trainers"] = trainers_launches[counter]
        # the quality phase's, and the tp phase's on rank 0 at the shard's
        # shapes; neither runs the ring's intervals (the TP ring is bf16)
        static = k["name"] != "flash_decode_int8_intervals"
        k["launches_quality"] = quality["launches"].get(counter, 0) if static else 0
        k["launches_tp"] = tp_launches.get(counter, 0) if static else 0
        # the tptrain phase's: rank 0's timed TP = 2 and DP = 2 micro-steps
        k["launches_tptrain"] = tptrain_launches.get(counter, 0) if static else 0
        # the warmup phase's: its cold and warm runs of bench_warmup_torch
        k["launches_warmup"] = sum(warmup_launches[run].get(counter, 0)
                                   for run in ("cold", "warm")) if static else 0
    # the datatools phase's teacher: the ring (K2' is K2's counter there, every
    # launch checked to be under per-lane intervals) and the batch
    by_name = {k["name"]: k for k in kernels}
    for name, counter, runs in (("q8_matmul", "q8_matmul", ("ring", "batch")),
                                ("flash_decode_int8_intervals", "flash_decode_int8", ("ring",)),
                                ("flash_decode_int8", "flash_decode_int8", ("batch",)),
                                ("flash_attention", "flash_attention", ("ring", "batch"))):
        for run in runs:
            by_name[name][f"launches_datatools_{run}"] = datatools_launches[run][counter]
    emit("total", seconds=time.time() - _START)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


REPORT_REPS = 2


def time_report_one(root: str) -> int:
    """The slice phase's report batch (56 x 300, W8A8 Vicuna-7B at random
    weights, int8 cache, defer off) on the checkout at ``root``, with that
    checkout's own chip_smoke.py and package, in this process: a warm-up of
    8 tokens with torch's sync debug mode on (every stream wait the host
    makes counted), then REPORT_REPS timed passes."""
    import warnings
    import zlib
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    from radialog_tpu_torch.apps import pipeline as pipeline_mod
    from radialog_tpu_torch.ops import flash_decode as tfd
    from radialog_tpu_torch.ops import q8_matmul as tq8
    from radialog_tpu_torch.ops.layers import set_precision
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    set_precision()
    pipe = pipeline_mod.RaDialogPipeline(pipeline_mod.PipelineConfig(synthetic=True, seed=0))
    _, _, report_step = cs._report_batch(torch, pipe)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        report_step(8)
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(0)
    waits = sum("synchroniz" in str(w.message) for w in caught)
    counted = {"q8_matmul": tq8.q8_matmul_int32, "flash_decode_int8": tfd.flash_decode_int8_kernel}
    for rep in range(REPORT_REPS):
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        _, _, res = report_step(cs.NEW)
        tokens = res.tokens.cpu()
        dt = time.time() - t0
        emit("report", rep=rep, reports_per_s=cs.BATCH / dt, seconds=dt,
             stream_waits_in_8_tokens=waits,
             launches={k: fn.launches for k, fn in counted.items()},
             tokens_crc32=zlib.crc32(tokens.numpy().tobytes()),
             ok=tokens.shape == (cs.BATCH, cs.NEW))
    return 0


def time_report(roots) -> int:
    """time_report_one for each checkout in ``roots``, in the order given,
    each in a process of its own, so that commits compare in one call."""
    if not roots:
        print("usage: chip_smoke.py --time-report ROOT [ROOT ...]", file=sys.stderr)
        return 2
    print(smi(), flush=True)
    rc = 0
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-report-one",
                               root], capture_output=True, text=True, timeout=900)
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(json.dumps({"root": root, **json.loads(line)}), flush=True)
        if proc.returncode != 0:
            print(f"chip_smoke: {root} failed (rc {proc.returncode}):\n{proc.stderr[-4000:]}",
                  file=sys.stderr, flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-rank"] and len(sys.argv) == 3:
        sys.exit(_tp_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--tptrain-rank"] and len(sys.argv) == 3:
        sys.exit(_tptrain_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--phase-process"] and len(sys.argv) == 5:
        sys.exit(phase_process(*sys.argv[2:]))
    if sys.argv[1:2] == ["--warmup-tool"] and len(sys.argv) >= 3:
        sys.exit(warmup_tool(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["--time-report"]:
        sys.exit(time_report(sys.argv[2:]))
    if sys.argv[1:2] == ["--time-report-one"] and len(sys.argv) == 3:
        sys.exit(time_report_one(sys.argv[2]))
    sys.exit(main())
