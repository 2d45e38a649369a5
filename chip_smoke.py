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
          1, 440 and 448: the eval phase's batch-1 decode and correction
          prefills, whose last 64-row tile is partial); each
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
          eval phase's batch-1 correction decode (B=1, no prefix, S=768, a
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
          T=S in {431, 436} and the eval phase's correction prefills (437
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
          run and reports/s; then the same pass with RADIALOG_DEFER_KV=1:
          K2'' 32 x 299 times, K2 never, reports/s both ways and the share
          of tokens equal to the first pass (reported, not held)
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
          --do_cp_all_qa over the first 3 test studies of tests/fixtures,
          batch 12, 300 new tokens, files under build/chip_eval/: the report
          pass, the batch-1 correction pass (256 tokens a study), binary QA,
          all-QA, CheXbert labels; seconds per pass, launches of K1, K2 and
          K3 (K3 exactly as models/llama.py _use_flash predicts from the
          prompts that reached the pipeline), the four files and finite
          metrics; K1 (bitwise), K2 and K3 held against their plain
          versions on the inputs the run gave them in the first and the
          last correction; cut from the test split in depth only (3 studies)
  spec    speculative decoding at full width on the eval phase's pipeline
          and prompts: the int8 verify attention card against CPU at S=1280
          (integer sums bitwise past 2^24, where an f32 product misses);
          generate_spec (k 4) on the first correction prompt, 256 tokens
          over the int8 cache and 128 over the bf16 one (verifies, tokens per verify,
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
  float   the float path at full width (PipelineConfig(quantize=False), the
          JAX package's default): Vicuna-7B bf16 in the stacked layout over
          the bf16 cache, random from a seed, with the slice's vision models.
          The report pass (56 images, 128-token prompts, 300 tokens, EOS
          disabled, after a warm-up; reports/s, peak memory); the server on
          its weights (the bf16 ring, 16 lanes, prompt region 256, ring 128,
          8 steps a chunk, 16 sessions x 32 tokens of 100-250-token image
          prompts from 4 client threads; tokens/s, first-token seconds);
          ContinuousBatcher (4 lanes, 8 staggered sessions x 32 tokens, each
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
          ms/step and peak memory of both

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

  ckpt    checkpoints on disk at full size, loaded back through the port's
          loaders (ROADMAP queue 1 item 3) with both tokenizer loaders
          replaced by the WhitespaceTokenizer at the Vicuna layout: Vicuna-7B
          v1.3's HF layout in fp16 (32 layers, 32,000 embedding rows, two
          pytorch_model-*.bin shards and their index, ~13.5 GB, random from
          per-tensor seeds), a PEFT adapter (r 8, alpha 16, q/v, img_proj),
          a LAVIS BLIP-2 .pth with BioViL-T, a Lightning classifier .ckpt, a
          CheXbert .pth (module. prefix) and an emb_cache npz, in a fresh
          directory under build/ (16 GiB free asked first, removed at the
          end). The W8A8 pipeline from the files: load seconds by stage,
          peak host RSS, device memory; layers 0 and 31, lm_head, embed, the
          LoRA and every BLIP-2, BioViL-T, classifier and CheXbert leaf
          bitwise against the same tensors converted and packed on the host;
          the report batch (56 x 300; logits finite with the image, NaN
          without it, as JAX's jnp.take gives them) and a 4-beam run (2
          prompts x 64 tokens: K1, never K2); the bf16 pipeline (layers 0
          and 31 bitwise); apps/evaluate.py main with every checkpoint flag,
          --num_beams 4, --do_corr, --do_cp_bin_qa over 1 fixture study (K3);
          the trainer from the files (int8 base, the adapter, flash, 2
          micro-steps: K3, K5a, K5b); pack_q4's seconds for one layer

``python3 chip_smoke.py --time-report ROOT [ROOT ...]`` runs only the slice
phase's report batch, of each checkout at ROOT in turn (its own package and
chip_smoke.py, a process each), to compare commits in one call: the stream
waits the host makes in an 8-token warm-up (torch's sync debug mode), then
two timed passes' reports/s, launches and a checksum of the tokens.

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
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12       # dense int8 tensor-core peak
BATCH, PROMPT, SHARED, NEW = 56, 128, 48, 300
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
# the eval phase's batch-1 correction turn at full width: 437, 442 and 445
# prompt tokens (a 118-token report prompt, its 300 generated tokens, the
# correction request; the eval phase prints them), padded to a multiple of
# 8 (apps/tokenization.py pad_batch_right): 440 and 448 rows, whose last
# 64-row tile is partial; 256 new tokens in a cache of 768 slots
# (decode/kvcache.py bucket_length). The eval phase also holds each kernel
# against its plain version on the inputs the run itself gave it there
CORR_T, CORR_T2, CORR_LEN, CORR_LEN2, CORR_NEW, CORR_S = 440, 448, 437, 445, 256, 768
EVAL_STUDIES = 3
# the speculative phases: K1's rows in a verify block (batch 1 at k = 4 and
# 5; 8 compact lanes at k = 5); batch-1 drafts and new tokens (the
# correction turn's 256); the chat's drafts, reply tokens after its 300-token
# report, and chunk; SpecRingBatcher's lanes, sessions, new tokens, drafts,
# verifies a chunk and ring (a multiple of k + 1 above 64 verifies x 5 slots);
# the S of the int8 verify attention held card against CPU, where 127 x 127 x
# 1,280 passes 2^24
VERIFY_M = (5, 6, 48)
SPEC_K, CORR_SPEC_K, CHAT_K, CHAT_NEW, CHAT_CHUNK = 4, 5, 5, 48, 16
SPEC_BF16_NEW = 128     # the bf16-cache batch-1 run, cut from 256 for the script's time
RING_LANES, RING_NEW, RING_K, RING_CHUNK, RING_LEN = 4, 64, 4, 8, 325
VERIFY_S = 1280
# tokens of each speculative run teacher-forced through the plain steps (the
# int8 runs make 256); generated rows of the batch-1 runs held bitwise
# against one row at a time (_tf_verify one_row), and against the control
SPEC_TF_N, ONE_ROW_N = 128, 32
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
CB_LANES, CB_SESSIONS, CB_NEW, CB_CACHE = 4, 8, 32, 320
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


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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
    admission of a full prompt region (256 rows); and at the eval phase's:
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
    # the eval phase's batch-1 correction decode: one lane, no prefix, a
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
    the eval phase's correction prefills (437 of 440 and 445 of 448 rows),
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
    report_step(8)                      # warm-up: cuDNN plans, allocator
    counted = {"q8_matmul": tq8.q8_matmul_int32, "flash_decode_int8": tfd.flash_decode_int8_kernel,
               "flash_decode_int8_current": tfd.flash_decode_int8_current_kernel}

    def timed_pass():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counted.values():
            fn.launches = 0
        t0 = time.time()
        findings, embs, res = report_step(NEW)
        tokens = res.tokens.cpu()
        return (findings, embs, res, tokens, time.time() - t0,
                {name: fn.launches for name, fn in counted.items()})

    findings, embs, res, tokens, dt, launches = timed_pass()
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
    # the same pass with in-kernel KV writes: K2'' at every layer of every
    # decode step (32 x 299 launches), K2 and the row copies never
    with _env("RADIALOG_DEFER_KV", "1"):
        _, _, res_d, tokens_d, dt_d, launches_d = timed_pass()
    layers = pipe.llama_cfg.num_layers
    differs = tokens_d != tokens
    first_diff = torch.where(differs.any(dim=1), differs.int().argmax(dim=1),
                             torch.full((BATCH,), NEW))         # NEW: the lane is equal
    ok_d = (tokens_d.shape == (BATCH, NEW) and int(tokens_d.min()) >= 0
            and int(tokens_d.max()) < pipe.llama_cfg.vocab_size
            and all(res_d.lengths.cpu() == NEW)
            and launches_d["flash_decode_int8"] == 0
            and launches_d["flash_decode_int8_current"] == layers * (NEW - 1)
            and launches_d["q8_matmul"] == launches["q8_matmul"])
    emit("slice", reports_per_s=BATCH / dt_d, seconds=dt_d, batch=BATCH, prompt=PROMPT,
         shared_prefix=p0, new_tokens=NEW, defer_kv=True, launches=launches_d,
         reports_per_s_defer_off=BATCH / dt,
         # reported, not held: the current row is summed in another order, so
         # a rounding edge may flip a token and the rest of its lane
         token_share_equal_to_defer_off=float((tokens_d == tokens).float().mean()),
         lanes_equal_to_defer_off=int((first_diff == NEW).sum()),
         first_different_step_median=float(first_diff.float().median()),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, ok=ok_d)
    if not ok_d:
        raise AssertionError("the full-width slice with in-kernel KV writes failed a check")
    return launches, launches_d, {"pipe": pipe, "prompts": prompts, "tokens": tokens,
                                  "lengths": res.lengths.cpu(), "embs": embs}


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
    its plain version on the same inputs: K1 bitwise, K2 within K2_TOL, K3
    within K3_TOL. Returns one entry per kept call."""
    held = []
    for name, kept in kept_by_name.items():
        for study, index, args, kw, got, views in kept.kept:
            ref = kept.plain(*args, **kw)
            err = float((got.double() - ref.double()).abs().max())
            ref_max = float(ref.double().abs().max())
            if name == "q8_matmul":
                ok, where = err == 0, {"m": args[0].shape[0], "n": args[1].shape[0],
                                       "k": args[1].shape[1]}
            elif name == "flash_decode_int8":
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
    the first EVAL_STUDIES test studies of tests/fixtures (one batch, 300 new
    tokens), the batch-1 correction pass (256 new tokens a study), the
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
    argv = _eval_argv(["--synthetic", "--int8"], out_dir, EVAL_STUDIES, NEW)
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
    by = {n: [c for c in gens if c["new"] == n] for n in (NEW, ev.CORRECTION_NEW, 10, 30)}
    k3_want = pipe.llama_cfg.num_layers * sum(_k3_forwards(pipeline_mod, pipe, c["prompts"],
                                                           c["embs"]) for c in gens)
    corr_tokens = [len(pipe.tokenizer(c["prompts"][0])["input_ids"]) for c in by[ev.CORRECTION_NEW]]
    files_ok, files = _eval_outputs(out_dir, results, EVAL_STUDIES)
    per_pass = {"report": sum(c["s"] for c in by[NEW]),
                "correction_per_study": [c["s"] for c in by[ev.CORRECTION_NEW]],
                "binary_qa": sum(c["s"] for c in by[10]), "all_qa": sum(c["s"] for c in by[30]),
                "labels": sum(c["s"] for c in calls if "labels" in c)}
    kinds = {(h["kernel"], h["study"]) for h in held}
    ok = (files_ok and len(gens) == sum(len(x) for x in by.values())
          and len(by[NEW]) == 1 and len(by[ev.CORRECTION_NEW]) == EVAL_STUDIES
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
         report_prompt_tokens=[len(pipe.tokenizer(p)["input_ids"]) for p in by[NEW][0]["prompts"]],
         correction_prompt_tokens=corr_tokens,
         correction_prefill_rows=[-(-n // 8) * 8 for n in corr_tokens],
         held_on_the_run_s_inputs=held, metrics=results, ok=ok, **files)
    if not ok:
        raise AssertionError("the full-width eval phase failed a check")
    k1.kept.clear(), k2.kept.clear(), k3.kept.clear()
    # the spec phase runs on this pipeline and these prompts: its batch-1
    # correction loop is the plain run the speculative decoders are put beside
    return launches, {"pipe": made.pop(), "argv": argv,
                      "report": by[NEW][0], "corrections": by[ev.CORRECTION_NEW]}


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
        with its image embeddings, 256 new tokens over the int8 cache and
        SPEC_BF16_NEW over the bf16 one: verifies, tokens per verify, seconds, stream waits
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
    for kv_int8, new in ((True, CORR_NEW), (False, SPEC_BF16_NEW)):
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
        assert (list(prompts), max_new_tokens) == (report["prompts"], NEW)
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
    """The float report pass: BATCH images, PROMPT-token prompts, NEW greedy
    tokens with EOS disabled, after a warm-up. Returns (numbers, ok, embs)."""
    from radialog_tpu_torch.decode.engine import default_cache_len
    cfg = pipe.llama_cfg
    _, ids, report_step = _report_batch(torch, pipe)
    report_step(8)                      # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counted)
    t0 = time.time()
    findings, embs, res = report_step(NEW)
    tokens = res.tokens.cpu()
    dt = time.time() - t0
    launches = _read(counted)
    cache_len = default_cache_len(PROMPT, pipe.decode_params(max_new_tokens=NEW))
    ok = (tokens.shape == (BATCH, NEW) and int(tokens.min()) >= 0
          and int(tokens.max()) < cfg.vocab_size and all(res.lengths.cpu() == NEW)
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
               "new_tokens": NEW, "cache_len": cache_len, "launches": launches,
               "ms_per_token_all_stages": dt / NEW * 1e3, "cache_gb": cache_bytes / 1e9,
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
    argv = _eval_argv(["--synthetic"], out_dir, FLOAT_STUDIES, NEW)
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
    by = {n: [c for c in gens if c["new"] == n] for n in (NEW, ev.CORRECTION_NEW, 10, 30)}
    k3_want = pipe.llama_cfg.num_layers * sum(_k3_forwards(pipeline_mod, pipe, c["prompts"],
                                                           c["embs"]) for c in gens)
    files_ok, files = _eval_outputs(out_dir, results, FLOAT_STUDIES)
    per_pass = {"report": sum(c["s"] for c in by[NEW]),
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
          and len(gens) == sum(len(x) for x in by.values()) and len(by[NEW]) == 1
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
    return out[True]["launches"]


# the stage1 phase: full width (configs/stage1_pretrain.yaml: batch 32 at 448 px,
# captions padded to max_txt_len 256), the fixtures cycled to 64 paths, 8 BF16 steps;
# the small part's batch, trunk size and caption length (pretrain.py run_mock_raw's)
STAGE1_BATCH, STAGE1_PATHS, STAGE1_STEPS, STAGE1_PROFILED = 32, 64, 8, 2
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

    # the timed run: 8 BF16 steps, then 2 under the profiler
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


# the ckpt phase: Vicuna-7B v1.3's published shapes (32,000 embedding rows, one
# short of the port's vocab 32,001 with <IMG> = 32,000), the adapter's rank
# and alpha, the beam run, the trainer's steps; bytes of free disk it needs
CKPT_VOCAB, CKPT_LORA_R, CKPT_LORA_ALPHA = 32000, 8, 16
CKPT_BEAMS, CKPT_BEAM_PROMPTS, CKPT_BEAM_NEW, CKPT_TRAIN_STEPS = 4, 2, 64, 2
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


def _rss_reset():
    """Reset the peak resident set size (Linux: 5 into clear_refs)."""
    try:
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")
    except OSError:
        pass


def _rss_peak_gb() -> float:
    """The peak resident set size since the last reset, else of the process."""
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
    _rss_reset()
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
    findings, embs, res = report_step(NEW)
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
    report = {"reports_per_s": BATCH / dt, "seconds": dt, "launches": report_launches,
              "logits_finite": bool(torch.isfinite(first).all()),
              # JAX's jnp.take fills the <IMG> row past the 32,000-row table with NaN
              "logits_without_image_nan": bool(torch.isnan(no_img).all()),
              "embs_finite": bool(torch.isfinite(embs).all()),
              "distinct_tokens": int(tokens.unique().numel())}
    ok_report = (tokens.shape == (BATCH, NEW) and int(tokens.max()) < CKPT_VOCAB
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
    _rss_reset()
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
            "--output_dir", str(out_dir)]
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
    per_pass = {"report_beams": sum(c["s"] for c in gens if c["new"] == NEW),
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
    _rss_reset()
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
    """Seconds of pack_q4 (the host packer of --w4) for one full-width layer
    of the written checkpoint, by projection; the 32-layer cost is 32 x."""
    import numpy as np
    from radialog_tpu_torch.ops.q4_matmul import pack_q4
    sd = _vicuna_layer(torch, 0)
    t = {k: v.float().T.numpy() for k, v in sd.items() if v.ndim == 2}
    parts = {"wqkv": np.concatenate([t["self_attn.q_proj.weight"], t["self_attn.k_proj.weight"],
                                     t["self_attn.v_proj.weight"]], -1),
             "gateup": np.concatenate([t["mlp.gate_proj.weight"], t["mlp.up_proj.weight"]], -1),
             "wo": t["self_attn.o_proj.weight"], "down": t["mlp.down_proj.weight"]}
    seconds = {}
    for name, w in parts.items():
        t0 = time.time()
        pack_q4(w)
        seconds[name] = time.time() - t0
    layer = sum(seconds.values())
    emit("ckpt", part="w4_pack", seconds_per_projection=seconds, seconds_per_layer=layer,
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
    k1 = phase_k1(torch, tq8, flush)
    k2, k2_ring, k2c = phase_k2(torch, tfd, flush)
    k3 = phase_k3(torch, tfa, flush)
    k4 = phase_k4(torch, tq4, flush)
    k5 = phase_k5(torch, tfa, flush)
    t1, t2, t3 = phase_tproto(torch, tfd, tw, flush)
    phase_small(torch, te, pipeline_mod, tq8, tfd, tfa, tq4)
    del flush_buf
    torch.cuda.empty_cache()
    launches, defer_launches, sl = phase_slice(torch, te, pipeline_mod, tq8, tfd)
    qa_launches = phase_qa(torch, tq8, tfd, tfa, sl)
    eval_launches, ev_state = phase_eval(torch, pipeline_mod, tq8, tfd, tfa)
    gc.collect()
    torch.cuda.empty_cache()
    spec_launches = phase_spec(torch, te, tq8, tfd, tfa, ev_state)
    del ev_state
    gc.collect()                            # the eval run's pipeline
    torch.cuda.empty_cache()
    chat_launches = phase_chat(torch, te, tq8, tfd, tfa, sl)
    gc.collect()
    torch.cuda.empty_cache()
    serve_launches, serve4_launches = phase_serve(torch, tq8, tfd, tfa, tq4, sl)
    del sl                                  # the W8A8 weights make room for the float ones
    gc.collect()                            # the servers' reference cycles hold their params
    torch.cuda.empty_cache()
    float_launches = phase_float(torch, te, pipeline_mod, tq8, tfd, tfa, tq4)
    gc.collect()                            # the float pipelines make room for the trainer
    torch.cuda.empty_cache()
    train_launches = phase_train(torch, tfa)
    gc.collect()
    torch.cuda.empty_cache()
    every_kernel = {"q8_matmul": tq8.q8_matmul_int32,
                    "flash_decode_int8": tfd.flash_decode_int8_kernel,
                    "flash_decode_int8_current": tfd.flash_decode_int8_current_kernel,
                    "flash_decode_int8_fused": tfd.flash_decode_int8_fused_kernel,
                    "flash_attention": tfa.flash_attention_kernel,
                    "flash_attention_dq": tfa.flash_attention_dq_kernel,
                    "flash_attention_dkv": tfa.flash_attention_dkv_kernel,
                    "q4_matmul": tq4.q4_matmul_acc, "w4_int32_split": tw.w4_int32_split,
                    "w4_int32": tw.w4_int32}
    stage1_launches = phase_stage1(torch, pipeline_mod, every_kernel)
    gc.collect()
    torch.cuda.empty_cache()
    ckpt = phase_ckpt(torch, pipeline_mod, tq8, tfd, tfa)

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
    for k in kernels:       # the stage1 phase's launches (the intervals mode is K2's counter)
        k["launches_stage1"] = stage1_launches[{"flash_decode_int8_intervals":
                                                "flash_decode_int8"}.get(k["name"], k["name"])]
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
    if sys.argv[1:2] == ["--time-report"]:
        sys.exit(time_report(sys.argv[2:]))
    if sys.argv[1:2] == ["--time-report-one"] and len(sys.argv) == 3:
        sys.exit(time_report_one(sys.argv[2]))
    sys.exit(main())
