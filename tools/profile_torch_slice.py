#!/usr/bin/env python3
"""Where the time of one report step goes in the PyTorch port, on one GPU.

Run from the repository root: ``python3 tools/profile_torch_slice.py
[--table FILE]`` (it builds the kernels first if needed).
It builds the full-width synthetic pipeline of ``chip_smoke.py`` (Vicuna-7B
W8A8, 32 layers, int8 KV, BioViL-T at 448, CheXpert at 488), takes the
same batch (56 X-rays, 128-token prompts sharing 48 tokens) and prints one
JSON line per stage:

  stages   host-clock time of each stage, each ended by a synchronize:
           classifier, image embedding, shared-prefix prefill, remainder
           prefill into the int8 cache, and the mean decode step over
           DECODE_STEPS steps from step 0
  profile  torch.profiler over PROFILE_STEPS decode steps (from step 150):
           device time by kernel, device busy share of the window, and
           kernel launches per step

``--defer`` takes the report decode steps with in-kernel KV writes
(``llama_apply(defer_kv=True)``: the flash-decode kernel attends each layer's
new K/V row as an operand and writes it into the cache, K2'', in place of
four row copies per layer).

``--ring`` profiles the multi-session server's decode step instead
(decode/continuous.RingBatcher at Vicuna-7B width, 16 lanes over the int8
ring, prompt region 256, ring 128, 8 steps per chunk, random prompts of
100-250 tokens; ``--bits 4`` with W4A8 layers): the time of the 16 batch-1
admissions, the mean decode step over RING_CHUNKS chunks, and the profile
of one chunk.

``--train`` profiles a LoRA finetune micro-step instead: it drives
``apps/finetune_lora.train`` as the train phase of ``chip_smoke.py`` does,
on that phase's records and settings (Vicuna-7B over the int8 base, bf16
compute, LoRA rank 8 on wq/wv plus img_proj, per-layer recomputation,
micro-batch 2 x cutoff 600, image embeddings, AdamW, clip 1.0, accumulation
2), and reads the loop through ``on_step``: TRAIN_WARM micro-steps warm up,
TRAIN_STEPS are timed on the host clock (tokens/s counts the sequences' own
tokens over the whole span), then two are profiled (one that only
accumulates, one that applies the update); peak memory. Without ``--sync``
the host waits for the card only at the ends of the timed span, as a user's
run does; with it after every micro-step, as the smoke's ``on_step`` does to
stamp each step. Without ``--flash`` attention is mha under autograd, with
it K3 and K5a/K5b.

``--float`` profiles the float path's report step instead (chip_smoke.py's
float phase: Vicuna-7B bf16 in the stacked layout over the bf16 cache,
``PipelineConfig(quantize=False)``, the same batch without prefix sharing):
stages classifier, image embedding, the prefill without a cache with its
install into the cache, and the mean decode step (every layer writes its
row and attends its whole cache through ``mha``); then the profile.

``--table FILE`` also writes the profiler's full table of operators to FILE.
It needs one CUDA card and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

BATCH, PROMPT, SHARED = 56, 128, 48
DECODE_STEPS, PROFILE_AT, PROFILE_STEPS = 30, 150, 5
LANES, PROMPT_REGION, CACHE_LEN, CHUNK, RING_CHUNKS = 16, 256, 384, 8, 3
TRAIN_WARM, TRAIN_STEPS = 2, 6


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def prompts(n: int, img_tokens: int):
    """The prompts of chip_smoke.py: PROMPT tokens, the first SHARED common."""
    shared = " ".join(f"sys{i}" for i in range(SHARED - 1))
    rest = PROMPT - SHARED - 4 - img_tokens
    return [f"{shared} req{j} a{j} b{j} c{j} " + "<IMG> " * img_tokens
            + " ".join(f"w{j}x{i}" for i in range(rest)) for j in range(n)]


def clock(torch, fn):
    """(result, host ms) of fn, the card drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def profiled(torch, card, run, steps: int, step_ms: float, table, **extra) -> bool:
    """torch.profiler over ``run()``, which takes ``steps`` decode steps
    that last ``step_ms`` each when not profiled. Emits the profile line."""
    torch.cuda.synchronize()
    with profiler() as prof:
        _, wall_ms = clock(torch, run)
    return summarize(card, prof, wall_ms, steps, step_ms, table, **extra)


def summarize(card, prof, wall_ms: float, steps: int, step_ms: float, table, **extra) -> bool:
    """Emit the profile line of ``prof``, which traced ``steps`` steps in
    ``wall_ms``; whether it saw the card."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        name = e.name[:80]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit("profile", card=card, steps=steps, wall_ms_per_step=wall_ms / steps,
         device_busy_ms_per_step=busy_ms / steps,
         device_idle_share=(1 - busy_ms / wall_ms) if kernels else None,
         # the profiler slows the host; against the unprofiled step time
         device_idle_share_unprofiled=(1 - busy_ms / steps / step_ms) if kernels else None,
         kernel_launches_per_step=len(kernels) / steps,
         top_kernels_ms_per_step={n: ms / steps for n, ms in top}, **extra)
    if table:
        table = Path(table)
        table.parent.mkdir(parents=True, exist_ok=True)
        table.write_text(card + "\n" + prof.key_averages().table(sort_by="cuda_time_total",
                                                                 row_limit=40))
    return bool(kernels)


def ring(torch, card, bits: int, table) -> int:
    """The server's decode step: 16 sessions admitted into a RingBatcher,
    chunks timed, one chunk profiled."""
    import numpy as np
    from radialog_tpu_torch.decode.continuous import RingBatcher
    from radialog_tpu_torch.decode.engine import DecodeParams
    from radialog_tpu_torch.models.llama import VICUNA_7B, lora_init
    from radialog_tpu_torch.ops.layers import BF16, set_precision
    from radialog_tpu_torch.ops.quant import random_serving_params
    set_precision()
    cfg = VICUNA_7B
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = random_serving_params(cfg, gen, bits=bits)
    lora = lora_init(gen, cfg, dtype=torch.bfloat16)
    rb = RingBatcher(params, cfg, lanes=LANES, cache_len=CACHE_LEN, prompt_len=PROMPT_REGION,
                     dp=DecodeParams(max_new_tokens=100, eos_token_id=-1), lora=lora,
                     policy=BF16, steps_per_call=CHUNK, kv_int8=True)
    rng = np.random.default_rng(1)
    lengths = [int(n) for n in rng.integers(100, 251, 2 * LANES)]
    for n in lengths[:LANES]:                      # warm-up sessions of one chunk
        rb.submit([int(x) for x in rng.integers(3, 30000, n)], max_new_tokens=CHUNK)
    rb.run()
    for n in lengths[LANES:]:
        rb.submit([int(x) for x in rng.integers(3, 30000, n)])
    _, admit_ms = clock(torch, rb._admit)
    rb.step()
    _, chunks_ms = clock(torch, lambda: [rb.step() for _ in range(RING_CHUNKS)])
    step_ms = chunks_ms / (RING_CHUNKS * CHUNK)
    emit("stages", card=card, weight_bits=bits, lanes=LANES, prompt_tokens=lengths[LANES:],
         admission_ms=admit_ms / LANES, decode_step_ms=step_ms, steps_per_call=CHUNK,
         aggregate_tokens_per_s_while_decoding=LANES / step_ms * 1e3)
    ok = profiled(torch, card, rb.step, CHUNK, step_ms, table, weight_bits=bits,
                  ring_pos=rb.ring_pos)
    return 0 if ok and rb.active_lanes == LANES else 1


def train(torch, card, flash: bool, sync: bool, table) -> int:
    """apps/finetune_lora.train at full width, read through on_step: warm-up,
    a timed span, then two profiled micro-steps."""
    import tempfile
    import chip_smoke as smoke
    from radialog_tpu_torch.apps import finetune_lora as ft
    first, last = TRAIN_WARM, TRAIN_WARM + TRAIN_STEPS   # the timed span's ends
    total = last + 2
    prof = profiler()
    stamps, tokens, mem, final = {}, {}, {}, {}

    def on_step(step, metrics):
        if sync or step in (first, last, total):
            torch.cuda.synchronize()
        stamps[step], tokens[step] = time.perf_counter(), metrics["tokens"]
        final.update(metrics)
        if step == first:
            mem["resident"] = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
        elif step == last:
            mem["peak"] = torch.cuda.max_memory_allocated() / 1e9
            prof.start()
            stamps["profile"] = time.perf_counter()
        elif step == total:
            prof.stop()

    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "instruct.json"
        data.write_text(json.dumps(smoke._train_records(14, lambda j: 360 + 30 * (j % 12))))
        cfg = ft.FinetuneConfig(synthetic=True, data_path=str(data),
                                output_dir=str(Path(tmp) / "lora"),
                                batch_size=smoke.MICRO * smoke.ACCUM,
                                micro_batch_size=smoke.MICRO, num_epochs=4, max_steps=total,
                                cutoff_len=smoke.CUTOFF, val_set_size=2, use_embs=True,
                                use_instruct_data=True, quantize_base=True, flash=flash)
        ft.train(cfg, log_fn=lambda m: None, on_step=on_step)
    span_ms = (stamps[last] - stamps[first]) * 1e3
    step_ms = span_ms / TRAIN_STEPS
    timed = [tokens[i] for i in range(first + 1, last + 1)]
    emit("stages", card=card, mode="train", flash=flash, sync_every_step=sync,
         micro_batch=smoke.MICRO, cutoff=smoke.CUTOFF, accum=smoke.ACCUM,
         micro_steps=TRAIN_STEPS, micro_step_ms=step_ms, tokens_per_step=timed,
         tokens_per_s=sum(timed) / span_ms * 1e3,
         micro_step_ms_all=([(stamps[i] - stamps[i - 1]) * 1e3
                             for i in range(first + 1, last + 1)] if sync else None),
         loss=float(final["loss"]), grad_norm=float(final["grad_norm"]),
         resident_before_steps_gb=mem["resident"], peak_mem_gb=mem["peak"])
    ok = summarize(card, prof, (stamps[total] - stamps["profile"]) * 1e3, 2, step_ms, table,
                   mode="train", flash=flash, sync_every_step=sync)
    return 0 if ok else 1


def float_report(torch, card, table) -> int:
    """The float path's report step: stages, then PROFILE_STEPS decode
    steps profiled from step PROFILE_AT."""
    from radialog_tpu_torch.apps.pipeline import PipelineConfig, RaDialogPipeline
    from radialog_tpu_torch.apps.tokenization import pad_batch_right
    from radialog_tpu_torch.decode import engine as te
    from radialog_tpu_torch.ops.image import expand_cxr_u8
    pipe = RaDialogPipeline(PipelineConfig(synthetic=True, quantize=False, seed=0))
    cfg = pipe.llama_cfg
    g = torch.Generator(device="cuda").manual_seed(3)
    x448 = torch.randint(0, 256, (BATCH, 448, 448), generator=g, device="cuda",
                         dtype=torch.uint8)
    x488 = torch.randint(0, 256, (BATCH, 488, 488), generator=g, device="cuda",
                         dtype=torch.uint8)
    ids = [pipe.tokenizer(p)["input_ids"] for p in prompts(BATCH, cfg.num_img_tokens)]
    dp = pipe.decode_params(max_new_tokens=300, eos_token_id=-1)
    tok, lens = (torch.as_tensor(x, device="cuda")
                 for x in pad_batch_right(ids, pipe.tokenizer.pad_token_id))
    t = tok.shape[1]
    cache_len = te.default_cache_len(t, dp)

    def stages():
        times = {}
        _, times["classify_ms"] = clock(torch, lambda: pipe.classify_findings(
            expand_cxr_u8(x488)))
        embs, times["embed_ms"] = clock(torch, lambda: pipe.embed_images(expand_cxr_u8(x448)))
        with torch.no_grad():
            (cache, logits), times["prefill_and_install_ms"] = clock(torch, lambda: te.prefill(
                pipe.llama, cfg, tok, lens, cache_len, img_embs=embs, lora=pipe.lora,
                policy=pipe.policy, kv_int8=False))
        first = torch.argmax(logits, -1).to(torch.int32)

        @torch.no_grad()
        def step(s):
            return te.decode_step(pipe.llama, cfg, cache, first, lens, t, s, lora=pipe.lora,
                                  policy=pipe.policy)

        _, total = clock(torch, lambda: [step(s) for s in range(DECODE_STEPS)])
        times["decode_step_ms"] = total / DECODE_STEPS
        return times, step

    stages()                                       # warm-up
    times, step = stages()
    emit("stages", card=card, mode="float", batch=BATCH, prompt=PROMPT, cache_len=cache_len,
         decode_steps=DECODE_STEPS, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         **times)
    for s in range(PROFILE_AT - 2, PROFILE_AT):
        step(s)
    ok = profiled(torch, card,
                  lambda: [step(s) for s in range(PROFILE_AT, PROFILE_AT + PROFILE_STEPS)],
                  PROFILE_STEPS, times["decode_step_ms"], table, mode="float",
                  from_step=PROFILE_AT)
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true",
                    help="profile a LoRA finetune micro-step, not the report step")
    ap.add_argument("--flash", action="store_true",
                    help="in --train mode: attention through the flash-attention kernels")
    ap.add_argument("--sync", action="store_true",
                    help="in --train mode: wait for the card after every micro-step")
    ap.add_argument("--table", help="write the profiler's operator table here")
    ap.add_argument("--defer", action="store_true",
                    help="report decode steps with in-kernel KV writes (K2'')")
    ap.add_argument("--ring", action="store_true",
                    help="profile the ring batcher's decode step, not the report step")
    ap.add_argument("--bits", type=int, default=8, choices=(4, 8),
                    help="weight bits of the layers in --ring mode")
    ap.add_argument("--float", dest="float_path", action="store_true",
                    help="profile the float path's report step (bf16, stacked, bf16 cache)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 2
    from radialog_tpu_torch.apps.pipeline import PipelineConfig, RaDialogPipeline
    from radialog_tpu_torch.apps.tokenization import pad_batch_right
    from radialog_tpu_torch.decode import engine as te
    from radialog_tpu_torch.models.llama import find_img_start, init_cache, llama_apply, \
        prefill_bias
    from radialog_tpu_torch.ops import _build
    from radialog_tpu_torch.ops.image import expand_cxr_u8

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    _build.build()
    if args.train:
        return train(torch, card, args.flash, args.sync, args.table)
    if args.ring:
        return ring(torch, card, args.bits, args.table)
    if args.float_path:
        return float_report(torch, card, args.table)
    pipe = RaDialogPipeline(PipelineConfig(synthetic=True, seed=0))
    cfg = pipe.llama_cfg
    g = torch.Generator(device="cuda").manual_seed(3)
    x448 = torch.randint(0, 256, (BATCH, 448, 448), generator=g, device="cuda",
                         dtype=torch.uint8)
    x488 = torch.randint(0, 256, (BATCH, 488, 488), generator=g, device="cuda",
                         dtype=torch.uint8)
    ids = [pipe.tokenizer(p)["input_ids"] for p in prompts(BATCH, cfg.num_img_tokens)]
    dp = pipe.decode_params(max_new_tokens=300, eos_token_id=-1)
    p0, _ = pipe._shared_prefix_len(ids, None)
    rem, lens = pad_batch_right([s[p0:] for s in ids], pipe.tokenizer.pad_token_id)
    rem = torch.as_tensor(rem, device="cuda")
    lens = torch.as_tensor(lens, device="cuda")
    t1 = rem.shape[1]

    def clock_ms(fn):
        return clock(torch, fn)

    def report_stages():
        times = {}
        _, times["classify_ms"] = clock_ms(lambda: pipe.classify_findings(expand_cxr_u8(x488)))
        embs, times["embed_ms"] = clock_ms(lambda: pipe.embed_images(expand_cxr_u8(x448)))
        prefix = torch.as_tensor(ids[0][:p0], device="cuda")
        shared, times["prefix_prefill_ms"] = clock_ms(lambda: te.prefix_kv(
            pipe.llama, cfg, prefix, lora=pipe.lora, policy=pipe.policy))
        cache = init_cache(cfg, BATCH, te.default_cache_len(t1, dp), device="cuda")
        (logits, cache), times["prefill_ms"] = clock_ms(lambda: llama_apply(
            pipe.llama, cfg, rem, p0 + torch.arange(t1, device="cuda")[None].repeat(BATCH, 1),
            prefill_bias(lens, t1), cache=cache, img_embs=embs,
            img_start=find_img_start(rem, cfg.img_token_id), lora=pipe.lora,
            policy=pipe.policy, lengths=lens, last_pos=lens - 1, shared_kv=shared))
        qp = te.quantize_prefix(shared)
        tok = torch.argmax(logits[:, 0], -1).to(torch.int32)

        def step(s):
            return te.decode_step(pipe.llama, cfg, cache, tok, lens, t1, s, lora=pipe.lora,
                                  policy=pipe.policy, shared_kv=qp, pos_offset=p0,
                                  shared_p0=p0, defer_kv=args.defer)

        _, total = clock_ms(lambda: [step(s) for s in range(DECODE_STEPS)])
        times["decode_step_ms"] = total / DECODE_STEPS
        return times, step

    report_stages()                                # warm-up
    times, step = report_stages()
    emit("stages", card=card, batch=BATCH, prompt=PROMPT, shared_prefix=p0,
         decode_steps=DECODE_STEPS, defer_kv=args.defer, **times)

    for s in range(PROFILE_AT - 2, PROFILE_AT):
        step(s)
    ok = profiled(torch, card,
                  lambda: [step(s) for s in range(PROFILE_AT, PROFILE_AT + PROFILE_STEPS)],
                  PROFILE_STEPS, times["decode_step_ms"], args.table, from_step=PROFILE_AT,
                  defer_kv=args.defer)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
