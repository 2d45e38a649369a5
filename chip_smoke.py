#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (radialog_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and the CUDA toolkit (nvcc). Phases, one JSON line
each; any failing phase exits non-zero:

  device  card name and power limit, torch/CUDA versions; builds every
          kernel from csrc/ (one nvcc per source, started together)
  k1      W8A8 GEMM kernel vs its plain version, bitwise, at the five
          Vicuna-7B weight shapes x M in {1, 56, 48, 56*80}; times
  k2      int8 flash-decode kernel vs its plain version (atol=rtol=2e-3) at
          B=56, H=32, D=128, S=384, L=32, shared prefix P0=48, and at the
          binary-QA prefix (B=14, P0=427 of 448 rows); times
  k3      flash-attention kernel vs its plain version (K3_TOL, beside the
          plain version's own spread between key blocks of 64 and 256) at
          H=32, D=128, bf16, causal: B=1 with T=S in {256, 448, 1024}, B=12
          with T=S=448 and lengths 300-448, and the qa phase's B=1 shapes
          T=S in {431, 436} with q/k/v as views of one fused projection;
          and H=4, D=16, f32, B=2, T=300; times, with
          scaled_dot_product_attention as the yardstick
  small   the mock pipeline on the card vs the same weights on the CPU:
          query embeddings, prefill and teacher-forced decode logits, for
          the report batch (48-token shared prefix), for a batch whose
          shared prefix holds the image and is 273 tokens long (K3 in the
          prefix prefill, K2 over the long prefix), and for a batch of 2
          300-token prompts sharing only BOS (K3, then install_prefill);
          every kernel call held against its plain version there
  slice   the full-width pipeline (Vicuna-7B W8A8, 32 layers, int8 KV,
          BioViL-T at 448, BERT-base Q-Former, CheXpert classifier at 488)
          with random weights from a seeded generator: 56 uint8 X-rays,
          128-token prompts sharing 48 tokens, greedy decode of 300 tokens
          with EOS disabled, after a warm-up; kernel launch counts of that
          run and reports/s
  qa      the evaluation follow-up passes on the slice's pipeline, over the
          slice's own conversations (prompt + 300 generated tokens) and
          image embeddings: the binary-QA pass over 2 studies (14 lanes,
          the image in a shared prefix of ~427 tokens), the all-QA pass over
          5, one batch-1 follow-up of 32 tokens (the correction pass's
          shape: prefill without a cache, then install_prefill) and the
          BERT-base CheXbert labels of 16 reports; seconds, launches per
          kernel (K3 exactly 32 x 3) and the metrics

The line before the last is a JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}. A kernel's time is the
median over launches timed with CUDA events, the 50 MB L2 flushed before
each, all queued behind a sleep on the card so that no launch waits for the
host.
"""
from __future__ import annotations

import json
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
QA_STUDIES, ALL_QA_STUDIES, LABELED, FOLLOW_UP_NEW = 2, 5, 16, 32
LOGIT_TOL = {"mean": 3e-2, "max": 0.3}   # why: phase_small's docstring


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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
    """Every LLaMA projection shape at decode, prefix and prefill rows."""
    h, inter, v = 4096, 11008, 32001
    shapes = {"wqkv": (h, 3 * h), "wo": (h, h), "gateup": (h, 2 * inter),
              "down": (inter, h), "lm_head": (h, v)}
    g = torch.Generator(device="cuda").manual_seed(1)
    summary = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
               "max_abs_err": 0, "bytes_bound": 0}
    for name, (k, n) in shapes.items():
        w8 = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
        for m in (1, 56, 48, BATCH * (PROMPT - SHARED)):
            x8 = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
            got = tq8.q8_matmul_int32(x8, w8)
            ref = tq8.q8_matmul_int32_plain(x8, w8)
            torch.cuda.synchronize()
            err = int((got.long() - ref.long()).abs().max())
            if err:
                raise AssertionError(f"K1 {name} M={m}: int32 differs from plain by {err}")
            ms = timed_ms(lambda: tq8.q8_matmul_int32(x8, w8), 20, flush)
            plain_ms = timed_ms(lambda: tq8.q8_matmul_int32_plain(x8, w8), 3, flush)
            lib_ms = None
            if m > 16 and k % 8 == 0 and n % 8 == 0:   # torch._int_mm's shape rules
                lib_ms = timed_ms(lambda: torch._int_mm(x8, w8.t()), 20, flush)
            nbytes = m * k + n * k + 4 * m * n
            b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            b_ops = 2 * m * n * k / INT8_OPS_PER_S * 1e3
            emit("k1", weight=name, m=m, k=k, n=n, bitwise=True, kernel_ms=ms,
                 plain_ms=plain_ms, library_ms=lib_ms, bound_ms=max(b_bytes, b_ops),
                 bound_by="bytes" if b_bytes >= b_ops else "operations",
                 roofline_share=max(b_bytes, b_ops) / ms)
            if m == BATCH and name != "lm_head":
                # the summary: one decoder layer's four projections at decode
                summary["ms"] += ms
                summary["plain_ms"] += plain_ms
                summary["library_ms"] += lib_ms
                summary["bound_ms"] += max(b_bytes, b_ops)
                summary["bytes_bound"] += b_bytes >= b_ops
        del w8
    summary["bound_by"] = "bytes" if summary.pop("bytes_bound") == 4 else "operations"
    return summary


def _k2_case(torch, tfd, flush, b, s, p0, t1, steps, seed):
    """K2 at one cache shape: lanes of t1 remainder slots (ragged, one
    empty), a shared prefix of p0 live rows padded to 32, decode steps
    ``steps``. Emits one line per step; returns {step: numbers}."""
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
    lens = torch.full((b,), t1, dtype=torch.int32, device="cuda")
    lens[::3] = max(t1 - 7, 1)          # ragged remainders
    lens[1] = 0                          # a lane with only its shared prefix
    q8, qs = tfd.quantize_q(q)
    shared = (k0, ks0, v0, vs0)
    out = {}
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
        ms = timed_ms(lambda: tfd.flash_decode_int8_kernel(*args, shared=shared, p0=p0), 20,
                      flush)
        plain_ms = timed_ms(lambda: tfd.flash_decode_int8_plain(*args, shared=shared, p0=p0),
                            3, flush)
        # bytes this run's data needs: each lane's valid rows (prompt and
        # generated; K, V, both scales), the live prefix rows once, q in
        # and out once
        rows = int(lens.long().sum()) + b * (step + 1)
        nbytes = rows * (2 * h * d + 4 * h) + p0 * (2 * h * d + 4 * h) + 2 * 4 * b * h * d
        ops = 4 * (rows + b * p0) * h * d
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        b_ops = ops / INT8_OPS_PER_S * 1e3
        out[step] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(b_bytes, b_ops),
                     "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                     "max_abs_err": err}
        emit("k2", batch=b, prefix_rows=p0p, step=step, max_abs_err=err, kernel_ms=ms,
             plain_ms=plain_ms, library_ms=None, bound_ms=max(b_bytes, b_ops),
             bound_by=out[step]["bound_by"], roofline_share=max(b_bytes, b_ops) / ms)
    del k8, v8
    return out


def phase_k2(torch, tfd, flush):
    """The report path's decode shape (B=56, P0=48) and the binary-QA
    pass's (14 lanes of one study, the whole 427-token history in the
    prefix, a 10-token answer in a 128-slot cache)."""
    report = _k2_case(torch, tfd, flush, BATCH, 384, SHARED, PROMPT - SHARED,
                      (0, 150, NEW - 1), seed=2)
    qa = _k2_case(torch, tfd, flush, 14, 128, 427, 8, (0, 9), seed=4)
    summary = dict(report[150])
    summary["max_abs_err"] = max(r["max_abs_err"] for r in [*report.values(), *qa.values()])
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
    """Square shapes, and the qa phase's own: the binary-QA prefix (431
    tokens) and the batch-1 follow-up (436), both ending in a partial
    64-row tile, with q/k/v read as views of one fused (B, T, 3*H*D)
    projection as models/llama.py hands them over."""
    shapes = [(1, 256, 32, 128, "bfloat16", False, False),
              (1, 448, 32, 128, "bfloat16", False, False),
              (1, 1024, 32, 128, "bfloat16", False, False),
              (12, 448, 32, 128, "bfloat16", True, False),
              (1, 431, 32, 128, "bfloat16", False, True),
              (1, 436, 32, 128, "bfloat16", False, True),
              (2, 300, 4, 16, "float32", True, False)]
    f = torch.nn.functional
    summary, worst = None, 0.0
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
        if ragged:
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
        plain_ms = timed_ms(lambda: tfa.flash_attention_plain(q, k, v, lens), 3, flush)
        lib_ms = timed_ms(lambda: f.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
                          20, flush)
        bound, by = _k3_bound(b, t, h, d, lens.tolist(), q.element_size(),
                              BF16_OPS_PER_S if dt == "bfloat16" else F32_OPS_PER_S)
        emit("k3", batch=b, t=t, heads=h, head_dim=d, dtype=dt, fused_qkv_views=fused,
             lengths=[int(x) for x in lens.tolist()], max_abs_err=err, tol=K3_TOL[dt],
             plain_block_spread=spread, kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
             bound_ms=bound, bound_by=by, roofline_share=bound / ms)
        if (b, t, dt) == (1, 431, "bfloat16"):
            # the binary-QA prefix prefill, one layer
            summary = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": bound, "bound_by": by}
    summary["max_abs_err"] = worst
    return summary


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
    the largest difference and the largest plain value, so every kernel is
    also held at the mock pipeline's own shapes (K1: K=64/128, N up to 256;
    K2: H=4, D=16; K3: H=4, D=16, f32)."""

    def __init__(self, kernel, plain):
        self.kernel, self.plain, self.calls, self.err, self.ref_max = kernel, plain, 0, 0.0, 0.0
        # the kernel counts its launches on the name it is bound to, which
        # is this object while it stands in; those launches are not counted
        self.launches = 0

    def __call__(self, *args, **kw):
        got = self.kernel(*args, **kw)
        ref = self.plain(*args, **kw)
        self.calls += 1
        self.err = max(self.err, float((got.double() - ref.double()).abs().max()))
        self.ref_max = max(self.ref_max, float(ref.double().abs().max()))
        return got


def phase_small(torch, te, pipeline_mod, tq8, tfd, tfa):
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
    k3 = _Checked(tfa.flash_attention_kernel, tfa.flash_attention_plain)
    tq8.q8_matmul_int32, tfd.flash_decode_int8_kernel, tfa.flash_attention_kernel = k1, k2, k3
    try:
        _small_run(torch, te, pipeline_mod, cpu, gpu, k1, k2, k3)
    finally:
        tq8.q8_matmul_int32, tfd.flash_decode_int8_kernel = k1.kernel, k2.kernel
        tfa.flash_attention_kernel = k3.kernel


def _teacher_forced(torch, te, pipeline_mod, p, ids, emb, forced, dp):
    """Per-step logits of pipeline p on its device with the ids ``forced``
    fed back, through the engine calls that generate_ids makes for these
    prompts (shared-prefix or plain prefill)."""
    from radialog_tpu_torch.apps.tokenization import pad_batch_right
    from radialog_tpu_torch.models.llama import find_img_start, init_cache, llama_apply, \
        prefill_bias
    n, dev = len(ids), p.device
    p0, img_in_prefix = p._shared_prefix_len(ids, emb)
    if p0 >= pipeline_mod.SHARED_PREFIX_MIN:
        rem, lens = pad_batch_right([s[p0:] for s in ids], 0)
        rem, lens = torch.as_tensor(rem, device=dev), torch.as_tensor(lens, device=dev)
        t1 = rem.shape[1]
        shared = te.prefix_kv(p.llama, p.llama_cfg, torch.as_tensor(ids[0][:p0], device=dev),
                              lora=p.lora, policy=p.policy,
                              img_embs=emb[:1] if img_in_prefix else None)
        rem_emb = None if img_in_prefix else emb
        cache = init_cache(p.llama_cfg, n, te.default_cache_len(t1, dp), device=dev)
        first, cache = llama_apply(
            p.llama, p.llama_cfg, rem, p0 + torch.arange(t1, device=dev)[None].repeat(n, 1),
            prefill_bias(lens, t1), cache=cache, img_embs=rem_emb,
            img_start=(find_img_start(rem, p.llama_cfg.img_token_id)
                       if rem_emb is not None else None),
            lora=p.lora, policy=p.policy, lengths=lens, last_pos=lens - 1, shared_kv=shared)
        first = first[:, 0]
        kw = dict(shared_kv=te.quantize_prefix(shared), pos_offset=p0, shared_p0=p0)
    else:
        tok, lens = pad_batch_right(ids, 0)
        tok, lens = torch.as_tensor(tok, device=dev), torch.as_tensor(lens, device=dev)
        t1 = tok.shape[1]
        cache, first = te.prefill(p.llama, p.llama_cfg, tok, lens, te.default_cache_len(t1, dp),
                                  img_embs=emb, lora=p.lora, policy=p.policy)
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


def _small_run(torch, te, pipeline_mod, cpu, gpu, k1, k2, k3):
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
    k3_tol = K3_TOL["float32"]
    emit("small", embed_max_abs_err=emb_err, logit_tol=LOGIT_TOL, cases=cases,
         k1_calls=k1.calls, k1_max_abs_err=k1.err, k2_calls=k2.calls, k2_max_abs_err=k2.err,
         k3_calls=k3.calls, k3_calls_long_prefix=k3_long, k3_calls_no_prefix=k3_plain_prefill,
         k3_max_abs_err=k3.err, k3_tol=k3_tol)
    ok = (emb_err < 1e-3 and k1.calls and k1.err == 0 and k2.calls and k2.err < K2_TOL["atol"]
          and k3.calls and k3_long and k3_plain_prefill
          and k3.err <= k3_tol["atol"] + k3_tol["rtol"] * k3.ref_max
          and cases["long_prefix"]["shared_prefix"] >= 256
          and cases["no_prefix"]["shared_prefix"] < pipeline_mod.SHARED_PREFIX_MIN
          and all(c["teacher_forced_logit_mean_abs_err"] < LOGIT_TOL["mean"]
                  and c["teacher_forced_logit_max_abs_err"] < LOGIT_TOL["max"]
                  for c in cases.values()))
    if not ok:
        raise AssertionError("card and CPU disagree on the mock pipeline")


def phase_slice(torch, te, pipeline_mod, tq8, tfd):
    from radialog_tpu_torch.ops.image import expand_cxr_u8
    t0 = time.time()
    pipe = pipeline_mod.RaDialogPipeline(pipeline_mod.PipelineConfig(synthetic=True, seed=0))
    torch.cuda.synchronize()
    build_s = time.time() - t0
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

    report_step(8)                      # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tq8.q8_matmul_int32.launches = 0
    tfd.flash_decode_int8_kernel.launches = 0
    t0 = time.time()
    findings, embs, res = report_step(NEW)
    tokens = res.tokens.cpu()
    dt = time.time() - t0
    launches = {"q8_matmul": tq8.q8_matmul_int32.launches,
                "flash_decode_int8": tfd.flash_decode_int8_kernel.launches}
    p0, _ = pipe._shared_prefix_len(ids, embs)
    ok = (tokens.shape == (BATCH, NEW) and int(tokens.min()) >= 0
          and int(tokens.max()) < pipe.llama_cfg.vocab_size
          and bool(torch.isfinite(embs).all()) and embs.shape == (BATCH, 32, 768)
          and len(findings) == BATCH and p0 == SHARED
          and all(res.lengths.cpu() == NEW) and all(v > 0 for v in launches.values()))
    emit("slice", reports_per_s=BATCH / dt, seconds=dt, batch=BATCH, prompt=PROMPT,
         shared_prefix=p0, new_tokens=NEW, launches=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, build_s=build_s,
         distinct_tokens=int(tokens.unique().numel()), ok=ok)
    if not ok:
        raise AssertionError("the full-width slice produced a malformed result")
    # decode steps per report: 299 forwards x 32 layers of K2, plus K1 calls
    return launches, {"pipe": pipe, "prompts": prompts, "tokens": tokens,
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
        from radialog_tpu_torch.ops import q8_matmul as tq8
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

    k1 = phase_k1(torch, tq8, flush)
    k2 = phase_k2(torch, tfd, flush)
    k3 = phase_k3(torch, tfa, flush)
    phase_small(torch, te, pipeline_mod, tq8, tfd, tfa)
    del flush_buf
    torch.cuda.empty_cache()
    launches, sl = phase_slice(torch, te, pipeline_mod, tq8, tfd)
    qa_launches = phase_qa(torch, tq8, tfd, tfa, sl)

    kernels = [
        {"name": "q8_matmul", "route": "cuda", "source": "radialog_tpu_torch/csrc/q8_matmul.cu",
         "replaces": "radialog_tpu/ops/q8_matmul.py:102", "launches": launches["q8_matmul"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"],
         "work": "one decoder layer's 4 projections at decode, M=56"},
        {"name": "flash_decode_int8", "route": "cuda",
         "source": "radialog_tpu_torch/csrc/flash_decode.cu",
         "replaces": "radialog_tpu/ops/flash_decode.py:128",
         "launches": launches["flash_decode_int8"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None,
         "work": "one layer at decode step 150, B=56, S=384, P0=48"},
        {"name": "flash_attention", "route": "cuda",
         "source": "radialog_tpu_torch/csrc/flash_attention.cu",
         "replaces": "radialog_tpu/ops/flash_attention.py:44",
         "launches": qa_launches["flash_attention"], "max_abs_err": k3["max_abs_err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
         "work": "one layer's binary-QA prefix attention, B=1, T=S=431, H=32, D=128, bf16, "
                 "causal, q/k/v views of the fused projection; launches of the qa phase"},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
