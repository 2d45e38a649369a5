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
          B=56, H=32, D=128, S=384, L=32, shared prefix P0=48; times
  small   the mock pipeline on the card vs the same weights on the CPU:
          query embeddings, prefill and teacher-forced decode logits
  slice   the full-width pipeline (Vicuna-7B W8A8, 32 layers, int8 KV,
          BioViL-T at 448, BERT-base Q-Former, CheXpert classifier at 488)
          with random weights from a seeded generator: 56 uint8 X-rays,
          128-token prompts sharing 48 tokens, greedy decode of 300 tokens
          with EOS disabled, after a warm-up; kernel launch counts of that
          run and reports/s

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
K2_TOL = dict(atol=2e-3, rtol=2e-3)
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


def phase_k2(torch, tfd, flush):
    b, h, d, s, L, layer, p0 = BATCH, 32, 128, 384, 32, 16, SHARED
    t1 = PROMPT - SHARED
    g = torch.Generator(device="cuda").manual_seed(2)
    k8 = torch.randint(-127, 128, (L, b, s, h * d), generator=g, device="cuda", dtype=torch.int8)
    v8 = torch.randint(-127, 128, (L, b, s, h * d), generator=g, device="cuda", dtype=torch.int8)
    ks = (torch.rand((L, b, s, h), generator=g, device="cuda") * 0.01 + 0.002).to(torch.bfloat16)
    vs = (torch.rand((L, b, s, h), generator=g, device="cuda") * 0.01 + 0.002).to(torch.bfloat16)
    p0p = 64
    k0 = torch.randint(-127, 128, (p0p, h * d), generator=g, device="cuda", dtype=torch.int8)
    v0 = torch.randint(-127, 128, (p0p, h * d), generator=g, device="cuda", dtype=torch.int8)
    ks0 = (torch.rand((p0p, h), generator=g, device="cuda") * 0.01 + 0.002).to(torch.bfloat16)
    vs0 = (torch.rand((p0p, h), generator=g, device="cuda") * 0.01 + 0.002).to(torch.bfloat16)
    q = torch.randn((b, h, d), generator=g, device="cuda", dtype=torch.float32)
    lens = torch.full((b,), t1, dtype=torch.int32, device="cuda")
    lens[::3] = t1 - 7                  # ragged remainders
    lens[1] = 0                          # a lane with only its shared prefix
    q8, qs = tfd.quantize_q(q)
    shared = (k0, ks0, v0, vs0)
    summary = None
    worst = 0.0
    for step in (0, 150, NEW - 1):
        masks = tfd.slot_masks(lens, t1, step)
        args = (q8, qs, k8, ks, v8, vs, masks, layer, d ** -0.5, tfd.default_bs(s))
        got = tfd.flash_decode_int8_kernel(*args, shared=shared, p0=p0)
        ref = tfd.flash_decode_int8_plain(*args, shared=shared, p0=p0)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"K2 step {step}: non-finite output")
        torch.testing.assert_close(got, ref, **K2_TOL)
        err = float((got - ref).abs().max())
        worst = max(worst, err)
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
        emit("k2", step=step, max_abs_err=err, kernel_ms=ms, plain_ms=plain_ms,
             library_ms=None, bound_ms=max(b_bytes, b_ops),
             bound_by="bytes" if b_bytes >= b_ops else "operations",
             roofline_share=max(b_bytes, b_ops) / ms)
        if step == 150:
            summary = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(b_bytes, b_ops),
                       "bound_by": "bytes" if b_bytes >= b_ops else "operations"}
    summary["max_abs_err"] = worst
    del k8, v8
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
    the largest difference, so every kernel is also held at the mock
    pipeline's own shapes (K1: K=64/128, N up to 256; K2: H=4, D=16)."""

    def __init__(self, kernel, plain):
        self.kernel, self.plain, self.calls, self.err = kernel, plain, 0, 0.0
        # the kernel counts its launches on the name it is bound to, which
        # is this object while it stands in; those launches are not counted
        self.launches = 0

    def __call__(self, *args, **kw):
        got = self.kernel(*args, **kw)
        ref = self.plain(*args, **kw)
        self.calls += 1
        self.err = max(self.err, float((got.double() - ref.double()).abs().max()))
        return got


def phase_small(torch, te, pipeline_mod, tq8, tfd):
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
    tq8.q8_matmul_int32, tfd.flash_decode_int8_kernel = k1, k2
    try:
        _small_run(torch, te, cpu, gpu, k1, k2)
    finally:
        tq8.q8_matmul_int32, tfd.flash_decode_int8_kernel = k1.kernel, k2.kernel


def _small_run(torch, te, cpu, gpu, k1, k2):
    from radialog_tpu_torch.apps.tokenization import pad_batch_right
    from radialog_tpu_torch.models.llama import find_img_start, init_cache, llama_apply, \
        prefill_bias
    from radialog_tpu_torch.ops.image import expand_cxr_u8
    u8 = torch.randint(0, 256, (4, 64, 64), generator=torch.Generator().manual_seed(0),
                       dtype=torch.uint8)
    e_cpu = cpu.embed_images(expand_cxr_u8(u8))
    e_gpu = gpu.embed_images(expand_cxr_u8(u8.cuda()))
    emb_err = float((e_gpu.cpu() - e_cpu).abs().max())
    prompts = _prompts(cpu.tokenizer, 4, 32)
    ids = [cpu.tokenizer(p)["input_ids"] for p in prompts]
    dp = cpu.decode_params(max_new_tokens=12, eos_token_id=-1)
    res_cpu = cpu.generate_ids(ids, e_cpu, dp)
    res_gpu = gpu.generate_ids(ids, e_cpu.cuda(), dp)
    agree = float((res_gpu.tokens.cpu() == res_cpu.tokens).float().mean())
    # teacher-forced logits on the CPU's greedy ids, through the engine
    forced = res_cpu.tokens
    p0, _ = cpu._shared_prefix_len(ids, e_cpu)
    errs = []
    for p, dev, emb in ((cpu, "cpu", e_cpu), (gpu, "cuda", e_cpu.cuda())):
        rem, lens = pad_batch_right([s[p0:] for s in ids], 0)
        rem = torch.as_tensor(rem, device=dev)
        lens = torch.as_tensor(lens, device=dev)
        t1 = rem.shape[1]
        shared = te.prefix_kv(p.llama, p.llama_cfg, torch.as_tensor(ids[0][:p0], device=dev),
                              lora=p.lora, policy=p.policy)
        cache = init_cache(p.llama_cfg, len(ids), te.default_cache_len(t1, dp), device=dev)
        first, cache = llama_apply(
            p.llama, p.llama_cfg, rem, p0 + torch.arange(t1, device=dev)[None].repeat(4, 1),
            prefill_bias(lens, t1), cache=cache, img_embs=emb,
            img_start=find_img_start(rem, p.llama_cfg.img_token_id), lora=p.lora,
            policy=p.policy, lengths=lens, last_pos=lens - 1, shared_kv=shared)
        qp = te.quantize_prefix(shared)
        out = [first[:, 0]]
        for step in range(forced.shape[1] - 1):
            out.append(te.decode_step(p.llama, p.llama_cfg, cache, forced[:, step].to(dev),
                                      lens, t1, step, lora=p.lora, policy=p.policy,
                                      shared_kv=qp, pos_offset=p0, shared_p0=p0))
        errs.append(torch.stack(out, 1).cpu())
    diff = (errs[0] - errs[1]).abs()
    logit_max, logit_mean = float(diff.max()), float(diff.mean())
    emit("small", embed_max_abs_err=emb_err, teacher_forced_logit_max_abs_err=logit_max,
         teacher_forced_logit_mean_abs_err=logit_mean, logit_tol=LOGIT_TOL,
         logit_std=float(errs[0].std()), greedy_agreement=agree, shared_prefix=p0,
         k1_calls=k1.calls, k1_max_abs_err=k1.err, k2_calls=k2.calls, k2_max_abs_err=k2.err)
    if not (emb_err < 1e-3 and logit_mean < LOGIT_TOL["mean"] and logit_max < LOGIT_TOL["max"]
            and k1.calls and k1.err == 0 and k2.calls and k2.err < K2_TOL["atol"]):
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
    phase_small(torch, te, pipeline_mod, tq8, tfd)
    del flush_buf
    torch.cuda.empty_cache()
    launches = phase_slice(torch, te, pipeline_mod, tq8, tfd)

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
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
