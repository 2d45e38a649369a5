"""The report pass as an archive job runs it: a closed loop of passes, back
to back. Each pass takes a batch of studies (grey-level images made from
the seed and the pass's index), embeds them (BioViL-T, ln_vision, the
Q-Former), classifies their findings (the CheXpert classifier), writes each
prompt from its findings and decodes a greedy report of ``new_tokens``
tokens: ``decode/engine.py generate_shared_prefix`` on a configuration that
shares the prompt prefix (the quantized serving path), ``generate`` on one
that does not (the float path).

A prompt is the shared prefix (the system prompt and "USER: Image
information: "), then the <IMG> slots, a findings header, one token chunk
for each finding the classifier calls positive (cut at
``findings_max_tokens``) and the instruction; every chunk is drawn from the
seed once per run, so a prompt's length follows its findings.

The window runs whole passes: a pass starts while less than ``--seconds``
have passed, and the window ends with the last pass.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark import port
from benchmark import weights as W
from benchmark.common import Context, clock


class Prompts:
    """The run's token chunks and the prompts they make."""

    def __init__(self, config: Dict, traffic: Dict, seed: int):
        lo, hi = config["text_token_range"]
        rng = np.random.default_rng(int(seed) % 2 ** 63)
        self.img_id = config["added_tokens"]["<IMG>"]
        self.n_img = config["vision"]["num_query_tokens"]
        self.prefix = rng.integers(lo, hi, traffic["shared_prefix"]).tolist()
        self.header = rng.integers(lo, hi, traffic["findings_header_tokens"]).tolist()
        a, b = traffic["finding_tokens"]
        self.chunks = [rng.integers(lo, hi, int(rng.integers(a, b + 1))).tolist()
                       for _ in range(config["vision"]["num_classes"])]
        self.sep = int(rng.integers(lo, hi))
        self.instruction = rng.integers(lo, hi, traffic["instruction_tokens"]).tolist()
        self.cap = traffic["findings_max_tokens"]

    def remainder(self, positive: np.ndarray) -> List[int]:
        """The tokens after the shared prefix, for one study's findings."""
        found: List[int] = []
        for c in np.flatnonzero(positive):
            found += self.chunks[c] + [self.sep]
        return [self.img_id] * self.n_img + self.header + found[:self.cap] + self.instruction


def setup(ctx: Context) -> Dict:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    t = clock(dev)
    state = {"llama": port.serving_llama(cfg, ctx.seed, dev)}
    t = ctx.mark("llama weights", t)
    state.update(lora=port.serving_lora(cfg, ctx.seed, dev),
                 images=port.ImageSide(cfg, ctx.seed, dev), lcfg=port.llama_config(cfg),
                 policy=port.policy(cfg), prompts=Prompts(cfg, tr, ctx.seed))
    t = ctx.mark("lora and image side weights", t)
    # warm-up: the first pass's own inputs, with a short decode
    run_pass(ctx, state, 0, warm_steps=tr["warmup_steps"])
    ctx.mark("warm-up", t)
    return state


def _decode_params(ctx: Context, new_tokens: int):
    from radialog_tpu_torch.decode.engine import DecodeParams
    return DecodeParams(max_new_tokens=new_tokens, eos_token_id=ctx.config["model"]["eos_token_id"],
                        unroll=ctx.config["path"]["decode_unroll"])


@torch.no_grad()
def run_pass(ctx: Context, state: Dict, index: int, warm_steps: int = 0) -> Dict:
    """One pass over batch ``index``; returns its record and host spans."""
    from radialog_tpu_torch.decode.engine import generate, generate_shared_prefix
    from radialog_tpu_torch.models.chexpert import predicted_findings
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    v = cfg["vision"]
    u8 = W.images_u8(ctx.seed, index, tr["batch"], tr["image_px"], dev)
    img, img_cls = W.crop_float(u8, v["image_px"]), W.crop_float(u8, v["classifier_px"])
    t0 = clock(dev)
    embs = state["images"].embed(img)
    cls_logits = state["images"].classify(img_cls)
    positive = predicted_findings(cls_logits).cpu().numpy()
    t1 = clock(dev)
    pr: Prompts = state["prompts"]
    rems = [pr.remainder(row) for row in positive]
    pad = cfg["pad_token_id"]
    dp = _decode_params(ctx, warm_steps or tr["new_tokens"])
    if cfg["path"]["shared_prefix"]:
        t_rem = max(len(r) for r in rems)
        toks = torch.tensor([r + [pad] * (t_rem - len(r)) for r in rems], dtype=torch.int32,
                            device=dev)
        lens = torch.tensor([len(r) for r in rems], dtype=torch.int32, device=dev)
        res = generate_shared_prefix(state["llama"], state["lcfg"],
                                     torch.tensor(pr.prefix, dtype=torch.int32, device=dev),
                                     toks, lens, dp, img_embs=embs, lora=state["lora"],
                                     policy=state["policy"],
                                     kv_int8=cfg["path"]["kv_cache"] == "int8")
    else:
        full = [pr.prefix + r for r in rems]
        t_full = max(len(f) for f in full)
        toks = torch.tensor([f + [pad] * (t_full - len(f)) for f in full], dtype=torch.int32,
                            device=dev)
        lens = torch.tensor([len(f) for f in full], dtype=torch.int32, device=dev)
        res = generate(state["llama"], state["lcfg"], toks, lens, dp, img_embs=embs,
                       lora=state["lora"], policy=state["policy"],
                       kv_int8=cfg["path"]["kv_cache"] == "int8")
    tokens, n_gen = res.tokens.cpu().numpy(), res.lengths.cpu().numpy()
    t2 = clock(dev)
    return {"index": index, "prompts": [pr.prefix + r for r in rems], "tokens": tokens,
            "n_gen": n_gen, "cls_logits": cls_logits.float().cpu(), "embs": embs.float().cpu(),
            "vision_s": t1 - t0, "generate_s": t2 - t1}


class _StepTrace:
    """Profiles decode steps [first, last) of the first pass in a traced
    run by wrapping ``decode/engine.py decode_step`` (the decode loop looks
    it up in its module at every step)."""

    def __init__(self, ctx: Context, first: int, last: int):
        import radialog_tpu_torch.decode.engine as engine
        self.engine, self.orig = engine, engine.decode_step
        self.first, self.last, self.tracer = first, last, ctx.tracer
        tr = self

        def step(*args, **kwargs):
            s = args[6] if len(args) > 6 else kwargs["step"]
            if s == tr.first:
                tr.tracer.start()
            out = tr.orig(*args, **kwargs)
            if s == tr.last - 1:
                tr.tracer.stop()
            return out

        engine.decode_step = step

    def remove(self) -> None:
        self.engine.decode_step = self.orig


def window(ctx: Context, state: Dict, seconds: float) -> Dict:
    tr = ctx.traffic
    passes = []
    trace = None
    if ctx.tracer is not None:
        first, last = tr["trace_steps"]
        trace = _StepTrace(ctx, first, last)
        ctx.tracer.counters["traced_steps"] = last - first
        ctx.tracer.counters["batch"] = tr["batch"]
    t0 = clock(ctx.device)
    try:
        while clock(ctx.device) - t0 < seconds:
            passes.append(run_pass(ctx, state, len(passes) + 1))
            if trace is not None and ctx.tracer.done:
                trace.remove()
                trace = None
    finally:
        if trace is not None:
            trace.remove()
    elapsed = clock(ctx.device) - t0
    reports = sum(len(p["tokens"]) for p in passes)
    from benchmark import roofline as R
    model = ctx.config["model"]
    v = port.vocab(ctx.config)
    flops = 0.0
    for p in passes:
        for prompt, n in zip(p["prompts"], p["n_gen"]):
            t, n = len(prompt), int(n)
            # the prefill's rows (the head on the last row only), then n - 1
            # decode rows that each attend the prompt and the rows before
            flops += R.llama_flops(model, v, t, R.causal_pairs(t, [t]), head_rows=1)
            flops += R.llama_flops(model, v, n - 1, (n - 1) * t + n * (n - 1) // 2)
        flops += len(p["prompts"]) * R.report_image_flops(ctx.config["vision"])
    return {"attempted": reports, "failed": 0,
            "metrics": {tr["rate_metric"]: reports / elapsed},
            "record": {"window_s": elapsed, "passes": len(passes), "reports": reports,
                       "model_flops": flops,
                       "vision_s": [p["vision_s"] for p in passes],
                       "generate_s": [p["generate_s"] for p in passes],
                       "decode_tokens": [int(p["n_gen"].max()) for p in passes],
                       "precision": ctx.config["reference"]["precision"]},
            "outputs": passes}


def free(state: Dict) -> None:
    state.clear()


def _sample(ctx: Context, passes: List[Dict]) -> List[tuple]:
    """(pass, lane) of the requests to check: the one with the most served
    tokens (on a tie, the longest prompt), then others drawn from the seed."""
    rng = np.random.default_rng((int(ctx.seed) * 31 + 7) % 2 ** 63)
    every = [(i, lane) for i, p in enumerate(passes) for lane in range(len(p["tokens"]))]
    longest = max(every, key=lambda pl: (int(passes[pl[0]]["n_gen"][pl[1]]),
                                         len(passes[pl[0]]["prompts"][pl[1]])))
    rest = [pl for pl in every if pl != longest]
    n = min(ctx.traffic["check_requests"] - 1, len(rest))
    picks = [rest[i] for i in rng.choice(len(rest), size=n, replace=False)]
    return [longest] + picks


def _gaps(name: str, diffs: List[torch.Tensor], refs: List[torch.Tensor]) -> Dict[str, float]:
    """``<name>_err``, the largest distance of an output from the
    reference's, and ``<name>_rms``, their root mean square, both over the
    reference outputs' standard deviation; ``<name>_rel``, the largest
    distance of one study's outputs from the reference's (L2) over the
    reference's (L2)."""
    d = torch.cat([x.flatten() for x in diffs])
    sd = torch.cat([r.flatten() for r in refs]).std()
    rel = torch.cat([x.flatten(1).norm(dim=1) / r.flatten(1).norm(dim=1)
                     for x, r in zip(diffs, refs)])
    return {f"{name}_err": float(d.abs().max() / sd),
            f"{name}_rms": float(d.pow(2).mean().sqrt() / sd), f"{name}_rel": float(rel.max())}


@torch.no_grad()
def check(ctx: Context, passes: List[Dict], control: bool = False) -> Dict[str, float]:
    """The numbers compared with the plain reference, once the program's
    state is freed: ``token_gap``, the widest gap by which a served token's
    logit lies below the reference's best over the sampled requests (each
    with its prompt, its image run again through the reference's own
    image side, and every token it was served), and ``token_gap_mean``
    over every checked token; over every study of the sampled requests'
    passes, the image queries (``embed_*``) and the findings logits
    (``findings_*``) against the reference's (``_gaps``). With
    ``control``, also each number with the reference one precision lower
    put in the program's place."""
    from benchmark.reference import llama as RL
    from benchmark.reference import vision as RV
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    v = cfg["vision"]
    picks = _sample(ctx, passes)
    vp, vs = W.vision_weights(v, ctx.seed, dev)
    qf = W.qformer_weights(v, ctx.seed, dev)
    cp, cs = W.classifier_weights(v, ctx.seed, dev)
    low_q = cfg["reference"]["vision_control"] if control else None
    seqs, served = [], []
    out: Dict[str, float] = {}
    sides = {"findings": ([], [], []), "embed": ([], [], [])}   # diffs, refs, control diffs
    for i in sorted({p for p, _ in picks}):
        p = passes[i]
        u8 = W.images_u8(ctx.seed, p["index"], tr["batch"], tr["image_px"], dev)
        img_cls, img = W.crop_float(u8, v["classifier_px"]), W.crop_float(u8, v["image_px"])
        refs = {"findings": RV.classifier_logits(cp, cs, v, img_cls),
                "embed": RV.qformer_queries(vp, vs, qf, v, img)}
        progs = {"findings": p["cls_logits"], "embed": p["embs"]}
        for name, (diffs, rs, ctrl) in sides.items():
            diffs.append(progs[name].to(dev) - refs[name])
            rs.append(refs[name])
            if control:
                low = (RV.classifier_logits(cp, cs, v, img_cls, quant=low_q) if name == "findings"
                       else RV.qformer_queries(vp, vs, qf, v, img, quant=low_q))
                ctrl.append(low - refs[name])
        for lane in [lane for q, lane in picks if q == i]:
            n = int(p["n_gen"][lane])
            toks = [int(t) for t in p["tokens"][lane, :n]]
            prompt = p["prompts"][lane]
            seqs.append({"tokens": torch.tensor(prompt + toks[:-1], device=dev),
                         "n_prompt": len(prompt), "img_embs": refs["embed"][lane]})
            served.append(torch.tensor(toks, device=dev))
    del vp, vs, qf, cp, cs
    for name, (diffs, rs, ctrl) in sides.items():
        out.update(_gaps(name, diffs, rs))
        if control:
            out.update({f"{k}_control": x for k, x in _gaps(name, ctrl, rs).items()})
    model = port.model_reference_dict(cfg)
    w = W.llama_weights(cfg["model"], port.vocab(cfg), ctx.seed, dev,
                        dtype=getattr(torch, cfg["path"]["float_weights"]))
    lora = W.lora_weights(cfg["model"], cfg["lora"], v["qformer"]["hidden_size"], ctx.seed, dev,
                          dtype=port.lora_dtype(cfg))
    ref = RL.Reference(w, lora, model, cfg["reference"]["precision"]).logits(seqs)
    out.update(RL.gaps(ref, served))
    if control:
        low = RL.Reference(w, lora, model, cfg["reference"]["control"]).logits(seqs)
        out.update({f"{k}_control": v for k, v in
                    RL.gaps(ref, [c.argmax(-1) for c in low]).items()})
    return out
