"""Readers served in an open loop: sessions arrive on a schedule, each a
report request with its image and then follow-ups, through one
``apps/serve.py RaDialogServer`` (``decode/continuous.py RingBatcher`` over
the int8 ring) on the configuration's weights.

The schedule is fixed by the seed and ``--seconds``: the window is cut into
periods of ``burst_period_s``; a ``burst_share`` of them, one drawn from
the seed in each of as many equal stretches of the window, run at
``burst_factor`` times the rate of the others, so that the mean over the
window is ``rate_sessions_per_s``; each period holds as many sessions as
its rate gives, at times drawn uniformly inside it. Every
seed gets the same multiset of sizes in another order: report prompts
spread evenly over ``report_prompt``, report budgets over ``report_new``,
0 to ``followups[1]`` follow-ups in equal shares, follow-up budgets over
``followup_new`` and question lengths over ``question_tokens``.

A report prompt is the shared prefix, the <IMG> slots and findings text; a
follow-up re-sends the session's history (its last prompt and the tokens
served for it) and a question, and is sent when the answer before it has
come back, while the window lasts; one whose prompt would pass the ring's
prompt region is not sent. Each request is timed from when it was due: its
first token when the server streams it, its last when the session ends.
The window closes at ``--seconds``; requests due before then are waited
for up to ``drain_s`` more, and one that fails or never ends counts as
failed, its first-token time running to the end of that wait.

The images' query embeddings are made in set-up for a pool of
``image_pool`` studies (the report cell times the image side).
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import port
from benchmark import weights as W
from benchmark.common import Context, clock, percentile


def schedule(traffic: Dict, seed: int, seconds: float, rate: float, token_range,
             fixed: int) -> List[Dict]:
    """The sessions of a window: arrival time, pool image, the report
    prompt's text after its ``fixed`` leading tokens and its budget, and per
    follow-up (question tokens, budget). Token ids are drawn from
    ``token_range``."""
    rng = np.random.default_rng((int(seed) * 7 + 3) % 2 ** 63)
    period = traffic["burst_period_s"]
    n_periods = max(1, math.ceil(seconds / period))
    n_burst = int(round(traffic["burst_share"] * n_periods))
    burst = np.zeros(n_periods, bool)
    # one burst in each of n_burst equal stretches of the window
    edges = np.linspace(0, n_periods, n_burst + 1).round().astype(int)
    burst[[int(rng.integers(a, b)) for a, b in zip(edges[:-1], edges[1:]) if b > a]] = True
    lengths = np.minimum(period, seconds - period * np.arange(n_periods))
    weight = np.where(burst, traffic["burst_factor"], 1.0)
    base = rate * seconds / float((weight * lengths).sum())
    # each period's count rounded on the running total, so that the window
    # holds rate * seconds sessions
    due = np.round(np.cumsum(base * weight * lengths)).astype(int)
    counts = np.diff(np.concatenate([[0], due]))
    times: List[float] = []
    for i in range(n_periods):
        times += sorted((i * period + rng.random(counts[i]) * lengths[i]).tolist())
    n = len(times)

    def spread_ints(lo, hi, count):
        return rng.permutation(np.round(np.linspace(lo, hi, count)).astype(int)).tolist() \
            if count else []

    prompt = spread_ints(*traffic["report_prompt"], n)
    budget = spread_ints(*traffic["report_new"], n)
    follow = rng.permutation(np.arange(n) % (traffic["followups"][1] + 1)).tolist()
    total_f = int(sum(follow))
    f_new = spread_ints(*traffic["followup_new"], total_f)
    f_q = spread_ints(*traffic["question_tokens"], total_f)
    lo, hi = token_range
    out, k = [], 0
    for i in range(n):
        fu = [(rng.integers(lo, hi, f_q[k + j]).tolist(), f_new[k + j]) for j in range(follow[i])]
        k += follow[i]
        out.append({"at": times[i], "image": int(rng.integers(traffic["image_pool"])),
                    "text": rng.integers(lo, hi, prompt[i] - fixed).tolist(), "new": budget[i],
                    "followups": fu})
    return out


class Client:
    """Sends a window's sessions and times their requests."""

    def __init__(self, ctx: Context, state: Dict, sessions: List[Dict], seconds: float):
        self.ctx, self.state, self.sessions, self.seconds = ctx, state, sessions, seconds
        self.lock = threading.Lock()
        self.requests: List[Dict] = []
        self.all_sent = threading.Event()
        self.t0 = 0.0
        self.dropped = 0

    def _send(self, session: Dict, prompt: List[int], new: int, due: float, step: int) -> None:
        srv, embs = self.state["server"], self.state["pool_embs"]
        req = {"session": session, "step": step, "prompt": prompt, "new": new, "due": due,
               "sent": time.perf_counter(), "first": None, "last": None, "tokens": [],
               "error": None}
        with self.lock:
            self.requests.append(req)

        def on_tokens(delta, done):
            now = time.perf_counter()
            if delta and req["first"] is None:
                req["first"] = now
            req["tokens"] += list(delta)
            if done:
                req["last"] = now
                self._next(req)

        try:
            fut = srv.submit(prompt, img_embs=embs[session["image"]:session["image"] + 1],
                             max_new_tokens=new, on_tokens=on_tokens)
        except RuntimeError as exc:       # the server is dead: counted as failed
            req["error"] = repr(exc)
            return
        fut.add_done_callback(lambda f: req.__setitem__("error", repr(f.exception()))
                              if f.exception() is not None else None)

    def _next(self, req: Dict) -> None:
        """The session's next follow-up, sent now if the window lasts and
        its prompt fits the prompt region."""
        s, step = req["session"], req["step"]
        if step >= len(s["followups"]):
            return
        now = time.perf_counter()
        if now - self.t0 >= self.seconds:
            return
        q, new = s["followups"][step]
        prompt = req["prompt"] + req["tokens"] + q
        if len(prompt) > self.ctx.traffic["prompt_region"]:
            with self.lock:
                self.dropped += len(s["followups"]) - step
            return
        self._send(s, prompt, new, now, step + 1)

    def run(self) -> None:
        prefix = self.state["prefix"]
        img = [self.ctx.config["added_tokens"]["<IMG>"]] * self.ctx.config["vision"]["num_query_tokens"]
        self.t0 = time.perf_counter()
        for s in self.sessions:
            due = self.t0 + s["at"]
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self._send(s, prefix + img + s["text"], s["new"], due, 0)
        self.all_sent.set()

    def pending(self) -> int:
        with self.lock:
            return sum(r["last"] is None and r["error"] is None for r in self.requests)

    def backlog(self) -> int:
        """Requests sent that have no first token yet."""
        with self.lock:
            return sum(r["first"] is None and r["error"] is None for r in self.requests)


def setup(ctx: Context) -> Dict:
    from radialog_tpu_torch.apps.serve import RaDialogServer
    from radialog_tpu_torch.decode.engine import DecodeParams
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    t = clock(dev)
    lcfg = port.llama_config(cfg)
    images = port.ImageSide(cfg, ctx.seed, dev, classifier=False)
    u8 = W.images_u8(ctx.seed, 0, tr["image_pool"], tr["image_px"], dev)
    pool = images.embed(W.crop_float(u8, cfg["vision"]["image_px"]))
    del images
    t = ctx.mark("image pool", t)
    lo, hi = cfg["text_token_range"]
    rng = np.random.default_rng((int(ctx.seed) * 17 + 11) % 2 ** 63)
    prefix = rng.integers(lo, hi, tr["shared_prefix"]).tolist()
    dp = DecodeParams(max_new_tokens=max(tr["report_new"][1], tr["followup_new"][1]),
                      eos_token_id=cfg["model"]["eos_token_id"])
    srv = RaDialogServer(port.serving_llama(cfg, ctx.seed, dev), lcfg, lanes=tr["lanes"],
                         cache_len=tr["cache_len"], prompt_len=tr["prompt_region"], dp=dp,
                         lora=port.serving_lora(cfg, ctx.seed, dev), policy=port.policy(cfg),
                         steps_per_call=tr["steps_per_call"],
                         kv_int8=cfg["path"]["kv_cache"] == "int8", device=dev)
    state = {"server": srv, "pool_embs": pool, "prefix": prefix}
    t = ctx.mark("llama weights and server", t)
    # warm-up: one session with an image in every prompt bucket the mix
    # reaches, each decoding one chunk
    img = [cfg["added_tokens"]["<IMG>"]] * cfg["vision"]["num_query_tokens"]
    futs = []
    for bucket in range(tr["report_prompt"][0] // 32 * 32 + 32, tr["prompt_region"] + 1, 32):
        text = rng.integers(lo, hi, bucket - len(prefix) - len(img)).tolist()
        futs.append(srv.submit(prefix + img + text, img_embs=pool[:1],
                               max_new_tokens=tr["steps_per_call"] + 1))
    for f in futs:
        f.result(timeout=600)
    ctx.mark("warm-up", t)
    return state


class _AdmissionTimer:
    """Times every admission of a traced run's window with CUDA events
    around the ring's prefill (``RingBatcher._prefill_fn``: the batch-1
    prefill of one prompt and its first token), by wrapping it on the
    server's own batcher. The wrapper holds the tracer's guard, so the
    profiled stretch starts and stops between admissions (K3 runs in
    them)."""

    def __init__(self, ctx: Context, state: Dict):
        self.rb, self.ctx = state["server"]._rb, ctx
        self.orig = self.rb._prefill_fn
        self.timed: List = []
        me = self

        def prefill(tokens, length, lane, img_embs):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            with ctx.tracer.guard:
                ev0.record()
                out = me.orig(tokens, length, lane, img_embs)
                ev1.record()
            me.timed.append((int(length), ev0, ev1))
            return out

        self.rb._prefill_fn = prefill

    def remove(self) -> None:
        self.rb._prefill_fn = self.orig
        clock(self.ctx.device)
        self.ctx.tracer.counters["admissions_timed"] = [
            (n, ev0.elapsed_time(ev1) * 1e-3) for n, ev0, ev1 in self.timed]


def measure(ctx: Context, state: Dict, seconds: float, rate: float) -> Dict:
    """One window at ``rate`` sessions a second: the requests and the
    backlog sampled every second."""
    fixed = len(state["prefix"]) + ctx.config["vision"]["num_query_tokens"]
    sessions = schedule(ctx.traffic, ctx.seed, seconds, rate, ctx.config["text_token_range"],
                        fixed)
    client = Client(ctx, state, sessions, seconds)
    sender = threading.Thread(target=client.run, name="bench-client", daemon=True)
    admissions = None
    if ctx.tracer is not None and ctx.device.type == "cuda":
        admissions = _AdmissionTimer(ctx, state)
    sender.start()
    while client.t0 == 0.0:
        time.sleep(0.001)
    # the profiler runs from this (the main) thread, over trace_seconds
    # from trace_at_s into the window
    trace_on = trace_off = math.inf
    if ctx.tracer is not None:
        trace_on = client.t0 + ctx.traffic["trace_at_s"]
        trace_off = trace_on + ctx.traffic["trace_seconds"]
    backlog = []
    end = client.t0 + seconds
    next_sample = client.t0 + 1.0
    try:
        while time.perf_counter() < end:
            now = time.perf_counter()
            if now >= trace_on and not ctx.tracer.done and not ctx.tracer.active:
                ctx.tracer.start()
            elif now >= trace_off and ctx.tracer.active:
                ctx.tracer.stop()
            if now >= next_sample:
                backlog.append(client.backlog())
                next_sample += 1.0
            time.sleep(0.05)
        sender.join()
        deadline = time.perf_counter() + ctx.traffic["drain_s"]
        while client.pending() and time.perf_counter() < deadline:
            time.sleep(0.05)
    finally:
        if ctx.tracer is not None and ctx.tracer.active:
            ctx.tracer.stop()
        if admissions is not None:
            admissions.remove()
    dead = state["server"]._dead
    if dead is not None:
        ctx.log(f"the server died: {dead!r}")
    closed = time.perf_counter()
    return {"client": client, "sessions": len(sessions), "backlog": backlog, "closed": closed,
            "window_s": closed - client.t0}


def summarize(run: Dict, window_s: float) -> Dict:
    """Requests due in the window: first-token seconds (a failed or
    unfinished request counts as failed, its time running to the close),
    per-request seconds a token after the first."""
    client, closed = run["client"], run["closed"]
    due = [r for r in client.requests if r["due"] - client.t0 < window_s]
    ok = [r for r in due if r["error"] is None and r["last"] is not None]
    ttft = [(r["first"] if r["first"] is not None and r["error"] is None else closed) - r["due"]
            for r in due]
    tpot = [(r["last"] - r["first"]) / (len(r["tokens"]) - 1) for r in ok if len(r["tokens"]) > 1]
    late = [r["sent"] - r["due"] for r in due if r["step"] == 0]
    return {"attempted": len(due), "failed": len(due) - len(ok), "ttft": ttft, "tpot": tpot,
            "tokens": sum(len(r["tokens"]) for r in ok), "sender_late_max_s": max(late or [0.0])}


def model_flops(config: Dict, requests: List[Dict]) -> float:
    """Model operations of the requests' prefills (the head on the last row)
    and of their decode rows, each attending the prompt and the rows before
    (benchmark/roofline.py)."""
    from benchmark import roofline as R
    model, v = config["model"], port.vocab(config)
    flops = 0.0
    for r in requests:
        t, n = len(r["prompt"]), len(r["tokens"])
        if n:
            flops += R.llama_flops(model, v, t, R.causal_pairs(t, [t]), head_rows=1)
            flops += R.llama_flops(model, v, n - 1, (n - 1) * t + n * (n - 1) // 2)
    return flops


def window(ctx: Context, state: Dict, seconds: float) -> Dict:
    tr = ctx.traffic
    run = measure(ctx, state, seconds, tr["rate_sessions_per_s"])
    s = summarize(run, seconds)
    client = run["client"]
    return {"attempted": s["attempted"], "failed": s["failed"],
            "metrics": {"ttft_p95_s": percentile(s["ttft"], 95),
                        "tpot_p95_ms": 1e3 * percentile(s["tpot"], 95)},
            "record": {"window_s": run["window_s"], "sessions": run["sessions"],
                       "requests": s["attempted"], "tokens": s["tokens"],
                       "ttft_p50_s": percentile(s["ttft"], 50),
                       "tpot_p50_ms": 1e3 * percentile(s["tpot"], 50),
                       "followups_not_sent": client.dropped, "backlog": run["backlog"],
                       "sender_late_max_s": s["sender_late_max_s"],
                       "model_flops": model_flops(ctx.config, client.requests),
                       "precision": ctx.config["reference"]["precision"]},
            "outputs": {"done": [r for r in client.requests
                                 if r["error"] is None and r["last"] is not None],
                        "failed": s["failed"]}}


def sweep(ctx: Context, state: Dict, seconds: float, rates: List[float]) -> List[Dict]:
    """One window a rate on the same server: what the knee is read from."""
    out = []
    for rate in rates:
        run = measure(ctx, state, seconds, rate)
        s = summarize(run, seconds)
        b = run["backlog"]
        third = max(1, len(b) // 3)
        out.append({"rate_sessions_per_s": rate, "sessions": run["sessions"],
                    "requests": s["attempted"], "failed": s["failed"],
                    "ttft_p50_s": percentile(s["ttft"], 50), "ttft_p95_s": percentile(s["ttft"], 95),
                    "tpot_p95_ms": 1e3 * percentile(s["tpot"], 95) if s["tpot"] else None,
                    "tokens_per_s": s["tokens"] / run["window_s"],
                    "backlog_first_third": float(np.mean(b[:third])),
                    "backlog_last_third": float(np.mean(b[-third:])), "backlog": b})
        ctx.log("sweep", out[-1])
    return out


def free(state: Dict) -> None:
    srv = state.get("server")
    if srv is not None:
        srv.shutdown()
    state.clear()


def _sample(ctx: Context, done: List[Dict]) -> List[Dict]:
    """The requests to check: the one served the most tokens, the one with
    the longest prompt, then others drawn from the seed."""
    rng = np.random.default_rng((int(ctx.seed) * 31 + 7) % 2 ** 63)
    most = max(done, key=lambda r: (len(r["tokens"]), len(r["prompt"])))
    longest = max(done, key=lambda r: (len(r["prompt"]), len(r["tokens"])))
    picks = [most] + ([longest] if longest is not most else [])
    rest = [r for r in done if all(r is not p for p in picks)]
    n = min(ctx.traffic["check_requests"] - len(picks), len(rest))
    return picks + [rest[i] for i in rng.choice(len(rest), size=n, replace=False)]


@torch.no_grad()
def check(ctx: Context, outputs: Dict, control: bool = False) -> Dict[str, float]:
    """``failed_requests``, the requests due in the window that failed or
    never ended (an answer that never comes); ``token_gap`` over the sampled
    requests, each with its prompt, its pool image run again through the
    reference's own image side, and every token it was served (see
    drivers/report.py); with ``control``, also ``token_gap_control``."""
    from benchmark.reference import llama as RL
    from benchmark.reference import vision as RV
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    v = cfg["vision"]
    picks = _sample(ctx, outputs["done"])
    vp, vs = W.vision_weights(v, ctx.seed, dev)
    qf = W.qformer_weights(v, ctx.seed, dev)
    u8 = W.images_u8(ctx.seed, 0, tr["image_pool"], tr["image_px"], dev)
    pool = sorted({r["session"]["image"] for r in picks})
    embs = dict(zip(pool, RV.qformer_queries(vp, vs, qf, v, W.crop_float(u8[pool], v["image_px"]))))
    del vp, vs, qf
    seqs = [{"tokens": torch.tensor(r["prompt"] + r["tokens"][:-1], device=dev),
             "n_prompt": len(r["prompt"]), "img_embs": embs[r["session"]["image"]]} for r in picks]
    served = [torch.tensor(r["tokens"], device=dev) for r in picks]
    model = port.model_reference_dict(cfg)
    w = W.llama_weights(cfg["model"], port.vocab(cfg), ctx.seed, dev,
                        dtype=getattr(torch, cfg["path"]["float_weights"]))
    lora = W.lora_weights(cfg["model"], cfg["lora"], v["qformer"]["hidden_size"], ctx.seed, dev,
                          dtype=port.lora_dtype(cfg))
    ref = RL.Reference(w, lora, model, cfg["reference"]["precision"]).logits(seqs)
    out = dict(RL.gaps(ref, served), failed_requests=float(outputs["failed"]))
    if control:
        low = RL.Reference(w, lora, model, cfg["reference"]["control"]).logits(seqs)
        out.update({f"{k}_control": v for k, v in
                    RL.gaps(ref, [c.argmax(-1) for c in low]).items()})
    return out
