"""Plain reference of the served language model, in float32: LLaMA
(RMSNorm, SwiGLU, rotary positions in the "half" layout, multi-head
attention without bias) with LoRA on the named projections and the image
queries projected and spliced at the first <IMG> token. It reads the
stacked tree of ``benchmark/weights.py`` and imports nothing of the
program.

The precision named by the configuration is worked out here from the float
weights, never taken from the program:

- ``bf16``: float32 arithmetic of the bf16 weights; the rows a decode step
  reads from the cache are rounded to bf16, as the bf16 cache holds them.
- ``w8a8``: int8 weights per output channel, int8 inputs per row of every
  projection and of the output head (the LoRA deltas read the unrounded
  input); decode rows read int8 keys and values per (token, head) with
  bf16 scales and an int8 query per head.
- ``w4a8``: as ``w8a8``, with the layers' weights in int4, symmetric, one
  scale per 128 rows of K and output channel (the output head stays int8).
- ``fp8``: as ``w8a8`` with every int8 rounding replaced by float8 e4m3
  under the same scales (the largest magnitude of the row, channel or
  (token, head) maps to 448), the head included.

A prompt row attends the prompt's own float keys and values, as the
program's prefill does; a decode row attends the cache's rounding of every
row up to its own.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

PRECISIONS = ("bf16", "w8a8", "w4a8", "fp8")
INT4_GROUP = 128
FP8_MAX = 448.0


def _q_rows(x: torch.Tensor, levels: int, dim: int = -1, scale_dtype=None) -> torch.Tensor:
    """Symmetric rounding of x to ``levels`` steps each side, one scale
    over ``dim``; the scale rounded to ``scale_dtype`` first if given."""
    s = torch.clamp(x.abs().amax(dim=dim, keepdim=True) / float(levels), min=1e-8)
    if scale_dtype is not None:
        s = s.to(scale_dtype).float()
    return torch.clamp(torch.round(x / s), -levels, levels) * s


def q_fp8(x: torch.Tensor, dim=-1, scale_dtype=None) -> torch.Tensor:
    """x rounded to float8 e4m3, one scale over ``dim`` (None: the whole
    tensor) mapping its largest magnitude to 448; the scale rounded to
    ``scale_dtype`` first if given."""
    a = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    s = torch.clamp(a / FP8_MAX, min=1e-12)
    if scale_dtype is not None:
        s = s.to(scale_dtype).float()
    return (x / s).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).float() * s


def quant_weight(w: torch.Tensor, scheme: Optional[str]) -> torch.Tensor:
    """(K, N) float32 -> its rounding under ``scheme`` (None, "int8" per
    output channel, "int4" per 128 rows of K and output channel, "fp8" per
    output channel)."""
    if scheme is None:
        return w
    if scheme == "int8":
        return _q_rows(w, 127, dim=0)
    if scheme == "fp8":
        return q_fp8(w, dim=0)
    k, n = w.shape
    g = INT4_GROUP if k % INT4_GROUP == 0 else k
    return _q_rows(w.reshape(k // g, g, n), 7, dim=1).reshape(k, n)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, D) rotated at ``positions`` (T,), the "half" layout."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = positions.float()[:, None] * inv[None]
    cos = torch.cat([ang.cos(), ang.cos()], dim=-1)[:, None]
    sin = torch.cat([ang.sin(), ang.sin()], dim=-1)[:, None]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * gain.float()


class Reference:
    """The model of one configuration at one precision, applied layer by
    layer to a list of sequences (so only one layer's float32 weights live
    at a time)."""

    def __init__(self, weights: Dict, lora: Dict, model: Dict, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.w, self.lora, self.m, self.precision = weights, lora, model, precision
        self.wscheme = {"bf16": None, "w8a8": "int8", "w4a8": "int4", "fp8": "fp8"}[precision]
        self.head_scheme = {"bf16": None, "fp8": "fp8"}.get(precision, "int8")

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "bf16":
            return x
        return q_fp8(x) if self.precision == "fp8" else _q_rows(x, 127)

    def _cache(self, x: torch.Tensor) -> torch.Tensor:
        """What a decode step reads back of keys or values (T, H, D)."""
        if self.precision == "bf16":
            return x.to(torch.bfloat16).float()
        if self.precision == "fp8":
            return q_fp8(x, scale_dtype=torch.bfloat16)
        return _q_rows(x, 127, scale_dtype=torch.bfloat16)

    def _attend(self, q, k, v, n_prompt: int) -> torch.Tensor:
        """(T, H, D) each -> (T, H*D): prompt rows causally over the float
        keys of the prompt, decode rows over the cache's rounding of every
        row up to their own."""
        t, h, d = q.shape
        scale = d ** -0.5
        out = torch.empty_like(q)
        qp, kp, vp = (z[:n_prompt].transpose(0, 1) for z in (q, k, v))
        causal = torch.ones((n_prompt, n_prompt), dtype=torch.bool, device=q.device).tril()
        s = (qp @ kp.transpose(-1, -2)) * scale
        s = s.masked_fill(~causal, float("-inf"))
        out[:n_prompt] = (torch.softmax(s, -1) @ vp).transpose(0, 1)
        if t > n_prompt:
            qd = self._act(q[n_prompt:])
            kc, vc = self._cache(k).transpose(0, 1), self._cache(v).transpose(0, 1)
            rows = torch.arange(n_prompt, t, device=q.device)[:, None]
            live = torch.arange(t, device=q.device)[None, :] <= rows
            s = (qd.transpose(0, 1) @ kc.transpose(-1, -2)) * scale
            s = s.masked_fill(~live, float("-inf"))
            out[n_prompt:] = (torch.softmax(s, -1) @ vc).transpose(0, 1)
        return out.reshape(t, h * d)

    def logits(self, seqs: List[Dict]) -> List[torch.Tensor]:
        """Each sequence: {"tokens" (T,) long: the prompt and every served
        token but the last, "n_prompt", "img_embs" (n, qdim) or None}.
        Returns per sequence the float32 logits (T - n_prompt + 1, V) of the
        rows that chose the served tokens."""
        m, w = self.m, self.w
        h, nh = m["hidden_size"], m["num_attention_heads"]
        hd, eps, theta = h // nh, m["rms_norm_eps"], m["rope_theta"]
        lora_layers, lscale = self.lora["layers"], float(self.lora["scale"])
        img_id = m["img_token_id"]
        xs = []
        for s in seqs:
            x = w["embed"][s["tokens"]].float()
            if s["img_embs"] is not None:
                pos = int((s["tokens"] == img_id).nonzero()[0, 0])
                proj = s["img_embs"].float() @ self.lora["img_proj"]["w"].float() \
                    + self.lora["img_proj"]["b"].float()
                x[pos:pos + proj.shape[0]] = proj
            xs.append(x)
        lay = w["layers"]
        for i in range(m["num_hidden_layers"]):
            ws = {n: quant_weight(lay[n]["w"][i].float(), self.wscheme)
                  for n in ("wq", "wk", "wv", "wo", "gate", "up", "down")}
            lo = {n: (lora_layers[n]["a"][i].float(), lora_layers[n]["b"][i].float())
                  for n in lora_layers}
            for j, s in enumerate(seqs):
                x = xs[j]
                t = x.shape[0]
                a = rmsnorm(x, lay["input_ln"][i], eps)
                aq = self._act(a)
                proj = {}
                for n in ("wq", "wk", "wv"):
                    y = aq @ ws[n]
                    if n in lo:
                        y = y + lscale * ((a @ lo[n][0]) @ lo[n][1])
                    proj[n] = y.reshape(t, nh, hd)
                positions = torch.arange(t, device=x.device)
                q, k = rope(proj["wq"], positions, theta), rope(proj["wk"], positions, theta)
                o = self._attend(q, k, proj["wv"], s["n_prompt"])
                x = x + self._act(o) @ ws["wo"]
                a = self._act(rmsnorm(x, lay["post_ln"][i], eps))
                x = x + self._act(F.silu(a @ ws["gate"]) * (a @ ws["up"])) @ ws["down"]
                xs[j] = x
            del ws, lo
        head = quant_weight(w["lm_head"]["w"].float(), self.head_scheme)
        out = []
        for j, s in enumerate(seqs):
            last = rmsnorm(xs[j][s["n_prompt"] - 1:], w["final_ln"], eps)
            out.append(self._act(last) @ head)
        return out


def token_gaps(ref_logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """By how much the logit of each chosen token lies below the best
    logit, over the rows of ``ref_logits`` (n, V); ``chosen`` (n,)."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(1, chosen.long()[:, None])[:, 0]


def gaps(ref_logits, chosen) -> dict:
    """Over sequences: ``token_gap``, the widest gap; ``token_gap_mean``,
    the mean gap over every checked token; ``served_tokens_checked``."""
    g = torch.cat([token_gaps(r, c) for r, c in zip(ref_logits, chosen)])
    return {"token_gap": float(g.max()), "token_gap_mean": float(g.mean()),
            "served_tokens_checked": float(g.numel())}
