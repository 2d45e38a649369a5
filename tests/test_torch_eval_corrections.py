"""Teacher-forced logits of the evaluation's 256-token correction turns, the
port against JAX, at every weight seed that test_torch_eval_harness.py
tried (0-23).

The harness test runs ``run_eval`` at seed 0 only: no seed of 0-23 keeps
all three batch-1 corrections token-equal to JAX (each parts at a greedy
near-tie somewhere in 768 steps; JAX's own jitted and eager runs part the
same way, ROADMAP.md section 3). Logits fed the same tokens do not part,
so here, at each seed:

  * the JAX mock pipeline's LLM and CheXbert weights (quantize=True: the
    same keys, ``llama_init``, ``quantize_llama_host``, ``lora_init``,
    ``chexbert_init``; checked equal to the pipeline's at seed 0) go
    through the bridge into the port's mock pipeline (one for the module:
    each seed replaces these weights, and no other weight of it is read);
  * the port's ``run_eval`` builds the three correction prompts of the
    fixtures' first 3 studies (its report pass of 8 tokens with image
    embeddings, CheXbert labels and ``correction_prompts``, each held equal
    to JAX's at seed 0 by the harness test);
  * JAX decodes each prompt greedily for 256 tokens as its engine does
    (``prefill`` with the int8 cache, then its decode step in one
    ``lax.scan``, flash-decode in Pallas interpret mode), keeping the
    logits of every step; the port is fed JAX's tokens (``prefill``, then
    ``decode_step``) up to the first EOS, where the turn ends;
  * the logits are held at test_torch_teacher_forced.py's BOUND (max |err|
    < 0.25 and mean |err| < 0.025 over all steps; logit std ~1).

Measured over seeds 0-23 (72 turns, 22 of them ending at EOS before 256
tokens): max |err| up to 0.196, mean up to 0.0223 (a one-step turn; 0.0216
over 256 steps). Control: a decode step whose mask leaves out the newest
cache row (the token it was just fed) moves the logits of seed 0's three
turns by 0.42, 1.17 and 0.70 (mean 0.041, 0.048, 0.038), over the bound
in every turn, and the largest margin of JAX's token below the port's
argmax to 0.11-0.54 (test_torch_eval_harness.py, TIE 0.05).
"""
import os
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.apps import pipeline as jpipe
from radialog_tpu.decode import engine as je
from radialog_tpu.models import llama as jl
from radialog_tpu.models.chexbert import chexbert_init
from radialog_tpu.ops.quant import quantize_llama_host
from radialog_tpu_torch import bridge
from radialog_tpu_torch.apps import evaluate as tev
from radialog_tpu_torch.apps.pipeline import PipelineConfig, RaDialogPipeline
from radialog_tpu_torch.apps.tokenization import pad_batch_right
from radialog_tpu_torch.data.datasets import MimicPaths, ReportGenData
from radialog_tpu_torch.decode import engine as te

import test_torch_llama as tll
from test_torch_teacher_forced import BOUND

FIXTURES = Path(__file__).resolve().parent / "fixtures"
SEEDS = range(24)
STUDIES, REPORT_NEW = 3, 8
N = tev.CORRECTION_NEW


def _jax_weights(seed, cfg, bert_cfg):
    """The JAX mock pipeline's LLM, LoRA and CheXbert weights at ``seed``
    (radialog_tpu/apps/pipeline.py RaDialogPipeline.__init__, mock and
    quantize=True), without its vision tower."""
    kl, _, _, _, kb = jax.random.split(jax.random.PRNGKey(seed), 5)
    llama = quantize_llama_host(jax.tree_util.tree_map(np.asarray,
                                                       jl.llama_init(kl, cfg, dtype=jnp.float32)),
                                bits=8)
    return llama, jl.lora_init(kl, cfg, dtype=jnp.float32), chexbert_init(kb, bert_cfg)


@pytest.fixture(scope="module")
def setting():
    os.environ["RADIALOG_FLASH_DECODE_FORCE"] = "interpret"   # before the first trace
    # the port's tiny ops gain nothing from threads, and beside the suite's
    # other workers extra threads only compete for the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jp = jpipe.RaDialogPipeline(jpipe.PipelineConfig(mock=True, quantize=True, seed=0))
    llama, lora, chexbert = _jax_weights(0, jp.llama_cfg, jp.chexbert_cfg)
    for got, want in ((llama, jp.llama), (lora, jp.lora), (chexbert, jp.chexbert)):
        jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    paths = MimicPaths(split_csv=str(FIXTURES / "split.csv"),
                       sectioned_csv=str(FIXTURES / "sectioned.csv"),
                       chexpert_csv=str(FIXTURES / "chexpert.csv"),
                       predicted_findings_json=str(FIXTURES / "preds.json"))
    # one port pipeline for every seed: each case puts its seed's LLM, LoRA
    # and CheXbert weights in; nothing else of it is read here (the report
    # pass takes the mock embeddings and the fixtures' predicted findings)
    tp = RaDialogPipeline(PipelineConfig(mock=True, device="cpu", seed=0))
    yield (jp.llama_cfg, jp.chexbert_cfg, ReportGenData(paths, truncate=STUDIES).records(),
           tp)
    os.environ.pop("RADIALOG_FLASH_DECODE_FORCE", None)
    torch.set_num_threads(threads)


@partial(jax.jit, static_argnums=(0, 6, 7))
def _greedy(cfg, qp, lora, tokens, lens, embs, cache_len, n):
    """JAX's greedy turn of n tokens and the logits each token was taken
    from: decode/engine.py prefill and its decode loop's step (static slot,
    int8 cache), one step a scan iteration."""
    t = tokens.shape[1]
    cache, first = je.prefill(qp, cfg, tokens, lens, cache_len, img_embs=embs, lora=lora,
                              kv_int8=True)

    def step(carry, i):
        cache, logits = carry
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out, cache = jl.llama_apply(
            qp, cfg, tok[:, None], (lens + i)[:, None],
            jl.decode_bias_static_slot(lens, t, i, cache_len), cache=cache, write_pos=t + i,
            lora=lora, lengths=lens, slot_info=(t, i))
        return (cache, out[:, 0]), (tok, logits)

    (_, last), (toks, logits) = jax.lax.scan(step, (cache, first), jnp.arange(n - 1))
    return (jnp.concatenate([toks, jnp.argmax(last, -1)[None].astype(jnp.int32)])[:, 0],
            jnp.concatenate([logits, last[None]])[:, 0])


_COMPILED = {}


def _jax_greedy(cfg, qp, lora, tokens, lens, embs, cache_len, n):
    """_greedy, compiled once per shape at the XLA CPU backend's default
    optimization level: tests/conftest.py sets level 0 for the whole suite,
    which is compile-bound, but this one program runs 768 steps a seed
    (5.5 s a turn at level 0, 0.9 s at level 3)."""
    args = (cfg, qp, lora, tokens, lens, embs, cache_len, n)
    key = (cfg, tokens.shape, cache_len, n)
    if key not in _COMPILED:
        _COMPILED[key] = _greedy.lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": 3})
    return _COMPILED[key](qp, lora, tokens, lens, embs)


def _correction_prompts(tp, records, out_dir):
    """(prompt, image embeddings) of each correction turn of the port's
    run_eval over ``records``; the turns themselves are not decoded."""
    real, turns = tp.generate_texts, []

    def generate_texts(prompts, img_embs=None, max_new_tokens=None, **kw):
        if max_new_tokens == N:
            turns.append((prompts[0], img_embs))
            return list(prompts)
        return real(prompts, img_embs=img_embs, max_new_tokens=max_new_tokens, **kw)
    tp.generate_texts = generate_texts
    cfg = tp.llama_cfg
    try:
        tev.run_eval(tp, records, tev.EvalOptions(use_embs=True, do_corr=True,
                                                  max_new_tokens=REPORT_NEW,
                                                  output_dir=str(out_dir)),
                     emb_provider=tev.mock_emb_provider(cfg.num_img_tokens, cfg.qformer_dim))
    finally:
        del tp.generate_texts
    return turns


def _port_logits(tp, tok, lens, embs, cache_len, forced):
    cfg = tp.llama_cfg
    lens = torch.from_numpy(lens)
    with torch.no_grad():
        cache, logits = te.prefill(tp.llama, cfg, torch.from_numpy(tok), lens, cache_len,
                                   img_embs=embs, lora=tp.lora, policy=tp.policy)
        out = [logits[0].numpy()]
        for step, t in enumerate(forced[:-1]):
            out.append(te.decode_step(tp.llama, cfg, cache, torch.tensor([int(t)]), lens,
                                      tok.shape[1], step, lora=tp.lora,
                                      policy=tp.policy)[0].numpy())
    return np.stack(out)


@pytest.mark.parametrize("seed", SEEDS)
def test_correction_logits_match_jax_at_every_seed(setting, seed, tmp_path):
    cfg, bert_cfg, records, tp = setting
    qp, lora, chexbert = _jax_weights(seed, cfg, bert_cfg)
    tp.llama = bridge.llama_serving(tll.packed_tree(qp), tp.llama_cfg, device="cpu")
    tp.lora = bridge.lora(jax.tree_util.tree_map(np.asarray, lora), device="cpu")
    tp.chexbert = bridge.chexbert(jax.tree_util.tree_map(np.asarray, chexbert), device="cpu")
    turns = _correction_prompts(tp, records, tmp_path)
    assert len(turns) == STUDIES
    worst = []
    for prompt, embs in turns:
        tok, lens = pad_batch_right([tp.tokenizer(prompt)["input_ids"]], 0)
        cache_len = te.default_cache_len(tok.shape[1], tp.decode_params(max_new_tokens=N))
        toks, ref = (np.asarray(x) for x in _jax_greedy(
            cfg, qp, lora, jnp.asarray(tok), jnp.asarray(lens), jnp.asarray(embs.numpy()),
            cache_len, N))
        eos = np.flatnonzero(toks == cfg.eos_token_id)
        n = int(eos[0]) + 1 if eos.size else N
        got = _port_logits(tp, tok, lens, embs, cache_len, toks[:n])
        err = np.abs(got - ref[:n])
        worst.append((n, float(err.max()), float(err.mean())))
        assert err.max() < BOUND["max"] and err.mean() < BOUND["mean"], worst[-1]
    print(f"seed {seed}: (tokens, max |err|, mean |err|) per turn {worst}")
