"""The port's slice end to end against the JAX package: X-ray -> BioViL-T ->
ln_vision -> Q-Former -> <IMG> splice -> W8A8 TINY_LLAMA with the int8 KV
cache -> generate_shared_prefix, weights through the bridge, FP32 policy.
The JAX decode takes its flash-decode kernel in Pallas interpret mode.

Checked: the query embeddings (rtol=atol=1e-4, float32 trunk sums in
another order), the prefill logits and the teacher-forced per-step decode
logits (atol=2e-3, see tests/test_torch_llama.py for why), and the greedy
ids (equal)."""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.decode import engine as je
from radialog_tpu.models import biovil_t as jb
from radialog_tpu.models import blip2 as jblip
from radialog_tpu.models import llama as jl
from radialog_tpu.models import qformer as jq
from radialog_tpu.ops.layers import layernorm as jlayernorm
from radialog_tpu.ops.layers import layernorm_init
from radialog_tpu_torch import bridge
from radialog_tpu_torch.apps.pipeline import PipelineConfig, RaDialogPipeline
from radialog_tpu_torch.decode import engine as te
from radialog_tpu_torch.models import biovil_t as tb
from radialog_tpu_torch.models import blip2 as tblip
from radialog_tpu_torch.models.chexpert import CHEXPERT_CLASSES
from radialog_tpu_torch.models import llama as tl
from radialog_tpu_torch.models import qformer as tq
from radialog_tpu_torch.ops.layers import layernorm

import test_torch_llama as tll

REPO = Path(__file__).resolve().parent.parent
NQ = jl.TINY_LLAMA.num_img_tokens          # 4 queries = 4 <IMG> slots
P0, T1, B, NEW = 6, 10, 2, 8
LOGIT_TOL = dict(rtol=0, atol=2e-3)


def _embeddings():
    jcfg = dataclasses.replace(jq.TINY_QFORMER, num_query_tokens=NQ)
    tcfg = dataclasses.replace(tq.TINY_QFORMER, num_query_tokens=NQ)
    vp, vs = jb.biovil_t_init(jax.random.PRNGKey(7), joint_feature_size=jcfg.encoder_width,
                              resnet_layers=(1, 1, 1, 1), bottleneck=False)
    qf = {"qformer": jq.qformer_init(jax.random.PRNGKey(8), jcfg),
          "ln_vision": layernorm_init(jcfg.encoder_width)}
    u8 = np.random.default_rng(0).integers(0, 256, (B, 64, 64), dtype=np.uint8)
    x = np.repeat((u8.astype(np.float32) / 255.0)[..., None], 3, axis=-1)
    out, _ = jb.biovil_t_apply(vp, vs, jnp.asarray(x))
    patch = jlayernorm(qf["ln_vision"], jb.patch_tokens_for_qformer(out.projected_patch_embeddings))
    jemb = jblip.blip2_forward_image(qf, jblip.Blip2Config(qformer=jcfg), patch)
    tvp, tvs = bridge.biovil_t(jax.tree_util.tree_map(np.asarray, vp),
                               jax.tree_util.tree_map(np.asarray, vs), device="cpu")
    tqf = bridge.qformer(jax.tree_util.tree_map(np.asarray, qf["qformer"]),
                         jax.tree_util.tree_map(np.asarray, qf["ln_vision"]), device="cpu")
    from radialog_tpu_torch.ops.image import expand_cxr_u8
    tout = tb.biovil_t_apply(tvp, tvs, expand_cxr_u8(torch.from_numpy(u8)))
    tpatch = layernorm(tqf["ln_vision"], tb.patch_tokens_for_qformer(tout.projected_patch_embeddings))
    temb = tblip.blip2_forward_image(tqf, tblip.Blip2Config(qformer=tcfg), tpatch)
    return np.array(jemb), temb


def _prompts():
    rng = np.random.default_rng(1)
    prefix = rng.integers(3, 240, (P0,)).astype(np.int32)
    rem = rng.integers(3, 240, (B, T1)).astype(np.int32)
    rem[:, 2:2 + NQ] = jl.TINY_LLAMA.img_token_id
    lengths = np.asarray([T1, T1 - 2], np.int32)
    return prefix, rem, lengths


def _jax_teacher_forced(qp, lora, prefix, rem, lengths, embs, forced, cache_len):
    """JAX engine internals (generate_shared_prefix with kv_int8=True),
    stepped by hand so every step's logits can be read."""
    cfg = jl.TINY_LLAMA
    shared = je.prefix_kv(qp, cfg, jnp.asarray(prefix), lora=lora)
    cache = jl.init_cache(cfg, B, cache_len, quantized=True)
    pos = P0 + jnp.arange(T1)[None].repeat(B, 0)
    logits, cache = jl.llama_apply(
        qp, cfg, jnp.asarray(rem), pos, jl.prefill_bias(jnp.asarray(lengths), T1),
        cache=cache, write_pos=0, img_embs=jnp.asarray(embs),
        img_start=jl.find_img_start(jnp.asarray(rem), cfg.img_token_id), lora=lora,
        lengths=jnp.asarray(lengths), last_pos=jnp.asarray(lengths - 1), shared_kv=shared)
    L, _, H, D = shared.k.shape
    k0, ks0 = jl.quantize_kv(shared.k)
    v0, vs0 = jl.quantize_kv(shared.v)
    pad = ((0, 0), (0, 32 - P0), (0, 0))
    k0 = jnp.pad(k0.reshape(L, P0, H * D), pad)
    v0 = jnp.pad(v0.reshape(L, P0, H * D), pad)
    ks0 = jnp.pad(jl.pad_scale_lanes(ks0), pad)
    vs0 = jnp.pad(jl.pad_scale_lanes(vs0), pad)
    shared_c = tuple((k0[i], ks0[i], v0[i], vs0[i]) for i in range(L))
    lens = jnp.asarray(lengths)

    @jax.jit   # traced like the engine's decode loop body
    def step_fn(cache, tok, step):
        return jl.llama_apply(
            qp, cfg, tok[:, None], (lens + P0 + step)[:, None],
            jl.decode_bias_static_slot(lens, T1, step, cache_len), cache=cache,
            write_pos=T1 + step, lora=lora, lengths=lens, slot_info=(T1, step),
            shared_kv=shared_c, shared_p0=P0)

    out = [np.asarray(logits[:, 0])]
    for step in range(NEW - 1):
        lg, cache = step_fn(cache, jnp.asarray(forced[:, step]), jnp.asarray(step))
        out.append(np.asarray(lg[:, 0]))
    return np.stack(out, 1)


def test_slice_matches_jax_generate_shared_prefix(monkeypatch):
    monkeypatch.setenv("RADIALOG_FLASH_DECODE_FORCE", "interpret")
    jemb, temb = _embeddings()
    np.testing.assert_allclose(temb.numpy(), jemb, rtol=1e-4, atol=1e-4)
    qp, lora, tp, tlora, _ = tll.models(3)
    prefix, rem, lengths = _prompts()
    cache_len = 32
    jres = je.generate_shared_jit(qp, jl.TINY_LLAMA, jnp.asarray(prefix), jnp.asarray(rem),
                                  jnp.asarray(lengths),
                                  je.DecodeParams(max_new_tokens=NEW, eos_token_id=-1),
                                  img_embs=jnp.asarray(jemb), lora=lora,
                                  cache_len=cache_len, kv_int8=True)
    tres = te.generate_shared_prefix(tp, tl.TINY_LLAMA, torch.from_numpy(prefix),
                                     torch.from_numpy(rem), torch.from_numpy(lengths),
                                     te.DecodeParams(max_new_tokens=NEW, eos_token_id=-1),
                                     img_embs=torch.from_numpy(jemb), lora=tlora,
                                     cache_len=cache_len)
    np.testing.assert_array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(tres.lengths.numpy(), np.asarray(jres.lengths))

    # teacher-forced per-step logits on the JAX greedy ids
    forced = np.asarray(jres.tokens)
    jlog = _jax_teacher_forced(qp, lora, prefix, rem, lengths, jemb, forced, cache_len)
    shared = te.prefix_kv(tp, tl.TINY_LLAMA, torch.from_numpy(prefix), lora=tlora)
    cache = tl.init_cache(tl.TINY_LLAMA, B, cache_len, device="cpu")
    tlen = torch.from_numpy(lengths)
    first, cache = tl.llama_apply(
        tp, tl.TINY_LLAMA, torch.from_numpy(rem),
        P0 + torch.arange(T1)[None].repeat(B, 1), tl.prefill_bias(tlen, T1), cache=cache,
        img_embs=torch.from_numpy(jemb),
        img_start=tl.find_img_start(torch.from_numpy(rem), tl.TINY_LLAMA.img_token_id),
        lora=tlora, lengths=tlen, last_pos=tlen - 1, shared_kv=shared)
    qprefix = te.quantize_prefix(shared)
    tlog = [first[:, 0].numpy()]
    for step in range(NEW - 1):
        tlog.append(te.decode_step(tp, tl.TINY_LLAMA, cache, torch.from_numpy(forced[:, step]),
                                   tlen, T1, step, lora=tlora, shared_kv=qprefix,
                                   pos_offset=P0, shared_p0=P0).numpy())
    np.testing.assert_allclose(np.stack(tlog, 1), jlog, **LOGIT_TOL)


def test_mock_pipeline_generates_on_cpu():
    p = RaDialogPipeline(PipelineConfig(mock=True, device="cpu", max_new_tokens=4))
    embs = p.embed_images(torch.rand(3, 64, 64, 3))
    assert embs.shape == (3, 32, 32)
    findings = p.classify_findings(torch.rand(1, 488, 488, 3))
    assert len(findings) == 1 and set(findings[0]) <= set(CHEXPERT_CLASSES)
    shared = " ".join(f"w{i}" for i in range(20))
    prompts = [f"{shared} r{j} " + "<IMG> " * 32 + f"tail{j}" for j in range(3)]
    ids = [p.tokenizer(x)["input_ids"] for x in prompts]
    assert p._shared_prefix_len(ids, embs) == (21, False)
    assert p._shared_prefix_len(ids, embs[:1].expand(3, -1, -1)) == (21, False)
    texts = p.generate_texts(prompts, img_embs=embs)
    assert [t.startswith(q) for t, q in zip(texts, prompts)] == [True] * 3


@pytest.mark.parametrize("batch,words,installs,flash_calls", [(2, 300, 1, 2), (30, 12, 0, 0)])
def test_generate_ids_prefill_rule(monkeypatch, batch, words, installs, flash_calls):
    """Prompts that share no prefix go through the engine's prefill: below
    batch 30 cache-free (K3's plain version at 256+ tokens, once per layer)
    and then installed; at 30 and above straight into the cache."""
    from radialog_tpu_torch.decode import engine as te_mod
    from radialog_tpu_torch.ops import flash_attention as tfa
    seen = {"install": 0, "flash": 0}
    install, plain = te_mod.install_prefill, tfa.flash_attention_plain

    def counted(name, fn):
        def call(*a, **kw):
            seen[name] += 1
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(te_mod, "install_prefill", counted("install", install))
    monkeypatch.setattr(tfa, "flash_attention_plain", counted("flash", plain))
    p = RaDialogPipeline(PipelineConfig(mock=True, device="cpu"))
    ids = [p.tokenizer(" ".join(f"p{j}w{i}" for i in range(words)))["input_ids"]
           for j in range(batch)]
    assert p._shared_prefix_len(ids, None)[0] == 1          # BOS only: below SHARED_PREFIX_MIN
    res = p.generate_ids(ids, None, p.decode_params(max_new_tokens=3, eos_token_id=-1))
    assert res.tokens.shape == (batch, 3) and bool((res.lengths == 3).all())
    assert seen == {"install": installs, "flash": flash_calls}


def test_mock_label_reports():
    p = RaDialogPipeline(PipelineConfig(mock=True, device="cpu"))
    labels = p.label_reports(["no acute process", "large effusion " * 100] + ["x"] * 17)
    assert labels.shape == (19, 14)
    assert set(np.unique(labels[~np.isnan(labels)])) <= {-1.0, 0.0, 1.0}
    assert np.isnan(labels[:, 13]).any() or (labels[:, 13] == 1).any()


def test_entry_points_default_to_the_card():
    """Every entry point that makes or moves parameters or tensors runs on
    the card unless the caller asks for the CPU."""
    import inspect
    from radialog_tpu_torch.models import chexbert as tcb
    from radialog_tpu_torch.apps.serve import RaDialogServer
    from radialog_tpu_torch.decode.continuous import RingBatcher
    from radialog_tpu_torch.decode.session import InteractiveSession
    from radialog_tpu_torch.decode.spec_ring import SpecCompactBatcher, SpecRingBatcher
    from radialog_tpu_torch.ops import quant as tquant
    fns = [tl.llama_init, tl.lora_init, tl.init_cache, tcb.chexbert_init, bridge.to_torch,
           bridge.packed_q8, bridge.packed_q4, tquant.quantize_llama_host,
           tquant.random_serving_params, RingBatcher.__init__, RaDialogServer.__init__,
           SpecRingBatcher.__init__, SpecCompactBatcher.__init__, InteractiveSession.__init__,
           bridge.llama_serving, bridge.llama, bridge.lora, bridge.biovil_t,
           bridge.qformer, bridge.chexpert, bridge.chexbert]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    assert PipelineConfig().device == "cuda"


def test_port_imports_no_jax():
    """The port, its tools and chip_smoke.py import neither jax, optax, orbax,
    radialog_tpu, pandas nor nltk (the card machine has neither of the
    last two)."""
    files = (sorted((REPO / "radialog_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "tools").glob("*torch*.py"))
             + [REPO / "tools" / f"{name}.py" for name in ("time_prefill_paths", "time_k2_phase",
                                                          "time_k4_phase")])
    assert len(files) > 15
    assert REPO / "radialog_tpu_torch" / "native" / "loader.py" in files
    assert {"continuous.py", "serve.py", "q4_matmul.py", "quant.py", "bridge.py",
            "chip_smoke.py", "finetune_lora.py", "optim.py", "steps.py", "checkpoint.py",
            "datasets.py", "flash_attention.py", "tokenization.py", "w4_colscale.py", "prng.py",
            "profile_torch_slice.py", "time_prefill_paths.py", "microbench_kvfused_torch.py",
            "microbench_w4_torch.py", "time_k4_phase.py", "conversation.py", "prompts.py",
            "downstream.py", "ce_metrics.py", "nlg.py", "_treebank.py", "_porter.py",
            "evaluate.py", "hf_weights.py", "beam.py", "speculative.py", "spec_ring.py",
            "session.py", "streaming.py", "chat.py", "config.py", "demo.py", "blip2.py",
            "qformer.py", "augment.py", "image.py", "loader.py", "prefetch.py", "runner.py",
            "logging.py", "pretrain.py"} <= \
        {f.name for f in files}
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "optax", "orbax", "radialog_tpu", "pandas",
                                    "nltk"), \
                    f"{f}: imports {n}"
