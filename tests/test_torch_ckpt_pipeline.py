"""The pipeline, the eval command line and the trainer of the port built from
checkpoint files, against the JAX package's built from the same files.

The files use the reference's formats and key names at tiny widths: an HF
LLaMA directory (two ``pytorch_model-*.bin`` shards and their index, fp16), a
PEFT adapter with ``adapter_config.json``, a LAVIS BLIP-2 ``.pth`` with
BioViL-T under ``visual_encoder.``, a Lightning classifier ``.ckpt``, a
CheXbert ``.pth`` with DataParallel's ``module.`` prefix and an emb_cache
npz. ``VICUNA_7B``, ``QFormerConfig`` and ``BertConfig`` are set to tiny
configs in the pipeline and trainer modules of both packages (their loaders
read them at call time; the converters' depth of 12 stays, as in JAX), and
both tokenizer loaders return the WhitespaceTokenizer. Nothing of
radialog_tpu is edited.

Checked: every parameter leaf bitwise at W8A8, W4A8 and f32; greedy tokens
equal to the jitted JAX pipeline's (FP32 policy); ``embed_images`` cache
hits; a table one row short of the vocab (JAX's ``jnp.take`` fills the
<IMG> row with NaN, which the splice overwrites; without image embeddings
the logits are NaN in both); the eval command line with every checkpoint
flag and beams; the trainer from the files with ``lora_weights``."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from radialog_tpu.apps import finetune_lora as jft  # noqa: E402
from radialog_tpu.apps import pipeline as jpipe  # noqa: E402
from radialog_tpu.data import tokenization as jtok  # noqa: E402
from radialog_tpu.decode import engine as je  # noqa: E402
from radialog_tpu.models import bert as jbert  # noqa: E402
from radialog_tpu.models import llama as jl  # noqa: E402
from radialog_tpu.models import qformer as jq  # noqa: E402
from radialog_tpu_torch import bridge  # noqa: E402
from radialog_tpu_torch.apps import evaluate as tev  # noqa: E402
from radialog_tpu_torch.apps import finetune_lora as tft  # noqa: E402
from radialog_tpu_torch.apps import pipeline as tpipe  # noqa: E402
from radialog_tpu_torch.apps import tokenization as ttok  # noqa: E402
from radialog_tpu_torch.decode import engine as te  # noqa: E402
from radialog_tpu_torch.models import bert as tbert  # noqa: E402
from radialog_tpu_torch.models import llama as tl  # noqa: E402
from radialog_tpu_torch.models import qformer as tq  # noqa: E402

import test_converter_contracts as contracts  # noqa: E402
import test_torch_hf_weights as thw  # noqa: E402
from test_torch_llama import packed_tree  # noqa: E402

VOCAB, H, INTER, LAYERS, NQ, QDIM, ENC = 256, 64, 128, 2, 4, 32, 16
LLAMA_KW = dict(vocab_size=VOCAB, hidden_size=H, num_layers=LAYERS, num_heads=4,
                num_kv_heads=4, intermediate_size=INTER, max_position=512,
                img_token_id=VOCAB - 1, num_img_tokens=NQ, qformer_dim=QDIM)
BERT_KW = dict(vocab_size=60, hidden_size=QDIM, num_layers=12, num_heads=4,
               intermediate_size=64, max_position=64)
QF_KW = dict(num_query_tokens=NQ, encoder_width=ENC)
J_LLAMA, T_LLAMA = jl.LlamaConfig(**LLAMA_KW), tl.LlamaConfig(**LLAMA_KW)
J_BERT, T_BERT = jbert.BertConfig(**BERT_KW), tbert.BertConfig(**BERT_KW)
J_QF = jq.QFormerConfig(bert=jbert.BertConfig(**{**BERT_KW, "vocab_size": 50}), **QF_KW)
T_QF = tq.QFormerConfig(bert=tbert.BertConfig(**{**BERT_KW, "vocab_size": 50}), **QF_KW)
DICOMS = ("dcm000", "dcm001", "dcm002", "dcm003", "dcm004", "dcm005")


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


# ------------------------------------------------------------------- files
def write_checkpoints(root, vocab_rows=VOCAB):
    """Every checkpoint family in the reference's format under ``root``."""
    root.mkdir(parents=True, exist_ok=True)
    vic = root / "vicuna"
    vic.mkdir()
    sd = thw.llama_sd(layers=LAYERS, h=H, inter=INTER, vocab=VOCAB, dtype=torch.float16,
                      img=False, seed=5)
    sd["model.embed_tokens.weight"] = sd["model.embed_tokens.weight"][:vocab_rows].clone()
    keys = sorted(sd)
    shards = {"pytorch_model-00001-of-00002.bin": keys[:len(keys) // 2],
              "pytorch_model-00002-of-00002.bin": keys[len(keys) // 2:]}
    for name, ks in shards.items():
        torch.save({k: sd[k] for k in ks}, vic / name)
    (vic / "pytorch_model.bin.index.json").write_text(json.dumps(
        {"weight_map": {k: n for n, ks in shards.items() for k in ks}}))
    ad = root / "adapter"
    ad.mkdir()
    lora = thw.peft_sd(layers=LAYERS, h=H, rank=4, seed=6)
    g = torch.Generator().manual_seed(8)
    lora["base_model.model.model.img_proj_layer.weight"] = \
        torch.randn(H, QDIM, generator=g) * QDIM ** -0.5
    lora["base_model.model.model.img_proj_layer.bias"] = torch.randn(H, generator=g) * 0.02
    torch.save(lora, ad / "adapter_model.bin")
    (ad / "adapter_config.json").write_text(json.dumps({"r": 4, "lora_alpha": 16}))
    blip2 = thw.randomized(contracts._qformer_state_dict(J_QF), 7)
    for name, o, i in (("vision_proj", 8, QDIM), ("text_proj", 8, QDIM), ("itm_head", 2, QDIM)):
        blip2[f"{name}.weight"] = torch.randn(o, i, generator=g) * 0.1
        blip2[f"{name}.bias"] = torch.randn(o, generator=g) * 0.1
    blip2["ln_vision.weight"] = 1 + 0.1 * torch.randn(ENC, generator=g)
    blip2["ln_vision.bias"] = 0.1 * torch.randn(ENC, generator=g)
    blip2["temp"] = torch.tensor(0.07)
    blip2.update(thw.biovil_sd("visual_encoder.", j=ENC))
    torch.save({"model": blip2, "config": {"arch": "blip2"}}, root / "blip2.pth")
    cls = thw.biovil_sd("model.biovil_encoder.", j=128)
    cls.update({"model.fc1.weight": torch.randn(16, 2048, generator=g) * 0.02,
                "model.fc1.bias": torch.randn(16, generator=g) * 0.02,
                "model.fc2.weight": torch.randn(14, 16, generator=g) * 0.2,
                "model.fc2.bias": torch.randn(14, generator=g) * 0.2})
    torch.save({"state_dict": cls, "hyper_parameters": {"lr": 1e-4}}, root / "cls.ckpt")
    with torch.random.fork_rng():      # every file the same in every run
        torch.manual_seed(10)
        hf_bert = transformers.BertModel(transformers.BertConfig(
            vocab_size=60, hidden_size=QDIM, num_hidden_layers=12, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=64)).eval()
    chex = {f"module.bert.{k}": v for k, v in hf_bert.state_dict().items()}
    for i in range(14):
        chex[f"module.linear_heads.{i}.weight"] = torch.randn(2 if i == 13 else 4, QDIM,
                                                              generator=g)
        chex[f"module.linear_heads.{i}.bias"] = torch.randn(2 if i == 13 else 4, generator=g)
    torch.save({"model_state_dict": chex}, root / "chexbert.pth")
    rng = np.random.default_rng(9)
    np.savez(root / "emb_cache.npz", **{d: rng.normal(size=(NQ, QDIM)).astype(np.float32)
                                        for d in DICOMS})
    return {"vicuna_path": str(vic), "lora_path": str(ad / "adapter_model.bin"),
            "blip2_checkpoint": str(root / "blip2.pth"),
            "classifier_checkpoint": str(root / "cls.ckpt"),
            "chexbert_checkpoint": str(root / "chexbert.pth"),
            "emb_cache": str(root / "emb_cache.npz")}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_checkpoints(tmp_path_factory.mktemp("ckpt"))


@pytest.fixture(scope="module")
def short_files(tmp_path_factory):
    """The embedding table one row short of the vocab: no row for <IMG>."""
    return write_checkpoints(tmp_path_factory.mktemp("ckpt_short"), vocab_rows=VOCAB - 1)


@pytest.fixture(scope="module")
def tiny():
    """Tiny configs and the WhitespaceTokenizer in both packages' loaders."""
    mp = pytest.MonkeyPatch()
    for mod, cfg, q, b in ((jpipe, J_LLAMA, J_QF, J_BERT), (tpipe, T_LLAMA, T_QF, T_BERT)):
        mp.setattr(mod, "VICUNA_7B", cfg)
        mp.setattr(mod, "QFormerConfig", lambda q=q: q)
        mp.setattr(mod, "BertConfig", lambda *a, b=b, **k: b)
    mp.setattr(jft, "VICUNA_7B", J_LLAMA)
    mp.setattr(tft, "VICUNA_7B", T_LLAMA)
    vic = dict(vocab_size=VOCAB, num_img_tokens=NQ, img_token_id=VOCAB - 1)
    mp.setattr(jpipe, "load_vicuna_tokenizer", lambda path: jtok.WhitespaceTokenizer(**vic))
    mp.setattr(jtok, "load_vicuna_tokenizer", lambda path: jtok.WhitespaceTokenizer(**vic))
    mp.setattr(ttok, "load_vicuna_tokenizer", lambda path: ttok.WhitespaceTokenizer(**vic))
    mp.setattr(transformers.AutoTokenizer, "from_pretrained",
               lambda path, **k: jtok.WhitespaceTokenizer(vocab_size=60))
    mp.setattr(ttok, "load_bert_tokenizer", lambda path=None: ttok.WhitespaceTokenizer(vocab_size=60))
    yield
    mp.undo()


def build(files, **kw):
    """(JAX pipeline, port pipeline) from the same files and settings."""
    j = jpipe.RaDialogPipeline(jpipe.PipelineConfig(**files, **kw))
    t = tpipe.RaDialogPipeline(tpipe.PipelineConfig(**files, **kw, device="cpu"))
    return j, t


@pytest.fixture(scope="module")
def w8a8(tiny, files):
    return build(files, quantize=True, bf16=False)


@pytest.fixture(scope="module")
def f32(tiny, files):
    return build(files, quantize=False, bf16=False)


# --------------------------------------------------------------- the leaves
def assert_leaves_bitwise(port, ref):
    """Every leaf bitwise, dtype alike; BioViL-T's computed sine table
    (``_pos``, not read from a file) as test_torch_hf_weights.py holds it."""
    p, r = thw.flat(port), thw.flat(bridge.to_torch(_np(ref), device="cpu"))
    assert p.keys() == r.keys()
    for k in r:
        if k.endswith("/_pos"):
            thw._vit_pos_equal(p[k], r[k].numpy())
        else:
            assert p[k].dtype == r[k].dtype and torch.equal(p[k], r[k]), k


def assert_components_bitwise(j, t):
    """Every loaded component but the LLaMA, leaf for leaf."""
    for name in ("lora", "blip2", "visual", "visual_state", "classifier", "classifier_state",
                 "chexbert"):
        assert_leaves_bitwise(getattr(t, name), getattr(j, name))
    assert len(t.emb_cache) == len(j.emb_cache) == len(DICOMS)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_leaves_are_jax_s(tiny, files, bits):
    j, t = build(files, quantize=True, weight_bits=bits)
    want = bridge.llama_serving(packed_tree(j.llama), T_LLAMA, device="cpu")
    got = t.llama
    for i in range(LAYERS):
        for name in ("wqkv", "gateup", "wo", "down"):
            a, b = got["layers"][i][name], want["layers"][i][name]
            assert type(a) is type(b) and (bits == 8) == (type(a).__name__ == "PackedQ8")
            for f in dataclasses.fields(a):
                x, y = getattr(a, f.name), getattr(b, f.name)
                same = torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                assert same, (i, name, f.name)
        for name in ("input_ln", "post_ln"):
            assert torch.equal(got["layers"][i][name], want["layers"][i][name])
    assert torch.equal(got["lm_head"].w, want["lm_head"].w)
    assert torch.equal(got["lm_head"].scale, want["lm_head"].scale)
    assert torch.equal(got["embed"], want["embed"]) and got["embed"].dtype == torch.bfloat16
    assert torch.equal(got["final_ln"], want["final_ln"])
    assert_components_bitwise(j, t)
    assert t.lora["scale"].dtype == torch.bfloat16       # the policy's dtype, as JAX casts it


def test_f32_leaves_are_jax_s(f32):
    j, t = f32
    assert_leaves_bitwise(t.llama, j.llama)
    assert t.llama["layers"]["wq"]["w"].dtype == torch.float32
    assert_components_bitwise(j, t)


# -------------------------------------------------------------- generation
def _prompts(n=3):
    return [f"sys a b c <IMG> <IMG> <IMG> <IMG> w{j} x{j} " + " ".join(f"y{i}" for i in range(j))
            for j in range(n)]


@pytest.mark.parametrize("layout", ["w8a8", "f32"])
def test_greedy_tokens_match_jax(layout, w8a8, f32):
    j, t = w8a8 if layout == "w8a8" else f32
    embs = np.random.default_rng(0).normal(size=(3, NQ, QDIM)).astype(np.float32)
    want = j.generate_texts(_prompts(), img_embs=jnp.asarray(embs), max_new_tokens=8)
    got = t.generate_texts(_prompts(), img_embs=torch.from_numpy(embs), max_new_tokens=8)
    assert got == want


def test_embed_images_returns_cache_hits(f32):
    j, t = f32
    images = np.random.default_rng(1).random((2, 64, 64, 3)).astype(np.float32)
    got = t.embed_images(torch.from_numpy(images), dicoms=["dcm001", "dcm004"])
    want = j.embed_images(images, dicoms=["dcm001", "dcm004"])
    assert torch.equal(got, torch.from_numpy(np.asarray(want)))
    assert torch.equal(got[1], torch.from_numpy(t.emb_cache["dcm004"]))
    # one dicom missing: the image goes through BioViL-T and the Q-Former
    mixed = t.embed_images(torch.from_numpy(images), dicoms=["dcm001", "nope"])
    jmixed = j.embed_images(images, dicoms=["dcm001", "nope"])
    assert mixed.shape == (2, NQ, QDIM)
    np.testing.assert_allclose(mixed.numpy(), np.asarray(jmixed), rtol=1e-4, atol=1e-4)


def _first_logits(j, t, ids, embs):
    toks, lens = ttok.pad_batch_right(ids, 0)
    jargs = (j.llama, J_LLAMA, jnp.asarray(toks), jnp.asarray(lens), toks.shape[1] + 4)
    jprefill = jax.jit(je.prefill, static_argnums=(1, 4), static_argnames=("policy",))
    _, jl_ = jprefill(*jargs, img_embs=None if embs is None else jnp.asarray(embs),
                      lora=j.lora, policy=j.policy)
    with torch.no_grad():
        _, tl_ = te.prefill(t.llama, T_LLAMA, torch.from_numpy(toks), torch.from_numpy(lens),
                            toks.shape[1] + 4, img_embs=None if embs is None else
                            torch.from_numpy(embs), lora=t.lora, policy=t.policy,
                            kv_int8=t.cfg.use_kv_int8())
    return np.asarray(jl_), tl_.numpy()


def test_a_table_one_row_short(tiny, short_files):
    """Vicuna-7B v1.3 has 32,000 embedding rows under vocab 32,001: the
    <IMG> id reads a row of NaN (jnp.take's fill), which the image splice
    overwrites; without image embeddings JAX's logits are NaN, and so are
    the port's. No index leaves the table."""
    j, t = build(short_files, quantize=False, bf16=False)
    assert t.llama["embed"].shape[0] == VOCAB - 1
    ids = [t.tokenizer(p)["input_ids"] for p in _prompts(2)]
    embs = np.random.default_rng(2).normal(size=(2, NQ, QDIM)).astype(np.float32)
    want, got = _first_logits(j, t, ids, embs)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    want, got = _first_logits(j, t, ids, None)
    assert np.isnan(want).all() and np.isnan(got).all()
    texts = t.generate_texts(_prompts(2), img_embs=torch.from_numpy(embs), max_new_tokens=6)
    assert texts == j.generate_texts(_prompts(2), img_embs=jnp.asarray(embs), max_new_tokens=6)


def test_a_table_one_row_short_at_w8a8(tiny, short_files):
    j, t = build(short_files, quantize=True, bf16=False)
    embs = np.random.default_rng(3).normal(size=(3, NQ, QDIM)).astype(np.float32)
    got = t.generate_texts(_prompts(), img_embs=torch.from_numpy(embs), max_new_tokens=6)
    assert got == j.generate_texts(_prompts(), img_embs=jnp.asarray(embs), max_new_tokens=6)


def test_pipeline_refusals_match_jax(tiny):
    with pytest.raises(ValueError, match="vicuna_path required"):
        tpipe.RaDialogPipeline(tpipe.PipelineConfig(device="cpu"))
    with pytest.raises(ValueError, match="vicuna_path required"):
        jpipe.RaDialogPipeline(jpipe.PipelineConfig())
    with pytest.raises(ValueError, match="one of mock"):
        tpipe.RaDialogPipeline(tpipe.PipelineConfig(mock=True, synthetic=True, device="cpu"))


def test_components_without_a_checkpoint_keep_their_init(tiny, files):
    only = {"vicuna_path": files["vicuna_path"]}
    t = tpipe.RaDialogPipeline(tpipe.PipelineConfig(**only, quantize=False, device="cpu"))
    assert set(t.blip2) == {"qformer", "ln_vision"} and t.visual is not None
    assert t.lora["layers"]["wq"]["b"].abs().max() == 0          # lora_init's zero B
    assert isinstance(t.bert_tokenizer, ttok.WhitespaceTokenizer) and t.emb_cache == {}


# ------------------------------------------------------------ command line
@pytest.fixture(scope="module")
def cli_runs(tiny, files, tmp_path_factory):
    """The root test.py and the port's main with every checkpoint flag and
    beams over 2 fixture studies, on the float pipeline (FP32 by bf16=False
    is not a flag: both run bf16 weights, compared as files)."""
    import runpy
    import sys
    from pathlib import Path
    out = tmp_path_factory.mktemp("cli")
    repo = Path(__file__).resolve().parents[1]
    flags = ["--vicuna_path", files["vicuna_path"], "--lora_model", files["lora_path"],
             "--blip2_checkpoint", files["blip2_checkpoint"],
             "--chexbert_checkpoint", files["chexbert_checkpoint"],
             "--emb_cache", files["emb_cache"], "--use_embs", "--num_beams", "2",
             "--fixture-dir", str(repo / "tests" / "fixtures"), "--truncate", "2",
             "--max_new_tokens", "6"]
    port = tev.main([*flags, "--device", "cpu", "--output_dir", str(out / "port")])
    argv = sys.argv
    sys.argv = ["test.py", *flags, "--output_dir", str(out / "jax")]
    try:
        runpy.run_path(str(repo / "test.py"), run_name="__main__")
    finally:
        sys.argv = argv
    return out, port


def test_cli_with_checkpoints_and_beams_matches_root_test_py(cli_runs):
    out, port = cli_runs
    exp = "img_matching_examples_ig2_noexamples_IMG_findings_embs"
    for name in ("predictions_{}.csv", "labels_{}.csv", "results_{}.txt"):
        f = name.format(exp)
        assert (out / "port" / f).read_bytes() == (out / "jax" / f).read_bytes(), f
    assert port and all(np.isfinite(v) for v in port.values())


def test_cli_emb_provider_reads_the_cache_first(tiny, files):
    t = tpipe.RaDialogPipeline(tpipe.PipelineConfig(**files, quantize=False, device="cpu"))
    provider = tev.mock_emb_provider(NQ, QDIM, t.emb_cache)
    got = provider(["dcm002", "not-cached"])
    assert np.array_equal(got[0], t.emb_cache["dcm002"])
    assert np.array_equal(got[1], tev.mock_emb_provider(NQ, QDIM)(["not-cached"])[0])


# ----------------------------------------------------------------- trainer
TRAIN = dict(micro_batch_size=8, batch_size=16, max_steps=2, num_epochs=2, cutoff_len=64,
             use_embs=True)


@pytest.fixture(scope="module")
def train_runs(tiny, files, tmp_path_factory):
    """JAX's and the port's train from the Vicuna files and the adapter,
    the same batches (one seed), bf16 base as in JAX."""
    from pathlib import Path
    out = tmp_path_factory.mktemp("train")
    data = str(Path(__file__).resolve().parent / "fixtures" / "instruct.json")
    kw = dict(base_model=files["vicuna_path"], lora_weights=files["lora_path"], lora_r=4,
              data_path=data, **TRAIN)
    jlogs, tlogs, tsteps = [], [], []
    jstate = jft.train(jft.FinetuneConfig(output_dir=str(out / "jax"), **kw), log_fn=jlogs.append)
    tstate = tft.train(tft.FinetuneConfig(output_dir=str(out / "port"), device="cpu", **kw),
                       log_fn=tlogs.append,
                       on_step=lambda s, m: tsteps.append(float(m["loss"])))
    return jlogs, tlogs, tsteps, jstate, tstate


def test_train_from_files_matches_jax(train_runs):
    jlogs, tlogs, tsteps, jstate, tstate = train_runs
    jl_ = [m for m in jlogs if "loss" in m or "val_loss" in m]
    tl_ = [m for m in tlogs if "loss" in m or "val_loss" in m]
    assert len(tsteps) == 2 and tstate.step == int(jstate.step) == 2
    assert abs(tl_[0]["loss"] - jl_[0]["loss"]) < TRAIN_LOSS_TOL
    assert abs(tl_[1]["val_loss"] - jl_[1]["val_loss"]) < TRAIN_LOSS_TOL
    got, want = thw.flat(tstate.params), thw.flat(bridge.to_torch(_np(jstate.params), "cpu"))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(), want[k].float().numpy(), rtol=0,
                                   atol=TRAIN_TREE_TOL, err_msg=k)


# BF16 on both sides, matmuls rounded in another order: measured on the CPU
# 4.7e-5 in the first loss, 2.7e-5 in the validation loss, 5.2e-4 in the
# LoRA tree after two updates (img_proj's w); the bounds are ~4x that
TRAIN_LOSS_TOL, TRAIN_TREE_TOL = 2e-4, 2e-3


# -------------------------------------------------------- the two repairs
def test_embedding_lookup_is_jnp_take():
    """ops/layers.embedding_lookup reads rows as jnp.take does: a negative id
    from the end, an id past the table a row of NaN; no index leaves it."""
    from radialog_tpu.ops.layers import embedding_lookup as jlookup
    from radialog_tpu_torch.ops.layers import embedding_lookup as tlookup
    table = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    ids = np.asarray([[0, 4, 5, -1], [-5, -6, 9, 2]], np.int32)
    for dtype in (torch.float32, torch.bfloat16):
        got = tlookup(torch.from_numpy(table).to(dtype), torch.from_numpy(ids))
        want = np.asarray(jlookup(jnp.asarray(table, dtype=jnp.dtype(str(dtype)[6:])),
                                  jnp.asarray(ids)).astype(jnp.float32))
        assert got.dtype == dtype and got.shape == (2, 4, 3)
        np.testing.assert_array_equal(got.float().numpy(), want)     # NaN where JAX's are
    assert np.isnan(want[0, 2]).all() and np.isnan(want[1, 1]).all()


class _LayersOnly:
    """A stacked leaf that hands out one layer at a time and refuses to be
    converted whole."""

    def __init__(self, x):
        self.x = x

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        assert isinstance(i, int), "only one layer at a time"
        return self.x[i]

    def __array__(self, *a, **k):
        raise AssertionError("the whole stack was converted")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("leaves", ["numpy", "tensor_f32", "tensor_f16"])
def test_quantize_llama_host_slices_each_layer_first(bits, leaves):
    """ops/quant.quantize_llama_host converts one layer of each stacked leaf
    at a time, and its output is bitwise what it was: the JAX packer's, as
    the stacks converted whole and then sliced gave it."""
    from radialog_tpu.ops.quant import quantize_llama_host as jquantize
    from radialog_tpu_torch.ops.quant import quantize_llama_host
    params = _np(jl.llama_init(jax.random.PRNGKey(4), jl.TINY_LLAMA))
    if leaves == "tensor_f16":      # values an fp16 checkpoint holds, in both
        params = jax.tree_util.tree_map(lambda x: x.astype(np.float16).astype(np.float32),
                                        params)
    want = bridge.llama_serving(packed_tree(jquantize(params, bits=bits)), tl.TINY_LLAMA,
                                device="cpu")
    conv = {"numpy": lambda x: x, "tensor_f32": torch.from_numpy,
            "tensor_f16": lambda x: torch.from_numpy(x).half()}[leaves]
    src = jax.tree_util.tree_map(conv, params)
    src["layers"] = {k: ({n: _LayersOnly(v) for n, v in leaf.items()} if isinstance(leaf, dict)
                         else _LayersOnly(leaf)) for k, leaf in src["layers"].items()}
    got = quantize_llama_host(src, device="cpu", bits=bits)
    assert thw.flat(got).keys() == thw.flat(want).keys()
    for i, (lg, lw) in enumerate(zip(got["layers"], want["layers"])):
        for name in ("wqkv", "gateup", "wo", "down"):
            for f in dataclasses.fields(lg[name]):
                x, y = getattr(lg[name], f.name), getattr(lw[name], f.name)
                assert (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y), (i, name)
        assert torch.equal(lg["input_ln"], lw["input_ln"])
    for name in ("embed", "final_ln"):
        assert torch.equal(got[name], want[name])
    assert torch.equal(got["lm_head"].w, want["lm_head"].w)
