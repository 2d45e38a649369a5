"""The port's checkpoint converters and file readers
(radialog_tpu_torch/utils/hf_weights.py) against the JAX package's
(radialog_tpu/utils/hf_weights.py), on synthetic state dicts with the
reference's key names, and the tokenizer loaders against JAX's.

Converters: the same keys and every leaf bitwise (``np.array_equal`` on the
values; a leaf keeps an fp16 or bf16 source's dtype where JAX holds the
same values in f32), from fp16 and from f32 sources. Forward parity with
HF: a tiny ``LlamaForCausalLM`` (with a PEFT adapter) and a ``BertModel``
through the port's converter and forward, within the bar of
tests/test_hf_parity.py (atol 2e-4, rtol 1e-3)."""
import json

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from radialog_tpu.data import tokenization as jtok  # noqa: E402
from radialog_tpu.utils import hf_weights as jhf  # noqa: E402
from radialog_tpu.apps import pipeline as jpipe  # noqa: E402
from radialog_tpu_torch import bridge  # noqa: E402
from radialog_tpu_torch.apps import tokenization as ttok  # noqa: E402
from radialog_tpu_torch.models import bert as tbert  # noqa: E402
from radialog_tpu_torch.models import llama as tl  # noqa: E402
from radialog_tpu_torch.utils import hf_weights as thf  # noqa: E402

import test_converter_contracts as contracts  # noqa: E402
from radialog_tpu.models.bert import BertConfig as JBertConfig  # noqa: E402
from radialog_tpu.models.qformer import QFormerConfig as JQFormerConfig  # noqa: E402

ATOL, RTOL = 2e-4, 1e-3


# ------------------------------------------------------------------ helpers
def flat(tree, prefix=""):
    """{path: leaf} of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def assert_same_tree(port, ref, src_dtype=torch.float32):
    """Every leaf of ``port`` (tensors) equals the JAX converter's (numpy)
    bitwise, keys and shapes alike; each is f32 or the source's dtype."""
    p, r = flat(port), flat(ref)
    assert p.keys() == r.keys()
    for k in r:
        want = np.asarray(r[k])
        got = p[k]
        assert isinstance(got, torch.Tensor), k
        assert tuple(got.shape) == want.shape, k
        assert got.dtype in (torch.float32, src_dtype), (k, got.dtype)
        assert np.array_equal(got.float().numpy(), want.astype(np.float32)), k


def randomized(sd, seed=0, dtype=torch.float32):
    """Every float entry of ``sd`` redrawn (running_var positive), so that no
    two leaves are alike and a swapped key shows; cast to ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in sd.items():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            x = torch.randn(v.shape, generator=g) * 0.1
            if k.endswith("running_var"):
                x = x.abs() + 0.5
            v = x.to(dtype)
        out[k] = v
    return out


def llama_sd(layers=2, h=16, inter=24, vocab=40, dtype=torch.float32, img=True, seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return (torch.randn(shape, generator=g) * 0.1).to(dtype)
    sd = {"model.embed_tokens.weight": r(vocab, h), "model.norm.weight": r(h),
          "lm_head.weight": r(vocab, h)}
    for i in range(layers):
        p = f"model.layers.{i}."
        for n in ("q", "k", "v", "o"):
            sd[p + f"self_attn.{n}_proj.weight"] = r(h, h)
        sd[p + "mlp.gate_proj.weight"] = r(inter, h)
        sd[p + "mlp.up_proj.weight"] = r(inter, h)
        sd[p + "mlp.down_proj.weight"] = r(h, inter)
        sd[p + "input_layernorm.weight"] = r(h)
        sd[p + "post_attention_layernorm.weight"] = r(h)
    if img:
        sd["model.img_proj_layer.weight"] = r(h, 12)
        sd["model.img_proj_layer.bias"] = r(h)
    return sd


def peft_sd(layers=2, h=16, rank=4, fmt="lora_A.weight", prefix="base_model.model.model.",
            targets=("q", "v"), dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for i in range(layers):
        for t in targets:
            base = f"base_model.model.model.layers.{i}.self_attn.{t}_proj"
            sd[f"{base}.{fmt}"] = torch.randn(rank, h, generator=g).to(dtype)
            sd[f"{base}.{fmt.replace('A', 'B')}"] = torch.randn(h, rank, generator=g).to(dtype)
    sd[f"{prefix}img_proj_layer.weight"] = torch.randn(h, 12, generator=g).to(dtype)
    sd[f"{prefix}img_proj_layer.bias"] = torch.randn(h, generator=g).to(dtype)
    return sd


def qformer_cfg(layers=4):
    return JQFormerConfig(bert=JBertConfig(vocab_size=50, hidden_size=16, num_layers=layers,
                                           num_heads=4, intermediate_size=24, max_position=20),
                          num_query_tokens=6, encoder_width=12)


def blip2_sd(dtype=torch.float32, layers=4, vision=True):
    sd = randomized(contracts._qformer_state_dict(qformer_cfg(layers)), 1, dtype)
    g = torch.Generator().manual_seed(2)
    sd.update({"ln_vision.weight": torch.randn(12, generator=g).to(dtype),
               "ln_vision.bias": torch.randn(12, generator=g).to(dtype),
               "vision_proj.weight": torch.randn(8, 16, generator=g).to(dtype),
               "vision_proj.bias": torch.randn(8, generator=g).to(dtype),
               "text_proj.weight": torch.randn(8, 16, generator=g).to(dtype),
               "text_proj.bias": torch.randn(8, generator=g).to(dtype),
               "itm_head.weight": torch.randn(2, 16, generator=g).to(dtype),
               "itm_head.bias": torch.randn(2, generator=g).to(dtype),
               "temp": torch.tensor(0.07).to(dtype)})
    if vision:
        sd.update(biovil_sd("visual_encoder.", dtype, j=12))
    return sd


def biovil_sd(prefix="", dtype=torch.float32, j=8):
    sd = randomized(contracts._biovil_state_dict(j=j), 3, dtype)
    return {prefix + k: v for k, v in sd.items()}


@pytest.fixture(scope="module")
def _biovil_base():
    return biovil_sd()


# --------------------------------------------------------------- converters
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_convert_llama_matches_jax(dtype):
    sd = llama_sd(dtype=dtype)
    got = thf.convert_llama(sd, 2)
    assert_same_tree(got, jhf.convert_llama(sd, 2), dtype)
    assert got["layers"]["wq"]["w"].dtype == dtype       # the checkpoint's dtype is kept
    assert "img_proj" in got and "img_proj" not in thf.convert_llama(llama_sd(img=False), 2)


def test_convert_llama_keeps_bf16_and_widens_others():
    sd = llama_sd(dtype=torch.bfloat16)
    got = thf.convert_llama(sd, 2)
    assert got["embed"].dtype == torch.bfloat16
    assert_same_tree(got, jhf.convert_llama(sd, 2), torch.bfloat16)
    sd64 = llama_sd(dtype=torch.float64)
    got = thf.convert_llama(sd64, 2)
    assert got["embed"].dtype == torch.float32             # as t2n's .float()
    assert_same_tree(got, jhf.convert_llama(sd64, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_convert_llama_per_layer_views_are_the_stack(dtype):
    """convert_llama(stack=False): layer i of the stacked tree, each leaf a
    view of the state dict's tensor (no copy on the host)."""
    sd = llama_sd(dtype=dtype)
    stacked, views = thf.convert_llama(sd, 2), thf.convert_llama(sd, 2, stack=False)
    assert views.keys() == stacked.keys() and len(views["layers"]) == 2
    want = flat(stacked["layers"])
    for i, layer in enumerate(views["layers"]):
        got = flat(layer)
        assert got.keys() == want.keys()
        for k, v in got.items():
            assert v.dtype == dtype and torch.equal(v, want[k][i]), (i, k)
        for k, key in thf._LLAMA_PROJ.items():
            src = sd[f"model.layers.{i}.{key}.weight"]
            assert layer[k]["w"].data_ptr() == src.data_ptr()
    for k in ("embed", "final_ln", "lm_head", "img_proj"):
        assert flat(views[k]).keys() == flat(stacked[k]).keys()
        assert all(torch.equal(a, b) for a, b in zip(flat(views[k]).values(),
                                                     flat(stacked[k]).values()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stack_layers_is_the_stack_cast(dtype):
    """stack_layers fills the stacked tree one layer at a time: bitwise the
    stacked converter's output cast to ``dtype``."""
    sd = llama_sd(dtype=torch.float16)
    want = flat(thf.convert_llama(sd, 2)["layers"])
    got = flat(thf.stack_layers(thf.convert_llama(sd, 2, stack=False)["layers"], "cpu", dtype))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == dtype and torch.equal(got[k], want[k].to(dtype)), k


def _same_serving_tree(a, b):
    import dataclasses
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(_same_serving_tree(getattr(a, f.name), getattr(b, f.name))
                                          for f in dataclasses.fields(a))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_serving_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same_serving_tree, a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("quantizer", ["quantize_llama_host", "quantize_llama_np"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_quantizers_take_per_layer_views(quantizer, dtype):
    """ops/quant's serving and training quantizers give the same bytes from
    convert_llama(stack=False)'s per-layer views as from the stacked tree."""
    from radialog_tpu_torch.ops import quant
    sd = llama_sd(dtype=dtype)
    fn = getattr(quant, quantizer)
    assert _same_serving_tree(fn(thf.convert_llama(sd, 2, stack=False), device="cpu"),
                              fn(thf.convert_llama(sd, 2), device="cpu"))


@pytest.mark.parametrize("fmt", ["lora_A.weight", "lora_A.default.weight"])
@pytest.mark.parametrize("prefix", ["base_model.model.model.", "base_model.model."])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_convert_peft_lora_matches_jax(fmt, prefix, dtype):
    sd = peft_sd(fmt=fmt, prefix=prefix, dtype=dtype)
    got = thf.convert_peft_lora(sd, 2)
    assert_same_tree(got, jhf.convert_peft_lora(sd, 2), dtype)
    assert set(got["layers"]) == {"wq", "wv"} and "img_proj" in got


@pytest.mark.parametrize("kw, scale", [
    ({}, 16.0 / 4),                                            # rank from shapes, alpha 16
    ({"adapter_config": {"r": 4, "lora_alpha": 32}}, 32.0 / 4),
    ({"alpha": 8.0, "adapter_config": {"lora_alpha": 32}}, 8.0 / 4),   # the argument first
    ({"rank": 4, "alpha": 4.0}, 1.0),
])
def test_peft_rank_and_alpha_resolve_as_jax(kw, scale):
    sd = peft_sd(rank=4)
    got = thf.convert_peft_lora(sd, 2, **kw)
    assert float(got["scale"]) == scale == float(jhf.convert_peft_lora(sd, 2, **kw)["scale"])
    assert got["scale"].dtype == torch.float32


def test_peft_no_layers_takes_the_reference_defaults():
    sd = {"base_model.model.model.img_proj_layer.weight": torch.ones(4, 3),
          "base_model.model.model.img_proj_layer.bias": torch.ones(4)}
    got, want = thf.convert_peft_lora(sd, 2), jhf.convert_peft_lora(sd, 2)
    assert float(got["scale"]) == float(want["scale"]) == 2.0 and got["layers"] == {}


@pytest.mark.parametrize("case, match", [
    ("mismatch", "rank mismatch"), ("inconsistent", "inconsistent LoRA ranks"),
    ("missing", "missing LoRA layers")])
def test_peft_errors_match_jax(case, match):
    if case == "mismatch":
        sd, kw = peft_sd(rank=4), {"adapter_config": {"r": 8, "lora_alpha": 16}}
    elif case == "inconsistent":
        sd = {**peft_sd(rank=4, targets=("q",)), **peft_sd(rank=2, targets=("v",))}
        kw = {}
    else:
        sd = peft_sd(layers=1)
        kw = {}
    for fn in (thf.convert_peft_lora, jhf.convert_peft_lora):
        with pytest.raises(ValueError, match=match):
            fn(sd, 2, **kw)


@pytest.fixture(scope="module")
def hf_bert():
    cfg = transformers.BertConfig(vocab_size=130, hidden_size=48, num_hidden_layers=2,
                                  num_attention_heads=4, intermediate_size=96,
                                  max_position_embeddings=32, attn_implementation="eager")
    torch.manual_seed(0)
    return transformers.BertModel(cfg).eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("with_pooler", [False, True])
def test_convert_bert_matches_jax(hf_bert, dtype, with_pooler):
    sd = {k: v.to(dtype) if v.is_floating_point() else v for k, v in hf_bert.state_dict().items()}
    got = thf.convert_bert(sd, 2, prefix="", with_pooler=with_pooler)
    assert_same_tree(got, jhf.convert_bert(sd, 2, prefix="", with_pooler=with_pooler), dtype)
    assert ("pooler" in got) == with_pooler


class _Labeler(torch.nn.Module):
    def __init__(self, bert):
        super().__init__()
        self.bert = bert
        self.linear_heads = torch.nn.ModuleList(
            [torch.nn.Linear(48, 4) for _ in range(13)] + [torch.nn.Linear(48, 2)])


@pytest.mark.parametrize("data_parallel", [False, True])
def test_convert_chexbert_matches_jax(hf_bert, data_parallel):
    torch.manual_seed(1)
    sd = _Labeler(hf_bert).state_dict()
    if data_parallel:
        sd = {f"module.{k}": v for k, v in sd.items()}
    got = thf.convert_chexbert(sd, num_layers=2)
    assert_same_tree(got, jhf.convert_chexbert(sd, num_layers=2))
    assert len(got["heads"]) == 14 and got["heads"][13]["w"].shape == (48, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_convert_qformer_matches_jax(dtype):
    sd = randomized(contracts._qformer_state_dict(qformer_cfg()), 1, dtype)
    got = thf.convert_qformer(sd, num_layers=4)
    assert_same_tree(got, jhf.convert_qformer(sd, num_layers=4), dtype)
    assert ["cross" in lp for lp in got["layers"]] == [True, False, True, False]


def _vit_pos_equal(got, want):
    """The pooler's sine table is computed, not read: the port's torch table
    against JAX's. They part by up to 1.5e-4 in some runs of this file and
    of test_torch_ckpt_pipeline.py (measured on the CPU; the cause is not
    found, ROADMAP.md queue 3); only a prior image, which RaDialog never
    passes, reads the table."""
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=5e-4)


def _split_pos(tree):
    """(tree without the computed sine tables, [tables]) of a biovil tree."""
    pos = []

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items() if not (k == "_pos" and pos.append(v) is None)}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t
    return walk(tree), pos


@pytest.mark.parametrize("vision", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_convert_blip2_matches_jax(vision, dtype):
    sd = blip2_sd(dtype, vision=vision)
    sd["config"] = {"not": "a tensor"}     # LAVIS checkpoints carry such entries
    got, got_s = thf.convert_blip2(sd, num_layers=4)
    want, want_s = jhf.convert_blip2(sd, num_layers=4)
    (got, gpos), (want, wpos) = _split_pos(got), _split_pos(want)
    assert_same_tree(got, want, dtype)
    assert_same_tree(got_s, want_s, dtype)
    assert ("visual" in got) == vision and len(gpos) == len(wpos) == int(vision)
    for a, b in zip(gpos, wpos):
        _vit_pos_equal(a, b)


@pytest.mark.parametrize("prefix", ["", "visual_encoder.", "model.biovil_encoder."])
def test_convert_biovil_t_matches_jax(prefix, _biovil_base):
    sd = {prefix + k: v for k, v in _biovil_base.items()}
    got, got_s = thf.convert_biovil_t(sd, prefix=prefix)
    want, want_s = jhf.convert_biovil_t(sd, prefix=prefix)
    (got, gpos), (want, wpos) = _split_pos(got), _split_pos(want)
    assert_same_tree(got, want)
    assert_same_tree(got_s, want_s)
    _vit_pos_equal(gpos[0], wpos[0])
    assert got["proj1"]["w"].shape == (1, 1, 512, 8)        # HWIO


def test_convert_chexpert_classifier_matches_jax(_biovil_base):
    g = torch.Generator().manual_seed(4)
    sd = {"model.biovil_encoder." + k: v for k, v in _biovil_base.items()}
    sd.update({"model.fc1.weight": torch.randn(16, 128, generator=g),
               "model.fc1.bias": torch.randn(16, generator=g),
               "model.fc2.weight": torch.randn(14, 16, generator=g),
               "model.fc2.bias": torch.randn(14, generator=g)})
    (got, got_s), (want, want_s) = (thf.convert_chexpert_classifier(sd),
                                    jhf.convert_chexpert_classifier(sd))
    (got, _), (want, _) = _split_pos(got), _split_pos(want)
    assert_same_tree(got, want)
    assert_same_tree(got_s, want_s)


def test_bridge_takes_the_jax_trees_to_the_ports():
    """The JAX converter's output through bridge.to_torch is the port's
    converter output, leaf for leaf (the fp16 source's values in f32)."""
    sd = llama_sd(dtype=torch.float16)
    mine = thf.convert_llama(sd, 2)
    theirs = bridge.to_torch(jhf.convert_llama(sd, 2), device="cpu")
    for k, v in flat(theirs).items():
        assert torch.equal(flat(mine)[k].float(), v), k


# ---------------------------------------------------------- forward parity
@pytest.fixture(scope="module")
def hf_llama():
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=64,
        rms_norm_eps=1e-6, attn_implementation="eager")
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(cfg).eval()


TINY_HF = tl.LlamaConfig(vocab_size=128, hidden_size=64, num_layers=3, num_heads=4,
                         num_kv_heads=4, intermediate_size=128, max_position=64)


def _port_logits(params, tokens, lora=None):
    t = tokens.shape[1]
    lengths = torch.full((tokens.shape[0],), t, dtype=torch.int32)
    pos = torch.arange(t)[None].repeat(tokens.shape[0], 1)
    logits, _ = tl.llama_apply(params, TINY_HF, torch.from_numpy(tokens), pos,
                               tl.prefill_bias(lengths, t), lora=lora)
    return logits.numpy()


def test_llama_forward_matches_hf(hf_llama):
    params = thf.convert_llama(hf_llama.state_dict(), 3)
    tokens = np.random.default_rng(0).integers(0, 128, (2, 9)).astype(np.int32)
    with torch.no_grad():
        ref = hf_llama(torch.from_numpy(tokens.astype(np.int64))).logits.numpy()
    np.testing.assert_allclose(_port_logits(params, tokens), ref, atol=ATOL, rtol=RTOL)


def test_llama_forward_with_peft_lora_matches_hf(hf_llama):
    peft = pytest.importorskip("peft")
    import copy
    lcfg = peft.LoraConfig(r=4, lora_alpha=16, target_modules=["q_proj", "v_proj"],
                           lora_dropout=0.0, bias="none", task_type="CAUSAL_LM")
    pmodel = peft.get_peft_model(copy.deepcopy(hf_llama), lcfg).eval()
    torch.manual_seed(1)
    for mod in pmodel.modules():
        if hasattr(mod, "lora_B") and "default" in getattr(mod, "lora_B", {}):
            torch.nn.init.normal_(mod.lora_B["default"].weight, std=0.05)
    sd = dict(pmodel.state_dict())
    base_sd = {k.replace("base_model.model.", "").replace(".base_layer", ""): v
               for k, v in sd.items() if "lora_" not in k}
    params = thf.convert_llama(base_sd, 3)
    lora = thf.convert_peft_lora(sd, 3, rank=4, alpha=16)
    assert any("lora_A.default.weight" in k for k in sd)
    tokens = np.random.default_rng(1).integers(0, 128, (1, 7)).astype(np.int32)
    with torch.no_grad():
        ref = pmodel(input_ids=torch.from_numpy(tokens.astype(np.int64))).logits.numpy()
    np.testing.assert_allclose(_port_logits(params, tokens, lora), ref, atol=ATOL, rtol=RTOL)


def test_bert_forward_matches_hf(hf_bert):
    cfg = tbert.BertConfig(vocab_size=130, hidden_size=48, num_layers=2, num_heads=4,
                           intermediate_size=96, max_position=32)
    params = thf.convert_bert(hf_bert.state_dict(), 2, prefix="")
    tokens = np.random.default_rng(0).integers(0, 130, (2, 11))
    mask = np.ones((2, 11), np.int64)
    mask[1, 8:] = 0
    with torch.no_grad():
        ref = hf_bert(torch.from_numpy(tokens), attention_mask=torch.from_numpy(mask)
                      ).last_hidden_state.numpy()
        got = tbert.bert_apply(params, cfg, torch.from_numpy(tokens),
                               torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got[0], ref[0], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[1, :8], ref[1, :8], atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------ file readers
def _tensor(w):
    """A state-dict value as a tensor (numpy bf16 is ml_dtypes', which JAX
    registers with numpy)."""
    if isinstance(w, torch.Tensor):
        return w
    w = np.asarray(w)
    if w.dtype.name == "bfloat16":
        return torch.from_numpy(w.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(w.copy())


def _same_sd(got, want):
    assert got.keys() == want.keys()
    for k in want:
        w = _tensor(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k


def test_bin_shards_read_as_jax(tmp_path):
    sd = llama_sd(dtype=torch.float16)
    keys = sorted(sd)
    torch.save({k: sd[k] for k in keys[:9]}, tmp_path / "pytorch_model-00001-of-00002.bin")
    torch.save({k: sd[k] for k in keys[9:]}, tmp_path / "pytorch_model-00002-of-00002.bin")
    (tmp_path / "pytorch_model.bin.index.json").write_text(json.dumps({"weight_map": {}}))
    got = thf._load_hf_state_dict(tmp_path)
    _same_sd(got, jpipe._load_hf_state_dict(str(tmp_path)))
    _same_sd(got, sd)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32, torch.bfloat16])
def test_safetensors_shards_read_as_jax(tmp_path, dtype):
    """JAX reads the shards through safetensors.numpy, bf16 included: JAX
    imports ml_dtypes, which gives numpy a bfloat16."""
    from safetensors.torch import save_file
    sd = llama_sd(dtype=dtype)
    keys = sorted(sd)
    save_file({k: sd[k] for k in keys[:7]}, str(tmp_path / "model-00001-of-00002.safetensors"))
    save_file({k: sd[k] for k in keys[7:]}, str(tmp_path / "model-00002-of-00002.safetensors"),
              metadata={"format": "pt"})
    torch.save({"ignored": torch.ones(1)}, tmp_path / "pytorch_model.bin")   # safetensors first
    got = thf._load_hf_state_dict(tmp_path)
    _same_sd(got, jpipe._load_hf_state_dict(str(tmp_path)))
    _same_sd(got, sd)


def test_safetensors_reader_takes_every_dtype(tmp_path):
    """The port's reader against safetensors' own, over the format's dtypes,
    a scalar, an empty tensor and an fp16 tensor of odd length (the next
    one starts 2 bytes off a 4-byte boundary)."""
    from safetensors.torch import load_file, save_file
    g = torch.Generator().manual_seed(0)
    sd = {"bf16": torch.randn(5, 3, generator=g).bfloat16(),
          "f64": torch.randn(3, generator=g).double(),
          "i64": torch.arange(7), "i32": torch.arange(5, dtype=torch.int32),
          "i16": torch.arange(3, dtype=torch.int16), "i8": torch.arange(-3, 3, dtype=torch.int8),
          "u8": torch.arange(9, dtype=torch.uint8), "bool": torch.tensor([True, False, True]),
          "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4),
          "odd": torch.randn(3, generator=g).half()}
    path = tmp_path / "model.safetensors"
    save_file(sd, str(path))
    _same_sd(thf.load_safetensors(path), load_file(str(path)))


def test_no_weights_raise_as_jax(tmp_path):
    for fn in (thf._load_hf_state_dict, jpipe._load_hf_state_dict):
        with pytest.raises(FileNotFoundError, match="no model weights"):
            fn(str(tmp_path))


def test_torch_load_takes_a_lightning_ckpt(tmp_path):
    """A Lightning .ckpt holds entries that are no tensors; torch >= 2.6
    refuses them unless weights_only=False."""
    sd = {"model.fc1.weight": torch.randn(3, 2), "model.fc1.bias": torch.randn(3)}
    ckpt = {"state_dict": sd, "hyper_parameters": {"lr": 1e-4, "name": "cls"},
            "epoch": 7, "callbacks": {"ModelCheckpoint": {"best": None}}}
    torch.save(ckpt, tmp_path / "cls.ckpt")
    got = thf._torch_load(tmp_path / "cls.ckpt")
    assert got["hyper_parameters"] == ckpt["hyper_parameters"] and got["epoch"] == 7
    _same_sd(got["state_dict"], sd)
    _same_sd(got["state_dict"], jpipe._torch_load(str(tmp_path / "cls.ckpt"))["state_dict"])


# ------------------------------------------------------------ tokenizers
@pytest.fixture(scope="module")
def tokenizer_dirs(tmp_path_factory):
    """A LLaMA-layout fast tokenizer (unk 0, bos 1, eos 2) and a BERT
    WordPiece tokenizer, built here with tokenizers and transformers."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    root = tmp_path_factory.mktemp("tok")
    words = ["<unk>", "<s>", "</s>", "the", "heart", "size", "is", "normal", "no",
             "effusion", ".", "lungs", "are", "clear"]
    tk = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    llama = transformers.PreTrainedTokenizerFast(tokenizer_object=tk, unk_token="<unk>",
                                                 bos_token="<s>", eos_token="</s>")
    llama.save_pretrained(root / "vicuna")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "heart", "is", "normal",
             "no", "effusion", "."]
    (root / "vocab.txt").write_text("\n".join(vocab) + "\n")
    bert = transformers.BertTokenizerFast(vocab_file=str(root / "vocab.txt"))
    bert.save_pretrained(root / "bert")
    return root


def test_load_vicuna_tokenizer_matches_jax(tokenizer_dirs):
    path = str(tokenizer_dirs / "vicuna")
    mine, theirs = ttok.load_vicuna_tokenizer(path), jtok.load_vicuna_tokenizer(path)
    assert mine.get_vocab() == theirs.get_vocab()
    assert mine.convert_tokens_to_ids("<IMG>") == theirs.convert_tokens_to_ids("<IMG>") == 14
    assert mine.pad_token == theirs.pad_token == "<unk>"
    text = "the heart <IMG> <IMG> is normal . no effusion"
    assert mine(text)["input_ids"] == theirs(text)["input_ids"]
    ids = mine(text)["input_ids"]
    assert mine.decode(ids, skip_special_tokens=True) == theirs.decode(
        ids, skip_special_tokens=True)


def test_load_bert_tokenizer_matches_the_jax_pipeline(tokenizer_dirs):
    from transformers import AutoTokenizer
    path = str(tokenizer_dirs / "bert")
    mine, theirs = ttok.load_bert_tokenizer(path), AutoTokenizer.from_pretrained(path)
    text = "The heart is normal. No effusion, the lungs"
    assert mine(text, truncation=True, max_length=512)["input_ids"] == \
        theirs(text, truncation=True, max_length=512)["input_ids"]


def test_tokenizer_loaders_name_transformers_when_missing(monkeypatch, tokenizer_dirs):
    import sys
    monkeypatch.setitem(sys.modules, "transformers", None)
    for fn in (ttok.load_vicuna_tokenizer, ttok.load_bert_tokenizer):
        with pytest.raises(ImportError, match="transformers"):
            fn(str(tokenizer_dirs / "vicuna"))

