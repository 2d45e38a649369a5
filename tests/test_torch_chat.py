"""The chat app of the PyTorch port (apps/chat.py ``ChatSession``,
apps/demo.py, core/config.py, the image loader of ops/image.py) against the
JAX package's ``ChatSession``, the root demo.py and ``Config`` on the CPU:
the mock pipelines (float, the JAX default: the stacked f32 tree over the
bf16 cache) with every weight bridged from JAX's, REPLY new tokens a turn.

  * ``load_image`` of a PNG written with PIL: the port's PIL decode equals
    the JAX loader's (its native decoder here) bitwise, and the findings
    and the report equal JAX's; then ``ask``, ``ask_stream`` (its last
    yield equals ``ask``'s reply on the same history) and a speculative
    session's replies, equal to JAX's. With the WhitespaceTokenizer a reply
    re-tokenizes to other ids (its text is "tok<id>"), so every turn after
    the first prefills the whole prompt again, on both sides; with
    ``RoundTrip``, whose words encode back to their ids, each turn prefills
    only its new tokens;
  * ``warmup`` then the first turn equals a cold session's;
  * ``Config`` from YAML files, merged and overridden, equals JAX's;
  * the demo: ``make_bot``'s yields and the ``--cli`` loop over stdin equal
    the root demo.py's on the same inputs; ``python -m
    radialog_tpu_torch.apps.demo --cli --mock --device cpu`` runs a
    conversation from stdin.

Every image turn of this module loads the same PNG, so each pipeline
classifies and embeds it once and later turns reuse that result
(``_once_per_image``).
"""
import copy
import io
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from radialog_tpu.apps import chat as jchat
from radialog_tpu.apps import pipeline as jpipe
from radialog_tpu.core.config import Config as JConfig
from radialog_tpu.ops.image import load_image_grayscale as jload
from radialog_tpu.ops.image import preprocess_cxr_np as jprep
from radialog_tpu_torch import bridge
from radialog_tpu_torch.apps import chat as tchat
from radialog_tpu_torch.apps import demo as tdemo
from radialog_tpu_torch.apps.pipeline import PipelineConfig, RaDialogPipeline
from radialog_tpu_torch.apps.tokenization import WhitespaceTokenizer
from radialog_tpu_torch.core.config import Config
from radialog_tpu_torch.ops import image as timage

from test_torch_eval_harness import REPO

REPLY = 10
TREES = ("llama", "lora", "blip2", "visual", "visual_state", "classifier",
         "classifier_state", "chexbert")


class RoundTrip(WhitespaceTokenizer):
    """WhitespaceTokenizer whose decoded words "w<id>" encode back to <id>
    and whose "</s>" is eos, so that a reply re-tokenizes to its own ids."""

    def encode(self, text, add_bos=True):
        return super().encode(text.replace("</s>", " </s> "), add_bos)

    def _word_id(self, w):
        if w == "</s>":
            return self.eos_token_id
        if w[:1] == "w" and w[1:].isdigit() and int(w[1:]) < self.vocab_size:
            return int(w[1:])
        return super()._word_id(w)

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{int(i)}" for i in ids
                        if not (skip_special_tokens and int(i) == self.eos_token_id))


def _once_per_image(pipe):
    """The pipeline's ``classify_findings`` and ``embed_images``, each run
    once per distinct input for the whole module: every session of these
    tests loads the same PNG, and each image turn would otherwise run the
    classifier's and BioViL-T's ResNet-50 on it again on both sides. A
    repeated call returns a copy of the first call's result."""
    for name in ("classify_findings", "embed_images"):
        real, seen = getattr(pipe, name), {}

        def once(images, *args, _real=real, _seen=seen, **kw):
            arr = np.asarray(images.cpu() if torch.is_tensor(images) else images)
            key = (arr.dtype.str, arr.shape, arr.tobytes(), repr(args), repr(sorted(kw.items())))
            if key not in _seen:
                _seen[key] = _real(images, *args, **kw)
            out = _seen[key]
            return out.clone() if torch.is_tensor(out) else copy.deepcopy(out)
        setattr(pipe, name, once)
    return pipe


@pytest.fixture(scope="module")
def pipelines():
    jp = jpipe.RaDialogPipeline(jpipe.PipelineConfig(mock=True, seed=0, max_new_tokens=REPLY))
    tp = RaDialogPipeline(PipelineConfig(mock=True, quantize=False, device="cpu", seed=0,
                                         max_new_tokens=REPLY))
    trees = {n: jax.tree_util.tree_map(np.array, getattr(jp, n)) for n in TREES}
    return _once_per_image(jp), _once_per_image(bridge.pipeline_weights(tp, trees))


@pytest.fixture(scope="module")
def png(tmp_path_factory):
    from PIL import Image
    p = tmp_path_factory.mktemp("img") / "dcm001.png"
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (300, 340)).astype(np.uint8)).save(p)
    return p


@pytest.fixture
def tokenizer(pipelines, request):
    """Both pipelines' tokenizer for the test, restored after it."""
    jp, tp = pipelines
    old = jp.tokenizer, tp.tokenizer
    if request.param == "round_trip":
        jp.tokenizer = tp.tokenizer = RoundTrip(vocab_size=tp.llama_cfg.vocab_size,
                                                num_img_tokens=32,
                                                img_token_id=tp.llama_cfg.img_token_id)
    yield request.param
    jp.tokenizer, tp.tokenizer = old


def test_image_loader_is_the_jax_pil_route_bitwise(png):
    from radialog_tpu.native.loader import preprocess_file as jfile
    for crop in (448, 488):
        got = timage.preprocess_file(png, resize=512, crop=crop)
        np.testing.assert_array_equal(got, jprep(jload(png), 512, crop))
        np.testing.assert_array_equal(got, jfile(str(png), 512, crop))
    np.testing.assert_array_equal(timage.load_image_grayscale(png), jload(png))
    raw = np.random.default_rng(1).integers(0, 4000, (7, 9))
    from radialog_tpu.ops.image import remap_to_uint8_np as jremap
    np.testing.assert_array_equal(timage.remap_to_uint8_np(raw), jremap(raw))


def test_image_division_is_ieee_as_on_the_card(monkeypatch):
    """``preprocess_cxr`` and ``expand_cxr_u8`` divide by 255 as numpy does
    for every uint8 value, also where a division by a Python scalar is a
    product with its reciprocal, as PyTorch's CUDA kernel computes it (a
    division by ``/ 255.0`` gives 126 of the 256 values one ulp off
    there)."""
    real = torch.Tensor.__truediv__

    def reciprocal(self, other):
        if isinstance(other, float):
            return self * (1.0 / torch.tensor(other, dtype=torch.float32))
        return real(self, other)
    monkeypatch.setattr(torch.Tensor, "__truediv__", reciprocal)
    u8 = torch.arange(256, dtype=torch.uint8).reshape(16, 16)
    want = np.arange(256, dtype=np.float32).reshape(16, 16) / np.float32(255)
    np.testing.assert_array_equal(timage.expand_cxr_u8(u8[None])[0, ..., 0].numpy(), want)
    big = u8.repeat(28, 28)          # 448 x 448: resize and crop are the identity
    np.testing.assert_array_equal(timage.preprocess_cxr(big, 448, 448)[:16, :16, 0].numpy(),
                                  want)
    assert (u8.float() / 255.0 != torch.from_numpy(want)).sum() == 126


# text turns of 40 words or more: a JAX ChatSession with an image loaded
# fails to trace the incremental prefill of a turn shorter than the 32-token
# <IMG> run (it passes the image's embeddings with every delta)
Q1 = "Is there any pneumonia? " + " ".join(f"detail{i}" for i in range(40))
Q2 = "Please describe the findings in plain words. " + " ".join(f"more{i}" for i in range(40))


def _replies(session, png):
    """The image turn, then two text turns."""
    return [session.load_image(str(png)), session.ask(Q1), session.ask(Q2)]


@pytest.mark.parametrize("tokenizer", ["whitespace", "round_trip"], indirect=True)
def test_chat_session_matches_jax(pipelines, png, tokenizer, monkeypatch):
    jp, tp = pipelines
    want = _replies(jchat.ChatSession(jp, cache_len=512), png)
    resets = []
    port = tchat.ChatSession(tp, cache_len=512)
    real_reset = port.session.reset
    monkeypatch.setattr(port.session, "reset", lambda: resets.append(port.session.cur_len)
                        or real_reset())
    got = _replies(port, png)
    assert got == want
    assert got[0][1] is not None and got[0][0]
    # turns 2 and 3 re-prefill (cur_len > 0 at the reset) only where replies
    # do not re-tokenize to their own ids
    assert (sum(r > 0 for r in resets) == 2) == (tokenizer == "whitespace")
    assert not port.session.cache.quantized
    spec = tchat.ChatSession(tp, cache_len=512, speculative=True, spec_k=5)
    assert _replies(spec, png) == want
    # ask_stream: the same history, the third turn streamed in chunks of 3
    stream = tchat.ChatSession(tp, cache_len=512)
    stream.load_image(str(png))
    stream.ask(Q1)
    partials = list(stream.ask_stream(Q2, chunk_size=3))
    assert len(partials) > 1 and partials[-1] == want[2]
    assert stream.conv.messages == port.conv.messages


def test_warmup_then_first_turn(pipelines):
    _, tp = pipelines
    cold = tchat.ChatSession(tp, cache_len=512)
    warm = tchat.ChatSession(tp, cache_len=512, speculative=True)
    assert warm.warmup(turn_lengths=(16,)) > 0
    assert warm.session.cur_len == 0 and warm.conv.messages == []
    q = "Hello, what can you do?"
    assert warm.ask(q) == cold.ask(q)
    assert tchat.ChatSession(tp, prefix_cache=False).warmup() == 0.0


def test_config_matches_jax(tmp_path):
    a, b = tmp_path / "a.yaml", tmp_path / "b.yaml"
    a.write_text("model:\n  vicuna_path: /w/v\n  weight_bits: 8\n  mock: false\n"
                 "run:\n  lr: 0.0001\n  tags: [x, y]\n")
    b.write_text("model:\n  mock: true\n  kv_int8: null\nrun:\n  epochs: 3\n")
    overrides = ["model.quantize=true", "run.lr=3e-4", "new.deep.key=[1, 2]", "x=none"]
    for mod in (JConfig, Config):
        assert mod.from_yaml(a).to_dict() == JConfig.from_yaml(a).to_dict()
    got = Config.from_files(str(a), str(b), overrides=overrides)
    want = JConfig.from_files(str(a), str(b), overrides=overrides)
    assert got.to_dict() == want.to_dict() and got.model.quantize is True
    assert got.merge({"run": {"lr": 1}}).to_dict() == want.merge({"run": {"lr": 1}}).to_dict()
    assert got == want.to_dict() and got.run.tags == ["x", "y"]
    for mod in (JConfig, Config):
        with pytest.raises(ValueError, match="key=value"):
            mod().apply_overrides(["nokey"])


def _root_demo():
    sys.path.insert(0, str(REPO))
    try:
        import demo
    finally:
        sys.path.pop(0)
    return demo


def test_make_bot_flows_match_the_root_demo(pipelines, png):
    jp, tp = pipelines
    bots = [_root_demo().make_bot(jchat.ChatSession(jp, cache_len=512)),
            tdemo.make_bot(tchat.ChatSession(tp, cache_len=512))]
    runs = []
    for bot in bots:
        history = [[(str(png),), None]]
        states = [copy.deepcopy(s) for s in bot(history)]
        history = states[-1] + [["Is there any pneumonia?", None]]
        states += [copy.deepcopy(s) for s in bot(history)]
        runs.append(states)
    assert runs[1] == runs[0]
    final = runs[1][-1]
    assert "(img_tokens)" in final[1][0] and final[-1][1]


def test_cli_loop_over_stdin_matches_the_root_demo(pipelines, png, monkeypatch, capsys):
    """``main(["--cli", "--mock"])`` of both demos, each building these
    pipelines, over the same stdin: the same printed conversation."""
    jp, tp = pipelines
    demo = _root_demo()
    lines = f"{png}\nIs there any pneumonia?\nreset\nHello\nquit\n"
    outs = []
    for main, owner, pipe in ((demo.main, jpipe, jp),
                              (tdemo.main, sys.modules[tdemo.__name__], tp)):
        monkeypatch.setattr(owner, "RaDialogPipeline", lambda cfg, pipe=pipe: pipe)
        monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
        monkeypatch.setattr(sys, "argv", ["demo.py", "--cli", "--mock"])
        main(["--cli", "--mock", "--device", "cpu"]) if main is tdemo.main else main()
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]
    assert outs[1].count("ASSISTANT:") == 3 and "(predicted findings:" in outs[1]


def test_demo_runs_as_a_module(png):
    proc = subprocess.run(
        [sys.executable, "-m", "radialog_tpu_torch.apps.demo", "--cli", "--mock",
         "--device", "cpu", "--options", "model.quantize=true"],
        input=f"{png}\nIs there any pneumonia?\nquit\n", cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    # --options model.quantize=true: the W8A8 mock (the session's cache is bf16)
    assert "(predicted findings:" in proc.stdout and proc.stdout.count("ASSISTANT:") == 2
