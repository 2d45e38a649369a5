"""The port's measurement entry points (tools/bench_torch.py and the
tools/*_torch.py twins of tools/bench_*.py and tools/spec_acceptance.py)
against their JAX originals, on the CPU:

  * flags: every ``add_argument`` of the JAX original, read from its source
    by ``ast`` (nothing of it is imported), is in the port's
    ``build_parser()`` with the same name and default, and the port adds
    ``--device`` (default cuda). The only defaults that differ are
    spec_acceptance's ``--ms-plain`` and ``--ms-verify``: the JAX tool's are
    a TPU's milliseconds, the port's the card's own; and bench_warmup's
    ``--cache-dir``: the JAX tool's names its compilation cache, the
    port's the kernels' build directory (ops/_build.py's default);
  * each port tool's ``main([..., "--device", "cpu"])`` runs in-process at
    a tiny model (passed as an argument, not a flag) and prints lines whose
    keys are the JAX original's plus ``device`` and ``runs_s``
    (bench_interactive's also ``ignored``; bench_warmup's ``device``
    alone); spec_acceptance's lines carry
    the JAX tool's keys alone, since its output is the JAX tool's byte for
    byte;
  * whole tools: ``spec_acceptance_torch`` prints what the JAX tool prints
    at the same flags, byte for byte (both ms flags passed explicitly);
    ``bench_spec_ring`` and ``bench_pipeline`` at ``--tiny`` on both sides
    give equal non-timing fields (the port's spec ring on the JAX tool's
    own TINY_LLAMA weights, bridged).
"""
import ast
import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from radialog_tpu_torch import bridge
from radialog_tpu_torch.native.loader import native_available
from tools import bench_torch

import test_torch_llama as tll

REPO = Path(__file__).resolve().parent.parent
TOOLS = {   # the port's tool: its JAX original
    "bench_torch": "bench.py",
    "bench_sweep_torch": "tools/bench_sweep.py",
    "bench_qa_pass_torch": "tools/bench_qa_pass.py",
    "bench_allqa_pass_torch": "tools/bench_allqa_pass.py",
    "bench_interactive_torch": "tools/bench_interactive.py",
    "bench_train_torch": "tools/bench_train.py",
    "bench_spec_torch": "tools/bench_spec.py",
    "bench_spec_ring_torch": "tools/bench_spec_ring.py",
    "bench_chat_torch": "tools/bench_chat.py",
    "spec_acceptance_torch": "tools/spec_acceptance.py",
    "bench_pipeline_torch": "tools/bench_pipeline.py",
    "bench_loader_torch": "tools/bench_loader.py",
    "bench_warmup_torch": "tools/bench_warmup.py",
}
# the JAX tools' defaults that name a TPU's figures or JAX's own cache
CARD_DEFAULTS = {"spec_acceptance_torch": {"ms_plain", "ms_verify"},
                 "bench_warmup_torch": {"cache_dir"}}
EXTRA = {"device", "runs_s"}
EXTRA_OF = {"bench_warmup_torch": {"device"}}    # one boot: no runs to list


def _port(name):
    return importlib.import_module(f"tools.{name}")


def _jax_flags(path):
    """{dest: default} of every ``add_argument`` call in the file."""
    flags = {}
    for node in ast.walk(ast.parse((REPO / path).read_text())):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            continue
        opt = [a.value for a in node.args if isinstance(a, ast.Constant)][-1]
        kw = {k.arg: k.value for k in node.keywords}
        if "default" in kw:
            default = ast.literal_eval(kw["default"])
        else:
            action = kw.get("action")
            default = (False if isinstance(action, ast.Constant)
                       and action.value == "store_true" else None)
        flags[opt.lstrip("-").replace("-", "_")] = default
    return flags


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_flags_are_the_jax_tools(name):
    want = _jax_flags(TOOLS[name])
    port = {a.dest: a.default for a in _port(name).build_parser()._actions
            if a.option_strings and a.dest != "help"}
    assert port.pop("device") == "cuda"
    assert set(port) == set(want)
    differ = {k for k in want if port[k] != want[k]}
    assert differ == CARD_DEFAULTS.get(name, set()), differ


# --------------------------------------------------------- each main's lines
MODEL = bench_torch.tiny_model()
SHAPE = bench_torch.Shape(batch=2, prompt_len=16, shared_prefix=6, new_tokens=3, lane_cache=32,
                          runs=1)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}
SWEEP_KEYS = {"batch", "kv_int8", "w4", "two_phase", "shared_prefix", "cache_len", "new_tokens",
              "reports_per_sec", "ms_per_token"}
MEM_KEYS = {"batch", "kv_int8", "cache_len", "argument_gib", "output_gib", "temp_gib",
            "alias_gib", "peak_gib"}
QA_KEYS = {"batch", "hist_len", "q_len", "new_tokens", "kv_int8", "plain_s_per_study",
           "shared_s_per_study", "speedup"}
ALLQA_KEYS = {"batch", "hist_len", "q_len", "prefix", "new_tokens", "kv_int8",
              "plain_s_per_batch", "shared_s_per_batch", "plain_s_per_study",
              "shared_s_per_study", "speedup"}
RING_KEYS = {"lanes", "sessions", "prompt_len", "new_tokens", "cache_len", "steps_per_call",
             "w4", "aggregate_tok_per_s", "per_session_tok_per_s", "chunk_ms", "ms_per_tok",
             "admit_ms_warm"}
LORA_KEYS = {"micro_batch", "cutoff", "ms_per_step", "tokens_per_sec", "loss", "grad_norm"}
STAGE1_KEYS = {"mode", "batch", "ms_per_step", "images_per_sec", "loss", "loss_itc",
               "loss_itm", "loss_lm"}
SPEC_HEAD = {"k", "m", "prompt_len", "new_tokens", "kv", "note"}
SPEC_ROW = {"mode", "tok_s", "forwards", "ms_per_forward", "accepted_per_forward"}
CHAT_HEAD = {"prompt_len", "turn_len", "report_tokens", "reply_tokens", "turns", "cache_len",
             "unroll", "note"}
CHAT_ROW = {"mode", "cold_turns_s", "warm_turns_s", "warm_followup_mean_s",
            "warm_report_tok_s"}
LOADER_HEAD = {"n", "jpeg_side", "host_cores", "device_rate_to_beat"}
LOADER_ROW = {"mode", "images_s"}
TINY_LM = ["--prompt-len", "12", "--new-tokens", "3"]
RUNS = {   # argv, the keys of each printed line
    "bench_torch": ([], [BENCH_KEYS]),
    "bench_sweep_torch": (["--batch", "2", "--cache-len", "48", "--prompt-len", "20",
                           "--new-tokens", "3", "--runs", "1", "--shared-prefix", "6",
                           "--kv-int8", "--w4"], [SWEEP_KEYS]),
    "bench_qa_pass_torch": (["--hist-len", "16", "--q-len", "4", "--new-tokens", "2",
                             "--batch", "2", "--runs", "1"], [QA_KEYS]),
    "bench_allqa_pass_torch": (["--hist-len", "20", "--q-len", "4", "--new-tokens", "2",
                                "--batch", "2", "--prefix", "6", "--runs", "1"], [ALLQA_KEYS]),
    "bench_interactive_torch": (["--lanes", "2", "--cache-len", "64", *TINY_LM, "--sessions",
                                 "2", "--steps-per-call", "2", "--kv-int8", "--no-donate"],
                                [RING_KEYS | {"ignored"}]),
    "bench_train_torch": (["--cutoff", "24", "--micro", "1", "--runs", "1", "--flash"],
                          [LORA_KEYS]),
    "bench_spec_torch": ([*TINY_LM, "--runs", "1", "--accept-pattern", "1,2"],
                         [SPEC_HEAD | {"accept_pattern"}] + [SPEC_ROW] * 5),
    "bench_chat_torch": (["--turns", "1", "--prompt-len", "12", "--turn-len", "4",
                          "--report-tokens", "3", "--reply-tokens", "2", "--cache-len", "64",
                          "--spec"], [CHAT_HEAD] + [CHAT_ROW] * 3),
    "bench_loader_torch": (["--n", "4", "--repeat", "1", "--size", "96"],
                           [LOADER_HEAD, LOADER_ROW] + (
                               [LOADER_ROW] * 5 if native_available() else
                               [LOADER_ROW | {"note"}] + [LOADER_ROW] * 4)),
    "bench_warmup_torch": (["--max-new", "3", "--cache-len", "288", "--spec"],
                           [{"weights_s", "warmup_s", "first_turn_s", "tokens", "cache_dir"}]),
}


def _lines(out: str):
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def _call_main(name, argv):
    kw = {} if name == "bench_loader_torch" else {"model": MODEL}
    if name == "bench_torch":
        kw["shape"] = SHAPE
    return _port(name).main([*argv, "--device", "cpu"], **kw)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_each_main_prints_the_jax_keys(name, capsys):
    argv, keys = RUNS[name]
    _call_main(name, argv)
    lines = _lines(capsys.readouterr().out)
    extra = EXTRA_OF.get(name, EXTRA)
    assert [set(line) - extra for line in lines] == keys
    assert all(extra <= set(line) and line["device"] == "cpu" for line in lines)


def test_sweep_mem_and_stage1_lines(capsys):
    """bench_sweep's --mem line (the allocator's figures; alias_gib has no
    counterpart: null) and bench_train's --stage1 line."""
    _call_main("bench_sweep_torch", ["--batch", "2", "--cache-len", "32", *TINY_LM, "--mem"])
    _call_main("bench_train_torch", ["--micro", "2", "--runs", "1", "--stage1"])
    mem, stage1 = _lines(capsys.readouterr().out)
    assert set(mem) - EXTRA == MEM_KEYS and mem["alias_gib"] is None
    assert set(stage1) - EXTRA == STAGE1_KEYS and np.isfinite(stage1["loss"])


# ------------------------------------------------------------- whole tools
def _jax_tool(path, argv, monkeypatch, tmp_path):
    """The JAX tool's main run in this process with ``argv``; its stdout.
    Its compilation cache goes to ``tmp_path`` and is switched off after."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.syspath_prepend(str(REPO))
    spec = importlib.util.spec_from_file_location(f"jax_{Path(path).stem}", REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [path, *argv])
    old = jax.config.jax_compilation_cache_dir
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
        from jax._src import compilation_cache
        compilation_cache.reset_cache()
    return buf.getvalue(), mod


def test_spec_acceptance_is_the_jax_tool_byte_for_byte(monkeypatch, tmp_path, capsys):
    flags = ["--n", "4", "--ms-plain", "10.6", "--ms-verify", "11.3"]
    want, _ = _jax_tool("tools/spec_acceptance.py", flags, monkeypatch, tmp_path)
    _port("spec_acceptance_torch").main([*flags, "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    lines = _lines(got)
    assert [x["task"] for x in lines] == ["correction", "rg"]
    assert set(lines[0]) == {"task", "k", "m", "n", "mean_out_tokens", "opt", "pess",
                             "plain_tok_s"}


TIMING = {"tok_s", "reports_s", "wall_s", "images_per_sec", "ms_per_step", "step_ms_p50",
          "step_ms_p90", "first5_ms", "note"}


def _fields(lines):
    return [{k: v for k, v in line.items() if k not in TIMING | EXTRA} for line in lines]


def test_spec_ring_tiny_equals_the_jax_tool(monkeypatch, tmp_path, capsys):
    argv = ["--tiny", "--prompt-len", "40", "--new-tokens", "12", "--runs", "1",
            "--lanes", "2"]
    want, _ = _jax_tool("tools/bench_spec_ring.py", argv, monkeypatch, tmp_path)
    from radialog_tpu.models.llama import TINY_LLAMA, llama_init
    from radialog_tpu.ops.quant import quantize_llama_host
    k1, _ = jax.random.split(jax.random.PRNGKey(0))     # the JAX tool's --tiny weights
    qp = quantize_llama_host(jax.tree_util.tree_map(np.asarray, llama_init(k1, TINY_LLAMA)))
    params = bridge.llama_serving(tll.packed_tree(qp), TINY_LLAMA, device="cpu")
    _port("bench_spec_ring_torch").main(argv, params=params)
    got = _lines(capsys.readouterr().out)
    assert _fields(got) == _fields(_lines(want))
    assert [x.get("mode") for x in got] == [None, "plain", "oracle", "pattern", "junk", "ngram"]
    assert got[2]["accepted_per_verify"] == 3.0 and got[2]["lanes_token_exact_vs_plain"] == "2/2"
    assert all(EXTRA <= set(x) for x in got)


def test_pipeline_tiny_equals_the_jax_tool(monkeypatch, tmp_path, capsys):
    """``--no-step`` on both sides: the loader, the tokenizer, the staging and
    the count of steps. The JAX tool still compiles its step for a warm-up
    call; here that step is a stub returning its state (its loss is never
    read, and its compile would take most of a minute), while the port's
    warm-up runs its real step."""
    argv = ["--tiny", "--batch", "2", "--steps", "2", "--imgs", "4", "--no-step"]
    from radialog_tpu.train import steps as jsteps

    def stub_step(tx, cfg, **kw):
        return lambda st, vp, vs, batch, key: (st, {"loss": np.float32(0)})
    monkeypatch.setattr(jsteps, "make_stage1_raw_train_step", stub_step)
    want, _ = _jax_tool("tools/bench_pipeline.py", argv, monkeypatch, tmp_path)
    _port("bench_pipeline_torch").main(argv)
    got = _lines(capsys.readouterr().out)
    assert _fields(got) == _fields(_lines(want))
    assert got[0]["steps"] == 2 and got[0]["no_step"] and EXTRA <= set(got[0])
