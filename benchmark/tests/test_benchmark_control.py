"""The correctness check against its control and against faults planted
under the timed path.

On the CPU at the tiny sizes of tiny.json: each cell's control (the
reference one precision lower put in the program's place: W4A8 for the
W8A8 model, W8A8 for the bf16 model, float8 for the image side) comes out
not correct, and
so does a run whose timed path has one of these faults planted under it:
a token altered where it is produced (the report engine's and the ring's
token choice), an answer altered (the findings classifier's logits), a
decode step that returns its state unchanged (the KV cache as it was
before the step), and half of the batch left out (half the lanes decoded
from the other half's logits; half the studies given the other half's
image queries). The cells run on one card, so no exchange between chips
can be left out. On the card (marked ``cuda``) each cell's control at the
cell's own size, on three seeds, and, where the configuration names a
path of the program one precision lower (``reference.control_path``: the
bf16 model's W8A8 path), the program on that path.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]] + sorted(
    p.stem for p in (ROOT / "benchmark" / "pending").glob("*.json"))
REPORT = [w for w in CELLS if "report" in w]


def _run(cell, seed, *extra, timeout=900):
    p = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload", cell,
                        "--seed", str(seed), "--seconds", "1", "--trace", "0", "--control",
                        *extra], capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    other = next(l for l in p.stderr.splitlines() if l.startswith("checks (other):"))
    return json.loads(p.stdout.strip().splitlines()[-1]), json.loads(other.split(":", 1)[1])


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_tiny_size(cell):
    tiny = json.loads((ROOT / "benchmark" / "tests" / "tiny.json").read_text())["limits"]
    limits = tiny["report" if "report" in cell else "serve"]
    for seed in (3, 4, 5):
        line, other = _run(cell, seed, "--cpu-tiny")
        assert line["correct"] is True
        assert any(other[f"{name}_control"] > lim["limit"] for name, lim in limits.items()
                   if f"{name}_control" in other), (seed, other)


def _in_process(cell, capsys, seed=10):
    from benchmark import run
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "1", "--trace", "0",
                   "--cpu-tiny"])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _token_number(line):
    """The token check the cell compares: the widest gap, or the mean gap
    where the widest does not separate the program from its control."""
    checks = line["checks"]
    return checks["token_gap"] if "token_gap" in checks else checks["token_gap_mean"]


def _far(logits_last):
    """A token far from the best: the best id shifted by half the vocabulary."""
    v = logits_last.shape[-1]
    return (logits_last.argmax(-1) + v // 2) % v


@pytest.mark.parametrize("cell", REPORT)
def test_a_token_altered_where_it_is_produced_fails(cell, capsys, monkeypatch):
    import radialog_tpu_torch.decode.engine as engine
    orig = engine._select_token

    def altered(logits, dp, gen=None):
        return _far(logits).to(orig(logits, dp, gen).dtype)

    monkeypatch.setattr(engine, "_select_token", altered)
    line = _in_process(cell, capsys)
    assert line["correct"] is False
    assert _token_number(line)["value"] > _token_number(line)["limit"]


@pytest.mark.parametrize("cell", REPORT)
def test_a_findings_answer_altered_fails(cell, capsys, monkeypatch):
    import radialog_tpu_torch.models.chexpert as chexpert
    orig = chexpert.chexpert_classifier_apply

    def altered(*args, **kwargs):
        out = orig(*args, **kwargs).clone()
        out[0, 3] += 5.0 * float(out.std())
        return out

    monkeypatch.setattr(chexpert, "chexpert_classifier_apply", altered)
    line = _in_process(cell, capsys)
    assert line["correct"] is False
    assert line["checks"]["findings_err"]["value"] > line["checks"]["findings_err"]["limit"]


def _cache_tensors(cache):
    return [t for t in (cache.k, cache.v, cache.k_scale, cache.v_scale) if t is not None]


def _unchanged(fn, cache_of):
    """``fn`` with every cache tensor put back as it was before the call."""
    def wrapped(*args, **kwargs):
        cache = cache_of(args, kwargs)
        before = [t.clone() for t in _cache_tensors(cache)]
        out = fn(*args, **kwargs)
        for t, b in zip(_cache_tensors(cache), before):
            t.copy_(b)
        return out
    return wrapped


def _half_left_out(rows):
    """Every odd lane given the even lane's rows before it (the ring fills
    its lanes from the first, so both halves carry sessions)."""
    out = rows.clone()
    n = out.shape[0] // 2
    out[1:2 * n:2] = out[0:2 * n:2]
    return out


@pytest.mark.parametrize("cell", REPORT)
def test_a_decode_step_that_returns_its_state_unchanged_fails(cell, capsys, monkeypatch):
    import radialog_tpu_torch.decode.engine as engine
    monkeypatch.setattr(engine, "decode_step", _unchanged(
        engine.decode_step, lambda a, k: a[2] if len(a) > 2 else k["cache"]))
    assert _in_process(cell, capsys)["correct"] is False


@pytest.mark.parametrize("cell", REPORT)
def test_half_of_the_batch_left_out_in_decode_fails(cell, capsys, monkeypatch):
    import radialog_tpu_torch.decode.engine as engine
    orig = engine.decode_step
    monkeypatch.setattr(engine, "decode_step", lambda *a, **k: _half_left_out(orig(*a, **k)))
    line = _in_process(cell, capsys)
    assert line["correct"] is False
    assert _token_number(line)["value"] > _token_number(line)["limit"]


@pytest.mark.parametrize("cell", REPORT)
def test_half_of_the_images_left_out_fails(cell, capsys, monkeypatch):
    from benchmark import port
    orig = port.ImageSide.embed

    def halved(self, images):
        return _half_left_out(orig(self, images))

    monkeypatch.setattr(port.ImageSide, "embed", halved)
    assert _in_process(cell, capsys)["correct"] is False


def _ring_decode(wrap, monkeypatch):
    """Plant ``wrap`` around the ring's decode steps (one row a lane)."""
    import radialog_tpu_torch.decode.continuous as continuous
    orig = continuous.llama_apply
    planted = wrap(orig)

    def apply(*args, **kwargs):
        return (planted if args[2].shape[1] == 1 else orig)(*args, **kwargs)

    monkeypatch.setattr(continuous, "llama_apply", apply)


def test_a_ring_step_that_returns_its_state_unchanged_fails(capsys, monkeypatch):
    _ring_decode(lambda f: _unchanged(f, lambda a, k: k["cache"]), monkeypatch)
    assert _in_process("w8a8.serve-readers", capsys)["correct"] is False


def test_half_of_the_ring_left_out_fails(capsys, monkeypatch):
    def wrap(f):
        def step(*args, **kwargs):
            logits, cache = f(*args, **kwargs)
            return _half_left_out(logits), cache
        return step

    _ring_decode(wrap, monkeypatch)
    assert _in_process("w8a8.serve-readers", capsys)["correct"] is False


def test_a_ring_token_altered_where_it_is_produced_fails(capsys, monkeypatch):
    import torch
    import radialog_tpu_torch.decode.continuous as continuous
    orig = continuous.llama_apply

    def altered(*args, **kwargs):
        logits, cache = orig(*args, **kwargs)
        if logits.shape[1] == 1:            # a ring step: every lane's choice moved
            logits = logits.clone()
            lanes = torch.arange(logits.shape[0])
            logits[lanes, 0, _far(logits[:, 0])] = logits.max() + 1.0
        return logits, cache

    monkeypatch.setattr(continuous, "llama_apply", altered)
    line = _in_process("w8a8.serve-readers", capsys)
    assert line["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    limits = json.loads((ROOT / "benchmark" / "limits" / f"{cell}.json").read_text())
    for seed in (41, 42, 43):
        line, other = _run(cell, seed, timeout=1200)
        assert line["correct"] is True
        assert any(other[f"{name}_control"] > lim["limit"] for name, lim in limits.items()
                   if f"{name}_control" in other), (seed, other)


CONTROL_PATH = [w["name"] for w in BENCH["workloads"]
                if "control_path" in json.loads((ROOT / next(
                    c["file"] for c in BENCH["configs"] if c["name"] == w["config"])
                ).read_text())["reference"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CONTROL_PATH)
def test_program_on_its_control_path_fails_on_the_card(cell):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for seed in (44, 45, 46):
        p = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                            cell, "--seed", str(seed), "--seconds", "1", "--trace", "0",
                            "--control-path"], capture_output=True, text=True, timeout=1200,
                           cwd=ROOT)
        assert p.returncode == 0, p.stderr[-3000:]
        assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is False, seed


def test_the_control_path_runs_at_tiny_size():
    """The switch itself: the bf16 cell's program on the W8A8 path, judged
    by the bf16 reference and limits (the tiny sizes do not separate the
    two precisions; the card test above holds that)."""
    for cell in CONTROL_PATH:
        p = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                            cell, "--seed", "6", "--seconds", "1", "--trace", "0",
                            "--cpu-tiny", "--control-path"], capture_output=True, text=True,
                           timeout=900, cwd=ROOT)
        assert p.returncode == 0, p.stderr[-3000:]
        line = json.loads(p.stdout.strip().splitlines()[-1])
        limits = json.loads((ROOT / "benchmark" / "limits" / f"{cell}.json").read_text())
        assert set(line["checks"]) == set(limits)
        assert '"weights": "w8a8"' in p.stderr and '"precision": "bf16"' in p.stderr
