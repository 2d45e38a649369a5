"""Rehearsals of the harness on the CPU at the tiny sizes of tiny.json (the
kernels' plain versions), the checks that no run loads JAX or the JAX
package and that the plain reference imports nothing of the program, and
the card runs (marked ``cuda``; they skip without a card, decided inside
the test)."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PENDING = {p.stem: json.loads(p.read_text()) for p in (ROOT / "benchmark" / "pending").glob("*.json")}
CELLS = [w["name"] for w in BENCH["workloads"]] + sorted(PENDING)
FORBIDDEN = {"jax", "jaxlib", "flax", "radialog_tpu"}


def run(*args, timeout=600):
    return subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), *args],
                          capture_output=True, text=True, timeout=timeout, cwd=ROOT)


def last_line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def metric_names(kind: str, cell: str):
    entries = BENCH[kind] + (PENDING[cell][kind] if cell in PENDING else [])
    return {m["name"] for m in entries if "workloads" not in m or cell in m["workloads"]}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_prints_the_contracts_line(cell, trace):
    p = run("--workload", cell, "--seed", "2147483693", "--seconds", "1.5", "--trace",
            str(trace), "--cpu-tiny")
    assert p.returncode == 0, p.stderr[-3000:]
    line = last_line(p.stdout)
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"
    for name, v in line["checks"].items():
        assert f"check {name}: {v['value']!r} limit {v['limit']!r}" in p.stderr
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        # the CPU has no kernels: only the host's metrics can be read
        assert set(line["metrics"]) <= metric_names("per_layer", cell)
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert set(line["metrics"]) == metric_names("end_to_end", cell)
        assert all(v["value"] > 0 for v in line["metrics"].values())


def test_same_seed_same_inputs_and_tokens():
    a = run("--workload", CELLS[0], "--seed", "77", "--seconds", "0.1", "--trace", "0",
            "--cpu-tiny")
    b = run("--workload", CELLS[0], "--seed", "77", "--seconds", "0.1", "--trace", "0",
            "--cpu-tiny")
    assert a.returncode == b.returncode == 0
    assert last_line(a.stdout)["checks"] == last_line(b.stdout)["checks"]


def test_a_run_without_a_card_fails_and_prints_no_result():
    p = run("--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0")
    if p.returncode == 0:
        pytest.skip("a CUDA device is present")
    assert p.returncode == 3
    assert "CUDA device" in p.stderr
    assert not p.stdout.strip()


@pytest.mark.parametrize("cell", CELLS)
def test_no_jax_module_after_a_run(cell):
    code = ("import sys, json\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "from benchmark import run\n"
            f"rc = run.main(['--workload', {cell!r}, '--seed', '5', '--seconds', '0.5', "
            "'--trace', '0', '--cpu-tiny'])\n"
            "print(json.dumps([rc, sorted({m.split('.')[0] for m in sys.modules})]))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    rc, tops = json.loads(p.stdout.strip().splitlines()[-1])
    assert rc == 0
    assert "radialog_tpu_torch" in tops
    assert not FORBIDDEN & set(tops)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def test_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "benchmark" / "reference").glob("*.py"))
    files.append(ROOT / "benchmark" / "weights.py")
    assert len(files) >= 3
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in FORBIDDEN | {"radialog_tpu_torch"}, (f, name)
            # nor through the benchmark's own modules that drive the program
            assert not name.startswith(("benchmark.port", "benchmark.drivers", ".port",
                                        "..port", "..drivers")), (f, name)


def test_no_benchmark_file_imports_jax():
    for f in (ROOT / "benchmark").rglob("*.py"):
        for name in _imports(f):
            assert name.split(".")[0] not in FORBIDDEN, (f, name)


def test_every_metric_has_its_reader_and_every_cell_its_files():
    bench_dir = ROOT / "benchmark"
    for m in BENCH["per_layer"] + [m for p in PENDING.values() for m in p["per_layer"]]:
        assert (bench_dir / "metrics" / f"{m['name']}.py").exists(), m["name"]
    names = {w["name"] for w in BENCH["workloads"]}
    for name, p in PENDING.items():
        assert p["workload"]["name"] == name and name not in names
        for m in p["end_to_end"] + p["per_layer"]:
            assert m["workloads"] == [name], m["name"]
    for w in BENCH["workloads"] + [p["workload"] for p in PENDING.values()]:
        assert (bench_dir / "traffic" / f"{w['traffic']}.json").exists()
        assert (bench_dir / "limits" / f"{w['name']}.json").exists()
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"] == []


@pytest.mark.parametrize("seconds", [51.0, 20.0])
def test_serving_schedule_holds_its_rate_and_sizes_on_every_seed(seconds):
    sys.path.insert(0, str(ROOT))
    from benchmark.drivers.serve import schedule
    tr = json.loads((ROOT / "benchmark" / "traffic" / "serve-readers.json").read_text())
    rate = tr["rate_sessions_per_s"]
    runs = [schedule(tr, seed, seconds, rate, (3, 100000), 80) for seed in (1, 2 ** 31 + 5)]
    for sessions in runs:
        at = [s["at"] for s in sessions]
        assert len(at) == round(rate * seconds) and at == sorted(at)
        assert 0 <= at[0] and at[-1] < seconds
        # one burst (a period at burst_factor times the others' rate) in
        # each of as many equal stretches of the window
        period = tr["burst_period_s"]
        n = int(-(-seconds // period))
        density = [sum(1 for t in at if i * period <= t < (i + 1) * period)
                   / min(period, seconds - i * period) for i in range(n)]
        calm = sorted(density)[n // 2]
        busy = [i for i in range(n) if density[i] > 2 * calm]
        edges = [round(n * j / round(tr["burst_share"] * n))
                 for j in range(round(tr["burst_share"] * n) + 1)]
        assert [sum(a <= i < b for i in busy) for a, b in zip(edges, edges[1:])] == \
            [1] * (len(edges) - 1)

    def sizes(sessions):
        return [sorted(len(s["text"]) for s in sessions), sorted(s["new"] for s in sessions),
                sorted(len(s["followups"]) for s in sessions),
                sorted(len(q) for s in sessions for q, _ in s["followups"]),
                sorted(new for s in sessions for _, new in s["followups"])]

    assert sizes(runs[0]) == sizes(runs[1])
    assert [s["image"] for s in runs[0]] != [s["image"] for s in runs[1]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = run("--workload", cell, "--seed", "31", "--seconds", "5", "--trace", "0", timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    line = last_line(p.stdout)
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
