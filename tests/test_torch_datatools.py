"""The data tools of the PyTorch port against the JAX package: the report
section parser (data/section_parser.py) and the create_sections command
line, the instruct-data generators (data/instruct.py) and the create_data
command line in both modes. Both packages' functions are plain Python and
numpy here, so every output is held equal: the same sections, the same
records, and byte-identical CSV and JSON files, from the same seeds. The
INS mode's teacher is a stub on both sides (a fixed answer a prompt), and
once the port's mock pipeline on the CPU (the task counts of the stub run).
"""
import csv
import importlib.util
import json
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from radialog_tpu.data import instruct as ji
from radialog_tpu.data import section_parser as jsp
from radialog_tpu_torch.apps import create_data as tcd
from radialog_tpu_torch.apps import create_sections as tcs
from radialog_tpu_torch.data.datasets import CHEXPERT_COLS
from radialog_tpu_torch.data import instruct as ti
from radialog_tpu_torch.data import section_parser as tsp

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
HEAD = "                                 FINAL REPORT\n"
REPORTS = [
    HEAD + " EXAMINATION:  CHEST (PA AND LAT)\n \n INDICATION:  Cough.\n \n TECHNIQUE:  PA and "
    "lateral views.\n \n COMPARISON:  None.\n \n FINDINGS: \n \n The lungs are clear. No pleural"
    " effusion.\n \n IMPRESSION: \n \n No acute process.\n",
    " The heart is mildly enlarged. Lungs clear.\n \n No acute cardiopulmonary process.\n",
    HEAD + " HISTORY:  Fever.\n \n IMPRESSON:  Right lower lobe pneumonia.\n",
    HEAD + " PORTABLE CHEST:  There is a right pleural effusion.\n \n CONCLUSION:  Effusion.\n",
    HEAD + " FINDINGS:\n \n IMPRESSION:  Clear.\n",
    HEAD + " IMPRESSION:  First.\n \n IMPRESSION:  Second.\n",
    HEAD + " WET READ: ABC 10:42 PM  no pneumothorax\n \n FINDNGS:  Stable cardiomegaly.\n \n"
    " COMPARISION:  Prior study.\n \n RECOMMENDATION(S):  Follow-up.\n",
    HEAD + " REASON FOR EXAM:  Line placement.\n \n FRONTAL AND LATERAL VIEWS OF THE CHEST:  "
    "The tube ends 3 cm above the carina.\n \n NOTIFICATION:  Called.\n",
    HEAD + " EXAMINATION:  Chest.\n \n Some text without impression.\n \n A final paragraph.\n",
    "",
]


# ------------------------------------------------------------ section parser
def test_section_parser_functions():
    for raw in ["IMPRESSON", "Findings and Impression", "chest, two views", "AP view",
                "Recommendation(s)", "pfi", "Wetread", "unknown header", " history of x "]:
        assert tsp.normalize_section_name(raw) == jsp.normalize_section_name(raw)
    assert tsp.custom_mimic_cxr_rules() == jsp.custom_mimic_cxr_rules()
    assert tsp.SECTIONED_COLUMNS == jsp.SECTIONED_COLUMNS
    stems = ["s50000001", "s50913680", "s58235663", "s50525523", "s51491012"]
    for i, text in enumerate(REPORTS):
        assert tsp.split_sections(text) == jsp.split_sections(text)
        assert tsp.parse_report(text) == jsp.parse_report(text)
        for stem in stems:
            for rules in (False, True):
                assert (tsp.parse_report_with_rules(stem, text * 3, rules)
                        == jsp.parse_report_with_rules(stem, text * 3, rules)), (i, stem, rules)


def _report_tree(root: Path):
    """A miniature MIMIC-CXR report tree and JPEG tree: two p-groups, studies
    with 0-3 dicoms, one study under a manual rule of each kind."""
    reports, jpgs = root / "reports", root / "jpgs"
    rng = np.random.default_rng(0)
    n = 0
    for grp, patients in (("p11", ["p11000003", "p11000001"]), ("p10", ["p10000002"])):
        for patient in patients:
            for k in range(3):
                stem = ["s50913680", "s58235663"][n] if n < 2 else f"s5{n:07d}"
                (reports / grp / patient).mkdir(parents=True, exist_ok=True)
                (reports / grp / patient / f"{stem}.txt").write_text(REPORTS[n % len(REPORTS)])
                img = jpgs / grp / patient / stem
                img.mkdir(parents=True)
                for d in range(int(rng.integers(0, 4))):
                    (img / f"{n:03d}-{d}.jpg").write_bytes(b"")
                n += 1
    (reports / "p10" / "notes.csv").write_text("not a patient")
    return reports, jpgs


def _root_module(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}", REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rules", [False, True])
def test_create_sections_bytes(tmp_path, monkeypatch, capsys, rules):
    reports, jpgs = _report_tree(tmp_path)
    argv = ["--reports_path", str(reports), "--mimic_cxr_jpg_path", str(jpgs)]
    argv += ["--apply-custom-rules"] if rules else []
    monkeypatch.setattr(sys, "argv", ["create_sections.py"] + argv
                        + ["--output_path", str(tmp_path / "jax")])
    _root_module("create_sections").main()
    tcs.main(argv + ["--output_path", str(tmp_path / "port")])
    jax_out, port_out = capsys.readouterr().out.strip().splitlines()
    name = "mimic_cxr_sectioned.csv"
    assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert port_out == jax_out.replace("jax", "port")
    with open(tmp_path / "port" / name, newline="") as f:
        rows = list(csv.reader(f))
    assert len(rows) > 5 and rows[0] == tsp.SECTIONED_COLUMNS
    assert len(list(tcs.iter_studies(reports, jpgs))) == 9


# ----------------------------------------------------------------- instruct
def teacher(prompts):
    """A fixed answer a prompt: the prompt and a checksum of it."""
    return [f"{p} reply {zlib.crc32(p.encode())}." for p in prompts]


def _records(n, rng):
    cols = CHEXPERT_COLS
    recs = []
    for i in range(n):
        labels = rng.choice([1.0, 0.0, -1.0, np.nan], 14)
        recs.append({"text_target": f"Report {i}: lungs clear.", "dicom": f"d{i:03d}",
                     "chexpert_labels": labels, "text_input": f"prompt {i}",
                     "findings_string": "edema" if i % 3 else ""})
    return recs, cols


def test_instruct_generators(tmp_path):
    assert ti.DEFAULT_PROMPTS == ji.DEFAULT_PROMPTS
    assert ti.MIMIC_NLE_DIAGNOSES == ji.MIMIC_NLE_DIAGNOSES
    with open(tmp_path / "EL_prompts.csv", "w", newline="") as f:
        csv.writer(f).writerows([["instruction"], ["Say it simply."], ["Simpler, please."]])
    for task in ("EL", "SU"):
        assert ti.load_prompt_bank(task, str(tmp_path)) == ji.load_prompt_bank(task, str(tmp_path))
    for n in range(0, 40, 7):
        a, b = np.random.default_rng(n), np.random.default_rng(n)
        assert ti.split_six_ways(n, a) == ji.split_six_ways(n, b)
    recs, cols = _records(30, np.random.default_rng(1))
    banks = {k: ji.load_prompt_bank(k) for k in ("CO_both", "CO_add", "CO_rem")}
    corr = [{"gt_report": f"gt {i}", "pred_report": f"pred {i}", "dicom": f"d{i}",
             "fp": [["Edema"], [], ["Edema", "Fracture"], []][i % 4],
             "fn": [[], ["Pneumonia"], ["Cardiomegaly"], []][i % 4]} for i in range(15)]
    nle = [{"report_ID": f"s{i}", "nle": "lungs clear" if i % 2 else "absent",
            "diagnosis_label": [int(v) for v in np.random.default_rng(i).integers(0, 2, 10)]}
           for i in range(6)]
    by_note = {f"s{i}": {"findings": "the lungs clear today", "dicom_id": f"d{i}"}
               for i in range(5)}
    out = {}
    for name, pkg in (("jax", ji), ("port", ti)):
        rng = np.random.default_rng(5)
        tasks = pkg.generate_direct_tasks(teacher, recs[:14], "EL", pkg.load_prompt_bank("EL"),
                                          rng)
        tasks += pkg.generate_cp_tasks(recs[14:22], "CPbQA", pkg.load_prompt_bank("CPbQA"),
                                       cols, rng)
        tasks += pkg.generate_cp_tasks(recs[22:], "CPaQA", pkg.load_prompt_bank("CPaQA"),
                                       cols, rng)
        tasks += pkg.generate_correction_tasks(teacher, corr, banks, rng, batch_size=4)
        tasks += pkg.generate_nle_tasks(nle, by_note, pkg.load_prompt_bank("RE"), rng)
        fused = pkg.fuse_instruct_dataset(recs[:9], tasks, "Findings: {findings}.",
                                          {r["dicom"]: r["findings_string"] for r in recs}, rng)
        pkg.save_instruct_json(fused, tmp_path / name / "out.json")
        out[name] = (tasks, rng.random())
    assert out["port"] == out["jax"]
    assert {t["task_type"] for t in out["port"][0]} == {"EL", "CPbQA", "CPaQA", "CO", "RE"}
    assert (tmp_path / "port" / "out.json").read_bytes() == \
        (tmp_path / "jax" / "out.json").read_bytes()
    with pytest.raises(ValueError):
        ti.generate_cp_tasks(recs[:1], "XX", ["?"], cols, np.random.default_rng(0))


# -------------------------------------------------------------- create_data
class StubPipeline:
    """The teacher of both packages' create_data: ``teacher`` for both
    serving shapes; records which was called."""

    calls = []

    def __init__(self, cfg=None):
        pass

    def generate_texts_ring(self, prompts, max_new_tokens=None, lanes=12):
        self.calls.append(("ring", len(prompts), max_new_tokens, lanes))
        return teacher(prompts)

    def generate_texts(self, prompts, max_new_tokens=None):
        self.calls.append(("batch", len(prompts), max_new_tokens))
        return teacher(prompts)


@pytest.mark.parametrize("mode,extra", [("RG", []), ("INS", ["--teacher", "batch"]),
                                        ("INS", ["--seed", "7"])])
def test_create_data_bytes(tmp_path, monkeypatch, capsys, mode, extra):
    import radialog_tpu.apps.pipeline as jpipe
    monkeypatch.setattr(jpipe, "RaDialogPipeline", StubPipeline)
    argv = ["--mode", mode, "--fixture-dir", str(FIXTURES), "--mock"] + extra
    monkeypatch.setattr(sys, "argv", ["create_data.py"] + argv
                        + ["--output-dir", str(tmp_path / "jax")])
    StubPipeline.calls = []
    _root_module("create_data").main()
    jax_calls, StubPipeline.calls = StubPipeline.calls, []
    tcd.main(argv + ["--output-dir", str(tmp_path / "port")], teacher_pipeline=StubPipeline())
    assert StubPipeline.calls == jax_calls
    jax_lines, port_lines = _halves(capsys.readouterr().out)
    assert port_lines == [ln.replace("/jax/", "/port/") for ln in jax_lines]
    name = ("mimic_cxr_reports_stratified.json" if mode == "RG"
            else "mimic_cxr_instruct_stratified.json")
    assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    records = json.loads((tmp_path / "port" / name).read_text())
    assert records and all(r["task"] for r in records)


def _halves(out):
    lines = out.strip().splitlines()
    return lines[:len(lines) // 2], lines[len(lines) // 2:]


def test_create_data_ins_mock_pipeline_on_cpu(tmp_path, capsys):
    """The INS mock with the port's own mock pipeline (W8A8, int8 ring) on
    the CPU: the same tasks, and as many of each, as the stub's run."""
    argv = ["--mode", "INS", "--fixture-dir", str(FIXTURES), "--mock", "--device", "cpu"]
    tcd.main(argv + ["--output-dir", str(tmp_path / "mock")])
    tcd.main(argv + ["--output-dir", str(tmp_path / "stub")], teacher_pipeline=StubPipeline())
    mock_lines, stub_lines = _halves(capsys.readouterr().out)
    assert [ln.split(" -> ")[0] for ln in mock_lines] == [ln.split(" -> ")[0] for ln in stub_lines]
    name = "mimic_cxr_instruct_stratified.json"
    mock = json.loads((tmp_path / "mock" / name).read_text())
    stub = json.loads((tmp_path / "stub" / name).read_text())
    assert [(r["task"], r["dicom"]) for r in mock] == [(r["task"], r["dicom"]) for r in stub]
    teacher_tasks = [r for r in mock if r["task"] in ("EL", "SU", "RQA", "CO")]
    assert teacher_tasks and all(r["output"] for r in teacher_tasks)
