"""The evaluation's data layer of the port against the JAX package:
``ReportGenData`` and ``stratified_indices`` (the JAX ones read the CSVs
with pandas, the port's with the csv module), the conversation template,
the report prompt, the structured findings string, the correction-turn
helpers and the CSV writers. Everything here is compared for equality:
strings, label arrays (NaN where JAX has NaN) and written bytes."""
import importlib
import json
from pathlib import Path

import numpy as np
import pytest

from radialog_tpu.data import conversation as jconv
from radialog_tpu.data import datasets as jds
from radialog_tpu.data import downstream as jdown
from radialog_tpu.data import prompts as jprompts
from radialog_tpu_torch.data import conversation as tconv
from radialog_tpu_torch.data import datasets as tds
from radialog_tpu_torch.data import downstream as tdown
from radialog_tpu_torch.data import prompts as tprompts
from radialog_tpu_torch.eval import ce_metrics as tce

# the JAX package's eval/__init__ re-exports the function ce_metrics under
# the module's name
jce = importlib.import_module("radialog_tpu.eval.ce_metrics")

FIXTURES = Path(__file__).resolve().parent / "fixtures"
LABELS = tds.CHEXPERT_COLS


def _paths(mod, root: Path, preds: bool):
    return mod.MimicPaths(split_csv=str(root / "split.csv"),
                          sectioned_csv=str(root / "sectioned.csv"),
                          chexpert_csv=str(root / "chexpert.csv"),
                          predicted_findings_json=str(root / "preds.json") if preds else None)


def _assert_same_data(root: Path, preds: bool, split: str, truncate):
    """Both packages' ReportGenData over the same files: records, image
    ids and the stratified sample."""
    ref = jds.ReportGenData(_paths(jds, root, preds), split=split, truncate=truncate)
    got = tds.ReportGenData(_paths(tds, root, preds), split=split, truncate=truncate)
    assert len(got) == len(ref)
    assert got.img_ids == ref.img_ids
    for r, g in zip(ref.records(), got.records()):
        assert g["chexpert_labels"].dtype == np.float64 and g["chexpert_labels"].shape == (14,)
        np.testing.assert_array_equal(g.pop("chexpert_labels"), r.pop("chexpert_labels"))
        assert isinstance(g["dicom"], str)
        assert g == r
    assert list(ref.annotation.index) == list(range(len(ref)))
    want = [ref.annotation.index.get_loc(i) for i in jds.stratified_indices(ref.annotation)]
    assert tds.stratified_indices(got.annotation) == want
    for epochs in (2, 3):
        assert tds.stratified_indices(got.annotation, simulated_epochs=epochs) == \
            jds.stratified_indices(ref.annotation, simulated_epochs=epochs)
    return got


@pytest.mark.parametrize("truncate", [None, 3])
@pytest.mark.parametrize("preds", [True, False])
@pytest.mark.parametrize("split", ["test", "validate", "train"])
def test_report_gen_data_of_the_fixtures_matches_jax(split, preds, truncate):
    got = _assert_same_data(FIXTURES, preds, split, truncate)
    assert len(got) == {"test": 6, "validate": 2, "train": 4}[split] if truncate is None \
        else len(got) == min(3, {"test": 6, "validate": 2, "train": 4}[split])


def _write_crafted(root: Path) -> None:
    """CSVs with what pandas reads implicitly: empty and NA-spelled findings
    (dropped), multi-line findings, a study with no chexpert row, a repeated
    chexpert dicom_id, blank and -1.0 labels, a blank line, a short row."""
    root.mkdir(parents=True, exist_ok=True)
    ids = [f"s{i:02d}-x" for i in range(14)]
    split = ["test"] * 10 + ["train", "validate", "test", "test"]
    (root / "split.csv").write_text(
        "dicom_id,study_id,subject_id,split\n"
        + "".join(f"{d},{i},{i},{s}\n" for i, (d, s) in enumerate(zip(ids, split))))
    findings = ["", "NA", "None", "Clear lungs.\nNo effusion.", "null", "N/A",
                "Mild edema. \"Stable\" heart,\r\nsmall effusion", "nan", "  Opacity.  ",
                "Cardiomegaly.", "Rib fracture.", "Pneumothorax.", "#N/A", "Last one."]
    rows = ["impression,findings,last_paragraph,comparison,dicom_id,Img_Filename,"
            "Img_Folder,Note_file"]
    for i, (d, f) in enumerate(zip(ids, findings)):
        cell = '"' + f.replace('"', '""') + '"' if any(c in f for c in ',"\n\r') else f
        rows.append(f"see findings,{cell},,None,{d},{d}.jpg,files/p10/p100000{i:02d}/s5{i:07d},"
                    f"s5{i:07d}.txt")
    rows.insert(4, "")                               # a blank line: skipped
    (root / "sectioned.csv").write_text("\n".join(rows) + "\n")
    head = "dicom_id," + ",".join(LABELS)
    chex = [head]
    rng = np.random.default_rng(0)
    for i, d in enumerate(ids):
        if i == 9:
            continue                                 # no chexpert row: NaN labels
        vals = rng.choice(["1.0", "0.0", "-1.0", ""], size=14)
        if i == 3:
            vals[:] = ""                             # every label blank
        if i == 8:
            vals[:] = "0.0"                          # no finding at all
        chex.append(d + "," + ",".join(vals))
        if i == 6:                                   # the same dicom_id twice
            chex.append(d + "," + ",".join(rng.choice(["1.0", "-1.0", "NA"], size=14)))
    chex.append(ids[13] + ",1.0,0.0")               # a second, short row: the rest NaN
    (root / "chexpert.csv").write_text("\n".join(chex) + "\n")
    (root / "preds.json").write_text(json.dumps(
        {ids[3]: ["No Finding", "Support Devices"], ids[6]: ["Edema", "No Finding"],
         ids[8]: []}))


@pytest.mark.parametrize("truncate", [None, 2, 5])
@pytest.mark.parametrize("preds", [True, False])
def test_report_gen_data_of_crafted_csvs_matches_jax(tmp_path, preds, truncate):
    _write_crafted(tmp_path)
    got = _assert_same_data(tmp_path, preds, "test", truncate)
    if truncate is None:
        dicoms = [r["dicom_id"] for r in got.annotation]
        # empty / NA / None / null / N/A / nan / #N/A findings dropped; s06
        # and s13 (its short row) twice
        assert dicoms == ["s03-x", "s06-x", "s06-x", "s08-x", "s09-x", "s13-x", "s13-x"]
        assert all(np.isnan(got[4]["chexpert_labels"]))          # no chexpert row
        assert "\n" not in got[0]["text_target"]
        assert set(np.unique(got[1]["chexpert_labels"][~np.isnan(got[1]["chexpert_labels"])])) \
            <= {-1.0, 0.0, 1.0}


@pytest.mark.parametrize("split", ["train", "validate"])
def test_report_gen_data_of_crafted_csvs_other_splits_match_jax(tmp_path, split):
    _write_crafted(tmp_path)
    _assert_same_data(tmp_path, False, split, None)


def test_na_values_are_pandas_defaults():
    from pandas._libs.parsers import STR_NA_VALUES
    assert tds.NA_VALUES == frozenset(STR_NA_VALUES)


# ------------------------------------------------------------- conversation
@pytest.mark.parametrize("style", ["SINGLE", "TWO"])
def test_conversation_matches_jax(style):
    msgs = [("USER", "Describe the image."), ("ASSISTANT", "The heart is enlarged."),
            ("USER", "Is there any edema?"), ("ASSISTANT", None)]
    convs = []
    for mod in (jconv, tconv):
        c = mod.Conversation(sep_style=getattr(mod.SeparatorStyle, style))
        for role, m in msgs:
            c.append(role, m)
        convs.append(c)
    assert convs[1].get_prompt() == convs[0].get_prompt()
    assert convs[1].copy().get_prompt() == convs[0].copy().get_prompt()
    c = tconv.Conversation(system=tconv.DEMO_SYSTEM).append_user("hi").append_assistant()
    r = jconv.Conversation(system=jconv.DEMO_SYSTEM).append_user("hi").append_assistant()
    assert c.get_prompt() == r.get_prompt()
    assert (tconv.RADIALOG_SYSTEM, tconv.DEMO_SYSTEM) == (jconv.RADIALOG_SYSTEM, jconv.DEMO_SYSTEM)


@pytest.mark.parametrize("decoded", [
    "sys USER: x ASSISTANT: The lungs are clear.",
    "sys USER: x ASSISTANT: Report: Mild edema. ASSISTANT: more",
    "sys USER: x ASSISTANT: some report: text REPORT: other",
    "sys USER: x ASSISTANT:"])
def test_reply_extraction_matches_jax(decoded):
    assert tconv.extract_report(decoded) == jconv.extract_report(decoded)
    assert tconv.extract_assistant_reply(decoded) == jconv.extract_assistant_reply(decoded)
    assert tconv.single_turn_prompt(decoded) == jconv.single_turn_prompt(decoded)


@pytest.mark.parametrize("labels", [[], ["No Finding"], ["No Finding", "Support Devices"],
                                    ["Edema", "No Finding", "Support Devices"],
                                    ["Cardiomegaly", "Pleural Effusion"], ["Support Devices"]])
def test_prompts_match_jax(labels):
    assert tprompts.structured_findings_string(labels) == \
        jprompts.structured_findings_string(labels)
    for kind in tprompts.VICUNA_PROMPTS:
        if "neg_" in kind:
            continue
        t, j = tprompts.ReportPrompt(kind), jprompts.ReportPrompt(kind)
        assert (t.prompt, t.prompt_neg) == (j.prompt, j.prompt_neg)
        no_labels, findings = tprompts.structured_findings_string(labels)
        assert t(findings, no_labels=no_labels) == j(findings, no_labels=no_labels)
    assert (tprompts.N_IMG_TOKENS, tprompts.IMG_RUN) == (jprompts.N_IMG_TOKENS, jprompts.IMG_RUN)


def test_prompt_bank_matches_jax(tmp_path):
    assert tprompts.load_prompt_bank() == jprompts.load_prompt_bank() == tprompts.VICUNA_PROMPTS
    bank = tmp_path / "vicuna_prompts.json"
    bank.write_text(json.dumps({"a": "x {findings}"}), encoding="UTF-8")
    assert tprompts.load_prompt_bank(bank) == jprompts.load_prompt_bank(bank)
    assert tprompts.load_prompt_bank(tmp_path / "missing.json") == tprompts.VICUNA_PROMPTS


# ------------------------------------------------------------- correction turn
def test_correction_helpers_match_jax():
    rng = np.random.default_rng(5)
    pred = rng.integers(0, 2, (12, 14)).astype(np.float64)
    gt = rng.integers(0, 2, (12, 14)).astype(np.float64)
    gt[0], pred[0] = pred[0], pred[0]            # nothing to correct: KEEP_OLD
    gt[1], pred[1] = 0.0, 0.0
    pred[1, 2] = 1.0                             # a false positive only
    gt[2], pred[2] = 0.0, 0.0
    gt[2, [3, 5, 9]] = 1.0                       # false negatives only, three of them
    assert tdown.fp_fn_lists(LABELS, pred, gt) == jdown.fp_fn_lists(LABELS, pred, gt)
    hists = [f"sys USER: <IMG> q{i} ASSISTANT: report {i}." for i in range(12)]
    got = tdown.correction_prompts(hists, LABELS, pred, gt)
    assert got == jdown.correction_prompts(hists, LABELS, pred, gt)
    assert tdown.KEEP_OLD == jdown.KEEP_OLD and tdown.KEEP_OLD in got[0]
    assert "does not have" in got[1] and "also has" in got[2]
    for p in got:
        decoded = p + " The corrected report. ASSISTANT: tail"
        assert tdown.correction_extract(decoded, p) == jdown.correction_extract(decoded, p)
    for fp, fn in (([], []), (["Edema"], []), ([], ["A", "B"]), (["A", "B", "C"], ["D"])):
        assert tdown.correction_prompt(fp, fn) == jdown.correction_prompt(fp, fn)
        assert tdown._and_join(fp + fn) == jdown._and_join(fp + fn)


# ------------------------------------------------------------- CSV writers
def test_csv_writers_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 4, (7, 14))
    texts = ['plain', 'with "quotes", and a comma', 'new\nline', '', "trailing  ", "a,b", "x"]
    np.testing.assert_array_equal(tce.class_ids_to_label_matrix(ids),
                                  jce.class_ids_to_label_matrix(ids))
    for name in ("t", "j"):
        mod = tce if name == "t" else jce
        mod.write_predictions_csv(texts, tmp_path / f"pred_{name}.csv")
        mod.write_labels_csv(ids, texts, tmp_path / f"labels_{name}.csv")
    for kind in ("pred", "labels"):
        assert (tmp_path / f"{kind}_t.csv").read_bytes() == (tmp_path / f"{kind}_j.csv").read_bytes()
    got = tce.read_labels_csv(tmp_path / "labels_t.csv")
    np.testing.assert_array_equal(got, jce.read_labels_csv(tmp_path / "labels_j.csv"))
    assert got.shape == (7, 14)
