"""Dataset assembly (port of radialog_tpu/data/datasets.py, numpy and the
``csv`` module only): the MIMIC-CXR CSV joins of the evaluation
(``MimicPaths``, ``ReportGenData``, ``stratified_indices``), the
stage-1 trainer's image and caption records (``Stage1Data``) and the
instruct-dataset helpers of the finetune path (the balanced report/instruct
sampler, the report/instruct split and the JSON loader).

The JAX package reads the CSVs with pandas; this module reproduces what
pandas does there implicitly:
  * a cell whose text is in pandas' default ``na_values`` (``NA_VALUES``,
    the empty cell included) reads as NaN, and ``dropna`` on ``findings``
    drops its row;
  * the test split's rows are cut to ``truncate`` in file order, after the
    split filter;
  * the left merge on ``dicom_id`` keeps a study with no chexpert row (NaN
    labels) and repeats a study once per chexpert row of its ``dicom_id``;
  * the merged rows are numbered 0..n-1, so ``stratified_indices`` returns
    positions.
``dicom_id`` stays a string. Label cells are floats (blank: NaN).
"""
from __future__ import annotations

import csv
import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..eval.ce_metrics import CHEXPERT_COLS  # the scoring column order, re-exported
from .conversation import RADIALOG_SYSTEM, Conversation
from .prompts import ReportPrompt, structured_findings_string

# pandas 3.0.3's default na_values (pandas/_libs/parsers.pyx STR_NA_VALUES):
# a CSV cell of exactly one of these texts reads as NaN
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})

Row = Dict[str, object]


def _isnan(v) -> bool:
    return isinstance(v, float) and math.isnan(v)


def _read_csv_rows(path: Union[str, Path]) -> Tuple[List[str], List[Row]]:
    """(header, rows) of a CSV as pandas reads it with its defaults: blank
    lines skipped, NA texts as NaN, a short row filled with NaN. Values
    stay strings; the caller converts the numeric columns it uses."""
    with open(path, newline="", encoding="utf-8") as f:
        lines = [r for r in csv.reader(f) if r]
    header, body = lines[0], lines[1:]
    rows = []
    for r in body:
        r = r + [""] * (len(header) - len(r))
        rows.append({h: (math.nan if v in NA_VALUES else v) for h, v in zip(header, r)})
    return header, rows


def _float(v) -> object:
    """A label cell as pandas' float column holds it; other text as it is."""
    if _isnan(v):
        return v
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def _split_annotation(paths: "MimicPaths", split: str,
                      truncate: Optional[int]) -> Tuple[List[Row], List[Row]]:
    """(reports with findings, the split's rows cut to ``truncate`` in file
    order, findings with their newlines removed)."""
    _, split_rows = _read_csv_rows(paths.split_csv)
    _, reports = _read_csv_rows(paths.sectioned_csv)
    reports = [r for r in reports if not _isnan(r["findings"])]
    split_ids = {r["dicom_id"] for r in split_rows if r["split"] == split}
    ann = [dict(r) for r in reports if r["dicom_id"] in split_ids]
    if truncate is not None:
        ann = ann[:truncate]
    for r in ann:
        r["findings"] = r["findings"].replace("\n", "")
    return reports, ann


def _left_merge(ann: List[Row], chexpert_csv: str) -> List[Row]:
    """pandas' left merge on dicom_id: every chexpert row of a study, or one
    row of NaN labels where it has none."""
    chex_header, chex_rows = _read_csv_rows(chexpert_csv)
    label_cols = [c for c in chex_header if c != "dicom_id"]
    by_dicom: Dict[object, List[Row]] = {}
    for r in chex_rows:
        by_dicom.setdefault(r["dicom_id"], []).append(r)
    return [{**r, **{c: math.nan if m is None else _float(m[c]) for c in label_cols}}
            for r in ann for m in by_dicom.get(r["dicom_id"], [None])]


@dataclasses.dataclass
class MimicPaths:
    """File inputs of the evaluation's data."""

    split_csv: str                  # mimic-cxr-2.0.0-split.csv
    sectioned_csv: str              # mimic_cxr_sectioned.csv (the section parser's output)
    chexpert_csv: str               # finding_chexbert_labels.csv (ground-truth labels)
    predicted_findings_json: Optional[str] = None  # the classifier's structured predictions
    image_root: Optional[str] = None


class ReportGenData:
    """Joined records for report generation.

    ``annotation`` is the merged table as a list of row dicts (positions
    0..n-1). Record fields: text_input (the full vicuna prompt), text_target
    (the ground-truth findings), chexpert_labels (14,) float64, dicom,
    img_path, findings_string.
    """

    def __init__(self, paths: MimicPaths, split: str = "test",
                 prompt_type: str = "img_matching_examples_ig2_noexamples_IMG_findings",
                 truncate: Optional[int] = None, system: str = RADIALOG_SYSTEM):
        reports, ann = _split_annotation(paths, split, truncate)
        self.img_ids = {r["dicom_id"]: i for i, r in enumerate(reports)}
        for r in ann:
            r["subject_id"] = int(r["Img_Folder"].split("/")[2].lstrip("p"))
            r["study_id"] = int(r["Note_file"].lstrip("s").rstrip(".txt"))
        self.annotation: List[Row] = _left_merge(ann, paths.chexpert_csv)

        self.pred_findings: Dict[str, List[str]] = {}
        if paths.predicted_findings_json:
            self.pred_findings = json.loads(Path(paths.predicted_findings_json).read_text())
        self.prompt = ReportPrompt(prompt_type)
        self.system = system
        self.chexpert_cols = CHEXPERT_COLS
        self.image_root = paths.image_root

    def __len__(self) -> int:
        return len(self.annotation)

    def findings_for(self, dicom_id: str, row: Optional[Row] = None) -> Tuple[bool, str]:
        """The classifier's predicted findings if given, else the labels of
        exactly 1.0 in the chexpert CSV."""
        if self.pred_findings:
            labels = list(self.pred_findings.get(str(dicom_id), []))
        else:
            labels = [c for c in self.chexpert_cols if row is not None and row.get(c) == 1]
        return structured_findings_string(labels)

    def __getitem__(self, index: int) -> Dict:
        ann = self.annotation[index]
        dicom = ann["dicom_id"]
        no_labels, findings = self.findings_for(dicom, ann)
        conv = Conversation(system=self.system)
        conv.append_user(self.prompt(findings, no_labels=no_labels))
        conv.append_assistant(None)
        labels = [float(ann[c]) for c in self.chexpert_cols]
        return {
            "text_input": conv.get_prompt(),
            "text_target": ann["findings"].strip(),
            "chexpert_labels": np.asarray(labels, np.float64),
            "dicom": dicom,
            "img_path": f"{ann['Img_Folder']}/{ann['Img_Filename']}",
            "findings_string": findings,
        }

    def records(self) -> List[Dict]:
        return [self[i] for i in range(len(self))]


class Stage1Data:
    """Image and caption records of Q-Former stage-1 training: the split,
    sectioned and (where given) chexpert CSV joins, the findings with their
    newlines removed as the caption, and the custom-epoch subsets: the rows
    fall into ``custom_epochs_per_epoch`` contiguous subsets, one per
    sub-epoch (2 for the whole train split, else 1)."""

    def __init__(self, paths: MimicPaths, split: str = "train",
                 truncate: Optional[int] = None,
                 custom_epochs_per_epoch: Optional[int] = None):
        reports, ann = _split_annotation(paths, split, truncate)
        self.img_ids = {r["dicom_id"]: i for i, r in enumerate(reports)}
        self.annotation: List[Row] = (_left_merge(ann, paths.chexpert_csv)
                                      if paths.chexpert_csv else ann)
        if custom_epochs_per_epoch is None:
            custom_epochs_per_epoch = 2 if split == "train" and truncate is None else 1
        self.custom_epochs_per_epoch = custom_epochs_per_epoch
        self.current_custom_epoch = 0
        self.image_root = paths.image_root

    def set_custom_epoch(self, custom_epoch: int) -> None:
        self.current_custom_epoch = custom_epoch % self.custom_epochs_per_epoch

    def __len__(self) -> int:
        return len(self.annotation) // self.custom_epochs_per_epoch

    def __getitem__(self, index: int) -> Dict:
        subset_size = len(self.annotation) // self.custom_epochs_per_epoch
        ann = self.annotation[self.current_custom_epoch * subset_size + index]
        img_path = f"{ann['Img_Folder']}/{ann['Img_Filename']}"
        if self.image_root:
            img_path = f"{self.image_root}/{img_path}"
        return {"img_path": img_path, "text_output": ann["findings"].strip(),
                "image_id": self.img_ids[ann["dicom_id"]], "dicom": ann["dicom_id"]}


def stratified_indices(annotation: Sequence[Row],
                       chexpert_cols: Sequence[str] = tuple(CHEXPERT_COLS),
                       simulated_epochs: int = 1) -> List[int]:
    """Positions of the finding-positive rows x simulated_epochs, then the
    no-finding rows capped at 1/14 of the result."""
    cols = list(chexpert_cols)
    no_finding = [r["No Finding"] == 1 or sum(r[c] == 1 for c in cols) == 0
                  for r in annotation]
    no_idx = [i for i, nf in enumerate(no_finding) if nf]
    f_idx = [i for i, nf in enumerate(no_finding) if not nf]
    f_idx = f_idx * simulated_epochs
    new_no_count = int(len(f_idx) * 14 / 13 / 14)
    return f_idx + no_idx[:new_no_count]


def balanced_epoch_indices(rep_idxs: Sequence[int], inst_idxs: Sequence[int],
                           rng: np.random.Generator) -> List[int]:
    """Per epoch: sample len(inst_idxs) report examples, merge them with all
    instruct examples, shuffle."""
    rep = list(rep_idxs)
    take = rng.choice(len(rep), size=min(len(inst_idxs), len(rep)), replace=False)
    merged = [rep[i] for i in take] + list(inst_idxs)
    rng.shuffle(merged)
    return merged


def load_instruct_dataset(path: Union[str, Path]) -> List[Dict]:
    """Records {instruction, input, output, dicom (optional), task}."""
    return json.loads(Path(path).read_text())


def split_report_instruct(records: List[Dict]) -> Tuple[List[int], List[int]]:
    """Indices of the report-generation ("RG", the default task) and of the
    instruct examples."""
    rep, inst = [], []
    for i, r in enumerate(records):
        (rep if r.get("task", "RG") == "RG" else inst).append(i)
    return rep, inst
