"""Instruct-dataset creation command line (port of the root create_data.py;
no pandas): ``--mode RG`` writes the stratified report-generation training
JSON; ``--mode INS`` generates the 7 dialog tasks (the teacher LLM writes
EL, SU, RQA and CO) and fuses them with the RG data into
mimic_cxr_instruct_stratified.json.

The teacher decodes through the pipeline's serving stack on the card:
``generate_texts_ring`` (the continuous-batching ring, 12 lanes) by
default, ``generate_texts`` (one fixed batch) with ``--teacher batch``. The
mock builds the tiny seeded pipeline (W8A8, int8 cache) and synthesizes a
few incorrect predictions and one explanation.

  python -m radialog_tpu_torch.apps.create_data --mode INS --mock \\
      --fixture-dir tests/fixtures --output-dir /tmp/instruct_out [--device cpu]

Without ``--device`` the teacher runs on the card. ``random`` and numpy's
generator are seeded in the JAX package's order, so a run writes the same
bytes as the root create_data.py given the same teacher answers.
"""
from __future__ import annotations

import argparse
import json
import random
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..data.datasets import CHEXPERT_COLS, MimicPaths, ReportGenData, stratified_indices
from ..data.instruct import (fuse_instruct_dataset, generate_correction_tasks,
                             generate_cp_tasks, generate_direct_tasks, generate_nle_tasks,
                             load_prompt_bank, save_instruct_json, split_six_ways)
from ..data.prompts import VICUNA_PROMPTS


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="RaDialog instruct data creation (PyTorch)")
    p.add_argument("--mode", type=str, default="RG", choices=["RG", "INS"])
    p.add_argument("--fixture-dir", type=str, default=None)
    p.add_argument("--split_csv", type=str, default=None)
    p.add_argument("--sectioned_csv", type=str, default=None)
    p.add_argument("--chexpert_csv", type=str, default=None)
    p.add_argument("--preds_json", type=str, default=None)
    p.add_argument("--prompt_csv_dir", type=str, default=None)
    p.add_argument("--correction_preds_json", type=str, default=None)
    p.add_argument("--nle_json", type=str, default=None)
    p.add_argument("--vicuna_path", type=str, default=None,
                   help="teacher model (reference: Vicuna-13B)")
    p.add_argument("--output-dir", type=str, default="data_out")
    p.add_argument("--simulated_epochs", type=int, default=2)
    p.add_argument("--mock", action="store_true", default=False)
    p.add_argument("--teacher", type=str, default="ring", choices=["ring", "batch"],
                   help="teacher serving shape: 'ring' streams the prompts through the "
                        "continuous-batching RingBatcher (12 lanes), 'batch' decodes them "
                        "as one fixed batch")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None, teacher_pipeline=None) -> None:
    """``teacher_pipeline``: a built pipeline to decode with instead of the
    one the flags describe (the chip smoke passes its full-width one)."""
    args = parse_args(argv)
    random.seed(args.seed)
    rng = np.random.default_rng(args.seed)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    fx = Path(args.fixture_dir) if args.fixture_dir else None
    paths = MimicPaths(
        split_csv=args.split_csv or str(fx / "split.csv"),
        sectioned_csv=args.sectioned_csv or str(fx / "sectioned.csv"),
        chexpert_csv=args.chexpert_csv or str(fx / "chexpert.csv"),
        predicted_findings_json=args.preds_json or
        (str(fx / "preds.json") if fx and (fx / "preds.json").exists() else None))
    ds = ReportGenData(paths, split="train")
    records = ds.records()
    print(f"train records: {len(records)}")
    rg_template = VICUNA_PROMPTS["img_matching_examples_ig2_noexamples_IMG_findings"]

    if args.mode == "RG":
        idx = stratified_indices(ds.annotation, simulated_epochs=args.simulated_epochs)
        rg = [{"instruction": ds[i]["text_input"], "input": "", "output": ds[i]["text_target"],
               "dicom": ds[i]["dicom"], "task": "RG"} for i in idx]
        out = out_dir / "mimic_cxr_reports_stratified.json"
        save_instruct_json(rg, out)
        print(f"wrote {len(rg)} RG examples -> {out}")
        return

    # ---- INS mode: the teacher LLM and the tasks synthesized from labels
    pipe = teacher_pipeline
    if pipe is None:
        from .pipeline import PipelineConfig, RaDialogPipeline
        pipe = RaDialogPipeline(PipelineConfig(mock=args.mock, quantize=args.mock,
                                               vicuna_path=args.vicuna_path,
                                               device=args.device))
    max_new = 64 if args.mock else 256

    def teacher(prompts):
        if args.teacher == "ring":
            return pipe.generate_texts_ring(prompts, max_new_tokens=max_new, lanes=12)
        return pipe.generate_texts(prompts, max_new_tokens=max_new)

    splits = split_six_ways(len(records), rng)
    tasks = []
    for task in ("EL", "SU", "RQA"):
        recs = [records[i] for i in splits[task]]
        tasks += generate_direct_tasks(teacher, recs, task,
                                       load_prompt_bank(task, args.prompt_csv_dir), rng)
        print(f"{task}: {len(splits[task])} examples")
    for task in ("CPbQA", "CPaQA"):
        recs = [records[i] for i in splits[task]]
        tasks += generate_cp_tasks(recs, task, load_prompt_bank(task, args.prompt_csv_dir),
                                   CHEXPERT_COLS, rng)
        print(f"{task}: {len(splits[task])} examples")

    if args.correction_preds_json:
        corr = json.loads(Path(args.correction_preds_json).read_text())
    elif args.mock:  # a few incorrect predictions
        corr = [{"gt_report": r["text_target"],
                 "pred_report": r["text_target"] + " Mild cardiomegaly.",
                 "fp": ["Cardiomegaly"], "fn": [], "dicom": r["dicom"]}
                for r in records[:3]]
    else:
        corr = []
    if corr:
        banks = {k: load_prompt_bank(k, args.prompt_csv_dir)
                 for k in ("CO_both", "CO_add", "CO_rem")}
        tasks += generate_correction_tasks(teacher, corr, banks, rng)
        print(f"CO: {len(corr)} candidates")

    if args.nle_json:
        nle = [json.loads(line) for line in Path(args.nle_json).read_text().splitlines() if line]
    elif args.mock:
        nle = [{"report_ID": ds.annotation[0]["Note_file"].rstrip(".txt"),
                "nle": records[0]["text_target"].split(".")[0] + ".",
                "diagnosis_label": [1] + [0] * 9}]
    else:
        nle = []
    if nle:
        # rstrip(".txt") strips characters, as the reference's does
        reports_by_note = {row["Note_file"].rstrip(".txt"):
                           {"findings": row["findings"].replace("\n", ""),
                            "dicom_id": row["dicom_id"]}
                           for row in ds.annotation}
        tasks += generate_nle_tasks(nle, reports_by_note,
                                    load_prompt_bank("RE", args.prompt_csv_dir), rng)

    idx = stratified_indices(ds.annotation, simulated_epochs=args.simulated_epochs)
    rg_records = [ds[i] for i in idx]
    findings_by_dicom = {str(r["dicom"]): r["findings_string"] for r in records}
    fused = fuse_instruct_dataset(rg_records, tasks, rg_template, findings_by_dicom, rng)
    out = out_dir / "mimic_cxr_instruct_stratified.json"
    save_instruct_json(fused, out)
    by_task = {}
    for f in fused:
        by_task[f["task"]] = by_task.get(f["task"], 0) + 1
    print(f"wrote {len(fused)} fused examples -> {out}; by task: {by_task}")


if __name__ == "__main__":
    main()
