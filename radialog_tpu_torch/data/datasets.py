"""Instruct-dataset helpers of the finetune path, copied from
radialog_tpu/data/datasets.py (numpy only): the balanced report/instruct
sampler, the report/instruct split and the JSON loader. The MIMIC-CXR CSV
joins of that module are not ported yet."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np


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
