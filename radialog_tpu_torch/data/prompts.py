"""Prompt bank and report prompt processor (port of
radialog_tpu/data/prompts.py, copied as it is).

The four vicuna_prompts.json templates; the *_IMG_findings ones carry the
32 <IMG> placeholders that the LLaMA forward replaces with projected
Q-Former embeddings.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Union

N_IMG_TOKENS = 32
IMG_RUN = "<IMG>" * N_IMG_TOKENS

_RG_TASK = (
    "You are to act as a radiologist and write the finding section of a chest "
    "x-ray radiology report for this X-ray image and the given predicted "
    "findings. Write in the style of a radiologist, write one fluent text "
    "without enumeration, be concise and don't provide explanations or reasons."
)

VICUNA_PROMPTS: Dict[str, str] = {
    "img_matching_examples_ig2_noexamples": (
        "You are to act as a radiologist and write the finding section of a "
        "chest x-ray radiology report for a patient presenting with a list of "
        "findings. Please write the findings section of a chest x-ray "
        "radiology report for a patient with the following findings: "
        "{findings} Write in the style of a radiologist, write one fluent "
        "text without enumeration, be concise and don't provide explanations "
        "or reasons. Make sure the mentioned findings occur in the report."
    ),
    "img_neg_matching_examples_ig2_noexamples": (
        "You are to act as a radiologist and write a chest x-ray radiology "
        "report for a patient presenting without findings. Here are a few "
        "examples of how such reports could look like. Please write the "
        "findings section of a chest x-ray radiology report for a patient "
        "whose results show no abnormalities. Write in the style of a "
        "radiologist, write one fluent text without enumeration, be concise "
        "and don't provide explanations or reasons."
    ),
    "img_matching_examples_ig2_noexamples_IMG_findings": (
        f"Image information: {IMG_RUN}. Predicted Findings: {{findings}}. " + _RG_TASK
    ),
    "img_neg_matching_examples_ig2_noexamples_IMG_findings": (
        f"Image information: {IMG_RUN}. Predicted Findings: {{findings}}. " + _RG_TASK
    ),
}


def load_prompt_bank(path: Optional[Union[str, Path]] = None) -> Dict[str, str]:
    """vicuna_prompts.json if it exists, else the built-in bank."""
    if path is not None and Path(path).exists():
        return json.loads(Path(path).read_text(encoding="UTF-8"))
    return dict(VICUNA_PROMPTS)


class ReportPrompt:
    """Formats the findings string into the prompt (positive template; the
    negative one is looked up beside it)."""

    def __init__(self, prompt_type: str = "img_matching_examples_ig2_noexamples_IMG_findings",
                 bank: Optional[Dict[str, str]] = None):
        bank = bank or VICUNA_PROMPTS
        self.prompt = bank[prompt_type]
        self.prompt_neg = bank[prompt_type.replace("matching_examples",
                                                   "neg_matching_examples")]

    def __call__(self, findings: str, no_labels: bool = False) -> str:
        if no_labels:
            findings = "no common findings"
        return self.prompt.format(findings=findings)


def structured_findings_string(pred_labels: list[str]) -> tuple[bool, str]:
    """Classifier label list -> the prompt's findings string: "No Finding"
    dropped when real findings coexist; lowercase, comma-joined."""
    labels = list(pred_labels)
    no_labels = len(labels) == 0
    counter = 0
    no_findings = "No Finding" in labels
    if no_findings:
        counter += 1
    if "Support Devices" in labels:
        counter += 1
    if len(labels) > counter and no_findings:
        labels.remove("No Finding")
    return no_labels, ", ".join(labels).lower().strip()
