"""Instruct-dataset generation: the 7 RaDialog dialog tasks (port of
radialog_tpu/data/instruct.py, copied: numpy only).

The behavioral contract of data/create_data.py:304-412 +
data/instruct_tasks.py:88-360. Task families:

  EL / SU / RQA  — teacher-LLM-generated: easy language, summarization,
                   free-form report QA (instruct_tasks.py:88-141)
  CPbQA / CPaQA  — synthesized from CheXpert labels: binary "is there <X>?"
                   and "name all findings" (instruct_tasks.py:144-191)
  CO             — correction: teacher rewrites an incorrect predicted report
                   given fp/fn lists (instruct_tasks.py:219-307)
  RE             — reasoning from MIMIC-NLE explanations (309-360)

The teacher is injected as a ``generate_fn(prompts) -> answers`` callable
(apps/create_data.py serves it through the pipeline's decode stack); prompt
banks are data — the built-ins below are the reference's
data/instruct_prompts/*.csv contents verbatim (typos included), overridable
by CSVs with an ``instruction`` column (the same layout). Every function
draws from the caller's numpy Generator in the JAX package's order, so the
same seed writes the same bytes.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

from .conversation import Conversation, RADIALOG_SYSTEM

# ---------------------------------------------------------------- prompt banks
# Verbatim contents of the reference's data/instruct_prompts/*.csv (data
# contract: the released LoRA was trained on instruct data drawn from exactly
# these strings, so paraphrasing them shifts the training prompt
# distribution). Typos are the reference's own and deliberately preserved:
# "they patient" (CO_both), "List all the finding" (CPaQA), "mediatinum" /
# "okey" (RQA), "summery" (SU), and the U+2019 apostrophe in CO_add.
# tests/test_torch_datatools.py holds each bank equal to the JAX package's.
DEFAULT_PROMPTS: Dict[str, List[str]] = {
    "EL": [
        "Explain this report in very easy terms, such that a child would understand.",
        "Given this chest xray report, formulate it in easy language.",
        "Reformulate this report in simple and understandable language.",
        "Given this xray report, please rewrite it in easy language for a patient without medical expertise.",
        "Give me a simple version of this report not requiring expert knowledge to understand.",
        "Please reformulate this chest x-ray report using simple terms, such that a patient can understand it easily.",
        "Please rewrite this report in simple language.",
        "Please reformulate this report in very easy language.",
        "Please write a simple version of this report for a child to understand.",
        "Translate this report to easy language for a patient to understand.",
    ],
    "SU": [
        "Summarize this report with bullet points.",
        "Provide a short summary of the most important points in this chest x-ray report.",
        "Write a short summary of this report, please.",
        "Please summarize this report in one sentence.",
        "Please provide a concise summarization of the findings in this report.",
        "Please summarize the given report in maximum two sentences.",
        "Write a concise summery of the major findings in this chest xray report.",
        "Give me a summary of this report as a bulletpoint list.",
        "Write a bulleted list summarizing this x-ray report.",
    ],
    "RQA": [
        "Is the patient's heart healthy?",
        "Does the patient have any abnormalities in the osseous structures?",
        "Are there any abnormalities in the lungs?",
        "Are the patient's lungs healthy?",
        "Are there any problems in the bones?",
        "Are there any abnormalities in the mediatinum?",
        "Does the patient have any heart-related issues?",
        "Are there any pulmonary abnormalities described in the report?",
        "Is the heart of this patient healthy?",
        "Is everything okey with the patient's lung?",
    ],
    "CPbQA": [
        "Is there evidence of <X> in the report?",
        "Is there any <X>?",
        "Is any <X> evident in the report?",
        "Is there any indication of <X> in the report?",
        "Does the report mention <X>?",
        "Does the patient have <X>?",
        "Is there any sign of <X> in the report?",
    ],
    "CPaQA": [
        "List all the finding in this report.",
        "Enumerate the observations from the report.",
        "What findings can be identified from this report?",
        "Detail the key conclusions from this report.",
        "What are the key observations derived from this report?",
        "Enumerate the findings mentioned in the report.",
        "Detail the observations noted in this report.",
        "List all the findings.",
        "Please enumerate the major positive observations described in the report.",
        "Provide the findings highlighted in the report.",
    ],
    "CO_both": [
        "I disagree with the generated report, I think the patient has <add> but does not have <rem>. Please adapt the report.",
        "You forgot to mention <add>. Also, they patient does not have <rem>, please remove this.",
        "Please adapt the report with the following corrections: Include <add> and remove <rem>.",
    ],
    "CO_add": [
        "The patient also has <add>, correct the report.",
        "You forgot to mention <add>. Please update the report.",
        "Please provide an adapted report. Mention <add>. Don’t make any other changes.",
        "I think the patient has some <add>. Please add this to the report.",
        "There is <add>, which you have missed. Please rewrite the report.",
        "I think you missed <add>, please provide a corrected report.",
    ],
    "CO_rem": [
        "You mentioned <rem>, but I don't think this is the case. Correct the report.",
        "There is no <rem>, please adapt the report accordingly.",
        "The patient does not have <rem>. Update the report.",
        "Write a corrected report, where you don't mention <rem>.",
        "I disagree with your report, I think there is no <rem>, correct this.",
    ],
    "RE": [
        "What are the indicators for <X> in the report?",
        "Why do you think the patient has <X>?",
        "What are the symptoms of this patient for <X>?",
        "Which symptoms led to the diagnosis of <X>?",
        "What in the report is indicative of <X>?",
        "Can you explain why you think the patient has <X>?",
        "Given the report, what led to the conclusion that the patient has <X>?",
        "What are the reasons for the diagnosis of <X>?",
        "Which signs show that the patient has <X>?",
        "What explanations for the diagnosis of <X> does the report give?",
        "Can you explain the diagnosis of <X>? What are the reasons?",
    ],
}

MIMIC_NLE_DIAGNOSES = [
    "Atelectasis", "Consolidation", "Edema", "Enlarged Cardiomediastinum",
    "Lung Lesion", "Lung Opacity", "Pleural Effusion", "Pleural Other",
    "Pneumonia", "Pneumothorax",
]


def load_prompt_bank(task: str, csv_dir: Optional[str] = None) -> List[str]:
    """CSV with an `instruction` column when available, else the built-ins."""
    if csv_dir:
        p = Path(csv_dir) / f"{task}_prompts.csv"
        if p.exists():
            import csv as _csv
            with open(p, newline="") as f:
                return [r["instruction"] for r in _csv.DictReader(f)]
    return list(DEFAULT_PROMPTS[task])


def _and_join(names: Sequence[str]) -> str:
    s = ", ".join(names)
    return " and ".join(s.rsplit(", ", 1))


def _teacher_conv(user_turns: List, system: str = RADIALOG_SYSTEM) -> str:
    conv = Conversation(system=system)
    for role_is_user, msg in user_turns:
        (conv.append_user if role_is_user else conv.append_assistant)(msg)
    conv.append_assistant(None)
    return conv.get_prompt()


# ------------------------------------------------------------------ generators
def split_six_ways(n: int, rng: np.random.Generator):
    """create_data.py:310-321: random 6-way split (EL, CO-slot, SU, EX, RQA,
    CPQA), CPQA further halved into (CPbQA, CPaQA). Returns dict of index
    lists."""
    perm = rng.permutation(n)
    base, rem = divmod(n, 6)
    sizes = [base + (i < rem) for i in range(6)]
    parts = []
    off = 0
    for s in sizes:
        parts.append(perm[off:off + s].tolist())
        off += s
    el, co_slot, su, ex, rqa, cpqa = parts
    half, hrem = divmod(len(cpqa), 2)
    return {"EL": el, "CO_slot": co_slot, "SU": su, "EX": ex, "RQA": rqa,
            "CPbQA": cpqa[:half + hrem], "CPaQA": cpqa[half + hrem:]}


def generate_direct_tasks(generate_fn: Callable[[List[str]], List[str]],
                          records: List[Dict], task_name: str,
                          prompts: List[str], rng: np.random.Generator,
                          batch_size: int = 12) -> List[Dict]:
    """EL/SU/RQA: 'Report: <gt>\\n<prompt>' -> teacher answer
    (instruct_tasks.py:88-141)."""
    out = []
    for i0 in range(0, len(records), batch_size):
        chunk = records[i0:i0 + batch_size]
        chosen = [prompts[rng.integers(len(prompts))] for _ in chunk]
        instructions = [
            _teacher_conv([(True, f"Report: {r['text_target']}\n{p}")])
            for r, p in zip(chunk, chosen)]
        answers = generate_fn(instructions)
        for r, p, instr, a in zip(chunk, chosen, instructions, answers):
            out.append({"gt_report": r["text_target"], "task": p,
                        "instruction": instr, "input": "",
                        "output": a.split("ASSISTANT:")[-1].strip(),
                        "dicom": r["dicom"], "task_type": task_name})
    return out


def generate_cp_tasks(records: List[Dict], task_name: str,
                      prompts: List[str], chexpert_cols: Sequence[str],
                      rng: np.random.Generator) -> List[Dict]:
    """CPbQA/CPaQA synthesized from labels (instruct_tasks.py:144-191):
    binary QA samples a positive finding 60% of the time."""
    out = []
    for r in records:
        prompt = prompts[rng.integers(len(prompts))]
        labels = np.asarray(r["chexpert_labels"])
        findings = [chexpert_cols[j] for j in np.where(labels == 1.0)[0]]
        if task_name == "CPbQA":
            pos = [f for f in findings if f != "No Finding"]
            if rng.random() < 0.6 and pos:
                finding = pos[rng.integers(len(pos))]
                answer = "yes"
            else:
                neg = sorted(set(chexpert_cols[1:]) - set(findings))
                finding = neg[rng.integers(len(neg))]
                answer = "no"
            prompt = prompt.replace("<X>", finding)
        elif task_name == "CPaQA":
            answer = ", ".join(findings)
        else:
            raise ValueError(task_name)
        out.append({"gt_report": r["text_target"], "task": prompt, "input": "",
                    "output": answer, "dicom": r["dicom"],
                    "task_type": task_name})
    return out


def generate_correction_tasks(generate_fn: Callable[[List[str]], List[str]],
                              correction_preds: List[Dict],
                              banks: Dict[str, List[str]],
                              rng: np.random.Generator,
                              batch_size: int = 12) -> List[Dict]:
    """CO: teacher corrects stored incorrect predictions given fp/fn name
    lists (instruct_tasks.py:219-307). correction_preds entries:
    {gt_report, pred_report, fp: [names], fn: [names], dicom}."""
    out = []
    for i0 in range(0, len(correction_preds), batch_size):
        chunk = correction_preds[i0:i0 + batch_size]
        fixed, train_prompts = [], []
        for s in chunk:
            fp, fn = _and_join(s["fp"]), _and_join(s["fn"])
            fixed_p = "Please provide an adapted report. "
            if fp:
                fixed_p += f"Do not mention {fp}. "
            if fn:
                fixed_p += f"Mention {fn}. "
            if not fp and not fn:
                fixed_p = "NOCHANGE"
            fixed.append(fixed_p.strip())
            if not fp and not fn:
                train_prompts.append("NOCHANGE")
            elif not fp:
                bank = banks["CO_add"]
                train_prompts.append(bank[rng.integers(len(bank))].replace("<add>", fn))
            elif not fn:
                bank = banks["CO_rem"]
                train_prompts.append(bank[rng.integers(len(bank))].replace("<rem>", fp))
            else:
                bank = banks["CO_both"]
                train_prompts.append(bank[rng.integers(len(bank))]
                                     .replace("<add>", fn).replace("<rem>", fp))
        instructions = [
            _teacher_conv([(True, "Please write a radiology report for the given x-ray."),
                           (False, s["pred_report"]), (True, fx)])
            for s, fx in zip(chunk, fixed)]
        answers = generate_fn(instructions)
        for s, tp, instr, a in zip(chunk, train_prompts, instructions, answers):
            if tp == "NOCHANGE":
                continue  # never train correction on already-correct reports
            out.append({"gt_report": s["gt_report"],
                        "incorrect_report": s["pred_report"], "task": tp,
                        "instruction": instr, "input": "",
                        "output": a.split("ASSISTANT:")[-1].strip(),
                        "dicom": s["dicom"], "task_type": "CO"})
    return out


def generate_nle_tasks(nle_records: Iterable[Dict], reports_by_note: Dict[str, Dict],
                       prompts: List[str], rng: np.random.Generator) -> List[Dict]:
    """RE: MIMIC-NLE explanations whose nle text appears in the findings
    (instruct_tasks.py:309-360). nle_records: {report_ID, nle,
    diagnosis_label: [10 ints]}; reports_by_note: note stem -> {findings,
    dicom_id}."""
    out = []
    for sample in nle_records:
        rep = reports_by_note.get(sample["report_ID"])
        if rep is None:
            continue
        findings = rep["findings"]
        if sample["nle"] not in findings:
            continue
        diagnoses = [d for j, d in enumerate(MIMIC_NLE_DIAGNOSES)
                     if sample["diagnosis_label"][j] == 1]
        prompt = prompts[rng.integers(len(prompts))].replace(
            "<X>", _and_join(diagnoses))
        out.append({"gt_report": findings, "task": prompt, "input": "",
                    "output": sample["nle"], "dicom": rep["dicom_id"],
                    "task_type": "RE"})
    return out


# ------------------------------------------------------------------------ fuse
def fuse_instruct_dataset(report_records: List[Dict],
                          task_records: List[Dict],
                          report_prompt_template: str,
                          findings_by_dicom: Dict[str, str],
                          rng: np.random.Generator) -> List[Dict]:
    """create_data.py:344-412: RG examples (instruction=full prompt,
    output=GT findings) + instruct examples wrapped as a second dialog turn
    after a synthetic first RG turn. CPaQA outputs lowercased."""
    fused: List[Dict] = []
    for r in report_records:
        fused.append({"instruction": r["text_input"], "input": "",
                      "output": r["text_target"], "dicom": r["dicom"],
                      "task": "RG"})
    for elem in task_records:
        first_report = (elem["incorrect_report"] if elem["task_type"] == "CO"
                        else elem["gt_report"])
        conv = Conversation(system=RADIALOG_SYSTEM)
        conv.append_user(report_prompt_template)
        conv.append_assistant(first_report)
        conv.append_user(elem["task"])
        conv.append_assistant(None)
        instruction = conv.get_prompt()
        findings = findings_by_dicom.get(str(elem["dicom"]), "") or "no common findings"
        instruction = instruction.format(findings=findings)
        output = elem["output"]
        if elem["task_type"] == "CPaQA":
            output = output.lower()
        fused.append({"instruction": instruction, "input": "",
                      "output": output.strip(), "dicom": elem["dicom"],
                      "task": elem["task_type"]})
    order = rng.permutation(len(fused))
    return [fused[i] for i in order]


def save_instruct_json(records: List[Dict], path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(records, indent=4, ensure_ascii=False))
