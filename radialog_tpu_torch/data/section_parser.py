"""MIMIC-CXR radiology report sectioning (port of
radialog_tpu/data/section_parser.py, copied: plain Python, its tables kept
here as data).

The behavioral contract of mimic-cxr/section_parser.py:5-205 +
create_section_files.py:35-114:
split a raw report on ALL-CAPS ``HEADER:`` lines, normalize header
spellings to canonical section names, extract the *last* occurrence of
impression/findings/last_paragraph/comparison, and emit one CSV row per
dicom image with columns
[impression, findings, last_paragraph, comparison, dicom_id, Img_Filename,
 Img_Folder, Note_file].

The normalization table is a data contract (observed MIMIC-CXR header
variants incl. typos); reproduced as data, organized our own way.
"""
from __future__ import annotations

import csv
import re
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

_HEADER_RE = re.compile(r"\n ([A-Z ()/,-]+):\s", re.DOTALL)

# canonical name -> header variants seen in MIMIC-CXR (incl. typos)
_CANONICAL_VARIANTS: Dict[str, Tuple[str, ...]] = {
    "preamble": ("preamble",),
    "impression": (
        "impression", "conclusion", "findings and impression",
        "findings/impression", "findings/ impression", "ndication",
        "impresson", "imprression", "imoression", "impressoin", "imprssion",
        "impresion", "imperssion", "mpression", "impession",
    ),
    "comparison": (
        "comparison", "comparisons", "reference exam", "comparison exam",
        "comparison film", "comparision", "comparsion", "comparrison",
        "comparisions",
    ),
    "indication": (
        "indication", "reason for examination", "reason for exam",
        "clinical indication", "idication",
    ),
    "findings": (
        "findings", "chest, two views", "finding", "findins", "findindgs",
        "findgings", "findngs", "findnings", "finidngs", "reference findings",
    ),
    "examination": ("examination", "exam", "type of examination"),
    "technique": ("technique",),
    "history": (
        "history", "clinical history", "clinical information",
        "patient history", "pfi",
    ),
    "notification": ("notification",),
    "recommendations": ("recommendation(s)", "recommendations", "recommendation"),
    "addendum": ("addendum",),
    "date": ("date",),
    "comment": ("comment",),
    "wet read": ("wet read", "wetread"),
}

_VARIANT_TO_CANONICAL: Dict[str, str] = {
    v: canon for canon, vs in _CANONICAL_VARIANTS.items() for v in vs
}

_MAIN_SECTIONS = ("impression", "findings", "history", "comparison", "addendum")

_FINDINGS_HINTS = re.compile(
    "(" + "|".join([
        "chest", "portable", "pa and lateral", "lateral and pa",
        "ap and lateral", "lateral and ap", "frontal and", "two views",
        "frontal view", "pa view", "ap view", "one view", "lateral view",
        "bone window", "frontal upright", "frontal semi-upright", "ribs",
        "pa and lat",
    ]) + ")")


def normalize_section_name(raw: str) -> str:
    """Header text -> canonical section name (section_parser.py:91-205)."""
    s = raw.lower().strip()
    if s in _VARIANT_TO_CANONICAL:
        return _VARIANT_TO_CANONICAL[s]
    for m in _MAIN_SECTIONS:
        if m in s:
            return m
    if _FINDINGS_HINTS.search(s):
        return "findings"
    return s


def split_sections(text: str) -> Tuple[List[str], List[str]]:
    """Raw report -> (section texts, normalized names), in document order.

    Mirrors section_text (section_parser.py:5-88): leading text becomes
    'preamble'; a report with no headers is one 'full report' section; empty
    impression/findings sections are dropped; when neither impression nor
    findings exists, the final blank-line-separated paragraph of the last
    section is split off as 'last_paragraph'.
    """
    sections: List[str] = []
    names: List[str] = []

    match = _HEADER_RE.search(text, 0)
    if match is None:
        sections.append(text)
        names.append("full report")
    else:
        sections.append(text[: match.start(1)])
        names.append("preamble")
        while match is not None:
            header = match.group(1).lower()
            body_start = match.end()
            # skip past the first newline to dodge header-like text on the
            # same line
            nl = text[body_start:].find("\n")
            skip = nl if nl != -1 else 0
            nxt = _HEADER_RE.search(text, body_start + skip)
            body_end = nxt.start() if nxt is not None else len(text)
            sections.append(text[body_start:body_end])
            names.append(header)
            match = nxt
        names = [normalize_section_name(n) for n in names]

    # drop empty impression/findings sections (handles title-like openers)
    for i in reversed(range(len(names))):
        if names[i] in ("impression", "findings") and sections[i].strip() == "":
            sections.pop(i)
            names.pop(i)

    if "impression" not in names and "findings" not in names:
        if "\n \n" in sections[-1]:
            parts = sections[-1].split("\n \n")
            sections[-1] = parts[0]
            sections.append("\n \n".join(parts[1:]))
            names.append("last_paragraph")

    return sections, names


def parse_report(text: str) -> Dict[str, str]:
    """Extract the four target sections, taking the LAST occurrence of each
    (create_section_files.py list_rindex)."""
    sections, names = split_sections(text)
    out: Dict[str, str] = {}
    for target in ("impression", "findings", "last_paragraph", "comparison"):
        for i in reversed(range(len(names))):
            if names[i] == target:
                out[target] = sections[i].strip()
                break
    return out


# ---------------------------------------------------------------------------
# Manually determined sections for poorly formatted reports.
#
# Data contract from mimic-cxr/section_parser.py:207-270 (originating in the
# upstream MIT-LCP/mimic-cxr text tools). Two tables keyed by study stem:
#   custom_section_names: study -> the section name whose text should be used
#   custom_indices:       study -> [start, end) character slice of raw text
#                          ([0, 0] = the report has no findings at all)
#
# NOTE ON REFERENCE BEHAVIOR: RaDialog's create_section_files.py *loads* these
# (create_section_files.py:47) but never applies them in its main loop, so the
# shipped mimic_cxr_sectioned.csv reflects the automatic parser only. We expose
# the tables and let the CLI apply them behind an explicit flag
# (apply_custom_rules) whose default (False) matches the reference's output
# byte-for-byte on the affected studies.
# ---------------------------------------------------------------------------

CUSTOM_SECTION_NAMES: Dict[str, str] = {
    "s50913680": "recommendations",
    "s59363654": "examination",
    "s59279892": "technique",
    "s59768032": "recommendations",
    "s57936451": "indication",
    "s50058765": "indication",
    "s53356173": "examination",
    "s53202765": "technique",
    "s50808053": "technique",
    "s51966317": "indication",
    "s50743547": "examination",
    "s56451190": "note",
    "s59067458": "recommendations",
    "s59215320": "examination",
    "s55124749": "indication",
    "s54365831": "indication",
    "s59087630": "recommendations",
    "s58157373": "recommendations",
    "s56482935": "recommendations",
    "s58375018": "recommendations",
    "s54654948": "indication",
    "s55157853": "examination",
    "s51491012": "history",
}

CUSTOM_INDICES: Dict[str, Tuple[int, int]] = {
    "s50525523": (201, 349),
    "s57564132": (233, 554),
    "s59982525": (313, 717),
    "s53488209": (149, 475),
    "s54875119": (234, 988),
    "s50196495": (59, 399),
    "s56579911": (59, 218),
    "s52648681": (292, 631),
    "s59889364": (172, 453),
    "s53514462": (73, 377),
    "s59505494": (59, 450),
    "s53182247": (59, 412),
    "s51410602": (47, 320),
    "s56412866": (522, 822),
    "s54986978": (59, 306),
    "s59003148": (262, 505),
    "s57150433": (61, 394),
    "s56760320": (219, 457),
    "s59562049": (158, 348),
    "s52674888": (145, 296),
    "s55258338": (192, 568),
    "s59330497": (140, 655),
    "s52119491": (179, 454),
    # no findings at all in the entire report
    "s58235663": (0, 0),
    "s50798377": (0, 0),
    "s54168089": (0, 0),
    "s53071062": (0, 0),
    "s56724958": (0, 0),
    "s54231141": (0, 0),
    "s53607029": (0, 0),
    "s52035334": (0, 0),
}


def custom_mimic_cxr_rules() -> Tuple[Dict[str, str], Dict[str, Tuple[int, int]]]:
    """(custom_section_names, custom_indices) — section_parser.py:207-270."""
    return CUSTOM_SECTION_NAMES, CUSTOM_INDICES


def parse_report_with_rules(study_stem: str, text: str,
                            apply_custom_rules: bool = False) -> Dict[str, str]:
    """parse_report plus the optional manual-rule overrides.

    When ``apply_custom_rules`` is True, studies in CUSTOM_INDICES take their
    findings from the raw-text character slice (empty slice -> no findings),
    and studies in CUSTOM_SECTION_NAMES take as findings the named section's
    text — the upstream tooling's semantics. Default False reproduces the
    reference pipeline, which loads but never applies the rules
    (create_section_files.py:47).
    """
    if apply_custom_rules and study_stem in CUSTOM_INDICES:
        lo, hi = CUSTOM_INDICES[study_stem]
        out: Dict[str, str] = {}
        sliced = text[lo:hi].strip()
        if sliced:
            out["findings"] = sliced
        return out
    out = parse_report(text)
    if apply_custom_rules and study_stem in CUSTOM_SECTION_NAMES:
        target = CUSTOM_SECTION_NAMES[study_stem]
        sections, names = split_sections(text)
        for i in reversed(range(len(names))):
            if names[i] == target:
                out["findings"] = sections[i].strip()
                break
    return out


SECTIONED_COLUMNS = ["impression", "findings", "last_paragraph", "comparison",
                     "dicom_id", "Img_Filename", "Img_Folder", "Note_file"]


def build_sectioned_csv(studies: Iterable[Tuple[str, str, str, List[str]]],
                        output_path: str | Path,
                        apply_custom_rules: bool = False) -> int:
    """Write mimic_cxr_sectioned.csv.

    ``studies``: iterable of (study_stem e.g. 's501...', report_text,
    img_folder e.g. 'files/p10/p10000032/s50414267', dicom_ids).
    Returns number of rows written. One row per dicom (create_section_files.py
    fan-out).
    """
    n = 0
    with open(output_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(SECTIONED_COLUMNS)
        for study_stem, text, img_folder, dicom_ids in studies:
            secs = parse_report_with_rules(study_stem, text, apply_custom_rules)
            base = [secs.get("impression"), secs.get("findings"),
                    secs.get("last_paragraph"), secs.get("comparison")]
            for d in dicom_ids:
                w.writerow(base + [d, f"{d}.jpg", img_folder, f"{study_stem}.txt"])
                n += 1
    return n
