"""Section the MIMIC-CXR free-text reports into mimic_cxr_sectioned.csv
(port of the root create_sections.py; plain Python, no device).

Walks reports_path/p1?/p*/s*.txt in the reference's sorted p-group /
patient / study order, pairs each study with its dicom JPEGs under
mimic_cxr_jpg_path, splits the report (data/section_parser.py) and writes
one CSV row per dicom: [impression, findings, last_paragraph, comparison,
dicom_id, Img_Filename, Img_Folder, Note_file], the LAST occurrence of each
section. The manual rules for poorly formatted studies apply only with
--apply-custom-rules; the reference loads them but never applies them.

  python -m radialog_tpu_torch.apps.create_sections --reports_path R \\
      --mimic_cxr_jpg_path J --output_path OUT
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import List, Optional

from ..data.section_parser import build_sectioned_csv


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="MIMIC-CXR report sectioning")
    p.add_argument("--reports_path", required=True,
                   help="root of the free-text reports, e.g. .../mimic-cxr-reports/files")
    p.add_argument("--mimic_cxr_jpg_path", required=True,
                   help="root of the JPEG tree, e.g. .../mimic-cxr-jpg/2.0.0/files")
    p.add_argument("--output_path", default="reports_processed",
                   help="directory for mimic_cxr_sectioned.csv")
    p.add_argument("--apply-custom-rules", action="store_true", default=False,
                   help="apply the manual per-study section overrides (upstream MIT-LCP "
                        "semantics; the reference loads but does not apply them)")
    return p.parse_args(argv)


def iter_studies(reports_path: Path, jpg_path: Path):
    """Yield (study_stem, report_text, img_folder, dicom_ids) in the
    reference's sorted p-group / patient / study walk; a study's dicoms in
    the directory's listing order, as the reference lists them."""
    p_grps = sorted(d for d in os.listdir(reports_path) if d.startswith("p") and len(d) == 3)
    for p_grp in p_grps:
        patients = sorted(d for d in os.listdir(reports_path / p_grp) if d.startswith("p"))
        for patient in patients:
            patient_path = reports_path / p_grp / patient
            for s in sorted(f for f in os.listdir(patient_path)
                            if f.startswith("s") and f.endswith(".txt")):
                stem = s[:-4]
                img_dir = jpg_path / p_grp / patient / stem
                dicom_ids = []
                if img_dir.is_dir():
                    dicom_ids = [f[:-4] for f in os.listdir(img_dir) if f.endswith(".jpg")]
                text = (patient_path / s).read_text()
                img_folder = str(Path("files") / p_grp / patient / stem)
                yield stem, text, img_folder, dicom_ids


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    out_dir = Path(args.output_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / "mimic_cxr_sectioned.csv"
    n = build_sectioned_csv(iter_studies(Path(args.reports_path), Path(args.mimic_cxr_jpg_path)),
                            out, apply_custom_rules=args.apply_custom_rules)
    print(f"wrote {n} rows -> {out}")


if __name__ == "__main__":
    main()
