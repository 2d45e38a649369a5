"""Batch evaluation harness (port of radialog_tpu/apps/evaluate.py) and its
command line, the port's counterpart of the repository's root ``test.py``.

``run_eval`` decodes a greedy report per study (batches of 12, 300 new
tokens), writes the predictions and labels CSVs and the results text in the
reference's byte formats, scores the reports with BLEU-1..4, METEOR,
ROUGE-L and the CheXbert CE metrics, then runs the optional second passes
in the JAX order: the batch-1 correction pass (256 new tokens a study,
scored again), the binary-QA pass (the 14 finding questions of one study as
one batch, 10 new tokens; the whole history and the image join the shared
prefix) and the all-QA pass (one question a study in batches of 5, 30 new
tokens).

With ``num_beams > 1`` the report pass runs beam search (decode/beam.py).
With ``corr_spec > 0`` every correction goes through one batched speculative
decoder of 8 lanes (``generate_texts_ring(spec_k=corr_spec)``,
decode/spec_ring.py ``SpecCompactBatcher``) instead of the batch-1 loop.

Run: ``python -m radialog_tpu_torch.apps.evaluate --mock --device cpu
--fixture-dir tests/fixtures --truncate 2 --max_new_tokens 6 --do_corr``
(tiny seeded models on the CPU), ``--synthetic`` for Vicuna-7B widths with
random weights, or the checkpoints as the root test.py takes them
(``--vicuna_path``, ``--lora_model``, ``--blip2_checkpoint``,
``--chexbert_checkpoint``, ``--emb_cache``), on the card by default
(``--device cuda``). As with the root test.py, the weights are float (the
stacked layout over the bf16 cache) unless ``--int8`` (W8A8) or ``--w4``
(W4A8) asks for the quantized serving params.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import random
import zlib
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.conversation import extract_report
from ..data.datasets import MimicPaths, ReportGenData, stratified_indices
from ..data.downstream import (all_qa_parse, all_qa_prompt, binary_qa_no_finding_fixup,
                               binary_qa_parse, binary_qa_prompts, correction_extract,
                               correction_prompts)
from ..eval.ce_metrics import (CHEXBERT_CONDITIONS, CHEXPERT_COLS, ce_metrics,
                               map_labels_for_scoring, write_labels_csv_from_raw,
                               write_predictions_csv)
from ..eval.nlg import evaluate_reports
from .pipeline import PipelineConfig, RaDialogPipeline

EVAL_BATCH = 12
ALL_QA_BATCH = 5
CORRECTION_NEW = 256
CORRECTION_LANES = 8    # lanes of the batched speculative correction pass
EmbProvider = Callable[[Sequence[str]], object]   # dicoms -> (N, 32, qformer_dim) embeddings


@dataclasses.dataclass
class EvalOptions:
    use_embs: bool = False
    do_sample: bool = False
    temperature: float = 1.0
    num_beams: int = 1
    do_corr: bool = False
    corr_spec: int = 0      # > 0: the correction pass batched through speculation, k = corr_spec
    do_cp_bin_qa: bool = False
    do_cp_all_qa: bool = False
    batch_size: int = EVAL_BATCH
    max_new_tokens: int = 300
    exp_name: str = "eval"
    output_dir: str = "vicuna_results"


def _embs(pipe: RaDialogPipeline, opts: EvalOptions, emb_provider: Optional[EmbProvider],
          dicoms: Sequence[str]) -> Optional[torch.Tensor]:
    if not (opts.use_embs and emb_provider):
        return None
    return torch.as_tensor(emb_provider(list(dicoms)), device=pipe.device)


def run_eval(pipe: RaDialogPipeline, records: List[Dict], opts: EvalOptions,
             emb_provider: Optional[EmbProvider] = None) -> Dict[str, float]:
    """records: ReportGenData records. Returns the metrics dict and writes
    predictions_/labels_ CSVs and results_{exp}.txt under opts.output_dir."""
    out_dir = Path(opts.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    all_preds: List[str] = []
    preds_history: List[str] = []
    dicoms = [r["dicom"] for r in records]
    gt_labels = np.stack([r["chexpert_labels"] for r in records])

    for i0 in range(0, len(records), opts.batch_size):
        chunk = records[i0:i0 + opts.batch_size]
        decoded = pipe.generate_texts([r["text_input"] for r in chunk],
                                      img_embs=_embs(pipe, opts, emb_provider,
                                                     [r["dicom"] for r in chunk]),
                                      max_new_tokens=opts.max_new_tokens,
                                      do_sample=opts.do_sample, temperature=opts.temperature,
                                      num_beams=opts.num_beams)
        preds_history.extend(decoded)
        all_preds.extend(extract_report(d).strip() for d in decoded)

    write_predictions_csv(all_preds, out_dir / f"predictions_{opts.exp_name}.csv")
    nlg = evaluate_reports({d: p for d, p in zip(dicoms, all_preds)},
                           {r["dicom"]: r["text_target"] for r in records})

    pred_labels_raw = pipe.label_reports(all_preds)
    write_labels_csv_from_raw(pred_labels_raw, all_preds,
                              out_dir / f"labels_{opts.exp_name}.csv")
    pred_labels = _to_scoring_order(pred_labels_raw)
    ce = ce_metrics(gt_labels, pred_labels)

    results = {**nlg.as_dict(), **{k: v for k, v in ce.items() if not isinstance(v, list)}}
    _write_results_txt(out_dir / f"results_{opts.exp_name}.txt",
                       records[0]["text_input"] if records else "", results)

    if opts.do_corr:
        results.update(run_correction_pass(
            pipe, records, preds_history, map_labels_for_scoring(pred_labels),
            map_labels_for_scoring(gt_labels), opts, emb_provider))
    if opts.do_cp_bin_qa:
        results.update(run_binary_qa_pass(pipe, records, preds_history, gt_labels, opts,
                                          emb_provider))
    if opts.do_cp_all_qa:
        results.update(run_all_qa_pass(pipe, records, preds_history, gt_labels, opts,
                                       emb_provider))
    return results


def _to_scoring_order(raw_labels: np.ndarray) -> np.ndarray:
    """CheXbert head order -> the scoring order (CHEXPERT_COLS)."""
    return raw_labels[:, [CHEXBERT_CONDITIONS.index(c) for c in CHEXPERT_COLS]]


def _write_results_txt(path: Path, prompt: str, results: Dict[str, float]) -> None:
    """results_{exp}.txt in the reference's layout."""
    lines = [f"Prompt: {prompt}"]
    name_map = [
        ("Avg Bleu 1", "Bleu_1"), ("Avg Bleu 2", "Bleu_2"),
        ("Avg Bleu 3", "Bleu_3"), ("Avg Bleu 4", "Bleu_4"),
        ("Avg Meteor", "METEOR"), ("Avg Rouge", "ROUGE_L"),
        ("Mean Chexpert F1", "chexbert_macro_f1"),
        ("Mean Chexpert Precision", "chexbert_macro_precision"),
        ("Mean Chexpert Recall", "chexbert_macro_recall"),
        ("Sample Chexpert F1", "chexbert_sample_f1"),
        ("Mean Chexpert Accuracy", "chexbert_mean_accuracy"),
    ]
    for label, key in name_map:
        if key in results:
            lines.append(f"{label}: {results[key]}")
    path.write_text("\n".join(lines) + "\n")


# ------------------------------------------------------------- second passes
def run_correction_pass(pipe: RaDialogPipeline, records: List[Dict], preds_history: List[str],
                        pred_labels: np.ndarray, gt_labels: np.ndarray, opts: EvalOptions,
                        emb_provider: Optional[EmbProvider]) -> Dict[str, float]:
    """Automated correction, batch 1, 256 new tokens a study (or, with
    ``corr_spec``, all studies through one batched speculative decoder of
    CORRECTION_LANES lanes): each report is rewritten from its
    false-positive and false-negative findings, written to
    predictions_{exp}_after_corrections.csv and scored again."""
    prompts = correction_prompts(list(preds_history), CHEXPERT_COLS, pred_labels, gt_labels)
    if opts.corr_spec > 0:
        decoded = pipe.generate_texts_ring(
            prompts, max_new_tokens=CORRECTION_NEW, lanes=CORRECTION_LANES,
            img_embs=_embs(pipe, opts, emb_provider, [r["dicom"] for r in records]),
            spec_k=opts.corr_spec)
    else:
        decoded = [pipe.generate_texts([prompt], img_embs=_embs(pipe, opts, emb_provider,
                                                                [records[i]["dicom"]]),
                                       max_new_tokens=CORRECTION_NEW)[0]
                   for i, prompt in enumerate(prompts)]
    corrected = [correction_extract(d, p) for d, p in zip(decoded, prompts)]

    out_dir = Path(opts.output_dir)
    write_predictions_csv(corrected,
                          out_dir / f"predictions_{opts.exp_name}_after_corrections.csv")
    nlg = evaluate_reports({r["dicom"]: c for r, c in zip(records, corrected)},
                           {r["dicom"]: r["text_target"] for r in records})
    labels = _to_scoring_order(pipe.label_reports(corrected))
    ce = ce_metrics(gt_labels, labels)
    return {f"corr_{k}": v for k, v in {**nlg.as_dict(), **ce}.items()
            if not isinstance(v, list)}


def run_binary_qa_pass(pipe: RaDialogPipeline, records: List[Dict], preds_history: List[str],
                       gt_labels: np.ndarray, opts: EvalOptions,
                       emb_provider: Optional[EmbProvider]) -> Dict[str, float]:
    """14 yes/no questions per report, max_new_tokens 10."""
    preds = []
    for i, hist in enumerate(preds_history):
        prompts = binary_qa_prompts(hist, CHEXPERT_COLS)
        embs = _embs(pipe, opts, emb_provider, [records[i]["dicom"]])
        if embs is not None:
            embs = embs.repeat(len(prompts), 1, 1)
        decoded = pipe.generate_texts(prompts, img_embs=embs, max_new_tokens=10)
        preds.append([binary_qa_parse(d) for d in decoded])
    preds = binary_qa_no_finding_fixup(np.asarray(preds), CHEXPERT_COLS)
    ce = ce_metrics(gt_labels, preds.astype(np.float64))
    return {f"bin_qa_{k}": v for k, v in ce.items() if not isinstance(v, list)}


def run_all_qa_pass(pipe: RaDialogPipeline, records: List[Dict], preds_history: List[str],
                    gt_labels: np.ndarray, opts: EvalOptions,
                    emb_provider: Optional[EmbProvider]) -> Dict[str, float]:
    """'List all the findings', batches of 5, max_new_tokens 30."""
    prompts = [all_qa_prompt(h) for h in preds_history]
    preds: List[List[int]] = []
    for i0 in range(0, len(prompts), ALL_QA_BATCH):
        chunk = prompts[i0:i0 + ALL_QA_BATCH]
        embs = _embs(pipe, opts, emb_provider,
                     [r["dicom"] for r in records[i0:i0 + ALL_QA_BATCH]])
        decoded = pipe.generate_texts(chunk, img_embs=embs, max_new_tokens=30)
        preds.extend(all_qa_parse(d, CHEXPERT_COLS) for d in decoded)
    ce = ce_metrics(gt_labels, np.asarray(preds, np.float64))
    return {f"all_qa_{k}": v for k, v in ce.items() if not isinstance(v, list)}


# ------------------------------------------------------------- command line
def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The root test.py's flags with their defaults, plus --synthetic and
    --device."""
    p = argparse.ArgumentParser(description="RaDialog evaluation on the PyTorch port")
    p.add_argument("--prompt", type=str,
                   default="img_matching_examples_ig2_noexamples_IMG_findings",
                   help="prompt type (vicuna_prompts.json key)")
    p.add_argument("--lora_model", type=str, default=None, help="lora adapter path")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--use_embs", action="store_true", default=False,
                   help="condition on image embeddings")
    p.add_argument("--do_sample", action="store_true", default=False)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--do_corr", action="store_true", default=False)
    p.add_argument("--corr_spec", type=int, default=0)
    p.add_argument("--do_cp_bin_qa", action="store_true", default=False)
    p.add_argument("--do_cp_all_qa", action="store_true", default=False)
    p.add_argument("--strat_eval", action="store_true", default=False)
    p.add_argument("--vicuna_path", type=str, default=None)
    p.add_argument("--blip2_checkpoint", type=str, default=None)
    p.add_argument("--chexbert_checkpoint", type=str, default=None)
    p.add_argument("--emb_cache", type=str, default=None)
    p.add_argument("--split_csv", type=str, default=None)
    p.add_argument("--sectioned_csv", type=str, default=None)
    p.add_argument("--chexpert_csv", type=str, default=None)
    p.add_argument("--preds_json", type=str, default=None)
    p.add_argument("--fixture-dir", type=str, default=None,
                   help="directory holding split.csv/sectioned.csv/chexpert.csv/preds.json")
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--truncate", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=EVAL_BATCH)
    p.add_argument("--max_new_tokens", type=int, default=300)
    p.add_argument("--output_dir", type=str, default="vicuna_results")
    p.add_argument("--exp_name", type=str, default=None)
    p.add_argument("--mock", action="store_true", default=False,
                   help="tiny seeded models: the whole pipeline without weights")
    p.add_argument("--int8", action="store_true", default=False, help="W8A8 serving weights")
    p.add_argument("--w4", action="store_true", default=False,
                   help="W4A8 layer weights (implies --int8)")
    p.add_argument("--kv_bf16", action="store_true", default=False,
                   help="the bf16 KV cache instead of the int8 one")
    p.add_argument("--synthetic", action="store_true", default=False,
                   help="Vicuna-7B widths with random weights from a seed")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; no fallback from one to the other")
    return p.parse_args(argv)


def _check_args(args: argparse.Namespace) -> None:
    if not (args.mock or args.synthetic or args.vicuna_path):
        raise ValueError("pass --vicuna_path (a Vicuna checkpoint directory), --mock or "
                         "--synthetic")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")


def mock_emb_provider(num_img_tokens: int, qformer_dim: int,
                      cache: Optional[Dict[str, np.ndarray]] = None) -> EmbProvider:
    """Per-dicom embeddings: the row of ``cache`` (the pipeline's emb_cache)
    where there is one, else normal draws from a generator seeded with the
    crc32 of the dicom id, as the root test.py makes them."""
    cache = cache or {}

    def one(d):
        if str(d) in cache:
            return np.asarray(cache[str(d)])
        return np.random.default_rng(zlib.crc32(str(d).encode())).normal(
            size=(num_img_tokens, qformer_dim)).astype(np.float32)

    return lambda dicoms: np.stack([one(d) for d in dicoms])


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    args = parse_args(argv)
    _check_args(args)
    opts = EvalOptions(
        use_embs=args.use_embs, do_sample=args.do_sample, temperature=args.temperature,
        do_corr=args.do_corr, corr_spec=args.corr_spec, do_cp_bin_qa=args.do_cp_bin_qa,
        do_cp_all_qa=args.do_cp_all_qa, num_beams=args.num_beams,
        batch_size=args.batch_size, max_new_tokens=args.max_new_tokens,
        exp_name=args.exp_name or f"{args.prompt}_{'embs' if args.use_embs else 'noembs'}",
        output_dir=args.output_dir)
    random.seed(42)
    np.random.seed(42)

    fx = Path(args.fixture_dir) if args.fixture_dir else None
    paths = MimicPaths(
        split_csv=args.split_csv or str(fx / "split.csv"),
        sectioned_csv=args.sectioned_csv or str(fx / "sectioned.csv"),
        chexpert_csv=args.chexpert_csv or str(fx / "chexpert.csv"),
        predicted_findings_json=args.preds_json or
        (str(fx / "preds.json") if fx and (fx / "preds.json").exists() else None),
    )
    ds = ReportGenData(paths, split=args.split, prompt_type=args.prompt, truncate=args.truncate)
    if args.strat_eval:
        records = [ds[i] for i in stratified_indices(ds.annotation)]
    else:
        records = ds.records()
    print(f"eval records: {len(records)}")

    pipe = RaDialogPipeline(PipelineConfig(
        vicuna_path=args.vicuna_path, lora_path=args.lora_model,
        blip2_checkpoint=args.blip2_checkpoint, chexbert_checkpoint=args.chexbert_checkpoint,
        emb_cache=args.emb_cache,
        mock=args.mock, synthetic=args.synthetic, quantize=args.int8 or args.w4,
        weight_bits=4 if args.w4 else 8,
        kv_int8=False if args.kv_bf16 else None, max_new_tokens=args.max_new_tokens,
        device=args.device))
    emb_provider = None
    if args.use_embs:
        emb_provider = mock_emb_provider(pipe.llama_cfg.num_img_tokens,
                                         pipe.llama_cfg.qformer_dim, pipe.emb_cache)
    results = run_eval(pipe, records, opts, emb_provider=emb_provider)
    print(json.dumps({k: round(float(v), 6) for k, v in results.items()}, indent=2))
    return results


if __name__ == "__main__":
    main()
