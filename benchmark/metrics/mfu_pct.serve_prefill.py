"""The admissions' share of the card's peak: the model operations of each
admitted prompt (its rows, the head on the last; benchmark/roofline.py)
over the admission's time between CUDA events around the ring's prefill,
summed over every admission of the window, over the int8 peak."""
from typing import Dict, Optional

from benchmark import roofline as R


def read(rec: Dict) -> Optional[float]:
    timed = rec["trace"].get("admissions_timed") or []
    took = sum(sec for _, sec in timed)
    if not timed or took <= 0:
        return None
    cfg = rec["config"]
    model, vocab = cfg["model"], cfg["model"]["vocab_size"] + len(cfg["added_tokens"])
    flops = sum(R.llama_flops(model, vocab, t, R.causal_pairs(t, [t]), head_rows=1)
                for t, _ in timed)
    return 100.0 * flops / took / R.PEAK_BY_PRECISION[cfg["reference"]["precision"]]
