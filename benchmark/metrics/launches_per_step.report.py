"""Device operations (kernels, copies and sets) per traced decode step: a
count, which repeats exactly between runs of one program."""
from typing import Dict, Optional

from benchmark.metrics._read import per_step


def read(rec: Dict) -> Optional[float]:
    steps = per_step(rec)
    n = rec["trace"].get("kernel_count")
    return n / steps if steps and n else None
