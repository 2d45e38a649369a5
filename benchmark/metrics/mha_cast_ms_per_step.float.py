"""Device milliseconds of copy kernels (``aten::_to_copy`` / ``aten::copy_``:
the float path's casts of the bf16 cache to the compute type and back) per
traced decode step."""
from typing import Dict, Optional

from benchmark.metrics._read import per_step


def read(rec: Dict) -> Optional[float]:
    steps = per_step(rec)
    fam = rec["trace"].get("families", {}).get("copy")
    return 1e3 * fam["seconds"] / steps if steps and fam and fam["count"] else None
