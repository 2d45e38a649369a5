"""Host milliseconds a pass spends on its image side (BioViL-T, ln_vision,
the Q-Former and the findings classifier, up to the findings on the host),
the card synchronized at both ends; the mean over the window's passes."""
from typing import Dict, Optional


def read(rec: Dict) -> Optional[float]:
    spans = rec["window"].get("vision_s") or []
    return 1e3 * sum(spans) / len(spans) if spans else None
