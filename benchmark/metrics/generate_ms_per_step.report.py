"""Host milliseconds of a pass's generate call (prefill and decode, the
card synchronized at both ends) per token generated, over the passes that
ran without the profiler (the first pass of a traced run carries it)."""
from typing import Dict, Optional


def read(rec: Dict) -> Optional[float]:
    w = rec["window"]
    spans, tokens = w.get("generate_s") or [], w.get("decode_tokens") or []
    pairs = list(zip(spans, tokens))[1:] or list(zip(spans, tokens))
    n = sum(t for _, t in pairs)
    return 1e3 * sum(s for s, _ in pairs) / n if n else None
