"""Streaming generation helpers (port of radialog_tpu/utils/streaming.py):
``stream_chunks``, which decodes a session's reply in chunks of tokens and
yields each chunk, and ``Iteratorize``, a callback producer as a blocking
generator (the reference's utils/callbacks.py)."""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterator, List, Optional


def stream_chunks(session, dp, chunk_size: int = 16,
                  max_new_tokens: int = 300) -> Iterator[List[int]]:
    """Yield generated token-id chunks from a decode/session.InteractiveSession.

    Each chunk is one decode of up to ``chunk_size`` tokens; the cache
    persists between chunks, and the chunk's last token (pending, not yet
    fed through the model) is fed by one decode step that gives the logits
    of the next chunk's first token, so the chunks are bitwise one decode's
    tokens (JAX feeds it by an incremental prefill, whose rows round apart
    in bf16)."""
    produced = 0
    while produced < max_new_tokens:
        n = min(chunk_size, max_new_tokens - produced, max(1, session.remaining - 1))
        ids = session.generate(dataclasses.replace(dp, max_new_tokens=n))
        if not ids:
            return
        yield ids
        produced += len(ids)
        if ids[-1] == dp.eos_token_id:
            return
        session.feed_pending()
        if session._last_logits is None:
            return


class Iteratorize:
    """Runs ``func(callback=...)`` on a thread and yields everything passed
    to the callback."""

    _SENTINEL = object()

    def __init__(self, func: Callable, timeout: Optional[float] = None):
        self.q: "queue.Queue" = queue.Queue()
        self.timeout = timeout

        def _run():
            try:
                func(callback=self.q.put)
            finally:
                self.q.put(self._SENTINEL)

        self.thread = threading.Thread(target=_run, daemon=True)
        self.thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get(timeout=self.timeout)
        if item is self._SENTINEL:
            raise StopIteration
        return item
