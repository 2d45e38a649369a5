"""Multi-session serving front end over continuous batching (port of
radialog_tpu/apps/serve.py ``RaDialogServer``).

Any number of client threads submit requests; a single stepper thread owns
the ``RingBatcher`` (decode/continuous.py) and therefore the card,
admitting requests into free lanes at chunk granularity and resolving
per-request futures as sessions finish.

  * The batcher is not thread-safe: all interaction with it happens on the
    stepper thread. ``submit`` only enqueues; results come back through a
    ``concurrent.futures.Future`` holding the list of generated ids.
  * Per-request errors (an oversized prompt, max_new_tokens that does not
    fit the ring) go to that request's future: one bad client never takes
    down the loop. An error in the shared decode step is fatal for the
    sessions in flight: it fails every outstanding future and marks the
    server dead (a later ``submit`` raises).
  * The stepper waits on a condition variable when there is no work: an
    idle server launches nothing.
  * It serves both weight layouts: the unrolled W8A8 / W4A8 serving params
    over the int8 or the bf16 ring, and the stacked float params (bf16
    Vicuna-7B, the float path) over the bf16 ring.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

from ..decode.continuous import RingBatcher
from ..decode.engine import DecodeParams
from ..models.llama import LlamaConfig
from ..ops.layers import DTypePolicy, FP32


class RaDialogServer:
    """Thread-safe continuous-batching server over one decode loop.

    >>> srv = RaDialogServer(params, cfg, lanes=8)
    >>> fut = srv.submit(prompt_ids, img_embs=embs)
    >>> tokens = fut.result()          # blocks until the session finishes
    >>> srv.shutdown()
    """

    def __init__(self, params: Optional[Dict] = None, cfg: Optional[LlamaConfig] = None,
                 lanes: int = 8, cache_len: int = 512, prompt_len: int = 256,
                 dp: DecodeParams = DecodeParams(), lora: Optional[Dict] = None,
                 policy: DTypePolicy = FP32, steps_per_call: int = 8,
                 batcher: Optional[RingBatcher] = None, kv_int8: bool = False,
                 device="cuda"):
        # ``batcher``: serve a pre-built scheduler with the same host
        # interface instead; mutually exclusive with params and cfg
        if batcher is not None:
            if params is not None or cfg is not None:
                raise ValueError("pass either batcher= or params+cfg, not both")
            self._rb = batcher
        elif params is None or cfg is None:
            raise ValueError("params and cfg are required without batcher=")
        else:
            self._rb = RingBatcher(params, cfg, lanes=lanes, cache_len=cache_len,
                                   prompt_len=prompt_len, dp=dp, lora=lora, policy=policy,
                                   steps_per_call=steps_per_call, kv_int8=kv_int8,
                                   device=device)
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._pending: List[tuple] = []  # (fut, prompt, img, max_new, on_tokens)
        self._futures: Dict[int, Future] = {}
        self._streams: Dict[int, tuple] = {}   # sid -> (Session, callback, tokens sent)
        self._stop = False
        self._dead: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name="radialog-serve", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- clients
    def submit(self, prompt_ids: List[int], img_embs=None,
               max_new_tokens: Optional[int] = None, on_tokens=None) -> "Future[List[int]]":
        """Queue a request from any thread; returns its future.

        on_tokens: optional ``callable(new_tokens: List[int], done: bool)``
        streaming hook, invoked on the server thread after every decode
        chunk with that session's freshly generated tokens (granularity
        ``steps_per_call``). The final invocation has ``done=True``
        (possibly with an empty delta). Keep it fast and non-blocking: it
        runs on the shared stepper thread; push to a queue for slow
        consumers."""
        fut: Future = Future()
        with self._work:
            if self._stop:
                raise RuntimeError("server is shut down")
            if self._dead is not None:
                raise RuntimeError("server died") from self._dead
            self._pending.append((fut, list(prompt_ids), img_embs, max_new_tokens, on_tokens))
            self._work.notify()
        return fut

    def generate(self, prompt_ids: List[int], img_embs=None,
                 max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = None) -> List[int]:
        """Blocking convenience wrapper."""
        return self.submit(prompt_ids, img_embs, max_new_tokens).result(timeout)

    def warmup(self, prompt_buckets=(32,), token_id: int = 0,
               timeout: Optional[float] = None) -> float:
        """Run one throwaway session per prompt bucket before the first real
        request, so that the kernels are built and loaded, the libraries'
        plans made and the allocator warm outside any user's latency. The
        lanes it used are freed when the sessions finish. Returns the
        seconds spent."""
        t0 = time.time()
        chunk = getattr(self._rb, "steps_per_call", 1)
        futs = [self.submit([token_id] * max(1, int(b)), max_new_tokens=chunk)
                for b in prompt_buckets]
        for f in futs:
            f.result(timeout)
        return time.time() - t0

    def shutdown(self, timeout: float = 60.0) -> None:
        """Finish in-flight sessions, then stop the stepper."""
        with self._work:
            self._stop = True
            self._work.notify()
        self._thread.join(timeout)

    # ------------------------------------------------------------- stepper
    def _admit_pending(self, pending) -> None:
        rb = self._rb
        for fut, prompt, img, max_new, on_tokens in pending:
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                # validate here: rb.submit only queues, and _admit's raise
                # inside rb.step() would take down the shared loop
                rb.validate_request(len(prompt), max_new)
                sid = rb.submit(prompt, img_embs=img, max_new_tokens=max_new)
            except Exception as exc:  # per-request validation error
                fut.set_exception(exc)
                continue
            self._futures[sid] = fut
            if on_tokens is not None:
                # the Session just enqueued by rb.submit: its .tokens list
                # grows in place as the batcher decodes
                self._streams[sid] = (rb.queue[-1], on_tokens, 0)

    def _pump_streams(self, final: bool = False) -> None:
        for sid in list(self._streams):
            sess, cb, sent = self._streams[sid]
            done = sess.done or final
            delta = sess.tokens[sent:]
            if delta or done:
                try:
                    cb(list(delta), done)
                except Exception:
                    # a client callback must not damage the shared loop, but
                    # submit() promises a final done=True invocation: attempt
                    # exactly one before dropping the stream (a consumer that
                    # closes its queue only on done=True would wait forever)
                    if not done:
                        done = True
                        try:
                            cb([], True)
                        except Exception:
                            pass
            if done:
                del self._streams[sid]
            else:
                self._streams[sid] = (sess, cb, sent + len(delta))

    def _resolve_finished(self) -> None:
        rb = self._rb
        self._pump_streams()
        for sid in [s for s in self._futures if s in rb.finished]:
            # pop from rb.finished too: keeping every Session (tokens and
            # image embeddings) would grow memory forever
            self._futures.pop(sid).set_result(rb.finished.pop(sid).tokens)

    def _run(self) -> None:
        rb = self._rb
        while True:
            with self._work:
                while (not self._pending and not rb.queue
                       and rb.active_lanes == 0 and not self._stop):
                    self._work.wait()
                if (self._stop and not self._pending and not rb.queue
                        and rb.active_lanes == 0):
                    return
                pending, self._pending = self._pending, []
            self._admit_pending(pending)
            try:
                rb.step()       # requests were validated, so an error here
            except Exception as exc:  # is damage to shared state: fatal
                with self._work:
                    # drain _pending under the same lock that sets _dead: a
                    # submit() racing this block either lands in the drained
                    # list (failed below) or sees _dead and raises, never a
                    # future that stays pending
                    self._dead = exc
                    pending, self._pending = self._pending, []
                for fut in self._futures.values():
                    fut.set_exception(exc)
                self._futures.clear()
                for fut, *_ in pending:
                    if fut.set_running_or_notify_cancel():
                        fut.set_exception(exc)
                self._pump_streams(final=True)
                return
            # resolve through rb.finished, not step()'s return value: a
            # session can also finish at admission (EOS or a one-token
            # budget), which step()'s list does not include
            self._resolve_finished()
