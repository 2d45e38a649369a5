"""The stage-1 input pipeline (port of radialog_tpu/data/prefetch.py): host
batches staged onto the card ahead of the step loop, and the raw-image
batches of one sub-epoch.

``DevicePrefetcher`` is the reference's ``PrefetchLoader``
(dataloader_utils.py:46-109) with its two halves kept apart: a daemon
thread pulls host batches, copies each array into pinned memory and from
there to the card with ``non_blocking=True`` on a side stream, and records
an event; the consumer's stream waits on that event, and every staged
tensor is marked as used on the consumer's stream (``record_stream``), so
the caching allocator does not hand its memory out again while the step
still reads it. ``stage1_raw_batches`` feeds it: Stage1Data records ->
CxrLoader (shuffled, decoded in worker threads) -> captions joined by the
loader's indices -> fixed-shape batch dicts.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch


def _map_arrays(fn, tree):
    """``fn`` over the numpy arrays and tensors of nested dicts, lists and
    tuples; other leaves are kept."""
    if isinstance(tree, dict):
        return {k: _map_arrays(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_arrays(fn, v) for v in tree)
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    return tree


class DevicePrefetcher:
    """Iterate ``batches`` with each batch staged on ``device`` up to
    ``depth`` batches ahead of the consumer.

    Arrays become tensors on ``device``; on the CPU they are wrapped
    without a copy (the thread and the queue stay, so errors and ``close``
    behave alike). An exception of the source re-raises at the consumer;
    ``close()`` stops the thread mid-stream. ``waits_s`` holds the seconds
    the consumer waited for each batch, ``staged`` the number of batches
    staged and ``all_pinned`` whether every host buffer copied to a card
    was pinned.
    """

    _DONE = object()

    def __init__(self, batches: Iterable, depth: int = 2, device="cuda"):
        self.device = torch.device(device)
        self._src = batches
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.waits_s: List[float] = []
        self.staged = 0
        self.all_pinned = True
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _stage(self, batch):
        if self._stream is None:
            return _map_arrays(torch.as_tensor, batch), None

        def to_card(x):
            host = torch.as_tensor(x).pin_memory()
            self.all_pinned &= host.is_pinned()
            return host.to(self.device, non_blocking=True)

        with torch.cuda.stream(self._stream):
            staged = _map_arrays(to_card, batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return staged, event

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self) -> None:
        try:
            for batch in self._src:
                if self._stop.is_set() or not self._put(self._stage(batch)):
                    return
                self.staged += 1
        except BaseException as e:  # noqa: BLE001 -- re-raised at the consumer
            self._err = e
        finally:
            self._put(self._DONE)

    def __iter__(self) -> Iterator:
        while True:
            t0 = time.perf_counter()
            item = self._q.get()
            self.waits_s.append(time.perf_counter() - t0)
            if item is self._DONE:
                self.waits_s.pop()
                if self._err is not None:
                    raise self._err
                return
            batch, event = item
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                _map_arrays(lambda t: t.record_stream(stream), batch)
            yield batch

    def close(self) -> None:
        self._stop.set()
        try:            # drain, so that a producer blocked on a full queue sees the stop
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def pad_text_batch(ids_list, max_len: int, n_rows: Optional[int] = None):
    """Token-id lists -> (n, max_len) int32 ids and mask, padded with 0 to
    the fixed ``max_len`` (not the longest row), each row cut to it."""
    n = n_rows if n_rows is not None else len(ids_list)
    text_ids = np.zeros((n, max_len), np.int32)
    text_mask = np.zeros((n, max_len), np.int32)
    for j, x in enumerate(ids_list):
        x = list(x)[:max_len]
        text_ids[j, :len(x)] = x
        text_mask[j, :len(x)] = 1
    return text_ids, text_mask


def stage1_raw_batches(data, tokenizer, max_txt_len: int, batch: int, sub_epoch: int,
                       resize: int = 512, crop: int = 448, threads: int = 4, seed: int = 0,
                       drop_last: bool = True, augment_fn: Optional[Callable] = None,
                       raw_u8: bool = True) -> Iterator[Dict]:
    """One sub-epoch of stage-1 batches decoded from the image files.

    data: Stage1Data; tokenizer: callable(text, max_length=) ->
    {"input_ids"}. Yields {"images", "text_ids", "text_mask" (B,
    max_txt_len) int32}: images (B, crop, crop) uint8 with ``raw_u8`` (the
    train step expands them on the device), else (B, crop, crop, 3) f32.
    Every caption is tokenized once, up front. ``drop_last`` drops a short
    last batch. A host-side ``augment_fn`` takes the f32 form, so it turns
    ``raw_u8`` off.
    """
    from ..native.loader import CxrLoader

    if augment_fn is not None:
        raw_u8 = False
    data.set_custom_epoch(sub_epoch)
    recs = [data[i] for i in range(len(data))]
    paths = [r["img_path"] for r in recs]
    tok_ids = [tokenizer(r["text_output"], max_length=max_txt_len)["input_ids"] for r in recs]
    with CxrLoader(paths, batch=batch, resize=resize, crop=crop, threads=threads,
                   shuffle=True, seed=seed, emit_u8=raw_u8) as ld:
        for images, idx in ld.epoch(seed=seed + sub_epoch):
            if drop_last and images.shape[0] < batch:
                continue
            text_ids, text_mask = pad_text_batch([tok_ids[i] for i in idx], max_txt_len,
                                                 images.shape[0])
            if augment_fn is not None:
                images = augment_fn(images)
            yield {"images": images, "text_ids": text_ids, "text_mask": text_mask}
