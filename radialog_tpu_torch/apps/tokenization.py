"""Tokenizer pieces the serving path needs, copied from
radialog_tpu/data/tokenization.py so the port imports nothing of the JAX
package: the deterministic ``WhitespaceTokenizer`` stand-in and
``pad_batch_right``."""
from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IMG_TOKEN = "<IMG>"


class WhitespaceTokenizer:
    """Deterministic stand-in tokenizer (tests + environments without the
    vicuna files). Hash-bucketed word ids with bos/eos/unk/<IMG> special ids
    mirroring the vicuna layout (bos=1, eos=2, unk=0, <IMG>=vocab-1)."""

    def __init__(self, vocab_size: int = 32001, num_img_tokens: int = 32,
                 img_token_id: Optional[int] = None):
        self.vocab_size = vocab_size
        self.bos_token_id = 1
        self.eos_token_id = 2
        self.unk_token_id = 0
        self.pad_token_id = 0
        self.img_token_id = img_token_id if img_token_id is not None else vocab_size - 1
        self.num_img_tokens = num_img_tokens

    def _word_id(self, w: str) -> int:
        if w == IMG_TOKEN:
            return self.img_token_id
        # crc32, not hash(): str hashing is salted per process, which made
        # mock runs irreproducible across invocations (same fix as the mock
        # emb providers)
        i = 3 + (zlib.crc32(w.encode()) % (self.vocab_size - 4))
        return 3 if i == self.img_token_id else i  # keep <IMG> id exclusive

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        # split out <IMG> runs so each placeholder is one token, as the real
        # tokenizer does for the added special token
        ids = [self._word_id(w) for w in text.replace(IMG_TOKEN, f" {IMG_TOKEN} ").split()]
        return ([self.bos_token_id] if add_bos else []) + ids

    def __call__(self, text: str, truncation: bool = True,
                 max_length: int = 2048, **_) -> Dict[str, List[int]]:
        ids = self.encode(text)[:max_length if truncation else None]
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return " ".join(f"tok{int(i)}" for i in ids
                        if not (skip_special_tokens and int(i) in
                                (self.bos_token_id, self.eos_token_id,
                                 self.pad_token_id)))


def pad_batch_right(seqs: Sequence[Sequence[int]], pad_id: int,
                    pad_to: Optional[int] = None,
                    multiple_of: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Right-pad to a bucketed length. Returns (tokens (B,T) int32,
    lengths (B,) int32). Replaces MyDataCollatorForSeq2Seq padding
    (utils/datacollator.py:84-94) and the eval left-pad (test.py:336)."""
    lengths = np.asarray([len(s) for s in seqs], np.int32)
    t = pad_to if pad_to is not None else int(lengths.max())
    t = ((t + multiple_of - 1) // multiple_of) * multiple_of
    out = np.full((len(seqs), t), pad_id, np.int32)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = np.asarray(s, np.int32)[:t]
    return out, np.minimum(lengths, t)
