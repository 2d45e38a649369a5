"""Tokenizer pieces the serving and finetune paths need, copied from
radialog_tpu/data/tokenization.py so the port imports nothing of the JAX
package: the loaders of the real tokenizers (``load_vicuna_tokenizer``,
``load_bert_tokenizer``), the deterministic ``WhitespaceTokenizer``
stand-in, ``pad_batch_right``, and for finetuning the vicuna_v11
``Prompter``, ``tokenize_with_masked_prompt`` and ``pad_labels_right``.

The loaders import ``transformers`` when called, and only then; callers
look them up on this module at call time, so a run without the tokenizer
files can put a ``WhitespaceTokenizer`` in their place."""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IMG_TOKEN = "<IMG>"
IGNORE_INDEX = -100


@dataclasses.dataclass(frozen=True)
class Prompter:
    """vicuna_v11 template: '{instruction} {input}' with the response
    appended directly and 'ASSISTANT:' as the response split."""

    prompt_input: str = "{instruction} {input}"
    prompt_no_input: str = "{instruction}"
    response_split: str = "ASSISTANT:"

    def generate_prompt(self, instruction: str, input: Optional[str] = None,
                        label: Optional[str] = None) -> str:
        res = (self.prompt_input.format(instruction=instruction, input=input)
               if input else self.prompt_no_input.format(instruction=instruction))
        if label:
            res = f"{res}{label}"
        return res

    def get_response(self, output: str) -> str:
        return output.split(self.response_split)[1].strip()


def _auto_tokenizer():
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError("loading a real tokenizer needs the transformers package, which "
                          f"this Python does not have ({e}); the port's runs without "
                          "tokenizer files use WhitespaceTokenizer") from e
    return AutoTokenizer


def load_vicuna_tokenizer(path: str, num_img_tokens: int = 32):
    """The fast LLaMA tokenizer of a local Vicuna checkout with the <IMG>
    special token appended (id 32000) and unk as the pad token."""
    tok = _auto_tokenizer().from_pretrained(path, use_fast=True)
    if IMG_TOKEN not in tok.get_vocab():
        tok.add_special_tokens({"additional_special_tokens": [IMG_TOKEN]})
    tok.pad_token = tok.unk_token if tok.unk_token else tok.eos_token
    return tok


def load_bert_tokenizer(path: Optional[str] = None):
    """CheXbert's tokenizer: ``path``, else ``bert-base-uncased`` (from the
    local Hugging Face cache; nothing is downloaded on a machine without a
    network)."""
    return _auto_tokenizer().from_pretrained(path or "bert-base-uncased")


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


def tokenize_with_masked_prompt(tokenizer, prompter: Prompter, record: Dict,
                                cutoff_len: int = 600, train_on_inputs: bool = False,
                                add_eos_token: bool = True) -> Dict[str, List[int]]:
    """Tokenize instruction + input + output, append eos if it fits, and
    mask the prompt span with -100 unless ``train_on_inputs``."""
    def tok(text: str, add_eos: bool) -> List[int]:
        ids = tokenizer(text, truncation=True, max_length=cutoff_len)["input_ids"]
        if add_eos and len(ids) < cutoff_len and (not ids or ids[-1] != tokenizer.eos_token_id):
            ids = ids + [tokenizer.eos_token_id]
        return ids

    full = tok(prompter.generate_prompt(record["instruction"], record.get("input"),
                                        record["output"]), add_eos_token)
    labels = list(full)
    if not train_on_inputs:
        user = tok(prompter.generate_prompt(record["instruction"], record.get("input")),
                   add_eos_token)
        user_len = len(user) - (1 if add_eos_token else 0)
        labels[:user_len] = [IGNORE_INDEX] * user_len
    return {"input_ids": full, "labels": labels, "attention_mask": [1] * len(full)}


def pad_labels_right(labels: Sequence[Sequence[int]], t: int) -> np.ndarray:
    out = np.full((len(labels), t), IGNORE_INDEX, np.int32)
    for i, s in enumerate(labels):
        out[i, :min(len(s), t)] = np.asarray(s, np.int32)[:t]
    return out
