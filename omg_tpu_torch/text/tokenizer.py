"""Tokenization for the dual SDXL text encoders.

The reference tokenizes through the two CLIP tokenizers bundled with the
SDXL checkpoint (used via diffusers encode_prompt, and directly for the
token-gated mask logic at inference_lora.py:276-283). We defer BPE to
``transformers.CLIPTokenizer`` loaded from the user's local checkpoint
directory (this image is zero-egress; the tokenizer ships inside every
SDXL checkout) and keep a deterministic ``ToyTokenizer`` so pipeline
logic is testable without any checkpoint.
"""

from __future__ import annotations

from typing import Protocol, Sequence

import numpy as np

MAX_LEN = 77


class Tokenizer(Protocol):
    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        """-> int32 ids [B, 77], BOS ... EOS, padded."""
        ...

    def encode_word(self, word: str) -> int:
        """First content token id of a single word (mask gating)."""
        ...


class HFCLIPTokenizer:
    """transformers CLIPTokenizer over a local checkpoint subfolder."""

    def __init__(self, path: str):
        from transformers import CLIPTokenizer
        self.tk = CLIPTokenizer.from_pretrained(path)

    def __call__(self, texts):
        out = self.tk(list(texts), padding="max_length", max_length=MAX_LEN,
                      truncation=True, return_tensors="np")
        return out["input_ids"].astype(np.int32)

    def encode_word(self, word: str) -> int:
        return self.tk(word)["input_ids"][1]

    # P2P word-alignment protocol (control/p2p.py get_word_inds)
    def encode(self, text: str):
        return self.tk(text)["input_ids"]

    def decode(self, ids):
        return self.tk.decode(ids)


class ToyTokenizer:
    """Whitespace + hash tokenizer for tests: deterministic, vocab-bounded,
    CLIP-shaped (BOS=start, EOS=vocab-1=pad, EOS is the max id so argmax
    pooling finds the first EOS exactly like real CLIP)."""

    def __init__(self, vocab_size: int = 1000):
        self.vocab_size = vocab_size
        self.bos = 1
        self.eos = vocab_size - 1

    def _word_id(self, w: str) -> int:
        return 2 + (hash(w) % (self.vocab_size - 3))

    def __call__(self, texts):
        rows = []
        for t in texts:
            ids = [self.bos] + [self._word_id(w) for w in t.split()][: MAX_LEN - 2]
            ids.append(self.eos)
            ids += [self.eos] * (MAX_LEN - len(ids))
            rows.append(ids)
        return np.asarray(rows, np.int32)

    def encode_word(self, word: str) -> int:
        return self._word_id(word)

    def encode(self, text: str):
        return [self.bos] + [self._word_id(w) for w in text.split()] + [self.eos]

    def decode(self, ids):
        return " ".join(f"tok{i}" for i in ids)
