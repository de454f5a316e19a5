"""The benchmark's tokenizer: whitespace words hashed into CLIP's id space.

A frozen copy of the port's ``ToyTokenizer`` (``text/tokenizer.py``) over
CLIP's vocabulary size, so that prompt ids reach every row of the
embedding tables. CLIP's BPE vocabulary files are not in the repository;
the ids are the benchmark's own input, and the same ids go to the program
and to the reference. BOS is 1, EOS and padding the largest id, so the
EOS pooling (argmax of the ids) finds the first EOS as with real CLIP.
"""

from __future__ import annotations

import hashlib

import numpy as np

MAX_LEN = 77


class HashTokenizer:
    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self.bos = 1
        self.eos = vocab_size - 1

    def _word_id(self, w: str) -> int:
        digest = hashlib.blake2b(w.encode("utf-8"), digest_size=8).digest()
        return 2 + (int.from_bytes(digest, "little") % (self.vocab_size - 3))

    def __call__(self, texts) -> np.ndarray:
        """-> int32 ids [B, 77]: BOS, words, EOS, EOS padding."""
        rows = []
        for t in texts:
            ids = [self.bos] + [self._word_id(w) for w in t.split()][
                :MAX_LEN - 2]
            ids.append(self.eos)
            ids += [self.eos] * (MAX_LEN - len(ids))
            rows.append(ids)
        return np.asarray(rows, np.int32)

    def encode_word(self, word: str) -> int:
        return self._word_id(word)

    def encode(self, text: str) -> list:
        return [self.bos] + [self._word_id(w) for w in text.split()] + \
            [self.eos]

    def decode(self, ids) -> str:
        return " ".join(f"tok{i}" for i in ids)
