"""Tokenization for the dual SDXL text encoders (port of
``omg_tpu/text/tokenizer.py``).

``HFCLIPTokenizer`` is CLIP's byte-level BPE over the ``tokenizer/`` or
``tokenizer_2/`` folder of an SDXL checkout, written here with the
standard library: the JAX package defers to ``transformers``, which the
GPU host lacks. ``ToyTokenizer`` keeps the pipeline testable without any
checkpoint.
"""

from __future__ import annotations

import hashlib
import json
import os
import unicodedata
from typing import Protocol, Sequence

import numpy as np

MAX_LEN = 77

_BOS, _EOS = "<|startoftext|>", "<|endoftext|>"
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


class Tokenizer(Protocol):
    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        """-> int32 ids [B, 77], BOS ... EOS, padded."""
        ...

    def encode_word(self, word: str) -> int:
        """First content token id of a single word (mask gating)."""
        ...


def bytes_to_unicode() -> dict:
    """CLIP's reversible byte -> printable character table: the printable
    Latin-1 bytes map to themselves, the other 68 to chr(256 + n)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_chinese_char(cp: int) -> bool:
    """The CJK Unified Ideographs blocks (BERT's basic tokenizer)."""
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def basic_clean(text: str) -> str:
    """``transformers``' BasicTokenizer(strip_accents=False,
    do_split_on_punc=False), CLIP's text cleaning without ``ftfy``: drop
    NUL, U+FFFD and control characters, whitespace to spaces, spaces
    around CJK ideographs, NFC, split on whitespace, lowercase, and join
    with single spaces."""
    out = []
    for ch in text:
        cp = ord(ch)
        if ch in " \t\n\r" or unicodedata.category(ch) == "Zs":
            out.append(" ")
        elif cp == 0 or cp == 0xFFFD or unicodedata.category(ch)[0] == "C":
            continue
        elif _is_chinese_char(cp):
            out += [" ", ch, " "]
        else:
            out.append(ch)
    words = unicodedata.normalize("NFC", "".join(out)).split()
    return " ".join(w.lower() for w in words)


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "L"


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "N"


def pre_tokenize(text: str) -> list:
    """CLIP's pattern ``<\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|
    've|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` (ignoring
    case), as a scanner on ``unicodedata`` categories: at each position the
    first alternative that matches wins; whitespace starts none."""
    out, i, n = [], 0, len(text)
    while i < n:
        ch = text[i]
        low = text[i:i + len(_BOS)].lower()
        special = next((s for s in (_BOS, _EOS) if low.startswith(s)), None)
        if special is not None:
            out.append(text[i:i + len(special)])
            i += len(special)
            continue
        if ch == "'":
            c = next((c for c in _CONTRACTIONS
                      if text[i:i + len(c)].lower() == c), None)
            if c is not None:
                out.append(text[i:i + len(c)])
                i += len(c)
                continue
        j = i + 1
        if _is_letter(ch):
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(ch):
            pass
        elif ch.isspace():
            i += 1
            continue
        else:
            while j < n and not (text[j].isspace() or _is_letter(text[j])
                                 or _is_number(text[j])):
                j += 1
        out.append(text[i:j])
        i = j
    return out


def _special(entry):
    """A special token as tokenizer files give it: a string or a dict
    with its "content"."""
    return entry.get("content") if isinstance(entry, dict) else entry


class HFCLIPTokenizer:
    """CLIP's BPE tokenizer over a checkpoint folder: ``vocab.json``,
    ``merges.txt``, and the special tokens of ``special_tokens_map.json``
    and ``tokenizer_config.json`` (bos ``<|startoftext|>``, eos and unk
    ``<|endoftext|>``; SDXL's ``tokenizer_2`` pads with ``"!"``, id 0).

    The same ids as ``transformers.CLIPTokenizer`` on a host without
    ``ftfy``, the JAX package's path here: special tokens are split out
    of the text first (an added ``"!"`` is id 0 wherever it appears), the
    rest cleaned (``basic_clean``), pre-tokenized (``pre_tokenize``) and
    merged byte pair by byte pair in merge-rank order, with a cache per
    word. Text that ``ftfy`` would repair (mojibake, HTML entities) may
    tokenize differently from a host that has ``ftfy``. Characters that
    Python's ``unicodedata`` (Unicode 15 in Python 3.12) and the
    ``regex`` module classify differently, i.e. ones assigned after the
    older of the two versions, may split differently too."""

    def __init__(self, path: str):
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            self.encoder = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:49152 - 256 - 2 + 1]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(lines)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        tokens = {"bos_token": _BOS, "eos_token": _EOS, "unk_token": _EOS,
                  "pad_token": _EOS}
        self.added: dict = {}           # added token -> id
        cleanup = False
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            f = os.path.join(path, name)
            if not os.path.exists(f):
                continue
            with open(f, encoding="utf-8") as fh:
                j = json.load(fh)
            tokens.update({k: _special(j[k]) for k in tokens
                           if _special(j.get(k)) is not None})
            self.added.update({_special(e): int(i) for i, e in
                               j.get("added_tokens_decoder", {}).items()})
            cleanup = j.get("clean_up_tokenization_spaces", cleanup)
        self.clean_up_tokenization_spaces = cleanup
        for tok in tokens.values():
            self.added.setdefault(tok, self.encoder[tok])
        self.decoder.update({i: tok for tok, i in self.added.items()})
        self.unk_id = self.added[tokens["unk_token"]]
        self.bos_id = self.added[tokens["bos_token"]]
        self.eos_id = self.added[tokens["eos_token"]]
        self.pad_id = self.added[tokens["pad_token"]]
        # split out of the text before anything else, longest first
        self.specials = sorted(self.added, key=len, reverse=True)
        self.cache = {_BOS: _BOS, _EOS: _EOS}

    def bpe(self, token: str) -> str:
        """One pre-token (byte characters) -> its merged symbols, space
        separated; the last symbol carries ``</w>``."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged, i = [], 0
            while i < len(word):
                if word[i] == first and i + 1 < len(word) \
                        and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self.cache[token] = " ".join(word)
        return self.cache[token]

    def _split_specials(self, text: str) -> list:
        """-> [(piece, is_special)], special tokens matched leftmost, the
        longest first at one position."""
        out, start, i = [], 0, 0
        while i < len(text):
            s = next((s for s in self.specials if text.startswith(s, i)),
                     None)
            if s is None:
                i += 1
                continue
            if i > start:
                out.append((text[start:i], False))
            out.append((s, True))
            i = start = i + len(s)
        if start < len(text):
            out.append((text[start:], False))
        return out

    def tokenize(self, text: str) -> list:
        """Text -> BPE symbols (strings), no BOS/EOS."""
        symbols = []
        for piece, special in self._split_specials(text):
            if special:
                symbols.append(piece)
                continue
            for tok in pre_tokenize(basic_clean(piece)):
                chars = "".join(self.byte_encoder[b]
                                for b in tok.encode("utf-8"))
                symbols += self.bpe(chars).split(" ")
        return symbols

    def encode(self, text: str) -> list:
        """BOS, the text's ids, EOS (no truncation or padding)."""
        return [self.bos_id] + [
            self.added.get(s, self.encoder.get(s, self.unk_id))
            for s in self.tokenize(text)] + [self.eos_id]

    def __call__(self, texts) -> np.ndarray:
        """-> int32 [B, 77]: BOS, at most 75 ids, EOS, then the pad id."""
        rows = []
        for t in texts:
            ids = self.encode(t)
            ids = ids[:MAX_LEN - 1] + [self.eos_id] if len(ids) > MAX_LEN \
                else ids
            rows.append(ids + [self.pad_id] * (MAX_LEN - len(ids)))
        return np.asarray(rows, np.int32)

    def encode_word(self, word: str) -> int:
        return self.encode(word)[1]

    def decode(self, ids) -> str:
        """Ids -> text: symbols joined, bytes decoded (invalid UTF-8
        replaced), ``</w>`` read as a space; special tokens kept."""
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        out = raw.decode("utf-8", errors="replace").replace("</w>", " ") \
            .strip()
        if self.clean_up_tokenization_spaces:
            for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                         (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                         (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
                out = out.replace(a, b)
        return out


class ToyTokenizer:
    """Whitespace + hash tokenizer for tests: deterministic, vocab-bounded,
    CLIP-shaped (BOS=start, EOS=vocab-1=pad, EOS is the max id so argmax
    pooling finds the first EOS exactly like real CLIP).

    A word's id comes from a BLAKE2b digest of its UTF-8 bytes, not from
    Python's ``hash``, which is salted per process: every process (each
    rank of a mesh, each run) maps a prompt to the same ids."""

    def __init__(self, vocab_size: int = 1000):
        self.vocab_size = vocab_size
        self.bos = 1
        self.eos = vocab_size - 1

    def _word_id(self, w: str) -> int:
        digest = hashlib.blake2b(w.encode("utf-8"), digest_size=8).digest()
        return 2 + (int.from_bytes(digest, "little") % (self.vocab_size - 3))

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
