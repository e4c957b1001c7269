"""Byte-level tokenizer (text8-style lowercase alphabet option); a verbatim
copy of ``repro.data.tokenizer``."""
from __future__ import annotations

import numpy as np

TEXT8_ALPHABET = "abcdefghijklmnopqrstuvwxyz "


class ByteTokenizer:
    vocab_size = 256

    def encode(self, s: str) -> np.ndarray:
        return np.frombuffer(s.encode("utf-8", errors="replace"),
                             dtype=np.uint8).astype(np.int64)

    def decode(self, ids) -> str:
        return bytes(int(i) % 256 for i in ids).decode("utf-8",
                                                       errors="replace")


class Text8Tokenizer:
    """27-symbol text8 alphabet + [MASK] (id 27). vocab_size=28."""
    def __init__(self):
        self.alphabet = TEXT8_ALPHABET
        self.stoi = {c: i for i, c in enumerate(self.alphabet)}
        self.mask_id = len(self.alphabet)
        self.vocab_size = len(self.alphabet) + 1

    def encode(self, s: str) -> np.ndarray:
        return np.array([self.stoi.get(c, self.stoi[" "]) for c in s.lower()],
                        np.int64)

    def decode(self, ids) -> str:
        out = []
        for i in ids:
            i = int(i)
            out.append(self.alphabet[i] if i < len(self.alphabet) else "_")
        return "".join(out)
