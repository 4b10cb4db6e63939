"""Deterministic stateless tokenizers.

Carried over from ``repro/data/tokenizer.py`` unchanged (NumPy host code),
with its own ``splitmix64`` from :mod:`repro_torch.core.hashing`.

`HashWordTokenizer` maps whitespace words -> stable ids via splitmix64 mod
(vocab - reserved); no vocabulary files, so every distributed worker agrees
without broadcast (same design as the stateless hash families).  `ByteTokenizer`
is the exact-roundtrip fallback.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.hashing import splitmix64

PAD, BOS, EOS, RESERVED = 0, 1, 2, 4


def _fnv1a(w: str) -> int:
    h = 0xCBF29CE484222325
    for b in w.encode("utf-8"):
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


@dataclass(frozen=True)
class HashWordTokenizer:
    vocab: int = 32_000
    lowercase: bool = True

    def encode(self, text: str) -> np.ndarray:
        if self.lowercase:
            text = text.lower()
        words = text.split()
        if not words:
            return np.zeros(0, dtype=np.int32)
        # FNV-1a (not Python's hash(): that is salted per process and would
        # break multi-host determinism)
        hs = splitmix64(np.array([_fnv1a(w) for w in words], dtype=np.uint64))
        ids = (hs % np.uint64(self.vocab - RESERVED)).astype(np.int32) + RESERVED
        return ids

    def encode_batch(self, texts) -> list[np.ndarray]:
        return [self.encode(t) for t in texts]


@dataclass(frozen=True)
class ByteTokenizer:
    vocab: int = 256 + RESERVED

    def encode(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int32) \
            + RESERVED

    def decode(self, ids) -> str:
        b = (np.asarray(ids, np.int32) - RESERVED).clip(0, 255).astype(np.uint8)
        return b.tobytes().decode("utf-8", errors="replace")
