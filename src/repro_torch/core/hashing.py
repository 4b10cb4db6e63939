"""Hash families for multi-set min-hash (§2.2 of the paper).

Carried over from ``repro/core/hashing.py`` unchanged: exact uint64
NumPy host code, bit-identical to the reference by construction.

Two interchangeable families:

* :class:`UniversalHash` — the paper's h(t, x) = (a1·t + a2·x + b) mod p
  with p = 2^61 − 1 (Mersenne prime).  Exact 61-bit arithmetic is done in
  numpy uint64 via Mersenne folding (no Python-int fallback), so hash grids
  for a whole text vectorize.
* :class:`MixHash` — a stateless splitmix64 counter-based mix.  Slightly
  faster, used by the distributed pipeline where every worker must derive
  identical hash functions from (seed, k) without broadcasting tables.

Both are deterministic functions of an integer ``seed``.
"""

from __future__ import annotations

import numpy as np

MERSENNE61 = np.uint64((1 << 61) - 1)
_LOW31 = np.uint64((1 << 31) - 1)

# ---------------------------------------------------------------------------
# splitmix64 — the stateless mixing primitive everything derives from.
# ---------------------------------------------------------------------------

_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_M2 = np.uint64(0x94D049BB133111EB)


def splitmix64(x: np.ndarray | int) -> np.ndarray:
    """Vectorized splitmix64 finalizer. uint64 -> uint64."""
    z = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = (z + _SM_GAMMA).astype(np.uint64)
        z = ((z ^ (z >> np.uint64(30))) * _SM_M1).astype(np.uint64)
        z = ((z ^ (z >> np.uint64(27))) * _SM_M2).astype(np.uint64)
        z = z ^ (z >> np.uint64(31))
    return z


def mix2(a, b) -> np.ndarray:
    """Combine two uint64 streams into one mixed stream."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    with np.errstate(over="ignore"):
        return splitmix64(splitmix64(a) ^ (b * _SM_GAMMA).astype(np.uint64))


def uniform01(bits: np.ndarray) -> np.ndarray:
    """uint64 -> float64 uniform in (0, 1), never exactly 0 or 1."""
    # keep the top 53 bits, add 0.5 ulp offset so u in (0,1) strictly
    return ((bits >> np.uint64(11)).astype(np.float64) + 0.5) * (2.0 ** -53)


# ---------------------------------------------------------------------------
# Mersenne-61 modular arithmetic (vectorized, overflow-free in uint64)
# ---------------------------------------------------------------------------


def mod_m61(x: np.ndarray) -> np.ndarray:
    """x mod (2^61-1) for x < 2^64 (one or two folds)."""
    x = np.asarray(x, dtype=np.uint64)
    x = (x & MERSENNE61) + (x >> np.uint64(61))
    x = (x & MERSENNE61) + (x >> np.uint64(61))
    # x may now equal p exactly
    return np.where(x == MERSENNE61, np.uint64(0), x).astype(np.uint64)


def mulmod_m61(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a * b) mod (2^61-1) with a, b < 2^61, without 128-bit ints.

    Split a = ah·2^31 + al (ah < 2^30, al < 2^31).  Then
       a·b = ah·b·2^31 + al·b.
    ah·b < 2^30·2^61 overflows, so reduce b first: all products are taken
    with operands < 2^31 after splitting both sides (schoolbook, 4 partials).
    """
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    ah = a >> np.uint64(31)
    al = a & _LOW31
    bh = b >> np.uint64(31)
    bl = b & _LOW31
    with np.errstate(over="ignore"):
        # a*b = ah*bh*2^62 + (ah*bl + al*bh)*2^31 + al*bl
        # 2^62 ≡ 2 (mod p); 2^31 fold below.
        hh = mod_m61(ah * bh)              # < p
        mid = mod_m61(ah * bl + al * bh)   # each partial < 2^61, sum < 2^62 fits
        ll = mod_m61(al * bl)
        # hh * 2^62 mod p = hh * 2
        term_hh = mod_m61(hh << np.uint64(1))
        # mid * 2^31 mod p: split mid = mh*2^30 + ml; mid*2^31 = mh*2^61 + ml*2^31
        mh = mid >> np.uint64(30)
        ml = mid & np.uint64((1 << 30) - 1)
        term_mid = mod_m61(mh + (ml << np.uint64(31)))
        return mod_m61(term_hh + term_mid + ll)


class UniversalHash:
    """The paper's universal family h(t,x) = (a1 t + a2 x + b) mod p.

    One instance = one hash function.  ``from_seed(seed, k)`` derives k
    independent members deterministically.
    """

    __slots__ = ("a1", "a2", "b")

    def __init__(self, a1: int, a2: int, b: int):
        p = int(MERSENNE61)
        self.a1 = np.uint64(a1 % p or 1)
        self.a2 = np.uint64(a2 % p or 1)
        self.b = np.uint64(b % p)

    @classmethod
    def from_seed(cls, seed: int, k: int) -> list["UniversalHash"]:
        idx = np.arange(k, dtype=np.uint64)
        base = mix2(np.uint64(seed), idx)
        a1 = mod_m61(splitmix64(base ^ np.uint64(0xA1)))
        a2 = mod_m61(splitmix64(base ^ np.uint64(0xA2)))
        b = mod_m61(splitmix64(base ^ np.uint64(0xB0)))
        return [cls(int(a1[i]), int(a2[i]), int(b[i])) for i in range(k)]

    def __call__(self, t, x) -> np.ndarray:
        """h(t, x); t and x broadcastable integer arrays. Returns uint64 < p."""
        t = mod_m61(np.asarray(t, dtype=np.uint64))
        x = mod_m61(np.asarray(x, dtype=np.uint64))
        with np.errstate(over="ignore"):
            return mod_m61(mulmod_m61(self.a1, t) + mulmod_m61(self.a2, x) + self.b)


class MixHash:
    """Stateless counter-based family: h(t,x) = splitmix-mix(seed, t, x)."""

    __slots__ = ("seed",)

    def __init__(self, seed: int):
        self.seed = np.uint64(seed)

    @classmethod
    def from_seed(cls, seed: int, k: int) -> list["MixHash"]:
        base = mix2(np.uint64(seed), np.arange(k, dtype=np.uint64))
        return [cls(int(base[i])) for i in range(k)]

    def __call__(self, t, x) -> np.ndarray:
        t = np.asarray(t, dtype=np.uint64)
        x = np.asarray(x, dtype=np.uint64)
        return mix2(mix2(self.seed, t), x)
