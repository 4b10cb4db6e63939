"""Improved Consistent Weighted Sampling (Ioffe 2010; Algorithm 6 of paper).

Carried over from ``repro/core/icws.py`` (NumPy float64 host code, the
exact sketch path): bit-identical to the reference by construction.

A hash function h ∈ H maps (token t, weight w) -> HashValue (t, y, a):

    r_t, c_t ~ Gamma(2,1),  β_t ~ Uniform(0,1)      (per token, per function)
    k_int = ⌊ ln(w)/r_t + β_t ⌋                      (the "quantized log-weight")
    y     = exp(r_t · (k_int − β_t))
    a     = c_t / (y · exp(r_t))

Ordering: v1 < v2  iff  a1 < a2.  Since y is determined by the integer
k_int (given t), (t, k_int) is the exact identity of a hash value.
Per-token randomness is derived statelessly from (seed, token) via
splitmix64 — Gamma(2,1) = −ln(u1·u2) — so no vocabulary-sized tables exist.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .hashing import mix2, uniform01


def _token_params(seed, t: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """r_t, c_t, beta_t for token array t (float64).  ``seed`` may be a
    scalar or an array broadcastable against ``t`` (the batched sketch
    evaluates all k hashers in one (k, N) call)."""
    t = np.asarray(t, dtype=np.uint64)
    base = mix2(np.asarray(seed, dtype=np.uint64), t)
    u1 = uniform01(mix2(base, np.uint64(1)))
    u2 = uniform01(mix2(base, np.uint64(2)))
    u3 = uniform01(mix2(base, np.uint64(3)))
    u4 = uniform01(mix2(base, np.uint64(4)))
    u5 = uniform01(mix2(base, np.uint64(5)))
    r = -np.log(u1 * u2)   # Gamma(2, 1)
    c = -np.log(u3 * u4)   # Gamma(2, 1)
    beta = u5              # Uniform(0, 1)
    return r, c, beta


@dataclass(frozen=True)
class ICWS:
    """One member of the ICWS hash family (≙ one sketch coordinate)."""

    seed: int

    @classmethod
    def from_seed(cls, seed: int, k: int) -> list["ICWS"]:
        base = mix2(np.uint64(seed), np.arange(k, dtype=np.uint64))
        return [cls(int(base[i])) for i in range(k)]

    def hash_parts(self, t, w) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Return (k_int, y, a) for tokens t with weights w (broadcastable).

        k_int is the integer identity component; a is the sort component.
        """
        t = np.atleast_1d(np.asarray(t, dtype=np.int64))
        w = np.atleast_1d(np.asarray(w, dtype=np.float64))
        t, w = np.broadcast_arrays(t, w)
        r, c, beta = _token_params(self.seed, t)
        k_int = np.floor(np.log(w) / r + beta)
        y = np.exp(r * (k_int - beta))
        a = c / (y * np.exp(r))
        return k_int.astype(np.int64), y, a

    def min_hash(self, tokens: np.ndarray, weights: np.ndarray
                 ) -> tuple[int, int, float]:
        """Weighted min-hash of a text given (distinct tokens, weights).

        Returns the identity/order triple (t*, k_int*, a*).
        """
        k_int, _y, a = self.hash_parts(tokens, weights)
        i = int(np.argmin(a))
        return int(tokens[i]), int(k_int[i]), float(a[i])
