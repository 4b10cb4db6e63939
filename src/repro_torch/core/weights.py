"""TF / IDF weight functions (Table 1 of the paper).

Carried over from ``repro/core/weights.py`` unchanged (NumPy host code).

A weight function w(t, x) maps (token, frequency-in-text) -> positive real,
under the paper's AoW assumption: monotonically increasing in x and
independent of any other property of the text.  w(t, x) = tf(x) · idf(t).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

# --- TF weight functions (x is an integer frequency >= 1) -----------------

TF_FUNCS: dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "binary": lambda x: (np.asarray(x, dtype=np.float64) >= 1).astype(np.float64),
    "raw": lambda x: np.asarray(x, dtype=np.float64),
    "log": lambda x: np.log(np.asarray(x, dtype=np.float64) + 1.0),
    "squared": lambda x: np.asarray(x, dtype=np.float64) ** 2,
}


def make_idf(kind: str, n_docs: int | None = None,
             doc_freq: dict[int, int] | None = None) -> Callable[[np.ndarray], np.ndarray]:
    """IDF weight per Table 1.  ``unary`` needs no corpus stats; the others
    need N = |D| and N_t (doc frequency per token)."""
    if kind == "unary":
        return lambda t: np.ones_like(np.asarray(t, dtype=np.float64))
    if n_docs is None or doc_freq is None:
        raise ValueError(f"idf kind {kind!r} needs corpus stats (n_docs, doc_freq)")
    n = float(n_docs)

    def _nt(t: np.ndarray) -> np.ndarray:
        t = np.atleast_1d(np.asarray(t, dtype=np.int64))
        return np.array([max(doc_freq.get(int(ti), 1), 1) for ti in t], dtype=np.float64)

    if kind == "standard":
        return lambda t: np.log(np.maximum(n / _nt(t), 1.0 + 1e-12))
    if kind == "smooth":
        return lambda t: np.log((n + _nt(t)) / _nt(t)) + 1.0
    if kind == "probabilistic":
        return lambda t: np.log(np.maximum((n - _nt(t)), 1.0) / _nt(t) + 1e-12) + 1e-9
    raise ValueError(f"unknown idf kind {kind!r}")


@dataclass
class WeightFn:
    """w(t, x) = tf(x) * idf(t), AoW-compliant."""

    tf: str = "raw"
    idf: str = "unary"
    n_docs: int | None = None
    doc_freq: dict[int, int] | None = None
    _idf_fn: Callable = field(init=False, repr=False)

    def __post_init__(self):
        if self.tf not in TF_FUNCS:
            raise ValueError(f"unknown tf kind {self.tf!r}")
        self._idf_fn = make_idf(self.idf, self.n_docs, self.doc_freq)

    @classmethod
    def fit(cls, docs, *, tf: str = "raw", idf: str = "smooth") -> "WeightFn":
        """Fit corpus statistics (N, per-token doc frequency) from token
        docs and return the corresponding TF-IDF weight function.

        ``idf="unary"`` needs no statistics but is accepted for a uniform
        construction path (``Aligner.build`` calls this for every weighted
        similarity).
        """
        doc_freq: dict[int, int] = {}
        n_docs = 0
        for d in docs:
            n_docs += 1
            for t in np.unique(np.asarray(d, dtype=np.int64)):
                t = int(t)
                doc_freq[t] = doc_freq.get(t, 0) + 1
        return cls(tf=tf, idf=idf, n_docs=n_docs, doc_freq=doc_freq)

    def __call__(self, t, x) -> np.ndarray:
        """Weight of token(s) t at frequency(ies) x (broadcastable)."""
        tfv = TF_FUNCS[self.tf](x)
        idfv = self._idf_fn(t)
        return np.maximum(tfv * idfv, 1e-300)  # keep strictly positive
