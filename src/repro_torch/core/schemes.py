"""Sketch schemes and the ``make_scheme`` registry.

Carried over from ``repro/core/schemes.py`` (NumPy host code), trimmed to
what the columnar build and the query sketch call.  ``sketch_batch`` runs
the exact float64/uint64 host path by default; ``backend="pallas"`` (the
reference's wire name) sketches a weighted batch with the hand-written f32
CUDA kernel :func:`repro_torch.kernels.icws_hash.icws_sketch_batch`.

  * ``MultisetScheme``  — integer universal (or splitmix) min-hash for
    multi-set Jaccard; index key ``int(h)``.
  * ``WeightedScheme``  — ICWS for weighted Jaccard; index key
    ``(token, k_int)``.

``make_scheme(similarity, ...)`` builds one by name (``"multiset"``,
``"weighted"``, ``"tfidf"``), and schemes round-trip through JSON
(``scheme_spec`` / ``scheme_from_spec``) exactly as the reference's store
manifest writes them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .hashing import MixHash, UniversalHash
from .icws import ICWS, _token_params
from .keys import (_flat_grid, generate_key_columns_icws,
                   generate_key_columns_multiset, occurrence_lists)
from .weights import WeightFn


@dataclass
class MultisetScheme:
    """Sketch scheme for multi-set Jaccard (standard min-hash over (t, x)).

    family="universal" is the paper's linear family; family="mix" is the
    splitmix64 family.
    """

    seed: int = 0
    k: int = 16
    family: str = "universal"
    hashers: list = field(init=False)

    def __post_init__(self):
        cls = {"universal": UniversalHash, "mix": MixHash}[self.family]
        self.hashers = cls.from_seed(self.seed, self.k)

    def key_columns(self, tokens, i: int, active: bool, occ=None):
        return generate_key_columns_multiset(tokens, self.hashers[i],
                                             active=active, occ=occ)

    def sketch(self, tokens) -> list:
        """k min-hash identities of a whole text (Eq. 1)."""
        return self.sketch_batch([tokens])[0]

    def sketch_batch(self, texts, *, backend: str = "exact",
                     device=None) -> list[list]:
        """Sketches of many texts: one vectorized hash call per (text,
        hasher) over the flat (t, x) grid.  Integer hashes are exact on
        every backend, so ``backend`` and ``device`` are accepted for
        signature parity and ignored, as in the reference."""
        out = []
        for tokens in texts:
            occ = occurrence_lists(np.asarray(tokens, dtype=np.int64))
            _toks, _fs, t_rep, x_rep, _bounds = _flat_grid(occ)
            out.append([int(h(t_rep, x_rep).min()) for h in self.hashers])
        return out


@dataclass
class WeightedScheme:
    """Sketch scheme for weighted Jaccard (ICWS over (t, w(t, f)))."""

    weight: WeightFn
    seed: int = 0
    k: int = 16
    hashers: list[ICWS] = field(init=False)

    def __post_init__(self):
        self.hashers = ICWS.from_seed(self.seed, self.k)

    def key_columns(self, tokens, i: int, active: bool, occ=None):
        return generate_key_columns_icws(tokens, self.hashers[i], self.weight,
                                         active=active, occ=occ)

    def sketch(self, tokens) -> list:
        occ = occurrence_lists(np.asarray(tokens, dtype=np.int64))
        toks = np.array(sorted(occ), dtype=np.int64)
        freqs = np.array([len(occ[int(t)]) for t in toks], dtype=np.int64)
        w = self.weight(toks, freqs)
        out = []
        for h in self.hashers:
            t_star, k_star, _a = h.min_hash(toks, w)
            out.append((t_star, k_star))
        return out

    def sketch_batch(self, texts, *, backend: str = "exact",
                     device=None) -> list[list]:
        """Sketches of many texts.

        backend="exact"  — float64 host math, bit-identical to per-text
        ``sketch`` (the default; what result parity assumes): the whole
        batch in one flat (k, N) hash evaluation plus a padded segmented
        argmin, chunked.
        backend="pallas" — the reference's name for the on-device sketch:
        all texts through the hand-written CUDA kernel ``icws_sketch_batch``
        in one launch on ``device`` (``None`` means ``"cuda"``; the CPU
        runs the kernel's plain version).  f32 math: identities can differ
        from the exact path on argmin near-ties.
        """
        if backend == "pallas":
            from ..kernels.ops import cws_sketch_batch
            token_lists, weight_lists = [], []
            for tokens in texts:
                toks, freqs = np.unique(np.asarray(tokens, dtype=np.int64),
                                        return_counts=True)
                token_lists.append(toks)
                weight_lists.append(self.weight(toks, freqs))
            return cws_sketch_batch(self.seed, self.k, token_lists,
                                    weight_lists, device=device)
        uniq = [np.unique(np.asarray(t, dtype=np.int64), return_counts=True)
                for t in texts]
        if not uniq or min(len(u) for u, _ in uniq) == 0:
            return [self.sketch(t) for t in texts]
        out: list[list] = []
        # chunk so the (k, B_chunk, Umax) argmin pad stays cache-sized
        budget = (1 << 22) // max(1, self.k)
        lo = 0
        while lo < len(uniq):
            hi, umax = lo, 0
            while hi < len(uniq):
                umax = max(umax, len(uniq[hi][0]))
                if hi > lo and (hi - lo + 1) * umax > budget:
                    break
                hi += 1
            out.extend(self._sketch_chunk(uniq[lo:hi]))
            lo = hi
        return out

    def _sketch_chunk(self, uniq: list) -> list[list]:
        """Vectorized exact sketches of one chunk of (unique tokens,
        counts) pairs; bit-identical to looping ``sketch``."""
        B = len(uniq)
        sizes = np.array([len(u) for u, _ in uniq], dtype=np.int64)
        toks = np.concatenate([u for u, _ in uniq])
        freqs = np.concatenate([c for _, c in uniq])
        w = self.weight(toks, freqs)
        seeds = np.array([h.seed for h in self.hashers], dtype=np.uint64)
        # (k, N): the same float64 formulas as ICWS.hash_parts, elementwise
        r, c, beta = _token_params(seeds[:, None], toks[None, :])
        logw = np.log(w)[None, :]
        k_int = np.floor(logw / r + beta)
        y = np.exp(r * (k_int - beta))
        a = c / (y * np.exp(r))
        # segmented argmin via an inf-padded (k, B, Umax) view; tokens are
        # ascending within each text as in ``sketch``, so first-min
        # indices agree
        starts = np.cumsum(sizes) - sizes
        slot = np.arange(len(toks), dtype=np.int64) - np.repeat(starts, sizes)
        row = np.repeat(np.arange(B, dtype=np.int64), sizes)
        pad = np.full((self.k, B, int(sizes.max())), np.inf)
        pad[:, row, slot] = a
        amin = pad.argmin(axis=2)                     # (k, B)
        flat = starts[None, :] + amin
        t_star = toks[flat]
        k_star = np.take_along_axis(k_int.astype(np.int64), flat, axis=1)
        return [[(int(t_star[i, b]), int(k_star[i, b]))
                 for i in range(self.k)] for b in range(B)]


def make_scheme(similarity: str = "weighted", *, seed=0, k=16,
                family="universal", tf="raw", idf=None, corpus=None):
    """Construct a sketch scheme by similarity name: ``"multiset"``,
    ``"weighted"`` (TF only, ``idf`` defaults to ``"unary"``) or
    ``"tfidf"`` (IDF fitted from ``corpus``, ``idf`` defaults to
    ``"smooth"``)."""
    if similarity == "multiset":
        return MultisetScheme(seed=seed, k=k, family=family)
    if similarity == "weighted":
        return WeightedScheme(weight=WeightFn(tf=tf, idf=idf or "unary"),
                              seed=seed, k=k)
    if similarity == "tfidf":
        if corpus is None:
            raise ValueError(
                'similarity="tfidf" fits IDF from document frequencies: '
                "pass corpus= (token docs)")
        return WeightedScheme(
            weight=WeightFn.fit(corpus, tf=tf, idf=idf or "smooth"),
            seed=seed, k=k)
    raise ValueError(f"unknown similarity {similarity!r}; expected "
                     "'multiset', 'weighted' or 'tfidf'")


def scheme_spec(scheme) -> dict:
    """JSON-serializable description sufficient to rebuild ``scheme``."""
    if isinstance(scheme, MultisetScheme):
        return {"kind": "multiset", "seed": scheme.seed, "k": scheme.k,
                "family": scheme.family}
    if isinstance(scheme, WeightedScheme):
        w = scheme.weight
        return {"kind": "weighted", "seed": scheme.seed, "k": scheme.k,
                "weight": {"tf": w.tf, "idf": w.idf, "n_docs": w.n_docs,
                           "doc_freq": ({str(t): c
                                         for t, c in w.doc_freq.items()}
                                        if w.doc_freq is not None else None)}}
    raise TypeError(f"cannot serialize scheme of type {type(scheme)!r}")


def scheme_from_spec(spec: dict):
    """Inverse of ``scheme_spec``: rebuild the exact hash family."""
    kind = spec["kind"]
    if kind == "multiset":
        return MultisetScheme(seed=spec["seed"], k=spec["k"],
                              family=spec.get("family", "universal"))
    if kind == "weighted":
        w = spec["weight"]
        doc_freq = ({int(t): int(c) for t, c in w["doc_freq"].items()}
                    if w.get("doc_freq") is not None else None)
        weight = WeightFn(tf=w["tf"], idf=w["idf"], n_docs=w.get("n_docs"),
                          doc_freq=doc_freq)
        return WeightedScheme(weight=weight, seed=spec["seed"], k=spec["k"])
    raise ValueError(f"unknown scheme kind {kind!r} in manifest")
