"""`repro_torch.api` — the one-object facade over the port's pipeline.

Carried over from ``repro/api.py`` for the main path, single shard::

    from repro_torch.api import Aligner

    Aligner.build(corpus, similarity="tfidf", k=32, pipeline="columnar",
                  store="idx_dir")                          # build + store
    server = Aligner.load("idx_dir", mmap=True)             # serve (mmap)
    results = server.find_batch(queries, theta=0.8)         # on the card

Queries run ``QueryOptions(plan="device")`` by default, on ``device``
(``None`` means ``"cuda"``).  Where CUDA is absent the constructor raises:
nothing carries on on the CPU unless the caller passes ``device="cpu"``.
The store is format v1, so ``load`` also serves a store the reference
built, and the reference loads one this package built.

Not ported yet: the dict build pipeline, shards, live serving with its
write-ahead log, ``save`` of a built index, and fault injection.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .core.columnar import ColumnarBuilder
from .core.device_plan import resolve_device
from .core.query import batch_query
from .core.results import QueryOptions, QueryResult
from .core.schemes import make_scheme
from .core.store import load_index, read_manifest

_ALIGNER_META = "aligner.json"


@dataclass(frozen=True)
class AlignerConfig:
    """Everything ``Aligner.build`` needs besides the corpus.

    similarity: "tfidf" (corpus-fitted TF-IDF weighted Jaccard, the
        default), "weighted" (TF-only weighted Jaccard) or "multiset".
    k: sketch width (number of hash functions / inverted tables).
    method: compact-window partitioner ("mono_active", "mono_all").
    tf / idf: weight-function kinds; ``idf=None`` picks the similarity's
        default ("smooth" for tfidf, "unary" for weighted).
    family: multiset hash family ("universal" or "mix").
    """

    similarity: str = "tfidf"
    k: int = 16
    method: str = "mono_active"
    seed: int = 0
    tf: str = "raw"
    idf: str | None = None
    family: str = "universal"

    def make_scheme(self, corpus=None):
        return make_scheme(self.similarity, seed=self.seed, k=self.k,
                           tf=self.tf, idf=self.idf, family=self.family,
                           corpus=corpus)


class Aligner:
    """Build→serve facade: index a corpus once, serve alignment queries
    on ``device`` (resolved at construction: ``None`` means ``"cuda"``)."""

    def __init__(self, index, *, config: AlignerConfig | None = None,
                 tokenizer=None, device=None):
        self.device = resolve_device(device)
        self._index = index
        self.config = config or AlignerConfig()
        self.tokenizer = tokenizer

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, corpus, *, similarity: str = "tfidf", k: int = 16,
              method: str = "mono_active", seed: int = 0, tf: str = "raw",
              idf: str | None = None, family: str = "universal",
              tokenizer=None, pipeline: str = "columnar", store=None,
              mmap: bool = True, device=None) -> "Aligner":
        """Fit weights from ``corpus``, construct the scheme, and index
        every document with the columnar pipeline.  ``corpus`` is an
        iterable of token arrays or strings (strings are tokenized with
        ``tokenizer``, by default a ``HashWordTokenizer``).  ``store=``
        streams the index into a store directory and serves from it
        (``mmap=True`` maps the arrays)."""
        if pipeline != "columnar":
            raise NotImplementedError(
                f"pipeline={pipeline!r} is not ported yet; use 'columnar'")
        config = AlignerConfig(similarity=similarity, k=k, method=method,
                               seed=seed, tf=tf, idf=idf, family=family)
        docs = list(corpus)
        if docs and isinstance(docs[0], str) and tokenizer is None:
            from .data.tokenizer import HashWordTokenizer
            tokenizer = HashWordTokenizer()
        self = cls(None, config=config, tokenizer=tokenizer, device=device)
        token_docs = [self._tokens(d) for d in docs]
        builder = ColumnarBuilder(scheme=config.make_scheme(corpus=token_docs),
                                  method=config.method).build(token_docs)
        if store is None:
            self._index = builder.freeze()
        else:
            self._index = builder.freeze_to_store(store, mmap=mmap)
            meta = {"similarity": config.similarity,
                    "tokenizer": _tokenizer_spec(tokenizer)}
            (Path(store) / _ALIGNER_META).write_text(json.dumps(meta))
        return self

    @classmethod
    def load(cls, path, *, mmap: bool = True, device=None) -> "Aligner":
        """Load a store and serve from it on ``device`` (``None`` means
        ``"cuda"``, which raises where CUDA is absent).  ``mmap=True`` maps
        the arrays read-only instead of reading them into RAM."""
        device = resolve_device(device)
        root = Path(path)
        meta = {}
        if (root / _ALIGNER_META).exists():
            meta = json.loads((root / _ALIGNER_META).read_text())
        index = load_index(root, mmap=mmap)
        spec = read_manifest(root)["scheme"]
        weight = spec.get("weight") or {}
        config = AlignerConfig(
            similarity=meta.get("similarity", spec["kind"]), k=spec["k"],
            seed=spec["seed"], method=index.method,
            tf=weight.get("tf", "raw"), idf=weight.get("idf"),
            family=spec.get("family", "universal"))
        return cls(index, config=config, device=device,
                   tokenizer=_tokenizer_from_spec(meta.get("tokenizer")))

    # -- queries ------------------------------------------------------------

    def find(self, text, theta: float, *,
             options: QueryOptions | None = None,
             stage_times: dict | None = None) -> QueryResult:
        """All indexed subsequences aligned with ``text`` at estimated
        (weighted) Jaccard >= theta (paper Definition 1).  ``options`` as
        for :meth:`find_batch`."""
        return self.find_batch([text], theta, options=options,
                               stage_times=stage_times)[0]

    def find_batch(self, texts, theta: float, *,
                   options: QueryOptions | None = None,
                   stage_times: dict | None = None) -> list[QueryResult]:
        """Batched :meth:`find`: one :class:`QueryResult` per text.
        ``options.plan`` names the pipeline — ``"device"`` (the default),
        ``"cpu"`` or ``"auto"``.  ``QueryOptions(sketch_backend="pallas")``
        pins the f32 CUDA sketch kernel on this Aligner's device under
        either plan (weighted schemes; identities can differ from the
        default exact sketch on argmin near-ties).  ``stage_times``
        accumulates per-stage wall seconds under
        ``"sketch"``/``"probe"``/``"sweep"``."""
        tokens = [self._tokens(t) for t in texts]
        res = batch_query(self._index, tokens, theta, options=options,
                          device=self.device, stage_times=stage_times)
        k = self.scheme.k
        return [QueryResult.from_alignments(r, theta=theta, k=k,
                                            query_len=len(t))
                for r, t in zip(res, tokens)]

    # -- introspection ------------------------------------------------------

    @property
    def index(self):
        return self._index

    @property
    def scheme(self):
        return self._index.scheme

    @property
    def num_docs(self) -> int:
        return self._index.num_texts

    @property
    def num_windows(self) -> int:
        return self._index.num_windows

    def __repr__(self) -> str:
        return (f"Aligner(similarity={self.config.similarity!r}, "
                f"k={self.config.k}, docs={self.num_docs}, "
                f"windows={self.num_windows}, device={self.device})")

    # -- helpers ------------------------------------------------------------

    def _tokens(self, text) -> np.ndarray:
        if isinstance(text, str):
            if self.tokenizer is None:
                raise ValueError(
                    "this Aligner has no tokenizer (the corpus was token "
                    "arrays, or the build tokenizer did not round-trip "
                    "through the store); pass token arrays")
            return np.asarray(self.tokenizer.encode(text), np.int64)
        return np.asarray(text, np.int64)


def _tokenizer_spec(tok) -> dict | None:
    from .data.tokenizer import ByteTokenizer, HashWordTokenizer
    if isinstance(tok, HashWordTokenizer):
        return {"kind": "hash_word", "vocab": tok.vocab,
                "lowercase": tok.lowercase}
    if isinstance(tok, ByteTokenizer):
        return {"kind": "byte"}
    return None          # custom tokenizers don't round-trip; pass anew


def _tokenizer_from_spec(spec: dict | None):
    if not spec:
        return None
    from .data.tokenizer import ByteTokenizer, HashWordTokenizer
    if spec["kind"] == "hash_word":
        return HashWordTokenizer(vocab=spec["vocab"],
                                 lowercase=spec["lowercase"])
    if spec["kind"] == "byte":
        return ByteTokenizer()
    return None


__all__ = ["Aligner", "AlignerConfig", "QueryOptions", "QueryResult"]
