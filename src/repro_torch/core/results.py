"""Typed query results and options — the public result surface and the
serving wire protocol.

Carried over from ``repro/core/results.py`` with the same ``to_dict`` /
``from_dict`` wire schema.  The deprecated per-stage keyword arguments and
their coercion shim are not carried over, and ``QueryOptions.plan``
defaults to ``"device"``: the entry points run on the card unless the
caller asks for ``plan="cpu"``.

The engine's native result is :class:`repro_torch.core.query.Alignment` (one per
(query, data-text) pair, carrying the Definition-1 maximal blocks).  The
facade and the network server speak in terms of:

* :class:`Match` — one aligned data text, as a frozen record with the
  global ``doc_id``, the outer ``span`` of all result subsequences in the
  data text, the ``query_span`` it aligned against (Definition 1 aligns
  the *whole* query, so this is the full query extent), the
  ``estimated_similarity`` (the fraction of the query's k sketch
  coordinates that collided with the text — ``>= theta`` for every
  returned match, Eq. 2/Eq. 5), and the full ``blocks`` family.
* :class:`QueryResult` — the per-query container; iterates its matches
  (so ``for hit in aligner.find(...)`` keeps working) and round-trips
  through ``to_dict``/``from_dict``/JSON, which is exactly the payload
  the reference's network server puts on the wire.
* :class:`QueryOptions` — the query-execution knobs: the plan and its
  per-stage pins.

None of these affect result *content*: every options combination remains
block-identical, and a ``Match`` is a re-labelling of an ``Alignment``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

__all__ = ["Match", "QueryResult", "QueryOptions"]


@dataclass(frozen=True)
class Match:
    """One aligned data text (all its result subsequences, as blocks).

    span: (lo, hi) outer extent of the result subsequences in the data
        text: every reported ``T[i..j]`` has ``lo <= i`` and ``j <= hi``.
    query_span: (0, len(query) - 1) — the query extent the text aligned
        against (the paper aligns the full query).
    estimated_similarity: colliding-coordinate fraction ``ncoords / k``
        (>= theta by construction: a reported cell is covered by
        >= ceil(k * theta) coordinates); ``None`` when the producing path
        did not count collisions.
    blocks: the Definition-1 maximal blocks, ``(i_lo, i_hi, j_lo, j_hi)``
        tuples exactly as :class:`~repro_torch.core.query.Alignment` carries
        them (every ``T[i..j]`` with ``i in [i_lo, i_hi]``,
        ``j in [j_lo, j_hi]`` is a result).
    """

    doc_id: int
    span: tuple[int, int]
    query_span: tuple[int, int]
    estimated_similarity: float | None
    blocks: list[tuple[int, int, int, int]] = field(default_factory=list)

    @property
    def text_id(self) -> int:
        """Legacy alias (``Alignment.text_id``) so pre-typed callers keep
        reading ``hit.text_id``."""
        return self.doc_id

    def __iter__(self):
        # tuple-style unpacking: doc_id, span, query_span, similarity
        yield self.doc_id
        yield self.span
        yield self.query_span
        yield self.estimated_similarity

    def to_dict(self) -> dict:
        return {"doc_id": self.doc_id,
                "span": list(self.span),
                "query_span": list(self.query_span),
                "estimated_similarity": self.estimated_similarity,
                "blocks": [list(b) for b in self.blocks]}

    @classmethod
    def from_dict(cls, d: dict) -> "Match":
        return cls(doc_id=int(d["doc_id"]),
                   span=tuple(int(x) for x in d["span"]),
                   query_span=tuple(int(x) for x in d["query_span"]),
                   estimated_similarity=(
                       None if d.get("estimated_similarity") is None
                       else float(d["estimated_similarity"])),
                   blocks=[tuple(int(x) for x in b) for b in d["blocks"]])

    @classmethod
    def from_alignment(cls, al, *, k: int, query_len: int) -> "Match":
        """Re-label one engine :class:`Alignment` (``k`` is the sketch
        width, for the similarity estimate)."""
        blocks = list(al.blocks)
        span = (min(b[0] for b in blocks), max(b[3] for b in blocks))
        sim = None if al.ncoords is None else al.ncoords / k
        return cls(doc_id=int(al.text_id), span=span,
                   query_span=(0, max(0, query_len - 1)),
                   estimated_similarity=sim, blocks=blocks)


@dataclass(frozen=True)
class QueryResult:
    """All matches of one query, plus the query's own context.

    Iterates (and indexes, and bool-tests) as the list of matches, so the
    pre-typed ``for hit in aligner.find(q, theta)`` loop is unchanged.

    ``degraded=True`` marks a *partial* result: one or more sharded
    fan-out probes failed (after bounded retries) and were skipped, so
    matches from the shards in ``failed_shards`` may be missing.  Healthy
    results keep the defaults, so pre-degraded consumers are unaffected.
    """

    matches: list[Match]
    theta: float
    query_len: int | None = None
    degraded: bool = False
    failed_shards: tuple = ()

    def __iter__(self):
        return iter(self.matches)

    def __len__(self) -> int:
        return len(self.matches)

    def __getitem__(self, i):
        return self.matches[i]

    def __bool__(self) -> bool:
        return bool(self.matches)

    def to_dict(self) -> dict:
        return {"matches": [m.to_dict() for m in self.matches],
                "theta": self.theta, "query_len": self.query_len,
                "degraded": self.degraded,
                "failed_shards": list(self.failed_shards)}

    @classmethod
    def from_dict(cls, d: dict) -> "QueryResult":
        return cls(matches=[Match.from_dict(m) for m in d["matches"]],
                   theta=float(d["theta"]),
                   query_len=(None if d.get("query_len") is None
                              else int(d["query_len"])),
                   degraded=bool(d.get("degraded", False)),
                   failed_shards=tuple(d.get("failed_shards", ())))

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "QueryResult":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_alignments(cls, alignments, *, theta: float, k: int,
                        query_len: int) -> "QueryResult":
        return cls(matches=[Match.from_alignment(al, k=k,
                                                 query_len=query_len)
                            for al in alignments],
                   theta=theta, query_len=query_len)


#: the stage fields a plan resolves (mirrors repro_torch.core.plan.
#: STAGE_FIELDS, duplicated here so the wire/result layer stays import-light)
_STAGE_FIELDS = ("sketch_backend", "probe_backend", "sweep")

_WIRE_FIELDS = ("plan",) + _STAGE_FIELDS


@dataclass(frozen=True)
class QueryOptions:
    """Execution knobs for the batched query path (content-neutral: every
    plan returns block-identical results).

    plan: which :class:`repro_torch.core.plan.ExecutionPlan` runs the batch
        — ``"device"`` (the default: arena resident on the card, probe and
        sweep as CUDA kernels), ``"cpu"`` (NumPy reference path) or
        ``"auto"`` (device when CUDA is available, else cpu).  Resolved
        once per batch by ``repro_torch.core.plan.resolve_plan``.
    sketch_backend / probe_backend / sweep: per-stage *pins*.  ``None``
        lets the plan pick; pinning a value the plan cannot execute raises
        ``TypeError`` at resolution.  ``sketch_backend="pallas"`` (the
        reference's wire name, kept so the wire form stays identical)
        sketches the batch with the hand-written f32 CUDA kernel
        ``repro_torch.kernels.icws_hash.icws_sketch_batch`` under either
        plan; its identities can differ from the exact host sketch on
        argmin near-ties, so it is a pin, never a default.
    """

    plan: str = "device"
    sketch_backend: str | None = None
    probe_backend: str | None = None
    sweep: str | None = None

    def to_dict(self) -> dict:
        d = {"plan": self.plan}
        d.update({f: getattr(self, f) for f in _STAGE_FIELDS
                  if getattr(self, f) is not None})
        return d

    @classmethod
    def from_dict(cls, d: dict | None) -> "QueryOptions":
        d = d or {}
        unknown = set(d) - set(_WIRE_FIELDS)
        if unknown:
            raise ValueError(f"unknown query options: {sorted(unknown)}")
        return cls(**{k: d[k] for k in d})
