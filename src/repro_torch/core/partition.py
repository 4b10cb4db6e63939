"""Monotonic Partitioning (Algorithm 4) — the paper's core contribution.

Carried over from ``repro/core/partition.py`` (host Python/NumPy: the
sequential skyline loop has no accelerator form), trimmed to ``Partition``
and ``monotonic_partition``.  The AllAlign partitioner is not ported yet.

Visits keys in ascending hash order while maintaining the skyline of visited
keys (a totally ordered staircase, Lemmas 5–7); each visit emits one compact
window per staircase step it consumes (Lemma 14 C2) and updates the skyline.

The skyline is kept in two parallel coordinate-ordered Python lists with
guard keys (−1,−1) and (n,n) (0-indexed variant of the paper's (0,0) and
(n+1,n+1)).  Every key is inserted at most once and removed at most once;
removals are contiguous slices, so the list operations are O(len) memmoves
at C speed and binary searches are O(log n) — matching the paper's
O(|X(T)|·log n) bound up to the memmove constant.

Windows use 0-indexed inclusive coordinates: ⟨gid, a, b, c, d⟩ represents
all subsequences T[i..j] with i ∈ [a,b], j ∈ [c,d].
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from dataclasses import dataclass

import numpy as np

from .keys import KeySet


@dataclass
class Partition:
    """A partition P(T, h): compact windows + the gid identity table."""

    n: int
    gid: np.ndarray   # int64 local group id per window
    a: np.ndarray     # int64 window coords (0-indexed, inclusive)
    b: np.ndarray
    c: np.ndarray
    d: np.ndarray

    def __len__(self) -> int:
        return len(self.gid)


def monotonic_partition(keys: KeySet) -> Partition:
    """Algorithm 4 over a pre-sorted KeySet (MonoAll or MonoActive depending
    on how ``keys`` was generated).

    This loop is the sequential heart of the build pipeline (everything
    around it is vectorized), so it is written for CPython constant
    factors: one binary search replaces the Lines 4+6 pair (``ys`` is
    strictly increasing, so the largest ``y <= c`` is ``il`` exactly when
    ``ys[il] == c``, else ``il - 1``), the splice+insert of Lines 14-15 is
    a single slice assignment (one memmove), and the common emit case
    (one staircase step, no dominated keys) skips the general loop.
    """
    n = keys.n
    kp = keys.p.tolist()
    kq = keys.q.tolist()
    kg = keys.gid.tolist()

    # skyline with guards; xs/ys are both sorted (Lemma 6)
    xs = [-1, n]
    ys = [-1, n]

    out_gid: list[int] = []
    out_a: list[int] = []
    out_b: list[int] = []
    out_c: list[int] = []
    out_d: list[int] = []
    emit_gid = out_gid.append
    emit_a = out_a.append
    emit_b = out_b.append
    emit_c = out_c.append
    emit_d = out_d.append

    for b, c, g in zip(kp, kq, kg):
        # Lines 4+6 fused: il = first index with ys >= c, so the largest
        # index with y < c (Line 6's i) is il - 1 and the largest with
        # y <= c (Line 4's j') is il iff ys[il] == c, else il - 1
        il = bisect_left(ys, c)
        i = il - 1
        jp = il if ys[il] == c else i
        xjp = xs[jp]
        # Line 5: S[j'] dominates (b,c) iff [xjp, ys[jp]] ⊂ [b, c]
        if xjp >= b and not (xjp == b and ys[jp] == c):
            continue
        # Line 7: smallest j with S[j].x > b
        j = bisect_right(xs, b)
        # Lines 8-13: emit staircase windows (Lemma 14 C2)
        if j == il:
            # one staircase step, nothing dominated: pure insert
            a = xs[i] + 1
            d = ys[il] - 1
            if a <= b and c <= d:
                emit_gid(g)
                emit_a(a)
                emit_b(b)
                emit_c(c)
                emit_d(d)
            xs.insert(il, b)
            ys.insert(il, c)
            continue
        cprime = c
        for kk in range(i, j):
            a = xs[kk] + 1
            d = ys[kk + 1] - 1
            if a <= b and cprime <= d:
                emit_gid(g)
                emit_a(a)
                emit_b(b)
                emit_c(cprime)
                emit_d(d)
            cprime = ys[kk + 1]
        # Lines 14-15: splice dominated keys out, insert (b, c) — one
        # slice assignment instead of del + insert
        xs[il:j] = (b,)
        ys[il:j] = (c,)

    return Partition(
        n=n,
        gid=np.array(out_gid, dtype=np.int64),
        a=np.array(out_a, dtype=np.int64),
        b=np.array(out_b, dtype=np.int64),
        c=np.array(out_c, dtype=np.int64),
        d=np.array(out_d, dtype=np.int64),
    )
