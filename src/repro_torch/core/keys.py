"""Columnar key generation (Algorithms 3 & 5 of the paper), multiset and
ICWS variants.

Carried over from ``repro/core/keys.py``, trimmed to what the columnar
build and the query sketches call: ``occurrence_lists``, ``_flat_grid``,
``KeySet`` and the ``generate_key_columns_*`` generators.  This stays
NumPy on purpose: it is exact uint64/float64 host code that never touches
the accelerator, and torch has neither a uint64 ``searchsorted`` nor a
logical ``>>``.

A *key* is a pair (p, q), 0-indexed here, with T[p] == T[q]; its hash value is
h(T[q], f(T[q], T[p,q])).  With ``active=True`` only keys whose hash value is
a strict running minimum over the frequency axis are kept (Alg. 5).  Keys
come back sorted in visiting order: ascending hash, ties broken by
frequency ASCENDING, then (p, q) (the reference's erratum note explains why
the lower frequency goes first).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .icws import ICWS
from .weights import WeightFn


@dataclass
class KeySet:
    """Keys in visiting order plus the per-gid hash identities.

    gid is a *local* dense group id per distinct hash value; ``gid_ident``
    holds the identities as arrays: uint64 (G,) hash values for multiset,
    int64 (G, 2) (token, k_int) rows for ICWS.  ``order`` is the sortable
    hash magnitude (uint64 h, or float64 a).
    """

    n: int
    p: np.ndarray
    q: np.ndarray
    gid: np.ndarray
    order: np.ndarray
    freq: np.ndarray
    gid_ident: np.ndarray | None = None  # identity per gid

    def __len__(self) -> int:
        return len(self.p)


def occurrence_lists(tokens: np.ndarray) -> dict[int, np.ndarray]:
    """token -> sorted positions (0-indexed)."""
    tokens = np.asarray(tokens, dtype=np.int64)
    order = np.argsort(tokens, kind="stable")
    sorted_tok = tokens[order]
    bounds = np.flatnonzero(np.diff(sorted_tok)) + 1
    groups = np.split(order, bounds)
    return {int(tokens[g[0]]): np.sort(g) for g in groups}


def _flat_grid(occ: dict[int, np.ndarray]):
    """One flat (t, x) enumeration of the whole hash grid:
    (tokens, freqs, t per cell, x = 1..f per cell, segment bounds)."""
    toks = np.fromiter(occ.keys(), np.int64, len(occ))
    fs = np.fromiter((len(v) for v in occ.values()), np.int64, len(occ))
    total = int(fs.sum())
    t_rep = np.repeat(toks, fs)
    starts = np.concatenate([[0], np.cumsum(fs)[:-1]])
    x_rep = np.arange(total, dtype=np.int64) - np.repeat(starts, fs) + 1
    return toks, fs, t_rep, x_rep, np.cumsum(fs)[:-1]


def _occ_columns(occ: dict[int, np.ndarray]):
    """Flatten an occurrence dict into parallel columns (token-major):
    (tokens (T,), freqs (T,), segment starts (T,), positions flat (N,),
    token-index per grid cell (N,), frequency 1..f per grid cell (N,))."""
    toks, fs, _t_rep, x_flat, bounds = _flat_grid(occ)
    starts = np.concatenate([[0], bounds]).astype(np.int64)[:len(fs)]
    pos_flat = (np.concatenate(list(occ.values()))
                if occ else np.empty(0, np.int64))
    ti_flat = np.repeat(np.arange(len(fs), dtype=np.int64), fs)
    return toks, fs, starts, pos_flat, ti_flat, x_flat


def _segmented_active(vals: np.ndarray, fs: np.ndarray, starts: np.ndarray
                      ) -> np.ndarray:
    """Strict-running-minimum mask within each token segment, vectorized:
    ``act[j]`` iff ``vals[j] < min(vals[seg_start:j])`` (segment starts are
    always active), batched by frequency."""
    act = np.zeros(len(vals), bool)
    act[starts] = True
    for f in np.unique(fs):
        f = int(f)
        if f <= 1:
            continue
        sel = np.flatnonzero(fs == f)
        idx = starts[sel][:, None] + np.arange(f)
        m = vals[idx]
        run = np.minimum.accumulate(m[:, :-1], axis=1)
        act[idx[:, 1:].ravel()] = (m[:, 1:] < run).ravel()
    return act


def _expand_key_columns(n, fs, starts, pos_flat, ti_flat, x_flat,
                        order_flat, gid_ident, active: bool) -> KeySet:
    """Expand (token, frequency) grid cells into key-instance columns.

    Each selected cell g = (t, x) contributes cnt = f_t - x + 1 keys
    (p, q) = (pos[j], pos[x-1+j]); then one lexsort into visiting order."""
    if active:
        act = _segmented_active(order_flat, fs, starts)
        sel = np.flatnonzero(act)
    else:
        sel = np.arange(len(order_flat), dtype=np.int64)
    g_ti = ti_flat[sel]
    g_x = x_flat[sel]
    cnt = fs[g_ti] - g_x + 1
    total = int(cnt.sum())
    gid = np.repeat(np.arange(len(sel), dtype=np.int64), cnt)
    seq = np.arange(total, dtype=np.int64) - \
        np.repeat(np.cumsum(cnt) - cnt, cnt)
    base = starts[g_ti][gid]
    p = pos_flat[base + seq]
    q = pos_flat[base + g_x[gid] - 1 + seq]
    order = order_flat[sel][gid]
    freq = g_x[gid]
    # visiting order: hash asc, freq ASC, then (p, q) — total, because
    # (p, q) pairs are globally unique
    idx = np.lexsort((q, p, freq, order))
    return KeySet(n=n, p=p[idx], q=q[idx], gid=gid[idx], order=order[idx],
                  freq=freq[idx], gid_ident=gid_ident[sel])


def generate_key_columns_multiset(tokens: np.ndarray, hashfn,
                                  active: bool = False,
                                  occ: dict | None = None) -> KeySet:
    """Columnar Algorithm 3/5 for the multi-set min-hash (``gid_ident`` is
    the uint64 hash value per gid)."""
    tokens = np.asarray(tokens, dtype=np.int64)
    n = len(tokens)
    if occ is None:
        occ = occurrence_lists(tokens)
    toks, fs, starts, pos_flat, ti_flat, x_flat = _occ_columns(occ)
    h_flat = (hashfn(toks[ti_flat], x_flat) if len(ti_flat)
              else np.empty(0, np.uint64))
    return _expand_key_columns(n, fs, starts, pos_flat, ti_flat, x_flat,
                               h_flat, h_flat, active)


def generate_key_columns_icws(tokens: np.ndarray, icws: ICWS,
                              weight: WeightFn, active: bool = False,
                              occ: dict | None = None) -> KeySet:
    """Columnar §5 key generation (ICWS; ``gid_ident`` is int64 (G, 2)
    (token, k_int) rows)."""
    tokens = np.asarray(tokens, dtype=np.int64)
    n = len(tokens)
    if occ is None:
        occ = occurrence_lists(tokens)
    toks, fs, starts, pos_flat, ti_flat, x_flat = _occ_columns(occ)
    t_rep = toks[ti_flat]
    if len(t_rep):
        w_flat = weight(t_rep, x_flat)
        k_flat, _y, a_flat = icws.hash_parts(t_rep, w_flat)
    else:
        k_flat = np.empty(0, np.int64)
        a_flat = np.empty(0, np.float64)
    ident = np.stack([t_rep, k_flat], axis=1) if len(t_rep) else \
        np.empty((0, 2), np.int64)
    return _expand_key_columns(n, fs, starts, pos_flat, ti_flat, x_flat,
                               a_flat, ident, active)
