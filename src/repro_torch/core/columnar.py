"""Columnar build pipeline: partition -> CSR without dict tables.

Carried over from ``repro/core/columnar.py`` (host NumPy), trimmed to
``build`` / ``freeze`` / ``freeze_to_store``.  Per text it runs the
vectorized columnar key generation, partitions, and appends the
``Partition``'s ``(key, tid, a, b, c, d)`` columns into chunked per-table
buffers; ``freeze`` turns each table's buffers into a ``FrozenTable`` with
one global stable sort and builds the fused ``ProbeArena`` straight from
the same columns.  ``freeze_to_store`` streams each table into a store
directory as it is finalized.  The partition methods live here
(``_METHODS``) so that the dict builder stays out of this package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

import numpy as np

from .frozen import (KIND_EMPTY, KIND_INT, KIND_PAIR, FrozenTable,
                     ProbeArena, pack_ident_columns)
from .keys import occurrence_lists
from .partition import monotonic_partition
from .search import SearchIndex

#: method -> (partitioner, active-keys only)
_METHODS = {
    "mono_all": (monotonic_partition, False),
    "mono_active": (monotonic_partition, True),
}


@dataclass
class _TableColumns:
    """Chunked append buffers for one inverted table's window columns."""

    kind: str = KIND_EMPTY
    idents: list = field(default_factory=list)   # per-text identity chunks
    windows: list = field(default_factory=list)  # per-text int32 (n, 5)

    def append(self, ident: np.ndarray, windows: np.ndarray) -> None:
        if self.kind == KIND_EMPTY:
            self.kind = KIND_PAIR if ident.ndim == 2 else KIND_INT
        self.idents.append(ident)
        self.windows.append(windows)

    def packed(self) -> tuple[np.ndarray, np.ndarray, int]:
        """(packed u64 keys, windows, kint_min) in append order."""
        if not self.windows:
            return np.empty(0, np.uint64), np.empty((0, 5), np.int32), 0
        ident, windows = np.concatenate(self.idents), \
            np.concatenate(self.windows)
        packed, kint_min = pack_ident_columns(self.kind, ident)
        return packed, windows, kint_min

    def clear(self) -> None:
        self.idents, self.windows = [], []


@dataclass
class ColumnarBuilder:
    """Batch build-side index: chunked window columns, one-sort freeze."""

    scheme: object
    method: str = "mono_active"
    num_texts: int = 0
    num_windows: int = 0
    text_lengths: list[int] = field(default_factory=list)
    _cols: list[_TableColumns] = field(default_factory=list)

    def __post_init__(self):
        if self.method == "allalign":
            raise NotImplementedError(
                'method="allalign" is not ported yet; use "mono_active" '
                'or "mono_all"')
        if self.method not in _METHODS:
            raise ValueError(f"unknown partition method {self.method!r}; "
                             f"expected one of {sorted(_METHODS)}")
        if not self._cols:
            self._cols = [_TableColumns() for _ in range(self.scheme.k)]

    def add_text(self, tokens) -> int:
        """Partition one text under all k hash functions and append its
        window columns (no per-window Python loop)."""
        tokens = np.asarray(tokens, dtype=np.int64)
        tid = self.num_texts
        self.num_texts += 1
        self.text_lengths.append(len(tokens))
        partition_fn, active = _METHODS[self.method]
        occ = occurrence_lists(tokens)
        for i in range(self.scheme.k):
            keys = self.scheme.key_columns(tokens, i, active, occ=occ)
            part = partition_fn(keys)
            nw = len(part)
            self.num_windows += nw
            if nw == 0:
                continue
            win = np.empty((nw, 5), np.int32)
            win[:, 0] = tid
            win[:, 1] = part.a
            win[:, 2] = part.b
            win[:, 3] = part.c
            win[:, 4] = part.d
            self._cols[i].append(keys.gid_ident[part.gid], win)
        return tid

    def build(self, texts: Iterable) -> "ColumnarBuilder":
        for tokens in texts:
            self.add_text(tokens)
        return self

    def _frozen_columns(self):
        """Per coordinate: (kind, FrozenTable, packed keys, windows,
        kint_min), releasing each table's buffers once consumed."""
        for col in self._cols:
            packed, windows, kint_min = col.packed()
            kind = col.kind if len(windows) else KIND_EMPTY
            table = FrozenTable.from_packed_columns(kind, packed, windows,
                                                    kint_min)
            col.clear()
            yield kind, table, packed, windows, kint_min

    def freeze(self) -> SearchIndex:
        """Compact the window columns into an immutable ``SearchIndex``
        with its fused probe arena built from the same columns."""
        tables, kinds, packed_cols, win_cols, kint_mins = [], [], [], [], []
        for kind, table, packed, windows, kint_min in self._frozen_columns():
            tables.append(table)
            kinds.append(kind)
            packed_cols.append(packed)
            win_cols.append(windows)
            kint_mins.append(kint_min)
        idx = SearchIndex(
            scheme=self.scheme, method=self.method, tables=tables,
            num_texts=self.num_texts, num_windows=self.num_windows,
            text_lengths=list(self.text_lengths))
        idx._arena = ProbeArena.from_window_columns(
            kinds, packed_cols, win_cols, np.array(kint_mins, np.int64))
        return idx

    def freeze_to_store(self, path, *, mmap: bool = True) -> SearchIndex:
        """Freeze straight into a store directory, streaming: each table's
        ``.npy`` files are written as soon as it is finalized, then the
        arena, then the manifest; the finished store is loaded back as
        the returned serving ``SearchIndex``."""
        from .store import IndexWriter, load_index
        writer = IndexWriter(path, scheme=self.scheme, method=self.method)
        kinds, packed_cols, win_cols, kint_mins = [], [], [], []
        for i, (kind, table, packed, windows, kint_min) in enumerate(
                self._frozen_columns()):
            writer.add_table(i, table)
            kinds.append(kind)
            packed_cols.append(packed)
            win_cols.append(windows)
            kint_mins.append(kint_min)
        writer.add_arena(ProbeArena.from_window_columns(
            kinds, packed_cols, win_cols, np.array(kint_mins, np.int64)))
        del packed_cols, win_cols
        writer.finalize(num_texts=self.num_texts,
                        num_windows=self.num_windows,
                        text_lengths=self.text_lengths)
        # just-written store: skip the load-time checksum verification
        return load_index(path, mmap=mmap, scheme=self.scheme, verify=False)
