"""Versioned on-disk format for frozen indexes (store format v1).

Carried over from ``repro/core/store.py``, flat layout only.  It reads and
writes format v1 byte for byte, so a store written by either package loads
in the other::

    index_dir/
      manifest.json           format/version, scheme spec, method, doc map,
                              text lengths, per-table kinds, arena meta,
                              per-array CRC32s
      table_00.keys.npy       uint64 sorted packed hash identities
      table_00.offsets.npy    int64 CSR row pointers
      table_00.windows.npy    int32 (nwin, 5) compact-window rows
      ...                     one triple per sketch coordinate
      arena.keys.npy          fused probe arena: keys, coordinate tags,
      arena.coords.npy        global CSR offsets and the slot-regrouped
      arena.offsets.npy       windows matrix
      arena.windows.npy

Writes are crash-safe by ordering: any previous manifest is unlinked
first, the arrays are written next and the manifest last (tmp file,
fsync, rename), so a directory without a readable manifest is an aborted
write, never a torn index.  A ``CURRENT`` generation pointer written by
the reference's live store is followed on read (:func:`resolve_store`).

A CRC mismatch raises ``ValueError`` on load.  Quarantine and fallback to
an older generation are not ported.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from zlib import crc32

import numpy as np

from .frozen import FrozenTable, ProbeArena
from .schemes import scheme_from_spec, scheme_spec

FORMAT = "mono-index"
FORMAT_VERSION = 1
CURRENT_POINTER = "CURRENT"

_ARRAYS = ("keys", "offsets", "windows")
_DTYPES = {"keys": np.uint64, "offsets": np.int64, "windows": np.int32}
_ARENA_ARRAYS = ("keys", "coords", "offsets", "windows")
_ARENA_DTYPES = {"keys": np.uint64, "coords": np.uint16,
                 "offsets": np.int64, "windows": np.int32}


def _table_path(root: Path, i: int, name: str) -> Path:
    return root / f"table_{i:02d}.{name}.npy"


def _arena_path(root: Path, name: str) -> Path:
    return root / f"arena.{name}.npy"


def _commit_text(path: Path, text: str) -> None:
    """Atomically publish ``text`` at ``path``: tmp write, fsync, rename."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(text.encode("utf-8"))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def resolve_store(root) -> Path:
    """Follow a ``CURRENT`` generation pointer to the serving directory;
    a flat store (no pointer) resolves to itself.  A pointer naming a
    version without a manifest is rejected."""
    root = Path(root)
    try:
        name = (root / CURRENT_POINTER).read_text().strip() or None
    except FileNotFoundError:
        name = None
    if name is None:
        return root
    target = root / name
    if not (target / "manifest.json").exists():
        raise ValueError(
            f"{root}: {CURRENT_POINTER} names generation {name!r} but that "
            "version has no manifest")
    return target


def _checksum_record(arr) -> dict:
    """CRC32 + shape/dtype fingerprint of one array."""
    a = np.ascontiguousarray(arr)
    return {"algo": "crc32",
            "crc": int(crc32(a.reshape(-1).view(np.uint8)) & 0xFFFFFFFF),
            "dtype": str(a.dtype), "shape": list(a.shape)}


class IndexWriter:
    """Streaming store writer: tables land on disk as they are finalized
    (``add_table``), then the arena (``add_arena``), then the manifest
    (``finalize``)."""

    def __init__(self, path, *, scheme=None, method: str = "mono_active"):
        self.root = Path(path)
        self.root.mkdir(parents=True, exist_ok=True)
        # invalidate any previous commit before touching its arrays: a
        # crash mid-rewrite must leave "no manifest" (aborted write).  The
        # port has no fault-injection layer yet, so this is a plain unlink.
        (self.root / "manifest.json").unlink(missing_ok=True)  # repro: allow[RPR203]
        self._scheme = scheme
        self._method = method
        self._tables: list[dict] = []
        self._arena: dict | None = None
        self._checksums: dict[str, dict] = {}

    def _save_array(self, path: Path, arr) -> None:
        np.save(path, arr)
        self._checksums[path.name] = _checksum_record(arr)

    def add_table(self, i: int, table) -> None:
        if i != len(self._tables):
            raise ValueError(f"tables must be added in coordinate order: "
                             f"got table {i}, expected {len(self._tables)}")
        for name in _ARRAYS:
            self._save_array(_table_path(self.root, i, name),
                             getattr(table, name))
        self._tables.append({"kind": table.kind,
                             "kint_min": int(table.kint_min)})

    def add_arena(self, arena) -> None:
        for name in _ARENA_ARRAYS:
            self._save_array(_arena_path(self.root, name),
                             getattr(arena, name))
        self._arena = {"mode": arena.mode, "max_run": int(arena.max_run)}

    def finalize(self, *, num_texts: int, num_windows: int,
                 text_lengths) -> None:
        manifest = {
            "format": FORMAT,
            "format_version": FORMAT_VERSION,
            "scheme": (scheme_spec(self._scheme)
                       if self._scheme is not None else None),
            "method": self._method,
            "num_texts": int(num_texts),
            "num_windows": int(num_windows),
            "text_lengths": [int(n) for n in text_lengths],
            "doc_map": None,
            "tables": self._tables,
            "arena": self._arena,
            "checksums": self._checksums,
        }
        _commit_text(self.root / "manifest.json", json.dumps(manifest))


def read_manifest(path) -> dict:
    """Read and validate a store directory's manifest."""
    root = resolve_store(path)
    mpath = root / "manifest.json"
    if not mpath.exists():
        raise FileNotFoundError(f"{root} is not an index store "
                                "(no manifest.json)")
    manifest = json.loads(mpath.read_text())
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{root}: not a {FORMAT} store "
                         f"(format={manifest.get('format')!r})")
    version = manifest.get("format_version")
    if version != FORMAT_VERSION:
        raise ValueError(
            f"{root}: unsupported index format version {version!r} "
            f"(this build reads version {FORMAT_VERSION})")
    return manifest


@dataclass
class VerifyReport:
    """Outcome of verifying one generation directory."""

    path: str
    committed: bool = False         # readable, valid manifest present
    arrays: int = 0                 # array files structurally checked
    checksummed: int = 0            # of those, verified against a CRC
    problems: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.committed and not self.problems


def verify_generation(path) -> VerifyReport:
    """Verify one store directory: manifest readable and valid, every
    required array file present, loadable, dtype-correct, and matching its
    recorded CRC32."""
    root = Path(path)
    rep = VerifyReport(path=str(root))
    try:
        manifest = read_manifest(root)
    except (OSError, ValueError) as e:
        rep.problems.append(f"manifest: {e}")
        return rep
    rep.committed = True
    checksums = manifest.get("checksums") or {}
    expected = {}
    for i in range(len(manifest.get("tables", []))):
        for name in _ARRAYS:
            expected[_table_path(root, i, name).name] = _DTYPES[name]
    if manifest.get("arena"):
        for name in _ARENA_ARRAYS:
            expected[_arena_path(root, name).name] = _ARENA_DTYPES[name]
    # table files are always required; arena files when checksummed
    required = [f for f in expected
                if f.startswith("table_") or f in checksums]
    for fname in required:
        fpath = root / fname
        if not fpath.exists():
            rep.problems.append(f"{fname}: missing")
            continue
        try:
            a = np.load(fpath, mmap_mode="r")
        except (OSError, ValueError) as e:
            rep.problems.append(f"{fname}: unreadable ({e})")
            continue
        rep.arrays += 1
        if a.dtype != expected[fname]:
            rep.problems.append(f"{fname}: dtype {a.dtype}, expected "
                                f"{np.dtype(expected[fname])}")
            continue
        rec = checksums.get(fname)
        if rec is None:
            continue
        got = _checksum_record(a)
        if list(a.shape) != list(rec.get("shape", [])) or \
                got["crc"] != rec.get("crc"):
            rep.problems.append(
                f"{fname}: checksum mismatch (crc {got['crc']} != "
                f"recorded {rec.get('crc')})")
        else:
            rep.checksummed += 1
    for fname in checksums:
        if fname not in required and not (root / fname).exists():
            rep.problems.append(f"{fname}: checksummed file missing")
    return rep


def load_index(path, *, mmap: bool = True, scheme=None, verify: bool = True):
    """Load a store directory back into a ``SearchIndex``.

    ``mmap=True`` maps every array read-only (``np.load(mmap_mode="r")``).
    ``verify=True`` checks every array against its recorded CRC32 first
    and raises ``ValueError`` on any problem; builders re-loading a store
    they just wrote pass ``verify=False``.
    """
    from .search import SearchIndex
    root = resolve_store(path)
    if verify:
        rep = verify_generation(root)
        if not rep.ok:
            raise ValueError(f"{root}: store fails verification: "
                             f"{rep.problems}")
    manifest = read_manifest(root)
    if scheme is None:
        if manifest["scheme"] is None:
            raise ValueError(f"{root}: manifest carries no scheme spec; "
                             "pass scheme= explicitly")
        scheme = scheme_from_spec(manifest["scheme"])
    mode = "r" if mmap else None
    tables = []
    for i, tmeta in enumerate(manifest["tables"]):
        arrays = {}
        for name in _ARRAYS:
            a = np.load(_table_path(root, i, name), mmap_mode=mode)
            if a.dtype != _DTYPES[name]:
                raise ValueError(f"{root}: table {i} {name} has dtype "
                                 f"{a.dtype}, expected {_DTYPES[name]}")
            arrays[name] = a
        tables.append(FrozenTable(kind=tmeta["kind"],
                                  kint_min=int(tmeta["kint_min"]), **arrays))
    return SearchIndex(scheme=scheme, method=manifest["method"],
                       tables=tables, num_texts=manifest["num_texts"],
                       num_windows=manifest["num_windows"],
                       text_lengths=list(manifest["text_lengths"]),
                       _arena=_load_arena(root, manifest, tables, mode))


def _load_arena(root: Path, manifest: dict, tables: list[FrozenTable],
                mmap_mode):
    """Map the persisted probe arena back; ``None`` (lazy rebuild from the
    tables) for stores without arena files."""
    ameta = manifest.get("arena")
    if not ameta:
        return None
    arrays = {}
    for name in _ARENA_ARRAYS:
        path = _arena_path(root, name)
        if not path.exists():
            return None
        a = np.load(path, mmap_mode=mmap_mode)
        if a.dtype != _ARENA_DTYPES[name]:
            raise ValueError(f"{root}: arena {name} has dtype {a.dtype}, "
                             f"expected {_ARENA_DTYPES[name]}")
        arrays[name] = a
    return ProbeArena(mode=ameta["mode"], max_run=int(ameta["max_run"]),
                      kinds=[t.kind for t in tables],
                      kint_mins=np.array([t.kint_min for t in tables],
                                         np.int64),
                      **arrays)
