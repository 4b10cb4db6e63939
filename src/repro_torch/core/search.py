"""Immutable serve-side index: frozen CSR tables plus the fused arena.

Carried over from ``repro/core/search.py`` (host NumPy).  ``state_dict`` /
``from_state`` speak the reference's array layout, so a reference
``SearchIndex.state_dict()`` loads here unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .frozen import FrozenTable, ProbeArena


@dataclass
class SearchIndex:
    """k immutable CSR inverted tables over a fixed collection."""

    scheme: object
    tables: list[FrozenTable]
    method: str = "mono_active"
    num_texts: int = 0
    num_windows: int = 0
    text_lengths: list[int] = field(default_factory=list)
    _arena: ProbeArena | None = field(default=None, repr=False, compare=False)
    # (host ProbeArena, torch.device, DeviceArena) cached by
    # repro_torch.core.device_plan.device_arena — keyed on the arena's
    # identity and the device, so residency lives and dies with this
    # (immutable) index instance
    _device_arena: tuple | None = field(default=None, repr=False,
                                        compare=False)

    def arena(self) -> ProbeArena:
        """The fused probe arena over all k tables.  Built lazily from the
        tables and cached; a store load restores the persisted arena
        instead (mmap-able)."""
        if self._arena is None:
            self._arena = ProbeArena.from_tables(self.tables)
        return self._arena

    def is_mmap(self) -> bool:
        """True when every non-empty table array is memory-mapped."""
        arrays = [a for t in self.tables
                  for a in (t.keys, t.offsets, t.windows) if a.size]
        return bool(arrays) and all(isinstance(a, np.memmap) for a in arrays)

    def state_dict(self) -> dict:
        return {"method": self.method, "num_texts": self.num_texts,
                "num_windows": self.num_windows,
                "text_lengths": list(self.text_lengths), "tables": [],
                "frozen": [t.state_dict() for t in self.tables]}

    @classmethod
    def from_state(cls, scheme, state: dict) -> "SearchIndex":
        return cls(scheme=scheme, method=state["method"],
                   tables=[FrozenTable.from_state(s)
                           for s in state["frozen"]],
                   num_texts=state["num_texts"],
                   num_windows=state["num_windows"],
                   text_lengths=list(state["text_lengths"]))
