"""Execution plans: where each stage of a batched query runs.

Carried over from ``repro/core/plan.py``:

* ``"device"`` — the default.  The arena stays resident on the card
  (:mod:`repro_torch.core.device_plan`), the probe and the small-group
  sweep run as hand-written CUDA kernels, and only final block extents
  return to host.  Sketching stays on the exact host path by default, so
  the plan is bit-identical to ``"cpu"`` by construction.
* ``"cpu"``    — the NumPy reference path (exact host sketch, one host
  ``searchsorted`` over the fused arena, vectorized grouped sweep).
* ``"auto"``   — ``"device"`` when CUDA is available, else ``"cpu"``.

Both plans take the pin ``sketch_backend="pallas"``, as the reference's
registry does: the reference's wire name for the on-device f32 ICWS
sketch, which in the port is the hand-written CUDA kernel
:func:`repro_torch.kernels.icws_hash.icws_sketch_batch` (it runs on the
``Aligner``'s device under either plan).  Every other stage runs exactly
one backend per plan; pinning a value a plan cannot execute is a
``TypeError``, never a silent fallback.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ExecutionPlan", "resolve_plan", "plan_names",
           "device_preferred"]

#: the QueryOptions stage fields a plan resolves
STAGE_FIELDS = ("sketch_backend", "probe_backend", "sweep")


@dataclass(frozen=True)
class ExecutionPlan:
    """A fully resolved pipeline: concrete backend per stage."""

    name: str
    sketch_backend: str
    probe_backend: str
    sweep: str

    @property
    def fused(self) -> bool:
        """True when probe and sweep both run on the device (the fused
        pipeline: device gather, no per-stage host round-trip)."""
        return self.probe_backend == "device" and self.sweep == "device"


#: plan -> stage -> (default, *other values the plan can execute)
_PLANS = {
    "cpu": {"sketch_backend": ("exact", "pallas"),
            "probe_backend": ("numpy",), "sweep": ("grouped",)},
    "device": {"sketch_backend": ("exact", "pallas"),
               "probe_backend": ("device",), "sweep": ("device",)},
}


def plan_names() -> list[str]:
    return sorted(_PLANS) + ["auto"]


def device_preferred() -> bool:
    """Capability check for ``plan="auto"``: is a CUDA device present?"""
    import torch
    return torch.cuda.is_available()


def resolve_plan(options=None) -> ExecutionPlan:
    """Resolve options (or a bare plan name) into an :class:`ExecutionPlan`,
    once per batch.  ``None`` means the default plan, ``"device"``."""
    if options is None:
        name, pins = "device", {}
    elif isinstance(options, str):
        name, pins = options, {}
    else:
        name = options.plan
        pins = {f: getattr(options, f) for f in STAGE_FIELDS
                if getattr(options, f) is not None}
    if name == "auto":
        name = "device" if device_preferred() else "cpu"
    choices = _PLANS.get(name)
    if choices is None:
        raise ValueError(f"unknown execution plan {name!r}; "
                         f"registered plans: {plan_names()}")
    stages = {f: vals[0] for f, vals in choices.items()}
    for f, v in pins.items():
        if v not in choices[f]:
            raise TypeError(
                f"plan {name!r} cannot execute {f}={v!r} (valid pins: "
                f"{sorted(choices[f])}); pinning a stage beyond what the "
                "plan supports is an error, not a fallback")
        stages[f] = v
    return ExecutionPlan(name=name, **stages)
