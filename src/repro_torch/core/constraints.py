"""Storage-bandwidth constraint specifications (paper §3.2, §4.2.2-4.2.3).

A constraint is either:
  * static:   ``storageBW = 20``          (MB/s, fixed for the whole run)
  * bounded:  ``storageBW = "auto(2,256,2)"``  -> AutoSpec(min,max,delta)
  * unbounded:``storageBW = "auto"``           -> AutoSpec(unbounded)
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Union


@dataclass(frozen=True)
class StaticSpec:
    value: float

    def __post_init__(self):
        if self.value <= 0:
            raise ValueError(f"storageBW must be positive, got {self.value}")


@dataclass(frozen=True)
class AutoSpec:
    bounded: bool
    min: Optional[float] = None
    max: Optional[float] = None
    delta: Optional[float] = None

    def __post_init__(self):
        if self.bounded:
            if not (self.min and self.max and self.delta):
                raise ValueError("bounded auto constraint needs min, max, delta")
            if self.min <= 0 or self.max < self.min:
                raise ValueError(f"invalid bounds auto({self.min},{self.max},{self.delta})")
            if self.delta <= 1:
                raise ValueError("delta must be > 1 (multiplicative step)")


ConstraintSpec = Union[StaticSpec, AutoSpec]

_AUTO_RE = re.compile(
    r"^auto\(\s*([0-9.]+)\s*,\s*([0-9.]+)\s*,\s*([0-9.]+)\s*\)$")


def parse_storage_bw(value) -> ConstraintSpec:
    """Parse the ``storageBW`` argument of ``@constraint`` (paper Listings 3-5)."""
    if isinstance(value, (StaticSpec, AutoSpec)):
        return value
    if isinstance(value, (int, float)):
        return StaticSpec(float(value))
    if isinstance(value, str):
        s = value.strip()
        if s == "auto":
            return AutoSpec(bounded=False)
        m = _AUTO_RE.match(s)
        if m:
            lo, hi, delta = (float(g) for g in m.groups())
            return AutoSpec(bounded=True, min=lo, max=hi, delta=delta)
        try:
            return StaticSpec(float(s))
        except ValueError:
            pass
    raise ValueError(f"cannot parse storageBW constraint: {value!r}")


def is_auto(spec: Optional[ConstraintSpec]) -> bool:
    return isinstance(spec, AutoSpec)
