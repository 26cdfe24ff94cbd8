"""QuantSpec, the one quantizer configuration of PTQ and KV-page freezing
(port of ``repro/core/spec.py``).

The compact string form round-trips as in the reference::

    kmeans_ls@16                    count method @ budget
    l1_ls:lam=0.02                  lam method : penalty
    kmeans_ls@16:weighted=true,seed=3,clip=-1.0..1.0

``QuantSpec.parse(str(spec)) == spec`` holds for every valid spec. The
spec validates against ``core.registry`` as the reference's does: a count
method needs ``num_values`` and rejects ``lam``; a lam method needs
``lam`` and rejects ``num_values``; ``lam2`` only where the method accepts
it. The port's registry holds only the methods it can run, so any other
method raises at construction, naming the methods the port has.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from . import registry


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Frozen, hashable quantizer configuration.

    method      a name in ``core.registry``.
    num_values  codebook budget (count methods).
    lam         l1 penalty (lam methods).
    lam2        negative-l2 strength, only for a method that accepts it.
    weighted    optimize the multiplicity-weighted loss.
    clip        optional (lo, hi) clamp on the codebook (eq. 21).
    seed        clustering seed (the device solver is deterministic and
                ignores it).
    """

    method: str
    num_values: int | None = None
    lam: float | None = None
    lam2: float | None = None
    weighted: bool = False
    clip: tuple[float, float] | None = None
    seed: int = 0

    def __post_init__(self) -> None:
        m = registry.get(self.method)
        _set = object.__setattr__
        if self.num_values is not None:
            _set(self, "num_values", int(self.num_values))
        for k in ("lam", "lam2"):
            if getattr(self, k) is not None:
                _set(self, k, float(getattr(self, k)))
        _set(self, "weighted", bool(self.weighted))
        _set(self, "seed", int(self.seed))
        if self.clip is not None:
            lo, hi = self.clip
            _set(self, "clip", (float(lo), float(hi)))
        if m.param_kind == "lam":
            if self.lam is None:
                raise ValueError(
                    f"method {self.method!r} is lam-parameterised: "
                    f"QuantSpec requires lam= (e.g. '{self.method}:lam=0.02')")
            if self.num_values is not None:
                raise ValueError(
                    f"num_values= is not valid for lam-parameterised method "
                    f"{self.method!r}; count-parameterised methods: "
                    f"{', '.join(registry.count_methods())}")
        else:
            if self.num_values is None:
                raise ValueError(
                    f"method {self.method!r} is count-parameterised: "
                    f"QuantSpec requires num_values= "
                    f"(e.g. '{self.method}@16')")
            if self.num_values < 1:
                raise ValueError(f"num_values must be >= 1, got "
                                 f"{self.num_values}")
            if self.lam is not None or self.lam2 is not None:
                raise ValueError(
                    f"lam=/lam2= are not valid for count-parameterised "
                    f"method {self.method!r}; lam-parameterised methods: "
                    f"{', '.join(registry.lam_methods())}")
        if self.lam2 is not None and not m.accepts_lam2:
            raise ValueError(f"lam2= is only valid for methods that accept "
                             f"it, not {self.method!r}")
        if self.lam is not None and self.lam < 0:
            raise ValueError(f"lam must be >= 0, got {self.lam}")

    @property
    def param_kind(self) -> str:
        return registry.get(self.method).param_kind

    @property
    def device_capable(self) -> bool:
        return registry.get(self.method).device_batch is not None

    def device_solve(self, rows):
        """Run this spec's batched device row solver."""
        return registry.get(self.method).device_batch(rows, self)

    def replace(self, **kw: Any) -> "QuantSpec":
        return dataclasses.replace(self, **kw)

    def __str__(self) -> str:
        head = self.method
        if self.num_values is not None:
            head += f"@{self.num_values}"
        opts: list[str] = []
        if self.lam is not None:
            opts.append(f"lam={self.lam!r}")
        if self.lam2 is not None:
            opts.append(f"lam2={self.lam2!r}")
        if self.weighted:
            opts.append("weighted=true")
        if self.clip is not None:
            opts.append(f"clip={float(self.clip[0])!r}.."
                        f"{float(self.clip[1])!r}")
        if self.seed != 0:
            opts.append(f"seed={self.seed}")
        return head + (":" + ",".join(opts) if opts else "")

    @classmethod
    def parse(cls, s: "str | QuantSpec") -> "QuantSpec":
        """Parse the compact string form (idempotent on QuantSpec input)."""
        if isinstance(s, QuantSpec):
            return s
        if not isinstance(s, str):
            raise TypeError(f"QuantSpec.parse wants a string or QuantSpec, "
                            f"got {type(s).__name__}")
        head, _, opts = s.strip().partition(":")
        method, _, budget = head.partition("@")
        if not method:
            raise ValueError(f"empty method in spec {s!r}")
        registry.get(method)        # an unknown method names the known ones
        kw: dict[str, Any] = {}
        if budget:
            try:
                kw["num_values"] = int(budget)
            except ValueError:
                raise ValueError(f"bad count budget {budget!r} in spec "
                                 f"{s!r} (want method@INT)") from None
        for item in filter(None, opts.split(",")):
            k, sep, v = item.partition("=")
            k = k.strip()
            if not sep or not k:
                raise ValueError(f"bad option {item!r} in spec {s!r} "
                                 f"(want key=value)")
            if k in ("lam", "lam2"):
                kw[k] = float(v)
            elif k in ("num_values", "seed"):
                kw[k] = int(v)
            elif k == "weighted":
                kw[k] = _parse_bool(v, s)
            elif k == "clip":
                lo, sep2, hi = v.partition("..")
                if not sep2:
                    raise ValueError(f"bad clip {v!r} in spec {s!r} "
                                     f"(want clip=LO..HI)")
                kw[k] = (float(lo), float(hi))
            else:
                raise ValueError(f"unknown spec option {k!r} in {s!r}; "
                                 f"one of lam, lam2, num_values, weighted, "
                                 f"clip, seed")
        return cls(method, **kw)


def _parse_bool(v: str, spec: str) -> bool:
    lv = v.strip().lower()
    if lv in ("1", "true", "yes", "on"):
        return True
    if lv in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"bad boolean {v!r} in spec {spec!r}")


def as_spec(spec: "str | QuantSpec", **replace_kw: Any) -> QuantSpec:
    """Coerce a QuantSpec | compact string to QuantSpec (with optional
    field overrides)."""
    out = QuantSpec.parse(spec)
    return out.replace(**replace_kw) if replace_kw else out
