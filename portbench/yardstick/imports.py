"""The check that no run loads JAX or the JAX package.

Modules are compared by their top-level name (the part before the first
dot) as a whole: the port ``repro_torch`` begins with ``repro``, the JAX
package's name, and is not it."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: every
    module this process has loaded), sorted."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(tops.intersection(FORBIDDEN))
