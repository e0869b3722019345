"""No JAX in a run: the check made once the window has closed."""
from __future__ import annotations

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
