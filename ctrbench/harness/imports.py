"""The whole-name import check: no process of a run may hold JAX or the
JAX package. Names are compared by their top-level part (before the first
dot) whole, so `distributed_tf_serving_tpu_torch`, the port, passes while
`distributed_tf_serving_tpu` fails."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "distributed_tf_serving_tpu"})


def forbidden_in(names) -> list[str]:
    """The forbidden top-level names among module names."""
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)


def forbidden_loaded() -> list[str]:
    """The forbidden top-level names this process has loaded."""
    return forbidden_in(list(sys.modules))
