"""The rule that nothing the benchmark runs loads JAX or the JAX package.

Modules are compared by their whole top-level name (the part before the
first dot): ``pytorch_operator_tpu_torch``, the port, begins with
``pytorch_operator_tpu``, the JAX package, and is not it.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "pytorch_operator_tpu")


def forbidden(modules=None) -> list[str]:
    """The loaded modules whose top-level name is a forbidden one."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
