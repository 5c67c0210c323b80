"""What a run may not load: JAX, or the JAX package the port was made
from. Modules are compared by their top-level name as a whole, so
``doda_tpu_torch`` is not ``doda_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({'jax', 'jaxlib', 'flax', 'doda_tpu'})


def forbidden_loaded(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split('.')[0] for m in names} & FORBIDDEN)
