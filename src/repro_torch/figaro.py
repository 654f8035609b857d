"""`repro_torch.figaro` — the public façade of the port.

Re-exports what the port has of the JAX package's `repro.figaro`:
`Session`, `default_session`, `FigaroEngine` and `PCAResult`. The dataset
and serving surfaces are still to be ported.

Not to be confused with `repro_torch.core.figaro`, Algorithm 2 itself.
"""

from repro_torch.api import Session, default_session  # noqa: F401
from repro_torch.core.engine import FigaroEngine, PCAResult  # noqa: F401

__all__ = ["Session", "default_session", "FigaroEngine", "PCAResult"]
