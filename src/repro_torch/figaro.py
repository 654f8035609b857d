"""`repro_torch.figaro` — the public façade of the port.

Re-exports the port's counterpart of the JAX package's `repro.figaro`:
``figaro.Session``, ``sess.ingest(...).join(...)`` → `JoinDataset`, its
`PlanHolder`, `FigaroEngine` and `PCAResult`. See `repro_torch.api`. The
async serving surface (`AsyncFigaroServer`, `FigaroFuture`) is still to be
ported; `SERVE_KINDS` is here already.

Not to be confused with `repro_torch.core.figaro`, Algorithm 2 itself.
"""

from repro_torch.api import (JoinDataset, Session, TableSet,  # noqa: F401
                             default_session)
from repro_torch.core.engine import FigaroEngine, PCAResult  # noqa: F401
from repro_torch.core.plan_cache import PlanHolder  # noqa: F401
from repro_torch.train.async_serve import SERVE_KINDS  # noqa: F401

__all__ = ["Session", "TableSet", "JoinDataset", "default_session",
           "FigaroEngine", "PCAResult", "PlanHolder", "SERVE_KINDS"]
