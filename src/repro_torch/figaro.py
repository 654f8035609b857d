"""`repro_torch.figaro` — the public façade of the port.

Re-exports the port's counterpart of the JAX package's `repro.figaro`:
``figaro.Session``, ``sess.ingest(...).join(...)`` → `JoinDataset`, its
`PlanHolder`, `FigaroEngine`, `PCAResult` and the async serving surface
(`AsyncFigaroServer`, `FigaroFuture`, `SERVE_KINDS`). See `repro_torch.api`.

Not to be confused with `repro_torch.core.figaro`, Algorithm 2 itself.
"""

from repro_torch.api import (JoinDataset, Session, TableSet,  # noqa: F401
                             default_session)
from repro_torch.core.engine import FigaroEngine, PCAResult  # noqa: F401
from repro_torch.core.plan_cache import PlanHolder  # noqa: F401
from repro_torch.train.async_serve import (AsyncFigaroServer,  # noqa: F401
                                           FigaroFuture, SERVE_KINDS)

__all__ = ["Session", "TableSet", "JoinDataset", "default_session",
           "FigaroEngine", "PCAResult", "PlanHolder", "AsyncFigaroServer",
           "FigaroFuture", "SERVE_KINDS"]
