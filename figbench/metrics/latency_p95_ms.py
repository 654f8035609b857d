"""latency_p95_ms: the 95th percentile, linearly interpolated, of the
latency of every request answered within the window: from its submit (or
call) to its answer being ready on the card, as a resolved future or after
a synchronize (host clock)."""

import numpy as np


def read(rec):
    if not rec.latencies_ms:
        return None
    return float(np.percentile(np.asarray(rec.latencies_ms), 95))
