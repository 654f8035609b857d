"""serve.latency_p95_ms: the served cell's tail, read in its traced window:
the 95th percentile, linearly interpolated, of the latency of every request
answered within the window, from its submit to its resolved future (host
clock). It counts the host's wake-ups on each answer (the server's
completion thread, then the client's), so on a shared host it swings more
than the rate does, and it stands here without a bound."""

import numpy as np


def read(rec):
    if not rec.latencies_ms:
        return None
    return float(np.percentile(np.asarray(rec.latencies_ms), 95))
