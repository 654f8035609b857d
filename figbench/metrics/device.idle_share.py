"""device.idle_share: the share of the traced window in which no activity
(kernel, copy or memset) ran on the card, 1 − busy / window, in %."""

from figbench import trace


def read(rec):
    w0, w1 = rec.window
    events = trace.in_window(rec.device_events, w0, w1)
    if not events or w1 <= w0:
        return None
    return 100.0 * (1.0 - trace.busy_ns(events) / (w1 - w0))
