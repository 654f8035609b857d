"""stage.h2d_share: host-to-device copy time in the traced window (the
staging copies of `core.engine.stage`) as a share of the device's busy time
there, in %. Copies that run beside kernels count in full."""

from figbench import trace


def read(rec):
    events = trace.in_window(rec.device_events, *rec.window)
    busy = trace.busy_ns(events)
    h2d = sum(e - s for name, s, e in events if "HtoD" in name)
    if not busy or not h2d:
        return None
    return 100.0 * h2d / busy
