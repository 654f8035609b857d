"""node_fused_roofline: the node pass's share of its roofline, in %.

Work: the node passes of every request answered in the traced window, as
`figbench.roofline.node_pass_work` counts them (each data leaf read once,
each slab of R₀ written once, at live sizes). Time: the device time of the
kernels the node pass launches, matched by name: the single-pass scan in its
node-pass mode and its preparation kernel."""

import re

from figbench import roofline, trace

KERNELS = re.compile(r"segscan::seg_kernel<\w+, 0>|nf_prep")


def read(rec):
    events = trace.in_window(rec.device_events, *rec.window)
    spent = sum(e - s for name, s, e in events if KERNELS.search(name))
    if not spent or not rec.requests:
        return None
    least = rec.requests * roofline.least_seconds(rec.work["node_pass"],
                                                  rec.dtype)
    return 100.0 * least / (spent / 1e9)
