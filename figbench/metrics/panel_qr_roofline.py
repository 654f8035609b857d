"""panel_qr_roofline: the postprocess's share of its roofline, in %.

Work: R₀ → R of every request answered in the traced window, as
`figbench.roofline.panel_work` counts it (R₀'s live rows read once, R
written once, 2MN² − 2N³/3 operations). Time: for each dispatch, from the
start of its first panel kernel to the end of its last one, everything
between included (the WY updates, copies and gaps); a dispatch starts at its
first node-pass kernel. The few elementwise kernels after the top level's
last panel (triu, the sign normalization) and the N×N tails are outside."""

import re

from figbench import roofline, trace

PANEL = re.compile(r"panel_qr_(reg|grid)_kernel<")
NODE_PASS = re.compile(r"segscan::seg_kernel<\w+, 0>")


def read(rec):
    events = sorted(trace.in_window(rec.device_events, *rec.window),
                    key=lambda ev: ev[1])
    spent, first, last = 0, None, None
    for name, s, e in events:
        if NODE_PASS.search(name) and first is not None:
            spent += last - first
            first = last = None
        elif PANEL.search(name):
            first = s if first is None else first
            last = e if last is None else max(last, e)
    if first is not None:
        spent += last - first
    if not spent or not rec.requests:
        return None
    least = rec.requests * roofline.least_seconds(rec.work["panel"],
                                                  rec.dtype)
    return 100.0 * least / (spent / 1e9)
