"""serve.batch_mean: requests completed in the traced window per dispatch of
the `AsyncFigaroServer`. The dispatches are the window's growth of the
``node_fused`` launch counter (`kernels._platform.launch_counts`, which a
graph replay adds to) over what one dispatch adds, read at warm-up."""


def read(rec):
    per = rec.per_dispatch.get("node_fused")
    if not per or not rec.requests:
        return None
    grew = (rec.counters["after"]["launches"].get("node_fused", 0)
            - rec.counters["before"]["launches"].get("node_fused", 0))
    if grew <= 0:
        return None
    return rec.requests / (grew / per)
