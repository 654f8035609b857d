"""setup.join_s: host seconds of ``Session.ingest(tables).join(edges,
root=...)``: ingest, the full reduction and the join tree (host clock, in
the benchmark's own files, around the call)."""


def read(rec):
    return rec.setup.get("join_s")
