"""engine.misses: signature misses and graph captures of the session's
`FigaroEngine` over the traced window, Δ(`trace_count()` + `capture_count()`).
Every shape the window uses is warmed up first, so a sound run reads 0."""


def read(rec):
    before, after = rec.counters["before"], rec.counters["after"]
    return float(after["traces"] + after["captures"]
                 - before["traces"] - before["captures"])
