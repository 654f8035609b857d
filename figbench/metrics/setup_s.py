"""setup_s: seconds from the start of the process to the first timed
request: imports, the tables drawn from the seed, ingest and join, the plan,
the request pool, and the warm-up that captures every shape the window uses
(host clock)."""


def read(rec):
    return rec.setup_s
