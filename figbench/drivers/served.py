"""Closed-loop clients of ``JoinDataset.serve`` (`AsyncFigaroServer`).

The traffic file names the served ``kind``, the server's ``max_batch`` and
``queue_depth``, the number of ``clients`` and of distinct
``feature_sets``. Set-up draws the feature sets from the seed: new values
for every relation at its live size, float32 numpy arrays on the host, so
each request goes through the server's staging copy. Each client submits a
request, waits for its future, and submits the next; requests take the
feature sets in turn, round robin over all clients.

The warm-up dispatches every batch bucket the window can form (1, 2, 4, ...
up to ``max_batch``) three times: eagerly, then captured, then replayed.
"""

from __future__ import annotations

import threading
import time

from figbench.data import feature_sets, reduce


class Driver:
    def __init__(self, ctx):
        t = ctx.traffic
        self.ctx = ctx
        self.kind = t["kind"]
        values = ctx.config["values"]
        # a leaf has its reduced table's shape; row i of it goes with row i
        # of the prepared table, which the reference makes after the window
        self.pool = feature_sets(reduce(ctx.config, ctx.drawn), ctx.order,
                                 t["feature_sets"], ctx.seed, values["low"],
                                 values["high"])
        self.server = ctx.ds.serve(kind=self.kind, max_batch=t["max_batch"],
                                   queue_depth=t["queue_depth"],
                                   dtype=ctx.dtype)
        self.clients = t["clients"]
        self.max_batch = t["max_batch"]

    def value_sets(self, tables) -> list:
        """The values of each feature set, by relation, for the reference."""
        return [dict(zip(self.ctx.order, leaves)) for leaves in self.pool]

    def warm(self) -> dict:
        """Every batch bucket three times; the launches of one dispatch."""
        buckets, b = [], 1
        while b < self.max_batch:
            buckets.append(b)
            b *= 2
        buckets.append(b)
        per = {}
        for b in buckets:
            for _ in range(3):
                before = self.ctx.launches()
                self.server.pause()
                futures = [self.server.submit(self.pool[j % len(self.pool)])
                           for j in range(b)]
                self.server.resume()
                for f in futures:
                    f.result(timeout=900)
                after = self.ctx.launches()
            if b == 1:
                per = {k: v - before.get(k, 0) for k, v in after.items()
                       if v != before.get(k, 0)}
        return per

    def run(self, seconds: float, grace: float) -> tuple:
        """The closed loop for ``seconds``: each request's record, and the
        perf_counter ns at which the window opened."""
        records, spans = [], self.ctx.spans
        lock = threading.Lock()
        issued = [0]
        start = time.perf_counter_ns()
        stop = start + int(seconds * 1e9)
        late = stop + int(grace * 1e9)

        def client():
            while time.perf_counter_ns() < stop:
                with lock:
                    i = issued[0]
                    issued[0] += 1
                key = i % len(self.pool)
                t0 = time.perf_counter_ns()
                answer = error = None
                try:
                    future = self.server.submit(self.pool[key])
                except Exception as e:  # a refused request is a failure
                    future, error = None, e
                t1 = time.perf_counter_ns()
                spans.append(("client.submit", t0, t1))
                if future is not None:
                    try:
                        answer = future.result(
                            timeout=max(late - t1, 0) / 1e9)
                    except Exception as e:
                        error = e
                t2 = time.perf_counter_ns()
                spans.append(("client.wait", t1, t2))
                records.append({"kind": self.kind, "key": key, "t0": t0,
                                "t1": t2, "answer": answer, "error": error})
                spans.append(("client.result", t2, time.perf_counter_ns()))

        threads = [threading.Thread(target=client, name=f"client{c}")
                   for c in range(self.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=seconds + 2 * grace)
        if any(t.is_alive() for t in threads):
            raise RuntimeError("a client did not finish")
        return records, start

    def close(self) -> None:
        self.server.close()
