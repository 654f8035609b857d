"""One closed-loop client calling a `JoinDataset` directly.

The traffic file lists the ``calls`` (``qr``, ``svd``, ``pca`` with its
``k``, ``lsq`` of the configuration's label column), made in turn, each on
the ingested tables, in the traffic's ``dtype``. Each call is followed by a
synchronize of the card, so it is timed from the call to its answer being
ready there. The warm-up makes every call three times: eagerly, then
captured, then replayed.
"""

from __future__ import annotations

import time

import torch


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.calls = ctx.traffic["calls"]

    def value_sets(self, tables) -> list:
        """The values the calls were made on: the tables' own."""
        return [{n: t.data for n, t in tables.items()}]

    def _call(self, call):
        ds, dtype = self.ctx.ds, self.ctx.dtype
        kind = call["kind"]
        if kind == "qr":
            return ds.qr(dtype=dtype)
        if kind == "svd":
            return ds.svd(dtype=dtype)
        if kind == "pca":
            return ds.pca(k=call["k"], dtype=dtype)
        if kind == "lsq":
            return ds.lsq(self.ctx.config["label"], dtype=dtype)
        raise ValueError(f"unknown call {kind!r}")

    def _sync(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def warm(self) -> dict:
        per = {}
        for call in self.calls:
            for _ in range(3):
                before = self.ctx.launches()
                self._call(call)
                self._sync()
                after = self.ctx.launches()
            per = {k: v - before.get(k, 0) for k, v in after.items()
                   if v != before.get(k, 0)}
        return per

    def run(self, seconds: float, grace: float) -> tuple:
        """The loop for ``seconds``: each call's record, and the
        perf_counter ns at which the window opened."""
        records, spans = [], self.ctx.spans
        start = time.perf_counter_ns()
        stop = start + int(seconds * 1e9)
        i = 0
        while time.perf_counter_ns() < stop:
            call = self.calls[i % len(self.calls)]
            i += 1
            t0 = time.perf_counter_ns()
            answer = error = None
            try:
                answer = self._call(call)
            except Exception as e:  # a call that raises is a failure
                error = e
            t1 = time.perf_counter_ns()
            spans.append(("client.submit", t0, t1))
            self._sync()
            t2 = time.perf_counter_ns()
            spans.append(("client.wait", t1, t2))
            records.append({"kind": call["kind"], "key": 0, "t0": t0,
                            "t1": t2, "answer": answer, "error": error,
                            "k": call.get("k")})
            spans.append(("client.result", t2, time.perf_counter_ns()))
        return records, start

    def close(self) -> None:
        pass
