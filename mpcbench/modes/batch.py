"""Closed batch: cycles enqueued back to back with no host fetch; the
window ends in torch.cuda.synchronize(). End-to-end metric: solves_per_s,
the candidate-QP solves S x C x cycles over the window's seconds, C the
configuration's num_intent_candidates (the arithmetic of
intent_mpc_torch/benchmark/bench.run)."""

from __future__ import annotations

import time


def cycle(flights):
    """One cycle as this traffic sends it: enqueued, nothing fetched."""
    return flights.step()


def window(flights, seconds: float, traffic: dict, cycles=None) -> dict:
    """`seconds` of cycles, or exactly `cycles` cycles where given."""
    start = flights.mark()
    flights.sync()
    enq = []
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        cycle(flights)
        b = time.perf_counter()
        enq.append(b - a)
        if (len(enq) == cycles) if cycles else (b - t0 >= seconds):
            break
    flights.sync()
    elapsed = time.perf_counter() - t0
    attempted, failed = flights.counters(start)
    candidates = flights.cfg.planner.num_intent_candidates
    solves = traffic["scenarios"] * candidates * len(enq)
    return dict(metrics={"solves_per_s": solves / elapsed}, cycles=len(enq),
                enqueue_s=enq, elapsed_s=elapsed, attempted=attempted,
                failed=failed)
