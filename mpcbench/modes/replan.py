"""One closed-loop client, blocking: cycle i is enqueued, its command
(every scenario's position and velocity, one (S, 6) tensor) is fetched
to the host, then cycle i + 1 is enqueued (the blocking pattern of
intent_mpc_torch/benchmark/bench.blocking_cycles). End-to-end metrics:
the median and the 95th percentile, over every cycle of the window, of
the time from the start of a cycle's enqueue to the host holding its
command."""

from __future__ import annotations

import time

import numpy as np
import torch


def fetch(carry):
    """The command the client waits for: every scenario's position and
    velocity on the host."""
    return torch.cat([carry.pos, carry.vel], dim=-1).cpu()


def cycle(flights):
    """One cycle as this client sends it: enqueued, its command fetched."""
    return fetch(flights.step())


def window(flights, seconds: float, traffic: dict, cycles=None) -> dict:
    """`seconds` of cycles, or exactly `cycles` cycles where given."""
    start = flights.mark()
    flights.sync()
    lat, enq = [], []
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        carry = flights.step()
        b = time.perf_counter()
        fetch(carry)
        c = time.perf_counter()
        lat.append(c - a)
        enq.append(b - a)
        if (len(lat) == cycles) if cycles else (c - t0 >= seconds):
            break
    elapsed = time.perf_counter() - t0
    attempted, failed = flights.counters(start)
    ms = np.asarray(lat) * 1e3
    return dict(metrics={"replan_p50_ms": float(np.percentile(ms, 50)),
                         "replan_p95_ms": float(np.percentile(ms, 95))},
                cycles=len(lat), enqueue_s=enq, elapsed_s=elapsed,
                attempted=attempted, failed=failed)
