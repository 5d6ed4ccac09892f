"""Mean host time for episode_step to return, over the window's cycles
(host clock around the benchmark's own calls)."""


def read(rec):
    e = rec["enqueue_s"]
    return 1e3 * sum(e) / len(e) if e else None
