"""One launch of csrc/ew_chain.cu: the elementwise tail of one ADMM
iteration of every candidate QP (x blend, z relaxation and projection,
dual update, next rho z - y). Per QP it needs x and x~ (n each) and z,
y, A x~, rho, l, u (m each) read once, and x, z, y, rho z - y written
once, all float32; about 3 operations per variable and 10 per row."""

from mpcbench.roofline import bound_seconds, qp_shapes


def bound(cfg: dict, scenarios: int, candidates: int, peaks: dict) -> dict:
    s = qp_shapes(cfg)
    qps = scenarios * candidates
    n, m = s["n"], s["m"]
    return bound_seconds(qps * (3 * n + 10 * m), qps * 4 * (3 * n + 9 * m), peaks)
