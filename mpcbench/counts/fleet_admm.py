"""One launch of csrc/fleet_admm.cu: every iteration of every candidate
QP of a cycle. Per iteration and QP the float32 work the solve needs is
A^T (rho z - y), the x-update Minv rhs with `refine` stationary steps
x += Minv (rhs - M x) (M x = (h + sigma) x + A^T rho A x), and A x~: so
(1 + refine) products with each of A and A^T (2 nnz operations each)
and (1 + refine) with the dense n x n inverse (2 n^2 each), and about 10
operations per row and 8 per variable per step for the rest. Bytes: the
scenario's inverse, scalings and the QPs' data read once, x and y
written once."""

from mpcbench.roofline import bound_seconds, qp_shapes


def bound(cfg: dict, scenarios: int, candidates: int, peaks: dict) -> dict:
    s = qp_shapes(cfg)
    sv = cfg["planner"]["solver"]
    it, ref = sv["max_iter"], sv["shared_refine_iters"]
    n, m, nnz, W, K = s["n"], s["m"], s["nnz"], s["W"], s["K"]
    qps = scenarios * candidates
    per_iter = (1 + ref) * (2 * 2 * nnz + 2 * n * n) + 10 * m + 8 * n * (1 + ref)
    flops = qps * it * per_iter
    per_scenario = n * n + 2 * n + m            # Minv, D, h + sigma, E
    per_qp = 2 * n + 3 * m + 5 * W * K          # q, warm x; l, u, rho; G, slack terms
    out = n + m                                  # x, y
    nbytes = 4 * (scenarios * per_scenario + qps * (per_qp + out))
    return bound_seconds(flops, nbytes, peaks)
