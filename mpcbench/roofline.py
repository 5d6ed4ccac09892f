"""Roofline arithmetic: the candidate QP's shapes that the kernel counts
(counts/<kernel>.py) are taken from, and the bound of a count.

Decision variables n = 8 H + 5 W (W = H - 1); rows m = 16 H + 5 W + W K
(dynamics equalities, state bounds, control bounds, K obstacle slots per
step); structural nonzeros of A: the first equality row block 8, each
later one 8 (-x_i) + 9 (A) + 8 (B), the bound rows one each, and every
obstacle row 3 (its gradient on p_w) + 1 (its slack).
"""


def qp_shapes(cfg: dict) -> dict:
    H = cfg["planner"]["horizon"]
    W = H - 1
    K = cfg["planner"]["max_obstacles"] + 1
    n = 8 * H + 5 * W
    m = 16 * H + 5 * W + W * K
    nnz = 8 + 25 * W + 8 * H + 5 * W + 4 * W * K
    return dict(H=H, W=W, K=K, n=n, m=m, nnz=nnz)


def bound_seconds(flops: float, nbytes: float, peaks: dict) -> dict:
    tf = flops / peaks["fp32_flops_per_s"]
    tb = nbytes / peaks["hbm_bytes_per_s"]
    return dict(flops=flops, bytes=nbytes, seconds=max(tf, tb),
                bound_by="operations" if tf >= tb else "bytes")
