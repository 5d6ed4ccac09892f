"""Time-optimal path parameterization (TOPP) (port of
intent_mpc_tpu/models/time_optimizer.py), batched over a leading scenario
axis S.

Rebuild of time_optimizer/ (timeOptimizer.cpp), which poses minimum-time
parameterization of a geometric trajectory under velocity/acceleration
limits as a MOSEK conic program. Here, as in the JAX package, it is the
numerical-integration form of the same convex problem over b(s) =
s_dot^2:

  * squared path speed b_k at arclength samples s_k
  * velocity limits:  b_k <= min_i (v_max / |q'_i(s_k)|)^2
  * acceleration limits: x_ddot = q'' b + q' b'/2 =>
        |q''_i b + q'_i a| <= a_max per axis, a = b'/2
  * a backward pass caps b_k by what the strongest admissible deceleration
    can reach from b_{k+1}; a forward pass integrates the strongest
    admissible acceleration from b_0.

Both passes are eager loops over the N samples (2 (N - 1) steps of ~40
small ops each), batched over scenarios. Inside them the products that
XLA contracts into the following sum in the JAX package's scan bodies are
one FMA. Time stamps follow t_{k+1} = t_k + 2 ds / (sqrt(b_k) +
sqrt(b_{k+1})).

The second differences of a finely sampled path amplify rounding: a 1e-7
relative change of a spline's samples can move b by 20% where its chords
shrink to millimetres. So the chords, roots and time sums are rounded the
same way on the card and the CPU (an FMA chain, the correctly rounded
root, a float64 running sum), and both give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from intent_mpc_torch.utils.device import f32
from intent_mpc_torch.utils.rounding import fma, sq_norm3, sqrt32


class TOPPResult(NamedTuple):
    b: torch.Tensor           # (S, N) squared path speed at samples
    times: torch.Tensor       # (S, N) time stamps
    total_time: torch.Tensor  # (S,)


def _acc_interval(qp: torch.Tensor, qpp: torch.Tensor, b: torch.Tensor,
                  a_max: float):
    """Admissible a = b'/2 interval from |q'' b + q' a| <= a_max (per axis),
    intersected over axes: qp, qpp (S, 3), b (S,) -> (lo, hi) (S,)."""
    dev = b.device
    lo = torch.full_like(b, float("-inf"))
    hi = torch.full_like(b, float("inf"))
    one = f32(1.0, dev)
    for i in range(3):
        qpi, qppi = qp[:, i], qpp[:, i]
        safe = torch.abs(qpi) > 1e-6
        q = torch.where(safe, qpi, one)
        a1 = fma(-qppi, b, f32(a_max, dev)) / q
        a2 = fma(-qppi, b, f32(-a_max, dev)) / q
        alo = torch.minimum(a1, a2)
        ahi = torch.maximum(a1, a2)
        lo = torch.where(safe, torch.maximum(lo, alo), lo)
        hi = torch.where(safe, torch.minimum(hi, ahi), hi)
    return lo, hi


def parameterize(path: torch.Tensor, v_max, a_max: float,
                 b_start: float = 0.0, b_end: float = 0.0) -> TOPPResult:
    """Time-optimal parameterization of sampled paths (S, N, 3).

    Arclength is the chord length between samples; q', q'' by central
    finite differences in s. v_max is a scalar or per-sample limits
    (S, N) (the braking-zone limits of models/traj_divider.py)."""
    S, N, _ = path.shape
    dev = path.device
    seg = sqrt32(sq_norm3(path[:, 1:] - path[:, :-1]))
    ds = torch.clamp(seg, min=1e-6)                          # (S, N - 1)

    def grad(f):
        # central differences with one-sided ends, w.r.t. arclength
        fwd = (f[:, 1:] - f[:, :-1]) / ds[..., None]
        mid = (fwd[:, 1:] + fwd[:, :-1]) * 0.5
        return torch.cat([fwd[:, :1], mid, fwd[:, -1:]], dim=1)

    qp = grad(path)          # (S, N, 3) ~ unit tangents
    qpp = grad(qp)

    v_cap = torch.broadcast_to(v_max if isinstance(v_max, torch.Tensor)
                               else f32(v_max, dev), (S, N))
    b_vel = torch.amin((v_cap[..., None]
                        / torch.clamp(torch.abs(qp), min=1e-6)) ** 2, dim=-1)

    # backward pass: b_k <= b_{k+1} - 2 ds * a_lo(b_{k+1})
    zero = f32(0.0, dev)
    b_next = torch.minimum(f32(b_end, dev), b_vel[:, -1])
    back = [b_next]
    for i in range(N - 2, -1, -1):
        lo, _ = _acc_interval(qp[:, i + 1], qpp[:, i + 1], b_next, a_max)
        cap = fma(-2.0 * ds[:, i], lo, b_next)
        b_next = torch.minimum(b_vel[:, i], torch.maximum(cap, zero))
        back.append(b_next)
    b_back = torch.stack(back[::-1], dim=1)                  # (S, N)

    # forward pass: b_{k+1} <= b_k + 2 ds * a_hi(b_k), capped by backward
    b_prev = torch.minimum(f32(b_start, dev), b_back[:, 0])
    fwd = [b_prev]
    for k in range(N - 1):
        _, hi = _acc_interval(qp[:, k], qpp[:, k], b_prev, a_max)
        nxt = fma(2.0 * ds[:, k], torch.maximum(hi, zero), b_prev)
        b_prev = torch.minimum(nxt, b_back[:, k + 1])
        fwd.append(b_prev)
    b = torch.stack(fwd, dim=1)

    sb = sqrt32(torch.clamp(b, min=1e-12))
    dt = 2.0 * ds / (sb[:, :-1] + sb[:, 1:])
    times = torch.cat([torch.zeros((S, 1), device=dev),
                       torch.cumsum(dt.double(), dim=1).float()], dim=1)
    return TOPPResult(b=b, times=times, total_time=times[:, -1])


def sample_state(path: torch.Tensor, res: TOPPResult, t: torch.Tensor):
    """Position and velocity (S, 3) at times t (S,) from the parameterized
    paths (S, N, 3); the path's end at rest after its total time."""
    S, N, _ = path.shape
    dev = path.device
    ar = torch.arange(S, device=dev)
    i = torch.searchsorted(res.times, t[:, None].contiguous(),
                           right=True)[:, 0] - 1
    i = torch.clamp(i, 0, N - 2)
    t0, t1 = res.times[ar, i], res.times[ar, i + 1]
    frac = torch.clamp((t - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)
    p0, p1 = path[ar, i], path[ar, i + 1]
    seg = p1 - p0
    pos = p0 + seg * frac[:, None]
    sb = torch.sqrt(torch.clamp(res.b[ar, i] * (1 - frac)
                                + res.b[ar, i + 1] * frac, min=0.0))
    tang = seg / torch.clamp(torch.linalg.vector_norm(seg, dim=-1,
                                                      keepdim=True), min=1e-9)
    vel = tang * sb[:, None]
    past = (t >= res.total_time)[:, None]
    return (torch.where(past, path[:, -1], pos),
            torch.where(past, torch.zeros_like(vel), vel))
