"""Precision modes and the ADMM of the candidate QPs.

ADMM (OSQP's iteration, fixed iteration count) in the Ruiz-scaled space
of the scenario's shared factor:

    x~ = argmin of the x-update:  M_c x~ = sigma x - q + A^T (rho z - y)
    x+ = alpha x~ + (1 - alpha) x
    z+ = clip(alpha A x~ + (1 - alpha) z + y / rho, l, u)
    y+ = y + rho (alpha A x~ + (1 - alpha) z - z+)

M_c is the candidate's own scaled normal matrix. The x-update is
inexact by the configuration: `refine` steps preconditioned by the
inverse of the candidate-mean QP's normal matrix (the shared factor),
either conjugate gradients started from the previous x~ ("cg") or the
stationary recurrence x += Minv (rhs - M_c x) started from Minv rhs
("stationary", the fused solve's).
"""

from __future__ import annotations

import torch

TF32_DROP = 13   # float32 mantissa bits that TF32 does not keep


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 explicit mantissa bits), to
    nearest with ties away from zero."""
    bits = a.contiguous().view(torch.int32)
    half = 1 << (TF32_DROP - 1)
    mask = ~((1 << TF32_DROP) - 1)
    return ((bits + half) & mask).view(torch.float32)


class Precision:
    """float64 (the reference), float32, or one of the two controls, each
    the step below the configuration's float32 with TF32 off for its kind
    of work: "tf32", float32 arithmetic with every matrix product's
    operands rounded to TF32 (as cuBLAS computes a product with TF32 on);
    "bf16", float32 arithmetic with every stored result (the state a
    cycle commits) rounded to bfloat16, the step below float32 for the
    stages that hold no product (the world and detector, the controller
    and plant)."""

    def __init__(self, name: str = "float64"):
        if name not in ("float64", "float32", "tf32", "bf16"):
            raise ValueError("precision must be float64, float32, tf32 or bf16")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def mm(self, a, b):
        if self.name == "tf32":
            a, b = tf32_round(a), tf32_round(b)
        return torch.matmul(a, b)

    def store(self, a):
        """A result as this precision stores it (bf16: rounded)."""
        if self.name == "bf16" and a.is_floating_point():
            return a.to(torch.bfloat16).to(torch.float32)
        return a

    def mv(self, a, v):
        return self.mm(a, v[..., None])[..., 0]


def inverse(prec: Precision, M: torch.Tensor) -> torch.Tensor:
    """Inverse of symmetric positive definite matrices through Cholesky."""
    L = torch.linalg.cholesky(M)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    Li = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return prec.mm(Li.mT, Li)


def admm(prec: Precision, As, Mc, Minv, q_s, l_s, u_s, rho, x0s, iters: int,
         refine: int, mode: str, sigma: float, alpha: float):
    """Scaled iterates after `iters` iterations of the candidates (..., C):
    As (..., C, m, n) scaled constraint matrices, Mc (..., C, n, n) their
    normal matrices, Minv (..., n, n) the shared preconditioner, q_s
    (..., C, n), l_s/u_s/rho (..., C, m), x0s (..., C, n). Returns (x, z,
    y) scaled."""
    tiny = 1e-30
    Pm = Minv[..., None, :, :]
    x = x0s
    z = prec.mv(As, x)
    y = torch.zeros_like(z)
    xt_prev = x
    for _ in range(iters):
        rhs = sigma * x - q_s + prec.mv(As.mT, rho * z - y)
        if mode == "cg":
            xt = xt_prev
            r = rhs - prec.mv(Mc, xt)
            w = prec.mv(Pm, r)
            p = w
            rz = (r * w).sum(-1)
            for j in range(refine):
                ap = prec.mv(Mc, p)
                pap = (p * ap).sum(-1)
                a = torch.where(pap.abs() > tiny, rz / pap, torch.zeros_like(pap))
                xt = xt + a[..., None] * p
                if j < refine - 1:
                    r = r - a[..., None] * ap
                    w = prec.mv(Pm, r)
                    rz_n = (r * w).sum(-1)
                    b = torch.where(rz.abs() > tiny, rz_n / rz, torch.zeros_like(rz))
                    rz = rz_n
                    p = w + b[..., None] * p
        else:
            xt = prec.mv(Pm, rhs)
            for _ in range(refine):
                xt = xt + prec.mv(Pm, rhs - prec.mv(Mc, xt))
        zt = prec.mv(As, xt)
        x_n = alpha * xt + (1.0 - alpha) * x
        zr = alpha * zt + (1.0 - alpha) * z
        z_n = torch.minimum(torch.maximum(zr + y / rho, l_s), u_s)
        y = y + rho * (zr - z_n)
        x, z, xt_prev = x_n, z_n, xt
    return x, z, y
