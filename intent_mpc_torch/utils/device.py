"""Device selection for the port's entry points.

Entry points run on the card unless the caller names another device:
`device=None` means "cuda", and raises when no CUDA device is present
instead of falling back to the CPU. Tests pass `device="cpu"`.
"""

from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """Return the torch.device an entry point runs on.

    Also turns TF32 off for float32 products: the reference runs every
    product at full float32 precision, and TF32 keeps ~3 decimal digits,
    which the infeasible DYNUS QPs (duals near 1e4-1e5) cannot absorb."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; "
                "pass device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)


@functools.lru_cache(maxsize=None)
def constant(values: tuple, device, dtype=torch.float32) -> torch.Tensor:
    """A small constant tensor, built once per device.

    Building `torch.tensor(list, device="cuda")` inside the loop would copy
    from the host and synchronize the stream on every call. Callers must
    not modify the returned tensor in place."""
    return torch.tensor(values, dtype=dtype).to(torch.device(device))


def f32(value: float, device) -> torch.Tensor:
    """A float32 scalar constant (0-dim) on `device`, built once: a divisor
    given as a tensor on the card divides exactly, where a Python float
    divisor would become a multiplication by its reciprocal there."""
    return constant((float(value),), device)[0]
