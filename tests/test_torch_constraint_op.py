"""The scaled constraint operator of the default ADMM iteration
(intent_mpc_torch/ops/constraint_op.py) on the CPU: its plain version
gives the bits of admm_solve's former a_s / at_s / m_apply composition,
the solver's carries are unchanged by the move, and the kernel's wrapper
refuses what the kernel cannot take before anything launches. The kernel
itself runs only on a CUDA device (tests/test_torch_cuda.py)."""

import dataclasses
import hashlib
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import constraint_op_inputs, small_fleet_qps  # noqa: E402
from intent_mpc_torch.ops import admm as admmlib  # noqa: E402
from intent_mpc_torch.ops import constraint_op as cop  # noqa: E402
from intent_mpc_torch.ops.qp import ConVec  # noqa: E402
from intent_mpc_torch.utils import trace  # noqa: E402
from intent_mpc_torch.utils.config import PlannerConfig, SolverConfig  # noqa: E402

torch.set_num_threads(1)

# the parity tests' size and the production shapes (horizon 30, 65 slots)
SIZES = {"small": dict(horizon=10, max_obstacles=4),
         "production": dict(horizon=30, max_obstacles=65)}

# sha256 (first 16 hex digits) of the outputs that the commit before the
# operator moved to its own module gave on the CPU, one thread: admm_solve's
# closures a_s, at_s and m_apply (sigma 1e-6) on _setup's inputs ...
PARENT_ENTRIES = {
    ('small', 2, True, 'forward'): '9663bf2ee0f23d1e',
    ('small', 2, True, 'transpose'): '0563c0c016083598',
    ('small', 2, True, 'normal'): '6e52079b0fdfead7',
    ('small', 2, False, 'forward'): '34dffb54c2cb8954',
    ('small', 2, False, 'transpose'): 'a938133a87a83a6a',
    ('small', 2, False, 'normal'): '9099a147608b4f1f',
    ('small', 4, True, 'forward'): '675187d33997f361',
    ('small', 4, True, 'transpose'): 'fc01b7b165d18219',
    ('small', 4, True, 'normal'): '63f9d16ad508da17',
    ('small', 4, False, 'forward'): 'e0d999b852da3d0b',
    ('small', 4, False, 'transpose'): '19120bf806f23213',
    ('small', 4, False, 'normal'): 'a2b6aeb56dae0938',
    ('production', 2, True, 'forward'): 'b0e6de97dc0f3b0a',
    ('production', 2, True, 'transpose'): '4fc5c10eead4a21e',
    ('production', 2, True, 'normal'): 'cdf7d4396cf0defa',
    ('production', 2, False, 'forward'): '8c8751132407aa56',
    ('production', 2, False, 'transpose'): '4441796d62aa0c9b',
    ('production', 2, False, 'normal'): 'abf1a1331d4f8348',
    ('production', 3, True, 'forward'): '0a8e65c614bb7f43',
    ('production', 3, True, 'transpose'): 'b47dc4c8e1f34fc2',
    ('production', 3, True, 'normal'): 'a0c4f37997b46a94',
    ('production', 3, False, 'forward'): '24e4e71c2bc44502',
    ('production', 3, False, 'transpose'): '010e227dc64c35de',
    ('production', 3, False, 'normal'): 'a0a665aeb3ec793d',
}
# ... and admm_solve's ADMMResult on test_admm_solve_carries_are_the_parents'
PARENT_CARRIES = {
    ('small', 40, 'default'): '0b015fbb91e0de73',
    ('small', 40, 'block_refine'): '18085e320479c042',
    ('small', 40, 'per_candidate'): 'b1e0ac7d926bdd4f',
    ('small', 40, 'ew_kernel_off'): '0b015fbb91e0de73',
    ('production', 6, 'default'): 'd1740c70ecbcc29c',
    ('production', 6, 'block_refine'): 'c7c3f5bdb5c84f34',
    ('production', 6, 'per_candidate'): '5fcdd0e899a911cd',
    ('production', 6, 'ew_kernel_off'): 'd1740c70ecbcc29c',
}


def _digest(tree) -> str:
    """sha256 of the shapes, dtypes and bits of a tree's tensors, in
    order (None leaves skipped)."""
    h = hashlib.sha256()

    def leaves(t):
        if isinstance(t, (tuple, list)):
            for u in t:
                yield from leaves(u)
        elif t is not None:
            yield t
    for t in leaves(tree):
        h.update(repr((tuple(t.shape), str(t.dtype))).encode())
        h.update(t.contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def _setup(size, S, shared):
    """(cfg, qps, D, E, rho, h_s) of seeded (S, 6) candidate QPs with every
    obstacle row in use and the shapes admm_solve binds: a shared factor's
    (S, 1, ...) scaling or each candidate's own
    (chip_smoke.constraint_op_inputs)."""
    cfg = PlannerConfig(**SIZES[size])
    return (cfg,) + constraint_op_inputs(cfg, S, shared, "cpu")


@pytest.mark.parametrize("size,S", [("small", 2), ("small", 4),
                                    ("production", 2), ("production", 3)])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("entry", ["forward", "transpose", "normal"])
def test_reference_entries_are_the_parents_composition(size, S, shared,
                                                       entry):
    """Each entry of the plain version gives the bits that admm_solve's
    former closures gave, with a shared factor's scaling and with each
    candidate's."""
    cfg, qps, D, E, rho, h_s = _setup(size, S, shared)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(qps.q.shape, generator=g)
    w = ConVec(*(torch.randn(t.shape, generator=g) for t in rho))
    args = {"forward": (x,), "transpose": (w,),
            "normal": (rho, h_s, 1e-6, x)}[entry]
    got = getattr(cop.ConstraintOpReference(cfg, qps, D, E), entry)(*args)
    assert _digest(got) == PARENT_ENTRIES[(size, S, shared, entry)]


def _solver(**kw):
    return dataclasses.replace(SolverConfig(), **kw)


@pytest.mark.parametrize("size,iters", [("small", 40), ("production", 6)])
@pytest.mark.parametrize("option", ["default", "block_refine",
                                    "per_candidate", "ew_kernel_off"])
def test_admm_solve_carries_are_the_parents(size, iters, option):
    """admm_solve on the CPU gives the bits it gave through the former
    closures: on the default path (shared factor, CG-2 from the previous
    x-tilde, the chain's tail), with block_refine, with a factor per
    candidate and with the grouped tail."""
    scfg = _solver(**{"default": {}, "block_refine": dict(block_refine=True),
                      "per_candidate": dict(shared_factor=False,
                                            refine_iters=1),
                      "ew_kernel_off": dict(ew_kernel=False)}[option])
    cfg = dataclasses.replace(PlannerConfig(**SIZES[size]), solver=scfg)
    qps = small_fleet_qps(cfg, 2, "cpu")
    x0 = torch.zeros(qps.q.shape)
    rho = torch.full((2, 1), 0.1)
    fac = (admmlib.admm_factor(cfg, admmlib.candidate_mean(qps))
           if scfg.shared_factor else None)
    got = admmlib.admm_solve(cfg, qps, x0, iters, rho_override=rho,
                             factor=fac)
    assert _digest(list(got)) == PARENT_CARRIES[(size, iters, option)]


def _bad_cases():
    """(name, how to break what the wrapper binds, the exception, a
    pattern of its message)."""
    def qp_field(name, f):
        return lambda c: c.update(qps=c["qps"]._replace(
            **{name: f(getattr(c["qps"], name))}))
    return [
        ("q_shape", qp_field("q", lambda t: t[..., :-1]), ValueError, "shape"),
        ("G_float64", qp_field("G", torch.Tensor.double), TypeError,
         "float32"),
        ("G_strided", qp_field("G", lambda t: t.transpose(-1, -2)
                               .contiguous().transpose(-1, -2)), ValueError,
         "contiguous"),
        ("mask_shape", qp_field("obs_slack", lambda t: t[..., :-1]),
         ValueError, "shape"),
        ("D_shape", lambda c: c.update(D=c["D"][:, :, :-1]), ValueError,
         "shape"),
        ("D_no_group_axis", lambda c: c.update(D=c["D"][:, 0]), ValueError,
         "shape"),
        ("E_float64", lambda c: c.update(E=c["E"]._replace(
            eq=c["E"].eq.double())), TypeError, "float32"),
        ("E_mixed", lambda c: c.update(E=c["E"]._replace(
            obs=c["E"].obs.expand(c["qps"].obs_active.shape).contiguous())),
         ValueError, "all be shared"),
        ("cpu_device", lambda c: None, ValueError, "CUDA tensors"),
    ]


@pytest.mark.parametrize("name,brk,exc,says", _bad_cases(),
                         ids=[c[0] for c in _bad_cases()])
def test_wrapper_refuses_what_the_kernel_cannot_take(name, brk, exc, says):
    """A wrong dtype, shape or layout of what the wrapper binds raises, and
    so do well-formed CPU tensors (the kernel runs on a CUDA device only),
    before anything launches: the host's launch count stays where it was.
    The entries' own arguments are refused on the card
    (tests/test_torch_cuda.py)."""
    cfg, qps, D, E, _, _ = _setup("small", 2, shared=True)
    c = dict(qps=qps, D=D, E=E.map(torch.Tensor.contiguous))
    brk(c)
    before = trace.counters().get("constraint_op.launches", 0)
    with pytest.raises(exc, match=says):
        cop.ConstraintOp(cfg, c["qps"], c["D"], c["E"])
    assert trace.counters().get("constraint_op.launches", 0) == before
