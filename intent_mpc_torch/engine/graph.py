"""The closed-loop cycle replayed as CUDA graphs.

An eager cycle of `engine/closed_loop.episode_step` issues 5-35 thousand
kernel launches from Python, and the device idles while the host issues
them. Here each kind of cycle, a variant, is captured once into a
`torch.cuda.CUDAGraph` and replayed on every later cycle of that kind: a
replay costs a few dozen host operations (the inputs copied in, one graph
launch, the outputs copied out). The graph runs the eager cycle's kernels
on the same shapes, so it gives the same bits.

The rule. A cycle runs eagerly, as without this module, when
  - its tensors are not on a CUDA device;
  - utils/trace is recording spans (they time the eager stages);
  - a solve_override is given (a Python callback inside the cycle);
  - its variant's first, eager run counted a host read (HOST_READS): a
    value read back to the host decides the next launches, and a graph
    cannot replay that decision.
Every other cycle is captured or replayed (`engages`, `reads_host`).

A variant is the caller's key (the configuration by value, the solver's
iteration budget, the factor refresh or reuse branch) together with the
process's matrix-product settings (`math_mode`: TF32, reduced-precision
reductions) and the structure of the cycle's arguments: which leaves are
None, each tensor's shape, dtype, strides and device, and each other value
itself (`variant_key`, over utils/tree's walk). Its first cycle runs
eagerly, which builds and loads the kernels, fills the cached constants
and makes cuBLAS's handles; its second is captured, on torch.cuda.graph's
side stream and into a memory pool of its own; later ones replay. Every
variant is kept until `clear()`.

Inputs and outputs. Before a replay the caller's tensors are copied into
the graph's static inputs and the cycle index into its clock, a float32
scalar on the device. After it every output is copied into a fresh tensor,
so no later cycle writes a tensor this one returned; an output that is one
of the inputs, unchanged, is returned as the caller's own tensor, as the
eager cycle returns it.

Counters (utils/trace): "closed_loop.graph_captures", "...graph_replays"
and "...graph_eager" (cycles on a CUDA device that ran eagerly, by the
rule or as a variant's first), one of the three per cycle. The kernels'
launch counters count the host's own launches: a capture takes back what
the captured cycle added to the registry (nothing ran), and a replay adds
nothing to them. It adds the captured cycle's change to "<name>.replayed"
instead ("ew_chain.launches.replayed", ...): the kernels the replayed
graphs hold, which only the device record (torch.profiler) sees run.
"""

from __future__ import annotations

import torch

from intent_mpc_torch.utils import trace
from intent_mpc_torch.utils.tree import flatten, unflatten

HOST_READS = ("closed_loop.host_reads", "admm.host_reads",
              "clustering.host_reads")

_SEEN, _EAGER = "seen", "eager"     # a variant run once / never captured
_variants: dict = {}


def engages(device: torch.device, spans_on: bool, solve_override) -> bool:
    """The rule's part that is known before a cycle runs."""
    return (device.type == "cuda" and not spans_on
            and solve_override is None)


def reads_host(before: dict, after: dict) -> bool:
    """Whether a run between two readings of `trace.counters()` read a
    device value back to the host."""
    return any(after.get(k, 0) != before.get(k, 0) for k in HOST_READS)


def math_mode() -> tuple:
    """The process-wide settings that choose a matrix product's kernels: a
    graph replays the kernels chosen under the settings of its capture."""
    mm = torch.backends.cuda.matmul
    return (mm.allow_tf32, mm.allow_fp16_reduced_precision_reduction,
            mm.allow_bf16_reduced_precision_reduction,
            torch.backends.cudnn.allow_tf32)


def _describe(leaf) -> tuple:
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), leaf.dtype, leaf.stride(), leaf.device)
    return (type(leaf), leaf)


def variant_key(key, tree) -> tuple:
    """(the variant's key, the tree's leaves in utils/tree order) for the
    caller's `key` and the cycle's arguments `tree`: the tree with each
    leaf replaced by its description, so None fields stay in place."""
    leaves = flatten(tree)
    shape = unflatten(tree, [_describe(x) for x in leaves])
    return (key, math_mode(), shape), leaves


def clock(cycle: int, device) -> torch.Tensor:
    """The cycle index as a float32 scalar on `device`: the one number of
    a cycle that changes from one replay to the next."""
    return torch.full((), float(cycle), dtype=torch.float32, device=device)


def _by_dtype(tensors) -> list:
    """Index lists of `tensors` grouped by dtype, for multi-tensor copies."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


def _copy(dst: list, src: list, groups: list) -> None:
    for idx in groups:
        torch._foreach_copy_([dst[i] for i in idx], [src[i] for i in idx])


class CudaGraph:
    """torch.cuda.CUDAGraph on one device: `capture(fn)` returns fn()'s
    outputs, captured on torch.cuda.graph's side stream into a private
    memory pool; `replay()` runs them again on the current stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn):
        with torch.cuda.device(self.device), torch.cuda.graph(self.graph):
            return fn()

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()


class _Captured:
    """One variant's graph: its static inputs and clock, the graph, its
    static outputs, and the registry's change over the captured cycle."""

    def __init__(self, tree, leaves: list, cycle: int, fn):
        self.slots = [i for i, x in enumerate(leaves)
                      if isinstance(x, torch.Tensor)]
        src = [leaves[i] for i in self.slots]
        self.inputs = [torch.empty_like(t) for t in src]
        self.in_groups = _by_dtype(self.inputs)
        self.clock = clock(cycle, src[0].device)
        _copy(self.inputs, src, self.in_groups)
        static = list(leaves)
        for i, t in zip(self.slots, self.inputs):
            static[i] = t
        self.graph = CudaGraph(src[0].device)
        before = trace.counters()
        out = self.graph.capture(
            lambda: fn(unflatten(tree, static), self.clock))
        after = trace.counters()
        self.counts = {k: v - before.get(k, 0) for k, v in after.items()
                       if v != before.get(k, 0)}
        for k, n in self.counts.items():
            trace.count(k, -n)              # captured, not executed
        # each output leaf (a tensor): ("in", j) the j-th input tensor
        # returned unchanged, or ("out", k) the k-th distinct static output
        self.out_tree = out
        ins = {id(t): j for j, t in enumerate(self.inputs)}
        outs = {}
        self.source, self.outputs = [], []
        for t in flatten(out):
            if id(t) in ins:
                self.source.append(("in", ins[id(t)]))
            else:
                if id(t) not in outs:
                    outs[id(t)] = len(self.outputs)
                    self.outputs.append(t)
                self.source.append(("out", outs[id(t)]))
        self.out_groups = _by_dtype(self.outputs)

    def replay(self, leaves: list, cycle: int):
        """The cycle's outputs for the caller's leaves `leaves`."""
        src = [leaves[i] for i in self.slots]
        _copy(self.inputs, src, self.in_groups)
        self.clock.fill_(float(cycle))
        self.graph.replay()
        for k, n in self.counts.items():
            trace.count(k + ".replayed", n)
        fresh = [torch.empty_like(t) for t in self.outputs]
        _copy(fresh, self.outputs, self.out_groups)
        pick = {"in": src, "out": fresh}
        return unflatten(self.out_tree,
                         [pick[kind][i] for kind, i in self.source])


def run(key, tree, cycle: int, fn):
    """One cycle of `fn(tree, clock)` on a CUDA device under the rule:
    eagerly on its variant's first encounter (and ever after if that run
    read the host), captured on the second, replayed after. `key` is
    hashable and holds whatever besides `tree`'s structure steers fn's
    launches; `clock` is `clock(cycle, device)` or the graph's own."""
    k, leaves = variant_key(key, tree)
    entry = _variants.get(k)
    if entry is None or entry is _EAGER:
        dev = next(x.device for x in leaves if isinstance(x, torch.Tensor))
        before = trace.counters()
        out = fn(tree, clock(cycle, dev))
        if entry is None:
            _variants[k] = (_EAGER if reads_host(before, trace.counters())
                            else _SEEN)
        trace.count("closed_loop.graph_eager")
        return out
    if entry is _SEEN:
        entry = _variants[k] = _Captured(tree, leaves, cycle, fn)
        trace.count("closed_loop.graph_captures")
    else:
        trace.count("closed_loop.graph_replays")
    return entry.replay(leaves, cycle)


def clear() -> None:
    """Forget every variant (their graphs and memory pools go with them)."""
    _variants.clear()
