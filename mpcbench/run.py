"""Run one benchmark cell once on the card.

    python3 mpcbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line (correct, attempted, failed, metrics, device,
with --trace 1 breakdown, and the compared numbers with their limits
last) as the last line of standard output, and the compared numbers
with their limits as the last lines of standard error. Exits non-zero
without a result when the card, the cell's files or the program are
missing, or when the process holds JAX or the JAX package after the
window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

FORBIDDEN = ("jax", "jaxlib", "flax", "intent_mpc_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.set_defaults(cycles=None)    # the CPU rehearsals' windows count cycles
    return ap.parse_args(argv)


def fail(msg: str, code: int):
    print("mpcbench: " + msg, file=sys.stderr)
    sys.exit(code)


def main(argv=None):
    args = parse(argv)
    from mpcbench import harness as hz
    bench = hz.load_json(os.path.join(hz.ROOT, "BENCHMARK.json"))
    c = hz.cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < c["workload"]["chips"]:
        fail("needs %d CUDA device(s), found %s" % (
            c["workload"]["chips"],
            torch.cuda.device_count() if torch.cuda.is_available() else 0), 3)
    result, checks = run_cell(c, args, torch.device("cuda"))
    found = forbidden_modules()
    if found:
        fail("the process holds %s after the window" % ", ".join(found), 4)
    for name, v, lim in checks:
        print("check %s %r limit %r" % (name, v, lim), file=sys.stderr)
    print(json.dumps(result))


class Prepared:
    """A cell's set-up on `dev`: the program's configuration, the seeded
    worlds (host and device copies) and each block's maps, the reference
    trajectory, the mode, the check's stages, and the program's kernels
    built and warmed on the cell's own shapes (one factor-refresh cycle
    and one reuse cycle, sent as the traffic sends them)."""

    def __init__(self, c: dict, seed: int, dev):
        import torch
        from mpcbench import check, generator
        from mpcbench import harness as hz
        from intent_mpc_torch.models.world import Scenario
        from intent_mpc_torch.ops import build

        self.seed, self.dev = seed, dev
        self.cfg, self.traffic = c["config"], c["traffic"]
        self.pcfg = hz.program_config(self.cfg)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.blocks_np, self.ref_np = generator.make(self.cfg, self.traffic, seed)
        self.blocks = [Scenario(**{k: torch.as_tensor(v, device=dev)
                                   for k, v in b.items()})
                       for b in self.blocks_np]
        self.ref = torch.as_tensor(self.ref_np, device=dev)
        self.maps = hz.maps(self.cfg, self.blocks_np, dev)
        self.mode = hz.load_module("modes", self.traffic["mode"])
        self.stages = check.stages(self.cfg)
        self.every = self.pcfg.planner.solver.factor_reuse_cycles
        warm = self.flights()
        for _ in range(2):
            self.mode.cycle(warm)
        warm.sync()
        self.build_s = dict(build.BUILD_SECONDS)

    def flights(self, sampler=None):
        from mpcbench import harness as hz
        return hz.Flights(self.pcfg, self.blocks, self.ref, self.maps,
                          self.traffic["episode_cycles"], sampler)

    def sampler(self):
        from mpcbench import check
        return check.Sampler(self.seed, self.traffic["samples"], self.every,
                             check.settled_from(self.cfg))

    def host_blocks(self):
        import torch
        return [{k: torch.as_tensor(v) for k, v in b.items()}
                for b in self.blocks_np]

    def gaps(self, samples, prec=None):
        """The reference's gaps of the samples, stage by stage; with a
        Precision `prec`, of the control: the reference computed in it,
        held in the program's place."""
        import torch
        from mpcbench import check
        blocks, ref = self.host_blocks(), torch.as_tensor(self.ref_np)
        chunk = self.traffic["reference_chunk"]
        out = []
        for s in samples:
            prog = None if prec is None else check.control_after(
                self.cfg, self.stages, blocks, ref, s, prec, chunk, self.dev)
            out.append(check.stage_gaps(self.cfg, self.stages, blocks, ref, s,
                                        chunk, self.dev, program=prog))
        return out

    def numbers(self, samples, prec=None) -> dict:
        """The compared numbers of the samples (of the control, with
        `prec`)."""
        from mpcbench import check
        return check.numbers(self.gaps(samples, prec), self.stages)

    def release(self):
        """Drop the program's device state (the reference runs after)."""
        import torch
        self.blocks = self.ref = self.maps = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def run_cell(c: dict, args, dev):
    """Set-up, window, optional traced sub-window and the reference check
    of one cell on `dev` (the card; the tests rehearse it on the CPU at a
    tiny size). Returns (result line, compared numbers)."""
    from mpcbench import check
    from mpcbench import harness as hz

    cfg, traffic = c["config"], c["traffic"]
    pre = Prepared(c, args.seed, dev)
    sampler = pre.sampler()
    flights = pre.flights(sampler)
    flights.sync()
    setup_s = time.perf_counter() - T_START
    win = pre.mode.window(flights, args.seconds, traffic, args.cycles)
    flights.sync()
    device = hz.card(dev)
    print("mpcbench: %s seed %d: %d cycles in %.3f s, setup %.3f s, build %s, "
          "card %s" % (c["workload"]["name"], args.seed, win["cycles"],
                       win["elapsed_s"], setup_s, json.dumps(pre.build_s),
                       hz.power_limit()), file=sys.stderr)

    result = dict(correct=False, attempted=win["attempted"], failed=win["failed"])
    if args.trace:
        flights.sampler = None
        tr = hz.traced(flights, pre.mode, traffic["trace_cycles"], pre.every,
                       spans=bool(traffic.get("spans") or cfg.get("spans")))
        busy = hz.busy_seconds(tr["ops"])
        rec = dict(mode=traffic["mode"], ops=tr["ops"], window_s=tr["window_s"],
                   busy_s=busy, traced_cycles=tr["cycles"], spans=tr["spans"],
                   counters=tr["counters"], runtime=tr["runtime"],
                   window=tr["window"],
                   enqueue_s=win["enqueue_s"], scenarios=traffic["scenarios"],
                   candidates=cfg["planner"]["num_intent_candidates"], config=cfg,
                   peaks=hz.load_json(os.path.join(hz.HERE, "peaks.json")),
                   counts=lambda k: hz.load_module("counts", k),
                   kernel_time=lambda p: hz.kernel_time(tr["ops"], p))
        metrics = {}
        for m in c["per_layer"]:
            v = hz.load_module("metrics", m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device.update(busy_s=busy, window_s=tr["window_s"])
        result["breakdown"] = hz.breakdown(tr["ops"])
    else:
        metrics = {m["name"]: {"value": win["metrics"][m["name"]],
                               "unit": m["unit"]}
                   for m in c["end_to_end"] if m["name"] in win["metrics"]}
        su = [m for m in c["end_to_end"] if m["name"] == "setup_s"]
        if su:
            metrics["setup_s"] = {"value": setup_s, "unit": su[0]["unit"]}
    result["metrics"] = metrics
    result["device"] = device

    # correctness: the program's state freed first, then the reference
    samples = sampler.take()
    del flights, sampler
    pre.release()
    t0 = time.perf_counter()
    values = pre.numbers(samples)
    ok, rows = check.judge(values, cfg["correct_limits"])
    print("mpcbench: reference check of %d sampled cycles in %.3f s: %s"
          % (len(samples), time.perf_counter() - t0, json.dumps(values)),
          file=sys.stderr)
    result["correct"] = bool(ok)
    result["checks"] = {n: {"value": v if v is not None and math.isfinite(v) else None,
                            "limit": lim} for n, v, lim in rows}
    return result, rows


if __name__ == "__main__":
    main()
