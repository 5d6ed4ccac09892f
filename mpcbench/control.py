"""The readings that the limits of `correct` are set from, on the card.

    python3 mpcbench/control.py --workload <name> --seeds 1 2 3 ...
        [--seconds 10] [--control 3]

For each seed, in one process: the cell's set-up and a window of
`--seconds` at the cell's own load, then the compared numbers of the
program's sampled cycles (the lower readings), with each sampled cycle's
median and largest plan gap where the configuration's stages hold one.
For the first `--control` seeds also the controls' numbers (the upper
readings), from the program's state of the same cycles, through the
configuration's own stages (its "stages", mpcbench/stages/<name>.py):
the reference in the program's place with its products in TF32
("tf32") and with its stored results in bfloat16 ("bf16"); and, as
a witness beside them, the program itself run once more on the seed with
cuBLAS's TF32 switched back on after each flight's `init_carry` (which
switches it off), its own sampled cycles held against the reference
("program_tf32"). One JSON line per seed. The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@contextlib.contextmanager
def program_tf32():
    """The program with TF32 in its cuBLAS products: every flight's
    `init_carry` turns TF32 off (utils/device.resolve_device), so it is
    turned back on after each."""
    import torch
    from intent_mpc_torch.engine import closed_loop as cl
    orig = cl.resolve_device

    def on(device=None):
        dev = orig(device)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        return dev
    cl.resolve_device = on
    try:
        yield
    finally:
        cl.resolve_device = orig
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def sampled_window(c, seed, dev, seconds):
    """(set-up, window, the samples moved to the host) of one seed; the
    program's device state is released."""
    from mpcbench.run import Prepared
    pre = Prepared(c, seed, dev)
    sampler = pre.sampler()
    fl = pre.flights(sampler)
    win = pre.mode.window(fl, seconds, c["traffic"])
    samples = sampler.take()
    del fl, sampler
    pre.release()
    return pre, win, samples


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from mpcbench import check
    from mpcbench import harness as hz
    from mpcbench.reference.solve import Precision

    if not torch.cuda.is_available():
        sys.exit("mpcbench: needs a CUDA device")
    dev = torch.device("cuda")
    c = hz.cell(hz.load_json(os.path.join(hz.ROOT, "BENCHMARK.json")),
                args.workload)
    for n, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        pre, win, samples = sampled_window(c, seed, dev, args.seconds)
        gaps = pre.gaps(samples)
        line = dict(workload=args.workload, seed=seed, cycles=win["cycles"],
                    program=check.numbers(gaps, pre.stages),
                    plan_by_cycle=[[s["cycle"], g["settled"],
                                    float(np.median(g["plan_state"])),
                                    max(g["plan_state"])]
                                   for s, g in zip(samples, gaps)
                                   if "plan_state" in g])
        if n < args.control:
            for name in ("tf32", "bf16"):
                line[name] = pre.numbers(samples, Precision(name))
            with program_tf32():
                pre_t, _, samples_t = sampled_window(c, seed, dev, args.seconds)
            line["program_tf32"] = pre_t.numbers(samples_t)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
