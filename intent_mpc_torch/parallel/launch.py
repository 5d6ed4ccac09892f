"""Start a fleet: one process per rank, each in the process group.

`init_process_group` runs once per process, so a fleet of W ranks is W
fresh interpreters. `spawn` starts them on this host with a loopback
rendezvous at a free port, runs `target` ("module:function", called as
function(fleet, **kwargs) with this rank's parallel/sharding.Fleet) in
each, and returns each rank's JSON-able result in rank order:

    results = spawn("intent_mpc_torch.entry:dryrun_rank", world=2,
                    backend="gloo", device="cpu", kwargs={...})

The ranks are watched together: as soon as one exits non-zero (its
peers may then wait on it forever), or the fleet outlasts `timeout`,
the others are stopped and spawn raises with the end of that rank's
output. Every process is stopped before spawn returns. Run as a module, this file is one rank:

    python -m intent_mpc_torch.parallel.launch --target mod:fn --rank 0
        --world 2 --addr tcp://127.0.0.1:PORT --backend gloo [--device cpu]
        [--threads 1] [--kwargs JSON]
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULT = "FLEET_RESULT "


def free_port() -> int:
    """A TCP port that was free on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(target: str, world: int, backend: str, kwargs: Optional[dict] = None,
          device: Optional[str] = None, threads: Optional[int] = None,
          timeout: float = 900.0) -> List:
    """Run `target` on `world` ranks (see the module docstring). device:
    each rank's device ("cpu"; None: cuda:<rank>); threads: torch's
    intra-op threads per rank (None: torch's default)."""
    addr = "tcp://127.0.0.1:%d" % free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "intent_mpc_torch.parallel.launch",
           "--target", target, "--world", str(world), "--addr", addr,
           "--backend", backend, "--kwargs", json.dumps(kwargs or {})]
    if device is not None:
        cmd += ["--device", device]
    if threads is not None:
        cmd += ["--threads", str(threads)]
    procs, logs = [], []
    try:
        for r in range(world):
            # a file, not a pipe: a rank that writes much never blocks
            logs.append(tempfile.TemporaryFile())
            procs.append(subprocess.Popen(
                cmd + ["--rank", str(r)], cwd=ROOT, env=env,
                stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        failed = why = None
        while failed is None:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                break
            # the first rank to fail: its peers may wait on it forever
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed, why = bad[0], "exited %d" % codes[bad[0]]
            elif time.monotonic() > deadline:
                failed, why = codes.index(None), "outlasted %g s" % timeout
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read().decode(errors="replace"))
            log.close()
    if failed is not None:
        raise RuntimeError("fleet rank %d of %d (%s) %s:\n%s"
                           % (failed, world, backend, why,
                              outs[failed][-4000:]))
    results = []
    for r, out in enumerate(outs):
        lines = [ln for ln in out.splitlines() if ln.startswith(RESULT)]
        if not lines:
            raise RuntimeError("fleet rank %d of %d (%s) printed no result:"
                               "\n%s" % (r, world, backend, out[-4000:]))
        results.append(json.loads(lines[-1][len(RESULT):]))
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="one rank of a fleet")
    ap.add_argument("--target", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--addr", required=True)
    ap.add_argument("--backend", required=True)
    ap.add_argument("--device", default=None)
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--kwargs", default="{}")
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist

    from intent_mpc_torch.parallel import sharding as sh
    if args.threads is not None:
        torch.set_num_threads(args.threads)
    sh.init_distributed(args.addr, args.world, args.rank, args.backend)
    try:
        fleet = sh.make_mesh(device=args.device)
        mod, fn = args.target.split(":")
        out = getattr(importlib.import_module(mod), fn)(
            fleet, **json.loads(args.kwargs))
    finally:
        dist.destroy_process_group()
    print(RESULT + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
