#!/usr/bin/env python3
"""How many of a session's kernels torch.profiler keeps, session after
session in one process, on one CUDA card, with CUPTI torn down at the end of
each session or kept attached (``TEARDOWN_CUPTI``).

    python3 gnark_icicle_tpu_torch/trace_probe.py [--teardown 1|0|unset]
        [--sessions 6] [--gap 20] [--load 7] [--out FILE]

``--teardown`` sets ``TEARDOWN_CUPTI`` before torch is imported (``unset``
leaves the environment's). Each session (torch.profiler, CPU and CUDA
activity) launches one small kernel at each of DELAYS seconds after its
start, the host spinning in between as a prove's witness solve does,
synchronizes after each, exports its Chrome trace and counts the kernel
events it holds against the launches; between sessions 20,000 launches run
unprofiled and the host spins for ``--gap`` seconds. ``--load N`` spawns N
processes that spin on the host's cores for the whole run, as the second
process, nvcc and the compile workers of ``chip_smoke.py`` do. One JSON line
a session (its age in the process, the kernels kept, each kept kernel's start
less its launch's, in µs) goes to stdout and to FILE (default
``build/trace_probe/<teardown>.jsonl``), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DELAYS = (0.0, 0.05, 0.25, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0)


def _spin(seconds: float) -> None:
    t = time.time()
    while time.time() - t < seconds:
        pass


def _session(x, t0: float, trace_dir: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.time()
        for i, d in enumerate(DELAYS):
            _spin(d - (time.time() - start))
            x.add_(1.0)
            torch.cuda.synchronize()
    path = os.path.join(trace_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e.get("name", "")}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return {"age_s": start - t0, "launched": len(DELAYS), "kept": len(kernels),
            "kernel_minus_launch_us": [k["ts"] - launches[k["args"]["correlation"]]
                                       for k in kernels
                                       if k.get("args", {}).get("correlation") in launches]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--teardown", choices=("1", "0", "unset"), default="1")
    ap.add_argument("--sessions", type=int, default=6)
    ap.add_argument("--gap", type=float, default=20.0)
    ap.add_argument("--load", type=int, default=7)
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.teardown != "unset":
        os.environ["TEARDOWN_CUPTI"] = args.teardown
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("trace_probe.py: no CUDA device")
    out = args.out or os.path.join(REPO, "build", "trace_probe", f"{args.teardown}.jsonl")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    load = [ctx.Process(target=_spin, args=(1e9,), daemon=True) for _ in range(args.load)]
    for p in load:
        p.start()
    try:
        x = torch.ones(1 << 16, device="cuda")
        torch.cuda.synchronize()
        t0 = time.time()
        with open(out, "w") as f:
            for n in range(args.sessions):
                line = json.dumps({"teardown": args.teardown, "load": args.load, "session": n,
                                   **_session(x, t0, os.path.dirname(out))})
                print(line, flush=True)
                f.write(line + "\n")
                for _ in range(20000):
                    x.mul_(1.0)
                torch.cuda.synchronize()
                _spin(args.gap)
    finally:
        for p in load:
            p.terminate()
            p.join()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
