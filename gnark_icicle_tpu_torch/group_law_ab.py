#!/usr/bin/env python3
"""A/B of the complete add and double (``*_add``, ``*_double``; csrc/field.cuh
``k_add``, ``k_double``) on one CUDA card: this checkout's kernels against
another checkout's, for BW6-761 G1 (24-word Fp), the one curve whose path
still runs ``*_add`` (the MSM's fold of split buckets).

    python3 gnark_icicle_tpu_torch/group_law_ab.py --other DIR [--out FILE]

DIR holds another checkout of the repo (e.g. the parent commit, unpacked
with ``git archive``). Both checkouts' ``csrc/g1.cu`` are built for BW6-761
with nvcc, the two processes started together, and loaded in one process;
ptxas's lines for ``k_add`` and ``k_double`` are kept. Cases: the add at 502
lanes (the first round of the 2-chain outer proof's fold) and at 2,112
lanes, the double at 1 lane (Horner's shape) and at 33 lanes. Operands are
random canonical Montgomery coordinates made from a seed, the first lanes
the identity; both libraries' results are held to the plain PyTorch
version (``ops/ec.py`` DevCurve) limb for limb. Times are CUDA-event means
of 20 launches after one warm-up, in the order other, this, this, other;
every pass is kept. The JSON goes to FILE (default
``build/group_law_ab/results.json``) and a summary to stdout, with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(REPO, "build", "group_law_ab")
CURVE = "bw6_761"
CASES = (("add", 502), ("add", 2112), ("double", 1), ("double", 33))
REPS = 20


def build(checkouts: dict) -> dict:
    """{label: checkout dir} -> {label: (library path, ptxas lines of k_add
    and k_double, seconds)}."""
    from gnark_icicle_tpu_torch.ops.cuda import _nvcc

    nvcc = _nvcc()
    procs = {}
    for label, root in checkouts.items():
        csrc = os.path.join(root, "gnark_icicle_tpu_torch", "csrc")
        out = os.path.join(BUILD, label)
        os.makedirs(out, exist_ok=True)
        lib, log = os.path.join(out, f"libg1_{CURVE}.so"), os.path.join(out, f"g1_{CURVE}.log")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               f"-DCURVE_{CURVE.upper()}", "-I", csrc, "-o", lib, os.path.join(csrc, "g1.cu")]
        procs[label] = (subprocess.Popen(cmd, stdout=open(log, "w"), stderr=subprocess.STDOUT),
                        lib, log, time.perf_counter())
    built = {}
    for label, (proc, lib, log, t0) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{open(log).read()}")
        keep, on = [], False
        for ln in open(log).read().splitlines():
            if "Compiling entry function" in ln:
                on = "k_add" in ln or "k_double" in ln
                if on:
                    keep.append(ln.split("'")[1] if "'" in ln else ln)
            elif on and ("registers" in ln or "spill" in ln):
                keep.append(ln.split("ptxas info    : ")[-1].strip())
        built[label] = (lib, keep, time.perf_counter() - t0)
    return built


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="another checkout of the repo")
    ap.add_argument("--out", default=os.path.join(BUILD, "results.json"))
    args = ap.parse_args()

    import torch

    sys.path.insert(0, REPO)
    from gnark_icicle_tpu_torch.curves import bw6_761
    from gnark_icicle_tpu_torch.ops.cuda import CURVES, SIGNATURES
    from gnark_icicle_tpu_torch.ops.ec_t import TCurve
    from gnark_icicle_tpu_torch.ops.field import field_for

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    device = torch.device("cuda", 0)
    built = build({"other": os.path.abspath(args.other), "this": REPO})
    fns = {}
    for label, (lib, _, _) in built.items():
        so = ctypes.CDLL(lib)
        for op in ("add", "double"):
            f = getattr(so, f"{CURVES[CURVE]}g1_{op}")
            f.argtypes, f.restype = SIGNATURES["g1"][f"g1_{op}"], ctypes.c_int
            fns[(label, op)] = f

    curve = bw6_761.BW6_761
    P = curve.fp.modulus
    fp = field_for(P)
    tc = TCurve(fp, 3 * curve.g1.b % P)
    b3 = tc.b3_row(device)
    gen = torch.Generator(device="cpu").manual_seed(761)

    def rand_points(n):
        w = torch.randint(-(1 << 31), 1 << 31, (tc.planes, fp.n32, n), generator=gen,
                          dtype=torch.int64)
        w[:, -1] = torch.randint(0, P >> (32 * (fp.n32 - 1)), (tc.planes, n), generator=gen)
        pts = w.to(torch.int32).to(device)
        k = min(4, n)
        pts[..., :k] = tc.identity(k, device)
        return pts

    def launcher(label, op, args_, out):
        n = out.shape[2]
        stream = torch.cuda.current_stream(device).cuda_stream
        if op == "add":
            P_, Q_ = args_
            call = (P_.data_ptr(), n, Q_.data_ptr(), n, out.data_ptr(), n, n,
                    b3.data_ptr(), stream)
        else:
            call = (args_[0].data_ptr(), n, out.data_ptr(), n, n, b3.data_ptr(), stream)

        def run():
            rc = fns[(label, op)](*call)
            if rc != 0:
                raise RuntimeError(f"{label} {op} failed to launch: error {rc}")
        return run

    def cuda_ms(run):
        run()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS

    cases = []
    for op, lanes in CASES:
        args_ = [rand_points(lanes) for _ in range(2 if op == "add" else 1)]
        want = tc._stack(getattr(tc.curve, op)(*[tc._coords(a.cpu()) for a in args_]))
        runs, outs = {}, {}
        for label in ("other", "this"):
            outs[label] = torch.empty((tc.planes, fp.n32, lanes), dtype=torch.int32,
                                      device=device)
            runs[label] = launcher(label, op, args_, outs[label])
            runs[label]()
        torch.cuda.synchronize()
        equal = {label: bool(torch.equal(outs[label].cpu(), want)) for label in outs}
        if not all(equal.values()):
            raise AssertionError(f"{op} at {lanes} lanes differs from the plain version: {equal}")
        ms = {"other": [], "this": []}
        for label in ("other", "this", "this", "other"):
            ms[label].append(cuda_ms(runs[label]))
        cases.append({"op": op, "lanes": lanes, "ms": ms, "equal_plain": equal})
        print(f"{CURVE} g1_{op} at {lanes} lanes: other {ms['other']} ms, this {ms['this']} ms",
              flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    result = {"card": smi, "curve": CURVE, "reps": REPS, "cases": cases,
              "ptxas": {label: b[1] for label, b in built.items()},
              "nvcc_seconds": {label: b[2] for label, b in built.items()}}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"ptxas": result["ptxas"]}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
