#!/usr/bin/env python3
"""Setup's fixed-base batches on one CUDA card: the bit ladder against the
comb, and the comb's window and the normalization's lanes a thread.

    python3 gnark_icicle_tpu_torch/fixed_base_ab.py [--other DIR ...] [--out FILE]

For each batch of the main paths (chip_smoke.py ``slice_shapes`` "ladder":
the Chain's G1 and G2 batches on BN254, BLS12-381 and BLS12-377, the
2-chain's on BW6-761, whose G2 lies over Fp) with random scalars below r
led by 0, 1 and r − 1:

* the bit ladder, as the port ran it before the comb (host ladder 2^i·G,
  one ``*_add_mixed_masked`` launch a scalar bit with mask = the bit, then
  ``to_affine_host``), split into its parts: ladder table (host), scalar
  encoding, the device ladder, the affine conversion;
* the comb at w = 4, 5 and 6 (``*_fixed_base``; its table's host build
  once per w), each held to the ladder's affine points through
  ``*_normalize``, and ``*_normalize`` at k = 16, 32 and 64 lanes a
  thread, then the host decode (``affine_host``).

With ``--other`` the script runs an A/B in place of the above: each DIR
(another checkout, e.g. the parent unpacked by ``git archive`` into
``build/parent``) has its ``g1.cu`` and ``g2.cu`` built with nvcc beside
this checkout's libraries, and the mixed-add kernel, which the comb shares
with the MSM, is timed against theirs:
``*_bucket_accumulate`` on the lanes of each group's MSM of the path
(chip_smoke.py ``slice_shapes`` "msm": random scalars through the MSM's own
digits, sort and segments), and ``*_fixed_base`` at w = 4 where DIR has
it; each result held to this checkout's limb for limb, the order of runs
this, others, others, this.

Device times are CUDA-event means (the ladder one run of all its launches,
the comb and the normalization REPS launches after one warm-up); host
parts one run each on the host clock. Each device time stands beside its
bound (chip_smoke.py ``_bound``): 11 products a nonzero digit (×3 over
Fp2) for the comb, the kernel's products for the normalization
(``normalize_work``). JSON goes to FILE (default
``build/fixed_base_ab/results.json``) and a line per batch to stdout, with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "fixed_base_ab", "results.json")
CURVE_NAMES = ("bn254", "bls12_381", "bls12_377", "bw6_761")
WINDOWS = (4, 5, 6)
LANES = (16, 32, 64)
REPS = 5
AB_REPS = 10


def build_other(roots: list) -> tuple:
    """{(root, curve, src): ctypes library} of each root's g1.cu and g2.cu
    (g1.cu only for BW6-761), all nvcc processes at once, and their
    seconds."""
    import ctypes
    import subprocess

    from gnark_icicle_tpu_torch.ops.cuda import CURVE_SOURCES, _nvcc

    procs = {}
    for i, root in enumerate(roots):
        csrc = os.path.join(root, "gnark_icicle_tpu_torch", "csrc")
        out = os.path.join(REPO, "build", "fixed_base_ab", f"other{i}")
        os.makedirs(out, exist_ok=True)
        for curve in CURVE_NAMES:
            for src in ("g1", "g2"):
                if src not in CURVE_SOURCES[curve]:
                    continue
                lib = os.path.join(out, f"lib{src}_{curve}.so")
                cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                       "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                       f"-DCURVE_{curve.upper()}", "-I", csrc, "-o", lib,
                       os.path.join(csrc, src + ".cu")]
                procs[(root, curve, src)] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib, time.perf_counter())
    libs, seconds = {}, {}
    for key, (proc, lib, t0) in procs.items():
        log = proc.communicate()[0].decode()
        seconds[f"{key[0]}:{key[2]}_{key[1]}"] = time.perf_counter() - t0
        with open(lib + ".log", "w") as f:   # ptxas's registers and spills
            f.write(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        libs[key] = ctypes.CDLL(lib)
    return libs, seconds


def kernel_ab(name: str, ctx, libs: dict, roots: list) -> list:
    """This checkout's *_bucket_accumulate (and *_fixed_base) against each
    root's on the same inputs; rows of ms per tree."""
    import ctypes

    import torch

    from chip_smoke import _cuda_ms, _rand_dev, slice_shapes
    from gnark_icicle_tpu_torch.ops import cuda as kc
    from gnark_icicle_tpu_torch.ops.ec_t import resident_lanes
    from gnark_icicle_tpu_torch.ops.fixed_base import FixedBaseMul
    from gnark_icicle_tpu_torch.ops.msm import MSMKernel, pick_window, segment_length

    dev = ctx.device
    pre = kc.CURVES[name]
    bits = ctx.curve.fr.modulus.bit_length()
    st = torch.cuda.current_stream().cuda_stream
    rows = []
    for tag, tc, G in (("g1", ctx.g1, ctx.curve.g1), ("g2", ctx.g2, ctx.curve.g2)):
        src = tc.GROUP
        n = slice_shapes(name)["msm"][tag]
        kern = MSMKernel(tc, bits)
        scal = _rand_dev(ctx.fr, 1, n, dev)[0]
        c = pick_window(n)
        seg = segment_length(n, c, bits, resident_lanes(dev))
        order, sign, starts, counts, _, _ = kern._runs(torch.zeros(n, dtype=torch.bool, device=dev),
                                                      scal, c)
        start, count = kern._segments(starts, counts, seg)[:2]
        table = _rand_dev(ctx.fp, 2 * tc.NP, n, dev).reshape(-1, n).T.contiguous()
        L = count.shape[0]
        b3 = tc.b3_row(dev)

        def this_acc():
            acc = tc.identity(L, dev)
            tc.bucket_accumulate(acc, table, order, sign, start, count)
            return acc

        def other_acc(lib):
            fn = getattr(lib, f"{pre}{src}_bucket_accumulate")
            fn.argtypes = kc.SIGNATURES[src][f"{src}_bucket_accumulate"]
            fn.restype = ctypes.c_int

            def run():
                acc = tc.identity(L, dev)
                kc.check(fn(acc.data_ptr(), L, table.data_ptr(), order.data_ptr(),
                            sign.data_ptr(), start.data_ptr(), count.data_ptr(), b3.data_ptr(),
                            tc.group_flag, st), "bucket_accumulate")
                return acc
            return run

        fb = FixedBaseMul(tc, G, G.generator, bits, dev, w=4)
        # random words below r's top word: scalars below r
        sc = _rand_dev(ctx.fr, 1, slice_shapes(name)["ladder"][tag], dev)[0]

        def other_comb(lib):
            name_fb = f"{pre}{src}_fixed_base"
            if not hasattr(lib, name_fb):
                return None
            fn = getattr(lib, name_fb)
            fn.argtypes = kc.SIGNATURES[src][f"{src}_fixed_base"]
            fn.restype = ctypes.c_int

            def run():
                out = tc.identity(sc.shape[1], dev)
                rows = torch.empty(sc.shape[1] * -(-bits // 4), dtype=torch.int32, device=dev)
                kc.check(fn(out.data_ptr(), sc.shape[1], sc.data_ptr(), sc.shape[0], bits, 4,
                            fb.table.data_ptr(), rows.data_ptr(), b3.data_ptr(), tc.group_flag,
                            st), "fixed_base")
                return out
            return run

        cases = {"bucket_accumulate": (this_acc, [other_acc(libs[(r, name, src)]) for r in roots]),
                 "fixed_base": (lambda: fb.mul(sc), [other_comb(libs[(r, name, src)]) for r in roots])}
        for case, (mine, others) in cases.items():
            want = mine()
            times = {"this": []}
            for i, run in enumerate(others):
                if run is not None and not torch.equal(run(), want):
                    raise AssertionError(f"{name} {tag} {case}: {roots[i]} differs")
            order_runs = ["this"] + list(range(len(others))) + list(range(len(others)))[::-1] + ["this"]
            for who in order_runs:
                run = mine if who == "this" else others[who]
                if run is None:
                    continue
                times.setdefault(who if who == "this" else roots[who], []).append(
                    _cuda_ms(run, AB_REPS))
            rows.append({"curve": name, "group": tag, "case": case, "ms": times,
                         "lanes": L if case == "bucket_accumulate" else sc.shape[1]})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", nargs="*", default=[],
                    help="other checkouts to A/B the shared mixed-add kernel against")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fixed_base_ab.py: no CUDA device")
    sys.path.insert(0, REPO)
    from chip_smoke import (
        _cuda_ms, _curves, _smi, card_rates, comb_bound, normalize_bound, phase_build,
        slice_shapes,
    )
    from gnark_icicle_tpu_torch.device import DeviceCtx
    from gnark_icicle_tpu_torch.ops import cuda as kc
    from gnark_icicle_tpu_torch.ops.fixed_base import WINDOW, FixedBaseMul
    from gnark_icicle_tpu_torch.ops.field import ints_to_limbs32, to_lanes

    roots = [os.path.abspath(r) for r in args.other]
    t0 = time.perf_counter()
    built = {}
    builder = threading.Thread(target=lambda: built.update(zip(("libs", "seconds"),
                                                                 build_other(roots))))
    builder.start()
    kc.build()
    builder.join()
    phase_build(time.perf_counter() - t0)
    rates = card_rates()
    dev = torch.device("cuda", 0)
    rows, ab = [], []
    for name in CURVE_NAMES if roots else ():
        ab += kernel_ab(name, DeviceCtx(_curves()[name], dev), built["libs"], roots)

    def host_s(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    for name in () if roots else CURVE_NAMES:
        curve = _curves()[name]
        ctx = DeviceCtx(curve, dev)
        r = curve.fr.modulus
        bits = r.bit_length()
        rng = random.Random(17)
        for tag, tc, G in (("g1", ctx.g1, curve.g1), ("g2", ctx.g2, curve.g2)):
            n = slice_shapes(name)["ladder"][tag]
            vals = [0, 1, r - 1] + [rng.randrange(r) for _ in range(n - 3)]
            sc, encode_s = host_s(lambda: to_lanes(ints_to_limbs32(vals, ctx.fr.n32), dev))

            # the bit ladder (the port's setup before the comb)
            def ladder_rows():
                pows, cur = [], G.generator
                for _ in range(bits):
                    pows.append(cur)
                    cur = G.add(cur, cur)
                return tc.table(pows, dev)
            ladder, ladder_table_s = host_s(ladder_rows)
            idx = torch.zeros(n, dtype=torch.int32, device=dev)

            def bit_ladder():
                acc = tc.identity(n, dev)
                for i in range(bits):
                    bit = (sc[i // 32] >> (i % 32)) & 1
                    tc.add_mixed_masked(acc, n, ladder[i:i + 1], idx, None, bit.contiguous())
                return acc
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            acc = bit_ladder()
            end.record()
            torch.cuda.synchronize()
            ladder_ms = start.elapsed_time(end)
            want, to_affine_s = host_s(lambda: tc.to_affine_host(acc))

            # the comb at each w, the normalization at each k
            combs, xy0 = {}, None
            for w in WINDOWS:
                fb, table_s = host_s(lambda: FixedBaseMul(tc, G, G.generator, bits, dev, w=w))
                P = fb.mul(sc)
                xy, inf = tc.normalize(P)
                if xy0 is None:
                    xy0, inf0, P0 = xy, inf, P
                    got, decode_s = host_s(lambda: tc.affine_host(xy, inf))
                    if got != want:
                        raise AssertionError(f"{name} {tag}: the comb differs from the ladder")
                elif not (torch.equal(xy, xy0) and torch.equal(inf, inf0)):
                    raise AssertionError(f"{name} {tag}: w = {w} differs from w = {WINDOWS[0]}")
                bound_ms, bound_by, adds = comb_bound(rates, tc, sc, fb.table, w, bits)
                combs[w] = {"table_s": table_s, "table_rows": fb.table.shape[0],
                            "ms": _cuda_ms(lambda: fb.mul(sc), REPS), "adds": adds,
                            "bound_ms": bound_ms, "bound_by": bound_by}
            norms = {}
            for k in LANES:
                xy, inf = tc.normalize(P0, k)
                if not (torch.equal(xy, xy0) and torch.equal(inf, inf0)):
                    raise AssertionError(f"{name} {tag}: normalize at k = {k} differs")
                bound_ms, bound_by = normalize_bound(rates, tc, inf0, k)
                norms[k] = {"ms": _cuda_ms(lambda: tc.normalize(P0, k), REPS),
                            "bound_ms": bound_ms, "bound_by": bound_by}
            row = {"curve": name, "group": tag, "lanes": n, "bits": bits,
                   "chosen_w": WINDOW,
                   "ladder": {"table_s": ladder_table_s, "encode_s": encode_s,
                              "device_ms": ladder_ms, "launches": bits,
                              "to_affine_host_s": to_affine_s},
                   "comb": combs, "normalize": norms, "decode_s": decode_s}
            rows.append(row)
            print(json.dumps(row), flush=True)
    card = _smi("name,power.limit")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "rates": rates, "rows": rows, "kernel_ab": ab,
                   "other_nvcc_seconds": built.get("seconds")}, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
