#!/usr/bin/env python3
"""A/B of PLONK's two Fr chains on one CUDA card: ``plonk_quotient`` and
``fr_batch_inv`` (``csrc/fr.cu``), against another checkout's quotient and
against the Fermat power the batch inversion replaced.

    python3 gnark_icicle_tpu_torch/quotient_ab.py [--other DIR] [--out FILE]

Only ``csrc/fr.cu`` is built, by nvcc processes that run together: this
checkout's as ``ops/cuda.py`` builds it (for the four curves; the port's
Fr entries run on these libraries), with ptxas's registers and spills.
First each curve's quotient and batch inversion are held to their plain
versions at its PLONK path's 4n rows (chip_smoke.py ``PLONK_LOG``), edge
values included. DIR, if given, is another checkout (e.g. the parent
unpacked with ``git archive`` into ``build/parent``) whose ``fr.cu`` is
built too: its ``plonk_quotient`` runs in the order other, this, this,
other.

Shapes, those of the PLONK path: the quotient at the 4n = 2^19 rows of
BN254 and BLS12-381, 15 random canonical inputs; the batch inversion at
2^19 lanes (every 1021st zero) against the Fermat power it replaced (one
``fr_mont_mul`` launch a product). Every result is held to this checkout's
kernel limb for limb, and that to the plain version. Then the quotient's
table build (``backend/plonk/prove.py`` ``_quotient_tables``) as the path
runs it, against the same build with the Fermat power, on the host clock
around a synchronised build. Device times are CUDA-event means of REPS
calls queued behind a spin wait (chip_smoke.py ``_cuda_ms``), each beside
its bound (``_bound``: the quotient at 21 products a row and at the
kernel's 20, the inversion at ``batch_inv_products``). JSON goes to FILE
(default ``build/quotient_ab/results.json``) and a line per case to
stdout, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(REPO, "build", "quotient_ab")
CURVE_NAMES = ("bn254", "bls12_381")
LOG_ROWS = 19
REPS = 20


def build_libs(jobs: dict) -> dict:
    """{key: (ctypes library, ptxas log lines)} of `jobs` {key: (csrc dir,
    curve)}, each fr.cu built by its own nvcc process, all at once."""
    from gnark_icicle_tpu_torch.ops.cuda import _nvcc

    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for i, (key, (csrc, curve)) in enumerate(jobs.items()):
        lib = os.path.join(BUILD, f"libfr_{i}_{curve}.so")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-DCURVE_{curve.upper()}",
               "-I", csrc, "-o", lib, os.path.join(csrc, "fr.cu")]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                      lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        out = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{out}")
        libs[key] = (ctypes.CDLL(lib), out.splitlines())
    return libs


def check(curve: str, F, tf, m: int, dev) -> None:
    """plonk_quotient and fr_batch_inv of one curve against their plain
    versions at m rows: every input led by 0, 1, r − 1, r − 2 and values
    near R (shifted a row each), zeros at the first and the last lane of
    threads and a thread all zeros."""
    import torch

    from chip_smoke import _rand_dev
    from gnark_icicle_tpu_torch.ops.field_t import (
        BATCH_INV_LANES, BATCH_INV_THREADS, QUOTIENT_CONSTS, QUOTIENT_INPUTS,
        plonk_quotient_plain,
    )

    q = F.modulus
    edge = F.encode([0, 1, q - 1, q - 2, (F.R - 1) % q, F.R % q], dev)
    n_in = len(QUOTIENT_INPUTS) + 2
    E = _rand_dev(F, n_in, m, dev)
    for i in range(n_in):
        E[i, :, i:i + 6] = edge
    zh = _rand_dev(F, 1, 4, dev)[0]
    consts = torch.cat([_rand_dev(F, 1, len(QUOTIENT_CONSTS) - 1, dev)[0], F.const(1, dev)],
                       1).contiguous()
    args = (list(E[:n_in - 2]), E[n_in - 2], E[n_in - 1], zh)
    if not torch.equal(tf.plonk_quotient(*args, consts.cpu()),
                       plonk_quotient_plain(F, *args, consts)):
        raise AssertionError(f"{curve}: plonk_quotient differs from its plain version")
    T, k = BATCH_INV_THREADS, BATCH_INV_LANES
    x = E[0].clone()
    for t in (5, T + 2, T - 1):
        x[:, t] = x[:, t + (k - 1) * T] = 0
    x[:, 7:7 + k * T:T] = 0
    if not torch.equal(tf.mont_inv(x), F.mont_inv(x)):
        raise AssertionError(f"{curve}: fr_batch_inv differs from its plain version")
    print(json.dumps({"curve": curve, "check": "plonk_quotient, fr_batch_inv", "rows": m,
                      "equal": True}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another checkout whose fr.cu has plonk_quotient")
    ap.add_argument("--out", default=os.path.join(BUILD, "results.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("quotient_ab.py: no CUDA device")
    sys.path.insert(0, REPO)
    from chip_smoke import (
        PLONK_LOG, _bound, _cuda_ms, _curves, _rand_dev, _smi, batch_inv_products, card_rates,
        kernel_regs, ptxas_kernels, _PTXAS,
    )
    plonk_prove = importlib.import_module("gnark_icicle_tpu_torch.backend.plonk.prove")
    from gnark_icicle_tpu_torch.device import DeviceCtx
    from gnark_icicle_tpu_torch.ops import cuda as kc
    from gnark_icicle_tpu_torch.ops.field import field_for, pow_by_squaring
    from gnark_icicle_tpu_torch.ops.field_t import (
        BATCH_INV_LANES, QUOTIENT_CONSTS, QUOTIENT_INPUTS, QUOTIENT_PRODUCTS, TField,
        plonk_quotient_plain,
    )
    from gnark_icicle_tpu_torch.ops.ntt import _pow_table

    t0 = time.perf_counter()
    jobs = {("this", c): (kc.CSRC, c) for c in kc.CURVES}
    if args.other:
        other = os.path.join(os.path.abspath(args.other), "gnark_icicle_tpu_torch", "csrc")
        jobs.update({("other", c): (other, c) for c in CURVE_NAMES})
        with open(os.path.join(other, "field.cuh")) as f:
            other_consts_host = "QuotientConsts" in f.read()
    libs = build_libs(jobs)
    build_s = time.perf_counter() - t0
    for c in kc.CURVES:   # the port's Fr entries launch this checkout's fr.cu
        lib, log = libs[("this", c)]
        for name, argtypes in kc.SIGNATURES["fr"].items():
            getattr(lib, kc.CURVES[c] + name).argtypes = argtypes
            getattr(lib, kc.CURVES[c] + name).restype = ctypes.c_int
        kc._libs[kc.lib_stem("fr", c)] = lib
        _PTXAS.update({(kc.lib_stem("fr", c), k): v for k, v in ptxas_kernels(log).items()})
    rates = card_rates()
    dev = torch.device("cuda", 0)
    P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    st = torch.cuda.current_stream().cuda_stream
    rows = []

    def say(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    def regs_of(lines, kernel):
        tag = f"_Z{len(kernel)}{kernel}"
        return next((v for k, v in ptxas_kernels(lines).items() if k.startswith(tag)), None)

    for curve in kc.CURVES:
        F = field_for(_curves()[curve].fr.modulus)
        check(curve, F, TField(F), 4 << PLONK_LOG[curve], dev)
    for curve in CURVE_NAMES:
        pre = kc.CURVES[curve]
        cv = _curves()[curve]
        q = cv.fr.modulus
        F = field_for(q)
        tf = TField(F)
        W, m = F.n32, 1 << LOG_ROWS
        n_in = len(QUOTIENT_INPUTS) + 2
        E = _rand_dev(F, n_in, m, dev)
        zh = _rand_dev(F, 1, 4, dev)[0]
        consts = torch.cat([_rand_dev(F, 1, len(QUOTIENT_CONSTS) - 1, dev)[0],
                            F.const(1, dev)], 1).contiguous()
        consts_host = consts.cpu()
        ptrs = (ctypes.c_void_p * n_in)(*[E[i].data_ptr() for i in range(n_in)])

        def other_quotient(lib):
            """the other checkout's entry: the constants from the host where
            its kernel takes them by value (field.cuh QuotientConsts, as this
            checkout's), else from the card"""
            fn = getattr(lib, pre + "plonk_quotient")
            fn.argtypes, fn.restype = [P, P, P, P, I64, P], I32
            c = consts_host if other_consts_host else consts

            def run():
                out = torch.empty((W, m), dtype=torch.int32, device=dev)
                kc.check(fn(ctypes.addressof(ptrs), c.data_ptr(), zh.data_ptr(),
                            out.data_ptr(), m, st), "plonk_quotient")
                return out
            return run

        def this_quotient():
            return tf.plonk_quotient(list(E[:n_in - 2]), E[n_in - 2], E[n_in - 1], zh,
                                     consts_host)

        want = this_quotient()
        plain = plonk_quotient_plain(F, list(E[:n_in - 2]), E[n_in - 2], E[n_in - 1], zh, consts)
        if not torch.equal(want, plain):
            raise AssertionError(f"{curve}: plonk_quotient differs from its plain version")
        lane = 4 * W
        q_bytes = (n_in + 1) * lane * m + 11 * lane
        bound_ms, bound_by = _bound(rates, q_bytes, 21 * m, W)
        row = {"curve": curve, "kernel": "plonk_quotient", "rows": m, "bound_ms": bound_ms,
               "bound_by": bound_by,
               "kernel_products_bound_ms": _bound(rates, q_bytes, QUOTIENT_PRODUCTS * m, W)[0],
               "this": {"ms": [], "regs": kernel_regs(kc.lib_stem("fr", curve),
                                                      "k_plonk_quotient")}}
        if args.other:
            other_run = other_quotient(libs[("other", curve)][0])
            if not torch.equal(other_run(), want):
                raise AssertionError(f"{curve}: the other checkout's plonk_quotient differs")
            row["other"] = {"ms": [], "regs": regs_of(libs[("other", curve)][1],
                                                     "k_plonk_quotient")}
            for label in ("other", "this", "this", "other"):
                row[label]["ms"].append(_cuda_ms(other_run if label == "other" else this_quotient,
                                                 REPS))
        else:
            row["this"]["ms"].append(_cuda_ms(this_quotient, REPS))
        say(row)

        # the batch inversion against the Fermat power it replaced (the
        # port's chain of fr_mont_mul)
        x = _rand_dev(F, 1, m, dev)[0]
        x[:, ::1021] = 0
        want = tf.mont_inv(x)
        if not torch.equal(want, F.mont_inv(x)):
            raise AssertionError(f"{curve}: fr_batch_inv differs from its plain version")

        def chain():
            return pow_by_squaring(tf.mont_mul, F.ones, x, q - 2)

        if not torch.equal(chain(), want):
            raise AssertionError(f"{curve}: the Fermat chain differs from fr_batch_inv")
        bound_ms, bound_by = _bound(rates, 2 * lane * m, batch_inv_products(q, x), W)
        say({"curve": curve, "kernel": "fr_batch_inv", "lanes": m, "k": BATCH_INV_LANES,
             "regs": kernel_regs(kc.lib_stem("fr", curve), "k_fr_batch_inv"),
             "ms": _cuda_ms(lambda: tf.mont_inv(x), REPS), "chain_ms": _cuda_ms(chain, 2),
             "bound_ms": bound_ms, "bound_by": bound_by})

        # the quotient's table build as the PLONK path runs it (PLONK_LOG 17),
        # against the same build with the Fermat power
        ctx = DeviceCtx(cv, dev)
        n = m // 4
        g, eta = cv.fr.multiplicative_generator, cv.fr.root_of_unity(LOG_ROWS)

        def tables_new():
            plonk_prove._DOMAIN_TABLES.clear()
            return plonk_prove._quotient_tables(ctx, n, g, eta, q)

        def tables_old():
            xs = tf.mont_mul(_pow_table(tf, F.const(eta, dev), m), F.const(g, dev))
            gn, etan = pow(g, n, q), pow(eta, n, q)
            zh_cycle = [(gn * pow(etan, t, q) - 1) % q for t in range(4)]
            zh_inv = F.encode([pow(v, -1, q) for v in zh_cycle], dev)
            zh_vals = F.encode(zh_cycle, dev).repeat(1, n)
            dens = tf.mont_mul(tf.sub(xs, F.ones(m, dev)), F.const(n, dev))
            l1 = tf.mont_mul(zh_vals, pow_by_squaring(tf.mont_mul, F.ones, dens, q - 2))
            return xs, l1, zh_inv

        if any(not torch.equal(a, b) for a, b in zip(tables_new(), tables_old(), strict=True)):
            raise AssertionError(f"{curve}: the quotient tables differ")

        def wall(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t

        launches = kc.KERNELS[pre + "fr_mont_mul"]
        before = launches.launches
        tables_new()
        new_muls = launches.launches - before
        before = launches.launches
        tables_old()
        old_muls = launches.launches - before
        say({"curve": curve, "case": "quotient tables", "rows": m,
             "new_s": [wall(tables_new) for _ in range(2)],
             "old_s": [wall(tables_old) for _ in range(2)],
             "new_device_ms": _cuda_ms(tables_new, 2), "old_device_ms": _cuda_ms(tables_old, 2),
             "fr_mont_mul_launches": {"new": new_muls, "old": old_muls}})
    card = _smi("name,power.limit")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "rates": rates, "build_s": build_s, "rows": rows}, f,
                  indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
