#!/usr/bin/env python3
"""A/B of the port's mixed-add kernel on one CUDA card, in its one-step form
(the ``*_add_mixed_masked`` entries) and in the MSM's bucket accumulation:
this checkout's kernel against another checkout's and against variants of
this checkout's sources, all built with nvcc and timed in one process.

    python3 gnark_icicle_tpu_torch/mixed_add_ab.py --other DIR [--out FILE]

DIR holds another checkout of the repo (e.g. the parent commit, unpacked
with ``git archive``); its ``gnark_icicle_tpu_torch/csrc`` is built as it
is, and its mixed-add entries take no group flag and it has no bucket
accumulation. Variants of this checkout's ``csrc``, each made by a textual
substitution in a copy under ``build/mixed_add_ab/``:

  now        the sources as they are;
  canonical  the mixed add's lazy products, sums, differences and negations
             (lmul, ladd, lsub, lneg) replaced by the canonical ones (fmul,
             fadd, fsub, fneg), every value reduced below p after each step;
  twin       the lazy arithmetic kept, its PTX carry chains replaced by their
             plain C++ twin (the 64-bit sums the host tests build);
  t256       k_mixed_accumulate at 256 threads a block (Stage<E>::T; one
             block an SM, MIN_BLOCKS), the other's block size;
  bounds2    k_mixed_accumulate's __launch_bounds__ given the two blocks an
             SM (Stage<E>::MIN_BLOCKS) beside its threads.

Each (variant, library) pair is one nvcc process, all started together;
ptxas's lines for the mixed-add kernel are kept. Cases, for BN254 G1 (8
words), BLS12-381 G1 (12) and BN254 G2 (8, over Fp2), at the 2^17 Chain
path's widths:

  ladder       setup's fixed-base ladder step: one table row on G1's
               262,144 or G2's 131,512 lanes, a random bit as the mask, no
               sign, every index 0;
  wave_random  557,056 lanes, 131,072 table rows, random indices, signs and
               a random half of the lanes masked;
  accumulate   the bucket accumulation of the path's MSM of the group (G1:
               2^18 points, G2: 131,512), random scalars through the MSM's
               own digits, sort and segments, from the identity (not for
               the other checkout).

Every result is held to the plain PyTorch version on the same inputs,
limb for limb. Times are CUDA-event means of 20 launches after one warm-up;
the variants run in order and then in reverse order, each pass over every
case, and both passes are kept. The JSON goes to FILE (default
``build/mixed_add_ab/results.json``) and a summary to stdout, with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "gnark_icicle_tpu_torch", "csrc")
BUILD = os.path.join(REPO, "build", "mixed_add_ab")
LIBS = (("g1", "bn254"), ("g1", "bls12_381"), ("g2", "bn254"))
PREFIX = {"bn254": "", "bls12_381": "bls12_381_"}
REPS = 20


def _canonical(src: str) -> str:
    """Calls of the lazy operations -> the canonical ones; the definitions
    (``Elt<P> lmul(`` and the like) stay."""
    return re.sub(r"(?<!> )\bl(mul|add|sub|neg)\(", r"f\1(", src)


def _twin(src: str) -> str:
    old = "#if defined(__CUDA_ARCH__)\n__device__ __forceinline__ uint32_t mad_lo_cc"
    if src.count(old) != 1:
        raise RuntimeError("twin: the PTX carry chains not found once")
    return src.replace(old, "#if 0\n__device__ __forceinline__ uint32_t mad_lo_cc")


def _t256(src: str) -> str:
    for old, new in (("static constexpr int T = 128;", "static constexpr int T = 256;"),
                     ("static constexpr int MIN_BLOCKS = 2;", "static constexpr int MIN_BLOCKS = 1;")):
        if src.count(old) != 1:
            raise RuntimeError(f"t256: {old!r} not found once")
        src = src.replace(old, new)
    return src


def _bounds2(src: str) -> str:
    old = "__launch_bounds__(Stage<E>::T)"
    if src.count(old) != 1:
        raise RuntimeError(f"bounds2: {old!r} not found once")
    return src.replace(old, "__launch_bounds__(Stage<E>::T, Stage<E>::MIN_BLOCKS)")


def _variant_csrc(name: str, edit) -> str:
    out = os.path.join(BUILD, name, "csrc")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(CSRC, out)
    if edit is not None:
        path = os.path.join(out, "field.cuh")
        text = open(path).read()
        changed = edit(text)
        if changed == text:
            raise RuntimeError(f"variant {name} changed nothing")
        open(path, "w").write(changed)
    return out


def build(variants: dict) -> dict:
    """{variant: csrc dir} -> {(variant, src, curve): (library path, ptxas
    lines of the mixed-add kernel, seconds)}."""
    from gnark_icicle_tpu_torch.ops.cuda import _nvcc

    nvcc = _nvcc()
    procs = {}
    for v, csrc in variants.items():
        out = os.path.join(BUILD, v, "lib")
        os.makedirs(out, exist_ok=True)
        for src, curve in LIBS:
            lib = os.path.join(out, f"lib{src}_{curve}.so")
            log = os.path.join(out, f"{src}_{curve}.log")
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                   "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                   f"-DCURVE_{curve.upper()}", "-I", csrc, "-o", lib,
                   os.path.join(csrc, src + ".cu")]
            procs[(v, src, curve)] = (subprocess.Popen(cmd, stdout=open(log, "w"),
                                                       stderr=subprocess.STDOUT),
                                      lib, log, time.perf_counter())
    built = {}
    for key, (proc, lib, log, t0) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{open(log).read()}")
        lines = open(log).read().splitlines()
        keep, on = [], False
        for ln in lines:
            if "Compiling entry function" in ln:
                on = "mixed" in ln
            if on and ("registers" in ln or "spill" in ln):
                keep.append(ln.split("ptxas info    : ")[-1].strip())
        built[key] = (lib, keep, time.perf_counter() - t0)
    return built


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of another checkout of the repo (e.g. the parent commit)")
    ap.add_argument("--out", default=os.path.join(BUILD, "results.json"))
    args = ap.parse_args()
    sys.path.insert(0, REPO)   # run as a script from anywhere

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from gnark_icicle_tpu_torch.curves import bls12_381, bn254
    from gnark_icicle_tpu_torch.ops.ec_t import TCurve, TCurve2, resident_lanes
    from gnark_icicle_tpu_torch.ops.field import field_for
    from gnark_icicle_tpu_torch.ops.msm import MSMKernel, pick_window, segment_length

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    variants = {"other": os.path.join(os.path.abspath(args.other), "gnark_icicle_tpu_torch", "csrc"),
                "now": _variant_csrc("now", None),
                "canonical": _variant_csrc("canonical", _canonical),
                "twin": _variant_csrc("twin", _twin),
                "t256": _variant_csrc("t256", _t256),
                "bounds2": _variant_csrc("bounds2", _bounds2)}
    t0 = time.perf_counter()
    built = build(variants)
    build_s = time.perf_counter() - t0

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    curves = {"bn254": bn254.BN254, "bls12_381": bls12_381.BLS12_381}

    def rand_words(F, planes, n):
        w = torch.randint(-(1 << 31), 1 << 31, (planes, F.n32, n), dtype=torch.int64,
                          device=dev, generator=gen)
        w[:, -1] = torch.randint(0, F.modulus >> (32 * (F.n32 - 1)), (planes, n),
                                 device=dev, generator=gen)
        return w.to(torch.int32)

    def bits(n, hi=2):
        return torch.randint(0, hi, (n,), dtype=torch.int32, device=dev, generator=gen)

    results, ptxas, errors = [], {}, []
    for src, curve in LIBS:
        c = curves[curve]
        F = field_for(c.fp.modulus)
        tc = (TCurve(F, 3 * c.g1.b % c.fp.modulus) if src == "g1"
              else TCurve2(F, c.tower.beta, c.g2.b * 3))
        b3 = tc.b3_row(dev)
        ladder_lanes = 1 << 18 if src == "g1" else 131512
        one_row = rand_words(F, 2 * tc.NP, 1).reshape(-1, 1).T.contiguous()
        rows = 1 << 17
        table = rand_words(F, 2 * tc.NP, rows).reshape(-1, rows).T.contiguous()
        cases = {
            "ladder": (ladder_lanes, one_row,
                       torch.zeros(ladder_lanes, dtype=torch.int32, device=dev),
                       None, bits(ladder_lanes)),
            "wave_random": (557056, table, bits(557056, rows), bits(557056), bits(557056)),
        }
        accs = {k: rand_words(F, tc.planes, v[0]) for k, v in cases.items()}
        wants = {}
        for k, (S, tab, idx, sign, mask) in cases.items():
            want = accs[k].clone()
            tc.add_mixed_masked_plain(want, S, tab, idx, sign, mask)
            wants[k] = want
        # the path's MSM of the group: its lanes as ops/msm.py cuts them
        n_msm = 1 << 18 if src == "g1" else 131512
        r = c.fr.modulus
        scal = rand_words(field_for(r), 1, n_msm)[0]
        kern, cw = MSMKernel(tc, r.bit_length()), pick_window(n_msm)
        order, sign_s, starts, counts, _, _ = kern._runs(
            torch.zeros(n_msm, dtype=torch.bool, device=dev), scal, cw)
        seg = segment_length(n_msm, cw, r.bit_length(), resident_lanes(dev))
        start, count = kern._segments(starts, counts, seg)[:2]
        msm_table = rand_words(F, 2 * tc.NP, n_msm).reshape(-1, n_msm).T.contiguous()
        msm_args = (msm_table, order, sign_s, start, count)
        acc0 = tc.identity(count.shape[0], dev)
        want_msm = acc0.clone()
        tc.bucket_accumulate_plain(want_msm, *msm_args)
        shape = {"accumulate": {"lanes": int(count.shape[0]), "adds": int(count.sum()),
                                "longest": int(count[0]), "segment": seg}}
        libs = {}
        for v in variants:
            lib, keep, secs = built[(v, src, curve)]
            ptxas[f"{v} {src}_{curve}"] = {"ptxas": keep, "nvcc_s": round(secs, 1)}
            so = ctypes.CDLL(lib)
            f = getattr(so, f"{PREFIX[curve]}{src}_add_mixed_masked")
            f.restype = ctypes.c_int
            libs[v] = f
            if v != "other":
                g = getattr(so, f"{PREFIX[curve]}{src}_bucket_accumulate")
                g.restype = ctypes.c_int
                g.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 6
                              + [ctypes.c_int, ctypes.c_void_p])
                libs[v + " accumulate"] = g

        def accumulate(v, acc):
            tab, order_, sign_, start_, count_ = msm_args
            rc = libs[v + " accumulate"](
                acc.data_ptr(), acc.shape[2], tab.data_ptr(), order_.data_ptr(),
                sign_.data_ptr(), start_.data_ptr(), count_.data_ptr(), b3.data_ptr(),
                tc.group_flag, torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{v} {src}_{curve} accumulate: launch error {rc}")

        def call(v, acc, S, tab, idx, sign, mask):
            p = [acc.data_ptr(), acc.stride(1), S, tab.data_ptr(), idx.data_ptr(),
                 None if sign is None else sign.data_ptr(), mask.data_ptr(), b3.data_ptr()]
            p += [] if v == "other" else [tc.group_flag]
            p += [torch.cuda.current_stream(dev).cuda_stream]
            types = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_void_p] * 5
                     + ([] if v == "other" else [ctypes.c_int]) + [ctypes.c_void_p])
            libs[v].argtypes = types
            rc = libs[v](*p)
            if rc != 0:
                raise RuntimeError(f"{v} {src}_{curve}: launch error {rc}")

        runs = {}
        for v in variants:
            for k, (S, tab, idx, sign, mask) in cases.items():
                runs[(v, k)] = (lambda v=v, k=k: call(v, accs[k], *cases[k]))
                got = accs[k].clone()
                call(v, got, S, tab, idx, sign, mask)
                if not torch.equal(got, wants[k]):
                    errors.append(f"{v} {src}_{curve} {k}")
            if v != "other":
                runs[(v, "accumulate")] = (lambda v=v: accumulate(v, acc0.clone()))
                got = acc0.clone()
                accumulate(v, got)
                if not torch.equal(got, want_msm):
                    errors.append(f"{v} {src}_{curve} accumulate")
        names = list(variants)
        for p, seq in enumerate((names, names[::-1])):
            for v in seq:
                for (rv, k), run in runs.items():
                    if rv != v:
                        continue
                    run()
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(REPS):
                        run()
                    end.record()
                    torch.cuda.synchronize()
                    results.append({"lib": f"{src}_{curve}", "variant": v, "case": k,
                                    "pass": p, "ms": start.elapsed_time(end) / REPS,
                                    **shape.get(k, {})})
    out = {"card": smi, "build_s": build_s, "ptxas": ptxas, "results": results,
           "errors": errors}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(smi)
    for key, val in ptxas.items():
        print(key, val)
    for r in results:
        print(json.dumps(r))
    print(json.dumps({"errors": errors, "build_s": build_s}))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
