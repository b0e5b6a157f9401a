#!/usr/bin/env python3
"""A/B of the NTT on one CUDA card: this checkout's passes (``csrc/fr.cu``
``ntt_pass``, ``ops/ntt.py`` ``Domain``) against another checkout's stage
loop (one ``ntt_stage`` launch a radix-2 stage, each scaling one
``fr_mont_mul``), and the pass split against other tile shapes.

    python3 gnark_icicle_tpu_torch/ntt_ab.py --other DIR [--out FILE]

DIR holds a checkout whose ``csrc/fr.cu`` has the ``ntt_stage`` entry (e.g.
the parent commit, unpacked with ``git archive``); its ``fr.cu`` is built
with nvcc for each curve below, while this checkout's libraries build as
``ops/cuda.py`` builds them. Cases, at the shapes of the main path: BN254
at 2^17 (PLONK's INTTs), BN254 and BLS12-381 at 2^18 (computeH) and 2^19
(PLONK's 4n coset), BW6-761 at 2^16 (the 2-chain's outer computeH). Transforms: the forward DIF
(``ntt_nat_to_rev``) and the coset INTT (``coset_intt_nat_to_rev``: the
stage loop's two scalings are two ``fr_mont_mul`` launches, the passes' one
product on the last store). Each is held to the other checkout's result
limb for limb. Times are CUDA-event means of 20 transforms after one
warm-up, in the order other, this, this, other; the tile variants
(``split_stages`` at other tile and column sizes) run after, on the same
input. The bound is the larger of one read and one write of the array over
3.35 TB/s and the (n/2)·log n twiddle products (plus n for a scaling) at
2·2N² 32-bit multiply-adds over the card's rate (chip_smoke.py
``card_rates``). JSON goes to FILE (default ``build/ntt_ab/results.json``)
and a summary to stdout, with the card's name and power limit.
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
BUILD = os.path.join(REPO, "build", "ntt_ab")
CASES = (("bn254", 17), ("bn254", 18), ("bls12_381", 18), ("bn254", 19), ("bls12_381", 19),
         ("bw6_761", 16))
VARIANTS = ((8, 3), (9, 3), (10, 3), (11, 3), (11, 4))  # (log_tile, log_cols)
REPS = 20


def build_other(root: str, curves) -> dict:
    """{curve: ctypes library of ROOT's fr.cu}, the nvcc processes together."""
    from gnark_icicle_tpu_torch.ops.cuda import _nvcc

    csrc = os.path.join(root, "gnark_icicle_tpu_torch", "csrc")
    os.makedirs(os.path.join(BUILD, "other"), exist_ok=True)
    procs = {}
    for curve in curves:
        lib = os.path.join(BUILD, "other", f"libfr_{curve}.so")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", f"-DCURVE_{curve.upper()}", "-I", csrc,
               "-o", lib, os.path.join(csrc, "fr.cu")]
        procs[curve] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib)
    libs = {}
    for curve, (proc, lib) in procs.items():
        out = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the other fr.cu for {curve}:\n{out}")
        libs[curve] = ctypes.CDLL(lib)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="a checkout with the ntt_stage entry")
    ap.add_argument("--out", default=os.path.join(BUILD, "results.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ntt_ab.py: no CUDA device")
    sys.path.insert(0, REPO)
    from chip_smoke import _bound, _cuda_ms, _rand_dev, _smi, card_rates, _curves
    from gnark_icicle_tpu_torch.ops import cuda as kc
    from gnark_icicle_tpu_torch.ops.field import field_for
    from gnark_icicle_tpu_torch.ops.ntt import domain_for, ntt_pass, split_stages

    t0 = time.perf_counter()
    kc.load_all()
    libs = build_other(os.path.abspath(args.other), sorted({c for c, _ in CASES}))
    build_s = time.perf_counter() - t0
    rates = card_rates()
    dev = torch.device("cuda", 0)
    P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    rows = []
    for curve, log_n in CASES:
        pre = kc.CURVES[curve]
        stage = getattr(libs[curve], pre + "ntt_stage")
        stage.argtypes, stage.restype = [P, I64, I64, I64, P, I64, I32, P], I32
        mul = getattr(libs[curve], pre + "fr_mont_mul")
        mul.argtypes, mul.restype = [P, P, I64, I32, P, I64, P], I32
        cv = _curves()[curve]
        F = field_for(cv.fr.modulus)
        W, n = F.n32, 1 << log_n
        dom = domain_for(F, cv.fr, log_n, dev, coset=True)
        x = _rand_dev(F, 1, n, dev)[0]
        st = torch.cuda.current_stream().cuda_stream

        def stage_loop(tw, scales=()):
            y = x.clone()
            for s in range(log_n - 1, -1, -1):
                m = 1 << s
                kc.check(stage(y.data_ptr(), n, m, n // (2 * m), tw.data_ptr(), tw.shape[1], 1,
                               st), "ntt_stage")
            for t in scales:
                z = torch.empty_like(y)
                kc.check(mul(y.data_ptr(), t.data_ptr(), t.shape[1], int(t.shape[1] == 1),
                             z.data_ptr(), n, st), "fr_mont_mul")
                y = z
            return y

        tw_f, tw_i = dom.tw_fwd.contiguous(), dom.tw_inv.contiguous()
        inv_rev = dom.bit_reverse(dom.coset_inv_pows)
        cases = {
            "ntt_nat_to_rev": (lambda: stage_loop(tw_f), lambda: dom.ntt_nat_to_rev(x), 0),
            "coset_intt_nat_to_rev": (lambda: stage_loop(tw_i, (inv_rev, dom.n_inv)),
                                      lambda: dom.coset_intt_nat_to_rev(x), n),
        }
        for tname, (old, new, extra) in cases.items():
            if not torch.equal(old(), new()):
                raise AssertionError(f"{curve} 2^{log_n} {tname}: the passes differ from the stage loop")
            times = {"other": [], "this": []}
            for label in ("other", "this", "this", "other"):
                times[label].append(_cuda_ms(old if label == "other" else new, REPS))
            products = (n // 2) * log_n + extra
            bound_ms, bound_by = _bound(rates, 2 * n * 4 * W, products, W)
            variants = {}
            if tname == "ntt_nat_to_rev":
                tws = dom._twiddles("f")
                for lt, lc in VARIANTS:
                    passes = split_stages(log_n, lt, lc)[::-1]

                    def run(passes=passes):
                        y = ntt_pass(F, x, tws, passes[0], True)
                        for p in passes[1:]:
                            ntt_pass(F, y, tws, p, True, out=y)
                        return y
                    if not torch.equal(run(), new()):
                        raise AssertionError(f"tile 2^{lt}, 2^{lc} columns differs")
                    variants[f"tile 2^{lt}, cols 2^{lc}"] = {
                        "passes": [tuple(p) for p in passes], "ms": _cuda_ms(run, REPS)}
            row = {"curve": curve, "log_n": log_n, "words": W, "transform": tname,
                   "stage_loop_ms": times["other"], "passes_ms": times["this"],
                   "bound_ms": bound_ms, "bound_by": bound_by, "variants": variants}
            rows.append(row)
            print(json.dumps(row), flush=True)
    card = _smi("name,power.limit")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "rates": rates, "build_s": build_s, "rows": rows}, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
