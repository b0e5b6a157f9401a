"""The arithmetic of csrc/field.cuh, built for the host with g++, against
Python integers and the host curves.

The CUDA kernels cannot run without a card, but their field and group-law
device functions are plain C++: with a stub ``cuda_runtime.h`` that defines
the CUDA qualifiers away, g++ compiles them for the CPU. A small driver reads
operands on stdin and prints results, once per curve (-DCURVE_BN254,
-DCURVE_BLS12_381, -DCURVE_BLS12_377, -DCURVE_BW6_761). The operands include
0, 1, p − 1, p − 2, R − 1 and R mod p, where the CIOS top-word carries and the
final subtraction matter (BLS12-381 r has 255 bits in 8 words). Results must
be equal and canonical. The fields are 8 words (BN254, the BLS12 r), 12
(BLS12-381 and BLS12-377 p, BW6-761 r) and 24 (BW6-761 p); BLS12-377's Fp2
has u² = −5, and BW6-761's G2 lies over Fp, so it runs the G1 law with G2's b.
"""

import random
import shutil
import subprocess

import pytest

from gnark_icicle_tpu_torch.ops.cuda import CSRC
from gnark_icicle_tpu_torch.ops.field import words_for

from test_torch_common import CURVES, g2_over_fp2, ref_curve

STUB = """#pragma once
#define __device__
#define __forceinline__ inline
#define __global__
struct Dim3Stub { unsigned x; };
static Dim3Stub blockIdx, blockDim, threadIdx;
"""

DRIVER = r"""
#include <cstdio>
#include <iostream>
#include <string>
#include "field.cuh"

template <class P> Elt<P> rd() {
  Elt<P> e;
  for (int i = 0; i < P::N; ++i) { unsigned long v; std::cin >> std::hex >> v; e.v[i] = (uint32_t)v; }
  return e;
}
template <class P> void wr(const Elt<P>& e) { for (int i = 0; i < P::N; ++i) printf("%x ", e.v[i]); }
template <class P> Elt2<P> rd2() { Elt2<P> e; e.c0 = rd<P>(); e.c1 = rd<P>(); return e; }
template <class P> void wr2(const Elt2<P>& e) { wr(e.c0); wr(e.c1); }

template <class P> void field_ops() {
  std::string op;
  while (std::cin >> op && op != "end") {
    Elt<P> a = rd<P>(), b = rd<P>();
    if (op == "mul") wr(fmul(a, b));
    else if (op == "add") wr(fadd(a, b));
    else if (op == "sub") wr(fsub(a, b));
    else wr(fneg(a));
    printf("\n");
  }
}

template <class P> void f2_ops() {
  std::string op;
  while (std::cin >> op && op != "end") {
    Elt2<P> a = rd2<P>(), b = rd2<P>();
    wr2(fmul(a, b));
    printf("\n");
  }
}

template <class E, class RD, class WR> void group_ops(RD rd, WR wr) {
  std::string op;
  while (std::cin >> op && op != "end") {
    E b3 = rd();
    E X1 = rd(), Y1 = rd(), Z1 = rd(), X2 = rd(), Y2 = rd(), Z2 = rd();
    E X3, Y3, Z3;
    if (op == "mixed") ec_add_mixed(X1, Y1, Z1, X2, Y2, b3, X3, Y3, Z3);
    else if (op == "add") ec_add(X1, Y1, Z1, X2, Y2, Z2, b3, X3, Y3, Z3);
    else ec_double(X1, Y1, Z1, b3, X3, Y3, Z3);
    wr(X3); wr(Y3); wr(Z3); printf("\n");
  }
}

int main() {
  std::string which;
  while (std::cin >> which) {
    if (which == "fp") field_ops<CurveFp>();
    else if (which == "fr") field_ops<CurveFr>();
    else if (which == "g1") group_ops<Elt<CurveFp>>(rd<CurveFp>, wr<CurveFp>);
#if !defined(CURVE_BW6_761)  // BW6-761 has no Fp2
    else if (which == "f2") f2_ops<CurveFp>();
    else group_ops<Elt2<CurveFp>>(rd2<CurveFp>, wr2<CurveFp>);
#endif
    fflush(stdout);
  }
}
"""


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """curve name -> path of the driver built with that curve's -D flag."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: field.cuh cannot be built for the host")
    d = tmp_path_factory.mktemp("field_cuh")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "driver.cpp").write_text(DRIVER)
    exes = {}
    for name in CURVES:
        exe = d / f"driver_{name}"
        subprocess.run([gxx, "-O1", "-std=c++17", f"-DCURVE_{name.upper()}",
                        "-I", str(d), "-I", CSRC, "-o", str(exe), str(d / "driver.cpp")],
                       check=True, capture_output=True, timeout=120)
        exes[name] = exe
    return exes


def _words(x: int, n: int) -> str:
    return " ".join("%x" % ((x >> (32 * i)) & 0xFFFFFFFF) for i in range(n))


def _ints(line: str, n: int) -> list:
    ws = [int(w, 16) for w in line.split()]
    return [sum(w << (32 * i) for i, w in enumerate(ws[k:k + n]))
            for k in range(0, len(ws), n)]


def _run(exe, lines: list) -> list:
    out = subprocess.run([str(exe)], input="\n".join(lines) + "\n",
                         capture_output=True, text=True, timeout=120, check=True)
    return out.stdout.splitlines()


@pytest.mark.parametrize("name", sorted(CURVES))
@pytest.mark.parametrize("fld", ["fp", "fr"])
def test_field_arithmetic_matches_python_ints(host_build, name, fld):
    curve = CURVES[name]
    q = (curve.fp if fld == "fp" else curve.fr).modulus
    n = words_for(q)
    R = 1 << (32 * n)
    rng = random.Random(5)
    vals = [0, 1, 2, q - 1, q - 2, (R - 1) % q, R % q, q >> 1, (q >> 1) + 1]
    vals += [rng.randrange(q) for _ in range(60)]
    lines, want = [fld], []
    for a in vals:
        for op in ("mul", "add", "sub", "neg"):
            b = rng.choice(vals)
            lines.append(f"{op} {_words(a, n)} {_words(b, n)}")
            want.append({"mul": a * b * pow(R, -1, q) % q, "add": (a + b) % q,
                         "sub": (a - b) % q, "neg": -a % q}[op])
    lines.append("end")
    got = [_ints(line, n)[0] for line in _run(host_build[name], lines)]
    assert got == want


@pytest.mark.parametrize("name", sorted(CURVES))
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_group_law_matches_host_curve(host_build, name, group):
    """Projective RCB add, mixed add and double against the affine group law
    of gnark_icicle_tpu.curves, on points with a random Z; every output word
    canonical.
    BW6-761's G2 (over Fp) runs the G1 law with G2's b."""
    curve = ref_curve(name)  # the JAX package's host curve
    p = curve.fp.modulus
    n = words_for(p)
    R = 1 << (32 * n)
    G = curve.g1 if group == "g1" else curve.g2
    fp2 = group == "g2" and g2_over_fp2(curve)
    F2 = type(curve.g2.generator[0])

    def enc(c):
        if fp2:
            return _words(c.c0 * R % p, n) + " " + _words(c.c1 * R % p, n)
        return _words(c * R % p, n)

    b3 = G.b * 3 if fp2 else 3 * G.b % p
    one = F2(curve.tower, 1, 0) if fp2 else 1
    rng = random.Random(9)
    lines, want = ["g2" if fp2 else "g1"], []
    for k in range(8):
        P1 = G.scalar_mul(G.generator, rng.randrange(1, curve.fr.modulus))
        P2 = P1 if k % 4 == 0 else G.scalar_mul(G.generator, rng.randrange(1, curve.fr.modulus))
        z = rng.randrange(1, p)
        Z1 = F2(curve.tower, z, 0) if fp2 else z
        X1, Y1 = (P1[0] * Z1, P1[1] * Z1) if fp2 else (P1[0] * z % p, P1[1] * z % p)
        for op in ("mixed", "add", "double"):
            lines.append(f"{op} {enc(b3)} {enc(X1)} {enc(Y1)} {enc(Z1)} "
                         f"{enc(P2[0])} {enc(P2[1])} {enc(one)}")
            want.append(G.add(P1, P2) if op != "double" else G.add(P1, P1))
    lines.append("end")
    rinv = pow(R, -1, p)
    for line, w in zip(_run(host_build[name], lines), want, strict=True):
        words = _ints(line, n)
        assert all(v < p for v in words)
        vals = [v * rinv % p for v in words]
        if fp2:
            X, Y, Z = (F2(curve.tower, vals[2 * i], vals[2 * i + 1]) for i in range(3))
            zi = Z.inv()
            assert (X * zi, Y * zi) == w
        else:
            X, Y, Z = vals
            zi = pow(Z, -1, p)
            assert (X * zi % p, Y * zi % p) == w


@pytest.mark.parametrize("name", sorted(n for n in CURVES if g2_over_fp2(CURVES[n])))
def test_fp2_product_matches_host_tower(host_build, name):
    """The Fp2 Karatsuba product against the host tower's, u² = β: −1 for
    BN254 and BLS12-381, −5 for BLS12-377, whose c0 = m0 − 5·m1 is formed by
    an add chain; operands at p − 1 and near R."""
    curve = ref_curve(name)  # the JAX package's host tower
    p = curve.fp.modulus
    n = words_for(p)
    R = 1 << (32 * n)
    F2 = type(curve.g2.generator[0])
    rng = random.Random(13)
    edge = [0, 1, p - 1, p - 2, (R - 1) % p, R % p]
    vals = [(a, b) for a in edge for b in edge]
    vals += [(rng.randrange(p), rng.randrange(p)) for _ in range(40)]
    lines, want = ["f2"], []
    for x in vals:
        y = vals[rng.randrange(len(vals))]
        lines.append("mul " + " ".join(_words(c * R % p, n) for c in x + y))
        want.append(F2(curve.tower, *x) * F2(curve.tower, *y))
    lines.append("end")
    rinv = pow(R, -1, p)
    for line, w in zip(_run(host_build[name], lines), want, strict=True):
        c0, c1 = _ints(line, n)
        assert c0 < p and c1 < p
        assert (c0 * rinv % p, c1 * rinv % p) == (w.c0, w.c1)


@pytest.mark.parametrize("name", sorted(CURVES))
def test_cios_bound_holds(name):
    """2p < R = 2^(32N) for both fields of every curve: the CIOS product's
    running value stays below 2p and fits N words plus one carry word that
    ends at 0, which the kernels' final conditional subtraction assumes."""
    for q in (CURVES[name].fp.modulus, CURVES[name].fr.modulus):
        n = words_for(q)
        assert 2 * q < 1 << (32 * n) and q >= 1 << (32 * (n - 1))
