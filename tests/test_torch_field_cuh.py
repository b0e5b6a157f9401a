"""The arithmetic of csrc/field.cuh, built for the host with g++, against
Python integers and the host curves.

The CUDA kernels cannot run without a card, but their field and group-law
device functions are plain C++: with a stub ``cuda_runtime.h`` that defines
the CUDA qualifiers away, g++ compiles them for the CPU. A small driver reads
operands on stdin and prints results, once per curve (-DCURVE_BN254,
-DCURVE_BLS12_381, -DCURVE_BLS12_377, -DCURVE_BW6_761). The operands include
0, 1, p − 1, p − 2, R − 1 and R mod p, where the CIOS top-word carries and the
final subtraction matter (BLS12-381 r has 255 bits in 8 words). Results must
be equal and canonical (the lazy arithmetic of the mixed add: below 2p
with the right residue, canonical once stored). The fields are 8 words (BN254, the BLS12 r), 12
(BLS12-381 and BLS12-377 p, BW6-761 r) and 24 (BW6-761 p); BLS12-377's Fp2
has u² = −5, and BW6-761's G2 lies over Fp, so it runs the G1 law with G2's b.
"""

import os
import random
import re
import shutil
import subprocess

import pytest

from gnark_icicle_tpu_torch.ops.cuda import CSRC
from gnark_icicle_tpu_torch.ops.ec_t import MIXED_MIN_BLOCKS, MIXED_THREADS
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
#include <vector>
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
    else if (op == "lmul") wr(lmul(a, b));
    else if (op == "ladd") wr(ladd(a, b));
    else if (op == "lsub") wr(lsub(a, b));
    else if (op == "canon") wr(lcanon(a));
    else wr(fneg(a));
    printf("\n");
  }
}

template <class P> void f2_ops() {
  std::string op;
  while (std::cin >> op && op != "end") {
    Elt2<P> a = rd2<P>(), b = rd2<P>();
    wr2(op == "lmul" ? lmul(a, b) : fmul(a, b));
    printf("\n");
  }
}

// "b3 <b3 row> <x>": the b3 form B3 of this build applied to x (lazy, then canonical)
template <class E, class B3, class RD, class WR> void b3_ops(RD rd, WR wr) {
  std::string op;
  while (std::cin >> op && op != "end") {
    E row = rd(), x = rd();
    const B3 b3(reinterpret_cast<const uint32_t*>(&row));
    wr(lcanon(b3(x)));
    printf("\n");
  }
}

template <class E, class B3, class RD, class WR> void group_ops(RD rd, WR wr) {
  std::string op;
  while (std::cin >> op && op != "end") {
    E b3 = rd();
    E X1 = rd(), Y1 = rd(), Z1 = rd(), X2 = rd(), Y2 = rd(), Z2 = rd();
    E X3, Y3, Z3;
    if (op == "mixed") {  // the lazy mixed add of the MSM kernels, with this build's b3 form
      RegAcc<E> acc{X1, Y1, Z1};
      const RegPoint<E> q{X2, Y2};
      ec_add_mixed_lazy<E>(acc, q, B3(reinterpret_cast<const uint32_t*>(&b3)), [] {});
      X3 = lcanon(acc.X); Y3 = lcanon(acc.Y); Z3 = lcanon(acc.Z);
    } else {  // the complete add and double of every kernel, b3 by the row product
      RegPt<E> p{X1, Y1, Z1};
      RegScratch<E> s;
      if (op == "add") ec_add_to<E>(p, RegPt<E>{X2, Y2, Z2}, s, RowB3<E>{b3});
      else ec_double_in<E>(p, s, RowB3<E>{b3});
      X3 = p.X; Y3 = p.Y; Z3 = p.Z;
    }
    wr(X3); wr(Y3); wr(Z3); printf("\n");
  }
}

// "reduce <b3 row> W B V c <W B points X Y Z>": the reduction's stages as
// the kernels run them, threads and lanes one after another: the running
// sums per (window, chunk) (none for M = 1), the combine per window (serial
// runs, then the scan and the tree round by round) and Horner's warp phases
// lane by lane. Prints the W window sums, then Horner's sum.
template <class E, class B3, class RD, class WR> void reduce_ops(RD rd, WR wr) {
  std::string op;
  while (std::cin >> op && op != "end") {
    E row = rd();
    long long W, B, V;
    int c;
    std::cin >> std::dec >> W >> B >> V >> c;
    const CanonB3<B3> b3{B3(reinterpret_cast<const uint32_t*>(&row))};
    RegScratch<E> s;
    InlineOps<E, RegScratch<E>, CanonB3<B3>> ops{s, b3};
    const long long n = W * B, M = B / V, L = W * V, pw = (long long)E::N * Coord<E>::NP;
    std::vector<uint32_t> S(3 * pw * n), TA(6 * pw * L), out(3 * pw * W);
    for (long long i = 0; i < n; ++i)
      for (int k = 0; k < 3; ++k) Coord<E>::store(S.data() + k * pw * n, n, i, rd());
    const uint32_t *T = S.data(), *A = S.data();
    long long ld = n;
    if (M > 1) {
      for (long long l = 0; l < L; ++l) {
        RegPt<E> run, acc;
        reduce_run<E>(run, acc, ops, (int)M,
                      [&](int j) { return PlanePt<E>{S.data(), n, l * M + j}; });
        store_point<E>(TA.data(), L, l, run);
        store_point<E>(TA.data() + 3 * pw * L, L, l, acc);
      }
      T = TA.data();
      A = TA.data() + 3 * pw * L;
      ld = L;
    }
    const int ct = V < COMBINE_T ? (int)V : COMBINE_T, r = (int)V / ct;
    for (long long w = 0; w < W; ++w) {
      std::vector<RegPt<E>> Tt(ct), G(ct), Ac(ct), D(ct);
      for (int t = 0; t < ct; ++t) {
        const long long a = w * V + (long long)t * r;
        combine_run<E>(Tt[t], G[t], Ac[t], ops, r, [&](int i) { return PlanePt<E>{T, ld, a + i}; },
                       [&](int i) { return PlanePt<E>{A, ld, a + i}; });
      }
      for (int h = 1; h < ct; h <<= 1) {
        for (int t = 0; t + h < ct; ++t) set_point<E>(D[t], Tt[t + h]);
        for (int t = 0; t + h < ct; ++t) ops.add(Tt[t], D[t]);
      }
      for (int t = 0; t < ct; ++t)
        combine_weight<E>(Tt[t], G[t], Ac[t], ops, r > 1, t > 0, log2_pow2(r), log2_pow2(M));
      for (int h = 1; h < ct; h <<= 1)
        for (int t = 0; t < ct; t += 2 * h) ops.add(Ac[t], Ac[t + h]);
      store_point<E>(out.data(), W, w, Ac[0]);
      wr(Ac[0].X); wr(Ac[0].Y); wr(Ac[0].Z); printf("\n");
    }
    auto win = [&](long long w) { return PlanePt<E>{out.data(), W, w}; };
    E h[3] = {win(W - 1).x(), win(W - 1).y(), win(W - 1).z()}, bank[12];
    for (long long w = W - 2; w >= 0; --w) {
      for (int i = 0; i < c; ++i) {
        for (int l = 0; l < 32; ++l) hdbl_products<E>(h, bank, l);
        for (int l = 0; l < 32; ++l) hdbl_second<E>(bank, b3, l);
        for (int l = 0; l < 32; ++l) hdbl_finish<E>(h, bank, l);
      }
      for (int l = 0; l < 32; ++l) hadd_products<E>(h, win(w), bank, l);
      for (int l = 0; l < 32; ++l) hadd_second<E>(bank, b3, l);
      for (int l = 0; l < 32; ++l) hadd_finish<E>(h, bank, l);
    }
    wr(h[0]); wr(h[1]); wr(h[2]); printf("\n");
  }
}

// "ntt n tw_ld s_lo c log_t log_g dif has_mul has_sub scale_ld post_ld <x>
// <tws> [<mul>] [<sub>] [<scale>] [<post>]": one NTT pass as k_ntt_pass runs it,
// block after block, each step thread after thread; prints the output
template <class P> void ntt_ops() {
  std::string op;
  while (std::cin >> op && op != "end") {
    long long n, tw_ld, scale_ld, post_ld;
    int s_lo, c, log_t, log_g, dif, has_mul, has_sub;
    std::cin >> std::dec >> n >> tw_ld >> s_lo >> c >> log_t >> log_g >> dif >> has_mul >>
        has_sub >> scale_ld >> post_ld;
    auto plane = [&](long long m) {
      std::vector<uint32_t> v(P::N * m);
      for (long long i = 0; i < m; ++i) fstore<P>(v.data(), m, i, rd<P>());
      return v;
    };
    const auto x = plane(n), tws = plane(tw_ld);
    const auto mul = plane(has_mul ? n : 0), sub = plane(has_sub ? n : 0);
    const auto scale = plane(scale_ld), post = plane(post_ld);
    std::vector<uint32_t> out(P::N * n);
    const NttPass a{x.data(), out.data(), tws.data(), has_mul ? mul.data() : nullptr,
                    has_sub ? sub.data() : nullptr, scale_ld ? scale.data() : nullptr,
                    post_ld ? post.data() : nullptr, n, tw_ld, scale_ld, post_ld, s_lo, c,
                    log_t, log_g, dif};
    const int E = 1 << ntt_log_tile(a);
    std::vector<uint32_t> sm(P::N * E);
    for (long long blk = 0; blk < n / E; ++blk) {
      for (int e = 0; e < E; ++e) ntt_load<P>(a, sm.data(), blk, e);
      for (int k = 0; k < c; ++k) {
        const int L = dif ? c - 1 - k : k;
        const uint32_t* tw = ntt_stage_twiddles(a, blk, L);
        for (int b = 0; b < E / 2; ++b) ntt_butterfly<P>(a, sm.data(), tw, L, b);
      }
      for (int e = 0; e < E; ++e) ntt_store<P>(a, sm.data(), blk, e);
    }
    for (long long i = 0; i < n; ++i) wr(fload<P>(out.data(), n, i));
    printf("\n");
  }
}

// "dig wr bits w <wr words>": the comb's digits fb_digit of one scalar,
// windows j < ceil(bits / w)
void digit_ops() {
  std::string op;
  while (std::cin >> op && op != "end") {
    int wr, bits, w;
    std::cin >> std::dec >> wr >> bits >> w;
    std::vector<uint32_t> s(wr);
    for (int k = 0; k < wr; ++k) { unsigned long v; std::cin >> std::hex >> v; s[k] = (uint32_t)v; }
    for (int j = 0; j * w < bits; ++j) printf("%u ", fb_digit(s.data(), 1, 0, wr, bits, w, j));
    printf("\n");
  }
}

// "norm n k T <n points X Y Z>": the batch normalization as k_normalize runs
// it, thread after thread (T threads a block, k lanes a thread); prints each
// lane's plain x, y and its infinity flag
template <class E, class RD, class WR> void norm_ops(RD rd, WR wr) {
  std::string op;
  while (std::cin >> op && op != "end") {
    long long n;
    int k, T;
    std::cin >> std::dec >> n >> k >> T;
    const long long pw = (long long)E::N * Coord<E>::NP;
    std::vector<uint32_t> P(3 * pw * n), xy(2 * pw * n);
    std::vector<int32_t> inf(n);
    for (long long i = 0; i < n; ++i)
      for (int c = 0; c < 3; ++c) Coord<E>::store(P.data() + c * pw * n, n, i, rd());
    for (long long b = 0; b * T * k < n; ++b)
      for (int t = 0; t < T; ++t) {
        const long long first = b * T * k + t;
        if (first >= n) continue;
        const long long rest = (n - first + T - 1) / T;
        normalize_lanes<E>(P.data(), n, xy.data(), inf.data(), first, T, rest < k ? (int)rest : k);
      }
    for (long long i = 0; i < n; ++i) {
      wr(Coord<E>::load(xy.data(), n, i));
      wr(Coord<E>::load(xy.data() + pw * n, n, i));
      printf("%d\n", inf[i]);
    }
  }
}

// "quot n <Q_INPUTS planes of n elements> <Q_CONSTS constants> <4 values
// of 1/Z_H>": k_plonk_quotient's rows one after another; prints the n
// outputs
void quot_rows(long long n) {
  using P = CurveFr;
  std::vector<std::vector<uint32_t>> planes(Q_INPUTS, std::vector<uint32_t>(P::N * n));
  for (int k = 0; k < Q_INPUTS; ++k)
    for (long long i = 0; i < n; ++i) fstore<P>(planes[k].data(), n, i, rd<P>());
  QuotientConsts<P> consts;
  for (int k = 0; k < Q_CONSTS; ++k) consts.c[k] = rd<P>();
  std::vector<uint32_t> zh(P::N * 4);
  for (int k = 0; k < 4; ++k) fstore<P>(zh.data(), 4, k, rd<P>());
  QuotientIn in;
  for (int k = 0; k < Q_INPUTS; ++k) in.p[k] = planes[k].data();
  in.zh_inv = zh.data();
  in.n = n;
  for (long long l = 0; l < n; ++l) wr(quotient_row<P>(in, consts, l));
  printf("\n");
}

// "binv n k T <n elements>": k_fr_batch_inv's threads one after another (T
// threads a block, k lanes a thread); prints the n outputs
void binv_rows(long long n, int k, int T) {
  using P = CurveFr;
  std::vector<uint32_t> x(P::N * n), out(P::N * n);
  for (long long i = 0; i < n; ++i) fstore<P>(x.data(), n, i, rd<P>());
  for (long long b = 0; b * T * k < n; ++b)
    for (int t = 0; t < T; ++t) {
      const long long first = b * T * k + t;
      if (first >= n) continue;
      const long long rest = (n - first + T - 1) / T;
      batch_inv_lanes<P>(x.data(), n, out.data(), first, T, rest < k ? (int)rest : k);
    }
  for (long long i = 0; i < n; ++i) wr(fload<P>(out.data(), n, i));
  printf("\n");
}

// "room": ROOM4 of this build's Fp and Fr; then the chain ops above
void chain_ops() {
  std::string op;
  while (std::cin >> op && op != "end") {
    if (op == "room") {
      printf("%d %d\n", (int)CurveFp::ROOM4, (int)CurveFr::ROOM4);
      continue;
    }
    long long n;
    std::cin >> std::dec >> n;
    if (op == "quot") {
      quot_rows(n);
    } else {
      int k, T;
      std::cin >> k >> T;
      binv_rows(n, k, T);
    }
  }
}

int main() {
  std::string which;
  while (std::cin >> which) {
    if (which == "fp") field_ops<CurveFp>();
    else if (which == "ntt") ntt_ops<CurveFr>();
    else if (which == "fr") field_ops<CurveFr>();
    else if (which == "g1") group_ops<Elt<CurveFp>, G1B3>(rd<CurveFp>, wr<CurveFp>);
    else if (which == "b3g1") b3_ops<Elt<CurveFp>, G1B3>(rd<CurveFp>, wr<CurveFp>);
    else if (which == "rg1") reduce_ops<Elt<CurveFp>, G1B3>(rd<CurveFp>, wr<CurveFp>);
    else if (which == "dig") digit_ops();
    else if (which == "chain") chain_ops();
    else if (which == "ng1") norm_ops<Elt<CurveFp>>(rd<CurveFp>, wr<CurveFp>);
#if defined(CURVE_BW6_761)  // BW6-761 has no Fp2; its G2 over Fp runs the g1 law
    else if (which == "g2") group_ops<Elt<CurveFp>, TwistB3>(rd<CurveFp>, wr<CurveFp>);
    else if (which == "b3g2") b3_ops<Elt<CurveFp>, TwistB3>(rd<CurveFp>, wr<CurveFp>);
    else if (which == "rg2") reduce_ops<Elt<CurveFp>, TwistB3>(rd<CurveFp>, wr<CurveFp>);
    else if (which == "ng2") norm_ops<Elt<CurveFp>>(rd<CurveFp>, wr<CurveFp>);
#else
    else if (which == "f2") f2_ops<CurveFp>();
    else if (which == "g2") group_ops<Elt2<CurveFp>, G2B3>(rd2<CurveFp>, wr2<CurveFp>);
    else if (which == "b3g2") b3_ops<Elt2<CurveFp>, G2B3>(rd2<CurveFp>, wr2<CurveFp>);
    else if (which == "rg2") reduce_ops<Elt2<CurveFp>, G2B3>(rd2<CurveFp>, wr2<CurveFp>);
    else if (which == "ng2") norm_ops<Elt2<CurveFp>>(rd2<CurveFp>, wr2<CurveFp>);
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
    exes = {name: d / f"driver_{name}" for name in CURVES}
    procs = {name: subprocess.Popen([gxx, "-O1", "-std=c++17", f"-DCURVE_{name.upper()}",
                                     "-I", str(d), "-I", CSRC, "-o", str(exe),
                                     str(d / "driver.cpp")],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for name, exe in exes.items()}   # the four builds at once
    for name, proc in procs.items():
        out = proc.communicate(timeout=120)[0].decode()
        assert proc.returncode == 0, f"g++ failed for {name}:\n{out}"
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
    canonical. The mixed add is the kernels' lazy one with the build's b3
    form (an add chain, c·u or the row product).
    BW6-761's G2 (over Fp) runs the G1 law with G2's b3 form (12)."""
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
    lines, want = [group], []
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
    an add chain; operands at p − 1 and near R. Both the canonical product
    and the lazy one of the mixed add (below 2p, same residue)."""
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
        for op in ("mul", "lmul"):
            lines.append(f"{op} " + " ".join(_words(c * R % p, n) for c in x + y))
            want.append((op, F2(curve.tower, *x) * F2(curve.tower, *y)))
    lines.append("end")
    rinv = pow(R, -1, p)
    for line, (op, w) in zip(_run(host_build[name], lines), want, strict=True):
        c0, c1 = _ints(line, n)
        assert c0 < (p if op == "mul" else 2 * p) and c1 < (p if op == "mul" else 2 * p)
        assert (c0 * rinv % p, c1 * rinv % p) == (w.c0, w.c1)


@pytest.mark.parametrize("name", sorted(CURVES))
def test_cios_bound_holds(name):
    """2p < R = 2^(32N) for both fields of every curve: the CIOS product's
    running value stays below 2p and fits N words plus one carry word that
    ends at 0, which the kernels' final conditional subtraction assumes.
    For the base field 4p < R too: the mixed add's lazy values stay in
    [0, 2p), a lazy product of two of them is below 4p²/R + p < 2p, and a
    lazy sum below 4p fits N words (BLS12-381's 255-bit r in 8 words has no
    such room, and no lazy arithmetic)."""
    for q in (CURVES[name].fp.modulus, CURVES[name].fr.modulus):
        n = words_for(q)
        assert 2 * q < 1 << (32 * n) and q >= 1 << (32 * (n - 1))
    p = CURVES[name].fp.modulus
    assert 4 * p < 1 << (32 * words_for(p))


@pytest.mark.parametrize("name", sorted(CURVES))
def test_lazy_arithmetic_stays_below_2p(host_build, name):
    """The mixed add's lazy product (the PTX carry-chain CIOS, here its C++
    twin), sum and difference on operands anywhere in [0, 2p), edges 0, p − 1,
    p, p + 1, 2p − 1 and near R included: results below 2p with the right
    residue, and the canonicalisation before a store gives x mod p."""
    q = CURVES[name].fp.modulus
    n = words_for(q)
    R = 1 << (32 * n)
    rng = random.Random(17)
    vals = [0, 1, q - 1, q, q + 1, 2 * q - 1, 2 * q - 2, (R - 1) % q, (R - 1) % q + q]
    vals += [rng.randrange(2 * q) for _ in range(60)]
    rinv = pow(R, -1, q)
    lines, want = ["fp"], []
    for a in vals:
        for op in ("lmul", "ladd", "lsub", "canon"):
            b = rng.choice(vals)
            lines.append(f"{op} {_words(a, n)} {_words(b, n)}")
            want.append((op, {"lmul": a * b * rinv, "ladd": a + b, "lsub": a - b,
                              "canon": a}[op] % q))
    lines.append("end")
    for line, (op, w) in zip(_run(host_build[name], lines), want, strict=True):
        got = _ints(line, n)[0]
        assert got < (q if op == "canon" else 2 * q) and got % q == w, op


@pytest.mark.parametrize("name", sorted(CURVES))
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_b3_forms_match_python_ints(host_build, name, group):
    """Each build's b3 form against b3·x: the add chains of G1 (9, 12, 3, −3)
    and of BW6-761's G2 over Fp (12), BLS12-381's 12(1 + u), BLS12-377's
    c·u (two base products) and BN254's general row product over Fp2."""
    curve = ref_curve(name)
    p = curve.fp.modulus
    n = words_for(p)
    R = 1 << (32 * n)
    G = curve.g1 if group == "g1" else curve.g2
    fp2 = group == "g2" and g2_over_fp2(curve)
    F2 = type(curve.g2.generator[0])
    b3 = G.b * 3 if fp2 else 3 * G.b % p
    rng = random.Random(19)
    edge = [0, 1, p - 1, (R - 1) % p]
    xs = ([F2(curve.tower, a, b) for a in edge for b in edge] if fp2 else edge)
    xs += [F2(curve.tower, rng.randrange(p), rng.randrange(p)) if fp2 else rng.randrange(p)
           for _ in range(30)]

    def enc(c):
        if fp2:
            return _words(c.c0 * R % p, n) + " " + _words(c.c1 * R % p, n)
        return _words(c * R % p, n)

    lines = ["b3" + group] + [f"b3 {enc(b3)} {enc(x)}" for x in xs] + ["end"]
    rinv = pow(R, -1, p)
    for line, x in zip(_run(host_build[name], lines), xs, strict=True):
        words = _ints(line, n)
        assert all(v < p for v in words)
        if fp2:
            assert F2(curve.tower, *(v * rinv % p for v in words)) == b3 * x
        else:
            assert words[0] * rinv % p == b3 * x % p


def test_mixed_kernel_launch_matches_resident_lanes():
    """ops/ec_t.py counts k_mixed_accumulate's resident lanes from its launch
    (threads a block, the blocks an SM that its shared memory and at most
    255 registers a thread allow); the numbers are the header's."""
    src = open(os.path.join(CSRC, "field.cuh")).read()
    stage = src[src.index("struct Stage {"):]
    assert int(re.search(r"int T = (\d+);", stage).group(1)) == MIXED_THREADS
    assert int(re.search(r"int MIN_BLOCKS = (\d+);", stage).group(1)) == MIXED_MIN_BLOCKS
    assert "__launch_bounds__(Stage<E>::T)" in src
    assert "static_assert(MIN_BLOCKS * (bytes() + 1024) <= 228 * 1024" in stage


@pytest.mark.parametrize("name", sorted(CURVES))
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_reduction_stages_match_plain(host_build, name, group):
    """The reduction's running sums, combine (serial runs and tree) and
    Horner (the warp's phases, lane by lane) with this
    build's b3 form, against the plain versions of ops/ec_t.py, limb for
    limb: W = 2 windows of B = 4 buckets in V = 2 chunks (M = 2), of B = 8
    in V = 8 (M = 1, three tree levels), and one of B = 512 in V = 256 (M =
    2, two chunks a combine thread, seven levels), c = 2; random coordinates
    (the formulas are arithmetic, so any field elements test them) with
    identity buckets and edge values."""
    import torch

    from gnark_icicle_tpu_torch.ops.ec_t import TCurve, TCurve2
    from gnark_icicle_tpu_torch.ops.field import field_for

    curve = CURVES[name]
    p = curve.fp.modulus
    n = words_for(p)
    R = 1 << (32 * n)
    F = field_for(p)
    fp2 = group == "g2" and g2_over_fp2(curve)
    G = curve.g1 if group == "g1" else curve.g2
    tc = (TCurve2(F, curve.tower.beta, G.b * 3) if fp2 else TCurve(F, 3 * G.b % p))
    b3 = [G.b.c0 * 3 % p, G.b.c1 * 3 % p] if fp2 else [3 * G.b % p]
    rng = random.Random(23)
    edge = [0, 1, p - 1, (R - 1) % p]
    lines, want = ["r" + group], []
    for W, B, V, c in ((2, 4, 2, 2), (2, 8, 8, 2), (1, 512, 256, 2)):
        planes = [[rng.randrange(p) for _ in range(W * B)] for _ in range(tc.planes)]
        planes[0][:4] = edge
        for i in (1, W * B - 1):          # identity buckets (0 : 1 : 0)
            for k in range(tc.planes):
                planes[k][i] = 1 if k == tc.NP else 0
        words = [" ".join(_words(v * R % p, n) for v in vals) for vals in zip(*planes)]
        lines.append("reduce " + " ".join(_words(v * R % p, n) for v in b3)
                     + f" {W} {B} {V} {c} " + " ".join(words))
        S = torch.stack([F.encode(vals, "cpu") for vals in planes])
        per_window = tc.bucket_reduce(S, W, V)
        horner = tc.horner(per_window, c)
        want += [per_window[..., w] for w in range(W)] + [horner[..., 0]]
    lines.append("end")
    got = _run(host_build[name], lines)
    assert len(got) == len(want)
    for line, w in zip(got, want):
        assert _ints(line, n) == _words_of(w)


def _words_of(t) -> list:
    """(planes, n) int32 Montgomery words -> the int of each plane."""
    return [sum((int(x) & 0xFFFFFFFF) << (32 * i) for i, x in enumerate(t[k].tolist()))
            for k in range(t.shape[0])]



@pytest.mark.parametrize("name", sorted(CURVES))
def test_ntt_pass_matches_plain(host_build, name):
    """csrc/field.cuh's NTT pass (k_ntt_pass's loads, butterflies and
    stores, block after block, thread after thread) against ops/ntt.py
    ntt_pass_plain, limb for limb: the two passes of pass_split at 2^12
    (DIF with 1/n on the store, DIT with the coset powers on the load), and
    at 2^8 a pass of each position on tiles of several groups and columns,
    with computeH's pointwise (a·b − c)·den on the load and a table on the
    store, and the two passes of a batch of eight transforms of 2^5 that
    read a table of 2^5 (the twiddles' own row stride); random Montgomery
    values led by 0, 1, p − 1."""
    import torch

    from gnark_icicle_tpu_torch.ops.field import field_for
    from gnark_icicle_tpu_torch.ops.ntt import NttPass, ntt_pass_plain, pass_split

    q = CURVES[name].fr.modulus
    F = field_for(q)
    W = F.n32
    rng = random.Random(31)

    def arr(m):
        return F.encode([0, 1, q - 1][:m] + [rng.randrange(q) for _ in range(m - 3)], "cpu")

    def words(t):
        return " ".join(_words(v, W) for v in _words_of(t.T.contiguous()))

    cases = []
    for dif, p in zip((True, False), pass_split(12)):
        ops = {"post": F.const(rng.randrange(q), "cpu")} if dif else {"mul": arr(1 << 12)}
        cases.append((1 << 12, p, dif, ops))
    n = 1 << 8
    cases += [(n, NttPass(6, 2, 2, 0), True, {"mul": arr(n), "sub": arr(n),
                                               "scale": F.const(rng.randrange(q), "cpu")}),
              (n, NttPass(3, 3, 3, 0), False, {"post": arr(n)}),
              (n, NttPass(0, 3, 0, 2), True, {}),
              (n, NttPass(0, 3, 0, 2), False, {"scale": arr(n)})]
    cases = [(n_, n_, p, dif, ops) for n_, p, dif, ops in cases] + [
        (n, 32, NttPass(0, 3, 0, 0), True, {}), (n, 32, NttPass(3, 2, 1, 0), False, {})]
    lines, want = ["ntt"], []
    for n, m, p, dif, ops in cases:
        x, tws = arr(n), arr(m)
        scale, post = ops.get("scale"), ops.get("post")
        head = (f"pass {n} {m} {p.s_lo} {p.c} {p.log_t} {p.log_g} {int(dif)} "
                f"{int('mul' in ops)} "
                f"{int('sub' in ops)} {0 if scale is None else scale.shape[1]} "
                f"{0 if post is None else post.shape[1]}")
        lines.append(" ".join([head, words(x), words(tws)] + [
            words(ops[k]) for k in ("mul", "sub", "scale", "post") if k in ops]))
        want.append(ntt_pass_plain(F, x, tws, p, dif, **ops))
    lines.append("end")
    got = _run(host_build[name], lines)
    assert len(got) == len(want)
    for line, w in zip(got, want):
        assert _ints(line, W) == _words_of(w.T.contiguous())


@pytest.mark.parametrize("name", sorted(CURVES))
def test_comb_digits_match_python_ints(host_build, name):
    """The fixed-base comb's digits (field.cuh fb_digit, ops/ec_t.py
    comb_digits) against the w-bit digits of the scalar as an int, w = 3-7
    and 16 (windows that straddle two words, a top window of fewer bits):
    scalars 0, 1, r − 1, 2^k, runs of all-ones windows and random ones."""
    import torch

    from gnark_icicle_tpu_torch.ops.ec_t import comb_digits
    from gnark_icicle_tpu_torch.ops.field import ints_to_limbs32, to_lanes

    r = CURVES[name].fr.modulus
    bits, wr = r.bit_length(), words_for(r)
    rng = random.Random(37)
    vals = [0, 1, r - 1, 1 << (bits - 1), (1 << (bits - 1)) - 1, 1 << 31, 1 << 32,
            ((1 << 60) - 1) << 64] + [rng.randrange(r) for _ in range(12)]
    lines, want = ["dig"], []
    for w in (3, 4, 5, 6, 7, 16):
        J = -(-bits // w)
        digits = comb_digits(to_lanes(ints_to_limbs32(vals, wr), "cpu"), w, bits)
        for i, s in enumerate(vals):
            lines.append(f"dig {wr} {bits} {w} {_words(s, wr)}")
            ref = [(s >> (w * j)) & ((1 << w) - 1) for j in range(J)]
            assert digits[:, i].tolist() == ref
            assert sum(d << (w * j) for j, d in enumerate(ref)) == s
            want.append(ref)
    lines.append("end")
    got = [[int(v) for v in line.split()] for line in _run(host_build[name], lines)]
    assert got == want


@pytest.mark.parametrize("name", sorted(CURVES))
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_normalize_lanes_match_plain(host_build, name, group):
    """The batch normalization's threads (field.cuh normalize_lanes, thread
    after thread as k_normalize runs them) against ops/ec_t.py
    normalize_plain, limb for limb, and the flags: 300 lanes at k = 2 and
    4 (partial blocks and threads), random coordinates with Z = 0 on some
    lanes and edge values elsewhere."""
    import torch

    from gnark_icicle_tpu_torch.ops.ec_t import NORMALIZE_THREADS, TCurve, TCurve2
    from gnark_icicle_tpu_torch.ops.field import field_for

    curve = CURVES[name]
    p = curve.fp.modulus
    n = words_for(p)
    R = 1 << (32 * n)
    F = field_for(p)
    fp2 = group == "g2" and g2_over_fp2(curve)
    G = curve.g1 if group == "g1" else curve.g2
    tc = (TCurve2(F, curve.tower.beta, G.b * 3) if fp2 else TCurve(F, 3 * G.b % p))
    rng = random.Random(41)
    lanes = 300
    planes = [[rng.randrange(p) for _ in range(lanes)] for _ in range(tc.planes)]
    planes[0][:4] = [0, 1, p - 1, (R - 1) % p]
    planes[2 * tc.NP][4:8] = [1, p - 1, (R - 1) % p, R % p]     # Z (its c0)
    for i in (0, 9, 150, lanes - 1):                            # Z = 0
        for k in range(2 * tc.NP, 3 * tc.NP):
            planes[k][i] = 0
    if fp2:
        planes[2 * tc.NP][10] = 0                               # Z = (0, z1)
    P = torch.stack([F.encode(vals, "cpu") for vals in planes])
    words = " ".join(" ".join(_words(v * R % p, n) for v in vals) for vals in zip(*planes))
    lines = ["n" + group]
    want = []
    for k in (2, 4):
        lines.append(f"norm {lanes} {k} {NORMALIZE_THREADS} {words}")
        want.append(tc.normalize_plain(P, k))
    lines.append("end")
    got = _run(host_build[name], lines)
    assert len(got) == 2 * lanes
    for c, (xy, inf) in enumerate(want):
        assert inf.tolist() == [int(i in (0, 9, 150, lanes - 1)) for i in range(lanes)]
        for i in range(lanes):
            line = got[c * lanes + i].split()
            assert int(line[-1]) == inf[i]
            assert _ints(" ".join(line[:-1]), n) == _words_of(xy[:, :, i])


@pytest.mark.parametrize("name", sorted(CURVES))
def test_room4_flags_match_moduli(host_build, name):
    """ROOM4 (4p < R, which the lazy chains need) of the build's Fp and Fr:
    set for every field but BLS12-381's r."""
    got = _run(host_build[name], ["chain", "room", "end"])[0].split()
    for flag, fld in zip(got, (CURVES[name].fp, CURVES[name].fr), strict=True):
        q = fld.modulus
        assert int(flag) == int(4 * q < 1 << (32 * words_for(q)))


def _quotient_ints(v: list, c: list, zh: int, q: int) -> int:
    """PLONK's quotient row on plain values (backend/plonk/prove.py
    :186-217): v the 15 inputs in QUOTIENT_INPUTS + (xs, l1) order, c the
    7 constants."""
    A, B, C, z, zw, qk, ql, qr, qm, qo, s1, s2, s3, xs, l1 = v
    beta, gamma, alpha, bk1, bk2, alpha2, one = c
    gate = ql * A + qr * B + qm * A * B + qo * C + qk
    lhs = (A + beta * xs + gamma) * (B + bk1 * xs + gamma) * (C + bk2 * xs + gamma) * z
    rhs = (A + beta * s1 + gamma) * (B + beta * s2 + gamma) * (C + beta * s3 + gamma) * zw
    return (gate + alpha * (rhs - lhs) + alpha2 * l1 * (z - one)) * zh % q


@pytest.mark.parametrize("name", sorted(CURVES))
def test_quotient_row_matches_plain_and_ints(host_build, name):
    """k_plonk_quotient's rows (field.cuh quotient_row: canonical, the gate
    factored, 20 products) against plonk_quotient_plain (the reference's
    21 in its order) limb for limb and against Python integers: every input
    holds 0, 1, r − 1, r − 2 and values near R on rows of its own."""
    from gnark_icicle_tpu_torch.ops.field import field_for
    from gnark_icicle_tpu_torch.ops.field_t import (
        QUOTIENT_CONSTS, QUOTIENT_INPUTS, plonk_quotient_plain,
    )

    q = CURVES[name].fr.modulus
    n = words_for(q)
    R = 1 << (32 * n)
    F = field_for(q)
    rng = random.Random(43)
    rows, n_in = 64, len(QUOTIENT_INPUTS) + 2
    edge = [0, 1, q - 1, q - 2, (R - 1) % q, R % q]
    mont = [edge[i % 6:] + edge[:i % 6] + [rng.randrange(q) for _ in range(rows - 6)]
            for i in range(n_in)]
    consts = [rng.randrange(q) for _ in range(len(QUOTIENT_CONSTS) - 1)] + [R % q]
    zh = [rng.randrange(q) for _ in range(4)]
    rinv = pow(R, -1, q)
    line = (f"quot {rows} " + " ".join(_words(w, n) for plane in mont for w in plane) + " "
            + " ".join(_words(w, n) for w in consts + zh))
    want = [_quotient_ints([p[i] * rinv % q for p in mont], [c * rinv % q for c in consts],
                           zh[i % 4] * rinv % q, q) for i in range(rows)]
    dev = "cpu"
    plain = plonk_quotient_plain(
        F, [F.encode_plain(p, dev) for p in mont[:-2]], F.encode_plain(mont[-2], dev),
        F.encode_plain(mont[-1], dev), F.encode_plain(zh, dev), F.encode_plain(consts, dev))
    plain_words = F.decode_plain(plain)
    assert [w * rinv % q for w in plain_words] == want
    got = _run(host_build[name], ["chain", line, "end"])[0]
    assert _ints(got, n) == plain_words


@pytest.mark.parametrize("name", sorted(CURVES))
def test_batch_inv_lanes_match_pow(host_build, name):
    """k_fr_batch_inv's threads (field.cuh batch_inv_lanes: Montgomery's
    trick over k lanes, one Fermat chain a thread; lazy where r has room)
    against pow(x, -1, r) in Montgomery form, 0 -> 0:
    zeros at the first and the last lane of threads, a thread all zeros,
    the last block's threads with fewer than k lanes, and 1, r − 1, r − 2
    and values near R."""
    q = CURVES[name].fr.modulus
    n = words_for(q)
    R = 1 << (32 * n)
    rng = random.Random(47)
    T, k, lanes = 4, 5, 47          # blocks of 20 lanes; the last has 7
    vals = [rng.randrange(1, q) for _ in range(lanes)]
    vals[2:8] = [1, q - 1, q - 2, (R - 1) % q, R % q, 2]
    zeros = {0, 16, 22, 38, 43, 46} | {1 + 4 * i for i in range(k)}   # thread (0, 1): all
    for i in zeros:
        vals[i] = 0
    words = " ".join(_words(v, n) for v in vals)
    got = _run(host_build[name], ["chain", f"binv {lanes} {k} {T} {words}", "end"])[0]
    rinv = pow(R, -1, q)
    assert _ints(got, n) == [0 if v == 0 else pow(v * rinv % q, -1, q) * R % q for v in vals]
