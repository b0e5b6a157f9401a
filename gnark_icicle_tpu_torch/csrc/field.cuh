// Montgomery field arithmetic over N 32-bit words and the RCB16 a=0 group
// law for Hopper, for BN254 (N = 8 for both fields), BLS12-381 and BLS12-377
// (Fp: N = 12, Fr: N = 8) and BW6-761 (Fp: N = 24, Fr: N = 12).
//
// Shared by fr.cu, g1.cu and g2.cu, each built once per curve (see the end of
// this file). An element is N little-endian 32-bit limbs in Montgomery form
// with R = 2^(32N), N = ceil((bits + 1) / 32): the same value the JAX package
// holds as 2N 16-bit limbs (gnark_icicle_tpu/ops/field.py:121), so a repack
// of the bits converts between the two. Every operation returns canonical
// limbs (< p), which makes the results bit-identical to the reference's.
//
// Device layout: a batch of elements is a limb-major (N, ld) uint32 plane,
// limb k of lane i at base[k * ld + i], so that neighbouring threads read
// neighbouring words. A batch of points is a stack of such planes: G1
// projective (X, Y, Z) is (3, N, ld), G2 over Fp2 is (6, N, ld) with the
// planes x0, x1, y0, y1, z0, z1. Affine point tables for the MSM gather are
// row-major instead: one row of 2N (G1: x, y) or 4N (G2: x0, x1, y0, y1)
// words per point, so one gathered point is a contiguous 8N or 16N bytes.
//
// What bounds these kernels on the card: the 32x32->64-bit integer multiply
// rate (CIOS Montgomery: 2 * N^2 multiply-adds per product) and registers (an
// element is N registers; the G2 mixed add keeps about ten Fp2 temporaries,
// 20N registers before the multiply's own, which spills at N = 12, and so
// does the G1 mixed add at N = 24). The design answer here is the simplest
// one: one thread per lane, unrolled limb loops so the limbs stay in
// registers (at N = 24 the product's outer loop stays rolled, see fmul), and
// no shared memory.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// ---------------------------------------------------------------------------
// moduli: N words, the words of p, INV = -p^-1 mod 2^32 and, for a base
// field, BETA, the non-residue of Fp2 = Fp[u]/(u^2 - BETA)
// ---------------------------------------------------------------------------

struct FpP {
  // BN254 p = 21888242871839275222246405745257275088696311157297823662689037894645226208583
  static constexpr int N = 8;
  static constexpr int BETA = -1;
  static __device__ __forceinline__ uint32_t mod(int i) {
    switch (i) {
      case 0: return 0xd87cfd47u;
      case 1: return 0x3c208c16u;
      case 2: return 0x6871ca8du;
      case 3: return 0x97816a91u;
      case 4: return 0x8181585du;
      case 5: return 0xb85045b6u;
      case 6: return 0xe131a029u;
      default: return 0x30644e72u;
    }
  }
  static constexpr uint32_t INV = 0xe4866389u;  // -p^-1 mod 2^32
};

struct FrP {
  // BN254 r = 21888242871839275222246405745257275088548364400416034343698204186575808495617
  static constexpr int N = 8;
  static __device__ __forceinline__ uint32_t mod(int i) {
    switch (i) {
      case 0: return 0xf0000001u;
      case 1: return 0x43e1f593u;
      case 2: return 0x79b97091u;
      case 3: return 0x2833e848u;
      case 4: return 0x8181585du;
      case 5: return 0xb85045b6u;
      case 6: return 0xe131a029u;
      default: return 0x30644e72u;
    }
  }
  static constexpr uint32_t INV = 0xefffffffu;
};

struct Bls381Fp {
  // BLS12-381 p (381 bits) = 4002409555221667393417789825735904156556882819939007885332058136124031650490837864442687629129015664037894272559787
  static constexpr int N = 12;
  static constexpr int BETA = -1;
  static __device__ __forceinline__ uint32_t mod(int i) {
    switch (i) {
      case 0: return 0xffffaaabu;
      case 1: return 0xb9feffffu;
      case 2: return 0xb153ffffu;
      case 3: return 0x1eabfffeu;
      case 4: return 0xf6b0f624u;
      case 5: return 0x6730d2a0u;
      case 6: return 0xf38512bfu;
      case 7: return 0x64774b84u;
      case 8: return 0x434bacd7u;
      case 9: return 0x4b1ba7b6u;
      case 10: return 0x397fe69au;
      default: return 0x1a0111eau;
    }
  }
  static constexpr uint32_t INV = 0xfffcfffdu;
};

struct Bls381Fr {
  // BLS12-381 r (255 bits) = 52435875175126190479447740508185965837690552500527637822603658699938581184513
  static constexpr int N = 8;
  static __device__ __forceinline__ uint32_t mod(int i) {
    switch (i) {
      case 0: return 0x00000001u;
      case 1: return 0xffffffffu;
      case 2: return 0xfffe5bfeu;
      case 3: return 0x53bda402u;
      case 4: return 0x09a1d805u;
      case 5: return 0x3339d808u;
      case 6: return 0x299d7d48u;
      default: return 0x73eda753u;
    }
  }
  static constexpr uint32_t INV = 0xffffffffu;
};

struct Bls377Fp {
  // BLS12-377 p (377 bits) = 258664426012969094010652733694893533536393512754914660539884262666720468348340822774968888139573360124440321458177
  static constexpr int N = 12;
  static constexpr int BETA = -5;
  static __device__ __forceinline__ uint32_t mod(int i) {
    switch (i) {
      case 0: return 0x00000001u;
      case 1: return 0x8508c000u;
      case 2: return 0x30000000u;
      case 3: return 0x170b5d44u;
      case 4: return 0xba094800u;
      case 5: return 0x1ef3622fu;
      case 6: return 0x00f5138fu;
      case 7: return 0x1a22d9f3u;
      case 8: return 0x6ca1493bu;
      case 9: return 0xc63b05c0u;
      case 10: return 0x17c510eau;
      default: return 0x01ae3a46u;
    }
  }
  static constexpr uint32_t INV = 0xffffffffu;
};

struct Bls377Fr {
  // BLS12-377 r (253 bits) = 8444461749428370424248824938781546531375899335154063827935233455917409239041
  static constexpr int N = 8;
  static __device__ __forceinline__ uint32_t mod(int i) {
    switch (i) {
      case 0: return 0x00000001u;
      case 1: return 0x0a118000u;
      case 2: return 0xd0000001u;
      case 3: return 0x59aa76feu;
      case 4: return 0x5c37b001u;
      case 5: return 0x60b44d1eu;
      case 6: return 0x9a2ca556u;
      default: return 0x12ab655eu;
    }
  }
  static constexpr uint32_t INV = 0xffffffffu;
};

struct Bw6Fp {
  // BW6-761 p (761 bits) = 6891450384315732539396789682275657542479668912536150109513790160209623422243491736087683183289411687640864567753786613451161759120554247759349511699125301598951605099378508850372543631423596795951899700429969112842764913119068299
  // No BETA: BW6-761's G2 lies over Fp itself (a sextic twist over the base
  // field), so this field has no Fp2 and no g2.cu build.
  static constexpr int N = 24;
  static __device__ __forceinline__ uint32_t mod(int i) {
    switch (i) {
      case 0: return 0x0000008bu;
      case 1: return 0xf49d0000u;
      case 2: return 0x70000082u;
      case 3: return 0xe6913e68u;
      case 4: return 0xeaf0a437u;
      case 5: return 0x160cf8aeu;
      case 6: return 0x5667a8f8u;
      case 7: return 0x98a116c2u;
      case 8: return 0x73ebff2eu;
      case 9: return 0x71dcd3dcu;
      case 10: return 0x12f9fd90u;
      case 11: return 0x8689c8edu;
      case 12: return 0x25b42304u;
      case 13: return 0x03cebaffu;
      case 14: return 0xe584e919u;
      case 15: return 0x707ba638u;
      case 16: return 0x8087be41u;
      case 17: return 0x528275efu;
      case 18: return 0x81d14688u;
      case 19: return 0xb926186au;
      case 20: return 0x04faff3eu;
      case 21: return 0xd187c940u;
      case 22: return 0xfb83ce0au;
      default: return 0x0122e824u;
    }
  }
  static constexpr uint32_t INV = 0x8fa798ddu;
};

struct Bw6Fr {
  // BW6-761 r (377 bits): the modulus of BLS12-377's base field (the
  // 2-chain), so the words are Bls377Fp's
  static constexpr int N = 12;
  static __device__ __forceinline__ uint32_t mod(int i) { return Bls377Fp::mod(i); }
  static constexpr uint32_t INV = Bls377Fp::INV;
};

// ---------------------------------------------------------------------------
// base field element
// ---------------------------------------------------------------------------

template <class P>
struct Elt {
  static constexpr int N = P::N;
  uint32_t v[P::N];
};

// t (< 2p, with `hi` the word above the top limb) -> t mod p
template <class P>
__device__ __forceinline__ Elt<P> reduce_once(const uint32_t t[P::N], uint32_t hi) {
  Elt<P> d;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < P::N; ++j) {
    uint64_t diff = (uint64_t)t[j] - P::mod(j) - borrow;
    d.v[j] = (uint32_t)diff;
    borrow = (uint32_t)(diff >> 32) & 1u;
  }
  const bool take = (hi != 0) || (borrow == 0);
  Elt<P> r;
#pragma unroll
  for (int j = 0; j < P::N; ++j) r.v[j] = take ? d.v[j] : t[j];
  return r;
}

// CIOS Montgomery product a * b * 2^-(32N) mod p with the outer loop rolled,
// for N = 24 (BW6-761 Fp): fmul below, step for step, but the fully unrolled
// 24 x 24 product, inlined a dozen times per group-law kernel, made g1.cu's
// build minutes longer than any other and spilled more (PERF.md). The inner
// loops stay unrolled.
template <class P>
__device__ __forceinline__ Elt<P> fmul_rolled(const Elt<P>& a, const Elt<P>& b) {
  constexpr int N = P::N;
  uint32_t t[N + 2];
#pragma unroll
  for (int j = 0; j < N + 2; ++j) t[j] = 0;
#pragma unroll 1
  for (int i = 0; i < N; ++i) {
    const uint32_t bi = b.v[i];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t uv = (uint64_t)a.v[j] * bi + t[j] + c;
      t[j] = (uint32_t)uv;
      c = uv >> 32;
    }
    uint64_t uv = (uint64_t)t[N] + c;
    t[N] = (uint32_t)uv;
    t[N + 1] = (uint32_t)(uv >> 32);
    const uint32_t m = t[0] * P::INV;
    uv = (uint64_t)m * P::mod(0) + t[0];
    c = uv >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      uv = (uint64_t)m * P::mod(j) + t[j] + c;
      t[j - 1] = (uint32_t)uv;
      c = uv >> 32;
    }
    uv = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)uv;
    t[N] = t[N + 1] + (uint32_t)(uv >> 32);
  }
  return reduce_once<P>(t, t[N]);
}

// CIOS Montgomery product a * b * 2^-(32N) mod p. With a, b < p every outer
// step leaves t < 2p, held in the N words of t plus the word t[N] (t[N + 1]
// takes the carry of the product row). 2p < R for every field here (N is
// ceil((bits + 1) / 32)), so t[N] is 0 at the end; reduce_once still reads it.
template <class P>
__device__ __forceinline__ Elt<P> fmul(const Elt<P>& a, const Elt<P>& b) {
  if constexpr (P::N >= 24) {
    return fmul_rolled<P>(a, b);
  } else {
    constexpr int N = P::N;
    uint32_t t[N + 2];
#pragma unroll
    for (int j = 0; j < N + 2; ++j) t[j] = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      uint64_t c = 0;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        uint64_t uv = (uint64_t)a.v[j] * b.v[i] + t[j] + c;
        t[j] = (uint32_t)uv;
        c = uv >> 32;
      }
      uint64_t uv = (uint64_t)t[N] + c;
      t[N] = (uint32_t)uv;
      t[N + 1] = (uint32_t)(uv >> 32);
      const uint32_t m = t[0] * P::INV;
      uv = (uint64_t)m * P::mod(0) + t[0];
      c = uv >> 32;
#pragma unroll
      for (int j = 1; j < N; ++j) {
        uv = (uint64_t)m * P::mod(j) + t[j] + c;
        t[j - 1] = (uint32_t)uv;
        c = uv >> 32;
      }
      uv = (uint64_t)t[N] + c;
      t[N - 1] = (uint32_t)uv;
      t[N] = t[N + 1] + (uint32_t)(uv >> 32);
    }
    return reduce_once<P>(t, t[N]);
  }
}

template <class P>
__device__ __forceinline__ Elt<P> fadd(const Elt<P>& a, const Elt<P>& b) {
  uint32_t s[P::N];
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < P::N; ++j) {
    uint64_t uv = (uint64_t)a.v[j] + b.v[j] + c;
    s[j] = (uint32_t)uv;
    c = (uint32_t)(uv >> 32);
  }
  return reduce_once<P>(s, c);
}

template <class P>
__device__ __forceinline__ Elt<P> fsub(const Elt<P>& a, const Elt<P>& b) {
  Elt<P> d;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < P::N; ++j) {
    uint64_t diff = (uint64_t)a.v[j] - b.v[j] - borrow;
    d.v[j] = (uint32_t)diff;
    borrow = (uint32_t)(diff >> 32) & 1u;
  }
  if (borrow) {  // a < b: add p back (the carry out cancels the wrap)
    uint32_t c = 0;
#pragma unroll
    for (int j = 0; j < P::N; ++j) {
      uint64_t uv = (uint64_t)d.v[j] + P::mod(j) + c;
      d.v[j] = (uint32_t)uv;
      c = (uint32_t)(uv >> 32);
    }
  }
  return d;
}

template <class P>
__device__ __forceinline__ Elt<P> fneg(const Elt<P>& a) {
  Elt<P> z;
#pragma unroll
  for (int j = 0; j < P::N; ++j) z.v[j] = 0;
  return fsub(z, a);
}

template <class P>
__device__ __forceinline__ Elt<P> fload(const uint32_t* base, long long ld, long long lane) {
  Elt<P> e;
#pragma unroll
  for (int k = 0; k < P::N; ++k) e.v[k] = base[k * ld + lane];
  return e;
}

template <class P>
__device__ __forceinline__ void fstore(uint32_t* base, long long ld, long long lane, const Elt<P>& e) {
#pragma unroll
  for (int k = 0; k < P::N; ++k) base[k * ld + lane] = e.v[k];
}

// ---------------------------------------------------------------------------
// quadratic extension Fp2 = Fp[u]/(u^2 - BETA), BETA = -1 (BN254, BLS12-381)
// or -5 (BLS12-377)
// ---------------------------------------------------------------------------

template <class P>
struct Elt2 {
  static constexpr int N = P::N;
  Elt<P> c0, c1;
};

template <class P>
__device__ __forceinline__ Elt2<P> fmul(const Elt2<P>& a, const Elt2<P>& b) {
  static_assert(P::BETA == -1 || P::BETA == -5,
                "the Fp2 product is written for u^2 = -1 and u^2 = -5");
  // Karatsuba, 3 base products: c0 = m0 + BETA m1, c1 = (a0+a1)(b0+b1) - m0 - m1
  const Elt<P> m0 = fmul(a.c0, b.c0);
  const Elt<P> m1 = fmul(a.c1, b.c1);
  const Elt<P> m2 = fmul(fadd(a.c0, a.c1), fadd(b.c0, b.c1));
  Elt2<P> r;
  if constexpr (P::BETA == -1) {
    r.c0 = fsub(m0, m1);
  } else {
    // 5 m1 by the add chain m1 + 4 m1 (each step canonical, as the plain
    // version's DevField2._beta_term), then c0 = m0 - 5 m1
    const Elt<P> m1x2 = fadd(m1, m1);
    r.c0 = fsub(m0, fadd(m1, fadd(m1x2, m1x2)));
  }
  r.c1 = fsub(fsub(m2, m0), m1);
  return r;
}

template <class P>
__device__ __forceinline__ Elt2<P> fadd(const Elt2<P>& a, const Elt2<P>& b) {
  return Elt2<P>{fadd(a.c0, b.c0), fadd(a.c1, b.c1)};
}

template <class P>
__device__ __forceinline__ Elt2<P> fsub(const Elt2<P>& a, const Elt2<P>& b) {
  return Elt2<P>{fsub(a.c0, b.c0), fsub(a.c1, b.c1)};
}

template <class P>
__device__ __forceinline__ Elt2<P> fneg(const Elt2<P>& a) {
  return Elt2<P>{fneg(a.c0), fneg(a.c1)};
}

// ---------------------------------------------------------------------------
// loads and stores of one coordinate (NP planes) and of table rows
// ---------------------------------------------------------------------------

template <class E>
struct Coord;

template <class P>
struct Coord<Elt<P>> {
  static constexpr int NP = 1;  // planes per coordinate
  static __device__ __forceinline__ Elt<P> load(const uint32_t* plane, long long ld, long long lane) {
    return fload<P>(plane, ld, lane);
  }
  static __device__ __forceinline__ void store(uint32_t* plane, long long ld, long long lane, const Elt<P>& e) {
    fstore<P>(plane, ld, lane, e);
  }
  static __device__ __forceinline__ Elt<P> row(const uint32_t* r) {
    return fload<P>(r, 1, 0);
  }
};

template <class P>
struct Coord<Elt2<P>> {
  static constexpr int NP = 2;
  static __device__ __forceinline__ Elt2<P> load(const uint32_t* plane, long long ld, long long lane) {
    return Elt2<P>{fload<P>(plane, ld, lane), fload<P>(plane + P::N * ld, ld, lane)};
  }
  static __device__ __forceinline__ void store(uint32_t* plane, long long ld, long long lane, const Elt2<P>& e) {
    fstore<P>(plane, ld, lane, e.c0);
    fstore<P>(plane + P::N * ld, ld, lane, e.c1);
  }
  static __device__ __forceinline__ Elt2<P> row(const uint32_t* r) {
    return Elt2<P>{fload<P>(r, 1, 0), fload<P>(r + P::N, 1, 0)};
  }
};

// ---------------------------------------------------------------------------
// complete a=0 group law (Renes-Costello-Batina 2016, algorithms 7-9), the
// schedules of gnark_icicle_tpu/ops/ec.py DevCurve line for line
// ---------------------------------------------------------------------------

template <class E>
__device__ __forceinline__ void ec_add_mixed(const E& X1, const E& Y1, const E& Z1,
                                             const E& X2, const E& Y2, const E& b3,
                                             E& X3, E& Y3, E& Z3) {
  E t0 = fmul(X1, X2);
  E t1 = fmul(Y1, Y2);
  E t3 = fmul(fadd(X1, Y1), fadd(X2, Y2));
  t3 = fsub(t3, fadd(t0, t1));
  E t4 = fadd(fmul(Y2, Z1), Y1);
  E y3 = fadd(fmul(X2, Z1), X1);
  t0 = fadd(fadd(t0, t0), t0);
  E t2 = fmul(b3, Z1);
  E z3 = fadd(t1, t2);
  t1 = fsub(t1, t2);
  y3 = fmul(b3, y3);
  X3 = fsub(fmul(t3, t1), fmul(t4, y3));
  Y3 = fadd(fmul(y3, t0), fmul(t1, z3));
  Z3 = fadd(fmul(z3, t4), fmul(t0, t3));
}

template <class E>
__device__ __forceinline__ void ec_add(const E& X1, const E& Y1, const E& Z1,
                                       const E& X2, const E& Y2, const E& Z2, const E& b3,
                                       E& X3, E& Y3, E& Z3) {
  E t0 = fmul(X1, X2);
  E t1 = fmul(Y1, Y2);
  E t2 = fmul(Z1, Z2);
  E t3 = fmul(fadd(X1, Y1), fadd(X2, Y2));
  t3 = fsub(t3, fadd(t0, t1));
  E t4 = fmul(fadd(Y1, Z1), fadd(Y2, Z2));
  t4 = fsub(t4, fadd(t1, t2));
  E y3 = fmul(fadd(X1, Z1), fadd(X2, Z2));
  y3 = fsub(y3, fadd(t0, t2));
  t0 = fadd(fadd(t0, t0), t0);
  t2 = fmul(b3, t2);
  E z3 = fadd(t1, t2);
  t1 = fsub(t1, t2);
  y3 = fmul(b3, y3);
  X3 = fsub(fmul(t3, t1), fmul(t4, y3));
  Y3 = fadd(fmul(y3, t0), fmul(t1, z3));
  Z3 = fadd(fmul(z3, t4), fmul(t0, t3));
}

template <class E>
__device__ __forceinline__ void ec_double(const E& X, const E& Y, const E& Z, const E& b3,
                                          E& X3, E& Y3, E& Z3) {
  E t0 = fmul(Y, Y);
  E z3 = fadd(t0, t0);
  z3 = fadd(z3, z3);
  z3 = fadd(z3, z3);
  E t1 = fmul(Y, Z);
  E t2 = fmul(b3, fmul(Z, Z));
  E x3 = fmul(t2, z3);
  E y3 = fadd(t0, t2);
  z3 = fmul(t1, z3);
  t1 = fadd(t2, t2);
  t2 = fadd(t1, t2);
  t0 = fsub(t0, t2);
  y3 = fadd(fmul(t0, y3), x3);
  t1 = fmul(X, Y);
  x3 = fmul(t0, t1);
  X3 = fadd(x3, x3);
  Y3 = y3;
  Z3 = z3;
}

// ---------------------------------------------------------------------------
// group-law kernels over a coordinate type E (instantiated by g1.cu / g2.cu)
// ---------------------------------------------------------------------------

// acc[:, :, l] += (+-)table[idx[l]] where mask[l], for l < S, in place.
// `acc` is the (3*NP, N, ld) projective stack; the sign negates the table
// point's y (the signed-digit MSM); null sign or mask pointers mean 0 and 1.
template <class E>
__global__ void k_add_mixed_masked(uint32_t* acc, long long ld, long long S,
                                   const uint32_t* table, const int32_t* idx,
                                   const int32_t* sign, const int32_t* mask,
                                   const uint32_t* b3_row) {
  using C = Coord<E>;
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= S) return;
  if (mask != nullptr && mask[l] == 0) return;
  const long long plane = E::N * ld;
  const uint32_t* row = table + (long long)idx[l] * (2 * E::N * C::NP);
  const E X2 = C::row(row);
  E Y2 = C::row(row + E::N * C::NP);
  if (sign != nullptr && sign[l] != 0) Y2 = fneg(Y2);
  const E X1 = C::load(acc, ld, l);
  const E Y1 = C::load(acc + C::NP * plane, ld, l);
  const E Z1 = C::load(acc + 2 * C::NP * plane, ld, l);
  const E b3 = C::row(b3_row);
  E X3, Y3, Z3;
  ec_add_mixed(X1, Y1, Z1, X2, Y2, b3, X3, Y3, Z3);
  C::store(acc, ld, l, X3);
  C::store(acc + C::NP * plane, ld, l, Y3);
  C::store(acc + 2 * C::NP * plane, ld, l, Z3);
}

template <class E>
__global__ void k_add(const uint32_t* p, long long ldp, const uint32_t* q, long long ldq,
                      uint32_t* o, long long ldo, long long n, const uint32_t* b3_row) {
  using C = Coord<E>;
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= n) return;
  const long long pp = E::N * ldp * C::NP, pq = E::N * ldq * C::NP, po = E::N * ldo * C::NP;
  const E X1 = C::load(p, ldp, l), Y1 = C::load(p + pp, ldp, l), Z1 = C::load(p + 2 * pp, ldp, l);
  const E X2 = C::load(q, ldq, l), Y2 = C::load(q + pq, ldq, l), Z2 = C::load(q + 2 * pq, ldq, l);
  const E b3 = C::row(b3_row);
  E X3, Y3, Z3;
  ec_add(X1, Y1, Z1, X2, Y2, Z2, b3, X3, Y3, Z3);
  C::store(o, ldo, l, X3);
  C::store(o + po, ldo, l, Y3);
  C::store(o + 2 * po, ldo, l, Z3);
}

template <class E>
__global__ void k_double(const uint32_t* p, long long ldp, uint32_t* o, long long ldo,
                         long long n, const uint32_t* b3_row) {
  using C = Coord<E>;
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= n) return;
  const long long pp = E::N * ldp * C::NP, po = E::N * ldo * C::NP;
  const E X = C::load(p, ldp, l), Y = C::load(p + pp, ldp, l), Z = C::load(p + 2 * pp, ldp, l);
  const E b3 = C::row(b3_row);
  E X3, Y3, Z3;
  ec_double(X, Y, Z, b3, X3, Y3, Z3);
  C::store(o, ldo, l, X3);
  C::store(o + po, ldo, l, Y3);
  C::store(o + 2 * po, ldo, l, Z3);
}

static inline unsigned int n_blocks(long long n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}

// ---------------------------------------------------------------------------
// the curve of this translation unit: every .cu is built once per curve that
// needs it, with -DCURVE_<NAME> (ops/cuda.py), and names its C entries
// through ENTRY (BN254 unprefixed, the others with "<name>_")
// ---------------------------------------------------------------------------

#if defined(CURVE_BN254)
using CurveFp = FpP;
using CurveFr = FrP;
#define ENTRY(name) name
#elif defined(CURVE_BLS12_381)
using CurveFp = Bls381Fp;
using CurveFr = Bls381Fr;
#define ENTRY(name) bls12_381_##name
#elif defined(CURVE_BLS12_377)
using CurveFp = Bls377Fp;
using CurveFr = Bls377Fr;
#define ENTRY(name) bls12_377_##name
#elif defined(CURVE_BW6_761)
using CurveFp = Bw6Fp;
using CurveFr = Bw6Fr;
#define ENTRY(name) bw6_761_##name
#else
#error "build with -DCURVE_BN254, -DCURVE_BLS12_381, -DCURVE_BLS12_377 or -DCURVE_BW6_761"
#endif
