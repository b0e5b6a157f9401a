// Montgomery field arithmetic over N 32-bit words and the RCB16 a=0 group
// law for Hopper, for BN254 (N = 8 for both fields), BLS12-381 and BLS12-377
// (Fp: N = 12, Fr: N = 8) and BW6-761 (Fp: N = 24, Fr: N = 12).
//
// Shared by fr.cu, g1.cu and g2.cu, each built once per curve (see the end of
// this file). An element is N little-endian 32-bit limbs in Montgomery form
// with R = 2^(32N), N = ceil((bits + 1) / 32): the same value the JAX package
// holds as 2N 16-bit limbs (gnark_icicle_tpu/ops/field.py:121), so a repack
// of the bits converts between the two. Every operation returns canonical
// limbs (< p), which makes the results bit-identical to the reference's; the
// mixed add keeps its values lazily in [0, 2p) and stores canonical limbs.
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
// does the G1 mixed add at N = 24). The add, double and Fr kernels take the
// simplest design: one thread per lane, unrolled limb loops so the limbs stay
// in registers (at N = 24 the product's outer loop stays rolled, see fmul),
// no shared memory. The mixed add, the MSM's hot loop, is redesigned (see
// "lazy arithmetic" and "the staged mixed-add kernels" below): PTX carry
// chains, lazy reduction, b3 by add chains, rows prefetched into shared
// memory by cp.async, and wide accumulators staged there instead of spilled.
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
// lazy arithmetic of the mixed add (k_mixed_accumulate)
//
// Values stay in [0, 2p) between operations and are made canonical once,
// before they are stored, so stored limbs are the canonical ones of the
// functions above. That is valid because 4p < R = 2^(32N) for every field
// here (254/256, 381/384, 377/384, 761/768 bits). The product is CIOS on PTX
// carry chains: mad.lo.cc / madc.lo.cc add the low halves of a row, mad.hi.cc
// / madc.hi.cc the high halves one word up, so each 32x32 product costs two
// instructions and no 64-bit temporaries. Off the card (the host build of
// tests/test_torch_field_cuh.py) the same steps run as plain C++ with the
// carry flag held in a word of its own.
// ---------------------------------------------------------------------------

struct Carry {
  uint32_t cf;  // the carry flag of the C++ twin; on the card, CC.CF
};

#if defined(__CUDA_ARCH__)
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c, Carry&) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c, Carry&) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c, Carry&) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c, Carry&) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c, Carry&) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b, Carry&) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
#else
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c, Carry& f) {
  const uint64_t s = (uint64_t)(uint32_t)(a * b) + c;
  f.cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c, Carry& f) {
  const uint64_t s = (uint64_t)(uint32_t)(a * b) + c + f.cf;
  f.cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c, Carry& f) {
  const uint64_t s = (((uint64_t)a * b) >> 32) + c;
  f.cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c, Carry& f) {
  const uint64_t s = (((uint64_t)a * b) >> 32) + c + f.cf;
  f.cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c, Carry& f) {
  return (uint32_t)(((uint64_t)a * b) >> 32) + c + f.cf;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b, Carry& f) {
  return a + b + f.cf;
}
#endif

// word j of 2p (4p < R, so 2p has N words)
template <class P>
__device__ __forceinline__ uint32_t mod2(int j) {
  return (P::mod(j) << 1) | (j > 0 ? P::mod(j - 1) >> 31 : 0u);
}

// One outer step of CIOS on t (N words and t[N] = 0, value below a + p):
// t = (t + a * bi + m * p) / 2^32 with m = t[0] * INV mod 2^32. For a < 2p
// the sum stays below 2^(32(N+1)), so the last word of each chain takes no
// carry out, and the result is below a + p again; the division by 2^32 is
// folded into the last chain, which writes word j + 1 into word j.
template <class P>
__device__ __forceinline__ void cios_step(uint32_t (&t)[P::N + 1], const Elt<P>& a, uint32_t bi) {
  constexpr int N = P::N;
  Carry f{0};
  t[0] = mad_lo_cc(a.v[0], bi, t[0], f);
#pragma unroll
  for (int j = 1; j < N; ++j) t[j] = madc_lo_cc(a.v[j], bi, t[j], f);
  t[N] = addc(0u, 0u, f);
  t[1] = mad_hi_cc(a.v[0], bi, t[1], f);
#pragma unroll
  for (int j = 1; j < N - 1; ++j) t[j + 1] = madc_hi_cc(a.v[j], bi, t[j + 1], f);
  t[N] = madc_hi(a.v[N - 1], bi, t[N], f);
  const uint32_t m = t[0] * P::INV;
  (void)mad_lo_cc(m, P::mod(0), t[0], f);  // the low word becomes 0; its carry goes on
#pragma unroll
  for (int j = 1; j < N; ++j) t[j] = madc_lo_cc(m, P::mod(j), t[j], f);
  t[N] = addc(t[N], 0u, f);
  t[0] = mad_hi_cc(m, P::mod(0), t[1], f);
#pragma unroll
  for (int j = 1; j < N - 1; ++j) t[j] = madc_hi_cc(m, P::mod(j), t[j + 1], f);
  t[N - 1] = madc_hi(m, P::mod(N - 1), t[N], f);
  t[N] = 0;
}

// Lazy Montgomery product: a, b < 2p -> a * b * R^-1 mod p, below 2p (the
// result is below a * b / R + p < 4p^2 / R + p < 2p), with no final
// subtraction. At N = 24 the outer loop runs rolled, four steps per turn
// (b's words move down four per turn, so that no register array is indexed
// by a loop variable); fully unrolled, the 24-word product made the build
// minutes long (PERF.md).
template <class P>
__device__ __forceinline__ Elt<P> lmul(const Elt<P>& a, const Elt<P>& b) {
  constexpr int N = P::N;
  uint32_t t[N + 1];
#pragma unroll
  for (int j = 0; j <= N; ++j) t[j] = 0;
  if constexpr (N >= 24) {
    constexpr int U = 4;
    static_assert(N % U == 0, "the rolled product takes U words of b per turn");
    Elt<P> bb = b;
#pragma unroll 1
    for (int i = 0; i < N; i += U) {
#pragma unroll
      for (int k = 0; k < U; ++k) cios_step<P>(t, a, bb.v[k]);
#pragma unroll
      for (int k = 0; k < N - U; ++k) bb.v[k] = bb.v[k + U];
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) cios_step<P>(t, a, b.v[i]);
  }
  Elt<P> r;
#pragma unroll
  for (int j = 0; j < N; ++j) r.v[j] = t[j];
  return r;
}

// s (< 4p) -> s mod 2p
template <class P>
__device__ __forceinline__ Elt<P> sub_2p_if_above(const uint32_t s[P::N]) {
  Elt<P> d;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < P::N; ++j) {
    const uint64_t diff = (uint64_t)s[j] - mod2<P>(j) - borrow;
    d.v[j] = (uint32_t)diff;
    borrow = (uint32_t)(diff >> 32) & 1u;
  }
#pragma unroll
  for (int j = 0; j < P::N; ++j) d.v[j] = borrow ? s[j] : d.v[j];
  return d;
}

// a, b < 2p -> a + b, below 2p
template <class P>
__device__ __forceinline__ Elt<P> ladd(const Elt<P>& a, const Elt<P>& b) {
  uint32_t s[P::N];
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < P::N; ++j) {
    const uint64_t uv = (uint64_t)a.v[j] + b.v[j] + c;
    s[j] = (uint32_t)uv;
    c = (uint32_t)(uv >> 32);
  }
  return sub_2p_if_above<P>(s);
}

// a, b < 2p -> a - b, below 2p (2p added back where a < b, without a branch)
template <class P>
__device__ __forceinline__ Elt<P> lsub(const Elt<P>& a, const Elt<P>& b) {
  Elt<P> d;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < P::N; ++j) {
    const uint64_t diff = (uint64_t)a.v[j] - b.v[j] - borrow;
    d.v[j] = (uint32_t)diff;
    borrow = (uint32_t)(diff >> 32) & 1u;
  }
  const uint32_t mask = 0u - borrow;
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < P::N; ++j) {
    const uint64_t uv = (uint64_t)d.v[j] + (mod2<P>(j) & mask) + c;
    d.v[j] = (uint32_t)uv;
    c = (uint32_t)(uv >> 32);
  }
  return d;
}

template <class P>
__device__ __forceinline__ Elt<P> lneg(const Elt<P>& a) {
  return lsub(Elt<P>{}, a);
}

// x < 2p -> x mod p: the canonical limbs, once before a store
template <class P>
__device__ __forceinline__ Elt<P> lcanon(const Elt<P>& x) {
  return reduce_once<P>(x.v, 0u);
}

template <class P>
__device__ __forceinline__ Elt2<P> ladd(const Elt2<P>& a, const Elt2<P>& b) {
  return Elt2<P>{ladd(a.c0, b.c0), ladd(a.c1, b.c1)};
}

template <class P>
__device__ __forceinline__ Elt2<P> lsub(const Elt2<P>& a, const Elt2<P>& b) {
  return Elt2<P>{lsub(a.c0, b.c0), lsub(a.c1, b.c1)};
}

template <class P>
__device__ __forceinline__ Elt2<P> lneg(const Elt2<P>& a) {
  return Elt2<P>{lneg(a.c0), lneg(a.c1)};
}

template <class P>
__device__ __forceinline__ Elt2<P> lcanon(const Elt2<P>& x) {
  return Elt2<P>{lcanon(x.c0), lcanon(x.c1)};
}

// K * x for a small integer K by an add chain (halving K), lazily reduced
template <int K, class E>
__device__ __forceinline__ E mul_small(const E& x) {
  static_assert(K != 0, "K * x takes a nonzero K");
  if constexpr (K < 0) {
    return lneg(mul_small<-K>(x));
  } else if constexpr (K == 1) {
    return x;
  } else if constexpr (K % 2 == 0) {
    const E h = mul_small<K / 2>(x);
    return ladd(h, h);
  } else {
    return ladd(mul_small<K - 1>(x), x);
  }
}

// Fp2 Karatsuba, lazily: c0 = m0 + BETA m1 (BETA m1 by its add chain),
// c1 = (a0 + a1)(b0 + b1) - m0 - m1
template <class P>
__device__ __forceinline__ Elt2<P> lmul(const Elt2<P>& a, const Elt2<P>& b) {
  static_assert(P::BETA == -1 || P::BETA == -5,
                "the Fp2 product is written for u^2 = -1 and u^2 = -5");
  const Elt<P> m0 = lmul(a.c0, b.c0);
  const Elt<P> m1 = lmul(a.c1, b.c1);
  const Elt<P> m2 = lmul(ladd(a.c0, a.c1), ladd(b.c0, b.c1));
  return Elt2<P>{lsub(m0, mul_small<-P::BETA>(m1)), lsub(lsub(m2, m0), m1)};
}

// ---------------------------------------------------------------------------
// b3 = 3b of the mixed add, by the form the curve's b takes (each curve's
// forms are fixed at the end of this file). ROW says the form reads the b3
// row (staged once per block in shared memory by the kernels).
// ---------------------------------------------------------------------------

// b3 = K, an integer (Fp), or K (1 + u) over Fp2
template <int K>
struct B3Int {
  static constexpr bool ROW = false;
  __device__ __forceinline__ explicit B3Int(const uint32_t*) {}
  template <class P>
  __device__ __forceinline__ Elt<P> operator()(const Elt<P>& x) const {
    return mul_small<K>(x);
  }
  // K (1 + u)(x0 + x1 u) = K (x0 + BETA x1) + K (x0 + x1) u
  template <class P>
  __device__ __forceinline__ Elt2<P> operator()(const Elt2<P>& x) const {
    return Elt2<P>{mul_small<K>(lsub(x.c0, mul_small<-P::BETA>(x.c1))),
                   mul_small<K>(ladd(x.c0, x.c1))};
  }
};

// b3 = c u over Fp2: (c u)(x0 + x1 u) = BETA c x1 + c x0 u, two base products
struct B3Imag {
  static constexpr bool ROW = true;
  const uint32_t* row;
  __device__ __forceinline__ explicit B3Imag(const uint32_t* r) : row(r) {}
  template <class P>
  __device__ __forceinline__ Elt2<P> operator()(const Elt2<P>& x) const {
    const Elt<P> c = fload<P>(row + P::N, 1, 0);
    return Elt2<P>{mul_small<P::BETA>(lmul(x.c1, c)), lmul(x.c0, c)};
  }
};

// any b3: one product with the row (Fp2: Karatsuba, 3 base products)
struct B3Row {
  static constexpr bool ROW = true;
  const uint32_t* row;
  __device__ __forceinline__ explicit B3Row(const uint32_t* r) : row(r) {}
  template <class P>
  __device__ __forceinline__ Elt<P> operator()(const Elt<P>& x) const {
    return lmul(fload<P>(row, 1, 0), x);
  }
  template <class P>
  __device__ __forceinline__ Elt2<P> operator()(const Elt2<P>& x) const {
    return lmul(Elt2<P>{fload<P>(row, 1, 0), fload<P>(row + P::N, 1, 0)}, x);
  }
};

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

// The mixed add P + Q (Q affine, not infinity), lazily reduced and ordered so
// that few values are live at once: the accumulator's X1, Y1, Z1 are read
// (acc.x(), ...) only before the first write (acc.set_x), the point's x and
// y where they are used, t3, t4 (needed again only by the last six
// products) are held aside by the accumulator (acc.hold), and so are t0 and
// z3 while X3 is formed (acc.park), so that its two products run with two
// coordinates live, not four. The accessors decide where values live
// (registers, shared memory). After the point's last read, point_done()
// runs: the kernels put the next row in flight there. Same field values as
// DevCurve.add_mixed.
template <class E, class A, class Q, class B3, class Done>
__device__ __forceinline__ void ec_add_mixed_lazy(A& acc, const Q& q, const B3& b3,
                                                  Done point_done) {
  E t0 = lmul(acc.x(), q.x());
  E t1 = lmul(acc.y(), q.y());
  acc.hold(0, lsub(lmul(ladd(acc.x(), acc.y()), ladd(q.x(), q.y())), ladd(t0, t1)));  // t3
  acc.hold(1, ladd(lmul(q.y(), acc.z()), acc.y()));                                  // t4
  E y3 = ladd(lmul(q.x(), acc.z()), acc.x());
  point_done();
  const E t2 = b3(acc.z());
  t0 = mul_small<3>(t0);
  const E z3 = ladd(t1, t2);
  t1 = lsub(t1, t2);
  y3 = b3(y3);
  acc.park(0, t0);
  acc.park(1, z3);
  acc.set_x(lsub(lmul(acc.held(0), t1), lmul(acc.held(1), y3)));
  acc.set_y(ladd(lmul(y3, acc.parked(0)), lmul(t1, acc.parked(1))));
  acc.set_z(ladd(lmul(acc.parked(1), acc.held(1)), lmul(acc.parked(0), acc.held(0))));
}

// an accumulator in registers
template <class E>
struct RegAcc {
  E X, Y, Z, H[2], K[2];
  __device__ __forceinline__ E x() const { return X; }
  __device__ __forceinline__ E y() const { return Y; }
  __device__ __forceinline__ E z() const { return Z; }
  __device__ __forceinline__ void set_x(const E& v) { X = v; }
  __device__ __forceinline__ void set_y(const E& v) { Y = v; }
  __device__ __forceinline__ void set_z(const E& v) { Z = v; }
  __device__ __forceinline__ void hold(int k, const E& v) { H[k] = v; }
  __device__ __forceinline__ E held(int k) const { return H[k]; }
  __device__ __forceinline__ void park(int k, const E& v) { K[k] = v; }
  __device__ __forceinline__ E parked(int k) const { return K[k]; }
};

// an affine point in registers
template <class E>
struct RegPoint {
  E X, Y;
  __device__ __forceinline__ E x() const { return X; }
  __device__ __forceinline__ E y() const { return Y; }
};

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

#if defined(__CUDACC__)
// ---------------------------------------------------------------------------
// the staged mixed-add kernel: the MSM's bucket accumulation (one launch per
// MSM) and the masked wave step (setup's fixed-base ladders), one kernel
//
// Each thread owns one lane and adds its run of points in a loop. A row
// arrives by cp.async (16-byte chunks) in the thread's slot of shared
// memory; the mixed add reads the point's x and y from the slot where it
// uses them, so the point holds no registers, and once it has read them for
// the last time (five of its eleven products) the next row goes in flight
// into the same slot while the rest of the add computes. Where a coordinate
// is 16 words or more (G2, and G1 at N = 24), the accumulator, the held t3,
// t4 and the parked t0, z3 live in shared memory too: in registers they, the
// temporaries and the products exceed 255 registers and spill to local
// memory. A b3 row, where the form reads one, is staged once per block.
//
// Shared memory, in 16-byte chunks, chunk k of thread i at [k * T + i], so
// that a warp's 16-byte accesses are contiguous:
//   b3 row (EC chunks) | row slots (RC each) | accumulator, held, parked (7 EC each)
// At 24-word coordinates that is 110,688 bytes a block of 128 threads. An SM
// holds two blocks (MIN_BLOCKS): 128 threads at no more than 255 registers
// take half its registers, and two blocks' shared memory fits. The MSM's
// split rule counts on that (ops/ec_t.py resident_lanes). It is not passed
// to __launch_bounds__: there it raised the registers ptxas allots (110 to
// 148 at 8-word G1) and slowed the kernel (PERF.md).
// ---------------------------------------------------------------------------

template <class E>
struct Stage {
  static constexpr int EW = E::N * Coord<E>::NP;  // words of one coordinate
  static constexpr int EC = EW / 4;               // its 16-byte chunks
  static constexpr int RC = 2 * EC;               // chunks of a table row (x, y)
  static constexpr bool ACC_SMEM = EW >= 16;
  static constexpr int T = 128;                   // threads per block
  static constexpr int MIN_BLOCKS = 2;            // blocks an SM holds at least
  static_assert(EW % 4 == 0, "coordinates are whole 16-byte chunks");
  static constexpr size_t bytes() {
    return 16 * (EC + (size_t)T * (RC + (ACC_SMEM ? 7 * EC : 0)));
  }
  // an SM's 228 KB of shared memory, 1 KB of it reserved per block
  static_assert(MIN_BLOCKS * (bytes() + 1024) <= 228 * 1024,
                "MIN_BLOCKS blocks' shared memory fits an SM");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// volatile, so that the compiler reloads a staged value where it is used
// instead of holding it in registers from the first read
__device__ __forceinline__ uint4 lds16(const uint4* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(smem_addr(p)));
  return v;
}

__device__ __forceinline__ void sts16(uint4* p, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "r"(smem_addr(p)), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

// .ca, cached in L1: setup's ladders gather one row into every lane, which
// .cg (L2 only) would fetch from L2 once per warp
__device__ __forceinline__ void cp_async16(uint4* dst, const uint4* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

template <class P>
__device__ __forceinline__ uint32_t& word(Elt<P>& e, int k) { return e.v[k]; }

template <class P>
__device__ __forceinline__ uint32_t& word(Elt2<P>& e, int k) {
  return k < P::N ? e.c0.v[k] : e.c1.v[k - P::N];
}

// one coordinate at p (this thread's chunk 0), chunks T apart
template <class E>
__device__ __forceinline__ E sload(const uint4* p) {
  E e;
#pragma unroll
  for (int k = 0; k < Stage<E>::EC; ++k) {
    const uint4 v = lds16(p + k * Stage<E>::T);
    word(e, 4 * k) = v.x;
    word(e, 4 * k + 1) = v.y;
    word(e, 4 * k + 2) = v.z;
    word(e, 4 * k + 3) = v.w;
  }
  return e;
}

template <class E>
__device__ __forceinline__ void sstore(uint4* p, E e) {
#pragma unroll
  for (int k = 0; k < Stage<E>::EC; ++k)
    sts16(p + k * Stage<E>::T, make_uint4(word(e, 4 * k), word(e, 4 * k + 1),
                                          word(e, 4 * k + 2), word(e, 4 * k + 3)));
}

// an accumulator, t3, t4 held and t0, z3 parked, in this thread's shared
// memory
template <class E>
struct SmemAcc {
  uint4* p;
  static constexpr int C = Stage<E>::EC * Stage<E>::T;  // one coordinate
  __device__ __forceinline__ E x() const { return sload<E>(p); }
  __device__ __forceinline__ E y() const { return sload<E>(p + C); }
  __device__ __forceinline__ E z() const { return sload<E>(p + 2 * C); }
  __device__ __forceinline__ void set_x(const E& v) { sstore(p, v); }
  __device__ __forceinline__ void set_y(const E& v) { sstore(p + C, v); }
  __device__ __forceinline__ void set_z(const E& v) { sstore(p + 2 * C, v); }
  __device__ __forceinline__ void hold(int k, const E& v) { sstore(p + (3 + k) * C, v); }
  __device__ __forceinline__ E held(int k) const { return sload<E>(p + (3 + k) * C); }
  __device__ __forceinline__ void park(int k, const E& v) { sstore(p + (5 + k) * C, v); }
  __device__ __forceinline__ E parked(int k) const { return sload<E>(p + (5 + k) * C); }
};

// a gathered table row in this thread's slot; neg negates y (the signed digit)
template <class E>
struct SmemPoint {
  const uint4* p;
  bool neg;
  __device__ __forceinline__ E x() const { return sload<E>(p); }
  __device__ __forceinline__ E y() const {
    const E y = sload<E>(p + Stage<E>::EC * Stage<E>::T);
    return neg ? lneg(y) : y;
  }
};

// acc += sum over t < n of (-1)^neg(t) table[idx(t)], row t + 1 in flight
// during the second half of add t
template <class E, class B3, class Acc, class Idx, class Neg>
__device__ __forceinline__ void accumulate(Acc& A, int n, const uint32_t* table, Idx idx_of,
                                           Neg neg_of, uint4* slot, const B3& b3) {
  using S = Stage<E>;
  auto fetch = [&](int idx) {
    const uint4* row = reinterpret_cast<const uint4*>(table + (long long)idx * 2 * S::EW);
#pragma unroll
    for (int k = 0; k < S::RC; ++k) cp_async16(slot + k * S::T, row + k);
    cp_async_commit();
  };
  fetch(idx_of(0));
  bool neg = neg_of(0);
  int idx_next = n > 1 ? idx_of(1) : 0;
  for (int t = 0; t < n; ++t) {
    cp_async_wait_all();
    bool neg_next = false;
    ec_add_mixed_lazy<E>(A, SmemPoint<E>{slot, neg}, b3, [&] {
      if (t + 1 < n) {
        fetch(idx_next);
        neg_next = neg_of(t + 1);
        if (t + 2 < n) idx_next = idx_of(t + 2);
      }
    });
    neg = neg_next;
  }
}

// One mixed-add kernel for both entries. Lane l < L of the accumulator
// planes (stride ld) adds a run of points:
//   start given (the MSM's bucket accumulation): count[l] points at sorted
//     positions start[l] + t, acc_l += sum (-1)^sign[s] table[order[s]];
//   start null (the wave step): the one point at position l where count
//     (the mask) is nonzero, everywhere if count is null.
// A null sign means all positive. The lane's accumulator is read once and
// written once (canonical). MSM lanes come sorted by count, descending, so a
// warp's threads loop about equally long.
template <class E, class B3>
__global__ void __launch_bounds__(Stage<E>::T)
k_mixed_accumulate(uint32_t* acc, long long ld, long long L, const uint32_t* table,
                   const int32_t* order, const int32_t* sign, const long long* start,
                   const int32_t* count, const uint32_t* b3_row) {
  using S = Stage<E>;
  using C = Coord<E>;
  extern __shared__ uint4 smem[];
  uint32_t* b3s = reinterpret_cast<uint32_t*>(smem);
  if constexpr (B3::ROW) {  // before any lane returns
    for (int i = threadIdx.x; i < S::EW; i += blockDim.x) b3s[i] = b3_row[i];
    __syncthreads();
  }
  const B3 b3(b3s);
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const long long s0 = start != nullptr ? start[l] : l;
  const int n = start != nullptr ? count[l] : (count == nullptr || count[l] != 0);
  if (n <= 0) return;
  auto idx_of = [&](int t) { return order[s0 + t]; };
  auto neg_of = [&](int t) { return sign != nullptr && sign[s0 + t] != 0; };
  const long long plane = (long long)E::N * ld * C::NP;
  uint4* slot = smem + S::EC + threadIdx.x;
  if constexpr (S::ACC_SMEM) {
    SmemAcc<E> A{slot + S::RC * S::T};
    A.set_x(C::load(acc, ld, l));
    A.set_y(C::load(acc + plane, ld, l));
    A.set_z(C::load(acc + 2 * plane, ld, l));
    accumulate<E>(A, n, table, idx_of, neg_of, slot, b3);
    C::store(acc, ld, l, lcanon(A.x()));
    C::store(acc + plane, ld, l, lcanon(A.y()));
    C::store(acc + 2 * plane, ld, l, lcanon(A.z()));
  } else {
    RegAcc<E> A{C::load(acc, ld, l), C::load(acc + plane, ld, l), C::load(acc + 2 * plane, ld, l)};
    accumulate<E>(A, n, table, idx_of, neg_of, slot, b3);
    C::store(acc, ld, l, lcanon(A.X));
    C::store(acc + plane, ld, l, lcanon(A.Y));
    C::store(acc + 2 * plane, ld, l, lcanon(A.Z));
  }
}

// Launch k_mixed_accumulate<E, B3> over L lanes with its shared memory;
// above 48 KB the kernel must be allowed more first.
template <class E, class B3>
static int launch_mixed_accumulate(void* acc, long long ld, long long L, const void* table,
                                   const void* order, const void* sign, const void* start,
                                   const void* count, const void* b3, void* stream) {
  constexpr size_t bytes = Stage<E>::bytes();
  auto kernel = k_mixed_accumulate<E, B3>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  if (L > 0)
    kernel<<<n_blocks(L, Stage<E>::T), Stage<E>::T, bytes, (cudaStream_t)stream>>>(
        (uint32_t*)acc, ld, L, (const uint32_t*)table, (const int32_t*)order,
        (const int32_t*)sign, (const long long*)start, (const int32_t*)count,
        (const uint32_t*)b3);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

// ---------------------------------------------------------------------------
// the curve of this translation unit: every .cu is built once per curve that
// needs it, with -DCURVE_<NAME> (ops/cuda.py), and names its C entries
// through ENTRY (BN254 unprefixed, the others with "<name>_")
// ---------------------------------------------------------------------------

// and the b3 forms of its mixed adds: G1B3 for G1 (3b: BN254 9, BLS12-381
// 12, BLS12-377 3, BW6-761 -3), G2B3 for G2 over Fp2 (BN254: 3b / (9 + u), a
// general constant; BLS12-381: 12 (1 + u); BLS12-377: c u) and, for
// BW6-761, TwistB3 for its G2 over Fp (12), which runs the g1 entries. The
// mixed-add entries take a flag g2 (0: G1, 1: G2) and use its group's form.
#if defined(CURVE_BN254)
using CurveFp = FpP;
using CurveFr = FrP;
using G1B3 = B3Int<9>;
using G2B3 = B3Row;
#define ENTRY(name) name
#elif defined(CURVE_BLS12_381)
using CurveFp = Bls381Fp;
using CurveFr = Bls381Fr;
using G1B3 = B3Int<12>;
using G2B3 = B3Int<12>;
#define ENTRY(name) bls12_381_##name
#elif defined(CURVE_BLS12_377)
using CurveFp = Bls377Fp;
using CurveFr = Bls377Fr;
using G1B3 = B3Int<3>;
using G2B3 = B3Imag;
#define ENTRY(name) bls12_377_##name
#elif defined(CURVE_BW6_761)
using CurveFp = Bw6Fp;
using CurveFr = Bw6Fr;
using G1B3 = B3Int<-3>;
using TwistB3 = B3Int<12>;
#define ENTRY(name) bw6_761_##name
#else
#error "build with -DCURVE_BN254, -DCURVE_BLS12_381, -DCURVE_BLS12_377 or -DCURVE_BW6_761"
#endif
