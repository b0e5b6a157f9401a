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
// moduli: N words, the words of p, INV = -p^-1 mod 2^32, ROOM4 = (4p < R =
// 2^(32N)), which the lazy arithmetic below needs, and, for a base field,
// BETA, the non-residue of Fp2 = Fp[u]/(u^2 - BETA)
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
  static constexpr bool ROOM4 = true;
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
  static constexpr bool ROOM4 = true;
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
  static constexpr bool ROOM4 = true;
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
  static constexpr bool ROOM4 = false;  // 4r > R: 255 bits in 8 words
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
  static constexpr bool ROOM4 = true;
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
  static constexpr bool ROOM4 = true;
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
  static constexpr bool ROOM4 = true;
};

struct Bw6Fr {
  // BW6-761 r (377 bits): the modulus of BLS12-377's base field (the
  // 2-chain), so the words are Bls377Fp's
  static constexpr int N = 12;
  static __device__ __forceinline__ uint32_t mod(int i) { return Bls377Fp::mod(i); }
  static constexpr uint32_t INV = Bls377Fp::INV;
  static constexpr bool ROOM4 = true;
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

// One outer step of CIOS on 64-bit temporaries: t = (t + a bi + m p) / 2^32
// with m = t[0] INV mod 2^32, in the N words of t plus the word t[N] (t[N +
// 1] takes the carry of the product row).
template <class P>
__device__ __forceinline__ void cios64_step(const Elt<P>& a, uint32_t bi, uint32_t (&t)[P::N + 2]) {
  constexpr int N = P::N;
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

// CIOS Montgomery product on 64-bit temporaries: t = a * b * 2^-(32N) + (a
// multiple of p), below a * b / R + p. Every outer step leaves t below a +
// p, and the step's sum stays below 2^32 (a + p), so with a + p < R nothing
// overflows the N + 2 words. ROLL = 0 unrolls the outer loop; ROLL = U
// rolls it, U steps a turn (b's words move down U a turn, so that no
// register array is indexed by a loop variable): less code for the
// scheduler to interleave, and so fewer registers live.
template <class P, int ROLL = 0>
__device__ __forceinline__ void cios64(const Elt<P>& a, const Elt<P>& b, uint32_t (&t)[P::N + 2]) {
  constexpr int N = P::N;
#pragma unroll
  for (int j = 0; j < N + 2; ++j) t[j] = 0;
  if constexpr (ROLL == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) cios64_step<P>(a, b.v[i], t);
  } else {
    static_assert(N % ROLL == 0, "the rolled product takes ROLL words of b a turn");
    Elt<P> bb = b;
#pragma unroll 1
    for (int i = 0; i < N; i += ROLL) {
#pragma unroll
      for (int k = 0; k < ROLL; ++k) cios64_step<P>(a, bb.v[k], t);
#pragma unroll
      for (int k = 0; k < N - ROLL; ++k) bb.v[k] = bb.v[k + ROLL];
    }
  }
}

// CIOS Montgomery product a * b * 2^-(32N) mod p. With a, b < p the result
// of cios64 is below 2p; 2p < R for every field here (N is ceil((bits + 1) /
// 32)), so t[N] is 0 at the end; reduce_once still reads it.
template <class P>
__device__ __forceinline__ Elt<P> fmul(const Elt<P>& a, const Elt<P>& b) {
  if constexpr (P::N >= 24) {
    return fmul_rolled<P>(a, b);
  } else {
    uint32_t t[P::N + 2];
    cios64<P>(a, b, t);
    return reduce_once<P>(t, t[P::N]);
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
// the NTT pass (fr.cu k_ntt_pass): stages s_lo .. s_lo + c - 1 of a radix-2
// transform of n = 2^log_n over a tile of 2^(log_g + c + log_t) elements in
// shared memory. The stages mix only the bits s_lo .. s_lo + c - 1 of an
// index, so the tile is G groups (bits above) x R = 2^c rows (the pass's
// bits) x T columns (the consecutive low bits lo0 .. lo0 + T - 1): tile
// element e = (g R + r) T + t is global index ((hi0 + g) << (s_lo + c)) +
// (r << s_lo) + lo0 + t. A pass with s_lo > 0 takes G = 1 and T >= 8, so each
// limb row of the tile is a run of at least 32 bytes; the pass with s_lo = 0
// takes T = 1 and G consecutive groups, one contiguous chunk. The functions
// are per-thread steps, plain C++ (tests/test_torch_field_cuh.py runs them on
// the host, thread after thread); shared memory holds the tile limb-major, E
// words a limb, so neighbouring threads touch neighbouring words.
// ---------------------------------------------------------------------------

struct NttPass {
  const uint32_t* x;      // input (N, n)
  uint32_t* out;          // output (N, n); may be x (every tile is read before it is written)
  const uint32_t* tws;    // stage-major twiddles (N, tw_ld): stage s (half-width 2^s) at
                          // columns 2^s + j, so tw_ld >= 2^(s_lo + c) and columns from
                          // there on are never read: a batch of transforms of m | n
                          // (blocks of m consecutive elements) reads a table of m
  const uint32_t* mul;    // load x * mul[i] (N, n), or null
  const uint32_t* sub;    // then - sub[i] (N, n), or null
  const uint32_t* scale;  // then * scale (N, scale_ld): column i, or 0 where scale_ld == 1; or null
  const uint32_t* post;   // store v * post (N, post_ld), as scale; or null
  long long n, tw_ld, scale_ld, post_ld;
  int s_lo, c, log_t, log_g, dif;
};

__device__ __forceinline__ int ntt_log_tile(const NttPass& a) { return a.log_g + a.c + a.log_t; }

// the first column of block blk's tile, lo0
__device__ __forceinline__ long long ntt_lo0(const NttPass& a, long long blk) {
  return (blk & ((1LL << (a.s_lo - a.log_t)) - 1)) << a.log_t;
}

// the global index of tile element e of block blk (tile-local indices are
// below 2^12, so they take 32-bit arithmetic; global ones 64-bit)
__device__ __forceinline__ long long ntt_index(const NttPass& a, long long blk, int e) {
  const long long hi0 = (blk >> (a.s_lo - a.log_t)) << a.log_g;
  const int t = e & ((1 << a.log_t) - 1), r = (e >> a.log_t) & ((1 << a.c) - 1);
  const int g = e >> (a.log_t + a.c);
  return ((hi0 + g) << (a.s_lo + a.c)) + ((long long)r << a.s_lo) + ntt_lo0(a, blk) + t;
}

// limb k of tile element e at sm[k E + e]
template <class P>
__device__ __forceinline__ Elt<P> tload(const uint32_t* sm, int E, int e) {
  Elt<P> v;
#pragma unroll
  for (int k = 0; k < P::N; ++k) v.v[k] = sm[k * E + e];
  return v;
}

template <class P>
__device__ __forceinline__ void tstore(uint32_t* sm, int E, int e, const Elt<P>& v) {
#pragma unroll
  for (int k = 0; k < P::N; ++k) sm[k * E + e] = v.v[k];
}

// v = ((x mul - sub) scale) at element e into the tile
template <class P>
__device__ __forceinline__ void ntt_load(const NttPass& a, uint32_t* sm, long long blk, int e) {
  const long long i = ntt_index(a, blk, e);
  Elt<P> v = fload<P>(a.x, a.n, i);
  if (a.mul) v = fmul(v, fload<P>(a.mul, a.n, i));
  if (a.sub) v = fsub(v, fload<P>(a.sub, a.n, i));
  if (a.scale) v = fmul(v, fload<P>(a.scale, a.scale_ld, a.scale_ld == 1 ? 0 : i));
  tstore<P>(sm, 1 << ntt_log_tile(a), e, v);
}

// the twiddles of the pass's local stage L from block blk's first column:
// tws + 2^(s_lo + L) + lo0 (see ntt_butterfly)
__device__ __forceinline__ const uint32_t* ntt_stage_twiddles(const NttPass& a, long long blk,
                                                             int L) {
  return a.tws + (1LL << (a.s_lo + L)) + ntt_lo0(a, blk);
}

// Butterfly b (of E / 2) of the pass's local stage L, stage s = s_lo + L of
// the transform (half-width m = 2^s): the pair e0, e1 = e0 + 2^(log_t + L)
// of tile elements, global i0 and i0 + m, with twiddle j = i0 mod m (tw: the
// stage's twiddles from ntt_stage_twiddles), the butterflies of
// ops/ntt.py ntt_stage_plain:
//   DIF: (a, b) -> (a + b, (a - b) w)        DIT: (a, b) -> (a + b w, a - b w)
template <class P>
__device__ __forceinline__ void ntt_butterfly(const NttPass& a, uint32_t* sm, const uint32_t* tw,
                                              int L, int b) {
  const int E = 1 << ntt_log_tile(a), p = a.log_t + L;
  const int e0 = ((b >> p) << (p + 1)) | (b & ((1 << p) - 1)), e1 = e0 | (1 << p);
  const int t = e0 & ((1 << a.log_t) - 1), r0 = (e0 >> a.log_t) & ((1 << L) - 1);
  const Elt<P> w = fload<P>(tw, a.tw_ld, ((long long)r0 << a.s_lo) + t);
  const Elt<P> x0 = tload<P>(sm, E, e0), x1 = tload<P>(sm, E, e1);
  if (a.dif) {
    tstore<P>(sm, E, e0, fadd(x0, x1));
    tstore<P>(sm, E, e1, fmul(fsub(x0, x1), w));
  } else {
    const Elt<P> xw = fmul(x1, w);
    tstore<P>(sm, E, e0, fadd(x0, xw));
    tstore<P>(sm, E, e1, fsub(x0, xw));
  }
}

// element e of the tile, times post, to out
template <class P>
__device__ __forceinline__ void ntt_store(const NttPass& a, const uint32_t* sm, long long blk,
                                          int e) {
  const long long i = ntt_index(a, blk, e);
  Elt<P> v = tload<P>(sm, 1 << ntt_log_tile(a), e);
  if (a.post) v = fmul(v, fload<P>(a.post, a.post_ld, a.post_ld == 1 ? 0 : i));
  fstore<P>(a.out, a.n, i, v);
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
// functions above. That is valid where 4p < R = 2^(32N) (ROOM4): every base
// field here (254/256, 381/384, 377/384, 761/768 bits) and every scalar
// field but BLS12-381's r (255/256). The product is CIOS on PTX
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

// The lazy product on 64-bit temporaries (cios64, fmul's core without its
// final subtraction): a, b < 2p -> below 2p, as lmul. Needs 3p < R (a + p <
// R in cios64), which ROOM4 gives.
template <class P, int ROLL = 0>
__device__ __forceinline__ Elt<P> lmul64(const Elt<P>& a, const Elt<P>& b) {
  static_assert(P::ROOM4, "lazy products need 4p < R");
  uint32_t t[P::N + 2];
  cios64<P, ROLL>(a, b, t);
  Elt<P> r;
#pragma unroll
  for (int j = 0; j < P::N; ++j) r.v[j] = t[j];
  return r;
}

// The arithmetic of a chain of products and sums that ends in one store
// (plonk_quotient's row, the batch inversion's lanes), fixed at compile
// time; the product on 64-bit temporaries (cios64, its outer loop rolled
// ROLL steps a turn, or unrolled for ROLL = 0):
//   LAZY: values in [0, 2p) between operations and canonical once, before
//     the store (lmul64, ladd, lsub, lcanon). Only where ROOM4: a lazy sum
//     below 4p must fit N words, and a lazy product's running value below
//     a + p < 3p too.
//   otherwise canonical throughout (the product's final subtraction, fadd,
//     fsub), the only form BLS12-381's r allows.
template <bool LAZY, int ROLL = 0>
struct ChainOps {
  template <class P>
  static __device__ __forceinline__ Elt<P> mul(const Elt<P>& a, const Elt<P>& b) {
    if constexpr (LAZY) {
      return lmul64<P, ROLL>(a, b);
    } else {
      uint32_t t[P::N + 2];
      cios64<P, ROLL>(a, b, t);
      return reduce_once<P>(t, t[P::N]);
    }
  }
  template <class P>
  static __device__ __forceinline__ Elt<P> add(const Elt<P>& a, const Elt<P>& b) {
    if constexpr (LAZY) return ladd(a, b);
    else return fadd(a, b);
  }
  template <class P>
  static __device__ __forceinline__ Elt<P> sub(const Elt<P>& a, const Elt<P>& b) {
    if constexpr (LAZY) return lsub(a, b);
    else return fsub(a, b);
  }
  template <class P>
  static __device__ __forceinline__ Elt<P> canon(const Elt<P>& x) {
    if constexpr (LAZY) return lcanon(x);
    else return x;
  }
};

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
  using Base = Elt<P>;          // its base field
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
  using Base = Elt<P>;
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

static inline unsigned int n_blocks(long long n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}

// ---------------------------------------------------------------------------
// the fixed-base comb (K6's role in setup and the SRS) and the batch
// normalization after it: per-thread steps, plain C++
// (tests/test_torch_field_cuh.py runs them on the host)
//
// The comb: s G = sum_j table[j][d_j] with d_j the w-bit digits of s and
// row (j, d) of the table d 2^(w j) G, affine, at index j (2^w - 1) + d - 1.
// k_mixed_accumulate walks a lane's nonzero digits in the order of j (its
// comb mode), so a lane does about J = ceil(bits / w) mixed adds where the
// bit ladder did `bits` masked steps.
// ---------------------------------------------------------------------------

// digit j of lane l's scalar: the w bits from bit w j (the top window only
// those below `bits`) of the plain words s[k ld + l], k < wr
__device__ __forceinline__ uint32_t fb_digit(const uint32_t* s, long long ld, long long l, int wr,
                                             int bits, int w, int j) {
  const int b = w * j, k = b >> 5, sh = b & 31;
  uint32_t v = s[k * ld + l] >> sh;
  if (sh + w > 32 && k + 1 < wr) v |= s[(k + 1) * ld + l] << (32 - sh);
  const int width = bits - b < w ? bits - b : w;
  return v & ((1u << width) - 1u);
}

// word k of p - 2: 2 comes off the lowest word and the borrow runs up
// through words that are 0 (BLS12-377's p ends in 0x...00000001)
template <class P>
__device__ __forceinline__ uint32_t pm2_word(int k) {
  if (k == 0) return P::mod(0) - 2u;
  bool borrow = P::mod(0) < 2u;
  for (int j = 1; j < k && borrow; ++j) borrow = P::mod(j) == 0u;
  return P::mod(k) - (borrow ? 1u : 0u);
}

// the lazy PTX product as a chain's product (the normalization's Fermat
// chain over Fp)
struct LazyPtxMul {
  template <class P>
  static __device__ __forceinline__ Elt<P> mul(const Elt<P>& a, const Elt<P>& b) {
    return lmul(a, b);
  }
};

// x^(p - 2), the inverse of x != 0 by Fermat, in the product Ops::mul
// (lazy: x < 2p in, < 2p out): square and multiply from the top bit of p -
// 2. A thread inverts once for its k lanes, so a window over the exponent
// would save few products a lane; both loops stay rolled, so the product
// is inlined twice.
template <class Ops, class P>
__device__ __forceinline__ Elt<P> pow_pm2(const Elt<P>& x) {
  Elt<P> r = x;
  bool started = false;
#pragma unroll 1
  for (int k = P::N - 1; k >= 0; --k) {
    const uint32_t e = pm2_word<P>(k);
#pragma unroll 1
    for (int i = 31; i >= 0; --i) {
      const bool bit = (e >> i) & 1u;
      if (started) {
        r = Ops::mul(r, r);
        if (bit) r = Ops::mul(r, x);
      }
      started = started || bit;
    }
  }
  return r;
}

template <class P>
__device__ __forceinline__ bool is_zero(const Elt<P>& x) {
  uint32_t o = 0;
#pragma unroll
  for (int j = 0; j < P::N; ++j) o |= x.v[j];
  return o == 0;
}

template <class P>
__device__ __forceinline__ bool is_zero(const Elt2<P>& x) {
  return is_zero(x.c0) && is_zero(x.c1);
}

// what Montgomery's trick inverts for z: z over Fp, the norm z0^2 - BETA z1^2
// (in Fp, nonzero for z != 0: BETA is not a square) over Fp2
template <class P>
__device__ __forceinline__ Elt<P> trick_value(const Elt<P>& z) { return z; }

template <class P>
__device__ __forceinline__ Elt<P> trick_value(const Elt2<P>& z) {
  return ladd(lmul(z.c0, z.c0), mul_small<-P::BETA>(lmul(z.c1, z.c1)));
}

// z^-1 from d = 1 / trick_value(z): d over Fp, (z0, -z1) d over Fp2
template <class P>
__device__ __forceinline__ Elt<P> inverse_of(const Elt<P>&, const Elt<P>& d) { return d; }

template <class P>
__device__ __forceinline__ Elt2<P> inverse_of(const Elt2<P>& z, const Elt<P>& d) {
  return Elt2<P>{lmul(z.c0, d), lneg(lmul(z.c1, d))};
}

// One thread's batch normalization: lanes first + i stride, i < count, of
// the projective points p (planes X, Y, Z of row stride ld; Z canonical)
// -> the affine x, y as canonical PLAIN words in xy (planes x, y, stride
// ld) and inf[l] = 1 where Z = 0 (x = y = 0 there), else 0.
//
// Montgomery's trick over the thread's lanes: the running products of
// trick_value(Z) (a lane with Z = 0 enters as the word 1, which is nonzero)
// wait in the first Fp plane of x, and over Fp2 each lane's norm in the
// second; one Fermat inversion of the last; then the lanes from the last
// down, each taking its inverse from the product before it. The inverse
// is first multiplied by the word 1, i.e. by R^-1, so that the Montgomery
// product X z^-1 R^-1 comes out as the plain value X / Z: no conversion
// from Montgomery form is left. Per lane 5 products over Fp (its running
// product, its inverse, the inverse's update, x and y), 13 over Fp2 (the
// norm 2 more, z^-1 2, x and y 3 each), and per thread one inversion:
// about 1.5 bits products, shared by its k lanes.
template <class E>
__device__ __forceinline__ void normalize_lanes(const uint32_t* p, long long ld, uint32_t* xy,
                                                int32_t* inf, long long first, long long stride,
                                                int count) {
  using C = Coord<E>;
  using B = typename C::Base;
  constexpr int N = B::N;
  const long long plane = (long long)E::N * ld * C::NP;
  const uint32_t* pz = p + 2 * plane;
  uint32_t* run = xy;               // running products (x, first Fp plane)
  uint32_t* own = xy + N * ld;      // Fp2: each lane's norm (x, second Fp plane)
  B word1{};
  word1.v[0] = 1u;
  B acc{};
#pragma unroll 1
  for (int i = 0; i < count; ++i) {
    const long long l = first + i * stride;
    const E z = C::load(pz, ld, l);
    const bool zero = is_zero(z);
    inf[l] = zero ? 1 : 0;
    const B v = zero ? word1 : trick_value(z);
    if constexpr (C::NP == 2) fstore(own, ld, l, v);
    acc = i == 0 ? v : lmul(acc, v);
    fstore(run, ld, l, acc);
  }
  if (count <= 0) return;
  B d = lmul(pow_pm2<LazyPtxMul>(acc), word1);  // (the product)^-1 R^-1
#pragma unroll 1
  for (int i = count - 1; i >= 0; --i) {
    const long long l = first + i * stride;
    const E z = C::load(pz, ld, l);
    const bool zero = inf[l] != 0;
    B v;
    if constexpr (C::NP == 2) v = Coord<B>::load(own, ld, l);
    else v = zero ? word1 : z;
    const B di = i == 0 ? d : lmul(d, Coord<B>::load(run, ld, l - stride));
    if (i > 0) d = lmul(d, v);
    E x{}, y{};
    if (!zero) {
      const E zi = inverse_of(z, di);
      x = lcanon(lmul(C::load(p, ld, l), zi));
      y = lcanon(lmul(C::load(p + plane, ld, l), zi));
    }
    C::store(xy, ld, l, x);
    C::store(xy + plane, ld, l, y);
  }
}

// ---------------------------------------------------------------------------
// PLONK's Fr chains (fr.cu k_plonk_quotient, k_fr_batch_inv): per-thread
// steps, plain C++ (tests/test_torch_field_cuh.py runs them on the host), in
// a chain arithmetic (ChainOps). The quotient is canonical on every curve,
// its product rolled two steps a turn (QuotientOps); the batch inversion is
// lazy where r leaves room (4r < R: BN254, BLS12-377 and BW6-761 r;
// BLS12-381's 255 bits in 8 words leave none) and canonical elsewhere, its
// product unrolled (ChainOps<P::ROOM4>). fr.cu says why.
// ---------------------------------------------------------------------------

// fload whose loads the compiler may neither merge with another load of the
// same words nor move (each an asm volatile ld.global.nc on the card)
template <class P>
__device__ __forceinline__ Elt<P> fload_pinned(const uint32_t* base, long long ld, long long lane) {
#if defined(__CUDA_ARCH__)
  Elt<P> e;
#pragma unroll
  for (int k = 0; k < P::N; ++k)
    asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(e.v[k]) : "l"(base + k * ld + lane));
  return e;
#else
  return fload<P>(base, ld, lane);
#endif
}

// the quotient's inputs, each (N, n) Montgomery, in this order
enum { QA, QB, QC, QZ, QZW, QQK, QQL, QQR, QQM, QQO, QS1, QS2, QS3, QXS, QL1, Q_INPUTS };
// the constants, columns of an (N, 7) table: beta, gamma, alpha, beta k1,
// beta k2, alpha^2, one
enum { CBETA, CGAMMA, CALPHA, CBK1, CBK2, CALPHA2, CONE, Q_CONSTS };

struct QuotientIn {
  const uint32_t* p[Q_INPUTS];
  const uint32_t* zh_inv;  // (N, 4): 1/Z_H cycles with period 4 on the 4n coset
  long long n;             // rows, the stride of every input
};

// the constants by value: a kernel parameter, so that the card reads their
// words as operands from the constant bank and holds no register for them
template <class P>
struct QuotientConsts {
  Elt<P> c[Q_CONSTS];
};

using QuotientOps = ChainOps<false, 2>;

// Row l of T(x) = (gate + alpha perm + alpha^2 L1 (Z - 1)) / Z_H(x) on the
// 4n coset, canonical: the function of gnark_icicle_tpu/backend/plonk/
// prove.py:186-217 (_quotient_chunk_fn). The output is canonical, so any
// algebra that gives the same field element gives the same limbs; the
// reference's order is not kept. The row is a chain of products with little
// to overlap, so the card hides its latency with warps, and warps need
// registers: the terms are taken one after the other, each input loaded
// where it is used and loaded again where it is used again (from L1 or L2),
// so that at most the two permutation products are live beside the product
// being formed. The compiler may keep the first load of an input for its
// later uses and hoist loads ahead of their products (nothing is stored
// before the end), so each input is loaded where it is written
// (fload_pinned). The gate is taken as A (ql + qm B) + qr B + qo C + qk, 20
// products a row, where the reference's ql A + (qm A) B + ... has 21.
// (alpha^2 is the table's column CALPHA2, as the plain version takes it,
// so that both compute one function of the table.)
template <class P>
__device__ __forceinline__ Elt<P> quotient_row(const QuotientIn& in, const QuotientConsts<P>& k,
                                                long long l) {
  using E = Elt<P>;
  using Ops = QuotientOps;
  auto ld = [&](int i) { return fload_pinned<P>(in.p[i], in.n, l); };
  auto cst = [&](int i) { return k.c[i]; };
  // one wire's factor w + c y + gamma of a permutation product
  auto factor = [&](int w, int c, int y) {
    return Ops::add(Ops::add(ld(w), Ops::mul(cst(c), ld(y))), cst(CGAMMA));
  };
  E lhs = factor(QA, CBETA, QXS);
  lhs = Ops::mul(lhs, factor(QB, CBK1, QXS));
  lhs = Ops::mul(lhs, factor(QC, CBK2, QXS));
  lhs = Ops::mul(lhs, ld(QZ));
  E rhs = factor(QA, CBETA, QS1);
  rhs = Ops::mul(rhs, factor(QB, CBETA, QS2));
  rhs = Ops::mul(rhs, factor(QC, CBETA, QS3));
  E acc = Ops::sub(Ops::mul(rhs, ld(QZW)), lhs);  // perm
  const E start = Ops::mul(ld(QL1), Ops::sub(ld(QZ), cst(CONE)));
  acc = Ops::add(Ops::mul(cst(CALPHA), acc), Ops::mul(cst(CALPHA2), start));
  acc = Ops::add(acc, Ops::mul(ld(QA), Ops::add(ld(QQL), Ops::mul(ld(QQM), ld(QB)))));
  acc = Ops::add(acc, Ops::mul(ld(QQR), ld(QB)));
  acc = Ops::add(Ops::add(acc, Ops::mul(ld(QQO), ld(QC))), ld(QQK));
  return Ops::canon(Ops::mul(acc, fload<P>(in.zh_inv, 4, l & 3)));
}

// One thread's batch inversion: lanes first + i stride, i < count, of x
// (stride ld) -> out, x^-1 in Montgomery form and canonical, 0 -> 0 (the
// contract of the Fermat inversion, gnark_icicle_tpu/ops/field.py:330
// LimbField.mont_inv). Montgomery's trick: the running products of the
// lanes (a zero lane enters as the word 1, which is nonzero, so it poisons
// no other lane) wait in out; one Fermat inversion of the last; then the
// lanes from the last down, each taking its inverse from the product before
// it. 3 products a lane after the thread's first, and one inversion (about
// 1.5 bits products) a thread.
template <class P>
__device__ __forceinline__ void batch_inv_lanes(const uint32_t* x, long long ld, uint32_t* out,
                                                long long first, long long stride, int count) {
  using E = Elt<P>;
  using Ops = ChainOps<P::ROOM4>;
  E word1{};
  word1.v[0] = 1u;
  E acc{};
#pragma unroll 1
  for (int i = 0; i < count; ++i) {
    const long long l = first + i * stride;
    const E v = fload<P>(x, ld, l);
    const E u = is_zero(v) ? word1 : v;
    acc = i == 0 ? u : Ops::mul(acc, u);
    fstore<P>(out, ld, l, acc);
  }
  if (count <= 0) return;
  E d = pow_pm2<Ops>(acc);  // (the product)^-1
#pragma unroll 1
  for (int i = count - 1; i >= 0; --i) {
    const long long l = first + i * stride;
    const E v = fload<P>(x, ld, l);
    const bool zero = is_zero(v);
    const E di = i == 0 ? d : Ops::mul(d, fload<P>(out, ld, l - stride));
    if (i > 0) d = Ops::mul(d, zero ? word1 : v);
    fstore<P>(out, ld, l, zero ? E{} : Ops::canon(di));
  }
}

// ---------------------------------------------------------------------------
// the MSM's bucket reduction and Horner (K2/K3 in their MSM role): stages as
// per-thread functions over accessors, plain C++ (tests/test_torch_field_cuh.py
// builds them for the host), and the kernels further below.
//
// Every value is canonical (fmul, fadd, fsub; b3 through the build's form,
// made canonical), so a stage's limbs are fixed by the order of its group
// operations alone: the plain versions (ops/ec_t.py) repeat that order with
// DevCurve and are equal limb for limb, whichever thread or lane computed
// which product.
//
// For one window's buckets S_b, b < B = V·M, cut into V chunks of M:
//   running sums: chunk v gives T_v = sum_j S_{vM+j} and
//     A_v = sum_j (j+1) S_{vM+j} (running += S_j; acc += running, j down);
//   combine: S_w = sum_v A_v + M sum_v v T_v (ops/msm.py, the identity of
//     the reference's _weighted_chunked_t), one block per window: thread t
//     of ct takes r = V / ct chunks serially (T_t, A_t and the 0-based
//     weighted G_t = sum_i i T_{tr+i}); then sum_v v T_v = sum_t G_t +
//     r sum_{t>=1} U_t with U_t = sum_{u>=t} T_u, the suffix sums of the
//     threads' T (a Hillis-Steele scan, log2 ct rounds of one add), so each
//     thread forms Y_t = A_t + M (G_t + r U_t) (U_0 left out; log2 r +
//     log2 M doublings, all threads at once) and a tree in shared memory
//     sums the Y_t (log2 ct rounds of one add): no doubling per level;
//   Horner: sum_w 2^(cw) S_w, c doublings and one add per window, top down.
// ---------------------------------------------------------------------------

// threads of a combine block (at most; V when V is smaller)
constexpr int COMBINE_T = 128;

static __device__ __forceinline__ int log2_pow2(long long x) {
  int k = 0;
  while ((1LL << k) < x) ++k;
  return k;
}

// b3 * x, canonical, by the build's b3 form (add chains made canonical; the
// row products on the canonical product)
template <int K, class E>
__device__ __forceinline__ E b3_canon(const B3Int<K>& b3, const E& x) {
  return lcanon(b3(x));
}

template <class P>
__device__ __forceinline__ Elt2<P> b3_canon(const B3Imag& b3, const Elt2<P>& x) {
  const Elt<P> c = fload<P>(b3.row + P::N, 1, 0);
  return Elt2<P>{lcanon(mul_small<P::BETA>(fmul(x.c1, c))), fmul(x.c0, c)};
}

template <class P>
__device__ __forceinline__ Elt<P> b3_canon(const B3Row& b3, const Elt<P>& x) {
  return fmul(fload<P>(b3.row, 1, 0), x);
}

template <class P>
__device__ __forceinline__ Elt2<P> b3_canon(const B3Row& b3, const Elt2<P>& x) {
  return fmul(Elt2<P>{fload<P>(b3.row, 1, 0), fload<P>(b3.row + P::N, 1, 0)}, x);
}

template <class B3>
struct CanonB3 {
  B3 b3;
  template <class E>
  __device__ __forceinline__ E operator()(const E& x) const { return b3_canon(b3, x); }
};

// a projective point in registers
template <class E>
struct RegPt {
  E X, Y, Z;
  __device__ __forceinline__ E x() const { return X; }
  __device__ __forceinline__ E y() const { return Y; }
  __device__ __forceinline__ E z() const { return Z; }
  __device__ __forceinline__ void set_x(const E& v) { X = v; }
  __device__ __forceinline__ void set_y(const E& v) { Y = v; }
  __device__ __forceinline__ void set_z(const E& v) { Z = v; }
};

// the complete add's t3, t4 (held) and t0, z3 (parked), in registers
template <class E>
struct RegScratch {
  E H[2], K[2];
  __device__ __forceinline__ void hold(int k, const E& v) { H[k] = v; }
  __device__ __forceinline__ E held(int k) const { return H[k]; }
  __device__ __forceinline__ void park(int k, const E& v) { K[k] = v; }
  __device__ __forceinline__ E parked(int k) const { return K[k]; }
};

// a point of coordinate planes (row stride ld) at one lane, read where used
template <class E>
struct PlanePt {
  const uint32_t* p;
  long long ld, lane;
  __device__ __forceinline__ long long plane() const { return (long long)E::N * ld * Coord<E>::NP; }
  __device__ __forceinline__ E x() const { return Coord<E>::load(p, ld, lane); }
  __device__ __forceinline__ E y() const { return Coord<E>::load(p + plane(), ld, lane); }
  __device__ __forceinline__ E z() const { return Coord<E>::load(p + 2 * plane(), ld, lane); }
};

template <class E, class A, class Q>
__device__ __forceinline__ void set_point(A& a, const Q& q) {
  a.set_x(q.x());
  a.set_y(q.y());
  a.set_z(q.z());
}

template <class E, class Q>
__device__ __forceinline__ void store_point(uint32_t* base, long long ld, long long lane, const Q& q) {
  const long long plane = (long long)E::N * ld * Coord<E>::NP;
  Coord<E>::store(base, ld, lane, q.x());
  Coord<E>::store(base + plane, ld, lane, q.y());
  Coord<E>::store(base + 2 * plane, ld, lane, q.z());
}

// p += q, the complete RCB add (Renes-Costello-Batina 2016, algorithm 7;
// DevCurve.add's values), p's coordinates read only before its first write, q's where used; t3, t4 held and t0, z3 parked in s
template <class E, class A, class Q, class S, class B3C>
__device__ __forceinline__ void ec_add_to(A& p, const Q& q, S& s, const B3C& b3) {
  E t0 = fmul(p.x(), q.x());
  E t1 = fmul(p.y(), q.y());
  E t2 = fmul(p.z(), q.z());
  s.hold(0, fsub(fmul(fadd(p.x(), p.y()), fadd(q.x(), q.y())), fadd(t0, t1)));  // t3
  s.hold(1, fsub(fmul(fadd(p.y(), p.z()), fadd(q.y(), q.z())), fadd(t1, t2)));  // t4
  E y3 = fsub(fmul(fadd(p.x(), p.z()), fadd(q.x(), q.z())), fadd(t0, t2));
  t0 = fadd(fadd(t0, t0), t0);
  t2 = b3(t2);
  s.park(1, fadd(t1, t2));  // z3
  t1 = fsub(t1, t2);
  y3 = b3(y3);
  s.park(0, t0);
  p.set_x(fsub(fmul(s.held(0), t1), fmul(s.held(1), y3)));
  p.set_y(fadd(fmul(y3, s.parked(0)), fmul(t1, s.parked(1))));
  p.set_z(fadd(fmul(s.parked(1), s.held(1)), fmul(s.parked(0), s.held(0))));
}

// p = 2p, the RCB double (algorithm 9; DevCurve.double's values), x3 held
// and Z3 parked in s
template <class E, class A, class S, class B3C>
__device__ __forceinline__ void ec_double_in(A& p, S& s, const B3C& b3) {
  E t0 = fmul(p.y(), p.y());
  E z3 = fadd(t0, t0);
  z3 = fadd(z3, z3);
  z3 = fadd(z3, z3);
  const E t2 = b3(fmul(p.z(), p.z()));
  s.hold(0, fmul(t2, z3));                // x3
  s.park(1, fmul(fmul(p.y(), p.z()), z3));  // Z3
  E y3 = fadd(t0, t2);
  const E t2x2 = fadd(t2, t2);
  t0 = fsub(t0, fadd(t2x2, t2));
  y3 = fadd(fmul(t0, y3), s.held(0));
  const E x3 = fmul(t0, fmul(p.x(), p.y()));
  p.set_x(fadd(x3, x3));
  p.set_y(y3);
  p.set_z(s.parked(1));
}

// The stages below take their group law as `ops`: ops.add(p, q) is p += q,
// ops.dbl(p) is p = 2p. InlineOps inlines ec_add_to / ec_double_in at each
// call; the combine kernel passes ops that call one out-of-line add and one
// double over shared memory instead, so that its many call sites do not
// each carry a dozen unrolled products.
template <class E, class S, class B3C>
struct InlineOps {
  S& s;
  B3C b3;
  template <class A, class Q>
  __device__ __forceinline__ void add(A& p, const Q& q) { ec_add_to<E>(p, q, s, b3); }
  template <class A>
  __device__ __forceinline__ void dbl(A& p) { ec_double_in<E>(p, s, b3); }
};

// running sums of one chunk: run = T = sum_j S_j, acc = A = sum_j (j+1) S_j
// over the M points src(j), j from M - 1 down
template <class E, class A, class Ops, class Src>
__device__ __forceinline__ void reduce_run(A& run, A& acc, Ops& ops, int M, Src src) {
  set_point<E>(run, src(M - 1));
  set_point<E>(acc, run);
  for (int j = M - 2; j >= 0; --j) {
    ops.add(run, src(j));
    ops.add(acc, run);
  }
}

// a combine thread's r chunks (tsrc(i), asrc(i), i < r): T, A and, for
// r > 1, G = sum_i i T_i (the suffix sums from i = r - 1 down to 1)
template <class E, class A, class Ops, class SrcT, class SrcA>
__device__ __forceinline__ void combine_run(A& T, A& G, A& Acc, Ops& ops, int r, SrcT tsrc,
                                            SrcA asrc) {
  set_point<E>(T, tsrc(r - 1));
  set_point<E>(Acc, asrc(r - 1));
  if (r > 1) set_point<E>(G, T);
  for (int i = r - 2; i >= 1; --i) {
    ops.add(T, tsrc(i));
    ops.add(G, T);
  }
  for (int i = r - 2; i >= 0; --i) ops.add(Acc, asrc(i));
  if (r > 1) ops.add(T, tsrc(0));
}

// a combine thread's Y = A + 2^log_m (G + 2^log_r U) once U (its suffix
// sum, in T; none for thread 0: has_u false) is known; Y in Acc, T and G
// overwritten. Without G (has_g false: r = 1) G is 0.
template <class E, class A, class Ops>
__device__ __forceinline__ void combine_weight(A& T, A& G, A& Acc, Ops& ops, bool has_g,
                                               bool has_u, int log_r, int log_m) {
  if (has_u) {
    for (int i = 0; i < log_r; ++i) ops.dbl(T);
    if (has_g) ops.add(G, T);
    else set_point<E>(G, T);
    has_g = true;
  }
  if (has_g) {
    for (int i = 0; i < log_m; ++i) ops.dbl(G);
    ops.add(Acc, G);
  }
}

// Horner's group law spread over a warp: the independent products of each
// round on lanes of their own, exchanged through res[3] (X, Y, Z) and
// bank[12] in shared memory, each phase followed by __syncwarp. The add's 12
// products run as 6 + 6 (b3 recomputed by every lane that needs it), the
// double's 8 as 4 + 4: a round costs one product's latency, not its count.

// add, phase 1 (lanes 0-5): bank[l] = X1X2, Y1Y2, Z1Z2, (X1+Y1)(X2+Y2),
// (Y1+Z1)(Y2+Z2), (X1+Z1)(X2+Z2)
template <class E, class Q>
__device__ __forceinline__ void hadd_products(const E* res, const Q& q, E* bank, int lane) {
  E a, b;
  switch (lane) {
    case 0: a = res[0]; b = q.x(); break;
    case 1: a = res[1]; b = q.y(); break;
    case 2: a = res[2]; b = q.z(); break;
    case 3: a = fadd(res[0], res[1]); b = fadd(q.x(), q.y()); break;
    case 4: a = fadd(res[1], res[2]); b = fadd(q.y(), q.z()); break;
    case 5: a = fadd(res[0], res[2]); b = fadd(q.x(), q.z()); break;
    default: return;
  }
  bank[lane] = fmul(a, b);
}

// add, phase 2 (lanes 0-5): bank[6 + l] = t3 t1, t4 y3, y3 t0, t1 z3, z3 t4,
// t0 t3 with t3 = m3 - (m0 + m1), t4 = m4 - (m1 + m2), y3 = b3 (m5 - (m0 +
// m2)), t0 = 3 m0, z3 = m1 + b3 m2, t1 = m1 - b3 m2. The two b3 terms are
// formed by every lane before the lanes part (a product inside a divergent
// branch would run once per branch); only additions depend on the lane.
template <class E, class B3C>
__device__ __forceinline__ void hadd_second(E* bank, const B3C& b3, int lane) {
  if (lane >= 6) return;
  const E t2 = b3(bank[2]);
  const E y3 = b3(fsub(bank[5], fadd(bank[0], bank[2])));
  auto t3 = [&] { return fsub(bank[3], fadd(bank[0], bank[1])); };
  auto t4 = [&] { return fsub(bank[4], fadd(bank[1], bank[2])); };
  auto t0 = [&] { const E m = bank[0]; return fadd(fadd(m, m), m); };
  auto z3 = [&] { return fadd(bank[1], t2); };
  auto t1 = [&] { return fsub(bank[1], t2); };
  E a, b;
  switch (lane) {
    case 0: a = t3(); b = t1(); break;
    case 1: a = t4(); b = y3; break;
    case 2: a = y3; b = t0(); break;
    case 3: a = t1(); b = z3(); break;
    case 4: a = z3(); b = t4(); break;
    default: a = t0(); b = t3(); break;
  }
  bank[6 + lane] = fmul(a, b);
}

// add, phase 3 (lanes 0-2): X3 = m6 - m7, Y3 = m8 + m9, Z3 = m10 + m11
template <class E>
__device__ __forceinline__ void hadd_finish(E* res, const E* bank, int lane) {
  if (lane == 0) res[0] = fsub(bank[6], bank[7]);
  else if (lane == 1) res[1] = fadd(bank[8], bank[9]);
  else if (lane == 2) res[2] = fadd(bank[10], bank[11]);
}

// double, phase 1 (lanes 0-3): bank[l] = YY, YZ, ZZ, XY
template <class E>
__device__ __forceinline__ void hdbl_products(const E* res, E* bank, int lane) {
  E a, b;
  switch (lane) {
    case 0: a = res[1]; b = res[1]; break;
    case 1: a = res[1]; b = res[2]; break;
    case 2: a = res[2]; b = res[2]; break;
    case 3: a = res[0]; b = res[1]; break;
    default: return;
  }
  bank[lane] = fmul(a, b);
}

// double, phase 2 (lanes 0-3): bank[6 + l] = t2 z3, YZ z3, t0' (t0 + t2),
// t0' XY with t0 = YY, t2 = b3 ZZ, z3 = 8 t0, t0' = t0 - 3 t2
template <class E, class B3C>
__device__ __forceinline__ void hdbl_second(E* bank, const B3C& b3, int lane) {
  if (lane >= 4) return;
  const E t0 = bank[0];
  const E t2 = b3(bank[2]);
  E a, b;
  if (lane < 2) {
    E z3 = fadd(t0, t0);
    z3 = fadd(z3, z3);
    a = lane == 0 ? t2 : bank[1];
    b = fadd(z3, z3);
  } else {
    a = fsub(t0, fadd(fadd(t2, t2), t2));
    b = lane == 2 ? fadd(t0, t2) : bank[3];
  }
  bank[6 + lane] = fmul(a, b);
}

// double, phase 3 (lanes 0-2): X3 = 2 m9, Y3 = m8 + m6, Z3 = m7
template <class E>
__device__ __forceinline__ void hdbl_finish(E* res, const E* bank, int lane) {
  if (lane == 0) res[0] = fadd(bank[9], bank[9]);
  else if (lane == 1) res[1] = fadd(bank[8], bank[6]);
  else if (lane == 2) res[2] = bank[7];
}

// b3 * x by the canonical product with a b3 row (the add and double kernels,
// which take any b3)
template <class E>
struct RowB3 {
  E b3;
  __device__ __forceinline__ E operator()(const E& x) const { return fmul(b3, x); }
};

// ---------------------------------------------------------------------------
// the complete add and double kernels over a coordinate type E
// (instantiated by g1.cu / g2.cu): one lane a thread, in registers
// ---------------------------------------------------------------------------

template <class E>
__global__ void k_add(const uint32_t* p, long long ldp, const uint32_t* q, long long ldq,
                      uint32_t* o, long long ldo, long long n, const uint32_t* b3_row) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= n) return;
  const PlanePt<E> P{p, ldp, l};
  RegPt<E> R{P.x(), P.y(), P.z()};
  RegScratch<E> s;
  ec_add_to<E>(R, PlanePt<E>{q, ldq, l}, s, RowB3<E>{Coord<E>::row(b3_row)});
  store_point<E>(o, ldo, l, R);
}

template <class E>
__global__ void k_double(const uint32_t* p, long long ldp, uint32_t* o, long long ldo,
                         long long n, const uint32_t* b3_row) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= n) return;
  const PlanePt<E> P{p, ldp, l};
  RegPt<E> R{P.x(), P.y(), P.z()};
  RegScratch<E> s;
  ec_double_in<E>(R, s, RowB3<E>{Coord<E>::row(b3_row)});
  store_point<E>(o, ldo, l, R);
}

#if defined(__CUDACC__)
// ---------------------------------------------------------------------------
// the staged mixed-add kernel: the MSM's bucket accumulation (one launch per
// MSM), the masked wave step and the fixed-base comb of setup and the SRS
// (one launch per batch), one kernel, so that ptxas builds the mixed add
// once per (coordinate type, b3 form); then the batch normalization
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

// .ca, cached in L1: the comb's lanes gather rows of one small table (61 KB
// to a few hundred KB), which .cg (L2 only) would fetch from L2 each time
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

// Where each lane's points come from (k_mixed_accumulate):
//   start given (the MSM's bucket accumulation): count[l] points at sorted
//     positions start[l] + t, acc_l += sum (-1)^sign[s] table[order[s]];
//   start and scalars null (the wave step): the one point at position l
//     where count (the mask) is nonzero, everywhere if count is null;
//   scalars given (the fixed-base comb): acc_l += table[j (2^w - 1) + d_j - 1]
//     for the nonzero digits d_j (fb_digit) of lane l's scalar, j upwards.
//     The lane first writes those rows to order[l J ..] (J = ceil(bits / w)
//     words a lane, scratch that the caller provides), then walks them as an
//     MSM lane walks its run: the loop of adds is the MSM's, and a branch of
//     the comb's inside it cost the MSM's accumulation up to 14 % (PERF.md).
// A null sign means all positive.
struct Walk {
  int32_t* order;           // the comb writes its rows here
  const int32_t* sign;
  const long long* start;
  const int32_t* count;
  const uint32_t* scalars;  // (wr, ld) plain words, the accumulator's stride
  int wr, bits, w;
};

// One mixed-add kernel for the MSM's bucket accumulation, the wave step and
// the fixed-base comb: lane l < L of the accumulator planes (stride ld) adds
// its points (Walk), read once and written once (canonical). MSM lanes come
// sorted by count, descending, so a warp's threads loop about equally long;
// a comb lane adds about J (1 - 2^-w) points.
template <class E, class B3>
__global__ void __launch_bounds__(Stage<E>::T)
k_mixed_accumulate(uint32_t* acc, long long ld, long long L, const uint32_t* table,
                   const Walk walk, const uint32_t* b3_row) {
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
  long long s0 = l;
  int n = 0;
  if (walk.scalars != nullptr) {  // the comb: this lane's rows, then the walk below
    const int J = (walk.bits + walk.w - 1) / walk.w, D = (1 << walk.w) - 1;
    s0 = l * J;
    for (int j = 0; j < J; ++j) {
      const uint32_t d = fb_digit(walk.scalars, ld, l, walk.wr, walk.bits, walk.w, j);
      if (d != 0) walk.order[s0 + n++] = j * D + (int)d - 1;
    }
  } else if (walk.start != nullptr) {
    s0 = walk.start[l];
    n = walk.count[l];
  } else {
    n = walk.count == nullptr || walk.count[l] != 0;
  }
  if (n <= 0) return;
  auto idx_of = [&](int t) { return walk.order[s0 + t]; };
  auto neg_of = [&](int t) { return walk.sign != nullptr && walk.sign[s0 + t] != 0; };
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
                                   const Walk& walk, const void* b3, void* stream) {
  constexpr size_t bytes = Stage<E>::bytes();
  auto kernel = k_mixed_accumulate<E, B3>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  if (L > 0)
    kernel<<<n_blocks(L, Stage<E>::T), Stage<E>::T, bytes, (cudaStream_t)stream>>>(
        (uint32_t*)acc, ld, L, (const uint32_t*)table, walk, (const uint32_t*)b3);
  return (int)cudaGetLastError();
}

// The batch normalization, one launch: block b's thread t takes the k lanes
// b NORM_T k + t + i NORM_T, so that at each step a warp touches 32
// neighbouring lanes (normalize_lanes). Few threads are in flight (n / k),
// each a chain of products with little to overlap; the launch is small
// beside the comb's.
constexpr int NORM_T = 64;

template <class E>
__global__ void __launch_bounds__(NORM_T)
k_normalize(const uint32_t* p, long long n, uint32_t* xy, int32_t* inf, int k) {
  const long long first = (long long)blockIdx.x * NORM_T * k + threadIdx.x;
  if (first >= n) return;
  const long long rest = (n - first + NORM_T - 1) / NORM_T;
  normalize_lanes<E>(p, n, xy, inf, first, NORM_T, rest < k ? (int)rest : k);
}

template <class E>
static int launch_normalize(const void* p, long long n, void* xy, void* inf, int k, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  if (n > 0)
    k_normalize<E><<<n_blocks(n, NORM_T * k), NORM_T, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, n, (uint32_t*)xy, (int32_t*)inf, k);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the reduction and Horner kernels (stages above): at most three launches
// per MSM, in place of one k_add / k_double launch per round of the
// reference's scans and Horner loop
//
// What bounds them. The running sums are 2 W B complete adds (12 products
// each, on the integer-multiply rate) spread over W V threads, V chosen so
// that W V fills the card (ops/msm.py reduce_chunks); the combine adds about
// 3 V + ct log2 ct adds and ct (log2 r + log2 M) doublings per window, and
// its depth is about 3 r + 2 log2 ct adds and log2 r + log2 M doublings;
// Horner is one chain of c (W - 1) doublings and W - 1 adds that no
// reordering shortens, so its bound is that chain at the latency of one
// double. The warp form brings the chain to its depth in products (two
// rounds a double or an add) instead of their count: on an H100 it ran
// 2.7-6.4x faster than the same chain on one thread (PERF.md).
//
// Registers and build time: where a coordinate is 16 words or more
// (Stage<E>::ACC_SMEM) the running sums hold their points and the add's
// t3, t4, t0, z3 in shared memory and run the group law through one
// out-of-line add and double (smem_add, smem_double), so that 12-word G2
// and 24-word G1 neither spill much (k_add spilled up to
// 1,176 bytes there) nor build for minutes. The combine keeps T, G, A, D
// and the scratch of each thread in shared memory at every width (16
// coordinates, 196,608 bytes a block at 24 words), through the same two
// functions: the scan and the tree read the other threads'.
// ---------------------------------------------------------------------------

// one coordinate at p, chunks `stride` apart, and a point / the add's
// scratch of one thread in shared memory with that stride (the threads of
// a block side by side: stride = threads, chunk k of thread i at k stride + i)
template <class E>
__device__ __forceinline__ E sld(const uint4* p, int stride) {
  E e;
#pragma unroll
  for (int k = 0; k < Stage<E>::EC; ++k) {
    const uint4 v = lds16(p + k * stride);
    word(e, 4 * k) = v.x;
    word(e, 4 * k + 1) = v.y;
    word(e, 4 * k + 2) = v.z;
    word(e, 4 * k + 3) = v.w;
  }
  return e;
}

template <class E>
__device__ __forceinline__ void sst(uint4* p, int stride, E e) {
#pragma unroll
  for (int k = 0; k < Stage<E>::EC; ++k)
    sts16(p + k * stride, make_uint4(word(e, 4 * k), word(e, 4 * k + 1), word(e, 4 * k + 2),
                                     word(e, 4 * k + 3)));
}

template <class E>
struct SmemPt {
  uint4* p;
  int stride;
  __device__ __forceinline__ int C() const { return Stage<E>::EC * stride; }  // one coordinate
  __device__ __forceinline__ E x() const { return sld<E>(p, stride); }
  __device__ __forceinline__ E y() const { return sld<E>(p + C(), stride); }
  __device__ __forceinline__ E z() const { return sld<E>(p + 2 * C(), stride); }
  __device__ __forceinline__ void set_x(const E& v) { sst<E>(p, stride, v); }
  __device__ __forceinline__ void set_y(const E& v) { sst<E>(p + C(), stride, v); }
  __device__ __forceinline__ void set_z(const E& v) { sst<E>(p + 2 * C(), stride, v); }
};

template <class E>
struct SmemScratch {
  uint4* p;
  int stride;
  __device__ __forceinline__ int C() const { return Stage<E>::EC * stride; }
  __device__ __forceinline__ void hold(int k, const E& v) { sst<E>(p + k * C(), stride, v); }
  __device__ __forceinline__ E held(int k) const { return sld<E>(p + k * C(), stride); }
  __device__ __forceinline__ void park(int k, const E& v) { sst<E>(p + (2 + k) * C(), stride, v); }
  __device__ __forceinline__ E parked(int k) const { return sld<E>(p + (2 + k) * C(), stride); }
};

// The group law on points in shared memory, out of line: one add and one
// double per (coordinate type, b3 form) serve every call site of the
// combine and the running sums, where inlined the dozen unrolled products
// of each site made ptxas take minutes and spill.
template <class E, class B3>
__device__ __noinline__ void smem_add(uint4* p, uint4* q, uint4* scratch, int stride,
                                      const uint32_t* b3_row) {
  SmemPt<E> P{p, stride}, Q{q, stride};
  SmemScratch<E> s{scratch, stride};
  ec_add_to<E>(P, Q, s, CanonB3<B3>{B3(b3_row)});
}

template <class E, class B3>
__device__ __noinline__ void smem_double(uint4* p, uint4* scratch, int stride,
                                         const uint32_t* b3_row) {
  SmemPt<E> P{p, stride};
  SmemScratch<E> s{scratch, stride};
  ec_double_in<E>(P, s, CanonB3<B3>{B3(b3_row)});
}

// ops over smem_add / smem_double: a point of the planes is first copied
// into the thread's staging slot
template <class E, class B3>
struct SmemOps {
  using SP = SmemPt<E>;
  uint4* scratch;
  uint4* stage;
  int stride;
  const uint32_t* b3_row;
  __device__ __forceinline__ void add(SP& p, const SP& q) {
    smem_add<E, B3>(p.p, q.p, scratch, stride, b3_row);
  }
  __device__ __forceinline__ void add(SP& p, const PlanePt<E>& q) {
    SP st{stage, stride};
    set_point<E>(st, q);
    smem_add<E, B3>(p.p, stage, scratch, stride, b3_row);
  }
  __device__ __forceinline__ void dbl(SP& p) { smem_double<E, B3>(p.p, scratch, stride, b3_row); }
};

constexpr int REDUCE_T = 32;  // threads a block of the running sums

// shared memory of the running sums: where ACC_SMEM, run, acc, a staging
// slot and the scratch, 13 coordinates a thread (39,936 bytes a block at 24
// words: five blocks an SM)
template <class E>
constexpr size_t reduce_bytes() {
  return Stage<E>::ACC_SMEM ? (size_t)16 * Stage<E>::EC * 13 * REDUCE_T : 0;
}

// of the combine: T, G, A, D and the scratch, 16 coordinates a thread
template <class E>
constexpr size_t combine_bytes() {
  return (size_t)16 * Stage<E>::EC * 16 * COMBINE_T;
}

static_assert(combine_bytes<Elt<Bw6Fp>>() <= 232448, "a combine block's shared memory fits");

// The running sums and the combine are two stages of one kernel, k_reduce,
// so that ptxas compiles smem_add and smem_double once per (coordinate
// type, b3 form) and not once per kernel that calls them: as separate
// kernels, the 12-word G2 library took about 300 s to build.
struct ReduceArgs {
  int stage;               // 0 running sums, 1 combine
  const uint32_t* in;      // S (stage 0) or T (stage 1)
  const uint32_t* in2;     // A (stage 1)
  uint32_t* out;
  long long L, ld, W;      // lanes (0), stride of T and A (1), windows (1)
  int M, V, log_m;
  const uint32_t* b3_row;
};

// Running sums: lane l < L (one (window, chunk)) reads buckets l M .. l M +
// M - 1 of S (stride L M) and writes T_l to planes 0-2 and A_l to planes 3-5
// (coordinates) of TA (stride L).
template <class E, class B3>
__device__ __forceinline__ void reduce_runs_stage(const ReduceArgs& a, uint4* smem) {
  const long long L = a.L;
  const int M = a.M;
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  auto src = [&](int j) { return PlanePt<E>{a.in, L * M, l * M + j}; };
  const long long point = 3LL * E::N * L * Coord<E>::NP;
  if constexpr (Stage<E>::ACC_SMEM) {
    constexpr int C = Stage<E>::EC * REDUCE_T;
    uint4* base = smem + threadIdx.x;
    SmemPt<E> run{base, REDUCE_T}, acc{base + 3 * C, REDUCE_T};
    SmemOps<E, B3> ops{base + 9 * C, base + 6 * C, REDUCE_T, a.b3_row};
    reduce_run<E>(run, acc, ops, M, src);
    store_point<E>(a.out, L, l, run);
    store_point<E>(a.out + point, L, l, acc);
  } else {
    RegPt<E> run, acc;
    RegScratch<E> s;
    InlineOps<E, RegScratch<E>, CanonB3<B3>> ops{s, CanonB3<B3>{B3(a.b3_row)}};
    reduce_run<E>(run, acc, ops, M, src);
    store_point<E>(a.out, L, l, run);
    store_point<E>(a.out + point, L, l, acc);
  }
}

// Combine: block w of ct threads turns chunks w V .. w V + V - 1 of T and A
// (stride ld) into S_w = sum_v A_v + 2^log_m sum_v v T_v at lane w of out
// (stride W).
template <class E, class B3>
__device__ __forceinline__ void reduce_combine_stage(const ReduceArgs& a, uint4* smem) {
  using SP = SmemPt<E>;
  constexpr int C = Stage<E>::EC * COMBINE_T;
  const int ct = blockDim.x, t = threadIdx.x, r = a.V / ct;
  // point k of thread u: 0 T, 1 G, 2 A, 3 D (the staging slot of the serial
  // runs, then the scan's copy of a neighbour's sum); then the add's scratch
  auto pt = [&](int u, int k) { return SP{smem + u + 3 * k * C, COMBINE_T}; };
  SP Tt = pt(t, 0), G = pt(t, 1), Acc = pt(t, 2), D = pt(t, 3);
  SmemOps<E, B3> ops{smem + t + 12 * C, D.p, COMBINE_T, a.b3_row};
  const long long first = (long long)blockIdx.x * a.V + (long long)t * r;
  combine_run<E>(Tt, G, Acc, ops, r, [&](int i) { return PlanePt<E>{a.in, a.ld, first + i}; },
                 [&](int i) { return PlanePt<E>{a.in2, a.ld, first + i}; });
  // the suffix sums U_t of the threads' T, in place: round h adds thread
  // t + h's value from before the round (copied into D first)
  for (int h = 1; h < ct; h <<= 1) {
    __syncthreads();
    if (t + h < ct) set_point<E>(D, pt(t + h, 0));
    __syncthreads();
    if (t + h < ct) ops.add(Tt, D);
  }
  combine_weight<E>(Tt, G, Acc, ops, r > 1, t > 0, log2_pow2(r), a.log_m);
  // the tree: thread t adds thread t + h's Y where t is a multiple of 2h
  for (int h = 1; h < ct; h <<= 1) {
    __syncthreads();
    if (t % (2 * h) == 0) ops.add(Acc, pt(t + h, 2));
  }
  if (t == 0) store_point<E>(a.out, a.W, blockIdx.x, Acc);
}

template <class E, class B3>
__global__ void __launch_bounds__(COMBINE_T) k_reduce(const ReduceArgs a) {
  extern __shared__ uint4 smem[];
  if (a.stage == 0) reduce_runs_stage<E, B3>(a, smem);
  else reduce_combine_stage<E, B3>(a, smem);
}

// Horner, one warp a problem: block m sums 2^(cw) S_w over its W windows,
// lanes m W .. m W + W - 1 of S (plane stride M W), into lane m of out
// (plane stride M). The M warps run on SMs of their own, side by side.
template <class E, class B3>
__global__ void __launch_bounds__(32)
k_horner(const uint32_t* S, long long W, long long M, int c, uint32_t* out,
         const uint32_t* b3_row) {
  __shared__ E res[3];
  __shared__ E bank[12];
  const CanonB3<B3> b3{B3(b3_row)};
  const int lane = threadIdx.x;
  const long long m = blockIdx.x;
  auto src = [&](long long w) { return PlanePt<E>{S, M * W, m * W + w}; };
  if (lane < 3) res[lane] = lane == 0 ? src(W - 1).x() : lane == 1 ? src(W - 1).y() : src(W - 1).z();
  __syncwarp();
  for (long long w = W - 2; w >= 0; --w) {
    for (int i = 0; i < c; ++i) {
      hdbl_products<E>(res, bank, lane);
      __syncwarp();
      hdbl_second<E>(bank, b3, lane);
      __syncwarp();
      hdbl_finish<E>(res, bank, lane);
      __syncwarp();
    }
    hadd_products<E>(res, src(w), bank, lane);
    __syncwarp();
    hadd_second<E>(bank, b3, lane);
    __syncwarp();
    hadd_finish<E>(res, bank, lane);
    __syncwarp();
  }
  if (lane < 3) Coord<E>::store(out + (long long)lane * E::N * Coord<E>::NP * M, M, m, res[lane]);
}

// one stage of k_reduce; its largest stage's shared memory allowed first
template <class E, class B3>
static int launch_reduce(const ReduceArgs& a, unsigned int blocks, int threads, size_t bytes,
                         void* stream) {
  auto kernel = k_reduce<E, B3>;
  constexpr size_t most = combine_bytes<E>() > reduce_bytes<E>() ? combine_bytes<E>()
                                                                 : reduce_bytes<E>();
  if (most > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, threads, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// the running sums over L = W V lanes of M buckets each
template <class E, class B3>
static int launch_reduce_runs(const void* S, long long L, int M, void* TA, const void* b3,
                              void* stream) {
  if (L <= 0) return (int)cudaGetLastError();
  ReduceArgs a{0, (const uint32_t*)S, nullptr, (uint32_t*)TA, L, 0, 0, M, 0, 0,
               (const uint32_t*)b3};
  return launch_reduce<E, B3>(a, n_blocks(L, REDUCE_T), REDUCE_T, reduce_bytes<E>(), stream);
}

// the combine of W windows of V chunks (V a power of two)
template <class E, class B3>
static int launch_reduce_combine(const void* T, const void* A, long long ld, long long W, int V,
                                 int log_m, void* out, const void* b3, void* stream) {
  if (V <= 0 || (V & (V - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (W <= 0) return (int)cudaGetLastError();
  ReduceArgs a{1, (const uint32_t*)T, (const uint32_t*)A, (uint32_t*)out, 0, ld, W, 0, V, log_m,
               (const uint32_t*)b3};
  return launch_reduce<E, B3>(a, (unsigned int)W, V < COMBINE_T ? V : COMBINE_T,
                              combine_bytes<E>(), stream);
}

// Horner over W windows of each of M problems, one warp a problem
template <class E, class B3>
static int launch_horner(const void* S, long long W, long long M, int c, void* out,
                         const void* b3, void* stream) {
  if (W <= 0 || M <= 0 || M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  k_horner<E, B3><<<(unsigned int)M, 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)S, W, M, c, (uint32_t*)out, (const uint32_t*)b3);
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
