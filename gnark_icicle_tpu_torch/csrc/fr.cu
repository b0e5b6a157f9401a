// Fr (scalar field) kernels: the elementwise Montgomery product, the
// subtraction computeH needs, the addition of PLONK's linear combinations,
// one radix-2 NTT stage, and PLONK's quotient on the 4n coset. Built once per
// curve (field.cuh, CurveFr): BN254, BLS12-381 and BLS12-377 r at 8 words,
// BW6-761 r at 12.
//
// Replaces TPU kernel K1: gnark_icicle_tpu/ops/field_t.py:353 TField.mont_mul
// (Pallas body _mul_kernel, :314), which carries every NTT butterfly stage
// (gnark_icicle_tpu/ops/ntt.py:190 _tmul, :204 _butterflies_t) and through
// them computeH (gnark_icicle_tpu/backend/groth16/prove.py:31).
//
// Bound on the card: fr_mont_mul and fr_sub read 8N bytes and write 4N per
// lane (N = 8 or 12 words), so at 2^16-2^18 lanes they are bound by device
// memory, not by the 2N^2 integer multiply-adds of one product. An NTT stage
// is the same plus a twiddle read. The design keeps one lane per thread on
// the limb-major (N, n) layout, so every limb load is a coalesced 128-byte
// line per warp,
// and fuses the twiddle product into the butterfly (no separate pass over
// the d-half as the TPU version makes). Fusing several stages through shared
// memory is later work.
//
// plonk_quotient is the row function of gnark_icicle_tpu/backend/plonk/
// prove.py:176-218 (_quotient_chunk_fn: 21 Montgomery products and 16 adds
// and subtractions a row, in jnp there; the reference's own products are K1)
// in one pass, one thread a row. It reads 15 Fr values a row and writes one:
// at 8 words, 2^19 rows move 256 MiB (0.08 ms at 3.35 TB/s) against 21 * 2N^2
// = 2,688 multiply-adds of 32 bits a row (0.17 ms at the card's rate), so it
// is bound by operations; in plain PyTorch it would be 21 passes of the
// plain product over every 4n array. The reference's uint16 packing and row
// chunks (prove.py:128-130, :178-181) existed for v5e's memory and are gone:
// the sixteen 4n inputs fit the card.
#include "field.cuh"

using FrM = CurveFr;
using Fr = Elt<FrM>;

// out = a * b; b is either (N, n) or one broadcast column (b_ld == 1).
__global__ void k_fr_mont_mul(const uint32_t* a, const uint32_t* b, long long b_ld, int b_bcast,
                              uint32_t* out, long long n) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= n) return;
  const Fr x = fload<FrM>(a, n, l);
  const Fr y = fload<FrM>(b, b_ld, b_bcast ? 0 : l);
  fstore<FrM>(out, n, l, fmul(x, y));
}

__global__ void k_fr_sub(const uint32_t* a, const uint32_t* b, uint32_t* out, long long n) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= n) return;
  fstore<FrM>(out, n, l, fsub(fload<FrM>(a, n, l), fload<FrM>(b, n, l)));
}

__global__ void k_fr_add(const uint32_t* a, const uint32_t* b, uint32_t* out, long long n) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= n) return;
  fstore<FrM>(out, n, l, fadd(fload<FrM>(a, n, l), fload<FrM>(b, n, l)));
}

// the quotient's inputs, each (N, n) Montgomery, in this order
enum { QA, QB, QC, QZ, QZW, QQK, QQL, QQR, QQM, QQO, QS1, QS2, QS3, QXS, QL1, Q_INPUTS };
struct QuotientIn {
  const uint32_t* p[Q_INPUTS];
};
// the constants, columns of an (N, 7) table: beta, gamma, alpha, beta k1,
// beta k2, alpha^2, one
enum { CBETA, CGAMMA, CALPHA, CBK1, CBK2, CALPHA2, CONE, Q_CONSTS };

// One row of T(x) Z_H(x) = gate + alpha perm + alpha^2 L1 (Z - 1), divided by
// Z_H, on the coset: the reference's order of products and adds (prove.py
// :191-217), so the result is its Montgomery value. 1/Z_H cycles with period
// 4 on the 4n coset, so it is read from a (N, 4) table, column row mod 4.
__global__ void k_plonk_quotient(QuotientIn in, const uint32_t* consts, const uint32_t* zh_inv,
                                 uint32_t* out, long long n) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= n) return;
  auto ld = [&](int k) { return fload<FrM>(in.p[k], n, l); };
  auto cst = [&](int k) { return fload<FrM>(consts, Q_CONSTS, k); };
  const Fr A = ld(QA), B = ld(QB), C = ld(QC);
  Fr gate = fmul(ld(QQL), A);
  gate = fadd(gate, fmul(ld(QQR), B));
  gate = fadd(gate, fmul(fmul(ld(QQM), A), B));
  gate = fadd(gate, fmul(ld(QQO), C));
  gate = fadd(gate, ld(QQK));
  const Fr beta = cst(CBETA), gamma = cst(CGAMMA);
  const Fr xs = ld(QXS);
  Fr lhs = fadd(fadd(A, fmul(beta, xs)), gamma);
  lhs = fmul(lhs, fadd(fadd(B, fmul(cst(CBK1), xs)), gamma));
  lhs = fmul(lhs, fadd(fadd(C, fmul(cst(CBK2), xs)), gamma));
  const Fr z = ld(QZ);
  lhs = fmul(lhs, z);
  Fr rhs = fadd(fadd(A, fmul(beta, ld(QS1))), gamma);
  rhs = fmul(rhs, fadd(fadd(B, fmul(beta, ld(QS2))), gamma));
  rhs = fmul(rhs, fadd(fadd(C, fmul(beta, ld(QS3))), gamma));
  rhs = fmul(rhs, ld(QZW));
  const Fr perm = fsub(rhs, lhs);
  const Fr start = fmul(ld(QL1), fsub(z, cst(CONE)));
  const Fr num = fadd(gate, fadd(fmul(cst(CALPHA), perm), fmul(cst(CALPHA2), start)));
  fstore<FrM>(out, n, l, fmul(num, fload<FrM>(zh_inv, 4, l & 3)));
}

// One radix-2 stage over (N, n) data in place. Stage half-width m: lane k
// of n/2 is butterfly j = k mod m of group g = k / m, touching elements
// i0 = 2mg + j and i1 = i0 + m with twiddle tw[j * stride] (the layout of
// gnark_icicle_tpu/ops/ntt.py:224, view (-1, 2, m)).
//   DIF: (a, b) -> (a + b, (a - b) w)        DIT: (a, b) -> (a + bw, a - bw)
__global__ void k_ntt_stage(uint32_t* x, long long n, long long m, long long stride,
                            const uint32_t* tw, long long tw_ld, int dif) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n / 2) return;
  const long long g = k / m, j = k - g * m;
  const long long i0 = 2 * m * g + j, i1 = i0 + m;
  const Fr w = fload<FrM>(tw, tw_ld, j * stride);
  const Fr a = fload<FrM>(x, n, i0);
  const Fr b = fload<FrM>(x, n, i1);
  if (dif) {
    fstore<FrM>(x, n, i0, fadd(a, b));
    fstore<FrM>(x, n, i1, fmul(fsub(a, b), w));
  } else {
    const Fr bw = fmul(b, w);
    fstore<FrM>(x, n, i0, fadd(a, bw));
    fstore<FrM>(x, n, i1, fsub(a, bw));
  }
}

extern "C" int ENTRY(fr_mont_mul)(const void* a, const void* b, long long b_ld, int b_bcast, void* out,
                           long long n, void* stream) {
  if (n > 0)
    k_fr_mont_mul<<<n_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, b_ld, b_bcast, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int ENTRY(fr_sub)(const void* a, const void* b, void* out, long long n, void* stream) {
  if (n > 0)
    k_fr_sub<<<n_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int ENTRY(fr_add)(const void* a, const void* b, void* out, long long n, void* stream) {
  if (n > 0)
    k_fr_add<<<n_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

// in: a host array of the Q_INPUTS device pointers, in the enum's order
extern "C" int ENTRY(plonk_quotient)(const void* const* in, const void* consts, const void* zh_inv,
                                     void* out, long long n, void* stream) {
  QuotientIn q;
  for (int k = 0; k < Q_INPUTS; ++k) q.p[k] = (const uint32_t*)in[k];
  if (n > 0)
    k_plonk_quotient<<<n_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
        q, (const uint32_t*)consts, (const uint32_t*)zh_inv, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int ENTRY(ntt_stage)(void* x, long long n, long long m, long long stride, const void* tw,
                         long long tw_ld, int dif, void* stream) {
  if (n > 1)
    k_ntt_stage<<<n_blocks(n / 2, 256), 256, 0, (cudaStream_t)stream>>>(
        (uint32_t*)x, n, m, stride, (const uint32_t*)tw, tw_ld, dif);
  return (int)cudaGetLastError();
}
