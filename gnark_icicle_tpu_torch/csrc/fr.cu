// Fr (scalar field) kernels: the elementwise Montgomery product, the
// subtraction and the addition of PLONK's linear combinations, one NTT pass
// of up to 11 radix-2 stages in shared memory, and PLONK's quotient on the 4n
// coset. Built once per curve (field.cuh, CurveFr): BN254, BLS12-381 and
// BLS12-377 r at 8 words, BW6-761 r at 12.
//
// Replaces TPU kernel K1: gnark_icicle_tpu/ops/field_t.py:353 TField.mont_mul
// (Pallas body _mul_kernel, :314), which carries every NTT butterfly stage
// (gnark_icicle_tpu/ops/ntt.py:190 _tmul, :204 _butterflies_t) and through
// them computeH (gnark_icicle_tpu/backend/groth16/prove.py:31).
//
// Bound on the card: fr_mont_mul, fr_sub and fr_add read 8N bytes and write
// 4N per lane (N = 8 or 12 words), so at 2^16-2^19 lanes they are bound by
// device memory, not by the 2N^2 integer multiply-adds of one product; one
// thread a lane on the limb-major (N, n) layout, every limb load a coalesced
// 128-byte line per warp. A whole transform of n = 2^k is bound by its
// products instead: (n/2) k twiddle products of 2 * 2N^2 32-bit multiply-adds
// (0.076 ms at 2^19 and 8 words) against one read and one write of the array
// (0.010 ms). ntt_pass is designed for that: a transform is 2 or 3 passes
// (ops/ntt.py pass_split), each running its stages on a tile in shared memory
// (field.cuh "the NTT pass"), so the array crosses device memory 2-3 times,
// not k times, and the stages' products have the SMs to themselves between a
// tile's load and its store. The twiddles come from a stage-major table (stage
// s's 2^s twiddles consecutive), so neighbouring butterflies read
// neighbouring words; it is built once per domain. The scalings of the
// transforms ride the first load and the last store: the coset powers, 1/n
// and g^-i n^-1, and computeH's pointwise (a b - c) den.
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

// One pass of an NTT: block blk loads its tile (field.cuh ntt_index) with the
// load's scalings, runs the pass's stages in shared memory (DIF from the
// highest down, DIT from the lowest up), and stores it with the store's.
// 512 threads at 8 words (at most 128 registers a thread), 256 at 12
constexpr int NTT_THREADS = FrM::N > 8 ? 256 : 512;
constexpr int NTT_LOG_TILE_MAX = 11;  // 2048 elements: 64 KB at 8 words, 96 KB at 12

__global__ void __launch_bounds__(NTT_THREADS) k_ntt_pass(NttPass a) {
  extern __shared__ uint32_t sm[];
  const long long blk = blockIdx.x;
  const int E = 1 << ntt_log_tile(a);
  for (int e = threadIdx.x; e < E; e += blockDim.x) ntt_load<FrM>(a, sm, blk, e);
  __syncthreads();
  for (int k = 0; k < a.c; ++k) {
    const int L = a.dif ? a.c - 1 - k : k;
    const uint32_t* tw = ntt_stage_twiddles(a, blk, L);
    for (int b = threadIdx.x; b < E / 2; b += blockDim.x) ntt_butterfly<FrM>(a, sm, tw, L, b);
    __syncthreads();
  }
  for (int e = threadIdx.x; e < E; e += blockDim.x) ntt_store<FrM>(a, sm, blk, e);
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

// x, out, tws, mul, sub, scale, post: (N, n) limb-major planes (scale and
// post (N, 1) where their ld is 1); mul, sub, scale and post may be null.
// The tile of 2^(log_g + c + log_t) elements must divide n, and log_t may
// not exceed s_lo. Above 48 KB a block's shared memory takes the function
// attribute, set once; a refused launch is returned, never skipped.
extern "C" int ENTRY(ntt_pass)(const void* x, void* out, const void* tws, const void* mul,
                               const void* sub, const void* scale, long long scale_ld,
                               const void* post, long long post_ld, long long n, int s_lo, int c,
                               int log_t, int log_g, int dif, void* stream) {
  static bool attr_set = false;
  const int log_e = log_g + c + log_t;
  if (log_e > NTT_LOG_TILE_MAX || log_t > s_lo || c < 0 || log_g < 0 || n < (1LL << log_e) ||
      (n & ((1LL << log_e) - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(k_ntt_pass,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (4 << NTT_LOG_TILE_MAX) * FrM::N);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  NttPass a{(const uint32_t*)x, (uint32_t*)out, (const uint32_t*)tws, (const uint32_t*)mul,
            (const uint32_t*)sub, (const uint32_t*)scale, (const uint32_t*)post,
            n, scale_ld, post_ld, s_lo, c, log_t, log_g, dif};
  const long long E = 1LL << log_e;
  const int threads = E / 2 < 32 ? 32 : (E / 2 > NTT_THREADS ? NTT_THREADS : (int)(E / 2));
  k_ntt_pass<<<(unsigned int)(n >> log_e), threads, (size_t)(4 * E * FrM::N),
               (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
