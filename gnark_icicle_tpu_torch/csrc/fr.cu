// Fr (scalar field) kernels: the elementwise Montgomery product, the
// subtraction and the addition of PLONK's linear combinations, one NTT pass
// of up to 11 radix-2 stages in shared memory, PLONK's quotient on the 4n
// coset and the batch inversion of its tables. Built once per curve
// (field.cuh, CurveFr): BN254, BLS12-381 and BLS12-377 r at 8 words, BW6-761
// r at 12.
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
// in one pass, one thread a row (field.cuh quotient_row). It reads 15 Fr
// values a row and writes one: at 8 words, 2^19 rows move 256 MiB (0.08 ms
// at 3.35 TB/s) against 21 * 2N^2 = 2,688 multiply-adds of 32 bits a row
// (0.17 ms at the card's rate), so it is bound by operations. A row is a
// chain of products with little to overlap, so warps hide its latency and
// registers decide the warps. Each choice below was measured against its
// alternatives at 2^19 rows (NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// - __launch_bounds__(256, 3): 24 warps an SM at 8 words, at most 80
//   registers (12-16 bytes spill); 4 blocks at 64 registers spill 92 bytes
//   and run no faster, 2 blocks at 128 no slower;
// - each input loaded where the row uses it, and loaded again where it is
//   used again (field.cuh fload_pinned: the compiler may neither keep the
//   first load nor hoist it), the terms one after the other;
// - the 64-bit product with its outer loop rolled two steps a turn (fewer
//   registers than unrolled: 0.37 against 0.50 ms; the PTX carry-chain
//   product 0.62), the constants by value in the kernel's parameters, read
//   as operands from the constant bank;
// - 20 products a row, the gate taken as A (ql + qm B) + qr B + qo C + qk
//   (the reference's 21: 5 % slower);
// - canonical values throughout (field.cuh QuotientOps): lazy ones, where r
//   leaves room (4r < R: BN254, BLS12-377, BW6-761 r; not BLS12-381's),
//   ran 3.5 % slower on BN254 at these registers.
// The reference's uint16 packing and row chunks (prove.py:128-130,
// :178-181) existed for v5e's memory and are gone: the sixteen 4n inputs
// fit the card.
//
// fr_batch_inv is the elementwise inverse (0 -> 0) over a (N, n) array,
// which the PLONK quotient's tables take once per domain (the 4n values
// n (x - 1)). The JAX package computes it as one Fermat power, a scan of
// about 1.5 bits products over the whole array (LimbField.mont_inv, its
// products K1), each a full read and write of the array. Here it is one
// launch of Montgomery's trick over BINV_K lanes a thread (field.cuh
// batch_inv_lanes): 3 products a lane and one Fermat chain a thread. The
// function needs 3 products a nonzero element and one chain in all, its
// bound; the time is a thread's chain of about 1.5 bits dependent
// products, which k trades against the chains' work (k = 32 was fastest of
// 8-64). Its values are lazy where r leaves room (5 % faster than canonical
// on BN254).
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

// at 8 words 3 blocks of 256 an SM (24 warps, at most 80 registers a
// thread); BW6-761's 12-word row takes the registers it needs
constexpr int Q_THREADS = 256;
constexpr int Q_MIN_BLOCKS = FrM::N > 8 ? 1 : 3;

__global__ void __launch_bounds__(Q_THREADS, Q_MIN_BLOCKS)
    k_plonk_quotient(const QuotientIn in, const QuotientConsts<FrM> k, uint32_t* out) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= in.n) return;
  fstore<FrM>(out, in.n, l, quotient_row<FrM>(in, k, l));
}

// The batch inversion, one launch: block b's thread t takes the BINV_K
// lanes b BINV_T BINV_K + t + i BINV_T, so that at each step a warp touches
// 32 neighbouring lanes (field.cuh batch_inv_lanes)
constexpr int BINV_T = 64, BINV_K = 32;

__global__ void __launch_bounds__(BINV_T) k_fr_batch_inv(const uint32_t* x, uint32_t* out,
                                                         long long n) {
  const long long first = (long long)blockIdx.x * BINV_T * BINV_K + threadIdx.x;
  if (first >= n) return;
  const long long rest = (n - first + BINV_T - 1) / BINV_T;
  batch_inv_lanes<FrM>(x, n, out, first, BINV_T, rest < BINV_K ? (int)rest : BINV_K);
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

// in: a host array of the Q_INPUTS device pointers, in the enum's order;
// consts: HOST memory, the (N, Q_CONSTS) limb-major table (passed by value)
extern "C" int ENTRY(plonk_quotient)(const void* const* in, const void* consts, const void* zh_inv,
                                     void* out, long long n, void* stream) {
  QuotientIn q;
  for (int k = 0; k < Q_INPUTS; ++k) q.p[k] = (const uint32_t*)in[k];
  q.zh_inv = (const uint32_t*)zh_inv;
  q.n = n;
  QuotientConsts<FrM> c;
  const uint32_t* h = (const uint32_t*)consts;
  for (int i = 0; i < Q_CONSTS; ++i)
    for (int j = 0; j < FrM::N; ++j) c.c[i].v[j] = h[j * Q_CONSTS + i];
  if (n > 0)
    k_plonk_quotient<<<n_blocks(n, Q_THREADS), Q_THREADS, 0, (cudaStream_t)stream>>>(
        q, c, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// x, out: (N, n)
extern "C" int ENTRY(fr_batch_inv)(const void* x, void* out, long long n, void* stream) {
  if (n > 0)
    k_fr_batch_inv<<<n_blocks(n, BINV_T * BINV_K), BINV_T, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

// x, out, mul, sub, scale, post: (N, n) limb-major planes (scale and post
// (N, 1) where their ld is 1); mul, sub, scale and post may be null. tws:
// (N, tw_ld) with tw_ld >= 2^(s_lo + c); a pass of a batch of transforms of m
// (n / m blocks of m consecutive elements, stages below log m) reads the
// m-wide table of one transform. The tile of 2^(log_g + c + log_t) elements
// must divide n, and log_t may not exceed s_lo. Above 48 KB a block's shared
// memory takes the function attribute, which belongs to the current device:
// it is set at every such launch, as field.cuh's other kernels set theirs, so
// that every card takes it. A refused launch is returned, never skipped.
extern "C" int ENTRY(ntt_pass)(const void* x, void* out, const void* tws, long long tw_ld,
                               const void* mul, const void* sub, const void* scale,
                               long long scale_ld,
                               const void* post, long long post_ld, long long n, int s_lo, int c,
                               int log_t, int log_g, int dif, void* stream) {
  const int log_e = log_g + c + log_t;
  if (log_e > NTT_LOG_TILE_MAX || log_t > s_lo || c < 0 || log_g < 0 || n < (1LL << log_e) ||
      (n & ((1LL << log_e) - 1)) != 0 || tw_ld < (1LL << (s_lo + c)))
    return (int)cudaErrorInvalidValue;
  if ((4 << log_e) * FrM::N > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(k_ntt_pass,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (4 << NTT_LOG_TILE_MAX) * FrM::N);
    if (e != cudaSuccess) return (int)e;
  }
  NttPass a{(const uint32_t*)x, (uint32_t*)out, (const uint32_t*)tws, (const uint32_t*)mul,
            (const uint32_t*)sub, (const uint32_t*)scale, (const uint32_t*)post,
            n, tw_ld, scale_ld, post_ld, s_lo, c, log_t, log_g, dif};
  const long long E = 1LL << log_e;
  const int threads = E / 2 < 32 ? 32 : (E / 2 > NTT_THREADS ? NTT_THREADS : (int)(E / 2));
  k_ntt_pass<<<(unsigned int)(n >> log_e), threads, (size_t)(4 * E * FrM::N),
               (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
