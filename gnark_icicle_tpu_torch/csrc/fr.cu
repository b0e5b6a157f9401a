// Fr (scalar field) kernels: the elementwise Montgomery product, the
// subtraction computeH needs, and one radix-2 NTT stage. Built once per curve
// (field.cuh, CurveFr): BN254, BLS12-381 and BLS12-377 r at 8 words, BW6-761 r
// at 12.
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

extern "C" int ENTRY(ntt_stage)(void* x, long long n, long long m, long long stride, const void* tw,
                         long long tw_ld, int dif, void* stream) {
  if (n > 1)
    k_ntt_stage<<<n_blocks(n / 2, 256), 256, 0, (cudaStream_t)stream>>>(
        (uint32_t*)x, n, m, stride, (const uint32_t*)tw, tw_ld, dif);
  return (int)cudaGetLastError();
}
