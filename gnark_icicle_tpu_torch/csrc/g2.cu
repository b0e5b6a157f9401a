// G2 (over Fp2 = Fp[u]/(u^2 - beta)) group-law kernels: the MSM wave step,
// the complete add and the double. Built once per curve with an Fp2
// (field.cuh, CurveFp): BN254 at 8 words and beta = -1, BLS12-381 at 12 and
// beta = -1, BLS12-377 at 12 and beta = -5. BW6-761 has no Fp2 and no build
// of this file.
//
// Replaces TPU kernels K3 (gnark_icicle_tpu/ops/ec_t.py:649 TCurve2._mul,
// the Fp2 Karatsuba product of the G2 wave) and K5 (ops/ec_t.py:896
// TCurve2.add_mixed_masked_fused, the whole masked, signed Fp2 mixed add).
//
// Bound on the card: integer multiply rate first (a mixed add is 11 Fp2
// products, 33 Fp products), registers second: an Fp2 element is 2N words,
// and the schedule keeps about ten of them live, so the compiler is near its
// 255-register limit at N = 8 and spills at N = 12. The design is the G1 one
// (one fused kernel per wave, gather by index inside, one lane per thread)
// with half the threads per block, which leaves the compiler the full
// register file per thread; splitting the add across two threads per lane is
// later work.
#include "field.cuh"

using G2E = Elt2<CurveFp>;

extern "C" int ENTRY(g2_add_mixed_masked)(void* acc, long long ld, long long S, const void* table,
                                   const void* idx, const void* sign, const void* mask,
                                   const void* b3, void* stream) {
  if (S > 0)
    k_add_mixed_masked<G2E><<<n_blocks(S, 128), 128, 0, (cudaStream_t)stream>>>(
        (uint32_t*)acc, ld, S, (const uint32_t*)table, (const int32_t*)idx,
        (const int32_t*)sign, (const int32_t*)mask, (const uint32_t*)b3);
  return (int)cudaGetLastError();
}

extern "C" int ENTRY(g2_add)(const void* p, long long ldp, const void* q, long long ldq, void* o,
                      long long ldo, long long n, const void* b3, void* stream) {
  if (n > 0)
    k_add<G2E><<<n_blocks(n, 128), 128, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, ldp, (const uint32_t*)q, ldq, (uint32_t*)o, ldo, n,
        (const uint32_t*)b3);
  return (int)cudaGetLastError();
}

extern "C" int ENTRY(g2_double)(const void* p, long long ldp, void* o, long long ldo, long long n,
                         const void* b3, void* stream) {
  if (n > 0)
    k_double<G2E><<<n_blocks(n, 128), 128, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, ldp, (uint32_t*)o, ldo, n, (const uint32_t*)b3);
  return (int)cudaGetLastError();
}
