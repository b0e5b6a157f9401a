// G1 (over Fp) group-law kernels: the MSM wave step, the complete add and
// the double. Built once per curve (field.cuh, CurveFp): BN254 at 8 words,
// BLS12-381 and BLS12-377 at 12, BW6-761 at 24. BW6-761's G2 lies over Fp too
// (the sextic twist y^2 = x^3 + 4): it runs these entries with its own b3 row.
//
// Replaces TPU kernels K2 (gnark_icicle_tpu/ops/ec_t.py:266 TCurve._mul, the
// Fp product called 11 times per wave step), K4 (ops/ec_t.py:529
// TCurve.add_mixed_masked_fused, the whole masked, signed mixed add) and, in
// setup, K6 (gnark_icicle_tpu/ops/ec_pallas.py:440 PallasEC._build, the
// fixed-base ladder's mixed adds through ops/ec.py DevCurve).
//
// Bound on the card: integer multiply rate. A mixed add is 11 Fp products
// (11 * 2N^2 multiply-adds: 1,408 at N = 8, 3,168 at N = 12, 12,672 at
// N = 24) against 8N bytes gathered and 24N bytes of accumulator read and
// written, so it sits far above the memory roofline; registers come next
// (three accumulator coordinates, the gathered point and about six
// temporaries of N words each: about 240 registers at N = 24, so BW6-761
// spills). The design fuses the whole RCB16 schedule, the table gather (by
// index, inside the kernel), the sign and the mask into one kernel, one lane
// per thread, so nothing between the 11 products touches device memory;
// masked-off lanes return before loading.
#include "field.cuh"

using G1E = Elt<CurveFp>;

extern "C" int ENTRY(g1_add_mixed_masked)(void* acc, long long ld, long long S, const void* table,
                                   const void* idx, const void* sign, const void* mask,
                                   const void* b3, void* stream) {
  if (S > 0)
    k_add_mixed_masked<G1E><<<n_blocks(S, 256), 256, 0, (cudaStream_t)stream>>>(
        (uint32_t*)acc, ld, S, (const uint32_t*)table, (const int32_t*)idx,
        (const int32_t*)sign, (const int32_t*)mask, (const uint32_t*)b3);
  return (int)cudaGetLastError();
}

extern "C" int ENTRY(g1_add)(const void* p, long long ldp, const void* q, long long ldq, void* o,
                      long long ldo, long long n, const void* b3, void* stream) {
  if (n > 0)
    k_add<G1E><<<n_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, ldp, (const uint32_t*)q, ldq, (uint32_t*)o, ldo, n,
        (const uint32_t*)b3);
  return (int)cudaGetLastError();
}

extern "C" int ENTRY(g1_double)(const void* p, long long ldp, void* o, long long ldo, long long n,
                         const void* b3, void* stream) {
  if (n > 0)
    k_double<G1E><<<n_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, ldp, (uint32_t*)o, ldo, n, (const uint32_t*)b3);
  return (int)cudaGetLastError();
}
