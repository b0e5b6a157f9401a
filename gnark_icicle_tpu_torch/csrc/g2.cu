// G2 (over Fp2 = Fp[u]/(u^2 - beta)) group-law kernels: the MSM's bucket
// accumulation, the masked wave step, setup's fixed-base comb and batch
// normalization, the complete add and the double (the bucket reduction and
// Horner are in g2_reduce.cu). Built once per curve with an Fp2 (field.cuh,
// CurveFp): BN254 at 8 words and beta = -1, BLS12-381 at 12 and beta = -1,
// BLS12-377 at 12 and beta = -5. BW6-761 has no Fp2 and no build of this
// file.
//
// Replaces TPU kernels K3 (gnark_icicle_tpu/ops/ec_t.py:649 TCurve2._mul,
// the Fp2 Karatsuba product of _add_impl :736 and _double_impl :761, which
// the reference's G2 bucket reduction and Horner launch once per round) and
// K5 (ops/ec_t.py:896 TCurve2.add_mixed_masked_fused, the whole masked,
// signed Fp2 mixed add, which the reference launches once per wave of the
// MSM) and, in setup, K6 (gnark_icicle_tpu/ops/ec_pallas.py:440
// PallasEC._build, the fixed-base ladder's Fp2 mixed adds) with
// g2_fixed_base, and batch_normalize (gnark_icicle_tpu/ops/fixed_base.py:95,
// the norm's Fermat inversion over Fp) with g2_normalize.
//
// Bound on the card: integer multiply rate first (a mixed add is 11 Fp2
// products, 33 Fp products, plus the products by b3: none for BLS12-381's
// 12 (1 + u), an add chain; 2 for BLS12-377's c u; 3 for BN254's general
// b3), registers second: an Fp2 element is 2N words and the add keeps about
// eight of them live, so at N = 12 the accumulator is staged in shared
// memory (field.cuh, "the staged mixed-add kernel"); g2_fixed_base is its
// comb mode, g2_add_mixed_masked its one-step form (no caller). g2_add and g2_double
// stay (the fold of split buckets, which no G2 path has yet; no caller).
// The mixed-add entries take g2 = 1 (G2's b3, the only group here) and
// refuse any other. Splitting a lane across two threads is later work.
#include "field.cuh"

using G2E = Elt2<CurveFp>;

extern "C" int ENTRY(g2_add_mixed_masked)(void* acc, long long ld, long long S, const void* table,
                                   const void* idx, const void* sign, const void* mask,
                                   const void* b3, int g2, void* stream) {
  if (g2 != 1) return (int)cudaErrorInvalidValue;
  const Walk walk{(int32_t*)idx, (const int32_t*)sign, nullptr, (const int32_t*)mask,
                  nullptr, 0, 0, 0};
  return launch_mixed_accumulate<G2E, G2B3>(acc, ld, S, table, walk, b3, stream);
}

extern "C" int ENTRY(g2_bucket_accumulate)(void* acc, long long L, const void* table,
                                    const void* order, const void* sign, const void* start,
                                    const void* count, const void* b3, int g2, void* stream) {
  if (g2 != 1) return (int)cudaErrorInvalidValue;
  const Walk walk{(int32_t*)order, (const int32_t*)sign, (const long long*)start,
                  (const int32_t*)count, nullptr, 0, 0, 0};
  return launch_mixed_accumulate<G2E, G2B3>(acc, L, L, table, walk, b3, stream);
}

extern "C" int ENTRY(g2_fixed_base)(void* acc, long long n, const void* scalars, int wr, int bits,
                             int w, const void* table, void* rows, const void* b3, int g2,
                             void* stream) {
  if (g2 != 1 || w < 1 || w > 16 || bits < 1 || bits > 32 * wr)
    return (int)cudaErrorInvalidValue;
  const Walk walk{(int32_t*)rows, nullptr, nullptr, nullptr, (const uint32_t*)scalars, wr, bits,
                  w};
  return launch_mixed_accumulate<G2E, G2B3>(acc, n, n, table, walk, b3, stream);
}

extern "C" int ENTRY(g2_normalize)(const void* p, long long n, void* xy, void* inf, int k,
                            void* stream) {
  return launch_normalize<G2E>(p, n, xy, inf, k, stream);
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
