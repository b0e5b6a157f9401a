// G1 (over Fp) group-law kernels: the MSM's bucket accumulation, the masked
// wave step, the fixed-base comb and the batch normalization of setup and
// the SRS, the complete add and the double (the bucket reduction and
// Horner are in g1_reduce.cu). Built once per curve (field.cuh, CurveFp): BN254 at 8 words,
// BLS12-381 and BLS12-377 at 12, BW6-761 at 24. BW6-761's G2 lies over Fp
// too (the sextic twist y^2 = x^3 + 4): it runs these entries with its own
// b3 (TwistB3).
//
// Replaces TPU kernels K2 (gnark_icicle_tpu/ops/ec_t.py:266 TCurve._mul, the
// Fp product of _add_impl :340 and _double_impl :365, which the reference's
// bucket reduction, ops/msm.py:399-469, and its scanned Horner, :637-642,
// launch once per round), K4 (ops/ec_t.py:529
// TCurve.add_mixed_masked_fused, the whole masked, signed mixed add, which
// the reference launches once per wave of the MSM) and, in setup and the
// SRS, K6 (gnark_icicle_tpu/ops/ec_pallas.py:440 PallasEC._build, the
// fixed-base ladder's mixed adds through ops/ec.py DevCurve, one launch per
// scalar bit) with g1_fixed_base, and the JAX package's batch_normalize
// (gnark_icicle_tpu/ops/fixed_base.py:95) with g1_normalize.
//
// Bound on the card: integer multiply rate. A mixed add is 11 Fp products
// (11 * 2N^2 multiply-adds: 1,408 at N = 8, 3,168 at N = 12, 12,672 at
// N = 24; b3 is an integer on every curve's G1, so its products are add
// chains) against 8N bytes gathered, so it sits far above the memory
// roofline. g1_bucket_accumulate runs a whole MSM's bucket sums in one
// launch, each lane's run of points in a loop with the accumulator held
// through it (field.cuh, "the staged mixed-add kernel"); g1_fixed_base runs
// the same kernel over a comb table, each lane its scalar's nonzero w-bit
// digits (about 60 adds at w = 4 where the ladder took 254 launches, one
// step each), and g1_normalize turns its projective points into affine
// plain words by Montgomery's trick over k lanes a thread.
// g1_add_mixed_masked, the one-step form, has no caller on the path. g1_add
// stays for the MSM's fold of split buckets, g1_double has no caller on the
// path. The mixed-add entries take g2 = 0 for G1's b3 and g2 = 1 for G2's,
// which only BW6-761's build has on these entries, and refuse any other.
#include "field.cuh"

using G1E = Elt<CurveFp>;

// k_mixed_accumulate with the b3 form of group g2 (0: G1, 1: G2)
static int mixed_accumulate(void* acc, long long ld, long long L, const void* table,
                            const Walk& walk, const void* b3, int g2, void* stream) {
  if (g2 == 0) return launch_mixed_accumulate<G1E, G1B3>(acc, ld, L, table, walk, b3, stream);
#if defined(CURVE_BW6_761)
  if (g2 == 1) return launch_mixed_accumulate<G1E, TwistB3>(acc, ld, L, table, walk, b3, stream);
#endif
  return (int)cudaErrorInvalidValue;
}

extern "C" int ENTRY(g1_add_mixed_masked)(void* acc, long long ld, long long S, const void* table,
                                   const void* idx, const void* sign, const void* mask,
                                   const void* b3, int g2, void* stream) {
  const Walk walk{(int32_t*)idx, (const int32_t*)sign, nullptr, (const int32_t*)mask,
                  nullptr, 0, 0, 0};
  return mixed_accumulate(acc, ld, S, table, walk, b3, g2, stream);
}

extern "C" int ENTRY(g1_bucket_accumulate)(void* acc, long long L, const void* table,
                                    const void* order, const void* sign, const void* start,
                                    const void* count, const void* b3, int g2, void* stream) {
  const Walk walk{(int32_t*)order, (const int32_t*)sign, (const long long*)start,
                  (const int32_t*)count, nullptr, 0, 0, 0};
  return mixed_accumulate(acc, L, L, table, walk, b3, g2, stream);
}

extern "C" int ENTRY(g1_fixed_base)(void* acc, long long n, const void* scalars, int wr, int bits,
                             int w, const void* table, void* rows, const void* b3, int g2,
                             void* stream) {
  if (w < 1 || w > 16 || bits < 1 || bits > 32 * wr) return (int)cudaErrorInvalidValue;
  const Walk walk{(int32_t*)rows, nullptr, nullptr, nullptr, (const uint32_t*)scalars, wr, bits,
                  w};
  return mixed_accumulate(acc, n, n, table, walk, b3, g2, stream);
}

extern "C" int ENTRY(g1_normalize)(const void* p, long long n, void* xy, void* inf, int k,
                            void* stream) {
  return launch_normalize<G1E>(p, n, xy, inf, k, stream);
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
