// The MSM's bucket reduction and Horner over G1 (and BW6-761's G2 over Fp),
// built once per curve beside g1.cu (field.cuh, CurveFp): BN254 at 8 words,
// BLS12-381 and BLS12-377 at 12, BW6-761 at 24. A source of its own so that
// nvcc builds it in a process of its own, beside g1.cu.
//
// Replaces TPU kernel K2 (gnark_icicle_tpu/ops/ec_t.py:266 TCurve._mul, the
// Fp product of _add_impl :340 and _double_impl :365) in its MSM role: the
// reference's bucket reduction (ops/msm.py:399-469, _weighted_chunked_t and
// its suffix scans) and scanned Horner (:637-642) launch an add or a double
// per round, 82 adds and 260 doubles per 2^17 Chain MSM.
//
// At most three launches per MSM (field.cuh, "the reduction and Horner
// kernels"): g1_bucket_reduce, the running sums over W V chunks of M
// buckets (2 W B complete adds of 12 products, bound by the multiply rate;
// V fills the card); g1_reduce_combine, one block per window: serial runs,
// a suffix scan over the threads and a tree in shared memory (O(V) adds,
// latency-bound); g1_horner, one warp a problem whose lanes take each
// round's independent products (bound by the chain of c (W - 1) doubles,
// each at its latency; the warp brings a double's chain from 8 products to
// 2: on an H100 2.7-6.4x faster than the same chain on one thread,
// PERF.md). A batch of M problems (ops/msm.py msm_batch) is one launch of
// each: the running sums and the combine over its M W windows, Horner on M
// warps side by side.
// The entries take g2 = 0 for G1's b3 and g2 = 1 for G2's, which only
// BW6-761's build has on these entries, and refuse any other.
#include "field.cuh"

using G1E = Elt<CurveFp>;

// each entry with the b3 form of group g2 (0: G1, 1: G2)
#if defined(CURVE_BW6_761)
#define G1_DISPATCH(launch, ...)                                  \
  if (g2 == 0) return launch<G1E, G1B3>(__VA_ARGS__);            \
  if (g2 == 1) return launch<G1E, TwistB3>(__VA_ARGS__);         \
  return (int)cudaErrorInvalidValue;
#else
#define G1_DISPATCH(launch, ...)                                  \
  if (g2 == 0) return launch<G1E, G1B3>(__VA_ARGS__);            \
  return (int)cudaErrorInvalidValue;
#endif

extern "C" int ENTRY(g1_bucket_reduce)(const void* buckets, long long L, int M, void* TA,
                                const void* b3, int g2, void* stream) {
  G1_DISPATCH(launch_reduce_runs, buckets, L, M, TA, b3, stream)
}

extern "C" int ENTRY(g1_reduce_combine)(const void* T, const void* A, long long ld, long long W,
                                 int V, int log_m, void* out, const void* b3, int g2,
                                 void* stream) {
  G1_DISPATCH(launch_reduce_combine, T, A, ld, W, V, log_m, out, b3, stream)
}

extern "C" int ENTRY(g1_horner)(const void* S, long long W, long long M, int c, void* out,
                         const void* b3, int g2, void* stream) {
  G1_DISPATCH(launch_horner, S, W, M, c, out, b3, stream)
}
