// The MSM's bucket reduction and Horner over G2 (Fp2 = Fp[u]/(u^2 - beta)),
// built once per curve with an Fp2 beside g2.cu (field.cuh, CurveFp):
// BN254 at 8 words, BLS12-381 and BLS12-377 at 12. A source of its own so
// that nvcc builds it in a process of its own, beside g2.cu (the 12-word
// G2 libraries are the build's longest).
//
// Replaces TPU kernel K3 (gnark_icicle_tpu/ops/ec_t.py:649 TCurve2._mul,
// the Fp2 Karatsuba product of _add_impl :736 and _double_impl :761) in its
// MSM role: the reference's G2 bucket reduction and Horner launch an add or
// a double per round.
//
// At most three launches per MSM (field.cuh, "the reduction and Horner
// kernels"): g2_bucket_reduce (running sums; 2 W B complete adds of 36 Fp
// products, more with b3's, bound by the multiply rate), g2_reduce_combine
// (one block per window, latency-bound) and g2_horner (one warp a problem;
// bound by its chain of doubles, each at its latency; M problems of
// msm_batch are M warps of one launch). Every G2 coordinate is 16
// words or more, so the running sums hold their points and the add's
// temporaries in shared memory and run one out-of-line add and double
// (k_add spilled up to 1,176 bytes at N = 12). The entries take g2 = 1
// (G2's b3) and refuse any other.
#include "field.cuh"

using G2E = Elt2<CurveFp>;

// each entry with G2's b3 form (g2 must be 1)
extern "C" int ENTRY(g2_bucket_reduce)(const void* buckets, long long L, int M, void* TA,
                                const void* b3, int g2, void* stream) {
  if (g2 != 1) return (int)cudaErrorInvalidValue;
  return launch_reduce_runs<G2E, G2B3>(buckets, L, M, TA, b3, stream);
}

extern "C" int ENTRY(g2_reduce_combine)(const void* T, const void* A, long long ld, long long W,
                                 int V, int log_m, void* out, const void* b3, int g2,
                                 void* stream) {
  if (g2 != 1) return (int)cudaErrorInvalidValue;
  return launch_reduce_combine<G2E, G2B3>(T, A, ld, W, V, log_m, out, b3, stream);
}

extern "C" int ENTRY(g2_horner)(const void* S, long long W, long long M, int c, void* out,
                         const void* b3, int g2, void* stream) {
  if (g2 != 1) return (int)cudaErrorInvalidValue;
  return launch_horner<G2E, G2B3>(S, W, M, c, out, b3, stream);
}
