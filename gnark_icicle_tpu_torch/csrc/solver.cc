// Copied from native/solver.cc:1 for the PyTorch port (built by
// gnark_icicle_tpu_torch/native.py); tests/test_torch_copies.py holds the
// port's solves to the original's.
//
// Native witness-solver core: N x 64-limb Montgomery field arithmetic +
// instruction-ordered R1CS / SparseR1CS solving.
//
// Role parity: gnark-crypto's amd64-assembly fr.Element arithmetic
// (reference README.md:66-68) + the generated level-parallel solver
// (constraint/bn254/solver.go:426-540). The Python side orchestrates hint
// instructions (arbitrary host code, solver.go:205) and hands contiguous
// R1C runs to this core; all state lives in shared numpy buffers.
//
// Field-generic: templated on the limb count — N=4 covers any odd prime
// < 2^256 (BN254/BLS12-381/BLS12-377 fr), N=6 covers < 2^384 (BW6-761's
// 377-bit fr, the native 2-chain outer curve). Values are little-endian
// N x 64 limbs in Montgomery form (R = 2^(64N)).
//
// Build: g++ -O3 -shared -fPIC -fopenmp -o libsolver.so solver.cc

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;

namespace {

template <int N>
struct Field {
  u64 p[N];     // modulus
  u64 inv;      // -p^-1 mod 2^64
};

template <int N>
inline bool geq(const u64 a[N], const u64 b[N]) {
  for (int i = N - 1; i >= 0; --i) {
    if (a[i] != b[i]) return a[i] > b[i];
  }
  return true;
}

template <int N>
inline void sub_p(u64 a[N], const u64 p[N]) {
  u128 borrow = 0;
  for (int i = 0; i < N; ++i) {
    u128 d = (u128)a[i] - p[i] - borrow;
    a[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

template <int N>
inline void fadd(const Field<N>& f, const u64 a[N], const u64 b[N],
                 u64 out[N]) {
  u128 carry = 0;
  for (int i = 0; i < N; ++i) {
    u128 s = (u128)a[i] + b[i] + carry;
    out[i] = (u64)s;
    carry = s >> 64;
  }
  if (carry || geq<N>(out, f.p)) sub_p<N>(out, f.p);
}

template <int N>
inline void fsub(const Field<N>& f, const u64 a[N], const u64 b[N],
                 u64 out[N]) {
  u128 borrow = 0;
  for (int i = 0; i < N; ++i) {
    u128 d = (u128)a[i] - b[i] - borrow;
    out[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  if (borrow) {  // add p back
    u128 carry = 0;
    for (int i = 0; i < N; ++i) {
      u128 s = (u128)out[i] + f.p[i] + carry;
      out[i] = (u64)s;
      carry = s >> 64;
    }
  }
}

// CIOS Montgomery multiplication (Koc et al.)
template <int N>
inline void fmul(const Field<N>& f, const u64 a[N], const u64 b[N],
                 u64 out[N]) {
  u64 t[N + 2];
  std::memset(t, 0, sizeof(t));
  for (int i = 0; i < N; ++i) {
    // t += a[i] * b
    u128 carry = 0;
    for (int j = 0; j < N; ++j) {
      u128 s = (u128)a[i] * b[j] + t[j] + carry;
      t[j] = (u64)s;
      carry = s >> 64;
    }
    u128 s = (u128)t[N] + carry;
    t[N] = (u64)s;
    t[N + 1] = (u64)(s >> 64);
    // m = t[0] * inv mod 2^64; t += m*p; t >>= 64
    u64 m = t[0] * f.inv;
    carry = ((u128)m * f.p[0] + t[0]) >> 64;
    for (int j = 1; j < N; ++j) {
      u128 s2 = (u128)m * f.p[j] + t[j] + carry;
      t[j - 1] = (u64)s2;
      carry = s2 >> 64;
    }
    u128 s3 = (u128)t[N] + carry;
    t[N - 1] = (u64)s3;
    t[N] = t[N + 1] + (u64)(s3 >> 64);
    t[N + 1] = 0;
  }
  std::memcpy(out, t, N * 8);
  if (t[N] || geq<N>(out, f.p)) sub_p<N>(out, f.p);
}

template <int N>
inline bool is_zero(const u64 a[N]) {
  u64 acc = 0;
  for (int i = 0; i < N; ++i) acc |= a[i];
  return acc == 0;
}

// a^e mod p (Montgomery), e plain N x 64
template <int N>
void fpow(const Field<N>& f, const u64 a[N], const u64 e[N],
          const u64 one[N], u64 out[N]) {
  u64 base[N], acc[N];
  std::memcpy(base, a, N * 8);
  std::memcpy(acc, one, N * 8);
  for (int w = 0; w < N; ++w) {
    u64 bits = e[w];
    for (int i = 0; i < 64; ++i) {
      if (bits & 1) fmul<N>(f, acc, base, acc);
      bits >>= 1;
      fmul<N>(f, base, base, base);
    }
  }
  std::memcpy(out, acc, N * 8);
}

template <int N>
inline void finv(const Field<N>& f, const u64 a[N], const u64 one[N],
                 u64 out[N]) {
  // Fermat: a^(p-2)
  u64 e[N];
  u128 borrow = 2;
  for (int i = 0; i < N; ++i) {
    u128 d = (u128)f.p[i] - (u64)borrow;
    e[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  fpow<N>(f, a, e, one, out);
}

// Evaluate + solve a contiguous run of R1C instructions (see the N=4
// extern "C" wrapper below for the calling convention).
template <int N>
long long r1cs_solve_run_t(
    const u64* p_limbs, u64 inv,
    const u64* coeffs,
    const uint32_t* term_coeff, const uint32_t* term_wire,
    const long long* l_off, const long long* r_off, const long long* o_off,
    const long long* solved_wire,
    const long long* order, long long n_run, long long n_cons,
    u64* wires, uint8_t* assigned,
    u64* abc, const u64* one_mont) {
  Field<N> f;
  std::memcpy(f.p, p_limbs, N * 8);
  f.inv = inv;

  for (long long r = 0; r < n_run; ++r) {
    long long j = order[r];
    long long ranges[3][2] = {
        {l_off[j], r_off[j]},
        {r_off[j], o_off[j]},
        {o_off[j], l_off[j + 1]},
    };
    long long sw = solved_wire[j];
    bool unknown = sw >= 0 && !assigned[sw];

    u64 vals[3][N], unk_coeff[3][N];
    std::memset(vals, 0, sizeof(vals));
    std::memset(unk_coeff, 0, sizeof(unk_coeff));
    bool has_unk[3] = {false, false, false};

    for (int s = 0; s < 3; ++s) {
      for (long long t = ranges[s][0]; t < ranges[s][1]; ++t) {
        uint32_t w = term_wire[t];
        const u64* c = coeffs + N * term_coeff[t];
        if (unknown && (long long)w == sw) {
          fadd<N>(f, unk_coeff[s], c, unk_coeff[s]);
          has_unk[s] = true;
          continue;
        }
        if (!assigned[w]) return j;  // used-before-solved
        u64 prod[N];
        fmul<N>(f, c, wires + N * w, prod);
        fadd<N>(f, vals[s], prod, vals[s]);
      }
    }

    if (unknown) {
      int n_unk = has_unk[0] + has_unk[1] + has_unk[2];
      if (n_unk != 1) return j;
      u64 x[N];
      if (has_unk[2]) {
        // L*R = O_k + c*x  ->  x = (L*R - O_k) / c
        u64 lr[N], num[N];
        fmul<N>(f, vals[0], vals[1], lr);
        fsub<N>(f, lr, vals[2], num);
        if (std::memcmp(unk_coeff[2], one_mont, N * 8) == 0) {
          // c == 1: the overwhelmingly common case (fresh output wires) —
          // skip the field inversion entirely
          std::memcpy(x, num, N * 8);
        } else {
          u64 ci[N];
          finv<N>(f, unk_coeff[2], one_mont, ci);
          fmul<N>(f, num, ci, x);
        }
      } else {
        int s = has_unk[0] ? 0 : 1;
        int o = 1 - s;  // the other mul slot
        // (V_s + c*x) * V_o = O  ->  x = (O - V_s*V_o) / (c*V_o)
        u64 den[N];
        fmul<N>(f, unk_coeff[s], vals[o], den);
        if (is_zero<N>(den)) return j;
        u64 pv[N], num[N], di[N];
        fmul<N>(f, vals[s], vals[o], pv);
        fsub<N>(f, vals[2], pv, num);
        finv<N>(f, den, one_mont, di);
        fmul<N>(f, num, di, x);
      }
      std::memcpy(wires + N * sw, x, N * 8);
      assigned[sw] = 1;
      // fold the unknown's contribution back into the slot values
      for (int s = 0; s < 3; ++s) {
        if (has_unk[s]) {
          u64 prod[N];
          fmul<N>(f, unk_coeff[s], x, prod);
          fadd<N>(f, vals[s], prod, vals[s]);
        }
      }
    }

    // check L*R == O
    u64 lr[N], diff[N];
    fmul<N>(f, vals[0], vals[1], lr);
    fsub<N>(f, lr, vals[2], diff);
    if (!is_zero<N>(diff)) return j;

    std::memcpy(abc + N * j, vals[0], N * 8);                    // a
    std::memcpy(abc + N * (n_cons + j), vals[1], N * 8);         // b
    std::memcpy(abc + N * (2 * n_cons + j), vals[2], N * 8);     // c
  }
  return -1;
}

// Solve a contiguous run of SparseR1CS gates:
//   qL·a + qR·b + qM·a·b + qO·c + qC = 0
template <int N>
long long scs_solve_run_t(
    const u64* p_limbs, u64 inv,
    const uint32_t* xa, const uint32_t* xb, const uint32_t* xc,
    const u64* ql, const u64* qr, const u64* qm, const u64* qo,
    const u64* qc,
    const long long* solved_wire,
    const long long* order, long long n_run,
    u64* wires, uint8_t* assigned,
    u64* abc, long long n_gates, const u64* one_mont) {
  Field<N> f;
  std::memcpy(f.p, p_limbs, N * 8);
  f.inv = inv;

  for (long long r = 0; r < n_run; ++r) {
    long long j = order[r];
    uint32_t wa = xa[j], wb = xb[j], wc = xc[j];
    long long sw = solved_wire[j];
    bool in_a = (long long)wa == sw, in_b = (long long)wb == sw,
         in_c = (long long)wc == sw;
    bool unknown = sw >= 0 && !assigned[sw];

    if (unknown) {
      if ((!in_a && !assigned[wa]) || (!in_b && !assigned[wb]) ||
          (!in_c && !assigned[wc]))
        return j;
      u64 coef[N], cons[N];
      std::memset(coef, 0, sizeof(coef));
      std::memcpy(cons, qc + N * j, N * 8);
      if (in_a) fadd<N>(f, coef, ql + N * j, coef);
      else {
        u64 t[N];
        fmul<N>(f, ql + N * j, wires + N * wa, t);
        fadd<N>(f, cons, t, cons);
      }
      if (in_b) fadd<N>(f, coef, qr + N * j, coef);
      else {
        u64 t[N];
        fmul<N>(f, qr + N * j, wires + N * wb, t);
        fadd<N>(f, cons, t, cons);
      }
      if (in_c) fadd<N>(f, coef, qo + N * j, coef);
      else {
        u64 t[N];
        fmul<N>(f, qo + N * j, wires + N * wc, t);
        fadd<N>(f, cons, t, cons);
      }
      if (!is_zero<N>(qm + N * j)) {
        if (in_a && in_b) return j;  // quadratic in the unknown
        u64 t[N];
        if (in_a) {
          fmul<N>(f, qm + N * j, wires + N * wb, t);
          fadd<N>(f, coef, t, coef);
        } else if (in_b) {
          fmul<N>(f, qm + N * j, wires + N * wa, t);
          fadd<N>(f, coef, t, coef);
        } else {
          fmul<N>(f, qm + N * j, wires + N * wa, t);
          fmul<N>(f, t, wires + N * wb, t);
          fadd<N>(f, cons, t, cons);
        }
      }
      if (is_zero<N>(coef)) return j;
      u64 x[N], zero[N], neg_one[N];
      std::memset(zero, 0, sizeof(zero));
      fsub<N>(f, zero, one_mont, neg_one);
      if (std::memcmp(coef, neg_one, N * 8) == 0) {
        // coef == -1 (the builder's qO on nearly every gate): x = const
        std::memcpy(x, cons, N * 8);
      } else if (std::memcmp(coef, one_mont, N * 8) == 0) {
        fsub<N>(f, zero, cons, x);
      } else {
        u64 ci[N];
        fsub<N>(f, zero, cons, cons);
        finv<N>(f, coef, one_mont, ci);
        fmul<N>(f, cons, ci, x);
      }
      std::memcpy(wires + N * sw, x, N * 8);
      assigned[sw] = 1;
    }

    if (!assigned[wa] || !assigned[wb] || !assigned[wc]) return j;
    const u64 *va = wires + N * wa, *vb = wires + N * wb,
              *vc = wires + N * wc;
    u64 acc[N], t[N];
    fmul<N>(f, ql + N * j, va, acc);
    fmul<N>(f, qr + N * j, vb, t);
    fadd<N>(f, acc, t, acc);
    fmul<N>(f, qm + N * j, va, t);
    fmul<N>(f, t, vb, t);
    fadd<N>(f, acc, t, acc);
    fmul<N>(f, qo + N * j, vc, t);
    fadd<N>(f, acc, t, acc);
    fadd<N>(f, acc, qc + N * j, acc);
    if (!is_zero<N>(acc)) return j;
    std::memcpy(abc + N * j, va, N * 8);
    std::memcpy(abc + N * (n_gates + j), vb, N * 8);
    std::memcpy(abc + N * (2 * n_gates + j), vc, N * 8);
  }
  return -1;
}

template <int N>
void to_mont_batch_t(const u64* p_limbs, u64 inv, const u64* r2,
                     u64* vals, long long n) {
  Field<N> f;
  std::memcpy(f.p, p_limbs, N * 8);
  f.inv = inv;
  for (long long i = 0; i < n; ++i) {
    fmul<N>(f, vals + N * i, r2, vals + N * i);
  }
}

template <int N>
void from_mont_batch_t(const u64* p_limbs, u64 inv, u64* vals, long long n) {
  Field<N> f;
  std::memcpy(f.p, p_limbs, N * 8);
  f.inv = inv;
  u64 one[N];
  std::memset(one, 0, sizeof(one));
  one[0] = 1;
  for (long long i = 0; i < n; ++i) {
    fmul<N>(f, vals + N * i, one, vals + N * i);
  }
}

// Level-parallel variant of r1cs_solve_run: every instruction in `order`
// belongs to one dependency level (inputs produced strictly earlier), so
// iterations are independent and can run concurrently (≙ the reference's
// per-level goroutine pool, constraint/bn254/solver.go:426-532).
template <int N>
long long r1cs_solve_level_t(
    const u64* p_limbs, u64 inv,
    const u64* coeffs,
    const uint32_t* term_coeff, const uint32_t* term_wire,
    const long long* l_off, const long long* r_off, const long long* o_off,
    const long long* solved_wire,
    const long long* order, long long n_run, long long n_cons,
    u64* wires, uint8_t* assigned,
    u64* abc, const u64* one_mont) {
  long long fail = -1;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (long long r = 0; r < n_run; ++r) {
    if (fail >= 0) continue;
    long long rc = r1cs_solve_run_t<N>(
        p_limbs, inv, coeffs, term_coeff, term_wire, l_off, r_off, o_off,
        solved_wire, order + r, 1, n_cons, wires, assigned, abc, one_mont);
    if (rc >= 0) {
#ifdef _OPENMP
#pragma omp critical
#endif
      {
        if (fail < 0 || rc < fail) fail = rc;
      }
    }
  }
  return fail;
}

}  // namespace

// Stable C ABI: the original names are the 4-limb instantiation (any fr
// < 2^256); the "6" suffix serves 6-limb fields (BW6-761 fr < 2^384).
extern "C" {

long long r1cs_solve_run(
    const u64* p, u64 inv, const u64* coeffs, const uint32_t* tc,
    const uint32_t* tw, const long long* lo, const long long* ro,
    const long long* oo, const long long* sw, const long long* order,
    long long n_run, long long n_cons, u64* wires, uint8_t* assigned,
    u64* abc, const u64* one) {
  return r1cs_solve_run_t<4>(p, inv, coeffs, tc, tw, lo, ro, oo, sw, order,
                             n_run, n_cons, wires, assigned, abc, one);
}

long long r1cs_solve_run6(
    const u64* p, u64 inv, const u64* coeffs, const uint32_t* tc,
    const uint32_t* tw, const long long* lo, const long long* ro,
    const long long* oo, const long long* sw, const long long* order,
    long long n_run, long long n_cons, u64* wires, uint8_t* assigned,
    u64* abc, const u64* one) {
  return r1cs_solve_run_t<6>(p, inv, coeffs, tc, tw, lo, ro, oo, sw, order,
                             n_run, n_cons, wires, assigned, abc, one);
}

long long r1cs_solve_level(
    const u64* p, u64 inv, const u64* coeffs, const uint32_t* tc,
    const uint32_t* tw, const long long* lo, const long long* ro,
    const long long* oo, const long long* sw, const long long* order,
    long long n_run, long long n_cons, u64* wires, uint8_t* assigned,
    u64* abc, const u64* one) {
  return r1cs_solve_level_t<4>(p, inv, coeffs, tc, tw, lo, ro, oo, sw,
                               order, n_run, n_cons, wires, assigned, abc,
                               one);
}

long long r1cs_solve_level6(
    const u64* p, u64 inv, const u64* coeffs, const uint32_t* tc,
    const uint32_t* tw, const long long* lo, const long long* ro,
    const long long* oo, const long long* sw, const long long* order,
    long long n_run, long long n_cons, u64* wires, uint8_t* assigned,
    u64* abc, const u64* one) {
  return r1cs_solve_level_t<6>(p, inv, coeffs, tc, tw, lo, ro, oo, sw,
                               order, n_run, n_cons, wires, assigned, abc,
                               one);
}

long long scs_solve_run(
    const u64* p, u64 inv, const uint32_t* xa, const uint32_t* xb,
    const uint32_t* xc, const u64* ql, const u64* qr, const u64* qm,
    const u64* qo, const u64* qc, const long long* sw,
    const long long* order, long long n_run, u64* wires, uint8_t* assigned,
    u64* abc, long long n_gates, const u64* one) {
  return scs_solve_run_t<4>(p, inv, xa, xb, xc, ql, qr, qm, qo, qc, sw,
                            order, n_run, wires, assigned, abc, n_gates,
                            one);
}

long long scs_solve_run6(
    const u64* p, u64 inv, const uint32_t* xa, const uint32_t* xb,
    const uint32_t* xc, const u64* ql, const u64* qr, const u64* qm,
    const u64* qo, const u64* qc, const long long* sw,
    const long long* order, long long n_run, u64* wires, uint8_t* assigned,
    u64* abc, long long n_gates, const u64* one) {
  return scs_solve_run_t<6>(p, inv, xa, xb, xc, ql, qr, qm, qo, qc, sw,
                            order, n_run, wires, assigned, abc, n_gates,
                            one);
}

void to_mont_batch(const u64* p, u64 inv, const u64* r2, u64* vals,
                   long long n) {
  to_mont_batch_t<4>(p, inv, r2, vals, n);
}

void to_mont_batch6(const u64* p, u64 inv, const u64* r2, u64* vals,
                    long long n) {
  to_mont_batch_t<6>(p, inv, r2, vals, n);
}

void from_mont_batch(const u64* p, u64 inv, u64* vals, long long n) {
  from_mont_batch_t<4>(p, inv, vals, n);
}

void from_mont_batch6(const u64* p, u64 inv, u64* vals, long long n) {
  from_mont_batch_t<6>(p, inv, vals, n);
}

}  // extern "C"
