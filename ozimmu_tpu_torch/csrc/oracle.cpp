// Long-double host oracle: error metrics of a computed GEMM.
//
// The metric functions of ozimmu_tpu/native/oracle.cpp, unchanged: recompute
// the GEMM at higher precision (80-bit x87 long double accumulation) and
// report relative_residual = ||C - C_ref||_F / ||C_ref||_F and the
// elementwise max relative error, streamed, so no C_ref buffer is ever
// materialized (the reference's `mateval` use, test/main_test.cu:101-117).
// The single-C functions run their rows in parallel (OpenMP); the multi-C
// functions score many candidate C matrices against one accumulation on one
// thread, so their results do not depend on the thread count.
//
// Exposed with a plain C ABI for ctypes; built and bound by oracle.py.

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// error metrics, real: A [m,k] row-major, B [k,n] row-major, C [m,n]
// out[0] = relative_residual, out[1] = max_relative_error
// ---------------------------------------------------------------------------
void oz_error_metrics_d(int64_t m, int64_t n, int64_t k, const double* A,
                        const double* B, const double* C, double* out) {
  long double diff_sq = 0.0L, ref_sq = 0.0L, max_rel = 0.0L;
#pragma omp parallel reduction(+ : diff_sq, ref_sq) reduction(max : max_rel)
  {
#pragma omp for schedule(static)
    for (int64_t i = 0; i < m; ++i) {
      for (int64_t j = 0; j < n; ++j) {
        long double acc = 0.0L;
        const double* a = A + i * k;
        for (int64_t l = 0; l < k; ++l) acc += (long double)a[l] * B[l * n + j];
        const long double d = (long double)C[i * n + j] - acc;
        diff_sq += d * d;
        ref_sq += acc * acc;
        if (acc != 0.0L) {
          const long double r = fabsl(d / acc);
          if (r > max_rel) max_rel = r;
        }
      }
    }
  }
  out[0] = (double)(ref_sq > 0 ? sqrtl(diff_sq / ref_sq) : sqrtl(diff_sq));
  out[1] = (double)max_rel;
}

// complex128 variant; A,B,C interleaved re/im, row-major
void oz_error_metrics_z(int64_t m, int64_t n, int64_t k, const double* A,
                        const double* B, const double* C, double* out) {
  long double diff_sq = 0.0L, ref_sq = 0.0L, max_rel = 0.0L;
#pragma omp parallel reduction(+ : diff_sq, ref_sq) reduction(max : max_rel)
  {
#pragma omp for schedule(static)
    for (int64_t i = 0; i < m; ++i) {
      for (int64_t j = 0; j < n; ++j) {
        long double ar = 0.0L, ai = 0.0L;
        const double* a = A + 2 * i * k;
        for (int64_t l = 0; l < k; ++l) {
          const long double xr = a[2 * l], xi = a[2 * l + 1];
          const long double yr = B[2 * (l * n + j)], yi = B[2 * (l * n + j) + 1];
          ar += xr * yr - xi * yi;
          ai += xr * yi + xi * yr;
        }
        const long double dr = (long double)C[2 * (i * n + j)] - ar;
        const long double di = (long double)C[2 * (i * n + j) + 1] - ai;
        const long double d2 = dr * dr + di * di;
        const long double r2 = ar * ar + ai * ai;
        diff_sq += d2;
        ref_sq += r2;
        if (r2 > 0) {
          const long double r = sqrtl(d2 / r2);
          if (r > max_rel) max_rel = r;
        }
      }
    }
  }
  out[0] = (double)(ref_sq > 0 ? sqrtl(diff_sq / ref_sq) : sqrtl(diff_sq));
  out[1] = (double)max_rel;
}

// Multi-C variants: evaluate MANY candidate C matrices against ONE
// long-double reference accumulation (the expensive part).  Used by the
// full CI matrix runner, where the same (A, B) pair is checked at nine
// split counts — 9x less oracle work than calling the single-C metric
// per mode.  Cs: nc pointers, each [m,n]; out: nc pairs (residual, max_rel).
void oz_error_metrics_d_multi(int64_t m, int64_t n, int64_t k, const double* A,
                              const double* B, const double* const* Cs,
                              int64_t nc, double* out) {
  const int64_t NC_MAX = 32;
  if (nc > NC_MAX) nc = NC_MAX;
  long double diff_sq[NC_MAX] = {0.0L}, max_rel[NC_MAX] = {0.0L};
  long double ref_sq = 0.0L;
  for (int64_t i = 0; i < m; ++i) {
    for (int64_t j = 0; j < n; ++j) {
      long double acc = 0.0L;
      const double* a = A + i * k;
      for (int64_t l = 0; l < k; ++l) acc += (long double)a[l] * B[l * n + j];
      ref_sq += acc * acc;
      for (int64_t c = 0; c < nc; ++c) {
        const long double d = (long double)Cs[c][i * n + j] - acc;
        diff_sq[c] += d * d;
        if (acc != 0.0L) {
          const long double r = fabsl(d / acc);
          if (r > max_rel[c]) max_rel[c] = r;
        }
      }
    }
  }
  for (int64_t c = 0; c < nc; ++c) {
    out[2 * c] =
        (double)(ref_sq > 0 ? sqrtl(diff_sq[c] / ref_sq) : sqrtl(diff_sq[c]));
    out[2 * c + 1] = (double)max_rel[c];
  }
}

void oz_error_metrics_z_multi(int64_t m, int64_t n, int64_t k, const double* A,
                              const double* B, const double* const* Cs,
                              int64_t nc, double* out) {
  const int64_t NC_MAX = 32;
  if (nc > NC_MAX) nc = NC_MAX;
  long double diff_sq[NC_MAX] = {0.0L}, max_rel[NC_MAX] = {0.0L};
  long double ref_sq = 0.0L;
  for (int64_t i = 0; i < m; ++i) {
    for (int64_t j = 0; j < n; ++j) {
      long double ar = 0.0L, ai = 0.0L;
      const double* a = A + 2 * i * k;
      for (int64_t l = 0; l < k; ++l) {
        const long double xr = a[2 * l], xi = a[2 * l + 1];
        const long double yr = B[2 * (l * n + j)], yi = B[2 * (l * n + j) + 1];
        ar += xr * yr - xi * yi;
        ai += xr * yi + xi * yr;
      }
      const long double r2 = ar * ar + ai * ai;
      ref_sq += r2;
      for (int64_t c = 0; c < nc; ++c) {
        const long double dr = (long double)Cs[c][2 * (i * n + j)] - ar;
        const long double di = (long double)Cs[c][2 * (i * n + j) + 1] - ai;
        const long double d2 = dr * dr + di * di;
        diff_sq[c] += d2;
        if (r2 > 0) {
          const long double r = sqrtl(d2 / r2);
          if (r > max_rel[c]) max_rel[c] = r;
        }
      }
    }
  }
  for (int64_t c = 0; c < nc; ++c) {
    out[2 * c] =
        (double)(ref_sq > 0 ? sqrtl(diff_sq[c] / ref_sq) : sqrtl(diff_sq[c]));
    out[2 * c + 1] = (double)max_rel[c];
  }
}

}  // extern "C"
