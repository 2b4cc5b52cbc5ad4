// Long-double host oracle: error metrics of a computed GEMM.
//
// The metric functions of ozimmu_tpu/native/oracle.cpp, unchanged: recompute
// the GEMM at higher precision (80-bit x87 long double accumulation) and
// report relative_residual = ||C - C_ref||_F / ||C_ref||_F and the
// elementwise max relative error, streamed, so no C_ref buffer is ever
// materialized (the reference's `mateval` use, test/main_test.cu:101-117).
// The single-C functions run their rows in parallel (OpenMP); the multi-C
// functions score many candidate C matrices against one accumulation, their
// dot products on as many threads as the caller asks for and their sums in
// one fixed order, so their results do not depend on the thread count.
//
// Exposed with a plain C ABI for ctypes; built and bound by oracle.py.

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

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
// per mode.  Bt is B transposed ([n,k] row-major), so each dot product
// reads both operands contiguously; Cs: nc pointers, each [m,n]; out: nc
// pairs (residual, max_rel).
//
// The dot products of a slab of rows run on `threads` OpenMP threads into
// a buffer; the sums over the slab are then taken one element at a time in
// row order.  Each element's accumulation runs over l in order and the
// sums in (i, j) order, as in the one-thread loop of
// ozimmu_tpu/native/oracle.cpp, so the results equal it bit for bit
// whatever the thread count.  The real variant also stores the
// accumulation rounded to f64 into ref64 [m,n] unless it is null (the
// product of ozimmu_tpu/native/oracle.cpp's oz_ref_gemm_d, from the same
// pass).
static const int64_t NC_MAX = 32;
static const int64_t SLAB_ROWS = 64;

void oz_error_metrics_d_multi(int64_t m, int64_t n, int64_t k, const double* A,
                              const double* Bt, const double* const* Cs,
                              int64_t nc, double* out, int64_t threads,
                              double* ref64) {
  if (nc > NC_MAX) nc = NC_MAX;
  long double diff_sq[NC_MAX] = {0.0L}, max_rel[NC_MAX] = {0.0L};
  long double ref_sq = 0.0L;
  std::vector<long double> slab((size_t)(SLAB_ROWS * n));
  for (int64_t i0 = 0; i0 < m; i0 += SLAB_ROWS) {
    const int64_t rows = std::min(SLAB_ROWS, m - i0);
#pragma omp parallel for schedule(static) num_threads(threads)
    for (int64_t r = 0; r < rows; ++r) {
      const double* a = A + (i0 + r) * k;
      for (int64_t j = 0; j < n; ++j) {
        const double* b = Bt + j * k;
        long double acc = 0.0L;
        for (int64_t l = 0; l < k; ++l) acc += (long double)a[l] * b[l];
        slab[r * n + j] = acc;
      }
    }
    for (int64_t r = 0; r < rows; ++r) {
      const int64_t i = i0 + r;
      for (int64_t j = 0; j < n; ++j) {
        const long double acc = slab[r * n + j];
        if (ref64) ref64[i * n + j] = (double)acc;
        ref_sq += acc * acc;
        for (int64_t c = 0; c < nc; ++c) {
          const long double d = (long double)Cs[c][i * n + j] - acc;
          diff_sq[c] += d * d;
          if (acc != 0.0L) {
            const long double rel = fabsl(d / acc);
            if (rel > max_rel[c]) max_rel[c] = rel;
          }
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
                              const double* Bt, const double* const* Cs,
                              int64_t nc, double* out, int64_t threads) {
  if (nc > NC_MAX) nc = NC_MAX;
  long double diff_sq[NC_MAX] = {0.0L}, max_rel[NC_MAX] = {0.0L};
  long double ref_sq = 0.0L;
  std::vector<long double> slab((size_t)(2 * SLAB_ROWS * n));
  for (int64_t i0 = 0; i0 < m; i0 += SLAB_ROWS) {
    const int64_t rows = std::min(SLAB_ROWS, m - i0);
#pragma omp parallel for schedule(static) num_threads(threads)
    for (int64_t r = 0; r < rows; ++r) {
      const double* a = A + 2 * (i0 + r) * k;
      for (int64_t j = 0; j < n; ++j) {
        const double* b = Bt + 2 * j * k;
        long double ar = 0.0L, ai = 0.0L;
        for (int64_t l = 0; l < k; ++l) {
          const long double xr = a[2 * l], xi = a[2 * l + 1];
          const long double yr = b[2 * l], yi = b[2 * l + 1];
          ar += xr * yr - xi * yi;
          ai += xr * yi + xi * yr;
        }
        slab[2 * (r * n + j)] = ar;
        slab[2 * (r * n + j) + 1] = ai;
      }
    }
    for (int64_t r = 0; r < rows; ++r) {
      const int64_t i = i0 + r;
      for (int64_t j = 0; j < n; ++j) {
        const long double ar = slab[2 * (r * n + j)], ai = slab[2 * (r * n + j) + 1];
        const long double r2 = ar * ar + ai * ai;
        ref_sq += r2;
        for (int64_t c = 0; c < nc; ++c) {
          const long double dr = (long double)Cs[c][2 * (i * n + j)] - ar;
          const long double di = (long double)Cs[c][2 * (i * n + j) + 1] - ai;
          const long double d2 = dr * dr + di * di;
          diff_sq[c] += d2;
          if (r2 > 0) {
            const long double rel = sqrtl(d2 / r2);
            if (rel > max_rel[c]) max_rel[c] = rel;
          }
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
