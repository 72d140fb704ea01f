// Native host-side CKKS core: exact RNS polynomial kernels in C++.
//
// Role in the framework: the reference implements its entire runtime in
// C++17 (SURVEY.md §2 — Homulator is a pure-C++ machine). Our device compute
// path is JAX (plus one CUDA kernel); this library is the native half of the *host*
// runtime: exact integer kernels used for key generation, encode/encrypt,
// and as a fast oracle for large-N tests (the numpy reference engine stays
// the canonical spec; this is bit-identical to it and ~an order of
// magnitude faster).
//
// Same algorithm and table layout as refimpl.py / ops/ntt.py: 4-step
// negacyclic NTT, CT stages with psi_br-layout tables (stage s reads
// rows [2^s, 2^(s+1))), mid twiddle with the folded cyclic->negacyclic
// pre-twist, transpose, stage-2. All arithmetic is uint64 with q < 2^30
// (products fit in 64 bits, matching numtheory.py's design point).
//
// Build: make -C native  -> libckks_core.so (loaded via ctypes).

#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

using u64 = std::uint64_t;

namespace {

inline u64 addmod(u64 a, u64 b, u64 q) {
  u64 s = a + b;
  return s >= q ? s - q : s;
}
inline u64 submod(u64 a, u64 b, u64 q) { return a >= b ? a - b : a + q - b; }
inline u64 mulmod(u64 a, u64 b, u64 q) { return (a * b) % q; }  // q < 2^30

// CT DIT butterflies along the leading axis of a [n, m] tile (in place).
// tw_flat: psi_br layout, stage s uses entries [2^s, 2^(s+1)).
void ct_stages(u64* a, int n, int m, const u64* tw_flat, u64 q) {
  for (int B = 1, half = n >> 1; half >= 1; B <<= 1, half >>= 1) {
    // B blocks of 2*half rows each.
    for (int b = 0; b < B; ++b) {
      const u64 w = tw_flat[B + b];
      u64* top = a + (std::size_t)(2 * b * half) * m;
      u64* bot = top + (std::size_t)half * m;
      for (int r = 0; r < half; ++r) {
        u64* urow = top + (std::size_t)r * m;
        u64* vrow = bot + (std::size_t)r * m;
        for (int c = 0; c < m; ++c) {
          const u64 u = urow[c];
          const u64 v = mulmod(vrow[c], w, q);
          urow[c] = addmod(u, v, q);
          vrow[c] = submod(u, v, q);
        }
      }
    }
  }
}

// GS inverse butterflies (no 1/n factor; folded into tw_mid_inv).
void gs_stages(u64* a, int n, int m, const u64* tw_flat, u64 q) {
  for (int B = n >> 1, half = 1; B >= 1; B >>= 1, half <<= 1) {
    for (int b = 0; b < B; ++b) {
      const u64 w = tw_flat[B + b];
      u64* top = a + (std::size_t)(2 * b * half) * m;
      u64* bot = top + (std::size_t)half * m;
      for (int r = 0; r < half; ++r) {
        u64* urow = top + (std::size_t)r * m;
        u64* vrow = bot + (std::size_t)r * m;
        for (int c = 0; c < m; ++c) {
          const u64 u = urow[c];
          const u64 v = vrow[c];
          urow[c] = addmod(u, v, q);
          vrow[c] = mulmod(submod(u, v, q), w, q);
        }
      }
    }
  }
}

void transpose(const u64* src, u64* dst, int rows, int cols) {
  for (int r = 0; r < rows; ++r)
    for (int c = 0; c < cols; ++c) dst[(std::size_t)c * rows + r] = src[(std::size_t)r * cols + c];
}

}  // namespace

extern "C" {

// Forward 4-step negacyclic NTT of M limbs in place.
// x: [M, n1*n2]; per-limb tables row-aligned with x:
//   qs[M], psi1_flat[M, n1], tw_mid[M, n1*n2], psi2_flat[M, n2].
void ckks_ntt_fwd(u64* x, int M, int n1, int n2, const u64* qs,
                  const u64* psi1_flat, const u64* tw_mid,
                  const u64* psi2_flat) {
  const std::size_t N = (std::size_t)n1 * n2;
#pragma omp parallel
  {
    std::vector<u64> tmp(N);
#pragma omp for
    for (int t = 0; t < M; ++t) {
      const u64 q = qs[t];
      u64* a = x + (std::size_t)t * N;
      ct_stages(a, n1, n2, psi1_flat + (std::size_t)t * n1, q);
      const u64* mid = tw_mid + (std::size_t)t * N;
      for (std::size_t i = 0; i < N; ++i) a[i] = mulmod(a[i], mid[i], q);
      transpose(a, tmp.data(), n1, n2);
      std::memcpy(a, tmp.data(), N * sizeof(u64));
      ct_stages(a, n2, n1, psi2_flat + (std::size_t)t * n2, q);
    }
  }
}

// Inverse: x arrives in the forward output layout ([n2, n1] tiles).
void ckks_ntt_inv(u64* x, int M, int n1, int n2, const u64* qs,
                  const u64* ipsi1_flat, const u64* tw_mid_inv,
                  const u64* ipsi2_flat) {
  const std::size_t N = (std::size_t)n1 * n2;
#pragma omp parallel
  {
    std::vector<u64> tmp(N);
#pragma omp for
    for (int t = 0; t < M; ++t) {
      const u64 q = qs[t];
      u64* a = x + (std::size_t)t * N;
      gs_stages(a, n2, n1, ipsi2_flat + (std::size_t)t * n2, q);
      transpose(a, tmp.data(), n2, n1);
      std::memcpy(a, tmp.data(), N * sizeof(u64));
      const u64* mid = tw_mid_inv + (std::size_t)t * N;
      for (std::size_t i = 0; i < N; ++i) a[i] = mulmod(a[i], mid[i], q);
      gs_stages(a, n1, n2, ipsi1_flat + (std::size_t)t * n1, q);
    }
  }
}

// Elementwise ops over [M, N] limb arrays (per-limb modulus).
void ckks_ewe_mul(const u64* a, const u64* b, u64* out, int M, long long N,
                  const u64* qs) {
#pragma omp parallel for
  for (int t = 0; t < M; ++t) {
    const u64 q = qs[t];
    const std::size_t off = (std::size_t)t * N;
    for (long long i = 0; i < N; ++i) out[off + i] = mulmod(a[off + i], b[off + i], q);
  }
}

void ckks_ewe_add(const u64* a, const u64* b, u64* out, int M, long long N,
                  const u64* qs) {
#pragma omp parallel for
  for (int t = 0; t < M; ++t) {
    const u64 q = qs[t];
    const std::size_t off = (std::size_t)t * N;
    for (long long i = 0; i < N; ++i) out[off + i] = addmod(a[off + i], b[off + i], q);
  }
}

void ckks_ewe_sub(const u64* a, const u64* b, u64* out, int M, long long N,
                  const u64* qs) {
#pragma omp parallel for
  for (int t = 0; t < M; ++t) {
    const u64 q = qs[t];
    const std::size_t off = (std::size_t)t * N;
    for (long long i = 0; i < N; ++i) out[off + i] = submod(a[off + i], b[off + i], q);
  }
}

// Base-conversion step 2: out[j, :] = sum_i xhat[i, :] * mat[j, i] mod pj.
// xhat: [nd, N]; mat: [Mout, nd]; out: [Mout, N]; out_qs: [Mout].
void ckks_bconv(const u64* xhat, const u64* mat, u64* out, int nd, int Mout,
                long long N, const u64* out_qs) {
#pragma omp parallel for
  for (int j = 0; j < Mout; ++j) {
    const u64 q = out_qs[j];
    u64* orow = out + (std::size_t)j * N;
    std::memset(orow, 0, (std::size_t)N * sizeof(u64));
    for (int i = 0; i < nd; ++i) {
      const u64 w = mat[(std::size_t)j * nd + i] % q;
      const u64* xrow = xhat + (std::size_t)i * N;
      for (long long c = 0; c < N; ++c)
        orow[c] = addmod(orow[c], mulmod(xrow[c], w, q), q);
    }
  }
}

int ckks_core_version() { return 1; }

}  // extern "C"
