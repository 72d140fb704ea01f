// 4-step negacyclic NTT / iNTT for Hopper, called from JAX through the FFI.
//
// Same transform as the XLA leaf in ops/ntt.py (bit-identical: every value
// leaves a butterfly fully reduced to [0, q)). A limb of N = n1 * n2
// uint32 words is 256 KB at N = 2^16, more than one block's shared memory,
// so each transform runs as two column-tile passes:
//
//   forward  pass 1: [n1, n2] coeff tile -> size-n1 CT stages per column,
//                    mid twiddle (Montgomery form), transposed store
//                    into scratch [n2, n1]
//            pass 2: size-n2 CT stages per column of the scratch -> out
//   inverse  pass 1: [n2, n1] eval tile -> size-n2 GS stages per column,
//                    transposed store into scratch [n1, n2]
//            pass 2: inverse mid twiddle on load, size-n1 GS stages -> out
//
// One block holds an [N x TC] column tile (TC = 8 columns, rows padded by
// one word for the transposed store) plus the limb's flat Shoup stage
// tables. Stage twiddles use Shoup products (__umulhi); the
// per-element mid twiddle uses the Montgomery table so only one
// data-sized table is read.
//
// Tables (per limb m, flat stage layout: stage s, block b at 2^s + b):
//   q[M], qinv[M] (-q^{-1} mod 2^32), tw/tw_sh[M, N] Shoup pairs,
//   mid[M, n1, n2] Montgomery form.
// Data with more rows than M (leading batch dims, or rep stacked copies)
// uses table row (row % M).

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLogN = 10;  // N <= 1024: tile + tables fit in 227 KB
// Tile width TC = 8 columns: 32-byte row segments still fill whole memory
// sectors, and at set B a pass runs 1,600 blocks instead of 400 — the
// kernel is latency-bound, and measured 0.084 ms per 50-row transform
// against 0.105 ms at TC = 32 (one H100 at 400 W).
constexpr int kLogTileCols = 3;

__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w,
                                              uint32_t wsh, uint32_t q) {
  uint32_t r = a * w - __umulhi(a, wsh) * q;  // [0, 2q)
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t w_mont,
                                             uint32_t q, uint32_t qinv_neg) {
  uint64_t t = static_cast<uint64_t>(a) * w_mont;  // < q * 2^32
  uint32_t m = static_cast<uint32_t>(t) * qinv_neg;
  uint32_t r = static_cast<uint32_t>(
      (t + static_cast<uint64_t>(m) * q) >> 32);  // [0, 2q)
  return r >= q ? r - q : r;
}

// One pass: transform along the N rows of every column of an [N, C] tile.
// kForward: CT stages then optional post-multiply by mid; otherwise
// optional pre-multiply by mid then GS stages. transpose_out stores the
// [N, C] result as [C, N].
template <bool kForward>
__global__ void __launch_bounds__(kThreads)
col_pass(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
         const uint32_t* __restrict__ q_arr,
         const uint32_t* __restrict__ qinv_arr,
         const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tw_sh,
         const uint32_t* __restrict__ mid, int M, int log_n, int C,
         int log_tc, bool transpose_out) {
  extern __shared__ uint32_t smem[];
  const int N = 1 << log_n;
  const int tc = 1 << log_tc;
  const int ld = tc + 1;
  uint32_t* s = smem;            // [N][ld]
  uint32_t* s_tw = s + N * ld;   // [N]
  uint32_t* s_sh = s_tw + N;     // [N]
  const int row = blockIdx.y;    // data limb (batch * M + m)
  const int m = row % M;
  const int c0 = blockIdx.x * tc;
  const uint32_t q = q_arr[m];
  const uint32_t qinv = qinv_arr[m];
  const size_t base = static_cast<size_t>(row) * N * C;
  const size_t tbase = static_cast<size_t>(m) * N * C;
  const int n_elem = N << log_tc;
  const int tc_mask = tc - 1;

  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    s_tw[i] = tw[static_cast<size_t>(m) * N + i];
    s_sh[i] = tw_sh[static_cast<size_t>(m) * N + i];
  }
  for (int i = threadIdx.x; i < n_elem; i += blockDim.x) {
    const int r = i >> log_tc, c = i & tc_mask;
    const size_t g = static_cast<size_t>(r) * C + c0 + c;
    uint32_t v = in[base + g];
    if (!kForward && mid != nullptr) v = mont_mul(v, mid[tbase + g], q, qinv);
    s[r * ld + c] = v;
  }
  __syncthreads();

  const int n_bfly = (N / 2) << log_tc;
  if (kForward) {
    for (int st = 0; st < log_n; ++st) {
      const int log_h = log_n - st - 1;
      for (int i = threadIdx.x; i < n_bfly; i += blockDim.x) {
        const int p = i >> log_tc, c = i & tc_mask;
        const int blk = p >> log_h, h = p & ((1 << log_h) - 1);
        const int r0 = (blk << (log_h + 1)) + h, r1 = r0 + (1 << log_h);
        const int t = (1 << st) + blk;
        const uint32_t u = s[r0 * ld + c];
        const uint32_t v = shoup_mul(s[r1 * ld + c], s_tw[t], s_sh[t], q);
        const uint32_t a = u + v;
        const uint32_t d = u + q - v;
        s[r0 * ld + c] = a >= q ? a - q : a;
        s[r1 * ld + c] = d >= q ? d - q : d;
      }
      __syncthreads();
    }
    if (mid != nullptr) {
      for (int i = threadIdx.x; i < n_elem; i += blockDim.x) {
        const int r = i >> log_tc, c = i & tc_mask;
        const size_t g = static_cast<size_t>(r) * C + c0 + c;
        s[r * ld + c] = mont_mul(s[r * ld + c], mid[tbase + g], q, qinv);
      }
      __syncthreads();
    }
  } else {
    for (int st = log_n - 1; st >= 0; --st) {
      const int log_h = log_n - st - 1;
      for (int i = threadIdx.x; i < n_bfly; i += blockDim.x) {
        const int p = i >> log_tc, c = i & tc_mask;
        const int blk = p >> log_h, h = p & ((1 << log_h) - 1);
        const int r0 = (blk << (log_h + 1)) + h, r1 = r0 + (1 << log_h);
        const int t = (1 << st) + blk;
        const uint32_t u = s[r0 * ld + c];
        const uint32_t v = s[r1 * ld + c];
        const uint32_t a = u + v;
        uint32_t d = u + q - v;
        d = d >= q ? d - q : d;
        s[r0 * ld + c] = a >= q ? a - q : a;
        s[r1 * ld + c] = shoup_mul(d, s_tw[t], s_sh[t], q);
      }
      __syncthreads();
    }
  }

  if (transpose_out) {
    // out[row] viewed as [C, N]: consecutive threads walk r (coalesced).
    for (int i = threadIdx.x; i < n_elem; i += blockDim.x) {
      const int c = i >> log_n, r = i & (N - 1);
      out[base + static_cast<size_t>(c0 + c) * N + r] = s[r * ld + c];
    }
  } else {
    for (int i = threadIdx.x; i < n_elem; i += blockDim.x) {
      const int r = i >> log_tc, c = i & tc_mask;
      out[base + static_cast<size_t>(r) * C + c0 + c] = s[r * ld + c];
    }
  }
}

int ilog2(int64_t v) {
  int l = 0;
  while ((int64_t{1} << l) < v) ++l;
  return (int64_t{1} << l) == v ? l : -1;
}

template <bool kForward>
ffi::Error launch_pass(cudaStream_t stream, const uint32_t* in, uint32_t* out,
                       const uint32_t* q, const uint32_t* qinv,
                       const uint32_t* tw, const uint32_t* tw_sh,
                       const uint32_t* mid, int64_t rows, int64_t M,
                       int log_n, int64_t C, bool transpose_out) {
  const int log_c = ilog2(C);
  const int log_tc = log_c < kLogTileCols ? log_c : kLogTileCols;
  const int tc = 1 << log_tc;
  const size_t smem =
      (static_cast<size_t>(1 << log_n) * (tc + 1) + 2 * (1 << log_n)) *
      sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        col_pass<kForward>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess)
      return ffi::Error::Internal(cudaGetErrorString(e));
  }
  dim3 grid(static_cast<unsigned>(C / tc), static_cast<unsigned>(rows));
  col_pass<kForward><<<grid, kThreads, smem, stream>>>(
      in, out, q, qinv, tw, tw_sh, mid, static_cast<int>(M), log_n,
      static_cast<int>(C), log_tc, transpose_out);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(e));
  return ffi::Error::Success();
}

// Shared shape checks: x [..., a, b]; returns rows, M.
ffi::Error check_shapes(const ffi::AnyBuffer& x, const ffi::AnyBuffer& q,
                        int64_t* a, int64_t* b, int64_t* rows, int64_t* M) {
  auto dims = x.dimensions();
  if (dims.size() < 2) return ffi::Error::InvalidArgument("x rank < 2");
  *a = dims[dims.size() - 2];
  *b = dims[dims.size() - 1];
  if (ilog2(*a) < 0 || ilog2(*b) < 0 || ilog2(*a) > kMaxLogN ||
      ilog2(*b) > kMaxLogN)
    return ffi::Error::InvalidArgument("tile dims must be powers of two <= 1024");
  *M = static_cast<int64_t>(q.element_count());
  *rows = static_cast<int64_t>(x.element_count()) / (*a * *b);
  if (*M == 0 || *rows % *M != 0)
    return ffi::Error::InvalidArgument("data rows must be a multiple of table rows");
  return ffi::Error::Success();
}

const uint32_t* u32(const ffi::AnyBuffer& b) {
  return static_cast<const uint32_t*>(b.untyped_data());
}

ffi::Error NttFwdImpl(cudaStream_t stream, ffi::AnyBuffer x, ffi::AnyBuffer q,
                      ffi::AnyBuffer qinv, ffi::AnyBuffer tw1,
                      ffi::AnyBuffer tw1_sh, ffi::AnyBuffer mid,
                      ffi::AnyBuffer tw2, ffi::AnyBuffer tw2_sh,
                      ffi::Result<ffi::AnyBuffer> y,
                      ffi::Result<ffi::AnyBuffer> scratch) {
  int64_t n1, n2, rows, M;
  ffi::Error err = check_shapes(x, q, &n1, &n2, &rows, &M);
  if (err.failure()) return err;
  uint32_t* tmp = static_cast<uint32_t*>(scratch->untyped_data());
  uint32_t* out = static_cast<uint32_t*>(y->untyped_data());
  err = launch_pass<true>(stream, u32(x), tmp, u32(q), u32(qinv), u32(tw1),
                          u32(tw1_sh), u32(mid), rows, M, ilog2(n1), n2,
                          /*transpose_out=*/true);
  if (err.failure()) return err;
  return launch_pass<true>(stream, tmp, out, u32(q), u32(qinv), u32(tw2),
                           u32(tw2_sh), nullptr, rows, M, ilog2(n2), n1,
                           /*transpose_out=*/false);
}

ffi::Error NttInvImpl(cudaStream_t stream, ffi::AnyBuffer x, ffi::AnyBuffer q,
                      ffi::AnyBuffer qinv, ffi::AnyBuffer tw2,
                      ffi::AnyBuffer tw2_sh, ffi::AnyBuffer mid_inv,
                      ffi::AnyBuffer tw1, ffi::AnyBuffer tw1_sh,
                      ffi::Result<ffi::AnyBuffer> y,
                      ffi::Result<ffi::AnyBuffer> scratch) {
  int64_t n2, n1, rows, M;
  ffi::Error err = check_shapes(x, q, &n2, &n1, &rows, &M);
  if (err.failure()) return err;
  uint32_t* tmp = static_cast<uint32_t*>(scratch->untyped_data());
  uint32_t* out = static_cast<uint32_t*>(y->untyped_data());
  err = launch_pass<false>(stream, u32(x), tmp, u32(q), u32(qinv), u32(tw2),
                           u32(tw2_sh), nullptr, rows, M, ilog2(n2), n1,
                           /*transpose_out=*/true);
  if (err.failure()) return err;
  return launch_pass<false>(stream, tmp, out, u32(q), u32(qinv), u32(tw1),
                            u32(tw1_sh), u32(mid_inv), rows, M, ilog2(n1),
                            n2, /*transpose_out=*/false);
}

}  // namespace

#define NTT_BINDING                                  \
  ffi::Ffi::Bind()                                   \
      .Ctx<ffi::PlatformStream<cudaStream_t>>()      \
      .Arg<ffi::AnyBuffer>()                         \
      .Arg<ffi::AnyBuffer>()                         \
      .Arg<ffi::AnyBuffer>()                         \
      .Arg<ffi::AnyBuffer>()                         \
      .Arg<ffi::AnyBuffer>()                         \
      .Arg<ffi::AnyBuffer>()                         \
      .Arg<ffi::AnyBuffer>()                         \
      .Arg<ffi::AnyBuffer>()                         \
      .Ret<ffi::AnyBuffer>()                         \
      .Ret<ffi::AnyBuffer>()

XLA_FFI_DEFINE_HANDLER_SYMBOL(HomulatorNttFwd, NttFwdImpl, NTT_BINDING);
XLA_FFI_DEFINE_HANDLER_SYMBOL(HomulatorNttInv, NttInvImpl, NTT_BINDING);
