// Adaptive-band x-drop extension for NVIDIA Hopper, called from JAX
// through the XLA FFI (custom call target "bella_xdrop_extend").
//
// Computes exactly what the plain-JAX reference `extend_batch`
// (bella_tpu/align/xdrop.py) computes, pair by pair: the same
// antidiagonal recurrence over a band of W cells, the same band move
// (slide toward the target when the argmax lane is past W/2, ties to
// the first lane), the same x-drop / end-of-matrix termination and
// step cap, all in int32.
//
// Layout: one pair per warp (LOGAN's one-alignment-per-block design,
// scaled down to a warp). The band's W = 32*C cells live in registers,
// C contiguous cells per lane; a one-cell shift of the band is one
// __shfl_up/down_sync, the per-antidiagonal max/argmax a butterfly
// reduction. The sequence windows under the band (target chars T[i-1],
// query chars Q[j-1]) ride in registers as well and take one new char
// per step, prefetched at the top of the step. The whole extension runs
// in one launch with no host synchronisation.

#include <cstdint>
#include <string>
#include <type_traits>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int32_t kNinf = -(1 << 20);  // NINF of the reference
constexpr int32_t kPad = 127;          // PAD_CHAR of the reference
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ int64_t clampi(int64_t x, int64_t hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

template <int C>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
xdrop_extend_kernel(const int8_t* __restrict__ T,
                    const int32_t* __restrict__ t_len,
                    const int8_t* __restrict__ Q,
                    const int32_t* __restrict__ q_len, int64_t n, int64_t L,
                    int32_t xdrop, int32_t max_steps, int32_t match,
                    int32_t mismatch, int32_t gap, int32_t* __restrict__ score,
                    int32_t* __restrict__ t_end, int32_t* __restrict__ q_end) {
  constexpr int W = 32 * C;
  const int lane = threadIdx.x & 31;
  const int64_t pair =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= n) return;  // uniform across the warp

  const int8_t* t = T + pair * L;
  const int8_t* q = Q + pair * L;
  const int32_t tl = t_len[pair];
  const int32_t ql = q_len[pair];
  const int p0 = lane * C;  // band position of this lane's first cell

  // antidiagonals d-2 (a1) and d-1 (a2); windows tw[p] = T[lo+p-1],
  // qw[p] = Q[d-lo-p-1] for the antidiagonal d about to be computed
  int32_t a1[C], a2[C], tw[C], qw[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int p = p0 + c;
    a1[c] = p == 0 ? 0 : kNinf;
    a2[c] = p == 0   ? (ql >= 1 ? gap : kNinf)
            : p == 1 ? (tl >= 1 ? gap : kNinf)
                     : kNinf;
    tw[c] = p >= 1 ? t[clampi(p - 1, L - 1)] : kPad;
    qw[c] = p <= 1 ? q[clampi(1 - p, L - 1)] : kPad;
  }

  int32_t lo = 0, dlt1 = 0, dlt2 = 0, d = 2;
  int32_t best = 0, best_t = 0, best_q = 0;
  bool alive = (tl + ql) > 0;

  for (int32_t step = 0; alive && step < max_steps; ++step) {
    // the one char each window may take this step, fetched early
    const int32_t t_new = lane == 31 ? t[clampi(int64_t(lo) + W - 1, L - 1)] : 0;
    const int32_t q_new = lane == 0 ? q[clampi(int64_t(d) - lo, L - 1)] : 0;

    int32_t a1_prev = __shfl_up_sync(kFull, a1[C - 1], 1);
    int32_t a1_next = __shfl_down_sync(kFull, a1[0], 1);
    int32_t a2_prev = __shfl_up_sync(kFull, a2[C - 1], 1);
    int32_t a2_next = __shfl_down_sync(kFull, a2[0], 1);
    if (lane == 0) a1_prev = a2_prev = kNinf;
    if (lane == 31) a1_next = a2_next = kNinf;

    const int sd = dlt2 + dlt1 - 1;  // diagonal predecessor offset
    int32_t a3[C];
    int32_t cur = kNinf - 1;
    int arg = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int32_t am1 = c == 0 ? a1_prev : a1[c - 1];
      const int32_t ap1 = c == C - 1 ? a1_next : a1[c + 1];
      const int32_t diag = sd < 0 ? am1 : (sd == 0 ? a1[c] : ap1);
      const int32_t bm1 = c == 0 ? a2_prev : a2[c - 1];
      const int32_t bp1 = c == C - 1 ? a2_next : a2[c + 1];
      const int32_t gq = dlt2 == 1 ? a2[c] : bm1;  // consumes target
      const int32_t gt = dlt2 == 1 ? bp1 : a2[c];  // consumes query
      const int32_t sub = tw[c] == qw[c] ? match : mismatch;
      int32_t v = max(diag + sub, max(gq, gt) + gap);
      const int32_t i = lo + p0 + c;
      const int32_t j = d - i;
      const bool valid = i >= 0 && i <= tl && j >= 0 && j <= ql;
      v = valid ? v : kNinf;
      v = max(v, kNinf);
      a3[c] = v;
      if (v > cur) {  // first maximum within the lane
        cur = v;
        arg = p0 + c;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {  // ties go to the first lane
      const int32_t ov = __shfl_xor_sync(kFull, cur, off);
      const int oa = __shfl_xor_sync(kFull, arg, off);
      if (ov > cur || (ov == cur && oa < arg)) {
        cur = ov;
        arg = oa;
      }
    }

    if (cur > best) {
      best = cur;
      best_t = lo + arg;
      best_q = d - (lo + arg);
    }
    alive = cur >= best - xdrop && d < tl + ql;
    if (!alive) break;

    const bool move = arg > W / 2;
    if (move) {  // band slides down the target: T window shifts left
      const int32_t nxt = __shfl_down_sync(kFull, tw[0], 1);
#pragma unroll
      for (int c = 0; c < C - 1; ++c) tw[c] = tw[c + 1];
      tw[C - 1] = lane == 31 ? t_new : nxt;
    } else {  // Q window shifts right
      const int32_t prv = __shfl_up_sync(kFull, qw[C - 1], 1);
#pragma unroll
      for (int c = C - 1; c > 0; --c) qw[c] = qw[c - 1];
      qw[0] = lane == 0 ? q_new : prv;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      a1[c] = a2[c];
      a2[c] = a3[c];
    }
    dlt1 = dlt2;
    dlt2 = move ? 1 : 0;
    lo += dlt2;
    ++d;
  }

  if (lane == 0) {
    score[pair] = best;
    t_end[pair] = best_t;
    q_end[pair] = best_q;
  }
}

template <int C>
void launch(cudaStream_t stream, const int8_t* T, const int32_t* tl,
            const int8_t* Q, const int32_t* ql, int64_t n, int64_t L,
            int32_t xdrop, int32_t max_steps, int32_t match, int32_t mismatch,
            int32_t gap, int32_t* score, int32_t* t_end, int32_t* q_end) {
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  xdrop_extend_kernel<C><<<static_cast<unsigned>(blocks),
                           32 * kWarpsPerBlock, 0, stream>>>(
      T, tl, Q, ql, n, L, xdrop, max_steps, match, mismatch, gap, score,
      t_end, q_end);
}

ffi::Error XdropExtendImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> T,
                           ffi::Buffer<ffi::S32> t_len, ffi::Buffer<ffi::S8> Q,
                           ffi::Buffer<ffi::S32> q_len, int32_t band,
                           int32_t xdrop, int32_t max_steps, int32_t match,
                           int32_t mismatch, int32_t gap,
                           ffi::ResultBuffer<ffi::S32> score,
                           ffi::ResultBuffer<ffi::S32> t_end,
                           ffi::ResultBuffer<ffi::S32> q_end) {
  const auto dims = T.dimensions();
  if (dims.size() != 2 || Q.dimensions().size() != 2) {
    return ffi::Error::InvalidArgument("T and Q must be (n, L)");
  }
  const int64_t n = dims[0];
  const int64_t L = dims[1];
  if (Q.dimensions()[0] != n || Q.dimensions()[1] != L ||
      static_cast<int64_t>(t_len.element_count()) != n ||
      static_cast<int64_t>(q_len.element_count()) != n) {
    return ffi::Error::InvalidArgument("T, Q, t_len, q_len shapes disagree");
  }
  if (n == 0) return ffi::Error::Success();
  if (L < 1) return ffi::Error::InvalidArgument("sequence width must be >= 1");
  auto go = [&](auto c) {
    launch<decltype(c)::value>(
        stream, T.typed_data(), t_len.typed_data(), Q.typed_data(),
        q_len.typed_data(), n, L, xdrop, max_steps, match, mismatch, gap,
        score->typed_data(), t_end->typed_data(), q_end->typed_data());
  };
  switch (band) {
    case 32: go(std::integral_constant<int, 1>()); break;
    case 64: go(std::integral_constant<int, 2>()); break;
    case 128: go(std::integral_constant<int, 4>()); break;
    case 256: go(std::integral_constant<int, 8>()); break;
    default:
      return ffi::Error::InvalidArgument(
          "band must be 32, 64, 128 or 256, got " + std::to_string(band));
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("xdrop kernel launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(BellaXdropExtend, XdropExtendImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()   // T
                                  .Arg<ffi::Buffer<ffi::S32>>()  // t_len
                                  .Arg<ffi::Buffer<ffi::S8>>()   // Q
                                  .Arg<ffi::Buffer<ffi::S32>>()  // q_len
                                  .Attr<int32_t>("band")
                                  .Attr<int32_t>("xdrop")
                                  .Attr<int32_t>("max_steps")
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("gap")
                                  .Ret<ffi::Buffer<ffi::S32>>()   // score
                                  .Ret<ffi::Buffer<ffi::S32>>()   // t_end
                                  .Ret<ffi::Buffer<ffi::S32>>());  // q_end
