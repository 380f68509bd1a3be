// One-launch anti-diagonal wavefront fill of the banded 4D bi-alignment DP
// for NVIDIA Hopper (sm_90a), called from JAX through the XLA FFI.
//
// One thread block per pair; a loop over the anti-diagonals d = i + j runs
// inside the block, with one block-wide barrier between diagonals.  A thread
// owns one cell (i, sk, sl) of the diagonal and all Q states of it; the W*W
// cells of one lattice row sit in consecutive lanes of one warp, so the
// within-diagonal (str-only) cases read their predecessors from other lanes
// with warp shuffles.  Cross-diagonal predecessors are read from the two
// previous diagonal slabs in global memory (L1/L2 resident).  Rows outside
// the live window [max(0, d - m), min(n, d)] are never computed.
//
// The recurrence is the XLA scan's (bialign_tpu/ops/xla_dp.py) cell for
// cell, including its sentinel handling, so the emitted band is bit-exact
// with it on every cell of the genuine (i, j) window.  The case structure
// (columns, source states, mu multiplicities, guard kinds) comes from the
// generated header cases_gen.h, written from bialign_tpu/ops/cases.py at
// build time; the parameter-bound case constants arrive per call as an FFI
// attribute.
//
// Output layouts: band mode writes ys[B, D, Q, P, W, W] (the XLA band
// layout read by ops/band.py and ops/device_traceback.py); score mode keeps
// a ring of three slabs [B, 3, Q, P, W, W] instead.  Rows outside the live
// window of a diagonal are left unwritten.

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"
#include "cases_gen.h"

namespace ffi = xla::ffi;

namespace {

constexpr int32_t kNegInf = -(1 << 30);
constexpr int32_t kInvalid = -(1 << 30) - (1 << 29);
// threads per block: the cheaper-register configurations take twice as
// many warps to hide the latency of their predecessor loads
template <int S, bool AFFINE>
constexpr int threads_for() {
  return AFFINE && S > 0 ? 512 : 1024;
}
constexpr unsigned kFull = 0xffffffffu;

struct CaseConsts {
  int32_t v[AFF_NQ * AFF_NC];
};

template <bool AFFINE>
__device__ __forceinline__ int case_meta(int idx) {
  return AFFINE ? aff_meta(idx) : na_meta(idx);
}

template <int S, bool AFFINE>
__global__ void __launch_bounds__(threads_for<S, AFFINE>())
wavefront_kernel(const int32_t* __restrict__ mu1,
                 const int32_t* __restrict__ mu2,
                 const int32_t* __restrict__ ns,
                 const int32_t* __restrict__ ms,
                 const CaseConsts cst, int P, int Mp, int D, int band,
                 int32_t* __restrict__ slabs, int32_t* __restrict__ scores) {
  constexpr int W = 2 * S + 1;
  constexpr int W2 = W * W;
  constexpr int Q = AFFINE ? AFF_NQ : 1;
  constexpr int NC = AFFINE ? AFF_NC : NA_NC;
  constexpr int RPW = 32 / W2;  // lattice rows per warp

  const int b = blockIdx.x;
  const int n = ns[b];
  const int m = ms[b];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int seg = lane / W2;
  const int pos = lane - seg * W2;
  const int sk = pos / W;
  const int sl = pos - sk * W;

  const int64_t row_sz = W2;
  const int64_t state_sz = (int64_t)P * W2;
  const int64_t slab_sz = (int64_t)Q * state_sz;
  const int32_t* mu1b = mu1 + (int64_t)b * P * Mp;
  const int32_t* mu2b = mu2 + (int64_t)b * P * Mp;
  int32_t* base = slabs + (int64_t)b * (band ? D : 3) * slab_sz;
  auto slab = [&](int d) -> int32_t* {
    return base + (int64_t)(band ? d : d % 3) * slab_sz;
  };

  for (int d = 0; d <= n + m; ++d) {
    const int ilo = d - m > 0 ? d - m : 0;
    const int ihi = d < n ? d : n;
    int32_t* cur = slab(d);
    // predecessor slabs; only dereferenced under guards that imply d >= 1/2
    const int32_t* prv[3] = {cur, slab(d >= 1 ? d - 1 : 0),
                             slab(d >= 2 ? d - 2 : 0)};

    for (int i0 = ilo + warp * RPW; i0 <= ihi; i0 += nwarps * RPW) {
      const int i = i0 + seg;
      const bool act = seg < RPW && i <= ihi;
      const int j = d - i;
      const int k = i + sk - S;
      const int l = j + sl - S;
      const int32_t mu1v = act ? mu1b[(int64_t)i * Mp + j] : 0;
      const bool kl_in = act && k >= 0 && k <= n && l >= 0 && l <= m;
      const int32_t mu2v = kl_in ? mu2b[(int64_t)k * Mp + l] : 0;

      int32_t best[Q];
      int32_t val[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        int32_t bq = kInvalid;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int meta = case_meta<AFFINE>(q * NC + c);
          const int x0 = meta & 1, x1 = (meta >> 1) & 1;
          const int x2 = (meta >> 2) & 1, x3 = (meta >> 3) & 1;
          if (x0 + x1 == 0) continue;  // within-diagonal: swept below
          const int src = (meta >> 4) & 15;
          const int m1c = (meta >> 8) & 1, m2c = (meta >> 9) & 1;
          const int klchk = (meta >> 10) & 1;
          const int psk = sk - x2 + x0;
          const int psl = sl - x3 + x1;
          bool g = act && i >= x0 && j >= x1 && psk >= 0 && psk < W &&
                   psl >= 0 && psl < W;
          if (klchk) g = g && k >= x2 && l >= x3;
          if (g) {
            const int32_t pv =
                prv[x0 + x1][src * state_sz + (int64_t)(i - x0) * row_sz +
                             psk * W + psl];
            const int32_t v = pv + cst.v[q * NC + c] + m1c * mu1v + m2c * mu2v;
            bq = v > bq ? v : bq;
          }
        }
        best[q] = bq;
        val[q] = bq == kInvalid ? kNegInf : bq;
      }

      // origin initialisation (diagonal 0, i = 0, centre shift cell)
      const bool protect = d == 0 && i == 0 && sk == S && sl == S;
      if (protect) {
#pragma unroll
        for (int q = 0; q < Q; ++q)
          val[q] = (!AFFINE || q == AFF_BOTH_MATCH) ? 0 : kNegInf;
      }

      // within-diagonal cases: a sweep over shift levels t = sk + sl; a
      // case's predecessor sits at a strictly lower level of the same row
#pragma unroll
      for (int t = 1; t <= 4 * S; ++t) {
        const bool commit = act && sk + sl == t && !protect;
        int32_t nb[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          int32_t bq = best[q];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const int meta = case_meta<AFFINE>(q * NC + c);
            const int x0 = meta & 1, x1 = (meta >> 1) & 1;
            const int x2 = (meta >> 2) & 1, x3 = (meta >> 3) & 1;
            if (x0 + x1 != 0) continue;
            const int src = (meta >> 4) & 15;
            const int m2c = (meta >> 9) & 1;
            const int32_t pv = __shfl_up_sync(kFull, val[src], x2 * W + x3);
            const bool g = k >= x2 && l >= x3 && sk >= x2 && sl >= x3;
            const int32_t v = pv + cst.v[q * NC + c] + m2c * mu2v;
            if (g) bq = v > bq ? v : bq;
          }
          nb[q] = bq;
        }
        if (commit) {
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            best[q] = nb[q];
            val[q] = nb[q] == kInvalid ? kNegInf : nb[q];
          }
        }
      }

      if (act) {
#pragma unroll
        for (int q = 0; q < Q; ++q)
          cur[q * state_sz + (int64_t)i * row_sz + pos] = val[q];
      }
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    const int32_t* fin = slab(n + m);
    int32_t s = fin[(int64_t)n * row_sz + S * W + S];
    for (int q = 1; q < Q; ++q) {
      const int32_t v = fin[q * state_sz + (int64_t)n * row_sz + S * W + S];
      s = v > s ? v : s;
    }
    scores[b] = s;
  }
}

template <int S, bool AFFINE>
cudaError_t launch(cudaStream_t stream, int B, const int32_t* mu1,
                   const int32_t* mu2, const int32_t* ns, const int32_t* ms,
                   const CaseConsts& cst, int P, int Mp, int D, int band,
                   int32_t* slabs, int32_t* scores) {
  constexpr int W2 = (2 * S + 1) * (2 * S + 1);
  constexpr int RPW = 32 / W2;
  int warps = (P + RPW - 1) / RPW;
  int threads = 32 * warps;
  if (threads > threads_for<S, AFFINE>()) threads = threads_for<S, AFFINE>();
  wavefront_kernel<S, AFFINE><<<B, threads, 0, stream>>>(
      mu1, mu2, ns, ms, cst, P, Mp, D, band, slabs, scores);
  return cudaGetLastError();
}

ffi::Error WavefrontImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> mu1,
                         ffi::Buffer<ffi::S32> mu2, ffi::Buffer<ffi::S32> ns,
                         ffi::Buffer<ffi::S32> ms,
                         ffi::ResultBuffer<ffi::S32> scores,
                         ffi::ResultBuffer<ffi::S32> slabs, int32_t max_shift,
                         int32_t affine, int32_t band,
                         ffi::Span<const int32_t> cst) {
  auto dims = mu1.dimensions();
  if (dims.size() != 3) {
    return ffi::Error::InvalidArgument("mu1 must be [B, P, Mp]");
  }
  const int B = static_cast<int>(dims[0]);
  const int P = static_cast<int>(dims[1]);
  const int Mp = static_cast<int>(dims[2]);
  const int D = P + Mp - 1;
  const size_t nc = affine ? AFF_NQ * AFF_NC : NA_NC;
  if (cst.size() != nc) {
    return ffi::Error::InvalidArgument("case constant table has wrong size");
  }
  CaseConsts cc{};
  for (size_t c = 0; c < nc; ++c) cc.v[c] = cst[c];
  if (B == 0) return ffi::Error::Success();

  const int32_t* a = mu1.typed_data();
  const int32_t* b = mu2.typed_data();
  const int32_t* pn = ns.typed_data();
  const int32_t* pm = ms.typed_data();
  int32_t* sl = slabs->typed_data();
  int32_t* sc = scores->typed_data();
  cudaError_t err;
#define BIALIGN_LAUNCH(S_, A_) \
  launch<S_, A_>(stream, B, a, b, pn, pm, cc, P, Mp, D, band, sl, sc)
  if (affine) {
    switch (max_shift) {
      case 0: err = BIALIGN_LAUNCH(0, true); break;
      case 1: err = BIALIGN_LAUNCH(1, true); break;
      case 2: err = BIALIGN_LAUNCH(2, true); break;
      default: return ffi::Error::InvalidArgument("max_shift must be 0..2");
    }
  } else {
    switch (max_shift) {
      case 0: err = BIALIGN_LAUNCH(0, false); break;
      case 1: err = BIALIGN_LAUNCH(1, false); break;
      case 2: err = BIALIGN_LAUNCH(2, false); break;
      default: return ffi::Error::InvalidArgument("max_shift must be 0..2");
    }
  }
#undef BIALIGN_LAUNCH
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("wavefront launch failed: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(BialignWavefront, WavefrontImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("max_shift")
                                  .Attr<int32_t>("affine")
                                  .Attr<int32_t>("band")
                                  .Attr<ffi::Span<const int32_t>>("cst"));
