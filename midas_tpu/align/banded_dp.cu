// Banded affine-gap DP for NVIDIA Hopper (sm_90a), called from JAX
// through the XLA FFI (align/banded_cuda.py).
//
// Same recurrences, float arithmetic, statistics and tie-breaks as the
// jnp reference, align/banded.py:banded_align (diagonal > deletion >
// insertion; earliest row, then smallest band offset), so outputs are
// bit-equal to it. Build with --fmad=false: the reference rounds every
// multiply and add on its own.
//
// Layout: one (read, candidate) pair per D-lane segment of a warp, band
// offset d on the lane. The DP state of a pair (H, I, the fresh-start
// flag and 6 statistics planes each, or 1 in score-only mode) lives in
// registers for the whole row loop; band shifts are __shfl_up/down
// within the segment and the deletion prefix max is a log2(D)-step
// Kogge-Stone over shuffles. Device memory is touched only to stage a
// block's queries, windows and quality penalties into shared memory and
// to write one result column per pair. The row loop stops at the pair's
// own read length.
//
// The best cell is tracked per lane (its first row reaching the lane's
// maximum) and reduced across the segment once after the loop: largest
// score, then earliest row, then smallest offset, which is the same
// cell as the reference's row-by-row first-occurrence tracking.

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr float kNeg = -1e9f;
constexpr int kBlock = 256;

struct Scoring {
  float ma, mi, go, ge, npen;
};

template <int D>
__device__ __forceinline__ unsigned segment_mask() {
  if (D == 32) return 0xffffffffu;
  const unsigned lane = threadIdx.x & 31u;
  return ((1u << D) - 1u) << (lane & ~unsigned(D - 1));
}

// out[d] = x[d + s]; `fill` past the band's end
template <int D, typename T>
__device__ __forceinline__ T from_above(unsigned m, T x, int s, int d,
                                        T fill) {
  const T y = __shfl_down_sync(m, x, s, D);
  return d + s < D ? y : fill;
}

// out[d] = x[d - s]; `fill` before the band's start
template <int D, typename T>
__device__ __forceinline__ T from_below(unsigned m, T x, int s, int d,
                                        T fill) {
  const T y = __shfl_up_sync(m, x, s, D);
  return d >= s ? y : fill;
}

// NS = 6 statistics planes (matches, mismatches, gap_cols, gap_opens,
// qstart row, window-start column) or 1 (window-start column only).
template <int D, bool LOCAL, int NS, bool QPEN>
__global__ void __launch_bounds__(kBlock)
banded_dp_kernel(const int8_t* __restrict__ query,
                 const int32_t* __restrict__ qlens,
                 const int8_t* __restrict__ win,
                 const int8_t* __restrict__ qpen, int P, int L, Scoring sc,
                 float* __restrict__ score_out,
                 int32_t* __restrict__ stats_out) {
  constexpr int PB = kBlock / D;     // pairs per block
  constexpr bool FULL = NS == 6;
  constexpr int NP = FULL ? NS + 1 : NS;  // deletion payload (+ gap origin)
  const int W = L + D - 1;

  extern __shared__ int8_t smem[];
  int8_t* sq = smem;             // [PB, L] query codes
  int8_t* sw = sq + PB * L;      // [PB, W] window codes
  int8_t* sp = sw + PB * W;      // [PB, L] mismatch penalties (QPEN)
  const int pair0 = blockIdx.x * PB;
  const int np = min(PB, P - pair0);
  for (int k = threadIdx.x; k < np * L; k += kBlock)
    sq[k] = query[(size_t)pair0 * L + k];
  for (int k = threadIdx.x; k < np * W; k += kBlock)
    sw[k] = win[(size_t)pair0 * W + k];
  if (QPEN)
    for (int k = threadIdx.x; k < np * L; k += kBlock)
      sp[k] = qpen[(size_t)pair0 * L + k];
  __syncthreads();

  const int lp = threadIdx.x / D;
  if (lp >= np) return;  // whole segments only
  const int d = threadIdx.x % D;
  const int pair = pair0 + lp;
  const unsigned m = segment_mask<D>();
  const float fd = float(d);
  const float dge = fd * sc.ge;
  const int8_t* q = sq + lp * L;
  const int8_t* w = sw + lp * W + d;
  const int8_t* qp = sp + lp * L;
  const int qlen = qlens[pair];
  const int rows = min(qlen, L);

  float H = 0.f, I = kNeg;
  int Hf = 1;  // H starts a fresh alignment (row -1, or a local clamp)
  float Hs[NS], Is[NS];
  float lb = kNeg;  // this lane's best H (local mode) ...
  int lbi = 0;      // ... its first row ...
  float lbs[NS];    // ... and its statistics
#pragma unroll
  for (int s = 0; s < NS; ++s) Hs[s] = Is[s] = lbs[s] = 0.f;

  for (int i = 0; i < rows; ++i) {
    const float fi = float(i);
    const int qi = q[i];
    const int ri = w[i];
    const bool match = qi == ri && qi < 4 && ri < 4;
    const float mf = match ? 1.f : 0.f;
    float sub;
    if (QPEN) {
      const float pen = qi >= 4 ? sc.npen : (ri >= 4 ? -sc.mi : float(qp[i]));
      sub = match ? sc.ma : -pen;
    } else {
      sub = match ? sc.ma : sc.mi;
    }

    // diagonal move; a fresh path starts here at (row i, column i + d)
    const float T1 = H + sub;
    float T1s[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float fresh;
      if (FULL)
        fresh = s == 4 ? fi : (s == 5 ? fi + fd : 0.f);
      else
        fresh = fi + fd;
      T1s[s] = Hf ? fresh : Hs[s];
    }
    if (FULL) {
      T1s[0] = T1s[0] + mf;
      T1s[1] = T1s[1] + (1.f - mf);
    }

    // insertion (consumes query): predecessor at offset d+1, prev row
    const float Hsh = from_above<D>(m, H, 1, d, kNeg);
    const int Hfsh = from_above<D>(m, Hf, 1, d, 0);
    const float Ish = from_above<D>(m, I, 1, d, kNeg);
    const float i_ext = Ish - sc.ge;
    const float i_open = Hsh - sc.go - sc.ge;
    const bool take_ext = i_ext >= i_open;
    const float In = take_ext ? i_ext : i_open;
    float Ins[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float hs = from_above<D>(m, Hs[s], 1, d, 0.f);
      const float is = from_above<D>(m, Is[s], 1, d, 0.f);
      float fresh;
      if (FULL)
        fresh = s == 4 ? fi : (s == 5 ? fi + 1.f + fd : 0.f);
      else
        fresh = fi + 1.f + fd;
      Ins[s] = take_ext ? is : (Hfsh ? fresh : hs);
    }
    if (FULL) {
      Ins[2] = Ins[2] + 1.f;
      Ins[3] = Ins[3] + (take_ext ? 0.f : 1.f);
    }

    // best before deletions; the diagonal wins ties over the insertion
    const bool take_I = In > T1;
    float Hn = take_I ? In : T1;
    float pay[NP];
#pragma unroll
    for (int s = 0; s < NS; ++s) pay[s] = take_I ? Ins[s] : T1s[s];
    float A;
    if (LOCAL) {
      const bool clamp = Hn <= 0.f;
      if (clamp) {
        Hn = 0.f;
#pragma unroll
        for (int s = 0; s < NS; ++s) pay[s] = 0.f;
      }
      A = clamp ? kNeg : Hn + dge;
    } else {
      A = Hn + dge;
    }
    if (FULL) pay[NS] = fd;

    // deletion: exclusive prefix max over the band, with payload
#pragma unroll
    for (int s = 1; s < D; s <<= 1) {
      const float sA = from_below<D>(m, A, s, d, kNeg);
      const bool take = sA > A;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const float v = from_below<D>(m, pay[k], s, d, 0.f);
        pay[k] = take ? v : pay[k];
      }
      A = take ? sA : A;
    }
    const float exA = from_below<D>(m, A, 1, d, kNeg);
    float Ds[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) Ds[k] = from_below<D>(m, pay[k], 1, d, 0.f);
    if (FULL) {
      const float origin = from_below<D>(m, pay[NS], 1, d, 0.f);
      Ds[2] = Ds[2] + (fd - origin);
      Ds[3] = Ds[3] + 1.f;
    }
    const float Dv = exA - sc.go - dge;

    // final H: priority diagonal > deletion > insertion
    const bool take_D = Dv > T1;
    H = take_D ? Dv : T1;
#pragma unroll
    for (int s = 0; s < NS; ++s) Hs[s] = take_D ? Ds[s] : T1s[s];
    if (In > H) {
      H = In;
#pragma unroll
      for (int s = 0; s < NS; ++s) Hs[s] = Ins[s];
    }
    if (LOCAL) {
      Hf = H <= 0.f;
      if (Hf) {
        H = 0.f;
#pragma unroll
        for (int s = 0; s < NS; ++s) Hs[s] = 0.f;
      }
      if (H > lb) {
        lb = H;
        lbi = i;
#pragma unroll
        for (int s = 0; s < NS; ++s) lbs[s] = Hs[s];
      }
    } else {
      Hf = 0;
    }
    I = In;
#pragma unroll
    for (int s = 0; s < NS; ++s) Is[s] = Ins[s];
  }

  // reduce to the best cell: score, then earliest row, then offset
  float best;
  int bi, bd;
  float bst[NS];
  if (LOCAL) {
    float b = lb;
    int r = lbi, o = d;
#pragma unroll
    for (int s = D / 2; s >= 1; s >>= 1) {
      const float b2 = __shfl_xor_sync(m, b, s, D);
      const int r2 = __shfl_xor_sync(m, r, s, D);
      const int o2 = __shfl_xor_sync(m, o, s, D);
      if (b2 > b || (b2 == b && (r2 < r || (r2 == r && o2 < o)))) {
        b = b2;
        r = r2;
        o = o2;
      }
    }
    best = b;
    bi = r;
    bd = o;
#pragma unroll
    for (int s = 0; s < NS; ++s) bst[s] = __shfl_sync(m, lbs[s], o, D);
  } else {
    // end-to-end: the best offset of the read's last row
    float b = H;
    int o = d;
#pragma unroll
    for (int s = D / 2; s >= 1; s >>= 1) {
      const float b2 = __shfl_xor_sync(m, b, s, D);
      const int o2 = __shfl_xor_sync(m, o, s, D);
      if (b2 > b || (b2 == b && o2 < o)) {
        b = b2;
        o = o2;
      }
    }
    const bool ok = qlen >= 1 && qlen <= L;
    best = ok ? b : kNeg;
    bi = ok ? qlen - 1 : 0;
    bd = ok ? o : 0;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float v = __shfl_sync(m, Hs[s], o, D);
      bst[s] = ok ? v : 0.f;
    }
  }

  if (d == 0) {
    score_out[pair] = best;
    int32_t* out = stats_out + pair;
    if (FULL) {
      out[0 * (size_t)P] = int32_t(bst[4]);   // qstart
      out[1 * (size_t)P] = bi + 1;            // qend
      out[2 * (size_t)P] = int32_t(bst[5]);   // wstart
      out[3 * (size_t)P] = bi + bd + 1;       // wend
      out[4 * (size_t)P] = int32_t(bst[0]);   // matches
      out[5 * (size_t)P] = int32_t(bst[1]);   // mismatches
      out[6 * (size_t)P] = int32_t(bst[2]);   // gap_cols
      out[7 * (size_t)P] = int32_t(bst[3]);   // gap_opens
    } else {
      out[0 * (size_t)P] = bi + 1;            // qend
      out[1 * (size_t)P] = int32_t(bst[0]);   // wstart
      out[2 * (size_t)P] = bi + bd + 1;       // wend
    }
  }
}

template <int D, bool LOCAL, int NS, bool QPEN>
cudaError_t launch(cudaStream_t stream, const int8_t* query,
                   const int32_t* qlens, const int8_t* win,
                   const int8_t* qpen, int P, int L, Scoring sc,
                   float* score, int32_t* stats) {
  constexpr int PB = kBlock / D;
  const int W = L + D - 1;
  const size_t smem = size_t(PB) * (L + W + (QPEN ? L : 0));
  const int grid = (P + PB - 1) / PB;
  banded_dp_kernel<D, LOCAL, NS, QPEN><<<grid, kBlock, smem, stream>>>(
      query, qlens, win, qpen, P, L, sc, score, stats);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_band(cudaStream_t stream, bool local, bool score_only,
                        bool qual_pen, const int8_t* query,
                        const int32_t* qlens, const int8_t* win,
                        const int8_t* qpen, int P, int L, Scoring sc,
                        float* score, int32_t* stats) {
#define MIDAS_LAUNCH(LOC, NS, QP)                                           \
  return launch<D, LOC, NS, QP>(stream, query, qlens, win, qpen, P, L, sc, \
                                score, stats)
  if (local) {
    if (score_only) {
      if (qual_pen) MIDAS_LAUNCH(true, 1, true);
      MIDAS_LAUNCH(true, 1, false);
    }
    if (qual_pen) MIDAS_LAUNCH(true, 6, true);
    MIDAS_LAUNCH(true, 6, false);
  }
  if (score_only) {
    if (qual_pen) MIDAS_LAUNCH(false, 1, true);
    MIDAS_LAUNCH(false, 1, false);
  }
  if (qual_pen) MIDAS_LAUNCH(false, 6, true);
  MIDAS_LAUNCH(false, 6, false);
#undef MIDAS_LAUNCH
}

ffi::Error BandedDp(cudaStream_t stream, ffi::Buffer<ffi::S8> query,
                    ffi::Buffer<ffi::S32> qlens, ffi::Buffer<ffi::S8> win,
                    ffi::Buffer<ffi::S8> qpen,
                    ffi::ResultBuffer<ffi::F32> score,
                    ffi::ResultBuffer<ffi::S32> stats, float match,
                    float mismatch, float gap_open, float gap_extend,
                    float n_pen, int32_t band_width, int32_t local,
                    int32_t score_only, int32_t qual_pen) {
  const auto qd = query.dimensions();
  const auto wd = win.dimensions();
  const auto sd = stats->dimensions();
  if (qd.size() != 2 || wd.size() != 2 || sd.size() != 2)
    return ffi::Error::InvalidArgument("banded_dp: query, window and stats "
                                       "must be rank 2");
  const int64_t P = qd[0], L = qd[1];
  const int64_t n_stats = score_only ? 3 : 8;
  if (wd[0] != P || wd[1] != L + band_width - 1 ||
      qlens.element_count() != size_t(P) ||
      score->element_count() != size_t(P) || sd[0] != n_stats ||
      sd[1] != P || (qual_pen && qpen.element_count() != size_t(P * L)))
    return ffi::Error::InvalidArgument("banded_dp: inconsistent shapes");
  if (P == 0) return ffi::Error::Success();
  const Scoring sc{match, mismatch, gap_open, gap_extend, n_pen};
  cudaError_t err;
  switch (band_width) {
    case 16:
      err = launch_band<16>(stream, local, score_only, qual_pen,
                            query.typed_data(), qlens.typed_data(),
                            win.typed_data(), qpen.typed_data(), int(P),
                            int(L), sc, score->typed_data(),
                            stats->typed_data());
      break;
    default:
      return ffi::Error::InvalidArgument(
          "banded_dp: band_width " + std::to_string(band_width) +
          " is not compiled (16 is)");
  }
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("banded_dp launch: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(MidasBandedDp, BandedDp,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()   // query
                                  .Arg<ffi::Buffer<ffi::S32>>()  // qlens
                                  .Arg<ffi::Buffer<ffi::S8>>()   // window
                                  .Arg<ffi::Buffer<ffi::S8>>()   // qpen
                                  .Ret<ffi::Buffer<ffi::F32>>()  // score
                                  .Ret<ffi::Buffer<ffi::S32>>()  // stats
                                  .Attr<float>("match")
                                  .Attr<float>("mismatch")
                                  .Attr<float>("gap_open")
                                  .Attr<float>("gap_extend")
                                  .Attr<float>("n_pen")
                                  .Attr<int32_t>("band_width")
                                  .Attr<int32_t>("local")
                                  .Attr<int32_t>("score_only")
                                  .Attr<int32_t>("qual_pen"));
