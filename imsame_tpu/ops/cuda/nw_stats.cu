// Accept-gate statistics of the reference's long-gap aligner on an NVIDIA
// Hopper GPU, bit-equal to ops/nw.py nw_stats_batch (the plain reference).
//
// The DP and its quirks are those of oracle/nw.py (SURVEY.md 6.2-6.4);
// the per-cell (length, identities) propagation is nw_stats_batch's, with
// both stats in one int32 word w = length + (identities << 16).
//
// Layout: one warp per pair.  The DP rows are cut into bands of 32*R rows;
// inside a band lane k owns rows [k*R, k*R + R) and sweeps the columns
// one per step, lagging lane k-1 by one step, so lane k computes column
// j = t - k at step t.  Everything the recurrence carries stays in
// registers for the whole DP:
//   * per row: T and W of the two previous columns, and the row-max
//     tracker mf (score, gap base, stats base);
//   * per column: the column-max tracker mc of column j-1, which flows
//     down the rows of a lane inside the step and then to the next lane
//     with __shfl_up_sync, together with T/W of the lane's last two rows;
//   * per lane: the best eligible cell as the packed key score*8192 + i.
// Between bands, the band's last lane hands its last two rows and the mc
// trackers to the next band through a [7, L] scratch row per pair (used
// only when L > 32*R).  Device memory therefore sees the two code rows in
// and four int32 per pair out.
//
// Trackers are kept with their gap-penalty and stats bases folded in:
//   left  = mf_s + igap + (j - mf_y - 1)*egap + s = mfb + j*egap + s
//   right = mc_s + igap + (i - mc_x - 1)*egap + s = mcb + i*egap + s
// and a gap move adds its run to the length half of w: j - mf_y for a
// left move (the row tracker sits on row i or i-1, so the y run is the
// longer side) and i - mc_x for an up move (i - mc_x >= 2 > 1).  All of
// it is exact int32 arithmetic, as in nw_stats_batch.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kPoint = 4;           // constants.POINT
constexpr int kNeg = -(1 << 28);    // ops/nw.py NEG
constexpr int kKeyBase = 8192;      // best-cell key: score * 8192 + row
constexpr int kDiagHit = 0x10001;   // diagonal match: length +1, identities +1
constexpr int kWarpsPerBlock = 4;
constexpr int kScratchRows = 7;
constexpr unsigned kFullMask = 0xffffffffu;

template <int R>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
nw_stats_kernel(const uint8_t* __restrict__ X, const uint8_t* __restrict__ Y,
                const int32_t* __restrict__ xlen,
                const int32_t* __restrict__ ylen,
                const int32_t* __restrict__ igap_p,
                const int32_t* __restrict__ egap_p, int B, int L,
                int32_t* __restrict__ out, int32_t* __restrict__ scratch) {
  static_assert(R % 4 == 0 && R >= 4, "rows per lane must be a multiple of 4");
  constexpr int kBand = 32 * R;
  const int pair = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pair >= B) return;  // uniform per warp

  const int xl = xlen[pair];
  const int yl = ylen[pair];
  const int igap = *igap_p;
  const int egap = *egap_p;
  const uint8_t* x = X + static_cast<size_t>(pair) * L;
  const uint8_t* y = Y + static_cast<size_t>(pair) * L;
  int32_t* sc = scratch + static_cast<size_t>(pair) * kScratchRows * L;

  int best_key = INT_MIN, best_j = 0, best_w = 0;

  for (int band0 = 0; band0 < xl; band0 += kBand) {
    const int row0 = band0 + lane * R;
    uint32_t xw[R / 4];  // this lane's db codes, four per word
    const uint32_t* xr = reinterpret_cast<const uint32_t*>(x + row0);
#pragma unroll
    for (int q = 0; q < R / 4; ++q) xw[q] = xr[q];

    int t1[R], t2[R], w1[R], w2[R], mfs[R], mfb[R], mfw[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      t1[r] = t2[r] = w1[r] = w2[r] = 0;
      mfs[r] = mfb[r] = mfw[r] = 0;
    }
    // Handed down from the lane above (or the band above, for lane 0):
    // T/W of its last row at columns j-1 and j-2, T/W of its second-last
    // row at column j-1, and column j-1's mc tracker after its rows.
    int in_t1 = 0, in_t2 = 0, in_w1 = 0, in_w2 = 0, in_u1 = 0, in_v1 = 0;
    int in_mcs = 0, in_mcb = 0, in_mcw = 0;

    const bool live = row0 < xl;
    const int last_lane = min(31, (xl - 1 - band0) / R);
    const int steps = yl + last_lane;
    for (int t = 0; t < steps; ++t) {
      const int j = t - lane;
      const bool act = live && j >= 0 && j < yl;
      if (lane == 0 && band0 > 0 && act) {
        in_mcs = sc[j];
        in_mcb = sc[L + j];
        in_mcw = sc[2 * L + j];
        if (j >= 1) {
          in_t1 = sc[3 * L + j - 1];
          in_w1 = sc[4 * L + j - 1];
          in_u1 = sc[5 * L + j - 1];
          in_v1 = sc[6 * L + j - 1];
        }
        if (j >= 2) {
          in_t2 = sc[3 * L + j - 2];
          in_w2 = sc[4 * L + j - 2];
        }
      }
      int mcs = in_mcs, mcb = in_mcb, mcw = in_mcw;
      if (act) {
        const int yc = y[j];
        // T/W of the row above at columns j-1, j-2 and two rows above at j-1
        int ut1 = in_t1, ut2 = in_t2, uw1 = in_w1, uw2 = in_w2;
        int u2t = in_u1, u2w = in_v1;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = row0 + r;
          const int xc = (xw[r >> 2] >> (8 * (r & 3))) & 0xff;
          const bool match = xc == yc;
          const int s = match ? kPoint : -kPoint;
          const int ot1 = t1[r], ot2 = t2[r], ow1 = w1[r], ow2 = w2[r];
          int cell, w;
          if (i == 0 || j == 0) {
            // border cell: bare +/-POINT, stats 0
            cell = s;
            w = 0;
            if (j == 0) {  // row-max tracker restarts at (i, 0)
              mfs[r] = s;
              mfb[r] = s + igap - egap;
              mfw[r] = 0;
            } else {  // column j-1's tracker starts at (0, j-1)
              mcs = ot1;
              mcb = ot1 + igap - egap;
              mcw = 0;
            }
          } else {
            // row max: compare T[i][j-2], assign T[i-1][j-2] (SURVEY.md 6.3)
            if (j >= 2 && mfs[r] <= ot2) {
              mfs[r] = ut2;
              mfb[r] = ut2 + igap - (j - 1) * egap;
              mfw[r] = uw2 - (j - 2);
            }
            const int diag = ut1 + s;
            const int left = j >= 2 ? mfb[r] + j * egap + s : kNeg;
            const int right = i >= 2 ? mcb + i * egap + s : kNeg;
            const bool pick_diag = diag >= left && diag >= right;
            const bool pick_right = !pick_diag && right > left;
            cell = pick_diag ? diag : (pick_right ? right : left);
            w = pick_diag ? uw1 + (match ? kDiagHit : 1)
                          : (pick_right ? mcw + i : mfw[r] + j);
            // column max from two rows up, strict > (SURVEY.md 6.4)
            if (i >= 2 && j >= 2 && u2t > mcs) {
              mcs = u2t;
              mcb = u2t + igap - (i - 1) * egap;
              mcw = u2w - (i - 2);
            }
            // best cell on the last row/column: lex max of (score, i, j)
            if (i < xl && (i == xl - 1 || j == yl - 1)) {
              const int key = cell * kKeyBase + i;
              if (key >= best_key) {
                best_key = key;
                best_j = j;
                best_w = w;
              }
            }
          }
          t2[r] = ot1;
          t1[r] = cell;
          w2[r] = ow1;
          w1[r] = w;
          u2t = ut1;
          u2w = uw1;
          ut1 = ot1;
          ut2 = ot2;
          uw1 = ow1;
          uw2 = ow2;
        }
        if (lane == 31 && L > kBand) {
          sc[j] = mcs;
          sc[L + j] = mcb;
          sc[2 * L + j] = mcw;
          sc[3 * L + j] = t1[R - 1];
          sc[4 * L + j] = w1[R - 1];
          sc[5 * L + j] = t1[R - 2];
          sc[6 * L + j] = w1[R - 2];
        }
      }
      // Lane k+1 computes this column at the next step.
      in_t2 = in_t1;
      in_w2 = in_w1;
      in_t1 = __shfl_up_sync(kFullMask, t2[R - 1], 1);
      in_w1 = __shfl_up_sync(kFullMask, w2[R - 1], 1);
      in_u1 = __shfl_up_sync(kFullMask, t2[R - 2], 1);
      in_v1 = __shfl_up_sync(kFullMask, w2[R - 2], 1);
      in_mcs = __shfl_up_sync(kFullMask, mcs, 1);
      in_mcb = __shfl_up_sync(kFullMask, mcb, 1);
      in_mcw = __shfl_up_sync(kFullMask, mcw, 1);
    }
    __syncwarp();
  }

  // Rows are disjoint across lanes, so the keys are unique: plain argmax.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ok = __shfl_xor_sync(kFullMask, best_key, off);
    const int oj = __shfl_xor_sync(kFullMask, best_j, off);
    const int ow = __shfl_xor_sync(kFullMask, best_w, off);
    if (ok > best_key) {
      best_key = ok;
      best_j = oj;
      best_w = ow;
    }
  }
  if (lane == 0) {
    int score = INT_MIN + 1, bi = 0;  // nw_stats_batch's value with no eligible cell
    if (best_key != INT_MIN) {
      score = best_key >> 13;  // floor division by kKeyBase
      bi = best_key & (kKeyBase - 1);
    } else {
      best_j = 0;
    }
    out[pair] = score;
    out[B + pair] = bi;
    out[2 * B + pair] = best_j;
    out[3 * B + pair] = best_w;
  }
}

template <int R>
void Launch(cudaStream_t stream, const uint8_t* X, const uint8_t* Y,
            const int32_t* xlen, const int32_t* ylen, const int32_t* igap,
            const int32_t* egap, int B, int L, int32_t* out,
            int32_t* scratch) {
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  nw_stats_kernel<R><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      X, Y, xlen, ylen, igap, egap, B, L, out, scratch);
}

ffi::Error NwStatsImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> X,
                       ffi::Buffer<ffi::U8> Y, ffi::Buffer<ffi::S32> xlen,
                       ffi::Buffer<ffi::S32> ylen, ffi::Buffer<ffi::S32> igap,
                       ffi::Buffer<ffi::S32> egap,
                       ffi::ResultBuffer<ffi::S32> out,
                       ffi::ResultBuffer<ffi::S32> scratch) {
  auto dims = X.dimensions();
  if (dims.size() != 2) {
    return ffi::Error::InvalidArgument("X must be [B, L]");
  }
  const int B = static_cast<int>(dims[0]);
  const int L = static_cast<int>(dims[1]);
  if (B == 0) return ffi::Error::Success();
  const int R = L >= 512 ? 16 : L / 32;
  if ((R != 4 && R != 8 && R != 16) || L % (32 * R) != 0) {
    return ffi::Error::InvalidArgument("L must be 128, 256 or a multiple of 512");
  }
  if (L > 32 * R &&
      scratch->element_count() < static_cast<size_t>(B) * kScratchRows * L) {
    return ffi::Error::InvalidArgument("scratch must hold [B, 7, L] int32");
  }
  auto args = [&](auto launch) {
    launch(stream, X.typed_data(), Y.typed_data(), xlen.typed_data(),
           ylen.typed_data(), igap.typed_data(), egap.typed_data(), B, L,
           out->typed_data(), scratch->typed_data());
  };
  if (R == 4) {
    args(Launch<4>);
  } else if (R == 8) {
    args(Launch<8>);
  } else {
    args(Launch<16>);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(ImsameNwStats, NwStatsImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()   // X [B, L]
                                  .Arg<ffi::Buffer<ffi::U8>>()   // Y [B, L]
                                  .Arg<ffi::Buffer<ffi::S32>>()  // xlen [B]
                                  .Arg<ffi::Buffer<ffi::S32>>()  // ylen [B]
                                  .Arg<ffi::Buffer<ffi::S32>>()  // igap []
                                  .Arg<ffi::Buffer<ffi::S32>>()  // egap []
                                  .Ret<ffi::Buffer<ffi::S32>>()  // [4, B]
                                  .Ret<ffi::Buffer<ffi::S32>>());  // scratch
