// The tracker's gated auction: threshold-gated min-cost matching of rows (tracks) to columns
// (detections) with a null option, the whole solve of one cost matrix in one launch.
//
// Replaces the JAX package's dcnn/hungarian.py gated_auction_match, a lax.while_loop on the
// device (no Pallas kernel).  Plain version: apse_uav_torch/dcnn/hungarian.py
// gated_auction_sweeps, which the JAX function's operations are ported into one for one.  This
// kernel runs the same float32 operations in the same order, bit for bit:
// - benefit = valid ? -cost : -1e30; reserve = -threshold;
//   spread = max(max(benefit > -5e29 ? benefit : reserve) - reserve, 1e-6); eps = spread / 1024;
// - a sweep: every bidding row takes its best value v1 = max_j (benefit - price) at column j*
//   (the lower column on ties) and its second-best-or-null v2 = max(max_{j != j*}, -1e30,
//   reserve); it exits to null where v1 <= reserve, else bids (v1 - v2) + eps on j*.  Each
//   column with a bid above -5e29 goes to its highest bidder (the lower row on ties), its price
//   rises by that bid, and its previous owner goes back to bidding;
// - sweeps run while a row is bidding, at most max_sweeps; rows still bidding then exit.
// Maxima are exact in any order, so the reductions may run as trees; the sums and the one
// division are single IEEE operations (-fmad=false changes none of them).  NaN costs are not
// ordered as torch orders them; the tracker's costs are finite squared distances.
//
// Two kernels compute it, chosen by shape (dcnn/cuda_auction.py kernel_for):
// - auction_warp_kernel for R <= 32 and D <= 32, the tracker's 32 x 32 (TrackerConfig's
//   max_tracks and max_detections): one warp a problem, a lane a row and a lane a column;
// - auction_kernel, one block a problem, for up to 1,024 rows and 1,024 columns.
//
// What bounds them on the H100: the chain of dependent sweeps.  At 32 x 32 a sweep is ~100
// operations for each row that bids, on 4 KB of costs: the bytes bound (each input read once) is
// about a nanosecond, and a sweep cannot start before the last one's prices are known, so the time
// is the sweep count times one sweep's latency.  Both kernels keep the chain on the card, where the
// plain version takes ~35 launches a sweep and a host sync every 4 sweeps.
//
// auction_warp_kernel takes the block kernel's three per-sweep costs off that chain:
// - the column pass: there one thread a column scans all rows' (j*, bid) in shared memory while
//   31 warps wait; here lane c takes the bidding rows' (j*, bid) by shuffles, in row order, four
//   rows at a time, skipping the rows that do not bid (a ballot), all 32 lanes at once;
// - barriers: there three __syncthreads a sweep across 32 warps; here none: the warp's shuffles
//   and votes are the only synchronisation, and nothing is in shared memory;
// - the costs: there re-read (and negated) through L1 every sweep; here lane r reads row r once
//   and keeps its 32 benefits in registers (loops unrolled over a compile-time 32), and lane c
//   keeps price c and owner c in registers; a row's scan takes each price by a shuffle and
//   reduces its 32 values by a 5-level tree of top-2 merges, not a 32-step chain of compares.
// A row learns its new state from the lane of the column it bid on or held: it won if that
// column's owner is now the row, and a row that held a column goes back to bidding if the owner
// is another row.  At the tracker's costs a sweep has ~4 bidding rows, so the row scan and the
// warp's votes and shuffles set a sweep's time.
//
// auction_kernel: a warp a row (rows r, r + warps, ... where R exceeds 32 warps), a lane a column
// (columns l, l + 32, ... where D exceeds 32): v1, j* and v2 from a lane scan and five
// xor-shuffle merges of (v1, j*, v2); prices, owners, the rows' states, bids and bid columns in
// shared memory; a column's best bid from one thread scanning the rows' bids in row order; the
// costs through the read-only cache; three barriers a sweep.  21 KB of shared memory.
//
// Larger problems are refused with cudaErrorInvalidValue, as is a problem above 32 x 32 given
// to the warp kernel.  Outputs: col_of_row (R,) int64, -1 = unmatched, and the sweep count
// (int32).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 1024;
constexpr int kMaxCols = 1024;
constexpr int kMaxWarps = 32;
constexpr int kWarpMax = 32;  // auction_warp_kernel's rows and columns
constexpr int kBidding = -2;
constexpr int kNull = -1;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// The best value of a set of columns, its column (the lower on ties) and the best value of the
// rest of the set.
struct Top2 {
  float v1;
  int j;
  float v2;
};

// a <- the Top2 of the union of a's and b's (disjoint) sets.
__device__ __forceinline__ void merge(Top2& a, const Top2& b) {
  if (b.v1 > a.v1 || (b.v1 == a.v1 && b.j < a.j)) {
    a.v2 = fmaxf(a.v1, b.v2);
    a.v1 = b.v1;
    a.j = b.j;
  } else {
    a.v2 = fmaxf(a.v2, b.v1);
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32) auction_kernel(const float* __restrict__ cost,
                                                                 const uint8_t* __restrict__ row_valid,
                                                                 const uint8_t* __restrict__ col_valid, int n_rows,
                                                                 int n_cols, float threshold, int max_sweeps,
                                                                 int64_t* __restrict__ out, int32_t* __restrict__ sweeps_out) {
  __shared__ float prices[kMaxCols];
  __shared__ int owner[kMaxCols];
  __shared__ uint8_t cvalid[kMaxCols];
  __shared__ int col_of_row[kMaxRows];  // kBidding, kNull or the column held
  __shared__ int jstar[kMaxRows];       // the column bid on this sweep, -1 for none
  __shared__ float bid[kMaxRows];
  __shared__ float warp_max[kMaxWarps];

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const float reserve = -threshold;

  for (int j = tid; j < n_cols; j += nthreads) {
    prices[j] = 0.0f;
    owner[j] = -1;
    cvalid[j] = col_valid[j];
  }
  for (int r = tid; r < n_rows; r += nthreads) col_of_row[r] = row_valid[r] ? kBidding : kNull;

  // spread and eps.
  float m = -INFINITY;
  for (int i = tid; i < n_rows * n_cols; i += nthreads) {
    const int r = i / n_cols, j = i - r * n_cols;
    const float b = (row_valid[r] && col_valid[j]) ? -__ldg(cost + i) : kNegInf;
    m = fmaxf(m, b > kNegInf / 2.0f ? b : reserve);
  }
  for (int off = 16; off; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  m = warp_max[0];
  for (int w = 1; w < nwarps; ++w) m = fmaxf(m, warp_max[w]);
  const float spread = fmaxf(m - reserve, 1e-6f);
  const float eps = spread / 1024.0f;

  int sweeps = 0;
  while (sweeps < max_sweeps) {
    int mine = 0;
    for (int r = tid; r < n_rows; r += nthreads) mine |= col_of_row[r] == kBidding;
    if (!__syncthreads_or(mine)) break;

    // Each bidding row: its best and second-best-or-null value, then exit or bid.
    for (int r = warp; r < n_rows; r += nwarps) {
      if (col_of_row[r] != kBidding) {  // the same for the whole warp
        if (lane == 0) jstar[r] = -1;
        continue;
      }
      Top2 t{-INFINITY, 0x7fffffff, -INFINITY};
      const float* row = cost + (size_t)r * n_cols;
      for (int j = lane; j < n_cols; j += 32) {  // a bidding row is valid
        const float v = (cvalid[j] ? -__ldg(row + j) : kNegInf) - prices[j];
        if (v > t.v1) {
          t.v2 = t.v1;
          t.v1 = v;
          t.j = j;
        } else {
          t.v2 = fmaxf(t.v2, v);
        }
      }
      for (int off = 16; off; off >>= 1) {
        const Top2 o{__shfl_xor_sync(kFull, t.v1, off), __shfl_xor_sync(kFull, t.j, off),
                     __shfl_xor_sync(kFull, t.v2, off)};
        merge(t, o);
      }
      if (lane == 0) {
        // masked[r, j*] = -1e30 joins the second-best, then the null option.
        const float v2 = fmaxf(fmaxf(t.v2, kNegInf), reserve);
        if (t.v1 <= reserve) {
          col_of_row[r] = kNull;
          jstar[r] = -1;
        } else {
          bid[r] = (t.v1 - v2) + eps;
          jstar[r] = t.j;
        }
      }
    }
    __syncthreads();

    // Each column: its highest bid (the lower row on ties) takes it.
    for (int c = tid; c < n_cols; c += nthreads) {
      float best = jstar[0] == c ? bid[0] : kNegInf;
      int best_row = 0;
      for (int r = 1; r < n_rows; ++r) {
        const float b = jstar[r] == c ? bid[r] : kNegInf;
        if (b > best) {
          best = b;
          best_row = r;
        }
      }
      if (best > kNegInf / 2.0f) {
        // The previous owner held no other column and did not bid, and each bidder bid on one
        // column: the rows written here are written by no other thread.
        prices[c] = prices[c] + best;
        const int prev = owner[c];
        if (prev >= 0) col_of_row[prev] = kBidding;
        col_of_row[best_row] = c;
        owner[c] = best_row;
      }
    }
    __syncthreads();
    ++sweeps;
  }
  __syncthreads();

  for (int r = tid; r < n_rows; r += nthreads) out[r] = col_of_row[r] == kBidding ? kNull : col_of_row[r];
  if (tid == 0) *sweeps_out = sweeps;
}


// One warp a problem of R <= 32 rows and D <= 32 columns: lane r holds row r's benefits and
// state, lane c column c's price and owner.  The same float32 operations as auction_kernel, with
// the same results.
__global__ void __launch_bounds__(32) auction_warp_kernel(const float* __restrict__ cost,
                                                          const uint8_t* __restrict__ row_valid,
                                                          const uint8_t* __restrict__ col_valid, int n_rows,
                                                          int n_cols, float threshold, int max_sweeps,
                                                          int64_t* __restrict__ out,
                                                          int32_t* __restrict__ sweeps_out) {
  const int lane = threadIdx.x;
  const float reserve = -threshold;
  const bool row_ok = lane < n_rows && row_valid[lane];
  const unsigned col_ok = __ballot_sync(kFull, lane < n_cols && col_valid[lane]);

  // Row lane's benefits, -INFINITY past the last column (never a best or a second best).  The
  // loads do not wait on the masks, so they are all in flight at once.
  float benefit[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    benefit[j] = -INFINITY;
    if (j < n_cols && lane < n_rows) {
      const float c = __ldg(cost + lane * n_cols + j);
      benefit[j] = (row_ok && ((col_ok >> j) & 1u)) ? -c : kNegInf;
    }
  }
  // spread and eps: the lane's max over its real entries, then the warp's.
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < 32; ++j)
    if (j < n_cols && lane < n_rows) m = fmaxf(m, benefit[j] > kNegInf / 2.0f ? benefit[j] : reserve);
#pragma unroll
  for (int off = 16; off; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  const float spread = fmaxf(m - reserve, 1e-6f);
  const float eps = spread / 1024.0f;

  float price = 0.0f;                     // column lane's
  int owner = -1;                         // column lane's
  int state = row_ok ? kBidding : kNull;  // row lane's: kBidding, kNull or the column held
  int sweeps = 0;
  while (sweeps < max_sweeps && __any_sync(kFull, state == kBidding)) {
    // Row scan: the best value v1 at j* (the lower column on ties) and the best of the rest, by
    // a tree of merges of neighbouring column ranges, 5 levels deep.  The higher range wins a
    // merge only by a strict >, so the result is an ascending scan's.
    float v1[32], v2[32];
    int jstar[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      v1[j] = benefit[j] - __shfl_sync(kFull, price, j);
      v2[j] = -INFINITY;
      jstar[j] = j;
    }
#pragma unroll
    for (int w = 1; w < 32; w <<= 1) {
#pragma unroll
      for (int i = 0; i < 32; i += 2 * w) {
        if (v1[i + w] > v1[i]) {
          v2[i] = fmaxf(v1[i], v2[i + w]);
          v1[i] = v1[i + w];
          jstar[i] = jstar[i + w];
        } else {
          v2[i] = fmaxf(v2[i], v1[i + w]);
        }
      }
    }
    // masked[r, j*] = -1e30 joins the second-best, then the null option.
    const float second = fmaxf(fmaxf(v2[0], kNegInf), reserve);
    int bid_col = -1;
    float bid = 0.0f;
    if (state == kBidding) {
      if (v1[0] <= reserve) {
        state = kNull;
      } else {
        bid = (v1[0] - second) + eps;
        bid_col = jstar[0];
      }
    }

    // Column pass: column lane's highest bid (the lower row on ties) over the bidding rows in
    // row order, four rows' (j*, bid) shuffled at a time (r = -1 once none is left).
    float best = kNegInf;
    int best_row = 0;
    for (unsigned bidders = __ballot_sync(kFull, bid_col >= 0); bidders;) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = __ffs(bidders) - 1;
        bidders &= bidders - 1;
        const int c = __shfl_sync(kFull, bid_col, r & 31);
        const float b = __shfl_sync(kFull, bid, r & 31);
        if (r >= 0 && c == lane && b > best) {
          best = b;
          best_row = r;
        }
      }
    }
    if (best > kNegInf / 2.0f) {
      price = price + best;
      owner = best_row;
    }

    // Each row that bid or held a column reads that column's owner: its own, or back to bidding.
    const int col = state >= 0 ? state : (bid_col >= 0 ? bid_col : 0);
    const int now = __shfl_sync(kFull, owner, col);
    if (state >= 0 || bid_col >= 0) state = now == lane ? col : kBidding;
    ++sweeps;
  }

  if (lane < n_rows) out[lane] = state == kBidding ? kNull : state;
  if (lane == 0) *sweeps_out = sweeps;
}

}  // namespace

// cost (R, D) float32, row_valid (R,) and col_valid (D,) bool as bytes, all contiguous on the
// card; out (R,) int64 and sweeps (1,) int32.  Returns cudaErrorInvalidValue for R or D outside
// 1..1024, else the launch's cudaGetLastError().
extern "C" int auction_launch(const float* cost, const uint8_t* row_valid, const uint8_t* col_valid, int n_rows,
                              int n_cols, float threshold, int max_sweeps, int64_t* out, int32_t* sweeps,
                              cudaStream_t stream) {
  if (n_rows < 1 || n_rows > kMaxRows || n_cols < 1 || n_cols > kMaxCols) return (int)cudaErrorInvalidValue;
  const int warps = n_rows < kMaxWarps ? n_rows : kMaxWarps;
  auction_kernel<<<1, warps * 32, 0, stream>>>(cost, row_valid, col_valid, n_rows, n_cols, threshold, max_sweeps,
                                               out, sweeps);
  return (int)cudaGetLastError();
}

// The same arguments for a problem of 1..32 rows and 1..32 columns (cudaErrorInvalidValue
// otherwise), solved by one warp.
extern "C" int auction_warp_launch(const float* cost, const uint8_t* row_valid, const uint8_t* col_valid,
                                   int n_rows, int n_cols, float threshold, int max_sweeps, int64_t* out,
                                   int32_t* sweeps, cudaStream_t stream) {
  if (n_rows < 1 || n_rows > kWarpMax || n_cols < 1 || n_cols > kWarpMax) return (int)cudaErrorInvalidValue;
  auction_warp_kernel<<<1, 32, 0, stream>>>(cost, row_valid, col_valid, n_rows, n_cols, threshold, max_sweeps,
                                            out, sweeps);
  return (int)cudaGetLastError();
}
