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
// What bounds it on the H100: the chain of dependent sweeps.  At the tracker's 32x32 a sweep is
// ~3 x 32 operations for each row that bids, on 4 KB of costs: the bound (bytes once, the bidding
// rows' operations) is about a nanosecond, and each sweep's barriers and shuffles cost more.  The design keeps the
// chain on the card, where the plain version takes ~35 launches a sweep and a host sync every 4
// sweeps:
// - one block a problem, a warp a row (rows r, r + warps, ... where R exceeds 32 warps), a lane a
//   column (columns l, l + 32, ... where D exceeds 32): v1, j* and v2 from a lane scan and five
//   xor-shuffle merges of (v1, j*, v2);
// - prices, owners, the rows' states, bids and bid columns in shared memory; a column's best bid
//   from one thread scanning the rows' bids in row order (shared-memory broadcasts);
// - the costs read from global memory through the read-only cache (L1-resident after the first
//   sweep); three barriers a sweep.
// Rows and columns each up to 1,024 (21 KB of shared memory); larger problems are refused with
// cudaErrorInvalidValue.  Outputs: col_of_row (R,) int64, -1 = unmatched, and the sweep count
// (int32).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 1024;
constexpr int kMaxCols = 1024;
constexpr int kMaxWarps = 32;
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
