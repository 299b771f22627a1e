// K1: 4-connected component labels of binarized candidate windows.
//
// Replaces the JAX package's Pallas TPU kernel aruco/pallas_labeling.py:116 (labels_batched).
// Plain version: apse_uav_torch/aruco/detector.py _label_sweeps.  The same fixed schedule, bit
// for bit: `rounds` rounds of a row sweep then a column sweep, then `mop` radius-1 steps.  Root
// label y*win + x, sentinel win*win on non-dark cells.  The schedule does not converge on every
// mask (a serpentine keeps many labels), so it is reproduced, not replaced by an exact
// labeling.
//
// A sweep is a run-min: the plain version's segmented prefix mins with run-id keys
// (R - runid)*K + label leave every dark cell with the least label of the dark run that holds
// it along the sweep's axis (K > win*win, so a nearer run's key always loses), and a non-dark
// cell with the sentinel.  A mop step is a Jacobi step: each cell reads the previous field.
//
// What bounds it on the H100: the schedule's dependent steps and the instructions they take.  A
// 64x64 window is 4 KB in and 16 KB out and ~5e5 integer operations of schedule: 600 windows are
// 0.0045 ms of operations at the card's rate and 0.0037 ms of bytes, and they fit in one wave,
// so a block's chain of 6 sweeps and 8 steps, and the instructions it spends on them, set the
// time.  The design cuts both:
// - The dark mask as bits, one 64-bit word per row and one per column, built once per window by
//   __ballot_sync.  A lane's links between neighbouring cells and the reach of its runs are bit
//   operations on those words (__clzll / __ffsll on the masked complement), computed once for
//   the whole schedule.
// - Two lines in the 16-bit halves of each register, minimised two at a time by __vminu2, and 8
//   cells of both lines a lane: a serial prefix and suffix min inside the lane, then a segmented
//   doubling scan of the lanes' carries (3 __shfl_up_sync and 3 __shfl_down_sync steps of
//   width 8, a step taking its source only while that source's end cell lies in the run), then
//   the serial mins again, seeded with the neighbours' carries.  A warp sweeps 8 lines at once,
//   so 8 warps sweep the window with no loop.
// - Labels (at most 4096) as 16-bit values in shared memory, rows at a pitch of 66 (33 words):
//   a row pair is read as 32-bit words and repacked by __byte_perm; a column pair is one word.
// - The mop steps keep a thread's 16 cells (8 of two rows) in registers, also two to a register;
//   the vertical neighbours come from the previous step's field in shared memory
//   (double-buffered), the horizontal ones by __byte_perm and shuffles.
// - 16-byte loads of the mask where win is a multiple of 16 and 16-byte stores of the labels
//   where it is a multiple of 4; cells beyond win are non-dark sentinels, so every run ends at
//   win.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWin = 64;
constexpr int kPitch = kMaxWin + 2;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
// The thread layouts below (a quarter row a thread for the mask load, 8 lines a warp a sweep,
// two rows a group of 8 lanes for the mop steps) cover 64 rows with 8 warps.
static_assert(kWarps == 8 && kMaxWin == 64, "the thread layouts take 8 warps and 64 rows");

// Bit k = (byte k of w != 0), k < 4.
__device__ __forceinline__ uint32_t nibble(uint32_t w) {
  return (((__vcmpne4(w, 0u) & 0x01010101u) * 0x204081u) >> 21) & 0xFu;
}

// First cell of the dark run holding cell i of a line whose dark cells are the set bits of m;
// i + 1 where cell i is not dark.
__device__ __forceinline__ int run_start(uint64_t m, int i) {
  const uint64_t z = ~m & ((2ull << i) - 1);
  return z ? 64 - __clzll((long long)z) : 0;
}

// Last cell of that run; i - 1 where cell i is not dark.
__device__ __forceinline__ int run_end(uint64_t m, int i) {
  const uint64_t z = ~m & (~0ull << i);
  return z ? __ffsll((long long)z) - 2 : kMaxWin - 1;
}

// Halfword masks of bit i of the two 16-bit fields of x: 0xFFFF where it is set.
__device__ __forceinline__ uint32_t half_mask(uint32_t x, int i) { return ((x >> i) & 0x10001u) * 0xFFFFu; }

// Bit j of the result: cells j - 1 and j of segment s (cells 8s..8s+7) are both dark, j = 0..8
// (cell -1 is the last of the previous segment, cell 8 the first of the next).
__device__ __forceinline__ uint32_t seg_links(uint64_t m, int s) {
  const uint32_t t = (uint32_t)(m >> (8 * s));  // cells 8s.. of the line
  const uint32_t prev = s > 0 ? (uint32_t)(m >> (8 * s - 1)) & 1u : 0u;
  const uint32_t ext = prev | (t & 0x1FFu) << 1;  // bit j: cell j - 1
  return ext & (ext >> 1);
}

// Number of segments before s whose last cell lies in the run of cell 8s + 7, plus one, and the
// number after s whose first cell lies in the run of cell 8s, plus one (0 and 0 when not dark).
__device__ __forceinline__ uint32_t reach_back(uint64_t m, int s) {
  return (uint32_t)((8 * s + 7 - run_start(m, 8 * s + 7)) >> 3) + 1;
}
__device__ __forceinline__ uint32_t reach_fwd(uint64_t m, int s) {
  return (uint32_t)((run_end(m, 8 * s) - 8 * s) >> 3) + 1;
}

// The masks of a lane's two lines as sweep_pair takes them, fixed for the whole schedule.
struct PairMasks {
  uint32_t links, back, fwd;  // seg_links, reach_back, reach_fwd of line A | of line B << 16
};

__device__ __forceinline__ PairMasks pair_masks(uint64_t ma, uint64_t mb, int s) {
  return {seg_links(ma, s) | seg_links(mb, s) << 16, reach_back(ma, s) | reach_back(mb, s) << 16,
          reach_fwd(ma, s) | reach_fwd(mb, s) << 16};
}

// One sweep of two lines A and B (rows if kRow, else columns) in the 16-bit halves of each
// register: every cell takes the least label of its dark run.  The lane holds cells 8s..8s+7 of
// both lines; eight lanes make a line pair, so a warp sweeps 8 lines.  Pass 1: the segment's
// carries, the min of its trailing run (forward) and of its leading run (backward).  Then a
// segmented doubling scan of the carries across the 8 lanes (3 shuffle steps each way, a step
// taking its source only where that source's end cell lies in the run).  Pass 2: the prefix and
// suffix mins again, seeded with the neighbours' carries.  nl[j] holds 0xFFFF in a line's half
// where cell j is not linked to cell j - 1: OR-ed into the value carried to cell j, it loses the
// min.  Non-dark cells are their own empty run and keep the sentinel.
template <bool kRow>
__device__ __forceinline__ void sweep_pair(uint16_t* lab, const PairMasks& pm, int line_a, int line_b, int s) {
  uint32_t l[8];
  if (kRow) {
    const uint32_t* wa = reinterpret_cast<const uint32_t*>(lab + line_a * kPitch) + 4 * s;
    const uint32_t* wb = reinterpret_cast<const uint32_t*>(lab + line_b * kPitch) + 4 * s;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t a = wa[k], b = wb[k];
      l[2 * k] = __byte_perm(a, b, 0x5410);
      l[2 * k + 1] = __byte_perm(a, b, 0x7632);
    }
  } else {  // line_b = line_a + 1, line_a even: one word holds both
    const uint32_t* w = reinterpret_cast<const uint32_t*>(lab) + line_a / 2;
#pragma unroll
    for (int i = 0; i < 8; ++i) l[i] = w[(8 * s + i) * (kPitch / 2)];
  }
  uint32_t nl[9];  // 0xFFFF where cell j is not linked to cell j - 1
#pragma unroll
  for (int j = 0; j < 9; ++j) nl[j] = ~half_mask(pm.links, j);

  uint32_t fc = l[0], gc = l[7];
#pragma unroll
  for (int i = 1; i < 8; ++i) fc = __vminu2(l[i], fc | nl[i]);
#pragma unroll
  for (int i = 6; i >= 0; --i) gc = __vminu2(l[i], gc | nl[i + 1]);

#pragma unroll
  for (int d = 1; d < 8; d <<= 1) {
    // A source beyond the line's edge is the lane's own value: min with it changes nothing.
    const uint32_t uf = __shfl_up_sync(kFull, fc, d, 8);
    const uint32_t dg = __shfl_down_sync(kFull, gc, d, 8);
    fc = __vminu2(fc, uf | ~__vcmpgtu2(pm.back, d * 0x10001u));
    gc = __vminu2(gc, dg | ~__vcmpgtu2(pm.fwd, d * 0x10001u));
  }
  const uint32_t pin = __shfl_up_sync(kFull, fc, 1, 8);    // run min up to cell 8s - 1
  const uint32_t sin = __shfl_down_sync(kFull, gc, 1, 8);  // run min from cell 8s + 8

  uint32_t f[8];
  f[0] = __vminu2(l[0], pin | nl[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) f[i] = __vminu2(l[i], f[i - 1] | nl[i]);
  uint32_t g = __vminu2(l[7], sin | nl[8]);
  l[7] = __vminu2(f[7], g);
#pragma unroll
  for (int i = 6; i >= 0; --i) {
    g = __vminu2(l[i], g | nl[i + 1]);
    l[i] = __vminu2(f[i], g);
  }

  if (kRow) {
    uint32_t* wa = reinterpret_cast<uint32_t*>(lab + line_a * kPitch) + 4 * s;
    uint32_t* wb = reinterpret_cast<uint32_t*>(lab + line_b * kPitch) + 4 * s;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wa[k] = __byte_perm(l[2 * k], l[2 * k + 1], 0x5410);
      wb[k] = __byte_perm(l[2 * k], l[2 * k + 1], 0x7632);
    }
  } else {
    uint32_t* w = reinterpret_cast<uint32_t*>(lab) + line_a / 2;
#pragma unroll
    for (int i = 0; i < 8; ++i) w[(8 * s + i) * (kPitch / 2)] = l[i];
  }
}

__global__ void __launch_bounds__(kThreads) labels_kernel(const uint8_t* __restrict__ dark_g,
                                                          int32_t* __restrict__ out, int win, int rounds,
                                                          int mop, int vec_in, int vec_out) {
  __shared__ __align__(16) uint16_t buf[2][kMaxWin * kPitch];
  __shared__ uint64_t rowm[kMaxWin];  // bit x of rowm[y]: cell (y, x) is dark; bits from win on are 0
  __shared__ uint64_t colm[kMaxWin];  // bit y of colm[x]: the same cell
  const int n = win * win;
  const int sentinel = n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint8_t* src = dark_g + (long long)blockIdx.x * n;

  if (vec_in) {  // thread = (row, 16-byte quarter); the window is 16-byte aligned
    const int y = tid >> 2, c = tid & 3;
    uint64_t bits = 0;
    if (y < win && c * 16 < win) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + y * win + c * 16);
      bits = (uint64_t)(nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8 | nibble(v.w) << 12) << (16 * c);
    }
    bits |= __shfl_xor_sync(kFull, bits, 1);
    bits |= __shfl_xor_sync(kFull, bits, 2);
    if (c == 0) rowm[y] = bits;
  } else {
    for (int y = warp; y < kMaxWin; y += kWarps) {
      const bool lo = y < win && lane < win && src[y * win + lane];
      const bool hi = y < win && lane + 32 < win && src[y * win + lane + 32];
      const uint64_t bits = __ballot_sync(kFull, lo) | (uint64_t)__ballot_sync(kFull, hi) << 32;
      if (lane == 0) rowm[y] = bits;
    }
  }
  __syncthreads();

  uint16_t* cur = buf[0];
  uint16_t* nxt = buf[1];
  {
    const uint64_t ra = rowm[lane], rb = rowm[lane + 32];
    for (int x = warp; x < kMaxWin; x += kWarps) {
      const uint32_t lo = __ballot_sync(kFull, (ra >> x) & 1), hi = __ballot_sync(kFull, (rb >> x) & 1);
      if (lane == 0) colm[x] = lo | (uint64_t)hi << 32;
    }
    // Every cell of the 64x64 field, so that cells beyond win read as non-dark sentinels.
    for (int y = warp; y < kMaxWin; y += kWarps) {
      const uint64_t m = rowm[y];
      cur[y * kPitch + lane] = (uint16_t)((m >> lane) & 1 ? y * win + lane : sentinel);
      cur[y * kPitch + lane + 32] = (uint16_t)((m >> (lane + 32)) & 1 ? y * win + lane + 32 : sentinel);
    }
  }
  __syncthreads();

  // Sweeps: warp w takes lines 8w..8w+7; lane = (line pair, 8-cell segment).  Rows pair as
  // (8w + sub, 8w + 4 + sub), columns as (8w + 2 sub, 8w + 2 sub + 1).
  const int sub = lane >> 3, seg = lane & 7;
  const bool sweeps = 8 * warp < win;
  const int ra = 8 * warp + sub, rb = ra + 4, ca = 8 * warp + 2 * sub, cb = ca + 1;
  const PairMasks rows = pair_masks(rowm[ra], rowm[rb], seg), cols = pair_masks(colm[ca], colm[cb], seg);
  for (int r = 0; r < rounds; ++r) {
    if (sweeps) sweep_pair<true>(cur, rows, ra, rb, seg);
    __syncthreads();
    if (sweeps) sweep_pair<false>(cur, cols, ca, cb, seg);
    __syncthreads();
  }

  // Mop steps: thread = (two rows 2p and 2p + 1, 8-cell segment), its 16 cells in registers as
  // pairs of 16-bit labels; up and down from the previous step's field in shared memory, left
  // and right across segments by shuffles.  Jacobi: each step writes the other buffer.
  const int p = sub + 4 * warp;  // 0..31
  const uint32_t sent2 = (uint32_t)sentinel * 0x10001u;
  uint32_t w[2][4], keep[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int y = 2 * p + h;
    const uint32_t bits = (uint32_t)(rowm[y] >> (8 * seg)) & 0xFF;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[h][k] = reinterpret_cast<const uint32_t*>(cur + y * kPitch)[4 * seg + k];
      keep[h][k] = ((bits >> (2 * k)) & 1 ? 0u : 0xFFFFu) | ((bits >> (2 * k + 1)) & 1 ? 0u : 0xFFFF0000u);
    }
  }
  for (int st = 0; st < mop; ++st) {
    const uint32_t* row = reinterpret_cast<const uint32_t*>(cur) + 4 * seg;
    uint32_t nb[2][4];  // the vertical neighbours outside the thread's two rows
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      nb[0][k] = p > 0 ? row[(2 * p - 1) * (kPitch / 2) + k] : sent2;
      nb[1][k] = 2 * p + 2 < win ? row[(2 * p + 2) * (kPitch / 2) + k] : sent2;
    }
    uint32_t v[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t from_left = __shfl_up_sync(kFull, w[h][3], 1, 8);
      const uint32_t from_right = __shfl_down_sync(kFull, w[h][0], 1, 8);
      const uint32_t left = seg > 0 ? from_left : sent2;
      const uint32_t right = seg < 7 ? from_right : sent2;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t lt = __byte_perm(k > 0 ? w[h][k - 1] : left, w[h][k], 0x5432);
        const uint32_t rt = __byte_perm(w[h][k], k < 3 ? w[h][k + 1] : right, 0x5432);
        const uint32_t vert = __vminu2(h == 0 ? nb[0][k] : w[0][k], h == 0 ? w[1][k] : nb[1][k]);
        const uint32_t mn = __vminu2(__vminu2(w[h][k], vert), __vminu2(lt, rt));
        v[h][k] = (mn & ~keep[h][k]) | (w[h][k] & keep[h][k]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w[h][k] = v[h][k];
        reinterpret_cast<uint32_t*>(nxt + (2 * p + h) * kPitch)[4 * seg + k] = v[h][k];
      }
    }
    __syncthreads();
    uint16_t* t = cur;
    cur = nxt;
    nxt = t;
  }

  int32_t* dst = out + (long long)blockIdx.x * n;
  if (vec_out) {  // thread = (row, 4 cells); win is a multiple of 4 and out 16-byte aligned
    const int q = 4 * (tid & 15);
    for (int y = tid >> 4; y < win; y += kThreads / 16) {
      if (q < win) {
        const uint16_t* c = cur + y * kPitch + q;
        *reinterpret_cast<int4*>(dst + y * win + q) = make_int4(c[0], c[1], c[2], c[3]);
      }
    }
  } else {
    for (int y = warp; y < win; y += kWarps) {
      if (lane < win) dst[y * win + lane] = cur[y * kPitch + lane];
      if (lane + 32 < win) dst[y * win + lane + 32] = cur[y * kPitch + lane + 32];
    }
  }
}

}  // namespace

// dark (K, win, win) u8 (torch.bool), out (K, win, win) i32; win <= 64.
extern "C" int labels_launch(const uint8_t* dark, int32_t* out, int k, int win, int rounds, int mop,
                             cudaStream_t stream) {
  if (win > kMaxWin || win <= 0) return (int)cudaErrorInvalidValue;
  const int vec_in = win % 16 == 0 && ((uintptr_t)dark & 15) == 0;
  const int vec_out = win % 4 == 0 && ((uintptr_t)out & 15) == 0;
  labels_kernel<<<k, kThreads, 0, stream>>>(dark, out, win, rounds, mop, vec_in, vec_out);
  return (int)cudaGetLastError();
}
