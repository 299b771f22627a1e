// K2: multi-scale dark-square proposal scoring on the mean-centred pooled gray.
//
// Replaces the JAX package's Pallas TPU kernel aruco/pallas_proposals.py
// _make_kernel / _run (via proposals_batched_from_pool).  Plain version:
// apse_uav_torch/aruco/detector.py _proposals_from_pool (decimate=False); the plain
// versions of the two last launches are cuda_proposals.tile_topk_plain and
// cuda_proposals.select_plain.
//
// Five launches:
//   integral_rows, integral_cols  the global integral image, summed in float64 and
//       rounded once to float32.  The centred pool values are multiples of the mean's
//       ulp and below 256 in magnitude, so the float64 sums are exact at 4K whatever
//       their order, and the plain version's integral_image gives the same float32
//       values bit for bit.  Rows: one block per (row, frame), warp scans over chunks
//       of the row (coalesced).  Columns: a block per 32 columns and frame, 16 row
//       segments scanned in parallel, then their offsets.
//   flags_kernel  per (tile, frame, scale) whether the tile's core has a candidate: a
//       score above the threshold, the only kind that survives the NMS.
//   tiles_kernel  one block per (32 x 64 tile of the pooled grid, frame) does all the
//       scales, rolling over the ladder the way the TPU kernel does in VMEM: per scale
//       the score on the tile plus a halo of that scale's dilation radius (four point
//       reads per box from the integral image, which stays in L2), the separable
//       square dilation in shared memory, and the tile's core of the score and of the
//       dilated map kept in registers, three dilated scales at a time for the
//       adjacent-scale non-max suppression.  It writes the tile's k best (value
//       descending, flat frame index ascending) per scale and nothing else: no score
//       or dilation map goes through device memory.  Score region, dilation and
//       top-k run only where the tile has a candidate at the scale or a neighbour;
//       elsewhere the tile's k best are its first k cells at 0, exactly.
//   select_kernel  one block per (scale, frame): the global top-k over the tiles'
//       candidates in the same order, then the proposal tuple (centres from off_px
//       and unit, sizes, scores, valid) straight into the outputs.
// A per-tile top-k with k_tile = k is exact: every element of the global top-k
// (value descending, flat index ascending on ties) is in its own tile's top-k
// under the same order.
//
// What bounds it on the H100: operations, not bytes.  The pool is 2 MB a frame at
// 4K, the candidates a few KB; the work is ~12 integral reads and ~20 FP32 ops per
// score cell, up to 2 (2 r + 1) max ops per cell for the dilation and the NMS and
// top-k compares.  Where a tile has candidates, its halo adds ~80 % to the score
// work at 32 x 64 tiles (radii 1..20 cells).  On 8 rendered 4K frames the five
// kernels take ~0.46 ms, ~14x that bound: the flags pass (twelve integral reads
// per cell and scale over every tile) and the candidate tiles share it about evenly.
// The top-k is register and warp level: each warp takes its k best by shuffles,
// one warp merges the block's.  All arithmetic follows the plain version op by op
// (-fmad=false, IEEE divisions), so the scores are bit-identical to it.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kParams = 8;   // per scale: sc_in, sc_mid, sc_ring, off_in, off_mid, n_y, n_x, r_d
constexpr int kFParams = 3;  // per scale, float: off_px, unit, size
constexpr int kMaxK = 16;
constexpr int kTileH = 32, kTileW = 64, kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowStep = kThreads / kTileW;          // a thread's core cells are kRowStep rows apart
constexpr int kCells = kTileH * kTileW / kThreads;   // core cells per thread
constexpr int kSegments = 16;                        // row segments of the column scan
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- integral image

// acc (B, H, W) f64: prefix sums of each pool row.
__global__ void __launch_bounds__(kThreads) integral_rows(const float* __restrict__ pool, double* __restrict__ acc,
                                                          int h, int w) {
  __shared__ double warp_sum[kWarps];
  const long long row = (long long)blockIdx.y * h + blockIdx.x;
  const float* src = pool + row * w;
  double* dst = acc + row * w;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  double carry = 0.0;
  for (int x0 = 0; x0 < w; x0 += kThreads) {
    const int x = x0 + threadIdx.x;
    double v = x < w ? (double)src[x] : 0.0;
    for (int off = 1; off < 32; off *= 2) {
      const double n = __shfl_up_sync(kFull, v, off);
      if (lane >= off) v += n;
    }
    if (lane == 31) warp_sum[warp] = v;
    __syncthreads();
    double before = carry, total = carry;
    for (int j = 0; j < kWarps; ++j) {
      if (j < warp) before += warp_sum[j];
      total += warp_sum[j];
    }
    if (x < w) dst[x] = before + v;
    carry = total;
    __syncthreads();  // warp_sum is rewritten by the next chunk
  }
}

// ii (B, H+1, W+1) f32 with a zero first row and column: column prefix sums of acc.
// Block (32 columns, kSegments row segments) of one frame.
__global__ void integral_cols(const double* __restrict__ acc, float* __restrict__ ii, int h, int w) {
  __shared__ double seg_sum[kSegments][32];
  const int b = blockIdx.y;
  const int x = blockIdx.x * 32 + threadIdx.x;
  const int seg = threadIdx.y;
  const int len = (h + kSegments - 1) / kSegments;
  const int y0 = seg * len, y1 = min(h, y0 + len);
  const double* src = acc + (long long)b * h * w;
  float* dst = ii + (long long)b * (h + 1) * (w + 1);
  double s = 0.0;
  if (x < w) {
    for (int y = y0; y < y1; ++y) s += src[(long long)y * w + x];
  }
  seg_sum[seg][threadIdx.x] = s;
  __syncthreads();
  if (x >= w) return;
  s = 0.0;
  for (int j = 0; j < seg; ++j) s += seg_sum[j][threadIdx.x];
  for (int y = y0; y < y1; ++y) {
    s += src[(long long)y * w + x];
    dst[(long long)(y + 1) * (w + 1) + x + 1] = (float)s;
  }
  if (seg == 0) dst[x + 1] = 0.0f;
  if (x == 0) {
    for (int y = y0; y < y1; ++y) dst[(long long)(y + 1) * (w + 1)] = 0.0f;
    if (seg == 0) dst[0] = 0.0f;
  }
}

// ---------------------------------------------------------------- top-k

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// The warp's best (value, index) in every lane.
__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int off = 16; off > 0; off /= 2) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// The k best of the entries get(0..n) of every lane of the warp, in order, into
// out_v / out_i (written by lane 0).  Each round takes the best entry that comes
// strictly after the previous pick in the (value desc, index asc) order, so no
// entry is marked taken.  Missing entries are (-inf, INT_MAX).
template <class Get>
__device__ __forceinline__ void warp_topk(int n, Get get, int k, float* out_v, int* out_i) {
  float lv = INFINITY;
  int li = -1;
  for (int t = 0; t < k; ++t) {
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < n; ++j) {
      float v;
      int i;
      get(j, v, i);
      if (better(lv, li, v, i) && better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    warp_best(bv, bi);
    if (threadIdx.x % 32 == 0) {
      out_v[t] = bv;
      out_i[t] = bi;
    }
    lv = bv;
    li = bi;
  }
}

// The block's k best of the entries get(0..n) of every thread: each warp's k best
// into wv / wi (kWarps * k), then warp 0 merges them into top_v / top_i (k).  Ends
// with the block synchronised and top_v / top_i readable by every thread.
template <class Get>
__device__ __forceinline__ void block_topk(int n, Get get, int k, float* wv, int* wi, float* top_v, int* top_i) {
  const int warp = threadIdx.x / 32;
  warp_topk(n, get, k, wv + warp * k, wi + warp * k);
  __syncthreads();
  if (warp == 0) {
    const int lane = threadIdx.x % 32;
    const int m = kWarps * k;
    warp_topk(
        (m + 31) / 32,
        [&](int j, float& v, int& i) {
          const int e = lane + 32 * j;
          v = e < m ? wv[e] : -INFINITY;
          i = e < m ? wi[e] : INT_MAX;
        },
        k, top_v, top_i);
  }
  __syncthreads();
}

// ---------------------------------------------------------------- fused tiles

// The box sum of the integral image whose top-left corner is at q, dy = side * pitch
// and dx = side: ((q[dy + dx] - q[dy]) - q[dx]) + q[0], the plain version's order.
__device__ __forceinline__ float box(const float* __restrict__ q, int dy, int dx) {
  return __ldg(q + dy + dx) - __ldg(q + dy) - __ldg(q + dx) + __ldg(q);
}

// One scale of the ladder, with the integral-image offsets of its inner and mid boxes.
struct Scale {
  int sc_in, sc_mid, sc_ring, o_in, o_mid, n_y, n_x, r;
  float in_area, ring_area;
};

__device__ __forceinline__ Scale load_scale(const int32_t* __restrict__ prm, int s, int pitch) {
  const int32_t* p = prm + s * kParams;
  Scale c;
  c.sc_in = p[0];
  c.sc_mid = p[1];
  c.sc_ring = p[2];
  c.o_in = p[3] * pitch + p[3];
  c.o_mid = p[4] * pitch + p[4];
  c.n_y = p[5];
  c.n_x = p[6];
  c.r = p[7];
  c.in_area = (float)(c.sc_in * c.sc_in);
  c.ring_area = (float)(c.sc_ring * c.sc_ring) - (float)(c.sc_mid * c.sc_mid);
  return c;
}

// The score of pooled cell (gy, gx) at scale c: -inf outside the map (ignored by the
// dilation), 0 outside the scale's (n_y, n_x) extent or below min_diff, else
// contrast / 255, in the plain version's order of operations.
__device__ __forceinline__ float cell_score(const float* __restrict__ iib, int pitch, int h, int w, int gy, int gx,
                                            const Scale& c, float min_diff) {
  if (gy < 0 || gy >= h || gx < 0 || gx >= w) return -INFINITY;
  if (gy >= c.n_y || gx >= c.n_x) return 0.0f;
  const float* q = iib + (long long)gy * pitch + gx;
  const float inner = box(q + c.o_in, c.sc_in * pitch, c.sc_in) / c.in_area;
  const float mid = box(q + c.o_mid, c.sc_mid * pitch, c.sc_mid);
  const float ring = box(q, c.sc_ring * pitch, c.sc_ring);
  const float outer = (ring - mid) / c.ring_area;
  const float contrast = fmaxf(outer - inner, 0.0f);
  return contrast >= min_diff ? contrast / 255.0f : 0.0f;
}

// flags (B, S, n_tiles) u8: whether any core cell of the tile scores above thr at the
// scale (a candidate).  One block per (tile, frame), a thread per kCells core cells;
// no shared memory beyond the barrier, so many blocks hide the integral reads' latency.
__global__ void __launch_bounds__(kThreads) flags_kernel(const float* __restrict__ ii, const int32_t* __restrict__ prm,
                                                         uint8_t* __restrict__ flags, int h, int w, int ns,
                                                         float min_diff, float thr) {
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * kTileH, tx0 = blockIdx.x * kTileW;
  const int n_tiles = gridDim.x * gridDim.y, tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int pitch = w + 1;
  const float* iib = ii + (long long)b * (h + 1) * pitch;
  const int cx = threadIdx.x % kTileW, cy0 = threadIdx.x / kTileW;
  for (int s = 0; s < ns; ++s) {
    const Scale c = load_scale(prm, s, pitch);
    bool any = false;
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      any |= cell_score(iib, pitch, h, w, ty0 + cy0 + j * kRowStep, tx0 + cx, c, min_diff) > thr;
    }
    any = __syncthreads_or(any);
    if (threadIdx.x == 0) flags[((long long)b * ns + s) * n_tiles + tile] = any;
  }
}

// tile_val / tile_idx (B, S, n_tiles, k): per (frame, scale, tile) the k best masked
// scores and their flat frame indices y * w + x.  masked = score where score >=
// max(dil[s-1], dil[s], dil[s+1]) and score > thr, else 0; the dilation ignores cells
// outside the map.  A thread owns the core cells (cy0 + j * kRowStep, cx) and keeps
// their scores and dilations in registers.  Scale s's masked scores are all 0 unless
// the tile has a candidate there (flags), so the block scores the region and dilates
// scale s only when s - 1, s or s + 1 has one, and a tile without a candidate at s
// writes its first k cells with 0, which is what the full top-k gives there.
// Dynamic shared memory: the score region (TH + 2r) x (TW + 2r) and the row-dilated
// region (TH + 2r) x TW at radius r_max.
__global__ void __launch_bounds__(kThreads, 3)
    tiles_kernel(const float* __restrict__ ii, const int32_t* __restrict__ prm, const uint8_t* __restrict__ flags,
                 float* __restrict__ tile_val, int32_t* __restrict__ tile_idx, int h, int w, int ns, int k, int r_max,
                 float min_diff, float thr) {
  extern __shared__ float smem[];
  __shared__ float wv[kWarps * kMaxK], top_v[kMaxK];
  __shared__ int wi[kWarps * kMaxK], top_i[kMaxK];
  float* region = smem;
  float* rowmax = smem + (kTileH + 2 * r_max) * (kTileW + 2 * r_max);
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * kTileH, tx0 = blockIdx.x * kTileW;
  const int n_tiles = gridDim.x * gridDim.y, tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int pitch = w + 1;
  const float* iib = ii + (long long)b * (h + 1) * pitch;
  const int cx = threadIdx.x % kTileW, cy0 = threadIdx.x / kTileW;
  auto candidate = [&](int s) { return s >= 0 && s < ns && flags[((long long)b * ns + s) * n_tiles + tile] != 0; };
  // Per owned core cell: the max of the two previous scales' dilations, the previous
  // scale's dilation and score.
  float m_prev[kCells], d_prev[kCells], s_prev[kCells];
#pragma unroll
  for (int j = 0; j < kCells; ++j) m_prev[j] = d_prev[j] = s_prev[j] = -INFINITY;
  for (int s = 0; s <= ns; ++s) {
    float d[kCells], sc[kCells];
#pragma unroll
    for (int j = 0; j < kCells; ++j) d[j] = sc[j] = -INFINITY;
    if (s < ns && (candidate(s - 1) || candidate(s) || candidate(s + 1))) {  // dil[s] is read by some NMS
      const Scale c = load_scale(prm, s, pitch);
      const int r = c.r, rh = kTileH + 2 * r, rw = kTileW + 2 * r;
      __syncthreads();  // the previous scale's region and rowmax are no longer read
      // Region cell e = (ry, rx), stepped without a division per cell.
      int ry = threadIdx.x / rw, rx = threadIdx.x % rw;
      const int step_y = kThreads / rw, step_x = kThreads % rw;
      for (int e = threadIdx.x; e < rh * rw; e += kThreads) {
        region[e] = cell_score(iib, pitch, h, w, ty0 - r + ry, tx0 - r + rx, c, min_diff);
        rx += step_x;
        ry += step_y;
        if (rx >= rw) {
          rx -= rw;
          ++ry;
        }
      }
      __syncthreads();
      for (int e = threadIdx.x; e < rh * kTileW; e += kThreads) {
        const float* row = region + (e / kTileW) * rw + e % kTileW;  // core column x: region columns x .. x + 2r
        float m = -INFINITY;
        for (int t = 0; t <= 2 * r; ++t) m = fmaxf(m, row[t]);
        rowmax[e] = m;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kCells; ++j) {
        const int cy = cy0 + j * kRowStep;
        float m = -INFINITY;
        for (int t = 0; t <= 2 * r; ++t) m = fmaxf(m, rowmax[(cy + t) * kTileW + cx]);
        d[j] = m;
        sc[j] = region[(cy + r) * rw + cx + r];
      }
    }
    if (s > 0) {  // NMS and top-k of scale s - 1: its cross max is max(m_prev, d)
      const long long o = (((long long)b * ns + s - 1) * n_tiles + tile) * k;
      if (candidate(s - 1)) {
#pragma unroll
        for (int j = 0; j < kCells; ++j) {  // s_prev becomes the masked score, -inf outside the map
          const float cross = fmaxf(m_prev[j], d[j]);
          s_prev[j] = s_prev[j] == -INFINITY ? -INFINITY : (s_prev[j] >= cross && s_prev[j] > thr) ? s_prev[j] : 0.0f;
        }
        block_topk(
            kCells,
            [&](int j, float& v, int& i) {
              v = s_prev[j];
              i = v == -INFINITY ? INT_MAX : (ty0 + cy0 + j * kRowStep) * w + tx0 + cx;
            },
            k, wv, wi, top_v, top_i);
        if (threadIdx.x < k) {
          tile_val[o + threadIdx.x] = top_v[threadIdx.x];
          tile_idx[o + threadIdx.x] = top_i[threadIdx.x];
        }
      } else if (threadIdx.x < k) {  // every masked score is 0: the first k cells in the map
        const int t = threadIdx.x, n_cols = min(kTileW, w - tx0), n_cells = n_cols * min(kTileH, h - ty0);
        tile_val[o + t] = t < n_cells ? 0.0f : -INFINITY;
        tile_idx[o + t] = t < n_cells ? (ty0 + t / n_cols) * w + tx0 + t % n_cols : INT_MAX;
      }
    }
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      m_prev[j] = fmaxf(d_prev[j], d[j]);
      d_prev[j] = d[j];
      s_prev[j] = sc[j];
    }
  }
}

// ---------------------------------------------------------------- global top-k

// Per (scale s, frame b): the k best of the n_cand tile candidates, then the
// proposal slots s * k + t of frame b: centers (B, K, 2) yx = (y, x) * unit + off_px,
// sizes, scores (the value; -1 where fewer than k cells exist), valid = score > thr.
__global__ void __launch_bounds__(kThreads) select_kernel(const float* __restrict__ tile_val,
                                                          const int32_t* __restrict__ tile_idx,
                                                          const float* __restrict__ fprm, float* __restrict__ centers,
                                                          float* __restrict__ sizes, float* __restrict__ scores,
                                                          uint8_t* __restrict__ valid, int w, int ns, int n_cand, int k,
                                                          float thr) {
  __shared__ float wv[kWarps * kMaxK], top_v[kMaxK];
  __shared__ int wi[kWarps * kMaxK], top_i[kMaxK];
  const int s = blockIdx.x, b = blockIdx.y;
  const float* cv = tile_val + ((long long)b * ns + s) * n_cand;
  const int32_t* ci = tile_idx + ((long long)b * ns + s) * n_cand;
  block_topk(
      (n_cand + kThreads - 1) / kThreads,
      [&](int j, float& v, int& i) {
        const int e = threadIdx.x + j * kThreads;
        v = e < n_cand ? cv[e] : -INFINITY;
        i = e < n_cand ? ci[e] : INT_MAX;
      },
      k, wv, wi, top_v, top_i);
  if (threadIdx.x >= k) return;
  const float v = top_v[threadIdx.x];
  const bool found = v != -INFINITY;
  const int idx = found ? top_i[threadIdx.x] : 0;
  const float off = fprm[s * kFParams], unit = fprm[s * kFParams + 1];
  const long long slot = (long long)b * ns * k + s * k + threadIdx.x;
  const float score = found ? v : -1.0f;
  centers[2 * slot] = (float)(idx / w) * unit + off;
  centers[2 * slot + 1] = (float)(idx % w) * unit + off;
  sizes[slot] = fprm[s * kFParams + 2];
  scores[slot] = score;
  valid[slot] = score > thr;
}

}  // namespace

// pool (B, H, W) f32 mean-centred; prm (S, 8) i32 and fprm (S, 3) f32 on the device;
// scratch: acc (B, H, W) f64, ii (B, H+1, W+1) f32, flags (B, S, n_tiles) u8, tile_val /
// tile_idx (B, S, n_tiles * k) for the (tile_h, tile_w) tile grid; outputs centers (B, S*k, 2),
// sizes, scores (B, S*k) f32, valid (B, S*k) bool.  Returns the first launch error.
extern "C" int proposals_launch(const float* pool, const int32_t* prm, const float* fprm, double* acc, float* ii,
                                uint8_t* flags, float* tile_val, int32_t* tile_idx, float* centers, float* sizes,
                                float* scores, uint8_t* valid, int batch, int h, int w, int ns, int k, int r_max,
                                int tile_h, int tile_w, float min_diff, float thr, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || tile_h != kTileH || tile_w != kTileW || r_max < 0) return (int)cudaErrorInvalidValue;
  integral_rows<<<dim3(h, batch), kThreads, 0, stream>>>(pool, acc, h, w);
  integral_cols<<<dim3((w + 31) / 32, batch), dim3(32, kSegments), 0, stream>>>(acc, ii, h, w);
  const size_t smem = sizeof(float) * (size_t)(kTileH + 2 * r_max) * (2 * kTileW + 2 * r_max);
  // Above the default 48 KB (static shared memory included) the kernel must opt in.
  if (smem > 48 * 1024 - sizeof(float) * 2 * (kWarps + 1) * kMaxK) {
    const cudaError_t err =
        cudaFuncSetAttribute(tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 tiles((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, batch);
  flags_kernel<<<tiles, kThreads, 0, stream>>>(ii, prm, flags, h, w, ns, min_diff, thr);
  tiles_kernel<<<tiles, kThreads, smem, stream>>>(ii, prm, flags, tile_val, tile_idx, h, w, ns, k, r_max, min_diff,
                                                  thr);
  select_kernel<<<dim3(ns, batch), kThreads, 0, stream>>>(tile_val, tile_idx, fprm, centers, sizes, scores, valid, w,
                                                           ns, (int)(tiles.x * tiles.y) * k, k, thr);
  return (int)cudaGetLastError();
}
