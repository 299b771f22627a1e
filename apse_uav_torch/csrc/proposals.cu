// K2: multi-scale dark-square proposal scoring on the mean-centred pooled gray.
//
// Replaces the JAX package's Pallas TPU kernel aruco/pallas_proposals.py
// _make_kernel / _run (via proposals_batched_from_pool).  Plain version:
// apse_uav_torch/aruco/detector.py _proposals_from_pool (decimate=False).
// Computed here, in four launches: the integral image; per kept scale the inner,
// mid and ring box sums, the contrast score gated by min_diff and masked to the
// scale's valid extents; the square dilation of radius r_d (separable: a row
// pass and a column pass); adjacent-scale non-max suppression and a per-block
// top-k with k_tile = k.  The global top-k over the blocks' candidates and the
// centres from off_px are done by the wrapper in PyTorch, as the reference does
// them in XLA.  A per-block top-k with k_tile = k is exact: every element of the
// global top-k (value descending, flat index ascending on ties) is in its own
// block's top-k under the same order.
//
// What bounds it on the H100: memory traffic of the per-scale maps.  The pooled
// 4K frame is 540 x 960 f32 (2 MB); each of the 10 scales writes a score map, a
// row-dilated map and a dilated map (2 MB each) and the NMS pass reads three
// dilated maps per scale, ~150 MB per frame in all, with ~80 box-sum ops and up
// to 2 x 41 max ops per cell and scale.  Design for now: simple one-thread-per-cell
// passes through global memory (L2-resident at one frame); fusing the scales and
// the dilation into shared-memory tiles, as the TPU kernel does in VMEM, is the
// optimisation to come.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kParams = 8;  // per scale: sc_in, sc_mid, sc_ring, off_in, off_mid, n_y, n_x, r_d
constexpr int kTopkThreads = 256;
constexpr int kMaxK = 16;

// Column prefix sums first, then row prefix sums, accumulated in float64 and
// rounded once to the float32 integral ii (B, H+1, W+1) with a zero first row
// and column.  The centred pool values are multiples of the mean's ulp and below
// 256 in magnitude, so these float64 sums are exact at 4K whatever their order:
// the plain version's integral_image gives the same float32 values bit for bit.
__global__ void integral_cols(const float* __restrict__ pool, double* __restrict__ acc, int h, int w) {
  const int b = blockIdx.y;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  const float* src = pool + (long long)b * h * w;
  double* dst = acc + (long long)b * h * w;
  double s = 0.0;
  for (int y = 0; y < h; ++y) {
    s += (double)src[(long long)y * w + x];
    dst[(long long)y * w + x] = s;
  }
}

__global__ void integral_rows(const double* __restrict__ acc, float* __restrict__ ii, int h, int w) {
  const int b = blockIdx.y;
  const int y = blockIdx.x * blockDim.x + threadIdx.x;
  if (y > h) return;
  float* row = ii + (long long)b * (h + 1) * (w + 1) + (long long)y * (w + 1);
  row[0] = 0.0f;
  if (y == 0) {
    for (int x = 1; x <= w; ++x) row[x] = 0.0f;
    return;
  }
  const double* src = acc + (long long)b * h * w + (long long)(y - 1) * w;
  double s = 0.0;
  for (int x = 0; x < w; ++x) {
    s += src[x];
    row[x + 1] = (float)s;
  }
}

__device__ __forceinline__ float box(const float* ii, int pitch, int oy, int ox, int sz) {
  return ii[(long long)(oy + sz) * pitch + ox + sz] - ii[(long long)(oy + sz) * pitch + ox] -
         ii[(long long)oy * pitch + ox + sz] + ii[(long long)oy * pitch + ox];
}

// score (B, S, H, W): contrast/255 where contrast >= min_diff, inside the scale's
// (n_y, n_x) valid extent; 0 elsewhere.
__global__ void scores_kernel(const float* __restrict__ ii, const int32_t* __restrict__ prm,
                              float* __restrict__ score, int h, int w, int ns, float min_diff) {
  const int b = blockIdx.z / ns, s = blockIdx.z % ns;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const int32_t* p = prm + s * kParams;
  const int sc_in = p[0], sc_mid = p[1], sc_ring = p[2], off_in = p[3], off_mid = p[4], n_y = p[5], n_x = p[6];
  float v = 0.0f;
  if (y < n_y && x < n_x) {
    const int pitch = w + 1;
    const float* iib = ii + (long long)b * (h + 1) * pitch;
    const float inner = box(iib, pitch, y + off_in, x + off_in, sc_in) / (float)(sc_in * sc_in);
    const float mid = box(iib, pitch, y + off_mid, x + off_mid, sc_mid);
    const float ring = box(iib, pitch, y, x, sc_ring);
    const float outer = (ring - mid) / ((float)(sc_ring * sc_ring) - (float)(sc_mid * sc_mid));
    const float contrast = fmaxf(outer - inner, 0.0f);
    v = contrast >= min_diff ? contrast / 255.0f : 0.0f;
  }
  score[(((long long)b * ns + s) * h + y) * w + x] = v;
}

// Max over [c - r, c + r] along rows (dir 0) or columns (dir 1), inside the map.
__global__ void dilate_kernel(const float* __restrict__ src, const int32_t* __restrict__ prm,
                              float* __restrict__ dst, int h, int w, int ns, int dir) {
  const int s = blockIdx.z % ns;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const int r = prm[s * kParams + 7];
  const float* map = src + (long long)blockIdx.z * h * w;
  float m = -INFINITY;
  if (dir == 0) {
    const int lo = max(x - r, 0), hi = min(x + r, w - 1);
    for (int i = lo; i <= hi; ++i) m = fmaxf(m, map[(long long)y * w + i]);
  } else {
    const int lo = max(y - r, 0), hi = min(y + r, h - 1);
    for (int i = lo; i <= hi; ++i) m = fmaxf(m, map[(long long)i * w + x]);
  }
  dst[(long long)blockIdx.z * h * w + (long long)y * w + x] = m;
}

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// Adjacent-scale NMS + top-k of one block of `rows` rows of one (frame, scale):
// masked = (score >= max(dil[s-1], dil[s], dil[s+1]) && score > thr) ? score : 0;
// out_val/out_idx (B, S, n_blocks, k): the block's k best (value desc, flat
// index asc), taken one at a time by a block-wide arg-max.
__global__ void nms_topk_kernel(const float* __restrict__ score, const float* __restrict__ dil,
                                float* __restrict__ out_val, int32_t* __restrict__ out_idx,
                                int h, int w, int ns, int rows, int k, float thr) {
  extern __shared__ float vals[];
  __shared__ float red_v[kTopkThreads / 32];
  __shared__ int red_i[kTopkThreads / 32];
  const int bs = blockIdx.y;  // b * ns + s
  const int s = bs % ns;
  const int y0 = blockIdx.x * rows;
  const int n_rows = min(rows, h - y0);
  const int n = n_rows * w;
  const long long plane = (long long)h * w;
  const float* sc = score + bs * plane + (long long)y0 * w;
  const float* dl = dil + bs * plane + (long long)y0 * w;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = sc[i];
    float cross = dl[i];
    if (s > 0) cross = fmaxf(cross, dl[i - plane]);
    if (s + 1 < ns) cross = fmaxf(cross, dl[i + plane]);
    vals[i] = (v >= cross && v > thr) ? v : 0.0f;
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long obase = ((long long)bs * gridDim.x + blockIdx.x) * k;
  for (int t = 0; t < k; ++t) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      if (better(vals[i], i, bv, bi)) { bv = vals[i]; bi = i; }
    }
    for (int off = 16; off > 0; off /= 2) {
      const float ov = __shfl_down_sync(0xffffffff, bv, off);
      const int oi = __shfl_down_sync(0xffffffff, bi, off);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { red_v[warp] = bv; red_i[warp] = bi; }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int j = 1; j < (int)(blockDim.x / 32); ++j) {
        if (better(red_v[j], red_i[j], bv, bi)) { bv = red_v[j]; bi = red_i[j]; }
      }
      const bool found = bi < n && bv != -INFINITY;
      out_val[obase + t] = found ? bv : -1.0f;
      out_idx[obase + t] = found ? y0 * w + bi : 0x7fffffff;
      if (found) vals[bi] = -INFINITY;  // taken
    }
    __syncthreads();
  }
}

}  // namespace

// pool (B, H, W) f32 mean-centred; prm (S, 8) i32 on the device; scratch: acc
// (B, H, W) f64, ii (B, H+1, W+1) f32, score / tmp / dil (B, S, H, W) f32; out_val / out_idx
// (B, S, ceil(H / rows), k).  Returns the first launch error.
extern "C" int proposals_launch(const float* pool, const int32_t* prm, double* acc, float* ii, float* score,
                                float* tmp, float* dil, float* out_val, int32_t* out_idx, int batch, int h, int w, int ns,
                                int rows, int k, float min_diff, float thr, cudaStream_t stream) {
  if (k > kMaxK || rows <= 0) return (int)cudaErrorInvalidValue;
  integral_cols<<<dim3((w + 127) / 128, batch), 128, 0, stream>>>(pool, acc, h, w);
  integral_rows<<<dim3((h + 1 + 127) / 128, batch), 128, 0, stream>>>(acc, ii, h, w);
  const dim3 grid_map((w + 127) / 128, h, batch * ns);
  scores_kernel<<<grid_map, 128, 0, stream>>>(ii, prm, score, h, w, ns, min_diff);
  dilate_kernel<<<grid_map, 128, 0, stream>>>(score, prm, tmp, h, w, ns, 0);
  dilate_kernel<<<grid_map, 128, 0, stream>>>(tmp, prm, dil, h, w, ns, 1);
  const size_t smem = (size_t)rows * w * sizeof(float);
  nms_topk_kernel<<<dim3((h + rows - 1) / rows, batch * ns), kTopkThreads, smem, stream>>>(
      score, dil, out_val, out_idx, h, w, ns, rows, k, thr);
  return (int)cudaGetLastError();
}
