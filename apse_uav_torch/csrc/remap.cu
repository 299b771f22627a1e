// K3 + K4: fused undistort (bilinear remap) + LAB gamma + BGR2GRAY, u8 gray out, and
// K3's RGB mode, which also writes the three gamma-corrected channels.
//
// Replaces the JAX package's Pallas TPU kernel preproc/pallas_remap.py
// _make_kernel, in both of its grid modes:
//   K3  _fused_preproc_packed_impl (full grid; the two-pass front runs it on the
//       4x-pooled plan, (B, 3, 544, 1024) at 4K, the single-pass front on the full
//       frame).  With want_rgb it also writes the undistorted, gamma-corrected
//       (B, 3, H, W) u8 image: remap_rgb_gray_launch, which Preprocessor runs;
//   K4  _fused_preproc_selected (t_sel > 0: only the tile ids in sel (B, T_sel) of
//       the full-res tile grid; -1 entries do nothing, unselected tiles are left
//       unwritten).
// Every grid runs the same per-pixel device functions, so K4's tiles are
// bit-identical to K3's full-frame output for the same frame and map, and the RGB
// mode's gray is K3's gray.
//
// Plain versions: apse_uav_torch/preproc/remap.py remap_gray_u8, remap_rgb_gray_u8
// and, for the colour table, lab_gamma_table.  The source position of every output
// pixel comes in as the port's own float32 undistort_rectify_map tensor (Ho, Wo, 2),
// so kernel and plain version sample at the same coordinates.  The arithmetic follows
// the plain version op by op: built with -fmad=false (no a*b+c contraction), IEEE
// division by constants, rintf (round half to even, like torch.round), powf as
// PyTorch's CUDA pow.
//
// The design.  After the bilinear blend and its rounding to u8, the rest of the
// chain (LAB, gamma on L, back to RGB, gray) is a pure function of three bytes and
// gamma: lab_gamma_u8.  table_kernel evaluates it once on all 2^24 colours, in this
// translation unit and under the same flags, so every entry is the bit pattern the
// per-pixel chain gives.  The gray table is 16 MB of u8 and stays in the 50 MB L2;
// the RGB mode reads a 64 MB u32 table (B, G, R, gray), which beat the chain per
// pixel on rendered and on uniform random frames.  Per output pixel the remap then
// does one 8-byte map read, 12 u8 taps per frame, the blend, one table gather and 1
// (or 4) byte stores.  A K3 block
// owns a band of one output tile and loops over the frames of the batch, so each
// map entry is read from device memory once per batch, not once per frame; K4's
// frames select different tiles, so its grid puts the B frames of one slot next to
// each other and lets L2 share the map between them.  Both grids cut tiles into row
// bands: K3's blocks take one pixel a thread in every frame, K4's eight pixels a
// thread in one frame.
//
// What bounds it on the H100: memory.  At 4K a batch of 8 frames moves 199 MB of
// source, 66 MB of map and 66 MB of gray (~0.1 ms at 3.35 TB/s); the blend is ~40
// FP32 ops per pixel and frame.  The table gathers are L2 hits when the frames hold
// few colours and miss L1 when they hold many (uniform random frames).  The kernel
// runs at ~4.5x that bound: 13 one-byte loads per pixel and frame, each its own
// warp-wide load; streaming cache hints on map and stores, and unrolling the frame
// loop, did not make it faster.
//
// In the RGB mode, source and RGB output are addressed through (batch, channel, row,
// column) element strides, so one kernel reads the planar frames of the ArUco path and
// the HWC frames of Preprocessor (and writes the RGB image in either layout) with no
// transpose copy.  The gray-only launches address planar frames.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kColours = 1 << 24;
constexpr int kThreads = 256;

struct Strides {  // element strides of a (B, C, H, W) u8 view
  long long b, c, r, x;
};

__device__ __forceinline__ float srgb_to_linear(float u) {
  return u <= 0.04045f ? u / 12.92f : powf((u + 0.055f) / 1.055f, 2.4f);
}

__device__ __forceinline__ float linear_to_srgb(float u) {
  u = fmaxf(u, 0.0f);
  return u <= 0.0031308f ? u * 12.92f : 1.055f * powf(u, (float)(1.0 / 2.4)) - 0.055f;
}

__device__ __forceinline__ float f_cbrt(float t) {
  return t > 0.008856f ? powf(fabsf(t), (float)(1.0 / 3.0)) : 7.787f * t + (float)(16.0 / 116.0);
}

__device__ __forceinline__ float f_inv(float ft) {
  return ft > 0.2068966f ? ft * ft * ft : (ft - (float)(16.0 / 116.0)) / 7.787f;
}

__device__ __forceinline__ float clamp255(float v) { return fminf(fmaxf(v, 0.0f), 255.0f); }

// LAB gamma of one stored-order colour (c0, c1, c2 in 0..255): the gamma-corrected
// channels o[0..2] and the gray.
__device__ __forceinline__ uint8_t lab_gamma_u8(int c0, int c1, int c2, float gamma, int o[3]) {
  // RGB2LAB on the stored channel order (colorspace.rgb_to_lab_u8).
  const float l0 = srgb_to_linear((float)c0 / 255.0f);
  const float l1 = srgb_to_linear((float)c1 / 255.0f);
  const float l2 = srgb_to_linear((float)c2 / 255.0f);
  const float x = 0.412453f * l0 + 0.357580f * l1 + 0.180423f * l2;
  const float y = 0.212671f * l0 + 0.715160f * l1 + 0.072169f * l2;
  const float z = 0.019334f * l0 + 0.119193f * l1 + 0.950227f * l2;
  const float fx = f_cbrt(x / 0.950456f);
  const float fy = f_cbrt(y);
  const float fz = f_cbrt(z / 1.088754f);
  const float big_l = y > 0.008856f ? 116.0f * fy - 16.0f : 903.3f * y;
  const float l_u8 = clamp255(rintf(big_l * (float)(255.0 / 100.0)));
  const float a_u8 = clamp255(rintf(500.0f * (fx - fy) + 128.0f));
  const float b_u8 = clamp255(rintf(200.0f * (fy - fz) + 128.0f));
  // Gamma LUT on L (colorspace.gamma_l_channel): floor((L/255)^gamma * 255).
  const float lf = l_u8 / 255.0f;
  const float lg = floorf(clamp255((gamma == 2.0f ? lf * lf : powf(lf, gamma)) * 255.0f));
  // LAB2RGB (colorspace.lab_to_rgb_u8).
  const float ll = lg * (float)(100.0 / 255.0);
  const float aa = a_u8 - 128.0f, bb = b_u8 - 128.0f;
  const float fy2 = (ll + 16.0f) / 116.0f;
  const float fx2 = fy2 + aa / 500.0f;
  const float fz2 = fy2 - bb / 200.0f;
  const float x2 = f_inv(fx2) * 0.950456f;
  const float y2 = ll > 8.0f ? fy2 * fy2 * fy2 : ll / 903.3f;
  const float z2 = f_inv(fz2) * 1.088754f;
  // jnp.linalg.inv of the float32 RGB2XYZ matrix (colorspace.XYZ2RGB).
  const float r = 3.24048113822937f * x2 + -1.5371514558792114f * y2 + -0.4985363185405731f * z2;
  const float g = -0.9692547917366028f * x2 + 1.8759899139404297f * y2 + 0.041555918753147125f * z2;
  const float b = 0.0556466206908226f * x2 + -0.20404131710529327f * y2 + 1.0573110580444336f * z2;
  o[0] = (int)clamp255(rintf(linear_to_srgb(r) * 255.0f));
  o[1] = (int)clamp255(rintf(linear_to_srgb(g) * 255.0f));
  o[2] = (int)clamp255(rintf(linear_to_srgb(b) * 255.0f));
  // BGR2GRAY on stored order (o[0] = B, o[1] = G, o[2] = R), cv2 fixed point.
  const int gray = (4899 * o[2] + 9617 * o[1] + 1868 * o[0] + (1 << 13)) >> 14;
  return (uint8_t)min(max(gray, 0), 255);
}

// gray[i] and, if bgrg is not null, bgrg[i] = B | G << 8 | R << 16 | gray << 24 of the
// colour i = c0 << 16 | c1 << 8 | c2, for every i < 2^24.
__global__ void table_kernel(uint8_t* __restrict__ gray, uint32_t* __restrict__ bgrg, float gamma) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kColours) return;
  int o[3];
  const uint8_t g = lab_gamma_u8(i >> 16, (i >> 8) & 255, i & 255, gamma, o);
  if (gray != nullptr) gray[i] = g;
  if (bgrg != nullptr) bgrg[i] = (uint32_t)o[0] | (uint32_t)o[1] << 8 | (uint32_t)o[2] << 16 | (uint32_t)g << 24;
}

// The four source taps of one output pixel: their offsets in a channel plane, which
// of them lie inside the source (cv2's BORDER_CONSTANT 0 outside), and the weights.
struct Taps {
  long long o00, o01, o10, o11;
  bool v00, v01, v10, v11;
  float wx, wy;
};

__device__ __forceinline__ Taps make_taps(float mx, float my, int h, int w, long long s_r, long long s_x) {
  const float x0 = floorf(mx), y0 = floorf(my);
  const float x1 = x0 + 1.0f, y1 = y0 + 1.0f;
  const bool vy0 = y0 >= 0.0f && y0 <= (float)(h - 1), vy1 = y1 >= 0.0f && y1 <= (float)(h - 1);
  const bool vx0 = x0 >= 0.0f && x0 <= (float)(w - 1), vx1 = x1 >= 0.0f && x1 <= (float)(w - 1);
  Taps t;
  t.wx = mx - x0;
  t.wy = my - y0;
  t.v00 = vy0 && vx0;
  t.v01 = vy0 && vx1;
  t.v10 = vy1 && vx0;
  t.v11 = vy1 && vx1;
  t.o00 = t.v00 ? (long long)y0 * s_r + (long long)x0 * s_x : 0;
  t.o01 = t.v01 ? (long long)y0 * s_r + (long long)x1 * s_x : 0;
  t.o10 = t.v10 ? (long long)y1 * s_r + (long long)x0 * s_x : 0;
  t.o11 = t.v11 ? (long long)y1 * s_r + (long long)x1 * s_x : 0;
  return t;
}

// The bilinear blend of one channel plane, rounded to u8 (bilinear_remap_u8).
__device__ __forceinline__ int blend(const uint8_t* __restrict__ p, const Taps& t) {
  const float p00 = t.v00 ? (float)__ldg(p + t.o00) : 0.0f;
  const float p01 = t.v01 ? (float)__ldg(p + t.o01) : 0.0f;
  const float p10 = t.v10 ? (float)__ldg(p + t.o10) : 0.0f;
  const float p11 = t.v11 ? (float)__ldg(p + t.o11) : 0.0f;
  const float top = p00 * (1.0f - t.wx) + p01 * t.wx;
  const float bot = p10 * (1.0f - t.wx) + p11 * t.wx;
  return (int)clamp255(rintf(top * (1.0f - t.wy) + bot * t.wy));
}

// gray (B, Ho, Wo) u8; in the RGB mode also rgb, addressed by rs, and src by ss (gray
// may be null there).  Block (blockIdx.x, blockIdx.y) covers rows [blockIdx.y * rows,
// + rows) of one (th, tw) output tile: with t_sel == 0 tile blockIdx.x for every frame
// of the batch (K3); else slot blockIdx.x / batch of frame blockIdx.x % batch, whose
// tile id is sel[frame, slot] (K4: the blocks of one slot run together and share its
// map in L2 when the frames select the same tile).  gray_lut is the 2^24 gray table
// (gray only), bgrg_lut the packed one (RGB).
template <bool RGB>
__global__ void __launch_bounds__(kThreads) remap_kernel(
    const uint8_t* __restrict__ src, Strides ss, const float* __restrict__ map,
    const uint8_t* __restrict__ gray_lut, const uint32_t* __restrict__ bgrg_lut, uint8_t* __restrict__ gray,
    uint8_t* __restrict__ rgb, Strides rs, const int32_t* __restrict__ sel, int batch, int h, int w, int ho,
    int wo, int th, int tw, int rows, int t_sel) {
  const int ntx = (wo + tw - 1) / tw;
  const int n_tiles = ((ho + th - 1) / th) * ntx;
  int tile = blockIdx.x, b_lo = 0, b_hi = batch;
  if (t_sel > 0) {
    const int slot = blockIdx.x / batch;
    b_lo = blockIdx.x % batch;
    b_hi = b_lo + 1;
    tile = sel[(long long)b_lo * t_sel + slot];
    if (tile < 0 || tile >= n_tiles) return;  // -1 padding: nothing to do
  }
  const int ty = tile / ntx, tx = tile % ntx;
  // The gray grids read planar frames, with the unit column stride known at compile time.
  const Strides s = RGB ? ss : Strides{3LL * h * w, (long long)h * w, w, 1};
  const int row0 = blockIdx.y * rows;
  const int n_px = min(rows, th - row0) * tw;
  const long long plane = (long long)ho * wo;
  for (int p = threadIdx.x; p < n_px; p += blockDim.x) {
    const int y = ty * th + row0 + p / tw;
    const int x = tx * tw + p % tw;
    if (y >= ho || x >= wo) continue;  // tiles that overhang the output (RGB mode)
    const long long o = (long long)y * wo + x;
    const float2 m = __ldg(reinterpret_cast<const float2*>(map) + o);
    const Taps t = make_taps(m.x, m.y, h, w, s.r, s.x);
    for (int b = b_lo; b < b_hi; ++b) {
      const uint8_t* frame = src + (long long)b * s.b;
      const int colour = blend(frame, t) << 16 | blend(frame + s.c, t) << 8 | blend(frame + 2 * s.c, t);
      if constexpr (RGB) {
        const uint32_t v = __ldg(bgrg_lut + colour);
        if (gray != nullptr) gray[(long long)b * plane + o] = (uint8_t)(v >> 24);
        uint8_t* dst = rgb + (long long)b * rs.b + (long long)y * rs.r + (long long)x * rs.x;
        for (int ch = 0; ch < 3; ++ch) dst[ch * rs.c] = (uint8_t)(v >> (8 * ch));
      } else {
        gray[(long long)b * plane + o] = __ldg(gray_lut + colour);
      }
    }
  }
}

// Launch shape over `units` tiles (K3) or (slot, frame) pairs (K4): one block per band
// of `rows` rows of a tile, about kThreads threads with px pixels of the band each.
void band_grid(int units, int th, int tw, int px, int* rows, dim3* grid, dim3* block) {
  *rows = std::min(th, std::max(1, kThreads * px / tw));
  *grid = dim3(units, (th + *rows - 1) / *rows);
  *block = dim3(std::min(kThreads, *rows * tw));
}

}  // namespace

// The colour tables of gamma, each where not null: gray (2^24) u8, bgrg (2^24) u32.
extern "C" int remap_table_launch(uint8_t* gray, uint32_t* bgrg, float gamma, cudaStream_t stream) {
  table_kernel<<<kColours / kThreads, kThreads, 0, stream>>>(gray, bgrg, gamma);
  return (int)cudaGetLastError();
}

// src (B, 3, H, W) u8 planar, map (Ho, Wo, 2) f32, lut the (2^24) u8 gray table, out
// (B, Ho, Wo) u8.  sel == nullptr and t_sel == 0: every (th, tw) tile (K3); else sel
// (B, t_sel) i32 tile ids (K4).
extern "C" int remap_gray_launch(const uint8_t* src, const float* map, const uint8_t* lut, uint8_t* out,
                                 const int32_t* sel, int batch, int h, int w, int ho, int wo, int th, int tw,
                                 int t_sel, cudaStream_t stream) {
  const Strides unused{0, 0, 0, 0};  // the gray-only kernel addresses planar frames itself
  int rows;
  dim3 grid, block;
  // K4: the (slot, frame) pairs, frame fastest, 8 pixels a thread; K3: the tiles, one
  // pixel a thread in each frame of the batch.
  if (t_sel > 0) {
    band_grid(t_sel * batch, th, tw, 8, &rows, &grid, &block);
  } else {
    band_grid((ho / th) * (wo / tw), th, tw, 1, &rows, &grid, &block);
  }
  remap_kernel<false><<<grid, block, 0, stream>>>(src, unused, map, lut, nullptr, out, nullptr, unused, sel, batch,
                                                  h, w, ho, wo, th, tw, rows, t_sel);
  return (int)cudaGetLastError();
}

// K3's RGB mode: src (B, 3, H, W) u8 with element strides (sb, sc, sr, sx), map (Ho, Wo, 2)
// f32, lut the (2^24) u32 B|G|R|gray table, rgb (B, 3, Ho, Wo) u8 with element strides
// (rb, rc, rr, rx), gray (B, Ho, Wo) u8 contiguous or null.  Every (th, tw) tile of the
// output, the overhang masked.
extern "C" int remap_rgb_gray_launch(const uint8_t* src, long long sb, long long sc, long long sr, long long sx,
                                     const float* map, const uint32_t* lut, uint8_t* rgb, long long rb,
                                     long long rc, long long rr, long long rx, uint8_t* gray, int batch, int h,
                                     int w, int ho, int wo, int th, int tw, cudaStream_t stream) {
  int rows;
  dim3 grid, block;
  band_grid(((ho + th - 1) / th) * ((wo + tw - 1) / tw), th, tw, 1, &rows, &grid, &block);
  const Strides ss{sb, sc, sr, sx}, rs{rb, rc, rr, rx};
  remap_kernel<true><<<grid, block, 0, stream>>>(src, ss, map, nullptr, lut, gray, rgb, rs, nullptr, batch, h, w, ho,
                                                 wo, th, tw, rows, 0);
  return (int)cudaGetLastError();
}
