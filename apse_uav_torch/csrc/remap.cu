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
// Every grid runs the same per-pixel device function, so K4's tiles are bit-identical
// to K3's full-frame output for the same frame and map, and the RGB mode's gray is
// K3's gray.
//
// Plain versions: apse_uav_torch/preproc/remap.py remap_gray_u8 and remap_rgb_gray_u8.
// The source position of every output pixel comes in as the port's own float32
// undistort_rectify_map tensor (Ho, Wo, 2) -- passed in, not re-evaluated here, so
// kernel and plain version sample at the same coordinates.  The arithmetic follows
// the plain version op by op: built with -fmad=false (no a*b+c contraction), IEEE
// division by constants, rintf (round half to even, like torch.round), powf as
// PyTorch's CUDA pow.
//
// In the RGB mode, source and RGB output are addressed through (batch, channel, row,
// column) element strides, so one kernel reads the planar frames of the ArUco path and
// the HWC frames of Preprocessor (and writes the RGB image in either layout) with no
// transpose copy.  The gray-only launches address planar frames as before.
//
// What bounds it on the H100: memory.  Per output pixel it reads the 8-byte map
// entry, 4 taps x 3 channels of u8 source (mostly from L1/L2: neighbouring pixels
// share taps) and writes 1 byte of gray (+3 of RGB); the LAB chain is ~100 FP32 ops
// incl. 6 powf.  A 4K frame moves ~66 MB of map + ~25 MB of source + 8 MB of gray, so
// the map is the largest stream; evaluating the distortion polynomial in-kernel would
// remove it (a later optimisation).  Design: one block per (th, tw) output tile, one
// thread per output pixel with consecutive threads on consecutive columns (coalesced
// map and output), the tile id from blockIdx (K3) or from sel (K4); tiles that
// overhang the output (RGB mode at any frame size) are masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// One u8 tap of channel plane `p` (H x W, row and column strides s_r, s_x), 0 outside
// the source.
__device__ __forceinline__ float tap(const uint8_t* p, float yy, float xx, int h, int w, long long s_r,
                                     long long s_x) {
  if (yy >= 0.0f && yy <= (float)(h - 1) && xx >= 0.0f && xx <= (float)(w - 1)) {
    return (float)p[(long long)yy * s_r + (long long)xx * s_x];
  }
  return 0.0f;
}

// The gamma-corrected stored-order channels o[0..2] of one output pixel, and its gray.
__device__ __forceinline__ uint8_t pixel_lab_gamma(const uint8_t* frame, const Strides& s, float mx, float my,
                                                   int h, int w, float gamma, int o[3]) {
  const float x0 = floorf(mx), y0 = floorf(my);
  const float wx = mx - x0, wy = my - y0;
  float c8[3];
  for (int ch = 0; ch < 3; ++ch) {
    const uint8_t* p = frame + ch * s.c;
    const float p00 = tap(p, y0, x0, h, w, s.r, s.x), p01 = tap(p, y0, x0 + 1.0f, h, w, s.r, s.x);
    const float p10 = tap(p, y0 + 1.0f, x0, h, w, s.r, s.x), p11 = tap(p, y0 + 1.0f, x0 + 1.0f, h, w, s.r, s.x);
    const float top = p00 * (1.0f - wx) + p01 * wx;
    const float bot = p10 * (1.0f - wx) + p11 * wx;
    c8[ch] = clamp255(rintf(top * (1.0f - wy) + bot * wy));
  }
  // RGB2LAB on the stored channel order (colorspace.rgb_to_lab_u8).
  const float l0 = srgb_to_linear(c8[0] / 255.0f);
  const float l1 = srgb_to_linear(c8[1] / 255.0f);
  const float l2 = srgb_to_linear(c8[2] / 255.0f);
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

// gray (B, Ho, Wo) u8; with RGB also rgb, addressed by rs, and src by ss (gray may be null).
template <bool RGB>
__global__ void remap_kernel(const uint8_t* __restrict__ src, Strides ss, const float* __restrict__ map,
                             uint8_t* __restrict__ gray, uint8_t* __restrict__ rgb, Strides rs,
                             const int32_t* __restrict__ sel, int h, int w, int ho, int wo, int th, int tw,
                             int t_sel, float gamma) {
  const int b = blockIdx.y;
  const int ntx = (wo + tw - 1) / tw;
  const int n_tiles = ((ho + th - 1) / th) * ntx;
  int tile = blockIdx.x;
  if (t_sel > 0) {
    tile = sel[(long long)b * t_sel + blockIdx.x];
    if (tile < 0 || tile >= n_tiles) return;  // -1 padding: nothing to do
  }
  const int ty = tile / ntx, tx = tile % ntx;
  // The gray-only grids read planar frames, with the unit column stride known at compile
  // time, and cover the output exactly (th, tw divide it), as they did before the RGB mode.
  const Strides s = RGB ? ss : Strides{3LL * h * w, (long long)h * w, w, 1};
  const uint8_t* frame = src + (long long)b * s.b;
  for (int p = threadIdx.x; p < th * tw; p += blockDim.x) {
    const int y = ty * th + p / tw;
    const int x = tx * tw + p % tw;
    if (RGB && (y >= ho || x >= wo)) continue;
    const long long o = (long long)y * wo + x;
    int c[3];
    const uint8_t g = pixel_lab_gamma(frame, s, map[2 * o], map[2 * o + 1], h, w, gamma, c);
    if (!RGB || gray != nullptr) gray[(long long)b * ho * wo + o] = g;
    if constexpr (RGB) {
      uint8_t* dst = rgb + (long long)b * rs.b + (long long)y * rs.r + (long long)x * rs.x;
      for (int ch = 0; ch < 3; ++ch) dst[ch * rs.c] = (uint8_t)c[ch];
    }
  }
}

}  // namespace

// src (B, 3, H, W) u8 planar, map (Ho, Wo, 2) f32, out (B, Ho, Wo) u8.  sel == nullptr
// and t_sel == 0: every (th, tw) tile (K3); else sel (B, t_sel) i32 tile ids (K4).
extern "C" int remap_gray_launch(const uint8_t* src, const float* map, uint8_t* out, const int32_t* sel,
                                 int batch, int h, int w, int ho, int wo, int th, int tw, int t_sel,
                                 float gamma, cudaStream_t stream) {
  const int n_tiles = (ho / th) * (wo / tw);
  const Strides unused{0, 0, 0, 0};  // the gray-only kernel addresses planar frames itself
  dim3 grid(t_sel > 0 ? t_sel : n_tiles, batch);
  remap_kernel<false><<<grid, 256, 0, stream>>>(src, unused, map, out, nullptr, unused, sel, h, w, ho, wo, th, tw,
                                                t_sel, gamma);
  return (int)cudaGetLastError();
}

// K3's RGB mode: src (B, 3, H, W) u8 with element strides (sb, sc, sr, sx), map (Ho, Wo, 2)
// f32, rgb (B, 3, Ho, Wo) u8 with element strides (rb, rc, rr, rx), gray (B, Ho, Wo) u8
// contiguous or null.  Every (th, tw) tile of the output, the overhang masked.
extern "C" int remap_rgb_gray_launch(const uint8_t* src, long long sb, long long sc, long long sr, long long sx,
                                     const float* map, uint8_t* rgb, long long rb, long long rc, long long rr,
                                     long long rx, uint8_t* gray, int batch, int h, int w, int ho, int wo, int th,
                                     int tw, float gamma, cudaStream_t stream) {
  const int n_tiles = ((ho + th - 1) / th) * ((wo + tw - 1) / tw);
  dim3 grid(n_tiles, batch);
  remap_kernel<true><<<grid, 256, 0, stream>>>(src, Strides{sb, sc, sr, sx}, map, gray, rgb,
                                               Strides{rb, rc, rr, rx}, nullptr, h, w, ho, wo, th, tw, 0, gamma);
  return (int)cudaGetLastError();
}
