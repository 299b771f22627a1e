// K3 + K4: fused undistort (bilinear remap) + LAB gamma + BGR2GRAY, u8 gray out.
//
// Replaces the JAX package's Pallas TPU kernel preproc/pallas_remap.py
// _make_kernel, in both of its grid modes:
//   K3  _fused_preproc_packed_impl (full grid; the two-pass front runs it on the
//       4x-pooled plan, (B, 3, 544, 1024) at 4K);
//   K4  _fused_preproc_selected (t_sel > 0: only the tile ids in sel (B, T_sel) of
//       the full-res tile grid; -1 entries do nothing, unselected tiles are left
//       unwritten).
// Both grids run the same per-pixel device function, so K4's tiles are bit-identical
// to K3's full-frame output for the same frame and map.
//
// Plain version: apse_uav_torch/preproc/remap.py remap_gray_u8.  The source
// position of every output pixel comes in as the port's own float32
// undistort_rectify_map tensor (Ho, Wo, 2) -- passed in, not re-evaluated here, so
// kernel and plain version sample at the same coordinates.  The arithmetic follows
// the plain version op by op: built with -fmad=false (no a*b+c contraction), IEEE
// division by constants, rintf (round half to even, like torch.round), powf as
// PyTorch's CUDA pow.
//
// What bounds it on the H100: memory.  Per output pixel it reads the 8-byte map
// entry, 4 taps x 3 channels of u8 source (mostly from L1/L2: neighbouring pixels
// share taps) and writes 1 byte; the LAB chain is ~100 FP32 ops incl. 6 powf.
// A 4K frame moves ~66 MB of map + ~25 MB of source + 8 MB of gray, so the map is
// the largest stream; evaluating the distortion polynomial in-kernel would remove
// it (a later optimisation).  Design: one block per (th, tw) output tile, one thread
// per output pixel with consecutive threads on consecutive columns (coalesced map
// and output), the tile id from blockIdx (K3) or from sel (K4).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// One u8 tap of channel plane `p` (H x W), 0 outside the source.
__device__ __forceinline__ float tap(const uint8_t* p, float yy, float xx, int h, int w) {
  if (yy >= 0.0f && yy <= (float)(h - 1) && xx >= 0.0f && xx <= (float)(w - 1)) {
    return (float)p[(long long)yy * w + (long long)xx];
  }
  return 0.0f;
}

__device__ __forceinline__ uint8_t pixel_gray(const uint8_t* src, float mx, float my, int h, int w, float gamma) {
  const long long plane = (long long)h * w;
  const float x0 = floorf(mx), y0 = floorf(my);
  const float wx = mx - x0, wy = my - y0;
  float c8[3];
  for (int ch = 0; ch < 3; ++ch) {
    const uint8_t* p = src + ch * plane;
    const float p00 = tap(p, y0, x0, h, w), p01 = tap(p, y0, x0 + 1.0f, h, w);
    const float p10 = tap(p, y0 + 1.0f, x0, h, w), p11 = tap(p, y0 + 1.0f, x0 + 1.0f, h, w);
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
  const int o0 = (int)clamp255(rintf(linear_to_srgb(r) * 255.0f));
  const int o1 = (int)clamp255(rintf(linear_to_srgb(g) * 255.0f));
  const int o2 = (int)clamp255(rintf(linear_to_srgb(b) * 255.0f));
  // BGR2GRAY on stored order (o0 = B, o1 = G, o2 = R), cv2 fixed point.
  const int gray = (4899 * o2 + 9617 * o1 + 1868 * o0 + (1 << 13)) >> 14;
  return (uint8_t)min(max(gray, 0), 255);
}

__global__ void remap_gray_kernel(const uint8_t* __restrict__ src, const float* __restrict__ map,
                                  uint8_t* __restrict__ out, const int32_t* __restrict__ sel,
                                  int h, int w, int ho, int wo, int th, int tw, int t_sel, float gamma) {
  const int b = blockIdx.y;
  const int ntx = wo / tw;
  const int n_tiles = (ho / th) * ntx;
  int tile = blockIdx.x;
  if (t_sel > 0) {
    tile = sel[(long long)b * t_sel + blockIdx.x];
    if (tile < 0 || tile >= n_tiles) return;  // -1 padding: nothing to do
  }
  const int ty = tile / ntx, tx = tile % ntx;
  const uint8_t* frame = src + (long long)b * 3 * h * w;
  uint8_t* dst = out + (long long)b * ho * wo;
  for (int p = threadIdx.x; p < th * tw; p += blockDim.x) {
    const int y = ty * th + p / tw;
    const int x = tx * tw + p % tw;
    const long long o = (long long)y * wo + x;
    dst[o] = pixel_gray(frame, map[2 * o], map[2 * o + 1], h, w, gamma);
  }
}

}  // namespace

// src (B, 3, H, W) u8, map (Ho, Wo, 2) f32, out (B, Ho, Wo) u8.  sel == nullptr and
// t_sel == 0: every (th, tw) tile (K3); else sel (B, t_sel) i32 tile ids (K4).
extern "C" int remap_gray_launch(const uint8_t* src, const float* map, uint8_t* out, const int32_t* sel,
                                 int batch, int h, int w, int ho, int wo, int th, int tw, int t_sel,
                                 float gamma, cudaStream_t stream) {
  const int n_tiles = (ho / th) * (wo / tw);
  dim3 grid(t_sel > 0 ? t_sel : n_tiles, batch);
  remap_gray_kernel<<<grid, 256, 0, stream>>>(src, map, out, sel, h, w, ho, wo, th, tw, t_sel, gamma);
  return (int)cudaGetLastError();
}
