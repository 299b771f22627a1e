// K5: 4x4 mean pool of the planar u8 source into the pooled plan's padded geometry.
//
// Replaces the JAX package's Pallas TPU kernel preproc/pallas_pool.py
// pool_packed_rows (the two-pass front's step 1 under pallas_pool=True).  The TPU
// kernel works on the i32 byte-packed source and repacks its output lanes with two
// MXU dots; both are layout artefacts of the TPU and are not carried over.  Here the
// source is planar u8 (B, 3, H, W) and the output planar u8 (B, 3, HP, WP).
//
// Plain version: apse_uav_torch/preproc/twopass.py pool_source_u8.  Every output
// byte is (sum of its 4x4 source bytes + 8) >> 4 for y < H/4, x < W/4 (the source
// is truncated to a multiple of 4 in both axes) and 0 in the pad, so the grid covers
// the whole padded output and the wrapper allocates it with torch.empty.
//
// What bounds it on the H100: memory.  It reads every source byte once (199 MB for
// 8 frames at 4K) and writes 1/16 of that; it does 16 adds per output byte.  Design:
// one thread per output byte, consecutive threads on consecutive output columns, so
// each thread reads one aligned 4-byte word from each of its 4 source rows and a warp
// reads 128 contiguous bytes per row (W % 4 == 0 is required by the wrapper).  The
// grid is (column blocks, output rows, planes): no 64-bit divisions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void pool4_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ out,
                             int h, int w, int hp, int wp) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  const long long plane = blockIdx.z;  // b * C + c
  if (x >= wp) return;
  uint32_t v = 0;
  if (y < h / 4 && x < w / 4) {
    const int wq = w / 4;  // 4-byte words per source row
    const uint32_t* row =
        reinterpret_cast<const uint32_t*>(src + plane * h * w + (long long)(4 * y) * w) + x;
    uint32_t s = 0;
    for (int k = 0; k < 4; ++k) {
      const uint32_t q = __ldg(row + (long long)k * wq);
      s += (q & 255u) + ((q >> 8) & 255u) + ((q >> 16) & 255u) + (q >> 24);
    }
    v = (s + 8u) >> 4;
  }
  out[(plane * hp + y) * wp + x] = (uint8_t)v;
}

}  // namespace

// src (planes, H, W) u8 with W % 4 == 0 and a 4-byte aligned base, out (planes, HP, WP)
// u8 with HP >= H / 4, WP >= W / 4; planes and HP at most 65535.
extern "C" int pool4_launch(const uint8_t* src, uint8_t* out, int planes, int h, int w, int hp, int wp,
                            cudaStream_t stream) {
  dim3 grid((wp + kThreads - 1) / kThreads, hp, planes);
  pool4_kernel<<<grid, kThreads, 0, stream>>>(src, out, h, w, hp, wp);
  return (int)cudaGetLastError();
}
