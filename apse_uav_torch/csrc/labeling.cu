// K1: 4-connected component labels of binarized candidate windows.
//
// Replaces the JAX package's Pallas TPU kernel aruco/pallas_labeling.py
// _kernel / labels_batched.  Plain version: apse_uav_torch/aruco/detector.py
// _label_sweeps.  Same fixed schedule: `rounds` rounds of segmented row then
// column prefix-min sweeps with run-id keys (R - runid) * K + label (R = win + 1,
// K = win*win + 1), then `mop` radius-1 steps.  Root label y*win + x, sentinel
// win*win.  All integer arithmetic and a prefix min does not depend on the scan
// order, so the output is bit-identical to the plain version.
//
// What bounds it on the H100: latency, not bytes or operations.  A 64x64 window
// is 4 KB in and 16 KB out; 60 windows per 4K frame are ~1 MB in all, and the
// 6 sweeps (12 scans) + 8 steps are ~0.5 M integer ops per window.  The work is a chain of
// dependent serial scans, so the design keeps everything on chip: one block per
// window, the labels in shared memory (rows padded to 65 ints so that the
// one-thread-per-row sweeps do not all hit one bank), one thread per row (row
// sweeps) or per column (column sweeps) scanning serially.  The run ids are
// counted on the fly during each scan instead of being stored.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWin = 64;
constexpr int kPitch = kMaxWin + 1;

// One segmented prefix-min sweep along a line of `win` cells: cell i of the line
// is lab[base + i * stride].  Forward and backward scans, then
// lab = dark ? min(lab, lf, lb) : sentinel.  tmp holds lf between the two scans.
__device__ void sweep_line(int* lab, int* tmp, const uint8_t* dark, int base, int stride, int dbase, int dstride,
                           int win, int kk, int rr, int sentinel) {
  int runid = 0;
  int m = 0x7fffffff;
  for (int i = 0; i < win; ++i) {
    const int l = lab[base + i * stride];
    runid += dark[dbase + i * dstride] ? 0 : 1;
    const int t = (rr - runid) * kk;
    m = min(m, t + l);
    tmp[base + i * stride] = m - t;
  }
  runid = 0;
  m = 0x7fffffff;
  for (int i = win - 1; i >= 0; --i) {
    const int l = lab[base + i * stride];
    const bool d = dark[dbase + i * dstride] != 0;
    runid += d ? 0 : 1;
    const int t = (rr - runid) * kk;
    m = min(m, t + l);
    const int lb = m - t;
    lab[base + i * stride] = d ? min(l, min(tmp[base + i * stride], lb)) : sentinel;
  }
}

__global__ void labels_kernel(const uint8_t* __restrict__ dark_g, int32_t* __restrict__ out, int win, int rounds,
                              int mop) {
  __shared__ int lab[kMaxWin * kPitch];
  __shared__ int tmp[kMaxWin * kPitch];
  __shared__ uint8_t dark[kMaxWin * kMaxWin];
  const int n = win * win;
  const int sentinel = n;
  const int kk = n + 1;
  const int rr = win + 1;
  const uint8_t* src = dark_g + (long long)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int y = i / win, x = i % win;
    const uint8_t d = src[i];
    dark[i] = d;
    lab[y * kPitch + x] = d ? i : sentinel;
  }
  __syncthreads();
  const int line = threadIdx.x;
  for (int r = 0; r < rounds; ++r) {
    if (line < win) {  // row sweep: thread = row y, cells (y, 0..win-1)
      sweep_line(lab, tmp, dark, line * kPitch, 1, line * win, 1, win, kk, rr, sentinel);
    }
    __syncthreads();
    if (line < win) {  // column sweep: thread = column x, cells (0..win-1, x)
      sweep_line(lab, tmp, dark, line, kPitch, line, win, win, kk, rr, sentinel);
    }
    __syncthreads();
  }
  int* cur = lab;
  int* nxt = tmp;
  for (int s = 0; s < mop; ++s) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int y = i / win, x = i % win;
      const int c = cur[y * kPitch + x];
      int v = sentinel;
      if (dark[i]) {
        const int up = y > 0 ? cur[(y - 1) * kPitch + x] : sentinel;
        const int dn = y < win - 1 ? cur[(y + 1) * kPitch + x] : sentinel;
        const int lt = x > 0 ? cur[y * kPitch + x - 1] : sentinel;
        const int rt = x < win - 1 ? cur[y * kPitch + x + 1] : sentinel;
        v = min(c, min(min(up, dn), min(lt, rt)));
      }
      nxt[y * kPitch + x] = v;
    }
    __syncthreads();
    int* t = cur;
    cur = nxt;
    nxt = t;
  }
  int32_t* dst = out + (long long)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    dst[i] = cur[(i / win) * kPitch + i % win];
  }
}

}  // namespace

// dark (K, win, win) u8 (torch.bool), out (K, win, win) i32; win <= 64.
extern "C" int labels_launch(const uint8_t* dark, int32_t* out, int k, int win, int rounds, int mop,
                             cudaStream_t stream) {
  if (win > kMaxWin || win <= 0) return (int)cudaErrorInvalidValue;
  labels_kernel<<<k, kMaxWin, 0, stream>>>(dark, out, win, rounds, mop);
  return (int)cudaGetLastError();
}
