// Block-matching displaced-frame difference (DFD) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_dfd_kernel` / `dfd_series_pallas`
// (pyannote_video_tpu/ops/dfd_pallas.py:48, :100, pallas_call at :134);
// the contract is pyannote_video_tpu/ops/dfd.py:dfd_series.
//
// For each consecutive pair (prev, cur) of gray frames [H, W]:
//   * crop prev to hc x wc (multiples of `block`), edge-pad cur by `radius`;
//   * for every block and every displacement (dy, dx) in the (2r+1)^2
//     window, the block mean of |prev - shifted cur|;
//   * with `subpixel`, V-correct each displacement,
//     max(v - |up - down|/2 - |left - right|/2, 0), one-sided at the edges
//     of the displacement window; take the min over displacements;
//   * write the mean of the per-block minima.
//
// Bound on an H100 at the shot stage's shape (T=257, 50x89, r=3, block 5):
// ~4.6 MB read (~1.4 us at 3.35 TB/s) against ~0.18 G f32 operations
// (~2.7 us at 67 TFLOP/s without tensor cores), so operations bound it;
// at one launch per 256-frame chunk, launch overhead is of the same order.
//
// Design: one CTA per frame pair (grid-stride over pairs).  The cropped
// prev frame and the edge-padded cur window are staged in shared memory;
// the padding is an index clamp on load, so no padded copy exists in
// device memory.  Threads then cover (block, displacement) work items and
// write the residual surface [n_blocks, R, R] to shared memory; a second
// pass applies the V-correction and the per-block min, and a block-wide
// reduction gives the mean.  The TPU kernel's layout workarounds (0/1
// pooling matmuls, 8 pairs per program, 128-lane broadcast output) are
// not carried over.  About 70 KB of shared memory at the shot shape, so
// the kernel opts in to dynamic shared memory above 48 KB.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
dfd_kernel(const float* __restrict__ gray, float* __restrict__ out,
           int n_pairs, int H, int W, int radius, int block, int subpixel) {
  extern __shared__ float smem[];
  __shared__ float s_warp[kThreads / 32];

  const int hc = (H / block) * block;
  const int wc = (W / block) * block;
  const int R = 2 * radius + 1;
  const int RR = R * R;
  const int ph = hc + 2 * radius;
  const int pw = wc + 2 * radius;
  const int n_bx = wc / block;
  const int n_blocks = (hc / block) * n_bx;
  const float inv_area = 1.0f / (float)(block * block);

  float* s_prev = smem;               // [hc, wc]
  float* s_cur = s_prev + hc * wc;    // [ph, pw], edge-padded window
  float* s_res = s_cur + ph * pw;     // [n_blocks, R, R]

  const int tid = threadIdx.x;
  for (int p = blockIdx.x; p < n_pairs; p += gridDim.x) {
    const float* prev = gray + (size_t)p * H * W;
    const float* cur = prev + (size_t)H * W;

    for (int i = tid; i < hc * wc; i += kThreads) {
      const int y = i / wc, x = i - (i / wc) * wc;
      s_prev[i] = prev[y * W + x];
    }
    // edge padding by clamping: row/col k of the window reads cur at
    // clamp(k - radius), as jnp.pad(mode="edge") followed by the crop to
    // [hc + 2r, wc + 2r] does
    for (int i = tid; i < ph * pw; i += kThreads) {
      const int y = i / pw, x = i - (i / pw) * pw;
      const int sy = min(max(y - radius, 0), H - 1);
      const int sx = min(max(x - radius, 0), W - 1);
      s_cur[i] = cur[sy * W + sx];
    }
    __syncthreads();

    for (int w = tid; w < n_blocks * RR; w += kThreads) {
      const int b = w / RR, d = w - (w / RR) * RR;
      const int y0 = (b / n_bx) * block, x0 = (b - (b / n_bx) * n_bx) * block;
      const int dy = d / R, dx = d - (d / R) * R;
      float s = 0.0f;
      for (int yy = 0; yy < block; ++yy) {
        const float* pr = s_prev + (y0 + yy) * wc + x0;
        const float* cr = s_cur + (y0 + yy + dy) * pw + x0 + dx;
        for (int xx = 0; xx < block; ++xx) s += fabsf(pr[xx] - cr[xx]);
      }
      s_res[w] = s * inv_area;
    }
    __syncthreads();

    float acc = 0.0f;
    for (int b = tid; b < n_blocks; b += kThreads) {
      const float* r = s_res + b * RR;
      float best = CUDART_INF_F;
      for (int dy = 0; dy < R; ++dy) {
        for (int dx = 0; dx < R; ++dx) {
          float v = r[dy * R + dx];
          if (subpixel) {
            const float up = r[max(dy - 1, 0) * R + dx];
            const float down = r[min(dy + 1, R - 1) * R + dx];
            const float left = r[dy * R + max(dx - 1, 0)];
            const float right = r[dy * R + min(dx + 1, R - 1)];
            v = fmaxf(v - fabsf(up - down) * 0.5f - fabsf(left - right) * 0.5f,
                      0.0f);
          }
          best = fminf(best, v);
        }
      }
      acc += best;
    }
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if ((tid & 31) == 0) s_warp[tid >> 5] = acc;
    __syncthreads();
    if (tid < 32) {
      float v = tid < kThreads / 32 ? s_warp[tid] : 0.0f;
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (tid == 0) out[p] = v / (float)n_blocks;
    }
    // the next pair overwrites shared memory
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Shared memory (bytes) the kernel needs for one frame pair.
size_t dfd_smem_bytes(int H, int W, int radius, int block) {
  const int hc = (H / block) * block, wc = (W / block) * block;
  const int R = 2 * radius + 1;
  const size_t floats = (size_t)hc * wc + (size_t)(hc + 2 * radius) * (wc + 2 * radius) +
                        (size_t)(hc / block) * (wc / block) * R * R;
  return floats * sizeof(float);
}

// gray: [T, H, W] float32, contiguous, on the device; out: [T - 1] float32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int dfd_series_launch(const void* gray, void* out, int T, int H, int W,
                      int radius, int block, int subpixel, void* stream) {
  const size_t smem = dfd_smem_bytes(H, W, radius, block);
  cudaError_t err = cudaFuncSetAttribute(
      dfd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_pairs = T - 1;
  const int grid = n_pairs < 65535 ? n_pairs : 65535;
  dfd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)gray, (float*)out, n_pairs, H, W, radius, block, subpixel);
  return (int)cudaGetLastError();
}

const char* dfd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
