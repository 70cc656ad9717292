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
// What bounds it on an H100: operations.  At the shot stage's chunk shape
// (T=257, 50x89, r=3, block 5) it reads ~4.6 MB (~1.4 us at 3.35 TB/s) and
// does ~0.18 G f32 operations (~2.7 us at 67 TFLOP/s).  Every (pixel,
// displacement) term is |prev - cur| added to a sum: two f32 instructions
// (the add takes |x| as an operand modifier), ~0.11 G in all, and not a
// product, so tensor cores do not serve it and pooling in TF32 or bf16
// would break the 1e-3 tolerance on residuals of ~1e2.
//
// Design:
//   * One thread per (pair, block).  The thread keeps its block's block^2
//     prev pixels and the (2r+1)^2 residual sums in registers and walks the
//     block+2r cur rows of its search window once: each row's block+2r
//     values are read from shared memory once and feed every (row of the
//     block, dy) sum they belong to, so the loop is bound by f32 issue, not
//     by shared-memory loads.  The V-correction, the min over displacements
//     and the block mean run in registers.
//   * Radius, block and subpixel are template parameters: for the shot
//     stage's (3, 5) every loop unrolls and every index is a constant.
//     Other sizes run the same body with run-time radius and block
//     (kBlock == 0), its arrays then in local memory.
//   * A CTA takes a tile of `band` x `tile_bx` blocks of `pairs` consecutive
//     pairs and stages the frame rows and columns its windows reach, of
//     pairs + 1 frames (frame f is cur of pair f-1 and prev of pair f, so
//     each is staged once per CTA).  Shared memory is bounded by the tile
//     that the launch plan picks (pyannote_video_tpu_torch/ops/dfd.py:_plan),
//     not by H x W.
//   * Staging is bulk copies (cp.async.bulk) completing on one mbarrier.
//     Where the tile is as wide as the frame, its rows are contiguous in
//     the frame stack and one copy stages a whole frame; otherwise one copy
//     per row.  Copies move 16-byte granules, but rows are W * 4 bytes
//     apart (356 B at W = 89), so a copy starts at the granule holding its
//     first float and the reader skips the frame's `lead` floats (for
//     per-row copies, a row pitch congruent to W mod 4 gives every row of a
//     frame the same lead).  Small copies are slow: staging the shot
//     stage's chunk with 4-byte cp.async, TMA row boxes or one bulk copy
//     per row took longer than with one bulk copy per frame.
//   * Edge padding is a clamp when the window is read: rows clamp into the
//     frame, and of the window's columns only the r at either end can leave
//     it, so only those read through clamped offsets.  No padded copy
//     exists anywhere.
//   * Sums are deterministic: a CTA adds its blocks' minima in a fixed
//     order; where the plan splits a frame into several tiles, the tile
//     sums go to a scratch buffer and a second kernel adds them in tile
//     order.  No float atomics.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

// The launch plan; the field order matches ops/dfd.py:_CPlan.  Outside the
// anonymous namespace: the extern "C" launcher takes it.
struct DfdPlan {
  int T, H, W, radius, block;
  int band, tile_bx, pairs;     // block rows, block columns, pairs per CTA
  int n_tx, n_tiles, n_groups;  // tiles across, tiles per frame, pair groups
  int rows, pitch, fstride;     // window rows; staged row pitch, frame stride
  int full;                     // tiles as wide as the frame: one copy a frame
  int threads, smem;            // CTA size, dynamic shared memory (bytes)
};

namespace {

constexpr int kMaxThreads = 256;  // ops/dfd.py:_MAX_THREADS
constexpr int kPad = 4;           // ops/dfd.py:_PAD: floats before each staged frame
constexpr int kMaxRadius = 7;     // limits of the run-time instance
constexpr int kMaxBlock = 16;

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// adds `bytes` to the transfers the current phase of `bar` waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// waits for the first phase of `bar`
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// one bulk copy (16-byte aligned, a multiple of 16 bytes) that completes
// on `bar`
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Three CTAs per SM cap the registers at 80: ptxas then spills ~180 bytes,
// and the kernel still runs faster than with the ~126 it takes at two
// (PERF.md; scripts/dfd_probe.py measures both).
template <int kRadius, int kBlock, bool kSubpixel>
__global__ void __launch_bounds__(kMaxThreads, 3)
dfd_kernel(const float* __restrict__ base, int shift, float* __restrict__ out,
           float* __restrict__ partial, const DfdPlan p) {
  constexpr bool kDynamic = kBlock == 0;
  constexpr int kB = kDynamic ? kMaxBlock : kBlock;
  constexpr int kR = kDynamic ? 2 * kMaxRadius + 1 : 2 * kRadius + 1;
  const int radius = kDynamic ? p.radius : kRadius;
  const int block = kDynamic ? p.block : kBlock;
  const int R = 2 * radius + 1;
  const int win = block + 2 * radius;

  extern __shared__ __align__(128) float smem[];  // [pairs + 1][fstride]
  __shared__ float s_best[kMaxThreads];
  __shared__ uint64_t s_ready;

  const int tile = blockIdx.x % p.n_tiles;
  const int p0 = (blockIdx.x / p.n_tiles) * p.pairs;
  const int pairs = min(p.pairs, p.T - 1 - p0);
  const int by0 = (tile / p.n_tx) * p.band;
  const int bx0 = (tile % p.n_tx) * p.tile_bx;
  const int n_by = p.H / block, n_bx = p.W / block;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  // The tile's windows reach frame rows [y_lo, y_hi) and columns
  // [x_lo, x_hi).  Frame f of the CTA (frame p0 + f of the stack) is staged
  // at smem + f * fstride + kPad: frame row y, column x at
  // lead_f + (y - y_lo) * rstride + (x - x_lo).  A copy runs from the
  // 16-byte boundary at or before its first element (`base` is gray's
  // boundary, `shift` floats before it) to the one at or after its last.
  // Full-width tiles: the rows are contiguous in the stack, one copy per
  // frame, rstride = W.  Column tiles: one copy per row, rstride = pitch =
  // W (mod 4), so each row's copy lands on a 16-byte boundary with its data
  // where the frame's lead puts it.
  const int y_org = by0 * block - radius, x_org = bx0 * block - radius;
  const int y_lo = max(y_org, 0), y_hi = min(y_org + p.rows, p.H);
  const int x_lo = p.full ? 0 : max(x_org, 0);
  const int x_hi = p.full ? p.W : min(x_org + p.tile_bx * block + 2 * radius, p.W);
  const int rstride = p.full ? p.W : p.pitch;
  auto element = [&](int f, int y, int x) {  // from base, of stack frame p0 + f
    return shift + ((p0 + f) * p.H + y) * p.W + x;
  };
  if (threadIdx.x == 0) mbar_init(&s_ready, 1);
  __syncthreads();
  if (warp == 0) {
    const int segs = p.full ? 1 : y_hi - y_lo;
    for (int i = lane; i < (pairs + 1) * segs; i += 32) {
      const int f = i / segs, y = y_lo + (i - f * segs);
      const int e0 = element(f, y, x_lo);
      const int e1 = p.full ? element(f, y_hi - 1, p.W) : element(f, y, x_hi);
      const unsigned bytes = 4u * (unsigned)(((e1 + 3) & ~3) - (e0 & ~3));
      const int at = kPad + (element(f, y_lo, x_lo) & 3) + (y - y_lo) * rstride -
                     (e0 & 3);
      mbar_expect_tx(&s_ready, bytes);
      bulk_copy(smem + f * p.fstride + at, base + (e0 & ~3), bytes, &s_ready);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&s_ready);
  }
  if (threadIdx.x == 0) mbar_wait(&s_ready);
  __syncthreads();

  const int per_pair = p.band * p.tile_bx;
  const int k = threadIdx.x / per_pair;
  const int ly = (threadIdx.x - k * per_pair) / p.tile_bx;
  const int lx = threadIdx.x - k * per_pair - ly * p.tile_bx;
  float best = 0.0f;
  if (k < pairs && by0 + ly < n_by && bx0 + lx < n_bx) {
    // frame row y (edge-clamped) of CTA frame f, at frame column 0
    auto staged = [&](int f, int y) {
      return smem + f * p.fstride + kPad + (element(f, y_lo, x_lo) & 3) - x_lo +
             (min(max(y, 0), p.H - 1) - y_lo) * rstride;
    };
    // window column j of the block is frame column xw + j, edge-clamped;
    // only the r columns at either end can lie outside the frame
    const int x0 = (bx0 + lx) * block, y0 = (by0 + ly) * block;
    const int xw = x0 - radius;
    int edge[kR - 1];  // 2r clamped columns
#pragma unroll
    for (int j = 0; j < radius; ++j) {
      edge[j] = max(xw + j, 0);
      edge[radius + j] = min(xw + block + radius + j, p.W - 1);
    }

    float pv[kB][kB];
#pragma unroll
    for (int yy = 0; yy < block; ++yy) {
      const float* prev = staged(k, y0 + yy) + x0;
#pragma unroll
      for (int xx = 0; xx < block; ++xx) pv[yy][xx] = prev[xx];
    }

    float acc[kR][kR];
#pragma unroll
    for (int dy = 0; dy < R; ++dy)
#pragma unroll
      for (int dx = 0; dx < R; ++dx) acc[dy][dx] = 0.0f;

    // window row i holds cur row yy + dy for every yy + dy == i
#pragma unroll
    for (int i = 0; i < win; ++i) {
      const float* cur = staged(k + 1, y0 - radius + i);
      float row[kB + kR - 1];
#pragma unroll
      for (int j = 0; j < radius; ++j) {
        row[j] = cur[edge[j]];
        row[radius + block + j] = cur[edge[radius + j]];
      }
#pragma unroll
      for (int j = 0; j < block; ++j) row[radius + j] = cur[x0 + j];
#pragma unroll
      for (int yy = 0; yy < block; ++yy) {
        const int dy = i - yy;
        if (dy < 0 || dy >= R) continue;
#pragma unroll
        for (int xx = 0; xx < block; ++xx)
#pragma unroll
          for (int dx = 0; dx < R; ++dx)
            acc[dy][dx] += fabsf(pv[yy][xx] - row[xx + dx]);
      }
    }

    // min over displacements of max(v - |up-down|/2 - |left-right|/2, 0):
    // the clamp at 0 and the 1/block^2 of the block mean commute with the
    // min, so each is applied once; a min per displacement row, then across
    // rows, keeps the dependency chains short
    best = CUDART_INF_F;
#pragma unroll
    for (int dy = 0; dy < R; ++dy) {
      float m = CUDART_INF_F;
#pragma unroll
      for (int dx = 0; dx < R; ++dx) {
        float v = acc[dy][dx];
        if (kSubpixel) {
          const float up = acc[max(dy - 1, 0)][dx];
          const float down = acc[min(dy + 1, R - 1)][dx];
          const float left = acc[dy][max(dx - 1, 0)];
          const float right = acc[dy][min(dx + 1, R - 1)];
          v = fmaf(fabsf(up - down) + fabsf(left - right), -0.5f, v);
        }
        m = fminf(m, v);
      }
      best = fminf(best, m);
    }
    best = fmaxf(best, 0.0f) * (1.0f / (float)(block * block));
  }
  // per pair: lane-strided sums in a fixed order, then a butterfly
  s_best[threadIdx.x] = best;
  __syncthreads();
  for (int kk = warp; kk < pairs; kk += n_warps) {
    float s = 0.0f;
    for (int i = lane; i < per_pair; i += 32) s += s_best[kk * per_pair + i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      if (p.n_tiles == 1)
        out[p0 + kk] = s / (float)(n_by * n_bx);
      else
        partial[(size_t)(p0 + kk) * p.n_tiles + tile] = s;
    }
  }
}

// out[p] = (sum of partial[p, :] in tile order) / n_blocks
__global__ void dfd_sum_tiles(const float* __restrict__ partial,
                              float* __restrict__ out, int n_pairs,
                              int n_tiles, int n_blocks) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pairs) return;
  float s = 0.0f;
  for (int t = 0; t < n_tiles; ++t) s += partial[(size_t)p * n_tiles + t];
  out[p] = s / (float)n_blocks;
}

template <int kRadius, int kBlock, bool kSubpixel>
cudaError_t launch(const float* base, int shift, float* out, float* partial,
                   const DfdPlan& p, cudaStream_t stream) {
  dfd_kernel<kRadius, kBlock, kSubpixel>
      <<<p.n_groups * p.n_tiles, p.threads, p.smem, stream>>>(base, shift, out,
                                                              partial, p);
  return cudaGetLastError();
}

void* const kInstances[] = {
    (void*)dfd_kernel<3, 5, true>, (void*)dfd_kernel<3, 5, false>,
    (void*)dfd_kernel<0, 0, true>, (void*)dfd_kernel<0, 0, false>};

}  // namespace

extern "C" {

// Lets every instance take all the shared memory a CTA may have on the
// current device.  Call once per device, outside any stream capture.
// Returns the largest static shared memory of the instances (bytes), or
// -(CUDA error code).
int dfd_prepare(void) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  int static_max = 0;
  for (void* fn : kInstances) {
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - (int)attr.sharedSizeBytes);
    if (err != cudaSuccess) return -(int)err;
    static_max = (int)attr.sharedSizeBytes > static_max ? (int)attr.sharedSizeBytes
                                                        : static_max;
  }
  return static_max;
}

// gray: [T, H, W] float32, contiguous, on the device; out: [T - 1] float32;
// partial: [T - 1, n_tiles] float32 scratch when plan->n_tiles > 1.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int dfd_series_launch(const void* gray, void* out, void* partial,
                      const DfdPlan* plan, int subpixel, void* stream) {
  const DfdPlan& p = *plan;
  // copies start on 16-byte boundaries: the one at or before gray, `shift`
  // floats earlier, lies in gray's allocation (granules holding no element
  // of gray are never copied)
  const auto addr = reinterpret_cast<uintptr_t>(gray);
  const auto* g = reinterpret_cast<const float*>(addr & ~(uintptr_t)15);
  const int shift = (int)((addr & 15) / sizeof(float));
  auto* o = (float*)out;
  auto* part = (float*)partial;
  const auto st = (cudaStream_t)stream;
  cudaError_t err;
  if (p.radius == 3 && p.block == 5) {
    err = subpixel ? launch<3, 5, true>(g, shift, o, part, p, st)
                   : launch<3, 5, false>(g, shift, o, part, p, st);
  } else {
    if (p.radius < 0 || p.radius > kMaxRadius || p.block < 1 || p.block > kMaxBlock)
      return (int)cudaErrorInvalidValue;
    err = subpixel ? launch<0, 0, true>(g, shift, o, part, p, st)
                   : launch<0, 0, false>(g, shift, o, part, p, st);
  }
  if (err != cudaSuccess || p.n_tiles == 1) return (int)err;
  const int n_pairs = p.T - 1;
  dfd_sum_tiles<<<(n_pairs + 255) / 256, 256, 0, st>>>(
      part, o, n_pairs, p.n_tiles, (p.H / p.block) * (p.W / p.block));
  return (int)cudaGetLastError();
}

const char* dfd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
