// Tile-blend backward for Hopper (sm_90a): the gradient of the packed blend
// records from the gradients of image, depth and alpha.
//
// Replaces: d3gs_tpu/ops/pallas_blend.py::_bwd_kernel (launched by
// _bwd_pallas) and its XLA epilogue _core_bwd, which on the TPU write
// per-duplicate gradient blocks and reduce them per Gaussian with a sort
// and a segmented cumsum. This kernel follows the reference rasterizer's
// renderCUDA backward instead:
//   * one 256-thread block per tile, one thread per pixel;
//   * each pixel starts at its last included record (last_contrib, written
//     by csrc/blend_fwd.cu) and walks back to the front of the list; the
//     block starts at the largest last_contrib of its pixels (a block-wide
//     max) and stages the records in shared memory in batches of 256, from
//     the back, each with its Gaussian id order[rank_sorted[m]];
//   * the walk is anchored in log space on the forward's log T_final:
//     L = log T after record k, T_before = exp(L - log1p(-alpha)), and
//     L -= log1p(-alpha) per included record, so saturated tiles (T far
//     below the f32 range of a product) give finite gradients;
//   * per record each pixel forms its partials of mean2d (2), conic (3),
//     rgb (3), power (opacity) and depth; a warp sums them with
//     __shfl_down_sync, lane 0 adds the warp's sum into a per-batch
//     accumulator in shared memory, and after the batch each record's row
//     goes to the (N, 16) gradient with one atomicAdd per channel. That
//     replaces the TPU's sort-and-cumsum epilogue; the atomics make the
//     summation order, and so the last bits, vary from run to run.
//   * the depth cotangent's math is compiled in only for kDepth; the
//     photometric trainers launch kDepth = false.
//
// What bounds it on the H100: like the forward, neither HBM nor f32
// throughput. Per pixel-record evaluation it does ~40 f32 operations and
// three SFU transcendentals (exp of the power, log1p, exp of T_before);
// per record and warp that contributes, ten 5-step shuffle reductions.
// The records are gathered once per tile into shared memory and each
// Gaussian's gradient row receives one atomicAdd per channel and tile
// (the 50 MB L2 holds the N x 64 B gradient at N ~ 44k). The roofline bound
// counts the evaluations (PERF.md); what costs time beyond it is the
// serial dependence through L and S per pixel, the shuffle reductions, and
// a block running as long as its deepest pixel. Skipping a warp's
// reduction when none of its lanes contributes is the design's one
// economy; splitting long lists across warps is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;
constexpr int kChannels = 10;   // mean2d 2, conic 3, rgb 3, opacity, depth
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

template <bool kDepth>
__global__ void __launch_bounds__(kBlock)
blend_bwd_kernel(const float* __restrict__ records, int record_stride,
                 const int* __restrict__ order,
                 const int* __restrict__ rank_sorted,
                 const int* __restrict__ starts,
                 const float* __restrict__ bg,
                 int tiles_x, int width, int height,
                 const float* __restrict__ log_t_final,
                 const float* __restrict__ t_final,
                 const int* __restrict__ last_contrib,
                 const float* __restrict__ g_image,
                 const float* __restrict__ g_depth,
                 const float* __restrict__ g_alpha,
                 float* __restrict__ grad, int grad_stride) {
  __shared__ float2 s_mean[kBlock];
  __shared__ float4 s_conic_opa[kBlock];
  __shared__ float4 s_rgb_depth[kBlock];
  __shared__ int s_gid[kBlock];
  __shared__ float s_acc[kChannels][kBlock];
  __shared__ int s_max_last;

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int tile = blockIdx.x;
  const int px = (tile % tiles_x) * kTile + tid % kTile;
  const int py = (tile / tiles_x) * kTile + tid / kTile;
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const int s0 = starts[tile];

  int last = 0;
  float log_t = 0.0f;   // L: log T after the record being visited
  float g_r = 0.0f, g_g = 0.0f, g_b = 0.0f, g_d = 0.0f, g_tt = 0.0f;
  if (inside) {
    const int pix = py * width + px;
    last = last_contrib[pix];
    log_t = log_t_final[pix];
    g_r = g_image[3 * pix + 0];
    g_g = g_image[3 * pix + 1];
    g_b = g_image[3 * pix + 2];
    if (kDepth) g_d = g_depth[pix];
    const float g_tf = g_r * bg[0] + g_g * bg[1] + g_b * bg[2] - g_alpha[pix];
    g_tt = g_tf * t_final[pix];
  }
  if (tid == 0) s_max_last = 0;
  for (int c = 0; c < kChannels; ++c) s_acc[c][tid] = 0.0f;
  __syncthreads();
  const int warp_last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) atomicMax(&s_max_last, warp_last);
  __syncthreads();
  const int end = s0 + s_max_last;

  float suffix = 0.0f;  // S: sum of gw·w over the included records behind
  for (int batch_end = end; batch_end > s0; batch_end -= kBlock) {
    const int n = min(kBlock, batch_end - s0);
    if (tid < n) {
      // slot j holds list position batch_end - 1 - j: the walk goes back
      const int gid = order[rank_sorted[batch_end - 1 - tid]];
      const float* rec = records + static_cast<size_t>(gid) * record_stride;
      s_gid[tid] = gid;
      s_mean[tid] = make_float2(rec[0], rec[1]);
      s_conic_opa[tid] = make_float4(rec[2], rec[3], rec[4], rec[8]);
      s_rgb_depth[tid] = make_float4(rec[5], rec[6], rec[7], rec[9]);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const int k = batch_end - 1 - j - s0;   // position in the tile's list
      float part[kChannels] = {};
      bool contrib = false;
      if (k < last) {
        const float2 mu = s_mean[j];
        const float4 co = s_conic_opa[j];
        const float dx = mu.x - fx;
        const float dy = mu.y - fy;
        const float power =
            -0.5f * (co.x * dx * dx + co.z * dy * dy) - co.y * dx * dy;
        const float raw = power > 0.0f ? 0.0f : co.w * expf(power);
        if (raw >= kAlphaMin) {
          contrib = true;
          const float alpha = fminf(kAlphaMax, raw);
          const float lo = log1pf(-alpha);
          const float t_before = expf(log_t - lo);
          const float w = t_before * alpha;
          const float4 cd = s_rgb_depth[j];
          float gw = g_r * cd.x + g_g * cd.y + g_b * cd.z;
          if (kDepth) gw += g_d * cd.w;
          const float g_al = gw * t_before - (suffix + g_tt) / (1.0f - alpha);
          suffix += gw * w;
          log_t -= lo;
          const float g_pow = raw > kAlphaMax ? 0.0f : g_al * alpha;
          part[0] = -(co.x * dx + co.y * dy) * g_pow;
          part[1] = -(co.z * dy + co.y * dx) * g_pow;
          part[2] = -0.5f * dx * dx * g_pow;
          part[3] = -dx * dy * g_pow;
          part[4] = -0.5f * dy * dy * g_pow;
          part[5] = g_r * w;
          part[6] = g_g * w;
          part[7] = g_b * w;
          part[8] = g_pow;        // divided by the opacity at the flush
          if (kDepth) part[9] = g_d * w;
        }
      }
      if (__any_sync(0xffffffffu, contrib)) {
#pragma unroll
        for (int c = 0; c < kChannels; ++c) {
          if (c == 9 && !kDepth) continue;
          const float v = warp_sum(part[c]);
          if (lane == 0) atomicAdd(&s_acc[c][j], v);
        }
      }
    }
    __syncthreads();
    if (tid < n) {
      float* out = grad + static_cast<size_t>(s_gid[tid]) * grad_stride;
      const float opa = s_conic_opa[tid].w;
#pragma unroll
      for (int c = 0; c < kChannels; ++c) {
        float v = s_acc[c][tid];
        s_acc[c][tid] = 0.0f;
        if (c == 8) v = fabsf(opa) > 1e-12f ? v / opa : 0.0f;
        if (v != 0.0f) atomicAdd(out + c, v);
      }
    }
    // the next batch overwrites the staged records and the accumulators
    __syncthreads();
  }
}

}  // namespace

// Accumulates into `grad` (zeroed by the caller) on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int d3gs_blend_bwd(const float* records, int record_stride,
                              const int* order, const int* rank_sorted,
                              const int* starts, const float* bg,
                              int tiles_x, int tiles_y, int width, int height,
                              const float* log_t_final, const float* t_final,
                              const int* last_contrib, const float* g_image,
                              const float* g_depth, const float* g_alpha,
                              int depth_grad, float* grad, int grad_stride,
                              void* stream) {
  const int num_tiles = tiles_x * tiles_y;
  if (num_tiles > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (depth_grad) {
      blend_bwd_kernel<true><<<num_tiles, kBlock, 0, s>>>(
          records, record_stride, order, rank_sorted, starts, bg, tiles_x,
          width, height, log_t_final, t_final, last_contrib, g_image,
          g_depth, g_alpha, grad, grad_stride);
    } else {
      blend_bwd_kernel<false><<<num_tiles, kBlock, 0, s>>>(
          records, record_stride, order, rank_sorted, starts, bg, tiles_x,
          width, height, log_t_final, t_final, last_contrib, g_image,
          g_depth, g_alpha, grad, grad_stride);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
