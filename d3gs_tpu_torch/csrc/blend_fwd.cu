// Tile-blend forward for Hopper (sm_90a): front-to-back alpha compositing of
// each 16x16 tile's depth-sorted duplicate list.
//
// Replaces: d3gs_tpu/ops/pallas_blend.py::_fwd_kernel (launched by
// _fwd_pallas), the TPU kernel that walks 128-record blocks per tile with
// MXU prefix scans. This kernel computes the same function with the
// reference rasterizer's renderCUDA structure instead:
//   * one 256-thread block per tile, one thread per pixel;
//   * the tile's records [starts[t], starts[t+1]) are staged in shared
//     memory in cooperative batches of 256, each thread gathering one record
//     through order[rank_sorted[m]] (10 live fields of the packed row);
//   * each pixel walks the batch in depth order with the Pallas kernel's
//     alpha rules: power = -0.5(a dx² + c dy²) - b dx dy, skipped if
//     power > 0; alpha = min(0.99, opa e^power), skipped if < 1/255;
//   * each pixel carries log T (the sum of log1p(-alpha), as the TPU kernel
//     does) and includes a record iff exp(log T after it) >= 1e-4; the first
//     record that fails marks the pixel done. The block leaves once
//     __syncthreads_count(done) == 256.
//
// Per pixel it writes the image composed with bg, the expected depth,
// alpha = 1 - T_final, T_final, log T_final, the number of records walked
// (the failing record included) and, for the backward (csrc/blend_bwd.cu),
// last_contrib: the index + 1 in the tile's list of the last record the
// pixel included (0 if none). n_walked alone cannot tell whether the last
// walked record was included (the list ran out after it) or failed.
//
// What bounds it on the H100: neither HBM nor f32 throughput at the bench
// scene. Per pixel-record evaluation it does ~15 f32 operations and two to
// three transcendentals (exp, log1p, exp) from the SFU, and it reads each
// duplicate's 40-byte record once per tile (a gather: order[rank] points
// anywhere in the N-row table, which stays in the 50 MB L2 at N ~ 44k). The
// roofline bound is set by the evaluations (see PERF.md); what costs time
// beyond it is latency: one pixel's walk is a serial dependence chain
// through log T, and a tile's block runs as long as its slowest pixel. The
// design keeps everything per pixel in registers, broadcasts each record
// from shared memory to all 256 threads without bank conflicts, and stops a
// tile as soon as every pixel is saturated. Splitting long lists across
// warps, and staging the next batch while the current one is blended, are
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTransEps = 1e-4f;

__global__ void __launch_bounds__(kBlock)
blend_fwd_kernel(const float* __restrict__ records, int record_stride,
                 const int* __restrict__ order,
                 const int* __restrict__ rank_sorted,
                 const int* __restrict__ starts,
                 const float* __restrict__ bg,
                 int tiles_x, int width, int height,
                 float* __restrict__ image, float* __restrict__ depth,
                 float* __restrict__ alpha_out, float* __restrict__ t_final,
                 float* __restrict__ log_t_final,
                 int* __restrict__ n_walked, int* __restrict__ last_contrib) {
  __shared__ float2 s_mean[kBlock];
  __shared__ float4 s_conic_opa[kBlock];
  __shared__ float4 s_rgb_depth[kBlock];

  const int tile = blockIdx.x;
  const int px = (tile % tiles_x) * kTile + static_cast<int>(threadIdx.x) % kTile;
  const int py = (tile / tiles_x) * kTile + static_cast<int>(threadIdx.x) / kTile;
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const int s0 = starts[tile];
  const int s1 = starts[tile + 1];

  float log_t = 0.0f;   // log T after the last included record
  float trans = 1.0f;   // exp(log_t)
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  int walked = 0;
  int last = 0;
  bool done = !inside;

  for (int base = s0; base < s1; base += kBlock) {
    // barrier: also orders the previous batch's reads before these writes
    if (__syncthreads_count(done) == kBlock) break;
    const int m = base + static_cast<int>(threadIdx.x);
    if (m < s1) {
      const float* rec =
          records + static_cast<size_t>(order[rank_sorted[m]]) * record_stride;
      s_mean[threadIdx.x] = make_float2(rec[0], rec[1]);
      s_conic_opa[threadIdx.x] = make_float4(rec[2], rec[3], rec[4], rec[8]);
      s_rgb_depth[threadIdx.x] = make_float4(rec[5], rec[6], rec[7], rec[9]);
    }
    __syncthreads();
    const int n = min(kBlock, s1 - base);
    for (int j = 0; !done && j < n; ++j) {
      ++walked;
      const float2 mu = s_mean[j];
      const float4 co = s_conic_opa[j];
      const float dx = mu.x - fx;
      const float dy = mu.y - fy;
      const float power = -0.5f * (co.x * dx * dx + co.z * dy * dy) - co.y * dx * dy;
      if (power > 0.0f) continue;
      const float raw = co.w * expf(power);
      if (raw < kAlphaMin) continue;
      const float alpha = fminf(kAlphaMax, raw);
      const float log_next = log_t + log1pf(-alpha);
      const float t_next = expf(log_next);
      if (t_next < kTransEps) {
        done = true;
        break;
      }
      const float w = trans * alpha;
      const float4 cd = s_rgb_depth[j];
      acc_r += w * cd.x;
      acc_g += w * cd.y;
      acc_b += w * cd.z;
      acc_d += w * cd.w;
      log_t = log_next;
      trans = t_next;
      last = walked;
    }
  }

  if (!inside) return;
  const int pix = py * width + px;
  image[3 * pix + 0] = acc_r + trans * bg[0];
  image[3 * pix + 1] = acc_g + trans * bg[1];
  image[3 * pix + 2] = acc_b + trans * bg[2];
  depth[pix] = acc_d;
  alpha_out[pix] = 1.0f - trans;
  t_final[pix] = trans;
  log_t_final[pix] = log_t;
  n_walked[pix] = walked;
  last_contrib[pix] = last;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int d3gs_blend_fwd(const float* records, int record_stride,
                              const int* order, const int* rank_sorted,
                              const int* starts, const float* bg,
                              int tiles_x, int tiles_y, int width, int height,
                              float* image, float* depth, float* alpha,
                              float* t_final, float* log_t_final,
                              int* n_walked, int* last_contrib,
                              void* stream) {
  const int num_tiles = tiles_x * tiles_y;
  if (num_tiles > 0) {
    blend_fwd_kernel<<<num_tiles, kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        records, record_stride, order, rank_sorted, starts, bg, tiles_x,
        width, height, image, depth, alpha, t_final, log_t_final, n_walked,
        last_contrib);
  }
  return static_cast<int>(cudaGetLastError());
}
