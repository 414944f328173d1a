// Tile-blend backward for Hopper (sm_90a): the gradient of the packed blend
// records from the gradients of image, depth and alpha.
//
// Replaces: d3gs_tpu/ops/pallas_blend.py::_bwd_kernel (launched by
// _bwd_pallas) and its XLA epilogue _core_bwd, which on the TPU write
// per-duplicate gradient blocks and reduce them per Gaussian with a sort
// and a segmented cumsum. Here each pixel walks its included records back
// to front from its last one (last_contrib, written by csrc/blend_fwd.cu):
//   * T is carried multiplicatively from the forward's T_final: every
//     included record has T after it >= 1e-4 (the forward's include rule),
//     so T_before = T_after / (1 - alpha) never underflows, and the one
//     reciprocal serves the g_alpha term too;
//   * g_alpha_k = gw_k T_before_k - (S_k + g_tf T_final) / (1 - alpha_k),
//     g_power_k = g_alpha_k alpha_k (0 where alpha was clamped), with
//     gw = g_image·rgb (+ g_depth·depth) and S_k the sum of gw·w behind k;
//   * per record each pixel forms its partials of mean2d (2), conic (3),
//     rgb (3), opacity and depth; the warp sums them over its 32 pixels and
//     adds the sums to the record's row of the (N, 16) gradient with one
//     atomicAdd per channel. That replaces the TPU's sort-and-cumsum
//     epilogue; the atomics make the summation order, and so the last bits,
//     vary from run to run;
//   * the depth cotangent's math is compiled in only for kDepth; the
//     photometric trainers launch kDepth = false.
//
// What bounds it on the H100: like the forward, not HBM and not the f32
// peak, but the instructions issued per (warp, record) visit, ~120 SASS
// instructions at kGroup = 4, of which the sum over pixels was the largest
// share before this design, and how well the visits' chains overlap. The
// design:
//   * work unit a warp (blend_common.cuh): each warp owns a 16x2 strip and
//     walks back from its own largest last_contrib, not the tile's;
//   * per-warp cull (`rows_hit`): the warp visits only the records whose
//     1/255 ellipse reaches its strip; the others add nothing to its sums;
//   * the sum over pixels is a reduce-scatter across the warp
//     (warp_transpose_sum): kGroup records' 8 main channels take
//     8·kGroup - 1 shuffles instead of 40·kGroup, opacity and depth one
//     more transposed sum, and the totals land on different lanes, so one
//     atomicAdd instruction writes a whole row; no shared accumulator, no
//     contended shared atomics, no block barrier;
//   * staging as in the forward: three 16-byte loads per record through the
//     wrapper's gid, the next chunk's loads issued before the walk; 1 /
//     opacity computed there, once per record and strip;
//   * hits are walked kGroup at a time without a branch inside the group
//     (the exp is not skipped for power > 0, the reciprocal is a refined
//     approximate one, not a rounded division with its slow path): their
//     exps, reciprocals, partials and sums interleave, only the T and S
//     chains run in order.

#include "blend_common.cuh"

namespace {

using namespace d3gs_blend;

constexpr int kWarps = 2;   // warps (strips) per block
constexpr int kGroup = 4;   // hits evaluated together
constexpr int kBlocksPerTile = kWarpsPerTile / kWarps;
static_assert(kWarpsPerTile % kWarps == 0, "a block holds whole strips");
static_assert(kGroup == 1 || kGroup == 2 || kGroup == 4, "kGroup: 1, 2, 4");

template <bool kDepth>
__global__ void __launch_bounds__(kWarps * 32)
blend_bwd_kernel(const float* __restrict__ records, int record_stride,
                 const int* __restrict__ gid,
                 const int* __restrict__ starts,
                 const float* __restrict__ bg,
                 int tiles_x, int tile_y0, int width, int height,
                 const float* __restrict__ t_final,
                 const int* __restrict__ last_contrib,
                 const float* __restrict__ g_image,
                 const float* __restrict__ g_depth,
                 const float* __restrict__ g_alpha,
                 float* __restrict__ grad, int grad_stride) {
  // the channels' sums: kM main values (8 per record: mean2d, conic, rgb)
  // and kE extras (opacity per record, then depth per record)
  constexpr int kM = 8 * kGroup;
  constexpr int kE = kDepth ? 2 * kGroup : kGroup;
  constexpr int kLanesM = 32 / kM;   // lanes that end with one main total
  constexpr int kLanesE = 32 / kE;
  __shared__ Record s_rec[kWarps][32];

  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int tile = static_cast<int>(blockIdx.x) / kBlocksPerTile;
  const int strip =
      static_cast<int>(blockIdx.x) % kBlocksPerTile * kWarps + warp;
  const int tx0 = (tile % tiles_x) * kTile;
  // the strip's first row in the output buffer, which holds the tile rows
  // [tile_y0, tile_y0 + tiles_y) of the image: `py` indexes and masks the
  // buffer, the image row `gy0 + lane / 16` places the pixel centre
  const int ty0 = (tile / tiles_x) * kTile + 2 * strip;
  const int gy0 = ty0 + tile_y0 * kTile;
  const int px = tx0 + (lane & 15);
  const int py = ty0 + (lane >> 4);
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(gy0 + (lane >> 4));
  const float x0 = static_cast<float>(tx0);
  const float y0 = static_cast<float>(gy0);
  const int s0 = starts[tile];
  Record* rec = s_rec[warp];

  // which total this lane adds to the gradient after a group's sums
  const int m_idx = lane / kLanesM;
  const bool m_lead = lane % kLanesM == 0;
  const int m_rec = m_idx >> 3;   // record of the group
  const int m_ch = m_idx & 7;     // channel 0-7 of the row
  // signs and halves of the partials, applied to the totals
  const float m_scale =
      m_ch >= 5 ? 1.0f : ((m_ch == 2 || m_ch == 4) ? -0.5f : -1.0f);
  const int e_idx = lane / kLanesE;
  const bool e_lead = lane % kLanesE == kLanesE - 1;
  const int e_rec = e_idx % kGroup;
  const int e_ch = e_idx < kGroup ? 8 : 9;

  int last = 0;
  float t_after = 0.0f;   // T after the record being visited
  float g_r = 0.0f, g_g = 0.0f, g_b = 0.0f, g_d = 0.0f, g_tt = 0.0f;
  if (inside) {
    const int pix = py * width + px;
    last = last_contrib[pix];
    t_after = t_final[pix];
    g_r = g_image[3 * pix + 0];
    g_g = g_image[3 * pix + 1];
    g_b = g_image[3 * pix + 2];
    if (kDepth) g_d = g_depth[pix];
    const float g_tf = g_r * bg[0] + g_g * bg[1] + g_b * bg[2] - g_alpha[pix];
    g_tt = g_tf * t_after;
  }
  const int end = s0 + __reduce_max_sync(kFull, last);
  float suffix = 0.0f;  // S: sum of gw·w over the included records behind

  // chunk c holds list positions end - 1 - 32c - lane: the walk goes back
  int g = gid_at(gid, end - 1 - lane, s0, end);
  Record cur = {};
  if (g >= 0) cur = load_record(records, record_stride, g);
  int g_next = gid_at(gid, end - 33 - lane, s0, end);
  for (int top = end; top > s0; top -= 32) {
    unsigned hits = __ballot_sync(kFull, g >= 0 && rows_hit(cur, x0, y0));
    // 1 / opacity for the opacity channel, once per record and strip
    cur.q2.w = fabsf(cur.q2.x) > 1e-12f ? 1.0f / cur.q2.x : 0.0f;
    rec[lane] = cur;
    __syncwarp();
    // the next chunk's loads are issued now and consumed after the walk
    Record nxt = {};
    if (g_next >= 0) nxt = load_record(records, record_stride, g_next);
    const int g_after = gid_at(gid, top - 65 - lane, s0, end);

    while (hits != 0u) {
      float v[kM], e[kE];
      int row[kGroup];
      float inv_opa[kGroup];
      bool any = false;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const bool has = hits != 0u;
        const int j = has ? __ffs(hits) - 1 : 0;
        hits &= hits - 1u;
        const int k = top - 1 - j - s0;   // position in the tile's list
        const float4 q0 = rec[j].q0;
        const float4 q1 = rec[j].q1;
        const float4 q2 = rec[j].q2;
        row[u] = __float_as_int(q2.z);
        inv_opa[u] = q2.w;
        const float dx = q0.x - fx;
        const float dy = q0.y - fy;
        const float power = gauss_power(q0, q1, dx, dy);
        // no branch around the exp, so that a group's evaluations interleave
        const float raw = q2.x * expf(power);
        const bool ok = has && k < last && !(power > 0.0f) && raw >= kAlphaMin;
        const float alpha = ok ? fminf(kAlphaMax, raw) : 0.0f;
        // 1 / (1 - alpha), 1 - alpha in [0.01, 1]: the approximate reciprocal
        // and one Newton step, without the slow-path branch of a rounded
        // division; its error would compound along the T chain
        const float om = 1.0f - alpha;
        float rcp = __fdividef(1.0f, om);
        rcp = fmaf(rcp, fmaf(-om, rcp, 1.0f), rcp);
        float gw = g_r * q1.y + g_g * q1.z + g_b * q1.w;
        if (kDepth) gw += g_d * q2.y;
        // the T and S chains: the only dependence between records
        const float t_before = t_after * rcp;
        const float w = ok ? t_before * alpha : 0.0f;
        const float g_al = gw * t_before - (suffix + g_tt) * rcp;
        if (ok) {
          suffix += gw * w;
          t_after = t_before;
        }
        const float gp = (ok && !(raw > kAlphaMax)) ? g_al * alpha : 0.0f;
        v[8 * u + 0] = (q0.z * dx + q0.w * dy) * gp;
        v[8 * u + 1] = (q1.x * dy + q0.w * dx) * gp;
        v[8 * u + 2] = dx * dx * gp;
        v[8 * u + 3] = dx * dy * gp;
        v[8 * u + 4] = dy * dy * gp;
        v[8 * u + 5] = g_r * w;
        v[8 * u + 6] = g_g * w;
        v[8 * u + 7] = g_b * w;
        e[u] = gp;
        if (kDepth) e[kGroup + u] = g_d * w;
        any = any || ok;
      }
      if (!__any_sync(kFull, any)) continue;
      const float sm = warp_transpose_sum<kM>(v, lane);
      const float se = warp_transpose_sum<kE>(e, lane);
      int m_row = row[0], e_row = row[0];
      float e_inv = inv_opa[0];
#pragma unroll
      for (int u = 1; u < kGroup; ++u) {
        if (m_rec == u) m_row = row[u];
        if (e_rec == u) {
          e_row = row[u];
          e_inv = inv_opa[u];
        }
      }
      const float vm = sm * m_scale;
      if (m_lead && vm != 0.0f) {
        atomicAdd(grad + static_cast<size_t>(m_row) * grad_stride + m_ch, vm);
      }
      const float ve = e_ch == 8 ? se * e_inv : se;
      if (e_lead && ve != 0.0f) {
        atomicAdd(grad + static_cast<size_t>(e_row) * grad_stride + e_ch, ve);
      }
    }
    __syncwarp();   // the walk's reads before the next chunk's writes
    cur = nxt;
    g = g_next;
    g_next = g_after;
  }
}

}  // namespace

// Accumulates into `grad` (zeroed by the caller) on `stream` and returns
// cudaGetLastError() (0 on success). `gid` (M,) is order[rank_sorted]. The
// buffers (height x width) hold the tile rows [tile_y0, tile_y0 + tiles_y)
// of the image: tile_y0 = 0 for a whole frame, a strip's first tile row
// for a tile-row-sharded render (d3gs_tpu_torch/parallel/sharded.py).
extern "C" int d3gs_blend_bwd(const float* records, int record_stride,
                              const int* gid, const int* starts,
                              const float* bg, int tiles_x, int tiles_y,
                              int width, int height, int tile_y0,
                              const float* t_final, const int* last_contrib,
                              const float* g_image, const float* g_depth,
                              const float* g_alpha,
                              int depth_grad, float* grad, int grad_stride,
                              void* stream) {
  const int num_tiles = tiles_x * tiles_y;
  if (num_tiles > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int blocks = num_tiles * kBlocksPerTile;
    if (depth_grad) {
      blend_bwd_kernel<true><<<blocks, kWarps * 32, 0, s>>>(
          records, record_stride, gid, starts, bg, tiles_x, tile_y0, width,
          height, t_final, last_contrib, g_image, g_depth, g_alpha, grad,
          grad_stride);
    } else {
      blend_bwd_kernel<false><<<blocks, kWarps * 32, 0, s>>>(
          records, record_stride, gid, starts, bg, tiles_x, tile_y0, width,
          height, t_final, last_contrib, g_image, g_depth, g_alpha, grad,
          grad_stride);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
