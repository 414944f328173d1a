// Tile-blend forward for Hopper (sm_90a): front-to-back alpha compositing of
// each 16x16 tile's depth-sorted duplicate list.
//
// Replaces: d3gs_tpu/ops/pallas_blend.py::_fwd_kernel (launched by
// _fwd_pallas), the TPU kernel that walks 128-record blocks per tile with
// MXU prefix scans. This kernel computes the same function per pixel with
// the Pallas kernel's alpha rules: power = -0.5(a dx² + c dy²) - b dx dy,
// skipped if power > 0; alpha = min(0.99, opa e^power), skipped if < 1/255;
// log T = Σ log1p(-alpha) over the included records, and a record is
// included iff exp(log T after it) >= 1e-4 (full-precision expf and
// log1pf, summed in list order: this decision is never approximated). The
// first record that fails marks the pixel done.
//
// Per pixel it writes the image composed with bg, the expected depth,
// alpha = 1 - T_final, T_final, log T_final, the number of records walked
// (the failing record included) and, for the backward (csrc/blend_bwd.cu),
// last_contrib: the index + 1 in the tile's list of the last record the
// pixel included (0 if none).
//
// What bounds it on the H100: not HBM (the ~40-byte records of a tile's
// list are gathered from the L2, which holds the N-row table) and not the
// f32 or SFU peak (the roofline bound is under a tenth of the time), but
// the instructions issued per (warp, record) visit, ~85 SASS instructions
// (the exp of the power, the log1p, the exp of log T, the bookkeeping),
// and how well the schedulers overlap the visits' serial chains. The design:
//   * work unit a warp, not a tile: each warp owns a 16x2 pixel strip
//     (blend_common.cuh) and walks the list alone, so it stops when its own
//     32 pixels are saturated; 64-thread blocks (a quarter tile);
//   * per-warp cull: a chunk of 32 records is tested against the strip,
//     one record per lane (`rows_hit`), and the warp visits only the hits;
//     a skipped record has alpha < 1/255 at every pixel of the strip, so
//     the result is unchanged (n_walked still counts list positions);
//   * staging without a stall: each record is three 16-byte loads through
//     gid = order[rank_sorted] (resolved once by the wrapper), and the next
//     chunk's loads are issued before the current chunk is walked;
//   * a branch-free walk, kGroup hits at a time: the exps and log1ps of a
//     group are independent, the log-T sum runs in order and the include
//     decisions are selects, so a group is one basic block whose
//     evaluations the compiler interleaves (log1p_neg in blend_common.cuh:
//     the library's log1pf ends in a branch), with one branch per group,
//     the warp's all-done vote.

#include "blend_common.cuh"

namespace {

using namespace d3gs_blend;

constexpr int kWarps = 2;   // warps (strips) per block
constexpr int kGroup = 2;   // hits evaluated together
constexpr int kBlocksPerTile = kWarpsPerTile / kWarps;
constexpr float kTransEps = 1e-4f;
static_assert(kWarpsPerTile % kWarps == 0, "a block holds whole strips");

__global__ void __launch_bounds__(kWarps * 32)
blend_fwd_kernel(const float* __restrict__ records, int record_stride,
                 const int* __restrict__ gid,
                 const int* __restrict__ starts,
                 const float* __restrict__ bg,
                 int tiles_x, int tile_y0, int width, int height,
                 float* __restrict__ image, float* __restrict__ depth,
                 float* __restrict__ alpha_out, float* __restrict__ t_final,
                 float* __restrict__ log_t_final,
                 int* __restrict__ n_walked, int* __restrict__ last_contrib) {
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
  const int s1 = starts[tile + 1];
  Record* rec = s_rec[warp];

  float log_t = 0.0f;   // log T after the last included record
  float trans = 1.0f;   // exp(log_t)
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  int walked = s1 - s0;
  int last = 0;
  bool done = !inside;

  // chunk c holds list positions s0 + 32c + lane
  int g = gid_at(gid, s0 + lane, s0, s1);
  Record cur = {};
  if (g >= 0) cur = load_record(records, record_stride, g);
  int g_next = gid_at(gid, s0 + 32 + lane, s0, s1);
  for (int base = s0; base < s1; base += 32) {
    if (__all_sync(kFull, done)) break;
    unsigned hits = __ballot_sync(kFull, g >= 0 && rows_hit(cur, x0, y0));
    rec[lane] = cur;
    __syncwarp();
    // the next chunk's loads are issued now and consumed after the walk
    Record nxt = {};
    if (g_next >= 0) nxt = load_record(records, record_stride, g_next);
    const int g_after = gid_at(gid, base + 64 + lane, s0, s1);

    while (hits != 0u) {
      int k[kGroup];
      bool ok[kGroup];
      float al[kGroup], lo[kGroup], cr[kGroup], cg[kGroup], cb[kGroup],
          cd[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const bool has = hits != 0u;
        const int j = has ? __ffs(hits) - 1 : 0;
        hits &= hits - 1u;
        k[u] = base - s0 + j;
        const float4 q0 = rec[j].q0;
        const float4 q1 = rec[j].q1;
        const float opa = rec[j].q2.x;
        const float dx = q0.x - fx;
        const float dy = q0.y - fy;
        const float power = gauss_power(q0, q1, dx, dy);
        const float raw = opa * expf(power);
        ok[u] = has && !done && !(power > 0.0f) && !(raw < kAlphaMin);
        al[u] = ok[u] ? fminf(kAlphaMax, raw) : 0.0f;
        lo[u] = log1p_neg(al[u]);
        cr[u] = q1.y;
        cg[u] = q1.z;
        cb[u] = q1.w;
        cd[u] = rec[j].q2.y;
      }
      // log T after each candidate, the earlier candidates included
      float ln[kGroup], tn[kGroup];
      float l = log_t;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        ln[u] = l + lo[u];
        l = ok[u] ? ln[u] : l;
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) tn[u] = expf(ln[u]);
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const bool live = ok[u] && !done;
        const bool fail = live && tn[u] < kTransEps;
        const bool inc = live && !fail;
        const float w = inc ? trans * al[u] : 0.0f;
        acc_r += w * cr[u];
        acc_g += w * cg[u];
        acc_b += w * cb[u];
        acc_d += w * cd[u];
        walked = fail ? k[u] + 1 : walked;
        last = inc ? k[u] + 1 : last;
        log_t = inc ? ln[u] : log_t;
        trans = inc ? tn[u] : trans;
        done = done || fail;
      }
      if (__all_sync(kFull, done)) break;
    }
    __syncwarp();   // the walk's reads before the next chunk's writes
    cur = nxt;
    g = g_next;
    g_next = g_after;
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
// `gid` (M,) is order[rank_sorted]: the Gaussian of each sorted duplicate.
// The outputs (height x width) hold the tile rows [tile_y0, tile_y0 +
// tiles_y) of the image: tile_y0 = 0 for a whole frame, a strip's first
// tile row for a tile-row-sharded render (d3gs_tpu_torch/parallel/).
extern "C" int d3gs_blend_fwd(const float* records, int record_stride,
                              const int* gid, const int* starts,
                              const float* bg, int tiles_x, int tiles_y,
                              int width, int height, int tile_y0,
                              float* image, float* depth, float* alpha,
                              float* t_final, float* log_t_final,
                              int* n_walked, int* last_contrib,
                              void* stream) {
  const int num_tiles = tiles_x * tiles_y;
  if (num_tiles > 0) {
    blend_fwd_kernel<<<num_tiles * kBlocksPerTile, kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        records, record_stride, gid, starts, bg, tiles_x, tile_y0, width,
        height, image, depth, alpha, t_final, log_t_final, n_walked,
        last_contrib);
  }
  return static_cast<int>(cudaGetLastError());
}
