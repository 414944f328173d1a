// One RK4 step of the neural-ODE dynamics net for Hopper (sm_90a), in f32
// on the CUDA cores: y -> y + dt/6 (k1 + 2 k2 + 2 k3 + k4) for every row,
// k_i = f(t_i, y_i) by `DeformNetworkODE` at use_linear 0, use_emb, D 8,
// W 256, skip after layer 4, PE(x, 10) (models/deform/networks.py).
//
// Replaces no TPU kernel: the JAX package leaves the dynamics MLP to XLA
// (dense products and elementwise glue per stage). On the card the same
// split costs ~1,600 launches a viewer frame and a round trip of every
// (N, 256) activation through device memory between them; here the four
// stages of a step run in one launch, and nothing of size (N, 256) leaves
// the SM.
//
// What bounds it on the H100: f32 FFMA issue. A stage is 491,776
// multiply-adds a row (63x256, 4 of 256x256, 319x256 at the skip, 2 of
// 256x256, 256x3); at N = 78,624 a step is 4 x 77.3 GFLOP at 67 TFLOP/s,
// ~4.6 ms. The products run in full f32 (no TF32, no wgmma: f32 has none),
// so the design is about keeping the FFMA pipe fed:
//   * a block owns up to 128 rows for the whole step; the activations of a
//     stage live in shared memory feature-major (Hs[feature][row], rows
//     padded by 4 floats and 16-byte chunks swizzled by the feature, so
//     that the epilogue's stores fall on distinct banks: `act_index`), the
//     current layer's output in registers, written back over Hs after the
//     layer's last product;
//   * the time input is folded into two per-stage bias vectors by the
//     wrapper (c0 = b0 + W0[:, 63:] temb(t), c5 = b5 + W5[:, 63:in] temb(t),
//     one per distinct stage time), so the kernel sees layer 0 as the
//     64-row PE(x) block (63 and a zero row) and the skip layer as one
//     accumulator over PE(x) then h: no concat;
//   * weights stream from L2, packed K-major (1,920 x 256, one slab of 16
//     rows = 16 KB at a time), through a 3-deep cp.async ring; the slab
//     sequence runs across layers and stages, so the next layer's first
//     slab is in flight during an epilogue;
//   * a warp owns 16 rows x 256 columns, a lane 16 rows x 8 columns (128
//     accumulators, columns 4l..4l+3 and 128+4l..128+4l+3): per k, 4
//     broadcast LDS.128 of activations and 2 contiguous LDS.128 of weights
//     feed 128 FFMA (95 % of issue slots). 16 warps of 8 rows ran 11 %
//     slower on the card (128 registers a lane: spills), and scalar weight
//     loads 16 % slower (fewer FFMA per issue slot);
//   * the 256 -> 3 output is reduced from the layer-7 registers by a
//     halving shuffle tree that leaves row r of the warp on lanes 2r and
//     2r + 1, which keep that row's state, k-sum and stage input;
//   * PE(x) in-kernel with full-precision sinf / cosf (no fast-math: at
//     2^9 x 1.3 rad the intrinsics lose digits); the stage arithmetic
//     y + (dt/2) k, y + dt k, ((k1 + 2k2) + 2k3) + k4, y + (dt/6) s with
//     one rounding per operation, as `_rk4_step` computes it.
// Tiles: a block is 8 warps (one per SM: 213 KB of shared memory at 128
// rows, 225 registers a lane), and its time goes with its rows. A launch
// of 128-row tiles in whole waves covers all it can; the rest runs as one
// wave of the smallest tile of 128, 96 (12 rows a warp) or 64 rows whose
// wave holds it. At N = 78,624 that is 4 waves of 128 rows and 115 blocks
// of 96: 4.75 wave-times where 615 blocks of 128 rows took 5 (4.66 waves,
// the last 66 % full).
// The stages, the tiles and the wave planner are ode_rk4_common.cuh's,
// shared with the backward's recompute (ode_rk4_bwd.cu).
#include "ode_rk4_common.cuh"

namespace {

using namespace d3gs_ode;

// rows [row0, row0 + gridDim.x * kBM) of the step, those below n
template <int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
ode_rk4_kernel(const float* __restrict__ y, int row0, int n,
               const float* __restrict__ w, const float* __restrict__ bias,
               const float* __restrict__ tbias,
               const float* __restrict__ w_out,
               const float* __restrict__ b_out, float scale, float h2,
               float h1, float h6, float* __restrict__ y_out) {
  extern __shared__ __align__(16) float smem[];
  const Lane<ROWS> at(row0);
  float y0[3], ks[3];
  rk4_stages<ROWS>(smem, at, y, n, w, bias, tbias, w_out, b_out, scale, h2,
                   h1, y0, ks);
  if (at.keeps && at.part == 0 && at.row < n) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      y_out[3 * at.row + j] = __fadd_rn(y0[j], __fmul_rn(h6, ks[j]));
  }
}

// One launch of ode_rk4_kernel<ROWS> over rows [row0, row0 + rows).
template <int ROWS>
cudaError_t launch(const float* y, int row0, int rows, int n, const float* w,
                   const float* bias, const float* tbias, const float* w_out,
                   const float* b_out, float scale, float h2, float h1,
                   float h6, float* y_out, cudaStream_t stream) {
  using T = Tile<ROWS>;
  const cudaError_t err = cudaFuncSetAttribute(
      ode_rk4_kernel<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int blocks = (rows + T::kBM - 1) / T::kBM;
  ode_rk4_kernel<ROWS><<<blocks, kThreads, T::kSmemBytes, stream>>>(
      y, row0, n, w, bias, tbias, w_out, b_out, scale, h2, h1, h6, y_out);
  return cudaGetLastError();
}

}  // namespace

// One RK4 step of the n rows of y (n x 3, f32) into y_out. w: the packed
// trunk (1,920 x 256, K-major: layer 0's PE(x) rows and a zero row, layers
// 1-4, layer 5's PE(x) rows, a zero row and its h rows, layers 6-7); bias:
// (8, 256), the trunk's biases (rows 0 and 5 unused); tbias: (3, 2, 256),
// c0 and c5 at t, t + dt/2, t + dt; w_out (3 x 256), b_out (3); scale the
// output scale; h2, h1, h6 the stage factors dt/2, dt, dt/6 in f32.
// Whole waves of 128-row blocks, then the rest in one wave of the smallest
// tile that holds it (see "Tiles" above): one or two launches on `stream`.
// Returns the first launch error (0 on success).
extern "C" int d3gs_ode_rk4(const float* y, long long n, const float* w,
                            const float* bias, const float* tbias,
                            const float* w_out, const float* b_out,
                            float scale, float h2, float h1, float h6,
                            float* y_out, void* stream) {
  if (n <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int rows = static_cast<int>(n);
  return static_cast<int>(plan_waves(rows, [&](auto tile, int row0,
                                               int count) {
    return launch<decltype(tile)::kRows>(y, row0, count, rows, w, bias, tbias,
                                         w_out, b_out, scale, h2, h1, h6,
                                         y_out, s);
  }));
}
