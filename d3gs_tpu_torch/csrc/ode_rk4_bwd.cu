// The vector-Jacobian product of one RK4 step of the neural-ODE dynamics
// net for Hopper (sm_90a), in f32 on the CUDA cores: for y (n x 3), host
// times t, dt and the cotangent g of y_out = y + dt/6 (k1 + 2 k2 + 2 k3 +
// k4), dL/dy and the gradients of the net's weights and biases, the net
// being csrc/ode_rk4.cu's (`DeformNetworkODE` at use_linear 0, use_emb,
// D 8, W 256, skip after layer 4, PE(x, 10), the time input folded into
// the per-stage bias vectors c0 and c5).
//
// Replaces no TPU kernel: the JAX package leaves the dynamics MLP and its
// gradient to XLA. On the card the backward of a fused step was the plain
// step run again under autograd and its graph's VJPs: ~400 launches a
// step (cuBLAS f32 products, ReLU masks, bias-gradient reductions, the
// stage glue), every (N, 256) activation and gradient through device
// memory between them.
//
// What bounds it on the H100: f32 FFMA issue, three times the forward's
// multiply-adds (the 4 stages again, the input-side products through all
// 8 layers, the weight-side products): 3 x 309 GFLOP at N = 78,624, 13.9
// ms at 67 TFLOP/s. Three passes, each a product that keeps the FFMA pipe
// fed as ode_rk4_kernel does (a lane owns 16 rows x 8 columns, 128
// accumulators; per k, 4 broadcast LDS.128 and 2 contiguous LDS.128 feed
// 128 FFMA; one block of 8 warps an SM):
//   * `ode_rk4_recompute_kernel`: the four stages again exactly as
//     ode_rk4_kernel runs them (the same tiles, cp.async weight ring and
//     arithmetic), each layer's output stored to a scratch of device
//     memory (f32, stage-major, for the third pass), PE(x) beside it, and
//     each ReLU's mask kept as bits (a 16-byte word of a lane's 128
//     outputs);
//   * `ode_rk4_sweep_kernel`: the reverse sweep, stages 4 -> 1 and layers
//     7 -> 0, the same product on the gradient at a layer's output
//     (feature-major in shared memory) against the layer's weights in
//     their out-major packing, streamed through the same ring; a layer's
//     mask word is read as its product starts, so no load waits after it.
//     The two PE(x) blocks (64 columns) run as a narrow product, 2
//     columns a lane; dL/dy follows through PE's exact derivatives (the
//     forward's sinf and cosf, read back from the scratch) and the RK4
//     adjoint, which stays within a row. The gradient at each layer's
//     output goes to a second scratch; its column sums (the biases'
//     gradients) and the output layer's gradient are summed per block
//     from shared memory, in a fixed order. A kernel of its own, not the
//     recompute's tail, so that each pass has its own registers (the
//     sweep takes 255): 2 % faster than the two in one kernel;
//   * `ode_rk4_wgrad_kernel`: dW_l = sum over the 4 stages and n rows of
//     delta_l^T h_l, a 256 x 256 product (256 x 64 for the PE(x) blocks)
//     over K = 4n, split over K into a fixed number of blocks a layer (a
//     quarter as many for the PE(x) blocks, so that every block does the
//     same work), K-slabs of both operands through a 4-deep cp.async
//     ring; then `sum_partials` adds the splits in their order. No float
//     atomics anywhere: the same inputs give the same bits, run to run.
// PE(x) with full-precision sinf / cosf, no fast-math; products by fmaf,
// everything else one rounding per operation (no TF32, no bf16, no wgmma).
// Tiles as csrc/ode_rk4.cu: whole waves of 128-row blocks, the rest as one
// wave of the smallest tile of 128, 96 or 64 rows that holds it. Scratch
// at N = 78,624: 2.66 GB of layer outputs, 2.58 GB of gradients. The
// tiles, the ring, the 16-row product, the reductions, the wave planner
// and the recompute's stage loop (`rk4_stages`, the forward's own) are in
// ode_rk4_common.cuh; the scratch's layout (`Place`), the sweep's row
// helpers and the weight-gradient pass in bwd_common.cuh, which the
// deformation MLP's backward (mlp_field.cu) shares.
#include "bwd_common.cuh"

namespace {

using namespace d3gs_ode;

constexpr int kXK = kWide / kXRows;             // k rows of a PE(x) slab
constexpr int kPartRows = 12;                   // see d3gs_ode_rk4_bwd

// Shared memory of the recompute and the sweep at ROWS rows a warp: the
// forward's (Hs; Xs, the stash of the PE(x) gradient in the sweep; the
// ring) and the scaled output cotangents of the block's rows.
template <int ROWS>
constexpr int smem_bytes() {
  using T = Tile<ROWS>;
  static_assert(2 * ROWS * kThreads <= kXRows * T::kStride, "Xs holds stash");
  static_assert(ROWS * kCols <= 128, "a lane's mask fits 4 words");
  static_assert(T::kSmemBytes + 4 * 3 * T::kBM <= 232448,
                "fits one SM's shared memory");
  return T::kSmemBytes + 4 * 3 * T::kBM;
}

// the narrow product: acc[r][c] += act[k0 + k][m0 + r] * wt[k][2 lane + c]
// over a slab of 64 k and 64 columns
template <int ROWS>
__device__ __forceinline__ void slab_fma_x(const float* __restrict__ act,
                                           int k0, int m0,
                                           const float* __restrict__ wt,
                                           int lane, float (&acc)[ROWS][2]) {
#pragma unroll 16
  for (int k = 0; k < kXK; ++k) {
    float av[ROWS];
    load_act<ROWS>(act, k0 + k, m0, av);
    const float2 b = *reinterpret_cast<const float2*>(wt + k * kXRows +
                                                      2 * lane);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      acc[r][0] = fmaf(av[r], b.x, acc[r][0]);
      acc[r][1] = fmaf(av[r], b.y, acc[r][1]);
    }
  }
}

// The four stages again, as ode_rk4_kernel runs them (`rk4_stages`),
// keeping each layer's input and output and the ReLU masks.
template <int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
ode_rk4_recompute_kernel(const float* __restrict__ y, int row0, int n,
                         int blk0, const float* __restrict__ w,
                         const float* __restrict__ bias,
                         const float* __restrict__ tbias,
                         const float* __restrict__ w_out,
                         const float* __restrict__ b_out, float scale,
                         float h2, float h1, float* __restrict__ acts,
                         uint4* __restrict__ masks) {
  extern __shared__ __align__(16) float smem[];
  const Place<ROWS, kStages> at(row0, n, blk0, acts, nullptr, masks);
  float y0[3], ks[3];
  rk4_stages<ROWS>(smem, at, y, n, w, bias, tbias, w_out, b_out, scale, h2,
                   h1, y0, ks);
}

// The reverse sweep, stages 4 -> 1 and layers 7 -> 0, over what
// ode_rk4_recompute_kernel kept.
template <int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
ode_rk4_sweep_kernel(const float* __restrict__ gout, int row0, int n,
                     int blk0, const float* __restrict__ wt,
                     const float* __restrict__ w_out, float scale, float h2,
                     float h1, float h6, float* __restrict__ acts,
                     float* __restrict__ deltas, uint4* __restrict__ masks,
                     float* __restrict__ part, float* __restrict__ gy) {
  using T = Tile<ROWS>;
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                               // [256][kStride]
  float* stash = smem + kW * T::kStride;          // dL/dPE(x) from layer 5
  float* ring = smem + (kW + kXRows) * T::kStride;  // [kRing][16][256]
  float* gks = ring + kRing * kWide;              // [kBM][3]
  const Place<ROWS, kStages> at(row0, n, blk0, acts, deltas, masks);
  const int tid = at.tid, lane = at.lane, m0 = at.m0, first = at.first;
  const int row = at.row, my_row = at.my_row, part_ = at.part;
  const bool keeps = at.keeps;
  float* my_part =
      part + static_cast<long long>(at.blk) * kStages * kPartRows * kW;

  int g = 0;                                      // slab of the sequence
  start_ring(ring, wt, tid);
  float acc[ROWS][kCols];

  // The row's cotangents live on its lanes: gyv (dL/dy), c1 = dt/6 g (k1's
  // and k4's share of the output), gprev (the stage after's dL/dy_i)
  float gyv[3], c1[3], gprev[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    gyv[j] = keeps && row < n ? gout[3 * row + j] : 0.f;
    c1[j] = __fmul_rn(h6, gyv[j]);
  }
  for (int s = kStages - 1; s >= 0; --s) {
    float* p = my_part + s * kPartRows * kW;
    if (keeps && part_ == 0) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        // dL/dk_s: k4 c1, k3 2 c1 + dt gy_4, k2 2 c1 + dt/2 gy_3,
        // k1 c1 + dt/2 gy_2
        const float base = (s == 0 || s == 3) ? c1[j] : __fmul_rn(2.f, c1[j]);
        const float gk = s == 3 ? base
                                : __fadd_rn(base, __fmul_rn(s == 2 ? h1 : h2,
                                                            gprev[j]));
        gks[3 * my_row + j] = __fmul_rn(scale, gk);
      }
    }
    // h8 of the lane's rows
    {
      const float* src = at.act_h(kLayers, s);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
        if (first + r < n) {
          a = *reinterpret_cast<const float4*>(src + r * kW + 4 * lane);
          b = *reinterpret_cast<const float4*>(src + r * kW + 128 + 4 * lane);
        }
        acc[r][0] = a.x, acc[r][1] = a.y, acc[r][2] = a.z, acc[r][3] = a.w;
        acc[r][4] = b.x, acc[r][5] = b.y, acc[r][6] = b.z, acc[r][7] = b.w;
      }
    }
    __syncthreads();                              // Hs free, gks written
    to_hs<ROWS>(hs, m0, lane, acc);
    // the gradient at layer 7's output: (gk scale) W_out, masked
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = col_of(lane, c);
      const float wo0 = __ldg(w_out + col), wo1 = __ldg(w_out + kW + col),
                  wo2 = __ldg(w_out + 2 * kW + col);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float* gr = gks + 3 * (m0 + r);
        float v = gr[0] * wo0;
        v = fmaf(gr[1], wo1, v);
        v = fmaf(gr[2], wo2, v);
        acc[r][c] = acc[r][c] > 0.f ? v : 0.f;
      }
    }
    __syncthreads();                              // h8 in Hs
    {
      // dW_out[j][tid] and db_out over the block's rows
      const float* a = hs + tid * T::kStride;
      float d0 = 0.f, d1 = 0.f, d2 = 0.f, e0 = 0.f, e1 = 0.f, e2 = 0.f;
      for (int q = 0; q < T::kBM / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(a + 4 * (q ^ ((tid >> 3) & 3)));
        const float hv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* gr = gks + 3 * (4 * q + i);
          d0 = fmaf(gr[0], hv[i], d0);
          d1 = fmaf(gr[1], hv[i], d1);
          d2 = fmaf(gr[2], hv[i], d2);
          e0 += gr[0];
          e1 += gr[1];
          e2 += gr[2];
        }
      }
      p[kLayers * kW + tid] = d0;
      p[(kLayers + 1) * kW + tid] = d1;
      p[(kLayers + 2) * kW + tid] = d2;
      p[(kLayers + 3) * kW + tid] =
          tid == 0 ? e0 : (tid == 1 ? e1 : (tid == 2 ? e2 : 0.f));
    }
    __syncthreads();                              // every read of h8 done
    to_hs<ROWS>(hs, m0, lane, acc);
    store_rows<ROWS>(at.delta(kLayers - 1, s), first, n, lane, acc);
    __syncthreads();
    p[(kLayers - 1) * kW + tid] = row_sum<ROWS>(hs, tid);

    // layers 7 ... 1: the gradient at layer l's input, masked by ReLU,
    // is the gradient at layer l - 1's output
    for (int l = kLayers - 1; l >= 1; --l) {
      const uint4 mk = at.mask(l - 1, s);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
      if (l == 5) {                               // dL/dPE(x) += d5 W5x
        float ax[ROWS][2];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) ax[r][0] = ax[r][1] = 0.f;
        for (int e = g + kW / kXK; g < e; ++g) {
          const float* b = next_slab(ring, wt, g, tid);
          slab_fma_x<ROWS>(hs, (kW / kXK - (e - g)) * kXK, m0, b, lane, ax);
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          stash[(2 * r) * kThreads + tid] = ax[r][0];
          stash[(2 * r + 1) * kThreads + tid] = ax[r][1];
        }
      }
      for (int e = g + 16; g < e; ++g) {
        const float* b = next_slab(ring, wt, g, tid);
        slab_fma<ROWS>(hs, (16 - (e - g)) * kBK, m0, b, lane, acc);
      }
      const unsigned mw[4] = {mk.x, mk.y, mk.z, mk.w};
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int i = r * kCols + c;
          if (!((mw[i >> 5] >> (i & 31)) & 1u)) acc[r][c] = 0.f;
        }
      __syncthreads();                            // every read of Hs done
      to_hs<ROWS>(hs, m0, lane, acc);
      store_rows<ROWS>(at.delta(l - 1, s), first, n, lane, acc);
      __syncthreads();
      p[(l - 1) * kW + tid] = row_sum<ROWS>(hs, tid);
    }

    // layer 0: dL/dPE(x) = d5 W5x + d0 W0x, 2 columns a lane
    float ax[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      ax[r][0] = stash[(2 * r) * kThreads + tid];
      ax[r][1] = stash[(2 * r + 1) * kThreads + tid];
    }
    for (int e = g + kW / kXK; g < e; ++g) {
      const float* b = next_slab(ring, wt, g, tid);
      slab_fma_x<ROWS>(hs, (kW / kXK - (e - g)) * kXK, m0, b, lane, ax);
    }
    // through PE: column c of PE(x) is x_j, sin(2^f x_j) or cos(2^f x_j),
    // j = c mod 3; sin' = 2^f cos, cos' = -2^f sin, read from the scratch
    float gx_part[T::kSpan][3];
#pragma unroll
    for (int r = 0; r < T::kSpan; ++r)
#pragma unroll
      for (int j = 0; j < 3; ++j) gx_part[r][j] = 0.f;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 2 * lane + c;
      if (col >= kXDim) continue;
      const int j = col % 3;
      int partner = -1;
      float fac = 1.f;
      if (col >= 3) {
        const int u = col - 3, f = u / 6;
        const bool is_sin = u % 6 < 3;
        partner = is_sin ? col + 3 : col - 3;
        fac = is_sin ? static_cast<float>(1 << f)
                     : -static_cast<float>(1 << f);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (first + r >= n) continue;
        float v = ax[r][c];
        if (partner >= 0) {
          const float e = at.act_x(s, first + r)[partner];
          v = __fmul_rn(__fmul_rn(v, e), fac);
        }
        gx_part[r][0] += j == 0 ? v : 0.f;
        gx_part[r][1] += j == 1 ? v : 0.f;
        gx_part[r][2] += j == 2 ? v : 0.f;
      }
    }
    float gx[3];
    reduce_rows<T::kSpan>(gx_part, lane, 16, gx);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      gprev[j] = gx[j];
      gyv[j] = __fadd_rn(gyv[j], gx[j]);
    }
  }
  if (keeps && part_ == 0 && row < n) {
#pragma unroll
    for (int j = 0; j < 3; ++j) gy[3 * row + j] = gyv[j];
  }
}


// The weight-gradient pass (`wgrad_pass`) over the four stages' scratch.
__global__ void __launch_bounds__(kThreads, 1)
ode_rk4_wgrad_kernel(const float* __restrict__ acts,
                     const float* __restrict__ deltas, long long n4,
                     int splits, long long per, long long xper,
                     float* __restrict__ wpart) {
  extern __shared__ __align__(16) float smem[];
  wgrad_pass(acts, deltas, n4, splits, per, xper, wpart, smem);
}

struct Args {
  const float *y, *g, *w, *wt, *bias, *tbias, *w_out, *b_out;
  float scale, h2, h1, h6;
  float *acts, *deltas;
  uint4* masks;
  float *part, *gy;
  int n;
};

// The recompute and the sweep over rows [row0, row0 + rows), tiles of ROWS
// rows a warp; adds their block count to *blocks.
template <int ROWS>
cudaError_t launch(const Args& a, int row0, int rows, int* blocks,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<ROWS>();
  cudaError_t err = cudaFuncSetAttribute(
      ode_rk4_recompute_kernel<ROWS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ode_rk4_sweep_kernel<ROWS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return err;
  const int grid = (rows + Tile<ROWS>::kBM - 1) / Tile<ROWS>::kBM;
  ode_rk4_recompute_kernel<ROWS><<<grid, kThreads, smem, stream>>>(
      a.y, row0, a.n, *blocks, a.w, a.bias, a.tbias, a.w_out, a.b_out,
      a.scale, a.h2, a.h1, a.acts, a.masks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ode_rk4_sweep_kernel<ROWS><<<grid, kThreads, smem, stream>>>(
      a.g, row0, a.n, *blocks, a.wt, a.w_out, a.scale, a.h2, a.h1, a.h6,
      a.acts, a.deltas, a.masks, a.part, a.gy);
  *blocks += grid;
  return cudaGetLastError();
}

}  // namespace

// The VJP of one RK4 step of the n rows of y (n x 3, f32) for the
// cotangent g (n x 3) of its output. w, bias, tbias, w_out, b_out, scale,
// h2, h1, h6: as d3gs_ode_rk4; wt: the out-major weights of the sweep
// (W7, W6, W5[:, :63] padded to 64 columns, W5[:, in:], W4, W3, W2, W1,
// W0[:, :63] padded). Scratch: acts (4n x (64 + 8 x 256) floats), deltas
// (8 x 4n x 256), masks (16 bytes x 256 x 32 a block), part (kPartRows x
// 256 x 4 a block), wpart (at most splits x kGradLen); at most ceil(n / 64)
// blocks. Out: gy (n x 3) dL/dy; dpart (4 x kPartRows x 256), per stage
// the column sums of the gradients at layers 0-7's outputs (rows 0-7),
// dL/dW_out (rows 8-10) and dL/db_out (row 11, columns 0-2); dw
// (kGradLen), the seven 256 x 256 trunk blocks W1, W2, W3, W4, W5[:, in:],
// W6, W7 and the PE(x) blocks of W0 and W5 (256 x 64 each), as nn.Linear
// lays them out; splits (at least 1) K-splits of the trunk's blocks.
// Returns the first launch error (0 on success).
extern "C" int d3gs_ode_rk4_bwd(const float* y, const float* g, long long n,
                                const float* w, const float* wt,
                                const float* bias, const float* tbias,
                                const float* w_out, const float* b_out,
                                float scale, float h2, float h1, float h6,
                                float* acts, float* deltas, void* masks,
                                float* part, float* wpart, float* gy,
                                float* dpart, float* dw, int splits,
                                void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (n <= 0) {                                   // no rows: zero sums
    cudaError_t err = cudaMemsetAsync(
        dpart, 0, sizeof(float) * kStages * kPartRows * kW, s);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(dw, 0, sizeof(float) * kGradLen, s);
    return static_cast<int>(err);
  }
  const int rows = static_cast<int>(n);
  const Args a{y,     g,      w,  wt, bias, tbias, w_out, b_out,
               scale, h2,     h1, h6, acts, deltas,
               static_cast<uint4*>(masks), part, gy, rows};
  int blocks = 0;
  cudaError_t err = plan_waves(rows, [&](auto tile, int row0, int count) {
    return launch<decltype(tile)::kRows>(a, row0, count, &blocks, s);
  });
  if (err == cudaSuccess)
    err = launch_sum(part, blocks, kStages * kPartRows * kW, dpart, s);
  if (err == cudaSuccess)
    err = launch_wgrad(ode_rk4_wgrad_kernel, acts, deltas, 4 * n, splits,
                       wpart, dw, s);
  return static_cast<int>(err);
}
