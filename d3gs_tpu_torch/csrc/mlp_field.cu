// One evaluation of the deformation MLP for Hopper (sm_90a), in f32 on the
// CUDA cores, and its vector-Jacobian product for the weights: for x (n x
// 3) and one host time t, the heads of `DeformMLP` at D 8, W 256, skip
// after layer 4, PE(x, 10), not 6DoF (models/deform/networks.py): δx (3),
// δr (4) and δs (3), or δx alone (the `warp` kind).
//
// Replaces no TPU kernel: the JAX package leaves the MLP to XLA (dense
// products and elementwise glue). On the card the same split costs a
// cuBLAS SGEMM, a bias add, a ReLU and a concatenation a layer, and a
// round trip of every (N, 256) activation through device memory between
// them; under autograd as many again for the backward, with a reduction a
// bias.
//
// What bounds it on the H100: f32 FFMA issue. An evaluation is 493,568
// multiply-adds a row (63x256, 4 of 256x256, 319x256 at the skip, 2 of
// 256x256, 256x10): at N = 400,000, 0.395 TFLOP, ~5.9 ms at 67 TFLOP/s.
// The trunk is the ODE dynamics net's (csrc/ode_rk4.cu), so the forward
// is one of its stages, the same code (`trunk_eval`, ode_rk4_common.cuh,
// which the ODE's stage loop runs four times a step): a block of 8 warps
// owns up to 128 rows, their activations in shared memory feature-major,
// a lane 16 rows x 8 columns of a layer's output in registers; the
// weights stream from L2 in the same 1,920 x 256 K-major packing through
// the 3-deep cp.async ring; PE(x) with full-precision sinf / cosf; the
// time input folded by the wrapper into the bias vectors c0 and c5 at the
// one time t; the skip layer one accumulator over PE(x) then h, no
// concat. The heads are reduced from layer 7's registers three at a time
// by the ODE output's halving shuffle tree (`three_outputs`).
//
// Under autograd the forward also keeps what the backward reads, as the
// ODE backward's recompute does (`Place`, bwd_common.cuh): PE(x), each
// layer's output h1 ... h8 and each ReLU's mask as bits. The backward is
// two passes of the same product, 954,880 multiply-adds a row (the sweep's
// 7 of 256x256 and the heads' 256x10, the weight gradients' 493,568): at
// N = 400,000, 0.764 TFLOP, ~11.4 ms at 67 TFLOP/s:
//   * `mlp_field_sweep_kernel`: the reverse sweep, layers 7 -> 1, the
//     gradient at a layer's output (feature-major in shared memory) against
//     the layer's weights out-major (W7, W6, W5[:, in:], W4 ... W1: 1,792 x
//     256) through the same ring; no gradient of x (the trainers detach
//     it), so neither PE(x) block enters the sweep. Each layer's gradient
//     goes to the scratch; its column sums (the biases' gradients) and the
//     heads' weight and bias gradients are summed per block from shared
//     memory, in a fixed order;
//   * the split-K weight gradients of the trunk's blocks over K = n rows,
//     the ODE backward's own pass (`wgrad_pass`), then fixed-order sums.
// No float atomics: the same inputs give the same bits, run to run. The
// forward and the sweep plan the same tiles for the same n (`plan_waves`),
// so the sweep finds each block's masks where the forward put them.
// Products by fmaf, everything else one rounding per operation (no TF32,
// no bf16, no fast-math).
#include "bwd_common.cuh"

namespace {

using namespace d3gs_ode;

constexpr int kHeadRows = 12;                   // heads padded: 10 or 3
constexpr int kPartRows = kLayers + kHeadRows + 1;
constexpr int kSweepSlabs = 7 * kW / kBK;       // W7 ... W1, out-major

// head h of row r: δx in o0 (n x 3), δr in o1 (n x 4), δs in o2 (n x 3)
template <class P>
__device__ __forceinline__ P head_at(P o0, P o1, P o2, int h, int r) {
  const long long i = r;
  return h < 3 ? o0 + 3 * i + h : (h < 7 ? o1 + 4 * i + h - 3
                                         : o2 + 3 * i + h - 7);
}

// One evaluation of the block's rows of x (n x 3) through the trunk (w:
// the packed K-major trunk; bias; tbias: c0 and c5 at t) and the heads
// (w_head: kHeadRows x 256, zero past `heads`; b_head), into o0, o1, o2.
// Where At::kStores (`Place`), PE(x), each layer's output and its ReLU
// mask go to the scratch besides (`trunk_eval`).
template <int ROWS, class At>
__device__ __forceinline__ void mlp_eval(
    float* smem, const At& at, const float* __restrict__ x, int n,
    const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ tbias, const float* __restrict__ w_head,
    const float* __restrict__ b_head, int heads, float* o0, float* o1,
    float* o2) {
  using T = Tile<ROWS>;
  start_ring(smem + (kW + kXRows) * T::kStride, w, at.tid);
  if (at.tid < T::kBM)
    smem[kW * T::kStride + act_index<ROWS>(kXDim, at.tid)] = 0.f;

  float xi[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    xi[j] = at.keeps && at.row < n ? x[3 * at.row + j] : 0.f;
  float acc[ROWS][kCols];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  int g = 0;                                      // slab of the pass
  trunk_eval<kSlabs, ROWS>(smem, at, 0, xi, n, w, bias, tbias, g, acc);

  // the heads, three at a time: row my_row's on its lanes
  for (int q = 0; 3 * q < heads; ++q) {
    float o[3];
    three_outputs<ROWS>(acc, w_head + 3 * q * kW, at.lane, o);
    if (at.keeps && at.part == 0 && at.row < n) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int h = 3 * q + j;
        if (h < heads)
          *head_at(o0, o1, o2, h, at.row) = __fadd_rn(o[j], __ldg(b_head + h));
      }
    }
  }
}

// rows [row0, row0 + gridDim.x * kBM) of the evaluation, those below n;
// STORES: keep the backward's scratch (block blk0 + blockIdx.x's masks)
template <int ROWS, bool STORES>
__global__ void __launch_bounds__(kThreads, 1)
mlp_field_kernel(const float* __restrict__ x, int row0, int n, int blk0,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 const float* __restrict__ tbias,
                 const float* __restrict__ w_head,
                 const float* __restrict__ b_head, int heads,
                 float* __restrict__ o0, float* __restrict__ o1,
                 float* __restrict__ o2, float* __restrict__ acts,
                 uint4* __restrict__ masks) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (STORES)
    mlp_eval<ROWS>(smem, Place<ROWS, 1>(row0, n, blk0, acts, nullptr, masks),
                   x, n, w, bias, tbias, w_head, b_head, heads, o0, o1, o2);
  else
    mlp_eval<ROWS>(smem, Lane<ROWS>(row0), x, n, w, bias, tbias, w_head,
                   b_head, heads, o0, o1, o2);
}

// The reverse sweep over what mlp_field_kernel<ROWS, true> kept, layers
// 7 -> 1, for the cotangents g0, g1, g2 of the heads (laid out as o0, o1,
// o2). Per block (part: kPartRows x 256): rows 0-7 the column sums of the
// gradients at layers 0-7's outputs, rows 8-19 dL/dW_head, row 20
// dL/db_head (columns 0-11).
template <int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
mlp_field_sweep_kernel(const float* __restrict__ g0,
                       const float* __restrict__ g1,
                       const float* __restrict__ g2, int heads, int row0,
                       int n, int blk0, const float* __restrict__ wt,
                       const float* __restrict__ w_head,
                       float* __restrict__ acts, float* __restrict__ deltas,
                       uint4* __restrict__ masks, float* __restrict__ part) {
  using T = Tile<ROWS>;
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                               // [256][kStride]
  float* gks = smem + kW * T::kStride;            // [kBM][kHeadRows]
  float* ring = smem + (kW + kXRows) * T::kStride;  // [kRing][16][256]
  const Place<ROWS, 1> at(row0, n, blk0, acts, deltas, masks);
  const int tid = at.tid, lane = at.lane, m0 = at.m0, first = at.first;
  float* p = part + static_cast<long long>(at.blk) * kPartRows * kW;

  int g = 0;                                      // slab of the sweep
  start_ring(ring, wt, tid);
  // the block's rows' cotangents, 0 past n and past the heads
  const int base = row0 + blockIdx.x * T::kBM;
  for (int i = tid; i < T::kBM * kHeadRows; i += kThreads) {
    const int m = i / kHeadRows, h = i % kHeadRows;
    gks[i] = base + m < n && h < heads ? *head_at(g0, g1, g2, h, base + m)
                                       : 0.f;
  }
  // h8 of the lane's rows
  float acc[ROWS][kCols];
  {
    const float* src = at.act_h(kLayers, 0);
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
  __syncthreads();                                // gks written
  to_hs<ROWS>(hs, m0, lane, acc);
  // the gradient at layer 7's output: g W_head, masked
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = col_of(lane, c);
    float wo[kHeadRows];
#pragma unroll
    for (int h = 0; h < kHeadRows; ++h) wo[h] = __ldg(w_head + h * kW + col);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float* gr = gks + kHeadRows * (m0 + r);
      float v = gr[0] * wo[0];
#pragma unroll
      for (int h = 1; h < kHeadRows; ++h) v = fmaf(gr[h], wo[h], v);
      acc[r][c] = acc[r][c] > 0.f ? v : 0.f;
    }
  }
  __syncthreads();                                // h8 in Hs
  {
    // dW_head[h][tid] and db_head over the block's rows
    const float* a = hs + tid * T::kStride;
    float d[kHeadRows], e[kHeadRows];
#pragma unroll
    for (int h = 0; h < kHeadRows; ++h) d[h] = e[h] = 0.f;
    for (int q = 0; q < T::kBM / 4; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(a + 4 * (q ^ ((tid >> 3) & 3)));
      const float hv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* gr = gks + kHeadRows * (4 * q + i);
#pragma unroll
        for (int h = 0; h < kHeadRows; ++h) {
          d[h] = fmaf(gr[h], hv[i], d[h]);
          e[h] += gr[h];
        }
      }
    }
    float eb = 0.f;
#pragma unroll
    for (int h = 0; h < kHeadRows; ++h) {
      p[(kLayers + h) * kW + tid] = d[h];
      if (tid == h) eb = e[h];
    }
    p[(kLayers + kHeadRows) * kW + tid] = eb;
  }
  __syncthreads();                                // every read of h8 done
  to_hs<ROWS>(hs, m0, lane, acc);
  store_rows<ROWS>(at.delta(kLayers - 1, 0), first, n, lane, acc);
  __syncthreads();
  p[(kLayers - 1) * kW + tid] = row_sum<ROWS>(hs, tid);

  // layers 7 ... 1: the gradient at layer l's input, masked by ReLU, is
  // the gradient at layer l - 1's output
  for (int l = kLayers - 1; l >= 1; --l) {
    const uint4 mk = at.mask(l - 1, 0);
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
    for (int e = g + kW / kBK; g < e; ++g) {
      const float* b = next_slab<kSweepSlabs>(ring, wt, g, tid);
      slab_fma<ROWS>(hs, (kW / kBK - (e - g)) * kBK, m0, b, lane, acc);
    }
    const unsigned mw[4] = {mk.x, mk.y, mk.z, mk.w};
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int i = r * kCols + c;
        if (!((mw[i >> 5] >> (i & 31)) & 1u)) acc[r][c] = 0.f;
      }
    __syncthreads();                              // every read of Hs done
    to_hs<ROWS>(hs, m0, lane, acc);
    store_rows<ROWS>(at.delta(l - 1, 0), first, n, lane, acc);
    __syncthreads();
    p[(l - 1) * kW + tid] = row_sum<ROWS>(hs, tid);
  }
}

// The weight-gradient pass (`wgrad_pass`) over the evaluation's scratch.
__global__ void __launch_bounds__(kThreads, 1)
mlp_field_wgrad_kernel(const float* __restrict__ acts,
                       const float* __restrict__ deltas, long long n4,
                       int splits, long long per, long long xper,
                       float* __restrict__ wpart) {
  extern __shared__ __align__(16) float smem[];
  wgrad_pass(acts, deltas, n4, splits, per, xper, wpart, smem);
}

// out[g][i] = the sum of p[r][i] over the parts r of group g, [g kSumGroup,
// min(parts, (g + 1) kSumGroup)), in r's order (len4 float4s a part; chunks
// blocks of 256 a group): the first pass of the sum of the sweep's ~3,000
// per-block parts at N = 400,000, which a thread each would read in turn
// (~0.6 ms in one pass)
constexpr int kSumGroup = 64;

__global__ void sum_groups(const float4* __restrict__ p, long long parts,
                           long long len4, int chunks,
                           float4* __restrict__ out) {
  const long long g = blockIdx.x / chunks;
  const long long i = (blockIdx.x % chunks) * 256LL + threadIdx.x;
  if (i >= len4) return;
  const long long r0 = g * kSumGroup;
  const long long r1 = r0 + kSumGroup < parts ? r0 + kSumGroup : parts;
  float4 s = p[r0 * len4 + i];
  for (long long r = r0 + 1; r < r1; ++r) {
    const float4 v = p[r * len4 + i];
    s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
  }
  out[g * len4 + i] = s;
}

struct Args {
  const float *x, *w, *bias, *tbias, *w_head, *b_head;
  float *o0, *o1, *o2;
  const float *g0, *g1, *g2, *wt;
  float *acts, *deltas;
  uint4* masks;
  float* part;
  int heads, n;
};

// One launch of a pass over rows [row0, row0 + rows), tiles of ROWS rows a
// warp: the forward (STORES: keeping the scratch) or the sweep (SWEEP);
// adds its block count to *blocks.
template <int ROWS, bool STORES, bool SWEEP>
cudaError_t launch(const Args& a, int row0, int rows, int* blocks,
                   cudaStream_t stream) {
  constexpr int smem = Tile<ROWS>::kSmemBytes;
  const int grid = (rows + Tile<ROWS>::kBM - 1) / Tile<ROWS>::kBM;
  cudaError_t err;
  if constexpr (SWEEP) {
    err = cudaFuncSetAttribute(mlp_field_sweep_kernel<ROWS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    mlp_field_sweep_kernel<ROWS><<<grid, kThreads, smem, stream>>>(
        a.g0, a.g1, a.g2, a.heads, row0, a.n, *blocks, a.wt, a.w_head, a.acts,
        a.deltas, a.masks, a.part);
  } else {
    err = cudaFuncSetAttribute(mlp_field_kernel<ROWS, STORES>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    mlp_field_kernel<ROWS, STORES><<<grid, kThreads, smem, stream>>>(
        a.x, row0, a.n, *blocks, a.w, a.bias, a.tbias, a.w_head, a.b_head,
        a.heads, a.o0, a.o1, a.o2, a.acts, a.masks);
  }
  *blocks += grid;
  return cudaGetLastError();
}

}  // namespace

// One evaluation of the n rows of x (n x 3, f32). w: the packed trunk
// (1,920 x 256, K-major, as d3gs_ode_rk4's); bias: (8, 256), the trunk's
// biases (rows 0 and 5 unused); tbias: (2, 256), c0 and c5 at t; w_head
// (12 x 256: the heads' rows in order, then zeros), b_head (12); heads 10
// or 3; out: o0 (n x 3), o1 and o2 (n x 4, n x 3; unused at 3 heads).
// acts, masks: the backward's scratch (acts n x (64 + 8 x 256) floats,
// masks 16 bytes x 256 x 8 a block, at most ceil(n / 64) blocks), filled
// where acts is not null. Whole waves of 128-row blocks, then the rest in
// one wave of the smallest tile that holds it (ode_rk4.cu's "Tiles").
// Returns the first launch error (0 on success).
extern "C" int d3gs_mlp_field(const float* x, long long n, const float* w,
                              const float* bias, const float* tbias,
                              const float* w_head, const float* b_head,
                              int heads, float* o0, float* o1, float* o2,
                              float* acts, void* masks, void* stream) {
  if (n <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  Args a{};
  a.x = x, a.w = w, a.bias = bias, a.tbias = tbias, a.w_head = w_head;
  a.b_head = b_head, a.o0 = o0, a.o1 = o1, a.o2 = o2, a.acts = acts;
  a.masks = static_cast<uint4*>(masks), a.heads = heads;
  a.n = static_cast<int>(n);
  int blocks = 0;
  return static_cast<int>(plan_waves(a.n, [&](auto tile, int row0,
                                              int count) {
    constexpr int kRows = decltype(tile)::kRows;
    return acts ? launch<kRows, true, false>(a, row0, count, &blocks, s)
                : launch<kRows, false, false>(a, row0, count, &blocks, s);
  }));
}

// The VJP of d3gs_mlp_field for the weights, for the cotangents g0, g1, g2
// of its outputs (laid out as o0, o1, o2), from the scratch acts, masks
// that the forward at the same n kept. wt: the out-major weights of the
// sweep (W7, W6, W5[:, in:], W4, W3, W2, W1: 1,792 x 256); w_head as
// d3gs_mlp_field's. Scratch: deltas (8 x n x 256), part (kPartRows x 256 a
// block), psum (kPartRows x 256 a group of kSumGroup blocks), wpart (at
// most splits x kGradLen). Out: dpart (kPartRows x
// 256): the column sums of the gradients at layers 0-7's outputs (rows
// 0-7), dL/dW_head (rows 8-19) and dL/db_head (row 20, columns 0-11);
// dw (kGradLen), the seven 256 x 256 trunk blocks W1, W2, W3, W4,
// W5[:, in:], W6, W7 and the PE(x) blocks of W0 and W5 (256 x 64 each),
// as nn.Linear lays them out; splits (at least 1) K-splits of the trunk's
// blocks. Returns the first launch error (0 on success).
extern "C" int d3gs_mlp_field_bwd(const float* g0, const float* g1,
                                  const float* g2, long long n, int heads,
                                  const float* wt, const float* w_head,
                                  float* acts, float* deltas, void* masks,
                                  float* part, float* psum, float* wpart,
                                  float* dpart, float* dw, int splits,
                                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (n <= 0) {                                   // no rows: zero sums
    cudaError_t err =
        cudaMemsetAsync(dpart, 0, sizeof(float) * kPartRows * kW, s);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(dw, 0, sizeof(float) * kGradLen, s);
    return static_cast<int>(err);
  }
  Args a{};
  a.g0 = g0, a.g1 = g1, a.g2 = g2, a.wt = wt, a.w_head = w_head;
  a.acts = acts, a.deltas = deltas, a.masks = static_cast<uint4*>(masks);
  a.part = part, a.heads = heads, a.n = static_cast<int>(n);
  int blocks = 0;
  cudaError_t err = plan_waves(a.n, [&](auto tile, int row0, int count) {
    return launch<decltype(tile)::kRows, false, true>(a, row0, count,
                                                      &blocks, s);
  });
  const int groups = (blocks + kSumGroup - 1) / kSumGroup;
  const long long len4 = kPartRows * kW / 4;
  const int chunks = static_cast<int>((len4 + 255) / 256);
  if (err == cudaSuccess) {
    sum_groups<<<groups * chunks, 256, 0, s>>>(
        reinterpret_cast<const float4*>(part), blocks, len4, chunks,
        reinterpret_cast<float4*>(psum));
    err = cudaGetLastError();
  }
  if (err == cudaSuccess)
    err = launch_sum(psum, groups, kPartRows * kW, dpart, s);
  if (err == cudaSuccess)
    err = launch_wgrad(mlp_field_wgrad_kernel, acts, deltas, n, splits, wpart,
                       dw, s);
  return static_cast<int>(err);
}
