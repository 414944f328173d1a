// Shared by the two backward passes of the 8x256 trunk: ode_rk4_bwd.cu (the
// VJP of one RK4 step of the ODE dynamics net, four evaluations) and
// mlp_field.cu (the VJP of one evaluation of the deformation MLP). Both
// nets have the same trunk, so the same scratch and the same weight blocks:
//   * `Place`: where a forward pass that keeps its activations stores
//     PE(x), each layer's output and its ReLU mask, and where the sweep puts
//     the gradient at each layer's output, for STAGES evaluations of n rows;
//   * `store_rows` and `row_sum`, the sweep's per-layer epilogue helpers;
//   * the split-K weight-gradient pass (`wgrad_pass`, launched by
//     `launch_wgrad`): dW_l = sum over the K = STAGES n rows of delta_l^T
//     h_l for the seven 256 x 256 blocks (W1 ... W4, W5[:, in:], W6, W7)
//     and the two PE(x) blocks of W0 and W5, then the splits' fixed-order
//     sums (`sum_partials`). No float atomics: the same inputs give the same
//     bits, run to run.
#pragma once

#include "ode_rk4_common.cuh"

namespace d3gs_ode {

// acc to the rows below n of a 256-wide scratch slot (row stride 256)
template <int ROWS>
__device__ __forceinline__ void store_rows(float* slot, int first, int n,
                                           int lane,
                                           const float (&acc)[ROWS][kCols]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (first + r >= n) break;
    float* p = slot + static_cast<long long>(r) * kW + 4 * lane;
    *reinterpret_cast<float4*>(p) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    *reinterpret_cast<float4*>(p + 128) =
        make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
}

// sum over the block's rows of Hs' feature `f`, in row order
template <int ROWS>
__device__ __forceinline__ float row_sum(const float* hs, int f) {
  const float* a = hs + f * Tile<ROWS>::kStride;
  float s = 0.f;
  for (int q = 0; q < Tile<ROWS>::kBM / 4; ++q) {
    const float4 v =
        *reinterpret_cast<const float4*>(a + 4 * (q ^ ((f >> 3) & 3)));
    s += v.x;
    s += v.y;
    s += v.z;
    s += v.w;
  }
  return s;
}

// A lane's place in the pass (`Lane`) and the pass's memory: block blk0 +
// blockIdx.x of the masks and partial sums, and the scratch: PE(x)
// [STAGES][n][64], then h_1 ... h_8 (each layer's output), each
// [STAGES][n][256]; the gradients at layers 0-7's outputs, each
// [STAGES][n][256]. kStores: a forward pass keeps PE(x), h_l and the masks
// here.
template <int ROWS, int STAGES>
struct Place : Lane<ROWS> {
  static constexpr bool kStores = true;
  using Lane<ROWS>::tid;
  using Lane<ROWS>::lane;
  using Lane<ROWS>::first;
  int blk, n;
  long long n4;
  float *acts, *deltas;
  uint4* masks;
  __device__ Place(int row0, int n_, int blk0, float* a, float* d, uint4* mk)
      : Lane<ROWS>(row0), blk(blk0 + blockIdx.x), n(n_),
        n4(static_cast<long long>(STAGES) * n_), acts(a), deltas(d),
        masks(mk) {}
  // PE(x) of row r at stage s
  __device__ float* act_x(int s, int r) const {
    return acts + (static_cast<long long>(s) * n + r) * kXRows;
  }
  // h_l (l = 1 ... 8) of the warp's row 0 at stage s
  __device__ float* act_h(int l, int s) const {
    return acts + n4 * kXRows + (l - 1) * n4 * kW +
           (static_cast<long long>(s) * n + first) * kW;
  }
  __device__ float* delta(int l, int s) const {
    return deltas + l * n4 * kW + (static_cast<long long>(s) * n + first) * kW;
  }
  // the lane's ReLU mask word of layer l's output at stage s
  __device__ uint4& mask(int l, int s) const {
    return masks[((static_cast<long long>(blk) * STAGES + s) * kLayers + l) *
                     kThreads + tid];
  }
  // layer l's output at stage s, after its ReLU: h_{l+1} to the scratch
  __device__ void keep_h(int l, int s, const float (&acc)[ROWS][kCols]) const {
    store_rows<ROWS>(act_h(l + 1, s), first, n, lane, acc);
  }
  // and its mask, one bit an output (layers 0-6: the sweep reads h8 itself)
  __device__ void keep_mask(int l, int s,
                            const float (&acc)[ROWS][kCols]) const {
    unsigned bits[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (acc[r][c] > 0.f) bits[(r * kCols + c) >> 5] |=
            1u << ((r * kCols + c) & 31);
    mask(l, s) = make_uint4(bits[0], bits[1], bits[2], bits[3]);
  }
};

// ---- the weight-gradient pass
constexpr int kGRing = 4;                       // K-slabs in flight
constexpr int kGBK = 16;                        // rows of A and B a slab
constexpr int kGHalf = 128;                     // output rows a block
constexpr int kGAct = kGBK * kGHalf;            // floats of an A slab
constexpr int kGB = kGBK * kW;                  // floats of a B slab
constexpr int kGSmemBytes = 4 * kGRing * (kGAct + kGB);
constexpr long long kWideOut = 7LL * kW * kW;
constexpr long long kXOut = 2LL * kW * kXRows;
constexpr long long kGradLen = kWideOut + kXOut;

// One block: rows [half * 128, +128) of dW = A^T B over A's and B's rows
// [kb, ke), A = the gradients at a layer's output (256 wide), B its input
// (COLS * 32 wide), into out (128 x COLS * 32).
template <int COLS>
__device__ void wgrad_block(const float* __restrict__ a,
                            const float* __restrict__ bsrc, int half,
                            long long kb, long long ke,
                            float* __restrict__ out, float* smem) {
  constexpr int kB = COLS * 32;                 // B's width
  float* aring = smem;                          // [kGRing][16][128]
  float* bring = smem + kGRing * kGAct;         // [kGRing][16][kB]
  const int tid = threadIdx.x, lane = tid & 31, m0 = (tid >> 5) * 16;
  const int slabs = ke > kb ? static_cast<int>((ke - kb + kGBK - 1) / kGBK) : 0;
  auto load = [&](int i) {
    const long long k0 = kb + static_cast<long long>(i) * kGBK;
    float* ad = aring + (i % kGRing) * kGAct;
    float* bd = bring + (i % kGRing) * kGB;
    for (int c = tid; c < kGAct / 4; c += kThreads) {
      const int rr = c / (kGHalf / 4), c4 = c % (kGHalf / 4);
      float* d = ad + rr * kGHalf + 4 * c4;
      if (k0 + rr < ke)
        cp_async16(d, a + (k0 + rr) * kW + half * kGHalf + 4 * c4);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int c = tid; c < kGBK * kB / 4; c += kThreads) {
      const int rr = c / (kB / 4), c4 = c % (kB / 4);
      float* d = bd + rr * kB + 4 * c4;
      if (k0 + rr < ke)
        cp_async16(d, bsrc + (k0 + rr) * kB + 4 * c4);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  float acc[16][COLS];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;
  for (int i = 0; i < kGRing - 1; ++i) {
    if (i < slabs) load(i);
    cp_async_commit();
  }
  for (int i = 0; i < slabs; ++i) {
    cp_async_wait<kGRing - 2>();
    __syncthreads();
    if (i + kGRing - 1 < slabs) load(i + kGRing - 1);
    cp_async_commit();
    const float* as = aring + (i % kGRing) * kGAct;
    const float* bs = bring + (i % kGRing) * kGB;
#pragma unroll
    for (int k = 0; k < kGBK; ++k) {
      float av[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(as + k * kGHalf + m0 + 4 * q);
        av[4 * q] = v.x, av[4 * q + 1] = v.y, av[4 * q + 2] = v.z,
               av[4 * q + 3] = v.w;
      }
      float bv[COLS];
      if constexpr (COLS == kCols) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(bs + k * kB + 4 * lane);
        const float4 b1 =
            *reinterpret_cast<const float4*>(bs + k * kB + 128 + 4 * lane);
        bv[0] = b0.x, bv[1] = b0.y, bv[2] = b0.z, bv[3] = b0.w;
        bv[4] = b1.x, bv[5] = b1.y, bv[6] = b1.z, bv[7] = b1.w;
      } else {
        const float2 b0 =
            *reinterpret_cast<const float2*>(bs + k * kB + 2 * lane);
        bv[0] = b0.x, bv[1] = b0.y;
      }
#pragma unroll
      for (int r = 0; r < 16; ++r)
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    float* o = out + (m0 + r) * kB;
    if constexpr (COLS == kCols) {
      *reinterpret_cast<float4*>(o + 4 * lane) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      *reinterpret_cast<float4*>(o + 128 + 4 * lane) =
          make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    } else {
      *reinterpret_cast<float2*>(o + 2 * lane) =
          make_float2(acc[r][0], acc[r][1]);
    }
  }
}

// A block of the weight-gradient kernel (its body; each .cu names its own
// kernel). Blocks [0, 14 splits): the seven 256 x 256 blocks (W1 ... W4,
// W5h, W6, W7), two halves each, split s = b / 14, over K-ranges of `per`
// rows; then 4 xsplits blocks: the PE(x) blocks of W0 and W5, two halves
// each, over K-ranges of `xper` rows (a quarter as many splits: a quarter of
// the columns). acts, deltas: `Place`'s scratch, K = n4 rows. Out:
// [splits][kWideOut], then [xsplits][kXOut].
__device__ __forceinline__ void wgrad_pass(const float* __restrict__ acts,
                                           const float* __restrict__ deltas,
                                           long long n4, int splits,
                                           long long per, long long xper,
                                           float* __restrict__ wpart,
                                           float* smem) {
  const int b = blockIdx.x;
  const bool wide = b < 14 * splits;
  const int split = wide ? b / 14 : (b - 14 * splits) / 4;
  const int type = wide ? b % 14 : (b - 14 * splits) % 4;
  const int piece = type / 2, half = type % 2;
  const long long span = wide ? per : xper;
  const long long kb = split * span;
  const long long ke = kb + span < n4 ? kb + span : n4;
  if (wide) {
    const int l = piece + 1;                      // layer l: h_l, d_l
    wgrad_block<kCols>(deltas + l * n4 * kW, acts + n4 * kXRows +
                       (l - 1) * n4 * kW, half, kb, ke,
                       wpart + split * kWideOut + piece * kW * kW +
                           half * kGHalf * kW,
                       smem);
  } else {
    const int l = piece == 0 ? 0 : 5;             // PE(x), d_0 or d_5
    wgrad_block<2>(deltas + l * n4 * kW, acts, half, kb, ke,
                   wpart + splits * kWideOut + split * kXOut +
                       piece * kW * kXRows + half * kGHalf * kXRows,
                   smem);
  }
}

// out[i] = sum over r < parts of p[r][i], in r's order (len4 float4s)
__global__ void sum_partials(const float4* __restrict__ p, long long parts,
                             long long len4, float4* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= len4) return;
  float4 s = p[i];
  for (long long r = 1; r < parts; ++r) {
    const float4 v = p[r * len4 + i];
    s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
  }
  out[i] = s;
}

inline cudaError_t launch_sum(const float* p, long long parts, long long len,
                              float* out, cudaStream_t stream) {
  const long long len4 = len / 4;
  sum_partials<<<static_cast<unsigned>((len4 + 255) / 256), 256, 0,
                 stream>>>(reinterpret_cast<const float4*>(p), parts, len4,
                           reinterpret_cast<float4*>(out));
  return cudaGetLastError();
}

// The weight-gradient pass over K = n4 rows of `Place`'s scratch by
// `kernel` (a __global__ whose body is `wgrad_pass`), `splits` K-splits of
// the 256 x 256 blocks and a quarter as many of the PE(x) blocks, then
// their sums into dw (kGradLen: the seven 256 x 256 blocks, then the two
// 256 x 64 PE(x) blocks, as nn.Linear lays them out). wpart: at most
// splits x kGradLen floats. Returns the first launch error.
template <class Kernel>
cudaError_t launch_wgrad(Kernel kernel, const float* acts, const float* deltas,
                         long long n4, int splits, float* wpart, float* dw,
                         cudaStream_t stream) {
  const int xsplits = (splits + 3) / 4;
  auto span = [&](int parts) {                    // rows a split, kGBK | it
    return ((n4 + parts - 1) / parts + kGBK - 1) / kGBK * kGBK;
  };
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmemBytes);
  if (err == cudaSuccess) {
    kernel<<<14 * splits + 4 * xsplits, kThreads, kGSmemBytes, stream>>>(
        acts, deltas, n4, splits, span(splits), span(xsplits), wpart);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess)
    err = launch_sum(wpart, splits, kWideOut, dw, stream);
  if (err == cudaSuccess)
    err = launch_sum(wpart + splits * kWideOut, xsplits, kXOut, dw + kWideOut,
                     stream);
  return err;
}

}  // namespace d3gs_ode
