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
#include <cuda_runtime.h>

namespace {

constexpr int kW = 256;                         // trunk width
constexpr int kWarps = 8;                       // per block
constexpr int kThreads = kWarps * 32;
constexpr int kCols = kW / 32;                  // columns per lane
constexpr int kXRows = 64;                      // PE(x): 63 and a zero row
constexpr int kXDim = 63;
constexpr int kFreqs = 10;
constexpr int kBK = 16;                         // weight rows per slab
constexpr int kRing = 3;                        // slabs in flight
constexpr int kLayers = 8;
constexpr int kSlabs = (kXRows + 4 * kW + kXRows + kW + 2 * kW) / kBK;
constexpr int kStages = 4;
static_assert(kSlabs == 120, "packed weights: 1,920 rows");

// The block's shape at ROWS rows a warp (a multiple of 4: 16-byte loads).
// Lanes keep rows in pairs (ROWS up to 16) or fours (8): kSpan rows, the
// power of two the output's shuffle tree halves, of which ROWS are real.
template <int ROWS>
struct Tile {
  static constexpr int kRows = ROWS;
  static constexpr int kBM = kWarps * ROWS;     // rows per block
  static constexpr int kStride = kBM + 4;       // floats per feature row
  static constexpr int kSpan = ROWS > 8 ? 16 : 8;
  static constexpr int kLanesPerRow = 32 / kSpan;
  static constexpr int kSmemBytes =
      4 * ((kW + kXRows) * kStride + kRing * kBK * kW);
  static_assert(ROWS % 4 == 0 && ROWS <= kSpan, "rows a warp");
  static_assert(kStride * 4 % 128 == 16, "act_index's bank groups");
  static_assert(kSmemBytes <= 232448, "fits one SM's shared memory");
};

// slab count and leading PE(x) slabs of layer l
__device__ __forceinline__ int slab_count(int l) {
  return l == 0 ? 4 : (l == 5 ? 20 : 16);
}
__device__ __forceinline__ int x_slabs(int l) {
  return (l == 0 || l == 5) ? 4 : 0;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// slab q of the step's sequence (q mod kSlabs of the packed weights) into
// ring buffer q mod kRing: 16 KB, four 16-byte copies a thread
__device__ __forceinline__ void load_slab(float* ring, const float* w, int q,
                                          int tid) {
  const float* src = w + (q % kSlabs) * (kBK * kW);
  float* dst = ring + (q % kRing) * (kBK * kW);
#pragma unroll
  for (int i = 0; i < kBK * kW / 4 / kThreads; ++i) {
    const int c = 4 * (tid + i * kThreads);
    cp_async16(dst + c, src + c);
  }
}

// Column of a lane's c-th accumulator: two runs of 4, 128 apart, so that
// a warp reads a weight row as two contiguous 512-byte LDS.128.
__device__ __forceinline__ int col_of(int lane, int c) {
  return 4 * lane + (c & 3) + 128 * (c >> 2);
}

// Index in Hs or Xs of feature k at row m: row m's 16-byte chunk is
// XORed with bits 3-4 of k, so that the 8 lanes of an epilogue store
// (features 4l + c, rows 16 bytes past a multiple of 128 apart) hit 8
// distinct bank groups.
template <int ROWS>
__device__ __forceinline__ int act_index(int k, int m) {
  return k * Tile<ROWS>::kStride + 4 * ((m >> 2) ^ ((k >> 3) & 3)) +
         (m & 3);
}

// acc[r][c] += act[k0 + k][m0 + r] * wt[k][col_of(lane, c)] over the
// slab's 16 k: act = Hs or Xs, k0 its first feature (a multiple of 16),
// wt = the slab in the ring
template <int ROWS>
__device__ __forceinline__ void slab_fma(const float* __restrict__ act,
                                         int k0, int m0,
                                         const float* __restrict__ wt,
                                         int lane,
                                         float (&acc)[ROWS][kCols]) {
  int off[2][ROWS / 4];                          // chunk offsets, k < 8 / >= 8
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < ROWS / 4; ++q)
      off[h][q] = 4 * (((m0 >> 2) + q) ^ (((k0 >> 3) + h) & 3));
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const float* a = act + (k0 + k) * Tile<ROWS>::kStride;
    float av[ROWS];
#pragma unroll
    for (int q = 0; q < ROWS / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(a + off[k >> 3][q]);
      av[4 * q] = v.x;
      av[4 * q + 1] = v.y;
      av[4 * q + 2] = v.z;
      av[4 * q + 3] = v.w;
    }
    const float* b = wt + k * kW + 4 * lane;
    const float4 b0 = *reinterpret_cast<const float4*>(b);
    const float4 b1 = *reinterpret_cast<const float4*>(b + 128);
    const float bv[kCols] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// the 8 values of this lane's columns of a 256-vector in device memory
__device__ __forceinline__ void load_cols(const float* __restrict__ v,
                                          int lane, float (&out)[kCols]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(v + 4 * lane));
  const float4 b = __ldg(reinterpret_cast<const float4*>(v + 128 + 4 * lane));
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}

__device__ __forceinline__ float relu(float v) { return v <= 0.f ? 0.f : v; }

// the warp's sums over its lanes of the R rows' 3 partial outputs `in`,
// halving: at each level the lanes with `bit` set keep the upper half of
// the rows and add their partner's; row lane / (32 / R) ends on its lanes
template <int R>
__device__ __forceinline__ void reduce_rows(const float (&in)[R][3],
                                            int lane, int bit,
                                            float (&out)[3]) {
  if constexpr (R == 1) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[j] = in[0][j];
      for (int b = bit; b >= 1; b >>= 1)
        out[j] += __shfl_xor_sync(0xffffffffu, out[j], b);
    }
  } else {
    const bool up = (lane & bit) != 0;
    float half[R / 2][3];
#pragma unroll
    for (int i = 0; i < R / 2; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float lo = in[i][j], hi = in[i + R / 2][j];
        const float keep = up ? hi : lo, send = up ? lo : hi;
        half[i][j] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
      }
    reduce_rows<R / 2>(half, lane, bit >> 1, out);
  }
}

// rows [row0, row0 + gridDim.x * kBM) of the step, those below n
template <int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
ode_rk4_kernel(const float* __restrict__ y, int row0, int n,
               const float* __restrict__ w, const float* __restrict__ bias,
               const float* __restrict__ tbias,
               const float* __restrict__ w_out,
               const float* __restrict__ b_out, float scale, float h2,
               float h1, float h6, float* __restrict__ y_out) {
  using T = Tile<ROWS>;
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                               // [256][kStride]
  float* xs = smem + kW * T::kStride;             // [64][kStride]
  float* ring = smem + (kW + kXRows) * T::kStride;  // [kRing][16][256]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int m0 = (tid >> 5) * ROWS;               // this warp's first row
  const int r_lane = lane / T::kLanesPerRow;      // the warp's row it keeps
  const bool keeps = r_lane < ROWS;               // (past ROWS: none)
  const int my_row = m0 + r_lane;
  const int row = row0 + blockIdx.x * T::kBM + my_row;
  const int part = lane % T::kLanesPerRow;        // its share of the row

  for (int q = 0; q < kRing - 1; ++q) {
    load_slab(ring, w, q, tid);
    cp_async_commit();
  }
  if (tid < T::kBM) xs[act_index<ROWS>(kXDim, tid)] = 0.f;

  float y0[3], ks[3], yi[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    y0[j] = keeps && row < n ? y[3 * row + j] : 0.f;
    yi[j] = y0[j];
    ks[j] = 0.f;
  }

  float acc[ROWS][kCols];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  int g = 0;                                      // slab of the step
  for (int s = 0; s < kStages; ++s) {
    // PE(y_i) into Xs: the row's first lane writes x, each of its lanes
    // the sines and cosines of every kLanesPerRow-th frequency
    if (keeps) {
      if (part == 0) {
#pragma unroll
        for (int j = 0; j < 3; ++j) xs[act_index<ROWS>(j, my_row)] = yi[j];
      }
      for (int f = part; f < kFreqs; f += T::kLanesPerRow) {
        const float p = static_cast<float>(1 << f);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float v = yi[j] * p;
          xs[act_index<ROWS>(3 + 6 * f + j, my_row)] = sinf(v);
          xs[act_index<ROWS>(6 + 6 * f + j, my_row)] = cosf(v);
        }
      }
    }
    const int ti = s == 0 ? 0 : (s == 3 ? 2 : 1);  // t, t + dt/2, t + dt

    for (int l = 0; l < kLayers; ++l) {
      const int g0 = g, nx = x_slabs(l);
      for (int e = g + slab_count(l); g < e; ++g) {
        cp_async_wait<kRing - 2>();
        __syncthreads();
        if (g + kRing - 1 < kStages * kSlabs)
          load_slab(ring, w, g + kRing - 1, tid);
        cp_async_commit();
        const int qs = g - g0;
        slab_fma<ROWS>(qs < nx ? xs : hs, (qs < nx ? qs : qs - nx) * kBK,
                       m0, ring + (g % kRing) * (kBK * kW), lane, acc);
      }
      const float* b = (l == 0 || l == 5)
                           ? tbias + (2 * ti + (l == 5)) * kW
                           : bias + l * kW;
      float bv[kCols];
      load_cols(b, lane, bv);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[r][c] = relu(__fadd_rn(acc[r][c], bv[c]));
      if (l == kLayers - 1) break;
      __syncthreads();                            // every read of Hs done
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int f = col_of(lane, c);
#pragma unroll
        for (int q = 0; q < ROWS / 4; ++q)
          *reinterpret_cast<float4*>(hs + act_index<ROWS>(f, m0 + 4 * q)) =
              make_float4(acc[4 * q][c], acc[4 * q + 1][c],
                          acc[4 * q + 2][c], acc[4 * q + 3][c]);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
    }

    // k_s = (W_out h + b_out) * scale, of row my_row on its lanes
    float part_out[T::kSpan][3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float wo[kCols];
      load_cols(w_out + j * kW, lane, wo);
#pragma unroll
      for (int r = 0; r < T::kSpan; ++r) {
        float v = 0.f;
        if (r < ROWS) {
          v = acc[r][0] * wo[0];
#pragma unroll
          for (int c = 1; c < kCols; ++c) v = fmaf(acc[r][c], wo[c], v);
        }
        part_out[r][j] = v;
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
    float k[3];
    reduce_rows<T::kSpan>(part_out, lane, 16, k);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      k[j] = __fmul_rn(__fadd_rn(k[j], __ldg(b_out + j)), scale);
    // the RK4 combination, in `_rk4_step`'s order
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      ks[j] = s == 0 ? k[j]
                     : __fadd_rn(ks[j], s == 3 ? k[j] : __fmul_rn(2.f, k[j]));
      yi[j] = __fadd_rn(y0[j], __fmul_rn(s == 2 ? h1 : h2, k[j]));
    }
  }
  if (keeps && part == 0 && row < n) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      y_out[3 * row + j] = __fadd_rn(y0[j], __fmul_rn(h6, ks[j]));
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
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const int rows = static_cast<int>(n);
  const int wave = sms * Tile<16>::kBM;
  const int full = rows / wave * wave;
  const int rest = rows - full;
  if (full > 0)
    err = launch<16>(y, 0, full, rows, w, bias, tbias, w_out, b_out, scale,
                     h2, h1, h6, y_out, s);
  if (err == cudaSuccess && rest > 0) {
    if (rest <= sms * Tile<8>::kBM)
      err = launch<8>(y, full, rest, rows, w, bias, tbias, w_out, b_out,
                      scale, h2, h1, h6, y_out, s);
    else if (rest <= sms * Tile<12>::kBM)
      err = launch<12>(y, full, rest, rows, w, bias, tbias, w_out, b_out,
                       scale, h2, h1, h6, y_out, s);
    else
      err = launch<16>(y, full, rest, rows, w, bias, tbias, w_out, b_out,
                       scale, h2, h1, h6, y_out, s);
  }
  return static_cast<int>(err);
}
