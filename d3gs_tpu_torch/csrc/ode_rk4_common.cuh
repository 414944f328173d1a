// Shared by ode_rk4.cu (one RK4 step of the 8x256 ODE dynamics net),
// ode_rk4_bwd.cu (its vector-Jacobian product) and mlp_field.cu (the
// deformation MLP, whose trunk is the same): the block's tiles, the
// cp.async weight ring, the 16-row product and the output's reduction, one
// evaluation of the trunk (`trunk_eval`), the four stages of a step
// (`rk4_stages`) and the wave planner of the C entries. The step kernel
// runs the stages; the backward's recompute runs them again and keeps
// what its sweep reads. The backward is the gradient of what the forward
// computed only while the recompute repeats the forward's arithmetic bit
// for bit (roundings, sinf / cosf, accumulation order): one stage loop
// for both keeps it so, and one trunk for the MLP's forward, which keeps
// its backward's inputs itself.

#pragma once

#include <cuda_runtime.h>

namespace d3gs_ode {

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
constexpr int kWide = kBK * kW;                 // floats of a slab
constexpr int kSeq = kStages * kSlabs;          // slabs of a step's pass
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
  // Hs, Xs and the ring
  static constexpr int kSmemBytes =
      4 * ((kW + kXRows) * kStride + kRing * kWide);
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

// slab q of a pass's sequence (slab q mod kSlabs of the packed weights:
// the stages' K-major w or the sweep's out-major wt, 1,920 x 256 each)
// into ring buffer q mod kRing: 16 KB, four 16-byte copies a thread
__device__ __forceinline__ void load_slab(float* ring, const float* w, int q,
                                          int tid) {
  const float* src = w + (q % kSlabs) * kWide;
  float* dst = ring + (q % kRing) * kWide;
#pragma unroll
  for (int i = 0; i < kWide / 4 / kThreads; ++i) {
    const int c = 4 * (tid + i * kThreads);
    cp_async16(dst + c, src + c);
  }
}

// the first kRing - 1 slabs of a pass over w in flight
__device__ __forceinline__ void start_ring(float* ring, const float* w,
                                           int tid) {
  for (int q = 0; q < kRing - 1; ++q) {
    load_slab(ring, w, q, tid);
    cp_async_commit();
  }
}

// Waits for slab g of a pass of SEQ slabs (a step's: four stages), keeps
// the ring kRing - 1 slabs ahead, returns slab g.
template <int SEQ = kSeq>
__device__ __forceinline__ const float* next_slab(float* ring, const float* w,
                                                  int g, int tid) {
  cp_async_wait<kRing - 2>();
  __syncthreads();
  if (g + kRing - 1 < SEQ) load_slab(ring, w, g + kRing - 1, tid);
  cp_async_commit();
  return ring + (g % kRing) * kWide;
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

// the ROWS activations act[k][m0 .. m0 + ROWS) of feature k (broadcast)
template <int ROWS>
__device__ __forceinline__ void load_act(const float* __restrict__ act,
                                         int k, int m0, float (&av)[ROWS]) {
  const float* a = act + k * Tile<ROWS>::kStride;
#pragma unroll
  for (int q = 0; q < ROWS / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(
        a + 4 * (((m0 >> 2) + q) ^ ((k >> 3) & 3)));
    av[4 * q] = v.x;
    av[4 * q + 1] = v.y;
    av[4 * q + 2] = v.z;
    av[4 * q + 3] = v.w;
  }
}

// acc[r][c] += act[k0 + k][m0 + r] * wt[k][col_of(lane, c)] over the
// slab's 16 k: act = Hs or Xs, k0 its first feature (a multiple of 16),
// wt = the slab in the ring. act_index's chunk offsets are one half's (8
// k) at a time: at 128 rows, where the sweep holds 255 registers, that ran
// 1 % faster than both halves' offsets live or each k's computed in turn.
template <int ROWS>
__device__ __forceinline__ void slab_fma(const float* __restrict__ act,
                                         int k0, int m0,
                                         const float* __restrict__ wt,
                                         int lane,
                                         float (&acc)[ROWS][kCols]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int off[ROWS / 4];
#pragma unroll
    for (int q = 0; q < ROWS / 4; ++q)
      off[q] = 4 * (((m0 >> 2) + q) ^ (((k0 >> 3) + h) & 3));
#pragma unroll
    for (int k = 8 * h; k < 8 * h + 8; ++k) {
      const float* a = act + (k0 + k) * Tile<ROWS>::kStride;
      float av[ROWS];
#pragma unroll
      for (int q = 0; q < ROWS / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(a + off[q]);
        av[4 * q] = v.x;
        av[4 * q + 1] = v.y;
        av[4 * q + 2] = v.z;
        av[4 * q + 3] = v.w;
      }
      const float* b = wt + k * kW + 4 * lane;
      const float4 b0 = *reinterpret_cast<const float4*>(b);
      const float4 b1 = *reinterpret_cast<const float4*>(b + 128);
      const float bv[kCols] = {b0.x, b0.y, b0.z, b0.w,
                               b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
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

// acc (a lane's ROWS x 8) over Hs, feature-major (a layer's epilogue)
template <int ROWS>
__device__ __forceinline__ void to_hs(float* hs, int m0, int lane,
                                      const float (&acc)[ROWS][kCols]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int f = col_of(lane, c);
#pragma unroll
    for (int q = 0; q < ROWS / 4; ++q)
      *reinterpret_cast<float4*>(hs + act_index<ROWS>(f, m0 + 4 * q)) =
          make_float4(acc[4 * q][c], acc[4 * q + 1][c], acc[4 * q + 2][c],
                      acc[4 * q + 3][c]);
  }
}

// A lane's place in its block, whose rows are [row0 + blockIdx.x * kBM,
// + kBM) of the step: its warp's rows start at m0 (`first` in the step);
// the row it keeps is my_row (`row` in the step), held by kLanesPerRow
// lanes, this one with share `part`; past ROWS, `keeps` is false.
// kStores: `rk4_stages` stores nothing more (see there).
template <int ROWS>
struct Lane {
  static constexpr bool kStores = false;
  int tid, lane, m0, r_lane, my_row, first, row, part;
  bool keeps;
  __device__ explicit Lane(int row0)
      : tid(threadIdx.x), lane(threadIdx.x & 31),
        m0((threadIdx.x >> 5) * ROWS),
        r_lane(lane / Tile<ROWS>::kLanesPerRow), my_row(m0 + r_lane),
        first(row0 + blockIdx.x * Tile<ROWS>::kBM + m0),
        row(first + r_lane), part(lane % Tile<ROWS>::kLanesPerRow),
        keeps(r_lane < ROWS) {}
};

// One evaluation of the trunk for the block's rows, the s-th of its pass:
// PE(xi) into Xs (xi: the lane's row, 0 past n), then layers 0-7 with
// ReLU into acc (zero on entry), the weights from slab g of the pass's
// SEQ on (g ends past the trunk's kSlabs), the biases of layers 0 and 5
// from tb (c0 and c5 at this evaluation's time), the others from bias. On
// return acc holds the lane's rows of h8 (layer 7's output) and Hs h7.
// Where At::kStores (the backward's `Place`), PE(xi) (at.act_x), each
// layer's output (at.keep_h) and its ReLU mask (at.keep_mask) are kept
// besides, as evaluation s; the arithmetic is the same either way.
template <int SEQ, int ROWS, class At>
__device__ __forceinline__ void trunk_eval(
    float* smem, const At& at, int s, const float (&xi)[3], int n,
    const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ tb, int& g, float (&acc)[ROWS][kCols]) {
  using T = Tile<ROWS>;
  float* hs = smem;                               // [256][kStride]
  float* xs = smem + kW * T::kStride;             // [64][kStride]
  float* ring = smem + (kW + kXRows) * T::kStride;  // [kRing][16][256]

  // PE(xi) into Xs: the row's first lane writes x, each of its lanes the
  // sines and cosines of every kLanesPerRow-th frequency
  if (at.keeps) {
    float* ex = nullptr;                          // PE(xi) kept, if stored
    bool st = false;
    if constexpr (At::kStores) {
      ex = at.act_x(s, at.row);
      st = at.row < n;
    }
    if (at.part == 0) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        xs[act_index<ROWS>(j, at.my_row)] = xi[j];
        if (st) ex[j] = xi[j];
      }
      if (st) ex[kXDim] = 0.f;
    }
    for (int f = at.part; f < kFreqs; f += T::kLanesPerRow) {
      const float p = static_cast<float>(1 << f);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float v = xi[j] * p;
        // the same values either way; at 12 rows a warp the recompute
        // ran 6 % slower storing each before the next is computed, the
        // forward took 2 registers more computing both first
        if constexpr (At::kStores) {
          const float sv = sinf(v), cv = cosf(v);
          xs[act_index<ROWS>(3 + 6 * f + j, at.my_row)] = sv;
          xs[act_index<ROWS>(6 + 6 * f + j, at.my_row)] = cv;
          if (st) {
            ex[3 + 6 * f + j] = sv;
            ex[6 + 6 * f + j] = cv;
          }
        } else {
          xs[act_index<ROWS>(3 + 6 * f + j, at.my_row)] = sinf(v);
          xs[act_index<ROWS>(6 + 6 * f + j, at.my_row)] = cosf(v);
        }
      }
    }
  }

  for (int l = 0; l < kLayers; ++l) {
    const int g0 = g, nx = x_slabs(l);
    for (int e = g + slab_count(l); g < e; ++g) {
      const float* wt = next_slab<SEQ>(ring, w, g, at.tid);
      const int qs = g - g0;
      slab_fma<ROWS>(qs < nx ? xs : hs, (qs < nx ? qs : qs - nx) * kBK,
                     at.m0, wt, at.lane, acc);
    }
    const float* b =
        (l == 0 || l == 5) ? tb + (l == 5) * kW : bias + l * kW;
    float bv[kCols];
    load_cols(b, at.lane, bv);
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        acc[r][c] = relu(__fadd_rn(acc[r][c], bv[c]));
    if constexpr (At::kStores) at.keep_h(l, s, acc);
    if (l == kLayers - 1) break;
    if constexpr (At::kStores) at.keep_mask(l, s, acc);
    __syncthreads();                              // every read of Hs done
    to_hs<ROWS>(hs, at.m0, at.lane, acc);
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }
}

// the three outputs w3 h8 (w3: 3 x 256, rows of an output layer) of row
// my_row, on its lanes: per lane over its 8 columns, then over the warp
template <int ROWS>
__device__ __forceinline__ void three_outputs(
    const float (&acc)[ROWS][kCols], const float* __restrict__ w3,
    int lane, float (&out)[3]) {
  constexpr int kSpan = Tile<ROWS>::kSpan;
  float part_out[kSpan][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float wo[kCols];
    load_cols(w3 + j * kW, lane, wo);
#pragma unroll
    for (int r = 0; r < kSpan; ++r) {
      float v = 0.f;
      if (r < ROWS) {
        v = acc[r][0] * wo[0];
#pragma unroll
        for (int c = 1; c < kCols; ++c) v = fmaf(acc[r][c], wo[c], v);
      }
      part_out[r][j] = v;
    }
  }
  reduce_rows<kSpan>(part_out, lane, 16, out);
}

// The four stages of one RK4 step of the block's rows of y (n x 3) through
// the net (w: the packed K-major trunk, bias, tbias, w_out, b_out, scale,
// h2 = dt/2, h1 = dt: d3gs_ode_rk4's), in smem (Tile<ROWS>::kSmemBytes at
// least), each stage one `trunk_eval` and the output. On return y0 is the
// lane's row of y (0 past n) and ks its k1 + 2 k2 + 2 k3 + k4. Where
// At::kStores (the backward's `Place`), each stage also keeps what
// `trunk_eval` keeps.
template <int ROWS, class At>
__device__ __forceinline__ void rk4_stages(
    float* smem, const At& at, const float* __restrict__ y, int n,
    const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ tbias, const float* __restrict__ w_out,
    const float* __restrict__ b_out, float scale, float h2, float h1,
    float (&y0)[3], float (&ks)[3]) {
  using T = Tile<ROWS>;
  start_ring(smem + (kW + kXRows) * T::kStride, w, at.tid);
  if (at.tid < T::kBM)
    smem[kW * T::kStride + act_index<ROWS>(kXDim, at.tid)] = 0.f;

  float yi[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    y0[j] = at.keeps && at.row < n ? y[3 * at.row + j] : 0.f;
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
    const int ti = s == 0 ? 0 : (s == 3 ? 2 : 1);  // t, t + dt/2, t + dt
    trunk_eval<kSeq, ROWS>(smem, at, s, yi, n, w, bias, tbias + 2 * ti * kW,
                           g, acc);
    // k_s = (W_out h + b_out) * scale, of row my_row on its lanes
    float k[3];
    three_outputs<ROWS>(acc, w_out, at.lane, k);
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
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
}

// The tiles of a step of `rows` rows: whole waves of 128-row blocks, then
// the rest as one wave of the smallest tile of 64, 96 or 128 rows that
// holds it (see ode_rk4.cu's "Tiles"), for the current device's SM count.
// launch(Tile<ROWS>{}, row0, count) launches a tile's blocks over rows
// [row0, row0 + count); returns the first error (cudaSuccess if none).
template <class Launch>
cudaError_t plan_waves(int rows, Launch launch) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int wave = sms * Tile<16>::kBM;
  const int full = rows / wave * wave;
  const int rest = rows - full;
  if (full > 0) err = launch(Tile<16>{}, 0, full);
  if (err == cudaSuccess && rest > 0) {
    if (rest <= sms * Tile<8>::kBM)
      err = launch(Tile<8>{}, full, rest);
    else if (rest <= sms * Tile<12>::kBM)
      err = launch(Tile<12>{}, full, rest);
    else
      err = launch(Tile<16>{}, full, rest);
  }
  return err;
}

}  // namespace d3gs_ode
