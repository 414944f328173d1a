// Checks, not kernels of any path: two pieces the blend kernels rely on,
// as nvcc compiles them, for chip_smoke.py's phase 3.
//   * d3gs_blend_cull_check: the per-warp cull (blend_common.cuh::rows_hit)
//     against the kernels' own alpha. For every (record, strip) pair of a
//     grid of 16x2 strips, one thread runs rows_hit; where it rules the
//     strip out, the thread evaluates alpha = opa * expf(gauss_power(...))
//     at the strip's 32 pixels and counts the pair as a miss if any pixel
//     reaches 1/255 with power <= 0 (the include rule of both kernels).
//   * d3gs_blend_log1p_check: the forward's log1p_neg against the
//     library's log1pf on every f32 alpha in (0, 0.99].

#include "blend_common.cuh"

namespace {

using namespace d3gs_blend;

// counts[0]: pairs ruled out although a pixel reaches 1/255 (must be 0);
// counts[1]: pairs kept; counts[2]: pairs ruled out whose largest alpha over
// the strip is above 0.9 / 255 (the edges the check is meant to probe).
__global__ void cull_check_kernel(const float* __restrict__ records,
                                  int record_stride, int n_records,
                                  int strips_x, int strips_y,
                                  unsigned long long* counts) {
  const long long pair = static_cast<long long>(blockIdx.x) * blockDim.x
                         + threadIdx.x;
  const long long n_strips = static_cast<long long>(strips_x) * strips_y;
  if (pair >= n_records * n_strips) return;
  const int g = static_cast<int>(pair / n_strips);
  const int s = static_cast<int>(pair % n_strips);
  const float x0 = static_cast<float>(kTile * (s % strips_x));
  const float y0 = static_cast<float>(2 * (s / strips_x));
  const Record r = load_record(records, record_stride, g);
  if (rows_hit(r, x0, y0)) {
    atomicAdd(counts + 1, 1ull);
    return;
  }
  float peak = 0.0f;
  bool miss = false;
  for (int p = 0; p < 32; ++p) {
    const float dx = r.q0.x - (x0 + static_cast<float>(p & 15));
    const float dy = r.q0.y - (y0 + static_cast<float>(p >> 4));
    const float power = gauss_power(r.q0, r.q1, dx, dy);
    const float raw = r.q2.x * expf(power);
    if (!(power > 0.0f)) {
      miss = miss || !(raw < kAlphaMin);
      peak = fmaxf(peak, raw);
    }
  }
  if (miss) atomicAdd(counts, 1ull);
  if (peak > 0.9f * kAlphaMin) atomicAdd(counts + 2, 1ull);
}

// Every f32 alpha in (0, 0.99]: log1p_neg against the library's log1pf.
__global__ void log1p_check_kernel(unsigned long long* mismatches) {
  const unsigned last_bits = __float_as_uint(kAlphaMax);
  const unsigned stride = gridDim.x * blockDim.x;
  unsigned long long bad = 0;
  for (unsigned b = blockIdx.x * blockDim.x + threadIdx.x; b <= last_bits;
       b += stride) {
    const float a = __uint_as_float(b);
    bad += __float_as_uint(log1p_neg(a)) != __float_as_uint(log1pf(-a))
           && a != 0.0f;
  }
  if (bad) atomicAdd(mismatches, bad);
}

}  // namespace

// Adds the three counts of cull_check_kernel for `records` (n_records rows,
// 16-byte aligned) against the strips_x x strips_y strips at (16 i, 2 j)
// into counts[0..2] (zeroed by the caller); returns cudaGetLastError().
extern "C" int d3gs_blend_cull_check(const float* records, int record_stride,
                                     int n_records, int strips_x,
                                     int strips_y, unsigned long long* counts,
                                     void* stream) {
  const long long pairs =
      static_cast<long long>(n_records) * strips_x * strips_y;
  if (pairs > 0) {
    const int threads = 256;
    cull_check_kernel<<<static_cast<unsigned>((pairs + threads - 1) / threads),
                        threads, 0, static_cast<cudaStream_t>(stream)>>>(
        records, record_stride, n_records, strips_x, strips_y, counts);
  }
  return static_cast<int>(cudaGetLastError());
}

// Counts into *mismatches (zeroed by the caller) the f32 alpha in
// (0, 0.99] where log1p_neg(alpha) and log1pf(-alpha) differ in any bit;
// returns cudaGetLastError().
extern "C" int d3gs_blend_log1p_check(unsigned long long* mismatches,
                                      void* stream) {
  log1p_check_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      mismatches);
  return static_cast<int>(cudaGetLastError());
}
