// Row scatter-add (a segment sum) for Hopper (sm_90a):
// out[rank[m], :] += g[m, :] for every row m of an (M, 16) f32 array.
//
// Replaces: tools/exp_vmem_scatter.py::kern (launched by run), the TPU
// microbenchmark that keeps an (N1, 16) accumulator resident in VMEM across
// its sequential grid and adds one gradient row per record at a dynamic
// sublane index, with the ranks brought to SMEM by DMA. On the card the grid
// is parallel and nothing carries from one block to the next, so the
// accumulation goes to device memory with atomics, as csrc/blend_bwd.cu
// reduces its per-duplicate gradients.
//
// Design: one thread per element, 16 consecutive threads per row: the loads
// of g are fully coalesced, and each row's 16 atomicAdds (their results
// unused, so they compile to red.global.add.f32) land on one 64-byte output
// row. The caller zeroes `out`. Float addition is not associative and the
// atomics arrive in no fixed order, so the sums differ from run to run in
// the last bits.
//
// What bounds it on the H100: bytes. Counting each input once and the
// output once, 352,256 rows of 64 B, their 4-byte ranks and the 44,032 x
// 64 B accumulator move 26.7 MB (0.008 ms at 3.35 TB/s); the 5.6 M f32
// additions are negligible. The atomics are served by the L2, which holds
// the 2.8 MB accumulator; rows that share a rank serialise there.

#include <cuda_runtime.h>

namespace {

constexpr int kRec = 16;
constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
scatter_add_rows_kernel(const float* __restrict__ g,
                        const int* __restrict__ rank, long long n_elems,
                        float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n_elems) return;
  const long long dst = static_cast<long long>(__ldg(rank + i / kRec)) * kRec
                        + (i % kRec);
  atomicAdd(out + dst, __ldg(g + i));
}

}  // namespace

// Adds the n_rows rows of the contiguous (n_rows, 16) `g` into the rows
// `rank` (int32, each in [0, N1), checked by the caller) of the contiguous
// (N1, 16) `out`. Launches on `stream` and returns cudaGetLastError().
extern "C" int d3gs_scatter_add_rows(const float* g, const int* rank,
                                     long long n_rows, float* out,
                                     void* stream) {
  const long long n_elems = n_rows * kRec;
  if (n_elems > 0) {
    const long long blocks = (n_elems + kBlock - 1) / kBlock;
    scatter_add_rows_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        g, rank, n_elems, out);
  }
  return static_cast<int>(cudaGetLastError());
}
