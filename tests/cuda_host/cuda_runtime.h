// A stand-in for the CUDA runtime, so that a kernel source of
// d3gs_tpu_torch/csrc compiles with g++ and runs on the CPU
// (tests/torch_port_cuda_host.py makes the text edits it needs): one
// std::thread per lane, the blocks of a launch in turn, __syncthreads as a
// barrier of the block's threads, a shuffle as an exchange between two
// barriers of the warp's. Slow (a 128-row block of the RK4 backward takes
// seconds) and sequential in its blocks, but the kernel's own arithmetic,
// index by index.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(a, b)
#define __align__(x)

struct dim3 { unsigned x = 1, y = 1, z = 1; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
constexpr int cudaDevAttrMultiProcessorCount = 16;

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

struct HostBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  std::vector<float> lanes;                     // a shuffle's values
  std::vector<float> smem;                      // dynamic shared memory
};
inline HostBlock* host_block;

inline void __syncthreads() { host_block->bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int b) {
  const int t = threadIdx.x, w = t / 32, l = t % 32;
  host_block->lanes[t] = v;
  host_block->warp_bar[w]->arrive_and_wait();
  const float r = host_block->lanes[w * 32 + (l ^ b)];
  host_block->warp_bar[w]->arrive_and_wait();
  return r;
}
// one rounding, as the device's: volatile keeps g++ from contracting
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline float* host_smem() { return host_block->smem.data(); }

template <class K> inline int cudaFuncSetAttribute(K, int, int) { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
// the number of SMs a launch plans its waves for: HOST_SMS, default 2
inline int cudaDeviceGetAttribute(int* v, int, int) {
  const char* e = std::getenv("HOST_SMS");
  *v = e ? std::atoi(e) : 2;
  return 0;
}
inline int cudaGetLastError() { return 0; }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}

// kernel<<<grid, block, smem, stream>>>(...): the blocks in turn, each
// with its threads at once; shared memory starts as NaN
inline void host_launch(unsigned grid, unsigned block, size_t smem,
                        std::function<void()> body) {
  gridDim.x = grid;
  blockDim.x = block;
  for (unsigned b = 0; b < grid; ++b) {
    HostBlock hb;
    hb.bar = std::make_unique<std::barrier<>>(block);
    for (unsigned w = 0; w < block / 32; ++w)
      hb.warp_bar.push_back(std::make_unique<std::barrier<>>(32));
    hb.lanes.assign(block, 0.f);
    hb.smem.assign(smem / 4 + 4, std::nanf(""));
    host_block = &hb;
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block; ++t)
      threads.emplace_back([&body, t, b] {
        threadIdx.x = t;
        blockIdx.x = b;
        body();
      });
    for (auto& th : threads) th.join();
  }
}
