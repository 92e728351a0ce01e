// Stand-ins for the CUDA headers that let g++ compile a kernel source and
// run one CTA of a kernel on the CPU, each CUDA thread a std::thread:
// __syncthreads is a barrier of the CTA's threads, __shfl_*_sync a barrier
// of the warp's around a shared slot, dynamic shared memory a global array
// the harness defines.  Kernels that use static __shared__ variables or
// atomics across CTAs do not run correctly here; it serves the register
// kernel (tests/_torch_regs_emu.cpp).  Installed as cuda_runtime.h and
// cuda_bf16.h in a build directory of the test.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <memory>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#define __restrict__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 {
  unsigned x, y, z;
};
extern thread_local uint3 threadIdx, blockIdx;
extern dim3 blockDim, gridDim;

// The CTA's barrier, one barrier a warp, and the warp's shuffle slots.
struct EmuCta {
  std::unique_ptr<std::barrier<>> block;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<float> slots;
};
extern EmuCta emu_cta;

inline int emu_tid() { return threadIdx.y * blockDim.x + threadIdx.x; }
inline void __syncthreads() { emu_cta.block->arrive_and_wait(); }
inline void __threadfence() {}
inline float emu_shfl(float v, int src_lane) {
  const int t = emu_tid(), w = t / 32;
  emu_cta.slots[t] = v;
  emu_cta.warps[w]->arrive_and_wait();
  const float r = emu_cta.slots[w * 32 + src_lane];
  emu_cta.warps[w]->arrive_and_wait();
  return r;
}
inline float __shfl_up_sync(unsigned, float v, int d) {
  const int lane = emu_tid() & 31;
  return emu_shfl(v, lane >= d ? lane - d : lane);
}
inline float __shfl_down_sync(unsigned, float v, int d) {
  const int lane = emu_tid() & 31;
  return emu_shfl(v, lane + d < 32 ? lane + d : lane);
}

struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __ldcg(const float* p) { return *p; }
using std::max;
using std::min;

// Enough of the runtime API for the launchers to compile (never called).
typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
inline cudaError_t cudaGetDevice(int*) { return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int*, cudaDeviceAttr, int) {
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, K, int,
                                                          size_t) {
  return cudaSuccess;
}
inline cudaError_t cudaLaunchCooperativeKernel(const void*, dim3, dim3,
                                               void**, size_t, cudaStream_t) {
  return cudaSuccess;
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return *p += v;
}

// bf16 only so that the source compiles; the harness runs fp32.
struct __nv_bfloat16 {
  unsigned short bits;
};
inline float __bfloat162float(__nv_bfloat16) { return 0.f; }
inline __nv_bfloat16 __float2bfloat16(float) { return {}; }
