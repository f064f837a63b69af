// launch_count: each kernel of a library counts its own launches on the
// card, so the replays of a captured CUDA graph count as eager launches
// do (a replay runs no host code, so no host-side counter can see it).
//
// The kernel calls count_launch() first thing: block (0, 0, 0)'s thread 0
// adds one to g_launches, the library's counter on that device.  C
// interface: launch_count(device, out) reads it and
// reset_launch_count(device) sets it to 0, each a synchronous copy on
// `device`; both return a CUDA error code.  Included by one .cu each, so
// every library has its own counter.

#pragma once

#include <cuda_runtime.h>

__device__ unsigned long long g_launches = 0;

__device__ __forceinline__ void count_launch() {
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0)
    atomicAdd(&g_launches, 1ull);
}

extern "C" int launch_count(int device, unsigned long long* out) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, g_launches, sizeof(*out));
  cudaSetDevice(prev);
  return static_cast<int>(err);
}

extern "C" int reset_launch_count(int device) {
  const unsigned long long zero = 0;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_launches, &zero, sizeof(zero));
  cudaSetDevice(prev);
  return static_cast<int>(err);
}
