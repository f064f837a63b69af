// stamp: the device half of the tracing recorder (utils/profiling.py), one
// thread a launch, on sm_90a.
//
// Replaces no TPU kernel: the JAX package traces with jax.profiler, which
// sees inside its compiled program.  A CUDA graph's replay runs no host
// code, so spans inside a replayed engine.step are stamped by the card
// itself, with nodes captured into the graph like any other kernel.
//
// The recorder owns a ring [rows, slots] of int64 and a step counter
// [1] int64 on the card.  Row (counter % rows) belongs to the current step:
//   slot 0  the id of the step's slot layout, written last (0: unfinished)
//   slot 1  the counter value, i.e. the step's frame id
//   slot 2+ stamps and counts, one slot per boundary, fixed at capture
// Ops (one launch each):
//   OP_BEGIN  counter += 1; clears slot 0, writes slot 1 and a stamp
//   OP_TIME   a stamp: %globaltimer (ns) at the kernel's start
//   OP_SUM    the sum of `n` integers of `elem` bytes (1: bool, 4: int32,
//             8: int64): a count, n lanes of it under vmap
//   OP_CONST  `constant` (the layout id)
// A replay re-runs every op, so nothing is read back per step: the host
// copies the ring once when it flushes.
//
// What bounds it on an H100: one launch's fixed cost (a graph node of a
// few microseconds at most); the stores are 8 bytes.
//
// timer_probe: one thread reads %globaltimer `iters` times and writes
// [smallest nonzero step, number of changes, last - first] (ns), the
// timer's resolution on this card.
//
// C interface: ring_write(ring, counter, rows, slots, slot, op, values, n,
// elem, constant, device, stream) and timer_probe(out, iters, device, stream)
// launch on `stream` of `device` and return cudaGetLastError().  Each
// launch counts itself on the card (launch_count.cuh).

#include <climits>
#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

enum Op { kBegin = 0, kTime = 1, kSum = 2, kConst = 3 };

__device__ __forceinline__ long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__device__ __forceinline__ long long value_at(const void* values, int elem,
                                              int i) {
  if (elem == 1) return static_cast<const unsigned char*>(values)[i];
  if (elem == 4) return static_cast<const int*>(values)[i];
  return static_cast<const long long*>(values)[i];
}

__global__ void ring_write_kernel(long long* ring, long long* counter,
                                  int rows, int slots, int slot, int op,
                                  const void* values, int n, int elem,
                                  long long constant) {
  const long long now = globaltimer();  // before any load: the stamp
  count_launch();
  long long c = counter[0];
  if (op == kBegin) counter[0] = ++c;
  long long* row = ring + (c % rows) * slots;
  long long v = now;
  if (op == kBegin) {
    row[0] = 0;
    row[1] = c;
  } else if (op == kSum) {
    v = 0;
    for (int i = 0; i < n; ++i) v += value_at(values, elem, i);
  } else if (op == kConst) {
    v = constant;
  }
  row[slot] = v;
}

__global__ void timer_probe_kernel(long long* out, int iters) {
  count_launch();
  const long long first = globaltimer();
  long long prev = first, step = LLONG_MAX, changes = 0;
  for (int i = 0; i < iters; ++i) {
    const long long t = globaltimer();
    if (t != prev) {
      if (t - prev < step) step = t - prev;
      ++changes;
      prev = t;
    }
  }
  out[0] = step;
  out[1] = changes;
  out[2] = prev - first;
}

}  // namespace

extern "C" int ring_write(void* ring, void* counter, int rows, int slots,
                          int slot, int op, const void* values, int n,
                          int elem, long long constant, int device,
                          void* stream) {
  if (rows < 1 || slot < 0 || slot >= slots || op < kBegin || op > kConst ||
      (op == kSum && (n < 0 || (n > 0 && values == nullptr) ||
                      (elem != 1 && elem != 4 && elem != 8))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_write_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<long long*>(counter), rows,
      slots, slot, op, values, n, elem, constant);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int timer_probe(void* out, int iters, int device, void* stream) {
  if (iters < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  timer_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
