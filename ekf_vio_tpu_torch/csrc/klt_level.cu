// klt_level: one whole pyramid level of Lucas-Kanade tracking for N
// features with a fixed iteration count, on sm_90a.
//
// Replaces the TPU kernel ekf_vio_tpu/frontend/pallas_klt.py _kernel
// (launched through track_level_pallas), the tracker the JAX package runs
// on the levels of at least 40x40 px when the corr-table tracker does not
// apply (a window other than 21 px, level 0 of at least 64 Ki px).  Its
// one-hot bf16 matmul extraction and selector matmuls existed to keep the
// TPU's matrix unit busy; here the patches sit in shared memory and every
// iteration resamples the window directly.  Semantics are those of the
// Pallas kernel, whose plain PyTorch twin is
// ekf_vio_tpu_torch/frontend/klt.py track_level_klt_plain:
//   * 40x40 patches at origin floor(nan_to_num(pos)) - 17, clamped to
//     [0, W-40] x [0, H-40] so the patch lies inside the level; values
//     rounded to bf16 (round to nearest even), as the one-hot bf16
//     extraction rounds them;
//   * Scharr gradients edge-replicated at the PATCH border, in the
//     kernel's order: gx = vsmooth(c+1) - vsmooth(c-1),
//     gy = hsmooth(r+1) - hsmooth(r-1);
//   * bilinear windows whose two taps clamp to [0, 39] inside the patch,
//     rows interpolated first, then columns;
//   * exactly `iters` iterations of g += delta * live, live *= 1 - conv
//     (conv: |delta|^2 < eps^2), live starting at valid & H invertible.
//     A block leaves the loop at the first iteration that starts with
//     live == 0, after applying that iteration's delta * 0: g is frozen
//     from then on, so every later iteration would compute the same delta,
//     and a non-finite delta turns g into NaN exactly once (NaN * 0 = NaN);
//   * err: the mean absolute residual at the final g (the Pallas kernel's
//     mean of row means, equal in exact arithmetic);
//   * ok = in bounds (g and q inside [1, dim-2)) & det > 1e-12 & within
//     +-5 px of the incoming guess & min_eig > min_eigen, NOT including
//     valid (the caller ANDs it); NaN comparisons are false.
// Element-wise arithmetic uses the round-to-nearest intrinsics so the
// compiler fuses nothing into FMAs that the twin rounds twice; the window
// sums are block reductions whose order differs from PyTorch's.
//
// Design: one 256-thread block per feature; the prev and cur patches and
// both gradient patches (25.6 KB) and the three win x win windows (3.5 KB
// at win = 17) live in shared memory.  Each iteration does one block
// reduction of two sums (warp shuffles, then one __syncthreads over a
// double-buffered scratch); every thread derives the same step from the
// reduced sums, so the block leaves its loop on its own.
//
// What bounds it on an H100: latency.  At N = 128 there is about one
// block per SM, each level is a chain of up to ~30 dependent block
// reductions, and a level reads ~1.6 MB of patches and does well under
// 0.1 GFLOP, far below both rooflines.  Several features per block and
// fewer barriers are later work.
//
// C interface: klt_track_level(...) launches on `stream` of `device` and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPatch = 40;   // pallas_klt.PATCH
constexpr int kPad = 17;     // pallas_klt._PAD
constexpr int kMargin = 5;   // pallas_klt._MARGIN
constexpr int kRedSlots = 3;  // widest block reduction (the Hessian)

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// torch.nan_to_num: NaN -> 0, +-inf -> +-FLT_MAX.
__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return 0.0f;
  if (isinf(v)) return v > 0.0f ? FLT_MAX : -FLT_MAX;
  return v;
}

// Patch origin along one axis: floor(nan_to_num(v)) - 17 clamped to
// [0, hi].  Clamping before the cast keeps the conversion in range.
__device__ __forceinline__ float origin(float v, int hi) {
  const float o = __fsub_rn(floorf(nan_to_num(v)), static_cast<float>(kPad));
  return fminf(fmaxf(o, 0.0f), static_cast<float>(hi));
}

// int of an already-floored window base, for addressing only: clamped to
// +-2 * kPatch so the cast cannot overflow; every tap index derived from
// it is clamped into the patch, where the clamp gives the same taps.
__device__ __forceinline__ int index_of(float floored) {
  const float lim = static_cast<float>(2 * kPatch);
  return static_cast<int>(fminf(fmaxf(nan_to_num(floored), -lim), lim));
}

struct Window {
  int x0, y0;    // integer window base (floor of the base coordinate)
  float fx, fy;  // fractional offset (NaN for a NaN centre)
};

__device__ __forceinline__ Window window_at(float cx, float cy, float half) {
  const float bx = __fsub_rn(cx, half), by = __fsub_rn(cy, half);
  const float flx = floorf(bx), fly = floorf(by);
  Window w;
  w.x0 = index_of(flx);
  w.y0 = index_of(fly);
  w.fx = __fsub_rn(bx, flx);
  w.fy = __fsub_rn(by, fly);
  return w;
}

// The two taps of window row/column i (pallas_klt._selector): indices
// clamp into the patch, and a clamped pair that coincides carries both
// weights.
struct Taps {
  int a, b;
  float wa, wb;
};

__device__ __forceinline__ Taps taps(int i0, float f, int i) {
  Taps t;
  t.a = clampi(i0 + i, 0, kPatch - 1);
  t.b = clampi(i0 + i + 1, 0, kPatch - 1);
  t.wa = __fsub_rn(1.0f, f);
  t.wb = f;
  if (t.a == t.b) {
    t.wa = __fadd_rn(t.wa, t.wb);
    t.wb = 0.0f;
  }
  return t;
}

// Bilinear sample of the 40 x 40 array S: rows first, then columns.
__device__ __forceinline__ float sample(const float* S, const Taps& ty,
                                        const Taps& tx) {
  const float ta = __fadd_rn(__fmul_rn(ty.wa, S[ty.a * kPatch + tx.a]),
                             __fmul_rn(ty.wb, S[ty.b * kPatch + tx.a]));
  const float tb = __fadd_rn(__fmul_rn(ty.wa, S[ty.a * kPatch + tx.b]),
                             __fmul_rn(ty.wb, S[ty.b * kPatch + tx.b]));
  return __fadd_rn(__fmul_rn(tx.wa, ta), __fmul_rn(tx.wb, tb));
}

// Sum K values over the block; every thread returns the same sums.  `red`
// holds two buffers of kWarps * kRedSlots floats used in turn, so one
// __syncthreads per reduction suffices: a buffer is rewritten only after
// the next reduction's barrier, which every reader of it has passed.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red,
                                          int& parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  }
  float* buf = red + parity * kWarps * kRedSlots;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) buf[warp * kRedSlots + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += buf[w * kRedSlots + k];
    v[k] = s;
  }
  parity ^= 1;
}

constexpr float kSmooth0 = 3.0f / 32.0f;
constexpr float kSmooth1 = 10.0f / 32.0f;

__global__ void __launch_bounds__(kThreads)
    klt_level_kernel(const float* __restrict__ prev,
                     const float* __restrict__ cur, int h, int w,
                     const float* __restrict__ q,
                     const float* __restrict__ g_in,
                     const unsigned char* __restrict__ valid, int win,
                     int iters, float eps2, float min_eigen,
                     float* __restrict__ g_out,
                     unsigned char* __restrict__ ok_out,
                     float* __restrict__ eig_out,
                     float* __restrict__ err_out) {
  extern __shared__ float smem[];
  constexpr int pp = kPatch * kPatch;
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int ww = win * win;
  float* ps = smem;        // prev patch
  float* cs = ps + pp;     // cur patch
  float* gxp = cs + pp;    // Scharr x of the prev patch
  float* gyp = gxp + pp;   // Scharr y of the prev patch
  float* tpl = gyp + pp;   // template window
  float* wx = tpl + ww;    // gradient windows
  float* wy = wx + ww;
  float* red = wy + ww;    // 2 x kWarps x kRedSlots reduction scratch

  const float qx = q[2 * n], qy = q[2 * n + 1];
  const float g0x = g_in[2 * n], g0y = g_in[2 * n + 1];
  const bool is_valid = valid[n] != 0;

  const float pox = origin(qx, w - kPatch), poy = origin(qy, h - kPatch);
  const float cox = origin(g0x, w - kPatch), coy = origin(g0y, h - kPatch);
  const int pxi = static_cast<int>(pox), pyi = static_cast<int>(poy);
  const int cxi = static_cast<int>(cox), cyi = static_cast<int>(coy);

  for (int k = tid; k < pp; k += kThreads) {
    const int r = k / kPatch, c = k - r * kPatch;
    ps[k] = bf16_round(prev[(pyi + r) * w + pxi + c]);
    cs[k] = bf16_round(cur[(cyi + r) * w + cxi + c]);
  }
  __syncthreads();

  // Scharr gradients of the prev patch, edge-replicated at its border
  for (int k = tid; k < pp; k += kThreads) {
    const int r = k / kPatch, c = k - r * kPatch;
    const int rm = max(r - 1, 0), rp = min(r + 1, kPatch - 1);
    const int cm = max(c - 1, 0), cp = min(c + 1, kPatch - 1);
    auto vsmooth = [&](int col) {
      return __fadd_rn(
          __fadd_rn(__fmul_rn(ps[rm * kPatch + col], kSmooth0),
                    __fmul_rn(ps[r * kPatch + col], kSmooth1)),
          __fmul_rn(ps[rp * kPatch + col], kSmooth0));
    };
    auto hsmooth = [&](int row) {
      return __fadd_rn(
          __fadd_rn(__fmul_rn(ps[row * kPatch + cm], kSmooth0),
                    __fmul_rn(ps[row * kPatch + c], kSmooth1)),
          __fmul_rn(ps[row * kPatch + cp], kSmooth0));
    };
    gxp[k] = __fsub_rn(vsmooth(cp), vsmooth(cm));
    gyp[k] = __fsub_rn(hsmooth(rp), hsmooth(rm));
  }
  __syncthreads();

  // template and gradient windows at the prev position, and the Hessian
  const float half_f = 0.5f * static_cast<float>(win - 1);
  const Window tw = window_at(__fsub_rn(qx, pox), __fsub_rn(qy, poy), half_f);
  float hs[3] = {0.0f, 0.0f, 0.0f};
  for (int k = tid; k < ww; k += kThreads) {
    const int i = k / win, j = k - i * win;
    const Taps ty = taps(tw.y0, tw.fy, i);
    const Taps tx = taps(tw.x0, tw.fx, j);
    const float ix = sample(gxp, ty, tx);
    const float iy = sample(gyp, ty, tx);
    tpl[k] = sample(ps, ty, tx);
    wx[k] = ix;
    wy[k] = iy;
    hs[0] += ix * ix;
    hs[1] += ix * iy;
    hs[2] += iy * iy;
  }
  int parity = 0;
  block_sum<3>(hs, red, parity);
  const float gxx = hs[0], gxy = hs[1], gyy = hs[2];
  const float tr = __fadd_rn(gxx, gyy);
  const float dd = __fsub_rn(gxx, gyy);
  const float det_half = sqrtf(fmaxf(
      __fadd_rn(__fdiv_rn(__fmul_rn(dd, dd), 4.0f), __fmul_rn(gxy, gxy)),
      0.0f));
  const float min_eig = __fdiv_rn(__fsub_rn(__fdiv_rn(tr, 2.0f), det_half),
                                  static_cast<float>(ww));
  const float det = __fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy));
  const bool inv_ok = det > 1e-12f;
  const float det_safe = inv_ok ? det : 1.0f;
  const float i00 = __fdiv_rn(gyy, det_safe);
  const float i01 = __fdiv_rn(-gxy, det_safe);
  const float i11 = __fdiv_rn(gxx, det_safe);

  // fixed-count Gauss-Newton on the cur patch, seeded at the guess
  float gx = g0x, gy = g0y;
  float live = (is_valid && inv_ok) ? 1.0f : 0.0f;
  for (int it = 0; it < iters; ++it) {
    const Window cw = window_at(__fsub_rn(gx, cox), __fsub_rn(gy, coy),
                                half_f);
    float b[2] = {0.0f, 0.0f};
    for (int k = tid; k < ww; k += kThreads) {
      const int i = k / win, j = k - i * win;
      const float r = __fsub_rn(
          tpl[k], sample(cs, taps(cw.y0, cw.fy, i), taps(cw.x0, cw.fx, j)));
      b[0] += r * wx[k];
      b[1] += r * wy[k];
    }
    block_sum<2>(b, red, parity);
    const float dx = __fadd_rn(__fmul_rn(i00, b[0]), __fmul_rn(i01, b[1]));
    const float dy = __fadd_rn(__fmul_rn(i01, b[0]), __fmul_rn(i11, b[1]));
    gx = __fadd_rn(gx, __fmul_rn(dx, live));
    gy = __fadd_rn(gy, __fmul_rn(dy, live));
    if (live == 0.0f) break;  // frozen: later iterations repeat this one
    if (__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) < eps2) live = 0.0f;
  }

  // mean absolute residual at the final position
  const Window fw = window_at(__fsub_rn(gx, cox), __fsub_rn(gy, coy), half_f);
  float e[1] = {0.0f};
  for (int k = tid; k < ww; k += kThreads) {
    const int i = k / win, j = k - i * win;
    e[0] += fabsf(__fsub_rn(
        tpl[k], sample(cs, taps(fw.y0, fw.fy, i), taps(fw.x0, fw.fx, j))));
  }
  block_sum<1>(e, red, parity);

  if (tid == 0) {
    const float m = static_cast<float>(kMargin);
    const bool within = fabsf(__fsub_rn(gx, g0x)) <= m &&
                        fabsf(__fsub_rn(gy, g0y)) <= m;
    const float xmax = static_cast<float>(w - 2);
    const float ymax = static_cast<float>(h - 2);
    const bool in_bounds = gx >= 1.0f && gy >= 1.0f && gx < xmax &&
                           gy < ymax && qx >= 1.0f && qy >= 1.0f &&
                           qx < xmax && qy < ymax;
    g_out[2 * n] = gx;
    g_out[2 * n + 1] = gy;
    ok_out[n] =
        (in_bounds && inv_ok && within && min_eig > min_eigen) ? 1 : 0;
    eig_out[n] = min_eig;
    err_out[n] = __fdiv_rn(__fdiv_rn(e[0], static_cast<float>(win)),
                           static_cast<float>(win));
  }
}

}  // namespace

extern "C" int klt_track_level(const void* prev, const void* cur, int h,
                               int w, const void* q, const void* g_in,
                               const void* valid, int n, int win, int iters,
                               float eps2, float min_eigen, void* g_out,
                               void* ok_out, void* eig_out, void* err_out,
                               int device, void* stream) {
  if (n == 0) return 0;
  if (h < kPatch || w < kPatch || win < 1 || win > kPatch)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const size_t smem = (4 * kPatch * kPatch + 3 * win * win +
                       2 * kWarps * kRedSlots) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        klt_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  klt_level_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prev), static_cast<const float*>(cur), h, w,
      static_cast<const float*>(q), static_cast<const float*>(g_in),
      static_cast<const unsigned char*>(valid), win, iters, eps2, min_eigen,
      static_cast<float*>(g_out), static_cast<unsigned char*>(ok_out),
      static_cast<float*>(eig_out), static_cast<float*>(err_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
