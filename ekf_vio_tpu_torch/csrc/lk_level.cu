// lk_level: one pyramid level of Lucas-Kanade tracking for N features,
// on sm_90a.
//
// Replaces the two TPU kernels of ekf_vio_tpu/frontend/pallas_lk.py,
// _prep_kernel (patches, Scharr gradients, template and gradient windows,
// Hessian, corr tables) and _iter_kernel (the LK iterations on the corr
// tables, status, residual), fused into one launch per level.  The corr
// tables, the bf16 one-hot extraction and the block tiers existed to fit
// the MXU and VMEM; here every iteration resamples the window directly
// from shared memory.  Semantics are those of
// ekf_vio_tpu/frontend/klt.py _track_level, whose plain PyTorch twin is
// ekf_vio_tpu_torch/frontend/klt.py track_level_plain:
//   * p = win + 11 square patches anchored at floor(pos) - (half + 5),
//     clamped at the image border, values rounded to bf16 (round to
//     nearest even), as the reference's one-hot bf16 extraction rounds;
//   * Scharr gradients (smooth [3,10,3]/32 x derive [-1,0,1]),
//     edge-replicated at the patch border;
//   * bilinear windows whose two taps clamp to [0, p-1] inside the patch,
//     interpolating rows first, then columns;
//   * up to `iters` Gauss-Newton steps, stopping when step^2 < eps^2;
//   * status: in bounds (g and q inside [1, dim-2) of this level), H
//     invertible (det > 1e-12), within +-5 px of the incoming guess, and at
//     level 0 (gate_eig) min_eig > min_eigen; always AND valid.
// Element-wise arithmetic uses the round-to-nearest intrinsics so the
// compiler fuses nothing into FMAs that the plain twin rounds twice; the
// window sums are block reductions whose order differs from PyTorch's.
//
// Design: one 256-thread block per feature.  The prev and cur patches,
// both gradient patches and the three win x win windows live in shared
// memory (21.7 KB at win = 21).  Each iteration resamples the cur window
// and does one block reduction of two sums (warp shuffles, then one
// __syncthreads over a double-buffered scratch); every thread derives the
// same step from the reduced sums, so each block leaves its loop on its
// own when its feature converges.
//
// What bounds it on an H100: latency.  At the main path's N = 128 there is
// about one block per SM, and each level is ~30 dependent block
// reductions; the whole level reads ~1 MB and does ~40 MFLOP, far below
// both rooflines.  Making it fast (several features per block, fewer
// syncs) is later work.
//
// C interface: lk_track_level(...) launches on `stream` of `device` and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMargin = 5;  // klt._SEARCH_MARGIN: px of search per level
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

// int of an already-floored value, for addressing only: clamped to
// [-lim, lim] so the conversion cannot overflow.  Every index derived from
// it is clamped into the patch or image, where the clamp gives the same
// taps as the unclamped value would.
__device__ __forceinline__ int index_of(float floored, int lim) {
  const float v = nan_to_num(floored);
  return static_cast<int>(fminf(fmaxf(v, -static_cast<float>(lim)),
                                static_cast<float>(lim)));
}

// Placement of a bilinear window inside a p x p patch.
struct Window {
  int x0, y0;    // integer window base (floor of the base coordinate)
  float fx, fy;  // fractional offset
};

__device__ __forceinline__ Window window_at(float cx, float cy, float half,
                                            int p) {
  const float bx = __fsub_rn(cx, half), by = __fsub_rn(cy, half);
  const float flx = floorf(bx), fly = floorf(by);
  Window w;
  w.x0 = index_of(flx, 2 * p);
  w.y0 = index_of(fly, 2 * p);
  w.fx = __fsub_rn(bx, flx);
  w.fy = __fsub_rn(by, fly);
  return w;
}

// The two taps of window row/column i (klt._lerp_selector): indices clamp
// into the patch, and a clamped pair that coincides carries both weights.
struct Taps {
  int a, b;
  float wa, wb;
};

__device__ __forceinline__ Taps taps(int i0, float f, int i, int p) {
  Taps t;
  t.a = clampi(i0 + i, 0, p - 1);
  t.b = clampi(i0 + i + 1, 0, p - 1);
  t.wa = __fsub_rn(1.0f, f);
  t.wb = f;
  if (t.a == t.b) {
    t.wa = __fadd_rn(t.wa, t.wb);
    t.wb = 0.0f;
  }
  return t;
}

// Bilinear sample of the p x p array S: rows first, then columns.
__device__ __forceinline__ float sample(const float* S, int p, const Taps& ty,
                                        const Taps& tx) {
  const float ta = __fadd_rn(__fmul_rn(ty.wa, S[ty.a * p + tx.a]),
                             __fmul_rn(ty.wb, S[ty.b * p + tx.a]));
  const float tb = __fadd_rn(__fmul_rn(ty.wa, S[ty.a * p + tx.b]),
                             __fmul_rn(ty.wb, S[ty.b * p + tx.b]));
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
    lk_level_kernel(const float* __restrict__ prev,
                    const float* __restrict__ cur, int h, int w,
                    const float* __restrict__ q,
                    const float* __restrict__ g_in,
                    const unsigned char* __restrict__ valid, int win,
                    int iters, float eps2, float min_eigen, int gate_eig,
                    float* __restrict__ g_out,
                    unsigned char* __restrict__ ok_out,
                    float* __restrict__ eig_out,
                    float* __restrict__ err_out) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int half = (win - 1) / 2;
  const int p = win + 2 * kMargin + 1;
  const int pp = p * p;
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

  // patch anchors floor(pos) - (half + margin); NaN positions anchor at 0
  const float off = static_cast<float>(half + kMargin);
  const float pax = __fsub_rn(floorf(nan_to_num(qx)), off);
  const float pay = __fsub_rn(floorf(nan_to_num(qy)), off);
  const float cax = __fsub_rn(floorf(nan_to_num(g0x)), off);
  const float cay = __fsub_rn(floorf(nan_to_num(g0y)), off);
  const int pxi = index_of(pax, p + w), pyi = index_of(pay, p + h);
  const int cxi = index_of(cax, p + w), cyi = index_of(cay, p + h);

  for (int k = tid; k < pp; k += kThreads) {
    const int r = k / p, c = k - r * p;
    ps[k] = bf16_round(
        prev[clampi(pyi + r, 0, h - 1) * w + clampi(pxi + c, 0, w - 1)]);
    cs[k] = bf16_round(
        cur[clampi(cyi + r, 0, h - 1) * w + clampi(cxi + c, 0, w - 1)]);
  }
  __syncthreads();

  // Scharr gradients of the prev patch, edge-replicated at its border:
  // x = vertical smooth then horizontal derivative, y = the transpose
  for (int k = tid; k < pp; k += kThreads) {
    const int r = k / p, c = k - r * p;
    const int rm = max(r - 1, 0), rp = min(r + 1, p - 1);
    const int cm = max(c - 1, 0), cp = min(c + 1, p - 1);
    auto vsmooth = [&](int col) {
      return __fadd_rn(__fadd_rn(__fmul_rn(ps[rm * p + col], kSmooth0),
                                 __fmul_rn(ps[r * p + col], kSmooth1)),
                       __fmul_rn(ps[rp * p + col], kSmooth0));
    };
    auto vdiff = [&](int col) {
      return __fsub_rn(ps[rp * p + col], ps[rm * p + col]);
    };
    gxp[k] = __fsub_rn(vsmooth(cp), vsmooth(cm));
    gyp[k] = __fadd_rn(__fadd_rn(__fmul_rn(vdiff(cm), kSmooth0),
                                 __fmul_rn(vdiff(c), kSmooth1)),
                       __fmul_rn(vdiff(cp), kSmooth0));
  }
  __syncthreads();

  // template and gradient windows at the prev position, and the Hessian
  const float half_f = 0.5f * static_cast<float>(win - 1);
  const Window tw = window_at(__fsub_rn(qx, pax), __fsub_rn(qy, pay),
                              half_f, p);
  float hs[3] = {0.0f, 0.0f, 0.0f};
  for (int k = tid; k < ww; k += kThreads) {
    const int i = k / win, j = k - i * win;
    const Taps ty = taps(tw.y0, tw.fy, i, p);
    const Taps tx = taps(tw.x0, tw.fx, j, p);
    const float ix = sample(gxp, p, ty, tx);
    const float iy = sample(gyp, p, ty, tx);
    tpl[k] = sample(ps, p, ty, tx);
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

  // Gauss-Newton on the cur patch, seeded at the incoming guess
  float gx = g0x, gy = g0y;
  if (is_valid && inv_ok) {
    for (int it = 0; it < iters; ++it) {
      const Window cw = window_at(__fsub_rn(gx, cax), __fsub_rn(gy, cay),
                                  half_f, p);
      float b[2] = {0.0f, 0.0f};
      for (int k = tid; k < ww; k += kThreads) {
        const int i = k / win, j = k - i * win;
        const float r = __fsub_rn(
            tpl[k], sample(cs, p, taps(cw.y0, cw.fy, i, p),
                           taps(cw.x0, cw.fx, j, p)));
        b[0] += r * wx[k];
        b[1] += r * wy[k];
      }
      block_sum<2>(b, red, parity);
      const float dx = __fadd_rn(__fmul_rn(i00, b[0]), __fmul_rn(i01, b[1]));
      const float dy = __fadd_rn(__fmul_rn(i01, b[0]), __fmul_rn(i11, b[1]));
      gx = __fadd_rn(gx, dx);
      gy = __fadd_rn(gy, dy);
      if (__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) < eps2) break;
    }
  }

  // mean absolute residual at the final position
  const Window fw = window_at(__fsub_rn(gx, cax), __fsub_rn(gy, cay), half_f,
                              p);
  float e[1] = {0.0f};
  for (int k = tid; k < ww; k += kThreads) {
    const int i = k / win, j = k - i * win;
    e[0] += fabsf(__fsub_rn(tpl[k], sample(cs, p, taps(fw.y0, fw.fy, i, p),
                                           taps(fw.x0, fw.fx, j, p))));
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
    const bool eig_ok = !gate_eig || min_eig > min_eigen;
    g_out[2 * n] = gx;
    g_out[2 * n + 1] = gy;
    ok_out[n] = (is_valid && in_bounds && inv_ok && within && eig_ok) ? 1 : 0;
    eig_out[n] = min_eig;
    err_out[n] = __fdiv_rn(e[0], static_cast<float>(ww));
  }
}

}  // namespace

extern "C" int lk_track_level(const void* prev, const void* cur, int h, int w,
                              const void* q, const void* g_in,
                              const void* valid, int n, int win, int iters,
                              float eps2, float min_eigen, int gate_eig,
                              void* g_out, void* ok_out, void* eig_out,
                              void* err_out, int device, void* stream) {
  if (n == 0) return 0;
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const int p = win + 2 * kMargin + 1;
  const size_t smem =
      (4 * p * p + 3 * win * win + 2 * kWarps * kRedSlots) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lk_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lk_level_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prev), static_cast<const float*>(cur), h, w,
      static_cast<const float*>(q), static_cast<const float*>(g_in),
      static_cast<const unsigned char*>(valid), win, iters, eps2, min_eigen,
      gate_eig, static_cast<float*>(g_out),
      static_cast<unsigned char*>(ok_out), static_cast<float*>(eig_out),
      static_cast<float*>(err_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
