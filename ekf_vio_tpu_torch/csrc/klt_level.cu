// klt_level: whole-level Lucas-Kanade tracking of N features with a fixed
// iteration count, over up to kMaxLevels consecutive pyramid levels in
// one launch, on sm_90a.
//
// Replaces the TPU kernel ekf_vio_tpu/frontend/pallas_klt.py _kernel
// (launched through track_level_pallas, once per level), the tracker the
// JAX package runs on the levels of at least 40x40 px when the corr-table
// tracker does not apply (a window other than 21 px, level 0 of at least
// 64 Ki px).  Its one-hot bf16 matmul extraction and selector matmuls
// existed to keep the TPU's matrix unit busy; here the patches sit in
// shared memory and every iteration resamples the window directly.  Per
// level the semantics are those of the Pallas kernel, whose plain PyTorch
// twin is ekf_vio_tpu_torch/frontend/klt.py track_level_klt_plain; across
// levels they are those of klt.track's level loop (twin:
// track_pyramid_klt_plain):
//   * per level l, q = pts / 2^l; the guess enters the coarsest level as
//     init / 2^hi and every finer one as twice the coarser result; valid
//     at level l is valid & ok of every coarser level;
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
//   * err: the mean absolute residual at the final g of the finest level
//     (the Pallas kernel's mean of row means, equal in exact arithmetic);
//   * a level's ok = in bounds (g and q inside [1, dim-2)) & det > 1e-12
//     & within +-5 px of the incoming guess & min_eig > min_eigen, NOT
//     including valid; min_eigen is -1 above level 0; NaN comparisons are
//     false.  The one-level call returns that ok (the caller ANDs valid);
//     the pyramid call returns valid & ok of every level.
// Element-wise arithmetic uses the round-to-nearest intrinsics so the
// compiler fuses nothing into FMAs that the twin rounds twice; the window
// sums are block reductions whose order differs from PyTorch's.
//
// What bounds it on an H100: latency, not bytes or FLOPs.  A 3-level call
// for N = 128 moves ~2 MB of patches and does well under 0.1 GFLOP, a
// fraction of a microsecond at either roofline; what costs is the chain
// of dependent operations per feature at 8 warps a block, with the
// slowest feature holding the launch: the hoisted prologue, one cur patch
// gather per level, and per iteration the sampling and one block
// reduction.  chip_smoke.py times the call with and without iterations
// (PERF.md).
//
// Lanes: one launch tracks `lanes` independent sequences ([lanes, h, w]
// level images, [lanes, n] features; the counterpart of a vmap over
// track_level_pallas, which batches the Pallas grid).  Block (x, y) is
// feature x of lane y and reads lane y's images; its arithmetic does not
// depend on y, so a lane of a many-lane launch is bitwise equal to a
// one-lane launch on that lane, and lanes = 1 is the one-lane launch.
//
// Design: one 256-thread block per feature carries it through every
// level, coarse to fine, in one launch (a loop inside the block takes the
// place of the host's level loop, its launches, wrapper calls and glue).
// Everything that depends only on pts is hoisted and done for all levels
// at once: the prev patches (one gather phase of cp.async copies, which
// also fetches the coarsest cur patch), Scharr at just the (win + 1)^2
// patch pixels the template window's taps read (kept as small tap arrays,
// not as gradient patches), the windows and all Hessians (one block
// reduction).  Thread t owns window pixels t, t + 256, ... and keeps
// their template and gradient values in registers, so an iteration reads
// only the cur patch from shared memory.  Per level, only the cur patch
// gather waits on the coarser level's result: its origin is
// floor(2 g) - 17.  The window size is a template parameter for the
// windows the configurations use (17 and 21), so pixel -> (row, column)
// is a division by a constant and the per-thread loops unroll; other
// windows of 1..40 px run a generic instantiation.  The tap weights of an
// iteration are computed once per thread, the clamped tap indices once
// per owned row and column.  A thread's slots past the window sample
// pixel (0, 0) at zero gradient weight rather than behind a branch, so
// their loads overlap.
//
// C interface: klt_track_pyramid(levels, nlev, ...) launches on `stream`
// of `device` and returns cudaGetLastError().  Each launch counts itself
// on the card (launch_count.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "launch_count.cuh"

constexpr int kMaxLevels = 4;

// Level e of a call: its prev and cur images (lane 0's), their size,
// 2^-(lo + e), the factor from the caller's points to this level
// (multiplying by it is exact, and equals dividing by 2^(lo + e)), and the
// elements from one lane's image to the next (h * w for a [lanes, h, w]
// stack).  The same layout as csrc/lk_level.cu LkLevels and
// frontend/lk_cuda.py Levels; klt_levels_size() lets the wrapper check it.
// Outside the anonymous namespace: a C entry taking a type of internal
// linkage gets internal linkage itself.  The kernel indexes it only with
// compile-time indices, so it stays in the parameter bank.
struct KltLevels {
  const float* prev[kMaxLevels];
  const float* cur[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float inv_scale[kMaxLevels];
  long long lane_stride[kMaxLevels];
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPatch = 40;   // pallas_klt.PATCH
constexpr int kPP = kPatch * kPatch;
constexpr int kPad = 17;     // pallas_klt._PAD
constexpr int kMargin = 5;   // pallas_klt._MARGIN
constexpr int kRedSlots = 3 * kMaxLevels;  // widest reduction: Hessians
constexpr int kLoads = (kPP + kThreads - 1) / kThreads;  // patch px a thread
static_assert(kWarps % 4 == 0, "block_sum reads the partials 4 at a time");

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// torch.nan_to_num: NaN -> 0, +-inf -> +-FLT_MAX.
__device__ __forceinline__ float nan_to_num(float v) {
  return isnan(v) ? 0.0f : fminf(fmaxf(v, -FLT_MAX), FLT_MAX);
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

// The weights of a window's two taps along one axis
// (pallas_klt._selector): 1 - f and f, or both on one tap where the
// clamped pair coincides.
struct Weights {
  float wa, wb, both;
};

__device__ __forceinline__ Weights weights_of(float f) {
  Weights w;
  w.wa = __fsub_rn(1.0f, f);
  w.wb = f;
  w.both = __fadd_rn(w.wa, w.wb);
  return w;
}

// The two taps of window row/column i: indices clamped into the patch.
struct Taps {
  int a, b;
  float wa, wb;
};

__device__ __forceinline__ Taps taps(int i0, int i, const Weights& w) {
  Taps t;
  t.a = clampi(i0 + i, 0, kPatch - 1);
  t.b = clampi(i0 + i + 1, 0, kPatch - 1);
  t.wa = t.a == t.b ? w.both : w.wa;
  t.wb = t.a == t.b ? 0.0f : w.wb;
  return t;
}

// Bilinear blend of the four taps at rows ra, rb and columns ca, cb of the
// array S of row stride `stride`: rows first, then columns.
__device__ __forceinline__ float blend(const float* S, int stride, int ra,
                                       int rb, int ca, int cb, const Taps& ty,
                                       const Taps& tx) {
  const float ta = __fadd_rn(__fmul_rn(ty.wa, S[ra * stride + ca]),
                             __fmul_rn(ty.wb, S[rb * stride + ca]));
  const float tb = __fadd_rn(__fmul_rn(ty.wa, S[ra * stride + cb]),
                             __fmul_rn(ty.wb, S[rb * stride + cb]));
  return __fadd_rn(__fmul_rn(tx.wa, ta), __fmul_rn(tx.wb, tb));
}

// Bilinear sample of a 40 x 40 patch.
__device__ __forceinline__ float sample(const float* S, const Taps& ty,
                                        const Taps& tx) {
  return blend(S, kPatch, ty.a, ty.b, tx.a, tx.b, ty, tx);
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
    for (int k = 0; k < K; ++k) buf[k * kWarps + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; w += 4) {  // in warp order, 4 at a time
      const float4 q = *reinterpret_cast<const float4*>(buf + k * kWarps + w);
      s += q.x;
      s += q.y;
      s += q.z;
      s += q.w;
    }
    v[k] = s;
  }
  parity ^= 1;
}

// Start copying this thread's pixels of the 40 x 40 patch of `img` (row
// stride w) with top-left (x0, y0), which lies inside the image, into the
// shared patch `dst`: asynchronous copies, which hold no registers, so
// every patch of a phase is in flight at once.
__device__ __forceinline__ void fetch(float* dst,
                                      const float* __restrict__ img, int w,
                                      int x0, int y0) {
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int k = threadIdx.x + j * kThreads;
    if (k < kPP) {
      const int r = k / kPatch, c = k - r * kPatch;
      const float* src = img + (y0 + r) * w + x0 + c;
      const unsigned to =
          static_cast<unsigned>(__cvta_generic_to_shared(dst + k));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(to), "l"(src) : "memory");
    }
  }
}

// Wait for this thread's copies; its own pixels are then visible to it.
__device__ __forceinline__ void fetch_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// After fetch_wait(): round this thread's pixels of the patch to bf16.
__device__ __forceinline__ void round_patch(float* dst) {
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int k = threadIdx.x + j * kThreads;
    if (k < kPP) dst[k] = bf16_round(dst[k]);
  }
}

constexpr float kSmooth0 = 3.0f / 32.0f;
constexpr float kSmooth1 = 10.0f / 32.0f;

// Scharr gradients of the patch ps at (r, c), edge-replicated at its
// border.
__device__ __forceinline__ void scharr_at(const float* ps, int r, int c,
                                          float* gx, float* gy) {
  const int rm = max(r - 1, 0), rp = min(r + 1, kPatch - 1);
  const int cm = max(c - 1, 0), cp = min(c + 1, kPatch - 1);
  auto vsmooth = [&](int col) {
    return __fadd_rn(__fadd_rn(__fmul_rn(ps[rm * kPatch + col], kSmooth0),
                               __fmul_rn(ps[r * kPatch + col], kSmooth1)),
                     __fmul_rn(ps[rp * kPatch + col], kSmooth0));
  };
  auto hsmooth = [&](int row) {
    return __fadd_rn(__fadd_rn(__fmul_rn(ps[row * kPatch + cm], kSmooth0),
                               __fmul_rn(ps[row * kPatch + c], kSmooth1)),
                     __fmul_rn(ps[row * kPatch + cp], kSmooth0));
  };
  *gx = __fsub_rn(vsmooth(cp), vsmooth(cm));
  *gy = __fsub_rn(hsmooth(rp), hsmooth(rm));
}

// kWin: the window size when it is known at compile time, else 0 (then
// `win_rt` is read); kTaps: window pixels per thread, at least
// ceil(win^2 / kThreads).
template <int kWin, int kTaps>
__global__ void __launch_bounds__(kThreads)
    klt_pyramid_kernel(KltLevels lv, int nlev, int nfeat,
                       const float* __restrict__ pts,
                       const float* __restrict__ init,
                       const unsigned char* __restrict__ valid, int win_rt,
                       int iters, float eps2, float min_eigen,
                       int gate_finest, int include_valid,
                       float* __restrict__ g_out,
                       unsigned char* __restrict__ ok_out,
                       float* __restrict__ eig_out,
                       float* __restrict__ err_out) {
  extern __shared__ __align__(16) float smem[];
  count_launch();
  const int lane = blockIdx.y;
  const int n = lane * nfeat + blockIdx.x;  // index into [lanes, nfeat]
  const int tid = threadIdx.x;
  const int win = kWin ? kWin : win_rt;
  const int ww = win * win;
  const int tw1 = win + 1;      // taps along one axis of the window
  const int tt = tw1 * tw1;     // patch pixels under the template window
  const int top = nlev - 1;
  float* red = smem;  // 2 x kWarps x kRedSlots reduction scratch, aligned
  float* ps = red + 2 * kWarps * kRedSlots;  // [nlev][kPP] prev patches
  float* cs = ps + nlev * kPP;   // [kPP] cur patch of the level in hand
  float* gxt = cs + kPP;         // [nlev][tt] Scharr x at the window taps
  float* gyt = gxt + nlev * tt;  // [nlev][tt] Scharr y at the window taps

  const float half_f = 0.5f * static_cast<float>(win - 1);
  const float px = pts[2 * n], py = pts[2 * n + 1];
  float gx = init[2 * n], gy = init[2 * n + 1];
  bool alive = valid[n] != 0;  // valid & ok of every coarser level
  const float* prev_img[kMaxLevels];  // this lane's level images
  const float* cur_img[kMaxLevels];
#pragma unroll
  for (int e = 0; e < kMaxLevels; ++e) {
    prev_img[e] = lv.prev[e] + lane * lv.lane_stride[e];
    cur_img[e] = lv.cur[e] + lane * lv.lane_stride[e];
  }

  // the window pixels this thread owns: row ti, column tj; a thread's
  // slots past the window point at pixel (0, 0), which the iterations
  // sample with zero gradient weights
  int ti[kTaps], tj[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    const int k = tid + j * kThreads;
    ti[j] = k < ww ? k / win : 0;
    tj[j] = k < ww ? k - ti[j] * win : 0;
  }

  // 1. gather the prev patch of every level and the coarsest cur patch,
  // every copy in flight at once
  float qx[kMaxLevels], qy[kMaxLevels];
  Window tw[kMaxLevels];
  float cox = 0.0f, coy = 0.0f;  // cur patch origin of the level in hand
#pragma unroll
  for (int e = 0; e < kMaxLevels; ++e) {
    if (e < nlev) {
      qx[e] = __fmul_rn(px, lv.inv_scale[e]);
      qy[e] = __fmul_rn(py, lv.inv_scale[e]);
      const float pox = origin(qx[e], lv.w[e] - kPatch);
      const float poy = origin(qy[e], lv.h[e] - kPatch);
      tw[e] = window_at(__fsub_rn(qx[e], pox), __fsub_rn(qy[e], poy), half_f);
      fetch(ps + e * kPP, prev_img[e], lv.w[e], static_cast<int>(pox),
            static_cast<int>(poy));
    }
    if (e == top) {
      gx = __fmul_rn(gx, lv.inv_scale[e]);
      gy = __fmul_rn(gy, lv.inv_scale[e]);
      cox = origin(gx, lv.w[e] - kPatch);
      coy = origin(gy, lv.h[e] - kPatch);
      fetch(cs, cur_img[e], lv.w[e], static_cast<int>(cox),
            static_cast<int>(coy));
    }
  }
  fetch_wait();
#pragma unroll
  for (int e = 0; e < kMaxLevels; ++e) {
    if (e < nlev) round_patch(ps + e * kPP);
  }
  round_patch(cs);
  __syncthreads();

  // 2. Scharr at the patch pixels the template window's taps read: rows
  // clamp(y0 + i), i = 0 .. win, the same for columns, stored at (i, j)
  constexpr int kScharr = kWin ? ((kWin + 1) * (kWin + 1) + kThreads - 1) /
                                     kThreads
                               : 0;
#pragma unroll
  for (int e = 0; e < kMaxLevels; ++e) {
    if (e < nlev) {
      if constexpr (kWin != 0) {
#pragma unroll
        for (int m = 0; m < kScharr; ++m) {
          const int k = tid + m * kThreads;
          if (k < tt) {
            const int i = k / tw1, j = k - i * tw1;
            scharr_at(ps + e * kPP, clampi(tw[e].y0 + i, 0, kPatch - 1),
                      clampi(tw[e].x0 + j, 0, kPatch - 1), gxt + e * tt + k,
                      gyt + e * tt + k);
          }
        }
      } else {
        for (int k = tid; k < tt; k += kThreads) {
          const int i = k / tw1, j = k - i * tw1;
          scharr_at(ps + e * kPP, clampi(tw[e].y0 + i, 0, kPatch - 1),
                    clampi(tw[e].x0 + j, 0, kPatch - 1), gxt + e * tt + k,
                    gyt + e * tt + k);
        }
      }
    }
  }
  __syncthreads();

  // 3. template and gradient windows into registers, and every Hessian
  float tpl[kMaxLevels][kTaps], wx[kMaxLevels][kTaps], wy[kMaxLevels][kTaps];
  float hs[kRedSlots];
#pragma unroll
  for (int e = 0; e < kMaxLevels; ++e) {
    hs[3 * e] = hs[3 * e + 1] = hs[3 * e + 2] = 0.0f;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) tpl[e][j] = wx[e][j] = wy[e][j] = 0.0f;
    if (e >= nlev) continue;
    const Weights wgy = weights_of(tw[e].fy), wgx = weights_of(tw[e].fx);
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      if (tid + j * kThreads < ww) {
        const Taps ty = taps(tw[e].y0, ti[j], wgy);
        const Taps tx = taps(tw[e].x0, tj[j], wgx);
        const float ix = blend(gxt + e * tt, tw1, ti[j], ti[j] + 1, tj[j],
                               tj[j] + 1, ty, tx);
        const float iy = blend(gyt + e * tt, tw1, ti[j], ti[j] + 1, tj[j],
                               tj[j] + 1, ty, tx);
        tpl[e][j] = sample(ps + e * kPP, ty, tx);
        wx[e][j] = ix;
        wy[e][j] = iy;
        hs[3 * e] += ix * ix;
        hs[3 * e + 1] += ix * iy;
        hs[3 * e + 2] += iy * iy;
      }
    }
  }
  int parity = 0;
  block_sum(hs, red, parity);
  float min_eig[kMaxLevels], i00[kMaxLevels], i01[kMaxLevels],
      i11[kMaxLevels];
  bool inv_ok[kMaxLevels];
#pragma unroll
  for (int e = 0; e < kMaxLevels; ++e) {
    const float gxx = hs[3 * e], gxy = hs[3 * e + 1], gyy = hs[3 * e + 2];
    const float tr = __fadd_rn(gxx, gyy);
    const float dd = __fsub_rn(gxx, gyy);
    const float det_half = sqrtf(fmaxf(
        __fadd_rn(__fmul_rn(__fmul_rn(dd, dd), 0.25f), __fmul_rn(gxy, gxy)),
        0.0f));
    min_eig[e] = __fdiv_rn(__fsub_rn(__fmul_rn(tr, 0.5f), det_half),
                           static_cast<float>(ww));
    const float det = __fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy));
    inv_ok[e] = det > 1e-12f;
    const float det_safe = inv_ok[e] ? det : 1.0f;
    i00[e] = __fdiv_rn(gyy, det_safe);
    i01[e] = __fdiv_rn(-gxy, det_safe);
    i11[e] = __fdiv_rn(gxx, det_safe);
  }

  // 4. coarse to fine: fixed-count Gauss-Newton on each level's cur patch
  float err = 0.0f;
  bool ok_level = false;  // ok of the level in hand, without valid
#pragma unroll
  for (int e = kMaxLevels - 1; e >= 0; --e) {
    if (e >= nlev) continue;
    const int h = lv.h[e], w = lv.w[e];
    if (e != top) {
      // every read of the coarser level's cur patch came before the last
      // barrier every thread has passed, so the patch is free to refill
      cox = origin(gx, w - kPatch);
      coy = origin(gy, h - kPatch);
      fetch(cs, cur_img[e], w, static_cast<int>(cox), static_cast<int>(coy));
      fetch_wait();
      round_patch(cs);
      __syncthreads();
    }
    const float g0x = gx, g0y = gy;
    float live = (alive && inv_ok[e]) ? 1.0f : 0.0f;
    for (int it = 0; it < iters; ++it) {
      const Window cw = window_at(__fsub_rn(gx, cox), __fsub_rn(gy, coy),
                                  half_f);
      const Weights wgy = weights_of(cw.fy), wgx = weights_of(cw.fx);
      // no guard on the slots past the window: their gradient weights are
      // 0, so they add exact zeros (or NaN where every pixel does)
      float b[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < kTaps; ++j) {
        const float r = __fsub_rn(
            tpl[e][j],
            sample(cs, taps(cw.y0, ti[j], wgy), taps(cw.x0, tj[j], wgx)));
        b[0] += r * wx[e][j];
        b[1] += r * wy[e][j];
      }
      block_sum(b, red, parity);
      const float dx =
          __fadd_rn(__fmul_rn(i00[e], b[0]), __fmul_rn(i01[e], b[1]));
      const float dy =
          __fadd_rn(__fmul_rn(i01[e], b[0]), __fmul_rn(i11[e], b[1]));
      gx = __fadd_rn(gx, __fmul_rn(dx, live));
      gy = __fadd_rn(gy, __fmul_rn(dy, live));
      if (live == 0.0f) break;  // frozen: later iterations repeat this one
      if (__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) < eps2) live = 0.0f;
    }
    const float m = static_cast<float>(kMargin);
    const bool within = fabsf(__fsub_rn(gx, g0x)) <= m &&
                        fabsf(__fsub_rn(gy, g0y)) <= m;
    const float xmax = static_cast<float>(w - 2);
    const float ymax = static_cast<float>(h - 2);
    const bool in_bounds = gx >= 1.0f && gy >= 1.0f && gx < xmax &&
                           gy < ymax && qx[e] >= 1.0f && qy[e] >= 1.0f &&
                           qx[e] < xmax && qy[e] < ymax;
    const float gate = (e == 0 && gate_finest) ? min_eigen : -1.0f;
    ok_level = in_bounds && inv_ok[e] && within && min_eig[e] > gate;
    alive = alive && ok_level;
    if (e > 0) {
      gx = __fmul_rn(gx, 2.0f);
      gy = __fmul_rn(gy, 2.0f);
    } else {
      // mean absolute residual at the final position of the finest level
      const Window fw = window_at(__fsub_rn(gx, cox), __fsub_rn(gy, coy),
                                  half_f);
      const Weights wgy = weights_of(fw.fy), wgx = weights_of(fw.fx);
      float s[1] = {0.0f};
#pragma unroll
      for (int j = 0; j < kTaps; ++j) {
        if (tid + j * kThreads < ww) {
          s[0] += fabsf(__fsub_rn(
              tpl[0][j],
              sample(cs, taps(fw.y0, ti[j], wgy), taps(fw.x0, tj[j], wgx))));
        }
      }
      block_sum(s, red, parity);
      err = __fdiv_rn(__fdiv_rn(s[0], static_cast<float>(win)),
                      static_cast<float>(win));
    }
  }

  if (tid == 0) {
    g_out[2 * n] = gx;
    g_out[2 * n + 1] = gy;
    ok_out[n] = (include_valid ? alive : ok_level) ? 1 : 0;
    eig_out[n] = min_eig[0];
    err_out[n] = err;
  }
}

template <int kWin, int kTaps>
cudaError_t launch(const KltLevels& lv, int nlev, const float* pts,
                   const float* init, const unsigned char* valid, int n,
                   int lanes, int win, int iters, float eps2, float min_eigen,
                   int gate_finest, int include_valid, float* g_out,
                   unsigned char* ok_out, float* eig_out, float* err_out,
                   cudaStream_t stream) {
  const size_t smem = (2 * kWarps * kRedSlots + (nlev + 1) * kPP +
                       2 * nlev * (win + 1) * (win + 1)) * sizeof(float);
  auto kernel = klt_pyramid_kernel<kWin, kTaps>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(n, lanes), kThreads, smem, stream>>>(
      lv, nlev, n, pts, init, valid, win, iters, eps2, min_eigen, gate_finest,
      include_valid, g_out, ok_out, eig_out, err_out);
  return cudaGetLastError();
}

}  // namespace

// `levels` holds nlev (1..kMaxLevels) consecutive levels, finest first,
// each at least 40 x 40 and a stack of `lanes` images
// levels.lane_stride elements apart; pts and init are [lanes, n, 2] in the
// units that levels.inv_scale scales, valid and the outputs [lanes, n]
// (g_out [lanes, n, 2]).  The eigen gate applies at the finest level
// when gate_finest is set, with min_eigen = -1 elsewhere.  ok_out is
// valid & ok of every level when include_valid is set, else the finest
// level's ok alone.  Returns a CUDA error code, or cudaErrorInvalidValue
// for arguments outside that envelope.
extern "C" int klt_track_pyramid(KltLevels levels, int nlev, const void* pts,
                                 const void* init, const void* valid, int n,
                                 int lanes, int win, int iters, float eps2,
                                 float min_eigen, int gate_finest,
                                 int include_valid, void* g_out, void* ok_out,
                                 void* eig_out, void* err_out, int device,
                                 void* stream) {
  if (nlev < 1 || nlev > kMaxLevels || win < 1 || win > kPatch ||
      lanes < 1 || lanes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int e = 0; e < nlev; ++e) {
    if (levels.h[e] < kPatch || levels.w[e] < kPatch)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  auto args = [&](auto launcher) {
    return launcher(levels, nlev, static_cast<const float*>(pts),
                    static_cast<const float*>(init),
                    static_cast<const unsigned char*>(valid), n, lanes, win,
                    iters, eps2, min_eigen, gate_finest, include_valid,
                    static_cast<float*>(g_out),
                    static_cast<unsigned char*>(ok_out),
                    static_cast<float*>(eig_out),
                    static_cast<float*>(err_out),
                    static_cast<cudaStream_t>(stream));
  };
  // 2 window pixels a thread up to 22 px, 7 up to 40 px
  const cudaError_t err = win == 17   ? args(launch<17, 2>)
                          : win == 21 ? args(launch<21, 2>)
                          : win <= 22 ? args(launch<0, 2>)
                                      : args(launch<0, 7>);
  return static_cast<int>(err);
}

extern "C" int klt_max_levels() { return kMaxLevels; }

extern "C" int klt_levels_size() {
  return static_cast<int>(sizeof(KltLevels));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
