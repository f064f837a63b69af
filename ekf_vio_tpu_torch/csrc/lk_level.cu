// lk_level: pyramidal Lucas-Kanade tracking of N features over up to
// kMaxLevels consecutive pyramid levels in one launch, on sm_90a.
//
// Replaces the two TPU kernels of ekf_vio_tpu/frontend/pallas_lk.py,
// _prep_kernel (patches, Scharr gradients, template and gradient windows,
// Hessian, corr tables) and _iter_kernel (the LK iterations on the corr
// tables, status, residual).  The corr tables, the bf16 one-hot extraction
// and the block tiers existed to fit the MXU and VMEM; here every iteration
// resamples the window directly from shared memory.  Semantics are those
// of ekf_vio_tpu/frontend/klt.py track over _track_level, whose plain
// PyTorch twin is ekf_vio_tpu_torch/frontend/klt.py track_pyramid_plain
// (a loop over track_level_plain):
//   * per level l, q = pts / 2^l, and the guess enters the coarsest level
//     as init / 2^hi and every finer one as twice the coarser result;
//     valid at level l is the status of level l + 1;
//   * p = win + 11 square patches anchored at floor(pos) - (half + 5),
//     clamped at the image border, values rounded to bf16 (round to
//     nearest even), as the reference's one-hot bf16 extraction rounds;
//   * Scharr gradients (smooth [3,10,3]/32 x derive [-1,0,1]),
//     edge-replicated at the patch border;
//   * bilinear windows whose two taps clamp to [0, p-1] inside the patch,
//     interpolating rows first, then columns;
//   * up to `iters` Gauss-Newton steps, stopping when step^2 < eps^2;
//   * status: in bounds (g and q inside [1, dim-2) of the level), H
//     invertible (det > 1e-12), within +-5 px of the level's incoming
//     guess, and at the finest level, when asked, min_eig > min_eigen;
//   * min_eig and the mean absolute residual of the finest level.
// Element-wise arithmetic uses the round-to-nearest intrinsics so the
// compiler fuses nothing into FMAs that the plain twin rounds twice; the
// window sums are block reductions whose order differs from PyTorch's.
//
// What bounds it on an H100: latency, not bytes or FLOPs.  A 4-level call
// for N = 128 moves ~1 MB and does ~20 MFLOP, a fraction of a microsecond
// at either roofline; what costs is the chain of dependent instructions
// per feature, at 8 warps a block, with the slowest feature holding the
// launch: the hoisted prologue, one cur patch gather per level, and per
// iteration the sampling and one block reduction.  chip_smoke.py times
// the call with and without iterations (PERF.md).
//
// Lanes: one launch tracks `lanes` independent sequences ([lanes, h, w]
// level images, [lanes, n] features; the counterpart of pallas_lk's
// custom_vmap rule, which folds vmapped lanes into one launch).  Block
// (x, y) is feature x of lane y and reads lane y's images; its arithmetic
// does not depend on y, so a lane of a many-lane launch is bitwise equal
// to a one-lane launch on that lane, and lanes = 1 is the one-lane launch.
//
// Design: one block per feature carries it through every level, coarse to
// fine, in one launch (a loop inside the block takes the place of the
// host's level loop, and its launches, wrapper calls and glue).
// Everything that depends only on pts is hoisted and done for all levels
// at once: the prev patches (one gather phase of cp.async copies, which
// also fetches the coarsest cur patch; the copies hold no registers, so
// all are in flight together), Scharr at just the patch pixels the
// template windows read, the windows and all Hessians (one block
// reduction).  Thread t owns window pixels t, t + kThreads, ... and keeps
// their template and gradient values in registers, so an iteration reads
// only the cur patch from shared memory.  Per level, only the cur patch
// gather waits on the coarser level's result.  The residual is summed at
// the finest level only, where it is reported.  Since each step is a
// chain of dependent instructions, the chain is kept short: the level
// scale is a multiply by an exact power of two (the plain twin divides,
// with the same result), NaN handling is a select rather than a branch,
// and an iteration samples a thread's slots past the window at weight 0
// rather than behind a branch, so their loads overlap.  kThreads = 256
// keeps the window sums in the order of the one-level kernel this
// replaced (warp partials added in warp order); 128 threads a feature
// measured slower (PERF.md).
//
// C interface: lk_track_pyramid(levels, nlev, ...) launches on `stream` of
// `device` and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

constexpr int kMaxLevels = 4;

// Level e of a call: its prev and cur images (lane 0's), their size,
// 2^-(lo + e), the factor from the caller's level-0 points to this level
// (multiplying by it is exact, and equals dividing by 2^(lo + e)), and the
// elements from one lane's image to the next (h * w for a [lanes, h, w]
// stack).  The same layout as csrc/klt_level.cu KltLevels and
// frontend/lk_cuda.py Levels; lk_levels_size() lets the wrapper check it.
// Outside the anonymous namespace: a C entry taking a type of internal
// linkage gets internal linkage itself.  The kernel indexes it only with
// compile-time indices, so it stays in the parameter bank.
struct LkLevels {
  const float* prev[kMaxLevels];
  const float* cur[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float inv_scale[kMaxLevels];
  long long lane_stride[kMaxLevels];
};

namespace {

constexpr int kMargin = 5;                   // klt._SEARCH_MARGIN
constexpr int kRedSlots = 3 * kMaxLevels;    // widest reduction: Hessians
constexpr int kThreads = 256;                // threads per feature
constexpr int kWarps = kThreads / 32;
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

// int of an already-floored value, for addressing only: NaN -> 0, then
// clamped to [-lim, lim] so the conversion cannot overflow (+-inf clamp
// as nan_to_num's +-FLT_MAX would).  Every index derived from it is
// clamped into the patch or image, where the clamp gives the same taps as
// the unclamped value would.
__device__ __forceinline__ int index_of(float floored, int lim) {
  const float v = isnan(floored) ? 0.0f : floored;
  return static_cast<int>(fminf(fmaxf(v, -static_cast<float>(lim)),
                                static_cast<float>(lim)));
}

// Patch anchor floor(pos) - (half + margin); NaN positions anchor at 0.
__device__ __forceinline__ float anchor_of(float v, float off) {
  return __fsub_rn(floorf(nan_to_num(v)), off);
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

// The largest window a kernel with `taps` window pixels a thread takes,
// and the patch pixels and Scharr taps per thread at that window.
__host__ __device__ constexpr int max_window(int taps) {
  int w = 1;
  while (w < 32 && (w + 1) * (w + 1) <= kThreads * taps) ++w;
  return w;
}
__host__ __device__ constexpr int patch_loads(int taps) {
  const int p = max_window(taps) + 2 * kMargin + 1;
  return (p * p + kThreads - 1) / kThreads;
}
__host__ __device__ constexpr int scharr_taps(int taps) {
  const int t = max_window(taps) + 1;
  return (t * t + kThreads - 1) / kThreads;
}

// A thread's share of a p x p patch: pixels tid + j * kThreads at rows
// pr[j] and columns pc[j]; pr[j] < 0 past the end of the patch.
template <int kLoads>
struct PatchShare {
  int pr[kLoads], pc[kLoads];
  __device__ __forceinline__ explicit PatchShare(int p) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int k = threadIdx.x + j * kThreads;
      pr[j] = k < p * p ? k / p : -1;
      pc[j] = k - pr[j] * p;
    }
  }
  // Start copying this thread's pixels of the patch of `img` (h x w) with
  // top-left (x0, y0), rows and columns clamped into the image, into the
  // shared patch `dst`: asynchronous copies, which hold no registers, so
  // every patch of a phase is in flight at once.
  __device__ __forceinline__ void fetch(float* dst,
                                        const float* __restrict__ img, int h,
                                        int w, int x0, int y0) const {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      if (pr[j] >= 0) {
        const float* src = img + clampi(y0 + pr[j], 0, h - 1) * w +
                           clampi(x0 + pc[j], 0, w - 1);
        const unsigned to = static_cast<unsigned>(
            __cvta_generic_to_shared(dst + threadIdx.x + j * kThreads));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     :: "r"(to), "l"(src) : "memory");
      }
    }
  }
  // After wait(): round this thread's pixels of the shared patch to bf16.
  __device__ __forceinline__ void round(float* dst) const {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      if (pr[j] >= 0) {
        float* v = dst + threadIdx.x + j * kThreads;
        *v = bf16_round(*v);
      }
    }
  }
  // Wait for this thread's copies; its own pixels are then visible to it.
  __device__ __forceinline__ static void wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
};

constexpr float kSmooth0 = 3.0f / 32.0f;
constexpr float kSmooth1 = 10.0f / 32.0f;

// Scharr gradients of the patch ps at (r, c), edge-replicated at its
// border: x = vertical smooth then horizontal derivative, y = the
// transpose.
__device__ __forceinline__ void scharr_at(const float* ps, int p, int r,
                                          int c, float* gx, float* gy) {
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
  gx[r * p + c] = __fsub_rn(vsmooth(cp), vsmooth(cm));
  gy[r * p + c] = __fadd_rn(__fadd_rn(__fmul_rn(vdiff(cm), kSmooth0),
                                      __fmul_rn(vdiff(c), kSmooth1)),
                            __fmul_rn(vdiff(cp), kSmooth0));
}

template <int kTaps>
__global__ void __launch_bounds__(kThreads)
    lk_pyramid_kernel(LkLevels lv, int nlev, int nfeat,
                      const float* __restrict__ pts,
                      const float* __restrict__ init,
                      const unsigned char* __restrict__ valid, int win,
                      int iters, float eps2, float min_eigen,
                      int gate_finest, float* __restrict__ g_out,
                      unsigned char* __restrict__ ok_out,
                      float* __restrict__ eig_out,
                      float* __restrict__ err_out) {
  extern __shared__ __align__(16) float smem[];
  const int lane = blockIdx.y;
  const int n = lane * nfeat + blockIdx.x;  // index into [lanes, nfeat]
  const int tid = threadIdx.x;
  const int half = (win - 1) / 2;
  const int p = win + 2 * kMargin + 1;
  const int pp = p * p;
  const int ww = win * win;
  const int top = nlev - 1;
  float* red = smem;  // 2 x kWarps x kRedSlots reduction scratch, aligned
  float* ps = red + 2 * kWarps * kRedSlots;  // [nlev][pp] prev patches
  float* gxs = ps + nlev * pp;   // [nlev][pp] their Scharr x (window taps)
  float* gys = gxs + nlev * pp;  // [nlev][pp] their Scharr y
  float* cs = gys + nlev * pp;   // [pp] cur patch of the level in hand

  const float off = static_cast<float>(half + kMargin);
  const float half_f = 0.5f * static_cast<float>(win - 1);
  const float px = pts[2 * n], py = pts[2 * n + 1];
  float gx = init[2 * n], gy = init[2 * n + 1];
  bool ok = valid[n] != 0;
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
  constexpr int kLoads = patch_loads(kTaps);
  const PatchShare<kLoads> share(p);
  float qx[kMaxLevels], qy[kMaxLevels];
  Window tw[kMaxLevels];
  float cax = 0.0f, cay = 0.0f;  // cur patch anchor of the level in hand
#pragma unroll
  for (int e = 0; e < kMaxLevels; ++e) {
    if (e < nlev) {
      qx[e] = __fmul_rn(px, lv.inv_scale[e]);
      qy[e] = __fmul_rn(py, lv.inv_scale[e]);
      const float pax = anchor_of(qx[e], off), pay = anchor_of(qy[e], off);
      tw[e] = window_at(__fsub_rn(qx[e], pax), __fsub_rn(qy[e], pay), half_f,
                        p);
      share.fetch(ps + e * pp, prev_img[e], lv.h[e], lv.w[e],
                  index_of(pax, p + lv.w[e]), index_of(pay, p + lv.h[e]));
    }
    if (e == top) {
      gx = __fmul_rn(gx, lv.inv_scale[e]);
      gy = __fmul_rn(gy, lv.inv_scale[e]);
      cax = anchor_of(gx, off);
      cay = anchor_of(gy, off);
      share.fetch(cs, cur_img[e], lv.h[e], lv.w[e],
                  index_of(cax, p + lv.w[e]), index_of(cay, p + lv.h[e]));
    }
  }
  share.wait();
#pragma unroll
  for (int e = 0; e < kMaxLevels; ++e) {
    if (e < nlev) share.round(ps + e * pp);
  }
  share.round(cs);
  __syncthreads();

  // 2. Scharr at the patch pixels the template window's taps read: rows
  // clamp(y0 + i), i = 0 .. win, the same for columns.  Thread t takes
  // (i, j) = divmod(t + m * kThreads, win + 1) at every level; where the
  // clamp maps two of them to one pixel, both write the same value.
  constexpr int kScharr = scharr_taps(kTaps);
  int si[kScharr], sj[kScharr];
#pragma unroll
  for (int m = 0; m < kScharr; ++m) {
    const int k = tid + m * kThreads;
    si[m] = k < (win + 1) * (win + 1) ? k / (win + 1) : -1;
    sj[m] = k - si[m] * (win + 1);
  }
#pragma unroll
  for (int e = 0; e < kMaxLevels; ++e) {
    if (e < nlev) {
#pragma unroll
      for (int m = 0; m < kScharr; ++m) {
        if (si[m] >= 0)
          scharr_at(ps + e * pp, p, clampi(tw[e].y0 + si[m], 0, p - 1),
                    clampi(tw[e].x0 + sj[m], 0, p - 1), gxs + e * pp,
                    gys + e * pp);
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
    for (int j = 0; j < kTaps; ++j) {
      tpl[e][j] = wx[e][j] = wy[e][j] = 0.0f;
      if (e < nlev && tid + j * kThreads < ww) {
        const Taps ty = taps(tw[e].y0, tw[e].fy, ti[j], p);
        const Taps tx = taps(tw[e].x0, tw[e].fx, tj[j], p);
        const float ix = sample(gxs + e * pp, p, ty, tx);
        const float iy = sample(gys + e * pp, p, ty, tx);
        tpl[e][j] = sample(ps + e * pp, p, ty, tx);
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

  // 4. coarse to fine: Gauss-Newton on each level's cur patch
  float err = 0.0f;
#pragma unroll
  for (int e = kMaxLevels - 1; e >= 0; --e) {
    if (e >= nlev) continue;
    const int h = lv.h[e], w = lv.w[e];
    if (e != top) {
      // every read of the coarser level's cur patch came before the last
      // barrier every thread has passed, so the patch is free to refill
      cax = anchor_of(gx, off);
      cay = anchor_of(gy, off);
      share.fetch(cs, cur_img[e], h, w, index_of(cax, p + w),
                  index_of(cay, p + h));
      share.wait();
      share.round(cs);
      __syncthreads();
    }
    const float g0x = gx, g0y = gy;
    if (ok && inv_ok[e]) {
      for (int it = 0; it < iters; ++it) {
        const Window cw = window_at(__fsub_rn(gx, cax), __fsub_rn(gy, cay),
                                    half_f, p);
        // no guard on the slots past the window: their gradient weights
        // are 0, so they add exact zeros, and the taps' loads overlap
        float b[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < kTaps; ++j) {
          const float r = __fsub_rn(
              tpl[e][j], sample(cs, p, taps(cw.y0, cw.fy, ti[j], p),
                                taps(cw.x0, cw.fx, tj[j], p)));
          b[0] += r * wx[e][j];
          b[1] += r * wy[e][j];
        }
        block_sum(b, red, parity);
        const float dx =
            __fadd_rn(__fmul_rn(i00[e], b[0]), __fmul_rn(i01[e], b[1]));
        const float dy =
            __fadd_rn(__fmul_rn(i01[e], b[0]), __fmul_rn(i11[e], b[1]));
        gx = __fadd_rn(gx, dx);
        gy = __fadd_rn(gy, dy);
        if (__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) < eps2) break;
      }
    }
    const float m = static_cast<float>(kMargin);
    const bool within = fabsf(__fsub_rn(gx, g0x)) <= m &&
                        fabsf(__fsub_rn(gy, g0y)) <= m;
    const float xmax = static_cast<float>(w - 2);
    const float ymax = static_cast<float>(h - 2);
    const bool in_bounds = gx >= 1.0f && gy >= 1.0f && gx < xmax &&
                           gy < ymax && qx[e] >= 1.0f && qy[e] >= 1.0f &&
                           qx[e] < xmax && qy[e] < ymax;
    const bool eig_ok = e != 0 || !gate_finest || min_eig[0] > min_eigen;
    ok = ok && in_bounds && inv_ok[e] && within && eig_ok;
    if (e > 0) {
      gx = __fmul_rn(gx, 2.0f);
      gy = __fmul_rn(gy, 2.0f);
    } else {
      // mean absolute residual at the final position of the finest level
      const Window fw = window_at(__fsub_rn(gx, cax), __fsub_rn(gy, cay),
                                  half_f, p);
      float s[1] = {0.0f};
#pragma unroll
      for (int j = 0; j < kTaps; ++j) {
        if (tid + j * kThreads < ww) {
          s[0] += fabsf(__fsub_rn(
              tpl[0][j], sample(cs, p, taps(fw.y0, fw.fy, ti[j], p),
                                taps(fw.x0, fw.fx, tj[j], p))));
        }
      }
      block_sum(s, red, parity);
      err = __fdiv_rn(s[0], static_cast<float>(ww));
    }
  }

  if (tid == 0) {
    g_out[2 * n] = gx;
    g_out[2 * n + 1] = gy;
    ok_out[n] = ok ? 1 : 0;
    eig_out[n] = min_eig[0];
    err_out[n] = err;
  }
}

template <int kTaps>
cudaError_t launch(const LkLevels& lv, int nlev, const float* pts,
                   const float* init, const unsigned char* valid, int n,
                   int lanes, int win, int iters, float eps2, float min_eigen,
                   int gate_finest, float* g_out, unsigned char* ok_out,
                   float* eig_out, float* err_out, cudaStream_t stream) {
  const int p = win + 2 * kMargin + 1;
  const size_t smem =
      ((3 * nlev + 1) * p * p + 2 * kWarps * kRedSlots) * sizeof(float);
  auto kernel = lk_pyramid_kernel<kTaps>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(n, lanes), kThreads, smem, stream>>>(
      lv, nlev, n, pts, init, valid, win, iters, eps2, min_eigen,
      gate_finest, g_out, ok_out, eig_out, err_out);
  return cudaGetLastError();
}

}  // namespace

// `levels` holds nlev (1..kMaxLevels) consecutive levels, finest first,
// each a stack of `lanes` images levels.lane_stride elements apart; pts
// and init are [lanes, n, 2] in the units that levels.inv_scale scales,
// valid and the outputs [lanes, n] (g_out [lanes, n, 2]).
// Window pixels per thread: ceil(win^2 / 256), at most 4, so win <= 32.
// Returns a CUDA error code, or cudaErrorInvalidValue for arguments
// outside that envelope.
extern "C" int lk_track_pyramid(LkLevels levels, int nlev, const void* pts,
                                const void* init, const void* valid, int n,
                                int lanes, int win, int iters, float eps2,
                                float min_eigen, int gate_finest, void* g_out,
                                void* ok_out, void* eig_out, void* err_out,
                                int device, void* stream) {
  if (nlev < 1 || nlev > kMaxLevels || win < 1 || win > 32 || lanes < 1 ||
      lanes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const int per_thread = (win * win + kThreads - 1) / kThreads;
  auto args = [&](auto launcher) {
    return launcher(levels, nlev, static_cast<const float*>(pts),
                    static_cast<const float*>(init),
                    static_cast<const unsigned char*>(valid), n, lanes, win,
                    iters, eps2, min_eigen, gate_finest,
                    static_cast<float*>(g_out),
                    static_cast<unsigned char*>(ok_out),
                    static_cast<float*>(eig_out),
                    static_cast<float*>(err_out),
                    static_cast<cudaStream_t>(stream));
  };
  const cudaError_t err = per_thread <= 1   ? args(launch<1>)
                          : per_thread <= 2 ? args(launch<2>)
                                            : args(launch<4>);
  return static_cast<int>(err);
}

extern "C" int lk_max_levels() { return kMaxLevels; }

extern "C" int lk_levels_size() { return static_cast<int>(sizeof(LkLevels)); }

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
