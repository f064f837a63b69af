// fast9: FAST-9/16 corner score, 3x3 non-max suppression and the 3-px
// border margin for one float32 image, in one launch, on sm_90a.
//
// Replaces the TPU kernel ekf_vio_tpu/frontend/pallas_fast.py
// _fast_tile_kernel (launched through detect_pallas), which also computed
// score, margin and NMS in one kernel over row tiles with a halo.  The
// ring reads an edge-replicated image and NMS treats outside-the-image as
// -inf.  The margin follows the JAX package's dispatch: with mask_first
// (frames of at least 128x256 px, where pallas_fast.detect runs the
// Pallas kernel) the score is zeroed in the margin BEFORE NMS, as that
// kernel does; otherwise the margin is applied after NMS, as the jnp
// detector ekf_vio_tpu/frontend/fast.py detect does.  The two differ next
// to row and column 3.  Plain twin: ekf_vio_tpu_torch/frontend/fast.py
// detect.
//
// What bounds it on an H100: latency.  At 160x120 and 320x240 (19,200 and
// 76,800 pixels, at most 0.6 MB in and out, ~110 FLOPs a pixel) both
// rooflines are a fraction of a microsecond, below a launch's fixed cost
// and one block's chain of a global load, the score, a barrier and the
// NMS.  The kernel this replaced spent two launches and a full-frame score
// scratch on it.
//
// Lanes: a [lanes, h, w] stack of frames is one launch, grid.z = lanes
// (the counterpart of a vmap over detect_pallas); block (x, y, z) reads
// and writes frame z only, with the arithmetic of a one-frame launch, so
// each lane is bitwise equal to a one-frame launch on it.
//
// Design: one launch and no device-memory scratch.  A block owns a
// kTileW x kRows output tile and has one thread per position of its score
// tile (the output tile and a 1-px ring), so the chain is one round of
// each step: every thread issues its loads of the tile and its 4-px halo
// (3 for the ring, 1 for NMS; rows and columns clamped at the image edge,
// as the ring's edge replication reads them) before storing any into
// shared memory; syncs; scores its position (-inf outside the image);
// syncs; and the kTileW x kRows output threads suppress from shared
// memory.  A pixel with fewer than 9 bright or 9 dark ring pixels scores 0
// at once.  For the others every arc is summed, each as a left fold of its
// 9 excesses in ring order, as the twin sums them, and the qualifying ones
// are selected: summing only the qualifying arcs behind a branch per arc
// measured slower (PERF.md).
//
// C interface: fast9_detect(img, lanes, h, w, threshold, mask_first, out,
// device, stream) launches on `stream` of `device` and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Bresenham circle of radius 3, clockwise from 12 o'clock (fast.py _CIRCLE).
__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                0, -1, -2, -3, -3, -3, -2, -1};
constexpr int kArcLen = 9;
constexpr int kMargin = 3;
constexpr int kHalo = 4;                   // ring radius + the NMS neighbour
constexpr int kTileW = 32;                 // output columns per block
constexpr int kRows = 8;  // output rows per block (16: slower, PERF.md)
constexpr int kInW = kTileW + 2 * kHalo;   // input tile
constexpr int kInH = kRows + 2 * kHalo;
constexpr int kScoreW = kTileW + 2;        // score tile: the output + 1 px
constexpr int kScoreH = kRows + 2;
constexpr int kThreads = kScoreW * kScoreH;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ bool inside_margin(int y, int x, int h, int w) {
  return y >= kMargin && y < h - kMargin && x >= kMargin && x < w - kMargin;
}

// FAST-9 score of the pixel at (r, c) of the shared input tile `in`: 0 for
// non-corners, else the max over qualifying 9-arcs of the sum of
// |ring - centre| - t.
__device__ __forceinline__ float score_at(const float* in, int r, int c,
                                          float thr) {
  const float centre = in[r * kInW + c];
  float e[16];
  unsigned bright = 0, dark = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float d = in[(r + kRingDy[k]) * kInW + c + kRingDx[k]] - centre;
    bright |= (d > thr ? 1u : 0u) << k;
    dark |= (d < -thr ? 1u : 0u) << k;
    e[k] = fabsf(d) - thr;
  }
  if (__popc(bright) < kArcLen && __popc(dark) < kArcLen) return 0.0f;
  const unsigned ring2b = bright | (bright << 16);  // wraparound arcs
  const unsigned ring2d = dark | (dark << 16);
  const unsigned arc = (1u << kArcLen) - 1u;
  float best = 0.0f;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const bool ok =
        ((ring2b >> s) & arc) == arc || ((ring2d >> s) & arc) == arc;
    float sad = 0.0f;
#pragma unroll
    for (int k = 0; k < kArcLen; ++k) sad += e[(s + k) & 15];
    best = fmaxf(best, ok ? sad : 0.0f);
  }
  return best;
}

// One block: a kTileW x kRows output tile, one thread per position of its
// score tile (the output tile and a 1-px ring).
__global__ void __launch_bounds__(kThreads)
    fast9_kernel(const float* __restrict__ img, int h, int w, float thr,
                 int mask_first, float* __restrict__ out) {
  constexpr int kLoads = (kInW * kInH + kThreads - 1) / kThreads;
  __shared__ float in[kInH * kInW];        // input with the halo
  __shared__ float sc[kScoreH * kScoreW];  // scores with a 1-px ring
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kRows;
  img += static_cast<long long>(blockIdx.z) * h * w;  // this lane's frame
  out += static_cast<long long>(blockIdx.z) * h * w;

  // every load in flight before the first store
  float v[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int k = tid + j * kThreads;
    if (k < kInH * kInW) {
      const int r = k / kInW, c = k - r * kInW;
      v[j] = __ldg(img + clampi(y0 - kHalo + r, 0, h - 1) * w +
                   clampi(x0 - kHalo + c, 0, w - 1));
    }
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int k = tid + j * kThreads;
    if (k < kInH * kInW) in[k] = v[j];
  }
  __syncthreads();

  // score tile position (r, c) is image (y0 - 1 + r, x0 - 1 + c) and
  // input tile position (r + 3, c + 3)
  {
    const int r = tid / kScoreW, c = tid - r * kScoreW;
    const int y = y0 - 1 + r, x = x0 - 1 + c;
    float s;
    if (y < 0 || y >= h || x < 0 || x >= w)
      s = -INFINITY;
    else if (mask_first && !inside_margin(y, x, h, w))
      s = 0.0f;
    else
      s = score_at(in, r + kHalo - 1, c + kHalo - 1, thr);
    sc[tid] = s;
  }
  __syncthreads();

  if (tid >= kRows * kTileW) return;
  const int r = tid / kTileW, c = tid - r * kTileW;
  const int x = x0 + c, y = y0 + r;
  if (x >= w || y >= h) return;
  const float* centre = sc + (r + 1) * kScoreW + c + 1;
  const float s = *centre;
  float pooled = -INFINITY;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx)
      pooled = fmaxf(pooled, centre[dy * kScoreW + dx]);
  }
  const bool keep = (s >= pooled) && (s > 0.0f);
  out[y * w + x] = (keep && inside_margin(y, x, h, w)) ? s : 0.0f;
}

}  // namespace

// img and out: [lanes, h, w] float32, each frame scored on its own.
extern "C" int fast9_detect(const void* img, int lanes, int h, int w,
                            float threshold, int mask_first, void* out,
                            int device, void* stream) {
  if (lanes < 1 || lanes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (h == 0 || w == 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kRows - 1) / kRows, lanes);
  fast9_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), h, w, threshold, mask_first,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
