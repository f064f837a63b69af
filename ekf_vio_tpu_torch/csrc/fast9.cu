// fast9: FAST-9/16 corner score, 3x3 non-max suppression and the 3-px
// border margin for one float32 image, on sm_90a.
//
// Replaces the TPU kernel ekf_vio_tpu/frontend/pallas_fast.py
// _fast_tile_kernel (launched through detect_pallas).  The ring reads an
// edge-replicated image and NMS treats outside-the-image as -inf.  The
// margin follows the JAX package's dispatch: with mask_first (frames of
// at least 128x256 px, where pallas_fast.detect runs the Pallas kernel)
// the score is zeroed in the margin BEFORE NMS, as that kernel does;
// otherwise the margin is applied after NMS, as the jnp detector
// ekf_vio_tpu/frontend/fast.py detect does.  The two differ next to row
// and column 3.  Plain twin: ekf_vio_tpu_torch/frontend/fast.py detect.
//
// What bounds it on an H100: latency.  At 160x120 and 320x240 (19,200 and
// 76,800 pixels, at most 0.6 MB in and out, ~200 FLOPs a pixel) both
// rooflines are a fraction of a microsecond, below the two launches'
// fixed cost.  At 640x480 it is a stencil that reads each pixel ~17 times
// from L1/L2 and writes once, far below the memory roofline.  The design
// is one thread per pixel with the 16 ring reads served by the caches; a
// tiled shared-memory version is later work if a larger frame makes it
// matter.
//
// C interface: fast9_detect(img, h, w, threshold, mask_first,
// score_scratch, out, device, stream) launches both kernels on `stream` of
// `device` and returns cudaGetLastError().

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

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ bool inside_margin(int y, int x, int h, int w) {
  return y >= kMargin && y < h - kMargin && x >= kMargin && x < w - kMargin;
}

__global__ void fast9_score_kernel(const float* __restrict__ img, int h, int w,
                                   float thr, int mask_first,
                                   float* __restrict__ score) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  if (mask_first && !inside_margin(y, x, h, w)) {
    score[y * w + x] = 0.0f;
    return;
  }
  const float c = img[y * w + x];
  float excess[16];
  unsigned bright = 0, dark = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int yy = clampi(y + kRingDy[k], 0, h - 1);
    const int xx = clampi(x + kRingDx[k], 0, w - 1);
    const float d = img[yy * w + xx] - c;
    bright |= (d > thr ? 1u : 0u) << k;
    dark |= (d < -thr ? 1u : 0u) << k;
    excess[k] = fabsf(d) - thr;
  }
  const unsigned ring2b = bright | (bright << 16);  // wraparound arcs
  const unsigned ring2d = dark | (dark << 16);
  const unsigned arc = (1u << kArcLen) - 1u;
  float best = 0.0f;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const bool b_ok = ((ring2b >> s) & arc) == arc;
    const bool d_ok = ((ring2d >> s) & arc) == arc;
    float sad = 0.0f;
#pragma unroll
    for (int k = 0; k < kArcLen; ++k) sad += excess[(s + k) & 15];
    best = fmaxf(best, (b_ok || d_ok) ? sad : 0.0f);
  }
  score[y * w + x] = best;
}

__global__ void fast9_nms_kernel(const float* __restrict__ score, int h, int w,
                                 float* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const float s = score[y * w + x];
  float pooled = -INFINITY;
  for (int dy = -1; dy <= 1; ++dy) {
    for (int dx = -1; dx <= 1; ++dx) {
      const int yy = y + dy, xx = x + dx;
      if (yy >= 0 && yy < h && xx >= 0 && xx < w)
        pooled = fmaxf(pooled, score[yy * w + xx]);
    }
  }
  const bool keep = (s >= pooled) && (s > 0.0f);
  out[y * w + x] = (keep && inside_margin(y, x, h, w)) ? s : 0.0f;
}

}  // namespace

extern "C" int fast9_detect(const void* img, int h, int w, float threshold,
                            int mask_first, void* score_scratch, void* out,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fast9_score_kernel<<<grid, block, 0, s>>>(
      static_cast<const float*>(img), h, w, threshold, mask_first,
      static_cast<float*>(score_scratch));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fast9_nms_kernel<<<grid, block, 0, s>>>(
      static_cast<const float*>(score_scratch), h, w, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
