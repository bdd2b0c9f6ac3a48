// The earlier kernel of the ORB front end, kept as the timing baseline
// of csrc/fast_nms_blur.cu: one launch per pyramid level, one thread per
// output pixel on a 32x8 tile. chip_smoke.py builds it beside the current
// kernel, holds the two against each other bit for bit, and times both in
// one run on one card; nothing in the package calls it.
//
// Same function as the current kernel (see its header): FAST-9/16 V-score
// with edge-clamped ring reads and the two-threshold bonus, 3x3 NMS over an
// edge-clamped apron, 7x7 sigma=2 blur with reflect-101 borders in pinned
// __fmul_rn/__fadd_rn term order.
//
// Why it is slower: its arc search takes 16 x 8 min and 16 x 8 max per scored
// slot; it scores a 34x10 apron and loads a 40x16 halo for 256 outputs; its
// cooperative loops divide by the tile width; the ring offsets come from
// __constant__ arrays, not from immediates; and a pyramid takes one launch
// and two allocations per level.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;          // tile width  = threads per block in x
constexpr int TY = 8;           // tile height = threads per block in y
constexpr int HALO = 4;         // 3 px for the FAST ring + 1 px NMS apron
constexpr int SW = TX + 2 * HALO;
constexpr int SH = TY + 2 * HALO;
constexpr int ARC = 9;

__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

struct Taps7 {
  float k[7];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// reflect-101 for offsets of at most 3 px beyond the edge (n >= 4)
__device__ __forceinline__ int reflect101(int v, int n) {
  if (v < 0) return -v;
  if (v >= n) return 2 * (n - 1) - v;
  return v;
}

__global__ void fast_nms_blur_kernel(const float* __restrict__ img,
                                     float* __restrict__ score_out,
                                     float* __restrict__ blur_out,
                                     int H, int W, float th_high,
                                     float th_low, Taps7 g7) {
  __shared__ float s_img[SH][SW];
  __shared__ float s_score[TY + 2][TX + 2];
  __shared__ float s_vblur[TY][SW];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tid = ty * TX + tx;
  constexpr int NT = TX * TY;

  // phase 1: tile + halo, edge-clamped reads
  for (int i = tid; i < SH * SW; i += NT) {
    const int sy = i / SW, sx = i % SW;
    const int gy = clampi(y0 - HALO + sy, 0, H - 1);
    const int gx = clampi(x0 - HALO + sx, 0, W - 1);
    s_img[sy][sx] = img[gy * W + gx];
  }
  __syncthreads();

  // phase 2a: FAST score over tile + 1-px apron
  for (int i = tid; i < (TY + 2) * (TX + 2); i += NT) {
    const int ay = i / (TX + 2), ax = i % (TX + 2);
    // clamped in-image pixel whose score this apron slot carries
    const int py = clampi(y0 - 1 + ay, 0, H - 1);
    const int px = clampi(x0 - 1 + ax, 0, W - 1);
    const int sy = py - (y0 - HALO), sx = px - (x0 - HALO);
    const float c = s_img[sy][sx];
    float d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = s_img[sy + kRingDy[k]][sx + kRingDx[k]] - c;
    float bright = -__int_as_float(0x7f800000), dark = bright;  // -inf
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      float mn = d[s], mx = d[s];
#pragma unroll
      for (int k = 1; k < ARC; ++k) {
        const float v = d[(s + k) & 15];
        mn = fminf(mn, v);
        mx = fmaxf(mx, v);
      }
      bright = fmaxf(bright, mn);   // max_s min_arc d
      dark = fmaxf(dark, -mx);      // max_s min_arc (-d)
    }
    const float v = fmaxf(bright, dark);
    s_score[ay][ax] = __fadd_rn(v > th_low ? v : 0.0f, v > th_high ? 1e4f : 0.0f);
  }

  // phase 2b: vertical blur pass, tile rows x all halo columns
  // (rows reflect-101; columns outside the image are never read below)
  for (int i = tid; i < TY * SW; i += NT) {
    const int r = i / SW, sx = i % SW;
    const int gy = y0 + r;
    float acc = 0.0f;
    if (gy < H) {
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        const int ry = reflect101(gy + k - 3, H);
        acc = __fadd_rn(acc, __fmul_rn(g7.k[k], s_img[ry - (y0 - HALO)][sx]));
      }
    }
    s_vblur[r][sx] = acc;
  }
  __syncthreads();

  // phase 3: NMS + horizontal blur pass
  const int x = x0 + tx, y = y0 + ty;
  if (x >= W || y >= H) return;
  const float sc = s_score[ty + 1][tx + 1];
  bool is_max = true;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      if (dy != 1 || dx != 1) is_max &= sc >= s_score[ty + dy][tx + dx];
  score_out[y * W + x] = is_max ? sc : 0.0f;

  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const int rx = reflect101(x + k - 3, W);
    acc = __fadd_rn(acc, __fmul_rn(g7.k[k], s_vblur[ty][rx - (x0 - HALO)]));
  }
  blur_out[y * W + x] = acc;
}

}  // namespace

extern "C" int fast_nms_blur_v1_launch(const float* img, float* score,
                                       float* blur, int H, int W,
                                       float th_high, float th_low,
                                       const float* taps7, void* stream) {
  Taps7 g7;
  for (int k = 0; k < 7; ++k) g7.k[k] = taps7[k];   // host array
  const dim3 block(TX, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  fast_nms_blur_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, score, blur, H, W, th_high, th_low, g7);
  return static_cast<int>(cudaGetLastError());
}
