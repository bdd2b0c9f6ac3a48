// Deterministic segment sum, CUDA C++ for sm_90a with a plain C entry point
// (loaded with ctypes by orb_slam2_e_tpu_torch/ops/scatter.py).
//
//   out[s, c] = sum of vals[r, c] over the rows r with idx[r] == s,
//               added one by one in ascending r, starting from 0.0f
//
// for s < n_seg; rows past offsets[n_seg] (the spare segment of masked rows)
// are not read. It replaces the atomics of `index_add_` /
// `index_put_(accumulate=True)` under the port's float scatter-adds (the BA's
// normal blocks, Schur buffer and PCG products, the pose graph's Hessian and
// gradient, the FEM assembly), whose order changes from run to run on the
// card. No TPU kernel: the reference sums with XLA scatters
// (`jax.ops.segment_sum`, orb_slam2_e_tpu/ops/ba.py:132, :181), which add in
// one fixed order. The order here is the one in which the CPU's `index_add_`
// adds, so on the same inputs the two agree bit for bit.
//
// The wrapper hands in a plan: `perm`, a stable sort of the segment index,
// and the n_seg + 1 offsets of each segment's rows in that order. Stability keeps
// ascending row order inside a segment.
//
// What bounds it on an H100: bytes. Each value is read once and each output
// written once (4 bytes each), plus 8 bytes of permutation per row and of
// offsets per segment; one float add per value, 1 operation in ~8-12
// bytes, far below the card's ~10 operations per byte. The design is the
// simple one that keeps the order: one thread per (segment, column), which
// walks its segment's rows serially. Neighbouring threads take neighbouring
// columns of one row, so a row's D values are read by adjacent lanes and
// the permutation entry is a broadcast. The loop issues the loads of four
// rows before it adds them in order, so four loads are in flight per
// thread. A segment of thousands of rows (the PCG's per-camera sums) is
// a serial chain of that length; its time is in PERF.md.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ vals,
                   const long long* __restrict__ perm,
                   const long long* __restrict__ offsets, long long n_seg,
                   int d, float* __restrict__ out) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n_seg * d) return;
  const long long seg = t / d;
  const int col = static_cast<int>(t - seg * d);
  const long long lo = __ldg(offsets + seg);
  const long long hi = __ldg(offsets + seg + 1);
  float acc = 0.0f;
  long long k = lo;
  for (; k + 4 <= hi; k += 4) {
    const float v0 = __ldg(vals + __ldg(perm + k) * d + col);
    const float v1 = __ldg(vals + __ldg(perm + k + 1) * d + col);
    const float v2 = __ldg(vals + __ldg(perm + k + 2) * d + col);
    const float v3 = __ldg(vals + __ldg(perm + k + 3) * d + col);
    acc = __fadd_rn(acc, v0);
    acc = __fadd_rn(acc, v1);
    acc = __fadd_rn(acc, v2);
    acc = __fadd_rn(acc, v3);
  }
  for (; k < hi; ++k) {
    acc = __fadd_rn(acc, __ldg(vals + __ldg(perm + k) * d + col));
  }
  out[t] = acc;
}

}  // namespace

// vals: (rows, d) float32, contiguous; perm: (rows,) int64;
// offsets: (n_seg + 1,) int64; out: (n_seg, d) float32. Returns the CUDA
// error of the launch (0 when it was accepted).
extern "C" int segment_sum_launch(const void* vals, const void* perm,
                                  const void* offsets, long long n_seg, int d,
                                  void* out, void* stream) {
  if (n_seg < 0 || d < 1 || d > 64 || perm == nullptr) return -1;
  const long long total = n_seg * d;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return -1;
  segment_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const long long*>(perm),
      static_cast<const long long*>(offsets), n_seg, d,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
