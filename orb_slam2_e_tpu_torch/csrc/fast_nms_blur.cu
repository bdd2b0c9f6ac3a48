// Fused FAST-9/16 score + 3x3 non-max suppression + 7x7 Gaussian blur over
// every level of an image pyramid in ONE launch, CUDA C++ for sm_90a with a
// plain C entry point (loaded with ctypes by
// orb_slam2_e_tpu_torch/ops/kernels.py).
//
// Replaces orb_slam2_e_tpu/ops/pallas_kernels.py::fast_nms_blur (the only
// Pallas kernel of the reference). It computes the function of the XLA path
// the reference runs on CPU (orb.fast_score_map + the NMS of
// orb.detect_level + orb.gaussian_blur7) over the WHOLE image of each level:
//   - FAST ring reads clamp to the image edge (`_shift2d` pads with 'edge');
//   - NMS neighbour reads clamp to the edge of the score map;
//   - the blur uses reflect-101 borders (jnp.pad mode='reflect', which is
//     also the original ORB-SLAM2's BORDER_REFLECT_101).
// The TPU kernel padded the blur with 'edge' instead; this one does not.
//
// What bounds it on an H100. A pixel moves 12 bytes (one f32 read, two
// written): 3.6 ps at 3.35e12 bytes/s. The function as the reference
// computes it needs ~223 f32 operations per pixel (16 ring differences, 128
// min/max for the two window trees, 30 for their final reductions, 7 to
// combine and threshold, 16 for NMS, 26 for the blur). None is a fused
// multiply-add (the blur's rounding is pinned), so they run at one per lane
// per clock, 132 SMs x 128 lanes x 1.98 GHz = 33.5e12 /s, half of the card's
// 67 TFLOP/s: 6.7 ps per pixel, so computed in full it is bound by
// instruction throughput, not by memory. The exact early reject below leaves 46
// operations on every pixel, 177 more where a score is possible and 16
// where one is not 0; on a frame where an eighth of the pixels pass the
// reject that is ~70 per pixel, 2.1 ps, and the bytes bind. There is no
// matrix product in it, so the tensor cores have nothing to do.
//
// What the design does about it:
//   - one launch per extraction: a 1-D grid over the tiles of all levels, a
//     block finding its level by binary search in a table of first tile
//     indices passed as a __grid_constant__ argument. The table holds 64
//     levels (32 B each, 2 KB of the 4 KB parameter space), so the pyramids
//     of 8 camera streams go in one launch. The small levels, which cannot
//     fill 132 SMs on their own, share the card with the large ones. Each
//     level's input is its own tensor (no packing copy); the two outputs
//     are packed buffers that the wrapper allocates once and views per
//     level;
//   - an exact early reject: a 9-arc holds two neighbouring compass
//     positions of the ring, which bounds the score from 4 of the 16
//     differences; where the bound is not above the lower threshold the
//     score is 0 without the search. The pixels that are left are
//     compacted into a list in shared memory, so the search runs on full
//     warps whatever the image looks like;
//   - the 9-of-16 arc search is the reference kernel's log-step circular
//     window tree (windows of 2, 4, 8, then one more): 4 operations per ring
//     position and tree, on registers, min-tree for bright and max-tree for
//     dark from the same 16 differences. fminf/fmaxf are exact, so the order
//     does not change the bits;
//   - a TILE_W x TILE_H tile (32x16) per 128-thread block, 4 pixels per
//     thread: the halo loaded is 1.88x the tile (was 2.5x) and the apron
//     that is tested 1.2x (was 1.33x, searched in full); tiles of 32x16 to
//     64x32 with 128 to 512 threads all measured within 15% of each other;
//   - the halo tile arrives by asynchronous copies (cp.async), all of a
//     thread's loads in flight together;
//   - work is dealt to warps as row segments of 32 consecutive pixels, so
//     shared-memory reads are conflict-free (odd row pitches keep the few
//     column-shaped tasks conflict-free too), global accesses coalesce, and
//     no loop divides or takes a remainder by a run-time value;
//   - ring offsets are immediates; a tile whose halo lies inside the image
//     takes an instantiation without clamps, reflect-101 index arithmetic
//     or bounds checks.
//
// A block:
//   phase 1   load img[clamp(y), clamp(x)] for the tile + 4-px halo
//   phase 2a  early reject for the tile + 1-px apron; an apron slot outside
//             the image stands for its clamped in-image pixel, which is
//             what the edge-padded NMS of the reference sees
//   phase 2b  vertical blur pass for the tile rows over the tile columns + 3
//             on each side
//   phase 2c  arc search for the listed slots
//   phase 3   NMS and horizontal blur pass, stores
// Arithmetic of the blur is pinned with __fmul_rn/__fadd_rn (no FMA
// contraction) in the reference's term order, so it rounds as the plain
// torch version does.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 32;            // output columns per block
constexpr int TILE_H = 16;            // output rows per block
constexpr int NT = 128;               // threads per block
constexpr int NWARP = NT / 32;
constexpr int SEG = TILE_W / 32;      // 32-pixel row segments per tile row
constexpr int HALO = 4;               // 3 px for the FAST ring + 1 px NMS apron
constexpr int IMG_ROWS = TILE_H + 2 * HALO;
constexpr int IMG_COLS = TILE_W + 2 * HALO;
constexpr int IMG_PITCH = IMG_COLS | 1;          // odd pitches: see header
constexpr int APRON_ROWS = TILE_H + 2;
constexpr int APRON_COLS = TILE_W + 2;
constexpr int APRON_PITCH = APRON_COLS | 1;
constexpr int VB_COLS = TILE_W + 6;              // tile columns + 3 each side
constexpr int VB_PITCH = VB_COLS | 1;
constexpr int MAX_LEVELS = 64;            // 8 lanes x 8 levels

static_assert(TILE_W % 32 == 0 && (SEG & (SEG - 1)) == 0, "tile width");
static_assert((TILE_H & (TILE_H - 1)) == 0, "tile height: a power of two");
static_assert(IMG_ROWS * IMG_PITCH <= 0xffff, "s_todo packs 16-bit indices");

struct Level {
  const float* img;     // (H, W) contiguous
  int H, W;
  int tiles_x;          // tiles per tile row
  int first_tile;       // index of the level's first block in the grid
  long long out;        // element offset into the packed outputs
};

struct Params {
  Level level[MAX_LEVELS];
  int n_levels;
  float th_high, th_low;
  float th_min;         // min(th_high, th_low): no score at or below it
  float g7[7];
};
static_assert(sizeof(Level) == 32, "a level table row is 32 bytes");
static_assert(sizeof(Params) <= 4096, "the classic 4 KB kernel-parameter space");

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// reflect-101 for offsets of at most 3 px beyond the edge (n >= 4)
__device__ __forceinline__ int reflect101(int v, int n) {
  if (v < 0) return -v;
  if (v >= n) return 2 * (n - 1) - v;
  return v;
}

// FAST-9/16 V-score with the two-threshold bonus of the pixel at p, a
// pointer into the shared halo tile.
__device__ __forceinline__ float fast_score(const float* p, float th_high,
                                            float th_low) {
  const float c = p[0];
  float d[16];
#define RING(k, dx, dy) d[k] = p[(dy) * IMG_PITCH + (dx)] - c;
  RING(0, 0, -3) RING(1, 1, -3) RING(2, 2, -2) RING(3, 3, -1)
  RING(4, 3, 0) RING(5, 3, 1) RING(6, 2, 2) RING(7, 1, 3)
  RING(8, 0, 3) RING(9, -1, 3) RING(10, -2, 2) RING(11, -3, 1)
  RING(12, -3, 0) RING(13, -3, -1) RING(14, -2, -2) RING(15, -1, -3)
#undef RING
  // circular windows of 2, 4, 8 and then 9 consecutive ring positions
  float lo2[16], hi2[16], lo4[16], hi4[16], lo8[16], hi8[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo2[k] = fminf(d[k], d[(k + 1) & 15]);
    hi2[k] = fmaxf(d[k], d[(k + 1) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo4[k] = fminf(lo2[k], lo2[(k + 2) & 15]);
    hi4[k] = fmaxf(hi2[k], hi2[(k + 2) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo8[k] = fminf(lo4[k], lo4[(k + 4) & 15]);
    hi8[k] = fmaxf(hi4[k], hi4[(k + 4) & 15]);
  }
  float lo9[16], hi9[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo9[k] = fminf(lo8[k], d[(k + 8) & 15]);
    hi9[k] = fmaxf(hi8[k], d[(k + 8) & 15]);
  }
  // bright: max_s min_arc d; dark: max_s min_arc (-d) = -min_s max_arc d
#define FOLD(w)                                                   \
  _Pragma("unroll") for (int k = 0; k < (w); ++k) {               \
    lo9[k] = fmaxf(lo9[k], lo9[k + (w)]);                         \
    hi9[k] = fminf(hi9[k], hi9[k + (w)]);                         \
  }
  FOLD(8) FOLD(4) FOLD(2) FOLD(1)
#undef FOLD
  const float v = fmaxf(lo9[0], -hi9[0]);
  return __fadd_rn(v > th_low ? v : 0.0f, v > th_high ? 1e4f : 0.0f);
}

// Exact early reject. An arc of 9 consecutive ring positions holds two
// compass positions (0, 4, 8, 12) that are neighbours on the compass, so the
// V-score is at most the best over the four neighbour pairs of the smaller
// difference (bright) or of the smaller negated difference (dark). Where
// that bound is not above th_min the score is exactly 0.
__device__ __forceinline__ bool may_score(const float* p, float th_min) {
  const float c = p[0];
  const float n = p[-3 * IMG_PITCH] - c, e = p[3] - c;
  const float s = p[3 * IMG_PITCH] - c, w = p[-3] - c;
  const float bright = fmaxf(fmaxf(fminf(n, e), fminf(e, s)),
                             fmaxf(fminf(s, w), fminf(w, n)));
  const float dark = fminf(fminf(fmaxf(n, e), fmaxf(e, s)),
                           fminf(fmaxf(s, w), fmaxf(w, n)));
  return fmaxf(bright, -dark) > th_min;
}

// 7 taps along a line of `stride` floats around `centre`, which holds
// position `pos` of a line of length `n`. REFLECT: taps beyond the line's
// ends take their reflect-101 position.
template <bool REFLECT>
__device__ __forceinline__ float blur7(const float* centre, int stride,
                                       int pos, int n, const float (&g7)[7]) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const int off = REFLECT ? reflect101(pos + k - 3, n) - pos : k - 3;
    acc = __fadd_rn(acc, __fmul_rn(g7[k], centre[off * stride]));
  }
  return acc;
}

// One tile of one level. EDGE: the tile's halo crosses the image border or
// the tile is cut by it, so reads clamp, blur taps reflect, and slots and
// pixels outside the image are skipped. A tile whose halo lies inside the
// image (most tiles of the large levels) takes the other instantiation,
// whose index arithmetic is all compile-time strides.
template <bool EDGE>
__device__ __forceinline__ void process_tile(
    const Params& prm, const Level& L, int x0, int y0,
    float* __restrict__ score_out, float* __restrict__ blur_out, float* s_img,
    float* s_score, float* s_vblur, int* s_todo, int* s_n_todo) {
  const int H = L.H, W = L.W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // phase 1: tile + halo; s_img[r][c] is pixel (y0 - HALO + r,
  // x0 - HALO + c), clamped into the image. Asynchronous copies, so that
  // all of a thread's loads are in flight together.
#pragma unroll
  for (int i = 0; i < (IMG_ROWS + NWARP - 1) / NWARP; ++i) {
    const int r = warp + i * NWARP;
    if (r < IMG_ROWS) {
      const int gy = y0 - HALO + r;
      const float* row =
          L.img + static_cast<long long>(EDGE ? clampi(gy, 0, H - 1) : gy) * W;
#pragma unroll
      for (int j = 0; j < (IMG_COLS + 31) / 32; ++j) {
        const int c = lane + 32 * j, gx = x0 - HALO + c;
        if (c < IMG_COLS)
          __pipeline_memcpy_async(&s_img[r * IMG_PITCH + c],
                                  &row[EDGE ? clampi(gx, 0, W - 1) : gx], 4);
      }
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // phase 2a: the early reject over tile + 1-px apron; s_score[ar][ax] is
  // the slot of pixel (y0 - 1 + ar, x0 - 1 + ax), clamped into the image. A
  // warp takes tasks of 32 slots: row segments of the apron's interior
  // columns, and (its last warps) the apron's two edge columns. A rejected
  // slot gets its 0; the others are appended to s_todo for phase 2c, with
  // one shared atomic per warp for all of its tasks.
  constexpr int ROW_TASKS = APRON_ROWS * SEG;
  constexpr int ROW_ROUNDS = (ROW_TASKS + NWARP - 1) / NWARP;
  constexpr int COL_TASKS = (2 * APRON_ROWS + 31) / 32;
  static_assert(COL_TASKS <= NWARP, "one edge-column task per warp at most");
  int code[ROW_ROUNDS + 1];
  unsigned votes[ROW_ROUNDS + 1];
  int n_todo = 0;
#pragma unroll
  for (int i = 0; i <= ROW_ROUNDS; ++i) {
    int ar, ax;
    bool used;
    if (i < ROW_ROUNDS) {
      const int t = warp + i * NWARP;
      ar = t / SEG;
      ax = 1 + 32 * (t % SEG) + lane;
      used = t < ROW_TASKS;
    } else {
      const int s = (warp - (NWARP - COL_TASKS)) * 32 + lane;
      const bool right = s >= APRON_ROWS;
      ar = right ? s - APRON_ROWS : s;
      ax = right ? APRON_COLS - 1 : 0;
      used = s >= 0 && ar < APRON_ROWS;
    }
    int sy = ar + HALO - 1, sx = ax + HALO - 1;
    if (EDGE) {
      // slots past the apron of the image's last row and column are never
      // read; the others carry the score of their clamped in-image pixel
      used = used && y0 - 1 + ar <= H && x0 - 1 + ax <= W;
      sy = clampi(y0 - 1 + ar, 0, H - 1) - (y0 - HALO);
      sx = clampi(x0 - 1 + ax, 0, W - 1) - (x0 - HALO);
    }
    const int at = used ? sy * IMG_PITCH + sx : HALO * IMG_PITCH + HALO;
    const int slot = ar * APRON_PITCH + ax;
    const bool todo = may_score(&s_img[at], prm.th_min) && used;
    if (used && !todo) s_score[slot] = 0.0f;
    code[i] = (slot << 16) | at;
    votes[i] = __ballot_sync(0xffffffffu, todo);
    n_todo += __popc(votes[i]);
  }
  if (n_todo != 0) {
    int base = 0;
    if (lane == 0) base = atomicAdd(s_n_todo, n_todo);
    base = __shfl_sync(0xffffffffu, base, 0);
#pragma unroll
    for (int i = 0; i <= ROW_ROUNDS; ++i) {
      if ((votes[i] >> lane) & 1u)
        s_todo[base + __popc(votes[i] & ((1u << lane) - 1u))] = code[i];
      base += __popc(votes[i]);
    }
  }

  // phase 2b: vertical blur pass; s_vblur[r][c] is pixel (y0 + r,
  // x0 - 3 + c). Rows reflect-101; columns outside the image hold values
  // that phase 3 never reads. Tasks: row segments of the tile's own columns,
  // then the 3 + 3 columns beside it.
  const bool reflect_rows = EDGE && (y0 < 3 || y0 + TILE_H + 3 > H);
  constexpr int VB_ROW_TASKS = TILE_H * SEG;
  constexpr int VB_TASKS = VB_ROW_TASKS + (6 * TILE_H + 31) / 32;
#pragma unroll
  for (int i = 0; i < (VB_TASKS + NWARP - 1) / NWARP; ++i) {
    const int t = warp + i * NWARP;
    int r, c;
    if (t < VB_ROW_TASKS) {
      r = t / SEG;
      c = 3 + 32 * (t % SEG) + lane;
    } else {
      const int s = (t - VB_ROW_TASKS) * 32 + lane;
      const int e = s / TILE_H;                  // 0..5: which side column
      r = s % TILE_H;
      c = e < 3 ? e : TILE_W + e;
    }
    if (t >= VB_TASKS || c >= VB_COLS || (EDGE && y0 + r >= H)) continue;
    const float* centre = &s_img[(r + HALO) * IMG_PITCH + c + 1];
    s_vblur[r * VB_PITCH + c] =
        reflect_rows ? blur7<true>(centre, IMG_PITCH, y0 + r, H, prm.g7)
                     : blur7<false>(centre, IMG_PITCH, y0 + r, H, prm.g7);
  }
  __syncthreads();

  // phase 2c: the arc search, only where phase 2a could not rule a score
  // out, one slot per thread whichever row it lies in
  for (int i = threadIdx.x; i < *s_n_todo; i += NT) {
    const int e = s_todo[i];
    s_score[e >> 16] = fast_score(&s_img[e & 0xffff], prm.th_high,
                                  prm.th_low);
  }
  __syncthreads();

  // phase 3: NMS + horizontal blur pass, one row segment per task
  const bool reflect_cols = EDGE && (x0 < 3 || x0 + TILE_W + 3 > W);
  static_assert(TILE_H * SEG % NWARP == 0, "whole rounds of output tasks");
#pragma unroll
  for (int i = 0; i < TILE_H * SEG / NWARP; ++i) {
    const int t = warp + i * NWARP;
    const int r = t / SEG, cx = 32 * (t % SEG) + lane;
    const int x = x0 + cx, y = y0 + r;
    if (EDGE && (x >= W || y >= H)) continue;
    const float* sp = &s_score[(r + 1) * APRON_PITCH + cx + 1];
    const float sc = sp[0];
    bool is_max = true;
    if (sc != 0.0f) {                 // a 0 stays 0 whatever its neighbours
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx)
          if (dy != 0 || dx != 0) is_max &= sc >= sp[dy * APRON_PITCH + dx];
    }
    const long long o = L.out + static_cast<long long>(y) * W + x;
    score_out[o] = is_max ? sc : 0.0f;
    const float* centre = &s_vblur[r * VB_PITCH + cx + 3];
    blur_out[o] = reflect_cols ? blur7<true>(centre, 1, x, W, prm.g7)
                               : blur7<false>(centre, 1, x, W, prm.g7);
  }
}

__global__ void __launch_bounds__(NT)
fast_nms_blur_kernel(const __grid_constant__ Params prm,
                     float* __restrict__ score_out,
                     float* __restrict__ blur_out) {
  __shared__ float s_img[IMG_ROWS * IMG_PITCH];
  __shared__ float s_score[APRON_ROWS * APRON_PITCH];
  __shared__ float s_vblur[TILE_H * VB_PITCH];
  __shared__ int s_todo[APRON_ROWS * APRON_COLS];   // slot << 16 | s_img index
  __shared__ int s_n_todo;

  if (threadIdx.x == 0) s_n_todo = 0;
  // the block's level: the last one whose first tile is not beyond it, by
  // binary search over the increasing first tiles (6 steps for 64 levels)
  int lvl = 0, hi = prm.n_levels - 1;
  while (lvl < hi) {
    const int mid = (lvl + hi + 1) >> 1;
    if (static_cast<int>(blockIdx.x) >= prm.level[mid].first_tile)
      lvl = mid;
    else
      hi = mid - 1;
  }
  const Level& L = prm.level[lvl];
  const int tile = blockIdx.x - L.first_tile;
  const int tile_y = tile / L.tiles_x;          // once per block
  const int x0 = (tile - tile_y * L.tiles_x) * TILE_W, y0 = tile_y * TILE_H;
  if (x0 >= HALO && y0 >= HALO && x0 + TILE_W + HALO <= L.W &&
      y0 + TILE_H + HALO <= L.H)
    process_tile<false>(prm, L, x0, y0, score_out, blur_out, s_img, s_score,
                        s_vblur, s_todo, &s_n_todo);
  else
    process_tile<true>(prm, L, x0, y0, score_out, blur_out, s_img, s_score,
                       s_vblur, s_todo, &s_n_todo);
}

}  // namespace

// One launch over n_levels images. imgs, heights, widths, offsets and taps7
// are host arrays; imgs[l] is a device pointer to a contiguous (H, W) f32
// image, offsets[l] the element offset of level l in the packed device
// buffers score and blur. Returns the CUDA error of the launch, or -1 for a
// level count the kernel's table does not hold.
extern "C" int fast_nms_blur_pyramid_launch(
    const void* const* imgs, const int* heights, const int* widths,
    const long long* offsets, int n_levels, float* score, float* blur,
    float th_high, float th_low, const float* taps7, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return -1;
  Params prm;
  int n_tiles = 0;
  for (int l = 0; l < n_levels; ++l) {
    Level& L = prm.level[l];
    L.img = static_cast<const float*>(imgs[l]);
    L.H = heights[l];
    L.W = widths[l];
    L.tiles_x = (L.W + TILE_W - 1) / TILE_W;
    L.first_tile = n_tiles;
    L.out = offsets[l];
    n_tiles += L.tiles_x * ((L.H + TILE_H - 1) / TILE_H);
  }
  for (int l = n_levels; l < MAX_LEVELS; ++l) prm.level[l] = Level{};
  prm.n_levels = n_levels;
  prm.th_high = th_high;
  prm.th_low = th_low;
  prm.th_min = th_high < th_low ? th_high : th_low;
  for (int k = 0; k < 7; ++k) prm.g7[k] = taps7[k];
  fast_nms_blur_kernel<<<n_tiles, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      prm, score, blur);
  return static_cast<int>(cudaGetLastError());
}
