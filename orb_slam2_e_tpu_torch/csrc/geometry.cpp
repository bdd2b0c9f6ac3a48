// Host geometry for the deformable mode of the PyTorch port.
//
// The port's own copy of the reference package's native geometry
// (orb_slam2_e_tpu/native/src/geometry.cpp), statement for statement, so
// that both packages triangulate the same points into the same triangles:
//  - delaunay_triangulate: 2D Bowyer-Watson Delaunay, the FEM mesher's
//    triangulation (ops/fem.py::build_mesh). It runs on the host once per
//    relocalization attempt and feeds the FEM assembly on the device.
//  - knn_query: grid-hash k-nearest-neighbour queries, which pick the
//    untracked landmarks nearest the tracked surface for the mode-2
//    deformation propagation (models/deformable.py::propagate_untracked).
//
// Exposed with a plain C ABI for ctypes (ops/geometry.py builds and binds it).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Bowyer-Watson Delaunay triangulation (2D)
// ---------------------------------------------------------------------------

namespace {

struct Tri {
  int a, b, c;
  bool dead = false;
};

static inline double circum_side(const double* P, int a, int b, int c,
                                 double px, double py) {
  // >0 if (px,py) inside circumcircle of (a,b,c) with CCW orientation
  double ax = P[2 * a] - px, ay = P[2 * a + 1] - py;
  double bx = P[2 * b] - px, by = P[2 * b + 1] - py;
  double cx = P[2 * c] - px, cy = P[2 * c + 1] - py;
  double d = (ax * ax + ay * ay) * (bx * cy - cx * by) -
             (bx * bx + by * by) * (ax * cy - cx * ay) +
             (cx * cx + cy * cy) * (ax * by - bx * ay);
  return d;
}

static inline double orient(const double* P, int a, int b, int c) {
  return (P[2 * b] - P[2 * a]) * (P[2 * c + 1] - P[2 * a + 1]) -
         (P[2 * c] - P[2 * a]) * (P[2 * b + 1] - P[2 * a + 1]);
}

}  // namespace

// pts: (n, 2) float32. out_tris: (max_tris, 3) int32. Returns #triangles
// (or -1 on failure / overflow).
int delaunay_triangulate(const float* pts, int n, int* out_tris,
                         int max_tris) {
  if (n < 3) return 0;
  std::vector<double> P(2 * (n + 3));
  double minx = 1e30, miny = 1e30, maxx = -1e30, maxy = -1e30;
  for (int i = 0; i < n; i++) {
    P[2 * i] = pts[2 * i];
    P[2 * i + 1] = pts[2 * i + 1];
    minx = std::min(minx, P[2 * i]);
    maxx = std::max(maxx, P[2 * i]);
    miny = std::min(miny, P[2 * i + 1]);
    maxy = std::max(maxy, P[2 * i + 1]);
  }
  double dx = maxx - minx, dy = maxy - miny;
  double d = std::max(dx, dy) * 100.0 + 1.0;
  double cx = (minx + maxx) / 2, cy = (miny + maxy) / 2;
  // super-triangle vertices at indices n, n+1, n+2
  P[2 * n] = cx - d;       P[2 * n + 1] = cy - d;
  P[2 * (n + 1)] = cx + d; P[2 * (n + 1) + 1] = cy - d;
  P[2 * (n + 2)] = cx;     P[2 * (n + 2) + 1] = cy + d;

  std::vector<Tri> tris;
  tris.push_back({n, n + 1, n + 2});

  std::vector<std::pair<int, int>> boundary;
  for (int ip = 0; ip < n; ip++) {
    double px = P[2 * ip], py = P[2 * ip + 1];
    boundary.clear();
    std::unordered_map<int64_t, int> edge_count;
    auto ekey = [](int u, int v) {
      int lo = std::min(u, v), hi = std::max(u, v);
      return (int64_t)lo << 32 | (uint32_t)hi;
    };
    // find all "bad" triangles whose circumcircle contains the point
    for (auto& t : tris) {
      if (t.dead) continue;
      double s = orient(P.data(), t.a, t.b, t.c);
      double inside = circum_side(P.data(), t.a, t.b, t.c, px, py);
      if (s < 0) inside = -inside;
      if (inside > 0) {
        t.dead = true;
        edge_count[ekey(t.a, t.b)]++;
        edge_count[ekey(t.b, t.c)]++;
        edge_count[ekey(t.c, t.a)]++;
        boundary.push_back({t.a, t.b});
        boundary.push_back({t.b, t.c});
        boundary.push_back({t.c, t.a});
      }
    }
    // re-triangulate the cavity: edges appearing exactly once
    for (auto& e : boundary) {
      int64_t k = ((int64_t)std::min(e.first, e.second) << 32) |
                  (uint32_t)std::max(e.first, e.second);
      if (edge_count[k] == 1) {
        tris.push_back({e.first, e.second, ip});
      }
    }
    // periodic compaction to bound memory
    if (tris.size() > (size_t)(12 * n + 64)) {
      std::vector<Tri> keep;
      keep.reserve(tris.size());
      for (auto& t : tris)
        if (!t.dead) keep.push_back(t);
      tris.swap(keep);
    }
  }
  int count = 0;
  for (auto& t : tris) {
    if (t.dead) continue;
    if (t.a >= n || t.b >= n || t.c >= n) continue;  // touches super-tri
    if (count >= max_tris) return -1;
    // emit CCW
    if (orient(P.data(), t.a, t.b, t.c) < 0) {
      out_tris[3 * count] = t.a;
      out_tris[3 * count + 1] = t.c;
      out_tris[3 * count + 2] = t.b;
    } else {
      out_tris[3 * count] = t.a;
      out_tris[3 * count + 1] = t.b;
      out_tris[3 * count + 2] = t.c;
    }
    count++;
  }
  return count;
}

// ---------------------------------------------------------------------------
// Grid-hash k-nearest neighbours (3D)
// ---------------------------------------------------------------------------

// pts: (n, 3) f32; queries: (m, 3) f32; out_idx: (m, k) int32 (-1 pad).
void knn_query(const float* pts, int n, const float* queries, int m, int k,
               float cell, int* out_idx) {
  std::unordered_map<int64_t, std::vector<int>> grid;
  auto key = [cell](float x, float y, float z) {
    int ix = (int)std::floor(x / cell);
    int iy = (int)std::floor(y / cell);
    int iz = (int)std::floor(z / cell);
    return ((int64_t)(ix & 0x1FFFFF) << 42) |
           ((int64_t)(iy & 0x1FFFFF) << 21) | (int64_t)(iz & 0x1FFFFF);
  };
  for (int i = 0; i < n; i++)
    grid[key(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2])].push_back(i);

  std::vector<std::pair<float, int>> cand;
  for (int q = 0; q < m; q++) {
    cand.clear();
    float qx = queries[3 * q], qy = queries[3 * q + 1], qz = queries[3 * q + 2];
    for (int ring = 1; ring <= 4 && (int)cand.size() < k; ring++) {
      cand.clear();
      for (int dx = -ring; dx <= ring; dx++)
        for (int dy = -ring; dy <= ring; dy++)
          for (int dz = -ring; dz <= ring; dz++) {
            auto it = grid.find(key(qx + dx * cell, qy + dy * cell,
                                    qz + dz * cell));
            if (it == grid.end()) continue;
            for (int i : it->second) {
              float ddx = pts[3 * i] - qx, ddy = pts[3 * i + 1] - qy,
                    ddz = pts[3 * i + 2] - qz;
              cand.push_back({ddx * ddx + ddy * ddy + ddz * ddz, i});
            }
          }
    }
    std::sort(cand.begin(), cand.end());
    for (int j = 0; j < k; j++)
      out_idx[q * k + j] = j < (int)cand.size() ? cand[j].second : -1;
  }
}

}  // extern "C"
