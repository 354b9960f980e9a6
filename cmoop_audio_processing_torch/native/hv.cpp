// Exact hypervolume for 2-D and 3-D minimization fronts.
//
// Native counterpart of metrics/hypervolume.py (same algorithms, same
// clipping semantics), standing in for the reference's use of pygmo's C++
// pagmo hypervolume core (reference: compare.ipynb cell 1). Built as a plain
// shared library and loaded via ctypes; the Python implementation is the
// always-available fallback and the parity oracle in tests.
//
// A copy of cmoop_audio_processing_tpu/native/hv.cpp. Build: build.py
// (g++ -O2 -shared -fPIC hv.cpp -o build/native/libhv.so at the repo root)

#include <algorithm>
#include <cstring>
#include <vector>

namespace {

struct P2 {
  double x, y;
};

// 2-D staircase sweep over points strictly dominating ref.
double hv2d(std::vector<P2> pts, double rx, double ry) {
  std::vector<P2> kept;
  kept.reserve(pts.size());
  for (const auto& p : pts) {
    if (p.x < rx && p.y < ry) kept.push_back(p);
  }
  if (kept.empty()) return 0.0;
  std::sort(kept.begin(), kept.end(), [](const P2& a, const P2& b) {
    if (a.x != b.x) return a.x < b.x;
    return a.y < b.y;
  });
  double hv = 0.0;
  double best_y = ry;
  for (const auto& p : kept) {
    if (p.y < best_y) {
      hv += (rx - p.x) * (best_y - p.y);
      best_y = p.y;
    }
  }
  return hv;
}

struct P3 {
  double x, y, z;
};

// 3-D sweep: between consecutive distinct z-levels the dominated 2-D area is
// the staircase area of all points at or below the level.
double hv3d(const double* data, int n, double rx, double ry, double rz) {
  std::vector<P3> pts;
  pts.reserve(n);
  for (int i = 0; i < n; ++i) {
    P3 p{data[3 * i], data[3 * i + 1], data[3 * i + 2]};
    if (p.x < rx && p.y < ry && p.z < rz) pts.push_back(p);
  }
  if (pts.empty()) return 0.0;
  std::stable_sort(pts.begin(), pts.end(),
                   [](const P3& a, const P3& b) { return a.z < b.z; });
  double hv = 0.0;
  size_t i = 0;
  std::vector<P2> active;
  active.reserve(pts.size());
  while (i < pts.size()) {
    double z = pts[i].z;
    size_t j = i;
    while (j < pts.size() && pts[j].z == z) {
      active.push_back(P2{pts[j].x, pts[j].y});
      ++j;
    }
    double z_next = (j < pts.size()) ? pts[j].z : rz;
    hv += hv2d(active, rx, ry) * (z_next - z);
    i = j;
  }
  return hv;
}

}  // namespace

extern "C" {

// points: row-major (n x d); ref: length d. Supports d == 2 or 3.
double hv_compute(const double* points, int n, int d, const double* ref) {
  if (n <= 0) return 0.0;
  if (d == 2) {
    std::vector<P2> pts(n);
    for (int i = 0; i < n; ++i) pts[i] = P2{points[2 * i], points[2 * i + 1]};
    return hv2d(pts, ref[0], ref[1]);
  }
  if (d == 3) {
    return hv3d(points, n, ref[0], ref[1], ref[2]);
  }
  return -1.0;  // unsupported dimension; caller falls back to Python
}
}
