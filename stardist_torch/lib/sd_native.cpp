// stardist_torch native host library.
//
// The host counterpart of the port's star distances, NMS and label
// rasters (a copy of stardist_tpu/lib/sd_native.cpp), and the embedding C
// ABI of the reference's C++ layer (stardist/lib/stardist3d_lib.h):
//   * a plain-C ABI so non-Python hosts (ImageJ/Fiji-style integrations)
//     can call star-dist / NMS / rasterization directly;
//   * an OpenMP host implementation with the same geometric semantics as
//     the port (wedge point-in-polygon, tetra-decomposition
//     point-in-polyhedron, sampled-overlap greedy NMS), used as an
//     independent oracle in tests. The port never calls it from a model.
//
// One change from the copied source: the 2D star distances' ray directions
// are rounded to float once from double, as the port's (and the JAX
// package's) are, so that the distances are equal to the port's bit for
// bit (the copied source rounds the angle to float first).
//
// Build: g++ -O3 -fopenmp -shared -fPIC sd_native.cpp -o libsd_native.so
#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

static inline int round_even(float v) { return (int)std::nearbyint(v); }

// ---------------------------------------------------------------------------
// 2D star distances (semantics of reference c_star_dist, stardist2d.cpp:55-124)
// ---------------------------------------------------------------------------
void sd2d_star_dist(const int32_t* lbl, int H, int W, int n_rays,
                    int gy, int gx, float* out /* (Ho,Wo,R) */) {
  const int Ho = (H - 1) / gy + 1, Wo = (W - 1) / gx + 1;
  std::vector<float> dr(n_rays), dc(n_rays), tcorr(n_rays);
  for (int k = 0; k < n_rays; k++) {
    const double phi = 2.0 * M_PI / n_rays * k;
    dr[k] = (float)std::sin(phi);
    dc[k] = (float)std::cos(phi);
    tcorr[k] = 0.5f / std::max(std::fabs(dr[k]), std::fabs(dc[k]));
  }
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < Ho; i++) {
    for (int j = 0; j < Wo; j++) {
      const int32_t v = lbl[(int64_t)(i * gy) * W + j * gx];
      float* o = out + ((int64_t)i * Wo + j) * n_rays;
      if (v == 0) {
        for (int k = 0; k < n_rays; k++) o[k] = 0.f;
        continue;
      }
      for (int k = 0; k < n_rays; k++) {
        int t = 0;
        for (;;) {
          t++;
          const float tf = (float)t;
          // offset rounding (matches the TPU shift-compare kernel)
          const int ii = i * gy + round_even(tf * dr[k]);
          const int jj = j * gx + round_even(tf * dc[k]);
          if (ii < 0 || ii >= H || jj < 0 || jj >= W ||
              lbl[(int64_t)ii * W + jj] != v) {
            o[k] = tf - 1.0f + tcorr[k];
            break;
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3D star distances (semantics of reference c_star_dist3d,
// stardist3d.cpp:245-346: distance from the rounded endpoint)
// ---------------------------------------------------------------------------
void sd3d_star_dist(const int32_t* lbl, int D, int H, int W,
                    const float* dirs /* (R,3) zyx */, int n_rays,
                    int gz, int gy, int gx, float* out /* (Do,Ho,Wo,R) */) {
  const int Do = (D - 1) / gz + 1, Ho = (H - 1) / gy + 1, Wo = (W - 1) / gx + 1;
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < Do; i++) {
    for (int j = 0; j < Ho; j++) {
      for (int k = 0; k < Wo; k++) {
        const int32_t v = lbl[((int64_t)(i * gz) * H + j * gy) * W + k * gx];
        float* o = out + (((int64_t)i * Ho + j) * Wo + k) * n_rays;
        if (v == 0) {
          for (int n = 0; n < n_rays; n++) o[n] = 0.f;
          continue;
        }
        for (int n = 0; n < n_rays; n++) {
          const float dz = dirs[3 * n], dy = dirs[3 * n + 1], dx = dirs[3 * n + 2];
          int t = 0;
          for (;;) {
            t++;
            const float tf = (float)t;
            const float rz = std::nearbyint(tf * dz), ry = std::nearbyint(tf * dy),
                        rx = std::nearbyint(tf * dx);
            // offset rounding (matches the TPU shift-compare kernel; the
            // distance uses the rounded offsets like the reference)
            const int ii = i * gz + (int)rz;
            const int jj = j * gy + (int)ry;
            const int kk = k * gx + (int)rx;
            if (ii < 0 || ii >= D || jj < 0 || jj >= H || kk < 0 || kk >= W ||
                lbl[((int64_t)ii * H + jj) * W + kk] != v) {
              o[n] = std::sqrt(rz * rz + ry * ry + rx * rx);
              break;
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2D geometry helpers
// ---------------------------------------------------------------------------
static inline bool inside_polygon(const float* dist, int R, float cr, float cc,
                                  float pr, float pc) {
  const float dphi = (float)(2.0 * M_PI / R);
  const float ur = pr - cr, uc = pc - cc;
  float theta = std::atan2(ur, uc);
  if (theta < 0) theta += (float)(2.0 * M_PI);
  int k = (int)(theta / dphi);
  if (k >= R) k = R - 1;
  const int k1 = (k + 1) % R;
  const float phi0 = k * dphi, phi1 = (k + 1) * dphi;
  const float v0r = dist[k] * std::sin(phi0), v0c = dist[k] * std::cos(phi0);
  const float v1r = dist[k1] * std::sin(phi1), v1c = dist[k1] * std::cos(phi1);
  const float er = v1r - v0r, ec = v1c - v0c;
  const float cross_p = er * (uc - v0c) - ec * (ur - v0r);
  const float cross_c = er * (0.f - v0c) - ec * (0.f - v0r);
  return cross_p * cross_c >= 0.f;
}

static inline float polygon_area(const float* dist, int R) {
  float s = 0.f;
  for (int k = 0; k < R; k++) s += dist[k] * dist[(k + 1) % R];
  return 0.5f * std::sin((float)(2.0 * M_PI / R)) * s;
}

// ---------------------------------------------------------------------------
// 2D greedy NMS with sampled overlap (semantics of reference
// c_non_max_suppression_inds, stardist2d.cpp:390-615; overlap estimated on an
// S x S sub-pixel grid over the bbox intersection like the TPU kernel)
// ---------------------------------------------------------------------------
void sd2d_nms(const float* dist /* (N,R) */, const float* points /* (N,2) */,
              int N, int R, float thresh, int samples,
              uint8_t* survivors /* (N,), input sorted by desc score */) {
  std::vector<float> area(N), lo_r(N), lo_c(N), hi_r(N), hi_c(N);
#pragma omp parallel for
  for (int i = 0; i < N; i++) {
    area[i] = polygon_area(dist + (int64_t)i * R, R);
    float lr = 1e30f, lc = 1e30f, hr = -1e30f, hc = -1e30f;
    for (int k = 0; k < R; k++) {
      const float phi = (float)(2.0 * M_PI / R) * k;
      const float vr = points[2 * i] + dist[(int64_t)i * R + k] * std::sin(phi);
      const float vc = points[2 * i + 1] + dist[(int64_t)i * R + k] * std::cos(phi);
      lr = std::min(lr, vr); hr = std::max(hr, vr);
      lc = std::min(lc, vc); hc = std::max(hc, vc);
    }
    lo_r[i] = lr; hi_r[i] = hr; lo_c[i] = lc; hi_c[i] = hc;
    survivors[i] = 1;
  }
  for (int i = 0; i < N - 1; i++) {
    if (!survivors[i]) continue;
#pragma omp parallel for schedule(dynamic)
    for (int j = i + 1; j < N; j++) {
      if (!survivors[j]) continue;
      const float plo_r = std::max(lo_r[i], lo_r[j]), phi_r = std::min(hi_r[i], hi_r[j]);
      const float plo_c = std::max(lo_c[i], lo_c[j]), phi_c = std::min(hi_c[i], hi_c[j]);
      const float er = phi_r - plo_r, ec = phi_c - plo_c;
      if (er <= 0 || ec <= 0) continue;
      int cnt = 0;
      for (int a = 0; a < samples; a++) {
        const float pr = plo_r + (a + 0.5f) * er / samples;
        for (int b = 0; b < samples; b++) {
          const float pc = plo_c + (b + 0.5f) * ec / samples;
          if (inside_polygon(dist + (int64_t)i * R, R, points[2 * i], points[2 * i + 1], pr, pc) &&
              inside_polygon(dist + (int64_t)j * R, R, points[2 * j], points[2 * j + 1], pr, pc))
            cnt++;
        }
      }
      const float inter = (float)cnt / (samples * samples) * er * ec;
      const float overlap = inter / (std::min(area[i], area[j]) + 1e-10f);
      if (overlap > thresh) survivors[j] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// 2D rasterization (winner = max order value; reference polygons_to_label
// order semantics, geometry/geom2d.py:169-197)
// ---------------------------------------------------------------------------
void sd2d_polygons_to_label(const float* dist, const float* points,
                            const int32_t* order_values, int N, int R,
                            int H, int W, int32_t* out /* (H,W) zeroed */,
                            const int32_t* lut /* len >= max(order)+1, or NULL */) {
  // angle tables (double -> float, matching the numpy tables of the JAX
  // rasterizer so both paths make bit-identical wedge decisions)
  const double dphi_d = 2.0 * M_PI / R;
  const float dphi = (float)dphi_d;
  std::vector<float> s0(R), c0(R), s1(R), c1(R);
  for (int k = 0; k < R; k++) {
    s0[k] = (float)std::sin(dphi_d * k);
    c0[k] = (float)std::cos(dphi_d * k);
    s1[k] = (float)std::sin(dphi_d * (k + 1));
    c1[k] = (float)std::cos(dphi_d * (k + 1));
  }
  std::vector<float> v0r(R), v0c(R), v1r(R), v1c(R);
  // strip-parallel: each thread owns a contiguous row band and scans all
  // polygons whose bbox intersects it — no write conflicts on `out`
#ifdef _OPENMP
  const int n_threads = omp_get_max_threads();
#else
  const int n_threads = 1;
#endif
  const int strip = std::max(1, (H + n_threads - 1) / n_threads);
#pragma omp parallel for schedule(static, 1) firstprivate(v0r, v0c, v1r, v1c)
  for (int t = 0; t < (H + strip - 1) / strip; t++) {
    const int band0 = t * strip, band1 = std::min(H, band0 + strip);
    for (int i = 0; i < N; i++) {
      const float cr = points[2 * i], cc = points[2 * i + 1];
      const float* d = dist + (int64_t)i * R;
      float rmax = 0.f;
      for (int k = 0; k < R; k++) rmax = std::max(rmax, d[k]);
      const int r0 = std::max(band0, (int)std::floor(cr - rmax) - 1);
      const int r1 = std::min(band1 - 1, (int)std::ceil(cr + rmax) + 1);
      if (r0 > r1) continue;
      const int c0i = std::max(0, (int)std::floor(cc - rmax) - 1);
      const int c1i = std::min(W - 1, (int)std::ceil(cc + rmax) + 1);
      if (c0i > c1i) continue;
      for (int k = 0; k < R; k++) {
        const int k1 = (k + 1) % R;
        v0r[k] = d[k] * s0[k];
        v0c[k] = d[k] * c0[k];
        v1r[k] = d[k1] * s1[k];
        v1c[k] = d[k1] * c1[k];
      }
      const int32_t val = order_values[i];
      const float rmax2 = rmax * rmax;
      for (int r = r0; r <= r1; r++) {
        const float ur = (float)r - cr;
        int32_t* row = out + (int64_t)r * W;
        for (int c = c0i; c <= c1i; c++) {
          const float uc = (float)c - cc;
          if (ur * ur + uc * uc > rmax2) continue;  // cheap reject
          if (row[c] >= val) continue;              // cannot win
          float theta = std::atan2(ur, uc);
          if (theta < 0) theta += (float)(2.0 * M_PI);
          int k = (int)(theta / dphi);
          if (k >= R) k = R - 1;
          const float er = v1r[k] - v0r[k], ec = v1c[k] - v0c[k];
          const float cross_p = er * (uc - v0c[k]) - ec * (ur - v0r[k]);
          const float cross_c = ec * v0r[k] - er * v0c[k];
          if (cross_p * cross_c >= 0.f) row[c] = val;
        }
      }
    }
  }
  if (lut) {
    const int64_t n = (int64_t)H * W;
#pragma omp parallel for
    for (int64_t p = 0; p < n; p++) out[p] = lut[out[p]];
  }
}

// ---------------------------------------------------------------------------
// 3D geometry: tetra-decomposition inside test with precomputed inverses
// ---------------------------------------------------------------------------
struct FaceInv { float m[9]; bool valid; };

static void face_inverses(const float* dist, const float* verts, const int32_t* faces,
                          int R, int F, std::vector<FaceInv>& out) {
  out.resize(F);
  for (int f = 0; f < F; f++) {
    float col[3][3];  // columns A,B,C (zyx)
    for (int v = 0; v < 3; v++) {
      const int k = faces[3 * f + v];
      for (int c = 0; c < 3; c++) col[v][c] = dist[k] * verts[3 * k + c];
    }
    const float* a = col[0];
    const float* b = col[1];
    const float* c = col[2];
    // det of matrix with columns a,b,c
    const float det = a[0] * (b[1] * c[2] - b[2] * c[1])
                    - b[0] * (a[1] * c[2] - a[2] * c[1])
                    + c[0] * (a[1] * b[2] - a[2] * b[1]);
    out[f].valid = std::fabs(det) > 1e-12f;
    if (!out[f].valid) continue;
    // rows of inverse = cross products of the other two columns / det
    const float r0[3] = {b[1] * c[2] - b[2] * c[1], b[2] * c[0] - b[0] * c[2], b[0] * c[1] - b[1] * c[0]};
    const float r1[3] = {c[1] * a[2] - c[2] * a[1], c[2] * a[0] - c[0] * a[2], c[0] * a[1] - c[1] * a[0]};
    const float r2[3] = {a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]};
    for (int c2 = 0; c2 < 3; c2++) {
      out[f].m[0 + c2] = r0[c2] / det;
      out[f].m[3 + c2] = r1[c2] / det;
      out[f].m[6 + c2] = r2[c2] / det;
    }
  }
}

static inline bool inside_polyhedron(const std::vector<FaceInv>& inv,
                                     float uz, float uy, float ux, float eps = 1e-7f) {
  for (const auto& fi : inv) {
    if (!fi.valid) continue;
    const float al = fi.m[0] * uz + fi.m[1] * uy + fi.m[2] * ux;
    const float be = fi.m[3] * uz + fi.m[4] * uy + fi.m[5] * ux;
    const float ga = fi.m[6] * uz + fi.m[7] * uy + fi.m[8] * ux;
    if (al >= -eps && be >= -eps && ga >= -eps && al + be + ga <= 1 + eps) return true;
  }
  return false;
}

static float polyhedron_volume(const float* dist, const float* verts,
                               const int32_t* faces, int R, int F) {
  double vol = 0;
  for (int f = 0; f < F; f++) {
    float p[3][3];
    for (int v = 0; v < 3; v++) {
      const int k = faces[3 * f + v];
      for (int c = 0; c < 3; c++) p[v][c] = dist[k] * verts[3 * k + c];
    }
    const double det = (double)p[0][0] * (p[1][1] * p[2][2] - p[1][2] * p[2][1])
                     - (double)p[0][1] * (p[1][0] * p[2][2] - p[1][2] * p[2][0])
                     + (double)p[0][2] * (p[1][0] * p[2][1] - p[1][1] * p[2][0]);
    vol += det;
  }
  return (float)(-vol / 6.0);
}

// ---------------------------------------------------------------------------
// 3D greedy NMS: integer-lattice counted intersection / min analytic volume
// (semantics of reference _COMMON_non_maximum_suppression_sparse,
// stardist3d_impl.cpp:956-1385, exact stage)
// ---------------------------------------------------------------------------
void sd3d_nms(const float* dist /* (N,R) */, const float* points /* (N,3) */,
              const float* verts /* (R,3) */, const int32_t* faces /* (F,3) */,
              int N, int R, int F, float thresh,
              uint8_t* survivors /* (N,), input sorted by desc score */) {
  std::vector<float> vol(N);
  std::vector<float> lo(3 * N), hi(3 * N);
  std::vector<std::vector<FaceInv>> inv(N);
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < N; i++) {
    vol[i] = polyhedron_volume(dist + (int64_t)i * R, verts, faces, R, F);
    face_inverses(dist + (int64_t)i * R, verts, faces, R, F, inv[i]);
    for (int c = 0; c < 3; c++) { lo[3 * i + c] = 1e30f; hi[3 * i + c] = -1e30f; }
    for (int k = 0; k < R; k++)
      for (int c = 0; c < 3; c++) {
        const float v = points[3 * i + c] + dist[(int64_t)i * R + k] * verts[3 * k + c];
        lo[3 * i + c] = std::min(lo[3 * i + c], v);
        hi[3 * i + c] = std::max(hi[3 * i + c], v);
      }
    survivors[i] = 1;
  }
  for (int i = 0; i < N - 1; i++) {
    if (!survivors[i]) continue;
#pragma omp parallel for schedule(dynamic)
    for (int j = i + 1; j < N; j++) {
      if (!survivors[j]) continue;
      int b0[3], b1[3];
      bool empty = false;
      for (int c = 0; c < 3; c++) {
        b0[c] = (int)std::ceil(std::max(lo[3 * i + c], lo[3 * j + c]));
        b1[c] = (int)std::floor(std::min(hi[3 * i + c], hi[3 * j + c]));
        if (b0[c] > b1[c]) { empty = true; break; }
      }
      if (empty) continue;
      int64_t cnt = 0;
      for (int z = b0[0]; z <= b1[0]; z++)
        for (int y = b0[1]; y <= b1[1]; y++)
          for (int x = b0[2]; x <= b1[2]; x++) {
            if (inside_polyhedron(inv[i], z - points[3 * i], y - points[3 * i + 1], x - points[3 * i + 2]) &&
                inside_polyhedron(inv[j], z - points[3 * j], y - points[3 * j + 1], x - points[3 * j + 2]))
              cnt++;
          }
      const float overlap = (float)cnt / (std::min(vol[i], vol[j]) + 1e-10f);
      if (overlap > thresh) survivors[j] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// 3D rasterization (winner = max order value; overlap count output optional)
// ---------------------------------------------------------------------------
void sd3d_polyhedra_to_label(const float* dist, const float* points,
                             const float* verts, const int32_t* faces,
                             const int32_t* order_values,
                             int N, int R, int F, int D, int H, int W,
                             int32_t* out /* zeroed */, int32_t* count /* zeroed or null */) {
  for (int i = 0; i < N; i++) {
    std::vector<FaceInv> inv;
    face_inverses(dist + (int64_t)i * R, verts, faces, R, F, inv);
    float rmax = 0.f;
    for (int k = 0; k < R; k++) rmax = std::max(rmax, dist[(int64_t)i * R + k]);
    const float cz = points[3 * i], cy = points[3 * i + 1], cx = points[3 * i + 2];
    const int z0 = std::max(0, (int)std::floor(cz - rmax) - 1), z1 = std::min(D - 1, (int)std::ceil(cz + rmax) + 1);
    const int y0 = std::max(0, (int)std::floor(cy - rmax) - 1), y1 = std::min(H - 1, (int)std::ceil(cy + rmax) + 1);
    const int x0 = std::max(0, (int)std::floor(cx - rmax) - 1), x1 = std::min(W - 1, (int)std::ceil(cx + rmax) + 1);
#pragma omp parallel for
    for (int z = z0; z <= z1; z++)
      for (int y = y0; y <= y1; y++)
        for (int x = x0; x <= x1; x++)
          if (inside_polyhedron(inv, z - cz, y - cy, x - cx)) {
            const int64_t idx = ((int64_t)z * H + y) * W + x;
            out[idx] = std::max(out[idx], order_values[i]);
            if (count) {
#pragma omp atomic
              count[idx]++;
            }
          }
  }
}

// dense per-voxel polyhedron volume map from a dist map
// (reference _COMMON_dist_to_volume, stardist3d_impl.cpp:1529-1589)
void sd3d_dist_to_volume(const float* dist /* (M,R) */, const float* verts,
                         const int32_t* faces, int64_t M, int R, int F,
                         float* out /* (M,) */) {
#pragma omp parallel for
  for (int64_t m = 0; m < M; m++)
    out[m] = polyhedron_volume(dist + m * R, verts, faces, R, F);
}

int sd_version() { return 101; }

}  // extern "C"
