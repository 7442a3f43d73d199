// Native host-side mesh/image ops for the homan_tpu_torch data pipeline.
//
// The reference delegates this work to external C++ executables
// (ManifoldPlus + ACVD remeshing, meshprocess/simplifymesh.py:28-104) and to
// scipy (EDT in homan/pose_optimization.py:84-88). Device compute stays in
// PyTorch; these are the host-side preprocessing hot spots:
//   * quadric-error-metric edge-collapse decimation (stage-B coarse meshes)
//   * exact squared Euclidean distance transform (Felzenszwalb-Huttenlocher)
//   * fast OBJ vertex/face parsing
//   * a host Phong z-buffer renderer of one frame
//
// A copy of homan_tpu/native/meshops.cpp, kept line for line in its
// functions so the two libraries give the same outputs.
// Build: homan_tpu_torch/native/build.py (g++ -O3 -shared -fPIC -std=c++17
// into homan_tpu_torch/_build/, keyed by a hash of this file), at first use.
// Python binding: ctypes (homan_tpu_torch/native/__init__.py); there is no
// Python fallback.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Exact 1D squared distance transform (Felzenszwalb & Huttenlocher 2004)
// ---------------------------------------------------------------------------
static void edt_1d(const float* f, float* d, int* v, float* z, int n) {
  int k = 0;
  v[0] = 0;
  z[0] = -1e20f;
  z[1] = 1e20f;
  for (int q = 1; q < n; q++) {
    float s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2 * q - 2 * v[k]);
    while (s <= z[k]) {
      k--;
      s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2 * q - 2 * v[k]);
    }
    k++;
    v[k] = q;
    z[k] = s;
    z[k + 1] = 1e20f;
  }
  k = 0;
  for (int q = 0; q < n; q++) {
    while (z[k + 1] < q) k++;
    d[q] = (q - v[k]) * (q - v[k]) + f[v[k]];
  }
}

// mask: (h, w) uint8, nonzero = feature. out: (h, w) float32 squared
// distance to the nearest feature pixel.
void edt2d_squared(const uint8_t* mask, float* out, int h, int w) {
  const float INF = 1e20f;
  std::vector<float> f(std::max(h, w));
  std::vector<float> d(std::max(h, w));
  std::vector<int> v(std::max(h, w));
  std::vector<float> z(std::max(h, w) + 1);

  // columns
  for (int x = 0; x < w; x++) {
    for (int y = 0; y < h; y++) f[y] = mask[y * w + x] ? 0.0f : INF;
    edt_1d(f.data(), d.data(), v.data(), z.data(), h);
    for (int y = 0; y < h; y++) out[y * w + x] = d[y];
  }
  // rows
  for (int y = 0; y < h; y++) {
    for (int x = 0; x < w; x++) f[x] = out[y * w + x];
    edt_1d(f.data(), d.data(), v.data(), z.data(), w);
    for (int x = 0; x < w; x++) out[y * w + x] = d[x];
  }
}

// ---------------------------------------------------------------------------
// Quadric-error-metric decimation (Garland & Heckbert '97, simplified:
// collapse to edge midpoint, no topology repair).
// ---------------------------------------------------------------------------
struct Quadric {
  double m[10];  // symmetric 4x4: xx xy xz xw yy yz yw zz zw ww
  void zero() { std::memset(m, 0, sizeof(m)); }
  void add_plane(double a, double b, double c, double d) {
    m[0] += a * a; m[1] += a * b; m[2] += a * c; m[3] += a * d;
    m[4] += b * b; m[5] += b * c; m[6] += b * d;
    m[7] += c * c; m[8] += c * d; m[9] += d * d;
  }
  void add(const Quadric& o) { for (int i = 0; i < 10; i++) m[i] += o.m[i]; }
  double eval(double x, double y, double z) const {
    return m[0]*x*x + 2*m[1]*x*y + 2*m[2]*x*z + 2*m[3]*x
         + m[4]*y*y + 2*m[5]*y*z + 2*m[6]*y
         + m[7]*z*z + 2*m[8]*z + m[9];
  }
};

struct Collapse {
  double cost;
  int u, v;
  int stamp_u, stamp_v;
  bool operator<(const Collapse& o) const { return cost > o.cost; }  // min-heap
};

// verts: (nv, 3) float32; faces: (nf, 3) int32. Outputs written in place;
// returns new face count, new vert count via out params.
int decimate_qem(const float* verts_in, int nv, const int32_t* faces_in,
                 int nf, int target_faces, float* verts_out,
                 int32_t* faces_out, int* out_nv) {
  std::vector<double> V(nv * 3);
  for (int i = 0; i < nv * 3; i++) V[i] = verts_in[i];
  std::vector<int32_t> F(faces_in, faces_in + nf * 3);
  std::vector<Quadric> Q(nv);
  for (auto& q : Q) q.zero();
  std::vector<int> stamp(nv, 0);
  std::vector<int> parent(nv);
  for (int i = 0; i < nv; i++) parent[i] = i;

  auto find = [&](int x) {
    while (parent[x] != x) { parent[x] = parent[parent[x]]; x = parent[x]; }
    return x;
  };

  auto face_quadric = [&](int fi) {
    int a = F[fi * 3], b = F[fi * 3 + 1], c = F[fi * 3 + 2];
    double ux = V[b*3]-V[a*3], uy = V[b*3+1]-V[a*3+1], uz = V[b*3+2]-V[a*3+2];
    double vx = V[c*3]-V[a*3], vy = V[c*3+1]-V[a*3+1], vz = V[c*3+2]-V[a*3+2];
    double nx = uy*vz - uz*vy, ny = uz*vx - ux*vz, nz = ux*vy - uy*vx;
    double len = std::sqrt(nx*nx + ny*ny + nz*nz);
    if (len < 1e-20) return;
    nx /= len; ny /= len; nz /= len;
    double d = -(nx*V[a*3] + ny*V[a*3+1] + nz*V[a*3+2]);
    Q[a].add_plane(nx, ny, nz, d);
    Q[b].add_plane(nx, ny, nz, d);
    Q[c].add_plane(nx, ny, nz, d);
  };
  for (int fi = 0; fi < nf; fi++) face_quadric(fi);

  std::priority_queue<Collapse> heap;
  auto push_edge = [&](int u, int v) {
    u = find(u); v = find(v);
    if (u == v) return;
    double x = (V[u*3] + V[v*3]) / 2, y = (V[u*3+1] + V[v*3+1]) / 2,
           z = (V[u*3+2] + V[v*3+2]) / 2;
    Quadric q = Q[u]; q.add(Q[v]);
    heap.push({q.eval(x, y, z), u, v, stamp[u], stamp[v]});
  };
  for (int fi = 0; fi < nf; fi++) {
    push_edge(F[fi*3], F[fi*3+1]);
    push_edge(F[fi*3+1], F[fi*3+2]);
    push_edge(F[fi*3+2], F[fi*3]);
  }

  int live_faces = 0;
  std::vector<char> face_dead(nf, 0);
  auto count_live = [&]() {
    live_faces = 0;
    for (int fi = 0; fi < nf; fi++) {
      int a = find(F[fi*3]), b = find(F[fi*3+1]), c = find(F[fi*3+2]);
      face_dead[fi] = (a == b || b == c || a == c);
      if (!face_dead[fi]) live_faces++;
    }
  };
  count_live();

  while (live_faces > target_faces && !heap.empty()) {
    Collapse c = heap.top(); heap.pop();
    int u = find(c.u), v = find(c.v);
    if (u == v) continue;
    if (stamp[u] != c.stamp_u || stamp[v] != c.stamp_v) continue;
    // collapse v into u at the midpoint
    V[u*3] = (V[u*3] + V[v*3]) / 2;
    V[u*3+1] = (V[u*3+1] + V[v*3+1]) / 2;
    V[u*3+2] = (V[u*3+2] + V[v*3+2]) / 2;
    Q[u].add(Q[v]);
    parent[v] = u;
    stamp[u]++;
    live_faces -= 2;  // approximation; exact recount below periodically
    // push fresh edges around u from incident faces (linear scan batched)
    if ((stamp[u] & 7) == 0) count_live();
    for (int fi = 0; fi < nf; fi++) {
      if (face_dead[fi]) continue;
      int a = find(F[fi*3]), b = find(F[fi*3+1]), cc = find(F[fi*3+2]);
      if (a == u || b == u || cc == u) {
        if (a != b) push_edge(a, b);
        if (b != cc) push_edge(b, cc);
        if (cc != a) push_edge(cc, a);
      }
    }
  }
  count_live();

  // compact
  std::vector<int> remap(nv, -1);
  int nv_out = 0;
  for (int fi = 0; fi < nf; fi++) {
    if (face_dead[fi]) continue;
    for (int k = 0; k < 3; k++) {
      int r = find(F[fi*3+k]);
      if (remap[r] < 0) {
        remap[r] = nv_out;
        verts_out[nv_out*3] = (float)V[r*3];
        verts_out[nv_out*3+1] = (float)V[r*3+1];
        verts_out[nv_out*3+2] = (float)V[r*3+2];
        nv_out++;
      }
    }
  }
  int nf_out = 0;
  for (int fi = 0; fi < nf; fi++) {
    if (face_dead[fi]) continue;
    faces_out[nf_out*3] = remap[find(F[fi*3])];
    faces_out[nf_out*3+1] = remap[find(F[fi*3+1])];
    faces_out[nf_out*3+2] = remap[find(F[fi*3+2])];
    nf_out++;
  }
  *out_nv = nv_out;
  return nf_out;
}

// ---------------------------------------------------------------------------
// Fast OBJ parse: counts then fills preallocated buffers.
// Returns 0 on success.
// ---------------------------------------------------------------------------
int obj_count(const char* path, int* nv, int* nf) {
  FILE* fp = std::fopen(path, "r");
  if (!fp) return 1;
  char line[512];
  *nv = 0; *nf = 0;
  while (std::fgets(line, sizeof(line), fp)) {
    if (line[0] == 'v' && line[1] == ' ') (*nv)++;
    else if (line[0] == 'f' && line[1] == ' ') {
      int corners = 0;
      char* p = line + 2;
      while (*p && *p != '\n' && *p != '\r') {
        while (*p == ' ') p++;
        if (*p && *p != '\n' && *p != '\r') {
          corners++;
          while (*p && *p != ' ' && *p != '\n' && *p != '\r') p++;
        }
      }
      *nf += std::max(0, corners - 2);  // fan triangulation
    }
  }
  std::fclose(fp);
  return 0;
}

int obj_parse(const char* path, float* verts, int32_t* faces) {
  FILE* fp = std::fopen(path, "r");
  if (!fp) return 1;
  char line[512];
  int vi = 0, fi = 0;
  while (std::fgets(line, sizeof(line), fp)) {
    if (line[0] == 'v' && line[1] == ' ') {
      float x, y, z;
      if (std::sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
        verts[vi*3] = x; verts[vi*3+1] = y; verts[vi*3+2] = z; vi++;
      }
    } else if (line[0] == 'f' && line[1] == ' ') {
      int idx[64], n = 0;
      char* p = line + 2;
      while (*p && n < 64) {
        while (*p == ' ') p++;
        if (!*p || *p == '\n' || *p == '\r') break;
        idx[n++] = std::atoi(p) - 1;
        while (*p && *p != ' ' && *p != '\n') p++;
      }
      for (int k = 1; k + 1 < n; k++) {
        faces[fi*3] = idx[0]; faces[fi*3+1] = idx[k]; faces[fi*3+2] = idx[k+1];
        fi++;
      }
    }
  }
  std::fclose(fp);
  return 0;
}

// ---------------------------------------------------------------------------
// Hard z-buffer Phong rasterizer for host-side visualization.
//
// Native equivalent of render/rasterizer.py::rasterize_hard (which itself
// replaces the reference's pytorch3d eval renders, homan/viz/renderot.py:
// 71-106), one frame on the host. viz/render_viz.py renders through
// rasterize_hard on the caller's device; this function is held against it
// in the tests.
// Projection/shading conventions match rasterize_hard exactly: normalized
// intrinsics, pixel centers at (i + 0.5)/S, two-sided lighting, perspective
// -correct barycentric Phong with a Blinn-Phong specular.
// ---------------------------------------------------------------------------
void raster_phong(const float* verts, int nv, const int32_t* faces, int nf,
                  const float* K, const float* face_colors, int S,
                  float znear, const float* light_dir, float ambient,
                  float diffuse, float specular, float shininess,
                  float background, int phong,
                  float* rgb, float* depth_out, uint8_t* sil) {
  const float eps = 1e-9f;
  // Project: uv = (K v)_{xy} / max((K v)_z, eps) in [0,1]; px = uv*S - 0.5.
  std::vector<float> px(nv), py(nv), pz(nv);
  for (int i = 0; i < nv; i++) {
    const float* v = verts + 3 * i;
    float p0 = K[0] * v[0] + K[1] * v[1] + K[2] * v[2];
    float p1 = K[3] * v[0] + K[4] * v[1] + K[5] * v[2];
    float p2 = K[6] * v[0] + K[7] * v[1] + K[8] * v[2];
    float w = p2 > eps ? p2 : eps;
    px[i] = (p0 / w) * S - 0.5f;
    py[i] = (p1 / w) * S - 0.5f;
    pz[i] = v[2];
  }
  // Face normals (3D) + flat shade; area-weighted vertex normals.
  std::vector<float> fnorm(3 * nf), fshade(nf);
  std::vector<float> vnorm(3 * nv, 0.0f);
  float lx = light_dir[0], ly = light_dir[1], lz = light_dir[2];
  {
    float ln = std::sqrt(lx * lx + ly * ly + lz * lz);
    if (ln < eps) ln = 1.0f;
    lx /= ln; ly /= ln; lz /= ln;
  }
  for (int f = 0; f < nf; f++) {
    const int32_t* id = faces + 3 * f;
    const float* a = verts + 3 * id[0];
    const float* b = verts + 3 * id[1];
    const float* c = verts + 3 * id[2];
    float e1[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
    float e2[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
    float n[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                  e1[2] * e2[0] - e1[0] * e2[2],
                  e1[0] * e2[1] - e1[1] * e2[0]};
    float nn = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    float inv = nn > 1e-9f ? 1.0f / nn : 0.0f;
    fnorm[3 * f] = n[0] * inv;
    fnorm[3 * f + 1] = n[1] * inv;
    fnorm[3 * f + 2] = n[2] * inv;
    fshade[f] = ambient + diffuse * std::fabs(fnorm[3 * f] * lx +
                                              fnorm[3 * f + 1] * ly +
                                              fnorm[3 * f + 2] * lz);
    // Accumulate RAW cross products: |n| = 2x face area, so vertex
    // normals are area-weighted (matches rasterize_hard / pytorch3d).
    for (int ci = 0; ci < 3; ci++)
      for (int d = 0; d < 3; d++) vnorm[3 * id[ci] + d] += n[d];
  }
  for (int i = 0; i < nv; i++) {
    float nn = std::sqrt(vnorm[3 * i] * vnorm[3 * i] +
                         vnorm[3 * i + 1] * vnorm[3 * i + 1] +
                         vnorm[3 * i + 2] * vnorm[3 * i + 2]);
    float inv = nn > 1e-9f ? 1.0f / nn : 0.0f;
    for (int d = 0; d < 3; d++) vnorm[3 * i + d] *= inv;
  }
  // Z-buffer fill: winning face id per pixel.
  std::vector<int32_t> fid(S * S, -1);
  std::vector<float> zbuf(S * S, 1e6f);
  for (int f = 0; f < nf; f++) {
    const int32_t* id = faces + 3 * f;
    float z0 = pz[id[0]], z1 = pz[id[1]], z2 = pz[id[2]];
    if (!(z0 > znear && z1 > znear && z2 > znear)) continue;
    float ax = px[id[0]], ay = py[id[0]];
    float bx = px[id[1]], by = py[id[1]];
    float cx = px[id[2]], cy = py[id[2]];
    float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
    if (std::fabs(area) < 1e-12f) continue;
    int x0 = std::max(0, (int)std::floor(std::min({ax, bx, cx})));
    int x1 = std::min(S - 1, (int)std::ceil(std::max({ax, bx, cx})));
    int y0 = std::max(0, (int)std::floor(std::min({ay, by, cy})));
    int y1 = std::min(S - 1, (int)std::ceil(std::max({ay, by, cy})));
    if (x0 > x1 || y0 > y1) continue;
    float inv_area = 1.0f / area;
    float iz0 = 1.0f / std::max(z0, 1e-6f);
    float iz1 = 1.0f / std::max(z1, 1e-6f);
    float iz2 = 1.0f / std::max(z2, 1e-6f);
    for (int y = y0; y <= y1; y++) {
      for (int x = x0; x <= x1; x++) {
        float e0 = (cx - bx) * (y - by) - (cy - by) * (x - bx);
        float e1_ = (ax - cx) * (y - cy) - (ay - cy) * (x - cx);
        float e2_ = (bx - ax) * (y - ay) - (by - ay) * (x - ax);
        bool in = (e0 >= 0 && e1_ >= 0 && e2_ >= 0) ||
                  (e0 <= 0 && e1_ <= 0 && e2_ <= 0);
        if (!in) continue;
        float w0 = e0 * inv_area, w1 = e1_ * inv_area, w2 = e2_ * inv_area;
        float inv_z = w0 * iz0 + w1 * iz1 + w2 * iz2;
        float z = 1.0f / std::max(inv_z, 1e-6f);
        int p = y * S + x;
        if (z < zbuf[p]) { zbuf[p] = z; fid[p] = f; }
      }
    }
  }
  // Shading pass.
  for (int p = 0; p < S * S; p++) {
    int f = fid[p];
    if (f < 0) {
      rgb[3 * p] = rgb[3 * p + 1] = rgb[3 * p + 2] = background;
      depth_out[p] = 0.0f;
      sil[p] = 0;
      continue;
    }
    depth_out[p] = zbuf[p];
    sil[p] = 1;
    const int32_t* id = faces + 3 * f;
    float fr = 1.0f, fg = 1.0f, fb = 1.0f;
    if (face_colors) {
      fr = face_colors[3 * f];
      fg = face_colors[3 * f + 1];
      fb = face_colors[3 * f + 2];
    }
    if (!phong) {
      float s = fshade[f];
      rgb[3 * p] = std::min(1.0f, std::max(0.0f, fr * s));
      rgb[3 * p + 1] = std::min(1.0f, std::max(0.0f, fg * s));
      rgb[3 * p + 2] = std::min(1.0f, std::max(0.0f, fb * s));
      continue;
    }
    int x = p % S, y = p / S;
    float ax = px[id[0]], ay = py[id[0]];
    float bx = px[id[1]], by = py[id[1]];
    float cx = px[id[2]], cy = py[id[2]];
    float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
    float inv_area = std::fabs(area) > 1e-12f ? 1.0f / area : 1.0f;
    float e0 = (cx - bx) * (y - by) - (cy - by) * (x - bx);
    float e1_ = (ax - cx) * (y - cy) - (ay - cy) * (x - cx);
    float e2_ = (bx - ax) * (y - ay) - (by - ay) * (x - ax);
    // Perspective-correct barycentrics: screen bary / z, renormalized.
    float bar[3] = {e0 * inv_area / std::max(pz[id[0]], 1e-6f),
                    e1_ * inv_area / std::max(pz[id[1]], 1e-6f),
                    e2_ * inv_area / std::max(pz[id[2]], 1e-6f)};
    float bs = bar[0] + bar[1] + bar[2];
    bs = std::fabs(bs) > 1e-9f ? 1.0f / bs : 0.0f;
    bar[0] *= bs; bar[1] *= bs; bar[2] *= bs;
    float n[3] = {0, 0, 0}, p3[3] = {0, 0, 0};
    for (int ci = 0; ci < 3; ci++) {
      for (int d = 0; d < 3; d++) {
        n[d] += bar[ci] * vnorm[3 * id[ci] + d];
        p3[d] += bar[ci] * verts[3 * id[ci] + d];
      }
    }
    float nn = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    float ninv = nn > 1e-9f ? 1.0f / nn : 0.0f;
    n[0] *= ninv; n[1] *= ninv; n[2] *= ninv;
    float pn = std::sqrt(p3[0] * p3[0] + p3[1] * p3[1] + p3[2] * p3[2]);
    float pinv = pn > 1e-9f ? 1.0f / pn : 0.0f;
    float vx = -p3[0] * pinv, vy = -p3[1] * pinv, vz = -p3[2] * pinv;
    float hx = lx + vx, hy = ly + vy, hz = lz + vz;
    float hn = std::sqrt(hx * hx + hy * hy + hz * hz);
    float hinv = hn > 1e-9f ? 1.0f / hn : 0.0f;
    hx *= hinv; hy *= hinv; hz *= hinv;
    float lam = ambient + diffuse * std::fabs(n[0] * lx + n[1] * ly +
                                              n[2] * lz);
    float spec = specular * std::pow(
        std::fabs(n[0] * hx + n[1] * hy + n[2] * hz), shininess);
    rgb[3 * p] = std::min(1.0f, std::max(0.0f, fr * lam + spec));
    rgb[3 * p + 1] = std::min(1.0f, std::max(0.0f, fg * lam + spec));
    rgb[3 * p + 2] = std::min(1.0f, std::max(0.0f, fb * lam + spec));
  }
}

}  // extern "C"
