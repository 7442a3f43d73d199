// Raster prep of the soft silhouette for Hopper (sm_90a): the contour
// edges, winding anchors and first-Ke tile binning of every frame, forward
// only.
//
// Replaces no TPU kernel. The JAX package builds these inputs of the shade
// kernel in XLA (homan_tpu/render/rasterizer.py `_pallas_prep`); the port
// built them in plain PyTorch, which stays as this kernel's twin
// (render/rasterizer.py `_shade_prep_plain`, the CPU path). The plain form
// sweeps every edge at every pixel row through broadcast (B, S, E) tensors
// (spans, t, x_int, the contributions, a select and a sum per tile column)
// and every edge at every tile through a (B, T, E) overlap, its int32
// cumsum and a searchsorted: some 50 GB of device traffic a fitting step
// at 960 frames of 256^2 and 1,920 edges, though 2-3% of the edges are on
// the contour and only those can add to an anchor or a bin.
//
// What bounds it. Bytes: the outputs, the anchors broadcast over each
// tile's rows (B T tp^2 floats) and the inverse map slot_of (B T E int64)
// the endpoints' backward reads, are ~90% of what it moves; the inputs
// (projected and camera-space vertices, shared topology) are read once
// and the arithmetic is a few operations per face, edge and (row, contour
// edge).
//
// Design. One block a frame, 256 threads:
//  1. slot_of is filled with Ke (not binned); the orientation of every
//     face (the sign of its projected area where its three vertices lie
//     past znear and |area| > 1e-12, else 0) goes to shared memory, one
//     byte a face.
//  2. Every edge is classified from its two faces' signs (contour: the
//     signs differ and both endpoints lie past znear), and the contour
//     edges are compacted into a shared list in edge-index order (ballot,
//     popc prefix per warp, warp counts in order): endpoints, the oriented
//     crossing sign, flip and the edge index. The list holds as many
//     entries as the frame has edges, up to what shared memory holds;
//     where E is larger the edges are walked in chunks of that many, and
//     steps 3-4 run over each chunk's list in turn.
//  3. Anchors: per pixel row and tile column, the oriented crossing signs
//     of the list entries that span the row and cross right of the
//     column's boundary, summed as an integer (the plain sum of +-1 and 0
//     floats is exact, so the order is free) into a (B, g, S) scratch.
//  4. Binning: a warp per tile walks the list 32 entries at a time in
//     order, tests each margin-widened bbox against the tile (ballot),
//     gives the first Ke overlaps their slots (popc prefix plus the
//     tile's running count in shared memory: idx, slot_of and the pack's
//     sign and flip rows) and counts every overlap into the tile's demand.
//  5. The slots' other rows (valid, far, empty idx), e_demand (the largest
//     tile demand), the counter's two counts, and anchor_px (B, T, tp, tp):
//     each row's anchor broadcast over the tile's pixels as float4 stores.
//
// Exactness. Every output equals the plain version's on the same inputs:
// its float expressions in its order, uncontracted (-fmad=false), IEEE
// division for the crossing parameter t; the row centres and tile bounds
// come from a table the wrapper computes with the plain expressions on
// the same device, and the Python scalars (znear, the margin, the column
// boundaries) are rounded to float32 once, as PyTorch rounds them when it
// compares or adds them to a float32 tensor. No float atomics; integer
// sums only.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Shared bytes of one list entry: endpoints, (crossing sign, flip), edge.
constexpr int kEntryBytes = sizeof(float4) + sizeof(float2) + sizeof(int);
constexpr int kMaxSmem = 200 * 1024;

struct Args {
  const float2* uv;            // (B, V) projected vertices
  const float* xyz;            // (B, V, 3) camera-space vertices
  const long long* faces;      // (nt, F, 3) or (F, 3)
  const long long* edges;      // (nt, E, 2) or (E, 2)
  const long long* edge_faces; // (nt, E, 2) or (E, 2), -1 = none
  const bool* edge_dir;        // (nt, E) or (E,)
  long long faces_stride, edges_stride, ef_stride, dir_stride;  // 0: shared
  const float* table;          // ys (S), tile lo (g), tile hi (g), xb (g)
  int nt, fpt, V, F, E, S, tp, g, ke, list_cap;
  float znear, margin;
  int* anchors;                // (B, g, S) scratch
  float* anchor_px;            // (B, T, tp, tp)
  long long* idx;              // (B, T, Ke)
  bool* hit;                   // (B, T, Ke)
  long long* slot_of;          // (B, T, E)
  long long* e_demand;         // (B,)
  float* pack_c;               // (B, T, 4, Ke): sign, valid, flip, 0
  float* far;                  // (B, T, Ke): 0 in a valid slot, else 99
  int* n_contour;              // (B,)
  int* n_read;                 // (B,)
};

// torch.sign: (0 < x) - (x < 0), so 0 for a zero or a NaN.
__device__ __forceinline__ float sign_of(float x) {
  return (float)((0.f < x) - (x < 0.f));
}

__global__ void __launch_bounds__(kThreads)
prep_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_wcount[kWarps];
  const int L = a.list_cap;
  float4* s_seg = reinterpret_cast<float4*>(smem);
  float2* s_cf = reinterpret_cast<float2*>(smem + (size_t)L * 16);
  int* s_e = reinterpret_cast<int*>(smem + (size_t)L * 24);
  int* s_cnt = reinterpret_cast<int*>(smem + (size_t)L * 28);
  const int T = a.g * a.g;
  signed char* s_front = reinterpret_cast<signed char*>(s_cnt + T);

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int tb = (b / a.fpt) % a.nt;
  const long long* faces = a.faces + tb * a.faces_stride;
  const long long* edges = a.edges + tb * a.edges_stride;
  const long long* ef = a.edge_faces + tb * a.ef_stride;
  const bool* edir = a.edge_dir + tb * a.dir_stride;
  const float2* uv = a.uv + (size_t)b * a.V;
  const float* xyz = a.xyz + (size_t)b * a.V * 3;
  const float* ys = a.table;
  const float* t_lo = a.table + a.S;
  const float* t_hi = t_lo + a.g;
  const float* xb = t_hi + a.g;
  const int S = a.S, g = a.g, E = a.E, ke = a.ke;

  // 1. slot_of = Ke everywhere; the binning below overwrites the binned
  // slots after the barriers of the compaction.
  long long* slot_of = a.slot_of + (size_t)b * T * E;
  for (int i = tid; i < T * E; i += kThreads) slot_of[i] = ke;
  for (int t = tid; t < T; t += kThreads) s_cnt[t] = 0;
  for (int f = tid; f < a.F; f += kThreads) {
    const long long i0 = faces[3 * f], i1 = faces[3 * f + 1],
                    i2 = faces[3 * f + 2];
    const float2 p = uv[i0], q = uv[i1], r = uv[i2];
    // _edge_fn(p, q, r) = (r - q) x (p - q), in the plain order.
    const float area = (r.x - q.x) * (p.y - q.y) - (r.y - q.y) * (p.x - q.x);
    const bool valid = xyz[3 * i0 + 2] > a.znear && xyz[3 * i1 + 2] > a.znear &&
                       xyz[3 * i2 + 2] > a.znear && fabsf(area) > 1e-12f;
    s_front[f] = valid ? (signed char)sign_of(area) : (signed char)0;
  }
  __syncthreads();

  int total = 0, padded = 0;
  for (int base = 0; base < E; base += L) {
    const int end = min(E, base + L);
    // 2. Classify this chunk's edges and compact the contour ones.
    int n = 0;
    for (int c0 = base; c0 < end; c0 += kThreads) {
      const int e = c0 + tid;
      bool contour = false;
      float4 seg = make_float4(0.f, 0.f, 0.f, 0.f);
      float2 cf = make_float2(0.f, 0.f);
      if (e < end) {
        const long long f0 = ef[2 * e], f1 = ef[2 * e + 1];
        const float o1 = f0 >= 0 ? (float)s_front[f0] : 0.f;
        const float o2 = f1 >= 0 ? (float)s_front[f1] : 0.f;
        if (o1 != o2 && (o1 != 0.f || o2 != 0.f)) {
          const long long v0 = edges[2 * e], v1 = edges[2 * e + 1];
          contour = xyz[3 * v0 + 2] > a.znear && xyz[3 * v1 + 2] > a.znear;
          const float2 p0 = uv[v0], p1 = uv[v1];
          const float flip = (edir[e] ? 1.f : -1.f) * (o1 > 0.f ? 1.f : -1.f);
          seg = make_float4(p0.x, p0.y, p1.x, p1.y);
          cf = make_float2(sign_of(p1.y - p0.y) * flip, flip);
        }
      }
      const unsigned m = __ballot_sync(0xffffffffu, contour);
      if (lane == 0) s_wcount[warp] = __popc(m);
      __syncthreads();
      int off = n, add = 0;
      for (int w = 0; w < kWarps; ++w) {
        off += w < warp ? s_wcount[w] : 0;
        add += s_wcount[w];
      }
      if (contour) {
        const int pos = off + __popc(m & lanes_below);
        s_seg[pos] = seg;
        s_cf[pos] = cf;
        s_e[pos] = e;
      }
      n += add;
      __syncthreads();
    }
    total += n;
    padded += (n + 31) / 32 * 32;  // the binning reads whole warps of them

    // 3. Anchors of this chunk: (row, column) items, rows fastest.
    for (int item = tid; item < S * g; item += kThreads) {
      const int gc = item / S, row = item - gc * S;
      const float py = ys[row], bound = xb[gc];
      int acc = 0;
      for (int j = 0; j < n; ++j) {
        const float4 s = s_seg[j];
        if ((s.y <= py) == (s.w <= py)) continue;
        const float dy = s.w - s.y;
        const float t = (py - s.y) / (fabsf(dy) > 1e-12f ? dy : 1.f);
        const float xi = s.x + t * (s.z - s.x);
        if (xi > bound) acc += (int)s_cf[j].x;
      }
      int* dst = a.anchors + ((size_t)b * g + gc) * S + row;
      *dst = (base == 0 ? 0 : *dst) + acc;
    }

    // 4. Binning of this chunk: a warp per tile, entries in edge order.
    for (int t = warp; t < T; t += kWarps) {
      const int gx = t % g, gy = t / g;
      const float lo_x = t_lo[gx], hi_x = t_hi[gx];
      const float lo_y = t_lo[gy], hi_y = t_hi[gy];
      const size_t slots = ((size_t)b * T + t) * ke;
      float* pc = a.pack_c + ((size_t)b * T + t) * 4 * ke;
      int cnt = s_cnt[t];
      for (int j0 = 0; j0 < n; j0 += 32) {
        const int j = j0 + lane;
        bool ov = false;
        if (j < n) {
          const float4 s = s_seg[j];
          ov = fminf(s.x, s.z) - a.margin <= hi_x &&
               fmaxf(s.x, s.z) + a.margin >= lo_x &&
               fminf(s.y, s.w) - a.margin <= hi_y &&
               fmaxf(s.y, s.w) + a.margin >= lo_y;
        }
        const unsigned m = __ballot_sync(0xffffffffu, ov);
        const int r = cnt + __popc(m & lanes_below);
        if (ov && r < ke) {
          const int e = s_e[j];
          a.idx[slots + r] = e;
          slot_of[(size_t)t * E + e] = r;
          pc[r] = s_cf[j].x;
          pc[2 * ke + r] = s_cf[j].y;
        }
        cnt += __popc(m);
      }
      if (lane == 0) s_cnt[t] = cnt;
    }
    __syncthreads();  // the next chunk overwrites the list
  }

  // 5. The slots past each tile's count, the frame's counts, anchor_px.
  for (int item = tid; item < T * ke; item += kThreads) {
    const int t = item / ke, k = item - t * ke;
    const bool h = k < min(s_cnt[t], ke);
    const size_t o = (size_t)b * T * ke + item;
    float* pc = a.pack_c + ((size_t)b * T + t) * 4 * ke + k;
    a.hit[o] = h;
    a.far[o] = h ? 0.f : 99.f;
    pc[ke] = h ? 1.f : 0.f;
    pc[3 * ke] = 0.f;
    if (!h) {
      a.idx[o] = E - 1;
      pc[0] = 0.f;
      pc[2 * ke] = 0.f;
    }
  }
  if (warp == 0) {
    int most = 0;
    for (int t = lane; t < T; t += 32) most = max(most, s_cnt[t]);
    for (int d = 16; d > 0; d >>= 1)
      most = max(most, __shfl_xor_sync(0xffffffffu, most, d));
    if (lane == 0) {
      a.e_demand[b] = most;
      a.n_contour[b] = total;
      a.n_read[b] = padded;
    }
  }
  const int tp = a.tp, tile_px = tp * tp;
  const int* anc = a.anchors + (size_t)b * g * S;
  float* out = a.anchor_px + (size_t)b * T * tile_px;
  if (tp % 4 == 0) {
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int q = tid; q < T * tile_px / 4; q += kThreads) {
      const int p = 4 * q, t = p / tile_px, r = (p - t * tile_px) / tp;
      const float v = (float)anc[(t % g) * S + (t / g) * tp + r];
      out4[q] = make_float4(v, v, v, v);
    }
  } else {
    for (int p = tid; p < T * tile_px; p += kThreads) {
      const int t = p / tile_px, r = (p - t * tile_px) / tp;
      out[p] = (float)anc[(t % g) * S + (t / g) * tp + r];
    }
  }
}

}  // namespace

// Shared bytes of a launch over E edges, F faces and T tiles whose list
// holds `list_cap` entries.
static size_t prep_smem(int list_cap, int T, int F) {
  return (size_t)list_cap * kEntryBytes + (size_t)T * 4 + (size_t)F;
}

// The list's entries a launch takes: E rounded up to a whole pass of the
// block's threads, or as many whole passes as shared memory holds; 0 where
// not one pass fits beside the faces' signs and the tiles' counts.
extern "C" int shade_prep_list_cap(int E, int T, int F) {
  const int want = (E + kThreads - 1) / kThreads * kThreads;
  long long room = (long long)kMaxSmem - (long long)T * 4 - F;
  const long long fit = room < 0 ? 0 : room / kEntryBytes / kThreads * kThreads;
  return (int)(want < fit ? want : fit);
}

// C interface, loaded with ctypes: launches one block per frame on
// `stream` and returns cudaGetLastError() (0 = launched), or -1 where the
// faces' signs and the tiles' counts leave no room for a list in shared
// memory. Topology tensors with a stride of 0 are shared by every frame;
// otherwise frame b uses topology (b / fpt) % nt.
extern "C" int shade_prep(
    const float* uv, const float* xyz, const long long* faces,
    const long long* edges, const long long* edge_faces, const bool* edge_dir,
    long long faces_stride, long long edges_stride, long long ef_stride,
    long long dir_stride, const float* table, int B, int nt, int fpt, int V,
    int F, int E, int S, int tp, int ke, float znear, float margin,
    int* anchors, float* anchor_px, long long* e_demand, long long* idx,
    bool* hit, long long* slot_of, float* pack_c, float* far, int* n_contour,
    int* n_read, void* stream) {
  const int g = S / tp, T = g * g;
  const int list_cap = shade_prep_list_cap(E, T, F);
  if (list_cap <= 0) return -1;
  const size_t smem = prep_smem(list_cap, T, F);
  // Raise the dynamic shared-memory limit only when a launch needs more
  // than it was given (render/csrc/shade.cu launch_fwd does the same).
  static size_t limit = 48 * 1024;
  if (smem > limit) {
    const cudaError_t err = cudaFuncSetAttribute(
        prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    limit = smem;
  }
  Args a;
  a.uv = reinterpret_cast<const float2*>(uv);
  a.xyz = xyz;
  a.faces = faces;
  a.edges = edges;
  a.edge_faces = edge_faces;
  a.edge_dir = edge_dir;
  a.faces_stride = faces_stride;
  a.edges_stride = edges_stride;
  a.ef_stride = ef_stride;
  a.dir_stride = dir_stride;
  a.table = table;
  a.nt = nt;
  a.fpt = fpt;
  a.V = V;
  a.F = F;
  a.E = E;
  a.S = S;
  a.tp = tp;
  a.g = g;
  a.ke = ke;
  a.list_cap = list_cap;
  a.znear = znear;
  a.margin = margin;
  a.anchors = anchors;
  a.anchor_px = anchor_px;
  a.idx = idx;
  a.hit = hit;
  a.slot_of = slot_of;
  a.e_demand = e_demand;
  a.pack_c = pack_c;
  a.far = far;
  a.n_contour = n_contour;
  a.n_read = n_read;
  prep_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
