// Mesh -> interior-clamped SDF on a G^3 grid, for Hopper (sm_90a).
//
// Replaces the TPU kernel _voxelize_kernel (homan_tpu/interactions/
// pallas_sdf.py:35). Forward only: the grids carry no gradient. The plain
// PyTorch version is interactions/sdf.py voxelize_interior_sdf.
//
//   phi(p) = sqrt(max(min_f d2(p, f), 1e-20)) where the +z ray from p
//            crosses the mesh an odd number of times, else 0;
//   grid points p = cell centres -1 + (2i + 1)/G, linear index
//   (ix, iy, iz) with iz fastest.
//
// What bounds it. The dense form evaluates every (point, triangle) pair:
// ~104 fp32 operations each, against 4 bytes of output per point. Two
// facts cut that work: the crossing test depends only on the point's xy
// column (all G points of a column share it), and a point outside the
// mesh is written as 0 whatever its distance. So the work these inputs
// need is the crossing test per (column, triangle) plus the distance per
// (INSIDE point, triangle); the distance dominates, and the kernel is
// bound by fp32 instruction throughput on the inside points.
//
// Design. One block of 256 threads per 512 consecutive grid points of one
// frame, grid (G^3 / 512, B): 512 / G whole columns at G <= 64, a segment
// of one column at G >= 128 (G 16 to 1,024, the JAX launcher's range).
//  1. Parity per column. Each warp owns the 64 consecutive points
//     warp * 64 .. + 63 of its block: 64 / G whole columns at G <= 64,
//     the z cells z0 .. z0 + 63 of one column at G >= 128 (its warps
//     then test the same triangles against the same column: the crossing
//     test is ~1/16 of the distance work at a tenth inside, so the
//     repeat costs a few per cent and keeps every count in registers, two
//     a lane, at any G). Lane j tests
//     triangles j, j + 32, ... (read from global memory, L1-resident)
//     against each of its columns: the three xy edge functions, inside_xy,
//     area2 and its |.| > 1e-12 test and z_tri, in the plain version's
//     expressions and order (built with -fmad=false), so the inside sets
//     agree bit for bit. __ballot_sync gives the lanes that hit; for each
//     set bit __shfl_sync broadcasts that lane's z_tri and every lane adds
//     z_tri > pz for the z cells it owns (iz = z0 + lane + 32 k). A count
//     is an integer, so the order does not matter, and no hit list can
//     overflow. At G 16 lanes 16-31 own no cell (they still test
//     triangles); at G >= 64 each lane owns two cells of one column.
//  2. Compaction. Odd counts are the inside points: each warp appends its
//     inside points to a shared list (ballot, popc prefix, one shared
//     atomicAdd per warp) and writes 0 for its outside points. A block
//     with no inside point is done.
//  3. Distance, inside points only. The block's n points are spread over
//     its 256 threads: n >= 256 gives each thread P = ceil(n / 256) <= 2
//     points (register blocking: each staged triangle's terms serve both);
//     n < 256 gives each point S = min(32, 2^floor(log2(256 / n))) lanes
//     of one warp, each sweeping every S-th triangle, then a min over the
//     S lanes by __shfl_xor_sync (fminf is exact, so the result does not
//     depend on the split or on the order of the list). Triangles are
//     staged 128 at a time: the valid ones (row 9 > 0.5) are compacted in
//     order into shared memory with their point-independent terms
//     (edges, |ab|^2, |ac|^2, |cb|^2 and reciprocals, the normal and
//     1/|n|^2, the plane flag): six float4 per triangle, read as
//     broadcasts. Padding slots cost nothing.
//  4. Distance arithmetic: the region test of Ericson's dot-product form
//     (Real-Time Collision Detection 5.1.5), as the TPU kernel restructured
//     it (d1, d2 and single subtractions give the six dots and va, vb, vc;
//     per-triangle reciprocals replace every divide), with each clamped
//     edge distance taken as |ap - t e|^2 as in the plain version: the
//     TPU kernel's apap - (2d - u) u / |e|^2 cancels near the surface
//     (1.8e-5 from the plain version at G 64 on the hand, against the
//     1e-5 band). Explicit __fmaf_rn where a*b+c contracts: the global
//     flag stays -fmad=false for the exact parity, and the distance is
//     held to its plain version by the band, not bit for bit. Degenerate
//     faces take the edge branch.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPoints = 512;  // grid points per block
constexpr int kTile = 128;    // triangles staged per pass
constexpr int kMaxPerThread = kPoints / kThreads;

// Per-triangle terms of the distance, six float4 each:
//   q0 (ax, ay, az, |ab|^2)   q1 (abx, aby, abz, |ac|^2)
//   q2 (acx, acy, acz, ab.ac) q3 (nx, ny, nz, 1/|n|^2)
//   q4 (1/|ab|^2, 1/|ac|^2, 1/|cb|^2, |cb|^2) q5 (cbx, cby, cbz, plane flag)
struct Tri {
  float4 q[6];
};

__device__ __forceinline__ float dot3(float ux, float uy, float uz, float vx,
                                      float vy, float vz) {
  return __fmaf_rn(uz, vz, __fmaf_rn(uy, vy, ux * vx));
}

// |w|^2 of w = v - t e, the offset from the closest point of an edge.
__device__ __forceinline__ float edge_d2(float t, float vx, float vy,
                                         float vz, float ex, float ey,
                                         float ez) {
  const float wx = __fmaf_rn(-t, ex, vx);
  const float wy = __fmaf_rn(-t, ey, vy);
  const float wz = __fmaf_rn(-t, ez, vz);
  return dot3(wx, wy, wz, wx, wy, wz);
}

__device__ __forceinline__ float tri_dist2(const Tri& t, float px, float py,
                                           float pz) {
  const float apx = px - t.q[0].x;
  const float apy = py - t.q[0].y;
  const float apz = pz - t.q[0].z;
  const float abx = t.q[1].x, aby = t.q[1].y, abz = t.q[1].z;
  const float acx = t.q[2].x, acy = t.q[2].y, acz = t.q[2].z;
  const float abab = t.q[0].w, acac = t.q[1].w, acab = t.q[2].w;
  const float d1 = dot3(abx, aby, abz, apx, apy, apz);  // ab . ap
  const float d2 = dot3(acx, acy, acz, apx, apy, apz);  // ac . ap
  const float d3 = d1 - abab;  // ab . bp
  const float d4 = d2 - acab;  // ac . bp
  const float d5 = d1 - acab;  // ab . cp
  const float d6 = d2 - acac;  // ac . cp
  const float va = __fmaf_rn(d3, d6, -(d5 * d4));
  const float vb = __fmaf_rn(d5, d2, -(d1 * d6));
  const float vc = __fmaf_rn(d1, d4, -(d3 * d2));
  // The clamped edge distances as |p - closest point|^2, the plain
  // version's form: apap - (2d - u) u / |e|^2 would cancel near the
  // surface, where sqrt magnifies an absolute error of d2.
  const float dab = edge_d2(fminf(fmaxf(d1, 0.0f), abab) * t.q[4].x, apx,
                            apy, apz, abx, aby, abz);
  const float dac = edge_d2(fminf(fmaxf(d2, 0.0f), acac) * t.q[4].y, apx,
                            apy, apz, acx, acy, acz);
  const float e = d4 - d3;  // (c-b) . bp
  const float dbc = edge_d2(fminf(fmaxf(e, 0.0f), t.q[4].w) * t.q[4].z,
                            apx - abx, apy - aby, apz - abz, t.q[5].x,
                            t.q[5].y, t.q[5].z);
  const float edge = fminf(dab, fminf(dac, dbc));
  const bool inside_face = (va >= 0.0f) && (vb >= 0.0f) && (vc >= 0.0f) &&
                           (t.q[5].w > 0.5f);
  const float dplane = dot3(apx, apy, apz, t.q[3].x, t.q[3].y, t.q[3].z);
  const float plane_d2 = dplane * dplane * t.q[3].w;
  return inside_face ? plane_d2 : edge;
}

// Stage triangles [base, base + kTile) of `pack`: the valid ones, in
// order, into s_tri[0, n); returns n. Every thread of the block calls it.
__device__ int stage_tile(const float* __restrict__ pack, int fpad, int base,
                          Tri* s_tri, int* s_wcount) {
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  constexpr int kStageWarps = kTile / 32;
  bool valid = false;
  Tri tri;
  if (t < kTile) {
    const int f = base + t;
    valid = pack[9 * fpad + f] > 0.5f;
    const float ax = pack[0 * fpad + f], ay = pack[1 * fpad + f];
    const float az = pack[2 * fpad + f], bx = pack[3 * fpad + f];
    const float by = pack[4 * fpad + f], bz = pack[5 * fpad + f];
    const float cx = pack[6 * fpad + f], cy = pack[7 * fpad + f];
    const float cz = pack[8 * fpad + f];
    const float abx = bx - ax, aby = by - ay, abz = bz - az;
    const float acx = cx - ax, acy = cy - ay, acz = cz - az;
    const float abab = abx * abx + aby * aby + abz * abz;
    const float acac = acx * acx + acy * acy + acz * acz;
    const float acab = abx * acx + aby * acy + abz * acz;
    const float cbcb = fmaxf(abab + acac - 2.0f * acab, 1e-12f);
    const float nx = aby * acz - abz * acy;
    const float ny = abz * acx - abx * acz;
    const float nz = abx * acy - aby * acx;
    const float nn_raw = nx * nx + ny * ny + nz * nz;
    tri.q[0] = make_float4(ax, ay, az, abab);
    tri.q[1] = make_float4(abx, aby, abz, acac);
    tri.q[2] = make_float4(acx, acy, acz, acab);
    tri.q[3] = make_float4(nx, ny, nz, 1.0f / fmaxf(nn_raw, 1e-18f));
    tri.q[4] = make_float4(1.0f / fmaxf(abab, 1e-12f),
                           1.0f / fmaxf(acac, 1e-12f), 1.0f / cbcb, cbcb);
    // Degenerate (zero-area) faces must take the edge branch: their plane
    // distance is identically 0.
    tri.q[5] = make_float4(cx - bx, cy - by, cz - bz,
                           nn_raw > 1e-18f ? 1.0f : 0.0f);
  }
  const unsigned m = __ballot_sync(0xffffffffu, valid);
  if (lane == 0 && warp < kStageWarps) s_wcount[warp] = __popc(m);
  __syncthreads();
  int offset = 0, n = 0;
  for (int w = 0; w < kStageWarps; ++w) {
    offset += w < warp ? s_wcount[w] : 0;
    n += s_wcount[w];
  }
  if (valid) s_tri[offset + __popc(m & ((1u << lane) - 1u))] = tri;
  __syncthreads();
  return n;
}

// The distance sweep of P points per thread, each thread taking every
// S-th staged triangle from `split` on.
// A thread with no point (active false) only helps to stage.
template <int P>
__device__ void sweep(const float* __restrict__ pack, int fpad,
                      const float (&px)[P], const float (&py)[P],
                      const float (&pz)[P], float (&d2min)[P], int S,
                      int split, bool active, Tri* s_tri, int* s_wcount) {
  for (int base = 0; base < fpad; base += kTile) {
    const int n = stage_tile(pack, fpad, base, s_tri, s_wcount);
    for (int j = active ? split : n; j < n; j += S) {
      const Tri t = s_tri[j];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        d2min[q] = fminf(d2min[q], tri_dist2(t, px[q], py[q], pz[q]));
      }
    }
    __syncthreads();  // every thread is done with s_tri
  }
}

__device__ __forceinline__ float cell(int i, float fg) {
  return -1.0f + (2.0f * (float)i + 1.0f) / fg;
}

template <int G>
__global__ void __launch_bounds__(kThreads)
voxelize_kernel(const float* __restrict__ tri_pack, float* __restrict__ phi,
                int fpad, float big) {
  constexpr int kWarpPoints = kPoints / kWarps;  // 64 points per warp
  // Columns per warp, and the z cells of a column a warp owns.
  constexpr int kColsPerWarp = G <= kWarpPoints ? kWarpPoints / G : 1;
  constexpr int kSpan = G <= kWarpPoints ? G : kWarpPoints;
  constexpr int kCells = kSpan >= 32 ? kSpan / 32 : 1;  // z cells per lane
  __shared__ Tri s_tri[kTile];
  __shared__ int s_list[kPoints];
  __shared__ int s_wcount[kWarps];
  __shared__ int s_n;

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float fg = (float)G;
  const float* pack = tri_pack + (size_t)b * 16 * fpad;
  const size_t out0 = (size_t)b * G * G * G + (size_t)blockIdx.x * kPoints;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();

  // 1. Crossing parity per column. The warp's first point, in the frame's
  // linear order, starts its first column (G <= 64) or its segment.
  const int first = blockIdx.x * kPoints + warp * kWarpPoints;
  const int z0 = first % G;  // 0 at G <= 64
  float cpx[kColsPerWarp], cpy[kColsPerWarp];
  int count[kColsPerWarp][kCells];
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c) {
    const int col = first / G + c;
    cpx[c] = cell(col / G, fg);
    cpy[c] = cell(col % G, fg);
#pragma unroll
    for (int k = 0; k < kCells; ++k) count[c][k] = 0;
  }
  float pz[kCells];
#pragma unroll
  for (int k = 0; k < kCells; ++k) pz[k] = cell(z0 + lane + 32 * k, fg);

  for (int f0 = 0; f0 < fpad; f0 += 32) {
    const int f = f0 + lane;  // fpad is a multiple of 128
    const bool valid = pack[9 * fpad + f] > 0.5f;
    const float ax = pack[0 * fpad + f], ay = pack[1 * fpad + f];
    const float az = pack[2 * fpad + f], bx = pack[3 * fpad + f];
    const float by = pack[4 * fpad + f], bz = pack[5 * fpad + f];
    const float cx = pack[6 * fpad + f], cy = pack[7 * fpad + f];
    const float cz = pack[8 * fpad + f];
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c) {
      // The plain version's expressions and order (sdf.py
      // _ray_z_crossings), uncontracted.
      const float px = cpx[c], py = cpy[c];
      const float e0 = (bx - ax) * (py - ay) - (by - ay) * (px - ax);
      const float e1 = (cx - bx) * (py - by) - (cy - by) * (px - bx);
      const float e2 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx);
      const bool inside_xy =
          ((e0 >= 0.0f) && (e1 >= 0.0f) && (e2 >= 0.0f)) ||
          ((e0 <= 0.0f) && (e1 <= 0.0f) && (e2 <= 0.0f));
      const float area2 = e0 + e1 + e2;
      const bool hit = valid && inside_xy && fabsf(area2) > 1e-12f;
      float z_tri = 0.0f;
      if (hit) {
        const float b0 = e1 / area2;
        const float b1 = e2 / area2;
        const float b2 = e0 / area2;
        z_tri = b0 * az + b1 * bz + b2 * cz;
      }
      unsigned hits = __ballot_sync(0xffffffffu, hit);
      while (hits) {  // warp-uniform: every lane holds the same mask
        const int src = __ffs(hits) - 1;
        hits &= hits - 1u;
        const float z = __shfl_sync(0xffffffffu, z_tri, src);
#pragma unroll
        for (int k = 0; k < kCells; ++k) count[c][k] += z > pz[k];
      }
    }
  }

  // 2. Compact the inside points; write 0 for the others.
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c) {
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const int iz = lane + 32 * k;  // within the column's segment
      const bool own = iz < kSpan;
      const int local = warp * kWarpPoints + c * G + iz;
      const bool inside = own && (count[c][k] & 1);
      const unsigned m = __ballot_sync(0xffffffffu, inside);
      int base = 0;
      if (lane == 0 && m) base = atomicAdd(&s_n, __popc(m));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (inside) {
        s_list[base + __popc(m & ((1u << lane) - 1u))] = local;
      } else if (own) {
        phi[out0 + local] = 0.0f;
      }
    }
  }
  __syncthreads();
  const int n = s_n;
  if (n == 0) return;  // block-uniform

  // 3. Distance of the inside points.
  const int t = threadIdx.x;
  if (n >= kThreads) {
    // P = 2 points per thread (n <= kPoints = 2 * kThreads); a thread
    // whose second slot is past the list repeats its first point.
    static_assert(kMaxPerThread == 2, "blocking assumes two points");
    int idx[2] = {s_list[t], s_list[t + kThreads < n ? t + kThreads : t]};
    float px[2], py[2], pz2[2], d2min[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int point = blockIdx.x * kPoints + idx[q];
      const int col = point / G;
      px[q] = cell(col / G, fg);
      py[q] = cell(col % G, fg);
      pz2[q] = cell(point % G, fg);
      d2min[q] = big;
    }
    sweep<2>(pack, fpad, px, py, pz2, d2min, 1, 0, true, s_tri, s_wcount);
    phi[out0 + idx[0]] = sqrtf(fmaxf(d2min[0], 1e-20f));
    if (t + kThreads < n) phi[out0 + idx[1]] = sqrtf(fmaxf(d2min[1], 1e-20f));
  } else {
    int S = 1;
    while (S < 32 && 2 * S * n <= kThreads) S *= 2;
    const int slot = t / S;  // groups of S lanes never straddle a warp
    const int split = t % S;
    const bool active = slot < n;
    const int idx = s_list[active ? slot : 0];
    const int point = blockIdx.x * kPoints + idx;
    const int col = point / G;
    float px[1] = {cell(col / G, fg)};
    float py[1] = {cell(col % G, fg)};
    float pz1[1] = {cell(point % G, fg)};
    float d2min[1] = {big};
    sweep<1>(pack, fpad, px, py, pz1, d2min, S, split, active, s_tri,
             s_wcount);
    float d = d2min[0];
    for (int off = S / 2; off > 0; off >>= 1) {
      d = fminf(d, __shfl_xor_sync(0xffffffffu, d, off));
    }
    if (active && split == 0) phi[out0 + idx] = sqrtf(fmaxf(d, 1e-20f));
  }
}

template <int G>
int launch(const float* tri_pack, float* phi, int B, int fpad, float big,
           cudaStream_t s) {
  const dim3 grid(G * G * G / kPoints, B);
  voxelize_kernel<G><<<grid, kThreads, 0, s>>>(tri_pack, phi, fpad, big);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes: launches on `stream` and returns
// cudaGetLastError() (0 = launched), or -1 for a grid size the kernel does
// not take (G must be a power of two from 16 to 1,024).
extern "C" int voxelize(const float* tri_pack, float* phi, int B, int G,
                        int fpad, float big, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 16: return launch<16>(tri_pack, phi, B, fpad, big, s);
    case 32: return launch<32>(tri_pack, phi, B, fpad, big, s);
    case 64: return launch<64>(tri_pack, phi, B, fpad, big, s);
    case 128: return launch<128>(tri_pack, phi, B, fpad, big, s);
    case 256: return launch<256>(tri_pack, phi, B, fpad, big, s);
    case 512: return launch<512>(tri_pack, phi, B, fpad, big, s);
    case 1024: return launch<1024>(tri_pack, phi, B, fpad, big, s);
    default: return -1;
  }
}
