// Hard z-buffer depth tiles for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernels _depth_fwd_kernel (homan_tpu/render/
// pallas_depth.py:56) and _depth_bwd_kernel (:180). The plain PyTorch
// versions in render/depth.py compute the same expressions in the same
// order; render/depth.py documents the math and replays the forward's cull
// on the host (`fwd_work`).
//
// What bounds the forward. Per pixel and valid slot the z-buffer does ~22
// fp32 operations, but a face's edge lines hold (e_i >= 0) over a few dozen
// of a 64^2 tile's 4,096 pixels, and the busy tiles of a frame hold ~1,000
// faces while most tiles hold none. So the work is set by how few (pixel,
// slot) pairs a kernel can prove empty, and its time by the busiest tiles.
//
// Forward design.
//  * A block owns a 16 x 16 region of one tile; a warp owns an 8 x 8
//    sub-tile of it, 2 adjacent pixels of one row per lane. Grid
//    (ceil(tp/16)^2, T, B), 128 threads: a busy 64^2 tile
//    spreads over 16 blocks, which the scheduler places on many SMs (at
//    R = 32 the busy tiles' warps crowded fewer SMs and the forward took
//    1.2x as long; 16 x 16 sub-tiles at 8 pixels a lane, 1.7-2.2x:
//    PERF.md).
//  * The block stages its tile's valid slots (a prefix, from the binning)
//    one per thread per pass, and keeps a slot only if it can be inside
//    somewhere in the block's region; a warp then keeps, from the staged
//    slots, those that can be inside somewhere in its sub-tile. Both tests
//    are exact culls: skip a slot only when some edge is negative at every
//    pixel centre of the box as the kernel rounds it. e is linear, so its
//    largest value over the box is at a corner centre; the rounded e at any
//    pixel lies within 6.1 u (|a| + |b| + |c|) of the exact one (u = 2^-24,
//    three roundings, pixel coordinates in (0, 1)), so a slot whose rounded
//    corner maximum plus the slack (|a| + |b| + |c|) 2^-20 is negative can
//    never pass `e >= 0` at any pixel of the box.
//  * Survivors are compacted with __ballot_sync / __popc in ascending slot
//    order, at both levels, so each pixel still scans its candidates in
//    slot order with strict `>` from best = 0: the lowest slot wins a tie,
//    and amax is the slot's index in the tile. A culled slot is never
//    inside, so the outputs are bit-identical to the plain version's.
//  * Register blocking: a lane reads a slot's 12 coefficients once, as
//    three float4 broadcasts from shared memory, for all its pixels.
//  * A pass loads the next pass's slots before it culls and scans its own,
//    so the loads' latency hides behind that work. A tile whose slot 0 is
//    not valid is empty: its blocks write 0 and -1 and leave.
//  * Any tile width. A tile that is not a multiple of 16 runs a second
//    instantiation (kRagged): the regions and sub-tiles at its edge cover
//    only the pixels inside it. Their cull boxes are clamped to those
//    pixels (so they stay conservative and cull no less), a sub-tile
//    wholly outside culls and scans nothing, and a lane stores only its
//    pixels inside the tile, by scalars (a row is not 8-byte aligned when
//    tp is odd). The per-pixel scan is unchanged, so the outputs stay
//    bit-equal to the plain version's.
//
// Backward design.
//  * Bound: bytes. ~6 operations per pixel against 12 bytes read per pixel
//    and the (B, T, 16, Kf) gpack written; ~98% of the depth fit's pixels
//    are uncovered, so writing gpack is most of the work.
//  * A deterministic segmented reduction in two launches, no float atomics.
//    The first, per 256-pixel chunk: each warp walks the DISTINCT winning
//    slots of its 32 pixels in ascending order (__reduce_min_sync) and
//    reduces each one's contributions by a shuffle tree; the first warp
//    that holds a slot sums the warps' values in warp order and writes
//    the chunk's compact list: the count, then (k, v0, v1, v2) per
//    distinct slot. Nothing is zero-filled, and no barrier is taken per
//    slot.
//  * The second runs one block per tile: it clears a 3 x Kf accumulator in
//    shared memory (in windows of kWindow slots), adds the chunks' lists in
//    chunk order (the slots of one list are distinct, so threads add
//    without conflict), and writes the tile's 16 x Kf gpack once, rows 9-11
//    from shared memory and zeros elsewhere. Each slot's sum runs
//    0 + p_0 + p_1 + ... over the chunks that hold it, which is the dense
//    per-chunk sum (a (3, Kf) partial per chunk, added in chunk order) with
//    its +0.0 terms left out; the sum starts at +0.0 and so is never -0.0,
//    so the two are bit-equal.
//  * One launch with a block per tile, walking its chunks in turn and
//    adding them in shared memory, took 1.9-2.4x as long as these two on
//    the depth fit's packs (PERF.md): a tile's chunks ran one after
//    another on one SM, where here they spread over the card.
//  * Exactness: built with -fmad=false. The `e >= 0` inside tests and the
//    strict-> argmax are exact comparisons; an FMA-contracted a*b+c would
//    flip them against the plain version, which never contracts.
#include <climits>
#include <cuda_runtime.h>

namespace {

// Forward geometry (render/depth.py FWD_SUB, FWD_REGION).
constexpr int kSub = 8;      // a warp's sub-tile side
constexpr int kPx = 2;       // adjacent pixels of one row per lane
constexpr int kRegion = 16;  // a block's region side
static_assert(kSub * kSub == 32 * kPx, "a warp covers its sub-tile");
constexpr int kLanesPerRow = kSub / kPx;
constexpr int kRegionWarps = kRegion / kSub;  // sub-tiles per region row
constexpr int kFwdWarps = kRegionWarps * kRegionWarps;
constexpr int kFwdThreads = 32 * kFwdWarps;

// Backward.
constexpr int kThreads = 256;  // pixels per chunk
constexpr int kWarps = kThreads / 32;
// One chunk's list: the count (padded to 16 bytes), then a float4
// (k as int bits, v0, v1, v2) per distinct slot.
constexpr int kListFloats = 4 + 4 * kThreads;
constexpr int kWindow = 2048;  // finalize: accumulator slots per pass
constexpr int kGroup = 8;      // finalize: chunk lists loaded together

// e = a px + b py + c may reach >= 0 somewhere in the box of pixel centres
// [x0, x1] x [y0, y1]: its rounded maximum over the four corners plus the
// slack that covers the rounding at every pixel of the box.
__device__ __forceinline__ bool edge_may_hold(float a, float b, float c,
                                              float x0, float x1, float y0,
                                              float y1) {
  const float m = fmaxf(fmaxf(a * x0 + b * y0 + c, a * x1 + b * y0 + c),
                        fmaxf(a * x0 + b * y1 + c, a * x1 + b * y1 + c));
  const float slack = (fabsf(a) + fabsf(b) + fabsf(c)) * 0x1p-20f;
  return m + slack >= 0.0f;
}

// The slot's coefficients as staged: (A0 B0 C0 A1) (B1 C1 A2 B2)
// (C2 Az Bz Cz).
__device__ __forceinline__ bool face_may_cover(const float4& a,
                                               const float4& b,
                                               const float4& c, float x0,
                                               float x1, float y0,
                                               float y1) {
  return edge_may_hold(a.x, a.y, a.z, x0, x1, y0, y1) &&
         edge_may_hold(a.w, b.x, b.y, x0, x1, y0, y1) &&
         edge_may_hold(b.z, b.w, c.x, x0, x1, y0, y1);
}

// Rows r..r+3 of slot k (k + r * kf given as `at`), or zeros.
__device__ __forceinline__ float4 load_slot(const float* pack, int kf,
                                            int at, bool load) {
  if (!load) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return make_float4(pack[at], pack[at + kf], pack[at + 2 * kf],
                     pack[at + 3 * kf]);
}

// A lane's kPx pixels: depth = 1 / max(best, 1e-9) and the winning slot
// where best > 0, else 0 and -1. kRagged: only the first n_in pixels, by
// scalars.
template <bool kRagged>
__device__ __forceinline__ void store_px(float* depth, int* amax, size_t pix,
                                         const float* best, const int* am,
                                         int n_in) {
  static_assert(kPx == 2, "a lane's pixels move as one float2 and one int2");
  float d[kPx];
  int a_out[kPx];
#pragma unroll
  for (int q = 0; q < kPx; ++q) {
    const bool covered = best[q] > 0.0f;
    d[q] = covered ? 1.0f / fmaxf(best[q], 1e-9f) : 0.0f;
    a_out[q] = covered ? am[q] : -1;
  }
  if (kRagged) {
#pragma unroll
    for (int q = 0; q < kPx; ++q) {
      if (q < n_in) {
        depth[pix + q] = d[q];
        amax[pix + q] = a_out[q];
      }
    }
    return;
  }
  *reinterpret_cast<float2*>(depth + pix) = make_float2(d[0], d[1]);
  *reinterpret_cast<int2*>(amax + pix) = make_int2(a_out[0], a_out[1]);
}

template <bool kRagged>
__global__ void __launch_bounds__(kFwdThreads)
depth_fwd_kernel(const float* __restrict__ face_pack,
                 float* __restrict__ depth, int* __restrict__ amax, int T,
                 int g, int tp, int kf, float inv_s) {
  __shared__ float4 s_slot[3][kFwdThreads];  // the staged survivors
  __shared__ int s_id[kFwdThreads];          // their slots in the tile
  __shared__ unsigned short s_list[kFwdWarps][kFwdThreads];
  __shared__ int s_count[kFwdWarps];

  const int per_row = (tp + kRegion - 1) / kRegion;
  const int t = blockIdx.y;
  const size_t tile = (size_t)blockIdx.z * T + t;
  const float* pack = face_pack + tile * 16 * kf;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rx0 = (int)(blockIdx.x % per_row) * kRegion;
  const int ry0 = (int)(blockIdx.x / per_row) * kRegion;
  const int wx0 = rx0 + (warp % kRegionWarps) * kSub;
  const int wy0 = ry0 + (warp / kRegionWarps) * kSub;

  // The last pixel of the region and of the sub-tile in each direction;
  // kRagged: clamped to the tile (a sub-tile wholly outside it has none).
  const int rx1 = kRagged ? min(rx0 + kRegion, tp) - 1 : rx0 + kRegion - 1;
  const int ry1 = kRagged ? min(ry0 + kRegion, tp) - 1 : ry0 + kRegion - 1;
  const bool sub_in = !kRagged || (wx0 < tp && wy0 < tp);  // warp-uniform
  const int wx1 = kRagged ? min(wx0 + kSub, tp) - 1 : wx0 + kSub - 1;
  const int wy1 = kRagged ? min(wy0 + kSub, tp) - 1 : wy0 + kSub - 1;

  // Pixel centres in the plain version's expressions.
  const float gx = (float)(t % g);
  const float gy = (float)(t / g);
  const float ftp = (float)tp;
  const float bx0 = (gx * ftp + (float)rx0 + 0.5f) * inv_s;
  const float bx1 = (gx * ftp + (float)rx1 + 0.5f) * inv_s;
  const float by0 = (gy * ftp + (float)ry0 + 0.5f) * inv_s;
  const float by1 = (gy * ftp + (float)ry1 + 0.5f) * inv_s;
  const float sx0 = (gx * ftp + (float)wx0 + 0.5f) * inv_s;
  const float sx1 = (gx * ftp + (float)wx1 + 0.5f) * inv_s;
  const float sy0 = (gy * ftp + (float)wy0 + 0.5f) * inv_s;
  const float sy1 = (gy * ftp + (float)wy1 + 0.5f) * inv_s;
  const int iy = wy0 + lane / kLanesPerRow;
  const int ix0 = wx0 + (lane % kLanesPerRow) * kPx;
  // kRagged: the lane's pixels inside the tile (0 to kPx).
  const int n_in = iy < tp ? max(0, min(kPx, tp - ix0)) : 0;
  const float py = (gy * ftp + (float)iy + 0.5f) * inv_s;
  float px[kPx], best[kPx];
  int am[kPx];
#pragma unroll
  for (int q = 0; q < kPx; ++q) {
    px[q] = (gx * ftp + (float)(ix0 + q) + 0.5f) * inv_s;
    best[q] = 0.0f;
    am[q] = -1;
  }
  const unsigned lanes_below = (1u << lane) - 1u;
  const size_t pix = tile * tp * tp + (size_t)iy * tp + ix0;

  // The valid slots are a prefix: a tile whose slot 0 is not valid is
  // empty.
  if (!(kf > 0 && pack[12 * kf] > 0.5f)) {  // block-uniform
    store_px<kRagged>(depth, amax, pix, best, am, n_in);
    return;
  }
  // Pass 0's slot of this thread; each pass loads the next pass's while it
  // culls and scans its own.
  int k = tid;
  bool valid = k < kf && pack[12 * kf + k] > 0.5f;
  float4 a = load_slot(pack, kf, k, valid);
  float4 b = load_slot(pack, kf, k + 4 * kf, valid);
  float4 c = load_slot(pack, kf, k + 8 * kf, valid);
  while (true) {
    // A pass that meets an invalid slot (or the end of the pack) is the
    // last.
    const bool more = __syncthreads_and(valid) != 0;
    const int kn = k + kFwdThreads;
    const bool load_next = more && kn < kf;
    const bool valid_n = load_next && pack[12 * kf + kn] > 0.5f;
    const float4 an = load_slot(pack, kf, kn, load_next);
    const float4 bn = load_slot(pack, kf, kn + 4 * kf, load_next);
    const float4 cn = load_slot(pack, kf, kn + 8 * kf, load_next);

    // Stage the slots that can be inside somewhere in the block's region.
    const bool keep = valid && face_may_cover(a, b, c, bx0, bx1, by0, by1);
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, n_staged = 0;
    for (int w = 0; w < kFwdWarps; ++w) {
      const int cnt = s_count[w];
      base += w < warp ? cnt : 0;
      n_staged += cnt;
    }
    if (keep) {
      const int j = base + __popc(ballot & lanes_below);
      s_slot[0][j] = a;
      s_slot[1][j] = b;
      s_slot[2][j] = c;
      s_id[j] = k;
    }
    __syncthreads();

    // Cull: the staged slots that can be inside in this warp's sub-tile,
    // in ascending order.
    int n_mine = 0;
    for (int j0 = 0; sub_in && j0 < n_staged; j0 += 32) {
      const int j = j0 + lane;
      const bool mine =
          j < n_staged && face_may_cover(s_slot[0][j], s_slot[1][j],
                                         s_slot[2][j], sx0, sx1, sy0, sy1);
      const unsigned m = __ballot_sync(0xffffffffu, mine);
      if (mine) s_list[warp][n_mine + __popc(m & lanes_below)] =
          (unsigned short)j;
      n_mine += __popc(m);
    }
    __syncwarp();

    // Scan the survivors for this lane's pixels.
    for (int i = 0; i < n_mine; ++i) {
      const int j = s_list[warp][i];
      const float4 f0 = s_slot[0][j];
      const float4 f1 = s_slot[1][j];
      const float4 f2 = s_slot[2][j];
      const int id = s_id[j];
#pragma unroll
      for (int q = 0; q < kPx; ++q) {
        const float e0 = f0.x * px[q] + f0.y * py + f0.z;
        const float e1 = f0.w * px[q] + f1.x * py + f1.y;
        const float e2 = f1.z * px[q] + f1.w * py + f2.x;
        const float invz = f2.y * px[q] + f2.z * py + f2.w;
        const bool inside = (e0 >= 0.0f) && (e1 >= 0.0f) && (e2 >= 0.0f);
        if (inside && invz > best[q]) {
          best[q] = invz;
          am[q] = id;
        }
      }
    }
    if (!more) break;  // block-uniform
    // The next pass's first barrier keeps its staging from overwriting
    // slots this pass still reads.
    k = kn;
    valid = valid_n;
    a = an;
    b = bn;
    c = cn;
  }
  store_px<kRagged>(depth, amax, pix, best, am, n_in);
}

__global__ void __launch_bounds__(kThreads)
depth_bwd_partial_kernel(const float* __restrict__ depth,
                         const int* __restrict__ amax,
                         const float* __restrict__ gcot,
                         float* __restrict__ lists, int T, int g, int tp,
                         float inv_s) {
  __shared__ int s_k[kWarps][32];       // a warp's distinct slots, ascending
  __shared__ float s_v[kWarps][32][3];  // and its sums for them
  __shared__ int s_n[kWarps];
  __shared__ int s_count;
  const int C = gridDim.x;
  const int chunk = blockIdx.x;
  const int t = blockIdx.y;
  const size_t tile = (size_t)blockIdx.z * T + t;
  const int P = tp * tp;
  const int p = chunk * kThreads + threadIdx.x;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  int k_px = -1;
  if (p < P) {
    const size_t pix = tile * P + p;
    const float d = depth[pix];
    const float coef = d > 0.0f ? -gcot[pix] * d * d : 0.0f;
    const float gx = (float)(t % g);
    const float gy = (float)(t / g);
    const float ftp = (float)tp;
    const float px = (gx * ftp + (float)(p % tp) + 0.5f) * inv_s;
    const float py = (gy * ftp + (float)(p / tp) + 0.5f) * inv_s;
    c0 = coef * px;
    c1 = coef * py;
    c2 = coef;
    k_px = amax[pix];
  }
  float* out = lists + (tile * C + chunk) * kListFloats;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // Each warp walks the distinct slots of its 32 pixels in ascending order
  // and reduces each one's contributions by a shuffle tree (lanes without
  // the slot add 0).
  int last = -1;  // slots <= last are done; uncovered pixels hold -1
  int n = 0;      // distinct slots of this warp so far (warp-uniform)
  while (true) {
    const int k = __reduce_min_sync(0xffffffffu,
                                    k_px > last ? k_px : INT_MAX);
    if (k == INT_MAX) break;  // warp-uniform
    last = k;
    const bool mine = (k_px == k);
    float v0 = mine ? c0 : 0.0f;
    float v1 = mine ? c1 : 0.0f;
    float v2 = mine ? c2 : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      v0 += __shfl_down_sync(0xffffffffu, v0, off);
      v1 += __shfl_down_sync(0xffffffffu, v1, off);
      v2 += __shfl_down_sync(0xffffffffu, v2, off);
    }
    if (lane == 0) {
      s_k[warp][n] = k;
      s_v[warp][n][0] = v0;
      s_v[warp][n][1] = v1;
      s_v[warp][n][2] = v2;
    }
    ++n;
  }
  if (lane == 0) s_n[warp] = n;
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();

  // The chunk's sum of slot k is 0 + (warp sums in warp order); the first
  // warp that holds k writes it. Lists are sorted, so a warp finds k by
  // binary search.
  auto find = [&](int w, int k) {
    int lo = 0, hi = s_n[w];
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_k[w][mid] < k) lo = mid + 1; else hi = mid;
    }
    return lo < s_n[w] && s_k[w][lo] == k ? lo : -1;
  };
  if (lane < n) {
    const int k = s_k[warp][lane];
    bool first = true;
    for (int w = 0; w < warp && first; ++w) first = find(w, k) < 0;
    if (first) {
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
      for (int w = warp; w < kWarps; ++w) {
        const int j = w == warp ? lane : find(w, k);
        if (j >= 0) {
          a0 += s_v[w][j][0];
          a1 += s_v[w][j][1];
          a2 += s_v[w][j][2];
        }
      }
      const int pos = atomicAdd(&s_count, 1);  // list order is free
      *reinterpret_cast<float4*>(out + 4 + 4 * pos) =
          make_float4(__int_as_float(k), a0, a1, a2);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) reinterpret_cast<int*>(out)[0] = s_count;
}

__global__ void __launch_bounds__(kThreads)
depth_bwd_finalize_kernel(const float* __restrict__ lists,
                          float* __restrict__ gpack, int C, int kf) {
  __shared__ float s_acc[3][kWindow];
  const size_t tile = blockIdx.x;
  const float* tile_lists = lists + tile * C * kListFloats;
  float* out = gpack + tile * 16 * kf;
  for (int lo = 0; lo < kf; lo += kWindow) {
    const int n = min(kWindow, kf - lo);
    // Rows 0-8 and 12-15 first: their stores overlap the lists' loads.
    for (int r = 0; r < 16; ++r) {
      if (r >= 9 && r < 12) continue;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        out[(size_t)r * kf + lo + i] = 0.0f;
      }
    }
    for (int i = threadIdx.x; i < n; i += kThreads) {
      s_acc[0][i] = 0.0f;
      s_acc[1][i] = 0.0f;
      s_acc[2][i] = 0.0f;
    }
    __syncthreads();
    // Chunk order. A list holds at most kThreads entries, so thread i adds
    // entry i; the counts and entries of kGroup chunks load together.
    for (int c0 = 0; c0 < C; c0 += kGroup) {
      int cnt[kGroup];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        cnt[q] = c0 + q < C ? reinterpret_cast<const int*>(
                                  tile_lists + (size_t)(c0 + q) *
                                                   kListFloats)[0]
                            : 0;
      }
      float4 e[kGroup];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        e[q] = threadIdx.x < cnt[q]
                   ? reinterpret_cast<const float4*>(
                         tile_lists + (size_t)(c0 + q) * kListFloats +
                         4)[threadIdx.x]
                   : make_float4(__int_as_float(-1), 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        const int k = __float_as_int(e[q].x) - lo;
        if (k >= 0 && k < n) {
          s_acc[0][k] += e[q].y;
          s_acc[1][k] += e[q].z;
          s_acc[2][k] += e[q].w;
        }
        __syncthreads();  // the next chunk may add to the same slots
      }
    }
    for (int r = 0; r < 3; ++r) {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        out[(size_t)(9 + r) * kf + lo + i] = s_acc[r][i];
      }
    }
    __syncthreads();  // the next window clears s_acc
  }
}

}  // namespace

// C interface, loaded with ctypes. Each entry point launches on `stream`
// and returns cudaGetLastError() (0 = launched).
//
// depth_fwd takes any tp > 0 (others return cudaErrorInvalidValue); kf
// slots per tile, valid slots a prefix.
extern "C" int depth_fwd(const float* face_pack, float* depth, int* amax,
                         int B, int T, int g, int tp, int kf, float inv_s,
                         void* stream) {
  if (tp <= 0) return (int)cudaErrorInvalidValue;
  const int per_row = (tp + kRegion - 1) / kRegion;
  const dim3 grid(per_row * per_row, T, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tp % kRegion != 0) {
    depth_fwd_kernel<true><<<grid, kFwdThreads, 0, s>>>(face_pack, depth,
                                                        amax, T, g, tp, kf,
                                                        inv_s);
  } else {
    depth_fwd_kernel<false><<<grid, kFwdThreads, 0, s>>>(face_pack, depth,
                                                         amax, T, g, tp, kf,
                                                         inv_s);
  }
  return (int)cudaGetLastError();
}

// depth_bwd: `partial` is scratch of at least B * T * n_chunks *
// (4 + 4 * 256) floats (the chunks' compact lists), n_chunks =
// ceil(tp^2 / 256).
extern "C" int depth_bwd(const float* depth, const int* amax,
                         const float* gcot, float* partial, float* gpack,
                         int B, int T, int g, int tp, int kf, int n_chunks,
                         float inv_s, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_chunks, T, B);
  depth_bwd_partial_kernel<<<grid, kThreads, 0, s>>>(depth, amax, gcot,
                                                     partial, T, g, tp,
                                                     inv_s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  depth_bwd_finalize_kernel<<<(unsigned)(B * T), kThreads, 0, s>>>(
      partial, gpack, n_chunks, kf);
  return (int)cudaGetLastError();
}
