// Soft-silhouette tile shading for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernel _shade_fwd_kernel (homan_tpu/render/pallas_shade.py
// :86) and its XLA one-hot-einsum backward _shade_bwd_vjp (:281). The plain
// PyTorch versions and the math are in render/shade.py; the kernels keep
// the plain expressions wherever an exact comparison depends on them.
//
// What bounds the forward. Per pixel and valid slot the plain form does
// two IEEE divides and ~62 fp32 operations; much of that depends only on
// the pixel's row and the slot: the +x crossing of pass 1 (spans, the
// divide, xi) and, in pass 2, py - ay, ex (py - ay), (py - ay) ey and the
// segment's ex, ey and |e|^2. And pass 2 only matters where a segment can
// come nearer a pixel than the nearest one so far. What a pixel needs is a
// compare and an add per slot in pass 1 and ~37 operations per slot that
// can still win in pass 2 (about 1% of them at the headline pack), so its
// least time is set by the 24 bytes of output per pixel.
//
// Forward design.
//  * A block covers RB whole rows of one tile (RB = min(tp, 128 * 8 / tp),
//    halved while the shared records would not fit), tp / 8 threads per
//    row, 8 adjacent pixels per thread: 128 threads and 8 rows at tp 128,
//    32 rows at tp 32, the whole tile (32 threads) at tp 16. Grid
//    (ceil(tp / RB), T, B). Anchors and the five outputs move as float4 /
//    int4. (On the headline pack, 8 pixels a thread in blocks of 128 beat
//    4 pixels in blocks of 256 and 8 in blocks of 256: PERF.md.)
//  * The block counts its tile's valid slots n_e once (__syncthreads_count;
//    the binning packs them as a prefix), then computes each (slot, row)
//    record once into shared memory: xi folded with spans and xi <= x1
//    (xi, or -inf where the slot cannot cross the row's ray), sgn, and for
//    pass 2 ax, ay, ex, ey, |e|^2 and its reciprocal, py - ay,
//    ex (py - ay), (py - ay) ey, flip, the segment's x extent, the row's
//    gap to its y extent and a rounding slack. The row-side arithmetic is
//    the plain version's, uncontracted, so a pixel's crossing test
//    `xi > px` and its winding are bit-identical.
//  * Pass 2 skips, per thread and slot, a segment that cannot lower any of
//    its 8 pixels' d2min: the gap between the pixels' box and the
//    segment's box, less the slack, squared, above the largest of their
//    d2min (the plain version's rounded d2 of that segment is then larger
//    too, and an irrelevant segment gives cap2). The skip changes no
//    output; it only drops work (PERF.md gives the share evaluated).
//  * Pass 2 per pixel keeps the plain version's expressions, so its
//    outputs are bit-identical too. That matters beyond the bands: where
//    two slots tie (a pixel nearest a vertex two contour segments share),
//    d2 rounded any other way picks the other slot, and the backward then
//    sends that pixel's gradient to the other slot's endpoint rows (a
//    staged reciprocal with FMA-contracted tc, dx, dyp and d2 kept sil,
//    argmin and residuals inside their bands on the card, but moved gseg
//    by 31% of its maximum on the headline fit's pack). The one divide,
//    (px - ax) ex + (py - ay) ey over |e|^2, is the correctly rounded
//    quotient from the slot's staged reciprocal y = 1/|e|^2: q0 = n y and
//    two residual corrections q = q + (n - |e|^2 q) y with __fmaf_rn
//    (Markstein: a faithful q and the correctly rounded y give the
//    correctly rounded quotient), with the divide itself where |n| lies
//    outside [2^-60, 2^60]. `cross2d == 0`, its sign and the strict
//    `d2 < d2min` are exact as in the plain version.
//  * The residual and forward-only instantiations share all arithmetic, so
//    their sil are bit-equal.
//  * Any tile width. A tile that is a multiple of 8 pixels and at most
//    1024 wide runs the instantiation above. Any other runs a second one
//    (kRagged): a block covers RB rows of a column segment of at most 1024
//    pixels, grid (ceil(tp / RB) * segments, T, B), and every thread loads
//    and stores its pixels by scalars, masked at the tile's edge (a row's
//    pixels are not 16-byte aligned when tp is not a multiple of 4). The
//    pixels of a thread's last group that lie past the edge are computed
//    but never stored; they only widen its skip test's box and raise its
//    largest d2min, so the skip stays exact. The arithmetic per pixel is
//    the same, so the outputs stay bit-equal to the plain version's.
//
// What bounds the backward. Bytes: every pixel's argmin (4 bytes) says
// whether it reaches gseg, and only a pixel that picked a slot needs its
// other 20 (sil, rx, ry, tc and the cotangent) and ~14 fp32 operations;
// the output, 8 x Ke per tile, is small. The work it adds on top is the
// reduction per slot.
//
// What the first design lost (256-pixel blocks). Each block looped
// over every slot up to its largest argmin, with two __syncthreads per
// slot, though a strip of two rows picks only a handful of distinct
// slots; and it wrote dense (B, T, C, 4, Ke) partials, zeros past its
// largest argmin included, which a second kernel read back: ~24 MB of
// scratch traffic at the headline pack beside the 47 MB of inputs.
//
// Backward design.
//  * A block covers a strip of 1024 pixels of one tile (8 rows at tile
//    128), or the whole of a smaller tile with as many warps as it needs
//    (two at tile 16); each thread takes 4 adjacent pixels.
//  * Only the pixels that picked a slot need their residuals: a thread
//    reads its amin first (int4), then the other five arrays (float4) only
//    where one of its pixels picked a slot. At the headline pack 3.4% of
//    the pixels pick one (the rest lie farther than the bin margin from
//    every relevant segment), so the bytes read fall from 24 a pixel to ~5
//    (chip_smoke.py's bound counts 4 a pixel and 20 a picked pixel): all
//    six arrays read took 0.034 ms there on the H100, this 0.023 (cold
//    L2). Scalars where tp^2 is not a multiple of 4 or a pointer is not
//    16-byte aligned; streaming loads (each byte is read once).
//  * A warp walks the DISTINCT slots its 128 pixels picked, in ascending
//    order (__reduce_min_sync over each lane's pending slots). Per slot a
//    lane adds its pixels that picked it in pixel order, and a shuffle tree
//    adds the lanes in a fixed order: passes = distinct slots, no barrier.
//    Lane 0 keeps (slot, 4 sums) in the warp's sorted list in shared
//    memory.
//  * The first warp that holds a slot adds the warps' sums in warp order
//    (finding the slot in the others' lists by binary search) and writes
//    it to the strip's compact list: the count, then the slots and their 4
//    sums. Nothing is zero-filled. A tile of one strip (tp <= 32) writes
//    its gseg there directly, zeros first, and takes no second launch (at
//    tile 16 a block of 2048 pixels idled 7 of its 8 warps, and the second
//    launch ran a block per tile: 0.092 ms for 30 x 256 tiles on the H100).
//  * A second launch, one block per tile, clears a 4 x Ke accumulator in
//    shared memory (windows of 2048 slots), adds the strips' lists in
//    strip order (a list's slots are distinct, so its entries add without
//    conflict) and writes gseg (B, T, 8, Ke) once, rows 4-7 zero.
//  * Deterministic: every sum has a fixed order (pixel, lane tree, warp,
//    strip); the list positions come from a shared counter, but they only
//    decide which thread adds an entry. No atomics on floats.
//  * Measured and not kept (PERF.md): 8 pixels a thread (2048-pixel
//    strips) 0.0232 ms against 0.0228; the last strip block of a tile
//    adding the lists (an integer ticket after __threadfence) instead of a
//    second launch; persistent blocks that load the next strip while they
//    reduce (116 registers: one block an SM, 0.042 ms with all six arrays
//    read against 0.029).
#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFwdThreads = 128;  // forward: threads per block, at most
constexpr int kPx = 8;  // forward: adjacent pixels of one row per thread
static_assert(kPx % 4 == 0, "the forward moves pixels as float4");
// Forward: the widest column segment a block covers.
constexpr int kFwdCols = kFwdThreads * kPx;
// Forward shared terms per (slot, row): four float4.
constexpr int kRecordBytes = 4 * 16;
constexpr int kMaxForwardSmem = 200 * 1024;

// Backward (render/shade.py BWD_STRIP_PIXELS, bwd_list_floats).
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdPx = 4;                        // pixels a thread: a float4
constexpr int kWarpPx = 32 * kBwdPx;             // pixels a warp
constexpr int kStripPx = kBwdThreads * kBwdPx;   // pixels a block
constexpr int kWindow = 2048;  // finalize: accumulator slots per pass
constexpr int kGroup = 8;      // finalize: strip lists loaded together

template <bool kResiduals, bool kRagged>
__global__ void __launch_bounds__(kFwdThreads)
shade_fwd_kernel(const float* __restrict__ seg_pack,
                 const float* __restrict__ anchors, float* __restrict__ sil,
                 int* __restrict__ amin_out, float* __restrict__ rx_out,
                 float* __restrict__ ry_out, float* __restrict__ tc_out,
                 int T, int g, int tp, int ke, int rb, float inv_s,
                 float sigma, float cap2) {
  extern __shared__ float4 smem[];
  float4* s_a = smem;                    // (ax, ex, ey, 1/|e|^2)
  float4* s_b = smem + (size_t)ke * rb;  // (py-ay, ex(py-ay), (py-ay)ey,
                                         //  flip)
  float4* s_c = s_b + (size_t)ke * rb;   // (xi or -inf, sgn, |e|^2, ay)
  float4* s_d = s_c + (size_t)ke * rb;   // (x min, x max, y gap, slack)
  const int t = blockIdx.y;
  const size_t tile = (size_t)blockIdx.z * T + t;
  const float* seg = seg_pack + tile * 8 * ke;
  // kRagged: blockIdx.x walks the column segments of each row block.
  const int n_col = kRagged ? (tp + kFwdCols - 1) / kFwdCols : 1;
  const int row_block = kRagged ? (int)blockIdx.x / n_col : (int)blockIdx.x;
  const int col0 = kRagged ? ((int)blockIdx.x - row_block * n_col) * kFwdCols
                           : 0;
  const int row0 = row_block * rb;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  int n_e = 0;
  for (int base = 0; base < ke; base += nthreads) {
    const int k = base + tid;
    n_e += __syncthreads_count(k < ke && seg[5 * ke + k] > 0.5f);
  }

  const float gx = (float)(t % g);
  const float gy = (float)(t / g);
  const float ftp = (float)tp;
  const float x1 = (gx + 1.0f) * ftp * inv_s;
  const float kNegInf = __int_as_float(0xff800000u);
  // Per (slot, row) records, in the plain version's expressions.
  for (int i = tid; i < n_e * rb; i += nthreads) {
    const int k = i / rb;
    const int r = i - k * rb;
    const float py = (gy * ftp + (float)(row0 + r) + 0.5f) * inv_s;
    const float ax = seg[k], ay = seg[ke + k];
    const float bx = seg[2 * ke + k], by = seg[3 * ke + k];
    const float dy = by - ay;
    const float dy_safe = fabsf(dy) > 1e-12f ? dy : 1.0f;
    const bool spans = (ay <= py) != (by <= py);
    const float pya = py - ay;
    const float tt = pya / dy_safe;
    const float ex = bx - ax;
    const float xi = ax + tt * ex;
    const float ey = dy;
    const float denom = fmaxf(ex * ex + ey * ey, 1e-12f);
    s_c[i] = make_float4(spans && (xi <= x1) ? xi : kNegInf,
                         seg[4 * ke + k], denom, ay);
    s_a[i] = make_float4(ax, ex, ey, 1.0f / denom);
    s_b[i] = make_float4(pya, ex * pya, pya * ey, seg[6 * ke + k]);
    // The skip test of pass 2: the segment's x extent, the row's distance
    // to its y extent, and a slack above the rounding of the plain
    // version's dx and dyp (<= 2^-21.5 of the largest coordinate).
    const float big = fmaxf(fmaxf(fabsf(ax), fabsf(bx)),
                            fmaxf(fabsf(ay), fabsf(by)));
    s_d[i] = make_float4(fminf(ax, bx), fmaxf(ax, bx),
                         fmaxf(fmaxf(fminf(ay, by) - py, py - fmaxf(ay, by)),
                               0.0f),
                         (big + 2.0f) * 0x1p-18f);
  }
  __syncthreads();

  // Threads per row.
  const int tr = kRagged ? (min(tp, kFwdCols) + kPx - 1) / kPx : tp / kPx;
  const int r = tid / tr;
  const int row = row0 + r;
  if (r >= rb || row >= tp) return;
  const int ix0 = col0 + (tid - r * tr) * kPx;
  if (kRagged && ix0 >= tp) return;
  const size_t pix = tile * tp * tp + (size_t)row * tp + ix0;
  float px[kPx];
#pragma unroll
  for (int q = 0; q < kPx; ++q) {
    px[q] = (gx * ftp + (float)(ix0 + q) + 0.5f) * inv_s;
  }

  // Pass 1: winding = anchor + oriented crossings of the +x ray in (px, x1].
  float winding[kPx];
  if (kRagged) {
#pragma unroll
    for (int q = 0; q < kPx; ++q) {
      winding[q] = ix0 + q < tp ? anchors[pix + q] : 0.0f;
    }
  } else {
#pragma unroll
    for (int v = 0; v < kPx; v += 4) {
      const float4 anc = *reinterpret_cast<const float4*>(anchors + pix + v);
      winding[v] = anc.x;
      winding[v + 1] = anc.y;
      winding[v + 2] = anc.z;
      winding[v + 3] = anc.w;
    }
  }
  for (int k = 0; k < n_e; ++k) {
    const float4 xs = s_c[k * rb + r];
#pragma unroll
    for (int q = 0; q < kPx; ++q) {
      winding[q] = winding[q] + (xs.x > px[q] ? xs.y : 0.0f);
    }
  }
  bool covered[kPx];
#pragma unroll
  for (int q = 0; q < kPx; ++q) covered[q] = fabsf(winding[q]) > 0.5f;

  // Pass 2: nearest silhouette-relevant segment. For a covered pixel only
  // segments across which the winding drops to 0 count.
  float d2min[kPx], rxm[kPx], rym[kPx], tcm[kPx];
  int am[kPx];
#pragma unroll
  for (int q = 0; q < kPx; ++q) {
    d2min[q] = cap2;
    am[q] = -1;
    rxm[q] = rym[q] = tcm[q] = 0.0f;
  }
  const float py = (gy * ftp + (float)row + 0.5f) * inv_s;
  float dmax = cap2;  // the largest d2min of the thread's pixels
  for (int k = 0; k < n_e; ++k) {
    // Skip the slot where it cannot lower any of the thread's d2min: L is
    // a lower bound of every pixel's distance to the segment (the gap
    // between the pixels' and the segment's boxes), and the plain
    // version's rounded d2 is then at least (L - slack)^2 (1 - 2^-22),
    // above dmax; an irrelevant slot gives cap2 >= d2min. The outputs do
    // not change.
    const float4 gb = s_d[k * rb + r];
    const float gap = fmaxf(fmaxf(gb.x - px[kPx - 1], px[0] - gb.y), 0.0f);
    const float lo = sqrtf(gap * gap + gb.z * gb.z) - gb.w;
    if (lo > 0.0f && lo * lo > dmax * (1.0f + 0x1p-18f)) continue;
    const float4 a = s_a[k * rb + r];  // ax, ex, ey, 1/|e|^2
    const float4 b = s_b[k * rb + r];  // py-ay, ex(py-ay), (py-ay)ey, flip
    const float4 c = s_c[k * rb + r];  // -, -, |e|^2, ay
#pragma unroll
    for (int q = 0; q < kPx; ++q) {
      const float pxa = px[q] - a.x;
      const float num = pxa * a.y + b.z;
      float quot;
      if (fabsf(num) >= 0x1p-60f && fabsf(num) <= 0x1p60f) {
        const float q0 = num * a.w;
        const float q1 = __fmaf_rn(__fmaf_rn(-q0, c.z, num), a.w, q0);
        quot = __fmaf_rn(__fmaf_rn(-q1, c.z, num), a.w, q1);
      } else {
        quot = num / c.z;
      }
      const float tc = fminf(fmaxf(quot, 0.0f), 1.0f);
      const float dx = px[q] - (a.x + tc * a.y);
      const float dyp = py - (c.w + tc * a.z);
      float d2 = dx * dx + dyp * dyp;
      const float cross2d = b.y - a.z * pxa;
      const float sgn_c = cross2d > 0.0f ? 1.0f
                                         : (cross2d < 0.0f ? -1.0f : 0.0f);
      const float w_other = winding[q] - b.w * sgn_c;
      const bool rel = (fabsf(w_other) < 0.5f) || (cross2d == 0.0f) ||
                       !covered[q];
      d2 = rel ? d2 : cap2;
      if (d2 < d2min[q]) {
        d2min[q] = d2;
        if (kResiduals) {
          am[q] = k;
          rxm[q] = dx;
          rym[q] = dyp;
          tcm[q] = tc;
        }
      }
    }
    dmax = d2min[0];
#pragma unroll
    for (int q = 1; q < kPx; ++q) dmax = fmaxf(dmax, d2min[q]);
  }
  float s_out[kPx];
#pragma unroll
  for (int q = 0; q < kPx; ++q) {
    const float signed_d2 = covered[q] ? d2min[q] : -d2min[q];
    s_out[q] = 1.0f / (1.0f + expf(-(signed_d2 / sigma)));
  }
  if (kRagged) {
#pragma unroll
    for (int q = 0; q < kPx; ++q) {
      if (ix0 + q >= tp) break;
      sil[pix + q] = s_out[q];
      if (kResiduals) {
        amin_out[pix + q] = am[q];
        rx_out[pix + q] = rxm[q];
        ry_out[pix + q] = rym[q];
        tc_out[pix + q] = tcm[q];
      }
    }
    return;
  }
#pragma unroll
  for (int v = 0; v < kPx; v += 4) {
    *reinterpret_cast<float4*>(sil + pix + v) =
        make_float4(s_out[v], s_out[v + 1], s_out[v + 2], s_out[v + 3]);
    if (kResiduals) {
      *reinterpret_cast<int4*>(amin_out + pix + v) =
          make_int4(am[v], am[v + 1], am[v + 2], am[v + 3]);
      *reinterpret_cast<float4*>(rx_out + pix + v) =
          make_float4(rxm[v], rxm[v + 1], rxm[v + 2], rxm[v + 3]);
      *reinterpret_cast<float4*>(ry_out + pix + v) =
          make_float4(rym[v], rym[v + 1], rym[v + 2], rym[v + 3]);
      *reinterpret_cast<float4*>(tc_out + pix + v) =
          make_float4(tcm[v], tcm[v + 1], tcm[v + 2], tcm[v + 3]);
    }
  }
}

// A strip's compact list (render/shade.py bwd_list_floats): the count,
// padded to 4 floats, then `cap` slots (as ints) padded to a multiple of
// 4, then `cap` float4 sums.
__host__ __device__ inline int list_floats(int cap) {
  return 4 + (cap + 3) / 4 * 4 + 4 * cap;
}

template <bool kVecLoads>
__global__ void __launch_bounds__(kBwdThreads)
shade_bwd_strip_kernel(const float* __restrict__ sil,
                       const int* __restrict__ amin,
                       const float* __restrict__ rx,
                       const float* __restrict__ ry,
                       const float* __restrict__ tc,
                       const float* __restrict__ gcot,
                       float* __restrict__ lists, float* __restrict__ gseg,
                       int T, int tp, int ke, int warp_cap, int cap,
                       float sigma) {
  extern __shared__ float4 s_bwd[];
  float4* s_v = s_bwd;  // per warp: warp_cap sums, then the slots
  int* s_k = reinterpret_cast<int*>(s_bwd + (blockDim.x >> 5) * warp_cap);
  __shared__ int s_n[kBwdWarps];
  __shared__ int s_count;
  const int strip = blockIdx.x;
  const size_t tile = (size_t)blockIdx.z * T + blockIdx.y;
  const int P = tp * tp;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const bool direct = gridDim.x == 1;  // the tile's only strip

  // The thread's kBwdPx adjacent pixels from p, masked at the tile's end
  // (a pixel past it picks no slot). Streaming loads: each byte is read
  // once. amin first: pixels that picked no slot need none of their other
  // five arrays.
  const int p = (strip * blockDim.x + threadIdx.x) * kBwdPx;
  const size_t i = tile * P + p;
  int a[kBwdPx];
  if (kVecLoads) {  // P is a multiple of 4: the pixels are all in or out
    const int4 a4 = p < P ? __ldcs(reinterpret_cast<const int4*>(amin + i))
                          : make_int4(-1, -1, -1, -1);
    a[0] = a4.x;
    a[1] = a4.y;
    a[2] = a4.z;
    a[3] = a4.w;
  } else {
#pragma unroll
    for (int v = 0; v < kBwdPx; ++v) {
      a[v] = p + v < P ? __ldcs(amin + i + v) : -1;
    }
  }
  bool need = false;
#pragma unroll
  for (int v = 0; v < kBwdPx; ++v) need |= a[v] >= 0 && a[v] < ke;
  float s[kBwdPx], gc[kBwdPx], t[kBwdPx], x[kBwdPx], y[kBwdPx];
  if (kVecLoads && need) {
    const float4 s4 = __ldcs(reinterpret_cast<const float4*>(sil + i));
    const float4 x4 = __ldcs(reinterpret_cast<const float4*>(rx + i));
    const float4 y4 = __ldcs(reinterpret_cast<const float4*>(ry + i));
    const float4 t4 = __ldcs(reinterpret_cast<const float4*>(tc + i));
    const float4 g4 = __ldcs(reinterpret_cast<const float4*>(gcot + i));
    s[0] = s4.x; s[1] = s4.y; s[2] = s4.z; s[3] = s4.w;
    x[0] = x4.x; x[1] = x4.y; x[2] = x4.z; x[3] = x4.w;
    y[0] = y4.x; y[1] = y4.y; y[2] = y4.z; y[3] = y4.w;
    t[0] = t4.x; t[1] = t4.y; t[2] = t4.z; t[3] = t4.w;
    gc[0] = g4.x; gc[1] = g4.y; gc[2] = g4.z; gc[3] = g4.w;
  } else {
#pragma unroll
    for (int v = 0; v < kBwdPx; ++v) {
      const bool in = need && p + v < P;
      s[v] = in ? __ldcs(sil + i + v) : 0.0f;
      x[v] = in ? __ldcs(rx + i + v) : 0.0f;
      y[v] = in ? __ldcs(ry + i + v) : 0.0f;
      t[v] = in ? __ldcs(tc + i + v) : 0.0f;
      gc[v] = in ? __ldcs(gcot + i + v) : 0.0f;
    }
  }
  // The plain version's expressions (shade.py _bwd_contrib).
  int kk[kBwdPx];  // the slot each pixel picked, INT_MAX once added
  float c0[kBwdPx], c1[kBwdPx], c2[kBwdPx], c3[kBwdPx];
#pragma unroll
  for (int v = 0; v < kBwdPx; ++v) {
    float base = gc[v] * s[v] * (1.0f - s[v]) / sigma;
    if (!(s[v] >= 0.5f)) base = -base;
    const float wa = -2.0f * base * (1.0f - t[v]);
    const float wb = -2.0f * base * t[v];
    c0[v] = wa * x[v];
    c1[v] = wa * y[v];
    c2[v] = wb * x[v];
    c3[v] = wb * y[v];
    kk[v] = a[v] >= 0 && a[v] < ke ? a[v] : INT_MAX;
  }

  // The warp walks its distinct slots in ascending order.
  float4* w_v = s_v + warp * warp_cap;
  int* w_k = s_k + warp * warp_cap;
  int n = 0;  // distinct slots of this warp so far (warp-uniform)
  while (true) {
    int mine = INT_MAX;
#pragma unroll
    for (int q = 0; q < kBwdPx; ++q) mine = min(mine, kk[q]);
    const int k = __reduce_min_sync(0xffffffffu, mine);
    if (k == INT_MAX) break;  // warp-uniform
    float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f, v3 = 0.0f;
#pragma unroll
    for (int q = 0; q < kBwdPx; ++q) {
      if (kk[q] == k) {
        v0 += c0[q];
        v1 += c1[q];
        v2 += c2[q];
        v3 += c3[q];
        kk[q] = INT_MAX;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      v0 += __shfl_down_sync(0xffffffffu, v0, off);
      v1 += __shfl_down_sync(0xffffffffu, v1, off);
      v2 += __shfl_down_sync(0xffffffffu, v2, off);
      v3 += __shfl_down_sync(0xffffffffu, v3, off);
    }
    if (lane == 0) {
      w_k[n] = k;
      w_v[n] = make_float4(v0, v1, v2, v3);
    }
    ++n;
  }
  if (lane == 0) s_n[warp] = n;
  if (threadIdx.x == 0) s_count = 0;
  float* tile_g = gseg + tile * 8 * (size_t)ke;
  if (direct) {  // rows 0-3 of the slots no pixel picked, and rows 4-7
    for (int i = threadIdx.x; i < 8 * ke; i += blockDim.x) tile_g[i] = 0.0f;
  }
  __syncthreads();

  // The strip's sum of slot k is 0 + (warp sums in warp order); the first
  // warp that holds k writes it. Lists are sorted, so a warp finds k by
  // binary search.
  auto find = [&](int w, int k) {
    const int* wk = s_k + w * warp_cap;
    int lo = 0, hi = s_n[w];
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (wk[mid] < k) lo = mid + 1; else hi = mid;
    }
    return lo < s_n[w] && wk[lo] == k ? lo : -1;
  };
  float* out = lists + (tile * gridDim.x + strip) * (size_t)list_floats(cap);
  int* out_k = reinterpret_cast<int*>(out) + 4;
  float4* out_v = reinterpret_cast<float4*>(out + 4 + (cap + 3) / 4 * 4);
  for (int j = lane; j < n; j += 32) {
    const int k = w_k[j];
    bool first = true;
    for (int w = 0; w < warp && first; ++w) first = find(w, k) < 0;
    if (!first) continue;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int w = warp; w < n_warps; ++w) {
      const int i = w == warp ? j : find(w, k);
      if (i >= 0) {
        const float4 v = s_v[w * warp_cap + i];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
    if (direct) {
      tile_g[k] = acc.x;
      tile_g[ke + k] = acc.y;
      tile_g[2 * ke + k] = acc.z;
      tile_g[3 * ke + k] = acc.w;
      continue;
    }
    const int pos = atomicAdd(&s_count, 1);  // list order is free
    out_k[pos] = k;
    out_v[pos] = acc;
  }
  if (direct) return;
  __syncthreads();
  if (threadIdx.x == 0) reinterpret_cast<int*>(out)[0] = s_count;
}

__global__ void __launch_bounds__(kBwdThreads)
shade_bwd_finalize_kernel(const float* __restrict__ lists,
                          float* __restrict__ gseg, int S, int ke, int cap) {
  __shared__ float4 s_acc[kWindow];
  const int tid = threadIdx.x;
  const size_t tile = blockIdx.x;
  const int lf = list_floats(cap);
  const int v_off = 4 + (cap + 3) / 4 * 4;
  const float* tile_lists = lists + tile * S * (size_t)lf;
  float* out = gseg + tile * 8 * (size_t)ke;
  for (int lo = 0; lo < ke; lo += kWindow) {
    const int n = min(kWindow, ke - lo);
    // Rows 4-7 first: their stores overlap the lists' loads.
    for (int r = 4; r < 8; ++r) {
      for (int i = tid; i < n; i += kBwdThreads) {
        out[(size_t)r * ke + lo + i] = 0.0f;
      }
    }
    for (int i = tid; i < n; i += kBwdThreads) {
      s_acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
    // Strip order. The counts and first entries of kGroup strips load
    // together; a list longer than kBwdThreads adds the rest in turn.
    for (int s0 = 0; s0 < S; s0 += kGroup) {
      int cnt[kGroup], k0[kGroup];
      float4 v0[kGroup];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        const float* l = tile_lists + (size_t)(s0 + q) * lf;
        cnt[q] = s0 + q < S ? reinterpret_cast<const int*>(l)[0] : 0;
        const bool has = tid < cnt[q];
        k0[q] = has ? reinterpret_cast<const int*>(l)[4 + tid] : -1;
        v0[q] = has ? reinterpret_cast<const float4*>(l + v_off)[tid]
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        const float* l = tile_lists + (size_t)(s0 + q) * lf;
        for (int i = tid; i < cnt[q]; i += kBwdThreads) {
          const bool first = i == tid;
          const int k =
              (first ? k0[q] : reinterpret_cast<const int*>(l)[4 + i]) - lo;
          if (k >= 0 && k < n) {
            const float4 v =
                first ? v0[q] : reinterpret_cast<const float4*>(l + v_off)[i];
            float4 a = s_acc[k];
            a.x += v.x;
            a.y += v.y;
            a.z += v.z;
            a.w += v.w;
            s_acc[k] = a;
          }
        }
        __syncthreads();  // the next strip may add to the same slots
      }
    }
    for (int i = tid; i < n; i += kBwdThreads) {
      const float4 a = s_acc[i];
      out[lo + i] = a.x;
      out[(size_t)ke + lo + i] = a.y;
      out[(size_t)2 * ke + lo + i] = a.z;
      out[(size_t)3 * ke + lo + i] = a.w;
    }
    __syncthreads();  // the next window clears s_acc
  }
}

template <bool kResiduals, bool kRagged>
int launch_fwd(dim3 grid, int threads, size_t smem, cudaStream_t s,
               const float* seg_pack, const float* anchors, float* sil,
               int* amin, float* rx, float* ry, float* tc, int T, int g,
               int tp, int ke, int rb, float inv_s, float sigma,
               float cap2) {
  // Raise the kernel's dynamic shared-memory limit only when a launch needs
  // more than it was given (once per size, not a host call per launch).
  // The limit belongs to the current device; the port drives one device
  // per process, and a launch on another would fail and be reported.
  static size_t limit = 48 * 1024;
  if (smem > limit) {
    const cudaError_t err = cudaFuncSetAttribute(
        shade_fwd_kernel<kResiduals, kRagged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    limit = smem;
  }
  shade_fwd_kernel<kResiduals, kRagged><<<grid, threads, smem, s>>>(
      seg_pack, anchors, sil, amin, rx, ry, tc, T, g, tp, ke, rb, inv_s,
      sigma, cap2);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// C interface, loaded with ctypes. Each entry point launches on `stream`
// and returns cudaGetLastError() (0 = launched); shade_fwd returns -1 for
// a Ke whose per-row records do not fit in shared memory.
extern "C" int shade_fwd(const float* seg_pack, const float* anchors,
                         float* sil, int* amin, float* rx, float* ry,
                         float* tc, int B, int T, int g, int tp, int ke,
                         int want_residuals, float inv_s, float sigma,
                         float cap2, void* stream) {
  if (tp <= 0) return (int)cudaErrorInvalidValue;
  const bool ragged = tp % kPx != 0 || tp > kFwdCols;
  const int tr = (std::min(tp, kFwdCols) + kPx - 1) / kPx;  // per row
  int rb = kFwdThreads / tr;  // rows per block
  if (rb > tp) rb = tp;
  while (rb > 1 && (size_t)ke * rb * kRecordBytes > kMaxForwardSmem) rb /= 2;
  const size_t smem = (size_t)ke * rb * kRecordBytes;
  if (smem > kMaxForwardSmem) return -1;
  const int n_col = ragged ? (tp + kFwdCols - 1) / kFwdCols : 1;
  const dim3 grid((tp + rb - 1) / rb * n_col, T, B);
  const int threads = rb * tr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SHADE_FWD_LAUNCH(RES, RAG)                                          \
  launch_fwd<RES, RAG>(grid, threads, smem, s, seg_pack, anchors, sil, amin, \
                       rx, ry, tc, T, g, tp, ke, rb, inv_s, sigma, cap2)
  if (ragged) {
    return want_residuals ? SHADE_FWD_LAUNCH(true, true)
                          : SHADE_FWD_LAUNCH(false, true);
  }
  return want_residuals ? SHADE_FWD_LAUNCH(true, false)
                        : SHADE_FWD_LAUNCH(false, false);
#undef SHADE_FWD_LAUNCH
}

// The backward's pixels per strip (one block of the first launch).
extern "C" int shade_bwd_strip_pixels() { return kStripPx; }

// shade_bwd: n_strips = ceil(tp^2 / kStripPx); `lists` is scratch of at
// least B * T * n_strips * list_floats(min(ke, kStripPx)) floats where
// n_strips > 1, and unused where it is 1.
extern "C" int shade_bwd(const float* sil, const int* amin, const float* rx,
                         const float* ry, const float* tc, const float* gcot,
                         float* lists, float* gseg, int B, int T, int tp,
                         int ke, int n_strips, float sigma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int warp_cap = std::min(ke, kWarpPx);  // distinct slots of a warp
  const int cap = std::min(ke, kStripPx);      // and of a strip
  // A tile of one strip takes as many warps as its pixels need.
  const int px_threads = (tp * tp + kBwdPx - 1) / kBwdPx;
  const int threads = n_strips > 1 ? kBwdThreads
                                   : std::min(kBwdThreads,
                                              (px_threads + 31) / 32 * 32);
  const size_t smem = (size_t)(threads / 32) * warp_cap * (sizeof(float4) + 4);
  const bool vec = (tp * tp) % kBwdPx == 0 && aligned16(sil) &&
                   aligned16(amin) && aligned16(rx) && aligned16(ry) &&
                   aligned16(tc) && aligned16(gcot);
  const dim3 grid(n_strips, T, B);
  if (vec) {
    shade_bwd_strip_kernel<true><<<grid, threads, smem, s>>>(
        sil, amin, rx, ry, tc, gcot, lists, gseg, T, tp, ke, warp_cap, cap,
        sigma);
  } else {
    shade_bwd_strip_kernel<false><<<grid, threads, smem, s>>>(
        sil, amin, rx, ry, tc, gcot, lists, gseg, T, tp, ke, warp_cap, cap,
        sigma);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_strips == 1) return (int)err;
  shade_bwd_finalize_kernel<<<(unsigned)(B * T), kBwdThreads, 0, s>>>(
      lists, gseg, n_strips, ke, cap);
  return (int)cudaGetLastError();
}
