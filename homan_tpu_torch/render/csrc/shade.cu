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
//
// Backward design.
//  * Bound: bytes. ~14 ops per pixel against 24 bytes of input.
//  * A deterministic segmented reduction. Each block reduces its 256
//    pixels for every slot up to the block's largest argmin in a fixed
//    order (warp shuffles, then the 8 warp sums in order) into per-block
//    partials (B, T, C, 4, Ke); a second kernel sums the C partials in
//    order into gseg (B, T, 8, Ke), rows 4-7 zero. No atomics on floats.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFwdThreads = 128;  // forward: threads per block, at most
constexpr int kPx = 8;  // forward: adjacent pixels of one row per thread
static_assert(kPx % 4 == 0, "the forward moves pixels as float4");
// Forward shared terms per (slot, row): four float4.
constexpr int kRecordBytes = 4 * 16;
constexpr int kMaxForwardSmem = 200 * 1024;

template <bool kResiduals>
__global__ void __launch_bounds__(kFwdThreads)
shade_fwd_kernel(const float* __restrict__ seg_pack,
                                 const float* __restrict__ anchors,
                                 float* __restrict__ sil,
                                 int* __restrict__ amin_out,
                                 float* __restrict__ rx_out,
                                 float* __restrict__ ry_out,
                                 float* __restrict__ tc_out, int T, int g,
                                 int tp, int ke, int rb, float inv_s,
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
  const int row0 = blockIdx.x * rb;
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

  const int tr = tp / kPx;  // threads per row
  const int r = tid / tr;
  const int row = row0 + r;
  if (r >= rb || row >= tp) return;
  const int ix0 = (tid - r * tr) * kPx;
  const size_t pix = tile * tp * tp + (size_t)row * tp + ix0;
  float px[kPx];
#pragma unroll
  for (int q = 0; q < kPx; ++q) {
    px[q] = (gx * ftp + (float)(ix0 + q) + 0.5f) * inv_s;
  }

  // Pass 1: winding = anchor + oriented crossings of the +x ray in (px, x1].
  float winding[kPx];
#pragma unroll
  for (int v = 0; v < kPx; v += 4) {
    const float4 anc = *reinterpret_cast<const float4*>(anchors + pix + v);
    winding[v] = anc.x;
    winding[v + 1] = anc.y;
    winding[v + 2] = anc.z;
    winding[v + 3] = anc.w;
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

__global__ void __launch_bounds__(kThreads)
shade_bwd_partial_kernel(const float* __restrict__ sil,
                         const int* __restrict__ amin,
                         const float* __restrict__ rx,
                         const float* __restrict__ ry,
                         const float* __restrict__ tc,
                         const float* __restrict__ gcot,
                         float* __restrict__ partial, int T, int tp, int ke,
                         float sigma) {
  __shared__ int s_kmax;
  __shared__ float s_warp[kWarps][4];
  const int C = gridDim.x;
  const int chunk = blockIdx.x;
  const size_t tile = (size_t)blockIdx.z * T + blockIdx.y;
  const int P = tp * tp;
  const int p = chunk * kThreads + threadIdx.x;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
  int k_px = -1;
  if (p < P) {
    const size_t pix = tile * P + p;
    const float s = sil[pix];
    float base = gcot[pix] * s * (1.0f - s) / sigma;
    if (!(s >= 0.5f)) base = -base;
    const float t = tc[pix];
    const float wa = -2.0f * base * (1.0f - t);
    const float wb = -2.0f * base * t;
    const float r_x = rx[pix], r_y = ry[pix];
    c0 = wa * r_x;
    c1 = wa * r_y;
    c2 = wb * r_x;
    c3 = wb * r_y;
    k_px = amin[pix];
  }
  if (threadIdx.x == 0) s_kmax = -1;
  __syncthreads();
  atomicMax(&s_kmax, k_px);  // integer max: order-independent
  __syncthreads();
  const int n_slots = s_kmax + 1;

  float* out = partial + (tile * C + chunk) * 4 * ke;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = 0; k < n_slots; ++k) {
    const bool mine = (k_px == k);
    float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f, v3 = 0.0f;
    if (__any_sync(0xffffffffu, mine)) {  // warp-uniform branch
      v0 = mine ? c0 : 0.0f;
      v1 = mine ? c1 : 0.0f;
      v2 = mine ? c2 : 0.0f;
      v3 = mine ? c3 : 0.0f;
      for (int off = 16; off > 0; off >>= 1) {
        v0 += __shfl_down_sync(0xffffffffu, v0, off);
        v1 += __shfl_down_sync(0xffffffffu, v1, off);
        v2 += __shfl_down_sync(0xffffffffu, v2, off);
        v3 += __shfl_down_sync(0xffffffffu, v3, off);
      }
    }
    if (lane == 0) {
      s_warp[warp][0] = v0;
      s_warp[warp][1] = v1;
      s_warp[warp][2] = v2;
      s_warp[warp][3] = v3;
    }
    __syncthreads();
    if (threadIdx.x < 4) {
      float acc = 0.0f;
      for (int w = 0; w < kWarps; ++w) acc += s_warp[w][threadIdx.x];
      out[threadIdx.x * ke + k] = acc;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 4 * ke; i += kThreads) {
    if (i % ke >= n_slots) out[i] = 0.0f;
  }
}

__global__ void shade_bwd_finalize_kernel(const float* __restrict__ partial,
                                          float* __restrict__ gseg, int C,
                                          int ke, size_t n_out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const size_t tile = i / (8 * ke);
  const int row = (int)((i / ke) % 8);
  const int k = (int)(i % ke);
  float acc = 0.0f;
  if (row < 4) {
    const float* src = partial + (tile * C * 4 + row) * ke + k;
    for (int c = 0; c < C; ++c) acc += src[(size_t)c * 4 * ke];
  }
  gseg[i] = acc;
}

template <bool kResiduals>
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
        shade_fwd_kernel<kResiduals>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    limit = smem;
  }
  shade_fwd_kernel<kResiduals><<<grid, threads, smem, s>>>(
      seg_pack, anchors, sil, amin, rx, ry, tc, T, g, tp, ke, rb, inv_s,
      sigma, cap2);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. Each entry point launches on `stream`
// and returns cudaGetLastError() (0 = launched); shade_fwd returns -1 for
// a tile width it does not take (a multiple of 8, at most 1024).
extern "C" int shade_fwd(const float* seg_pack, const float* anchors,
                         float* sil, int* amin, float* rx, float* ry,
                         float* tc, int B, int T, int g, int tp, int ke,
                         int want_residuals, float inv_s, float sigma,
                         float cap2, void* stream) {
  if (tp % kPx != 0 || tp / kPx > kFwdThreads) return -1;
  int rb = kFwdThreads * kPx / tp;  // rows per block
  if (rb > tp) rb = tp;
  while (rb > 1 && (size_t)ke * rb * kRecordBytes > kMaxForwardSmem) rb /= 2;
  const size_t smem = (size_t)ke * rb * kRecordBytes;
  if (smem > kMaxForwardSmem) return -1;
  const dim3 grid((tp + rb - 1) / rb, T, B);
  const int threads = rb * (tp / kPx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (want_residuals) {
    return launch_fwd<true>(grid, threads, smem, s, seg_pack, anchors, sil,
                            amin, rx, ry, tc, T, g, tp, ke, rb, inv_s, sigma,
                            cap2);
  }
  return launch_fwd<false>(grid, threads, smem, s, seg_pack, anchors, sil,
                           amin, rx, ry, tc, T, g, tp, ke, rb, inv_s, sigma,
                           cap2);
}

extern "C" int shade_bwd(const float* sil, const int* amin, const float* rx,
                         const float* ry, const float* tc, const float* gcot,
                         float* partial, float* gseg, int B, int T, int tp,
                         int ke, int n_chunks, float sigma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_chunks, T, B);
  shade_bwd_partial_kernel<<<grid, kThreads, 0, s>>>(
      sil, amin, rx, ry, tc, gcot, partial, T, tp, ke, sigma);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n_out = (size_t)B * T * 8 * ke;
  const unsigned blocks = (unsigned)((n_out + kThreads - 1) / kThreads);
  shade_bwd_finalize_kernel<<<blocks, kThreads, 0, s>>>(partial, gseg,
                                                        n_chunks, ke, n_out);
  return (int)cudaGetLastError();
}
