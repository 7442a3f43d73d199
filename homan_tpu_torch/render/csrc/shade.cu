// Soft-silhouette tile shading for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernel _shade_fwd_kernel (homan_tpu/render/pallas_shade.py
// :86) and its XLA one-hot-einsum backward _shade_bwd_vjp (:281). The plain
// PyTorch versions in render/shade.py compute the same expressions in the
// same order; render/shade.py documents the math.
//
// Design.
//  * Forward: one thread per pixel, 256 pixels of one tile per block, grid
//    (tp*tp/256, T, B) -- 7,680 blocks at 30 frames x 4 tiles of 128^2, where
//    the TPU's (B, T) grid would give 120, fewer than the card's 132 SMs.
//    The block stages its tile's seg_pack (8 x Ke floats, 1.5 KB at Ke=48)
//    in shared memory; every thread then reads the same slot at once, a
//    broadcast. The binning packs valid slots as a prefix, so the edge
//    loops run k < n_e (the TPU kernel's chunk skip without chunks).
//  * Bound: compute. At the headline shape the forward does ~62 fp32 ops per
//    pixel and valid slot against 24 bytes of output per pixel; the
//    backward does ~14 ops per pixel against 24 bytes of input, so it is
//    bound by bytes.
//  * Backward: a deterministic segmented reduction. Each block reduces its
//    256 pixels for every slot up to the block's largest argmin in a fixed
//    order (warp shuffles, then the 8 warp sums in order) into per-block
//    partials (B, T, C, 4, Ke); a second kernel sums the C partials in
//    order into gseg (B, T, 8, Ke), rows 4-7 zero. No atomics on floats.
//  * Exactness: built with -fmad=false. `cross2d == 0` and the strict-<
//    argmin are exact comparisons; an FMA-contracted a*b+c would flip them
//    against the plain version, which never contracts. A later speed change
//    may revisit this.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <bool kResiduals>
__global__ void __launch_bounds__(kThreads)
shade_fwd_kernel(const float* __restrict__ seg_pack,
                 const float* __restrict__ anchors,
                 float* __restrict__ sil, int* __restrict__ amin_out,
                 float* __restrict__ rx_out, float* __restrict__ ry_out,
                 float* __restrict__ tc_out, int T, int g, int tp, int ke,
                 float inv_s, float sigma, float cap2) {
  extern __shared__ float seg[];  // 8 rows x ke
  const int t = blockIdx.y;
  const size_t tile = (size_t)blockIdx.z * T + t;
  const float* src = seg_pack + tile * 8 * ke;
  for (int i = threadIdx.x; i < 8 * ke; i += kThreads) seg[i] = src[i];
  __syncthreads();

  const int P = tp * tp;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  int n_e = 0;
  for (int k = 0; k < ke; ++k) n_e += seg[5 * ke + k] > 0.5f;

  const float gx = (float)(t % g);
  const float gy = (float)(t / g);
  const float ix = (float)(p % tp);
  const float iy = (float)(p / tp);
  const float ftp = (float)tp;
  const float px = (gx * ftp + ix + 0.5f) * inv_s;
  const float py = (gy * ftp + iy + 0.5f) * inv_s;
  const float x1 = (gx + 1.0f) * ftp * inv_s;
  const size_t pix = tile * P + p;

  // Pass 1: winding = anchor + oriented crossings of the +x ray in (px, x1].
  float winding = anchors[pix];
  for (int k = 0; k < n_e; ++k) {
    const float ax = seg[k], ay = seg[ke + k];
    const float bx = seg[2 * ke + k], by = seg[3 * ke + k];
    const float sgn = seg[4 * ke + k];
    const float dy = by - ay;
    const float dy_safe = fabsf(dy) > 1e-12f ? dy : 1.0f;
    const bool spans = (ay <= py) != (by <= py);
    const float tt = (py - ay) / dy_safe;
    const float xi = ax + tt * (bx - ax);
    const bool cross = spans && (xi > px) && (xi <= x1);
    winding = winding + (cross ? sgn : 0.0f);
  }
  const bool covered = fabsf(winding) > 0.5f;

  // Pass 2: nearest silhouette-relevant segment. For a covered pixel only
  // segments across which the winding drops to 0 count.
  float d2min = cap2;
  int am = -1;
  float rxm = 0.0f, rym = 0.0f, tcm = 0.0f;
  for (int k = 0; k < n_e; ++k) {
    const float ax = seg[k], ay = seg[ke + k];
    const float bx = seg[2 * ke + k], by = seg[3 * ke + k];
    const float flipk = seg[6 * ke + k];
    const float ex = bx - ax;
    const float ey = by - ay;
    const float denom = fmaxf(ex * ex + ey * ey, 1e-12f);
    const float tc = fminf(
        fmaxf(((px - ax) * ex + (py - ay) * ey) / denom, 0.0f), 1.0f);
    const float dx = px - (ax + tc * ex);
    const float dyp = py - (ay + tc * ey);
    float d2 = dx * dx + dyp * dyp;
    const float cross2d = ex * (py - ay) - ey * (px - ax);
    const float sgn_c = cross2d > 0.0f ? 1.0f : (cross2d < 0.0f ? -1.0f
                                                                : 0.0f);
    const float w_other = winding - flipk * sgn_c;
    const bool rel = (fabsf(w_other) < 0.5f) || (cross2d == 0.0f) || !covered;
    d2 = rel ? d2 : cap2;
    if (d2 < d2min) {
      d2min = d2;
      if (kResiduals) {
        am = k;
        rxm = dx;
        rym = dyp;
        tcm = tc;
      }
    }
  }
  const float signed_d2 = covered ? d2min : -d2min;
  sil[pix] = 1.0f / (1.0f + expf(-(signed_d2 / sigma)));
  if (kResiduals) {
    amin_out[pix] = am;
    rx_out[pix] = rxm;
    ry_out[pix] = rym;
    tc_out[pix] = tcm;
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

}  // namespace

// C interface, loaded with ctypes. Each entry point launches on `stream`
// and returns cudaGetLastError() (0 = launched).
extern "C" int shade_fwd(const float* seg_pack, const float* anchors,
                         float* sil, int* amin, float* rx, float* ry,
                         float* tc, int B, int T, int g, int tp, int ke,
                         int want_residuals, float inv_s, float sigma,
                         float cap2, void* stream) {
  const dim3 grid((tp * tp + kThreads - 1) / kThreads, T, B);
  const size_t smem = (size_t)8 * ke * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (want_residuals) {
    shade_fwd_kernel<true><<<grid, kThreads, smem, s>>>(
        seg_pack, anchors, sil, amin, rx, ry, tc, T, g, tp, ke, inv_s, sigma,
        cap2);
  } else {
    shade_fwd_kernel<false><<<grid, kThreads, smem, s>>>(
        seg_pack, anchors, sil, amin, rx, ry, tc, T, g, tp, ke, inv_s, sigma,
        cap2);
  }
  return (int)cudaGetLastError();
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
