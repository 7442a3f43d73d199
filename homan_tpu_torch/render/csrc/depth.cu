// Hard z-buffer depth tiles for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernels _depth_fwd_kernel (homan_tpu/render/
// pallas_depth.py:56) and _depth_bwd_kernel (:180). The plain PyTorch
// versions in render/depth.py compute the same expressions in the same
// order; render/depth.py documents the math.
//
// Design.
//  * Forward: one thread per pixel, 256 pixels of one tile per block, grid
//    (tp*tp/256, T, B) -- 10,240 blocks at 10 frames x 64 tiles of 64^2.
//    The block counts its tile's valid slots (a prefix, from the binning)
//    and stages them through shared memory 256 slots at a time (13 rows x
//    256 floats, 13 KB); every thread then reads the same slot at once, a
//    broadcast. The scan runs k < n_hit with strict `>` from best = 0, which
//    gives the TPU kernel's chunked first-match argmax: the lowest slot wins
//    a tie, and amax = -1 where no face covers the pixel.
//  * Bound: compute. ~22 fp32 operations per pixel and valid slot against 8
//    bytes of output per pixel. The backward does ~6 operations per pixel
//    against 12 bytes read per pixel and the (B, T, 16, Kf) gpack written,
//    so it is bound by bytes.
//  * Backward: a deterministic segmented reduction. Each block walks the
//    DISTINCT winning slots of its 256 pixels in ascending order (a block
//    min per step), reduces each slot's contributions in a fixed order
//    (warp shuffles, then the 8 warp sums in order) into per-block partials
//    (B, T, C, 3, Kf), zero where the block has no pixel; a second kernel
//    sums the C partials in order into rows 9-11 of gpack (B, T, 16, Kf),
//    every other row zero. No atomics on floats. Walking distinct slots, not
//    every slot up to the block's largest, keeps the step count at the few
//    dozen faces a 4 x 64-pixel strip shows, at any Kf.
//  * Exactness: built with -fmad=false. The `e >= 0` inside tests and the
//    strict-> argmax are exact comparisons; an FMA-contracted a*b+c would
//    flip them against the plain version, which never contracts.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 256;  // face slots staged in shared memory per pass
constexpr int kRows = 13;    // A0..Cz and valid

__global__ void __launch_bounds__(kThreads)
depth_fwd_kernel(const float* __restrict__ face_pack,
                 float* __restrict__ depth, int* __restrict__ amax, int T,
                 int g, int tp, int kf, float inv_s) {
  __shared__ float s_face[kRows][kSlots];
  __shared__ int s_nhit;
  const int t = blockIdx.y;
  const size_t tile = (size_t)blockIdx.z * T + t;
  const float* pack = face_pack + tile * 16 * kf;
  if (threadIdx.x == 0) s_nhit = 0;
  __syncthreads();
  int cnt = 0;
  for (int i = threadIdx.x; i < kf; i += kThreads) {
    cnt += pack[12 * kf + i] > 0.5f;
  }
  atomicAdd(&s_nhit, cnt);  // integer sum: order-independent
  __syncthreads();
  const int n_hit = s_nhit;

  const int P = tp * tp;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const float gx = (float)(t % g);
  const float gy = (float)(t / g);
  const float ix = (float)(p % tp);
  const float iy = (float)(p / tp);
  const float ftp = (float)tp;
  const float px = (gx * ftp + ix + 0.5f) * inv_s;
  const float py = (gy * ftp + iy + 0.5f) * inv_s;

  float best = 0.0f;
  int am = -1;
  for (int lo = 0; lo < n_hit; lo += kSlots) {
    const int n = min(kSlots, n_hit - lo);
    __syncthreads();  // the previous pass is done with s_face
    for (int i = threadIdx.x; i < kRows * n; i += kThreads) {
      const int r = i / n;
      const int j = i - r * n;
      s_face[r][j] = pack[r * kf + lo + j];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float e0 = s_face[0][j] * px + s_face[1][j] * py + s_face[2][j];
      const float e1 = s_face[3][j] * px + s_face[4][j] * py + s_face[5][j];
      const float e2 = s_face[6][j] * px + s_face[7][j] * py + s_face[8][j];
      const float invz =
          s_face[9][j] * px + s_face[10][j] * py + s_face[11][j];
      const bool inside = (e0 >= 0.0f) && (e1 >= 0.0f) && (e2 >= 0.0f);
      if (inside && invz > best) {
        best = invz;
        am = lo + j;
      }
    }
  }
  if (p < P) {
    const size_t pix = tile * P + p;
    const bool covered = best > 0.0f;
    depth[pix] = covered ? 1.0f / fmaxf(best, 1e-9f) : 0.0f;
    amax[pix] = covered ? am : -1;
  }
}

__global__ void __launch_bounds__(kThreads)
depth_bwd_partial_kernel(const float* __restrict__ depth,
                         const int* __restrict__ amax,
                         const float* __restrict__ gcot,
                         float* __restrict__ partial, int T, int g, int tp,
                         int kf, float inv_s) {
  __shared__ int s_min[kWarps];
  __shared__ int s_k;
  __shared__ float s_warp[kWarps][3];
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
  float* out = partial + (tile * C + chunk) * 3 * kf;
  for (int i = threadIdx.x; i < 3 * kf; i += kThreads) out[i] = 0.0f;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int last = -1;  // slots <= last are done; uncovered pixels hold -1
  while (true) {
    // The smallest slot not yet reduced, over the block.
    int kk = k_px > last ? k_px : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      kk = min(kk, __shfl_down_sync(0xffffffffu, kk, off));
    }
    if (lane == 0) s_min[warp] = kk;
    __syncthreads();  // also orders the zero fill before the slot writes
    if (threadIdx.x == 0) {
      int m = INT_MAX;
      for (int w = 0; w < kWarps; ++w) m = min(m, s_min[w]);
      s_k = m;
    }
    __syncthreads();
    const int k = s_k;
    if (k == INT_MAX) break;  // block-uniform
    last = k;
    const bool mine = (k_px == k);
    float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f;
    if (__any_sync(0xffffffffu, mine)) {  // warp-uniform branch
      v0 = mine ? c0 : 0.0f;
      v1 = mine ? c1 : 0.0f;
      v2 = mine ? c2 : 0.0f;
      for (int off = 16; off > 0; off >>= 1) {
        v0 += __shfl_down_sync(0xffffffffu, v0, off);
        v1 += __shfl_down_sync(0xffffffffu, v1, off);
        v2 += __shfl_down_sync(0xffffffffu, v2, off);
      }
    }
    if (lane == 0) {
      s_warp[warp][0] = v0;
      s_warp[warp][1] = v1;
      s_warp[warp][2] = v2;
    }
    __syncthreads();
    if (threadIdx.x < 3) {
      float acc = 0.0f;
      for (int w = 0; w < kWarps; ++w) acc += s_warp[w][threadIdx.x];
      out[threadIdx.x * kf + k] = acc;
    }
    // The next step's first barrier keeps s_warp and s_k from being
    // overwritten before they are read.
  }
}

__global__ void depth_bwd_finalize_kernel(const float* __restrict__ partial,
                                          float* __restrict__ gpack, int C,
                                          int kf, size_t n_out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const size_t tile = i / (16 * (size_t)kf);
  const int row = (int)((i / kf) % 16);
  const int k = (int)(i % kf);
  float acc = 0.0f;
  if (row >= 9 && row < 12) {
    const float* src = partial + (tile * C * 3 + (row - 9)) * kf + k;
    for (int c = 0; c < C; ++c) acc += src[(size_t)c * 3 * kf];
  }
  gpack[i] = acc;
}

}  // namespace

// C interface, loaded with ctypes. Each entry point launches on `stream`
// and returns cudaGetLastError() (0 = launched).
extern "C" int depth_fwd(const float* face_pack, float* depth, int* amax,
                         int B, int T, int g, int tp, int kf, float inv_s,
                         void* stream) {
  const dim3 grid((tp * tp + kThreads - 1) / kThreads, T, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  depth_fwd_kernel<<<grid, kThreads, 0, s>>>(face_pack, depth, amax, T, g,
                                             tp, kf, inv_s);
  return (int)cudaGetLastError();
}

extern "C" int depth_bwd(const float* depth, const int* amax,
                         const float* gcot, float* partial, float* gpack,
                         int B, int T, int g, int tp, int kf, int n_chunks,
                         float inv_s, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_chunks, T, B);
  depth_bwd_partial_kernel<<<grid, kThreads, 0, s>>>(depth, amax, gcot,
                                                     partial, T, g, tp, kf,
                                                     inv_s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n_out = (size_t)B * T * 16 * kf;
  const unsigned blocks = (unsigned)((n_out + kThreads - 1) / kThreads);
  depth_bwd_finalize_kernel<<<blocks, kThreads, 0, s>>>(partial, gpack,
                                                        n_chunks, kf, n_out);
  return (int)cudaGetLastError();
}
