// Blend forward for NVIDIA Hopper (sm_90a).
//
// Replaces ibgs_tpu/ops/blend_pallas.py `_fwd_kernel` (the Pallas TPU
// kernel behind `blend_packed`).  It computes the same function with the
// per-pixel sequential semantics of ibgs_tpu/ops/blend_oracle.py:
// front-to-back alpha compositing of each tile's depth-sorted instances,
// alpha = min(0.99, op * exp(min(power, 0))), the gate
// power <= 0 && alpha >= 1/255, an exclusive stop once T * (1 - alpha)
// < 1e-4 (the crossing instance is excluded and ends the pixel), and the
// two-part median buffer (circular "before" part of ceil(B/2) slots while
// T > 0.5, write-once "below" part after, plane depth -d / (n.ray + 1e-8)
// taken only if > 0, last writer wins per slot).  In depth-only mode a
// pixel stops once the below part fills; the filling instance counts.
//
// What bounds it on the card: the work is a data-dependent sequential
// scan, about 30-45 float operations for every (pixel, instance) pair a
// pixel walks before it saturates; the bytes are small (the instance table
// is read once per tile, the outputs written once).  So it is bound by
// operations and by latency of the dependent chain, not by memory.
//
// Design: one CTA per tile, one thread per pixel.  The tile's instances
// are staged through shared memory in batches of 256 x 13 floats, so each
// instance is read from device memory once per tile and then broadcast to
// every pixel.  All per-pixel state (T, colour, normal, last contributor,
// buffer pointers and the <= 8 buffer slots) lives in registers; buffer
// slots are selected with unrolled compile-time loops so they never spill
// to local memory.  The block leaves the instance loop early once every
// pixel is done (__syncthreads_count).  Outputs are written straight into
// (Hp, Wp, C) image layout.  The TPU kernel's 128-instance sublane prefix
// products, packed rank scans and DMA drain are TPU devices and are not
// carried over.
//
// Numerics: build with --fmad=false (no multiply-add contraction) and use
// expf, so every float op rounds as the plain PyTorch version's ops do and
// the threshold tests (alpha >= 1/255, T * (1 - alpha) < 1e-4, T > 0.5)
// decide identically.  min() propagates NaN like jnp.minimum.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_BUFFER = 8;
constexpr int BATCH = 256;
// columns of the per-instance table (ibgs_tpu/ops/blend_pallas.py:67)
constexpr int FX = 0, FY = 1, FCA = 2, FCB = 3, FCC = 4, FOP = 5, FR = 6,
              FG = 7, FB = 8, FNX = 9, FNY = 10, FNZ = 11, FD = 12;
constexpr int NCH = FD + 1;

// The JAX package's Python-double constants, rounded to float32 as JAX
// rounds them.
constexpr float ALPHA_CLAMP = (float)0.99;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float T_STOP = (float)1.0e-4;
constexpr float PLANE_EPS = (float)1.0e-8;

enum { MODE_COLOR = 0, MODE_GEO = 1, MODE_DEPTH = 2 };

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

template <int MODE>
__global__ void __launch_bounds__(1024) blend_fwd_kernel(
    const float* __restrict__ feats, int stride,
    const int* __restrict__ tile_start, const int* __restrict__ tile_stop,
    int tiles_x, int tile_h, int tile_w, int Wp,
    float fx, float fy, float cx, float cy, float row0, int B,
    float* __restrict__ color, float* __restrict__ normal,
    float* __restrict__ final_t, int* __restrict__ n_contrib,
    float* __restrict__ buf_depth, float* __restrict__ buf_weight,
    int* __restrict__ buf_contrib) {
  __shared__ float sf[BATCH * NCH];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int x = (t % tiles_x) * tile_w + tid % tile_w;
  const int y = (t / tiles_x) * tile_h + tid / tile_w;
  const float px = (float)x;
  const float py = (float)y + row0;
  const float ray_x = (px - cx) / fx;
  const float ray_y = (py - cy) / fy;
  const int start = tile_start[t];
  const int stop = tile_stop[t];
  const int before_cap = (B + 1) / 2;
  const int below_cap = B - before_cap;

  float T = 1.f;
  bool done = false;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, n0 = 0.f, n1 = 0.f, n2 = 0.f;
  int last = 0, before_ptr = 0, below_cnt = 0;
  float bd[MAX_BUFFER], bw[MAX_BUFFER];
  int bc[MAX_BUFFER];
#pragma unroll
  for (int s = 0; s < MAX_BUFFER; ++s) {
    bd[s] = 0.f;
    bw[s] = 0.f;
    bc[s] = 0;
  }

  for (int base = start; base < stop; base += BATCH) {
    // Block-wide early exit, and the barrier that keeps the previous batch
    // in shared memory until every thread is past it.
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(BATCH, stop - base);
    for (int j = tid; j < n * NCH; j += blockDim.x) {
      const int k = j / NCH;
      sf[j] = feats[(size_t)(base + k) * stride + (j - k * NCH)];
    }
    __syncthreads();
    if (done) continue;
    for (int k = 0; k < n; ++k) {
      const float* f = sf + k * NCH;
      const float dx = f[FX] - px;
      const float dy = f[FY] - py;
      const float power =
          -0.5f * (f[FCA] * dx * dx + f[FCC] * dy * dy) - f[FCB] * dx * dy;
      const float alpha =
          min_nan(ALPHA_CLAMP, f[FOP] * expf(min_nan(power, 0.f)));
      if (!(power <= 0.f && alpha >= ALPHA_MIN)) continue;
      const float test_t = T * (1.f - alpha);
      if (test_t < T_STOP) {
        done = true;
        break;
      }
      const float a_t = alpha * T;
      const int pos = base + k - start + 1;
      bool fill = false;
      if (MODE != MODE_DEPTH) {
        c0 = c0 + f[FR] * a_t;
        c1 = c1 + f[FG] * a_t;
        c2 = c2 + f[FB] * a_t;
      }
      if (MODE != MODE_COLOR) {
        const float denom =
            f[FNX] * ray_x + f[FNY] * ray_y + f[FNZ] + PLANE_EPS;
        const float depth = -f[FD] / denom;
        if (depth > 0.f) {
          int slot = -1;
          if (T > 0.5f) {
            slot = before_ptr;
            before_ptr = (before_ptr + 1) % before_cap;
          } else if (below_cnt < below_cap) {
            slot = before_cap + below_cnt;
            ++below_cnt;
          }
#pragma unroll
          for (int s = 0; s < MAX_BUFFER; ++s) {
            if (s == slot) {
              bd[s] = depth;
              bw[s] = a_t;
              bc[s] = pos;
            }
          }
          fill = MODE == MODE_DEPTH && below_cnt == below_cap;
        }
      }
      if (MODE == MODE_GEO) {
        n0 = n0 + f[FNX] * a_t;
        n1 = n1 + f[FNY] * a_t;
        n2 = n2 + f[FNZ] * a_t;
      }
      T = test_t;
      last = pos;
      if (fill) {
        done = true;
        break;
      }
    }
  }

  const size_t p = (size_t)y * Wp + x;
  color[3 * p + 0] = c0;
  color[3 * p + 1] = c1;
  color[3 * p + 2] = c2;
  normal[3 * p + 0] = n0;
  normal[3 * p + 1] = n1;
  normal[3 * p + 2] = n2;
  final_t[p] = T;
  n_contrib[p] = last;
#pragma unroll
  for (int s = 0; s < MAX_BUFFER; ++s) {
    if (s < B) {
      buf_depth[p * B + s] = bd[s];
      buf_weight[p * B + s] = bw[s];
      buf_contrib[p * B + s] = bc[s];
    }
  }
}

}  // namespace

extern "C" int ibgs_blend_fwd(
    const float* feats, int stride, const int* tile_start,
    const int* tile_stop, int tiles_x, int tiles_y, int tile_h, int tile_w,
    float fx, float fy, float cx, float cy, float row0, int buffer_len,
    int mode, float* color, float* normal, float* final_t, int* n_contrib,
    float* buf_depth, float* buf_weight, int* buf_contrib, void* stream) {
  if (buffer_len < 1 || buffer_len > MAX_BUFFER || tile_h * tile_w > 1024 ||
      stride < NCH) {
    return (int)cudaErrorInvalidValue;
  }
  const int num_tiles = tiles_x * tiles_y;
  if (num_tiles == 0) return (int)cudaSuccess;
  const int Wp = tiles_x * tile_w;
  const dim3 grid(num_tiles), block(tile_h * tile_w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IBGS_LAUNCH(M)                                                       \
  blend_fwd_kernel<M><<<grid, block, 0, s>>>(                                \
      feats, stride, tile_start, tile_stop, tiles_x, tile_h, tile_w, Wp, fx, \
      fy, cx, cy, row0, buffer_len, color, normal, final_t, n_contrib,       \
      buf_depth, buf_weight, buf_contrib)
  switch (mode) {
    case MODE_COLOR: IBGS_LAUNCH(MODE_COLOR); break;
    case MODE_GEO: IBGS_LAUNCH(MODE_GEO); break;
    case MODE_DEPTH: IBGS_LAUNCH(MODE_DEPTH); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef IBGS_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" const char* ibgs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
