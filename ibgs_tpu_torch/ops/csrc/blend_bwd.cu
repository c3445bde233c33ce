// Blend backward for NVIDIA Hopper (sm_90a).
//
// Replaces ibgs_tpu/ops/blend_pallas.py `_bwd_kernel` (the Pallas TPU
// kernel behind the VJP of `blend_packed`).  It computes the analytic VJP
// of the blend forward (blend_fwd.cu) for the colour-only and render_geo
// modes; depth_only has no backward.  Per tile it re-walks the instances
// forward, carrying T, the colour+normal prefix Pc and the buffer prefix
// Qle.  The suffix sums of the alpha recursion are the saved totals
// (TOTcn = colour.dLc + normal.dLn, TOTQ = sum_b dLbw*bw) minus the
// inclusive prefix, so it never divides by T.  An instance contributes at
// a pixel where it passes the alpha gate, lies in the tile's range and
// sits at or before the pixel's saved n_contrib (not the forward's T test
// redone, which could flip at ulp-level ties).  The alpha gradient is
// gated at the 0.99 clamp; median-buffer gradients reach only the exact
// buffer entry (buf_contrib == position).  Each instance gets one
// 16-column row: dmean x/y, dconic a/b/c, dopacity, drgb, dnormal, ddist,
// sum over pixels of |dmean x| and |dmean y|, and a zero pad.
//
// What bounds it on the card: per (pixel, instance) pair up to the
// pixel's last contributor it does about 70 float operations, plus a
// per-instance reduction over the tile's pixels; the bytes (instance
// table in, saved outputs and cotangents in, gradient rows out) are read
// or written once.  So it is bound by operations, and in this first
// version by the reductions and barriers.
//
// Design: one CTA per tile (at most 512 pixels), one thread per pixel.  A
// block reduction of the saved n_contrib bounds the walk at
// start + max(n_contrib).  Each thread keeps its saved outputs and
// cotangents in registers (512 threads leave it 128).  Instances
// are staged through shared memory in batches of 16; every thread walks
// them in order, so the carries need no scan.  The 15 terms of each
// instance are reduced deterministically: a butterfly warp-shuffle sum
// (skipped when no lane of the warp contributes), the per-warp partials in
// shared memory, then one fixed-order pass over the warps and one
// coalesced write of the batch's rows.  No float atomics: two runs give
// bit-identical gradients.  The TPU kernel's 128-sublane prefix scans,
// DMA read-modify-write pipeline and chunk drains are not carried over.
//
// Numerics: build with --fmad=false and expf, as the forward, so each
// per-pixel term rounds as the plain PyTorch version's ops do; only the
// order of the sums over pixels differs.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_BUFFER = 8;
constexpr int BATCH = 16;
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// columns of the per-instance table (ibgs_tpu/ops/blend_pallas.py:67)
constexpr int FX = 0, FY = 1, FCA = 2, FCB = 3, FCC = 4, FOP = 5, FR = 6,
              FG = 7, FB = 8, FNX = 9, FNY = 10, FNZ = 11, FD = 12;
constexpr int NCH = FD + 1;      // columns read
constexpr int NCOL = 15;         // gradient columns FX..FAY
constexpr int OUT_STRIDE = 16;   // FX..FPAD

constexpr float ALPHA_CLAMP = (float)0.99;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float PLANE_EPS = (float)1.0e-8;

enum { MODE_COLOR = 0, MODE_GEO = 1 };

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

template <int MODE>
__global__ void __launch_bounds__(MAX_THREADS) blend_bwd_kernel(
    const float* __restrict__ feats, int stride,
    const int* __restrict__ tile_start, const int* __restrict__ tile_stop,
    int tiles_x, int tile_h, int tile_w, int Wp,
    float fx, float fy, float cx, float cy, float row0, int B,
    const float* __restrict__ color, const float* __restrict__ normal,
    const float* __restrict__ final_t, const int* __restrict__ n_contrib,
    const float* __restrict__ buf_weight, const int* __restrict__ buf_contrib,
    const float* __restrict__ d_color, const float* __restrict__ d_normal,
    const float* __restrict__ d_t, const float* __restrict__ d_buf_depth,
    const float* __restrict__ d_buf_weight, float* __restrict__ out) {
  constexpr bool GEO = MODE == MODE_GEO;
  __shared__ float sf[BATCH * NCH];
  __shared__ float part[BATCH][MAX_WARPS][OUT_STRIDE];
  __shared__ int warp_max[MAX_WARPS];
  __shared__ int s_stop;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int x = (t % tiles_x) * tile_w + tid % tile_w;
  const int y = (t / tiles_x) * tile_h + tid / tile_w;
  const float px = (float)x;
  const float py = (float)y + row0;
  const float ray_x = (px - cx) / fx;
  const float ray_y = (py - cy) / fy;
  const int start = tile_start[t];
  const size_t p = (size_t)y * Wp + x;
  const int nc = n_contrib[p];

  // stop_eff = min(stop, start + max n_contrib over the tile)
  int m = nc;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(FULL, m, o));
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (tid == 0) {
    int mm = 0;
    for (int w = 0; w < nwarps; ++w) mm = max(mm, warp_max[w]);
    s_stop = min(tile_stop[t], start + mm);
  }
  __syncthreads();
  const int stop_eff = s_stop;
  if (stop_eff <= start) return;

  const float Tf = final_t[p];
  const float dLt = d_t[p];
  const float dLc0 = d_color[3 * p], dLc1 = d_color[3 * p + 1],
              dLc2 = d_color[3 * p + 2];
  float TOTcn = color[3 * p] * dLc0 + color[3 * p + 1] * dLc1 +
                color[3 * p + 2] * dLc2;
  float dLn0 = 0.f, dLn1 = 0.f, dLn2 = 0.f, TOTQ = 0.f;
  float dLbd[MAX_BUFFER], dLbw[MAX_BUFFER], gS[MAX_BUFFER];
  int bcN[MAX_BUFFER];
#pragma unroll
  for (int b = 0; b < MAX_BUFFER; ++b) {
    dLbd[b] = dLbw[b] = gS[b] = 0.f;
    bcN[b] = 0;
  }
  if (GEO) {
    dLn0 = d_normal[3 * p];
    dLn1 = d_normal[3 * p + 1];
    dLn2 = d_normal[3 * p + 2];
    TOTcn = TOTcn + (normal[3 * p] * dLn0 + normal[3 * p + 1] * dLn1 +
                     normal[3 * p + 2] * dLn2);
#pragma unroll
    for (int b = 0; b < MAX_BUFFER; ++b) {
      if (b < B) {
        dLbd[b] = d_buf_depth[p * B + b];
        dLbw[b] = d_buf_weight[p * B + b];
        gS[b] = dLbw[b] * buf_weight[p * B + b];
        bcN[b] = buf_contrib[p * B + b];
        TOTQ = b == 0 ? gS[0] : TOTQ + gS[b];
      }
    }
  }

  float T = 1.f, Pc = 0.f, Qle = 0.f;
  for (int base = start; base < stop_eff; base += BATCH) {
    const int n = min(BATCH, stop_eff - base);
    __syncthreads();  // the previous batch's sf and part are consumed
    for (int j = tid; j < n * NCH; j += blockDim.x) {
      const int k = j / NCH;
      sf[j] = feats[(size_t)(base + k) * stride + (j - k * NCH)];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float* f = sf + k * NCH;
      const int pos = base + k - start + 1;
      float v[NCOL];
#pragma unroll
      for (int c = 0; c < NCOL; ++c) v[c] = 0.f;
      bool contrib = false;
      if (pos <= nc) {
        const float dx = f[FX] - px;
        const float dy = f[FY] - py;
        const float power =
            -0.5f * (f[FCA] * dx * dx + f[FCC] * dy * dy) - f[FCB] * dx * dy;
        const float g = expf(min_nan(power, 0.f));
        const float raw = f[FOP] * g;
        const float alpha = min_nan(ALPHA_CLAMP, raw);
        contrib = power <= 0.f && alpha >= ALPHA_MIN;
        if (contrib) {
          const float w = alpha * T;
          const float om_a = 1.f - alpha;
          float cndl = f[FR] * dLc0 + f[FG] * dLc1 + f[FB] * dLc2;
          if (GEO) cndl = cndl + (f[FNX] * dLn0 + f[FNY] * dLn1 + f[FNZ] * dLn2);
          Pc = Pc + w * cndl;
          float dLa = cndl * T - (TOTcn - Pc) / om_a + dLt * (-Tf / om_a);
          if (GEO) {
            float dd = 0.f, gw = 0.f, gq = 0.f;
#pragma unroll
            for (int b = 0; b < MAX_BUFFER; ++b) {
              if (b < B && bcN[b] == pos) {
                dd = dLbd[b];
                gw = dLbw[b];
                gq = gS[b];
              }
            }
            Qle = Qle + gq;
            dLa = dLa + (gw * T - (TOTQ - Qle) / om_a);
            const float inv_den =
                1.f / (f[FNX] * ray_x + f[FNY] * ray_y + f[FNZ] + PLANE_EPS);
            const float coef = dd * f[FD] * inv_den * inv_den;
            v[FNX] = w * dLn0 + coef * ray_x;
            v[FNY] = w * dLn1 + coef * ray_y;
            v[FNZ] = w * dLn2 + coef;
            v[FD] = dd * (-inv_den);
          }
          const float live = raw < ALPHA_CLAMP ? 1.f : 0.f;
          const float gg = g * f[FOP] * dLa * live;
          const float dmx = -(f[FCA] * dx + f[FCB] * dy) * gg;
          const float dmy = -(f[FCC] * dy + f[FCB] * dx) * gg;
          v[FX] = dmx;
          v[FY] = dmy;
          v[FCA] = -0.5f * dx * dx * gg;
          v[FCB] = -dx * dy * gg;
          v[FCC] = -0.5f * dy * dy * gg;
          v[FOP] = g * dLa * live;
          v[FR] = w * dLc0;
          v[FG] = w * dLc1;
          v[FB] = w * dLc2;
          v[13] = fabsf(dmx);
          v[14] = fabsf(dmy);
          T = T * om_a;
        }
      }
      if (__any_sync(FULL, contrib)) {
#pragma unroll
        for (int c = 0; c < NCOL; ++c) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            v[c] = v[c] + __shfl_xor_sync(FULL, v[c], o);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < NCOL; ++c) part[k][warp][c] = v[c];
      }
    }
    __syncthreads();
    // one fixed-order pass over the warps, one row per instance
    for (int j = tid; j < n * OUT_STRIDE; j += blockDim.x) {
      const int k = j / OUT_STRIDE;
      const int c = j - k * OUT_STRIDE;
      float s = 0.f;
      if (c < NCOL) {
        for (int w = 0; w < nwarps; ++w) s = s + part[k][w][c];
      }
      out[(size_t)base * OUT_STRIDE + j] = s;
    }
  }
}

}  // namespace

extern "C" int ibgs_blend_bwd(
    const float* feats, int stride, const int* tile_start,
    const int* tile_stop, int tiles_x, int tiles_y, int tile_h, int tile_w,
    float fx, float fy, float cx, float cy, float row0, int buffer_len,
    int mode, const float* color, const float* normal, const float* final_t,
    const int* n_contrib, const float* buf_weight, const int* buf_contrib,
    const float* d_color, const float* d_normal, const float* d_t,
    const float* d_buf_depth, const float* d_buf_weight, float* out,
    void* stream) {
  const int np = tile_h * tile_w;
  if (buffer_len < 1 || buffer_len > MAX_BUFFER || np > MAX_THREADS || np % 32 ||
      np == 0 || stride < NCH) {
    return (int)cudaErrorInvalidValue;
  }
  const int num_tiles = tiles_x * tiles_y;
  if (num_tiles == 0) return (int)cudaSuccess;
  const int Wp = tiles_x * tile_w;
  const dim3 grid(num_tiles), block(np);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IBGS_LAUNCH(M)                                                       \
  blend_bwd_kernel<M><<<grid, block, 0, s>>>(                                \
      feats, stride, tile_start, tile_stop, tiles_x, tile_h, tile_w, Wp, fx, \
      fy, cx, cy, row0, buffer_len, color, normal, final_t, n_contrib,       \
      buf_weight, buf_contrib, d_color, d_normal, d_t, d_buf_depth,          \
      d_buf_weight, out)
  switch (mode) {
    case MODE_COLOR: IBGS_LAUNCH(MODE_COLOR); break;
    case MODE_GEO: IBGS_LAUNCH(MODE_GEO); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef IBGS_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" const char* ibgs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
