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
// What bounds it on the card: per walked (pixel, instance) pair 17 float
// operations, and per contributing pair about 60-80 more plus the sum of
// its 15 terms over the tile's pixels; the bytes are read or written once.
// So it is bound by operations.  In practice: by the contributing pairs'
// instruction chains (three or four IEEE divisions each, which the
// numerics keep), run at the SIMD width of however many of a warp's 32
// pixels an instance touches; by the per-instance reduction over the
// warp's pixels; and by the longest tiles.
//
// Design:
// - One CTA per sub-tile of at most 128 pixels (a 16x32 tile is four 16x8
//   CTAs), one thread per pixel, warps on 4x8 pixel blocks, tiles taken
//   longest first (the pre-pass in blend_common.cuh), 128 threads under
//   matching launch bounds so up to 6 CTAs share an SM.
// - Each warp walks to its own largest n_contrib; the CTA to the largest
//   of its warps.
// - Per instance and warp, a reduce-scatter over the 16 columns: 8 + 4 +
//   2 + 1 + 1 = 16 shuffles leave column lane/2 on each even lane, which
//   stores it to shared memory in one instruction.  Skipped (zeros
//   stored) when no lane contributes.
// - Batches of 64 instances: the table records (16-float, aligned, read
//   as float4) are staged through two buffers with cp.async, the next
//   batch landing while this one is walked; the per-warp partials of a
//   batch (64 x 4 warps x 16 floats) sit in shared memory.  Two barriers
//   per 64 instances.  One fixed-order pass over the warps (a warp past
//   its walk counts as zero and is not read) writes the batch's rows as
//   float4.
// - A tile of several sub-tiles: each CTA writes its rows to its own
//   slice of a scratch table and its walk length to `limits`; the last CTA
//   of the tile to finish (an integer counter) sums the slices in sub-tile
//   order into the output.  No float atomics anywhere, and every sum has a
//   fixed order, so two runs give bit-identical gradients.
// - Pairs whose power is below POWER_CUT skip the exp (they cannot pass
//   the gate).
//
// Numerics: build with --fmad=false and expf, as the forward, so each
// per-pixel term rounds as the plain PyTorch version's ops do; only the
// order of the sums over pixels differs.

#include "blend_common.cuh"

namespace {

using namespace ibgs;

constexpr int BATCH = 64;
constexpr int MAX_CTA = 128;  // threads (pixels) of one sub-tile CTA
constexpr int MAX_WARPS = MAX_CTA / 32;
constexpr int OUT_STRIDE = 16;  // gradient columns FX..FAY and the pad

// Sum over the warp's 32 lanes of each of the 16 columns v[0..15], left
// with column (lane >> 1) on every lane; 16 shuffles, in a fixed order.
__device__ __forceinline__ float reduce_scatter16(const float (&v)[16],
                                                  int lane) {
  float a[8], b[4], c[2];
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4, h2 = lane & 2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float keep = h16 ? v[i + 8] : v[i];
    const float send = h16 ? v[i] : v[i + 8];
    a[i] = keep + __shfl_xor_sync(FULL, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = h8 ? a[i + 4] : a[i];
    const float send = h8 ? a[i] : a[i + 4];
    b[i] = keep + __shfl_xor_sync(FULL, send, 8);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = h4 ? b[i + 2] : b[i];
    const float send = h4 ? b[i] : b[i + 2];
    c[i] = keep + __shfl_xor_sync(FULL, send, 4);
  }
  const float keep = h2 ? c[1] : c[0];
  const float send = h2 ? c[0] : c[1];
  const float d = keep + __shfl_xor_sync(FULL, send, 2);
  return d + __shfl_xor_sync(FULL, d, 1);
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x = a.x + b.x;
  a.y = a.y + b.y;
  a.z = a.z + b.z;
  a.w = a.w + b.w;
}

template <int MODE, int BUF>
__global__ void __launch_bounds__(MAX_CTA,
                                  MODE == MODE_GEO && BUF > 4 ? 4 : 6)
    blend_bwd_kernel(
        const float* __restrict__ feats, int stride,
        const int* __restrict__ tile_start, const int* __restrict__ tile_stop,
        const int* __restrict__ order, SubTile g, float fx, float fy,
        float cx, float cy, float row0, int B,
        const float* __restrict__ color, const float* __restrict__ normal,
        const float* __restrict__ final_t, const int* __restrict__ n_contrib,
        const float* __restrict__ buf_weight,
        const int* __restrict__ buf_contrib,
        const float* __restrict__ d_color, const float* __restrict__ d_normal,
        const float* __restrict__ d_t, const float* __restrict__ d_buf_depth,
        const float* __restrict__ d_buf_weight, float* __restrict__ out,
        float* __restrict__ scratch, int n_rows, int* __restrict__ counters,
        int* __restrict__ limits) {
  constexpr bool GEO = MODE == MODE_GEO;
  __shared__ __align__(16) float sf[2][BATCH * REC];
  __shared__ __align__(16) float part[BATCH * MAX_WARPS * OUT_STRIDE];
  __shared__ int warp_stop[MAX_WARPS];
  __shared__ int s_stop, s_last;

  const int t = order[blockIdx.x / g.splits];
  const int sub = blockIdx.x % g.splits;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  int x, y;
  bool inside;
  sub_pixel(g, t, sub, tid, x, y, inside);
  const float px = (float)x;
  const float py = (float)y + row0;
  const float ray_x = (px - cx) / fx;
  const float ray_y = (py - cy) / fy;
  const int start = tile_start[t];
  const size_t p = inside ? (size_t)y * g.Wp + x : 0;
  const int nc = inside ? n_contrib[p] : 0;

  // walk limits: per warp start + max n_contrib (within the range), per
  // CTA the largest of its warps
  int m = nc;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(FULL, m, o));
  if (lane == 0) warp_stop[warp] = max(start, min(tile_stop[t], start + m));
  __syncthreads();
  if (tid == 0) {
    int mm = start;
    for (int w = 0; w < nwarps; ++w) mm = max(mm, warp_stop[w]);
    s_stop = mm;
  }
  __syncthreads();
  const int cta_stop = s_stop;
  const int my_stop = warp_stop[warp];

  float Tf = 0.f, dLt = 0.f, dLc0 = 0.f, dLc1 = 0.f, dLc2 = 0.f, TOTcn = 0.f;
  float dLn0 = 0.f, dLn1 = 0.f, dLn2 = 0.f, TOTQ = 0.f;
  float dLbd[BUF], dLbw[BUF], gS[BUF];
  int bcN[BUF];
#pragma unroll
  for (int b = 0; b < BUF; ++b) {
    dLbd[b] = dLbw[b] = gS[b] = 0.f;
    bcN[b] = 0;
  }
  if (nc > 0) {
    Tf = final_t[p];
    dLt = d_t[p];
    dLc0 = d_color[3 * p];
    dLc1 = d_color[3 * p + 1];
    dLc2 = d_color[3 * p + 2];
    TOTcn = color[3 * p] * dLc0 + color[3 * p + 1] * dLc1 +
            color[3 * p + 2] * dLc2;
    if (GEO) {
      dLn0 = d_normal[3 * p];
      dLn1 = d_normal[3 * p + 1];
      dLn2 = d_normal[3 * p + 2];
      TOTcn = TOTcn + (normal[3 * p] * dLn0 + normal[3 * p + 1] * dLn1 +
                       normal[3 * p + 2] * dLn2);
#pragma unroll
      for (int b = 0; b < BUF; ++b) {
        if (b < B) {
          dLbd[b] = d_buf_depth[p * B + b];
          dLbw[b] = d_buf_weight[p * B + b];
          gS[b] = dLbw[b] * buf_weight[p * B + b];
          bcN[b] = buf_contrib[p * B + b];
          TOTQ = b == 0 ? gS[0] : TOTQ + gS[b];
        }
      }
    }
  }

  float* dst = g.splits > 1 ? scratch + (size_t)sub * n_rows * OUT_STRIDE
                            : out;
  float T = 1.f, Pc = 0.f, Qle = 0.f;
  const int nb = (cta_stop - start + BATCH - 1) / BATCH;
  if (nb > 0) stage(sf[0], feats, stride, start, min(BATCH, cta_stop - start));
  for (int i = 0; i < nb; ++i) {
    const int base = start + i * BATCH;
    const int n = min(BATCH, cta_stop - base);
    // batch i has landed; batch i-1's buffer and partials are consumed
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < nb) {
      stage(sf[(i + 1) & 1], feats, stride, base + BATCH,
            min(BATCH, cta_stop - base - BATCH));
    }
    const float* buf = sf[i & 1];
    const int kend = min(n, my_stop - base);
    for (int k = 0; k < kend; ++k) {
      const float* f = buf + k * REC;
      const int pos = base + k - start + 1;
      float v[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) v[c] = 0.f;
      bool contrib = false;
      if (pos <= nc) {
        const float4 q0 = *reinterpret_cast<const float4*>(f);  // x y a b
        const float4 q1 =
            *reinterpret_cast<const float4*>(f + 4);  // c op r g
        const float dx = q0.x - px;
        const float dy = q0.y - py;
        const float power =
            -0.5f * (q0.z * dx * dx + q1.x * dy * dy) - q0.w * dx * dy;
        if (!(power < POWER_CUT && q1.y <= 1.f)) {
          const float ge = expf(min_nan(power, 0.f));
          const float raw = q1.y * ge;
          const float alpha = min_nan(ALPHA_CLAMP, raw);
          contrib = power <= 0.f && alpha >= ALPHA_MIN;
          if (contrib) {
            const float4 q2 =
                *reinterpret_cast<const float4*>(f + 8);  // b nx ny nz
            const float w = alpha * T;
            const float om_a = 1.f - alpha;
            float cndl = q1.z * dLc0 + q1.w * dLc1 + q2.x * dLc2;
            if (GEO) cndl = cndl + (q2.y * dLn0 + q2.z * dLn1 + q2.w * dLn2);
            Pc = Pc + w * cndl;
            float dLa = cndl * T - (TOTcn - Pc) / om_a + dLt * (-Tf / om_a);
            if (GEO) {
              float dd = 0.f, gw = 0.f, gq = 0.f;
#pragma unroll
              for (int b = 0; b < BUF; ++b) {
                if (b < B && bcN[b] == pos) {
                  dd = dLbd[b];
                  gw = dLbw[b];
                  gq = gS[b];
                }
              }
              Qle = Qle + gq;
              dLa = dLa + (gw * T - (TOTQ - Qle) / om_a);
              const float inv_den =
                  1.f / (q2.y * ray_x + q2.z * ray_y + q2.w + PLANE_EPS);
              const float coef = dd * f[FD] * inv_den * inv_den;
              v[FNX] = w * dLn0 + coef * ray_x;
              v[FNY] = w * dLn1 + coef * ray_y;
              v[FNZ] = w * dLn2 + coef;
              v[FD] = dd * (-inv_den);
            }
            const float live = raw < ALPHA_CLAMP ? 1.f : 0.f;
            const float gg = ge * q1.y * dLa * live;
            const float dmx = -(q0.z * dx + q0.w * dy) * gg;
            const float dmy = -(q1.x * dy + q0.w * dx) * gg;
            v[FX] = dmx;
            v[FY] = dmy;
            v[FCA] = -0.5f * dx * dx * gg;
            v[FCB] = -dx * dy * gg;
            v[FCC] = -0.5f * dy * dy * gg;
            v[FOP] = ge * dLa * live;
            v[FR] = w * dLc0;
            v[FG] = w * dLc1;
            v[FB] = w * dLc2;
            v[13] = fabsf(dmx);
            v[14] = fabsf(dmy);
            T = T * om_a;
          }
        }
      }
      float r = 0.f;
      if (__any_sync(FULL, contrib)) r = reduce_scatter16(v, lane);
      if (!(lane & 1)) {
        part[(k * MAX_WARPS + warp) * OUT_STRIDE + (lane >> 1)] = r;
      }
    }
    __syncthreads();
    // one fixed-order pass over the warps, one row per instance
    for (int j = tid; j < n * 4; j += blockDim.x) {
      const int k = j >> 2;
      const int q = j & 3;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w = 0; w < nwarps; ++w) {
        if (base + k < warp_stop[w]) {
          add4(acc, *reinterpret_cast<const float4*>(
                        part + (k * MAX_WARPS + w) * OUT_STRIDE + 4 * q));
        }
      }
      *reinterpret_cast<float4*>(dst + (size_t)(base + k) * OUT_STRIDE +
                                 4 * q) = acc;
    }
  }

  if (g.splits == 1) return;
  // The last CTA of the tile sums the sub-tiles' rows, in sub-tile order.
  if (tid == 0) limits[t * g.splits + sub] = cta_stop - start;
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&counters[t], 1) == g.splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  int lim[MAX_SPLITS];
  int rows = 0;
#pragma unroll
  for (int s = 0; s < MAX_SPLITS; ++s) {
    lim[s] = s < g.splits ? __ldcg(limits + t * g.splits + s) : 0;
    rows = max(rows, lim[s]);
  }
  for (int j = tid; j < rows * 4; j += blockDim.x) {
    const int k = j >> 2;
    const int q = j & 3;
    const size_t row = (size_t)(start + k) * OUT_STRIDE + 4 * q;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      if (k < lim[s]) {
        add4(acc, __ldcg(reinterpret_cast<const float4*>(
                      scratch + (size_t)s * n_rows * OUT_STRIDE + row)));
      }
    }
    *reinterpret_cast<float4*>(out + row) = acc;
  }
}

using BwdKernel = void (*)(const float*, int, const int*, const int*,
                           const int*, SubTile, float, float, float, float,
                           float, int, const float*, const float*,
                           const float*, const int*, const float*,
                           const int*, const float*, const float*,
                           const float*, const float*, const float*, float*,
                           float*, int, int*, int*);

BwdKernel bwd_kernel(int mode, int buffer_len) {
  const bool small = buffer_len <= 4;
  switch (mode) {
    case MODE_COLOR:
      return small ? &blend_bwd_kernel<MODE_COLOR, 4>
                   : &blend_bwd_kernel<MODE_COLOR, 8>;
    case MODE_GEO:
      return small ? &blend_bwd_kernel<MODE_GEO, 4>
                   : &blend_bwd_kernel<MODE_GEO, 8>;
    default:
      return nullptr;
  }
}

}  // namespace

// Launches the tile-order pre-pass and the backward on `stream`.  `out` is
// the zeroed (n_rows, 16) gradient table.  `workspace` is scratch of
// num_tiles * (2 + splits) ints: the order, the per-tile counters (cleared
// by the pre-pass) and the per-sub-tile walk lengths.  `scratch` holds
// splits * n_rows * 16 floats when a tile has more than one sub-tile and
// the table has rows, and may be null otherwise.  Returns the CUDA error
// of the launches.
extern "C" int ibgs_blend_bwd(
    const float* feats, int stride, const int* tile_start,
    const int* tile_stop, int tiles_x, int tiles_y, int tile_h, int tile_w,
    int splits_y, int splits_x, float fx, float fy, float cx, float cy,
    float row0, int buffer_len, int mode, const float* color,
    const float* normal, const float* final_t, const int* n_contrib,
    const float* buf_weight, const int* buf_contrib, const float* d_color,
    const float* d_normal, const float* d_t, const float* d_buf_depth,
    const float* d_buf_weight, float* out, float* scratch, int n_rows,
    int* workspace, void* stream) {
  SubTile g;
  const BwdKernel kernel = bwd_kernel(mode, buffer_len);
  if (buffer_len < 1 || buffer_len > MAX_BUFFER || stride < NCH ||
      kernel == nullptr ||
      !make_sub_tile(tiles_x, tile_h, tile_w, splits_y, splits_x, MAX_CTA,
                     &g) ||
      (g.splits > 1 && n_rows > 0 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int num_tiles = tiles_x * tiles_y;
  if (num_tiles == 0) return (int)cudaSuccess;
  int* order = workspace;
  int* counters = workspace + num_tiles;
  int* limits = workspace + 2 * num_tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_tile_order(tile_start, tile_stop, num_tiles, order,
                                      counters, num_tiles, s);
  if (err != cudaSuccess) return (int)err;
  kernel<<<num_tiles * g.splits, cta_threads(g.sub_h, g.sub_w), 0, s>>>(
      feats, stride, tile_start, tile_stop, order, g, fx, fy, cx, cy, row0,
      buffer_len, color, normal, final_t, n_contrib, buf_weight, buf_contrib,
      d_color, d_normal, d_t, d_buf_depth, d_buf_weight, out, scratch,
      n_rows, counters, limits);
  return (int)cudaGetLastError();
}

// The CTA of a sub_h x sub_w sub-tile for the kernel of (mode,
// buffer_len): its threads, and how many such CTAs one SM holds at once.
extern "C" int ibgs_blend_bwd_occupancy(int mode, int buffer_len, int sub_h,
                                        int sub_w, int* blocks,
                                        int* threads) {
  const BwdKernel kernel = bwd_kernel(mode, buffer_len);
  if (kernel == nullptr || sub_h < 1 || sub_w < 1) {
    return (int)cudaErrorInvalidValue;
  }
  *threads = cta_threads(sub_h, sub_w);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                            *threads, 0);
}

extern "C" const char* ibgs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
