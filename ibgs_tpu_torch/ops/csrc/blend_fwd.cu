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
// What bounds it on the card: a data-dependent sequential scan, 17 float
// operations for every (pixel, instance) pair a pixel walks and about 30
// more where the instance contributes; the bytes (the table read once per
// tile, the outputs written once) are small.  So it is bound by
// operations: by issuing each pair's instructions, which the exact
// float32 arithmetic (no contraction, IEEE division, expf) keeps long and
// warp divergence between contributing and passing pixels makes longer,
// and by the longest tiles, since tile ranges are skewed (at 960x544 the
// longest range is 8x the median) and one CTA walks a whole range.
//
// Design:
// - One CTA per sub-tile of at most 256 pixels (a 16x32 tile is two 16x16
//   CTAs), one thread per pixel, warps on 4x8 pixel blocks.  Each CTA walks
//   the tile's whole range, positions counted from the tile's start, and
//   leaves as soon as its own pixels are done; a tile's halves run on two
//   SMs at once.  256-thread CTAs under matching launch bounds, the buffer
//   slots templated on B <= 4 or <= 8: 4-7 CTAs share an SM.
// - Longest first: a one-block pre-pass (blend_common.cuh) lists the tiles
//   by falling range length, and CTA i takes work item i of that list.  The
//   block scheduler hands out CTAs in index order, so the longest tiles
//   start first and the short ones fill the tail.
// - Instances are staged in batches of 256 through two shared buffers with
//   cp.async: batch i+1 lands while batch i is blended, one barrier per
//   batch.  Each record is 16 floats, aligned, read as float4 (the gate
//   needs two loads, a contributing pair three) instead of 13 scalar loads.
// - Work that cannot change an output is skipped: the exp of a pair whose
//   power is below POWER_CUT (it cannot pass the gate), and in render_geo
//   the plane depth and its division once the pixel's buffer can take no
//   more entries (T <= 0.5 and the below part full).
// Numerics: build with --fmad=false (no multiply-add contraction) and use
// expf, so every float op rounds as the plain PyTorch version's ops do and
// the threshold tests (alpha >= 1/255, T * (1 - alpha) < 1e-4, T > 0.5)
// decide identically.  min() propagates NaN like jnp.minimum.

#include "blend_common.cuh"

namespace {

using namespace ibgs;

constexpr int BATCH = 256;
constexpr int MAX_CTA = 256;  // threads (pixels) of one sub-tile CTA

template <int MODE, int BUF>
__global__ void __launch_bounds__(MAX_CTA, BUF <= 4 ? 4 : 3) blend_fwd_kernel(
    const float* __restrict__ feats, int stride,
    const int* __restrict__ tile_start, const int* __restrict__ tile_stop,
    const int* __restrict__ order, SubTile g, float fx, float fy, float cx,
    float cy, float row0, int B, float* __restrict__ color,
    float* __restrict__ normal, float* __restrict__ final_t,
    int* __restrict__ n_contrib, float* __restrict__ buf_depth,
    float* __restrict__ buf_weight, int* __restrict__ buf_contrib) {
  __shared__ __align__(16) float sf[2][BATCH * REC];

  const int t = order[blockIdx.x / g.splits];
  int x, y;
  bool inside;
  sub_pixel(g, t, blockIdx.x % g.splits, threadIdx.x, x, y, inside);
  const float px = (float)x;
  const float py = (float)y + row0;
  const float ray_x = (px - cx) / fx;
  const float ray_y = (py - cy) / fy;
  const int start = tile_start[t];
  const int stop = tile_stop[t];
  const int before_cap = (B + 1) / 2;
  const int below_cap = B - before_cap;

  float T = 1.f;
  bool done = !inside;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, n0 = 0.f, n1 = 0.f, n2 = 0.f;
  int last = 0, before_ptr = 0, below_cnt = 0;
  float bd[BUF], bw[BUF];
  int bc[BUF];
#pragma unroll
  for (int s = 0; s < BUF; ++s) {
    bd[s] = 0.f;
    bw[s] = 0.f;
    bc[s] = 0;
  }

  const int nb = stop > start ? (stop - start + BATCH - 1) / BATCH : 0;
  if (nb > 0) stage(sf[0], feats, stride, start, min(BATCH, stop - start));
  for (int i = 0; i < nb; ++i) {
    const int base = start + i * BATCH;
    const int n = min(BATCH, stop - base);
    // Batch i has landed, every thread is past batch i-1 (so its buffer
    // may be refilled), and the block leaves once all its pixels are done.
    cp_async_wait_all();
    if (__syncthreads_count(!done) == 0) break;
    if (i + 1 < nb) {
      stage(sf[(i + 1) & 1], feats, stride, base + BATCH,
            min(BATCH, stop - base - BATCH));
    }
    if (done) continue;
    const float* buf = sf[i & 1];
    for (int k = 0; k < n; ++k) {
      const float* f = buf + k * REC;
      const float4 q0 = *reinterpret_cast<const float4*>(f);      // x y a b
      const float4 q1 = *reinterpret_cast<const float4*>(f + 4);  // c op r g
      const float dx = q0.x - px;
      const float dy = q0.y - py;
      const float power =
          -0.5f * (q0.z * dx * dx + q1.x * dy * dy) - q0.w * dx * dy;
      if (power < POWER_CUT && q1.y <= 1.f) continue;
      const float alpha =
          min_nan(ALPHA_CLAMP, q1.y * expf(min_nan(power, 0.f)));
      if (!(power <= 0.f && alpha >= ALPHA_MIN)) continue;
      const float test_t = T * (1.f - alpha);
      if (test_t < T_STOP) {
        done = true;
        break;
      }
      const float4 q2 = *reinterpret_cast<const float4*>(f + 8);  // b nx ny nz
      const float a_t = alpha * T;
      const int pos = base + k - start + 1;
      bool fill = false;
      if (MODE != MODE_DEPTH) {
        c0 = c0 + q1.z * a_t;
        c1 = c1 + q1.w * a_t;
        c2 = c2 + q2.x * a_t;
      }
      // The plane depth (an IEEE division) is needed only where it can take
      // a buffer slot, or in depth-only mode fill the buffer; once a pixel's
      // buffer is settled its later contributors skip it.
      if (MODE == MODE_DEPTH ||
          (MODE == MODE_GEO && (T > 0.5f || below_cnt < below_cap))) {
        const float denom = q2.y * ray_x + q2.z * ray_y + q2.w + PLANE_EPS;
        const float depth = -f[FD] / denom;
        if (depth > 0.f) {
          int slot = -1;
          if (T > 0.5f) {
            slot = before_ptr;
            before_ptr = before_ptr + 1 == before_cap ? 0 : before_ptr + 1;
          } else if (below_cnt < below_cap) {
            slot = before_cap + below_cnt;
            ++below_cnt;
          }
#pragma unroll
          for (int s = 0; s < BUF; ++s) {
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
        n0 = n0 + q2.y * a_t;
        n1 = n1 + q2.z * a_t;
        n2 = n2 + q2.w * a_t;
      }
      T = test_t;
      last = pos;
      if (fill) {
        done = true;
        break;
      }
    }
  }

  if (!inside) return;
  const size_t p = (size_t)y * g.Wp + x;
  color[3 * p + 0] = c0;
  color[3 * p + 1] = c1;
  color[3 * p + 2] = c2;
  normal[3 * p + 0] = n0;
  normal[3 * p + 1] = n1;
  normal[3 * p + 2] = n2;
  final_t[p] = T;
  n_contrib[p] = last;
#pragma unroll
  for (int s = 0; s < BUF; ++s) {
    if (s < B) {
      buf_depth[p * B + s] = bd[s];
      buf_weight[p * B + s] = bw[s];
      buf_contrib[p * B + s] = bc[s];
    }
  }
}

// The kernel of one (mode, buffer length), or nullptr.
using FwdKernel = void (*)(const float*, int, const int*, const int*,
                           const int*, SubTile, float, float, float, float,
                           float, int, float*, float*, float*, int*, float*,
                           float*, int*);

FwdKernel fwd_kernel(int mode, int buffer_len) {
  const bool small = buffer_len <= 4;
  switch (mode) {
    case MODE_COLOR:
      return small ? &blend_fwd_kernel<MODE_COLOR, 4>
                   : &blend_fwd_kernel<MODE_COLOR, 8>;
    case MODE_GEO:
      return small ? &blend_fwd_kernel<MODE_GEO, 4>
                   : &blend_fwd_kernel<MODE_GEO, 8>;
    case MODE_DEPTH:
      return small ? &blend_fwd_kernel<MODE_DEPTH, 4>
                   : &blend_fwd_kernel<MODE_DEPTH, 8>;
    default:
      return nullptr;
  }
}

}  // namespace

// Launches the tile-order pre-pass and the blend on `stream`.  `order` is
// scratch of tiles_x * tiles_y ints.  Returns the CUDA error of the
// launches (0 = success).
extern "C" int ibgs_blend_fwd(
    const float* feats, int stride, const int* tile_start,
    const int* tile_stop, int tiles_x, int tiles_y, int tile_h, int tile_w,
    int splits_y, int splits_x, float fx, float fy, float cx, float cy,
    float row0, int buffer_len, int mode, float* color, float* normal,
    float* final_t, int* n_contrib, float* buf_depth, float* buf_weight,
    int* buf_contrib, int* order, void* stream) {
  SubTile g;
  const FwdKernel kernel = fwd_kernel(mode, buffer_len);
  if (buffer_len < 1 || buffer_len > MAX_BUFFER || stride < NCH ||
      kernel == nullptr ||
      !make_sub_tile(tiles_x, tile_h, tile_w, splits_y, splits_x, MAX_CTA,
                     &g)) {
    return (int)cudaErrorInvalidValue;
  }
  const int num_tiles = tiles_x * tiles_y;
  if (num_tiles == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      launch_tile_order(tile_start, tile_stop, num_tiles, order, nullptr, 0, s);
  if (err != cudaSuccess) return (int)err;
  kernel<<<num_tiles * g.splits, cta_threads(g.sub_h, g.sub_w), 0, s>>>(
      feats, stride, tile_start, tile_stop, order, g, fx, fy, cx, cy, row0,
      buffer_len, color, normal, final_t, n_contrib, buf_depth, buf_weight,
      buf_contrib);
  return (int)cudaGetLastError();
}

// The CTA of a sub_h x sub_w sub-tile for the kernel of (mode,
// buffer_len): its threads, and how many such CTAs one SM holds at once.
extern "C" int ibgs_blend_fwd_occupancy(int mode, int buffer_len, int sub_h,
                                        int sub_w, int* blocks,
                                        int* threads) {
  const FwdKernel kernel = fwd_kernel(mode, buffer_len);
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
