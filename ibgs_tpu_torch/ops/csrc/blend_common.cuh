// Shared pieces of the blend kernels (blend_fwd.cu, blend_bwd.cu) for
// NVIDIA Hopper (sm_90a): the instance-table layout and constants, the
// sub-tile geometry that maps a CTA's threads onto a tile's pixels, the
// asynchronous staging of instance records, and the longest-first tile
// order.
#pragma once

#include <cuda_runtime.h>

namespace ibgs {

constexpr int MAX_BUFFER = 8;
constexpr int MAX_SPLITS = 8;   // sub-tile CTAs of one tile
constexpr int REC = 16;         // floats of a staged record: 64 B, 16-B aligned
constexpr unsigned FULL = 0xffffffffu;
// columns of the per-instance table (ibgs_tpu/ops/blend_pallas.py:67)
constexpr int FX = 0, FY = 1, FCA = 2, FCB = 3, FCC = 4, FOP = 5, FR = 6,
              FG = 7, FB = 8, FNX = 9, FNY = 10, FNZ = 11, FD = 12;
constexpr int NCH = FD + 1;     // columns the kernels read

// The JAX package's Python-double constants, rounded to float32 as JAX
// rounds them.
constexpr float ALPHA_CLAMP = (float)0.99;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float T_STOP = (float)1.0e-4;
constexpr float PLANE_EPS = (float)1.0e-8;
// Below this power an instance with opacity <= 1 cannot pass the gate:
// expf(-5.6) = 0.00370 < 1/255 = 0.00392, so op * exp(power) < 1/255.
// Skipping its exp changes no output.
constexpr float POWER_CUT = -5.6f;

enum { MODE_COLOR = 0, MODE_GEO = 1, MODE_DEPTH = 2 };

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

// A tile of tile_h x tile_w pixels is covered by splits_y x splits_x
// sub-tiles of sub_h x sub_w (the last row / column of sub-tiles may be
// cut by the tile's edge); one CTA per sub-tile.
struct SubTile {
  int tiles_x, tile_h, tile_w, sub_h, sub_w, splits_x, splits, Wp;
};

// Threads of a sub-tile CTA: warps take 4x8 pixel blocks where the
// sub-tile allows it, else rows of the sub-tile in order.
__host__ __device__ inline bool warp_blocks(int sub_h, int sub_w) {
  return sub_w % 8 == 0 && sub_h % 4 == 0;
}
__host__ __device__ inline int cta_threads(int sub_h, int sub_w) {
  const int np = sub_h * sub_w;
  return warp_blocks(sub_h, sub_w) ? np : (np + 31) / 32 * 32;
}

// Fills g from the tile shape and the split; false if the split is not
// one the kernel takes (a sub-tile over max_threads threads, an empty
// sub-tile, more than MAX_SPLITS sub-tiles).
inline bool make_sub_tile(int tiles_x, int tile_h, int tile_w, int splits_y,
                          int splits_x, int max_threads, SubTile* g) {
  if (tile_h < 1 || tile_w < 1 || splits_y < 1 || splits_x < 1 ||
      splits_y * splits_x > MAX_SPLITS) {
    return false;
  }
  const int sub_h = (tile_h + splits_y - 1) / splits_y;
  const int sub_w = (tile_w + splits_x - 1) / splits_x;
  if ((splits_y - 1) * sub_h >= tile_h || (splits_x - 1) * sub_w >= tile_w ||
      cta_threads(sub_h, sub_w) > max_threads) {
    return false;
  }
  *g = SubTile{tiles_x, tile_h, tile_w, sub_h, sub_w, splits_x,
               splits_y * splits_x, tiles_x * tile_w};
  return true;
}

// Image pixel of thread `tid` of sub-tile `s` of tile `t`; `inside` is
// false for threads past the tile's edge or the sub-tile's pixels.
__device__ __forceinline__ void sub_pixel(const SubTile& g, int t, int s,
                                          int tid, int& x, int& y,
                                          bool& inside) {
  int ly, lx;
  if (warp_blocks(g.sub_h, g.sub_w)) {
    const int warp = tid >> 5, lane = tid & 31, per_row = g.sub_w >> 3;
    ly = (warp / per_row) * 4 + (lane >> 3);
    lx = (warp % per_row) * 8 + (lane & 7);
  } else {
    ly = tid / g.sub_w;
    lx = tid - ly * g.sub_w;
  }
  const int ty = (s / g.splits_x) * g.sub_h + ly;
  const int tx = (s % g.splits_x) * g.sub_w + lx;
  inside = ly < g.sub_h && ty < g.tile_h && tx < g.tile_w;
  x = (t % g.tiles_x) * g.tile_w + tx;
  y = (t / g.tiles_x) * g.tile_h + ty;
}

// ---- asynchronous staging (cp.async, sm_80+) ------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts copying rows [base, base + n) of the table, their 13 read columns
// each, into 16-float records at dst.  The table's rows are 15 floats
// (60 B, not 16-B aligned), so the gather is 4-byte copies; the records
// land aligned, and are read back as float4.  Complete once the issuing
// thread has passed cp_async_wait_all() and the block a barrier.
__device__ __forceinline__ void stage(float* dst, const float* feats,
                                      int stride, int base, int n) {
  for (int j = threadIdx.x; j < n * NCH; j += blockDim.x) {
    const int k = j / NCH;
    const int c = j - k * NCH;
    cp_async4(dst + k * REC + c, feats + (size_t)(base + k) * stride + c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// ---- longest-first tile order ---------------------------------------------

constexpr int ORDER_KEYS = 129;

// Sort key of a range length: 4 buckets per octave, longest first, empty
// ranges last.
__device__ __forceinline__ int order_key(int len) {
  if (len <= 0) return ORDER_KEYS - 1;
  const int e = 31 - __clz(len);
  const int m = e >= 2 ? (len >> (e - 2)) & 3 : (len << (2 - e)) & 3;
  return (31 - e) * 4 + (3 - m);
}

// One block: order[] lists the tiles by falling range length (a counting
// sort on order_key; the order inside a bucket is not fixed, and changes
// no output), and zero[0..n_zero) is cleared for the kernel that follows.
__global__ void __launch_bounds__(1024) tile_order_kernel(
    const int* __restrict__ tile_start, const int* __restrict__ tile_stop,
    int num_tiles, int* __restrict__ order, int* __restrict__ zero,
    int n_zero) {
  __shared__ int slot[ORDER_KEYS];
  for (int i = threadIdx.x; i < ORDER_KEYS; i += blockDim.x) slot[i] = 0;
  for (int i = threadIdx.x; i < n_zero; i += blockDim.x) zero[i] = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < num_tiles; t += blockDim.x) {
    atomicAdd(&slot[order_key(tile_stop[t] - tile_start[t])], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int i = 0; i < ORDER_KEYS; ++i) {
      const int c = slot[i];
      slot[i] = run;
      run += c;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < num_tiles; t += blockDim.x) {
    order[atomicAdd(&slot[order_key(tile_stop[t] - tile_start[t])], 1)] = t;
  }
}

inline cudaError_t launch_tile_order(const int* tile_start,
                                     const int* tile_stop, int num_tiles,
                                     int* order, int* zero, int n_zero,
                                     cudaStream_t s) {
  tile_order_kernel<<<1, 1024, 0, s>>>(tile_start, tile_stop, num_tiles,
                                       order, zero, n_zero);
  return cudaGetLastError();
}

}  // namespace ibgs
