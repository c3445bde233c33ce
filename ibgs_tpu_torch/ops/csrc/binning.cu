// Staircase tile binning for NVIDIA Hopper (sm_90a): the depth order, the
// per-Gaussian row and instance counts with their offsets, the instance
// emission, the tile sort and the tile ranges of the port's
// `bin_splats(staircase=True)`.
//
// Replaces no TPU kernel: the JAX package bins with XLA ops,
// ibgs_tpu/ops/binning.py `bin_splats` (its staircase path and
// `_staircase_row_interval`).  The port's plain version,
// ibgs_tpu_torch/ops/binning.py `bin_staircase_plain`, is a chain of about
// 50 elementwise torch ops over every tile row, two `repeat_interleave`
// expansions, two library sorts and four host syncs a render (two totals
// to size the lists, two host copies for `seg_off`): about 200 device
// events.  These kernels compute the same TileBins, bit for bit, in 10
// launches beside the workspace's zero fill and one host read: 12 device
// events a render at the port's grids (up to 65,536 tiles).
//
// For depth rank r (Gaussian g = order[r]) with tile rectangle
// [rx, rx+rw) x [ry, ry+rh) (rh = 0 where g is culled) and cull row (mean
// x, mean y, conic a, b, c, threshold), tile row ty = ry + j keeps the
// tile-column interval [lo, lo+w) of `_staircase_row_interval`: the
// closed-form u-extent of {q(u, v) <= thr} over the row's pixel band,
// widened by 1e-3 + 1e-3·|x| for float32 safety; a degenerate conic keeps
// the whole rectangle row.  Rows are numbered over all ranks in depth
// order; rows at or past `row_cap` (0 = no cap) are dropped.  Each kept
// row's tiles take consecutive slots, Gaussians in depth order, rows in
// order, tiles left to right; slots at or past `cap` are dropped.
//
//   (zeros)     one zeroed workspace: the totals, the scans' and sort
//               passes' state, the digit counts
//   bin_key     the depth key (depth, +inf where culled) as ordered bits
//               and the counts of its four 8-bit digits
//   bin_radix   x4: the stable depth sort, a digit a launch: the order
//   bin_count   one thread per depth rank: rows rh, their offsets (a scan),
//               the kept rows and their instance count w summed, the
//               instance offsets seg_off (a second scan), the two totals
//               and a flag for a rectangle outside the grid; both scans
//               are chained across CTAs inside this kernel
//   (host)      the totals and the flag read back: the layer's one sync,
//               which sizes the instance list
//   bin_emit    one thread per depth rank: each kept slot's tile id and
//               depth rank, truncated at cap, and the tile ids' digit
//               counts; zeroes the tile sort's state
//   bin_radix   x1-2: the stable sort of the tile ids (as many digits as
//               the largest tile id has): the slot permutation
//   bin_ranges  one thread per sorted instance and per tile: rank,
//               gauss_id, tile_id, inst_valid, and tile_start as
//               searchsorted(side="left") by binary search
//
// bin_radix is one pass of a least-significant-digit radix sort in the
// "onesweep" form: every pass's digit counts come from the kernel that
// wrote the keys; a pass's CTA ranks its 4,096 consecutive items by digit
// (warp-synchronous matching, each warp over consecutive items, so equal
// digits keep their order and the sort is stable), takes each digit's
// offset from the earlier CTAs' published counts and scatters its keys
// and values once.  Depth keys map float order onto unsigned order (one
// NaN after +inf, -0 equal to +0, as the plain version's stable sort
// orders them).  Chained scans and sort passes publish per CTA a count
// flagged as the CTA's own (aggregate) or as everything up to it
// (inclusive); a CTA sums its predecessors' words back to the nearest
// inclusive one (decoupled look-back).  Their CTAs take ids from a ticket
// counter in launch order, so every CTA waited on is resident.
//
// What bounds it on the card: bytes and latency.  bin_count and bin_emit
// read a Gaussian's 45 input bytes (order, tile count, rectangle, cull
// row) and do about 60 float operations per tile row; a sort pass reads
// and writes 8 bytes an item (the last one 12); bin_emit writes 8 bytes a
// slot and bin_ranges reads 16 and writes 25 bytes an instance.  A thread
// walks its Gaussian's rows in a loop, so one large Gaussian holds its
// warp.
//
// Numerics: built with --fmad=false and IEEE division and square root,
// every float op of the plain version's interval in its order, as PyTorch
// runs them on the card: a division by a Python scalar is a multiply by
// its float reciprocal (the tile width), clamp propagates NaN, and
// float -> int32 maps NaN to 0 and saturates (`to_i32`).  The integer
// sums are exact.  No float atomics; repeats are bit-identical.
//
// The per-item work is in HD functions, so a host build of this file
// (without __CUDACC__) runs the same items in sequence on the CPU: the
// `ibgs_bin_*_host` entries, which the CPU tests hold to the plain version
// with a stable sort of the same keys between them.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int DIGITS = 256;             // 8-bit digits
constexpr int RADIX_ITEMS = 16;         // items per thread of a sort pass
constexpr int RADIX_TILE = THREADS * RADIX_ITEMS;
constexpr int LOOK_BACK = 16;         // earlier CTAs' words read at once
constexpr int DEPTH_PASSES = 4;
constexpr int MAX_PASSES = 4;
constexpr float WIDEN = (float)1e-3;
constexpr float BIG = (float)(1 << 24);
constexpr unsigned long long AGGREGATE = 1ULL << 62;
constexpr unsigned long long INCLUSIVE = 2ULL << 62;
constexpr unsigned long long VALUE = (1ULL << 62) - 1;

struct Inputs {
  const long long* order;  // (P,) depth order (bin_count, bin_emit)
  const int* n_tiles;      // (P,)
  const int* rect_min;     // (P, 2) x, y
  const int* rect_max;     // (P, 2)
  const float* cull;       // (P, 6)
  long long P;
  int tiles_x, tiles_y, tile_h, tile_w;
  float inv_tw;            // 1 / tile_w in float32, as PyTorch divides
  long long row_cap;       // 0 = no cap
};

// float clamp with tensor bounds, NaN in any operand giving NaN
HD float clamp_nan(float v, float lo, float hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}

// `to_i32(torch.clamp(x, lo, BIG))` as int64: NaN -> 0
HD long long tile_index(float x, float lo) {
  if (isnan(x)) return 0;
  return (long long)(int)fminf(fmaxf(x, lo), BIG);
}

HD long long sub_i32(int a, int b) {  // int32 difference, wrapping
  return (long long)(int)((unsigned)a - (unsigned)b);
}

// One Gaussian's staircase: its rectangle and the row-independent part of
// `_staircase_row_interval`.
struct Stair {
  long long rx, ry, rw, rh;
  float mx, my, cb, ca_s, det_s, vstar, two_ca_thr;
  bool safe;
};

HD Stair stair_of(const Inputs& in, long long g) {
  Stair s;
  const int* mn = in.rect_min + 2 * g;
  const int* mx = in.rect_max + 2 * g;
  s.rx = mn[0];
  s.ry = mn[1];
  const long long w = sub_i32(mx[0], mn[0]);
  s.rw = w < 1 ? 1 : w;
  // (a negative height, which the plain version refuses, counts as 0:
  // the scans' published sums stay non-negative)
  const long long h = in.n_tiles[g] > 0 ? sub_i32(mx[1], mn[1]) : 0;
  s.rh = h > 0 ? h : 0;
  const float* c = in.cull + 6 * g;
  s.mx = c[0];
  s.my = c[1];
  const float ca = c[2], cb = c[3], cc = c[4], thr = c[5];
  const float thr_m = thr + (WIDEN + WIDEN * fabsf(thr));
  const float det = ca * cc - cb * cb;
  s.safe = (ca > 0.0f) && (cc > 0.0f) && (det > 0.0f) && (thr_m > 0.0f);
  s.cb = cb;
  s.ca_s = s.safe ? ca : 1.0f;
  const float cc_s = s.safe ? cc : 1.0f;
  s.det_s = s.safe ? det : 1.0f;
  const float thr_s = s.safe ? thr_m : 1.0f;
  s.vstar = -cb * sqrtf(2.0f * thr_s / (cc_s * s.det_s));
  s.two_ca_thr = 2.0f * s.ca_s * thr_s;
  return s;
}

// Whether a Gaussian's rows lie inside the grid (their tile ids are then
// in [0, tiles_x * tiles_y)).
HD bool inside_grid(const Inputs& in, const Stair& s) {
  return s.rh == 0 || (s.rx >= 0 && s.rx + s.rw <= in.tiles_x &&
                       s.ry >= 0 && s.ry + s.rh <= in.tiles_y);
}

// The kept tile-column interval [*lo, *lo + *w) of tile row ty.
HD void row_interval(const Inputs& in, const Stair& s, long long ty,
                     long long* lo_out, long long* w_out) {
  if (!s.safe) {
    *lo_out = s.rx;
    *w_out = s.rw;
    return;
  }
  const float v_lo = (float)(ty * in.tile_h) - s.my;
  const float v_hi = v_lo + (float)(in.tile_h - 1);
  const float v_at_max = clamp_nan(s.vstar, v_lo, v_hi);
  const float v_at_min = clamp_nan(-s.vstar, v_lo, v_hi);
  const float disc_max = s.two_ca_thr - s.det_s * v_at_max * v_at_max;
  const float disc_min = s.two_ca_thr - s.det_s * v_at_min * v_at_min;
  const bool hit = disc_max >= 0.0f;
  // clamp(x, min=0) propagates NaN
  const float r_max =
      sqrtf(isnan(disc_max) ? disc_max : fmaxf(disc_max, 0.0f));
  const float r_min =
      sqrtf(isnan(disc_min) ? disc_min : fmaxf(disc_min, 0.0f));
  float u_max = (-s.cb * v_at_max + r_max) / s.ca_s;
  float u_min = (-s.cb * v_at_min - r_min) / s.ca_s;
  u_max = u_max + (WIDEN + WIDEN * fabsf(u_max));
  u_min = u_min - (WIDEN + WIDEN * fabsf(u_min));
  const float lo_f =
      ceilf((s.mx + u_min - (float)(in.tile_w - 1)) * in.inv_tw);
  const float hi_f = floorf((s.mx + u_max) * in.inv_tw);
  const long long tx_lo = tile_index(lo_f, -1.0f);
  const long long tx_hi = tile_index(hi_f, -2.0f);
  const long long lo = tx_lo > s.rx ? tx_lo : s.rx;
  const long long last = s.rx + s.rw - 1;
  const long long hi = tx_hi < last ? tx_hi : last;
  const long long w = hi - lo + 1;
  *lo_out = lo;
  *w_out = hit ? (w > 0 ? w : 0) : 0;
}

// Rows of a depth rank kept under row_cap, given its first row's index.
HD long long kept_rows(const Inputs& in, long long rh, long long row_off) {
  if (in.row_cap <= 0) return rh;
  const long long room = in.row_cap - row_off;
  return room <= 0 ? 0 : (room < rh ? room : rh);
}

// The instances of a rank's kept rows.
HD long long count_of(const Inputs& in, const Stair& s, long long kept) {
  long long n = 0;
  for (long long j = 0; j < kept; ++j) {
    long long lo, w;
    row_interval(in, s, s.ry + j, &lo, &w);
    n += w;
  }
  return n;
}

HD void add_count(int* c, int v) {
#ifdef __CUDA_ARCH__
  atomicAdd(c, v);
#else
  *c += v;
#endif
}

// Adds the digits of the tile ids [t0, t0 + w) to a sort's digit counts
// (passes x 256; on the card in shared memory): the lowest digit as a
// difference array (+1 where a run of consecutive digits starts, -1 past
// its end; a sort pass sums it), each higher one as the run's overlap
// with each of its values.  A few additions a row, however many tiles it
// has.
HD void count_run(int* hist, int passes, long long t0, long long w) {
  const long long full = w / DIGITS, rem = w % DIGITS;
  const int lo = (int)(t0 & 255);
  if (full) add_count(&hist[0], (int)full);
  if (rem) {
    add_count(&hist[lo], 1);
    const long long end = lo + rem;
    if (end < DIGITS) {
      add_count(&hist[end], -1);
    } else if (end > DIGITS) {  // wraps past digit 255
      add_count(&hist[0], 1);
      add_count(&hist[end - DIGITS], -1);
    }
  }
  for (int p = 1; p < passes; ++p) {
    const int sh = 8 * p;
    for (long long v = t0 >> sh; v <= (t0 + w - 1) >> sh; ++v) {
      const long long a = v << sh > t0 ? v << sh : t0;
      const long long b = (v + 1) << sh < t0 + w ? (v + 1) << sh : t0 + w;
      add_count(&hist[p * DIGITS + (int)(v & 255)], (int)(b - a));
    }
  }
}

// Writes a rank's slots [base, min(base + its count, n)): tile id and
// rank r, and counts the tile ids' digits of `passes` passes in hist (see
// count_run).
HD void emit_of(const Inputs& in, const Stair& s, long long kept,
                long long r, long long base, long long n, uint32_t* tile,
                int* rank, int* hist, int passes) {
  long long slot = base;
  for (long long j = 0; j < kept && slot < n; ++j) {
    long long lo, w;
    const long long ty = s.ry + j;
    row_interval(in, s, ty, &lo, &w);
    const long long t0 = ty * in.tiles_x + lo;
    if (w > n - slot) w = n - slot;
    if (w > 0) count_run(hist, passes, t0, w);
    for (long long k = 0; k < w; ++k, ++slot) {
      tile[slot] = (uint32_t)(t0 + k);
      rank[slot] = (int)r;
    }
  }
}

// searchsorted(side="left") of probe p in the sorted tile ids
HD long long lower_bound(const uint32_t* tile, long long n, long long p) {
  long long a = 0, b = n;
  while (a < b) {
    const long long m = a + (b - a) / 2;
    if ((long long)tile[m] < p) a = m + 1; else b = m;
  }
  return a;
}

// Sorted instance i (i < n) and probe i (i <= num_tiles).
HD void ranges_item(long long i, const uint32_t* tile_sorted,
                    const long long* perm, const int* slot_rank,
                    const long long* order, long long n, int num_tiles,
                    long long* rank, long long* gauss_id, long long* tile_id,
                    uint8_t* valid, int* start) {
  if (i < n) {
    const long long rk = slot_rank[perm[i]];
    const uint32_t t = tile_sorted[i];
    rank[i] = rk;
    gauss_id[i] = order[rk];
    tile_id[i] = t;
    valid[i] = t < (uint32_t)num_tiles;
  }
  if (i <= num_tiles) {
    long long s = lower_bound(tile_sorted, n, i);
    if (i == num_tiles && s > n) s = n;
    start[i] = (int)s;
  }
}

HD uint32_t float_bits(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(f);
#else
  uint32_t u;
  memcpy(&u, &f, sizeof(u));
  return u;
#endif
}

// The depth key (depth, +inf where culled) as bits whose unsigned order
// is the float order: one NaN after +inf, -0 the same key as +0.
HD uint32_t depth_bits(float depth, int n_tiles) {
  const float k = n_tiles > 0 ? depth : INFINITY;
  uint32_t u = float_bits(k);
  if (isnan(k)) u = 0x7fc00000u;
  else if (u == 0x80000000u) u = 0;
  return u ^ ((u & 0x80000000u) ? 0xffffffffu : 0x80000000u);
}

HD long long ceil_div(long long a, long long b) {
  const long long q = (a + b - 1) / b;
  return q > 0 ? q : 1;
}

HD long long blocks_of(long long items) { return ceil_div(items, THREADS); }

HD long long radix_ctas(long long items) {
  return ceil_div(items, RADIX_TILE);
}

// 8-bit digits of the largest of num_tiles tile ids (1 to MAX_PASSES).
HD int tile_passes(long long num_tiles) {
  int p = 1;
  while (p < MAX_PASSES && ((num_tiles - 1) >> (8 * p)) != 0) ++p;
  return p;
}

// Words of one sort pass's state: its ticket and its CTAs' digit counts.
HD long long pass_words(long long ctas) { return 1 + ctas * DIGITS; }

// The workspace in 64-bit words, all zero before bin_key: the totals
// (rows, instances, the out-of-grid flag), bin_count's ticket and two
// chained scans, the depth keys' and the tile ids' digit counts, and the
// depth sort passes' state.
struct Layout {
  long long scan_blocks, scan, depth_hist, tile_hist, depth_state, words;
  HD Layout(long long P) {
    scan_blocks = blocks_of(P);
    scan = 3;
    depth_hist = scan + 1 + 2 * scan_blocks;
    tile_hist = depth_hist + DEPTH_PASSES * DIGITS;
    depth_state = tile_hist + MAX_PASSES * DIGITS;
    words = depth_state + DEPTH_PASSES * pass_words(radix_ctas(P));
  }
};

Inputs make_inputs(const long long* order, const int* n_tiles,
                   const int* rect_min, const int* rect_max,
                   const float* cull, long long P, int tiles_x, int tiles_y,
                   int tile_h, int tile_w, long long row_cap) {
  Inputs in;
  in.order = order;
  in.n_tiles = n_tiles;
  in.rect_min = rect_min;
  in.rect_max = rect_max;
  in.cull = cull;
  in.P = P;
  in.tiles_x = tiles_x;
  in.tiles_y = tiles_y;
  in.tile_h = tile_h;
  in.tile_w = tile_w;
  in.inv_tw = 1.0f / (float)tile_w;
  in.row_cap = row_cap;
  return in;
}

#ifdef __CUDACC__

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = THREADS / 32;

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// Adds a CTA's digit counts (s_hist: passes x 256; bin_emit's lowest
// digit a difference array, whose entries may be negative) to the global
// ones (two's complement: the sums come out right).
__device__ void flush_hist(const int* s_hist, int passes,
                           unsigned long long* hist) {
  __syncthreads();
  for (int i = threadIdx.x; i < passes * DIGITS; i += THREADS)
    if (s_hist[i])
      atomicAdd(hist + i, (unsigned long long)(long long)s_hist[i]);
}

__global__ void __launch_bounds__(THREADS)
bin_key_kernel(const float* depth, const int* n_tiles, long long P,
               uint32_t* keys, unsigned long long* hist, long long stride) {
  __shared__ int s_hist[DEPTH_PASSES * DIGITS];
  for (int i = threadIdx.x; i < DEPTH_PASSES * DIGITS; i += THREADS)
    s_hist[i] = 0;
  __syncthreads();
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < P;
       i += stride) {
    const uint32_t u = depth_bits(depth[i], n_tiles[i]);
    keys[i] = u;
    for (int p = 0; p < DEPTH_PASSES; ++p)
      atomicAdd(&s_hist[p * DIGITS + ((u >> (8 * p)) & 255u)], 1);
  }
  flush_hist(s_hist, DEPTH_PASSES, hist);
}

// Exclusive block scan of v; *total gets the block's sum.
__device__ long long block_scan(long long v, long long* total,
                                long long* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long t = lane < WARPS ? sh[lane] : 0;
    for (int o = 1; o < WARPS; o <<= 1) {
      const long long y = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t += y;
    }
    if (lane < WARPS) sh[lane] = t;
  }
  __syncthreads();
  const long long before = warp > 0 ? sh[warp - 1] : 0;
  *total = sh[WARPS - 1];
  __syncthreads();
  return before + x - v;
}

// CTA b's count in its word of a chained sequence, then its exclusive
// prefix (the sum of the earlier CTAs' words back to the nearest
// inclusive one; `stride` words apart, read LOOK_BACK at a time), after
// which its inclusive prefix is published.  One thread per sequence (a
// sort pass's digit).
__device__ long long chain_one(unsigned long long* words, long long b,
                               long long stride, long long count) {
  unsigned long long* mine = words + b * stride;
  if (b == 0) {
    atomicExch(mine, INCLUSIVE | (unsigned long long)count);
    return 0;
  }
  atomicExch(mine, AGGREGATE | (unsigned long long)count);
  long long prefix = 0;
  bool done = false;
  for (long long top = b - 1; !done; top -= LOOK_BACK) {
    unsigned long long w[LOOK_BACK];
#pragma unroll
    for (int j = 0; j < LOOK_BACK; ++j)
      w[j] = top - j >= 0
                 ? *(const volatile unsigned long long*)(words +
                                                         (top - j) * stride)
                 : INCLUSIVE;  // before CTA 0: an empty prefix
#pragma unroll
    for (int j = 0; j < LOOK_BACK; ++j) {
      if (done) continue;
      while ((w[j] & ~VALUE) == 0)
        w[j] = *(const volatile unsigned long long*)(words +
                                                     (top - j) * stride);
      prefix += (long long)(w[j] & VALUE);
      done = (w[j] & ~VALUE) == INCLUSIVE;
    }
  }
  atomicExch(mine, INCLUSIVE | (unsigned long long)(prefix + count));
  return prefix;
}

// Chained scan across CTAs: CTA b's exclusive prefix, to every thread.
// Warp 0 reads the earlier CTAs' words 32 at a time.
__device__ long long chain(unsigned long long* words, long long b,
                           long long aggregate, long long* sh) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    long long prefix = 0;
    if (lane == 0)
      atomicExch(words + b, (b == 0 ? INCLUSIVE : AGGREGATE) |
                                (unsigned long long)aggregate);
    for (long long top = b - 1; top >= 0; top -= 32) {
      const long long idx = top - lane;
      unsigned long long s = INCLUSIVE;  // before CTA 0: an empty prefix
      if (idx >= 0) {
        const volatile unsigned long long* q = words + idx;
        do { s = *q; } while ((s & ~VALUE) == 0);
      }
      const unsigned incl =
          __ballot_sync(FULL, (s & ~VALUE) == INCLUSIVE);
      const int nearest = incl ? __ffs(incl) - 1 : 31;
      long long v = lane <= nearest ? (long long)(s & VALUE) : 0;
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
      prefix += v;
      if (incl) break;
    }
    if (lane == 0) {
      if (b > 0)
        atomicExch(words + b,
                   INCLUSIVE | (unsigned long long)(prefix + aggregate));
      sh[0] = prefix;
    }
  }
  __syncthreads();
  const long long prefix = sh[0];
  __syncthreads();
  return prefix;
}

struct Pass {
  const uint32_t* keys_in;
  const int* vals_in;                // null: the item's index
  long long n;
  int shift;
  const unsigned long long* hist;    // the pass's 256 digit counts
  bool delta;                        // hist is a difference array
  unsigned long long* state;         // ticket, ctas x 256 digit counts
  uint32_t* keys_out;                // null: not written
};

// One stable radix sort pass (see the head of the file).  The CTA's
// items are staged in shared memory in their sorted order, so each
// digit's run is written out by consecutive threads.
template <typename VOut>
__global__ void __launch_bounds__(THREADS)
bin_radix_kernel(Pass a, VOut* vals_out) {
  __shared__ unsigned s_cnt[WARPS][DIGITS];
  __shared__ long long s_base[DIGITS];
  __shared__ long long s_local[DIGITS];
  __shared__ uint32_t s_keys[RADIX_TILE];
  __shared__ int s_vals[RADIX_TILE];
  __shared__ long long sh[WARPS];
  __shared__ long long s_id;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < WARPS * DIGITS; i += THREADS)
    (&s_cnt[0][0])[i] = 0;
  if (threadIdx.x == 0) s_id = (long long)atomicAdd(a.state, 1ULL);
  __syncthreads();
  const long long b = s_id;
  const long long base = b * RADIX_TILE;
  const int first = warp * 32 * RADIX_ITEMS + lane;  // within the tile
  const unsigned below = (1u << lane) - 1;
  uint32_t key[RADIX_ITEMS];
  unsigned rank[RADIX_ITEMS];
  // each warp ranks its 512 consecutive items, 32 at a time, by digit
#pragma unroll
  for (int it = 0; it < RADIX_ITEMS; ++it) {
    const long long i = base + first + it * 32;
    const bool live = i < a.n;
    key[it] = live ? a.keys_in[i] : 0;
    const unsigned d = live ? (key[it] >> a.shift) & 255u : DIGITS + lane;
    const unsigned peers = __match_any_sync(FULL, d);
    const int leader = __ffs(peers) - 1;
    unsigned before = 0;
    if (live && lane == leader) {
      before = s_cnt[warp][d];
      s_cnt[warp][d] = before + __popc(peers);
    }
    before = __shfl_sync(FULL, before, leader);
    __syncwarp();
    rank[it] = before + __popc(peers & below);
  }
  __syncthreads();
  // thread d: the warps' offsets for digit d within the CTA, the CTA's
  // count, the digit's start within the CTA and over all items
  const int d = threadIdx.x;
  unsigned count = 0;
  for (int w = 0; w < WARPS; ++w) {
    const unsigned c = s_cnt[w][d];
    s_cnt[w][d] = count;
    count += c;
  }
  long long total;
  s_local[d] = block_scan(count, &total, sh);
  long long all = (long long)a.hist[d];
  if (a.delta) all += block_scan(all, &total, sh);
  const long long start = block_scan(all, &total, sh);
  // the items in their sorted order within the CTA
#pragma unroll
  for (int it = 0; it < RADIX_ITEMS; ++it) {
    const long long i = base + first + it * 32;
    if (i < a.n) {
      const unsigned dd = (key[it] >> a.shift) & 255u;
      const int local = (int)s_local[dd] + s_cnt[warp][dd] + rank[it];
      s_keys[local] = key[it];
      s_vals[local] = a.vals_in ? a.vals_in[i] : (int)i;
    }
  }
  // the earlier CTAs' counts of digit d
  s_base[d] = start + chain_one(a.state + 1 + d, b, DIGITS, count) -
              s_local[d];
  __syncthreads();
  const long long left = a.n - base;
  const int items = left < RADIX_TILE ? (int)left : RADIX_TILE;
  for (int j = threadIdx.x; j < items; j += THREADS) {
    const uint32_t k = s_keys[j];
    const long long pos = s_base[(k >> a.shift) & 255u] + j;
    if (a.keys_out) a.keys_out[pos] = k;
    vals_out[pos] = (VOut)s_vals[j];
  }
}

__global__ void __launch_bounds__(THREADS)
bin_count_kernel(Inputs in, unsigned long long* ws, long long* seg_off,
                 int* kept_out) {
  __shared__ long long sh[WARPS];
  __shared__ long long s_id;
  const Layout L(in.P);
  if (threadIdx.x == 0) s_id = (long long)atomicAdd(ws + L.scan, 1ULL);
  __syncthreads();
  const long long b = s_id;
  unsigned long long* rows_st = ws + L.scan + 1;
  unsigned long long* inst_st = rows_st + L.scan_blocks;
  const long long r = b * THREADS + threadIdx.x;
  const bool live = r < in.P;
  Stair s = {};
  if (live) s = stair_of(in, in.order[r]);
  if (live && !inside_grid(in, s)) atomicOr(ws + 2, 1ULL);
  long long agg;
  const long long row_excl = block_scan(s.rh, &agg, sh);
  const long long row_prefix = chain(rows_st, b, agg, sh);
  long long kept = 0, count = 0;
  if (live) {
    kept = kept_rows(in, s.rh, row_prefix + row_excl);
    count = count_of(in, s, kept);
  }
  const long long rows_total = row_prefix + agg;
  const long long inst_excl = block_scan(count, &agg, sh);
  const long long inst_prefix = chain(inst_st, b, agg, sh);
  if (live) {
    seg_off[r] = inst_prefix + inst_excl;
    kept_out[r] = (int)kept;
  }
  if (b == L.scan_blocks - 1 && threadIdx.x == 0) {
    ws[0] = (unsigned long long)rows_total;
    ws[1] = (unsigned long long)(inst_prefix + agg);
    seg_off[in.P] = inst_prefix + agg;
  }
}

__global__ void __launch_bounds__(THREADS)
bin_emit_kernel(Inputs in, const long long* seg_off, const int* kept,
                long long n, uint32_t* tile, int* rank,
                unsigned long long* hist, int passes,
                unsigned long long* state, long long state_words,
                long long stride) {
  __shared__ int s_hist[MAX_PASSES * DIGITS];
  for (int i = threadIdx.x; i < MAX_PASSES * DIGITS; i += THREADS)
    s_hist[i] = 0;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < state_words; i += stride)
    state[i] = 0;
  __syncthreads();
  for (long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
       r < in.P; r += stride) {
    if (seg_off[r] >= n || kept[r] == 0) continue;
    const Stair s = stair_of(in, in.order[r]);
    emit_of(in, s, kept[r], r, seg_off[r], n, tile, rank, s_hist, passes);
  }
  flush_hist(s_hist, passes, hist);
}

__global__ void __launch_bounds__(THREADS)
bin_ranges_kernel(const uint32_t* tile_sorted, const long long* perm,
                  const int* slot_rank, const long long* order, long long n,
                  int num_tiles, long long* rank, long long* gauss_id,
                  long long* tile_id, uint8_t* valid, int* start) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  ranges_item(i, tile_sorted, perm, slot_rank, order, n, num_tiles, rank,
              gauss_id, tile_id, valid, start);
}

typedef const void* KernelPtr;

KernelPtr kernel_for(int which) {
  switch (which) {
    case 0: return (KernelPtr)bin_key_kernel;
    case 1: return (KernelPtr)bin_radix_kernel<int>;
    case 2: return (KernelPtr)bin_count_kernel;
    case 3: return (KernelPtr)bin_emit_kernel;
    case 4: return (KernelPtr)bin_ranges_kernel;
    default: return nullptr;
  }
}

bool grid_ok(long long blocks) { return blocks <= 0x7fffffffLL; }

bool args_ok(long long P, int tiles_x, int tiles_y, int tile_h, int tile_w) {
  return P >= 0 && P < 0x7fffffffLL && tiles_x > 0 && tiles_y > 0 &&
         tile_h > 0 && tile_w > 0 &&
         (long long)tiles_x * tiles_y < 0x7fffffffLL;
}

// A grid-stride kernel's CTAs: enough to fill the card, at most one per
// THREADS items.
long long strided_blocks(long long items) {
  const long long b = blocks_of(items), cap = 4LL * sm_count();
  return b < cap ? b : cap;
}

// `passes` stable radix passes over n keys (pass p: digit p, counts
// hist[p], state `pass_words` apart): keys ping-pong between a and b, the
// values start as the items' indices; the last pass writes keys_out (if
// not null) and the int64 values out.
int sort_passes(long long n, int passes, const unsigned long long* hist,
                bool delta, unsigned long long* state, uint32_t* ka,
                uint32_t* kb, int* va, int* vb, uint32_t* keys_out,
                long long* vals_out, cudaStream_t stream) {
  const long long ctas = radix_ctas(n);
  if (!grid_ok(ctas)) return (int)cudaErrorInvalidValue;
  for (int p = 0; p < passes; ++p) {
    const bool even = p % 2 == 0, last = p == passes - 1;
    Pass a;
    a.keys_in = even ? ka : kb;
    a.vals_in = p == 0 ? nullptr : (even ? va : vb);
    a.n = n;
    a.shift = 8 * p;
    a.hist = hist + p * DIGITS;
    a.delta = delta && p == 0;
    a.state = state + p * pass_words(ctas);
    a.keys_out = last ? keys_out : (even ? kb : ka);
    if (last)
      bin_radix_kernel<long long><<<(unsigned)ctas, THREADS, 0, stream>>>(
          a, vals_out);
    else
      bin_radix_kernel<int><<<(unsigned)ctas, THREADS, 0, stream>>>(
          a, even ? vb : va);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

#endif  // __CUDACC__

}  // namespace

// 64-bit words of the workspace for P Gaussians (zeroed by the caller).
extern "C" long long ibgs_bin_workspace_words(long long P) {
  return Layout(P).words;
}

// Radix passes of the tile sort for num_tiles tiles.
extern "C" int ibgs_bin_tile_passes(int num_tiles) {
  return tile_passes(num_tiles);
}

// 64-bit words of the tile sort's state for n instances on num_tiles tiles
// (bin_emit zeroes them).
extern "C" long long ibgs_bin_tile_state_words(long long n, int num_tiles) {
  return tile_passes(num_tiles) * pass_words(radix_ctas(n));
}

#ifdef __CUDACC__

// Each entry returns the CUDA error of its launches (0 = success).
//
// depth (P,) float32, n_tiles (P,) int32, ws the zeroed workspace →
// bin_key (keys_a: the depth keys) and the four depth sort passes →
// order (P,) int64.  keys_b, vals_a, vals_b: (P,) scratch.
extern "C" int ibgs_bin_order(const float* depth, const int* n_tiles,
                              long long P, unsigned long long* ws,
                              uint32_t* keys_a, uint32_t* keys_b, int* vals_a,
                              int* vals_b, long long* order, void* stream) {
  if (P < 0 || P >= 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout L(P);
  const long long blocks = strided_blocks(P);
  bin_key_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(
      depth, n_tiles, P, keys_a, ws + L.depth_hist, blocks * THREADS);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sort_passes(P, DEPTH_PASSES, ws + L.depth_hist, false,
                     ws + L.depth_state,
                     keys_a, keys_b, vals_a, vals_b, nullptr, order, st);
}

// order (P,) int64, n_tiles (P,) int32, rect_min / rect_max (P, 2) int32,
// cull (P, 6) float32, ws → seg_off (P + 1,) int64, kept rows (P,) int32,
// and in ws[0..2] the rows, the instances (both before the caps) and 1
// where a rectangle with rows lies outside the tiles_x x tiles_y grid.
extern "C" int ibgs_bin_count(const long long* order, const int* n_tiles,
                              const int* rect_min, const int* rect_max,
                              const float* cull, long long P, int tiles_x,
                              int tiles_y, int tile_h, int tile_w,
                              long long row_cap, unsigned long long* ws,
                              long long* seg_off, int* kept, void* stream) {
  if (!args_ok(P, tiles_x, tiles_y, tile_h, tile_w))
    return (int)cudaErrorInvalidValue;
  const Inputs in = make_inputs(order, n_tiles, rect_min, rect_max, cull, P,
                                tiles_x, tiles_y, tile_h, tile_w, row_cap);
  const long long blocks = blocks_of(P);
  if (!grid_ok(blocks)) return (int)cudaErrorInvalidValue;
  bin_count_kernel<<<(unsigned)blocks, THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(in, ws, seg_off,
                                                          kept);
  return (int)cudaGetLastError();
}

// bin_count's inputs and outputs, n = the kept slots → tile (n,) uint32
// tile ids and rank (n,) int32 depth ranks in slot order, the tile ids'
// digit counts in ws; zeroes `state`, the tile sort's state.
extern "C" int ibgs_bin_emit(const long long* order, const int* n_tiles,
                             const int* rect_min, const int* rect_max,
                             const float* cull, long long P, int tiles_x,
                             int tiles_y, int tile_h, int tile_w,
                             const long long* seg_off, const int* kept,
                             long long n, uint32_t* tile, int* rank,
                             unsigned long long* ws,
                             unsigned long long* state, void* stream) {
  if (!args_ok(P, tiles_x, tiles_y, tile_h, tile_w) || n < 0)
    return (int)cudaErrorInvalidValue;
  const Inputs in = make_inputs(order, n_tiles, rect_min, rect_max, cull, P,
                                tiles_x, tiles_y, tile_h, tile_w, 0);
  const int num_tiles = tiles_x * tiles_y;
  const long long words = ibgs_bin_tile_state_words(n, num_tiles);
  const long long blocks = strided_blocks(P > words ? P : words);
  bin_emit_kernel<<<(unsigned)blocks, THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      in, seg_off, kept, n, tile, rank, ws + Layout(P).tile_hist,
      tile_passes(num_tiles), state, words, blocks * THREADS);
  return (int)cudaGetLastError();
}

// bin_emit's tile ids (keys_a) → the stable tile sort: tile_sorted (n,)
// uint32 and slot (n,) int64, the permutation.  keys_b, vals_a, vals_b:
// (n,) scratch; ws and state as bin_emit left them.
extern "C" int ibgs_bin_tiles(long long n, int num_tiles, long long P,
                              unsigned long long* ws,
                              unsigned long long* state, uint32_t* keys_a,
                              uint32_t* keys_b, int* vals_a, int* vals_b,
                              uint32_t* tile_sorted, long long* slot,
                              void* stream) {
  if (n < 0 || num_tiles < 1) return (int)cudaErrorInvalidValue;
  return sort_passes(n, tile_passes(num_tiles), ws + Layout(P).tile_hist,
                     true, state, keys_a, keys_b, vals_a, vals_b, tile_sorted,
                     slot, static_cast<cudaStream_t>(stream));
}

// tile_sorted (n,) uint32 and perm (n,) int64 from the tile sort,
// slot_rank (n,) int32 (bin_emit's ranks), order (P,) int64 → rank,
// gauss_id, tile_id (n,) int64, valid (n,) bool, start (num_tiles + 1,)
// int32.
extern "C" int ibgs_bin_ranges(const uint32_t* tile_sorted,
                               const long long* perm, const int* slot_rank,
                               const long long* order, long long n,
                               int num_tiles, long long* rank,
                               long long* gauss_id, long long* tile_id,
                               uint8_t* valid, int* start, void* stream) {
  if (n < 0 || num_tiles < 0) return (int)cudaErrorInvalidValue;
  const long long items = n > (long long)num_tiles + 1 ? n : num_tiles + 1;
  const long long blocks = blocks_of(items);
  if (!grid_ok(blocks)) return (int)cudaErrorInvalidValue;
  bin_ranges_kernel<<<(unsigned)blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      tile_sorted, perm, slot_rank, order, n, num_tiles, rank, gauss_id,
      tile_id, valid, start);
  return (int)cudaGetLastError();
}

// Registers, local (spill) bytes per thread, CTAs one SM holds at once and
// threads per CTA of kernel `which` (0 bin_key, 1 bin_radix, 2 bin_count,
// 3 bin_emit, 4 bin_ranges), into out[0..3].
extern "C" int ibgs_binning_info(int which, int* out) {
  const KernelPtr k = kernel_for(which);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = THREADS;
  return (int)cudaSuccess;
}

extern "C" const char* ibgs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#else  // the host build: the same items in sequence

extern "C" void ibgs_bin_key_host(const float* depth, const int* n_tiles,
                                  long long P, uint32_t* keys) {
  for (long long i = 0; i < P; ++i) keys[i] = depth_bits(depth[i], n_tiles[i]);
}

extern "C" void ibgs_bin_count_host(const long long* order,
                                    const int* n_tiles, const int* rect_min,
                                    const int* rect_max, const float* cull,
                                    long long P, int tiles_x, int tiles_y,
                                    int tile_h, int tile_w, long long row_cap,
                                    long long* seg_off, int* kept,
                                    long long* totals) {
  const Inputs in = make_inputs(order, n_tiles, rect_min, rect_max, cull, P,
                                tiles_x, tiles_y, tile_h, tile_w, row_cap);
  long long rows = 0, inst = 0, outside = 0;
  for (long long r = 0; r < P; ++r) {
    const Stair s = stair_of(in, order[r]);
    const long long k = kept_rows(in, s.rh, rows);
    outside |= !inside_grid(in, s);
    seg_off[r] = inst;
    kept[r] = (int)k;
    rows += s.rh;
    inst += count_of(in, s, k);
  }
  seg_off[P] = inst;
  totals[0] = rows;
  totals[1] = inst;
  totals[2] = outside;
}

// ... and hist (passes x 256 int32, zeroed by the caller): the tile ids'
// digit counts as bin_emit leaves them (the lowest digit a difference
// array) for the tile sort's passes.
extern "C" void ibgs_bin_emit_host(const long long* order, const int* n_tiles,
                                   const int* rect_min, const int* rect_max,
                                   const float* cull, long long P,
                                   int tiles_x, int tiles_y, int tile_h,
                                   int tile_w, const long long* seg_off,
                                   const int* kept, long long n,
                                   uint32_t* tile, int* rank, int* hist) {
  const Inputs in = make_inputs(order, n_tiles, rect_min, rect_max, cull, P,
                                tiles_x, tiles_y, tile_h, tile_w, 0);
  const int passes = tile_passes((long long)tiles_x * tiles_y);
  for (long long r = 0; r < P; ++r)
    if (seg_off[r] < n && kept[r] > 0)
      emit_of(in, stair_of(in, order[r]), kept[r], r, seg_off[r], n, tile,
              rank, hist, passes);
}

extern "C" void ibgs_bin_ranges_host(const uint32_t* tile_sorted,
                                     const long long* perm,
                                     const int* slot_rank,
                                     const long long* order, long long n,
                                     int num_tiles, long long* rank,
                                     long long* gauss_id, long long* tile_id,
                                     uint8_t* valid, int* start) {
  const long long items = n > (long long)num_tiles + 1 ? n : num_tiles + 1;
  for (long long i = 0; i < items; ++i)
    ranges_item(i, tile_sorted, perm, slot_rank, order, n, num_tiles, rank,
                gauss_id, tile_id, valid, start);
}

#endif  // __CUDACC__
