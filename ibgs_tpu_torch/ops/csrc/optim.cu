// The optimizer's pass for NVIDIA Hopper (sm_90a): Adam on every tensor a
// train step updates, the densification statistics and the count of
// non-finite gradients, in one launch.
//
// Replaces no TPU kernel: the JAX package writes these steps as XLA ops,
// ibgs_tpu/models/gaussians.py:253 `adam_step`, :285 `accumulate_stats`,
// ibgs_tpu/train/trainer.py:54 `side_adam` and the count at :211 (no
// Pallas kernel).  The port's plain version (ops/optim.py `adam_plain`,
// `stats_plain`, `nonfinite_plain`) is about 14 torch launches a tensor for
// Adam (8 Gaussian fields, the exposure table, the net's 22 tensors), 4 a
// gradient for the count and 16 for the statistics: some 600-760 launches
// a step, each reading and writing whole fields again.
//
// Layout: a table of segments, passed by value as the kernel's parameter
// (the pointers change every step; nothing is copied to the device).  An
// Adam segment is n float32 elements of p, m, v and g in rows (slots) of
// `width` elements, each input row-strided (a row contiguous, the rows
// `stride` elements apart: the SH gradient's DC and rest terms are views
// of one (P, 9, 3) tensor), with the contiguous outputs p', m', v' (p' may
// be p: the net is updated in place), its hyper-parameters by index into
// the table's list, and optionally the alive mask, one byte a row.  A
// count segment is a gradient that no Adam segment reads.  The statistics
// segment is P slots: the two row-strided (P, 2) screen gradients, the
// int32 radii and the five statistics in, the five out.
//
// Work: a unit is 4 elements of a segment, or a slot of the statistics.
// The units of all segments, one after the other, are dealt round-robin to
// the grid's threads (a grid-stride loop over each segment that starts on
// the thread after the one where the last segment ended), so that the
// small segments land on different threads.  The grid fills the SMs
// (occupancy x SM count) or the units, whichever is fewer.  A unit of 4
// elements moves as one float4 an array where that array is contiguous
// and 16-byte aligned (the outputs alike); the rest (a segment's tail,
// row-strided or unaligned inputs) element by element.
//
// What bounds it on the card: bytes.  Adam reads p, m, v, g and writes p,
// m, v: 28 bytes an element, and 1 a slot a masked field reads; the
// statistics 60 bytes a slot; a count 4 bytes an element.  About 14 float
// operations an element.  Every byte is read once and written once.
//
// Numerics: built with --fmad=false and IEEE division and square root,
// each element keeps the plain chain's rounding points on the card:
// m' = b1·m + (1-b1)·g (each product rounded, then the sum; 1-b1 formed in
// double by the wrapper and cast), v' = b2·v + ((1-b2)·g)·g, m̂ = m'·(1/bc1)
// and v̂ = v'·(1/bc2) (PyTorch's CUDA division by a Python scalar multiplies
// by the float reciprocal, which the wrapper forms), p' = p − (lr·m̂) /
// (√v̂ + eps).  A dead slot's gradient is +0 (torch.where) once counted.
// The statistics: the screen gradients times 0.5·W and 0.5·H, each product
// rounded; the norm √(x² + y²) with both squares rounded before their sum,
// as ATen's reduction of a (P, 2) row adds the two lanes' squares;
// max_radii2d with NaN propagated as torch.maximum does.  So every output
// is the plain chain's bit for bit.  The count adds each warp's number of
// non-finite gradient entries to one 64-bit integer with one atomic:
// exact in any order.
//
// A host build (without __CUDACC__) walks the whole table with one thread
// as `ibgs_optim_host`, which the CPU tests hold to the plain chain.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int MAX_SEGS = 36;
constexpr int MAX_HYPER = 12;
constexpr int THREADS = 256;
constexpr unsigned UNIT = 4;                // elements a unit
constexpr unsigned F_ADAM = 1u;             // Adam (else a count segment)
constexpr unsigned F_COUNT = 2u;            // count g's non-finite entries
constexpr unsigned F_COUNT_ABS = 4u;        // statistics: count the second
// set by the entry: p, m, v, g contiguous and 16-byte aligned; the
// outputs 16-byte aligned
constexpr unsigned F_VP = 8u, F_VM = 16u, F_VV = 32u, F_VG = 64u,
                   F_VO = 128u;

struct Hyper {
  float lr, b1, omb1, b2, omb2, ibc1, ibc2, eps;   // omb = 1 - b
};

struct Seg {
  const float* p;
  const float* m;
  const float* v;
  const float* g;
  float* po;
  float* mo;
  float* vo;
  const uint8_t* alive;     // null: no mask
  unsigned n, width;        // elements, elements a row
  unsigned sp, sm, sv, sg;  // row strides of p, m, v, g (elements)
  unsigned rot;             // the segment's first thread
  unsigned short hyper, flags;
};

struct Stats {
  const float* sg;          // (P, 2) screen gradient
  const float* sa;          // (P, 2) its abs twin
  const int* radii;         // (P,)
  const float* in[5];       // max_radii2d, grad_accum, grad_accum_abs,
  float* out[5];            // denom, denom_abs
  unsigned P, rot;
  unsigned ssg, ssa;        // row strides of sg, sa
  float half_w, half_h;
  unsigned flags;           // F_COUNT, F_COUNT_ABS
};

struct Table {
  Seg seg[MAX_SEGS];
  Hyper hyper[MAX_HYPER];
  Stats stats;              // P = 0: none
  unsigned long long* count;  // non-finite entries; null: not counted
  int nseg;
};

HD uint32_t bits_of(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(x);
#else
  uint32_t b;
  memcpy(&b, &x, sizeof b);
  return b;
#endif
}

// torch.isfinite's complement: exponent all ones (inf or NaN)
HD unsigned nonfinite(float x) {
  return (bits_of(x) & 0x7f800000u) == 0x7f800000u ? 1u : 0u;
}

HD void load4(const float* src, float* dst) {
#ifdef __CUDA_ARCH__
  const float4 t = *reinterpret_cast<const float4*>(src);
  dst[0] = t.x;
  dst[1] = t.y;
  dst[2] = t.z;
  dst[3] = t.w;
#else
  memcpy(dst, src, 4 * sizeof(float));
#endif
}

HD void store4(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2],
                                                src[3]);
#else
  memcpy(dst, src, 4 * sizeof(float));
#endif
}

// One element of the plain chain, op by op (see the note above).
HD void adam_one(float& p, float& m, float& v, float g, const Hyper& h) {
  const float mb = h.b1 * m;
  const float gb = h.omb1 * g;
  m = mb + gb;
  const float vb = h.b2 * v;
  const float g1 = h.omb2 * g;
  const float g2 = g1 * g;
  v = vb + g2;
  const float mh = m * h.ibc1;
  const float vh = v * h.ibc2;
  const float num = h.lr * mh;
  const float den = sqrtf(vh) + h.eps;
  p = p - num / den;
}

// The unit's element count (1-4).
HD unsigned unit_len(const Seg& s, unsigned u) {
  const unsigned left = s.n - UNIT * u;
  return left < UNIT ? left : UNIT;
}

// Where a unit starts: element i0 is element r of row `row`.
struct At {
  unsigned i0, k, row, r;
};

HD At unit_at(const Seg& s, unsigned u) {
  At a;
  a.i0 = UNIT * u;
  a.k = unit_len(s, u);
  a.row = a.i0 / s.width;
  a.r = a.i0 - a.row * s.width;
  return a;
}

// The unit's k elements of a row-strided input: one float4 where `vec`
// (the input contiguous and aligned) and the unit whole.
HD void load_unit(const float* base, unsigned stride, bool vec, At a,
                  unsigned width, float* out) {
  if (vec && a.k == UNIT) {
    load4(base + a.i0, out);
    return;
  }
#pragma unroll
  for (unsigned j = 0; j < UNIT; ++j)
    if (j < a.k) {
      out[j] = base[(size_t)a.row * stride + a.r];
      if (++a.r == width) {
        a.r = 0;
        ++a.row;
      }
    }
}

HD void store_unit(float* base, bool vec, At a, const float* in) {
  if (vec && a.k == UNIT) {
    store4(base + a.i0, in);
    return;
  }
#pragma unroll
  for (unsigned j = 0; j < UNIT; ++j)
    if (j < a.k) base[a.i0 + j] = in[j];
}

HD unsigned adam_unit(const Seg& s, const Hyper& h, unsigned u) {
  const At at = unit_at(s, u);
  At a = at;
  float p[UNIT], m[UNIT], v[UNIT], g[UNIT];
  load_unit(s.p, s.sp, s.flags & F_VP, a, s.width, p);
  load_unit(s.m, s.sm, s.flags & F_VM, a, s.width, m);
  load_unit(s.v, s.sv, s.flags & F_VV, a, s.width, v);
  load_unit(s.g, s.sg, s.flags & F_VG, a, s.width, g);
  unsigned bad = 0;
#pragma unroll
  for (unsigned j = 0; j < UNIT; ++j)
    if (j < a.k) {
      float gj = g[j];
      if (s.flags & F_COUNT) bad += nonfinite(gj);
      if (s.alive != nullptr && !s.alive[a.row]) gj = 0.0f;
      adam_one(p[j], m[j], v[j], gj, h);
      if (++a.r == s.width) {
        a.r = 0;
        ++a.row;
      }
    }
  const bool vo = s.flags & F_VO;
  store_unit(s.po, vo, at, p);
  store_unit(s.mo, vo, at, m);
  store_unit(s.vo, vo, at, v);
  return bad;
}

HD unsigned count_unit(const Seg& s, unsigned u) {
  const At a = unit_at(s, u);
  const unsigned k = a.k;
  float g[UNIT];
  load_unit(s.g, s.sg, s.flags & F_VG, a, s.width, g);
  unsigned bad = 0;
#pragma unroll
  for (unsigned j = 0; j < UNIT; ++j)
    if (j < k) bad += nonfinite(g[j]);
  return bad;
}

// torch.maximum: NaN in either operand propagates.
HD float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : (a < b ? b : a));
}

HD unsigned stats_slot(const Stats& t, unsigned i) {
  const float sx = t.sg[(size_t)i * t.ssg], sy = t.sg[(size_t)i * t.ssg + 1];
  const float ax = t.sa[(size_t)i * t.ssa], ay = t.sa[(size_t)i * t.ssa + 1];
  unsigned bad = 0;
  if (t.flags & F_COUNT) bad += nonfinite(sx) + nonfinite(sy);
  if (t.flags & F_COUNT_ABS) bad += nonfinite(ax) + nonfinite(ay);
  const int rad = t.radii[i];
  const bool vis = rad > 0;
  const float x = sx * t.half_w, y = sy * t.half_h;
  const float xa = ax * t.half_w, ya = ay * t.half_h;
  const float xx = x * x, yy = y * y, xxa = xa * xa, yya = ya * ya;
  const float norm = sqrtf(xx + yy), norm_a = sqrtf(xxa + yya);
  const float mr = t.in[0][i];
  t.out[0][i] = vis ? maximum(mr, (float)rad) : mr;
  t.out[1][i] = t.in[1][i] + (vis ? norm : 0.0f);
  t.out[2][i] = t.in[2][i] + (vis ? norm_a : 0.0f);
  const float one = vis ? 1.0f : 0.0f;
  t.out[3][i] = t.in[3][i] + one;
  t.out[4][i] = t.in[4][i] + one;
  return bad;
}

// The first unit of a segment that starts on thread `rot` for thread tid.
HD unsigned first_unit(unsigned tid, unsigned rot, unsigned stride) {
  return (tid + stride - rot) % stride;
}

// Every unit of thread tid of `stride`; returns its non-finite count.
HD unsigned walk(const Table& t, unsigned tid, unsigned stride) {
  unsigned bad = 0;
  for (int k = 0; k < t.nseg; ++k) {
    const Seg s = t.seg[k];
    const unsigned units = (s.n + UNIT - 1) / UNIT;
    if (s.flags & F_ADAM) {
      const Hyper h = t.hyper[s.hyper];
      for (unsigned u = first_unit(tid, s.rot, stride); u < units;
           u += stride)
        bad += adam_unit(s, h, u);
    } else {
      for (unsigned u = first_unit(tid, s.rot, stride); u < units;
           u += stride)
        bad += count_unit(s, u);
    }
  }
  const unsigned P = t.stats.P;
  for (unsigned i = first_unit(tid, t.stats.rot, stride); i < P; i += stride)
    bad += stats_slot(t.stats, i);
  return bad;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// A contiguous, 16-byte aligned input: flag `f`.
unsigned vec_flag(const void* p, unsigned stride, unsigned width,
                  unsigned f) {
  return aligned16(p) && stride == width ? f : 0u;
}

// Checks the table, sets each segment's vector flags and first thread for
// a grid of `stride` threads; returns the units in all, or -1 on a table
// the kernel does not take.
long long prepare(Table& t, unsigned stride) {
  if (t.nseg < 0 || t.nseg > MAX_SEGS) return -1;
  unsigned long long base = 0;
  for (int k = 0; k < t.nseg; ++k) {
    Seg& s = t.seg[k];
    if (s.n >= 0x80000000u || s.width == 0 || s.n % s.width != 0)
      return -1;
    const bool adam = s.flags & F_ADAM;
    if (adam && s.hyper >= MAX_HYPER) return -1;
    unsigned f = vec_flag(s.g, s.sg, s.width, F_VG);
    if (adam)
      f |= vec_flag(s.p, s.sp, s.width, F_VP) |
           vec_flag(s.m, s.sm, s.width, F_VM) |
           vec_flag(s.v, s.sv, s.width, F_VV) |
           (aligned16(s.po) && aligned16(s.mo) && aligned16(s.vo) ? F_VO
                                                                 : 0u);
    s.flags = (unsigned short)((s.flags & (F_ADAM | F_COUNT)) | f);
    s.rot = (unsigned)(base % stride);
    base += (s.n + UNIT - 1) / UNIT;
  }
  if (t.stats.P >= 0x80000000u) return -1;
  t.stats.rot = (unsigned)(base % stride);
  return (long long)(base + t.stats.P);
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(THREADS) optim_kernel(const Table t) {
  const unsigned tid = blockIdx.x * THREADS + threadIdx.x;
  const unsigned bad = __reduce_add_sync(
      0xffffffffu, walk(t, tid, gridDim.x * THREADS));
  if ((threadIdx.x & 31u) == 0u && bad != 0u && t.count != nullptr)
    atomicAdd(t.count, (unsigned long long)bad);
}

#endif  // __CUDACC__

}  // namespace

// sizeof(Table) and the offsets of its parts, for the wrapper's mirror:
// out[0..5] = sizeof(Table), seg[1], hyper, stats, count, nseg.
extern "C" int ibgs_optim_layout(long long* out) {
  out[0] = (long long)sizeof(Table);
  out[1] = (long long)offsetof(Table, seg) + (long long)sizeof(Seg);
  out[2] = (long long)offsetof(Table, hyper);
  out[3] = (long long)offsetof(Table, stats);
  out[4] = (long long)offsetof(Table, count);
  out[5] = (long long)offsetof(Table, nseg);
  return 0;
}

#ifdef __CUDACC__

// One launch over `table` (a Table in host memory, copied into the
// kernel's parameter; passed as void* so that the entry keeps external
// linkage), after zeroing *count.  Returns the CUDA error (0 = success).
extern "C" int ibgs_optim(const void* table, void* stream) {
  static int sms = 0, per_sm = 0;
  cudaError_t err;
  if (sms == 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, optim_kernel, THREADS, 0)) != cudaSuccess)
      return (int)err;
  }
  Table t = *static_cast<const Table*>(table);
  const auto s = static_cast<cudaStream_t>(stream);
  if (t.count != nullptr &&
      (err = cudaMemsetAsync(t.count, 0, sizeof *t.count, s)) != cudaSuccess)
    return (int)err;
  long long units = prepare(t, 1u);
  if (units < 0) return (int)cudaErrorInvalidValue;
  if (units == 0) return (int)cudaSuccess;
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long need = (units + THREADS - 1) / THREADS;
  const unsigned blocks = (unsigned)(need < full ? need : full);
  prepare(t, blocks * THREADS);
  optim_kernel<<<blocks, THREADS, 0, s>>>(t);
  return (int)cudaGetLastError();
}

// Registers, local (spill) bytes per thread, CTAs one SM holds at once and
// threads per CTA of the kernel (which = 0), into out[0..3].
extern "C" int ibgs_optim_info(int which, int* out) {
  if (which != 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, optim_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, optim_kernel,
                                                      THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = THREADS;
  return (int)cudaSuccess;
}

#else  // the host build: the whole table with one thread

// ibgs_optim's argument without the stream (*count in host memory);
// returns 0, or 1 on a table the kernel does not take.
extern "C" int ibgs_optim_host(const void* table) {
  Table t = *static_cast<const Table*>(table);
  if (prepare(t, 1u) < 0) return 1;
  const unsigned bad = walk(t, 0u, 1u);
  if (t.count != nullptr) *t.count = bad;
  return 0;
}

#endif  // __CUDACC__
