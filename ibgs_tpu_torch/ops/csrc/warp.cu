// Image-based warp for NVIDIA Hopper (sm_90a): the rgb10 colour tables, the
// forward with the occlusion test's depth sample, and the backward.
//
// Replaces the JAX package's warp, ibgs_tpu/ops/epilogue.py `_warp_views`
// (a jax.custom_vjp that XLA compiles, not a Pallas kernel): its colour
// tables `pack_rgb10` (:152-161), the forward `_warp_views_impl`
// (:219-262), the hand-derived backward `_warp_views_bwd` (:286-353), and
// the occlusion test's depth sample of `ibr_epilogue` (:487-512).  It
// computes the functions of the port's plain versions,
// ibgs_tpu_torch/ops/epilogue.py `pack_rgb10`, `warp_views_plain` and
// `warp_views_bwd_plain`.
//
// rgb10_pack: each texel's three float colours become one int32 word,
// q = rint(clip(x, 0, 1)·1023) per channel (NaN -> 0), r<<20 | g<<10 | b,
// and each texel's 2x2 clamp-to-edge footprint of words is written as one
// 16-byte row (the JAX package's pack_bilinear_corners_rgb10).
// Forward, for every pixel p, buffer entry b (depth d, weight w) and source
// s: the entry's point (pdx·d, pdy·d, d) goes through ref_to_src[s] to q;
// pu = qx·fx/(qz + 1e-8) + cx, pv likewise; inb = pu, pv inside
// [0, Ws-1] x [0, Hs-1]; w_eff = w·inb; a clamp-to-edge bilinear sample of
// the unpacked table s at (pu, pv), read at texel (0, 0) where w_eff is not
// > 0; wsc[s,p] = Σ_b colour·w_eff and ws[s,p] = Σ_b w_eff.  The median
// point (pdx·m, pdy·m, m) goes through ref_to_src[s] to (pum, pvm, qmz);
// wdepth[s,p] is the bilinear sample of depths[s] there where pum lies in
// [0, W-1] (W the rendered view's width, as the JAX package bounds it) and
// pvm in [0, Hs-1], else 0; depth_err[s,p] = |wdepth - qmz|/(qmz + 1e-8).
// Backward, for every entry: dbw = Σ_s (g_wsum + Σ_ch colour·g_wsc)·inb and
// dbd = Σ_s (du·∂pu/∂d + dv·∂pv/∂d), du and dv the bilinear texture
// gradients weighted by w_eff·g_wsc.  Tables, transforms, rays, the median
// and the depth maps get no gradient; wdepth and depth_err carry none.
//
// What bounds it on the card: bytes.  Each (entry, source) pair gathers a
// 2x2 texel footprint and does 67 float operations forward, 145 backward;
// each (pixel, source) 46 more forward for the occlusion test.  Counting
// each input of a kernel once and each output once, at 960x544 with B = 4,
// S = 5 and sources of the view's size: the pack 28 bytes per texel (the
// float colour in, the footprint row out), 73 MB or 0.022 ms at 3.35 TB/s;
// the forward and the backward the colour tables at 4 bytes per texel
// (the least a table of the 10-bit colours needs: the rows repeat each
// word four times, the design's own cost), the buffer, the transforms and
// rays, the forward also the median and depth maps in and its four outputs
// out, 107 MB or 0.032 ms, the backward the cotangents in and dbd, dbw
// out, 90 MB or 0.027 ms; against 0.8 / 1.5 GFLOP (0.012 / 0.023 ms at
// 67 TFLOP/s).
//
// Design for Hopper.  The colour tables are the JAX package's rgb10
// footprint rows: each texel's 2x2 clamp-to-edge footprint of 10-bit words
// as one aligned 16-byte row, so a bilinear footprint is one vector load
// (167 MB at 1920x1088 with S = 5, where float texels, 125 MB, took 12
// scattered 4-byte loads); one word per texel (42 MB, inside L2, four
// loads) measured slower in both kernels (scripts/warp_probe.py builds
// that variant of this source; PERF.md §6).  The blend's (H, W, B) buffers
// are read in place: for B = 4 one float4 of depths and one of weights per
// pixel, and the backward writes its gradients in that layout.  Both
// kernels run one thread per pixel on TILE_W x TILE_H CTA tiles and loop
// over the S sources; B is a template parameter (slots for B <= 4, B <= 8,
// a generic loop above); the forward loads a source's B footprints before
// mixing their colours; the backward sums each entry's gradient over S
// inside the thread and reads the pixel's cotangents and rays once per
// source.  The S transforms sit in shared memory, loaded once per CTA.
// Both kernels are built for MIN_CTAS CTAs per SM.  No reduction crosses
// threads: no atomics, repeats bit-identical.  What holds the kernels
// under their bound: issue and latency, not bytes (PERF.md §6).
//
// Numerics: built with --fmad=false and IEEE division, every float op in
// the order of the plain version's torch ops, so each term rounds as there:
// the backward, wdepth and depth_err equal their plain versions bit for
// bit, the colour sums differ in the order of the B-sum only.  The unpacked
// channel q·float32(1/1023) is the float the plain version unpacks.  NaN
// and inf propagate as there: the weight is w·1 or w·0 (not a select), and
// every entry's colour enters its sum, also where w_eff is 0.  A texel
// index is floor(u) with NaN mapped to 0 and clamped to [0, n-1], as the
// port's `_floor_index` (saturating to_i32, then clamp) gives it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// the warp kernels' CTA: TILE_W x TILE_H pixels (scripts/warp_probe.py
// times the other widths)
constexpr int TILE_W = 16;
constexpr int TILE_H = THREADS / TILE_W;
constexpr int MAX_SOURCES = 1024;  // S x 12 floats of shared memory
// CTAs per SM that both warp kernels are built for, a cap of 64 registers:
// the uncapped build (MIN_CTAS 1, 2 CTAs per SM) ran both kernels 18-28%
// slower in scripts/warp_probe.py (PERF.md §6), the forward's spill
// included
constexpr int MIN_CTAS = 4;
// int32 words per texel of a colour table: its 2x2 footprint row
constexpr int TABLE_WORDS = 4;
constexpr float EPS = 1.0e-8f;
// the plain version multiplies by the double 1/1023 rounded to float32
constexpr float INV_1023 = (float)(1.0 / 1023.0);

struct Params {
  // (H, W, B) buffers: entry b of pixel (y, x) at y·row_stride + x·B + b
  const float* bd;
  const float* bw;
  long long row_stride;
  const int* tables;  // (S, Hs, Ws, 4) footprint rows
  const float* r2s;   // (S, 4, 4)
  const float* pdx;   // (H, W)
  const float* pdy;
  const float* median;  // forward: (H, W)
  const float* depths;  // forward: (S, Hs, Ws)
  const float* g_wsc;   // backward: (S, H, W, 3)
  const float* g_wsum;  // backward: (S, H, W)
  float* out0;  // forward wsc (S, H, W, 3); backward dbd (H, W, B)
  float* out1;  // forward ws (S, H, W); backward dbw (H, W, B)
  float* out2;  // forward wdepth (S, H, W)
  float* out3;  // forward depth_err (S, H, W)
  int B, H, W, S, Hs, Ws;
  float fx, fy, cx, cy;
  bool vec;  // B is 4 or 8 and the buffers' rows are 16-byte aligned
};

// floor(u) (already floored) as a texel index: NaN -> 0, clamp to [0, n-1]
// (fmaxf returns the non-NaN operand).
__device__ __forceinline__ int floor_index(float f, int n) {
  return (int)fminf(fmaxf(f, 0.0f), (float)(n - 1));
}

// Rows 0-2 of every ref_to_src into shared memory, once per CTA.
__device__ __forceinline__ void load_transforms(const Params& a, float* xf) {
  for (int i = threadIdx.y * TILE_W + threadIdx.x; i < a.S * 12;
       i += THREADS)
    xf[i] = __ldg(a.r2s + (i / 12) * 16 + i % 12);
  __syncthreads();
}

struct Proj {
  float qx, qy, inv_z, inbf, w_eff, fu, fv;
  int x0, y0;
};

// Projection of one entry into the source of transform m.
__device__ __forceinline__ Proj project(const float* m, float d, float w,
                                        float pdx, float pdy,
                                        const Params& a) {
  Proj o;
  const float px = pdx * d, py = pdy * d, pz = d;
  o.qx = m[0] * px + m[1] * py + m[2] * pz + m[3];
  o.qy = m[4] * px + m[5] * py + m[6] * pz + m[7];
  const float qz = m[8] * px + m[9] * py + m[10] * pz + m[11];
  o.inv_z = 1.0f / (qz + EPS);
  const float pu = o.qx * a.fx * o.inv_z + a.cx;
  const float pv = o.qy * a.fy * o.inv_z + a.cy;
  const bool inb = (pu >= 0.0f) && (pu <= (float)a.Ws - 1.0f) &&
                   (pv >= 0.0f) && (pv <= (float)a.Hs - 1.0f);
  o.inbf = inb ? 1.0f : 0.0f;
  o.w_eff = w * o.inbf;
  const float flu = floorf(pu), flv = floorf(pv);
  const bool live = o.w_eff > 0.0f;
  o.x0 = live ? floor_index(flu, a.Ws) : 0;
  o.y0 = live ? floor_index(flv, a.Hs) : 0;
  o.fu = pu - flu;
  o.fv = pv - flv;
  return o;
}

struct Foot {
  unsigned int c00, c01, c10, c11;
};

// The 2x2 clamp-to-edge footprint of words at (x0, y0) of one table: its
// footprint row, one 16-byte load.
__device__ __forceinline__ Foot fetch(const int* tab, int x0, int y0,
                                      const Params& a) {
  const int4 r = __ldg(reinterpret_cast<const int4*>(tab) +
                       ((long long)y0 * a.Ws + x0));
  return Foot{(unsigned int)r.x, (unsigned int)r.y, (unsigned int)r.z,
              (unsigned int)r.w};
}

__device__ __forceinline__ float channel(unsigned int v, int ch) {
  return (float)((v >> (20 - 10 * ch)) & 1023u) * INV_1023;
}

// The B entries of a pixel from the in-place buffers (e0: its entry 0).
template <int BMAX>
__device__ __forceinline__ void load_entries(const Params& a, long long e0,
                                             float* d, float* w) {
  if (a.vec) {
#pragma unroll
    for (int k = 0; k < BMAX / 4; ++k) {
      const float4 dv = __ldg(reinterpret_cast<const float4*>(a.bd + e0) + k);
      const float4 wv = __ldg(reinterpret_cast<const float4*>(a.bw + e0) + k);
      d[4 * k] = dv.x;
      d[4 * k + 1] = dv.y;
      d[4 * k + 2] = dv.z;
      d[4 * k + 3] = dv.w;
      w[4 * k] = wv.x;
      w[4 * k + 1] = wv.y;
      w[4 * k + 2] = wv.z;
      w[4 * k + 3] = wv.w;
    }
  } else {
#pragma unroll
    for (int b = 0; b < BMAX; ++b) {
      d[b] = b < a.B ? __ldg(a.bd + e0 + b) : 0.0f;
      w[b] = b < a.B ? __ldg(a.bw + e0 + b) : 0.0f;
    }
  }
}

// One entry's weighted colour added to the three colour sums and acc[3].
__device__ __forceinline__ void accumulate(const Proj& o, const Foot& f,
                                           float* acc) {
  const float w00 = (1.0f - o.fu) * (1.0f - o.fv);
  const float w01 = o.fu * (1.0f - o.fv);
  const float w10 = (1.0f - o.fu) * o.fv;
  const float w11 = o.fu * o.fv;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float col = w00 * channel(f.c00, ch) + w01 * channel(f.c01, ch) +
                      w10 * channel(f.c10, ch) + w11 * channel(f.c11, ch);
    acc[ch] = acc[ch] + col * o.w_eff;
  }
  acc[3] = acc[3] + o.w_eff;
}

// One entry's gradient terms of one source added to its (gd, gw).
__device__ __forceinline__ void entry_grad(const Proj& o, const Foot& f,
                                           const float* gc, float gws,
                                           float rx, float ry, float rz,
                                           const Params& a, float& gd,
                                           float& gw) {
  const float w00 = (1.0f - o.fu) * (1.0f - o.fv);
  const float w01 = o.fu * (1.0f - o.fv);
  const float w10 = (1.0f - o.fu) * o.fv;
  const float w11 = o.fu * o.fv;
  float dw_eff = gws, du = 0.0f, dv = 0.0f;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float a00 = channel(f.c00, ch), a01 = channel(f.c01, ch);
    const float a10 = channel(f.c10, ch), a11 = channel(f.c11, ch);
    const float col = w00 * a00 + w01 * a01 + w10 * a10 + w11 * a11;
    dw_eff = dw_eff + col * gc[ch];
    const float dcol = o.w_eff * gc[ch];
    du = du + dcol * ((1.0f - o.fv) * (a01 - a00) + o.fv * (a11 - a10));
    dv = dv + dcol * ((1.0f - o.fu) * (a10 - a00) + o.fu * (a11 - a01));
  }
  gw = gw + dw_eff * o.inbf;
  // q = A·(pdx·d, pdy·d, d) + t, so dq/dd = A·(pdx, pdy, 1)
  const float du_dd = a.fx * (rx - o.qx * o.inv_z * rz) * o.inv_z;
  const float dv_dd = a.fy * (ry - o.qy * o.inv_z * rz) * o.inv_z;
  gd = gd + du * du_dd + dv * dv_dd;
}

// The occlusion test's depth sample of the median point (pdx·med, pdy·med,
// med) in the source of transform m: writes wdepth and depth_err at q.
__device__ __forceinline__ void occlusion(const float* m, float pdx,
                                          float pdy, float med,
                                          const float* dm, long long q,
                                          const Params& a) {
  const float mx = pdx * med, my = pdy * med, mz = med;
  const float qmx = m[0] * mx + m[1] * my + m[2] * mz + m[3];
  const float qmy = m[4] * mx + m[5] * my + m[6] * mz + m[7];
  const float qmz = m[8] * mx + m[9] * my + m[10] * mz + m[11];
  const float inv_zm = 1.0f / (qmz + EPS);
  const float pum = qmx * a.fx * inv_zm + a.cx;
  const float pvm = qmy * a.fy * inv_zm + a.cy;
  float wd = 0.0f;
  if ((pum >= 0.0f) && (pum <= (float)a.W - 1.0f) && (pvm >= 0.0f) &&
      (pvm <= (float)a.Hs - 1.0f)) {
    const float flu = floorf(pum), flv = floorf(pvm);
    const int x0 = floor_index(flu, a.Ws), y0 = floor_index(flv, a.Hs);
    const int x1 = min(x0 + 1, a.Ws - 1), y1 = min(y0 + 1, a.Hs - 1);
    const float fu = pum - flu, fv = pvm - flv;
    const float* r0 = dm + (long long)y0 * a.Ws;
    const float* r1 = dm + (long long)y1 * a.Ws;
    wd = (1.0f - fu) * (1.0f - fv) * __ldg(r0 + x0) +
         fu * (1.0f - fv) * __ldg(r0 + x1) +
         (1.0f - fu) * fv * __ldg(r1 + x0) + fu * fv * __ldg(r1 + x1);
  }
  a.out2[q] = wd;
  a.out3[q] = fabsf(wd - qmz) * inv_zm;
}

// CTA: a 2-D tile of TILE_W x TILE_H pixels, one thread each, looping
// over the S sources.  BMAX: buffer slots (4 or 8; 0 = a runtime loop over
// any B).
template <int BMAX>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
    warp_fwd_kernel(const Params a) {
  extern __shared__ float xf[];
  load_transforms(a, xf);
  const int x = blockIdx.x * TILE_W + threadIdx.x;
  const int y = blockIdx.y * TILE_H + threadIdx.y;
  if (x >= a.W || y >= a.H) return;
  const long long n_pix = (long long)a.H * a.W;
  const long long p = (long long)y * a.W + x;
  const long long e0 = y * a.row_stride + (long long)x * a.B;
  const long long tab_len = (long long)a.Hs * a.Ws;
  const float pdx = __ldg(a.pdx + p), pdy = __ldg(a.pdy + p);
  const float med = __ldg(a.median + p);
  float d[BMAX > 0 ? BMAX : 1], w[BMAX > 0 ? BMAX : 1];
  if constexpr (BMAX > 0) load_entries<BMAX>(a, e0, d, w);
  for (int s = 0; s < a.S; ++s) {
    const float* m = xf + 12 * s;
    const int* tab = a.tables + s * tab_len * TABLE_WORDS;
    const long long q = s * n_pix + p;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if constexpr (BMAX > 0) {
      Proj o[BMAX];
      Foot f[BMAX];
#pragma unroll
      for (int b = 0; b < BMAX; ++b) {
        if (b < a.B) {
          o[b] = project(m, d[b], w[b], pdx, pdy, a);
          f[b] = fetch(tab, o[b].x0, o[b].y0, a);
        }
      }
      occlusion(m, pdx, pdy, med, a.depths + s * tab_len, q, a);
#pragma unroll
      for (int b = 0; b < BMAX; ++b)
        if (b < a.B) accumulate(o[b], f[b], acc);
    } else {
      for (int b = 0; b < a.B; ++b) {
        const Proj o = project(m, __ldg(a.bd + e0 + b),
                               __ldg(a.bw + e0 + b), pdx, pdy, a);
        accumulate(o, fetch(tab, o.x0, o.y0, a), acc);
      }
      occlusion(m, pdx, pdy, med, a.depths + s * tab_len, q, a);
    }
    a.out0[q * 3 + 0] = acc[0];
    a.out0[q * 3 + 1] = acc[1];
    a.out0[q * 3 + 2] = acc[2];
    a.out1[q] = acc[3];
  }
}

// CTA as the forward's; each thread sums its pixel's B entries' gradients
// over the S sources in source order, reading the pixel's cotangents and
// rays once per source.  Entry by entry within a source: loading all B
// footprints first, as the forward does, needed twice the registers and
// was slower on the card.
template <int BMAX>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
    warp_bwd_kernel(const Params a) {
  extern __shared__ float xf[];
  load_transforms(a, xf);
  const int x = blockIdx.x * TILE_W + threadIdx.x;
  const int y = blockIdx.y * TILE_H + threadIdx.y;
  if (x >= a.W || y >= a.H) return;
  const long long n_pix = (long long)a.H * a.W;
  const long long p = (long long)y * a.W + x;
  const long long e0 = y * a.row_stride + (long long)x * a.B;
  const long long o0 = p * a.B;  // the gradients are contiguous (H, W, B)
  const long long tab_len = (long long)a.Hs * a.Ws * TABLE_WORDS;
  const float pdx = __ldg(a.pdx + p), pdy = __ldg(a.pdy + p);
  if constexpr (BMAX > 0) {
    float d[BMAX], w[BMAX], gd[BMAX], gw[BMAX];
    load_entries<BMAX>(a, e0, d, w);
#pragma unroll
    for (int b = 0; b < BMAX; ++b) gd[b] = gw[b] = 0.0f;
    for (int s = 0; s < a.S; ++s) {
      const float* m = xf + 12 * s;
      const int* tab = a.tables + s * tab_len;
      const long long q = s * n_pix + p;
      const float gc[3] = {__ldg(a.g_wsc + q * 3), __ldg(a.g_wsc + q * 3 + 1),
                           __ldg(a.g_wsc + q * 3 + 2)};
      const float gws = __ldg(a.g_wsum + q);
      const float rx = m[0] * pdx + m[1] * pdy + m[2];
      const float ry = m[4] * pdx + m[5] * pdy + m[6];
      const float rz = m[8] * pdx + m[9] * pdy + m[10];
#pragma unroll
      for (int b = 0; b < BMAX; ++b) {
        if (b < a.B) {
          const Proj o = project(m, d[b], w[b], pdx, pdy, a);
          entry_grad(o, fetch(tab, o.x0, o.y0, a), gc, gws, rx, ry, rz,
                     a, gd[b], gw[b]);
        }
      }
    }
    if (a.vec) {
#pragma unroll
      for (int k = 0; k < BMAX / 4; ++k) {
        reinterpret_cast<float4*>(a.out0 + o0)[k] =
            make_float4(gd[4 * k], gd[4 * k + 1], gd[4 * k + 2],
                        gd[4 * k + 3]);
        reinterpret_cast<float4*>(a.out1 + o0)[k] =
            make_float4(gw[4 * k], gw[4 * k + 1], gw[4 * k + 2],
                        gw[4 * k + 3]);
      }
    } else {
#pragma unroll
      for (int b = 0; b < BMAX; ++b) {
        if (b < a.B) {
          a.out0[o0 + b] = gd[b];
          a.out1[o0 + b] = gw[b];
        }
      }
    }
  } else {
    for (int b = 0; b < a.B; ++b) {
      const float d = __ldg(a.bd + e0 + b), w = __ldg(a.bw + e0 + b);
      float gd = 0.0f, gw = 0.0f;
      for (int s = 0; s < a.S; ++s) {
        const float* m = xf + 12 * s;
        const long long q = s * n_pix + p;
        const float gc[3] = {__ldg(a.g_wsc + q * 3),
                             __ldg(a.g_wsc + q * 3 + 1),
                             __ldg(a.g_wsc + q * 3 + 2)};
        const float rx = m[0] * pdx + m[1] * pdy + m[2];
        const float ry = m[4] * pdx + m[5] * pdy + m[6];
        const float rz = m[8] * pdx + m[9] * pdy + m[10];
        const Proj o = project(m, d, w, pdx, pdy, a);
        entry_grad(o, fetch(a.tables + s * tab_len, o.x0, o.y0, a),
                   gc, __ldg(a.g_wsum + q), rx, ry, rz, a, gd, gw);
      }
      a.out0[o0 + b] = gd;
      a.out1[o0 + b] = gw;
    }
  }
}

__device__ __forceinline__ int pack_texel(const float* c) {
  int q[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    q[ch] = (int)rintf(fminf(fmaxf(__ldg(c + ch), 0.0f), 1.0f) * 1023.0f);
  return (q[0] << 20) | (q[1] << 10) | q[2];
}

__global__ void __launch_bounds__(THREADS)
    rgb10_pack_kernel(const float* __restrict__ img, long long n, int Hs,
                      int Ws, int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int v = pack_texel(img + 3 * i);
  const int x = (int)(i % Ws), y = (int)((i / Ws) % Hs);
  const long long dx = x + 1 < Ws ? 1 : 0, dy = y + 1 < Hs ? Ws : 0;
  reinterpret_cast<int4*>(out)[i] =
      make_int4(v, pack_texel(img + 3 * (i + dx)),
                pack_texel(img + 3 * (i + dy)),
                pack_texel(img + 3 * (i + dx + dy)));
}

using Kernel = void (*)(const Params);

// which: 0 forward, 1 backward.
Kernel warp_kernel(int which, int B) {
  if (which == 0)
    return B <= 4   ? warp_fwd_kernel<4>
           : B <= 8 ? warp_fwd_kernel<8>
                    : warp_fwd_kernel<0>;
  return B <= 4   ? warp_bwd_kernel<4>
         : B <= 8 ? warp_bwd_kernel<8>
                  : warp_bwd_kernel<0>;
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

bool valid(int B, int H, int W, int S, int Hs, int Ws,
           long long row_stride) {
  return B >= 0 && H >= 0 && W >= 0 && S >= 0 && S <= MAX_SOURCES &&
         Hs >= 1 && Ws >= 1 && (H + TILE_H - 1) / TILE_H <= 65535 &&
         row_stride >= (long long)W * B;
}

int launch(int which, Params& a, void* stream) {
  // the backward's gradients are written as float4 too
  a.vec = (a.B == 4 || a.B == 8) && a.row_stride % 4 == 0 &&
          aligned16(a.bd) && aligned16(a.bw) &&
          (which == 0 || (aligned16(a.out0) && aligned16(a.out1)));
  const dim3 block(TILE_W, TILE_H);
  const dim3 grid((a.W + TILE_W - 1) / TILE_W, (a.H + TILE_H - 1) / TILE_H);
  const Kernel k = warp_kernel(which, a.B);
  k<<<grid, block, a.S * 12 * sizeof(float),
      static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Packs (S, Hs, Ws, 3) contiguous float32 images on `stream` into out,
// (S, Hs, Ws, 4) int32 footprint rows.  Returns the CUDA error of the
// launch (0 = success).
extern "C" int ibgs_rgb10_pack(const float* images, int S, int Hs, int Ws,
                               int* out, void* stream) {
  if (S < 0 || Hs < 0 || Ws < 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)S * Hs * Ws;
  if (n == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  rgb10_pack_kernel<<<blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(images, n, Hs, Ws,
                                                           out);
  return (int)cudaGetLastError();
}

// Launches the forward on `stream`: bd, bw the (H, W, B) buffers (row
// stride in floats), tables (S, Hs, Ws, 4) int32 footprint rows, r2s (S,
// 4, 4), pdx, pdy, median (H, W), depths (S, Hs, Ws), all contiguous →
// wsc (S, H, W, 3), ws, wdepth, depth_err (S, H, W).  Returns the CUDA
// error of the launch (0 = success).
extern "C" int ibgs_warp_fwd(const float* bd, const float* bw,
                             long long row_stride, const int* tables,
                             const float* r2s, const float* pdx,
                             const float* pdy, const float* median,
                             const float* depths, int B, int H, int W, int S,
                             int Hs, int Ws, float fx, float fy, float cx,
                             float cy, float* wsc, float* ws, float* wdepth,
                             float* depth_err, void* stream) {
  if (!valid(B, H, W, S, Hs, Ws, row_stride))
    return (int)cudaErrorInvalidValue;
  if ((long long)H * W == 0 || S == 0) return (int)cudaSuccess;
  Params a = {bd, bw, row_stride, tables, r2s, pdx, pdy, median, depths,
              nullptr, nullptr, wsc, ws, wdepth, depth_err, B, H, W, S, Hs,
              Ws, fx, fy, cx, cy, false};
  return launch(0, a, stream);
}

// Launches the backward on `stream`: the forward's buffers, tables,
// transforms and rays and the cotangents g_wsc (S, H, W, 3), g_wsum (S, H,
// W), contiguous → dbd, dbw, contiguous (H, W, B).  Returns the CUDA
// error of the launch.
extern "C" int ibgs_warp_bwd(const float* bd, const float* bw,
                             long long row_stride, const int* tables,
                             const float* r2s, const float* pdx,
                             const float* pdy, const float* g_wsc,
                             const float* g_wsum, int B, int H, int W, int S,
                             int Hs, int Ws, float fx, float fy, float cx,
                             float cy, float* dbd, float* dbw,
                             void* stream) {
  if (!valid(B, H, W, S, Hs, Ws, row_stride))
    return (int)cudaErrorInvalidValue;
  if ((long long)H * W * B == 0) return (int)cudaSuccess;
  Params a = {bd, bw, row_stride, tables, r2s, pdx, pdy, nullptr, nullptr,
              g_wsc, g_wsum, dbd, dbw, nullptr, nullptr, B, H, W, S, Hs, Ws,
              fx, fy, cx, cy, false};
  return launch(1, a, stream);
}

// Registers, local (spill) bytes per thread, CTAs one SM holds at once and
// the CTA's width and height in threads of the kernel `which` (0 forward,
// 1 backward, 2 pack) for B entries and S sources, into out[0..4].
extern "C" int ibgs_warp_info(int which, int B, int S, int* out) {
  const void* fn = (const void*)rgb10_pack_kernel;
  int smem = 0, tile_w = THREADS, tile_h = 1;
  if (which != 2) {
    fn = (const void*)warp_kernel(which, B);
    smem = S * 12 * (int)sizeof(float);
    tile_w = TILE_W;
    tile_h = TILE_H;
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = tile_w;
  out[4] = tile_h;
  return (int)cudaSuccess;
}

extern "C" const char* ibgs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
