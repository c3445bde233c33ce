// The SSIM map and its gradient for NVIDIA Hopper (sm_90a): one forward
// and one backward kernel for the port's `losses.ssim_map`.
//
// Replaces no TPU kernel: the JAX package computes SSIM with XLA ops,
// ibgs_tpu/train/losses.py `_sep_blur` / `ssim_map` (no Pallas kernel).
// The port's plain version, ibgs_tpu_torch/train/losses.py
// `ssim_map_plain`, blurs five images (x, y, x², y², xy) with `_blur`, an
// 11-tap shift-and-add along H and then W, each tap a torch launch: about
// 240 launches forward and 300 backward a call.
//
// Layout: images (B, H, W, C) float32, channel-last, each frame
// contiguous; an input's batch stride may be 0 (one image against a
// stack).  Window w[0..10] (σ = 1.5, normalised, symmetric), zero padding.
//
// ssim_fwd: one CTA per (channel, 32x16 output tile, batch entry).  It
// stages the tile plus its 5-pixel halo of both images in shared memory
// (zero outside the frame, as F.pad gives), forms the three products on
// the fly, runs the H pass of all five moments into shared memory, then
// the W pass and the SSIM formula for each output, and writes the map.
// Where a gradient is wanted it also writes the five blurred moments
// (μx, μy, E[x²], E[y²], E[xy]): 20 more bytes an element, held until the
// backward (about 626 MB over a 1920x1088 geometry step's five frames).
// Recomputing them there instead would hold nothing but stage both
// images with a 10-pixel halo and run both passes again.
//
// ssim_bwd: one CTA per tile stages, with its halo, the gradients that
// autograd through the plain chain delivers at the blurred maps for the
// map's gradient g (g·∂S/∂μx and g·∂S/∂μy as autograd sums them, the one
// at E[x²] and E[y²], the one at E[xy]), computed from the saved moments
// in autograd's operation order; blurs each with the window's transpose,
// which is the window (symmetric, zero padded), in autograd's order: the
// W pass's transpose first, then the H pass's; and writes the terms
// autograd's engine adds to x's gradient, in its order, apart:
// blur(g_xy)·y, blur(g_xx)·x (added twice) and blur(g_μx); y's likewise.
// The wrapper hands them to autograd as separate gradients, so that each
// is added to the input's other gradients as through the plain chain.
// g is read through its four strides.  No reduction crosses threads and
// there are no atomics: repeats are bit-identical.
//
// What bounds it on the card: bytes.  The function's own traffic is 12
// bytes an element forward (both images in, the map out) and 16 backward
// (both images and g in, one gradient out); the design moves 32 and 44
// where one input needs a gradient (the moments written and read, three
// terms written).  Its arithmetic, about 250 float operations an element
// forward and 200 backward, runs from shared memory.
//
// Numerics: built with --fmad=false and IEEE division, every float op of
// the plain chain and of autograd's backward of it in their order: each
// tap's v·w[k] rounded before its add, the taps summed k = 0..10 from
// acc = v·w[0] (padding taps included; the transposed pass sums the same
// taps in the same order, the window being symmetric), the products
// rounded before they are blurred, s = blur(x·x) − μ² and the quotient in
// `ssim_map_plain`'s order with C1 and C2 as float32.  So the map and
// every term of both gradients are the plain chain's bit for bit.
//
// The CTA's body is written as loops over its items in steps of the
// thread count, with barriers between the phases; a host build of this
// file (without __CUDACC__) runs every CTA in sequence with one thread,
// as the `ibgs_ssim_*_host` entries, which the CPU tests hold to the plain
// chain.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif
#if defined(__CUDA_ARCH__)
#define BARRIER() __syncthreads()
#else
#define BARRIER() ((void)0)
#endif
#include <stdint.h>

namespace {

constexpr int R = 5;                  // window radius
constexpr int TAPS = 2 * R + 1;
constexpr int TW = 32, TH = 16;       // output tile
constexpr int SW = TW + 2 * R, SH = TH + 2 * R;   // staged tile
constexpr int THREADS = 256;
constexpr int MOMENTS = 5;            // μx, μy, E[x²], E[y²], E[xy]
constexpr int MAPS = 4;               // gradients at μx, μy, E[x²], E[xy]

struct Window {
  float w[TAPS];
};

// `_blur`'s tap sum along one axis: v[k·stride]·w[k] for k = 0..10
HD float blur(const float* v, int stride, const Window& w) {
  float acc = v[0] * w.w[0];
  for (int k = 1; k < TAPS; ++k) acc = acc + v[k * stride] * w.w[k];
  return acc;
}

// The H pass of the five moments from the staged columns of x and y.
HD void blur_moments(const float* x, const float* y, int stride,
                     const Window& w, float m[MOMENTS]) {
  for (int k = 0; k < TAPS; ++k) {
    const float a = x[k * stride], b = y[k * stride], wk = w.w[k];
    const float xx = a * a, yy = b * b, xy = a * b;
    const float t[MOMENTS] = {a * wk, b * wk, xx * wk, yy * wk, xy * wk};
    for (int j = 0; j < MOMENTS; ++j) m[j] = k == 0 ? t[j] : m[j] + t[j];
  }
}

// The SSIM formula's terms in `ssim_map_plain`'s order: S = a1·a2 /
// (b1·b2), a1 = 2μxμy + C1, a2 = 2σxy + C2, b1 = μx² + μy² + C1,
// b2 = σx² + σy² + C2.
struct Terms {
  float mu1, mu2, a1, a2, b1, b2;
};

HD Terms terms_of(const float m[MOMENTS], float c1, float c2) {
  Terms t;
  t.mu1 = m[0];
  t.mu2 = m[1];
  const float mu1_sq = t.mu1 * t.mu1, mu2_sq = t.mu2 * t.mu2;
  const float mu12 = t.mu1 * t.mu2;
  const float s1 = m[2] - mu1_sq, s2 = m[3] - mu2_sq, s12 = m[4] - mu12;
  t.a1 = 2.0f * mu12 + c1;
  t.a2 = 2.0f * s12 + c2;
  t.b1 = mu1_sq + mu2_sq + c1;
  t.b2 = s1 + s2 + c2;
  return t;
}

HD float ssim_of(const float m[MOMENTS], float c1, float c2) {
  const Terms t = terms_of(m, c1, c2);
  return (t.a1 * t.a2) / (t.b1 * t.b2);
}

// The gradients autograd through `ssim_map_plain` delivers at μx, μy,
// E[x²] (= at E[y²]) and E[xy] for the map's gradient g: the quotient's
// (g / den, -g·((num / den) / den)), the products', the sums' and
// differences' backward in its order, each tensor's incoming terms added
// in the order autograd's engine runs their producers.
HD void grads_of(const float m[MOMENTS], float g, float c1, float c2,
                 float d[MAPS]) {
  const Terms t = terms_of(m, c1, c2);
  const float num = t.a1 * t.a2, den = t.b1 * t.b2;
  const float gnum = g / den, gden = -g * ((num / den) / den);
  const float ga1 = gnum * t.a2, ga2 = gnum * t.a1;
  const float gb1 = gden * t.b2, gb2 = gden * t.b1;
  const float g_e12 = ga2 * 2.0f;
  const float g_mu12 = ga1 * 2.0f + -g_e12;
  const float g_sq = gb1 + -gb2;           // at μx² and at μy²
  d[0] = g_mu12 * t.mu2 + g_sq * t.mu1 + g_sq * t.mu1;
  d[1] = g_mu12 * t.mu1 + g_sq * t.mu2 + g_sq * t.mu2;
  d[2] = gb2;
  d[3] = g_e12;
}

struct Frame {
  int H, W, C;
  HD long long at(int y, int x, int c) const {
    return ((long long)y * W + x) * C + c;
  }
  HD bool inside(int y, int x) const {
    return y >= 0 && y < H && x >= 0 && x < W;
  }
};

struct FwdArgs {
  const float* x;          // (B, H, W, C) frames, batch stride x_batch
  const float* y;
  long long x_batch, y_batch;
  Frame f;
  Window w;
  float c1, c2;
  float* out;              // (B, H, W, C), contiguous
  float* mom;              // (5, B, H, W, C), contiguous, or null
  long long plane;         // B·H·W·C
};

struct FwdSmem {
  float x[SH][SW];
  float y[SH][SW];
  float h[MOMENTS][TH][SW];
};

// One CTA of ssim_fwd: channel and tile column from bx, tile row by,
// batch entry bz; thread tid of nth.
HD void fwd_tile(const FwdArgs& p, int bx, int by, int bz, int tid, int nth,
                 FwdSmem& s) {
  const Frame& f = p.f;
  const int c = bx % f.C, x0 = (bx / f.C) * TW, y0 = by * TH;
  const float* xs = p.x + bz * p.x_batch;
  const float* ys = p.y + bz * p.y_batch;
  for (int i = tid; i < SH * SW; i += nth) {
    const int r = i / SW, q = i % SW, gy = y0 - R + r, gx = x0 - R + q;
    const bool in = f.inside(gy, gx);
    s.x[r][q] = in ? xs[f.at(gy, gx, c)] : 0.0f;
    s.y[r][q] = in ? ys[f.at(gy, gx, c)] : 0.0f;
  }
  BARRIER();
  for (int i = tid; i < TH * SW; i += nth) {
    const int r = i / SW, q = i % SW;
    float m[MOMENTS];
    blur_moments(&s.x[r][q], &s.y[r][q], SW, p.w, m);
    for (int j = 0; j < MOMENTS; ++j) s.h[j][r][q] = m[j];
  }
  BARRIER();
  const long long base = (long long)bz * f.H * f.W * f.C;
  for (int i = tid; i < TH * TW; i += nth) {
    const int r = i / TW, q = i % TW, gy = y0 + r, gx = x0 + q;
    if (!f.inside(gy, gx)) continue;
    float m[MOMENTS];
    for (int j = 0; j < MOMENTS; ++j) m[j] = blur(&s.h[j][r][q], 1, p.w);
    const long long o = base + f.at(gy, gx, c);
    p.out[o] = ssim_of(m, p.c1, p.c2);
    if (p.mom != nullptr)
      for (int j = 0; j < MOMENTS; ++j) p.mom[j * p.plane + o] = m[j];
  }
}

struct BwdArgs {
  const float* x;
  const float* y;
  long long x_batch, y_batch;
  Frame f;
  Window w;
  float c1, c2;
  const float* g;          // the map's gradient, read through its strides
  long long g_stride[4];
  const float* mom;        // the forward's moments
  long long plane;
  float* dx[3];            // x's terms: cross, square, mean; (B, H, W, C)
  float* dy[3];            // contiguous each, null where not wanted
};

struct BwdSmem {
  float m[MAPS][SH][SW];
  float h[MAPS][SH][TW];
};

// Map j of the backward is needed: μx's for dx, μy's for dy, the others
// for both.
HD bool wanted(const BwdArgs& p, int j) {
  return j == 0 ? p.dx[0] != nullptr : j == 1 ? p.dy[0] != nullptr : true;
}

HD void bwd_tile(const BwdArgs& p, int bx, int by, int bz, int tid, int nth,
                 BwdSmem& s) {
  const Frame& f = p.f;
  const int c = bx % f.C, x0 = (bx / f.C) * TW, y0 = by * TH;
  const long long base = (long long)bz * f.H * f.W * f.C;
  const float* g = p.g + bz * p.g_stride[0] + c * p.g_stride[3];
  for (int i = tid; i < SH * SW; i += nth) {
    const int r = i / SW, q = i % SW, gy = y0 - R + r, gx = x0 - R + q;
    float d[MAPS] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (f.inside(gy, gx)) {
      const long long o = base + f.at(gy, gx, c);
      float m[MOMENTS];
      for (int j = 0; j < MOMENTS; ++j) m[j] = p.mom[j * p.plane + o];
      grads_of(m, g[gy * p.g_stride[1] + gx * p.g_stride[2]], p.c1, p.c2,
               d);
    }
    for (int j = 0; j < MAPS; ++j) s.m[j][r][q] = d[j];
  }
  BARRIER();
  for (int i = tid; i < SH * TW; i += nth) {
    const int r = i / TW, q = i % TW;
    for (int j = 0; j < MAPS; ++j)
      if (wanted(p, j)) s.h[j][r][q] = blur(&s.m[j][r][q], 1, p.w);
  }
  BARRIER();
  for (int i = tid; i < TH * TW; i += nth) {
    const int r = i / TW, q = i % TW, gy = y0 + r, gx = x0 + q;
    if (!f.inside(gy, gx)) continue;
    float b[MAPS];
    for (int j = 0; j < MAPS; ++j)
      b[j] = wanted(p, j) ? blur(&s.h[j][r][q], TW, p.w) : 0.0f;
    const float xv = p.x[bz * p.x_batch + f.at(gy, gx, c)];
    const float yv = p.y[bz * p.y_batch + f.at(gy, gx, c)];
    const long long o = base + f.at(gy, gx, c);
    if (p.dx[0] != nullptr) {
      p.dx[0][o] = b[3] * yv;
      p.dx[1][o] = b[2] * xv;
      p.dx[2][o] = b[0];
    }
    if (p.dy[0] != nullptr) {
      p.dy[0][o] = b[3] * xv;
      p.dy[1][o] = b[2] * yv;
      p.dy[2][o] = b[1];
    }
  }
}

HD int tiles(int n, int t) { return (n + t - 1) / t; }

bool sizes_ok(int B, int H, int W, int C) {
  return B >= 1 && H >= 1 && W >= 1 && C >= 1 && B <= 65535 &&
         tiles(H, TH) <= 65535 &&
         (long long)tiles(W, TW) * C <= 0x7fffffffLL &&
         (long long)H * W * C < 0x7fffffffLL;
}

Frame frame_of(int H, int W, int C) {
  Frame f;
  f.H = H;
  f.W = W;
  f.C = C;
  return f;
}

Window window_of(const float* w) {
  Window out;
  for (int k = 0; k < TAPS; ++k) out.w[k] = w[k];
  return out;
}

FwdArgs fwd_args(const float* x, long long x_batch, const float* y,
                 long long y_batch, int B, int H, int W, int C,
                 const float* w, float c1, float c2, float* out, float* mom) {
  FwdArgs p;
  p.x = x;
  p.y = y;
  p.x_batch = x_batch;
  p.y_batch = y_batch;
  p.f = frame_of(H, W, C);
  p.w = window_of(w);
  p.c1 = c1;
  p.c2 = c2;
  p.out = out;
  p.mom = mom;
  p.plane = (long long)B * H * W * C;
  return p;
}

BwdArgs bwd_args(const float* x, long long x_batch, const float* y,
                 long long y_batch, int B, int H, int W, int C,
                 const float* w, float c1, float c2, const float* g,
                 long long gs_b, long long gs_h, long long gs_w,
                 long long gs_c, const float* mom, float* const dx[3],
                 float* const dy[3]) {
  BwdArgs p;
  p.x = x;
  p.y = y;
  p.x_batch = x_batch;
  p.y_batch = y_batch;
  p.f = frame_of(H, W, C);
  p.w = window_of(w);
  p.c1 = c1;
  p.c2 = c2;
  p.g = g;
  p.g_stride[0] = gs_b;
  p.g_stride[1] = gs_h;
  p.g_stride[2] = gs_w;
  p.g_stride[3] = gs_c;
  p.mom = mom;
  p.plane = (long long)B * H * W * C;
  for (int k = 0; k < 3; ++k) {
    p.dx[k] = dx[k];
    p.dy[k] = dy[k];
  }
  return p;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(THREADS) ssim_fwd_kernel(FwdArgs p) {
  __shared__ FwdSmem s;
  fwd_tile(p, blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x, THREADS, s);
}

__global__ void __launch_bounds__(THREADS) ssim_bwd_kernel(BwdArgs p) {
  __shared__ BwdSmem s;
  bwd_tile(p, blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x, THREADS, s);
}

dim3 grid_of(int B, int H, int W, int C) {
  return dim3((unsigned)(tiles(W, TW) * C), (unsigned)tiles(H, TH),
              (unsigned)B);
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// Each entry returns the CUDA error of its launch (0 = success).
//
// x, y: (B, H, W, C) float32 frames, each contiguous, batch strides x_batch
// and y_batch floats (0: one frame for every entry); w: the 11 window
// weights (host memory); c1, c2 the constants → out (B, H, W, C) the SSIM
// map and, where mom is not null, the five moments, (5, B, H, W, C).
extern "C" int ibgs_ssim_fwd(const float* x, long long x_batch,
                             const float* y, long long y_batch, int B, int H,
                             int W, int C, const float* w, float c1, float c2,
                             float* out, float* mom, void* stream) {
  if (!sizes_ok(B, H, W, C)) return (int)cudaErrorInvalidValue;
  ssim_fwd_kernel<<<grid_of(B, H, W, C), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      fwd_args(x, x_batch, y, y_batch, B, H, W, C, w, c1, c2, out, mom));
  return (int)cudaGetLastError();
}

// The forward's frames, window, constants and moments, g the map's
// gradient with strides (in floats) gs_b, gs_h, gs_w, gs_c → x's gradient
// terms dx_cross, dx_sq, dx_mu and y's, (B, H, W, C) contiguous, an
// input's three only where its first is not null.
extern "C" int ibgs_ssim_bwd(const float* x, long long x_batch,
                             const float* y, long long y_batch, int B, int H,
                             int W, int C, const float* w, float c1, float c2,
                             const float* g, long long gs_b, long long gs_h,
                             long long gs_w, long long gs_c,
                             const float* mom, float* dx_cross, float* dx_sq,
                             float* dx_mu, float* dy_cross, float* dy_sq,
                             float* dy_mu, void* stream) {
  if (!sizes_ok(B, H, W, C)) return (int)cudaErrorInvalidValue;
  float* const dx[3] = {dx_cross, dx_sq, dx_mu};
  float* const dy[3] = {dy_cross, dy_sq, dy_mu};
  ssim_bwd_kernel<<<grid_of(B, H, W, C), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      bwd_args(x, x_batch, y, y_batch, B, H, W, C, w, c1, c2, g, gs_b, gs_h,
               gs_w, gs_c, mom, dx, dy));
  return (int)cudaGetLastError();
}

// Registers, local (spill) bytes per thread, CTAs one SM holds at once,
// threads per CTA and static shared bytes of kernel `which` (0 ssim_fwd,
// 1 ssim_bwd), into out[0..4].
extern "C" int ibgs_ssim_info(int which, int* out) {
  const void* fn = which == 0 ? (const void*)ssim_fwd_kernel
                 : which == 1 ? (const void*)ssim_bwd_kernel : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS,
                                                      0);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = THREADS;
  out[4] = (int)attr.sharedSizeBytes;
  return (int)cudaSuccess;
}

extern "C" const char* ibgs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#else  // the host build: every CTA in sequence, one thread each

// ibgs_ssim_fwd's arguments without the stream; returns 0, or 1 on sizes
// the kernels do not take.
extern "C" int ibgs_ssim_fwd_host(const float* x, long long x_batch,
                                  const float* y, long long y_batch, int B,
                                  int H, int W, int C, const float* w,
                                  float c1, float c2, float* out,
                                  float* mom) {
  if (!sizes_ok(B, H, W, C)) return 1;
  const FwdArgs p = fwd_args(x, x_batch, y, y_batch, B, H, W, C, w, c1, c2,
                             out, mom);
  FwdSmem* s = new FwdSmem;
  for (int bz = 0; bz < B; ++bz)
    for (int by = 0; by < tiles(H, TH); ++by)
      for (int bx = 0; bx < tiles(W, TW) * C; ++bx)
        fwd_tile(p, bx, by, bz, 0, 1, *s);
  delete s;
  return 0;
}

// ibgs_ssim_bwd's arguments without the stream.
extern "C" int ibgs_ssim_bwd_host(const float* x, long long x_batch,
                                  const float* y, long long y_batch, int B,
                                  int H, int W, int C, const float* w,
                                  float c1, float c2, const float* g,
                                  long long gs_b, long long gs_h,
                                  long long gs_w, long long gs_c,
                                  const float* mom, float* dx_cross,
                                  float* dx_sq, float* dx_mu,
                                  float* dy_cross, float* dy_sq,
                                  float* dy_mu) {
  if (!sizes_ok(B, H, W, C)) return 1;
  float* const dx[3] = {dx_cross, dx_sq, dx_mu};
  float* const dy[3] = {dy_cross, dy_sq, dy_mu};
  const BwdArgs p = bwd_args(x, x_batch, y, y_batch, B, H, W, C, w, c1, c2,
                             g, gs_b, gs_h, gs_w, gs_c, mom, dx, dy);
  BwdSmem* s = new BwdSmem;
  for (int bz = 0; bz < B; ++bz)
    for (int by = 0; by < tiles(H, TH); ++by)
      for (int bx = 0; bx < tiles(W, TW) * C; ++bx)
        bwd_tile(p, bx, by, bz, 0, 1, *s);
  delete s;
  return 0;
}

#endif  // __CUDACC__
