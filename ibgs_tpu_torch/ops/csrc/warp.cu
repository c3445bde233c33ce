// Image-based warp for NVIDIA Hopper (sm_90a): forward and backward.
//
// Replaces the JAX package's warp, ibgs_tpu/ops/epilogue.py `_warp_views`
// (a jax.custom_vjp that XLA compiles, not a Pallas kernel): the forward
// `_warp_views_impl` (:219-262) and the hand-derived backward
// `_warp_views_bwd` (:286-353).  It computes the function of the port's
// plain versions, ibgs_tpu_torch/ops/epilogue.py `warp_views_plain` and
// `warp_views_bwd_plain`, whose float colour tables the CPU tests hold to
// the JAX package's rgb10 tables.
//
// Forward, for every pixel p, buffer entry b (depth d, weight w) and
// source s: the entry's point (pdx·d, pdy·d, d) goes through ref_to_src[s]
// to q; pu = qx·fx/(qz + 1e-8) + cx, pv likewise; inb = pu, pv inside
// [0, Ws-1] x [0, Hs-1]; w_eff = w·inb; a clamp-to-edge bilinear sample of
// tables[s] at (pu, pv), read at texel (0, 0) where w_eff is not > 0;
// wsc[s,p] = Σ_b colour·w_eff and ws[s,p] = Σ_b w_eff.
// Backward, for every entry: dbw = Σ_s (g_wsum + Σ_ch colour·g_wsc)·inb and
// dbd = Σ_s (du·∂pu/∂d + dv·∂pv/∂d), du and dv the bilinear texture
// gradients weighted by w_eff·g_wsc.  Tables, transforms, rays and the
// intrinsics get no gradient.
//
// What bounds it on the card: bytes.  Each (entry, source) pair gathers a
// 2x2 texel footprint and does 67 float operations forward, 145 backward;
// per pixel the kernels move the B entries, the S outputs or cotangents
// and, across the launch, the S source tables: about 94 MB forward and
// 111 MB backward at 960x544 with B = 4, S = 5 (0.028 / 0.033 ms at 3.35
// TB/s), against 0.7 / 1.5 GFLOP (0.010 / 0.023 ms at 67 TFLOP/s).
//
// Design (simple first): one thread per pixel forward, looping over S and
// B and writing only its pixel's S outputs; one thread per (entry, pixel)
// backward, looping over S and writing only its entry's two gradients.
// No reduction crosses threads, so there are no atomics and repeats are
// bit-identical.  Numerics: built with --fmad=false and IEEE division, and
// every float op in the order of the plain version's torch ops, so each
// term rounds as there; the backward equals its plain version bit for bit,
// the forward differs in the order of the B-sum only.  NaN and inf
// propagate as there: the weight is w·1 or w·0 (not a select), and every
// entry's colour enters its sum, also where w_eff is 0.  The texel index
// is floor(u) with NaN mapped to 0 and clamped to [0, n-1], as the port's
// `_floor_index` (saturating to_i32, then clamp) gives it.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr float EPS = 1.0e-8f;

// floor(u) (already floored) as a texel index: NaN -> 0, clamp to [0, n-1]
// (fmaxf returns the non-NaN operand).
__device__ __forceinline__ int floor_index(float f, int n) {
  return (int)fminf(fmaxf(f, 0.0f), (float)(n - 1));
}

struct Sample {
  float pu, pv, qx, qy, inv_z, inbf, w_eff, fu, fv;
  const float* c00;
  const float* c01;
  const float* c10;
  const float* c11;
};

// Projection of one entry into source view s and its bilinear footprint.
__device__ __forceinline__ Sample sample(const float* __restrict__ r,
                                         const float* __restrict__ tab,
                                         float d, float w, float pdx,
                                         float pdy, float fx, float fy,
                                         float cx, float cy, int Hs,
                                         int Ws) {
  Sample o;
  const float px = pdx * d, py = pdy * d, pz = d;
  o.qx = __ldg(r + 0) * px + __ldg(r + 1) * py + __ldg(r + 2) * pz +
         __ldg(r + 3);
  o.qy = __ldg(r + 4) * px + __ldg(r + 5) * py + __ldg(r + 6) * pz +
         __ldg(r + 7);
  const float qz = __ldg(r + 8) * px + __ldg(r + 9) * py +
                   __ldg(r + 10) * pz + __ldg(r + 11);
  o.inv_z = 1.0f / (qz + EPS);
  o.pu = o.qx * fx * o.inv_z + cx;
  o.pv = o.qy * fy * o.inv_z + cy;
  const bool inb = (o.pu >= 0.0f) && (o.pu <= (float)Ws - 1.0f) &&
                   (o.pv >= 0.0f) && (o.pv <= (float)Hs - 1.0f);
  o.inbf = inb ? 1.0f : 0.0f;
  o.w_eff = w * o.inbf;
  const float flu = floorf(o.pu), flv = floorf(o.pv);
  const bool live = o.w_eff > 0.0f;
  const int x0 = live ? floor_index(flu, Ws) : 0;
  const int y0 = live ? floor_index(flv, Hs) : 0;
  const int x1 = min(x0 + 1, Ws - 1), y1 = min(y0 + 1, Hs - 1);
  o.fu = o.pu - flu;
  o.fv = o.pv - flv;
  o.c00 = tab + ((long long)y0 * Ws + x0) * 3;
  o.c01 = tab + ((long long)y0 * Ws + x1) * 3;
  o.c10 = tab + ((long long)y1 * Ws + x0) * 3;
  o.c11 = tab + ((long long)y1 * Ws + x1) * 3;
  return o;
}

__global__ void __launch_bounds__(THREADS) warp_fwd_kernel(
    const float* __restrict__ bd, const float* __restrict__ bw,
    const float* __restrict__ tables, const float* __restrict__ r2s,
    const float* __restrict__ pdx_, const float* __restrict__ pdy_, int B,
    int n_pix, int S, int Hs, int Ws, float fx, float fy, float cx,
    float cy, float* __restrict__ wsc, float* __restrict__ ws) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= n_pix) return;
  const float pdx = pdx_[p], pdy = pdy_[p];
  const long long table_len = (long long)Hs * Ws * 3;
  for (int s = 0; s < S; ++s) {
    const float* tab = tables + s * table_len;
    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, accw = 0.0f;
    for (int b = 0; b < B; ++b) {
      const long long e = (long long)b * n_pix + p;
      const Sample o = sample(r2s + 16 * s, tab, bd[e], bw[e], pdx, pdy, fx,
                              fy, cx, cy, Hs, Ws);
      const float w00 = (1.0f - o.fu) * (1.0f - o.fv);
      const float w01 = o.fu * (1.0f - o.fv);
      const float w10 = (1.0f - o.fu) * o.fv;
      const float w11 = o.fu * o.fv;
      float col[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        col[ch] = w00 * __ldg(o.c00 + ch) + w01 * __ldg(o.c01 + ch) +
                  w10 * __ldg(o.c10 + ch) + w11 * __ldg(o.c11 + ch);
      }
      acc0 = acc0 + col[0] * o.w_eff;
      acc1 = acc1 + col[1] * o.w_eff;
      acc2 = acc2 + col[2] * o.w_eff;
      accw = accw + o.w_eff;
    }
    const long long q = (long long)s * n_pix + p;
    wsc[q * 3 + 0] = acc0;
    wsc[q * 3 + 1] = acc1;
    wsc[q * 3 + 2] = acc2;
    ws[q] = accw;
  }
}

__global__ void __launch_bounds__(THREADS) warp_bwd_kernel(
    const float* __restrict__ bd, const float* __restrict__ bw,
    const float* __restrict__ tables, const float* __restrict__ r2s,
    const float* __restrict__ pdx_, const float* __restrict__ pdy_,
    const float* __restrict__ g_wsc, const float* __restrict__ g_wsum,
    int B, int n_pix, int S, int Hs, int Ws, float fx, float fy, float cx,
    float cy, float* __restrict__ dbd, float* __restrict__ dbw) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (long long)B * n_pix) return;
  const int p = (int)(e % n_pix);
  const float pdx = pdx_[p], pdy = pdy_[p];
  const float d = bd[e], w = bw[e];
  const long long table_len = (long long)Hs * Ws * 3;
  float gd = 0.0f, gw = 0.0f;
  for (int s = 0; s < S; ++s) {
    const float* r = r2s + 16 * s;
    const Sample o = sample(r, tables + s * table_len, d, w, pdx, pdy, fx, fy,
                            cx, cy, Hs, Ws);
    const float w00 = (1.0f - o.fu) * (1.0f - o.fv);
    const float w01 = o.fu * (1.0f - o.fv);
    const float w10 = (1.0f - o.fu) * o.fv;
    const float w11 = o.fu * o.fv;
    const long long q = (long long)s * n_pix + p;
    float dw_eff = g_wsum[q];
    float du = 0.0f, dv = 0.0f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float a00 = __ldg(o.c00 + ch), a01 = __ldg(o.c01 + ch);
      const float a10 = __ldg(o.c10 + ch), a11 = __ldg(o.c11 + ch);
      const float col = w00 * a00 + w01 * a01 + w10 * a10 + w11 * a11;
      const float gc = g_wsc[q * 3 + ch];
      dw_eff = dw_eff + col * gc;
      const float dcol = o.w_eff * gc;
      du = du + dcol * ((1.0f - o.fv) * (a01 - a00) + o.fv * (a11 - a10));
      dv = dv + dcol * ((1.0f - o.fu) * (a10 - a00) + o.fu * (a11 - a01));
    }
    gw = gw + dw_eff * o.inbf;
    // q = A·(pdx·d, pdy·d, d) + t, so dq/dd = A·(pdx, pdy, 1)
    const float rx = __ldg(r + 0) * pdx + __ldg(r + 1) * pdy + __ldg(r + 2);
    const float ry = __ldg(r + 4) * pdx + __ldg(r + 5) * pdy + __ldg(r + 6);
    const float rz = __ldg(r + 8) * pdx + __ldg(r + 9) * pdy + __ldg(r + 10);
    const float du_dd = fx * (rx - o.qx * o.inv_z * rz) * o.inv_z;
    const float dv_dd = fy * (ry - o.qy * o.inv_z * rz) * o.inv_z;
    gd = gd + du * du_dd + dv * dv_dd;
  }
  dbd[e] = gd;
  dbw[e] = gw;
}

bool valid(int B, int n_pix, int S, int Hs, int Ws) {
  return B >= 0 && n_pix >= 0 && S >= 0 && Hs >= 1 && Ws >= 1 &&
         (long long)B * n_pix < (1LL << 40);
}

}  // namespace

// Launches the forward on `stream`: bd, bw (B, n_pix) contiguous, tables
// (S, Hs, Ws, 3), r2s (S, 4, 4), pdx, pdy (n_pix) → wsc (S, n_pix, 3), ws
// (S, n_pix).  Returns the CUDA error of the launch (0 = success).
extern "C" int ibgs_warp_fwd(const float* bd, const float* bw,
                             const float* tables, const float* r2s,
                             const float* pdx, const float* pdy, int B,
                             int n_pix, int S, int Hs, int Ws, float fx,
                             float fy, float cx, float cy, float* wsc,
                             float* ws, void* stream) {
  if (!valid(B, n_pix, S, Hs, Ws)) return (int)cudaErrorInvalidValue;
  if (n_pix == 0 || S == 0) return (int)cudaSuccess;
  warp_fwd_kernel<<<(n_pix + THREADS - 1) / THREADS, THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      bd, bw, tables, r2s, pdx, pdy, B, n_pix, S, Hs, Ws, fx, fy, cx, cy,
      wsc, ws);
  return (int)cudaGetLastError();
}

// Launches the backward on `stream`: the forward's inputs and the
// cotangents g_wsc (S, n_pix, 3), g_wsum (S, n_pix), all contiguous →
// dbd, dbw (B, n_pix).  Returns the CUDA error of the launch.
extern "C" int ibgs_warp_bwd(const float* bd, const float* bw,
                             const float* tables, const float* r2s,
                             const float* pdx, const float* pdy,
                             const float* g_wsc, const float* g_wsum, int B,
                             int n_pix, int S, int Hs, int Ws, float fx,
                             float fy, float cx, float cy, float* dbd,
                             float* dbw, void* stream) {
  if (!valid(B, n_pix, S, Hs, Ws)) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * n_pix;
  if (n == 0) return (int)cudaSuccess;
  warp_bwd_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      bd, bw, tables, r2s, pdx, pdy, g_wsc, g_wsum, B, n_pix, S, Hs, Ws, fx,
      fy, cx, cy, dbd, dbw);
  return (int)cudaGetLastError();
}

extern "C" const char* ibgs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
