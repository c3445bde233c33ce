// Per-Gaussian projection for NVIDIA Hopper (sm_90a): the forward and the
// backward of the port's `preprocess`.
//
// Replaces the JAX package's per-Gaussian view preprocessing,
// ibgs_tpu/ops/preprocess.py `preprocess` (:142-262, with `ewa_project`
// :66, `camera_plane` :103 and ibgs_tpu/core/sh.py:74 `eval_sh`), which XLA
// compiles and fuses (not a Pallas kernel), and its autodiff.  It computes
// the function of the port's plain version, ibgs_tpu_torch/ops/
// preprocess.py `preprocess_plain`, and the gradient torch autograd takes
// of it (`preprocess_bwd_plain`).
//
// Forward, for every Gaussian (xyz, activated scale, unit quaternion,
// opacity, SH coefficients (K, 3), camera-facing plane normal and offset):
// the view-space mean and depth; the pixel mean through the full
// projection (homogeneous divide by w + 1e-7); the EWA 2D covariance with
// the mean clamped to ±1.3·tan(fov) of the frustum and the +0.3 px
// dilation; its conic (det != 0 guarded); the SH colour of the view
// direction (coefficients of degree above the active one masked to 0·c,
// +0.5, clamped at 0); the camera-space plane normal and |offset|; and the
// integer outputs: the radius ceil(3·sqrt(lambda_max)), the opacity-aware
// per-axis tile rectangle, its tile count, all zero where the Gaussian is
// culled (view z <= 0.2, det == 0, no tile, opacity <= 1/255, not alive).
// Backward: the cotangents of the pixel mean, conic, colour, plane normal
// and plane distance give the gradients of xyz, scale, quaternion, SH
// coefficients, plane normal and plane offset.  The depth and the integer
// outputs carry no gradient; lambda_max, the rectangle and its cutoff reach
// only integer outputs.
//
// What bounds it on the card: bytes.  Each Gaussian is independent and
// takes about 450 float operations forward and 1,100 backward against 245
// (forward) and 376 (backward) bytes at SH degree 2: at 1,310,720
// Gaussians 0.32 / 0.49 GB, 0.096 / 0.147 ms at 3.35 TB/s, against 0.59
// / 1.46 GFLOP, 0.009 / 0.022 ms at 67 TFLOP/s.
//
// Design: one thread per Gaussian in both kernels, no shared memory, no
// atomics, no reduction across threads; repeats are bit-identical.  The
// backward recomputes the forward's intermediates in registers rather
// than reading them back (a saved copy would cost more bytes than the
// recomputation costs time).  The SH degree is a template parameter, so
// the basis and the coefficient loops unroll into registers; -1 is the
// build without colour (the caller's rgb_override passes around the
// kernels).  The camera (two 4x4 matrices and the centre) is read from
// device memory, the same 35 words for every thread.  A cotangent is read
// through its row and column strides, so the strided slices autograd hands
// back from `torch.cat` need no copy; a missing one reads as 0.
//
// Numerics: built with --fmad=false and IEEE division and square root,
// every float op in the order of the plain version's torch ops on the
// card, so each output rounds as there and the integer outputs agree
// exactly.  PyTorch's CUDA division by a host scalar multiplies by its
// float reciprocal (the tile divisions here), `1.0 / t` is a reciprocal,
// and every Python float constant is the float32 rounding of its double.
// The library calls are the plain version's: sqrtf, logf, rsqrtf, ceilf,
// floorf.  The plane's dot products are fused multiply-add chains, each
// step a float64 product and sum rounded to float as the plain version's
// float64 ops round them.  clamp propagates NaN; float -> int32 maps NaN to 0 and
// saturates.  The backward follows autograd's rules: clamp passes the
// gradient at its bounds and gives 0 outside them (also to a NaN
// gradient), `where` routes it, |x| has gradient sign(x) (0 at 0 and at
// NaN), 1/x has -g/x², x/y gives g/y and -g·(x/y)/y, rsqrt -0.5·g·r³;
// where the plain version's gradient is non-finite the kernel's is too.
//
// The per-Gaussian math is in HD functions, so a host build of this file
// (without __CUDACC__) computes the same values on the CPU.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// the plain version's Python float constants, rounded to float32
constexpr float NEAR_CULL_Z = (float)0.2;
constexpr float DILATION = (float)0.3;
constexpr float PROJ_EPS = (float)1e-7;
constexpr float DIR_EPS = (float)1e-24;
constexpr float LAM_MIN = (float)0.1;
constexpr float OPACITY_FLOOR = (float)1.000001;
constexpr float MIN_OPACITY = (float)(1.0 / 255.0);
constexpr float I32_LO = (float)-2147483648.0;
constexpr float I32_HI = (float)2147483520.0;  // 2^31 - 128

// SH basis constants (ibgs_tpu_torch/core/sh.py)
constexpr float C0 = (float)0.28209479177387814;
constexpr float C1 = (float)0.4886025119029199;
constexpr float NC1 = (float)-0.4886025119029199;
constexpr float C2_0 = (float)1.0925484305920792;
constexpr float C2_1 = (float)-1.0925484305920792;
constexpr float C2_2 = (float)0.31539156525252005;
constexpr float C2_3 = (float)-1.0925484305920792;
constexpr float C2_4 = (float)0.5462742152960396;
constexpr float C3_0 = (float)-0.5900435899266435;
constexpr float C3_1 = (float)2.890611442640554;
constexpr float C3_2 = (float)-0.4570457994644658;
constexpr float C3_3 = (float)0.3731763325901154;
constexpr float C3_4 = (float)-0.4570457994644658;
constexpr float C3_5 = (float)1.445305721320277;
constexpr float C3_6 = (float)-0.5900435899266435;

struct Params {
  // inputs, contiguous: (P, 3), (P, 3), (P, 4), (P,), (P, K, 3), (P, 3),
  // (P,), (P,) bool or null
  const float* xyz;
  const float* scale;
  const float* quat;
  const float* opacity;
  const float* sh;
  const float* normal;
  const float* offset;
  const uint8_t* alive;
  long long P;
  int active;  // active SH degree
  // the camera: (4, 4) world -> view and world -> clip, row-major, (3,)
  const float* view;
  const float* full;
  const float* cam_pos;
  float fx, fy, lim_x, lim_y;
  int width, height, tile_h, tile_w, tiles_x, tiles_y;
  // forward outputs: mean2d (P, 2), depth (P,), conic (P, 3), rgb (P, 3),
  // plane normal (P, 3), plane distance (P,); radius (P,), rect_min,
  // rect_max (P, 2), n_tiles (P,) int32
  float* mean2d;
  float* depth;
  float* conic;
  float* rgb;
  float* plane_normal;
  float* plane_dist;
  int* radius;
  int* rect_min;
  int* rect_max;
  int* n_tiles;
  // backward: the cotangents of mean2d, conic, rgb, plane normal and plane
  // distance (null = 0) with their row and column strides in floats, and
  // the gradients, contiguous: xyz, scale, quat, sh, normal, offset
  const float* ct[5];
  long long ct_row[5];
  long long ct_col[5];
  float* d_xyz;
  float* d_scale;
  float* d_quat;
  float* d_sh;
  float* d_normal;
  float* d_offset;
};

// NaN test that needs no math header (the build has no fast-math)
HD bool is_nan(float v) { return v != v; }
HD float clamp_f(float v, float lo, float hi) {
  return is_nan(v) ? v : fminf(fmaxf(v, lo), hi);
}
HD float clamp_min_f(float v, float lo) { return is_nan(v) ? v : fmaxf(v, lo); }
HD float clamp_max_f(float v, float hi) { return is_nan(v) ? v : fminf(v, hi); }
HD int clamp_i(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
// float -> int32 as the plain version's to_i32: NaN -> 0, saturate, truncate
HD int to_i32(float v) {
  v = is_nan(v) ? 0.0f : fminf(fmaxf(v, I32_LO), I32_HI);
  return (int)v;
}
// torch.sign: 0 at 0 and at NaN
HD float sign_f(float v) { return (float)((0.0f < v) - (v < 0.0f)); }
HD float rsqrt_f(float v) {
#ifdef __CUDA_ARCH__
  return rsqrtf(v);
#else
  return 1.0f / sqrtf(v);
#endif
}

// Row r of a row-major 4x4 matrix applied to the point x, summed left to
// right as the port's transforms._affine_row.
HD float affine_row(const float* M, int r, const float x[3]) {
  return ((x[0] * M[4 * r] + x[1] * M[4 * r + 1]) + x[2] * M[4 * r + 2]) +
         M[4 * r + 3];
}

// The forward's geometry of one Gaussian: what the conic, the pixel mean
// and the integer outputs read, and what the backward chains through.
struct Geo {
  float mv[3];              // view-space mean
  float h0, h1, w;          // clip rows 0 and 1; 1 / (clip w + 1e-7)
  float m[2];               // pixel mean
  float rx, ry, cx, cy;     // mean / z, clamped to the frustum
  float tx, ty, inv_z, inv_z2, j00, j02, j11, j12;
  float U0[3], U1[3];       // J @ W
  float R[3][3], s2[3];     // rotation, squared scales
  float Sm[3][3];           // world covariance
  float a, b, c, det, inv_det;
  bool det_ok;
};

HD void geometry(const float x[3], const float s[3], const float q[4],
                 const Params& p, Geo& g) {
  const float* V = p.view;
  const float* F = p.full;
  for (int r = 0; r < 3; ++r) g.mv[r] = affine_row(V, r, x);
  g.h0 = affine_row(F, 0, x);
  g.h1 = affine_row(F, 1, x);
  g.w = 1.0f / (affine_row(F, 3, x) + PROJ_EPS);
  g.m[0] = (((g.h0 * g.w) + 1.0f) * (float)p.width - 1.0f) * 0.5f;
  g.m[1] = (((g.h1 * g.w) + 1.0f) * (float)p.height - 1.0f) * 0.5f;

  // EWA: the Jacobian at the frustum-clamped mean
  const float tz = g.mv[2];
  g.rx = g.mv[0] / tz;
  g.cx = clamp_f(g.rx, -p.lim_x, p.lim_x);
  g.tx = g.cx * tz;
  g.ry = g.mv[1] / tz;
  g.cy = clamp_f(g.ry, -p.lim_y, p.lim_y);
  g.ty = g.cy * tz;
  g.inv_z = 1.0f / tz;
  g.inv_z2 = g.inv_z * g.inv_z;
  g.j00 = p.fx * g.inv_z;
  g.j02 = (-p.fx * g.tx) * g.inv_z2;
  g.j11 = p.fy * g.inv_z;
  g.j12 = (-p.fy * g.ty) * g.inv_z2;
  for (int k = 0; k < 3; ++k) {
    g.U0[k] = g.j00 * V[k] + g.j02 * V[8 + k];
    g.U1[k] = g.j11 * V[4 + k] + g.j12 * V[8 + k];
  }

  // world covariance R diag(s²) Rᵀ
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  g.R[0][0] = 1.0f - 2.0f * (qy * qy + qz * qz);
  g.R[0][1] = 2.0f * (qx * qy - qw * qz);
  g.R[0][2] = 2.0f * (qx * qz + qw * qy);
  g.R[1][0] = 2.0f * (qx * qy + qw * qz);
  g.R[1][1] = 1.0f - 2.0f * (qx * qx + qz * qz);
  g.R[1][2] = 2.0f * (qy * qz - qw * qx);
  g.R[2][0] = 2.0f * (qx * qz - qw * qy);
  g.R[2][1] = 2.0f * (qy * qz + qw * qx);
  g.R[2][2] = 1.0f - 2.0f * (qx * qx + qy * qy);
  for (int k = 0; k < 3; ++k) g.s2[k] = s[k] * s[k];
  for (int i = 0; i < 3; ++i)
    for (int j = i; j < 3; ++j) {
      const float v = ((g.R[i][0] * g.R[j][0]) * g.s2[0] +
                       (g.R[i][1] * g.R[j][1]) * g.s2[1]) +
                      (g.R[i][2] * g.R[j][2]) * g.s2[2];
      g.Sm[i][j] = v;
      g.Sm[j][i] = v;
    }

  // 2D covariance (a, b, c): 0 + Σ_ij (Ua_i·S_ij)·Ub_j, then the dilation
  float qa = 0.0f, qb = 0.0f, qc = 0.0f;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      qa = qa + (g.U0[i] * g.Sm[i][j]) * g.U0[j];
      qb = qb + (g.U0[i] * g.Sm[i][j]) * g.U1[j];
      qc = qc + (g.U1[i] * g.Sm[i][j]) * g.U1[j];
    }
  g.a = qa + DILATION;
  g.b = qb;
  g.c = qc + DILATION;
  g.det = g.a * g.c - g.b * g.b;
  g.det_ok = g.det != 0.0f;
  g.inv_det = 1.0f / (g.det_ok ? g.det : 1.0f);
}

// The SH degree of coefficient k.
HD int coeff_degree(int k) { return k < 1 ? 0 : k < 4 ? 1 : k < 9 ? 2 : 3; }

// The view direction, normalised as x·rsqrt(|x|² + 1e-24).
struct Dir {
  float d[3], inv, v[3];
};

HD void view_dir(const float x[3], const Params& p, Dir& r) {
  for (int k = 0; k < 3; ++k) r.d[k] = x[k] - p.cam_pos[k];
  const float ss = (r.d[0] * r.d[0] + r.d[1] * r.d[1]) + r.d[2] * r.d[2];
  r.inv = rsqrt_f(ss + DIR_EPS);
  for (int k = 0; k < 3; ++k) r.v[k] = r.d[k] * r.inv;
}

// The SH basis of degree DEG at the unit direction (x, y, z), times the
// active-degree mask.
template <int DEG>
HD void sh_basis(float x, float y, float z, int active, float* b) {
  b[0] = C0;
  if constexpr (DEG >= 1) {
    b[1] = NC1 * y;
    b[2] = C1 * z;
    b[3] = NC1 * x;
  }
  if constexpr (DEG >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = C2_0 * xy;
    b[5] = C2_1 * yz;
    b[6] = C2_2 * ((2.0f * zz - xx) - yy);
    b[7] = C2_3 * xz;
    b[8] = C2_4 * (xx - yy);
    if constexpr (DEG >= 3) {
      b[9] = (C3_0 * y) * (3.0f * xx - yy);
      b[10] = (C3_1 * xy) * z;
      b[11] = (C3_2 * y) * ((4.0f * zz - xx) - yy);
      b[12] = (C3_3 * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
      b[13] = (C3_4 * x) * ((4.0f * zz - xx) - yy);
      b[14] = (C3_5 * z) * (xx - yy);
      b[15] = (C3_6 * x) * (xx - 3.0f * yy);
    }
  }
  constexpr int K = (DEG + 1) * (DEG + 1);
  for (int k = 0; k < K; ++k)
    b[k] = b[k] * (coeff_degree(k) <= active ? 1.0f : 0.0f);
}

// The raw SH sum Σ_k b_k·sh_k (left to right) of one Gaussian's (K, 3)
// coefficients.
template <int K>
HD void sh_sum(const float* b, const float* sh, float raw[3]) {
  for (int ch = 0; ch < 3; ++ch) raw[ch] = b[0] * sh[ch];
  for (int k = 1; k < K; ++k)
    for (int ch = 0; ch < 3; ++ch) raw[ch] = raw[ch] + b[k] * sh[3 * k + ch];
}

// a·b + c rounded once to float, as the plain version's float64 product
// (exact) and sum rounds it: a fused multiply-add
HD float fma_f64(float a, float b, float c) {
  return (float)((double)a * (double)b + (double)c);
}

// a·b of 3-vectors as the plain version's `_dot3`: a fused multiply-add
// chain, left to right
HD float dot3(float a0, float a1, float a2, float b0, float b1, float b2) {
  return fma_f64(a2, b2, fma_f64(a1, b1, a0 * b0));
}

// The camera-space plane: normal n_cam = W n and distance |dist_world -
// n_cam·t| with dist_world = -(n·x) + offset.
struct Plane {
  float nc[3], dc;
};

HD void camera_plane(const float n[3], float off, const float x[3],
                     const Params& p, Plane& pl) {
  const float* V = p.view;
  for (int r = 0; r < 3; ++r)
    pl.nc[r] = dot3(n[0], n[1], n[2], V[4 * r], V[4 * r + 1], V[4 * r + 2]);
  const float dw = -dot3(n[0], n[1], n[2], x[0], x[1], x[2]) + off;
  pl.dc = dw - dot3(pl.nc[0], pl.nc[1], pl.nc[2], V[3], V[7], V[11]);
}

HD void load3(const float* src, long long i, float v[3]) {
  for (int k = 0; k < 3; ++k) v[k] = src[3 * i + k];
}

// The forward of Gaussian i.
template <int DEG>
HD void forward_one(const Params& p, long long i) {
  float x[3], s[3], q[4], n[3];
  load3(p.xyz, i, x);
  load3(p.scale, i, s);
  for (int k = 0; k < 4; ++k) q[k] = p.quat[4 * i + k];
  load3(p.normal, i, n);
  const float op = p.opacity[i];

  Geo g;
  geometry(x, s, q, p, g);
  p.mean2d[2 * i] = g.m[0];
  p.mean2d[2 * i + 1] = g.m[1];
  p.depth[i] = g.mv[2];
  p.conic[3 * i] = g.c * g.inv_det;
  p.conic[3 * i + 1] = -g.b * g.inv_det;
  p.conic[3 * i + 2] = g.a * g.inv_det;

  // radius and the opacity-aware per-axis tile rectangle
  const float mid = 0.5f * (g.a + g.c);
  const float lam = mid + sqrtf(clamp_min_f(mid * mid - g.det, LAM_MIN));
  const float radius_f = ceilf(3.0f * sqrtf(lam));
  const float cutoff =
      sqrtf(2.0f * logf(clamp_min_f(255.0f * op, OPACITY_FLOOR)));
  const float rr = ceilf(clamp_max_f(cutoff, 3.0f) * sqrtf(lam));
  const float tr[2] = {cutoff * sqrtf(g.a), cutoff * sqrtf(g.c)};
  const int tile[2] = {p.tile_w, p.tile_h};
  const int tiles[2] = {p.tiles_x, p.tiles_y};
  int lo[2], hi[2];
  for (int k = 0; k < 2; ++k) {
    const float inv_t = 1.0f / (float)tile[k];
    const float m = g.m[k];
    const int lo_ref = to_i32((m - rr) * inv_t);
    const int lo_cov = to_i32(floorf((m - tr[k]) * inv_t));
    lo[k] = clamp_i(lo_ref > lo_cov ? lo_ref : lo_cov, 0, tiles[k]);
    const int hi_ref = to_i32((((m + rr) + (float)tile[k]) - 1.0f) * inv_t);
    const int hi_cov = to_i32(floorf((m + tr[k]) * inv_t)) + 1;
    hi[k] = clamp_i(hi_ref < hi_cov ? hi_ref : hi_cov, 0, tiles[k]);
    hi[k] = hi[k] > lo[k] ? hi[k] : lo[k];
  }
  const int nt = (hi[0] - lo[0]) * (hi[1] - lo[1]);
  const bool valid = g.mv[2] > NEAR_CULL_Z && g.det_ok && nt > 0 &&
                     op > MIN_OPACITY && (p.alive == nullptr || p.alive[i]);
  p.radius[i] = valid ? to_i32(radius_f) : 0;
  p.n_tiles[i] = valid ? nt : 0;
  p.rect_min[2 * i] = lo[0];
  p.rect_min[2 * i + 1] = lo[1];
  p.rect_max[2 * i] = hi[0];
  p.rect_max[2 * i + 1] = hi[1];

  if constexpr (DEG >= 0) {
    constexpr int K = (DEG + 1) * (DEG + 1);
    Dir dir;
    view_dir(x, p, dir);
    float b[K], raw[3];
    sh_basis<DEG>(dir.v[0], dir.v[1], dir.v[2], p.active, b);
    sh_sum<K>(b, p.sh + 3 * K * i, raw);
    for (int ch = 0; ch < 3; ++ch)
      p.rgb[3 * i + ch] = clamp_min_f(raw[ch] + 0.5f, 0.0f);
  }

  Plane pl;
  camera_plane(n, p.offset[i], x, p, pl);
  for (int r = 0; r < 3; ++r) p.plane_normal[3 * i + r] = pl.nc[r];
  p.plane_dist[i] = fabsf(pl.dc);
}

// Cotangent t, column c, of Gaussian i (0 where the cotangent is absent).
HD float cot(const Params& p, int t, long long i, int c) {
  return p.ct[t] == nullptr ? 0.0f
                            : p.ct[t][i * p.ct_row[t] + c * p.ct_col[t]];
}

// The gradient of the direction's SH colour w.r.t. the unit direction v,
// from the gradient gb of the masked basis.
template <int DEG>
HD void sh_basis_bwd(const float v[3], const float* gb, float gv[3]) {
  const float x = v[0], y = v[1], z = v[2];
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  if constexpr (DEG >= 1) {
    gy = gy + gb[1] * NC1;
    gz = gz + gb[2] * C1;
    gx = gx + gb[3] * NC1;
  }
  if constexpr (DEG >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z, xy = x * y;
    float gxx = 0.0f, gyy = 0.0f, gzz = 0.0f;
    float gxy = gb[4] * C2_0, gyz = gb[5] * C2_1, gxz = gb[7] * C2_3;
    float t = gb[6] * C2_2;
    gzz = gzz + 2.0f * t;
    gxx = gxx - t;
    gyy = gyy - t;
    t = gb[8] * C2_4;
    gxx = gxx + t;
    gyy = gyy - t;
    if constexpr (DEG >= 3) {
      gy = gy + (gb[9] * C3_0) * (3.0f * xx - yy);
      t = gb[9] * (C3_0 * y);
      gxx = gxx + 3.0f * t;
      gyy = gyy - t;
      gxy = gxy + (gb[10] * z) * C3_1;
      gz = gz + gb[10] * (C3_1 * xy);
      gy = gy + (gb[11] * C3_2) * ((4.0f * zz - xx) - yy);
      t = gb[11] * (C3_2 * y);
      gzz = gzz + 4.0f * t;
      gxx = gxx - t;
      gyy = gyy - t;
      gz = gz + (gb[12] * C3_3) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
      t = gb[12] * (C3_3 * z);
      gzz = gzz + 2.0f * t;
      gxx = gxx - 3.0f * t;
      gyy = gyy - 3.0f * t;
      gx = gx + (gb[13] * C3_4) * ((4.0f * zz - xx) - yy);
      t = gb[13] * (C3_4 * x);
      gzz = gzz + 4.0f * t;
      gxx = gxx - t;
      gyy = gyy - t;
      gz = gz + (gb[14] * C3_5) * (xx - yy);
      t = gb[14] * (C3_5 * z);
      gxx = gxx + t;
      gyy = gyy - t;
      gx = gx + (gb[15] * C3_6) * (xx - 3.0f * yy);
      t = gb[15] * (C3_6 * x);
      gxx = gxx + t;
      gyy = gyy - 3.0f * t;
    }
    gx = gx + (2.0f * gxx * x + gxy * y + gxz * z);
    gy = gy + (2.0f * gyy * y + gxy * x + gyz * z);
    gz = gz + (2.0f * gzz * z + gyz * y + gxz * x);
  }
  gv[0] = gx;
  gv[1] = gy;
  gv[2] = gz;
}

// The backward of Gaussian i.
template <int DEG>
HD void backward_one(const Params& p, long long i) {
  float x[3], s[3], q[4], n[3];
  load3(p.xyz, i, x);
  load3(p.scale, i, s);
  for (int k = 0; k < 4; ++k) q[k] = p.quat[4 * i + k];
  load3(p.normal, i, n);
  const float* V = p.view;
  const float* F = p.full;
  float gx[3] = {0.0f, 0.0f, 0.0f};

  // ---- plane: pd = |dc|, dc = (-(n·x) + off) - n_cam·t ------------------
  {
    Plane pl;
    camera_plane(n, p.offset[i], x, p, pl);
    const float g_dc = cot(p, 4, i, 0) * sign_f(pl.dc);
    const float g_e = -g_dc;
    const float g_s = -g_dc;  // of n·x
    float g_nc[3];
    for (int r = 0; r < 3; ++r) g_nc[r] = cot(p, 3, i, r) + g_e * V[4 * r + 3];
    for (int c = 0; c < 3; ++c) {
      const float g_n = g_s * x[c] + ((g_nc[0] * V[c] + g_nc[1] * V[4 + c]) +
                                      g_nc[2] * V[8 + c]);
      p.d_normal[3 * i + c] = g_n;
      gx[c] = gx[c] + g_s * n[c];
    }
    p.d_offset[i] = g_dc;
  }

  // ---- colour: rgb = max(Σ_k b_k·sh_k + 0.5, 0) ---------------------------
  if constexpr (DEG >= 0) {
    constexpr int K = (DEG + 1) * (DEG + 1);
    Dir dir;
    view_dir(x, p, dir);
    const float* sh = p.sh + 3 * K * i;
    float b[K], raw[3], g_raw[3];
    sh_basis<DEG>(dir.v[0], dir.v[1], dir.v[2], p.active, b);
    sh_sum<K>(b, sh, raw);
    for (int ch = 0; ch < 3; ++ch)
      g_raw[ch] = raw[ch] + 0.5f >= 0.0f ? cot(p, 2, i, ch) : 0.0f;
    float gb[K];
    for (int k = 0; k < K; ++k) {
      for (int ch = 0; ch < 3; ++ch)
        p.d_sh[3 * K * i + 3 * k + ch] = g_raw[ch] * b[k];
      gb[k] = (g_raw[0] * sh[3 * k] + g_raw[1] * sh[3 * k + 1]) +
              g_raw[2] * sh[3 * k + 2];
      gb[k] = gb[k] * (coeff_degree(k) <= p.active ? 1.0f : 0.0f);
    }
    float gv[3];
    sh_basis_bwd<DEG>(dir.v, gb, gv);
    // v = d·inv, inv = rsqrt(|d|² + eps)
    const float g_inv = (gv[0] * dir.d[0] + gv[1] * dir.d[1]) + gv[2] * dir.d[2];
    const float g_ss = (-0.5f * g_inv) * ((dir.inv * dir.inv) * dir.inv);
    for (int k = 0; k < 3; ++k) {
      const float g_sq = g_ss * dir.d[k];
      gx[k] = gx[k] + (gv[k] * dir.inv + (g_sq + g_sq));
    }
  }

  Geo g;
  geometry(x, s, q, p, g);

  // ---- pixel mean: m = ((h·w + 1)·size - 1)·0.5 ---------------------------
  {
    const float g_n0 = (cot(p, 0, i, 0) * 0.5f) * (float)p.width;
    const float g_n1 = (cot(p, 0, i, 1) * 0.5f) * (float)p.height;
    const float g_w = g_n0 * g.h0 + g_n1 * g.h1;
    const float g_h0 = g_n0 * g.w, g_h1 = g_n1 * g.w;
    const float g_h3 = -g_w * (g.w * g.w);
    for (int c = 0; c < 3; ++c)
      gx[c] = gx[c] + ((g_h0 * F[c] + g_h1 * F[4 + c]) + g_h3 * F[12 + c]);
  }

  // ---- conic = (c, -b, a) / det ------------------------------------------
  const float gca = cot(p, 1, i, 0), gcb = cot(p, 1, i, 1),
              gcc = cot(p, 1, i, 2);
  float g_a = gcc * g.inv_det;
  float g_b = -(gcb * g.inv_det);
  float g_c = gca * g.inv_det;
  const float g_id = (gca * g.c + gcb * -g.b) + gcc * g.a;
  const float g_det = g.det_ok ? -g_id * (g.inv_det * g.inv_det) : 0.0f;
  g_a = g_a + g_det * g.c;
  g_c = g_c + g_det * g.a;
  const float g_bb = -g_det * g.b;
  g_b = g_b + (g_bb + g_bb);

  // ---- (a, b, c) = quadratic forms of U0, U1 through S ---------------------
  float gU0[3] = {0.0f, 0.0f, 0.0f}, gU1[3] = {0.0f, 0.0f, 0.0f};
  float gS[3][3];
  for (int i3 = 0; i3 < 3; ++i3)
    for (int j = 0; j < 3; ++j) {
      const float S = g.Sm[i3][j];
      // a term (Ua_i·S_ij)·Ub_j with gradient gq: Ub_j gets gq·(Ua_i·S_ij),
      // Ua_i gets (gq·Ub_j)·S_ij, S_ij gets (gq·Ub_j)·Ua_i
      float t = g_a * g.U0[j];
      gU0[j] = gU0[j] + g_a * (g.U0[i3] * S);
      gU0[i3] = gU0[i3] + t * S;
      float gs = t * g.U0[i3];
      t = g_b * g.U1[j];
      gU1[j] = gU1[j] + g_b * (g.U0[i3] * S);
      gU0[i3] = gU0[i3] + t * S;
      gs = gs + t * g.U0[i3];
      t = g_c * g.U1[j];
      gU1[j] = gU1[j] + g_c * (g.U1[i3] * S);
      gU1[i3] = gU1[i3] + t * S;
      gS[i3][j] = gs + t * g.U1[i3];
    }

  // ---- S = R diag(s²) Rᵀ --------------------------------------------------
  float gR[3][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  float g_s2[3] = {0.0f, 0.0f, 0.0f};
  for (int i3 = 0; i3 < 3; ++i3)
    for (int j = i3; j < 3; ++j) {
      const float g6 = i3 == j ? gS[i3][j] : gS[i3][j] + gS[j][i3];
      for (int k = 0; k < 3; ++k) {
        const float gp = g6 * g.s2[k];
        g_s2[k] = g_s2[k] + g6 * (g.R[i3][k] * g.R[j][k]);
        gR[i3][k] = gR[i3][k] + gp * g.R[j][k];
        gR[j][k] = gR[j][k] + gp * g.R[i3][k];
      }
    }
  for (int k = 0; k < 3; ++k) {
    const float t = g_s2[k] * s[k];
    p.d_scale[3 * i + k] = t + t;
  }
  {
    const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
    const float gw = 2.0f * (((((-qz * gR[0][1] + qy * gR[0][2]) +
                                qz * gR[1][0]) - qx * gR[1][2]) -
                              qy * gR[2][0]) + qx * gR[2][1]);
    const float gqx = 2.0f * (((((qy * gR[0][1] + qz * gR[0][2]) +
                                 qy * gR[1][0]) - qw * gR[1][2]) +
                               qz * gR[2][0]) + qw * gR[2][1]) -
                      4.0f * qx * (gR[1][1] + gR[2][2]);
    const float gqy = 2.0f * (((((qx * gR[0][1] + qw * gR[0][2]) +
                                 qx * gR[1][0]) + qz * gR[1][2]) -
                               qw * gR[2][0]) + qz * gR[2][1]) -
                      4.0f * qy * (gR[0][0] + gR[2][2]);
    const float gqz = 2.0f * (((((-qw * gR[0][1] + qx * gR[0][2]) +
                                 qw * gR[1][0]) + qy * gR[1][2]) +
                               qx * gR[2][0]) + qy * gR[2][1]) -
                      4.0f * qz * (gR[0][0] + gR[1][1]);
    p.d_quat[4 * i] = gw;
    p.d_quat[4 * i + 1] = gqx;
    p.d_quat[4 * i + 2] = gqy;
    p.d_quat[4 * i + 3] = gqz;
  }

  // ---- U = J W, J from the clamped mean ----------------------------------
  float g_j00 = 0.0f, g_j02 = 0.0f, g_j11 = 0.0f, g_j12 = 0.0f;
  for (int k = 0; k < 3; ++k) {
    g_j00 = g_j00 + gU0[k] * V[k];
    g_j02 = g_j02 + gU0[k] * V[8 + k];
    g_j11 = g_j11 + gU1[k] * V[4 + k];
    g_j12 = g_j12 + gU1[k] * V[8 + k];
  }
  float g_inv_z = g_j00 * p.fx + g_j11 * p.fy;
  const float g_tx = (g_j02 * g.inv_z2) * -p.fx;
  const float g_ty = (g_j12 * g.inv_z2) * -p.fy;
  const float g_inv_z2 = g_j02 * (-p.fx * g.tx) + g_j12 * (-p.fy * g.ty);
  g_inv_z = g_inv_z + (g_inv_z2 * g.inv_z + g_inv_z2 * g.inv_z);
  const float tz = g.mv[2];
  float g_tz = -g_inv_z * (g.inv_z * g.inv_z);
  g_tz = g_tz + (g_tx * g.cx + g_ty * g.cy);
  const float g_rx =
      g.rx >= -p.lim_x && g.rx <= p.lim_x ? g_tx * tz : 0.0f;
  const float g_ry =
      g.ry >= -p.lim_y && g.ry <= p.lim_y ? g_ty * tz : 0.0f;
  const float g_mv[3] = {g_rx / tz, g_ry / tz,
                         g_tz + (-g_rx * (g.rx / tz) + -g_ry * (g.ry / tz))};
  for (int c = 0; c < 3; ++c)
    gx[c] = gx[c] + ((g_mv[0] * V[c] + g_mv[1] * V[4 + c]) + g_mv[2] * V[8 + c]);
  for (int c = 0; c < 3; ++c) p.d_xyz[3 * i + c] = gx[c];
}

#ifdef __CUDACC__

template <int DEG>
__global__ void __launch_bounds__(THREADS)
    preprocess_fwd_kernel(const Params p) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < p.P) forward_one<DEG>(p, i);
}

template <int DEG>
__global__ void __launch_bounds__(THREADS)
    preprocess_bwd_kernel(const Params p) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < p.P) backward_one<DEG>(p, i);
}

using Kernel = void (*)(const Params);

// which: 0 forward, 1 backward; deg: -1 (no colour) .. 3.
Kernel kernel_for(int which, int deg) {
  switch (deg) {
    case -1: return which == 0 ? preprocess_fwd_kernel<-1> : preprocess_bwd_kernel<-1>;
    case 0: return which == 0 ? preprocess_fwd_kernel<0> : preprocess_bwd_kernel<0>;
    case 1: return which == 0 ? preprocess_fwd_kernel<1> : preprocess_bwd_kernel<1>;
    case 2: return which == 0 ? preprocess_fwd_kernel<2> : preprocess_bwd_kernel<2>;
    case 3: return which == 0 ? preprocess_fwd_kernel<3> : preprocess_bwd_kernel<3>;
    default: return nullptr;
  }
}

// The SH degree of K coefficients (0 = no colour: -1), or -2.
int degree_of(int K) {
  return K == 0 ? -1 : K == 1 ? 0 : K == 4 ? 1 : K == 9 ? 2 : K == 16 ? 3 : -2;
}

int launch(int which, int K, const Params& a, void* stream) {
  const Kernel k = kernel_for(which, degree_of(K));
  if (k == nullptr || a.P < 0 || a.tile_h < 1 || a.tile_w < 1)
    return (int)cudaErrorInvalidValue;
  if (a.P == 0) return (int)cudaSuccess;
  const long long blocks = (a.P + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  k<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

Params camera_params(long long P, int active, const float* view,
                     const float* full, const float* cam_pos, float fx,
                     float fy, float lim_x, float lim_y, int width,
                     int height, int tile_h, int tile_w) {
  Params a = {};
  a.P = P;
  a.active = active;
  a.view = view;
  a.full = full;
  a.cam_pos = cam_pos;
  a.fx = fx;
  a.fy = fy;
  a.lim_x = lim_x;
  a.lim_y = lim_y;
  a.width = width;
  a.height = height;
  a.tile_h = tile_h;
  a.tile_w = tile_w;
  a.tiles_x = tile_w > 0 ? (width + tile_w - 1) / tile_w : 0;
  a.tiles_y = tile_h > 0 ? (height + tile_h - 1) / tile_h : 0;
  return a;
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// Launches the forward on `stream` for P Gaussians: xyz, scale (P, 3),
// quat (P, 4), opacity (P,), sh (P, K, 3) (K in {1, 4, 9, 16}; K = 0 and
// sh null: no colour, rgb not written), normal (P, 3), offset (P,), alive
// (P,) bool or null, all contiguous float32; the camera's view and full
// projection (4, 4) and centre (3,) on the device; lim_x, lim_y the
// float32 products 1.3·tan(fov / 2) → the Splats2D fields.  Returns the
// CUDA error of the launch (0 = success).
extern "C" int ibgs_preprocess_fwd(
    const float* xyz, const float* scale, const float* quat,
    const float* opacity, const float* sh, const float* normal,
    const float* offset, const uint8_t* alive, long long P, int K,
    int active, const float* view, const float* full, const float* cam_pos,
    float fx, float fy, float lim_x, float lim_y, int width, int height,
    int tile_h, int tile_w, float* mean2d, float* depth, float* conic,
    float* rgb, float* plane_normal, float* plane_dist, int* radius,
    int* rect_min, int* rect_max, int* n_tiles, void* stream) {
  Params a = camera_params(P, active, view, full, cam_pos, fx, fy, lim_x,
                           lim_y, width, height, tile_h, tile_w);
  a.xyz = xyz;
  a.scale = scale;
  a.quat = quat;
  a.opacity = opacity;
  a.sh = sh;
  a.normal = normal;
  a.offset = offset;
  a.alive = alive;
  a.mean2d = mean2d;
  a.depth = depth;
  a.conic = conic;
  a.rgb = rgb;
  a.plane_normal = plane_normal;
  a.plane_dist = plane_dist;
  a.radius = radius;
  a.rect_min = rect_min;
  a.rect_max = rect_max;
  a.n_tiles = n_tiles;
  return launch(0, K, a, stream);
}

// Launches the backward on `stream`: the forward's float inputs (opacity
// and alive aside) and camera, `cts` the 5 cotangents (mean2d, conic,
// rgb, plane normal, plane distance; null = 0) with `ct_strides` their 10
// (row, column) strides in floats → the gradients of xyz, scale, quat, sh
// (not written when K = 0), normal and offset, contiguous.  Returns the
// CUDA error of the launch.
extern "C" int ibgs_preprocess_bwd(
    const float* xyz, const float* scale, const float* quat, const float* sh,
    const float* normal, const float* offset, long long P, int K, int active,
    const float* view, const float* full, const float* cam_pos, float fx,
    float fy, float lim_x, float lim_y, int width, int height,
    const float* const* cts, const long long* ct_strides, float* d_xyz,
    float* d_scale, float* d_quat, float* d_sh, float* d_normal,
    float* d_offset, void* stream) {
  Params a = camera_params(P, active, view, full, cam_pos, fx, fy, lim_x,
                           lim_y, width, height, 1, 1);
  a.xyz = xyz;
  a.scale = scale;
  a.quat = quat;
  a.sh = sh;
  a.normal = normal;
  a.offset = offset;
  for (int t = 0; t < 5; ++t) {
    a.ct[t] = cts[t];
    a.ct_row[t] = ct_strides[2 * t];
    a.ct_col[t] = ct_strides[2 * t + 1];
  }
  a.d_xyz = d_xyz;
  a.d_scale = d_scale;
  a.d_quat = d_quat;
  a.d_sh = d_sh;
  a.d_normal = d_normal;
  a.d_offset = d_offset;
  return launch(1, K, a, stream);
}

// Registers, local (spill) bytes per thread, CTAs one SM holds at once and
// threads per CTA of the kernel `which` (0 forward, 1 backward) for K SH
// coefficients, into out[0..3].
extern "C" int ibgs_preprocess_info(int which, int K, int* out) {
  const Kernel k = kernel_for(which, degree_of(K));
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)k);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, (const void*)k,
                                                      THREADS, 0);
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

#endif  // __CUDACC__
