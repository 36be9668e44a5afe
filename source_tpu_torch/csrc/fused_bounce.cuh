// One path-tracing bounce for one ray: the device functions shared by the
// fused forward kernels (fused_kernels.cu) and, through fused_adjoint.cuh, by
// the adjoint kernels (fused_bwd_kernels.cu), which replay the bounce with
// them before they reverse it.
//
// This is the per-thread form of ``bounce_core`` in tracer/fused.py, which is
// its plain PyTorch version and the specification: Russian roulette,
// intersection of every analytic leaf, winner select, Beer-Lambert and
// homogeneous volumes, material dispatch, state update, and the i32 bitfield
// of the discrete choices. Where the plain version evaluates every branch on
// every lane and selects, a thread here switches on its own winner leaf and
// material, so a ray pays for one normal and one material only.
//
// Same float route as the plain version, on purpose: every guard (ssqrt, sdiv,
// spow, norm3, the miss-lane sanitising, inv_dir's +-BIG, quad's a_ok/q_ok,
// the quartic's a == 0 guard, the polynomial arccos) is repeated literally,
// expressions keep their association, maxima propagate NaN like
// torch.maximum, and the file is built with -fmad=false and without fast
// math, because a lane within rounding of a threshold (t > eps, the winner's
// strict <, u < 1 - reflectivity, cdf < u, total internal reflection) would
// otherwise choose another branch and follow another path.
//
// SRC_BINS (the number of spectral bins) is a compile-time constant so the
// per-bin throughput and radiance live in registers.
#pragma once

#include <cuda_runtime.h>

#ifndef SRC_BINS
#error "compile with -DSRC_BINS=<number of spectral bins>"
#endif

namespace fb {

constexpr int NB = SRC_BINS;
constexpr int N_UNIFORMS = 10;

constexpr float BIG = 3e38f;
constexpr float PI = 3.14159265358979323846f;
constexpr float TWO_PI = 6.283185307179586f;  // (float)(2.0 * pi)
constexpr float T_EPS = 1e-4f;

// primitive types (primitive/analytic.py)
enum { TYPE_SPHERE = 0, TYPE_BOX = 1, TYPE_CYLINDER = 2, TYPE_CONE = 3,
       TYPE_PARABOLA = 4, TYPE_TORUS = 5 };
// material codes (optical/material/base.py)
enum { MAT_ABSORBER = 0, MAT_LAMBERT = 1, MAT_EMITTER = 2, MAT_NULL = 3,
       MAT_CONDUCTOR = 4, MAT_ROUGH_CONDUCTOR = 5, MAT_DIELECTRIC = 6,
       MAT_EMITTER_ANISO = 7, MAT_CHECKERBOARD = 8, MAT_LIGHT = 9,
       MAT_PERFECT_REFLECT = 10 };
enum { VOL_BEER = 1, VOL_HOMOGENEOUS = 2 };
// choice bitfield (tracer/fused.py)
enum { B_ALIVE = 0, B_HIT = 1, B_TRANSMIT = 2, B_TIR = 3, B_PICKLIGHT = 4,
       B_CONT = 5, B_CNTD = 6, B_ALIVENEXT = 7, B_EXIT = 8, LIGHT_SHIFT = 9,
       B_PARITY = 14, WIN_SHIFT = 16 };
// descriptor layout (tracer/fused.py spec_descriptor)
enum { D_L = 0, D_NVOL = 1, D_NIMP = 2, D_FLAGS = 3, D_MAT_BASE = 4,
       D_IMP_BASE = 5, D_MAT_STRIDE = 6, D_TAB_SIZE = 7, D_HEADER = 8,
       D_LEAF_WORDS = 5, D_VOL_WORDS = 3 };
enum { F_USE_MIS = 1, F_NEEDS_MIS = 2, F_HAS_DIELECTRIC = 4,
       F_HAS_CHECKER = 8, F_MAX_DISTANCE = 16 };

struct Cfg {
  int max_depth;
  int ext_min_depth;
  float p_ext;        // extinction probability
  float survive;      // (float)(1 / (1 - p_ext))
  float w_imp;        // important path weight
  float one_m_w_imp;  // (float)(1 - w_imp)
  float max_distance;
};

struct V3 {
  float x, y, z;
};

struct Ray {
  V3 o, d;
  float thr[NB];
  float rad[NB];
  float alive;  // 0 / 1
  float depth;
};

// --- guarded component math -------------------------------------------------

__device__ __forceinline__ float maxp(float a, float b) {
  // NaN-propagating maximum (fmaxf would drop the NaN)
  return (a != a || b != b) ? (a + b) : fmaxf(a, b);
}
__device__ __forceinline__ float minp(float a, float b) {
  return (a != a || b != b) ? (a + b) : fminf(a, b);
}
__device__ __forceinline__ float clampp(float x, float lo, float hi) {
  return minp(maxp(x, lo), hi);
}
__device__ __forceinline__ float ssqrt(float x) {
  return x > 0.0f ? sqrtf(x) : 0.0f;
}
__device__ __forceinline__ float sdiv(float a, float b, float eps = 1e-30f) {
  return fabsf(b) > eps ? a / b : 0.0f;
}
__device__ __forceinline__ float spow(float base, float e) {
  return base > 0.0f ? powf(base, e) : 0.0f;
}
__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);  // 0 -> 0, NaN -> NaN
}
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 norm3(float x, float y, float z) {
  float n2 = x * x + y * y + z * z;
  float inv = n2 > 1e-24f ? 1.0f / sqrtf(n2) : 0.0f;
  return V3{x * inv, y * inv, z * inv};
}
__device__ __forceinline__ V3 reflect(V3 d, V3 n) {
  float k = 2.0f * dot3(d, n);
  return V3{d.x - k * n.x, d.y - k * n.y, d.z - k * n.z};
}

struct Frame {
  V3 t, b, n;
};

// Duff et al. branchless ONB with an fp-noise-tolerant sign threshold.
__device__ __forceinline__ Frame make_frame(V3 n) {
  float s = n.z >= -1e-6f ? 1.0f : -1.0f;
  float a = -1.0f / (s + n.z);
  float b = n.x * n.y * a;
  Frame f;
  f.t = V3{1.0f + s * n.x * n.x * a, s * b, -s * n.x};
  f.b = V3{b, s + n.y * n.y * a, -n.y};
  f.n = n;
  return f;
}
__device__ __forceinline__ V3 from_frame(V3 v, const Frame& f) {
  return V3{v.x * f.t.x + v.y * f.b.x + v.z * f.n.x,
            v.x * f.t.y + v.y * f.b.y + v.z * f.n.y,
            v.x * f.t.z + v.y * f.b.z + v.z * f.n.z};
}
__device__ __forceinline__ V3 hemisphere_cosine(float u1, float u2) {
  float z = ssqrt(u1);
  float r = ssqrt(1.0f - u1);
  float phi = TWO_PI * u2;
  return V3{r * cosf(phi), r * sinf(phi), z};
}
__device__ __forceinline__ V3 cone_uniform(float u1, float u2, float cos_max) {
  float z = 1.0f - u1 * (1.0f - cos_max);
  float r = ssqrt(1.0f - z * z);
  float phi = TWO_PI * u2;
  return V3{r * cosf(phi), r * sinf(phi), z};
}

// --- nearest-positive-crossing closed forms ---------------------------------
// Each hit function returns the smallest crossing strictly greater than t_min
// (else BIG) and sets ``inside`` to the ray-origin containment flag.

struct Quad {
  float lo, hi;
  bool v;
};

__device__ __forceinline__ Quad quad(float a, float b, float c) {
  float disc = b * b - 4.0f * a * c;
  bool v = disc >= 0.0f;
  float sq = ssqrt(disc);
  float q = -0.5f * (b + (b >= 0.0f ? sq : -sq));
  bool a_ok = fabsf(a) > 1e-30f;
  bool q_ok = fabsf(q) > 1e-30f;
  float r0 = a_ok ? sdiv(q, a) : BIG;
  float r1 = q_ok ? sdiv(c, q) : r0;
  return Quad{minp(r0, r1), maxp(r0, r1), v && a_ok};
}

__device__ __forceinline__ void take_after(float& best, float t_min, float t,
                                           bool v) {
  if (v && t > t_min && t < best) best = t;
}

__device__ __forceinline__ float hit_sphere(V3 o, V3 d, float r, float t_min,
                                            bool& inside) {
  float a = dot3(d, d);
  float b = 2.0f * dot3(o, d);
  float c = dot3(o, o) - r * r;
  Quad q = quad(a, b, c);
  float best = BIG;
  take_after(best, t_min, q.lo, q.v);
  take_after(best, t_min, q.hi, q.v);
  inside = c < 0.0f;
  return best;
}

__device__ __forceinline__ float inv_dir(float x) {
  return fabsf(x) > 1e-30f ? sdiv(1.0f, x) : (x >= 0.0f ? BIG : -BIG);
}

__device__ __forceinline__ float hit_box(V3 o, V3 d, const float* p,
                                         float t_min, bool& inside) {
  float ix = inv_dir(d.x), iy = inv_dir(d.y), iz = inv_dir(d.z);
  float t0x = (p[0] - o.x) * ix;
  float t1x = (p[3] - o.x) * ix;
  float t0y = (p[1] - o.y) * iy;
  float t1y = (p[4] - o.y) * iy;
  float t0z = (p[2] - o.z) * iz;
  float t1z = (p[5] - o.z) * iz;
  float lo = maxp(maxp(minp(t0x, t1x), minp(t0y, t1y)), minp(t0z, t1z));
  float hi = minp(minp(maxp(t0x, t1x), maxp(t0y, t1y)), maxp(t0z, t1z));
  bool v = hi >= lo;
  inside = (o.x >= p[0]) && (o.x <= p[3]) && (o.y >= p[1]) && (o.y <= p[4]) &&
           (o.z >= p[2]) && (o.z <= p[5]);
  float best = BIG;
  take_after(best, t_min, lo, v);
  take_after(best, t_min, hi, v);
  return best;
}

// Smallest-distance-to-face-plane pick.
__device__ __forceinline__ V3 n_box(V3 p, const float* pp) {
  float cx = 0.5f * (pp[0] + pp[3]), cy = 0.5f * (pp[1] + pp[4]),
        cz = 0.5f * (pp[2] + pp[5]);
  float ex = 0.5f * (pp[3] - pp[0]), ey = 0.5f * (pp[4] - pp[1]),
        ez = 0.5f * (pp[5] - pp[2]);
  float qx = p.x - cx, qy = p.y - cy, qz = p.z - cz;
  float dx = fabsf(ex - fabsf(qx));
  float dy = fabsf(ey - fabsf(qy));
  float dz = fabsf(ez - fabsf(qz));
  bool on_x = (dx <= dy) && (dx <= dz);
  bool on_y = !on_x && (dy <= dz);
  bool on_z = !on_x && !on_y;
  return V3{on_x ? (qx >= 0.0f ? 1.0f : -1.0f) : 0.0f,
            on_y ? (qy >= 0.0f ? 1.0f : -1.0f) : 0.0f,
            on_z ? (qz >= 0.0f ? 1.0f : -1.0f) : 0.0f};
}

__device__ __forceinline__ float hit_cylinder(V3 o, V3 d, const float* p,
                                              float t_min, bool& inside) {
  float r = p[0], h = p[1];
  float a = d.x * d.x + d.y * d.y;
  float b = 2.0f * (o.x * d.x + o.y * d.y);
  float c = o.x * o.x + o.y * o.y - r * r;
  Quad q = quad(a, b, c);
  bool axial = a <= 1e-20f;
  bool in_tube = c <= 0.0f;
  float tube_lo = axial ? (in_tube ? -BIG : BIG) : (q.v ? q.lo : BIG);
  float tube_hi = axial ? (in_tube ? BIG : -BIG) : (q.v ? q.hi : -BIG);
  bool flat = fabsf(d.z) <= 1e-30f;
  float dz = flat ? 1e-30f : d.z;
  float s0 = sdiv(0.0f - o.z, dz, 1e-35f);
  float s1 = sdiv(h - o.z, dz, 1e-35f);
  bool in_slab = (o.z >= 0.0f) && (o.z <= h);
  float slab_lo = flat ? (in_slab ? -BIG : BIG) : minp(s0, s1);
  float slab_hi = flat ? (in_slab ? BIG : -BIG) : maxp(s0, s1);
  float lo = maxp(tube_lo, slab_lo);
  float hi = minp(tube_hi, slab_hi);
  bool v = hi >= lo;
  inside = in_tube && in_slab;
  float best = BIG;
  take_after(best, t_min, lo, v);
  take_after(best, t_min, hi, v);
  return best;
}

__device__ __forceinline__ V3 n_cylinder(V3 p, const float* pp) {
  float r = pp[0], h = pp[1];
  float rad = sqrtf(p.x * p.x + p.y * p.y + 1e-12f);
  float d_side = fabsf(rad - r);
  float d_bot = fabsf(p.z);
  float d_top = fabsf(p.z - h);
  bool side = (d_side <= d_bot) && (d_side <= d_top);
  bool bot = !side && (d_bot <= d_top);
  bool top = !side && !bot;
  return V3{side ? p.x / rad : 0.0f, side ? p.y / rad : 0.0f,
            bot ? -1.0f : (top ? 1.0f : 0.0f)};
}

__device__ __forceinline__ float hit_cone(V3 o, V3 d, const float* p,
                                          float t_min, bool& inside) {
  float r = p[0], h = p[1];
  float k = sdiv(r, h, 1e-30f);
  float wo = h - o.z;
  float wd = -d.z;
  float a = d.x * d.x + d.y * d.y - k * k * wd * wd;
  float b = 2.0f * (o.x * d.x + o.y * d.y - k * k * wo * wd);
  float c = o.x * o.x + o.y * o.y - k * k * wo * wo;
  Quad q = quad(a, b, c);
  float z0 = o.z + q.lo * d.z;
  float z1 = o.z + q.hi * d.z;
  bool v0 = q.v && (z0 >= 0.0f) && (z0 <= h);
  bool v1 = q.v && (z1 >= 0.0f) && (z1 <= h);
  bool nz = fabsf(d.z) > 1e-30f;
  float tc = sdiv(-o.z, nz ? d.z : 1.0f);
  float px = o.x + tc * d.x;
  float py = o.y + tc * d.y;
  bool vc = nz && (px * px + py * py <= r * r);
  float lim = k * (h - o.z);
  inside = (o.z >= 0.0f) && (o.z <= h) &&
           (o.x * o.x + o.y * o.y <= lim * lim);
  float best = BIG;
  take_after(best, t_min, q.lo, v0);
  take_after(best, t_min, q.hi, v1);
  take_after(best, t_min, tc, vc);
  return best;
}

__device__ __forceinline__ V3 n_cone(V3 p, const float* pp) {
  float r = pp[0], h = pp[1];
  float k = sdiv(r, h, 1e-30f);
  float rad = sqrtf(p.x * p.x + p.y * p.y + 1e-12f);
  float d_cap = fabsf(p.z);
  float inv = 1.0f / sqrtf(1.0f + k * k);
  float d_cone = fabsf(rad - k * (h - p.z)) * inv;
  bool cap = d_cap <= d_cone;
  return V3{cap ? 0.0f : p.x / rad * inv, cap ? 0.0f : p.y / rad * inv,
            cap ? -1.0f : k * inv};
}

__device__ __forceinline__ float hit_parabola(V3 o, V3 d, const float* p,
                                              float t_min, bool& inside) {
  float r = p[0], h = p[1];
  float a4 = sdiv(r * r, h, 1e-30f);
  float a = d.x * d.x + d.y * d.y;
  float b = 2.0f * (o.x * d.x + o.y * d.y) + a4 * d.z;
  float c = o.x * o.x + o.y * o.y + a4 * (o.z - h);
  Quad q = quad(a, b, c);
  float z0 = o.z + q.lo * d.z;
  float z1 = o.z + q.hi * d.z;
  bool v0 = q.v && (z0 >= 0.0f) && (z0 <= h);
  bool v1 = q.v && (z1 >= 0.0f) && (z1 <= h);
  bool lin = a <= 1e-20f;
  bool b_ok = fabsf(b) > 1e-30f;
  float tl = sdiv(-c, b_ok ? b : 1.0f);
  float zl = o.z + tl * d.z;
  bool vl = lin && b_ok && (zl >= 0.0f) && (zl <= h);
  float t0 = lin ? tl : q.lo;
  v0 = (lin && vl) || (!lin && v0);
  v1 = v1 && !lin;
  bool nz = fabsf(d.z) > 1e-30f;
  float tc = sdiv(-o.z, nz ? d.z : 1.0f);
  float px = o.x + tc * d.x;
  float py = o.y + tc * d.y;
  bool vc = nz && (px * px + py * py <= r * r);
  inside = (o.z >= 0.0f) && (o.z <= h) &&
           (o.x * o.x + o.y * o.y <= a4 * (h - o.z));
  float best = BIG;
  take_after(best, t_min, t0, v0);
  take_after(best, t_min, q.hi, v1);
  take_after(best, t_min, tc, vc);
  return best;
}

__device__ __forceinline__ V3 n_parabola(V3 p, const float* pp) {
  float r = pp[0], h = pp[1];
  float a4 = sdiv(r * r, h, 1e-30f);
  float d_cap = fabsf(p.z);
  float surf = fabsf(p.x * p.x + p.y * p.y + a4 * (p.z - h));
  bool cap = d_cap <= surf * 0.5f;
  return V3{cap ? 0.0f : 2.0f * p.x, cap ? 0.0f : 2.0f * p.y,
            cap ? -1.0f : a4};
}

// --- torus quartic (core/math/polyroots.py) -----------------------------------

__device__ __forceinline__ float pr_safe_sqrt(float x) {
  return x > 0.0f ? sqrtf(x) : 0.0f;
}
__device__ __forceinline__ float pr_cbrt(float x) {
  float ax = fabsf(x);
  float r = ax > 1e-24f ? powf(ax, 0.33333334f) : 0.0f;  // (float)(1/3)
  return signf(x) * r;
}

struct Root {
  float x;
  bool v;
};

// polyroots._quad_components: ((lo, v_lo), (hi, v_hi))
__device__ __forceinline__ void quad_components(float a, float b, float c,
                                                Root& rlo, Root& rhi) {
  const float eps = 1e-30f;
  float d = b * b - 4.0f * a * c;
  bool has_roots = d >= 0.0f;
  float sq = pr_safe_sqrt(has_roots ? d : 0.0f);
  float q = -0.5f * (b + signf(b) * sq);
  if (b == 0.0f) q = -0.5f * sq;
  bool lin = fabsf(a) < eps;
  float r0 = lin ? sdiv(-c, b, eps) : sdiv(q, a, eps);
  float r1 = sdiv(c, q, eps);
  bool v1 = has_roots && !lin && (fabsf(q) >= eps);
  bool v0 = (lin && (fabsf(b) >= eps)) || (!lin && has_roots);
  float r1_eff = v1 ? r1 : r0;
  rlo = Root{minp(r0, r1_eff), v0};
  rhi = Root{maxp(r0, r1_eff), v1};
}

// Polynomial arccos (Abramowitz & Stegun 4.4.45): the polynomial IS the
// function here, not acosf.
__device__ __forceinline__ float acos_poly(float x) {
  float ax = fabsf(x);
  float p = 1.5707288f + ax * (-0.2121144f + ax * (0.0742610f - 0.0187293f * ax));
  float om = 1.0f - ax;
  float a = (om > 0.0f ? sqrtf(om) : 0.0f) * p;
  return x >= 0.0f ? a : 3.14159265358979f - a;
}

__device__ __forceinline__ float cubic_largest(float b, float c, float d) {
  float A = c - b * b / 3.0f;
  float B = (2.0f * b * b * b - 9.0f * b * c + 27.0f * d) / 27.0f;
  float disc = (B * B) / 4.0f + (A * A * A) / 27.0f;
  float shift = -b / 3.0f;
  bool one = disc > 0.0f;
  float sq = pr_safe_sqrt(one ? disc : 0.0f);
  float single = pr_cbrt(-B / 2.0f + sq) + pr_cbrt(-B / 2.0f - sq) + shift;
  float Am = minp(A, -1e-24f);
  float m = 2.0f * pr_safe_sqrt(-Am / 3.0f);
  float arg = clampp(sdiv(3.0f * B, Am * m), -0.999999f, 0.999999f);
  float theta = acos_poly(arg) / 3.0f;
  return one ? single : m * cosf(theta) + shift;
}

// Four Newton-polished (root, valid) pairs of a x^4 + b x^3 + c x^2 + d x + e.
// ``seeds``, when given, receives the four roots as Ferrari leaves them, before
// the Newton steps (the adjoint reverses those steps from there).
__device__ __forceinline__ void solve_quartic(float a, float b, float c, float d,
                                              float e, int newton_iters,
                                              Root out[4],
                                              float* seeds = nullptr) {
  bool a_ok = fabsf(a) > 1e-30f;
  a = a_ok ? a : 1.0f;
  float inv_a = 1.0f / a;
  float b_ = b * inv_a, c_ = c * inv_a, d_ = d * inv_a, e_ = e * inv_a;
  float p = c_ - 3.0f * b_ * b_ / 8.0f;
  float q = d_ - b_ * c_ / 2.0f + b_ * b_ * b_ / 8.0f;
  float r = e_ - b_ * d_ / 4.0f + b_ * b_ * c_ / 16.0f -
            3.0f * b_ * b_ * b_ * b_ / 256.0f;
  float shift = -b_ / 4.0f;
  float z = cubic_largest(-p, -4.0f * r, 4.0f * p * r - q * q);
  float s = pr_safe_sqrt(z - p);
  bool deg = s <= 1e-12f;
  float t0 = z / 2.0f - sdiv(q, 2.0f * s);
  float t1 = z / 2.0f + sdiv(q, 2.0f * s);
  float dd = pr_safe_sqrt(p * p - 4.0f * r);
  if (deg) {
    t0 = (z + dd) / 2.0f;
    t1 = (z - dd) / 2.0f;
  }
  quad_components(1.0f, -s, t0, out[0], out[1]);
  quad_components(1.0f, s, t1, out[2], out[3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bool v = out[k].v && a_ok;
    float x = v ? out[k].x + shift : 0.0f;
    if (seeds) seeds[k] = x;
    for (int it = 0; it < newton_iters; ++it) {
      float poly = (((a * x + b) * x + c) * x + d) * x + e;
      float dpoly = ((4.0f * a * x + 3.0f * b) * x + 2.0f * c) * x + d;
      if (v) x = x - sdiv(poly, dpoly);
    }
    out[k] = Root{x, v};
  }
}

__device__ __forceinline__ bool torus_root_valid(float px, float py, float pz,
                                                 float R, float r) {
  float rad2 = px * px + py * py;
  float rad = sqrtf(rad2 + 1e-12f);
  float f = (rad - R) * (rad - R) + pz * pz - r * r;
  float tol = 1e-3f * (R * R + r * r + rad2 + pz * pz);
  return fabsf(f) <= tol;
}

struct TorusHit {
  float t;
  bool inside;
};

// The nearest torus crossing after t_min (BIG: none), and whether the origin
// is inside. Its own function (the quartic is long and rare), with the
// parameters and results by value: a call that takes no address leaves the
// caller's frame in registers. The analytic-BVH kernel (analytic_bvh.cu)
// calls it too, through hit_local.
__device__ __noinline__ TorusHit hit_torus(V3 o, V3 d, float R, float r,
                                           float t_min) {
  float dd = dot3(d, d);
  float od = dot3(o, d);
  float oo = dot3(o, o);
  float k = oo - r * r - R * R;
  float a4 = dd * dd;
  float a3 = 4.0f * dd * od;
  float a2 = 2.0f * dd * k + 4.0f * od * od + 4.0f * R * R * d.z * d.z;
  float a1 = 4.0f * k * od + 8.0f * R * R * o.z * d.z;
  float a0 = k * k - 4.0f * R * R * (r * r - o.z * o.z);
  Root roots[4];
  solve_quartic(a4, a3, a2, a1, a0, 3, roots);
  float best = BIG;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float ts = roots[i].v ? roots[i].x : 0.0f;
    float px = o.x + ts * d.x;
    float py = o.y + ts * d.y;
    float pz = o.z + ts * d.z;
    take_after(best, t_min, roots[i].x,
               roots[i].v && torus_root_valid(px, py, pz, R, r));
  }
  float rad = sqrtf(o.x * o.x + o.y * o.y + 1e-12f);
  return TorusHit{best, (rad - R) * (rad - R) + o.z * o.z <= r * r};
}

__device__ __forceinline__ V3 n_torus(V3 p, const float* pp) {
  float R = pp[0];
  float rad = sqrtf(p.x * p.x + p.y * p.y + 1e-12f);
  return V3{p.x - p.x / rad * R, p.y - p.y / rad * R, p.z};
}

__device__ __forceinline__ bool contains(int tid, V3 p, const float* pp) {
  switch (tid) {
    case TYPE_TORUS: {
      float R = pp[0], r = pp[1];
      float rad = sqrtf(p.x * p.x + p.y * p.y + 1e-12f);
      return (rad - R) * (rad - R) + p.z * p.z <= r * r;
    }
    case TYPE_SPHERE:
      return dot3(p, p) <= pp[0] * pp[0];
    case TYPE_BOX:
      return (p.x >= pp[0]) && (p.x <= pp[3]) && (p.y >= pp[1]) &&
             (p.y <= pp[4]) && (p.z >= pp[2]) && (p.z <= pp[5]);
    case TYPE_CYLINDER:
      return (p.x * p.x + p.y * p.y <= pp[0] * pp[0]) && (p.z >= 0.0f) &&
             (p.z <= pp[1]);
    case TYPE_CONE: {
      float k = sdiv(pp[0], pp[1], 1e-30f);
      float lim = k * (pp[1] - p.z);
      return (p.z >= 0.0f) && (p.z <= pp[1]) &&
             (p.x * p.x + p.y * p.y <= lim * lim);
    }
    default: {  // TYPE_PARABOLA
      float a4 = sdiv(pp[0] * pp[0], pp[1], 1e-30f);
      return (p.z >= 0.0f) && (p.x * p.x + p.y * p.y <= a4 * (pp[1] - p.z));
    }
  }
}

__device__ __forceinline__ float hit_local(int tid, V3 lo, V3 ld, const float* pp,
                                           float t_min, bool& inside) {
  switch (tid) {
    case TYPE_SPHERE: return hit_sphere(lo, ld, pp[0], t_min, inside);
    case TYPE_BOX: return hit_box(lo, ld, pp, t_min, inside);
    case TYPE_CYLINDER: return hit_cylinder(lo, ld, pp, t_min, inside);
    case TYPE_CONE: return hit_cone(lo, ld, pp, t_min, inside);
    case TYPE_PARABOLA: return hit_parabola(lo, ld, pp, t_min, inside);
    default: {
      const TorusHit h = hit_torus(lo, ld, pp[0], pp[1], t_min);
      inside = h.inside;
      return h.t;
    }
  }
}

__device__ __forceinline__ V3 normal_local(int tid, V3 ph, const float* pp) {
  switch (tid) {
    case TYPE_SPHERE: return ph;
    case TYPE_BOX: return n_box(ph, pp);
    case TYPE_CYLINDER: return n_cylinder(ph, pp);
    case TYPE_CONE: return n_cone(ph, pp);
    case TYPE_PARABOLA: return n_parabola(ph, pp);
    default: return n_torus(ph, pp);
  }
}

// point through the 12 row scalars of a world->local matrix
__device__ __forceinline__ V3 xf_point(const float* m, V3 p) {
  return V3{m[0] * p.x + m[1] * p.y + m[2] * p.z + m[3],
            m[4] * p.x + m[5] * p.y + m[6] * p.z + m[7],
            m[8] * p.x + m[9] * p.y + m[10] * p.z + m[11]};
}
__device__ __forceinline__ V3 xf_dir(const float* m, V3 d) {
  return V3{m[0] * d.x + m[1] * d.y + m[2] * d.z,
            m[4] * d.x + m[5] * d.y + m[6] * d.z,
            m[8] * d.x + m[9] * d.y + m[10] * d.z};
}

__device__ __forceinline__ float conductor_fresnel(float ci, float n, float k) {
  float ci2 = ci * ci;
  float n2k2 = n * n + k * k;
  float two_n_ci = 2.0f * n * ci;
  float rs = (n2k2 - two_n_ci + ci2) / maxp(n2k2 + two_n_ci + ci2, 1e-30f);
  float rp = (n2k2 * ci2 - two_n_ci + 1.0f) /
             maxp(n2k2 * ci2 + two_n_ci + 1.0f, 1e-30f);
  return 0.5f * (rs + rp);
}

// The important-sphere cone seen from ``point``: unit axis and cos of the
// half-angle (-1 when the point is inside the sphere).
__device__ __forceinline__ void imp_cone(const float* rec, V3 point, V3& ax,
                                         float& cm) {
  float r = rec[3];
  float tx = rec[0] - point.x;
  float ty = rec[1] - point.y;
  float tz = rec[2] - point.z;
  float dist2 = tx * tx + ty * ty + tz * tz;
  float dist = sqrtf(dist2 + 1e-12f);
  ax = V3{tx / dist, ty / dist, tz / dist};
  bool inside_s = dist <= r;
  float sr = sdiv(r, dist);
  float sin2 = clampp(sr * sr, 0.0f, 1.0f);
  float c2 = 1.0f - sin2;
  cm = c2 > 0.0f ? ssqrt(c2) : 0.0f;
  if (inside_s) cm = -1.0f;
}

// Mixture pdf of the important spheres in direction ``wo``. The cones are
// recomputed per sphere instead of held in registers (up to 31 of them).
__device__ __forceinline__ float light_pdf(const float* imp, int n_imp, V3 point,
                                           V3 wo) {
  float pdf = 0.0f;
  for (int i = 0; i < n_imp; ++i) {
    V3 ax;
    float cm;
    imp_cone(imp + 6 * i, point, ax, cm);
    float c = dot3(ax, wo);
    float solid = TWO_PI * (1.0f - cm);
    float pdf_i = c >= cm ? sdiv(1.0f, maxp(solid, 1e-12f)) : 0.0f;
    pdf = pdf + imp[6 * i + 4] * pdf_i;
  }
  return pdf;
}

// --- the bounce ---------------------------------------------------------------
// ``ray`` must be alive on entry. Returns the choice bitfield; a ray that the
// roulette or the depth bound stops before its segment returns 0.
//
// MODE is DECIDE (the forward kernels: every discrete choice is made here and
// returned in the bitfield) or REPLAY (the profiling kernel
// fused_bounce_replay: the choices the bitfield stores -- winner leaf, hit,
// exiting, light pick and index, transmit, TIR, checkerboard parity,
// continues, counts toward depth, alive next -- are taken from ``bits``, as
// ``bounce_core(..., bits)`` does, and the code that makes them is not run:
// the other leaves' hit tests, the Fresnel reflectivity of the path roulette,
// the cell count, the throughput maximum). The roulette is recomputed from
// ``u`` in both, as in ``bounce_core``. REPLAY returns ``bits``.
enum { DECIDE = 0, REPLAY = 1 };

template <int MODE>
__device__ __forceinline__ int bounce_as(const float* __restrict__ tab,
                                         const int* __restrict__ desc,
                                         const Cfg& cfg, Ray& ray,
                                         const float* u, int bits) {
  const int L = desc[D_L];
  const int n_vol = desc[D_NVOL];
  const int n_imp = desc[D_NIMP];
  const int flags = desc[D_FLAGS];
  const int mat_base = desc[D_MAT_BASE];
  const int mat_stride = desc[D_MAT_STRIDE];
  const float* imp = tab + desc[D_IMP_BASE];
  const int* leaves = desc + D_HEADER;
  const int* vols = leaves + D_LEAF_WORDS * L;

  const V3 o = ray.o, d = ray.d;

  // --- Russian roulette (optical/ray.pyx:380-388) -----------------------------
  bool roulette_active = ray.depth >= (float)cfg.ext_min_depth;
  bool killed = roulette_active && (u[6] < cfg.p_ext);
  float survive_scale = (roulette_active && !killed) ? cfg.survive : 1.0f;
  bool alive = !killed && (ray.depth < (float)cfg.max_depth);
#pragma unroll
  for (int b = 0; b < NB; ++b) ray.thr[b] = ray.thr[b] * survive_scale;
  if (!alive) {
    ray.alive = 0.0f;
    return 0;
  }

  // --- intersection: loop over the leaf descriptor -----------------------------
  float eps = T_EPS * maxp(1.0f, maxp(fabsf(o.x), maxp(fabsf(o.y), fabsf(o.z))));
  float t_best = BIG;
  int win = 0;
  bool ins_sel = false;
  if constexpr (MODE == REPLAY) {
    // the winner's distance alone: the other leaves enter the bounce only
    // through the choice
    win = (bits >> WIN_SHIFT) & 0x1FF;
    ins_sel = (bits >> B_EXIT) & 1;
    const int* lf = leaves + D_LEAF_WORDS * win;
    const float* rec = tab + 20 * win;
    bool ins_g;
    if (lf[3] == 1) {
      V3 p0 = V3{o.x - rec[0], o.y - rec[1], o.z - rec[2]};
      t_best = hit_sphere(p0, d, rec[3], eps, ins_g);
    } else if (lf[3] == 2) {
      t_best = hit_box(o, d, rec, eps, ins_g);
    } else {
      t_best = hit_local(lf[0], xf_point(rec, o), xf_dir(rec, d), rec + 12,
                         eps, ins_g);
    }
  } else {
    for (int g = 0; g < L; ++g) {
      const int* lf = leaves + D_LEAF_WORDS * g;
      const float* rec = tab + 20 * g;
      int kind = lf[3];
      float t_g;
      bool ins_g;
      if (kind == 1) {  // world sphere: centre + radius, no transform
        V3 p0 = V3{o.x - rec[0], o.y - rec[1], o.z - rec[2]};
        t_g = hit_sphere(p0, d, rec[3], eps, ins_g);
      } else if (kind == 2) {  // world AABB
        t_g = hit_box(o, d, rec, eps, ins_g);
      } else {
        t_g = hit_local(lf[0], xf_point(rec, o), xf_dir(rec, d), rec + 12, eps,
                        ins_g);
      }
      // strict <: the first of equal distances wins; leaf 0's flag is the
      // default of a miss
      if (t_g < t_best || g == 0) {
        bool better = t_g < t_best;
        if (better) {
          t_best = t_g;
          win = g;
        }
        if (better || g == 0) ins_sel = ins_g;
      }
    }
  }
  bool hit;
  if constexpr (MODE == REPLAY) {
    hit = (bits >> B_HIT) & 1;
  } else {
    hit = t_best < 1e30f;
    if (flags & F_MAX_DISTANCE) hit = hit && (t_best <= cfg.max_distance);
  }

  // the winner's normal at the sanitised distance (0 on a miss: BIG * d
  // would overflow)
  const int* wl = leaves + D_LEAF_WORDS * win;
  const float* wrec = tab + 20 * win;
  float t_sel = t_best < 1e30f ? t_best : 0.0f;
  V3 nw;
  if (wl[3] == 1) {
    V3 p0 = V3{o.x - wrec[0], o.y - wrec[1], o.z - wrec[2]};
    nw = V3{p0.x + t_sel * d.x, p0.y + t_sel * d.y, p0.z + t_sel * d.z};
  } else if (wl[3] == 2) {
    V3 pw = V3{o.x + t_sel * d.x, o.y + t_sel * d.y, o.z + t_sel * d.z};
    nw = n_box(pw, wrec);
  } else {
    // local hit point as w2l . (world hit point), NOT lo + t * ld
    V3 pw = V3{o.x + t_sel * d.x, o.y + t_sel * d.y, o.z + t_sel * d.z};
    V3 ph = xf_point(wrec, pw);
    V3 nl = normal_local(wl[0], ph, wrec + 12);
    // local -> world normal via (w2l)^T
    nw = V3{wrec[0] * nl.x + wrec[4] * nl.y + wrec[8] * nl.z,
            wrec[1] * nl.x + wrec[5] * nl.y + wrec[9] * nl.z,
            wrec[2] * nl.x + wrec[6] * nl.y + wrec[10] * nl.z};
  }
  float t_safe = hit ? t_sel : 0.0f;
  nw = norm3(nw.x, nw.y, nw.z);
  bool exiting = ins_sel;
  float ddn = d.x * nw.x + d.y * nw.y + d.z * nw.z;
  bool flip = (exiting && (ddn < 0.0f)) || (!exiting && (ddn > 0.0f));
  float fs = flip ? -1.0f : 1.0f;
  V3 n = V3{nw.x * fs, nw.y * fs, nw.z * fs};

  V3 point = V3{o.x + t_safe * d.x, o.y + t_safe * d.y, o.z + t_safe * d.z};
  float off_p = T_EPS * maxp(1.0f, maxp(fabsf(point.x),
                                        maxp(fabsf(point.y), fabsf(point.z))));
  V3 outside_p = V3{point.x + n.x * off_p, point.y + n.y * off_p,
                    point.z + n.z * off_p};
  V3 inside_p = V3{point.x - n.x * off_p, point.y - n.y * off_p,
                   point.z - n.z * off_p};

  // --- volume stage (optical/ray.pyx:422-455) ------------------------------------
  // radd = the radiance this bounce adds; emission inside the segment is
  // weighted by the segment-start throughput, Beer-Lambert attenuates what
  // arrives from beyond it
  float radd[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) radd[b] = 0.0f;
  float t_seg = t_safe;
  if (n_vol > 0) {
    V3 mid = V3{o.x + 0.5f * t_seg * d.x, o.y + 0.5f * t_seg * d.y,
                o.z + 0.5f * t_seg * d.z};
    unsigned long long in_mask = 0ull;
    bool any_homog = false;
    for (int v = 0; v < n_vol; ++v) {
      const int* vr = vols + D_VOL_WORDS * v;
      const int* lf = leaves + D_LEAF_WORDS * vr[2];
      const float* rec = tab + 20 * vr[2];
      bool inside_v;
      if (lf[3] == 1) {
        float dx = mid.x - rec[0], dy = mid.y - rec[1], dz = mid.z - rec[2];
        inside_v = dx * dx + dy * dy + dz * dz <= rec[3] * rec[3];
      } else if (lf[3] == 2) {
        inside_v = contains(TYPE_BOX, mid, rec);
      } else {
        inside_v = contains(lf[0], xf_point(rec, mid), rec + 12);
      }
      if (inside_v && hit) in_mask |= 1ull << v;
      any_homog = any_homog || (vr[1] == VOL_HOMOGENEOUS);
    }
    if (any_homog) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float vol_em = 0.0f;
        for (int v = 0; v < n_vol; ++v) {
          const int* vr = vols + D_VOL_WORDS * v;
          if (vr[1] == VOL_HOMOGENEOUS) {
            float spec0 = tab[mat_base + vr[0] * mat_stride + 10 + b];
            vol_em = vol_em + (((in_mask >> v) & 1ull) ? spec0 * t_seg : 0.0f);
          }
        }
        radd[b] = radd[b] + ray.thr[b] * vol_em;
      }
    }
    for (int v = 0; v < n_vol; ++v) {
      const int* vr = vols + D_VOL_WORDS * v;
      if (vr[1] == VOL_BEER && ((in_mask >> v) & 1ull)) {
        const float* tr = tab + mat_base + vr[0] * mat_stride + 10 + NB;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          float base = tr[b];  // slot 1: transmission per metre
          float att = base > 1e-9f ? spow(base, t_seg) : 0.0f;
          ray.thr[b] = ray.thr[b] * att;
        }
      }
    }
  }

  // --- surface stage ---------------------------------------------------------------
  float cos_in = -ddn * fs;  // -d . n with the oriented normal
  bool front = cos_in >= 0.0f;
  float abs_cos_in = fabsf(cos_in);
  V3 n_sh = front ? n : V3{-n.x, -n.y, -n.z};
  Frame fr = make_frame(n_sh);
  V3 refl_origin = front ? outside_p : inside_p;
  V3 trans_origin = front ? inside_p : outside_p;

  V3 new_o = refl_origin;
  V3 new_d = d;
  bool continues = false;
  bool counts_depth = true;

  const int mt = wl[2];
  const float* mrec = tab + mat_base + wl[1] * mat_stride;
  const float* s0 = mrec + 10;
  const float* s1 = mrec + 10 + NB;

  // --- MIS shared precompute (world.pyx:134-253) -------------------------------------
  const bool use_mis = (flags & F_USE_MIS) != 0;
  int lidx = 0;
  bool pick_light = false;
  V3 dir_light = V3{0.0f, 0.0f, 0.0f};
  if (flags & F_NEEDS_MIS) {
    if constexpr (MODE == REPLAY) {
      lidx = (bits >> LIGHT_SHIFT) & 0x1F;
      pick_light = (bits >> B_PICKLIGHT) & 1;
    } else {
      // cdf pick (searchsorted 'left' == count of cdf entries < u)
      for (int i = 0; i < n_imp; ++i) lidx += (imp[6 * i + 5] < u[3]) ? 1 : 0;
      lidx = min(max(lidx, 0), n_imp - 1);
      pick_light = u[0] < cfg.w_imp;
    }
    if (mt == MAT_LAMBERT || mt == MAT_ROUGH_CONDUCTOR) {
      V3 ax_s;
      float cm_s;
      imp_cone(imp + 6 * lidx, point, ax_s, cm_s);
      V3 local = cone_uniform(u[4], u[5], cm_s);
      dir_light = from_frame(local, make_frame(ax_s));
    }
  }

  bool transmit = false, tir_out = false;
  // a non-checkerboard lane of a scene that has one reports parity 1 (cell 0)
  bool check_parity = (flags & F_HAS_CHECKER) != 0;

  // dielectric decisions are part of every lane's bitfield in a scene with a
  // dielectric (lanes on another material take n = 1.5 / 1.0)
  V3 diel_d = d, diel_o = refl_origin;
  bool diel_ok = false;
  if (flags & F_HAS_DIELECTRIC) {
    bool m = mt == MAT_DIELECTRIC;
    float n_int = m ? maxp(mrec[8], 1e-3f) : 1.5f;
    float n_ext = m ? maxp(mrec[9], 1e-3f) : 1.0f;
    bool trans_only = m && (mrec[0] > 0.5f);
    float c1 = cos_in;
    bool entering = c1 >= 0.0f;
    float n1 = entering ? n_ext : n_int;
    float n2 = entering ? n_int : n_ext;
    float gamma = n1 / n2;
    float c2s = 1.0f - gamma * gamma * (1.0f - c1 * c1);
    bool tir = c2s <= 0.0f;
    float sq = !tir ? ssqrt(c2s) : 0.0f;
    float temp_t = entering ? gamma * c1 - sq : gamma * c1 + sq;
    V3 td = norm3(gamma * d.x + temp_t * n.x, gamma * d.y + temp_t * n.y,
                  gamma * d.z + temp_t * n.z);
    V3 rdir = reflect(d, n);
    bool tr;
    if constexpr (MODE == REPLAY) {
      tr = (bits >> B_TRANSMIT) & 1;
      tir = (bits >> B_TIR) & 1;
    } else {
      float c2 = -dot3(n, td);
      float den1 = n1 * c1 + n2 * c2;
      float den2 = n1 * c2 + n2 * c1;
      float r1 = (n1 * c1 - n2 * c2) / (fabsf(den1) > 1e-12f ? den1 : 1e-12f);
      float r2 = (n1 * c2 - n2 * c1) / (fabsf(den2) > 1e-12f ? den2 : 1e-12f);
      float reflectivity = 0.5f * (r1 * r1 + r2 * r2);
      tr = trans_only || (u[0] < (1.0f - reflectivity));
    }
    tr = tr && !tir;
    diel_ok = m && !(tir && trans_only);
    diel_d = tr ? td : rdir;
    diel_o = tr ? trans_origin : refl_origin;
    transmit = tr;
    tir_out = tir;
  }

  // --- material dispatch: per-bin emission and throughput factor ---------------------
  const bool active = hit;  // alive is known here
#define FB_SURFACE(EM, MUL)                                          \
  _Pragma("unroll") for (int b = 0; b < NB; ++b) {                   \
    if (active) {                                                    \
      radd[b] = radd[b] + ray.thr[b] * (EM);                         \
      ray.thr[b] = ray.thr[b] * (MUL);                               \
    }                                                                \
  }

  switch (mt) {
    case MAT_EMITTER:
      FB_SURFACE(s0[b], 0.0f)
      break;
    case MAT_EMITTER_ANISO: {
      float factor = spow(maxp(abs_cos_in, 1e-9f), mrec[0]);
      FB_SURFACE(s0[b] * factor, 0.0f)
      break;
    }
    case MAT_CHECKERBOARD: {
      if constexpr (MODE == REPLAY) {
        check_parity = (bits >> B_PARITY) & 1;
      } else {
        float width = maxp(mrec[0], 1e-12f);
        // per-entity local frame (checkerboard.pyx:39 pattern frame)
        V3 pl = xf_point(tab + wl[4], point);
        int cells = (int)floorf(pl.x / width) + (int)floorf(pl.y / width) +
                    (int)floorf(pl.z / width);
        check_parity = (cells % 2) == 0;
      }
      FB_SURFACE(check_parity ? s0[b] : s1[b], 0.0f)
      break;
    }
    case MAT_LIGHT: {
      float fac = maxp(0.0f, -(mrec[0] * n_sh.x + mrec[1] * n_sh.y +
                               mrec[2] * n_sh.z));
      FB_SURFACE(s0[b] * fac, 0.0f)
      break;
    }
    case MAT_PERFECT_REFLECT:
      new_d = reflect(d, n_sh);
      continues = true;
      FB_SURFACE(0.0f, 1.0f)
      break;
    case MAT_NULL:
      continues = true;
      counts_depth = false;
      new_o = trans_origin;
      FB_SURFACE(0.0f, 1.0f)
      break;
    case MAT_LAMBERT: {
      V3 dir_bsdf = from_frame(hemisphere_cosine(u[1], u[2]), fr);
      V3 out_dir;
      float cos_out, pdf_bsdf, pdf;
      if (use_mis) {
        out_dir = pick_light ? dir_light : dir_bsdf;
        float pdf_light = light_pdf(imp, n_imp, point, out_dir);
        cos_out = dot3(out_dir, n_sh);
        pdf_bsdf = maxp(cos_out, 0.0f) / PI;
        pdf = cfg.w_imp * pdf_light + cfg.one_m_w_imp * pdf_bsdf;
      } else {
        out_dir = dir_bsdf;
        cos_out = dot3(out_dir, n_sh);
        pdf_bsdf = maxp(cos_out, 0.0f) / PI;
        pdf = pdf_bsdf;
      }
      bool ok = (pdf > 1e-9f) && (cos_out > 0.0f);
      float w_l = ok ? pdf_bsdf / maxp(pdf, 1e-12f) : 0.0f;
      new_d = out_dir;
      continues = ok;
      FB_SURFACE(0.0f, s0[b] * w_l)
      break;
    }
    case MAT_CONDUCTOR:
      new_d = reflect(d, n_sh);
      continues = true;
      FB_SURFACE(0.0f, conductor_fresnel(abs_cos_in, s0[b], s1[b]))
      break;
    case MAT_ROUGH_CONDUCTOR: {
      float rough = clampp(mrec[0], 1e-3f, 1.0f);
      float a2 = rough * rough;
      float phi = TWO_PI * u[2];
      float ct2 = clampp(
          sdiv(1.0f - u[1], maxp(1.0f + (a2 - 1.0f) * u[1], 1e-12f)), 0.0f,
          1.0f);
      float ct = sqrtf(ct2 + 1e-12f);
      float st = sqrtf(clampp(1.0f - ct2, 1e-12f, 1.0f));
      V3 h_bsdf = from_frame(V3{st * cosf(phi), st * sinf(phi), ct}, fr);
      V3 wi = V3{-d.x, -d.y, -d.z};
      V3 wo_bsdf = reflect(d, h_bsdf);
      V3 wo = (use_mis && pick_light) ? dir_light : wo_bsdf;
      V3 h_raw = V3{wi.x + wo.x, wi.y + wo.y, wi.z + wo.z};
      float h_len = sqrtf(maxp(dot3(h_raw, h_raw), 1e-24f));
      V3 h = V3{h_raw.x / h_len, h_raw.y / h_len, h_raw.z / h_len};
      float ct_i = maxp(dot3(wi, n_sh), 1e-6f);
      float ct_o = dot3(wo, n_sh);
      float ct_h = dot3(h, n_sh);
      float o_dot_h = dot3(wo, h);
      float dd = ct_h * ct_h * (a2 - 1.0f) + 1.0f;
      float d_ggx = a2 / maxp(PI * dd * dd, 1e-12f);
      float pdf_bsdf = 0.25f * d_ggx *
                       fabsf(ct_h / (fabsf(o_dot_h) > 1e-9f ? o_dot_h : 1e-9f));
      float pdf = pdf_bsdf;
      if (use_mis) {
        float pdf_light = light_pdf(imp, n_imp, point, wo);
        pdf = cfg.w_imp * pdf_light + cfg.one_m_w_imp * pdf_bsdf;
      }
      bool ok = (ct_o > 1e-6f) && (pdf > 1e-9f);
      float cto = maxp(ct_o, 1e-6f);
      float g1i = 2.0f * ct_i /
                  maxp(ct_i + sqrtf(a2 + (1.0f - a2) * ct_i * ct_i), 1e-12f);
      float g1o =
          2.0f * cto / maxp(cto + sqrtf(a2 + (1.0f - a2) * cto * cto), 1e-12f);
      float g_s = g1i * g1o;
      float w_spec =
          ok ? d_ggx * g_s / (4.0f * ct_i * maxp(pdf, 1e-12f)) : 0.0f;
      float aoh = fabsf(o_dot_h);
      new_d = wo;
      continues = ok;
      FB_SURFACE(0.0f, conductor_fresnel(aoh, s0[b], s1[b]) * w_spec)
      break;
    }
    case MAT_DIELECTRIC:
      new_d = diel_d;
      new_o = diel_o;
      continues = diel_ok;
      FB_SURFACE(0.0f, diel_ok ? 1.0f : 0.0f)
      break;
    default:  // MAT_ABSORBER
      FB_SURFACE(0.0f, 0.0f)
      break;
  }
#undef FB_SURFACE

  // --- state update ------------------------------------------------------------------
  bool alive_next;
  if constexpr (MODE == REPLAY) {
    continues = (bits >> B_CONT) & 1;
    counts_depth = (bits >> B_CNTD) & 1;
    alive_next = (bits >> B_ALIVENEXT) & 1;
  } else {
    float thr_max = ray.thr[0];
#pragma unroll
    for (int b = 1; b < NB; ++b) thr_max = maxp(thr_max, ray.thr[b]);
    alive_next = active && continues && (thr_max > 0.0f);
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) ray.rad[b] = ray.rad[b] + radd[b];
  if (active) {
    ray.o = new_o;
    ray.d = new_d;
    if (counts_depth) ray.depth = ray.depth + 1.0f;
  }
  ray.alive = alive_next ? 1.0f : 0.0f;

  if constexpr (MODE == REPLAY) {
    return bits;
  } else {
    return (1 << B_ALIVE) | ((int)hit << B_HIT) | ((int)transmit << B_TRANSMIT) |
           ((int)tir_out << B_TIR) | ((int)pick_light << B_PICKLIGHT) |
           ((int)continues << B_CONT) | ((int)counts_depth << B_CNTD) |
           ((int)alive_next << B_ALIVENEXT) | ((int)ins_sel << B_EXIT) |
           ((int)check_parity << B_PARITY) | (lidx << LIGHT_SHIFT) |
           (win << WIN_SHIFT);
  }
}

// The forward kernels' bounce: every choice made here.
__device__ __forceinline__ int bounce(const float* __restrict__ tab,
                                      const int* __restrict__ desc,
                                      const Cfg& cfg, Ray& ray,
                                      const float* u) {
  return bounce_as<DECIDE>(tab, desc, cfg, ray, u, 0);
}

}  // namespace fb
