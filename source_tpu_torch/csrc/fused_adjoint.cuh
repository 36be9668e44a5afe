// The adjoint of one replayed bounce for one ray: the device functions of the
// fused backward kernels (fused_bwd_kernels.cu).
//
// ``bounce_bwd`` is the hand-derived vector-Jacobian product of ``bounce_core``
// (tracer/fused.py) in replay mode: the discrete choices of the forward bounce
// (winner leaf, hit, exiting, transmit, TIR, light pick and index, checkerboard
// parity) come from the saved bitfield; the entry state (o, d, thr, depth) and
// the uniforms are given. Its plain PyTorch version, and its specification, is
// ``bounce_bwd_plain``: torch.autograd.grad of ``bounce_core``.
//
// Only what the WINNER touches carries a gradient: one hit function, one
// normal, one material, the volumes the segment crosses and the light cones
// of the important spheres. Every other leaf enters the replayed bounce only
// through a select on ``win`` and contributes nothing. So the thread first
// recomputes the winner's side of the forward bounce with the forward device
// functions of fused_bounce.cuh (same flags, -fmad=false: every decision that
// the bitfield does not store -- flip, front, volume containment, which
// candidate root a hit function returned -- is retaken from the same floats
// the forward kernel saw), then walks it in reverse. Beside each forward
// closed form stands its ``*_adj``.
//
// Conventions follow what autograd of the plain version gives: a guarded
// form (ssqrt, sdiv, spow, norm3) has gradient 0 on its guarded side;
// maximum/minimum of two tensors split a tie half and half; a clamp against a
// constant passes the gradient on its closed interval; |x| has gradient 0 at
// 0. The quartic of the torus is reversed through its three Newton steps; the
// Ferrari seed is taken as a constant. Its derivative leaves the Newton steps
// multiplied by the product of their contractions P P'' / P'^2, which is small
// where they converge; Ferrari's f32 seeds are poor, so on a share of lanes it
// is not, and there autograd of the plain version (which differentiates the
// seed as well) and this adjoint differ, each about as far from the root's
// true derivative as the other (chip_smoke.py holds both to a converged
// float64 solve).
//
// The table cotangent is accumulated into one f32[tab_size] per block in
// shared memory (``gtab``) by ``tadd``: where the active lanes of a warp add
// to the same entry (the common case once the kernels have grouped their
// lanes by code path) they sum with shuffles and one lane adds the sum;
// otherwise each lane adds its own with a shared-memory atomic. Float
// atomics add in an order that changes from run to run, so the table
// cotangent is reproducible only to summation noise.
#pragma once

#include "fused_bounce.cuh"

namespace fb {

// The sum of ``x`` over the lanes of ``mask`` (every lane of ``mask`` calls
// this), left in the lowest lane of ``mask``: a tree over the lanes' ranks
// (E. Westphal's reduction over a peer mask), log2(popc(mask)) rounds.
__device__ __forceinline__ float reduce_lanes(unsigned mask, float x) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(mask & ((1u << lane) - 1u));
  unsigned above = mask & (0xfffffffeu << lane);
  while (__any_sync(mask, above != 0u)) {
    const int next = __ffs(above);  // 1 + the next lane above, 0 if none
    const float y = __shfl_sync(mask, x, (next - 1) & 31);
    if (next) x += y;
    above &= ~__ballot_sync(mask, rank & 1);  // lanes whose sum was taken
    rank >>= 1;
  }
  return x;
}

// gtab[k] += v over the calling lanes of the warp.
__device__ __forceinline__ void tadd(float* gtab, int k, float v) {
  const unsigned act = __activemask();
  if (!__any_sync(act, v != 0.0f)) return;
  const int first = __ffs(act) - 1;
  if (__all_sync(act, k == __shfl_sync(act, k, first))) {
    if (act == 0xffffffffu) {
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(act, v, s);
    } else {
      v = reduce_lanes(act, v);
    }
    if ((int)(threadIdx.x & 31) == first && v != 0.0f) atomicAdd(gtab + k, v);
  } else if (v != 0.0f) {
    atomicAdd(gtab + k, v);
  }
}
__device__ __forceinline__ void acc(V3& a, V3 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
}
__device__ __forceinline__ V3 mul3(V3 a, float s) {
  return V3{a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ float sgn0(float x) {  // sign with sign(0) = 0
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}
__device__ __forceinline__ void max_adj(float a, float b, float g, float& ga,
                                        float& gb) {
  if (a > b) ga += g;
  else if (b > a) gb += g;
  else { ga += 0.5f * g; gb += 0.5f * g; }
}
__device__ __forceinline__ void min_adj(float a, float b, float g, float& ga,
                                        float& gb) {
  if (a < b) ga += g;
  else if (b < a) gb += g;
  else { ga += 0.5f * g; gb += 0.5f * g; }
}

// x * inv with inv = 1/sqrt(|x|^2) above the guard
__device__ __forceinline__ V3 norm3_adj(V3 v, V3 g) {
  float n2 = v.x * v.x + v.y * v.y + v.z * v.z;
  if (!(n2 > 1e-24f)) return V3{0.0f, 0.0f, 0.0f};
  float inv = 1.0f / sqrtf(n2);
  V3 n = V3{v.x * inv, v.y * inv, v.z * inv};
  float gn = dot3(g, n);
  return V3{inv * (g.x - n.x * gn), inv * (g.y - n.y * gn),
            inv * (g.z - n.z * gn)};
}

// r = d - 2 (d.n) n
__device__ __forceinline__ void reflect_adj(V3 d, V3 n, V3 g, V3& gd, V3& gn) {
  float k = 2.0f * dot3(d, n);
  float gk = -dot3(g, n);
  acc(gd, g);
  acc(gn, mul3(g, -k));
  acc(gd, mul3(n, 2.0f * gk));
  acc(gn, mul3(d, 2.0f * gk));
}

// make_frame(n) -> (t, b, n); returns the cotangent of n
__device__ __forceinline__ V3 make_frame_adj(V3 n, const Frame& g) {
  float s = n.z >= -1e-6f ? 1.0f : -1.0f;
  float a = -1.0f / (s + n.z);
  float gnx = g.n.x + g.t.x * 2.0f * s * n.x * a - s * g.t.z;
  float ga = g.t.x * s * n.x * n.x + g.b.y * n.y * n.y;
  float gb = g.t.y * s + g.b.x;
  float gny = g.n.y + g.b.y * 2.0f * n.y * a - g.b.z;
  gnx += gb * n.y * a;
  gny += gb * n.x * a;
  ga += gb * n.x * n.y;
  return V3{gnx, gny, g.n.z + ga * a * a};
}

// out = v.x t + v.y b + v.z n
__device__ __forceinline__ void from_frame_adj(V3 v, const Frame& f, V3 g,
                                               V3& gv, Frame& gf) {
  gv = V3{dot3(g, f.t), dot3(g, f.b), dot3(g, f.n)};
  gf.t = mul3(g, v.x);
  gf.b = mul3(g, v.y);
  gf.n = mul3(g, v.z);
}

// cotangent of cos_max in cone_uniform(u1, u2, cos_max)
__device__ __forceinline__ float cone_uniform_adj(float u1, float u2,
                                                  float cos_max, V3 g) {
  float z = 1.0f - u1 * (1.0f - cos_max);
  float arg = 1.0f - z * z;
  float r = ssqrt(arg);
  float phi = TWO_PI * u2;
  float gr = g.x * cosf(phi) + g.y * sinf(phi);
  float gz = g.z;
  if (arg > 0.0f) gz += gr * 0.5f / r * (-2.0f * z);
  return gz * u1;
}

// --- quadratic ------------------------------------------------------------------
__device__ __forceinline__ void quad_adj(float a, float b, float c, float g_lo,
                                         float g_hi, float& ga, float& gb,
                                         float& gc) {
  float disc = b * b - 4.0f * a * c;
  float sq = ssqrt(disc);
  float sg = b >= 0.0f ? 1.0f : -1.0f;
  float q = -0.5f * (b + (b >= 0.0f ? sq : -sq));
  bool a_ok = fabsf(a) > 1e-30f;
  bool q_ok = fabsf(q) > 1e-30f;
  float r0 = a_ok ? sdiv(q, a) : BIG;
  float r1 = q_ok ? sdiv(c, q) : r0;
  float g_r0 = 0.0f, g_r1 = 0.0f;
  min_adj(r0, r1, g_lo, g_r0, g_r1);
  max_adj(r0, r1, g_hi, g_r0, g_r1);
  float g_q = 0.0f;
  if (q_ok) {
    gc += g_r1 / q;
    g_q += -g_r1 * c / (q * q);
  } else {
    g_r0 += g_r1;
  }
  if (a_ok) {
    g_q += g_r0 / a;
    ga += -g_r0 * q / (a * a);
  }
  gb += -0.5f * g_q;
  float g_sq = -0.5f * sg * g_q;
  float g_disc = disc > 0.0f ? g_sq * 0.5f / sq : 0.0f;
  gb += 2.0f * b * g_disc;
  ga += -4.0f * c * g_disc;
  gc += -4.0f * a * g_disc;
}

struct Pick {
  float best;
  int k;
};
__device__ __forceinline__ void pick_after(Pick& p, float t_min, float t, bool v,
                                           int k) {
  if (v && t > t_min && t < p.best) {
    p.best = t;
    p.k = k;
  }
}

// Each hit adjoint takes the cotangent ``g`` of the returned distance and adds
// the cotangents of the local ray (go, gd) and of the parameter block (gp[8]).

__device__ __forceinline__ void hit_sphere_adj(V3 o, V3 d, float r, float t_min,
                                               float g, V3& go, V3& gd,
                                               float& gr) {
  float a = dot3(d, d);
  float b = 2.0f * dot3(o, d);
  float c = dot3(o, o) - r * r;
  Quad q = quad(a, b, c);
  Pick p{BIG, -1};
  pick_after(p, t_min, q.lo, q.v, 0);
  pick_after(p, t_min, q.hi, q.v, 1);
  if (p.k < 0) return;
  float ga = 0.0f, gb = 0.0f, gc = 0.0f;
  quad_adj(a, b, c, p.k == 0 ? g : 0.0f, p.k == 1 ? g : 0.0f, ga, gb, gc);
  acc(gd, mul3(d, 2.0f * ga));
  acc(gd, mul3(o, 2.0f * gb));
  acc(go, mul3(d, 2.0f * gb));
  acc(go, mul3(o, 2.0f * gc));
  gr += -2.0f * r * gc;
}

__device__ __forceinline__ void slab_axis_adj(float p0, float p1, float o,
                                              float d, float g0, float g1,
                                              float& gp0, float& gp1, float& go,
                                              float& gd) {
  float inv = inv_dir(d);
  gp0 += g0 * inv;
  gp1 += g1 * inv;
  go += -(g0 + g1) * inv;
  float g_inv = g0 * (p0 - o) + g1 * (p1 - o);
  if (fabsf(d) > 1e-30f) gd += -g_inv / (d * d);
}

__device__ __forceinline__ void hit_box_adj(V3 o, V3 d, const float* p,
                                            float t_min, float g, V3& go, V3& gd,
                                            float* gp) {
  float ix = inv_dir(d.x), iy = inv_dir(d.y), iz = inv_dir(d.z);
  float t0x = (p[0] - o.x) * ix, t1x = (p[3] - o.x) * ix;
  float t0y = (p[1] - o.y) * iy, t1y = (p[4] - o.y) * iy;
  float t0z = (p[2] - o.z) * iz, t1z = (p[5] - o.z) * iz;
  float nx = minp(t0x, t1x), ny = minp(t0y, t1y), nz = minp(t0z, t1z);
  float xx = maxp(t0x, t1x), xy = maxp(t0y, t1y), xz = maxp(t0z, t1z);
  float lo = maxp(maxp(nx, ny), nz);
  float hi = minp(minp(xx, xy), xz);
  bool v = hi >= lo;
  Pick pk{BIG, -1};
  pick_after(pk, t_min, lo, v, 0);
  pick_after(pk, t_min, hi, v, 1);
  if (pk.k < 0) return;
  float g0x = 0.0f, g1x = 0.0f, g0y = 0.0f, g1y = 0.0f, g0z = 0.0f, g1z = 0.0f;
  float gx = 0.0f, gy = 0.0f, gz = 0.0f, gxy = 0.0f;
  if (pk.k == 0) {
    max_adj(maxp(nx, ny), nz, g, gxy, gz);
    max_adj(nx, ny, gxy, gx, gy);
    min_adj(t0x, t1x, gx, g0x, g1x);
    min_adj(t0y, t1y, gy, g0y, g1y);
    min_adj(t0z, t1z, gz, g0z, g1z);
  } else {
    min_adj(minp(xx, xy), xz, g, gxy, gz);
    min_adj(xx, xy, gxy, gx, gy);
    max_adj(t0x, t1x, gx, g0x, g1x);
    max_adj(t0y, t1y, gy, g0y, g1y);
    max_adj(t0z, t1z, gz, g0z, g1z);
  }
  slab_axis_adj(p[0], p[3], o.x, d.x, g0x, g1x, gp[0], gp[3], go.x, gd.x);
  slab_axis_adj(p[1], p[4], o.y, d.y, g0y, g1y, gp[1], gp[4], go.y, gd.y);
  slab_axis_adj(p[2], p[5], o.z, d.z, g0z, g1z, gp[2], gp[5], go.z, gd.z);
}

__device__ __forceinline__ void hit_cylinder_adj(V3 o, V3 d, const float* p,
                                                 float t_min, float g, V3& go,
                                                 V3& gd, float* gp) {
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
  Pick pk{BIG, -1};
  pick_after(pk, t_min, lo, v, 0);
  pick_after(pk, t_min, hi, v, 1);
  if (pk.k < 0) return;
  float g_tube = 0.0f, g_slab = 0.0f, g_s0 = 0.0f, g_s1 = 0.0f;
  float g_qlo = 0.0f, g_qhi = 0.0f;
  if (pk.k == 0) {
    max_adj(tube_lo, slab_lo, g, g_tube, g_slab);
    if (!axial && q.v) g_qlo = g_tube;
    if (!flat) min_adj(s0, s1, g_slab, g_s0, g_s1);
  } else {
    min_adj(tube_hi, slab_hi, g, g_tube, g_slab);
    if (!axial && q.v) g_qhi = g_tube;
    if (!flat) max_adj(s0, s1, g_slab, g_s0, g_s1);
  }
  float ga = 0.0f, gb = 0.0f, gc = 0.0f;
  quad_adj(a, b, c, g_qlo, g_qhi, ga, gb, gc);
  gd.x += 2.0f * d.x * ga + 2.0f * gb * o.x;
  gd.y += 2.0f * d.y * ga + 2.0f * gb * o.y;
  go.x += 2.0f * gb * d.x + 2.0f * o.x * gc;
  go.y += 2.0f * gb * d.y + 2.0f * o.y * gc;
  gp[0] += -2.0f * r * gc;
  if (!flat) {  // |dz| > 1e-30 passes sdiv's guard
    float g_dz = -g_s0 * (0.0f - o.z) / (dz * dz) - g_s1 * (h - o.z) / (dz * dz);
    go.z += -(g_s0 + g_s1) / dz;
    gp[1] += g_s1 / dz;
    gd.z += g_dz;
  }
}

// n = (p.x / rad, p.y / rad, .) on the side, constant on the caps
__device__ __forceinline__ void unit_xy_adj(V3 p, float rad, float gux,
                                            float guy, V3& gp) {
  float g_rad = -(gux * p.x + guy * p.y) / (rad * rad);
  gp.x += gux / rad + g_rad * p.x / rad;
  gp.y += guy / rad + g_rad * p.y / rad;
}

__device__ __forceinline__ void n_cylinder_adj(V3 p, const float* pp, V3 g,
                                               V3& gp) {
  float r = pp[0], h = pp[1];
  float rad = sqrtf(p.x * p.x + p.y * p.y + 1e-12f);
  float d_side = fabsf(rad - r);
  float d_bot = fabsf(p.z);
  float d_top = fabsf(p.z - h);
  bool side = (d_side <= d_bot) && (d_side <= d_top);
  if (side) unit_xy_adj(p, rad, g.x, g.y, gp);
}

// cotangent of k = sdiv(r, h) onto (r, h)
__device__ __forceinline__ void ratio_adj(float r, float h, float gk, float& gr,
                                          float& gh) {
  if (fabsf(h) > 1e-30f) {
    gr += gk / h;
    gh += -gk * r / (h * h);
  }
}

// shared by cone and parabola: the base-cap candidate tc = -o.z / d.z
__device__ __forceinline__ void cap_adj(V3 o, V3 d, float g, V3& go, V3& gd) {
  go.z += -g / d.z;
  gd.z += g * o.z / (d.z * d.z);
}

__device__ __forceinline__ void hit_cone_adj(V3 o, V3 d, const float* p,
                                             float t_min, float g, V3& go,
                                             V3& gd, float* gp) {
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
  Pick pk{BIG, -1};
  pick_after(pk, t_min, q.lo, v0, 0);
  pick_after(pk, t_min, q.hi, v1, 1);
  pick_after(pk, t_min, tc, vc, 2);
  if (pk.k < 0) return;
  if (pk.k == 2) {
    cap_adj(o, d, g, go, gd);
    return;
  }
  float ga = 0.0f, gb = 0.0f, gc = 0.0f;
  quad_adj(a, b, c, pk.k == 0 ? g : 0.0f, pk.k == 1 ? g : 0.0f, ga, gb, gc);
  float k2 = k * k;
  float g_k2 = -wd * wd * ga - 2.0f * gb * wo * wd - wo * wo * gc;
  float g_wd = -2.0f * k2 * wd * ga - 2.0f * gb * k2 * wo;
  float g_wo = -2.0f * gb * k2 * wd - 2.0f * k2 * wo * gc;
  gd.x += 2.0f * d.x * ga + 2.0f * gb * o.x;
  gd.y += 2.0f * d.y * ga + 2.0f * gb * o.y;
  go.x += 2.0f * gb * d.x + 2.0f * o.x * gc;
  go.y += 2.0f * gb * d.y + 2.0f * o.y * gc;
  gp[1] += g_wo;
  go.z += -g_wo;
  gd.z += -g_wd;
  ratio_adj(r, h, 2.0f * k * g_k2, gp[0], gp[1]);
}

__device__ __forceinline__ void n_cone_adj(V3 p, const float* pp, V3 g, V3& gp,
                                           float* gpp) {
  float r = pp[0], h = pp[1];
  float k = sdiv(r, h, 1e-30f);
  float rad = sqrtf(p.x * p.x + p.y * p.y + 1e-12f);
  float d_cap = fabsf(p.z);
  float inv = 1.0f / sqrtf(1.0f + k * k);
  float d_cone = fabsf(rad - k * (h - p.z)) * inv;
  if (d_cap <= d_cone) return;
  float ux = p.x / rad, uy = p.y / rad;
  float g_inv = g.x * ux + g.y * uy + g.z * k;
  float g_k = g.z * inv - g_inv * k * inv * inv * inv;
  unit_xy_adj(p, rad, g.x * inv, g.y * inv, gp);
  ratio_adj(r, h, g_k, gpp[0], gpp[1]);
}

// cotangent of a4 = sdiv(r * r, h) onto (r, h)
__device__ __forceinline__ void a4_adj(float r, float h, float g, float* gpp) {
  if (fabsf(h) > 1e-30f) {
    gpp[0] += g * 2.0f * r / h;
    gpp[1] += -g * r * r / (h * h);
  }
}

__device__ __forceinline__ void hit_parabola_adj(V3 o, V3 d, const float* p,
                                                 float t_min, float g, V3& go,
                                                 V3& gd, float* gp) {
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
  Pick pk{BIG, -1};
  pick_after(pk, t_min, t0, v0, 0);
  pick_after(pk, t_min, q.hi, v1, 1);
  pick_after(pk, t_min, tc, vc, 2);
  if (pk.k < 0) return;
  if (pk.k == 2) {
    cap_adj(o, d, g, go, gd);
    return;
  }
  float ga = 0.0f, gb = 0.0f, gc = 0.0f;
  if (pk.k == 0 && lin) {  // tl = -c / b, b_ok holds
    gc += -g / b;
    gb += g * c / (b * b);
  } else {
    quad_adj(a, b, c, pk.k == 0 ? g : 0.0f, pk.k == 1 ? g : 0.0f, ga, gb, gc);
  }
  gd.x += 2.0f * d.x * ga + 2.0f * gb * o.x;
  gd.y += 2.0f * d.y * ga + 2.0f * gb * o.y;
  gd.z += gb * a4;
  go.x += 2.0f * gb * d.x + 2.0f * o.x * gc;
  go.y += 2.0f * gb * d.y + 2.0f * o.y * gc;
  go.z += gc * a4;
  gp[1] += -gc * a4;
  a4_adj(r, h, gb * d.z + gc * (o.z - h), gp);
}

__device__ __forceinline__ void n_parabola_adj(V3 p, const float* pp, V3 g,
                                               V3& gp, float* gpp) {
  float r = pp[0], h = pp[1];
  float a4 = sdiv(r * r, h, 1e-30f);
  float d_cap = fabsf(p.z);
  float surf = fabsf(p.x * p.x + p.y * p.y + a4 * (p.z - h));
  if (d_cap <= surf * 0.5f) return;
  gp.x += 2.0f * g.x;
  gp.y += 2.0f * g.y;
  a4_adj(r, h, g.z, gpp);
}

__device__ __noinline__ void hit_torus_adj(V3 o, V3 d, const float* p,
                                           float t_min, float g, V3& go, V3& gd,
                                           float* gp) {
  float R = p[0], r = p[1];
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
  float seeds[4];
  solve_quartic(a4, a3, a2, a1, a0, 3, roots, seeds);
  Pick pk{BIG, -1};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float ts = roots[i].v ? roots[i].x : 0.0f;
    float px = o.x + ts * d.x;
    float py = o.y + ts * d.y;
    float pz = o.z + ts * d.z;
    pick_after(pk, t_min, roots[i].x,
               roots[i].v && torus_root_valid(px, py, pz, R, r), i);
  }
  if (pk.k < 0) return;
  // the picked root's Newton iterates, from its seed (a4 passed the a_ok
  // guard, or no root would be valid)
  float xs[3];
  float x = seeds[0];
#pragma unroll
  for (int i = 1; i < 4; ++i)
    if (pk.k == i) x = seeds[i];
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    xs[it] = x;
    float poly = (((a4 * x + a3) * x + a2) * x + a1) * x + a0;
    float dpoly = ((4.0f * a4 * x + 3.0f * a3) * x + 2.0f * a2) * x + a1;
    x = x - sdiv(poly, dpoly);
  }
  float gx = g, gA = 0.0f, gB = 0.0f, gC = 0.0f, gD = 0.0f, gE = 0.0f;
#pragma unroll
  for (int it = 2; it >= 0; --it) {
    float y = xs[it];
    float poly = (((a4 * y + a3) * y + a2) * y + a1) * y + a0;
    float dpoly = ((4.0f * a4 * y + 3.0f * a3) * y + 2.0f * a2) * y + a1;
    if (fabsf(dpoly) > 1e-30f) {
      float ddpoly = (12.0f * a4 * y + 6.0f * a3) * y + 2.0f * a2;
      float g_poly = -gx / dpoly;
      float g_dp = gx * poly / (dpoly * dpoly);
      float y2 = y * y, y3 = y2 * y;
      gA += g_poly * y2 * y2 + g_dp * 4.0f * y3;
      gB += g_poly * y3 + g_dp * 3.0f * y2;
      gC += g_poly * y2 + g_dp * 2.0f * y;
      gD += g_poly * y + g_dp;
      gE += g_poly;
      gx = gx + g_poly * dpoly + g_dp * ddpoly;
    }
  }
  float R2 = R * R;
  float g_dd = 2.0f * dd * gA + 4.0f * od * gB + 2.0f * k * gC;
  float g_od = 4.0f * dd * gB + 8.0f * od * gC + 4.0f * k * gD;
  float g_k = 2.0f * dd * gC + 4.0f * od * gD + 2.0f * k * gE;
  float g_R = 8.0f * R * d.z * d.z * gC + 16.0f * R * o.z * d.z * gD -
              8.0f * R * (r * r - o.z * o.z) * gE - 2.0f * R * g_k;
  float g_r = -8.0f * R2 * r * gE - 2.0f * r * g_k;
  gd.z += 8.0f * R2 * d.z * gC + 8.0f * R2 * o.z * gD;
  go.z += 8.0f * R2 * d.z * gD + 8.0f * R2 * o.z * gE;
  acc(gd, mul3(d, 2.0f * g_dd));
  acc(go, mul3(d, g_od));
  acc(gd, mul3(o, g_od));
  acc(go, mul3(o, 2.0f * g_k));
  gp[0] += g_R;
  gp[1] += g_r;
}

__device__ __forceinline__ void n_torus_adj(V3 p, const float* pp, V3 g, V3& gp,
                                            float* gpp) {
  float R = pp[0];
  float rad = sqrtf(p.x * p.x + p.y * p.y + 1e-12f);
  gp.x += g.x;
  gp.y += g.y;
  gp.z += g.z;
  gpp[0] += -(p.x / rad * g.x + p.y / rad * g.y);
  unit_xy_adj(p, rad, -R * g.x, -R * g.y, gp);
}

__device__ __forceinline__ void hit_local_adj(int tid, V3 lo, V3 ld,
                                              const float* pp, float t_min,
                                              float g, V3& glo, V3& gld,
                                              float* gpp) {
  switch (tid) {
    case TYPE_SPHERE: hit_sphere_adj(lo, ld, pp[0], t_min, g, glo, gld, gpp[0]); break;
    case TYPE_BOX: hit_box_adj(lo, ld, pp, t_min, g, glo, gld, gpp); break;
    case TYPE_CYLINDER: hit_cylinder_adj(lo, ld, pp, t_min, g, glo, gld, gpp); break;
    case TYPE_CONE: hit_cone_adj(lo, ld, pp, t_min, g, glo, gld, gpp); break;
    case TYPE_PARABOLA: hit_parabola_adj(lo, ld, pp, t_min, g, glo, gld, gpp); break;
    default: hit_torus_adj(lo, ld, pp, t_min, g, glo, gld, gpp); break;
  }
}

// the box normal is piecewise constant: no cotangent
__device__ __forceinline__ void normal_local_adj(int tid, V3 ph, const float* pp,
                                                 V3 g, V3& gph, float* gpp) {
  switch (tid) {
    case TYPE_SPHERE: acc(gph, g); break;
    case TYPE_BOX: break;
    case TYPE_CYLINDER: n_cylinder_adj(ph, pp, g, gph); break;
    case TYPE_CONE: n_cone_adj(ph, pp, g, gph, gpp); break;
    case TYPE_PARABOLA: n_parabola_adj(ph, pp, g, gph, gpp); break;
    default: n_torus_adj(ph, pp, g, gph, gpp); break;
  }
}

// cotangents (g_ci, g_n, g_k) of conductor_fresnel(ci, n, k) under g
__device__ __forceinline__ void conductor_fresnel_adj(float ci, float n, float k,
                                                      float g, float& g_ci,
                                                      float& g_n, float& g_k) {
  float ci2 = ci * ci;
  float n2k2 = n * n + k * k;
  float tnc = 2.0f * n * ci;
  float A = n2k2 - tnc + ci2;
  float Bv = n2k2 + tnc + ci2;
  float C = n2k2 * ci2 - tnc + 1.0f;
  float D = n2k2 * ci2 + tnc + 1.0f;
  float Bm = maxp(Bv, 1e-30f), Dm = maxp(D, 1e-30f);
  float gh = 0.5f * g;
  float gA = gh / Bm;
  float gB = Bv >= 1e-30f ? -gh * A / (Bm * Bm) : 0.0f;
  float gC = gh / Dm;
  float gD = D >= 1e-30f ? -gh * C / (Dm * Dm) : 0.0f;
  float g_n2k2 = gA + gB + (gC + gD) * ci2;
  float g_tnc = -gA + gB - gC + gD;
  float g_ci2 = gA + gB + (gC + gD) * n2k2;
  g_ci += 2.0f * ci * g_ci2 + 2.0f * n * g_tnc;
  g_n += 2.0f * n * g_n2k2 + 2.0f * ci * g_tnc;
  g_k += 2.0f * k * g_n2k2;
}

// imp_cone(rec, point) -> (ax, cm): adds the cotangents of the record's centre
// and radius to the table and returns the cotangent of ``point``
__device__ __forceinline__ V3 imp_cone_adj(const float* rec, V3 point, V3 g_ax,
                                           float g_cm, float* gtab, int off) {
  float r = rec[3];
  V3 t = V3{rec[0] - point.x, rec[1] - point.y, rec[2] - point.z};
  float dist2 = dot3(t, t);
  float dist = sqrtf(dist2 + 1e-12f);
  bool inside_s = dist <= r;
  float sr = sdiv(r, dist);
  float s2 = sr * sr;
  float c2 = 1.0f - clampp(s2, 0.0f, 1.0f);
  float g_dist = -dot3(g_ax, t) / (dist * dist);
  V3 g_t = V3{g_ax.x / dist, g_ax.y / dist, g_ax.z / dist};
  if (!inside_s && c2 > 0.0f) {
    float g_c2 = g_cm * 0.5f / sqrtf(c2);
    float g_s2 = (s2 >= 0.0f && s2 <= 1.0f) ? -g_c2 : 0.0f;
    float g_sr = 2.0f * sr * g_s2;
    if (fabsf(dist) > 1e-30f) {
      tadd(gtab, off + 3, g_sr / dist);
      g_dist += -g_sr * r / (dist * dist);
    }
  }
  float g_dist2 = g_dist * 0.5f / dist;
  acc(g_t, mul3(t, 2.0f * g_dist2));
  tadd(gtab, off + 0, g_t.x);
  tadd(gtab, off + 1, g_t.y);
  tadd(gtab, off + 2, g_t.z);
  return V3{-g_t.x, -g_t.y, -g_t.z};
}

// light_pdf(imp, n_imp, point, wo) under g: the direction enters only through
// the comparison c >= cm, so the cotangent goes to the weights and, through
// each cone's cos_max, to the centres, the radii and ``point``
__device__ __noinline__ void light_pdf_adj(const float* imp, int n_imp,
                                           V3 point, V3 wo, float g, V3& g_point,
                                           float* gtab, int imp_base) {
  for (int i = 0; i < n_imp; ++i) {
    V3 ax;
    float cm;
    imp_cone(imp + 6 * i, point, ax, cm);
    if (!(dot3(ax, wo) >= cm)) continue;
    float solid = TWO_PI * (1.0f - cm);
    float sm = maxp(solid, 1e-12f);
    tadd(gtab, imp_base + 6 * i + 4, g * sdiv(1.0f, sm));
    float g_sm = -g * imp[6 * i + 4] / (sm * sm);
    float g_cm = solid >= 1e-12f ? -TWO_PI * g_sm : 0.0f;
    acc(g_point, imp_cone_adj(imp + 6 * i, point, V3{0.0f, 0.0f, 0.0f}, g_cm,
                              gtab, imp_base + 6 * i));
  }
}

// dir_light = from_frame(cone_uniform(u4, u5, cm), make_frame(ax)) of the
// picked important sphere, under g
__device__ __noinline__ void dir_light_adj(const float* rec, V3 point, float u4,
                                           float u5, V3 g, V3& g_point,
                                           float* gtab, int off) {
  V3 ax;
  float cm;
  imp_cone(rec, point, ax, cm);
  V3 local = cone_uniform(u4, u5, cm);
  Frame f = make_frame(ax);
  V3 g_local;
  Frame g_f;
  from_frame_adj(local, f, g, g_local, g_f);
  float g_cm = cone_uniform_adj(u4, u5, cm, g_local);
  V3 g_ax = make_frame_adj(ax, g_f);
  acc(g_point, imp_cone_adj(rec, point, g_ax, g_cm, gtab, off));
}

// g1(c) = 2c / max(c + sqrt(a2 + (1 - a2) c^2), 1e-12)
__device__ __forceinline__ float smith_g1(float c, float a2) {
  return 2.0f * c / maxp(c + sqrtf(a2 + (1.0f - a2) * c * c), 1e-12f);
}
__device__ __forceinline__ void smith_g1_adj(float c, float a2, float g,
                                             float& g_c, float& g_a2) {
  float s = sqrtf(a2 + (1.0f - a2) * c * c);
  float den = maxp(c + s, 1e-12f);
  g_c += 2.0f * g / den;
  if (c + s >= 1e-12f) {
    float g_den = -g * 2.0f * c / (den * den);
    float g_arg = g_den * 0.5f / s;
    g_c += g_den + g_arg * (1.0f - a2) * 2.0f * c;
    g_a2 += g_arg * (1.0f - c * c);
  }
}

// What the material branches hand back to the geometry.
struct SurfAdj {
  V3 g_d;        // cotangent of the entry direction
  V3 g_nsh;      // ... of the shading normal
  V3 g_n;        // ... of the oriented normal (dielectric)
  V3 g_point;    // ... of the hit point (light cones)
  V3 g_refl;     // ... of the reflection-side origin
  V3 g_trans;    // ... of the transmission-side origin
  float g_cos_in;
  float g_abs_cos;
};

// Rough conductor: reverse of the GGX sample, weight and Fresnel factor.
// Returns w_spec; the per-bin Fresnel cotangent is summed by the caller into
// ``g_wspec`` and ``g_aoh`` before the call.
__device__ __noinline__ void rough_conductor_adj(
    const float* mrec, int moff, const float* imp, int n_imp, int imp_base,
    const Cfg& cfg, bool use_mis, bool pick_light, int lidx, const float* u,
    V3 d, V3 n_sh, const Frame& fr, V3 point, V3 dir_light, float g_wspec,
    float g_aoh, V3 g_wo, SurfAdj& s, float* gtab) {
  float rough = clampp(mrec[0], 1e-3f, 1.0f);
  float a2 = rough * rough;
  float phi = TWO_PI * u[2];
  float den_raw = 1.0f + (a2 - 1.0f) * u[1];
  float den_s = maxp(den_raw, 1e-12f);
  float rat = sdiv(1.0f - u[1], den_s);
  float ct2 = clampp(rat, 0.0f, 1.0f);
  float ct = sqrtf(ct2 + 1e-12f);
  float st_raw = 1.0f - ct2;
  float st = sqrtf(clampp(st_raw, 1e-12f, 1.0f));
  float cphi = cosf(phi), sphi = sinf(phi);
  V3 hl = V3{st * cphi, st * sphi, ct};
  V3 h_bsdf = from_frame(hl, fr);
  V3 wi = V3{-d.x, -d.y, -d.z};
  V3 wo_bsdf = reflect(d, h_bsdf);
  bool lit = use_mis && pick_light;
  V3 wo = lit ? dir_light : wo_bsdf;
  V3 h_raw = V3{wi.x + wo.x, wi.y + wo.y, wi.z + wo.z};
  float hh = dot3(h_raw, h_raw);
  float h_len = sqrtf(maxp(hh, 1e-24f));
  V3 h = V3{h_raw.x / h_len, h_raw.y / h_len, h_raw.z / h_len};
  float dwi = dot3(wi, n_sh);
  float ct_i = maxp(dwi, 1e-6f);
  float ct_o = dot3(wo, n_sh);
  float ct_h = dot3(h, n_sh);
  float odh = dot3(wo, h);
  float dd = ct_h * ct_h * (a2 - 1.0f) + 1.0f;
  float dden_raw = PI * dd * dd;
  float dden = maxp(dden_raw, 1e-12f);
  float d_ggx = a2 / dden;
  float odh_s = fabsf(odh) > 1e-9f ? odh : 1e-9f;
  float ratio = ct_h / odh_s;
  float pdf_bsdf = 0.25f * d_ggx * fabsf(ratio);
  float pdf = pdf_bsdf;
  if (use_mis) {
    float pdf_light = light_pdf(imp, n_imp, point, wo);
    pdf = cfg.w_imp * pdf_light + cfg.one_m_w_imp * pdf_bsdf;
  }
  bool ok = (ct_o > 1e-6f) && (pdf > 1e-9f);
  float cto = maxp(ct_o, 1e-6f);
  float g1i = smith_g1(ct_i, a2), g1o = smith_g1(cto, a2);
  float g_s = g1i * g1o;
  float pm = maxp(pdf, 1e-12f);

  float g_a2 = 0.0f, g_dggx = 0.0f, g_cti = 0.0f, g_cto = 0.0f, g_pdfb = 0.0f;
  if (ok) {
    float num = d_ggx * g_s;
    float den = 4.0f * ct_i * pm;
    float g_num = g_wspec / den;
    float g_den = -g_wspec * num / (den * den);
    g_dggx = g_num * g_s;
    float g_gs = g_num * d_ggx;
    g_cti = g_den * 4.0f * pm;
    float g_pdf = pdf >= 1e-12f ? g_den * 4.0f * ct_i : 0.0f;
    smith_g1_adj(ct_i, a2, g_gs * g1o, g_cti, g_a2);
    float g_cto_c = 0.0f;
    smith_g1_adj(cto, a2, g_gs * g1i, g_cto_c, g_a2);
    if (ct_o >= 1e-6f) g_cto = g_cto_c;
    if (use_mis) {
      g_pdfb = cfg.one_m_w_imp * g_pdf;
      light_pdf_adj(imp, n_imp, point, wo, cfg.w_imp * g_pdf, s.g_point, gtab,
                    imp_base);
    } else {
      g_pdfb = g_pdf;
    }
  }
  float g_odh = g_aoh * sgn0(odh);
  g_dggx += g_pdfb * 0.25f * fabsf(ratio);
  float g_ratio = g_pdfb * 0.25f * d_ggx * sgn0(ratio);
  float g_cth = g_ratio / odh_s;
  if (fabsf(odh) > 1e-9f) g_odh += -g_ratio * ct_h / (odh_s * odh_s);
  g_a2 += g_dggx / dden;
  if (dden_raw >= 1e-12f) {
    float g_dd = -g_dggx * a2 / (dden * dden) * PI * 2.0f * dd;
    g_cth += g_dd * 2.0f * ct_h * (a2 - 1.0f);
    g_a2 += g_dd * ct_h * ct_h;
  }
  V3 g_h = mul3(wo, g_odh);
  acc(g_wo, mul3(h, g_odh));
  acc(g_h, mul3(n_sh, g_cth));
  acc(s.g_nsh, mul3(h, g_cth));
  acc(g_wo, mul3(n_sh, g_cto));
  acc(s.g_nsh, mul3(wo, g_cto));
  V3 g_wi = V3{0.0f, 0.0f, 0.0f};
  if (dwi >= 1e-6f) {
    acc(g_wi, mul3(n_sh, g_cti));
    acc(s.g_nsh, mul3(wi, g_cti));
  }
  V3 g_hraw = V3{g_h.x / h_len, g_h.y / h_len, g_h.z / h_len};
  if (hh >= 1e-24f) {
    float g_hlen = -dot3(g_h, h_raw) / (h_len * h_len);
    acc(g_hraw, mul3(h_raw, 2.0f * g_hlen * 0.5f / h_len));
  }
  acc(g_wi, g_hraw);
  acc(g_wo, g_hraw);
  if (lit) {
    dir_light_adj(imp + 6 * lidx, point, u[4], u[5], g_wo, s.g_point, gtab,
                  imp_base + 6 * lidx);
  } else {
    V3 g_hb = V3{0.0f, 0.0f, 0.0f};
    reflect_adj(d, h_bsdf, g_wo, s.g_d, g_hb);
    V3 g_hl;
    Frame g_fr;
    from_frame_adj(hl, fr, g_hb, g_hl, g_fr);
    acc(s.g_nsh, make_frame_adj(n_sh, g_fr));
    float g_st = g_hl.x * cphi + g_hl.y * sphi;
    float g_ct2 = g_hl.z * 0.5f / ct;
    if (st_raw >= 1e-12f && st_raw <= 1.0f) g_ct2 += -g_st * 0.5f / st;
    if (rat >= 0.0f && rat <= 1.0f && fabsf(den_s) > 1e-30f &&
        den_raw >= 1e-12f)
      g_a2 += -g_ct2 * (1.0f - u[1]) / (den_s * den_s) * u[1];
  }
  acc(s.g_d, V3{-g_wi.x, -g_wi.y, -g_wi.z});
  if (mrec[0] >= 1e-3f && mrec[0] <= 1.0f)
    tadd(gtab, moff, 2.0f * rough * g_a2);
}

// --- the adjoint of the bounce -----------------------------------------------------
// The ray entered the bounce with (o, d, thr, depth) and ``bits`` != 0 (it was
// alive after the roulette). In: the cotangents go, gd, gthr of the bounce's
// exit o, d, thr and ``grad`` of its radiance increment. Out, in place: the
// cotangents of the entry o, d, thr. The table cotangent is added to ``gtab``.
__device__ __forceinline__ void bounce_bwd(const float* __restrict__ tab,
                                           const int* __restrict__ desc,
                                           const Cfg& cfg, V3 o, V3 d,
                                           const float* thr_in, float depth,
                                           const float* u, int bits, V3& go,
                                           V3& gd, float* gthr,
                                           const float* grad, float* gtab) {
  const int L = desc[D_L];
  const int n_vol = desc[D_NVOL];
  const int n_imp = desc[D_NIMP];
  const int flags = desc[D_FLAGS];
  const int mat_base = desc[D_MAT_BASE];
  const int mat_stride = desc[D_MAT_STRIDE];
  const int imp_base = desc[D_IMP_BASE];
  const float* imp = tab + imp_base;
  const int* leaves = desc + D_HEADER;
  const int* vols = leaves + D_LEAF_WORDS * L;

  // the roulette scaled the throughput of a survivor
  const float scale = depth >= (float)cfg.ext_min_depth ? cfg.survive : 1.0f;
  const bool hit = (bits >> B_HIT) & 1;
  if (!hit) {  // a miss leaves o and d alone and adds no radiance
#pragma unroll
    for (int b = 0; b < NB; ++b) gthr[b] = gthr[b] * scale;
    return;
  }

  // --- replay the winner's side of the forward bounce ---------------------------
  const int win = (bits >> WIN_SHIFT) & 0x1FF;
  const int* wl = leaves + D_LEAF_WORDS * win;
  const int woff = 20 * win;
  const float* wrec = tab + woff;
  const float* pp = wrec + 12;
  const int tid = wl[0];
  float eps = T_EPS * maxp(1.0f, maxp(fabsf(o.x), maxp(fabsf(o.y), fabsf(o.z))));
  V3 lo = xf_point(wrec, o), ld = xf_dir(wrec, d);
  bool ins_unused;
  float t_g = hit_local(tid, lo, ld, pp, eps, ins_unused);
  bool t_ok = t_g < 1e30f;
  float t_s = t_ok ? t_g : 0.0f;
  V3 pw = V3{o.x + t_s * d.x, o.y + t_s * d.y, o.z + t_s * d.z};
  V3 ph = xf_point(wrec, pw);
  V3 nl = normal_local(tid, ph, pp);
  V3 nw_raw = V3{wrec[0] * nl.x + wrec[4] * nl.y + wrec[8] * nl.z,
                 wrec[1] * nl.x + wrec[5] * nl.y + wrec[9] * nl.z,
                 wrec[2] * nl.x + wrec[6] * nl.y + wrec[10] * nl.z};
  float t_safe = t_s;
  V3 nw = norm3(nw_raw.x, nw_raw.y, nw_raw.z);
  bool exiting = (bits >> B_EXIT) & 1;
  float ddn = d.x * nw.x + d.y * nw.y + d.z * nw.z;
  bool flip = (exiting && (ddn < 0.0f)) || (!exiting && (ddn > 0.0f));
  float fs = flip ? -1.0f : 1.0f;
  V3 n = V3{nw.x * fs, nw.y * fs, nw.z * fs};
  V3 point = V3{o.x + t_safe * d.x, o.y + t_safe * d.y, o.z + t_safe * d.z};
  float apx = fabsf(point.x), apy = fabsf(point.y), apz = fabsf(point.z);
  float m_yz = maxp(apy, apz);
  float m_xyz = maxp(apx, m_yz);
  float off_p = T_EPS * maxp(1.0f, m_xyz);

  // volumes: containment as the forward kernel took it
  float t_seg = t_safe;
  unsigned long long in_mask = 0ull;
  float thr1[NB], thr2[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    thr1[b] = thr_in[b] * scale;
    thr2[b] = thr1[b];
  }
  if (n_vol > 0) {
    V3 mid = V3{o.x + 0.5f * t_seg * d.x, o.y + 0.5f * t_seg * d.y,
                o.z + 0.5f * t_seg * d.z};
    for (int v = 0; v < n_vol; ++v) {
      const int* vr = vols + D_VOL_WORDS * v;
      const float* rec = tab + 20 * vr[2];
      if (contains(leaves[D_LEAF_WORDS * vr[2]], xf_point(rec, mid), rec + 12))
        in_mask |= 1ull << v;
    }
    for (int v = 0; v < n_vol; ++v) {
      const int* vr = vols + D_VOL_WORDS * v;
      if (vr[1] == VOL_BEER && ((in_mask >> v) & 1ull)) {
        const float* tr = tab + mat_base + vr[0] * mat_stride + 10 + NB;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          float base = tr[b];
          float att = base > 1e-9f ? spow(base, t_seg) : 0.0f;
          thr2[b] = thr2[b] * att;
        }
      }
    }
  }

  float cos_in = -ddn * fs;
  bool front = cos_in >= 0.0f;
  float abs_cos_in = fabsf(cos_in);
  V3 n_sh = front ? n : V3{-n.x, -n.y, -n.z};
  Frame fr = make_frame(n_sh);

  const int mt = wl[2];
  const int moff = mat_base + wl[1] * mat_stride;
  const float* mrec = tab + moff;
  const float* s0 = mrec + 10;
  const float* s1 = mrec + 10 + NB;
  const int o_s0 = moff + 10, o_s1 = moff + 10 + NB;

  const bool use_mis = (flags & F_USE_MIS) != 0;
  const int lidx = (bits >> LIGHT_SHIFT) & 0x1F;
  const bool pick_light = (bits >> B_PICKLIGHT) & 1;
  V3 dir_light = V3{0.0f, 0.0f, 0.0f};
  if ((flags & F_NEEDS_MIS) &&
      (mt == MAT_LAMBERT || mt == MAT_ROUGH_CONDUCTOR)) {
    V3 ax_s;
    float cm_s;
    imp_cone(imp + 6 * lidx, point, ax_s, cm_s);
    dir_light = from_frame(cone_uniform(u[4], u[5], cm_s), make_frame(ax_s));
  }

  // --- reverse: state update and material ------------------------------------------
  // exit thr = thr2 * mul, rad_delta += thr2 * emission; gthr becomes the
  // cotangent of thr2
  const V3 zero = V3{0.0f, 0.0f, 0.0f};
  SurfAdj s{zero, zero, zero, zero, zero, zero, 0.0f, 0.0f};
  const V3 g_new_o = go, g_new_d = gd;

  switch (mt) {
    case MAT_EMITTER:
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        tadd(gtab, o_s0 + b, grad[b] * thr2[b]);
        gthr[b] = grad[b] * s0[b];
      }
      s.g_refl = g_new_o;
      s.g_d = g_new_d;
      break;
    case MAT_EMITTER_ANISO: {
      float power = mrec[0];
      float base = maxp(abs_cos_in, 1e-9f);
      float factor = spow(base, power);
      float g_factor = 0.0f;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float ge = grad[b] * thr2[b];
        g_factor += ge * s0[b];
        tadd(gtab, o_s0 + b, ge * factor);
        gthr[b] = grad[b] * (s0[b] * factor);
      }
      if (power != 0.0f && abs_cos_in >= 1e-9f)
        s.g_abs_cos += g_factor * power * powf(base, power - 1.0f);
      tadd(gtab, moff, g_factor * factor * logf(base));
      s.g_refl = g_new_o;
      s.g_d = g_new_d;
      break;
    }
    case MAT_CHECKERBOARD: {
      bool parity = (bits >> B_PARITY) & 1;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        tadd(gtab, (parity ? o_s0 : o_s1) + b, grad[b] * thr2[b]);
        gthr[b] = grad[b] * (parity ? s0[b] : s1[b]);
      }
      s.g_refl = g_new_o;
      s.g_d = g_new_d;
      break;
    }
    case MAT_LIGHT: {
      float val = -(mrec[0] * n_sh.x + mrec[1] * n_sh.y + mrec[2] * n_sh.z);
      float fac = maxp(0.0f, val);
      float g_fac = 0.0f;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float ge = grad[b] * thr2[b];
        g_fac += ge * s0[b];
        tadd(gtab, o_s0 + b, ge * fac);
        gthr[b] = grad[b] * (s0[b] * fac);
      }
      if (val >= 0.0f) {
        tadd(gtab, moff + 0, -g_fac * n_sh.x);
        tadd(gtab, moff + 1, -g_fac * n_sh.y);
        tadd(gtab, moff + 2, -g_fac * n_sh.z);
        s.g_nsh = V3{-g_fac * mrec[0], -g_fac * mrec[1], -g_fac * mrec[2]};
      }
      s.g_refl = g_new_o;
      s.g_d = g_new_d;
      break;
    }
    case MAT_PERFECT_REFLECT:
      reflect_adj(d, n_sh, g_new_d, s.g_d, s.g_nsh);
      s.g_refl = g_new_o;
      break;
    case MAT_NULL:
      s.g_trans = g_new_o;
      s.g_d = g_new_d;
      break;
    case MAT_LAMBERT: {
      V3 hemi = hemisphere_cosine(u[1], u[2]);
      V3 dir_bsdf = from_frame(hemi, fr);
      bool lit = use_mis && pick_light;
      V3 out_dir = lit ? dir_light : dir_bsdf;
      float cos_out = dot3(out_dir, n_sh);
      float pdf_bsdf = maxp(cos_out, 0.0f) / PI;
      float pdf = pdf_bsdf;
      if (use_mis)
        pdf = cfg.w_imp * light_pdf(imp, n_imp, point, out_dir) +
              cfg.one_m_w_imp * pdf_bsdf;
      bool ok = (pdf > 1e-9f) && (cos_out > 0.0f);
      float pm = maxp(pdf, 1e-12f);
      float w_l = ok ? pdf_bsdf / pm : 0.0f;
      float g_wl = 0.0f;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float gm = gthr[b] * thr2[b];
        g_wl += gm * s0[b];
        tadd(gtab, o_s0 + b, gm * w_l);
        gthr[b] = gthr[b] * (s0[b] * w_l);
      }
      V3 g_out = g_new_d;
      if (ok) {
        float g_pdfb = g_wl / pm;
        float g_pdf = pdf >= 1e-12f ? -g_wl * pdf_bsdf / (pm * pm) : 0.0f;
        if (use_mis) {
          g_pdfb += cfg.one_m_w_imp * g_pdf;
          light_pdf_adj(imp, n_imp, point, out_dir, cfg.w_imp * g_pdf,
                        s.g_point, gtab, imp_base);
        } else {
          g_pdfb += g_pdf;
        }
        float g_cos = cos_out >= 0.0f ? g_pdfb / PI : 0.0f;
        acc(g_out, mul3(n_sh, g_cos));
        acc(s.g_nsh, mul3(out_dir, g_cos));
      }
      if (lit) {
        dir_light_adj(imp + 6 * lidx, point, u[4], u[5], g_out, s.g_point, gtab,
                      imp_base + 6 * lidx);
      } else {
        V3 g_hemi;
        Frame g_fr;
        from_frame_adj(hemi, fr, g_out, g_hemi, g_fr);
        acc(s.g_nsh, make_frame_adj(n_sh, g_fr));
      }
      s.g_refl = g_new_o;
      break;
    }
    case MAT_CONDUCTOR: {
      float g_ci = 0.0f;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float f = conductor_fresnel(abs_cos_in, s0[b], s1[b]);
        float g_n = 0.0f, g_k = 0.0f;
        conductor_fresnel_adj(abs_cos_in, s0[b], s1[b], gthr[b] * thr2[b], g_ci,
                              g_n, g_k);
        tadd(gtab, o_s0 + b, g_n);
        tadd(gtab, o_s1 + b, g_k);
        gthr[b] = gthr[b] * f;
      }
      s.g_abs_cos += g_ci;
      reflect_adj(d, n_sh, g_new_d, s.g_d, s.g_nsh);
      s.g_refl = g_new_o;
      break;
    }
    case MAT_ROUGH_CONDUCTOR: {
      // forward values the per-bin loop needs: |wo . h| and w_spec
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
      V3 wo = (use_mis && pick_light) ? dir_light : reflect(d, h_bsdf);
      V3 h_raw = V3{wi.x + wo.x, wi.y + wo.y, wi.z + wo.z};
      float h_len = sqrtf(maxp(dot3(h_raw, h_raw), 1e-24f));
      V3 h = V3{h_raw.x / h_len, h_raw.y / h_len, h_raw.z / h_len};
      float ct_i = maxp(dot3(wi, n_sh), 1e-6f);
      float ct_o = dot3(wo, n_sh);
      float ct_h = dot3(h, n_sh);
      float odh = dot3(wo, h);
      float dd = ct_h * ct_h * (a2 - 1.0f) + 1.0f;
      float d_ggx = a2 / maxp(PI * dd * dd, 1e-12f);
      float pdf_bsdf = 0.25f * d_ggx *
                       fabsf(ct_h / (fabsf(odh) > 1e-9f ? odh : 1e-9f));
      float pdf = pdf_bsdf;
      if (use_mis)
        pdf = cfg.w_imp * light_pdf(imp, n_imp, point, wo) +
              cfg.one_m_w_imp * pdf_bsdf;
      bool ok = (ct_o > 1e-6f) && (pdf > 1e-9f);
      float cto = maxp(ct_o, 1e-6f);
      float w_spec = ok ? d_ggx * (smith_g1(ct_i, a2) * smith_g1(cto, a2)) /
                              (4.0f * ct_i * maxp(pdf, 1e-12f))
                        : 0.0f;
      float aoh = fabsf(odh);
      float g_wspec = 0.0f, g_aoh = 0.0f;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float f = conductor_fresnel(aoh, s0[b], s1[b]);
        float gm = gthr[b] * thr2[b];
        g_wspec += gm * f;
        float g_n = 0.0f, g_k = 0.0f;
        conductor_fresnel_adj(aoh, s0[b], s1[b], gm * w_spec, g_aoh, g_n, g_k);
        tadd(gtab, o_s0 + b, g_n);
        tadd(gtab, o_s1 + b, g_k);
        gthr[b] = gthr[b] * (f * w_spec);
      }
      rough_conductor_adj(mrec, moff, imp, n_imp, imp_base, cfg, use_mis,
                          pick_light, lidx, u, d, n_sh, fr, point, dir_light,
                          g_wspec, g_aoh, g_new_d, s, gtab);
      s.g_refl = g_new_o;
      break;
    }
    case MAT_DIELECTRIC: {
      float n_int = maxp(mrec[8], 1e-3f);
      float n_ext = maxp(mrec[9], 1e-3f);
      bool trans_only = mrec[0] > 0.5f;
      float c1 = cos_in;
      bool entering = c1 >= 0.0f;
      float n1 = entering ? n_ext : n_int;
      float n2 = entering ? n_int : n_ext;
      float gamma = n1 / n2;
      float c2s = 1.0f - gamma * gamma * (1.0f - c1 * c1);
      bool tir_c = c2s <= 0.0f;
      float sq = !tir_c ? ssqrt(c2s) : 0.0f;
      float temp_t = entering ? gamma * c1 - sq : gamma * c1 + sq;
      bool tr = (bits >> B_TRANSMIT) & 1;
      bool tir = (bits >> B_TIR) & 1;
      float mul = (tir && trans_only) ? 0.0f : 1.0f;
#pragma unroll
      for (int b = 0; b < NB; ++b) gthr[b] = gthr[b] * mul;
      if (tr) {
        s.g_trans = g_new_o;
        V3 tv = V3{gamma * d.x + temp_t * n.x, gamma * d.y + temp_t * n.y,
                   gamma * d.z + temp_t * n.z};
        V3 g_tv = norm3_adj(tv, g_new_d);
        float g_gamma = dot3(g_tv, d);
        acc(s.g_d, mul3(g_tv, gamma));
        float g_tt = dot3(g_tv, n);
        acc(s.g_n, mul3(g_tv, temp_t));
        g_gamma += g_tt * c1;
        float g_c1 = g_tt * gamma;
        float g_sq = entering ? -g_tt : g_tt;
        if (!tir_c && c2s > 0.0f) {
          float g_c2s = g_sq * 0.5f / sq;
          g_gamma += g_c2s * (-2.0f * gamma * (1.0f - c1 * c1));
          g_c1 += g_c2s * gamma * gamma * 2.0f * c1;
        }
        float g_n1 = g_gamma / n2;
        float g_n2 = -g_gamma * n1 / (n2 * n2);
        if (mrec[8] >= 1e-3f) tadd(gtab, moff + 8, entering ? g_n2 : g_n1);
        if (mrec[9] >= 1e-3f) tadd(gtab, moff + 9, entering ? g_n1 : g_n2);
        s.g_cos_in += g_c1;
      } else {
        s.g_refl = g_new_o;
        reflect_adj(d, n, g_new_d, s.g_d, s.g_n);
      }
      break;
    }
    default:  // MAT_ABSORBER
#pragma unroll
      for (int b = 0; b < NB; ++b) gthr[b] = 0.0f;
      s.g_refl = g_new_o;
      s.g_d = g_new_d;
      break;
  }

  // --- reverse: surface frame ---------------------------------------------------------
  V3 g_d = s.g_d;
  V3 g_o = zero;
  V3 g_outside = front ? s.g_refl : s.g_trans;
  V3 g_inside = front ? s.g_trans : s.g_refl;
  V3 g_n = s.g_n;
  acc(g_n, front ? s.g_nsh : V3{-s.g_nsh.x, -s.g_nsh.y, -s.g_nsh.z});
  float g_cos_in = s.g_cos_in + s.g_abs_cos * sgn0(cos_in);
  float g_ddn = -fs * g_cos_in;

  // --- reverse: volumes ------------------------------------------------------------------
  // gthr is the cotangent of thr2 here and becomes that of thr1
  float g_tseg = 0.0f;
  if (n_vol > 0 && in_mask != 0ull) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float prod = 1.0f, vol_em = 0.0f;
      for (int v = 0; v < n_vol; ++v) {
        const int* vr = vols + D_VOL_WORDS * v;
        if (!((in_mask >> v) & 1ull)) continue;
        const int ob = mat_base + vr[0] * mat_stride + 10;
        if (vr[1] == VOL_BEER) {
          float base = tab[ob + NB + b];
          float att = base > 1e-9f ? spow(base, t_seg) : 0.0f;
          // the product of the other volumes' attenuations
          float oth = 1.0f;
          for (int w = 0; w < n_vol; ++w) {
            const int* wr = vols + D_VOL_WORDS * w;
            if (w == v || wr[1] != VOL_BEER || !((in_mask >> w) & 1ull))
              continue;
            float bw = tab[mat_base + wr[0] * mat_stride + 10 + NB + b];
            oth = oth * (bw > 1e-9f ? spow(bw, t_seg) : 0.0f);
          }
          if (base > 1e-9f) {
            float g_att = gthr[b] * thr1[b] * oth;
            if (t_seg != 0.0f)
              tadd(gtab, ob + NB + b, g_att * t_seg * powf(base, t_seg - 1.0f));
            g_tseg += g_att * att * logf(base);
          }
          prod = prod * att;
        } else {  // VOL_HOMOGENEOUS
          float spec0 = tab[ob + b];
          float g_ve = grad[b] * thr1[b];
          tadd(gtab, ob + b, g_ve * t_seg);
          g_tseg += g_ve * spec0;
          vol_em = vol_em + spec0 * t_seg;
        }
      }
      gthr[b] = gthr[b] * prod + grad[b] * vol_em;
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) gthr[b] = gthr[b] * scale;

  // --- reverse: hit point, normal, distance ----------------------------------------------
  V3 g_point = s.g_point;
  acc(g_point, g_outside);
  acc(g_point, g_inside);
  V3 g_diff = V3{g_outside.x - g_inside.x, g_outside.y - g_inside.y,
                 g_outside.z - g_inside.z};
  acc(g_n, mul3(g_diff, off_p));
  float g_off = dot3(g_diff, n) * T_EPS;
  if (m_xyz >= 1.0f) {  // clamp(min=1) passes the gradient on m >= 1
    float g_x = 0.0f, g_yz = 0.0f, g_y = 0.0f, g_z = 0.0f;
    max_adj(apx, m_yz, g_off, g_x, g_yz);
    max_adj(apy, apz, g_yz, g_y, g_z);
    g_point.x += g_x * sgn0(point.x);
    g_point.y += g_y * sgn0(point.y);
    g_point.z += g_z * sgn0(point.z);
  }
  acc(g_o, g_point);
  acc(g_d, mul3(g_point, t_safe));
  float g_ts = dot3(g_point, d) + g_tseg;
  V3 g_nw = mul3(g_n, fs);
  acc(g_d, mul3(nw, g_ddn));
  acc(g_nw, mul3(d, g_ddn));
  V3 g_raw = norm3_adj(nw_raw, g_nw);
  // nw_raw = M^T nl
  float gm[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) gm[k] = 0.0f;
  float gpp[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) gpp[k] = 0.0f;
  V3 g_nl = V3{wrec[0] * g_raw.x + wrec[1] * g_raw.y + wrec[2] * g_raw.z,
               wrec[4] * g_raw.x + wrec[5] * g_raw.y + wrec[6] * g_raw.z,
               wrec[8] * g_raw.x + wrec[9] * g_raw.y + wrec[10] * g_raw.z};
  gm[0] += nl.x * g_raw.x; gm[1] += nl.x * g_raw.y; gm[2] += nl.x * g_raw.z;
  gm[4] += nl.y * g_raw.x; gm[5] += nl.y * g_raw.y; gm[6] += nl.y * g_raw.z;
  gm[8] += nl.z * g_raw.x; gm[9] += nl.z * g_raw.y; gm[10] += nl.z * g_raw.z;
  V3 g_ph = zero;
  normal_local_adj(tid, ph, pp, g_nl, g_ph, gpp);
  // ph = M pw + t
  V3 g_pw = V3{wrec[0] * g_ph.x + wrec[4] * g_ph.y + wrec[8] * g_ph.z,
               wrec[1] * g_ph.x + wrec[5] * g_ph.y + wrec[9] * g_ph.z,
               wrec[2] * g_ph.x + wrec[6] * g_ph.y + wrec[10] * g_ph.z};
  gm[0] += g_ph.x * pw.x; gm[1] += g_ph.x * pw.y; gm[2] += g_ph.x * pw.z; gm[3] += g_ph.x;
  gm[4] += g_ph.y * pw.x; gm[5] += g_ph.y * pw.y; gm[6] += g_ph.y * pw.z; gm[7] += g_ph.y;
  gm[8] += g_ph.z * pw.x; gm[9] += g_ph.z * pw.y; gm[10] += g_ph.z * pw.z; gm[11] += g_ph.z;
  acc(g_o, g_pw);
  acc(g_d, mul3(g_pw, t_s));
  g_ts += dot3(g_pw, d);
  // t_s = t_g below the miss threshold; t_g = HIT(lo, ld, pp)
  if (t_ok) {
    V3 g_lo = zero, g_ld = zero;
    hit_local_adj(tid, lo, ld, pp, eps, g_ts, g_lo, g_ld, gpp);
    g_o.x += wrec[0] * g_lo.x + wrec[4] * g_lo.y + wrec[8] * g_lo.z;
    g_o.y += wrec[1] * g_lo.x + wrec[5] * g_lo.y + wrec[9] * g_lo.z;
    g_o.z += wrec[2] * g_lo.x + wrec[6] * g_lo.y + wrec[10] * g_lo.z;
    g_d.x += wrec[0] * g_ld.x + wrec[4] * g_ld.y + wrec[8] * g_ld.z;
    g_d.y += wrec[1] * g_ld.x + wrec[5] * g_ld.y + wrec[9] * g_ld.z;
    g_d.z += wrec[2] * g_ld.x + wrec[6] * g_ld.y + wrec[10] * g_ld.z;
    gm[0] += g_lo.x * o.x + g_ld.x * d.x; gm[1] += g_lo.x * o.y + g_ld.x * d.y;
    gm[2] += g_lo.x * o.z + g_ld.x * d.z; gm[3] += g_lo.x;
    gm[4] += g_lo.y * o.x + g_ld.y * d.x; gm[5] += g_lo.y * o.y + g_ld.y * d.y;
    gm[6] += g_lo.y * o.z + g_ld.y * d.z; gm[7] += g_lo.y;
    gm[8] += g_lo.z * o.x + g_ld.z * d.x; gm[9] += g_lo.z * o.y + g_ld.z * d.y;
    gm[10] += g_lo.z * o.z + g_ld.z * d.z; gm[11] += g_lo.z;
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) tadd(gtab, woff + k, gm[k]);
#pragma unroll
  for (int k = 0; k < 8; ++k) tadd(gtab, woff + 12 + k, gpp[k]);
  go = g_o;
  gd = g_d;
}

}  // namespace fb
