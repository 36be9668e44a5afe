// Nearest hit over analytic leaves on a threaded SAH BVH, one ray per thread.
//
// Replaces the TPU kernel source_tpu/tracer/pallas_analytic.py:702 ``_kernel``
// (called through ``analytic_bvh_winner``, :1017). The specification is
// ``analytic_bvh_winner_plain`` in tracer/analytic_bvh.py (the threaded walk
// over the tables of ``pack_leaf_bvh_host``); this kernel's own walk in plain
// PyTorch is ``pruned_walk_plain`` there. It reads the records of
// ``pack_bvh_records`` (integers as int32 bits):
//
//   nodes    f32[n_nodes, 8]   lo xyz, skip | hi xyz, first << 8 | count
//   items    f32[n_items, 32]  box lo xyz, type | box hi xyz, entity | the
//                              item's record of "leaves": per record type
//                              general (w2l rows, params), world sphere
//                              (c, r), world box (lo, hi), CSG (first child
//                              row, child count, truth table low and high
//                              words); type, global leaf id and entity as
//                              floats | 0
//   children f32[6 n_csg, 24]  w2l rows (12), params (8), global leaf id, type
//
// Design. The TPU kernel moves a tile of 1024 rays with ONE shared node
// pointer and tests a leaf under a per-lane mask. Here every thread walks the
// tree alone along the skip pointers: it descends where its own slab test
// hits, else escapes. A lane of the tile only ever takes a leaf's item under
// its own ``lane_hit`` and with the strict ``t < t_best`` in the same node
// order, so the per-thread walk gives the same winner, ties included.
//
// What bounds it on this card: operations and divergence, not bytes (the
// records, a few kB, stay in L1). So the kernel does less arithmetic than
// the threaded walk. Each item carries the padded box the BVH was built over
// (a CSG item a tighter one, its program over its children's boxes), and an
// item is tested only if the ray enters its box under the node's own rule:
// an item skipped so cannot meet the ray before t_best, so cannot win under
// the strict rule, and the tested items keep their order, so winners and
// ties stay the threaded walk's. A small CSG is resolved from its children's
// convex intervals: every boundary lies on an interval endpoint, so the
// solid's state just before and just after each of the 2l endpoints decides
// it, read from the program's 64-bit truth table at the children's states.
// Every array is indexed by compile-time constants (the children's loop
// writes its interval by an unrolled select; the resolve is a template on
// the child count), and the torus is called with its arguments by value, so
// nothing spills. The one stack frame ptxas reports (32 B) is cosf's
// scratch for reducing arguments beyond 1e5, in the torus's cubic
// (fb::cubic_largest), whose argument here is at most pi/3: never touched.
// Records are float4 rows (a child six loads, a general item five); the
// winning child's row is read again for its normal, an L1 hit: holding
// every child's 20 words in registers (248 registers) timed no faster.
//
// The per-type closed forms are the fused kernels' (fused_bounce.cuh: quad,
// the hit_* functions, normal_local, xf_point, xf_dir, inv_dir, n_box), the
// same arithmetic as the TPU kernel's own (the torus's through this file's
// torus_hit); the convex intervals of the CSG children are this file's. Built with -fmad=false and no fast math
// (NVCC_FLAGS in tracer/fused.py): the plain version's products and sums
// round separately.

#define SRC_BINS 1
#include "fused_bounce.cuh"

#include <cuda_runtime.h>

namespace ab {

using fb::BIG;
using fb::maxp;
using fb::minp;
using fb::V3;

enum { KT_SPHERE_W = 6, KT_BOX_W = 7, KT_CSG = 8 };
// row widths in float4s (tracer/analytic_bvh.py: NODE_W, ITEM_W, CHILD_W),
// the item's record of "leaves" at float4 2 of its row
enum { NODE_Q = 2, ITEM_Q = 8, CHILD_Q = 6, REC_Q = 2, MAX_CHILD = 6 };
// 128 threads a block and at least 5 blocks an SM: ptxas holds the kernel
// to 96 registers with no spills. Without the cap it takes 128 registers
// and runs 8-12 % slower; at 6 blocks (80 registers) it spills 50 B for no
// gain; 256-thread blocks time the same or slower (PERF.md, Findings).
#define AB_THREADS 128
#define AB_MIN_BLOCKS 5

struct Item {
  float t;
  bool inside;
  V3 n;
  int gid;
  int ishi;
};

__device__ __forceinline__ float4 ld4(const float4* p) { return __ldg(p); }
__device__ __forceinline__ int bits(float x) { return __float_as_int(x); }

__device__ __forceinline__ float safe_inv(float x) {
  return fabsf(x) > 1e-12f ? 1.0f / x : BIG;
}

// a local normal to world through the transpose of the 12 w2l row scalars
__device__ __forceinline__ V3 to_world(const float* m, V3 n) {
  return V3{m[0] * n.x + m[4] * n.y + m[8] * n.z,
            m[1] * n.x + m[5] * n.y + m[9] * n.z,
            m[2] * n.x + m[6] * n.y + m[10] * n.z};
}

// The walk's slab test: the box is entered no later than it is left, not
// behind the ray, and strictly before t_best.
__device__ __forceinline__ bool slab_hit(float4 lo, float4 hi, V3 o, V3 inv,
                                         float t_best) {
  float t0x = (lo.x - o.x) * inv.x, t1x = (hi.x - o.x) * inv.x;
  float t0y = (lo.y - o.y) * inv.y, t1y = (hi.y - o.y) * inv.y;
  float t0z = (lo.z - o.z) * inv.z, t1z = (hi.z - o.z) * inv.z;
  float tnear = maxp(maxp(minp(t0x, t1x), minp(t0y, t1y)), minp(t0z, t1z));
  float tfar = minp(minp(maxp(t0x, t1x), maxp(t0y, t1y)), maxp(t0z, t1z));
  return (tfar >= maxp(tnear, 0.0f)) && (tnear < t_best);
}

// 12 w2l row scalars and 8 params from five float4s
__device__ __forceinline__ void load_frame(const float4* p, float* m,
                                           float* pp) {
  float4 a = ld4(p), b = ld4(p + 1), c = ld4(p + 2), e = ld4(p + 3),
         f = ld4(p + 4);
  m[0] = a.x; m[1] = a.y; m[2] = a.z; m[3] = a.w;
  m[4] = b.x; m[5] = b.y; m[6] = b.z; m[7] = b.w;
  m[8] = c.x; m[9] = c.y; m[10] = c.z; m[11] = c.w;
  pp[0] = e.x; pp[1] = e.y; pp[2] = e.z; pp[3] = e.w;
  pp[4] = f.x; pp[5] = f.y; pp[6] = f.z; pp[7] = f.w;
}

// --- convex ray intervals of the CSG children ----------------------------------

struct Ival {
  float lo, hi;
  bool v;
};

// (min, max) over the valid boundary crossings, folded in candidate order
__device__ __forceinline__ Ival cand_first(float t, bool v) {
  return Ival{v ? t : BIG, v ? t : -BIG, v};
}
__device__ __forceinline__ void cand(Ival& iv, float t, bool v) {
  iv.lo = minp(iv.lo, v ? t : BIG);
  iv.hi = maxp(iv.hi, v ? t : -BIG);
  iv.v = iv.v || v;
}

__device__ __forceinline__ Ival ival(int tid, V3 o, V3 d, const float* p) {
  if (tid == fb::TYPE_SPHERE) {
    float r = p[0];
    float a = d.x * d.x + d.y * d.y + d.z * d.z;
    float b = 2.0f * (o.x * d.x + o.y * d.y + o.z * d.z);
    float c = o.x * o.x + o.y * o.y + o.z * o.z - r * r;
    fb::Quad q = fb::quad(a, b, c);
    return Ival{q.lo, q.hi, q.v};
  }
  if (tid == fb::TYPE_BOX) {
    float ix = fb::inv_dir(d.x), iy = fb::inv_dir(d.y), iz = fb::inv_dir(d.z);
    float t0x = (p[0] - o.x) * ix, t1x = (p[3] - o.x) * ix;
    float t0y = (p[1] - o.y) * iy, t1y = (p[4] - o.y) * iy;
    float t0z = (p[2] - o.z) * iz, t1z = (p[5] - o.z) * iz;
    float lo = maxp(maxp(minp(t0x, t1x), minp(t0y, t1y)), minp(t0z, t1z));
    float hi = minp(minp(maxp(t0x, t1x), maxp(t0y, t1y)), maxp(t0z, t1z));
    return Ival{lo, hi, hi >= lo};
  }
  float r = p[0], h = p[1];
  if (tid == fb::TYPE_CYLINDER) {
    float a = d.x * d.x + d.y * d.y;
    float b = 2.0f * (o.x * d.x + o.y * d.y);
    float c = o.x * o.x + o.y * o.y - r * r;
    fb::Quad q = fb::quad(a, b, c);
    bool axial = a <= 1e-20f;
    bool in_tube = c <= 0.0f;
    float tube_lo = axial ? (in_tube ? -BIG : BIG) : (q.v ? q.lo : BIG);
    float tube_hi = axial ? (in_tube ? BIG : -BIG) : (q.v ? q.hi : -BIG);
    bool flat = fabsf(d.z) <= 1e-30f;
    float sdz = flat ? 1e-30f : d.z;
    float s0 = (0.0f - o.z) / sdz;
    float s1 = (h - o.z) / sdz;
    bool in_slab = (o.z >= 0.0f) && (o.z <= h);
    float slab_lo = flat ? (in_slab ? -BIG : BIG) : minp(s0, s1);
    float slab_hi = flat ? (in_slab ? BIG : -BIG) : maxp(s0, s1);
    float lo = maxp(tube_lo, slab_lo);
    float hi = minp(tube_hi, slab_hi);
    return Ival{lo, hi, hi >= lo};
  }
  bool nz = fabsf(d.z) > 1e-30f;
  float tc = -o.z / (nz ? d.z : 1e-30f);
  float px = o.x + tc * d.x;
  float py = o.y + tc * d.y;
  bool vc = nz && (px * px + py * py <= r * r);
  if (tid == fb::TYPE_CONE) {
    float k = r / h;
    float wo = h - o.z;
    float wd = -d.z;
    float a = d.x * d.x + d.y * d.y - k * k * wd * wd;
    float b = 2.0f * (o.x * d.x + o.y * d.y - k * k * wo * wd);
    float c = o.x * o.x + o.y * o.y - k * k * wo * wo;
    fb::Quad q = fb::quad(a, b, c);
    float z0 = o.z + q.lo * d.z;
    float z1 = o.z + q.hi * d.z;
    Ival iv = cand_first(q.lo, q.v && (z0 >= 0.0f) && (z0 <= h));
    cand(iv, q.hi, q.v && (z1 >= 0.0f) && (z1 <= h));
    cand(iv, tc, vc);
    return iv;
  }
  // TYPE_PARABOLA
  float a4 = r * r / h;
  float a = d.x * d.x + d.y * d.y;
  float b = 2.0f * (o.x * d.x + o.y * d.y) + a4 * d.z;
  float c = o.x * o.x + o.y * o.y + a4 * (o.z - h);
  fb::Quad q = fb::quad(a, b, c);
  float z0 = o.z + q.lo * d.z;
  float z1 = o.z + q.hi * d.z;
  bool v0 = q.v && (z0 >= 0.0f) && (z0 <= h);
  bool v1 = q.v && (z1 >= 0.0f) && (z1 <= h);
  bool lin = a <= 1e-20f;
  bool b_ok = fabsf(b) > 1e-30f;
  float tl = -c / (b_ok ? b : 1e-30f);
  float zl = o.z + tl * d.z;
  bool vl = lin && b_ok && (zl >= 0.0f) && (zl <= h);
  Ival iv = cand_first(lin ? tl : q.lo, (lin && vl) || (!lin && v0));
  cand(iv, q.hi, v1 && !lin);
  cand(iv, tc, vc);
  return iv;
}

// --- the CSG resolve ----------------------------------------------------------------

// the program's value at child state s (bit k: child k contains the point)
template <int L>
__device__ __forceinline__ bool truth(unsigned tlo, unsigned thi, unsigned s) {
  if (L <= 5) return (tlo >> s) & 1u;
  return ((s < 32u ? tlo >> s : thi >> (s - 32u)) & 1u) != 0u;
}

// The first endpoint, strictly after t_min, at which the solid's state
// changes: the state just before and just after each endpoint from the
// children's intervals, endpoints in child order, lo before hi, strict <.
// A child the ray misses holds (BIG, -BIG): it contains no point, and its
// endpoints are never after t_min and before t_b.
template <int L>
__device__ __forceinline__ void resolve(const float* lo, const float* hi,
                                        unsigned tlo, unsigned thi,
                                        float t_min, float& t_b, int& win_c,
                                        int& ishi, bool& inside) {
#pragma unroll
  for (int c = 0; c < L; ++c) {
#pragma unroll
    for (int kind = 0; kind < 2; ++kind) {
      float e = kind ? hi[c] : lo[c];
      unsigned sb = 0u, sa = 0u;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        sb |= unsigned((lo[k] < e) && (e <= hi[k])) << k;
        sa |= unsigned((lo[k] <= e) && (e < hi[k])) << k;
      }
      bool b = truth<L>(tlo, thi, sb);
      bool a = truth<L>(tlo, thi, sa);
      if (e > t_min && b != a && e < t_b) {
        t_b = e;
        win_c = c;
        ishi = kind;
        inside = b;
      }
    }
  }
}

// child c's interval, (BIG, -BIG) where the ray misses it
__device__ __forceinline__ void child_ival(const float4* ch, V3 o, V3 d,
                                           float& lo, float& hi) {
  float m[12], pp[8];
  load_frame(ch, m, pp);
  int tid = bits(ld4(ch + 5).y);
  Ival iv = ival(tid, fb::xf_point(m, o), fb::xf_dir(m, d), pp);
  lo = iv.v ? iv.lo : BIG;
  hi = iv.v ? iv.hi : -BIG;
}

__device__ __forceinline__ Item csg_item(const float4* rec,
                                         const float4* __restrict__ kids, V3 o,
                                         V3 d, float t_min) {
  float4 q = ld4(rec + REC_Q);
  const float4* ch = kids + CHILD_Q * bits(q.x);
  int l = bits(q.y);
  unsigned tlo = unsigned(bits(q.z)), thi = unsigned(bits(q.w));
  float lo[MAX_CHILD], hi[MAX_CHILD];
#pragma unroll
  for (int j = 0; j < MAX_CHILD; ++j) {
    lo[j] = BIG;
    hi[j] = -BIG;
  }
  // one copy of the interval code; its result lands in registers by an
  // unrolled select, never by an index computed at run time
#pragma unroll 1
  for (int c = 0; c < l; ++c) {
    float a, b;
    child_ival(ch + CHILD_Q * c, o, d, a, b);
#pragma unroll
    for (int j = 0; j < MAX_CHILD; ++j) {
      lo[j] = j == c ? a : lo[j];
      hi[j] = j == c ? b : hi[j];
    }
  }
  float t_b = BIG;
  int win_c = 0, ishi = 0;
  bool inside = false;
  switch (l) {
    case 1: resolve<1>(lo, hi, tlo, thi, t_min, t_b, win_c, ishi, inside); break;
    case 2: resolve<2>(lo, hi, tlo, thi, t_min, t_b, win_c, ishi, inside); break;
    case 3: resolve<3>(lo, hi, tlo, thi, t_min, t_b, win_c, ishi, inside); break;
    case 4: resolve<4>(lo, hi, tlo, thi, t_min, t_b, win_c, ishi, inside); break;
    case 5: resolve<5>(lo, hi, tlo, thi, t_min, t_b, win_c, ishi, inside); break;
    default: resolve<6>(lo, hi, tlo, thi, t_min, t_b, win_c, ishi, inside);
  }
  // the winning child's outward normal at the crossing
  float t_sn = t_b < 1e30f ? t_b : 0.0f;
  V3 pw{o.x + t_sn * d.x, o.y + t_sn * d.y, o.z + t_sn * d.z};
  const float4* w = ch + CHILD_Q * win_c;
  float m[12], pp[8];
  load_frame(w, m, pp);
  float4 tail = ld4(w + 5);
  V3 n = to_world(m, fb::normal_local(bits(tail.y), fb::xf_point(m, pw), pp));
  return Item{t_b, inside, n, bits(tail.x), ishi};
}

struct TorusHit {
  float t;
  bool inside;
};

// fb::hit_torus with the same arithmetic and its parameters and results by
// value: a call that takes no address leaves the caller's frame in
// registers (fb::hit_torus takes the params and ``inside`` by address)
__device__ __noinline__ TorusHit torus_hit(V3 o, V3 d, float R, float r,
                                           float t_min) {
  float dd = fb::dot3(d, d);
  float od = fb::dot3(o, d);
  float oo = fb::dot3(o, o);
  float k = oo - r * r - R * R;
  float a4 = dd * dd;
  float a3 = 4.0f * dd * od;
  float a2 = 2.0f * dd * k + 4.0f * od * od + 4.0f * R * R * d.z * d.z;
  float a1 = 4.0f * k * od + 8.0f * R * R * o.z * d.z;
  float a0 = k * k - 4.0f * R * R * (r * r - o.z * o.z);
  fb::Root roots[4];
  fb::solve_quartic(a4, a3, a2, a1, a0, 3, roots);
  float best = BIG;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float ts = roots[i].v ? roots[i].x : 0.0f;
    float px = o.x + ts * d.x;
    float py = o.y + ts * d.y;
    float pz = o.z + ts * d.z;
    fb::take_after(best, t_min, roots[i].x,
                   roots[i].v && fb::torus_root_valid(px, py, pz, R, r));
  }
  float rad = sqrtf(o.x * o.x + o.y * o.y + 1e-12f);
  return TorusHit{best, (rad - R) * (rad - R) + o.z * o.z <= r * r};
}

// fb::hit_local, the torus through this file's torus_hit
__device__ __forceinline__ float hit_general(int tid, V3 lo, V3 ld,
                                           const float* pp, float t_min,
                                           bool& inside) {
  switch (tid) {
    case fb::TYPE_SPHERE: return fb::hit_sphere(lo, ld, pp[0], t_min, inside);
    case fb::TYPE_BOX: return fb::hit_box(lo, ld, pp, t_min, inside);
    case fb::TYPE_CYLINDER: return fb::hit_cylinder(lo, ld, pp, t_min, inside);
    case fb::TYPE_CONE: return fb::hit_cone(lo, ld, pp, t_min, inside);
    case fb::TYPE_PARABOLA: return fb::hit_parabola(lo, ld, pp, t_min, inside);
    default: {
      TorusHit h = torus_hit(lo, ld, pp[0], pp[1], t_min);
      inside = h.inside;
      return h.t;
    }
  }
}

// a general, world-sphere or world-box item; ``p`` its record of "leaves"
__device__ __forceinline__ Item simple_item(int typ, const float4* p, V3 o,
                                            V3 d, V3 inv, float t_min) {
  Item it;
  it.gid = int(ld4(p + 5).y);
  it.ishi = 0;
  if (typ == KT_SPHERE_W) {
    float4 s = ld4(p);
    V3 q{o.x - s.x, o.y - s.y, o.z - s.z};
    it.t = fb::hit_sphere(q, d, s.w, t_min, it.inside);
    it.n = V3{q.x + it.t * d.x, q.y + it.t * d.y, q.z + it.t * d.z};
    return it;
  }
  if (typ == KT_BOX_W) {
    float4 a = ld4(p), c = ld4(p + 1);
    float b[6] = {a.x, a.y, a.z, a.w, c.x, c.y};
    float t0x = (b[0] - o.x) * inv.x, t1x = (b[3] - o.x) * inv.x;
    float t0y = (b[1] - o.y) * inv.y, t1y = (b[4] - o.y) * inv.y;
    float t0z = (b[2] - o.z) * inv.z, t1z = (b[5] - o.z) * inv.z;
    float lo = maxp(maxp(minp(t0x, t1x), minp(t0y, t1y)), minp(t0z, t1z));
    float hi = minp(minp(maxp(t0x, t1x), maxp(t0y, t1y)), maxp(t0z, t1z));
    bool v = hi >= lo;
    float best = BIG;
    fb::take_after(best, t_min, lo, v);
    fb::take_after(best, t_min, hi, v);
    it.t = best;
    it.inside = (o.x >= b[0]) && (o.x <= b[3]) && (o.y >= b[1]) &&
                (o.y <= b[4]) && (o.z >= b[2]) && (o.z <= b[5]);
    it.n = fb::n_box(V3{o.x + best * d.x, o.y + best * d.y, o.z + best * d.z}, b);
    return it;
  }
  float m[12], pp[8];
  load_frame(p, m, pp);
  V3 lo = fb::xf_point(m, o), ldir = fb::xf_dir(m, d);
  it.t = hit_general(typ, lo, ldir, pp, t_min, it.inside);
  V3 q{lo.x + it.t * ldir.x, lo.y + it.t * ldir.y, lo.z + it.t * ldir.z};
  it.n = to_world(m, fb::normal_local(typ, q, pp));
  return it;
}

__global__ void __launch_bounds__(AB_THREADS, AB_MIN_BLOCKS)
winner_kernel(const float* __restrict__ o_in, const float* __restrict__ d_in,
              const float* __restrict__ tmin_in, int N,
              const float4* __restrict__ nodes, int n_nodes,
              const float4* __restrict__ items,
              const float4* __restrict__ kids, float* __restrict__ t_out,
              int* __restrict__ leaf_out, int* __restrict__ ent_out,
              int* __restrict__ ins_out, float* __restrict__ n_out,
              int* __restrict__ ishi_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  V3 o{o_in[3 * i], o_in[3 * i + 1], o_in[3 * i + 2]};
  V3 d{d_in[3 * i], d_in[3 * i + 1], d_in[3 * i + 2]};
  float t_min = tmin_in[i];
  V3 inv{safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
  float t_best = BIG;
  int leaf = -1, ent = -1, ishi = 0;
  bool inside = false;
  V3 n{0.0f, 0.0f, 0.0f};
  int node = 0;
  while (node < n_nodes) {
    float4 a = ld4(nodes + NODE_Q * node), b = ld4(nodes + NODE_Q * node + 1);
    bool lane_hit = slab_hit(a, b, o, inv, t_best);
    int count = bits(b.w) & 255;
    if (lane_hit && count > 0) {
      const float4* rec = items + ITEM_Q * (bits(b.w) >> 8);
      for (int k = 0; k < count; ++k, rec += ITEM_Q) {
        float4 lo = ld4(rec), hi = ld4(rec + 1);
        if (!slab_hit(lo, hi, o, inv, t_best)) continue;
        int typ = bits(lo.w);
        Item it = typ == KT_CSG
                      ? csg_item(rec, kids, o, d, t_min)
                      : simple_item(typ, rec + REC_Q, o, d, inv, t_min);
        if (it.t < t_best) {
          t_best = it.t;
          leaf = it.gid;
          ent = bits(hi.w);
          inside = it.inside;
          n = it.n;
          ishi = it.ishi;
        }
      }
    }
    node = (lane_hit && count == 0) ? node + 1 : bits(a.w);
  }
  float len2 = n.x * n.x + n.y * n.y + n.z * n.z + 1e-24f;
  float inv_len = 1.0f / sqrtf(len2);
  t_out[i] = t_best;
  leaf_out[i] = leaf;
  ent_out[i] = ent;
  ins_out[i] = inside ? 1 : 0;
  n_out[3 * i] = n.x * inv_len;
  n_out[3 * i + 1] = n.y * inv_len;
  n_out[3 * i + 2] = n.z * inv_len;
  ishi_out[i] = ishi;
}

}  // namespace ab

extern "C" {

// Launches on ``stream``; returns the CUDA error of the launch (0 = queued).
// ``nodes``, ``items`` and ``children`` are the records of
// tracer/analytic_bvh.py ``pack_bvh_records``.
int analytic_bvh_winner(const float* o, const float* d, const float* t_min,
                        int N, const float* nodes, int n_nodes,
                        const float* items, const float* children,
                        float* t_out, int* leaf_out, int* ent_out, int* ins_out,
                        float* n_out, int* ishi_out, void* stream) {
  if (N <= 0) return 0;
  const int threads = AB_THREADS;
  int blocks = (N + threads - 1) / threads;
  ab::winner_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      o, d, t_min, N, (const float4*)nodes, n_nodes, (const float4*)items,
      (const float4*)children, t_out, leaf_out, ent_out, ins_out, n_out,
      ishi_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
