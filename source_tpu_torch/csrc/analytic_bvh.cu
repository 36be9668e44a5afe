// Nearest hit over analytic leaves on a threaded SAH BVH, one ray per thread.
//
// Replaces the TPU kernel source_tpu/tracer/pallas_analytic.py:702 ``_kernel``
// (called through ``analytic_bvh_winner``, :1017). Its plain PyTorch version,
// and the specification, is ``analytic_bvh_winner_plain`` in
// tracer/analytic_bvh.py; the tables are those of ``pack_leaf_bvh_host``:
//
//   nodes  f32[n_nodes, 9]   lo xyz, hi xyz, skip, first, count
//   leaves f32[n_items, 23]  per record type: general (w2l rows 0..11,
//                            params 12..19), world sphere (c, r), world box
//                            (lo, hi), CSG (table row, signature); 20 type,
//                            21 global leaf id, 22 entity
//   csg    f32[n_csg, 127]   n_children, then per child gid, w2l rows, params
//   sigs   i32[n_sig, 32]    n_children, n_ops, child types x6, (op, arg) x12
//
// Design. The TPU kernel moves a tile of 1024 rays with ONE shared node
// pointer and tests a leaf under a per-lane mask. Here every thread walks the
// tree alone along the skip pointers: it descends where its own slab test
// hits, else escapes. A lane of the tile only ever takes a leaf's item under
// its own ``lane_hit`` and with the strict ``t < t_best`` in the same node
// order, so the per-thread walk gives the same winner, ties included. The
// tables are small and read by every thread: they are read through the
// read-only cache (``__ldg``). The per-type closed forms are the fused
// kernels' (fused_bounce.cuh: quad, hit_local, normal_local, xf_point,
// xf_dir, inv_dir, n_box), the same arithmetic
// as the TPU kernel's own; the convex intervals of the CSG children are this
// file's. A small CSG is resolved from its children's intervals: every
// boundary lies on an interval endpoint, so the postfix program is evaluated
// just before and just after each of the 2l endpoints; the 2l evaluations are
// packed as bits of one word per child, so one pass of the program over
// 32-bit words serves them all.
//
// What bounds it on this card: operations and divergence, not bytes. A ray
// reads 7 floats and writes 8; the tables stay in L1/L2. Each visited node
// costs a slab test (~20 flops) and each tested item a closed form (20-300
// flops; a CSG item 6 intervals and a program pass). Neighbouring threads walk
// different node paths unless the wrapper sorts the rays by direction octant
// and origin Morton code first (``sort_rays``).
//
// Built with -fmad=false and no fast math (NVCC_FLAGS in tracer/fused.py):
// the plain version's products and sums round separately.

#define SRC_BINS 1
#include "fused_bounce.cuh"

#include <cuda_runtime.h>

namespace ab {

using fb::BIG;
using fb::V3;

enum { KT_SPHERE_W = 6, KT_BOX_W = 7, KT_CSG = 8 };
enum { NODE_W = 9, LEAF_W = 23, CSG_W = 127, CHILD_W = 21, SIG_W = 32,
       MAX_CHILD = 6 };

struct Item {
  float t;
  bool inside;
  V3 n;
  int gid;
  int ishi;
};

__device__ __forceinline__ float ld(const float* p, int k) { return __ldg(p + k); }

__device__ __forceinline__ float safe_inv(float x) {
  return fabsf(x) > 1e-12f ? 1.0f / x : BIG;
}

// a local normal to world through the transpose of the 12 w2l row scalars
__device__ __forceinline__ V3 to_world(const float* m, V3 n) {
  return V3{m[0] * n.x + m[4] * n.y + m[8] * n.z,
            m[1] * n.x + m[5] * n.y + m[9] * n.z,
            m[2] * n.x + m[6] * n.y + m[10] * n.z};
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
  iv.lo = fb::minp(iv.lo, v ? t : BIG);
  iv.hi = fb::maxp(iv.hi, v ? t : -BIG);
  iv.v = iv.v || v;
}

__device__ Ival ival(int tid, V3 o, V3 d, const float* p) {
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
    float lo = fb::maxp(fb::maxp(fb::minp(t0x, t1x), fb::minp(t0y, t1y)),
                        fb::minp(t0z, t1z));
    float hi = fb::minp(fb::minp(fb::maxp(t0x, t1x), fb::maxp(t0y, t1y)),
                        fb::maxp(t0z, t1z));
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
    float slab_lo = flat ? (in_slab ? -BIG : BIG) : fb::minp(s0, s1);
    float slab_hi = flat ? (in_slab ? BIG : -BIG) : fb::maxp(s0, s1);
    float lo = fb::maxp(tube_lo, slab_lo);
    float hi = fb::minp(tube_hi, slab_hi);
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

// postfix program over per-child bit words (OP_LEAF 0, union 1, intersect 2,
// subtract 3)
__device__ __forceinline__ unsigned eval_program(const int* sig,
                                                 const unsigned* states) {
  unsigned stack[MAX_CHILD + 1];
  int top = 0;
  int n_ops = __ldg(sig + 1);
  for (int k = 0; k < n_ops; ++k) {
    int op = __ldg(sig + 8 + 2 * k);
    if (op == 0) {
      stack[top++] = states[__ldg(sig + 9 + 2 * k)];
    } else {
      unsigned b = stack[--top];
      unsigned a = stack[top - 1];
      stack[top - 1] = op == 1 ? (a | b) : (op == 2 ? (a & b) : (a & ~b));
    }
  }
  return stack[0];
}

__device__ __noinline__ Item csg_item(const float* row, const int* sig, V3 o,
                                      V3 d, float t_min) {
  int l = __ldg(sig);
  Ival iv[MAX_CHILD];
  for (int c = 0; c < l; ++c) {
    const float* ch = row + 1 + c * CHILD_W;
    float m[12], pp[8];
    for (int k = 0; k < 12; ++k) m[k] = ld(ch, 1 + k);
    for (int k = 0; k < 8; ++k) pp[k] = ld(ch, 13 + k);
    iv[c] = ival(__ldg(sig + 2 + c), fb::xf_point(m, o), fb::xf_dir(m, d), pp);
  }
  // bit 2c+kind of child k's words: k's state just before / after endpoint
  // (c, kind)
  unsigned before[MAX_CHILD], after[MAX_CHILD];
  for (int k = 0; k < l; ++k) {
    unsigned b = 0u, a = 0u;
    for (int c = 0; c < l; ++c) {
      for (int kind = 0; kind < 2; ++kind) {
        float e = kind ? iv[c].hi : iv[c].lo;
        int j = 2 * c + kind;
        b |= unsigned((iv[k].lo < e) && (e <= iv[k].hi) && iv[k].v) << j;
        a |= unsigned((iv[k].lo <= e) && (e < iv[k].hi) && iv[k].v) << j;
      }
    }
    before[k] = b;
    after[k] = a;
  }
  unsigned pb = eval_program(sig, before);
  unsigned pa = eval_program(sig, after);
  float t_b = BIG;
  int win_c = 0, ishi = 0;
  bool inside = false;
  for (int c = 0; c < l; ++c) {
    for (int kind = 0; kind < 2; ++kind) {
      float e = kind ? iv[c].hi : iv[c].lo;
      int j = 2 * c + kind;
      bool b = (pb >> j) & 1u;
      bool a = (pa >> j) & 1u;
      if (iv[c].v && e > t_min && b != a && e < t_b) {
        t_b = e;
        win_c = c;
        ishi = kind;
        inside = b;
      }
    }
  }
  // the winning child's outward normal at the crossing
  float t_sn = t_b < 1e30f ? t_b : 0.0f;
  V3 pw{o.x + t_sn * d.x, o.y + t_sn * d.y, o.z + t_sn * d.z};
  const float* ch = row + 1 + win_c * CHILD_W;
  float m[12], pp[8];
  for (int k = 0; k < 12; ++k) m[k] = ld(ch, 1 + k);
  for (int k = 0; k < 8; ++k) pp[k] = ld(ch, 13 + k);
  V3 n = to_world(m, fb::normal_local(__ldg(sig + 2 + win_c),
                                       fb::xf_point(m, pw), pp));
  return Item{t_b, inside, n, int(ld(ch, 0)), ishi};
}

__device__ __forceinline__ Item test_item(const float* rec, const float* csg,
                                          const int* sigs, V3 o, V3 d, V3 inv,
                                          float t_min) {
  int typ = int(ld(rec, 20));
  int gid = int(ld(rec, 21));
  Item it;
  it.gid = gid;
  it.ishi = 0;
  if (typ == KT_CSG) {
    return csg_item(csg + int(ld(rec, 0)) * CSG_W, sigs + int(ld(rec, 1)) * SIG_W,
                    o, d, t_min);
  }
  if (typ == KT_SPHERE_W) {
    V3 p{o.x - ld(rec, 0), o.y - ld(rec, 1), o.z - ld(rec, 2)};
    it.t = fb::hit_sphere(p, d, ld(rec, 3), t_min, it.inside);
    it.n = V3{p.x + it.t * d.x, p.y + it.t * d.y, p.z + it.t * d.z};
    return it;
  }
  if (typ == KT_BOX_W) {
    float b[6];
    for (int k = 0; k < 6; ++k) b[k] = ld(rec, k);
    float t0x = (b[0] - o.x) * inv.x, t1x = (b[3] - o.x) * inv.x;
    float t0y = (b[1] - o.y) * inv.y, t1y = (b[4] - o.y) * inv.y;
    float t0z = (b[2] - o.z) * inv.z, t1z = (b[5] - o.z) * inv.z;
    float lo = fb::maxp(fb::maxp(fb::minp(t0x, t1x), fb::minp(t0y, t1y)),
                        fb::minp(t0z, t1z));
    float hi = fb::minp(fb::minp(fb::maxp(t0x, t1x), fb::maxp(t0y, t1y)),
                        fb::maxp(t0z, t1z));
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
  for (int k = 0; k < 12; ++k) m[k] = ld(rec, k);
  for (int k = 0; k < 8; ++k) pp[k] = ld(rec, 12 + k);
  V3 lo = fb::xf_point(m, o), ldir = fb::xf_dir(m, d);
  it.t = fb::hit_local(typ, lo, ldir, pp, t_min, it.inside);
  V3 p{lo.x + it.t * ldir.x, lo.y + it.t * ldir.y, lo.z + it.t * ldir.z};
  it.n = to_world(m, fb::normal_local(typ, p, pp));
  return it;
}

__global__ void __launch_bounds__(256)
winner_kernel(const float* __restrict__ o_in, const float* __restrict__ d_in,
              const float* __restrict__ tmin_in, int N,
              const float* __restrict__ nodes, int n_nodes,
              const float* __restrict__ leaves, const float* __restrict__ csg,
              const int* __restrict__ sigs, float* __restrict__ t_out,
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
    const float* nd = nodes + node * NODE_W;
    float t0x = (ld(nd, 0) - o.x) * inv.x, t1x = (ld(nd, 3) - o.x) * inv.x;
    float t0y = (ld(nd, 1) - o.y) * inv.y, t1y = (ld(nd, 4) - o.y) * inv.y;
    float t0z = (ld(nd, 2) - o.z) * inv.z, t1z = (ld(nd, 5) - o.z) * inv.z;
    float tnear = fb::maxp(fb::maxp(fb::minp(t0x, t1x), fb::minp(t0y, t1y)),
                           fb::minp(t0z, t1z));
    float tfar = fb::minp(fb::minp(fb::maxp(t0x, t1x), fb::maxp(t0y, t1y)),
                          fb::maxp(t0z, t1z));
    bool lane_hit = (tfar >= fb::maxp(tnear, 0.0f)) && (tnear < t_best);
    int count = int(ld(nd, 8));
    if (lane_hit && count > 0) {
      int first = int(ld(nd, 7));
      for (int k = 0; k < count; ++k) {
        const float* rec = leaves + (first + k) * LEAF_W;
        Item it = test_item(rec, csg, sigs, o, d, inv, t_min);
        if (it.t < t_best) {
          t_best = it.t;
          leaf = it.gid;
          ent = int(ld(rec, 22));
          inside = it.inside;
          n = it.n;
          ishi = it.ishi;
        }
      }
    }
    node = (lane_hit && count == 0) ? node + 1 : int(ld(nd, 6));
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
int analytic_bvh_winner(const float* o, const float* d, const float* t_min,
                        int N, const float* nodes, int n_nodes,
                        const float* leaves, const float* csg, const int* sigs,
                        float* t_out, int* leaf_out, int* ent_out, int* ins_out,
                        float* n_out, int* ishi_out, void* stream) {
  if (N <= 0) return 0;
  const int threads = 256;
  int blocks = (N + threads - 1) / threads;
  ab::winner_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      o, d, t_min, N, nodes, n_nodes, leaves, csg, sigs, t_out, leaf_out,
      ent_out, ins_out, n_out, ishi_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
