// Nearest triangle hit on one mesh's BVH, one ray per thread.
//
// Replaces two TPU kernels of the JAX package, which compute the same
// function: source_tpu/tracer/pallas_mesh.py:192 ``_kernel`` (K7, called
// through ``_run_traversal``, a mesh whose packed tables fit the TPU's VMEM)
// and :369 ``_paged_kernel`` (K8, a larger mesh cut into pages with private
// BVHs, rays sorted by page, a running winner across the page axis). Paging
// exists because the tables do not fit VMEM; on this card a 1.31M-triangle
// mesh (about 90 MB of records) sits in device memory, so both are this one
// walk over one BVH. Its plain PyTorch version is ``ordered_walk_plain`` in
// tracer/mesh_bvh.py (the same walk vectorised over lanes), and the
// specification ``mesh_intersect_plain`` in tracer/meshtrace.py (the
// threaded walk). The kernel reads the records of ``pack_mesh_records``:
//
//   nodes f32[R,16]  row 0: the root's box (lo.w = ref, hi.w = count);
//                    row r >= 1: one inner node as four float4s, child 0's
//                    lo and hi, then child 1's, each child's reference in
//                    lo.w and its triangle count in hi.w (int bits)
//   tris  f32[T,12]  three float4s a triangle, the coordinates of a, b, c,
//                    in BVH leaf order
//
// A reference r > 0 is an inner row; r < 0 a leaf, its triangles ~r ..
// ~r + count - 1.
//
// Design. What bounds the walk is the records it fetches, each a dependent
// round trip, and the longest walk among a warp's lanes (on the
// 1.31M-triangle mesh, the longest of all: every warp is resident at
// once), not the arithmetic. One 64-B fetch (two sectors) holds both
// children's boxes, so a node visit tests two boxes and orders them; a
// leaf's triangles are contiguous 48-B records, one round trip with no
// index table between. The walk goes nearest child first, the other child
// parked with its entry distance on a per-thread stack (local memory,
// MB_STACK deep; the packer checks the tree's depth), so t_best tightens
// early and parked boxes beyond it are dropped unread. The loop is
// while-while: a warp's lanes descend until each holds a leaf, then test
// their leaves together.
//
// The winner does not depend on the order of the walk: a hit replaces the
// best when (t, triangle id) is lexicographically smaller, and a box is
// pruned only when its entry distance is strictly beyond t_best, so a tie
// of lower id is never pruned away. That is the first minimum in leaf
// order, the threaded walk's winner under its strict t < t_best. With t_max,
// t_best starts there and tri_best at -1, so the tie clause never admits a
// hit at exactly t_max. The root's box is tested once per ray, so parked
// lanes (origin 3e7) fail there. The reciprocal rule is the reference
// traversal's: |d| > 1e-12 ? 1/d : 3e38 with the sign dropped.
//
// Built with -fmad=false and no fast math (NVCC_FLAGS in tracer/fused.py):
// the Woop test's forward-error-bound accept decides rays aimed at edges and
// vertices, and a contracted multiply-add or a reordered sum would move such
// lanes across an edge. Every sum keeps the association of
// tracer/watertight.py and every division is a true division.

#include <cuda_runtime.h>
#include <math.h>

namespace mb {

// NaN-propagating min/max, as torch.minimum/maximum
__device__ __forceinline__ float maxp(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float minp(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float safe_inv(float x) {
  return fabsf(x) > 1e-12f ? 1.0f / x : 3e38f;
}

struct Setup {
  float ox, oy, oz, sx, sy, sz;
  bool mz, mx, swap, dk_ok;
};

__device__ __forceinline__ Setup woop_setup(float ox, float oy, float oz,
                                            float dx, float dy, float dz) {
  Setup s;
  float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
  s.mz = (adz >= adx) && (adz >= ady);
  s.mx = (!s.mz) && (adx >= ady);
  float dk = s.mz ? dz : (s.mx ? dx : dy);
  float di = s.mz ? dx : (s.mx ? dy : dz);
  float dj = s.mz ? dy : (s.mx ? dz : dx);
  s.swap = dk < 0.0f;
  if (s.swap) {
    float tmp = di;
    di = dj;
    dj = tmp;
  }
  s.dk_ok = fabsf(dk) > 1e-30f;
  float inv = s.dk_ok ? 1.0f / dk : 0.0f;
  s.ox = ox;
  s.oy = oy;
  s.oz = oz;
  s.sx = di * inv;
  s.sy = dj * inv;
  s.sz = inv;
  return s;
}

// permuted (kx, ky, kz) components of a translated vertex
__device__ __forceinline__ void comps(const Setup& s, float vx, float vy,
                                      float vz, float& vi, float& vj,
                                      float& vk) {
  vk = s.mz ? vz : (s.mx ? vx : vy);
  vi = s.mz ? vx : (s.mx ? vy : vz);
  vj = s.mz ? vy : (s.mx ? vz : vx);
  if (s.swap) {
    float tmp = vi;
    vi = vj;
    vj = tmp;
  }
}

// tracer/watertight.py ``woop_tri_test``, operation for operation
__device__ __forceinline__ bool woop_tri_test(const Setup& s, const float* a,
                                              const float* b, const float* c,
                                              float t_min, float& t, float& u,
                                              float& v, bool& front) {
  const float E = 4.0f * 1.1920929e-07f;
  float Ai, Aj, Ak, Bi, Bj, Bk, Ci, Cj, Ck;
  comps(s, a[0] - s.ox, a[1] - s.oy, a[2] - s.oz, Ai, Aj, Ak);
  comps(s, b[0] - s.ox, b[1] - s.oy, b[2] - s.oz, Bi, Bj, Bk);
  comps(s, c[0] - s.ox, c[1] - s.oy, c[2] - s.oz, Ci, Cj, Ck);
  float Ax = Ai - s.sx * Ak;
  float Ay = Aj - s.sy * Ak;
  float Bx = Bi - s.sx * Bk;
  float By = Bj - s.sy * Bk;
  float Cx = Ci - s.sx * Ck;
  float Cy = Cj - s.sy * Ck;
  float U = Cx * By - Cy * Bx;
  float V = Ax * Cy - Ay * Cx;
  float W = Bx * Ay - By * Ax;
  float errAx = fabsf(Ai) + fabsf(s.sx * Ak);
  float errAy = fabsf(Aj) + fabsf(s.sy * Ak);
  float errBx = fabsf(Bi) + fabsf(s.sx * Bk);
  float errBy = fabsf(Bj) + fabsf(s.sy * Bk);
  float errCx = fabsf(Ci) + fabsf(s.sx * Ck);
  float errCy = fabsf(Cj) + fabsf(s.sy * Ck);
  float eU = E * (((errCx * fabsf(By) + fabsf(Cx) * errBy)
                   + errCy * fabsf(Bx)) + fabsf(Cy) * errBx);
  float eV = E * (((errAx * fabsf(Cy) + fabsf(Ax) * errCy)
                   + errAy * fabsf(Cx)) + fabsf(Ay) * errCx);
  float eW = E * (((errBx * fabsf(Ay) + fabsf(Bx) * errAy)
                   + errBy * fabsf(Ax)) + fabsf(By) * errAx);
  bool same = ((U >= -eU) && (V >= -eV) && (W >= -eW)) ||
              ((U <= eU) && (V <= eV) && (W <= eW));
  float det = (U + V) + W;
  bool det_ok = det != 0.0f;
  float inv_det = det_ok ? 1.0f / det : 0.0f;
  t = (s.sz * ((U * Ak + V * Bk) + W * Ck)) * inv_det;
  u = V * inv_det;
  v = W * inv_det;
  front = det > 0.0f;
  return same && det_ok && s.dk_ok && (t > t_min);
}

#define MB_STACK 64    // entries a thread may park (mesh_bvh_stack())
#define MB_THREADS 128  // threads a block

// The slab test of one box: hit when the ray's interval meets it at or
// before t_best (a tie survives); ``tnear`` its entry distance.
__device__ __forceinline__ bool slab(float4 lo, float4 hi, float ox, float oy,
                                     float oz, float ix, float iy, float iz,
                                     float t_best, float& tnear) {
  float t0x = (lo.x - ox) * ix, t1x = (hi.x - ox) * ix;
  float t0y = (lo.y - oy) * iy, t1y = (hi.y - oy) * iy;
  float t0z = (lo.z - oz) * iz, t1z = (hi.z - oz) * iz;
  tnear = maxp(maxp(minp(t0x, t1x), minp(t0y, t1y)), minp(t0z, t1z));
  float tfar = minp(minp(maxp(t0x, t1x), maxp(t0y, t1y)), maxp(t0z, t1z));
  return (tfar >= maxp(tnear, 0.0f)) && (tnear <= t_best);
}

// Take the nearest parked box not beyond t_best into (ref, count), dropping
// those beyond it; false when the stack runs out (the walk ends).
__device__ __forceinline__ bool pop(const int* stack_ref,
                                    const int* stack_count,
                                    const float* stack_t, int& sp,
                                    float t_best, int& ref, int& count) {
  while (sp > 0) {
    --sp;
    if (stack_t[sp] <= t_best) {
      ref = stack_ref[sp];
      count = stack_count[sp];
      return true;
    }
  }
  return false;
}

__global__ void __launch_bounds__(MB_THREADS)
winner_kernel(const float* __restrict__ o_in, const float* __restrict__ d_in,
              const float* __restrict__ tmin_in,
              const float* __restrict__ tmax_in, int N,
              const float4* __restrict__ nodes,
              const float4* __restrict__ tris, float* __restrict__ t_out,
              int* __restrict__ tri_out, float* __restrict__ u_out,
              float* __restrict__ v_out, int* __restrict__ front_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float ox = o_in[3 * i], oy = o_in[3 * i + 1], oz = o_in[3 * i + 2];
  float dx = d_in[3 * i], dy = d_in[3 * i + 1], dz = d_in[3 * i + 2];
  float t_min = tmin_in[i];
  float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  Setup s = woop_setup(ox, oy, oz, dx, dy, dz);
  float t_best = tmax_in ? tmax_in[i] : INFINITY;
  int tri_best = -1;
  float u_best = 0.0f, v_best = 0.0f;
  bool front_best = false;
  int stack_ref[MB_STACK], stack_count[MB_STACK];
  float stack_t[MB_STACK];
  int sp = 0;
  float4 lo = __ldg(nodes), hi = __ldg(nodes + 1);
  float tnear;
  bool walking = slab(lo, hi, ox, oy, oz, ix, iy, iz, t_best, tnear);
  int ref = __float_as_int(lo.w), count = __float_as_int(hi.w);
  // While-while (Aila & Laine, HPG 2009): a lane descends until it holds a
  // leaf or its walk ends, and the warp's lanes then test their leaves
  // together, so a warp does not alternate node steps and triangle tests
  // lane by lane.
  while (walking) {
    while (ref > 0) {
      const float4* row = nodes + 4 * ref;
      float4 lo0 = __ldg(row), hi0 = __ldg(row + 1);
      float4 lo1 = __ldg(row + 2), hi1 = __ldg(row + 3);
      float t0, t1;
      bool h0 = slab(lo0, hi0, ox, oy, oz, ix, iy, iz, t_best, t0);
      bool h1 = slab(lo1, hi1, ox, oy, oz, ix, iy, iz, t_best, t1);
      if (h0 && h1) {
        bool second = t1 < t0;  // the nearer first; child 0 on a tie
        stack_ref[sp] = __float_as_int(second ? lo0.w : lo1.w);
        stack_count[sp] = __float_as_int(second ? hi0.w : hi1.w);
        stack_t[sp] = second ? t0 : t1;
        ++sp;
        ref = __float_as_int(second ? lo1.w : lo0.w);
        count = __float_as_int(second ? hi1.w : hi0.w);
      } else if (h0 || h1) {
        ref = __float_as_int(h0 ? lo0.w : lo1.w);
        count = __float_as_int(h0 ? hi0.w : hi1.w);
      } else if (!pop(stack_ref, stack_count, stack_t, sp, t_best, ref,
                      count)) {
        walking = false;
        break;
      }
    }
    if (!walking) break;
    int first = ~ref;
    for (int k = 0; k < count; ++k) {
      int id = first + k;
      const float4* rec = tris + 3 * id;
      float4 A = __ldg(rec), B = __ldg(rec + 1), C = __ldg(rec + 2);
      float a[3] = {A.x, A.y, A.z}, b[3] = {B.x, B.y, B.z};
      float c[3] = {C.x, C.y, C.z};
      float t, u, v;
      bool front;
      bool valid = woop_tri_test(s, a, b, c, t_min, t, u, v, front);
      if (valid && (t < t_best || (t == t_best && id < tri_best))) {
        t_best = t;
        tri_best = id;
        u_best = u;
        v_best = v;
        front_best = front;
      }
    }
    walking = pop(stack_ref, stack_count, stack_t, sp, t_best, ref, count);
  }
  t_out[i] = tri_best >= 0 ? t_best : INFINITY;
  tri_out[i] = tri_best;
  u_out[i] = u_best;
  v_out[i] = v_best;
  front_out[i] = front_best ? 1 : 0;
}

}  // namespace mb

extern "C" {

// Launches on ``stream``; returns the CUDA error of the launch (0 = queued).
// ``t_max`` may be NULL (no upper limit); ``nodes`` and ``tris`` are the
// records of tracer/mesh_bvh.py ``pack_mesh_records``.
int mesh_bvh_winner(const float* o, const float* d, const float* t_min,
                    const float* t_max, int N, const float* nodes,
                    const float* tris, float* t_out, int* tri_out,
                    float* u_out, float* v_out, int* front_out,
                    void* stream) {
  if (N <= 0) return 0;
  int blocks = (N + MB_THREADS - 1) / MB_THREADS;
  mb::winner_kernel<<<blocks, MB_THREADS, 0, (cudaStream_t)stream>>>(
      o, d, t_min, t_max, N, (const float4*)nodes, (const float4*)tris,
      t_out, tri_out, u_out, v_out, front_out);
  return (int)cudaGetLastError();
}

// The depth of the per-thread stack: the wrapper refuses to load a library
// whose stack differs from the depth its packer checks trees against.
int mesh_bvh_stack() { return MB_STACK; }

}  // extern "C"
