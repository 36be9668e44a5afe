// Nearest triangle hit on one mesh's threaded BVH, one ray per thread.
//
// Replaces two TPU kernels of the JAX package, which compute the same
// function: source_tpu/tracer/pallas_mesh.py:192 ``_kernel`` (K7, called
// through ``_run_traversal``, a mesh whose packed tables fit the TPU's VMEM)
// and :369 ``_paged_kernel`` (K8, a larger mesh cut into pages with private
// BVHs, rays sorted by page, a running winner across the page axis). Paging
// exists because the tables do not fit VMEM; on this card a 1.31M-triangle
// mesh (tens of MB of tables) sits in device memory and largely in the 50 MB
// L2, so both are this one walk over one BVH. Its plain PyTorch version, and
// the specification, is ``mesh_intersect_plain`` in tracer/meshtrace.py; the
// tables are those of ``MeshData.to_tables``:
//
//   vertices  f32[V,3]   local frame
//   triangles i32[T,3]   in BVH leaf order
//   node_lo, node_hi f32[NN,3]; node_skip, node_first, node_count i32[NN]
//
// Design. Each thread walks the tree alone along the skip pointers: it
// descends to node+1 where its slab test hits an inner node, else escapes to
// skip[node]; the slab test prunes on t_near < t_best. A leaf's triangles are
// tested in order k = 0..count-1 with the strict t < t_best, in the
// reference's node order (no nearest-child-first reordering), so the winner
// of a tie is the reference's. The Woop setup is computed once per ray. The
// reciprocal rule is the reference traversal's: |d| > 1e-12 ? 1/d : 3e38
// with the sign dropped, so parked lanes (origin 3e7) fail the root slab.
// The tables are read through the read-only cache (``__ldg``).
//
// Built with -fmad=false and no fast math (NVCC_FLAGS in tracer/fused.py):
// the Woop test's forward-error-bound accept decides rays aimed at edges and
// vertices, and a contracted multiply-add or a reordered sum would move such
// lanes across an edge. Every sum keeps the association of
// tracer/watertight.py and every division is a true division.
//
// What bounds it on this card: operations and divergence, not bytes. A ray
// reads 7 floats and writes 5 words; each visited node costs a slab test
// (about 26 f32 operations) and each tested triangle a Woop test (about 110).
// Camera rays walk similar node paths in neighbouring threads; incoherent
// bounce rays do not, and the divergence of their walks is the known limit,
// left to a later change: a coherence sort of the rays before the launch
// costs more than it saves on this card (PERF.md, Findings).

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

__device__ __forceinline__ void vertex(const float* __restrict__ verts, int id,
                                       float* out) {
  out[0] = __ldg(verts + 3 * id);
  out[1] = __ldg(verts + 3 * id + 1);
  out[2] = __ldg(verts + 3 * id + 2);
}

__global__ void __launch_bounds__(256)
winner_kernel(const float* __restrict__ o_in, const float* __restrict__ d_in,
              const float* __restrict__ tmin_in,
              const float* __restrict__ tmax_in, int N,
              const float* __restrict__ verts, const int* __restrict__ tris,
              const float* __restrict__ node_lo,
              const float* __restrict__ node_hi,
              const int* __restrict__ node_skip,
              const int* __restrict__ node_first,
              const int* __restrict__ node_count, int n_nodes,
              float* __restrict__ t_out, int* __restrict__ tri_out,
              float* __restrict__ u_out, float* __restrict__ v_out,
              int* __restrict__ front_out) {
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
  int node = 0;
  while (node < n_nodes) {
    const float* lo = node_lo + 3 * node;
    const float* hi = node_hi + 3 * node;
    float t0x = (__ldg(lo) - ox) * ix, t1x = (__ldg(hi) - ox) * ix;
    float t0y = (__ldg(lo + 1) - oy) * iy, t1y = (__ldg(hi + 1) - oy) * iy;
    float t0z = (__ldg(lo + 2) - oz) * iz, t1z = (__ldg(hi + 2) - oz) * iz;
    float tnear = maxp(maxp(minp(t0x, t1x), minp(t0y, t1y)), minp(t0z, t1z));
    float tfar = minp(minp(maxp(t0x, t1x), maxp(t0y, t1y)), maxp(t0z, t1z));
    bool hit = (tfar >= maxp(tnear, 0.0f)) && (tnear < t_best);
    int count = __ldg(node_count + node);
    if (hit && count > 0) {
      int first = __ldg(node_first + node);
      for (int k = 0; k < count; ++k) {
        int id = first + k;
        float a[3], b[3], c[3];
        vertex(verts, __ldg(tris + 3 * id), a);
        vertex(verts, __ldg(tris + 3 * id + 1), b);
        vertex(verts, __ldg(tris + 3 * id + 2), c);
        float t, u, v;
        bool front;
        bool valid = woop_tri_test(s, a, b, c, t_min, t, u, v, front);
        if (valid && t < t_best) {
          t_best = t;
          tri_best = id;
          u_best = u;
          v_best = v;
          front_best = front;
        }
      }
    }
    node = (hit && count == 0) ? node + 1 : __ldg(node_skip + node);
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
// ``t_max`` may be NULL (no upper limit).
int mesh_bvh_winner(const float* o, const float* d, const float* t_min,
                    const float* t_max, int N, const float* verts,
                    const int* tris, const float* node_lo, const float* node_hi,
                    const int* node_skip, const int* node_first,
                    const int* node_count, int n_nodes, float* t_out,
                    int* tri_out, float* u_out, float* v_out, int* front_out,
                    void* stream) {
  if (N <= 0) return 0;
  const int threads = 256;
  int blocks = (N + threads - 1) / threads;
  mb::winner_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      o, d, t_min, t_max, N, verts, tris, node_lo, node_hi, node_skip,
      node_first, node_count, n_nodes, t_out, tri_out, u_out, v_out,
      front_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
