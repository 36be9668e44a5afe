// The two fused forward kernels and their plain C interface (loaded with
// ctypes by tracer/fused.py; built by nvcc for sm_90a, one library per bin
// count: -DSRC_BINS=<B>).
//
// fused_bounce_fwd replaces the per-bounce Pallas kernel of the JAX package
// (source_tpu/tracer/pallas_fused.py, _bounce_fwd_call -> _fwd_kernel);
// fused_span_fwd replaces its whole-span kernel (_span_fwd_call ->
// _span_fwd_kernel).
//
// Layout: one thread per ray, SoA state (o[3,N] d[3,N] thr[B,N] rad[B,N]
// aux[2,N], one ray per column) so a warp's loads and stores are contiguous.
// The scene table (a few hundred floats) and the int32 descriptor of the spec
// are copied to shared memory once per block; the kernels are data-driven and
// serve every scene of the fused class without recompiling.
//
// What bounds them on an H100: by the roofline, bytes. A bounce moves about
// (2 * (8 + 2B) + 11) * 4 bytes per ray and spends on the order of a thousand
// f32 operations on it, a few operations per byte where the card balances at
// about twenty. What keeps the measured time above that bound is latency, not
// throughput: divides, square roots and branches that diverge within a warp
// (each lane has its own winner leaf and material), at about 120 registers a
// thread (thr, rad and the bounce's radiance increment are 3B floats), which
// holds occupancy down. The design answers the bytes: the span kernel keeps
// the ray state in registers across the bounces of a span, so per bounce it
// reads only the 10 uniforms and writes one bitfield; a ray that dies leaves
// the loop, and the wrapper zero-fills the bitfields it no longer writes.
// Making the kernels fast is later work; they are written to be right first.
#include "fused_bounce.cuh"

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ void load_tables(float* s_tab, int* s_desc,
                                            const float* tab, int n_tab,
                                            const int* desc, int n_desc) {
  for (int k = threadIdx.x; k < n_tab; k += blockDim.x) s_tab[k] = tab[k];
  for (int k = threadIdx.x; k < n_desc; k += blockDim.x) s_desc[k] = desc[k];
  __syncthreads();
}

__device__ __forceinline__ void load_ray(fb::Ray& r, int i, int N,
                                         const float* o, const float* d,
                                         const float* thr, const float* rad,
                                         const float* aux) {
  r.o = fb::V3{o[i], o[N + i], o[2 * N + i]};
  r.d = fb::V3{d[i], d[N + i], d[2 * N + i]};
#pragma unroll
  for (int b = 0; b < fb::NB; ++b) {
    r.thr[b] = thr[b * N + i];
    r.rad[b] = rad[b * N + i];
  }
  r.alive = aux[i];
  r.depth = aux[N + i];
}

__device__ __forceinline__ void store_ray(const fb::Ray& r, int i, int N,
                                          float* o, float* d, float* thr,
                                          float* rad, float* aux) {
  o[i] = r.o.x;
  o[N + i] = r.o.y;
  o[2 * N + i] = r.o.z;
  d[i] = r.d.x;
  d[N + i] = r.d.y;
  d[2 * N + i] = r.d.z;
#pragma unroll
  for (int b = 0; b < fb::NB; ++b) {
    thr[b * N + i] = r.thr[b];
    rad[b * N + i] = r.rad[b];
  }
  aux[i] = r.alive;
  aux[N + i] = r.depth;
}

// One bounce for every ray. u is f32[10, N]; bits is i32[N].
__global__ void __launch_bounds__(THREADS)
k_bounce_fwd(const float* __restrict__ tab, int n_tab,
             const int* __restrict__ desc, int n_desc,
             const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ thr, const float* __restrict__ rad,
             const float* __restrict__ aux, float* __restrict__ o2,
             float* __restrict__ d2, float* __restrict__ thr2,
             float* __restrict__ rad2, float* __restrict__ aux2,
             const float* __restrict__ u, int* __restrict__ bits, int N,
             fb::Cfg cfg) {
  extern __shared__ float smem[];
  float* s_tab = smem;
  int* s_desc = reinterpret_cast<int*>(smem + n_tab);
  load_tables(s_tab, s_desc, tab, n_tab, desc, n_desc);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  fb::Ray ray;
  load_ray(ray, i, N, o, d, thr, rad, aux);
  int bf = 0;
  if (ray.alive > 0.5f) {
    float uu[fb::N_UNIFORMS];
#pragma unroll
    for (int k = 0; k < fb::N_UNIFORMS; ++k) uu[k] = u[k * N + i];
    bf = fb::bounce(s_tab, s_desc, cfg, ray, uu);
  }
  store_ray(ray, i, N, o2, d2, thr2, rad2, aux2);
  bits[i] = bf;
}

// n_steps bounces for every ray, state in registers. u is
// f32[n_steps, 10, N]; bits is i32[n_steps, N], zero-filled by the caller:
// only the bounces a ray enters alive are written.
__global__ void __launch_bounds__(THREADS)
k_span_fwd(const float* __restrict__ tab, int n_tab,
           const int* __restrict__ desc, int n_desc,
           const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ thr, const float* __restrict__ rad,
           const float* __restrict__ aux, float* __restrict__ o2,
           float* __restrict__ d2, float* __restrict__ thr2,
           float* __restrict__ rad2, float* __restrict__ aux2,
           const float* __restrict__ u, int* __restrict__ bits, int N,
           int n_steps, fb::Cfg cfg) {
  extern __shared__ float smem[];
  float* s_tab = smem;
  int* s_desc = reinterpret_cast<int*>(smem + n_tab);
  load_tables(s_tab, s_desc, tab, n_tab, desc, n_desc);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  fb::Ray ray;
  load_ray(ray, i, N, o, d, thr, rad, aux);
  for (int step = 0; step < n_steps && ray.alive > 0.5f; ++step) {
    const float* us = u + (size_t)step * fb::N_UNIFORMS * N;
    float uu[fb::N_UNIFORMS];
#pragma unroll
    for (int k = 0; k < fb::N_UNIFORMS; ++k) uu[k] = us[(size_t)k * N + i];
    bits[(size_t)step * N + i] = fb::bounce(s_tab, s_desc, cfg, ray, uu);
  }
  store_ray(ray, i, N, o2, d2, thr2, rad2, aux2);
}

size_t smem_bytes(int n_tab, int n_desc) {
  return sizeof(float) * (size_t)n_tab + sizeof(int) * (size_t)n_desc;
}

}  // namespace

// Both return the cudaError_t of the launch (0 on success); nothing
// synchronises. 48 KB of shared memory hold every scene of the fused class
// (48 leaves and 48 materials at 15 bins are under 12 KB); a larger table is
// refused with cudaErrorInvalidValue.
extern "C" int fused_bounce_fwd(
    const float* tab, int n_tab, const int* desc, int n_desc, const float* o,
    const float* d, const float* thr, const float* rad, const float* aux,
    float* o2, float* d2, float* thr2, float* rad2, float* aux2, const float* u,
    int* bits, int N, int max_depth, int ext_min_depth, float p_ext,
    float survive, float w_imp, float one_m_w_imp, float max_distance,
    void* stream) {
  if (N <= 0) return 0;
  size_t smem = smem_bytes(n_tab, n_desc);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  fb::Cfg cfg{max_depth, ext_min_depth, p_ext, survive, w_imp, one_m_w_imp,
              max_distance};
  int blocks = (N + THREADS - 1) / THREADS;
  k_bounce_fwd<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      tab, n_tab, desc, n_desc, o, d, thr, rad, aux, o2, d2, thr2, rad2, aux2,
      u, bits, N, cfg);
  return (int)cudaGetLastError();
}

extern "C" int fused_span_fwd(
    const float* tab, int n_tab, const int* desc, int n_desc, const float* o,
    const float* d, const float* thr, const float* rad, const float* aux,
    float* o2, float* d2, float* thr2, float* rad2, float* aux2, const float* u,
    int* bits, int N, int n_steps, int max_depth, int ext_min_depth,
    float p_ext, float survive, float w_imp, float one_m_w_imp,
    float max_distance, void* stream) {
  if (N <= 0) return 0;
  size_t smem = smem_bytes(n_tab, n_desc);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  fb::Cfg cfg{max_depth, ext_min_depth, p_ext, survive, w_imp, one_m_w_imp,
              max_distance};
  int blocks = (N + THREADS - 1) / THREADS;
  k_span_fwd<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      tab, n_tab, desc, n_desc, o, d, thr, rad, aux, o2, d2, thr2, rad2, aux2,
      u, bits, N, n_steps, cfg);
  return (int)cudaGetLastError();
}
