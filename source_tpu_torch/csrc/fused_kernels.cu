// The fused forward kernels and their plain C interface (loaded with ctypes
// by tracer/fused.py; built by nvcc for sm_90a, one library per bin count:
// -DSRC_BINS=<B>).
//
// fused_bounce_fwd replaces the per-bounce Pallas kernel of the JAX package
// (source_tpu/tracer/pallas_fused.py, _bounce_fwd_call -> _fwd_kernel);
// fused_span_fwd replaces its whole-span kernel (_span_fwd_call ->
// _span_fwd_kernel), with both of its uniform sources: uniforms read from
// device memory, or drawn in the kernel (the TPU kernel's _gen_u branch) by
// Philox4x32-10 (philox.cuh) from an i32[2] seed on the device.
// fused_bounce_replay and fused_bounce_io replace its two profiling variants
// of the per-bounce kernel (_bounce_replay_call -> _replay_kernel and
// _bounce_io_call -> _io_kernel, which benchmarks/fusedprof.py drives): the
// bounce with its decisions replayed from a bitfield, and the bounce's loads
// and stores with no arithmetic. Together with fused_bounce_fwd they split a
// bounce's time into its decision path, its arithmetic and its load/store and
// launch floor.
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
// With the kernel RNG it reads no uniforms at all and spends about 300
// integer operations a ray and a bounce on Philox instead (three calls of ten
// rounds), which moves the span's bound from bytes toward operations.
// Making the kernels fast is later work; they are written to be right first.
#include "fused_bounce.cuh"
#include "philox.cuh"

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

// n_steps bounces for every ray, state in registers. With KRNG false, u is
// f32[n_steps, 10, N]; with KRNG true the uniforms of bounce ``step`` are
// Philox's for (lane i, bounce start + step) under the key ``seed`` (i32[2]
// on the device, read by every thread: no host sync for the seed), drawn in
// registers, and u is not read. bits is i32[n_steps, N], zero-filled by the
// caller: only the bounces a ray enters alive are written.
template <bool KRNG>
__global__ void __launch_bounds__(THREADS)
k_span_fwd(const float* __restrict__ tab, int n_tab,
           const int* __restrict__ desc, int n_desc,
           const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ thr, const float* __restrict__ rad,
           const float* __restrict__ aux, float* __restrict__ o2,
           float* __restrict__ d2, float* __restrict__ thr2,
           float* __restrict__ rad2, float* __restrict__ aux2,
           const float* __restrict__ u, const int* __restrict__ seed,
           int start, int* __restrict__ bits, int N, int n_steps,
           fb::Cfg cfg) {
  extern __shared__ float smem[];
  float* s_tab = smem;
  int* s_desc = reinterpret_cast<int*>(smem + n_tab);
  load_tables(s_tab, s_desc, tab, n_tab, desc, n_desc);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  fb::Ray ray;
  load_ray(ray, i, N, o, d, thr, rad, aux);
  uint32_t k0 = 0u, k1 = 0u;
  if constexpr (KRNG) {
    k0 = (uint32_t)seed[0];
    k1 = (uint32_t)seed[1];
  }
  for (int step = 0; step < n_steps && ray.alive > 0.5f; ++step) {
    float uu[fb::N_UNIFORMS];
    if constexpr (KRNG) {
      fb::philox_uniforms((uint32_t)i, (uint32_t)(start + step), k0, k1, uu);
    } else {
      const float* us = u + (size_t)step * fb::N_UNIFORMS * N;
#pragma unroll
      for (int k = 0; k < fb::N_UNIFORMS; ++k) uu[k] = us[(size_t)k * N + i];
    }
    bits[(size_t)step * N + i] = fb::bounce(s_tab, s_desc, cfg, ray, uu);
  }
  store_ray(ray, i, N, o2, d2, thr2, rad2, aux2);
}

// K1 with its decisions replayed from ``bits_in`` (i32[N], what
// fused_bounce_fwd returned for this state and these uniforms): the same
// launch, loads and stores, and the bounce's arithmetic without the code that
// decides (fb::bounce_as<REPLAY>). Its plain version is ``bounce_core`` with
// ``bits``. A ray that enters dead keeps its state, as in k_bounce_fwd; the
// TPU kernel evaluates such lanes too (with their bitfield 0, a result
// nothing reads), here they skip. Writes no bitfield.
__global__ void __launch_bounds__(THREADS)
k_bounce_replay(const float* __restrict__ tab, int n_tab,
                const int* __restrict__ desc, int n_desc,
                const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ thr, const float* __restrict__ rad,
                const float* __restrict__ aux, float* __restrict__ o2,
                float* __restrict__ d2, float* __restrict__ thr2,
                float* __restrict__ rad2, float* __restrict__ aux2,
                const float* __restrict__ u,
                const int* __restrict__ bits_in, int N, fb::Cfg cfg) {
  extern __shared__ float smem[];
  float* s_tab = smem;
  int* s_desc = reinterpret_cast<int*>(smem + n_tab);
  load_tables(s_tab, s_desc, tab, n_tab, desc, n_desc);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  fb::Ray ray;
  load_ray(ray, i, N, o, d, thr, rad, aux);
  if (ray.alive > 0.5f) {
    float uu[fb::N_UNIFORMS];
#pragma unroll
    for (int k = 0; k < fb::N_UNIFORMS; ++k) uu[k] = u[k * N + i];
    fb::bounce_as<fb::REPLAY>(s_tab, s_desc, cfg, ray, uu, bits_in[i]);
  }
  store_ray(ray, i, N, o2, d2, thr2, rad2, aux2);
}

// K1's loads and stores and nothing else: the table and descriptor copied to
// shared memory, the state and (for a ray alive on entry) the uniforms
// loaded, the state and a zero bitfield stored, as k_bounce_fwd does. Every
// store depends on every load of its thread through ``z = |s| * 0``, which
// the compiler cannot fold under IEEE arithmetic (s may be NaN or infinite;
// no fast math), and x - (+0) is x bit for bit, -0 included: the output state
// equals the input.
__global__ void __launch_bounds__(THREADS)
k_bounce_io(const float* __restrict__ tab, int n_tab,
            const int* __restrict__ desc, int n_desc,
            const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ thr, const float* __restrict__ rad,
            const float* __restrict__ aux, float* __restrict__ o2,
            float* __restrict__ d2, float* __restrict__ thr2,
            float* __restrict__ rad2, float* __restrict__ aux2,
            const float* __restrict__ u, int* __restrict__ bits, int N) {
  extern __shared__ float smem[];
  float* s_tab = smem;
  int* s_desc = reinterpret_cast<int*>(smem + n_tab);
  load_tables(s_tab, s_desc, tab, n_tab, desc, n_desc);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  fb::Ray ray;
  load_ray(ray, i, N, o, d, thr, rad, aux);
  float s = s_tab[0] + (float)s_desc[0];
  if (ray.alive > 0.5f) {
#pragma unroll
    for (int k = 0; k < fb::N_UNIFORMS; ++k) s = s + u[k * N + i];
  }
#pragma unroll
  for (int b = 0; b < fb::NB; ++b) s = s + ray.thr[b] + ray.rad[b];
  s = s + ray.o.x + ray.o.y + ray.o.z + ray.d.x + ray.d.y + ray.d.z +
      ray.alive + ray.depth;
  const float z = fabsf(s) * 0.0f;
  ray.o = fb::V3{ray.o.x - z, ray.o.y - z, ray.o.z - z};
  ray.d = fb::V3{ray.d.x - z, ray.d.y - z, ray.d.z - z};
#pragma unroll
  for (int b = 0; b < fb::NB; ++b) {
    ray.thr[b] = ray.thr[b] - z;
    ray.rad[b] = ray.rad[b] - z;
  }
  ray.alive = ray.alive - z;
  ray.depth = ray.depth - z;
  store_ray(ray, i, N, o2, d2, thr2, rad2, aux2);
  bits[i] = 0;
}

size_t smem_bytes(int n_tab, int n_desc) {
  return sizeof(float) * (size_t)n_tab + sizeof(int) * (size_t)n_desc;
}

}  // namespace

// Each returns the cudaError_t of the launch (0 on success); nothing
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

// ``seed`` null: the uniforms ``u`` f32[n_steps, 10, N] are read; else
// ``seed`` is an i32[2] on the device and the kernel draws the uniforms of
// bounces start .. start + n_steps - 1 itself (``u`` is not read).
extern "C" int fused_span_fwd(
    const float* tab, int n_tab, const int* desc, int n_desc, const float* o,
    const float* d, const float* thr, const float* rad, const float* aux,
    float* o2, float* d2, float* thr2, float* rad2, float* aux2, const float* u,
    const int* seed, int start, int* bits, int N, int n_steps, int max_depth,
    int ext_min_depth, float p_ext, float survive, float w_imp,
    float one_m_w_imp, float max_distance, void* stream) {
  if (N <= 0) return 0;
  size_t smem = smem_bytes(n_tab, n_desc);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  fb::Cfg cfg{max_depth, ext_min_depth, p_ext, survive, w_imp, one_m_w_imp,
              max_distance};
  int blocks = (N + THREADS - 1) / THREADS;
  if (seed != nullptr) {
    k_span_fwd<true><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        tab, n_tab, desc, n_desc, o, d, thr, rad, aux, o2, d2, thr2, rad2,
        aux2, nullptr, seed, start, bits, N, n_steps, cfg);
  } else {
    k_span_fwd<false><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        tab, n_tab, desc, n_desc, o, d, thr, rad, aux, o2, d2, thr2, rad2,
        aux2, u, nullptr, 0, bits, N, n_steps, cfg);
  }
  return (int)cudaGetLastError();
}

extern "C" int fused_bounce_replay(
    const float* tab, int n_tab, const int* desc, int n_desc, const float* o,
    const float* d, const float* thr, const float* rad, const float* aux,
    float* o2, float* d2, float* thr2, float* rad2, float* aux2, const float* u,
    const int* bits_in, int N, int max_depth, int ext_min_depth, float p_ext,
    float survive, float w_imp, float one_m_w_imp, float max_distance,
    void* stream) {
  if (N <= 0) return 0;
  size_t smem = smem_bytes(n_tab, n_desc);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  fb::Cfg cfg{max_depth, ext_min_depth, p_ext, survive, w_imp, one_m_w_imp,
              max_distance};
  int blocks = (N + THREADS - 1) / THREADS;
  k_bounce_replay<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      tab, n_tab, desc, n_desc, o, d, thr, rad, aux, o2, d2, thr2, rad2, aux2,
      u, bits_in, N, cfg);
  return (int)cudaGetLastError();
}

extern "C" int fused_bounce_io(
    const float* tab, int n_tab, const int* desc, int n_desc, const float* o,
    const float* d, const float* thr, const float* rad, const float* aux,
    float* o2, float* d2, float* thr2, float* rad2, float* aux2, const float* u,
    int* bits, int N, void* stream) {
  if (N <= 0) return 0;
  size_t smem = smem_bytes(n_tab, n_desc);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  int blocks = (N + THREADS - 1) / THREADS;
  k_bounce_io<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      tab, n_tab, desc, n_desc, o, d, thr, rad, aux, o2, d2, thr2, rad2, aux2,
      u, bits, N);
  return (int)cudaGetLastError();
}
