// The two fused adjoint kernels and their plain C interface (loaded with
// ctypes by tracer/fused.py; built by nvcc for sm_90a, one library per bin
// count: -DSRC_BINS=<B>). A translation unit of its own, so that it builds
// beside the forward library and never moves the forward kernels' code.
//
// fused_bounce_bwd replaces the per-bounce backward Pallas kernel of the JAX
// package (source_tpu/tracer/pallas_fused.py, _bounce_bwd_call -> _bwd_kernel);
// fused_span_bwd replaces its whole-span backward kernel (_span_bwd_call ->
// _span_bwd_kernel), with both of its uniform sources: uniforms read from
// device memory, or regenerated in the kernel (the TPU kernel's _gen_u
// branch) by the forward span kernel's Philox (philox.cuh) from the same
// seed, so the replay draws what the forward drew. The TPU kernels take
// jax.vjp of the bounce inside the kernel; here the reverse pass is written
// out (fused_adjoint.cuh).
//
// Layout: one thread per ray, SoA [C, N] as the forward kernels. The scene
// table and the descriptor are copied to shared memory, and beside them one
// f32[tab_size] accumulator of the table cotangent per block, added to with
// shared-memory atomics. Each block writes its accumulator to its own row of
// ``gtab_parts`` [blocks, tab_size]; the wrapper sums the rows. (The TPU
// kernels return per-tile partials of only the table entries the bounce reads;
// a full-size row per block needs no such map.)
//
// What bounds them on an H100: by the roofline, bytes, like the forward
// kernels. fused_bounce_bwd reads the entry state, the uniforms, the bitfield
// and 6 + 2B cotangent rows and writes 6 + B; it recomputes the winner's side
// of the bounce and reverses it, two to three times the forward arithmetic of
// one leaf and one material, well under the card's operations per byte. What
// keeps the measured time above the bound is again latency and divergence
// (each lane reverses its own leaf type and material), local-memory traffic
// (thr, the three cotangent rows of B floats and the bounce's intermediates do
// not fit the register file at B = 15), and the shared atomics, which
// serialise where the lanes of a warp hit the same leaf or material.
// fused_span_bwd keeps the cotangents in registers across the span and moves
// per bounce only the uniforms, the bitfield and the saved entry state (8 + B
// floats written in phase 1, read back in phase 2), in global memory where the
// TPU kernel had VMEM scratch; with the kernel RNG not the uniforms, which
// both phases draw again (about 300 integer operations each). Making them
// fast is later work.
#include "fused_adjoint.cuh"
#include "philox.cuh"

namespace {

constexpr int THREADS = 128;

// tab | desc | table cotangent accumulator
__device__ __forceinline__ float* load_tables(float* smem, int** s_desc,
                                              const float* tab, int n_tab,
                                              const int* desc, int n_desc) {
  float* s_tab = smem;
  *s_desc = reinterpret_cast<int*>(smem + n_tab);
  float* s_gtab = smem + n_tab + n_desc;
  for (int k = threadIdx.x; k < n_tab; k += blockDim.x) {
    s_tab[k] = tab[k];
    s_gtab[k] = 0.0f;
  }
  for (int k = threadIdx.x; k < n_desc; k += blockDim.x) (*s_desc)[k] = desc[k];
  __syncthreads();
  return s_gtab;
}

__device__ __forceinline__ void store_parts(float* parts, const float* s_gtab,
                                            int n_tab) {
  __syncthreads();
  float* row = parts + (size_t)blockIdx.x * n_tab;
  for (int k = threadIdx.x; k < n_tab; k += blockDim.x) row[k] = s_gtab[k];
}

__device__ __forceinline__ fb::V3 load3(const float* p, int i, int N) {
  return fb::V3{p[i], p[N + i], p[2 * (size_t)N + i]};
}
__device__ __forceinline__ void store3(float* p, int i, int N, fb::V3 v) {
  p[i] = v.x;
  p[N + i] = v.y;
  p[2 * (size_t)N + i] = v.z;
}

// The adjoint of one bounce for every ray. A ray whose bitfield is 0 took no
// part in the bounce: its cotangents pass through.
__global__ void __launch_bounds__(THREADS)
k_bounce_bwd(const float* __restrict__ tab, int n_tab,
             const int* __restrict__ desc, int n_desc,
             const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ thr, const float* __restrict__ aux,
             const float* __restrict__ u, const int* __restrict__ bits,
             const float* __restrict__ go, const float* __restrict__ gd,
             const float* __restrict__ gthr, const float* __restrict__ grad,
             float* __restrict__ go2, float* __restrict__ gd2,
             float* __restrict__ gthr2, float* __restrict__ parts, int N,
             fb::Cfg cfg) {
  extern __shared__ float smem[];
  int* s_desc;
  float* s_gtab = load_tables(smem, &s_desc, tab, n_tab, desc, n_desc);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N) {
    fb::V3 g_o = load3(go, i, N), g_d = load3(gd, i, N);
    float g_thr[fb::NB];
#pragma unroll
    for (int b = 0; b < fb::NB; ++b) g_thr[b] = gthr[(size_t)b * N + i];
    int bf = bits[i];
    if (bf != 0) {
      float t_in[fb::NB], g_rad[fb::NB], uu[fb::N_UNIFORMS];
#pragma unroll
      for (int b = 0; b < fb::NB; ++b) {
        t_in[b] = thr[(size_t)b * N + i];
        g_rad[b] = grad[(size_t)b * N + i];
      }
#pragma unroll
      for (int k = 0; k < fb::N_UNIFORMS; ++k) uu[k] = u[(size_t)k * N + i];
      fb::bounce_bwd(smem, s_desc, cfg, load3(o, i, N), load3(d, i, N), t_in,
                     aux[N + i], uu, bf, g_o, g_d, g_thr, g_rad, s_gtab);
    }
    store3(go2, i, N, g_o);
    store3(gd2, i, N, g_d);
#pragma unroll
    for (int b = 0; b < fb::NB; ++b) gthr2[(size_t)b * N + i] = g_thr[b];
  }
  store_parts(parts, s_gtab, n_tab);
}

// The adjoint of a span of n_steps bounces. Phase 1 replays the span forward
// from its entry state with the forward kernels' own bounce (the same floats,
// bit for bit) and writes the entry state of every bounce the ray enters to
// ``scratch`` [n_steps, 8 + B, N]; phase 2 walks those bounces in reverse,
// chaining the per-bounce adjoint with the cotangents in registers. ``replay``
// (may be null) receives the state phase 1 ended in, [8 + B, N]. With KRNG
// the uniforms of bounce ``step`` are drawn as k_span_fwd<true> draws them,
// from (lane i, bounce start + step) under the key ``seed``, in both phases;
// ``u`` is not read.
template <bool KRNG>
__global__ void __launch_bounds__(THREADS)
k_span_bwd(const float* __restrict__ tab, int n_tab,
           const int* __restrict__ desc, int n_desc,
           const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ thr, const float* __restrict__ aux,
           const float* __restrict__ u, const int* __restrict__ seed,
           int start, const int* __restrict__ bits,
           const float* __restrict__ go, const float* __restrict__ gd,
           const float* __restrict__ gthr, const float* __restrict__ grad,
           float* __restrict__ go2, float* __restrict__ gd2,
           float* __restrict__ gthr2, float* __restrict__ parts,
           float* __restrict__ scratch, float* __restrict__ replay, int N,
           int n_steps, fb::Cfg cfg) {
  constexpr int SR = 8 + fb::NB;  // saved rows: o(3) d(3) thr(B) alive depth
  extern __shared__ float smem[];
  int* s_desc;
  float* s_gtab = load_tables(smem, &s_desc, tab, n_tab, desc, n_desc);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N) {
    uint32_t k0 = 0u, k1 = 0u;
    if constexpr (KRNG) {
      k0 = (uint32_t)seed[0];
      k1 = (uint32_t)seed[1];
    }
    // the uniforms of bounce ``step`` of the span
    auto draw = [&](int step, float* uu) {
      if constexpr (KRNG) {
        fb::philox_uniforms((uint32_t)i, (uint32_t)(start + step), k0, k1, uu);
      } else {
        const float* us = u + (size_t)step * fb::N_UNIFORMS * N;
#pragma unroll
        for (int k = 0; k < fb::N_UNIFORMS; ++k) uu[k] = us[(size_t)k * N + i];
      }
    };
    // --- phase 1: forward replay, saving entry states ---------------------------
    int entered = 0;
    {
      fb::Ray ray;
      ray.o = load3(o, i, N);
      ray.d = load3(d, i, N);
#pragma unroll
      for (int b = 0; b < fb::NB; ++b) {
        ray.thr[b] = thr[(size_t)b * N + i];
        ray.rad[b] = 0.0f;
      }
      ray.alive = aux[i];
      ray.depth = aux[N + i];
      for (int step = 0; step < n_steps && ray.alive > 0.5f; ++step) {
        float* row = scratch + (size_t)step * SR * N + i;
        row[0] = ray.o.x;
        row[(size_t)N] = ray.o.y;
        row[2 * (size_t)N] = ray.o.z;
        row[3 * (size_t)N] = ray.d.x;
        row[4 * (size_t)N] = ray.d.y;
        row[5 * (size_t)N] = ray.d.z;
#pragma unroll
        for (int b = 0; b < fb::NB; ++b) row[(6 + b) * (size_t)N] = ray.thr[b];
        row[(6 + fb::NB) * (size_t)N] = ray.alive;
        row[(7 + fb::NB) * (size_t)N] = ray.depth;
        float uu[fb::N_UNIFORMS];
        draw(step, uu);
        fb::bounce(smem, s_desc, cfg, ray, uu);
        entered = step + 1;
      }
      if (replay != nullptr) {
        float* row = replay + i;
        row[0] = ray.o.x;
        row[(size_t)N] = ray.o.y;
        row[2 * (size_t)N] = ray.o.z;
        row[3 * (size_t)N] = ray.d.x;
        row[4 * (size_t)N] = ray.d.y;
        row[5 * (size_t)N] = ray.d.z;
#pragma unroll
        for (int b = 0; b < fb::NB; ++b) row[(6 + b) * (size_t)N] = ray.thr[b];
        row[(6 + fb::NB) * (size_t)N] = ray.alive;
        row[(7 + fb::NB) * (size_t)N] = ray.depth;
      }
    }
    // --- phase 2: the adjoints in reverse ----------------------------------------
    fb::V3 g_o = load3(go, i, N), g_d = load3(gd, i, N);
    float g_thr[fb::NB], g_rad[fb::NB];
#pragma unroll
    for (int b = 0; b < fb::NB; ++b) {
      g_thr[b] = gthr[(size_t)b * N + i];
      g_rad[b] = grad[(size_t)b * N + i];
    }
    for (int step = entered - 1; step >= 0; --step) {
      int bf = bits[(size_t)step * N + i];
      if (bf == 0) continue;  // stopped by the roulette: an identity
      const float* row = scratch + (size_t)step * SR * N + i;
      float t_in[fb::NB], uu[fb::N_UNIFORMS];
#pragma unroll
      for (int b = 0; b < fb::NB; ++b) t_in[b] = row[(6 + b) * (size_t)N];
      draw(step, uu);
      fb::bounce_bwd(smem, s_desc, cfg,
                     fb::V3{row[0], row[(size_t)N], row[2 * (size_t)N]},
                     fb::V3{row[3 * (size_t)N], row[4 * (size_t)N],
                            row[5 * (size_t)N]},
                     t_in, row[(7 + fb::NB) * (size_t)N], uu, bf, g_o, g_d,
                     g_thr, g_rad, s_gtab);
    }
    store3(go2, i, N, g_o);
    store3(gd2, i, N, g_d);
#pragma unroll
    for (int b = 0; b < fb::NB; ++b) gthr2[(size_t)b * N + i] = g_thr[b];
  }
  store_parts(parts, s_gtab, n_tab);
}

size_t smem_bytes(int n_tab, int n_desc) {
  return sizeof(float) * 2 * (size_t)n_tab + sizeof(int) * (size_t)n_desc;
}

}  // namespace

// Blocks a launch over N rays uses: the rows of ``gtab_parts``.
extern "C" int fused_bwd_blocks(int N) { return (N + THREADS - 1) / THREADS; }

// Both return the cudaError_t of the launch (0 on success); nothing
// synchronises. A table too large for 48 KB of shared memory (twice the
// table plus the descriptor) is refused with cudaErrorInvalidValue.
extern "C" int fused_bounce_bwd(
    const float* tab, int n_tab, const int* desc, int n_desc, const float* o,
    const float* d, const float* thr, const float* aux, const float* u,
    const int* bits, const float* go, const float* gd, const float* gthr,
    const float* grad, float* go2, float* gd2, float* gthr2, float* parts,
    int N, int max_depth, int ext_min_depth, float p_ext, float survive,
    float w_imp, float one_m_w_imp, float max_distance, void* stream) {
  if (N <= 0) return 0;
  size_t smem = smem_bytes(n_tab, n_desc);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  fb::Cfg cfg{max_depth, ext_min_depth, p_ext, survive, w_imp, one_m_w_imp,
              max_distance};
  k_bounce_bwd<<<fused_bwd_blocks(N), THREADS, smem, (cudaStream_t)stream>>>(
      tab, n_tab, desc, n_desc, o, d, thr, aux, u, bits, go, gd, gthr, grad,
      go2, gd2, gthr2, parts, N, cfg);
  return (int)cudaGetLastError();
}

// ``seed`` null: the uniforms ``u`` f32[n_steps, 10, N] are read; else
// ``seed`` is the i32[2] on the device that fused_span_fwd drew bounces
// start .. start + n_steps - 1 from (``u`` is not read).
extern "C" int fused_span_bwd(
    const float* tab, int n_tab, const int* desc, int n_desc, const float* o,
    const float* d, const float* thr, const float* aux, const float* u,
    const int* seed, int start, const int* bits, const float* go,
    const float* gd, const float* gthr, const float* grad, float* go2,
    float* gd2, float* gthr2, float* parts, float* scratch, float* replay,
    int N, int n_steps, int max_depth, int ext_min_depth, float p_ext,
    float survive, float w_imp, float one_m_w_imp, float max_distance,
    void* stream) {
  if (N <= 0) return 0;
  size_t smem = smem_bytes(n_tab, n_desc);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  fb::Cfg cfg{max_depth, ext_min_depth, p_ext, survive, w_imp, one_m_w_imp,
              max_distance};
  if (seed != nullptr) {
    k_span_bwd<true><<<fused_bwd_blocks(N), THREADS, smem,
                       (cudaStream_t)stream>>>(
        tab, n_tab, desc, n_desc, o, d, thr, aux, nullptr, seed, start, bits,
        go, gd, gthr, grad, go2, gd2, gthr2, parts, scratch, replay, N,
        n_steps, cfg);
  } else {
    k_span_bwd<false><<<fused_bwd_blocks(N), THREADS, smem,
                        (cudaStream_t)stream>>>(
        tab, n_tab, desc, n_desc, o, d, thr, aux, u, nullptr, 0, bits, go, gd,
        gthr, grad, go2, gd2, gthr2, parts, scratch, replay, N, n_steps, cfg);
  }
  return (int)cudaGetLastError();
}
