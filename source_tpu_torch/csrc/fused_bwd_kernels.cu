// The two fused adjoint kernels, the binning pass that schedules the first,
// and their plain C interface (loaded with ctypes by tracer/fused.py; built
// by nvcc for sm_90a, one library per bin count: -DSRC_BINS=<B>). A
// translation unit of its own, so that it builds beside the forward library
// and never moves the forward kernels' code.
//
// fused_bounce_bwd replaces the per-bounce backward Pallas kernel of the JAX
// package (source_tpu/tracer/pallas_fused.py, _bounce_bwd_call -> _bwd_kernel);
// fused_span_bwd replaces its whole-span backward kernel (_span_bwd_call ->
// _span_bwd_kernel), with both of its uniform sources: uniforms read from
// device memory, or regenerated in the kernel (the TPU kernel's _gen_u
// branch) by the forward span kernel's Philox (philox.cuh) from the same
// seed, so the replay draws what the forward drew. The TPU kernels take
// jax.vjp of the bounce inside the kernel; here the reverse pass is written
// out (fused_adjoint.cuh). adjoint_bin has no TPU counterpart: it is the
// schedule of fused_bounce_bwd.
//
// What bounds them on an H100. By the roofline, bytes: a lane reads its
// entry state, uniforms, bitfield and 6 + 2B cotangent rows and writes 6 + B,
// and reverses one leaf and one material, two to three times the forward
// arithmetic of one bounce, well under the card's operations per byte. What
// held the first versions (one thread per lane, in lane order) 15-440x above
// that bound was the schedule: after the second bounce a warp's lanes sit on
// different leaves and materials and some are dead, so a warp ran every code
// path of its lanes one after the other (the switches on leaf type in
// hit_local_adj and on material in bounce_bwd); the whole-span kernel
// walked a different bounce in every lane at once; and the table cotangent
// was summed with one shared-memory atomic per lane and entry, which the
// hardware serialises where the lanes of a warp add to one address.
//
// What this design does about it:
// - A code-path key per lane (adjoint_key): 0 for a miss, else the winner
//   leaf (which fixes its solid's type and its material's type) and the
//   stored choices that steer the reverse pass (transmit, TIR, light pick,
//   exiting, checker parity). A lane whose bitfield is 0 has no key.
// - fused_bounce_bwd runs over the live lanes sorted by key: adjoint_bin is a
//   stable counting sort (counts per warp segment, a scan per key, a
//   scatter) that writes the permutation and the live count, which stays on
//   the device: the grid still covers N lanes and blocks past the count only
//   copy the dead lanes' cotangents through. Thread t reverses lane perm[t],
//   gathering its state and scattering its cotangents back.
// - fused_span_bwd walks the span step-aligned, with the lanes regrouped at
//   every step. It is ONE persistent cooperative launch (as many blocks as
//   fit the SMs; grid-wide barriers between its stages): phase 1 replays the
//   span per lane (the forward kernels' own bounce, bit for bit), saves every
//   entered bounce's entry state and counts each step's keys; one block per
//   step scans its histogram; a scatter writes each step's live lanes sorted
//   by key (order within a key left to the atomics: only the table's
//   summation order depends on it); phase 2 then reverses step n_steps - 1 ..
//   0, each step's live lanes dense across the whole grid. This packs the
//   late bounces, when a tenth of the lanes is alive, into full warps over
//   the whole card, which a block-local sort (the other design) cannot: a
//   block of 128 lanes holds a dozen live lanes there, on a few keys. The
//   entry states, the staged cotangents and g_rad are the kernel's own and
//   lane-major (a lane's values in one row of float4s), so a gathered lane
//   reads a few 32-byte sectors, not one per value.
// - fb::tadd adds a warp's contribution to one table entry with a shuffle
//   reduction and one atomic when the warp's active lanes share the entry,
//   which the binning makes the common case; each block sums into its own
//   shared-memory copy of the table cotangent and adds its non-zero entries
//   to the output with global atomics at the end (no per-block rows).
// - Both kernels keep 128 threads a block and cut the registers to 128 so
//   that 4 blocks fit an SM (16 warps to hide the latency of the gathers):
//   the spills this costs were cheaper than the lost occupancy in a sweep
//   of block sizes and register budgets on an H100.
// The per-lane arithmetic is fb::bounce_bwd, unchanged: same floats, same
// flags (-fmad=false, no fast math), so the whole-span kernel equals the
// chain of per-bounce kernels on every lane. What still separates the kernels
// from their byte bound: the gathers of a key's lanes, scattered over the
// lane index after the first bounces (in fused_bounce_bwd a sector per
// value: its rows are the caller's, one per value), the registers' spills,
// and, in fused_span_bwd, the forward replay of phase 1, which runs in lane
// order as the forward kernel does.
#include <cooperative_groups.h>

#include "fused_adjoint.cuh"
#include "lane_schedule.cuh"
#include "philox.cuh"

namespace cg = cooperative_groups;

namespace {

// Threads of an adjoint block, and the blocks per SM the register budget of
// both adjoint kernels is cut for (128 registers a thread).
constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 4;
using ls::FULL;
// adjoint_bin: a warp's segment is CHUNKS chunks of 32 lanes
constexpr int CHUNKS = 8;
constexpr int SEG = 32 * CHUNKS;
constexpr int BIN_WARPS = 4;  // warps of a binning block

// keys: 0 for a miss, 1 + (winner leaf << KEY_BITS | branch bits) for a hit
constexpr int KEY_BITS = 5;
__host__ __device__ __forceinline__ int n_keys_of(int n_leaves) {
  return 1 + (n_leaves << KEY_BITS);
}

// The code-path key of a lane whose bitfield is not 0 (tracer/fused.py
// adjoint_key_plain is its plain version).
__device__ __forceinline__ int adjoint_key(int bits) {
  if (!((bits >> fb::B_HIT) & 1)) return 0;
  const int win = (bits >> fb::WIN_SHIFT) & 0x1FF;
  const int branch = ((bits >> fb::B_TRANSMIT) & 7)        // transmit tir light
                     | (((bits >> fb::B_EXIT) & 1) << 3)
                     | (((bits >> fb::B_PARITY) & 1) << 4);
  return 1 + (win << KEY_BITS) + branch;
}

// --- adjoint_bin: stable counting sort of the live lanes by key ---------------------
// Three launches, each wide: (1) every warp counts the keys of its segment of
// SEG lanes into rel[key * nseg + seg]; (2) one warp per key scans its row
// over the segments in place (exclusive) and writes the key's total to
// tot[key]; (3) every block scans tot into each key's first slot, and every
// warp writes the lanes of its segment to base[key] + rel[key, seg] + their
// rank among the segment's earlier lanes of that key. Each step is a few
// dependent loads deep, so the pass is bound by launch and latency, not by
// its 2 MB of traffic.

// The keys of the CHUNKS x 32 lanes of warp segment ``seg`` (-1: no key),
// the loads issued together.
__device__ __forceinline__ void segment_keys(const int* __restrict__ bits,
                                             int N, int seg, int* key) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int i = seg * SEG + c * 32 + lane;
    key[c] = i < N ? bits[i] : 0;
  }
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) key[c] = key[c] != 0 ? adjoint_key(key[c]) : -1;
}

__global__ void __launch_bounds__(BIN_WARPS * 32)
k_bin_hist(const int* __restrict__ bits, int N, int n_keys, int nseg,
           int* __restrict__ rel) {
  extern __shared__ int s_cnt[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int seg = blockIdx.x * BIN_WARPS + w;
  int* cnt = s_cnt + w * n_keys;
  if (seg >= nseg) return;  // the whole warp
  for (int k = lane; k < n_keys; k += 32) cnt[k] = 0;
  int key[CHUNKS];
  segment_keys(bits, N, seg, key);
  __syncwarp();
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const unsigned peers = __match_any_sync(FULL, key[c]);
    if (key[c] >= 0 && lane == __ffs(peers) - 1) cnt[key[c]] += __popc(peers);
    __syncwarp();
  }
  for (int k = lane; k < n_keys; k += 32) rel[(size_t)k * nseg + seg] = cnt[k];
}

// One warp per key: rel[key, :] becomes its exclusive scan over the
// segments, tot[key] the key's lanes.
__global__ void __launch_bounds__(BIN_WARPS * 32)
k_bin_segscan(int* __restrict__ rel, int n_keys, int nseg,
              int* __restrict__ tot) {
  const int lane = threadIdx.x & 31;
  const int key = blockIdx.x * BIN_WARPS + (threadIdx.x >> 5);
  if (key >= n_keys) return;
  int* row = rel + (size_t)key * nseg;
  int carry = 0;
  for (int j0 = 0; j0 < nseg; j0 += 32 * CHUNKS) {
    int v[CHUNKS];
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int j = j0 + c * 32 + lane;
      v[c] = j < nseg ? row[j] : 0;
    }
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      int x = v[c];
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int y = __shfl_up_sync(FULL, x, s);
        if (lane >= s) x += y;
      }
      const int j = j0 + c * 32 + lane;
      if (j < nseg) row[j] = carry + x - v[c];
      carry += __shfl_sync(FULL, x, 31);
    }
  }
  if (lane == 0) tot[key] = carry;
}

__global__ void __launch_bounds__(BIN_WARPS * 32)
k_bin_scatter(const int* __restrict__ bits, int N, int n_keys, int nseg,
              const int* __restrict__ rel, const int* __restrict__ tot,
              int* __restrict__ perm, int* __restrict__ count) {
  extern __shared__ int s_bin[];
  __shared__ int tmp[32];
  int* base = s_bin;  // each key's first slot in perm
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int* cur = s_bin + (1 + w) * n_keys;  // the warp's next slot per key, or -1
  // base: the exclusive scan of tot, by the whole block
  const int per = (n_keys + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * per, n_keys);
  const int hi = min(lo + per, n_keys);
  int sum = 0;
  for (int k = lo; k < hi; ++k) sum += tot[k];
  int total;
  int run = ls::block_exclusive_scan(sum, tmp, total);
  for (int k = lo; k < hi; ++k) {
    base[k] = run;
    run += tot[k];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) count[0] = total;
  for (int k = lane; k < n_keys; k += 32) cur[k] = -1;
  __syncthreads();
  const int seg = blockIdx.x * BIN_WARPS + w;
  if (seg >= nseg) return;
  int key[CHUNKS];
  segment_keys(bits, N, seg, key);
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int k = key[c];
    const unsigned peers = __match_any_sync(FULL, k);
    const bool leader = k >= 0 && lane == __ffs(peers) - 1;
    if (leader && cur[k] < 0) cur[k] = base[k] + rel[(size_t)k * nseg + seg];
    __syncwarp();
    if (k >= 0)
      perm[cur[k] + __popc(peers & ((1u << lane) - 1u))] = seg * SEG + c * 32 + lane;
    __syncwarp();
    if (leader) cur[k] += __popc(peers);
    __syncwarp();
  }
}

// --- shared helpers of the adjoint kernels ---------------------------------------

// tab | desc | table cotangent accumulator | 32 ints of scan scratch
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

// The block's table cotangent into the output: its non-zero entries, with
// global atomics (the summation order across blocks changes from run to run).
__device__ __forceinline__ void flush_table(float* gtab, const float* s_gtab,
                                            int n_tab) {
  __syncthreads();
  for (int k = threadIdx.x; k < n_tab; k += blockDim.x) {
    const float v = s_gtab[k];
    if (v != 0.0f) atomicAdd(gtab + k, v);
  }
}

__device__ __forceinline__ fb::V3 load3(const float* p, int i, int N) {
  return fb::V3{p[i], p[N + i], p[2 * (size_t)N + i]};
}
__device__ __forceinline__ void store3(float* p, int i, int N, fb::V3 v) {
  p[i] = v.x;
  p[N + i] = v.y;
  p[2 * (size_t)N + i] = v.z;
}

// fused_span_bwd's own rows, one per lane (lane-major, so that a lane's
// values share a few 32-byte sectors where the lanes of a warp lie far
// apart): an entry state o d thr alive depth, the cotangents o d thr, and
// g_rad, each padded to whole float4s
using ls::round4;
constexpr int SAVE_W = round4(8 + fb::NB);
constexpr int COT_W = round4(6 + fb::NB);
constexpr int RAD_W = round4(fb::NB);

// --- fused_bounce_bwd ----------------------------------------------------------------
// The adjoint of one bounce for every ray, thread t on the t-th live lane of
// ``perm`` (the first ``count[0]`` entries). A ray whose bitfield is 0 took
// no part in the bounce: thread t copies lane t's cotangents through.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
k_bounce_bwd(const float* __restrict__ tab, int n_tab,
             const int* __restrict__ desc, int n_desc,
             const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ thr, const float* __restrict__ aux,
             const float* __restrict__ u, const int* __restrict__ bits,
             const float* __restrict__ go, const float* __restrict__ gd,
             const float* __restrict__ gthr, const float* __restrict__ grad,
             float* __restrict__ go2, float* __restrict__ gd2,
             float* __restrict__ gthr2, float* __restrict__ gtab,
             const int* __restrict__ perm, const int* __restrict__ count,
             int N, fb::Cfg cfg) {
  extern __shared__ float smem[];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < N && bits[t] == 0) {
    store3(go2, t, N, load3(go, t, N));
    store3(gd2, t, N, load3(gd, t, N));
#pragma unroll
    for (int b = 0; b < fb::NB; ++b)
      gthr2[(size_t)b * N + t] = gthr[(size_t)b * N + t];
  }
  const int n_live = count[0];
  if ((int)(blockIdx.x * blockDim.x) >= n_live) return;  // the whole block
  int* s_desc;
  float* s_gtab = load_tables(smem, &s_desc, tab, n_tab, desc, n_desc);
  if (t < n_live) {
    const int i = perm[t];
    fb::V3 g_o = load3(go, i, N), g_d = load3(gd, i, N);
    float g_thr[fb::NB], t_in[fb::NB], g_rad[fb::NB], uu[fb::N_UNIFORMS];
#pragma unroll
    for (int b = 0; b < fb::NB; ++b) {
      g_thr[b] = gthr[(size_t)b * N + i];
      t_in[b] = thr[(size_t)b * N + i];
      g_rad[b] = grad[(size_t)b * N + i];
    }
#pragma unroll
    for (int k = 0; k < fb::N_UNIFORMS; ++k) uu[k] = u[(size_t)k * N + i];
    fb::bounce_bwd(smem, s_desc, cfg, load3(o, i, N), load3(d, i, N), t_in,
                   aux[N + i], uu, bits[i], g_o, g_d, g_thr, g_rad, s_gtab);
    store3(go2, i, N, g_o);
    store3(gd2, i, N, g_d);
#pragma unroll
    for (int b = 0; b < fb::NB; ++b) gthr2[(size_t)b * N + i] = g_thr[b];
  }
  flush_table(gtab, s_gtab, n_tab);
}

// --- fused_span_bwd ------------------------------------------------------------------
// The adjoint of a span of n_steps bounces, one cooperative launch; every
// loop over lanes is warp-strided over chunks of 32 lanes, every loop over a
// step's live lanes thread-strided over the grid. ``iw`` (int workspace):
//   hist   [n_steps, n_keys]  keys counted per step (zeroed here)
//   cursor [n_steps, n_keys]  next free slot of the key in the step's perm
//   live   [n_steps]          lanes taking part in the step
//   ent    [N]                bounces the lane entered
//   perm   [n_steps, N]       each step's live lanes, sorted by key
// and ``fw`` (float workspace), lane-major rows:
//   saved  [n_steps, N, SAVE_W]  the entry state of every bounce entered
//   cot    [N, COT_W]            the cotangents o d thr, staged
//   rad    [N, RAD_W]            g_rad
// Phase 1 replays the span forward from its entry state with the forward
// kernels' own bounce (the same floats, bit for bit), saves the entry state
// of every bounce the ray enters, and stages the lane's cotangents; ``replay``
// (may be null) receives the state it ended in, [8 + B, N]. A lane takes
// part in step s when s < entered and its bitfield there is not 0. At the
// end every lane's staged cotangents are written to go2 gd2 gthr2. With KRNG the uniforms of bounce ``step`` are drawn as k_span_fwd<true>
// draws them, from (lane i, bounce start + step) under the key ``seed``, in
// both phases; ``u`` is not read.
template <bool KRNG>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
k_span_bwd(const float* __restrict__ tab, int n_tab,
           const int* __restrict__ desc, int n_desc,
           const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ thr, const float* __restrict__ aux,
           const float* __restrict__ u, const int* __restrict__ seed,
           int start, const int* __restrict__ bits,
           const float* __restrict__ go, const float* __restrict__ gd,
           const float* __restrict__ gthr, const float* __restrict__ grad,
           float* __restrict__ go2, float* __restrict__ gd2,
           float* __restrict__ gthr2, float* __restrict__ gtab,
           float* __restrict__ fw, float* __restrict__ replay,
           int* __restrict__ iw, int N, int n_steps, fb::Cfg cfg) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int n_keys = n_keys_of(desc[fb::D_L]);
  int* hist = iw;
  int* cursor = hist + (size_t)n_steps * n_keys;
  int* live = cursor + (size_t)n_steps * n_keys;
  int* ent = live + n_steps;
  int* perm = ent + N;
  float* saved = fw;
  float* cot = saved + (size_t)n_steps * N * SAVE_W;
  float* rad = cot + (size_t)N * COT_W;
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_thr = gridDim.x * blockDim.x;

  for (int k = gtid; k < n_steps * n_keys; k += n_thr) hist[k] = 0;
  int* s_desc;
  float* s_gtab = load_tables(smem, &s_desc, tab, n_tab, desc, n_desc);
  int* s_scan = reinterpret_cast<int*>(s_gtab + n_tab);
  uint32_t k0 = 0u, k1 = 0u;
  if constexpr (KRNG) {
    k0 = (uint32_t)seed[0];
    k1 = (uint32_t)seed[1];
  }
  // the uniforms of bounce ``step`` of the span for lane i
  auto draw = [&](int i, int step, float* uu) {
    if constexpr (KRNG) {
      fb::philox_uniforms((uint32_t)i, (uint32_t)(start + step), k0, k1, uu);
    } else {
      const float* us = u + (size_t)step * fb::N_UNIFORMS * N;
#pragma unroll
      for (int k = 0; k < fb::N_UNIFORMS; ++k) uu[k] = us[(size_t)k * N + i];
    }
  };
  // the keys of lane i at steps s0 .. s0 + CHUNKS - 1 (-1: no part in
  // the step), the loads issued together
  auto keys_at = [&](int i, int s0, int entered, int* key) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int s = s0 + c;
      key[c] = (i < N && s < entered) ? bits[(size_t)s * N + i] : 0;
    }
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
      key[c] = key[c] != 0 ? adjoint_key(key[c]) : -1;
  };
  grid.sync();

  // --- phase 1: forward replay, saving entry states; keys counted ------------------
  for (int c = warp * 32; c < N; c += n_warps * 32) {
    const int i = c + lane;
    int entered = 0;
    if (i < N) {
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
        float v[SAVE_W];
        v[0] = ray.o.x;
        v[1] = ray.o.y;
        v[2] = ray.o.z;
        v[3] = ray.d.x;
        v[4] = ray.d.y;
        v[5] = ray.d.z;
#pragma unroll
        for (int b = 0; b < fb::NB; ++b) v[6 + b] = ray.thr[b];
        v[6 + fb::NB] = ray.alive;
        v[7 + fb::NB] = ray.depth;
#pragma unroll
        for (int k = 8 + fb::NB; k < SAVE_W; ++k) v[k] = 0.0f;
        ls::store_vec<SAVE_W>(saved + ((size_t)step * N + i) * SAVE_W, v);
        float uu[fb::N_UNIFORMS];
        draw(i, step, uu);
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
      // the cotangents and g_rad, staged for phase 2; a lane that takes part
      // in no step keeps its cotangents: the pass-through
      float c[COT_W], r[RAD_W];
      const fb::V3 g_o = load3(go, i, N), g_d = load3(gd, i, N);
      c[0] = g_o.x;
      c[1] = g_o.y;
      c[2] = g_o.z;
      c[3] = g_d.x;
      c[4] = g_d.y;
      c[5] = g_d.z;
#pragma unroll
      for (int b = 0; b < fb::NB; ++b) {
        c[6 + b] = gthr[(size_t)b * N + i];
        r[b] = grad[(size_t)b * N + i];
      }
#pragma unroll
      for (int k = 6 + fb::NB; k < COT_W; ++k) c[k] = 0.0f;
#pragma unroll
      for (int k = fb::NB; k < RAD_W; ++k) r[k] = 0.0f;
      ls::store_vec<COT_W>(cot + (size_t)i * COT_W, c);
      ls::store_vec<RAD_W>(rad + (size_t)i * RAD_W, r);
      ent[i] = entered;
    }
    __syncwarp();
    for (int s0 = 0; s0 < n_steps; s0 += CHUNKS) {
      int key[CHUNKS];
      keys_at(i, s0, entered, key);
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        if (!__any_sync(FULL, key[c] >= 0)) continue;
        ls::warp_count(key[c], hist + (size_t)(s0 + c) * n_keys);
      }
    }
  }
  grid.sync();

  // --- each step's histogram scanned by one block ----------------------------------
  for (int s = blockIdx.x; s < n_steps; s += gridDim.x) {
    const int per = (n_keys + blockDim.x - 1) / blockDim.x;
    const int lo = min((int)threadIdx.x * per, n_keys);
    const int hi = min(lo + per, n_keys);
    const int* h = hist + (size_t)s * n_keys;
    int* cur = cursor + (size_t)s * n_keys;
    int sum = 0;
    for (int k = lo; k < hi; ++k) sum += h[k];
    int total;
    int run = ls::block_exclusive_scan(sum, s_scan, total);
    for (int k = lo; k < hi; ++k) {
      cur[k] = run;
      run += h[k];
    }
    if (threadIdx.x == 0) live[s] = total;
  }
  grid.sync();

  // --- each step's live lanes scattered into its perm, by key ----------------------
  for (int c = warp * 32; c < N; c += n_warps * 32) {
    const int i = c + lane;
    const int entered = i < N ? ent[i] : 0;
    for (int s0 = 0; s0 < n_steps; s0 += CHUNKS) {
      int key[CHUNKS];
      keys_at(i, s0, entered, key);
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        if (!__any_sync(FULL, key[c] >= 0)) continue;
        const int at =
            ls::warp_append(key[c], cursor + (size_t)(s0 + c) * n_keys);
        if (key[c] >= 0) perm[(size_t)(s0 + c) * N + at] = i;
      }
    }
  }
  grid.sync();

  // --- phase 2: the adjoints in reverse, one step at a time over the grid ----------
  for (int s = n_steps - 1; s >= 0; --s) {
    const int n_live = live[s];
    const int* ps = perm + (size_t)s * N;
    const float* rows = saved + (size_t)s * N * SAVE_W;
    for (int t = gtid; t < n_live; t += n_thr) {
      const int i = ps[t];
      float v[SAVE_W], c[COT_W], r[RAD_W], uu[fb::N_UNIFORMS];
      ls::load_vec<SAVE_W>(rows + (size_t)i * SAVE_W, v);
      ls::load_vec<COT_W>(cot + (size_t)i * COT_W, c);
      ls::load_vec<RAD_W>(rad + (size_t)i * RAD_W, r);
      draw(i, s, uu);
      fb::V3 g_o{c[0], c[1], c[2]}, g_d{c[3], c[4], c[5]};
      fb::bounce_bwd(smem, s_desc, cfg, fb::V3{v[0], v[1], v[2]},
                     fb::V3{v[3], v[4], v[5]}, v + 6, v[7 + fb::NB], uu,
                     bits[(size_t)s * N + i], g_o, g_d, c + 6, r, s_gtab);
      c[0] = g_o.x;
      c[1] = g_o.y;
      c[2] = g_o.z;
      c[3] = g_d.x;
      c[4] = g_d.y;
      c[5] = g_d.z;
      ls::store_vec<COT_W>(cot + (size_t)i * COT_W, c);
    }
    grid.sync();
  }
  // the staged cotangents into the outputs
  for (int i = gtid; i < N; i += n_thr) {
    float c[COT_W];
    ls::load_vec<COT_W>(cot + (size_t)i * COT_W, c);
    store3(go2, i, N, fb::V3{c[0], c[1], c[2]});
    store3(gd2, i, N, fb::V3{c[3], c[4], c[5]});
#pragma unroll
    for (int b = 0; b < fb::NB; ++b) gthr2[(size_t)b * N + i] = c[6 + b];
  }
  flush_table(gtab, s_gtab, n_tab);
}

size_t smem_bytes(int n_tab, int n_desc) {
  return sizeof(float) * 2 * (size_t)n_tab + sizeof(int) * (size_t)n_desc +
         sizeof(int) * 32;
}

// Dynamic shared memory above 48 KB must be granted per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

int n_segments(int N) { return (N + SEG - 1) / SEG; }

}  // namespace

// Words of the int workspace of adjoint_bin over N lanes: the counts per
// key and segment, and the totals per key.
extern "C" long long adjoint_bin_words(int N, int n_leaves) {
  return (long long)n_keys_of(n_leaves) * (n_segments(N) + 1);
}

// Floats of the float workspace of fused_span_bwd.
extern "C" long long fused_span_bwd_floats(int N, int n_steps) {
  return ((long long)n_steps * SAVE_W + COT_W + RAD_W) * N;
}

// Words of the int workspace of fused_span_bwd.
extern "C" long long fused_span_bwd_words(int N, int n_steps, int n_leaves) {
  return 2LL * n_steps * n_keys_of(n_leaves) + n_steps + N +
         (long long)n_steps * N;
}

// The live lanes of a bounce (``bits`` i32[N] != 0) sorted by adjoint_key,
// stably: ``perm`` i32[N] receives them in its first ``count[0]`` entries
// (the rest is not written). ``work`` holds adjoint_bin_words(N, n_leaves)
// ints. Returns the cudaError_t of the launches; nothing synchronises.
extern "C" int adjoint_bin(const int* bits, int N, int n_leaves, int* perm,
                           int* count, int* work, void* stream) {
  if (N <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int n_keys = n_keys_of(n_leaves), nseg = n_segments(N);
  const size_t smem = sizeof(int) * BIN_WARPS * (size_t)n_keys;
  const size_t smem_s = smem + sizeof(int) * (size_t)n_keys;
  cudaError_t err = allow_smem(k_bin_hist, smem);
  if (err == cudaSuccess) err = allow_smem(k_bin_scatter, smem_s);
  if (err != cudaSuccess) return (int)err;
  int* rel = work;
  int* tot = work + (size_t)n_keys * nseg;
  const int blocks = (nseg + BIN_WARPS - 1) / BIN_WARPS;
  k_bin_hist<<<blocks, BIN_WARPS * 32, smem, st>>>(bits, N, n_keys, nseg, rel);
  k_bin_segscan<<<(n_keys + BIN_WARPS - 1) / BIN_WARPS, BIN_WARPS * 32, 0,
                  st>>>(rel, n_keys, nseg, tot);
  k_bin_scatter<<<blocks, BIN_WARPS * 32, smem_s, st>>>(bits, N, n_keys, nseg,
                                                        rel, tot, perm, count);
  return (int)cudaGetLastError();
}

// Both adjoint kernels add their table cotangent into ``gtab`` f32[n_tab],
// which the caller zeroes, and return the cudaError_t of the launch (0 on
// success); nothing synchronises.
//
// fused_bounce_bwd: ``perm`` and ``count`` as adjoint_bin wrote them for
// ``bits``.
extern "C" int fused_bounce_bwd(
    const float* tab, int n_tab, const int* desc, int n_desc, const float* o,
    const float* d, const float* thr, const float* aux, const float* u,
    const int* bits, const float* go, const float* gd, const float* gthr,
    const float* grad, float* go2, float* gd2, float* gthr2, float* gtab,
    const int* perm, const int* count, int N, int max_depth,
    int ext_min_depth, float p_ext, float survive, float w_imp,
    float one_m_w_imp, float max_distance, void* stream) {
  if (N <= 0) return 0;
  const size_t smem = smem_bytes(n_tab, n_desc);
  cudaError_t err = allow_smem(k_bounce_bwd, smem);
  if (err != cudaSuccess) return (int)err;
  fb::Cfg cfg{max_depth, ext_min_depth, p_ext, survive, w_imp, one_m_w_imp,
              max_distance};
  k_bounce_bwd<<<(N + THREADS - 1) / THREADS, THREADS, smem,
                 (cudaStream_t)stream>>>(
      tab, n_tab, desc, n_desc, o, d, thr, aux, u, bits, go, gd, gthr, grad,
      go2, gd2, gthr2, gtab, perm, count, N, cfg);
  return (int)cudaGetLastError();
}

// fused_span_bwd: ``seed`` null: the uniforms ``u`` f32[n_steps, 10, N] are
// read; else ``seed`` is the i32[2] on the device that fused_span_fwd drew
// bounces start .. start + n_steps - 1 from (``u`` is not read). ``fw``
// holds fused_span_bwd_floats(N, n_steps) floats (16-byte aligned), ``iw``
// fused_span_bwd_words(N, n_steps, n_leaves) ints. The grid is as many
// blocks as the occupancy calculator fits on the card, launched
// cooperatively.
extern "C" int fused_span_bwd(
    const float* tab, int n_tab, const int* desc, int n_desc, const float* o,
    const float* d, const float* thr, const float* aux, const float* u,
    const int* seed, int start, const int* bits, const float* go,
    const float* gd, const float* gthr, const float* grad, float* go2,
    float* gd2, float* gthr2, float* gtab, float* fw, float* replay,
    int* iw, int N, int n_steps, int max_depth, int ext_min_depth,
    float p_ext, float survive, float w_imp, float one_m_w_imp,
    float max_distance, void* stream) {
  if (N <= 0) return 0;
  const size_t smem = smem_bytes(n_tab, n_desc);
  fb::Cfg cfg{max_depth, ext_min_depth, p_ext, survive, w_imp, one_m_w_imp,
              max_distance};
  const void* kernel = seed != nullptr ? (const void*)k_span_bwd<true>
                                       : (const void*)k_span_bwd<false>;
  cudaError_t err = seed != nullptr ? allow_smem(k_span_bwd<true>, smem)
                                    : allow_smem(k_span_bwd<false>, smem);
  if (err != cudaSuccess) return (int)err;
  const float* u_arg = seed != nullptr ? nullptr : u;
  const int start_arg = seed != nullptr ? start : 0;
  void* args[] = {(void*)&tab,     (void*)&n_tab,   (void*)&desc,
                  (void*)&n_desc,  (void*)&o,       (void*)&d,
                  (void*)&thr,     (void*)&aux,     (void*)&u_arg,
                  (void*)&seed,    (void*)&start_arg, (void*)&bits,
                  (void*)&go,      (void*)&gd,      (void*)&gthr,
                  (void*)&grad,    (void*)&go2,     (void*)&gd2,
                  (void*)&gthr2,   (void*)&gtab,    (void*)&fw,
                  (void*)&replay,  (void*)&iw,      (void*)&N,
                  (void*)&n_steps, (void*)&cfg};
  return (int)ls::launch_cooperative(kernel, THREADS, smem,
                                     (N + THREADS - 1) / THREADS, args,
                                     (cudaStream_t)stream);
}
