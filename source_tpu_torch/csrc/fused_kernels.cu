// The fused forward kernels and their plain C interface (loaded with ctypes
// by tracer/fused.py; built by nvcc for sm_90a, one library per bin count:
// -DSRC_BINS=<B>).
//
// fused_bounce_fwd (K1) replaces the per-bounce Pallas kernel of the JAX
// package (source_tpu/tracer/pallas_fused.py, _bounce_fwd_call ->
// _fwd_kernel); fused_span_fwd (K3) replaces its whole-span kernel
// (_span_fwd_call -> _span_fwd_kernel), with both of its uniform sources:
// uniforms read from device memory, or drawn in the kernel (the TPU kernel's
// _gen_u branch) by Philox4x32-10 (philox.cuh) from an i32[2] seed on the
// device. fused_bounce_replay (K9) and fused_bounce_io (K10) replace its two
// profiling variants of the per-bounce kernel (_bounce_replay_call ->
// _replay_kernel and _bounce_io_call -> _io_kernel, which
// benchmarks/fusedprof.py drives): the bounce with its decisions replayed
// from a bitfield, and the bounce's loads and stores with no arithmetic.
// The three are instantiations of one bounce loop (k_bounce<MODE>), so each
// runs the lanes K1 runs on K1's schedule, with the same loads, stores and
// list pushes: K1 - K9 is the decision path, K9 - K10 the arithmetic, K10
// the load/store and launch floor of the bounce that a route launches.
//
// Layout: SoA state (o[3,N] d[3,N] thr[B,N] rad[B,N] aux[2,N], one ray per
// column) so that a warp's loads and stores in lane order are contiguous.
// The scene table (a few hundred floats) and the int32 descriptor of the
// spec are copied to shared memory once per block; the kernels are
// data-driven and serve every scene of the fused class without recompiling.
//
// What bounds them on an H100: by the roofline, bytes. A bounce moves about
// (2 * (8 + 2B) + 11) * 4 bytes per ray and spends on the order of a thousand
// f32 operations on it, a few operations per byte where the card balances at
// about twenty. What held the first versions (one thread per lane, in lane
// order) 20-30x above that bound was the schedule: a ray that dies leaves
// its warp's loop but not its warp, so late in a span a warp runs a whole
// bounce (each lane on its own leaf and material: divides, square roots and
// branches that diverge) for a handful of live lanes, and a bounce launched
// over N lanes loads and stores every dead lane too.
//
// What this design does about it; the arithmetic of a lane is fb::bounce,
// unchanged (same floats, -fmad=false, no fast math), and a lane's uniforms
// and bitfields stay indexed by its own index, so every lane's state and
// bits are the lane-order kernels' bit for bit; only the order in which
// lanes run changes, and no float depends on it.
// - fused_span_fwd is ONE persistent cooperative launch (as many blocks as
//   the card holds at once; ls::launch_cooperative). Head: each warp takes
//   chunks of 32 lanes (an atomic counter hands them out) and walks them in
//   registers, step by step, while at least SPILL_AT of its lanes are alive.
//   Hand-off: when fewer are (__ballot_sync), the survivors write their
//   state to the kernel's own lane-major rows (one per lane, padded to
//   float4s) and append their lane to the queue of that step (one
//   warp-aggregated atomic). Tail: after one grid.sync(), step s runs its
//   queue densely over the whole grid -- gather the row, bounce, write the
//   row back, append a survivor to the queue of step s + 1 -- with one
//   grid.sync() a step that has lanes. At the end the spilled lanes' rows go
//   to the SoA outputs; the others were written from registers. SPILL_AT = 0
//   is the lane-order kernel, SPILL_AT = 32 compacts from the first death;
//   the sweep chose 24, with 128 registers a thread for 4 blocks an SM.
// - fused_bounce_fwd takes the live lanes of the previous bounce (a list and
//   its count on the device, written by the previous launch) and runs them
//   gathered, dense; the launch still covers N lanes, so the host never
//   reads the count. It appends its survivors to the next list in the same
//   pass. In place (the outputs are the inputs: the forward per-bounce
//   route) the lanes dead on entry are not written at all; out of place
//   they are copied through in lane order by every thread, which timed
//   slower than lane order at every bounce measured, so the differentiable
//   per-bounce route (out of place) passes no list. With no list,
//   or a list of GATHER_PCT percent of the lanes or more (the count decides
//   on the device), it runs in lane order, where a gather would read no
//   fewer sectors of the SoA state. K9 and K10 take the same list and run
//   the same schedule, so that their times split the route's K1 and not a
//   lane-order kernel that no route launches.
// With the kernel RNG the span kernel reads no uniforms and spends about 300
// integer operations a ray and a bounce on Philox instead (three calls of ten
// rounds), which moves its bound from bytes toward operations.
#include <cooperative_groups.h>

#include "fused_bounce.cuh"
#include "lane_schedule.cuh"
#include "philox.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
// The schedule's constants, each chosen by a sweep on an H100 (PERF.md):
// - SPILL_AT: lanes of a warp that must be alive for the span kernel's head
//   to go on walking them in registers; below it the survivors move to the
//   tail. tracer/fused.py mirrors it (SPILL_AT) for its plain model.
// - MIN_BLOCKS: blocks an SM holds of the span kernel, which caps its
//   registers at 128.
// - SPREAD_WARPS: a gathered bounce of the per-bounce kernel with few lanes
//   puts only as many on a warp as it needs to cover them with this many
//   warps (the tail's steps spread over all of the grid's): a warp then
//   runs the code paths of a few lanes and not of 32, where the time is one
//   bounce's latency and not the card's throughput.
// - GATHER_PCT: the share of the lanes (percent) below which the per-bounce
//   kernel runs its live list gathered; at or above it, the live lanes'
//   state spans nearly every sector of the SoA state, and the kernel walks
//   the lanes in order.
constexpr int SPILL_AT = 24;
constexpr int MIN_BLOCKS = 4;
constexpr int SPREAD_WARPS = 2048;
constexpr int GATHER_PCT = 50;
// the per-bounce loop's third mode, beside fb::DECIDE (K1) and fb::REPLAY
// (K9): K10, the loads and stores alone
constexpr int IO = 2;
using ls::FULL;
// a lane's row of the span kernel: o d thr rad alive depth, padded
constexpr int ROW_W = ls::round4(8 + 2 * fb::NB);

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

__device__ __forceinline__ void load_row(const float* p, fb::Ray& r) {
  float v[ROW_W];
  ls::load_vec<ROW_W>(p, v);
  r.o = fb::V3{v[0], v[1], v[2]};
  r.d = fb::V3{v[3], v[4], v[5]};
#pragma unroll
  for (int b = 0; b < fb::NB; ++b) {
    r.thr[b] = v[6 + b];
    r.rad[b] = v[6 + fb::NB + b];
  }
  r.alive = v[6 + 2 * fb::NB];
  r.depth = v[7 + 2 * fb::NB];
}

__device__ __forceinline__ void store_row(float* p, const fb::Ray& r) {
  float v[ROW_W];
  v[0] = r.o.x;
  v[1] = r.o.y;
  v[2] = r.o.z;
  v[3] = r.d.x;
  v[4] = r.d.y;
  v[5] = r.d.z;
#pragma unroll
  for (int b = 0; b < fb::NB; ++b) {
    v[6 + b] = r.thr[b];
    v[6 + fb::NB + b] = r.rad[b];
  }
  v[6 + 2 * fb::NB] = r.alive;
  v[7 + 2 * fb::NB] = r.depth;
#pragma unroll
  for (int k = 8 + 2 * fb::NB; k < ROW_W; ++k) v[k] = 0.0f;
  ls::store_vec<ROW_W>(p, v);
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// K10's stand-in for the bounce: the lane's uniforms (alive on entry) are
// loaded, and every store of the lane depends on every load of its thread
// through ``z = |s| * 0``, which the compiler cannot fold under IEEE
// arithmetic (s may be NaN or infinite; no fast math); x - (+0) is x bit for
// bit, -0 included, so the state comes out as it went in.
__device__ __forceinline__ void io_touch(fb::Ray& ray, int i, int N,
                                         const float* __restrict__ u,
                                         const float* s_tab, const int* s_desc,
                                         bool entered) {
  float s = s_tab[0] + (float)s_desc[0];
  if (entered) {
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
}

// One bounce of the per-bounce route, in one of three modes, each inlined
// once:
// - fb::DECIDE (K1, fused_bounce_fwd): the bounce, its choices returned in
//   ``bits``.
// - fb::REPLAY (K9, fused_bounce_replay): the bounce's arithmetic with the
//   choices taken from ``bits_in`` (what K1 returned for this state and
//   these uniforms; fb::bounce_as<REPLAY>); writes no bitfield. Its plain
//   version is ``bounce_core`` with ``bits``. A lane that enters dead keeps
//   its state, as in K1: the TPU kernel evaluates such lanes too (with their
//   bitfield 0, a result nothing reads), here they are skipped.
// - IO (K10, fused_bounce_io): K1's loads and stores and nothing else
//   (io_touch); a zero bitfield; every lane alive on entry survives.
// u is f32[10, N]; bits is i32[N]. A lane dead on entry keeps its state and
// gets a zero bitfield (K9 writes none). With ``live`` null, or a list that
// holds GATHER_PCT percent of the lanes or more, thread i runs lane i (a
// dead lane is copied through out of place, not stored in place: o2 == o,
// every output its input). Else the list (the lanes alive on entry, in any
// order) is run gathered: warp w takes entries w * per .. w * per + per - 1,
// then those n_warps * per further on, until the list ends (``per`` is 32,
// or fewer when the list is short enough to spread over SPREAD_WARPS warps
// of the grid); out of place, thread i copies lane i through when it is
// dead, and in place the caller has zeroed ``bits``. ``next`` (may be null)
// receives the lanes alive after the bounce, in the order of the atomics,
// and next_n[0] (zeroed by the caller) their count. No __restrict__ on the
// state: in place the outputs alias the inputs.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
k_bounce(const float* __restrict__ tab, int n_tab,
         const int* __restrict__ desc, int n_desc, const float* o,
         const float* d, const float* thr, const float* rad, const float* aux,
         float* o2, float* d2, float* thr2, float* rad2, float* aux2,
         const float* __restrict__ u, const int* __restrict__ bits_in,
         int* bits, const int* __restrict__ live,
         const int* __restrict__ live_n, int* __restrict__ next,
         int* __restrict__ next_n, int N, fb::Cfg cfg) {
  extern __shared__ float smem[];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  const bool in_place = o2 == o;
  const int n_live = live != nullptr ? live_n[0] : N;
  const bool gather =
      live != nullptr && 100LL * n_live < (long long)GATHER_PCT * N;
  const int spread = min(SPREAD_WARPS, n_warps);
  const int per = min(32, max(1, (n_live + spread - 1) / spread));
  if (gather) {
    if (!in_place && t < N && !(aux[t] > 0.5f)) {  // dead: copied through
      fb::Ray ray;
      load_ray(ray, t, N, o, d, thr, rad, aux);
      store_ray(ray, t, N, o2, d2, thr2, rad2, aux2);
      if constexpr (MODE != fb::REPLAY) bits[t] = 0;
    }
    // a block whose first entry is past the list has none
    if ((long long)blockIdx.x * (blockDim.x / 32) * per >= n_live) return;
  }
  float* s_tab = smem;
  int* s_desc = reinterpret_cast<int*>(smem + n_tab);
  load_tables(s_tab, s_desc, tab, n_tab, desc, n_desc);
  // one loop for both orders, so that the bounce is inlined once: in lane
  // order warp w takes lanes 32 w .. 32 w + 31 in one pass (the grid covers
  // N); gathered, its entries of the list, pass by pass
  const int take = gather ? per : 32, end = gather ? n_live : N;
  const int stride = n_warps * take;
  for (int e0 = (t >> 5) * take; e0 < end; e0 += stride) {
    const int e = e0 + lane;
    const int i = lane < take && e < end ? (gather ? live[e] : e) : -1;
    bool survives = false;
    if (i >= 0) {
      fb::Ray ray;
      load_ray(ray, i, N, o, d, thr, rad, aux);
      const bool entered = ray.alive > 0.5f;
      int bf = 0;
      if constexpr (MODE == IO) {
        io_touch(ray, i, N, u, s_tab, s_desc, entered);
        survives = entered;
      } else if (entered) {
        float uu[fb::N_UNIFORMS];
#pragma unroll
        for (int k = 0; k < fb::N_UNIFORMS; ++k) uu[k] = u[k * N + i];
        if constexpr (MODE == fb::DECIDE)
          bf = fb::bounce(s_tab, s_desc, cfg, ray, uu);
        else
          fb::bounce_as<fb::REPLAY>(s_tab, s_desc, cfg, ray, uu, bits_in[i]);
        survives = ray.alive > 0.5f;
      }
      if (entered || !in_place) store_ray(ray, i, N, o2, d2, thr2, rad2, aux2);
      if constexpr (MODE != fb::REPLAY) bits[i] = bf;
    }
    if (next != nullptr) {
      const int at = ls::warp_push(survives, next_n);
      if (survives) next[at] = i;
    }
  }
}

// n_steps bounces for every ray. With KRNG false, u is f32[n_steps, 10, N];
// with KRNG true the uniforms of bounce ``step`` are Philox's for (lane i,
// bounce start + step) under the key ``seed`` (i32[2] on the device, read by
// every thread: no host sync for the seed), drawn in registers, and u is not
// read. bits is i32[n_steps, N], zero-filled by the caller: only the bounces
// a ray enters alive are written. ``rows`` f32[N, ROW_W] holds the state of
// the lanes that left the head; ``iw`` (int workspace, its first 1 +
// n_steps words zeroed by the caller):
//   next   [1]             the next chunk of 32 lanes for the head
//   live   [n_steps]       lanes queued for each step of the tail
//   mask   [n_chunks]      each chunk's lanes that left the head
//   queue  [n_steps, N]    each step's lanes, in the order of the atomics
// ``trace`` (may be null; i64[2 + 2 n_steps]): block 0's %globaltimer at its
// start, at the end of the head (after the grid barrier) and after each step
// of the tail, then each step's queued lanes.
template <bool KRNG>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
k_span_fwd(const float* __restrict__ tab, int n_tab,
           const int* __restrict__ desc, int n_desc,
           const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ thr, const float* __restrict__ rad,
           const float* __restrict__ aux, float* __restrict__ o2,
           float* __restrict__ d2, float* __restrict__ thr2,
           float* __restrict__ rad2, float* __restrict__ aux2,
           const float* __restrict__ u, const int* __restrict__ seed,
           int start, int* __restrict__ bits, float* __restrict__ rows,
           int* __restrict__ iw, long long* __restrict__ trace, int N,
           int n_steps, fb::Cfg cfg) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  float* s_tab = smem;
  int* s_desc = reinterpret_cast<int*>(smem + n_tab);
  load_tables(s_tab, s_desc, tab, n_tab, desc, n_desc);
  const int n_chunks = (N + 31) / 32;
  int* next_chunk = iw;
  int* live = iw + 1;
  unsigned* mask = reinterpret_cast<unsigned*>(live + n_steps);
  int* queue = live + n_steps + n_chunks;
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  const bool timer = trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  if (timer) trace[0] = globaltimer();
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

  // --- head: a warp walks its chunk in registers while it is full enough ---
  for (;;) {
    int c = 0;
    if (lane == 0) c = atomicAdd(next_chunk, 1);
    c = __shfl_sync(FULL, c, 0);
    if (c >= n_chunks) break;
    const int i = c * 32 + lane;
    fb::Ray ray;
    if (i < N)
      load_ray(ray, i, N, o, d, thr, rad, aux);
    else
      ray.alive = 0.0f;
    int step = 0;
    bool spill = false;
    for (; step < n_steps; ++step) {
      const unsigned alive = __ballot_sync(FULL, ray.alive > 0.5f);
      if (alive == 0u) break;
      if (__popc(alive) < SPILL_AT) {
        spill = ray.alive > 0.5f;
        break;
      }
      if (ray.alive > 0.5f) {
        float uu[fb::N_UNIFORMS];
        draw(i, step, uu);
        bits[(size_t)step * N + i] = fb::bounce(s_tab, s_desc, cfg, ray, uu);
      }
    }
    // hand-off: the survivors to their rows and the queue of this step
    const int at = ls::warp_push(spill, live + step);
    if (spill) {
      store_row(rows + (size_t)i * ROW_W, ray);
      queue[(size_t)step * N + at] = i;
    } else if (i < N) {
      store_ray(ray, i, N, o2, d2, thr2, rad2, aux2);
    }
    const unsigned m = __ballot_sync(FULL, spill);
    if (lane == 0) mask[c] = m;
  }
  grid.sync();
  if (timer) trace[1] = globaltimer();

  // --- tail: step by step, each step's lanes dense over the grid ----------
  for (int s = 0; s < n_steps; ++s) {
    const int n_live = __ldcg(live + s);  // complete: no step before s runs
    if (timer) trace[2 + n_steps + s] = n_live;
    if (n_live > 0) {
      const int* q = queue + (size_t)s * N;
      const int per = min(32, (n_live + n_warps - 1) / n_warps);
      for (int t0 = warp * per; t0 < n_live; t0 += n_warps * per) {
        const int t = t0 + lane;
        const int i = lane < per && t < n_live ? __ldcg(q + t) : -1;
        bool more = false;
        if (i >= 0) {
          fb::Ray ray;
          load_row(rows + (size_t)i * ROW_W, ray);
          float uu[fb::N_UNIFORMS];
          draw(i, s, uu);
          bits[(size_t)s * N + i] = fb::bounce(s_tab, s_desc, cfg, ray, uu);
          store_row(rows + (size_t)i * ROW_W, ray);
          more = ray.alive > 0.5f && s + 1 < n_steps;
        }
        const int at = ls::warp_push(more, live + s + 1);
        if (more) queue[(size_t)(s + 1) * N + at] = i;
      }
      grid.sync();
    }
    if (timer) trace[2 + s] = globaltimer();
  }

  // --- the lanes that left the head: rows to the outputs, in lane order ---
  for (int c = warp; c < n_chunks; c += n_warps) {
    if ((mask[c] >> lane) & 1u) {
      const int i = c * 32 + lane;
      fb::Ray ray;
      load_row(rows + (size_t)i * ROW_W, ray);
      store_ray(ray, i, N, o2, d2, thr2, rad2, aux2);
    }
  }
}

size_t smem_bytes(int n_tab, int n_desc) {
  return sizeof(float) * (size_t)n_tab + sizeof(int) * (size_t)n_desc;
}

// The launch of k_bounce<MODE> behind the three per-bounce entry points:
// ``bits`` (null for K9, which writes none) zeroed first where the kernel
// runs its list in place (the lanes not in it get no store), ``next_n``
// zeroed where a list is pushed.
template <int MODE>
int launch_bounce(const float* tab, int n_tab, const int* desc, int n_desc,
                  const float* o, const float* d, const float* thr,
                  const float* rad, const float* aux, float* o2, float* d2,
                  float* thr2, float* rad2, float* aux2, const float* u,
                  const int* bits_in, int* bits, const int* live,
                  const int* live_n, int* next, int* next_n, int N,
                  fb::Cfg cfg, void* stream) {
  if (N <= 0) return 0;
  size_t smem = smem_bytes(n_tab, n_desc);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (bits != nullptr && live != nullptr && o2 == o)
    err = cudaMemsetAsync(bits, 0, sizeof(int) * (size_t)N, st);
  if (err == cudaSuccess && next != nullptr)
    err = cudaMemsetAsync(next_n, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  int blocks = (N + THREADS - 1) / THREADS;
  k_bounce<MODE><<<blocks, THREADS, smem, st>>>(
      tab, n_tab, desc, n_desc, o, d, thr, rad, aux, o2, d2, thr2, rad2, aux2,
      u, bits_in, bits, live, live_n, next, next_n, N, cfg);
  return (int)cudaGetLastError();
}

}  // namespace

// The span kernel's workspace: ints (iw) and floats (rows, 16-byte aligned)
// over N lanes and n_steps bounces.
extern "C" long long fused_span_fwd_words(int N, int n_steps) {
  return 1LL + n_steps + (N + 31) / 32 + (long long)n_steps * N;
}
extern "C" long long fused_span_fwd_floats(int N) {
  return (long long)N * ROW_W;
}

// Each returns the cudaError_t of the launch (0 on success); nothing
// synchronises. 48 KB of shared memory hold every scene of the fused class
// (48 leaves and 48 materials at 15 bins are under 12 KB); a larger table is
// refused with cudaErrorInvalidValue.
//
// fused_bounce_fwd (K1), fused_bounce_replay (K9) and fused_bounce_io
// (K10) take the same schedule: ``live`` null: every lane, in lane order;
// else the lanes alive on entry, ``live_n[0]`` of them, as a previous
// launch's ``next`` wrote them. ``next`` (may be null) receives the lanes
// alive after the bounce (K10: those alive on entry, which it leaves alive)
// and ``next_n[0]`` their count. In place when o2 == o (every output
// pointer its input). K9 reads the bitfield ``bits_in`` that K1 returned for
// this state and these uniforms and writes none; K10 takes no configuration.
extern "C" int fused_bounce_fwd(
    const float* tab, int n_tab, const int* desc, int n_desc, const float* o,
    const float* d, const float* thr, const float* rad, const float* aux,
    float* o2, float* d2, float* thr2, float* rad2, float* aux2, const float* u,
    int* bits, const int* live, const int* live_n, int* next, int* next_n,
    int N, int max_depth, int ext_min_depth, float p_ext, float survive,
    float w_imp, float one_m_w_imp, float max_distance, void* stream) {
  fb::Cfg cfg{max_depth, ext_min_depth, p_ext, survive, w_imp, one_m_w_imp,
              max_distance};
  return launch_bounce<fb::DECIDE>(tab, n_tab, desc, n_desc, o, d, thr, rad,
                                   aux, o2, d2, thr2, rad2, aux2, u, nullptr,
                                   bits, live, live_n, next, next_n, N, cfg,
                                   stream);
}

extern "C" int fused_bounce_replay(
    const float* tab, int n_tab, const int* desc, int n_desc, const float* o,
    const float* d, const float* thr, const float* rad, const float* aux,
    float* o2, float* d2, float* thr2, float* rad2, float* aux2, const float* u,
    const int* bits_in, const int* live, const int* live_n, int* next,
    int* next_n, int N, int max_depth, int ext_min_depth, float p_ext,
    float survive, float w_imp, float one_m_w_imp, float max_distance,
    void* stream) {
  fb::Cfg cfg{max_depth, ext_min_depth, p_ext, survive, w_imp, one_m_w_imp,
              max_distance};
  return launch_bounce<fb::REPLAY>(tab, n_tab, desc, n_desc, o, d, thr, rad,
                                   aux, o2, d2, thr2, rad2, aux2, u, bits_in,
                                   nullptr, live, live_n, next, next_n, N, cfg,
                                   stream);
}

extern "C" int fused_bounce_io(
    const float* tab, int n_tab, const int* desc, int n_desc, const float* o,
    const float* d, const float* thr, const float* rad, const float* aux,
    float* o2, float* d2, float* thr2, float* rad2, float* aux2, const float* u,
    int* bits, const int* live, const int* live_n, int* next, int* next_n,
    int N, void* stream) {
  return launch_bounce<IO>(tab, n_tab, desc, n_desc, o, d, thr, rad, aux, o2,
                           d2, thr2, rad2, aux2, u, nullptr, bits, live,
                           live_n, next, next_n, N, fb::Cfg{}, stream);
}

// fused_span_fwd: ``seed`` null: the uniforms ``u`` f32[n_steps, 10, N] are
// read; else ``seed`` is an i32[2] on the device and the kernel draws the
// uniforms of bounces start .. start + n_steps - 1 itself (``u`` is not
// read). ``rows`` holds fused_span_fwd_floats(N) floats, ``iw``
// fused_span_fwd_words(N, n_steps) ints; ``trace`` may be null. The grid is
// as many blocks as the occupancy calculator fits on the card, launched
// cooperatively.
extern "C" int fused_span_fwd(
    const float* tab, int n_tab, const int* desc, int n_desc, const float* o,
    const float* d, const float* thr, const float* rad, const float* aux,
    float* o2, float* d2, float* thr2, float* rad2, float* aux2, const float* u,
    const int* seed, int start, int* bits, float* rows, int* iw,
    long long* trace, int N, int n_steps, int max_depth, int ext_min_depth,
    float p_ext, float survive, float w_imp, float one_m_w_imp,
    float max_distance, void* stream) {
  if (N <= 0) return 0;
  size_t smem = smem_bytes(n_tab, n_desc);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(iw, 0, sizeof(int) * (size_t)(1 + n_steps), st);
  if (err != cudaSuccess) return (int)err;
  fb::Cfg cfg{max_depth, ext_min_depth, p_ext, survive, w_imp, one_m_w_imp,
              max_distance};
  const float* u_arg = seed != nullptr ? nullptr : u;
  const int start_arg = seed != nullptr ? start : 0;
  void* args[] = {(void*)&tab,   (void*)&n_tab, (void*)&desc,  (void*)&n_desc,
                  (void*)&o,     (void*)&d,     (void*)&thr,   (void*)&rad,
                  (void*)&aux,   (void*)&o2,    (void*)&d2,    (void*)&thr2,
                  (void*)&rad2,  (void*)&aux2,  (void*)&u_arg, (void*)&seed,
                  (void*)&start_arg, (void*)&bits, (void*)&rows, (void*)&iw,
                  (void*)&trace, (void*)&N,     (void*)&n_steps, (void*)&cfg};
  const void* kernel = seed != nullptr ? (const void*)k_span_fwd<true>
                                       : (const void*)k_span_fwd<false>;
  return (int)ls::launch_cooperative(kernel, THREADS, smem,
                                     (N + THREADS - 1) / THREADS, args, st);
}
