// RG-LRU linear recurrence  h_t = a_t · h_{t−1} + u_t  over (B, S, W) f32,
// and its backward as the same recurrence in reverse time.
//
// Replaces repro/kernels/rglru_scan.py::rglru_scan_b (the Pallas kernel: a
// (B, chunks) grid whose chunk axis runs in order on the TPU, the carry h in
// VMEM, a doubling scan inside each chunk of 256 steps).  The recurrence
// starts from h_{−1} = 0; a caller with a carried state h0 folds it into the
// first step (u_0 ← u_0 + a_0·h0) before the launch, as the Pallas kernel
// folds its carry into each chunk's first row.
//
// Bound: a and u read once, h written once: 12·B·S·W bytes against 2·B·S·W
// flops (0.17 flop/byte), so the forward is memory-bound.  At the served
// shape (B, S, W) = (4, 4096, 4096) that is 805 MB, 0.24 ms at 3.35 TB/s.
// The backward reads a, h and dh and writes da and du: 20·B·S·W bytes.
//
// Two forward routes, chosen by repro_torch/kernels/rglru_scan.py::route.
//
// Walk route (rglru_scan_kernel, the first port; any shape): one thread per
// (b, w) channel walks S in order and keeps h in a register; neighbouring
// threads hold neighbouring w, so each step's loads and store are coalesced
// 128-byte lines.  The loads of a_t and u_t do not depend on h, so they are
// issued kUnroll steps ahead.  The ragged W edge is masked and any S is
// taken (steps past S load the identity a = 1, u = 0 and store nothing).
// Each step rounds the product and the sum separately (no fused
// multiply-add), the order of the plain version
// (repro_torch/kernels/ref.py::rglru_ref), so the two agree bit for bit.
// Its only parallelism is the B·W channels: 16 blocks at (1, S, 2048), each
// thread walking S dependent steps.  A 1-D grid of (b, 128 channels)
// blocks takes any B.
//
// Chunked route (rglru_chunked_kernel; S of two chunks or more): one pass
// over S in parallel, the carry between chunks found by decoupled look-back
// (the single-pass scan of Merrill and Garland).
//  * A tile is a batch row b, 32 channels (one 128-byte row: lane =
//    channel) and one chunk of 128 steps; a block of 8 warps scans it, warp
//    = a run of 16 steps.  The route needs S of two chunks or more: with
//    one chunk there is no carry to find, and on an H100 the walk is the
//    faster there (at (8, 128, 4096): PERF.md).
//  * Tiles are numbered by an atomic ticket, chunk-major (all (b, w-tile)
//    of chunk 0, then chunk 1, …).  A persistent grid (the blocks the card
//    holds at once: 4 an SM forward, 3 backward) takes tickets in turn.
//  * A block's pipeline: the tile's operands land in shared memory
//    (cp.async, each thread copying what it later reads); each thread
//    scans its 16 steps from zero into registers and keeps the prefix
//    products P_t; the 8 runs' maps (Π a, h_end) compose through shared
//    memory into each run's carry-in map and the tile's aggregate, which
//    is published at once (for chunk 0, its inclusive end state).  Then
//    the block takes its next ticket and starts that tile's copies, so
//    they are in flight while it looks back for the current tile's carry
//    and stores it.
//  * Look-back: the 8 warps read 8 predecessors at once (warp v at chunk
//    c − 1 − v), each spinning until its predecessor's flag is set; the
//    carry composes the aggregates down to the nearest inclusive state
//    (or h_{−1} = 0), 8 chunks a round.  The tile publishes its own
//    inclusive end state, then applies h_t = h_local_t + P_t·carry and
//    stores h once: 12·B·S·W bytes, the walk's, in one launch.
//  * No deadlock, whatever order the card schedules blocks in: a block
//    only waits on tiles of smaller tickets; of the tiles that wait, the
//    one with the smallest ticket has every predecessor published, or
//    held as the prefetched next tile of a block that does not wait.
//  * Ordering: values are stored, fenced (__threadfence) and the warp
//    synchronized before one lane stores the flag with st.release.gpu;
//    every reading lane loads the flag with ld.acquire.gpu and then the
//    values through L2 (ld.cg).
//  * Per-launch state (the ticket and the flags) lives in a workspace the
//    wrapper allocates; the launcher zeroes it with cudaMemsetAsync on the
//    launch's stream, so no host sync is needed and the launch can be
//    captured in a CUDA graph.
//  * Tiles are decoded from the ticket, not from a 2-D grid, so any B
//    (the clients folded into B under vmap) fits the grid.
//  * Rounding: the carry reaches a step through P_t (fused multiply-adds),
//    not step by step, so the route is not bit for bit the plain version;
//    repro_torch/kernels/ref.py::rglru_chunked writes its arithmetic out.
//  * On an H100, chunks of 64 steps measured slower at every timed shape,
//    and a two-stage version that scanned a prefetched tile only after
//    the current one lost at (1, 32768, 4096) and (1, 4096, 2048)
//    (PERF.md).
//
// Backward (the chunked kernel in reverse time, rglru_scan_bwd_launch):
//     g_t = dh_t + a_{t+1}·g_{t+1}   (a_S the identity),
//     du_t = g_t,   da_t = g_t·h_{t−1}   (h_{−1} = 0),
// is the forward's scan over the reversed sequence with a read one step
// ahead: logical step t' is physical step S − 1 − t', the chunks are walked
// from the last toward the first, and the fix-up's epilogue reads h_{t−1}
// and writes da and du.  20·B·S·W bytes in one launch;
// repro_torch/kernels/ref.py::rglru_bwd_scan writes it out in plain ops.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kScanThreads = 128;  // channels per block (walk)
constexpr int kUnroll = 16;        // steps loaded ahead (walk)

__global__ void __launch_bounds__(kScanThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ u,
                  float* __restrict__ h, int S, int W, int w_blocks) {
  const int b = blockIdx.x / w_blocks;
  const int w = (blockIdx.x - b * w_blocks) * kScanThreads + threadIdx.x;
  if (w >= W) return;
  const int64_t base = (int64_t)b * S * W + w;
  const float* ap = a + base;
  const float* up = u + base;
  float* hp = h + base;

  float ca[kUnroll], cu[kUnroll], na[kUnroll], nu[kUnroll];
#pragma unroll
  for (int i = 0; i < kUnroll; ++i) {
    const bool in = i < S;
    ca[i] = in ? __ldcs(ap + (int64_t)i * W) : 1.0f;
    cu[i] = in ? __ldcs(up + (int64_t)i * W) : 0.0f;
  }
  float hv = 0.0f;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int t = t0 + kUnroll + i;
      const bool in = t < S;
      na[i] = in ? __ldcs(ap + (int64_t)t * W) : 1.0f;
      nu[i] = in ? __ldcs(up + (int64_t)t * W) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      hv = __fadd_rn(__fmul_rn(ca[i], hv), cu[i]);
      if (t0 + i < S) __stcs(hp + (int64_t)(t0 + i) * W, hv);
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      ca[i] = na[i];
      cu[i] = nu[i];
    }
  }
}

// ---------------------------------------------------------------------------
// the chunked route and the backward
// ---------------------------------------------------------------------------

constexpr int kLanes = 32;  // channels of a tile: one 128-byte row
constexpr int kWarps = 8;   // runs of kSteps steps in a tile's chunk
constexpr int kSteps = 16;  // steps a run
constexpr int kChunk = kSteps * kWarps;  // steps a chunk (128)
constexpr int kTileThreads = kLanes * kWarps;
constexpr int kEmpty = 0, kAggregate = 1, kInclusive = 2;

// The look-back's workspace: the ticket, a flag per tile, and per tile and
// channel the aggregate (Π a, h from zero) and the inclusive end state.
struct LookBack {
  int* ticket;
  int* flags;
  float* agg_a;
  float* agg_h;
  float* inc_h;
};

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Warp 0 publishes the tile's per-channel values (stored by the caller's
// lanes before this call), then the flag.
__device__ __forceinline__ void publish(int* flag, int value, int lane) {
  __threadfence();
  __syncwarp();
  if (lane == 0) store_release(flag, value);
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// The operands a chunk stages: a and x, and for the backward h_{t−1}.
// The operands a chunk stages: a and x, and for the backward h_{t−1}.
template <bool kReverse>
constexpr int kStagedArrays = kReverse ? 3 : 2;
constexpr int kStagedFloats = kChunk * kLanes;  // one array of one tile

template <bool kReverse>
constexpr int stage_bytes() {
  return kStagedArrays<kReverse> * kStagedFloats * (int)sizeof(float);
}

// This thread's part of a tile: its chunk, channel and first logical step.
struct Tile {
  int id;        // the ticket
  int c;         // the chunk, in the scan's (logical) order
  int ch;        // the channel
  bool live;     // ch < W
  int64_t row0;  // b·S
  int t0;        // this thread's first logical step
};

__device__ __forceinline__ Tile decode(int id, int S, int W, int G, int BG) {
  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x / kLanes;
  Tile t;
  t.id = id;
  t.c = id / BG;
  const int bg = id - t.c * BG;
  const int b = bg / G;
  t.ch = (bg - b * G) * kLanes + lane;
  t.live = t.ch < W;
  t.row0 = (int64_t)b * S;
  t.t0 = t.c * kChunk + warp * kSteps;
  return t;
}

// Issues this thread's cp.async copies of a tile's steps into the stage
// (each thread later reads exactly what it copied).
template <bool kReverse>
__device__ __forceinline__ void stage_tile(const Tile& tl, float* stage,
                                           const float* a, const float* x,
                                           const float* h_fwd, int S,
                                           int W) {
  const int r0 = (threadIdx.x / kLanes) * kSteps * kLanes +
                 (threadIdx.x & (kLanes - 1));
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int tl_i = tl.t0 + i;
    if (!tl.live || tl_i >= S) continue;
    const int t = kReverse ? S - 1 - tl_i : tl_i;  // physical step
    const int64_t off = (tl.row0 + t) * W + tl.ch;
    const int r = r0 + i * kLanes;
    cp_async4(stage + kStagedFloats + r, x + off);
    if (!kReverse) {
      cp_async4(stage + r, a + off);
    } else {
      if (t + 1 < S) cp_async4(stage + r, a + off + W);  // a_{t+1}
      if (t > 0) cp_async4(stage + 2 * kStagedFloats + r, h_fwd + off - W);
    }
  }
}

// A tile after its runs' scans: this thread's local h and prefix products,
// h_{t−1} for the backward, the map from the tile's carry-in to this run's
// (ea, eh) and the tile's aggregate (ta, th).
template <bool kReverse>
struct Scanned {
  Tile tl;
  float hl[kSteps], p[kSteps], hp[kSteps];
  float ea, eh, ta, th;
};

// The runs' scans of a staged tile, then its aggregate published (for
// chunk 0, its inclusive end state).
template <bool kReverse>
__device__ __forceinline__ void scan_runs(Scanned<kReverse>& sc,
                                          const float* stage, int S,
                                          LookBack lb) {
  __shared__ float s_a[kWarps][kLanes];
  __shared__ float s_h[kWarps][kLanes];
  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x / kLanes;
  const int r0 = warp * kSteps * kLanes + lane;
  const Tile& tl = sc.tl;
  // the run's scan from zero: hl ← h_local, p ← P (prefix products)
  float hv = 0.0f, pv = 1.0f;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int tl_i = tl.t0 + i;
    const int t = kReverse ? S - 1 - tl_i : tl_i;
    const int r = r0 + i * kLanes;
    float ai = 1.0f, xi = 0.0f, hi = 0.0f;
    if (tl.live && tl_i < S) {
      xi = stage[kStagedFloats + r];
      if (!kReverse || t + 1 < S) ai = stage[r];
      if (kReverse && t > 0) hi = stage[2 * kStagedFloats + r];
    }
    hv = fmaf(ai, hv, xi);
    pv *= ai;
    sc.hl[i] = hv;
    sc.p[i] = pv;
    sc.hp[i] = hi;
  }
  s_a[warp][lane] = pv;
  s_h[warp][lane] = hv;
  __syncthreads();
  float ta = 1.0f, th = 0.0f;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    if (v == warp) {
      sc.ea = ta;
      sc.eh = th;
    }
    th = fmaf(s_a[v][lane], th, s_h[v][lane]);
    ta *= s_a[v][lane];
  }
  sc.ta = ta;
  sc.th = th;
  if (warp == 0) {
    const int64_t slot = (int64_t)tl.id * kLanes + lane;
    if (tl.c == 0) {
      lb.inc_h[slot] = th;
    } else {
      lb.agg_a[slot] = ta;
      lb.agg_h[slot] = th;
    }
    publish(lb.flags + tl.id, tl.c == 0 ? kInclusive : kAggregate, lane);
  }
}

// The tile's carry by decoupled look-back, its inclusive end state
// published, then the fix-up, stored once.
template <bool kReverse>
__device__ __forceinline__ void finish_tile(const Scanned<kReverse>& sc,
                                            float* __restrict__ out,
                                            float* __restrict__ out_da,
                                            int S, int W, int BG,
                                            LookBack lb) {
  __shared__ int s_flag[kWarps];
  __shared__ float s_a[kWarps][kLanes];
  __shared__ float s_h[kWarps][kLanes];
  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x / kLanes;
  const Tile& tl = sc.tl;
  const int c = tl.c;
  // warp v reads chunk j0 − v; the carry is acc_h + acc_a·(the inclusive
  // state where the walk stops)
  float carry = 0.0f;
  if (c > 0) {
    float acc_a = 1.0f, acc_h = 0.0f;
    bool done = false;
    for (int j0 = c - 1; !done; j0 -= kWarps) {
      const int j = j0 - warp;
      int f = kInclusive;
      float va = 0.0f, vh = 0.0f;  // j < 0: h_{−1} = 0
      if (j >= 0) {
        const int pred = tl.id - (c - j) * BG;
        while ((f = load_acquire(lb.flags + pred)) == kEmpty) {
          __nanosleep(32);
        }
        const int64_t ps = (int64_t)pred * kLanes + lane;
        if (f == kInclusive) {
          vh = __ldcg(lb.inc_h + ps);
        } else {
          va = __ldcg(lb.agg_a + ps);
          vh = __ldcg(lb.agg_h + ps);
        }
      }
      __syncthreads();  // the shared values of the round before are read
      if (lane == 0) s_flag[warp] = f;
      s_a[warp][lane] = va;
      s_h[warp][lane] = vh;
      __syncthreads();
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        if (!done) {
          acc_h = fmaf(acc_a, s_h[v][lane], acc_h);
          acc_a *= s_a[v][lane];
          done = s_flag[v] == kInclusive;
        }
      }
    }
    carry = acc_h;
    if (warp == 0) {
      lb.inc_h[(int64_t)tl.id * kLanes + lane] = fmaf(sc.ta, carry, sc.th);
      publish(lb.flags + tl.id, kInclusive, lane);
    }
  }
  // h_t = h_local_t + P_t·(this run's carry-in)
  const float cin = fmaf(sc.ea, carry, sc.eh);
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int tl_i = tl.t0 + i;
    if (tl.live && tl_i < S) {
      const int t = kReverse ? S - 1 - tl_i : tl_i;
      const int64_t off = (tl.row0 + t) * W + tl.ch;
      const float v = fmaf(sc.p[i], cin, sc.hl[i]);
      __stcs(out + off, v);
      if (kReverse) __stcs(out_da + off, v * sc.hp[i]);
    }
  }
}

// kReverse = false: x = u, out = h.  kReverse = true: x = dh, h_fwd = the
// forward's h, out = du, out_da = da.  A persistent block takes tiles by
// ticket: it scans a tile's runs and publishes its aggregate, then copies
// the next tile's operands into shared memory (cp.async) while it looks
// back for the tile's carry and stores it.
template <bool kReverse>
__global__ void __launch_bounds__(kTileThreads, kReverse ? 3 : 4)
rglru_chunked_kernel(const float* __restrict__ a, const float* __restrict__ x,
                     const float* __restrict__ h_fwd, float* __restrict__ out,
                     float* __restrict__ out_da, int S, int W, int G, int BG,
                     int tiles, LookBack lb) {
  extern __shared__ float stage[];  // [kStagedArrays][kChunk][kLanes]
  __shared__ int s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(lb.ticket, 1);
  __syncthreads();
  int cur = s_ticket;
  if (cur >= tiles) return;
  Scanned<kReverse> sc;
  sc.tl = decode(cur, S, W, G, BG);
  stage_tile<kReverse>(sc.tl, stage, a, x, h_fwd, S, W);
  cp_async_commit();
  cp_async_wait<0>();
  scan_runs<kReverse>(sc, stage, S, lb);
  while (true) {
    __syncthreads();  // the ticket and the stage are read
    if (threadIdx.x == 0) s_ticket = atomicAdd(lb.ticket, 1);
    __syncthreads();
    const int nxt = s_ticket;
    if (nxt < tiles) {
      stage_tile<kReverse>(decode(nxt, S, W, G, BG), stage, a, x, h_fwd, S,
                           W);
      cp_async_commit();
    }
    finish_tile<kReverse>(sc, out, out_da, S, W, BG, lb);
    if (nxt >= tiles) break;
    sc.tl = decode(nxt, S, W, G, BG);
    cp_async_wait<0>();
    scan_runs<kReverse>(sc, stage, S, lb);
  }
}

// The workspace's layout (repro_torch/kernels/rglru_scan.py::work_bytes):
// the ticket in the first 16 bytes, T flags padded to 16 bytes, then the
// three (T, 32) f32 arrays.
inline LookBack carve(void* work, int64_t tiles) {
  char* p = (char*)work;
  LookBack lb;
  lb.ticket = (int*)p;
  lb.flags = (int*)(p + 16);
  float* vals = (float*)(p + 16 + ((tiles + 3) / 4) * 16);
  lb.agg_a = vals;
  lb.agg_h = vals + tiles * kLanes;
  lb.inc_h = vals + 2 * tiles * kLanes;
  return lb;
}

template <bool kReverse>
int launch_chunked(const float* a, const float* x, const float* h_fwd,
                   float* out, float* out_da, void* work, int B, int S,
                   int W, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaSuccess;
  const int64_t G = (W + kLanes - 1) / kLanes;
  const int64_t tiles = (S + kChunk - 1) / kChunk * B * G;
  if (B * G > 0x7fffffff || tiles > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  // a persistent grid: as many blocks as the card holds at once
  auto kernel = rglru_chunked_kernel<kReverse>;
  const int smem = stage_bytes<kReverse>();
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kTileThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = tiles < (int64_t)sms * per_sm
                             ? tiles : (int64_t)sms * per_sm;
  const LookBack lb = carve(work, tiles);
  err = cudaMemsetAsync(work, 0, 16 + ((tiles + 3) / 4) * 16, stream);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kTileThreads, smem, stream>>>(
      a, x, h_fwd, out, out_da, S, W, (int)G, (int)(B * G), (int)tiles, lb);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// The walk route.
extern "C" int rglru_scan_launch(const float* a, const float* u, float* h,
                                 int B, int S, int W, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaSuccess;
  const int w_blocks = (W + kScanThreads - 1) / kScanThreads;
  if ((int64_t)B * w_blocks > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  rglru_scan_kernel<<<B * w_blocks, kScanThreads, 0, (cudaStream_t)stream>>>(
      a, u, h, S, W, w_blocks);
  return (int)cudaGetLastError();
}

// The chunked route; `work` holds
// repro_torch/kernels/rglru_scan.py::work_bytes(B, S, W) bytes.
extern "C" int rglru_chunked_launch(const float* a, const float* u, float* h,
                                    void* work, int B, int S, int W,
                                    void* stream) {
  return repro_torch::launch_chunked<false>(a, u, nullptr, h, nullptr, work,
                                            B, S, W, (cudaStream_t)stream);
}

// The backward: (da, du) from a, the forward's h and dh, the chunked
// kernel in reverse time.
extern "C" int rglru_scan_bwd_launch(const float* a, const float* h,
                                     const float* dh, float* da, float* du,
                                     void* work, int B, int S, int W,
                                     void* stream) {
  return repro_torch::launch_chunked<true>(a, dh, h, du, da, work, B, S, W,
                                           (cudaStream_t)stream);
}
