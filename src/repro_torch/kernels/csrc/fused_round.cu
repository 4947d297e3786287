// The whole Algorithm-1 round over the packed z = (x; y).
//
// Replaces repro/kernels/fused_round.py::fused_round_nd (the Pallas kernel
// behind mixing_impl="fused_round"), including the quantizer of
// repro/kernels/quantize.py::quantize_dequant that runs inside it:
//
//   repeat K:  z ← z − step ⊙ (G z + h_k + c)         (G: (n, dz, dz))
//   Δ = z_K − z₀
//   q = Δ, or  v = mask ⊙ (Δ + e), q = Q(v), e' = mask > 0 ? v − q : e
//   z' = W z₀ + η_s ⊙ W q,   c' = c + corr ⊙ (q − W q)
//
// Two launches on one stream: (A) the K local steps, which write q and e';
// (B) the shared epilogue (epilogue.cuh) with per-element η_s and corr.
//
// Bound: G is the big operand (n·dz²·4 bytes, 8 MB at n = 8, dz = 512)
// and the K steps do 2·K·n·dz² flops on it (33.5 MFLOP there): read once
// from device memory G takes ~2.5 µs on an H100.
//
// Launch A has two routes, chosen by repro_torch/kernels/fused_round.py::
// route.
//
// Cluster route (local_steps_cluster_kernel): G is read from device memory
// once and held on chip across the K steps.  A thread-block cluster of cs
// blocks (the smallest of 1, 2, 4, 8 with at most 64 rows a block: 8 at
// dz = 512, 1 at dz = 15) serves one client; block r holds rows
// [r·R, r·R + R) of the client's G (R = ⌈dz/cs⌉) in registers — 64 floats
// a thread of 512, 128 KB a block at dz = 512, read with coalesced loads.
// Each step a block computes its rows of G z (z from shared memory into
// registers; a lane sums columns lane + 32j of each row in order and the
// warp xor-reduces: the block route's order, so Δ is the same bits), and
// sends each new z entry to every block of the cluster with st.async into
// its shared memory, which completes 4 bytes of the transaction on that
// block's mbarrier; a block waits only for its own dz entries.  z is
// double-buffered (entries of step k + 1 never land in the buffer step k
// reads).  The int8 quantizer's max|v| is reduced across the cluster
// through distributed shared memory and one cluster barrier before the
// scale.  dz past 512 (16 columns a lane) takes the block route.
//
// Why registers and st.async: from shared memory each step re-reads the
// block's 128 KB of G, and a cluster barrier a step compiles to a
// GPU-scope fence (MEMBAR.ALL.GPU) and an L1 invalidate; both cost more
// than the step's arithmetic on the H100.
//
// Block route (local_steps_kernel, the first port): one block per client
// on n of the 132 SMs, and each of the K steps streams the client's G
// slice (dz²·4 bytes, 1 MB at dz = 512) again from L2.  Inside a block z,
// z₀, c and step live in shared memory (dz ≤ 1024: ≤ 20 KB), each warp
// takes rows of G with its lanes striding the row (coalesced 128-byte
// reads) and reduces with shuffles.
//
// Quantizer op order is the reference's, which keeps q + e' == v bitwise:
// s = max|v| · f32(1/127) (a block, or cluster, max), v / safe as an IEEE
// division, rintf (round half to even, as jnp.round and torch.round),
// clip, q · safe.
#include <cooperative_groups.h>

#include "epilogue.cuh"

namespace repro_torch {

constexpr int kStepThreads = 512;
constexpr int kMaxDz = 1024;
constexpr float kInv127 = 0x1.020408p-7f;  // float32(1/127)

enum Compress { kNone = 0, kBf16 = 1, kInt8 = 2 };

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x / 32) ? red[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// The block route: grid = n (one block per client); dynamic shared memory
// 5·dz floats.
template <int COMPRESS>
__global__ void __launch_bounds__(kStepThreads)
local_steps_kernel(const float* __restrict__ z0, const float* __restrict__ c,
                   const float* __restrict__ ef, const float* __restrict__ g,
                   const float* __restrict__ h, const float* __restrict__ step,
                   const float* __restrict__ mask, float* __restrict__ q_out,
                   float* __restrict__ e_out, int n, int dz, int K) {
  extern __shared__ float sm[];
  float* z = sm;             // current iterate
  float* zs = sm + dz;       // z₀
  float* cs = sm + 2 * dz;   // c row
  float* ss = sm + 3 * dz;   // step row
  float* gr = sm + 4 * dz;   // G z, then v
  __shared__ float red[32];

  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)i * dz;
  const float* gi = g + (int64_t)i * dz * dz;
  for (int r = tid; r < dz; r += blockDim.x) {
    const float v = z0[row0 + r];
    z[r] = v;
    zs[r] = v;
    cs[r] = c[row0 + r];
    ss[r] = step[row0 + r];
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
  for (int k = 0; k < K; ++k) {
    for (int r = warp; r < dz; r += nwarps) {
      const float* grow = gi + (int64_t)r * dz;
      float acc = 0.f;
      for (int col = lane; col < dz; col += 32)
        acc = fmaf(grow[col], z[col], acc);
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) gr[r] = acc;
    }
    __syncthreads();
    const float* hk = h + ((int64_t)k * n + i) * dz;
    for (int r = tid; r < dz; r += blockDim.x)
      z[r] = z[r] - ss[r] * ((gr[r] + hk[r]) + cs[r]);
    __syncthreads();
  }

  float amax = 0.f;
  for (int r = tid; r < dz; r += blockDim.x) {
    const float dv = z[r] - zs[r];
    if (COMPRESS == kNone) {
      q_out[row0 + r] = dv;
      e_out[row0 + r] = ef[row0 + r];
    } else {
      const float v = mask[row0 + r] * (dv + ef[row0 + r]);
      gr[r] = v;
      if (COMPRESS == kInt8) amax = fmaxf(amax, fabsf(v));
    }
  }
  if (COMPRESS == kNone) return;
  float s = 0.f;
  if (COMPRESS == kInt8) s = block_max(amax, red) * kInv127;
  const float safe = s > 0.f ? s : 1.f;
  for (int r = tid; r < dz; r += blockDim.x) {
    const float v = gr[r];
    float q;
    if (COMPRESS == kBf16) {
      q = narrow_bf16(v);
    } else {
      const float code = fminf(fmaxf(rintf(v / safe), -127.f), 127.f);
      q = s > 0.f ? code * safe : 0.f;
    }
    q_out[row0 + r] = q;
    e_out[row0 + r] = mask[row0 + r] > 0.f ? v - q : ef[row0 + r];
  }
}

// ---------------------------------------------------------------------------
// The cluster route
// ---------------------------------------------------------------------------

constexpr int kClusterThreads = 512;
constexpr int kMaxCluster = 8;                          // the portable size
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kRowsPerWarp * kClusterWarps;  // 64
constexpr int kMaxClusterDz = 512;
constexpr int kColsPerLane = kMaxClusterDz / 32;             // 16

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the address of this block's shared `addr` in block `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// one arrival (the barrier's only one) that also expects `bytes` of data
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// v into the shared word at cluster address `dst`, completing 4 bytes of
// the transaction that the mbarrier at cluster address `bar` expects
__device__ __forceinline__ void st_async(uint32_t dst, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(dst),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// grid = n·cs blocks in clusters of cs (one cluster per client), R ≤ 64
// rows a block; dynamic shared memory 2·dz + 2·R + 8 floats.
template <int COMPRESS>
__global__ void __launch_bounds__(kClusterThreads)
local_steps_cluster_kernel(const float* __restrict__ z0,
                           const float* __restrict__ c,
                           const float* __restrict__ ef,
                           const float* __restrict__ g,
                           const float* __restrict__ h,
                           const float* __restrict__ step,
                           const float* __restrict__ mask,
                           float* __restrict__ q_out, float* __restrict__ e_out,
                           int n, int dz, int K, int R) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  extern __shared__ float sm[];
  float* zb = sm;                 // [2][dz] the iterate, double-buffered
  float* z0s = zb + 2 * dz;       // [R] this block's rows of z₀
  float* vs = z0s + R;            // [R] ... of v
  float* amaxs = vs + R;          // [kMaxCluster] max|v| by rank
  __shared__ float red[32];
  // full[b]: the z entries of buffer b have all arrived (dz·4 bytes a step)
  __shared__ uint64_t full[2];

  const int i = blockIdx.x / cs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = rank * R;
  const int rn = max(0, min(R, dz - r0));  // rows this block owns
  const int64_t row0 = (int64_t)i * dz;

  // 1. this block's rows of G into registers, once: gr[rr][j] is
  // G[r0 + warp + 16·rr][lane + 32·j]; z₀ whole; this block's z₀; the
  // warp's rows of c, step and h_0 into registers
  float gr[kRowsPerWarp][kColsPerLane];
  float cr[kRowsPerWarp], sr[kRowsPerWarp], hv[kRowsPerWarp];
  const float* gi = g + (row0 + r0) * dz;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp + kClusterWarps * rr;
    const bool in = r < rn;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int col = lane + 32 * j;
      gr[rr][j] = in && col < dz ? gi[(int64_t)r * dz + col] : 0.f;
    }
    cr[rr] = in ? c[row0 + r0 + r] : 0.f;
    sr[rr] = in ? step[row0 + r0 + r] : 0.f;
    hv[rr] = in && K > 0 ? h[(int64_t)i * dz + r0 + r] : 0.f;
  }
  for (int r = tid; r < dz; r += kClusterThreads) zb[r] = z0[row0 + r];
  for (int r = tid; r < rn; r += kClusterThreads) z0s[r] = z0[row0 + r0 + r];
  // z_m (m ≥ 1) lands in zb[m % 2], tracked by full[m % 2] in its phase
  // (m − 1) / 2; arm the barriers of z_1 and z_2
  const int step_bytes = dz * (int)sizeof(float);
  if (tid == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (K >= 1) mbar_expect(&full[1], step_bytes);
    if (K >= 2) mbar_expect(&full[0], step_bytes);
  }
  // every block of the cluster has started, staged and armed its barriers
  cluster.sync();

  // 2. K steps; step k reads zb[k % 2] and writes zb[(k + 1) % 2].  A lane
  // sums its columns of each of its warp's rows in column order, then the
  // warp xor-reduces (the block route's order); every lane ends with the
  // row's sum, and lane j < cs sends the new z entry to block j with
  // st.async, which completes 4 bytes on block j's barrier: no cluster
  // barrier and no fence a step, each block waits for its own dz entries.
  for (int k = 0; k < K; ++k) {
    const float* cur = zb + (k & 1) * dz;
    float* nxt = zb + ((k + 1) & 1) * dz;
    float zr[kColsPerLane], acc[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) acc[rr] = 0.f;
    if (k > 0) {
      mbar_wait(&full[k & 1], ((k - 1) >> 1) & 1);
      // every thread is past the wait before the barrier's next phase (z_{k+2})
      __syncthreads();
      if (tid == 0 && k + 2 <= K) mbar_expect(&full[k & 1], step_bytes);
    }
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int col = lane + 32 * j;
      zr[j] = col < dz ? cur[col] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j)
      if (lane + 32 * j < dz)
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr)
          acc[rr] = fmaf(gr[rr][j], zr[j], acc[rr]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        acc[rr] += __shfl_xor_sync(0xffffffffu, acc[rr], off);
    const uint32_t bar = cluster_addr(smem_addr(&full[(k + 1) & 1]), lane);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp + kClusterWarps * rr;
      if (r < rn && lane < cs) {
        const float zn = cur[r0 + r] - sr[rr] * ((acc[rr] + hv[rr]) + cr[rr]);
        st_async(cluster_addr(smem_addr(nxt + r0 + r), lane), zn, bar);
      }
    }
    if (k + 1 < K) {
      const float* hk = h + ((int64_t)(k + 1) * n + i) * dz + r0;
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp + kClusterWarps * rr;
        hv[rr] = r < rn ? hk[r] : 0.f;
      }
    }
  }
  if (K > 0) mbar_wait(&full[K & 1], ((K - 1) >> 1) & 1);  // z_K is here

  // 3. Δ and the quantizer on this block's rows
  const float* zk = zb + (K & 1) * dz;
  float amax = 0.f;
  for (int r = tid; r < rn; r += kClusterThreads) {
    const int64_t off = row0 + r0 + r;
    const float dv = zk[r0 + r] - z0s[r];
    if (COMPRESS == kNone) {
      q_out[off] = dv;
      e_out[off] = ef[off];
    } else {
      const float v = mask[off] * (dv + ef[off]);
      vs[r] = v;
      if (COMPRESS == kInt8) amax = fmaxf(amax, fabsf(v));
    }
  }
  if (COMPRESS == kNone) return;
  float s = 0.f;
  if (COMPRESS == kInt8) {
    // the client's max|v|: each block's max into every block's slot
    const float mine = block_max(amax, red);
    if (tid < cs) *cluster.map_shared_rank(amaxs + rank, tid) = mine;
    cluster.sync();
    float m = 0.f;
    for (int j = 0; j < cs; ++j) m = fmaxf(m, amaxs[j]);
    s = m * kInv127;
  }
  const float safe = s > 0.f ? s : 1.f;
  for (int r = tid; r < rn; r += kClusterThreads) {
    const int64_t off = row0 + r0 + r;
    const float v = vs[r];
    float q;
    if (COMPRESS == kBf16) {
      q = narrow_bf16(v);
    } else {
      const float code = fminf(fmaxf(rintf(v / safe), -127.f), 127.f);
      q = s > 0.f ? code * safe : 0.f;
    }
    q_out[off] = q;
    e_out[off] = mask[off] > 0.f ? v - q : ef[off];
  }
}

template <int COMPRESS>
cudaError_t launch_cluster_steps(const float* z0, const float* c,
                                 const float* ef, const float* g,
                                 const float* h, const float* step,
                                 const float* mask, float* q, float* e_out,
                                 int n, int dz, int K, int cs,
                                 cudaStream_t stream) {
  const int rows = (dz + cs - 1) / cs;
  // (at most 4.6 KB: no opt-in past 48 KB is needed)
  const size_t bytes =
      (2 * (size_t)dz + 2 * (size_t)rows + kMaxCluster) * sizeof(float);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * cs));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, local_steps_cluster_kernel<COMPRESS>, z0,
                            c, ef, g, h, step, mask, q, e_out, n, dz, K,
                            rows);
}

}  // namespace repro_torch

// q: (n, dz) scratch written by launch A and read by launch B.  cluster:
// 0 for the block route, else the cluster size (1, 2, 4 or 8, with at most
// 64 rows a block) of the cluster route.
extern "C" int fused_round_launch(
    const float* w, const float* z0, const float* c, const float* ef,
    const float* g, const float* h, const float* step, const float* etas,
    const float* corr, const float* mask, float* z_out, float* c_out,
    float* e_out, float* q, int n, int dz, int K, int compress,
    int bf16, int cluster, void* stream_ptr) {
  using namespace repro_torch;
  if (dz > kMaxDz || dz <= 0 || n <= 0 || compress < 0 || compress > 2 ||
      cluster < 0 || cluster > kMaxCluster ||
      (cluster > 0 && ((dz + cluster - 1) / cluster > kRowsPerBlock ||
                       dz > kMaxClusterDz)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err;
  if (cluster > 0) {
    if (compress == kNone)
      err = launch_cluster_steps<kNone>(z0, c, ef, g, h, step, mask, q, e_out,
                                        n, dz, K, cluster, stream);
    else if (compress == kBf16)
      err = launch_cluster_steps<kBf16>(z0, c, ef, g, h, step, mask, q, e_out,
                                        n, dz, K, cluster, stream);
    else
      err = launch_cluster_steps<kInt8>(z0, c, ef, g, h, step, mask, q, e_out,
                                        n, dz, K, cluster, stream);
    if (err != cudaSuccess) return (int)err;
  } else {
    const size_t smem = (size_t)5 * dz * sizeof(float);
    if (compress == kNone)
      local_steps_kernel<kNone><<<n, kStepThreads, smem, stream>>>(
          z0, c, ef, g, h, step, mask, q, e_out, n, dz, K);
    else if (compress == kBf16)
      local_steps_kernel<kBf16><<<n, kStepThreads, smem, stream>>>(
          z0, c, ef, g, h, step, mask, q, e_out, n, dz, K);
    else
      local_steps_kernel<kInt8><<<n, kStepThreads, smem, stream>>>(
          z0, c, ef, g, h, step, mask, q, e_out, n, dz, K);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ArrayScales sc{etas, corr};
  return (int)launch_gossip_epilogue(w, q, z0, c, z_out, c_out, n,
                                     (int64_t)dz, bf16 != 0, sc, stream);
}
