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
// Two launches on one stream: (A) local_steps_kernel, one block per
// client, writes q and e'; (B) the shared epilogue (epilogue.cuh) with
// per-element η_s and corr.
//
// Bound: G is the big operand (n·dz²·4 bytes, 8 MB at n = 8, dz = 512)
// and the K steps do 2·K·n·dz² flops on it (33.5 MFLOP there): read once
// from device memory G takes ~2.5 µs on an H100.  This simple design does
// not reach that: one block per client runs on n of the 132 SMs, and each
// of the K steps streams the client's G slice (dz²·4 bytes, 1 MB at dz =
// 512) again from L2.  Inside a block, z, z₀, c and step live in shared
// memory (dz ≤ 1024: ≤ 20 KB), each warp takes rows of G with its lanes
// striding the row (coalesced 128-byte reads) and reduces with shuffles.
// Holding each client's G slice on chip across the K steps (a cluster of
// blocks sharing it) is the next step for speed.
//
// Quantizer op order is the reference's, which keeps q + e' == v bitwise:
// s = max|v| · f32(1/127) (a block max), v / safe as an IEEE division,
// rintf (round half to even, as jnp.round and torch.round), clip, q · safe.
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

// grid = n (one block per client); dynamic shared memory 5·dz floats.
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

}  // namespace repro_torch

// q: (n, dz) scratch written by launch A and read by launch B.
extern "C" int fused_round_launch(
    const float* w, const float* z0, const float* c, const float* ef,
    const float* g, const float* h, const float* step, const float* etas,
    const float* corr, const float* mask, float* z_out, float* c_out,
    float* e_out, float* q, int n, int dz, int K, int compress,
    int bf16, void* stream_ptr) {
  using namespace repro_torch;
  if (dz > kMaxDz || dz <= 0 || n <= 0 || compress < 0 || compress > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
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
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ArrayScales sc{etas, corr};
  return (int)launch_gossip_epilogue(w, q, z0, c, z_out, c_out, n,
                                     (int64_t)dz, bf16 != 0, sc, stream);
}
