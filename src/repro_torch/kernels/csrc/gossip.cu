// Fused gossip epilogue for one packed variable, or for both (x and y) in
// one launch.
//
// Replaces repro/kernels/gossip.py::fused_gossip_nd (the Pallas kernel
// behind mixing_impl="pallas_packed"):
//
//   θ' = Wθ + η_s·WΔ,   c' = c + s·(Δ − WΔ)
//
// over Δ, θ (n, D) f32, with scalar η_s and s.  W is a block of n_out rows
// (n_out, n) and c, θ', c' are (n_out, D): out row r is row row0 + r of the
// whole epilogue, its correction reading Δ[row0 + r] (a rank's rows on the
// decentralized mesh, over the gathered Δ and θ); n_out = n, row0 = 0 is
// the epilogue of all of W.  Plain version:
// repro_torch/kernels/ref.py::fused_gossip_ref.
//
// Two routes, chosen in Python by gossip.route (a pure function of n):
//
// * tiled (fused_gossip_launch, the first port): epilogue.cuh's kernel,
//   one launch a variable.  Each thread walks the n rows in a loop with a
//   runtime trip count, two dependent-latency loads an iteration: at the
//   main path's n = 8 a launch costs ~8 memory round trips.
// * unrolled (fused_gossip_pair_launch, below) for n ≤ kMaxUnrolledN: n is
//   a template parameter, and a thread issues every Δ, θ and c load of its
//   columns (16 bytes a row where D and the alignment allow) before its
//   first FMA, so a launch costs about one memory round trip; both
//   variables share one launch (blocks [0, bx) are x's columns, the rest
//   y's).  At large D each thread keeps 3·n 16-byte loads in flight.  The
//   rule looks at the contraction length n only.  A row block (ROWS) is an
//   instantiation of its own, so the whole epilogue's code is unchanged:
//   its out rows are a run-time count, and past row 0 it reads its own Δ
//   rows again for the correction (cache hits).
//
// Both routes sum each output in the same order (j ascending, fmaf from
// 0) and end with the same expressions, so they agree bit for bit.  Bound:
// 5·n·D·4 bytes against 4·n²·D flops, memory-bound (epilogue.cuh).
#include "epilogue.cuh"

extern "C" int fused_gossip_launch(const float* w, const float* delta,
                                   const float* theta, const float* c,
                                   float* theta_out, float* c_out, int n,
                                   int n_out, int row0, long long D,
                                   float eta_s, float corr_scale, int bf16,
                                   void* stream) {
  if (n_out < 0 || n_out > n || row0 < 0 || row0 > n - n_out)
    return (int)cudaErrorInvalidValue;
  repro_torch::ScalarScales sc{eta_s, corr_scale};
  return (int)repro_torch::launch_gossip_epilogue_rows(
      w, delta, theta, c, theta_out, c_out, n, n_out, row0, (int64_t)D,
      bf16 != 0, sc, (cudaStream_t)stream);
}

namespace repro_torch {

constexpr int kUnrolledThreads = 64;
constexpr int kMaxUnrolledN = 8;

// one variable of the pair
struct EpiVar {
  const float* delta;
  const float* theta;
  const float* c;
  float* theta_out;
  float* c_out;
  int64_t D;
  float eta, corr;
  unsigned blocks;  // blocks of this variable's columns
  int vec;          // 16-byte rows: D % 4 == 0 and every pointer aligned
};

__device__ __forceinline__ void load_cols(float (&v)[4], const float* p,
                                          int cols) {
  if (cols == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

// columns [d0, d0 + V) of the out rows over all N source rows: every load
// first, then the sums.  ROWS: out rows [row0, row0 + n_out), n_out ≤ N;
// else all N rows from row 0.
template <int N, bool BF16, bool ROWS, int V>
__device__ __forceinline__ void unrolled_columns(const float (*ws)[N],
                                                 const EpiVar& v, int64_t d0,
                                                 int n_out, int row0) {
  float dv[N][4], tv[N][4], cv[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int64_t off = (int64_t)j * v.D + d0;
    load_cols(dv[j], v.delta + off, V);
    load_cols(tv[j], v.theta + off, V);
    if (!ROWS || j < n_out) load_cols(cv[j], v.c + off, V);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (ROWS && i >= n_out) break;
    // out row i's own Δ row, row0 + i: the loaded row where the block
    // starts at row 0, else read again (a cache hit); a register array
    // indexed at run time would live in local memory
    float own[4];
    if (!ROWS || row0 == 0) {
#pragma unroll
      for (int q = 0; q < V; ++q) own[q] = dv[i][q];
    } else {
      load_cols(own, v.delta + (int64_t)(row0 + i) * v.D + d0, V);
    }
    float ad[V], at[V];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      ad[q] = 0.f;
      at[q] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float w = ws[i][j];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        ad[q] = fmaf(w, narrow<BF16>(dv[j][q]), ad[q]);
        at[q] = fmaf(w, narrow<BF16>(tv[j][q]), at[q]);
      }
    }
    float to[4], co[4];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      to[q] = at[q] + v.eta * ad[q];
      co[q] = cv[i][q] + v.corr * (own[q] - ad[q]);
    }
    const int64_t off = (int64_t)i * v.D + d0;
    if (V == 4) {
      *reinterpret_cast<float4*>(v.theta_out + off) =
          make_float4(to[0], to[1], to[2], to[3]);
      *reinterpret_cast<float4*>(v.c_out + off) =
          make_float4(co[0], co[1], co[2], co[3]);
    } else {
      v.theta_out[off] = to[0];
      v.c_out[off] = co[0];
    }
  }
}

// grid = x.blocks + y.blocks blocks of kUnrolledThreads; a thread owns 4
// columns (vec) or 1 of one variable.  w is (n_out, N) (ROWS) or (N, N).
template <int N, bool BF16, bool ROWS>
__global__ void __launch_bounds__(kUnrolledThreads)
unrolled_gossip_kernel(const float* __restrict__ w, EpiVar x, EpiVar y,
                       int n_out, int row0) {
  __shared__ float ws[N][N];
  const bool is_x = blockIdx.x < x.blocks;
  const EpiVar v = is_x ? x : y;
  const unsigned b = is_x ? blockIdx.x : blockIdx.x - x.blocks;
  if (threadIdx.x < (ROWS ? n_out : N) * N)
    ws[threadIdx.x / N][threadIdx.x % N] = narrow<BF16>(w[threadIdx.x]);
  __syncthreads();
  const int64_t g = (int64_t)b * kUnrolledThreads + threadIdx.x;
  if (v.vec) {
    if (4 * g < v.D)
      unrolled_columns<N, BF16, ROWS, 4>(ws, v, 4 * g, n_out, row0);
  } else {
    if (g < v.D) unrolled_columns<N, BF16, ROWS, 1>(ws, v, g, n_out, row0);
  }
}

template <int N, bool BF16>
cudaError_t launch_unrolled(const float* w, const EpiVar& x, const EpiVar& y,
                            int n_out, int row0, cudaStream_t stream) {
  const unsigned blocks = x.blocks + y.blocks;
  if (n_out == N && row0 == 0)
    unrolled_gossip_kernel<N, BF16, false>
        <<<blocks, kUnrolledThreads, 0, stream>>>(w, x, y, n_out, row0);
  else
    unrolled_gossip_kernel<N, BF16, true>
        <<<blocks, kUnrolledThreads, 0, stream>>>(w, x, y, n_out, row0);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_unrolled_n(int n, const float* w, const EpiVar& x,
                              const EpiVar& y, int n_out, int row0,
                              cudaStream_t stream) {
  switch (n) {
    case 1: return launch_unrolled<1, BF16>(w, x, y, n_out, row0, stream);
    case 2: return launch_unrolled<2, BF16>(w, x, y, n_out, row0, stream);
    case 3: return launch_unrolled<3, BF16>(w, x, y, n_out, row0, stream);
    case 4: return launch_unrolled<4, BF16>(w, x, y, n_out, row0, stream);
    case 5: return launch_unrolled<5, BF16>(w, x, y, n_out, row0, stream);
    case 6: return launch_unrolled<6, BF16>(w, x, y, n_out, row0, stream);
    case 7: return launch_unrolled<7, BF16>(w, x, y, n_out, row0, stream);
    case 8: return launch_unrolled<8, BF16>(w, x, y, n_out, row0, stream);
  }
  return cudaErrorInvalidValue;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

inline EpiVar epi_var(const float* delta, const float* theta, const float* c,
                      float* theta_out, float* c_out, long long D, float eta,
                      float corr) {
  const bool vec = D % 4 == 0 && aligned16(delta) && aligned16(theta) &&
                   aligned16(c) && aligned16(theta_out) && aligned16(c_out);
  const long long cols = vec ? D / 4 : D;
  const unsigned long long blocks =
      (cols + kUnrolledThreads - 1) / kUnrolledThreads;
  return EpiVar{delta, theta, c, theta_out, c_out, (int64_t)D, eta, corr,
                (unsigned)blocks, vec ? 1 : 0};
}

}  // namespace repro_torch

// The unrolled route over one or two variables (Dy = 0: x alone), n ≤ 8:
// out rows [row0, row0 + n_out) of the epilogue, W (n_out, n), c and the
// outputs (n_out, D).
extern "C" int fused_gossip_pair_launch(
    const float* w, const float* dx, const float* tx, const float* cx,
    float* tox, float* cox, long long Dx, float eta_x, float corr_x,
    const float* dy, const float* ty, const float* cy, float* toy,
    float* coy, long long Dy, float eta_y, float corr_y, int n, int n_out,
    int row0, int bf16, void* stream) {
  using namespace repro_torch;
  if (n <= 0 || n > kMaxUnrolledN || Dx < 0 || Dy < 0 || n_out < 0 ||
      n_out > n || row0 < 0 || row0 > n - n_out)
    return (int)cudaErrorInvalidValue;
  constexpr long long kMaxD = 0x3fffffffLL * kUnrolledThreads;
  if (Dx > kMaxD || Dy > kMaxD) return (int)cudaErrorInvalidConfiguration;
  const EpiVar x = epi_var(dx, tx, cx, tox, cox, Dx, eta_x, corr_x);
  const EpiVar y = epi_var(dy, ty, cy, toy, coy, Dy, eta_y, corr_y);
  const unsigned long long blocks = (unsigned long long)x.blocks + y.blocks;
  if (blocks == 0 || n_out == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffULL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(bf16 ? launch_unrolled_n<true>(n, w, x, y, n_out, row0, st)
                    : launch_unrolled_n<false>(n, w, x, y, n_out, row0, st));
}
