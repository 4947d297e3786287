// Fused gossip epilogue for one packed variable.
//
// Replaces repro/kernels/gossip.py::fused_gossip_nd (the Pallas kernel
// behind mixing_impl="pallas_packed"):
//
//   θ' = Wθ + η_s·WΔ,   c' = c + s·(Δ − WΔ)
//
// over W (n, n) and Δ, θ, c (n, D) f32, with scalar η_s and s.  Bound and
// design: see epilogue.cuh.  Plain version: repro_torch/kernels/ref.py::
// fused_gossip_ref.
#include "epilogue.cuh"

extern "C" int fused_gossip_launch(const float* w, const float* delta,
                                   const float* theta, const float* c,
                                   float* theta_out, float* c_out, int n,
                                   long long D, float eta_s, float corr_scale,
                                   int bf16, void* stream) {
  repro_torch::ScalarScales sc{eta_s, corr_scale};
  return (int)repro_torch::launch_gossip_epilogue(
      w, delta, theta, c, theta_out, c_out, n, (int64_t)D, bf16 != 0, sc,
      (cudaStream_t)stream);
}
