// The instantiations of the shared bf16 attention backward pair
// (merged_bwd_tc.cuh), behind mcl_bwd_tc::launch: K6's (no mask, the scale
// after the products) and K2's and K2-bd's four (causal or not, kv_mask or
// not, dS * D^-1/2 rounded), each at head dims 16, 32 and 64.  Built once
// here; K2, K2-bd and K6's entry points call launch.

#include "merged_attention.cuh"  // with_head_dim
#include "merged_bwd_tc.cuh"

namespace mcl_bwd_tc {

cudaError_t launch(const BwdParams& p, int D, bool causal, bool masked, bool scale_first,
                   cudaStream_t stream) {
  if (p.B <= 0 || p.T <= 0 || p.H <= 0 || p.ws == nullptr ||
      (masked && p.kv_mask == nullptr) || (!scale_first && (causal || masked)))
    return cudaErrorInvalidValue;
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (!scale_first) return launch_bwd_tc<kD, BwdCfg<false, false, false>>(p, stream);
    if (causal)
      return masked ? launch_bwd_tc<kD, BwdCfg<true, true, true>>(p, stream)
                    : launch_bwd_tc<kD, BwdCfg<true, false, true>>(p, stream);
    return masked ? launch_bwd_tc<kD, BwdCfg<false, true, true>>(p, stream)
                  : launch_bwd_tc<kD, BwdCfg<false, false, true>>(p, stream);
  });
}

}  // namespace mcl_bwd_tc
