// K2's fused multiply-add variant (see lae.cu).
#include "lae.cuh"

namespace flgp_k2 {
int launch_fused(const Args& a) { return launch<true>(a); }
}  // namespace flgp_k2
