// K1 with d = 2 as a template parameter (see knn.cu).
#include "knn.cuh"

namespace flgp_k1 {
int launch_d2(const Args& a) { return launch_fixed<2>(a); }
}  // namespace flgp_k1
