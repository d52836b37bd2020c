// K1 with d = 3 as a template parameter (see knn.cu).
#include "knn.cuh"

namespace flgp_k1 {
int launch_d3(const Args& a) { return launch_fixed<3>(a); }
}  // namespace flgp_k1
