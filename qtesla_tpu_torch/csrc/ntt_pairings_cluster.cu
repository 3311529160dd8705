// The cluster forms of the five pairings' pass kernel (pairing_pass.cuh):
// R = 32 in three passes (n = 32768) or four (n = 65536, 131072), a row
// across a thread-block cluster of 2, 4 or 8 blocks (pass_stages.cuh).
// They are instantiated here, apart from the block forms of
// ntt_pairings.cu, whose launchers take them through cluster_pass_kernel,
// so that the two compile side by side.

#include "pairing_pass.cuh"

namespace qt {
namespace pairing {

template <int FWD, int INV>
PassKernel cluster_pass_kernel(int passes) {
    if (passes == 3) return pass_kernel<FWD, INV, 32, 3, 0, true>;
    if (passes == 4) return pass_kernel<FWD, INV, 32, 4, 0, true>;
    return nullptr;
}

template PassKernel cluster_pass_kernel<kDif, kDit>(int);
template PassKernel cluster_pass_kernel<kDit, kDit>(int);
template PassKernel cluster_pass_kernel<kDif, kDif>(int);
template PassKernel cluster_pass_kernel<kDit, kDif>(int);
template PassKernel cluster_pass_kernel<kStk, kStk>(int);

}  // namespace pairing
}  // namespace qt
