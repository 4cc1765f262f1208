// The failsafe cells (infw_torch/failsaferules.py): the (proto, dst_port)
// pairs an enforce-mode policy never rewrites.  Shared by K10
// (score_update.cu) and K11 (payload_match.cu); a CPU test holds the two
// lists equal to kernels/mxu_score.py FAILSAFE_TCP / FAILSAFE_UDP.
#pragma once

namespace failsafe_cells {

constexpr int kProtoTCP = 6;
constexpr int kProtoUDP = 17;

__constant__ int kFailsafeTcp[] = {22, 2379, 2380, 6443, 10250, 10257, 10259};
__constant__ int kFailsafeUdp[] = {68};

__device__ __forceinline__ bool failsafe(int proto, int dport) {
  if (proto == kProtoTCP) {
#pragma unroll
    for (int k = 0; k < (int)(sizeof(kFailsafeTcp) / sizeof(int)); ++k)
      if (dport == kFailsafeTcp[k]) return true;
  } else if (proto == kProtoUDP) {
#pragma unroll
    for (int k = 0; k < (int)(sizeof(kFailsafeUdp) / sizeof(int)); ++k)
      if (dport == kFailsafeUdp[k]) return true;
  }
  return false;
}

}  // namespace failsafe_cells
