// The decode cross-attention kernels (cross_attention.cuh) at head dim 16,
// compiled apart from the others so that the build runs them side by side.
#include "cross_attention.cuh"

OWC_CROSS_DEFINE(16)
