// The decode cross-attention kernels (cross_attention.cuh) at head dim 128,
// compiled apart from the others so that the build runs them side by side.
#include "cross_attention.cuh"

OWC_CROSS_DEFINE(128)
