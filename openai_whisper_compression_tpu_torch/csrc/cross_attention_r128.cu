// The RAGGED decode cross-attention kernels (cross_attention.cuh) of
// capacity 128: the head dims below 128 that it serves, each taken at run
// time. Compiled apart so that the build runs the instances side by side.
#include "cross_attention.cuh"

OWC_CROSS_DEFINE_RAGGED(128)
