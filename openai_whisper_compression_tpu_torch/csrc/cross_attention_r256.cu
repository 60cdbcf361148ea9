// The RAGGED decode cross-attention kernels (cross_attention.cuh) of
// capacity 256: head dims 129..256 (256 itself too: it has no whole body),
// each taken at run time. Compiled apart so that the build runs the
// instances side by side.
#include "cross_attention.cuh"

OWC_CROSS_DEFINE_RAGGED(256)
