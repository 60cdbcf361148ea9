// The RAGGED fused cache update + decode self-attention kernels and the
// read-only attention (self_attention_step.cuh) of capacity 16: the head
// dims it serves, each taken at run time. Compiled apart so that the
// build runs the instances side by side.
#include "self_attention_step.cuh"

OWC_SA_DEFINE(r16, 16, true)
