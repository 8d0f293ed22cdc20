"""Device ops: the hand-written CUDA serving kernels (cross_kernel), the
int8 weight quantizer (quantize), the per-bucket variant autotune
(autotune) and the host<->device transfer packing (transfer). Importing
this package builds nothing; kernels compile at first launch."""
