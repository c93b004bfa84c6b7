"""The port's codecs: ``fp_torch`` (f32 v2 codec), ``pack_funnel`` (residual
packing) and ``fp_cuda`` (the CUDA kernels and their plain versions)."""
