"""The port's codecs: ``fp_torch`` / ``fp64_torch`` (f32 and f64 chunk
codecs), ``bp_torch`` (BP32 / BP64), ``lz4_torch`` (the LZ4 match search),
``pack_funnel`` (residual packing) and ``fp_cuda`` (the CUDA kernels and
their plain versions)."""
