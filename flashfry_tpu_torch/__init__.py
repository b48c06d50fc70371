"""flashfry_tpu_torch: flashfry_tpu's off-target discovery and guide scoring
on PyTorch + CUDA.

The port of the JAX package to one NVIDIA Hopper GPU. The host code
(genome indexing, site finding, the database, the numpy scan, hit
collection, output rendering, the scoring models, and the native C++ in
csrc/flashfry_native.cpp) is the package's own copy of flashfry_tpu's,
module for module under the same names; the device path (plane upload, the
stage-1 scan kernel in csrc/stage1.cu, the exact recount, the comparison
counter, and the scoring descriptor kernel in csrc/descriptors.cu) is
re-implemented here on torch. Nothing in this package imports jax or
flashfry_tpu.
"""

__version__ = "0.1.0"
