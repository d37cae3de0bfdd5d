"""Hand-written CUDA kernels of the fused violation path: sources in
csrc/, the nvcc build in build.py, wrappers and plain torch versions in
ops.py."""
