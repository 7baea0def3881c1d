"""Hand-written Hopper kernels of the port and their plain versions.

- ``fused_dense``   : act(x @ w + b), f32 (``csrc/fused_dense.cu``).
- ``gravnet_block`` : the fused GravNet block — S/F prologue, kNN cell,
                      output-dense epilogue — in one launch
                      (``csrc/gravnet_block.cu``, ``csrc/gravnet_cell.cuh``).

``ops.py`` routes by device (CPU tensor -> plain version in ``ref.py``,
CUDA tensor -> kernel); ``_build.py`` compiles ``csrc/`` with ``nvcc``
at first use. Nothing builds when a module is imported.
"""
