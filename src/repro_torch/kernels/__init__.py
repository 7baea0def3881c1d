"""Hand-written Hopper kernels of the port and their plain versions.

- ``fused_dense``        : act(x @ w + b), f32 (``csrc/fused_dense.cu``).
- ``fused_dense_int8``   : the quantized dense — int8 × int8 into exact
                           int32 sums, dequant, bias, activation, optional
                           int8 requant (``csrc/fused_dense_int8.cu``).
- ``gravnet_aggregate``  : the unfused GravNet kNN aggregation
                           (``csrc/gravnet_aggregate.cu``).
- ``gravnet_block``      : the fused GravNet block — S/F prologue, kNN
                           cell, output-dense epilogue — in one launch
                           (``csrc/gravnet_block.cu``).
- ``gravnet_block_int8`` : its quantized form, the serve default's block
                           (``csrc/gravnet_block_int8.cu``).
- ``knn_build``          : the ragged path's segment-masked kNN selection
                           over bin-packed events (``csrc/knn_build.cu``).
- ``knn_aggregate``      : the ragged path's mean/max over the selected
                           rows (``csrc/knn_aggregate.cu``).
- ``edge_aggregate``     : the edge-based GNNs' masked segment sum/mean
                           of edge messages into their destination nodes
                           (``csrc/edge_aggregate.cu``).
- ``flash_attention``    : blockwise streaming-softmax attention, the
                           ``attention`` op's kernel, its (bq, bk) blocks
                           tunable (``csrc/flash_attention.cu``).

The three kernels that run the whole GravNet cell (``gravnet_block``,
``gravnet_block_int8``, ``gravnet_aggregate``) keep a row's distances in
registers (``csrc/gravnet_cell_reg.cuh``) up to 512 hits and d_f 128,
``knn_build`` runs its selection half up to 512 hits and
``knn_aggregate`` its accumulation half up to d_f 128; past those the
f32 ones run the shared-memory cell of ``csrc/gravnet_cell.cuh`` (the
first designs). The two int8 kernels share the tensor-core product
(``csrc/mma_s8.cuh``) and the division-free quantization
(``csrc/int8_quant.cuh``). ``int8_cases.py`` and ``f32_cases.py`` make
the inputs that stress the kernels; ``phase_split.py`` times a GravNet
or kNN kernel's phases on the card and ``source_ab.py`` times the f32
kernels against an earlier revision of their sources.
``ops.py`` routes by device (CPU tensor -> plain version in ``ref.py``,
CUDA tensor -> kernel); ``_build.py`` compiles ``csrc/`` with ``nvcc``
at first use. Nothing builds when a module is imported.
"""
