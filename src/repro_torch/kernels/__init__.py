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

Four GravNet and kNN kernels share the cell in ``csrc/gravnet_cell.cuh``:
the whole of it, or its selection or its accumulation half;
``gravnet_block_int8`` runs the same cell with its distance row in
registers (``csrc/gravnet_cell_reg.cuh``). The two int8 kernels share
the tensor-core product (``csrc/mma_s8.cuh``) and the division-free
quantization (``csrc/int8_quant.cuh``). ``int8_cases.py`` makes the
inputs that stress them; ``phase_split.py`` times the int8 block's
phases on the card.
``ops.py`` routes by device (CPU tensor -> plain version in ``ref.py``,
CUDA tensor -> kernel); ``_build.py`` compiles ``csrc/`` with ``nvcc``
at first use. Nothing builds when a module is imported.
"""
