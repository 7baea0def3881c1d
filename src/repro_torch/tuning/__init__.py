"""Kernel tuning: a persistent cache of searched launch configurations.

Counterpart of ``repro/tuning/``:

- ``cache`` — the JSON ``TuningCache`` keyed by (kernel, shape, dtype,
  backend), empty (with ``load_error`` saying why) when its file is
  absent, corrupt or stale, so every consumer keeps its heuristic;
- ``candidates``/``autotune`` — the candidate spaces and the timing
  loop (``autotune_graph`` tunes every problem a deployed graph emits);
- ``warmup`` — replays cached winners before serving.

Consumers: ``core/passes/kernel_opt.py`` binds cached winners at design
point 3 (``deploy(..., tuning_cache=...)``); ``launch/serve.py`` exposes
``--tune`` / ``--tuning-cache``. The backends are ``"cuda"`` (the
kernels) and ``"cpu"`` (their plain versions).
"""
from repro_torch.tuning.autotune import (autotune_graph,
                                         graph_kernel_problems,
                                         tune_edge_aggregate,
                                         tune_flash_attention,
                                         tune_fused_dense, tune_gravnet,
                                         tune_gravnet_block,
                                         tune_knn_aggregate, tune_knn_build)
from repro_torch.tuning.cache import (SCHEMA_VERSION, KernelKey, TuningCache,
                                      TuningEntry, edge_aggregate_key,
                                      flash_attention_key, fused_dense_key,
                                      gravnet_block_int8_key,
                                      gravnet_block_key, gravnet_key,
                                      knn_aggregate_key, knn_build_key)
from repro_torch.tuning.warmup import make_warmup, warm_from_cache

__all__ = [
    "SCHEMA_VERSION", "KernelKey", "TuningCache", "TuningEntry",
    "autotune_graph", "edge_aggregate_key", "flash_attention_key",
    "fused_dense_key", "graph_kernel_problems", "gravnet_block_int8_key",
    "gravnet_block_key", "gravnet_key", "knn_aggregate_key",
    "knn_build_key", "make_warmup", "tune_edge_aggregate",
    "tune_flash_attention", "tune_fused_dense", "tune_gravnet",
    "tune_gravnet_block", "tune_knn_aggregate", "tune_knn_build",
    "warm_from_cache",
]
