"""The port of the design flow, CaloClusterNet and the executor.

Exports what ``repro.core`` exports, resolved at first use: the kernels'
plain versions import ``core.quantization``, and the executor imports
the kernels, so the package loads none of its modules eagerly."""
import importlib

_EXPORTS = {"Graph": "graph_ir", "Operator": "graph_ir",
            "Requirements": "passes.parallelize",
            "BucketedPipeline": "pipeline", "CompiledPipeline": "pipeline",
            "deploy": "pipeline", "deploy_bucketed": "pipeline"}
_MODULES = ("caloclusternet", "condensation", "quantization")

__all__ = sorted([*_EXPORTS, *_MODULES])


def __getattr__(name):
    if name in _EXPORTS:
        mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(mod, name)
    if name in _MODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
