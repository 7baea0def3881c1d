"""Print the reference's cells as JSON: for every cell of
``repro.configs.all_cells(include_paper=True)``, in order, its kind,
``model_flops`` and, leaf for leaf of its abstract arguments, the shape,
dtype, logical spec and the local shard shape at the (16, 16) and
(2, 16, 16) production meshes (``NamedSharding.shard_shape``).

Run as a script in its own process: it asks XLA for 512 host devices
before JAX starts. ``tests/test_torch_cells.py`` runs it once;
arguments ``arch:shape ...`` keep only those cells.
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs  # noqa: E402
from repro.dist.sharding import _path_str  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402


def _spec(p):
    return [list(e) if isinstance(e, tuple) else e for e in p]


def main():
    meshes = {"single": make_production_mesh(),
              "multi": make_production_mesh(multi_pod=True)}
    out = []
    keep = set(sys.argv[1:])
    for arch, shape, mod in configs.all_cells(include_paper=True):
        if keep and f"{arch}:{shape}" not in keep:
            continue
        cell = mod.cell(shape)
        args = cell.abstract_args()
        leaves = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(args)[0]:
            leaves[_path_str(path)] = {"shape": list(leaf.shape),
                                       "dtype": str(leaf.dtype)}
        specs = jax.tree_util.tree_flatten_with_path(
            cell.spec_args(), is_leaf=lambda x: isinstance(x, P))[0]
        for path, spec in specs:
            leaves[_path_str(path)]["spec"] = _spec(spec)
        for tag, mesh in meshes.items():
            shs = jax.tree_util.tree_flatten_with_path(
                cell.resolve_shardings(mesh))[0]
            by_path = dict(jax.tree_util.tree_flatten_with_path(args)[0])
            for path, sh in shs:
                leaf = by_path[path]
                leaves[_path_str(path)][tag] = list(
                    sh.shard_shape(leaf.shape))
        out.append({"arch": arch, "shape": shape, "kind": cell.kind,
                    "model_flops": cell.model_flops, "leaves": leaves})
    json.dump(out, sys.stdout)


if __name__ == "__main__":
    main()
