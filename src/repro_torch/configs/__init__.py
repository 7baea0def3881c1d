"""Architecture registry: ``--arch <id>`` resolution for the training
driver and the tests. Counterpart of ``repro/configs/__init__.py``: the
reference's 11 ids (10 assigned archs and the paper's own), every one
ported: the five LMs, MIND, the four GNNs (DimeNet, GatedGCN,
GraphSAGE, NequIP) and CaloClusterNet.

Each module's ``cell(shape)`` gives a ``configs.base.Cell``;
:func:`all_cells` walks them in the reference's order.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "yi-9b": "repro_torch.configs.yi_9b",
    "granite-34b": "repro_torch.configs.granite_34b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "llama4-maverick-400b-a17b":
        "repro_torch.configs.llama4_maverick_400b_a17b",
    "dimenet": "repro_torch.configs.dimenet",
    "gatedgcn": "repro_torch.configs.gatedgcn",
    "graphsage-reddit": "repro_torch.configs.graphsage_reddit",
    "nequip": "repro_torch.configs.nequip",
    "mind": "repro_torch.configs.mind",
    "caloclusternet": "repro_torch.configs.caloclusternet",
}

ASSIGNED = [a for a in _MODULES if a != "caloclusternet"]


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {list(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id])


def all_cells(include_paper: bool = False):
    """Yield every (arch, shape, module) — 40 assigned (+3 paper)."""
    ids = list(ASSIGNED) + (["caloclusternet"] if include_paper else [])
    for arch_id in ids:
        mod = get_arch(arch_id)
        for shape in mod.SHAPES:
            yield arch_id, shape, mod
