"""Meshes, hardware constants, and the serving layer's replica placement.

The TPU v5e constants are copied from ``repro/launch/mesh.py``: the
design flow's cost model ranks P choices with them (or with the CPU
constants in ``passes/parallelize.py``) so that the port picks the
reference's P and micro-batch, and ``CompiledPipeline.resource_report``
reports the reference's modelled working set against ``VMEM_BYTES``.
They describe a TPU chip, not the H100.

The ``H100_*`` constants are the roofline model of the dry-run
(``launch/analysis.py``). They are datasheet figures, not measurements:
a number the roofline gives is a model's, and a time on the card comes
only from a run there.

The meshes are ``torch.distributed.device_mesh.DeviceMesh`` objects with
the reference's axis names. :func:`make_production_mesh` needs a world
of 256 (or 512) ranks: on the CPU, :func:`fake_world` starts one of the
``fake`` backend (no process per rank, no data moves; a CPU tool only).
:func:`make_host_mesh` is a world of one on the card (NCCL) or the CPU
(gloo), started here if no process group exists.
"""
from __future__ import annotations

import contextlib
import socket

import torch

# TPU v5e hardware constants (the design flow's cost model).
PEAK_FLOPS_BF16 = 197e12      # per chip, FLOP/s
HBM_BW = 819e9                # per chip, B/s
VMEM_BYTES = 128 * 1024 * 1024  # the working-set limit resource_report uses

# NVIDIA H100 SXM5 80GB datasheet figures (the dry-run's roofline model).
# Dense bf16 tensor-core peak, without sparsity: 989.4 TFLOP/s (NVIDIA
# H100 Tensor Core GPU datasheet, SXM5 column).
H100_PEAK_FLOPS_BF16 = 989e12
# HBM3 bandwidth of the SXM5 80GB part: 3.35 TB/s (same datasheet).
H100_HBM_BW = 3.35e12
# The per-GPU link a 256-GPU mesh crosses between its 8-GPU nodes: one
# 400 Gb/s NDR InfiniBand adapter per GPU (DGX H100 reference
# architecture), 400e9 / 8 = 50 GB/s each way.
H100_LINK_BW = 50e9

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def _mesh_device_type() -> str:
    import torch.distributed as dist
    backend = dist.get_backend()
    return "cuda" if backend == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod",
    "data", "model"), over the running world (256 or 512 ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = MULTI_POD_AXES if multi_pod else PRODUCTION_AXES
    return init_device_mesh(_mesh_device_type(), shape,
                            mesh_dim_names=axes)


def traced_mesh(mesh):
    """The mesh a dry-run traces on: ``mesh`` itself, or for the
    multi-pod (pod, data, model) mesh the (pod·data, model) mesh over
    the same ranks, its "data" axis pod × data. DP resolves to (pod,
    data) together, so every shard is the same; each DP collective is
    then one over the 32 ranks, as XLA's partitioner issues it, where
    DTensor would issue one a mesh dim (and its planner searches the
    three dims' placements at every new op)."""
    from torch.distributed.device_mesh import init_device_mesh
    names = tuple(mesh.mesh_dim_names)
    if names != MULTI_POD_AXES:
        return mesh
    shape = tuple(mesh.shape)
    return init_device_mesh(mesh.device_type, (shape[0] * shape[1],
                                               shape[2]),
                            mesh_dim_names=PRODUCTION_AXES)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_host_mesh(device=None):
    """A (1, 1) ("data", "model") mesh: a world of one on ``device``
    (None: the card, over NCCL; ``"cpu"``: gloo). A process group that
    already runs is used as it is (it must then be a world of one)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{_free_port()}",
            world_size=1, rank=0,
            **({"device_id": dev} if dev.type == "cuda" else {}))
    if dist.get_world_size() != 1:
        raise RuntimeError("make_host_mesh needs a world of one, not "
                           f"{dist.get_world_size()}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=PRODUCTION_AXES)


@contextlib.contextmanager
def fake_world(size: int = 256):
    """A process group of ``size`` ranks on the ``fake`` backend (this
    process is rank 0; collectives move nothing), destroyed on exit.
    The backend is registered by importing
    ``torch.testing._internal.distributed.fake_pg``. A CPU tool: meshes
    over it hold fake tensors (``FakeTensorMode``)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group already runs in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def destroy_host_mesh() -> None:
    """End the world :func:`make_host_mesh` started."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def replica_devices(n_replicas: int):
    """Device placement for the sharded serving layer.

    With several visible cards, replica i is pinned to ``cuda:{i %
    count}`` (its lane holds its own copy of the weights there). With
    one card, or none, every entry is ``None``: the replicas are
    thread-backed lanes on the pipeline's device.
    """
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count <= 1:
        return [None] * n_replicas
    return [torch.device(f"cuda:{i % count}") for i in range(n_replicas)]

