"""Meshes, the H100's constants, and the serving layer's replica
placement.

The ``H100_*`` constants model the card the port runs on: the design
flow's cost model (``core/passes/parallelize.py``, platform "h100")
prices each op with them, ``CompiledPipeline.resource_report`` reports
a segment's working set against the card's L2 and its launches' share of
the SMs, and the dry-run's roofline (``launch/analysis.py``) uses the
datasheet rates. Two kinds sit here, each with its source on its line:

- datasheet figures of the NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor
  Core GPU datasheet, SXM5 column, dense rates without sparsity): a
  model's, not measurements;
- three figures measured on the card by ``python -m
  repro_torch.launch.h100_model`` (NVIDIA H100 80GB HBM3, power limit
  700.00 W, as ``nvidia-smi --query-gpu=name,power.limit
  --format=csv,noheader`` prints them): the device time one small plain
  kernel launch costs inside a captured chunk, the same for a hand
  kernel's launch, and the rate of the plain PyTorch ops that the
  executor runs outside the hand kernels.

A number the model gives is a model's; a time on the card comes only
from a run there (``chip_smoke.py`` phase 19 holds the model against
the card's busy time per chunk).

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

# NVIDIA H100 SXM5 80GB datasheet figures (NVIDIA H100 Tensor Core GPU
# datasheet, SXM5 column, dense rates without sparsity, at 700 W).
# Dense bf16 tensor-core peak: 989.4 TFLOP/s.
H100_PEAK_FLOPS_BF16 = 989e12
# Dense int8 tensor-core peak: 1,979 TOPS (the int8 dense's mma.sync).
H100_PEAK_OPS_INT8 = 1979e12
# f32 outside the tensor cores: 67 TFLOP/s, an FMA counted as two
# operations (132 SMs x 128 FP32 lanes x 2 x 1.98 GHz boost).
H100_PEAK_FLOPS_F32 = 67e12
# The f32 rate of the kernels built with -fmad=false (every source but
# flash_attention.cu, kernels/_build.py): without FMA a multiply and an
# add are two instructions, each one operation, at the same issue rate,
# so half the datasheet's figure.
H100_PEAK_FLOPS_F32_NO_FMA = H100_PEAK_FLOPS_F32 / 2
# HBM3 bandwidth of the SXM5 80GB part: 3.35 TB/s.
H100_HBM_BW = 3.35e12
# Streaming multiprocessors of the SXM5 part: 132.
H100_SMS = 132
# L2 cache: 50 MB (the CUDA runtime reports 52,428,800 bytes on the card).
H100_L2_BYTES = 50 * 1024 * 1024

# Measured on the card (python -m repro_torch.launch.h100_model; NVIDIA
# H100 80GB HBM3, 700.00 W): the profiler's busy time of one small
# plain PyTorch kernel launch inside a captured CUDA graph (read
# 1.4764953e-06 s).
H100_LAUNCH_S = 1.4765e-6
# Measured on the card (the same script and card): the busy time of one
# hand-kernel launch at the smallest served shape, (128, 32) -> 7, f32
# and int8 denses, inside a captured graph: the launch and a CTA's
# staging round trip, which a plain elementwise kernel does not make
# (read 2.4367430e-06 s).
H100_KERNEL_LAUNCH_S = 2.4367e-6
# Measured on the card (the same script and card): the f32 elements a
# second that plain PyTorch elementwise ops (add, mul, where, sigmoid) run
# at on large tensors, inside a captured graph: the rate the cost model
# prices a plain op's counted operations at (read 2.6248410e+11).
H100_PLAIN_FLOPS = 2.6248e11

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

