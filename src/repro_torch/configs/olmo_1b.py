"""olmo-1b [dense]: 16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304
— non-parametric LayerNorm, non-gated SwiGLU-free MLP
[arXiv:2402.00838; hf].

Counterpart of ``repro/configs/olmo_1b.py``."""
import torch

from repro_torch.configs import lm_common
from repro_torch.models import transformer as tr

ARCH_ID = "olmo-1b"
FAMILY = "lm"
SHAPES = list(lm_common.SHAPES)


def full_config():
    return tr.TransformerConfig(
        name=ARCH_ID, n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab=50304, rope_theta=1e4, norm="nonparametric",
        gated_mlp=False, activation="silu")


def smoke_config():
    return tr.TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=128, rope_theta=1e4, block_q=8,
        loss_chunk=8, norm="nonparametric", gated_mlp=False,
        compute_dtype=torch.float32)


def cell(shape):
    return lm_common.cells_for(ARCH_ID, full_config())[shape]()


def smoke_run(seed=0, device=None):
    return lm_common.smoke_lm(smoke_config(), seed, device)
