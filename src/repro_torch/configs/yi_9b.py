"""yi-9b [dense]: 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000
— llama-arch GQA [arXiv:2403.04652; hf].

Counterpart of ``repro/configs/yi_9b.py``."""
import torch

from repro_torch.configs import lm_common
from repro_torch.models import transformer as tr

ARCH_ID = "yi-9b"
FAMILY = "lm"
SHAPES = list(lm_common.SHAPES)


def full_config():
    return tr.TransformerConfig(
        name=ARCH_ID, n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
        d_ff=11008, vocab=64000, rope_theta=5e6, norm="rmsnorm",
        gated_mlp=True, activation="silu")


def smoke_config():
    return tr.TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=96, vocab=128, rope_theta=1e4, block_q=8,
        loss_chunk=8, compute_dtype=torch.float32)


def cell(shape):
    return lm_common.cells_for(ARCH_ID, full_config())[shape]()


def smoke_run(seed=0, device=None):
    return lm_common.smoke_lm(smoke_config(), seed, device)
