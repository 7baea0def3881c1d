"""granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — llama-arch, code [arXiv:2405.04324; hf].
(granite-34b-code uses non-gated GELU MLP — d_ff=24576 is the full
expansion.)

Counterpart of ``repro/configs/granite_34b.py``."""
import torch

from repro_torch.configs import lm_common
from repro_torch.models import transformer as tr

ARCH_ID = "granite-34b"
FAMILY = "lm"
SHAPES = list(lm_common.SHAPES)


def full_config():
    return tr.TransformerConfig(
        name=ARCH_ID, n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24576, vocab=49152, rope_theta=1e7, norm="rmsnorm",
        gated_mlp=False, activation="gelu")


def smoke_config():
    return tr.TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, d_ff=128, vocab=128, rope_theta=1e4, block_q=8,
        loss_chunk=8, gated_mlp=False, activation="gelu",
        compute_dtype=torch.float32)


def cell(shape):
    return lm_common.cells_for(ARCH_ID, full_config())[shape]()


def smoke_run(seed=0, device=None):
    return lm_common.smoke_lm(smoke_config(), seed, device)
