"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].

Counterpart of ``repro/configs/granite_moe_1b_a400m.py``."""
import torch

from repro_torch.configs import lm_common
from repro_torch.models import transformer as tr

ARCH_ID = "granite-moe-1b-a400m"
FAMILY = "lm"
SHAPES = list(lm_common.SHAPES)


def full_config():
    return tr.TransformerConfig(
        name=ARCH_ID, n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=512, vocab=49155, rope_theta=1e4, norm="rmsnorm",
        gated_mlp=True, activation="silu",
        moe=tr.MoEConfig(n_experts=32, top_k=8, group_size=512))


def smoke_config():
    return tr.TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=32, vocab=128, rope_theta=1e4, block_q=8,
        loss_chunk=8, compute_dtype=torch.float32,
        moe=tr.MoEConfig(n_experts=4, top_k=2, group_size=16))


def cell(shape):
    return lm_common.cells_for(ARCH_ID, full_config())[shape]()


def smoke_run(seed=0, device=None):
    return lm_common.smoke_lm(smoke_config(), seed, device)
