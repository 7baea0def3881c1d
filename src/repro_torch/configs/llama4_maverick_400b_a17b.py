"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1 + 1 shared expert
[hf:meta-llama/Llama-4; unverified]. Its cells train with int8-quantized
Adam moments (``lm_common.opt_config(quantize=True)``).

Counterpart of ``repro/configs/llama4_maverick_400b_a17b.py``."""
import torch

from repro_torch.configs import lm_common
from repro_torch.models import transformer as tr

ARCH_ID = "llama4-maverick-400b-a17b"
FAMILY = "lm"
SHAPES = list(lm_common.SHAPES)


def full_config():
    return tr.TransformerConfig(
        name=ARCH_ID, n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab=202048, rope_theta=5e5, norm="rmsnorm",
        gated_mlp=True, activation="silu",
        moe=tr.MoEConfig(n_experts=128, top_k=1, group_size=512,
                         shared_experts=1))


def smoke_config():
    return tr.TransformerConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=48, vocab=128, rope_theta=1e4, block_q=8,
        loss_chunk=8, compute_dtype=torch.float32,
        moe=tr.MoEConfig(n_experts=8, top_k=1, group_size=16,
                         shared_experts=1))


def cell(shape):
    return lm_common.cells_for(ARCH_ID, full_config(),
                               quantize_opt=True)[shape]()


def smoke_run(seed=0, device=None):
    return lm_common.smoke_lm(smoke_config(), seed, device)
