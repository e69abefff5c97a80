"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B]: 48L d_model=2048
16H (GQA kv=16) expert d_ff=1408 vocab=163840, MoE 64 experts top-6 (+2
shared experts; every layer MoE, as the reference runs it); as
``repro.configs.moonshot_v1_16b_a3b``."""
import torch

from repro_torch.configs.lm_shapes import lm_shapes
from repro_torch.models import moe, transformer as tf

FAMILY = "lm"
SHAPES = lm_shapes(long_context_ok=False)


def config(dtype=torch.bfloat16, **kw):
    m = moe.MoEConfig(n_experts=64, top_k=6, d_model=2048, d_ff=1408,
                      n_shared_experts=2, **kw.pop("moe_kw", {}))
    return tf.LMConfig(
        name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
        n_kv_heads=16, head_dim=128, d_ff=1408, vocab=163840, moe=m,
        rope_theta=5e4, dtype=dtype, **kw)


def smoke_config(**kw):
    m = moe.MoEConfig(n_experts=4, top_k=2, d_model=64, d_ff=32,
                      n_shared_experts=1, **kw.pop("moe_kw", {}))
    return tf.LMConfig(
        name="moonshot-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=32, vocab=256, moe=m,
        dtype=torch.float32, **kw)
