"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-235B-A22B family]: 94L d_model=4096
64H (GQA kv=4) expert d_ff=1536 vocab=151936, MoE 128 experts top-8,
qk-norm; as ``repro.configs.qwen3_moe_235b_a22b``."""
import torch

from repro_torch.configs.lm_shapes import lm_shapes
from repro_torch.models import moe, transformer as tf

FAMILY = "lm"
SHAPES = lm_shapes(long_context_ok=False)


def config(dtype=torch.bfloat16, **kw):
    m = moe.MoEConfig(n_experts=128, top_k=8, d_model=4096, d_ff=1536,
                      **kw.pop("moe_kw", {}))
    return tf.LMConfig(
        name="qwen3-moe-235b-a22b", n_layers=94, d_model=4096, n_heads=64,
        n_kv_heads=4, head_dim=128, d_ff=1536, vocab=151936, moe=m,
        qk_norm=True, tie_embeddings=False, rope_theta=1e6, dtype=dtype,
        **kw)


def smoke_config(**kw):
    m = moe.MoEConfig(n_experts=4, top_k=2, d_model=64, d_ff=32,
                      **kw.pop("moe_kw", {}))
    return tf.LMConfig(
        name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, head_dim=8, d_ff=32, vocab=256, moe=m, qk_norm=True,
        tie_embeddings=False, dtype=torch.float32, **kw)
