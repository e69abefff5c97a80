"""qwen3-14b [hf:Qwen/Qwen3-14B]: 40L d_model=5120 40H (GQA kv=8)
d_ff=17408 vocab=151936, qk-norm, full attention; as
``repro.configs.qwen3_14b``."""
import torch

from repro_torch.configs.lm_shapes import lm_shapes
from repro_torch.models import transformer as tf

FAMILY = "lm"
SHAPES = lm_shapes(long_context_ok=False)


def config(dtype=torch.bfloat16, **kw):
    return tf.LMConfig(
        name="qwen3-14b", n_layers=40, d_model=5120, n_heads=40,
        n_kv_heads=8, head_dim=128, d_ff=17408, vocab=151936,
        qk_norm=True, tie_embeddings=False, rope_theta=1e6, dtype=dtype,
        **kw)


def smoke_config(**kw):
    return tf.LMConfig(
        name="qwen3-14b-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, head_dim=8, d_ff=128, vocab=256, qk_norm=True,
        tie_embeddings=False, dtype=torch.float32, **kw)
