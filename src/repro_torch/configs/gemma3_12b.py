"""gemma3-12b [hf:google/gemma-3-12b-pt]: 48L d_model=3840 16H (GQA kv=8)
head_dim=256 d_ff=15360 vocab=262144, 5:1 local:global attention (local
window 1024); as ``repro.configs.gemma3_12b``.  Its layer pattern keeps
attention on the plain path whatever ``attn_impl`` says."""
import torch

from repro_torch.configs.lm_shapes import lm_shapes
from repro_torch.models import transformer as tf

FAMILY = "lm"
SHAPES = lm_shapes(long_context_ok=True)


def config(dtype=torch.bfloat16, **kw):
    return tf.LMConfig(
        name="gemma3-12b", n_layers=48, d_model=3840, n_heads=16,
        n_kv_heads=8, head_dim=256, d_ff=15360, vocab=262144,
        window=1024, local_global=5, rope_theta=1e6, dtype=dtype, **kw)


def smoke_config(**kw):
    return tf.LMConfig(
        name="gemma3-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=256, window=8,
        local_global=2, dtype=torch.float32, **kw)
