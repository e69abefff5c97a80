"""h2o-danube-3-4b [arXiv:2401.16818]: 24L d_model=3840 32H (GQA kv=8)
d_ff=10240 vocab=32000, sliding-window attention (window 4096, all
layers); as ``repro.configs.h2o_danube_3_4b``."""
import torch

from repro_torch.configs.lm_shapes import lm_shapes
from repro_torch.models import transformer as tf

FAMILY = "lm"
SHAPES = lm_shapes(long_context_ok=True)


def config(dtype=torch.bfloat16, **kw):
    return tf.LMConfig(
        name="h2o-danube-3-4b", n_layers=24, d_model=3840, n_heads=32,
        n_kv_heads=8, head_dim=120, d_ff=10240, vocab=32000,
        window=4096, rope_theta=1e4, dtype=dtype, **kw)


def smoke_config(**kw):
    return tf.LMConfig(
        name="danube-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, head_dim=8, d_ff=128, vocab=256, window=16,
        dtype=torch.float32, **kw)
