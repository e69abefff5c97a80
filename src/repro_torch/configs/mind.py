"""mind [arXiv:1904.08030]: embed_dim=64 n_interests=4 capsule_iters=3,
multi-interest dynamic routing over a 2^21-row item table; as
``repro.configs.mind``."""
from repro_torch.models.recsys import mind as model

FAMILY = "recsys"
MODULE = model

SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512, n_cand=2048),
    "serve_bulk": dict(kind="serve", batch=262144, n_cand=256),
    "retrieval_cand": dict(kind="serve", batch=1, n_cand=1_000_000),
}


def config(**kw):
    base = dict(n_items=2 ** 21, embed_dim=64, seq_len=50, n_interests=4,
                capsule_iters=3, n_neg=1024, profile_vocab=8192,
                profile_len=8)
    base.update(kw)
    return model.MINDConfig(**base)


def smoke_config(**kw):
    base = dict(n_items=256, embed_dim=16, seq_len=8, n_interests=4,
                capsule_iters=3, n_neg=16, profile_vocab=32, profile_len=4)
    base.update(kw)
    return model.MINDConfig(**base)
