"""Decoder-only LM, serving side: the dense archs of
``repro.models.transformer`` (qwen3-14b, h2o-danube-3-4b, gemma3-12b).

GQA with separate ``n_kv_heads``, explicit ``head_dim``, optional qk-norm,
sliding-window attention, a local:global layer pattern, RoPE, RMSNorm, a
SwiGLU FFN and a tied or untied vocab head.  Parameters are a plain dict,
as in the reference, with the layers as a list of per-layer dicts instead
of arrays stacked on a leading [L] axis; weights keep the reference's
``x @ W`` ([in, out]) layout.

Entry points: ``prefill`` (build the KV cache, return the last logits) and
``decode_step`` (one token against the cache).  With ``attn_impl="flash"``
prefill's attention runs the flash kernel, under the reference's condition:
no KV override (decode keeps the plain path) and no local:global pattern.
Training (``loss_fn``, remat) and MoE layers are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import common

NEG_INF = -1e30
ATTN_IMPLS = ("xla", "flash")


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's fields and defaults; ``remat``, ``aux_loss_weight``
    and ``scan_unroll`` change nothing in serving and exist so a JAX config
    dict carries across (``carry.lm_config_from_dict``)."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    qk_norm: bool = False
    window: int = 0          # sliding-window width for local layers; 0=full
    local_global: int = 0    # N local layers per 1 global layer; 0=all global
    rope_theta: float = 1e4
    tie_embeddings: bool = True
    moe: Optional[Any] = None  # must stay None: MoE is not ported yet
    dtype: torch.dtype = torch.float32
    remat: str = "none"      # training only; no effect on serving
    attn_impl: str = "xla"   # 'xla' | 'flash' (flash needs uniform windows)
    aux_loss_weight: float = 0.01  # MoE training only; no effect here
    act_spec: Any = None     # must stay None: no sharding in the port yet
    scan_unroll: bool = False  # the layer loop is a Python loop here

    def __post_init__(self):
        if self.moe is not None:
            raise ValueError("MoE layers are not ported (models/moe.py)")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} is not one of "
                             f"{ATTN_IMPLS}")
        if self.act_spec is not None:
            raise ValueError("act_spec: the port does not shard activations")

    @property
    def windows(self) -> List[int]:
        """Per-layer window (0 = full attention)."""
        return [0 if self.local_global > 0
                and (l + 1) % (self.local_global + 1) == 0 else self.window
                for l in range(self.n_layers)]

    def n_params(self) -> int:
        d, dh = self.d_model, self.head_dim
        attn = d * dh * (self.n_heads * 2 + self.n_kv_heads * 2)
        per_layer = attn + 3 * d * self.d_ff + 2 * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d


Params = Dict[str, Any]


# --------------------------------------------------------------- params ---

def _layer_init(gen: torch.Generator, cfg: LMConfig, device) -> Params:
    d, dh = cfg.d_model, cfg.head_dim

    def dense(shape):
        return common.dense_init(gen, shape, dtype=cfg.dtype, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=cfg.dtype, device=device)

    p = {"ln1": zeros(d), "ln2": zeros(d),
         "wq": dense((d, cfg.n_heads * dh)),
         "wk": dense((d, cfg.n_kv_heads * dh)),
         "wv": dense((d, cfg.n_kv_heads * dh)),
         "wo": dense((cfg.n_heads * dh, d))}
    if cfg.qk_norm:
        p["q_norm"], p["k_norm"] = zeros(dh), zeros(dh)
    p["ffn"] = {"w_gate": dense((d, cfg.d_ff)), "w_up": dense((d, cfg.d_ff)),
                "w_down": dense((cfg.d_ff, d))}
    return p


def init(cfg: LMConfig, gen: torch.Generator, device=None) -> Params:
    """Random weights drawn from ``gen`` on ``device`` (the generator's)."""
    device = device if device is not None else gen.device
    params = {"embed": common.embed_init(gen, (cfg.vocab, cfg.d_model),
                                         dtype=cfg.dtype, device=device),
              "layers": [_layer_init(gen, cfg, device)
                         for _ in range(cfg.n_layers)],
              "ln_f": torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                                  device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = common.dense_init(
            gen, (cfg.d_model, cfg.vocab), dtype=cfg.dtype, device=device)
    return params


# ------------------------------------------------------------ attention ---

def _attn_scores_mask(pos_q, pos_k, window: int) -> torch.Tensor:
    """bool mask [..., Sq, Sk]: causal and (window==0 or distance < window)."""
    d = pos_q[..., :, None] - pos_k[..., None, :]
    return (d >= 0) & ((window <= 0) | (d < window))


def _attention_xla(q, k, v, pos_q, pos_k, window: int) -> torch.Tensor:
    """The plain path.  q: [B,Sq,H,Dh]; k,v: [B,Sk,Hkv,Dh]."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, dh)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float()
    scores = scores / (dh ** 0.5)
    mask = _attn_scores_mask(pos_q, pos_k, window)  # [B,Sq,Sk] or [Sq,Sk]
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores,
                         torch.full((), NEG_INF, device=scores.device))
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", p, v)
    return out.reshape(b, sq, h, dh)


KVOverride = Callable[[torch.Tensor, torch.Tensor],
                      tuple]  # (k, v) -> (k_all, v_all, pos_k)


def _layer_fwd(cfg: LMConfig, p: Params, x, positions, window: int,
               kv_override: Optional[KVOverride] = None):
    """One decoder layer.  x: [B,S,D].  Returns (y, (k, v))."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    h = common.rms_norm(x, p["ln1"])
    q = (h @ p["wq"]).view(b, s, cfg.n_heads, dh)
    k = (h @ p["wk"]).view(b, s, cfg.n_kv_heads, dh)
    v = (h @ p["wv"]).view(b, s, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = common.rms_norm(q, p["q_norm"])
        k = common.rms_norm(k, p["k_norm"])
    # RoPE is elementwise per (position, head): [B,S,H,Dh] against [B,S,1]
    q = common.rope(q, positions[:, :, None], cfg.rope_theta)
    k = common.rope(k, positions[:, :, None], cfg.rope_theta)
    if kv_override is not None:
        k_all, v_all, pos_k = kv_override(k, v)
    else:
        k_all, v_all, pos_k = k, v, positions
    if cfg.attn_impl == "flash" and kv_override is None \
            and cfg.local_global == 0:
        out = fa.mha(q.transpose(1, 2), k_all.transpose(1, 2),
                     v_all.transpose(1, 2), causal=True,
                     window=cfg.window).transpose(1, 2)
    else:
        out = _attention_xla(q, k_all, v_all, positions, pos_k, window)
    x = x + out.reshape(b, s, cfg.n_heads * dh) @ p["wo"]
    h = common.rms_norm(x, p["ln2"])
    f = p["ffn"]
    y = (torch.nn.functional.silu(h @ f["w_gate"]) * (h @ f["w_up"])) \
        @ f["w_down"]
    return x + y, (k, v)


def _logits(cfg: LMConfig, params: Params, x) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head).float()


# -------------------------------------------------------------- serving ---

def prefill(params: Params, tokens: torch.Tensor, cfg: LMConfig,
            cache_len: int):
    """tokens: int[B,S] -> (cache, last_logits f32[B,V]).

    cache = {'k','v': [L,B,cache_len,Hkv,Dh], 'pos': S}; the slots past S
    are zero, as the reference pads them.
    """
    b, s = tokens.shape
    dev = params["embed"].device
    shape = (cfg.n_layers, b, cache_len, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=dev), "pos": s}
    x = params["embed"][tokens.long()]
    positions = torch.arange(s, device=dev).expand(b, s)
    for l, (p, window) in enumerate(zip(params["layers"], cfg.windows)):
        x, (k, v) = _layer_fwd(cfg, p, x, positions, window)
        cache["k"][l, :, :s] = k
        cache["v"][l, :, :s] = v
    x = common.rms_norm(x[:, -1], params["ln_f"])
    return cache, _logits(cfg, params, x)


def decode_step(params: Params, cache: Dict, tok: torch.Tensor,
                cfg: LMConfig):
    """One-token decode.  tok: int[B] -> (logits f32[B,V], cache).

    The cache is written in place (the reference returns a new one) and
    its 'pos' advanced.  This step's k/v go to slot min(pos, cache_len-1):
    the reference's ``dynamic_update_slice`` clamps its start index the
    same way once ``pos`` passes the cache.
    """
    b = tok.shape[0]
    cache_len = cache["k"].shape[2]
    pos = cache["pos"]
    dev = cache["k"].device
    slot = min(pos, cache_len - 1)
    x = params["embed"][tok.long()[:, None]]  # [B,1,D]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=dev)
    pos_k = torch.arange(cache_len, device=dev)
    # unwritten slots are masked through their key position
    pos_k = torch.where(pos_k <= pos, pos_k, 2 ** 30).expand(b, cache_len)
    for l, (p, window) in enumerate(zip(params["layers"], cfg.windows)):
        x, _ = _layer_fwd(cfg, p, x, positions, window,
                          _cache_writer(cache["k"][l], cache["v"][l], slot,
                                        pos_k))
    x = common.rms_norm(x[:, 0], params["ln_f"])
    cache["pos"] = pos + 1
    return _logits(cfg, params, x), cache


def _cache_writer(kc, vc, slot: int, pos_k) -> KVOverride:
    def kv_override(k_new, v_new):
        kc[:, slot] = k_new[:, 0]
        vc[:, slot] = v_new[:, 0]
        return kc, vc, pos_k
    return kv_override
