"""Decoder-only LM: the archs of ``repro.models.transformer`` (qwen3-14b,
h2o-danube-3-4b, gemma3-12b, and the MoE archs moonshot-v1-16b-a3b and
qwen3-moe-235b-a22b), for training and serving.

GQA with separate ``n_kv_heads``, explicit ``head_dim``, optional qk-norm,
sliding-window attention, a local:global layer pattern, RoPE, RMSNorm, a
SwiGLU FFN or an MoE FFN (``models/moe.py``) and a tied or untied vocab
head.  Parameters are a plain dict, as in the reference, with the layers
as a list of per-layer dicts instead of arrays stacked on a leading [L]
axis; weights keep the reference's ``x @ W`` ([in, out]) layout.

Entry points: ``loss_fn`` (teacher-forced next-token CE plus the MoE aux
loss, for training), ``prefill`` (build the KV cache, return the last
logits) and ``decode_step`` (one token against the cache);
``decode_step_at`` / ``greedy_step`` are that step with the position,
the cache slot and the greedy pick on the card, which the LM server
captures in a CUDA graph (``launch/serve.py``).  Attention is
``xla`` (the materialized scores), ``chunked`` (an online softmax over KV
chunks, which training uses, as the reference's train step does) or
``flash``: the flash kernel, under the reference's condition (no KV
override, so decode keeps the plain path, and no local:global pattern).
The flash kernel has no backward, as the TPU kernel has no VJP: a gradient
through it raises.  ``remat`` recomputes each layer in the backward pass
(``full``) or all but its matmul outputs (``dots``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.sharding import constrain, remat_context, unshard_dim
from repro_torch.models import common, moe as moe_lib

NEG_INF = -1e30
ATTN_IMPLS = ("xla", "flash", "chunked")
REMATS = ("none", "full", "dots")


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's fields and defaults; ``scan_unroll`` changes
    nothing (the layer loop is a Python loop) and exists so a JAX config
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
    moe: Optional[moe_lib.MoEConfig] = None
    dtype: torch.dtype = torch.float32
    remat: str = "none"      # 'none' | 'full' | 'dots' (loss_fn only)
    attn_impl: str = "xla"   # 'xla' | 'flash' | 'chunked'
    aux_loss_weight: float = 0.01  # weight of the MoE aux loss in loss_fn
    act_spec: Any = None     # residual stream's sharding between layers
    scan_unroll: bool = False  # the layer loop is a Python loop here

    def __post_init__(self):
        if self.moe is not None and not isinstance(self.moe,
                                                   moe_lib.MoEConfig):
            raise ValueError(f"moe is a {type(self.moe).__name__}, not a "
                             f"models.moe.MoEConfig")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} is not one of "
                             f"{ATTN_IMPLS}")
        if self.remat not in REMATS:
            raise ValueError(f"remat {self.remat!r} is not one of {REMATS}")

    @property
    def windows(self) -> List[int]:
        """Per-layer window (0 = full attention)."""
        return [0 if self.local_global > 0
                and (l + 1) % (self.local_global + 1) == 0 else self.window
                for l in range(self.n_layers)]

    def n_params(self) -> int:
        return self._count(self.moe.n_experts if self.moe else 0)

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        return self._count(self.moe.top_k if self.moe else 0)

    def _count(self, routed: int) -> int:
        """The reference's count, with ``routed`` experts' FFNs a layer
        (the router and shared experts always)."""
        d, dh = self.d_model, self.head_dim
        attn = d * dh * (self.n_heads * 2 + self.n_kv_heads * 2)
        m = self.moe
        if m is not None:
            ffn = (d * routed * m.d_ff * 3 + d * m.n_experts
                   + d * m.d_ff * m.n_shared_experts * 3)
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
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
    if cfg.moe is not None:
        p["moe"] = moe_lib.init(cfg.moe, gen, dtype=cfg.dtype, device=device)
    else:
        p["ffn"] = {"w_gate": dense((d, cfg.d_ff)),
                    "w_up": dense((d, cfg.d_ff)),
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


def _attention_chunked(q, k, v, pos_q, pos_k, window: int,
                       chunk: int = 1024) -> torch.Tensor:
    """The reference's FlashAttention in plain ops: a loop over KV chunks
    with an online softmax in f32, so no [B,H,Sq,Sk] score tensor exists;
    the same mask as ``_attention_xla``.  A chunk that does not divide Sk
    falls back to one chunk, as in the reference."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    if sk % chunk != 0:
        chunk = sk  # degenerate fallback (smoke shapes)
    qg = q.reshape(b, sq, hkv, rep, dh).float() / (dh ** 0.5)
    if pos_k.dim() == 1:
        pos_k = pos_k[None].expand(b, sk)
    m = torch.full((b, sq, hkv, rep), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, sq, hkv, rep), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, hkv, rep, dh), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, sk, chunk):
        kb = k[:, c0:c0 + chunk].float()
        vb = v[:, c0:c0 + chunk].float()
        mask = _attn_scores_mask(pos_q, pos_k[:, c0:c0 + chunk],
                                 window)[:, :, None, None]  # [B,Sq,1,1,C]
        s = torch.einsum("bqhrd,bkhd->bqhrk", qg, kb)
        s = torch.where(mask, s, NEG_INF)
        # max(dim) keeps only the argmax for its backward (amax would keep
        # the whole score chunk); the running max cancels in the result
        m_new = torch.maximum(m, s.max(dim=-1).values)
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhrk,bkhd->bqhrd",
                                                   p, vb)
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.reshape(b, sq, h, dh).to(q.dtype)


class _FlashNoGrad(torch.autograd.Function):
    """``fa.mha`` (the kernel on a card, its plain version on the CPU) with
    a backward that refuses: the kernel has none, as the TPU kernel has no
    VJP, and no gradient may vanish or fall back to a plain version."""

    @staticmethod
    def forward(ctx, q, k, v, window: int):
        return fa.mha(q, k, v, causal=True, window=window)

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError(
            "the flash attention kernel has no backward; train with "
            "attn_impl='chunked' (as the reference's train step does)")


KVOverride = Callable[[torch.Tensor, torch.Tensor],
                      tuple]  # (k, v) -> (k_all, v_all, pos_k)


def _layer_fwd(cfg: LMConfig, p: Params, x, positions, window: int,
               kv_override: Optional[KVOverride] = None):
    """One decoder layer.  x: [B,S,D].  Returns (y, (k, v), aux_loss)."""
    b, s, d = x.shape
    dh = cfg.head_dim
    # on a mesh (Megatron SP): the norm runs on the sequence-sharded
    # stream, then the sequence is gathered before the projections, and
    # the fused head dim is whole before it splits into heads
    h = unshard_dim(common.rms_norm(x, p["ln1"]), 1)
    q = unshard_dim(h @ p["wq"], -1).view(b, s, cfg.n_heads, dh)
    k = unshard_dim(h @ p["wk"], -1).view(b, s, cfg.n_kv_heads, dh)
    v = unshard_dim(h @ p["wv"], -1).view(b, s, cfg.n_kv_heads, dh)
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
        out = _FlashNoGrad.apply(q.transpose(1, 2), k_all.transpose(1, 2),
                                 v_all.transpose(1, 2),
                                 cfg.window).transpose(1, 2)
    elif cfg.attn_impl == "chunked":
        out = _attention_chunked(q, k_all, v_all, positions, pos_k, window)
    else:
        out = _attention_xla(q, k_all, v_all, positions, pos_k, window)
    x = x + unshard_dim(out.reshape(b, s, cfg.n_heads * dh), -1) @ p["wo"]
    h = unshard_dim(common.rms_norm(x, p["ln2"]), 1)
    if cfg.moe is not None:
        y, aux = moe_lib.apply(p["moe"], h.reshape(b * s, d), cfg.moe)
        y = y.view(b, s, d)
    else:
        f = p["ffn"]
        y = (torch.nn.functional.silu(h @ f["w_gate"]) * (h @ f["w_up"])) \
            @ f["w_down"]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, (k, v), aux


def _logits(cfg: LMConfig, params: Params, x) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head).float()


# --------------------------------------------------------------- losses ---

_MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    """``dots`` remat: keep matmul outputs, recompute everything else (the
    reference's ``checkpoint_dots``)."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _train_layer(cfg: LMConfig, p: Params, x, positions, window: int):
    """One layer for the loss, under ``cfg.remat`` -> (y, aux); the
    residual stream pinned to ``cfg.act_spec`` at both ends."""
    def body(x):
        y, _, aux = _layer_fwd(cfg, p, constrain(x, cfg.act_spec),
                               positions, window)
        return constrain(y, cfg.act_spec), aux

    if cfg.remat == "none":
        return body(x)
    policy = None
    if cfg.remat == "dots":
        policy = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return ckpt.checkpoint(body, x, use_reentrant=False,
                           context_fn=lambda: remat_context(policy))


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: LMConfig):
    """batch: {'tokens': int[B,S], 'labels': int[B,S] (< 0 = pad)} ->
    (loss, {'ce', 'aux'}): the mean next-token NLL over labels >= 0, plus
    ``aux_loss_weight`` x the layers' MoE aux loss / n_layers."""
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(s, device=x.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, window in zip(params["layers"], cfg.windows):
        x, a = _train_layer(cfg, p, x, positions, window)
        aux = aux + a
    x = unshard_dim(common.rms_norm(x, params["ln_f"]), 1)
    logits = _logits(cfg, params, x)
    valid = labels >= 0
    tgt = labels.clamp_min(0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    loss = (nll * valid).sum() / valid.sum().clamp_min(1)
    return loss + cfg.aux_loss_weight * aux / cfg.n_layers, {
        "ce": loss, "aux": aux}


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
        x, (k, v), _ = _layer_fwd(cfg, p, constrain(x, cfg.act_spec),
                                  positions, window)
        x = constrain(x, cfg.act_spec)
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
    pos = cache["pos"]
    slot = min(pos, cache["k"].shape[2] - 1)
    logits = _decode(params, cache, tok, pos, slot, cfg)
    cache["pos"] = pos + 1
    return logits, cache


def decode_step_at(params: Params, cache: Dict, tok: torch.Tensor,
                   pos: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """:func:`decode_step` with the position a 0-d int64 tensor on the
    cache's device, as the reference's ``cache["pos"]`` is an int32 on
    its device: the slot is ``pos`` clamped to the cache on the card, the
    k/v writes go through ``index_copy_`` at that device index, and
    ``pos`` is advanced in place.  No host value enters the step, so a
    CUDA graph can capture it.  ``cache["pos"]`` is left as it was.
    Returns the logits f32[B,V]."""
    slot = pos.clamp(max=cache["k"].shape[2] - 1).view(1)
    logits = _decode(params, cache, tok, pos, slot, cfg)
    pos.add_(1)
    return logits


def greedy_step(params: Params, cache: Dict, pos: torch.Tensor,
                tok: torch.Tensor, out: torch.Tensor, col: torch.Tensor,
                cfg: LMConfig) -> torch.Tensor:
    """One greedy decode step in place, every index on the card: ``out[:,
    col] = tok`` (``out`` int32[B, W], ``col`` int64[1]), the logits of
    ``tok`` at ``pos`` (:func:`decode_step_at`), then ``tok`` <- their
    argmax and ``col`` += 1.  Returns the logits: the body of the LM
    server's captured decode step."""
    out.index_copy_(1, col, tok.unsqueeze(1))
    logits = decode_step_at(params, cache, tok, pos, cfg)
    tok.copy_(logits.argmax(-1))
    col.add_(1)
    return logits


def _decode(params: Params, cache: Dict, tok: torch.Tensor, pos, slot,
            cfg: LMConfig) -> torch.Tensor:
    """The decode step's body: ``pos`` and ``slot`` Python ints, or a 0-d
    and a [1] int64 tensor on the cache's device."""
    b = tok.shape[0]
    cache_len = cache["k"].shape[2]
    dev = cache["k"].device
    x = params["embed"][tok.long()[:, None]]  # [B,1,D]
    if isinstance(pos, int):
        positions = torch.full((b, 1), pos, dtype=torch.int64, device=dev)
    else:
        positions = pos.expand(b, 1)
    pos_k = torch.arange(cache_len, device=dev)
    # unwritten slots are masked through their key position
    pos_k = torch.where(pos_k <= pos, pos_k, 2 ** 30).expand(b, cache_len)
    for l, (p, window) in enumerate(zip(params["layers"], cfg.windows)):
        x, _, _ = _layer_fwd(cfg, p, x, positions, window,
                             _cache_writer(cache["k"][l], cache["v"][l], slot,
                                           pos_k))
    x = common.rms_norm(x[:, 0], params["ln_f"])
    return _logits(cfg, params, x)


def _cache_writer(kc, vc, slot, pos_k) -> KVOverride:
    def kv_override(k_new, v_new):
        if isinstance(slot, int):
            kc[:, slot] = k_new[:, 0]
            vc[:, slot] = v_new[:, 0]
        else:  # a device index: nothing copied from the host
            kc.index_copy_(1, slot, k_new)
            vc.index_copy_(1, slot, v_new)
        return kc, vc, pos_k
    return kv_override
