"""Plain PyTorch version of the frontier-expansion segment-min, in its
direct form (per-edge messages) and its gather form (per-vertex values,
the message gathered along each edge).

torch has no uint32 min or shift.  The direct form carries uint32 messages
in int64, values in ``[0, 2^32)``.  The gather form holds uint32 values in
32-bit words (int32 tensors whose bits are read unsigned), the kernel's
carrier; :func:`words_to_u32` and :func:`u32_to_words` convert.
``SENTINEL`` is the min-semiring identity; its word is -1.
"""
from __future__ import annotations

import torch

SENTINEL = 0xFFFFFFFF
SENT_WORD = -1  # SENTINEL's 32-bit word
MODES = ("min", "pair", "or")


def frontier_min(dst: torch.Tensor, msg: torch.Tensor, nv: int
                 ) -> torch.Tensor:
    """out[f, v] = min(msg[f, e] : dst[e] == v), SENTINEL where no edge
    lands.  dst: int32[E] (entries outside ``[0, nv)`` are dropped, as the
    TPU kernel drops its -1 padding); msg: int64[F, E] -> int64[F, NV]."""
    f, e = msg.shape
    idx = torch.where((dst >= 0) & (dst < nv), dst.long(), nv)
    out = torch.full((f, nv + 1), SENTINEL, dtype=torch.int64,
                     device=msg.device)
    out.scatter_reduce_(1, idx.expand(f, e), msg, reduce="amin")
    return out[:, :nv].contiguous()


def words_to_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> their uint32 values, in int64."""
    return words.long() & SENTINEL


def u32_to_words(x: torch.Tensor) -> torch.Tensor:
    """uint32 values in int64 -> int32 words (two's-complement wrap)."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).int()


def gather_min(src, dst, live, val, nv: int) -> torch.Tensor:
    """out[f, v] = min{val[f, src[e]] : live[e], dst[e] == v, 0 <= src[e]
    < n_src}, SENTINEL where nothing lands: the message of each edge built
    as the JAX package builds it, then :func:`frontier_min`.  val: int32
    words [F, n_src] -> int32 words [F, NV]."""
    n_src = val.shape[1]
    ok = live & (src >= 0) & (src < n_src)
    # a dropped edge reads the SENTINEL column n_src
    padded = torch.cat([words_to_u32(val), torch.full(
        (val.shape[0], 1), SENTINEL, dtype=torch.int64, device=val.device)],
        dim=1)
    msg = padded[:, torch.where(ok, src, n_src).long()]
    return u32_to_words(frontier_min(dst, msg, nv))


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool[Q, N] -> int32 words [ceil(Q / 32), N]: bit q of word w is row
    32 w + q."""
    q, n = mask.shape
    w = -(-q // 32)
    rows = torch.zeros((w * 32, n), dtype=torch.int64, device=mask.device)
    rows[:q] = mask
    weight = torch.ones(32, dtype=torch.int64, device=mask.device) << \
        torch.arange(32, device=mask.device)
    return u32_to_words((rows.view(w, 32, n) * weight[:, None]).sum(1))


def unpack_bits(words: torch.Tensor, q: int) -> torch.Tensor:
    """int32 words [W, N] -> bool[q, N], the inverse of :func:`pack_bits`."""
    w, n = words.shape
    shift = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, None, :] >> shift[:, None]) & 1
    return bits.reshape(w * 32, n)[:q].bool()


def frontier_gather(src, dst, live, val, nv: int, mode: str = "min"
                    ) -> torch.Tensor:
    """The gather form, by mode (see ``ops.frontier_gather``): ``min`` is
    :func:`gather_min`; ``pair`` takes row 0 along src -> dst and row 1
    along dst -> src; ``or`` unpacks each bit of val into a frontier of
    0 (reached) / SENTINEL messages, takes their segment-min and packs
    ``incoming == 0`` back."""
    if mode == "min":
        return gather_min(src, dst, live, val, nv)
    if mode == "pair":
        return torch.cat([gather_min(src, dst, live, val[:1], nv),
                          gather_min(dst, src, live, val[1:], nv)])
    if mode == "or":
        reached = unpack_bits(val, 32 * val.shape[0])
        inc = gather_min(src, dst, live, reached.int() - 1, nv)
        return pack_bits(inc == 0)
    raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def frontier_gather_lanes(src, dst, live, val, nv: int, mode: str = "min"
                          ) -> torch.Tensor:
    """The gather form over T tenant rows: src, dst, live [T, E] with
    row-local vertex ids, val int32 words [T, F, n_src] -> [T, F, nv].
    Edge e of row t reads val[t, :, src[t, e]] and writes out[t, :,
    dst[t, e]]: the rows become one graph of T x n_src vertices with row
    offsets added (an edge whose ids fall outside its row is dropped
    first), through :func:`frontier_gather`."""
    t, e = src.shape
    f, n_src = val.shape[1], val.shape[2]
    row = torch.arange(t, dtype=torch.int32, device=src.device)[:, None]
    keep = live & (src >= 0) & (src < n_src) & (dst >= 0) & (dst < nv)
    fsrc = torch.where(keep, src + row * n_src, -1).reshape(-1)
    fdst = torch.where(keep, dst + row * nv, -1).reshape(-1)
    flat = val.permute(1, 0, 2).reshape(f, t * n_src)
    out = frontier_gather(fsrc, fdst, keep.reshape(-1), flat, t * nv, mode)
    return out.reshape(f, t, nv).permute(1, 0, 2).contiguous()
