"""Equivariant GNN substrate: Cartesian irreps (l <= 2), tensor products,
radial bases, gates; as ``repro.models.gnn.common``.

Irreps are carried in Cartesian form -- l=0 scalars, l=1 vectors (3,), l=2
symmetric-traceless matrices (3,3) -- where every allowed product l1 ⊗ l2
-> l3 is an explicit contraction (dot, cross, traceless-symmetric outer,
epsilon contraction).  Feature trees:

    {"l0": [N, C], "l1": [N, C, 3], "l2": [N, C, 3, 3]}

All tensor-product helpers broadcast over leading dims, so they serve both
edge-message products (feature × edge basis, basis as channel-dim 1) and
MACE's node-wise A×A products (channel-aligned).  The epsilon contractions
(the reference's einsums with ``EPS3``) are written as cross products and
the antisymmetric part of a matrix product: the same sums without the
zero terms.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.sharding import P, constrain, remat_context
from repro_torch.tree import tree_map

EPS3 = torch.tensor([[[0, 0, 0], [0, 0, 1], [0, -1, 0]],
                     [[0, 0, -1], [0, 0, 0], [1, 0, 0]],
                     [[0, 1, 0], [-1, 0, 0], [0, 0, 0]]],
                    dtype=torch.float32)


def sym_traceless(m: torch.Tensor) -> torch.Tensor:
    """Project [..., 3, 3] onto the l=2 (symmetric traceless) component."""
    s = 0.5 * (m + m.transpose(-1, -2))
    tr = torch.diagonal(s, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    return s - tr * eye / 3.0


def _cross(a, b, dim=-1):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=dim)


def _axial(m):
    """eps_iab m_ab: the vector of [..., 3, 3]'s antisymmetric part."""
    return torch.stack([m[..., 1, 2] - m[..., 2, 1],
                        m[..., 2, 0] - m[..., 0, 2],
                        m[..., 0, 1] - m[..., 1, 0]], dim=-1)


# --- tensor products: a has irrep l1, b has irrep l2, result lout ----------

def _tp00_0(a, b):
    return a * b


def _tp01_1(a, b):
    return a[..., None] * b


def _tp02_2(a, b):
    return a[..., None, None] * b


def _tp10_1(a, b):
    return a * b[..., None]


def _tp11_0(a, b):
    return (a * b).sum(-1)


def _tp11_1(a, b):
    return _cross(a, b)


def _tp11_2(a, b):
    return sym_traceless(a[..., :, None] * b[..., None, :])


def _tp12_1(a, b):
    return (a[..., :, None] * b).sum(-2)


def _tp12_2(a, b):
    # eps_iab a_a b_bj: column j of the result is a x (column j of b)
    return sym_traceless(_cross(a[..., :, None], b, dim=-2))


def _tp20_2(a, b):
    return a * b[..., None, None]


def _tp21_1(a, b):
    return (a * b[..., None, :]).sum(-1)


def _tp21_2(a, b):
    return _tp12_2(b, a)


def _tp22_0(a, b):
    return (a * b).sum((-2, -1))


def _matmul3(a, b):
    """[..., 3, 3] @ [..., 3, 3] as three broadcast outer products:
    ``@`` would copy a broadcast operand (and run millions of 3x3 GEMMs),
    one multiply-sum would hold a [..., 3, 3, 3] temporary."""
    return (a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
            + a[..., :, 2:3] * b[..., 2:3, :])


def _tp22_1(a, b):
    return _axial(_matmul3(a, b))


def _tp22_2(a, b):
    return sym_traceless(_matmul3(a, b))


# (l_a, l_b, l_out) -> bilinear map; the full l<=2 path table.
TP_PATHS = {
    (0, 0, 0): _tp00_0,
    (0, 1, 1): _tp01_1,
    (0, 2, 2): _tp02_2,
    (1, 0, 1): _tp10_1,
    (1, 1, 0): _tp11_0,
    (1, 1, 1): _tp11_1,
    (1, 1, 2): _tp11_2,
    (1, 2, 1): _tp12_1,
    (1, 2, 2): _tp12_2,
    (2, 0, 2): _tp20_2,
    (2, 1, 1): _tp21_1,
    (2, 1, 2): _tp21_2,
    (2, 2, 0): _tp22_0,
    (2, 2, 1): _tp22_1,
    (2, 2, 2): _tp22_2,
}


def paths_for(l_max: int):
    return [(la, lb, lo) for (la, lb, lo) in TP_PATHS
            if la <= l_max and lb <= l_max and lo <= l_max]


def zeros_feats(n: int, c: int, l_max: int, dtype=torch.float32,
                device=None) -> dict:
    f = {"l0": torch.zeros((n, c), dtype=dtype, device=device)}
    if l_max >= 1:
        f["l1"] = torch.zeros((n, c, 3), dtype=dtype, device=device)
    if l_max >= 2:
        f["l2"] = torch.zeros((n, c, 3, 3), dtype=dtype, device=device)
    return f


def edge_basis(rhat: torch.Tensor, l_max: int) -> dict:
    """Cartesian Y_l of unit edge vectors with a channel-1 dim for
    broadcasting against [E, C, ...] features.  rhat: [E, 3]."""
    out = {"l0": torch.ones((rhat.shape[0], 1), dtype=rhat.dtype,
                            device=rhat.device)}
    if l_max >= 1:
        out["l1"] = rhat[:, None, :]
    if l_max >= 2:
        out["l2"] = sym_traceless(
            rhat[:, :, None] * rhat[:, None, :])[:, None, :, :]
    return out


def bessel_basis(r: torch.Tensor, n_rbf: int, cutoff: float
                 ) -> torch.Tensor:
    """Radial Bessel basis with smooth polynomial cutoff.  r: [E]."""
    r = r.clamp_min(1e-9)
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    basis = (2.0 / cutoff) ** 0.5 * torch.sin(
        n[None, :] * np.pi * r[:, None] / cutoff) / r[:, None]
    x = (r / cutoff).clamp(0.0, 1.0)
    env = 1.0 - 10.0 * x ** 3 + 15.0 * x ** 4 - 6.0 * x ** 5  # C² cutoff
    return basis * env[:, None]


def linear_mix(w: dict, feats: dict) -> dict:
    """Per-l channel mixing.  w: {'l0': [Cin, Cout], ...}."""
    return {l: torch.einsum("nc...,cd->nd...", f, w[l])
            for l, f in feats.items()}


def gate(feats: dict, w_gate: dict) -> dict:
    """Equivariant gate: scalars through silu; l>0 scaled by
    sigmoid(linear(scalars))."""
    s = feats["l0"]
    out = {"l0": F.silu(s)}
    for l in ("l1", "l2"):
        if l in feats:
            g = torch.sigmoid(s @ w_gate[l])  # [N, C]
            extra = feats[l].dim() - g.dim()
            out[l] = feats[l] * g.reshape(g.shape + (1,) * extra)
    return out


def add_feats(a: dict, b: dict) -> dict:
    return {l: a[l] + b[l] for l in a}


def norm_feats(feats: dict, eps: float = 1e-6) -> dict:
    """Invariant RMS normalization per l (divide by channel-mean norm)."""
    out = {}
    for l, f in feats.items():
        ms = (f * f).mean(dim=tuple(range(1, f.dim())), keepdim=True)
        out[l] = f * torch.rsqrt(ms + eps)
    return out


def invariants(feats: dict) -> torch.Tensor:
    """Concatenate rotation-invariant contractions of all l channels."""
    parts = [feats["l0"]]
    if "l1" in feats:
        parts.append(torch.sqrt((feats["l1"] ** 2).sum(-1) + 1e-12))
    if "l2" in feats:
        parts.append(torch.sqrt((feats["l2"] * feats["l2"]).sum((-2, -1))
                                + 1e-12))
    return torch.cat(parts, dim=-1)


def random_rotation(rng: np.random.Generator) -> np.ndarray:
    """Haar-ish random rotation matrix (f32 [3, 3]) via QR, from a numpy
    generator."""
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))[None, :]
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


def rotate_feats(feats: dict, rot: torch.Tensor) -> dict:
    out = {"l0": feats["l0"]}
    if "l1" in feats:
        out["l1"] = torch.einsum("ij,ncj->nci", rot, feats["l1"])
    if "l2" in feats:
        out["l2"] = torch.einsum("ia,jb,ncab->ncij", rot, rot, feats["l2"])
    return out


def constrain_rows(x, axis):
    """Pin the leading-dim sharding of an intermediate (edge or node
    arrays) to mesh ``axis`` (a name or a tuple); None is a no-op."""
    if axis is None:
        return x
    return constrain(x, P(axis, *([None] * (x.dim() - 1))))


def constrain_feats(feats, axis):
    if axis is None:
        return feats
    return {l: constrain_rows(f, axis) for l, f in feats.items()}


def scan_layers(body, carry, layers, n_layers: int, remat: bool):
    """The reference's ``jax.lax.scan`` of ``body(carry, p)`` over the
    layer tree stacked on [n_layers]: layer i's params are views ``x[i]``
    of the stacked leaves, so gradients land in the stacked tree.  With
    ``remat`` each body runs under ``torch.utils.checkpoint``
    (non-reentrant, which carries a second derivative), as
    ``jax.checkpoint`` wraps the scan body."""
    for i in range(n_layers):
        p = tree_map(lambda x: x[i], layers)
        carry = ckpt.checkpoint(body, carry, p, use_reentrant=False,
                                context_fn=remat_context) \
            if remat else body(carry, p)
    return carry


def stack_layers(layers: list):
    """Per-layer param trees -> one tree with every leaf stacked on a
    leading [n_layers] axis (the reference's layout)."""
    return tree_map(lambda *xs: torch.stack(xs), *layers)
