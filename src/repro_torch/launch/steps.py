"""Step builders, as ``repro.launch.steps``: (arch x shape x mesh) -> a
sharded step of the port.

``build(arch, shape, mesh)`` returns a StepBundle:
  fn             the port's step (train / prefill / decode / serve /
                 update / query)
  args           stand-ins that allocate nothing: tensors on
                 ``device="meta"`` (the reference's ShapeDtypeStructs)
  in_shardings / out_shardings   trees of ``P`` over the mesh's axis
                 names (``mesh.placements`` turns one into DTensor
                 placements)
  meta           model_flops (analytic useful FLOPs a step), tokens or
                 items a step, notes
  donate         the reference's donated argument indices, kept as data:
                 torch has no donation (the port's updates write in place)

The rules are the reference's: the training shardings, the MoE group
count, the GNN node axis and padding, the edge chunking, and the skip
cells.  Shapes whose global dims do not divide the mesh are padded up
front (masked tails), recorded in meta['padded'].  LM layer specs drop the
reference's leading [L] dim, since the port's layers are a list.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import configs as cfg_registry
from repro_torch.configs import gnn_shapes as gshapes
from repro_torch.launch import partition
from repro_torch.launch.mesh import P, axis_names, axis_size
from repro_torch.models import transformer as tf
from repro_torch.optim import optimizer
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class StepBundle(NamedTuple):
    name: str
    fn: Any
    args: tuple
    in_shardings: Any
    out_shardings: Any
    meta: dict
    donate: tuple = ()  # the reference's donated args (no donation here)


def _dp_size(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        if a in axis_names(mesh):
            n *= axis_size(mesh, a)
    return n


def _dp(mesh):
    axes = tuple(a for a in axis_names(mesh) if a in ("pod", "data"))
    return axes if len(axes) > 1 else axes[0]


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _gen():
    return torch.Generator().manual_seed(0)


OPT_CFG = optimizer.AdamWConfig(lr=3e-4, total_steps=100_000,
                                warmup_steps=2000)


def _train_step(loss):
    """The trainer's step: ``loss(params, batch) -> (loss, aux)``, its
    gradient on every leaf, then AdamW (params and moments in place)."""
    def train_step(params, opt_state, b):
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        value, _ = loss(params, b)
        grads = torch.autograd.grad(value, leaves, allow_unused=True,
                                    materialize_grads=True)
        params, opt_state, _ = optimizer.update(
            tree_unflatten(params, grads), opt_state, params, OPT_CFG)
        return params, opt_state, value.detach()
    return train_step


# ------------------------------------------------------------------- LM ---

def lm_model_flops(cfg: tf.LMConfig, kind: str, batch: int, seq: int):
    """Analytic useful FLOPs a step: 6·N·D train, 2·N·D forward, plus the
    attention term; MoE counts active parameters only."""
    n_active = cfg.n_active_params()
    if kind == "train":
        tokens = batch * seq
        base = 6 * n_active * tokens
        attn = 0
        for w in cfg.windows:
            eff = seq if w == 0 else min(seq, w)
            # causal: ~seq*eff/2 scored pairs, *2 matmuls (QK^T, PV), *2 MACs
            attn += 3 * 4 * batch * cfg.n_heads * cfg.head_dim * \
                (seq * eff // 2)  # fwd+bwd(2x)
        return base + attn
    if kind == "prefill":
        tokens = batch * seq
        base = 2 * n_active * tokens
        attn = 0
        for w in cfg.windows:
            eff = seq if w == 0 else min(seq, w)
            attn += 4 * batch * cfg.n_heads * cfg.head_dim * (seq * eff // 2)
        return base + attn
    # decode: one token against a seq-long cache
    base = 2 * n_active * batch
    attn = 0
    for w in cfg.windows:
        eff = seq if w == 0 else min(seq, w)
        attn += 4 * batch * cfg.n_heads * cfg.head_dim * eff
    return base + attn


GROUP_TOKENS = 4096  # GShard dispatch group size (capacity = 4096*k/E*cf)


def _lm_apply_shardings(cfg, mesh, kind, tokens: int):
    """The activation and MoE sharding constraints for ``mesh``."""
    dp = _dp(mesh)
    upd = {}
    if kind in ("train", "prefill"):
        upd["act_spec"] = P(dp, "model", None)   # Megatron SP on seq
        upd["remat"] = "full" if kind == "train" else "none"
        # the online-softmax KV-chunked attention: the materialized scores
        # blow the 32k prefill's memory
        upd["attn_impl"] = "chunked"
    if cfg.moe is not None:
        # GShard groups of ~4k tokens, a multiple of the dp extent so
        # each shard owns whole groups
        n_dp = _dp_size(mesh)
        n_groups = max(1, tokens // GROUP_TOKENS)
        if n_groups % n_dp != 0 or tokens % n_groups != 0:
            n_groups = n_dp if tokens % n_dp == 0 else 1
        if kind == "decode":
            n_groups = 1
        upd["moe"] = dataclasses.replace(
            cfg.moe, n_groups=n_groups,
            disp_spec=P(dp, None, "model", None),
            expert_spec=P("model", dp, None, None))
    return dataclasses.replace(cfg, **upd)


def apply_overrides(cfg, overrides):
    """dataclasses.replace with dotted 'moe.*' routing."""
    if not overrides:
        return cfg
    moe_over = {k[4:]: v for k, v in overrides.items()
                if k.startswith("moe.")}
    top = {k: v for k, v in overrides.items() if "." not in k}
    if moe_over and getattr(cfg, "moe", None) is not None:
        top["moe"] = dataclasses.replace(cfg.moe, **moe_over)
    return dataclasses.replace(cfg, **top)


def lm_port_param_specs(pspecs, n_layers: int):
    """The reference-form LM specs on the port's tree: the layer specs,
    leading [L] dim dropped, once per layer of the list."""
    layer = tree_map(lambda s: P(*s[1:]), pspecs["layers"])
    return dict(pspecs, layers=[layer] * n_layers)


def build_lm(arch_mod, shape_name: str, shape: dict, mesh,
             layers_override=None, overrides=None):
    cfg = arch_mod.config()
    kind = shape["kind"]
    tokens = shape["global_batch"] * (shape["seq"] if kind != "decode"
                                      else 1)
    cfg = _lm_apply_shardings(cfg, mesh, kind, tokens)
    cfg = apply_overrides(cfg, overrides)
    if layers_override is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers_override,
                                  scan_unroll=True)
    seq, batch = shape["seq"], shape["global_batch"]

    params = tf.init(cfg, _gen(), device="meta")
    pspecs = lm_port_param_specs(partition.lm_param_specs(cfg, mesh),
                                 cfg.n_layers)
    dp = _dp(mesh)
    meta = {"model_flops": lm_model_flops(cfg, kind, batch, seq),
            "tokens": batch * (seq if kind != "decode" else 1),
            "params": cfg.n_params(), "active_params": cfg.n_active_params()}
    name = f"{cfg.name}:{shape_name}"

    if kind == "train":
        opt = optimizer.init(params)
        ospecs = partition.opt_state_specs(pspecs)
        bspecs = partition.lm_batch_specs(mesh)
        b = {"tokens": _sds((batch, seq), torch.int32),
             "labels": _sds((batch, seq), torch.int32)}
        return StepBundle(
            name, _train_step(lambda p, x: tf.loss_fn(p, x, cfg)),
            (params, opt, b), (pspecs, ospecs, bspecs),
            (pspecs, ospecs, P()), meta, donate=(0, 1))

    cache_specs = partition.lm_cache_specs(cfg, mesh, batch)
    if kind == "prefill":
        def prefill_step(params, toks):
            return tf.prefill(params, toks, cfg, cache_len=seq)

        cache_out = {"k": cache_specs["k"], "v": cache_specs["v"],
                     "pos": P()}
        return StepBundle(
            name, prefill_step, (params, _sds((batch, seq), torch.int32)),
            (pspecs, P(dp, None)), (cache_out, P(dp, "model")), meta)

    # decode: one new token against a seq-long KV cache
    kv_shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": _sds(kv_shape, cfg.dtype), "v": _sds(kv_shape, cfg.dtype),
             "pos": seq - 1}

    def decode(params, cache, tok):
        return tf.decode_step(params, cache, tok, cfg)

    n_dp = _dp_size(mesh)
    bax = dp if batch % n_dp == 0 and batch >= n_dp else None
    vax = "model" if cfg.vocab % axis_size(mesh, "model") == 0 else None
    return StepBundle(
        name, decode, (params, cache, _sds((batch,), torch.int32)),
        (pspecs, cache_specs, P(bax)), (P(bax, vax), cache_specs),
        meta, donate=(1,))


# ------------------------------------------------------------------ GNN ---

def gnn_model_flops(arch: str, cfg, n_nodes: int, n_edges: int) -> int:
    """Analytic useful FLOPs a step (forward + backward ~ 3x forward)."""
    c = cfg.d_hidden
    if arch == "gatedgcn":
        fwd = n_edges * (3 * 2 * c * c) + n_nodes * (2 * 2 * c * c)
        fwd *= cfg.n_layers
    elif arch == "egnn":
        fwd = n_edges * (2 * (2 * c + 1) * c + 2 * c * c + 2 * c * c) + \
            n_nodes * (2 * 2 * c * c)
        fwd *= cfg.n_layers
    else:  # nequip / mace: radial MLP + per-path TP + mixing
        n_paths = 15 if cfg.l_max >= 2 else (4 if cfg.l_max == 1 else 1)
        tp_cost = n_edges * n_paths * c * 18     # avg contraction cost
        radial = n_edges * 2 * (cfg.n_rbf * 32 + 32 * n_paths * c)
        mix = n_nodes * (cfg.l_max + 1) * 2 * c * c * 9
        fwd = (tp_cost + radial + mix) * cfg.n_layers
        if arch == "mace":
            fwd += cfg.n_layers * n_nodes * 2 * n_paths * c * 18  # B-products
    return 3 * fwd


def build_gnn(arch: str, arch_mod, shape_name: str, shape: dict, mesh,
              overrides=None):
    model = arch_mod.MODULE
    dp = _dp(mesh)
    n_model = axis_size(mesh, "model")
    n_dp = _dp_size(mesh)

    if shape["kind"] == "train_mol":
        n_graphs = shape["batch"]
        n_nodes = n_graphs * shape["n_nodes"]
        n_edges = n_graphs * shape["n_edges"]
        task, n_classes, d_feat = "energy", 2, shape["d_feat"]
    else:
        if shape["kind"] == "train_sampled":
            n_nodes, n_edges = gshapes.sampled_block_dims(shape)
        else:
            n_nodes, n_edges = shape["n_nodes"], shape["n_edges"]
        n_graphs = 1
        task, n_classes, d_feat = \
            "node_class", shape["n_classes"], shape["d_feat"]

    pad_n = _pad_to(n_nodes, n_dp * n_model)  # node arrays shard all ranks
    pad_e = _pad_to(n_edges, n_dp * n_model)  # safe for either edge axis
    # small and minibatch graphs scatter cheapest into 'model'-only node
    # shards; only 10^6+-node full-batch graphs need every axis
    if pad_n > 2 ** 20:
        node_ax = partition.gnn_node_axis(mesh, pad_n)
    else:
        node_ax = "model" if pad_n % n_model == 0 else None
    kw = dict(task=task, n_classes=n_classes, d_feat=d_feat,
              n_graphs=n_graphs, scan_unroll=True,
              edge_ax=dp, node_ax=node_ax, remat=True)
    if arch in ("nequip", "mace") and pad_e > 2 ** 22:
        # stream edges in 32 chunks: l <= 2 message tensors never exceed
        # chunk x C x 9 floats
        kw["edge_chunk"] = pad_e // 32
    kw.update(overrides or {})
    node_ax = kw["node_ax"]  # overrides steer input sharding too
    cfg = arch_mod.config(**kw)

    b = {
        "src": _sds((pad_e,), torch.int32), "dst": _sds((pad_e,), torch.int32),
        "edge_mask": _sds((pad_e,), torch.bool),
        "node_mask": _sds((pad_n,), torch.float32),
        "graph_id": _sds((pad_n,), torch.int32),
        "x": _sds((pad_n, d_feat), torch.float32),
        "pos": _sds((pad_n, 3), torch.float32),
    }
    if task == "node_class":
        b["labels"] = _sds((pad_n,), torch.int32)
    else:
        b["energy"] = _sds((n_graphs,), torch.float32)
        b["forces"] = _sds((pad_n, 3), torch.float32)

    params = model.init(cfg, _gen(), device="meta")
    pspecs = partition.gnn_param_specs(params)
    ospecs = partition.opt_state_specs(pspecs)
    all_bspecs = partition.gnn_batch_specs(mesh, pad_n, pad_e,
                                           node_ax=node_ax)
    bspecs = {k: all_bspecs[k] for k in b}
    meta = {"model_flops": gnn_model_flops(arch, cfg, pad_n, pad_e),
            "nodes": pad_n, "edges": pad_e,
            "edge_chunks": (pad_e // kw["edge_chunk"])
            if kw.get("edge_chunk") else 1,
            "padded": (pad_n != n_nodes or pad_e != n_edges)}
    return StepBundle(
        f"{arch}:{shape_name}",
        _train_step(lambda p, x: model.loss_fn(p, x, cfg)),
        (params, optimizer.init(params), b), (pspecs, ospecs, bspecs),
        (pspecs, ospecs, P()), meta, donate=(0, 1))


# --------------------------------------------------------------- recsys ---

def mind_model_flops(cfg, kind: str, batch: int, n_cand: int = 0) -> int:
    d, l, k = cfg.embed_dim, cfg.seq_len, cfg.n_interests
    routing = 2 * batch * l * d * d + \
        cfg.capsule_iters * (2 * batch * l * k * d * 2)
    profile = 2 * batch * cfg.profile_len * d
    fuse = 2 * batch * k * (2 * d) * d
    fwd = routing + profile + fuse
    if kind == "train":
        label_att = 2 * batch * k * d * 2
        softmax = 2 * batch * (cfg.n_neg + 1) * d
        return 3 * (fwd + label_att + softmax)
    return fwd + 2 * batch * k * n_cand * d


def build_mind(arch_mod, shape_name: str, shape: dict, mesh):
    from repro_torch.models.recsys import mind as model
    cfg = arch_mod.config(scan_unroll=True)
    batch = shape["batch"]
    b = {"behavior": _sds((batch, cfg.seq_len), torch.int32),
         "profile": _sds((batch, cfg.profile_len), torch.int32)}
    params = model.init(cfg, _gen(), device="meta")
    pspecs = partition.mind_param_specs(cfg, mesh)

    if shape["kind"] == "train":
        b["target"] = _sds((batch,), torch.int32)
        b["negatives"] = _sds((cfg.n_neg,), torch.int32)
        bspecs = partition.mind_batch_specs(mesh, batch)
        ospecs = partition.opt_state_specs(pspecs)
        meta = {"model_flops": mind_model_flops(cfg, "train", batch),
                "items": batch}
        return StepBundle(
            f"mind:{shape_name}",
            _train_step(lambda p, x: model.loss_fn(p, x, cfg)),
            (params, optimizer.init(params), b), (pspecs, ospecs, bspecs),
            (pspecs, ospecs, P()), meta, donate=(0, 1))

    n_cand = shape["n_cand"]
    b["candidates"] = _sds((batch, n_cand), torch.int32)
    bspecs = partition.mind_batch_specs(mesh, batch, with_candidates=True,
                                        cand=n_cand)
    bspecs = {k: bspecs[k] for k in b}  # serve has no target / negatives

    def serve_step(params, b):
        return model.serve_score(params, b, cfg)

    cax = "model" if n_cand % axis_size(mesh, "model") == 0 else None
    meta = {"model_flops": mind_model_flops(cfg, "serve", batch, n_cand),
            "items": batch * max(n_cand, 1)}
    return StepBundle(
        f"mind:{shape_name}", serve_step, (params, b), (pspecs, bspecs),
        P(bspecs["behavior"][0], cax), meta)


# ---------------------------------------------------------------- smscc ---

def build_smscc(arch_mod, shape_name: str, shape: dict, mesh,
                overrides=None):
    from repro_torch.core import community, dynamic
    from repro_torch.core import graph_state as gs
    cfg = arch_mod.config(n_vertices=shape["n_vertices"],
                          edge_capacity=shape["edge_capacity"],
                          **(overrides or {}))
    state = gs.empty(cfg, device="meta")
    sspecs = partition.smscc_state_specs(mesh)
    dp = _dp(mesh)
    b = shape["batch"]
    # per-round useful work: one edge-parallel sweep (compare + scatter a
    # slot); queries are gathers (one compare a query)
    if shape["kind"] == "update":
        meta = {"model_flops": 2 * cfg.edge_capacity, "ops": b,
                "flops_unit": "per fixpoint round"}
    else:
        meta = {"model_flops": 2 * b, "ops": b}

    if shape["kind"] == "update":
        ops = dynamic.OpBatch(kind=_sds((b,), torch.int32),
                              u=_sds((b,), torch.int32),
                              v=_sds((b,), torch.int32))

        def update_step(state, ops):
            return dynamic.apply_batch(state, ops, cfg)

        return StepBundle(
            f"smscc:{shape_name}", update_step, (state, ops),
            (sspecs, partition.smscc_ops_specs(mesh)), (sspecs, P(dp)),
            meta, donate=(0,))

    def query_step(state, u, v):
        return community.check_scc(state, u, v)

    return StepBundle(
        f"smscc:{shape_name}", query_step,
        (state, _sds((b,), torch.int32), _sds((b,), torch.int32)),
        (sspecs, P(dp), P(dp)), P(dp), meta)


# ---------------------------------------------------------------- entry ---

def build(arch: str, shape_name: str, mesh, lm_layers=None,
          overrides=None) -> Optional[StepBundle]:
    mod = cfg_registry.get(arch)
    shape = mod.SHAPES[shape_name]
    if shape.get("skip"):
        return None
    if mod.FAMILY == "lm":
        return build_lm(mod, shape_name, shape, mesh,
                        layers_override=lm_layers, overrides=overrides)
    if mod.FAMILY == "gnn":
        return build_gnn(arch.replace("-", "_"), mod, shape_name, shape,
                         mesh, overrides=overrides)
    if mod.FAMILY == "recsys":
        return build_mind(mod, shape_name, shape, mesh)
    if mod.FAMILY == "smscc":
        return build_smscc(mod, shape_name, shape, mesh,
                           overrides=overrides)
    raise ValueError(mod.FAMILY)
