"""PartitionSpec rules per model family, as ``repro.launch.partition``:
the same builders, names and rules, in the port's ``P``.

Mesh axes: 'pod' and 'data' carry batch / edge / op parallelism; 'model'
carries tensor / expert / vocab / node parallelism.  Every rule is written
against axis names, so the same specs drive the 16x16 mesh, the 2x16x16
mesh and a host mesh, and checkpoints re-shard elastically.

* LM: weights FSDP over 'data' on d_model x TP over 'model' on the ffn /
  heads / vocab axis (AdamW moments take the same specs); activations
  batch over ('pod', 'data'), the residual stream sequence-sharded over
  'model' between layers; MoE experts over 'model'; KV caches batch over
  ('pod', 'data') and length over 'model' (or length over data and model
  when the batch is too small).
* GNN: edge arrays over ('pod', 'data'); node arrays over the widest axes
  that divide them.
* RecSys: batch over ('pod', 'data'); tables row-sharded over 'model';
  candidates over 'model'.
* SMSCC: edge-table columns over ('pod', 'data'), label arrays
  replicated (all-reduce merges).

Specs keep the reference's layout of each tree, so they compare with the
JAX package's leaf by leaf: LM layer specs carry the reference's leading
[L] dim (``steps`` drops it for the port's per-layer list).
"""
from __future__ import annotations

from repro_torch.launch.mesh import P, axis_names, axis_size
from repro_torch.tree import tree_map


def _dp(mesh):
    axes = tuple(a for a in axis_names(mesh) if a in ("pod", "data"))
    return axes if len(axes) > 1 else axes[0]


def _dp_size(mesh) -> int:
    dp = _dp(mesh)
    n = 1
    for a in (dp if isinstance(dp, tuple) else (dp,)):
        n *= axis_size(mesh, a)
    return n


def _divisible(n: int, mesh, axis: str) -> bool:
    return n % axis_size(mesh, axis) == 0


# ------------------------------------------------------------------- LM ---

def lm_param_specs(cfg, mesh):
    fsdp = "data" if _divisible(cfg.d_model, mesh, "data") else None
    kv = "model" if _divisible(cfg.n_kv_heads * cfg.head_dim, mesh,
                               "model") else None
    layers = {
        "ln1": P(None, None), "ln2": P(None, None),
        "wq": P(None, fsdp, "model"),
        "wk": P(None, fsdp, kv),
        "wv": P(None, fsdp, kv),
        "wo": P(None, "model", fsdp),
    }
    if cfg.qk_norm:
        layers["q_norm"] = P(None, None)
        layers["k_norm"] = P(None, None)
    if cfg.moe is not None:
        moe = {
            "router": P(None, None, "model") if _divisible(
                cfg.moe.n_experts, mesh, "model") else P(None, None, None),
            "w_gate": P(None, "model", fsdp, None),
            "w_up": P(None, "model", fsdp, None),
            "w_down": P(None, "model", None, fsdp),
        }
        if cfg.moe.n_shared_experts:
            moe["shared"] = {
                "w_gate": P(None, fsdp, "model"),
                "w_up": P(None, fsdp, "model"),
                "w_down": P(None, "model", fsdp),
            }
        layers["moe"] = moe
    else:
        layers["ffn"] = {
            "w_gate": P(None, fsdp, "model"),
            "w_up": P(None, fsdp, "model"),
            "w_down": P(None, "model", fsdp),
        }
    vocab = "model" if _divisible(cfg.vocab, mesh, "model") else None
    specs = {"embed": P(vocab, fsdp), "layers": layers, "ln_f": P(None)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(fsdp, vocab)
    return specs


def lm_batch_specs(mesh):
    dp = _dp(mesh)
    return {"tokens": P(dp, None), "labels": P(dp, None)}


def lm_cache_specs(cfg, mesh, batch: int):
    """KV cache sharding for decode shapes."""
    dp = _dp(mesh)
    n_dp = _dp_size(mesh)
    if batch % n_dp == 0 and batch >= n_dp:
        # batch-sharded cache, length over 'model' (seq-sharded attention)
        return {"k": P(None, dp, "model", None, None),
                "v": P(None, dp, "model", None, None),
                "pos": P()}
    # batch too small (long-context bs=1): shard length over data+model
    return {"k": P(None, None, ("data", "model"), None, None),
            "v": P(None, None, ("data", "model"), None, None),
            "pos": P()}


# ------------------------------------------------------------------ GNN ---

def gnn_param_specs(params):
    """GNN weights are small: replicate everything."""
    return tree_map(lambda _: P(), params)


def gnn_node_axis(mesh, n_nodes: int):
    """Widest mesh-axis combination that divides the (padded) node count:
    node tensors of 10^6-node graphs must shard across every rank."""
    dp = _dp(mesh)
    full = (dp if isinstance(dp, tuple) else (dp,)) + ("model",)
    size = 1
    for a in full:
        size *= axis_size(mesh, a)
    if n_nodes % size == 0:
        return full
    if n_nodes % axis_size(mesh, "model") == 0:
        return "model"
    return None


def gnn_batch_specs(mesh, n_nodes: int, n_edges: int, node_ax="auto"):
    edge_ax = _dp(mesh)
    if node_ax == "auto":
        node_ax = gnn_node_axis(mesh, n_nodes)
    return {
        "src": P(edge_ax), "dst": P(edge_ax), "edge_mask": P(edge_ax),
        "node_mask": P(node_ax), "graph_id": P(node_ax),
        "x": P(node_ax, None), "pos": P(node_ax, None),
        "labels": P(node_ax), "energy": P(None), "forces": P(node_ax, None),
    }


# --------------------------------------------------------------- recsys ---

def mind_param_specs(cfg, mesh):
    row = "model" if _divisible(cfg.n_items, mesh, "model") else None
    prow = "model" if _divisible(cfg.profile_vocab, mesh, "model") else None
    return {
        "item_embed": P(row, None),
        "profile_embed": P(prow, None),
        "S": P(None, None),
        "b_init": P(None, None),
        "proj": P(None, None),
    }


def mind_batch_specs(mesh, batch: int, with_candidates: bool = False,
                     cand: int = 0):
    n_dp = _dp_size(mesh)
    bax = _dp(mesh) if batch % n_dp == 0 and batch >= n_dp else None
    specs = {"behavior": P(bax, None), "profile": P(bax, None),
             "target": P(bax), "negatives": P(None)}
    if with_candidates:
        cax = "model" if _divisible(cand, mesh, "model") else None
        specs["candidates"] = P(bax, cax)
    return specs


# ---------------------------------------------------------------- smscc ---

def smscc_state_specs(mesh):
    from repro_torch.core import edge_table as et
    from repro_torch.core import graph_state as gs
    dp = _dp(mesh)
    return gs.GraphState(
        v_alive=P(None), ccid=P(None),
        edges=et.EdgeTable(src=P(dp), dst=P(dp), state=P(dp)),
        n_ccs=P(), gen=P(), overflow=P())


def smscc_ops_specs(mesh):
    from repro_torch.core import dynamic
    dp = _dp(mesh)
    return dynamic.OpBatch(kind=P(dp), u=P(dp), v=P(dp))


# ------------------------------------------------------------ optimizer ---

def opt_state_specs(param_specs):
    """AdamW moments inherit the parameter specs (FSDP => ZeRO)."""
    from repro_torch.optim import optimizer
    return optimizer.OptState(m=param_specs, v=param_specs, count=P())
