"""The port's GNN family held to the JAX package's: the Cartesian tensor
products and the equivariant substrate, EGNN, GatedGCN, NequIP (with its
chunked-edge convolution) and MACE on both tasks, and a trainer step
(``launch.train --arch <gnn>`` runs in ``test_torch_train.py``).

Weights are the JAX package's ``init`` carried into the port
(``carry.gnn_params_from_numpy``); batches are numpy arrays made from a
seed.  Tolerances: the tensor products and substrate functions within 1e-6
(the same sums in another order); the loss within 1e-5 relative and every
gradient leaf within rtol 2e-4 / atol 2e-5 of ``jax.value_and_grad`` (the
LM training tolerances), the port with remat on and off against the
reference's one answer.  MACE's energy task is compared in f64 on both
sides: its force loss differentiates twice through norms of near-zero
features, and in f32 its gradients stand over 10x that tolerance from
its own f64 answer (``test_mace_energy_f32_is_beyond_the_tolerance``),
so f32 cannot resolve it; the other seven cases run in f32.  Equivariance holds at the
reference's own tolerances (``tests/test_models.py``), and chunked NequIP
equals unchunked at the reference's chunking tolerances.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import egnn as j_egnn
from repro.configs import gatedgcn as j_gatedgcn
from repro.configs import mace as j_mace
from repro.configs import nequip as j_nequip
from repro.graph import batching as jbatch
from repro.models import common as jcommon
from repro.models.gnn import common as jgc
from repro.optim import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import carry, configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import common as tcommon
from repro_torch.models.gnn import common as tgc
from repro_torch.models.gnn import nequip as tnequip
from repro_torch.optim import optimizer as topt
from repro_torch.train import trainer as ttrainer
from repro_torch.tree import tree_leaves, tree_map

ARCHS = ["egnn", "gatedgcn", "nequip", "mace"]
JAX_CONFIGS = {"egnn": j_egnn, "gatedgcn": j_gatedgcn, "nequip": j_nequip,
               "mace": j_mace}
TP_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
N_CLASSES = 3


def _rng_feats(rng, n, c, dtype=np.float32):
    """Random l<=2 features [n, c, ...], l2 symmetric traceless."""
    l2 = rng.normal(size=(n, c, 3, 3))
    l2 = 0.5 * (l2 + np.swapaxes(l2, -1, -2))
    l2 -= np.trace(l2, axis1=-2, axis2=-1)[..., None, None] * np.eye(3) / 3
    return {"l0": rng.normal(size=(n, c)).astype(dtype),
            "l1": rng.normal(size=(n, c, 3)).astype(dtype),
            "l2": l2.astype(dtype)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


# ------------------------------------------------------ tensor products ---

@pytest.mark.parametrize("path", list(jgc.TP_PATHS))
def test_tensor_product_path_matches_jax(path):
    """Channel-aligned (MACE's node products) and broadcast against a
    channel-1 edge basis (NequIP's messages)."""
    la, lb, _ = path
    rng = np.random.default_rng(sum(path))
    a = _rng_feats(rng, 5, 4)[f"l{la}"]
    for b in (_rng_feats(rng, 5, 4)[f"l{lb}"],
              _rng_feats(rng, 5, 1)[f"l{lb}"]):
        want = jgc.TP_PATHS[path](jnp.asarray(a), jnp.asarray(b))
        got = tgc.TP_PATHS[path](torch.from_numpy(a), torch.from_numpy(b))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TP_TOL)
    assert list(tgc.TP_PATHS) == list(jgc.TP_PATHS)
    for l_max in (0, 1, 2):
        assert tgc.paths_for(l_max) == jgc.paths_for(l_max)


def test_substrate_functions_match_jax():
    rng = np.random.default_rng(1)
    f, g = _rng_feats(rng, 6, 4), _rng_feats(rng, 6, 4)
    w = {l: rng.normal(size=(4, 5)).astype(np.float32)
         for l in ("l0", "l1", "l2")}
    m = rng.normal(size=(6, 3, 3)).astype(np.float32)
    rhat = rng.normal(size=(9, 3)).astype(np.float32)
    rhat /= np.linalg.norm(rhat, axis=1, keepdims=True)
    r = np.abs(rng.normal(size=9)).astype(np.float32) * 4
    r[0] = 0.0  # clamped at 1e-9
    rot = tgc.random_rotation(rng)
    pairs = [
        (jgc.sym_traceless(jnp.asarray(m)), tgc.sym_traceless(
            torch.from_numpy(m))),
        (jgc.bessel_basis(jnp.asarray(r), 6, 5.0),
         tgc.bessel_basis(torch.from_numpy(r), 6, 5.0)),
        (jgc.invariants(_j(f)), tgc.invariants(_t(f))),
    ]
    for want, got in zip(jgc.edge_basis(jnp.asarray(rhat), 2).values(),
                         tgc.edge_basis(torch.from_numpy(rhat), 2).values()):
        pairs.append((want, got))
    for jfn, tfn, args in (
            (jgc.linear_mix, tgc.linear_mix, (w, f)),
            (jgc.gate, tgc.gate, (f, {"l1": w["l1"][:, :4],
                                      "l2": w["l2"][:, :4]})),
            (jgc.add_feats, tgc.add_feats, (f, g)),
            (jgc.norm_feats, tgc.norm_feats, (f,)),
            (jgc.rotate_feats, tgc.rotate_feats, (f, rot))):
        jw = jfn(*(_j(a) if isinstance(a, dict) else jnp.asarray(a)
                   for a in args))
        tw = tfn(*(_t(a) if isinstance(a, dict) else torch.from_numpy(a)
                   for a in args))
        assert list(tw) == list(jw)
        pairs += [(jw[k], tw[k]) for k in jw]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TP_TOL)
    assert np.array_equal(tgc.EPS3.numpy(), np.asarray(jgc.EPS3))
    z = tgc.zeros_feats(3, 2, 1)
    assert {k: tuple(v.shape) for k, v in z.items()} == \
        {k: v.shape for k, v in jgc.zeros_feats(3, 2, 1).items()}


class _TwoRankMesh:
    axis_names = ("data", "model")
    shape = {"data": 2, "model": 1}


def test_constrain_accepts_only_none():
    """A mesh axis constrains nothing with no mesh current (as on one
    card), so a config naming one computes what the unnamed one does;
    under a mesh of two ranks a plain tensor is refused."""
    x = torch.zeros(3)
    assert tgc.constrain_rows(x, None) is x
    assert tgc.constrain_rows(x, "data") is x
    assert tgc.constrain_feats({"l0": x}, ("data", "model"))["l0"] is x
    mod = configs.get("egnn")
    cfg = mod.smoke_config(task="node_class", node_ax="model",
                           edge_ax="data")
    params = mod.MODULE.init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _t(_np_batch("node_class"))
    plain = dataclasses.replace(cfg, node_ax=None, edge_ax=None)
    assert torch.equal(mod.MODULE.loss_fn(params, batch, cfg)[0],
                       mod.MODULE.loss_fn(params, batch, plain)[0])
    with mesh_lib.use_mesh(_TwoRankMesh()):
        with pytest.raises(ValueError, match="mesh"):
            tgc.constrain_rows(x, "data")
        with pytest.raises(ValueError, match="mesh"):
            mod.MODULE.loss_fn(params, batch, cfg)


def test_tensor_products_are_equivariant():
    """The reference's test on the port: every path commutes with a
    rotation (rtol 2e-4, atol 2e-5)."""
    rng = np.random.default_rng(0)
    rot = torch.from_numpy(tgc.random_rotation(np.random.default_rng(9)))
    f, g = _t(_rng_feats(rng, 4, 3)), _t(_rng_feats(rng, 4, 3))
    fr, gr = tgc.rotate_feats(f, rot), tgc.rotate_feats(g, rot)
    for (la, lb, lo), fn in tgc.TP_PATHS.items():
        out = fn(f[f"l{la}"], g[f"l{lb}"])
        out_r = fn(fr[f"l{la}"], gr[f"l{lb}"])
        want = tgc.rotate_feats({f"l{lo}": out, "l0": f["l0"] * 0}, rot)[
            f"l{lo}"] if lo > 0 else out
        np.testing.assert_allclose(out_r.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=f"path {(la, lb, lo)}")


# --------------------------------------------------------------- models ---

def _np_batch(task, n_graphs=2, n_nodes=6, n_edges=12, d_feat=6, seed=0):
    """The reference's ``graph_batch`` (tests/test_models.py) in numpy."""
    g = jbatch.pack_dense_batch(n_graphs, n_nodes, n_edges, seed=seed)
    rng = np.random.default_rng(seed)
    n = n_graphs * n_nodes
    b = {k: np.asarray(getattr(g, k)) for k in ("src", "dst", "edge_mask",
                                                 "graph_id")}
    b["node_mask"] = np.asarray(g.node_mask, np.float32)
    b["x"] = rng.normal(size=(n, d_feat)).astype(np.float32)
    b["pos"] = rng.normal(size=(n, 3)).astype(np.float32)
    if task == "energy":
        b["energy"] = rng.normal(size=(n_graphs,)).astype(np.float32)
        b["forces"] = rng.normal(size=(n, 3)).astype(np.float32)
    else:
        b["labels"] = rng.integers(0, N_CLASSES, n).astype(np.int32)
    return b


def _f64(arch, task):
    return arch == "mace" and task == "energy"


def _cast(tree, f64):
    dt = np.float64 if f64 else np.float32
    return jax.tree.map(lambda a: np.asarray(a, dt) if np.issubdtype(
        np.asarray(a).dtype, np.floating) else np.asarray(a), tree)


@functools.lru_cache(maxsize=None)
def _jax_answer(arch, task):
    """(config dict, numpy params, numpy batch, loss, grad leaves) of the
    arch's smoke config from the JAX package, once per (arch, task)."""
    f64 = _f64(arch, task)
    with jax.enable_x64(f64):
        jcfg = JAX_CONFIGS[arch].smoke_config(
            task=task, n_classes=N_CLASSES,
            dtype=jnp.float64 if f64 else jnp.float32)
        model = JAX_CONFIGS[arch].MODULE
        params = _cast(model.init(jax.random.PRNGKey(0), jcfg), f64)
        batch = _cast(_np_batch(task), f64)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: model.loss_fn(p, b, jcfg), has_aux=True))(
            jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, batch))
        return (dataclasses.asdict(jcfg), params, batch, float(loss),
                [np.asarray(g) for g in jax.tree.leaves(grads)])


def _port_loss_and_grads(arch, task, remat):
    cfg_d, params_np, batch_np, _, _ = _jax_answer(arch, task)
    cfg = dataclasses.replace(carry.gnn_config_from_dict(cfg_d),
                              remat=remat)
    params = carry.gnn_params_from_numpy(params_np, cfg, "cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss, _ = configs.get(arch).MODULE.loss_fn(params, _t(batch_np), cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.item(), grads


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("task", ["energy", "node_class"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch, task, remat):
    *_, want_loss, want_grads = _jax_answer(arch, task)
    loss, grads = _port_loss_and_grads(arch, task, remat)
    assert loss == pytest.approx(want_loss, rel=1e-5)
    assert len(grads) == len(want_grads)
    for g, w in zip(grads, want_grads):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


def _f32_error_over_tolerance(arch):
    """The largest |f32 - f64| / (atol + rtol |f64|) over the energy
    loss's gradient leaves of the port's smoke config, one set of
    weights: how far f32 alone stands from the GRAD_TOL comparison."""
    mod = configs.get(arch)
    cfg = mod.smoke_config(task="energy", n_classes=N_CLASSES)
    params = mod.MODULE.init(cfg, torch.Generator().manual_seed(0), "cpu")
    grads = []
    for dt in (torch.float32, torch.float64):
        p = tree_map(lambda x: x.detach().to(dt).requires_grad_(), params)
        b = {k: v.to(dt) if v.is_floating_point() else v
             for k, v in _t(_np_batch("energy")).items()}
        loss, _ = mod.MODULE.loss_fn(p, b, dataclasses.replace(cfg,
                                                               dtype=dt))
        grads.append(torch.autograd.grad(loss, tree_leaves(p),
                                         allow_unused=True,
                                         materialize_grads=True))
    return max(float(((g.double() - w).abs()
                      / (GRAD_TOL["atol"] + GRAD_TOL["rtol"] * w.abs())).max())
               for g, w in zip(*grads))


def test_mace_energy_f32_is_beyond_the_tolerance():
    """Why MACE's energy task is compared in f64: in f32 its force loss's
    gradients stand over 10x the tolerance from its own f64 answer (the
    second derivative through norms of near-zero features), while
    NequIP's f32 gradients stay inside it."""
    assert _f32_error_over_tolerance("mace") > 10
    assert _f32_error_over_tolerance("nequip") < 1


def test_remat_equals_no_remat_exactly():
    """Checkpointed layers recompute the same ops: the same gradients bit
    for bit, through the force loss's second derivative too."""
    for arch in ("egnn", "nequip"):
        _, plain = _port_loss_and_grads(arch, "energy", False)
        _, remat = _port_loss_and_grads(arch, "energy", True)
        assert all(torch.equal(a, b) for a, b in zip(plain, remat))


def test_params_and_config_carry_both_ways():
    for arch in ARCHS:
        cfg_d, params_np, *_ = _jax_answer(arch, "node_class")
        cfg = carry.gnn_config_from_dict(cfg_d)
        assert carry.gnn_config_to_dict(cfg) == dict(cfg_d, dtype="float32")
        back = carry.gnn_params_to_numpy(
            carry.gnn_params_from_numpy(params_np, cfg, "cpu"))
        assert jax.tree.structure(back) == jax.tree.structure(params_np)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params_np)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        # the port's own init builds the same tree, layers stacked on [L]
        own = configs.get(arch).MODULE.init(
            cfg, torch.Generator().manual_seed(0), "cpu")
        assert [tuple(x.shape) for x in tree_leaves(own)] == \
            [x.shape for x in jax.tree.leaves(params_np)]
        assert tcommon.count_params(own) == jcommon.count_params(params_np)


# ------------------------------------------------------------ equivariance

def _port_smoke(arch, **kw):
    cfg = configs.get(arch).smoke_config(n_graphs=2, **kw)
    params = configs.get(arch).MODULE.init(
        cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, params, _t(_np_batch("energy"))


@pytest.mark.parametrize("arch", ["nequip", "mace"])
def test_energy_is_rotation_invariant(arch):
    cfg, params, batch = _port_smoke(arch)
    model = configs.get(arch).MODULE
    rot = torch.from_numpy(tgc.random_rotation(np.random.default_rng(7)))
    e1 = model.node_energy(params, batch["pos"], batch, cfg)
    e2 = model.node_energy(params, batch["pos"] @ rot.T, batch, cfg)
    np.testing.assert_allclose(e1.detach().numpy(), e2.detach().numpy(),
                               rtol=5e-4, atol=5e-5)


def test_egnn_positions_rotate_with_the_input():
    cfg, params, batch = _port_smoke("egnn")
    model = configs.get("egnn").MODULE
    rot = torch.from_numpy(tgc.random_rotation(np.random.default_rng(8)))
    _, pos1 = model._forward(params, batch["pos"], batch, cfg)
    _, pos2 = model._forward(params, batch["pos"] @ rot.T, batch, cfg)
    np.testing.assert_allclose((pos1 @ rot.T).detach().numpy(),
                               pos2.detach().numpy(), rtol=2e-3, atol=2e-4)


# ----------------------------------------------------- chunked NequIP ---

def _chunk_case(remat=False):
    cfg, params, batch = _port_smoke("nequip", d_hidden=4, remat=remat)
    assert batch["src"].shape[0] == 24  # -> 3 chunks of 8
    return cfg, dataclasses.replace(cfg, edge_chunk=8), params, batch


@pytest.mark.parametrize("remat", [False, True])
def test_chunked_nequip_equals_unchunked(remat):
    """Energies within rtol 1e-5 / atol 1e-6; first-order gradients for
    the params and the positions within rtol 2e-3 / atol 1e-5, the
    reference's chunking tolerances."""
    cfg, cfg_c, params, batch = _chunk_case(remat)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    out = []
    for c in (cfg, cfg_c):
        pos = batch["pos"].clone().requires_grad_()
        e = tnequip.node_energy(params, pos, batch, c)
        out.append((e.detach(), torch.autograd.grad(e.sum(), leaves + [pos])))
    (e1, g1), (e2, g2) = out
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), rtol=1e-5, atol=1e-6)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=1e-5)
    # node classification: the loss's gradient through the chunks
    ccfg = dataclasses.replace(cfg, task="node_class")
    nb = _t(_np_batch("node_class"))
    grads = [torch.autograd.grad(tnequip.loss_fn(params, nb, c)[0], leaves)
             for c in (ccfg, dataclasses.replace(ccfg, edge_chunk=8))]
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=1e-5)


def test_chunked_nequip_refuses_a_second_derivative():
    cfg, cfg_c, params, batch = _chunk_case()
    for p in tree_leaves(params):
        p.requires_grad_()
    loss, _ = tnequip.loss_fn(params, batch, cfg)  # unchunked: force loss
    assert torch.isfinite(loss)
    with pytest.raises(RuntimeError, match="first-order only"):
        tnequip.loss_fn(params, batch, cfg_c)


def _saved_bytes_per_edge(pos_grad, e=4000, c=32):
    """Bytes an edge of NequIP's message computation keeps for its
    backward (saved tensors, each storage once, the inputs excluded)."""
    cfg = configs.get("nequip").config(task="node_class", n_classes=5)
    g = torch.Generator().manual_seed(0)
    p = tree_map(lambda x: x[0].detach().requires_grad_(),
                 tnequip.init(cfg, g, "cpu")["layers"])
    feats = {l: torch.randn((e, c) + s, generator=g, requires_grad=True)
             for l, s in (("l0", ()), ("l1", (3,)), ("l2", (3, 3)))}
    pos = torch.randn(e, 3, generator=g, requires_grad=pos_grad)
    src, dst = torch.randint(0, e, (2, e), generator=g)
    inputs = {x.untyped_storage().data_ptr()
              for x in [pos, *feats.values()]}
    kept = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in inputs:
            kept[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tnequip._chunk_messages(p, feats, pos, src, dst,
                                torch.ones(e, dtype=torch.bool), e, cfg)
    return sum(kept.values()) / e


def test_messages_keep_no_edge_product_for_the_backward():
    """With fixed positions (node classification, ogb_products' chunks)
    an edge keeps its gathered features (416 floats at 32 channels),
    radial weights (480) and basis for the backward, not its 15 [C, ...]
    path products (2400 floats): under 6 KB an edge.  With positions
    under a gradient (forces) the products are kept."""
    assert _saved_bytes_per_edge(False) < 6000 < _saved_bytes_per_edge(True)


def test_chunking_needs_a_dividing_chunk():
    """The reference's conditions: no chunking unless edge_chunk divides
    the edge count and is below it (the result is the unchunked one bit
    for bit)."""
    cfg, _, params, batch = _chunk_case()
    want = tnequip.node_energy(params, batch["pos"], batch, cfg)
    for ck in (7, 24, 48):
        got = tnequip.node_energy(params, batch["pos"], batch,
                                  dataclasses.replace(cfg, edge_chunk=ck))
        assert torch.equal(got, want)


# -------------------------------------------------------------- trainer ---

OPT = dict(lr=1e-3, warmup_steps=3, total_steps=10)


def test_trainer_step_matches_jax():
    """One step of each package's Trainer on the launcher's smoke graph
    (egnn, node classification) from one set of weights: metrics, params
    and moments within 2e-4."""
    from repro.data import pipeline as jpipe
    from repro_torch.data import pipeline as tpipe

    jcfg = j_egnn.smoke_config(task="node_class", n_classes=7)
    params_np = jax.tree.map(np.asarray, j_egnn.MODULE.init(
        jax.random.PRNGKey(0), jcfg))
    jgraph = jpipe.node_class_graph(200, 1000, jcfg.d_feat, 7, seed=0)
    jt = jtrainer.Trainer(
        lambda p, b: j_egnn.MODULE.loss_fn(p, b, jcfg),
        jax.tree.map(jnp.asarray, params_np), jopt.AdamWConfig(**OPT),
        jtrainer.TrainerConfig(total_steps=1, log_every=1),
        lambda s: jgraph)
    cfg = carry.gnn_config_from_dict(dataclasses.asdict(jcfg))
    tgraph = tpipe.node_class_graph(200, 1000, cfg.d_feat, 7, seed=0,
                                    device="cpu")
    tt = ttrainer.Trainer(
        lambda p, b: configs.get("egnn").MODULE.loss_fn(p, b, cfg),
        carry.gnn_params_from_numpy(params_np, cfg, "cpu"),
        topt.AdamWConfig(**OPT),
        ttrainer.TrainerConfig(total_steps=1, log_every=1),
        lambda s: tgraph)
    (_, jm), = jt.run()
    (_, tm), = tt.run()
    for k in ("loss", "ce", "acc", "grad_norm", "lr"):
        assert tm[k] == pytest.approx(jm[k], rel=2e-4, abs=2e-5), k
    want = jax.tree.map(np.asarray, {k: jt.state[k] for k in
                                     ("params", "opt")})
    got = carry.train_state_to_numpy(tt.state)
    for w, g in ((want["params"], got["params"]),
                 (want["opt"].m, got["opt"]["m"]),
                 (want["opt"].v, got["opt"]["v"])):
        assert jax.tree.structure(g) == jax.tree.structure(w)
        for a, b in zip(jax.tree.leaves(w), jax.tree.leaves(g)):
            np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-4)
    assert got["opt"]["count"] == 1
    back = carry.train_state_from_numpy(got, cfg, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(back["params"]), tree_leaves(tt.state["params"])))
