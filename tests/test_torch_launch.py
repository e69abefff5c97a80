"""The port's launch layer (``repro_torch.launch.{mesh,partition,steps}``)
against the JAX package's, in one process on the CPU.

Spec trees are compared leaf by leaf, JAX's ``PartitionSpec`` as a tuple,
for every arch's full config on a 16x16 and a 2x16x16 mesh-like object
(the reference's tests' FakeMesh); model FLOPs are integers and must be
equal; ``build``'s meta and skips are held to JAX's ``build`` on a 1x1
mesh of this one device.  The multi-rank runs (gloo, a fake process
group) are in ``test_torch_launch_dist.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.kernels import reach_blockmm as jrb
from repro.launch import partition as jpart
from repro.launch import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.core import dynamic as tdyn
from repro_torch.core import graph_state as tgs
from repro_torch.data import pipeline as tpipeline
from repro_torch.kernels.reach_blockmm import ops as trb
from repro_torch.kernels.reach_blockmm import ref as trb_ref
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import partition as tpart
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import P
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.gnn import common as tgc
from repro_torch.tree import tree_leaves, tree_map


class FakeMesh:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


MESHES = {"16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16)}
LM_ARCHS = [a for a in tconfigs.ARCHS if tconfigs.get(a).FAMILY == "lm"]
GNN_ARCHS = [a for a in tconfigs.ARCHS if tconfigs.get(a).FAMILY == "gnn"]


def _plain(tree):
    """A spec tree of either package as nested dicts / lists of tuples
    (NamedTuples as dicts of their fields)."""
    if isinstance(tree, (P, JP)):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {f: _plain(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, (list, tuple)):
        return [_plain(x) for x in tree]
    return tree


def _both(arch):
    return jconfigs.get(arch), tconfigs.get(arch)


@pytest.fixture(params=sorted(MESHES))
def mesh(request):
    return FakeMesh(**MESHES[request.param])


# ----------------------------------------------------------------- specs ---

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_specs_equal_jax(arch, mesh):
    jmod, tmod = _both(arch)
    jcfg, tcfg = jmod.config(), tmod.config()
    assert _plain(tpart.lm_param_specs(tcfg, mesh)) == \
        _plain(jpart.lm_param_specs(jcfg, mesh))
    assert _plain(tpart.lm_batch_specs(mesh)) == \
        _plain(jpart.lm_batch_specs(mesh))
    for batch in (128, 1):
        assert _plain(tpart.lm_cache_specs(tcfg, mesh, batch)) == \
            _plain(jpart.lm_cache_specs(jcfg, mesh, batch))
    tspecs = tpart.opt_state_specs(tpart.lm_param_specs(tcfg, mesh))
    jspecs = jpart.opt_state_specs(jpart.lm_param_specs(jcfg, mesh))
    assert _plain(tspecs) == _plain(jspecs)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_specs_equal_jax(arch, mesh):
    jmod, tmod = _both(arch)
    jparams = jax.eval_shape(lambda: jmod.MODULE.init(
        jax.random.PRNGKey(0), jmod.config()))
    tparams = tmod.MODULE.init(tmod.config(), torch.Generator(), "meta")
    tspecs = tpart.gnn_param_specs(tparams)
    jspecs = jpart.gnn_param_specs(jparams)
    assert _plain(tspecs) == _plain(jspecs)
    assert _plain(tpart.opt_state_specs(tspecs)) == \
        _plain(jpart.opt_state_specs(jspecs))
    # node counts dividing every rank, only 'model', and neither
    for n in (512 * 16, 16 * 3, 50):
        assert tpart.gnn_node_axis(mesh, n) == jpart.gnn_node_axis(mesh, n)
        for ax in ("auto", None, "model"):
            assert _plain(tpart.gnn_batch_specs(mesh, n, 4 * n, ax)) == \
                _plain(jpart.gnn_batch_specs(mesh, n, 4 * n, ax))


def test_mind_specs_equal_jax(mesh):
    jmod, tmod = _both("mind")
    for kw in ({}, dict(n_items=1000, profile_vocab=30)):
        jcfg, tcfg = jmod.config(**kw), tmod.config(**kw)
        assert _plain(tpart.mind_param_specs(tcfg, mesh)) == \
            _plain(jpart.mind_param_specs(jcfg, mesh))
    for batch, cand in ((512, 2048), (1, 1_000_000), (100, 30)):
        for with_c in (False, True):
            assert _plain(tpart.mind_batch_specs(mesh, batch, with_c,
                                                 cand)) == \
                _plain(jpart.mind_batch_specs(mesh, batch, with_c, cand))


def test_smscc_specs_equal_jax(mesh):
    assert _plain(tpart.smscc_state_specs(mesh)) == \
        _plain(jpart.smscc_state_specs(mesh))
    assert _plain(tpart.smscc_ops_specs(mesh)) == \
        _plain(jpart.smscc_ops_specs(mesh))


def test_lm_param_specs_match_tree():
    """Every port param has a spec (the reference's test, on the port's
    per-layer list)."""
    for arch in ("qwen3-14b", "moonshot-v1-16b-a3b"):
        cfg = tconfigs.get(arch).smoke_config()
        params = ttf.init(cfg, torch.Generator(), device="meta")
        specs = tsteps.lm_port_param_specs(
            tpart.lm_param_specs(cfg, FakeMesh(data=16, model=16)),
            cfg.n_layers)
        tree_map(lambda t, s: None, params, specs)


def test_divisibility_fallbacks():
    cfg = tconfigs.get("qwen3-14b").config()
    specs = tpart.lm_param_specs(cfg, FakeMesh(data=16, model=16))
    assert specs["embed"][0] == "model"    # vocab 151936 % 16 == 0
    assert specs["layers"]["wk"][2] == "model"  # kv dim 1024 % 16 == 0


# ----------------------------------------------------------- model FLOPs ---

def _gnn_dims(shape, n_ranks=256):
    from repro.configs import gnn_shapes
    if shape["kind"] == "train_mol":
        n, e = (shape["batch"] * shape["n_nodes"],
                shape["batch"] * shape["n_edges"])
    elif shape["kind"] == "train_sampled":
        n, e = gnn_shapes.sampled_block_dims(shape)
    else:
        n, e = shape["n_nodes"], shape["n_edges"]
    return -(-n // n_ranks) * n_ranks, -(-e // n_ranks) * n_ranks


@pytest.mark.parametrize("arch", tconfigs.all_archs(include_paper=False))
def test_model_flops_equal_jax(arch):
    jmod, tmod = _both(arch)
    for name, shape in tmod.SHAPES.items():
        if tmod.FAMILY == "lm":
            jcfg, tcfg = jmod.config(), tmod.config()
            args = (shape["kind"], shape["global_batch"], shape["seq"])
            got = tsteps.lm_model_flops(tcfg, *args)
            want = jsteps.lm_model_flops(jcfg, *args)
        elif tmod.FAMILY == "gnn":
            n, e = _gnn_dims(shape)
            got = tsteps.gnn_model_flops(arch, tmod.config(), n, e)
            want = jsteps.gnn_model_flops(arch, jmod.config(), n, e)
        else:
            args = (shape["kind"], shape["batch"], shape.get("n_cand", 0))
            got = tsteps.mind_model_flops(tmod.config(), *args)
            want = jsteps.mind_model_flops(jmod.config(), *args)
        assert isinstance(got, int) and got == want, (name, got, want)


# ----------------------------------------------------------------- build ---

@pytest.mark.parametrize("arch,shape", [
    ("qwen3-14b", "train_4k"), ("moonshot-v1-16b-a3b", "prefill_32k"),
    ("gemma3-12b", "decode_32k"), ("gatedgcn", "molecule"),
    ("nequip", "ogb_products"), ("mind", "serve_p99"),
    ("smscc", "update_1m"), ("smscc", "community_query")])
def test_build_meta_equals_jax(arch, shape):
    jb = jsteps.build(arch, shape, jax.make_mesh((1, 1), ("data", "model")))
    tb = tsteps.build(arch, shape, FakeMesh(data=1, model=1))
    assert (tb.name, tb.meta, tb.donate) == (jb.name, jb.meta, jb.donate)
    for t in tree_leaves(tb.args):
        assert not isinstance(t, torch.Tensor) or t.device.type == "meta"


def test_skip_cells_are_none():
    jm = jax.make_mesh((1, 1), ("data", "model"))
    skips = [(a, s) for a in tconfigs.all_archs()
             for s, sh in tconfigs.get(a).SHAPES.items() if sh.get("skip")]
    assert ("qwen3_14b", "long_500k") in skips
    for arch, shape in skips:
        assert jsteps.build(arch, shape, jm) is None
        assert tsteps.build(arch, shape, FakeMesh(data=16, model=16)) is None


def test_build_rules_on_the_production_mesh():
    """The reference's rules: training shardings, the MoE group count, the
    node axis and 32 edge chunks over 2^22 edges."""
    m = FakeMesh(pod=2, data=16, model=16)
    b = tsteps.build("moonshot-v1-16b-a3b", "train_4k", m, lm_layers=1)
    assert b.in_shardings[2]["tokens"] == P(("pod", "data"), None)
    lm = tsteps._lm_apply_shardings(
        tconfigs.get("moonshot-v1-16b-a3b").config(), m, "train", 256 * 4096)
    assert (lm.act_spec, lm.remat, lm.attn_impl, lm.moe.n_groups) == \
        (P(("pod", "data"), "model", None), "full", "chunked", 256)
    g = tsteps.build("nequip", "ogb_products", m)
    assert g.meta["edge_chunks"] == 32 and g.meta["edges"] % 512 == 0
    assert g.in_shardings[2]["x"] == P(("pod", "data", "model"), None)


# ---------------------------------------------------- refusals, closed ---

TWO = FakeMesh(data=2, model=1)
ONE = FakeMesh(data=1, model=1)


def test_constrain_identity_without_a_mesh_or_on_one_rank():
    x = torch.arange(6.0).reshape(3, 2)
    assert tmesh.constrain(x, P("data", None)) is x
    with tmesh.use_mesh(ONE):
        assert tmesh.current_mesh() is ONE
        assert tmesh.constrain(x, P("data", "model")) is x
    assert tmesh.current_mesh() is None
    with tmesh.use_mesh(TWO), pytest.raises(ValueError, match="P\\('data'"):
        tmesh.constrain(x, P("data", None))


def test_sharding_sits_below_the_port():
    """``repro_torch.sharding`` imports nothing of the port, and no module
    outside ``launch/`` imports the launch layer's mesh, partition, steps
    or dry-run (they import the models, never the reverse); on a plain
    tensor
    ``unshard_dim`` and ``constrain`` hand back the tensor itself."""
    import ast
    import pathlib

    from repro_torch import sharding

    port = pathlib.Path(sharding.__file__).parent

    def imports(path):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                yield from (f"{node.module}.{a.name}" for a in node.names)
            elif isinstance(node, ast.Import):
                yield from (a.name for a in node.names)

    assert not [m for m in imports(port / "sharding.py")
                if m.startswith("repro_torch")]
    layer = tuple(f"repro_torch.launch.{m}"
                  for m in ("mesh", "partition", "steps", "dryrun"))
    for path in port.rglob("*.py"):
        if path.parent.name != "launch":
            bad = [m for m in imports(path) if m.startswith(layer)]
            assert not bad, (path, bad)
    assert tmesh.constrain is sharding.constrain and tmesh.P is P
    x = torch.zeros(2, 3, 4)
    assert sharding.unshard_dim(x, 1) is x
    assert sharding.constrain(x, P("data", "model", None)) is x


def _scc_inputs(label_spec=None, device="cpu"):
    from repro_torch.configs import smscc
    cfg = smscc.smoke_config(label_spec=label_spec)
    rng = np.random.default_rng(0)
    src = torch.as_tensor(rng.integers(0, 64, 150), dtype=torch.int32)
    dst = torch.as_tensor(rng.integers(0, 64, 150), dtype=torch.int32)
    state = tgs.from_arrays(cfg, src, dst, device=device)
    ops = tdyn.make_ops(torch.tensor([0, 1, 0, 1], dtype=torch.int32),
                        torch.tensor([1, 2, 3, 4], dtype=torch.int32),
                        torch.tensor([5, 6, 7, 8], dtype=torch.int32))
    return cfg, state, ops


def test_label_spec_is_accepted():
    cfg, state, ops = _scc_inputs(label_spec=P(None))
    plain, _, _ = _scc_inputs()
    got = tdyn.recompute(state, cfg)
    want = tdyn.recompute(state, plain)
    assert torch.equal(got.ccid, want.ccid)
    s1, ok1 = tdyn.apply_batch(got, ops, cfg)
    s2, ok2 = tdyn.apply_batch(want, ops, plain)
    assert torch.equal(s1.ccid, s2.ccid) and torch.equal(ok1, ok2)
    with tmesh.use_mesh(TWO), pytest.raises(ValueError, match="mesh"):
        tdyn.recompute(state, cfg)


def test_expert_spec_maps_onto_the_index_buffer():
    assert tmoe._buffer_spec(P("model", ("pod", "data"), None, None)) == \
        P("model", ("pod", "data"), None)
    assert tmoe._buffer_spec(P("model", "data", "model", None)) == \
        P("model", ("data", "model"), None)
    assert tmoe._buffer_spec(None) is None


def test_gnn_axes_raise_for_a_plain_tensor_under_two_ranks():
    x = torch.zeros(4, 3)
    assert tgc.constrain_rows(x, ("data", "model")) is x
    with tmesh.use_mesh(TWO), pytest.raises(ValueError, match="mesh"):
        tgc.constrain_feats({"l0": x}, "model")


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    m = FakeMesh(pod=2, data=16, model=16)
    assert tmesh.placements(P(("pod", "data"), "model"), m) == \
        (Shard(0), Shard(0), Shard(1))
    assert tmesh.placements(P(None, ("data", "model")), m) == \
        (Replicate(), Shard(1), Shard(1))
    assert tmesh.placements(P(), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        tmesh.placements(P(("model", "data")), m)


def test_production_mesh_needs_its_process_group():
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("a process group is already up in this worker")
    with pytest.raises(RuntimeError, match="256 ranks"):
        tmesh.make_production_mesh(device_type="cpu")
    assert tmesh.data_axes(FakeMesh(pod=2, data=16, model=16)) == \
        ("pod", "data")


def test_config_registry_aliases():
    assert tconfigs.ALIASES["qwen3-14b"] == "qwen3_14b"
    assert tconfigs.all_archs() == jconfigs.all_archs()
    assert tconfigs.all_archs(False) == jconfigs.all_archs(False)
    assert tconfigs.get("h2o-danube-3-4b").FAMILY == "lm"


# ----------------------------------------------------- small functions ---

def test_frontier_step_and_closure_equal_jax():
    rng = np.random.default_rng(0)
    n = 40
    adj = rng.random((n, n)) < 0.08
    f = np.zeros((n, 4), bool)
    f[[3, 11, 17, 29], np.arange(4)] = True
    jadj, jf = jnp.asarray(adj), jnp.asarray(f)
    tadj, tf_ = torch.as_tensor(adj), torch.as_tensor(f)
    want = np.asarray(jrb.ref.frontier_step(jadj, jf))
    for got in (trb.frontier_step(tadj, tf_), trb_ref.frontier_step(tadj, tf_)):
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jrb.ref.closure(jadj))
    for got in (trb.closure(tadj), trb_ref.closure(tadj)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_op_stream_alias_equals_jax():
    for step in (0, 3):
        want = jpipeline.op_stream(64, 16, step=step, add_frac=0.8)
        got = tpipeline.op_stream(64, 16, step=step, add_frac=0.8,
                                  info=tpipeline.ShardInfo(0, 1))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
