"""The port's launch layer across ranks on the CPU: gloo process groups of
2, 4 and 8 ranks, one subprocess a rank (each with its own timeout and
one thread).

* a sharded train step of the qwen3 smoke config on a 2x2 mesh (chunked
  attention, remat "full", as ``steps`` sets them) equals the one-device
  step: loss within 1e-5 relative, gradients within rtol 2e-4 / atol
  2e-5, with no op replicated and the projections, norms and layer
  outputs sharded; a dim split over two mesh axes lies as JAX splits
  it; an op DTensor cannot partition runs replicated under
  ``sharded_ops``;
* ``compressed_psum`` over a ("pod",) axis equals the mean of each rank's
  dequantized gradients, and a Trainer with ``pod_axis`` keeps the ranks
  equal;
* a checkpoint saved by one process restores onto a 4x2 mesh of 8 ranks
  with its values exact (the reference's elastic-restore test).
"""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import torch

from repro_torch.ckpt import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, port = map(int, sys.argv[1:4])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(body: str, n: int, *argv, timeout: float = 300.0) -> list:
    """Run PRELUDE + ``body`` as ``n`` gloo ranks; returns each rank's
    (returncode, stdout, stderr)."""
    env = {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": os.environ.get(
        "PATH", "/usr/bin:/bin"), "OMP_NUM_THREADS": "1",
        "HOME": os.environ.get("HOME", ROOT)}
    port = _free_port()
    script = PRELUDE + textwrap.dedent(body)
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(n), str(port), *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _check(outs, token):
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0 and token in out, f"rank {r}: rc {rc}\n{err[-3000:]}"


LM_STEP = """
    import collections
    import types
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import qwen3_14b
    from repro_torch.data import pipeline
    from repro_torch.launch import mesh as ml, partition, steps
    from repro_torch.launch.mesh import P
    from repro_torch.models import transformer as tf
    from repro_torch.optim import optimizer
    from repro_torch.tree import tree_leaves, tree_map

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    batch, seq = 4, 16
    cfg = steps._lm_apply_shardings(qwen3_14b.smoke_config(), mesh, "train",
                                    batch * seq)
    assert (cfg.remat, cfg.attn_impl) == ("full", "chunked")
    assert cfg.act_spec == P("data", "model", None)
    params = tf.init(cfg, torch.Generator().manual_seed(0), "cpu")
    b = pipeline.lm_batch(cfg.vocab, batch, seq, step=0, device="cpu")
    pspecs = steps.lm_port_param_specs(partition.lm_param_specs(cfg, mesh),
                                       cfg.n_layers)
    bspecs = partition.lm_batch_specs(mesh)

    def shard(tree, specs):
        return tree_map(lambda t, s: ml.distribute(t.detach().clone(), s,
                                                   mesh), tree, specs)

    def value_and_grads(p, x):
        leaves = [t.requires_grad_() for t in tree_leaves(p)]
        loss, _ = tf.loss_fn(p, x, cfg)
        return loss, torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True)

    # the layout the sharded run gives the layer's tensors: what reaches
    # each unshard_dim (a gather) and each layer's output before its
    # constrain, forward and remat recompute alike
    from torch.distributed.tensor import DTensor, Replicate, Shard
    seen = collections.Counter()
    unshard, layer_fwd = tf.unshard_dim, tf._layer_fwd

    def layout(x):
        return tuple(x.placements) if isinstance(x, DTensor) else "plain"

    def unshard_spy(x, dim):
        seen[dim, layout(x)] += 1
        return unshard(x, dim)

    def layer_spy(*a, **k):
        y, kv, aux = layer_fwd(*a, **k)
        seen["y", layout(y)] += 1
        return y, kv, aux

    loss1, g1 = value_and_grads(tree_map(torch.clone, params), b)
    tf.unshard_dim, tf._layer_fwd = unshard_spy, layer_spy
    with ml.sharded_ops(mesh) as ops:
        loss2, g2 = value_and_grads(shard(params, pspecs), shard(b, bspecs))
        loss2 = loss2.full_tensor()
        g2 = [g.full_tensor() for g in g2]
    tf.unshard_dim, tf._layer_fwd = unshard, layer_fwd
    rel = abs(loss2.item() - loss1.item()) / abs(loss1.item())
    assert rel <= 1e-5, rel
    for a, w in zip(g2, g1):
        torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-5)

    # it ran sharded: no op fell back to replicated operands; the norms
    # ran on the sequence-sharded stream (data x model), q, k and v came
    # out of column-parallel matmuls (fused head dim on "model"), only
    # the attention's output is whole on "model", and every layer's
    # output is sharded as act_spec before its constrain
    assert dict(ops.replicated) == {}, dict(ops.replicated)
    by_seq, by_col = (Shard(0), Shard(1)), (Shard(0), Shard(2))
    by_batch = (Shard(0), Replicate())
    assert set(seen) == {(1, by_seq), (-1, by_col), (-1, by_batch),
                         ("y", by_seq)}, seen
    assert seen[-1, by_col] == 3 * seen[-1, by_batch] > 0, seen
    assert seen["y", by_seq] >= cfg.n_layers, seen

    # the bundle's step (loss, gradient, AdamW) on the mesh == one device
    bundle = steps.build_lm(types.SimpleNamespace(
        config=qwen3_14b.smoke_config), "smoke",
        dict(kind="train", seq=seq, global_batch=batch), mesh)
    state = (params, optimizer.init(params), b)
    p1, _, l1 = bundle.fn(*tree_map(torch.clone, state))
    with ml.sharded_ops(mesh) as ops:
        p2, _, l2 = bundle.fn(*shard(state, bundle.in_shardings))
        l2 = l2.full_tensor()
        p2 = [t.full_tensor() for t in tree_leaves(p2)]
    assert dict(ops.replicated) == {}, dict(ops.replicated)
    assert abs(l2.item() - l1.item()) <= 1e-5 * abs(l1.item())
    for a, w in zip(p2, tree_leaves(p1)):
        torch.testing.assert_close(a, w.detach(), rtol=2e-4, atol=2e-5)

    # a dim over two axes splits data-major, as JAX splits it
    t = torch.arange(24.0).reshape(8, 3)
    d = ml.distribute(t, P(("data", "model"), None), mesh)
    assert torch.equal(d.to_local(), t[2 * rank:2 * rank + 2])
    assert torch.equal(d.full_tensor(), t)

    # an op DTensor cannot partition (5 rows from 10 columns over 2 ranks)
    # runs on replicated operands, the result resharded where it can be
    t = torch.arange(40.0).reshape(4, 10)
    with ml.sharded_ops(mesh) as fb:
        v = ml.distribute(t, P("data", "model"), mesh).view(4, 5, 2)
        assert torch.equal(v.full_tensor(), t.view(4, 5, 2))
    assert dict(fb.replicated) == {"view": 1}, dict(fb.replicated)
    print("LM_OK", loss1.item(), rel)
"""


def test_sharded_lm_train_step_equals_one_device():
    _check(run_ranks(LM_STEP, 4), "LM_OK")


POD = """
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import mesh as ml
    from repro_torch.optim import compression, optimizer
    from repro_torch.train import trainer
    from repro_torch.tree import tree_leaves, tree_map

    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("pod",))

    def grads_of(r):
        g = torch.Generator().manual_seed(10 + r)
        return {"w": torch.randn(5, 3, generator=g),
                "b": torch.randn(4, generator=g)}

    ef0 = compression.init(grads_of(0))
    deq = [compression.compressed_psum(grads_of(r), ef0, None)
           for r in range(2)]
    want = tree_map(lambda a, c: (a + c) / 2, deq[0][0], deq[1][0])
    with ml.use_mesh(mesh):
        got, ef = compression.compressed_psum(grads_of(rank), ef0, "pod")
    for a, w in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-6)
    for a, w in zip(tree_leaves(ef.err), tree_leaves(deq[rank][1].err)):
        assert torch.equal(a, w)

    # a Trainer with pod_axis: each rank its own data, the same update
    def loss_fn(p, x):
        return ((p["w"] - x["x"]) ** 2).sum(), {}

    def data_fn(step):
        return {"x": torch.full((3,), float(rank + step))}

    tr = trainer.Trainer(
        loss_fn, {"w": torch.zeros(3)},
        optimizer.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=10),
        trainer.TrainerConfig(total_steps=3, grad_compression=True,
                              pod_axis="pod"), data_fn)
    with ml.use_mesh(mesh):
        tr.run(3)
    w = tr.state["params"]["w"]
    both = [torch.empty_like(w) for _ in range(2)]
    dist.all_gather(both, w)
    assert torch.equal(both[0], both[1]) and bool(torch.isfinite(w).all())
    print("POD_OK")
"""


def test_compressed_psum_over_a_pod_axis():
    _check(run_ranks(POD, 2), "POD_OK")


ELASTIC = """
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.ckpt import checkpoint
    from repro_torch.launch import mesh as ml
    from repro_torch.launch.mesh import P

    like = {"w": torch.zeros(16, 4), "m": torch.zeros(16, 4),
            "step": torch.zeros((), dtype=torch.int32)}
    restored, step = checkpoint.restore(sys.argv[4], like)
    assert step == 3, step
    # onto a 4x2 mesh the single-process run that saved it never saw
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    w = ml.distribute(restored["w"], P("data", "model"), mesh)
    want = torch.arange(64, dtype=torch.float32).reshape(16, 4)
    i, j = divmod(rank, 2)
    assert torch.equal(w.to_local(), want[4 * i:4 * i + 4, 2 * j:2 * j + 2])
    assert torch.equal(w.full_tensor(), want)
    print("ELASTIC_OK")
"""


def test_elastic_restore_different_mesh(tmp_path):
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(16, 4),
            "m": torch.ones(16, 4), "step": torch.tensor(3, dtype=torch.int32)}
    checkpoint.save(str(tmp_path), 3, tree)
    _check(run_ranks(ELASTIC, 8, str(tmp_path)), "ELASTIC_OK")
    np.testing.assert_array_equal(
        checkpoint.restore(str(tmp_path), tree)[0]["w"].numpy(),
        tree["w"].numpy())


HOST = """
import torch
import torch.distributed as dist
from repro_torch.launch import mesh as ml
from repro_torch.launch.mesh import P

torch.set_num_threads(1)
assert not dist.is_initialized()
m = ml.make_host_mesh(device_type="cpu")  # starts its own one-rank group
assert tuple(m.shape) == (1, 1) and m.mesh_dim_names == ("data", "model")
x = torch.arange(6.0).reshape(2, 3)
with ml.use_mesh(m):
    assert ml.constrain(x, P("data", "model")) is x
    d = ml.distribute(x, P("data", "model"), m)
    assert torch.equal(ml.constrain(d, P(None, "model")).full_tensor(), x)
dist.destroy_process_group()
print("HOST_OK")
"""


def test_host_mesh_starts_its_own_group():
    """No process group and no MASTER_ADDR: ``make_host_mesh`` starts a
    one-rank group itself; ``constrain`` is the identity on its 1x1
    mesh for a plain tensor and a redistribute for a DTensor."""
    r = subprocess.run(
        [sys.executable, "-c", HOST], capture_output=True, text=True,
        timeout=120, cwd=ROOT,
        env={"PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1",
             "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
             "HOME": os.environ.get("HOME", ROOT)})
    assert "HOST_OK" in r.stdout, r.stderr[-3000:]
