"""The port's training substrate held to the JAX package's: the data
streams, AdamW, gradient compression, the checkpoint's bf16 leaves, the
trainer (the reference's own substrate tests mirrored, and one step
against the JAX trainer's), ``launch.train`` and the training example.

Inputs come from seeded numpy generators and cross into both packages as
numpy arrays.  Tolerances: the data streams' integers exactly (the same
numpy ``SeedSequence`` streams); optimizer and compression floats within
1e-6 (both compute in f32, the same formulas; the int8 ``q`` exactly);
one trainer step within 2e-4, the LM tolerance (a step's loss goes
through matmuls summed in other orders); a resumed run bit-identical to
an uninterrupted one (same package, same device).
"""
import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.optim import compression as jcomp
from repro.optim import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import carry
from repro_torch.ckpt import checkpoint
from repro_torch.configs import mind as t_mind_cfg
from repro_torch.data import pipeline as tpipe
from repro_torch.optim import compression as tcomp
from repro_torch.optim import optimizer as topt
from repro_torch.train import trainer as ttrainer
from repro_torch.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
STREAMS = [(0, 0, 0, 1), (0, 3, 1, 2), (7, 11, 0, 2), (123, 4, 3, 4)]


# ----------------------------------------------------------------- data ---

@pytest.mark.parametrize("structured", [True, False])
@pytest.mark.parametrize("seed,step,shard,n_shards", STREAMS)
def test_lm_batch_matches_jax(seed, step, shard, n_shards, structured):
    info = dict(shard=shard, n_shards=n_shards)
    want = jpipe.lm_batch(97, 8, 12, step, jpipe.ShardInfo(**info), seed,
                          structured)
    got = tpipe.lm_batch(97, 8, 12, step, tpipe.ShardInfo(**info), seed,
                         structured, device="cpu")
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("seed,step,shard,n_shards", STREAMS)
def test_mind_batch_matches_jax(seed, step, shard, n_shards):
    info = dict(shard=shard, n_shards=n_shards)
    args = (5000, 64, 10, 32, 4, 16, step)
    want = jpipe.mind_batch(*args, jpipe.ShardInfo(**info), seed)
    got = tpipe.mind_batch(*args, tpipe.ShardInfo(**info), seed,
                           device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # rows with fewer in-cluster items than seq_len stay -1 padded
    assert (got["behavior"] == -1).any()


# ------------------------------------------------------------ optimizer ---

def _tree(rng, fn):
    return {"a": fn(rng, (5, 3)), "b": {"d": fn(rng, (2, 2)),
                                        "c": fn(rng, (4,))}}


def _opt_case(dtype):
    rng = np.random.default_rng(1)
    normal = lambda r, s: r.standard_normal(s).astype(np.float32)  # noqa
    p, g, m = (_tree(rng, normal) for _ in range(3))
    v = _tree(rng, lambda r, s: r.random(s).astype(np.float32))
    if dtype == "bfloat16":
        p = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)
                                              .astype(jnp.float32)), p)
    return p, g, m, v


def _torch_tree(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)).to(dtype),
                        tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [1.0, 100.0])  # active, inactive
@pytest.mark.parametrize("schedule", ["cosine", "linear", "const"])
def test_adamw_update_matches_jax(schedule, clip_norm, dtype):
    p, g, m, v = _opt_case(dtype)
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20, schedule=schedule,
              clip_norm=clip_norm, weight_decay=0.05)
    jd = getattr(jnp, dtype)
    jp, js, jm = jopt.update(
        jax.tree.map(jnp.asarray, g),
        jopt.OptState(jax.tree.map(jnp.asarray, m),
                      jax.tree.map(jnp.asarray, v), jnp.int32(4)),
        jax.tree.map(lambda a: jnp.asarray(a, jd), p),
        jopt.AdamWConfig(**kw))
    td = getattr(torch, dtype)
    tp = _torch_tree(p, td)
    got_p, ts, tm = topt.update(
        _torch_tree(g), topt.OptState(_torch_tree(m), _torch_tree(v),
                                      torch.tensor(4, dtype=torch.int32)),
        tp, topt.AdamWConfig(**kw))
    assert got_p is tp and tp["a"].dtype == td  # written in place
    for want, got in ((jp, got_p), (js.m, ts.m), (js.v, ts.v)):
        for w, t in zip(jax.tree.leaves(want), tree_leaves(got)):
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(w, np.float32), **OPT_TOL)
    assert int(ts.count) == int(js.count) == 5
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-6)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    # clipping active: the norm is above 1.0; inactive: below 100.0
    assert (float(jm["grad_norm"]) > clip_norm) == (clip_norm == 1.0)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "const"])
def test_schedule_matches_jax(schedule):
    for warm, total in ((10, 100), (0, 50), (5, 5)):
        jc = jopt.AdamWConfig(lr=0.5, warmup_steps=warm, total_steps=total,
                              schedule=schedule)
        tc = topt.AdamWConfig(**dataclasses.asdict(jc))
        for step in (0, 1, warm, warm + 1, total // 2, total, total + 7):
            want = float(jopt.schedule(jc, jnp.int32(step)))
            got = float(topt.schedule(tc, torch.tensor(step)))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-9), \
                (warm, total, step)


def test_global_norm_and_clip_match_jax():
    _, g, _, _ = _opt_case("float32")
    for max_norm in (0.5, 1e3):
        wg, wn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                          max_norm)
        tg, tn = topt.clip_by_global_norm(_torch_tree(g), max_norm)
        assert float(tn) == pytest.approx(float(wn), rel=1e-6)
        for w, t in zip(jax.tree.leaves(wg), tree_leaves(tg)):
            np.testing.assert_allclose(t.numpy(), np.asarray(w), **OPT_TOL)


def test_optimizer_init_keeps_f32_moments():
    params = {"w": torch.zeros((3, 2), dtype=torch.bfloat16),
              "layers": [{"b": torch.ones(4)}]}
    st = topt.init(params)
    assert st.m["w"].dtype == st.v["layers"][0]["b"].dtype == torch.float32
    assert st.count.dtype == torch.int32 and int(st.count) == 0


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    cfg = topt.AdamWConfig(lr=0.3, weight_decay=0.0, warmup_steps=0,
                           total_steps=200, schedule="const")
    state = topt.init(params)
    for _ in range(150):
        w = params["w"].detach().requires_grad_()
        (grad,) = torch.autograd.grad((w ** 2).sum(), [w])
        params, state, m = topt.update({"w": grad}, state, params, cfg)
    assert float(params["w"].abs().max()) < 0.05
    assert float(m["grad_norm"]) >= 0


# ---------------------------------------------------------- compression ---

def _grads_and_err():
    rng = np.random.default_rng(2)
    g = {"x": rng.standard_normal((6, 5)).astype(np.float32) * 0.3,
         "y": [rng.standard_normal(7).astype(np.float32)]}
    err = {"x": rng.standard_normal((6, 5)).astype(np.float32) * 1e-3,
           "y": [rng.standard_normal(7).astype(np.float32) * 1e-3]}
    return g, err


def test_compress_and_decompress_match_jax():
    g, err = _grads_and_err()
    for a, e in ((g["x"], err["x"]), (g["y"][0], np.zeros(7, np.float32)),
                 (np.zeros(4, np.float32), np.zeros(4, np.float32))):
        wq, ws, we = jcomp.compress(jnp.asarray(a), jnp.asarray(e))
        tq, ts, te = tcomp.compress(torch.from_numpy(a), torch.from_numpy(e))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(wq))
        np.testing.assert_allclose(float(ts), float(ws), **OPT_TOL)
        np.testing.assert_allclose(te.numpy(), np.asarray(we), **OPT_TOL)
        np.testing.assert_allclose(tcomp.decompress(tq, ts).numpy(),
                                   np.asarray(jcomp.decompress(wq, ws)),
                                   **OPT_TOL)


def test_compressed_psum_matches_jax():
    g, err = _grads_and_err()
    wg, wef = jcomp.compressed_psum(
        jax.tree.map(jnp.asarray, g),
        jcomp.EFState(err=jax.tree.map(jnp.asarray, err)), None)
    tg, tef = tcomp.compressed_psum(
        _torch_tree(g), tcomp.EFState(err=_torch_tree(err)), None)
    for want, got in ((wg, tg), (wef.err, tef.err)):
        for w, t in zip(jax.tree.leaves(want), tree_leaves(got)):
            np.testing.assert_allclose(t.numpy(), np.asarray(w), **OPT_TOL)


def test_compressed_psum_refuses_a_pod_axis():
    g, err = _grads_and_err()
    with pytest.raises(ValueError, match="mesh"):
        tcomp.compressed_psum(_torch_tree(g),
                              tcomp.EFState(err=_torch_tree(err)), "pod")


def test_error_feedback_reduces_bias():
    """With error feedback the accumulated quantized sum tracks the true
    sum at least as well as naive per-step quantization."""
    rng = np.random.default_rng(0)
    g_seq = [torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
             * 0.01 for _ in range(50)]
    ef = tcomp.init({"g": g_seq[0]})
    acc_ef, acc_naive, acc_true = (np.zeros(64) for _ in range(3))
    for g in g_seq:
        out, ef = tcomp.compressed_psum({"g": g}, ef, None)
        acc_ef += out["g"].numpy()
        q, s, _ = tcomp.compress(g, torch.zeros_like(g))
        acc_naive += tcomp.decompress(q, s).numpy()
        acc_true += g.numpy()
    err_ef = np.abs(acc_ef - acc_true).max()
    err_naive = np.abs(acc_naive - acc_true).max()
    assert err_ef <= err_naive * 1.5
    assert err_ef < 0.01


# ------------------------------------------------------------ checkpoint ---

def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_checkpoint_bf16_round_trip_is_bitwise(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((5, 3), generator=g).to(torch.bfloat16),
            "layers": [{"ln": torch.randn(4, generator=g).bfloat16()}],
            "opt": topt.OptState(m={"x": torch.randn(3, generator=g)},
                                 v={"x": torch.rand(3, generator=g)},
                                 count=torch.tensor(7, dtype=torch.int32)),
            "s": torch.tensor(-0.0).bfloat16(), "none": None}
    checkpoint.save(str(tmp_path), 2, tree)
    with np.load(tmp_path / "ckpt_2.npz") as z:
        assert z["d:w"].dtype == np.uint16
        assert sorted(z[checkpoint.BF16_KEYS].tolist()) == \
            ["d:layers|s:0|d:ln", "d:s", "d:w"]
    like = tree_map(torch.zeros_like, tree)
    got, step = checkpoint.restore(str(tmp_path), like)
    assert step == 2 and got["none"] is None
    for (kw, w), (kg, t) in zip(checkpoint.leaves(tree),
                                checkpoint.leaves(got)):
        assert kw == kg and t.dtype == w.dtype, kw
        assert torch.equal(_bits(t), _bits(w)), kw


def test_checkpoint_without_bf16_is_unchanged(tmp_path):
    tree = {"a": torch.arange(5), "b": [torch.ones((2, 3))],
            "c": np.int32(4)}
    checkpoint.save(str(tmp_path), 1, tree)
    with np.load(tmp_path / "ckpt_1.npz") as z:
        assert z.files == ["d:a", "d:b|s:0", "d:c"]
        assert [z[k].dtype for k in z.files] == [np.int64, np.float32,
                                                 np.int32]


def test_graph_snapshot_written_before_bf16_change_opens(tmp_path):
    """A store the port wrote before bf16 leaves were stored as bits (a
    16-vertex graph, generation 3) opens as it did."""
    src = ROOT / "tests" / "data" / "graph_snapshot_before_bf16"
    shutil.copytree(src, tmp_path / "store")
    state, cfg, meta, step = checkpoint.restore_graph_snapshot(
        str(tmp_path / "store"), device="cpu")
    assert step == meta["gen"] == 3 and cfg.n_vertices == 16
    assert state.ccid.tolist() == [0, 0, 0, 3, 3] + [16] * 11
    assert int(state.n_ccs) == 2 and state.edges.src.dtype == torch.int32
    assert int((state.edges.state == 1).sum()) == 5


# --------------------------------------------------------------- trainer ---

def _toy(tmp_path=None, total=12, compress=False, dtype=torch.float32):
    """The reference's toy trainer (tests/test_substrate.py)."""
    def loss_fn(params, batch):
        w = params["w"]
        pred = batch["x"].to(w.dtype) @ w
        return torch.mean((pred.float() - batch["y"]) ** 2), {}

    def data_fn(step):
        rng = np.random.default_rng(step)
        x = torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32))
        w_true = torch.tensor([[1.0], [-2.0], [0.5], [3.0]])
        return {"x": x, "y": x @ w_true}

    tcfg = ttrainer.TrainerConfig(
        total_steps=total, ckpt_dir=str(tmp_path) if tmp_path else None,
        ckpt_every=5, log_every=1, grad_compression=compress)
    ocfg = topt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                            schedule="const")
    return ttrainer.Trainer(loss_fn, {"w": torch.zeros((4, 1), dtype=dtype)},
                            ocfg, tcfg, data_fn)


def test_trainer_learns():
    log = _toy(total=60).run()
    assert log[-1][1]["loss"] < log[0][1]["loss"] * 0.1


def test_trainer_with_compression_learns():
    log = _toy(total=60, compress=True).run()
    assert log[-1][1]["loss"] < log[0][1]["loss"] * 0.2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_preemption_resume_identical(tmp_path, dtype):
    """Crash after step 7, resume from the checkpoint -> bit-identical
    final params, moments and seed."""
    t_full = _toy(None, total=12, dtype=dtype, compress=True)
    t_full.run()
    t_a = _toy(tmp_path, total=12, dtype=dtype, compress=True)
    t_a.run(steps=7)
    t_a.save()
    del t_a  # "preemption"
    t_b = _toy(tmp_path, total=12, dtype=dtype, compress=True)
    assert t_b.step == 7  # restored cursor
    t_b.run()
    assert t_b.state["params"]["w"].dtype == dtype
    for (k, want), (_, got) in zip(checkpoint.leaves(t_full.state),
                                   checkpoint.leaves(t_b.state)):
        assert got.dtype == want.dtype and torch.equal(_bits(got),
                                                       _bits(want)), k
    assert int(t_b.state["rng"]) == 12


def test_straggler_counter():
    t = _toy(total=30)
    t.run()
    before = t.straggler_events
    t._watch_straggler(100.0)  # a synthetic slow step
    assert t.straggler_events == before + 1
    assert len(t.step_times) == 31


def test_trainer_metrics_log_format():
    t = _toy(total=4)
    t.cfg.log_every = 2
    log = t.run()
    assert [s for s, _ in log] == [2, 4]
    assert sorted(log[0][1]) == ["grad_norm", "loss", "lr"]
    assert all(isinstance(v, float) for _, m in log for v in m.values())


def _jax_toy(params, total):
    def loss_fn(p, batch):
        return jnp.mean((batch["x"] @ p["w"] - batch["y"]) ** 2), {}

    def data_fn(step):
        rng = np.random.default_rng(step)
        x = jnp.asarray(rng.normal(size=(16, 4)).astype(np.float32))
        return {"x": x, "y": x @ jnp.asarray([[1.0], [-2.0], [0.5], [3.0]])}

    return jtrainer.Trainer(
        loss_fn, params, jopt.AdamWConfig(lr=0.1, weight_decay=0.0,
                                          warmup_steps=0, schedule="const"),
        jtrainer.TrainerConfig(total_steps=total, log_every=1,
                               grad_compression=True), data_fn)


def test_toy_trainer_state_carries_and_steps_as_jax():
    """Two JAX steps with compression, the state carried into the port,
    then one more step in each package: params, moments, count and the
    error-feedback residual agree."""
    jt = _jax_toy({"w": jnp.zeros((4, 1))}, total=3)
    jt.run(steps=2)
    st = jax.tree.map(np.asarray, {k: jt.state[k] for k in
                                   ("params", "opt", "ef")})
    tt = _toy(total=3, compress=True)
    # a flat f32 tree crosses as MIND's params do
    tt.state = carry.train_state_from_numpy(st, t_mind_cfg.smoke_config(),
                                            "cpu")
    tt.step = jt.step
    assert int(tt.state["opt"].count) == 2
    jt.run()
    tt.run()
    want = jax.tree.map(np.asarray, {k: jt.state[k] for k in
                                     ("params", "opt", "ef")})
    got = carry.train_state_to_numpy(tt.state)
    np.testing.assert_allclose(got["params"]["w"], want["params"]["w"],
                               rtol=2e-4, atol=2e-5)
    for k in ("m", "v"):
        np.testing.assert_allclose(got["opt"][k]["w"],
                                   getattr(want["opt"], k)["w"],
                                   rtol=2e-4, atol=2e-5)
    assert got["opt"]["count"] == int(want["opt"].count) == 3
    np.testing.assert_allclose(got["ef"]["err"]["w"], want["ef"].err["w"],
                               rtol=2e-4, atol=2e-5)


# ------------------------------------------------- launch.train, example ---

def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("arch", ["qwen3-14b", "mind", "egnn", "gatedgcn",
                                  "nequip", "mace"])
def test_launch_train_on_cpu(arch, tmp_path):
    out = _run("-m", "repro_torch.launch.train", "--arch", arch, "--smoke",
               "--steps", "4", "--device", "cpu", "--ckpt-dir",
               str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert re.search(r"^step    4  loss \d+\.\d{4}$", out.stdout, re.M)
    assert re.search(r"done: 4 steps, median \d+ms/step, stragglers=0 on "
                     r"cpu", out.stdout)
    assert checkpoint.latest_step(str(tmp_path)) == 4


@pytest.mark.parametrize("arch,msg", [("smscc", "dynamic_scc_serving")])
def test_launch_train_refuses_unported_families(arch, msg):
    out = _run("-m", "repro_torch.launch.train", "--arch", arch, "--device",
               "cpu")
    assert out.returncode == 1 and msg in out.stderr


def test_train_lm_example_prints_the_jax_examples_lines():
    """The lines of examples/train_lm.py: its parameter count, its steps
    and learning rates (the weights are each package's own random draw,
    so the losses differ), and a decreasing loss."""
    from repro.configs import qwen3_14b as j_qwen
    from repro.models import common as jcommon
    from repro.models import transformer as jtf

    out = _run(str(ROOT / "examples" / "train_lm_torch.py"), "--device",
               "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    jcfg = dataclasses.replace(j_qwen.smoke_config(), n_layers=2,
                               d_model=64, vocab=512)
    n = jcommon.count_params(jtf.init(jax.random.PRNGKey(0), jcfg))
    assert lines[0] == f"training {jcfg.name}: {n:,} params"
    assert lines[1] == "loss curve:"
    ocfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=60)
    curve = [re.fullmatch(r"  step +(\d+)  loss (\S+)  ce (\S+)  lr (\S+)",
                          ln) for ln in lines[2:8]]
    assert [int(m.group(1)) for m in curve] == [10, 20, 30, 40, 50, 60]
    for m in curve:
        want_lr = float(jopt.schedule(ocfg, jnp.int32(int(m.group(1)))))
        assert m.group(4) == f"{want_lr:.2e}"
        assert m.group(2) == m.group(3)  # dense: loss == ce
    first, last = re.fullmatch(
        r"loss (\S+) -> (\S+)  \(stragglers flagged: \d+\)",
        lines[8]).groups()
    assert float(last) < float(first)
