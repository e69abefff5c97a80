"""The port's segment ops, embedding bag and MIND serving path held to the
JAX package's.

Inputs come from a seeded numpy generator; MIND's weights come from the
JAX package's ``init`` and cross into the port through ``carry``.  Every
bag form (``[B, L]`` with -1 padding, flat ``ids`` + ``offsets``) runs in
every mode (sum, mean, max; weighted or not), and the segment reductions
with ids out of range; then ``interests``, ``serve_score`` and
``retrieve_topk`` at the smoke config.  The port runs on CPU tensors, so
the ``[B, L]`` sum and mean bags take the embedding-bag kernel's plain
version.

Tolerance 1e-5 abs/rel on every float (the JAX package's own for the
embedding bag: both sides sum in f32 in other orders); top-k indices
exactly, ties included (duplicate candidates score alike, and both sides
keep the lower index first).
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mind as j_mind_cfg
from repro.graph import segment_ops as jso
from repro.models.recsys import mind as jmind
from repro_torch import carry, configs, kernels
from repro_torch.configs import mind as t_mind_cfg
from repro_torch.graph import segment_ops as tso
from repro_torch.launch import serve
from repro_torch.models.recsys import mind as tmind

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
V, D, B, L = 40, 12, 6, 7
BATCH, N_CAND = 8, 128


def _bag_inputs():
    rng = np.random.default_rng(5)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(-1, V, (B, L)).astype(np.int32)
    ids[2] = -1  # a bag with no id
    weights = rng.random((B, L)).astype(np.float32)
    # flat form: 30 ids in 6 bags, bag 3 empty (offsets sorted, as torch's)
    flat = rng.integers(-1, V, 30).astype(np.int32)
    offsets = np.array([0, 4, 11, 11, 20, 27], np.int32)
    flat_w = rng.random(30).astype(np.float32)
    return table, ids, weights, flat, offsets, flat_w


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("form", ["padded", "offsets"])
def test_embedding_bag_matches_jax(form, mode, weighted):
    table, ids, weights, flat, offsets, flat_w = _bag_inputs()
    if form == "padded":
        args, kw = (ids,), dict(weights=weights if weighted else None)
    else:
        args, kw = (flat, offsets), dict(weights=flat_w if weighted else None)
    want = jso.embedding_bag(jnp.asarray(table),
                             *(jnp.asarray(a) for a in args), mode=mode,
                             **{k: None if v is None else jnp.asarray(v)
                                for k, v in kw.items()})
    kernels.reset_launch_counts()
    got = tso.embedding_bag(torch.from_numpy(table),
                            *(torch.from_numpy(a) for a in args), mode=mode,
                            **{k: None if v is None else torch.from_numpy(v)
                               for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert kernels.launch_counts()["embedding_bag"] == 0  # CPU: plain


@pytest.mark.parametrize("op", ["sum", "max"])
def test_segment_reductions_match_jax(op):
    rng = np.random.default_rng(6)
    data = rng.standard_normal((50, 3)).astype(np.float32)
    seg = rng.integers(-2, 9, 50).astype(np.int32)  # some out of range
    seg[seg == 4] = 5  # segment 4 stays empty
    want = getattr(jso, f"segment_{op}")(jnp.asarray(data), jnp.asarray(seg),
                                         7)
    got = getattr(tso, f"segment_{op}")(torch.from_numpy(data),
                                        torch.from_numpy(seg), 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embedding_bag_rejects_unknown_mode():
    table, ids, *_ = _bag_inputs()
    with pytest.raises(ValueError):
        tso.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                          mode="median")


@functools.lru_cache(maxsize=None)
def _jax_mind():
    """JAX params (numpy), one batch, and its interests, scores and top-k
    (one compile each)."""
    cfg = j_mind_cfg.smoke_config()
    params = jax.tree_util.tree_map(
        np.asarray, jmind.init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    batch = {
        "behavior": rng.integers(-1, cfg.n_items, (BATCH, cfg.seq_len)),
        "profile": rng.integers(-1, cfg.profile_vocab,
                                (BATCH, cfg.profile_len)),
        "candidates": rng.integers(0, cfg.n_items, (BATCH, N_CAND))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    u = jax.jit(lambda p, b: jmind.interests(p, b["behavior"], b["profile"],
                                             cfg))(params, jb)
    scores = jax.jit(lambda p, b: jmind.serve_score(p, b, cfg))(params, jb)
    vals, idx = jax.jit(lambda p, b: jmind.retrieve_topk(p, b, cfg))(
        params, jb)
    return params, batch, [np.asarray(a) for a in (u, scores, vals, idx)]


def _port_mind():
    params, batch, _ = _jax_mind()
    cfg = carry.mind_config_from_dict(
        dataclasses.asdict(j_mind_cfg.smoke_config()))
    return (cfg, carry.mind_params_from_numpy(params, cfg, "cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_mind_interests_and_scores_match_jax():
    _, _, (want_u, want_scores, want_vals, want_idx) = _jax_mind()
    cfg, params, batch = _port_mind()
    u = tmind.interests(params, batch["behavior"], batch["profile"], cfg)
    np.testing.assert_allclose(u.numpy(), want_u, **TOL)
    scores = tmind.serve_score(params, batch, cfg)
    np.testing.assert_allclose(scores.numpy(), want_scores, **TOL)
    vals, idx = tmind.retrieve_topk(params, batch, cfg)
    assert idx.shape == (BATCH, 100)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_allclose(vals.numpy(), want_vals, **TOL)
    # the candidates repeat ids, so the top 100 hold ties: equal scores
    # keep the lower index first, in both packages
    cand = batch["candidates"].numpy()
    top_ids = np.take_along_axis(cand, want_idx, 1)
    assert any(len(set(row)) < len(row) for row in top_ids)


def test_mind_config_and_carry_match_jax():
    for make in ("smoke_config", "config"):
        want = dataclasses.asdict(getattr(j_mind_cfg, make)())
        got = carry.mind_config_to_dict(getattr(t_mind_cfg, make)())
        assert got.pop("dtype") == np.dtype(want.pop("dtype")).name
        assert got == want, make
    assert t_mind_cfg.SHAPES == j_mind_cfg.SHAPES
    assert configs.get("mind") is t_mind_cfg
    params, *_ = _jax_mind()
    cfg, tparams, _ = _port_mind()
    back = carry.mind_params_to_numpy(tparams)
    assert sorted(back) == sorted(params)
    for k, want in params.items():
        np.testing.assert_array_equal(back[k], want, err_msg=k)
    # the port's own init draws the reference's shapes and dtypes
    mine = tmind.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: v.shape for k, v in params.items()}


def test_serve_mind_on_cpu():
    cfg = t_mind_cfg.smoke_config()
    kernels.reset_launch_counts()
    rep = serve.serve_mind(cfg, 2, batch=4, n_cand=64, device="cpu")
    assert rep["device"] == "cpu" and rep["peak_mem_bytes"] is None
    assert rep["scores_finite"] and rep["last"].shape == (4, 64)
    assert rep["scores_per_s"] > 0 and len(rep["latency_s"]) == 2
    rep = serve.serve_mind(cfg, 1, batch=1, n_cand=500, top_k=100,
                           device="cpu")
    vals, idx = rep["last"]
    assert vals.shape == idx.shape == (1, 100)
    assert bool((vals[:, :-1] >= vals[:, 1:]).all())
    assert kernels.launch_counts()["embedding_bag"] == 0


def test_serve_cli_mind_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "mind",
         "--device", "cpu", "--steps", "2"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "scores/s) on cpu" in out.stdout
