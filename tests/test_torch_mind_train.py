"""The port's MIND training path held to the JAX package's:
``label_aware_user_vec``, ``loss_fn`` and its gradients (the profile bag's
included), the embedding bag's gradient, and a trainer step.

Weights come from ``repro.models.recsys.mind.init`` and cross into the
port through ``carry``; batches are ``mind_batch`` streams, the same
integers in both packages.  On CPU tensors the profile bag is the plain
version, which autograd differentiates; on a card it is the kernel inside
``EmbeddingBagFn``, whose backward is checked here by
``torch.autograd.gradcheck`` in float64 with the plain version as its
forward (the kernel cannot run here), and on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

Tolerances: attention vectors and the loss within 1e-5 (the JAX package's
bag tolerance; both sides compute in f32), gradients within rtol 2e-4 /
atol 2e-5, a trainer step within 2e-4.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mind as j_mind_cfg
from repro.data import pipeline as jpipe
from repro.models.recsys import mind as jmind
from repro.optim import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import carry, kernels
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels.embedding_bag import ops as eops
from repro_torch.kernels.embedding_bag import ref as eref
from repro_torch.models.recsys import mind as tmind
from repro_torch.optim import optimizer as topt
from repro_torch.train import trainer as ttrainer
from repro_torch.tree import tree_leaves, tree_unflatten

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
BATCH = 32


def _batch_args(cfg):
    return (cfg.n_items, BATCH, cfg.seq_len, cfg.profile_vocab,
            cfg.profile_len, cfg.n_neg)


@functools.lru_cache(maxsize=None)
def _jax_mind():
    """JAX params, batch, u, the label-aware vectors, (loss, acc) and
    grads, all numpy."""
    cfg = j_mind_cfg.smoke_config()
    params = jmind.init(jax.random.PRNGKey(0), cfg)
    jb = jpipe.mind_batch(*_batch_args(cfg), step=2)
    batch = {k: np.array(v) for k, v in jb.items()}

    def user_vec(p, b):
        u = jmind.interests(p, b["behavior"], b["profile"], cfg)
        tgt = jnp.take(p["item_embed"], b["target"], axis=0)
        return u, jmind.label_aware_user_vec(u, tgt, cfg)

    u, vec = jax.jit(user_vec)(params, jb)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jmind.loss_fn(p, b, cfg), has_aux=True))(params, jb)
    return (jax.tree.map(np.asarray, params), batch, np.asarray(u),
            np.asarray(vec), (float(loss), float(aux["ce"]),
                              float(aux["acc"])),
            jax.tree.map(np.asarray, grads))


def _port():
    params_np, batch, *_ = _jax_mind()
    cfg = carry.mind_config_from_dict(
        dataclasses.asdict(j_mind_cfg.smoke_config()))
    return (cfg, carry.mind_params_from_numpy(params_np, cfg, "cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_label_aware_user_vec_matches_jax():
    _, _, want_u, want_vec, _, _ = _jax_mind()
    cfg, params, batch = _port()
    tgt = params["item_embed"][batch["target"].long()]
    vec = tmind.label_aware_user_vec(torch.from_numpy(want_u), tgt, cfg)
    np.testing.assert_allclose(vec.numpy(), want_vec, **TOL)


def test_mind_loss_and_grads_match_jax():
    *_, want_loss, want_grads = _jax_mind()
    cfg, params, batch = _port()
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    kernels.reset_launch_counts()
    loss, aux = tmind.loss_fn(params, batch, cfg)
    grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
    assert kernels.launch_counts()["embedding_bag"] == 0  # CPU: plain
    got = tuple(float(x.detach()) for x in (loss, aux["ce"], aux["acc"]))
    np.testing.assert_allclose(got, want_loss, **TOL)
    assert 0.0 < got[2] < 1.0  # some users ranked first, some not
    assert sorted(grads) == sorted(want_grads)
    for k, w in want_grads.items():
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(grads[k].numpy(), w, **GRAD_TOL,
                                   err_msg=k)


def _bag_case():
    g = torch.Generator().manual_seed(0)
    v, d = 7, 3
    table = torch.randn((v, d), generator=g, dtype=torch.float64)
    # padding (-1), a bag of padding only, ids >= V (add nothing), and the
    # same id repeated within one bag
    ids = torch.tensor([[0, 1, 1, -1, 6], [-1, -1, -1, -1, -1],
                        [3, 3, 3, 2, 7], [5, 0, -1, 4, 4]],
                       dtype=torch.int32)
    weights = torch.rand(ids.shape, generator=g, dtype=torch.float64)
    return table, ids, weights


def _plain_forward(table, ids, mode, weights):
    return eref.embedding_bag(table, ids, mode=mode, weights=weights)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bag_function_gradcheck(mode, weighted):
    table, ids, weights = _bag_case()
    table.requires_grad_()
    args = (table, weights.requires_grad_()) if weighted else (table,)

    def bag(t, w=None):
        return eops.EmbeddingBagFn.apply(t, w, ids, mode, _plain_forward)

    assert torch.autograd.gradcheck(bag, args)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bag_backward_matches_autograd_of_plain(mode, weighted):
    """The Function's backward against autograd through the plain version,
    in f32, as the card runs it."""
    table, ids, weights = (x.float() for x in _bag_case())
    w = weights if weighted else None
    grad = torch.randn((ids.shape[0], table.shape[1]),
                       generator=torch.Generator().manual_seed(1))
    leaves = [table.requires_grad_()] + ([w.requires_grad_()] if weighted
                                         else [])
    want = torch.autograd.grad(
        eref.embedding_bag(table, ids, mode=mode, weights=w), leaves, grad)
    got = torch.autograd.grad(
        eops.EmbeddingBagFn.apply(table, w, ids, mode, _plain_forward),
        leaves, grad)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    d_table, d_w = eops.backward(table, ids, mode, w, grad,
                                 weights_grad=weighted)
    assert d_table.shape == table.shape and (d_w is None) != weighted
    assert not d_table[1:3].eq(0).all()  # rows 1, 2: named by real ids


def test_mind_trainer_step_matches_jax():
    jcfg = j_mind_cfg.smoke_config()
    params_np, *_ = _jax_mind()
    opt = dict(lr=1e-2, warmup_steps=0, total_steps=4)
    jt = jtrainer.Trainer(
        lambda p, b: jmind.loss_fn(p, b, jcfg),
        jax.tree.map(jnp.asarray, params_np), jopt.AdamWConfig(**opt),
        jtrainer.TrainerConfig(total_steps=2, log_every=1),
        lambda s: jpipe.mind_batch(*_batch_args(jcfg), step=s))
    cfg, params, _ = _port()
    tt = ttrainer.Trainer(
        lambda p, b: tmind.loss_fn(p, b, cfg), params,
        topt.AdamWConfig(**opt),
        ttrainer.TrainerConfig(total_steps=2, log_every=1),
        lambda s: tpipe.mind_batch(*_batch_args(cfg), step=s,
                                   device="cpu"))
    jlog, tlog = jt.run(), tt.run()
    for (_, jm), (_, tm) in zip(jlog, tlog):
        for k in ("loss", "ce", "acc", "grad_norm", "lr"):
            assert tm[k] == pytest.approx(jm[k], rel=2e-4, abs=2e-5), k
    got = carry.train_state_to_numpy(tt.state)
    want = jax.tree.map(np.asarray, jt.state["params"])
    for k, w in want.items():
        np.testing.assert_allclose(got["params"][k], w, rtol=2e-4,
                                   atol=2e-4, err_msg=k)
    for k, w in jax.tree.map(np.asarray, jt.state["opt"].v).items():
        np.testing.assert_allclose(got["opt"]["v"][k], w, rtol=2e-4,
                                   atol=2e-8, err_msg=k)
