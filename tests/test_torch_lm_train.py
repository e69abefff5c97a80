"""The port's LM training path held to the JAX package's: the chunked
attention, ``loss_fn`` and its gradients (dense and MoE, with the aux
loss), remat, the flash kernel's refusal under a gradient, and the
trainer's steps.

Weights come from ``repro.models.transformer.init`` and cross into the
port through ``carry``; batches are ``lm_batch`` streams, the same
integers in both packages, with some labels set to -100 (padding).
Tolerances: loss, ``ce`` and ``aux`` within 1e-5 relative, every gradient
leaf within rtol 2e-4 / atol 2e-5 of ``jax.grad`` (both sides compute in
f32 and sum in other orders); attention within 2e-5 (the reference's own
test of its chunked path); one trainer step within 2e-4, a 10-step loss
curve within 1e-3 relative at every step (the differences of each step
compound through the updates).  Remat changes no number: it recomputes the
same operations on the same inputs.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_12b as j_gemma
from repro.configs import h2o_danube_3_4b as j_danube
from repro.configs import moonshot_v1_16b_a3b as j_moonshot
from repro.configs import qwen3_14b as j_qwen
from repro.data import pipeline as jpipe
from repro.models import transformer as jtf
from repro.optim import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import carry, kernels
from repro_torch.configs import qwen3_14b
from repro_torch.data import pipeline as tpipe
from repro_torch.models import transformer as ttf
from repro_torch.optim import optimizer as topt
from repro_torch.train import trainer as ttrainer
from repro_torch.tree import tree_leaves, tree_unflatten

CASES = {
    "qwen3_xla": (j_qwen, {}),
    "qwen3_chunked": (j_qwen, {"attn_impl": "chunked"}),
    "danube_chunked": (j_danube, {"attn_impl": "chunked"}),
    "gemma3_chunked": (j_gemma, {"attn_impl": "chunked"}),  # local:global
    "moonshot_aux": (j_moonshot, {"aux_loss_weight": 0.5}),
}
BATCH, SEQ = 4, 32  # SEQ > danube's window (16) and gemma3's (8)
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _jax_cfg(case, **kw):
    mod, over = CASES[case]
    return dataclasses.replace(mod.smoke_config(), **over, **kw)


def _batch_np(vocab, step=1):
    b = {k: np.array(v) for k, v in
         jpipe.lm_batch(vocab, BATCH, SEQ, step=step).items()}
    b["labels"][0, :5] = -100
    b["labels"][2, -3:] = -100
    return b


@functools.lru_cache(maxsize=None)
def _jax_grads(case):
    """JAX params, batch, (loss, ce, aux) and grads, all numpy."""
    cfg = _jax_cfg(case)
    params = jtf.init(jax.random.PRNGKey(0), cfg)
    batch = _batch_np(cfg.vocab)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(p, b, cfg), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    return (jax.tree.map(np.asarray, params), batch,
            (float(loss), float(aux["ce"]), float(aux["aux"])),
            jax.tree.map(np.asarray, grads))


def _port_grads(case, **kw):
    """The port's (loss, ce, aux) and grads (JAX layout, numpy) from the
    JAX weights and batch."""
    params_np, batch, _, _ = _jax_grads(case)
    cfg = carry.lm_config_from_dict(dataclasses.asdict(_jax_cfg(case, **kw)))
    params = carry.lm_params_from_numpy(params_np, cfg, "cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss, aux = ttf.loss_fn(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return ((float(loss.detach()), float(aux["ce"].detach()),
             float(aux["aux"].detach())),
            carry.lm_params_to_numpy(tree_unflatten(params, grads)))


@pytest.mark.parametrize("case", list(CASES))
def test_lm_loss_and_grads_match_jax(case):
    _, _, want_loss, want_grads = _jax_grads(case)
    got_loss, got_grads = _port_grads(case)
    np.testing.assert_allclose(got_loss, want_loss, **LOSS_TOL)
    if case == "moonshot_aux":
        assert want_loss[2] > 1.0  # the aux loss is on and in the loss
        assert abs(want_loss[0] - want_loss[1]) > 0.1
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(want_grads)[0]]
    for path, w, g in zip(paths, jax.tree.leaves(want_grads),
                          jax.tree.leaves(got_grads)):
        assert np.abs(w).max() > 0, path
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=path)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("case", ["qwen3_chunked", "gemma3_chunked",
                                  "moonshot_aux"])
def test_remat_matches_no_remat(case, remat):
    want_loss, want_grads = _port_grads(case)
    got_loss, got_grads = _port_grads(case, remat=remat)
    assert got_loss == want_loss
    for w, g in zip(jax.tree.leaves(want_grads), jax.tree.leaves(got_grads)):
        np.testing.assert_array_equal(g, w)


def test_lm_config_refuses_unknown_remat():
    with pytest.raises(ValueError, match="remat"):
        qwen3_14b.smoke_config(remat="offload")


def _qkv(s=32, b=2, h=4, hkv=2, dh=8):
    rng = np.random.default_rng(11)
    return tuple(rng.normal(size=(b, s, n, dh)).astype(np.float32)
                 for n in (h, hkv, hkv))


@pytest.mark.parametrize("chunk", [8, 12])  # 12 does not divide S: one chunk
@pytest.mark.parametrize("window", [0, 8])
def test_attention_chunked_matches_jax_and_xla(window, chunk):
    q, k, v = _qkv()
    pos = np.broadcast_to(np.arange(q.shape[1]), q.shape[:2])
    want = jtf._attention_chunked(*(jnp.asarray(a) for a in (q, k, v, pos,
                                                             pos)),
                                  jnp.int32(window), chunk=chunk)
    tq, tk, tv, tpos = (torch.from_numpy(np.array(a))
                        for a in (q, k, v, pos))
    got = ttf._attention_chunked(tq, tk, tv, tpos, tpos, window, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    xla = ttf._attention_xla(tq, tk, tv, tpos, tpos, window)
    np.testing.assert_allclose(got.numpy(), xla.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_flash_refuses_a_backward():
    """The flash path runs forward (the plain version on CPU tensors) and
    refuses the backward, as it does on a card."""
    case = "qwen3_xla"
    params_np, batch, want_loss, _ = _jax_grads(case)
    cfg = carry.lm_config_from_dict(dataclasses.asdict(
        _jax_cfg(case, attn_impl="flash")))
    params = carry.lm_params_from_numpy(params_np, cfg, "cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    kernels.reset_launch_counts()
    loss, _ = ttf.loss_fn(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    assert float(loss.detach()) == pytest.approx(want_loss[0], rel=1e-5)
    assert kernels.launch_counts()["flash_attention"] == 0
    with pytest.raises(RuntimeError, match="attn_impl='chunked'"):
        torch.autograd.grad(loss, leaves)
    # without a gradient (serving) flash runs as before
    with torch.no_grad():
        ttf.loss_fn(params, {k: torch.from_numpy(v)
                             for k, v in batch.items()}, cfg)


OPT = dict(lr=1e-3, warmup_steps=3, total_steps=10)


def _trainers(case, steps, compress=False, batch=BATCH, seq=SEQ,
              opt=OPT):
    """A JAX and a port Trainer on one config, weights and stream."""
    jcfg = _jax_cfg(case, remat="full")
    params_np, *_ = _jax_grads(case)
    jt = jtrainer.Trainer(
        lambda p, b: jtf.loss_fn(p, b, jcfg),
        jax.tree.map(jnp.asarray, params_np), jopt.AdamWConfig(**opt),
        jtrainer.TrainerConfig(total_steps=steps, log_every=1,
                               grad_compression=compress),
        lambda s: jpipe.lm_batch(jcfg.vocab, batch, seq, step=s))
    cfg = carry.lm_config_from_dict(dataclasses.asdict(jcfg))
    tt = ttrainer.Trainer(
        lambda p, b: ttf.loss_fn(p, b, cfg),
        carry.lm_params_from_numpy(params_np, cfg, "cpu"),
        topt.AdamWConfig(**opt),
        ttrainer.TrainerConfig(total_steps=steps, log_every=1,
                               grad_compression=compress),
        lambda s: tpipe.lm_batch(cfg.vocab, batch, seq, step=s,
                                 device="cpu"))
    return jt, tt, cfg


@pytest.mark.parametrize("case", ["qwen3_chunked", "moonshot_aux"])
def test_trainer_step_matches_jax(case):
    """Without compression: int8 rounding turns a 1e-7 gradient difference
    into a whole quantum where e / scale sits at a .5 boundary, and Adam's
    first step (about lr x sign(g)) carries it in full; the compressed
    path is held to the reference by its own tests, on one set of grads."""
    jt, tt, _ = _trainers(case, 1)
    (_, jm), = jt.run()
    (_, tm), = tt.run()
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        assert tm[k] == pytest.approx(jm[k], rel=2e-4, abs=2e-5), k
    want = jax.tree.map(np.asarray, {k: jt.state[k] for k in
                                     ("params", "opt")})
    got = carry.train_state_to_numpy(tt.state)
    for w, g in ((want["params"], got["params"]),
                 (want["opt"].m, got["opt"]["m"]),
                 (want["opt"].v, got["opt"]["v"])):
        for a, b in zip(jax.tree.leaves(w), jax.tree.leaves(g)):
            np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-4)
    assert got["opt"]["count"] == 1


def test_loss_curve_matches_jax():
    """10 steps on the launcher's smoke batches (16 x 64 tokens, a fresh
    batch a step).  Each batch's loss varies by ~0.2 around the curve, so
    "decreases" reads the mean of the last three steps against the first
    three."""
    jt, tt, _ = _trainers("qwen3_chunked", 10, batch=16, seq=64,
                          opt=dict(OPT, lr=1e-2, warmup_steps=2))
    jlog, tlog = jt.run(), tt.run()
    assert [s for s, _ in tlog] == [s for s, _ in jlog] == list(range(1, 11))
    want = np.array([m["loss"] for _, m in jlog])
    got = np.array([m["loss"] for _, m in tlog])
    np.testing.assert_allclose(got, want, rtol=1e-3)
    for curve in (got, want):
        assert curve[-3:].mean() < curve[:3].mean()


def test_train_state_carries_both_ways():
    """A JAX state after one compressed step crosses into the port and back
    unchanged: params, m, v (per-layer lists <-> stacked [L]), count and
    the error-feedback residual."""
    jt, _, cfg = _trainers("moonshot_aux", 1, compress=True)
    jt.run()
    want = jax.tree.map(np.asarray, {k: jt.state[k] for k in
                                     ("params", "opt", "ef")})
    state = carry.train_state_from_numpy(want, cfg, "cpu")
    assert state["opt"].m["layers"][1]["moe"]["w_up"].dtype == torch.float32
    assert len(state["ef"].err["layers"]) == cfg.n_layers
    back = carry.train_state_to_numpy(state)
    for w, g in ((want["params"], back["params"]),
                 (want["opt"].m, back["opt"]["m"]),
                 (want["opt"].v, back["opt"]["v"]),
                 (want["ef"].err, back["ef"]["err"])):
        assert jax.tree.structure(w) == jax.tree.structure(g)
        for a, b in zip(jax.tree.leaves(w), jax.tree.leaves(g)):
            np.testing.assert_array_equal(b, a)
    assert back["opt"]["count"] == int(want["opt"].count) == 1
