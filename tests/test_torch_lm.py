"""The port's dense LM serving path held to the JAX package's.

Weights come from ``repro.models.transformer.init`` and cross into the port
through ``carry``; prompts come from a seeded numpy generator.  Both
packages prefill the same prompts, then decode teacher-forced with the JAX
side's greedy tokens, so a near-tie cannot fork the sequences.  The prompt
(12 tokens) and six decode steps run past the 16-slot cache, where the
reference clamps its cache write to the last slot.

Tolerance 2e-4 abs/rel on every logit, that of the reference's own
``test_lm_prefill_decode_matches_full``: both sides compute in f32 but sum
in other orders.  With ``attn_impl="flash"`` the JAX side runs the Pallas
kernel in interpret mode and the port its plain version (CPU tensors).
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
from repro.configs import qwen3_14b as j_qwen
from repro.models import transformer as jtf
from repro_torch import carry, kernels
from repro_torch.configs import gemma3_12b, h2o_danube_3_4b, qwen3_14b
from repro_torch.launch import serve
from repro_torch.launch.mesh import P, use_mesh
from repro_torch.models import transformer as ttf

ARCHS = {"qwen3": (j_qwen, qwen3_14b), "danube": (j_danube, h2o_danube_3_4b),
         "gemma3": (j_gemma, gemma3_12b)}
BATCH, PROMPT, CACHE, STEPS = 2, 12, 16, 6
TOL = dict(rtol=2e-4, atol=2e-4)


def _jax_cfg(arch, impl):
    return dataclasses.replace(ARCHS[arch][0].smoke_config(), attn_impl=impl)


@functools.lru_cache(maxsize=None)
def _jax_run(arch, impl):
    """JAX params (numpy), prompts, last logits and teacher-forced decode
    logits with the greedy tokens fed; one compile per (arch, impl)."""
    cfg = _jax_cfg(arch, impl)
    params = jtf.init(jax.random.PRNGKey(0), cfg)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)
    prefill = jax.jit(lambda p, t: jtf.prefill(p, t, cfg, cache_len=CACHE))
    decode = jax.jit(lambda p, c, t: jtf.decode_step(p, c, t, cfg))
    cache, logits = prefill(params, jnp.asarray(toks))
    fed, steps = [], []
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for _ in range(STEPS):
        fed.append(np.array(tok))
        step_logits, cache = decode(params, cache, tok)
        steps.append(np.asarray(step_logits))
        tok = jnp.argmax(step_logits, -1).astype(jnp.int32)
    return (jax.tree_util.tree_map(np.asarray, params), toks,
            np.asarray(logits), fed, steps)


def _port(arch, impl):
    jcfg = _jax_cfg(arch, impl)
    cfg = carry.lm_config_from_dict(dataclasses.asdict(jcfg))
    tree, toks, *_ = _jax_run(arch, impl)
    return cfg, carry.lm_params_from_numpy(tree, cfg, "cpu"), toks


@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_decode_match_jax(arch, impl):
    _, _, want_last, fed, want_steps = _jax_run(arch, impl)
    cfg, params, toks = _port(arch, impl)
    cache, last = ttf.prefill(params, torch.from_numpy(toks), cfg, CACHE)
    np.testing.assert_allclose(last.numpy(), want_last, **TOL)
    for i, (tok, want) in enumerate(zip(fed, want_steps)):
        logits, cache = ttf.decode_step(params, cache, torch.from_numpy(tok),
                                        cfg)
        np.testing.assert_allclose(logits.numpy(), want, **TOL,
                                   err_msg=f"decode step {i}")
    assert cache["pos"] == PROMPT + STEPS > CACHE


@pytest.mark.parametrize("arch", list(ARCHS))
def test_device_position_decode_matches_jax(arch):
    """``decode_step_at`` (the position a 0-d tensor, the cache slot and
    the k/v writes on the tensors' device), run eagerly, == JAX's jitted
    ``decode_step`` teacher-forced, within 2e-4, through the six steps
    past the 16-slot cache; it advances ``pos`` in place and leaves the
    cache's Python 'pos' alone."""
    _, _, _, fed, want_steps = _jax_run(arch, "xla")
    cfg, params, toks = _port(arch, "xla")
    cache, _ = ttf.prefill(params, torch.from_numpy(toks), cfg, CACHE)
    pos = torch.tensor(cache["pos"])
    for i, (tok, want) in enumerate(zip(fed, want_steps)):
        logits = ttf.decode_step_at(params, cache, torch.from_numpy(tok),
                                    pos, cfg)
        np.testing.assert_allclose(logits.numpy(), want, **TOL,
                                   err_msg=f"decode step {i}")
    assert int(pos) == PROMPT + STEPS > CACHE and cache["pos"] == PROMPT


def greedy_runs(cfg, params, toks, steps):
    """The eager greedy loop through ``decode_step`` and ``steps`` calls
    of ``greedy_step`` (the decode graph's body) from the same prefill:
    ((tokens, cache) of each)."""
    runs = []
    for form in ("eager", "device"):
        cache, last = ttf.prefill(params, torch.from_numpy(toks), cfg, CACHE)
        tok = last.argmax(-1).to(torch.int32)
        if form == "eager":
            seq = []
            for _ in range(steps):
                seq.append(tok)
                logits, cache = ttf.decode_step(params, cache, tok, cfg)
                tok = logits.argmax(-1).to(torch.int32)
            runs.append((torch.stack(seq, 1), cache))
        else:
            pos = torch.tensor(cache["pos"])
            out = torch.zeros((tok.shape[0], steps), dtype=torch.int32)
            col = torch.zeros(1, dtype=torch.int64)
            for _ in range(steps):
                ttf.greedy_step(params, cache, pos, tok, out, col, cfg)
            assert int(pos) == cache["pos"] + steps and int(col) == steps
            runs.append((out, cache))
    return runs


@pytest.mark.parametrize("arch", list(ARCHS))
def test_greedy_step_gives_the_eager_loops_tokens(arch):
    """``greedy_step``, run eagerly, writes the eager loop's greedy tokens
    and the same cache, bit for bit, through the cache's end."""
    cfg, params, toks = _port(arch, "xla")
    (want, wcache), (got, gcache) = greedy_runs(cfg, params, toks, STEPS)
    assert torch.equal(got, want)
    assert torch.equal(gcache["k"], wcache["k"])
    assert torch.equal(gcache["v"], wcache["v"])


def test_port_config_matches_jax():
    for arch, (jmod, tmod) in ARCHS.items():
        want = dataclasses.asdict(jmod.smoke_config())
        got = carry.lm_config_to_dict(tmod.smoke_config())
        assert got.pop("dtype") == "float32"
        want.pop("dtype")
        assert got == want, arch
        assert tmod.config().n_params() == jmod.config().n_params()
        assert tmod.config().windows == list(
            np.asarray(jmod.config().windows)), arch
        assert tmod.SHAPES == jmod.SHAPES, arch


def test_carry_round_trip_is_exact():
    tree = _jax_run("qwen3", "xla")[0]
    cfg = _port("qwen3", "xla")[0]
    back = carry.lm_params_to_numpy(
        carry.lm_params_from_numpy(tree, cfg, "cpu"))
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for (path, want), got in zip(flat, jax.tree_util.tree_leaves(back)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=str(path))
    # bf16 leaves (ml_dtypes in numpy) cross exactly and come back as f32
    jcfg = dataclasses.replace(j_qwen.smoke_config(), dtype=jnp.bfloat16)
    tree16 = jax.tree_util.tree_map(
        np.asarray, jtf.init(jax.random.PRNGKey(1), jcfg))
    cfg = carry.lm_config_from_dict(dataclasses.asdict(jcfg))
    assert cfg.dtype == torch.bfloat16
    params = carry.lm_params_from_numpy(tree16, cfg, "cpu")
    assert params["embed"].dtype == torch.bfloat16
    back = carry.lm_params_to_numpy(params)
    for want, got in zip(jax.tree_util.tree_leaves(tree16),
                         jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(got, want.astype(np.float32))
    cfg16 = qwen3_14b.config()
    assert carry.lm_config_from_dict(carry.lm_config_to_dict(cfg16)) == cfg16
    assert carry.lm_config_from_dict(
        dataclasses.asdict(j_qwen.config())) == cfg16


def test_unported_options_raise():
    with pytest.raises(ValueError, match="MoE"):
        qwen3_14b.smoke_config(moe=object())
    # 'chunked' is ported (training); the sharding constraint is not
    qwen3_14b.smoke_config(attn_impl="chunked")
    with pytest.raises(ValueError, match="attn_impl"):
        qwen3_14b.smoke_config(attn_impl="splash")
    # act_spec is accepted: it pins the residual stream on a mesh and is
    # the identity with none current; a plain tensor under two ranks raises
    cfg = qwen3_14b.smoke_config(act_spec=P("data", "model", None))
    params = ttf.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((2, 8), dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    plain = dataclasses.replace(cfg, act_spec=None)
    assert torch.equal(ttf.loss_fn(params, batch, cfg)[0],
                       ttf.loss_fn(params, batch, plain)[0])

    class TwoRanks:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 1}

    with use_mesh(TwoRanks()), pytest.raises(ValueError, match="mesh"):
        ttf.loss_fn(params, batch, cfg)


def test_serve_lm_on_cpu():
    cfg = qwen3_14b.smoke_config(attn_impl="flash")
    kernels.reset_launch_counts()
    rep = serve.serve_lm(cfg, 3, device="cpu")
    assert rep["device"] == "cpu" and rep["peak_mem_bytes"] is None
    assert rep["decode"] == "eager"  # a CUDA graph needs a card
    assert rep["device_s_per_decode_step"] is None
    with pytest.raises(ValueError, match="card"):
        serve.serve_lm(cfg, 3, device="cpu", decode="graph")
    assert len(rep["tokens"]) == 4 and len(rep["tokens"][0]) == 3
    # CPU tensors take the plain version
    assert kernels.launch_counts()["flash_attention"] == 0
    assert rep["prompt_tok_per_s"] > 0 and rep["decode_tok_per_s"] > 0
