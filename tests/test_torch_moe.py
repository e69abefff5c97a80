"""The port's MoE layer and MoE LM serving path held to the JAX package's.

Weights come from the JAX package's ``init`` and cross into the port
through ``carry``; inputs come from a seeded numpy generator.  ``apply``
runs under both dispatch strategies, one and two GShard groups, a
capacity factor that drops most pairs beside the configs' 1.25, and with
and without shared experts; the port computes every case by index, the
reference by its one-hot einsums or its argsort.  The smoke configs of
moonshot-v1-16b-a3b and qwen3-moe-235b-a22b then go through prefill and
teacher-forced decode, as tests/test_torch_lm.py runs the dense archs.

Tolerance 2e-4 abs/rel, the reference's own for its LM logits: both sides
compute in f32 and sum in other orders.
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

from repro.configs import moonshot_v1_16b_a3b as j_moonshot
from repro.configs import qwen3_moe_235b_a22b as j_qwen_moe
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import carry, kernels
from repro_torch.configs import moonshot_v1_16b_a3b, qwen3_moe_235b_a22b
from repro_torch.launch import serve
from repro_torch.launch.mesh import P, use_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf

ROOT = Path(__file__).resolve().parents[1]
ARCHS = {"moonshot": (j_moonshot, moonshot_v1_16b_a3b),
         "qwen3_moe": (j_qwen_moe, qwen3_moe_235b_a22b)}
BATCH, PROMPT, CACHE, STEPS = 2, 12, 16, 6
TOL = dict(rtol=2e-4, atol=2e-4)
T, D, F, E, K = 32, 16, 8, 4, 2


def _moe_case(dispatch, n_groups, capacity_factor, shared):
    jcfg = jmoe.MoEConfig(n_experts=E, top_k=K, d_model=D, d_ff=F,
                          n_shared_experts=shared,
                          capacity_factor=capacity_factor,
                          dispatch=dispatch, n_groups=n_groups)
    params = jax.tree_util.tree_map(
        np.asarray, jmoe.init(jax.random.PRNGKey(3), jcfg))
    x = np.random.default_rng(3).standard_normal((T, D)).astype(np.float32)
    return jcfg, params, x


def _kept_pairs(params, x, cfg):
    """(token, slot) pairs within capacity, counted by the reference's
    rule in numpy: token-major places in each expert's queue per group."""
    probs = jax.nn.softmax(x @ params["router"], axis=-1)
    top_i = np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])
    g = cfg.n_groups if cfg.dispatch == "einsum" else 1
    c = jmoe._capacity(T // g, cfg)
    kept = 0
    for grp in np.split(top_i.reshape(-1), g):
        kept += sum(min(int((grp == e).sum()), c) for e in range(E))
    return kept


@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_moe_apply_matches_jax(dispatch, n_groups, capacity_factor, shared):
    jcfg, params, x = _moe_case(dispatch, n_groups, capacity_factor, shared)
    want_y, want_aux = jax.jit(
        lambda p, a: jmoe.apply(p, a, jcfg))(params, jnp.asarray(x))
    cfg = tmoe.MoEConfig(**dataclasses.asdict(jcfg))
    tparams = {k: (({kk: torch.tensor(vv) for kk, vv in v.items()})
                   if isinstance(v, dict) else torch.tensor(v))
               for k, v in params.items()}
    y, aux = tmoe.apply(tparams, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    if capacity_factor < 1:  # the case is meant to drop pairs
        assert _kept_pairs(params, x, jcfg) < T * K


def test_moe_config_rejects_unknown_dispatch_and_sharding():
    with pytest.raises(ValueError, match="dispatch"):
        tmoe.MoEConfig(n_experts=4, top_k=2, d_model=8, d_ff=4,
                       dispatch="scatter")
    # the sharding constraints are accepted: the identity with no mesh
    # current, refused for a plain tensor under a mesh of two ranks
    cfg = tmoe.MoEConfig(n_experts=4, top_k=2, d_model=8, d_ff=4,
                         disp_spec=P("data", None, "model", None),
                         expert_spec=P("model", "data", None, None))
    params = tmoe.init(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((6, 8), generator=torch.Generator().manual_seed(1))
    plain = dataclasses.replace(cfg, disp_spec=None, expert_spec=None)
    assert torch.equal(tmoe.apply(params, x, cfg)[0],
                       tmoe.apply(params, x, plain)[0])

    class TwoRanks:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 1}

    with use_mesh(TwoRanks()), pytest.raises(ValueError, match="mesh"):
        tmoe.apply(params, x, cfg)


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


@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_moe_prefill_and_decode_match_jax(arch, impl):
    tree, toks, want_last, fed, want_steps = _jax_run(arch, impl)
    cfg = carry.lm_config_from_dict(dataclasses.asdict(_jax_cfg(arch, impl)))
    assert isinstance(cfg.moe, tmoe.MoEConfig)
    params = carry.lm_params_from_numpy(tree, cfg, "cpu")
    cache, last = ttf.prefill(params, torch.from_numpy(toks), cfg, CACHE)
    np.testing.assert_allclose(last.numpy(), want_last, **TOL)
    for i, (tok, want) in enumerate(zip(fed, want_steps)):
        logits, cache = ttf.decode_step(params, cache, torch.from_numpy(tok),
                                        cfg)
        np.testing.assert_allclose(logits.numpy(), want, **TOL,
                                   err_msg=f"decode step {i}")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_moe_device_position_decode_matches_jax(arch):
    """The MoE archs through ``decode_step_at`` (the position, the cache
    slot and the greedy pick on the tensors' device, as the decode graph
    runs them), eagerly == JAX's decode within 2e-4; ``greedy_step``
    gives ``decode_step``'s greedy tokens."""
    tree, toks, _, fed, want_steps = _jax_run(arch, "xla")
    cfg = carry.lm_config_from_dict(dataclasses.asdict(_jax_cfg(arch, "xla")))
    params = carry.lm_params_from_numpy(tree, cfg, "cpu")
    cache, _ = ttf.prefill(params, torch.from_numpy(toks), cfg, CACHE)
    pos = torch.tensor(cache["pos"])
    for i, (tok, want) in enumerate(zip(fed, want_steps)):
        logits = ttf.decode_step_at(params, cache, torch.from_numpy(tok),
                                    pos, cfg)
        np.testing.assert_allclose(logits.numpy(), want, **TOL,
                                   err_msg=f"decode step {i}")
    toks_t = torch.from_numpy(toks)
    cache, last = ttf.prefill(params, toks_t, cfg, CACHE)
    tok = last.argmax(-1).to(torch.int32)
    want_tok = []
    for _ in range(STEPS):
        want_tok.append(tok)
        logits, cache = ttf.decode_step(params, cache, tok, cfg)
        tok = logits.argmax(-1).to(torch.int32)
    cache, last = ttf.prefill(params, toks_t, cfg, CACHE)
    pos = torch.tensor(cache["pos"])
    tok = last.argmax(-1).to(torch.int32)
    got_tok = torch.zeros((BATCH, STEPS), dtype=torch.int32)
    col = torch.zeros(1, dtype=torch.int64)
    for _ in range(STEPS):
        ttf.greedy_step(params, cache, pos, tok, got_tok, col, cfg)
    assert torch.equal(got_tok, torch.stack(want_tok, 1))


def test_moe_configs_match_jax():
    for arch, (jmod, tmod) in ARCHS.items():
        for make in ("smoke_config", "config"):
            want = dataclasses.asdict(getattr(jmod, make)())
            got = carry.lm_config_to_dict(getattr(tmod, make)())
            assert _dtype_name(got.pop("dtype")) == \
                _dtype_name(want.pop("dtype")), (arch, make)
            assert got == want, (arch, make)
        jcfg, tcfg = jmod.config(), tmod.config()
        assert tcfg.n_params() == jcfg.n_params(), arch
        assert tcfg.n_active_params() == jcfg.n_active_params(), arch
        assert tmod.SHAPES == jmod.SHAPES, arch
        assert carry.lm_config_from_dict(dataclasses.asdict(jcfg)) == tcfg
    assert moonshot_v1_16b_a3b.config().n_params() == 28552923136
    assert qwen3_moe_235b_a22b.config().n_params() == 235093610496


def _dtype_name(d):
    return d if isinstance(d, str) else np.dtype(d).name


def test_moe_carry_round_trip_is_exact():
    tree = _jax_run("moonshot", "xla")[0]
    cfg = carry.lm_config_from_dict(
        dataclasses.asdict(_jax_cfg("moonshot", "xla")))
    params = carry.lm_params_from_numpy(tree, cfg, "cpu")
    moe = params["layers"][1]["moe"]
    assert tuple(moe["w_gate"].shape) == (4, 64, 32)
    assert tuple(moe["w_down"].shape) == (4, 32, 64)
    assert tuple(moe["shared"]["w_up"].shape) == (64, 32)
    back = carry.lm_params_to_numpy(params)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for want, got in zip(jax.tree_util.tree_leaves(tree),
                         jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(got, want)


def test_serve_lm_moe_on_cpu():
    cfg = qwen3_moe_235b_a22b.smoke_config(attn_impl="flash")
    kernels.reset_launch_counts()
    rep = serve.serve_lm(cfg, 3, device="cpu")
    assert rep["n_params"] == cfg.n_params()
    assert len(rep["tokens"]) == 4 and len(rep["tokens"][0]) == 3
    assert rep["logits_finite"]
    assert kernels.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "qwen3-moe-235b-a22b"])
def test_serve_cli_moe_archs_on_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--device", "cpu", "--steps", "2"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "on cpu" in out.stdout
