"""The LM stack's kernel wrappers of the port, on CPU tensors (their plain
versions), held to the JAX package's Pallas kernels in interpret mode.

Inputs come from a seeded numpy generator and go to both packages as
numpy.  Tolerances are those of the JAX package's own kernel tests
(tests/test_kernels.py): 2e-5 for attention, 1e-5 for the embedding bag,
both in f32, where the two sides sum in other orders.  The JAX side of the
embedding bag is the kernel (``impl="pallas_interpret"``), not its ``ref``,
which gives nan for an id >= V where the kernel adds nothing.  The CUDA
kernels themselves run only on the card (tests/test_torch_gpu.py and
chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import embedding_bag as jeb
from repro.kernels import flash_attention as jfa
from repro_torch.kernels.embedding_bag import ops as teb
from repro_torch.kernels.flash_attention import ops as tfa


def _qkv(seed, b, h, hkv, s, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]


# (b, h, hkv, s, d, causal, window); bq = bk = 32 tiles on the JAX side
FLASH_CASES = {
    "causal": (1, 2, 2, 64, 16, True, 0),
    "full": (1, 2, 2, 64, 16, False, 0),
    "window8": (1, 2, 2, 64, 16, True, 8),
    "window8_noncausal": (1, 2, 2, 64, 16, False, 8),
    "gqa": (2, 4, 2, 64, 8, True, 0),
    "ragged": (1, 4, 2, 50, 16, True, 8),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_matches_pallas_interpret(case):
    b, h, hkv, s, d, causal, window = FLASH_CASES[case]
    q, k, v = _qkv(len(case), b, h, hkv, s, d)
    want = jfa.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, window=window, bq=32, bk=32,
                   impl="pallas_interpret")
    got = tfa.mha(*map(torch.from_numpy, (q, k, v)), causal=causal,
                  window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# bf16: FLASH_CASES plus one D=120 case, at the JAX package's own bf16
# tolerance (tests/test_kernels.py::test_flash_bf16, 3e-2): the plain
# version rounds the scores to bf16 where the kernel keeps them in f32
FLASH_BF16_CASES = {**FLASH_CASES, "d120": (1, 4, 2, 50, 120, True, 8)}


@pytest.mark.parametrize("case", list(FLASH_BF16_CASES))
def test_flash_bf16_matches_pallas_interpret(case):
    b, h, hkv, s, d, causal, window = FLASH_BF16_CASES[case]
    q, k, v = _qkv(len(case) + 100, b, h, hkv, s, d)
    want = jfa.mha(*(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
                   causal=causal, window=window, bq=32, bk=32,
                   impl="pallas_interpret")
    got = tfa.mha(*(torch.from_numpy(x).to(torch.bfloat16)
                    for x in (q, k, v)), causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=3e-2, atol=3e-2)


def test_flash_whole_tiles_masked_stays_finite():
    """Window 4 with 32-row tiles: for all but the first tile's rows whole
    kv tiles are masked; no row may turn nan."""
    q, k, v = _qkv(11, 1, 1, 1, 64, 16)
    want = jfa.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=True, window=4, bq=32, bk=32,
                   impl="pallas_interpret")
    got = tfa.mha(*map(torch.from_numpy, (q, k, v)), causal=True, window=4)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def _bag_case(seed, b, l, v, d):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    # pads (-1), ids < -1, ids >= V (past the padded vocab too) and repeats
    ids = rng.integers(-1, v, (b, l)).astype(np.int32)
    big = rng.random((b, l)) < 0.15
    ids[big] = v + rng.integers(0, 300, int(big.sum()))
    ids[rng.random((b, l)) < 0.1] = -7
    ids[0, :] = -1  # an empty bag
    weights = rng.random((b, l)).astype(np.float32)
    return table, ids, weights


@pytest.mark.parametrize("mode,weighted", [("sum", False), ("sum", True),
                                           ("mean", False), ("mean", True)])
@pytest.mark.parametrize("b,l,v,d", [(5, 7, 40, 8), (9, 20, 129, 16)])
def test_embedding_bag_matches_pallas_interpret(mode, weighted, b, l, v, d):
    table, ids, weights = _bag_case(b * l, b, l, v, d)
    w = weights if weighted else None
    want = jeb.embedding_bag(jnp.asarray(table), jnp.asarray(ids), mode=mode,
                             weights=None if w is None else jnp.asarray(w),
                             bb=4, bv=32, impl="pallas_interpret")
    got = teb.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                            mode=mode, weights=None if w is None
                            else torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("d", [7, 64, 256])
@pytest.mark.parametrize("l", [1, 50, 70])
def test_embedding_bag_widths_and_lengths(d, l):
    """The widths and bag lengths the card's kernel splits differently: D
    not a multiple of 4 (4-byte chunks), MIND's 64 and 256 (16-byte
    chunks), a single id, MIND's 50 and a bag past 64 ids."""
    table, ids, weights = _bag_case(d + l, 6, l, 40, d)
    for mode, w in (("sum", None), ("sum", weights), ("mean", None)):
        want = jeb.embedding_bag(
            jnp.asarray(table), jnp.asarray(ids), mode=mode,
            weights=None if w is None else jnp.asarray(w), bb=8, bv=64,
            impl="pallas_interpret")
        got = teb.embedding_bag(torch.from_numpy(table),
                                torch.from_numpy(ids), mode=mode,
                                weights=None if w is None
                                else torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_embedding_bag_max_mode_raises():
    table, ids, _ = _bag_case(0, 2, 3, 10, 4)
    with pytest.raises(ValueError, match="not supported"):
        teb.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                          mode="max")
