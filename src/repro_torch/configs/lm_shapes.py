"""The four LM input shapes of the JAX package (``repro.configs.lm_shapes``),
shared across the LM archs.  No launcher of the port reads them yet: they
name the shapes a benchmark of the LM path would take its cells from."""

TRAIN_4K = dict(kind="train", seq=4096, global_batch=256)
PREFILL_32K = dict(kind="prefill", seq=32768, global_batch=32)
DECODE_32K = dict(kind="decode", seq=32768, global_batch=128)
LONG_500K = dict(kind="decode", seq=524288, global_batch=1)


def lm_shapes(long_context_ok: bool, skip_reason: str = ""):
    shapes = {
        "train_4k": dict(TRAIN_4K),
        "prefill_32k": dict(PREFILL_32K),
        "decode_32k": dict(DECODE_32K),
        "long_500k": dict(LONG_500K),
    }
    if not long_context_ok:
        shapes["long_500k"]["skip"] = (
            skip_reason or "pure full-attention arch: 500k decode mandates "
            "sub-quadratic attention (DESIGN.md §4)")
    return shapes
