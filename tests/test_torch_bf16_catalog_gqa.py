"""The four GQA configs of the bf16 catalog tests: the reduced zamba2-1.2b
(its shared attention block closing each Mamba2 segment), gemma3-1b (a
local:global window schedule, QK norms, tied), minitron-4b (G = 3,
untied) and qwen1.5-0.5b (MHA, QKV biases) in bf16 against the JAX
package, through ``tests/test_torch_bf16_catalog.py``'s tests (its module
docstring states the tolerances and the rules); and gemma's embedding
scale, rounded to bf16 as the reference rounds it, bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.blocks as jax_blocks
import repro_torch.models.blocks as blocks
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro_torch.models import decode_step, forward, init_cache
from repro_torch.models.model import _embed_scale
from test_torch_bf16_catalog import (  # noqa: F401  (collected here on this file's configs)
    B,
    _build,
    _jbatch,
    _tbatch,
    test_bf16_forward_logits_match_the_reference_and_f32,
    test_bf16_greedy_tokens_match_the_reference_up_to_a_near_tie,
    test_bf16_params_keep_the_references_dtypes,
    test_bf16_prefill_and_teacher_forced_decode_match_forward,
    test_bf16_teacher_forced_argmax_matches_the_reference,
)

ARCHS = ("zamba2-1.2b", "gemma3-1b", "minitron-4b", "qwen1.5-0.5b")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _build(request.param)


# ---------------------------------------------------------------------------
# gemma's embedding scale in the config's dtype
# ---------------------------------------------------------------------------


def _first_layer_input(monkeypatch, module, name: str, run) -> np.ndarray:
    """The residual stream ``run()`` hands to its first call of
    ``module.name`` (argument 1: the embedded, scaled tokens), as f32."""
    seen = []
    orig = getattr(module, name)

    def wrapped(*args, **kw):
        if not seen:
            x = args[1]
            seen.append(x.float().numpy() if isinstance(x, torch.Tensor)
                        else np.asarray(x.astype(jnp.float32)))
        return orig(*args, **kw)

    with monkeypatch.context() as mp:
        mp.setattr(module, name, wrapped)
        run()
    return seen[0]


def test_gemma_bf16_embedding_scale_is_bit_equal_to_the_reference(monkeypatch):
    """gemma3 scales its bf16 embeddings by sqrt(d_model) rounded to bf16,
    as the reference does (at the full 1152, 33.94 -> 34.0). At a reduced
    width of 72 (8.485 -> 8.5; the reduced config's 64 has the exact 8) the
    first layer's input in the forward and in a decode step is bit-equal
    in the two packages, and so is the full width's scaled embedding."""
    model = _build("gemma3-1b", d_model=72)
    tcfg, jcfg, tok = model["tcfg"], model["jcfg"], model["tok"]
    assert _embed_scale(tcfg) == 8.5 != 72 ** 0.5
    got = _first_layer_input(monkeypatch, blocks, "attn_layer_train",
                             lambda: forward(model["tp"], _tbatch(model, tok), tcfg))
    with jax.disable_jit():
        want = _first_layer_input(monkeypatch, jax_blocks, "attn_layer_train",
                                  lambda: jax_forward(model["jp"], _jbatch(model, tok), jcfg))
    np.testing.assert_array_equal(got, want)
    cache = init_cache(tcfg, B, 4)
    got = _first_layer_input(monkeypatch, blocks, "attn_layer_decode", lambda: decode_step(
        model["tp"], cache, torch.from_numpy(tok[:, :1]).long(), 0, tcfg))
    with jax.disable_jit():
        want = _first_layer_input(monkeypatch, jax_blocks, "attn_layer_decode",
                                  lambda: jax_decode_step(model["jp"], jax_init_cache(jcfg, B, 4),
                                                          jnp.asarray(tok[:, :1]), 0, jcfg))
    np.testing.assert_array_equal(got, want)
    full = dataclasses.replace(tcfg, d_model=1152)
    assert _embed_scale(full) == float(jnp.asarray(1152 ** 0.5, jnp.bfloat16)) == 34.0
    x = np.random.default_rng(4).standard_normal((4, 1152), dtype=np.float32)
    got = (torch.from_numpy(x).bfloat16() * _embed_scale(full)).float().numpy()
    want = np.asarray((jnp.asarray(x, jnp.bfloat16)
                       * jnp.asarray(1152 ** 0.5, jnp.bfloat16)).astype(jnp.float32))
    np.testing.assert_array_equal(got, want)
