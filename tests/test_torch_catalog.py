"""The rest of the dense catalog against the JAX package, on the reduced
configs in f32: gemma3-1b (a local:global window schedule, QK norms, tied),
minitron-4b (untied) and qwen1.5-0.5b (MHA with QKV biases). The JAX
package's weights are carried over with ``params_from_numpy``, with every
bias and norm scale drawn at random (its init leaves them 0, which would
hide a misplaced one); the same numpy prompts go to both packages. Forward
logits at F32TOL, greedy tokens equal over 20 steps (past gemma3's reduced
window of 8), qwen1.5's paged decode against its per-request greedy decode,
and the paged cache refusing gemma3 in both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.serve import PagedKVCache as JaxPagedKVCache
from repro.serve import greedy_decode as jax_greedy_decode
from repro_torch.configs import get_reduced
from repro_torch.dispatch import DispatchService
from repro_torch.models import forward
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import PagedKVCache, greedy_decode, make_serve_step, prefill

F32TOL = dict(atol=2e-3, rtol=2e-3)   # tests/test_kernels.py:30
ARCHS = ("gemma3-1b", "minitron-4b", "qwen1.5-0.5b")
STEPS = 20


def _randomize_zeros(tree: dict, rng) -> dict:
    """Every all-zero leaf (biases, norm scales) drawn as 0.1 N(0, 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_zeros(v, rng)
        elif not np.any(v):
            out[k] = 0.1 * rng.standard_normal(v.shape, dtype=np.float32)
        else:
            out[k] = v
    return out


_MODELS: dict = {}


def _model(arch: str):
    """(jax cfg, torch cfg, jax params, torch params) of the reduced arch."""
    if arch not in _MODELS:
        jcfg = dataclasses.replace(jax_get_reduced(arch), dtype=jnp.float32)
        tcfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
        tree = jax.tree_util.tree_map(np.asarray,
                                      jax_init_params(jcfg, jax.random.PRNGKey(0)))
        tree = _randomize_zeros(tree, np.random.default_rng(7))
        _MODELS[arch] = (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                         params_from_numpy(tree))
    return _MODELS[arch]


def _prompt(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S), dtype=np.int32)


def test_the_reduced_configs_are_what_this_file_holds():
    g, m, q = (get_reduced(a) for a in ARCHS)
    assert g.local_global_ratio and g.sliding_window == 8 and g.tie_embeddings and g.qk_norm
    assert not m.tie_embeddings and m.n_kv_heads < m.n_heads
    assert q.qkv_bias and q.n_kv_heads == q.n_heads


@pytest.mark.parametrize("with_service", [False, True], ids=["plain", "service"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch, with_service):
    jcfg, tcfg, jparams, params = _model(arch)
    toks = _prompt(2, 12, tcfg.vocab_size, seed=1)   # past gemma3's window of 8
    want, _ = jax_forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    svc = DispatchService() if with_service else None
    got, aux = forward(params, {"tokens": torch.from_numpy(toks).long()}, tcfg, service=svc)
    assert got.shape == (2, 12, tcfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32TOL)
    if with_service:
        assert svc.stats["build_failed"] == 0 and svc.stats["store_default"] >= 2


@pytest.mark.parametrize("with_service", [False, True], ids=["plain", "service"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference_over_20_steps(arch, with_service):
    jcfg, tcfg, jparams, params = _model(arch)
    toks = _prompt(2, 6, tcfg.vocab_size, seed=2)
    want = jax_greedy_decode(jparams, jcfg, jnp.asarray(toks), steps=STEPS,
                             max_len=6 + STEPS)
    svc = DispatchService() if with_service else None
    got = greedy_decode(params, tcfg, torch.from_numpy(toks).long(), steps=STEPS,
                        max_len=6 + STEPS, service=svc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_qwen15_paged_decode_matches_per_request_greedy():
    """Continuous batching on bucketed views (MHA with biases) reproduces each
    request's solo greedy decode, in the port and against the JAX package's."""
    jcfg, tcfg, jparams, params = _model("qwen1.5-0.5b")
    svc = DispatchService()
    lens, steps = (5, 3, 9), 6
    prompts = [_prompt(1, n, tcfg.vocab_size, seed=30 + n) for n in lens]
    pc = PagedKVCache(tcfg, max_batch=4, max_len=16, page_size=8)
    solo = [greedy_decode(params, tcfg, torch.from_numpy(p).long(), steps=steps,
                          max_len=pc.alloc, service=svc)[0].tolist() for p in prompts]
    ref = [np.asarray(jax_greedy_decode(jparams, jcfg, jnp.asarray(p), steps=steps,
                                        max_len=pc.alloc))[0].tolist() for p in prompts]
    assert solo == ref
    serve = make_serve_step(tcfg, service=svc)
    slots, toks = [0, 2, 3], []
    for slot, p in zip(slots, prompts):
        logits, cache = prefill(params, {"tokens": torch.from_numpy(p).long()}, tcfg,
                                max_len=pc.alloc, service=svc)
        pc.admit(slot, cache, p.shape[1])
        toks.append([int(torch.argmax(logits[0, -1]))])
    cur = torch.tensor([[t[-1]] for t in toks])
    for _ in range(steps - 1):
        bucket = pc.seq_bucket(slots)
        view = pc.view(slots, bucket)
        nxt, _, view = serve(params, view, cur, pc.pos_vector(slots) + 1)
        pc.writeback(slots, bucket, view)
        pc.advance(slots)
        for i, t in enumerate(toks):
            t.append(int(nxt[i, 0]))
        cur = nxt
    assert toks == solo
    assert svc.stats["build_failed"] == 0


@pytest.mark.parametrize("max_len", [4, 64])
def test_paged_cache_refuses_gemma3_in_both_packages(max_len):
    # a local:global schedule is refused whatever the length, in both packages
    jcfg, tcfg, _, _ = _model("gemma3-1b")
    with pytest.raises(ValueError):
        JaxPagedKVCache(jcfg, 2, max_len, page_size=4)
    with pytest.raises(ValueError, match="windowed"):
        PagedKVCache(tcfg, 2, max_len, page_size=4)
