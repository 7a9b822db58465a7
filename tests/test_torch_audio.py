"""The port's audio family against the JAX package: whisper-large-v3 reduced
(2 encoder + 2 decoder layers, d 64, 24 frames) in f32, the JAX package's
weights carried over with ``params_from_numpy`` (its norm scales, which its
init leaves at 0, drawn at random first so that a misplaced one shows), the
same numpy tokens and frames in both packages.

The cross-attention layers, the forward's logits, the decode step against a
cross cache filled from the encoder's output (as ``tests/test_models.py``'s
teacher-forcing test fills it), the loss and every gradient, remat and an
``accum=2`` step are held against ``repro``'s. The JAX package's ``prefill``
leaves the cross cache zeros, so its decode steps never see the frames; the
port's fills it, and its greedy tokens are held against the argmax of
``repro``'s forward run by teacher forcing instead of ``repro``'s
``greedy_decode`` (ROADMAP.md Queue 3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore as jax_restore
from repro.ckpt import save as jax_save
from repro.configs import get_reduced as jax_get_reduced
from repro.models import abstract_params as jax_abstract_params
from repro.models import blocks as jax_blocks
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.serve import PagedKVCache as JaxPagedKVCache
from repro.serve import cache_bytes as jax_cache_bytes
from repro.serve import prefill as jax_prefill
from repro.train import init_train_state as jax_init_train_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.ckpt import restore, save
from repro_torch.configs import get_reduced
from repro_torch.dispatch import DispatchService
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.matmul import tiled_matmul
from repro_torch.launch import serve as serve_cli
from repro_torch.models import blocks, decode_step, forward, init_cache, init_params, loss_fn
from repro_torch.models import trainable
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import PagedKVCache, cache_bytes, greedy_decode, prefill
from repro_torch.train import init_train_state, make_train_step
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

ARCH = "whisper-large-v3"
# activations: the port's F32TOL (tests/test_torch_ssm.py:49, after
# tests/test_kernels.py:31); gradients: GRADTOL (tests/test_torch_train.py:46,
# the JAX suite's own tolerance for remat gradients)
F32TOL = dict(atol=2e-3, rtol=2e-3)
GRADTOL = dict(atol=1e-5, rtol=1e-3)
# what the JAX package's init leaves at 0, drawn at random
RANDOM = ("ln1", "ln2", "ln_x", "final_norm")
DECODE_STEPS = 8


def _np_tree(tree) -> dict:
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize(tree: dict, rng) -> dict:
    return {k: _randomize(v, rng) if isinstance(v, dict) else
            (0.1 * rng.standard_normal(v.shape, dtype=np.float32) if k in RANDOM else v)
            for k, v in tree.items()}


def _close(got, want, tol=F32TOL):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).detach().float()),
                               np.asarray(want, np.float32), **tol)


def _tokens(B: int, S: int, vocab: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _frames(cfg, B: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_len, cfg.d_model), dtype=np.float32)


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a.copy())


@pytest.fixture(scope="module")
def model():
    """(jax cfg, port cfg, jax params, numpy params, port params), f32."""
    jcfg = dataclasses.replace(jax_get_reduced(ARCH), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_reduced(ARCH), dtype=torch.float32)
    tree = _randomize(_np_tree(jax_init_params(jcfg, jax.random.PRNGKey(0))),
                      np.random.default_rng(7))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, tree, params_from_numpy(tree)


def _jax_encode(jparams, jcfg, enc):
    """The encoder's output as ``tests/test_models.py``'s teacher-forcing
    test computes it, then each decoder layer's cross K/V: (L, B, Se, K, hd)."""
    B, Se = enc.shape[:2]
    enc_pos = jnp.broadcast_to(jnp.arange(Se)[None, :], (B, Se))
    for li in range(jcfg.n_encoder_layers):
        p_l = jax.tree_util.tree_map(lambda a: a[li], jparams["enc_layers"])
        enc, _ = jax_blocks.attn_layer_train(p_l, enc, cfg=jcfg, positions=enc_pos,
                                             window=None, moe=False, causal=False)
    shape = (B, Se, jcfg.n_kv_heads, jcfg.hd)
    ks, vs = [], []
    for li in range(jcfg.n_layers):
        p_l = jax.tree_util.tree_map(lambda a: a[li], jparams["dec_layers"])
        ks.append((enc @ p_l["xk"]).reshape(shape))
        vs.append((enc @ p_l["xv"]).reshape(shape))
    return enc, {"k": jnp.stack(ks), "v": jnp.stack(vs)}


@pytest.fixture(scope="module")
def reference(model):
    """The JAX package's decode steps over (2, 8) tokens from a cache whose
    cross K/V were filled from the encoder's output on (2, 24) frames:
    each step's logits, the filled cross K/V and the cache after the steps;
    and its forward's logits over those tokens and frames."""
    jcfg, _, jparams, _, _ = model
    toks = _tokens(2, DECODE_STEPS, jcfg.vocab_size, seed=1)
    frames = _frames(jcfg, 2, seed=2)
    _, cross = _jax_encode(jparams, jcfg, jnp.asarray(frames))
    cache = jax_init_cache(jcfg, 2, DECODE_STEPS + 2)
    cache["cross"] = cross
    step = jax.jit(lambda p, c, tok, t: jax_decode_step(p, c, tok, t, jcfg))
    steps = []
    for t in range(DECODE_STEPS):
        lg, cache = step(jparams, cache, jnp.asarray(toks[:, t:t + 1]), t)
        steps.append(np.asarray(lg))
    logits, _ = jax_forward(jparams, {"tokens": jnp.asarray(toks),
                                      "enc_embed": jnp.asarray(frames)}, jcfg)
    return dict(toks=toks, frames=frames, steps=steps, cross=_np_tree(cross),
                cache=_np_tree(cache), logits=np.asarray(logits))


def _shapes(tree) -> dict:
    return {k: _shapes(v) if isinstance(v, dict) else (tuple(v.shape), "bf16" in str(v.dtype))
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def test_init_params_tree_matches_reference():
    """Keys, shapes and which leaves are bf16 (the weights, the cross
    projections included) or f32 (the norms, ``ln_x`` included), at the
    config's bf16."""
    want = jax_abstract_params(jax_get_reduced(ARCH))
    tp = init_params(get_reduced(ARCH), torch.Generator().manual_seed(0))
    assert _shapes({k: v for k, v in tp.items() if k != "embed_t"}) == _shapes(want)
    assert set(tp) == {"embed", "embed_t", "final_norm", "enc_layers", "dec_layers"}
    assert set(tp["dec_layers"]) == set(tp["enc_layers"]) | {"ln_x", "xq", "xk", "xv", "xo"}


def test_params_from_numpy_keeps_the_cross_projections_in_the_weights_dtype(model):
    _, _, _, tree, _ = model
    tp = params_from_numpy(tree, dtype=torch.bfloat16)
    want = _shapes(jax_abstract_params(jax_get_reduced(ARCH)))
    assert _shapes({k: v for k, v in tp.items() if k != "embed_t"}) == want
    d = tp["dec_layers"]
    assert all(d[k].dtype == torch.bfloat16 for k in ("xq", "xk", "xv", "xo"))
    assert d["ln_x"].dtype == torch.float32
    assert torch.equal(d["xk"], _t(tree["dec_layers"]["xk"]).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------


def _layer(tree: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def test_cross_layer_train_matches_reference(model):
    jcfg, tcfg, _, tree, params = model
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, tcfg.d_model), dtype=np.float32)
    enc = rng.standard_normal((2, tcfg.encoder_len, tcfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(6)[None, :], (2, 6))
    jp = jax.tree_util.tree_map(jnp.asarray, _layer(tree["dec_layers"], 1))
    shape = (2, tcfg.encoder_len, tcfg.n_kv_heads, tcfg.hd)
    jkv = {"k": (jnp.asarray(enc) @ jp["xk"]).reshape(shape),
           "v": (jnp.asarray(enc) @ jp["xv"]).reshape(shape)}
    want = jax_blocks.cross_layer_train(jp, jnp.asarray(x), jkv, cfg=jcfg,
                                        positions=jnp.asarray(pos))
    tp = _layer(params["dec_layers"], 1)
    kv = blocks.cross_kv(tp, _t(enc), tcfg)
    for k in ("k", "v"):
        _close(kv[k], jkv[k])
    got = blocks.cross_layer_train(tp, _t(x), kv, cfg=tcfg, positions=_t(pos))
    _close(got, want)


def test_cross_layer_decode_matches_reference(model):
    """One token at position 5 against a self-attention cache holding 5
    earlier entries (and garbage past them, which the mask must hide) and
    the cross K/V; the cache written in place at position 5."""
    jcfg, tcfg, _, tree, params = model
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, tcfg.d_model), dtype=np.float32)
    kv_shape = (2, 8, tcfg.n_kv_heads, tcfg.hd)
    cache = {k: rng.standard_normal(kv_shape, dtype=np.float32) for k in ("k", "v")}
    enc_shape = (2, tcfg.encoder_len, tcfg.n_kv_heads, tcfg.hd)
    enc_kv = {k: rng.standard_normal(enc_shape, dtype=np.float32) for k in ("k", "v")}
    jp = jax.tree_util.tree_map(jnp.asarray, _layer(tree["dec_layers"], 0))
    want, want_cache = jax_blocks.cross_layer_decode(
        jp, jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, cache),
        jax.tree_util.tree_map(jnp.asarray, enc_kv), 5, cfg=jcfg)
    tcache = {k: _t(v) for k, v in cache.items()}
    got, got_cache = blocks.cross_layer_decode(_layer(params["dec_layers"], 0), _t(x), tcache,
                                               {k: _t(v) for k, v in enc_kv.items()}, 5,
                                               cfg=tcfg)
    assert got_cache is tcache
    _close(got, want)
    for k in ("k", "v"):
        _close(got_cache[k], want_cache[k])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_service", [False, True], ids=["plain", "service"])
def test_forward_logits_match_reference(model, reference, with_service):
    _, tcfg, _, _, params = model
    svc = DispatchService() if with_service else None
    got, aux = forward(params, {"tokens": _t(reference["toks"]),
                                "enc_embed": _t(reference["frames"])}, tcfg, service=svc)
    _close(got, reference["logits"])
    assert float(aux) == 0.0
    if with_service:
        # the unembed is the one call site that dispatches (the encoder's
        # and the decoder's layers pass no service, as in the JAX package)
        assert svc.stats["store_default"] == 1 and svc.stats["build_failed"] == 0


def _port_cache(tcfg, reference) -> dict:
    cache = init_cache(tcfg, 2, DECODE_STEPS + 2)
    for k in ("k", "v"):
        cache["cross"][k].copy_(_t(reference["cross"][k]))
    return cache


def test_decode_step_with_a_filled_cross_cache_matches_reference(model, reference):
    _, tcfg, _, _, params = model
    cache = _port_cache(tcfg, reference)
    toks = _t(reference["toks"])
    for t in range(DECODE_STEPS):
        lg, out = decode_step(params, cache, toks[:, t:t + 1], t, tcfg)
        assert out is cache
        _close(lg, reference["steps"][t])
    want = jax.tree_util.tree_leaves(reference["cache"])
    got = jax.tree_util.tree_leaves(cache)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        _close(a, b)


def test_decode_reproduces_the_forward_by_teacher_forcing(model, reference):
    # the JAX suite's own check (tests/test_models.py), on the port alone
    _, tcfg, _, _, params = model
    toks = _t(reference["toks"])
    want, _ = forward(params, {"tokens": toks, "enc_embed": _t(reference["frames"])}, tcfg)
    cache = _port_cache(tcfg, reference)
    got = torch.stack([decode_step(params, cache, toks[:, t:t + 1], t, tcfg)[0]
                       for t in range(DECODE_STEPS)], 1)
    _close(got, want.numpy())


def test_init_cache_matches_reference(model):
    jcfg, tcfg, _, _, _ = model
    want = _shapes(jax_init_cache(jcfg, 3, 11))
    got = init_cache(tcfg, 3, 11)
    assert _shapes(got) == want
    assert all(not bool(t.any()) for t in tree_leaves(got))


@pytest.mark.parametrize("with_service", [False, True], ids=["plain", "service"])
def test_prefill_fills_the_cross_cache_from_the_encoder(model, reference, with_service):
    """The port's prefill leaves the cross K/V the encoder's output gives
    (the JAX-side fill of the teacher-forcing test) and, after the prompt's
    replay, the self-attention K/V the JAX package's decode steps leave on
    that cross cache; its logits are the forward's."""
    _, tcfg, _, _, params = model
    svc = DispatchService() if with_service else None
    logits, cache = prefill(params, {"tokens": _t(reference["toks"]),
                                     "enc_embed": _t(reference["frames"])}, tcfg,
                            max_len=DECODE_STEPS + 2, service=svc)
    _close(logits, reference["logits"])
    for k in ("k", "v"):
        _close(cache["cross"][k], reference["cross"][k])
        _close(cache["dec_layers"][k], reference["cache"]["dec_layers"][k])


def test_reference_prefill_leaves_the_cross_cache_empty(model, reference):
    """Pins the fault of ``repro.serve.prefill`` the port does not copy: its
    cross cache stays zeros, so every decode step after it is blind to the
    frames (two different sets of frames leave one cache)."""
    jcfg, _, jparams, _, _ = model
    toks = jnp.asarray(reference["toks"][:, :6])
    caches = []
    for seed in (2, 12):
        _, cache = jax_prefill(jparams, {"tokens": toks,
                                         "enc_embed": jnp.asarray(_frames(jcfg, 2, seed))},
                               jcfg, max_len=10)
        caches.append(_np_tree(cache))
    assert float(np.abs(caches[0]["cross"]["k"]).max()) == 0.0
    for a, b in zip(jax.tree_util.tree_leaves(caches[0]), jax.tree_util.tree_leaves(caches[1])):
        np.testing.assert_array_equal(a, b)


def test_decode_after_prefill_depends_on_the_frames(model, reference):
    """In the port the decode step after a prefill sees the frames: the
    same prompt and next token under two sets of frames give different
    logits (and each equals the reference's forward over the longer
    sequence, by teacher forcing)."""
    jcfg, tcfg, jparams, _, params = model
    toks = reference["toks"]
    outs = []
    for seed in (2, 12):
        frames = _frames(tcfg, 2, seed)
        _, cache = prefill(params, {"tokens": _t(toks[:, :6]), "enc_embed": _t(frames)}, tcfg,
                           max_len=10)
        lg, _ = decode_step(params, cache, _t(toks[:, 6:7]), 6, tcfg)
        want, _ = jax_forward(jparams, {"tokens": jnp.asarray(toks[:, :7]),
                                        "enc_embed": jnp.asarray(frames)}, jcfg)
        _close(lg, np.asarray(want)[:, 6])
        outs.append(lg)
    assert float((outs[0] - outs[1]).abs().max()) > 0.1


@pytest.mark.parametrize("with_service", [False, True], ids=["plain", "service"])
def test_greedy_tokens_equal_the_teacher_forced_reference_argmax(model, with_service):
    """Each greedy token is the argmax of the JAX package's forward over the
    prompt and the tokens generated before it, on the same frames."""
    jcfg, tcfg, jparams, _, params = model
    prompt = _tokens(2, 5, tcfg.vocab_size, seed=8)
    frames = _frames(tcfg, 2, seed=9)
    steps = 6
    svc = DispatchService() if with_service else None
    got = greedy_decode(params, tcfg, _t(prompt), steps=steps, max_len=5 + steps, service=svc,
                        enc_embed=_t(frames)).numpy()
    assert got.shape == (2, steps)
    seq = np.concatenate([prompt, got[:, :-1]], axis=1)
    logits, _ = jax_forward(jparams, {"tokens": jnp.asarray(seq),
                                      "enc_embed": jnp.asarray(frames)}, jcfg)
    want = np.asarray(jnp.argmax(logits[:, 4:], axis=-1))
    np.testing.assert_array_equal(got, want)
    if with_service:
        # the unembed at the prompt's rows (2 x 5) and at the batch's (2)
        assert svc.stats["store_default"] == 2 and svc.stats["build_failed"] == 0


def test_greedy_decode_needs_the_frames(model):
    _, tcfg, _, _, params = model
    with pytest.raises(KeyError, match="enc_embed"):
        greedy_decode(params, tcfg, _t(_tokens(1, 3, tcfg.vocab_size, 0)), steps=1, max_len=4)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _train_batch(tcfg, B: int, S: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, tcfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, -2:] = -1
    return {"tokens": toks[:, :-1], "labels": labels, "enc_embed": _frames(tcfg, B, seed + 1)}


def _port_grads(params: dict, batch: dict, cfg, **kw):
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    total, _ = loss_fn(tree_unflatten(params, live), batch, cfg, **kw)
    return total.detach(), torch.autograd.grad(total, live, materialize_grads=True)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_policies_give_the_same_loss_and_gradients(model, remat):
    """Each policy wraps each encoder layer and each decoder layer (its
    cross K/V products included): against the JAX package's same policy and
    against the port's own un-rematerialised step."""
    jcfg, tcfg, jparams, _, params = model
    b = _train_batch(tcfg, 2, 6, seed=10)
    (jt, _), jg = jax.value_and_grad(
        lambda p: jax_loss_fn(p, {k: jnp.asarray(v) for k, v in b.items()}, jcfg,
                              remat=remat), has_aux=True)(jparams)
    tb = {k: _t(v) for k, v in b.items()}
    train = trainable(params)
    t0, g0 = _port_grads(train, tb, tcfg)
    t1, g1 = _port_grads(train, tb, tcfg, remat=remat)
    np.testing.assert_allclose(float(t1), float(t0), rtol=1e-6)
    _close(t1, jt, dict(atol=1e-5, rtol=1e-5))
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(g1) == len(jleaves) == len(g0)
    for a, a0, want in zip(g1, g0, jleaves):
        _close(a, a0.numpy(), GRADTOL)
        _close(a, want, GRADTOL)


def test_accum2_train_steps_match_reference(model):
    """Two steps of ``make_train_step(accum=2)`` on batches of 4 (frames
    sliced with the tokens into microbatches): metrics and parameters."""
    jcfg, tcfg, _, tree, _ = model
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    js = jax_init_train_state(jp)
    jstep = jax.jit(jax_make_train_step(jcfg, lr=1e-3, accum=2))
    params = trainable(params_from_numpy(tree))
    opt = init_train_state(params)
    step = make_train_step(tcfg, lr=1e-3, accum=2)
    start = jax.tree_util.tree_leaves(tree)
    for i in range(2):
        b = _train_batch(tcfg, 4, 6, seed=20 + i)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        params, opt, m = step(params, opt, {k: _t(v) for k, v in b.items()})
        for k in ("loss", "aux", "total"):
            _close(m[k], jm[k], dict(atol=1e-5, rtol=1e-5))
        _close(m["grad_norm"], jm["grad_norm"], dict(atol=1e-6, rtol=1e-4))
        assert float(m["aux"]) == 0.0 and int(m["step"]) == i + 1
        if i == 0:  # the first moment is (1 - b1) g: the first gradients
            noise = [(t.abs() < 1e-7).numpy() & (np.abs(np.asarray(w)) < 1e-7)
                     for t, w in zip(tree_leaves(opt["m"]), jax.tree_util.tree_leaves(js["m"]))]
    # the rule of tests/test_torch_train.py's three steps: where a first
    # gradient is rounding noise in both packages (below 1e-6; the key
    # projection's slowest rope dimensions, whose part of a query's scores
    # is nearly one constant, which softmax ignores), Adam moves the element
    # by about lr a step either way, so such elements are held to that
    # bound; the rest to the reference suite's tolerance for parameters
    # after a step (2e-5, 2e-4)
    for a, want, p0, nz in zip(tree_leaves(params), jax.tree_util.tree_leaves(jp), start, noise):
        a, want = a.numpy(), np.asarray(want)
        np.testing.assert_allclose(a[~nz], want[~nz], atol=2e-5, rtol=2e-4)
        assert np.all(np.abs(a - p0)[nz] <= 2 * 1e-3 * (1 + 0.1 * np.abs(p0[nz])) + 1e-7)


def test_checkpoint_of_the_train_state_restores_in_either_package(model, tmp_path):
    """A train state of whisper (encoder and decoder stacks, moments, step)
    saved by the port restores in the JAX package, and the JAX package's in
    the port, bit for bit."""
    jcfg, tcfg, jparams, tree, _ = model
    params = trainable(params_from_numpy(tree))
    opt = init_train_state(params)
    make_train_step(tcfg, lr=1e-3)(params, opt, {k: _t(v) for k, v in
                                                 _train_batch(tcfg, 2, 6, seed=30).items()})
    state = {"params": params, "opt": opt}
    save(str(tmp_path / "port"), state, step=1)
    jtemplate = {"params": jparams, "opt": jax_init_train_state(jparams)}
    got, step = jax_restore(str(tmp_path / "port"), jtemplate)
    assert step == 1
    got_leaves, want_leaves = jax.tree_util.tree_leaves(got), tree_leaves(state)
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jax_save(str(tmp_path / "jax"), got, step=2)
    back, step = restore(str(tmp_path / "jax"), tree_map(torch.zeros_like, state))
    assert step == 2
    for a, b in zip(tree_leaves(back), want_leaves):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# serving: the cache accounting, the paged cache, the CLI
# ---------------------------------------------------------------------------


def test_cache_bytes_count_the_self_attention_cache_as_the_reference():
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config

    for cfg, jcfg in ((get_config(ARCH), jax_get_config(ARCH)),
                      (get_reduced(ARCH), jax_get_reduced(ARCH))):
        assert cache_bytes(cfg, 4, 80) == jax_cache_bytes(jcfg, 4, 80)
        assert cache_bytes(cfg, 4, 80) == 2 * cfg.n_layers * 4 * 80 * cfg.n_kv_heads * cfg.hd * 2


def test_paged_cache_refuses_audio():
    with pytest.raises(ValueError, match="GQA family"):
        PagedKVCache(get_reduced(ARCH), max_batch=2, max_len=16, page_size=8)
    with pytest.raises(ValueError, match="GQA family"):
        JaxPagedKVCache(jax_get_reduced(ARCH), max_batch=2, max_len=16, page_size=8)


def test_launch_serve_on_cpu(capsys):
    for w in (flash_attention, decode_attention, tiled_matmul):
        w.launches = 0
    assert serve_cli.main(["--arch", ARCH, "--device", "cpu", "--reduced", "--batch", "2",
                           "--prompt-len", "6", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "ms/step" in out and "tok/s" in out
    # the unembed at the prompt's rows and at the batch's
    assert '"store_default": 2' in out and '"build_failed": 0' in out
    assert flash_attention.launches == decode_attention.launches == tiled_matmul.launches == 0
    ids = [int(t) for t in out.split("first request ids:")[1].strip().strip("[]").split(",")]
    assert len(ids) == 4 and all(0 <= t < get_reduced(ARCH).vocab_size for t in ids)
