"""The port's SSM, hybrid and VLM families against the JAX package: the
Mamba2 mixer (chunked SSD scan, causal conv, recurrent decode) and the
reduced mamba2-780m, zamba2-1.2b (five Mamba2 layers, the shared attention
block every two: three sites, the last segment short) and qwen2-vl-7b
(M-RoPE on explicit, distinct 3-section positions) in f32: the JAX
package's weights carried over with ``params_from_numpy``, the same numpy
inputs, outputs at F32TOL and greedy tokens identical. On the CPU the
port's dispatched kernels take their plain versions; the mixer is plain
tensor operations in both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.models import abstract_params as jax_abstract_params
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import ssm as jax_ssm
from repro.serve import PagedKVCache as JaxPagedKVCache
from repro.serve import cache_bytes as jax_cache_bytes
from repro.serve import cache_bytes_per_token as jax_per_token
from repro.serve import greedy_decode as jax_greedy_decode
from repro_torch.configs import get_config, get_reduced
from repro_torch.dispatch import DispatchService
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.matmul import tiled_matmul
from repro_torch.launch import serve as serve_cli
from repro_torch.models import decode_step, forward, init_cache, init_params
from repro_torch.models import ssm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (
    PagedKVCache,
    cache_bytes,
    cache_bytes_per_token,
    greedy_decode,
    make_serve_step,
    prefill,
)

F32TOL = dict(atol=2e-3, rtol=2e-3)   # tests/test_kernels.py:31
BF16TOL = dict(atol=3e-2, rtol=3e-2)  # tests/test_kernels.py:30
ARCHS = ("mamba2-780m", "zamba2-1.2b", "qwen2-vl-7b")
# what the JAX package's init leaves trivial (0, or D's 1), drawn at random
# so that a misplaced term shows: norm scales, the mixer's dt bias, D and
# conv bias, qwen2-vl's QKV biases
RANDOM = ("ln", "ln1", "ln2", "norm", "final_norm", "dt_bias", "D", "conv_b", "bq", "bk", "bv")
# dispatch signatures the service resolves in a forward (each family's call
# sites: the unembed; zamba2's shared block and qwen2-vl's layers add flash
# attention and the output projection)
FORWARD_SIGNATURES = {"mamba2-780m": 1, "zamba2-1.2b": 3, "qwen2-vl-7b": 3}


def _np_tree(params) -> dict:
    return jax.tree_util.tree_map(np.asarray, params)


def _randomize(tree: dict, rng) -> dict:
    def draw(k, v):
        if k not in RANDOM:
            return v
        r = 0.1 * rng.standard_normal(v.shape, dtype=np.float32)
        return (1.0 + r) if k == "D" else r

    return {k: _randomize(v, rng) if isinstance(v, dict) else draw(k, v)
            for k, v in tree.items()}


def _close(got, want, tol=F32TOL):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).float()),
                               np.asarray(want, np.float32), **tol)


def _prompt(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S), dtype=np.int32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable copy


# ---------------------------------------------------------------------------
# the Mamba2 mixer
# ---------------------------------------------------------------------------


def _ssd_inputs(b=2, s=16, H=4, P=8, N=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, H), dtype=np.float32)))  # softplus'd
    A = -np.exp(rng.standard_normal(H, dtype=np.float32))
    B = rng.standard_normal((b, s, N), dtype=np.float32)
    C = rng.standard_normal((b, s, N), dtype=np.float32)
    h0 = rng.standard_normal((b, H, P, N), dtype=np.float32)
    return x, dt, A, B, C, h0


def test_segsum_is_minus_infinity_above_the_diagonal():
    a = np.random.default_rng(1).standard_normal((3, 6), dtype=np.float32)
    got = ssm._segsum(_t(a))
    want = np.asarray(jax_ssm._segsum(jnp.asarray(a)))
    upper = np.triu(np.ones((6, 6), bool), 1)
    assert np.all(np.isneginf(got.numpy()[:, upper])) and np.all(np.isneginf(want[:, upper]))
    _close(got.numpy()[:, ~upper], want[:, ~upper])
    assert torch.count_nonzero(torch.exp(got)[:, torch.from_numpy(upper)]) == 0


@pytest.mark.parametrize("initial", [False, True], ids=["zero-state", "initial-state"])
@pytest.mark.parametrize("chunk", [4, 8, 16, 64],
                         ids=["chunk4", "chunk8", "chunk-s", "chunk-past-s"])
def test_ssd_matches_reference(chunk, initial):
    x, dt, A, B, C, h0 = _ssd_inputs()
    want_y, want_h = jax_ssm.ssd(*(jnp.asarray(a) for a in (x, dt, A, B, C)), chunk=chunk,
                                 initial_state=jnp.asarray(h0) if initial else None)
    y, h = ssm.ssd(*(_t(a) for a in (x, dt, A, B, C)), chunk=chunk,
                   initial_state=_t(h0) if initial else None)
    assert y.dtype == h.dtype == torch.float32 and h.shape == (2, 4, 8, 8)
    _close(y, want_y)
    _close(h, want_h)


def test_ssd_refuses_a_length_off_the_chunk():
    x, dt, A, B, C, _ = _ssd_inputs(s=12)
    with pytest.raises(ValueError, match="chunk 8"):
        ssm.ssd(*(_t(a) for a in (x, dt, A, B, C)), chunk=8)


def test_ssd_state_stays_f32_in_bf16():
    x, dt, A, B, C, _ = _ssd_inputs()
    y, h = ssm.ssd(_t(x).to(torch.bfloat16), _t(dt), _t(A), _t(B).to(torch.bfloat16),
                   _t(C).to(torch.bfloat16), chunk=8)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    want_y, want_h = jax_ssm.ssd(jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(A),
                                 jnp.asarray(B, jnp.bfloat16), jnp.asarray(C, jnp.bfloat16),
                                 chunk=8)
    _close(y, want_y.astype(jnp.float32), BF16TOL)
    _close(h, want_h, BF16TOL)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(2)
    xBC = rng.standard_normal((2, 10, 12), dtype=np.float32)
    w = rng.standard_normal((4, 12), dtype=np.float32)
    b = rng.standard_normal(12, dtype=np.float32)
    want = jax_ssm._causal_conv(jnp.asarray(xBC), jnp.asarray(w), jnp.asarray(b))
    _close(ssm._causal_conv(_t(xBC), _t(w), _t(b)), want)


@pytest.fixture(scope="module")
def mixer():
    """One reduced mamba2-780m mixer (d 64, d_in 128, 8 heads of 16, state
    16), its trivial parameters drawn at random, in both packages' configs."""
    jcfg = dataclasses.replace(jax_get_reduced("mamba2-780m"), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_reduced("mamba2-780m"), dtype=torch.float32)
    p = jax_ssm.init_mamba2(jax.random.PRNGKey(3), jcfg.d_model, expand=jcfg.ssm_expand,
                            head_dim=jcfg.ssm_head_dim, n_state=jcfg.ssm_state,
                            conv_width=jcfg.ssm_conv_width, dtype=jnp.float32)
    return jcfg, tcfg, _randomize(_np_tree(p), np.random.default_rng(4))


@pytest.mark.parametrize("chunk", [4, 64], ids=["chunks", "one-chunk"])
def test_mamba2_forward_matches_reference(mixer, chunk):
    jcfg, tcfg, tree = mixer
    x = np.random.default_rng(5).standard_normal((2, 12, tcfg.d_model), dtype=np.float32)
    want = jax_ssm.mamba2_forward(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
                                  jcfg, chunk=chunk)
    got = ssm.mamba2_forward(params_from_numpy(tree, tie_embeddings=False), _t(x), tcfg,
                             chunk=chunk)
    _close(got, want)


def test_mamba2_forward_bf16_matches_reference(mixer):
    """bf16 projections and input (the conv, A, D, dt bias and norm stay f32
    in both packages) at bf16's tolerance."""
    jcfg, tcfg, tree = mixer
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    x = np.random.default_rng(6).standard_normal((2, 8, tcfg.d_model), dtype=np.float32)
    p = params_from_numpy(tree, dtype=torch.bfloat16, tie_embeddings=False)
    assert p["in_proj"].dtype == p["out_proj"].dtype == torch.bfloat16
    assert {p[k].dtype for k in ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm")} \
        == {torch.float32}
    jp = {k: jnp.asarray(v, jnp.bfloat16 if k in ("in_proj", "out_proj") else jnp.float32)
          for k, v in tree.items()}
    want = jax_ssm.mamba2_forward(jp, jnp.asarray(x, jnp.bfloat16), jcfg, chunk=4)
    got = ssm.mamba2_forward(p, _t(x).to(torch.bfloat16), tcfg, chunk=4)
    assert got.dtype == torch.bfloat16
    _close(got, want.astype(jnp.float32), BF16TOL)


def test_mamba2_decode_matches_reference_over_a_sequence(mixer):
    """Eight steps from a fresh state: each step's output, then the conv
    window and SSM state, both updated in place in the port."""
    jcfg, tcfg, tree = mixer
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    p = params_from_numpy(tree, tie_embeddings=False)
    xs = np.random.default_rng(7).standard_normal((8, 2, 1, tcfg.d_model), dtype=np.float32)
    jcache = jax_ssm.init_ssm_cache(jcfg, 2)
    cache = ssm.init_ssm_cache(tcfg, 2)
    conv, state = cache["conv"], cache["ssm"]
    for t in range(8):
        want, jcache = jax_ssm.mamba2_decode(jp, jnp.asarray(xs[t]), jcache, jcfg)
        got, out = ssm.mamba2_decode(p, _t(xs[t]), cache, tcfg)
        assert out is cache and out["conv"] is conv and out["ssm"] is state
        _close(got, want)
    _close(cache["conv"], jcache["conv"])
    _close(cache["ssm"], jcache["ssm"])


def test_mamba2_decode_token_by_token_equals_forward(mixer):
    """The recurrence reproduces the chunked scan's output position by
    position (and the JAX package's forward)."""
    jcfg, tcfg, tree = mixer
    p = params_from_numpy(tree, tie_embeddings=False)
    x = np.random.default_rng(8).standard_normal((2, 12, tcfg.d_model), dtype=np.float32)
    whole = ssm.mamba2_forward(p, _t(x), tcfg, chunk=4)
    cache = ssm.init_ssm_cache(tcfg, 2)
    steps = torch.cat([ssm.mamba2_decode(p, _t(x[:, t:t + 1]), cache, tcfg)[0]
                       for t in range(12)], dim=1)
    _close(steps, whole.numpy())
    want = jax_ssm.mamba2_forward(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
                                  jcfg, chunk=4)
    _close(steps, want)


# ---------------------------------------------------------------------------
# the models: params, caches, forward, decode, greedy
# ---------------------------------------------------------------------------


def _positions(cfg, B, S, seed):
    """Explicit (B, 3, S) M-RoPE positions whose three sections differ (a
    text span then an image grid), or None for the other families."""
    if not cfg.mrope:
        return None
    t = np.arange(S)
    pos = np.stack([np.minimum(t, 4), 4 + (t // 3), 4 + (t % 3) * 2])
    pos = pos[None] + np.random.default_rng(seed).integers(0, 3, (B, 1, 1))
    return pos.astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """The JAX package's reduced weights of one arch, with its trivial
    parameters drawn at random, in both packages."""
    arch = request.param
    jcfg = dataclasses.replace(jax_get_reduced(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
    jparams = jax.jit(jax_init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0))
    tree = _randomize(_np_tree(jparams), np.random.default_rng(5))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return arch, jcfg, tcfg, jparams, params_from_numpy(tree, tie_embeddings=tcfg.tie_embeddings)


DECODE_TOKENS = 10


@pytest.fixture(scope="module")
def reference(model):
    """The JAX package's outputs on the reduced model, shared by the port's
    plain and service runs: the forward's logits on a (2, 12) prompt (SSD
    chunk 4: three chunks; qwen2-vl on explicit positions), each step's
    logits and the filled cache of 10 decode steps from a fresh cache of
    max_len 12, and 8 greedy tokens after a (2, 7) prompt (each jitted)."""
    _, jcfg, tcfg, jparams, _ = model
    fwd_toks = _prompt(2, 12, tcfg.vocab_size, seed=1)
    positions = _positions(tcfg, 2, 12, seed=2)
    batch = {"tokens": jnp.asarray(fwd_toks)}
    if positions is not None:
        batch["positions"] = jnp.asarray(positions)
    logits, _ = jax.jit(lambda p, b: jax_forward(p, b, jcfg, ssm_chunk=4))(jparams, batch)
    dec_toks = _prompt(2, DECODE_TOKENS, tcfg.vocab_size, seed=4)
    step = jax.jit(lambda p, c, tok, t: jax_decode_step(p, c, tok, t, jcfg))
    cache, steps = jax_init_cache(jcfg, 2, 12), []
    for t in range(DECODE_TOKENS):
        lg, cache = step(jparams, cache, jnp.asarray(dec_toks[:, t:t + 1]), t)
        steps.append(np.asarray(lg))
    greedy_toks = _prompt(2, 7, tcfg.vocab_size, seed=5)
    greedy = jax.jit(lambda p, t: jax_greedy_decode(p, jcfg, t, steps=8, max_len=16))(
        jparams, jnp.asarray(greedy_toks))
    return dict(fwd_toks=fwd_toks, positions=positions, logits=np.asarray(logits),
                dec_toks=dec_toks, steps=steps, cache=_np_tree(cache),
                greedy_toks=greedy_toks, greedy=np.asarray(greedy))


def _shapes(tree) -> dict:
    return {k: _shapes(v) if isinstance(v, dict) else (tuple(v.shape), "bf16" in str(v.dtype))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    """Keys, shapes and which leaves are bf16 (the weights) or f32 (norms,
    biases, the mixer's conv, A, D and dt bias), at the configs' bf16;
    zamba2's one shared block, qwen2-vl's untied unembed."""
    want = jax_abstract_params(jax_get_reduced(arch))
    tp = init_params(get_reduced(arch), torch.Generator().manual_seed(0))
    assert _shapes({k: v for k, v in tp.items() if k != "embed_t"}) == _shapes(want)
    assert ("shared_attn" in tp) == (arch == "zamba2-1.2b")
    assert ("unembed" in tp) == (arch == "qwen2-vl-7b") == ("embed_t" not in tp)


def test_params_from_numpy_keys_and_dtypes(model):
    arch, jcfg, tcfg, jparams, _ = model
    jp = _np_tree(jparams)
    tp = params_from_numpy(jp, dtype=torch.bfloat16, tie_embeddings=tcfg.tie_embeddings)
    want = _shapes(jax_abstract_params(dataclasses.replace(jcfg, dtype=jnp.bfloat16)))
    assert _shapes({k: v for k, v in tp.items() if k != "embed_t"}) == want
    if tcfg.family in ("ssm", "hybrid"):
        m = tp["layers"]["mixer"]
        assert m["in_proj"].dtype == m["out_proj"].dtype == torch.bfloat16
        assert torch.equal(m["D"], _t(jp["layers"]["mixer"]["D"]))
    if arch == "zamba2-1.2b":
        s = tp["shared_attn"]
        assert s["wo"].dtype == s["mlp"]["wg"].dtype == torch.bfloat16
        assert s["ln1"].dtype == torch.float32 and s["wq"].ndim == 2
        assert torch.equal(s["wq"], _t(jp["shared_attn"]["wq"]).to(torch.bfloat16))
    if arch == "qwen2-vl-7b":
        assert tp["unembed"].dtype == torch.bfloat16 and tp["layers"]["bq"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    """Shapes and dtypes at the configs' bf16: the Mamba2 state f32, the KV
    caches bf16; zamba2's shared K/V over its ceil(5 / 2) = 3 sites."""
    for max_len in (12, 40):
        want = _np_tree(jax_init_cache(jax_get_reduced(arch), 3, max_len))
        got = init_cache(get_reduced(arch), 3, max_len)
        assert _shapes(got) == _shapes(want)
    if arch == "zamba2-1.2b":
        assert got["shared_attn"]["k"].shape[0] == 3
    if arch != "qwen2-vl-7b":
        assert got["layers"]["ssm"].dtype == got["layers"]["conv"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_accounting_matches_reference(arch):
    for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                      (get_reduced(arch), jax_get_reduced(arch))):
        assert cache_bytes_per_token(cfg) == jax_per_token(jcfg)
        assert cache_bytes(cfg, 4, 144, 4, page_size=128) == jax_cache_bytes(
            jcfg, 4, 144, 4, page_size=128)


@pytest.mark.parametrize("with_service", [False, True], ids=["plain", "service"])
def test_forward_logits_match_reference(model, reference, with_service):
    arch, _, tcfg, _, params = model
    batch = {"tokens": torch.from_numpy(reference["fwd_toks"]).long()}
    if reference["positions"] is not None:
        batch["positions"] = torch.from_numpy(reference["positions"]).long()
    svc = DispatchService() if with_service else None
    got, aux = forward(params, batch, tcfg, ssm_chunk=4, service=svc)
    assert got.shape == (2, 12, tcfg.vocab_size) and got.dtype == torch.float32
    assert float(aux) == 0.0
    _close(got, reference["logits"])
    if with_service:
        assert svc.stats["store_default"] == FORWARD_SIGNATURES[arch]


@pytest.mark.parametrize("with_service", [False, True], ids=["plain", "service"])
def test_decode_logits_match_reference(model, reference, with_service):
    """10 decode steps from a fresh cache (max_len 12): each step's logits
    and the filled cache (Mamba2 state, zamba2's shared K/V per site,
    qwen2-vl's K/V)."""
    _, _, tcfg, _, params = model
    toks = reference["dec_toks"]
    cache = init_cache(tcfg, 2, 12)
    svc = DispatchService() if with_service else None
    for t in range(DECODE_TOKENS):
        got, cache = decode_step(params, cache, torch.from_numpy(toks[:, t:t + 1]).long(), t,
                                 tcfg, service=svc)
        _close(got, reference["steps"][t])
    got_leaves = jax.tree_util.tree_leaves(cache)
    want_leaves = jax.tree_util.tree_leaves(reference["cache"])
    assert len(got_leaves) == len(want_leaves)
    for got_leaf, want_leaf in zip(got_leaves, want_leaves):
        _close(got_leaf, want_leaf)


@pytest.mark.parametrize("with_service", [False, True], ids=["plain", "service"])
def test_greedy_tokens_match_reference(model, reference, with_service):
    _, _, tcfg, _, params = model
    svc = DispatchService() if with_service else None
    got = greedy_decode(params, tcfg, torch.from_numpy(reference["greedy_toks"]).long(),
                        steps=8, max_len=16, service=svc)
    np.testing.assert_array_equal(got.numpy(), reference["greedy"])
    if with_service:
        assert svc.stats["build_failed"] == 0


def test_decode_matches_forward(model):
    """Sequential decode reproduces the forward's logits (the SSD scan's
    chunks against the recurrence; qwen2-vl on its default positions)."""
    _, _, tcfg, _, params = model
    toks = torch.from_numpy(_prompt(1, 8, tcfg.vocab_size, seed=6)).long()
    ref, _ = forward(params, {"tokens": toks}, tcfg, ssm_chunk=4)
    cache = init_cache(tcfg, 1, 8)
    outs = []
    for t in range(8):
        lg, cache = decode_step(params, cache, toks[:, t:t + 1], t, tcfg)
        outs.append(lg)
    _close(torch.stack(outs, 1), ref.numpy())


# ---------------------------------------------------------------------------
# serving: the paged cache, a prompt off the chunk, the CLI
# ---------------------------------------------------------------------------


def test_paged_cache_refuses_ssm_and_hybrid():
    for arch in ("mamba2-780m", "zamba2-1.2b"):
        with pytest.raises(ValueError, match="GQA family"):
            PagedKVCache(get_reduced(arch), max_batch=2, max_len=16, page_size=8)
        with pytest.raises(ValueError, match="GQA family"):
            JaxPagedKVCache(jax_get_reduced(arch), max_batch=2, max_len=16, page_size=8)


def test_paged_decode_matches_per_request_greedy_for_qwen2_vl():
    """Continuous batching of reduced qwen2-vl on bucketed views (per-row
    positions through M-RoPE's three sections) reproduces each request's
    solo greedy_decode tokens."""
    tcfg = dataclasses.replace(get_reduced("qwen2-vl-7b"), dtype=torch.float32)
    params = init_params(tcfg, torch.Generator().manual_seed(2))
    JaxPagedKVCache(jax_get_reduced("qwen2-vl-7b"), max_batch=2, max_len=16, page_size=8)
    svc = DispatchService()
    prompts = [torch.from_numpy(_prompt(1, n, tcfg.vocab_size, seed=40 + n)).long()
               for n in (5, 3, 7)]
    steps = 8
    pc = PagedKVCache(tcfg, max_batch=4, max_len=24, page_size=8)
    svc.attach_kv_cache(pc)
    base = [greedy_decode(params, tcfg, p, steps=steps, max_len=pc.alloc, service=svc)
            for p in prompts]
    serve = make_serve_step(tcfg, service=svc)
    slots, toks = [0, 2, 3], []
    for slot, p in zip(slots, prompts):
        logits, cache = prefill(params, {"tokens": p}, tcfg, max_len=pc.alloc, service=svc)
        pc.admit(slot, cache, p.shape[1])
        toks.append([int(torch.argmax(logits[0, -1]))])
    cur = torch.tensor([[t[-1]] for t in toks])
    buckets = set()
    for _ in range(steps - 1):
        bucket = pc.seq_bucket(slots)
        buckets.add(bucket)
        view = pc.view(slots, bucket)
        nxt, _, view = serve(params, view, cur, pc.pos_vector(slots) + 1)
        pc.writeback(slots, bucket, view)
        pc.advance(slots)
        for i, t in enumerate(toks):
            t.append(int(nxt[i, 0]))
        cur = nxt
    assert buckets == {8, 16}
    for got, want in zip(toks, base):
        assert got == want[0].tolist()


def test_prompt_off_the_chunk_raises():
    """A prompt longer than the SSD chunk must be a multiple of it, as in
    the JAX package (which asserts it)."""
    tcfg = dataclasses.replace(get_reduced("mamba2-780m"), dtype=torch.float32)
    params = init_params(tcfg, torch.Generator().manual_seed(3))
    prompt = torch.from_numpy(_prompt(1, 70, tcfg.vocab_size, seed=9)).long()
    with pytest.raises(ValueError, match="chunk 64"):
        greedy_decode(params, tcfg, prompt, steps=1, max_len=72)
    out = greedy_decode(params, tcfg, prompt, steps=1, max_len=72, ssm_chunk=10)
    assert out.shape == (1, 1)


@pytest.mark.parametrize("arch,signatures", [("mamba2-780m", 2), ("zamba2-1.2b", 6),
                                             ("qwen2-vl-7b", 6)])
def test_launch_serve_on_cpu(capsys, arch, signatures):
    for w in (flash_attention, decode_attention, tiled_matmul):
        w.launches = 0
    assert serve_cli.main(["--arch", arch, "--device", "cpu", "--reduced", "--batch", "2",
                           "--prompt-len", "6", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "ms/step" in out and "tok/s" in out
    # the unembed at the prompt's rows and at the batch's; zamba2 and
    # qwen2-vl add flash, decode and the output projection at both
    assert f'"store_default": {signatures}' in out and '"build_failed": 0' in out
    # the plain versions ran: no kernel launched on the CPU
    assert flash_attention.launches == decode_attention.launches == tiled_matmul.launches == 0
