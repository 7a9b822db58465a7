"""The port's MoE family against the JAX package, on the reduced mixtral-8x7b
(routed experts, GQA, a sliding window of 16) and deepseek-v2-236b (MLA
latent attention, routed and shared experts, a leading dense layer) in f32:
the JAX package's weights carried over with ``params_from_numpy``, the same
numpy inputs, outputs at F32TOL and greedy tokens identical. On the CPU the
port's dispatched matmuls take their plain versions; MLA, the experts and
windowed attention are plain tensor operations in both packages."""

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
from repro.models import mla as jax_mla
from repro.models import moe as jax_moe
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
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.mla import init_mla_cache, mla_attention, mla_decode
from repro_torch.models.moe import moe_ffn
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
ARCHS = ("mixtral-8x7b", "deepseek-v2-236b")
# norm scales drawn at random (the JAX package's init leaves them 0, which
# would hide a misplaced norm)
NORMS = ("ln1", "ln2", "q_norm", "kv_norm", "final_norm")


def _np_tree(params) -> dict:
    return jax.tree_util.tree_map(np.asarray, params)


def _randomize_norms(tree: dict, rng) -> dict:
    return {k: _randomize_norms(v, rng) if isinstance(v, dict)
            else (0.1 * rng.standard_normal(v.shape, dtype=np.float32) if k in NORMS else v)
            for k, v in tree.items()}


def _close(got, want, tol=F32TOL):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).float()),
                               np.asarray(want, np.float32), **tol)


def _prompt(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S), dtype=np.int32)


def _route_margin(x: np.ndarray, router: np.ndarray, k: int) -> float:
    """The least gap between the k-th and (k+1)-th router probability over
    the tokens of ``x``: a test whose routing hinges on a near-tie could
    pass or fail on the summation order alone."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ router.astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), axis=-1)[:, ::-1]
    return float((p[:, k - 1] - p[:, k]).min())


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """The JAX package's reduced weights of one arch, with random norm
    scales, in both packages."""
    arch = request.param
    jcfg = dataclasses.replace(jax_get_reduced(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
    jparams = jax.jit(jax_init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0))
    tree = _randomize_norms(_np_tree(jparams), np.random.default_rng(5))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, params_from_numpy(tree, tie_embeddings=False)


DECODE_TOKENS = 20   # mixtral's ring of 16 positions wraps


@pytest.fixture(scope="module")
def reference(model):
    """The JAX package's outputs on the reduced model, shared by the port's
    plain and service runs: the forward's logits and aux on a (2, 12)
    prompt, each step's logits and the filled cache of 20 decode steps from
    a fresh cache of max_len 24, and 12 greedy tokens after a (2, 7) prompt
    (each jitted)."""
    jcfg, tcfg, jparams, _ = model
    fwd_toks = _prompt(2, 12, tcfg.vocab_size, seed=1)
    logits, aux = jax.jit(lambda p, t: jax_forward(p, {"tokens": t}, jcfg))(
        jparams, jnp.asarray(fwd_toks))
    dec_toks = _prompt(2, DECODE_TOKENS, tcfg.vocab_size, seed=4)
    step = jax.jit(lambda p, c, tok, t: jax_decode_step(p, c, tok, t, jcfg))
    cache, steps = jax_init_cache(jcfg, 2, 24), []
    for t in range(DECODE_TOKENS):
        lg, cache = step(jparams, cache, jnp.asarray(dec_toks[:, t:t + 1]), t)
        steps.append(np.asarray(lg))
    greedy_toks = _prompt(2, 7, tcfg.vocab_size, seed=5)
    greedy = jax.jit(lambda p, t: jax_greedy_decode(p, jcfg, t, steps=12, max_len=20))(
        jparams, jnp.asarray(greedy_toks))
    return dict(fwd_toks=fwd_toks, logits=np.asarray(logits), aux=np.asarray(aux),
                dec_toks=dec_toks, steps=steps, cache=_np_tree(cache),
                greedy_toks=greedy_toks, greedy=np.asarray(greedy))


# ---------------------------------------------------------------------------
# the routed experts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def experts():
    """init_moe's weights (d 16, expert width 32, 4 experts), with and
    without a shared expert, and one input (2, 12, 16)."""
    out = {}
    for n_shared in (0, 1):
        p = jax_moe.init_moe(jax.random.PRNGKey(7), 16, 32, n_experts=4, n_shared=n_shared,
                             dtype=jnp.float32)
        out[n_shared] = _np_tree(p)
    x = np.random.default_rng(8).standard_normal((2, 12, 16), dtype=np.float32)
    return out, x


def _moe_pair(tree, x, cf, group):
    want = jax_moe.moe_ffn(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
                           top_k=2, capacity_factor=cf, group_size=group)
    got = moe_ffn(params_from_numpy(tree, tie_embeddings=False), torch.from_numpy(x),
                  top_k=2, capacity_factor=cf, group_size=group)
    return got, want


@pytest.mark.parametrize("n_shared", [0, 1], ids=["routed", "shared"])
@pytest.mark.parametrize("group", [8, 10], ids=["group-divides", "group-pads"])
@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["no-drop", "drops"])
def test_moe_ffn_matches_reference(experts, cf, group, n_shared):
    trees, x = experts
    tree = trees[n_shared]
    assert _route_margin(x, tree["router"], 2) > 1e-4   # no test input hinges on a tie
    (y, aux), (jy, jaux) = _moe_pair(tree, x, cf, group)
    assert y.shape == (2, 12, 16) and aux.dtype == torch.float32
    _close(y, jy)
    _close(aux, jaux)
    if cf < 1:
        # capacity 4 per group of 8 or 10 tokens x top-2 over 4 experts:
        # tokens are dropped, so the output differs from ample capacity's
        (y_all, _), _ = _moe_pair(tree, x, 8.0, group)
        assert not torch.allclose(y, y_all, atol=1e-3)


@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["no-drop", "drops"])
def test_moe_ffn_bf16_keeps_the_router_in_f32(experts, cf):
    """bf16 experts and input: the router's weights and logits stay f32 in
    both packages (src/repro/models/moe.py:46, :83), so the same tokens are
    routed and dropped; y in bf16 at bf16's tolerance, aux (from the f32
    router probabilities alone) to 1e-6, a few f32 ulps: a router rounded
    to bf16 moves it by 1.4e-5 here."""
    trees, x = experts
    tree = trees[1]
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert _route_margin(xb.float().numpy(), tree["router"], 2) > 1e-4
    p = params_from_numpy(tree, dtype=torch.bfloat16, tie_embeddings=False)
    assert p["router"].dtype == torch.float32 and p["wg"].dtype == torch.bfloat16
    jp = {k: jnp.asarray(v) if k == "router" else
          jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), v)
          for k, v in tree.items()}
    jy, jaux = jax_moe.moe_ffn(jp, jnp.asarray(x).astype(jnp.bfloat16), top_k=2,
                               capacity_factor=cf, group_size=10)
    y, aux = moe_ffn(p, xb, top_k=2, capacity_factor=cf, group_size=10)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    _close(y, jy.astype(jnp.float32), BF16TOL)
    _close(aux, jaux, dict(atol=1e-6, rtol=1e-6))


def test_moe_group_size_invariance_at_ample_capacity(experts):
    """tests/test_models.py::test_moe_group_size_invariance, on the port."""
    trees, x = experts
    p = params_from_numpy(trees[0], tie_embeddings=False)
    outs = [moe_ffn(p, torch.from_numpy(x), top_k=2, capacity_factor=8.0, group_size=g)[0]
            for g in (8, 10, 24, 2048)]
    for o in outs[1:]:
        _close(o, outs[0], dict(atol=1e-5, rtol=1e-5))


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mla():
    cfg = dataclasses.replace(get_reduced("deepseek-v2-236b"), dtype=torch.float32)
    jcfg = dataclasses.replace(jax_get_reduced("deepseek-v2-236b"), dtype=jnp.float32)
    tree = _randomize_norms(_np_tree(jax_mla.init_mla(jax.random.PRNGKey(3), jcfg,
                                                      jnp.float32)),
                            np.random.default_rng(4))
    return cfg, jcfg, tree


@pytest.mark.parametrize("chunk", [512, 4], ids=["one-chunk", "chunks-pad"])
def test_mla_attention_matches_reference(mla, chunk):
    cfg, jcfg, tree = mla
    x = np.random.default_rng(9).standard_normal((2, 10, cfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(10)[None], (2, 10))
    want = jax_mla.mla_attention(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
                                 jcfg, jnp.asarray(pos), chunk=chunk)
    got = mla_attention(params_from_numpy(tree, tie_embeddings=False), torch.from_numpy(x),
                        cfg, torch.from_numpy(np.ascontiguousarray(pos)), chunk=chunk)
    _close(got, want)


@pytest.mark.parametrize("absorb", [True, False], ids=["absorb", "naive"])
def test_mla_decode_matches_reference(mla, absorb):
    """Six steps from a fresh cache: each step's output and the filled
    latent cache, under both schedules."""
    cfg, jcfg, tree = mla
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    p = params_from_numpy(tree, tie_embeddings=False)
    xs = np.random.default_rng(10).standard_normal((6, 2, 1, cfg.d_model), dtype=np.float32)
    jcache = jax_mla.init_mla_cache(jcfg, 2, 8, jnp.float32)
    cache = init_mla_cache(cfg, 2, 8, torch.float32)
    for t in range(6):
        want, jcache = jax_mla.mla_decode(jp, jnp.asarray(xs[t]), jcache, jcfg, t, absorb=absorb)
        got, out = mla_decode(p, torch.from_numpy(xs[t]), cache, cfg, t, absorb=absorb)
        assert out is cache
        _close(got, want)
    for name in ("c_kv", "k_rope"):
        _close(cache[name], jcache[name])


def test_mla_schedules_agree_and_refuse_per_row_positions(mla):
    cfg, _, tree = mla
    p = params_from_numpy(tree, tie_embeddings=False)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal((2, 1, cfg.d_model),
                                                                   dtype=np.float32))
    outs = []
    for absorb in (True, False):
        cache = init_mla_cache(cfg, 2, 8, torch.float32)
        for t in range(3):
            o, cache = mla_decode(p, x, cache, cfg, t, absorb=absorb)
        outs.append(o)
    _close(outs[0], outs[1], dict(atol=1e-3, rtol=1e-3))   # tests/test_models.py:131
    with pytest.raises(ValueError, match="scalar position"):
        mla_decode(p, x, init_mla_cache(cfg, 2, 8, torch.float32), cfg, torch.tensor([0, 1]))


# ---------------------------------------------------------------------------
# the models: params, caches, forward, decode, greedy
# ---------------------------------------------------------------------------


def _shapes(tree) -> dict:
    return {k: _shapes(v) if isinstance(v, dict) else (tuple(v.shape), "bf16" in str(v.dtype))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    """Keys, shapes and which leaves are bf16 (the weights) or f32 (norms,
    the router), at the configs' bf16 — dense0's FFN 12288 wide for the
    reduced deepseek too."""
    want = jax_abstract_params(jax_get_reduced(arch))
    tp = init_params(get_reduced(arch), torch.Generator().manual_seed(0))
    assert _shapes(tp) == _shapes(want)
    if arch.startswith("deepseek"):
        assert tp["dense0"]["mlp"]["wg"].shape == (64, 12288)
        assert tp["layers"]["moe"]["shared"]["wg"].shape == (2, 64, 32)


def test_params_from_numpy_keys_and_dtypes(model):
    jcfg, _, jparams, _ = model
    jp = _np_tree(jparams)
    tp = params_from_numpy(jp, dtype=torch.bfloat16, tie_embeddings=False)
    assert _shapes(tp) == _shapes(jax_abstract_params(dataclasses.replace(
        jcfg, dtype=jnp.bfloat16)))
    layers = tp["layers"]
    assert layers["moe"]["router"].dtype == torch.float32
    assert layers["ln1"].dtype == tp["final_norm"].dtype == torch.float32
    assert layers["moe"]["wg"].dtype == tp["unembed"].dtype == torch.bfloat16
    if jcfg.attn_type == "mla":
        m = layers["mla"]
        assert m["q_norm"].dtype == m["kv_norm"].dtype == torch.float32
        assert {m[k].dtype for k in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo")} == {torch.bfloat16}
        assert tp["dense0"]["mlp"]["wd"].dtype == torch.bfloat16
        want = torch.from_numpy(np.array(jp["dense0"]["mla"]["wkv_b"])).to(torch.bfloat16)
        assert torch.equal(tp["dense0"]["mla"]["wkv_b"], want)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    """The MLA latent cache for every layer and dense0; mixtral's ring of
    min(max_len, window) positions."""
    for max_len in (12, 40):
        want = _np_tree(jax_init_cache(jax_get_reduced(arch), 3, max_len))
        got = init_cache(get_reduced(arch), 3, max_len)
        assert _shapes(got) == _shapes(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_accounting_matches_reference(arch):
    for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                      (get_reduced(arch), jax_get_reduced(arch))):
        assert cache_bytes_per_token(cfg) == jax_per_token(jcfg)
        assert cache_bytes(cfg, 4, 144, 4, page_size=128) == jax_cache_bytes(
            jcfg, 4, 144, 4, page_size=128)


@pytest.mark.parametrize("with_service", [False, True], ids=["plain", "service"])
def test_forward_logits_and_aux_match_reference(model, reference, with_service):
    _, tcfg, _, params = model
    toks = reference["fwd_toks"]
    svc = DispatchService() if with_service else None
    got, aux = forward(params, {"tokens": torch.from_numpy(toks).long()}, tcfg, service=svc)
    assert got.shape == (2, 12, tcfg.vocab_size) and got.dtype == torch.float32
    _close(got, reference["logits"])
    _close(aux, reference["aux"])
    assert float(aux) > 0
    if with_service:
        # mixtral: the output projection and the unembed; deepseek: the unembed
        assert svc.stats["store_default"] == (2 if tcfg.attn_type == "gqa" else 1)


@pytest.mark.parametrize("with_service", [False, True], ids=["plain", "service"])
def test_decode_logits_match_reference(model, reference, with_service):
    """20 decode steps from a fresh cache (max_len 24): mixtral's ring of 16
    positions wraps; each step's logits and the filled cache of every
    layer (deepseek's latent cache, dense0's included)."""
    _, tcfg, _, params = model
    toks = reference["dec_toks"]
    cache = init_cache(tcfg, 2, 24)
    if tcfg.attn_type == "gqa":
        assert cache["layers"]["k"].shape[2] == tcfg.sliding_window == 16
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
    """A prompt of 7 and 12 new tokens: mixtral's ring wraps past 16."""
    _, tcfg, _, params = model
    svc = DispatchService() if with_service else None
    got = greedy_decode(params, tcfg, torch.from_numpy(reference["greedy_toks"]).long(),
                        steps=12, max_len=20, service=svc)
    np.testing.assert_array_equal(got.numpy(), reference["greedy"])
    if with_service:
        assert svc.stats["build_failed"] == 0


def test_decode_matches_forward_at_ample_capacity(model):
    """tests/test_models.py:157-184 on the port: with ample capacity nothing
    is dropped, and sequential decode reproduces the forward's logits."""
    _, tcfg, _, params = model
    cfg = dataclasses.replace(tcfg, capacity_factor=8.0)
    toks = torch.from_numpy(_prompt(1, 6, cfg.vocab_size, seed=6)).long()
    ref, _ = forward(params, {"tokens": toks}, cfg)
    cache = init_cache(cfg, 1, 8)
    outs = []
    for t in range(6):
        lg, cache = decode_step(params, cache, toks[:, t:t + 1], t, cfg)
        outs.append(lg)
    _close(torch.stack(outs, 1), ref.numpy(), dict(atol=2e-2, rtol=2e-2))


# ---------------------------------------------------------------------------
# serving: the serve step's key, the paged cache, the CLI
# ---------------------------------------------------------------------------


def test_serve_step_key_carries_the_mla_schedule(model):
    _, tcfg, _, params = model
    svc = DispatchService()
    a = make_serve_step(tcfg, mla_absorb=True, service=svc)
    b = make_serve_step(tcfg, mla_absorb=False, service=svc)
    assert a is not b and svc.stats["exec_miss"] == 2
    assert make_serve_step(tcfg, mla_absorb=True, service=svc) is a
    tok = torch.from_numpy(_prompt(2, 1, tcfg.vocab_size, seed=7)).long()
    _, la, _ = a(params, init_cache(tcfg, 2, 4), tok, 0)
    _, lb, _ = b(params, init_cache(tcfg, 2, 4), tok, 0)
    _close(la, lb.numpy(), dict(atol=1e-3, rtol=1e-3))


def test_paged_decode_matches_per_request_greedy_for_mixtral():
    """Continuous batching of reduced mixtral on bucketed views (per-row
    positions through the routed experts) reproduces each request's solo
    greedy_decode tokens; the cache of 16 positions stays within the
    window."""
    tcfg = dataclasses.replace(get_reduced("mixtral-8x7b"), dtype=torch.float32)
    params = init_params(tcfg, torch.Generator().manual_seed(2))
    svc = DispatchService()
    prompts = [torch.from_numpy(_prompt(1, n, tcfg.vocab_size, seed=40 + n)).long()
               for n in (5, 3, 7)]
    steps = 6
    pc = PagedKVCache(tcfg, max_batch=4, max_len=16, page_size=8)
    assert pc.alloc == tcfg.sliding_window
    svc.attach_kv_cache(pc)
    base = [greedy_decode(params, tcfg, p, steps=steps, max_len=pc.alloc, service=svc)
            for p in prompts]
    serve = make_serve_step(tcfg, service=svc)
    slots, toks = [0, 1, 3], []
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
    st = svc.telemetry()["kv_cache"]
    assert st["slots_active"] == 3 and st["tokens_resident"] == 5 + 3 + 7 + 3 * (steps - 1)


def test_paged_cache_refuses_mla_and_windows_past_their_length():
    ds, jds = get_reduced("deepseek-v2-236b"), jax_get_reduced("deepseek-v2-236b")
    with pytest.raises(ValueError, match="GQA family"):
        PagedKVCache(ds, max_batch=2, max_len=16, page_size=8)
    with pytest.raises(ValueError, match="GQA family"):
        JaxPagedKVCache(jds, max_batch=2, max_len=16, page_size=8)
    with pytest.raises(ValueError, match="window"):
        PagedKVCache(get_reduced("mixtral-8x7b"), max_batch=2, max_len=17, page_size=8)
    with pytest.raises(ValueError, match="window"):
        PagedKVCache(get_reduced("gemma3-1b"), max_batch=2, max_len=8, page_size=8)


@pytest.mark.parametrize("arch,signatures", [("mixtral-8x7b", 4), ("deepseek-v2-236b", 2)])
def test_launch_serve_moe_on_cpu(capsys, arch, signatures):
    for w in (flash_attention, decode_attention, tiled_matmul):
        w.launches = 0
    assert serve_cli.main(["--arch", arch, "--device", "cpu", "--reduced", "--batch", "2",
                           "--prompt-len", "6", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "ms/step" in out and "tok/s" in out
    # the matmul call sites at the prompt's rows and at the batch's: mixtral's
    # output projection and unembed, deepseek's unembed
    assert f'"store_default": {signatures}' in out and '"build_failed": 0' in out
    # the plain versions ran: no kernel launched on the CPU
    assert flash_attention.launches == decode_attention.launches == tiled_matmul.launches == 0
