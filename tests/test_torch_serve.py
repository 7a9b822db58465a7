"""The port's serving path against the JAX package, on the reduced
qwen2-0.5b in f32: the JAX package's weights carried over with
``params_from_numpy``, the same numpy prompts, logits at F32TOL and greedy
tokens identical. On the CPU the port's dispatched kernels take their plain
versions; the JAX side runs its Pallas kernels in interpret mode
(``DispatchService(None, target="tpu")``) or, without a service, its einsum
paths."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.dispatch import DispatchService as JaxDispatchService
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.serve import greedy_decode as jax_greedy_decode
from repro_torch import kernels as _kernels  # noqa: F401  (package import check)
from repro_torch.configs import get_config, get_reduced
from repro_torch.dispatch import DispatchService
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.matmul import tiled_matmul
from repro_torch.launch import serve as serve_cli
from repro_torch.models import decode_step, forward, init_cache, init_params
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (
    PagedKVCache,
    cache_bytes,
    cache_bytes_per_token,
    greedy_decode,
    make_serve_step,
    prefill,
)

F32TOL = dict(atol=2e-3, rtol=2e-3)   # tests/test_kernels.py:30
ARCH = "qwen2-0.5b"


def _cfgs():
    jcfg = dataclasses.replace(jax_get_reduced(ARCH), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_reduced(ARCH), dtype=torch.float32)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def model():
    """The JAX package's reduced qwen2-0.5b weights, with random QKV biases
    and norm scales (its init leaves them 0, which would hide a misplaced
    bias), in both packages."""
    jcfg, tcfg = _cfgs()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(5)
    for name in ("bq", "bk", "bv", "ln1", "ln2"):
        tree["layers"][name] = 0.1 * rng.standard_normal(
            tree["layers"][name].shape, dtype=np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, params_from_numpy(tree)


def _prompt(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S), dtype=np.int32)


def test_params_carry_the_reference_keys(model):
    _, _, jparams, params = model
    assert set(params) == set(jparams) | {"embed_t"}
    assert set(params["layers"]) == set(jparams["layers"])
    np.testing.assert_array_equal(params["embed_t"].numpy(), np.asarray(jparams["embed"]).T)
    assert params["layers"]["wq"].shape == tuple(jparams["layers"]["wq"].shape)


@pytest.mark.parametrize("with_service", [False, True])
def test_forward_logits_match_reference(model, with_service):
    jcfg, tcfg, jparams, params = model
    toks = _prompt(2, 12, tcfg.vocab_size, seed=1)
    want, _ = jax_forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    svc = DispatchService() if with_service else None
    got, aux = forward(params, {"tokens": torch.from_numpy(toks).long()}, tcfg, service=svc)
    assert got.shape == (2, 12, tcfg.vocab_size) and got.dtype == torch.float32
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32TOL)
    if with_service:
        # flash_attention, the output projection and the unembed: one signature each
        assert svc.stats["store_default"] == 3


@pytest.mark.parametrize("jax_service", [False, True], ids=["jax-einsum", "jax-pallas"])
def test_greedy_tokens_match_reference(model, jax_service):
    jcfg, tcfg, jparams, params = model
    toks = _prompt(2, 7, tcfg.vocab_size, seed=2)
    jsvc = JaxDispatchService(None, target="tpu") if jax_service else None
    want = jax_greedy_decode(jparams, jcfg, jnp.asarray(toks), steps=6, max_len=16,
                             service=jsvc)
    svc = DispatchService()
    got = greedy_decode(params, tcfg, torch.from_numpy(toks).long(), steps=6, max_len=16,
                        service=svc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the default configs are the kernels (impl "pallas"), not the xla variants
    for kernel in ("flash_attention", "decode_attention", "matmul"):
        cfg, _ = svc.resolve_config(kernel, ((1,),))
        assert cfg.get("impl", "pallas") == "pallas"
    assert svc.stats["build_failed"] == 0


def test_greedy_without_service_matches_with(model):
    _, tcfg, _, params = model
    toks = torch.from_numpy(_prompt(3, 5, tcfg.vocab_size, seed=3)).long()
    a = greedy_decode(params, tcfg, toks, steps=5, max_len=12)
    b = greedy_decode(params, tcfg, toks, steps=5, max_len=12, service=DispatchService())
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_prefill_cache_agrees_with_forward(model):
    """Next-step decode from the filled cache == forward on the extended
    sequence (the JAX suite's test_prefill_cache_agrees_with_forward)."""
    _, tcfg, _, params = model
    svc = DispatchService()
    toks = torch.from_numpy(_prompt(1, 8, tcfg.vocab_size, seed=4)).long()
    logits, cache = prefill(params, {"tokens": toks}, tcfg, max_len=12, service=svc)
    serve = make_serve_step(tcfg, service=svc)
    nxt = torch.argmax(logits[:, -1, :], -1)[:, None]
    _, step_logits, _ = serve(params, cache, nxt, 8)
    ext, _ = forward(params, {"tokens": torch.cat([toks, nxt], dim=1)}, tcfg)
    np.testing.assert_allclose(step_logits.numpy(), ext[:, -1].numpy(), **F32TOL)


def test_decode_step_updates_cache_in_place(model):
    _, tcfg, _, params = model
    cache = init_cache(tcfg, 2, 8)
    k_before = cache["layers"]["k"]
    tok = torch.tensor([[3], [4]])
    _, out = decode_step(params, cache, tok, torch.tensor([2, 5]), tcfg)
    assert out is cache and out["layers"]["k"] is k_before
    written = k_before.abs().sum(dim=(0, 3, 4))          # (B, S)
    assert written[0, 2] > 0 and written[1, 5] > 0
    assert written.count_nonzero() == 2


def test_paged_decode_matches_per_request_greedy(model):
    """Continuous batching on bucketed views reproduces each request's solo
    greedy_decode tokens exactly (tests/test_serve.py:170)."""
    _, tcfg, _, params = model
    svc = DispatchService()
    prompts = [torch.from_numpy(_prompt(1, n, tcfg.vocab_size, seed=30 + n)).long()
               for n in (5, 3, 9)]
    steps = 5
    pc = PagedKVCache(tcfg, max_batch=4, max_len=16, page_size=8)
    svc.attach_kv_cache(pc)
    base = [greedy_decode(params, tcfg, p, steps=steps, max_len=pc.alloc, service=svc)
            for p in prompts]
    serve = make_serve_step(tcfg, service=svc)
    slots, toks = [0, 2, 3], []
    for slot, p in zip(slots, prompts):
        logits, cache = prefill(params, {"tokens": p}, tcfg, max_len=pc.alloc, service=svc)
        pc.admit(slot, cache, p.shape[1])
        toks.append([int(torch.argmax(logits[0, -1]))])
    assert pc.active_slots() == slots
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
    for got, want in zip(toks, base):
        assert got == want[0].tolist()
    st = svc.telemetry()["kv_cache"]
    assert st["slots_active"] == 3 and st["tokens_resident"] == 5 + 3 + 9 + 3 * (steps - 1)


def test_cache_accounting_matches_reference():
    from repro.serve import cache_bytes as jax_cache_bytes
    from repro.serve import cache_bytes_per_token as jax_per_token

    for arch in ("qwen2-0.5b", "deepseek-v2-236b", "mamba2-780m", "zamba2-1.2b"):
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        assert cache_bytes_per_token(cfg) == jax_per_token(jcfg)
        assert cache_bytes(cfg, 3, 100, page_size=64) == jax_cache_bytes(jcfg, 3, 100,
                                                                         page_size=64)


def test_configs_match_reference():
    from repro.configs import ARCHS as JAX_ARCHS
    from repro_torch.configs import ARCHS

    assert ARCHS == JAX_ARCHS
    for arch in ARCHS:
        a, b = dataclasses.asdict(get_config(arch)), dataclasses.asdict(jax_get_config(arch))
        assert str(a.pop("dtype")) == "torch.bfloat16" and b.pop("dtype") is not None
        assert a == b
        assert get_config(arch).param_count() == jax_get_config(arch).param_count()


def test_other_families_raise_not_implemented():
    for arch in ("mixtral-8x7b", "mamba2-780m", "whisper-large-v3"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            init_params(get_reduced(arch), torch.Generator().manual_seed(0))


def test_launch_serve_on_cpu(capsys):
    for w in (flash_attention, decode_attention, tiled_matmul):
        w.launches = 0
    assert serve_cli.main(["--device", "cpu", "--reduced", "--batch", "2",
                           "--prompt-len", "6", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "cache=" in out and "ms/step" in out and "tok/s" in out
    # flash, decode and four matmul signatures (the output projection and the
    # unembed, at the prompt's rows and at the batch's)
    assert '"store_default": 6' in out and '"build_failed": 0' in out
    # the plain versions ran: no kernel launched on the CPU
    assert flash_attention.launches == decode_attention.launches == tiled_matmul.launches == 0


def test_launch_serve_needs_a_card_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        serve_cli.main(["--reduced", "--gen", "1"])
