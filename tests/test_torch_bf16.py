"""The catalog in its own dtype: the reduced qwen2-0.5b, mixtral-8x7b,
mamba2-780m and qwen2-vl-7b served in bf16 (every config's dtype) on the
CPU, against the JAX package's bf16 forward and its f32 one; the tiled
matmul's plain version in bf16 against the Pallas kernel in interpret
mode; and the feasibility rule's and the cost model's bf16 routes.

Both packages take the JAX package's f32 weights rounded to bf16: the
weight matrices in bf16, norms, biases and the router in f32 (the JAX
package's own bf16 init gives each leaf's dtype). bf16 rounds at other
places in the two frameworks, so the logits are held relative to the f32
reference's largest |logit|: the port against the reference within
``TOL[family]``, and each of them against the f32 reference within the
same (measured on these inputs: 0.8-1.0% between the packages, 1.2-1.4%
against f32; mamba2's SSD in bf16 1.7% and 2.7-3.4%). Greedy tokens may
flip at near-ties, so they are held equal up to the first step whose top-2
margin in the reference's logits falls under that tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.kernels.matmul import tiled_matmul as jax_tiled_matmul
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.serve import greedy_decode as jax_greedy_decode
from repro_torch.configs import get_reduced
from repro_torch.dispatch import DispatchService
from repro_torch.kernels.matmul import tiled_matmul, tiled_matmul_plain
from repro_torch.models import decode_step, forward
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import greedy_decode, prefill

ARCHS = ("qwen2-0.5b", "mixtral-8x7b", "mamba2-780m", "qwen2-vl-7b")
# of the f32 reference's largest |logit|: about twice the largest distance
# measured between any two of the port's bf16, the reference's bf16 and the
# reference's f32 logits on these inputs
TOL = {"dense": 0.03, "moe": 0.03, "vlm": 0.03, "ssm": 0.06}
MATMUL_TOL = dict(atol=3e-2, rtol=3e-2)          # tests/test_kernels.py:30
MATMUL_NOPACK_TOL = dict(atol=1e-1, rtol=1e-1)   # tests/test_kernels.py:57
B, S, STEPS = 2, 16, 8


def _tokens(vocab: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, S), dtype=np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, the reference's bf16 config, the port's, the reference's bf16
    params, its f32 params, the port's bf16 params, the f32 reference's
    logits on the tokens)."""
    arch = request.param
    jcfg = jax_get_reduced(arch)
    assert jcfg.dtype == jnp.bfloat16 and get_reduced(arch).dtype == torch.bfloat16
    j32 = dataclasses.replace(jcfg, dtype=jnp.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax_init_params, static_argnums=0)(j32, jax.random.PRNGKey(0)))
    dtypes = jax.eval_shape(lambda: jax_init_params(jcfg, jax.random.PRNGKey(0)))
    jp = jax.tree_util.tree_map(lambda v, s: jnp.asarray(v, s.dtype), tree, dtypes)
    tcfg = get_reduced(arch)
    tp = params_from_numpy(tree, dtype=torch.bfloat16, tie_embeddings=tcfg.tie_embeddings)
    tok = _tokens(tcfg.vocab_size)
    want32 = np.asarray(jax_forward(jax.tree_util.tree_map(jnp.asarray, tree),
                                    {"tokens": jnp.asarray(tok)}, j32)[0], np.float32)
    return arch, jcfg, tcfg, jp, tp, tok, want32


def _rel(got, want, scale) -> float:
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max()
                 / scale)


def test_bf16_params_keep_the_references_dtypes(model):
    _, jcfg, _, jp, tp, _, _ = model
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        t = tp
        for k in path:
            t = t[k.key]
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), path


def test_bf16_forward_logits_match_the_reference_and_f32(model):
    arch, jcfg, tcfg, jp, tp, tok, want32 = model
    want = np.asarray(jax_forward(jp, {"tokens": jnp.asarray(tok)}, jcfg)[0], np.float32)
    got, _ = forward(tp, {"tokens": torch.from_numpy(tok).long()}, tcfg)
    assert got.dtype == torch.float32 and got.shape == want32.shape
    scale, tol = float(np.abs(want32).max()), TOL[tcfg.family]
    assert np.isfinite(got.numpy()).all()
    assert _rel(got, want, scale) <= tol, arch
    assert _rel(got, want32, scale) <= tol, arch
    assert _rel(want, want32, scale) <= tol, arch


def test_bf16_prefill_and_teacher_forced_decode_match_forward(model):
    """The first half of the tokens through ``prefill``, the rest one at a
    time through ``decode_step`` on the bf16 cache: each step's logits
    against the forward's at that position (MoE at a capacity that drops
    no token, where the forward and a step's one token a row agree)."""
    arch, _, tcfg, _, tp, tok, want32 = model
    cfg = dataclasses.replace(tcfg, capacity_factor=8.0) if tcfg.family == "moe" else tcfg
    toks = torch.from_numpy(tok).long()
    whole, _ = forward(tp, {"tokens": toks}, cfg)
    P = S // 2
    logits, cache = prefill(tp, {"tokens": toks[:, :P]}, cfg, max_len=S)
    if "layers" in cache and "k" in cache["layers"]:
        assert cache["layers"]["k"].dtype == torch.bfloat16
    steps = [logits[:, -1]]
    for t in range(P, S - 1):
        lg, cache = decode_step(tp, cache, toks[:, t:t + 1], t, cfg)
        steps.append(lg)
    got = torch.stack(steps, 1)
    assert _rel(got, whole[:, P - 1:S - 1], float(np.abs(want32).max())) <= TOL[tcfg.family]


def test_bf16_greedy_tokens_match_the_reference_up_to_a_near_tie(model):
    """Greedy tokens through a dispatch service (the plain versions on the
    CPU) equal the reference's up to the first step whose top-2 margin in
    the reference's teacher-forced bf16 logits is under the tolerance;
    every step before it agrees."""
    arch, jcfg, tcfg, jp, tp, tok, want32 = model
    prompt = tok[:, :S // 2]
    want = np.asarray(jax_greedy_decode(jp, jcfg, jnp.asarray(prompt), STEPS, S))
    svc = DispatchService()
    got = greedy_decode(tp, tcfg, torch.from_numpy(prompt).long(), STEPS, S,
                        service=svc).numpy()
    assert svc.stats["build_failed"] == 0
    seq = np.concatenate([prompt, want], axis=1)
    lg = np.asarray(jax_forward(jp, {"tokens": jnp.asarray(seq)}, jcfg)[0], np.float32)
    top2 = np.sort(lg[:, S // 2 - 1:S // 2 - 1 + STEPS], axis=-1)[..., -2:]
    margin = (top2[..., 1] - top2[..., 0]).min(axis=0)          # (STEPS,)
    scale = float(np.abs(want32).max())
    checked = 0
    for i in range(STEPS):
        if margin[i] < TOL[tcfg.family] * scale:
            break
        np.testing.assert_array_equal(got[:, i], want[:, i], err_msg=f"{arch} step {i}")
        checked += 1
    assert checked >= 1 or margin[0] < TOL[tcfg.family] * scale


@pytest.mark.parametrize("pack", [True, False], ids=["pack", "nopack"])
@pytest.mark.parametrize("shape", [(64, 96, 48), (100, 130, 70)], ids=["aligned", "ragged"])
def test_tiled_matmul_plain_in_bf16_matches_the_pallas_kernel(shape, pack):
    M, K, N = shape
    rng = np.random.default_rng(3)
    a = rng.standard_normal((M, K), dtype=np.float32)
    b = rng.standard_normal((K, N), dtype=np.float32)
    want = jax_tiled_matmul(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
                            bm=32, bn=32, bk=16, pack=pack, interpret=True)
    at, bt = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
    got = tiled_matmul(at, bt, bm=32, bn=32, bk=16, pack=pack)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, tiled_matmul_plain(at, bt, bk=16, pack=pack,
                                                       out_dtype=torch.bfloat16),
                               atol=0, rtol=0)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(MATMUL_TOL if pack else MATMUL_NOPACK_TOL))


# ---------------------------------------------------------------------------
# the bf16 routes of the cost model, the feasibility rules and the tuner
# ---------------------------------------------------------------------------


def test_the_cost_model_runs_bf16_past_8_rows_on_the_tensor_cores():
    from repro_torch.kernels import cost
    from repro_torch.kernels.problems import make_cost_evaluator

    cfg = dict(bm=64, bn=64, bk=24, pack=True)
    t32, i32 = cost.matmul_cost(cfg, 512, 4096, 4096)
    t16, i16 = cost.matmul_cost(cfg, 512, 4096, 4096, dtype=torch.bfloat16)
    assert (i32["peak"], i16["peak"]) == (cost.TF32X3_FLOPS, cost.BF16_FLOPS)
    assert i16["compulsory_bytes"] * 2 == i32["compulsory_bytes"] and t16 < t32
    # the chunk of 24 pads to the mma's k: 32 for bf16, 24 (a multiple of 8) for f32
    chunks = -(-4096 // 24)
    assert i32["padded_work"] == 2.0 * 512 * 4096 * chunks * 24
    assert i16["padded_work"] == 2.0 * 512 * 4096 * chunks * 32
    # 8-row tiles: the FFMA loop either way, bf16 reading half the bytes
    d32, d16 = (cost.matmul_cost(dict(cfg, bm=4), 4, 896, 151936, dtype=dt)[1]
                for dt in (torch.float32, torch.bfloat16))
    assert d32["peak"] == d16["peak"] == cost.FFMA_FLOPS
    assert d16["hbm_bytes"] == pytest.approx(d32["hbm_bytes"] / 2)
    # kernel_cost and rung 0 hand the dtype on; the other kernels take none
    assert cost.kernel_cost("matmul", cfg, 512, 4096, 4096, dtype=torch.bfloat16)[0] == t16
    assert make_cost_evaluator("matmul", (512, 4096, 4096),
                               dtype=torch.bfloat16)(cfg).objective == t16
    assert make_cost_evaluator("matmul", (512, 4096, 4096))(cfg).objective == t32
    syr = cost.kernel_cost("syr2k", {}, 240, 200)
    assert cost.kernel_cost("syr2k", {}, 240, 200, dtype=torch.bfloat16) == syr


def _fake_matmul_smem(f32: int, bf16: int):
    def fake(bm, bn, bk, dtype=torch.float32, limit=None):
        return bf16 if dtype == torch.bfloat16 else f32
    return fake


@pytest.mark.parametrize("f32,bf16,dtype,ok", [
    (300_000, 120_000, None, True), (120_000, 300_000, None, True),
    (300_000, 250_000, None, False), (-1, -1, None, False),
    (300_000, 120_000, torch.bfloat16, True), (300_000, 120_000, torch.float32, False),
    (120_000, 300_000, torch.bfloat16, False)])
def test_the_matmuls_smem_rule_takes_the_smaller_dtype(monkeypatch, f32, bf16, dtype, ok):
    """A signature carries no dtype: the model matmul is asked for both
    (card-only numbers mocked), and refused only where neither fits; a
    caller that knows the dtype is answered for it alone."""
    from repro_torch.analyze import feasibility as feas
    from repro_torch.kernels import matmul

    monkeypatch.setattr(feas, "smem_limit", lambda: 232_448)
    monkeypatch.setattr(matmul, "matmul_smem_bytes", _fake_matmul_smem(f32, bf16))
    v = feas.check_config("matmul", dict(bm=64, bn=64, bk=32), dims=(512, 896, 896),
                          target="gpu", dtype=dtype)
    assert v.ok == ok
    codes = {f.code for f in v.errors}
    assert codes == (set() if ok else {"smem_unsupported" if f32 < 0 else "smem_overflow"})


@pytest.mark.parametrize("dtype,pads", [(torch.bfloat16, 32), (torch.float32, None),
                                        (None, None)])
def test_the_model_matmuls_hopper_warnings_read_the_calls_dtype(dtype, pads):
    """A chunk of 24 pads to 32 on bf16's mma k of 16 and is whole on f32's
    8; where the dtype is unknown the rule reports the smaller padding."""
    from repro_torch.analyze import feasibility as feas

    v = feas.check_config("matmul", dict(bm=64, bn=64, bk=24), dims=(512, 896, 896),
                          target="gpu", dtype=dtype)
    found = [f for f in v.warnings if f.code == "tile_misaligned:bk"]
    assert v.ok and [f"pads to {pads}" in f.message for f in found] == ([True] if pads else [])
    # mm3's f32 products keep the TF32 k of 8: a chunk of 24 is whole
    v = feas.check_config("mm3", dict(bm=64, bn=64, bk=24), dims=(800, 900, 1000, 1100, 1200),
                          target="gpu")
    assert not [f for f in v.warnings if f.code == "tile_misaligned:bk"]


@pytest.mark.parametrize("dtype,ratio", [(torch.bfloat16, 4.0), (torch.float32, 2.0),
                                         (None, 2.0)])
def test_the_model_matmuls_padding_waste_reads_the_calls_dtype(dtype, ratio):
    """A chunk of 4 pads to 16 in bf16 (4x the work) and to 8 in f32 (2x);
    where the dtype is unknown the rule reports the smaller waste."""
    from repro_torch.analyze import feasibility as feas
    from repro_torch.kernels import cost

    cfg, dims = dict(bm=64, bn=64, bk=4), (512, 896, 896)
    _, info = cost.matmul_cost(cfg, *dims, dtype=dtype)
    assert info["padded_work"] / info["flops"] == pytest.approx(4.0 if dtype is torch.bfloat16
                                                                else 2.0)
    (f,) = [f for f in feas.check_config("matmul", cfg, dims=dims, target="cost",
                                         dtype=dtype).warnings if f.code == "padding_waste"]
    assert f"{ratio:.2f}x" in f.message


def test_a_bf16_calls_background_campaign_screens_and_times_in_bf16(tmp_path, monkeypatch):
    """The background tuner's campaign on a bf16 call times bf16 copies of
    the call's tensors, and its cost rung screens in the bf16 layout."""
    from repro_torch.dispatch import BackgroundTuner, DispatchService, TuningStore
    from repro_torch.dispatch import registry
    from repro_torch.kernels import problems

    screened, timed = [], []
    make = problems.make_cost_evaluator

    def recording(kernel, dims=None, dtype=None):
        screened.append(dtype)
        return make(kernel, dims, dtype=dtype)

    monkeypatch.setattr(problems, "make_cost_evaluator", recording)
    registry.registered()   # the built-ins, before the registry is swapped
    monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))
    spec = registry.get("matmul")
    builder = spec.builder

    def seeing(cfg, **kw):
        fn = builder(cfg, **kw)

        def run(a, b):
            timed.append((a.dtype, b.dtype))
            return fn(a, b)
        return run

    registry._REGISTRY["matmul"] = dataclasses.replace(spec, builder=seeing)
    store = TuningStore(str(tmp_path / "store"))
    tuner = BackgroundTuner(store, max_workers=1, max_evals=4, n_initial=2, cascade=True,
                            cascade_budgets=(6, 2))
    svc = DispatchService(store, backend="cpu", target="host", tuner=tuner)
    try:
        rng = np.random.default_rng(5)
        a, b = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).bfloat16()
                for s in ((16, 96), (96, 64)))
        out = svc.call("matmul", a, b)
        (rec,) = tuner.drain()
        assert tuner.errors == [] and rec is not None and out.dtype == torch.bfloat16
        assert screened == [torch.bfloat16]
        assert timed and set(timed) == {(torch.bfloat16, torch.bfloat16)}
    finally:
        tuner.shutdown()
