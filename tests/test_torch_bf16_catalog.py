"""The rest of the catalog in its own dtype: the reduced deepseek-v2-236b,
zamba2-1.2b, whisper-large-v3, gemma3-1b, minitron-4b and qwen1.5-0.5b
served in bf16 on the CPU, against the JAX package's bf16 forward and its
f32 one (``tests/test_torch_bf16.py`` holds the other four configs). This
file holds deepseek-v2 and whisper and the tests' bodies;
``tests/test_torch_bf16_catalog_gqa.py`` runs them on the four GQA configs
(zamba2's shared block, gemma3, minitron, qwen1.5) and pins gemma's scale.

Both packages take the JAX package's f32 weights rounded to bf16, as in
``tests/test_torch_bf16.py``; whisper takes the same numpy frames in both.
The logits are held relative to the f32 reference's largest |logit|, at
``TOL[family]`` (measured on these inputs, port against reference bf16 /
reference bf16 against f32 / port against f32: gemma3 0.53 / 0.52 / 0.53%,
minitron 0.77 / 1.24 / 1.15%, qwen1.5 0.88 / 1.31 / 1.24%, whisper
1.98 / 2.01 / 1.53%, zamba2 4.79 / 4.73 / 3.77%, deepseek with its routing
pinned 1.70 / 2.84 / 2.35%; ``python tests/test_torch_bf16_catalog.py``
prints them).

DeepSeek-V2's routed experts make a bf16 rounding decide which experts a
token takes where the router's k-th and (k+1)-th probabilities nearly tie:
unpinned, the port's bf16 forward is 9-11% off at two positions of eight
experts' reduced router. ``test_deepseek_*`` show that every such position
is a near-tie (a token whose routing differs from the reference's, at a
gap under twice the bf16 noise on a router probability, or a later
position of its row, which attends to it through a later layer) and that
with the router's
choices pinned to the reference's the port agrees everywhere.

Greedy tokens are held up to a near-tie of the top two logits, and the
teacher-forced argmax of every prompt position whose top-2 margin clears
the tolerance is held equal (at least ``ARGMAX_SHARE`` of the positions)."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.blocks as jax_blocks
import repro_torch.models.moe as moe
from repro.configs import get_reduced as jax_get_reduced
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.serve import greedy_decode as jax_greedy_decode
from repro_torch.configs import get_reduced
from repro_torch.dispatch import DispatchService
from repro_torch.models import decode_step, forward
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import greedy_decode, prefill

ARCHS = ("deepseek-v2-236b", "whisper-large-v3")  # the other four: test_torch_bf16_catalog_gqa.py
# of the f32 reference's largest |logit|: dense and moe as tests/test_torch_bf16.py
# (about twice the largest distance measured between any two of the port's bf16, the
# reference's bf16 and f32 logits); hybrid about 1.7 times zamba2's 4.79% (its SSD and
# shared block in bf16: the reference's own bf16 is 4.73% off its f32); audio about
# twice whisper's 2.0%
TOL = {"dense": 0.03, "moe": 0.03, "hybrid": 0.08, "audio": 0.04}
# the least share of the B x S prompt positions the teacher-forced argmax
# comparison must reach (measured on these inputs: 13 of 32 for zamba2 at its
# 8%, 22-30 of 32 for the others)
ARGMAX_SHARE = 0.25
B, S, STEPS = 2, 16, 8


def _tokens(vocab: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, S), dtype=np.int32)


def _frames(cfg, seed: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_len, cfg.d_model), dtype=np.float32)


def _rel(got, want, scale) -> float:
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max()
                 / scale)


_MODELS: dict = {}


def _build(arch: str, **changes) -> dict:
    """A dict: arch, the reference's bf16 and f32 configs and params, the
    port's bf16 config and params, the tokens (and whisper's frames) as
    numpy, and the f32 and bf16 references' logits on them (built once for
    the reduced config with ``changes``)."""
    key = (arch, *sorted(changes.items()))
    if key in _MODELS:
        return _MODELS[key]
    jcfg = dataclasses.replace(jax_get_reduced(arch), **changes)
    tcfg = dataclasses.replace(get_reduced(arch), **changes)
    assert jcfg.dtype == jnp.bfloat16 and tcfg.dtype == torch.bfloat16
    j32 = dataclasses.replace(jcfg, dtype=jnp.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax_init_params, static_argnums=0)(j32, jax.random.PRNGKey(0)))
    dtypes = jax.eval_shape(lambda: jax_init_params(jcfg, jax.random.PRNGKey(0)))
    jp = jax.tree_util.tree_map(lambda v, s: jnp.asarray(v, s.dtype), tree, dtypes)
    j32p = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_numpy(tree, dtype=torch.bfloat16, tie_embeddings=tcfg.tie_embeddings)
    tok = _tokens(tcfg.vocab_size)
    extra = {"enc_embed": _frames(tcfg)} if tcfg.family == "audio" else {}
    m = dict(arch=arch, jcfg=jcfg, j32=j32, jp=jp, j32p=j32p, tcfg=tcfg, tp=tp, tok=tok,
             extra=extra)
    m["want32"] = np.asarray(jax_forward(j32p, _jbatch(m, tok), j32)[0], np.float32)
    m["want16"] = np.asarray(jax_forward(jp, _jbatch(m, tok), jcfg)[0], np.float32)
    m["scale"] = float(np.abs(m["want32"]).max())
    _MODELS[key] = m
    return m


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _build(request.param)


def _jbatch(m, tok) -> dict:
    return {"tokens": jnp.asarray(tok), **{k: jnp.asarray(v) for k, v in m["extra"].items()}}


def _tbatch(m, tok) -> dict:
    return {"tokens": torch.from_numpy(np.asarray(tok)).long(),
            **{k: torch.from_numpy(v) for k, v in m["extra"].items()}}


def test_bf16_params_keep_the_references_dtypes(model):
    flat = jax.tree_util.tree_flatten_with_path(model["jp"])[0]
    for path, leaf in flat:
        t = model["tp"]
        for k in path:
            t = t[k.key]
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), path


# ---------------------------------------------------------------------------
# the router's choices: recorded in both packages, pinned in the port
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _port_routing(monkeypatch, record: list | None = None, pin: list | None = None):
    """Record each port ``moe_ffn`` call's router probabilities and choices
    as (T, E) and (T, k) numpy arrays in ``record``; with ``pin``, a list
    of (T, k) choices, route each call by the next one instead of its own
    top k (the gates are the call's own probabilities of those experts)."""
    queue = list(pin) if pin is not None else None
    orig = moe._topk

    def topk(probs, k):
        if queue is None:
            vals, idx = orig(probs, k)
        else:
            idx = torch.as_tensor(queue.pop(0)).reshape(*probs.shape[:-1], k)
            vals = probs.gather(-1, idx)
        if record is not None:
            record.append((probs.reshape(-1, probs.shape[-1]).float().numpy(),
                           idx.reshape(-1, k).numpy()))
        return vals, idx

    with monkeypatch.context() as mp:
        mp.setattr(moe, "_topk", topk)
        yield
    assert not queue, "pinned choices left over"


def _reference_router(params, cfg, batch) -> list:
    """The JAX package's router probabilities, (T, E) per MoE layer, from
    its forward run op by op (``jax.disable_jit``) with ``moe_ffn`` wrapped."""
    out = []
    orig = jax_blocks.moe_ffn

    def recording(p, x, **kw):
        logits = x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ p["router"]
        out.append(np.asarray(jax.nn.softmax(logits, axis=-1)))
        return orig(p, x, **kw)

    jax_blocks.moe_ffn = recording
    try:
        with jax.disable_jit():
            jax_forward(params, batch, cfg)
    finally:
        jax_blocks.moe_ffn = orig
    return out


def _top(probs: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(the top k experts of each token, sorted; the gap between the k-th
    and (k+1)-th probability)."""
    order = np.argsort(-probs, axis=-1, kind="stable")
    srt = np.take_along_axis(probs, order, axis=-1)
    return np.sort(order[:, :k], axis=-1), srt[:, k - 1] - srt[:, k]


@pytest.fixture(scope="module")
def deepseek():
    """The reduced deepseek's routing evidence: the reference's f32 router
    probabilities per MoE layer, the bf16 noise on a router probability (the
    largest shift between the reference's bf16 and f32 routers over the
    tokens and experts), and the near-tie threshold, twice that noise (a
    gap wider than the two probabilities' shifts together cannot flip)."""
    m = _build("deepseek-v2-236b")
    batch = _jbatch(m, m["tok"])
    p32 = _reference_router(m["j32p"], m["j32"], batch)
    p16 = _reference_router(m["jp"], m["jcfg"], batch)
    assert len(p32) == len(p16) == m["jcfg"].n_layers - m["jcfg"].first_dense_layers
    noise = max(float(np.abs(a - b).max()) for a, b in zip(p16, p32))
    return dict(m, p32=p32, noise=noise, tie=2.0 * noise, k=m["jcfg"].top_k)


def _named_near_ties(moved: list) -> np.ndarray:
    """(B, S): the positions a routing near-tie reaches, from each MoE
    layer's flipped tokens (B * S,) in order: each flipped token's own and,
    below a layer that is not the last, every later position of its row
    (the later layers' attention carries the token's residual stream
    forward)."""
    named = np.zeros((B, S), bool)
    for i, m in enumerate(moved):
        m = m.reshape(B, S)
        named |= m if i == len(moved) - 1 else np.maximum.accumulate(m, axis=1)
    return named


def test_deepseek_bf16_forward_is_off_only_at_routing_near_ties(deepseek, monkeypatch):
    """Every position where the port's bf16 logits leave the tolerance
    (against the reference's bf16 or f32) is a named near-tie: at some MoE
    layer a token of its row, at or before it, takes other experts than the
    reference's f32 router chooses, at a gap under the threshold. And
    there is at least one such flip on these inputs (the pin below shows
    what it costs)."""
    model = deepseek
    k, tie = deepseek["k"], deepseek["tie"]
    rec: list = []
    with _port_routing(monkeypatch, record=rec):
        got, _ = forward(model["tp"], _tbatch(model, model["tok"]), model["tcfg"])
    moved = []
    for (_, idx), p32 in zip(rec, deepseek["p32"]):
        want, gap = _top(p32, k)
        moved.append((np.sort(idx, axis=-1) != want).any(-1))
        assert (gap[moved[-1]] < tie).all(), (np.nonzero(moved[-1])[0], gap[moved[-1]], tie)
    named = _named_near_ties(moved)
    sc = model["scale"]
    for want in (model["want16"], model["want32"]):
        err = np.abs(got.numpy() - want).max(-1) / sc                  # (B, S)
        past = err > TOL["moe"]
        assert not (past & ~named).any(), (np.argwhere(past & ~named), err)
    assert np.any(moved) and deepseek["noise"] < 0.01


def test_deepseek_bf16_forward_with_the_references_routing_matches_everywhere(
        deepseek, monkeypatch):
    """With each MoE layer's choices pinned to the reference's f32 router's,
    the port's bf16 forward is within the tolerance of the reference's bf16
    and f32 logits at every position: the rest of the bf16 path (MLA, the
    experts' products, the shared experts, the capacity drops) agrees."""
    model = deepseek
    k = deepseek["k"]
    pin = [_top(p32, k)[0] for p32 in deepseek["p32"]]
    with _port_routing(monkeypatch, pin=pin):
        got, _ = forward(model["tp"], _tbatch(model, model["tok"]), model["tcfg"])
    sc = model["scale"]
    assert _rel(got, model["want16"], sc) <= TOL["moe"]
    assert _rel(got, model["want32"], sc) <= TOL["moe"]


def test_bf16_forward_logits_match_the_reference_and_f32(model, request, monkeypatch):
    """Every position within the tolerance, for deepseek outside the named
    routing near-ties (the two tests above)."""
    tcfg, sc, tol = model["tcfg"], model["scale"], TOL[model["tcfg"].family]
    rec: list = []
    with _port_routing(monkeypatch, record=rec):
        got, _ = forward(model["tp"], _tbatch(model, model["tok"]), tcfg)
    assert got.dtype == torch.float32 and got.shape == model["want32"].shape
    assert np.isfinite(got.numpy()).all()
    keep = np.ones((B, S), bool)
    if tcfg.family == "moe":
        deepseek = request.getfixturevalue("deepseek")
        keep = ~_named_near_ties([(np.sort(idx, axis=-1) != _top(p32, deepseek["k"])[0]).any(-1)
                                  for (_, idx), p32 in zip(rec, deepseek["p32"])])
        assert keep.mean() >= 0.5
    g = got.numpy()[keep]
    assert _rel(g, model["want16"][keep], sc) <= tol, model["arch"]
    assert _rel(g, model["want32"][keep], sc) <= tol, model["arch"]
    assert _rel(model["want16"][keep], model["want32"][keep], sc) <= tol, model["arch"]


# ---------------------------------------------------------------------------
# decode, greedy tokens, the teacher-forced argmax
# ---------------------------------------------------------------------------


def _decode_against_forward(m, cfg):
    """The first half of the tokens through ``prefill``, the rest one at a
    time through ``decode_step`` on the bf16 cache: (each step's logits
    stacked (B, S/2, V), the forward's at those positions)."""
    tp, toks = m["tp"], torch.from_numpy(m["tok"]).long()
    extra = {k: torch.from_numpy(v) for k, v in m["extra"].items()}
    whole, _ = forward(tp, {"tokens": toks, **extra}, cfg)
    P = S // 2
    logits, cache = prefill(tp, {"tokens": toks[:, :P], **extra}, cfg, max_len=S)
    for entry in ("layers", "dec_layers", "shared_attn"):
        if entry in cache and "k" in cache[entry]:
            assert cache[entry]["k"].dtype == torch.bfloat16
    if "c_kv" in cache.get("layers", {}):   # MLA's latent cache
        assert cache["layers"]["c_kv"].dtype == torch.bfloat16
    steps = [logits[:, -1]]
    for t in range(P, S - 1):
        lg, cache = decode_step(tp, cache, toks[:, t:t + 1], t, cfg)
        steps.append(lg)
    return torch.stack(steps, 1), whole[:, P - 1:S - 1]


def test_bf16_prefill_and_teacher_forced_decode_match_forward(model, monkeypatch):
    """Each decode step's logits against the forward's at that position
    (MoE at a capacity that drops no token, where the forward and a step's
    one token a row agree; its routing pinned to the forward's own choices,
    which a bf16 near-tie moves between the two paths: unpinned, every
    position past the tolerance is such a flip)."""
    tcfg = model["tcfg"]
    tol, sc = TOL[tcfg.family], model["scale"]
    if tcfg.family != "moe":
        got, want = _decode_against_forward(model, tcfg)
        assert _rel(got, want, sc) <= tol, model["arch"]
        return
    cfg = dataclasses.replace(tcfg, capacity_factor=8.0)
    rec: list = []
    with _port_routing(monkeypatch, record=rec):
        got, want = _decode_against_forward(model, cfg)
    n_moe = tcfg.n_layers - tcfg.first_dense_layers
    P = S // 2
    whole = [idx.reshape(B, S, -1) for _, idx in rec[:n_moe]]
    # the calls after the forward: the prefill's forward over P tokens, then
    # one call a layer for each replayed and each decoded position
    later = rec[2 * n_moe:]
    moved = np.zeros((n_moe, B, S), bool)
    for i, (_, idx) in enumerate(later):
        t, layer = divmod(i, n_moe)
        moved[layer, :, t] = (np.sort(idx, -1) != np.sort(whole[layer][:, t], -1)).any(-1)
    err = np.abs((got - want).numpy()).max(-1) / sc                     # (B, S/2)
    named = _named_near_ties([m.reshape(-1) for m in moved])[:, P - 1:S - 1]
    assert not ((err > tol) & ~named).any(), (err, named)
    pin = [w.reshape(B * S, -1) for w in whole] + [w[:, :P].reshape(B * P, -1)
                                                   for w in whole]
    pin += [w[:, t] for t in range(S - 1) for w in whole]
    with _port_routing(monkeypatch, pin=pin):
        got, want = _decode_against_forward(model, cfg)
    assert _rel(got, want, sc) <= tol


def test_bf16_greedy_tokens_match_the_reference_up_to_a_near_tie(model):
    """Greedy tokens through a dispatch service (the plain versions on the
    CPU) equal the reference's up to the first step whose top-2 margin in
    the reference's teacher-forced bf16 logits is under the tolerance. The
    reference's prefill leaves whisper's cross cache zeros (ROADMAP Queue
    3), so whisper's tokens are held against the argmax of the reference's
    forward over the prompt and the port's tokens before each step."""
    tcfg, jcfg, jp = model["tcfg"], model["jcfg"], model["jp"]
    prompt = model["tok"][:, :S // 2]
    svc = DispatchService()
    extra = {k: torch.from_numpy(v) for k, v in model["extra"].items()}
    got = greedy_decode(model["tp"], tcfg, torch.from_numpy(prompt).long(), STEPS, S,
                        service=svc, **extra).numpy()
    assert svc.stats["build_failed"] == 0
    if tcfg.family == "audio":
        seq = np.concatenate([prompt, got[:, :-1]], axis=1)
    else:
        want = np.asarray(jax_greedy_decode(jp, jcfg, jnp.asarray(prompt), STEPS, S))
        seq = np.concatenate([prompt, want[:, :-1]], axis=1)
    lg = np.asarray(jax_forward(jp, _jbatch(model, seq), jcfg)[0], np.float32)
    lg = lg[:, S // 2 - 1:S // 2 - 1 + STEPS]
    if tcfg.family == "audio":
        want = lg.argmax(-1)
    top2 = np.sort(lg, axis=-1)[..., -2:]
    margin = (top2[..., 1] - top2[..., 0]).min(axis=0)          # (STEPS,)
    floor = TOL[tcfg.family] * model["scale"]
    checked = 0
    for i in range(STEPS):
        if margin[i] < floor:
            break
        np.testing.assert_array_equal(got[:, i], want[:, i], err_msg=f"{model['arch']} step {i}")
        checked += 1
    assert checked >= 1 or margin[0] < floor


def test_bf16_teacher_forced_argmax_matches_the_reference(model):
    """The argmax of the port's bf16 forward equals the reference's at
    every prompt position whose top-2 margin in the reference's bf16 logits
    clears the tolerance, and at least ARGMAX_SHARE of the B x S positions
    clear it (the greedy check above may stop at its first step)."""
    tcfg, want = model["tcfg"], model["want16"]
    got, _ = forward(model["tp"], _tbatch(model, model["tok"]), tcfg)
    top2 = np.sort(want, axis=-1)[..., -2:]
    cleared = (top2[..., 1] - top2[..., 0]) > TOL[tcfg.family] * model["scale"]
    assert cleared.sum() >= ARGMAX_SHARE * B * S, (model["arch"], int(cleared.sum()))
    np.testing.assert_array_equal(got.numpy().argmax(-1)[cleared], want.argmax(-1)[cleared],
                                  err_msg=model["arch"])


def _report() -> None:
    """The measurements the tolerances above were set from, on these inputs
    (CPU): each config's distances, the argmax rule's compared positions,
    and deepseek's routing near-ties."""
    import pytest as _pytest

    tols = {**TOL, "vlm": 0.03, "ssm": 0.06}   # tests/test_torch_bf16.py's TOL for those two
    for arch in ("qwen2-0.5b", "mixtral-8x7b", "mamba2-780m", "qwen2-vl-7b") + ARCHS + (
            "zamba2-1.2b", "gemma3-1b", "minitron-4b", "qwen1.5-0.5b"):
        m = _build(arch)
        got = forward(m["tp"], _tbatch(m, m["tok"]), m["tcfg"])[0].numpy()
        sc, tol = m["scale"], tols[m["tcfg"].family]
        top2 = np.sort(m["want16"], axis=-1)[..., -2:]
        cleared = (top2[..., 1] - top2[..., 0]) > tol * sc
        print(f"{arch}: port vs reference bf16 {_rel(got, m['want16'], sc):.2%}, reference bf16 "
              f"vs f32 {_rel(m['want16'], m['want32'], sc):.2%}, port vs f32 "
              f"{_rel(got, m['want32'], sc):.2%}; argmax compared at {int(cleared.sum())} of "
              f"{B * S} positions (margin over {tol:.0%})")
    d = deepseek.__wrapped__()
    mp = _pytest.MonkeyPatch()
    rec: list = []
    with _port_routing(mp, record=rec):
        got = forward(d["tp"], _tbatch(d, d["tok"]), d["tcfg"])[0].numpy()
    err = np.abs(got - d["want16"]).max(-1).reshape(-1) / d["scale"]
    for layer, ((_, idx), p32) in enumerate(zip(rec, d["p32"])):
        want, gap = _top(p32, d["k"])
        for t in np.nonzero((np.sort(idx, axis=-1) != want).any(-1))[0]:
            print(f"deepseek MoE layer {layer + 1}: row {t // S} position {t % S} takes other "
                  f"experts than the reference's f32 router, gap {gap[t]:.2e}; its logits "
                  f"{err[t]:.2%} from the reference's bf16")
    with _port_routing(mp, pin=[_top(p32, d["k"])[0] for p32 in d["p32"]]):
        got = forward(d["tp"], _tbatch(d, d["tok"]), d["tcfg"])[0]
    print(f"deepseek: bf16 noise on a router probability {d['noise']:.2e} (near-tie under "
          f"{d['tie']:.2e}); pinned to the reference's choices: {_rel(got, d['want16'], d['scale']):.2%} "
          f"from its bf16, {_rel(got, d['want32'], d['scale']):.2%} from its f32")


if __name__ == "__main__":
    _report()
