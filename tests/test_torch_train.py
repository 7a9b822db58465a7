"""The port's training stack against the JAX package: ``loss_fn`` and every
gradient leaf (``jax.grad``) for the seven reduced configs the port has,
under each remat policy; AdamW, the LR schedules, the synthetic data and
three train steps (``accum`` 1 and 4) against ``repro``'s; the tied
embedding's gradient and serving copy; and ``launch.train`` on the CPU.
The JAX package's weights are carried over with ``params_from_numpy``; the
norm scales and biases its init leaves at 0 are drawn at random first, so
that their gradients are not trivial."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_reduced as jax_get_reduced
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import loss_fn as jax_loss_fn
from repro.models import init_params as jax_init_params
from repro.train import adamw_init as jax_adamw_init
from repro.train import adamw_update as jax_adamw_update
from repro.train import cosine_lr as jax_cosine_lr
from repro.train import init_train_state as jax_init_train_state
from repro.train import linear_warmup_lr as jax_linear_warmup_lr
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import get_reduced
from repro_torch.data import SyntheticLM, make_batch
from repro_torch.dispatch import DispatchService
from repro_torch.launch import train as train_cli
from repro_torch.models import forward, init_params, loss_fn, tied_unembed, trainable
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import (
    adamw_init,
    adamw_update,
    cosine_lr,
    init_train_state,
    linear_warmup_lr,
    make_train_step,
)
from repro_torch.tree import tree_leaves, tree_unflatten

# the JAX suite's own tolerance for remat gradients (tests/test_train.py)
GRADTOL = dict(atol=1e-5, rtol=1e-3)
ARCHS = ("qwen2-0.5b", "gemma3-1b", "mixtral-8x7b", "deepseek-v2-236b", "mamba2-780m",
         "zamba2-1.2b", "qwen2-vl-7b")
# what the JAX package's init leaves at 0 (or D's 1), drawn at random
RANDOM = ("ln", "ln1", "ln2", "norm", "final_norm", "kv_norm", "q_norm", "k_norm",
          "dt_bias", "D", "conv_b", "bq", "bk", "bv")
SSM_CHUNK = 8


def _randomize(tree: dict, rng) -> dict:
    def draw(k, v):
        if k not in RANDOM:
            return v
        r = 0.1 * rng.standard_normal(v.shape, dtype=np.float32)
        return (1.0 + r) if k == "D" else r

    return {k: _randomize(v, rng) if isinstance(v, dict) else draw(k, v)
            for k, v in tree.items()}


def _setup(arch: str, seed: int = 0):
    """(jax cfg, port cfg, numpy params): f32, norms and biases random."""
    jcfg = dataclasses.replace(jax_get_reduced(arch), dtype=jnp.float32)
    cfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    np_params = _randomize(jax.tree_util.tree_map(np.asarray, jp),
                           np.random.default_rng(seed + 100))
    return jcfg, cfg, np_params


def _port_params(np_params, cfg) -> dict:
    return trainable(params_from_numpy(np_params, tie_embeddings=cfg.tie_embeddings))


def _batch_np(cfg, batch: int = 4, seq: int = 16, seed: int = 0, masked: int = 3) -> dict:
    """A SyntheticLM batch with the last ``masked`` labels of each row -1."""
    b = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed).batch_at(0)
    if masked:
        b["labels"] = b["labels"].copy()
        b["labels"][:, -masked:] = -1
    return b


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


def _jax_batch(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def _port_grads(params: dict, batch: dict, cfg, **kw):
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    total, metrics = loss_fn(tree_unflatten(params, live), batch, cfg, **kw)
    grads = torch.autograd.grad(total, live, materialize_grads=True)
    return total.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _jax_grads(np_params, batch: dict, jcfg, **kw):
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    (total, metrics), grads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, batch, jcfg, **kw), has_aux=True)(jp)
    return total, metrics, jax.tree_util.tree_leaves(grads)


def _close(got, want, tol=GRADTOL):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).detach().float()),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    jcfg, cfg, np_params = _setup(arch)
    b = _batch_np(cfg)
    jt, jm, jg = _jax_grads(np_params, _jax_batch(b), jcfg, ssm_chunk=SSM_CHUNK)
    params = _port_params(np_params, cfg)
    total, metrics, grads = _port_grads(params, _torch_batch(b), cfg, ssm_chunk=SSM_CHUNK)
    _close(total, jt, dict(atol=1e-5, rtol=1e-5))
    _close(metrics["loss"], jm["loss"], dict(atol=1e-5, rtol=1e-5))
    _close(metrics["aux"], jm["aux"], dict(atol=1e-5, rtol=1e-5))
    assert (float(metrics["aux"]) > 0) == (cfg.family == "moe")
    assert len(grads) == len(jg)
    for g, want in zip(grads, jg):
        assert tuple(g.shape) == tuple(want.shape)
        _close(g, want)


@pytest.mark.parametrize("arch,remat", [(a, r) for a in ("qwen2-0.5b", "mamba2-780m")
                                        for r in ("full", "dots")])
def test_remat_matches_reference_and_changes_no_value(arch, remat):
    # the attention stage's body and the Mamba2 body, each under both
    # policies: against the JAX package's remat, and against the port's own
    # un-rematerialised step
    jcfg, cfg, np_params = _setup(arch, seed=1)
    b = _batch_np(cfg, seed=2)
    jt, _, jg = _jax_grads(np_params, _jax_batch(b), jcfg, remat=remat, ssm_chunk=SSM_CHUNK)
    params = _port_params(np_params, cfg)
    tb = _torch_batch(b)
    t0, _, g0 = _port_grads(params, tb, cfg, ssm_chunk=SSM_CHUNK)
    t1, _, g1 = _port_grads(params, tb, cfg, remat=remat, ssm_chunk=SSM_CHUNK)
    np.testing.assert_allclose(float(t1), float(t0), rtol=1e-6)
    _close(t1, jt, dict(atol=1e-5, rtol=1e-5))
    for a, b0, want in zip(g1, g0, jg):
        _close(a, b0.numpy())
        _close(a, want)


def test_unknown_remat_policy_raises():
    cfg = dataclasses.replace(get_reduced("qwen2-0.5b"), dtype=torch.float32)
    params = trainable(init_params(cfg, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="remat"):
        loss_fn(params, _torch_batch(_batch_np(cfg)), cfg, remat="everything")


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def test_dots_policy_keeps_the_products_and_full_recomputes_them():
    cfg = dataclasses.replace(get_reduced("qwen2-0.5b"), dtype=torch.float32)
    params = trainable(init_params(cfg, torch.Generator().manual_seed(0)))
    batch = _torch_batch(_batch_np(cfg))
    counts = {}
    for remat in ("none", "full", "dots"):
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        total, _ = loss_fn(tree_unflatten(params, live), batch, cfg, remat=remat)
        with _CountMM() as mode:
            torch.autograd.grad(total, live)
        counts[remat] = mode.mm
    # under "full" each layer's q, k, v, o, gate and up products run again
    # in the backward (nothing saves the down projection's output, so the
    # recomputation stops before it); "dots" keeps them all
    assert counts["dots"] == counts["none"]
    assert counts["full"] == counts["none"] + 6 * cfg.n_layers


# ---------------------------------------------------------------------------
# the tied embedding
# ---------------------------------------------------------------------------


def test_tied_embedding_gradient_flows_into_embed_and_state_holds_no_copy():
    jcfg, cfg, np_params = _setup("qwen2-0.5b")
    b = _batch_np(cfg)
    _, _, jg = _jax_grads(np_params, _jax_batch(b), jcfg)
    full = params_from_numpy(np_params)
    assert "embed_t" in full
    params = trainable(full)
    assert "embed_t" not in params
    _, _, grads = _port_grads(params, _torch_batch(b), cfg)
    keys = sorted(params)  # the leaves of the top level come in sorted order
    _close(grads[keys.index("embed")], jg[keys.index("embed")])
    state = init_train_state(params)
    assert "embed_t" not in state["m"] and "embed_t" not in state["v"]
    with pytest.raises(ValueError, match="embed_t"):
        init_train_state(full)
    with pytest.raises(ValueError, match="embed_t"):
        make_train_step(cfg)(full, state, _torch_batch(b))


def test_a_stale_tied_copy_cannot_be_served():
    cfg = dataclasses.replace(get_reduced("qwen2-0.5b"), dtype=torch.float32)
    served = init_params(cfg, torch.Generator().manual_seed(0))
    params = trainable(served)  # the same tensors: training updates them in place
    opt = init_train_state(params)
    batch = _torch_batch(_batch_np(cfg))
    make_train_step(cfg, lr=1e-2)(params, opt, batch)
    svc = DispatchService(backend="cpu", target="host")
    tokens = {"tokens": batch["tokens"]}
    with pytest.raises(ValueError, match="stale"):
        forward(served, tokens, cfg, service=svc)
    fresh = tied_unembed(served)
    assert fresh["embed"] is params["embed"]
    assert torch.equal(fresh["embed_t"], params["embed"].T)
    want, _ = forward(params, tokens, cfg)
    got, _ = forward(fresh, tokens, cfg, service=svc)
    _close(got, want.numpy(), dict(atol=1e-5, rtol=1e-5))
    assert tied_unembed(fresh) is fresh


# ---------------------------------------------------------------------------
# AdamW, schedules, data
# ---------------------------------------------------------------------------


def _opt_tree(rng):
    """1-D leaves, 2-D matrices and stacked (L, d) norms and biases."""
    return {"b": rng.standard_normal(5, dtype=np.float32),
            "w": rng.standard_normal((4, 3), dtype=np.float32),
            "layers": {"ln1": rng.standard_normal((2, 5), dtype=np.float32),
                       "bq": rng.standard_normal((2, 3), dtype=np.float32),
                       "wq": rng.standard_normal((2, 5, 3), dtype=np.float32)}}


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moment):
    rng = np.random.default_rng(0)
    p_np = _opt_tree(rng)
    jdt, tdt = getattr(jnp, moment), getattr(torch, moment)
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    js = jax_adamw_init(jp, jdt)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), p_np)
    ts = adamw_init(tp, tdt)
    for i in range(3):
        g_np = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape, dtype=np.float32), p_np)
        jp, js = jax_adamw_update(jax.tree_util.tree_map(jnp.asarray, g_np), js, jp, lr=1e-2)
        out_p, out_s = adamw_update(jax.tree_util.tree_map(torch.from_numpy, g_np), ts, tp,
                                    lr=1e-2)
        assert out_p is tp and out_s is ts  # in place
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == int(js["step"]) == 3
    for a, want in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        _close(a, want, dict(atol=1e-6, rtol=1e-6))
    for key in ("m", "v"):
        for a, want in zip(tree_leaves(ts[key]), jax.tree_util.tree_leaves(js[key])):
            assert a.dtype == tdt
            _close(a, np.asarray(want, np.float32), dict(atol=1e-6, rtol=1e-2 if
                                                         moment == "bfloat16" else 1e-6))


def test_adamw_decays_by_rank_not_by_name():
    # a zero gradient leaves only the decay: every leaf of rank >= 2, the
    # stacked norm scales and biases included, shrinks by lr * wd; 1-D ones stay
    rng = np.random.default_rng(1)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), _opt_tree(rng))
    before = {id(t): t.clone() for t in tree_leaves(tp)}
    grads = jax.tree_util.tree_map(torch.zeros_like, tp)
    adamw_update(grads, adamw_init(tp), tp, lr=0.5, weight_decay=0.1)
    for t in tree_leaves(tp):
        factor = 1 - 0.5 * 0.1 if t.ndim >= 2 else 1.0
        torch.testing.assert_close(t, before[id(t)] * factor, rtol=1e-6, atol=0)


def test_lr_schedules_match_reference():
    for s in range(100):
        np.testing.assert_allclose(linear_warmup_lr(s, peak=3e-3, warmup=10),
                                   float(jax_linear_warmup_lr(s, peak=3e-3, warmup=10)),
                                   rtol=1e-6)
        np.testing.assert_allclose(cosine_lr(s, peak=3e-3, warmup=10, total=100),
                                   float(jax_cosine_lr(s, peak=3e-3, warmup=10, total=100)),
                                   rtol=1e-6)


def test_synthetic_batches_equal_reference():
    for seed, step in ((0, 0), (42, 7), (3, 1000)):
        want = JaxSyntheticLM(1000, 32, 4, seed=seed, mean_doc_len=8).batch_at(step)
        stream = SyntheticLM(1000, 32, 4, seed=seed, mean_doc_len=8)
        got = stream.batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
        t = make_batch(stream, step)
        for k in ("tokens", "labels"):
            assert t[k].dtype == torch.int64 and t[k].device.type == "cpu"
            np.testing.assert_array_equal(t[k].numpy(), want[k])


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,accum", [("qwen2-0.5b", 1), ("qwen2-0.5b", 4),
                                        ("mixtral-8x7b", 1), ("mixtral-8x7b", 4)])
def test_three_train_steps_match_reference(arch, accum):
    jcfg, cfg, np_params = _setup(arch, seed=3)
    stream = SyntheticLM(cfg.vocab_size, 16, 8, seed=4)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    js = jax_init_train_state(jp)
    jstep = jax.jit(jax_make_train_step(jcfg, lr=1e-3, accum=accum))
    params = _port_params(np_params, cfg)
    opt = init_train_state(params)
    step = make_train_step(cfg, lr=1e-3, accum=accum)
    for i in range(3):
        b = stream.batch_at(i)
        jp, js, jm = jstep(jp, js, _jax_batch(b))
        params, opt, m = step(params, opt, _torch_batch(b))
        assert set(m) == set(jm)
        for k in ("loss", "aux", "total"):
            _close(m[k], jm[k], dict(atol=1e-5, rtol=1e-5))
        _close(m["grad_norm"], jm["grad_norm"], dict(atol=1e-6, rtol=1e-4))
        assert m["step"].dtype == torch.int32 and int(m["step"]) == int(jm["step"]) == i + 1
        assert all(v.ndim == 0 for v in m.values())
        if i == 0:  # the first moment is (1 - b1) g: the first gradients
            noise = [(t.abs() < 1e-7).numpy() & (np.abs(np.asarray(w)) < 1e-7)
                     for t, w in zip(tree_leaves(opt["m"]), jax.tree_util.tree_leaves(js["m"]))]
    # Adam's step is m / sqrt(v) per element, about +-lr whatever the
    # gradient's size. Where a gradient is rounding noise (qwen2's key bias
    # in its slowest rope dimensions: there the bias adds nearly the same
    # q.bk to every score of a query's row, and softmax is shift-invariant),
    # each package moves the element by its own noise. Such elements (a
    # first gradient below 1e-6 in both packages) are held to Adam's bound
    # of lr (plus the decay) a step; the rest to the reference suite's
    # tolerance for parameters after a step (2e-5, 2e-4)
    start = jax.tree_util.tree_leaves(np_params)
    for a, want, p0, m1, jm1, v1, jv1, nz in zip(
            tree_leaves(params), jax.tree_util.tree_leaves(jp), start,
            tree_leaves(opt["m"]), jax.tree_util.tree_leaves(js["m"]),
            tree_leaves(opt["v"]), jax.tree_util.tree_leaves(js["v"]), noise):
        a, want, keep = a.numpy(), np.asarray(want), ~nz
        np.testing.assert_allclose(a[keep], want[keep], atol=2e-5, rtol=2e-4)
        np.testing.assert_allclose(m1.numpy()[keep], np.asarray(jm1)[keep], atol=1e-6, rtol=1e-3)
        np.testing.assert_allclose(v1.numpy()[keep], np.asarray(jv1)[keep], atol=1e-6, rtol=1e-3)
        assert np.all(np.abs(a - p0)[nz] <= 3 * 1e-3 * (1 + 0.1 * np.abs(p0[nz])) + 1e-7)


def test_accumulation_keeps_the_references_metrics():
    # accum > 1: total is the mean loss and aux 0 (the JAX package's step)
    cfg = dataclasses.replace(get_reduced("mixtral-8x7b"), dtype=torch.float32)
    params = trainable(init_params(cfg, torch.Generator().manual_seed(0)))
    batch = _torch_batch(_batch_np(cfg, batch=4, masked=0))
    _, _, m = make_train_step(cfg, accum=2)(params, init_train_state(params), batch)
    assert float(m["aux"]) == 0.0 and float(m["total"]) == float(m["loss"])
    with pytest.raises(ValueError, match="accum"):
        make_train_step(cfg, accum=3)(params, init_train_state(params), batch)


def test_loss_falls_on_a_memorised_batch():
    cfg = dataclasses.replace(get_reduced("qwen2-0.5b"), dtype=torch.float32)
    params = trainable(init_params(cfg, torch.Generator().manual_seed(0)))
    opt = init_train_state(params)
    step = make_train_step(cfg, lr=3e-3)
    batch = make_batch(SyntheticLM(cfg.vocab_size, 32, 8, seed=0), 0)
    losses = [float(step(params, opt, batch)[2]["loss"]) for _ in range(30)]
    assert losses[-1] < 0.7 * losses[0], losses


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_train_cli_resumes_on_the_cpu(tmp_path, capsys):
    ckpt = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--reduced", "--batch", "2", "--seq", "16", "--ckpt-dir", ckpt]
    assert train_cli.main(argv + ["--steps", "4", "--ckpt-every", "2"]) == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out and "resumed" not in out
    assert sorted(p.name for p in tmp_path.joinpath("ck").iterdir()) == [
        "step_00000002", "step_00000004"]
    r = train_cli.run(reduced=True, batch=2, seq=16, steps=6, ckpt_dir=ckpt, device="cpu")
    assert "resumed from step 4" in capsys.readouterr().out
    assert r["start"] == 4 and len(r["losses"]) == 2 and r["peak_bytes"] is None
    assert all(np.isfinite(r["losses"])) and all(np.isfinite(r["grad_norms"]))


def test_train_cli_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--reduced", "--steps", "1"])


def test_train_cli_state_restores_in_the_reference(tmp_path):
    # the CLI's checkpoint is the JAX package's train state, leaf for leaf
    from repro.ckpt import restore as jax_restore

    ckpt = str(tmp_path)
    train_cli.run("mamba2-780m", reduced=True, batch=2, seq=16, steps=2, ckpt_dir=ckpt,
                  device="cpu")
    jcfg = dataclasses.replace(jax_get_reduced("mamba2-780m"), dtype=jnp.float32)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tree, step = jax_restore(ckpt, {"params": jp, "opt": jax_init_train_state(jp)})
    assert step == 2 and int(tree["opt"]["step"]) == 2
