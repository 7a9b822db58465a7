"""The port's serving benchmark (``benchmarks/torch_serve_bench.py``) on the
CPU against the JAX package's (``benchmarks/serve_bench.py``) as the oracle:
the workload and the batch ladder element for element, the tuned store's
records signature for signature, every request's ids in all three serving
modes against the JAX package's greedy decode of the same numpy prompt (the
reduced qwen2-0.5b in f32, weights carried over by ``params_from_numpy``),
the entry point's JSON and obs snapshot, and its tripwires."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.serve_bench as jsb
from benchmarks import torch_serve_bench as tsb
from repro.configs import get_reduced as jax_get_reduced
from repro.dispatch import TuningStore as JaxTuningStore
from repro.dispatch.signature import signature_key as jax_signature_key
from repro.models import init_params as jax_init_params
from repro.serve.step import greedy_decode as jax_greedy_decode
from repro_torch.configs import get_reduced
from repro_torch.dispatch import TuningStore
from repro_torch.dispatch.signature import signature_key
from repro_torch.kernels.spaces import PAGE_SIZES_HOST, kernel_space
from repro_torch.launch.serve import service_for
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs.metrics import MetricsRegistry

ARCH = "qwen2-0.5b"
CPU = torch.device("cpu")


@pytest.mark.parametrize("seed,rate,n,lens,out", [
    (1234, 12.0, 24, (16, 32, 48), (24, 48)),
    (1234, 50.0, 8, (8, 16), (8, 12)),
    (7, 3.5, 17, (5, 9, 11), (6, 9)),
    (0, 100.0, 40, (4,), (4, 4)),
])
def test_workload_equals_the_reference(seed, rate, n, lens, out):
    got = tsb.make_workload(n, rate, lens, out[0], out[1], seed)
    assert got == jsb.make_workload(n, rate, lens, out[0], out[1], seed)


@pytest.mark.parametrize("active,free,max_batch", [
    ([0], [1, 2, 3], 8), ([0, 2, 5], [1, 3, 4, 6, 7], 8), ([1, 2, 3, 4, 5], [0, 6, 7], 8),
    ([0, 1, 2, 3, 4, 5, 6, 7], [], 8), ([3], [0, 1, 2], 4), ([0, 1, 2], [3], 4),
    ([2, 4], [], 8),
])
def test_pad_batch_equals_the_reference(active, free, max_batch):
    assert tsb._pad_batch(list(active), list(free), max_batch) == \
        jsb._pad_batch(list(active), list(free), max_batch)


@pytest.mark.parametrize("best,max_batch,max_resident,alloc", [
    ({"impl": "pallas", "bk": 32, "hg": 2, "page": 16}, 8, 96, 1024),
    ({"impl": "xla", "bk": 8, "hg": 1, "page": 8}, 8, 28, 256),
    ({"impl": "pallas", "bk": 64, "hg": 4, "page": 128}, 6, 130, 300),
    ({"impl": "pallas", "bk": 16, "hg": 1, "page": 32}, 1, 40, 64),
])
def test_seed_store_publishes_the_references_signatures(tmp_path, best, max_batch,
                                                        max_resident, alloc):
    tcfg = get_reduced(ARCH)
    jcfg = jax_get_reduced(ARCH)
    tstore, jstore = TuningStore(str(tmp_path / "t")), JaxTuningStore(str(tmp_path / "j"))
    n = tsb.seed_store(tstore, tcfg, best, max_batch=max_batch, max_resident=max_resident,
                       alloc=alloc, backend="cpu")
    jn = jsb.seed_store(jstore, jcfg, best, max_batch=max_batch, max_resident=max_resident,
                        alloc=alloc)
    assert n == jn == len(tstore.records())
    got = sorted(signature_key(r.signature) for r in tstore.records())
    want = sorted(jax_signature_key(r.signature) for r in jstore.records())
    assert got == want
    assert {r.backend for r in tstore.records()} == {"cpu"}
    assert all(r.config == best for r in tstore.records())


def test_gpu_candidates_draw_the_page_beside_the_gpu_space():
    cands = tsb.decode_candidates("gpu", 12, seed=1234)
    gpu = kernel_space("decode_attention", target="gpu")
    assert cands[0] == dict(gpu.default_configuration(), page=PAGE_SIZES_HOST[-1])
    assert len(cands) == 12 and all(c not in cands[:i] for i, c in enumerate(cands))
    for c in cands:
        assert set(c) == set(gpu.param_names) | {"page"}
        assert c["page"] in PAGE_SIZES_HOST
        assert all(gpu[k].validate(c[k]) for k in gpu.param_names)
    assert tsb.decode_candidates("gpu", 12, seed=1234) == cands
    # the host space holds page itself: its samples are the space's, as the JAX package's
    host = tsb.decode_candidates("host", 6, seed=1234)
    assert host[0] == dict(kernel_space("decode_attention", target="host")
                           .default_configuration())


def test_tune_decode_on_the_cpu_times_host_candidates():
    cfg = dataclasses.replace(get_reduced(ARCH), dtype=torch.float32)
    best, trace = tsb.tune_decode(cfg, max_batch=4, resident=20, n_candidates=4, seed=3,
                                  device="cpu")
    assert len(trace) == 4 and best in [t["config"] for t in trace]
    assert all(t["seconds"] > 0 for t in trace)
    assert min(trace, key=lambda t: t["seconds"])["config"] == best


@pytest.fixture(scope="module")
def model():
    """The JAX package's reduced qwen2-0.5b weights in f32, with random QKV
    biases and norm scales, in both packages."""
    jcfg = dataclasses.replace(jax_get_reduced(ARCH), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_reduced(ARCH), dtype=torch.float32)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    for name in ("bq", "bk", "bv", "ln1", "ln2"):
        tree["layers"][name] = 0.1 * rng.standard_normal(tree["layers"][name].shape,
                                                         dtype=np.float32)
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), params_from_numpy(tree)


@pytest.fixture(scope="module")
def greedy_reference(model):
    """Each request's ids by the JAX package's greedy_decode on its numpy
    prompt (``request_prompt``), prompts of one length decoded together."""
    jcfg, _, jparams, _ = model
    workload = tsb.make_workload(6, 40.0, (5, 9), 6, 8, seed=3)
    steps = max(r["out_len"] for r in workload)
    want = {}
    for n in sorted({r["prompt_len"] for r in workload}):
        reqs = [r for r in workload if r["prompt_len"] == n]
        prompt = np.concatenate([tsb.request_prompt(r, jcfg.vocab_size) for r in reqs])
        toks = np.asarray(jax_greedy_decode(jparams, jcfg, jnp.asarray(prompt, jnp.int32),
                                            steps=steps, max_len=32))
        for r, row in zip(reqs, toks):
            want[r["id"]] = row[:r["out_len"]].tolist()
    return workload, want


@pytest.mark.parametrize("mode", ["einsum", "default", "tuned"])
def test_run_mode_ids_equal_the_references_greedy_decode(tmp_path, model, greedy_reference,
                                                         mode):
    _, tcfg, _, params = model
    workload, want = greedy_reference
    service, page = None, 32
    if mode == "default":
        service = service_for(CPU, TuningStore(str(tmp_path / "default")),
                              metrics=MetricsRegistry())
        page = 16
    elif mode == "tuned":
        store = TuningStore(str(tmp_path / "tuned"))
        best = {"impl": "pallas", "bk": 8, "hg": 2, "page": 8}
        tsb.seed_store(store, tcfg, best, max_batch=4, max_resident=17, alloc=32,
                       backend="cpu")
        service = service_for(CPU, store, metrics=MetricsRegistry())
        page = 8
    r = tsb.run_mode(mode, tcfg, params, workload, max_batch=4, max_len=32, page_size=page,
                     service=service, round_cap=3)
    assert r["ids"] == want
    assert r["tokens"] == sum(x["out_len"] for x in workload)
    assert r["launches"] == {"flash_attention": 0, "decode_attention": 0, "tiled_matmul": 0}
    assert 0 < r["token_lat_p50_ms"] <= r["token_lat_p99_ms"]
    if mode == "tuned":
        assert r["dispatch"]["store_exact"] >= 1 and r["dispatch"]["build_failed"] == 0
        assert r["dispatch"]["infeasible"] == 0
    if mode == "einsum":
        assert "dispatch" not in r and r["page_size"] is None


# the reference's keys (benchmarks/serve_bench.py: run_mode, main,
# guard_drift_phase)
MODE_KEYS = {"mode", "page_size", "requests", "tokens", "wall_sec", "throughput_tok_s",
             "token_lat_p50_ms", "token_lat_p99_ms", "ttft_p50_ms", "kv_cache"}
DISPATCH_KEYS = {"store_exact", "store_near", "store_default", "exec_hit", "exec_miss",
                 "build_failed", "infeasible"}
GUARD_KEYS = {"epsilon", "p50_plain_ms", "p50_shadow_ms", "shadow_overhead_frac",
              "drift_ok", "fallback_ok", "decisions", "shadow", "quarantines", "fallbacks",
              "counters"}
WORKLOAD_KEYS = {"requests", "rate_req_s", "prompt_lens", "out_mean", "out_cap",
                 "max_batch", "max_len", "seed", "arch", "reduced"}


def test_main_quick_on_the_cpu_writes_the_references_keys(tmp_path, capsys):
    out, obs = tmp_path / "bench.json", tmp_path / "bench.obs.jsonl"
    record = {}
    rc = tsb.main(["--quick", "--device", "cpu", "--reduced", "--inject-drift",
                   "--store", str(tmp_path / "store"), "--out", str(out),
                   "--obs-out", str(obs)], record=record)
    text = capsys.readouterr().out
    assert rc == 0, text
    data = json.loads(out.read_text())
    assert {"workload", "modes", "speedup_p50_tuned_vs_einsum",
            "speedup_p50_tuned_vs_default", "guard", "meta"} <= set(data)
    assert WORKLOAD_KEYS <= set(data["workload"]) and data["workload"]["reduced"] is True
    assert set(data["modes"]) == {"einsum", "default", "tuned"}
    for mode, r in data["modes"].items():
        assert MODE_KEYS <= set(r) and "ids" not in r
        if mode != "einsum":
            assert set(r["dispatch"]) == DISPATCH_KEYS
    assert {"decode_config", "campaign"} <= set(data["modes"]["tuned"])
    assert data["modes"]["tuned"]["page_axis"] == "the host space's"
    assert GUARD_KEYS <= set(data["guard"])
    g = data["guard"]
    assert g["drift_ok"] and g["fallback_ok"] and g["quarantines"] == 1
    assert g["watched_histogram"] == "dispatch_execute_seconds"
    assert g["overhead_trials"] == []            # one measurement: the gate's
    # the stamp: no card on the CPU
    assert data["meta"]["device"] == "cpu" and data["meta"]["card"] is None
    assert data["meta"]["torch"] == torch.__version__
    # the obs snapshot: both hot paths' execute histograms, stamped
    line = json.loads(obs.read_text().splitlines()[-1])
    assert line["bench"] == "serve" and line["mode"] == "tuned" and line["meta"]["device"] == "cpu"
    kernels = {h["labels"]["kernel"] for h in line["snapshot"]["histograms"]
               if h["name"] == "dispatch_execute_seconds"}
    assert {"flash_attention", "decode_attention"} <= kernels
    # the record keeps what the JSON leaves out: every request's ids, equal
    # across the modes (the same greedy decode three ways)
    ids = {m: r["ids"] for m, r in record["modes"].items()}
    assert ids["einsum"] == ids["default"] == ids["tuned"]
    assert len(ids["tuned"]) == data["workload"]["requests"]


def _fake_mode(p50, p99):
    def run_mode(mode, cfg, params, workload, *, max_batch, max_len, page_size, service,
                 round_cap=8):
        r = {"mode": mode, "page_size": page_size, "requests": len(workload), "tokens": 1,
             "wall_sec": 1.0, "throughput_tok_s": 1.0, "token_lat_p50_ms": p50,
             "token_lat_p99_ms": p99, "ttft_p50_ms": 1.0, "kv_cache": {},
             "launches": {}, "ids": {}}
        if service is not None:
            r["dispatch"] = {k: 0 for k in DISPATCH_KEYS}
            r["dispatch"]["store_exact"] = 1
        return r
    return run_mode


@pytest.mark.parametrize("p50,p99", [(1.0, 0.0), (1.0, float("nan")), (1.0, None),
                                     (2.0, 1.0)], ids=["zero", "nan", "missing", "p50>p99"])
def test_degenerate_p99_exits_1(tmp_path, monkeypatch, capsys, p50, p99):
    monkeypatch.setattr(tsb, "run_mode", _fake_mode(p50, p99 if p99 is not None else None))
    if p99 is None:
        # a missing p99 with a p50 that prints: the tripwire reads the p99 first
        monkeypatch.setattr(tsb, "_line", lambda name, r, extra="": name)
    record = {}
    rc = tsb.main(["--quick", "--device", "cpu", "--reduced", "--store", str(tmp_path / "s"),
                   "--out", str(tmp_path / "b.json"),
                   "--obs-out", str(tmp_path / "b.obs.jsonl")], record=record)
    out = capsys.readouterr().out
    assert rc == 1
    reason = "p50 > p99" if p50 > 1.0 else "degenerate p99"
    assert reason in out
    # the caller (chip_smoke.py's phase 14) reads why from the record
    assert reason in record["fail"]


def test_main_needs_a_card_without_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        tsb.main(["--quick", "--reduced", "--out", str(tmp_path / "b.json")])


def test_guard_phase_repeats_the_gate_beside_its_noise_floor(tmp_path):
    """``--overhead-trials``: the gate's measurement repeated at the JAX
    package's N and at the run's, for the guarded executable and for a
    second unguarded one; the gate and the drift loop as with one trial."""
    from repro_torch.dispatch.registry import get as get_variant

    cfg = get_reduced("qwen2-0.5b")
    best = dict(get_variant("decode_attention").default_config("host"), page=8)
    g = tsb.guard_drift_phase(cfg, best, store_root=str(tmp_path), max_batch=2, bucket=16,
                              quick=True, device="cpu", trials=2)
    rows = g["overhead_trials"]
    assert [(r["pairs"], r["b"]) for r in rows] == [(100, "unguarded"), (100, "guarded"),
                                                   (400, "unguarded"), (400, "guarded")]
    assert all(r["trials"] == 2 and 0 <= r["past_2pct"] <= 2 for r in rows)
    assert all(np.isfinite([r["mean_pct"], r["sd_pct"], r["max_pct"]]).all() for r in rows)
    assert np.isfinite(g["shadow_overhead_frac"])
    assert g["drift_ok"] and g["fallback_ok"] and g["quarantines"] == 1
