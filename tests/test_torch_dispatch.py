"""The port's dispatch core against the JAX package's: signatures, the
tuning store and lookup (a store written by ``repro`` resolves to the same
exact / near / default results in the port), and the port's service — its
build guard, which degrades a poisoned record to the space default, its
executable cache, ``jit_cached`` proxies and ``invalidate``."""

import numpy as np
import pytest
import torch

from repro.dispatch import TuningRecord as JaxRecord
from repro.dispatch import TuningStore as JaxStore
from repro.dispatch import lookup as jlookup
from repro.dispatch import signature as jsig
from repro_torch.dispatch import (
    DispatchService,
    TuningRecord,
    TuningStore,
    registered,
    resolve,
)
from repro_torch.dispatch import signature as sig
from repro_torch.kernels import model_kernels as mk
from repro_torch.kernels.decode_attention import CacheRows, decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain


def _normal(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)) for s in shapes]


@pytest.mark.parametrize("args", [
    (np.zeros((8, 256, 64)), np.zeros((8, 384, 64)), True),
    (np.zeros((4, 7, 64)), np.zeros((4,)), False, 0, 128),
    ((1200, 1000), 8, 2.5),
])
def test_signature_keys_match_reference(args):
    s, js = sig.shape_signature(args), jsig.shape_signature(args)
    assert s == js
    assert sig.signature_key(s) == jsig.signature_key(js)
    assert sig.parse_signature_key(sig.signature_key(s)) == s
    assert sig.bucket_signature(s) == jsig.bucket_signature(js)
    other = ((9, 250, 64), (9, 400, 64), (2,))
    assert sig.signature_distance(s, other) == jsig.signature_distance(js, other)


def test_tensor_and_cache_rows_signatures():
    q, kc = _normal((4, 7, 64), (2, 384, 2, 64))
    assert sig.shape_signature([q, CacheRows(kc), torch.zeros(4, dtype=torch.int32)]) == \
        ((4, 7, 64), (4, 384, 64), (4,))
    assert sig.shape_signature([q, CacheRows(kc)])[:2] == \
        mk.decode_attention_signature(4, 7, 384, 64)[:2]


def _jax_store(path):
    """A store written by the JAX package: two flash records, one decode
    record, one quarantined config."""
    st = JaxStore(str(path))
    flash = mk.flash_attention_signature(8, 256, 256, 64)
    st.put(JaxRecord("flash_attention", flash, "gpu",
                     dict(impl="pallas", bq=32, bk=64), 2e-4, n_evals=40))
    st.put(JaxRecord("flash_attention", mk.flash_attention_signature(8, 1024, 1024, 64), "gpu",
                     dict(impl="pallas", bq=128, bk=64), 9e-4))
    st.put(JaxRecord("decode_attention", mk.decode_attention_signature(8, 7, 384, 64), "gpu",
                     dict(impl="pallas", bk=64, hg=2, page=128), 1e-5))
    bad = JaxRecord("matmul", ((4, 896), (896, 896)), "gpu",
                    dict(bm=64, bn=64, bk=32, pack=True, interchange=False), 1e-6)
    st.put(bad)
    st.quarantine(bad, reason="build_failed")
    return st


@pytest.mark.parametrize("kernel,signature", [
    ("flash_attention", mk.flash_attention_signature(8, 256, 256, 64)),          # exact
    ("flash_attention", mk.flash_attention_signature(8, 300, 300, 64)),          # near
    ("flash_attention", mk.flash_attention_signature(8, 256, 256, 64, causal=False)),
    ("decode_attention", mk.decode_attention_signature(8, 7, 512, 64)),          # near
    ("decode_attention", mk.decode_attention_signature(8, 7, 384, 64, ring=True)),
    ("matmul", ((4, 896), (896, 896))),                                          # quarantined
    ("matmul", ((4, 896), (896, 151936))),                                       # no record
])
def test_port_store_resolves_a_reference_store_alike(tmp_path, kernel, signature):
    jst = _jax_store(tmp_path)
    st = TuningStore(str(tmp_path))
    assert len(st) == len(jst)
    want = jlookup.resolve(jst, kernel, signature, "gpu")
    got = resolve(st, kernel, signature, "gpu")
    if want is None:
        assert got is None
    else:
        assert (got.exact, got.distance, got.config) == (want.exact, want.distance, want.config)
    for max_d in (0.1, 1.0):
        a = resolve(st, kernel, signature, "gpu", max_distance=max_d)
        b = jlookup.resolve(jst, kernel, signature, "gpu", max_distance=max_d)
        assert (a is None) == (b is None)


def test_port_writes_a_store_the_reference_reads(tmp_path):
    st = TuningStore(str(tmp_path))
    rec = TuningRecord("decode_attention", mk.decode_attention_signature(8, 7, 384, 64), "gpu",
                       dict(impl="pallas", bk=128, hg=1, page=128), 3e-5, source="port")
    assert st.put(rec)
    assert not st.put(TuningRecord(rec.kernel, rec.signature, "gpu", rec.config, 4e-5))
    got = JaxStore(str(tmp_path)).get(rec.kernel, rec.signature, "gpu")
    assert got.config == rec.config and got.objective == rec.objective


def test_service_resolves_store_exact_near_and_default(tmp_path):
    _jax_store(tmp_path)
    svc = DispatchService(TuningStore(str(tmp_path)))
    q, k, v = _normal((8, 256, 64), (8, 256, 64), (8, 256, 64))
    fn = svc.dispatch("flash_attention", q, k, v, causal=True)
    assert fn.__wrapped__.fn.keywords == dict(causal=True, bq=32, bk=64)
    assert svc.dispatch("flash_attention", q, k, v, causal=True) is fn     # fast path
    q2 = q[:, :200].contiguous()
    near = svc.dispatch("flash_attention", q2, k, v, causal=True)
    assert near.__wrapped__.fn.keywords["bq"] == 32
    svc.dispatch("matmul", torch.zeros(3, 5), torch.zeros(5, 6))
    assert (svc.stats["store_exact"], svc.stats["store_near"], svc.stats["store_default"]) \
        == (1, 1, 1)
    assert svc.stats["exec_hit"] == 1 and svc.stats["exec_miss"] == 3
    torch.testing.assert_close(fn(q, k, v), flash_attention_plain(q, k, v))


@pytest.mark.parametrize("poison", [dict(impl="pallas", bq=0, bk=64),
                                    dict(impl="triton", bq=64, bk=64),
                                    dict(impl="pallas", bq="wide", bk=64)])
def test_poisoned_record_degrades_to_the_default(tmp_path, poison):
    st = TuningStore(str(tmp_path))
    signature = mk.flash_attention_signature(2, 40, 40, 16)
    st.put(TuningRecord("flash_attention", signature, "gpu", poison, 1e-6))
    svc = DispatchService(st)
    q, k, v = _normal((2, 40, 16), (2, 40, 16), (2, 40, 16), seed=1)
    out = svc.call("flash_attention", q, k, v, causal=True)
    assert svc.stats["build_failed"] == 1
    torch.testing.assert_close(out, flash_attention_plain(q, k, v))
    fn = svc.dispatch("flash_attention", q, k, v, causal=True)
    assert fn.__wrapped__.fn.keywords == dict(causal=True, bq=64, bk=64)   # the gpu default
    assert st.quarantines("flash_attention")[0]["reason"] == "build_failed"
    assert st.get("flash_attention", signature, "gpu") is None


@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention"])
def test_operand_fault_propagates_and_quarantines_nothing(tmp_path, kernel):
    # a sound exact record, and a caller whose operands lie on two devices
    # (q off the CPU, so the wrapper's operand checks run): the fault is the
    # caller's, so it raises and the record stays
    st = TuningStore(str(tmp_path))
    if kernel == "flash_attention":
        signature = mk.flash_attention_signature(2, 40, 40, 16)
        config, static = dict(impl="pallas", bq=32, bk=32), dict(causal=True)
        args = (torch.empty(2, 40, 16, device="meta"), *_normal((2, 40, 16), (2, 40, 16)))
    else:
        signature = mk.decode_attention_signature(4, 3, 48, 16)
        config, static = dict(impl="pallas", bk=32, hg=2), dict(ring=False, window=0)
        args = (torch.empty(4, 3, 16, device="meta"), *_normal((4, 48, 16), (4, 48, 16)),
                torch.full((4,), 40, dtype=torch.int32))
    st.put(TuningRecord(kernel, signature, "gpu", config, 1e-6))
    svc = DispatchService(st)
    with pytest.raises(ValueError, match="is on cpu"):
        svc.dispatch(kernel, *args, **static)
    assert svc.stats["store_exact"] == 1 and svc.stats["build_failed"] == 0
    assert st.quarantines() == [] and st.get(kernel, signature, "gpu").config == config


def test_xla_variants_refuse_tensors_off_the_cpu():
    from repro_torch.kernels.util import ConfigRejected

    flash = mk.flash_attention_builder(dict(impl="xla", bq=16))
    decode = mk.decode_attention_builder(dict(impl="xla", bk=16))
    q, k, v = (torch.empty(2, 8, 16, device="meta") for _ in range(3))
    cp = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ConfigRejected):
        flash.check(q, k, v)
    with pytest.raises(ConfigRejected):
        flash(q, k, v)
    with pytest.raises(ConfigRejected):
        decode(q, k, v, cp)
    qc, kc, vc = _normal((2, 8, 16), (2, 8, 16), (2, 8, 16))
    flash.check(qc, kc, vc)                              # the CPU is its place
    torch.testing.assert_close(flash(qc, kc, vc), mk.chunked_attention_xla(qc, kc, vc, bq=16))


def test_near_neighbor_that_does_not_transfer_is_not_quarantined(tmp_path):
    st = TuningStore(str(tmp_path))
    rec = TuningRecord("decode_attention", mk.decode_attention_signature(4, 3, 64, 16), "gpu",
                       dict(impl="pallas", bk=0, hg=1), 1e-6)
    st.put(rec)
    svc = DispatchService(st)
    q, k, v = _normal((4, 3, 16), (4, 48, 16), (4, 48, 16), seed=2)
    cp = torch.full((4,), 40, dtype=torch.int32)
    out = svc.call("decode_attention", q, k, v, cp, ring=False, window=0)
    torch.testing.assert_close(out, decode_attention_plain(q, k, v, cp))
    assert svc.stats["store_near"] == 1 and svc.stats["build_failed"] == 1
    assert st.quarantines() == [] and st.get(rec.kernel, rec.signature, "gpu") is not None


def test_jit_cached_proxy_and_invalidate():
    svc = DispatchService()
    calls = []

    def step(x):
        calls.append(x)
        return x + 1

    proxy = svc.jit_cached("serve_step/test", step)
    assert svc.jit_cached("serve_step/test", step) is proxy
    assert svc.stats["exec_miss"] == 1 and svc.stats["exec_hit"] == 1
    assert proxy(1) == 2
    q, k, v = _normal((2, 8, 16), (2, 8, 16), (2, 8, 16))
    fn = svc.dispatch("flash_attention", q, k, v, causal=True)
    assert svc.invalidate("flash_attention") == 1
    assert svc.dispatch("flash_attention", q, k, v, causal=True) is not fn
    assert proxy(2) == 3 and svc.stats["serve_rebuilt"] == 1
    assert svc.invalidate() >= 1
    assert proxy(3) == 4 and svc.stats["serve_rebuilt"] == 2 and calls == [1, 2, 3]
    svc.call("flash_attention", q, k, v, causal=True)
    tel = svc.telemetry()
    assert "flash_attention" in {row["kernel"] for row in tel["execute_latency"]}
    assert tel["infeasible"] == 0 and tel["bg_enqueued"] == 0


def test_registry_holds_the_model_kernels():
    assert registered() == ["decode_attention", "flash_attention", "matmul"]
    svc = DispatchService(target="host")
    cfg, res = svc.resolve_config("flash_attention", mk.flash_attention_signature(1, 8, 8, 16))
    assert res is None and cfg["impl"] == "xla"          # the host flavour, as in repro
    cfg, _ = DispatchService().resolve_config("decode_attention", ((1,),))
    assert cfg["impl"] == "pallas"                       # the gpu flavour: the kernel
