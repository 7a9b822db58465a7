"""The port's four parallelism benchmarks against the reference's:
compression bytes per parameter, the roofline table on one fixture, the
hillclimb's knob space, probes and knob mapping (and its evaluator's
penalty), and the flash byte model and adjustment."""

import json
import os

import pytest

from benchmarks import roofline_table as ref_table
from benchmarks import torch_compression_bench as compression
from benchmarks import torch_flash_adjust as flash_adjust
from benchmarks import torch_hillclimb as hillclimb
from benchmarks import torch_roofline_table as table
from repro.kernels.flash_attention import flash_hbm_bytes as ref_flash_hbm_bytes
from repro.kernels.flash_attention import xla_attention_hbm_bytes as ref_xla_bytes
from repro_torch.core import Categorical, Ordinal
from repro_torch.kernels.flash_attention import flash_hbm_bytes, xla_attention_hbm_bytes


@pytest.fixture
def ref_hillclimb(monkeypatch):
    """``benchmarks.hillclimb`` of the reference: its import adds a host
    device count to XLA_FLAGS unless one is there; the flag set here keeps
    the process's JAX as it is (and the environment is restored after)."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", "") +
                       " --xla_force_host_platform_device_count=1")
    import benchmarks.hillclimb as mod
    return mod


def test_compression_moves_4_2_1_bytes_a_parameter(tmp_path):
    rows = compression.main(["--out", str(tmp_path / "c.json")])
    assert rows["f32"]["bytes_per_param"] == pytest.approx(4.0, rel=1e-3)
    assert rows["bf16"]["bytes_per_param"] == pytest.approx(2.0, rel=1e-3)
    # int8 adds one scalar max (and the loss) a leaf: a hair above 1
    assert 1.0 <= rows["int8"]["bytes_per_param"] <= 1.01
    assert json.loads((tmp_path / "c.json").read_text()) == rows


FIXTURE = [
    {"arch": "qwen2-0.5b", "shape": "train_4k", "mesh": "16x16", "status": "ok",
     "roofline": {"compute_sec": 0.127, "memory_sec": 3.85, "collective_sec": 0.18,
                  "dominant": "memory", "bound_sec": 3.85, "roofline_fraction": 0.033,
                  "useful_flops_ratio": 0.0965, "bytes_per_device": 1.29e13}},
    {"arch": "qwen2-0.5b", "shape": "long_500k", "mesh": "16x16", "status": "skipped",
     "reason": "skip(full-attn): long_500k needs sub-quadratic attention"},
    {"arch": "mixtral-8x7b", "shape": "train_4k", "mesh": "16x16", "status": "error",
     "error": "ValueError: something"},
    {"arch": "gemma3-1b", "shape": "prefill_32k", "mesh": "2x16x16", "status": "ok",
     "roofline": {"compute_sec": 0.11, "memory_sec": 1.64, "collective_sec": 0.02,
                  "dominant": "memory", "bound_sec": 1.64, "roofline_fraction": 0.07,
                  "useful_flops_ratio": None, "bytes_per_device": 5.5e12}},
]


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_roofline_table_equals_the_references_on_one_fixture(tmp_path, mesh):
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(FIXTURE))
    assert table.markdown(str(path), mesh) == ref_table.markdown(str(path), mesh)
    assert table.csv_rows(str(path), mesh) == ref_table.csv_rows(str(path), mesh)
    assert table.load(str(tmp_path / "missing.json")) == []


def _space_equal(a, b):
    assert a.param_names == b.param_names
    for name in a.param_names:
        x, y = a[name], b[name]
        assert type(x).__name__ == type(y).__name__
        assert (x.name, x.default) == (y.name, y.default)
        assert tuple(getattr(x, "sequence", getattr(x, "choices", ()))) == \
            tuple(getattr(y, "sequence", getattr(y, "choices", ())))
    assert a.default_configuration() == b.default_configuration()


@pytest.mark.parametrize("kind,moe", [("train", False), ("train", True), ("decode", False),
                                      ("prefill", True)])
def test_knob_space_equals_the_references(ref_hillclimb, kind, moe):
    _space_equal(hillclimb.knob_space(kind, moe), ref_hillclimb.knob_space(kind, moe))
    space = hillclimb.knob_space(kind, moe)
    assert all(isinstance(space[n], (Ordinal, Categorical)) for n in space.param_names)


def test_probes_and_knob_mapping_equal_the_references(ref_hillclimb):
    assert hillclimb.PROBES == ref_hillclimb.PROBES
    for label, delta in hillclimb.PROBES:
        cfg = dict(hillclimb.knob_space("train", True).default_configuration(), **delta)
        assert hillclimb.config_to_knobs(cfg) == ref_hillclimb.config_to_knobs(cfg)


def test_hillclimb_evaluator_penalises_a_cell_past_the_cards_memory(monkeypatch):
    import dataclasses

    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.perf import roofline

    log: list = []
    config = dict(attn_chunk=512, attn_f32=True, mla_absorb=True)
    with fake_world(256):
        mesh = make_production_mesh()
        fits = hillclimb.make_cell_evaluator("qwen2-0.5b", "decode_32k", mesh, log,
                                             layers=1)(config)
        card = roofline.hardware
        monkeypatch.setattr(roofline, "hardware", lambda *a, **k: dataclasses.replace(
            card(*a, **k), memory_bytes=1e6))  # a card of 1 MB
        tight = hillclimb.make_cell_evaluator("qwen2-0.5b", "decode_32k", mesh, log,
                                              layers=1)(config)
    assert fits.ok and log[0]["feasible"] and fits.objective == log[0]["bound_sec"]
    assert tight.ok and not log[1]["feasible"]
    assert tight.objective == pytest.approx(
        log[1]["bound_sec"] * (log[1]["device_bytes"] / 1e6) ** 2)
    assert log[0]["config"] == config


def test_hillclimb_evaluation_in_a_worker_process_equals_the_inline_one():
    """``--parallel``'s route: a worker process traces on a fake world of its
    own and scores the configuration as this process does."""
    import concurrent.futures
    import multiprocessing

    from repro_torch.launch.mesh import fake_world, make_production_mesh

    config = dict(attn_chunk=512, attn_f32=True, mla_absorb=True)
    inline, pooled = [], []
    with fake_world(256):
        mesh = make_production_mesh()
        want = hillclimb.make_cell_evaluator("qwen2-0.5b", "decode_32k", mesh, inline,
                                             layers=1)(config)
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as pool:
            got = hillclimb.make_cell_evaluator("qwen2-0.5b", "decode_32k", mesh, pooled,
                                                layers=1, workers=pool)(config)
    assert want.ok and got.ok and got.objective == want.objective
    assert pooled == inline


def test_flash_byte_model():
    # one launch per query head: H, not Kh, sweeps of K/V per q tile
    assert flash_hbm_bytes(1, 8, 2, 512, 512, 64) == flash_hbm_bytes(1, 8, 8, 512, 512, 64)
    # the reference's formula at the reference's GQA with Kh = H and the same tile
    assert flash_hbm_bytes(2, 4, 4, 1024, 1024, 64, dtype_bytes=2) == \
        ref_flash_hbm_bytes(2, 4, 4, 1024, 1024, 64, dtype_bytes=2)
    # the causal mask reads the key blocks up to the diagonal: about half
    full = flash_hbm_bytes(1, 1, 1, 4096, 4096, 128)
    causal = flash_hbm_bytes(1, 1, 1, 4096, 4096, 128, causal=True)
    assert 0.5 < causal / full < 0.6
    # head sizes padded to the kernel's instantiation (80 -> 128)
    assert flash_hbm_bytes(1, 1, 1, 128, 128, 80) == flash_hbm_bytes(1, 1, 1, 128, 128, 128)
    assert xla_attention_hbm_bytes(2, 4, 64, 64, 32) == ref_xla_bytes(2, 4, 64, 64, 32)


def test_flash_adjust_counts_the_chunked_path_and_lowers_the_memory_term(tmp_path):
    a_fwd, a_fwdbwd = flash_adjust.attention_traffic(1, 512, 2, 1, 64, chunk=128)
    assert 0 < a_fwd < a_fwdbwd
    out = flash_adjust.adjust("qwen2-0.5b", 0.40, 0.02, 0.1, accum=8, layers=2)
    assert out["memory_sec_after"] < out["memory_sec_before"]
    assert out["traffic_ratio"] > 1 and out["bound_after"] <= out["bound_before"]
    hc = tmp_path / "hc.json"
    hc.write_text(json.dumps({"layers": 2, "baseline": {
        "config": {"accum": 8}, "memory_sec": 0.40, "compute_sec": 0.02,
        "collective_sec": 0.1}}))
    got = flash_adjust.main(["--arch", "qwen2-0.5b", "--hillclimb-json", str(hc),
                             "--out", str(tmp_path / "f.json")])
    assert got == out == json.loads((tmp_path / "f.json").read_text())
