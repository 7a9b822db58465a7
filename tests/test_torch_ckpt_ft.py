"""The port's checkpoints and fault tolerance against the JAX package: a
checkpoint written by either package restores in the other bit for bit
(raw and zstd shards), the port's MessagePack gives ``msgpack.packb``'s bytes
and its raw shard is the JAX package's byte for byte, the port's checkpoint
code runs with neither ``msgpack`` nor ``zstandard`` importable; resume,
mismatches and garbage collection; gradient compression (``quantize``,
error feedback, ``compressed_psum`` in a gloo world of one against
``repro``'s ``shard_map`` on one device), the straggler monitor and the
elastic mesh plan."""

import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.ckpt.checkpoint as jax_ckpt_mod
import repro_torch.ckpt.checkpoint as ckpt_mod
from repro.ckpt import AsyncCheckpointer as JaxAsyncCheckpointer
from repro.ckpt import restore as jax_restore
from repro.ckpt import save as jax_save
from repro.ft import LADDER as JAX_LADDER
from repro.ft import StragglerMonitor as JaxStragglerMonitor
from repro.ft import compressed_psum as jax_compressed_psum
from repro.ft import dequantize as jax_dequantize
from repro.ft import ef_compress_grads as jax_ef_compress_grads
from repro.ft import plan_mesh as jax_plan_mesh
from repro.ft import quantize as jax_quantize
from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore, save
from repro_torch.ckpt.codec import pack, unpack
from repro_torch.ft import (
    LADDER,
    StragglerMonitor,
    compressed_psum,
    dequantize,
    ef_compress_grads,
    plan_mesh,
    quantize,
)
from repro_torch.tree import tree_leaves, treedef_str

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _np_tree(seed: int = 0) -> dict:
    """Every dtype a train state holds, bf16 moments too, nested, 0-d step."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.standard_normal((3, 4), dtype=np.float32),
                   "layers": {"ln1": rng.standard_normal((2, 5), dtype=np.float32)},
                   "b": rng.standard_normal(4, dtype=np.float32)},
        "opt": {"m": {"h": rng.standard_normal((300, 7)).astype(jnp.bfloat16)},
                "step": np.asarray(7, np.int32)},
        "ids": np.arange(70_000, dtype=np.int64).reshape(1000, 70),
    }


def _to_torch(x):
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x) -> tuple:
    """(dtype name, shape, raw bytes) of a tensor or array."""
    if isinstance(x, torch.Tensor):
        bf16 = x.dtype == torch.bfloat16
        a = x.view(torch.int16).numpy() if bf16 else x.numpy()
        return ("bfloat16" if bf16 else a.dtype.str, a.shape, a.tobytes())
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return ("bfloat16", a.shape, a.view(np.uint16).tobytes())
    return (a.dtype.str, a.shape, a.tobytes())


def _torch_tree(tree: dict) -> dict:
    return jax.tree_util.tree_map(_to_torch, tree)


@pytest.fixture(params=["raw", "zstd"])
def shard_format(request, monkeypatch):
    """Both packages write raw shards (zstandard hidden from both) or zstd."""
    if request.param == "raw":
        monkeypatch.setattr(ckpt_mod, "zstandard", None)
        monkeypatch.setattr(jax_ckpt_mod, "zstandard", None)
    elif ckpt_mod.zstandard is None or jax_ckpt_mod.zstandard is None:
        pytest.skip("zstandard is not installed")
    return request.param


def _flag(path, step) -> bytes:
    with open(os.path.join(path, f"step_{step:08d}", "shard_0.msgpack.zst"), "rb") as f:
        return f.read(1)


# ---------------------------------------------------------------------------
# the format, across packages
# ---------------------------------------------------------------------------


def test_port_checkpoint_restores_in_reference(tmp_path, shard_format):
    tree = _np_tree()
    save(str(tmp_path), _torch_tree(tree), step=5)
    assert _flag(tmp_path, 5) == (b"\x00" if shard_format == "raw" else b"\x01")
    got, step = jax_restore(str(tmp_path), tree)
    assert step == 5
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tree)):
        assert _bits(a) == _bits(b)


def test_reference_checkpoint_restores_in_port(tmp_path, shard_format):
    tree = _np_tree(1)
    jax_save(str(tmp_path), tree, step=9)
    template = _torch_tree(_np_tree(2))
    got, step = restore(str(tmp_path), template)
    assert step == 9 and set(got) == set(template)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(tree)):
        assert isinstance(a, torch.Tensor) and _bits(a) == _bits(b)


def test_raw_shard_and_meta_equal_the_references_byte_for_byte(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt_mod, "zstandard", None)
    monkeypatch.setattr(jax_ckpt_mod, "zstandard", None)
    tree = _np_tree(3)
    save(str(tmp_path / "port"), _torch_tree(tree), step=1)
    jax_save(str(tmp_path / "jax"), tree, step=1)
    for name in ("shard_0.msgpack.zst", "meta.json"):
        mine = (tmp_path / "port" / "step_00000001" / name).read_bytes()
        theirs = (tmp_path / "jax" / "step_00000001" / name).read_bytes()
        assert mine == theirs, name
    meta = json.loads((tmp_path / "port" / "step_00000001" / "meta.json").read_text())
    assert meta["treedef"] == str(jax.tree_util.tree_structure(tree)) == treedef_str(tree)


@pytest.mark.parametrize("obj", [
    {"magic": "repro-ckpt-v1", "leaves": [
        {"d": "<f4", "s": [3, 4], "b": bytes(48)}, {"d": "bfloat16", "s": [], "b": bytes(2)},
        {"d": "<i8", "s": [70_000, 300, 2**33], "b": bytes(70_000)}]},
    [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1],
    ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65536, "ü"],
    [bytes(0), bytes(255), bytes(256), bytes(65536)],
    {str(i): [i, str(i)] for i in range(17)},
    list(range(16)) + [[]] + [{}],
], ids=["leaf-records", "uints", "strs", "bins", "map16", "array16"])
def test_codec_bytes_equal_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert b"".join(bytes(p) for p in pack(obj)) == want
    assert _plain(unpack(want)) == _plain(msgpack.unpackb(want, raw=False))


def _plain(x):
    if isinstance(x, (memoryview, bytes)):
        return bytes(x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def test_codec_refuses_what_the_format_has_not():
    with pytest.raises(ValueError, match="negative"):
        pack(-1)
    for obj in (1.5, True, None):
        with pytest.raises(TypeError):
            pack(obj)
    for obj, byte in ((1.5, "0xcb"), (None, "0xc0"), (True, "0xc3"), (-1, "0xff")):
        with pytest.raises(ValueError, match=byte):
            unpack(msgpack.packb(obj))
    with pytest.raises(ValueError, match="trailing"):
        unpack(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        unpack(msgpack.packb(b"abcd", use_bin_type=True)[:-1])


def test_port_checkpoint_code_imports_no_msgpack():
    for path in sorted((SRC / "repro_torch" / "ckpt").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in ("msgpack", "jax", "repro") for n in names), \
                (path.name, names)


def test_port_checkpoints_with_neither_msgpack_nor_zstandard(tmp_path):
    # a process where both imports fail, as on a machine without either package
    code = (
        "import sys; sys.modules['msgpack'] = None; sys.modules['zstandard'] = None\n"
        "import torch\n"
        "from repro_torch.ckpt import restore, save\n"
        "t = {'a': torch.arange(6.).reshape(2, 3), 'b': {'c': torch.ones(4, dtype=torch.bfloat16)}}\n"
        f"save({str(tmp_path)!r}, t, 3)\n"
        f"got, step = restore({str(tmp_path)!r}, t)\n"
        "assert step == 3 and torch.equal(got['a'], t['a']) and torch.equal(got['b']['c'], t['b']['c'])\n"
        "assert 'msgpack' not in {m for m in sys.modules if sys.modules[m] is not None}\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    assert _flag(tmp_path, 3) == b"\x00"
    got, _ = jax_restore(str(tmp_path), {"a": np.zeros((2, 3), np.float32),
                                         "b": {"c": jnp.zeros(4, jnp.bfloat16)}})
    np.testing.assert_array_equal(got["a"], np.arange(6.0).reshape(2, 3))


def test_zstd_shard_without_zstandard_raises(tmp_path, monkeypatch):
    if ckpt_mod.zstandard is None:
        pytest.skip("zstandard is not installed: no zstd shard to write")
    t = _torch_tree(_np_tree())
    save(str(tmp_path), t, step=1)
    monkeypatch.setattr(ckpt_mod, "zstandard", None)
    with pytest.raises(RuntimeError, match="zstandard"):
        restore(str(tmp_path), t)


# ---------------------------------------------------------------------------
# resume, mismatches, garbage collection
# ---------------------------------------------------------------------------


def test_latest_step_and_default_restore(tmp_path):
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path), {"a": torch.zeros(1)})
    t = {"a": torch.zeros(2)}
    for s in (1, 5, 3):
        save(str(tmp_path), {"a": torch.full((2,), float(s))}, step=s)
    os.makedirs(tmp_path / "step_00000009.tmp")  # a torn write is no step
    assert latest_step(str(tmp_path)) == 5
    got, step = restore(str(tmp_path), t)
    assert step == 5 and torch.equal(got["a"], torch.full((2,), 5.0))
    got, step = restore(str(tmp_path), t, step=3)
    assert step == 3 and torch.equal(got["a"], torch.full((2,), 3.0))


@pytest.mark.parametrize("template,match", [
    ({"params": {"w": torch.zeros(2, 2)}}, "leaf count mismatch"),
    (dict(_torch_tree(_np_tree()), ids=torch.zeros(70, 1000, dtype=torch.int64)), "mismatch"),
], ids=["leaf-count", "shape"])
def test_restore_rejects_a_template_off_the_checkpoint(tmp_path, template, match):
    save(str(tmp_path), _torch_tree(_np_tree()), step=1)
    with pytest.raises(ValueError, match=match):
        restore(str(tmp_path), template)


def test_restore_rejects_a_foreign_payload(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt_mod, "zstandard", None)
    d = tmp_path / "step_00000001"
    d.mkdir()
    (d / "shard_0.msgpack.zst").write_bytes(b"\x00" + msgpack.packb({"magic": "other"}))
    with pytest.raises(ValueError, match="corrupt"):
        restore(str(tmp_path), {"a": torch.zeros(1)})


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_async_checkpointer_keeps_the_last_saves(tmp_path, keep):
    ck = AsyncCheckpointer(str(tmp_path / "port"), keep=keep)
    ref = JaxAsyncCheckpointer(str(tmp_path / "jax"), keep=keep)
    for s in range(5):
        ck.save({"a": torch.full((3,), float(s))}, step=s)
        ref.save({"a": jnp.full((3,), float(s))}, step=s)
    ck.close()
    ref.wait()
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert latest_step(str(tmp_path / "port")) == 4


def test_async_checkpointer_writes_the_snapshot_not_later_updates(tmp_path):
    # the loop updates its tensors in place right after save() returns: the
    # shard holds the values at the call
    w = torch.arange(1_000_000, dtype=torch.float32)
    state = {"w": w, "step": torch.zeros((), dtype=torch.int32)}
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(state, step=1)
    w.add_(1.0)
    state["step"] += 5
    ck.close()
    got, _ = restore(str(tmp_path), state)
    assert torch.equal(got["w"], torch.arange(1_000_000, dtype=torch.float32))
    assert int(got["step"]) == 0


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


def _grads(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 16), dtype=np.float32) * 0.1,
            "layers": {"b": rng.standard_normal((2, 5), dtype=np.float32) * 3.0}}


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_quantize_matches_reference(dtype):
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    q, scale = quantize(torch.from_numpy(x), getattr(torch, dtype))
    jq, jscale = jax_quantize(jnp.asarray(x), getattr(jnp, dtype))
    assert q.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(q.float().numpy(), np.asarray(jq, np.float32))
    assert float(scale) == pytest.approx(float(jscale), rel=1e-7)
    np.testing.assert_array_equal(dequantize(q, scale).numpy(),
                                  np.asarray(jax_dequantize(jq, jscale)))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_error_feedback_matches_reference_over_steps(dtype):
    res = jax.tree_util.tree_map(np.zeros_like, _grads(0))
    tres = jax.tree_util.tree_map(torch.from_numpy, res)
    jres = jax.tree_util.tree_map(jnp.asarray, res)
    for s in range(5):
        g = _grads(s + 1)
        deq, tres = ef_compress_grads(jax.tree_util.tree_map(torch.from_numpy, g), tres,
                                      getattr(torch, dtype))
        jdeq, jres = jax_ef_compress_grads(jax.tree_util.tree_map(jnp.asarray, g), jres,
                                           getattr(jnp, dtype))
        assert set(deq) == set(g) and set(tres["layers"]) == {"b"}
        for a, b in zip(tree_leaves(deq) + tree_leaves(tres),
                        jax.tree_util.tree_leaves(jdeq) + jax.tree_util.tree_leaves(jres)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)


@pytest.fixture
def gloo_world_of_one(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_compressed_psum_matches_reference_shard_map(gloo_world_of_one, dtype):
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    x = np.linspace(-1.0, 1.0, 16, dtype=np.float32) * np.float32(0.37)
    mesh = Mesh(np.array(jax.devices()[:1]), ("d",))
    want = shard_map(lambda xs: jax_compressed_psum(xs[0], "d", getattr(jnp, dtype))[None],
                     mesh=mesh, in_specs=P("d", None), out_specs=P("d", None))(
        jnp.asarray(x)[None])
    got = compressed_psum(torch.from_numpy(x), dtype=getattr(torch, dtype))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want[0]), atol=1e-7, rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), x, atol=2e-2)


# ---------------------------------------------------------------------------
# straggler monitor, elastic plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("threshold,warmup", [(2.0, 3), (1.5, 5), (3.0, 0)])
def test_straggler_monitor_decides_as_reference(threshold, warmup):
    rng = np.random.default_rng(int(threshold * 10) + warmup)
    durs = np.where(rng.random(60) < 0.1, 0.5, 0.1) * (1 + 0.05 * rng.random(60))
    mine = StragglerMonitor(threshold=threshold, warmup_steps=warmup)
    ref = JaxStragglerMonitor(threshold=threshold, warmup_steps=warmup)
    for d in durs:
        assert mine.observe(float(d)) == ref.observe(float(d))
    assert (mine.flagged, mine.ewma, mine.n) == (ref.flagged, ref.ewma, ref.n)
    assert mine.flagged > 0


def test_elastic_plans_equal_reference():
    assert LADDER == JAX_LADDER
    for n in range(1, 600):
        mine, ref = plan_mesh(n), jax_plan_mesh(n)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref), n
        assert mine.multi_pod == ref.multi_pod
    with pytest.raises(RuntimeError):
        plan_mesh(0)
