"""The port's attention kernels against the JAX package: the same numpy
inputs go through the Pallas kernels (interpret mode), the JAX package's
chunked XLA variants and its dense oracle, and through the port's wrappers
(their plain versions on the CPU) and torch variants, at F32TOL. The CUDA
kernels themselves run only on the card (tests/test_torch_gpu.py,
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import model_kernels as jmk
from repro.kernels import spaces as jspaces
from repro.kernels.decode_attention import chunked_decode_xla as jax_chunked_decode
from repro.kernels.decode_attention import decode_attention as jax_decode_attention
from repro.kernels.decode_attention import decode_ref as jax_decode_ref
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.models.attention import gqa_attention as jax_gqa_attention
from repro.models.attention import gqa_decode as jax_gqa_decode
from repro_torch.dispatch import DispatchService
from repro_torch.kernels import model_kernels as mk
from repro_torch.kernels import ops, problems, spaces
from repro_torch.kernels.decode_attention import (
    CacheRows,
    chunked_decode_xla,
    decode_attention,
    decode_attention_head_groups,
    decode_attention_plain,
    decode_mask,
    decode_ref,
)
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_head_size
from repro_torch.kernels.util import ConfigRejected
from repro_torch.models.attention import gqa_attention, gqa_decode

F32TOL = dict(atol=2e-3, rtol=2e-3)   # tests/test_kernels.py:30


def _normal(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).float()),
                               np.asarray(want, np.float32), **F32TOL)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Sq,Sk", [(40, 40), (37, 53), (64, 29)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [16, 64, 128, 256])
def test_flash_matches_pallas_and_chunked(Sq, Sk, causal, hd):
    q, k, v = _normal((3, Sq, hd), (3, Sk, hd), (3, Sk, hd), seed=Sq + Sk + hd)
    want = jax_flash_attention(*_j(q, k, v), causal=causal, bq=16, bk=16, interpret=True)
    got = flash_attention(*_t(q, k, v), causal=causal, bq=16, bk=16)
    assert got.shape == (3, Sq, hd) and got.dtype == torch.float32
    _close(got, want)
    _close(mk.chunked_attention_xla(*_t(q, k, v), causal=causal, bq=16),
           jmk.chunked_attention_xla(*_j(q, k, v), causal=causal, bq=16))
    _close(got, jmk.chunked_attention_xla(*_j(q, k, v), causal=causal, bq=32))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_flash_builders_match_reference_builders(impl):
    q, k, v = _normal((2, 33, 16), (2, 33, 16), (2, 33, 16), seed=5)
    cfg = dict(impl=impl, bq=16, bk=32)
    want = jmk.flash_attention_builder(cfg, causal=True)(*_j(q, k, v))
    built = mk.flash_attention_builder(cfg, causal=True)
    built.check(*_t(q, k, v))
    _close(built(*_t(q, k, v)), want)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------


def _decode_inputs(BH, G, S, hd, ring, seed):
    q, k, v = _normal((BH, G, hd), (BH, S, hd), (BH, S, hd), seed=seed)
    wrap = S + 25 if ring else S - 1
    cur = np.array([0, 13, wrap, S - 1, 7, -1][:BH], np.int32)
    return q, k, v, cur


@pytest.mark.parametrize("ring,window", [(False, 0), (True, 0), (False, 7), (True, 7)])
@pytest.mark.parametrize("G,hd", [(7, 16), (2, 64), (3, 128), (8, 256)])
def test_decode_matches_pallas_xla_and_ref(ring, window, G, hd):
    q, k, v, cur = _decode_inputs(6, G, 40, hd, ring, seed=G + hd)
    kw = dict(ring=ring, window=window)
    for bk, hg in ((16, 1), (64, 2), (8, 4)):
        want = jax_decode_attention(*_j(q, k, v, cur), bk=bk, hg=hg, interpret=True, **kw)
        got = decode_attention(*_t(q, k, v, cur), bk=bk, hg=hg, **kw)
        _close(got, want)
        assert torch.count_nonzero(got[5]) == 0          # cur_pos = -1: exactly 0
    for bk in (8, 40, 128):
        _close(chunked_decode_xla(*_t(q, k, v, cur), bk=bk, **kw),
               jax_chunked_decode(*_j(q, k, v, cur), bk=bk, **kw))
    # the dense oracle, on the rows that have a valid slot (it gives a row
    # with none a uniform softmax)
    ref = decode_ref(*_t(q, k, v, cur), **kw)
    _close(ref, jax_decode_ref(*_j(q, k, v, cur), **kw))
    _close(got[:5], ref[:5])


def _split_and_combine(q, k, v, cur, *, splits, bk, ring, window):
    """The CUDA kernel's rule in torch: the key axis in ``splits`` splits of
    whole ``bk`` blocks, each a partial (m, l, acc) with p = 0 on masked
    slots (a split with no valid slot gives m = -1e30, l = 0, acc = 0), then
    merged: M = max m_s, L = sum l_s exp(m_s - M),
    O = sum acc_s exp(m_s - M) / max(L, 1e-30). Returns O and the number of
    (row, split) pairs that held no valid slot."""
    BH, G, hd = q.shape
    S = k.shape[1]
    span = -(-(-(-S // bk)) // splits) * bk
    cp = cur.reshape(BH, 1, 1)
    parts, empty = [], 0
    for s in range(splits):
        a, b = s * span, min(S, (s + 1) * span)
        slots = torch.arange(a, max(a, b), dtype=torch.int32).reshape(1, 1, -1)
        _, valid = decode_mask(slots, cp, s_real=S, ring=ring, window=window)
        sc = torch.einsum("bgh,bsh->bgs", q, k[:, a:b]) * hd ** -0.5
        sc = torch.where(valid, sc, -1.0e30)
        m = torch.cat([sc, torch.full((BH, G, 1), -1.0e30)], -1).amax(-1, keepdim=True)
        p = torch.where(valid, torch.exp(sc - m), 0.0)
        parts.append((m, p.sum(-1, keepdim=True), torch.einsum("bgs,bsh->bgh", p, v[:, a:b])))
        empty += int((~valid.any(-1)).any(-1).sum())
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = sum(l * torch.exp(m - M) for m, l, _ in parts)
    O = sum(acc * torch.exp(m - M) for m, _, acc in parts)
    return O / L.clamp_min(1e-30), empty


@pytest.mark.parametrize("ring,window", [(False, 0), (True, 0), (False, 7), (True, 7)])
@pytest.mark.parametrize("splits", [1, 3, 5])
def test_decode_split_and_combine_matches_pallas_and_plain(splits, ring, window):
    # (6, 7, 40, 16) in 8-slot blocks: 5 splits of 8 slots, 3 of 16, 16 and
    # 8 (40 is not a multiple of the split), 1 of 40
    q, k, v, cur = _decode_inputs(6, 7, 40, 16, ring, seed=splits)
    got, empty = _split_and_combine(*_t(q, k, v, cur), splits=splits, bk=8, ring=ring,
                                    window=window)
    want = jax_decode_attention(*_j(q, k, v, cur), bk=8, hg=1, ring=ring, window=window,
                                interpret=True)
    _close(got, want)
    _close(got, decode_attention_plain(*_t(q, k, v, cur), ring=ring, window=window))
    assert torch.count_nonzero(got[5]) == 0          # cur_pos = -1: exactly 0
    assert empty >= (splits if splits > 1 else 1)    # splits with no valid slot add nothing


def test_decode_scalar_position_broadcasts():
    q, k, v, _ = _decode_inputs(4, 3, 24, 16, False, seed=3)
    want = jax_decode_attention(*_j(q, k, v), 17, interpret=True)
    _close(decode_attention(*_t(q, k, v), 17), want)
    _close(decode_attention(*_t(q, k, v), torch.tensor([17], dtype=torch.int32)), want)


def test_cache_rows_view_matches_flattened_cache():
    B, S, K, G, hd = 2, 32, 2, 7, 16
    q, kc, vc = _normal((B * K, G, hd), (B, S, K, hd), (B, S, K, hd), seed=9)
    kf = kc.transpose(0, 2, 1, 3).reshape(B * K, S, hd)
    vf = vc.transpose(0, 2, 1, 3).reshape(B * K, S, hd)
    cur = np.array([3, 3, 31, 31], np.int32)
    rows = CacheRows(torch.from_numpy(kc))
    assert rows.shape == (B * K, S, hd)
    np.testing.assert_array_equal(rows.rows().numpy(), kf)
    want = jax_decode_attention(*_j(q, kf, vf, cur), interpret=True)
    got = decode_attention(torch.from_numpy(q), rows, CacheRows(torch.from_numpy(vc)),
                           torch.from_numpy(cur))
    _close(got, want)
    _close(chunked_decode_xla(torch.from_numpy(q), rows, CacheRows(torch.from_numpy(vc)),
                              torch.from_numpy(cur), bk=8), want)


# ---------------------------------------------------------------------------
# the model-level attention paths (the dispatch route and the tensor-op one)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 5])
def test_gqa_attention_matches_reference(window):
    B, S, K, G, hd = 2, 19, 2, 7, 16
    q, k, v = _normal((B, S, K * G, hd), (B, S, K, hd), (B, S, K, hd), seed=11)
    want = jax_gqa_attention(*_j(q, k, v), window=window, chunk=8)
    _close(gqa_attention(*_t(q, k, v), window=window, chunk=8), want)
    if window is None:
        svc = DispatchService()
        _close(gqa_attention(*_t(q, k, v), service=svc), want)
        assert svc.stats["store_default"] == 1


@pytest.mark.parametrize("ring,cur", [(False, 23), (True, 23), (True, 100)])
def test_gqa_decode_matches_reference(ring, cur):
    B, S, K, G, hd = 2, 32, 2, 7, 16
    q, kc, vc = _normal((B, 1, K * G, hd), (B, S, K, hd), (B, S, K, hd), seed=12)
    want = jax_gqa_decode(*_j(q, kc, vc), cur, ring=ring)
    _close(gqa_decode(*_t(q, kc, vc), cur, ring=ring), want)
    _close(gqa_decode(*_t(q, kc, vc), cur, ring=ring, service=DispatchService()), want)
    vec = np.array([cur, 5], np.int32)
    want = jax_gqa_decode(*_j(q, kc, vc), jnp.asarray(vec), ring=ring)
    _close(gqa_decode(*_t(q, kc, vc), torch.from_numpy(vec), ring=ring,
                      service=DispatchService()), want)


# ---------------------------------------------------------------------------
# spaces, problems, ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention", "matmul"])
def test_model_kernel_spaces(name):
    host, jhost = spaces.kernel_space(name, "host"), jspaces.kernel_space(name, "host")
    assert host.default_configuration() == jhost.default_configuration()
    assert host.param_names == jhost.param_names and host.cardinality() == jhost.cardinality()
    gpu_space = spaces.kernel_space(name, "gpu")
    gpu = gpu_space.default_configuration()
    assert gpu == ops.DEFAULTS[name]
    assert gpu.get("impl", "pallas") == "pallas"
    # the card's campaigns tune the kernel only, and no knob that nothing reads
    if "impl" in gpu_space.param_names:
        assert gpu_space["impl"].choices == ("pallas",)
    assert "page" not in gpu_space.param_names
    assert problems.LARGE_SHAPES[name] == {
        "flash_attention": (16, 4096, 4096, 128), "decode_attention": (16, 8, 4096, 128),
        "matmul": (2000, 2300, 2600)}[name]


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention", "matmul"])
def test_model_kernel_problems_run_on_the_cpu(name):
    factory = problems.gpu_problem(name, problems.BENCH_DIMS[name], device="cpu")
    fn, args = factory(spaces.kernel_space(name, "host").default_configuration())
    out = fn(*args)
    assert torch.isfinite(out).all()
    sig = tuple(tuple(a.shape) for a in args)
    dims = problems.BENCH_DIMS[name]
    if name == "flash_attention":
        assert sig == mk.flash_attention_signature(*dims)[:3]
    elif name == "decode_attention":
        assert sig == mk.decode_attention_signature(*dims)[:4]


def test_signatures_match_reference():
    assert mk.flash_attention_signature(8, 256, 256, 64) == \
        jmk.flash_attention_signature(8, 256, 256, 64)
    assert mk.flash_attention_signature(8, 10, 20, 64, causal=False) == \
        jmk.flash_attention_signature(8, 10, 20, 64, causal=False)
    for ring, window in ((False, 0), (True, 0), (True, 128)):
        assert mk.decode_attention_signature(8, 7, 384, 64, ring=ring, window=window) == \
            jmk.decode_attention_signature(8, 7, 384, 64, ring=ring, window=window)


def test_matmul_builder_matches_reference_mold():
    a, b = mk.init_matmul(40, 30, 50, seed=2)
    for pack in (True, False):
        cfg = dict(bm=16, bn=32, bk=8, pack=pack, interchange=True)
        _close(mk.matmul_builder(cfg)(*_t(a, b)), jmk.matmul_builder(cfg)(*_j(a, b)))


# ---------------------------------------------------------------------------
# head sizes on the card: flash's padded size, decode's launch groups
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd,want", [(1, 16), (16, 16), (17, 32), (64, 64), (80, 128),
                                     (96, 128), (112, 128), (128, 128), (160, 256),
                                     (192, 256), (256, 256)])
def test_flash_head_size_pads_to_the_next_instantiation(hd, want):
    assert flash_attention_head_size(hd) == want


@pytest.mark.parametrize("hd", [0, 257, 512])
def test_flash_head_size_rejects_past_256(hd):
    with pytest.raises(ConfigRejected, match="head sizes"):
        flash_attention_head_size(hd)


@pytest.mark.parametrize("G,hd,want", [
    (7, 64, [(0, 7)]),
    (32, 64, [(0, 32)]),                       # 8 * 256 / 64 = 32: one launch
    (33, 64, [(0, 16), (16, 33)]),             # just past it: two even groups
    (9, 256, [(0, 4), (4, 9)]),                # hd 256 takes 8 a launch
    (25, 80, [(0, 25)]),                       # 2048 // 80 = 25
    (26, 80, [(0, 13), (13, 26)]),
    (40, 192, [(0, 10), (10, 20), (20, 30), (30, 40)]),  # 10 a launch
])
def test_decode_head_groups(G, hd, want):
    groups = decode_attention_head_groups(G, hd)
    assert groups == want
    assert all(g1 - g0 <= 8 * 256 // hd for g0, g1 in groups)


@pytest.mark.parametrize("hd", [8, 72, 100, 272])
def test_decode_head_groups_reject_other_head_sizes(hd):
    # a head size off the multiples of 16 runs at the next one, round_up(hd,
    # 16), and takes that many heads a launch; only past 256 is one refused
    if hd > 256:
        with pytest.raises(ConfigRejected, match="from 1 to 256"):
            decode_attention_head_groups(4, hd)
        return
    padded = -(-hd // 16) * 16
    groups = decode_attention_head_groups(40, hd)
    assert groups[0][0] == 0 and groups[-1][1] == 40
    assert max(g1 - g0 for g0, g1 in groups) <= 8 * 256 // padded
    assert len(groups) == -(-40 // (8 * 256 // padded))


@pytest.mark.parametrize("hd", [80, 96, 112, 160, 192])
def test_flash_and_decode_take_other_head_sizes_on_the_cpu(hd):
    # the head sizes the card now runs (padded, or in groups): the wrappers'
    # plain versions against the JAX package's Pallas kernels (interpret)
    q, k, v = _normal((2, 40, hd), (2, 40, hd), (2, 40, hd), seed=hd)
    _close(flash_attention(*_t(q, k, v), causal=True, bq=16, bk=16),
           jax_flash_attention(*_j(q, k, v), causal=True, bq=16, bk=16, interpret=True))
    qd, kd, vd = _normal((2, 3, hd), (2, 50, hd), (2, 50, hd), seed=hd + 1)
    cp = np.array([30, 49], np.int32)
    _close(decode_attention(*_t(qd, kd, vd), torch.from_numpy(cp), ring=False, bk=16),
           jax_decode_attention(*_j(qd, kd, vd), jnp.asarray(cp), ring=False, bk=16,
                                interpret=True))
