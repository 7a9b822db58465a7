"""The model matmul's routes as the CPU-side models see them: the cost
model's route, split count and padding (``kernels/cost.py``), and the
Hopper feasibility warnings (``analyze/feasibility.py:TileAlign``,
``PaddingWaste``), against what ``csrc/matmul.cu`` does: tiles of at most
8 rows on the split stream, bf16 past 8 rows with pack on (K and N
multiples of 8) on wgmma, the rest on mma.sync. No card needed."""

import pytest
import torch

from repro_torch.analyze import feasibility as feas
from repro_torch.kernels import cost

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("M,K,N,bm,pack,size,want", [
    (4, 896, 896, 64, True, 2, "split"), (4, 896, 896, 64, False, 4, "split"),
    (1, 4096, 4096, 128, True, 4, "split"), (512, 896, 896, 8, True, 2, "split"),
    (512, 896, 896, 64, True, 2, "wgmma"), (20, 4096, 4096, 16, True, 2, "wgmma"),
    (512, 896, 896, 64, False, 2, "mma_sync"), (256, 1280, 51866, 64, True, 2, "mma_sync"),
    (256, 1282, 1024, 64, True, 2, "mma_sync"), (512, 896, 896, 64, True, 4, "mma_sync")])
def test_the_route_follows_the_kernels_rule(M, K, N, bm, pack, size, want):
    assert cost.matmul_route(M, K, N, bm, pack, size) == want


@pytest.mark.parametrize("M,K,N,size,pack,want", [
    (4, 4096, 4096, 2, True, 7),      # mixtral's output projection: 64 tiles, one wave
    (4, 896, 896, 2, True, 8),        # qwen2's: 14 tiles, K / 64 = 14
    (4, 3584, 3584, 2, True, 8),      # qwen2-vl's: 56 tiles
    (4, 896, 151936, 2, True, 1),     # an unembed fills the card with its tiles
    (4, 4096, 32000, 2, True, 1),     # 500 tiles: one wave of 528 places
    (4, 1536, 50280, 4, True, 3),     # 786 tiles: a split evens out two waves
    (4, 5120, 102400, 4, True, 4),
    (4, 4096, 4096, 4, False, 1),     # pack=False runs unsplit
    (4, 100, 64, 2, True, 1),         # K below two pieces of 64
    (4, 200, 64, 2, True, 3)])
def test_the_split_count(M, K, N, size, pack, want):
    """The least modelled time: waves of CTAs (4 an SM, 15/16 of them in
    clusters) x a CTA's share of its tile's bytes plus its fixed cost."""
    assert cost.matmul_splits(M, K, N, min(64, M), 64, pack, 132, size) == want


def test_the_split_route_is_bound_by_bs_bytes_in_both_dtypes():
    """The decode's products on the split stream: the CUDA cores' rate,
    bytes-bound, bf16 moving half of f32's bytes; its blocks count the
    split (mixtral's output projection: 64 column tiles x 7)."""
    hw = cost.H100_SXM5
    for dtype, size in ((F32, 4), (BF, 2)):
        t, info = cost.matmul_cost(dict(bm=64, bn=64, bk=32, pack=True), 4, 4096, 4096,
                                   dtype=dtype)
        assert info["peak"] == cost.FFMA_FLOPS
        b_bytes = 4096 * 4096 * size
        # B, plus the model's A panels (re-read a column tile, streamed
        # where the operands pass the L2) and the output
        assert b_bytes <= info["hbm_bytes"] < 1.1 * b_bytes
        assert t >= b_bytes / hw.hbm_bytes_per_sec
        assert info["flops"] / cost.FFMA_FLOPS < b_bytes / hw.hbm_bytes_per_sec
    ln = cost._matmul_launch(hw, 4, 4096, 4096, 4, 64, 32, True, None, in_bytes=2)
    assert ln.blocks == 64 * 7 and ln.threads == 128 and not ln.tensor_cores
    # rows pad to 4 (or 8 past 4), columns to a thread's 16 bytes
    assert ln.work == 2.0 * 64 * 4 * 64 * 4096
    ln8 = cost._matmul_launch(hw, 6, 4096, 4100, 8, 60, 32, False, None, in_bytes=2)
    assert ln8.blocks == 69 and ln8.work == 2.0 * 69 * 8 * 64 * 4096


def test_the_wgmma_route_runs_at_the_bf16_peak_on_its_64_padding():
    """bf16 past 8 rows with pack on: rows pad to 64 or 128, columns to 64
    or 128, the chunk rounds up to 16 k of the operands (no zeros: only K's
    last chunk pads); pack off keeps mma.sync's 32 x 32 pieces and its
    chunk padded to 16."""
    hw = cost.H100_SXM5
    ln = cost._matmul_launch(hw, 512, 4096, 4096, 40, 80, 24, True, None, in_bytes=2)
    assert ln.tensor_cores and ln.peak == cost.BF16_FLOPS and ln.threads == 160
    assert ln.work == 2.0 * (13 * 52) * 64 * 128 * 4096
    ln2 = cost._matmul_launch(hw, 512, 4096, 4096, 128, 128, 4, True, None, in_bytes=2)
    assert ln2.threads == 288 and ln2.work == 2.0 * (4 * 32) * 128 * 128 * 4096
    ln3 = cost._matmul_launch(hw, 512, 4104, 4096, 128, 128, 32, True, None, in_bytes=2)
    assert ln3.work == 2.0 * (4 * 32) * 128 * 128 * 129 * 32  # K's last chunk: 8 of 32
    rmw = cost._matmul_launch(hw, 512, 4096, 4096, 40, 80, 24, False, None, in_bytes=2)
    assert rmw.work == 2.0 * (13 * 52) * 64 * 96 * 171 * 32
    # the bf16 forward's products model faster on wgmma than on mma.sync
    t_w = cost.matmul_cost(dict(bm=64, bn=64, bk=24, pack=True), 512, 4096, 4096, dtype=BF)
    t_m = cost.matmul_cost(dict(bm=64, bn=64, bk=24, pack=False), 512, 4096, 4096, dtype=BF)
    assert t_w[0] < t_m[0] and t_w[1]["peak"] == cost.BF16_FLOPS


def _warned(cfg, dims, dtype, target="gpu"):
    v = feas.check_config("matmul", cfg, dims=dims, target=target, dtype=dtype)
    assert v.ok
    return {f.code.split(":")[-1]: f.message for f in v.warnings
            if f.code.startswith("tile_misaligned")}


def test_tile_warnings_follow_the_wgmma_route():
    """bf16, pack on, K and N multiples of 8: rows and columns pad to 64, a
    chunk of 24 pads nothing; the same tile with pack off pads as mma.sync
    does (32-wide pieces, the chunk to 16)."""
    cfg, dims = dict(bm=96, bn=48, bk=24, pack=True), (512, 896, 896)
    w = _warned(cfg, dims, BF)
    assert set(w) == {"bm", "bn"}
    assert "pads to 128 in the wgmma route's 64-row warpgroups" in w["bm"]
    assert "pads to 64 in the wgmma route's 64-column boxes" in w["bn"]
    w = _warned(dict(cfg, pack=False), dims, BF)
    assert set(w) == {"bn", "bk"} and "pads to 64" in w["bn"] and "pads to 32" in w["bk"]
    # N off a multiple of 8 (whisper's vocab): TMA cannot take it, mma.sync runs
    w = _warned(cfg, (512, 1280, 51866), BF)
    assert set(w) == {"bn", "bk"}
    # f32 past 8 rows: mma.sync, 24 a multiple of its k of 8
    assert set(_warned(cfg, dims, F32)) == {"bn"}
    # unknown dtype: the smaller padding of the two routes (mma.sync's 32
    # rows and columns, wgmma's unpadded chunk)
    assert set(_warned(cfg, dims, None)) == {"bn"}


def test_tile_warnings_of_the_split_route_pad_no_chunk():
    """At most 8 rows (the decode): the split stream pads no chunk, in
    either dtype; a tile off the 8-element grid still warns."""
    for dtype in (BF, F32, None):
        assert _warned(dict(bm=64, bn=64, bk=4, pack=True), (4, 896, 896), dtype) == {}
        assert set(_warned(dict(bm=64, bn=60, bk=4, pack=False), (4, 896, 896), dtype)) \
            == {"bn"}


def test_mm3_and_lu_keep_the_f32_route():
    """mm3's and lu's products are f32: their chunks pad to mma.sync's k of 8
    whatever the call's dtype, never to wgmma's rows."""
    v = feas.check_config("mm3", dict(bm=96, bn=64, bk=4), dims=(800, 900, 1000, 1100, 1200),
                          target="gpu")
    codes = {f.code for f in v.warnings}
    assert "tile_misaligned:bk" in codes and "tile_misaligned:bm" not in codes


@pytest.mark.parametrize("pack,warns", [(True, False), (False, True)])
def test_padding_waste_follows_the_route(pack, warns):
    """A chunk of 4 in bf16: wgmma rounds it up with the operands' own k (no
    waste); mma.sync pads it to 16 (4x the work)."""
    cfg, dims = dict(bm=64, bn=64, bk=4, pack=pack), (512, 896, 896)
    _, info = cost.matmul_cost(cfg, *dims, dtype=BF)
    assert info["padded_work"] / info["flops"] == pytest.approx(4.0 if not pack else 1.0)
    v = feas.check_config("matmul", cfg, dims=dims, target="cost", dtype=BF)
    assert any(f.code == "padding_waste" for f in v.warnings) == warns
