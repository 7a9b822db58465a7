"""repro_torch.analyze against repro.analyze: the concurrency lint (every
REP101-REP105 and pragma fixture of tests/test_analyze.py gives the same
codes at the same lines under both linters, and the port lints clean — its
tier-1 gate), the feasibility pass on the ``host`` target (the port's
errors are the JAX package's, its warnings the JAX package's less
``padding_waste``: the port pads no dim to ``lcm(bi, bj)``), the Hopper
warnings of the ``gpu`` and ``cost`` targets (``tile_misaligned:<name>``,
``padding_waste``; warn-only, so they never prune), and the
``launch.analyze`` CLI's JSON in the JAX package's keys."""

import json
import os
import textwrap

import numpy as np
import pytest

from repro.analyze import feasibility as jfeas
from repro.analyze.lint import lint_source as jlint_source
from repro.kernels.spaces import kernel_space as jkernel_space
from repro.launch.analyze import main as janalyze_main
from repro_torch.analyze import feasibility as feas
from repro_torch.analyze.lint import lint_paths, lint_source
from repro_torch.kernels.cost import KERNEL_COST_FNS
from repro_torch.kernels.problems import BENCH_DIMS, LARGE_SHAPES
from repro_torch.kernels.spaces import KERNEL_SPACES, kernel_space
from repro_torch.launch.analyze import main as analyze_main

# ---------------------------------------------------------------------------
# the lint: tests/test_analyze.py's fixtures under both linters
# ---------------------------------------------------------------------------

_REP101 = """
import time

class Agent:
    def lag(self):
        return time.time() - self.last_sync
"""
_REP102 = """
import threading

class Store:
    def __init__(self):
        self._tlock = threading.Lock()
        self._access = {}

    def put(self, k, v):
        with self._tlock:
            self._access[k] = v

    def get(self, k):
        self._access[k] = 1   # unguarded
        return k
"""
_REP103 = """
class Broker:
    def __init__(self, store: TuningStore, oplog: OpLog):
        self.store = store
        self.oplog = oplog

    def publish(self):
        with self.oplog._lock:
            with self.store._lock:
                pass
"""
_REP104 = """
import threading

class Runner:
    def start(self):
        self._t = threading.Thread(target=self._run)
        self._t.start()
"""
_REP105 = """
import threading

class Agent:
    def start(self):
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            try:
                self.step()
            except Exception:
                pass
"""
_PRAGMA = """
import time

class Rec:
    def age(self):
        # lint: allow=REP101 persisted stamps are cross-process wall-clock
        return time.time() - self.created
"""

LINT_FIXTURES = {
    "rep101_wallclock_duration": (_REP101, ["REP101"]),
    "rep101_monotonic_fix": (_REP101.replace("time.time()", "time.monotonic()"), []),
    "rep101_from_time_import": ("""
from time import time

def age(t0):
    return time() - t0
""", ["REP101"]),
    "rep102_unguarded_mutation": (_REP102, ["REP102"]),
    "rep102_guarded_fix": (_REP102.replace(
        "self._access[k] = 1   # unguarded",
        "with self._tlock:\n            self._access[k] = 1"), []),
    "rep102_locked_helpers_inherit_protection": ("""
import threading

class Store:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def bump(self):
        with self._lock:
            self._n += 1
            self._sweep_locked()

    def _sweep_locked(self):
        self._n = 0
""", []),
    "rep103_lock_order_inversion": (_REP103, ["REP103"]),
    "rep103_documented_order": (_REP103.replace(
        "with self.oplog._lock:\n            with self.store._lock:",
        "with self.store._lock:\n            with self.oplog._lock:"), []),
    "rep103_through_method_call": ("""
class Broker:
    def __init__(self, store: TuningStore, oplog: OpLog):
        self.store = store
        self.oplog = oplog

    def publish(self, rec):
        with self.oplog._lock:
            self.store.put(rec)
""", ["REP103"]),
    "rep104_unowned_thread": (_REP104, ["REP104"]),
    "rep104_daemon": (_REP104.replace("target=self._run", "target=self._run, daemon=True"), []),
    "rep104_stop_handler": (_REP104 + """
    def stop(self):
        self._t.join()
""", []),
    "rep105_runloop_swallow": (_REP105, ["REP105"]),
    "rep105_counted": (_REP105.replace("pass", 'self.stats["errors"] += 1'), []),
    "rep105_reraised": (_REP105.replace("pass", "raise"), []),
    "rep105_narrow_except": (_REP105.replace("except Exception:", "except ValueError:"), []),
    "rep105_reaches_helpers_called_from_the_loop": ("""
import threading

class Agent:
    def start(self):
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        while True:
            self._tick()

    def _tick(self):
        try:
            self.sync()
        except Exception:
            return None
""", ["REP105"]),
    "rep105_ignores_loops_outside_threads": ("""
class Loader:
    def load_all(self, paths):
        out = []
        for p in paths:
            try:
                out.append(self.parse(p))
            except Exception:
                continue
        return out
""", []),
    "rep105_counter_call_accounts": ("""
import threading

class Agent:
    def start(self):
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        while True:
            try:
                self.step()
            except Exception:
                self.registry.add("errors_total")
""", []),
    "pragma_allowlists_a_finding": (_PRAGMA, []),
    "pragma_silences_only_its_code": (_PRAGMA.replace("allow=REP101", "allow=REP104"),
                                      ["REP101"]),
}


@pytest.mark.parametrize("name", sorted(LINT_FIXTURES))
def test_lint_fixture_matches_the_reference(name):
    src, codes = LINT_FIXTURES[name]
    src = textwrap.dedent(src)
    ours = [(f.code, f.line, f.message) for f in lint_source(src)]
    theirs = [(f.code, f.line, f.message) for f in jlint_source(src)]
    assert ours == theirs
    assert [code for code, _, _ in ours] == codes


def test_lint_tree_is_clean():
    """Tier-1 gate: the port holds its own documented concurrency
    invariants. New findings must be fixed or explicitly pragma'd."""
    import repro_torch

    pkg = os.path.dirname(os.path.abspath(repro_torch.__file__))
    findings = lint_paths([pkg])
    assert findings == [], "\n".join(f.format() for f in findings)


def test_lint_ranks_and_receivers_are_the_references():
    from repro.analyze import lint as jlint
    from repro_torch.analyze import lint

    assert lint.LOCK_RANKS == jlint.LOCK_RANKS == {"TuningStore": 0, "OpLog": 1}
    assert lint.ATTR_TYPES == jlint.ATTR_TYPES


# ---------------------------------------------------------------------------
# feasibility on the host target: the reference's verdicts less padding_waste
# ---------------------------------------------------------------------------


def _samples(kernel: str, seed: int) -> list[dict]:
    """The default and 24 seeded samples of the host space, from each
    package's space (the port's host flavour is the JAX package's)."""
    out = []
    for space_of in (jkernel_space, kernel_space):
        space = space_of(kernel, target="host", seed=seed)
        rng = np.random.default_rng(seed)
        out += [space.default_configuration()] + space.sample_configurations(24, rng)
    return out


@pytest.mark.parametrize("dims_of", ["bench", "large"])
@pytest.mark.parametrize("kernel", sorted(KERNEL_SPACES))
def test_host_verdicts_equal_the_reference_less_padding_waste(kernel, dims_of):
    dims = (BENCH_DIMS if dims_of == "bench" else LARGE_SHAPES)[kernel]
    for cfg in _samples(kernel, seed=7):
        ours = feas.check_config(kernel, cfg, dims=dims, target="host")
        theirs = jfeas.check_config(kernel, cfg, dims=dims, target="host")
        assert ours.reasons == theirs.reasons, cfg
        assert [f.code for f in ours.warnings] == \
            [f.code for f in theirs.warnings if f.code != "padding_waste"], cfg


@pytest.mark.parametrize("kernel,cfg,dims,code", [
    ("syr2k", {}, BENCH_DIMS["syr2k"], "missing_param:bi"),
    ("syr2k", {"bi": 0, "bj": 64, "bk": 64}, BENCH_DIMS["syr2k"], "tile_not_positive:bi"),
    ("syr2k", {"bi": 2.5, "bj": 64, "bk": 64}, BENCH_DIMS["syr2k"], "tile_not_int:bi"),
    ("flash_attention", {"impl": "triton", "bq": 128, "bk": 128},
     BENCH_DIMS["flash_attention"], "invalid_choice:impl"),
    ("heat3d", {"bi": 8, "fuse_t": 3}, (40, 8), "fuse_indivisible:fuse_t"),
    ("heat3d", {"bi": 8, "fuse_t": 0}, (40, 8), "fuse_not_positive:fuse_t"),
    ("decode_attention", {"impl": "cuda", "bk": 128, "hg": 1, "page": 128},
     BENCH_DIMS["decode_attention"], "invalid_choice:impl"),
    ("decode_attention", {"impl": "xla", "bk": 128, "hg": 1, "page": 48},
     BENCH_DIMS["decode_attention"], "page_indivisible:page"),
])
def test_known_bad_host_configs_rejected_as_the_reference_does(kernel, cfg, dims, code):
    ours = feas.check_config(kernel, cfg, dims=dims, target="host")
    theirs = jfeas.check_config(kernel, cfg, dims=dims, target="host")
    assert not ours.ok and code in ours.reasons
    assert ours.reasons == theirs.reasons


def test_lcm_padding_is_the_one_host_divergence():
    # the JAX package's canonical pathology: its host syr2k pads N=240 to
    # lcm(50, 128) = 3200; the port's kernels pad no dim to an lcm
    cfg, dims = {"bi": 50, "bj": 128, "bk": 64}, BENCH_DIMS["syr2k"]
    theirs = jfeas.check_config("syr2k", cfg, dims=dims, target="host")
    ours = feas.check_config("syr2k", cfg, dims=dims, target="host")
    assert [f.code for f in theirs.warnings] == ["padding_waste"]
    assert ours.ok and ours.findings == ()


# ---------------------------------------------------------------------------
# the Hopper warnings (targets gpu and cost)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("target", ["gpu", "cost"])
@pytest.mark.parametrize("kernel,cfg,code,padded", [
    # an extent off the tile kernels' 8-element grid (FFMA route)
    ("syr2k", {"bi": 12, "bj": 64, "bk": 32}, "tile_misaligned:bi", 16),
    ("covariance", {"bi": 64, "bj": 12, "bk": 32}, "tile_misaligned:bj", 16),
    # a 3xTF32 tile padded past its 32 x 32 warp pieces
    ("mm3", {"bm": 40, "bn": 64, "bk": 32}, "tile_misaligned:bm", 64),
    ("matmul", {"bm": 64, "bn": 40, "bk": 32}, "tile_misaligned:bn", 64),
    ("lu", {"bs": 64, "bm": 40, "bn": 64}, "tile_misaligned:bm", 64),
    # the 3xTF32 route's k chunk pads to its mma.sync k of 8
    ("mm3", {"bm": 64, "bn": 64, "bk": 4}, "tile_misaligned:bk", 8),
])
def test_hopper_tile_warnings_fire_and_never_prune(kernel, cfg, code, padded, target):
    dims = LARGE_SHAPES[kernel]
    v = feas.check_config(kernel, cfg, dims=dims, target=target)
    assert v.ok and code in {f.code for f in v.warnings}
    (f,) = [f for f in v.warnings if f.code == code]
    assert f.param == code.split(":")[1] and f"pads to {padded}" in f.message
    assert feas.feasibility_filter(kernel, dims=dims, target=target)(cfg)
    # the host target has no Hopper rules
    assert code not in {f.code for f in feas.check_config(kernel, cfg, dims=dims).findings}


@pytest.mark.parametrize("kernel,cfg", [
    ("mm3", {"bm": 8, "bn": 40, "bk": 4}),       # 8-row tiles: the FFMA route pads to 8 and 4
    ("syr2k", {"bi": 64, "bj": 64, "bk": 12}),   # syr2k's k chunk is not padded
    ("matmul", {"bm": 128, "bn": 128, "bk": 32}),
    ("syr2k", {"bi": 1201, "bj": 64, "bk": 32}),  # a tile past its dim: the dim's own padding
])
def test_aligned_tiles_draw_no_tile_warning(kernel, cfg):
    v = feas.check_config(kernel, cfg, dims=LARGE_SHAPES[kernel], target="gpu")
    assert not [f for f in v.findings if f.code.startswith("tile_misaligned:")]


def test_padding_waste_reads_the_cost_model():
    # 3xTF32 tiles of 40 rows pad to 64: the padded work is the cost model's
    # own (info["padded_work"]) over its useful operations
    cfg, dims = {"bm": 40, "bn": 40, "bk": 32}, LARGE_SHAPES["mm3"]
    _, info = KERNEL_COST_FNS["mm3"](cfg, *dims)
    ratio = info["padded_work"] / info["flops"]
    assert ratio > feas.PAD_WASTE_RATIO == jfeas.PAD_WASTE_RATIO
    (f,) = [f for f in feas.check_config("mm3", cfg, dims=dims, target="cost").warnings
            if f.code == "padding_waste"]
    assert f"{ratio:.2f}x" in f.message
    assert feas.feasibility_filter("mm3", dims=dims, target="cost")(cfg)
    # the defaults at LARGE waste nothing worth a warning
    for kernel in sorted(KERNEL_SPACES):
        default = kernel_space(kernel, "gpu").default_configuration()
        v = feas.check_config(kernel, default, dims=LARGE_SHAPES[kernel], target="cost")
        assert v.findings == (), (kernel, v.findings)


def test_padding_waste_counts_whole_diagonal_tiles():
    # syr2k's symmetric output: one tile over all of C computes both halves
    # of a product whose useful work is the lower one
    v = feas.check_config("syr2k", {"bi": 64, "bj": 64, "bk": 32}, dims=(64, 64),
                          target="gpu")
    assert [f.code for f in v.warnings] == ["padding_waste"] and v.ok


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_space_json_in_the_references_keys(tmp_path, capsys):
    out = tmp_path / "space.json"
    assert analyze_main(["space", "--kernel", "mm3", "--samples", "16", "--json",
                         "--out", str(out)]) == 0
    data = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == data
    assert janalyze_main(["space", "--kernel", "mm3", "--samples", "16", "--json"]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert set(data) == set(ref) | {"gpu"}
    assert [set(r) for r in data["audit"]] == [set(r) for r in ref["audit"]]
    assert set(data["fidelity"]) == set(ref["fidelity"])
    # no card here: host and the Hopper cost model, gpu not audited
    assert [r["target"] for r in data["audit"]] == ["host", "cost"]
    assert data["gpu"]["audited"] is False and data["gpu"]["smem_limit"] is None
    for row in data["audit"]:
        assert row["n_sampled"] == 17   # default config + samples
        assert 0.0 <= row["infeasible_fraction"] <= 1.0
    cost = data["audit"][1]
    assert cost["pathological_fraction"] > 0 and "padding_waste" in cost["codes"]


def test_cli_lint_budget_gates_exit_code(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import time\n\n"
                   "class A:\n"
                   "    def age(self):\n"
                   "        return time.time() - self.t0\n")
    assert analyze_main(["lint", str(bad)]) == 1
    assert analyze_main(["lint", str(bad), "--max-findings", "1"]) == 0
    capsys.readouterr()
    rc = analyze_main(["lint", str(bad), "--json"])
    data = json.loads(capsys.readouterr().out)
    assert rc == 1 and data["findings"][0]["code"] == "REP101"
    janalyze_main(["lint", str(bad), "--json"])
    assert json.loads(capsys.readouterr().out) == data


def test_cli_lint_clean_port_exits_zero(capsys):
    assert analyze_main(["lint", "--json"]) == 0
    data = json.loads(capsys.readouterr().out)
    assert data["n_findings"] == 0 and data["findings"] == []
    assert data["paths"][0].endswith(os.path.join("src", "repro_torch"))
