"""The port's observability CLI (``repro_torch.launch.obs``) against the JAX
package's (``repro.launch.obs``): on one snapshot file and one trace file,
both written by the port's ``obs`` modules, every subcommand prints the same
stdout and exits with the same code; ``snapshot --url`` against a live
``ObsServer`` and the ``serve`` subcommand (in subprocesses, on 127.0.0.1 at
a free port) give the same scrapes."""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys
import urllib.request

import pytest

from repro.launch import obs as jax_obs
from repro_torch.launch import obs as torch_obs
from repro_torch.obs import MetricsRegistry, ObsServer, Tracer, write_snapshot

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A snapshot file of two lines (counters and histograms of two kernels)
    and a trace file of nested spans, written by the port's obs modules."""
    d = tmp_path_factory.mktemp("obs")
    reg = MetricsRegistry()
    for i in range(40):
        reg.observe("dispatch_execute_seconds", 1e-5 * (1 + i % 7),
                    kernel="decode_attention", signature="(8,7,64)", backend="cpu")
        reg.observe("dispatch_execute_seconds", 3e-4 * (1 + i % 3),
                    kernel="flash_attention", signature="(8,32,64)", backend="cpu")
        reg.add("dispatch_requests_total", kernel="decode_attention", path="fast_hit")
    snap = str(d / "metrics.jsonl")
    write_snapshot(snap, registry=reg, bench="serve", mode="tuned")
    reg.add("dispatch_requests_total", 5, kernel="flash_attention", path="store_default")
    write_snapshot(snap, registry=reg, bench="serve", mode="tuned")
    trace = str(d / "trace.jsonl")
    tracer = Tracer(trace, process_name="test")
    for i in range(3):
        with tracer.span("campaign.ask", learner="RF", i=i):
            pass
        with tracer.span("campaign.evaluate", i=i):
            with tracer.span("dispatch.execute", kernel="syr2k"):
                pass
        tracer.instant("campaign.tell", i=i)
    tracer.close()
    return {"snapshot": snap, "trace": trace, "dir": d, "registry": reg}


def _run(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue()


def _both(argv):
    return _run(jax_obs, argv), _run(torch_obs, argv)


@pytest.mark.parametrize("argv", [
    ["snapshot", "--file", "{snapshot}"],
    ["snapshot", "--file", "{snapshot}", "--prom"],
    ["tail", "--trace", "{trace}", "-n", "4"],
    ["tail", "--trace", "{trace}"],
    ["summarize", "--metrics", "{snapshot}"],
    ["summarize", "--trace", "{trace}", "--require-spans", "campaign.ask,campaign.evaluate"],
    ["summarize", "--trace", "{trace}", "--require-spans", "campaign.ask,dispatch.build"],
    ["summarize", "--trace", "{trace}", "--metrics", "{snapshot}"],
    ["summarize"],
], ids=["snapshot", "snapshot-prom", "tail-n", "tail", "summarize-metrics",
        "summarize-required-present", "summarize-required-missing", "summarize-both",
        "summarize-nothing"])
def test_subcommands_print_the_same_and_exit_alike(files, argv):
    argv = [a.format(**files) for a in argv]
    (jrc, jout), (trc, tout) = _both(argv)
    assert trc == jrc
    assert tout == jout
    if argv[0] != "tail" and "--prom" not in argv:
        json.loads(tout)  # JSON on stdout
    if "dispatch.build" in argv[-1]:
        assert trc == 1 and json.loads(tout)["trace"]["missing_spans"] == ["dispatch.build"]
    if argv == ["summarize"]:
        assert trc == 2


def test_summarize_metrics_shows_both_kernels(files):
    rc, out = _run(torch_obs, ["summarize", "--metrics", files["snapshot"]])
    assert rc == 0
    hists = json.loads(out)["metrics"]["histograms"]
    kernels = {h["labels"]["kernel"] for h in hists if h["name"] == "dispatch_execute_seconds"}
    assert kernels == {"decode_attention", "flash_attention"}


def test_summarize_perfetto_exports_the_same_trace(files):
    outs = {}
    for name, mod in (("jax", jax_obs), ("torch", torch_obs)):
        path = str(files["dir"] / f"{name}.perfetto.json")
        rc, out = _run(mod, ["summarize", "--trace", files["trace"], "--perfetto", path])
        assert rc == 0
        report = json.loads(out)
        assert report["trace"]["perfetto"]["path"] == path
        report["trace"]["perfetto"].pop("path")
        with open(path) as f:
            outs[name] = (report, json.load(f))
    assert outs["torch"] == outs["jax"]


def test_snapshot_url_against_a_live_server(files):
    server = ObsServer(registry=files["registry"], host="127.0.0.1", port=0).start()
    try:
        for extra in ([], ["--prom"]):
            argv = ["snapshot", "--url", server.url] + extra
            (jrc, jout), (trc, tout) = _both(argv)
            assert (trc, tout) == (jrc, jout)
        # a file and a live endpoint merged
        argv = ["snapshot", "--file", files["snapshot"], "--url", server.url]
        (jrc, jout), (trc, tout) = _both(argv)
        assert (trc, tout) == (jrc, jout)
    finally:
        server.stop()


def _scrape(url: str, path: str) -> bytes:
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return r.read()


def test_serve_subcommand_serves_the_same_endpoints(files):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONUNBUFFERED="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"{name}.launch.obs", "serve", "--file", files["snapshot"],
         "--port", "0"], stdout=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))
        for name in ("repro", "repro_torch")}
    try:
        got = {}
        for name, p in procs.items():
            head = json.loads(p.stdout.readline())
            url = head.pop("serving")
            assert url.startswith("http://127.0.0.1:")
            got[name] = (head, json.loads(_scrape(url, "/snapshot")),
                         _scrape(url, "/metrics"))
        assert got["repro_torch"] == got["repro"]
        assert got["repro_torch"][0] == {"endpoints": ["/metrics", "/snapshot"],
                                         "file": files["snapshot"]}
    finally:
        for p in procs.values():
            p.terminate()
            p.wait(timeout=30)
            p.stdout.close()
