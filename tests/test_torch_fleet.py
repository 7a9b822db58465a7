"""repro_torch.fleet against the JAX package's fleet: the port's oplog
emission and deterministic merge, file/HTTP transports, the anti-entropy
SyncAgent and the acceptance contracts (host B serves host A's tuned config
with zero local evaluations, quarantined/evicted records never resurrect,
re-applying any op stream is idempotent) — the counterparts of
tests/test_fleet.py on the port's store and dispatch service — and the two
packages replicating into each other: an oplog either one writes converges
the other's store to the same contents, and the same shuffled op streams
merge to identical stores in both."""

import dataclasses
import json
import random
import threading
import time

import numpy as np
import pytest
import torch

from repro import fleet as jfleet
from repro.dispatch import TuningRecord as JaxRecord
from repro.dispatch import TuningStore as JaxStore
from repro_torch.core.space import ConfigurationSpace, Ordinal
from repro_torch.dispatch import (
    BackgroundTuner,
    DispatchService,
    TuningRecord,
    TuningStore,
    register,
)
from repro_torch.dispatch.lookup import warm_start_material
from repro_torch.fleet import (
    FileTransport,
    MergeState,
    Op,
    OpLog,
    Replica,
    SyncAgent,
    transport_from_spec,
)


def _rec(kernel="k", dims=(64, 64), backend="cpu", obj=1.0, cls=TuningRecord, **cfg):
    return cls(kernel=kernel, signature=(tuple(dims),), backend=backend,
               config=cfg or {"t": 8}, objective=obj)


def _host(tmp_path, name, store_cls=TuningStore, replica_cls=Replica):
    store = store_cls(str(tmp_path / name / "store"))
    return store, replica_cls(store)


def _contents(store) -> dict:
    return {r.key(): (tuple(sorted(r.config.items())), r.objective)
            for r in store.records()}


def _quarantines(store) -> set:
    return {(q["kernel"], q["signature"], q["backend"], json.dumps(q["config"], sort_keys=True))
            for q in store.quarantines()}


def _quiesce(*agents, rounds=6):
    """Anti-entropy to a fixed point: a few alternating cycles with no
    traffic in either direction."""
    for _ in range(rounds):
        if all(a.sync_once() == {"applied": 0, "published": 0, "pending": 0}
               for a in agents):
            return
    raise AssertionError("fleet did not quiesce")


# ---------------------------------------------------------------------------
# ops + oplog
# ---------------------------------------------------------------------------


def test_op_json_roundtrip():
    op = Op(host="hA", seq=3, clock=17, kind="put", record=_rec(obj=0.5, t=4))
    back = Op.from_json(op.to_json())
    assert back == op
    assert back.stamp == (17, "hA", 3)
    # the wire form is the JAX package's, key for key
    jop = jfleet.Op(host="hA", seq=3, clock=17, kind="put",
                    record=_rec(obj=0.5, t=4, cls=JaxRecord))
    jd = jop.to_json()
    jd["created"] = op.to_json()["created"]  # stamped at construction
    assert json.dumps(op.to_json(), sort_keys=True) == json.dumps(jd, sort_keys=True)


def test_oplog_emit_assigns_monotonic_seq_and_clock(tmp_path):
    log = OpLog(str(tmp_path / "fleet"))
    a = log.emit("put", _rec(obj=2.0))
    b = log.emit("put", _rec(obj=1.0))
    assert (a.seq, b.seq) == (1, 2)
    assert b.clock > a.clock
    assert log.version_vector() == {log.host_id: 2}


def test_oplog_replay_restores_state(tmp_path):
    path = str(tmp_path / "fleet")
    log = OpLog(path)
    log.emit("put", _rec(obj=2.0, t=8))
    log.emit("put", _rec(obj=1.0, t=16))
    fresh = OpLog(path)
    assert fresh.host_id == log.host_id
    assert fresh.version_vector() == log.version_vector()
    assert len(fresh) == 2
    win = fresh.state.winner(_rec().key())
    assert win.record.config == {"t": 16}


def test_oplog_ingest_is_idempotent(tmp_path):
    src = OpLog(str(tmp_path / "a"))
    src.emit("put", _rec(obj=1.0))
    dst = OpLog(str(tmp_path / "b"))
    ops = src.ops_after({})
    applied, changed = dst.ingest(ops)
    assert len(applied) == 1 and changed
    applied2, changed2 = dst.ingest(ops)
    assert applied2 == [] and not changed2
    assert len(dst) == 1


# ---------------------------------------------------------------------------
# merge semantics: deterministic under any order, quarantine/tombstone aware
# ---------------------------------------------------------------------------


def _winners(state) -> dict:
    out = {}
    for key in state.keys():
        w = state.winner(key)
        if w is not None:
            out[key] = (tuple(sorted(w.record.config.items())),
                        w.record.objective, w.stamp)
    return out


def test_merge_lowest_objective_wins_per_key():
    s = MergeState()
    s.apply(Op("hA", 1, 1, "put", _rec(obj=0.8, t=2)))
    s.apply(Op("hB", 1, 2, "put", _rec(obj=0.3, t=4)))
    assert s.winner(_rec().key()).record.config == {"t": 4}


def test_merge_evict_tombstone_resurrects_newer_put_any_order():
    # p1 best but tombstoned, p2 worse but newer than the tombstone -> p2
    # must win in EVERY order
    p1 = Op("hA", 1, 2, "put", _rec(obj=1.0, t=2))
    p2 = Op("hB", 1, 10, "put", _rec(obj=5.0, t=8))
    ev = Op("hA", 2, 3, "evict", _rec(obj=1.0, t=2))
    for order in ([p1, p2, ev], [p1, ev, p2], [ev, p1, p2],
                  [p2, p1, ev], [ev, p2, p1], [p2, ev, p1]):
        s = MergeState()
        for op in order:
            s.apply(op)
        w = s.winner(_rec().key())
        assert w is not None and w.record.config == {"t": 8}, order


def test_merge_quarantine_resurrects_runner_up_any_order():
    p1 = Op("hA", 1, 1, "put", _rec(obj=0.8, t=2))
    p2 = Op("hB", 1, 2, "put", _rec(obj=0.3, t=4))
    q = Op("hB", 2, 3, "quarantine", _rec(obj=0.3, t=4))
    for order in ([p1, p2, q], [q, p1, p2], [p2, q, p1]):
        s = MergeState()
        for op in order:
            s.apply(op)
        w = s.winner(_rec().key())
        assert w is not None and w.record.config == {"t": 2}, order
        # and the poisoned config stays dead even if re-put afterwards
        s.apply(Op("hC", 1, 9, "put", _rec(obj=0.01, t=4)))
        assert s.winner(_rec().key()).record.config == {"t": 2}


def test_merge_property_shuffled_streams_converge():
    """A random op soup over 3 hosts and 4 keys folds to the same winners
    under 20 random application orders."""
    rng = random.Random(1234)
    ops = []
    for hi, host in enumerate(("hA", "hB", "hC")):
        clock = hi  # desynchronized clocks
        for seq in range(1, 13):
            clock += rng.randint(1, 3)
            dims = rng.choice(((8,), (16,), (32,), (64,)))
            kind = rng.choices(("put", "quarantine", "evict"),
                               weights=(6, 1, 1))[0]
            rec = _rec(dims=dims, obj=round(rng.uniform(0.1, 2.0), 3),
                       t=rng.choice((2, 4, 8)))
            ops.append(Op(host, seq, clock, kind, rec))
    reference = None
    for _ in range(20):
        rng.shuffle(ops)
        s = MergeState()
        for op in ops:
            s.apply(op)
        winners = _winners(s)
        if reference is None:
            reference = winners
        assert winners == reference
    assert reference  # the soup must leave at least one live winner


# ---------------------------------------------------------------------------
# file transport
# ---------------------------------------------------------------------------


def test_file_transport_push_is_idempotent_across_instances(tmp_path):
    log = OpLog(str(tmp_path / "fleet"))
    log.emit("put", _rec(obj=1.0))
    root = str(tmp_path / "shared")
    t1 = FileTransport(root)
    assert t1.push(log) == 1
    assert t1.push(log) == 0
    # a fresh transport (restarted host) re-derives the high-water mark
    assert FileTransport(root).push(log) == 0
    assert FileTransport(root).pending(log) == 0


def test_file_transport_pull_skips_torn_tail(tmp_path):
    a = OpLog(str(tmp_path / "a"))
    a.emit("put", _rec(obj=1.0))
    root = tmp_path / "shared"
    FileTransport(str(root)).push(a)
    with open(root / f"{a.host_id}.ops.jsonl", "a") as f:
        f.write('{"kernel": "k", "op": {"host"')  # crashed writer fragment
    b = OpLog(str(tmp_path / "b"))
    t = FileTransport(str(root))
    ops = t.pull(b)
    assert len(ops) == 1  # the complete line only; fragment left for later


def test_transport_from_spec(tmp_path):
    t = transport_from_spec(f"file:{tmp_path / 'x'}")
    assert isinstance(t, FileTransport)
    from repro_torch.fleet import HttpTransport

    assert isinstance(transport_from_spec("http://127.0.0.1:1"), HttpTransport)
    with pytest.raises(ValueError):
        transport_from_spec("carrier-pigeon:coop")


# ---------------------------------------------------------------------------
# replica + sync: convergence
# ---------------------------------------------------------------------------


def test_two_hosts_converge_bidirectionally(tmp_path):
    sa, ra = _host(tmp_path, "a")
    sb, rb = _host(tmp_path, "b")
    shared = str(tmp_path / "shared")
    aa = SyncAgent(ra, FileTransport(shared))
    ab = SyncAgent(rb, FileTransport(shared))
    sa.put(_rec(dims=(8,), obj=0.5, t=2))          # A-only key
    sb.put(_rec(dims=(16,), obj=0.7, t=4))         # B-only key
    sa.put(_rec(dims=(32,), obj=0.9, t=2))         # contested key:
    sb.put(_rec(dims=(32,), obj=0.2, t=16))        #   B's is better
    _quiesce(aa, ab)
    assert _contents(sa) == _contents(sb)
    assert sa.get("k", ((32,),), "cpu").config == {"t": 16}
    assert len(sa) == 3


def _toy_fleet_kernel():
    def _space(target="host", seed=1234):
        cs = ConfigurationSpace(seed=seed)
        cs.add_hyperparameter(Ordinal("s", (1, 2, 4, 8), default=1))
        return cs

    register("torch_fleet_scale", builder=lambda cfg: lambda x: x * cfg["s"],
             space=_space)


def _cpu_service(store, **kw):
    return DispatchService(store, backend="cpu", target="host", **kw)


def test_host_b_serves_host_a_config_with_zero_local_evals(tmp_path):
    """The acceptance contract: after sync, host B's dispatch() resolves the
    config host A tuned — exact store hit, no campaign, no evaluation."""
    _toy_fleet_kernel()
    sa, ra = _host(tmp_path, "a")
    sb, rb = _host(tmp_path, "b")
    shared = str(tmp_path / "shared")
    sa.put(TuningRecord("torch_fleet_scale", ((4,),), "cpu", {"s": 8}, 0.125,
                        n_evals=200, source="campaign:hostA"))
    SyncAgent(ra, FileTransport(shared)).sync_once()
    SyncAgent(rb, FileTransport(shared)).sync_once()

    svc = _cpu_service(sb)                         # no tuner: cannot evaluate
    x = torch.arange(4.0)
    torch.testing.assert_close(svc.call("torch_fleet_scale", x), x * 8)
    assert svc.stats["store_exact"] == 1 and svc.stats["bg_enqueued"] == 0
    got = sb.get("torch_fleet_scale", ((4,),), "cpu")
    assert got.source == "campaign:hostA" and got.n_evals == 200


def test_replayed_stream_is_idempotent_on_fresh_host(tmp_path):
    sa, ra = _host(tmp_path, "a")
    sa.put(_rec(dims=(8,), obj=0.5, t=2))
    sa.put(_rec(dims=(8,), obj=0.3, t=4))
    sa.quarantine(_rec(dims=(16,), obj=1.0, t=8))
    ops = ra.oplog.ops_after({})
    sc, rc = _host(tmp_path, "c")
    rc.ingest(ops)
    first = _contents(sc)
    assert rc.ingest(ops) == 0                     # second application: no-op
    assert _contents(sc) == first
    # and a store restart replays the log to the same view
    assert _contents(TuningStore(sc.path)) == first


# ---------------------------------------------------------------------------
# quarantine + compaction tombstones must propagate (and never resurrect)
# ---------------------------------------------------------------------------


def test_quarantine_propagates_and_bans_reintroduction(tmp_path):
    sa, ra = _host(tmp_path, "a")
    sb, rb = _host(tmp_path, "b")
    shared = str(tmp_path / "shared")
    aa, ab = SyncAgent(ra, FileTransport(shared)), SyncAgent(rb, FileTransport(shared))
    sa.put(_rec(dims=(8,), obj=0.5, t=2))
    _quiesce(aa, ab)
    assert sb.get("k", ((8,),), "cpu") is not None
    sa.quarantine(_rec(dims=(8,), obj=0.5, t=2))
    _quiesce(aa, ab)
    assert sb.get("k", ((8,),), "cpu") is None
    # B's store now refuses the poisoned config outright, like A's
    assert not sb.put(_rec(dims=(8,), obj=0.01, t=2))
    # ...but a different config for the key is welcome, and replicates
    assert sb.put(_rec(dims=(8,), obj=0.4, t=16))
    _quiesce(ab, aa)
    assert sa.get("k", ((8,),), "cpu").config == {"t": 16}


def test_compacted_eviction_does_not_resurrect_on_pull(tmp_path):
    """compact -> sync -> the record stays gone, even though a peer still
    carries its original put op."""
    sa, ra = _host(tmp_path, "a")
    sb, rb = _host(tmp_path, "b")
    shared = str(tmp_path / "shared")
    aa, ab = SyncAgent(ra, FileTransport(shared)), SyncAgent(rb, FileTransport(shared))
    sa.put(dataclasses.replace(_rec(dims=(8,), obj=0.5, t=2),
                               created=time.time() - 3600))
    sa.put(_rec(dims=(16,), obj=0.7, t=4))
    _quiesce(aa, ab)
    assert len(sb) == 2
    assert sa.compact(ttl_sec=60) == 1             # evicts the stale key
    _quiesce(aa, ab)
    assert sb.get("k", ((8,),), "cpu") is None     # tombstone reached B
    _quiesce(ab, aa)                               # and B's put can't undo it
    assert sa.get("k", ((8,),), "cpu") is None
    assert TuningStore(sb.path).get("k", ((8,),), "cpu") is None  # replay too
    # a genuinely new result (stamped after the tombstone) resurrects the key
    assert sb.put(_rec(dims=(8,), obj=0.45, t=32))
    _quiesce(ab, aa)
    assert sa.get("k", ((8,),), "cpu").config == {"t": 32}


def test_offline_host_converges_after_evict_plus_same_config_reput(tmp_path):
    """A host that missed the eviction and ingests evict + re-put of the SAME
    config (at a worse, newer objective) in one batch must still converge."""
    sa, ra = _host(tmp_path, "a")
    sb, rb = _host(tmp_path, "b")
    sc, rc = _host(tmp_path, "c")
    shared = str(tmp_path / "shared")
    aa = SyncAgent(ra, FileTransport(shared))
    ab = SyncAgent(rb, FileTransport(shared))
    ac = SyncAgent(rc, FileTransport(shared))
    sa.put(dataclasses.replace(_rec(dims=(8,), obj=3.0, t=2),
                               created=time.time() - 3600))
    _quiesce(aa, ab, ac)                           # everyone serves (t2, 3.0)
    # C goes offline; A evicts; B re-measures the same config, slower
    sa.compact(ttl_sec=60)
    _quiesce(aa, ab)
    assert sb.get("k", ((8,),), "cpu") is None
    sb.put(_rec(dims=(8,), obj=5.0, t=2))
    _quiesce(ab, aa)
    # C comes back and sees evict + new put in one pull
    _quiesce(ac, aa, ab)
    assert _contents(sc) == _contents(sa) == _contents(sb)
    assert sc.get("k", ((8,),), "cpu").objective == 5.0


def test_quarantine_survives_crash_between_ingest_and_store_apply(tmp_path):
    """A quarantine op is delivered once: if the process dies after the
    durable oplog append but before the store learns the ban, the next
    Replica over the same dirs re-derives it from the merge."""
    sa, ra = _host(tmp_path, "a")
    sa.put(_rec(dims=(8,), obj=0.5, t=2))
    sa.quarantine(_rec(dims=(8,), obj=0.5, t=2))
    ops = ra.oplog.ops_after({})
    b_store = str(tmp_path / "b" / "store")
    TuningStore(b_store).put(_rec(dims=(8,), obj=0.9, t=2))  # the poisoned cfg
    OpLog(str(tmp_path / "b" / "store" / "fleet")).ingest(ops)
    sb = TuningStore(b_store)
    Replica(sb)
    assert sb.get("k", ((8,),), "cpu") is None
    assert not sb.put(_rec(dims=(8,), obj=0.01, t=2))  # ban reached the store


def test_evict_survives_crash_between_ingest_and_store_apply(tmp_path):
    """The evict twin: host B durably ingests A's tombstone but dies before
    the store applies it; the restart must not re-emit B's surviving record
    (that would resurrect it fleet-wide with a fresh stamp)."""
    sa, ra = _host(tmp_path, "a")
    shared = str(tmp_path / "shared")
    aa = SyncAgent(ra, FileTransport(shared))
    sa.put(dataclasses.replace(_rec(dims=(8,), obj=0.5, t=2),
                               created=time.time() - 3600))
    aa.sync_once()
    sb, rb = _host(tmp_path, "b")
    ab = SyncAgent(rb, FileTransport(shared))
    _quiesce(aa, ab)
    assert sb.get("k", ((8,),), "cpu") is not None
    sa.compact(ttl_sec=60)
    aa.sync_once()
    b_log = OpLog(str(tmp_path / "b" / "store" / "fleet"))
    b_log.ingest(FileTransport(shared).pull(b_log))
    sb2 = TuningStore(str(tmp_path / "b" / "store"))
    rb2 = Replica(sb2)
    ab2 = SyncAgent(rb2, FileTransport(shared))
    _quiesce(ab2, aa)
    assert sb2.get("k", ((8,),), "cpu") is None
    assert sa.get("k", ((8,),), "cpu") is None, "evicted record resurrected"


def test_file_transport_redelivers_ops_until_ingested(tmp_path):
    """pull() coverage is judged by the version vector, not a cursor: ops
    pulled by a cycle whose ingest failed must come back next cycle."""
    a = OpLog(str(tmp_path / "a"))
    a.emit("put", _rec(obj=1.0))
    t = FileTransport(str(tmp_path / "shared"))
    t.push(a)
    b = OpLog(str(tmp_path / "b"))
    first = t.pull(b)
    assert len(first) == 1
    assert len(t.pull(b)) == 1          # not ingested: delivered again
    b.ingest(first)
    assert t.pull(b) == []              # covered by the vv now


def test_http_ops_parsing_tolerates_foreign_lines():
    from repro_torch.fleet.http import _ops_from_jsonl, _ops_to_jsonl

    good = Op(host="hA", seq=1, clock=1, kind="put", record=_rec(obj=1.0))
    data = (b'{"op": {"host": "hZ", "seq": 1, "clock": 1, "kind": "merge9000"}}\n'
            + b"not json at all\n" + _ops_to_jsonl([good]))
    assert _ops_from_jsonl(data) == [good]


def test_malformed_op_kind_rejected_before_durable_append(tmp_path):
    op = Op(host="hX", seq=1, clock=1, kind="put", record=_rec(obj=1.0))
    bad = op.to_json()
    bad["op"]["kind"] = "putt"
    with pytest.raises(ValueError):
        Op.from_json(bad)
    log = OpLog(str(tmp_path / "fleet"))
    evil = dataclasses.replace(op, kind="putt")    # bypasses from_json
    applied, _ = log.ingest([evil, op])
    assert [o.kind for o in applied] == ["put"]
    assert len(OpLog(str(tmp_path / "fleet"))) == 1   # replay still works


# ---------------------------------------------------------------------------
# concurrency: interleaved writers during sync still converge
# ---------------------------------------------------------------------------


def test_concurrent_writers_during_sync_converge(tmp_path):
    sa, ra = _host(tmp_path, "a")
    sb, rb = _host(tmp_path, "b")
    shared = str(tmp_path / "shared")
    aa, ab = SyncAgent(ra, FileTransport(shared)), SyncAgent(rb, FileTransport(shared))
    stop = threading.Event()

    def writer(store, salt: int):
        rng = random.Random(salt)
        for _ in range(30):
            dims = (rng.choice((8, 16, 32, 64)),)
            obj = round(rng.uniform(0.05, 1.0), 4)
            t = rng.choice((2, 4, 8, 16))
            if rng.random() < 0.1:
                store.quarantine(_rec(dims=dims, obj=obj, t=t))
            else:
                store.put(_rec(dims=dims, obj=obj, t=t))

    def syncer():
        while not stop.is_set():
            aa.sync_once()
            ab.sync_once()

    threads = [threading.Thread(target=writer, args=(s, i))
               for i, s in enumerate((sa, sa, sb, sb))]  # 4 writers, 2 per host
    sy = threading.Thread(target=syncer)
    sy.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    stop.set()
    sy.join(timeout=60)
    assert not any(t.is_alive() for t in threads + [sy])
    _quiesce(aa, ab, rounds=10)
    assert _contents(sa) == _contents(sb)
    # the merge is also what a fresh third host reconstructs from scratch
    sc, rc = _host(tmp_path, "c")
    _quiesce(SyncAgent(rc, FileTransport(shared)), aa, ab, rounds=10)
    assert _contents(sc) == _contents(sa)


# ---------------------------------------------------------------------------
# SyncAgent thread: hot swap into a live DispatchService + telemetry
# ---------------------------------------------------------------------------


def test_sync_agent_hot_swaps_replicated_config_into_service(tmp_path):
    _toy_fleet_kernel()
    sa, ra = _host(tmp_path, "a")
    sb = TuningStore(str(tmp_path / "b" / "store"))
    svc = _cpu_service(sb)
    rb = Replica(sb, service=svc)
    shared = str(tmp_path / "shared")
    aa = SyncAgent(ra, FileTransport(shared))
    ab = SyncAgent(rb, FileTransport(shared), interval_sec=0.05)

    x = torch.arange(4.0)
    torch.testing.assert_close(svc.call("torch_fleet_scale", x), x)
    assert svc.stats["store_default"] == 1

    sa.put(TuningRecord("torch_fleet_scale", ((4,),), "cpu", {"s": 4}, 0.25))
    aa.sync_once()
    ab.start()
    try:
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if sb.peek("torch_fleet_scale", ((4,),), "cpu") is not None:
                break
            time.sleep(0.02)
        # the agent invalidated the cached executable: no manual invalidate
        torch.testing.assert_close(svc.call("torch_fleet_scale", x), x * 4)
        assert svc.stats["sync_applied"] >= 1
        tele = svc.telemetry()
        assert tele["sync_ops_pending"] == 0
        assert tele["sync_last_age_sec"] < 60
    finally:
        ab.stop()


def test_telemetry_merges_tuner_overhead_and_replication_lag(tmp_path):
    """DispatchService.telemetry() is the one dashboard view: dispatch
    counters + the tuner's ask/tell/wait seconds + sync lag, and a local
    background publish is pushed fleet-wide by the attached agent."""
    _toy_fleet_kernel()
    store = TuningStore(str(tmp_path / "store"))
    tuner = BackgroundTuner(store, max_workers=1, max_evals=4, n_initial=2)
    svc = _cpu_service(store, tuner=tuner)
    rep = Replica(store, service=svc)
    agent = SyncAgent(rep, FileTransport(str(tmp_path / "shared")))
    try:
        assert tuner.on_publish is not None        # attach_sync wired the nudge
        svc.dispatch("torch_fleet_scale", torch.arange(4.0))  # miss -> background tune
        tuner.drain()
        assert tuner.errors == []
        agent.sync_once()
        tele = svc.telemetry()
        assert tele["ask_sec"] > 0.0 and tele["campaigns"] == 1
        assert tele["sync_ops_pending"] == 0       # the publish was pushed
        assert tele["sync_published"] >= 1
        assert tele["sync_last_age_sec"] < 60
    finally:
        tuner.shutdown()


def test_sync_agent_survives_transport_failure(tmp_path):
    sa, ra = _host(tmp_path, "a")

    class BrokenTransport(FileTransport):
        def pull(self, oplog):
            raise OSError("shared dir unmounted")

    agent = SyncAgent(ra, BrokenTransport(str(tmp_path / "shared")))
    out = agent.sync_once()
    assert "error" in out
    assert agent.stats["sync_errors"] == 1 and len(agent.errors) == 1
    assert agent.lag()["sync_errors"] == 1


def test_status_reports_replication_lag(tmp_path):
    sa, ra = _host(tmp_path, "a")
    shared = str(tmp_path / "shared")
    t = FileTransport(shared)
    sa.put(_rec(dims=(8,), obj=0.5, t=2))
    st = ra.status(t)
    assert st["ops_pending"] == 1                  # emitted, not yet pushed
    assert st["records"] == 1 and st["ops"] == 1
    agent = SyncAgent(ra, t)
    agent.sync_once()
    st = ra.status(t)
    assert st["ops_pending"] == 0
    assert st["last_sync_age_sec"] is not None and st["last_sync_age_sec"] < 60


# ---------------------------------------------------------------------------
# HTTP push/pull pair (127.0.0.1, port 0)
# ---------------------------------------------------------------------------


def test_http_transport_round_trip(tmp_path):
    from repro_torch.fleet import FleetServer, HttpTransport

    sa, ra = _host(tmp_path, "a")
    sb, rb = _host(tmp_path, "b")
    server = FleetServer(ra).start()
    try:
        t = HttpTransport(server.url)
        sb.put(_rec(dims=(8,), obj=0.5, t=2))      # B pushes to A
        sa.put(_rec(dims=(16,), obj=0.7, t=4))     # B pulls from A
        agent = SyncAgent(rb, t)
        out = agent.sync_once()
        assert out == {"applied": 1, "published": 1, "pending": 0}
        assert sa.get("k", ((8,),), "cpu").config == {"t": 2}
        assert sb.get("k", ((16,),), "cpu").config == {"t": 4}
        assert t.pending(rb.oplog) == 0
    finally:
        server.stop()


def test_http_server_propagates_third_party_ops(tmp_path):
    # hub topology: A is the hub; B and C only talk to A, yet B's configs
    # reach C because /ops serves everything the hub knows
    from repro_torch.fleet import FleetServer, HttpTransport

    sa, ra = _host(tmp_path, "a")
    sb, rb = _host(tmp_path, "b")
    sc, rc = _host(tmp_path, "c")
    server = FleetServer(ra).start()
    try:
        sb.put(_rec(dims=(8,), obj=0.5, t=2))
        SyncAgent(rb, HttpTransport(server.url)).sync_once()
        SyncAgent(rc, HttpTransport(server.url)).sync_once()
        assert sc.get("k", ((8,),), "cpu").config == {"t": 2}
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# integration: warm starts + CLI
# ---------------------------------------------------------------------------


def test_warm_start_sees_replicated_neighbors(tmp_path):
    store = TuningStore(str(tmp_path / "store"))
    assert warm_start_material(store, "k", ((8,),), "cpu") == (None, None)
    # another process view (the SyncAgent's reconcile) lands a record
    other = TuningStore(str(tmp_path / "store"))
    other.put(_rec(dims=(16,), obj=0.5, t=4))
    cfgs, recs = warm_start_material(store, "k", ((8,),), "cpu")
    assert cfgs == [{"t": 4}] and recs is None


def test_fleet_cli_sync_and_status_in_the_references_keys(tmp_path, capsys):
    from repro.launch.fleet import main as jmain
    from repro_torch.launch.fleet import main

    out = {}
    for pkg, cli, store_cls in (("port", main, TuningStore), ("ref", jmain, JaxStore)):
        store_a = str(tmp_path / pkg / "a" / "store")
        store_b = str(tmp_path / pkg / "b" / "store")
        shared = f"file:{tmp_path / pkg / 'shared'}"
        store_cls(store_a).put(_rec(dims=(8,), obj=0.5, t=2))
        capsys.readouterr()
        assert cli(["sync", "--store", store_a, "--transport", shared]) == 0
        sync = json.loads(capsys.readouterr().out)
        assert cli(["sync", "--store", store_b, "--transport", shared]) == 0
        capsys.readouterr()
        assert store_cls(store_b).get("k", ((8,),), "cpu").config == {"t": 2}
        assert cli(["status", "--store", store_b, "--transport", shared]) == 0
        st = json.loads(capsys.readouterr().out)
        assert st["records"] == 1 and st["ops_pending"] == 0
        assert cli(["push", "--store", store_b, "--transport", shared]) == 0
        push = json.loads(capsys.readouterr().out)
        assert cli(["pull", "--store", store_a, "--transport", shared]) == 0
        pull = json.loads(capsys.readouterr().out)
        out[pkg] = (sync, st, push, pull)
    for ours, theirs in zip(out["port"], out["ref"]):
        assert set(ours) == set(theirs)
    assert out["port"][0]["published"] == out["ref"][0]["published"] == 1


# ---------------------------------------------------------------------------
# the two packages replicate into each other
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_oplog_written_by_either_package_converges_the_other(tmp_path, writer):
    """Host R runs the JAX package's fleet, host P the port's, over one
    shared directory: whichever package wrote an oplog, the other pulls it
    and both stores hold the same (key, config, objective) contents and the
    same quarantines."""
    shared = str(tmp_path / "shared")
    sr, rr = _host(tmp_path, "ref", JaxStore, jfleet.Replica)
    sp, rp = _host(tmp_path, "port")
    ar = jfleet.SyncAgent(rr, jfleet.FileTransport(shared))
    ap = SyncAgent(rp, FileTransport(shared))
    sides = [(sr, JaxRecord, ar), (sp, TuningRecord, ap)]
    if writer == "port":
        sides.reverse()
    (first, w, first_agent), (second, other, second_agent) = sides
    first.put(_rec(dims=(8,), obj=0.5, t=2, cls=w))
    first.put(_rec(dims=(16,), obj=0.9, t=4, cls=w))
    first.put(_rec(dims=(16,), obj=0.7, t=8, cls=w))           # improves the key
    first.put(_rec(dims=(32,), obj=0.3, t=2, cls=w))
    first.quarantine(_rec(dims=(32,), obj=0.3, t=2, cls=w), reason="drift:test")
    second.put(_rec(dims=(64,), obj=0.4, t=16, cls=other))     # the reader's own key
    second.put(_rec(dims=(8,), obj=0.6, t=4, cls=other))       # loses to the writer's
    _quiesce(first_agent, second_agent)
    assert _contents(sr) == _contents(sp)
    got = {k[1]: v for k, v in _contents(sp).items()}
    assert got == {"8": ((("t", 2),), 0.5), "16": ((("t", 8),), 0.7),
                   "64": ((("t", 16),), 0.4)}
    assert _quarantines(sr) == _quarantines(sp) and len(_quarantines(sp)) == 1
    # the ban holds on both sides
    assert not sr.put(_rec(dims=(32,), obj=0.01, t=2, cls=JaxRecord))
    assert not sp.put(_rec(dims=(32,), obj=0.01, t=2))


def _op_soup(seed: int):
    """(host, seq, clock, kind, dims, objective, t) of a seeded op soup over
    three hosts and four keys."""
    rng = np.random.default_rng(seed)
    out = []
    for hi, host in enumerate(("hA", "hB", "hC")):
        clock = hi
        for seq in range(1, 17):
            clock += int(rng.integers(1, 4))
            kind = str(rng.choice(("put", "quarantine", "evict"), p=(0.7, 0.15, 0.15)))
            dims = (int(rng.choice((8, 16, 32, 64))),)
            out.append((host, seq, clock, kind, dims,
                        round(float(rng.uniform(0.1, 2.0)), 3), int(rng.choice((2, 4, 8)))))
    return out


def _interleave(soup, rng):
    """A random interleaving of the hosts' streams, each host's ops kept in
    seq order (the transport contract: a pull may reorder hosts, never one
    host's ops)."""
    slots = rng.permutation([op[0] for op in soup])
    queues = {h: [op for op in soup if op[0] == h] for h in set(slots)}
    return [queues[h].pop(0) for h in slots]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shuffled_op_streams_merge_to_identical_stores(tmp_path, seed):
    soup = _op_soup(seed)
    rng = np.random.default_rng(seed + 100)
    pkgs = (("ref", jfleet.Op, JaxRecord, JaxStore, jfleet.Replica, jfleet.MergeState),
            ("port", Op, TuningRecord, TuningStore, Replica, MergeState))
    merges, views = [], []
    for trial in range(3):
        shuffled = [soup[i] for i in rng.permutation(len(soup))]
        interleaved = _interleave(soup, rng)
        for pkg, op_cls, rec_cls, store_cls, replica_cls, merge_cls in pkgs:
            def ops(seq):
                return [op_cls(h, s, c, k, _rec(dims=d, obj=o, t=t, cls=rec_cls))
                        for h, s, c, k, d, o, t in seq]

            state = merge_cls()
            for op in ops(shuffled):               # any order at all
                state.apply(op)
            merges.append({k: (w[0], w[1], w[2]) for k, w in _winners(state).items()})
            store, rep = _host(tmp_path / f"{trial}", pkg, store_cls, replica_cls)
            stream = ops(interleaved)
            # in three batches, as three pulls would deliver them
            for part in np.array_split(np.arange(len(stream)), 3):
                rep.ingest([stream[i] for i in part])
            views.append((_contents(store), _quarantines(store)))
    assert all(m == merges[0] for m in merges[1:]) and merges[0]
    assert all(v == views[0] for v in views[1:])
    assert views[0][0]  # at least one live winner
    # the stores serve the merge's winners
    assert {k: (w[0], w[1]) for k, w in merges[0].items()} == views[0][0]
