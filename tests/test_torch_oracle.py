"""The port's GossipOracle on the CPU: against the JAX oracle, and under
the assertions of the JAX oracle's own behavioral tests (P4).

  * One command sequence (kill, advance, leave, spawn, revive, event
    fire, keyring install/use/remove) on a JAX oracle and a port oracle
    built from one config gives equal members, summaries, deltas,
    statuses, event lists, RTT orders, per-shard gauges and keyrings, and
    coordinates within 1e-5 of the coordinate scale (Vivaldi's norms and
    normal draw round a few ulp apart; tests/test_torch_serf.py).
  * A port oracle carried across from a JAX oracle's mid-run pool
    (convert.oracle_from_numpy) answers every read as the JAX one does.
  * advance() and every command leave a state a reader holds unchanged.
  * The assertions of tests/test_flight.py:310-511, test_events.py:69,
    test_agent_ops.py:210,236, test_device_counters.py:91 and
    test_delegate.py, run against the port's oracle with its hooks wired
    to the JAX package's flight recorder, profiler and telemetry.
  * convert/agent_bind: an agent of the host package answers
    `GET /v1/agent/members` from the port's oracle, keyring kept.
"""

import base64
import json
import os
import socket
import subprocess

import numpy as np
import pytest
import torch

from torch_parity import consul_hooks, jax_dict

from consul_tpu import config as jconfig
from consul_tpu import flight
from consul_tpu.oracle import GossipOracle as JaxOracle
from consul_tpu_torch import agent_bind, config, convert
from consul_tpu_torch import oracle as oracle_mod
from consul_tpu_torch.models import swim
from consul_tpu_torch.oracle import GossipOracle

KEY_A = base64.b64encode(b"A" * 16).decode()
KEY_B = base64.b64encode(b"B" * 32).decode()


def fresh():
    return flight.FlightRecorder(clock=lambda: 0.0, forward_to_log=False)


def port_oracle(**kw):
    return GossipOracle(config.GossipConfig.lan(), config.SimConfig(**kw),
                        device="cpu", hooks=consul_hooks())


# ------------------------------------------- against the JAX oracle

SEQ_SIM = dict(n_nodes=64, n_initial=56, rumor_slots=16, p_loss=0.01,
               seed=241, shard_blocks=4)


def _assert_same_reads(jo, to, where):
    names = [f"node{i}" for i in (1, 3, 5, 9, 20, 30, 33, 40, 47, 50)]
    assert to.tick == jo.tick, where
    assert to.provisioned_count == jo.provisioned_count, where
    assert to.members() == jo.members(), where
    assert to.members(limit=7, offset=10) == jo.members(limit=7, offset=10)
    assert to.members_summary() == jo.members_summary(), where
    assert to.members_delta(8) == jo.members_delta(8), where
    for n in names:
        assert to.status(n) == jo.status(n), f"{where}: {n}"
    assert to.event_list() == jo.event_list(), where
    assert to.sort_by_rtt("node1", names) == jo.sort_by_rtt("node1", names)
    assert to.shard_metrics() == jo.shard_metrics(), where
    assert to.keyring_list() == jo.keyring_list(), where
    for n in ("node3", "node47"):
        a, b = jo.coordinate(n), to.coordinate(n)
        scale = max(1e-9, max(abs(v) for v in a["vec"]))
        np.testing.assert_allclose(b["vec"], a["vec"], rtol=0,
                                   atol=1e-5 * scale, err_msg=where)
        for f in ("error", "adjustment", "height"):
            assert b[f] == pytest.approx(a[f], rel=1e-5, abs=1e-5 * scale)
        assert b["node"] == a["node"]
    assert to.rtt("node3", "node47") == pytest.approx(
        jo.rtt("node3", "node47"), rel=1e-5)


def test_command_sequence_matches_the_reference_oracle():
    jo = JaxOracle(jconfig.GossipConfig.lan(), jconfig.SimConfig(**SEQ_SIM))
    to = GossipOracle(config.GossipConfig.lan(), config.SimConfig(**SEQ_SIM),
                      device="cpu", hooks=consul_hooks())
    both = (jo, to)

    def each(method, *args):
        out = [getattr(o, method)(*args) for o in both]
        assert out[0] == out[1], f"{method}{args}: {out}"
        return out[1]

    with flight.use(fresh()):
        _assert_same_reads(jo, to, "fresh")
        each("advance", 10)
        each("kill", "node5")
        each("kill", "node20")
        each("advance", 150)
        _assert_same_reads(jo, to, "after the kills")
        assert to.status("node5") == "failed"
        each("leave", "node30")
        each("advance", 20)
        assert each("spawn", "fresh-node") == "fresh-node"
        assert each("spawn") == "node57"
        each("revive", "node5")
        each("advance", 40)
        _assert_same_reads(jo, to, "after leave, spawn and revive")
        eid = each("fire_event", "deploy", b"v1", "node1")
        each("advance", 10)
        assert each("event_coverage", int(eid)) > 0.0
        each("keyring_install", KEY_A)
        each("keyring_install", KEY_B)
        each("keyring_use", KEY_B)
        each("keyring_remove", KEY_A)
        _assert_same_reads(jo, to, "after the event and the keyring")
        for o in both:
            with pytest.raises(ValueError):
                o.keyring_remove(KEY_B)
            with pytest.raises(KeyError):
                o.keyring_use(KEY_A)
            with pytest.raises(ValueError):
                o.keyring_install("bm90IGEga2V5")
            with pytest.raises(KeyError):
                o.node_id("node60")      # never joined
        assert to.status("fresh-node") == "alive"
        assert to.status("node30") == "left"


def test_oracle_carried_from_a_jax_pool_answers_alike():
    sim = dict(n_nodes=128, n_initial=120, rumor_slots=16, p_loss=0.01,
               seed=243, shard_blocks=4)
    jo = JaxOracle(jconfig.GossipConfig.lan(), jconfig.SimConfig(**sim))
    jo.advance(10)
    jo.kill("node7")
    jo.leave("node8")
    jo.advance(120)
    js = jo._state
    state = {"swim": jax_dict(js.swim), "coords": jax_dict(js.coords),
             "events": jax_dict(js.events)}
    to = convert.oracle_from_numpy(config.GossipConfig.lan(),
                                   config.SimConfig(**sim), state,
                                   jo._provisioned, device="cpu")
    assert to.members() == jo.members()
    assert to.members_summary() == jo.members_summary()
    assert to.members_delta(16) == jo.members_delta(16)
    assert to.shard_metrics() == jo.shard_metrics()
    names = [f"node{i}" for i in range(0, 120, 7)]
    assert to.sort_by_rtt("node2", names) == jo.sort_by_rtt("node2", names)
    for n in ("node0", "node7", "node99"):
        assert to.coordinate(n) == jo.coordinate(n)
        assert to.status(n) == jo.status(n)
    assert to.rtt("node0", "node99") == pytest.approx(
        jo.rtt("node0", "node99"), rel=1e-6)
    assert to.sim_metrics() == jo.sim_metrics()
    with pytest.raises(ValueError):
        convert.oracle_from_numpy(config.GossipConfig.lan(),
                                  config.SimConfig(**sim), state,
                                  jo._provisioned[:10], device="cpu")


def test_advance_and_commands_leave_a_held_state_unchanged():
    """Readers hold state references across advance(): nothing writes a
    held state's tensors in place."""
    o = port_oracle(n_nodes=64, n_initial=60, rumor_slots=16, p_loss=0.01,
                    seed=7)
    o.advance(12)
    held = o._state

    def leaves(cs):
        out = {}
        for part in ("swim", "coords", "events"):
            for k, v in vars(getattr(cs, part)).items():
                if isinstance(v, torch.Tensor):
                    out[f"{part}.{k}"] = v
        return out

    copies = {k: v.clone() for k, v in leaves(held).items()}
    with flight.use(fresh()):
        o.kill("node3")
        o.advance(25)                 # probe ticks and gossip ticks
        o.leave("node4")
        o.spawn()
        o.revive("node3")
        o.fire_event("e", b"", "node1")
        o.advance(5)
        o.members_delta()
        o.publish_sim_metrics()
    assert o._state is not held
    for k, v in leaves(held).items():
        assert torch.equal(v, copies[k]), f"{k} was written in place"


def test_oracle_raises_without_a_card_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GossipOracle(config.GossipConfig.lan(), config.SimConfig(n_nodes=8))


# ---------------- tests/test_flight.py:310-511 against the port


def test_flap_journal_moves_o_flaps_rows(monkeypatch):
    n = 512
    o = port_oracle(n_nodes=n, rumor_slots=16, p_loss=0.0, seed=3)
    r = fresh()
    with flight.use(r):
        assert o.journal_flaps() == 0     # first call: baseline only
    assert r.last_seq == 0

    transferred = []
    real = oracle_mod._to_host

    def spy(x):
        a = real(x)
        transferred.append(a.nbytes)
        return a

    monkeypatch.setattr(oracle_mod, "_to_host", spy)

    o.kill("node5")
    o.kill("node77")
    o.advance(160)
    with flight.use(r):
        journaled = o.journal_flaps(max_changes=64)
    assert journaled >= 2
    flaps = {(e["labels"]["node"], e["labels"]["status"])
             for e in r.read(name="serf.member.flap")}
    assert ("node5", "failed") in flaps
    assert ("node77", "failed") in flaps
    assert transferred and sum(transferred) < n, \
        f"flap journal moved {sum(transferred)}B against a {n}-pool"
    from consul_tpu import trace
    tok = trace.set_current("deadbeef")
    try:
        o.kill("node200")
        o.advance(160)
        with flight.use(r):
            o.journal_flaps(max_changes=64)
    finally:
        trace.reset(tok)
    late = [e for e in r.read(name="serf.member.flap")
            if e["labels"]["node"] == "node200"]
    assert late and late[0]["trace_id"] == ""


def test_flap_journal_truncation_emits_single_event():
    o = port_oracle(n_nodes=512, rumor_slots=16, p_loss=0.0, seed=3)
    r = fresh()
    with flight.use(r):
        o.journal_flaps()
        for i in range(40):
            o.kill(f"node{i}")
        o.advance(200)
        journaled = o.journal_flaps(max_changes=8)
    assert journaled == 8
    assert len(r.read(name="serf.member.flap")) == 8
    evs = r.read(name="serf.flap.truncated")
    assert len(evs) == 1
    assert int(evs[0]["labels"]["count"]) > 8
    assert evs[0]["labels"]["limit"] == "8"


def test_flap_journal_cursor_independent_of_members_delta():
    o = port_oracle(n_nodes=512, rumor_slots=16, p_loss=0.0, seed=3)
    r = fresh()
    with flight.use(r):
        o.journal_flaps()
        o.members_delta()
        o.kill("node11")
        o.advance(160)
        assert o.journal_flaps() >= 1
        d = o.members_delta()
        assert (11, "failed") in d["changed"]
        o.kill("node13")
        o.advance(160)
        assert any(i == 13 for i, _ in o.members_delta()["changed"])
        assert o.journal_flaps() >= 1
        assert any(e["labels"]["node"] == "node13"
                   for e in r.read(name="serf.member.flap"))


def test_publish_sim_metrics_feeds_flap_journal():
    from consul_tpu import telemetry
    o = port_oracle(n_nodes=512, rumor_slots=16, p_loss=0.0, seed=3)
    reg = telemetry.Registry()
    r = fresh()
    with flight.use(r):
        o.publish_sim_metrics(reg)
        o.kill("node9")
        o.advance(160)
        o.publish_sim_metrics(reg)
    assert any(e["labels"]["node"] == "node9"
               for e in r.read(name="serf.member.flap"))


def test_shard_metrics_matches_numpy_reference():
    params = swim.make_params(config.GossipConfig.lan(),
                              config.SimConfig(n_nodes=64, rumor_slots=16,
                                               p_loss=0.0, seed=2))
    s = swim.init_state(params, device="cpu")
    s = swim.kill(s, 3)
    s = swim.kill(s, 35)
    blocks = 4
    mat = swim.shard_metrics(params, s, blocks).numpy()
    assert mat.shape == (blocks, len(swim.SHARD_METRIC_NAMES))
    up = s.up.numpy() & s.member.numpy()
    dead = s.committed_dead.numpy()
    for b in range(blocks):
        sl = slice(b * 16, (b + 1) * 16)
        assert mat[b][0] == up[sl].sum()
        assert mat[b][1] == dead[sl].sum()
    assert mat[:, 0].sum() == up.sum()


def test_publish_sim_metrics_emits_per_shard_and_skew_gauges():
    from consul_tpu import telemetry
    o = port_oracle(n_nodes=128, rumor_slots=16, p_loss=0.0, seed=5,
                    shard_blocks=4)
    reg = telemetry.Registry()
    with flight.use(fresh()):
        o.publish_sim_metrics(reg)
    dump = reg.dump()
    shard_rows = [g for g in dump["Gauges"]
                  if g["Name"] == "consul.serf.members.alive"
                  and "Labels" in g]
    assert {g["Labels"]["shard"] for g in shard_rows} == {"0", "1", "2", "3"}
    assert sum(g["Value"] for g in shard_rows) == 128
    names = {g["Name"] for g in dump["Gauges"]}
    assert "consul.serf.shard.skew" in names
    assert "consul.serf.shard.imbalance" in names
    skew = next(g["Value"] for g in dump["Gauges"]
                if g["Name"] == "consul.serf.shard.skew")
    assert skew == 0.0


def test_unsharded_pool_publishes_no_shard_gauges():
    from consul_tpu import telemetry
    o = port_oracle(n_nodes=64, rumor_slots=16, seed=5)
    reg = telemetry.Registry()
    with flight.use(fresh()):
        o.publish_sim_metrics(reg)
    assert o.shard_metrics() == {}
    assert not any("shard" in str(g.get("Labels", {})) or
                   g["Name"].startswith("consul.serf.shard.")
                   for g in reg.dump()["Gauges"])


def test_hooks_registry_is_the_default_sink(monkeypatch):
    """publish_sim_metrics with no registry writes to the hooks' registry
    (the telemetry default, as the JAX oracle's), and the user-event
    record reaches the flight recorder with the caller's trace."""
    from consul_tpu import telemetry, trace
    monkeypatch.setattr(telemetry, "_default", telemetry.Registry())
    o = port_oracle(n_nodes=16, rumor_slots=8, seed=9)
    o.advance(2 * o.params.swim.probe_period_ticks)
    o.publish_sim_metrics()
    names = {g["Name"] for g in telemetry.default_registry().dump()["Gauges"]}
    assert "consul.serf.probe.sent" in names
    r = fresh()
    tok = trace.set_current("cafef00d")
    try:
        with flight.use(r):
            o.fire_event("deploy", b"", "node2")
    finally:
        trace.reset(tok)
    ev = r.read(name="serf.user_event")
    assert len(ev) == 1 and ev[0]["trace_id"] == "cafef00d"
    assert ev[0]["labels"]["origin"] == "node2"


# ------------- test_events.py:69, test_agent_ops.py:210,236, and
# ------------- test_device_counters.py:91 against the port


def test_event_ids_monotonic_past_ring_wrap():
    o = port_oracle(n_nodes=8, rumor_slots=8, p_loss=0.0, seed=281)
    last = 0
    with flight.use(fresh()):
        for i in range(300):
            eid = int(o.fire_event(f"e{i}", b"", origin="node0"))
            assert eid > last, f"id regressed at {i}: {eid} <= {last}"
            last = eid
    ring = o.event_list()
    assert len(ring) == 256
    ids = [e["id"] for e in ring]
    assert ids == sorted(ids) and len(set(ids)) == len(ids)
    assert ids[-1] == 300


def test_oracle_spawn_elastic_join():
    o = port_oracle(n_nodes=16, n_initial=12, rumor_slots=8, p_loss=0.0,
                    seed=231)
    assert len(o.members()) == 12
    assert o.members_summary()["total"] == 12
    name = o.spawn("fresh-node")
    assert name == "fresh-node"
    o.advance(150)
    assert o.status("fresh-node") == "alive"
    assert len(o.members()) == 13
    with pytest.raises(ValueError):
        o.spawn("fresh-node")
    for _ in range(3):
        o.spawn()
    with pytest.raises(RuntimeError):
        o.spawn()


def test_spawn_default_name_of_unprovisioned_slot():
    o = port_oracle(n_nodes=16, n_initial=12, rumor_slots=8, p_loss=0.0,
                    seed=232)
    with pytest.raises(KeyError):
        o.node_id("node13")
    assert o.spawn("node13") == "node13"
    assert o.node_id("node13") == 13
    assert o.provisioned_count == 13


def test_oracle_publishes_serf_gauges():
    from consul_tpu.telemetry import Registry
    o = port_oracle(n_nodes=16, rumor_slots=8, seed=9)
    o.advance(2 * o.params.swim.probe_period_ticks)
    reg = Registry(prefix="consul")
    with flight.use(fresh()):
        m = o.publish_sim_metrics(registry=reg)
        assert m["probe.sent"] > 0
        names = {g["Name"] for g in reg.dump()["Gauges"]}
        assert "consul.serf.probe.sent" in names
        assert "consul.serf.queue.depth" in names
        assert "consul.serf.convergence.fraction" in names
        o.publish_sim_metrics(registry=reg)


def test_pacer_ticks_in_the_background_and_stops():
    o = port_oracle(n_nodes=16, rumor_slots=8, seed=10)
    o.start()
    try:
        import time
        deadline = time.time() + 20
        while o.tick < 5 and time.time() < deadline:
            time.sleep(0.01)
        assert o.tick >= 5
        assert o.members_summary()["total"] == 16   # readers get the lock
    finally:
        o.stop()
    assert o._thread is None
    t = o.tick
    o.advance(1)
    assert o.tick == t + 1


# ------------------------------- tests/test_delegate.py on the port

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")


@pytest.fixture(scope="module")
def bridge():
    from consul_tpu.delegate import DelegateServer
    oracle = port_oracle(n_nodes=32, n_initial=24, rumor_slots=16,
                         p_loss=0.0, seed=251)
    srv = DelegateServer(oracle, node_meta={"backend": "tpu-sim",
                                            "dc": "dc1"})
    srv.start()
    yield srv, oracle
    srv.stop()


def call(srv, method, params=None, rid=1):
    with socket.create_connection(srv.address, timeout=10) as s:
        s.sendall(json.dumps({"id": rid, "method": method,
                              "params": params or {}}).encode() + b"\n")
        buf = b""
        while b"\n" not in buf:
            buf += s.recv(65536)
    return json.loads(buf.split(b"\n", 1)[0])


def test_delegate_ping_and_node_meta(bridge):
    srv, _ = bridge
    out = call(srv, "ping")
    assert out["id"] == 1 and "tick" in out["result"]
    assert call(srv, "node_meta")["result"]["backend"] == "tpu-sim"


def test_delegate_members_and_status(bridge):
    srv, _ = bridge
    rows = call(srv, "members", {"limit": 100})["result"]
    assert len(rows) == 24
    assert all(r["Status"] == "alive" for r in rows)
    st = call(srv, "status", {"name": "node3"})["result"]
    assert st == {"Name": "node3", "Status": "alive"}


def test_delegate_join_spawns_new_member(bridge):
    srv, oracle = bridge
    out = call(srv, "join", {"name": "ext-agent-1"})["result"]
    assert out["Joined"] == "ext-agent-1"
    oracle.advance(150)
    assert call(srv, "status",
                {"name": "ext-agent-1"})["result"]["Status"] == "alive"
    assert len(call(srv, "members", {"limit": 100})["result"]) == 25


def test_delegate_notify_msg_and_broadcasts(bridge):
    srv, oracle = bridge
    payload = base64.b64encode(b"deploy v42").decode()
    call(srv, "notify_msg", {"name": "deploy", "payload_b64": payload,
                             "origin": "node0"})
    oracle.advance(100)
    bcasts = call(srv, "get_broadcasts", {"since": 0})["result"]
    assert any(b["Name"] == "deploy"
               and base64.b64decode(b["PayloadB64"]) == b"deploy v42"
               for b in bcasts)
    last = max(b["ID"] for b in bcasts)
    assert call(srv, "get_broadcasts", {"since": last})["result"] == []


def test_delegate_errors_are_responses_not_disconnects(bridge):
    srv, _ = bridge
    out = call(srv, "status", {"name": "no-such"})
    assert "error" in out and "KeyError" in out["error"]
    out = call(srv, "frobnicate")
    assert "error" in out
    assert call(srv, "ping")["result"]["tick"] >= 0


def test_delegate_native_client_end_to_end(bridge, tmp_path):
    srv, oracle = bridge
    src = os.path.join(NATIVE_DIR, "delegate_client.cpp")
    exe = os.path.join(str(tmp_path), "delegate_client")
    try:
        subprocess.run(["g++", "-O2", "-std=c++17", "-o", exe, src],
                       check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError) as e:
        pytest.skip(f"no native toolchain: {e}")
    port = str(srv.port)

    def run(*args):
        out = subprocess.run([exe, port, *args], capture_output=True,
                             timeout=30)
        assert out.returncode == 0, out.stdout + out.stderr
        return json.loads(out.stdout)

    assert "tick" in run("ping")["result"]
    assert run("join", "native-agent")["result"]["Joined"] == "native-agent"
    oracle.advance(150)
    assert run("status", "native-agent")["result"]["Status"] == "alive"
    names = {r["Name"] for r in run("members", "100")["result"]}
    assert "native-agent" in names
    run("fire", "native-event", "hello from c++")
    oracle.advance(100)
    assert run("summary")["result"]["alive"] >= 25
    out = subprocess.run([exe, port, "status", "missing-node"],
                         capture_output=True, timeout=30)
    assert out.returncode == 1 and b"error" in out.stdout


# ------------------------------------------------- agent binding


def test_bind_gives_an_agent_the_port_oracle(tmp_path):
    from consul_tpu.agent import Agent
    from consul_tpu.api.client import Client
    from consul_tpu.delegate import DelegateServer
    cfg = tmp_path / "agent.json"
    cfg.write_text(json.dumps({
        "encrypt": KEY_A,
        "sim": {"n_nodes": 16, "rumor_slots": 8, "p_loss": 0.0,
                "seed": 261}}))
    a = Agent.from_config(config_files=[str(cfg)])
    old = a.oracle
    port = port_oracle(n_nodes=16, rumor_slots=8, p_loss=0.0, seed=261)
    assert agent_bind.bind(a, port) is port
    assert a.oracle is port and a.api.oracle is port
    assert a.dns.oracle is port and a.remote_exec.oracle is port
    assert a.api.query_executor.oracle is port
    assert DelegateServer(a.oracle).oracle is port
    assert port.keyring_list() == old.keyring_list()
    assert port.keyring_list()["PrimaryKeys"] == {KEY_A: 16}
    # a failure only the port's pool has seen
    port.kill("node3")
    port.advance(200)
    assert port.status("node3") == "failed" and old.status("node3") == "alive"
    a.start(tick_seconds=0.05, reconcile_interval=0.5)
    try:
        with pytest.raises(RuntimeError):
            agent_bind.bind(a, port)
        rows = {m["Name"]: m for m in Client(a.http_address).agent_members()}
        assert len(rows) == 16
        # serf's codes: 1 alive, 4 failed (the old pool says alive)
        assert rows["node3"]["Status"] == 4 and rows["node4"]["Status"] == 1
    finally:
        a.stop()
