"""The port's program contracts (consul_tpu_torch/parallel/kernel_audit.py
and kernel_lint.py) on the CPU, mirroring tests/test_hlo_lint.py.

Every rule of the judge fires on a fabricated record that breaks it and
stays silent on the clean one; a record from another topology refuses
rather than judges; registry parity holds over the tree and fires on an
uncovered and on a stale launch site; every registry entry is measured at
N = 256 and judged against its own record; the committed manifest covers
every entry on both topologies; the check command exits 0 on the CPU with
its JSON shape and 2 against a cuda-stamped record; read entries' outputs
do not grow from N = 256 to 512; and each entry's state has the bytes per
node slot that the JAX package's own ledger (hlo_audit.bytes_per_slot)
gives the reference's state at the same configuration.
"""

import copy
import json
import os
import subprocess
import sys

import pytest
import torch

from consul_tpu_torch import bench, kernels
from consul_tpu_torch.parallel import kernel_audit as ka
from consul_tpu_torch.parallel import kernel_lint as kl
from consul_tpu_torch.parallel import mesh as meshlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
NAMES = [spec.name for spec in ka.REGISTRY]
SPECS = {spec.name: spec for spec in ka.REGISTRY}
# the entries whose outputs a caller copies to the host
READS = ["serf.metrics", "serf.shard_metrics", "oracle.membership_counts",
         "oracle.membership_delta", "oracle.membership_page",
         "oracle.rtt_order", "oracle.coord_row", "oracle.reads.sharded"]
SHARDED = [spec.name for spec in ka.REGISTRY if spec.sharded]


def stamp(name, device="cpu"):
    """The topology stamp an entry's record carries: a sharded entry's
    names its mesh of SHARD_BLOCKS blocks."""
    if not SPECS[name].sharded:
        return ka.topology_stamp(device)
    return ka.topology_stamp(device, meshlib.make_mesh(
        [device] * ka.SHARD_BLOCKS))

# a clean fabricated card record and its budget twin: each judge test
# perturbs exactly one field
FORM = {
    "launches": {"threefry_draws": 2, "probe_round": 1, "originate": 2},
    "kernels": {"threefry_draws_kernel": 2, "probe_round_kernel": 1,
                "originate_kernel": 2, "vectorized_elementwise_kernel": 1},
    "device_kernels": 6, "syncs": 1, "flag_syncs": 1, "allocations": 30,
    "peak_bytes": 1_000_000, "inplace": {"leaves": 20, "moved": []},
    "repeat_same": True,
}
BASE = {
    "topology": {"backend": "cuda", "devices": 1, "arch": "sm_90",
                 "mesh_shape": None},
    "n_nodes": 1_000_000, "bytes_per_slot": 493, "page_elements": None,
    "library_loads": 1, "forms": {"probe": FORM},
}


def judge(run_over=None, form_over=None, base_over=None, tol=0.25):
    run = copy.deepcopy(BASE)
    run.update(run_over or {})
    run["forms"]["probe"].update(form_over or {})
    base = copy.deepcopy(BASE)
    base.update(base_over or {})
    return ka.judge_record(run, base, tol)


def rules_fired(verdict):
    return {f["rule"] for f in verdict["failures"]}


# ------------------------------------------------- judge falsifiability


def test_judge_clean_record_is_silent():
    v = judge()
    assert v["ok"] and v["verdict"] == "ok" and not v["failures"]


def test_launch_count_fires_on_more_fewer_and_other_launches():
    more = judge(form_over={"launches": {**FORM["launches"], "originate": 3}})
    assert "launch-count" in rules_fired(more)
    fewer = judge(form_over={"launches": {"threefry_draws": 2,
                                          "originate": 2}})
    assert "launch-count" in rules_fired(fewer)     # K7 left the path
    other = judge(form_over={"launches": {**FORM["launches"],
                                          "bulk_step": 1}})
    assert not other["ok"] and "launch-count" in rules_fired(other)


def test_kernel_census_fires_on_count_and_family():
    over = judge(form_over={"kernels": {**FORM["kernels"],
                                        "originate_kernel": 3}})
    assert "kernel-census" in rules_fired(over)
    alien = judge(form_over={"kernels": {
        **FORM["kernels"], "elementwise_kernel<long, long>": 1}})
    assert "kernel-family" in rules_fired(alien)
    # a dropped profiler record (fewer kernels) is not a violation
    dropped = dict(FORM["kernels"])
    dropped.pop("vectorized_elementwise_kernel")
    assert judge(form_over={"kernels": dropped})["ok"]
    # the CPU has no census: nothing to judge
    assert judge(form_over={"kernels": None})["ok"]


def test_host_sync_fires_on_either_count():
    assert "host-sync" in rules_fired(judge(form_over={"syncs": 2}))
    assert "host-sync" in rules_fired(judge(form_over={"flag_syncs": 2}))
    assert judge(form_over={"syncs": 0, "flag_syncs": 0})["ok"]
    assert judge(form_over={"syncs": None})["ok"]     # the CPU's record


def test_host_transfer_fires_when_a_read_grows_with_n():
    v = judge({"page_elements": [256, 512]})
    assert not v["ok"] and "host-transfer" in rules_fired(v)
    assert judge({"page_elements": [513, 513]})["ok"]


def test_in_place_fires_on_a_moved_leaf_and_null_is_no_pass():
    v = judge(form_over={"inplace": {"leaves": 20,
                                     "moved": ["swim.sus_start"]}})
    assert not v["ok"] and "in-place" in rules_fired(v)
    # the CPU's twins return fresh tensors: the record holds null
    assert judge(form_over={"inplace": None})["ok"]


def test_bytes_per_slot_fires_on_widening_only():
    v = judge({"bytes_per_slot": 497})
    assert not v["ok"] and "bytes-per-slot" in rules_fired(v)
    assert judge({"bytes_per_slot": 400})["ok"]    # narrowing is fine


def test_peak_bytes_fires_outside_tolerance_allocations_above_budget():
    assert "peak-bytes" in rules_fired(
        judge(form_over={"peak_bytes": 1_500_000}))
    assert "peak-bytes" in rules_fired(
        judge(form_over={"peak_bytes": 500_000}))
    assert judge(form_over={"peak_bytes": 1_100_000})["ok"]   # within 25%
    assert "allocations" in rules_fired(judge(form_over={"allocations": 31}))
    assert judge(form_over={"allocations": 29})["ok"]
    # a budget of 0 peak bytes (K5 a call): any peak at all fires
    zero = copy.deepcopy(BASE)
    zero["forms"]["probe"]["peak_bytes"] = 0
    run = copy.deepcopy(zero)
    run["forms"]["probe"]["peak_bytes"] = 512
    assert "peak-bytes" in rules_fired(ka.judge_record(run, zero, 0.25))


def test_one_build_fires_on_a_second_load_or_a_first_call_difference():
    assert "one-build" in rules_fired(judge({"library_loads": 2}))
    assert "one-build" in rules_fired(judge(form_over={"repeat_same": False}))
    assert judge({"library_loads": None})["ok"]       # the CPU loads none


def test_a_form_without_a_budget_fires():
    run = copy.deepcopy(BASE)
    run["forms"]["gossip"] = copy.deepcopy(FORM)
    v = ka.judge_record(run, BASE, 0.25)
    assert not v["ok"] and "form" in rules_fired(v)


def test_topology_mismatch_refuses_not_judges():
    """A card's budget never gates a CPU record or another card's, even
    when the record would break every rule."""
    for topo in ({"backend": "cpu", "devices": 1, "arch": None,
                  "mesh_shape": None},
                 {"backend": "cuda", "devices": 1, "arch": "sm_80",
                  "mesh_shape": None}):
        v = judge({"topology": topo, "bytes_per_slot": 999,
                   "library_loads": 3},
                  form_over={"launches": {}, "syncs": 9})
        assert not v["ok"] and v["verdict"] == "topology"
        assert not v["failures"]


def test_scaling_needs_sharded_topologies():
    v = ka.judge_scaling({"cuda": BASE}, 0.25)
    assert v["ok"] and "needs >=2 sharded" in v["note"]


def _scaling(per_block, rows, n=1 << 20):
    """Hand-made records at B = 1, 2, 4: `per_block(b)` launches of the
    per-block kernels and `rows(b)` the largest tensor a call made."""
    return {str(b): {"launches": {"gossip_pack_blocks": per_block(b),
                                  "gossip_combine": 2},
                     "max_rows": rows(b), "n_nodes": n} for b in (1, 2, 4)}


def test_scaling_holds_a_launch_a_block_and_no_tensor_past_a_block():
    n = 1 << 20
    v = ka.judge_scaling(_scaling(lambda b: 2 * b, lambda b: n // b), 0.25)
    assert v["ok"] and v["launch_growth"] == 1.0
    assert v["ratios"]["launches_per_block"] == {"1": 2.0, "2": 2.0, "4": 2.0}
    # small tensors (pages, counts) are far inside a block at any B
    assert ka.judge_scaling(_scaling(lambda b: b, lambda b: 20), 0.25)["ok"]
    # a rotation that launched once per peer pair: O(B^2) launches
    v = ka.judge_scaling(_scaling(lambda b: b * b, lambda b: n // b), 0.25)
    assert not v["ok"] and v["launch_growth"] == 4.0
    # a gathered [N] leaf at B = 4
    v = ka.judge_scaling(_scaling(lambda b: b, lambda b: n), 0.25)
    assert not v["ok"] and v["widest_block_share"] == 4.0
    # fewer launches a block as B grows is never a violation
    assert ka.judge_scaling(_scaling(lambda b: 4, lambda b: n // b),
                            0.25)["ok"]


def test_gather_law_fires_on_a_deliberate_full_n_allocation():
    """The rule reads every tensor an op makes: a sharded call that makes
    an [N] buffer fails it, block-sized work passes."""
    n = 256
    x = meshlib.shard_state(torch.arange(n), meshlib.make_mesh(["cpu"] * 4),
                            n)
    with ka.RowCensus(["cpu"]) as census:
        x.map(lambda p: p * 2)
    assert ka.gather_law(census.rows, n)["ok"]
    with ka.RowCensus(["cpu"]) as census:
        x.map(lambda p: p * 2)
        torch.zeros(n, dtype=torch.int8)          # the deliberate gather
    law = ka.gather_law(census.rows, n)
    assert not law["ok"] and law["gathered"] == {"cpu": n}
    # as a judged record: the form's max_rows fires the rule
    rec = copy.deepcopy(BASE)
    rec["forms"]["probe"]["max_rows"] = dict(census.rows)
    rec["n_nodes"] = n
    assert "gather" in rules_fired(ka.judge_record(rec, BASE, 0.25))
    rec["forms"]["probe"]["max_rows"] = {"cpu": n // 4}
    assert ka.judge_record(rec, BASE, 0.25)["ok"]


def test_committed_sharded_records_hold_the_gather_and_scaling_laws():
    manifest = kl.load_baseline(kl.DEFAULT_BASELINE)
    for name in SHARDED:
        for backend, rec in manifest["entries"][name].items():
            for form, f in rec["forms"].items():
                assert ka.gather_law(f["max_rows"], rec["n_nodes"])["ok"], \
                    (name, backend, form)
            v = ka.judge_scaling(rec["scaling"], manifest["tolerance"])
            assert v["ok"] and set(v["ratios"]["launches_per_block"]) == \
                {"1", "2", "4"}, (name, backend, v)
    card = manifest["entries"]["serf.step.sharded"]["cuda"]
    assert card["topology"]["mesh_shape"] == {"nodes": ka.SHARD_BLOCKS}
    gossip = card["forms"]["gossip"]["launches"]
    b = ka.SHARD_BLOCKS
    assert {k: gossip[k] for k in ("gossip_pack_blocks",
                                   "gossip_exchange_blocks",
                                   "believed_down_blocks", "gossip_combine",
                                   "believed_down_combine")} == {
        "gossip_pack_blocks": 2 * b, "gossip_exchange_blocks": 2 * b,
        "believed_down_blocks": b, "gossip_combine": 2,
        "believed_down_combine": 1}
    assert not any(k in gossip for k in ("gossip_pack", "gossip_exchange",
                                         "believed_down"))


def test_launch_coverage_names_the_kernels_no_entry_launched():
    every = {name: 1 for name in kernels.KERNELS}
    assert ka.launch_coverage({"a": {"forms": {"f": {"launches": every}}}})[
        "ok"]
    partial = dict(every, mass_detect=0)
    partial.pop("bulk_step")
    cov = ka.launch_coverage({"a": {"forms": {"f": {"launches": partial}}}})
    assert not cov["ok"] and cov["missing"] == ["mass_detect", "bulk_step"]


def test_bytes_per_slot_counts_node_axis_tensors():
    n = 32
    narrow = {"a": torch.zeros(n, dtype=torch.int8),
              "b": torch.zeros((n, 4), dtype=torch.float32),
              "scalar": torch.zeros((), dtype=torch.float32),
              "table": torch.zeros(8, dtype=torch.int32)}
    assert ka.bytes_per_slot(narrow, n) == 1 + 16
    wide = dict(narrow, a=torch.zeros(n, dtype=torch.int32))
    assert ka.bytes_per_slot(wide, n) == 4 + 16


# --------------------------------------------------------- registry side


def test_registry_holds_the_seventeen_entries():
    """The seventeen entries of one device, then the two of a node-sharded
    pool."""
    assert NAMES == [
        "serf.scan", "serf.step", "serf.metrics", "serf.status_vector",
        "serf.shard_metrics", "oracle.membership_counts",
        "oracle.membership_delta", "oracle.membership_page",
        "oracle.rtt_order", "oracle.coord_row", "chaos.swim_run",
        "correlated.tick", "wan.run", "antientropy.step",
        "antientropy.register_desired", "antientropy.deregister_desired",
        "vivaldi.sim_step", "serf.step.sharded", "oracle.reads.sharded"]
    assert SHARDED == ["serf.step.sharded", "oracle.reads.sharded"]
    assert ka.TOPOLOGIES == ("cpu", "cuda")


def test_registry_parity_tree_wide():
    """Every kernels.launch_* call under consul_tpu_torch/ is an entry's
    cover or suppressed with a reason, and none of either is stale."""
    sites = kl.scan_launch_sites()
    assert len(sites) == len(set(sites)) >= 21
    parity = ka.registry_parity(sites)
    assert parity["ok"], parity


def test_registry_parity_fires_on_uncovered_and_stale():
    sites = kl.scan_launch_sites()
    seeded = sites + [("consul_tpu_torch/models/ae_kernel.py",
                       "register_desired", "launch_ae_merge")]
    p = ka.registry_parity(seeded)
    assert not p["ok"] and ["consul_tpu_torch/models/ae_kernel.py",
                            "register_desired",
                            "launch_ae_merge"] in p["uncovered"]
    gone = ("consul_tpu_torch/models/swim.py", "_bulk_step",
            "launch_bulk_step")
    p = ka.registry_parity([s for s in sites if s != gone])
    assert not p["ok"] and list(gone) in p["stale"]


def test_launch_site_scan_names_file_function_and_launcher(tmp_path):
    pkg = tmp_path / "consul_tpu_torch" / "models"
    pkg.mkdir(parents=True)
    (pkg / "x.py").write_text(
        "from consul_tpu_torch import kernels\n"
        "def outer(a):\n"
        "    def inner(b):\n"
        "        kernels.launch_map_add(b)\n"
        "    kernels.launch_draws(a)\n"
        "    return [kernels.launch_draws(c) for c in a]\n"
        "launch_draws = kernels.other(1)\n")
    got = kl.scan_launch_sites(str(tmp_path))
    assert sorted(got) == sorted([
        ("consul_tpu_torch/models/x.py", "inner", "launch_map_add"),
        ("consul_tpu_torch/models/x.py", "outer", "launch_draws"),
        ("consul_tpu_torch/models/x.py", "outer", "launch_draws")])


@pytest.mark.parametrize("name", NAMES)
def test_measure_judge_roundtrip_on_the_cpu(name):
    """Each entry measured at N = 256 on the CPU judges green against its
    own record, and a budget one byte narrower fires the ledger rule; only
    the READS have a page."""
    rec = ka.measure_entry(SPECS[name], "cpu")
    assert (rec["page_elements"] is not None) == (name in READS)
    assert rec["topology"] == stamp(name)
    assert rec["library_loads"] is None
    for form in rec["forms"].values():
        assert form["kernels"] is None and form["inplace"] is None
        assert form["launches"] == {}          # the twins launch nothing
        assert form["repeat_same"] is True
    v = ka.judge_record(rec, rec, 0.25)
    assert v["ok"], v
    tight = dict(rec, bytes_per_slot=rec["bytes_per_slot"] - 1)
    assert "bytes-per-slot" in rules_fired(ka.judge_record(rec, tight, 0.25))


@pytest.mark.parametrize("name", READS)
def test_read_outputs_do_not_grow_with_n(name):
    spec = SPECS[name]
    small, large = spec.build(CPU, 1), spec.build(CPU, 2)
    assert small.page is not None
    assert (small.n_nodes, large.n_nodes) == (256, 512)
    sizes = []
    for prog in (small, large):
        call = next(iter(prog.forms.values()))
        sizes.append(ka.page_elements(prog.page(call.fn(call.make()))))
    assert sizes[0] == sizes[1] > 0


def test_probe_ticks_read_one_bulk_flag_on_the_cpu_too():
    rec = ka.measure_entry(SPECS["serf.step"], "cpu")
    assert rec["forms"]["probe"]["flag_syncs"] == 1
    assert rec["forms"]["gossip"]["flag_syncs"] == 0


# ----------------------------------------------- committed manifest + CLI


@pytest.mark.parametrize("name", NAMES)
def test_committed_manifest_covers_every_entry_on_both_topologies(name):
    manifest = kl.load_baseline(kl.DEFAULT_BASELINE)
    assert manifest.get("version") == "r01"
    assert 0 < manifest.get("tolerance", 0) < 1
    by_backend = manifest["entries"][name]
    assert set(by_backend) == {"cpu", "cuda"}
    cpu, card = by_backend["cpu"], by_backend["cuda"]
    assert cpu["topology"] == stamp(name)
    assert card["topology"]["backend"] == "cuda"
    assert card["topology"]["arch"] == "sm_90"
    assert card["library_loads"] == 1
    assert set(cpu["forms"]) == set(card["forms"])
    for form in card["forms"].values():
        assert form["kernels"] and form["device_kernels"] >= 1
        assert form["inplace"]["moved"] == [] and form["repeat_same"]
    if card["page_elements"] is not None:
        assert card["page_elements"][0] == card["page_elements"][1]


def test_committed_card_records_launch_every_kernel():
    manifest = kl.load_baseline(kl.DEFAULT_BASELINE)
    records = {name: by["cuda"] for name, by in manifest["entries"].items()}
    assert ka.launch_coverage(records) == {"ok": True, "missing": []}
    # the contracts chip_smoke.py held before the registry, now budgets
    step = records["serf.step"]["forms"]
    assert step["gossip"]["launches"]["threefry_draws"] == 1
    assert step["gossip"]["syncs"] == 0
    assert step["probe"]["launches"]["threefry_draws"] == 2
    assert step["probe"]["launches"]["probe_round"] == 1
    assert step["probe"]["launches"]["originate"] >= 2
    assert all(step["probe"]["launches"][k] >= 1 for k in kernels.DETECTOR)
    assert step["probe"]["syncs"] == 1
    assert not any("elementwise" in k and "long" in k
                   for k in step["gossip"]["kernels"])
    assert records["oracle.membership_counts"]["forms"]["read"][
        "device_kernels"] == 1
    assert records["oracle.membership_delta"]["forms"]["read"][
        "device_kernels"] == 2
    detect = records["correlated.tick"]["forms"]["detect"]
    assert detect["device_kernels"] == 1 and detect["allocations"] == 0
    merge = records["antientropy.step"]["forms"]["merge"]
    assert merge["device_kernels"] == 1 and merge["allocations"] == 3
    bulk = records["correlated.tick"]["forms"]["gossip"]["launches"]
    assert {k: bulk.get(k) for k in ("threefry_draws", "gossip_pack",
                                     "gossip_exchange", "bulk_step")} \
        == {"threefry_draws": 1, "gossip_pack": 1, "gossip_exchange": 1,
            "bulk_step": 1}


def _lint(*args):
    return subprocess.run(
        [sys.executable, "-m", "consul_tpu_torch.parallel.kernel_lint",
         *args], capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))


def test_check_cli_green_on_the_cpu_with_its_json_shape():
    out = _lint("--check", "--device", "cpu", "--json")
    assert out.returncode == 0, out.stdout + out.stderr
    payload = json.loads(out.stdout)
    assert payload["ok"] is True and payload["tool"] == "kernel_lint"
    assert payload["device"] == "cpu" and payload["entries"] == len(NAMES)
    assert payload["parity"]["ok"] is True
    assert payload["violations"] == [] and payload["refused"] == []
    assert payload["coverage"] is None           # judged on the card only
    assert payload["wall_s"] < 120
    assert set(payload["records"]) == set(NAMES)
    for name, rec in payload["records"].items():
        assert payload["verdicts"][name]["ok"] is True
        assert payload["verdicts"][name]["scaling"]["ok"] is True
        assert rec["topology"]["backend"] == "cpu" and rec["forms"]


def test_check_cli_refuses_a_cuda_stamped_record(tmp_path):
    manifest = kl.load_baseline(kl.DEFAULT_BASELINE)
    for by_backend in manifest["entries"].values():
        by_backend["cpu"] = by_backend["cuda"]
    path = tmp_path / "budget.json"
    kl.save_baseline(str(path), manifest)
    out = _lint("--check", "--device", "cpu", "--baseline", str(path))
    assert out.returncode == 2, out.stdout + out.stderr
    payload = json.loads(out.stdout)
    assert not payload["ok"] and payload["violations"] == []
    assert len(payload["refused"]) == len(NAMES)
    assert all("topology" in r["why"] for r in payload["refused"])


def test_the_check_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kl.check()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kl.main(["--check"])


def test_bench_rows_carry_the_topology_and_no_library_load_on_the_cpu():
    r = bench.run_convergence(n_nodes=64, chunk=20, victim=21, max_ticks=20,
                              device="cpu")
    assert r["topology"] == {"backend": "cpu", "devices": 1, "arch": None,
                             "mesh_shape": None}
    assert r["library_loads"] is None


# -------------------------------------- bytes per slot against the JAX ledger


def _reference_state(name):
    """(JAX state, slots): the reference's own init_state at the
    configuration the entry builds on the CPU."""
    from consul_tpu import config as jconfig
    from consul_tpu.models import antientropy as jae
    from consul_tpu.models import serf as jserf
    from consul_tpu.models import swim as jswim
    from consul_tpu.models import vivaldi as jviv
    from consul_tpu.models import wan as jwan
    sim = dict(n_nodes=256, rumor_slots=16, alloc_cap=8, p_loss=0.01,
               seed=7)
    if name.startswith(("serf.", "oracle.")):
        s = jserf.init_state(jserf.make_params(
            jconfig.GossipConfig.lan(), jconfig.SimConfig(**sim)))
        return (s.coords if name == "oracle.coord_row" else s), 256
    if name in ("chaos.swim_run", "correlated.tick"):
        return jswim.init_state(jswim.make_params(
            jconfig.GossipConfig.lan(), jconfig.SimConfig(**sim))), 256
    if name == "wan.run":
        return jwan.init_state(jwan.make_params(
            3, 256, 5, p_loss=0.01, seed=7, rumor_slots=16,
            event_slots=16)), 256
    if name.startswith("antientropy."):
        return jae.init_state(jae.AEParams(
            n_agents=256, capacity=4608, sync_interval_ticks=60,
            seed=7)), 4608
    if name == "vivaldi.sim_step":
        return jviv.init_state(jviv.VivaldiParams(n_nodes=256, dims=8,
                                                  seed=7)), 256
    raise KeyError(name)


@pytest.mark.parametrize("name", NAMES)
def test_bytes_per_slot_equals_the_reference_ledger(name):
    from consul_tpu.parallel import hlo_audit
    prog = SPECS[name].build(CPU, 1)
    state, slots = _reference_state(name)
    assert prog.slots == slots
    want = hlo_audit.bytes_per_slot(state, slots)
    assert ka.bytes_per_slot(prog.state, prog.slots) == want
    if name in ("serf.scan", "chaos.swim_run"):
        # the reference's own ledger rows at this configuration
        assert want == {"serf.scan": 429, "chaos.swim_run": 109}[name]
