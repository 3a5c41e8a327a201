"""The port stands alone: importing every module of consul_tpu_torch and
chip_smoke.py loads no JAX, no flax and nothing of the JAX package; its
entry points never land on the CPU unasked; its kernel wrappers refuse
bad tensors before anything is launched."""

import ctypes
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import consul_tpu_torch
from consul_tpu_torch import bench, config, kernels
from consul_tpu_torch.models import serf

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "jaxlib", "consul_tpu")
             or m.startswith(("jax.", "flax.", "jaxlib.", "consul_tpu.")))
print(len(sys.argv) - 1, "modules")
if bad:
    sys.exit("imported: " + ", ".join(bad[:20]))
"""


def _port_modules():
    names = ["consul_tpu_torch"]
    for info in pkgutil.walk_packages(consul_tpu_torch.__path__,
                                      prefix="consul_tpu_torch."):
        names.append(info.name)
    return names


def test_port_imports_no_jax_and_no_reference_package():
    names = _port_modules()
    assert {"consul_tpu_torch.models.swim", "consul_tpu_torch.ops.gossip",
            "consul_tpu_torch.kernels", "consul_tpu_torch.bench"} <= set(names)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _PROBE, *names, "chip_smoke"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"{len(names) + 1} modules" in proc.stdout


def test_port_sources_never_name_the_reference_package():
    for path in [*Path(consul_tpu_torch.__file__).parent.rglob("*.py"),
                 REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                mod = stripped.split()[1]
                assert mod.split(".")[0] not in ("jax", "flax", "consul_tpu"), \
                    f"{path}: {stripped}"


def test_entry_points_raise_without_a_card_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = serf.make_params(config.GossipConfig.lan(),
                              config.SimConfig(n_nodes=64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serf.init_state(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_convergence(n_nodes=64, victim=21)
    assert serf.init_state(params, device="cpu").swim.up.device.type == "cpu"


def _gossip_args(n=16, s=8, g=3):
    know = torch.zeros(n, s, dtype=torch.bool)
    word = torch.int32 if s <= 32 else torch.int64
    return dict(know=know, sends_left=torch.zeros(n, s, dtype=torch.int8),
                offsets=torch.arange(1, g + 1, dtype=torch.int32),
                sender_ok=torch.ones(n, dtype=torch.bool),
                receiver_ok=torch.ones(n, dtype=torch.bool),
                slot_active=torch.ones(s, dtype=torch.bool), limit=4,
                new_know=torch.empty_like(know),
                new_sends=torch.empty(n, s, dtype=torch.int8),
                kword=torch.empty(n, dtype=word),
                qword=torch.empty(n, dtype=word),
                counters=torch.empty(3, dtype=torch.float32),
                key=(1, 2), p_ok=0.99,
                learn_tick=torch.zeros(n, s, dtype=torch.int16),
                new_learn=torch.empty(n, s, dtype=torch.int16), tick16=5,
                newly=None, ctr=torch.zeros(7), ctr_out=torch.empty(7))


def _monitor_args(n=16, u=8):
    z = lambda *shape, dtype=torch.bool: torch.zeros(shape, dtype=dtype)  # noqa: E731
    return dict(know=z(n, u), learn_tick=z(n, u, dtype=torch.int16),
                up=z(n), member=z(n), r_active=z(u),
                r_kind=z(u, dtype=torch.int8), r_subject=z(u, dtype=torch.int32),
                r_inc=z(u, dtype=torch.int32), r_confirm=z(u, dtype=torch.int8),
                timeouts=z(65, dtype=torch.int16), committed_dead=z(n),
                committed_left=z(n), committed_inc=z(n, dtype=torch.int32),
                bulk_member=z(n), bulk_cov=z(n, dtype=torch.float32),
                subject=3, tick16=0, out=z(1, dtype=torch.float32))


def test_kernel_wrappers_reject_bad_tensors_before_launching():
    before = dict(kernels.LAUNCHES)
    args = _gossip_args()
    args["sends_left"] = torch.zeros(16, 8, dtype=torch.int16)
    with pytest.raises(ValueError, match="sends_left"):
        kernels.launch_gossip(**args)
    args = _gossip_args()
    args["offsets"] = torch.ones(17, dtype=torch.int32)
    with pytest.raises(ValueError, match="contacts"):
        kernels.launch_gossip(**args)
    with pytest.raises(ValueError, match="elements"):
        kernels.launch_draws([kernels.Segment("uniform", ((0, 7),),
                                              torch.empty(9), 10)])
    assert kernels.LAUNCHES == before      # a refused launch is not counted


META = torch.device("meta")

GOSSIP_BAD = {
    # case: (the arguments' edit, the message it raises with)
    "know dtype": (dict(know=torch.zeros(16, 8, dtype=torch.uint8)), "know"),
    "offsets dtype": (dict(offsets=torch.arange(1, 4)), "offsets"),
    "learn_tick dtype": (dict(learn_tick=torch.zeros(16, 8, dtype=torch.int32)),
                         "learn_tick"),
    "ctr dtype": (dict(ctr=torch.zeros(7, dtype=torch.float64)), "ctr"),
    "receiver device": (dict(receiver_ok=torch.ones(16, dtype=torch.bool,
                                                    device=META)), "receiver_ok"),
    "new_sends device": (dict(new_sends=torch.empty(16, 8, dtype=torch.int8,
                                                    device=META)), "new_sends"),
    "sender shape": (dict(sender_ok=torch.ones(15, dtype=torch.bool)), "sender_ok"),
    "slot_active shape": (dict(slot_active=torch.ones(9, dtype=torch.bool)),
                          "slot_active"),
    "newly shape": (dict(newly=torch.empty(16, 9, dtype=torch.bool)), "newly"),
    "word width": (dict(kword=torch.empty(16, dtype=torch.int64)), "kword"),
    "not contiguous": (dict(know=torch.zeros(8, 16, dtype=torch.bool).t()), "know"),
    "learn without output": (dict(new_learn=None), "learn_tick"),
    "ctr without output": (dict(ctr_out=None), "ctr"),
    "ctr too short": (dict(ctr=torch.zeros(2), ctr_out=torch.empty(2)),
                      "at least 3"),
    "limit": (dict(limit=200), "limit"),
    "G > 16": (dict(offsets=torch.ones(17, dtype=torch.int32)), "contacts"),
    "chaos group dtype": (dict(group=torch.zeros(16, dtype=torch.int32)),
                          "group"),
    "chaos group shape": (dict(group=torch.zeros(15, dtype=torch.int16)),
                          "group"),
    "chaos node_ok dtype": (dict(node_ok=torch.ones(16, dtype=torch.float64)),
                            "node_ok"),
    "chaos node_ok device": (dict(node_ok=torch.ones(16, device=META)),
                             "node_ok"),
    "chaos without a key": (dict(key=None,
                                 group=torch.zeros(16, dtype=torch.int16)),
                            "needs a key"),
}


@pytest.mark.parametrize("case", sorted(GOSSIP_BAD))
def test_gossip_wrapper_rejects(case):
    edit, match = GOSSIP_BAD[case]
    args = _gossip_args()
    args.update(edit)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        kernels.launch_gossip(**args)
    assert kernels.LAUNCHES == before


def test_gossip_wrapper_rejects_more_than_64_slots():
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="slots"):
        kernels.launch_gossip(**_gossip_args(s=65))
    assert kernels.LAUNCHES == before


MONITOR_BAD = {
    "missing timeout table": (dict(timeouts=None), "timeout table"),
    "timeout table dtype": (dict(timeouts=torch.zeros(65, dtype=torch.int32)),
                            "timeout table"),
    "timeout table length": (dict(timeouts=torch.zeros(64, dtype=torch.int16)),
                             "timeout table"),
    "r_kind dtype": (dict(r_kind=torch.zeros(8, dtype=torch.int32)), "r_kind"),
    "r_confirm shape": (dict(r_confirm=torch.zeros(9, dtype=torch.int8)),
                        "r_confirm"),
    "learn_tick device": (dict(learn_tick=torch.zeros(16, 8, dtype=torch.int16,
                                                      device=META)), "learn_tick"),
    "bulk_cov dtype": (dict(bulk_cov=torch.zeros(16)[None].double()[0]),
                       "bulk_cov"),
    "out shape": (dict(out=torch.empty(2)), "out"),
    "subject": (dict(subject=16), "subject"),
    "U > 64": (dict(know=torch.zeros(16, 65, dtype=torch.bool)), "slots"),
}


@pytest.mark.parametrize("case", sorted(MONITOR_BAD))
def test_monitor_wrapper_rejects(case):
    edit, match = MONITOR_BAD[case]
    args = _monitor_args()
    args.update(edit)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        kernels.launch_believed_down(**args)
    assert kernels.LAUNCHES == before


def _segment(mode="uniform", n=8, **edit):
    int_out = mode in ("bits", "randint")
    args = dict(mode=mode, keys=((1, 2), (3, 4)) if mode == "randint"
                else ((1, 2),),
                out=torch.empty(n, dtype=torch.int32 if int_out
                                else torch.float32), n=n)
    if mode == "randint":
        args.update(minval=1, range=n, mult=0)
    args.update(edit)
    return kernels.Segment(**args)


DRAWS_BAD = {
    # case: (the segment table, the message it raises with)
    "no segments": (lambda: [], "segments"),
    "too many segments": (lambda: [_segment() for _ in range(9)], "segments"),
    "unknown mode": (lambda: [_segment(mode="gamma")], "mode"),
    "uniform out dtype": (lambda: [_segment(out=torch.empty(8, dtype=torch.int32))],
                          "out"),
    "randint out dtype": (lambda: [_segment("randint", out=torch.empty(8))],
                          "out"),
    "bits out dtype": (lambda: [_segment("bits", out=torch.empty(8))], "out"),
    "out too small": (lambda: [_segment(out=torch.empty(7))], "elements"),
    "out too large": (lambda: [_segment("normal"), _segment(out=torch.empty(9))],
                      "elements"),
    "empty segment": (lambda: [_segment(n=0, out=torch.empty(0))], "elements"),
    "out not contiguous": (lambda: [_segment(n=8, out=torch.empty(4, 2).t())],
                           "out"),
    "out on another device": (lambda: [_segment(), _segment(
        "exponential", out=torch.empty(8, device=META))], "out"),
    "randint with one key": (lambda: [_segment("randint", keys=((1, 2),))],
                             "keys"),
    "uniform with two keys": (lambda: [_segment(keys=((1, 2), (3, 4)))], "keys"),
    "randint range 0": (lambda: [_segment("randint", range=0)], "range"),
}


@pytest.mark.parametrize("case", sorted(DRAWS_BAD))
def test_draws_wrapper_rejects(case):
    table, match = DRAWS_BAD[case]
    before = dict(kernels.LAUNCHES), dict(kernels.DRAW_LAUNCHES)
    with pytest.raises(ValueError, match=match):
        kernels.launch_draws(table())
    assert (kernels.LAUNCHES, kernels.DRAW_LAUNCHES) == before


def test_draw_spec_matches_the_kernel_source():
    """kernels.DrawSpec has common.cuh's DrawSpec fields (K1's segment,
    K14's ring offsets), in order, with their C types and the size the
    source asserts; the segment limit, elements per thread and mode
    numbers are threefry.cu's; the key schedule is the one common.cuh's
    threefry_key builds."""
    csrc = Path(kernels.__file__).parent / "csrc"
    common = (csrc / "common.cuh").read_text()
    text = (csrc / "threefry.cu").read_text()
    body = re.search(r"struct DrawSpec \{(.*?)\};", common, re.S).group(1)
    c_types = {"void*": ctypes.c_void_p, "int64_t": ctypes.c_int64,
               "int32_t": ctypes.c_int32, "uint32_t": ctypes.c_uint32,
               "float": ctypes.c_float}
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        words = decl.replace("*", "* ").split()
        if not words:
            continue
        name, size = re.fullmatch(r"(\w+)(?:\[(\d+)\])?", words[-1]).groups()
        t = c_types["".join(words[:-1])]
        fields.append((name, t * int(size) if size else t))
    assert [(n, ctypes.sizeof(t), getattr(t, "_type_", t))
            for n, t in fields] == \
        [(n, ctypes.sizeof(t), getattr(t, "_type_", t))
         for n, t in kernels.DrawSpec._fields_]
    size = int(re.search(r"sizeof\(DrawSpec\) == (\d+)", common).group(1))
    assert ctypes.sizeof(kernels.DrawSpec) == size
    assert int(re.search(r"kMaxSegments = (\d+);", text).group(1)) == \
        kernels.MAX_SEGMENTS
    assert int(re.search(r"kPer = (\d+);", text).group(1)) == \
        kernels.DRAW_ELEMENTS_PER_THREAD
    modes = re.search(r"enum Mode[^{]*\{(.*?)\};", text, re.S).group(1)
    assert re.findall(r"k(\w+) = (\d+)", modes)[:5] == \
        [(m.capitalize(), str(i)) for i, m in enumerate(kernels.DRAW_MODES)]
    k0, k1 = 0x12345678, 0x9ABCDEF0
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    assert kernels._schedule((k0, k1)) == [
        k0, k1, k2, (k2 + 1) & 0xFFFFFFFF, (k0 + 2) & 0xFFFFFFFF,
        (k1 + 3) & 0xFFFFFFFF, (k2 + 4) & 0xFFFFFFFF, (k0 + 5) & 0xFFFFFFFF]


_C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
            "int64_t": ctypes.c_int64, "uint32_t": ctypes.c_uint32,
            "float": ctypes.c_float}


def _c_entry_points():
    """{name: [ctypes type per argument]} of every extern "C" function in
    the kernel sources."""
    found = {}
    for src in (Path(kernels.__file__).parent / "csrc").glob("*.cu"):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            types = []
            for arg in m.group(2).split(","):
                words = arg.replace("const ", "").replace("*", "* ").split()
                types.append(_C_TYPES["".join(words[:-1])])
            found[m.group(1)] = types
    return found


def test_ctypes_signatures_match_the_kernel_sources():
    """Each bound entry point's ctypes argument list has the C function's
    arity and, position by position, its pointer/integer/float kind."""
    assert _c_entry_points() == kernels.SIGNATURES


def _members_args(n=16, u=8, k=8):
    z = lambda *shape, dtype=torch.bool: torch.zeros(shape, dtype=dtype)  # noqa: E731
    table = dict(r_active=z(u), r_kind=z(u, dtype=torch.int8),
                 r_subject=z(u, dtype=torch.int32))
    nodes = dict(member=z(n), committed_dead=z(n), committed_left=z(n))
    tiles = kernels.member_tiles(n)
    return {
        "scan": dict(**nodes, **table, provisioned=z(n),
                     prev=z(n, dtype=torch.int8),
                     status=z(n, dtype=torch.int8),
                     counts=z(kernels.MEMBER_COUNTS, dtype=torch.int32),
                     block_changed=z(tiles, dtype=torch.int32)),
        "emit": dict(status=z(n, dtype=torch.int8), prev=z(n, dtype=torch.int8),
                     provisioned=z(n), block_changed=z(tiles, dtype=torch.int32),
                     k=k, idx=z(k, dtype=torch.int32),
                     state=z(k, dtype=torch.int8)),
        "page": dict(ids=z(k, dtype=torch.int32), **nodes, **table,
                     incarnation=z(n, dtype=torch.int32), up=z(n),
                     st_out=z(k, dtype=torch.int8),
                     inc_out=z(k, dtype=torch.int32), up_out=z(k)),
    }


MEMBERS_BAD = {
    # case: (launch, the arguments' edit, the message it raises with)
    "scan member dtype": ("scan", dict(member=torch.zeros(16, dtype=torch.int8)),
                          "member"),
    "scan prev dtype": ("scan", dict(prev=torch.zeros(16, dtype=torch.int32)),
                        "prev"),
    "scan counts length": ("scan", dict(counts=torch.zeros(4, dtype=torch.int32)),
                           "counts"),
    "scan provisioned device": ("scan", dict(provisioned=torch.zeros(
        16, dtype=torch.bool, device=META)), "provisioned"),
    "scan r_subject device": ("scan", dict(r_subject=torch.zeros(
        8, dtype=torch.int32, device=META)), "r_subject"),
    "scan prev without tiles": ("scan", dict(block_changed=None), "prev"),
    "scan tiles length": ("scan", dict(block_changed=torch.zeros(
        2, dtype=torch.int32)), "block_changed"),
    "scan U > 64": ("scan", dict(r_active=torch.zeros(65, dtype=torch.bool),
                                 r_kind=torch.zeros(65, dtype=torch.int8),
                                 r_subject=torch.zeros(65, dtype=torch.int32)),
                    "slots"),
    "emit status dtype": ("emit", dict(status=torch.zeros(16, dtype=torch.uint8)),
                          "status"),
    "emit idx dtype": ("emit", dict(idx=torch.zeros(8, dtype=torch.int64)), "idx"),
    "emit state length": ("emit", dict(state=torch.zeros(9, dtype=torch.int8)),
                          "state"),
    "emit k = 0": ("emit", dict(k=0, idx=torch.zeros(0, dtype=torch.int32),
                                state=torch.zeros(0, dtype=torch.int8)), "k=0"),
    "emit prev device": ("emit", dict(prev=torch.zeros(16, dtype=torch.int8,
                                                       device=META)), "prev"),
    "page ids dtype": ("page", dict(ids=torch.zeros(8, dtype=torch.int64)), "ids"),
    "page incarnation dtype": ("page", dict(incarnation=torch.zeros(
        16, dtype=torch.int64)), "incarnation"),
    "page up device": ("page", dict(up=torch.zeros(16, dtype=torch.bool,
                                                   device=META)), "up"),
    "page out length": ("page", dict(inc_out=torch.zeros(7, dtype=torch.int32)),
                        "inc_out"),
    "page U > 64": ("page", dict(r_active=torch.zeros(65, dtype=torch.bool),
                                 r_kind=torch.zeros(65, dtype=torch.int8),
                                 r_subject=torch.zeros(65, dtype=torch.int32)),
                    "slots"),
}


@pytest.mark.parametrize("case", sorted(MEMBERS_BAD))
def test_members_wrappers_reject(case):
    launch, edit, match = MEMBERS_BAD[case]
    args = _members_args()[launch]
    args.update(edit)
    fn = {"scan": kernels.launch_members_scan,
          "emit": kernels.launch_members_emit,
          "page": kernels.launch_members_page}[launch]
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        fn(**args)
    assert kernels.LAUNCHES == before


def test_members_tile_matches_the_kernel_source():
    """kernels.MEMBER_TILE and MEMBER_COUNTS are members.cu's kTile
    (kThreads * kPer) and kCounts: the per-tile counts the scan writes
    and the emit reads are sized from them."""
    text = (Path(kernels.__file__).parent / "csrc" / "members.cu").read_text()
    const = {name: int(v) for name, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert const["kThreads"] * const["kPer"] == kernels.MEMBER_TILE
    assert const["kCounts"] == kernels.MEMBER_COUNTS
    assert kernels.member_tiles(1) == 1
    assert kernels.member_tiles(kernels.MEMBER_TILE + 1) == 2
    assert set(kernels.MEMBERS) <= set(kernels.SIGNATURES)


def test_mass_scratch_matches_the_kernel_source():
    """kernels.MASS_COUNTERS and MASS_STAMP_AT are detect.cu's kCounters
    and kStampAt (the done count, the counters, kSlots slot counts): the
    scratch the wrapper keeps and the stamps chip_smoke reads."""
    text = (Path(kernels.__file__).parent / "csrc" / "detect.cu").read_text()
    const = {name: int(v) for name, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert const["kCounters"] == kernels.MASS_COUNTERS
    assert 1 + const["kCounters"] + const["kSlots"] == kernels.MASS_STAMP_AT
    assert "constexpr int kStampAt = kCol0 + kSlots;" in text
    assert "constexpr int kCol0 = 1 + kCounters;" in text


def test_membership_reads_on_a_card_tensor_never_take_the_plain_twin(
        monkeypatch):
    """On a CUDA tensor the K4 wrappers launch or raise: with the launch
    refused, the read raises instead of answering from the plain twin."""
    from consul_tpu_torch.models import swim as pswim
    params = pswim.make_params(config.GossipConfig.lan(),
                               config.SimConfig(n_nodes=16, rumor_slots=8))
    s = pswim.init_state(params, device="cpu")
    monkeypatch.setattr(type(s.member), "is_cuda", property(lambda t: True))
    called = []

    def refuse(*a, **k):
        called.append(1)
        raise RuntimeError("members_scan launch failed: CUDA error 1")

    monkeypatch.setattr(kernels, "launch_members_scan", refuse)
    monkeypatch.setattr(pswim, "status_vector_plain",
                        lambda *a: pytest.fail("took the plain twin"))
    with pytest.raises(RuntimeError, match="launch failed"):
        pswim.status_vector(params, s)
    assert called


def _mass_args(n=16, u=8):
    z = lambda *shape, dtype=torch.bool: torch.zeros(shape, dtype=dtype)  # noqa: E731
    return dict(know=z(n, u), up=z(n), member=z(n), committed_dead=z(n),
                committed_left=z(n), bulk_member=z(n),
                bulk_cov=z(n, dtype=torch.float32), victim=z(n),
                r_active=z(u), r_kind=z(u, dtype=torch.int8),
                r_subject=z(u, dtype=torch.int32),
                recall_out=z(1, dtype=torch.float32),
                fp_out=z(1, dtype=torch.int32))


MASS_BAD = {
    "know dtype": (dict(know=torch.zeros(16, 8, dtype=torch.uint8)), "know"),
    "know not [N, U]": (dict(know=torch.zeros(16, dtype=torch.bool)), "know"),
    "U > 64": (dict(know=torch.zeros(16, 65, dtype=torch.bool)), "slots"),
    "victim dtype": (dict(victim=torch.zeros(16, dtype=torch.int32)), "victim"),
    "victim shape": (dict(victim=torch.zeros(17, dtype=torch.bool)), "victim"),
    "bulk_cov dtype": (dict(bulk_cov=torch.zeros(16, dtype=torch.float64)),
                       "bulk_cov"),
    "up device": (dict(up=torch.zeros(16, dtype=torch.bool, device=META)),
                  "up"),
    "r_subject dtype": (dict(r_subject=torch.zeros(8, dtype=torch.int64)),
                        "r_subject"),
    "table shorter than know": (dict(r_active=torch.zeros(4, dtype=torch.bool),
                                     r_kind=torch.zeros(4, dtype=torch.int8),
                                     r_subject=torch.zeros(4, dtype=torch.int32)),
                                "slots"),
    "recall_out dtype": (dict(recall_out=torch.zeros(1, dtype=torch.float64)),
                         "recall_out"),
    "fp_out dtype": (dict(fp_out=torch.zeros(1, dtype=torch.int64)), "fp_out"),
    "fp_out shape": (dict(fp_out=torch.zeros(2, dtype=torch.int32)), "fp_out"),
    "know not contiguous": (dict(know=torch.zeros(8, 16, dtype=torch.bool).t()),
                            "know"),
}


@pytest.mark.parametrize("case", sorted(MASS_BAD))
def test_mass_detect_wrapper_rejects(case):
    edit, match = MASS_BAD[case]
    args = _mass_args()
    args.update(edit)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        kernels.launch_mass_detect(**args)
    assert kernels.LAUNCHES == before


def _cuda_flagged_state(monkeypatch, chaos=False):
    from consul_tpu_torch.models import swim as pswim
    params = pswim.make_params(config.GossipConfig.lan(),
                               config.SimConfig(n_nodes=16, rumor_slots=8,
                                                chaos=chaos))
    s = pswim.init_state(params, device="cpu")
    monkeypatch.setattr(type(s.know), "is_cuda", property(lambda t: True))
    return pswim, params, s


def test_mass_detection_on_a_card_tensor_never_takes_the_plain_twin(
        monkeypatch):
    """On a CUDA tensor K5's wrapper launches or raises: with the launch
    refused, mass_detection_stats raises instead of answering from the
    plain twin."""
    pswim, params, s = _cuda_flagged_state(monkeypatch)
    called = []

    def refuse(*a, **k):
        called.append(1)
        raise RuntimeError("mass_detect launch failed: CUDA error 1")

    monkeypatch.setattr(kernels, "launch_mass_detect", refuse)
    monkeypatch.setattr(pswim, "mass_detection_stats_plain",
                        lambda *a: pytest.fail("took the plain twin"))
    with pytest.raises(RuntimeError, match="launch failed"):
        pswim.mass_detection_stats(params, s, torch.zeros(16, dtype=torch.bool))
    assert called


def test_chaos_gossip_on_a_card_tensor_launches_the_chaos_mode(monkeypatch):
    """The chaos build's gossip pass on a CUDA tensor goes to K2 with the
    state's partition groups and delivery rates, never the plain twin."""
    from consul_tpu_torch.ops import gossip as pgossip
    pswim, params, s = _cuda_flagged_state(monkeypatch, chaos=True)
    seen = {}

    def refuse(*a, **k):
        seen.update(k)
        raise RuntimeError("gossip_exchange launch failed: CUDA error 1")

    monkeypatch.setattr(kernels, "launch_gossip", refuse)
    monkeypatch.setattr(pgossip, "disseminate_plain",
                        lambda *a, **k: pytest.fail("took the plain twin"))
    with pytest.raises(RuntimeError, match="launch failed"):
        pswim._disseminate(params, s)
    assert seen["group"] is s.chaos_grp and seen["node_ok"] is s.chaos_ok
    assert seen["key"] is not None


def _reconcile_args(m=12, k=10, nodes=True):
    z = lambda n, dtype=torch.int32: torch.zeros(n, dtype=dtype)  # noqa: E731
    merge = dict(d_ids=z(m), d_ver=z(m), d_node=z(m) if nodes else None,
                 push=z(m, torch.bool), a_ids=z(k), a_ver=z(k),
                 a_node=z(k) if nodes else None, drop=z(k, torch.bool),
                 out_ids=z(k), out_ver=z(k), out_node=z(k) if nodes else None)
    diff = dict(src_ids=z(m), src_ver=z(m), dst_ids=z(k), dst_ver=z(k),
                push=z(m, torch.bool), drop=z(k, torch.bool))
    step = dict(diff, due=z(7, torch.bool), d_node=z(m), a_node=z(k))
    return {"diff": diff, "merge": merge, "step": step}


RECONCILE_BAD = {
    # case: (the launch, the arguments' edit, the message it raises with)
    "diff src_ids dtype": ("diff", dict(src_ids=torch.zeros(12, dtype=torch.int64)),
                           "src_ids"),
    "diff dst_ver shape": ("diff", dict(dst_ver=torch.zeros(11, dtype=torch.int32)),
                           "dst_ver"),
    "diff push dtype": ("diff", dict(push=torch.zeros(12, dtype=torch.uint8)),
                        "push"),
    "diff drop device": ("diff", dict(drop=torch.zeros(10, dtype=torch.bool,
                                                       device=META)), "drop"),
    "diff empty table": ("diff", dict(dst_ids=torch.zeros(0, dtype=torch.int32)),
                         "rows"),
    "diff table not 1-d": ("diff", dict(src_ids=torch.zeros(3, 4, dtype=torch.int32)),
                           "rows"),
    "merge d_ver dtype": ("merge", dict(d_ver=torch.zeros(12)), "d_ver"),
    "merge push shape": ("merge", dict(push=torch.zeros(10, dtype=torch.bool)),
                         "push"),
    "merge out_ids shape": ("merge", dict(out_ids=torch.zeros(12, dtype=torch.int32)),
                            "out_ids"),
    "merge a_ids not contiguous": ("merge", dict(
        a_ids=torch.zeros(20, dtype=torch.int32)[::2]), "a_ids"),
    "merge drop dtype": ("merge", dict(drop=torch.zeros(10, dtype=torch.int32)),
                         "drop"),
    "merge node without output": ("merge", dict(out_node=None), "together"),
    "merge a_node device": ("merge", dict(a_node=torch.zeros(10, dtype=torch.int32,
                                                             device=META)), "a_node"),
    "step due without nodes": ("step", dict(d_node=None, a_node=None),
                               "together"),
    "step nodes without due": ("step", dict(due=None), "together"),
    "step due dtype": ("step", dict(due=torch.zeros(7, dtype=torch.uint8)),
                       "due"),
    "step due empty": ("step", dict(due=torch.zeros(0, dtype=torch.bool)),
                       "agents"),
    "step d_node shape": ("step", dict(d_node=torch.zeros(11, dtype=torch.int32)),
                          "d_node"),
    "step a_node dtype": ("step", dict(a_node=torch.zeros(10, dtype=torch.int64)),
                          "a_node"),
}


@pytest.mark.parametrize("case", sorted(RECONCILE_BAD))
def test_reconcile_wrappers_reject(case):
    launch, edit, match = RECONCILE_BAD[case]
    args = _reconcile_args()[launch]
    args.update(edit)
    fn = {"diff": kernels.launch_reconcile_diff,
          "step": kernels.launch_reconcile_diff,
          "merge": kernels.launch_reconcile_merge}[launch]
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        fn(**args)
    assert kernels.LAUNCHES == before


def test_reconcile_tile_matches_the_kernel_source():
    """kernels.MERGE_CLASSES is reconcile.cu's kClasses, and
    kernels.MERGE_SCRATCH sizes the merge's per-device scratch as the
    source lays it out: 32-bit class counts for SCRATCH_BLOCKS blocks,
    then the phase stamps; both entry points are bound."""
    text = (Path(kernels.__file__).parent / "csrc" / "reconcile.cu").read_text()
    assert int(re.search(r"constexpr int kClasses = (\d+);", text).group(1)) \
        == kernels.MERGE_CLASSES
    assert re.search(r"a\.stamps = static_cast<u64\*>\(scratch\) \+ 2 \* "
                     r"scratch_blocks;", text)
    assert kernels.MERGE_STAMP_AT == kernels.MERGE_CLASSES * 4 \
        * kernels.SCRATCH_BLOCKS // 8
    assert kernels.MERGE_SCRATCH == kernels.MERGE_STAMP_AT + kernels.MERGE_STAMPS
    assert set(kernels.RECONCILE) <= set(kernels.SIGNATURES)


def test_reconcile_on_a_card_tensor_never_takes_the_plain_twin(monkeypatch):
    """On a CUDA tensor the reconcile ops and antientropy.step go to K6 or
    raise: with the launches refused, each raises instead of answering
    from the plain twins, and the merge is handed the step's columns."""
    from consul_tpu_torch.models import antientropy as pae
    from consul_tpu_torch.ops import reconcile as prec
    params = pae.AEParams(n_agents=8, capacity=16, sync_interval_ticks=5)
    s = pae.init_state(params, device="cpu")
    s = pae.register_desired(s, [3, 1, 2], [0, 1, 2], [1, 1, 1])
    monkeypatch.setattr(type(s.d_ids), "is_cuda", property(lambda t: True))
    seen = []

    def refuse(name):
        def launch(*a, **k):
            seen.append(name)
            raise RuntimeError(f"reconcile_{name} launch failed: CUDA "
                               f"error 1")
        return launch

    for name in ("diff", "merge"):
        monkeypatch.setattr(kernels, f"launch_reconcile_{name}",
                            refuse(name))
    for twin in ("diff_sorted_plain", "merge_plain"):
        monkeypatch.setattr(prec, twin,
                            lambda *a, **k: pytest.fail("took the plain twin"))
    with pytest.raises(RuntimeError, match="reconcile_diff launch failed"):
        prec.diff_sorted(s.d_ids, s.d_ver, s.a_ids, s.a_ver)
    with pytest.raises(RuntimeError, match="reconcile_merge launch failed"):
        prec.apply_push(s.d_ids, s.d_ver, s.a_ids, s.a_ver,
                        torch.ones(16, dtype=torch.bool))
    with pytest.raises(RuntimeError, match="reconcile_diff launch failed"):
        pae.step(params, s, torch.ones(8, dtype=torch.bool))
    with pytest.raises(RuntimeError, match="reconcile_diff launch failed"):
        pae.in_sync_fraction(s)
    # with the diff answered, step's merge is the kernel's
    monkeypatch.setattr(prec, "diff_sorted_kernel", lambda *a: prec.DiffResult(
        push=torch.ones(16, dtype=torch.bool),
        drop=torch.zeros(16, dtype=torch.bool)))
    with pytest.raises(RuntimeError, match="reconcile_merge launch failed"):
        pae.step(params, s, torch.ones(8, dtype=torch.bool))
    assert seen == ["diff", "merge", "diff", "diff", "merge"]


def test_no_kernel_keeps_one_occupancy_cache_for_every_card():
    """The persistent grids' occupancy caches are per card (common.cuh's
    PerCard, read at the current device), so one process can drive the
    cards of a mesh: no `static int per_card` remains in the sources."""
    csrc = Path(kernels.__file__).parent / "csrc"
    for src in [*csrc.glob("*.cu"), *csrc.glob("*.cuh")]:
        assert "static int per_card" not in src.read_text(), src.name
    caches = sum(src.read_text().count("static PerCard per_card")
                 for src in csrc.glob("*.cu"))
    # the 13 persistent grids, and the block forms' own instantiations:
    # K7's and K11 pre's (kOne or not), K13's two forms, each twice
    assert caches == 17
    common = (csrc / "common.cuh").read_text()
    assert "struct PerCard" in common and "cudaGetDevice" in common
    assert "struct BlockRows" in common


def _sharded_state(monkeypatch, blocks=4):
    """A CPU pool cut into blocks, flagged as on the card."""
    from consul_tpu_torch.models import swim as pswim
    from consul_tpu_torch.parallel import mesh
    params = pswim.make_params(config.GossipConfig.lan(), config.SimConfig(
        n_nodes=64, rumor_slots=8, shard_blocks=blocks))
    s = pswim.init_state(params, device="cpu").replace(tick=1)
    sh = mesh.shard_state(s, mesh.make_mesh(["cpu"] * blocks))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    return pswim, params, sh


def test_sharded_passes_on_a_card_tensor_never_take_the_plain_twins(
        monkeypatch):
    """On CUDA blocks the sharded gossip pass, monitor and reads launch
    their block kernels or raise; none answers from its per-block twin."""
    from consul_tpu_torch.ops import gossip as pgossip
    from consul_tpu_torch.parallel import mesh
    pswim, params, sh = _sharded_state(monkeypatch)
    seen = []

    def refuse(name):
        def launch(*a, **k):
            seen.append(name)
            raise RuntimeError(f"{name} launch failed: CUDA error 1")
        return launch

    for name in ("gossip_blocks", "believed_down_blocks",
                 "members_scan_blocks", "members_page_blocks"):
        monkeypatch.setattr(kernels, f"launch_{name}", refuse(name))
    monkeypatch.setattr(pgossip, "disseminate_blocks_plain",
                        lambda *a, **k: pytest.fail("took the plain twin"))
    for twin in ("believed_down_fraction_blocks_plain",
                 "status_vector_blocks_plain",
                 "membership_counts_blocks_plain",
                 "membership_page_blocks_plain",
                 "membership_delta_blocks_plain"):
        monkeypatch.setattr(pswim, twin,
                            lambda *a, **k: pytest.fail("took the plain twin"))
    monkeypatch.setattr(pswim, "tick_offsets", lambda key, n, k, like:
                        mesh.Replicated([torch.ones(k, dtype=torch.int32)]))
    prov = mesh.shard_state(torch.ones(64, dtype=torch.bool),
                            mesh.make_mesh(["cpu"] * 4), 64)
    ids = torch.zeros(8, dtype=torch.int32)
    for call, name in (
            (lambda: pswim.step(params, sh), "gossip_blocks"),
            (lambda: pswim.believed_down_fraction(params, sh, 3),
             "believed_down_blocks"),
            (lambda: pswim.status_vector(params, sh), "members_scan_blocks"),
            (lambda: pswim.membership_counts(params, sh, prov),
             "members_scan_blocks"),
            (lambda: pswim.membership_delta(params, sh, prov, prov, 8),
             "members_scan_blocks"),
            (lambda: pswim.membership_page(params, sh, ids),
             "members_page_blocks")):
        with pytest.raises(RuntimeError, match=f"{name} launch failed"):
            call()
        assert seen[-1] == name


def test_block_wrappers_reject_bad_blocks_before_launching():
    from consul_tpu_torch.parallel import mesh
    m = mesh.make_mesh(["cpu"] * 4)
    before = dict(kernels.LAUNCHES)
    args = {k: (mesh.shard_state(v, m, 16) if isinstance(v, torch.Tensor)
                and v.dim() >= 1 and v.shape[0] == 16 else v)
            for k, v in _gossip_args().items()}
    bad = dict(args, sends_left=mesh.shard_state(
        torch.zeros(16, 8, dtype=torch.int16), m, 16))
    with pytest.raises(ValueError, match="sends_left"):
        kernels.launch_gossip_blocks(**bad)
    bad = dict(args, sender_ok=mesh.shard_state(
        torch.ones(16, dtype=torch.bool), mesh.make_mesh(["cpu"] * 2), 16))
    with pytest.raises(ValueError, match="sender_ok"):
        kernels.launch_gossip_blocks(**bad)
    bad = dict(args, know=mesh.Blocks([torch.zeros(1, 8, dtype=torch.bool)]
                                      * 17))
    with pytest.raises(ValueError, match="blocks"):
        kernels.launch_gossip_blocks(**bad)
    mon = {k: (mesh.shard_state(v, m, 16) if isinstance(v, torch.Tensor)
               and v.dim() >= 1 and v.shape[0] == 16 else v)
           for k, v in _monitor_args().items()}
    with pytest.raises(ValueError, match="subject"):
        kernels.launch_believed_down_blocks(**dict(mon, subject=16))
    with pytest.raises(ValueError, match="learn_tick"):
        kernels.launch_believed_down_blocks(**dict(mon, learn_tick=(
            mesh.shard_state(torch.zeros(16, 8, dtype=torch.int32), m, 16))))
    margs = _members_args()
    scan = {k: (mesh.shard_state(v, m, 16) if isinstance(v, torch.Tensor)
                and v.dim() == 1 and v.shape[0] == 16 else v)
            for k, v in margs["scan"].items()}
    scan["blk_counts"] = torch.zeros(20, dtype=torch.int32)
    scan["block_changed"] = mesh.Blocks([torch.zeros(1, dtype=torch.int32)]
                                        * 4)
    scan.pop("counts")
    with pytest.raises(ValueError, match="blk_counts"):
        kernels.launch_members_scan_blocks(**dict(
            scan, blk_counts=torch.zeros(5, dtype=torch.int32)))
    with pytest.raises(ValueError, match="member"):
        kernels.launch_members_scan_blocks(**dict(scan, member=mesh.shard_state(
            torch.zeros(16, dtype=torch.int8), m, 16)))
    assert kernels.LAUNCHES == before      # a refused launch is not counted


def test_sharded_probe_passes_on_a_card_tensor_never_take_the_plain_twins(
        monkeypatch):
    """On CUDA blocks every pass of the sharded probe tick (K1's block
    draws, K7-K12's block forms) and K13's launches its block kernel or
    raises; none answers from its per-block twin."""
    from consul_tpu_torch.models import swim_blocks, vivaldi
    from consul_tpu_torch.parallel import mesh
    from consul_tpu_torch.utils import prng
    pswim, params, sh = _sharded_state(monkeypatch)
    sh = sh.replace(tick=0)
    seen = []

    def refuse(name):
        def launch(*a, **k):
            seen.append(name)
            raise RuntimeError(f"{name} launch failed: CUDA error 1")
        return launch

    names = ("draws", "subject_maps_blocks", "map_add_blocks",
             "maps_convert_blocks", "probe_round_blocks", "originate_blocks",
             "suspicion_expiry_blocks", "dense_expiry_blocks",
             "refutation_blocks", "expire_blocks", "vivaldi_ring_blocks")
    for name in names:
        monkeypatch.setattr(kernels, f"launch_{name}", refuse(name))
    for twin in ("maps_plain", "map_add_plain", "maps_convert_plain",
                 "probe_pass_plain", "originate_plain",
                 "suspicion_expiry_plain", "dense_expiry_plain",
                 "refutation_plain", "expire_plain"):
        monkeypatch.setattr(swim_blocks, twin,
                            lambda *a, **k: pytest.fail("took the twin"))
    monkeypatch.setattr(vivaldi, "observe_ring_blocks_plain",
                        lambda *a, **k: pytest.fail("took the twin"))
    monkeypatch.setattr(prng, "draw_plain",
                        lambda *a, **k: pytest.fail("took the twin"))
    n, ell = 64, 16
    maps = tuple(mesh.Blocks(torch.full((ell,), -1, dtype=torch.int32)
                             for _ in range(4)) for _ in range(4))
    rows = mesh.Blocks(torch.zeros(ell, dtype=torch.int32) for _ in range(4))
    pairs = (torch.tensor([3], dtype=torch.int32),
             torch.tensor([1], dtype=torch.int32), torch.tensor([True]))
    conv = torch.zeros(8, dtype=torch.bool)
    shift = torch.tensor(3, dtype=torch.int32)
    vp = vivaldi.VivaldiParams(n_nodes=n, dims=8, seed=7)
    vs = mesh.shard_state(vivaldi.init_state(vp, device="cpu"),
                          mesh.make_mesh(["cpu"] * 4), n)
    flags = mesh.Blocks(torch.ones(ell, dtype=torch.bool) for _ in range(4))
    rtt = mesh.Blocks(torch.ones(ell) for _ in range(4))
    k = params.indirect_checks
    drawn = dict(offs=mesh.Replicated([torch.arange(1, k + 2,
                                                    dtype=torch.int32)]),
                 rtt=rtt, direct=rtt, lha=rtt,
                 **{leg: mesh.Blocks(torch.ones(ell, k) for _ in range(4))
                    for leg in ("uA", "uB", "uC")})
    for call, name in (
            (lambda: swim_blocks.probe_inputs(params, sh), "draws"),
            (lambda: swim_blocks.maps(params, sh), "subject_maps_blocks"),
            (lambda: swim_blocks.map_add(maps[0], *pairs), "map_add_blocks"),
            (lambda: swim_blocks.maps_convert(maps, sh, conv),
             "maps_convert_blocks"),
            (lambda: swim_blocks.probe_pass(params, sh, maps, drawn),
             "probe_round_blocks"),
            (lambda: swim_blocks.originate(params, sh, rows, 1,
                                           sh.incarnation, rows),
             "originate_blocks"),
            (lambda: swim_blocks.suspicion_expiry(params, sh),
             "suspicion_expiry_blocks"),
            (lambda: swim_blocks.dense_expiry(params, sh, shift, maps),
             "dense_expiry_blocks"),
            (lambda: swim_blocks.refutation(params, sh), "refutation_blocks"),
            (lambda: swim_blocks.expire(params, sh), "expire_blocks"),
            (lambda: vivaldi.observe_ring(vp, vs, shift, rtt, flags),
             "vivaldi_ring_blocks"),
            (lambda: pswim.step(params, sh), "subject_maps_blocks")):
        with pytest.raises(RuntimeError, match=f"{name} launch failed"):
            call()
        assert seen[-1] == name


class _AllCalls:
    """A stand-in kernel library that records every call of each entry
    point, in order."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def fn(*args):
            self.calls.setdefault(name, []).append(args)
            return 0
        return fn


def _named(source: str, name: str, args) -> dict:
    """An entry point's recorded arguments by their C parameter names."""
    text = (Path(kernels.__file__).parent / "csrc" / source).read_text()
    m = re.search(r'extern "C" int ' + name + r'\(([^)]*)\)', text)
    names = [a.replace("*", " ").split()[-1] for a in m.group(1).split(",")]
    assert len(names) == len(args)
    return dict(zip(names, args))


@pytest.mark.parametrize("blocks", (2, 4))
def test_block_forms_launch_a_block_at_a_time_with_its_tables(monkeypatch,
                                                              blocks):
    """The block wrappers' launches, read through the C parameter names:
    each block's launch covers rows [bL, (b + 1)L) with its own leaves,
    the tables list every block's base pointer in block order, each
    partial slot is the block's own, and the combine runs once, after
    the blocks, with every slot.  K8 runs select, cover, combine, seed;
    K10 scan, combine, apply; K12's expire count, combine, clear."""
    from consul_tpu_torch.models import swim as pswim
    from consul_tpu_torch.models import swim_blocks
    from consul_tpu_torch.parallel import mesh
    rec = _AllCalls()
    monkeypatch.setattr(kernels, "library", lambda: rec)
    monkeypatch.setattr(kernels, "_stream", lambda dev: 12345)
    monkeypatch.setattr(kernels, "enable_peer_access", lambda devs: None)
    n = 64
    ell = n // blocks
    params = pswim.make_params(config.GossipConfig.lan(), config.SimConfig(
        n_nodes=n, rumor_slots=8, shard_blocks=blocks))
    s = pswim.init_state(params, device="cpu")
    sh = mesh.shard_state(s, mesh.make_mesh(["cpu"] * blocks))
    want = mesh.Blocks(torch.zeros(ell, dtype=torch.int32)
                       for _ in range(blocks))
    swim_blocks.kernel_originate(params, sh, want, 1, sh.incarnation, want)
    swim_blocks.kernel_suspicion_expiry(params, sh)
    swim_blocks.kernel_expire(params, sh)
    modes = {"originate": [1] * blocks + [2] * blocks + [3] + [4] * blocks,
             "suspicion_expiry": [1] * blocks + [2] + [3] * blocks,
             "expire": [3] * blocks + [2] + [4] * blocks}
    sources = {"originate": "originate.cu", "suspicion_expiry": "expiry.cu",
               "expire": "refute.cu"}
    for name, want_modes in modes.items():
        calls = [_named(sources[name], name, a) for a in rec.calls[name]]
        assert [c["mode"] for c in calls] == want_modes, name
        per_block = [c for c in calls if c["mode"] != 2 + (name == "originate")]
        for i, c in enumerate(per_block):
            b = i % blocks
            assert (c["row0"], c["rows"], c["B"], c["L"], c["N"]) == \
                (b * ell, ell, blocks, ell, n), (name, i)
            assert c["know"] == sh.know.parts[b].data_ptr()
            assert c["stream"] == 12345
        table = list(calls[0]["tables"])
        parts = {"originate": sh.committed_dead, "suspicion_expiry":
                 sh.committed_dead, "expire": sh.committed_dead}[name]
        at = {"originate": 1, "suspicion_expiry": 1, "expire": 0}[name]
        assert table[at * blocks:(at + 1) * blocks] == \
            [p.data_ptr() for p in parts.parts], name
