"""ctypes bindings of the port's hand-written CUDA kernels.

The library is built from `csrc/*.cu` at first use (`build.py`) and
loaded once per process.  Each `launch_*` function checks its tensors,
launches on PyTorch's current stream, raises if the launch returned a
CUDA error, and counts the launch in `LAUNCHES` — the only place the
count moves, so a run can show that its path went through the kernel.
The public wrappers that choose between a kernel and its plain PyTorch
twin live beside the twin: `utils/prng.py` (K1), `ops/gossip.py` (K2),
`models/swim.py` (K3, K4, K5, K7-K12, K14), `ops/reconcile.py` (K6),
`models/vivaldi.py` (K13).  They take the twin only for CPU tensors.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from typing import Optional

import torch

from consul_tpu_torch.kernels import build

# the main path's kernels (K1-K3), then the oracle's membership reads (K4)
MAIN_PATH = ("threefry_draws", "gossip_pack", "gossip_exchange",
             "believed_down")
MEMBERS = ("members_scan", "members_emit", "members_page")
# the nemesis build and the mass-event path: K2's exchange in its chaos
# mode (counted apart from the non-chaos exchange) and K5
CHAOS = ("gossip_exchange_chaos", "mass_detect")
# anti-entropy's set reconciliation (K6): the diff (its step's form masked
# by the due agents), and the compaction + merge (one cooperative launch)
RECONCILE = ("reconcile_diff", "reconcile_merge")
# the probe round (K7) and rumor origination (K8: one cooperative launch),
# both writing the state they are given in place
PROBE = ("probe_round", "originate")
# the rest of the probe tick's detector passes: the subject maps and their
# updates (K9, the updates in place), suspicion expiry (K10: one
# cooperative launch), the dense expiry's launches before and after its
# origination (K11), K10 and K11
# writing the state they are given in place, refutation and expire (K12,
# in place; expire one cooperative launch)
DETECTOR = ("subject_maps", "map_add", "maps_convert", "suspicion_expiry",
            "dense_expiry", "dense_expiry_post", "refutation", "expire")
# the Vivaldi ring observation of every probe tick (K13, its window in
# place), and the bulk death channel of a mass event (K14: one cooperative
# launch, in place, its ring offsets drawn inside it)
VIVALDI_BULK = ("vivaldi_ring", "bulk_step")
# the node-sharded pool's launches (parallel/mesh.py): K2's pack and
# exchange (and its chaos mode), K3 and K4's scan, emit and page, each
# counted once a block, and the one launch a call that adds the blocks'
# partials (K2's counters, K3's fraction, K4's counts)
SHARDED = ("gossip_pack_blocks", "gossip_exchange_blocks",
           "gossip_exchange_chaos_blocks", "gossip_combine",
           "believed_down_blocks", "believed_down_combine",
           "members_scan_blocks", "members_emit_blocks", "members_page_blocks",
           "members_combine")
KERNELS = MAIN_PATH + MEMBERS + CHAOS + RECONCILE + PROBE + DETECTOR \
    + VIVALDI_BULK + SHARDED
LAUNCHES = {name: 0 for name in KERNELS}
# entry points of the library that launch no kernel: peer access between
# the cards of a mesh
HELPERS = ("enable_peer_access",)
# K1's modes, in the order of threefry.cu's Mode, and the launches of K1
# that carried a segment of each
DRAW_MODES = ("bits", "uniform", "exponential", "normal", "randint")
DRAW_LAUNCHES = {mode: 0 for mode in DRAW_MODES}
MAX_SEGMENTS = 8
DRAW_ELEMENTS_PER_THREAD = 4      # threefry.cu's kPer

_lib = None
# times this process built and loaded the library: once (kernel_audit's
# one-build rule and the bench's row hold it to that)
LIBRARY_LOADS = 0
# per-(device, kernel) counter scratch: one u64 block count, then each
# block's partial counters (the last block of a launch sums them and
# resets the count)
_scratch: dict = {}
SCRATCH_BLOCKS = 4096

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
_F32 = ctypes.c_float


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
    for mode in DRAW_MODES:
        DRAW_LAUNCHES[mode] = 0


# ctypes argument types of each extern "C" entry point of csrc/*.cu, in
# order (tests/test_torch_isolation.py holds them to the sources)
SIGNATURES = {
    "threefry_draws": [_P, _I, _P],
    "gossip_pack": [_P, _P, _P, _I64, _I, _I, _P, _P, _P],
    "gossip_exchange": [_P, _P, _I, _I64, _I64, _I64, _P, _I, _P, _P, _P,
                        _P, _I, _I, _U32, _U32, _I, _F32, _P, _P, _I, _I,
                        _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P],
    "gossip_combine": [_P, _I, _I, _P, _P, _P, _I, _P],
    "enable_peer_access": [_I, _I],
    "believed_down": [_P] * 15 + [_I64, _I, _I64, _I64, _I, _I, _P, _I, _P,
                                  _P, _P],
    "believed_down_combine": [_P, _I, _P, _P, _P, _P],
    "members_scan": [_P] * 6 + [_I, _P, _P, _I64, _I64, _I64, _P, _P, _P,
                                _P, _P],
    "members_emit": [_P] * 5 + [_I, _I, _I64, _P, _I, _I64, _I64, _P, _P,
                                _P],
    "members_combine": [_P, _I, _P, _P],
    "members_page": [_P, _I64] + [_P] * 6 + [_I, _P, _P, _I, _I64, _P, _P,
                                             _P, _P],
    "mass_detect": [_P] * 11 + [_I64, _I, _P, _P, _P, _P],
    "reconcile_diff": [_P] * 4 + [_I64, _I64, _P, _P, _P, _I64, _P, _P, _P],
    "reconcile_merge": [_P] * 8 + [_I64, _I64, _P, _I64, _P, _P, _P, _P],
    "probe_round": [_P] * 34 + [_I64] + [_I] * 6 + [_U32] + [_F32] * 5
    + [_I] * 3 + [_P, _I] + [_P] * 4 + [_I64, _I64, _P, _I, _I64, _P, _P],
    "probe_combine": [_P, _I, _I, _I, _P, _P, _P],
    "originate": [_P] * 18 + [_I64] + [_I] * 6 + [_P, _I] + [_P] * 3
    + [_I, _I64, _I64, _P, _I, _I64, _I, _P, _P, _P],
    "subject_maps": [_P] * 4 + [_I64, _I, _I64, _I64] + [_P] * 5,
    "map_add": [_P] * 4 + [_I64, _I, _I64, _I64, _P],
    "maps_convert": [_P] * 4 + [_I64, _I, _I64, _I64, _P],
    "suspicion_expiry": [_P] * 14 + [_I64] + [_I] * 4 + [_P] * 2
    + [_I, _I64, _I64, _P, _I, _I64, _P, _P, _P],
    "dense_expiry": [_P] * 18 + [_I64] + [_I] * 5 + [_P, _I] + [_P] * 4
    + [_I, _I64, _I64, _P, _I, _I64, _P, _P],
    "dense_expiry_post": [_P] * 14 + [_I64] + [_I] * 5 + [_P] * 5
    + [_I64, _I64, _P, _I, _I64, _P],
    "refutation": [_P] * 12 + [_I64] + [_I] * 5 + [_P]
    + [_I, _I64, _I64, _P, _I, _I64, _P],
    "expire": [_P] * 13 + [_I64] + [_I] * 4 + [_P]
    + [_I, _I64, _I64, _P, _I, _I64, _P, _P, _P],
    "vivaldi_ring": [_P] * 7 + [_I64, _I, _I, _I, _U32, _U32] + [_F32] * 8
    + [_P] * 4 + [_I64, _I64, _P, _I, _I64, _P],
    "bulk_step": [_P] * 9 + [_I64, _F32, _F32, _P, _I, _P, _P],
}


def library():
    """The loaded kernel library, built on first use."""
    global _lib, LIBRARY_LOADS
    if _lib is None:
        lib = ctypes.CDLL(str(build.build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        LIBRARY_LOADS += 1
    return _lib


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _on(device: torch.device):
    """The device a launch runs on made current for it (a CUDA launch goes
    to a stream of the current device): the blocks of a mesh over several
    cards launch on each card in turn."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _require(t, name: str, dtype, device, shape=None) -> None:
    if t is None:
        raise ValueError(f"{name}: missing")
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")


def _scratch_words(device: torch.device, kernel: str,
                   words: int) -> torch.Tensor:
    """The kernel's zeroed int64 scratch on the device, made once (each
    launch leaves it as it found it)."""
    buf = _scratch.get((device, kernel))
    if buf is None:
        buf = torch.zeros(words, dtype=torch.int64, device=device)
        _scratch[(device, kernel)] = buf
    return buf


def _counter_scratch(device: torch.device, kernel: str, k: int,
                     extra: int = 0) -> torch.Tensor:
    return _scratch_words(device, kernel, 1 + extra + SCRATCH_BLOCKS * k)


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


class DrawSpec(ctypes.Structure):
    """One segment of a K1 launch, laid out as common.cuh's DrawSpec
    (tests/test_torch_isolation.py holds the fields to the source); K14
    takes a randint one with no output for its ring offsets."""

    _fields_ = [("out", _P), ("n", _I64), ("sched", _U32 * 16),
                ("mode", ctypes.c_int32), ("lo", _F32), ("span", _F32),
                ("minval", _U32), ("range", _U32), ("mult", _U32),
                ("first", _I64)]


@dataclasses.dataclass(frozen=True)
class Segment:
    """One draw of a K1 launch: `mode` (a DRAW_MODES name) from `keys` (one
    key, two for randint: split(key)'s pair) into the n elements of the
    contiguous `out` (int32 for bits and randint, float32 otherwise).
    uniform and normal scale the unit float as max(lo, u * span + lo);
    randint adds minval to ((hi % range) * mult + lo % range) % range.
    out[0] is element `first` of the stream (a block of a draw's rows)."""

    mode: str
    keys: tuple
    out: torch.Tensor
    n: int
    lo: float = 0.0
    span: float = 1.0
    minval: int = 0
    range: int = 1
    mult: int = 0
    first: int = 0


def _schedule(key) -> list:
    """threefry2x32's key schedule of key (common.cuh:threefry_key)."""
    k0, k1 = (int(w) & 0xFFFFFFFF for w in key)
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    return [(w + c) & 0xFFFFFFFF for w, c in
            ((k0, 0), (k1, 0), (k2, 0), (k2, 1), (k0, 2), (k1, 3), (k2, 4),
             (k0, 5))]


def _spec(i: int, seg: Segment, device) -> DrawSpec:
    name = f"threefry_draws segment {i}"
    if seg.mode not in DRAW_MODES:
        raise ValueError(f"{name}: mode {seg.mode!r}, want one of {DRAW_MODES}")
    want = torch.int32 if seg.mode in ("bits", "randint") else torch.float32
    _require(seg.out, f"{name} out", want, device)
    if not 1 <= seg.n < 2 ** 40 or seg.out.numel() != seg.n:
        raise ValueError(f"{name}: out has {seg.out.numel()} elements, want "
                         f"n={seg.n} (at least 1)")
    if len(seg.keys) != (2 if seg.mode == "randint" else 1):
        raise ValueError(f"{name}: {seg.mode} takes "
                         f"{2 if seg.mode == 'randint' else 1} keys, got "
                         f"{len(seg.keys)}")
    if seg.mode == "randint" and not 1 <= seg.range < 2 ** 32:
        raise ValueError(f"{name}: randint range {seg.range} outside "
                         f"[1, 2^32)")
    if not 0 <= seg.first or seg.first + seg.n >= 2 ** 40:
        raise ValueError(f"{name}: first element {seg.first} out of range")
    sched = _schedule(seg.keys[0]) + (_schedule(seg.keys[1])
                                      if len(seg.keys) == 2 else [0] * 8)
    return DrawSpec(seg.out.data_ptr(), seg.n, (_U32 * 16)(*sched),
                    DRAW_MODES.index(seg.mode), seg.lo, seg.span,
                    seg.minval & 0xFFFFFFFF, seg.range, seg.mult & 0xFFFFFFFF,
                    seg.first)


def randint_spec(keys, n: int, minval: int, range_: int,
                 mult: int) -> DrawSpec:
    """The DrawSpec of a randint draw of n elements whose kernel draws them
    for itself (no output): K14's ring offsets.  keys are split(key)'s
    two keys; minval, range_ and mult as a Segment's."""
    if len(keys) != 2 or not 1 <= range_ < 2 ** 32 or not 1 <= n < 2 ** 40:
        raise ValueError(f"randint_spec: {len(keys)} keys, range {range_}, "
                         f"n {n}")
    sched = _schedule(keys[0]) + _schedule(keys[1])
    return DrawSpec(None, n, (_U32 * 16)(*sched), DRAW_MODES.index("randint"),
                    0.0, 1.0, minval & 0xFFFFFFFF, range_, mult & 0xFFFFFFFF,
                    0)


def launch_draws(segments, blocks: bool = False) -> None:
    """K1: one launch writes every segment's draw, finished (at most
    MAX_SEGMENTS segments, all on one device).  With `blocks` (a batch of
    a node-sharded pool's draws, prng.draw_blocks) it counts as
    `threefry_draws_blocks`."""
    if not 1 <= len(segments) <= MAX_SEGMENTS:
        raise ValueError(f"threefry_draws takes 1-{MAX_SEGMENTS} segments, "
                         f"got {len(segments)}")
    dev = segments[0].out.device
    specs = (DrawSpec * len(segments))(
        *[_spec(i, seg, dev) for i, seg in enumerate(segments)])
    with _on(dev):
        rc = library().threefry_draws(ctypes.addressof(specs), len(segments),
                                      _stream(dev))
    _check(rc, "threefry_draws")
    LAUNCHES["threefry_draws_blocks" if blocks else "threefry_draws"] += 1
    for mode in {seg.mode for seg in segments}:
        DRAW_LAUNCHES[mode] += 1


def _table(parts) -> ctypes.Array:
    """A host array of block base pointers (a kernel's BlockRows); kept
    alive by the caller until the launch returns."""
    return (_P * len(parts))(*[p.data_ptr() for p in parts])


def _no_table(parts) -> Optional[ctypes.Array]:
    return None if parts is None else _table(parts)


def _one_table(*leaves) -> ctypes.Array:
    """The block tables of a one-device launch of a kernel with a block
    form: each leaf's own pointer (null for None), a table of one block
    each."""
    return (_P * len(leaves))(*[_ptr(t) for t in leaves])


def _gossip_checks(n: int, s: int, g: int, limit: int, tick16: int,
                   dev, rows: dict, word, key, learn, newly, ctr,
                   group, node_ok) -> int:
    """K2's argument checks for one block of `n` rows on `dev` (the whole
    pool for one device); returns the counter vector's length C."""
    if not 1 <= s <= 64 or not 1 <= g <= 16:
        raise ValueError(f"gossip takes 1-64 slots and 1-16 contacts, got "
                         f"{s} slots and {g} contacts")
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"gossip: N={n} outside [1, 2^31)")
    if not 0 <= limit <= 127 or not -2 ** 15 <= tick16 < 2 ** 15:
        raise ValueError(f"gossip: limit {limit} or tick16 {tick16} out of "
                         f"range")
    shapes = {"know": (torch.bool, (n, s)), "sends_left": (torch.int8, (n, s)),
              "offsets": (torch.int32, (g,)),
              "sender_ok": (torch.bool, (n,)),
              "receiver_ok": (torch.bool, (n,)),
              "slot_active": (torch.bool, (s,)),
              "new_know": (torch.bool, (n, s)),
              "new_sends": (torch.int8, (n, s)), "kword": (word, (n,)),
              "qword": (word, (n,))}
    for name, (dt, shape) in shapes.items():
        _require(rows[name], "gossip " + name, dt, dev, shape)
    learn_tick, new_learn = learn
    if (learn_tick is None) != (new_learn is None):
        raise ValueError("gossip: learn_tick and new_learn come together")
    if learn_tick is not None:
        _require(learn_tick, "gossip learn_tick", torch.int16, dev, (n, s))
        _require(new_learn, "gossip new_learn", torch.int16, dev, (n, s))
    if newly is not None:
        _require(newly, "gossip newly", torch.bool, dev, (n, s))
    ctr_in, ctr_out = ctr
    if (ctr_in is None) != (ctr_out is None):
        raise ValueError("gossip: ctr and ctr_out come together")
    c = 0
    if ctr_in is not None:
        c = ctr_in.numel()
        _require(ctr_in, "gossip ctr", torch.float32, ctr_in.device, (c,))
        _require(ctr_out, "gossip ctr_out", torch.float32, ctr_in.device,
                 (c,))
        if c < 3:
            raise ValueError(f"gossip: ctr has {c} entries, want at least 3")
    if (group is not None or node_ok is not None) and key is None:
        raise ValueError("gossip: the chaos mode (group/node_ok) needs a key")
    if group is not None:
        _require(group, "gossip group", torch.int16, dev, (n,))
    if node_ok is not None:
        _require(node_ok, "gossip node_ok", torch.float32, dev, (n,))
    return c


def _vec(s: int, rows) -> int:
    """K2's lanes-per-row vectors for S = 16, 32, 64 on aligned rows, else a
    thread a row."""
    return int(s in (16, 32, 64)
               and all(t.data_ptr() % 16 == 0 for t in rows if t is not None))


def launch_gossip(know, sends_left, offsets, sender_ok, receiver_ok,
                  slot_active, limit: int, new_know, new_sends, kword, qword,
                  counters, *, key=None, p_ok: float = 1.0, learn_tick=None,
                  new_learn=None, tick16: int = 0, newly=None, ctr=None,
                  ctr_out=None, group=None, node_ok=None) -> None:
    """K2: the pack launch, then the exchange launch, each counted.

    know/sends_left [N, S] bool/int8 are read; new_know/new_sends (and
    new_learn, newly when given) [N, S] are written whole; kword/qword [N]
    (int32 for S <= 32, int64 for S <= 64) are the per-row know and
    queued masks the pack writes and the exchange reads; counters [3]
    float32 gets delivered, served, lost; ctr_out = ctr plus those in its
    last three entries.  With `key` (two uint32 words) contact (i, g) is
    delivered when the uniform float of element i*G + g of its threefry
    stream is < p_ok.  Chaos mode (with `key`): `group` [N] int16 and/or
    `node_ok` [N] float32 make contact (i, g), sender j, exist only where
    group[i] == group[j] and deliver below (p_ok * node_ok[i]) *
    node_ok[j]; its exchange counts as `gossip_exchange_chaos`.  The
    exchange reads the words (and group, node_ok) through one-block
    tables: the B = 1 form of launch_gossip_blocks."""
    dev = know.device
    if know.dim() != 2 or offsets.dim() != 1:
        raise ValueError("gossip: know must be [N, S] and offsets [G]")
    n, s = know.shape
    g = offsets.shape[0]
    word = torch.int32 if s <= 32 else torch.int64
    c = _gossip_checks(n, s, g, limit, tick16, dev, dict(
        know=know, sends_left=sends_left, offsets=offsets,
        sender_ok=sender_ok, receiver_ok=receiver_ok,
        slot_active=slot_active, new_know=new_know, new_sends=new_sends,
        kword=kword, qword=qword), word, key, (learn_tick, new_learn), newly,
        (ctr, ctr_out), group, node_ok)
    _require(counters, "gossip counters", torch.float32, dev, (3,))
    if ctr is not None:
        _require(ctr, "gossip ctr", torch.float32, dev, (c,))
        _require(ctr_out, "gossip ctr_out", torch.float32, dev, (c,))
    chaos = group is not None or node_ok is not None
    vec = _vec(s, (know, sends_left, new_know, new_sends, learn_tick,
                   new_learn, newly))
    lib = library()
    stream = _stream(dev)
    rc = lib.gossip_pack(know.data_ptr(), sends_left.data_ptr(),
                         sender_ok.data_ptr(), n, s, vec, kword.data_ptr(),
                         qword.data_ptr(), stream)
    _check(rc, "gossip_pack")
    LAUNCHES["gossip_pack"] += 1
    k0, k1 = key if key is not None else (0, 0)
    kw, qw = _table([kword]), _table([qword])
    grp = _no_table(None if group is None else [group])
    ok = _no_table(None if node_ok is None else [node_ok])
    rc = lib.gossip_exchange(
        kw, qw, 1, n, 0, n, offsets.data_ptr(), g, receiver_ok.data_ptr(),
        slot_active.data_ptr(), sends_left.data_ptr(), _ptr(learn_tick), s,
        vec, k0, k1, int(key is not None), p_ok, grp, ok, limit, tick16,
        new_know.data_ptr(), new_sends.data_ptr(), _ptr(new_learn),
        _ptr(newly), _counter_scratch(dev, "gossip_exchange", 3).data_ptr(),
        SCRATCH_BLOCKS, counters.data_ptr(), _ptr(ctr), _ptr(ctr_out), c,
        None, stream)
    _check(rc, "gossip_exchange")
    LAUNCHES["gossip_exchange_chaos" if chaos else "gossip_exchange"] += 1


_PEERS: set = set()


def enable_peer_access(devices) -> None:
    """Let every pair of distinct cards among `devices` read each other's
    memory (cudaDeviceCanAccessPeer, cudaDeviceEnablePeerAccess), once a
    pair a process; raises for a pair that cannot reach each other."""
    cards = sorted({d.index for d in devices if d.type == "cuda"})
    for a in cards:
        for b in cards:
            if a == b or (a, b) in _PEERS:
                continue
            rc = library().enable_peer_access(a, b)
            if rc != 0:
                raise RuntimeError(f"card {a} cannot read card {b}'s memory "
                                   f"(peer access: CUDA error {rc}); a mesh "
                                   f"over them needs peer access")
            _PEERS.add((a, b))


def _parts(x, n_blocks: int, name: str):
    parts = getattr(x, "parts", None)
    if parts is None or len(parts) != n_blocks:
        raise ValueError(f"{name}: want Blocks of {n_blocks} blocks")
    return parts


def _copy_on(x, dev, name: str):
    if isinstance(x, torch.Tensor):
        return x
    on = getattr(x, "on", None)
    if on is None:
        raise ValueError(f"{name}: want a tensor or a Replicated leaf")
    return on(dev)


def launch_gossip_blocks(know, sends_left, offsets, sender_ok, receiver_ok,
                         slot_active, limit: int, new_know, new_sends, kword,
                         qword, counters, *, key=None, p_ok: float = 1.0,
                         learn_tick=None, new_learn=None, tick16: int = 0,
                         newly=None, ctr=None, ctr_out=None, group=None,
                         node_ok=None) -> None:
    """K2 over a node-sharded pool (parallel/mesh.py): the [N, S] and [N]
    arguments are Blocks of B blocks of L rows, offsets and slot_active
    Replicated (or tensors on one device), counters [3] and ctr/ctr_out on
    the first block's device, all else as launch_gossip.  Every block's
    pack, then every block's exchange over rows [bL, (b + 1)L) reading
    the peers' words through B-block tables, each counted once a block
    (`gossip_pack_blocks`, `gossip_exchange_blocks` or its chaos form),
    then one gossip_combine of the blocks' partials.  Blocks on one card
    launch one after another on that card's current stream (sharing its
    per-device scratch in turn); across cards no exchange starts before
    every pack has finished and the combine waits for every exchange
    (mesh.join), with peer access enabled between the cards."""
    from consul_tpu_torch.parallel import mesh
    b_count = know.n_blocks
    ell = know.rows
    n = b_count * ell
    if not 1 <= b_count <= 16:
        raise ValueError(f"gossip: {b_count} blocks, want 1-16")
    devs = know.devices
    home = devs[0]
    s = know.shape[1] if len(know.shape) == 2 else -1
    word = torch.int32 if s <= 32 else torch.int64
    named = dict(know=know, sends_left=sends_left, sender_ok=sender_ok,
                 receiver_ok=receiver_ok, new_know=new_know,
                 new_sends=new_sends, kword=kword, qword=qword,
                 learn_tick=learn_tick, new_learn=new_learn, newly=newly,
                 group=group, node_ok=node_ok)
    parts = {k: None if v is None else _parts(v, b_count, "gossip " + k)
             for k, v in named.items()}
    offs = [_copy_on(offsets, d, "gossip offsets") for d in devs]
    active = [_copy_on(slot_active, d, "gossip slot_active") for d in devs]
    g = offs[0].shape[0] if offs[0].dim() == 1 else -1
    c = 0
    for b, d in enumerate(devs):
        at = {k: None if v is None else v[b] for k, v in parts.items()}
        c = _gossip_checks(ell, s, g, limit, tick16, d, dict(
            at, offsets=offs[b], slot_active=active[b]), word, key,
            (at["learn_tick"], at["new_learn"]), at["newly"], (ctr, ctr_out),
            at["group"], at["node_ok"])
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"gossip: N={n} outside [1, 2^31)")
    _require(counters, "gossip counters", torch.float32, home, (3,))
    if ctr is not None:
        _require(ctr, "gossip ctr", torch.float32, home, (c,))
    chaos = group is not None or node_ok is not None
    enable_peer_access(devs)
    lib = library()
    vecs = []
    for b, d in enumerate(devs):
        vec = _vec(s, [parts[k][b] for k in ("know", "sends_left", "new_know",
                                             "new_sends", "learn_tick",
                                             "new_learn", "newly")
                       if parts[k] is not None])
        vecs.append(vec)
        with _on(d):
            rc = lib.gossip_pack(parts["know"][b].data_ptr(),
                                 parts["sends_left"][b].data_ptr(),
                                 parts["sender_ok"][b].data_ptr(), ell, s, vec,
                                 parts["kword"][b].data_ptr(),
                                 parts["qword"][b].data_ptr(), _stream(d))
        _check(rc, "gossip_pack")
        LAUNCHES["gossip_pack_blocks"] += 1
    mesh.join(devs)
    k0, k1 = key if key is not None else (0, 0)
    kw, qw = _table(parts["kword"]), _table(parts["qword"])
    grp, ok = _no_table(parts["group"]), _no_table(parts["node_ok"])
    partials = torch.empty(3 * b_count, dtype=torch.int64, device=home)
    for b, d in enumerate(devs):
        opt = {k: None if parts[k] is None else parts[k][b]
               for k in ("learn_tick", "new_learn", "newly")}
        with _on(d):
            rc = lib.gossip_exchange(
                kw, qw, b_count, ell, b * ell, ell, offs[b].data_ptr(), g,
                parts["receiver_ok"][b].data_ptr(), active[b].data_ptr(),
                parts["sends_left"][b].data_ptr(), _ptr(opt["learn_tick"]), s,
                vecs[b], k0, k1, int(key is not None), p_ok, grp, ok, limit,
                tick16, parts["new_know"][b].data_ptr(),
                parts["new_sends"][b].data_ptr(), _ptr(opt["new_learn"]),
                _ptr(opt["newly"]),
                _counter_scratch(d, "gossip_exchange", 3).data_ptr(),
                SCRATCH_BLOCKS, None, None, None, 0,
                partials.data_ptr() + 24 * b, _stream(d))
        _check(rc, "gossip_exchange")
        LAUNCHES["gossip_exchange_chaos_blocks" if chaos
                 else "gossip_exchange_blocks"] += 1
    mesh.join(devs)
    with _on(home):
        rc = lib.gossip_combine(partials.data_ptr(), b_count, g,
                                counters.data_ptr(), _ptr(ctr), _ptr(ctr_out),
                                c, _stream(home))
    _check(rc, "gossip_combine")
    LAUNCHES["gossip_combine"] += 1


TIMEOUTS = 65   # Lifeguard timeout table entries: confirmations 0..64


def launch_believed_down(know, learn_tick, up, member, r_active, r_kind,
                         r_subject, r_inc, r_confirm, timeouts,
                         committed_dead, committed_left, committed_inc,
                         bulk_member, bulk_cov, subject: int, tick16: int,
                         out) -> None:
    """K3: the subject's believed-down fraction into out[0], from the raw
    rumor-table leaves and the int16 timeout table [65]."""
    dev = know.device
    if know.dim() != 2:
        raise ValueError("believed_down: know must be [N, U]")
    n, u = know.shape
    if not 1 <= u <= 64:
        raise ValueError(f"believed_down takes 1-64 slots, got {u}")
    if not 0 <= subject < n:
        raise ValueError(f"believed_down: subject {subject} outside [0, {n})")
    if not -2 ** 15 <= tick16 < 2 ** 15:
        raise ValueError(f"believed_down: tick16 {tick16} out of range")
    for t, name, dt, shape in (
            (know, "know", torch.bool, (n, u)),
            (learn_tick, "learn_tick", torch.int16, (n, u)),
            (up, "up", torch.bool, (n,)), (member, "member", torch.bool, (n,)),
            (r_active, "r_active", torch.bool, (u,)),
            (r_kind, "r_kind", torch.int8, (u,)),
            (r_subject, "r_subject", torch.int32, (u,)),
            (r_inc, "r_inc", torch.int32, (u,)),
            (r_confirm, "r_confirm", torch.int8, (u,)),
            (timeouts, "timeout table", torch.int16, (TIMEOUTS,)),
            (committed_dead, "committed_dead", torch.bool, (n,)),
            (committed_left, "committed_left", torch.bool, (n,)),
            (committed_inc, "committed_inc", torch.int32, (n,)),
            (bulk_member, "bulk_member", torch.bool, (n,)),
            (bulk_cov, "bulk_cov", torch.float32, (n,)),
            (out, "out", torch.float32, (1,))):
        _require(t, "believed_down " + name, dt, dev, shape)
    at = [t.data_ptr() + subject * t.element_size()
          for t in (committed_dead, committed_left, committed_inc,
                    bulk_member, bulk_cov)]
    rc = library().believed_down(
        know.data_ptr(), learn_tick.data_ptr(), up.data_ptr(),
        member.data_ptr(), r_active.data_ptr(), r_kind.data_ptr(),
        r_subject.data_ptr(), r_inc.data_ptr(), r_confirm.data_ptr(),
        timeouts.data_ptr(), *at, subject, tick16, 0, n, u,
        int(u in (16, 32, 64) and know.data_ptr() % 16 == 0),
        _counter_scratch(dev, "believed_down", 2).data_ptr(), SCRATCH_BLOCKS,
        out.data_ptr(), None, _stream(dev))
    _check(rc, "believed_down")
    LAUNCHES["believed_down"] += 1


def launch_believed_down_blocks(know, learn_tick, up, member, r_active,
                                r_kind, r_subject, r_inc, r_confirm,
                                timeouts, committed_dead, committed_left,
                                committed_inc, bulk_member, bulk_cov,
                                subject: int, tick16: int, out) -> None:
    """K3 over a node-sharded pool: the [N, U] and [N] leaves Blocks, the
    [U] tables and the timeout table Replicated (or tensors on one
    device), out [1] float32 on the first block's device.  One launch a
    block over its rows (`believed_down_blocks`), each writing its two
    counts to its own slot, then one believed_down_combine that adds them
    in block order, divides and floors by the subject's bulk coverage
    (read in the subject's block).  Blocks on one card launch one after
    another on its current stream; across cards the combine waits for
    every block (mesh.join)."""
    from consul_tpu_torch.parallel import mesh
    b_count, ell = know.n_blocks, know.rows
    n = b_count * ell
    devs = know.devices
    home = devs[0]
    u = know.shape[1] if len(know.shape) == 2 else -1
    if not 1 <= u <= 64:
        raise ValueError(f"believed_down takes 1-64 slots, got {u}")
    if not 0 <= subject < n:
        raise ValueError(f"believed_down: subject {subject} outside [0, {n})")
    if not -2 ** 15 <= tick16 < 2 ** 15:
        raise ValueError(f"believed_down: tick16 {tick16} out of range")
    rows = {name: _parts(x, b_count, "believed_down " + name) for name, x in (
        ("know", know), ("learn_tick", learn_tick), ("up", up),
        ("member", member), ("committed_dead", committed_dead),
        ("committed_left", committed_left), ("committed_inc", committed_inc),
        ("bulk_member", bulk_member), ("bulk_cov", bulk_cov))}
    kinds = {"know": (torch.bool, (ell, u)),
             "learn_tick": (torch.int16, (ell, u)), "up": (torch.bool, (ell,)),
             "member": (torch.bool, (ell,)),
             "committed_dead": (torch.bool, (ell,)),
             "committed_left": (torch.bool, (ell,)),
             "committed_inc": (torch.int32, (ell,)),
             "bulk_member": (torch.bool, (ell,)),
             "bulk_cov": (torch.float32, (ell,))}
    tables = {}
    for name, x, dt, shape in (
            ("r_active", r_active, torch.bool, (u,)),
            ("r_kind", r_kind, torch.int8, (u,)),
            ("r_subject", r_subject, torch.int32, (u,)),
            ("r_inc", r_inc, torch.int32, (u,)),
            ("r_confirm", r_confirm, torch.int8, (u,)),
            ("timeouts", timeouts, torch.int16, (TIMEOUTS,))):
        tables[name] = [_copy_on(x, d, "believed_down " + name) for d in devs]
        for t, d in zip(tables[name], devs):
            _require(t, "believed_down " + name, dt, d, shape)
    for b, d in enumerate(devs):
        for name, (dt, shape) in kinds.items():
            _require(rows[name][b], "believed_down " + name, dt, d, shape)
    _require(out, "believed_down out", torch.float32, home, (1,))
    sb, si = divmod(subject, ell)
    at = [rows[k][sb].data_ptr() + si * rows[k][sb].element_size()
          for k in ("committed_dead", "committed_left", "committed_inc",
                    "bulk_member", "bulk_cov")]
    enable_peer_access(devs)
    lib = library()
    partials = torch.empty(2 * b_count, dtype=torch.int64, device=home)
    for b, d in enumerate(devs):
        know_b = rows["know"][b]
        with _on(d):
            rc = lib.believed_down(
                know_b.data_ptr(), rows["learn_tick"][b].data_ptr(),
                rows["up"][b].data_ptr(), rows["member"][b].data_ptr(),
                *[tables[k][b].data_ptr() for k in (
                    "r_active", "r_kind", "r_subject", "r_inc", "r_confirm",
                    "timeouts")], *at, subject, tick16, b * ell, ell, u,
                int(u in (16, 32, 64) and know_b.data_ptr() % 16 == 0),
                _counter_scratch(d, "believed_down", 2).data_ptr(),
                SCRATCH_BLOCKS, None, partials.data_ptr() + 16 * b, _stream(d))
        _check(rc, "believed_down")
        LAUNCHES["believed_down_blocks"] += 1
    mesh.join(devs)
    with _on(home):
        rc = lib.believed_down_combine(partials.data_ptr(), b_count, at[3],
                                       at[4], out.data_ptr(), _stream(home))
    _check(rc, "believed_down_combine")
    LAUNCHES["believed_down_combine"] += 1


# members.cu's tile: the nodes of one block of members_scan and
# members_emit (kThreads * kPer), the unit of the per-block changed counts
MEMBER_TILE = 4096
MEMBER_COUNTS = 5    # alive, failed, left, provisioned, changed
# members_scan's per-device scratch: a word a total (its blocks' shares
# above bit 40, the count below)
MEMBER_SCRATCH = MEMBER_COUNTS


def member_tiles(n: int) -> int:
    return -(-n // MEMBER_TILE)


def _rumor_table(r_active, r_kind, r_subject, dev, name: str) -> int:
    u = r_active.shape[0] if r_active is not None and r_active.dim() == 1 else -1
    if not 1 <= u <= 64:
        raise ValueError(f"{name} takes 1-64 slots, got {u}")
    for t, what, dt in ((r_active, "r_active", torch.bool),
                        (r_kind, "r_kind", torch.int8),
                        (r_subject, "r_subject", torch.int32)):
        _require(t, f"{name} {what}", dt, dev, (u,))
    return u


def _node_vectors(name: str, dev, n: int, *named) -> None:
    for t, what, dt in named:
        _require(t, f"{name} {what}", dt, dev, (n,))


def launch_members_scan(member, committed_dead, committed_left, r_active,
                        r_kind, r_subject, provisioned, prev, status,
                        counts, block_changed) -> None:
    """K4's scan: status [N] int8 (when given), counts [5] int32 = alive,
    failed, left, provisioned and changed-against-prev over provisioned
    nodes (all nodes when provisioned is None), block_changed
    [member_tiles(N)] int32 = the changed count of tiles 0..b (an
    inclusive prefix, members_emit's input).  With prev, status and
    block_changed are required.  One launch; its scratch is kept per
    device, so two streams must not run it at once."""
    dev = member.device
    n = member.shape[0] if member.dim() == 1 else -1
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"members_scan: member must be [N], 1 <= N < 2^31")
    u = _rumor_table(r_active, r_kind, r_subject, dev, "members_scan")
    _node_vectors("members_scan", dev, n, (member, "member", torch.bool),
                  (committed_dead, "committed_dead", torch.bool),
                  (committed_left, "committed_left", torch.bool))
    _require(counts, "members_scan counts", torch.int32, dev,
             (MEMBER_COUNTS,))
    if provisioned is not None:
        _require(provisioned, "members_scan provisioned", torch.bool, dev,
                 (n,))
    if status is not None:
        _require(status, "members_scan status", torch.int8, dev, (n,))
    if prev is not None:
        if status is None or block_changed is None:
            raise ValueError("members_scan: prev needs status and "
                             "block_changed")
        _require(prev, "members_scan prev", torch.int8, dev, (n,))
    if block_changed is not None:
        _require(block_changed, "members_scan block_changed", torch.int32,
                 dev, (member_tiles(n),))
    rc = library().members_scan(
        member.data_ptr(), committed_dead.data_ptr(),
        committed_left.data_ptr(), r_active.data_ptr(), r_kind.data_ptr(),
        r_subject.data_ptr(), u, _ptr(provisioned), _ptr(prev), n, 0, n,
        _ptr(status), counts.data_ptr(), _ptr(block_changed),
        _scratch_words(dev, "members_scan", MEMBER_SCRATCH).data_ptr(),
        _stream(dev))
    _check(rc, "members_scan")
    LAUNCHES["members_scan"] += 1


def launch_members_emit(status, prev, provisioned, block_changed, k: int,
                        idx, state, counts=None) -> None:
    """K4's emit: idx [k] int32 and state [k] int8 = the ascending first k
    provisioned nodes whose status differs from prev, then -1 and
    status[0] (block_changed and counts [5] are members_scan's prefix and
    counts, from the same status)."""
    dev = status.device
    n = status.shape[0] if status.dim() == 1 else -1
    if not 1 <= n < 2 ** 31 or not 1 <= k < 2 ** 31:
        raise ValueError(f"members_emit: N={n} and k={k} must lie in "
                         f"[1, 2^31)")
    _node_vectors("members_emit", dev, n, (status, "status", torch.int8),
                  (prev, "prev", torch.int8),
                  (provisioned, "provisioned", torch.bool))
    _require(block_changed, "members_emit block_changed", torch.int32, dev,
             (member_tiles(n),))
    _require(idx, "members_emit idx", torch.int32, dev, (k,))
    _require(state, "members_emit state", torch.int8, dev, (k,))
    _require(counts, "members_emit counts", torch.int32, dev,
             (MEMBER_COUNTS,))
    rc = library().members_emit(status.data_ptr(), prev.data_ptr(),
                                provisioned.data_ptr(),
                                block_changed.data_ptr(), counts.data_ptr(),
                                1, 0, 0, status.data_ptr(), 1, n, k,
                                idx.data_ptr(), state.data_ptr(), _stream(dev))
    _check(rc, "members_emit")
    LAUNCHES["members_emit"] += 1


def launch_members_page(ids, member, committed_dead, committed_left,
                        r_active, r_kind, r_subject, incarnation, up,
                        st_out, inc_out, up_out) -> None:
    """K4's page: for the [K] int32 ids (negative ones wrapped once, then
    clamped into [0, N)), status, incarnation and up."""
    dev = member.device
    n = member.shape[0] if member.dim() == 1 else -1
    kk = ids.shape[0] if ids.dim() == 1 else 0
    if not 1 <= n < 2 ** 31 or kk < 1:
        raise ValueError(f"members_page: N={n} must lie in [1, 2^31) and "
                         f"ids must be [K], K >= 1")
    u = _rumor_table(r_active, r_kind, r_subject, dev, "members_page")
    _node_vectors("members_page", dev, n, (member, "member", torch.bool),
                  (committed_dead, "committed_dead", torch.bool),
                  (committed_left, "committed_left", torch.bool),
                  (incarnation, "incarnation", torch.int32),
                  (up, "up", torch.bool))
    _require(ids, "members_page ids", torch.int32, dev, (kk,))
    _require(st_out, "members_page st_out", torch.int8, dev, (kk,))
    _require(inc_out, "members_page inc_out", torch.int32, dev, (kk,))
    _require(up_out, "members_page up_out", torch.bool, dev, (kk,))
    tabs = [_table([t]) for t in (member, committed_dead, committed_left)]
    rc = library().members_page(
        ids.data_ptr(), kk, *tabs, r_active.data_ptr(), r_kind.data_ptr(),
        r_subject.data_ptr(), u, _table([incarnation]), _table([up]), 1, n,
        st_out.data_ptr(), inc_out.data_ptr(), up_out.data_ptr(), _stream(dev))
    _check(rc, "members_page")
    LAUNCHES["members_page"] += 1


def _member_blocks(name: str, b_count: int, ell: int, devs, *named) -> list:
    out = []
    for x, what, dt in named:
        parts = _parts(x, b_count, f"{name} {what}")
        for p, d in zip(parts, devs):
            _require(p, f"{name} {what}", dt, d, (ell,))
        out.append(parts)
    return out


def _member_table(name: str, devs, r_active, r_kind, r_subject) -> tuple:
    cols = [[_copy_on(x, d, f"{name} {what}") for d in devs]
            for x, what in ((r_active, "r_active"), (r_kind, "r_kind"),
                            (r_subject, "r_subject"))]
    u = -1
    for b, d in enumerate(devs):
        u = _rumor_table(cols[0][b], cols[1][b], cols[2][b], d, name)
    return u, cols


def launch_members_scan_blocks(member, committed_dead, committed_left,
                               r_active, r_kind, r_subject, provisioned,
                               prev, status, blk_counts,
                               block_changed) -> None:
    """K4's scan over a node-sharded pool: the [N] leaves (and provisioned,
    prev, status when given) Blocks, the [U] table Replicated (or tensors
    on one device), blk_counts [B * 5] int32 on the first block's device
    (block b's counts at 5b), block_changed Blocks of [member_tiles(L)]
    int32 (each block's tile prefix).  One launch a block over its L
    nodes (`members_scan_blocks`); members_combine adds the counts."""
    b_count, ell = member.n_blocks, member.rows
    n = b_count * ell
    devs = member.devices
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"members_scan: N={n} outside [1, 2^31)")
    u, cols = _member_table("members_scan", devs, r_active, r_kind,
                            r_subject)
    mem, cd, cl = _member_blocks(
        "members_scan", b_count, ell, devs, (member, "member", torch.bool),
        (committed_dead, "committed_dead", torch.bool),
        (committed_left, "committed_left", torch.bool))
    opt = {}
    for x, what, dt in ((provisioned, "provisioned", torch.bool),
                        (prev, "prev", torch.int8),
                        (status, "status", torch.int8)):
        opt[what] = None if x is None else _member_blocks(
            "members_scan", b_count, ell, devs, (x, what, dt))[0]
    if prev is not None and (status is None or block_changed is None):
        raise ValueError("members_scan: prev needs status and block_changed")
    tiles = None
    if block_changed is not None:
        tiles = _parts(block_changed, b_count, "members_scan block_changed")
        for t, d in zip(tiles, devs):
            _require(t, "members_scan block_changed", torch.int32, d,
                     (member_tiles(ell),))
    _require(blk_counts, "members_scan blk_counts", torch.int32, devs[0],
             (MEMBER_COUNTS * b_count,))
    enable_peer_access(devs)
    lib = library()
    for b, d in enumerate(devs):
        pick = {k: None if v is None else v[b] for k, v in opt.items()}
        with _on(d):
            rc = lib.members_scan(
                mem[b].data_ptr(), cd[b].data_ptr(), cl[b].data_ptr(),
                cols[0][b].data_ptr(), cols[1][b].data_ptr(),
                cols[2][b].data_ptr(), u, _ptr(pick["provisioned"]),
                _ptr(pick["prev"]), ell, b * ell, n, _ptr(pick["status"]),
                blk_counts.data_ptr() + 4 * MEMBER_COUNTS * b,
                None if tiles is None else tiles[b].data_ptr(),
                _scratch_words(d, "members_scan", MEMBER_SCRATCH).data_ptr(),
                _stream(d))
        _check(rc, "members_scan")
        LAUNCHES["members_scan_blocks"] += 1


def launch_members_combine(blk_counts, b_count: int, counts) -> None:
    """counts [5] int32 = the blocks' [B * 5] scan counts added in block
    order, one launch on their device (after every block's scan: the
    caller joins the mesh's streams first)."""
    dev = blk_counts.device
    _require(blk_counts, "members_combine blk_counts", torch.int32, dev,
             (MEMBER_COUNTS * b_count,))
    _require(counts, "members_combine counts", torch.int32, dev,
             (MEMBER_COUNTS,))
    with _on(dev):
        rc = library().members_combine(blk_counts.data_ptr(), b_count,
                                       counts.data_ptr(), _stream(dev))
    _check(rc, "members_combine")
    LAUNCHES["members_combine"] += 1


def launch_members_emit_blocks(status, prev, provisioned, block_changed,
                               blk_counts, k: int, idx, state) -> None:
    """K4's emit over a node-sharded pool: status, prev and provisioned
    Blocks, block_changed and blk_counts as launch_members_scan_blocks
    left them, idx [k] int32 and state [k] int8 on the first block's
    device.  One launch a block (`members_emit_blocks`): block b ranks its
    changed nodes after the earlier blocks' and writes those below k;
    the first block's launch writes the pad rows."""
    from consul_tpu_torch.parallel import mesh
    b_count, ell = status.n_blocks, status.rows
    n = b_count * ell
    devs = status.devices
    home = devs[0]
    if not 1 <= n < 2 ** 31 or not 1 <= k < 2 ** 31:
        raise ValueError(f"members_emit: N={n} and k={k} must lie in "
                         f"[1, 2^31)")
    st, pv, prov = _member_blocks(
        "members_emit", b_count, ell, devs, (status, "status", torch.int8),
        (prev, "prev", torch.int8), (provisioned, "provisioned", torch.bool))
    tiles = _parts(block_changed, b_count, "members_emit block_changed")
    for t, d in zip(tiles, devs):
        _require(t, "members_emit block_changed", torch.int32, d,
                 (member_tiles(ell),))
    _require(blk_counts, "members_emit blk_counts", torch.int32, home,
             (MEMBER_COUNTS * b_count,))
    _require(idx, "members_emit idx", torch.int32, home, (k,))
    _require(state, "members_emit state", torch.int8, home, (k,))
    enable_peer_access(devs)
    lib = library()
    mesh.join(devs)
    for b, d in enumerate(devs):
        with _on(d):
            rc = lib.members_emit(
                st[b].data_ptr(), pv[b].data_ptr(), prov[b].data_ptr(),
                tiles[b].data_ptr(), blk_counts.data_ptr(), b_count, b,
                b * ell, st[0].data_ptr(), int(b == 0), ell, k,
                idx.data_ptr(), state.data_ptr(), _stream(d))
        _check(rc, "members_emit")
        LAUNCHES["members_emit_blocks"] += 1
    mesh.join(devs)


def launch_members_page_blocks(ids, member, committed_dead, committed_left,
                               r_active, r_kind, r_subject, incarnation, up,
                               st_out, inc_out, up_out) -> None:
    """K4's page over a node-sharded pool: one launch on the first block's
    device (`members_page_blocks`) reading the five leaves through block
    tables, the [K] ids and outputs there too."""
    from consul_tpu_torch.parallel import mesh
    b_count, ell = member.n_blocks, member.rows
    n = b_count * ell
    devs = member.devices
    home = devs[0]
    kk = ids.shape[0] if ids.dim() == 1 else 0
    if not 1 <= n < 2 ** 31 or kk < 1 or b_count > 16:
        raise ValueError(f"members_page: N={n} must lie in [1, 2^31), ids "
                         f"must be [K], K >= 1, and 1-16 blocks")
    u, cols = _member_table("members_page", [home], r_active, r_kind,
                            r_subject)
    leaves = _member_blocks(
        "members_page", b_count, ell, devs, (member, "member", torch.bool),
        (committed_dead, "committed_dead", torch.bool),
        (committed_left, "committed_left", torch.bool),
        (incarnation, "incarnation", torch.int32), (up, "up", torch.bool))
    _require(ids, "members_page ids", torch.int32, home, (kk,))
    _require(st_out, "members_page st_out", torch.int8, home, (kk,))
    _require(inc_out, "members_page inc_out", torch.int32, home, (kk,))
    _require(up_out, "members_page up_out", torch.bool, home, (kk,))
    enable_peer_access(devs)
    mesh.join(devs)
    tabs = [_table(parts) for parts in leaves]
    with _on(home):
        rc = library().members_page(
            ids.data_ptr(), kk, tabs[0], tabs[1], tabs[2],
            cols[0][0].data_ptr(), cols[1][0].data_ptr(),
            cols[2][0].data_ptr(), u, tabs[3], tabs[4], b_count, ell,
            st_out.data_ptr(), inc_out.data_ptr(), up_out.data_ptr(),
            _stream(home))
    _check(rc, "members_page")
    LAUNCHES["members_page_blocks"] += 1


MASS_COUNTERS = 4    # detect.cu's kCounters: live, victims, and the base
#                      believed-down counts over victims and over live rows
MASS_STAMPS = 3      # its instrumented build's phase stamps
# detect.cu's kStampAt: the done count, the counters and 64 slot counts
MASS_STAMP_AT = 1 + MASS_COUNTERS + 64
MASS_SCRATCH = MASS_STAMP_AT + MASS_STAMPS


def launch_mass_detect(know, up, member, committed_dead, committed_left,
                       bulk_member, bulk_cov, victim, r_active, r_kind,
                       r_subject, recall_out, fp_out) -> None:
    """K5: recall (float32) into recall_out[0] and false positives (int32)
    into fp_out[0] of a correlated-failure experiment, from the [N, U]
    knowledge matrix, the [N] leaves and the raw [U] rumor table, in one
    launch (its scratch kept per device and left zeroed by each launch,
    so two streams must not run it at once)."""
    dev = know.device
    if know.dim() != 2:
        raise ValueError("mass_detect: know must be [N, U]")
    n, u = know.shape
    if not 1 <= u <= 64:
        raise ValueError(f"mass_detect takes 1-64 slots, got {u}")
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"mass_detect: N={n} outside [1, 2^31)")
    _require(know, "mass_detect know", torch.bool, dev, (n, u))
    _node_vectors("mass_detect", dev, n, (up, "up", torch.bool),
                  (member, "member", torch.bool),
                  (committed_dead, "committed_dead", torch.bool),
                  (committed_left, "committed_left", torch.bool),
                  (bulk_member, "bulk_member", torch.bool),
                  (bulk_cov, "bulk_cov", torch.float32),
                  (victim, "victim", torch.bool))
    if _rumor_table(r_active, r_kind, r_subject, dev, "mass_detect") != u:
        raise ValueError(f"mass_detect: the rumor table has "
                         f"{r_active.shape[0]} slots, know {u}")
    _require(recall_out, "mass_detect recall_out", torch.float32, dev, (1,))
    _require(fp_out, "mass_detect fp_out", torch.int32, dev, (1,))
    scratch = _scratch_words(dev, "mass_detect", MASS_SCRATCH)
    rc = library().mass_detect(
        know.data_ptr(), up.data_ptr(), member.data_ptr(),
        committed_dead.data_ptr(), committed_left.data_ptr(),
        bulk_member.data_ptr(), bulk_cov.data_ptr(), victim.data_ptr(),
        r_active.data_ptr(), r_kind.data_ptr(), r_subject.data_ptr(), n, u,
        scratch.data_ptr(), recall_out.data_ptr(), fp_out.data_ptr(),
        _stream(dev))
    _check(rc, "mass_detect")
    LAUNCHES["mass_detect"] += 1


MERGE_CLASSES = 4             # reconcile.cu's kClasses: counts a block
MERGE_STAMPS = 4              # its instrumented build's phase stamps
# reconcile_merge's per-device scratch in int64 words (reconcile.cu:
# reconcile_merge): the blocks' 32-bit class counts, then the stamps
MERGE_STAMP_AT = MERGE_CLASSES * SCRATCH_BLOCKS // 2
MERGE_SCRATCH = MERGE_STAMP_AT + MERGE_STAMPS
_I32_MAX = 2 ** 31 - 1


def _tables(name: str, src_ids, dst_ids) -> tuple:
    m = src_ids.shape[0] if src_ids is not None and src_ids.dim() == 1 else 0
    k = dst_ids.shape[0] if dst_ids is not None and dst_ids.dim() == 1 else 0
    if not 1 <= m <= _I32_MAX or not 1 <= k <= _I32_MAX:
        raise ValueError(f"{name}: both tables must be [rows] with 1 to "
                         f"2^31 - 1 rows, got {m} and {k}")
    return m, k


def launch_reconcile_diff(src_ids, src_ver, dst_ids, dst_ver, push, drop,
                          due=None, d_node=None, a_node=None) -> None:
    """K6's diff: push [M] bool and drop [K] bool of diff_sorted from the
    id-sorted int32 tables (src_ids, src_ver) [M] and (dst_ids, dst_ver)
    [K].  The step's form passes due [N] bool with the owning agents
    d_node [M] and a_node [K] (int32, in [0, N)) and gets push &
    due[d_node] and drop & due[a_node]."""
    dev = src_ids.device if src_ids is not None else None
    m, k = _tables("reconcile_diff", src_ids, dst_ids)
    named = [(src_ids, "src_ids", torch.int32, m),
             (src_ver, "src_ver", torch.int32, m),
             (dst_ids, "dst_ids", torch.int32, k),
             (dst_ver, "dst_ver", torch.int32, k),
             (push, "push", torch.bool, m), (drop, "drop", torch.bool, k)]
    step = (due, d_node, a_node)
    if any(t is None for t in step) and any(t is not None for t in step):
        raise ValueError("reconcile_diff: due, d_node and a_node come "
                         "together")
    n_due = 0
    if due is not None:
        n_due = due.shape[0] if due.dim() == 1 else 0
        if n_due < 1:
            raise ValueError(f"reconcile_diff: due must be [agents], got "
                             f"{tuple(due.shape)}")
        named += [(due, "due", torch.bool, n_due),
                  (d_node, "d_node", torch.int32, m),
                  (a_node, "a_node", torch.int32, k)]
    for t, what, dt, n in named:
        _require(t, "reconcile_diff " + what, dt, dev, (n,))
    rc = library().reconcile_diff(
        src_ids.data_ptr(), src_ver.data_ptr(), dst_ids.data_ptr(),
        dst_ver.data_ptr(), m, k, _ptr(due), _ptr(d_node), _ptr(a_node),
        n_due, push.data_ptr(), drop.data_ptr(), _stream(dev))
    _check(rc, "reconcile_diff")
    LAUNCHES["reconcile_diff"] += 1


def launch_reconcile_merge(d_ids, d_ver, d_node, push, a_ids, a_ver, a_node,
                           drop, out_ids, out_ver, out_node) -> None:
    """K6's merge (one cooperative launch): the catalog (a_ids, a_ver,
    a_node) [K] with the rows under `drop` [K] compacted out (drop may be
    None), merged with the desired rows (d_ids, d_ver, d_node) [M] under
    `push` [M], into out_ids/out_ver/out_node [K]; the node columns come
    together or are all None.  int32 columns, bool masks.  Its per-block
    counts live in per-device scratch, so two streams must not run it at
    once."""
    dev = d_ids.device if d_ids is not None else None
    m, k = _tables("reconcile_merge", d_ids, a_ids)
    nodes = (d_node, a_node, out_node)
    if any(t is None for t in nodes) and any(t is not None for t in nodes):
        raise ValueError("reconcile_merge: d_node, a_node and out_node come "
                         "together")
    named = [(d_ids, "d_ids", torch.int32, m), (d_ver, "d_ver", torch.int32, m),
             (push, "push", torch.bool, m), (a_ids, "a_ids", torch.int32, k),
             (a_ver, "a_ver", torch.int32, k),
             (out_ids, "out_ids", torch.int32, k),
             (out_ver, "out_ver", torch.int32, k)]
    if d_node is not None:
        named += [(d_node, "d_node", torch.int32, m),
                  (a_node, "a_node", torch.int32, k),
                  (out_node, "out_node", torch.int32, k)]
    if drop is not None:
        named.append((drop, "drop", torch.bool, k))
    for t, what, dt, n in named:
        _require(t, "reconcile_merge " + what, dt, dev, (n,))
    scratch = _scratch_words(dev, "reconcile_merge", MERGE_SCRATCH)
    rc = library().reconcile_merge(
        d_ids.data_ptr(), d_ver.data_ptr(), _ptr(d_node), push.data_ptr(),
        a_ids.data_ptr(), a_ver.data_ptr(), _ptr(a_node), _ptr(drop), m, k,
        scratch.data_ptr(), SCRATCH_BLOCKS, out_ids.data_ptr(),
        out_ver.data_ptr(), _ptr(out_node), _stream(dev))
    _check(rc, "reconcile_merge")
    LAUNCHES["reconcile_merge"] += 1


PROBE_COUNTERS = 4      # probe.cu's kCounters: probed, acked, failed, started
PROBE_MAX_RELAYS = 16   # probe.cu's kMaxRelays
# originate.cu's scratch: the plan words before the per-block lists, and
# the select phase's most blocks (each writes A <= 64 keys)
ORIGINATE_PLAN = 198
ORIGINATE_LIST_BLOCKS = 1024
_BOOL, _I8, _I16, _I32, _F = (torch.bool, torch.int8, torch.int16,
                              torch.int32, torch.float32)


def _slot_rows(name: str, know, learn_tick, sends_left, dev) -> tuple:
    if know is None or know.dim() != 2:
        raise ValueError(f"{name}: know must be [N, U]")
    n, u = know.shape
    if not 1 <= n < 2 ** 31 or not 1 <= u <= 64:
        raise ValueError(f"{name}: N={n} must lie in [1, 2^31) and U={u} "
                         f"in [1, 64]")
    for t, what, dt in ((know, "know", _BOOL), (learn_tick, "learn_tick", _I16),
                        (sends_left, "sends_left", _I8)):
        _require(t, f"{name} {what}", dt, dev, (n, u))
    return n, u


def launch_probe_round(*, up, member, awareness, coords, committed_dead,
                       committed_left, committed_inc, bulk_member, know,
                       learn_tick, sends_left, sus_start, sus_confirm,
                       sus_count, chaos_grp, chaos_ok, r_active, r_kind,
                       r_subject, r_inc, r_confirm, timeouts, suspect_of,
                       dead_of, left_of, alive_val, ctr, offs, rtt_draw,
                       direct, lha, leg_a, leg_b, leg_c, awareness_max: int,
                       degraded: bool, seed: int, ok_good: float,
                       ok_bad: float, degraded_frac: float,
                       probe_timeout_ms: float, rtt_base_ms: float, tick: int,
                       tick16: int, limit: int, want_out, row_subject_out,
                       rtt_out, acked_out) -> None:
    """K7: one probe round of the pool.  Reads the state's leaves, the [N]
    subject maps, the int16 timeout table [65] and the round's draws (offs
    [1 + k] int32, rtt/direct/lha [N] and the relay legs [N, k] float32;
    lha None when awareness_max is 0, the legs None when k is 0; chaos_grp
    and chaos_ok None outside the chaos build).  Updates know, learn_tick,
    sends_left, awareness (when awareness_max > 0), sus_start,
    sus_confirm, sus_count, r_confirm and ctr in place, where they change;
    writes want_out, row_subject_out, rtt_out and acked_out whole."""
    dev = know.device if know is not None else None
    n, u = _slot_rows("probe_round", know, learn_tick, sends_left, dev)
    k = offs.shape[0] - 1 if offs is not None and offs.dim() == 1 else -1
    if not 0 <= k <= PROBE_MAX_RELAYS:
        raise ValueError(f"probe_round takes 0-{PROBE_MAX_RELAYS} relays: "
                         f"offs must be [1 + k]")
    if not 0 <= awareness_max <= 127:
        raise ValueError(f"probe_round: awareness_max {awareness_max} "
                         f"outside [0, 127]")
    if not -2 ** 15 <= tick16 < 2 ** 15 or not 0 <= tick < 2 ** 31 \
            or not 0 <= limit <= 127:
        raise ValueError(f"probe_round: tick {tick}, tick16 {tick16} or "
                         f"limit {limit} out of range")
    c = ctr.shape[0] if ctr is not None and ctr.dim() == 1 else 0
    if not PROBE_COUNTERS <= c <= 16:
        raise ValueError(f"probe_round: ctr must be [C], 4 <= C <= 16")
    _node_vectors("probe_round", dev, n,
                  (up, "up", _BOOL), (member, "member", _BOOL),
                  (awareness, "awareness", _I8),
                  (committed_dead, "committed_dead", _BOOL),
                  (committed_left, "committed_left", _BOOL),
                  (committed_inc, "committed_inc", _I32),
                  (bulk_member, "bulk_member", _BOOL),
                  (sus_start, "sus_start", _I32),
                  (sus_confirm, "sus_confirm", _I8),
                  (sus_count, "sus_count", _I32),
                  (suspect_of, "suspect_of", _I32), (dead_of, "dead_of", _I32),
                  (left_of, "left_of", _I32), (alive_val, "alive_val", _I32),
                  (rtt_draw, "rtt_draw", _F), (direct, "direct", _F),
                  (want_out, "want_out", _I32),
                  (row_subject_out, "row_subject_out", _I32),
                  (rtt_out, "rtt_out", _F), (acked_out, "acked_out", _BOOL))
    _require(coords, "probe_round coords", _F, dev, (n, 2))
    if coords.data_ptr() % 8:
        raise ValueError("probe_round: coords must be 8-byte aligned (a "
                         "float2 a row)")
    if _rumor_table(r_active, r_kind, r_subject, dev, "probe_round") != u:
        raise ValueError(f"probe_round: the rumor table has "
                         f"{r_active.shape[0]} slots, know {u}")
    for t, what, dt, shape in (
            (r_inc, "r_inc", _I32, (u,)), (r_confirm, "r_confirm", _I8, (u,)),
            (timeouts, "timeout table", _I16, (TIMEOUTS,)),
            (offs, "offs", _I32, (k + 1,)), (ctr, "ctr", _F, (c,))):
        _require(t, "probe_round " + what, dt, dev, shape)
    if (chaos_grp is None) != (chaos_ok is None):
        raise ValueError("probe_round: chaos_grp and chaos_ok come together")
    if chaos_grp is not None:
        _node_vectors("probe_round", dev, n, (chaos_grp, "chaos_grp", _I16),
                      (chaos_ok, "chaos_ok", _F))
    if (awareness_max > 0) != (lha is not None):
        raise ValueError("probe_round: lha comes with awareness_max > 0, "
                         "and only then")
    if awareness_max > 0:
        _node_vectors("probe_round", dev, n, (lha, "lha", _F))
    legs = (leg_a, leg_b, leg_c)
    if any((t is None) != (k == 0) for t in legs):
        raise ValueError("probe_round: the three relay legs come with k > 0, "
                         "and only then")
    for t, what in zip(legs, ("leg_a", "leg_b", "leg_c")):
        if k > 0:
            _require(t, "probe_round " + what, _F, dev, (n, k))
    scratch = _counter_scratch(dev, "probe_round", PROBE_COUNTERS, extra=64)
    tables = _one_table(up, member, committed_dead, committed_left,
                        committed_inc, bulk_member, suspect_of, dead_of,
                        left_of, alive_val, coords, chaos_grp, chaos_ok,
                        sus_start, sus_confirm, sus_count, want_out)
    rc = library().probe_round(
        up.data_ptr(), member.data_ptr(), awareness.data_ptr(),
        coords.data_ptr(), committed_dead.data_ptr(),
        committed_left.data_ptr(), committed_inc.data_ptr(),
        bulk_member.data_ptr(), know.data_ptr(), learn_tick.data_ptr(),
        sends_left.data_ptr(), sus_start.data_ptr(), sus_confirm.data_ptr(),
        sus_count.data_ptr(), _ptr(chaos_grp), _ptr(chaos_ok),
        r_active.data_ptr(), r_kind.data_ptr(), r_subject.data_ptr(),
        r_inc.data_ptr(), r_confirm.data_ptr(), timeouts.data_ptr(),
        suspect_of.data_ptr(), dead_of.data_ptr(), left_of.data_ptr(),
        alive_val.data_ptr(), ctr.data_ptr(), offs.data_ptr(),
        rtt_draw.data_ptr(), direct.data_ptr(), _ptr(lha), _ptr(leg_a),
        _ptr(leg_b), _ptr(leg_c), n, u, k, awareness_max,
        int(chaos_grp is not None), int(degraded), c, seed & 0xFFFFFFFF,
        ok_good, ok_bad, degraded_frac, probe_timeout_ms, rtt_base_ms, tick,
        tick16, limit, scratch.data_ptr(), SCRATCH_BLOCKS,
        want_out.data_ptr(), row_subject_out.data_ptr(), rtt_out.data_ptr(),
        acked_out.data_ptr(), 0, n, tables, 1, n, None, _stream(dev))
    _check(rc, "probe_round")
    LAUNCHES["probe_round"] += 1


def launch_originate(*, want, row_subject, inc_of_subject, up, member, know,
                     learn_tick, sends_left, committed_dead, committed_left,
                     committed_inc, r_active, r_kind, r_subject, r_inc,
                     r_start, r_confirm, r_coverage, alloc: int, kind: int,
                     tick: int, tick16: int, limit: int, subjects_out,
                     slots_out, ok_out) -> None:
    """K8: allocate up to `alloc` rumor slots of `kind` for the subjects
    with want [N] int32 > 0, evicting fully disseminated non-suspect slots
    when demand exceeds the free slots, and seed the rows whose
    row_subject names an allocated subject.  Updates the [N, U] rows, the
    committed [N] leaves and the [U] table in place, where they change;
    writes the (subjects, slots, ok) [alloc] of the allocation whole."""
    dev = know.device if know is not None else None
    n, u = _slot_rows("originate", know, learn_tick, sends_left, dev)
    if not 1 <= alloc <= min(u, n):
        raise ValueError(f"originate: alloc {alloc} outside [1, min(U, N)]")
    if not 0 <= kind <= 3 or not 0 <= tick < 2 ** 31 \
            or not -2 ** 15 <= tick16 < 2 ** 15 or not 0 <= limit <= 127:
        raise ValueError(f"originate: kind {kind}, tick {tick}, tick16 "
                         f"{tick16} or limit {limit} out of range")
    _node_vectors("originate", dev, n,
                  (want, "want", _I32), (row_subject, "row_subject", _I32),
                  (inc_of_subject, "inc_of_subject", _I32),
                  (up, "up", _BOOL), (member, "member", _BOOL),
                  (committed_dead, "committed_dead", _BOOL),
                  (committed_left, "committed_left", _BOOL),
                  (committed_inc, "committed_inc", _I32))
    if _rumor_table(r_active, r_kind, r_subject, dev, "originate") != u:
        raise ValueError(f"originate: the rumor table has "
                         f"{r_active.shape[0]} slots, know {u}")
    for t, what, dt, shape in (
            (r_inc, "r_inc", _I32, (u,)), (r_start, "r_start", _I32, (u,)),
            (r_confirm, "r_confirm", _I8, (u,)),
            (r_coverage, "r_coverage", _F, (u,)),
            (subjects_out, "subjects_out", _I32, (alloc,)),
            (slots_out, "slots_out", _I32, (alloc,)),
            (ok_out, "ok_out", _BOOL, (alloc,))):
        _require(t, "originate " + what, dt, dev, shape)
    scratch = _scratch_words(dev, "originate",
                             ORIGINATE_PLAN + 64 * ORIGINATE_LIST_BLOCKS)
    rc = library().originate(
        want.data_ptr(), row_subject.data_ptr(), inc_of_subject.data_ptr(),
        up.data_ptr(), member.data_ptr(), know.data_ptr(),
        learn_tick.data_ptr(), sends_left.data_ptr(),
        committed_dead.data_ptr(), committed_left.data_ptr(),
        committed_inc.data_ptr(), r_active.data_ptr(), r_kind.data_ptr(),
        r_subject.data_ptr(), r_inc.data_ptr(), r_start.data_ptr(),
        r_confirm.data_ptr(), r_coverage.data_ptr(), n, u, alloc, kind, tick,
        tick16, limit, scratch.data_ptr(), ORIGINATE_LIST_BLOCKS,
        subjects_out.data_ptr(), slots_out.data_ptr(), ok_out.data_ptr(),
        0, 0, n, _one_table(inc_of_subject, committed_dead, committed_left,
                            committed_inc), 1, n, 0, None, None, _stream(dev))
    _check(rc, "originate")
    LAUNCHES["originate"] += 1


# expiry.cu's scratch words (the grid's expired slots, its readers) and
# refute.cu's (refutation: the blocks done deciding; expire: the live
# rows, 64 per-slot counts, the blocks that read them)
EXPIRY_SCRATCH = 2
REFUTE_SCRATCH = 1
EXPIRE_SCRATCH = 66
DENSE_COUNTS = 3        # dense.cu's sums: bulk members, live rows, wants


def _node_count(name: str, t) -> int:
    n = t.shape[0] if t is not None and t.dim() == 1 else 0
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"{name}: the [N] maps must have 1 <= N < 2^31")
    return n


def _ticks(name: str, tick: int, tick16: int = 0, limit: int = 0) -> None:
    if not 0 <= tick < 2 ** 31 or not -2 ** 15 <= tick16 < 2 ** 15 \
            or not 0 <= limit <= 127:
        raise ValueError(f"{name}: tick {tick}, tick16 {tick16} or limit "
                         f"{limit} out of range")


def launch_subject_maps(r_active, r_kind, r_subject, r_inc, suspect_of,
                        dead_of, left_of, alive_val) -> None:
    """K9's build: the four [N] int32 subject maps of the [U] rumor table
    (the largest slot of each kind whose subject is the node, the alive
    map's value r_inc * U + slot; -1 where none)."""
    dev = suspect_of.device if suspect_of is not None else None
    n = _node_count("subject_maps", suspect_of)
    u = _rumor_table(r_active, r_kind, r_subject, dev, "subject_maps")
    _node_vectors("subject_maps", dev, u, (r_inc, "r_inc", _I32))
    _node_vectors("subject_maps", dev, n, (suspect_of, "suspect_of", _I32),
                  (dead_of, "dead_of", _I32), (left_of, "left_of", _I32),
                  (alive_val, "alive_val", _I32))
    rc = library().subject_maps(
        r_active.data_ptr(), r_kind.data_ptr(), r_subject.data_ptr(),
        r_inc.data_ptr(), n, u, 0, n, suspect_of.data_ptr(), dead_of.data_ptr(),
        left_of.data_ptr(), alive_val.data_ptr(), _stream(dev))
    _check(rc, "subject_maps")
    LAUNCHES["subject_maps"] += 1


def launch_map_add(map_n, subjects, slots, ok) -> None:
    """K9's map_add, in place: the [A] (subject, slot) pairs under `ok`
    scatter-maxed into map_n [N] int32 (the others -1 into index 0)."""
    dev = map_n.device if map_n is not None else None
    n = _node_count("map_add", map_n)
    a = subjects.shape[0] if subjects is not None and subjects.dim() == 1 \
        else 0
    if not 1 <= a <= 64:
        raise ValueError(f"map_add takes 1-64 pairs, got {a}")
    _node_vectors("map_add", dev, n, (map_n, "map", _I32))
    _node_vectors("map_add", dev, a, (subjects, "subjects", _I32),
                  (slots, "slots", _I32), (ok, "ok", _BOOL))
    rc = library().map_add(map_n.data_ptr(), subjects.data_ptr(),
                           slots.data_ptr(), ok.data_ptr(), n, a, 0, n,
                           _stream(dev))
    _check(rc, "map_add")
    LAUNCHES["map_add"] += 1


def launch_maps_convert(suspect_of, dead_of, convert, r_subject) -> None:
    """K9's maps_convert, in place: the converting [U] slots' subjects
    leave suspect_of (a min with -1) and enter dead_of (a max with the
    slot)."""
    dev = suspect_of.device if suspect_of is not None else None
    n = _node_count("maps_convert", suspect_of)
    u = convert.shape[0] if convert is not None and convert.dim() == 1 else 0
    if not 1 <= u <= 64:
        raise ValueError(f"maps_convert takes 1-64 slots, got {u}")
    _node_vectors("maps_convert", dev, n, (suspect_of, "suspect_of", _I32),
                  (dead_of, "dead_of", _I32))
    _node_vectors("maps_convert", dev, u, (convert, "convert", _BOOL),
                  (r_subject, "r_subject", _I32))
    rc = library().maps_convert(suspect_of.data_ptr(), dead_of.data_ptr(),
                                convert.data_ptr(), r_subject.data_ptr(), n,
                                u, 0, n, _stream(dev))
    _check(rc, "maps_convert")
    LAUNCHES["maps_convert"] += 1


def launch_suspicion_expiry(*, know, learn_tick, sends_left, up, member,
                            committed_dead, committed_inc, r_active, r_kind,
                            r_subject, r_inc, r_start, r_confirm, timeouts,
                            tick: int, tick16: int, limit: int,
                            convert_out) -> None:
    """K10: the slot suspicion expiry of the pool (one cooperative launch:
    scan, grid barrier, decision, apply), from the int16 timeout table
    [65].  Updates know / learn_tick / sends_left in the converted columns
    and r_kind / r_start at the converted slots in place, where they
    change; writes convert_out [U] bool whole."""
    dev = know.device if know is not None else None
    n, u = _slot_rows("suspicion_expiry", know, learn_tick, sends_left, dev)
    _ticks("suspicion_expiry", tick, tick16, limit)
    _node_vectors("suspicion_expiry", dev, n, (up, "up", _BOOL),
                  (member, "member", _BOOL),
                  (committed_dead, "committed_dead", _BOOL),
                  (committed_inc, "committed_inc", _I32))
    if _rumor_table(r_active, r_kind, r_subject, dev, "suspicion_expiry") != u:
        raise ValueError(f"suspicion_expiry: the rumor table has "
                         f"{r_active.shape[0]} slots, know {u}")
    _node_vectors("suspicion_expiry", dev, u, (r_inc, "r_inc", _I32),
                  (r_start, "r_start", _I32), (r_confirm, "r_confirm", _I8),
                  (convert_out, "convert_out", _BOOL))
    _require(timeouts, "suspicion_expiry timeout table", _I16, dev,
             (TIMEOUTS,))
    scratch = _scratch_words(dev, "suspicion_expiry", EXPIRY_SCRATCH)
    rc = library().suspicion_expiry(
        know.data_ptr(), learn_tick.data_ptr(), sends_left.data_ptr(),
        up.data_ptr(), member.data_ptr(), committed_dead.data_ptr(),
        committed_inc.data_ptr(), r_active.data_ptr(), r_kind.data_ptr(),
        r_subject.data_ptr(), r_inc.data_ptr(), r_start.data_ptr(),
        r_confirm.data_ptr(), timeouts.data_ptr(), n, u, tick, tick16, limit,
        scratch.data_ptr(), convert_out.data_ptr(), 0, 0, n,
        _one_table(committed_inc, committed_dead), 1, n, None, None,
        _stream(dev))
    _check(rc, "suspicion_expiry")
    LAUNCHES["suspicion_expiry"] += 1


def _shift(name: str, shift, dev) -> None:
    if shift is None or shift.numel() != 1:
        raise ValueError(f"{name}: shift must be one int32 on the device")
    _require(shift, f"{name} shift", _I32, dev)


def launch_dense_expiry(*, sus_start, sus_confirm, up, member, committed_dead,
                        bulk_member, suspect_of, dead_of, left_of, know,
                        learn_tick, sends_left, r_active, r_kind, r_subject,
                        r_start, timeouts, shift, tick: int, tick16: int,
                        limit: int, period: int, exp_out, want_out,
                        row_subject_out, counts_out) -> None:
    """K11's pre launch: the expiring suspect slots (exp_out [U] bool), the
    wants at each prober's ring target (i + shift) % N and the probers'
    row subjects, and the sums [3] int64 (bulk members, live rows, wants)
    of the post launch, all written whole; the learn_tick / sends_left
    stamps of the known cells of the expiring columns and the [U] kind and
    start, in place where they change.  The int32 timeout table [65];
    `shift` one int32 read on the device."""
    dev = know.device if know is not None else None
    n, u = _slot_rows("dense_expiry", know, learn_tick, sends_left, dev)
    _ticks("dense_expiry", tick, tick16, limit)
    if not 1 <= period < 2 ** 31:
        raise ValueError(f"dense_expiry: probe period {period} out of range")
    _node_vectors("dense_expiry", dev, n, (sus_start, "sus_start", _I32),
                  (sus_confirm, "sus_confirm", _I8), (up, "up", _BOOL),
                  (member, "member", _BOOL),
                  (committed_dead, "committed_dead", _BOOL),
                  (bulk_member, "bulk_member", _BOOL),
                  (suspect_of, "suspect_of", _I32), (dead_of, "dead_of", _I32),
                  (left_of, "left_of", _I32), (want_out, "want_out", _I32),
                  (row_subject_out, "row_subject_out", _I32))
    if _rumor_table(r_active, r_kind, r_subject, dev, "dense_expiry") != u:
        raise ValueError(f"dense_expiry: the rumor table has "
                         f"{r_active.shape[0]} slots, know {u}")
    _node_vectors("dense_expiry", dev, u, (r_start, "r_start", _I32),
                  (exp_out, "exp_out", _BOOL))
    _require(timeouts, "dense_expiry timeout table", _I32, dev, (TIMEOUTS,))
    _require(counts_out, "dense_expiry counts_out", torch.int64, dev,
             (DENSE_COUNTS,))
    _shift("dense_expiry", shift, dev)
    scratch = _counter_scratch(dev, "dense_expiry", DENSE_COUNTS)
    rc = library().dense_expiry(
        sus_start.data_ptr(), sus_confirm.data_ptr(), up.data_ptr(),
        member.data_ptr(), committed_dead.data_ptr(), bulk_member.data_ptr(),
        suspect_of.data_ptr(), dead_of.data_ptr(), left_of.data_ptr(),
        know.data_ptr(), learn_tick.data_ptr(), sends_left.data_ptr(),
        r_active.data_ptr(), r_kind.data_ptr(), r_subject.data_ptr(),
        r_start.data_ptr(), timeouts.data_ptr(), shift.data_ptr(), n, u,
        tick, tick16, limit, period, scratch.data_ptr(), SCRATCH_BLOCKS,
        exp_out.data_ptr(), want_out.data_ptr(), row_subject_out.data_ptr(),
        counts_out.data_ptr(), 0, 0, n,
        _one_table(up, member, committed_dead, bulk_member, left_of, sus_start,
                   sus_confirm, suspect_of, dead_of, want_out), 1, n, None,
        _stream(dev))
    _check(rc, "dense_expiry")
    LAUNCHES["dense_expiry"] += 1


def launch_dense_expiry_post(*, want, dead_of, left_of, exp, r_subject,
                             subjects, slots, ok, up, member, committed_dead,
                             committed_left, counts, shift, tick: int,
                             period: int, chaos: bool, bulk_member,
                             bulk_heard, bulk_cov, sus_start,
                             sus_confirm) -> None:
    """K11's post launch, after the dead origination: the bulk overflow
    (off when `chaos`) and the timer clears, into bulk_member /
    bulk_heard / bulk_cov / sus_start / sus_confirm in place, where they
    change.  dead_of is the map the pre launch read; the kernel adds the
    pre launch's converted slots (`exp` [U] over `r_subject`, the table
    before the origination) and the origination's ok (subjects, slots)
    [A] pairs per node; `counts` holds the pre launch's sums."""
    dev = want.device if want is not None else None
    n = _node_count("dense_expiry_post", want)
    a = ok.shape[0] if ok is not None and ok.dim() == 1 else 0
    if not 1 <= a <= 64:
        raise ValueError(f"dense_expiry_post takes 1-64 pairs, got {a}")
    u = exp.shape[0] if exp is not None and exp.dim() == 1 else 0
    if not 1 <= u <= 64:
        raise ValueError(f"dense_expiry_post takes 1-64 slots, got {u}")
    _ticks("dense_expiry_post", tick)
    if not 1 <= period < 2 ** 31:
        raise ValueError(f"dense_expiry_post: probe period {period} out of "
                         f"range")
    _node_vectors("dense_expiry_post", dev, n, (want, "want", _I32),
                  (dead_of, "dead_of", _I32), (left_of, "left_of", _I32),
                  (up, "up", _BOOL), (member, "member", _BOOL),
                  (committed_dead, "committed_dead", _BOOL),
                  (committed_left, "committed_left", _BOOL),
                  (bulk_member, "bulk_member", _BOOL),
                  (bulk_heard, "bulk_heard", _F), (bulk_cov, "bulk_cov", _F),
                  (sus_start, "sus_start", _I32),
                  (sus_confirm, "sus_confirm", _I8))
    _node_vectors("dense_expiry_post", dev, u, (exp, "exp", _BOOL),
                  (r_subject, "r_subject", _I32))
    _node_vectors("dense_expiry_post", dev, a, (subjects, "subjects", _I32),
                  (slots, "slots", _I32), (ok, "ok", _BOOL))
    _require(counts, "dense_expiry_post counts", torch.int64, dev,
             (DENSE_COUNTS,))
    _shift("dense_expiry_post", shift, dev)
    rc = library().dense_expiry_post(
        want.data_ptr(), dead_of.data_ptr(), left_of.data_ptr(),
        exp.data_ptr(), r_subject.data_ptr(), subjects.data_ptr(),
        slots.data_ptr(), ok.data_ptr(), up.data_ptr(), member.data_ptr(),
        committed_dead.data_ptr(), committed_left.data_ptr(),
        counts.data_ptr(), shift.data_ptr(), n, u, a, tick, period,
        int(chaos), bulk_member.data_ptr(), bulk_heard.data_ptr(),
        bulk_cov.data_ptr(), sus_start.data_ptr(), sus_confirm.data_ptr(),
        0, n, _one_table(want, dead_of), 1, n, _stream(dev))
    _check(rc, "dense_expiry_post")
    LAUNCHES["dense_expiry_post"] += 1


def launch_refutation(*, incarnation, awareness, up, member, know, learn_tick,
                      sends_left, r_active, r_kind, r_subject, r_inc, r_start,
                      awareness_max: int, tick: int, tick16: int,
                      limit: int) -> None:
    """K12's refutation: live subjects that know they are suspected or
    declared dead refute, in place: incarnation, awareness (clamped for
    every node; left as it is when awareness_max is 0), the needing
    columns of know / learn_tick / sends_left and r_kind / r_inc / r_start
    at the needing slots, each only where a value changes."""
    dev = know.device if know is not None else None
    n, u = _slot_rows("refutation", know, learn_tick, sends_left, dev)
    _ticks("refutation", tick, tick16, limit)
    if not 0 <= awareness_max <= 127:
        raise ValueError(f"refutation: awareness_max {awareness_max} outside "
                         f"[0, 127]")
    _node_vectors("refutation", dev, n, (incarnation, "incarnation", _I32),
                  (awareness, "awareness", _I8), (up, "up", _BOOL),
                  (member, "member", _BOOL))
    if _rumor_table(r_active, r_kind, r_subject, dev, "refutation") != u:
        raise ValueError(f"refutation: the rumor table has "
                         f"{r_active.shape[0]} slots, know {u}")
    _node_vectors("refutation", dev, u, (r_inc, "r_inc", _I32),
                  (r_start, "r_start", _I32))
    scratch = _scratch_words(dev, "refutation", REFUTE_SCRATCH)
    rc = library().refutation(
        incarnation.data_ptr(), awareness.data_ptr(), up.data_ptr(),
        member.data_ptr(), know.data_ptr(), learn_tick.data_ptr(),
        sends_left.data_ptr(), r_active.data_ptr(), r_kind.data_ptr(),
        r_subject.data_ptr(), r_inc.data_ptr(), r_start.data_ptr(), n, u,
        awareness_max, tick, tick16, limit, scratch.data_ptr(), 0, 0, n,
        _one_table(know, up, member, incarnation), 1, n, _stream(dev))
    _check(rc, "refutation")
    LAUNCHES["refutation"] += 1


def launch_expire(*, know, sends_left, up, member, committed_dead,
                  committed_left, committed_inc, r_active, r_kind, r_subject,
                  r_inc, r_start, r_coverage, tick: int, life_gossip: int,
                  life_suspect: int) -> None:
    """K12's expire (one cooperative launch: count, grid barrier, decision,
    apply): slots past their dissemination window (`life_suspect` ticks
    for suspect rumors, `life_gossip` for the others) free at 99.5% live
    coverage or four windows, committing their belief at 50%.  Updates
    know / sends_left in the done columns, the committed leaves at the
    committing subjects (and node 0), r_active and r_coverage in place,
    each only where a value changes."""
    dev = know.device if know is not None else None
    if know is None or know.dim() != 2:
        raise ValueError("expire: know must be [N, U]")
    n, u = know.shape
    if not 1 <= n < 2 ** 31 or not 1 <= u <= 64:
        raise ValueError(f"expire: N={n} must lie in [1, 2^31) and U={u} in "
                         f"[1, 64]")
    _ticks("expire", tick)
    if not 0 <= life_gossip < 2 ** 29 or not 0 <= life_suspect < 2 ** 29:
        raise ValueError(f"expire: windows {life_gossip}, {life_suspect} out "
                         f"of range")
    for t, what, dt in ((know, "know", _BOOL),
                        (sends_left, "sends_left", _I8)):
        _require(t, "expire " + what, dt, dev, (n, u))
    _node_vectors("expire", dev, n, (up, "up", _BOOL),
                  (member, "member", _BOOL),
                  (committed_dead, "committed_dead", _BOOL),
                  (committed_left, "committed_left", _BOOL),
                  (committed_inc, "committed_inc", _I32))
    if _rumor_table(r_active, r_kind, r_subject, dev, "expire") != u:
        raise ValueError(f"expire: the rumor table has {r_active.shape[0]} "
                         f"slots, know {u}")
    _node_vectors("expire", dev, u, (r_inc, "r_inc", _I32),
                  (r_start, "r_start", _I32),
                  (r_coverage, "r_coverage", _F))
    scratch = _scratch_words(dev, "expire", EXPIRE_SCRATCH)
    rc = library().expire(
        know.data_ptr(), sends_left.data_ptr(), up.data_ptr(),
        member.data_ptr(), committed_dead.data_ptr(),
        committed_left.data_ptr(), committed_inc.data_ptr(),
        r_active.data_ptr(), r_kind.data_ptr(), r_subject.data_ptr(),
        r_inc.data_ptr(), r_start.data_ptr(), r_coverage.data_ptr(), n, u,
        tick, life_gossip, life_suspect, scratch.data_ptr(), 0, 0, n,
        _one_table(committed_dead, committed_left, committed_inc), 1, n, None,
        None, _stream(dev))
    _check(rc, "expire")
    LAUNCHES["expire"] += 1


VIVALDI_MAX_DIMS = 16      # vivaldi.cu's kMaxD
VIVALDI_MAX_WINDOW = 32    # vivaldi.cu's kMaxW
BULK_MAX_VIEWS = 16        # bulk.cu's kMaxViews
BULK_RESULTS = 5           # bulk.cu's kResults: each block's partial sums


def launch_vivaldi_ring(*, coords, height, error, window, rtt_ms, acked,
                        shift, col: int, key, normal_lo: float,
                        normal_span: float, ce: float, cc: float,
                        error_max: float, height_min: float, inv_rho: float,
                        mean_factor: float, coords_out, height_out,
                        error_out, adjustment) -> None:
    """K13: one observe_ring of the pool against the ring peers (i +
    shift) % N, `shift` one int32 read on the device, rtt_ms [N] float32
    milliseconds, acked [N] bool; the colocated rows' spring directions
    are normal draws of `key` (two uint32 words), scaled from (lo, span);
    gravity multiplies |c| by inv_rho, the mean the window sum by
    mean_factor.  Writes coords_out, height_out, error_out and adjustment
    [N] whole and the window's column `col` in place on acked rows."""
    dev = coords.device if coords is not None else None
    if coords is None or coords.dim() != 2 or window is None \
            or window.dim() != 2:
        raise ValueError("vivaldi_ring: coords must be [N, D] and the "
                         "window [N, W]")
    n, d = coords.shape
    w = window.shape[1]
    if not 1 <= n < 2 ** 31 or not 1 <= d <= VIVALDI_MAX_DIMS \
            or not 1 <= w <= VIVALDI_MAX_WINDOW:
        raise ValueError(f"vivaldi_ring: N={n}, D={d} and W={w} must lie in "
                         f"[1, 2^31), [1, {VIVALDI_MAX_DIMS}] and [1, "
                         f"{VIVALDI_MAX_WINDOW}]")
    if not 0 <= col < w:
        raise ValueError(f"vivaldi_ring: column {col} outside [0, {w})")
    for t, what, shape in ((coords, "coords", (n, d)),
                           (coords_out, "coords_out", (n, d)),
                           (window, "window", (n, w))):
        _require(t, "vivaldi_ring " + what, _F, dev, shape)
    _node_vectors("vivaldi_ring", dev, n, (height, "height", _F),
                  (error, "error", _F), (rtt_ms, "rtt_ms", _F),
                  (acked, "acked", _BOOL), (height_out, "height_out", _F),
                  (error_out, "error_out", _F),
                  (adjustment, "adjustment", _F))
    _shift("vivaldi_ring", shift, dev)
    k0, k1 = (int(x) & 0xFFFFFFFF for x in key)
    rc = library().vivaldi_ring(
        coords.data_ptr(), height.data_ptr(), error.data_ptr(),
        window.data_ptr(), rtt_ms.data_ptr(), acked.data_ptr(),
        shift.data_ptr(), n, d, w, col, k0, k1, normal_lo, normal_span, ce,
        cc, error_max, height_min, inv_rho, mean_factor,
        coords_out.data_ptr(), height_out.data_ptr(), error_out.data_ptr(),
        adjustment.data_ptr(), 0, n, _one_table(coords, height, error), 1, n,
        _stream(dev))
    _check(rc, "vivaldi_ring")
    LAUNCHES["vivaldi_ring"] += 1


def _bulk_carry(device: torch.device, n: int) -> torch.Tensor:
    """K14's per-device float carry of at least n rows, made once and
    grown with n (the kernel overwrites what it reads)."""
    buf = _scratch.get((device, "bulk_step carry"))
    if buf is None or buf.numel() < n:
        buf = torch.empty(n, dtype=_F, device=device)
        _scratch[(device, "bulk_step carry")] = buf
    return buf


def launch_bulk_step(*, bulk_member, bulk_heard, bulk_cov, up, member,
                     committed_dead, offsets: DrawSpec, group=None,
                     node_ok=None, cap: float, p_ok: float) -> None:
    """K14 (one cooperative launch): the bulk death channel one gossip
    tick along the G ring offsets the kernel draws from `offsets` (a
    randint DrawSpec with no output, n = G), then its commit, in place on
    bulk_member, bulk_heard, bulk_cov and committed_dead [N], each only
    where a value changes; with no bulk member nothing is written.  The
    nemesis build passes group [N] int16 and node_ok [N] float32 together.
    Its sums and the heard' carry live in per-device scratch, so two
    streams must not run it at once."""
    dev = bulk_member.device if bulk_member is not None else None
    n = _node_count("bulk_step", bulk_member)
    if not isinstance(offsets, DrawSpec) \
            or offsets.mode != DRAW_MODES.index("randint") \
            or not 1 <= offsets.n <= BULK_MAX_VIEWS or offsets.range < 1:
        g = getattr(offsets, "n", None)
        raise ValueError(f"bulk_step takes a randint DrawSpec of 1-"
                         f"{BULK_MAX_VIEWS} ring offsets, got {g}")
    _node_vectors("bulk_step", dev, n, (bulk_member, "bulk_member", _BOOL),
                  (bulk_heard, "bulk_heard", _F), (bulk_cov, "bulk_cov", _F),
                  (up, "up", _BOOL), (member, "member", _BOOL),
                  (committed_dead, "committed_dead", _BOOL))
    if (group is None) != (node_ok is None):
        raise ValueError("bulk_step: group and node_ok come together")
    if group is not None:
        _node_vectors("bulk_step", dev, n, (group, "group", _I16),
                      (node_ok, "node_ok", _F))
    partials = _scratch_words(dev, "bulk_step", BULK_RESULTS * SCRATCH_BLOCKS)
    carry = _bulk_carry(dev, n)
    rc = library().bulk_step(
        bulk_member.data_ptr(), bulk_heard.data_ptr(), bulk_cov.data_ptr(),
        up.data_ptr(), member.data_ptr(), committed_dead.data_ptr(),
        ctypes.addressof(offsets), _ptr(group), _ptr(node_ok), n, cap, p_ok,
        partials.data_ptr(), SCRATCH_BLOCKS, carry.data_ptr(), _stream(dev))
    _check(rc, "bulk_step")
    LAUNCHES["bulk_step"] += 1


# --------------------------------------------------------------------------
# the block forms of the probe tick's kernels (K7-K13) over a node-sharded
# pool: a launch a block over its rows on its device, the leaves read or
# written at another row through block tables, and a combine launch on
# the mesh's first device where the one-device kernel has a grid-wide
# step.  [N] and [N, W] leaves are parallel/mesh.Blocks, the [U] table,
# the timeout table and the counters Replicated (the combine writes the
# first device's copy; the others are copied from it), the small outputs
# on the first device.

MAX_BLOCKS = 16                  # common.cuh's kMaxBlocks
PROBE_PART = PROBE_COUNTERS + 1  # probe.cu's kPart
ORIGINATE_PART = 130             # originate.cu's kPartWords
ORIGINATE_PLAN_WORDS = 66        # originate.cu's kPlanWords
EXPIRE_PART = 65                 # refute.cu's kExpirePart
# the modes of the kernels with a block form (the csrc enums)
_ORIG = {"select": 1, "cover": 2, "combine": 3, "seed": 4}
_EXPIRY = {"scan": 1, "combine": 2, "apply": 3}
_DENSE = {"block": 1, "combine": 2}
_REFUTE = {"block": 1, "combine": 2}
_EXPIRE = {"combine": 2, "count": 3, "clear": 4}
# the block forms' launches (each counted once a launch)
BLOCK_FORMS = ("subject_maps_blocks", "map_add_blocks", "maps_convert_blocks",
               "probe_round_blocks", "probe_combine", "originate_blocks",
               "originate_combine", "suspicion_expiry_blocks",
               "suspicion_expiry_combine", "dense_expiry_blocks",
               "dense_expiry_combine", "dense_expiry_post_blocks",
               "refutation_blocks", "refutation_combine", "expire_blocks",
               "expire_combine", "vivaldi_ring_blocks",
               "threefry_draws_blocks")
KERNELS = KERNELS + BLOCK_FORMS
for _name in BLOCK_FORMS:
    LAUNCHES[_name] = 0


class _Blocked:
    """The blocks of one block-form call: B blocks of L rows of an N-node
    pool on `devs`, the first the home of the combine and the outputs."""

    def __init__(self, name: str, like):
        self.name = name
        if getattr(like, "parts", None) is None:
            raise ValueError(f"{name}: want a parallel/mesh.Blocks leaf")
        self.nb, self.ell = like.n_blocks, like.rows
        self.n = self.nb * self.ell
        if not 1 <= self.nb <= MAX_BLOCKS or not 1 <= self.n < 2 ** 31:
            raise ValueError(f"{name}: {self.nb} blocks of {self.ell} rows, "
                             f"want 1-{MAX_BLOCKS} blocks and N < 2^31")
        self.devs = like.devices
        self.home = self.devs[0]
        enable_peer_access(self.devs)

    def rows(self, x, what: str, dtype, width=None, optional=False):
        """x's B blocks, each [L] (or [L, width]) of dtype on its device."""
        if x is None and optional:
            return [None] * self.nb
        parts = _parts(x, self.nb, f"{self.name} {what}")
        shape = (self.ell,) if width is None else (self.ell, width)
        for p, d in zip(parts, self.devs):
            _require(p, f"{self.name} {what}", dtype, d, shape)
        return parts

    def copies(self, x, what: str, dtype, shape):
        """x's copy on each block's device (a Replicated leaf or a tensor
        on the first device)."""
        out = [_copy_on(x, d, f"{self.name} {what}") for d in self.devs]
        for c, d in zip(out, self.devs):
            if isinstance(x, torch.Tensor):
                d = self.home
            _require(c, f"{self.name} {what}", dtype, d, shape)
        return out

    def home_copy(self, x):
        return x if isinstance(x, torch.Tensor) else x.on(self.home)

    def tables(self, *leaves) -> ctypes.Array:
        """The host table array: each leaf's B block pointers in turn (a
        None leaf: B nulls)."""
        ptrs = []
        for parts in leaves:
            ptrs.extend([_ptr(p) for p in parts] if parts is not None
                        else [None] * self.nb)
        return (_P * len(ptrs))(*ptrs)

    def each(self, kernel: str, count: str, call) -> None:
        """call(b, device, stream) for every block, each on its device."""
        fn = getattr(library(), kernel)
        for b, d in enumerate(self.devs):
            with _on(d):
                rc = fn(*call(b, d), _stream(d))
            _check(rc, kernel)
            LAUNCHES[count] += 1

    def once(self, kernel: str, count: str, args) -> None:
        """One launch on the first device."""
        with _on(self.home):
            rc = getattr(library(), kernel)(*args, _stream(self.home))
        _check(rc, kernel)
        LAUNCHES[count] += 1

    def join(self) -> None:
        from consul_tpu_torch.parallel import mesh
        mesh.join(self.devs)

    def spread(self, *leaves) -> None:
        """The first device's copy of each Replicated leaf copied into its
        other copies (after a combine wrote it)."""
        self.join()
        for x in leaves:
            for c in getattr(x, "copies", ())[1:]:
                c.copy_(x.copies[0])
        self.join()


def launch_subject_maps_blocks(r_active, r_kind, r_subject, r_inc,
                               maps) -> None:
    """K9's build over blocks: maps is the four [N] int32 maps as Blocks
    (suspect_of, dead_of, left_of, alive_val), each block's rows written
    whole by a launch on its device from its copy of the table."""
    m = _Blocked("subject_maps", maps[0])
    rows = [m.rows(x, f"map {i}", _I32) for i, x in enumerate(maps)]
    u = r_active.shape[0]
    tab = [m.copies(x, w, dt, (u,)) for x, w, dt in (
        (r_active, "r_active", _BOOL), (r_kind, "r_kind", _I8),
        (r_subject, "r_subject", _I32), (r_inc, "r_inc", _I32))]
    m.each("subject_maps", "subject_maps_blocks", lambda b, d: (
        *[t[b].data_ptr() for t in tab], m.n, u, b * m.ell, m.ell,
        *[r[b].data_ptr() for r in rows]))


def launch_map_add_blocks(map_n, subjects, slots, ok) -> None:
    """K9's map_add over blocks, in place: each block applies the pairs
    whose subject it holds (the masked pairs' -1: block 0's row 0).  The
    pairs are [A] tensors on the first device."""
    m = _Blocked("map_add", map_n)
    rows = m.rows(map_n, "map", _I32)
    a = subjects.shape[0]
    for t, w, dt in ((subjects, "subjects", _I32), (slots, "slots", _I32),
                     (ok, "ok", _BOOL)):
        _require(t, "map_add " + w, dt, m.home, (a,))
    m.each("map_add", "map_add_blocks", lambda b, d: (
        rows[b].data_ptr(), subjects.data_ptr(), slots.data_ptr(),
        ok.data_ptr(), m.n, a, b * m.ell, m.ell))


def launch_maps_convert_blocks(suspect_of, dead_of, convert,
                               r_subject) -> None:
    """K9's maps_convert over blocks, in place (convert [U] on the first
    device)."""
    m = _Blocked("maps_convert", suspect_of)
    sus = m.rows(suspect_of, "suspect_of", _I32)
    dead = m.rows(dead_of, "dead_of", _I32)
    u = convert.shape[0]
    _require(convert, "maps_convert convert", _BOOL, m.home, (u,))
    subj = m.home_copy(r_subject)
    m.each("maps_convert", "maps_convert_blocks", lambda b, d: (
        sus[b].data_ptr(), dead[b].data_ptr(), convert.data_ptr(),
        subj.data_ptr(), m.n, u, b * m.ell, m.ell))


def launch_probe_round_blocks(*, up, member, awareness, coords,
                              committed_dead, committed_left, committed_inc,
                              bulk_member, know, learn_tick, sends_left,
                              sus_start, sus_confirm, sus_count, chaos_grp,
                              chaos_ok, r_active, r_kind, r_subject, r_inc,
                              r_confirm, timeouts, suspect_of, dead_of,
                              left_of, alive_val, ctr, offs, rtt_draw, direct,
                              lha, leg_a, leg_b, leg_c, awareness_max: int,
                              degraded: bool, seed: int, ok_good: float,
                              ok_bad: float, degraded_frac: float,
                              probe_timeout_ms: float, rtt_base_ms: float,
                              tick: int, tick16: int, limit: int, want_out,
                              row_subject_out, rtt_out, acked_out) -> None:
    """K7 over blocks (launch_probe_round's arguments, the [N] and [N, W]
    ones Blocks, the tables, offs and ctr Replicated): a probe_round
    launch a block over its rows, the targets' and relays' leaves read and
    the targets' timers and want written through block tables, each
    launch's counters and slot marks into its own partial slot; then one
    probe_combine on the first device (r_confirm and ctr), copied to the
    other devices."""
    m = _Blocked("probe_round", know)
    u = know.shape[1]
    k = offs.shape[0] - 1
    if not 0 <= k <= PROBE_MAX_RELAYS or not 0 <= awareness_max <= 127:
        raise ValueError(f"probe_round: {k} relays, awareness_max "
                         f"{awareness_max}")
    _ticks("probe_round", tick, tick16, limit)
    c = ctr.shape[0]
    if not PROBE_COUNTERS <= c <= 16:
        raise ValueError("probe_round: ctr must be [C], 4 <= C <= 16")
    r = {w: m.rows(x, w, dt, width, opt) for w, x, dt, width, opt in (
        ("up", up, _BOOL, None, False), ("member", member, _BOOL, None, False),
        ("awareness", awareness, _I8, None, False),
        ("coords", coords, _F, 2, False),
        ("committed_dead", committed_dead, _BOOL, None, False),
        ("committed_left", committed_left, _BOOL, None, False),
        ("committed_inc", committed_inc, _I32, None, False),
        ("bulk_member", bulk_member, _BOOL, None, False),
        ("know", know, _BOOL, u, False), ("learn_tick", learn_tick, _I16, u,
                                          False),
        ("sends_left", sends_left, _I8, u, False),
        ("sus_start", sus_start, _I32, None, False),
        ("sus_confirm", sus_confirm, _I8, None, False),
        ("sus_count", sus_count, _I32, None, False),
        ("chaos_grp", chaos_grp, _I16, None, True),
        ("chaos_ok", chaos_ok, _F, None, True),
        ("suspect_of", suspect_of, _I32, None, False),
        ("dead_of", dead_of, _I32, None, False),
        ("left_of", left_of, _I32, None, False),
        ("alive_val", alive_val, _I32, None, False),
        ("rtt_draw", rtt_draw, _F, None, False),
        ("direct", direct, _F, None, False), ("lha", lha, _F, None, True),
        ("leg_a", leg_a, _F, k, True), ("leg_b", leg_b, _F, k, True),
        ("leg_c", leg_c, _F, k, True),
        ("want_out", want_out, _I32, None, False),
        ("row_subject_out", row_subject_out, _I32, None, False),
        ("rtt_out", rtt_out, _F, None, False),
        ("acked_out", acked_out, _BOOL, None, False))}
    if (chaos_grp is None) != (chaos_ok is None) \
            or (awareness_max > 0) != (lha is not None) \
            or any((x is None) != (k == 0) for x in (leg_a, leg_b, leg_c)):
        raise ValueError("probe_round: chaos_grp/chaos_ok, lha and the legs "
                         "come as the one-device launch takes them")
    tab = {w: m.copies(x, w, dt, shape) for w, x, dt, shape in (
        ("r_active", r_active, _BOOL, (u,)), ("r_kind", r_kind, _I8, (u,)),
        ("r_subject", r_subject, _I32, (u,)), ("r_inc", r_inc, _I32, (u,)),
        ("r_confirm", r_confirm, _I8, (u,)),
        ("timeouts", timeouts, _I16, (TIMEOUTS,)),
        ("offs", offs, _I32, (k + 1,)), ("ctr", ctr, _F, (c,)))}
    tables = m.tables(*[r[w] for w in (
        "up", "member", "committed_dead", "committed_left", "committed_inc",
        "bulk_member", "suspect_of", "dead_of", "left_of", "alive_val",
        "coords")], r["chaos_grp"] if chaos_grp is not None else None,
        r["chaos_ok"] if chaos_ok is not None else None,
        r["sus_start"], r["sus_confirm"], r["sus_count"], r["want_out"])
    part = torch.empty(PROBE_PART * m.nb, dtype=torch.int64, device=m.home)
    chaos = int(chaos_grp is not None)

    def call(b, d):
        p = {w: _ptr(v[b]) for w, v in r.items()}
        t = {w: v[b].data_ptr() for w, v in tab.items()}
        return (p["up"], p["member"], p["awareness"], p["coords"],
                p["committed_dead"], p["committed_left"], p["committed_inc"],
                p["bulk_member"], p["know"], p["learn_tick"], p["sends_left"],
                p["sus_start"], p["sus_confirm"], p["sus_count"],
                p["chaos_grp"], p["chaos_ok"], t["r_active"], t["r_kind"],
                t["r_subject"], t["r_inc"], t["r_confirm"], t["timeouts"],
                p["suspect_of"], p["dead_of"], p["left_of"], p["alive_val"],
                t["ctr"], t["offs"], p["rtt_draw"], p["direct"], p["lha"],
                p["leg_a"], p["leg_b"], p["leg_c"], m.n, u, k, awareness_max,
                chaos, int(degraded), c, seed & 0xFFFFFFFF, ok_good, ok_bad,
                degraded_frac, probe_timeout_ms, rtt_base_ms, tick, tick16,
                limit,
                _counter_scratch(d, "probe_round", PROBE_COUNTERS,
                                 extra=64).data_ptr(),
                SCRATCH_BLOCKS, p["want_out"], p["row_subject_out"],
                p["rtt_out"], p["acked_out"], b * m.ell, m.ell, tables,
                m.nb, m.ell, part.data_ptr() + 8 * PROBE_PART * b)

    m.each("probe_round", "probe_round_blocks", call)
    m.join()
    m.once("probe_combine", "probe_combine", (
        part.data_ptr(), m.nb, u, c, m.home_copy(r_confirm).data_ptr(),
        m.home_copy(ctr).data_ptr()))
    m.spread(r_confirm, ctr)


def launch_originate_blocks(*, want, row_subject, inc_of_subject, up, member,
                            know, learn_tick, sends_left, committed_dead,
                            committed_left, committed_inc, r_active, r_kind,
                            r_subject, r_inc, r_start, r_confirm, r_coverage,
                            alloc: int, kind: int, tick: int, tick16: int,
                            limit: int, subjects_out, slots_out,
                            ok_out) -> None:
    """K8 over blocks (launch_originate's arguments, the [N] and [N, U]
    ones Blocks, the table Replicated, the outputs on the first device): a
    select launch a block (its top `alloc` wants and demand into its
    slot), a cover launch a block (its live counts, only when the blocks'
    demand exceeds the free slots), one combine on the first device (the
    top of the blocks' candidates, the decision, the table and the
    committed cells through tables, the plan), the table copied to the
    other devices, and a seed launch a block."""
    m = _Blocked("originate", know)
    u = know.shape[1]
    if not 1 <= alloc <= min(u, m.n):
        raise ValueError(f"originate: alloc {alloc} outside [1, min(U, N)]")
    if not 0 <= kind <= 3:
        raise ValueError(f"originate: kind {kind}")
    _ticks("originate", tick, tick16, limit)
    r = {w: m.rows(x, w, dt, width) for w, x, dt, width in (
        ("want", want, _I32, None), ("row_subject", row_subject, _I32, None),
        ("inc_of_subject", inc_of_subject, _I32, None),
        ("up", up, _BOOL, None), ("member", member, _BOOL, None),
        ("know", know, _BOOL, u), ("learn_tick", learn_tick, _I16, u),
        ("sends_left", sends_left, _I8, u),
        ("committed_dead", committed_dead, _BOOL, None),
        ("committed_left", committed_left, _BOOL, None),
        ("committed_inc", committed_inc, _I32, None))}
    names = ("r_active", "r_kind", "r_subject", "r_inc", "r_start",
             "r_confirm", "r_coverage")
    leaves = (r_active, r_kind, r_subject, r_inc, r_start, r_confirm,
              r_coverage)
    tab = {w: m.copies(x, w, dt, (u,)) for w, x, dt in zip(
        names, leaves, (_BOOL, _I8, _I32, _I32, _I32, _I8, _F))}
    for t, w, dt in ((subjects_out, "subjects_out", _I32),
                     (slots_out, "slots_out", _I32), (ok_out, "ok_out", _BOOL)):
        _require(t, "originate " + w, dt, m.home, (alloc,))
    tables = m.tables(r["inc_of_subject"], r["committed_dead"],
                      r["committed_left"], r["committed_inc"])
    buf = torch.empty(ORIGINATE_PART * m.nb + ORIGINATE_PLAN_WORDS,
                      dtype=torch.int64, device=m.home)
    plan = buf.data_ptr() + 8 * ORIGINATE_PART * m.nb

    def args(b, d, mode):
        p = {w: v[b].data_ptr() for w, v in r.items()}
        t = {w: v[b].data_ptr() for w, v in tab.items()}
        return (p["want"], p["row_subject"], p["inc_of_subject"], p["up"],
                p["member"], p["know"], p["learn_tick"], p["sends_left"],
                p["committed_dead"], p["committed_left"], p["committed_inc"],
                *[t[w] for w in names], m.n, u, alloc, kind, tick, tick16,
                limit,
                _scratch_words(d, "originate", ORIGINATE_PLAN
                               + 64 * ORIGINATE_LIST_BLOCKS).data_ptr(),
                ORIGINATE_LIST_BLOCKS, subjects_out.data_ptr(),
                slots_out.data_ptr(), ok_out.data_ptr(), _ORIG[mode],
                b * m.ell, m.ell, tables, m.nb, m.ell, b, buf.data_ptr(),
                plan)

    m.each("originate", "originate_blocks", lambda b, d: args(b, d, "select"))
    m.join()
    m.each("originate", "originate_blocks", lambda b, d: args(b, d, "cover"))
    m.join()
    m.once("originate", "originate_combine", args(0, m.home, "combine"))
    m.spread(*leaves)
    m.each("originate", "originate_blocks", lambda b, d: args(b, d, "seed"))


def launch_suspicion_expiry_blocks(*, know, learn_tick, sends_left, up,
                                   member, committed_dead, committed_inc,
                                   r_active, r_kind, r_subject, r_inc, r_start,
                                   r_confirm, timeouts, tick: int, tick16: int,
                                   limit: int, convert_out) -> None:
    """K10 over blocks: a scan launch a block (its expired-slot word), one
    combine on the first device (the decision: convert_out, the
    converted slots' kind and start, the plan word; the subjects'
    committed cells through tables), the table copied, an apply launch a
    block."""
    m = _Blocked("suspicion_expiry", know)
    u = know.shape[1]
    _ticks("suspicion_expiry", tick, tick16, limit)
    r = {w: m.rows(x, w, dt, width) for w, x, dt, width in (
        ("know", know, _BOOL, u), ("learn_tick", learn_tick, _I16, u),
        ("sends_left", sends_left, _I8, u), ("up", up, _BOOL, None),
        ("member", member, _BOOL, None),
        ("committed_dead", committed_dead, _BOOL, None),
        ("committed_inc", committed_inc, _I32, None))}
    names = ("r_active", "r_kind", "r_subject", "r_inc", "r_start",
             "r_confirm", "timeouts")
    tab = {w: m.copies(x, w, dt, shape) for w, x, dt, shape in zip(
        names, (r_active, r_kind, r_subject, r_inc, r_start, r_confirm,
                timeouts), (_BOOL, _I8, _I32, _I32, _I32, _I8, _I16),
        ((u,),) * 6 + ((TIMEOUTS,),))}
    _require(convert_out, "suspicion_expiry convert_out", _BOOL, m.home, (u,))
    tables = m.tables(r["committed_inc"], r["committed_dead"])
    buf = torch.empty(m.nb + 1, dtype=torch.int64, device=m.home)

    def args(b, d, mode):
        p = {w: v[b].data_ptr() for w, v in r.items()}
        t = {w: v[b].data_ptr() for w, v in tab.items()}
        return (p["know"], p["learn_tick"], p["sends_left"], p["up"],
                p["member"], p["committed_dead"], p["committed_inc"],
                *[t[w] for w in names], m.n, u, tick, tick16, limit,
                _scratch_words(d, "suspicion_expiry",
                               EXPIRY_SCRATCH).data_ptr(),
                convert_out.data_ptr(), _EXPIRY[mode], b * m.ell, m.ell,
                tables, m.nb, m.ell,
                buf.data_ptr() + (0 if mode == "combine" else 8 * b),
                buf.data_ptr() + 8 * m.nb)

    m.each("suspicion_expiry", "suspicion_expiry_blocks",
           lambda b, d: args(b, d, "scan"))
    m.join()
    m.once("suspicion_expiry", "suspicion_expiry_combine",
           args(0, m.home, "combine"))
    m.spread(r_kind, r_start)
    m.each("suspicion_expiry", "suspicion_expiry_blocks",
           lambda b, d: args(b, d, "apply"))


def launch_dense_expiry_blocks(*, sus_start, sus_confirm, up, member,
                               committed_dead, bulk_member, suspect_of,
                               dead_of, left_of, know, learn_tick, sends_left,
                               r_active, r_kind, r_subject, r_start, timeouts,
                               shift, tick: int, tick16: int, limit: int,
                               period: int, exp_out, want_out,
                               row_subject_out, counts_out) -> None:
    """K11's pre over blocks: a launch a block (the wants at each prober's
    target written through a table, the learn-tick stamps of its rows, its
    sums into its slot), then one dense combine on the first device (the
    sums added in block order into counts_out, exp_out, the converted
    slots' kind and start), the table copied.  shift, exp_out and
    counts_out on the first device."""
    m = _Blocked("dense_expiry", know)
    u = know.shape[1]
    _ticks("dense_expiry", tick, tick16, limit)
    r = {w: m.rows(x, w, dt, width) for w, x, dt, width in (
        ("sus_start", sus_start, _I32, None),
        ("sus_confirm", sus_confirm, _I8, None), ("up", up, _BOOL, None),
        ("member", member, _BOOL, None),
        ("committed_dead", committed_dead, _BOOL, None),
        ("bulk_member", bulk_member, _BOOL, None),
        ("suspect_of", suspect_of, _I32, None),
        ("dead_of", dead_of, _I32, None), ("left_of", left_of, _I32, None),
        ("know", know, _BOOL, u), ("learn_tick", learn_tick, _I16, u),
        ("sends_left", sends_left, _I8, u),
        ("want_out", want_out, _I32, None),
        ("row_subject_out", row_subject_out, _I32, None))}
    names = ("r_active", "r_kind", "r_subject", "r_start", "timeouts")
    tab = {w: m.copies(x, w, dt, shape) for w, x, dt, shape in zip(
        names, (r_active, r_kind, r_subject, r_start, timeouts),
        (_BOOL, _I8, _I32, _I32, _I32), ((u,),) * 4 + ((TIMEOUTS,),))}
    _shift("dense_expiry", shift, m.home)
    _require(exp_out, "dense_expiry exp_out", _BOOL, m.home, (u,))
    _require(counts_out, "dense_expiry counts_out", torch.int64, m.home,
             (DENSE_COUNTS,))
    tables = m.tables(*[r[w] for w in (
        "up", "member", "committed_dead", "bulk_member", "left_of",
        "sus_start", "sus_confirm", "suspect_of", "dead_of", "want_out")])
    part = torch.empty(DENSE_COUNTS * m.nb, dtype=torch.int64, device=m.home)

    def args(b, d, mode):
        p = {w: v[b].data_ptr() for w, v in r.items()}
        t = {w: v[b].data_ptr() for w, v in tab.items()}
        return (p["sus_start"], p["sus_confirm"], p["up"], p["member"],
                p["committed_dead"], p["bulk_member"], p["suspect_of"],
                p["dead_of"], p["left_of"], p["know"], p["learn_tick"],
                p["sends_left"], t["r_active"], t["r_kind"], t["r_subject"],
                t["r_start"], t["timeouts"], shift.data_ptr(), m.n, u, tick,
                tick16, limit, period,
                _counter_scratch(d, "dense_expiry",
                                 DENSE_COUNTS).data_ptr(),
                SCRATCH_BLOCKS, exp_out.data_ptr(), p["want_out"],
                p["row_subject_out"], counts_out.data_ptr(), _DENSE[mode],
                b * m.ell, m.ell, tables, m.nb, m.ell,
                part.data_ptr() + (0 if mode == "combine"
                                   else 8 * DENSE_COUNTS * b))

    m.each("dense_expiry", "dense_expiry_blocks",
           lambda b, d: args(b, d, "block"))
    m.join()
    m.once("dense_expiry", "dense_expiry_combine", args(0, m.home, "combine"))
    m.spread(r_kind, r_start)


def launch_dense_expiry_post_blocks(*, want, dead_of, left_of, exp,
                                    r_subject, subjects, slots, ok, up,
                                    member, committed_dead, committed_left,
                                    counts, shift, tick: int, period: int,
                                    chaos: bool, bulk_member, bulk_heard,
                                    bulk_cov, sus_start,
                                    sus_confirm) -> None:
    """K11's post over blocks: a launch a block, want and dead_of at the
    ring peer read through tables; exp, r_subject, the origination's
    pairs, counts and shift on the first device."""
    m = _Blocked("dense_expiry_post", want)
    u, a = exp.shape[0], subjects.shape[0]
    r = {w: m.rows(x, w, dt) for w, x, dt in (
        ("want", want, _I32), ("dead_of", dead_of, _I32),
        ("left_of", left_of, _I32), ("up", up, _BOOL),
        ("member", member, _BOOL), ("committed_dead", committed_dead, _BOOL),
        ("committed_left", committed_left, _BOOL),
        ("bulk_member", bulk_member, _BOOL), ("bulk_heard", bulk_heard, _F),
        ("bulk_cov", bulk_cov, _F), ("sus_start", sus_start, _I32),
        ("sus_confirm", sus_confirm, _I8))}
    for t, w, dt, shape in ((exp, "exp", _BOOL, (u,)),
                            (r_subject, "r_subject", _I32, (u,)),
                            (subjects, "subjects", _I32, (a,)),
                            (slots, "slots", _I32, (a,)), (ok, "ok", _BOOL, (a,)),
                            (counts, "counts", torch.int64, (DENSE_COUNTS,))):
        _require(t, "dense_expiry_post " + w, dt, m.home, shape)
    _shift("dense_expiry_post", shift, m.home)
    tables = m.tables(r["want"], r["dead_of"])

    def call(b, d):
        p = {w: v[b].data_ptr() for w, v in r.items()}
        return (p["want"], p["dead_of"], p["left_of"], exp.data_ptr(),
                r_subject.data_ptr(), subjects.data_ptr(), slots.data_ptr(),
                ok.data_ptr(), p["up"], p["member"], p["committed_dead"],
                p["committed_left"], counts.data_ptr(), shift.data_ptr(), m.n,
                u, a, tick, period, int(chaos), p["bulk_member"],
                p["bulk_heard"], p["bulk_cov"], p["sus_start"],
                p["sus_confirm"], b * m.ell, m.ell, tables, m.nb, m.ell)

    m.each("dense_expiry_post", "dense_expiry_post_blocks", call)


def launch_refutation_blocks(*, incarnation, awareness, up, member, know,
                             learn_tick, sends_left, r_active, r_kind,
                             r_subject, r_inc, r_start, awareness_max: int,
                             tick: int, tick16: int, limit: int) -> None:
    """K12's refutation over blocks: a launch a block (the decision from
    the subjects' cells through tables, its rows' scores and needing
    columns), then one refutation combine on the first device (the table
    and the subjects' incarnations through a writable table), the table
    copied."""
    m = _Blocked("refutation", know)
    u = know.shape[1]
    _ticks("refutation", tick, tick16, limit)
    if not 0 <= awareness_max <= 127:
        raise ValueError(f"refutation: awareness_max {awareness_max}")
    r = {w: m.rows(x, w, dt, width) for w, x, dt, width in (
        ("incarnation", incarnation, _I32, None),
        ("awareness", awareness, _I8, None), ("up", up, _BOOL, None),
        ("member", member, _BOOL, None), ("know", know, _BOOL, u),
        ("learn_tick", learn_tick, _I16, u),
        ("sends_left", sends_left, _I8, u))}
    names = ("r_active", "r_kind", "r_subject", "r_inc", "r_start")
    tab = {w: m.copies(x, w, dt, (u,)) for w, x, dt in zip(
        names, (r_active, r_kind, r_subject, r_inc, r_start),
        (_BOOL, _I8, _I32, _I32, _I32))}
    tables = m.tables(r["know"], r["up"], r["member"], r["incarnation"])

    def args(b, d, mode):
        p = {w: v[b].data_ptr() for w, v in r.items()}
        t = {w: v[b].data_ptr() for w, v in tab.items()}
        return (p["incarnation"], p["awareness"], p["up"], p["member"],
                p["know"], p["learn_tick"], p["sends_left"],
                *[t[w] for w in names], m.n, u, awareness_max, tick, tick16,
                limit,
                _scratch_words(d, "refutation", REFUTE_SCRATCH).data_ptr(),
                _REFUTE[mode], b * m.ell, m.ell, tables, m.nb, m.ell)

    m.each("refutation", "refutation_blocks", lambda b, d: args(b, d, "block"))
    m.join()
    m.once("refutation", "refutation_combine", args(0, m.home, "combine"))
    m.spread(r_kind, r_inc, r_start)


def launch_expire_blocks(*, know, sends_left, up, member, committed_dead,
                         committed_left, committed_inc, r_active, r_kind,
                         r_subject, r_inc, r_start, r_coverage, tick: int,
                         life_gossip: int, life_suspect: int) -> None:
    """K12's expire over blocks: a count launch a block (its live rows and
    per-slot live counts into its slot), one combine on the first device
    (the decision, the table, the committed cells through writable
    tables, the done word), the table copied, a clear launch a block."""
    m = _Blocked("expire", know)
    u = know.shape[1]
    _ticks("expire", tick)
    r = {w: m.rows(x, w, dt, width) for w, x, dt, width in (
        ("know", know, _BOOL, u), ("sends_left", sends_left, _I8, u),
        ("up", up, _BOOL, None), ("member", member, _BOOL, None),
        ("committed_dead", committed_dead, _BOOL, None),
        ("committed_left", committed_left, _BOOL, None),
        ("committed_inc", committed_inc, _I32, None))}
    names = ("r_active", "r_kind", "r_subject", "r_inc", "r_start",
             "r_coverage")
    tab = {w: m.copies(x, w, dt, (u,)) for w, x, dt in zip(
        names, (r_active, r_kind, r_subject, r_inc, r_start, r_coverage),
        (_BOOL, _I8, _I32, _I32, _I32, _F))}
    tables = m.tables(r["committed_dead"], r["committed_left"],
                      r["committed_inc"])
    buf = torch.empty(EXPIRE_PART * m.nb + 1, dtype=torch.int64,
                      device=m.home)

    def args(b, d, mode):
        p = {w: v[b].data_ptr() for w, v in r.items()}
        t = {w: v[b].data_ptr() for w, v in tab.items()}
        return (p["know"], p["sends_left"], p["up"], p["member"],
                p["committed_dead"], p["committed_left"], p["committed_inc"],
                *[t[w] for w in names], m.n, u, tick, life_gossip,
                life_suspect,
                _scratch_words(d, "expire", EXPIRE_SCRATCH).data_ptr(),
                _EXPIRE[mode], b * m.ell, m.ell, tables, m.nb, m.ell,
                buf.data_ptr() + (0 if mode == "combine"
                                  else 8 * EXPIRE_PART * b),
                buf.data_ptr() + 8 * EXPIRE_PART * m.nb)

    m.each("expire", "expire_blocks", lambda b, d: args(b, d, "count"))
    m.join()
    m.once("expire", "expire_combine", args(0, m.home, "combine"))
    m.spread(r_active, r_coverage)
    m.each("expire", "expire_blocks", lambda b, d: args(b, d, "clear"))


def launch_vivaldi_ring_blocks(*, coords, height, error, window, rtt_ms,
                               acked, shift, col: int, key, normal_lo: float,
                               normal_span: float, ce: float, cc: float,
                               error_max: float, height_min: float,
                               inv_rho: float, mean_factor: float,
                               coords_out, height_out, error_out,
                               adjustment) -> None:
    """K13 over blocks: a vivaldi_ring launch a block over its rows, the
    peers' coordinates, height and error read through block tables (shift
    on the first device; mean_factor the pool's float(N) / float(N * W))."""
    m = _Blocked("vivaldi_ring", height)
    d = coords.shape[1] if len(coords.shape) == 2 else 0
    w = window.shape[1] if len(window.shape) == 2 else 0
    if not 1 <= d <= VIVALDI_MAX_DIMS or not 1 <= w <= VIVALDI_MAX_WINDOW \
            or not 0 <= col < w:
        raise ValueError(f"vivaldi_ring: D={d}, W={w}, column {col}")
    r = {nm: m.rows(x, nm, _F, width) for nm, x, width in (
        ("coords", coords, d), ("height", height, None),
        ("error", error, None), ("window", window, w),
        ("rtt_ms", rtt_ms, None), ("coords_out", coords_out, d),
        ("height_out", height_out, None), ("error_out", error_out, None),
        ("adjustment", adjustment, None))}
    r["acked"] = m.rows(acked, "acked", _BOOL)
    _shift("vivaldi_ring", shift, m.home)
    tables = m.tables(r["coords"], r["height"], r["error"])
    k0, k1 = (int(x) & 0xFFFFFFFF for x in key)
    m.each("vivaldi_ring", "vivaldi_ring_blocks", lambda b, dev: (
        r["coords"][b].data_ptr(), r["height"][b].data_ptr(),
        r["error"][b].data_ptr(), r["window"][b].data_ptr(),
        r["rtt_ms"][b].data_ptr(), r["acked"][b].data_ptr(),
        shift.data_ptr(), m.n, d, w, col, k0, k1, normal_lo, normal_span, ce,
        cc, error_max, height_min, inv_rho, mean_factor,
        r["coords_out"][b].data_ptr(), r["height_out"][b].data_ptr(),
        r["error_out"][b].data_ptr(), r["adjustment"][b].data_ptr(),
        b * m.ell, m.ell, tables, m.nb, m.ell))
