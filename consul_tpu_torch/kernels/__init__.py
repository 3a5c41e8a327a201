"""ctypes bindings of the port's hand-written CUDA kernels.

The library is built from `csrc/*.cu` at first use (`build.py`) and
loaded once per process.  Each `launch_*` function checks its tensors,
launches on PyTorch's current stream, raises if the launch returned a
CUDA error, and counts the launch in `LAUNCHES` — the only place the
count moves, so a run can show that its path went through the kernel.
The public wrappers that choose between a kernel and its plain PyTorch
twin live beside the twin: `utils/prng.py` (K1), `ops/gossip.py` (K2),
`models/swim.py` (K3).  They take the twin only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from consul_tpu_torch.kernels import build

KERNELS = ("threefry_bits", "gossip_disseminate", "believed_down")
LAUNCHES = {name: 0 for name in KERNELS}

_lib = None
# per-device integer accumulators the kernels fold their counters into;
# each launch's last block zeroes them again
_scratch: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.build()))
        lib.threefry_bits.argtypes = [_U32, _U32, _I64, _I, _P, _P]
        lib.gossip_disseminate.argtypes = [_P, _P, _P, _I, _P, _P, _P, _P,
                                           _I64, _I, _I, _P, _P, _P, _P, _P, _P]
        lib.believed_down.argtypes = [_P] * 14 + [_I64, _I, _I64, _I, _P, _P, _P]
        for fn in (lib.threefry_bits, lib.gossip_disseminate, lib.believed_down):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _require(t: torch.Tensor, name: str, dtype, device) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")


def _acc(device: torch.device) -> torch.Tensor:
    buf = _scratch.get(device)
    if buf is None:
        buf = torch.zeros(8, dtype=torch.int64, device=device)
        _scratch[device] = buf
    return buf


def launch_threefry(key, n: int, mode: int, out: torch.Tensor) -> None:
    """out[i] = threefry2x32(key, (i>>32, i&M)) xor-folded (mode 0, int32
    bit pattern), or jax's uniform float32 of those bits (mode 1)."""
    want = torch.int32 if mode == 0 else torch.float32
    _require(out, "threefry_bits out", want, out.device)
    if out.numel() != n:
        raise ValueError(f"threefry_bits: out has {out.numel()} elements, "
                         f"want {n}")
    rc = library().threefry_bits(key[0], key[1], n, mode, out.data_ptr(),
                                 _stream(out.device))
    _check(rc, "threefry_bits")
    LAUNCHES["threefry_bits"] += 1


def launch_gossip(know, sends_left, offsets, sender_ok, receiver_ok,
                  slot_active, ok, limit: int, new_know, new_sends, newly,
                  counters) -> None:
    dev = know.device
    n, s = know.shape
    g = offsets.shape[0]
    if s > 64 or not 1 <= g <= 16:
        raise ValueError(f"gossip_disseminate takes at most 64 slots and 1-16 "
                         f"contacts, got {s} slots and {g} contacts")
    for t, name, dt in ((know, "know", torch.bool),
                        (sends_left, "sends_left", torch.int8),
                        (offsets, "offsets", torch.int32),
                        (sender_ok, "sender_ok", torch.bool),
                        (receiver_ok, "receiver_ok", torch.bool),
                        (slot_active, "slot_active", torch.bool),
                        (new_know, "new_know", torch.bool),
                        (new_sends, "new_sends", torch.int8),
                        (newly, "newly", torch.bool),
                        (counters, "counters", torch.float32)):
        _require(t, "gossip_disseminate " + name, dt, dev)
    if ok is not None:
        _require(ok, "gossip_disseminate ok", torch.bool, dev)
        if tuple(ok.shape) != (n, g):
            raise ValueError(f"gossip_disseminate: ok is {tuple(ok.shape)}, "
                             f"want {(n, g)}")
    if sends_left.shape != know.shape or sender_ok.shape[0] != n \
            or receiver_ok.shape[0] != n or slot_active.shape[0] != s:
        raise ValueError("gossip_disseminate: inconsistent shapes")
    rc = library().gossip_disseminate(
        know.data_ptr(), sends_left.data_ptr(), offsets.data_ptr(), g,
        sender_ok.data_ptr(), receiver_ok.data_ptr(), slot_active.data_ptr(),
        ok.data_ptr() if ok is not None else None, n, s, limit,
        new_know.data_ptr(), new_sends.data_ptr(), newly.data_ptr(),
        _acc(dev).data_ptr(), counters.data_ptr(), _stream(dev))
    _check(rc, "gossip_disseminate")
    LAUNCHES["gossip_disseminate"] += 1


def launch_believed_down(know, learn_tick, up, member, is_dl, is_s, is_a,
                         r_inc, timeout16, committed_dead, committed_left,
                         committed_inc, bulk_member, bulk_cov, subject: int,
                         tick16: int, out) -> None:
    dev = know.device
    n, u = know.shape
    if u > 64:
        raise ValueError(f"believed_down takes at most 64 slots, got {u}")
    if not 0 <= subject < n:
        raise ValueError(f"believed_down: subject {subject} outside [0, {n})")
    for t, name, dt in ((know, "know", torch.bool),
                        (learn_tick, "learn_tick", torch.int16),
                        (up, "up", torch.bool), (member, "member", torch.bool),
                        (is_dl, "is_dl", torch.bool), (is_s, "is_s", torch.bool),
                        (is_a, "is_a", torch.bool), (r_inc, "r_inc", torch.int32),
                        (timeout16, "timeout16", torch.int16),
                        (committed_dead, "committed_dead", torch.bool),
                        (committed_left, "committed_left", torch.bool),
                        (committed_inc, "committed_inc", torch.int32),
                        (bulk_member, "bulk_member", torch.bool),
                        (bulk_cov, "bulk_cov", torch.float32),
                        (out, "out", torch.float32)):
        _require(t, "believed_down " + name, dt, dev)
    if out.numel() != 1:
        raise ValueError("believed_down: out must hold one float32")
    rc = library().believed_down(
        know.data_ptr(), learn_tick.data_ptr(), up.data_ptr(),
        member.data_ptr(), is_dl.data_ptr(), is_s.data_ptr(), is_a.data_ptr(),
        r_inc.data_ptr(), timeout16.data_ptr(), committed_dead.data_ptr(),
        committed_left.data_ptr(), committed_inc.data_ptr(),
        bulk_member.data_ptr(), bulk_cov.data_ptr(), subject, tick16, n, u,
        _acc(dev).data_ptr() + 32, out.data_ptr(), _stream(dev))
    _check(rc, "believed_down")
    LAUNCHES["believed_down"] += 1
