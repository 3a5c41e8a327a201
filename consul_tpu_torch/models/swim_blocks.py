"""The probe tick of a node-sharded pool (parallel/mesh.py): the detector
passes of models/swim.py over B blocks of L rows.

Every pass of `swim.step_with_obs`'s probe tick has a form here that
works block by block and never builds a buffer of N rows: the subject
maps (K9), the probe round's draws (K1 by global element, prng.
draw_blocks), the probe round (K7), origination (K8), slot and dense
suspicion expiry (K10, K11), refutation and expire (K12), and the
metrics vector; models/vivaldi.py holds K13's.  Each has a plain twin
(`*_plain`, the CPU path) and, on the cards, a block form of its kernel:
a launch a block over that block's rows, reading other rows through
block tables (kernels/csrc/common.cuh:BlockRows, MutRows for the writes
that land in another block), and where the one-device kernel has a
grid-wide step, a combine launch on the mesh's first device that adds
the blocks' integer partials in block order and decides.  Reductions
that feed a decision are integer counts, ors and maxes, exact in any
order, so a sharded tick is bit-equal to the unsharded one.

The [U] rumor table and the counters are Replicated: every distinct
device holds a copy.  The twins update every copy alike; the kernels'
combine writes the first device's copy and the other copies are copied
from it.  Index-0 sentinels (a masked lane of a scatter lands at node
0) go to global row 0, the first block's row 0.
"""

from __future__ import annotations

import numpy as np
import torch

from consul_tpu_torch import kernels
from consul_tpu_torch.models import swim
from consul_tpu_torch.ops import rolls
from consul_tpu_torch.parallel.mesh import Blocks, Replicated
from consul_tpu_torch.utils import prng

I8, I16, I32, I64, F32 = torch.int8, torch.int16, torch.int32, torch.int64, \
    torch.float32
ALIVE, SUSPECT, DEAD, LEFT = swim.ALIVE, swim.SUSPECT, swim.DEAD, swim.LEFT


# ---------------------------------------------------------------- helpers

def _rows(x: Blocks, b: int) -> torch.Tensor:
    """The global node ids of block b's rows."""
    ell = x.rows
    return torch.arange(b * ell, (b + 1) * ell, dtype=I64,
                        device=x.parts[b].device)


def _total(parts, home) -> torch.Tensor:
    """The sum of 0-d integer tensors, in block order, on `home`."""
    tot = None
    for v in parts:
        v = v.to(home)
        tot = v if tot is None else tot + v
    return tot


def _count(x: Blocks, fn=None) -> torch.Tensor:
    """sum over blocks of fn(part).sum() (the part itself by default) as
    an int64 on the first block's device."""
    return _total(((p if fn is None else fn(p, b)).sum(dtype=I64)
                   for b, p in enumerate(x.parts)), x.device)


def _any(x: Blocks) -> torch.Tensor:
    return _count(x) > 0


def _column_counts(know: Blocks, live: Blocks) -> torch.Tensor:
    """[U] int64: the live rows that know each slot, added in block
    order."""
    return _total(((k & l[:, None]).sum(0, dtype=I64)
                   for k, l in zip(know.parts, live.parts)), know.device)


def _gather(x: Blocks, idx: torch.Tensor) -> torch.Tensor:
    """x at the [K] node ids idx as a JAX gather takes them (negative ids
    wrapped once, then clamped into [0, N)), on x's first device."""
    return swim._gather_rows(x, swim._clamped(idx.to(x.device), x.shape[0]))


def _scatter(base: Blocks, idx: torch.Tensor, val: torch.Tensor,
             reduce: str) -> Blocks:
    """swim._scatter over blocks: base.at[idx].max/min(val) with an index
    in [-N, 0) wrapped once and any other outside [0, N) dropped; each
    entry lands in the block that holds its node (index 0: the first
    block's row 0)."""
    n, ell = base.shape[0], base.rows
    idx = idx.to(I64)
    idx = torch.where(idx < 0, idx + n, idx)
    out = []
    for b, part in enumerate(base.parts):
        loc = (idx - b * ell).to(part.device)
        loc = torch.where((loc >= 0) & (loc < ell), loc, ell)
        out.append(swim._scatter(part, loc, val.to(part.device), reduce))
    return Blocks(out)


def _table_map(s, fields: dict) -> dict:
    """Replicated table leaves rebuilt copy by copy: fields maps a leaf's
    name to fn(copy of that leaf, device) -> its new copy."""
    return {f: Replicated(fn(c, c.device) for c in getattr(s, f).copies)
            for f, fn in fields.items()}


def _pull(x, d) -> Blocks:
    return rolls.pull(x, d)


def _targets(x: Blocks, d) -> Blocks:
    """The global ids (i + d) % N of each block's rows, int32."""
    n = x.shape[0]
    dd = torch.as_tensor(d, dtype=I64, device=x.device) % n
    return Blocks(((_rows(x, b) + dd.to(p.device)) % n).to(I32)
                  for b, p in enumerate(x.parts))


# ------------------------------------------------------------- K9: maps

def _subject_map(s, b: int, kind: int, values_of) -> torch.Tensor:
    """Block b's rows of swim._subject_map."""
    part = s.up.parts[b]
    dev, ell = part.device, s.up.rows
    n = s.up.shape[0]
    act, knd, subj = (getattr(s, f).on(dev) for f in
                      ("r_active", "r_kind", "r_subject"))
    mask = act & (knd == kind)
    idx = torch.where(mask, subj, 0).to(I64)
    idx = torch.where(idx < 0, idx + n, idx) - b * ell
    idx = torch.where((idx >= 0) & (idx < ell), idx, ell)
    val = torch.where(mask, values_of(dev).to(I32), -1)
    base = torch.full((ell,), -1, dtype=I32, device=dev)
    return swim._scatter(base, idx, val, "amax")


def maps_plain(params, s):
    """The plain twin of K9's build over blocks: the four maps as Blocks
    (each block fills the subjects in its own rows from the table)."""
    u = params.rumor_slots

    def slots(dev):
        return torch.arange(u, dtype=I32, device=dev)

    def alive(dev):
        return s.r_inc.on(dev) * u + slots(dev)

    nb = s.up.n_blocks
    return tuple(Blocks(_subject_map(s, b, kind, fn) for b in range(nb))
                 for kind, fn in ((SUSPECT, slots), (DEAD, slots),
                                  (LEFT, slots), (ALIVE, alive)))


def map_add_plain(map_n: Blocks, subjects, slots, ok) -> Blocks:
    """K9's map_add twin over blocks (masked pairs: -1 into node 0)."""
    return _scatter(map_n, torch.where(ok, subjects, 0),
                    torch.where(ok, slots, -1), "amax")


def maps_convert_plain(maps, s, convert):
    """K9's maps_convert twin over blocks."""
    suspect_of, dead_of, left_of, alive_val = maps
    home = s.device
    u = convert.shape[0]
    subj = torch.where(convert, s.r_subject.home, 0)
    suspect_of = _scatter(suspect_of, subj,
                          torch.where(convert, -1, 1 << 30), "amin")
    dead_of = _scatter(dead_of, subj, torch.where(
        convert, torch.arange(u, dtype=I32, device=home), -1), "amax")
    return suspect_of, dead_of, left_of, alive_val


# ---------------------------------------------------------- K7: the round

def probe_inputs(params, s) -> dict:
    """The probe round's draws over the blocks: the [1 + k] offsets
    Replicated, the per-node draws Blocks (K1 by global element)."""
    want = swim._probe_draws(params, s.tick)
    return dict(zip(want, prng.draw_blocks(list(want.values()), s.up)))


def _ok_node(params, s, b: int) -> torch.Tensor:
    """Block b's rows of the per-node delivery rate (_probe_pass_plain)."""
    dev, ell = s.up.parts[b].device, s.up.rows
    if params.degraded_frac > 0.0:
        h = (_rows(s.up, b) * 2654435761 + params.seed) & prng.M32
        degraded = (h.to(F32) / np.float32(2 ** 32)) < params.degraded_frac
        ok = torch.where(degraded, prng.f32(1.0 - params.degraded_loss),
                         prng.f32(1.0 - params.p_loss))
    else:
        ok = torch.full((ell,), 1.0 - params.p_loss, dtype=F32, device=dev)
    if params.chaos:
        ok = ok * s.chaos_ok.parts[b]
    return ok


def probe_pass_plain(params, s, maps, drawn):
    """The plain twin of K7 over blocks (_probe_pass_plain, each block's
    rows, the ring peers' leaves pulled by rolls' block rotations, the
    counters as integer totals added in block order).  Returns (state,
    want Blocks, row_subject Blocks, ProbeObs with Blocks rtt/acked)."""
    n, k, u = params.n_nodes, params.indirect_checks, params.rumor_slots
    tick, home, nb = s.tick, s.device, s.up.n_blocks
    offs = drawn["offs"].home
    d = offs[0]
    suspect_of, dead_of, left_of, alive_val = maps
    live = swim._both(s.up, s.member)
    ok_node = Blocks(_ok_node(params, s, b) for b in range(nb))
    t_down = _pull(s.committed_dead.map(torch.logical_or, s.committed_left), d)
    t_sus, t_dead, t_left, t_alive = (_pull(m, d) for m in maps)
    t_cinc, t_bulk = _pull(s.committed_inc, d), _pull(s.bulk_member, d)
    t_live, t_member = _pull(live, d), _pull(s.member, d)
    t_ok, t_coords = _pull(ok_node, d), _pull(s.coords, d)
    r_ok = [_pull(ok_node, offs[1 + m]) for m in range(k)]
    r_live = [_pull(live, offs[1 + m]) for m in range(k)]
    if params.chaos:
        t_grp = _pull(s.chaos_grp, d)
        r_grp = [_pull(s.chaos_grp, offs[1 + m]) for m in range(k)]
    t16 = swim._t16(tick)
    aware, failed, probed, acked_p, direct_p, rtt2 = [], [], [], [], [], []
    for b in range(nb):
        dev = s.up.parts[b].device
        know, learn = s.know.parts[b], s.learn_tick.parts[b]
        r_confirm, r_inc = s.r_confirm.on(dev), s.r_inc.on(dev)
        if params.awareness_max > 0:
            score = torch.clamp(s.awareness.parts[b], 0,
                                params.awareness_max - 1)
            mult = (score + 1).to(F32)
            lha_go = drawn["lha"].parts[b] * mult < 1.0
        else:
            mult = torch.ones(s.up.rows, dtype=F32, device=dev)
            lha_go = torch.ones(s.up.rows, dtype=torch.bool, device=dev)
        prober = live.parts[b] & lha_go
        # _believes_down_shift on the block's rows
        down = t_down.parts[b] | swim._row_gather(know, t_dead.parts[b]) \
            | swim._row_gather(know, t_left.parts[b])
        ss = t_sus.parts[b]
        know_s = swim._row_gather(know, ss)
        lrn = swim._row_gather(learn, ss)
        conf = swim._table_lookup(r_confirm, ss)
        expired = know_s & ((t16 - lrn) >= swim._timeouts(params, conf).to(I16))
        av = t_alive.parts[b]
        a_slot = torch.where(av >= 0, av % u, -1)
        a_inc = torch.where(av >= 0, torch.div(av, u, rounding_mode="floor"),
                            -1)
        s_inc = swim._table_lookup(r_inc, ss)
        refuted = (av >= 0) & (a_inc > s_inc) & swim._row_gather(know, a_slot)
        refuted = refuted | (s_inc < t_cinc.parts[b])
        skip = down | (expired & ~refuted) | t_bulk.parts[b]
        t_up = t_live.parts[b]
        ok_i = ok_node.parts[b]
        if params.chaos:
            grp = s.chaos_grp.parts[b]
            same_t = grp == t_grp.parts[b]
        diff = s.coords.parts[b] - t_coords.parts[b]
        rtt = torch.sqrt((diff * diff).sum(-1)) + params.rtt_base_ms
        rtt = rtt * (1.0 + drawn["rtt"].parts[b] * 0.1)
        ok_t = t_ok.parts[b]
        m_t = torch.minimum(ok_i, ok_t)
        legs_ok = drawn["direct"].parts[b] < m_t * m_t
        if params.chaos:
            legs_ok = legs_ok & same_t
        direct_ack = t_up & legs_ok \
            & (2.0 * rtt < params.probe_timeout_ms * mult)
        if k > 0:
            ok_r = torch.stack([r_ok[j].parts[b] for j in range(k)], dim=-1)
            l1 = drawn["uA"].parts[b] < torch.minimum(ok_i[:, None], ok_r)
            m_rt = torch.minimum(ok_r, ok_t[:, None])
            l23 = drawn["uB"].parts[b] < m_rt * m_rt
            l4 = drawn["uC"].parts[b] < torch.minimum(ok_r, ok_i[:, None])
            if params.chaos:
                rgrp = torch.stack([r_grp[j].parts[b] for j in range(k)],
                                   dim=-1)
                same_r = rgrp == grp[:, None]
                same_rt = rgrp == t_grp.parts[b][:, None]
                l1 = l1 & same_r
                l4 = l4 & same_r
                l23 = l23 & same_rt
            relay_ok = torch.stack([r_live[j].parts[b] for j in range(k)],
                                   dim=-1)
            reach = t_up[:, None] & l23
            ind_ack = relay_ok & l1 & reach & l4
            nacked = relay_ok & l1 & ~reach & l4
            ack = direct_ack | ind_ack.any(-1)
        else:
            nacked = torch.zeros((s.up.rows, 0), dtype=torch.bool, device=dev)
            ack = direct_ack
        t_mem = t_member.parts[b]
        f = prober & ~skip & ~ack & t_mem
        p = prober & ~skip & t_mem
        if params.awareness_max > 0:
            nack_count = nacked.sum(-1, dtype=I32)
            delta_fail = (k - nack_count) if k > 0 else 0
            zero = torch.zeros((), dtype=I32, device=dev)
            delta = torch.where(p & ack, -1, torch.where(f, delta_fail, zero))
            aware.append(torch.clamp(s.awareness.parts[b].to(I32) + delta, 0,
                                     params.awareness_max - 1).to(I8))
        failed.append(f)
        probed.append(p)
        acked_p.append(p & ack)
        direct_p.append(prober & ~skip & direct_ack)
        rtt2.append(2.0 * rtt)
    failed = Blocks(failed)
    if params.awareness_max > 0:
        s = s.replace(awareness=Blocks(aware))
    cnt = rolls.push(failed, d).map(lambda x: x.to(I32))

    # (a) confirm existing suspicions; joiners start carrying the rumor
    cnt_s = _gather(cnt, s.r_subject.home)

    def confirm(c, dev):
        act, knd = s.r_active.on(dev), s.r_kind.on(dev)
        r = c.to(I32) + torch.where(act & (knd == SUSPECT),
                                    torch.clamp_max(cnt_s.to(dev), 8), 0)
        return torch.clamp_max(r, 64).to(I8)

    es = _pull(suspect_of, d)
    know, learn, sends = [], [], []
    for b in range(nb):
        joiner = failed.parts[b] & (es.parts[b] >= 0)
        cell = swim._onehot(es.parts[b], u) & joiner[:, None]
        fresh_cell = cell & ~s.know.parts[b]
        know.append(s.know.parts[b] | cell)
        learn.append(torch.where(fresh_cell, t16, s.learn_tick.parts[b]))
        sends.append(torch.where(fresh_cell, params.retransmit_limit,
                                 s.sends_left.parts[b]))
    s = s.replace(know=Blocks(know), learn_tick=Blocks(learn),
                  sends_left=Blocks(sends),
                  **_table_map(s, {"r_confirm": confirm}))

    # (b) dense per-subject suspicion timers
    starts, confirms, counts, news = [], [], [], []
    for b in range(nb):
        c = cnt.parts[b]
        suspected = c > 0
        st = s.sus_start.parts[b]
        start_new = suspected & (st < 0) & ~s.committed_dead.parts[b] \
            & ~s.committed_left.parts[b] & s.member.parts[b]
        starts.append(torch.where(start_new, tick, st))
        sc = s.sus_confirm.parts[b].to(I32)
        confirms.append(torch.where(
            start_new, 1, torch.where(suspected & (st >= 0),
                                      torch.clamp_max(sc + c, 64), sc)).to(I8))
        counts.append(s.sus_count.parts[b] + start_new.to(I32))
        news.append(start_new)
    s = s.replace(sus_start=Blocks(starts), sus_confirm=Blocks(confirms),
                  sus_count=Blocks(counts))
    zero = torch.zeros((), dtype=I64, device=home)
    incr = torch.stack([_total((x.sum() for x in probed), home),
                        _total((x.sum() for x in acked_p), home),
                        _count(failed), _total((x.sum() for x in news), home),
                        zero, zero, zero]).to(F32)
    s = s.replace(ctr=s.ctr.map(lambda c: c + incr.to(c.device)))

    # (c) originate suspect rumors for subjects with no existing rumor
    want = []
    for b in range(nb):
        c = cnt.parts[b]
        fresh = (c > 0) & (suspect_of.parts[b] < 0) & (dead_of.parts[b] < 0) \
            & (left_of.parts[b] < 0) & ~s.committed_dead.parts[b] \
            & ~s.committed_left.parts[b]
        want.append(torch.where(fresh, c, 0))
    target = _targets(s.up, d)
    row_subject = Blocks(torch.where(f, t, -1)
                         for f, t in zip(failed.parts, target.parts))
    obs = swim.ProbeObs(shift=d, rtt_ms=Blocks(rtt2), acked=Blocks(direct_p))
    return s, Blocks(want), row_subject, obs


# ---------------------------------------------------------- K8: originate

def release_plain(s, done: torch.Tensor, coverage: torch.Tensor):
    """swim._release over blocks: done and coverage [U] on the first
    device; the committed scatters land in the subjects' blocks."""
    kind, subj, inc = s.r_kind.home, s.r_subject.home, s.r_inc.home
    commit_ok = coverage >= 0.5
    c_dead = done & (kind == DEAD) & commit_ok
    c_left = done & (kind == LEFT) & commit_ok
    c_alive = done & (kind == ALIVE) & commit_ok
    keep = ~done
    return s.replace(
        committed_dead=_scatter(s.committed_dead,
                                torch.where(c_dead, subj, 0), c_dead, "amax"),
        committed_left=_scatter(s.committed_left,
                                torch.where(c_left, subj, 0), c_left, "amax"),
        committed_inc=_scatter(s.committed_inc,
                               torch.where(c_alive, subj, 0),
                               torch.where(c_alive, inc, 0), "amax"),
        know=Blocks(k & keep.to(k.device)[None, :] for k in s.know.parts),
        sends_left=Blocks(torch.where(keep.to(x.device)[None, :], x, 0).to(I8)
                          for x in s.sends_left.parts),
        **_table_map(s, {
            "r_active": lambda a, dev: a & keep.to(dev),
            "r_coverage": lambda c, dev: torch.where(
                keep, coverage, 0.0).to(dev)}))


def _coverage(s):
    """(n_live int64, [U] float32 live coverage) over the blocks."""
    live = swim._both(s.up, s.member)
    n_live = _count(live).clamp_min(1)
    cols = _column_counts(s.know, live)
    return n_live, cols.to(F32) / n_live.to(F32)


def originate_plain(params, s, want_score: Blocks, kind: int,
                    inc_of_subject: Blocks, row_subject: Blocks):
    """K8's twin over blocks (_originate_plain): the demand and the live
    coverage as integer totals, the top `alloc_cap` wants by
    swim._top_k_sharded (earlier global index first among equals), the
    table writes on every copy, each block's rows seeded.  Returns
    (state, (subjects, slots, ok)) on the first device."""
    a, u, home = params.alloc_cap, params.rumor_slots, s.device
    demand = _count(want_score, lambda p, b: p > 0)
    r_active = s.r_active.home
    free = (~r_active).sum()
    _, coverage = _coverage(s)
    evicting = demand > free
    done = r_active & (coverage >= 0.995) & (s.r_kind.home != SUSPECT) \
        & evicting
    released = release_plain(s, done, coverage)
    s = released.replace(r_coverage=Replicated(
        torch.where(evicting.to(c.device), c, o)
        for c, o in zip(released.r_coverage.copies, s.r_coverage.copies)))

    score, subjects = swim._top_k_sharded(want_score, a)
    free_rank = torch.where(s.r_active.home, 0, 1).to(I32) \
        * (u - torch.arange(u, dtype=I32, device=home))
    free_score, slots = swim._top_k(free_rank, a)
    ok = (score > 0) & (free_score > 0)
    oob = torch.where(ok, slots, u)
    def full(v, dtype):
        return torch.full((a,), v, dtype=dtype, device=home)

    def setter(val):
        return lambda t, dev: swim._set_drop(t, oob.to(dev), val.to(dev))

    s = s.replace(**_table_map(s, {
        "r_active": setter(full(True, torch.bool)),
        "r_kind": setter(full(kind, I8)), "r_subject": setter(subjects),
        "r_inc": setter(_gather(inc_of_subject, subjects)),
        "r_start": setter(full(s.tick, I32)),
        "r_confirm": setter(full(1, I8))}))
    match_subj = torch.where(ok, subjects, -2)
    know, learn, sends = [], [], []
    for b, rs in enumerate(row_subject.parts):
        dev = rs.device
        match = rs[:, None] == match_subj.to(dev)[None, :]
        slot_row = torch.where(match, slots.to(dev)[None, :], -1).amax(1)
        cell = swim._onehot(slot_row, u) & (slot_row >= 0)[:, None]
        know.append(s.know.parts[b] | cell)
        learn.append(torch.where(cell, swim._t16(s.tick),
                                 s.learn_tick.parts[b]))
        sends.append(torch.where(cell, params.retransmit_limit,
                                 s.sends_left.parts[b]))
    s = s.replace(know=Blocks(know), learn_tick=Blocks(learn),
                  sends_left=Blocks(sends))
    return s, (subjects, slots, ok)


# ----------------------------------------------------- K10: slot expiry

def _alive_refuters(s, dev):
    """The [U] same-subject alive max of swim._suspicion_expiry_plain: (a
    slot index, refutable)."""
    u = s.r_active.shape[0]
    act, knd = s.r_active.on(dev), s.r_kind.on(dev)
    subj, inc = s.r_subject.on(dev), s.r_inc.on(dev)
    u_ids = torch.arange(u, dtype=I32, device=dev)
    same = subj[:, None] == subj[None, :]
    is_alive = act & (knd == ALIVE)
    av = torch.where(same & is_alive[None, :], inc[None, :] * u + u_ids[None, :],
                     -1).amax(1)
    a_slot = torch.where(av >= 0, av % u, 0)
    a_inc = torch.where(av >= 0, torch.div(av, u, rounding_mode="floor"), -1)
    return a_slot, (av >= 0) & (a_inc > inc)


def suspicion_expiry_plain(params, s):
    """K10's twin over blocks: each block's expired cells, their [U] or
    added in block order, the decision once, each block's columns
    rewritten.  Returns (state, convert [U] on the first device)."""
    home, tick = s.device, s.tick
    t16 = swim._t16(tick)
    subj = s.r_subject.home
    stale = s.r_inc.home < _gather(s.committed_inc, subj)
    cdead = _gather(s.committed_dead, subj)
    expired = []
    for b, know in enumerate(s.know.parts):
        dev = know.device
        act, knd = s.r_active.on(dev), s.r_kind.on(dev)
        is_suspect = act & (knd == SUSPECT)
        timeout16 = swim._timeouts(params, s.r_confirm.on(dev)).to(I16)
        age = t16 - s.learn_tick.parts[b]
        a_slot, refutable = _alive_refuters(s, dev)
        refuted = refutable[None, :] & know.index_select(1, a_slot.to(I64))
        refuted = refuted | stale.to(dev)[None, :]
        observer = (s.up.parts[b] & s.member.parts[b])[:, None]
        expired.append(know & is_suspect[None, :] & (age >= timeout16[None, :])
                       & ~refuted & observer)
    any_exp = _total((e.any(0).to(I64) for e in expired), home) > 0
    subj_ = s.r_subject.home
    is_dead = s.r_active.home & (s.r_kind.home == DEAD)
    dead_exists = ((subj_[:, None] == subj_[None, :]) & is_dead[None, :]).any(1)
    convert = any_exp & ~dead_exists & ~cdead
    limit = params.retransmit_limit
    know, learn, sends = [], [], []
    for b, e in enumerate(expired):
        c = convert.to(e.device)[None, :]
        know.append(torch.where(c, e, s.know.parts[b]))
        learn.append(torch.where(c & e, t16, s.learn_tick.parts[b]))
        sends.append(torch.where(c, torch.where(e, limit, 0).to(I8),
                                 s.sends_left.parts[b]))
    s = s.replace(know=Blocks(know), learn_tick=Blocks(learn),
                  sends_left=Blocks(sends), **_table_map(s, {
                      "r_kind": lambda x, dev: torch.where(
                          convert.to(dev), DEAD, x).to(I8),
                      "r_start": lambda x, dev: torch.where(
                          convert.to(dev), tick, x)}))
    return s, convert


# ---------------------------------------------------- K11: dense expiry

def _timers(params, s, b: int) -> tuple:
    """Block b's dense timers: (refuted, expired)."""
    st = s.sus_start.parts[b]
    active = st >= 0
    refute = active & s.up.parts[b] & s.member.parts[b] \
        & (s.tick - st >= params.probe_period_ticks)
    timeout = swim._timeouts(params, s.sus_confirm.parts[b])
    return refute, active & ~refute & (s.tick - st >= timeout) \
        & s.member.parts[b]


def dense_expiry_plain(params, s, shift, maps):
    """K11 around its origination over blocks (the plain twin of
    _dense_suspicion_expiry_plain): the pre launch's twin, K8, the post
    launch's twin."""
    s, want, row_subject, converted = dense_pre_plain(params, s, shift, maps)
    s, alloc = originate(params, s, want, DEAD, s.incarnation, row_subject)
    return dense_post_plain(params, s, shift, want, converted, alloc)


def dense_pre_plain(params, s, shift, maps):
    """K11's pre launch over blocks: the timers block by block, the
    expiring slots from the subjects' cells and their conversion, the
    wants at each prober's target by rolls' block rotations.  Returns
    (state, want, row_subject, the dead and left maps converted)."""
    tick, nb = s.tick, s.up.n_blocks
    t16 = swim._t16(tick)
    suspect_of, dead_of, left_of, _ = maps
    expired = Blocks(_timers(params, s, b)[1] for b in range(nb))
    subj = s.r_subject.home
    exp_u = s.r_active.home & (s.r_kind.home == SUSPECT) \
        & _gather(expired, subj) & (_gather(dead_of, subj) < 0) \
        & ~_gather(s.committed_dead, subj)
    learn, sends = [], []
    for b, know in enumerate(s.know.parts):
        sel = exp_u.to(know.device)[None, :] & know
        learn.append(torch.where(sel, t16, s.learn_tick.parts[b]))
        sends.append(torch.where(sel, params.retransmit_limit,
                                 s.sends_left.parts[b]))
    s = s.replace(learn_tick=Blocks(learn), sends_left=Blocks(sends),
                  **_table_map(s, {
                      "r_kind": lambda x, dev: torch.where(
                          exp_u.to(dev), DEAD, x).to(I8),
                      "r_start": lambda x, dev: torch.where(
                          exp_u.to(dev), tick, x)}))
    suspect_of, dead_of, left_of, _ = maps_convert_plain(
        (suspect_of, dead_of, left_of, None), s, exp_u)
    prober_live = rolls.push(swim._both(s.up, s.member), shift)
    want = Blocks(torch.where(
        expired.parts[b] & (dead_of.parts[b] < 0) & (left_of.parts[b] < 0)
        & (suspect_of.parts[b] < 0) & ~s.committed_dead.parts[b]
        & ~s.bulk_member.parts[b] & prober_live.parts[b], 1, 0).to(I32)
        for b in range(nb))
    target = _targets(s.up, shift)
    pulled = _pull(want, shift)
    row_subject = Blocks(torch.where(p > 0, t, -1)
                         for p, t in zip(pulled.parts, target.parts))
    return s, want, row_subject, (dead_of, left_of)


def dense_post_plain(params, s, shift, want, converted, alloc):
    """K11's post launch over blocks, after K8 gave the pairs `alloc`: the
    overflow into the bulk channel, its sums (bulk members, live rows) as
    integer totals added in block order, and the timers cleared."""
    nb = s.up.n_blocks
    dead_of, left_of = converted
    dead_of2 = map_add_plain(dead_of, *alloc)
    overflow = Blocks((w > 0) & (d2 < 0) if not params.chaos
                      else torch.zeros_like(w, dtype=torch.bool)
                      for w, d2 in zip(want.parts, dead_of2.parts))
    bulk_member = s.bulk_member.map(torch.logical_or, overflow)
    v_prev = _count(s.bulk_member).to(F32)
    v_new = _count(bulk_member).to(F32)
    seeded = _pull(overflow, shift)
    n_live_f = _count(swim._both(s.up, s.member)).clamp_min(1).to(F32)
    share = 1.0 / n_live_f
    heard, cov, starts, confirms = [], [], [], []
    for b in range(nb):
        dev = s.up.parts[b].device
        heard.append(torch.minimum(
            torch.minimum(s.bulk_heard.parts[b], v_prev.to(dev))
            + seeded.parts[b].to(F32), v_new.to(dev)))
        cov.append(torch.where(overflow.parts[b], share.to(dev),
                               s.bulk_cov.parts[b]))
        done = _timers(params, s, b)[0] | s.committed_dead.parts[b] \
            | s.committed_left.parts[b] | (dead_of2.parts[b] >= 0) \
            | (left_of.parts[b] >= 0) | ~s.member.parts[b] \
            | bulk_member.parts[b]
        starts.append(torch.where(done, -1, s.sus_start.parts[b]))
        confirms.append(torch.where(done, 0, s.sus_confirm.parts[b]).to(I8))
    return s.replace(bulk_member=bulk_member, bulk_heard=Blocks(heard),
                     bulk_cov=Blocks(cov), sus_start=Blocks(starts),
                     sus_confirm=Blocks(confirms))


# ------------------------------------------------ K12: refute and expire

def refutation_plain(params, s):
    """K12's refutation twin over blocks: the subjects' cells read in
    their blocks, the incarnation and Lifeguard updates landing in the
    subjects' blocks (masked lanes: node 0), each block's columns
    rewritten."""
    u, home, tick = params.rumor_slots, s.device, s.tick
    act, knd = s.r_active.home, s.r_kind.home
    subj, r_inc = s.r_subject.home, s.r_inc.home
    refutable = act & ((knd == SUSPECT) | (knd == DEAD))
    rows = _gather(s.know, subj)                                  # [U, U]
    subject_knows = rows[torch.arange(u, device=home),
                         torch.arange(u, device=home)]
    need = refutable & subject_knows & _gather(s.up, subj) \
        & _gather(s.member, subj) & (r_inc >= _gather(s.incarnation, subj))
    idx = torch.where(need, subj, 0)
    inc = _scatter(s.incarnation, idx, torch.where(need, r_inc + 1, -1),
                   "amax")
    awareness = s.awareness
    if params.awareness_max > 0:
        bumped = _add_at(s.awareness.map(lambda x: x.to(I32)), idx,
                         need.to(I32))
        awareness = bumped.map(lambda x: torch.clamp(
            x.to(I8), 0, params.awareness_max - 1))
    new_inc = _gather(inc, subj)
    t16 = swim._t16(tick)
    know, learn, sends = [], [], []
    for b, k in enumerate(s.know.parts):
        dev = k.device
        nd = need.to(dev)[None, :]
        cell_new = nd & (_rows(s.know, b)[:, None] == subj.to(dev)[None, :])
        know.append(torch.where(nd, cell_new, k))
        learn.append(torch.where(cell_new, t16, s.learn_tick.parts[b]))
        sends.append(torch.where(nd, torch.where(
            cell_new, params.retransmit_limit, 0).to(I8),
            s.sends_left.parts[b]))
    return s.replace(
        awareness=awareness, incarnation=inc, know=Blocks(know),
        learn_tick=Blocks(learn), sends_left=Blocks(sends),
        **_table_map(s, {
            "r_kind": lambda x, dev: torch.where(need.to(dev), ALIVE,
                                                 x).to(I8),
            "r_inc": lambda x, dev: torch.where(need.to(dev),
                                                new_inc.to(dev), x),
            "r_start": lambda x, dev: torch.where(need.to(dev), tick, x)}))


def _add_at(base: Blocks, idx: torch.Tensor, val: torch.Tensor) -> Blocks:
    """base.at[idx].add(val) for idx in [0, N), block by block."""
    ell = base.rows
    out = []
    for b, part in enumerate(base.parts):
        loc = (idx.to(I64) - b * ell).to(part.device)
        mine = (loc >= 0) & (loc < ell)
        wide = torch.cat([part, part[:1]])
        out.append(wide.scatter_add(0, torch.where(mine, loc, ell),
                                    val.to(part.device).to(part.dtype))[:ell])
    return Blocks(out)


def expire_plain(params, s):
    """K12's expire twin over blocks: the live count and the [U] column
    counts as integer totals, the decision once, _release over blocks."""
    kind, start = s.r_kind.home, s.r_start.home
    life = torch.where(kind == SUSPECT, params.expiry_suspect_ticks,
                       params.expiry_gossip_ticks).to(I32)
    age = s.tick - start
    _, coverage = _coverage(s)
    done = s.r_active.home & (age >= life) \
        & ((coverage >= 0.995) | (age >= 4 * life))
    return release_plain(s, done, coverage)


# ------------------------------------------------------------ the cards
#
# Each kernel_* launches the block form of its pass's kernel
# (kernels.launch_*_blocks): K9's build, map_add and maps_convert, K7 with
# its combine, K8's select, cover, combine and seed, K10's scan, combine
# and apply, K11's pre, combine and post around K8, K12's refutation with
# its combine and expire's count, combine and clear.  As on one device,
# each consumes the state it is given: the kernels write its blocks and
# its table copies in place, and the state returned holds its tensors.

def _blank(like: Blocks, dtype, width=None) -> Blocks:
    """Fresh blocks shaped as like's rows (uninitialized: written whole)."""
    shape = (like.rows,) if width is None else (like.rows, width)
    return Blocks(torch.empty(shape, dtype=dtype, device=d)
                  for d in like.devices)


def _timeout_copies(params, s, dtype):
    """The timeout table's copy on each distinct device, as the table."""
    return Replicated(swim._table(params, c.device, dtype)
                      for c in s.r_active.copies)


def kernel_maps(params, s):
    """K9's build over blocks: each block's four maps as the rows of one
    [4, L] tensor (no [4, N] buffer anywhere)."""
    rows = [torch.empty((4, s.up.rows), dtype=I32, device=d)
            for d in s.up.devices]
    maps = tuple(Blocks(r[k] for r in rows) for k in range(4))
    kernels.launch_subject_maps_blocks(s.r_active, s.r_kind, s.r_subject,
                                       s.r_inc, maps)
    return maps


def kernel_map_add(map_n: Blocks, subjects, slots, ok) -> Blocks:
    for part in map_n.parts:
        swim._writable_maps({"map": part}, "K9 map_add")
    kernels.launch_map_add_blocks(map_n, subjects, slots, ok)
    return map_n


def kernel_maps_convert(maps, s, convert):
    suspect_of, dead_of, left_of, alive_val = maps
    for a, b in zip(suspect_of.parts, dead_of.parts):
        swim._writable_maps({"suspect_of": a, "dead_of": b},
                            "K9 maps_convert")
    kernels.launch_maps_convert_blocks(suspect_of, dead_of, convert,
                                       s.r_subject)
    return suspect_of, dead_of, left_of, alive_val


def kernel_probe_pass(params, s, maps, drawn):
    """K7 over blocks (swim._probe_pass's block form)."""
    suspect_of, dead_of, left_of, alive_val = maps
    amax = params.awareness_max
    swim._writable(s, swim.PROBE_INPLACE if amax > 0 else
                   tuple(f for f in swim.PROBE_INPLACE if f != "awareness"),
                   "K7")
    out = dict(want_out=_blank(s.up, I32), row_subject_out=_blank(s.up, I32),
               rtt_out=_blank(s.up, F32), acked_out=_blank(s.up, torch.bool))
    kernels.launch_probe_round_blocks(
        up=s.up, member=s.member, awareness=s.awareness, coords=s.coords,
        committed_dead=s.committed_dead, committed_left=s.committed_left,
        committed_inc=s.committed_inc, bulk_member=s.bulk_member,
        know=s.know, learn_tick=s.learn_tick, sends_left=s.sends_left,
        sus_start=s.sus_start, sus_confirm=s.sus_confirm,
        sus_count=s.sus_count,
        chaos_grp=s.chaos_grp if params.chaos else None,
        chaos_ok=s.chaos_ok if params.chaos else None,
        r_active=s.r_active, r_kind=s.r_kind, r_subject=s.r_subject,
        r_inc=s.r_inc, r_confirm=s.r_confirm,
        timeouts=_timeout_copies(params, s, I16), suspect_of=suspect_of,
        dead_of=dead_of, left_of=left_of, alive_val=alive_val, ctr=s.ctr,
        offs=drawn["offs"], rtt_draw=drawn["rtt"], direct=drawn["direct"],
        lha=drawn.get("lha"), leg_a=drawn.get("uA"), leg_b=drawn.get("uB"),
        leg_c=drawn.get("uC"), awareness_max=amax,
        degraded=params.degraded_frac > 0.0, seed=params.seed,
        ok_good=prng.f32(1.0 - params.p_loss),
        ok_bad=prng.f32(1.0 - params.degraded_loss),
        degraded_frac=params.degraded_frac,
        probe_timeout_ms=params.probe_timeout_ms,
        rtt_base_ms=params.rtt_base_ms, tick=s.tick, tick16=swim._t16(s.tick),
        limit=params.retransmit_limit, **out)
    obs = swim.ProbeObs(shift=drawn["offs"].home[0], rtt_ms=out["rtt_out"],
                        acked=out["acked_out"])
    return s, out["want_out"], out["row_subject_out"], obs


def kernel_originate(params, s, want, kind, inc_of_subject, row_subject):
    """K8 over blocks (swim._originate's block form): (state, (subjects,
    slots, ok) on the first device)."""
    swim._writable(s, swim.ORIGINATE_INPLACE, "K8")
    a, dev = params.alloc_cap, s.device
    out = dict(subjects_out=torch.empty(a, dtype=I32, device=dev),
               slots_out=torch.empty(a, dtype=I32, device=dev),
               ok_out=torch.empty(a, dtype=torch.bool, device=dev))
    kernels.launch_originate_blocks(
        want=want, row_subject=row_subject, inc_of_subject=inc_of_subject,
        up=s.up, member=s.member, know=s.know, learn_tick=s.learn_tick,
        sends_left=s.sends_left, committed_dead=s.committed_dead,
        committed_left=s.committed_left, committed_inc=s.committed_inc,
        r_active=s.r_active, r_kind=s.r_kind, r_subject=s.r_subject,
        r_inc=s.r_inc, r_start=s.r_start, r_confirm=s.r_confirm,
        r_coverage=s.r_coverage, alloc=a, kind=kind, tick=s.tick,
        tick16=swim._t16(s.tick), limit=params.retransmit_limit, **out)
    return s, (out["subjects_out"], out["slots_out"], out["ok_out"])


def kernel_suspicion_expiry(params, s):
    """K10 over blocks: (state, convert [U] on the first device)."""
    swim._writable(s, swim.EXPIRY_INPLACE, "K10")
    convert = torch.empty_like(s.r_active.home)
    kernels.launch_suspicion_expiry_blocks(
        know=s.know, learn_tick=s.learn_tick, sends_left=s.sends_left,
        up=s.up, member=s.member, committed_dead=s.committed_dead,
        committed_inc=s.committed_inc, r_active=s.r_active, r_kind=s.r_kind,
        r_subject=s.r_subject, r_inc=s.r_inc, r_start=s.r_start,
        r_confirm=s.r_confirm, timeouts=_timeout_copies(params, s, I16),
        tick=s.tick, tick16=swim._t16(s.tick), limit=params.retransmit_limit,
        convert_out=convert)
    return s, convert


def kernel_dense_expiry(params, s, shift, maps):
    """K11's pre and post over blocks around the block form of K8
    (swim._dense_suspicion_expiry's block form)."""
    swim._writable(s, swim.DENSE_INPLACE, "K11")
    dev = s.device
    shift = torch.as_tensor(shift, dtype=I32, device=dev)
    suspect_of, dead_of, left_of, _ = maps
    want, row_subject = _blank(s.up, I32), _blank(s.up, I32)
    exp = torch.empty_like(s.r_active.home)
    counts = torch.empty(kernels.DENSE_COUNTS, dtype=I64, device=dev)
    kernels.launch_dense_expiry_blocks(
        sus_start=s.sus_start, sus_confirm=s.sus_confirm, up=s.up,
        member=s.member, committed_dead=s.committed_dead,
        bulk_member=s.bulk_member, suspect_of=suspect_of, dead_of=dead_of,
        left_of=left_of, know=s.know, learn_tick=s.learn_tick,
        sends_left=s.sends_left, r_active=s.r_active, r_kind=s.r_kind,
        r_subject=s.r_subject, r_start=s.r_start,
        timeouts=_timeout_copies(params, s, I32), shift=shift, tick=s.tick,
        tick16=swim._t16(s.tick), limit=params.retransmit_limit,
        period=params.probe_period_ticks, exp_out=exp, want_out=want,
        row_subject_out=row_subject, counts_out=counts)
    r_subject = s.r_subject.home.clone()   # K8 rewrites the table in place
    s, (subjects, slots, ok) = originate(
        params, s, want, swim.DEAD, s.incarnation, row_subject)
    kernels.launch_dense_expiry_post_blocks(
        want=want, dead_of=dead_of, left_of=left_of, exp=exp,
        r_subject=r_subject, subjects=subjects, slots=slots, ok=ok, up=s.up,
        member=s.member, committed_dead=s.committed_dead,
        committed_left=s.committed_left, counts=counts, shift=shift,
        tick=s.tick, period=params.probe_period_ticks, chaos=params.chaos,
        bulk_member=s.bulk_member, bulk_heard=s.bulk_heard,
        bulk_cov=s.bulk_cov, sus_start=s.sus_start,
        sus_confirm=s.sus_confirm)
    return s


def kernel_refutation(params, s):
    amax = params.awareness_max
    swim._writable(s, swim.REFUTE_INPLACE if amax > 0 else
                   tuple(f for f in swim.REFUTE_INPLACE if f != "awareness"),
                   "K12")
    kernels.launch_refutation_blocks(
        incarnation=s.incarnation, awareness=s.awareness, up=s.up,
        member=s.member, know=s.know, learn_tick=s.learn_tick,
        sends_left=s.sends_left, r_active=s.r_active, r_kind=s.r_kind,
        r_subject=s.r_subject, r_inc=s.r_inc, r_start=s.r_start,
        awareness_max=amax, tick=s.tick, tick16=swim._t16(s.tick),
        limit=params.retransmit_limit)
    return s


def kernel_expire(params, s):
    swim._writable(s, swim.FREE_INPLACE, "K12 expire")
    kernels.launch_expire_blocks(
        know=s.know, sends_left=s.sends_left, up=s.up, member=s.member,
        committed_dead=s.committed_dead, committed_left=s.committed_left,
        committed_inc=s.committed_inc, r_active=s.r_active, r_kind=s.r_kind,
        r_subject=s.r_subject, r_inc=s.r_inc, r_start=s.r_start,
        r_coverage=s.r_coverage, tick=s.tick,
        life_gossip=params.expiry_gossip_ticks,
        life_suspect=params.expiry_suspect_ticks)
    return s


# ------------------------------------------------------------ dispatch

def _cuda(s) -> bool:
    return s.know.is_cuda


def maps(params, s):
    if not _cuda(s):
        return maps_plain(params, s)
    return kernel_maps(params, s)


def map_add(map_n, subjects, slots, ok):
    if not map_n.is_cuda:
        return map_add_plain(map_n, subjects, slots, ok)
    return kernel_map_add(map_n, subjects, slots, ok)


def maps_convert(maps_, s, convert):
    if not _cuda(s):
        return maps_convert_plain(maps_, s, convert)
    return kernel_maps_convert(maps_, s, convert)


def probe_pass(params, s, maps_, drawn):
    if not _cuda(s):
        return probe_pass_plain(params, s, maps_, drawn)
    return kernel_probe_pass(params, s, maps_, drawn)


def originate(params, s, want, kind, inc_of_subject, row_subject):
    if not _cuda(s):
        return originate_plain(params, s, want, kind, inc_of_subject,
                               row_subject)
    return kernel_originate(params, s, want, kind, inc_of_subject,
                            row_subject)


def probe_round(params, s, maps_):
    """The sharded _probe_round: the draws (K1 by global element), the
    round (K7), its suspect rumors (K8) and their map update (K9)."""
    s, want, row_subject, obs = probe_pass(params, s, maps_,
                                           probe_inputs(params, s))
    s, alloc = originate(params, s, want, SUSPECT, s.incarnation,
                         row_subject)
    return s, obs, (map_add(maps_[0], *alloc), *maps_[1:])


def suspicion_expiry(params, s):
    if not _cuda(s):
        return suspicion_expiry_plain(params, s)
    return kernel_suspicion_expiry(params, s)


def dense_expiry(params, s, shift, maps_):
    if not _cuda(s):
        return dense_expiry_plain(params, s, shift, maps_)
    return kernel_dense_expiry(params, s, shift, maps_)


def refutation(params, s):
    if not _cuda(s):
        return refutation_plain(params, s)
    return kernel_refutation(params, s)


def expire(params, s):
    if not _cuda(s):
        return expire_plain(params, s)
    return kernel_expire(params, s)


def bulk_flag(bulk_member: Blocks) -> bool:
    """The probe tick's one host read on a sharded pool: the blocks' any
    added on the first device, read once whatever B is."""
    swim.host_syncs += 1
    return bool(_any(bulk_member).item())


def probe_tick(params, s):
    """swim.step_with_obs's probe-tick passes over the blocks.  Returns
    (state, ProbeObs)."""
    m = maps(params, s)
    s, obs, m = probe_round(params, s, m)
    s, convert = suspicion_expiry(params, s)
    m = maps_convert(m, s, convert)
    s = dense_expiry(params, s, obs.shift, m)
    s = refutation(params, s)
    s = expire(params, s)
    return s.replace(bulk_live=bulk_flag(s.bulk_member)), obs


# ------------------------------------------------------- metrics, commands

def metrics_vector(params, s) -> torch.Tensor:
    """swim.metrics_vector of a sharded pool: every gauge from integer
    totals added in block order (so bit-equal to the unsharded vector),
    except bulk.coverage, whose numerator is a float32 sum of the bulk
    members' coverage added block by block (within a few ulps)."""
    home = s.device
    live = swim._both(s.up, s.member)
    n_live = _count(live).clamp_min(1).to(F32)
    active = s.r_active.home
    n_active = active.sum().clamp_min(1).to(F32)
    know_live = _total(((k & l[:, None] & active.to(k.device)[None, :]
                         & (sl > 0)).sum(dtype=I64)
                        for k, l, sl in zip(s.know.parts, live.parts,
                                            s.sends_left.parts)), home)
    util = know_live.to(F32) / (n_live * n_active)
    conv = torch.where(active, s.r_coverage.home, 0.0).sum() / n_active
    n_bulk = _count(s.bulk_member).to(F32)
    cov_sum = _total((torch.where(m, c, 0.0).sum() for m, c in
                      zip(s.bulk_member.parts, s.bulk_cov.parts)), home)
    bulk_cov = cov_sum / n_bulk.clamp_min(1.0)
    kind = s.r_kind.home
    aware = _total((torch.where(l, a.to(I32), 0).sum(dtype=I64)
                    for l, a in zip(live.parts, s.awareness.parts)), home)
    gauges = torch.stack([
        (active & (kind == ALIVE)).sum().to(F32),
        (active & (kind == SUSPECT)).sum().to(F32),
        (active & (kind == DEAD)).sum().to(F32),
        (active & (kind == LEFT)).sum().to(F32),
        active.sum().to(F32), util, conv, _count(live).to(F32),
        _count(s.committed_dead).to(F32), _count(s.committed_left).to(F32),
        n_bulk, bulk_cov, aware.to(F32) / n_live,
        torch.full((), s.tick, dtype=F32, device=home)])
    return torch.cat([s.ctr.home, gauges])


def _set_cell(x: Blocks, node: int, value) -> Blocks:
    """x with node's cell set to value, the other blocks shared."""
    b, r = divmod(node, x.rows)
    parts = list(x.parts)
    parts[b] = parts[b].clone()
    parts[b][r] = value
    return Blocks(parts)


def kill(s, node: int):
    return s.replace(up=_set_cell(s.up, node, False))


def _one(like: Blocks, node: int, value: int, fill: int) -> Blocks:
    """An [N] int32 vector, `value` at node and `fill` elsewhere, block by
    block (swim._one, swim._own_row)."""
    x = Blocks(torch.full((like.rows,), fill, dtype=I32, device=d)
               for d in like.devices)
    return _set_cell(x, node, value)


def rejoin(params, s, node: int):
    """swim.rejoin on a sharded pool: the ground truth edited in the
    node's block, the stale rumors withdrawn copy by copy and block by
    block, and the alive rumor originated through the sharded K8."""
    inc = _set_cell(s.incarnation, node, swim._cell(s.incarnation, node) + 1)
    subj, kind = s.r_subject.home, s.r_kind.home
    stale = s.r_active.home & (subj == node) & (
        (kind == DEAD) | (kind == LEFT) | (kind == SUSPECT))
    s = s.replace(
        up=_set_cell(s.up, node, True), member=_set_cell(s.member, node, True),
        committed_dead=_set_cell(s.committed_dead, node, False),
        committed_left=_set_cell(s.committed_left, node, False),
        incarnation=inc,
        know=Blocks(k & ~stale.to(k.device)[None, :] for k in s.know.parts),
        sends_left=Blocks(torch.where(stale.to(x.device)[None, :], 0, x)
                          .to(I8) for x in s.sends_left.parts),
        bulk_member=_set_cell(s.bulk_member, node, False),
        bulk_cov=_set_cell(s.bulk_cov, node, 0.0),
        **_table_map(s, {"r_active": lambda a, dev: a & ~stale.to(dev)}))
    return originate(params, s, _one(s.up, node, 1, 0), ALIVE, inc,
                     _one(s.up, node, node, -1))[0]

