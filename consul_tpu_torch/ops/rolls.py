"""Ring-shift peer exchange: out[i] = mat[(i + d) % N].

Every node exchanges with its ring neighbour at a per-tick random offset
d, so the whole exchange is a rotation of the node axis (memberlist walks
a shuffled ring for probe targets; the shift keeps that one-prober-per-
subject-per-round structure).  The offsets are drawn on the device
(`offsets`: one K1 launch) and stay there: views are built by index arithmetic on the
device-side offset, `(arange(N) + d) % N`, because `torch.roll` needs a
host integer and reading one back would sync the device every tick.

`blocks` is the node-axis shard count (`SimConfig.shard_blocks`).  The
JAX package uses it only to lower a rotation to collective permutes
across a mesh; the result is the same permutation for any value.  The
port runs one device, so every `blocks` gives the `blocks == 1` views;
sharding the node axis over several cards is a later slice.
"""

from __future__ import annotations

import torch

from consul_tpu_torch.utils import prng


def offsets_draw(key, n: int, k: int) -> prng.Draw:
    """The draw of `offsets`, for a caller that makes it beside others."""
    return prng.Draw("randint", key, (k,), 1, n)


def offsets(key, n: int, k: int, device) -> torch.Tensor:
    """k nonzero ring offsets shared by all nodes this tick ([k] int32)."""
    return prng.draw([offsets_draw(key, n, k)], device)[0]


def _rows(n: int, d, device) -> torch.Tensor:
    d = torch.as_tensor(d, dtype=torch.int64, device=device)
    return (torch.arange(n, dtype=torch.int64, device=device) + d % n) % n


def pull_multi(mat: torch.Tensor, offs, blocks: int = 1) -> list:
    """k ring views: out[g][i] = mat[(i + offs[g]) % N] (for any `blocks`:
    one device holds every block)."""
    n = mat.shape[0]
    return [mat.index_select(0, _rows(n, offs[g], mat.device))
            for g in range(len(offs))]


def pull(mat: torch.Tensor, d, blocks: int = 1) -> torch.Tensor:
    """Row view from each node's ring peer: out[i] = mat[(i + d) % N]."""
    return pull_multi(mat, [d], blocks=blocks)[0]


def push(mat: torch.Tensor, d, blocks: int = 1) -> torch.Tensor:
    """Inverse view: out[j] = mat[(j - d) % N] — what node j receives when
    every node i sends to (i + d) % N."""
    n = mat.shape[0]
    d = torch.as_tensor(d, dtype=torch.int64, device=mat.device) % n
    return pull(mat, n - d, blocks=blocks)
