"""PyTorch/CUDA port of the consul_tpu device plane.

The north-star path (the serf pool's crash-to-convergence run) on an
NVIDIA Hopper card: threefry streams, ring exchange, gossip
dissemination, the SWIM detector passes, Vivaldi and user events, the
host handle on the pool (`oracle.py`, `segments.py`), the nemesis build
(`chaos.py`) and the mass-event benches (`correlated.py`, `f1.py`,
`leave_propagation.py`).  The hot
device programs run hand-written CUDA kernels (`kernels/`); every kernel
has a plain PyTorch twin that CPU tensors take.
"""

from consul_tpu_torch.config import GossipConfig, SimConfig

__all__ = ["GossipConfig", "SimConfig"]
