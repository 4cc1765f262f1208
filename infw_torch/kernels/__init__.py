"""Device kernels of the port and the plain PyTorch code around them.

``all_kernels()`` lists every hand-written kernel (its ``launches`` count
included); ``chip_smoke.py`` builds them together and checks each against
its plain version.
"""
from __future__ import annotations

from typing import List

from . import arena_walk, cwalk, dense, gather, walk, wire_decode
from ._build import Kernel


def all_kernels() -> List[Kernel]:
    return [dense.KERNEL, walk.KERNEL, cwalk.KERNEL, wire_decode.KERNEL, arena_walk.KERNEL,
            gather.KERNEL]
