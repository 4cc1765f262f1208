"""Device kernels of the port and the plain PyTorch code around them.

``all_kernels()`` lists every hand-written kernel entry point (its
``launches`` count included; K3's, K3b's and K6's fused entries share
their sources' libraries, as K7 and K8 and their resident entries share
flow_table's, K9's two entries sketch_update's, K10's two entries
score_update's and K11's two payload_match's); ``chip_smoke.py`` builds
them together and checks each against its plain version.
"""
from __future__ import annotations

from typing import List

from . import (acmatch, arena_dense, arena_walk, cwalk, dense, flow, gather, mxu_score, sketch,
               walk, wire_decode)
from ._build import Kernel


def all_kernels() -> List[Kernel]:
    return [dense.KERNEL, walk.KERNEL, cwalk.KERNEL, cwalk.FUSED_KERNEL, wire_decode.KERNEL,
            arena_walk.KERNEL, arena_walk.FUSED_KERNEL, gather.KERNEL, arena_dense.KERNEL,
            arena_dense.FUSED_KERNEL, flow.PROBE_KERNEL, flow.INSERT_KERNEL,
            flow.PROBE_RESIDENT_KERNEL, flow.INSERT_RESIDENT_KERNEL, sketch.KERNEL,
            sketch.RESIDENT_KERNEL, mxu_score.KERNEL, mxu_score.RESIDENT_KERNEL, acmatch.KERNEL,
            acmatch.RESIDENT_KERNEL]
