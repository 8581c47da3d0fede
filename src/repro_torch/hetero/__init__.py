"""Heterogeneous composition engine: joint N-level memory-system design.

Where ``api.explore`` picks each cache level independently (the paper's
§5.4 greedy policy), this package scores **whole system compositions** —
the N-level grid of candidate technologies per (level, bucket) slot, for
every level a task declares or the ``levels=`` subset — as batched tensor
code on the device of the call: system area [µm²], total power including
refresh [W], bandwidth margin, and capacity fit per composition, ranked
under an explicit ``ComposePolicy``. Chip-level envelopes arrive as a
``SystemBudget``; spaces too large to enumerate are searched by the
lossless branch-and-bound of ``hetero.search``; ``vdd_sweep`` /
``refresh_margin_sweep`` add operating points as searched blocks
(``hetero.expand``, one retention launch per swept point).

    from repro_torch.hetero import compose, ComposePolicy, SystemBudget
    report = compose(None, task, compose_policy=ComposePolicy(
        objective="power", budget=SystemBudget(area_um2=2.5e6)))
"""
from repro_torch.hetero.candidates import (BucketCandidates, Candidate,
                                           bucket_candidates,
                                           level_candidates)
from repro_torch.hetero.compose import (ComposePolicy, Composition,
                                        CompositionReport, LevelComposition,
                                        compose)
from repro_torch.hetero.search import balanced_norms, branch_and_bound
from repro_torch.hetero.system import (SYSTEM_METRICS, SystemBudget,
                                       composition_eval_count, score_grid,
                                       score_grid_corners)

__all__ = [
    "Candidate", "BucketCandidates", "bucket_candidates", "level_candidates",
    "ComposePolicy", "Composition", "LevelComposition", "CompositionReport",
    "compose",
    "balanced_norms", "branch_and_bound",
    "SYSTEM_METRICS", "SystemBudget", "score_grid", "score_grid_corners",
    "composition_eval_count",
]
