"""Training and evaluation view selection and the resolution schedule.

Counterpart of `gaussianeditor_tpu/data/view_dataset.py`, copied: it is
plain Python (seeded `random`), so both packages pick the same views.
  * `select_train_views`: the seeded `max_view_num` training subset;
  * `TrainViewSchedule`: refilling without-replacement batches and
    resolution milestones;
  * `select_val_views`, `select_test_views`.
"""

from __future__ import annotations

import bisect
import dataclasses
import random
from typing import List, Sequence, Tuple, Union

IntOrList = Union[int, Sequence[int]]


@dataclasses.dataclass
class ViewDataConfig:
    """GSLoadDataModuleConfig subset relevant to COLMAP editing
    (gs_load.py:174-208)."""

    height: IntOrList = 512
    width: IntOrList = 512
    batch_size: IntOrList = 1
    resolution_milestones: List[int] = dataclasses.field(
        default_factory=list
    )
    eval_height: int = -1
    eval_width: int = -1
    max_view_num: int = 48
    n_val_views: int = 8
    n_test_views: int = 120
    seed: int = 0


def _as_list(v: IntOrList) -> List[int]:
    return [v] if isinstance(v, int) else list(v)


def select_train_views(total_views: int, max_view_num: int,
                       seed: int = 0) -> List[int]:
    """The reference's seeded `random.sample` subset (gs_load.py:218-221)
    — deterministic given (total, max, seed)."""
    rng = random.Random(seed)
    return rng.sample(range(total_views), min(total_views, max_view_num))


class TrainViewSchedule:
    """Seeded view subset + refilling batch stack + resolution
    milestones (the GSLoadIterableDataset role)."""

    def __init__(self, total_views: int, cfg: ViewDataConfig):
        self.cfg = cfg
        self.view_subset = select_train_views(
            total_views, cfg.max_view_num, cfg.seed
        )
        self.heights = _as_list(cfg.height)
        self.widths = _as_list(cfg.width)
        self.batch_sizes = _as_list(cfg.batch_size)
        assert len(self.heights) == len(self.widths) == len(self.batch_sizes)
        if len(self.heights) == 1:
            self.milestones = [-1]
        else:
            assert len(self.heights) == len(cfg.resolution_milestones) + 1, (
                "need len(height) == len(resolution_milestones) + 1"
            )
            self.milestones = [-1] + list(cfg.resolution_milestones)
        self._rng = random.Random(cfg.seed)
        self._stack: List[int] = []

    def resolution_at(self, global_step: int) -> Tuple[int, int, int]:
        """(height, width, batch_size) for a step (gs_load.py:273-283)."""
        i = bisect.bisect_right(self.milestones, global_step) - 1
        return self.heights[i], self.widths[i], self.batch_sizes[i]

    def sample_batch(self, global_step: int) -> List[int]:
        """Without-replacement refilling draw from the seeded subset
        (gs_load.py:254-271)."""
        _, _, bs = self.resolution_at(global_step)
        out = []
        for _ in range(bs):
            if not self._stack:
                self._stack = self.view_subset.copy()
            pick = self._rng.choice(self._stack)
            self._stack.remove(pick)
            out.append(pick)
        return out


def select_val_views(train_views: Sequence[int], n_val: int) -> List[int]:
    """Val views: linspace over the SORTED train subset
    (GSLoadDataset, gs_load.py:311-320)."""
    sv = sorted(train_views)
    if not sv:
        return []
    n = min(n_val, len(sv))
    if n == 1:
        return [sv[0]]
    idx = [round(i * (len(sv) - 1) / (n - 1)) for i in range(n)]
    return [sv[i] for i in idx]


def select_test_views(total_views: int) -> List[int]:
    """Test epoch renders every view (gs_load.py:300-309)."""
    return list(range(total_views))
