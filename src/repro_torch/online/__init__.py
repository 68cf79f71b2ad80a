"""Online adaptation: the served router learns from the traffic it serves.

The port of ``repro.online``, with its exports. Layers: :mod:`replay` —
reservoir + recency outcome buffer; :mod:`updater` — warm-started masked
Adam steps and router publishing; :mod:`drift` — windowed
mean-shift/dispersion alarms (``pairwise_l2`` distances); :mod:`exploration`
— epsilon-greedy + optimistic bonus at the scoring step; :mod:`membership`
— runtime add/remove with probation; :mod:`staging` — delayed/out-of-order
quality feedback staged until the real score lands; :mod:`loop` — the
:class:`OnlineAdapter` the scheduler drives.
"""
from repro_torch.online.drift import DriftDetector
from repro_torch.online.exploration import ExplorationConfig, ExplorationPolicy
from repro_torch.online.loop import OnlineAdapter
from repro_torch.online.membership import MembershipTracker
from repro_torch.online.replay import ReplayBuffer
from repro_torch.online.staging import DelayedFeedback, OutcomeStage
from repro_torch.online.updater import IncrementalUpdater, OnlineUpdateConfig

__all__ = [
    "DelayedFeedback", "DriftDetector", "ExplorationConfig",
    "ExplorationPolicy", "IncrementalUpdater", "MembershipTracker",
    "OnlineAdapter", "OnlineUpdateConfig", "OutcomeStage", "ReplayBuffer",
]
