"""The paper's primary contribution: Hierarchical Inference (HI).

confidence -> policy -> router -> cascade is the Figure-1 pipeline;
cost/calibrate/replay implement the paper's cost model and its published
tables; baselines implements the §6 comparison points.

The reference's package also re-exports the function ``confidence``, which
shadows its module ``core.confidence``; here the name stays the module
(``from repro_torch.core import confidence`` gives the module, and
``confidence.confidence`` the function).
"""
from repro_torch.core.cascade import HICascade, classifier_cascade  # noqa: F401
from repro_torch.core.cost import CostReport, cost_closed_form  # noqa: F401
from repro_torch.core.policy import (AlwaysOffload,  # noqa: F401
                                     BinaryRelevancePolicy, NeverOffload,
                                     OnlineThresholdPolicy, ThresholdPolicy)
from repro_torch.core.router import RouteDecision, route  # noqa: F401
