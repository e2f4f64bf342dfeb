"""Tier-split deployment: the S tier and the L tier on SEPARATE pods (the
reference's ``launch/tier_split.py``).

The one-step HI case (``specs.make_hi_decode_case``) runs both tiers over
one mesh: the right plan when ED and ES share a fabric.  The paper's
topology is two systems joined by a narrow link; on a 2-pod machine the S
tier owns the first 256 ranks, the L tier the next 256, and the only
traffic between them is the escalated tokens out and their logits back
(the offload link, reported as ``beta_bytes_per_step``).

Each tier's decode step is counted on its own (16, 16) sub-mesh of a
512-rank dry-run world, from a rank inside it (rank 0 for the S tier,
rank 256 for the L tier).  Like the reference, this builds no running
two-tier server: the host-side router that would glue the two is the
serving engine's.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import router as router_mod
from repro_torch.launch import counting
from repro_torch.launch import specs as case_specs
from repro_torch.launch.mesh import Mesh, dryrun_world

TIER_SHAPE = (16, 16)


def make_tier_meshes(shape: Optional[Tuple[int, int]] = None,
                     device: str = "cpu") -> Tuple[Mesh, Mesh]:
    """Two disjoint (data, model) meshes of ``shape`` each (default
    16 x 16) over the ranks of the started world, in rank order: S tier
    first, L tier second."""
    from torch.distributed.device_mesh import DeviceMesh
    shape = TIER_SHAPE if shape is None else tuple(shape)
    per = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < 2 * per:
        raise RuntimeError(
            f"tier split needs {2 * per} ranks for two {shape} meshes, have "
            f"{have} (the dry run's 512-rank world provides the default "
            "2 x (16, 16))")
    dev = torch.device(device)
    return tuple(
        Mesh(DeviceMesh(dev.type,
                        torch.arange(i * per, (i + 1) * per).reshape(shape),
                        mesh_dim_names=("data", "model")), dev)
        for i in range(2))


@dataclass
class TierSplitReport:
    s_compile: Dict[str, Any]
    l_compile: Dict[str, Any]
    beta_bytes_per_step: int          # escalation link traffic


def lower_tier_split(cfg: ModelConfig, shape: ShapeConfig, *,
                     capacity_factor: float = 0.5, s_scale: int = 4
                     ) -> TierSplitReport:
    """Count each tier's decode step on its own pod; report per-rank
    ``chips`` and ``peak_gb_per_device`` (the counter's high-water mark)
    and the inter-pod escalation bytes (the paper's beta)."""
    s_cfg = cfg.s_variant(s_scale)
    b = shape.global_batch
    cap = router_mod.capacity_for(b, capacity_factor)
    cap = max(16, (cap // 16) * 16)      # keep shardable on the L mesh
    per = math.prod(TIER_SHAPE)

    reports = {}
    for i, (name, mcfg, batch) in enumerate((("s", s_cfg, b),
                                             ("l", cfg, cap))):
        with dryrun_world(2 * per, rank=i * per):
            mesh = make_tier_meshes()[i]
            fn, args, _, _ = case_specs.make_decode_case(
                mcfg, dataclasses.replace(shape, global_batch=batch), mesh)
            _, counts = counting.count(fn, args)
        reports[name] = {"chips": mesh.world, "plan": fn.plan,
                         "peak_gb_per_device": counts.peak_bytes / 1e9}

    # the offload link: escalated tokens out (cap x 1 int32) + logits back
    # (cap x vocab float32) per step
    beta = cap * 4 + cap * cfg.vocab_size * 4
    return TierSplitReport(reports["s"], reports["l"], beta)
