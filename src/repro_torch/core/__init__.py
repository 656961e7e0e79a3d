"""Gradient-sync core: bucket plans, the CommSchedule IR and its emitter,
strategies, the ZeRO-1 StepProgram, the pipeline planner, GradSync and
the paper's KVStore (``repro/core``)."""
from repro_torch.core.buckets import Bucket, BucketPlan, LeafInfo, make_bucket_plan
from repro_torch.core.kvstore import GradSync, GradSyncConfig, KVStore, SyncPlan, plan_sync
from repro_torch.core.pipeline_program import PipelinePlan, compose_step, plan_pipeline
from repro_torch.core.registry import (
    get_reducer,
    get_strategy,
    reducer_names,
    register_reducer,
    register_strategy,
    strategy_names,
)
from repro_torch.core.schedule import CollectiveOp, CommSchedule, execute
from repro_torch.core.stepprogram import (
    StepProgram,
    build_step_program,
    zero1_bucket_plan,
    zero1_schedule,
)
from repro_torch.core.strategies import make_reducer

__all__ = [
    "Bucket",
    "BucketPlan",
    "CollectiveOp",
    "CommSchedule",
    "GradSync",
    "GradSyncConfig",
    "KVStore",
    "LeafInfo",
    "PipelinePlan",
    "StepProgram",
    "SyncPlan",
    "build_step_program",
    "compose_step",
    "execute",
    "get_reducer",
    "get_strategy",
    "make_bucket_plan",
    "make_reducer",
    "plan_pipeline",
    "plan_sync",
    "reducer_names",
    "register_reducer",
    "register_strategy",
    "strategy_names",
    "zero1_bucket_plan",
    "zero1_schedule",
]
