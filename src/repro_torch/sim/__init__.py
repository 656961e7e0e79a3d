"""The discrete-event CommSchedule simulator and cost-model autotuner
(``repro/sim``).

Predicts, without hardware, how each collective-embedding strategy's
dependency structure lands on a timeline: per-op start/end, exposed
communication, overlap fraction, and step time — from an alpha-beta
network model (``netmodel``), a FLOP-derived compute model (``compute``)
and an event-driven executor over the CommSchedule IR (``engine``).  The
defaults are an H100 SXM's data-sheet figures, or assumptions marked as
such (``compute``, ``netmodel``); a profile fitted from measured runs
(``repro_torch.obs.calibrate``) replaces the network's.

Importing this package registers the ``auto`` strategy (``autotune``):
``--strategy auto`` plans by simulating every fixed strategy and
delegating to the predicted winner.

    PYTHONPATH=src python -m repro_torch.sim --arch resnet50-cifar
    PYTHONPATH=src python -m repro_torch.sim --arch qwen3-1.7b --autotune
"""
from repro_torch.sim.autotune import (
    Prediction,
    choose_pp_schedule,
    flat_step_schedule,
    grid_search,
    last_auto_report,
    plan_auto,
    rank_step_plans,
    rank_strategies,
    sim_config_for,
    simulate_strategy,
)
from repro_torch.sim.compute import (
    ComputeModel,
    HardwareModel,
    PipelineTimeline,
    StagingModel,
    UpdateModel,
    compute_model_for,
    count_params,
    fwd_flops,
    pipeline_timeline,
)
from repro_torch.sim.engine import (
    OpEvent,
    PipelinedTimeline,
    SimConfig,
    Timeline,
    simulate,
    simulate_pipelined,
)
from repro_torch.sim.netmodel import (
    NVLINK,
    POD_LINK,
    LinkModel,
    NetworkModel,
    default_network,
)
from repro_torch.sim.serve import (
    DecodeModel,
    plan_decode,
    rank_decode_plans,
    simulate_decode,
)
from repro_torch.sim.trace import (
    ascii_timeline,
    chrome_trace,
    chrome_trace_events,
    write_chrome_trace,
)

__all__ = [
    "ComputeModel",
    "DecodeModel",
    "HardwareModel",
    "LinkModel",
    "NVLINK",
    "NetworkModel",
    "OpEvent",
    "POD_LINK",
    "PipelineTimeline",
    "PipelinedTimeline",
    "Prediction",
    "SimConfig",
    "StagingModel",
    "Timeline",
    "UpdateModel",
    "ascii_timeline",
    "choose_pp_schedule",
    "chrome_trace",
    "chrome_trace_events",
    "compute_model_for",
    "count_params",
    "default_network",
    "flat_step_schedule",
    "fwd_flops",
    "grid_search",
    "last_auto_report",
    "pipeline_timeline",
    "plan_auto",
    "plan_decode",
    "rank_decode_plans",
    "rank_step_plans",
    "rank_strategies",
    "sim_config_for",
    "simulate",
    "simulate_decode",
    "simulate_pipelined",
    "simulate_strategy",
    "write_chrome_trace",
]
