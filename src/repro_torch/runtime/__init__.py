"""Training and serving runtimes."""
from repro_torch.runtime.kvcache import BlockAllocator, PagedLayout
from repro_torch.runtime.serve_loop import (
    ContinuousScheduler,
    RequestQueue,
    SamplingParams,
    Server,
    sharded_argmax,
    sharded_candidates,
    sharded_sample,
)
from repro_torch.runtime.train_loop import (
    RankLost,
    RemeshRequest,
    SimulatedFailure,
    Trainer,
    TrainStep,
    TransientStepError,
    make_train_step,
)

__all__ = ["BlockAllocator", "ContinuousScheduler", "PagedLayout", "RankLost",
           "RemeshRequest", "RequestQueue", "SamplingParams", "Server",
           "SimulatedFailure", "TrainStep", "Trainer", "TransientStepError",
           "make_train_step", "sharded_argmax", "sharded_candidates", "sharded_sample"]
