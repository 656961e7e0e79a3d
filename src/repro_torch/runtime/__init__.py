"""Training and serving runtimes."""
from repro_torch.runtime.kvcache import BlockAllocator, PagedLayout
from repro_torch.runtime.serve_loop import (
    ContinuousScheduler,
    RequestQueue,
    SamplingParams,
    Server,
    sharded_argmax,
    sharded_sample,
)
from repro_torch.runtime.train_loop import Trainer, TrainStep, make_train_step

__all__ = ["BlockAllocator", "ContinuousScheduler", "PagedLayout",
           "RequestQueue", "SamplingParams", "Server", "TrainStep", "Trainer",
           "make_train_step", "sharded_argmax", "sharded_sample"]
