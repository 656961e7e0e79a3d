from repro_torch.checkpoint.manager import CheckpointManager, restore, save
from repro_torch.checkpoint.reshard import reshard

__all__ = ["CheckpointManager", "reshard", "restore", "save"]
