from repro_torch.checkpoint.ckpt import CheckpointManager

__all__ = ["CheckpointManager"]
