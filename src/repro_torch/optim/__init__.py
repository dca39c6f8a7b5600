from repro_torch.optim import adamw, schedule

__all__ = ["adamw", "schedule"]
