from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_train, trains

__all__ = ["flash_attention", "flash_attention_train", "trains"]
