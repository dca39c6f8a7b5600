from repro_torch.kernels.mamba_scan.ops import selective_scan

__all__ = ["selective_scan"]
