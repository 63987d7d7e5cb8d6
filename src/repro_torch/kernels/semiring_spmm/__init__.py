from repro_torch.kernels.semiring_spmm.ops import spmv_blocked

__all__ = ["spmv_blocked"]
