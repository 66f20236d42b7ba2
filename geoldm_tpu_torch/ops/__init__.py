"""Kernel wrappers and their plain versions.

Each wrapper adds one to its module's launch counter where it launches its
kernel. ``LAUNCH_COUNTERS`` names every counter of the model's kernels:
kernel -> (module, attribute). The fused optimizer step keeps its own
(``fused_optim.norm_launches``, ``threshold_launches``, ``update_launches``).
"""

import importlib

LAUNCH_COUNTERS = {
    "egnn_block": ("egnn_block", "launches"),
    "egnn_block_bwd": ("egnn_block", "bwd_launches"),
    "egnn_block_bf16": ("egnn_block", "bf16_launches"),
    "egnn_block_bwd_bf16": ("egnn_block", "bwd_bf16_launches"),
    "egnn_block_lowp": ("egnn_block", "lowp_launches"),
    "egnn_block_bwd_lowp": ("egnn_block", "bwd_lowp_launches"),
    "gcl_rows": ("egnn_tiled", "gcl_rows_launches"),
    "coord_rows": ("egnn_tiled", "coord_rows_launches"),
    "gcl_rows_bf16": ("egnn_tiled", "gcl_rows_bf16_launches"),
    "coord_rows_bf16": ("egnn_tiled", "coord_rows_bf16_launches"),
    "gcl_rows_bwd": ("egnn_tiled", "gcl_rows_bwd_launches"),
    "coord_rows_bwd": ("egnn_tiled", "coord_rows_bwd_launches"),
    "gcl_rows_bwd_bf16": ("egnn_tiled", "gcl_rows_bwd_bf16_launches"),
    "coord_rows_bwd_bf16": ("egnn_tiled", "coord_rows_bwd_bf16_launches"),
    "sp_gcl_rows": ("egnn_sp", "sp_gcl_rows_launches"),
    "sp_coord_rows": ("egnn_sp", "sp_coord_rows_launches"),
    "sp_gcl_rows_bwd": ("egnn_sp", "sp_gcl_rows_bwd_launches"),
    "sp_coord_rows_bwd": ("egnn_sp", "sp_coord_rows_bwd_launches"),
    "sp_gcl_rows_bf16": ("egnn_sp", "sp_gcl_rows_bf16_launches"),
    "sp_coord_rows_bf16": ("egnn_sp", "sp_coord_rows_bf16_launches"),
    "sp_gcl_rows_bwd_bf16": ("egnn_sp", "sp_gcl_rows_bwd_bf16_launches"),
    "sp_coord_rows_bwd_bf16": ("egnn_sp", "sp_coord_rows_bwd_bf16_launches"),
}


def _module(name):
    return importlib.import_module(f"{__name__}.{name}")


def kernel_launches() -> dict:
    """Every kernel's launch count in this process."""
    return {k: getattr(_module(mod), attr) for k, (mod, attr) in LAUNCH_COUNTERS.items()}


def reset_kernel_launches() -> None:
    """Set every launch counter to 0."""
    for mod, attr in LAUNCH_COUNTERS.values():
        setattr(_module(mod), attr, 0)
