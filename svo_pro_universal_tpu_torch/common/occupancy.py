"""2D occupancy grid as tensor ops.

Counterpart of ``svo_pro_universal_tpu/common/occupancy.py`` (reference
``OccupandyGrid2D``, src/svo_common/include/svo/common/occupancy_grid_2d.h:
10-104): a flat bool grid of static size; marking is a scatter, querying a
gather, never a loop.
"""

from __future__ import annotations

import torch

from svo_pro_universal_tpu_torch.utils.indexing import set_drop


def grid_dims(img_w: int, img_h: int, cell_size: int) -> tuple[int, int]:
    return -(-img_w // cell_size), -(-img_h // cell_size)


def cell_index(px: torch.Tensor, cell_size: int, n_cols: int
               ) -> torch.Tensor:
    """Pixel coords [..., 2] → flat cell index (int32, as the JAX
    package's)."""
    cx = torch.floor(px[..., 0] / cell_size).to(torch.int32)
    cy = torch.floor(px[..., 1] / cell_size).to(torch.int32)
    return cy * n_cols + cx


def make_grid(img_w: int, img_h: int, cell_size: int,
              device=None) -> torch.Tensor:
    n_cols, n_rows = grid_dims(img_w, img_h, cell_size)
    return torch.zeros((n_rows * n_cols,), dtype=torch.bool, device=device)


def set_occupied(grid: torch.Tensor, px: torch.Tensor, mask: torch.Tensor,
                 cell_size: int, n_cols: int) -> torch.Tensor:
    """A new grid with the cells of ``px[mask]`` marked; indices outside
    the grid are dropped."""
    idx = cell_index(px, cell_size, n_cols).long()
    return set_drop(grid, torch.where(mask, idx, grid.shape[0]), True)


def is_occupied(grid: torch.Tensor, px: torch.Tensor, cell_size: int,
                n_cols: int) -> torch.Tensor:
    idx = torch.clamp(cell_index(px, cell_size, n_cols).long(), 0,
                      grid.shape[0] - 1)
    return grid[idx]
