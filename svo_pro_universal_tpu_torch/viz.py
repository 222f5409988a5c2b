"""Visualization: trajectory and map plots and point-cloud export.

The port's own copy of ``svo_pro_universal_tpu/viz.py`` (headless
counterpart of the reference's Pangolin viewer, src/visualize/include/svo/
viewer/viewer.h:15-40): ASCII PLY point clouds, and trajectory plots to PNG
through matplotlib, which only ``plot_trajectory`` imports.
"""

from __future__ import annotations

import numpy as np


def export_ply(path: str, points, colors=None) -> None:
    """Write an ASCII PLY point cloud."""
    points = np.asarray(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for i in range(len(points)):
            row = f"{points[i, 0]:.5f} {points[i, 1]:.5f} {points[i, 2]:.5f}"
            if colors is not None:
                c = np.asarray(colors[i]).astype(int)
                row += f" {c[0]} {c[1]} {c[2]}"
            f.write(row + "\n")


def plot_trajectory(path: str, est_positions, gt_positions=None,
                    landmarks=None, title: str = "trajectory") -> None:
    """Top-down (x-z) and side (x-y) trajectory plot to PNG."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    est = np.asarray(est_positions)
    fig, axes = plt.subplots(1, 2, figsize=(11, 5))
    for ax, (i, j), name in zip(axes, [(0, 2), (0, 1)],
                                ["top-down (x-z)", "side (x-y)"]):
        if landmarks is not None and len(landmarks):
            lm = np.asarray(landmarks)
            ax.scatter(lm[:, i], lm[:, j], s=1, c="gray", alpha=0.4,
                       label="landmarks")
        ax.plot(est[:, i], est[:, j], "b-", lw=1.5, label="estimate")
        if gt_positions is not None:
            gt = np.asarray(gt_positions)
            ax.plot(gt[:, i], gt[:, j], "g--", lw=1.0, label="ground truth")
        ax.set_title(name)
        ax.axis("equal")
        ax.legend(fontsize=8)
    fig.suptitle(title)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def dump_map(handler, out_prefix: str) -> None:
    """The current map: landmarks as PLY, keyframe trajectory as PNG."""
    pool = handler.pool
    pts = pool.pos[pool.valid].cpu().numpy()
    export_ply(out_prefix + "_landmarks.ply", pts)
    ring = handler.ring
    kf_pos = ring.frames.T_cam_world.inverse().t[ring.valid].cpu().numpy()
    if len(kf_pos):
        plot_trajectory(out_prefix + "_trajectory.png", kf_pos,
                        landmarks=pts, title="keyframes + landmarks")
