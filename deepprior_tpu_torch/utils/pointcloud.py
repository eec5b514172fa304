"""Point-cloud container for 3D visualization.

Mirrors the reference `VtkPointCloud` surface (reference
src/util/vtkpointcloud.py:38-141): max-points random subsampling and
depth-colored scalars — rendered through matplotlib's 3D axes (headless-
safe) instead of VTK; matplotlib is imported when a cloud is drawn.
The port's own copy of deepprior_tpu/utils/pointcloud.py.
"""

from __future__ import annotations

import numpy as np


class PointCloud:
    def __init__(self, max_num_points: int = 10_000, seed: int = 23455):
        self.max_num_points = max_num_points
        self._rng = np.random.default_rng(seed)
        self.points = np.zeros((0, 3), np.float32)

    def set_points(self, pts: np.ndarray):
        """Store (N, 3) points, randomly subsampled to max_num_points
        (vtkpointcloud.py:60-75)."""
        pts = np.asarray(pts, np.float32).reshape(-1, 3)
        if len(pts) > self.max_num_points:
            idx = self._rng.choice(len(pts), self.max_num_points, replace=False)
            pts = pts[idx]
        self.points = pts
        return self

    def add_point(self, p):
        if len(self.points) < self.max_num_points:
            self.points = np.vstack([self.points, np.asarray(p, np.float32)])
        else:
            i = int(self._rng.integers(0, self.max_num_points))
            self.points[i] = p
        return self

    def clear_points(self):
        self.points = np.zeros((0, 3), np.float32)
        return self

    def render(self, ax=None, s: float = 1.0, alpha: float = 0.4):
        """Scatter with depth-colored scalars; returns the axes."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if ax is None:
            fig = plt.figure(figsize=(5, 5))
            ax = fig.add_subplot(111, projection="3d")
        if len(self.points):
            ax.scatter(
                self.points[:, 0], self.points[:, 1], self.points[:, 2],
                c=self.points[:, 2], s=s, alpha=alpha, cmap="viridis",
            )
        return ax

    def save(self, path: str):
        ax = self.render()
        ax.figure.savefig(path, bbox_inches="tight", dpi=120)
        import matplotlib.pyplot as plt

        plt.close(ax.figure)
        return path
