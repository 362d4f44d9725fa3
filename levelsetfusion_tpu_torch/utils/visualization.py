"""Visualization: energy curves, TSDF heatmaps, warp quiver plots and the
live-field evolution video. Twin of
``levelsetfusion_tpu/utils/visualization.py``, with its file names.

Everything is host-side (numpy, headless Agg backend). matplotlib, and cv2
for the video, are imported when a plot or the video is made, not when this
module is: a machine without them (the H100's has no matplotlib) runs every
experiment, and the CLI records what it did not draw
(``missing_modules``, ``artifact_files``: its ``artifacts_skipped`` event).
A field may be a torch tensor on any device; only what a plot shows is
copied to the host.
"""

from __future__ import annotations

import importlib
import os
from typing import List, Sequence

import numpy as np

PLOT_MODULES = ("matplotlib",)
VIDEO_MODULES = ("matplotlib", "cv2")


def missing_modules(names: Sequence[str] = PLOT_MODULES) -> List[str]:
    """Those of ``names`` that cannot be imported here."""
    missing = []
    for name in names:
        try:
            importlib.import_module(name)
        except ImportError:
            missing.append(name)
    return missing


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _central(field, dim_of_field: int) -> np.ndarray:
    """``field`` on the host; a volume's central y slice."""
    if dim_of_field == 3:
        field = field[:, field.shape[1] // 2]
    if hasattr(field, "detach"):
        field = field.detach().cpu().numpy()
    return np.asarray(field)


def plot_energy_curves(rows: Sequence[dict], path: str) -> None:
    """Per-iteration energy components and warp-update statistics."""
    plt = _pyplot()
    it = [r["iteration"] for r in rows]
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 7), sharex=True)
    for key in ("data_energy", "smoothing_energy", "level_set_energy", "total_energy"):
        ax1.plot(it, [r[key] for r in rows], label=key)
    ax1.set_yscale("log")
    ax1.set_ylabel("energy")
    ax1.legend()
    ax2.plot(it, [r["max_warp_update"] for r in rows], label="max_warp_update")
    ax2.plot(it, [r["mean_warp_update"] for r in rows], label="mean_warp_update")
    ax2.set_yscale("log")
    ax2.set_xlabel("iteration")
    ax2.set_ylabel("warp update (voxels)")
    ax2.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def field_heatmap(field, path: str, title: str = "TSDF") -> None:
    """2D TSDF field heatmap (x lateral, z depth; a volume's central y
    slice), band-centred colormap."""
    plt = _pyplot()
    field = _central(field, field.ndim)
    fig, ax = plt.subplots(figsize=(6, 6))
    im = ax.imshow(field.T, origin="lower", cmap="RdBu", vmin=-1, vmax=1)
    ax.set_xlabel("x (voxels)")
    ax.set_ylabel("z (voxels)")
    ax.set_title(title)
    fig.colorbar(im, ax=ax, label="Φ")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def warp_quiver(warp, path: str, stride: int = 4, title: str = "warp") -> None:
    """Quiver plot of a 2D warp field (the central slice of a 3D one, its
    (x, z) components)."""
    plt = _pyplot()
    warp = _central(warp, warp.ndim - 1)
    if warp.shape[-1] == 3:
        warp = warp[..., [0, 2]]
    x, z = np.meshgrid(np.arange(0, warp.shape[0], stride),
                       np.arange(0, warp.shape[1], stride), indexing="ij")
    u = warp[::stride, ::stride, 0]
    v = warp[::stride, ::stride, 1]
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.quiver(x, z, u, v, angles="xy", scale_units="xy", scale=1.0, width=0.002)
    ax.set_xlabel("x (voxels)")
    ax.set_ylabel("z (voxels)")
    ax.set_title(title)
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


class FieldEvolutionVideo:
    """cv2 video writer of the live-field evolution: each frame a 2D field
    (a volume's central y slice) in the RdBu colormap. Both modules are
    imported here, so a machine without them fails at construction."""

    def __init__(self, path: str, fps: int = 10):
        import cv2

        self._cv2 = cv2
        self.path = path
        self.fps = fps
        self._writer = None
        self._cmap = _pyplot().get_cmap("RdBu")

    def add_frame(self, field) -> None:
        field = _central(field, field.ndim)
        rgb = (self._cmap((field.T + 1.0) / 2.0)[..., :3] * 255).astype(np.uint8)
        bgr = rgb[::-1, :, ::-1]  # origin lower + RGB->BGR
        if self._writer is None:
            h, w = bgr.shape[:2]
            fourcc = self._cv2.VideoWriter_fourcc(*"mp4v")
            self._writer = self._cv2.VideoWriter(self.path, fourcc, self.fps, (w, h))
        self._writer.write(np.ascontiguousarray(bgr))

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()
            self._writer = None


def artifact_files(rows=(), canonical=None, live=None, warped=None, warp=None) -> List[str]:
    """The files ``write_run_artifacts`` writes for these arguments."""
    named = (("energy.png", rows), ("canonical.png", canonical), ("live.png", live),
             ("warped_live.png", warped), ("warp.png", warp))
    return [name for name, value in named
            if (len(value) if name == "energy.png" else value is not None)]


def write_run_artifacts(out_dir: str, rows: List[dict], canonical=None, live=None,
                        warped=None, warp=None) -> List[str]:
    """The standard plots after a solve, into ``out_dir``; returns their
    file names (``artifact_files``)."""
    os.makedirs(out_dir, exist_ok=True)
    if rows:
        plot_energy_curves(rows, os.path.join(out_dir, "energy.png"))
    if canonical is not None:
        field_heatmap(canonical, os.path.join(out_dir, "canonical.png"), "canonical")
    if live is not None:
        field_heatmap(live, os.path.join(out_dir, "live.png"), "live")
    if warped is not None:
        field_heatmap(warped, os.path.join(out_dir, "warped_live.png"), "warped live")
    if warp is not None:
        warp_quiver(warp, os.path.join(out_dir, "warp.png"))
    return artifact_files(rows, canonical, live, warped, warp)
