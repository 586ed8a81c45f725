"""Point-cloud viewer (counterpart of the repository's `viewer.py`, the
reference's third entry point).

The reference opens an Open3D window with a height colormap
(viewer.py:11-32).  Hosts here are headless, so this writes an
orthographic top view of the cloud as a PNG with the same colormap, or,
with --o3d and a display, opens Open3D where it is installed.

    python -m lidar_rt_tpu_torch.viewer --pcd output/.../gt_0000.ply \
        [--out view.png] [--o3d]
"""

from __future__ import annotations

import argparse

import numpy as np

from lidar_rt_tpu_torch.utils.export import colormap, read_ply, write_png


def render_views(points: np.ndarray, out_path: str, res: int = 1024) -> None:
    """Write a res x res top view of points (N, 3) to out_path: each
    point's height through the colormap, between the 2nd and 98th
    percentiles, the higher points drawn last."""
    z = points[:, 2]
    lo, hi = np.quantile(z, 0.02), np.quantile(z, 0.98)
    colors = colormap((z - lo) / max(hi - lo, 1e-6))

    img = np.zeros((res, res, 3), np.float32)
    xy = points[:, :2]
    c = xy.mean(axis=0)
    half = np.quantile(np.abs(xy - c), 0.99) or 1.0
    px = np.clip(((xy - c) / half * 0.5 + 0.5) * (res - 1), 0,
                 res - 1).astype(int)
    order = np.argsort(z)
    img[res - 1 - px[order, 1], px[order, 0]] = colors[order]
    write_png(out_path, img)
    print(f"wrote {out_path} ({points.shape[0]} points)")


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pcd", required=True)
    p.add_argument("--out", default="view.png")
    p.add_argument("--o3d", action="store_true")
    a = p.parse_args(argv)
    points, _ = read_ply(a.pcd)
    if a.o3d:
        try:
            import open3d as o3d
            pcd = o3d.geometry.PointCloud()
            pcd.points = o3d.utility.Vector3dVector(points.astype(np.float64))
            z = points[:, 2]
            col = colormap((z - z.min()) / max(np.ptp(z), 1e-6))
            pcd.colors = o3d.utility.Vector3dVector(col.astype(np.float64))
            o3d.visualization.draw_geometries([pcd])
            return
        except ImportError:
            print("open3d not available; writing PNG views instead")
    render_views(points, a.out)


if __name__ == "__main__":
    main()
