"""Data layer: sensor frame containers, dataset loaders, scene assembly
(counterpart of `lidar_rt_tpu.data`).

- frames:     LiDARFrames: range images + poses + SensorGrid, on a device
- synthetic:  procedural scenes with analytic ground truth
- kitti:      KITTI-360 velodyne/bbox/pose loader
- waymo:      Waymo TFRecord loader (protobuf wire parsing, no TF; the
              C++ ingest in `native/` when it builds)
- proto_wire: the protobuf wire-format reader
- writers:    Waymo TFRecord and KITTI-360 tree writers
- build:      point-cloud scene assembly
"""
