"""Training: losses, per-group Adam, density control and the trainer
(counterpart of `lidar_rt_tpu.train`).

- losses:   masked L1/L2/BCE/DSSIM, Chamfer, box regularisation
- optim:    per-asset Adam with the reference's learning-rate schedule
- density:  clone / split / prune and opacity reset, in place
- loop:     `make_train_step`, `Trainer`
- options:  the trainer's options from configs/base.yaml + exp.yaml
- refine:   the U-Net ray-drop refine stage
"""
