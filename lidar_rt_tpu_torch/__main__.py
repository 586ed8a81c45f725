"""`python -m lidar_rt_tpu_torch {train,eval} ...`: the CLI
(`lidar_rt_tpu_torch.cli`)."""

from lidar_rt_tpu_torch.cli import main

main()
