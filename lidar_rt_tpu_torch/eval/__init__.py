"""Evaluation (counterpart of `lidar_rt_tpu.eval`): the metric suite
(`metrics`), LPIPS (`lpips`) and the eval runner (`runner`, eval.py's
counterpart)."""
