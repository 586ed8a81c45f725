"""Sensor data containers (counterpart of `lidar_rt_tpu.data`)."""
