"""Neural models (counterpart of `lidar_rt_tpu.models`): the ray-drop
refinement U-Net (`unet`)."""
