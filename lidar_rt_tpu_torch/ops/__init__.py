"""Compute ops: the surfel tracer and its kernels (counterpart of
`lidar_rt_tpu.ops`).

- geometry:     analytic ray <-> surfel-plane intersection math
- composite:    dense oracle renderer (tests), bundle/output containers
- binning:      surfel -> range-image tile binning
- tracer:       public trace()/render_frame(), the plain torch engine
- cuda_tracer:  host side of the kernel path and its plain twin
- kernels:      build, bindings and launch counters of the CUDA kernels
- ssim, chamfer: the training losses' windowed SSIM and Chamfer distance
- knn:          Morton-window nearest neighbours and PCA normals (scene
                initialization)
"""
