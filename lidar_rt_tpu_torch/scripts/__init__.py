"""Command-line workflows beside the CLI, named after the reference's
`scripts/` files:

  * `import_reference_ckpt`: a checkpoint trained with the original
    LiDAR-RT (`.pth`) -> a port checkpoint where `cli train --resume` and
    `cli eval` find it;
  * `import_roundtrip`: that workflow end to end from a port checkpoint
    (export to `.pth`, import, fine-tune, eval);
  * `e2e_rehearsal`: the rehearsal datasets, `cli train` and `cli eval` on
    them, and the record in `E2E_r05.json`'s schema;
  * `kernel_microbench`, `bf16_microbench`: the reference's two probe
    kernels as H100 kernels (the forward body's ablation ladder; float32
    against packed bfloat16);
  * `densify_stats`: the densification statistic of the rehearsal's Waymo
    scene in each of the port's training paths from one state.
"""
