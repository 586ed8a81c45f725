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
    against packed bfloat16), each with `--save`/`--against` to hold
    two runs' outputs to the bit; `sass_floor`: each probe kernel's
    instruction floor from its SASS;
  * `densify_stats`: the densification statistic of the rehearsal's Waymo
    scene in each of the port's training paths from one state;
  * `refine_spread`: the refine U-Net over several seeds on a trained
    rehearsal model, per-frame accuracy in eval and train mode and the
    eval metrics of each;
  * `quality_check`: each tracer config's convergence on the synthetic
    scene (how a user picks a tile shape and budget);
  * `nan_forensics`: the first non-finite gradient in training, named by
    loss term, parameter leaf and surfels;
  * `street`: the bench's street scene (131,072 surfels, 64 x 2650), the
    port's one copy, and what the design probes below share;
  * the design probes on it, each a function returning its statistics
    and a command printing the reference's lines (`--device cuda` unless
    `--device cpu`): `survivor_stats` (per-ray gate-passers and live
    pairs, per-row and per-tile demand), `overcount_probe` (the binner's
    footprint overcount), `subtile_demand` (per-sub-tile demand),
    `occlusion_stats` (the T_MIN latch cull), `selection_probe` (K=128
    under three selection rules), `profile_binner` (binner stage times
    and per-tile candidates), `sweep_perf` (tile shape x K on the
    kernels) and `compact_probe` (a compacted design's gather, scatter
    and list costs);
  * `import_jax_ckpt`: checkpoints of the JAX package, exported by the
    repository's `export_jax_ckpt.py`, into the port's format where `cli
    train --resume` and `cli eval` find them.
"""
