"""Command-line workflows beside the CLI, named after the reference's
`scripts/` files:

  * `import_reference_ckpt`: a checkpoint trained with the original
    LiDAR-RT (`.pth`) -> a port checkpoint where `cli train --resume` and
    `cli eval` find it;
  * `import_roundtrip`: that workflow end to end from a port checkpoint
    (export to `.pth`, import, fine-tune, eval).
"""
