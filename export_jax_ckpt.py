"""Export a checkpoint of the JAX package (`lidar_rt_tpu`) to a plain `.npz`
that the PyTorch port reads.

    python export_jax_ckpt.py IN.npz [IN.npz ...] --out DIR

Each IN is a file the JAX package's `utils.checkpoint.save` wrote: a
training checkpoint `ckpt_it_N[_good].npz` (its TrainState, or a bare
Scene) or the refine U-Net's `models/unet.npz` (flax variables).  Those
files pickle a jax treedef, which only jax can read.  Each is written to
DIR under its own name as a plain `.npz`, read with `allow_pickle=False`:

  * every array leaf under its dotted pytree path, e.g.
    `scene.background.xyz`, `opt_state_bg.inner_states.xyz.inner_state.0.
    mu.xyz`, `stats_bg.grad_accum`, `params.Conv_0.kernel`; a random key
    as its key data (uint32);
  * `__kind__` = "dict", so that the port's `utils.checkpoint.load` reads
    it as a mapping of dotted names to arrays;
  * `__meta__`, JSON: {"source": "lidar_rt_tpu", "kind": "TrainState",
    "Scene" or "variables", "name": IN's file name, "metadata": the
    checkpoint's own metadata, "static": each asset's `max_sh_degree` and
    `extent`, which the treedef holds and no leaf does}.

`python -m lidar_rt_tpu_torch.scripts.import_jax_ckpt` maps such a file to
the port's TrainState, Scene or U-Net weights.  This script needs jax and
the JAX package; it imports nothing of the port, nor torch.
"""

from __future__ import annotations

import argparse
import json
import os

import jax
import numpy as np

from lidar_rt_tpu.utils import checkpoint

SOURCE = "lidar_rt_tpu"


def _key_name(k) -> str:
    for attr in ("name", "key", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(f"unknown pytree key {k!r}")


def dotted_leaves(tree) -> dict[str, np.ndarray]:
    """Every leaf of a pytree as a numpy array under its dotted path; a
    typed random key becomes its key data."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if hasattr(leaf, "dtype") and jax.dtypes.issubdtype(
                leaf.dtype, jax.dtypes.prng_key):
            leaf = jax.random.key_data(leaf)
        name = ".".join(_key_name(k) for k in path)
        if name in out or name.startswith("__"):
            raise KeyError(f"pytree path {name!r} is not a unique name")
        out[name] = np.asarray(leaf)
    return out


def _plain(value):
    """A numpy or jax scalar of the metadata as a Python number."""
    return np.asarray(value).item()


def _kind(state) -> str:
    if hasattr(state, "opt_state_bg"):
        return "TrainState"
    if hasattr(state, "background"):
        return "Scene"
    return "variables"


def _static(state) -> dict:
    """Each asset's treedef-only fields."""
    scene = getattr(state, "scene", state)
    out = {}
    for part in ("background", "actors"):
        asset = getattr(scene, part, None)
        if asset is not None:
            out[part] = {"max_sh_degree": int(asset.max_sh_degree),
                         "extent": float(asset.extent)}
    return out


def export(path: str, out_path: str) -> dict:
    """Export one checkpoint; returns its metadata record."""
    state, metadata = checkpoint.load(path)
    arrays = dotted_leaves(state)
    meta = {"source": SOURCE, "kind": _kind(state),
            "name": os.path.basename(path), "metadata": metadata,
            "static": _static(state)}
    arrays["__kind__"] = np.asarray("dict")
    arrays["__meta__"] = np.asarray(json.dumps(meta, default=_plain))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        np.savez(f, **arrays)
    return meta


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("paths", nargs="+", metavar="IN.npz")
    p.add_argument("--out", required=True, metavar="DIR")
    a = p.parse_args(argv)
    written = []
    for path in a.paths:
        out = os.path.join(a.out, os.path.basename(path))
        if os.path.abspath(out) == os.path.abspath(path):
            p.error(f"{path}: --out would overwrite the checkpoint itself")
        meta = export(path, out)
        print(f"exported {path} ({meta['kind']}) -> {out}")
        written.append(out)
    return written


if __name__ == "__main__":
    main()
