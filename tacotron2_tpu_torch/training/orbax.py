"""Reading the JAX package's Orbax checkpoints without JAX.

Counterpart of the reading half of ``tacotron2_tpu/training/checkpoint.py``
(``load_model``, ``load_train``, ``has_train_state``). A checkpoint is a
directory: ``config.json``, ``model/`` (``{"params", "model_state"}``) and,
for a resumable one, ``train/`` (``{"opt_state", "step"}``). Each of the
two items is an Orbax PyTree checkpoint: ``_METADATA`` lists the tree's
leaves (``tree_metadata``: each key's path with its kinds, a dict key or a
sequence index, and whether the leaf holds an array), and each array is a
``zarr`` (or ``zarr3``) array under its dot-joined path in an ``ocdbt``
key-value store (or plain files) rooted at the item's directory.

This module reads them with ``tensorstore`` alone, imported when a
checkpoint is read: Orbax itself imports JAX. Without ``tensorstore``
reading raises; ``python -m tacotron2_tpu_torch convert`` on a machine that
has it writes the port's ``.ckpt``, which loads anywhere.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np

SEQUENCE_INDEX = 1  # orbax's key_type of a list or tuple index (a dict key is 2)
NO_TENSORSTORE = ("reading an Orbax checkpoint directory needs the tensorstore package, which is "
                  "not installed here: run `python -m tacotron2_tpu_torch convert <orbax_dir> "
                  "<out.ckpt>` on a machine that has it, and load the .ckpt")


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(NO_TENSORSTORE) from e
    return tensorstore


def has_train_state(ckpt_dir: str) -> bool:
    return os.path.isdir(os.path.join(ckpt_dir, "train"))


def _nest(leaves: Dict[Tuple, Tuple[Any, Tuple[bool, ...]]]):
    """{path: (value, per key whether it is a sequence index)} -> nested
    dicts, lists where the keys were sequence indices."""
    root: Dict = {}
    sequences = set()
    for path, (value, seq) in leaves.items():
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
        sequences.update(path[:d] for d in range(len(path)) if seq[d])

    def build(node, prefix):
        if not isinstance(node, dict):
            return node
        items = {k: build(v, prefix + (k,)) for k, v in node.items()}
        return [items[str(i)] for i in range(len(items))] if prefix in sequences else items

    return build(root, ())


def read_item(item_dir: str) -> dict:
    """One Orbax PyTree item (``model/`` or ``train/``) -> its tree as
    nested dicts and lists of numpy arrays, the tree JAX's ``restore``
    gives; a leaf saved as None (an optimizer's empty state) is None."""
    ts = _tensorstore()
    with open(os.path.join(item_dir, "_METADATA")) as f:
        meta = json.load(f)
    base = "file://" + os.path.abspath(item_dir) + "/"
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    leaves: Dict[Tuple, Tuple[Any, Tuple[bool, ...]]] = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        path = tuple(str(k["key"]) for k in keys)
        seq = tuple(k["key_type"] == SEQUENCE_INDEX for k in keys)
        value = None
        if not entry["value_metadata"].get("skip_deserialize"):
            name = ".".join(path)
            kv = ({"driver": "ocdbt", "base": base, "path": name}
                  if meta.get("use_ocdbt", True) else {"driver": "file", "path": base[7:] + name})
            value = np.asarray(ts.open({"driver": driver, "kvstore": kv}).result().read().result())
        leaves[path] = (value, seq)
    return _nest(leaves)


def read_config(ckpt_dir: str) -> dict:
    """``config.json`` ({} where there is none)."""
    p = os.path.join(ckpt_dir, "config.json")
    if not os.path.exists(p):
        return {}
    with open(p) as f:
        return json.load(f)


def load_model(ckpt_dir: str) -> Tuple[dict, dict, dict]:
    """-> (params, model_state, config.json's dict), numpy on the host (JAX
    ``load_model``)."""
    tree = read_item(os.path.join(ckpt_dir, "model"))
    return tree["params"], tree.get("model_state") or {}, read_config(ckpt_dir)


def load_train(ckpt_dir: str) -> Tuple[Any, int]:
    """-> (opt_state, step) as saved, numpy on the host: the caller maps
    ``opt_state`` onto its optimizer (JAX ``load_train`` checks it against
    the live optimizer's tree)."""
    tree = read_item(os.path.join(ckpt_dir, "train"))
    return tree["opt_state"], int(tree["step"])
