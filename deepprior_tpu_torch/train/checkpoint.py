"""Checkpoints with a config fingerprint (counterpart of
deepprior_tpu/train/checkpoint.py).

The reference pickles per-layer parameter values with a config-string
fingerprint, prints a unified diff on a mismatch and recovers by shape
matching (reference src/net/netbase.py:405-477).  The port's checkpoint is
one file of its own format:

    MAGIC | fingerprint length (8 LE) | fingerprint JSON
          | keys length (8 LE) | top-level keys JSON | torch.save payload

The tree is a nested dict whose leaves are tensors, numpy arrays or Python
scalars; a state dict may sit anywhere in it, and its dotted keys
(``conv1.weight``) count as paths (``("conv1", "weight")``), so that shape
recovery matches a state dict's entries by their trailing names as the JAX
package matches a pytree's.  The payload is the flat {path tuple: leaf}
dict with numpy leaves as tensors, read back with ``weights_only=True``.
The fingerprint and the tree are written to a temporary file that replaces
the target in one ``os.replace``, so they commit together.

The readers (``checkpoint_keys``, ``checkpoint_config``,
``read_checkpoint``, ``load_checkpoint``) also take the JAX package's
serving checkpoints (deepprior_tpu/train/checkpoint.py: ``b"DPTPU1\x00"``,
a network_prior.ckpt or a net_<prefix>.ckpt of its training mains), read
by train/jax_checkpoint.py without jax: the flax "params" and
"batch_stats" become the port model's state dict under "params"
(utils/convert.py::state_dict_from_flax), the other leaves stay as they
are, and the tree goes through the same matching and shape recovery.  A
JAX training snapshot raises ValueError: its optimizer state is optax's,
not the port's.
"""

from __future__ import annotations

import difflib
import io
import json
import os
import shutil
from typing import Any, Dict, Tuple

import numpy as np
import torch

from deepprior_tpu_torch.train.jax_checkpoint import is_jax_checkpoint, read_jax_checkpoint

MAGIC = b"DPTTC1\x00"


def _fingerprint(config: Any) -> str:
    """Stable JSON description of a config object."""

    def default(o):
        if hasattr(o, "_asdict"):
            return o._asdict()
        if isinstance(o, (np.ndarray, torch.Tensor)):
            return {"__array__": list(o.shape), "dtype": str(o.dtype)}
        if isinstance(o, type):
            return o.__name__
        return str(o)

    return json.dumps(config, default=default, sort_keys=True, indent=1)


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], Any]:
    """{path tuple: leaf} of a nested dict; dotted keys split into paths."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + tuple(str(k).split("."))))
    else:
        out[prefix] = tree
    return out


def _like(target, flat, prefix=()):
    """``target``'s structure (dotted keys kept) with each leaf taken from
    ``flat`` by its path and given the target leaf's kind: a numpy array
    for a numpy leaf, a tensor on the target's device for a tensor leaf."""
    if isinstance(target, dict):
        return {k: _like(v, flat, prefix + tuple(str(k).split(".")))
                for k, v in target.items()}
    value = flat[prefix]
    if isinstance(target, (np.ndarray, np.generic)):
        return np.asarray(torch.as_tensor(value).numpy())
    if isinstance(target, torch.Tensor):
        return torch.as_tensor(value).to(target.device)
    return value


def _to_payload(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    if isinstance(leaf, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(leaf))
    return leaf


def _shape(leaf):
    shape = getattr(leaf, "shape", None)
    return None if shape is None else tuple(shape)


def save_checkpoint(path: str, tree: Any, config: Any = None) -> None:
    """Write the tree and the config fingerprint.  Atomic: a temporary file
    replaces ``path``.  A sharded checkpoint directory at ``path`` (a run
    with --sharded-snapshots, train/checkpoint_sharded.py) is replaced, as
    the rolling snapshot's contract is overwrite; so is an empty directory
    (a sharded save interrupted before its first marker).  A directory that
    holds anything else raises IsADirectoryError: an output directory
    passed where a file belongs is never removed."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if os.path.isdir(path):
        from deepprior_tpu_torch.train.checkpoint_sharded import MARKERS

        if not set(os.listdir(path)) <= MARKERS:
            raise IsADirectoryError(
                f"refusing to overwrite non-checkpoint directory {path}")
        shutil.rmtree(path)
    flat = {k: _to_payload(v) for k, v in _flatten(tree).items()}
    buf = io.BytesIO()
    torch.save(flat, buf)
    fp = _fingerprint(config).encode()
    keys = json.dumps(sorted({k[0] for k in flat if k})).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        for blob in (fp, keys):
            f.write(len(blob).to_bytes(8, "little"))
            f.write(blob)
        f.write(buf.getvalue())
    os.replace(tmp, path)


def _read_header(f, path):
    if f.read(len(MAGIC)) != MAGIC:
        raise ValueError(f"{path} is not a deepprior_tpu_torch checkpoint")
    fp = f.read(int.from_bytes(f.read(8), "little")).decode()
    keys = json.loads(f.read(int.from_bytes(f.read(8), "little")).decode())
    return fp, set(keys)


def _read_jax(path) -> Tuple[str, Dict[Tuple[str, ...], Any], str]:
    """(fingerprint, flat tree, family) of a JAX package checkpoint, its flax
    variables as the port's state dict under "params"."""
    from deepprior_tpu_torch.utils.convert import state_dict_from_flax

    fp, tree = read_jax_checkpoint(path)
    if "opt_state" in tree or "params" not in tree:
        raise ValueError(
            f"{path} is a JAX package training snapshot (or no model checkpoint); only "
            "the JAX package's serving checkpoints are read (network_prior.ckpt, "
            "net_<prefix>.ckpt): its optax state is not the port's optimizer state")
    family, sd = state_dict_from_flax({"params": tree.pop("params"),
                                       "batch_stats": tree.pop("batch_stats", None) or {}})
    tree["params"] = sd
    flat = {k: torch.from_numpy(np.array(v)) if isinstance(v, (np.ndarray, np.generic)) else v
            for k, v in _flatten(tree).items()}
    return fp, flat, family


def checkpoint_keys(path: str) -> set:
    """Top-level key names of a stored checkpoint tree, read from the
    header alone (the payload, the parameters, is not loaded; a JAX package
    checkpoint is read whole)."""
    if is_jax_checkpoint(path):
        return {k[0] for k in _read_jax(path)[1] if k}
    with open(path, "rb") as f:
        return _read_header(f, path)[1]


def checkpoint_config(path: str) -> Any:
    """The stored config fingerprint, parsed (None when the checkpoint was
    saved without a config), read from the port format's header alone."""
    if is_jax_checkpoint(path):
        return json.loads(read_jax_checkpoint(path)[0])
    with open(path, "rb") as f:
        return json.loads(_read_header(f, path)[0])


def read_checkpoint(path: str) -> Tuple[str, Dict[Tuple[str, ...], Any], Any]:
    """(fingerprint, flat tree, model family) of a checkpoint of either
    format, read whole once.  A JAX package checkpoint's family is read off
    its flax tree, the port's from its config's "model" field (None when
    the config does not say)."""
    if is_jax_checkpoint(path):
        return _read_jax(path)
    with open(path, "rb") as f:
        fp, _ = _read_header(f, path)
        flat = torch.load(io.BytesIO(f.read()), map_location="cpu", weights_only=True)
    config = json.loads(fp)
    return fp, flat, config.get("model") if isinstance(config, dict) else None


def load_checkpoint(
    path: str, target: Any, config: Any = None, strict: bool = False, stored=None
) -> Tuple[Any, bool]:
    """Restore a tree into ``target``'s structure (``stored``: the
    ``read_checkpoint(path)`` the caller already holds, else it is read).

    A config mismatch prints a unified diff (netbase.py:440-450 semantics)
    and raises with ``strict``.  If the stored paths or shapes do not match
    the target's, leaves are grafted by path suffix, then prefix, and shape
    (the reference's shape-based recovery, netbase.py:451-476); with
    ``strict`` that raises instead.  Returns (tree, exact_match)."""
    stored_fp, flat_raw, _ = stored or read_checkpoint(path)

    exact = True
    if config is not None:
        now_fp = _fingerprint(config)
        if now_fp != stored_fp:
            exact = False
            diff = "\n".join(
                difflib.unified_diff(
                    stored_fp.splitlines(), now_fp.splitlines(),
                    "checkpoint", "current", lineterm="",
                )
            )
            msg = f"checkpoint config mismatch for {path}:\n{diff}"
            if strict:
                raise ValueError(msg)
            print(f"WARNING: {msg}")

    flat_tgt = _flatten(target)
    if set(flat_raw) == set(flat_tgt) and all(
            _shape(flat_raw[k]) == _shape(v) for k, v in flat_tgt.items()):
        return _like(target, flat_raw), exact
    if strict:
        raise ValueError(
            f"{path}: stored paths/shapes do not match the target's "
            f"({len(flat_raw)} stored, {len(flat_tgt)} wanted)")
    # shape-based recovery: graft stored leaves whose path suffix + shape
    # match the target's
    used = set()
    restored = dict(flat_tgt)
    for tkey, tval in flat_tgt.items():
        tshape = _shape(tval)
        best = None
        for rkey, rval in flat_raw.items():
            if rkey in used or _shape(rval) != tshape:
                continue
            # prefer matching trailing path components; break ties by
            # leading components: ('params', ..., 'weight') must pick the
            # stored 'params/...' over 'best/params/...', independent of
            # dict order
            score = (_suffix_score(tkey, rkey), _prefix_score(tkey, rkey))
            if best is None or score > best[0]:
                best = (score, rkey, rval)
        if best is not None and best[0][0] > 0:
            used.add(best[1])
            restored[tkey] = best[2]
    print(
        f"WARNING: structural mismatch for {path}; recovered "
        f"{len(used)}/{len(flat_tgt)} leaves by name/shape match"
    )
    return _like(target, restored), False


def _suffix_score(a: Tuple[str, ...], b: Tuple[str, ...]) -> int:
    s = 0
    for x, y in zip(reversed(a), reversed(b)):
        if x != y:
            break
        s += 1
    return s


def _prefix_score(a: Tuple[str, ...], b: Tuple[str, ...]) -> int:
    s = 0
    for x, y in zip(a, b):
        if x != y:
            break
        s += 1
    return s
