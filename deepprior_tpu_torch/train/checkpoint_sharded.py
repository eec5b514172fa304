"""Sharded, asynchronous checkpoints on ``torch.distributed.checkpoint``
(counterpart of deepprior_tpu/train/checkpoint_sharded.py, which writes
orbax/tensorstore trees).

train/checkpoint.py gathers the whole tree to one process and writes one
file.  This backend keeps tensors sharded end to end:

- save: every rank writes only its shards (a ``DTensor``'s local block;
  a plain tensor that every rank holds is written once); ``async_save``
  stages the tree to host memory and returns while the write drains in the
  background (``wait_until_finished``, or the next save, waits for it);
- restore: each rank reads its blocks straight into the target's tensors,
  in place, whatever the placement that wrote them.

The same fingerprint contract as checkpoint.py: the config's JSON sits next
to the tree and a mismatch raises with the unified diff unless
``allow_mismatch``, which prints it.  No structure recovery: sharded
checkpoints are for resuming a run of the same config; surgery across
architectures goes through checkpoint.py.

Layout of a checkpoint directory:

    fingerprint.json      the committed tree's config
    tree/                 the committed DCP tree (.metadata + __<rank>_*.distcp)
    tree.new/ + fingerprint.json.new
                          a newer committed tree, promoted over tree/ at the
                          next drain point
    tree.tmp/             a tree being written (debris after a crash)

A save writes tree.tmp/ and renames it to tree.new/ once every rank's
write finished, so tree.new/ exists only complete; the promotion replaces
the fingerprint first and then the tree, and a crash at any point leaves a
committed tree paired with its fingerprint (``_fp_for``).

The format is DCP's.  Reading the JAX package's orbax trees is out of scope.
"""

from __future__ import annotations

import difflib
import os
import shutil
from typing import Any, Optional

import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from deepprior_tpu_torch.train.checkpoint import _fingerprint

_FP_NAME = "fingerprint.json"
_FP_NEW_NAME = "fingerprint.json.new"
_TREE_NAME = "tree"
_TREE_NEW_NAME = "tree.new"
_TREE_TMP_NAME = "tree.tmp"
# every name a sharded checkpoint directory may hold (checkpoint.py removes
# a directory of these names only)
MARKERS = frozenset({_FP_NAME, _FP_NEW_NAME, _FP_NEW_NAME + ".tmp", _TREE_NAME,
                     _TREE_NEW_NAME, _TREE_TMP_NAME})


def _distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    if _distributed():
        dist.barrier()


def _committed_tree(path: str) -> Optional[str]:
    """The newest committed tree under ``path``: tree.new when it exists
    (it is newer than tree and complete by construction), else tree."""
    for name in (_TREE_NEW_NAME, _TREE_NAME):
        d = os.path.join(path, name)
        if os.path.isdir(d):
            return d
    return None


def _fp_for(path: str) -> Optional[str]:
    """The fingerprint file paired with the newest committed tree: a
    committed tree.new pairs with fingerprint.json.new while that exists
    (the fingerprint is staged before the tree write starts), otherwise with
    fingerprint.json (the promotion replaces the fingerprint first); a
    committed tree pairs with fingerprint.json.  None when there is no
    committed tree or no paired fingerprint."""
    tree_dir = _committed_tree(path)
    if tree_dir is None:
        return None
    if os.path.basename(tree_dir) == _TREE_NEW_NAME:
        fp_new = os.path.join(path, _FP_NEW_NAME)
        if os.path.exists(fp_new):
            return fp_new
    fp = os.path.join(path, _FP_NAME)
    return fp if os.path.exists(fp) else None


def is_sharded_checkpoint(path: str) -> bool:
    """True when ``path`` holds a restorable sharded checkpoint: a committed
    tree and its paired fingerprint (a crash before the first commit leaves
    debris, not a checkpoint)."""
    return os.path.isdir(path) and _fp_for(path) is not None


def _promote(path: str) -> None:
    """Promote a committed tree.new over tree (rank 0, then a barrier).
    Crash-safe: while the old tree is removed tree.new is intact and
    ``_committed_tree`` prefers it; the last rename is atomic."""
    new_dir = os.path.join(path, _TREE_NEW_NAME)
    if _rank() == 0 and os.path.isdir(new_dir):
        # the fingerprint first: while tree.new exists it pairs with fp.new,
        # so a crash after this line pairs tree.new with the promoted
        # (identical) fingerprint.json
        fp_new = os.path.join(path, _FP_NEW_NAME)
        if os.path.exists(fp_new):
            os.replace(fp_new, os.path.join(path, _FP_NAME))
        old_dir = os.path.join(path, _TREE_NAME)
        if os.path.exists(old_dir):
            shutil.rmtree(old_dir)
        os.rename(new_dir, old_dir)
    _barrier()


class ShardedCheckpointer:
    """One checkpointer reused across snapshots: async saves overlap the
    training and serialize with each other.  Use as a context manager or
    call ``close()``.  Under a process group every rank makes it, saves and
    restores together; async saves run their collectives on a gloo group of
    their own (DCP plans them on a CPU backend, whatever the training's
    group is), so they never interleave with the training's."""

    def __init__(self, async_save: bool = False):
        self.async_save = async_save
        self._future = None
        self._last_path: Optional[str] = None  # the path of the last save
        self._group = None
        if async_save and dist.is_initialized():
            # DCP stages and plans an async save on a CPU backend
            self._group = dist.new_group(backend="gloo")

    # -- lifecycle ----------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self.wait_until_finished()

    def wait_until_finished(self):
        """Block until the last save is written and committed (tree.tmp ->
        tree.new), then promote it over tree."""
        if self._future is not None:
            future, self._future = self._future, None
            future.result()
            self._commit(self._last_path)
        if self._last_path is not None:
            path, self._last_path = self._last_path, None
            _promote(path)

    def _commit(self, path: str) -> None:
        """tree.tmp -> tree.new once every rank's write has finished."""
        _barrier()
        if _rank() == 0:
            os.rename(os.path.join(path, _TREE_TMP_NAME),
                      os.path.join(path, _TREE_NEW_NAME))
        _barrier()

    # -- save / restore -------------------------------------------------
    def save(self, path: str, tree: Any, config: Any = None) -> None:
        """Write the tree (a nested dict of tensors, ``DTensor`` shards and
        Python scalars) and the fingerprint.  A ``DTensor`` leaf is written
        shard by shard by its ranks; do not gather it first.  The tree
        commits as tree.new (at once, or when an async write drains) and is
        promoted over tree at the next drain point (the next save,
        ``wait_until_finished``, ``close``), so the previous committed tree
        stays until then."""
        path = os.path.abspath(path)
        # drain the save in flight first: it commits and promotes
        self.wait_until_finished()
        _promote(path)  # a committed tree.new left by a crashed run
        if _rank() == 0:
            if os.path.isfile(path):
                # a single-file snapshot at the rolling path: the snapshot
                # contract is overwrite, so a format switch replaces it
                os.remove(path)
            stale = os.path.join(path, _TREE_TMP_NAME)
            if os.path.isdir(stale):  # a write a crash interrupted
                shutil.rmtree(stale)
            os.makedirs(path, exist_ok=True)
            # the fingerprint is staged as fp.new before the tree write and
            # promoted with it: written straight to fingerprint.json it
            # would pair the new config with the old committed tree
            fp_new = os.path.join(path, _FP_NEW_NAME)
            with open(fp_new + ".tmp", "w") as f:
                f.write(_fingerprint(config))
            os.replace(fp_new + ".tmp", fp_new)
        _barrier()
        tmp = os.path.join(path, _TREE_TMP_NAME)
        self._last_path = path
        if self.async_save:
            self._future = dcp.async_save(tree, checkpoint_id=tmp,
                                          process_group=self._group)
        else:
            dcp.save(tree, checkpoint_id=tmp)
            self._commit(path)

    def metadata_keys(self, path: str) -> set:
        """The stored tree's top-level key names, from its metadata alone
        (the probe for optional subtrees such as the trainer's best
        tracker, as ``checkpoint.checkpoint_keys``)."""
        tree_dir = _committed_tree(os.path.abspath(path))
        if tree_dir is None:
            raise FileNotFoundError(f"no committed tree under {path}")
        meta = dcp.FileSystemReader(tree_dir).read_metadata()
        return {k.split(".", 1)[0] for k in meta.state_dict_metadata}

    def restore(self, path: str, target: Any, config: Any = None,
                allow_mismatch: bool = False):
        """Read the committed tree into ``target`` (the same structure; its
        tensors and ``DTensor`` shards are filled in place, its Python
        scalars replaced).  Returns (target, fingerprint matched)."""
        path = os.path.abspath(path)
        matched = True
        if config is not None:
            fp_path = _fp_for(path)
            if fp_path is None:
                raise FileNotFoundError(
                    f"no committed checkpoint fingerprint under {path}")
            with open(fp_path) as f:
                stored = f.read()
            now = _fingerprint(config)
            if stored != now:
                matched = False
                diff = "\n".join(difflib.unified_diff(
                    stored.splitlines(), now.splitlines(), "checkpoint config",
                    "current config", lineterm=""))
                if not allow_mismatch:
                    raise ValueError(f"config fingerprint mismatch for {path}:\n{diff}")
                if _rank() == 0:
                    print(f"WARNING: resuming across config change:\n{diff}")
        tree_dir = _committed_tree(path)
        if tree_dir is None:
            raise FileNotFoundError(f"no committed tree under {path}")
        dcp.load(target, checkpoint_id=tree_dir)
        return target, matched


def save_checkpoint_sharded(path: str, tree: Any, config: Any = None) -> None:
    """One synchronous sharded save (``ShardedCheckpointer``)."""
    with ShardedCheckpointer(async_save=False) as ck:
        ck.save(path, tree, config=config)


def load_checkpoint_sharded(path: str, target: Any, config: Any = None,
                            allow_mismatch: bool = False):
    """One sharded restore (``ShardedCheckpointer.restore``)."""
    with ShardedCheckpointer(async_save=False) as ck:
        return ck.restore(path, target, config=config, allow_mismatch=allow_mismatch)
