"""npz-based tree checkpointing with structure + dtype round-trip.  Port of
``src/repro/checkpoint/io.py``; a file written by either package loads in
the other.

Leaves are stored under path-encoded keys built as the JAX package builds
them (dict keys in sorted order, list indices, NamedTuple field names);
structure (per-leaf dtype) rides along so bf16 tensors restore as bf16.

Two surfaces:

* ``save_pytree`` / ``load_pytree`` — shape-checked restore *into* a
  reference structure (train states, where the caller always has a
  freshly-initialized ``like`` tree); leaves come back as torch tensors on
  the device of the ``like`` leaf;
* ``save_blob`` / ``load_blob`` — structure-free round-trip of an
  arbitrary JSON-able skeleton (dicts with str keys, lists, scalars,
  None) holding numpy arrays at the leaves.  No reference needed at
  load time and no pickle involved — the skeleton travels as JSON with
  ``{"__npz__": key}`` placeholders for the arrays.  This is what the
  ``repro_torch.dist`` master checkpoints its round-loop state through
  (admitted-pattern history, in-flight results, ledger, RNG state):
  the state's shape depends on the run, so a ``like`` tree cannot
  exist before the load.
"""

from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch

_SEP = "/"


def _flatten_with_paths(tree) -> list[tuple[str, object]]:
    """(key, leaf) pairs in the order ``jax.tree_util`` flattens the same
    tree: dict keys sorted, sequences by index, NamedTuples by field; None
    is an empty subtree."""
    leaves: list[tuple[str, object]] = []
    _walk(tree, (), leaves)
    return leaves


def _walk(t, path: tuple, leaves: list) -> None:
    if t is None:
        return
    if isinstance(t, dict):
        for k in sorted(t):
            _walk(t[k], path + (str(k),), leaves)
    elif isinstance(t, tuple) and hasattr(t, "_fields"):
        for name in t._fields:
            _walk(getattr(t, name), path + (name,), leaves)
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            _walk(v, path + (str(i),), leaves)
    else:
        leaves.append((_SEP.join(path), t))


def _rebuild(t, it):
    """``t``'s structure with its leaves replaced, in flatten order, by ``it``."""
    if t is None:
        return None
    if isinstance(t, dict):
        out = {k: _rebuild(t[k], it) for k in sorted(t)}
        return {k: out[k] for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_rebuild(getattr(t, name), it) for name in t._fields))
    if isinstance(t, (list, tuple)):
        return type(t)(_rebuild(v, it) for v in t)
    return next(it)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, dtype name for the meta); bf16 is stored as f32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def save_pytree(path: str, tree) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    meta = {}
    for key, leaf in _flatten_with_paths(tree):
        arrays[key], meta[key] = _to_numpy(leaf)
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def load_pytree(path: str, like):
    """Restore into the structure of ``like`` (shapes must match)."""
    with np.load(path, allow_pickle=False) as zf:
        meta = json.loads(str(zf["__meta__"]))
        out = []
        for key, ref in _flatten_with_paths(like):
            arr = zf[key]
            dtype = meta[key]
            device = ref.device if isinstance(ref, torch.Tensor) else "cpu"
            if dtype == "bfloat16":
                leaf = torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
            else:
                leaf = torch.from_numpy(np.array(arr, dtype=np.dtype(dtype))).to(device)
            out.append(leaf)
            if tuple(arr.shape) != _shape(ref):
                raise ValueError(
                    f"shape mismatch for {key}: {arr.shape} vs {_shape(ref)}"
                )
    return _rebuild(like, iter(out))


_BLOB_TAG = "__npz__"


def save_blob(path: str, obj) -> str:
    """Serialize a nested dict/list/scalar/ndarray structure to one npz
    file; returns the actual path written (npz extension enforced).
    Dict keys must be strings; scalar leaves must be JSON-able."""
    if not path.endswith(".npz"):
        path += ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: dict[str, np.ndarray] = {}

    def enc(o):
        if isinstance(o, np.ndarray):
            key = f"a{len(arrays)}"
            arrays[key] = o
            return {_BLOB_TAG: key}
        if isinstance(o, np.bool_):
            return bool(o)
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, dict):
            bad = [k for k in o if not isinstance(k, str)]
            if bad:
                raise TypeError(f"blob dict keys must be str, got {bad[:3]}")
            return {k: enc(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [enc(v) for v in o]
        if o is None or isinstance(o, (bool, int, float, str)):
            return o
        raise TypeError(f"blob cannot serialize {type(o).__name__}")

    skeleton = enc(obj)
    np.savez(path, __blob__=json.dumps(skeleton), **arrays)
    return path


def load_blob(path: str):
    """Inverse of :func:`save_blob` (tuples come back as lists).

    A payload that is not a well-formed blob — truncated/garbled zip,
    missing skeleton, broken skeleton JSON, or a skeleton referencing
    an array member the archive lacks — raises ``ValueError`` naming
    the file and what is wrong with it, never a bare
    ``BadZipFile``/``KeyError`` from three layers down."""
    if not path.endswith(".npz"):
        path += ".npz"
    try:
        zf = np.load(path, allow_pickle=False)
    except (zipfile.BadZipFile, ValueError, OSError) as exc:
        # garbage bytes surface from np.load as BadZipFile OR as a bare
        # ValueError (its .npy-fallback mistakes them for pickled data)
        if isinstance(exc, FileNotFoundError):
            raise
        raise ValueError(
            f"corrupted checkpoint blob {path!r}: not a readable npz "
            f"archive ({exc})"
        ) from exc
    with zf:
        try:
            skeleton = json.loads(str(zf["__blob__"]))
        except KeyError as exc:
            raise ValueError(
                f"corrupted checkpoint blob {path!r}: missing __blob__ "
                "skeleton entry (not written by save_blob?)"
            ) from exc
        except (json.JSONDecodeError, zipfile.BadZipFile) as exc:
            raise ValueError(
                f"corrupted checkpoint blob {path!r}: unreadable "
                f"skeleton ({exc})"
            ) from exc

        def dec(o):
            if isinstance(o, dict):
                if set(o) == {_BLOB_TAG}:
                    key = o[_BLOB_TAG]
                    try:
                        return zf[key]
                    except (KeyError, zipfile.BadZipFile, ValueError) as exc:
                        raise ValueError(
                            f"corrupted checkpoint blob {path!r}: "
                            f"skeleton references array {key!r} but the "
                            f"archive cannot deliver it ({exc})"
                        ) from exc
                return {k: dec(v) for k, v in o.items()}
            if isinstance(o, list):
                return [dec(v) for v in o]
            return o

        return dec(skeleton)


def _opt_tree(opt_state, step):
    """The optimizer state as the JAX package saves it: a dict of its fields,
    ``step`` an int32 scalar (the port's ``AdamWState.step`` is a Python int)."""
    tree = opt_state._asdict() if hasattr(opt_state, "_asdict") else dict(opt_state)
    if "step" in tree:
        tree["step"] = np.asarray(step, np.int32)
    return tree


def save_train_state(path: str, params, opt_state, *, step: int, extra=None):
    save_pytree(
        path,
        {
            "params": params,
            "opt": _opt_tree(opt_state, getattr(opt_state, "step", 0)),
            "step": np.asarray(step, np.int32),
            "extra": extra or {},
        },
    )


def restore_train_state(path: str, params_like, opt_like):
    like = {
        "params": params_like,
        "opt": _opt_tree(opt_like, 0),
        "step": np.zeros((), np.int32),
        "extra": {},
    }
    tree = load_pytree(path, like)
    opt = tree["opt"]
    if hasattr(opt_like, "_asdict"):
        fields = dict(opt)
        if "step" in fields:
            fields["step"] = int(fields["step"])
        opt = type(opt_like)(**fields)
    return tree["params"], opt, int(tree["step"])
