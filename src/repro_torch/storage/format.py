"""On-disk index format: manifest schema, atomic commit, validation.

The JAX package's format, unchanged (`FORMAT_VERSION = 1`): an index
saved by either package opens in the other.

An index is a *directory*:

    <path>/
      manifest.json             # format version, params, shard table
      breakpoints.npy           # (card-1,) float32 iSAX breakpoints
      envelopes/<field>.npy     # sorted+padded main EnvelopeSet, one flat
                                #   .npy per struct-of-arrays field
      levels/L<k>_<field>.npy   # dense block levels, coarse -> fine
      collection/shard_<i>.npy  # raw series, row-sharded (the shard
                                #   table in the manifest names them)
      delta/<field>.npy         # optional: unsorted ingestion buffer

Distributed saves (kind == "distributed"; `store.save_distributed`, every
rank of a process group writing its own shard) add, all additive under
the same FORMAT_VERSION:

      shards/shard_<s>.npy        # per-shard MAIN raw rows
      delta/shard_<s>.npy         # per-shard uncompacted delta rows
      delta/shard_<s>_gmap.npy    # their GLOBAL series ids (append
                                  #   parts interleave shards, so the
                                  #   local->global map is not affine)
      index/shard_<s>_<field>.npy # per-shard envelope + prefix-sum
                                  #   sections over [main; delta] —
                                  #   with these a distributed open()
                                  #   reads O(index) bytes and never
                                  #   re-runs summarization

The write protocol is an atomic commit:
everything is staged into `<path>.tmp/` and `os.rename`d to `<path>` in
one step — a crashed writer never corrupts the last good index, and a
leftover `*.tmp/` directory is garbage, ignored and GC'd on the next
open or write (tested in tests/test_torch_storage.py).

The manifest is the compatibility gate: `validate_manifest` rejects
unknown format versions and `validate_params` rejects opening an index
under different `EnvelopeParams` — an index built with different
lmin/lmax/seg_len quantizes different envelopes, so a silent open would
return wrong distances, not degraded ones.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Optional

import numpy as np

from repro_torch.core.types import EnvelopeParams

FORMAT_MAGIC = "ulisse-index"
FORMAT_VERSION = 1
MANIFEST = "manifest.json"

# manifest["kind"]
KIND_LOCAL = "local"
KIND_DISTRIBUTED = "distributed"


class IndexFormatError(ValueError):
    """The directory is not a readable index of a supported version."""


class IndexCompatibilityError(IndexFormatError):
    """The index is readable but was built under incompatible params."""


# --------------------------------------------------------------------------
# params (de)serialization
# --------------------------------------------------------------------------

def params_to_dict(p: EnvelopeParams) -> dict:
    return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}


def params_from_dict(d: dict) -> EnvelopeParams:
    return EnvelopeParams(**d)


def validate_params(stored: EnvelopeParams,
                    expected: Optional[EnvelopeParams]) -> None:
    """Fail loudly when an index is opened under different params.

    lmin/lmax/seg_len change which subsequences an envelope represents
    and how many PAA segments it has; card/znorm change the quantization
    — any mismatch silently yields wrong distances, so every differing
    field is named in the error.
    """
    if expected is None or stored == expected:
        return
    diffs = [
        f"{f.name}: index has {getattr(stored, f.name)!r}, "
        f"caller expects {getattr(expected, f.name)!r}"
        for f in dataclasses.fields(stored)
        if getattr(stored, f.name) != getattr(expected, f.name)
    ]
    raise IndexCompatibilityError(
        "index was built under different EnvelopeParams — searching it "
        "with these would return wrong distances (rebuild the index or "
        "open it without `params=` to adopt the stored ones): "
        + "; ".join(diffs))


# --------------------------------------------------------------------------
# manifest i/o + validation
# --------------------------------------------------------------------------

def write_manifest(directory: str, manifest: dict) -> None:
    manifest = dict(manifest, magic=FORMAT_MAGIC,
                    format_version=FORMAT_VERSION)
    with open(os.path.join(directory, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)


def read_manifest(path: str) -> dict:
    """Read + validate `<path>/manifest.json`; raises IndexFormatError."""
    mf = os.path.join(path, MANIFEST)
    if not os.path.isdir(path) or not os.path.exists(mf):
        raise IndexFormatError(
            f"{path!r} is not a ULISSE index (no {MANIFEST}); "
            "was the Writer finalized?")
    with open(mf) as f:
        try:
            manifest = json.load(f)
        except json.JSONDecodeError as e:
            raise IndexFormatError(f"{mf} is not valid JSON: {e}") from e
    if manifest.get("magic") != FORMAT_MAGIC:
        raise IndexFormatError(
            f"{mf} has magic {manifest.get('magic')!r}, "
            f"expected {FORMAT_MAGIC!r}")
    ver = manifest.get("format_version")
    if ver != FORMAT_VERSION:
        raise IndexFormatError(
            f"index format version {ver!r} is not supported by this "
            f"build (supports {FORMAT_VERSION}); rebuild the index or "
            "upgrade the code that wrote it")
    return manifest


# --------------------------------------------------------------------------
# atomic commit protocol
# --------------------------------------------------------------------------

def tmp_path(path: str) -> str:
    return path.rstrip("/\\") + ".tmp"


def stage_dir(path: str, *subdirs: str) -> str:
    """Create a fresh `<path>.tmp/` staging dir (clobbering stale ones)."""
    tmp = tmp_path(path)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    for sub in subdirs:
        os.makedirs(os.path.join(tmp, sub))
    return tmp


def old_path(path: str) -> str:
    return path.rstrip("/\\") + ".old"


def _is_index_dir(path: str) -> bool:
    """True when `path` holds a manifest with our magic (any version)."""
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            return json.load(f).get("magic") == FORMAT_MAGIC
    except (OSError, json.JSONDecodeError):
        return False


def commit(path: str) -> str:
    """Atomically promote `<path>.tmp/` to `<path>`.

    An existing index is renamed aside (`<path>.old/`) BEFORE the new
    one is renamed in, never deleted first — at every instant either
    `<path>` or `<path>.old` is a complete committed index, so a crash
    anywhere in the sequence loses at most the *new* build (recovered
    or GC'd by `gc_stale_tmp` on the next open/write).  Refuses to
    replace a directory that is NOT a ULISSE index: a misconfigured
    target (e.g. an env var pointing at a data folder) must never be
    rmtree'd by a save.
    """
    tmp = tmp_path(path)
    old = old_path(path)
    if os.path.exists(old):
        if os.path.exists(path):
            shutil.rmtree(old)          # superseded by a committed path
        else:
            os.rename(old, path)        # roll back a prior crash first
    if os.path.exists(path) and not _is_index_dir(path):
        shutil.rmtree(tmp, ignore_errors=True)
        raise IndexFormatError(
            f"refusing to replace {path!r}: it exists but is not a "
            "ULISSE index — remove it manually if that is intended")
    had_old = os.path.exists(path)
    if had_old:
        os.rename(path, old)
    os.rename(tmp, path)            # atomic commit
    if had_old:
        shutil.rmtree(old, ignore_errors=True)
    return path


def gc_stale_tmp(path: str) -> bool:
    """Crash recovery: GC a leftover `<path>.tmp/`, and if a crash hit
    the commit window between the two renames (old moved aside, new not
    yet in place), restore `<path>.old/` as `<path>`."""
    changed = False
    tmp = tmp_path(path)
    if os.path.exists(tmp):
        shutil.rmtree(tmp, ignore_errors=True)
        changed = True
    old = old_path(path)
    if os.path.exists(old):
        if os.path.exists(path):
            shutil.rmtree(old, ignore_errors=True)   # superseded copy
        else:
            os.rename(old, path)                     # roll back
        changed = True
    return changed


# --------------------------------------------------------------------------
# flat .npy payloads
# --------------------------------------------------------------------------

def save_array(directory: str, rel: str, arr) -> dict:
    """Write one payload array; returns its shard-table entry."""
    arr = np.asarray(arr)
    np.save(os.path.join(directory, rel), arr)
    return {"file": rel + ".npy", "shape": list(arr.shape),
            "dtype": str(arr.dtype)}


def load_array(directory: str, entry: dict, mmap: bool = False):
    """Load a payload named by its shard-table entry, verifying shape."""
    fp = os.path.join(directory, entry["file"])
    if not os.path.exists(fp):
        raise IndexFormatError(f"payload {entry['file']!r} missing "
                               f"from {directory!r}")
    arr = np.load(fp, mmap_mode="r" if mmap else None)
    if list(arr.shape) != list(entry["shape"]):
        raise IndexFormatError(
            f"payload {entry['file']!r} has shape {list(arr.shape)}, "
            f"manifest says {entry['shape']} — index is corrupt")
    return arr
