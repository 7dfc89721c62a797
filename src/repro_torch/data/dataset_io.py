"""Versioned on-disk dataset format: one uncompressed ``.npz``
(counterpart of ``repro.data.dataset_io``, the same format, so a file
saved by either package loads in the other).

Layout (format ``repro.data``, version 1)::

    meta          uint8   JSON: {"format", "version", "name", "num_classes"}
    indptr        int32   (n+1,)  CSC row pointers (paper's R vector)
    indices       int32   (nnz,)  CSC column indices (paper's C vector)
    features      float32 (n, D)
    labels        int32   (n,)    -1 where unlabeled
    labeled_mask  bool    (n,)    the split mask partitioning balances on

``save_dataset`` writes with ``np.savez`` (stored, never deflated), so each
member is a contiguous ``.npy`` inside the archive, and ``load_dataset``
can memory-map the big arrays in place: it finds each member's data
offset from the zip local-file header and hands it to ``np.memmap``.  The
maps are copy-on-write, so the graph's tensors wrap them without a copy
and a stray write never reaches the file.  v1's int32 CSC tops out at
2^31 - 1 edges; ``save_dataset`` refuses more.
"""
from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch

from repro_torch.core.graph import CSCGraph
from repro_torch.data.synthetic_graph import GraphDataset

# the format's name and version, shared with repro.data.dataset_io: the
# files are the same
FORMAT_NAME = "repro.data"
FORMAT_VERSION = 1
_ARRAY_FIELDS = ("indptr", "indices", "features", "labels", "labeled_mask")


def save_dataset(ds: GraphDataset, path: str) -> str:
    """Write ``ds`` to ``path`` (``.npz`` appended if missing); returns
    the path written."""
    path = str(path)
    if not path.endswith(".npz"):
        path += ".npz"
    indptr, indices = ds.graph.numpy()
    nnz = int(indptr[-1])
    if nnz > np.iinfo(np.int32).max:
        raise ValueError(
            f"dataset has {nnz:,} edges, beyond the int32 limit of "
            f"format v{FORMAT_VERSION}")
    meta = json.dumps({
        "format": FORMAT_NAME,
        "version": FORMAT_VERSION,
        "name": ds.name,
        "num_classes": int(ds.num_classes),
    })
    labels = np.asarray(ds.labels, np.int32)
    np.savez(path,
             meta=np.frombuffer(meta.encode("utf-8"), dtype=np.uint8),
             indptr=np.asarray(indptr, np.int32),
             indices=np.asarray(indices, np.int32),
             features=np.asarray(ds.features, np.float32),
             labels=labels,
             labeled_mask=labels >= 0)
    return path


def _mmap_npz_member(path: str, info: zipfile.ZipInfo):
    """Copy-on-write ``np.memmap`` of one stored ``.npy`` member in place,
    or None when it cannot be mapped (compressed, or an unknown header),
    and the caller reads it instead."""
    if info.compress_type != zipfile.ZIP_STORED:
        return None
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        hdr = f.read(30)                       # zip local file header
        if len(hdr) != 30 or hdr[:4] != b"PK\x03\x04":
            return None
        name_len = int.from_bytes(hdr[26:28], "little")
        extra_len = int.from_bytes(hdr[28:30], "little")
        f.seek(info.header_offset + 30 + name_len + extra_len)
        try:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = \
                    np.lib.format.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, fortran, dtype = \
                    np.lib.format.read_array_header_2_0(f)
            else:
                return None
        except ValueError:
            return None
        offset = f.tell()
    if dtype.hasobject:
        return None
    return np.memmap(path, dtype=dtype, mode="c", offset=offset,
                     shape=shape, order="F" if fortran else "C")


def load_dataset(path: str, *, mmap: bool = True) -> GraphDataset:
    """Load a ``repro.data`` dataset.  With ``mmap=True`` (the default)
    the array members are memory-mapped from inside the archive;
    ``mmap=False`` reads them into memory.  Raises ``ValueError`` on a
    wrong or newer format, or a split mask that disagrees with the
    labels."""
    path = str(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no dataset at {path!r}")
    with np.load(path, allow_pickle=False) as z:
        if "meta" not in z.files:
            raise ValueError(
                f"{path!r} is not a {FORMAT_NAME} dataset (no meta member)")
        meta = json.loads(bytes(z["meta"]).decode("utf-8"))
        if meta.get("format") != FORMAT_NAME:
            raise ValueError(f"{path!r}: unknown format "
                             f"{meta.get('format')!r}")
        if int(meta.get("version", 0)) > FORMAT_VERSION:
            raise ValueError(
                f"{path!r} is format version {meta['version']}, newer than "
                f"this reader ({FORMAT_VERSION})")
        missing = [k for k in _ARRAY_FIELDS if k not in z.files]
        if missing:
            raise ValueError(f"{path!r} is missing members {missing}")
        arrays = {}
        if mmap:
            with zipfile.ZipFile(path) as zf:
                for k in _ARRAY_FIELDS:
                    arrays[k] = _mmap_npz_member(path, zf.getinfo(k + ".npy"))
        for k in _ARRAY_FIELDS:
            if arrays.get(k) is None:
                arrays[k] = z[k]

    # the stored split mask doubles as an integrity check (one O(n) scan)
    if not np.array_equal(np.asarray(arrays["labeled_mask"]),
                          np.asarray(arrays["labels"]) >= 0):
        raise ValueError(
            f"{path!r}: labeled_mask disagrees with labels — corrupt or "
            f"hand-edited file")

    graph = CSCGraph(indptr=torch.from_numpy(arrays["indptr"]),
                     indices=torch.from_numpy(arrays["indices"]))
    return GraphDataset(graph=graph, features=arrays["features"],
                        labels=arrays["labels"],
                        num_classes=int(meta["num_classes"]),
                        name=str(meta["name"]))
