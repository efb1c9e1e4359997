"""Carry an index built elsewhere into the port.

`index_from_arrays` takes an index's fields as numpy arrays — the JAX
package's `UlisseIndex` flattened to a dict, or anything written in the
same schema — and rebuilds a port `UlisseIndex` on `device` with every
field unchanged.  Both engines then search an identical plan.

Keys:
  "envelopes.<field>"   for every EnvelopeSet field (types.ENVELOPE_FIELDS);
  "levels.<i>.<field>"  for i = 0 (coarsest) .. L-1 and field in
                        paa_lo / paa_hi / valid;
  "collection.<field>"  data, csum, csum2, center, csum_lo, csum2_lo;
  "breakpoints";
  "delta.<field>"       optional: the unsorted ingestion delta's
                        EnvelopeSet fields (an index after `append`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.index import BlockLevel, UlisseIndex
from repro_torch.core.types import (ENVELOPE_FIELDS, Collection,
                                    DeviceLike, EnvelopeParams, EnvelopeSet,
                                    resolve_device)

_DTYPES = {"paa_lo": torch.float32, "paa_hi": torch.float32,
           "sym_lo": torch.int32, "sym_hi": torch.int32,
           "series_id": torch.int32, "anchor": torch.int32,
           "n_master": torch.int32, "valid": torch.bool}
_COLLECTION = ("data", "csum", "csum2", "center", "csum_lo", "csum2_lo")


def index_from_arrays(arrays: Dict[str, np.ndarray], params: EnvelopeParams,
                      device: DeviceLike = None) -> UlisseIndex:
    """Build a port UlisseIndex from numpy arrays (schema in the module
    docstring), on `device` (default CUDA)."""
    dev = resolve_device(device)

    def tensor(key, dtype):
        # a copy: the source arrays may be read-only views
        return torch.tensor(np.asarray(arrays[key]), dtype=dtype, device=dev)

    env = EnvelopeSet(**{f: tensor(f"envelopes.{f}", _DTYPES[f])
                         for f in ENVELOPE_FIELDS})
    n_levels = len({k.split(".")[1] for k in arrays
                    if k.startswith("levels.")})
    levels = [BlockLevel(paa_lo=tensor(f"levels.{i}.paa_lo", torch.float32),
                         paa_hi=tensor(f"levels.{i}.paa_hi", torch.float32),
                         valid=tensor(f"levels.{i}.valid", torch.bool))
              for i in range(n_levels)]
    coll = Collection(**{f: tensor(f"collection.{f}", torch.float32)
                         for f in _COLLECTION})
    delta = (EnvelopeSet(**{f: tensor(f"delta.{f}", _DTYPES[f])
                            for f in ENVELOPE_FIELDS})
             if "delta.series_id" in arrays else None)
    return UlisseIndex(envelopes=env, levels=levels, collection=coll,
                       breakpoints=tensor("breakpoints", torch.float32),
                       params=params, delta=delta)
