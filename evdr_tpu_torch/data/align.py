"""docid alignment of init-index arrays to teacher order.

Parity with reference ``utils/utils.py:106-138``: permute the 'other' arrays to
match the reference docid order iff every ref docid exists in 'other' and the
lengths match; otherwise return the inputs unchanged with ok=False.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from evdr_tpu_torch.data.packing import _as_object_array


def align_by_docid(
    docid_ref: np.ndarray,
    docid_other: Optional[np.ndarray],
    *arrays_to_perm: Optional[np.ndarray],
) -> Tuple[Tuple[Optional[np.ndarray], ...], bool]:
    if docid_other is None:
        return arrays_to_perm, False

    docid_ref = _as_object_array(docid_ref)
    docid_other = _as_object_array(docid_other)
    if len(docid_other) != len(docid_ref):
        return arrays_to_perm, False

    idx_of = {str(docid_other[i]): i for i in range(len(docid_other))}
    perm = np.empty(len(docid_ref), dtype=np.int64)
    for i in range(len(docid_ref)):
        j = idx_of.get(str(docid_ref[i]))
        if j is None:
            return arrays_to_perm, False
        perm[i] = j

    out = []
    for arr in arrays_to_perm:
        if arr is None:
            out.append(None)
        else:
            out.append(_as_object_array(arr)[perm])
    return tuple(out), True
