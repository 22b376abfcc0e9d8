"""The linear decode of the device path.

Decoding any full-rank linear code is itself linear, so on the device the
whole decode collapses to one combine ``blocks = D @ results`` with
D = pinv(M), computed on the host.  (The JAX package's peeling/rooting
decoder of the host master/worker path is not part of this port yet.)
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


class DecodingError(RuntimeError, ValueError):
    """Collected results cannot be decoded (rank-deficient coefficient rows).

    Subclasses both RuntimeError (historical) and ValueError so callers that
    treat rank loss as bad input -- e.g. ``CodedMatmulPlan.with_survivors``
    validation -- catch it either way.
    """


def decode_matrix(M: sp.spmatrix | np.ndarray) -> np.ndarray:
    """D = M^+ in R^{mn x K}: decoding as a single linear combine."""
    M = sp.csr_matrix(M).toarray()
    return np.linalg.pinv(M)
