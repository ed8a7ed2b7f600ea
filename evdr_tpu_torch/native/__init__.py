"""Native (C++) host-runtime components, loaded via ctypes.

The compute path is PyTorch and CUDA on the GPU; these cover hot HOST paths
around it (a copy of ``evdr_tpu/native``) —
currently the retrieval-metrics engine driving the training loop's periodic
eval. Every native entry point has a pure-Python/numpy fallback, so the
package works without a toolchain; `python -m evdr_tpu_torch.native.build` (or first
use) compiles the shared library with g++.
"""

from evdr_tpu_torch.native.build import load_library, build_library
from evdr_tpu_torch.native.fast_metrics import (
    build_fast_qrels,
    compute_metrics_from_scores,
    native_available,
    tie_rank_from_docids,
)
