"""evdr_tpu_torch — the PyTorch/CUDA port of evdr_tpu.

Multi-vector visual-document retrieval with masked MaxSim late-interaction
scoring, served on an NVIDIA GPU through hand-written CUDA kernels. The JAX
package ``evdr_tpu`` is the reference the port is tested against; this
package imports neither it nor JAX.

Layout
------
- ``evdr_tpu_torch.data``     npz payload I/O, ragged->dense packing, masks
- ``evdr_tpu_torch.ops``      MaxSim: torch oracle, CUDA kernels + plain versions
- ``evdr_tpu_torch.parallel`` the single-device index and top-k
- ``evdr_tpu_torch.tools``    packed-file conversion, search CLI, HTTP server
- ``evdr_tpu_torch.convert``  an index built by evdr_tpu -> the port
"""

from evdr_tpu_torch.engine import RetrievalEngine

__version__ = "0.1.0"
