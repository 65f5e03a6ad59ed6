"""splatt_tpu_torch — CPD-ALS on an NVIDIA GPU with PyTorch and CUDA.

The port of ``splatt_tpu`` (JAX on a TPU), which stays beside it as the
reference.  It imports neither JAX nor anything of ``splatt_tpu``.  Entry
points run on the card unless the caller passes ``device="cpu"``.
"""

from splatt_tpu_torch.blocked import BlockedSparse
from splatt_tpu_torch.config import Options
from splatt_tpu_torch.cpd import cpd_als
from splatt_tpu_torch.io import load
from splatt_tpu_torch.ops.mttkrp import mttkrp
from splatt_tpu_torch.version import (__version__, version_major,
                                      version_minor, version_patch)

__all__ = ["load", "BlockedSparse", "cpd_als", "mttkrp", "Options",
           "__version__", "version_major", "version_minor", "version_patch"]
