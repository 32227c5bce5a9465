"""sdr_tpu — accelerator-native software-defined FM broadcast receiver.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
C++/Python SDR course project (mono/stereo FM + RDS from u8 IQ streams):
pure functional block streaming under jit/scan, polyphase filtering as
convolutions and matmuls, a fused u8 front-end kernel for the GPU,
vmap/shard_map channel parallelism and halo-exchange time parallelism over
a device mesh.
"""

from sdr_tpu.config import MODES, ModeConfig, get_mode
from sdr_tpu.models.receiver import Receiver

__version__ = "0.1.0"

__all__ = ["MODES", "ModeConfig", "get_mode", "Receiver", "__version__"]
