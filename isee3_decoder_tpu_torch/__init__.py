"""isee3_decoder_tpu_torch — the PyTorch/CUDA port of the ISEE-3/ICE
telemetry receive chain.

Same layout and module names as ``isee3_decoder_tpu`` (the JAX reference
it is held against), so each counterpart sits at the same path:

  config    — code tables and framing constants (the port's own copy,
              held equal to the JAX package's by a test)
  ops       — compute stages; ``*_cuda.py`` hold the hand-written CUDA
              kernels (``csrc/``) beside their plain PyTorch versions
  models    — symdemod, decode and the receive chain composition
  utils     — metric tables, on-device signal synthesis, state transfer
              from the JAX package

Plain functions on tensors with an explicit ``device``; a CUDA tensor
always goes through the kernel, a CPU tensor through the plain version.
TF32 is off everywhere: the chain's float32 sums must stay float32.
"""

import torch

from isee3_decoder_tpu_torch.config import (
    CODES,
    DEFAULT_CODE,
    FRAMEBITS,
    FRAMESYMBOLS,
    SYNCBITS,
    SYNCWORD,
    SYNC_STATE,
    CodeSpec,
    sync_vector,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = [
    "CODES",
    "DEFAULT_CODE",
    "FRAMEBITS",
    "FRAMESYMBOLS",
    "SYNCBITS",
    "SYNCWORD",
    "SYNC_STATE",
    "CodeSpec",
    "sync_vector",
]
