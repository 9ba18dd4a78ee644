"""Carry state across from the JAX package.

The chain has no learned weights; its state is the stage configurations,
the pm carrier carry and the Fano metric table.  These helpers build the
port's counterparts from the JAX package's objects (duck-typed: nothing
here imports JAX), so a test can start both packages from identical
state.  Fields that only select a JAX/TPU execution backend
(``search_backend``, ``csum_backend``, ``viterbi_backend``, ...) have no
counterpart and are dropped.  The code spec is shared: both packages use
the one ``isee3_decoder_tpu.config.CodeSpec``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from isee3_decoder_tpu_torch.models.decode import DecodeConfig
from isee3_decoder_tpu_torch.models.pipeline import PipelineConfig
from isee3_decoder_tpu_torch.ops.carrier import PMCarry, PMConfig
from isee3_decoder_tpu_torch.ops.symbols import SymConfig


def torch_dtype(dtype) -> torch.dtype:
    """A jnp / numpy dtype → the torch dtype of the same name."""
    return getattr(torch, np.dtype(dtype).name)


def _fields(cls, src, **override):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in override:
            kw[f.name] = override[f.name]
        elif hasattr(src, f.name):
            kw[f.name] = getattr(src, f.name)
    return cls(**kw)


def pm_config(src) -> PMConfig:
    return _fields(PMConfig, src, dtype=torch_dtype(src.dtype))


def sym_config(src) -> SymConfig:
    return _fields(SymConfig, src)


def decode_config(src) -> DecodeConfig:
    return _fields(DecodeConfig, src)


def pipeline_config(src) -> PipelineConfig:
    return PipelineConfig(
        pm=pm_config(src.pm), sym=sym_config(src.sym),
        decode=decode_config(src.decode),
    )


def pm_carry(src, device=None) -> PMCarry:
    """A JAX PMCarry (or any pair of arrays) → float32 PMCarry."""
    return PMCarry(
        search_center=torch.as_tensor(np.array(src.search_center),
                                      dtype=torch.float32, device=device),
        cn0=torch.as_tensor(np.array(src.cn0), dtype=torch.float32,
                            device=device),
    )


def mettab(src, device=None) -> torch.Tensor:
    """A (2, 256) metric table → int32 tensor."""
    return torch.as_tensor(np.asarray(src), dtype=torch.int32, device=device)
