"""Carry state across from the JAX package.

The chain has no learned weights; its state is the stage configurations,
the pm carrier carry and the Fano metric table.  These helpers build the
port's counterparts from the JAX package's objects (duck-typed: nothing
here imports JAX), so a test can start both packages from identical
state.  Fields that only select a JAX/TPU execution backend
(``search_backend``, ``csum_backend``, ...) have no counterpart and are
dropped; ``pm_backend`` (block scan or fused scan) and
``viterbi_backend`` (classic or fused decoder) carry across as they
are.  The port keeps its own copy of the code tables
(``isee3_decoder_tpu_torch.config``), so a JAX ``CodeSpec`` becomes the
port's equal one through ``code_spec``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from isee3_decoder_tpu_torch.config import CodeSpec
from isee3_decoder_tpu_torch.models.decode import DecodeConfig
from isee3_decoder_tpu_torch.models.pipeline import PipelineConfig
from isee3_decoder_tpu_torch.ops.carrier import PMCarry, PMConfig
from isee3_decoder_tpu_torch.ops.symbols import SymConfig
from isee3_decoder_tpu_torch.ops.viterbi import ViterbiState
from isee3_decoder_tpu_torch.ops.viterbi_inplace import StreamState


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


def code_spec(src) -> CodeSpec:
    """A JAX package CodeSpec → the port's CodeSpec with equal fields."""
    return _fields(CodeSpec, src)


def decode_config(src) -> DecodeConfig:
    return _fields(DecodeConfig, src, code=code_spec(src.code))


def pipeline_config(src) -> PipelineConfig:
    return PipelineConfig(
        pm=pm_config(src.pm), sym=sym_config(src.sym),
        decode=decode_config(src.decode), pm_backend=src.pm_backend,
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


def stream_state(src, device=None) -> StreamState:
    """A JAX rotating-layout StreamState → the port's: int16 metrics, the
    uint32 decision tape as int32 words of the same bits, host-int dp and
    total."""
    return StreamState(
        metrics=torch.as_tensor(np.array(src.metrics), dtype=torch.int16,
                                device=device),
        decisions=torch.as_tensor(
            np.array(src.decisions, np.uint32).view(np.int32), device=device),
        dp=int(src.dp),
        total=int(src.total),
        renorm=torch.as_tensor(np.array(src.renorm), dtype=torch.int32,
                               device=device),
    )


def viterbi_state(src, device=None) -> ViterbiState:
    """A JAX classic ViterbiState (or numpy arrays of its fields) → the
    port's: metrics of the same type, the uint32 tape as int32 words of
    the same bits, dp as a host int."""
    metrics = np.array(src.metrics)
    return ViterbiState(
        metrics=torch.as_tensor(metrics, dtype=torch_dtype(metrics.dtype),
                                device=device),
        decisions=torch.as_tensor(
            np.array(src.decisions, np.uint32).view(np.int32), device=device),
        dp=int(src.dp),
        renorm=torch.as_tensor(np.array(src.renorm), dtype=torch.int32,
                               device=device),
    )
