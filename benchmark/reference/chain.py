"""The plain receive chain: raw int16 IQ → carrier demod → symbol demod
→ block decode, for the channels it is given.  It imports nothing of
the program under test and takes nothing the program made: only the
raw IQ the benchmark generated and the configuration's settings."""

from __future__ import annotations

import torch

from reference.decode import decode_block
from reference.pm import pm_demod
from reference.symbols import symdemod

#: the decode policy the plain chain implements (decode.c's defaults
#: with the QLEC tier and the Viterbi fallback on every undecoded frame)
POLICY = {"fano_enabled": True, "viterbi_enabled": True, "quicklook": True,
          "qlec": True}


#: the controls: the chain in the next precision below the float32 the
#: configurations state, put in the program's place (yardstick/control.py)
CONTROLS = {
    # the whole carrier demod, its estimate too, in bfloat16
    "bf16_carrier": {"real": torch.bfloat16},
    # the carrier estimate in float32; the spin-down, the baseband and
    # the symbol integrators in bfloat16
    "bf16_baseband": {"baseband_real": torch.bfloat16, "integrate_real": torch.bfloat16},
}


def receive(raw: torch.Tensor, cfg: dict, nframes: int, control: str | None = None) -> dict:
    """(B, 2L) int16 raw IQ of B channels → their frames (decode_block's
    dict) and, under ``"soft"``, their (B, S) uint8 soft symbols on the
    host.  ``control`` names an entry of CONTROLS."""
    lower = CONTROLS[control] if control else {}
    dcfg = cfg["decode"]
    for key, want in POLICY.items():
        if dcfg.get(key) != want:
            raise NotImplementedError(f"plain chain: decode {key} must be {want}")
    if cfg.get("pm_dtype", "float32") != "float32":
        raise NotImplementedError("plain chain: the carrier demod is float32")
    with torch.no_grad():
        baseband = pm_demod(raw, cfg, lower.get("real"), lower.get("baseband_real"))
        soft = symdemod(baseband, cfg, lower.get("integrate_real"))
        del baseband
        out = decode_block(soft, nframes, dcfg)
        out["soft"] = soft.cpu().numpy()
        return out
