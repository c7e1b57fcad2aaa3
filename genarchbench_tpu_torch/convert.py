"""The JAX package's kernel inputs as this package's tensors.

Neither kernel has learned weights: the state carried across is the
DP inputs and the scoring parameters.  These functions take the arrays
that the JAX package hands its bpm and bsw device functions
(`_bpm_distance_device`, `_bsw_device` and their Pallas twins), as
numpy arrays, and return the tensors the port's wrappers take, so the
same inputs can go through both.  Scoring parameters pass unchanged.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def bpm_inputs_from_jax(peq: np.ndarray, plen: np.ndarray, text: np.ndarray,
                        tlen: np.ndarray) -> Tuple[torch.Tensor, ...]:
    """peq (B, W, 4) uint32, plen (B,), text (B, T) int32 codes, tlen (B,)
    -> bpm_cuda's (peq (W, 4, B) int32 bits, plen (B,) int32,
    text (T, B) int8, tlen (B,) int32) on the CPU."""
    peq = np.ascontiguousarray(
        np.asarray(peq, np.uint32).view(np.int32).transpose(1, 2, 0))
    text = np.asarray(text)
    text = np.ascontiguousarray(np.where(text < 0, 4, text).astype(np.int8).T)
    return (torch.from_numpy(peq), torch.from_numpy(np.asarray(plen, np.int32)),
            torch.from_numpy(text), torch.from_numpy(np.asarray(tlen, np.int32)))


def unpack_nibbles(packed: np.ndarray) -> np.ndarray:
    """(..., N//2) uint8, two 4-bit codes a byte, low nibble first ->
    (..., N) uint8."""
    packed = np.asarray(packed, np.uint8)
    return np.stack([packed & 15, packed >> 4], axis=-1).reshape(
        *packed.shape[:-1], 2 * packed.shape[-1])


def bsw_inputs_from_jax(seq1: np.ndarray, seq2: np.ndarray, len1: np.ndarray,
                        len2: np.ndarray, h0: np.ndarray,
                        myband: np.ndarray) -> Tuple[torch.Tensor, ...]:
    """The JAX package's nibble-packed seq1 (G, L, R/2) and seq2
    (G, L, C2/2) uint8 and its (G, L) lane arrays -> bsw_cuda's unpacked
    (G, L, R) and (G, L, C2) uint8 codes and (G, L) int32 tensors on
    the CPU."""
    lanes = (torch.from_numpy(np.ascontiguousarray(a, np.int32))
             for a in (len1, len2, h0, myband))
    return (torch.from_numpy(unpack_nibbles(seq1)),
            torch.from_numpy(unpack_nibbles(seq2)), *lanes)
