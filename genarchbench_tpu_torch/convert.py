"""The JAX package's kernel inputs and weights as this package's tensors.

bpm and bsw have no learned weights: the state carried across is the
DP inputs and the scoring parameters.  Their functions take the arrays
that the JAX package hands its bpm and bsw device functions
(`_bpm_distance_device`, `_bsw_device` and their Pallas twins), as
numpy arrays, and return the tensors the port's wrappers take, so the
same inputs can go through both.  Scoring parameters pass unchanged.
nn-base has weights: `basecall_state_from_jax` turns the JAX
basecaller's flax variables into the port's (bonito's) state dict.
fmi's state is its index: `fmi_index_from_jax` builds the port's
`FMIndex` from a JAX `FMIndex`'s fields, so both search one index.
abea's state is its pore model, a dict of three numpy arrays
(`load_model`), which both packages take as it is: nothing to convert.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

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


def basecall_state_from_jax(variables: Dict[str, Any],
                            config: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX basecaller's variables ({"params": ..., "batch_stats": ...}
    as nested dicts of numpy arrays) -> the port's `BasecallModel` state
    dict, in bonito's names: the inverse of the JAX package's
    `convert_torch_state_dict`.  Conv kernels go from flax (k, in/groups,
    out) to torch (out, in/groups, k); BatchNorm scale, bias, mean and
    var to weight, bias, running_mean and running_var."""
    params, stats = variables["params"], variables["batch_stats"]
    state: Dict[str, torch.Tensor] = {}

    def tensor(a):
        return torch.from_numpy(np.array(a, np.float32))

    def conv(dst, leaves):
        state[dst + ".weight"] = tensor(np.transpose(np.asarray(
            leaves["kernel"]), (2, 1, 0)))
        if "bias" in leaves:
            state[dst + ".bias"] = tensor(leaves["bias"])

    def bn(dst, p, s):
        state[dst + ".weight"] = tensor(p["scale"])
        state[dst + ".bias"] = tensor(p["bias"])
        state[dst + ".running_mean"] = tensor(s["mean"])
        state[dst + ".running_var"] = tensor(s["var"])
        state[dst + ".num_batches_tracked"] = torch.tensor(0)

    for i, layer in enumerate(config["block"]):
        base = f"encoder.encoder.{i}"
        blk, bst = params[f"block{i}"], stats[f"block{i}"]
        # bonito's flat ModuleList: [TCS, BN, act, dropout] * (repeat-1)
        # + [TCS, BN]
        for r in range(layer["repeat"]):
            tcs = blk[f"tcs{r}"]
            for part in (("depthwise", "pointwise") if layer["separable"]
                         else ("conv",)):
                conv(f"{base}.conv.{4 * r}.{part}", tcs[part])
            bn(f"{base}.conv.{4 * r + 1}", blk[f"bn{r}"], bst[f"bn{r}"])
        if layer["residual"]:
            conv(f"{base}.residual.0.conv", blk["res_tcs"]["conv"])
            bn(f"{base}.residual.1", blk["res_bn"], bst["res_bn"])
    conv("decoder.layers.0", params["decoder"])
    return state


def fmi_index_from_jax(count: np.ndarray, cp_count: np.ndarray,
                       oh_hi: np.ndarray, oh_lo: np.ndarray, sentinel: int,
                       seq_len: int):
    """A JAX `FMIndex`'s fields (count (5,), cp_count (ncp, 4), the
    one-hot words oh_hi and oh_lo (ncp, 4) uint32, the sentinel row and
    the BWT length) -> the port's `kernels.fmi.FMIndex`, arrays copied
    with their dtypes."""
    from genarchbench_tpu_torch.kernels.fmi import FMIndex
    return FMIndex(np.array(count), np.array(cp_count),
                   np.array(oh_hi, np.uint32), np.array(oh_lo, np.uint32),
                   int(sentinel), int(seq_len))
