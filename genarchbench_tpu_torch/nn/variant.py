"""nn-variant: Clair3 variant calling, the pileup and full-alignment
models as torch.nn modules.

Reference semantics: nn-variant/Clair3 — the pileup network Clair3_P
(clair3/model.py:58-186): input (batch, 33 positions, 18 channels)
-> BiLSTM(128) -> BiLSTM(160) -> flatten -> Dense(128, selu) ->
heads Dense(128, selu) -> Dense(21|3|33|33, selu) -> softmax over
gt21 / genotype / two indel-length tasks; channel order
"A C G T I I1 D D1 * a c g t i i1 d d1 #" (shared/param_p.py:30);
pileup tensor = per-position signed counts from BAM
(preprocess/CreateTensorPileup.py); the full-alignment network Clair3_F
(model.py:295-440), a residual CNN over (rows, 33, 8) read tensors
(CreateTensorFullAlignment.py), fed after read-based phasing and an
optional SSW realignment (nn/ssw.py); the benchmark checks the
pileup-stage VCF (scripts/regression_small.sh).

The design is the JAX package's (nn/variant.py), which has no Pallas
kernel.  On the card:
  * the pileup counts (kernels/pileup.py's `calculate_pileup`) and the
    candidate selection over them, a masked comparison of every column
    at once whose list of candidates alone comes back;
  * Clair3P, one `torch.nn.LSTM` a BiLSTM (cuDNN), Keras gate order
    i,f,c,o being torch's i,f,g,o;
  * Clair3F in NCHW: TF-SAME padding at stride 2 pads the extra row and
    column at the end, the pyramid pooling is flax's SAME max-pool (pad
    -inf, low pad = total // 2), and the pooled maps go back to NHWC
    order before the flatten;
  * the SSW sweeps of the realignment.
Both models run in float32 with cuDNN's and cuBLAS's TF32 off.  The
tensor builders and the phasing stay host Python, copied from JAX; each
record's span and pileup events are computed once a run (`ReadCache`).

What differs from JAX:
  * `FullAlignmentCaller.predict` takes the sites' tensors as a list and
    runs one forward per row count, so sites of different coverage run
    in one call (JAX's `run` stacks them and raises).  A group whose
    pooled width the model was not built for (rows 1-16 and 25-32 for
    the 89-row model, where flax raises a parameter-shape error, and a
    site no read covers, where it raises too) is zero-padded at the end
    to the model's depth, the fixed depth the reference's Clair3_F takes;
  * the timing line `VariantCalling execution time:` (the reference's
    wrapper times the whole process), which JAX never prints;
  * the downsample draws from a private `random.Random(0)` in place of
    seeding the global generator.
"""

from __future__ import annotations

import contextlib
import copy
import math
import random
import sys
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genarchbench_tpu_torch.core.backend import resolve_device
from genarchbench_tpu_torch.core.roi import Laps, ROITimer
from genarchbench_tpu_torch.io.bam_io import parse_region, read_bam
from genarchbench_tpu_torch.kernels.pileup import (
    FEATLEN, FILTER_FLAGS, NUM_HOMOP, _read_events, calculate_pileup)

NO_OF_POSITIONS = 33
FLANKING = 16
CHANNELS = 18
GT21_LABELS = [
    "AA", "AC", "AG", "AT", "CC", "CG", "CT", "GG", "GT", "TT",
    "DelDel", "ADel", "CDel", "GDel", "TDel",
    "InsIns", "AIns", "CIns", "GIns", "TIns", "InsDel"]
GT21_SIZE = 21
GENOTYPE_SIZE = 3

_HEADS = ("L5_3", "L5_4", "Y_len1", "Y_len2")


@contextlib.contextmanager
def _fp32():
    """float32 throughout on the card: cuDNN's and cuBLAS's TF32 off."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                         allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class BiLSTM(nn.LSTM):
    """Keras Bidirectional(LSTM(units, return_sequences=True)): both
    directions' hidden states, concatenated per position."""

    def __init__(self, cin: int, units: int):
        super().__init__(cin, units, batch_first=True, bidirectional=True)

    def forward(self, x):
        return super().forward(x)[0]


class _Heads(nn.Module):
    """The dense tail both models share (model.py Clair3_P/_F predict
    mode): L5_* Dense(128, selu) into the softmaxed Y_* heads,
    concatenated."""

    def __init__(self, cin: int, add_indel_length: bool):
        super().__init__()
        self.add_indel_length = add_indel_length
        self.L5_1 = nn.Linear(cin, 128)
        self.L5_2 = nn.Linear(cin, 128)
        self.Y_gt21 = nn.Linear(128, GT21_SIZE)
        self.Y_genotype = nn.Linear(128, GENOTYPE_SIZE)
        if add_indel_length:
            self.L5_3 = nn.Linear(cin, 128)
            self.L5_4 = nn.Linear(cin, 128)
            self.Y_len1 = nn.Linear(128, NO_OF_POSITIONS)
            self.Y_len2 = nn.Linear(128, NO_OF_POSITIONS)

    def heads(self, x):
        def head(hidden, out):
            return F.softmax(F.selu(out(F.selu(hidden(x)))), dim=1)

        outs = [head(self.L5_1, self.Y_gt21), head(self.L5_2, self.Y_genotype)]
        if self.add_indel_length:
            outs += [head(self.L5_3, self.Y_len1), head(self.L5_4, self.Y_len2)]
        return torch.cat(outs, 1)


class Clair3P(_Heads):
    """clair3/model.py Clair3_P (predict mode concatenates the softmaxed
    heads); submodules named as JAX's flax layers."""

    def __init__(self, add_indel_length: bool = True):
        super().__init__(128, add_indel_length)
        self.LSTM1 = BiLSTM(CHANNELS, 128)
        self.LSTM2 = BiLSTM(256, 160)
        self.L4 = nn.Linear(NO_OF_POSITIONS * 320, 128)

    def forward(self, x):
        x = self.LSTM2(self.LSTM1(x.float()))
        return self.heads(F.selu(self.L4(x.reshape(x.shape[0], -1))))


def _dense_names(add_indel_length: bool) -> List[str]:
    return (["L4", "L5_1", "L5_2", "Y_gt21", "Y_genotype"]
            + (list(_HEADS) if add_indel_length else []))


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def pileup_state_from_tree(params: Dict[str, Any], add_indel_length: bool
                           = True) -> Dict[str, torch.Tensor]:
    """JAX Clair3P's parameter tree ({"LSTM1": {"fwd": {"kernel",
    "recurrent", "bias"}, "bwd": ...}, "L4": {"kernel", "bias"}, ...},
    arrays) -> `Clair3P`'s state dict: weight_ih = kernel.T, weight_hh =
    recurrent.T, bias_ih = bias, bias_hh = 0; Linear weight = kernel.T."""
    state: Dict[str, torch.Tensor] = {}
    for name in ("LSTM1", "LSTM2"):
        for d, sfx in (("fwd", ""), ("bwd", "_reverse")):
            leaves = params[name][d]
            state[f"{name}.weight_ih_l0{sfx}"] = _tensor(
                np.asarray(leaves["kernel"]).T)
            state[f"{name}.weight_hh_l0{sfx}"] = _tensor(
                np.asarray(leaves["recurrent"]).T)
            state[f"{name}.bias_ih_l0{sfx}"] = _tensor(leaves["bias"])
            state[f"{name}.bias_hh_l0{sfx}"] = torch.zeros(
                state[f"{name}.bias_ih_l0{sfx}"].shape)
    for name in _dense_names(add_indel_length):
        state[f"{name}.weight"] = _tensor(np.asarray(params[name]["kernel"]).T)
        state[f"{name}.bias"] = _tensor(params[name]["bias"])
    return state


def convert_keras_weights(weights: Dict[str, np.ndarray],
                          add_indel_length: bool = True
                          ) -> Dict[str, torch.Tensor]:
    """Keras Clair3_P checkpoint arrays -> `Clair3P`'s state dict.

    `weights` keys: 'LSTM1/forward/kernel', 'LSTM1/forward/recurrent',
    'LSTM1/forward/bias' (+ 'backward'), same for LSTM2; dense layers
    'L4/kernel', 'L4/bias', 'L5_1/...', 'Y_gt21/...', etc.  Keras LSTM
    kernels are (in, 4u) with gate order i,f,c,o."""
    tree: Dict[str, Any] = {}
    for name in ("LSTM1", "LSTM2"):
        tree[name] = {d: {k: weights[f"{name}/{src}/{k}"]
                          for k in ("kernel", "recurrent", "bias")}
                      for d, src in (("fwd", "forward"), ("bwd", "backward"))}
    for name in _dense_names(add_indel_length):
        tree[name] = {"kernel": weights[f"{name}/kernel"],
                      "bias": weights[f"{name}/bias"]}
    return pileup_state_from_tree(tree, add_indel_length)


def _lecun_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(fan_in))


def _random_init_(model: nn.Module, gen: torch.Generator) -> None:
    """Weights normal with variance 1/fan_in (flax's lecun_normal, not
    truncated; the LSTMs' recurrent kernels over the units), biases 0,
    BatchNorm the identity."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.LSTM):
                for d in ("", "_reverse"):
                    _lecun_(getattr(m, f"weight_ih_l0{d}"), m.input_size, gen)
                    _lecun_(getattr(m, f"weight_hh_l0{d}"), m.hidden_size,
                            gen)
                    getattr(m, f"bias_ih_l0{d}").zero_()
                    getattr(m, f"bias_hh_l0{d}").zero_()
            elif isinstance(m, (nn.Linear, nn.Conv2d)):
                _lecun_(m.weight, m.weight[0].numel(), gen)
                m.bias.zero_()


# ---------------------------------------------------------------------------
# full-alignment model Clair3_F (clair3/model.py:295-440): residual CNN over
# the (depth, 33 positions, 8 channels) full-alignment tensor, in NCHW
# ---------------------------------------------------------------------------

FA_CHANNELS = 8            # shared/param_f.py:21-24
FA_DEPTH_ONT = 89          # matrix_depth_dict['ont'], param_f.py:10
FA_NORMALIZE = 100.0       # NORMALIZE_NUM, param_f.py:34
POOL_SIZES = (3, 2, 1)


def _same_pad(d: int, stride: int, window: int) -> Tuple[int, int]:
    """TF/flax SAME padding of one dimension: (low, high), the extra
    one at the end."""
    out = -(-d // stride)
    total = max((out - 1) * stride + window - d, 0)
    return total // 2, total - total // 2


def _conv_bn(cin: int, cout: int, stride: int = 1):
    return (nn.Conv2d(cin, cout, 3, stride=stride,
                      padding=1 if stride == 1 else 0),
            nn.BatchNorm2d(cout, eps=1e-3))


class BasicConv2D(nn.Module):
    """Conv 3x3 (SAME) + BatchNorm + ReLU (model.py:189-206), BN in
    inference mode (moving statistics) as the reference predicts."""

    def __init__(self, cin: int, filters: int, strides: int = 1):
        super().__init__()
        self.strides = strides
        self.conv, self.bn = _conv_bn(cin, filters, strides)

    def forward(self, x):
        if self.strides != 1:
            h = _same_pad(x.shape[2], self.strides, 3)
            w = _same_pad(x.shape[3], self.strides, 3)
            x = F.pad(x, (*w, *h))
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    """Residual block (model.py:208-247), stride 1 (identity shortcut,
    the only configuration Clair3_F instantiates)."""

    def __init__(self, filters: int):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(filters, filters)
        self.conv2, self.bn2 = _conv_bn(filters, filters)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(x + self.bn2(self.conv2(y)))


def _pyramid_pooling(x: torch.Tensor, pool_sizes=POOL_SIZES) -> torch.Tensor:
    """PyramidPolling (model.py:260-293) on NCHW maps: flax's SAME
    max-pool with window == stride == ceil(dim / p), -inf padding with
    the low pad total // 2, each pooled map flattened in NHWC order."""
    B, _, H, W = x.shape
    parts = []
    for p in pool_sizes:
        wh, ww = -(-H // p), -(-W // p)
        h, w = _same_pad(H, wh, wh), _same_pad(W, ww, ww)
        pooled = F.max_pool2d(F.pad(x, (*w, *h), value=-math.inf),
                              (wh, ww), stride=(wh, ww))
        parts.append(pooled.permute(0, 2, 3, 1).reshape(B, -1))
    return torch.cat(parts, -1)


def pooled_features(rows: int, width: int = NO_OF_POSITIONS) -> int:
    """L4's input width for (rows, width) tensors: 256 channels times the
    pyramid's cells after three stride-2 convolutions."""
    for _ in range(3):
        rows, width = -(-rows // 2), -(-width // 2)
    cells = sum(-(-rows // -(-rows // p)) * -(-width // -(-width // p))
                for p in POOL_SIZES)
    return 256 * cells


class Clair3F(_Heads):
    """Full-alignment residual CNN (model.py:295-440, predict mode),
    built for (depth, width) tensors: L4 takes pooled_features(depth,
    width) inputs."""

    def __init__(self, add_indel_length: bool = True,
                 depth: int = FA_DEPTH_ONT, width: int = NO_OF_POSITIONS):
        super().__init__(256, add_indel_length)
        self.depth, self.width = depth, width
        self.conv1 = BasicConv2D(FA_CHANNELS, 64, strides=2)
        self.res_block1 = BasicBlock(64)
        self.conv3 = BasicConv2D(64, 128, strides=2)
        self.res_block2 = BasicBlock(128)
        self.conv5 = BasicConv2D(128, 256, strides=2)
        self.res_block3 = BasicBlock(256)
        self.L4 = nn.Linear(pooled_features(depth, width), 256)

    def fits(self, rows: int) -> bool:
        """Whether (rows, width) tensors pool to L4's input width (a site
        no read covers has no rows, and pools to nothing)."""
        return rows > 0 and \
            pooled_features(rows, self.width) == self.L4.in_features

    def forward(self, x):
        x = (x.float() / FA_NORMALIZE).permute(0, 3, 1, 2)
        for layer in (self.conv1, self.res_block1, self.conv3,
                      self.res_block2, self.conv5, self.res_block3):
            x = layer(x)
        return self.heads(F.selu(self.L4(_pyramid_pooling(x))))


def full_state_from_tree(params: Dict[str, Any], batch_stats: Dict[str, Any],
                         add_indel_length: bool = True
                         ) -> Dict[str, torch.Tensor]:
    """JAX Clair3F's params and batch_stats trees -> `Clair3F`'s state
    dict: conv kernels (kh, kw, cin, cout) -> (cout, cin, kh, kw),
    BatchNorm scale, bias, mean and var -> weight, bias, running_mean and
    running_var, Dense kernels transposed."""
    state: Dict[str, torch.Tensor] = {}

    def conv(dst, leaves):
        state[dst + ".weight"] = _tensor(np.transpose(
            np.asarray(leaves["kernel"]), (3, 2, 0, 1)))
        state[dst + ".bias"] = _tensor(leaves["bias"])

    def bn(dst, p, s):
        state[dst + ".weight"] = _tensor(p["scale"])
        state[dst + ".bias"] = _tensor(p["bias"])
        state[dst + ".running_mean"] = _tensor(s["mean"])
        state[dst + ".running_var"] = _tensor(s["var"])
        state[dst + ".num_batches_tracked"] = torch.tensor(0)

    for name in ("conv1", "conv3", "conv5"):
        conv(f"{name}.conv", params[name]["conv"])
        bn(f"{name}.bn", params[name]["bn"], batch_stats[name]["bn"])
    for name in ("res_block1", "res_block2", "res_block3"):
        for i in (1, 2):
            conv(f"{name}.conv{i}", params[name][f"conv{i}"])
            bn(f"{name}.bn{i}", params[name][f"bn{i}"],
               batch_stats[name][f"bn{i}"])
    for name in _dense_names(add_indel_length):
        state[f"{name}.weight"] = _tensor(np.asarray(params[name]["kernel"]).T)
        state[f"{name}.bias"] = _tensor(params[name]["bias"])
    return state


def convert_keras_weights_full(weights: Dict[str, np.ndarray],
                               add_indel_length: bool = True
                               ) -> Dict[str, torch.Tensor]:
    """Keras Clair3_F checkpoint arrays -> `Clair3F`'s state dict.

    Key scheme mirrors the layer names: 'conv1/conv/kernel',
    'conv1/bn/{gamma,beta,moving_mean,moving_variance}',
    'res_block1/conv1/kernel', ..., dense 'L4/kernel' etc.  Keras conv
    kernels are (kh, kw, cin, cout); a missing conv bias is zero."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def conv_bn(dst, conv_key, bn_key):
        kernel = weights[f"{conv_key}/kernel"]
        dst_p = {"kernel": kernel, "bias": weights.get(
            f"{conv_key}/bias", np.zeros(kernel.shape[-1], np.float32))}
        bn_p = {"scale": weights[f"{bn_key}/gamma"],
                "bias": weights[f"{bn_key}/beta"]}
        bn_s = {"mean": weights[f"{bn_key}/moving_mean"],
                "var": weights[f"{bn_key}/moving_variance"]}
        return dst_p, bn_p, bn_s

    for name in ("conv1", "conv3", "conv5"):
        c, p, s = conv_bn(name, f"{name}/conv", f"{name}/bn")
        params[name] = {"conv": c, "bn": p}
        stats[name] = {"bn": s}
    for name in ("res_block1", "res_block2", "res_block3"):
        params[name], stats[name] = {}, {}
        for i in (1, 2):
            c, p, s = conv_bn(name, f"{name}/conv{i}", f"{name}/bn{i}")
            params[name][f"conv{i}"] = c
            params[name][f"bn{i}"] = p
            stats[name][f"bn{i}"] = s
    for name in _dense_names(add_indel_length):
        params[name] = {"kernel": weights[f"{name}/kernel"],
                        "bias": weights[f"{name}/bias"]}
    return full_state_from_tree(params, stats, add_indel_length)


class _Caller:
    """A model in eval mode on its device; predict() runs it in float32
    on numpy tensors and returns numpy probabilities."""

    def __init__(self, model: nn.Module, state: Dict[str, torch.Tensor],
                 device):
        self.device = resolve_device(device)
        model.load_state_dict(state)
        self.model = model.to(self.device).eval()
        for m in self.model.modules():
            if isinstance(m, nn.LSTM):
                m.flatten_parameters()

    def _forward(self, x: np.ndarray) -> np.ndarray:
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        with _fp32():
            return self.model(xt).cpu().numpy()


class PileupCaller(_Caller):
    """Clair3_P inference wrapper (the pileup stage's CallVariants)."""

    def __init__(self, state: Dict[str, torch.Tensor],
                 add_indel_length: bool = True, *,
                 device: Optional[str] = None):
        self.add_indel_length = add_indel_length
        super().__init__(Clair3P(add_indel_length), state, device)

    @classmethod
    def init(cls, seed: int = 0, add_indel_length: bool = True, *,
             device: Optional[str] = None) -> "PileupCaller":
        """Random weights from a `torch.Generator` seeded with `seed`
        (`_random_init_`); they cannot equal flax's initialisation, so a
        run compared with the JAX package passes both a --model npz."""
        device = resolve_device(device)
        model = Clair3P(add_indel_length)
        _random_init_(model, torch.Generator().manual_seed(seed))
        return cls(model.state_dict(), add_indel_length, device=device)

    def predict(self, tensors: np.ndarray) -> np.ndarray:
        """(B, 33, 18) pileup tensors -> (B, 90) probabilities."""
        return self._forward(tensors)

    def call_variants(self, tensors, positions, ref_bases, chrom,
                      qual_cutoff=0.0):
        """VCF rows for candidate positions (CallVariants.py pileup
        output shape: CHROM POS ID REF ALT QUAL FILTER INFO FORMAT)."""
        return rows_from_probs(self.predict(tensors), positions,
                               ref_bases, chrom, qual_cutoff)


class FullAlignmentCaller(_Caller):
    """Clair3_F inference wrapper (the stage-6 caller,
    clair3.sh:224-240), its model built for (depth, width) tensors."""

    def __init__(self, state: Dict[str, torch.Tensor],
                 add_indel_length: bool = True, *,
                 depth: int = FA_DEPTH_ONT, width: int = NO_OF_POSITIONS,
                 device: Optional[str] = None):
        self.add_indel_length = add_indel_length
        super().__init__(Clair3F(add_indel_length, depth, width), state,
                         device)

    @classmethod
    def init(cls, seed: int = 0, add_indel_length: bool = True,
             depth: int = FA_DEPTH_ONT, *,
             device: Optional[str] = None) -> "FullAlignmentCaller":
        """Random weights from a `torch.Generator` seeded with `seed`, as
        `PileupCaller.init`."""
        device = resolve_device(device)
        model = Clair3F(add_indel_length, depth)
        _random_init_(model, torch.Generator().manual_seed(seed))
        return cls(model.state_dict(), add_indel_length, depth=depth,
                   device=device)

    def predict(self, tensors) -> np.ndarray:
        """Per-site (rows, width, 8) tensors (a list, or one (B, rows,
        width, 8) array) -> (B, 90) probabilities in site order, one
        forward per row count.  A row count the model cannot take is
        zero-padded at the end to its depth."""
        tensors = list(tensors)
        out = np.zeros((len(tensors), GT21_SIZE + GENOTYPE_SIZE + (
            2 * NO_OF_POSITIONS if self.add_indel_length else 0)), np.float32)
        groups: Dict[int, List[int]] = {}
        for k, t in enumerate(tensors):
            groups.setdefault(t.shape[0], []).append(k)
        for rows, ks in groups.items():
            x = np.stack([tensors[k] for k in ks])
            if not self.model.fits(rows):
                x = np.concatenate([x, np.zeros(
                    (len(ks), self.model.depth - rows, *x.shape[2:]),
                    x.dtype)], 1)
            out[ks] = self._forward(x)
        return out


# ---------------------------------------------------------------------------
# pileup tensor generation — exact CreateTensorPileup.py semantics
# ---------------------------------------------------------------------------

CHANNEL_ORDER = ("A", "C", "G", "T", "I", "I1", "D", "D1", "*",
                 "a", "c", "g", "t", "i", "i1", "d", "d1", "#")

# samtools view filter used by the mpileup stage (shared/param_p.py:39:
# SAMTOOLS_VIEW_FILTER_FLAG = 2316 = UNMAP|MUNMAP|SECONDARY|SUPPLEMENTARY)
CLAIR3_FILTER_FLAGS = 4 | 8 | 256 | 2048
CLAIR3_MIN_MQ = 5        # shared/param_p.py:19


class ReadCache:
    """Each record's reference span and pileup events (`_read_events`),
    computed at its first use and kept for the run: the tensor builders,
    the phasing and the realigner visit every record for every site.
    The cache holds its records, so an id stays its record's."""

    def __init__(self):
        self._memo: Dict[int, list] = {}

    def _entry(self, r) -> list:
        hit = self._memo.get(id(r))
        if hit is None:
            hit = self._memo[id(r)] = [r, r.ref_span(), None]
        return hit

    def span(self, r) -> int:
        return self._entry(r)[1]

    def events(self, r):
        """(pos, is_del, is_skip, qpos, indel), pos strictly increasing."""
        hit = self._entry(r)
        if hit[2] is None:
            hit[2] = _read_events(r)
        return hit[2]


def _window(events, lo: int, hi: int):
    """The events at positions in [lo, hi), in order."""
    pos = events[0]
    a, b = np.searchsorted(pos, (lo, hi))
    return tuple(e[a:b] for e in events)


def pileup_tensor_from_bam(records, chrom_id: int, center: int,
                           ref_seq: str, cache: Optional[ReadCache] = None
                           ) -> np.ndarray:
    """(33, 18) pileup count tensor around `center` (0-based), exact
    generate_tensor channel math (CreateTensorPileup.py:55-135):
    A/C/G/T by strand case, I/i = insertion events per strand,
    I1/i1 = count of the most frequent insertion ALLELE per strand,
    D/d and D1/d1 likewise for deletions, '*'/'#' = deletion bodies
    (mpileup --reverse-del; read filter = mpileup's --min-MQ 5 +
    --excl-flags 2316).  N bases count nowhere (BASE2INDEX has no N);
    insertions do not add to depth."""
    cache = cache or ReadCache()
    idx = {c: i for i, c in enumerate(CHANNEL_ORDER)}
    t = np.zeros((NO_OF_POSITIONS, CHANNELS), np.int32)
    lo = center - FLANKING
    hi = center + FLANKING + 1
    # per-column insertion/deletion ALLELE counters, keyed
    # (is_reverse, allele) — their maxima feed I1/i1/D1/d1
    ins_cnt = [Counter() for _ in range(NO_OF_POSITIONS)]
    del_cnt = [Counter() for _ in range(NO_OF_POSITIONS)]
    for r in records:
        if (r.ref_id != chrom_id or (r.flag & CLAIR3_FILTER_FLAGS)
                or r.mapq < CLAIR3_MIN_MQ):
            continue
        if r.pos >= hi or r.pos + cache.span(r) <= lo:
            continue
        pos, is_del, is_skip, qpos, indel = _window(cache.events(r),
                                                    max(lo, 0), hi)
        rev = r.is_reverse
        for p, d, sk, q, ind in zip(pos.tolist(), is_del.tolist(),
                                    is_skip.tolist(), qpos.tolist(),
                                    indel.tolist()):
            if sk:
                continue
            col = p - lo
            if d:
                t[col, idx["#" if rev else "*"]] += 1
                continue
            b = r.seq[q].upper()
            if b in "ACGT":
                t[col, idx[b.lower() if rev else b]] += 1
            if ind > 0:
                ins_cnt[col][(rev, r.seq[q + 1:q + 1 + ind].upper())] += 1
            elif ind < 0:
                del_cnt[col][(rev, -ind)] += 1
    for col in range(NO_OF_POSITIONS):
        for (rev, _allele), count in ins_cnt[col].items():
            t[col, idx["i" if rev else "I"]] += count
            ch = idx["i1" if rev else "I1"]
            t[col, ch] = max(t[col, ch], count)
        for (rev, _allele), count in del_cnt[col].items():
            t[col, idx["d" if rev else "D"]] += count
            ch = idx["d1" if rev else "D1"]
            t[col, ch] = max(t[col, ch], count)
        # reference-base channels hold the NEGATED total per strand
        # (CreateTensorPileup.py:163-164)
        p = lo + col
        rb = ref_seq[p].upper() if 0 <= p < len(ref_seq) else "N"
        if rb in "ACGT":
            t[col, idx[rb]] = -sum(t[col, idx[c]] for c in "ACGT")
            t[col, idx[rb.lower()]] = -sum(t[col, idx[c]]
                                           for c in "acgt")
    return t


# base byte -> 0-3 for A/C/G/T (either case), 4 otherwise
_REF_CODE = np.full(256, 4, np.int8)
for _i, _c in enumerate("ACGT"):
    _REF_CODE[ord(_c)] = _i
    _REF_CODE[ord(_c.lower())] = _i


def select_candidates(majors: np.ndarray, minors: np.ndarray, mat,
                      ref_seq: str, min_af: float) -> List[Tuple[int, str]]:
    """Candidate positions of a pileup count matrix, on the matrix's
    device: the major columns over an A/C/G/T reference base whose
    non-reference support (every count but the reference base's, both
    strands, all quality strata) reaches max(2, min_af * depth), compared
    in float64.  Returns [(position, reference base)] in column order,
    JAX's run loop (variant.py:855-868) exactly."""
    if not len(majors):
        return []
    pos = np.asarray(majors, np.int64)
    code = np.full(len(pos), 4, np.int8)
    inref = pos < len(ref_seq)
    code[inref] = _REF_CODE[np.frombuffer(ref_seq.encode("latin-1"),
                                          np.uint8)[pos[inref]]]
    dev = mat.device
    row = mat.view(-1, NUM_HOMOP, FEATLEN).sum(1, dtype=torch.int64)
    depth = row.sum(1)
    c = torch.from_numpy(code).to(dev).long()
    cc = c.clamp(max=3)[:, None]
    ref_cnt = (row.gather(1, cc) + row.gather(1, cc + 4))[:, 0]
    ok = torch.from_numpy(np.asarray(minors) == 0).to(dev) & (c < 4) \
        & (depth > 0)
    keep = ok & ((depth - ref_cnt).double()
                 >= (min_af * depth.double()).clamp_min(2.0))
    idx = torch.nonzero(keep)[:, 0].cpu().numpy()
    return [(int(pos[i]), "ACGT"[code[i]]) for i in idx]


# ---------------------------------------------------------------------------
# SSW read realignment (preprocess/realign: the ctypes realigner's
# SswAlignReadsToHaplotypes step) + full-alignment tensors + het phasing
# ---------------------------------------------------------------------------


def realign_reads(records, ref_seq: str, lo: int, hi: int,
                  chrom_id: int, *, device: Optional[str] = None,
                  cache: Optional[ReadCache] = None,
                  stats: Optional[dict] = None):
    """SSW-realign the reads overlapping [lo, hi) against the reference
    window, adopting the new (position, cigar) when the alignment score
    clears the realigner's threshold (realigner.cpp:76-86:
    match*L*0.16934 - mismatch*L*(1-0.16934); SSW driven as
    realigner.cpp:132-143 with maskLen = max(L/2, 15)).  The reference
    window plays the haplotype role (the realigner always includes the
    reference among its haplotypes); reads below threshold keep their
    original alignment.  The sweeps run on `device` (the card unless
    asked for the CPU); `stats` gets the aligner's and the window
    (`realign_window`).  Returns a new record list."""
    from genarchbench_tpu_torch.nn.ssw import SswAligner

    cache = cache or ReadCache()
    aligner = SswAligner(match=4, mismatch=6, gap_open=8, gap_extend=2,
                         device=device)
    win_lo = max(lo, 0)
    window = ref_seq[win_lo:hi]
    if not window:
        return records
    targets = [r for r in records
               if r.ref_id == chrom_id
               and not (r.flag & CLAIR3_FILTER_FLAGS)
               and r.pos < hi and r.pos + cache.span(r) > win_lo]
    if not targets:
        return records
    if stats is not None:
        stats["realign_window"] = (win_lo, hi)
    results = aligner.align_batch([r.seq for r in targets],
                                  [window] * len(targets), stats=stats)
    out = list(records)
    pos_of = {id(r): i for i, r in enumerate(records)}
    for r, a in zip(targets, results):
        L = len(r.seq)
        thresh = 4 * L * 0.16934 - 6 * L * (1 - 0.16934)
        if thresh < 0:
            thresh = 1
        if a.score1 < thresh or not a.cigar:
            continue
        nr = copy.copy(r)
        nr.pos = win_lo + a.ref_begin1
        cig = []
        if a.read_begin1 > 0:
            cig.append((4, a.read_begin1))            # soft-clip head
        cig += [(("MID".index(op)), n) for n, op in a.cigar]
        tail = L - 1 - a.read_end1
        if tail > 0:
            cig.append((4, tail))                     # soft-clip tail
        nr.cigar = cig
        out[pos_of[id(r)]] = nr
    return out


def phase_hets(records, het_positions, het_alts, chrom_id: int,
               cache: Optional[ReadCache] = None):
    """Read-based het-SNP phasing — the role whatshap phase + haplotag
    plays in the pipeline (Clair3/scripts/clair3.sh:173-194).

    Spanning-forest parity phasing (the HapCUT/whatshap graph model):
    every read contributes allele observations (+1 alt / -1 ref) at the
    hets it covers; het pairs co-covered by reads get an agreement
    weight w = sum of allele products; pairs are committed strongest
    first into a parity union-find (s_i * s_j = sign(w)), which is
    exactly a maximum-weight spanning forest of the conflict graph —
    the wMEC heuristic whatshap reduces to at high confidence.  Reads
    are then haplotagged by majority vote against the component phase;
    ambiguous reads (tied vote) stay untagged, like whatshap haplotag.
    Returns {read_name: 1|2}."""
    cache = cache or ReadCache()
    pos_list = sorted(set(het_positions))
    pos_alt = dict(zip(het_positions, het_alts))
    pidx = {p: i for i, p in enumerate(pos_list)}
    n = len(pos_list)

    # per read: observed alleles at covered hets
    read_obs: List[Tuple[str, List[Tuple[int, int]]]] = []
    for r in records:
        if r.ref_id != chrom_id or (r.flag & FILTER_FLAGS):
            continue
        obs = []
        for p in pos_list:
            if not (r.pos <= p < r.pos + cache.span(r)):
                continue
            qpos = _qpos_at(r, p, cache)
            if qpos is None:
                continue
            a = 1 if r.seq[qpos].upper() == pos_alt[p] else -1
            obs.append((pidx[p], a))
        if obs:
            read_obs.append((r.qname, obs))

    # pairwise agreement weights from co-covering reads
    w: Dict[Tuple[int, int], int] = {}
    for _, obs in read_obs:
        for k in range(len(obs)):
            i, ai = obs[k]
            for l in range(k + 1, len(obs)):
                j, aj = obs[l]
                key = (i, j) if i < j else (j, i)
                w[key] = w.get(key, 0) + ai * aj

    # maximum-|weight| spanning forest with parity union-find
    parent = list(range(n))
    rel = [1] * n                  # phase of node relative to its parent

    def find(x):
        # iterative two-pass root-then-compress: a long phased het chain
        # builds deep trees, which a recursive find could not walk
        path = []
        while parent[x] != x:
            path.append(x)
            x = parent[x]
        sign = 1
        for y in reversed(path):
            sign *= rel[y]
            parent[y] = x
            rel[y] = sign
        return x, (rel[path[0]] if path else 1)

    for (i, j), wij in sorted(w.items(),
                              key=lambda kv: (-abs(kv[1]), kv[0])):
        if wij == 0:
            continue
        ri, si = find(i)
        rj, sj = find(j)
        if ri == rj:
            continue               # parity fixed already (forest edge)
        # want s_i * s_j = sign(wij):  rel[rj -> ri]
        parent[rj] = ri
        rel[rj] = si * sj * (1 if wij > 0 else -1)

    phase = [find(i)[1] for i in range(n)]

    tags: Dict[str, int] = {}
    for qname, obs in read_obs:
        score = sum(a * phase[i] for i, a in obs)
        if score > 0:
            tags[qname] = 2
        elif score < 0:
            tags[qname] = 1
    return tags


def _qpos_at(r, p: int, cache: Optional[ReadCache] = None) -> Optional[int]:
    """Query offset aligned at reference position p (None in deletions)."""
    pos, is_del, is_skip, qpos, _ = (cache or ReadCache()).events(r)
    k = int(np.searchsorted(pos, p))
    if k < len(pos) and pos[k] == p:
        return None if (is_del[k] or is_skip[k]) else int(qpos[k])
    return None


# CreateTensorFullAlignment.py:26-31 constants
FA_MAX_BQ, FA_MAX_MQ = 40.0, 60.0
FA_STRAND_0, FA_STRAND_1 = 100, 50
FA_HAP_TYPE = {1: 30, 0: 60, 2: 90}            # hap1 UNKNOWN hap2
FA_ACGT_NUM = dict(zip("ACGT+-*#N",
                       (100, 25, 75, 50, -50, -100, 0, 0, 100)))


def _fa_evc_base(base: str) -> str:
    """evc_base_from (CreateTensorFullAlignment.py:92-103)."""
    if base == "N":
        return "A"
    if base == "n":
        return "a"
    if base in "ACGTacgt":
        return base
    return "A" if base.isupper() else "a"


def full_alignment_tensor(records, chrom_id: int, center: int,
                          ref_seq: str, haplotags: Optional[Dict[str, int]]
                          = None, depth: int = FA_DEPTH_ONT,
                          cache: Optional[ReadCache] = None) -> np.ndarray:
    """(rows, 33, 8) full-alignment tensor around `center`, exact
    CreateTensorFullAlignment.py semantics: per-cell channels from
    get_tensor_info (:136-169 — note the CODE's layout is ref, alt,
    strand, mq, bq, af, ins, hap; the param_f.py channel-name tuple
    lists a different order than the indices the code writes),
    insertion bases spread over following columns (:358-361), the
    per-read center-allele frequency and haplotype written onto
    non-deletion columns (:363-381), and rows ordered by
    sorted_by_hap_read_name (:105-134: window first-seen order,
    seed-0 random downsample past matrix_depth, then stable
    (hap, order) sort)."""
    cache = cache or ReadCache()
    lo = center - FLANKING
    hi = center + FLANKING + 1

    # per covering read: per-position (base_str, indel_str, bq) events
    reads_info = []                        # (first_p, qname, events, mq, hap)
    for r in records:
        if r.ref_id != chrom_id or (r.flag & CLAIR3_FILTER_FLAGS) \
                or r.mapq < CLAIR3_MIN_MQ:
            continue
        if r.pos >= hi or r.pos + cache.span(r) <= lo:
            continue
        pos, is_del, is_skip, qpos, indel = _window(cache.events(r), lo, hi)
        rev = r.is_reverse
        ev: Dict[int, tuple] = {}
        first_p = None
        for p, d, sk, q, ind in zip(pos.tolist(), is_del.tolist(),
                                    is_skip.tolist(), qpos.tolist(),
                                    indel.tolist()):
            if sk:
                continue
            if first_p is None:
                first_p = p
            if d:
                ev[p] = ("#" if rev else "*", "", 0)
                continue
            b = r.seq[q]
            base = b.lower() if rev else b.upper()
            ind_s = ""
            if ind > 0:
                ins = r.seq[q + 1:q + 1 + ind]
                ind_s = "+" + (ins.lower() if rev else ins.upper())
            elif ind < 0:
                dl = ref_seq[p + 1:p + 1 - ind]
                ind_s = "-" + (dl.lower() if rev else dl.upper())
            ev[p] = (base, ind_s, int(r.qual[q]))
        if first_p is None:
            continue
        hap = haplotags.get(r.qname, 0) if haplotags else 0
        reads_info.append((first_p, r.qname, ev, int(r.mapq), hap))

    # window first-seen order = (first covered position, record order)
    order_idx = sorted(range(len(reads_info)),
                       key=lambda i: (reads_info[i][0], i))
    if len(order_idx) > depth:
        # the draws of random.seed(0); random.sample (JAX), without
        # touching the global generator
        keep = sorted(random.Random(0).sample(range(len(order_idx)), depth))
        order_idx = [order_idx[i] for i in keep]
    rows = sorted(range(len(order_idx)),
                  key=lambda k: (reads_info[order_idx[k]][4], k))

    n_rows = len(rows)
    t = np.zeros((n_rows, NO_OF_POSITIONS, FA_CHANNELS), np.int32)
    if n_rows == 0:
        return t

    # center-position allele counts for the af channel (:335-350)
    alt_dict: Dict[str, int] = {}
    cdepth = 0
    for first_p, qn, ev, mq, hap in reads_info:
        info = ev.get(center)
        if info is None:
            continue
        base, ind_s, bq = info
        cdepth += 1
        if base in "#*":
            continue
        bu = base.upper()
        if ind_s:
            if ind_s[0] == "+":
                alt_dict["+" + bu + ind_s[1:].upper()] = \
                    alt_dict.get("+" + bu + ind_s[1:].upper(), 0) + 1
            else:
                alt_dict[ind_s.upper()] = \
                    alt_dict.get(ind_s.upper(), 0) + 1
        elif bu != ref_seq[center].upper():
            alt_dict[bu] = alt_dict.get(bu, 0) + 1

    for ridx, k in enumerate(rows):
        first_p, qn, ev, mq, hap = reads_info[order_idx[k]]
        mqn = int(100 * min(mq, FA_MAX_MQ) / FA_MAX_MQ)
        for p, (base, ind_s, bq) in ev.items():
            off = p - lo
            if base in "#*":
                continue                    # all-zero cell
            bu = base.upper()
            alt = 0
            if ind_s:
                alt = FA_ACGT_NUM[ind_s[0]]
            elif bu != ref_seq[p].upper() and bu in "ACGT":
                alt = FA_ACGT_NUM[_fa_evc_base(bu).upper()]
            strand = FA_STRAND_0 if base in "ACGT" else FA_STRAND_1
            t[ridx, off, 0] = FA_ACGT_NUM[ref_seq[p].upper()]
            t[ridx, off, 1] = alt
            t[ridx, off, 2] = strand
            t[ridx, off, 3] = mqn
            t[ridx, off, 4] = int(100 * min(bq, FA_MAX_BQ) / FA_MAX_BQ)
            # insertion bases spread over following columns (:358-361)
            if ind_s and ind_s[0] == "+" and p < hi - 1:
                ins = ind_s[1:].upper()
                for ii in range(min(len(ins), NO_OF_POSITIONS - off)):
                    t[ridx, off + ii, 6] = FA_ACGT_NUM[ins[ii]]
        # af + hap on non-deletion columns (:363-381)
        af_num = 0
        info = ev.get(center)
        if info is not None:
            base, ind_s, bq = info
            bu = base.upper()
            key = None
            if ind_s:
                key = ("+" + bu + ind_s[1:].upper()) if ind_s[0] == "+" \
                    else ind_s.upper()
            elif bu in alt_dict:
                key = bu
            if key is not None and key in alt_dict:
                af_num = alt_dict[key] / max(1.0, float(cdepth))
        if af_num != 0:
            af_num = int(100 * min(af_num, 1.0))
        hap_t = FA_HAP_TYPE[hap]
        nz = t[ridx, :, 2] != 0
        t[ridx, nz, 5] = af_num
        t[ridx, nz, 7] = hap_t
    return t


def merge_vcf_rows(pileup_rows: List[str], fa_rows: List[str],
                   examined_pos: Optional[set] = None) -> List[str]:
    """MergeVcf semantics (clair3.sh:267-280): at every position the
    full-alignment stage examined, its decision wins (including "no
    variant": an examined position with no FA row drops the pileup
    call); other pileup calls pass through.  Rows stay sorted."""
    examined = set(examined_pos or ()) | {
        int(r.split("\t")[1]) for r in fa_rows}
    merged = [r for r in pileup_rows
              if int(r.split("\t")[1]) not in examined] + fa_rows
    return sorted(merged, key=lambda r: (r.split("\t")[0],
                                         int(r.split("\t")[1])))


# ---------------------------------------------------------------------------
# variant calling output
# ---------------------------------------------------------------------------

def gt21_to_alleles(label: str, ref_base: str) -> Tuple[str, str, str]:
    """gt21 label -> (ref, alt, genotype-string)."""
    if label in ("AA", "CC", "GG", "TT"):
        b = label[0]
        if b == ref_base:
            return ref_base, ".", "0/0"
        return ref_base, b, "1/1"
    if len(label) == 2 and label[0] in "ACGT" and label[1] in "ACGT":
        a, b = label[0], label[1]
        if ref_base == a:
            return ref_base, b, "0/1"
        if ref_base == b:
            return ref_base, a, "0/1"
        return ref_base, f"{a},{b}", "1/2"
    return ref_base, ".", "./."        # indel classes need realignment


def rows_from_probs(probs, positions, ref_bases, chrom,
                    qual_cutoff=0.0) -> List[str]:
    """gt21/genotype head probabilities -> VCF rows (shared by the
    pileup and full-alignment callers)."""
    rows = []
    for k, pos in enumerate(positions):
        gt21 = probs[k, :GT21_SIZE]
        geno = probs[k, GT21_SIZE:GT21_SIZE + GENOTYPE_SIZE]
        gi = int(np.argmax(gt21))
        label = GT21_LABELS[gi]
        ref, alt, gt = gt21_to_alleles(label, ref_bases[k])
        if alt == ".":
            continue
        qual = float(gt21[gi]) * float(np.max(geno))
        if qual < qual_cutoff:
            continue
        q10 = min(99.0, -10.0 * np.log10(max(1e-10, 1 - qual)))
        rows.append(f"{chrom}\t{pos + 1}\t.\t{ref}\t{alt}\t"
                    f"{q10:.2f}\tPASS\t.\tGT\t{gt}")
    return rows


def _read_ref(path: str, chrom: str) -> str:
    with open(path) as f:
        cur, take = [], False
        for line in f:
            line = line.rstrip()
            if line.startswith(">"):
                take = line[1:].split()[0] == chrom
            elif take:
                cur.append(line)
    return "".join(cur)


def run(argv: Sequence[str], stats: Optional[dict] = None) -> int:
    """Variant calling: --bam --ref --region --output [--model
    weights.npz] [--full-alignment [--fa-model w.npz] [--realign]], on
    the card unless GENARCH_DEVICE=cpu.  With `stats`, a dict, adds the
    seconds of each stage (a sync at each boundary) and its counts."""
    import argparse
    p = argparse.ArgumentParser(prog="nn-variant")
    p.add_argument("--bam", required=True)
    p.add_argument("--ref", required=True)
    p.add_argument("--region", required=True)
    p.add_argument("--output", default=None)
    p.add_argument("--model", default=None)
    p.add_argument("--min_af", type=float, default=0.25)
    p.add_argument("--full-alignment", dest="full_alignment",
                   action="store_true",
                   help="run the Clair3_F full-alignment stage on "
                        "low-quality pileup calls (clair3.sh:211-240)")
    p.add_argument("--fa-model", dest="fa_model", default=None)
    p.add_argument("--fa-qual", dest="fa_qual", type=float, default=30.0,
                   help="pileup QUAL below which a call is re-examined "
                        "by the full-alignment model")
    p.add_argument("--realign", action="store_true",
                   help="SSW-realign reads around re-examined sites "
                        "before building full-alignment tensors (the "
                        "realign/ ctypes stage, ilmn platform)")
    args = p.parse_args(argv)
    dev = resolve_device()

    roi = ROITimer("nn_variant", "VariantCalling execution time: {t:.2f} sec")
    with roi:
        lap = Laps(stats, dev)
        chrom, beg, end = parse_region(args.region)
        refs, records = read_bam(args.bam)
        names = [n for n, _ in refs]
        cid = names.index(chrom)
        if beg is None:
            beg, end = 0, refs[cid][1]
        ref_seq = _read_ref(args.ref, chrom)
        lap("read_s")
        if args.model:
            caller = PileupCaller(convert_keras_weights(
                dict(np.load(args.model))), device=dev)
        else:
            caller = PileupCaller.init(device=dev)
        cache = ReadCache()
        lap("model_s")

        # candidate selection: positions whose non-ref support >= min_af
        majors, minors, mat, _ = calculate_pileup(records, cid, beg, end,
                                                  device_out=True, device=dev)
        cands = select_candidates(majors, minors, mat, ref_seq, args.min_af)
        lap("pileup_s")

        roi_lines: List[str] = []
        if cands:
            tensors = np.stack([
                pileup_tensor_from_bam(records, cid, pos, ref_seq, cache)
                for pos, _ in cands])
            lap("tensors_s")
            roi_lines = caller.call_variants(
                tensors, [p_ for p_, _ in cands],
                [b for _, b in cands], chrom)
            lap("clair3p_s")

        info = []
        if args.full_alignment and roi_lines:
            # stages 2-4 (phase hets) + 5 (select low-qual) + 6 (Clair3_F)
            # + 7 (merge), clair3.sh:173-280
            hets = [(int(r.split("\t")[1]) - 1, r.split("\t")[4])
                    for r in roi_lines
                    if r.split("\t")[9] == "0/1"
                    and len(r.split("\t")[4]) == 1]
            tags = phase_hets(records, [h[0] for h in hets],
                              [h[1] for h in hets], cid, cache) \
                if hets else {}
            lap("phase_s")
            sel = [r for r in roi_lines
                   if float(r.split("\t")[5]) < args.fa_qual]
            if sel:
                if args.fa_model:
                    fa_caller = FullAlignmentCaller(convert_keras_weights_full(
                        dict(np.load(args.fa_model))), device=dev)
                else:
                    fa_caller = FullAlignmentCaller.init(device=dev)
                lap("fa_model_s")
                sel_pos = [int(r.split("\t")[1]) - 1 for r in sel]
                fa_records = records
                if args.realign:
                    fa_records = realign_reads(
                        records, ref_seq, min(sel_pos) - 2 * FLANKING,
                        max(sel_pos) + 2 * FLANKING + 1, cid, device=dev,
                        cache=cache, stats=stats)
                    lap("realign_s")
                fa_tensors = [full_alignment_tensor(fa_records, cid, pos,
                                                    ref_seq, tags,
                                                    cache=cache)
                              for pos in sel_pos]
                lap("fa_tensors_s")
                fa_rows = rows_from_probs(
                    fa_caller.predict(fa_tensors), sel_pos,
                    [ref_seq[p_].upper() for p_ in sel_pos], chrom)
                lap("clair3f_s")
                roi_lines = merge_vcf_rows(
                    roi_lines, fa_rows,
                    examined_pos={p_ + 1 for p_ in sel_pos})
                info.append(f"[INFO] full-alignment re-called {len(sel)} "
                            f"sites ({len(tags)} reads haplotagged)")
                if stats is not None:
                    stats.update(fa_sites=len(sel), haplotagged=len(tags),
                                 fa_rows=[len(t) for t in fa_tensors])

        out = open(args.output, "w") if args.output else sys.stdout
        out.write("##fileformat=VCFv4.2\n")
        out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                  "SAMPLE\n")
        for row in roi_lines:
            out.write(row + "\n")
        if args.output:
            out.close()
        lap("write_s")
        roi.sync()
    for line in info:
        print(line, file=sys.stderr)
    print(f"[INFO] VariantCalling executed: {len(roi_lines)} variants "
          f"from {len(cands)} candidates", file=sys.stderr)
    roi.report()
    if stats is not None:
        stats.update(candidates=len(cands), variants=len(roi_lines),
                     reads=len(records), roi_s=roi.elapsed)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
