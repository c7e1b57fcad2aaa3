"""nn-base: QuartzNet-style CTC nanopore basecaller (Bonito) as a torch.nn
model.

Reference semantics: nn-base/bonito/basecall.py — Model/Encoder/Block/
TCSConv1d/Decoder (:77-270), chunk/stitch (:312-337), signal normalization
(:387-426), greedy/beam CTC decode via fast_ctc_decode (:104-113), and the
main loop printing "> samples per second" (:600-660).

The model is bonito's own layout: NCW tensors and bonito's state_dict
names (`encoder.encoder.<i>.conv.<j>.{depthwise,pointwise,conv}`,
`residual.0.conv`, `residual.1`, `decoder.layers.0`), so a bonito
`weights_<n>.tar` loads with `load_state_dict(strict=True)` and no
conversion.  The JAX package's public functions are kept: `Basecaller`
takes and returns (n, time, features) numpy arrays as the JAX one does,
and the host functions (normalization, chunking, stitching, the CTC
decoders) are its numpy code, copied.  The JAX package has no Pallas
kernel here: its convolutions are flax `nn.Conv`, and this port's are
`torch.nn.Conv1d` (cuDNN on the card), run in float32 with TF32 off.
"""

from __future__ import annotations

import math
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from genarchbench_tpu_torch.core.backend import resolve_device

DEFAULT_ALPHABET = ["N", "A", "C", "G", "T"]

# QuartzNet 5x5 (config-compatible with bonito's config.toml 'block' table;
# the real table ships with the model directory in the dataset).
DEFAULT_CONFIG: Dict[str, Any] = {
    "input": {"features": 1},
    "encoder": {"activation": "swish"},
    "labels": {"labels": DEFAULT_ALPHABET},
    "block": [
        dict(filters=256, repeat=1, kernel=[33], stride=[3], dilation=[1],
             dropout=0.05, residual=False, separable=False),
        dict(filters=256, repeat=5, kernel=[33], stride=[1], dilation=[1],
             dropout=0.05, residual=True, separable=True),
        dict(filters=256, repeat=5, kernel=[39], stride=[1], dilation=[1],
             dropout=0.05, residual=True, separable=True),
        dict(filters=512, repeat=5, kernel=[51], stride=[1], dilation=[1],
             dropout=0.05, residual=True, separable=True),
        dict(filters=512, repeat=5, kernel=[63], stride=[1], dilation=[1],
             dropout=0.05, residual=True, separable=True),
        dict(filters=512, repeat=5, kernel=[75], stride=[1], dilation=[1],
             dropout=0.05, residual=True, separable=True),
        dict(filters=512, repeat=1, kernel=[87], stride=[1], dilation=[1],
             dropout=0.05, residual=False, separable=True),
        dict(filters=1024, repeat=1, kernel=[1], stride=[1], dilation=[1],
             dropout=0.05, residual=False, separable=False),
    ],
}


class Swish(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(x)


class TCSConv(nn.Module):
    """Time-Channel Separable conv (basecall.py:147-180).

    Keeps the reference quirk of passing `stride` to the pointwise conv
    as well as the depthwise (basecall.py:160-168); all separable blocks
    use stride 1, so this is benign but kept for checkpoint parity."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dilation: int = 1, separable: bool = False,
                 bias: bool = False):
        super().__init__()
        pad = (kernel // 2) * dilation
        self.separable = separable
        if separable:
            self.depthwise = nn.Conv1d(cin, cin, kernel, stride, pad,
                                       dilation, groups=cin, bias=bias)
            self.pointwise = nn.Conv1d(cin, cout, 1, stride, 0, bias=bias)
        else:
            self.conv = nn.Conv1d(cin, cout, kernel, stride, pad, dilation,
                                  bias=bias)

    def forward(self, x):
        if self.separable:
            return self.pointwise(self.depthwise(x))
        return self.conv(x)


class BatchNorm(nn.BatchNorm1d):
    """bonito's BatchNorm1d (eps 1e-3, bonito's state-dict names) with
    flax's training rule, the JAX model's: in `train()` mode the batch's
    mean and its biased variance max(0, E[x^2] - E[x]^2) over batch and
    time (flax's `use_fast_variance`, not torch's two-pass variance)
    normalize x, and the running statistics take that biased variance
    with momentum 0.1 (flax's 0.9), where torch's own BatchNorm takes
    the unbiased one.  `eval()` is torch's BatchNorm1d."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-3)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        return self.forward_shards([x], [slice(None)])[0]

    def forward_shards(self, xs: Sequence[torch.Tensor],
                       blocks: Sequence[slice],
                       reduce: Optional[Callable] = None
                       ) -> List[torch.Tensor]:
        """Train mode over shards: xs[i] holds channels blocks[i] of this
        layer for some of the batch's rows and frames.  `reduce` maps a
        list of per-shard tensors to the list of their sums over the
        shards that hold the same channels, so that the statistics are
        the global batch's (None: each shard holds the whole batch)."""
        sums = [[x.sum((0, 2)) for x in xs], [(x * x).sum((0, 2)) for x in xs],
                [x.new_tensor(x.shape[0] * x.shape[2]) for x in xs]]
        if reduce is not None:
            sums = [reduce(v) for v in sums]
        out, seen = [], set()
        for x, b, s1, s2, n in zip(xs, blocks, *sums):
            mean = s1 / n
            var = torch.clamp_min(s2 / n - mean * mean, 0.0)
            scale = torch.rsqrt(var + self.eps) * self.weight[b].to(x.device)
            out.append((x - mean[:, None]) * scale[:, None]
                       + self.bias[b].to(x.device)[:, None])
            if (b.start, b.stop) not in seen:
                seen.add((b.start, b.stop))
                with torch.no_grad():
                    for buf, v in ((self.running_mean, mean),
                                   (self.running_var, var)):
                        buf[b] = (1 - self.momentum) * buf[b] \
                            + self.momentum * v.to(buf.device)
        return out


class Block(nn.Module):
    """TCSConv + BatchNorm + activation (+ residual) (basecall.py:182-253).
    `conv` is bonito's flat list, [TCS, BN, act, dropout] * (repeat-1) +
    [TCS, BN]; BatchNorm eps is 1e-3, with flax's training rule
    (`BatchNorm`)."""

    def __init__(self, cin: int, layer: Dict[str, Any]):
        super().__init__()
        f, k = layer["filters"], layer["kernel"][0]
        s, d = layer["stride"][0], layer["dilation"][0]
        sep = layer["separable"]
        p = layer.get("dropout", 0.0)
        mods, c = [], cin
        for _ in range(layer["repeat"] - 1):
            mods += [TCSConv(c, f, k, s, d, sep), BatchNorm(f), Swish(),
                     nn.Dropout(p)]
            c = f
        mods += [TCSConv(c, f, k, s, d, sep), BatchNorm(f)]
        self.conv = nn.ModuleList(mods)
        self.use_res = layer["residual"]
        if self.use_res:
            self.residual = nn.Sequential(TCSConv(cin, f, 1), BatchNorm(f))
        self.activation = nn.Sequential(Swish(), nn.Dropout(p))

    def forward(self, x):
        h = x
        for m in self.conv:
            h = m(h)
        if self.use_res:
            h = h + self.residual(x)
        return self.activation(h)


class Encoder(nn.Module):
    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        c = config["input"]["features"]
        blocks = []
        for layer in config["block"]:
            blocks.append(Block(c, layer))
            c = layer["filters"]
        self.encoder = nn.Sequential(*blocks)

    def forward(self, x):
        return self.encoder(x)


class Decoder(nn.Module):
    def __init__(self, features: int, classes: int):
        super().__init__()
        self.layers = nn.Sequential(nn.Conv1d(features, classes, 1,
                                              bias=True))

    def forward(self, x):
        return torch.log_softmax(self.layers(x).transpose(1, 2), dim=2)


class BasecallModel(nn.Module):
    """Encoder stack + 1x1 decoder conv + log_softmax (basecall.py:77-270).

    Input (batch, features, time) float; output (batch, time/stride,
    n_classes) log-probabilities, classes = alphabet (blank first)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        super().__init__()
        cfg = config or DEFAULT_CONFIG
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg["block"][-1]["filters"],
                               len(cfg["labels"]["labels"]))

    def forward(self, x):
        return self.decoder(self.encoder(x))


class Basecaller:
    """Inference wrapper: the model in eval mode on its device."""

    def __init__(self, config: Dict[str, Any], model: BasecallModel,
                 device: Optional[str] = None):
        self.config = config
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.alphabet = config["labels"]["labels"]
        self.stride = config["block"][0]["stride"][0]

    @classmethod
    def init(cls, config: Optional[Dict[str, Any]] = None, seed: int = 0,
             chunksize: int = 3000,
             device: Optional[str] = None) -> "Basecaller":
        """Random weights from `torch.Generator` seeded with `seed`: conv
        kernels normal with variance 1/fan_in (flax's lecun_normal, not
        truncated), biases 0, BatchNorm the identity.  `chunksize` is
        kept for the JAX signature; the weights do not depend on it."""
        device = resolve_device(device)
        config = config or DEFAULT_CONFIG
        gen = torch.Generator().manual_seed(seed)
        model = BasecallModel(config)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, nn.Conv1d):
                    fan_in = m.weight.shape[1] * m.weight.shape[2]
                    m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                                   / math.sqrt(fan_in))
                    if m.bias is not None:
                        m.bias.zero_()
        return cls(config, model, device)

    def forward(self, chunks: np.ndarray) -> np.ndarray:
        """(n, time, features) -> (n, out_time, classes) log-probs, in
        float32 with cuDNN's TF32 off."""
        x = torch.from_numpy(np.ascontiguousarray(chunks, np.float32))
        x = x.to(self.device).transpose(1, 2)
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                         allow_tf32=False):
            out = self.model(x)
        return out.cpu().numpy()


# ---------------------------------------------------------------------------
# signal preprocessing (basecall.py:387-426)
# ---------------------------------------------------------------------------

def med_mad(x: np.ndarray, factor: float = 1.4826) -> Tuple[float, float]:
    med = np.median(x)
    mad = np.median(np.absolute(x - med)) * factor
    return med, mad


def norm_by_noisiest_section(signal: np.ndarray, samples: int = 100,
                             threshold: float = 6.0) -> np.ndarray:
    """Normalize by the med/mad of the noisiest contiguous section."""
    threshold = signal.std() / 0.75
    windows = signal[:len(signal) // samples * samples].reshape(-1, samples)
    noise = windows.std(axis=1)
    which = noise.argmax() if (noise > threshold).sum() == 0 \
        else np.argmax(noise > threshold)
    i, j = which * samples, (which + 1) * samples
    med, mad = med_mad(signal[i:j])
    return ((signal - med) / mad).astype(np.float32)


def chunk_signal(signal: np.ndarray, chunksize: int,
                 overlap: int) -> np.ndarray:
    """Overlapping chunks, zero-padded tail (basecall.py:312-323)."""
    if chunksize > 0 and signal.shape[0] > chunksize:
        step = chunksize - overlap
        num_chunks = signal.shape[0] // step + 1
        tmp = np.zeros(num_chunks * step, signal.dtype)
        tmp[:signal.shape[0]] = signal
        n_win = (tmp.shape[0] - chunksize) // step + 1
        idx = np.arange(chunksize)[None, :] + step * np.arange(n_win)[:, None]
        return tmp[idx][:, :, None]
    return signal[None, :, None]


def stitch_predictions(preds: np.ndarray, overlap: int) -> np.ndarray:
    """Drop overlap halves and concatenate (basecall.py:325-337)."""
    if preds.shape[0] == 1:
        return preds[0]
    parts = [preds[0, :-overlap]]
    parts += [preds[i][overlap:-overlap] for i in range(1, preds.shape[0] - 1)]
    parts.append(preds[-1][overlap:])
    return np.concatenate(parts)


# ---------------------------------------------------------------------------
# CTC decoding (fast_ctc_decode viterbi_search/beam_search equivalents)
# ---------------------------------------------------------------------------

def viterbi_decode(posteriors: np.ndarray, alphabet: Sequence[str],
                   qscores: bool = False, qscale: float = 1.0,
                   qbias: float = 0.0) -> Tuple[str, np.ndarray]:
    """Greedy best-path CTC: argmax per frame, collapse repeats, drop blank
    (class 0). Returns (sequence[+qstring if qscores], path frame indices)."""
    best = posteriors.argmax(axis=-1)
    prev = np.concatenate([[0], best[:-1]])
    keep = (best != 0) & (best != prev)
    path = np.nonzero(keep)[0]
    ids = best[path]
    seq = "".join(alphabet[i] for i in ids)
    if qscores:
        probs = posteriors[path, ids]
        q = np.clip(-10 * np.log10(np.clip(1 - probs, 1e-7, 1.0)), 0, 60)
        qstring = "".join(chr(int(round(x * qscale + qbias)) + 33) for x in q)
        return seq + qstring, path
    return seq, path


def beam_search_decode(posteriors: np.ndarray, alphabet: Sequence[str],
                       beamsize: int = 5,
                       threshold: float = 1e-3) -> Tuple[str, np.ndarray]:
    """Prefix beam search over CTC posteriors (host-side, like the
    reference's fast_ctc_decode.beam_search)."""
    T, C = posteriors.shape
    # beams: prefix tuple -> (p_blank, p_nonblank, path)
    beams: Dict[Tuple[int, ...], Tuple[float, float, Tuple[int, ...]]] = {
        (): (1.0, 0.0, ())}
    for t in range(T):
        frame = posteriors[t]
        nxt: Dict[Tuple[int, ...], Tuple[float, float, Tuple[int, ...]]] = {}

        def add(prefix, pb, pnb, path):
            opb, opnb, opath = nxt.get(prefix, (0.0, 0.0, path))
            npb, npnb = opb + pb, opnb + pnb
            if opb + opnb < pb + pnb:
                opath = path
            nxt[prefix] = (npb, npnb, opath)

        for prefix, (pb, pnb, path) in beams.items():
            p_total = pb + pnb
            add(prefix, frame[0] * p_total, 0.0, path)          # blank
            for c in range(1, C):
                p = frame[c]
                if p < threshold:
                    continue
                if prefix and prefix[-1] == c:
                    add(prefix, 0.0, p * pnb, path)             # repeat merge
                    add(prefix + (c,), 0.0, p * pb, path + (t,))  # via blank
                else:
                    add(prefix + (c,), 0.0, p * p_total, path + (t,))
        beams = dict(sorted(nxt.items(), key=lambda kv: -(kv[1][0] + kv[1][1]))
                     [:beamsize])
    prefix, (_, _, path) = max(beams.items(),
                               key=lambda kv: kv[1][0] + kv[1][1])
    seq = "".join(alphabet[c] for c in prefix)
    return seq, np.asarray(path[:len(prefix)], np.int64)


# ---------------------------------------------------------------------------
# bonito model directories (load_model, basecall.py:275-310)
# ---------------------------------------------------------------------------

def _load_toml(path: str) -> Dict[str, Any]:
    try:
        import tomllib
        with open(path, "rb") as f:
            return tomllib.load(f)
    except ImportError:
        import toml  # type: ignore
        return toml.load(path)


def load_torch_checkpoint(model_dir: str, weights: str = "0",
                          device: Optional[str] = None) -> Basecaller:
    """Load a bonito model directory (config.toml + weights_<n>.tar): the
    state dict goes into the model as it is, strictly."""
    device = resolve_device(device)
    config = _load_toml(os.path.join(model_dir, "config.toml"))
    state = torch.load(os.path.join(model_dir, f"weights_{weights}.tar"),
                       map_location="cpu")
    model = BasecallModel(config)
    model.load_state_dict(state, strict=True)
    return Basecaller(config, model, device)


# ---------------------------------------------------------------------------
# command line (basecall.py main :600-660)
# ---------------------------------------------------------------------------

def basecall_reads(caller: Basecaller, reads: List[Tuple[str, np.ndarray]],
                   chunksize: int = 3000, overlap: int = 0,
                   beamsize: int = 5, fastq: bool = False,
                   out=None) -> Tuple[int, float]:
    """Normalize, chunk, forward (one call per read), stitch, decode,
    write fasta/fastq. Returns (total_samples, roi_seconds)."""
    out = out or sys.stdout
    samples = 0
    t0 = time.perf_counter()
    for read_id, signal in reads:
        samples += len(signal)
        norm = norm_by_noisiest_section(signal) if signal.dtype != np.float32 \
            else signal
        chunks = chunk_signal(norm, chunksize, overlap)
        logp = caller.forward(chunks)
        post = np.exp(logp.astype(np.float32))
        stitched = stitch_predictions(
            post, overlap // caller.stride // 2) if overlap else \
            (post.reshape(-1, post.shape[-1]) if post.shape[0] > 1 else post[0])
        if fastq or beamsize == 1:
            sq, path = viterbi_decode(stitched, caller.alphabet, qscores=True)
            seq, qstring = sq[:len(path)], sq[len(path):]
        else:
            seq, _ = beam_search_decode(stitched, caller.alphabet, beamsize)
            qstring = "*"
        if seq:
            if fastq:
                out.write(f"@{read_id}\n{seq}\n+\n{qstring}\n")
            else:
                out.write(f">{read_id}\n{seq}\n")
    return samples, time.perf_counter() - t0


def _load_reads_dir(path: str) -> List[Tuple[str, np.ndarray]]:
    """Read signals from a directory: .npy (one signal per file) or fast5
    via h5py when present."""
    reads = []
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if name.endswith(".npy"):
            reads.append((name[:-4], np.load(full)))
        elif name.endswith(".fast5"):
            try:
                import h5py  # type: ignore
            except ImportError as e:
                raise RuntimeError("fast5 input requires h5py") from e
            with h5py.File(full, "r") as f:
                for rk in f:
                    grp = f[rk]
                    sig = grp["Raw/Signal"][()] if "Raw" in grp else None
                    if sig is not None:
                        reads.append((rk.replace("read_", ""), np.asarray(sig)))
    return reads


def run(argv: Sequence[str]) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="nn-base")
    p.add_argument("model_directory")
    p.add_argument("reads_directory")
    p.add_argument("--weights", default="0")
    p.add_argument("--beamsize", default=5, type=int)
    p.add_argument("--chunksize", default=0, type=int)
    p.add_argument("--overlap", default=0, type=int)
    p.add_argument("--fastq", action="store_true", default=False)
    args = p.parse_args(argv)

    dev = resolve_device()
    sys.stderr.write("> loading model\n")
    if args.model_directory == "default":
        caller = Basecaller.init(chunksize=args.chunksize or 3000, device=dev)
    else:
        caller = load_torch_checkpoint(args.model_directory, args.weights,
                                       device=dev)
    reads = _load_reads_dir(args.reads_directory)
    sys.stderr.write("> calling\n")
    samples, dur = basecall_reads(
        caller, reads, chunksize=args.chunksize, overlap=args.overlap,
        beamsize=args.beamsize, fastq=args.fastq)
    sys.stderr.write(f"> completed reads: {len(reads)}\n")
    sys.stderr.write(f"> duration: {dur:.1f}s\n")
    sys.stderr.write("> samples per second %.1E\n" % (samples / dur))
    sys.stderr.write("> done\n")
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
