"""nn-base training: one step of the QuartzNet-CTC basecaller, the
counterpart of the step in the JAX package's
`__graft_entry__.dryrun_multichip` (the JAX package's only training
path): the forward with live BatchNorm statistics, optax's CTC loss and
optax's AdamW, and the new running statistics.

What it holds to, against optax and flax:
  * `ctc_loss` is `optax.ctc_loss(...).mean()`: each sequence's -log p,
    not divided by its label length (torch's reduction="mean" divides),
    averaged over the batch.  optax takes logits and applies its own
    log_softmax; the model's output is already log-probabilities, and a
    second log_softmax would change nothing.
  * `adamw` is `optax.adamw(1e-3)`: weight decay 1e-4 (torch's default
    is 1e-2) on every parameter, BatchNorm's scale and bias and the
    decoder's bias included (optax's default has no mask).
  * BatchNorm follows flax's training rule (`basecall.BatchNorm`).

On a `Grid` (dp, sp, tp) the forward is split as JAX shards the step:
dp splits the batch; sp splits the time axis, gathered before each conv
that reaches across frames and split again after it, and before the
loss; tp splits every conv's out-features, whose channel blocks are
gathered before each conv that needs every input channel (a depthwise
conv needs only its own).  BatchNorm sums its statistics over the dp x
sp shards, so they are the global batch's.  The decoder, whose 5
classes do not split over tp, runs whole on the tp = 0 shards.  One set
of parameters and optimizer state lives on the grid's first device and
each shard takes `.to()` slices of it, so autograd sums the shards'
gradients (JAX's psum over dp).  The collectives are `sharding/mesh.py`'s
`psum` and `all_gather` over the grid's sub-meshes; inside one process
they are copies, sums and concatenations, through which autograd flows.
Training across processes is not ported: under a process group of more
than one process `train_step` raises.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from genarchbench_tpu_torch.core.backend import resolve_device
from genarchbench_tpu_torch.nn.basecall import (BasecallModel, BatchNorm,
                                                Swish, TCSConv)
from genarchbench_tpu_torch.sharding.mesh import Grid, all_gather, psum

LR = 1e-3
WEIGHT_DECAY = 1e-4           # optax.adamw's default


def ctc_loss(log_probs: torch.Tensor, labels: torch.Tensor,
             label_pad: torch.Tensor) -> torch.Tensor:
    """`optax.ctc_loss(logits, 0, labels, label_pad).mean()` on the
    model's (B, T', C) log-probabilities, blank 0: labels (B, L), their
    padding (B, L) 1.0 past each label's end."""
    return _ctc_per_sequence(log_probs, labels, label_pad).mean()


def _ctc_per_sequence(log_probs, labels, label_pad):
    B, T, _ = log_probs.shape
    return F.ctc_loss(
        log_probs.transpose(0, 1), labels.long(),
        input_lengths=torch.full((B,), T, dtype=torch.long),
        target_lengths=(1 - label_pad).sum(1).long(),
        blank=0, reduction="none")


def adamw(params) -> torch.optim.AdamW:
    """`optax.adamw(1e-3)`: one parameter group, every parameter decayed."""
    return torch.optim.AdamW(params, lr=LR, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=WEIGHT_DECAY)


def _check_trainable(model: BasecallModel) -> None:
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise RuntimeError(
            "nn-base training runs in one process; training across "
            "processes (autograd through torch.distributed collectives) is "
            "ROADMAP item 14")
    for m in model.modules():
        if isinstance(m, nn.Dropout) and m.p > 0:
            raise ValueError(
                f"a training step with dropout {m.p}: the JAX step passes no "
                "dropout RNG, so it trains only configs with dropout 0.0")


def train_step(model: BasecallModel, opt: torch.optim.Optimizer,
               x: torch.Tensor, labels: torch.Tensor,
               label_pad: torch.Tensor,
               grid: Optional[Grid] = None) -> torch.Tensor:
    """One step on x (B, features, T) NCW: the forward in train mode,
    `ctc_loss`, the backward, `opt.step()`, with cuDNN's TF32 off.  The
    model keeps its new running statistics and each parameter's `.grad`;
    returns the loss (detached, on the model's device).  Without a grid
    the step runs on the model's device; on a grid the model must live
    on the grid's first device."""
    _check_trainable(model)
    model.train()
    opt.zero_grad(set_to_none=True)
    dev = next(model.parameters()).device
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        if grid is None:
            loss = ctc_loss(model(x.to(dev)), labels.to(dev),
                            label_pad.to(dev))
        else:
            loss = _grid_loss(model, x, labels, label_pad, grid)
        loss.backward()
    opt.step()
    return loss.detach()


def step_from_state(config: Dict[str, Any], state: Dict[str, torch.Tensor],
                    x: torch.Tensor, labels: torch.Tensor,
                    label_pad: torch.Tensor, grid: Optional[Grid] = None,
                    device=None
                    ) -> Tuple[float, Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """`train_step` from a state dict, with a fresh `adamw`: the model on
    the grid's first device, else on `device` (the card unless asked for
    the CPU).  Returns the loss, the new state dict and each parameter's
    gradient by name, on the CPU."""
    dev = grid.devices[0] if grid is not None else resolve_device(device)
    model = BasecallModel(config)
    model.load_state_dict(state)
    model.to(dev)
    loss = train_step(model, adamw(model.parameters()), x, labels,
                      label_pad, grid)
    new = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    return float(loss), new, grads


# ---------------------------------------------------------------------------
# the forward over a (dp, sp, tp) grid: lists of per-shard tensors, shard g
# at the grid's coordinates (d, s, t), each (B / dp, channels, frames / sp)
# with its tp block of the channels when `split`, else all of them
# ---------------------------------------------------------------------------

def _gather(grid: Grid, hs: Sequence[torch.Tensor], axis: str,
            dim: int) -> List[torch.Tensor]:
    """Each shard's tensor concatenated along `dim` with those of the
    shards that differ from it along `axis`, in that axis' order."""
    out = list(hs)
    for shards, mesh in grid.lines((axis,)):
        full = all_gather(mesh, [hs[g].movedim(dim, 0) for g in shards])
        for g, f in zip(shards, full):
            out[g] = f.movedim(0, dim)
    return out


def _psum_dp_sp(grid: Grid, vs: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
    """Each shard's tensor summed over the shards that hold its channels."""
    out = list(vs)
    for shards, mesh in grid.lines(("dp", "sp")):
        for g, v in zip(shards, psum(mesh, [vs[g] for g in shards])):
            out[g] = v
    return out


def _conv(grid: Grid, conv: nn.Conv1d, hs, split: bool):
    _, sp, tp = grid.shape
    cout = conv.out_channels
    if cout % tp:
        raise ValueError(f"{cout} out-features do not split over tp = {tp}")
    o = cout // tp
    depthwise = conv.groups > 1            # TCSConv's groups: 1 or in
    if split and not depthwise:
        hs = _gather(grid, hs, "tp", 1)
    whole = sp > 1 and (conv.kernel_size[0] > 1 or conv.stride[0] > 1
                        or conv.padding[0] > 0)
    if whole:
        hs = _gather(grid, hs, "sp", 2)
    out = []
    for g, h in enumerate(hs):
        _, s, t = grid.coords(g)
        blk = slice(t * o, (t + 1) * o)
        if depthwise and not split:
            h = h[:, blk]
        w = conv.weight[blk].to(h.device)
        b = None if conv.bias is None else conv.bias[blk].to(h.device)
        y = F.conv1d(h, w, b, conv.stride, conv.padding, conv.dilation,
                     o if depthwise else 1)
        if whole:
            n = y.shape[2]
            if n % sp:
                raise ValueError(f"{n} frames do not split over sp = {sp}")
            y = y[:, :, s * (n // sp):(s + 1) * (n // sp)]
        out.append(y)
    return out, True


def _layer(grid: Grid, m: nn.Module, hs, split: bool):
    if isinstance(m, nn.Sequential):
        for sub in m:
            hs, split = _layer(grid, sub, hs, split)
        return hs, split
    if isinstance(m, TCSConv):
        if m.separable:
            hs, split = _conv(grid, m.depthwise, hs, split)
            return _conv(grid, m.pointwise, hs, split)
        return _conv(grid, m.conv, hs, split)
    if isinstance(m, BatchNorm):
        f = m.num_features // grid.shape[2]
        blocks = [slice(t * f, (t + 1) * f)
                  for t in (grid.coords(g)[2] for g in range(len(hs)))]
        return m.forward_shards(hs, blocks,
                                lambda v: _psum_dp_sp(grid, v)), split
    if isinstance(m, Swish):
        return [m(h) for h in hs], split
    if isinstance(m, nn.Dropout):          # p == 0, as _check_trainable held
        return hs, split
    raise TypeError(f"no sharded form of {type(m).__name__}")


def _grid_loss(model: BasecallModel, x, labels, label_pad,
               grid: Grid) -> torch.Tensor:
    dp, sp, tp = grid.shape
    B, _, T = x.shape
    if B % dp or T % sp:
        raise ValueError(f"a batch of {B} x {T} samples does not split over "
                         f"dp = {dp}, sp = {sp}")
    b, ts = B // dp, T // sp
    hs = []
    for g, dev in enumerate(grid.devices):
        d, s, _ = grid.coords(g)
        hs.append(x[d * b:(d + 1) * b, :, s * ts:(s + 1) * ts].to(dev))
    split = False
    for block in model.encoder.encoder:
        inp, inp_split = hs, split
        for m in block.conv:
            hs, split = _layer(grid, m, hs, split)
        if block.use_res:
            res, _ = _layer(grid, block.residual, inp, inp_split)
            hs = [h + r for h, r in zip(hs, res)]
        hs, split = _layer(grid, block.activation, hs, split)
    if split and tp > 1:
        hs = _gather(grid, hs, "tp", 1)
    dec = model.decoder.layers[0]
    total = 0.0
    for shards, mesh in grid.lines(("sp",)):
        d, _, t = grid.coords(shards[0])
        if t:
            continue
        lps = [torch.log_softmax(F.conv1d(hs[g], dec.weight.to(hs[g].device),
                                          dec.bias.to(hs[g].device)
                                          ).transpose(1, 2), dim=2)
               for g in shards]
        lp = all_gather(mesh, [p.transpose(0, 1) for p in lps])[0]
        dev = lp.device
        rows = slice(d * b, (d + 1) * b)
        total = total + _ctc_per_sequence(
            lp.transpose(0, 1), labels[rows].to(dev),
            label_pad[rows].to(dev)).sum().to(grid.devices[0])
    return total / B
