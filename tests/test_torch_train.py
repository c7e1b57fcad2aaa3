"""The port's nn-base training step (`nn/train.py`, `entry.dryrun_multichip`)
against the JAX step of `__graft_entry__.dryrun_multichip`, on the CPU.

The JAX step is rebuilt here as `__graft_entry__.py:63-116` writes it
(that function returns nothing): `BasecallModel(deterministic=False)` at
`_tiny_config(8 x tp)`, `optax.ctc_loss(...).mean()`, `optax.adamw(1e-3)`,
jitted over JAX's own (dp, sp, tp) mesh and shardings of 2 and 1 of the 8
virtual host devices.  At n = 8 (2, 2, 2) XLA's SPMD partitioner on this
host computes another step than the same jit on one device: with the
conv kernels split over tp and x over sp, the stride-3 conv and the
depthwise convs come out wrong (loss 29.3861 against 29.1550), and with
the kernels replicated, the gradients of every conv that reaches across
frames come out doubled (`test_jax_mesh_of_8_is_not_its_one_device_step`).
So at n = 8 the port is held to the JAX step at the same config and
batch jitted on one device.  The port runs on a CPU grid of the same n,
from JAX's initial variables (`convert.basecall_state_from_jax`).

Two inputs: the dryrun's own (all-ones chunks, labels of eight 1s, no
padding) and a seeded standard-normal input with labels of mixed lengths
and padding.  Tolerances (float32 in both; sums in other orders):
  loss: relative 1e-5;
  gradients, per tensor, max |g_port - g_jax| over ||g_jax||: 2e-5 on the
    normal input, 2e-3 on the all-ones input, whose near-constant frames
    make BatchNorm's E[x^2] - E[x]^2 cancel (12 of 2069 gradient
    elements there are below 1e-6);
  updated parameters: absolute 1e-5 where JAX's |g| exceeds the
    gradient tolerance times the tensor's norm (there both gradients have
    one sign), elsewhere within 2 x lr (+ 1e-6): AdamW's first step
    moves a parameter by about lr g / (|g| + 1e-8), so a gradient that is
    float noise may move the two by lr in opposite directions (on the
    all-ones input, elements up to 2e-4 of the first conv's gradient,
    whose norm is 7.5, are such noise);
  running statistics: absolute 1e-6 (normal), 1e-4 (all-ones).
The port's n-shard step is held to its one-shard step at the same config
and batch: on the normal input loss relative 1e-6 and gradients 1e-5 of
the norm, on the all-ones input the tolerances against JAX (its float
noise is the same between two summation orders of the port's); the
parameters and statistics as against JAX.
"""

import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import __graft_entry__ as graft
from genarchbench_tpu.nn.basecall import BasecallModel as JaxModel
from genarchbench_tpu_torch.convert import basecall_state_from_jax
from genarchbench_tpu_torch.entry import dryrun_multichip, tiny_config
from genarchbench_tpu_torch.nn import basecall as bc
from genarchbench_tpu_torch.nn import train
from genarchbench_tpu_torch.sharding import mesh as M

REPO = pathlib.Path(__file__).resolve().parent.parent
T, L = 96, 8
LR = 1e-3
TOL = {"ones": dict(grad=2e-3, stats=1e-4, loss_self=1e-5, grad_self=2e-3),
       "normal": dict(grad=2e-5, stats=1e-6, loss_self=1e-6, grad_self=1e-5)}


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")


def jax_factors(n):
    """`__graft_entry__.py:57-61`."""
    tp = 2 if n % 2 == 0 else 1
    sp = 2 if n % 4 == 0 else 1
    return n // (tp * sp), sp, tp


def inputs(dp, seed=5):
    """(x (B, T, 1), labels (B, L) int32, label_pad (B, L) float32) by name."""
    B = 2 * dp
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, 1)).astype(np.float32)
    lens = L - 2 * (np.arange(B) % 3)
    pad = (np.arange(L)[None] >= lens[:, None]).astype(np.float32)
    lab = np.where(pad > 0, 0, rng.integers(1, 5, (B, L))).astype(np.int32)
    return {"ones": (np.ones((B, T, 1), np.float32),
                     np.ones((B, L), np.int32), np.zeros((B, L), np.float32)),
            "normal": (x, lab, pad)}


def jax_step_fn(n, mesh_step=True, shard_kernels=True):
    """The dryrun's step at n devices: (cfg, variables, step) where
    step(x, labels, pad) -> (loss, grads, new params, new batch_stats), on
    JAX's mesh and shardings, or jitted on one device."""
    dp, sp, tp = jax_factors(n)
    cfg = graft._tiny_config(filters=8 * tp)
    model = JaxModel(config=cfg, deterministic=False)
    B = 2 * dp
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((B, T, 1), jnp.float32))
    params, stats = variables["params"], variables["batch_stats"]
    opt = optax.adamw(LR)
    ostate = opt.init(params)

    def loss_fn(p, b, x, lab, pad):
        logits, upd = model.apply({"params": p, "batch_stats": b}, x,
                                  mutable=["batch_stats"])
        return optax.ctc_loss(logits, jnp.zeros(logits.shape[:2]), lab,
                              pad).mean(), upd["batch_stats"]

    @jax.jit
    def step(p, b, s, x, lab, pad):
        (loss, nb), g = jax.value_and_grad(loss_fn, has_aux=True)(
            p, b, x, lab, pad)
        u, _ = opt.update(g, s, p)
        return loss, g, optax.apply_updates(p, u), nb

    if not mesh_step:
        return cfg, variables, lambda *a: step(params, stats, ostate, *a)
    mesh = JMesh(np.asarray(jax.devices()[:n]).reshape(dp, sp, tp),
                 ("dp", "sp", "tp"))
    shard = lambda spec: NamedSharding(mesh, spec)

    def param_spec(path, leaf):          # __graft_entry__.py:81-85
        if shard_kernels and leaf.ndim == 3 and leaf.shape[-1] % tp == 0:
            return P(None, None, "tp")
        return P()

    rep = shard(P())
    p_s = jax.device_put(params, jax.tree.map(
        shard, jax.tree_util.tree_map_with_path(param_spec, params),
        is_leaf=lambda v: isinstance(v, P)))
    b_s = jax.device_put(stats, jax.tree.map(lambda _: rep, stats))
    s_s = jax.device_put(ostate, jax.tree.map(lambda _: rep, ostate))

    def run(x, lab, pad):
        with mesh:
            return step(p_s, b_s, s_s,
                        jax.device_put(x, shard(P("dp", "sp", None))),
                        jax.device_put(lab, shard(P("dp", None))),
                        jax.device_put(pad, shard(P("dp", None))))
    return cfg, variables, run


def to_numpy(tree):
    return jax.tree.map(np.array, jax.tree.map(np.asarray, tree))


def as_state(cfg, params, stats):
    return basecall_state_from_jax({"params": to_numpy(params),
                                    "batch_stats": to_numpy(stats)}, cfg)


def torch_batch(x, lab, pad):
    return (torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))),
            torch.from_numpy(lab).long(), torch.from_numpy(pad))


@pytest.fixture(scope="module", params=[8, 2, 1], ids=lambda n: f"n{n}")
def steps(request):
    """For each input: JAX's step and the port's on a CPU grid of n and on
    one shard, all from JAX's initial variables."""
    n = request.param
    cfg, variables, run = jax_step_fn(n, mesh_step=n != 8)
    init = as_state(cfg, variables["params"], variables["batch_stats"])
    grid = M.data_grid(n, "cpu")
    out = {}
    for name, (x, lab, pad) in inputs(jax_factors(n)[0]).items():
        loss, g, p, nb = run(x, lab, pad)
        batch = torch_batch(x, lab, pad)
        out[name] = dict(
            jax=(float(loss), as_state(cfg, g, variables["batch_stats"]),
                 as_state(cfg, p, nb)),
            grid=train.step_from_state(cfg, init, *batch, grid=grid),
            one=train.step_from_state(cfg, init, *batch, device="cpu"))
    return n, cfg, out


def check_grads(got, want, tol):
    for k in want:
        err = float((got[k] - want[k]).abs().max() / want[k].norm())
        assert err <= tol, (k, err, tol)


def check_state(got, want, grads, stats_tol, grad_tol):
    """Parameters within 1e-5 where |g| exceeds the gradients' tolerance
    (grad_tol x the tensor's norm: there the two gradients have one
    sign), else within 2 lr; running statistics within stats_tol."""
    for k, w in want.items():
        d = (got[k] - w).abs()
        if k.endswith(("running_mean", "running_var")):
            assert float(d.max()) <= stats_tol, (k, float(d.max()))
        elif k in grads:
            sure = grads[k].abs() > grad_tol * grads[k].norm()
            assert not sure.any() or float(d[sure].max()) <= 1e-5, k
            assert float(d.max()) <= 2 * LR + 1e-6, k


@pytest.mark.parametrize("name", ["ones", "normal"])
def test_step_matches_jax(steps, name):
    n, cfg, out = steps
    jloss, jgrads, jstate = out[name]["jax"]
    loss, state, grads = out[name]["grid"]
    assert np.isfinite(loss)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss), (loss, jloss)
    assert grads.keys() == jgrads.keys() - {
        k for k in jgrads if k.endswith(("running_mean", "running_var",
                                         "num_batches_tracked"))}
    jgrads = {k: jgrads[k] for k in grads}
    check_grads(grads, jgrads, TOL[name]["grad"])
    check_state(state, jstate, jgrads, TOL[name]["stats"], TOL[name]["grad"])


@pytest.mark.parametrize("name", ["ones", "normal"])
def test_grid_step_matches_one_shard(steps, name):
    n, cfg, out = steps
    loss, state, grads = out[name]["grid"]
    oloss, ostate, ograds = out[name]["one"]
    assert abs(loss - oloss) <= TOL[name]["loss_self"] * abs(oloss)
    check_grads(grads, ograds, TOL[name]["grad_self"])
    check_state(state, ostate, ograds, TOL[name]["stats"],
                TOL[name]["grad_self"])


def test_jax_mesh_of_8_is_not_its_one_device_step():
    """The JAX fault that makes the n = 8 oracle the one-device jit: on
    (2, 2, 2), XLA's partitioned step differs from the same step on one
    device, in the loss with the dryrun's tp-split kernels (the dryrun's
    own input) and in the gradients of the k 9 convs with replicated
    kernels (twice as large), while the port equals the one-device step
    (test_step_matches_jax)."""
    batches = inputs(2)
    _, _, one = jax_step_fn(8, mesh_step=False)
    _, _, split = jax_step_fn(8, shard_kernels=True)
    _, _, rep = jax_step_fn(8, shard_kernels=False)
    loss1 = float(one(*batches["ones"])[0])
    assert abs(float(split(*batches["ones"])[0]) - loss1) > 1e-3 * loss1
    _, g1, _, _ = one(*batches["normal"])
    loss_r, g_r, _, _ = rep(*batches["normal"])
    assert abs(float(loss_r) - float(one(*batches["normal"])[0])) <= 1e-5 * 30
    k1 = np.asarray(g1["block0"]["tcs0"]["conv"]["kernel"])
    kr = np.asarray(g_r["block0"]["tcs0"]["conv"]["kernel"])
    assert np.abs(kr - 2 * k1).max() <= 1e-4 * np.linalg.norm(k1)


def test_mesh_factors_and_grid_order():
    for n in range(1, 9):
        assert M.mesh_factors(n) == jax_factors(n)
    devs = tuple(torch.device("cpu", i) for i in range(8))
    grid = M.Grid(devs, (2, 2, 2))
    jax_order = np.arange(8).reshape(2, 2, 2)
    for g in range(8):
        assert jax_order[grid.coords(g)] == g
    for axis, want in (("dp", [[0, 4], [1, 5], [2, 6], [3, 7]]),
                       ("sp", [[0, 2], [1, 3], [4, 6], [5, 7]]),
                       ("tp", [[0, 1], [2, 3], [4, 5], [6, 7]])):
        lines = grid.lines((axis,))
        assert [s for s, _ in lines] == want
        assert all(m.devices == tuple(devs[g] for g in s) for s, m in lines)
    assert [s for s, _ in grid.lines(("dp", "sp"))] == [[0, 2, 4, 6],
                                                        [1, 3, 5, 7]]
    with pytest.raises(ValueError, match="needs 8 devices"):
        M.Grid(devs[:7], (2, 2, 2))
    assert M.data_grid(2, "cpu").devices == (torch.device("cpu"),) * 2


def test_batchnorm_against_flax():
    """Train mode: output, running mean and the biased running variance
    against flax's BatchNorm (momentum 0.9, eps 1e-3) on one tensor with
    a mean of 3 (E[x^2] - E[x]^2 cancels in part); torch's own
    BatchNorm1d updates with the unbiased variance.
    Then the same batch over four shards (two of rows, two of frames)
    with the sums reduced equals the whole."""
    rng = np.random.default_rng(0)
    x = (3 + rng.standard_normal((3, 7, 4)) * [0.5, 1, 2, 4]).astype(
        np.float32)                                        # NWC
    scale = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-3)
    v = fbn.init(jax.random.PRNGKey(0), x)
    v = {"params": {"scale": scale, "bias": bias},
         "batch_stats": v["batch_stats"]}
    want, upd = fbn.apply(v, x, mutable=["batch_stats"])
    want = np.asarray(want).transpose(0, 2, 1)
    var = np.asarray(upd["batch_stats"]["var"])

    xt = torch.from_numpy(x.transpose(0, 2, 1).copy())
    bn = bc.BatchNorm(4).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    got = bn(xt).detach().numpy()
    assert np.abs(got - want).max() <= 1e-4
    assert np.allclose(bn.running_mean.numpy(),
                       np.asarray(upd["batch_stats"]["mean"]), atol=1e-5)
    assert np.allclose(bn.running_var.numpy(), var, rtol=1e-5, atol=1e-5)
    plain = torch.nn.BatchNorm1d(4, eps=1e-3).train()
    plain(xt)
    assert not np.allclose(plain.running_var.numpy(), var, rtol=1e-3)
    assert bn.eval()(xt).shape == xt.shape           # eval: torch's BN

    bn2 = bc.BatchNorm(4).train()
    with torch.no_grad():
        bn2.weight.copy_(torch.from_numpy(scale))
        bn2.bias.copy_(torch.from_numpy(bias))
    parts = [xt[:2, :, :4], xt[:2, :, 4:], xt[2:, :, :4], xt[2:, :, 4:]]
    total = lambda vs: [sum(vs)] * len(vs)
    outs = bn2.forward_shards(parts, [slice(None)] * 4, total)
    whole = torch.cat([torch.cat(outs[:2], 2), torch.cat(outs[2:], 2)])
    assert np.abs(whole.detach().numpy() - want).max() <= 1e-4
    assert np.allclose(bn2.running_var.numpy(), var, rtol=1e-5, atol=1e-5)


def test_ctc_loss_against_optax():
    """optax's per-sequence loss averaged over the batch, padded labels of
    mixed lengths: not torch's reduction="mean", which divides each
    sequence's loss by its label length."""
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 20, 5)).astype(np.float32)
    lab = rng.integers(1, 5, (3, 6)).astype(np.int32)
    pad = (np.arange(6)[None] >= np.array([6, 3, 1])[:, None]).astype(
        np.float32)
    want = float(optax.ctc_loss(logits, np.zeros((3, 20), np.float32), lab,
                                pad).mean())
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    got = float(train.ctc_loss(lp, torch.from_numpy(lab),
                               torch.from_numpy(pad)))
    assert abs(got - want) <= 1e-5 * abs(want)
    mean = float(torch.nn.functional.ctc_loss(
        lp.transpose(0, 1), torch.from_numpy(lab).long(), [20] * 3,
        [6, 3, 1], reduction="mean"))
    assert abs(mean - want) > 0.1 * abs(want)


def test_adamw_against_optax():
    """Two steps of `train.adamw` against optax.adamw(1e-3) on a
    BatchNorm scale, a bias and a conv kernel: every parameter decays by
    1e-4 (no mask), so the scale shrinks under a zero gradient."""
    rng = np.random.default_rng(2)
    params = {"scale": np.ones(4, np.float32),
              "bias": rng.standard_normal(4).astype(np.float32),
              "kernel": rng.standard_normal((3, 2, 4)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    for g in grads:
        g["scale"][:] = 0
    opt = optax.adamw(LR)
    jp, js = dict(params), opt.init(params)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    topt = train.adamw(tp.values())
    for g in grads:
        u, js = opt.update(g, js, jp)
        jp = optax.apply_updates(jp, u)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k in params:
        assert np.allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                           atol=1e-7, rtol=1e-6), k
    shrunk = (1 - LR * 1e-4) ** 2
    assert np.allclose(tp["scale"].detach().numpy(), shrunk, atol=1e-8)
    assert len(topt.param_groups) == 1


def test_train_step_raises(monkeypatch):
    cfg = tiny_config(8)
    model = bc.BasecallModel(cfg)
    x, lab, pad = torch_batch(*inputs(1)["ones"])
    wet = tiny_config(8)
    wet["block"][1]["dropout"] = 0.1
    wet_model = bc.BasecallModel(wet)
    with pytest.raises(ValueError, match="dropout 0.1"):
        train.train_step(wet_model, train.adamw(wet_model.parameters()),
                         x, lab, pad)
    # a grid whose sp does not divide the strided conv's 33 frames raises
    # where a slice would silently cut frames
    grid = M.Grid((torch.device("cpu"),) * 2, (1, 2, 1))
    x98 = torch.ones((2, 1, 98))
    with pytest.raises(ValueError, match="33 frames do not split"):
        train.train_step(model, train.adamw(model.parameters()), x98, lab,
                         pad, grid)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(RuntimeError, match="ROADMAP item 14"):
        train.train_step(model, train.adamw(model.parameters()), x, lab, pad)


def test_dryrun_multichip(capsys):
    """JAX's line and fields on 8 CPU shards; the step equals the port's
    one-shard step from the same seeded weights."""
    res = dryrun_multichip(8)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    m = re.fullmatch(r"dryrun_multichip ok: mesh dp=2 sp=2 tp=2 "
                     r"loss=(\S+) kmer_all_to_all=(\d+) "
                     r"fmi_sharded_smems=(\d+)", line)
    assert m, line
    assert float(m.group(1)) == pytest.approx(res["loss"], abs=1e-4)
    assert (int(m.group(2)), int(m.group(3))) == (
        res["kmer_all_to_all"], res["fmi_sharded_smems"]) == (1710, 20)
    assert res["config"] == graft._tiny_config(filters=16) == tiny_config(16)
    oloss, ostate, ograds = train.step_from_state(
        res["config"], res["initial"], *res["batch"], device="cpu")
    assert abs(res["loss"] - oloss) <= TOL["ones"]["loss_self"] * abs(oloss)
    check_grads(res["grads"], ograds, TOL["ones"]["grad_self"])
    check_state(res["state"], ostate, ograds, TOL["ones"]["stats"],
                TOL["ones"]["grad_self"])


def test_module_entry_point():
    r = subprocess.run([sys.executable, "-m", "genarchbench_tpu_torch.entry",
                        "2"], cwd=REPO,
                       env={**os.environ, "GENARCH_DEVICE": "cpu"},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert re.fullmatch(r"dryrun_multichip ok: mesh dp=1 sp=1 tp=2 "
                        r"loss=\d+\.\d{4} kmer_all_to_all=1710 "
                        r"fmi_sharded_smems=20\n", r.stdout), r.stdout
