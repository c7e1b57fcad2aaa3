"""Inputs for the poa port's tests and chip_smoke.py, numpy only.

`batches_text` writes windows of noisy copies of a random base in the
reference program's batch format (a header whose second character is '0'
opens a window), with any number of reads a window and empty reads;
`bench_input` is the JAX bench's poa input (bench.py:141-161) draw for
draw; `random_round` makes one dispatch's DP inputs over random
rank-ordered graphs of up to P in-edges a node, with the column-0
boundary series the graph export computes, in the port's named layout;
`jax_blob` packs such a round as the JAX package's flat input blob.
"""

import numpy as np

NEG = -(1 << 28)
ROUND = ("node_ch", "seq", "preds", "npred", "H0col", "F0col", "O0col",
         "endmask", "Wlen")


def noisy_copy(rng, base: str, cuts) -> str:
    """base with substitutions, insertions after a base and deletions: a
    uniform draw a base below cuts[0], cuts[1] or cuts[2] makes each
    (tests/test_poa.py::gen_batches' and bench.py's draws)."""
    seq = []
    for ch in base:
        r = rng.random()
        if r < cuts[0]:
            seq.append("ACGT"[rng.integers(0, 4)])
        elif r < cuts[1]:
            seq.append(ch + "ACGT"[rng.integers(0, 4)])
        elif r < cuts[2]:
            pass
        else:
            seq.append(ch)
    return "".join(seq)


def batches_text(rng, n_reads=(6, 6, 6), length=80, err=0.08,
                 empty=()) -> str:
    """One window per entry of n_reads, each that many noisy copies of a
    random base of `length` bases; (window, read) pairs in `empty` are
    written as empty reads."""
    out = []
    for b, n in enumerate(n_reads):
        base = "".join("ACGT"[c] for c in rng.integers(0, 4, length))
        for s in range(n):
            seq = "" if (b, s) in empty else noisy_copy(
                rng, base, (err / 3, 2 * err / 3, err))
            out.append(f"s{'0' if s == 0 else '1'}_{b}_{s}\n{seq}\n")
    return "".join(out)


def bench_input(n_windows=256) -> str:
    """bench.py's poa input: n_windows windows of 10 reads of a 250-base
    draw with 3% substitutions, insertions and deletions (seed 105)."""
    rng_p = np.random.default_rng(105)
    out = []
    for b in range(n_windows):
        base = "".join("ACGT"[c] for c in rng_p.integers(0, 4, 250))
        for s in range(10):
            out.append(f"s{'0' if s == 0 else '1'}_{b}_{s}\n"
                       + noisy_copy(rng_p, base, (0.03, 0.06, 0.09))
                       + "\n")
    return "".join(out)


def random_round(rng, G, R, W, P, pen, pad_lanes=1):
    """One dispatch's DP inputs over G random graphs (ranks <= R, query
    lengths <= W, some rank of every graph with P in-edges when it has
    room) and pad_lanes empty lanes, as `export_dp` and `_align_group`
    lay them out: a dict of numpy arrays by ROUND's names (H0col, F0col,
    O0col int32) and the largest rank count."""
    m, n, g, e, q, c = pen
    Gt, W1 = G + pad_lanes, W + 1
    a = dict(node_ch=np.full((Gt, R), -2, np.int32),
             seq=np.full((Gt, W1), -1, np.int32),
             preds=np.zeros((Gt, R, P), np.int32),
             npred=np.ones((Gt, R), np.int32),
             O0col=np.full((Gt, R + 1), NEG, np.int64),
             F0col=np.full((Gt, R + 1), NEG, np.int64),
             endmask=np.zeros((Gt, R), bool), Wlen=np.zeros(Gt, np.int32))
    bases = np.frombuffer(b"ACGT", np.uint8)
    nrows = 0
    for w in range(G):
        Rw = R if w == 0 else int(rng.integers(max(R // 2, 1), R + 1))
        Ww = W if w == 0 else int(rng.integers(max(W // 2, 1), W + 1))
        nrows = max(nrows, Rw)
        a["Wlen"][w] = Ww
        a["seq"][w, 1:Ww + 1] = bases[rng.integers(0, 4, Ww)]
        a["node_ch"][w, :Rw] = bases[rng.integers(0, 4, Rw)]
        wide = int(rng.integers(P, Rw)) if Rw > P else -1
        has_succ = np.zeros(Rw, bool)
        O0, F0 = a["O0col"][w], a["F0col"][w]
        O0[0] = F0[0] = 0
        for r in range(Rw):
            k = P if r == wide else int(rng.integers(0, P + 1))
            k = min(k, r)
            if r > 0 and k == 0 and rng.random() < 0.7:
                k = 1               # mostly chains, a few new sources
            if k == 0:
                pO, pF = q - c, g - e
            else:
                pr = rng.choice(r, size=k, replace=False) + 1
                a["preds"][w, r, :k] = pr
                a["npred"][w, r] = k
                has_succ[pr - 1] = True
                pO, pF = O0[pr].max(), F0[pr].max()
            O0[r + 1] = pO + c
            F0[r + 1] = pF + e
        a["endmask"][w, :Rw] = ~has_succ
    H0 = np.maximum(a["O0col"], a["F0col"])
    H0[:, 0] = 0
    a["H0col"] = H0
    for k in ("H0col", "F0col", "O0col"):
        a[k] = a[k].astype(np.int32)
    return {k: a[k] for k in ROUND}, nrows


def jax_blob(arrays) -> np.ndarray:
    """A round's arrays as the JAX package's one flat int32 blob
    (poa.py:883-887's order, array-major)."""
    return np.concatenate([np.asarray(arrays[k]).astype(np.int32).ravel()
                           for k in ROUND])
