"""Inputs for the abea port's tests and chip_smoke.py, numpy only.

No pore model is in the repo, so every input is made from a seeded
synthetic 4096-row model (`synth_model`) in the form the packages'
`load_model` returns.  `synth_signal` is tests/test_abea.py's squiggle
generator and `bench_input` the JAX bench's abea input (bench.py:176-185)
draw for draw, each over such a model; `write_model` writes a model file
in the three forms `load_model` reads; `dyadic_host` makes band-scan
arguments whose emission arithmetic is exact in float32, with an option
for equal scores everywhere; `write_cli_case` lays out an eventalign
run's inputs.
"""

import numpy as np

KMER = 6
MODEL_FORMS = ("two-column", "headed", "kmer-first")


def kmer_ranks(seq: str) -> np.ndarray:
    """Each k-mer's rank, base j of the k-mer weighing 4^(k-1-j)."""
    codes = np.searchsorted(np.frombuffer(b"ACGT", np.uint8),
                            np.frombuffer(seq.encode(), np.uint8))
    n = len(seq) - KMER + 1
    r = np.zeros(max(n, 0), np.int64)
    for j in range(KMER):
        r += codes[j:j + n] << (2 * (KMER - 1 - j))
    return r


def synth_model(seed=0):
    """level_mean 60-130 pA and level_stdv 1-3 pA a k-mer, float32 (the
    r9.4 table's ranges), with load_model's level_log_stdv."""
    rng = np.random.default_rng(seed)
    lm = rng.uniform(60.0, 130.0, 4 ** KMER).astype(np.float32)
    ls = rng.uniform(1.0, 3.0, 4 ** KMER).astype(np.float32)
    return {"level_mean": lm, "level_stdv": ls,
            "level_log_stdv": np.log(ls.astype(np.float64)).astype(
                np.float32)}


def write_model(path, model, form="two-column"):
    """The model as a text file: `mean stdv` lines (two-column), the same
    under a comment and a column header (headed), or nanopolish's
    `.model` layout with the k-mer first (kmer-first).  Each float32 is
    written with 9 significant digits, so it reads back exactly."""
    kmers = ["".join("ACGT"[(r >> (2 * (KMER - 1 - j))) & 3]
                     for j in range(KMER)) for r in range(4 ** KMER)]
    rows = [f"{float(m):.9g}\t{float(s):.9g}" for m, s in
            zip(model["level_mean"], model["level_stdv"])]
    if form == "two-column":
        lines = rows
    elif form == "headed":
        lines = ["#synthetic pore model", "level_mean\tlevel_stdv", *rows]
    elif form == "kmer-first":
        lines = ["#ont_model_name\tsynthetic", "#kit\tr9.4_450bps",
                 "kmer\tlevel_mean\tlevel_stdv\tsd_mean\tsd_stdv\tweight",
                 *(f"{k}\t{r}\t1.0\t0.5\t100.0" for k, r in zip(kmers, rows))]
    else:
        raise ValueError(f"unknown model form {form!r}; try {MODEL_FORMS}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def random_seq(rng, n: int) -> str:
    return "".join("ACGT"[c] for c in rng.integers(0, 4, n))


def synth_signal(rng, model, seq, epk_lo=4, epk_hi=14, noise=0.8):
    """tests/test_abea.py:35-42: each k-mer's level held epk_lo to
    epk_hi - 1 samples, plus Gaussian noise."""
    levels = model["level_mean"][kmer_ranks(seq)]
    parts = [np.full(int(rng.integers(epk_lo, epk_hi)), lv)
             for lv in levels]
    sig = np.concatenate(parts).astype(np.float64)
    sig += rng.normal(0, noise, len(sig))
    return sig.astype(np.float32)


def bench_input(model, n_reads=256, seqlen=2000, seed=109):
    """bench.py's abea input: (seqs, signals), n_reads random reads of
    seqlen bases with 4-13 samples a k-mer and noise 0.8."""
    rng_a = np.random.default_rng(seed)
    seqs, sigs = [], []
    for _ in range(n_reads):
        seq = "".join("ACGT"[c] for c in rng_a.integers(0, 4, seqlen))
        levels = model["level_mean"][kmer_ranks(seq)]
        reps = rng_a.integers(4, 14, len(levels))
        sig = (np.repeat(levels, reps)
               + rng_a.normal(0, 0.8, int(reps.sum()))).astype(np.float32)
        seqs.append(seq)
        sigs.append(sig)
    return seqs, sigs


def dyadic_host(rng, lengths, ties=False):
    """Band-scan arguments on which every emission op is exact in
    float32: event means and k-mer means are multiples of 1/16 in
    [64, 96), stdvs 1 or 2, shift 0 and scale 1.  With `ties` every
    emission is the same and lp_stay == lp_step, so equal scores are
    everywhere."""
    B = len(lengths)
    n_km = np.array(lengths, np.int32)
    n_ev = (n_km * 1.6).astype(np.int32)
    NE = 1 << int(n_ev.max() - 1).bit_length()
    NK = 1 << int(n_km.max() - 1).bit_length()
    NB = int((n_ev + n_km).max()) + 2
    grid = lambda shape: (64 + rng.integers(0, 512, shape) / 16).astype(
        np.float32)
    lsd = rng.choice(np.float32([1.0, 2.0]), 4096)
    host = dict(ranks=rng.integers(0, 4096, (B, NK)).astype(np.int32),
                ev_mean=grid((B, NE)), n_ev=n_ev, n_km=n_km,
                shifts=np.zeros(B, np.float32), scales=np.ones(B, np.float32),
                lm=grid(4096), lsd=lsd,
                llsd=np.log(lsd.astype(np.float64)).astype(np.float32))
    p_stay = 1 - 1 / (n_ev / n_km + 1)
    lps = np.stack([np.full(B, np.log(1e-10)), np.log(p_stay),
                    np.log(1.0 - 1e-10 - p_stay), np.full(B, np.log(0.01))])
    if ties:
        host["ev_mean"][:] = 80.0
        host["lm"][:] = 80.0
        lps[2] = lps[1]
    host["lps"] = lps
    return host, NB, NE, NK


def write_cli_case(out_dir, model, seqs, sigs, bam_io, fast5_io=None,
                   gap=0, rng=None, unmapped=()):
    """An eventalign run's inputs in out_dir: ref.fa (one contig `tig1`
    with the reads laid end to end, `gap` random bases between them),
    reads.bam (read i, `r<i>`, mapped at its offset with one M cigar,
    written by `bam_io.write_bam`; the reads in `unmapped` flagged 0x4),
    model.txt, an npy/ directory of the signals, and with `fast5_io`
    reads.fast5, an empty reads.fastq and its `.index.readdb` (signals
    as the fast5 calibration returns them, so both routes read the same
    floats).  Returns a dict of the paths."""
    rng = rng or np.random.default_rng(0)
    parts, records, pos = [], [], 0
    for i, seq in enumerate(seqs):
        parts.append(seq)
        records.append(bam_io.BamRecord(
            f"r{i}", 4 if i in unmapped else 0, 0, pos, 60,
            [(0, len(seq))], seq, np.full(len(seq), 30, np.uint8)))
        filler = random_seq(rng, gap)
        parts.append(filler)
        pos += len(seq) + len(filler)
    ref = "".join(parts)
    paths = {k: out_dir / n for k, n in (
        ("ref", "ref.fa"), ("bam", "reads.bam"), ("model", "model.txt"),
        ("npy", "npy"), ("fast5", "reads.fast5"), ("reads", "reads.fastq"))}
    with open(paths["ref"], "w") as f:
        f.write(">tig1\n")
        for i in range(0, len(ref), 80):
            f.write(ref[i:i + 80] + "\n")
    bam_io.write_bam(str(paths["bam"]), [("tig1", len(ref))], records)
    write_model(paths["model"], model)
    paths["npy"].mkdir(exist_ok=True)
    if fast5_io is None:
        for i, sig in enumerate(sigs):
            np.save(paths["npy"] / f"r{i}.npy", sig)
        return paths
    dig, off, rng_pa = 8192.0, 10.0, 1467.6
    unit = rng_pa / dig
    reads = []
    for i, sig in enumerate(sigs):
        dac = np.round(sig.astype(np.float64) / unit - off)
        pa = (dac.astype(np.float32) + np.float32(off)) * np.float32(unit)
        np.save(paths["npy"] / f"r{i}.npy", pa)
        reads.append((f"r{i}", pa))
    fast5_io.write_fast5(str(paths["fast5"]), reads, dig, off, rng_pa)
    paths["reads"].write_text("")
    fast5_io.write_readdb(str(paths["reads"]) + ".index.readdb",
                          [(f"r{i}", str(paths["fast5"]))
                           for i in range(len(sigs))])
    return paths
