"""nn-variant inputs for the port's tests and chip_smoke.py, numpy only (no
JAX, no JAX package), the BAM writer passed in (`bam_io`, either
package's).

  * `keras_weights_p` / `keras_weights_f`: seeded Clair3_P / Clair3_F
    checkpoints in the Keras key scheme that both packages'
    `convert_keras_weights[_full]` read, so one `--model` / `--fa-model`
    npz drives both;
  * `two_hap_records`: tests/test_variant.py::_two_hap_records draw for
    draw (40 reads of 200 bases from two haplotypes);
  * `fa_edge_records`: reads with insertions at the window's right edge,
    deletions, both strands and more than 89 covering reads;
  * `ont_case` (input A): one contig, two haplotypes with het and hom
    SNPs, long reads with substitutions, insertions and deletions;
  * `ilmn_case` (input B): a short region, 150-base reads, het and hom
    SNPs and one 2-base deletion whose reads are written unaligned
    across it (all M), which the SSW realignment repairs.
"""

import numpy as np

ONT = dict(seed=115, ref_len=500_000, n_reads=5_000, read_len=3_000,
           read_spread=1_000, het_every=1_000, hom_every=3_000, sub=0.02,
           ins=0.01, dele=0.015)
ILMN = dict(seed=116, ref_len=3_000, n_reads=800, read_len=150, sub=0.005)


def _dense(w, rng, name, fin, fout, scale):
    w[f"{name}/kernel"] = (rng.normal(size=(fin, fout)) * scale) \
        .astype(np.float32)
    w[f"{name}/bias"] = (rng.normal(size=fout) * scale).astype(np.float32)


HEADS = [("L5_1", 128), ("L5_2", 128), ("L5_3", 128), ("L5_4", 128),
         ("Y_gt21", 21), ("Y_genotype", 3), ("Y_len1", 33), ("Y_len2", 33)]


def _heads(w, rng, fin, scale):
    for name, fout in HEADS:
        _dense(w, rng, name, fin if name.startswith("L5") else 128, fout,
               scale)


def keras_weights_p(seed: int, scale: float = 0.05) -> dict:
    """A seeded Clair3_P checkpoint (add_indel_length=True)."""
    rng = np.random.default_rng(seed)
    w = {}
    for name, u, fin in (("LSTM1", 128, 18), ("LSTM2", 160, 256)):
        for d in ("forward", "backward"):
            w[f"{name}/{d}/kernel"] = (rng.normal(size=(fin, 4 * u))
                                       * scale).astype(np.float32)
            w[f"{name}/{d}/recurrent"] = (rng.normal(size=(u, 4 * u))
                                          * scale).astype(np.float32)
            w[f"{name}/{d}/bias"] = (rng.normal(size=4 * u)
                                     * scale).astype(np.float32)
    _dense(w, rng, "L4", 33 * 320, 128, scale)
    _heads(w, rng, 128, scale)
    return w


def fa_l4_inputs(depth: int, width: int = 33) -> int:
    """Clair3_F's L4 input width for (depth, width) tensors."""
    for _ in range(3):
        depth, width = -(-depth // 2), -(-width // 2)
    return 256 * sum(-(-depth // -(-depth // p)) * -(-width // -(-width // p))
                     for p in (3, 2, 1))


def keras_weights_f(seed: int, depth: int = 89, width: int = 33,
                    scale: float = 0.05) -> dict:
    """A seeded Clair3_F checkpoint for (depth, width) tensors, BatchNorm
    statistics not the identity."""
    rng = np.random.default_rng(seed)
    w = {}

    def conv_bn(conv, bn, cin, cout):
        w[f"{conv}/kernel"] = (rng.normal(size=(3, 3, cin, cout))
                               / np.sqrt(9 * cin)).astype(np.float32)
        w[f"{conv}/bias"] = (rng.normal(size=cout) * scale) \
            .astype(np.float32)
        w[f"{bn}/gamma"] = rng.uniform(0.8, 1.2, cout).astype(np.float32)
        w[f"{bn}/beta"] = (rng.normal(size=cout) * scale).astype(np.float32)
        w[f"{bn}/moving_mean"] = (rng.normal(size=cout) * scale) \
            .astype(np.float32)
        w[f"{bn}/moving_variance"] = rng.uniform(0.5, 1.5, cout) \
            .astype(np.float32)

    for name, cin, cout in (("conv1", 8, 64), ("conv3", 64, 128),
                            ("conv5", 128, 256)):
        conv_bn(f"{name}/conv", f"{name}/bn", cin, cout)
        block = {"conv1": "res_block1", "conv3": "res_block2",
                 "conv5": "res_block3"}[name]
        for i in (1, 2):
            conv_bn(f"{block}/conv{i}", f"{block}/bn{i}", cout, cout)
    _dense(w, rng, "L4", fa_l4_inputs(depth, width), 256, scale)
    _heads(w, rng, 256, scale)
    return w


def save_npz(path, weights: dict) -> None:
    np.savez(str(path), **weights)


def random_ref(rng, n: int) -> str:
    return "".join("ACGT"[c] for c in rng.integers(0, 4, n))


def write_fasta(path, name: str, seq: str) -> None:
    with open(path, "w") as f:
        f.write(f">{name}\n")
        for i in range(0, len(seq), 80):
            f.write(seq[i:i + 80] + "\n")


def two_hap_records(rng, ref, het_sites, bam_io, n_reads=40, ln=200,
                    pos_span=100):
    """tests/test_variant.py::_two_hap_records: reads from two haplotypes
    differing at het_sites (pos -> alt), forward strand, mapq 40."""
    records = []
    for i in range(n_reads):
        hap = i % 2
        pos = int(rng.integers(0, pos_span))
        s = list(ref[pos:pos + ln])
        if hap:
            for p, alt in het_sites.items():
                if pos <= p < pos + ln:
                    s[p - pos] = alt
        records.append(bam_io.BamRecord(
            f"r{i}", 0, 0, pos, 40, [(0, ln)], "".join(s),
            np.full(ln, 30, np.uint8)))
    records.sort(key=lambda r: r.pos)
    return records


def fa_edge_records(rng, ref, center, bam_io, n_reads=120):
    """Reads around `center` for the full-alignment tensor: SNPs at the
    center, insertions after it and at the window's last columns (up to
    4 bases, past its right edge), deletions, reverse strands, mapq
    0-59, random qualities, some filtered flags; more than 89 reads
    cover the window, so the downsample runs."""
    records = []
    hi = center + 16                   # the window's last column
    for i in range(n_reads):
        pos = int(rng.integers(center - 60, center - 4))
        ln = int(rng.integers(40, 90))
        s = list(ref[pos:pos + ln])
        cig = [(0, ln)]
        kind = i % 6
        at = {1: center, 2: center, 3: center, 4: hi - 1, 5: hi}[kind] \
            - pos if kind else 0
        if kind == 1 and 0 <= at < ln:
            s[at] = "A" if ref[center] != "A" else "G"
        elif kind in (2, 4, 5) and 3 <= at < ln - 4:
            nins = 1 + i % 4
            cig = [(0, at + 1), (1, nins), (0, ln - at - 1)]
            s = s[:at + 1] + list("TGAC"[:nins]) + s[at + 1:]
        elif kind == 3 and 3 <= at < ln - 5:
            dl = 1 + i % 2
            cig = [(0, at + 1), (2, dl), (0, ln - at - 1 - dl)]
            s = s[:at + 1] + s[at + 1 + dl:]
        seq = "".join(s)
        flag = 16 if i % 3 == 0 else 0
        if i % 17 == 5:
            flag |= 256
        records.append(bam_io.BamRecord(
            f"r{i:03d}", flag, 0, pos, i % 60, cig, seq,
            rng.integers(5, 50, len(seq)).astype(np.uint8)))
    records.sort(key=lambda r: r.pos)
    return records


def _mutated_read(rng, hap: np.ndarray, start: int, length: int, sub: float,
                  ins: float, dele: float):
    """(seq codes, cigar) of hap[start:start+length] with substitutions,
    one-base insertions and one-base deletions; the first and last
    bases are matches."""
    seg = hap[start:start + length]
    u = rng.random(length)
    kind = np.where(u < dele, 2, np.where(u < dele + ins, 1,
                                          np.where(u < dele + ins + sub, 3,
                                                   0)))
    kind[0] = kind[-1] = 0
    base = seg.copy()
    subs = kind == 3
    base[subs] = (base[subs] + rng.integers(1, 4, int(subs.sum()))) % 4
    n_ops = np.where(kind == 1, 2, 1)
    starts = np.cumsum(n_ops) - n_ops
    ops = np.zeros(int(n_ops.sum()), np.int8)              # M
    ob = np.zeros(len(ops), np.int8)
    ops[starts] = np.where(kind == 1, 1, np.where(kind == 2, 2, 0))
    ob[starts] = np.where(kind == 1, rng.integers(0, 4, length), base)
    ob[starts[kind == 1] + 1] = base[kind == 1]
    seq = ob[ops != 2]
    brk = np.flatnonzero(np.diff(ops)) + 1
    run_starts = np.concatenate([[0], brk])
    run_lens = np.diff(np.concatenate([run_starts, [len(ops)]]))
    cigar = list(zip(ops[run_starts].tolist(), run_lens.tolist()))
    return seq, cigar


def _haplotypes(rng, ref: np.ndarray, het_every: int, hom_every: int):
    n = len(ref)
    het = np.sort(rng.choice(n, n // het_every, replace=False))
    hom = np.setdiff1d(np.sort(rng.choice(n, n // hom_every, replace=False)),
                       het)
    hap0, hap1 = ref.copy(), ref.copy()
    for sites, haps in ((hom, (hap0, hap1)), (het, (hap1,))):
        alt = (ref[sites] + rng.integers(1, 4, len(sites))) % 4
        for h in haps:
            h[sites] = alt
    return hap0, hap1, het, hom


def ont_case(directory, bam_io, **over):
    """Input A: `ONT` (over a 500 kb contig `ctg`, 30x of 3000 +- 1000
    base reads, half reverse, mapq 60, 2% substitutions, 1% insertions,
    1.5% deletions).  Writes ref.fa and reads.bam; returns their paths
    and the het and hom SNP positions."""
    kw = {**ONT, **over}
    rng = np.random.default_rng(kw["seed"])
    ref = rng.integers(0, 4, kw["ref_len"]).astype(np.int8)
    hap0, hap1, het, hom = _haplotypes(rng, ref, kw["het_every"],
                                       kw["hom_every"])
    records = []
    for i in range(kw["n_reads"]):
        ln = int(rng.integers(kw["read_len"] - kw["read_spread"],
                              kw["read_len"] + kw["read_spread"] + 1))
        ln = min(ln, kw["ref_len"])
        pos = int(rng.integers(0, kw["ref_len"] - ln + 1))
        hap = hap1 if rng.random() < 0.5 else hap0
        codes, cigar = _mutated_read(rng, hap, pos, ln, kw["sub"], kw["ins"],
                                     kw["dele"])
        seq = "".join(np.array(list("ACGT"))[codes])
        records.append(bam_io.BamRecord(
            f"ont{i}", 16 if rng.random() < 0.5 else 0, 0, pos, 60, cigar,
            seq, rng.integers(5, 40, len(seq)).astype(np.uint8)))
    records.sort(key=lambda r: r.pos)
    return _write_case(directory, bam_io, ref, records, het, hom)


def _write_case(directory, bam_io, ref, records, het, hom):
    ref_s = "".join(np.array(list("ACGT"))[ref])
    fa, bam = directory / "ref.fa", directory / "reads.bam"
    write_fasta(fa, "ctg", ref_s)
    bam_io.write_bam(str(bam), [("ctg", len(ref_s))], records)
    return dict(ref=fa, bam=bam, het=het, hom=hom, ref_seq=ref_s,
                region=f"ctg:1-{len(ref_s)}")


def ilmn_case(directory, bam_io, **over):
    """Input B: `ILMN` (a 3 kb contig `ctg`, 40x of 150-base reads, half
    reverse, mapq 60, 0.5% substitutions); het SNPs at 600 and 2100,
    hom SNPs at 1200 and 2600, a het 2-base deletion after 1500 whose
    reads are written all-M across it (their bases shifted).  Writes
    ref.fa and reads.bam; returns their paths and the sites."""
    kw = {**ILMN, **over}
    rng = np.random.default_rng(kw["seed"])
    n = kw["ref_len"]
    ref = rng.integers(0, 4, n).astype(np.int8)
    hap0, hap1 = ref.copy(), ref.copy()
    het = np.array([n // 5, 7 * n // 10])
    hom = np.array([2 * n // 5, 13 * n // 15])
    for sites, haps in ((hom, (hap0, hap1)), (het, (hap1,))):
        alt = (ref[sites] + 1 + np.arange(len(sites))) % 4
        for h in haps:
            h[sites] = alt
    dpos = n // 2
    hap1 = np.delete(hap1, [dpos + 1, dpos + 2])           # 2-base deletion
    L = kw["read_len"]
    records = []
    for i in range(kw["n_reads"]):
        pos = int(rng.integers(0, n - L - 2))
        hap = hap1 if i % 2 else hap0
        hpos = pos if (hap is hap0 or pos <= dpos) else pos - 2
        codes = hap[hpos:hpos + L].copy()
        subs = rng.random(L) < kw["sub"]
        codes[subs] = (codes[subs] + rng.integers(1, 4, int(subs.sum()))) % 4
        seq = "".join(np.array(list("ACGT"))[codes])
        records.append(bam_io.BamRecord(
            f"il{i}", 16 if rng.random() < 0.5 else 0, 0, pos, 60, [(0, L)],
            seq, rng.integers(20, 40, L).astype(np.uint8)))
    records.sort(key=lambda r: r.pos)
    case = _write_case(directory, bam_io, ref, records, het, hom)
    case["deletion"] = dpos
    return case
