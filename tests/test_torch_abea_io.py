"""The port's BAM and fast5 readers against the JAX package's, on the CPU.

BAMs written by one package are read by the other, field for field; the
two writers give the same BAM and `.bai` bytes; the C BGZF decoder gives
the zlib loop's bytes; fast5 files (both layouts) and readdb indexes
written by one package are read by the other to the same float32
signal.  Last, the port's modules import neither JAX nor the JAX package.
"""

import pathlib
import subprocess
import sys

import h5py
import numpy as np
import pytest

from genarchbench_tpu.io import bam_io as JB
from genarchbench_tpu.io import fast5_io as JF
from genarchbench_tpu_torch import native
from genarchbench_tpu_torch.io import bam_io as TB
from genarchbench_tpu_torch.io import fast5_io as TF

REPO = pathlib.Path(__file__).resolve().parent.parent
FIELDS = ("qname", "flag", "ref_id", "pos", "mapq", "cigar", "seq", "aux")


def record_fields(rng, n=300, ref_len=200_000):
    """Sorted record fields: M/I/D/S cigars, ambiguous bases, reverse,
    secondary and unmapped flags, aux bytes, reads past 64 KB blocks."""
    out = []
    for i in range(n):
        cig, qlen = [], 0
        if rng.random() < 0.3:
            cig.append((4, int(rng.integers(1, 8))))
            qlen += cig[-1][1]
        for _ in range(int(rng.integers(1, 4))):
            cig.append((0, int(rng.integers(20, 400))))
            qlen += cig[-1][1]
            op = int(rng.choice([1, 2]))
            cig.append((op, int(rng.integers(1, 5))))
            qlen += cig[-1][1] if op == 1 else 0
        cig.append((0, int(rng.integers(5, 50))))
        qlen += cig[-1][1]
        flag = int(rng.choice([0, 16, 0x100, 4]))
        ref_id = -1 if flag == 4 and i % 2 else int(rng.integers(0, 2))
        seq = "".join("ACGTN"[c] for c in rng.choice(
            5, qlen, p=[.24, .24, .24, .24, .04]))
        aux = b"NMi" + int(rng.integers(0, 9)).to_bytes(4, "little") \
            if i % 3 else b""
        out.append((f"read{i}", flag, ref_id, int(rng.integers(0, ref_len)),
                    int(rng.integers(0, 60)), cig, seq,
                    rng.integers(0, 40, qlen).astype(np.uint8), aux))
    out.sort(key=lambda f: (f[2] < 0, f[2], f[3]))
    return [("tig1", ref_len), ("tig2", ref_len)], out


def records_of(mod, fields):
    return [mod.BamRecord(*f) for f in fields]


def assert_same_records(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert [getattr(a, k) for k in FIELDS] == \
            [getattr(b, k) for k in FIELDS]
        np.testing.assert_array_equal(a.qual, b.qual)
        assert a.ref_span() == b.ref_span()
        np.testing.assert_array_equal(a.nt16(), b.nt16())


@pytest.mark.parametrize("writer,reader", [(TB, JB), (JB, TB)],
                         ids=["port-writes", "jax-writes"])
def test_bam_read_by_the_other(tmp_path, writer, reader):
    refs, fields = record_fields(np.random.default_rng(1))
    path = str(tmp_path / "r.bam")
    writer.write_bam(path, refs, records_of(writer, fields))
    got_refs, got = reader.read_bam(path)
    assert got_refs == refs
    assert_same_records(got, records_of(reader, fields))


def test_bam_and_bai_bytes_equal(tmp_path):
    refs, fields = record_fields(np.random.default_rng(2))
    TB.write_bam(str(tmp_path / "t.bam"), refs, records_of(TB, fields))
    JB.write_bam(str(tmp_path / "j.bam"), refs, records_of(JB, fields))
    for ext in (".bam", ".bam.bai"):
        assert (tmp_path / f"t{ext}").read_bytes() == \
            (tmp_path / f"j{ext}").read_bytes()
    assert len((tmp_path / "t.bam.bai").read_bytes()) > 100


@pytest.mark.parametrize("region", ["tig1", "tig1:1001", "tig1:1,001-2,000",
                                    "chr2:5-5", "a:b:30-40"])
def test_parse_region(region):
    assert TB.parse_region(region) == JB.parse_region(region)


def test_bgzf_c_against_the_zlib_loop(tmp_path):
    data = np.random.default_rng(3).integers(0, 4, 300_000).astype(
        np.uint8).tobytes() + b"tail"
    path = str(tmp_path / "x.gz")
    offsets = TB.bgzf_write(path, data)
    assert len(offsets) == 5
    assert TB.bgzf_read(path) == TB.bgzf_read_plain(path) == data
    assert TB.bgzf_read(path) == JB.bgzf_read(path)
    TB.bgzf_write(path, b"")                     # the EOF block alone
    assert TB.bgzf_read(path) == TB.bgzf_read_plain(path) == b""


def test_bgzf_bad_data_raises(tmp_path):
    path = tmp_path / "bad.gz"
    path.write_bytes(b"\x1f\x8b\x08\x04" + b"\x00" * 40)
    with pytest.raises(ValueError, match="bgzf"):
        TB.bgzf_read(str(path))
    with pytest.raises(ValueError):
        TB.bgzf_read_plain(str(path))
    with pytest.raises(ValueError, match="bgzf"):
        native.bgzf_decompress(b"not a gzip member at all")


def signals(rng, n=4):
    return [(f"id-{i}", rng.normal(90, 15, int(rng.integers(50, 3000)))
             .astype(np.float32)) for i in range(n)]


@pytest.mark.parametrize("writer,reader", [(TF, JF), (JF, TF)],
                         ids=["port-writes", "jax-writes"])
def test_fast5_read_by_the_other(tmp_path, writer, reader):
    reads = signals(np.random.default_rng(4))
    f5 = tmp_path / "sub" / "reads.fast5"
    f5.parent.mkdir()
    writer.write_fast5(str(f5), reads, 8192.0, 10.0, 1467.6)
    fq = tmp_path / "reads.fastq"
    # one absolute path, the others relative to the readdb's directory
    writer.write_readdb(str(fq) + reader.READ_DB_SUFFIX,
                        [(rid, str(f5) if i == 0 else "sub/reads.fast5")
                         for i, (rid, _) in enumerate(reads)])
    want = JF.Fast5Index.for_reads(str(fq))
    got = reader.Fast5Index.for_reads(str(fq))
    assert len(got) == len(want) == len(reads)
    for rid, sig in reads:
        assert rid in got
        a, b = got.signal(rid), want.signal(rid)
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        # the DAC round trip is within half a DAC unit of the pA signal
        assert np.abs(a - sig).max() <= 1467.6 / 8192.0 / 2 + 1e-3
    assert got.signal("missing") is None
    got.close()
    want.close()


def test_single_read_fast5(tmp_path):
    """The single-read layout (Raw/Reads/<Read_N>/Signal with the
    calibration under UniqueGlobalKey/channel_id), written with h5py."""
    dac = np.random.default_rng(5).integers(-200, 900, 4000).astype(np.int16)
    f5 = tmp_path / "one.fast5"
    with h5py.File(f5, "w") as f:
        f.create_dataset("Raw/Reads/Read_17/Signal", data=dac)
        ch = f.create_group("UniqueGlobalKey/channel_id")
        ch.attrs["digitisation"] = np.float64(2048.0)
        ch.attrs["offset"] = np.float64(-3.0)
        ch.attrs["range"] = np.float64(1402.8)
    db = tmp_path / "one.readdb"
    TF.write_readdb(str(db), [("r17", "one.fast5"), ("r18", "")])
    got = TF.Fast5Index(str(db))
    assert "r17" in got and "r18" not in got
    sig = got.signal("r17")
    np.testing.assert_array_equal(sig, JF.Fast5Index(str(db)).signal("r17"))
    np.testing.assert_array_equal(
        sig, (dac.astype(np.float32) + np.float32(-3.0))
        * np.float32(1402.8 / 2048.0))
    got.close()


def test_port_modules_import_no_jax():
    """The abea path's modules, imported in a fresh process, pull in
    neither JAX nor the JAX package (and the readers not h5py)."""
    code = ("import sys; import genarchbench_tpu_torch.io.bam_io, "
            "genarchbench_tpu_torch.io.fast5_io, "
            "genarchbench_tpu_torch.kernels.abea, "
            "genarchbench_tpu_torch.native; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'genarchbench_tpu', 'h5py')); print(bad)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
