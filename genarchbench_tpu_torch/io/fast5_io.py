"""fast5 raw-signal input located through an f5c/nanopolish read index.

The reference loads signals from ONT fast5 (HDF5) files found through a
prebuilt readdb index: `f5c index` writes `<reads>.index.readdb` with
one `read_id\tfast5_path` line a read (nanopolish_read_db.c:83-91, the
write at :259), and raw DAC values become picoamps by the channel
calibration `(raw + offset) * range / digitisation` (f5c.c:1245-1252,
nanopolish_fast5_io.c:173).

Both fast5 layouts are read (nanopolish_fast5_io.c:227-263):
  single-read: the signal at /Raw/Reads/<Read_N>/Signal, the
               calibration at /UniqueGlobalKey/channel_id
  multi-read:  per read_id, /read_<id>/Raw/Signal and /read_<id>/channel_id

h5py takes the place of the reference's fast5 reader processes
(f5c.c:68-122); abea's loader thread reads the next batch while the card
aligns the current one (kernels/abea.py::run).  h5py is imported only
where a fast5 file is opened or written, so the package imports without
it.  The port's own copy of the JAX package's io/fast5_io.py.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

READ_DB_SUFFIX = ".index.readdb"


class Fast5Index:
    """readdb-backed signal lookup with an open-file cache."""

    def __init__(self, readdb_path: str):
        self.root = os.path.dirname(os.path.abspath(readdb_path))
        self.paths: Dict[str, str] = {}
        with open(readdb_path) as f:
            for line in f:
                fields = line.rstrip("\n").split("\t")
                if len(fields) == 2 and fields[1]:
                    self.paths[fields[0]] = fields[1]
        self._open: Dict[str, object] = {}

    @staticmethod
    def for_reads(reads_path: str) -> "Fast5Index":
        """`f5c index` naming: <reads.fastq> -> <reads.fastq>.index.readdb."""
        return Fast5Index(reads_path + READ_DB_SUFFIX)

    def __contains__(self, read_id: str) -> bool:
        return read_id in self.paths

    def __len__(self) -> int:
        return len(self.paths)

    def _file(self, path: str):
        import h5py
        if path not in self._open:
            if len(self._open) > 32:        # bound the open handles
                for k in list(self._open):
                    self._open.pop(k).close()
            full = path if os.path.isabs(path) else os.path.join(
                self.root, path)
            self._open[path] = h5py.File(full, "r")
        return self._open[path]

    def signal(self, read_id: str) -> Optional[np.ndarray]:
        """pA-calibrated float32 signal, or None if unindexed/missing."""
        path = self.paths.get(read_id)
        if not path:
            return None
        f = self._file(path)
        grp_name = f"read_{read_id}"
        if grp_name in f:                   # multi-read fast5
            grp = f[grp_name]
            raw = grp["Raw/Signal"][()]
            ch = grp["channel_id"].attrs
        else:                               # single-read fast5
            reads = f["Raw/Reads"]
            key = next(iter(reads))
            raw = reads[key]["Signal"][()]
            ch = f["UniqueGlobalKey/channel_id"].attrs
        raw_unit = float(ch["range"]) / float(ch["digitisation"])
        return ((raw.astype(np.float32) + np.float32(ch["offset"]))
                * np.float32(raw_unit))

    def close(self) -> None:
        for f in self._open.values():
            f.close()
        self._open.clear()


def write_fast5(path: str, reads: Iterable[Tuple[str, np.ndarray]],
                digitisation: float = 8192.0, offset: float = 10.0,
                range_pA: float = 1467.6) -> None:
    """Write a multi-read fast5 (a fixture for tests and synthetic
    inputs).  Signals are given in pA and stored as DAC codes by the
    inverse calibration."""
    import h5py
    raw_unit = range_pA / digitisation
    with h5py.File(path, "w") as f:
        for read_id, sig_pa in reads:
            grp = f.create_group(f"read_{read_id}")
            dac = np.round(np.asarray(sig_pa, np.float64) / raw_unit
                           - offset).astype(np.int16)
            grp.create_dataset("Raw/Signal", data=dac)
            ch = grp.create_group("channel_id")
            ch.attrs["digitisation"] = np.float64(digitisation)
            ch.attrs["offset"] = np.float64(offset)
            ch.attrs["range"] = np.float64(range_pA)
            ch.attrs["sampling_rate"] = np.float64(4000.0)


def write_readdb(readdb_path: str,
                 entries: Iterable[Tuple[str, str]]) -> None:
    """Write a readdb index (read_id -> fast5 path), the f5c/nanopolish
    on-disk contract (nanopolish_read_db.c:259)."""
    with open(readdb_path, "w") as f:
        for read_id, path in entries:
            f.write(f"{read_id}\t{path}\n")
