"""The port's process route: 2 CPU processes in one gloo group, 2 CPU
shards each, 4 in all, with real cross-process collectives (psum,
all_gather, psum_scatter and the k-mer count's all_to_all), the port's
twin of tests/test_distributed.py."""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np

from genarchbench_tpu_torch.io.fasta_io import ReadSet
from genarchbench_tpu_torch.kernels.kmer import count_distinct

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_dist_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_group():
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("GENARCH_")}
    procs = []
    for rank in range(2):
        env = {**base, "GENARCH_HOSTS": "2", "GENARCH_DEVICES": "2",
               "GENARCH_DEVICE": "cpu",
               "GENARCH_COORDINATOR": f"127.0.0.1:{port}",
               "GENARCH_PROCESS_ID": str(rank)}
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{err[-2000:]}"
        lines = [ln for ln in out.splitlines() if ln.startswith("DIST_OK")]
        assert lines, f"no DIST_OK in output:\n{out}\n{err[-1000:]}"
        outs.append(lines[-1])
    assert outs[0] == outs[1], outs

    rng = np.random.default_rng(7)
    seqs = [rng.integers(0, 4, 400).astype(np.uint8) for _ in range(8)]
    want = count_distinct(ReadSet([f"r{i}" for i in range(8)], seqs), 15,
                          device="cpu")
    assert outs[0].split() == ["DIST_OK", "22", str(want)]
