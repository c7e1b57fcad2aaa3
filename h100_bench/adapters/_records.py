"""What the chain-format adapters share: anchor batches as the program's
records (`genarchbench_tpu_torch.io.chain_io.ChainRecord`), each
record's x and y a view of the batch's arrays (the records the
program's readers would make from the text, without the text, which
the reference's timing leaves out too), and one batch through the entry
that the configuration names."""

from __future__ import annotations

from typing import List


def chain_records(batch) -> List:
    from genarchbench_tpu_torch.io.chain_io import ChainRecord
    offs = batch.offs.tolist()
    return [ChainRecord(n, avg, mdx, mdy, bw, segs, batch.x[o:e],
                        batch.y[o:e])
            for n, avg, mdx, mdy, bw, segs, o, e in zip(
                batch.n.tolist(), batch.avg_qspan.tolist(),
                batch.max_dist_x.tolist(), batch.max_dist_y.tolist(),
                batch.bw.tolist(), batch.n_segs.tolist(), offs[:-1], offs[1:])]


def run_on_one_card(entry, records, device, stats=None):
    """entry(records) on `device` alone, as the CLI's region of interest
    calls it: [(scores, parents, peaks or None)] of every record."""
    from genarchbench_tpu_torch.sharding.mesh import data_mesh
    return entry(records, device=device, stats=stats, mesh=data_mesh())
