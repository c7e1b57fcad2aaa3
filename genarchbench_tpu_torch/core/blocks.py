"""Loops run in blocks of steps, replayed as CUDA graphs on the card.

A step of such a loop updates its carry tensors in place, keeps its
counters in device tensors and writes its outputs at a slot held in a
device tensor, so it never asks the host anything and no shape depends
on the data.  One block of steps can then be captured as a CUDA graph
and replayed, one graph launch in place of every kernel launch of the
block; the host reads a loop's end flag, where it has one, once a
block.  On the CPU the same blocks run eagerly.  abea's band scan and
backtrace and poa's DP rows and walk run this way.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def run_blocks(block: Callable[[], None], n_blocks: int, graphed: bool,
               done: Optional[Callable[[], bool]] = None) -> int:
    """Run `block` (one block of loop steps) up to n_blocks times, or
    until done() after a block; returns the blocks run.  Graphed (on the
    card): the first block runs eagerly on a side stream, one more is
    captured as a CUDA graph and the graph is replayed for the rest.  A
    failed capture raises; the graph and its memory pool are freed on
    return."""
    ran = 0
    if not graphed:
        while ran < n_blocks:
            block()
            ran += 1
            if done is not None and done():
                break
        return ran
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        block()
    torch.cuda.current_stream().wait_stream(side)
    ran = 1
    if ran == n_blocks or (done is not None and done()):
        return ran
    graph = torch.cuda.CUDAGraph()
    # thread_local: abea's loader thread keeps reading signals meanwhile
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        block()
    while ran < n_blocks:
        graph.replay()
        ran += 1
        if done is not None and done():
            break
    return ran
