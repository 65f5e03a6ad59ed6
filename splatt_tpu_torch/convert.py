"""Format conversion (≙ src/convert.c: tt_convert).

Counterpart of ``splatt_tpu/convert.py``, writing the same files.  Targets
mirror splatt_convert_type (src/convert.h:17-26): graph, fiber-CSR matrix
(mode unfolding), fiber hypergraph, nnz hypergraph, binary coordinate,
text coordinate.  ``bin`` saves the loaded tensor; the ``convert`` verb
streams a text file to ``bin`` through ``native.stream_to_bin`` instead,
for tensors larger than the host's memory.
"""

from __future__ import annotations

from splatt_tpu_torch.coo import SparseTensor
from splatt_tpu_torch.graph import (hypergraph_fibers, hypergraph_nnz,
                                    tensor_to_graph, write_graph,
                                    write_hypergraph)
from splatt_tpu_torch.io import save

CONVERT_TYPES = ("graph", "fibmat", "fibhgraph", "nnzhgraph", "bin", "coord")


def convert(tt: SparseTensor, target: str, path: str, mode: int = 0) -> None:
    if target == "graph":
        write_graph(tensor_to_graph(tt), path)
    elif target == "fibmat":
        indptr, cols, vals, shape = tt.unfold(mode)
        with open(path, "w") as f:
            f.write(f"{shape[0]} {shape[1]} {len(vals)}\n")
            for r in range(shape[0]):
                row = [f"{int(cols[k]) + 1} {vals[k]:.17g}"
                       for k in range(indptr[r], indptr[r + 1])]
                f.write(" ".join(row) + "\n")
    elif target == "fibhgraph":
        write_hypergraph(hypergraph_fibers(tt, mode), path)
    elif target == "nnzhgraph":
        write_hypergraph(hypergraph_nnz(tt), path)
    elif target == "bin":
        save(tt, path, binary=True)
    elif target == "coord":
        save(tt, path, binary=False)
    else:
        raise ValueError(f"unknown convert target {target!r} "
                         f"(one of {CONVERT_TYPES})")
