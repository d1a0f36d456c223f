"""haploconduct_tpu — haplotype-aware overlap-graph assembler on JAX.

A from-scratch rebuild of HaploConduct (SAVAGE + POLYTE) for an
accelerator (one or more NVIDIA GPUs): the numeric hot loops (pairwise
overlap verification, k-mer candidate generation, the abundance EM) run as
batched JAX programs on device; the inherently sequential graph heuristics (orientation
labelling, cycle removal, Bron-Kerbosch clique enumeration) run on host
(NumPy / native C++); multi-chip scale-out shards candidate batches over a
`jax.sharding.Mesh` and merges verified edges with XLA collectives.

Reference behavior: /root/reference (HaploConduct v0.2). This package is a
re-design, not a port: one in-memory Python pipeline replaces the reference's
process-and-files architecture (subprocess + TSV handoffs), while keeping the
reference's on-disk formats available as an interchange/debug layer.
"""

__version__ = "0.1.0"

# Large-buffer allocator tuning (see utils/hostmem.py): the host phases
# churn multi-MB NumPy temporaries every iteration; on lazily-faulted VM
# memory the default glibc mmap-per-allocation costs ~50x. Opt out with
# HC_NO_MALLOC_TUNE=1.
from .utils.hostmem import tune_allocator as _tune_allocator

_tune_allocator()
