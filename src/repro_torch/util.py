"""Small shared utilities.

Copy of ``repro.util.opt_flags``: the named options of ``REPRO_OPTS``
(``REPRO_OPTS=a,b,c``).  The port reads the reference's five:

* ``w8_experts`` (``models/moe.py``): int8 expert banks, dequantised at
  use;
* ``remat_dots`` (``models/transformer.py``): the group checkpoint keeps
  the outputs of products with no batch dimension, ``aten.mm`` and
  ``aten.addmm``, and recomputes the rest;
* ``sp_naive_attn`` (``kernels/ref.py``): the plain flash attention
  materialises the whole sequence's logits, with no query chunks and no
  chunk checkpoints;
* ``ssd_shard_state`` (``kernels/ref.py``): the plain SSD scan
  constrains each chunk's carried ``(b, h, p, n)`` state to ``("batch",
  "mamba_heads", None, None)``;
* ``microbatch8`` (``launch/dryrun.py``): a train cell's step runs 8
  microbatches.

None of them moves a value beyond the order of f32 sums.
"""
import os


def opt_flags() -> set:
    """Named perf optimizations (REPRO_OPTS=a,b,c)."""
    v = os.environ.get("REPRO_OPTS", "")
    return {x.strip() for x in v.split(",") if x.strip()}
